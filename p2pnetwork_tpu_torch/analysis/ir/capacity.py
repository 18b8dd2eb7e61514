"""Memory planner: closed-form device-memory extrapolation for the serving
program (torch counterpart of the planner in
``p2pnetwork_tpu/analysis/ir/capacity.py``).

The serving plane asks whether ``u32[W, N]`` lane state over an
``N``-node overlay fits a card, without building the overlay. The
planner answers from checked-in per-(program, family) coefficients::

    global_bytes(N_pad, E_pad, W) = c0 + cN·N_pad + cE·E_pad
                                       + cW·max(0, W - w0)·N_pad
    per_card(shards)              = c0 + (global_bytes - c0) / shards

The reference fits them from its compiler's memory analysis of traced
programs. The port has no traced program, so the coefficients are fitted
over MEASURED records: ``tools/fit_capacity.py`` drives ``SimService``'s
serving program (the batched flood under the engine) on the card at a
ladder of graph sizes and lane words, reads each point's peak device
bytes (``torch.cuda.max_memory_allocated`` over the service's life, plus
the bytes the graph's tensors hold, :func:`resident_bytes`), and fits
them by the reference's least squares (:func:`fit_capacity_model`). The
result rides in ``membudgets.json`` beside this module, under
``capacity_model``, with its fit points, ``max_resid`` and the card it
was measured on.

The evaluation (:func:`plan`, :func:`serving_footprint_bytes`,
:func:`northstar_plan`) is the reference's arithmetic, so both packages
plan the same bytes from the same model dict. As in the reference, both
graph families grow edges linearly in nodes, so the fit cannot separate
``cN`` from ``cE``: extrapolation is exact for graphs of the fitted
densities and outside the model's warranty far from them; below the
fit's smallest graph the intercept may take a plan under zero. No module
here reads any compiler IR.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["fit_capacity_model", "plan", "serving_footprint_bytes",
           "northstar_plan", "load_membudgets", "resident_bytes",
           "CAPACITY_SCHEMA", "DEFAULT_SERVING_ENTRY", "NODE_PAD_MULTIPLE",
           "LANES_PER_WORD", "MODEL_TOLERANCE"]

CAPACITY_SCHEMA = "graftmem-capacity-v1"
#: ``graph.from_edges``' default node padding: the planner pads target
#: node counts as a graph build pads them.
NODE_PAD_MULTIPLE = 128
EDGE_PAD_MULTIPLE = 128
#: One u32 lane word carries 32 concurrent messages (``ops/bitset.py``).
LANES_PER_WORD = 32
#: The serving program: the batched run-to-coverage engine loop that one
#: ``SimService`` tick runs.
DEFAULT_SERVING_ENTRY = "cov/batchflood-engine@ws"
#: Allowed disagreement between a plan and a measured peak (the
#: reference's analytic-vs-compiled bound, ``analysis/ir/memory.py``).
MODEL_TOLERANCE = 0.20


def _round_up(x: int, m: int) -> int:
    return -(-int(x) // m) * m


def default_membudgets_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "membudgets.json")


def load_membudgets(path: Optional[str] = None) -> dict:
    """The checked-in document (``{}`` when absent): its
    ``capacity_model`` section is the planner's model."""
    path = path or default_membudgets_path()
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def resident_bytes(*objs) -> int:
    """Bytes of device memory held by the tensors of ``objs`` (tensors,
    dataclasses, tuples, lists and dicts of them, walked recursively),
    each storage counted once."""
    import dataclasses

    import torch

    seen, total = set(), 0

    def visit(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                visit(getattr(x, f.name))
        elif isinstance(x, (tuple, list)):
            for v in x:
                visit(v)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)

    for o in objs:
        visit(o)
    return total


def _lstsq(rows: List[List[float]], ys: List[float]) -> List[float]:
    """Minimum-norm least squares (numpy's LAPACK), as the reference."""
    import numpy as np

    a = np.asarray(rows, dtype=np.float64)
    b = np.asarray(ys, dtype=np.float64)
    sol, *_ = np.linalg.lstsq(a, b, rcond=None)
    return [float(v) for v in sol]


# ----------------------------------------------------------------- fitting


#: Lane words the serving program's smallest fit point carries (the
#: reference's ``w0`` of its batched entries): the lane term prices only
#: the words past it.
LANE_WORDS_BASE = 1


def fit_capacity_model(records: Sequence[dict],
                       card: Optional[dict] = None) -> dict:
    """Fit the closed forms over measured records, each ``{"entry",
    "n_pad", "e_pad", "lane_words", "bytes"}`` (``entry`` a
    ``"<program>@<family>"`` name; ``"graph_fit": False`` keeps a record
    out of the family's edges-per-node model, as a probe of another
    density), by least squares: per entry ``c0``,
    ``cN`` and ``cE``, and the one lane-word slope ``cW`` of the
    reference's schema (the ``lane`` section, over the words past
    ``LANE_WORDS_BASE``), fitted with the serving entry's coefficients on
    its records (on all records when it has none); the other entries are
    fitted with that ``cW`` held. Returns the ``capacity_model`` document: the reference's
    schema, plus the fit points with their planned bytes and relative
    residuals, ``max_resid`` over the fitted entries' points and ``card``
    (the card they were measured on). An entry whose fit misses one of its
    points by more than ``MODEL_TOLERANCE`` is not offered for planning:
    it goes to ``unfitted`` with its residual, and its points stay in the
    document marked ``"fitted": false``."""
    entries = sorted({r["entry"] for r in records})

    w0 = LANE_WORDS_BASE

    def lane_x(r):
        return float(max(0, int(r["lane_words"]) - w0) * r["n_pad"])

    def base_row(r):
        return [1.0, float(r["n_pad"]), float(r["e_pad"])]

    own = [r for r in records if r["entry"] == DEFAULT_SERVING_ENTRY] \
        or list(records)
    cw = _lstsq([base_row(r) + [lane_x(r)] for r in own],
                [float(r["bytes"]) for r in own])[-1]
    sol = {}
    for e in entries:
        mine = [r for r in records if r["entry"] == e]
        sol[e] = _lstsq([base_row(r) for r in mine],
                        [float(r["bytes"]) - cw * lane_x(r) for r in mine])

    graph_info: Dict[str, dict] = {}
    for fam in sorted({e.rsplit("@", 1)[-1] for e in entries}):
        dims = sorted({(int(r["n_pad"]), int(r["e_pad"])) for r in records
                       if r["entry"].endswith("@" + fam)
                       and r.get("graph_fit", True)})
        e0, epn = (_lstsq([[1.0, float(n)] for n, _ in dims],
                          [float(e) for _, e in dims])
                   if len(dims) > 1 else (0.0, dims[0][1] / dims[0][0]))
        graph_info[fam] = {"n_pad": [n for n, _ in dims],
                           "e_pad": [e for _, e in dims],
                           "e0": round(e0, 3) + 0.0,
                           "edges_per_node": round(epn, 6)}

    fitted: Dict[str, dict] = {}
    unfitted: Dict[str, dict] = {}
    points = []
    for e in entries:
        c0, cn, ce = sol[e]
        coeffs = {"c0": round(c0, 3), "cN": round(cn, 6),
                  "cE": round(ce, 6), "shards": 1, "w0": w0}
        resid = 0.0
        n_pts = 0
        for r in records:
            if r["entry"] != e:
                continue
            got, _ = _eval_model(coeffs, round(cw, 6), r["n_pad"],
                                 r["e_pad"], r["lane_words"])
            err = abs(got - r["bytes"]) / max(float(r["bytes"]), 1.0)
            resid, n_pts = max(resid, err), n_pts + 1
            points.append({**r, "planned_bytes": int(got),
                           "resid": round(err, 4)})
        doc = {**coeffs, "points": n_pts, "max_resid": round(resid, 4)}
        if resid <= MODEL_TOLERANCE:
            fitted[e] = doc
        else:
            unfitted[e] = doc
    for p in points:
        p["fitted"] = p["entry"] in fitted

    return {
        "schema": CAPACITY_SCHEMA,
        "comment": ("Per-(program, family) closed-form device-memory "
                    "coefficients: global_bytes = c0 + cN*N_pad + "
                    "cE*E_pad + cW*max(0, W-w0)*N_pad; per_card(s) = c0 + "
                    "(global-c0)/s. Fit by least squares over measured "
                    "peaks of SimService's serving program "
                    "(tools/fit_capacity.py): the graph's resident bytes "
                    "plus torch.cuda.max_memory_allocated over the "
                    "service's life; cN/cE are identified jointly through "
                    "each family's edges-per-node ratio. max_resid is the "
                    "worst relative fit error over the fitted entries' "
                    "points; an entry missing a point by more than "
                    "MODEL_TOLERANCE is listed under unfitted, not "
                    "planned."),
        "card": dict(card or {}),
        "graph": graph_info,
        "lane": {"cW": round(cw, 6),
                 "basis": f"least-squares fit over "
                          f"{DEFAULT_SERVING_ENTRY}'s points at every "
                          "lane-word count"},
        "entries": fitted,
        "unfitted": unfitted,
        "points": points,
        "max_resid": round(max((p["resid"] for p in points
                                if p["fitted"]), default=0.0), 4),
    }


# ---------------------------------------------------------------- planning


def _load_model(model: Optional[dict]) -> Optional[dict]:
    if model is not None:
        return model
    return load_membudgets().get("capacity_model")


def _eval_model(coeffs: dict, lane_cw: float, n_pad: int, e_pad: int,
                lane_words: int) -> Tuple[float, float]:
    """(global_bytes, shardable_bytes) of one fitted entry at a shape."""
    extra_w = max(0, int(lane_words) - int(coeffs.get("w0", 0)))
    shardable = (coeffs["cN"] * n_pad + coeffs["cE"] * e_pad
                 + lane_cw * extra_w * n_pad)
    return coeffs["c0"] + shardable, shardable


def _card_bytes(m: dict) -> float:
    """The fitted card's memory, the default per-card budget."""
    total = (m.get("card") or {}).get("total_memory")
    if not total:
        raise ValueError("the capacity model names no card memory — pass "
                         "per_chip_hbm_bytes")
    return float(total)


def plan(n_nodes: int, lanes: int = 0,
         entry: str = DEFAULT_SERVING_ENTRY,
         per_chip_hbm_bytes: Optional[float] = None,
         headroom: float = 0.9,
         shard_candidates: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128,
                                            256, 512, 1024),
         model: Optional[dict] = None) -> dict:
    """Extrapolate one program's device-memory footprint to an overlay
    without building it, from the checked-in coefficients (the
    reference's plan document: padded dims, the global footprint, a
    per-card table over ``shard_candidates`` and the smallest shard count
    under ``headroom × per_chip_hbm_bytes``, ``recommended_shards``).
    ``per_chip_hbm_bytes`` defaults to the memory of the card the model
    was fitted on. Raises ``ValueError`` without a model or entry."""
    m = _load_model(model)
    if not m or "entries" not in m:
        raise ValueError(
            "no capacity model: membudgets.json lacks `capacity_model` — "
            "fit one on the card with tools/fit_capacity.py")
    coeffs = m["entries"].get(entry)
    if coeffs is None:
        known = ", ".join(sorted(m["entries"]))
        raise ValueError(f"no fitted capacity entry {entry!r} "
                         f"(fitted: {known})")
    if per_chip_hbm_bytes is None:
        per_chip_hbm_bytes = _card_bytes(m)
    fam = entry.rsplit("@", 1)[-1]
    ginfo = m.get("graph", {}).get(fam, {})
    n_pad = _round_up(max(int(n_nodes), 1), NODE_PAD_MULTIPLE)
    e_est = (ginfo.get("edges_per_node", 0.0) * n_pad
             + ginfo.get("e0", 0.0))
    e_pad = _round_up(max(int(math.ceil(e_est)), 1), EDGE_PAD_MULTIPLE)
    lane_words = -(-int(lanes) // LANES_PER_WORD) if lanes else 0
    lane_cw = float(m.get("lane", {}).get("cW", 4.0))
    global_bytes, shardable = _eval_model(coeffs, lane_cw, n_pad, e_pad,
                                          lane_words)
    budget = headroom * float(per_chip_hbm_bytes)
    table = []
    recommended = None
    for s in shard_candidates:
        per_chip = coeffs["c0"] + shardable / max(int(s), 1)
        fits = per_chip <= budget
        table.append({"shards": int(s), "per_chip_bytes": int(per_chip),
                      "fits": fits})
        if fits and recommended is None:
            recommended = int(s)
    return {
        "entry": entry,
        "n_nodes": int(n_nodes), "n_pad": n_pad, "e_pad": e_pad,
        "lanes": int(lanes), "lane_words": lane_words,
        "global_bytes": int(global_bytes),
        "per_chip_hbm_bytes": int(per_chip_hbm_bytes),
        "headroom": headroom,
        "recommended_shards": recommended,
        "per_chip": table,
        "model_note": ("E_pad derived from the family edges-per-node "
                       "model; densities far from the fitted generators "
                       "are outside the model's warranty"),
    }


def serving_footprint_bytes(n_padded: int, e_padded: int,
                            lane_words: int, shards: int = 1,
                            entry: str = DEFAULT_SERVING_ENTRY,
                            model: Optional[dict] = None) -> Optional[int]:
    """Per-card planned bytes of the serving program over a concrete
    graph (padded dims) at ``lane_words`` of lane state; None when no
    model is checked in or the entry was never fitted."""
    m = _load_model(model)
    if not m:
        return None
    coeffs = (m.get("entries") or {}).get(entry)
    if coeffs is None:
        return None
    lane_cw = float(m.get("lane", {}).get("cW", 4.0))
    _, shardable = _eval_model(coeffs, lane_cw, int(n_padded),
                               int(e_padded), int(lane_words))
    return int(coeffs["c0"] + shardable / max(int(shards), 1))


def northstar_plan(per_chip_hbm_bytes: Optional[float] = None,
                   model: Optional[dict] = None) -> dict:
    """The 10k-lane (W = 313 words), 1M-node serving shape, planned from
    the checked-in coefficients."""
    return plan(n_nodes=1_000_000, lanes=10_016,
                per_chip_hbm_bytes=per_chip_hbm_bytes, model=model)
