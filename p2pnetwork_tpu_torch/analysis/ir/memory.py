"""graftmem for the port: each lowering's peak live bytes, ratcheted
(the port's counterpart of ``p2pnetwork_tpu/analysis/ir/memory.py``).

The reference reads its compiler's memory analysis of a lowering and
checks it against a last-use liveness walk of the jaxpr. The port has no
compiled program: its record comes from the live-storage tracker
(``census.LiveTracker``, a ``TorchDispatchMode``) over one run of the
lowering, and its cross-check from a last-use walk over the census's
recorded calls (each call's operands and results, in order):

- ``tracked.peak``: the most bytes of storages the run allocated that
  were alive at once (the ratcheted number); ``tracked.output``: the
  run's storages the result holds;
- ``analytic.peak``: the walk's peak, each result live from its call to
  its last use as an operand (or to the end, when returned);
  ``analytic.output``: the bytes of the results the lowering returns.

The rules, as the reference's:

========================  =====  ==========================================
rule                      sev    fires on
========================  =====  ==========================================
``ir-mem-regression``     P1     tracked peak bytes past the blessed
                                 tolerance (a shrink past it is P2: bless
                                 the win so the ratchet holds)
``ir-mem-unbudgeted``     P1     a lowering with no blessed memory budget
``ir-mem-model-drift``    P2     the walk's output bytes and the tracker's
                                 disagree past ``MODEL_TOLERANCE``: a
                                 result pins storage the calls did not
                                 hand back, or the walk lost a call
========================  =====  ==========================================

The records live in the port's ``membudgets.json`` under ``entries``,
beside the planner's ``capacity_model`` (``capacity.py``), which a bless
keeps as it is. Inside a hand-written kernel's wrapper only its outputs
count, on the CPU and on the card alike, so the numbers are the same on
both.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

from p2pnetwork_tpu_torch.analysis.core import Finding
from p2pnetwork_tpu_torch.analysis.ir.registry import (Trace,
                                                       parse_shape_class)

__all__ = ["collect_memory", "analytic_memory", "load_membudgets",
           "write_membudgets", "check_membudgets",
           "default_membudgets_path", "DEFAULT_TOLERANCE",
           "MODEL_TOLERANCE", "SCHEMA"]

SCHEMA = "graftmem-torch-v1"
DEFAULT_TOLERANCE = 0.20
MODEL_TOLERANCE = 0.20


def _lifetimes(log: Sequence[tuple]) -> tuple:
    """The log with storage keys made unique per lifetime: an address a
    call produces starts a new lifetime unless the call also read it (an
    in-place op, a view of an operand); an allocator may reuse an address
    once its storage dies. Arguments get negative keys, results
    positive ones; returns the log and the last key of each address."""
    current: Dict[int, int] = {}
    n_arg = n_made = 0
    out = []
    for name, ins, outs in log:
        ins2 = []
        for key, nbytes in ins:
            if key not in current:  # an argument: no call made it
                n_arg += 1
                current[key] = -n_arg
            ins2.append((current[key], nbytes))
        read = {key for key, _ in ins}
        outs2 = []
        for key, nbytes in outs:
            if key not in read:
                n_made += 1
                current[key] = n_made
            outs2.append((current[key], nbytes))
        out.append((name, ins2, outs2))
    return out, current


def analytic_memory(log: Sequence[tuple], result_keys: set) -> Dict[str, int]:
    """The last-use walk over a census log (``(name, operands,
    results)``, each a list of ``(storage key, bytes)``): ``peak`` of the
    results live at once, ``output`` the bytes of the results the
    lowering returns (``result_keys``, storage keys at the end)."""
    log, current = _lifetimes(log)
    result_keys = {current[k] for k in result_keys if k in current}
    last_use: Dict[int, int] = {}
    size: Dict[int, int] = {}
    for i, (_, ins, outs) in enumerate(log):
        for key, _ in ins:
            last_use[key] = i
        for key, nbytes in outs:
            size[key] = max(size.get(key, 0), nbytes)
    live: Dict[int, int] = {}
    cur = peak = 0
    for i, (_, ins, outs) in enumerate(log):
        for key, _ in outs:
            if key > 0 and key not in live:
                live[key] = size[key]
                cur += size[key]
        peak = max(peak, cur)
        for key, _ in list(ins) + list(outs):
            if key in live and key not in result_keys and \
                    last_use.get(key, -1) <= i:
                cur -= live.pop(key)
    output = sum(size[k] for k in result_keys if k > 0)
    return {"peak": peak, "output": output}


def collect_memory(traces: Sequence[Trace]) -> Dict[str, dict]:
    """``{name: {"tracked": {...}, "analytic": {...}, "model_ratio"}}``
    for every lowering traced with the tracker and the log."""
    out: Dict[str, dict] = {}
    for t in traces:
        if t.error is not None or t.memory is None:
            continue
        rec = {"tracked": {"peak": int(t.memory["peak"]),
                           "output": int(t.memory["output"])}}
        if t.log is not None:
            analytic = analytic_memory(t.log, t.memory["result_keys"])
            rec["analytic"] = analytic
            have = rec["tracked"]["output"]
            if have > 0:
                rec["model_ratio"] = round(analytic["output"] / have, 4)
        out[t.entry.name] = rec
    return out


def default_membudgets_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "membudgets.json")


def load_membudgets(path: Optional[str] = None) -> dict:
    """The checked-in document (``{}`` when absent)."""
    path = path or default_membudgets_path()
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def write_membudgets(records: Dict[str, dict], path: Optional[str] = None,
                     tolerance: float = DEFAULT_TOLERANCE) -> str:
    """Bless the current records into the file, keeping its other keys
    (the planner's ``capacity_model``) as they are."""
    import torch

    path = path or default_membudgets_path()
    doc = load_membudgets(path)
    doc.update({
        "schema": SCHEMA,
        "comment": ("graftmem budgets: each lowering's peak live bytes "
                    "(tracked.peak, the live-storage tracker over one run "
                    "at the 1k shape-classes) and the census walk's "
                    "cross-check. CI fails on peak drift past `tolerance` "
                    "or walk/tracker disagreement past `model_tolerance`; "
                    "bless with `python -m p2pnetwork_tpu_torch.analysis.ir "
                    "--device cpu --write-membudgets` and commit the diff. "
                    "`capacity_model` is the planner's (capacity.py), "
                    "fitted on the card by tools/fit_capacity.py."),
        "torch": torch.__version__,
        "tolerance": tolerance,
        "model_tolerance": MODEL_TOLERANCE,
        "entries": {k: records[k] for k in sorted(records)},
    })
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return path


def _mem_finding(rule: str, name: str, message: str,
                 severity: str) -> Finding:
    return Finding(severity=severity, file=name, line=0, col=0,
                   rule=rule, message=message)


def _class_of(name: str) -> str:
    cls = name.rsplit("@", 1)[-1] if "@" in name else "?"
    try:
        parse_shape_class(cls)
        return cls
    except ValueError:
        return "?"


def check_membudgets(records: Dict[str, dict], budgets: dict,
                     tolerance: Optional[float] = None,
                     skipped: Optional[Sequence[str]] = None
                     ) -> List[Finding]:
    """Current memory records against the blessed ones (module doc)."""
    entries = budgets.get("entries", {})
    if tolerance is None:
        tolerance = float(budgets.get("tolerance", DEFAULT_TOLERANCE))
    model_tol = float(budgets.get("model_tolerance", MODEL_TOLERANCE))
    out: List[Finding] = []
    for name, rec in sorted(records.items()):
        ratio = rec.get("model_ratio")
        if ratio is not None and abs(ratio - 1.0) > model_tol:
            out.append(_mem_finding(
                "ir-mem-model-drift", name,
                f"the census walk's output bytes are {ratio:.2f}x the "
                f"tracker's (tolerance {model_tol:.0%}) — a result pins "
                "storage the calls did not hand back, or the walk lost a "
                "call (analysis/ir/memory.py)", "P2"))
        budget = entries.get(name)
        if budget is None:
            out.append(_mem_finding(
                "ir-mem-unbudgeted", name,
                "new lowering with no blessed memory budget — run "
                "`--write-membudgets` and commit membudgets.json", "P1"))
            continue
        if "tracked" not in budget:
            out.append(_mem_finding(
                "ir-mem-regression", name,
                "blessed memory budget has no tracked bytes — re-bless "
                "with --write-membudgets", "P1"))
            continue
        have = rec["tracked"]["peak"]
        want = budget["tracked"]["peak"]
        if want > 0:
            r = have / want
            if r > 1.0 + tolerance:
                out.append(_mem_finding(
                    "ir-mem-regression", name,
                    f"peak live bytes grew {r:.2f}x over budget ({have} vs "
                    f"{want} bytes, tolerance {tolerance:.0%}) — explain "
                    "the regression or bless it with --write-membudgets",
                    "P1"))
            elif r < 1.0 - tolerance:
                out.append(_mem_finding(
                    "ir-mem-regression", name,
                    f"peak live bytes shrank to {r:.2f}x of budget ({have} "
                    f"vs {want} bytes) — bless it (--write-membudgets) so "
                    "the ratchet holds the new level", "P2"))
    stale = sorted(set(entries) - set(records) - set(skipped or ()))
    for name in stale:
        out.append(_mem_finding(
            "ir-mem-regression", name,
            f"memory budget entry for a lowering the registry no longer "
            f"produces (shape-class {_class_of(name)}) — regenerate "
            "(--write-membudgets) so the file matches HEAD", "P2"))
    return sorted(out)
