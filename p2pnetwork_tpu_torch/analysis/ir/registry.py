"""graftaudit's lowering registry: every propagation variant x shape-class
(the port's counterpart of ``p2pnetwork_tpu/analysis/ir/registry.py``).

One :class:`Lowering` names one code path the port ships:
``or/frontier@ws1k`` is "``propagate_or`` through the frontier-compacted
method on the quasi-regular 1k Watts-Strogatz class". The names, ops,
variants, shape-classes, parity groups and slot budgets are the
reference's, so a lowering of one package has its twin in the other; the
port adds the routes of its hand-written segment-sum kernel (B1) that the
reference leaves out only because Pallas does not lower on the CPU:
``or/pallas``, ``or/hybrid``, ``sum/pallas`` and ``sum/hybrid`` at
``ws1k``.

``build(device)`` returns ``(fn, args, leaves)``. :func:`trace_lowering`
runs ``fn(*args)`` once on concrete inputs on ``device`` (the card unless
named, ``_device.resolve``) under a census (``census.py``): the torch calls
the port's code makes, their bytes, the host reads and uploads, each
hand-written kernel as its launches; and, for the ring entries, the
exchanges (``ring``'s launch counters, the one-card hops,
``mesh.EXCHANGES``) priced by ``parallel/commviz.py::ring_model_bytes``.
``leaves(result)`` (outside the census) gives the reference's output leaves,
whose dtypes and shapes are the signature the parity gate compares.

Inputs are seeded (numpy, seed 0) and sparse where a frontier reads them,
so every entry does real work and the frontier entries run their sparse
round. The classes are the reference's graphs, byte for byte: ``ws1k``
(Watts-Strogatz, ``auto`` routes to gather; every single-device layout)
and ``ba1k`` (Barabási-Albert with a skew table).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Lowering", "Trace", "all_lowerings", "zoo_at", "shape_class",
           "parse_shape_class", "trace_lowering", "signature_text",
           "flatten", "KERNEL_COUNTERS"]

#: The launch counters of each hand-written kernel's wrappers
#: (``module``, ``counter``) by census name: chip_smoke holds the census
#: to them on the card.
KERNEL_COUNTERS = {
    "segsum_or": ("segsum", "LAUNCHES"),
    "segsum_sum": ("segsum", "LAUNCHES"),
    "ring_shift": ("ring", "SHIFT_LAUNCHES"),
    "ring_segsum_or": ("ring", "SEGSUM_LAUNCHES"),
    "ring_segsum_sum": ("ring", "SEGSUM_LAUNCHES"),
    "ring_put": ("ring", "PUT_LAUNCHES"),
    "ring_gather": ("ring", "GATHER_LAUNCHES"),
    "ring_pass_segsum_or": ("ring", "PASS_SEGSUM_LAUNCHES"),
    "ring_pass_segsum_sum": ("ring", "PASS_SEGSUM_LAUNCHES"),
    "row_sum": ("rowsum", "LAUNCHES"),
    "gather_row_sum": ("rowsum", "LAUNCHES"),
    "threefry_bits": ("threefry", "LAUNCHES"),
    "threefry_uniform": ("threefry", "LAUNCHES"),
}


@dataclasses.dataclass(frozen=True)
class Lowering:
    """One auditable lowering: a name, its parity group and its build.

    ``slot_budget`` is the frontier gather bound in SLOTS (``k * span``)
    for entries on the compaction path (None: no slot rule).
    ``n_shards`` is the ring width the exchange model prices at (1: one
    device)."""

    name: str
    op: str
    variant: str
    shape_class: str
    build: Callable
    parity: bool = True
    slot_budget: Optional[int] = None
    n_shards: int = 1
    doc: str = ""


@dataclasses.dataclass
class Trace:
    """One run of a lowering: its census, output signature and exchange
    census (``error`` when it failed: a finding, never a skip)."""

    entry: Lowering
    census: Optional[object] = None        # census.CensusRecord
    out_sig: Optional[str] = None
    leaves: Optional[list] = None
    exchanges: Dict[str, int] = dataclasses.field(default_factory=dict)
    ici_bytes_est: int = 0
    memory: Optional[dict] = None
    log: Optional[list] = None
    error: Optional[str] = None


# ------------------------------------------------------------ shape-classes

# Bounded by construction: keys come from parse_shape_class (the two audit
# classes and their scaled siblings) and the device they live on.
_GRAPH_CACHE: Dict[tuple, object] = {}  # graftlint: ignore[unbounded-cache] -- keyed on the finite shape-class vocabulary x the devices of one process, not on user input


def parse_shape_class(name: str) -> Tuple[str, int]:
    """``(family, n_nodes)`` of a shape-class name: ``ws1k`` -> ("ws",
    1024), ``ba256`` -> ("ba", 256)."""
    import re

    m = re.fullmatch(r"(ws|ba)(\d+)(k?)", name)
    if not m:
        raise ValueError(f"unknown shape-class {name!r}")
    return m.group(1), int(m.group(2)) * (1024 if m.group(3) else 1)


def shape_class(name: str, device=None):
    """The canonical graph of one shape-class on ``device`` (host-built,
    cached): the reference's generators and seed, so the same bytes."""
    from p2pnetwork_tpu_torch import _device

    dev = _device.resolve(device)
    g = _GRAPH_CACHE.get((name, str(dev)))
    if g is None:
        from p2pnetwork_tpu_torch.sim import graph as G

        family, n = parse_shape_class(name)
        if family == "ws":
            g = G.watts_strogatz(n, 6, 0.2, seed=0, blocked=True,
                                 hybrid=True, skew_table=True,
                                 source_csr=True, device=dev)
        else:
            g = G.barabasi_albert(n, 3, seed=0, skew_table=True,
                                  source_csr=True, device=dev)
        _GRAPH_CACHE[(name, str(dev))] = g
    return g


# ------------------------------------------------------------ seeded inputs


def _rng():
    return np.random.default_rng(0)


def seeded_signal(n: int, kind: str) -> np.ndarray:
    """The registry's input of ``n`` nodes (numpy, seed 0): ``bool`` a
    sparse frontier (1/16 set), ``sum`` dense normals, ``max`` sparse
    normals over ``-inf``, ``minplus`` sparse distances over ``+inf``."""
    rng = _rng()
    on = rng.random(n) < 1 / 16
    if kind == "bool":
        return on
    vals = rng.standard_normal(n).astype(np.float32)
    if kind == "sum":
        return vals
    if kind == "max":
        return np.where(on, vals, -np.inf).astype(np.float32)
    if kind == "minplus":
        return np.where(on, np.abs(vals) * 4, np.inf).astype(np.float32)
    raise ValueError(kind)


def seeded_flood_state(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(seen, frontier)`` bool[n]: a sparse frontier inside a seen set
    of about twice its size."""
    frontier = seeded_signal(n, "bool")
    return frontier | np.roll(frontier, 7), frontier


def seeded_lanes(n: int) -> np.ndarray:
    """u32[1, n] lane words, set at a sparse 1/16 of the nodes."""
    rng = _rng()
    on = rng.random(n) < 1 / 16
    words = rng.integers(1, 2**32, size=n, dtype=np.uint64)
    return np.where(on, words, 0).astype(np.uint32).reshape(1, n)


def seeded_lane_matrix(n: int, op: str) -> np.ndarray:
    """f32[n, 8] query lanes: sparse distances over ``+inf``
    (``minplus_lanes``) or dense normals (``sum_lanes``)."""
    rng = _rng()
    on = rng.random((n, 8)) < 1 / 16
    vals = rng.standard_normal((n, 8)).astype(np.float32)
    if op == "minplus_lanes":
        return np.where(on, np.abs(vals) * 4, np.inf).astype(np.float32)
    return vals


def seeded_dht(n_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """i32[16] cursors and keys in ``[0, n_nodes)``."""
    rng = _rng()
    return (rng.integers(0, n_nodes, 16).astype(np.int32),
            rng.integers(0, n_nodes, 16).astype(np.int32))


def _t(a, device):
    import torch

    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# ------------------------------------------------------------ output leaves


def flatten(obj) -> list:
    """The tensor leaves of a result in the reference's pytree order
    (tuples and lists in order, dicts by sorted key, dataclass fields in
    order; numpy arrays as host tensors)."""
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, np.ndarray):
        return [torch.from_numpy(np.ascontiguousarray(obj))]
    if isinstance(obj, (tuple, list)):
        return [x for o in obj for x in flatten(o)]
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in flatten(obj[k])]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [x for f in dataclasses.fields(obj)
                for x in flatten(getattr(obj, f.name))]
    return []


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def signature_text(leaves) -> str:
    """Canonical text of an output's leaves: ``dtype[shape]`` per leaf,
    joined in tree order (the string the parity gate compares)."""
    return "; ".join(f"{_dtype_name(t.dtype)}[{','.join(map(str, t.shape))}]"
                     for t in leaves)


def _f32_bits(x) -> int:
    return int(np.array([x], dtype=np.float32).view(np.int32)[0])


def _limbs(messages: int) -> Tuple[int, int]:
    lo = int(messages) & 0xFFFFFFFF
    return int(messages) >> 32, lo - 2**32 if lo >= 2**31 else lo


def pack_summary(out: dict) -> np.ndarray:
    """The reference's ``i32[5]`` run summary of a coverage dict:
    ``[rounds, coverage bits, hi, lo bits, occupancy bits]``."""
    hi, lo = _limbs(out["messages"])
    return np.array([out["rounds"], _f32_bits(out["coverage"]), hi, lo,
                     _f32_bits(out.get("frontier_occupancy_mean", 0.0))],
                    dtype=np.int32)


def _done_words(lane_done) -> np.ndarray:
    bits = np.asarray(lane_done, dtype=bool)
    n_words = -(-bits.size // 32)
    padded = np.zeros(n_words * 32, dtype=np.uint64)
    padded[:bits.size] = bits
    words = (padded.reshape(n_words, 32)
             << np.arange(32, dtype=np.uint64)).sum(axis=1)
    return words.astype(np.uint32).view(np.int32)


def pack_batch(out: dict) -> np.ndarray:
    """The reference's ``i32[6 + W + B]`` batch summary of an unpacked
    batch dict (``utils/accum.py``'s layout)."""
    hi, lo = _limbs(out["messages"])
    head = np.array([out["rounds"], out["active_lanes"], out["completed"],
                     hi, lo, _f32_bits(out["occupancy_mean"])],
                    dtype=np.int32)
    return np.concatenate([head, _done_words(out["lane_done"]),
                           np.asarray(out["lane_rounds"], np.int32)])


def pack_query(out: dict) -> np.ndarray:
    """The reference's ``i32[6 + W + K + K]`` query summary."""
    vals = np.asarray(out["lane_values"])
    vals = vals.astype(np.float32).view(np.int32) if vals.dtype.kind == "f" \
        else vals.astype(np.int32)
    return np.concatenate([pack_batch(out), vals])


def ring_of(record, capacity: int) -> np.ndarray:
    """A ``FlightRecord``'s rows back in the raw ``f32[capacity, 7]``
    ring (runs within its capacity)."""
    ring = np.zeros((capacity, record.rows.shape[1]), dtype=np.float32)
    ring[:record.rounds] = record.rows[:record.rounds]
    return ring


# ------------------------------------------------------------ entries


def _kernel_entry(op: str, variant: str, cls: str, *, parity: bool = True,
                  doc: str = "") -> Lowering:
    """A propagate_* method entry (``ops/segment.py`` dispatch)."""
    kind = {"or": "bool", "sum": "sum", "max": "max",
            "minplus": "minplus"}[op]

    def build(device):
        from p2pnetwork_tpu_torch.ops import segment as S

        g = shape_class(cls, device)
        fn = {"or": S.propagate_or, "sum": S.propagate_sum,
              "max": S.propagate_max,
              "minplus": S.propagate_min_plus}[op]
        sig = _t(seeded_signal(g.n_nodes_padded, kind), g.device)
        return functools.partial(fn, g, method=variant), (sig,), None

    slot = _frontier_slots(cls) if variant == "frontier" else None
    return Lowering(name=f"{op}/{variant}@{cls}", op=op, variant=variant,
                    shape_class=cls, build=build, parity=parity,
                    slot_budget=slot, doc=doc)


def _frontier_slots(cls: str) -> Optional[int]:
    """The compaction buffer's slot bound (``ops/frontier.py``), or None
    where the budget disables the sparse path on the class."""
    from p2pnetwork_tpu_torch.ops import frontier as FR

    return FR.budget_slots(shape_class(cls, "cpu")) or None


def _flood_step_entry(variant: str, cls: str) -> Lowering:
    """The flood step, dense bool state or the bit-packed carry
    (``ops/bitset.py``), bool in and bool out so the parity gate compares
    the logical round."""

    def build(device):
        from p2pnetwork_tpu_torch.models.flood import (Flood, FloodBitState,
                                                       FloodState)
        from p2pnetwork_tpu_torch.ops import bitset

        g = shape_class(cls, device)
        proto = Flood(source=0, bitset=(variant == "bitset"))
        n = g.n_nodes_padded
        seen, frontier = (_t(a, g.device) for a in seeded_flood_state(n))

        def step(seen, frontier):
            if variant == "bitset":
                st = FloodBitState(seen=bitset.pack_bits(seen),
                                   frontier=bitset.pack_bits(frontier))
                st, stats = proto.step(g, st, None)
                return (bitset.unpack_bits(st.seen, n),
                        bitset.unpack_bits(st.frontier, n), stats)
            st, stats = proto.step(g, FloodState(seen=seen,
                                                 frontier=frontier), None)
            return st.seen, st.frontier, stats

        return step, (seen, frontier), None

    return Lowering(name=f"floodstep/{variant}@{cls}", op="floodstep",
                    variant=variant, shape_class=cls, build=build)


def _lanes_kernel_entry(variant: str, cls: str) -> Lowering:
    """A lane-packed ``propagate_or_lanes`` entry: ``[1, N]`` words (the
    reference's u32, the port's i32 of the same bits)."""

    def build(device):
        from p2pnetwork_tpu_torch.ops import segment as S

        g = shape_class(cls, device)
        lanes = _t(seeded_lanes(g.n_nodes_padded), g.device)
        return functools.partial(S.propagate_or_lanes, g,
                                 method=variant), (lanes,), None

    slot = None
    if variant == "frontier":
        from p2pnetwork_tpu_torch.ops import frontier as FR

        slot = FR.budget_slots_lanes(shape_class(cls, "cpu"),
                                     n_words=1) or None
    return Lowering(name=f"or_lanes/{variant}@{cls}", op="or_lanes",
                    variant=variant, shape_class=cls, build=build,
                    slot_budget=slot)


def _query_lanes_entry(op: str, variant: str, cls: str) -> Lowering:
    """A query-lane kernel (``ops/lanes.py``): ``f32[N_pad, 8]``."""

    def build(device):
        from p2pnetwork_tpu_torch.ops import lanes as L

        g = shape_class(cls, device)
        fn = {"minplus_lanes": L.propagate_min_plus_lanes,
              "sum_lanes": L.propagate_sum_lanes}[op]
        mat = _t(seeded_lane_matrix(g.n_nodes_padded, op), g.device)
        return functools.partial(fn, g, method=variant), (mat,), None

    return Lowering(name=f"{op}/{variant}@{cls}", op=op, variant=variant,
                    shape_class=cls, build=build)


def _dht_hop_entry(cls: str) -> Lowering:
    """The batched DHT hop (``ops/lanes.dht_hop_lanes``), 16 lookups."""

    def build(device):
        from p2pnetwork_tpu_torch.ops import lanes as L

        g = shape_class(cls, device)
        cur, keys = seeded_dht(g.n_nodes)
        return functools.partial(L.dht_hop_lanes, g, metric="ring"), (
            _t(cur, g.device), _t(keys, g.device)), None

    return Lowering(name=f"dht_hop/ring@{cls}", op="dht_hop",
                    variant="ring", shape_class=cls, build=build,
                    parity=False)


def _queries(g):
    from p2pnetwork_tpu_torch.models.querybatch import MinPlusQueries

    proto = MinPlusQueries(method="auto")
    return proto, proto.init(g, np.arange(8, dtype=np.int32) * 11 % 900,
                             np.arange(8, dtype=np.int32) * 37 % 900)


def _batch(g):
    from p2pnetwork_tpu_torch.models.messagebatch import BatchFlood

    proto = BatchFlood(method="auto")
    return proto, proto.init(g, np.arange(32, dtype=np.int32) * 7 % 1000)


def _resume_state(g):
    """The reference's mid-run flood state: seen the source, frontier
    node 1 (distinct tensors)."""
    import torch

    from p2pnetwork_tpu_torch.models import base
    from p2pnetwork_tpu_torch.models.flood import FloodState

    seed = base.source_seed(g, 0)
    frontier = torch.zeros_like(seed)
    frontier[1] = True
    return FloodState(seen=seed.clone(), frontier=frontier)


def _engine_query_entry(cls: str) -> Lowering:
    """The batched query loop (``engine.run_queries_until_done``): K = 8
    min-plus route lookups."""

    def build(device):
        from p2pnetwork_tpu_torch import prng
        from p2pnetwork_tpu_torch.sim import engine

        g = shape_class(cls, device)
        proto, qb = _queries(g)

        def run(qb):
            return engine.run_queries_until_done(g, proto, qb, prng.key(0),
                                                 max_rounds=64)

        return run, (qb,), lambda r: flatten(r[0]) + flatten(
            pack_query(r[1]))

    return Lowering(name=f"done/queries-engine@{cls}", op="done",
                    variant="queries-engine", shape_class=cls, build=build,
                    parity=False)


def _engine_batch_cov_entry(cls: str, rec: bool) -> Lowering:
    """The batched run-to-coverage loop (``engine.run_batch_until_
    coverage``), B = 32 floods; ``rec`` with the flight recorder."""

    def build(device):
        from p2pnetwork_tpu_torch import prng
        from p2pnetwork_tpu_torch.sim import engine, flightrec

        g = shape_class(cls, device)
        proto, batch = _batch(g)
        recorder = flightrec.FlightRecorder(capacity=64) if rec else None

        def run(batch):
            return engine.run_batch_until_coverage(
                g, proto, batch, prng.key(0), max_rounds=64,
                recorder=recorder)

        def leaves(r):
            out = flatten(r[0]) + flatten(pack_batch(r[1]))
            if rec:
                out += flatten(ring_of(r[1]["flight_record"], 64))
            return out

        return run, (batch,), leaves

    variant = "batchflood-engine" + ("-rec" if rec else "")
    return Lowering(name=f"cov/{variant}@{cls}", op="cov", variant=variant,
                    shape_class=cls, build=build, parity=False)


def _engine_cov_entry(cls: str) -> Lowering:
    """The single-device run-to-coverage loop from the protocol's init
    (``engine.run_until_coverage``)."""

    def build(device):
        from p2pnetwork_tpu_torch import prng
        from p2pnetwork_tpu_torch.models.flood import Flood
        from p2pnetwork_tpu_torch.sim import engine

        g = shape_class(cls, device)

        def run():
            return engine.run_until_coverage(
                g, Flood(source=0), prng.key(0), coverage_target=0.99,
                max_rounds=64)

        return run, (), lambda r: flatten(r[0]) + flatten(pack_summary(r[1]))

    return Lowering(name=f"cov/flood-engine@{cls}", op="cov",
                    variant="flood-engine", shape_class=cls, build=build,
                    parity=False)


def _engine_cov_rec_entry(cls: str) -> Lowering:
    """The run-to-coverage resume loop with the flight recorder
    (``engine.run_until_coverage_from(recorder=...)``)."""

    def build(device):
        from p2pnetwork_tpu_torch import prng
        from p2pnetwork_tpu_torch.models.flood import Flood
        from p2pnetwork_tpu_torch.sim import engine, flightrec

        g = shape_class(cls, device)
        recorder = flightrec.FlightRecorder(capacity=64)

        def run(state):
            return engine.run_until_coverage_from(
                g, Flood(source=0), state, prng.key(0),
                coverage_target=0.99, max_rounds=64, recorder=recorder)

        return run, (_resume_state(g),), lambda r: (
            flatten(r[0]) + flatten(pack_summary(r[1]))
            + flatten(ring_of(r[1]["flight_record"], 64)))

    return Lowering(name=f"cov/flood-engine-rec@{cls}", op="cov",
                    variant="flood-engine-rec", shape_class=cls,
                    build=build, parity=False)


def _ring(cls: str, device, **kw):
    """The class sharded over an 8-shard ring on one device."""
    from p2pnetwork_tpu_torch.parallel import mesh as M
    from p2pnetwork_tpu_torch.parallel import sharded as SH

    g = shape_class(cls, device)
    mesh = M.ring_mesh(8, device=g.device)
    return g, mesh, SH.shard_graph(g, mesh, **kw)


def _sharded_cov_entry(cls: str) -> Lowering:
    """The ring's run-to-coverage flood (``sharded.flood_until_
    coverage``, ``comm="ppermute"``)."""

    def build(device):
        from p2pnetwork_tpu_torch.parallel import sharded as SH

        g, mesh, sg = _ring(cls, device)

        def run():
            return SH.flood_until_coverage(
                sg, mesh, 0, coverage_target=0.99, max_rounds=64,
                return_state=True, comm="ppermute")

        return run, (), lambda r: flatten(r[0]) + flatten(pack_summary(r[1]))

    return Lowering(name=f"cov/flood-ppermute@{cls}", op="cov",
                    variant="flood-ppermute", shape_class=cls, build=build,
                    parity=False, n_shards=8)


def _ring_step_entry(variant: str, cls: str) -> Lowering:
    """One ring OR pass (``sharded.propagate``) per hop backend, a parity
    group: ``ppermute`` hops by roll on the segment layout, ``pallas`` on
    the MXU layout, where each step is the fused hop-and-sum kernel (B3)
    and the re-entry hops the ring-shift kernel (B2)."""

    def build(device):
        from p2pnetwork_tpu_torch.parallel import sharded as SH

        g, mesh, sg = _ring(cls, device, mxu=(variant == "pallas"))
        sig = _t(seeded_signal(g.n_nodes_padded, "bool").reshape(
            sg.n_shards, sg.block), g.device)
        return functools.partial(SH.propagate, sg, mesh, op="or",
                                 comm=variant), (sig,), None

    return Lowering(name=f"ringstep/{variant}@{cls}", op="ringstep",
                    variant=variant, shape_class=cls, build=build,
                    n_shards=8)


def _sharded_or_lanes_entry(cls: str) -> Lowering:
    """The lane-word ring pass (``sharded.propagate_or_lanes``)."""

    def build(device):
        from p2pnetwork_tpu_torch.parallel import sharded as SH

        g, mesh, sg = _ring(cls, device)
        lanes = SH.shard_lanes(sg, _t(seeded_lanes(g.n_nodes_padded),
                                      g.device))
        return functools.partial(SH.propagate_or_lanes, sg, mesh,
                                 comm="ppermute"), (lanes,), None

    return Lowering(name=f"or_lanes/sharded-ring@{cls}", op="or_lanes",
                    variant="sharded-ring", shape_class=cls, build=build,
                    parity=False, n_shards=8)


def _sharded_batch_cov_entry(cls: str) -> Lowering:
    """The ring's batched flood loop (``sharded.run_batch_until_
    coverage``), B = 32."""

    def build(device):
        from p2pnetwork_tpu_torch.models.messagebatch import BatchFlood
        from p2pnetwork_tpu_torch.parallel import sharded as SH

        g, mesh, sg = _ring(cls, device)
        batch = BatchFlood().init(g, np.arange(32, dtype=np.int32) * 7 % 1000)

        def run(batch):
            return SH.run_batch_until_coverage(
                sg, mesh, BatchFlood(), batch, max_rounds=64,
                comm="ppermute")

        def leaves(r):
            b = r[0]
            planes = [SH.shard_lanes(sg, p) for p in (b.seen, b.frontier,
                                                      b.sent)]
            rest = [b.source, b.admitted, b.done, b.rounds, b.seen_count,
                    b.target]
            return planes + rest + flatten(pack_batch(r[1]))

        return run, (batch,), leaves

    return Lowering(name=f"cov/batchflood-ring@{cls}", op="cov",
                    variant="batchflood-ring", shape_class=cls, build=build,
                    parity=False, n_shards=8)


def zoo_at(ws: str = "ws1k", ba: str = "ba1k") -> List[Lowering]:
    """The registry built at the given shape-classes
    (:func:`all_lowerings` is ``zoo_at("ws1k", "ba1k")``)."""
    entries: List[Lowering] = []
    for v in ("segment", "gather", "blocked", "skew", "frontier"):
        entries.append(_kernel_entry("or", v, ws))
    for v in ("segment", "gather", "blocked", "skew"):
        entries.append(_kernel_entry("sum", v, ws))
    for v in ("segment", "gather", "skew", "frontier"):
        entries.append(_kernel_entry("max", v, ws))
    for v in ("segment", "gather", "skew", "frontier"):
        entries.append(_kernel_entry("minplus", v, ws))
    entries.append(_flood_step_entry("dense", ws))
    entries.append(_flood_step_entry("bitset", ws))
    for v in ("segment", "gather", "frontier"):
        entries.append(_lanes_kernel_entry(v, ws))
    for v in ("gather", "segment"):
        entries.append(_query_lanes_entry("minplus_lanes", v, ws))
        entries.append(_query_lanes_entry("sum_lanes", v, ws))
    entries.append(_dht_hop_entry(ws))
    entries.append(_engine_query_entry(ws))
    entries.append(_engine_cov_entry(ws))
    entries.append(_engine_batch_cov_entry(ws, rec=False))
    entries.append(_engine_cov_rec_entry(ws))
    entries.append(_engine_batch_cov_entry(ws, rec=True))
    entries.append(_sharded_cov_entry(ws))
    entries.append(_ring_step_entry("ppermute", ws))
    entries.append(_ring_step_entry("pallas", ws))
    entries.append(_sharded_or_lanes_entry(ws))
    entries.append(_sharded_batch_cov_entry(ws))
    for v in ("segment", "skew", "frontier"):
        entries.append(_kernel_entry("or", v, ba))
    for v in ("segment", "frontier"):
        entries.append(_lanes_kernel_entry(v, ba))
    for op in ("minplus_lanes", "sum_lanes"):
        entries.append(_query_lanes_entry(op, "segment", ba))
    # The routes of the segment-sum kernel (B1), the main path's: the
    # blocked layout whole (`pallas`) and the hybrid remainder (`hybrid`).
    for op in ("or", "sum"):
        for v in ("pallas", "hybrid"):
            entries.append(_kernel_entry(op, v, ws))
    return entries


def all_lowerings() -> List[Lowering]:
    """The full registry, parity-grouped by ``(op, shape_class)``: the
    reference's 44 entries and B1's four routes."""
    return zoo_at("ws1k", "ba1k")


# ----------------------------------------------------------------- tracing


def _exchange_counters() -> Dict[str, int]:
    from p2pnetwork_tpu_torch.ops import ring
    from p2pnetwork_tpu_torch.parallel import mesh

    return {"gathers": ring.GATHER_LAUNCHES, "puts": ring.PUT_LAUNCHES,
            "group_exchanges": mesh.EXCHANGES}


def _ring_hops(calls: Dict[str, int], kernels: Dict[str, int]) -> int:
    """One-card hops of a ring run: the plain hop (``torch.roll``), the
    ring-shift kernel (B2) and the fused hop-and-sum (B3)."""
    return (calls.get("torch.roll", 0) + kernels.get("ring_shift", 0)
            + kernels.get("ring_segsum_or", 0)
            + kernels.get("ring_segsum_sum", 0))


def trace_lowering(entry: Lowering, device=None, *,
                   memory: bool = True) -> Trace:
    """Run one lowering once on ``device`` (the card unless named) under
    a census (and, with ``memory``, the live-storage tracker and the
    census's log, which ``memory.py`` reads). Never raises: a lowering
    that fails is a P1 finding (``rules.py``)."""
    from p2pnetwork_tpu_torch import _device
    from p2pnetwork_tpu_torch.analysis.ir import census as C
    from p2pnetwork_tpu_torch.parallel import commviz

    trace = Trace(entry=entry)
    try:
        dev = _device.resolve(device)
        fn, args, leaves = entry.build(dev)
        before = _exchange_counters()
        with C.run_census(dev, track=memory, log=memory,
                          inputs=flatten(args)) as census:
            result = fn(*args)
            if census.tracker is not None:
                # The result's own tensors (not its host arrays), read
                # before anything else allocates.
                outs = [t for t in flatten(result) if t.device == dev]
                trace.memory = {
                    "peak": census.tracker.peak,
                    "output": census.tracker.bytes_of(outs),
                    "result_keys": {k for k, _ in C._keys(outs)}}
        after = _exchange_counters()
        trace.census = census.record
        trace.log = census.log
        trace.leaves = leaves(result) if leaves is not None \
            else flatten(result)
        trace.out_sig = signature_text(trace.leaves)
    except Exception as e:  # noqa: BLE001 — any failure is the finding
        trace.error = f"{type(e).__name__}: {e}"
        return trace
    rec = trace.census
    if entry.n_shards > 1:
        ex = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        hops = _ring_hops(rec.calls, rec.kernels)
        if hops:
            ex["hops"] = hops
        trace.exchanges = ex
        trace.ici_bytes_est = sum(
            commviz.ring_model_bytes("ppermute", _hop_bytes(trace), 1)
            for _ in range(hops))
    return trace


def _hop_bytes(trace: Trace) -> int:
    """Bytes of one hop's payload: a shard of the ring's output."""
    leaves = trace.leaves or []
    if not leaves:
        return 0
    t = leaves[0]
    return t[0].numel() * t.element_size() if t.dim() else 0

