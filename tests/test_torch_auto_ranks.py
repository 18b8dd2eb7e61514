"""The auto-sharded path across ranks (``parallel/auto.py``:
``shard_graph_auto`` on a rank ring, ``run_auto``) against the JAX
package's own ``auto.run_auto`` on ``ring_mesh(8)``.

Rank processes started by ``multihost.launch`` at worlds 2 and 4 (S = 8,
so 4 and 2 shards a rank), joined by gloo on loopback, each run
``tests/torch_auto_worker.py::auto_runs`` (torch and the port only): the
reference's auto-parity cases with its inputs and rounds (the worker
lists the files), the protocols that read the op layer, the adaptive
wave, the frontier lowering, the batched flood and the query families;
world 2 every case and world 4 the flood family, SIR and the adaptive
flood. Each rank keeps the edges whose receiver it owns; every
aggregation assembles its owned slices in one exchange
(``parallel/mesh.py``). The checks:

1. against the JAX reference's auto path (``run_auto`` on the
   auto-sharded graph, or the reference's loop of the same name for the
   batch and query cases): bool and int fields and stats exactly, f32
   within the reference test's stated tolerance (``rtol = 1e-5, atol =
   1e-6``; HITS ``atol = 1e-6``; routing ``rtol = 1e-6``; push-sum
   queries ``rtol = 1e-4, atol = 1e-6``, ``tests/test_torch_queries.py``)
   and exactly where the port's own tests hold them so (the floods'
   coverage, min-plus distances, the batch's occupancy). The port's
   ``hybrid`` and ``pallas`` runs (B1, its plain version on the CPU) are
   held to the reference's ``hybrid-blocked`` and ``blocked``, the same
   sums without its Pallas kernel;
2. every rank's final state is bit-equal to every other rank's, and the
   bool/int fields (the adaptive wave's work items among them) and the
   frontier lowerings' sparse and dense rounds equal the one-process
   port's;
3. the partition (needs no group, as ``tests/test_sharded.py``'s
   ``test_auto_graph_is_actually_sharded``): the parts' live edges sum
   to the graph's, each holds only edges it owns with about 1/W of the
   edge-extent bytes, and the node-extent fields are whole;
4. every op of ``ops/segment.py`` by every method it takes on a part
   (``frontier`` on sparse and dense inputs, with the branch each call
   took), the query lanes' ops of ``ops/lanes.py`` and
   ``draw_neighbor_slot`` equal the one-process port bit for bit;
5. communication (the counterpart of ``tests/test_auto_comm.py``): a
   flood round makes exactly one exchange, of ``N_pad / S`` bools a
   shard; the adaptive wave's sparse round one too, of ``N_pad / S``
   i32 claims a shard; and no exchange of the flood family carries more
   than ``4 * N_pad`` bytes;
6. what stays refused: a protocol without ``RUNS_ON_PART`` (a user's
   own; every protocol of ``models/`` carries it), by name.
"""

import concurrent.futures
import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu import models as JMOD  # noqa: E402
from p2pnetwork_tpu.parallel import auto as JA  # noqa: E402
from p2pnetwork_tpu.parallel import mesh as JM  # noqa: E402
from p2pnetwork_tpu.sim import engine as JE  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu_torch import models, prng  # noqa: E402
from p2pnetwork_tpu_torch.models import messagebatch, querybatch  # noqa: E402
from p2pnetwork_tpu_torch.ops import frontier as TFR  # noqa: E402
from p2pnetwork_tpu_torch.parallel import auto as TA  # noqa: E402
from p2pnetwork_tpu_torch.parallel import mesh as TM  # noqa: E402
from p2pnetwork_tpu_torch.parallel import multihost  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine  # noqa: E402
from p2pnetwork_tpu_torch.sim import failures  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402
from tests import torch_auto_worker as W  # noqa: E402
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401

S = 8
WORLDS = {2: tuple(W.CASES) + tuple(W.KERNEL_FLOODS), 4: W.FLOOD_FAMILY}
WORKER = str(Path(W.__file__).resolve())
#: Seconds a world's rank processes may take before the launcher stops
#: them.
RANK_TIMEOUT = 240
#: The reference tests' tolerances for f32 fields: ``(rtol, atol)``; the
#: cases the port's own tests hold exactly, exactly.
EXACT = (0.0, 0.0)
TOL = {"hits": (0.0, 1e-6), "routing": (1e-6, 0.0),
       "pushsum_queries": (1e-4, 1e-6),
       **dict.fromkeys(("adaptive_flood", "adaptive_hop", "flood_frontier",
                        "hopdist", "leader", "spanning", "batch_flood",
                        "minplus", "dht"), EXACT)}
DEFAULT_TOL = (1e-5, 1e-6)
#: The reference's method for the port's kernel methods.
JAX_METHOD = {"hybrid": "hybrid-blocked", "pallas": "blocked"}


def _launch_all() -> dict:
    """Each world's rank results, in rank order."""
    out = {}
    for world, names in WORLDS.items():
        parts = multihost.launch(f"{WORKER}:auto_runs", world, (S, names),
                                 timeout=RANK_TIMEOUT, device="cpu")
        assert [(p["rank"], p["world"]) for p in parts] == [
            (r, world) for r in range(world)]
        out[world] = parts
    out["ops"] = multihost.launch(f"{WORKER}:ops_runs", 2, (S,),
                                  timeout=RANK_TIMEOUT, device="cpu")
    return out


@pytest.fixture(scope="module")
def ranks():
    """The future of :func:`_launch_all`: the rank processes run in a
    thread while this process computes the references."""
    if len(jax.devices()) < S:
        pytest.skip(f"needs {S} devices (the virtual CPU mesh of conftest)")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(_launch_all)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            for name in sorted({n for _, n in CASES}):
                _jax_auto(name)
                _one_process(name)
        finally:
            torch.set_num_threads(n)
        yield future


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _fields(state) -> dict:
    """A reference state's fields as numpy (a batch's ``payload`` dict
    as ``payload.<name>``, as the worker's ``state_np``)."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, dict):
            out.update({f"{f.name}.{k}": _np(x) for k, x in v.items()})
        else:
            out[f.name] = _np(v)
    return out


@functools.lru_cache(maxsize=None)
def _jax_auto(name: str):
    """``(state fields, stats)`` of the JAX reference's ``run_auto`` of
    case ``name`` on ``ring_mesh(8)``, or of its loop of the same name
    (the summary in place of the stats) on the auto-sharded graph."""
    spec, (cls, kw), rounds, key = W.case(name)
    if kw.get("method") in JAX_METHOD:
        kw = dict(kw, method=JAX_METHOD[kw["method"]])
    g = JA.shard_graph_auto(W.build(JG, spec), JM.ring_mesh(S))
    proto = W.protocol(JMOD, cls, kw)
    if name not in W.LOOPS:
        state, stats = JA.run_auto(g, proto, jax.random.key(key), rounds)
    else:
        loop, init = W.LOOPS[name]
        args, kwargs = init(g.n_nodes)
        run = (JE.run_batch_until_coverage if loop == "batch"
               else JE.run_queries_until_done)
        state, stats = run(g, proto, proto.init(g, *args, **kwargs),
                           jax.random.key(key), max_rounds=rounds,
                           donate=False)
    return _fields(state), {k: _np(v) for k, v in stats.items()}


@functools.lru_cache(maxsize=None)
def _one_process(name: str):
    """The same case on the port's one-process engine, and the frontier
    lowerings' sparse and dense rounds it took."""
    n = torch.get_num_threads()
    try:
        g = W.build(TG, W.case(name)[0], device="cpu")
        TFR.ROUNDS.update(sparse=0, dense=0)
        state, stats = W.run_case(name, g, models, TA.run_auto, prng)
        return state, stats, dict(TFR.ROUNDS)
    finally:
        torch.set_num_threads(n)


def _exact(x: np.ndarray) -> bool:
    return x.dtype == bool or np.issubdtype(x.dtype, np.integer)


def _hold(got: np.ndarray, want: np.ndarray, name: str, what: str):
    """Bool/int exactly, f32 within the case's tolerance."""
    assert got.shape == want.shape, (name, what)
    if _exact(want):
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=f"{name}.{what}")
    else:
        rtol, atol = TOL.get(name, DEFAULT_TOL)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=f"{name}.{what}")


CASES = [(w, n) for w, names in WORLDS.items() for n in names]


@pytest.mark.parametrize("world,name", CASES)
def test_auto_run_matches_reference(ranks, world, name, one_torch_thread):
    run = ranks.result()[world][0]["runs"][name]
    want_state, want_stats = _jax_auto(name)
    assert set(run["state"]) == set(want_state)
    for k, want in want_state.items():
        _hold(run["state"][k], want, name, k)
    for k, want in want_stats.items():
        _hold(run["stats"][k], want.astype(run["stats"][k].dtype)
              if _exact(run["stats"][k]) else want, name, k)


@pytest.mark.parametrize("world,name", CASES)
def test_ranks_agree_and_ints_equal_one_process(ranks, world, name,
                                                one_torch_thread):
    parts = ranks.result()[world]
    first = parts[0]["runs"][name]
    for p in parts[1:]:
        run = p["runs"][name]
        for k, v in first["state"].items():
            assert run["state"][k].tobytes() == v.tobytes(), (name, k)
        assert run["exchanges"] == first["exchanges"]
        assert run["frontier_rounds"] == first["frontier_rounds"]
    state, stats, rounds = _one_process(name)
    for k, v in state.items():
        if _exact(v):
            np.testing.assert_array_equal(first["state"][k], v,
                                          err_msg=f"{name}.{k}")
    np.testing.assert_array_equal(first["stats"]["messages"],
                                  stats["messages"])
    assert first["frontier_rounds"] == rounds


@functools.lru_cache(maxsize=None)
def _one_process_ops():
    n = torch.get_num_threads()
    try:
        return W.run_ops(W.ops_graph(TG))
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("op", sorted(W.OP_METHODS) + ["draw", "frontier"])
def test_every_method_on_a_part_equals_one_process(ranks, op,
                                                   one_torch_thread):
    """Each op of ``ops/segment.py`` by each method on a part, the query
    lanes' ops and the neighbor draw equal the one-process port bit for
    bit, on every rank: OR, max and min-plus pick one of their terms, the
    sums add 0/1 floats or integers, or the same terms in the same order
    (the owner adds its nodes' terms). ``frontier``: the four ops that
    take it, on a dense and a sparse input, with the sparse and dense
    rounds taken (each rank takes the one-process branch)."""
    want = _one_process_ops()
    for part in ranks.result()["ops"]:
        for (o, m), got in part["ops"].items():
            if o != op:
                continue
            for g, w in zip(*(((x,) if isinstance(x, np.ndarray) else x)
                              for x in (got, want[(o, m)]))):
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), (
                    o, m, part["rank"])


# ------------------------------------------------------- the partition


def _parts(g, world: int):
    """Every rank's part of ``g`` on a ring of ``world`` ranks, built
    without a group (no exchange happens at build)."""
    out = []
    for rank in range(world):
        mesh = TM.RingMesh(n_shards=S, axis_name=TM.DEFAULT_AXIS,
                           device=torch.device("cpu"), rank=rank,
                           world=world, order=tuple(range(world)))
        out.append(TA.shard_graph_auto(g, mesh))
    return out


def _edge_bytes(g) -> int:
    """The bytes of ``g``'s edge-extent fields (COO, source CSR, blocked,
    hybrid remainder)."""
    ts = [g.senders, g.receivers, g.edge_mask, g.src_eid]
    for b in (g.blocked, g.hybrid.remainder):
        ts += [b.src, b.local_dst, b.mask]
    return sum(t.numel() * t.element_size() for t in ts)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_part_holds_only_its_edges(world, one_torch_thread):
    g = TG.watts_strogatz(8192, 4, 0.1, seed=0, hybrid=True, blocked=True,
                          source_csr=True, device="cpu")
    parts = _parts(g, world)
    assert sum(int(p.edge_mask.sum()) for p in parts) == int(
        g.edge_mask.sum())
    for rank, p in enumerate(parts):
        lo, hi = p.part.lo, p.part.hi
        assert (lo, hi) == (rank * g.n_nodes_padded // world,
                            (rank + 1) * g.n_nodes_padded // world)
        live = p.edge_mask
        assert ((p.receivers[live] >= lo) & (p.receivers[live] < hi)).all()
        # Every edge the rank owns, in the whole graph's order.
        own = g.edge_mask & (g.receivers >= lo) & (g.receivers < hi)
        assert torch.equal(p.senders[live], g.senders[own])
        for f in ("node_mask", "in_degree", "out_degree"):
            assert torch.equal(getattr(p, f), getattr(g, f)), f
        assert torch.equal(p.neighbors, g.neighbors[lo:hi])
        assert p.hybrid.masks.shape[1] == min(hi, g.n_nodes) - min(
            lo, g.n_nodes)
        # 1/W of the edge-extent bytes, plus a block's padding a layout.
        pad = sum(t.numel() * t.element_size() for t in (
            p.senders[:128], p.receivers[:128], p.edge_mask[:128],
            p.src_eid[:128]))
        for b, whole in ((p.blocked, g.blocked),
                         (p.hybrid.remainder, g.hybrid.remainder)):
            assert b.width <= whole.width
            assert b.n_blocks == -(-(hi - lo) // b.block)
            pad += b.width * 9  # one row of src, local_dst, mask
        assert _edge_bytes(p) <= _edge_bytes(g) / world + pad


def _rebuilt(kind: str):
    """A 512-node graph with the source-CSR view, reordered (``rcm``,
    ``degree``), grown by 100 nodes and wired to them, changed by a delta,
    or with failed nodes (dead edges left in the view)."""
    kw = dict(seed=0, source_csr=True, device="cpu")
    if kind in ("rcm", "degree"):
        return TG.watts_strogatz(512, 6, 0.2, reorder=kind, **kw)
    g = TG.watts_strogatz(512, 6, 0.2, **kw)
    if kind == "failed":
        return failures.fail_nodes(g, np.array([3, 40, 300]))
    live = g.edge_mask.numpy()
    s, r = g.senders.numpy()[live], g.receivers.numpy()[live]
    if kind == "grow":
        g = TG.grow(g, 100)
        return TG.apply_delta(g, TG.GraphDelta(
            add_senders=[0, 512, 611, 7], add_receivers=[512, 3, 200, 611]))
    return TG.apply_delta(g, TG.GraphDelta(
        add_senders=[0, 7, 300], add_receivers=[400, 9, 2],
        remove_senders=s[[5, 900, 2000]], remove_receivers=r[[5, 900, 2000]]))


@pytest.mark.parametrize("kind", ["rcm", "degree", "grow", "delta",
                                  "failed"])
def test_part_of_a_rebuilt_graph_holds_its_edges(kind, one_torch_thread):
    """``graph_part`` cuts the owned edges by receiver, so the live
    receivers must be sorted after a reordered build, a grow and a
    delta: the ranks' live edges, in rank order, are the whole graph's.
    Each rank's source-CSR rows are the owned runs of the whole rows
    (``row_slots`` through ``row_lo``), with the whole graph's
    ``row_len`` and ``max_out_span``."""
    g = _rebuilt(kind)
    parts = _parts(g, 2)
    for f in ("senders", "receivers"):
        got = torch.cat([getattr(p, f)[p.edge_mask] for p in parts])
        assert torch.equal(got, getattr(g, f)[g.edge_mask]), f
    n_pad, span = g.n_nodes_padded, max(g.max_out_span, 1)
    nodes = torch.arange(n_pad)
    want_eid, want_ok = g.gather_row_slots(
        g.src_offsets[nodes], g.src_offsets[nodes + 1], span)
    covered = torch.zeros_like(want_ok)
    for p in parts:
        assert p.part.max_out_span == g.max_out_span
        assert torch.equal(p.part.row_len,
                           g.src_offsets[1:] - g.src_offsets[:-1])
        eid, ok = TG.row_slots(p, nodes, torch.zeros_like(nodes), span)
        assert torch.equal(torch.where(ok, eid + p.part.edge_lo, -1),
                           torch.where(ok, want_eid, -1))
        assert not (covered & ok).any()
        covered |= ok
    assert torch.equal(covered, want_ok)


def test_resolve_comm_defaults_to_the_card():
    """``resolve_comm("auto")`` takes a missing device as
    ``_device.resolve`` does: the card unless the caller names another.
    It once took the CPU for a missing device, and with it the plain hop
    in place of the ring kernels."""
    assert TA.resolve_comm("auto") == "pallas"
    assert TA.resolve_comm("auto", "cpu") == "ppermute"
    assert TA.resolve_comm("ppermute") == "ppermute"


# -------------------------------------------------- communication


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_flood_round_is_one_node_extent_exchange(ranks, world,
                                                 one_torch_thread):
    runs = ranks.result()[world][0]["runs"]
    n_local = S // world
    for name in ("flood", "skew_flood", "flood_hybrid_blocked",
                 "flood_hybrid", "flood_pallas"):
        run, rounds = runs[name], W.case(name)[2]
        assert run["exchanges"] == rounds, name
        assert run["payloads"] == [((n_local, run["block"]), "torch.bool",
                                    n_local * run["block"])] * rounds
    # The adaptive wave: a dense round is the flood's exchange; a sparse
    # round one too, of the owned nodes' winning claims.
    run, rounds = runs["adaptive_flood"], W.case("adaptive_flood")[2]
    assert run["exchanges"] == rounds
    shape = (n_local, run["block"])
    kinds = [(p[0], p[1]) for p in run["payloads"]]
    assert set(kinds) == {(shape, "torch.bool"), (shape, "torch.int32")}
    # The first round runs sparse (the source alone), and a sparse round
    # overflows k: every one of its winners is exchanged and seen.
    assert kinds[0] == (shape, "torch.int32")
    k = W.case("adaptive_flood")[1][1]["k"]
    assert any(kind[1] == "torch.int32" and winners > k for kind, winners
               in zip(kinds, run["stats"]["frontier"]))
    for name in W.FLOOD_FAMILY:
        run = runs[name]
        # The reference's bound: no collective beyond 4 bytes a node.
        assert max(p[2] for p in run["payloads"]) * world <= 4 * run["n_pad"]
    sir = runs["sir"]
    assert sir["exchanges"] == W.case("sir")[2]
    assert {p[1] for p in sir["payloads"]} == {"torch.float32"}


# --------------------------------------------------- what stays refused


def _rank0_part(**kw):
    g = TG.watts_strogatz(256, 4, 0.1, seed=0, device="cpu", **kw)
    return _parts(g, 2)[0]


#: The protocols the engine takes on a part: every protocol of
#: ``models/`` (the twelve of the reference's auto tests, then the
#: op-layer protocols, the adaptive wave, the batched flood and the query
#: families, and since the library was ported across ranks the walks,
#: Plumtree, the failure detector, anti-entropy and Vivaldi).
RUNS_ON_PART = {"Flood", "SIR", "Gossip", "ConnectedComponents", "LubyMIS",
                "KCore", "BipartiteCheck", "DistanceVector", "HITS",
                "LabelPropagation", "Boruvka", "Bracha", "AdaptiveFlood",
                "AdaptiveHopDistance", "HopDistance", "LeaderElection",
                "PageRank", "PushSum", "SpanningTree", "BatchFlood",
                "MinPlusQueries", "DhtLookups", "PushSumQueries",
                "RandomWalks", "Plumtree", "FailureDetector", "AntiEntropy",
                "Vivaldi"}


def test_only_the_twelve_protocols_run_on_a_part():
    """The protocols marked ``RUNS_ON_PART`` are exactly the 28: every
    protocol class of ``models/`` (a class with ``init`` and ``step``,
    the structural ``Protocol`` aside)."""
    classes = [getattr(mod, n) for mod in (models, messagebatch, querybatch)
               for n in dir(mod) if isinstance(getattr(mod, n), type)]
    marked = {c.__name__ for c in classes
              if getattr(c, "RUNS_ON_PART", False)}
    protocols = {c.__name__ for c in classes if hasattr(c, "init")
                 and hasattr(c, "step") and c is not models.Protocol}
    assert marked == RUNS_ON_PART == protocols


@dataclasses.dataclass(frozen=True)
class UserProtocol(models.Flood):
    """A user's own protocol: a flood that does not say it runs on a
    part."""

    RUNS_ON_PART = False


@pytest.mark.parametrize("proto", [UserProtocol(source=0)],
                         ids=lambda p: type(p).__name__)
def test_other_protocols_on_a_part_are_refused(proto, one_torch_thread):
    """A protocol without ``RUNS_ON_PART`` may read edge arrays past the
    op layer and would see the rank's edges alone: the engine refuses it
    by name, at every entry."""
    part = _rank0_part(source_csr=True)
    with pytest.raises(NotImplementedError, match="RUNS_ON_PART"):
        TA.run_auto(part, proto, prng.key(0), 1)
    with pytest.raises(NotImplementedError, match=type(proto).__name__):
        engine.run_until_converged(part, proto, prng.key(0),
                                   stat="messages", threshold=0.0)
