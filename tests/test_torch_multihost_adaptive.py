"""The ring across processes, the parts it once refused
(``parallel/sharded.py`` on a ring split over ranks: the frontier-adaptive
loop, the recorder on the dense flood and the lane ring, a fault-spec
comm; ``parallel/commviz.py::ring_hop_census``; a checkpoint whose leaves
are placed by the template's layout) against the JAX package's ring and
the port's one-process ring.

Rank processes started by ``multihost.launch`` at worlds 2 and 4 (S = 8,
so 4 and 2 shards a rank), joined by gloo on loopback, each run
``tests/torch_rank_worker.py::adaptive`` (torch and the port only) on the
reference worker's graph (``WS(512, 6, 0.2)``): on every layout the
adaptive flood and hop distance (``adaptive_k=16``: sparse and dense
rounds), the dense flood recorded into a ring of 4 rows (it wraps) and the
flood under the reference's faulted-flood schedule; on ``segment`` 64
lanes of the batched plane recorded beside a plain run; the hop census;
the placed checkpoint, saved at world 2 and restored at worlds 2, 4, 1
and in this process. World 8 runs the census alone. The ranks' rows,
gathered in rank order, and every summary must equal:

1. the JAX ring on the 8-device virtual CPU mesh (``comm="ppermute"``):
   integers, bools and stats exactly, f32 (the rows, the coverage and
   occupancy) by bits, the fault counts on every rank the reference's
   (its host replay runs in every process), the census's permute pairs
   and host classes ``ring_hop_classes``' of the reference's lowered
   flood. The reference's floods give the same bits on every layout, so
   it runs once, on ``segment``. No run here adds f32 terms on
   ``segment`` (the one stated tolerance of ROADMAP.md §C), so no
   tolerance is needed;
2. the port's one-process ring (``adaptive`` in this process), bit for
   bit, ``LAST_SPARSE_ROUNDS`` included. A process holds no group, so its
   runs make no exchange: the ranks' exchanges are checked against their
   counts a round instead.
"""

import concurrent.futures
import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu import telemetry as JT  # noqa: E402
from p2pnetwork_tpu.chaos import device as JCD  # noqa: E402
from p2pnetwork_tpu.models import hopdist as JHD  # noqa: E402
from p2pnetwork_tpu.models import Flood as JFlood  # noqa: E402
from p2pnetwork_tpu.models.messagebatch import (  # noqa: E402
    BatchFlood as JBatchFlood)
from p2pnetwork_tpu.parallel import commviz as JCV  # noqa: E402
from p2pnetwork_tpu.parallel import mesh as JM  # noqa: E402
from p2pnetwork_tpu.parallel import sharded as JS  # noqa: E402
from p2pnetwork_tpu.sim import flightrec as JF  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu.sim.simnode import JaxSimNode  # noqa: E402
from p2pnetwork_tpu_torch.chaos import device as chaos_device  # noqa: E402
from p2pnetwork_tpu_torch.parallel import mesh as TM  # noqa: E402
from p2pnetwork_tpu_torch.parallel import multihost  # noqa: E402
from p2pnetwork_tpu_torch.parallel import sharded as TS  # noqa: E402
from p2pnetwork_tpu_torch.sim import checkpoint, flightrec  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402
from tests import torch_rank_worker as W  # noqa: E402
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401
from tests.test_torch_multihost_protocols import _same  # noqa: E402

S = 8
WORLDS = (2, 4)
LAYOUTS = list(W.LAYOUTS)
#: The reference demo's layout: hosts of 4 ranks at world 8.
PER_HOST = 4
WORKER = str(Path(W.__file__).resolve())
#: Seconds a rank suite may take before the launcher stops it.
RANK_TIMEOUT = 240


def _launch_all(ckpt_dir: str) -> dict:
    """``adaptive`` at each world, gathered (``W.gather_runs``), world 2
    first (it saves the placed checkpoint), then the checkpoint restored
    by a rank process of world 1 and the census at world 8. The census
    records of each world are whole on every rank, checked equal."""
    out = {}
    for world in WORLDS:
        parts = multihost.launch(f"{WORKER}:adaptive", world,
                                 (S, ckpt_dir, world == 2),
                                 timeout=RANK_TIMEOUT)
        assert [(p["rank"], p["world"]) for p in parts] == [
            (r, world) for r in range(world)]
        census = [p.pop("census") for p in parts]
        assert all(c == census[0] for c in census)
        out[world] = W.gather_runs(parts)
        out[world]["census"] = census[0]
    out[1] = W.gather_runs(multihost.launch(
        f"{WORKER}:restore_placed", 1, (S, ckpt_dir), timeout=RANK_TIMEOUT))
    parts = multihost.launch(f"{WORKER}:census", 8, (S, PER_HOST),
                             timeout=RANK_TIMEOUT)
    assert all(p == parts[0] for p in parts)
    out[8] = {"census": parts[0]}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``(ckpt_dir, future of _launch_all)``: the rank processes run in a
    thread while this process computes the JAX ring and the one-process
    port."""
    if len(jax.devices()) < S:
        pytest.skip(f"needs {S} devices (the virtual CPU mesh of conftest)")
    ckpt_dir = str(tmp_path_factory.mktemp("adaptive-ckpt"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield ckpt_dir, pool.submit(_launch_all, ckpt_dir)


def _ranks(ranks, world: int) -> dict:
    return ranks[1].result()[world]


@functools.lru_cache(maxsize=None)
def _one_process(ckpt_dir: str) -> dict:
    n = torch.get_num_threads()
    try:
        one = W.adaptive(S, ckpt_dir, save=True)
        census = one.pop("census")
        return {**W.gather_runs([one]), "census": census}
    finally:
        torch.set_num_threads(n)


def _one(ranks) -> dict:
    return _one_process(str(Path(ranks[0]) / "one-process"))


def _jax_faults() -> dict:
    reg = JT.default_registry()
    return {k: reg.value("chaos_device_faults_total", kind=k)
            for k in W.FAULT_KINDS}


def _record(fr) -> dict:
    return {"rows": fr.rows, "rounds": fr.rounds, "dropped": fr.dropped}


@functools.lru_cache(maxsize=None)
def _jax_ring() -> dict:
    """The JAX ring's records, in ``W.gather_runs``' form."""
    jg = JG.watts_strogatz(*W.GRAPH, seed=0)
    mesh = JM.ring_mesh(S)
    pp = dict(comm="ppermute")
    sg = JS.shard_graph(jg, mesh, source_csr=True)
    seen, res = JS.flood_until_coverage(sg, mesh, 0,
                                        adaptive_k=W.ADAPTIVE_K, **pp)
    out = {"adaptive": {"seen": np.asarray(seen), "out": res}}
    (dist, front, rnd), res = JS.hopdist_until_coverage(
        sg, mesh, JHD.HopDistance(source=0), adaptive_k=W.ADAPTIVE_K, **pp)
    out["adaptive_hop"] = {"dist": np.asarray(dist),
                           "frontier": np.asarray(front),
                           "round": np.asarray(rnd), "out": res}
    seen, res = JS.flood_until_coverage(
        sg, mesh, 0, recorder=JF.FlightRecorder(capacity=W.REC_CAPACITY),
        **pp)
    res = dict(res)
    out["recorded"] = {"seen": np.asarray(seen),
                       "record": _record(res.pop("flight_record")),
                       "out": res}
    c0 = _jax_faults()
    seen, res = JS.flood_until_coverage(
        sg, mesh, 0, max_rounds=64, comm=JCD.FaultSpec(
            JCD.FaultSchedule(**W.RING_FAULTS), "ppermute"))
    out["faulted"] = {"seen": np.asarray(seen), "out": res, "faults": {
        k: v - c0[k] for k, v in _jax_faults().items()}}
    proto = JBatchFlood(method="segment")
    batch, res = JS.run_batch_until_coverage(
        sg, mesh, proto, proto.init(jg, W.lane_sources(jg.n_nodes),
                                    coverage_target=0.99),
        max_rounds=64, donate=False,
        recorder=JF.FlightRecorder(capacity=W.REC_CAPACITY), **pp)
    res = dict(res)
    out["lanes_recorded"] = {"seen": np.asarray(batch.seen),
                             "record": _record(res.pop("flight_record")),
                             "out": res}
    within, cross, per_permute = JCV.ring_hop_classes(
        JCV.lower_ring_flood_hlo(), lambda d: d // PER_HOST)
    out["census"] = {"within": within, "cross": cross,
                     "per_permute": per_permute}
    return out


def _check(ranks, world, name, jax_name, *keys):
    """Run ``name`` at ``world``: equal to the one-process port by bits
    (all but its exchanges) and, in ``keys``, to the JAX ring's
    ``jax_name`` record."""
    got = dict(_ranks(ranks, world)[name])
    one = dict(_one(ranks)[name])
    assert one.pop("exchanges") == 0
    exchanges = got.pop("exchanges")
    assert W._equal_tree(got, one), name
    want = _jax_ring()[jax_name]
    for k in keys:
        _same(got[k], want[k], f"{name}.{k}")
    return got, exchanges


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("world", WORLDS)
def test_rank_adaptive_flood(ranks, world, layout, one_torch_thread):
    got, exchanges = _check(ranks, world, f"adaptive-{layout}", "adaptive",
                            "seen", "out")
    rounds = got["out"]["rounds"]
    assert 0 < len(got["sparse"]) < rounds  # sparse and dense rounds both
    # Two exchanges a round (the list's gather, the budget's max), two
    # for the first list and budget, one for the start's coverage.
    assert exchanges == 2 * rounds + 3


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("world", WORLDS)
def test_rank_adaptive_hop_distance(ranks, world, layout, one_torch_thread):
    got, exchanges = _check(ranks, world, f"adaptive_hop-{layout}",
                            "adaptive_hop", "dist", "frontier", "round",
                            "out")
    assert 0 < len(got["sparse"]) < got["out"]["rounds"]
    assert exchanges == 2 * got["out"]["rounds"] + 2


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("world", WORLDS)
def test_rank_recorded_flood(ranks, world, layout, one_torch_thread):
    got, exchanges = _check(ranks, world, f"recorded-{layout}", "recorded",
                            "seen", "record", "out")
    assert got["record"]["dropped"] > 0  # the ring wrapped
    # The dense flood's one exchange a round and the start's coverage:
    # the recorder adds none.
    assert exchanges == got["out"]["rounds"] + 1


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("world", WORLDS)
def test_rank_faulted_flood(ranks, world, layout, one_torch_thread):
    got, _ = _check(ranks, world, f"faulted-{layout}", "faulted", "seen",
                    "out", "faults")
    assert all(got["faults"][k] > 0 for k in W.FAULT_KINDS)


@pytest.mark.parametrize("world", WORLDS)
def test_rank_recorded_lanes(ranks, world, one_torch_thread):
    got, exchanges = _check(ranks, world, "lanes_recorded",
                            "lanes_recorded", "seen", "record", "out")
    plain = dict(_ranks(ranks, world)["lanes"])
    assert plain.pop("exchanges") == exchanges  # the recorder adds none
    assert plain["record"] is None
    _same(plain["seen"], got["seen"], "plain seen")
    assert W._equal_tree(plain["out"], got["out"])
    assert got["record"]["dropped"] > 0


@functools.lru_cache(maxsize=None)
def _jax_node() -> tuple:
    """The reference's Flood node on one device through the same calls:
    its summary and seen set (the mesh node's summary is the
    single-device node's, ``tests/test_torch_ring_adaptive.py``)."""
    node = JaxSimNode(graph=JG.watts_strogatz(*W.GRAPH, seed=0),
                      protocol=JFlood(source=0), seed=0)
    node.run_rounds(1)
    summary = node.run_until_coverage(0.99)
    return summary, np.asarray(node.sim_state.seen)


@pytest.mark.parametrize("world", WORLDS)
def test_rank_adaptive_mesh_node(ranks, world, one_torch_thread):
    """``TorchSimNode``'s mesh backend with ``adaptive_k`` on a ring of
    ranks: its events, summary, rows and sparse rounds the one-process
    mesh node's, its summary and seen set the reference's node's."""
    got = _ranks(ranks, world)["node"]
    assert W._equal_tree(got, _one(ranks)["node"])
    summary, seen = _jax_node()
    assert got["summary"] == summary
    assert got["events"][-1] == {"sim_run": True, **summary}
    _same(got["seen"].reshape(-1)[:seen.size], seen, "seen")
    assert got["sparse"]


@pytest.mark.parametrize("world", [2, 4, 8])
def test_rank_hop_census(ranks, world, one_torch_thread):
    """The flood's hops by host (hosts of ``world // 2`` ranks at worlds 2
    and 4, of 4 at world 8: shards 0-3 on one host, 4-7 on the other in
    each) against the reference's ``ring_hop_classes`` of its lowered
    flood with ``host_of = d // 4``: the same classes, and the same pairs
    with each shard mapped to its rank (at world 8 a shard is a rank)."""
    got = _ranks(ranks, world)["census"]
    want = _jax_ring()["census"]
    assert (got["within"], got["cross"]) == (want["within"], want["cross"])
    rank_of = [d // (S // world) for d in range(S)]
    assert got["per_permute"] == [[(rank_of[a], rank_of[b]) for a, b in p]
                                  for p in want["per_permute"]]
    # A pass makes S - 1 hops of that permute; the round one exchange,
    # across both hosts.
    assert (got["hops"], got["hops_within"], got["hops_cross"]) == (
        S - 1, (S - 1) * want["within"], (S - 1) * want["cross"])
    assert (got["exchanges"], got["exchanges_cross"]) == (1, 1)
    if world == 8:
        assert got["per_permute"] == want["per_permute"]


def test_one_process_hop_census(ranks, one_torch_thread):
    """In one process every hop stays in the process and no round
    exchanges anything."""
    got = _one(ranks)["census"]
    assert (got["within"], got["cross"], got["hops"]) == (S, 0, S - 1)
    assert got["per_permute"] == [[(0, 0)] * S]
    assert (got["exchanges"], got["exchanges_cross"]) == (0, 0)


@pytest.mark.parametrize("where", [2, 4, 1, "one-process"])
def test_rank_placed_checkpoint(ranks, where, one_torch_thread):
    """Part of the state per shard (a leaf of two dimensions and one of
    one), part replicated (the lane words ``[2, 512]``), named by the
    layout: saved by world 2's ranks, restored onto a ring of ``where``
    (world 1 a rank process, then this process's ring). The rows span
    every rank and equal the one-process state, the replicated leaf is
    whole on every rank, the counters are the saved ones."""
    one = _one(ranks)["placed"]
    if where == "one-process":
        _ranks(ranks, 2)  # world 2 has saved
        got = W.gather_runs([W.restore_placed(S, ranks[0])])["placed"]
    else:
        got = _ranks(ranks, where)["placed"]
    for k in ("seen", "counts", "lanes"):
        _same(got[k], one[k], k)
    _same(got["lanes"], _jax_ring()["lanes_recorded"]["seen"], "lanes")
    assert (got["round"], got["messages"]) == (3, 7)
    assert got["key"].tolist() == [0, W.KEYS["ckpt"]]
    if where in WORLDS:
        assert got["equal"]  # each rank's restored leaves are its own
    manifest = checkpoint.read_manifest(f"{ranks[0]}/placed")
    assert manifest["world"] == 2
    assert [leaf["per_shard"] for leaf in manifest["leaves"]] == [
        W.PLACED[k] for k in sorted(W.PLACED)]


def test_placed_state_needs_its_layout(tmp_path, one_torch_thread):
    """ROADMAP.md §C C9: by dimension count alone the lane words
    ``[2, 512]`` would be cut as shard rows, which the shards' ``[8,
    ...]`` leaves contradict; the layout names them replicated, and a
    template placed otherwise than the save is refused."""
    mesh = TM.ring_mesh(S, device="cpu")
    g = TG.watts_strogatz(*W.GRAPH, seed=0, device="cpu")
    sg = TS.shard_graph(g, mesh)
    seen, _ = TS.flood_until_coverage(sg, mesh, 0)
    state = W.placed_state(sg, seen, torch.zeros((2, 512),
                                                 dtype=torch.int32))
    with pytest.raises(ValueError, match="disagree"):
        checkpoint.save_orbax(str(tmp_path), state, W.prng_key(), 0)
    checkpoint.save_orbax(str(tmp_path), state, W.prng_key(), 0,
                          per_shard=W.PLACED)
    restored, *_ = checkpoint.load_orbax(str(tmp_path), state)
    assert all(torch.equal(restored[k], state[k]) for k in state)
    with pytest.raises(ValueError, match="replicated"):
        checkpoint.load_orbax(str(tmp_path), state, per_shard={
            **W.PLACED, "counts": False})


def _rank_part(**kw):
    """Rank 0's part of a 2-rank ring, built without a group."""
    mesh = TM.RingMesh(n_shards=S, axis_name=TM.DEFAULT_AXIS,
                       device=torch.device("cpu"), rank=0, world=2,
                       order=(0, 1))
    g = TG.watts_strogatz(256, 4, 0.1, seed=0, device="cpu")
    return TS.shard_graph(g, mesh, source_csr=True, **kw), mesh


@pytest.mark.parametrize("option", ["recorder", "fault-spec"])
def test_rank_adaptive_keeps_the_reference_refusals(option,
                                                    one_torch_thread):
    """The adaptive loop refuses a recorder and a fault-spec comm with
    the reference's ``ValueError`` on a rank's part too, before any
    exchange."""
    sg, mesh = _rank_part()
    kw = ({"recorder": flightrec.FlightRecorder(8)} if option == "recorder"
          else {"comm": chaos_device.FaultSpec(
              chaos_device.FaultSchedule(seed=1, zero=0.5), "ppermute")})
    with pytest.raises(ValueError, match="adaptive"):
        TS.flood_until_coverage(sg, mesh, 0, adaptive_k=16, **kw)
