"""The ring's protocols across processes (``parallel/sharded.py`` on a
ring split over ranks, ``sim/checkpoint.py``'s ``save_orbax`` /
``load_orbax``, ``TorchSimNode``'s mesh backend) against the JAX
package's ring and the port's one-process ring.

Rank processes started by ``multihost.launch`` at worlds 2 and 4 (S = 8,
so 4 and 2 shards a rank), joined by gloo on loopback, each run
``tests/torch_rank_worker.py::protocols`` (torch and the port only) on
the reference worker's graph: SIR on every layout and to a coverage,
PageRank and push-sum with their run-to-threshold loops on ``mxu`` and
``hybrid``, hop distance and leader election on ``segment``, the walk
with and without restarts, 64 lanes of the batched plane, the reference
worker's fourth phase (gossip values saved at world 2 by ``save_orbax``
and restored at worlds 2, 4 and 1 and in this process), and at world 2 a
PageRank ``TorchSimNode`` on the ``mxu`` ring through every population
call. The ranks' rows, gathered in rank order, and every summary must
equal:

1. the JAX ring on the 8-device virtual CPU mesh (``comm="ppermute"``):
   integers, bools and stats exactly, f32 by bits. No run here adds f32
   terms on the ``segment`` layout, the one place where the reference
   adds in another order (ROADMAP.md §C, held to 1e-5 in
   ``tests/test_torch_multihost.py``), so no tolerance is needed: SIR's,
   hop distance's, the walk's and the lanes' f32 stats are counts over
   the live count, and PageRank and push-sum run on ``mxu``/``hybrid``.
   The reference's SIR gives the same bits on every layout, so it runs
   once, on ``segment``;
2. the port's one-process ring (``protocols`` in this process), bit for
   bit everywhere.
"""

import concurrent.futures
import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu.models import hopdist as JHD  # noqa: E402
from p2pnetwork_tpu.models import pagerank as JPR  # noqa: E402
from p2pnetwork_tpu.models import pushsum as JPS  # noqa: E402
from p2pnetwork_tpu.models import sir as JSIR  # noqa: E402
from p2pnetwork_tpu.models import walk as JW  # noqa: E402
from p2pnetwork_tpu.models.gossip import Gossip as JGossip  # noqa: E402
from p2pnetwork_tpu.models.messagebatch import (  # noqa: E402
    BatchFlood as JBatchFlood)
from p2pnetwork_tpu.parallel import mesh as JM  # noqa: E402
from p2pnetwork_tpu.parallel import sharded as JS  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu.sim.simnode import JaxSimNode  # noqa: E402
from p2pnetwork_tpu_torch.parallel import multihost  # noqa: E402
from p2pnetwork_tpu_torch.sim import checkpoint  # noqa: E402
from tests import torch_rank_worker as W  # noqa: E402
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401

S = 8
WORLDS = (2, 4)
WORKER = str(Path(W.__file__).resolve())
#: Seconds a rank suite may take before the launcher stops it.
RANK_TIMEOUT = 240


def _launch_all(ckpt_dir: str) -> dict:
    """The protocols at each world, gathered (``W.gather_runs``), then
    world 2's checkpoint restored by a rank process of world 1 (key 1).
    World 2 saves the checkpoint the others restore, so it runs first."""
    out = {}
    for world in (2,) + tuple(w for w in WORLDS if w != 2):
        parts = multihost.launch(f"{WORKER}:protocols", world,
                                 (S, ckpt_dir, world == 2),
                                 timeout=RANK_TIMEOUT, device="cpu")
        assert [(p["rank"], p["world"]) for p in parts] == [
            (r, world) for r in range(world)]
        out[world] = W.gather_runs(parts)
    out[1] = W.gather_runs(multihost.launch(
        f"{WORKER}:restore", 1, (S, ckpt_dir), timeout=RANK_TIMEOUT,
        device="cpu"))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``(ckpt_dir, future of _launch_all)``: the rank processes run in a
    thread while this process computes the JAX ring and the one-process
    port."""
    if len(jax.devices()) < S:
        pytest.skip(f"needs {S} devices (the virtual CPU mesh of conftest)")
    ckpt_dir = str(tmp_path_factory.mktemp("rank-ckpt"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield ckpt_dir, pool.submit(_launch_all, ckpt_dir)


def _ranks(ranks, world: int) -> dict:
    return ranks[1].result()[world]


@functools.lru_cache(maxsize=None)
def _one_process(ckpt_dir: str) -> dict:
    """The same protocols on the port's one-process ring, which saves
    and restores its own checkpoint (in ``ckpt_dir``)."""
    n = torch.get_num_threads()
    try:
        return W.gather_runs([W.protocols(S, ckpt_dir, save=True)])
    finally:
        torch.set_num_threads(n)


def _one(ranks) -> dict:
    return _one_process(str(Path(ranks[0]) / "one-process"))


def _rec(rows: dict, **same) -> dict:
    return {**{k: np.asarray(v) for k, v in rows.items()}, **{
        k: np.asarray(v) if isinstance(v, jax.Array) else v
        for k, v in same.items()}}


def _stats(stats) -> dict:
    return {k: np.asarray(v) for k, v in stats.items()}


@functools.lru_cache(maxsize=None)
def _jax_ring() -> dict:
    """The JAX ring's records of every run, in ``W.gather_runs``' form."""
    jg = JG.watts_strogatz(*W.GRAPH, seed=0)
    mesh = JM.ring_mesh(S)
    key = jax.random.key
    pp = dict(comm="ppermute")
    sgs = {lay: JS.shard_graph(jg, mesh, **kw)
           for lay, kw in W.LAYOUTS.items()}
    seg = sgs["segment"]
    sir = JSIR.SIR(**W.SIR_KW)
    status, st = JS.sir(seg, mesh, sir, key(W.KEYS["sir"]), W.ROUNDS,
                        exact_rng=True, **pp)
    out = {"sir": _rec({"status": status}, **_stats(st))}
    status, res = JS.sir_until_coverage(
        seg, mesh, sir, key(W.KEYS["sir"]), coverage_target=W.SIR_TARGET,
        max_rounds=64, **pp)
    out["sir_until"] = _rec({"status": status}, out=res)
    for lay in W.CONSENSUS_LAYOUTS:
        ranks, st = JS.pagerank(sgs[lay], mesh, JPR.PageRank(), W.ROUNDS,
                                **pp)
        out[f"pagerank-{lay}"] = _rec({"ranks": ranks}, **_stats(st))
        ranks, res = JS.pagerank_until_residual(
            sgs[lay], mesh, JPR.PageRank(), tol=W.PR_TOL, max_rounds=64,
            **pp)
        out[f"pagerank_until-{lay}"] = _rec({"ranks": ranks}, out=res)
        k = key(W.KEYS["pushsum"])
        (s, w), st = JS.pushsum(sgs[lay], mesh, JPS.PushSum(), k, W.ROUNDS,
                                **pp)
        out[f"pushsum-{lay}"] = _rec({"s": s, "w": w}, **_stats(st))
        (s, w), res = JS.pushsum_until_variance(
            sgs[lay], mesh, JPS.PushSum(), k, tol=W.PS_TOL, max_rounds=64,
            **pp)
        out[f"pushsum_until-{lay}"] = _rec({"s": s, "w": w}, out=res)
    hop = JHD.HopDistance(source=0)
    (dist, front, rnd), st = JS.hopdist(seg, mesh, hop, W.HOP_ROUNDS, **pp)
    out["hopdist"] = _rec({"dist": dist, "frontier": front}, round=rnd,
                          **_stats(st))
    (dist, front, rnd), res = JS.hopdist_until_done(seg, mesh, hop, **pp)
    out["hopdist_until_done"] = _rec({"dist": dist, "frontier": front},
                                     round=rnd, out=res)
    known, res = JS.leader_until_quiet(seg, mesh, **pp)
    out["leader"] = _rec({"known": known}, out=res)
    proto = JBatchFlood(method="segment")
    batch, res = JS.run_batch_until_coverage(
        seg, mesh, proto, proto.init(jg, W.lane_sources(jg.n_nodes),
                                     coverage_target=0.99),
        max_rounds=64, donate=False, **pp)
    out["lanes"] = _rec({}, out=res, **{
        f: np.asarray(getattr(batch, f)) for f in (
            "seen", "frontier", "sent", "done", "rounds", "seen_count")})
    sgc = JS.shard_graph(jg, mesh, source_csr=True)
    for name, p in (("walk", 0.0), ("walk_restart", W.RESTART_P)):
        (pos, start, visited), st = JS.walk(
            sgc, mesh, JW.RandomWalks(n_walkers=W.WALKERS, restart_p=p),
            key(W.KEYS["walk"]), W.WALK_ROUNDS, return_state=True)
        out[name] = _rec({"visited": visited}, pos=pos, start=start,
                         **_stats(st))
    vals, _ = JS.gossip(seg, mesh, JGossip(alpha=W.GOSSIP["alpha"]),
                        key(W.GOSSIP["key"]), W.GOSSIP["rounds"],
                        exact_rng=True, **pp)
    out["gossip_vals"] = np.asarray(vals)
    return out


@functools.lru_cache(maxsize=None)
def _jax_node(path: str) -> tuple:
    """The reference's PageRank node on its ``mxu`` ring through the same
    population calls: its events and final ranks."""
    rec = W.NodeEvents()
    node = JaxSimNode(graph=JG.watts_strogatz(*W.GRAPH, seed=0),
                      protocol=JPR.PageRank(), seed=3, callback=rec,
                      mesh=JM.ring_mesh(S), dynamic_edges=8, layout="mxu")
    W.node_calls(node, path)
    return rec.events, np.asarray(node.sim_state), (
        node.sim_round, node.sim_message_count, node._churn_count)


def _same(got, want, what):
    """Exactly equal: arrays by value and f32 by bits (the port's packed
    words as the reference's ``uint32``; its i64 counts beside the
    reference's i32), dicts and lists item by item."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _same(got[k], want[k], f"{what}.{k}")
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if w.dtype.kind == "f" or g.dtype.kind == "f":
        assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
        assert g.tobytes() == w.tobytes(), what
    elif g.dtype.itemsize == w.dtype.itemsize and w.dtype.kind in "iu":
        assert g.tobytes() == w.tobytes(), what
    else:
        assert np.array_equal(g, w), what


def _check(ranks, world, name, jax_name=None):
    """Run ``name`` at ``world``: equal to the JAX ring's ``jax_name``
    record and to the one-process port by bits (dtypes included)."""
    want = _jax_ring()[jax_name or name]
    one = _one(ranks)[name]
    got = _ranks(ranks, world)[name]
    assert W._equal_tree(got, one), name
    _same(got, want, name)


@pytest.mark.parametrize("layout", list(W.LAYOUTS))
@pytest.mark.parametrize("world", WORLDS)
def test_rank_sir(ranks, world, layout, one_torch_thread):
    _check(ranks, world, f"sir-{layout}", "sir")


@pytest.mark.parametrize("world", WORLDS)
def test_rank_sir_until_coverage(ranks, world, one_torch_thread):
    _check(ranks, world, "sir_until")
    assert 0 < _ranks(ranks, world)["sir_until"]["out"]["rounds"] < 64


@pytest.mark.parametrize("run", ["pagerank", "pagerank_until"])
@pytest.mark.parametrize("layout", W.CONSENSUS_LAYOUTS)
@pytest.mark.parametrize("world", WORLDS)
def test_rank_pagerank(ranks, world, layout, run, one_torch_thread):
    _check(ranks, world, f"{run}-{layout}")


@pytest.mark.parametrize("run", ["pushsum", "pushsum_until"])
@pytest.mark.parametrize("layout", W.CONSENSUS_LAYOUTS)
@pytest.mark.parametrize("world", WORLDS)
def test_rank_pushsum(ranks, world, layout, run, one_torch_thread):
    _check(ranks, world, f"{run}-{layout}")


@pytest.mark.parametrize("run", ["hopdist", "hopdist_until_done"])
@pytest.mark.parametrize("world", WORLDS)
def test_rank_hop_distance(ranks, world, run, one_torch_thread):
    _check(ranks, world, run)


@pytest.mark.parametrize("world", WORLDS)
def test_rank_leader_election(ranks, world, one_torch_thread):
    _check(ranks, world, "leader")
    assert _ranks(ranks, world)["leader"]["out"]["coverage"] == 1.0


@pytest.mark.parametrize("run", ["walk", "walk_restart"])
@pytest.mark.parametrize("world", WORLDS)
def test_rank_walk(ranks, world, run, one_torch_thread):
    _check(ranks, world, run)


@pytest.mark.parametrize("world", WORLDS)
def test_rank_lane_plane(ranks, world, one_torch_thread):
    _check(ranks, world, "lanes")
    assert _ranks(ranks, world)["lanes"]["out"]["completed"] == W.LANES


@pytest.mark.parametrize("where", [2, 4, 1, "one-process"])
def test_rank_checkpoint_restores(ranks, where, one_torch_thread):
    """The reference worker's fourth phase: saved by world 2's ranks,
    restored onto a ring of ``where`` (world 1 a rank process, then this
    process's ring): the values the engine's (the JAX ring's gossip),
    the counters the saved ones, and the restored rows span every rank
    (each rank's rows equal its own shards')."""
    want = _jax_ring()["gossip_vals"]
    if where == "one-process":
        _ranks(ranks, 2)  # world 2 has saved
        got = W.gather_runs([W.restore(S, ranks[0])])["ckpt"]
    else:
        got = _ranks(ranks, where)["ckpt"]
    _same(got["vals"], want, "restored values")
    assert (got["round"], got["messages"]) == (W.GOSSIP["rounds"], 0)
    assert got["key"].tolist() == [0, W.KEYS["ckpt"]]
    if where in WORLDS:
        assert got["equal"]  # each rank's restored rows are its own
    manifest = checkpoint.read_manifest(ranks[0])
    assert (manifest["n_shards"], manifest["world"]) == (S, 2)
    assert sorted(manifest["files"]) == [f"shard_{d:05d}.npz"
                                         for d in range(S)]


def test_orbax_directory_is_refused(tmp_path):
    # What the reference's orbax writes: no manifest of the port's.
    (tmp_path / "_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="manifest.json.*orbax"):
        checkpoint.load_orbax(str(tmp_path), {"vals": torch.zeros(8, 4)})


def test_rank_mesh_node(ranks, one_torch_thread, tmp_path):
    """A PageRank ``TorchSimNode`` on the ``mxu`` ring of 2 ranks through
    every population call: its events (the whole ring's stats), ranks,
    liveness and counters equal the one-process node's and the
    reference's node's; the node restored from its mid-run checkpoint
    (a directory each rank wrote its shards of) ends where it did."""
    events, ranked, counters = _jax_node(str(tmp_path / "jax-node.npz"))
    one = _one(ranks)["node"]
    got = _ranks(ranks, 2)["node"]
    assert W._equal_tree(got, one)
    _same(got["events"], events, "events")
    _same(got["ranks"], ranked, "ranks")
    assert got["counters"][:3] == counters
    _same(got["resumed"], got["ranks"], "resumed ranks")
    assert got["resumed_events"][-1] == got["events"][-1]
    assert got["counters"][3:] == got["counters"][:3]
    topology = [e for e in got["events"] if "sim_topology" in e]
    assert [e["sim_topology"] for e in topology] == ["fail_nodes",
                                                     "connect", "churn"]
    assert got["alive"].sum() == topology[-1]["alive_nodes"] < W.GRAPH[0]
