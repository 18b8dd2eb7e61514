"""The port's ring across processes (``parallel/multihost.py``, the rank
comm of ``parallel/sharded.py``) against the JAX package's multi-host
tests (``tests/test_multihost.py``, ``tests/multihost_worker.py``).

Two parts. The reference's four in-process tests, mirrored at world 1
with 8 stacked shards. Then its two-process phase suite at world 2 and
4 (S = 8, so 4 and 2 shards a rank): rank processes started by
``multihost.launch``, joined by gloo on loopback, each running
``tests/torch_rank_worker.py`` (torch and the port only) on the CPU.
Their rows, gathered in rank order, must equal the JAX ring's on the
8-device virtual CPU mesh (``comm="ppermute"``, as tests/test_torch_ring.py
runs it) and the port's one-process ring, bit for bit: floods on the
three layouts, exact-RNG gossip with its per-round stats (the gathered
``psum_f32`` order), the churn step, and ``propagate`` of every op. The
one exception is stated where it is made: the reference adds a segment
bucket's f32 terms in another order than the port (ROADMAP.md §C), so
``propagate("sum")`` of random values on the ``segment`` layout is held
to the JAX ring within ``RTOL``/``ATOL`` and to the one-process port by
bits; on ``mxu`` and ``hybrid`` it is bits against both.
"""

import functools
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu.models import Flood as JFlood  # noqa: E402
from p2pnetwork_tpu.models.gossip import Gossip as JGossip  # noqa: E402
from p2pnetwork_tpu.parallel import auto as JA  # noqa: E402
from p2pnetwork_tpu.parallel import mesh as JM  # noqa: E402
from p2pnetwork_tpu.parallel import multihost as JMH  # noqa: E402
from p2pnetwork_tpu.parallel import sharded as JS  # noqa: E402
from p2pnetwork_tpu.sim import engine as JE  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu_torch import prng  # noqa: E402
from p2pnetwork_tpu_torch.models import AntiEntropy, Flood  # noqa: E402
from p2pnetwork_tpu_torch.parallel import auto as TA  # noqa: E402
from p2pnetwork_tpu_torch.parallel import mesh as TM  # noqa: E402
from p2pnetwork_tpu_torch.parallel import multihost  # noqa: E402
from p2pnetwork_tpu_torch.parallel import sharded as TS  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine as TE  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402
from p2pnetwork_tpu_torch.sim import topology  # noqa: E402
from tests import torch_rank_worker as W  # noqa: E402
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401

S = 8
WORLDS = (2, 4)
RTOL = ATOL = 1e-5
WORKER = str(Path(W.__file__).resolve())
#: Seconds a rank suite may take before the launcher stops it.
RANK_TIMEOUT = 240


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < S:
        pytest.skip(f"needs {S} devices (the virtual CPU mesh of conftest)")
    return JM.ring_mesh(S)


# ------------------------------------- the reference's in-process tests


def test_initialize_noop_single_process():
    assert multihost.initialize_distributed() is False


def test_hierarchical_ring_mesh_covers_all_shards():
    mesh = multihost.hierarchical_ring_mesh(device="cpu")
    assert (mesh.n_shards, mesh.world, mesh.rank, mesh.order) == (S, 1, 0,
                                                                   (0,))
    # host-major: one process holds every shard, in order
    assert TM.shard_spec(mesh) == slice(0, S) and mesh.n_local == S


def test_ring_flood_on_hierarchical_mesh_matches_engine(one_torch_thread):
    g = TG.watts_strogatz(512, 6, 0.2, seed=0, device="cpu")
    mesh = multihost.hierarchical_ring_mesh(device="cpu")
    sg = TS.shard_graph(g, mesh)
    seen, _ = TS.flood(sg, mesh, source=0, rounds=6)
    ref, _ = JE.run(JG.watts_strogatz(512, 6, 0.2, seed=0),
                    JFlood(source=0), jax.random.key(0), 6)
    assert (seen.numpy().reshape(-1)[:g.n_nodes]
            == np.asarray(ref.seen)[:g.n_nodes]).all()


def test_mesh_2d_shape():
    mesh = multihost.mesh_2d(device="cpu")
    assert mesh.axis_names == ("dcn", "ici")
    assert mesh.shape == (1, S)  # one process of 8 shards
    assert multihost.mesh_2d(hosts=2, device="cpu").shape == (2, S // 2)


def test_mesh_2d_auto_run(jmesh, one_torch_thread):
    g = TG.watts_strogatz(512, 4, 0.1, seed=1, device="cpu")
    gs = TA.shard_graph_auto(g, multihost.mesh_2d(device="cpu"),
                             axis_name="ici")
    state, _ = TA.run_auto(gs, Flood(source=0, method="segment"),
                           prng.key(0), 5)
    jg = JG.watts_strogatz(512, 4, 0.1, seed=1)
    jgs = JA.shard_graph_auto(jg, JMH.mesh_2d(), axis_name="ici")
    ref, _ = JA.run_auto(jgs, JFlood(source=0, method="segment"),
                         jax.random.key(0), 5)
    np.testing.assert_array_equal(state.seen.numpy(), np.asarray(ref.seen))


# ---------------------------------------------------- the rank suite


@functools.lru_cache(maxsize=None)
def _ranks(world: int) -> dict:
    """The rank suite at ``world``, the ranks' rows gathered in rank order
    (``[S, block]``), the summaries checked equal on every rank."""
    parts = multihost.launch(f"{WORKER}:suite", world, (S,),
                             timeout=RANK_TIMEOUT, device="cpu")
    assert [p["rank"] for p in parts] == list(range(world))
    assert [p["shard_lo"] for p in parts] == [r * S // world
                                              for r in range(world)]
    assert all(p["multi"] for p in parts)
    return W.gather(parts)


@functools.lru_cache(maxsize=None)
def _graphs():
    n, k, p = W.GRAPH
    return (JG.watts_strogatz(n, k, p, seed=0),
            TG.watts_strogatz(n, k, p, seed=0, device="cpu"))


@functools.lru_cache(maxsize=None)
def _one_process() -> dict:
    """The same suite on the port's one-process ring (world 1)."""
    n = torch.get_num_threads()
    try:
        return W.suite(S)
    finally:
        torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_ring() -> dict:
    """The JAX ring's results: floods are OR, so one layout serves all
    three (its bits do not depend on the layout); the sums per layout."""
    jg, _ = _graphs()
    mesh = JM.ring_mesh(S)
    out = {}
    for layout, kw in W.LAYOUTS.items():
        jsg = JS.shard_graph(jg, mesh, **kw)
        sig = jax.numpy.asarray(W.signal(S * jsg.block).reshape(S, jsg.block))
        out[layout] = {"sum": np.asarray(JS.propagate(
            jsg, mesh, sig, "sum", comm="ppermute"))}
        if layout != "segment":
            continue
        seen, res = JS.flood_until_coverage(jsg, mesh, 0,
                                            coverage_target=0.99,
                                            comm="ppermute")
        out["flood"] = {"seen": np.asarray(seen), "out": res}
        out[layout].update(
            max=np.asarray(JS.propagate(jsg, mesh, sig, "max",
                                        comm="ppermute")),
            minplus=np.asarray(JS.propagate(jsg, mesh, abs(sig), "minplus",
                                            comm="ppermute")),
            orr=np.asarray(JS.propagate(jsg, mesh, sig > 1.0, "or",
                                        comm="ppermute")))
        vals, stats = JS.gossip(jsg, mesh, JGossip(alpha=W.GOSSIP["alpha"]),
                                jax.random.key(W.GOSSIP["key"]),
                                W.GOSSIP["rounds"], exact_rng=True,
                                comm="ppermute")
        out["gossip"] = {"values": np.asarray(vals),
                         **{k: np.asarray(v) for k, v in stats.items()}}
        sgc = JS.with_capacity(JS.fail_nodes(jsg, list(W.FAIL_IDS)), 8)
        sgc = JS.connect(sgc, [1], [jg.n_nodes - 2])
        seen, res = JS.flood_until_coverage(sgc, mesh, 0,
                                            coverage_target=0.9,
                                            comm="ppermute")
        out["churn"] = {"seen": np.asarray(seen), "out": res,
                        "out_degree": np.asarray(sgc.out_degree),
                        "in_degree": np.asarray(sgc.in_degree),
                        "neighbors_mask": np.asarray(sgc.neighbors_mask)}
    return out


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def _same(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert np.array_equal(_bits(got), _bits(want)), what


@pytest.mark.parametrize("layout", list(W.LAYOUTS))
@pytest.mark.parametrize("world", WORLDS)
def test_rank_flood_equals_the_rings(jmesh, world, layout, one_torch_thread):
    got = _ranks(world)[layout]
    want = _jax_ring()["flood"]
    one = _one_process()[layout]
    assert got["out"] == one["out"]
    for k in ("rounds", "messages", "coverage"):
        assert got["out"][k] == want["out"][k], k
    _same(got["seen"], want["seen"], "seen vs the JAX ring")
    _same(got["seen"], one["seen"], "seen vs one process")


@pytest.mark.parametrize("layout", list(W.LAYOUTS))
@pytest.mark.parametrize("world", WORLDS)
def test_rank_propagate_sum(jmesh, world, layout, one_torch_thread):
    got = _ranks(world)[layout]["sum"]
    _same(got, _one_process()[layout]["sum"], "sum vs one process")
    want = _jax_ring()[layout]["sum"]
    if layout == "segment":  # the reference adds a bucket in its own order
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        _same(got, want, f"sum vs the JAX ring on {layout}")


@pytest.mark.parametrize("op", ["max", "minplus", "orr"])
@pytest.mark.parametrize("world", WORLDS)
def test_rank_propagate_other_ops(jmesh, world, op, one_torch_thread):
    got = _ranks(world)["segment"][op]
    _same(got, _one_process()["segment"][op], f"{op} vs one process")
    _same(got, _jax_ring()["segment"][op], f"{op} vs the JAX ring")


@pytest.mark.parametrize("world", WORLDS)
def test_rank_gossip_is_exact(jmesh, world, one_torch_thread):
    got = _ranks(world)["gossip"]
    for want in (_jax_ring()["gossip"], _one_process()["gossip"]):
        assert set(got) == set(want)
        for k in got:
            _same(got[k], want[k].astype(got[k].dtype), k)


@pytest.mark.parametrize("world", WORLDS)
def test_rank_churn_step(jmesh, world, one_torch_thread):
    got = _ranks(world)["churn"]
    for want in (_jax_ring()["churn"], _one_process()["churn"]):
        assert (got["out"]["rounds"], got["out"]["messages"]) == (
            want["out"]["rounds"], want["out"]["messages"])
        for k in ("seen", "out_degree", "in_degree", "neighbors_mask"):
            _same(got[k], want[k], k)


# ------------------------------------------------------- the refusals


def _rank_part(**kw):
    """Rank 0's part of a 2-rank ring, built without a group: every
    refusal below raises before the first exchange."""
    mesh = TM.RingMesh(n_shards=S, axis_name=TM.DEFAULT_AXIS,
                       device=torch.device("cpu"), rank=0, world=2,
                       order=(0, 1))
    g = TG.watts_strogatz(256, 4, 0.1, seed=0, device="cpu")
    return TS.shard_graph(g, mesh, **kw), mesh, g


# The adaptive loop, the recorder and a fault-spec comm, once refused
# here, run across ranks: tests/test_torch_multihost_adaptive.py holds
# them to the JAX ring and the one-process port. The auto-sharded path
# runs across ranks too (tests/test_torch_auto_ranks.py,
# tests/test_torch_auto_library.py): every protocol of models/, a graph
# with a dynamic edge region and a 2-D mesh over ranks. What it still
# refuses is held here, on each of those parts: a protocol without
# RUNS_ON_PART (a user's own; here anti-entropy's class with the mark
# taken off), by name.
class _UserAntiEntropy(AntiEntropy):
    RUNS_ON_PART = False


def _user_run(part):
    return TA.run_auto(part, _UserAntiEntropy(), prng.key(0), 1)


REFUSALS = {
    "auto": lambda: _user_run(TA.shard_graph_auto(
        topology.with_capacity(_rank_part()[2], 8), _rank_part()[1])),
    "auto-mesh2d": lambda: _user_run(TA.shard_graph_auto(
        _rank_part()[2], multihost.Mesh2D(
            grid=np.arange(S).reshape(2, S // 2), axis_names=("dcn", "ici"),
            ring=_rank_part()[1]), axis_name="ici")),
    "auto-antientropy": lambda: _user_run(
        TA.shard_graph_auto(_rank_part()[2], _rank_part()[1])),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_rank_ring_refusals(name, one_torch_thread):
    with pytest.raises(NotImplementedError, match="_UserAntiEntropy.*"
                       "RUNS_ON_PART"):
        REFUSALS[name]()


def test_rank_part_holds_its_shards(one_torch_thread):
    sg, mesh, g = _rank_part(hybrid=True)
    whole = TS.shard_graph(g, TM.ring_mesh(S, device="cpu"), hybrid=True)
    assert (sg.n_shards, sg.n_local, sg.shard_lo) == (S, S // 2, 0)
    for f in ("bkt_src", "bkt_mask", "node_mask", "mxu_src", "mxu_extent",
              "diag_masks", "neighbors"):
        _same(getattr(sg, f).numpy(), getattr(whole, f)[:S // 2].numpy(), f)
    assert TS.init_state(sg, Flood(source=200))[0].sum() == 0  # rank 1's


# ------------------------------------------------- a rank that fails


def test_a_rank_that_raises_fails_the_launch(tmp_path):
    with pytest.raises(multihost.RankError, match="fails on purpose"):
        multihost.launch(f"{WORKER}:fail_on", 2, (1, str(tmp_path)),
                         timeout=60, device="cpu")
    pids = [int(p.read_text()) for p in tmp_path.glob("pid*")]
    assert len(pids) == 2
    for pid in pids:  # every rank was stopped and reaped
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_launch_defaults_to_the_card(monkeypatch):
    """``launch`` resolves its device as ``_device.resolve`` does: the
    card unless the caller names another. It once defaulted to the CPU,
    so a run on the card skipped the one build it makes up front and
    left each rank to build the library."""
    from p2pnetwork_tpu_torch import _build

    class Stop(Exception):
        pass

    built = []
    monkeypatch.setattr(_build, "library", lambda: built.append(1))
    monkeypatch.setattr(multihost, "_run_ranks",
                        lambda *a, **k: (_ for _ in ()).throw(Stop()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(Stop):
        multihost.launch(f"{WORKER}:fail_on", 2, (1, "unused"))
    assert built == [1]  # the card by default: built here, once
    with pytest.raises(Stop):
        multihost.launch(f"{WORKER}:fail_on", 2, (1, "unused"),
                         device="cpu")
    assert built == [1]  # the CPU by name: nothing to build
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.launch(f"{WORKER}:fail_on", 2, (1, "unused"))


def test_a_hung_rank_times_out(tmp_path):
    with pytest.raises(TimeoutError, match="did not finish"):
        multihost.launch(f"{WORKER}:fail_on", 2, (-1, str(tmp_path)),
                         timeout=8, device="cpu")
    for p in tmp_path.glob("pid*"):
        with pytest.raises(ProcessLookupError):
            os.kill(int(p.read_text()), 0)
