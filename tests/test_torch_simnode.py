"""``TorchSimNode`` (``sim/simnode.py``) against the JAX package's
``JaxSimNode``, on the single-device backend and on the 8-shard ring.

Both nodes get the same graph (built by each package from the same seed),
the same protocol and seed, and the same sequence of calls; their whole
callback event lists must be equal, exactly: every ``sim_round``,
``sim_run`` and ``sim_topology`` dict, value for value. So must the final
protocol state, the round and message counters, and the checkpoint
files, which cross both ways on both backends. The JAX ring runs on the
8-device virtual CPU mesh of ``tests/conftest.py``. Graph:
``tests/test_simnode_mesh.py``'s ``watts_strogatz(1024, 6, 0.2)``, whose
padded size is ``S * block``, so the ring's churn draw is the
single-device one.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu import models as JMOD  # noqa: E402
from p2pnetwork_tpu import node as JNODE  # noqa: E402
from p2pnetwork_tpu.parallel import mesh as JM  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu.sim import topology as JT  # noqa: E402
from p2pnetwork_tpu.sim.simnode import JaxSimNode  # noqa: E402
from p2pnetwork_tpu_torch import models as TMOD  # noqa: E402
from p2pnetwork_tpu_torch import node as TNODE  # noqa: E402
from p2pnetwork_tpu_torch.parallel import mesh as TM  # noqa: E402
from p2pnetwork_tpu_torch.sim import checkpoint as TC  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402
from p2pnetwork_tpu_torch.sim import topology as TT  # noqa: E402
from p2pnetwork_tpu_torch.sim.simnode import SimPeer, TorchSimNode  # noqa: E402
from tests.helpers import EventRecorder  # noqa: E402
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

S = 8
FAILED = [5, 500]


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < S:
        pytest.skip(f"needs {S} devices (the virtual CPU mesh of conftest)")
    return JM.ring_mesh(S), TM.ring_mesh(S, device="cpu")


@functools.lru_cache(maxsize=None)
def _graphs(kind="ws"):
    if kind == "ba":
        return (JG.barabasi_albert(1024, 3, seed=2),
                TG.barabasi_albert(1024, 3, seed=2, device="cpu"))
    return (JG.watts_strogatz(1024, 6, 0.2, seed=0),
            TG.watts_strogatz(1024, 6, 0.2, seed=0, device="cpu"))


@functools.lru_cache(maxsize=None)
def _capped():
    jg, tg = _graphs()
    return (JT.with_capacity(jg, extra_edges=16),
            TT.with_capacity(tg, extra_edges=16))


def _protocols(name):
    if name == "mesh-sir":
        kw = dict(beta=0.4, gamma=0.15, source=3)
        return JMOD.SIR(**kw), TMOD.SIR(**kw)
    if name == "gossip":
        return JMOD.Gossip(alpha=0.5), TMOD.Gossip(alpha=0.5)
    if name == "hopdist":
        return JMOD.HopDistance(source=7), TMOD.HopDistance(source=7)
    if name == "mesh-pagerank":
        return JMOD.PageRank(), TMOD.PageRank()
    if name == "pushsum":
        return JMOD.PushSum(), TMOD.PushSum()
    if name == "sir":
        kw = dict(beta=0.4, gamma=0.15, source=3, method="segment")
        return JMOD.SIR(**kw), TMOD.SIR(**kw)
    if name == "pagerank":
        return JMOD.PageRank(method="gather"), TMOD.PageRank(method="gather")
    return JMOD.Flood(source=0), TMOD.Flood(source=0)


def _churn(node, rounds=3):
    node.run_rounds(rounds)
    node.fail_sim_nodes(FAILED)
    node.inject_sim_churn(0.1)
    node.connect_sim_nodes([2, 40], [900, 41])
    node.run_rounds(2)


def _pagerank_threshold():
    """A residual threshold midway, in log scale, between the reference's
    residuals of rounds 15 and 16, so sums taken in another order (which
    move a residual by ~1e-3 relative) cannot change the stopping round."""
    jg = _graphs("ba")[0]
    dry = JaxSimNode(graph=jg, protocol=_protocols("pagerank")[0])
    res = dry.run_rounds(16)["residual"]
    return float(np.sqrt(res[14] * res[15]))


#: The call sequences, by scenario: (graph kind, protocol, calls).
SCENARIOS = {
    "flood": ("capped", "flood", lambda n, _: (
        _churn(n), n.run_until_coverage(0.9, max_rounds=32))),
    "sir": ("ws", "sir", lambda n, _: (
        n.run_rounds(2), n.inject_sim_churn(0.05),
        n.run_until_coverage(0.5, max_rounds=64))),
    "pagerank": ("ba", "pagerank", lambda n, thr: (
        n.run_rounds(3), n.run_until_converged("residual", thr,
                                               max_rounds=64))),
}

#: PageRank's f32 sums are added in another order by the port (its own
#: tests hold them so, ``tests/test_torch_protocols.py``): its f32 event
#: values agree within these (rtol, atol), every other value exactly.
PAGERANK_TOL = {"rank_total": (1e-5, 0.0), "rank_max": (1e-5, 0.0),
                "residual": (1e-3, 2e-8), "value": (1e-3, 2e-8)}


def _node_pair(kind, proto, mesh=None, **kw):
    jg, tg = _capped() if kind == "capped" else _graphs(kind)
    jp, tp = _protocols(proto)
    jrec, trec = EventRecorder(), EventRecorder()
    a = JaxSimNode(graph=jg, protocol=jp, seed=3, callback=jrec,
                   mesh=None if mesh is None else mesh[0], **kw)
    b = TorchSimNode(graph=tg, protocol=tp, seed=3, callback=trec,
                     mesh=None if mesh is None else mesh[1], **kw)
    return (a, jrec), (b, trec)


def _state_arrays(state):
    """A protocol state's leaves as numpy, in the packages' shared
    flattening order (either package's state)."""
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x, _ in TC._leaves(state)]


def assert_same_events(got, want, tol=None):
    assert [(e, c, sorted(d)) for e, c, d in got] == [
        (e, c, sorted(d)) for e, c, d in want]
    if tol is None:
        assert got == want
        return
    for (_, _, g), (_, _, w) in zip(got, want):
        for key, value in w.items():
            if key in tol:
                np.testing.assert_allclose(g[key], value, *tol[key])
            else:
                assert g[key] == value, key


def assert_same_nodes(a, b, jrec, trec, tol=None):
    assert_same_events(trec.events, jrec.events, tol)
    assert (b.sim_round, b.sim_message_count, b._churn_count) == (
        a.sim_round, a.sim_message_count, a._churn_count)
    np.testing.assert_array_equal(b.sim_node_alive, a.sim_node_alive)
    for got, want in zip(_state_arrays(b.sim_state),
                         _state_arrays(a.sim_state), strict=True):
        assert got.dtype == want.dtype
        if tol is None:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_single_device_events_equal_reference(name):
    kind, proto, calls = SCENARIOS[name]
    (a, jrec), (b, trec) = _node_pair(kind, proto)
    thr = _pagerank_threshold() if proto == "pagerank" else None
    calls(a, thr)
    calls(b, thr)
    assert_same_nodes(a, b, jrec, trec,
                      PAGERANK_TOL if proto == "pagerank" else None)
    runs = [d for d in trec.data_for("node_message") if "sim_run" in d]
    assert len(runs) == 1 and 0 < runs[0]["rounds"] < 64


@pytest.mark.parametrize("layout", ["mxu", "hybrid", "segment"])
def test_mesh_events_equal_reference(meshes, layout):
    (a, jrec), (b, trec) = _node_pair("ws", "flood", meshes,
                                      dynamic_edges=8, layout=layout)
    _churn(a)
    _churn(b)
    a.run_until_coverage(0.9, max_rounds=32)
    b.run_until_coverage(0.9, max_rounds=32)
    assert_same_nodes(a, b, jrec, trec)
    topo = [d for d in trec.data_for("node_message") if "sim_topology" in d]
    assert [d["sim_topology"] for d in topo] == ["fail_nodes", "churn",
                                                 "connect"]
    assert topo[0]["alive_nodes"] == 1022


def test_ring_node_matches_single_device_node(meshes):
    # tests/test_simnode_mesh.py::test_churn_and_events_match, in the port:
    # the same liveness, out-degrees, final seen and topology events.
    tg = _graphs()[1]
    rec = EventRecorder()
    a = TorchSimNode(graph=TT.with_capacity(tg, extra_edges=16),
                     protocol=TMOD.Flood(source=0), seed=0)
    b = TorchSimNode(graph=tg, protocol=TMOD.Flood(source=0), seed=0,
                     mesh=meshes[1], dynamic_edges=8, callback=rec,
                     layout="mxu")
    for n in (a, b):
        n.fail_sim_nodes([5, 500])
        n.inject_sim_churn(0.1)
        n.connect_sim_nodes([2], [900])
    np.testing.assert_array_equal(b.sim_node_alive, a.sim_node_alive)
    assert a.sim_node_alive.sum() == b.sim_node_alive.sum() < 1024
    np.testing.assert_array_equal(b.sim_sharded.out_degree.reshape(-1),
                                  a.sim_graph.out_degree)
    a.run_rounds(6)
    b.run_rounds(6)
    np.testing.assert_array_equal(b.sim_state[0].reshape(-1),
                                  a.sim_state.seen)
    assert a.sim_message_count == b.sim_message_count
    topo = [d for d in rec.data_for("node_message") if "sim_topology" in d]
    assert [e["sim_topology"] for e in topo] == ["fail_nodes", "churn",
                                                 "connect"]
    assert topo[0]["alive_nodes"] == 1022


@pytest.mark.parametrize("backend", ["single", "mxu"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_files_cross_both_ways(meshes, tmp_path, backend,
                                          writer):
    kw = {} if backend == "single" else dict(dynamic_edges=8,
                                             layout=backend)
    mesh = None if backend == "single" else meshes
    kind = "capped" if backend == "single" else "ws"
    (a, _), (b, _) = _node_pair(kind, "flood", mesh, **kw)
    src, dst_pair = (a, 1) if writer == "jax" else (b, 0)
    _churn(src)
    path = str(tmp_path / "node.npz")
    src.save_checkpoint(path)
    src.run_rounds(3)
    src.inject_sim_churn(0.05)
    # A fresh node of the other package resumes from the file.
    fresh = _node_pair(kind, "flood", mesh, **kw)[dst_pair]
    node, rec = fresh
    node.load_checkpoint(path)
    assert node.sim_round == 5 and node._churn_count == 1
    node.run_rounds(3)
    node.inject_sim_churn(0.05)
    assert node.sim_round == src.sim_round
    assert node.sim_message_count == src.sim_message_count
    np.testing.assert_array_equal(node.sim_node_alive, src.sim_node_alive)
    for got, want in zip(_state_arrays(node.sim_state),
                         _state_arrays(src.sim_state), strict=True):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["single", "hybrid"])
def test_resumed_node_equals_uninterrupted(meshes, tmp_path, backend):
    kw = {} if backend == "single" else dict(mesh=meshes[1],
                                             dynamic_edges=8, layout=backend)
    tg = _capped()[1] if backend == "single" else _graphs()[1]
    recs = [EventRecorder() for _ in range(2)]
    a, b = (TorchSimNode(graph=tg, protocol=TMOD.Flood(source=0), seed=1,
                         callback=r, **kw) for r in recs)
    _churn(a)
    path = str(tmp_path / "resume.npz")
    a.save_checkpoint(path)
    before = len(recs[0].events)
    a.run_until_coverage(0.9, max_rounds=32)
    b.load_checkpoint(path)
    b.run_until_coverage(0.9, max_rounds=32)
    assert recs[1].events == recs[0].events[before:]
    assert (b.sim_round, b.sim_message_count) == (a.sim_round,
                                                  a.sim_message_count)
    for got, want in zip(_state_arrays(b.sim_state),
                         _state_arrays(a.sim_state), strict=True):
        np.testing.assert_array_equal(got, want)


#: The mesh backend's other protocols, each a call sequence that drives
#: its ``run_rounds`` and its run-to-* loop (``examples/mesh_simnode_
#: demo.py``'s story for SIR: rounds, churn, runtime links, coverage),
#: and the layout it runs on: SIR, gossip and hop distance give the same
#: results on every layout (0/1 edge sums), PageRank and push-sum run on
#: the default hybrid layout, where their f32 sums add in the reference's
#: order.
MESH_SCENARIOS = {
    "mesh-sir": ("segment", lambda n: (
        n.run_rounds(2), n.inject_sim_churn(0.1),
        n.connect_sim_nodes([2, 40], [900, 41]),
        n.run_until_coverage(0.6, max_rounds=64))),
    "gossip": ("segment", lambda n: (
        n.run_rounds(2), n.fail_sim_nodes(FAILED), n.run_rounds(2))),
    "hopdist": ("segment", lambda n: (
        n.run_rounds(2), n.run_until_coverage(0.9, max_rounds=32))),
    "mesh-pagerank": ("hybrid", lambda n: (
        n.run_rounds(2), n.run_until_converged("residual", 2e-3,
                                               max_rounds=64))),
    "pushsum": ("hybrid", lambda n: (
        n.run_rounds(2), n.run_until_converged("variance", 1e-2,
                                               max_rounds=64))),
}


@pytest.mark.parametrize("name", sorted(MESH_SCENARIOS))
def test_mesh_protocols_equal_reference(meshes, tmp_path, name):
    # The ring backend of every protocol the reference's runs, then a
    # checkpoint crossing from the port's node to a fresh reference node,
    # which continues as the port's does.
    layout, calls = MESH_SCENARIOS[name]
    kw = dict(dynamic_edges=8, layout=layout)
    (a, jrec), (b, trec) = _node_pair("ws", name, meshes, **kw)
    calls(a)
    calls(b)
    assert_same_nodes(a, b, jrec, trec)
    runs = [d for d in trec.data_for("node_message") if "sim_run" in d]
    assert len(runs) == (name != "gossip") and all(
        0 < d["rounds"] < 64 for d in runs)
    path = str(tmp_path / f"{name}.npz")
    b.save_checkpoint(path)
    (c, crec), _ = _node_pair("ws", name, meshes, **kw)
    c.load_checkpoint(path)
    for n in (b, c):
        n.run_rounds(2)
    assert (c.sim_round, c.sim_message_count) == (b.sim_round,
                                                  b.sim_message_count)
    assert_same_events(trec.events[-2:], crec.events[-2:])
    for got, want in zip(_state_arrays(b.sim_state),
                         _state_arrays(c.sim_state), strict=True):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(mesh=True, adaptive_k=64), NotImplementedError, "item 9"),
    (dict(adaptive_k=64), ValueError, "mesh backend's coverage loop"),
    (dict(protocol="sir", mesh=True, adaptive_k=64), ValueError,
     "applies to Flood and HopDistance"),
    (dict(layout="blocked"), ValueError, "layout must be"),
], ids=["adaptive", "adaptive-no-mesh", "adaptive-protocol",
        "bad-layout"])
def test_refusals(meshes, kw, exc, match):
    kw = dict(kw)
    proto = _protocols(kw.pop("protocol", "flood"))[1]
    if kw.pop("mesh", False):
        kw["mesh"] = meshes[1]
    with pytest.raises(exc, match=match):
        TorchSimNode(graph=_graphs()[1], protocol=proto, **kw)


def test_mesh_backend_refuses_run_until_converged(meshes):
    b = TorchSimNode(graph=_graphs()[1], protocol=TMOD.Flood(source=0),
                     mesh=meshes[1])
    with pytest.raises(ValueError, match="sharded backend implements"):
        b.run_until_converged("residual", 1e-4)
    c = TorchSimNode(graph=_graphs()[1], protocol=TMOD.Gossip(),
                     mesh=meshes[1])
    with pytest.raises(ValueError, match="Flood, SIR and HopDistance"):
        c.run_until_coverage(0.5)
    with pytest.raises(RuntimeError, match="no simulation attached"):
        TorchSimNode().run_rounds(1)


def test_the_node_is_the_ports_own_copy():
    # The copy-not-bridge choice: TorchSimNode subclasses the port's Node,
    # whose module tree imports nothing of the JAX package
    # (tests/test_torch_isolation.py walks it), and it is a real sockets
    # node with the reference's SimPeer surface.
    assert issubclass(TorchSimNode, TNODE.Node)
    assert not issubclass(TorchSimNode, JNODE.Node)
    node = TorchSimNode("127.0.0.1", 0, graph=_graphs()[1],
                        protocol=TMOD.Flood(source=0))
    node.start()
    try:
        assert node._ready.wait(5.0) and node.port > 0
        peer = node.sim_peer
        assert isinstance(peer, SimPeer) and peer.id == "sim:1024-nodes"
        peer.set_info("k", 1)
        assert peer.get_info("k") == 1 and str(peer) == "SimPeer(sim:1024-nodes)"
    finally:
        node.stop()
        node.join(5.0)
    assert not node.is_alive()
