"""The ring's frontier-adaptive loop (``parallel/sharded.py``:
``flood_until_coverage(adaptive_k=...)``, ``hopdist_until_coverage`` /
``hopdist_until_done(adaptive_k=...)`` and the mesh ``TorchSimNode`` with
``adaptive_k``) against the JAX package's ring and against the port's
dense loop, on the same graphs.

The JAX ring runs on the 8-device virtual CPU mesh of
``tests/conftest.py`` with ``comm="ppermute"`` (this jax cannot run the
reference's Pallas ring kernels). Its adaptive results equal its dense
loop's bit for bit at every ``k`` and layout (the reference's own tests
pin that), so it runs once a graph, shard count and case, on the
``segment`` layout, and each port variant (``k``, layout, comm) is held
to it: ``seen``/``frontier``/``dist`` exactly, the summary dict exactly
(``rounds``, ``messages``, the f32 ``coverage`` and
``frontier_occupancy_mean`` by value, which carries every bit of an f32).
The cases mirror the reference's ``TestShardedAdaptiveFlood``,
``TestShardedAdaptiveHubGraphs``, ``TestShardedAdaptiveHopDistance``
(``tests/test_sharded.py``) and the two adaptive cases of
``tests/test_simnode_mesh.py``: crossing and sparse-only regimes, hub rows
wider than a work item, failed nodes and runtime links.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu.models import Flood as JFlood  # noqa: E402
from p2pnetwork_tpu.models import HopDistance as JHop  # noqa: E402
from p2pnetwork_tpu.parallel import mesh as JM  # noqa: E402
from p2pnetwork_tpu.parallel import sharded as JS  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu.sim.simnode import JaxSimNode  # noqa: E402
from p2pnetwork_tpu_torch import _device, prng  # noqa: E402
from p2pnetwork_tpu_torch.chaos import device as TCD  # noqa: E402
from p2pnetwork_tpu_torch.models.flood import Flood  # noqa: E402
from p2pnetwork_tpu_torch.models.hopdist import HopDistance  # noqa: E402
from p2pnetwork_tpu_torch.models.sir import SIR  # noqa: E402
from p2pnetwork_tpu_torch.parallel import mesh as TM  # noqa: E402
from p2pnetwork_tpu_torch.parallel import sharded as TS  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine as TE  # noqa: E402
from p2pnetwork_tpu_torch.sim import flightrec  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402
from p2pnetwork_tpu_torch.sim.simnode import TorchSimNode  # noqa: E402
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

COMMS = ("ppermute", "pallas")
#: The reference's ``k`` where a case's ``k`` is parametrised: its bits do
#: not depend on ``k``, so it runs once.
REF_K = 16
LAYOUTS = {"segment": {}, "mxu": {"mxu": True}, "hybrid": {"hybrid": True}}


@pytest.fixture(scope="module", autouse=True)
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (the virtual CPU mesh of conftest)")


def _star(n):
    hub = np.zeros(n - 1, dtype=np.int32)
    leaves = np.arange(1, n, dtype=np.int32)
    return (np.concatenate([hub, leaves]), np.concatenate([leaves, hub]), n)


#: name -> (generator, args, kwargs), built alike by both packages.
GRAPHS = {
    "ws1024": ("watts_strogatz", (1024, 6, 0.2), {"seed": 0}),
    "ws1024s1": ("watts_strogatz", (1024, 6, 0.2), {"seed": 1}),
    "ws1024s2": ("watts_strogatz", (1024, 6, 0.1), {"seed": 2}),
    "ws1024s20": ("watts_strogatz", (1024, 6, 0.2), {"seed": 20}),
    "ba2048": ("barabasi_albert", (2048, 4), {"seed": 0}),
    "ba2048s21": ("barabasi_albert", (2048, 4), {"seed": 21}),
    "ba1024m6": ("barabasi_albert", (1024, 6), {"seed": 1}),
    "ba1024m3": ("barabasi_albert", (1024, 3), {"seed": 2}),
    "ring512": ("ring", (512,), {}),
    "star2048": ("from_edges", _star(2048), {}),
}

#: Churn applied on both rings: (failed nodes, dynamic capacity, links).
CHURN = {
    None: None,
    "hybrid": ([3, 700], 8, ([2], [900])),
    "link": ([], 8, ([100], [400])),
    "ba": ([2], 8, ([10], [1000])),
    "hop": ([100], 8, ([5], [400])),
}


def _churn(mod, sg, name):
    spec = CHURN[name]
    if spec is None:
        return sg
    failed, cap, (s, r) = spec
    if failed:
        sg = mod.fail_nodes(sg, failed)
    return mod.connect(mod.with_capacity(sg, cap), s, r)


@functools.lru_cache(maxsize=None)
def _graphs(name):
    fn, args, kw = GRAPHS[name]
    return (getattr(JG, fn)(*args, **kw),
            getattr(TG, fn)(*args, **kw, device="cpu"))


@functools.lru_cache(maxsize=None)
def _jax_sharded(name, S, churn=None, **layout):
    m = JM.ring_mesh(S)
    return _churn(JS, JS.shard_graph(_graphs(name)[0], m, source_csr=True,
                                     **layout), churn), m


def _port_sharded(name, S, churn=None, **layout):
    m = TM.ring_mesh(S, device="cpu")
    return _churn(TS, TS.shard_graph(_graphs(name)[1], m, source_csr=True,
                                     **layout), churn), m


@functools.lru_cache(maxsize=None)
def _jax_flood(name, S, k, source, target, max_rounds=1024, churn=None,
               **layout):
    sg, m = _jax_sharded(name, S, churn, **layout)
    seen, out = JS.flood_until_coverage(
        sg, m, source, coverage_target=target, max_rounds=max_rounds,
        adaptive_k=k, comm="ppermute")
    return np.asarray(seen), out


def _port_flood(name, S, k, source, target, comm, max_rounds=1024,
                churn=None, **layout):
    sg, m = _port_sharded(name, S, churn, **layout)
    kw = dict(coverage_target=target, max_rounds=max_rounds, comm=comm)
    seen_a, out_a = TS.flood_until_coverage(sg, m, source, adaptive_k=k, **kw)
    sparse = list(TS.LAST_SPARSE_ROUNDS)
    seen_d, out_d = TS.flood_until_coverage(sg, m, source, **kw)
    # The adaptive loop equals the port's dense loop bit for bit.
    np.testing.assert_array_equal(seen_a.numpy(), seen_d.numpy())
    assert out_a == out_d
    return seen_a.numpy(), out_a, sparse


def _check_flood(name, S, k, source, target, comm, layout="segment",
                 max_rounds=1024, churn=None, ref_k=None):
    want_seen, want = _jax_flood(name, S, ref_k or k, source, target,
                                 max_rounds, churn)
    seen, out, sparse = _port_flood(name, S, k, source, target, comm,
                                    max_rounds, churn, **LAYOUTS[layout])
    np.testing.assert_array_equal(seen, want_seen)
    assert out == want
    return out, sparse


# ------------------------------------------------------------------ flood


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("k", [16, 256])
@pytest.mark.parametrize("S", [1, 2, 8])
def test_flood_equals_reference_and_dense(S, k, comm):
    out, sparse = _check_flood("ws1024", S, k, 0, 0.99, comm, ref_k=REF_K)
    # Both regimes run: sparse rounds first, then a crossing to dense.
    assert sparse and sparse == list(range(len(sparse)))
    assert len(sparse) < out["rounds"]


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("layout", ["mxu", "hybrid"])
def test_flood_every_layout(layout, comm):
    _check_flood("ws1024", 8, 256, 0, 0.99, comm, layout, ref_k=REF_K)


@pytest.mark.parametrize("comm", COMMS)
def test_hybrid_layout_and_churn(comm):
    # The reference's case: hybrid with min_count=32, two failed nodes, a
    # runtime link; held to the JAX ring on its segment layout.
    want_seen, want = _jax_flood("ws1024s1", 8, 64, 0, 0.95, churn="hybrid")
    seen, out, _ = _port_flood("ws1024s1", 8, 64, 0, 0.95, comm,
                               churn="hybrid", hybrid=True, min_count=32)
    np.testing.assert_array_equal(seen, want_seen)
    assert out == want
    assert not seen.reshape(-1)[3]


@pytest.mark.parametrize("comm", COMMS)
def test_dynamic_link_carries_in_sparse_mode(comm):
    # k large enough to stay sparse the whole run: the runtime link must
    # jump the wave across the ring, found by the sorted-list search.
    out, sparse = _check_flood("ring512", 4, 1024, 0, 0.5, comm,
                               max_rounds=200, churn="link")
    assert len(sparse) == out["rounds"]


def test_resume_state_roundtrip():
    sg, m = _port_sharded("ws1024s2", 8)
    jsg, jm = _jax_sharded("ws1024s2", 8)
    state, out1 = TS.flood_until_coverage(
        sg, m, 0, coverage_target=0.3, adaptive_k=64, return_state=True)
    state, out2 = TS.flood_until_coverage(
        sg, m, 0, coverage_target=0.99, adaptive_k=64, state0=state,
        return_state=True)
    jstate, j1 = JS.flood_until_coverage(
        jsg, jm, 0, coverage_target=0.3, adaptive_k=64, return_state=True,
        comm="ppermute")
    jstate, j2 = JS.flood_until_coverage(
        jsg, jm, 0, coverage_target=0.99, adaptive_k=64, state0=jstate,
        return_state=True, comm="ppermute")
    assert (out1, out2) == (j1, j2)
    for got, want in zip(state, jstate):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- hub graphs


@pytest.mark.parametrize("S", [2, 8])
def test_ba_equals_reference_and_dense(S):
    _check_flood("ba2048", S, 64, 5, 0.99, "pallas")


def test_star_hub_forces_chunked_work_items():
    # The hub's row is ~n/S slots a shard, far past the 128-wide item: the
    # sparse rounds run the cumsum + searchsorted expansion.
    sg, _ = _port_sharded("star2048", 2)
    assert sg.csr_span > 128
    out, sparse = _check_flood("star2048", 2, 512, 5, 0.99, "pallas")
    assert sparse


def test_hub_source_under_tiny_budget():
    # Source 0 is a hub under a budget of 4 items: the rounds cross to
    # dense as soon as the wave outgrows it.
    out, sparse = _check_flood("ba1024m6", 4, 4, 0, 0.99, "pallas")
    assert len(sparse) < out["rounds"]


def test_ba_with_churn():
    out, _ = _check_flood("ba1024m3", 4, 32, 5, 0.95, "pallas", churn="ba")
    seen, _ = _jax_flood("ba1024m3", 4, 32, 5, 0.95, churn="ba")
    assert not seen.reshape(-1)[2]


# ---------------------------------------------------------- hop distance


@functools.lru_cache(maxsize=None)
def _jax_hop(name, S, k, source, target, churn=None, prefix=0):
    sg, m = _jax_sharded(name, S, churn)
    st = None
    if prefix:
        st, _ = JS.hopdist(sg, m, JHop(source=source), prefix,
                           comm="ppermute")
    (d, f, r), out = JS.hopdist_until_coverage(
        sg, m, JHop(source=source), coverage_target=target, state0=st,
        adaptive_k=k, comm="ppermute")
    return np.asarray(d), np.asarray(f), int(r), out


def _check_hop(name, S, k, source, target, comm, churn=None, prefix=0):
    sg, m = _port_sharded(name, S, churn)
    proto = HopDistance(source=source)
    st = TS.hopdist(sg, m, proto, prefix, comm=comm)[0] if prefix else None
    kw = dict(coverage_target=target, state0=st, comm=comm)
    (d, f, r), out = TS.hopdist_until_coverage(sg, m, proto, adaptive_k=k,
                                               **kw)
    # The sparse rounds' outputs feed the ring's hop, whose kernel takes
    # contiguous blocks only.
    assert d.is_contiguous() and f.is_contiguous()
    (dd, fd, rd), outd = TS.hopdist_until_coverage(sg, m, proto, **kw)
    np.testing.assert_array_equal(d.numpy(), dd.numpy())
    np.testing.assert_array_equal(f.numpy(), fd.numpy())
    assert out == outd and int(r) == int(rd)
    want_d, want_f, want_r, want = _jax_hop(name, S, k, source, target,
                                            churn, prefix)
    np.testing.assert_array_equal(d.numpy(), want_d)
    np.testing.assert_array_equal(f.numpy(), want_f)
    assert int(r) == want_r and out == want
    return d.numpy(), out


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("k", [16, 256])
@pytest.mark.parametrize("S", [2, 8])
def test_hopdist_until_done_equals_reference(S, k, comm):
    # The unreachable target of hopdist_until_done: only wave death stops.
    sg, m = _port_sharded("ws1024s20", S)
    (d, _, r), out = TS.hopdist_until_done(sg, m, HopDistance(source=3),
                                           adaptive_k=k, comm=comm)
    jd, _, jr, jout = _jax_hop("ws1024s20", S, REF_K, 3, 2.0)
    np.testing.assert_array_equal(d.numpy(), jd)
    assert out == jout and int(r) == jr


def test_hopdist_ba_hub_until_coverage():
    _check_hop("ba2048s21", 4, 64, 7, 0.99, "pallas")


@pytest.mark.parametrize("comm", COMMS)
def test_hopdist_under_churn_and_resume(comm):
    d, _ = _check_hop("ring512", 4, 32, 0, 2.0, comm, churn="hop", prefix=10)
    assert d.reshape(-1)[100] == -1


# --------------------------------------------------------- the mesh node


def test_simnode_flood_adaptive_equals_reference(tmp_path):
    # tests/test_simnode_mesh.py's flood case: the adaptive mesh node's
    # summary equals the single-device node's, in both packages; the
    # port's state equals the reference mesh node's, and survives a
    # checkpoint round trip through the reference's file format.
    jg, tg = _graphs("ws1024")
    ja = JaxSimNode(graph=jg, protocol=JFlood(source=0), seed=0,
                    mesh=JM.ring_mesh(8), adaptive_k=64)
    want = ja.run_until_coverage(0.99)
    tm = TM.ring_mesh(8, device="cpu")
    node = TorchSimNode(graph=tg, protocol=Flood(source=0), seed=0,
                        mesh=tm, adaptive_k=64)
    assert node.sim_sharded.csr_pos is not None
    got = node.run_until_coverage(0.99)
    single = TorchSimNode(graph=tg, protocol=Flood(source=0), seed=0)
    assert got == want == single.run_until_coverage(0.99)
    for g_, w_ in zip(node.sim_state, ja.sim_state):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    path = str(tmp_path / "node.npz")
    node.save_checkpoint(path)
    back = TorchSimNode(graph=tg, protocol=Flood(source=0), seed=0,
                        mesh=tm, adaptive_k=64)
    back.load_checkpoint(path)
    assert back.sim_round == node.sim_round
    assert back.sim_sharded.csr_pos is not None
    for g_, w_ in zip(back.sim_state, node.sim_state):
        np.testing.assert_array_equal(g_.numpy(), w_.numpy())


def test_simnode_hopdist_adaptive_equals_reference():
    jg, tg = _graphs("ws1024")
    want = JaxSimNode(graph=jg, protocol=JHop(source=0), seed=0,
                      mesh=JM.ring_mesh(8), adaptive_k=64
                      ).run_until_coverage(0.99)
    node = TorchSimNode(graph=tg, protocol=HopDistance(source=0), seed=0,
                        mesh=TM.ring_mesh(8, device="cpu"), adaptive_k=64)
    assert node.run_until_coverage(0.99) == want
    _, ref = TE.run_until_coverage(tg, HopDistance(source=0), prng.key(0),
                                   coverage_target=0.99)
    assert (want["rounds"], want["messages"]) == (ref["rounds"],
                                                  ref["messages"])


def test_sharded_fields_carry_the_csr_view():
    from p2pnetwork_tpu_torch import interop
    from tests.test_torch_ring import sharded_fields

    jsg, _ = _jax_sharded("ws1024", 8)
    carried = interop.sharded_graph_from_numpy(
        sharded_fields(jsg), TM.ring_mesh(8, device="cpu"))
    assert carried.csr_span == jsg.csr_span
    for f in ("csr_pos", "csr_offsets"):
        np.testing.assert_array_equal(getattr(carried, f).numpy(),
                                      np.asarray(getattr(jsg, f)))
    seen, out = TS.flood_until_coverage(
        carried, TM.ring_mesh(8, device="cpu"), 0, adaptive_k=64)
    want_seen, want = _jax_flood("ws1024", 8, 64, 0, 0.99)
    np.testing.assert_array_equal(seen.numpy(), want_seen)
    assert out == want


# --------------------------------------------------------------- refusals


def test_syncs_are_two_a_round():
    # One exit-flag read and one branch read a round, plus the last exit
    # read and the summary's one transfer; nothing else reads the device.
    sg, m = _port_sharded("ws1024", 8)
    before = _device.SYNCS
    _, out = TS.flood_until_coverage(sg, m, 0, adaptive_k=256)
    assert _device.SYNCS - before == 2 * out["rounds"] + 2


@pytest.mark.parametrize("case", ["recorder", "fault-spec", "no-csr",
                                  "hop-no-csr"])
def test_reference_refusals(case):
    sg, m = _port_sharded("ws1024", 2)
    plain = TS.shard_graph(_graphs("ws1024")[1], m)
    if case == "recorder":
        with pytest.raises(ValueError, match="adaptive"):
            TS.flood_until_coverage(sg, m, 0, adaptive_k=64,
                                    recorder=flightrec.FlightRecorder())
    elif case == "fault-spec":
        spec = TCD.FaultSpec(TCD.FaultSchedule(seed=1, zero=0.5),
                             "ppermute")
        with pytest.raises(ValueError, match="fault-spec"):
            TS.flood_until_coverage(sg, m, 0, adaptive_k=64, comm=spec)
    elif case == "no-csr":
        with pytest.raises(ValueError, match="source_csr"):
            TS.flood_until_coverage(plain, m, 0, adaptive_k=32)
    else:
        with pytest.raises(ValueError, match="source_csr"):
            TS.hopdist_until_done(plain, m, HopDistance(source=0),
                                  adaptive_k=16)


@pytest.mark.parametrize("case", ["no-mesh", "sir"])
def test_simnode_refusals(case):
    _, tg = _graphs("ws1024")
    if case == "no-mesh":
        with pytest.raises(ValueError, match="mesh backend"):
            TorchSimNode(graph=tg, protocol=Flood(source=0), adaptive_k=8)
    else:
        with pytest.raises(ValueError, match="Flood and HopDistance"):
            TorchSimNode(graph=tg, protocol=SIR(),
                         mesh=TM.ring_mesh(8, device="cpu"), adaptive_k=8)
