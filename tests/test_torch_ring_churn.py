"""The ring's churn operations (``parallel/sharded.py``): the liveness
re-mask, the dynamic region and the topology state, against the JAX
package's on the same shards.

The JAX side runs on the 8-device virtual CPU mesh of
``tests/conftest.py`` (these tests skip with fewer devices); its re-mask
collects liveness with ``ppermute``, which its own tests pin equal to its
Pallas ring hop. The port runs both of its backends (on the CPU the ring
kernels' plain versions). Graph: ``watts_strogatz(1024, 6, 0.2)`` on 8
shards (``tests/test_simnode_mesh.py``'s), whose 1,024 padded nodes are
``S * block``, so the ring's failure draw is the single-device one.

What must agree, exactly: every field of the sharded graph after each
operation (``mxu_extent``, the port's own, stays the pristine build's),
the topology state and its re-application, and the floods after them.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu.parallel import mesh as JM  # noqa: E402
from p2pnetwork_tpu.parallel import sharded as JS  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu_torch import interop, prng  # noqa: E402
from p2pnetwork_tpu_torch.ops import ring  # noqa: E402
from p2pnetwork_tpu_torch.parallel import mesh as TM  # noqa: E402
from p2pnetwork_tpu_torch.parallel import sharded as TS  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401
from tests.test_torch_ring import (assert_same_fields,  # noqa: E402
                                   sharded_fields)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

S = 8
LAYOUTS = {"segment": {}, "mxu": {"mxu": True}, "hybrid": {"hybrid": True}}
FAILED = [5, 500, 1023]
PAIRS = ([2, 10, 130, 700, 2], [900, 11, 640, 701, 900])
CUT = ([10], [11])
COMMS = ("ppermute", "pallas")
#: The churned graphs strand a few nodes, so 0.99 is out of reach; the
#: flood stops at 0.9 or at the round cap.
TARGET = 0.9
MAX_ROUNDS = 24


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < S:
        pytest.skip(f"needs {S} devices (the virtual CPU mesh of conftest)")
    return JM.ring_mesh(S), TM.ring_mesh(S, device="cpu")


@functools.lru_cache(maxsize=None)
def _graphs():
    return (JG.watts_strogatz(1024, 6, 0.2, seed=0),
            TG.watts_strogatz(1024, 6, 0.2, seed=0, device="cpu"))


@functools.lru_cache(maxsize=None)
def _pristine(layout, capacity=8):
    jg, tg = _graphs()
    jsg = JS.shard_graph(jg, JM.ring_mesh(S), **LAYOUTS[layout])
    tsg = TS.shard_graph(tg, TM.ring_mesh(S, device="cpu"),
                         **LAYOUTS[layout])
    if capacity:
        jsg, tsg = JS.with_capacity(jsg, capacity), TS.with_capacity(
            tsg, capacity)
    return jsg, tsg


def _steps(jsg, tsg, comm):
    """The churn sequence on both packages, yielding (name, jax, port)
    after each operation."""
    yield "capacity", jsg, tsg
    jsg, tsg = JS.fail_nodes(jsg, FAILED), _fail(tsg, FAILED, comm)
    yield "fail_nodes", jsg, tsg
    jsg = JS.random_node_failures(jsg, jax.random.key(3), 0.1)
    tsg = TS.with_node_liveness(
        tsg, ~(prng.bernoulli(prng.key(3), 0.1, (tsg.n_nodes_padded,),
                              device="cpu").reshape(S, -1) & tsg.node_mask),
        comm=comm)
    yield "random_node_failures", jsg, tsg
    jsg, tsg = JS.connect(jsg, *PAIRS), TS.connect(tsg, *PAIRS)
    yield "connect", jsg, tsg
    jsg, tsg = JS.disconnect(jsg, *CUT), TS.disconnect(tsg, *CUT)
    yield "disconnect", jsg, tsg
    # A failure after the links: the re-mask reaches the dynamic region.
    jsg, tsg = JS.fail_nodes(jsg, [700]), _fail(tsg, [700], comm)
    yield "fail_linked", jsg, tsg


def _fail(tsg, ids, comm):
    alive = torch.ones(tsg.n_nodes_padded, dtype=torch.bool)
    alive[ids] = False
    return TS.with_node_liveness(tsg, alive, comm=comm)


@functools.lru_cache(maxsize=None)
def _sequence(layout, comm):
    return list(_steps(*_pristine(layout), comm))


def _same_graph(tsg, jsg, pristine_extent):
    got, want = sharded_fields(tsg), sharded_fields(jsg)
    extent = got.pop("mxu_extent")
    if pristine_extent is None:
        assert extent is None
    else:
        np.testing.assert_array_equal(extent, pristine_extent)
    for key in ("csr_pos", "csr_offsets"):
        assert got[key] is None and want[key] is None
    assert_same_fields(got, want)


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_every_churn_step_equals_reference(meshes, layout, comm):
    extent = _pristine(layout)[1].mxu_extent
    extent = None if extent is None else extent.numpy()
    names = []
    for name, jsg, tsg in _sequence(layout, comm):
        _same_graph(tsg, jsg, extent)
        names.append(name)
    assert names[-1] == "fail_linked"
    live = sharded_fields(_sequence(layout, comm)[-1][2])["dyn_mask"]
    assert 0 < live.sum() < 2 * len(PAIRS[0])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_floods_after_churn_equal_reference(meshes, layout):
    for name, jsg, tsg in _sequence(layout, "pallas")[1:]:
        jseen, jout = JS.flood_until_coverage(
            jsg, meshes[0], 0, coverage_target=TARGET, max_rounds=MAX_ROUNDS,
            comm="ppermute")
        for comm in COMMS:
            seen, out = TS.flood_until_coverage(
                tsg, meshes[1], 0, coverage_target=TARGET,
                max_rounds=MAX_ROUNDS, comm=comm)
            assert out == jout, (name, comm)
            np.testing.assert_array_equal(seen.numpy(), np.asarray(jseen))


def test_fixed_round_flood_over_runtime_links(meshes):
    # Fewer rounds than coverage needs: the per-round messages count the
    # dynamic links' out-degrees, and the region's slots carry the flood.
    _, jsg, tsg = _sequence("hybrid", "pallas")[3]
    jseen, jstats = JS.flood(jsg, meshes[0], 2, 3, comm="ppermute")
    seen, stats = TS.flood(tsg, meshes[1], 2, 3)
    np.testing.assert_array_equal(seen.numpy(), np.asarray(jseen))
    for key in stats:
        np.testing.assert_array_equal(stats[key].numpy(),
                                      np.asarray(jstats[key]))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_random_node_failures_equals_reference(meshes, layout):
    jsg, tsg = _pristine(layout)
    want = JS.random_node_failures(jsg, jax.random.key(7), 0.2)
    got = TS.random_node_failures(tsg, prng.key(7), 0.2)
    _same_graph(got, want, None if tsg.mxu_extent is None
                else tsg.mxu_extent.numpy())


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_with_node_liveness_takes_global_and_blocked_masks(meshes, layout):
    jsg, tsg = _pristine(layout, capacity=0)
    alive = np.random.default_rng(4).random(tsg.n_nodes_padded) > 0.3
    want = JS.with_node_liveness(jsg, jax.numpy.asarray(alive))
    for shape in ((-1,), (S, -1)):
        got = TS.with_node_liveness(
            tsg, torch.from_numpy(alive.reshape(shape)))
        _same_graph(got, want, None if tsg.mxu_extent is None
                    else tsg.mxu_extent.numpy())


def test_remask_runs_b2_both_ways(meshes):
    # S forward hops collect the liveness, S - 1 reverse hops fold the
    # out-degrees back; on the CPU they are the plain versions', so the
    # counters stay put, and the template of each direction is its own.
    _, tsg = _pristine("mxu")
    calls = []

    class Counting(TS._RingComm):
        __slots__ = ()

        def shift(self, x):
            calls.append(("fwd", x.dtype, x.is_contiguous()))
            return super().shift(x)

        def shift_back(self, x):
            calls.append(("back", x.dtype, x.is_contiguous()))
            return super().shift_back(x)

    class Spec:
        def make(self, axis_name, n):
            return Counting("pallas", n)

    before = (ring.SHIFT_LAUNCHES, ring.SHIFT_BACK_LAUNCHES)
    TS.with_node_liveness(tsg, torch.ones(S, tsg.block, dtype=torch.bool),
                          comm=Spec())
    # Dense payloads, as the CUDA hop requires.
    assert calls == [("fwd", torch.bool, True)] * S + [
        ("back", torch.int32, True)] * (S - 1)
    assert (ring.SHIFT_LAUNCHES, ring.SHIFT_BACK_LAUNCHES) == before


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_topology_state_round_trips_across_packages(meshes, layout):
    _, jsg, tsg = _sequence(layout, "pallas")[-1]
    jts, tts = JS.topology_state(jsg), TS.topology_state(tsg)
    assert set(jts) == set(tts)
    for key in jts:
        np.testing.assert_array_equal(tts[key].numpy(), np.asarray(jts[key]))
    jp, tp = _pristine(layout)
    # The reference's state onto the port's pristine shards, and back.
    got = TS.apply_topology_state(tp, {k: np.asarray(v)
                                       for k, v in jts.items()})
    _same_graph(got, jsg, None if tp.mxu_extent is None
                else tp.mxu_extent.numpy())
    back = JS.apply_topology_state(jp, {k: v.numpy()
                                        for k, v in tts.items()})
    assert_same_fields(sharded_fields(back), sharded_fields(jsg))


@pytest.mark.parametrize("bad", ["missing", "shape"])
def test_apply_topology_state_refuses_other_constructions(meshes, bad):
    _, tsg = _pristine("segment")
    ts = dict(TS.topology_state(tsg))
    if bad == "missing":
        ts.pop("dyn_mask")
        match = "keys mismatch"
    else:
        ts["node_mask"] = ts["node_mask"][:, :-1]
        match = "mismatch for 'node_mask'"
    with pytest.raises(ValueError, match=match):
        TS.apply_topology_state(tsg, ts)


def test_interop_carries_a_live_dynamic_region(meshes):
    _, jsg, tsg = _sequence("hybrid", "pallas")[4]
    carried = interop.sharded_graph_from_numpy(sharded_fields(jsg),
                                               meshes[1])
    assert carried.dyn_capacity == 8 and carried.dyn_mask.any()
    assert_same_fields(sharded_fields(carried), sharded_fields(tsg))


def test_graph_links_fold_into_static_buckets(meshes):
    # A single-device graph with runtime links shards losslessly: the
    # links join the static buckets, as in the reference.
    from p2pnetwork_tpu.sim import topology as JT
    from p2pnetwork_tpu_torch.sim import topology as TT

    jg, tg = _graphs()
    jg = JT.connect(JT.with_capacity(jg, extra_edges=8), *PAIRS)
    tg = TT.connect(TT.with_capacity(tg, extra_edges=8), *PAIRS)
    for layout in ("segment", "hybrid"):
        want = JS.shard_graph(jg, meshes[0], **LAYOUTS[layout])
        got = TS.shard_graph(tg, meshes[1], **LAYOUTS[layout])
        _same_graph(got, want, None if got.mxu_extent is None
                    else got.mxu_extent.numpy())


def test_with_capacity_rounds_and_grows(meshes):
    jsg, tsg = _pristine("segment", capacity=0)
    assert tsg.dyn_capacity == 0 and tsg.dyn_src is None
    grown = TS.with_capacity(TS.connect(TS.with_capacity(tsg, 3), [1], [600]),
                             5)
    want = JS.with_capacity(JS.connect(JS.with_capacity(jsg, 3), [1], [600]),
                            5)
    assert grown.dyn_capacity == 16 and grown.dyn_mask.sum() == 2
    assert_same_fields(*(
        {k: v for k, v in sharded_fields(x).items()
         if k.startswith("dyn_") or k.endswith("degree")}
        for x in (grown, want)))


@pytest.mark.parametrize("call,match", [
    (lambda sg: TS.connect(sg, [1], [2]), "no dynamic edge capacity"),
    (lambda sg: TS.disconnect(sg, [1], [2]), "no dynamic edge region"),
    (lambda sg: TS.fail_nodes(sg, [sg.n_nodes_padded]), "out of range"),
    (lambda sg: TS.connect(TS.with_capacity(sg, 1), [0], [-1]),
     "out of range"),
    (lambda sg: TS.connect(TS.with_capacity(sg, 1), list(range(1, 10)),
                           [600] * 9), "full"),
], ids=["no-capacity", "no-region", "fail-range", "connect-range", "full"])
def test_churn_refusals(meshes, call, match):
    _, tsg = _pristine("segment", capacity=0)
    with pytest.raises(ValueError, match=match):
        call(tsg)


def test_connect_drops_dead_duplicate_and_existing_pairs(meshes):
    jsg, tsg = _pristine("segment")
    jsg, tsg = JS.fail_nodes(jsg, [9]), TS.fail_nodes(tsg, [9])
    existing = int(tsg.bkt_src[0, 0, 0]), int(tsg.bkt_dst[0, 0, 0])
    s = [existing[0], 9, 3, 3]
    r = [existing[1], 40, 77, 77]
    got = TS.connect(tsg, s, r, undirected=False)
    want = JS.connect(jsg, s, r, undirected=False)
    assert int(got.dyn_mask.sum()) == 1
    assert_same_fields(sharded_fields(dataclasses.replace(
        got, mxu_extent=None)), {**sharded_fields(want),
                                 "mxu_extent": None})
