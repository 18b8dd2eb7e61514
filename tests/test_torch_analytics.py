"""The port's graph-analytics protocols against the JAX package's, on the
CPU: hop distance (plain and adaptive, ``bfs_distances``,
``eccentricities``, ``diameter_bounds``), leader election, connected
components, spanning tree, Luby's MIS, coloring, k-core and
distance-vector routing.

Each runs through the engine entry point a user calls, in both packages
on the same graph and key, through every method the reference accepts
for its aggregation; the summary dicts, the stacked stats and every
field of the final state are equal exactly (they are bools, ints, and
f32 costs made by the same adds, compared by their bits). K-core's count
keeps the reference's dtype in each method.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from p2pnetwork_tpu import models as JM  # noqa: E402
from p2pnetwork_tpu.models import hopdist as JH  # noqa: E402
from p2pnetwork_tpu.ops import segment as JS  # noqa: E402
from p2pnetwork_tpu.sim import engine as JE  # noqa: E402
from p2pnetwork_tpu.sim import failures as JFa  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu.sim import topology as JT  # noqa: E402
from p2pnetwork_tpu_torch import interop, prng  # noqa: E402
from p2pnetwork_tpu_torch import models as TM  # noqa: E402
from p2pnetwork_tpu_torch.models import hopdist as TH  # noqa: E402
from p2pnetwork_tpu_torch.ops import segment as TS  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine as TE  # noqa: E402
from p2pnetwork_tpu_torch.sim import failures as TFa  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402
from p2pnetwork_tpu_torch.sim import topology as TT  # noqa: E402
from tests.test_torch_graph import (LAYOUTS, build_jax,  # noqa: E402
                                    build_port, state_fields)
from tests.test_torch_semiring import bits, latency  # noqa: E402

#: Every layout, so that every method can run.
ALL = dict(LAYOUTS, skew_table=True)
#: The OR lowerings (hop distance, MIS's announcement), the max and
#: min-plus ones, and the sum ones (k-core).
OR_METHODS = ["segment", "gather", "skew", "blocked", "pallas", "hybrid",
              "hybrid-blocked", "frontier", "auto"]
MAX_METHODS = ["segment", "gather", "skew", "frontier", "auto"]
SUM_METHODS = ["segment", "gather", "skew", "blocked", "pallas", "hybrid",
               "hybrid-blocked", "auto"]


def churn(mods, g):
    """Runtime links, then a failed node band (node failures re-mask
    every layout) — the same ids in both packages."""
    topo, fail = mods
    rng = np.random.default_rng(9)
    n = g.n_nodes
    g = topo.with_capacity(g, extra_edges=128)
    g = topo.connect(g, rng.integers(0, n, 24).astype(np.int32),
                     rng.integers(0, n, 24).astype(np.int32))
    return fail.fail_nodes(g, np.arange(n // 5, n // 4))


_GRAPHS = {}


def graphs(family="ws", churned=False, weighted=False):
    key = (family, churned, weighted)
    if key not in _GRAPHS:
        jg, tg = build_jax(family, **ALL), build_port(family, **ALL)
        if weighted:
            jg, tg = jg.with_weights(latency), tg.with_weights(latency)
        if churned:
            jg, tg = churn((JT, JFa), jg), churn((TT, TFa), tg)
        _GRAPHS[key] = jg, tg
    return _GRAPHS[key]


def assert_state_equal(got, want):
    got, want = state_fields(got), state_fields(want)
    assert set(got) == set(want)
    for k in want:
        g, w = bits(got[k]), bits(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype,
                                                           w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


def assert_stats_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(bits(got[k].numpy().astype(
            np.asarray(want[k]).dtype)), bits(want[k]), err_msg=k)


def converged(jg, tg, jproto, tproto, stat, max_rounds=256, key=0):
    js, jout = JE.run_until_converged(jg, jproto, jax.random.key(key),
                                      stat=stat, threshold=1,
                                      max_rounds=max_rounds)
    ts, tout = TE.run_until_converged(tg, tproto, prng.key(key), stat=stat,
                                      threshold=1, max_rounds=max_rounds)
    assert tout == jout
    assert_state_equal(ts, js)
    return ts, tout


def covered(jg, tg, jproto, tproto, target=1.0):
    js, jout = JE.run_until_coverage(jg, jproto, jax.random.key(0),
                                     coverage_target=target, max_rounds=64)
    ts, tout = TE.run_until_coverage(tg, tproto, prng.key(0),
                                     coverage_target=target, max_rounds=64)
    assert tout == jout
    assert_state_equal(ts, js)
    return ts, tout


def stacked(jg, tg, jproto, tproto, rounds):
    js, jst = JE.run(jg, jproto, jax.random.key(0), rounds)
    ts, tst = TE.run(tg, tproto, prng.key(0), rounds)
    assert_stats_equal(tst, jst)
    assert_state_equal(ts, js)
    return ts, tst


# ---------------------------------------------------------- hop distance


@pytest.mark.parametrize("churned", [False, True], ids=["healthy", "churn"])
@pytest.mark.parametrize("method", OR_METHODS)
def test_hop_distance_equals_reference(method, churned):
    jg, tg = graphs(churned=churned)
    covered(jg, tg, JM.HopDistance(source=1, method=method),
            TM.HopDistance(source=1, method=method), target=0.99)
    if not churned:
        stacked(jg, tg, JM.HopDistance(source=1, method=method),
                TM.HopDistance(source=1, method=method), 6)


@pytest.mark.parametrize("k", [16, 64, 4096])
@pytest.mark.parametrize("family", ["ws", "ba"])
def test_adaptive_hop_distance_equals_reference(family, k):
    # k = 16 and 64 cross between sparse and dense rounds; 4096 stays
    # sparse. On BA the hubs' rows span several work items.
    jg, tg = graphs(family, churned=True)
    kw = dict(source=3, method="hybrid", k=k)
    ts, _ = covered(jg, tg, JM.AdaptiveHopDistance(**kw),
                    TM.AdaptiveHopDistance(**kw))
    hs, _ = covered(jg, tg, JM.HopDistance(source=3, method="segment"),
                    TM.HopDistance(source=3, method="segment"))
    assert torch.equal(ts.dist, hs.dist)


@pytest.mark.parametrize("method", ["segment", "hybrid", "frontier"])
@pytest.mark.parametrize("family", ["ws", "ba"])
def test_bfs_and_eccentricities_equal_reference(family, method):
    jg, tg = graphs(family, churned=True)
    np.testing.assert_array_equal(
        TH.bfs_distances(tg, 5, method).numpy(),
        np.asarray(JH.bfs_distances(jg, 5, method)))
    sources = np.array([0, 5, 77, jg.n_nodes // 5 + 1], np.int32)  # a dead one
    want = JH.eccentricities(jg, jnp.asarray(sources), method)
    got = TH.eccentricities(tg, torch.from_numpy(sources), method)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("samples", [1, 16])
@pytest.mark.parametrize("family", ["ws", "ba"])
def test_diameter_bounds_equal_reference(family, samples):
    # The picks are prng.choice without replacement over the live nodes.
    for churned in (False, True):
        jg, tg = graphs(family, churned=churned)
        want = JH.diameter_bounds(jg, jax.random.key(4), samples, "auto")
        got = TH.diameter_bounds(tg, prng.key(4), samples, "auto")
        assert got == want


# --------------------------------------------------------------- max


@pytest.mark.parametrize("churned", [False, True], ids=["healthy", "churn"])
@pytest.mark.parametrize("method", MAX_METHODS)
def test_leader_election_equals_reference(method, churned):
    jg, tg = graphs(churned=churned)
    converged(jg, tg, JM.LeaderElection(method=method),
              TM.LeaderElection(method=method), "changed")
    if not churned:
        stacked(jg, tg, JM.LeaderElection(method=method),
                TM.LeaderElection(method=method), 4)


def test_leader_election_on_the_skew_rung_graph():
    jg, tg = graphs("ba", churned=True)
    ts, _ = converged(jg, tg, JM.LeaderElection(method="skew"),
                      TM.LeaderElection(method="skew"), "changed")
    live = tg.node_mask
    assert (ts.known[live] == ts.known[live].max()).all()


def _split(mods, g):
    """Three components: two node bands failed, cutting the WS ring."""
    return mods.fail_nodes(g, np.r_[1000:1100, 2500:2600])


@pytest.mark.parametrize("method", MAX_METHODS)
def test_connected_components_equal_reference(method):
    jg, tg = graphs()
    jg, tg = _split(JFa, jg), _split(TFa, tg)
    ts, _ = converged(jg, tg, JM.ConnectedComponents(method=method),
                      TM.ConnectedComponents(method=method), "changed")
    stacked(jg, tg, JM.ConnectedComponents(method=method),
            TM.ConnectedComponents(method=method), 5)


@pytest.mark.parametrize("churned", [False, True], ids=["healthy", "churn"])
@pytest.mark.parametrize("method", MAX_METHODS)
def test_spanning_tree_equals_reference(method, churned):
    jg, tg = graphs(churned=churned)
    ts, _ = covered(jg, tg, JM.SpanningTree(source=2, method=method),
                    TM.SpanningTree(source=2, method=method))
    reached = ts.parent >= 0
    assert ts.parent[2] == 2 and (ts.dist[reached] >= 0).all()


#: (max method, OR method) pairs for the MIS: every lowering of each.
MIS_PAIRS = [("segment", "segment"), ("gather", "hybrid"),
             ("skew", "pallas"), ("frontier", "blocked"),
             ("auto", "hybrid-blocked"), ("gather", "frontier"),
             ("segment", "skew"), ("auto", "auto")]


@pytest.mark.parametrize("method,or_method", MIS_PAIRS)
def test_luby_mis_equals_reference(method, or_method):
    jg, tg = graphs(churned=True)
    kw = dict(method=method, or_method=or_method)
    ts, out = converged(jg, tg, JM.LubyMIS(**kw), TM.LubyMIS(**kw),
                        "undecided")
    assert out["value"] == 0 and out["rounds"] > 1
    # Independent: no edge joins two members.
    s, r = tg.senders[tg.edge_mask], tg.receivers[tg.edge_mask]
    assert not (ts.in_mis[s] & ts.in_mis[r]).any()


@pytest.mark.parametrize("method", ["gather", "segment"])
def test_color_via_mis_equals_reference(method):
    for family in ("ws", "ba"):
        jg, tg = graphs(family, churned=True)
        jc, jn = JM.color_via_mis(jg, jax.random.key(2), method=method)
        tc, tn = TM.color_via_mis(tg, prng.key(2), method=method)
        assert tn == jn
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        s, r = tg.senders[tg.edge_mask], tg.receivers[tg.edge_mask]
        assert not (tc[s] == tc[r]).any()


def test_color_via_mis_raises_as_the_reference():
    _, tg = graphs("ba")
    with pytest.raises(RuntimeError, match="max_colors"):
        TM.color_via_mis(tg, prng.key(0), max_colors=1)
    with pytest.raises(RuntimeError, match="did not quiesce"):
        TM.color_via_mis(tg, prng.key(0), max_rounds_per_color=1)


# --------------------------------------------------------------- k-core


@pytest.mark.parametrize("method", SUM_METHODS)
@pytest.mark.parametrize("family,k", [("ws", 10), ("ba", 6)])
def test_kcore_equals_reference(family, k, method):
    jg, tg = graphs(family, churned=True)
    ts, out = converged(jg, tg, JM.KCore(k=k, method=method),
                        TM.KCore(k=k, method=method), "removed")
    assert out["rounds"] > 1


def _ring(n):
    s = np.arange(n, dtype=np.int32)
    r = (s + 1) % n
    return np.r_[s, r], np.r_[r, s]


@pytest.mark.parametrize("method", SUM_METHODS)
def test_kcore_count_dtypes_follow_the_reference(method):
    # pallas and blocked sum in f32 (pallas_edge.py, the one-hot einsum);
    # hybrid and hybrid-blocked add that f32 remainder to i32 diagonals,
    # except when there is no remainder (a ring: every edge on a
    # diagonal); the rest keep i32. `exact` is ignored by the port, right
    # for the 0/1 indicator.
    jg, tg = graphs("ws", churned=True)
    jr = JG.from_edges(*_ring(300), 300, blocked=True, hybrid=True,
                       skew_table=True)
    tr = TG.from_edges(*_ring(300), 300, blocked=True, hybrid=True,
                       skew_table=True, device="cpu")
    assert jr.hybrid.remainder is None and tr.hybrid.remainder is None
    for j, t in ((jg, tg), (jr, tr)):
        ind = (np.arange(j.n_nodes_padded) % 3 != 0)
        ind = ind.astype(np.int32)
        want = JS.propagate_sum(j, jnp.asarray(ind), method, exact=False)
        for exact in (False, True):
            got = TS.propagate_sum(t, torch.from_numpy(ind), method,
                                   exact=exact)
            assert str(got.dtype).split(".")[1] == str(want.dtype)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert str(TS.propagate_sum(tg, torch.ones(tg.n_nodes_padded,
                                               dtype=torch.int32),
                                "pallas").dtype) == "torch.float32"


def test_kcore_refuses_bad_k():
    with pytest.raises(ValueError, match="k must be"):
        TM.KCore(k=0)


# -------------------------------------------------------------- routing


ROUTE_METHODS = ["segment", "gather", "skew", "frontier", "auto"]


@pytest.mark.parametrize("churned", [False, True], ids=["healthy", "churn"])
@pytest.mark.parametrize("method", ROUTE_METHODS)
@pytest.mark.parametrize("family", ["ws", "ba"])
def test_distance_vector_equals_reference(family, method, churned):
    jg, tg = graphs(family, churned=churned, weighted=True)
    jp = JM.DistanceVector(source=0, method=method)
    tp = TM.DistanceVector(source=0, method=method)
    js, _ = JE.run_until_converged(jg, jp, jax.random.key(0),
                                   stat="changed", threshold=1,
                                   max_rounds=512)
    ts, _ = converged(jg, tg, jp, tp, "changed", max_rounds=512)
    np.testing.assert_array_equal(tp.next_hops(tg, ts).numpy(),
                                  np.asarray(jp.next_hops(jg, js)))
    if not churned:
        stacked(jg, tg, jp, tp, 5)


def test_every_method_routes_to_the_same_bits():
    jg, tg = graphs("ba", churned=True, weighted=True)
    ref = None
    for method in ROUTE_METHODS:
        ts, _ = TE.run_until_converged(
            tg, TM.DistanceVector(source=0, method=method), prng.key(0),
            stat="changed", threshold=1, max_rounds=512)
        got = (bits(ts.dist), ts.parent.numpy())
        if ref is not None:
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g, r)
        ref = got


def test_unweighted_routing_is_hop_distance():
    jg, tg = graphs("ws", churned=True)
    ts, _ = converged(jg, tg, JM.DistanceVector(source=4, method="gather"),
                      TM.DistanceVector(source=4, method="gather"),
                      "changed")
    hs, _ = covered(jg, tg, JM.HopDistance(source=4),
                    TM.HopDistance(source=4))
    reached = hs.dist >= 0
    assert torch.equal(torch.isfinite(ts.dist), reached)
    assert torch.equal(ts.dist[reached], hs.dist[reached].float())


def test_dead_source_reaches_nothing():
    jg, tg = graphs("ws", churned=True, weighted=True)
    dead = jg.n_nodes // 5 + 3
    ts, out = converged(jg, tg, JM.DistanceVector(source=dead),
                        TM.DistanceVector(source=dead), "changed")
    assert out["rounds"] == 1 and torch.isinf(ts.dist).all()


# -------------------------------------------------------------- interop


#: (protocol pair, stat to converge on) for the state carried across.
CARRY = {
    "DistanceVectorState": (lambda M: M.DistanceVector(source=0), "changed"),
    "LeaderElectionState": (lambda M: M.LeaderElection(), "changed"),
    "ConnectedComponentsState": (lambda M: M.ConnectedComponents(),
                                 "changed"),
    "SpanningTreeState": (lambda M: M.SpanningTree(source=0), "frontier"),
    "LubyMISState": (lambda M: M.LubyMIS(), "undecided"),
    "KCoreState": (lambda M: M.KCore(k=10), "removed"),
    "HopDistanceState": (lambda M: M.HopDistance(source=0), "frontier"),
    "AdaptiveHopDistanceState": (lambda M: M.AdaptiveHopDistance(
        source=0, k=64), "frontier"),
}


@pytest.mark.parametrize("name", sorted(CARRY))
def test_states_carry_across_and_resume(name):
    make, stat = CARRY[name]
    jg, tg = graphs("ws", churned=True, weighted=True)
    jproto, tproto = make(JM), make(TM)
    js, _ = JE.run(jg, jproto, jax.random.key(1), 3)
    assert type(js).__name__ == name
    ts = interop.protocol_state_from_numpy(name, state_fields(js),
                                           device="cpu")
    assert_state_equal(ts, js)
    key = jax.random.key(5)
    js2, jout = JE.run_until_converged(jg, jproto, key, stat=stat,
                                       threshold=1, state0=js, donate=False)
    ts2, tout = TE.run_until_converged(
        tg, tproto, interop.key_from_numpy(jax.random.key_data(key)),
        stat=stat, threshold=1, state0=ts)
    assert tout == jout
    assert_state_equal(ts2, js2)


def test_state_fields_are_the_references():
    for name in CARRY:
        assert ([f.name for f in dataclasses.fields(getattr(TM, name))]
                == [f.name for f in dataclasses.fields(getattr(JM, name))])
