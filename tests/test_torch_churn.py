"""Runtime links and failures (``sim/topology.py``, ``sim/failures.py``)
against the JAX package.

The same operations, on the same numpy-made ids, go through both packages
from byte-equal builds; every array of the resulting graphs must be equal
(COO masks, degrees, neighbor table, the re-masked blocked, hybrid and
skew layouts, the dynamic region's slots). Then floods on a churned graph
(capacity, a batch of runtime links, a band of failed nodes) through every
method must return the reference's dict and final state exactly; the
reference's ``pallas`` runs in the Pallas interpreter, as its own tests
run it on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu.models import adaptive_flood as JA  # noqa: E402
from p2pnetwork_tpu.models import flood as JF  # noqa: E402
from p2pnetwork_tpu.sim import engine as JE  # noqa: E402
from p2pnetwork_tpu.sim import failures as JFa  # noqa: E402
from p2pnetwork_tpu.sim import topology as JT  # noqa: E402
from p2pnetwork_tpu_torch import interop, prng  # noqa: E402
from p2pnetwork_tpu_torch.models import adaptive_flood as TA  # noqa: E402
from p2pnetwork_tpu_torch.models import flood as TF  # noqa: E402
from p2pnetwork_tpu_torch.ops import bitset, segsum  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine as TE  # noqa: E402
from p2pnetwork_tpu_torch.sim import failures as TFa  # noqa: E402
from p2pnetwork_tpu_torch.sim import topology as TT  # noqa: E402
from tests.test_torch_frontier import assert_same_state  # noqa: E402
from tests.test_torch_graph import (LAYOUTS, assert_same_fields,  # noqa: E402
                                    build_jax, build_port, graph_fields)

JAX_MODS, PORT_MODS = (JT, JFa), (TT, TFa)


def same(tg, jg):
    assert_same_fields(graph_fields(tg), graph_fields(jg))


def both(family, **kw):
    return build_jax(family, **kw), build_port(family, **kw)


def links(n, count, seed):
    """``count`` random undirected pairs in ``[0, n)`` plus a repeat within
    the batch and a self-pair."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, count)
    r = rng.integers(0, n, count)
    s[-1], r[-1] = s[0], r[0]
    return s.astype(np.int32), r.astype(np.int32)


def churn(mods, g, n):
    """The churn scenario: capacity, a link batch, a failed band."""
    topo, fail = mods
    g = topo.with_capacity(g, extra_edges=200)
    g = topo.connect(g, *links(n, 40, 1))
    return fail.fail_nodes(g, np.arange(n // 8, n // 4))


@pytest.mark.parametrize("extra_edges,extra_nodes", [(100, 0), (0, 200),
                                                     (300, 50)])
def test_with_capacity_matches(extra_edges, extra_nodes):
    jg, tg = both("ba", source_csr=True)
    kw = dict(extra_edges=extra_edges, extra_nodes=extra_nodes)
    got, want = TT.with_capacity(tg, **kw), JT.with_capacity(jg, **kw)
    same(got, want)
    # Growing an existing region keeps its links.
    same(TT.with_capacity(got, extra_edges=10),
         JT.with_capacity(want, extra_edges=10))


def test_with_capacity_refuses_node_growth_under_layouts():
    tg = build_port("er", **LAYOUTS)
    with pytest.raises(ValueError, match="blocked/hybrid"):
        TT.with_capacity(tg, extra_nodes=10)


def test_connect_disconnect_join_match():
    jg, tg = both("er", source_csr=True)
    jg, tg = (m.with_capacity(g, extra_edges=64) for m, g in
              ((JT, jg), (TT, tg)))
    s, r = links(jg.n_nodes, 20, 2)
    # An existing static edge and a dead spare endpoint are dropped too.
    s = np.append(s, [int(jg.senders[0]), 0])
    r = np.append(r, [int(jg.receivers[0]), jg.n_nodes_padded - 1])
    for step in (lambda m, g: m.connect(g, s, r),
                 lambda m, g: m.connect(g, s[:5], r[:5] + 1,
                                        undirected=False),
                 lambda m, g: m.disconnect(g, s[:6], r[:6]),
                 lambda m, g: m.join_node(g, jg.n_nodes + 3, [1, 2, 7])):
        jg, tg = step(JT, jg), step(TT, tg)
        same(tg, jg)
    static = TT.static_edge_exists(tg, tg.senders[:8], tg.receivers[:8])
    assert static.all()


def test_connect_refuses_a_full_region_and_bad_ids():
    tg = TT.with_capacity(build_port("er"), extra_edges=1)  # 128 slots
    with pytest.raises(ValueError, match="full"):
        TT.connect(tg, np.arange(0, 200), np.arange(200, 400))
    with pytest.raises(ValueError, match="out of range"):
        TT.connect(tg, [0], [tg.n_nodes_padded])
    with pytest.raises(ValueError, match="capacity"):
        TT.connect(build_port("er"), [0], [1])


@pytest.mark.parametrize("capped", [False, True])
def test_edge_failures_match(capped):
    kw = dict(source_csr=True, skew_table=True,
              max_degree=4 if capped else None)
    jg, tg = both("ba", **kw)
    jg, tg = (m.connect(m.with_capacity(g, extra_edges=64),
                        *links(300, 10, 3)) for m, g in ((JT, jg), (TT, tg)))
    ids = np.random.default_rng(4).choice(jg.n_edges, 200, replace=False)
    got, want = TFa.cut_links(tg, ids), JFa.cut_links(jg, ids)
    same(got, want)
    assert (got.neighbors is None) == capped
    with pytest.raises(ValueError, match="blocked/hybrid"):
        TFa.fail_edges(build_port("er", **LAYOUTS), ids[:3])


def test_partition_and_revive_match():
    jg, tg = both("er", source_csr=True)
    jg, tg = (m.connect(m.with_capacity(g, extra_edges=64),
                        *links(500, 30, 5)) for m, g in ((JT, jg), (TT, tg)))
    groups = [np.arange(0, 200), np.arange(250, 500)]
    same(TFa.partition(tg, groups), JFa.partition(jg, groups))
    dead_j, dead_t = JFa.fail_nodes(jg, np.arange(50)), TFa.fail_nodes(
        tg, np.arange(50))
    ids = np.arange(10, 30)
    same(TFa.revive_nodes(dead_t, ids, tg), JFa.revive_nodes(dead_j, ids, jg))


@pytest.mark.parametrize("extra_nodes", [0, 100])
def test_consolidate_matches(extra_nodes):
    jg, tg = both("er", **LAYOUTS)  # 500 nodes: spare padding rows
    jg = JT.join_node(churn(JAX_MODS, jg, jg.n_nodes), jg.n_nodes + 5, [9])
    tg = TT.join_node(churn(PORT_MODS, tg, tg.n_nodes), tg.n_nodes + 5, [9])
    kw = dict(extra_edges=64, extra_nodes=extra_nodes)
    same(TT.consolidate(tg, **kw), JT.consolidate(jg, **kw))


@pytest.fixture(scope="module")
def churned():
    """The churn scenario on the WS graph with every layout."""
    kw = dict(LAYOUTS, skew_table=True)
    return (churn(JAX_MODS, build_jax("ws", **kw), 4096),
            churn(PORT_MODS, build_port("ws", **kw), 4096))


@pytest.mark.parametrize("unresponsive", [False, True])
def test_node_failures_remask_every_layout(churned, unresponsive):
    jg, tg = churned
    same(tg, jg)
    ids = np.arange(3000, 3100)
    fn = "mark_unresponsive" if unresponsive else "kill_nodes"
    same(getattr(TFa, fn)(tg, ids), getattr(JFa, fn)(jg, ids))


def test_interop_carries_the_dynamic_region(churned):
    jg, _ = churned
    same(interop.graph_from_numpy(graph_fields(jg), device="cpu"), jg)


#: Every single-device method on the churned graph: (protocol, its
#: keywords), each run from node 1 in both packages.
CHURN_METHODS = {
    "segment": ("Flood", {"method": "segment"}),
    "gather": ("Flood", {"method": "gather"}),
    "blocked": ("Flood", {"method": "blocked"}),
    "pallas": ("Flood", {"method": "pallas"}),
    "hybrid": ("Flood", {"method": "hybrid"}),
    "hybrid-blocked": ("Flood", {"method": "hybrid-blocked"}),
    "skew": ("Flood", {"method": "skew"}),
    "frontier-bitset": ("Flood", {"method": "frontier", "bitset": True}),
    "adaptive-64": ("AdaptiveFlood", {"method": "hybrid", "k": 64}),
    "adaptive-64-bitset": ("AdaptiveFlood", {"method": "pallas", "k": 64,
                                             "bitset": True}),
}


@pytest.fixture(scope="module")
def segment_run(churned):
    """The reference's segment flood of the churned graph."""
    return JE.run_until_coverage(churned[0], JF.Flood(source=1,
                                                      method="segment"),
                                 jax.random.key(0), coverage_target=0.99,
                                 max_rounds=64)


@pytest.mark.parametrize("name", sorted(CHURN_METHODS))
def test_churn_flood_matches(churned, segment_run, name):
    jg, tg = churned
    seg_state, seg_out = segment_run
    cls, kw = CHURN_METHODS[name]
    jproto = getattr(JA if cls == "AdaptiveFlood" else JF, cls)(source=1,
                                                                **kw)
    tproto = getattr(TA if cls == "AdaptiveFlood" else TF, cls)(source=1,
                                                                **kw)
    js, jout = JE.run_until_coverage(jg, jproto, jax.random.key(0),
                                     coverage_target=0.99, max_rounds=64)
    before = segsum.LAUNCHES
    ts, tout = TE.run_until_coverage(tg, tproto, prng.key(0),
                                     coverage_target=0.99, max_rounds=64)
    assert segsum.LAUNCHES == before  # the CPU runs the plain version
    assert tout == jout == seg_out
    assert_same_state(ts, js)
    seen = ts.seen
    if seen.dtype == torch.int32:
        seen = bitset.unpack_bits(seen, tg.n_nodes_padded)
    np.testing.assert_array_equal(seen.numpy(), np.asarray(seg_state.seen))
