"""The port's incremental graph builds against the JAX package, on the
CPU: ``GraphDelta``/``apply_delta`` and ``grow``.

Every array of the result is byte-equal to the reference's for the same
base and delta (WS, ER and BA; weighted and unweighted; every layout
flag; churned bases with runtime links and failed nodes; a width-capped
table; ``donate`` on and off) and, on pristine bases, to the port's own
``from_edges`` of the merged edge list. Also the refusals
(``EdgeEndpointError``, unmatched removals, weights), ``growth_capacity``,
the build-phase and growth counters, and floods on the delta'd and grown
graphs by every method, equal to the reference's dicts and states.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu import models as JM  # noqa: E402
from p2pnetwork_tpu.sim import engine as JE  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu_torch import models as TM  # noqa: E402
from p2pnetwork_tpu_torch import prng, telemetry  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine as TE  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402
from p2pnetwork_tpu.sim import failures as JFa  # noqa: E402
from p2pnetwork_tpu.sim import topology as JT  # noqa: E402
from p2pnetwork_tpu_torch.sim import failures as TFa  # noqa: E402
from p2pnetwork_tpu_torch.sim import topology as TT  # noqa: E402
from tests.test_torch_analytics import ALL, churn  # noqa: E402
from tests.test_torch_graph import (LAYOUTS, assert_same_fields,  # noqa: E402
                                    build_jax, build_port, graph_fields,
                                    one_torch_thread, state_fields)
from tests.test_torch_semiring import latency  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

#: Layout flag sets: none, the main path's, and every one.
FLAGS = {"plain": {}, "main": LAYOUTS, "all": ALL}


def bases(family, flags="all", weighted=False, churned=False, **kw):
    """A fresh ``(jax, port)`` base pair (the port's may be donated)."""
    jg = build_jax(family, **FLAGS[flags], **kw)
    tg = build_port(family, **FLAGS[flags], **kw)
    if weighted:
        jg, tg = jg.with_weights(latency), tg.with_weights(latency)
    if churned:
        jg, tg = churn((JT, JFa), jg), churn((TT, TFa), tg)
    return jg, tg


def make_delta(g, seed, n_rm=40, n_add=60, weighted=False):
    """Undirected churn: ``n_rm`` live pairs removed, ``n_add`` new pairs
    (self-loops excluded) added, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    emask = np.asarray(g.edge_mask)
    s, r = np.asarray(g.senders)[emask], np.asarray(g.receivers)[emask]
    fwd = np.flatnonzero(s < r)
    pick = rng.choice(fwd, size=min(n_rm, fwd.size), replace=False)
    a = rng.integers(0, g.n_nodes, n_add)
    b = (a + rng.integers(1, g.n_nodes, n_add)) % g.n_nodes
    w = rng.random(n_add).astype(np.float32) if weighted else None
    kw = dict(add_senders=a, add_receivers=b, add_weights=w,
              remove_senders=s[pick], remove_receivers=r[pick])
    return JG.GraphDelta.undirected(**kw), TG.GraphDelta.undirected(**kw)


def merged_edges(g, delta):
    """``kept + adds`` of the equivalence contract, with weights."""
    emask = np.asarray(g.edge_mask)
    s, r = np.asarray(g.senders)[emask], np.asarray(g.receivers)[emask]
    keys = (r.astype(np.int64) << 32) | s
    rm = ((delta.remove_receivers.astype(np.int64) << 32)
          | delta.remove_senders)
    keep = ~np.isin(keys, rm)
    ws = None
    if g.edge_weight is not None:
        ws = np.concatenate([np.asarray(g.edge_weight)[emask][keep],
                             delta.add_weights])
    return (np.concatenate([s[keep], delta.add_senders]),
            np.concatenate([r[keep], delta.add_receivers]), ws)


@pytest.mark.parametrize("donate", [False, True], ids=["copy", "donate"])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("family", ["ws", "er", "ba"])
def test_apply_delta_is_byte_equal(family, flags, weighted, donate):
    jg, tg = bases(family, flags, weighted)
    jd, td = make_delta(jg, 3, weighted=weighted)
    want = graph_fields(JG.apply_delta(jg, jd))
    got = graph_fields(tg.apply_delta(td, donate=donate))
    assert_same_fields(got, want)
    s, r, w = merged_edges(jg, jd)
    fresh = TG.from_edges(s, r, jg.n_nodes, weights=w, device="cpu",
                          **FLAGS[flags])
    assert_same_fields(got, graph_fields(fresh))


@pytest.mark.parametrize("donate", [False, True], ids=["copy", "donate"])
@pytest.mark.parametrize("family", ["ws", "ba"])
def test_apply_delta_on_a_churned_base(family, donate):
    # Runtime links ride along; failure-masked edges are dropped for
    # good; node_mask is kept.
    jg, tg = bases(family, churned=True)
    jd, td = make_delta(jg, 5)
    jn, tn = JG.apply_delta(jg, jd), TG.apply_delta(tg, td, donate=donate)
    assert_same_fields(graph_fields(tn), graph_fields(jn))
    assert tn.n_edges < tg.n_edges and tn.dyn_mask is not None


@pytest.mark.parametrize("donate", [False, True], ids=["copy", "donate"])
def test_apply_delta_on_a_capped_table(donate):
    jg, tg = bases("ba", "plain", max_degree=6)
    jd, td = make_delta(jg, 7, n_rm=10, n_add=80)
    assert_same_fields(
        graph_fields(TG.apply_delta(tg, td, donate=donate)),
        graph_fields(JG.apply_delta(jg, jd)))


def test_removals_at_a_hub():
    # Removals whose receiver runs outweigh the edge list take the
    # one-pass-over-every-slot form; the result is the same.
    n = 60
    hub_s = np.concatenate([np.arange(1, n), np.zeros(n - 1, np.int64)])
    hub_r = np.concatenate([np.zeros(n - 1, np.int64), np.arange(1, n)])
    jg = JG.from_edges(hub_s, hub_r, n, **LAYOUTS)
    tg = TG.from_edges(hub_s, hub_r, n, device="cpu", **LAYOUTS)
    kw = dict(remove_senders=np.arange(1, 41), remove_receivers=np.zeros(40),
              add_senders=[5, 7], add_receivers=[6, 8])
    want = JG.apply_delta(jg, JG.GraphDelta.undirected(**kw))
    for donate in (False, True):
        got = TG.apply_delta(tg, TG.GraphDelta.undirected(**kw),
                             donate=donate)
        assert_same_fields(graph_fields(got), graph_fields(want))


def test_rolling_donated_deltas_and_pad_multiple():
    # Three deltas in the rolling form, the last re-padded to 512.
    jg, tg = bases("ws")
    for seed, mult in ((11, None), (12, None), (13, 512)):
        jd, td = make_delta(jg, seed)
        jg = JG.apply_delta(jg, jd, edge_pad_multiple=mult)
        tg = tg.apply_delta(td, edge_pad_multiple=mult, donate=True)
        assert_same_fields(graph_fields(tg), graph_fields(jg))
    assert tg.n_edges_padded % 512 == 0 and tg.edge_pad_multiple == 512


def test_delta_fields_and_refusals():
    jd, td = make_delta(build_jax("ws"), 1, weighted=True)
    assert (td.n_adds, td.n_removes) == (jd.n_adds, jd.n_removes) == (120,
                                                                      80)
    for f in dataclasses.fields(JG.GraphDelta):
        np.testing.assert_array_equal(getattr(td, f.name),
                                      getattr(jd, f.name))
    _, tg = bases("ws", "plain")
    with pytest.raises(TG.EdgeEndpointError, match="out of range") as e:
        tg.apply_delta(TG.GraphDelta(add_senders=[0, 5000],
                                     add_receivers=[4096, 1]))
    assert e.value.pairs == [(0, 4096), (5000, 1)]
    assert e.value.n_nodes == 4096 and isinstance(e.value, ValueError)
    with pytest.raises(ValueError, match="match no live edge"):
        tg.apply_delta(TG.GraphDelta(remove_senders=[0],
                                     remove_receivers=[2048]))
    with pytest.raises(ValueError, match="add_weights"):
        tg.apply_delta(TG.GraphDelta(add_senders=[0], add_receivers=[9],
                                     add_weights=[1.0]))
    with pytest.raises(ValueError, match="need add_weights"):
        tg.with_weights(latency).apply_delta(
            TG.GraphDelta(add_senders=[0], add_receivers=[9]))
    with pytest.raises(ValueError, match="shape mismatch"):
        TG.GraphDelta(add_senders=[0, 1], add_receivers=[2])


# ----------------------------------------------------------------- grow


@pytest.mark.parametrize("n_new", [5, 200], ids=["in-capacity", "repad"])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("family", ["ws", "er", "ba"])
def test_grow_is_byte_equal(family, weighted, n_new):
    jg, tg = bases(family, "all", weighted)
    jn, tn = JG.grow(jg, n_new), tg.grow(n_new)
    assert_same_fields(graph_fields(tn), graph_fields(jn))
    e = jg.n_edges
    w = None if not weighted else np.asarray(jg.edge_weight)[:e]
    fresh = TG.from_edges(np.asarray(jg.senders)[:e],
                          np.asarray(jg.receivers)[:e], jn.n_nodes,
                          node_pad_multiple=jn.n_nodes_padded, weights=w,
                          device="cpu", **ALL)
    if n_new == 200 and not weighted:
        # (with_weights also weights the padding slots, which from_edges
        # leaves 0, so only the unweighted base is a from_edges build.)
        assert_same_fields(graph_fields(tn), graph_fields(fresh))
    # Wire the new nodes with a delta, as the storm does.
    new = np.arange(jg.n_nodes, jn.n_nodes)
    peers = np.random.default_rng(4).integers(0, jg.n_nodes, new.size * 2)
    kw = dict(add_senders=np.repeat(new, 2), add_receivers=peers,
              add_weights=(np.ones(new.size * 2, np.float32) if weighted
                           else None))
    jw = JG.apply_delta(jn, JG.GraphDelta.undirected(**kw))
    tw = tn.apply_delta(TG.GraphDelta.undirected(**kw), donate=True)
    assert_same_fields(graph_fields(tw), graph_fields(jw))


def test_grow_on_a_churned_and_reordered_base():
    jg, tg = bases("ws", churned=True)
    assert_same_fields(graph_fields(tg.grow(300)),
                       graph_fields(JG.grow(jg, 300)))
    jr = build_jax("ba", reorder="rcm", **LAYOUTS)
    tr = build_port("ba", reorder="rcm", **LAYOUTS)
    assert_same_fields(graph_fields(TG.grow(tr, 400)),
                       graph_fields(JG.grow(jr, 400)))
    assert_same_fields(graph_fields(TG.grow(tr, 0, node_capacity=2048)),
                       graph_fields(JG.grow(jr, 0, node_capacity=2048)))


def test_growth_capacity_and_grow_refusals():
    for demand, cur in ((1, 128), (129, 128), (4097, 4096), (10**6, 3),
                        (0, 0)):
        assert TG.growth_capacity(demand, cur) == JG.growth_capacity(
            demand, cur)
    _, tg = bases("er", "plain")
    assert tg.grow(0) is tg
    with pytest.raises(ValueError, match=">= 0"):
        tg.grow(-1)
    with pytest.raises(ValueError, match="below the grown node count"):
        tg.grow(10, node_capacity=tg.n_nodes_padded - 1)


def test_counters_and_build_phases():
    reg = telemetry.Registry()
    prev = telemetry.set_default_registry(reg)
    try:
        jg, tg = bases("ws", "all")
        assert set(TG.last_build_phases()) == set(JG.last_build_phases())
        jd, td = make_delta(jg, 2)
        JG.apply_delta(jg, jd)
        tg.apply_delta(td)
        assert set(TG.last_build_phases()) == set(JG.last_build_phases()) \
            == {"delta_sort_s", "delta_merge_s", "delta_degrees_s",
                "neighbor_table_s", "source_csr_s", "layouts_s"}
        build_port("er").grow(5)  # 505 nodes fit the 512 capacity
        tg.grow(10)
        tg.grow(9000)
        assert TG.last_build_phases().keys() == {"grow_s"}
        assert reg.value("sim_graph_grow_total", repad="false") == 1
        assert reg.value("sim_graph_grow_total", repad="true") == 2
        assert reg.value("sim_graph_build_seconds_total",
                         phase="delta_merge") > 0
        assert reg.value("sim_graph_build_seconds_total",
                         phase="dedup") > 0
        TFa.fail_nodes(tg, [1, 2, 3])
        TFa.mark_unresponsive(tg, np.array([4]))
        TFa.revive_nodes(tg, [1], tg)
        TFa.random_node_failures(tg, prng.key(0), 0.1)
        plain = build_port("ws")
        TFa.fail_edges(plain, torch.tensor([0, 1]))
        TFa.partition(plain, [[0, 1], [2, 3]])
        TFa.random_edge_failures(plain, prng.key(1), 0.1)

        class Run:
            armed = None

            def arm_preemption(self, at):
                self.armed = at

        run = Run()
        assert TFa.preempt(run, 7.0) is run and run.armed == 7
        counts = {s["labels"]["kind"]: s["value"] for s in reg.snapshot()[
            "sim_injected_failures_total"]["samples"]}
        assert counts == {"node": 3, "node_unresponsive": 1,
                          "node_revive": 1, "node_draw": 1, "edge": 2,
                          "partition": 1, "edge_draw": 1, "preempt": 1}
    finally:
        telemetry.set_default_registry(prev)


def test_registry_and_lock_seam():
    from p2pnetwork_tpu import telemetry as JT_
    from p2pnetwork_tpu_torch import concurrency

    assert telemetry.exponential_buckets(1e-4, 2.0, 16) == \
        JT_.exponential_buckets(1e-4, 2.0, 16)
    with pytest.raises(ValueError, match="factor > 1"):
        telemetry.exponential_buckets(1.0, 1.0, 3)

    class Provider:
        locks = 0

        def lock(self):
            Provider.locks += 1
            return concurrency._threading.Lock()

    prev = concurrency.install(Provider())
    try:
        reg = telemetry.Registry()
        c = reg.counter("x_total", "help", ("kind",))
    finally:
        concurrency.install(prev)
    assert Provider.locks == 2  # the registry's and the counter's
    c.labels(kind="a").inc(2)
    c.labels("a").inc()
    assert reg.value("x_total", kind="a") == 3
    assert reg.value("x_total", kind="b") == reg.value("nope") == 0
    assert reg.counter("x_total", "help", ("kind",)) is c
    with pytest.raises(ValueError, match="labels"):
        reg.counter("x_total", "help", ("other",))
    with pytest.raises(ValueError, match="only go up"):
        c.labels("a").inc(-1)
    with pytest.raises(ValueError, match="missing label"):
        c.labels(other="a")
    assert reg.snapshot() == {"x_total": {
        "type": "counter", "help": "help", "labelnames": ["kind"],
        "samples": [{"labels": {"kind": "a"}, "value": 3.0}]}}


# ------------------------------------------------------------- floods

METHODS = ["segment", "gather", "skew", "blocked", "pallas", "hybrid",
           "frontier", "auto"]


@pytest.fixture(scope="module")
def churned_graphs():
    """The WS base after a delta, and after a grow by 64 wired by a
    delta: ``{name: (jax, port)}``."""
    jg, tg = bases("ws", "all")
    jd, td = make_delta(jg, 21, n_rm=200, n_add=200)
    out = {"delta": (JG.apply_delta(jg, jd), TG.apply_delta(tg, td))}
    jn, tn = JG.grow(out["delta"][0], 64), TG.grow(out["delta"][1], 64)
    new = np.arange(4096, 4096 + 64)
    peers = np.random.default_rng(8).integers(0, 4096, 128)
    kw = dict(add_senders=np.repeat(new, 2), add_receivers=peers)
    out["grown"] = (JG.apply_delta(jn, JG.GraphDelta.undirected(**kw)),
                    TG.apply_delta(tn, TG.GraphDelta.undirected(**kw)))
    return out


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("which", ["delta", "grown"])
def test_floods_after_a_delta(churned_graphs, which, method):
    # The reference floods by segment: a flood's dict and state do not
    # depend on the lowering (OR is exact).
    jg, tg = churned_graphs[which]
    jp = JM.AdaptiveFlood(source=0, method="segment")
    js, jout = JE.run_until_coverage(jg, jp, jax.random.key(0),
                                     coverage_target=0.99)
    tp = TM.AdaptiveFlood(source=0, method=method)
    ts, tout = TE.run_until_coverage(tg, tp, prng.key(0),
                                     coverage_target=0.99)
    assert tout == jout
    want, got = state_fields(js), state_fields(ts)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
