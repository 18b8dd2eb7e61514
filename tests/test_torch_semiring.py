"""The port's max and min-plus aggregations and weighted graphs against the
JAX package's, on the CPU.

Everything here is held bit for bit: a max or a min picks one of its
terms, and each min-plus term is the same f32 add in both packages, so no
tolerance is needed. Floats are compared by their bits with every NaN
made one NaN (the port keeps where a NaN lands, not its payload), so
``-0.0`` against ``+0.0`` counts as a difference.

- ``Graph.with_weights`` (callable and array), ``from_edges(weights=)``
  with a capped table and a skew table, ``consolidate`` and ``interop``
  carrying the weights: field for field, byte-equal.
- ``propagate_max`` (i32 and f32) and ``propagate_min_plus`` (weighted and
  not) through ``segment``, ``gather``, ``skew``, ``frontier`` (sparse and
  dense rounds) and ``auto`` on WS, ER and BA graphs, healthy and churned
  (a dynamic region of runtime links, failed nodes, cut edges).
- NaN, ``±inf``, ``-0.0`` and rows with no live in-edge; the refusals.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from p2pnetwork_tpu.ops import segment as JS  # noqa: E402
from p2pnetwork_tpu.ops import skew as JSK  # noqa: E402
from p2pnetwork_tpu.sim import failures as JFa  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu.sim import topology as JT  # noqa: E402
from p2pnetwork_tpu_torch import interop  # noqa: E402
from p2pnetwork_tpu_torch.ops import frontier as TFR  # noqa: E402
from p2pnetwork_tpu_torch.ops import segment as TS  # noqa: E402
from p2pnetwork_tpu_torch.ops import skew as TSK  # noqa: E402
from p2pnetwork_tpu_torch.sim import failures as TFa  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402
from p2pnetwork_tpu_torch.sim import topology as TT  # noqa: E402
from tests.test_torch_graph import (FAMILIES, LAYOUTS,  # noqa: E402
                                    assert_same_fields, build_jax,
                                    build_port, graph_fields)

#: The layouts the max and min-plus methods read (edge cuts are refused on
#: the blocked and hybrid layouts, which these methods never read).
ALL = dict(source_csr=True, skew_table=True)
METHODS = ["segment", "gather", "skew", "frontier", "auto"]
#: The lowerings ``auto`` resolves to (its routing and fall-backs have
#: their own tests below).
LOWERINGS = METHODS[:-1]


def latency(s, r):
    """The ladder's id-hash link latency (``benchmarks/ladder.py``
    ``bench_routing``), on numpy (the port) or JAX arrays."""
    h = s.astype(np.uint32) * np.uint32(2654435761) + r.astype(np.uint32)
    return 1.0 + (h % 2048).astype(np.float32) / 1024.0


def bits(x) -> np.ndarray:
    """A float array's bits with every NaN made the same NaN; other
    arrays as they are."""
    a = np.array(x.numpy() if isinstance(x, torch.Tensor) else x)
    if a.dtype.kind != "f":
        return a
    a[np.isnan(a)] = np.nan
    return a.view(np.int32 if a.itemsize == 4 else np.int64)


def assert_bits_equal(got, want):
    g, w = bits(got), bits(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


def churn(mods, g):
    """Runtime links into a dynamic region, a failed node band and cut
    edges — the same ids in both packages."""
    topo, fail = mods
    n = g.n_nodes
    rng = np.random.default_rng(3)
    g = topo.with_capacity(g, extra_edges=128)
    g = topo.connect(g, rng.integers(0, n, 30).astype(np.int32),
                     rng.integers(0, n, 30).astype(np.int32))
    g = fail.fail_nodes(g, np.arange(n // 8, n // 6))
    return fail.fail_edges(g, rng.choice(g.n_edges, g.n_edges // 50,
                                         replace=False))


_GRAPHS = {}


def graphs(family, weighted=False, churned=False):
    """``(jax graph, port graph)``: every layout, the ladder's latency as
    weights when ``weighted``, :func:`churn` when ``churned``."""
    key = (family, weighted, churned)
    if key not in _GRAPHS:
        jg, tg = build_jax(family, **ALL), build_port(family, **ALL)
        if weighted:
            jg, tg = jg.with_weights(latency), tg.with_weights(latency)
        if churned:
            jg, tg = churn((JT, JFa), jg), churn((TT, TFa), tg)
        _GRAPHS[key] = jg, tg
    return _GRAPHS[key]


def signal(n, dtype, active, seed):
    """A node signal: ``active`` random values (int or f32), the rest the
    identity of the aggregation it feeds (int min / -inf for max, +inf
    for min-plus distances)."""
    rng = np.random.default_rng(seed)
    on = np.zeros(n, dtype=bool)
    on[rng.choice(n, active, replace=False)] = True
    if dtype == "i32":
        vals = rng.integers(-10**6, 10**6, n).astype(np.int32)
        return np.where(on, vals, np.iinfo(np.int32).min).astype(np.int32)
    if dtype == "f32":
        return np.where(on, rng.standard_normal(n), -np.inf).astype(
            np.float32)
    return np.where(on, rng.random(n) * 10, np.inf).astype(np.float32)


def both(jfn, tfn, jg, tg, x, method, **kw):
    want = jfn(jg, jnp.asarray(x), method, **kw)
    got = tfn(tg, torch.from_numpy(x), method, **kw)
    assert_bits_equal(got, want)
    return got


# ------------------------------------------------------------ weights


@pytest.mark.parametrize("form", ["callable", "array"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_with_weights_is_byte_equal(family, form):
    kw = dict(LAYOUTS, skew_table=True)
    jg, tg = build_jax(family, **kw), build_port(family, **kw)
    if form == "callable":
        jw, tw = jg.with_weights(latency), tg.with_weights(latency)
    else:
        w = np.random.default_rng(1).random(jg.n_edges_padded).astype(
            np.float32)
        jw, tw = jg.with_weights(w), tg.with_weights(torch.from_numpy(w))
    got, want = graph_fields(tw), graph_fields(jw)
    assert want["edge_weight"] is not None
    assert want["neighbor_weight"] is not None
    assert want["skew"]["weight"] is not None
    assert_same_fields(got, want)


def test_with_weights_after_failures_is_byte_equal():
    # Failures before the weights: the skew view is masked by the
    # re-masked table, the neighbor view keeps the build-time slots.
    ids = np.arange(40, 90)
    jg = JFa.fail_nodes(build_jax("ba", **ALL), ids).with_weights(latency)
    tg = TFa.fail_nodes(build_port("ba", **ALL), ids).with_weights(latency)
    assert_same_fields(graph_fields(tg), graph_fields(jg))


def _weighted_edges(n, m, seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, m).astype(np.int32)
    r = rng.integers(0, n, m).astype(np.int32)
    r[: m // 10] = 7  # a hub, so a capped table drops some of its edges
    return s, r, rng.random(m).astype(np.float32) * 5


@pytest.mark.parametrize("max_degree", [None, 4])
def test_from_edges_weights_is_byte_equal(max_degree):
    s, r, w = _weighted_edges(300, 2000, 2)
    kw = dict(weights=w, max_degree=max_degree, skew_table=True,
              source_csr=True, blocked=True, hybrid=True)
    jg = JG.from_edges(s, r, 300, **kw)
    tg = TG.from_edges(s, r, 300, device="cpu", **kw)
    assert tg.neighbors_complete is (max_degree is None)
    assert_same_fields(graph_fields(tg), graph_fields(jg))
    # The late skew table of a weighted graph carries the weights too.
    assert_same_fields(graph_fields(tg.with_skew_table(16)),
                       graph_fields(jg.with_skew_table(16)))


def test_with_weights_refusals():
    s, r, w = _weighted_edges(300, 2000, 2)
    tg = TG.from_edges(s, r, 300, max_degree=4, device="cpu")
    with pytest.raises(ValueError, match="width-capped"):
        tg.with_weights(np.ones(tg.n_edges_padded, np.float32))
    with pytest.raises(ValueError, match="align"):
        build_port("er").with_weights(np.ones(3, np.float32))
    with pytest.raises(ValueError, match="align"):
        TG.from_edges(s, r, 300, weights=w[:-1], device="cpu")


def test_consolidate_carries_weights():
    # Runtime links enter the rebuilt graph at DYNAMIC_LINK_COST.
    jg, tg = graphs("er", weighted=True, churned=True)
    assert JS.DYNAMIC_LINK_COST == TS.DYNAMIC_LINK_COST == 1.0
    got, want = TT.consolidate(tg), JT.consolidate(jg)
    assert want.edge_weight is not None
    assert_same_fields(graph_fields(got), graph_fields(want))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_interop_carries_weights(family):
    jg, tg = graphs(family, weighted=True, churned=True)
    carried = interop.graph_from_numpy(graph_fields(jg), device="cpu")
    assert_same_fields(graph_fields(carried), graph_fields(jg))
    assert_same_fields(graph_fields(carried), graph_fields(tg))


# ------------------------------------------------- max and min-plus


def _activity(n, method):
    """(active senders, seed) of the signals a method is given: half the
    nodes, and for ``frontier`` also 5 (its sparse round)."""
    return ((5, 0), (n // 2, 1)) if method == "frontier" else ((n // 2, 1),)


@pytest.mark.parametrize("churned", [False, True], ids=["healthy", "churn"])
@pytest.mark.parametrize("dtype", ["i32", "f32"])
@pytest.mark.parametrize("method", LOWERINGS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_propagate_max_equals_reference(family, method, dtype, churned):
    jg, tg = graphs(family, churned=churned)
    for active, seed in _activity(jg.n_nodes_padded, method):
        x = signal(jg.n_nodes_padded, dtype, active, seed)
        both(JS.propagate_max, TS.propagate_max, jg, tg, x, method)


@pytest.mark.parametrize("churned", [False, True], ids=["healthy", "churn"])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unit", "weighted"])
@pytest.mark.parametrize("method", LOWERINGS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_propagate_min_plus_equals_reference(family, method, weighted,
                                             churned):
    jg, tg = graphs(family, weighted=weighted, churned=churned)
    for active, seed in _activity(jg.n_nodes_padded, method):
        x = signal(jg.n_nodes_padded, "dist", active, seed)
        both(JS.propagate_min_plus, TS.propagate_min_plus, jg, tg, x, method)


@pytest.mark.parametrize("op", ["max", "min_plus"])
def test_frontier_takes_both_branches(op):
    # The budget holds 5 active senders and not half the graph; each
    # branch equals the dense method exactly.
    jg, tg = graphs("ws", weighted=True)
    n = jg.n_nodes_padded
    fn = TS.propagate_max if op == "max" else TS.propagate_min_plus
    jfn = JS.propagate_max if op == "max" else JS.propagate_min_plus
    TFR.ROUNDS.update(sparse=0, dense=0)
    for active, seed in ((5, 0), (n // 2, 1)):
        x = signal(n, "f32" if op == "max" else "dist", active, seed)
        got = both(jfn, fn, jg, tg, x, "frontier")
        assert_bits_equal(got, fn(tg, torch.from_numpy(x), "segment"))
    assert TFR.ROUNDS == {"sparse": 1, "dense": 1}


def test_methods_agree_on_dist_bits():
    # The routing contract: every lowering makes the same f32 adds, so the
    # relaxed costs have the same bits under each.
    jg, tg = graphs("ba", weighted=True)
    x = torch.from_numpy(signal(jg.n_nodes_padded, "dist", 40, 5))
    ref = TS.propagate_min_plus(tg, x, "segment")
    for method in METHODS[1:]:
        assert_bits_equal(TS.propagate_min_plus(tg, x, method), ref)


def _special(n, seed):
    """NaN, ±inf, ±0.0 and ordinary values at random nodes."""
    rng = np.random.default_rng(seed)
    vals = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, -2.0],
                    np.float32)
    return vals[rng.integers(0, vals.size, n)]


@pytest.mark.parametrize("method", METHODS)
def test_nonfinite_and_signed_zeros_spread_as_the_reference(method):
    # XLA's max and min let NaN win and order -0.0 below +0.0 whatever
    # the order of the terms; a NaN sender stays active in the frontier
    # method's sparse round (`!=` the identity).
    jg, tg = graphs("er", weighted=True, churned=True)
    n = jg.n_nodes_padded
    x = _special(n, 0)
    both(JS.propagate_max, TS.propagate_max, jg, tg, x, method)
    both(JS.propagate_min_plus, TS.propagate_min_plus, jg, tg, x, method)
    # Sparse: only a few non-identity senders, NaN among them.
    for ident, fns in ((-np.inf, (JS.propagate_max, TS.propagate_max)),
                       (np.inf, (JS.propagate_min_plus,
                                 TS.propagate_min_plus))):
        y = np.full(n, ident, np.float32)
        y[[3, 10, 50, 51]] = [np.nan, -0.0, 0.0, -ident]
        both(*fns, jg, tg, y, method)


def test_empty_rows_and_dead_nodes_get_the_identity():
    jg, tg = graphs("ba", churned=True)
    n = jg.n_nodes_padded
    x = signal(n, "i32", n, 0)
    got = both(JS.propagate_max, TS.propagate_max, jg, tg, x, "segment")
    dead = ~tg.node_mask
    assert dead.any() and (got[dead] == np.iinfo(np.int32).min).all()
    y = signal(n, "dist", n, 0)
    got = both(JS.propagate_min_plus, TS.propagate_min_plus, jg, tg, y,
               "gather")
    assert torch.isinf(got[dead]).all()


def test_skew_lowerings_equal_reference():
    jg, tg = graphs("ba", weighted=True)
    n = jg.n_nodes_padded
    x = signal(n, "i32", n // 3, 2)
    assert_bits_equal(TSK.max_skew(tg.skew, torch.from_numpy(x), n),
                      JSK.max_skew(jg.skew, jnp.asarray(x), n,
                                   JS.neutral_min(jnp.int32)))
    d = signal(n, "dist", n // 3, 2)
    assert_bits_equal(TSK.min_plus_skew(tg.skew, torch.from_numpy(d), n),
                      JSK.min_plus_skew(jg.skew, jnp.asarray(d), n))


def test_neutral_min_matches():
    for jd, td in ((jnp.int32, torch.int32), (jnp.float32, torch.float32),
                   (jnp.int16, torch.int16)):
        assert TS.neutral_min(td) == JS.neutral_min(jd).item()
    with pytest.raises(ValueError, match="propagate_or"):
        TS.neutral_min(torch.bool)


@pytest.mark.parametrize("method", ["blocked", "pallas", "hybrid",
                                    "hybrid-blocked", "bogus"])
@pytest.mark.parametrize("op", ["max", "min"])
def test_one_hot_methods_are_refused(op, method):
    jg, tg = graphs("ws")
    n = jg.n_nodes_padded
    fn = TS.propagate_max if op == "max" else TS.propagate_min_plus
    jfn = JS.propagate_max if op == "max" else JS.propagate_min_plus
    x = np.zeros(n, np.float32)
    with pytest.raises(ValueError, match=f"{op} does not ride") as want:
        jfn(jg, jnp.asarray(x), method)
    with pytest.raises(ValueError) as got:
        fn(tg, torch.from_numpy(x), method)
    assert str(got.value) == str(want.value)


def test_weighted_gather_and_skew_need_their_views():
    jg, tg = graphs("ba", weighted=True)
    n = jg.n_nodes_padded
    d = signal(n, "dist", n // 2, 4)
    bare = {"neighbor_weight": None,
            "skew": dataclasses.replace(tg.skew, weight=None)}
    tb = dataclasses.replace(tg, **bare)
    jb = dataclasses.replace(jg, neighbor_weight=None,
                             skew=dataclasses.replace(jg.skew, weight=None))
    for method, match in (("gather", "neighbor_weight"), ("skew", "weight")):
        with pytest.raises(ValueError, match=match):
            TS.propagate_min_plus(tb, torch.from_numpy(d), method)
    # auto falls back to segment (BA routes to skew, whose view is gone).
    assert TS._auto_method(tb) == "skew"
    got = both(JS.propagate_min_plus, TS.propagate_min_plus, jb, tb, d,
               "auto")
    assert_bits_equal(got, TS.propagate_min_plus(tg, torch.from_numpy(d),
                                                 "segment"))
    # ... and on a table graph without its aligned view.
    jw, tw = graphs("ws", weighted=True)
    tw = dataclasses.replace(tw, neighbor_weight=None)
    jw = dataclasses.replace(jw, neighbor_weight=None)
    assert TS._auto_method(tw) == "gather"
    both(JS.propagate_min_plus, TS.propagate_min_plus, jw, tw,
         signal(jw.n_nodes_padded, "dist", 100, 4), "auto")
