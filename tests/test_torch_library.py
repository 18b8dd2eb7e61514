"""The port's protocol library against the JAX package's, on the CPU:
Bracha, HITS, closeness and betweenness, label propagation, the
bipartiteness check, Borůvka and the triangle counts.

Each runs through the entry point a user calls, in both packages on the
same graph, through every method the reference accepts for its
aggregation (the sums by every ``propagate_sum`` lowering, ``pallas`` and
``hybrid`` through B1's plain version here). Counts, bools and ints —
Bracha's states and stats, labels, ``comp``, ``mst_edge``, triangle
counts, rounds and ``messages`` — are equal exactly. Float results hold
to the tolerance each test states: HITS's scores and betweenness are f32
sums whose terms add in another order than XLA's; closeness adds the same
terms in the same order and is held by its bits; Borůvka's
``mst_weight`` is an f32 sum of committed weights.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from p2pnetwork_tpu import models as JM  # noqa: E402
from p2pnetwork_tpu.models import centrality as JC  # noqa: E402
from p2pnetwork_tpu.models import labelprop as JLP  # noqa: E402
from p2pnetwork_tpu.models import triangles as JTR  # noqa: E402
from p2pnetwork_tpu.ops import segment as JS  # noqa: E402
from p2pnetwork_tpu.sim import engine as JE  # noqa: E402
from p2pnetwork_tpu.sim import failures as JFa  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu_torch import interop, prng  # noqa: E402
from p2pnetwork_tpu_torch import models as TM  # noqa: E402
from p2pnetwork_tpu_torch.models import centrality as TC  # noqa: E402
from p2pnetwork_tpu_torch.models import labelprop as TLP  # noqa: E402
from p2pnetwork_tpu_torch.models import triangles as TTR  # noqa: E402
from p2pnetwork_tpu_torch.ops import segment as TS  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine as TE  # noqa: E402
from p2pnetwork_tpu_torch.sim import failures as TFa  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402
from tests.test_torch_analytics import (MAX_METHODS, SUM_METHODS,  # noqa: E402
                                        assert_state_equal, converged,
                                        graphs, stacked)
from tests.test_torch_graph import (one_torch_thread,  # noqa: E402,F401
                                    state_fields)
from tests.test_torch_semiring import bits  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

#: HITS's scores: f32 power iterations whose sums add in another order.
HITS_RTOL, HITS_ATOL = 1e-4, 1e-6
#: Betweenness: f32 sums of path-count ratios, added in another order.
BC_RTOL, BC_ATOL = 1e-5, 1e-6
#: Borůvka's total weight: an f32 sum over ~N committed edges.
MST_RTOL = 1e-6


def _failed(mods, g):
    """A failed node band (no dynamic region: the triangle counters and
    Borůvka read the static edges)."""
    return mods.fail_nodes(g, np.arange(g.n_nodes // 5, g.n_nodes // 4))


# ---------------------------------------------------------------- Bracha


@pytest.mark.parametrize("method", SUM_METHODS)
def test_bracha_equals_reference(method):
    # Run to quiescence: on the churned graph both packages go quiet at
    # round 58, after 40,012 messages.
    jg, tg = graphs(churned=True)
    kw = dict(source=0, f=1, byzantine=(1, 2), method=method)
    ts, out = converged(jg, tg, JM.Bracha(**kw), TM.Bracha(**kw), "changed")
    assert (out["rounds"], out["messages"]) == (58, 40012)
    assert ts.ready_sent.any()


@pytest.mark.parametrize("n,f,byz", [(7, 2, (3, 5)), (7, 2, (0, 3)),
                                     (10, 3, (0, 2, 4))])
def test_bracha_on_the_complete_graph_keeps_its_guarantees(n, f, byz):
    # The reference's cases: an honest broadcaster's value is delivered
    # by every honest node; an equivocating one never splits them.
    jg = JG.complete(n, hybrid=True, blocked=True)
    tg = TG.complete(n, hybrid=True, blocked=True, device="cpu")
    kw = dict(source=0, f=f, byzantine=byz, method="hybrid")
    ts, _ = stacked(jg, tg, JM.Bracha(**kw), TM.Bracha(**kw), 6)
    honest = np.setdiff1d(np.arange(n), byz)
    vals = ts.value.numpy()[honest]
    if 0 not in byz:
        assert (vals == 1).all()
    assert len(np.unique(vals[vals >= 0])) <= 1


# ------------------------------------------------- exact f32 row sums


@pytest.mark.parametrize("churned", [False, True],
                         ids=["healthy", "churned"])
@pytest.mark.parametrize("method", [m for m in SUM_METHODS
                                    if m != "pallas"])
def test_propagate_sum_is_exact(method, churned):
    # gather and skew add each row's columns left to right, as XLA's CPU
    # row reduce does; segment, blocked and hybrid already matched.
    # pallas is not pinned: the reference's Pallas kernel (interpret mode
    # here) adds its one-hot product in its own order (ROADMAP.md §C).
    jg, tg = graphs(churned=churned)
    x = np.random.default_rng(0).random(jg.n_nodes_padded).astype(
        np.float32)
    want = JS.propagate_sum(jg, jnp.asarray(x), method=method)
    got = TS.propagate_sum(tg, torch.from_numpy(x), method=method)
    np.testing.assert_array_equal(bits(got.numpy()), bits(np.asarray(want)))


@pytest.mark.parametrize("method", ["gather", "skew"])
def test_pagerank_pull_step_is_exact(method):
    # The pull of one step from the reference's state after 3 rounds,
    # carried across: each package's rank shares, summed by ``method``.
    # (The rank update after it is one f32 expression that XLA contracts
    # into fused multiply-adds; it is not pinned here.)
    jg, tg = graphs(churned=True)
    js, _ = JE.run(jg, JM.PageRank(method=method), jax.random.key(0), 3)
    ts = interop.protocol_state_from_numpy("PageRankState",
                                           state_fields(js), device="cpu")
    jlive = jg.node_mask & (jg.out_degree > 0)
    jshare = jnp.where(jlive, js.ranks / jnp.maximum(
        jg.out_degree.astype(jnp.float32), 1.0), 0.0)
    tlive = tg.node_mask & (tg.out_degree > 0)
    tshare = torch.where(tlive, ts.ranks / tg.out_degree.to(
        torch.float32).clamp_min(1.0), 0.0)
    np.testing.assert_array_equal(bits(tshare.numpy()),
                                  bits(np.asarray(jshare)))
    want = JS.propagate_sum(jg, jshare, method=method)
    got = TS.propagate_sum(tg, tshare, method=method)
    np.testing.assert_array_equal(bits(got.numpy()), bits(np.asarray(want)))


# ------------------------------------------------------------------ HITS


def _hits_threshold(jg, method):
    """A residual threshold midway (in log scale) between two of the
    reference's consecutive residuals, so sums in another order cannot
    move the stopping round."""
    r = np.asarray(JE.run(jg, JM.HITS(method=method), jax.random.key(0),
                          12)[1]["residual"], np.float64)
    return float(np.sqrt(r[8] * r[9]))


@pytest.mark.parametrize("method", SUM_METHODS)
def test_hits_equals_reference(method):
    jg, tg = graphs(churned=True)
    thr = _hits_threshold(jg, method)
    js, jout = JE.run_until_converged(jg, JM.HITS(method=method),
                                      jax.random.key(0), stat="residual",
                                      threshold=thr)
    ts, tout = TE.run_until_converged(tg, TM.HITS(method=method),
                                      prng.key(0), stat="residual",
                                      threshold=thr)
    assert (tout["rounds"], tout["messages"]) == (jout["rounds"],
                                                  jout["messages"])
    np.testing.assert_allclose(tout["value"], jout["value"], rtol=1e-3)
    for f in ("hub", "authority"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)),
                                   rtol=HITS_RTOL, atol=HITS_ATOL,
                                   err_msg=f)


def test_hits_out_sum_without_the_csr_view():
    import dataclasses
    jg, tg = graphs(churned=True)
    jb = dataclasses.replace(jg, src_eid=None, src_offsets=None)
    tb = dataclasses.replace(tg, src_eid=None, src_offsets=None)
    x = np.random.default_rng(0).random(jg.n_nodes_padded).astype(np.float32)
    want = JM.HITS()._out_sum(jb, jnp.asarray(x))
    for g in (tb, tg):
        np.testing.assert_allclose(TM.HITS()._out_sum(g, torch.from_numpy(
            x)).numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ centrality


_SOURCES = np.array([0, 3, 77, 1000, 900, 4000], np.int32)  # 900: dead


@pytest.mark.parametrize("method", ["segment", "hybrid", "pallas",
                                    "frontier"])
def test_closeness_equals_reference(method):
    jg, tg = graphs(churned=True)
    for kw in (dict(), dict(normalized=True), dict(harmonic=False)):
        want = JC.closeness_sample(jg, jnp.asarray(_SOURCES), method, **kw)
        got = TC.closeness_sample(tg, torch.from_numpy(_SOURCES), method,
                                  **kw)
        np.testing.assert_array_equal(bits(got), bits(np.asarray(want)))


@pytest.mark.parametrize("method", SUM_METHODS)
def test_betweenness_equals_reference(method):
    jg, tg = graphs(churned=True)
    # The rescale is one product of the same sums: checked under hybrid.
    for normalized in (False, True) if method == "hybrid" else (False,):
        want = JC.betweenness_sample(jg, jnp.asarray(_SOURCES), method,
                                     normalized=normalized)
        got = TC.betweenness_sample(tg, _SOURCES, method,
                                    normalized=normalized)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=BC_RTOL, atol=BC_ATOL)
        assert (got[tg.node_mask] > 0).any()


def test_centrality_refusal():
    _, tg = graphs()
    with pytest.raises(ValueError, match="harmonic"):
        TC.closeness_sample(tg, [0], harmonic=False, normalized=True)


# ----------------------------------------------------- label propagation


def test_row_mode_ties_go_to_the_smallest_value():
    S = TLP._SENTINEL
    rows = np.array([[1, 1, 2, 2, S], [3, 5, 5, 7, 7], [4, 4, 4, 9, 9],
                     [S, S, S, S, S], [0, 2, 6, 8, 9], [-1, -1, 5, 5, S]],
                    np.int32)
    want = jax.vmap(JLP._row_mode)(jnp.asarray(rows))
    got = TLP._row_mode(torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [1, 5, 4, S, 0, -1])


@pytest.mark.parametrize("family", ["ws", "ba"])
def test_label_propagation_equals_reference(family):
    jg, tg = graphs(family, churned=True)
    ts, out = converged(jg, tg, JM.LabelPropagation(),
                        TM.LabelPropagation(), "unsettled")
    assert out["rounds"] > 2
    stacked(jg, tg, JM.LabelPropagation(), TM.LabelPropagation(), 5)


# ------------------------------------------------------------ bipartite


def _even_ring(mod, **kw):
    s = np.arange(500, dtype=np.int32)
    r = (s + 1) % 500
    return mod.from_edges(np.r_[s, r], np.r_[r, s], 500, source_csr=True,
                          skew_table=True, **kw)


@pytest.mark.parametrize("method", MAX_METHODS)
def test_bipartite_check_equals_reference(method):
    for jg, tg in (graphs(churned=True), graphs("ba"),
                   (_even_ring(JG), _even_ring(TG, device="cpu"))):
        jp, tp = JM.BipartiteCheck(method=method), \
            TM.BipartiteCheck(method=method)
        js, _ = JE.run_until_converged(jg, jp, jax.random.key(0),
                                       stat="changed", threshold=1)
        ts, _ = converged(jg, tg, jp, tp, "changed")
        assert tp.odd_edges(tg, ts).item() == int(jp.odd_edges(jg, js))
        np.testing.assert_array_equal(
            tp.component_bipartite(tg, ts).numpy(),
            np.asarray(jp.component_bipartite(jg, js)))
    assert tp.odd_edges(tg, ts).item() == 0  # the even ring


# --------------------------------------------------------------- Borůvka


def _sym_weight(s, r):
    """A symmetric link cost: a hash of the sorted endpoints."""
    lo, hi = np.minimum(s, r).astype(np.uint32), np.maximum(s, r)
    h = lo * np.uint32(2654435761) + hi.astype(np.uint32)
    return 1.0 + (h % 64).astype(np.float32) / 8.0


def _special_weight(s, r):
    """Symmetric costs with ties, ``-0.0`` against ``+0.0`` and NaN."""
    w = _sym_weight(s, r)
    lo = np.minimum(s, r)
    w = np.where(lo % 5 == 0, np.float32(0.0), w)
    w = np.where(lo % 10 == 0, np.float32(-0.0), w)
    return np.where(lo % 97 == 3, np.float32(np.nan), w).astype(np.float32)


def _boruvka(jg, tg):
    # Asymmetric weights never quiesce (ROADMAP §C): 16 phases bound them.
    js, jout = JE.run_until_converged(jg, JM.Boruvka(), jax.random.key(0),
                                      stat="changed", threshold=1,
                                      max_rounds=16)
    ts, tout = TE.run_until_converged(tg, TM.Boruvka(), prng.key(0),
                                      stat="changed", threshold=1,
                                      max_rounds=16)
    assert (tout["rounds"], tout["messages"]) == (jout["rounds"],
                                                  jout["messages"])
    for f in ("comp", "mst_edge", "round"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    np.testing.assert_allclose(ts.mst_weight.item(), float(js.mst_weight),
                               rtol=MST_RTOL)
    return ts, tout


@pytest.mark.parametrize("weights", ["unit", "symmetric", "latency",
                                     "special"])
@pytest.mark.parametrize("family", ["ws", "ba", "er"])
def test_boruvka_equals_reference(family, weights):
    from tests.test_torch_semiring import latency

    jg, tg = graphs(family)
    jg, tg = _failed(JFa, jg), _failed(TFa, tg)
    fn = {"symmetric": _sym_weight, "latency": latency,
          "special": _special_weight}.get(weights)
    if fn is not None:
        jg, tg = jg.with_weights(fn), tg.with_weights(fn)
    ts, out = _boruvka(jg, tg)
    assert out["rounds"] >= 2
    if weights in ("unit", "symmetric"):
        # The forest invariant: one committed slot per merge.
        comps = TM.Boruvka().components(tg, ts).item()
        assert ts.mst_edge.sum().item() == tg.node_mask.sum().item() - comps


# ------------------------------------------------------------- triangles


@pytest.mark.parametrize("failed", [False, True], ids=["healthy", "failed"])
@pytest.mark.parametrize("family", ["ws", "ba", "er"])
def test_triangle_counts_equal_reference(family, failed):
    jg, tg = graphs(family)
    if failed:
        jg, tg = _failed(JFa, jg), _failed(TFa, tg)
    # A 7-edge block on the narrow WS table splits the edges unevenly.
    for block in (None, 7) if family == "ws" else (None,):
        assert (TTR.count_triangles(tg, edge_block=block)
                == JTR.count_triangles(jg, edge_block=block))
    np.testing.assert_array_equal(TTR.triangles_per_node(tg).numpy(),
                                  np.asarray(JTR.triangles_per_node(jg)))
    np.testing.assert_array_equal(bits(TTR.local_clustering(tg)),
                                  bits(np.asarray(JTR.local_clustering(jg))))
    assert TTR.transitivity(tg) == JTR.transitivity(jg)
    for seed, samples in ((0, 4096), (5, 999)):
        assert (TTR.transitivity_sample(tg, prng.key(seed), samples)
                == JTR.transitivity_sample(jg, jax.random.key(seed),
                                           samples))


def test_triangles_refuse_a_dynamic_region():
    _, tg = graphs(churned=True)
    with pytest.raises(ValueError, match="dynamic"):
        TTR.count_triangles(tg)
    with pytest.raises(ValueError, match="dynamic"):
        TTR.transitivity_sample(tg, prng.key(0))


# --------------------------------------------------------------- interop


#: (protocol, stat) for the states carried across.
CARRY = {
    "BrachaState": (lambda M: M.Bracha(f=1, byzantine=(1, 2)), "changed"),
    "HITSState": (lambda M: M.HITS(), "residual"),
    "LabelPropagationState": (lambda M: M.LabelPropagation(), "unsettled"),
    "BipartiteCheckState": (lambda M: M.BipartiteCheck(), "changed"),
    "BoruvkaState": (lambda M: M.Boruvka(), "changed"),
}


@pytest.mark.parametrize("name", sorted(CARRY))
def test_states_carry_across_and_resume(name):
    make, stat = CARRY[name]
    jg, tg = graphs()
    jg, tg = _failed(JFa, jg), _failed(TFa, tg)
    jproto, tproto = make(JM), make(TM)
    js, _ = JE.run(jg, jproto, jax.random.key(1), 3)
    assert type(js).__name__ == name
    ts = interop.protocol_state_from_numpy(name, state_fields(js),
                                           device="cpu")
    assert_state_equal(ts, js)
    thr = 1e-3 if stat == "residual" else 1
    js2, jout = JE.run_until_converged(jg, jproto, jax.random.key(5),
                                       stat=stat, threshold=thr, state0=js,
                                       max_rounds=16, donate=False)
    ts2, tout = TE.run_until_converged(tg, tproto, prng.key(5), stat=stat,
                                       threshold=thr, state0=ts,
                                       max_rounds=16)
    assert tout["rounds"] == jout["rounds"]
    if name == "HITSState":
        np.testing.assert_allclose(ts2.hub.numpy(), np.asarray(js2.hub),
                                   rtol=HITS_RTOL, atol=HITS_ATOL)
    elif name == "BoruvkaState":
        np.testing.assert_array_equal(ts2.comp.numpy(), np.asarray(js2.comp))
    else:
        assert tout == jout
        assert_state_equal(ts2, js2)
