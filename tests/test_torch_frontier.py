"""The port's frontier-compacted OR (``ops/frontier.py``) and the packed
flood states against the JAX package.

Everything here is bool or integer, or an f32 ratio of integers, so it
must be bit-equal: budgets, both branches of ``propagate_or_frontier``,
and the run-to-coverage dicts and final states of
``Flood(method="frontier")`` and of ``Flood``/``AdaptiveFlood`` with
``bitset=True`` (packed words compared as ``uint32``). Graphs are the
families of ``test_torch_graph.py``, built with the source-CSR view."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from p2pnetwork_tpu.models import adaptive_flood as JA  # noqa: E402
from p2pnetwork_tpu.models import flood as JF  # noqa: E402
from p2pnetwork_tpu.ops import frontier as JFR  # noqa: E402
from p2pnetwork_tpu.ops import segment as JS  # noqa: E402
from p2pnetwork_tpu.sim import engine as JE  # noqa: E402
from p2pnetwork_tpu_torch import _device, interop, prng  # noqa: E402
from p2pnetwork_tpu_torch.models import adaptive_flood as TA  # noqa: E402
from p2pnetwork_tpu_torch.models import flood as TF  # noqa: E402
from p2pnetwork_tpu_torch.ops import frontier as TFR  # noqa: E402
from p2pnetwork_tpu_torch.ops import segment as TS  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine as TE  # noqa: E402
from tests.test_torch_graph import (FAMILIES, LAYOUTS, build_jax,  # noqa: E402
                                    build_port, state_fields)

TARGET = 0.99
MAX_ROUNDS = 64


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def graphs(request):
    return build_jax(request.param, **LAYOUTS), build_port(request.param,
                                                          **LAYOUTS)


def assert_same_state(got, want):
    """Two flood states field by field; packed words as ``uint32``."""
    got, want = state_fields(got), state_fields(want)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].view(np.uint32) if w.dtype == np.uint32 else got[k]
        np.testing.assert_array_equal(g, w, err_msg=k)


def run_both(jg, tg, jproto, tproto):
    js, jout = JE.run_until_coverage(jg, jproto, jax.random.key(0),
                                     coverage_target=TARGET,
                                     max_rounds=MAX_ROUNDS)
    ts, tout = TE.run_until_coverage(tg, tproto, prng.key(0),
                                     coverage_target=TARGET,
                                     max_rounds=MAX_ROUNDS)
    assert tout == jout
    assert_same_state(ts, js)
    return tout


@pytest.mark.parametrize("crossover", [None, 0.25, 200, 10**9])
def test_budget_matches(graphs, crossover):
    jg, tg = graphs
    assert TFR.budget(tg, crossover) == JFR.budget(jg, crossover)
    assert TFR.budget_slots(tg, crossover) == JFR.budget_slots(jg, crossover)


def test_budget_disables_sparse_on_a_hub_graph():
    # BA's widest out-row spans so much of E_pad that even the floor
    # budget breaks the slot bound: k == 0, every round dense.
    jg, tg = build_jax("ba", source_csr=True), build_port("ba",
                                                          source_csr=True)
    assert TFR.budget(tg) == JFR.budget(jg) == 0
    assert TFR.budget_slots(tg) == 0
    assert TFR.budget(tg, 0.5) == JFR.budget(jg, 0.5) > 0
    with pytest.raises(ValueError):
        TFR.budget(tg, 1.5)


@pytest.mark.parametrize("n_active,branch", [(40, "sparse"),
                                             (3000, "dense")])
def test_propagate_or_frontier_both_branches(n_active, branch):
    jg, tg = build_jax("ws", **LAYOUTS), build_port("ws", **LAYOUTS)
    rng = np.random.default_rng(n_active)
    sig = np.zeros(jg.n_nodes_padded, dtype=bool)
    sig[rng.choice(jg.n_nodes, n_active, replace=False)] = True
    want = np.asarray(JFR.propagate_or_frontier(
        jg, jnp.asarray(sig), lambda s: JS.propagate_or(jg, s, "auto")))
    before, syncs = dict(TFR.ROUNDS), _device.SYNCS
    got = TS.propagate_or(tg, torch.from_numpy(sig), "frontier")
    np.testing.assert_array_equal(got.numpy(), want)
    assert TFR.ROUNDS[branch] == before[branch] + 1
    assert _device.SYNCS == syncs + 1


@pytest.mark.parametrize("crossover", [None, 200])
@pytest.mark.parametrize("bitset", [False, True])
def test_frontier_flood_matches(graphs, bitset, crossover):
    jg, tg = graphs
    kw = dict(source=0, method="frontier", bitset=bitset,
              frontier_crossover=crossover)
    run_both(jg, tg, JF.Flood(**kw), TF.Flood(**kw))


@pytest.mark.parametrize("method", ["hybrid", "segment"])
def test_packed_floods_match(graphs, method):
    jg, tg = graphs
    run_both(jg, tg, JF.Flood(source=0, method=method, bitset=True),
             TF.Flood(source=0, method=method, bitset=True))
    kw = dict(source=0, method=method, k=64, bitset=True)
    run_both(jg, tg, JA.AdaptiveFlood(**kw), TA.AdaptiveFlood(**kw))


def test_interop_carries_packed_states(graphs):
    # A packed reference state (uint32 words) carried across resumes in
    # the port exactly as in the reference.
    jg, tg = graphs
    key = jax.random.key(0)
    for kw, jcls, tcls in ((dict(method="segment"), JF.Flood, TF.Flood),
                           (dict(method="hybrid", k=64), JA.AdaptiveFlood,
                            TA.AdaptiveFlood)):
        jproto, tproto = jcls(bitset=True, **kw), tcls(bitset=True, **kw)
        js, _ = JE.run(jg, jproto, key, 2)
        ts = interop.flood_state_from_numpy(state_fields(js), device="cpu")
        assert type(ts).__name__ == type(js).__name__
        assert_same_state(ts, js)
        jend, jout = JE.run_until_coverage_from(
            jg, jproto, js, key, coverage_target=TARGET,
            max_rounds=MAX_ROUNDS, donate=False)
        tend, tout = TE.run_until_coverage_from(
            tg, tproto, ts, prng.key(0), coverage_target=TARGET,
            max_rounds=MAX_ROUNDS)
        assert tout == jout
        assert_same_state(tend, jend)


def test_frontier_needs_the_source_csr():
    tg = build_port("er")
    with pytest.raises(ValueError, match="source-CSR"):
        TS.propagate_or(tg, torch.zeros(tg.n_nodes_padded, dtype=torch.bool),
                        "frontier")
