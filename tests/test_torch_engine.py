"""The port's engine loops against the JAX package's: ``run`` /
``run_from``, and the keyed early-exit loops.

Both return the final state and every stat stacked to ``[rounds]``; the
stats are counts and f32 ratios of counts, so each round must be equal,
and so must the final states (packed words compared as ``uint32``). A
resumed run — ``run_from`` a few rounds, then ``run_until_coverage_from``
— must return the reference's stacked stats and resumed dict (which counts
the resumed rounds only), end where the direct run ends, and leave the
state it was given as it was. SIR (which draws every round) must give the
reference's dict by ``run_until_coverage`` at one and three steps per
super-step, and PageRank by ``run_until_converged``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu.models import adaptive_flood as JA  # noqa: E402
from p2pnetwork_tpu.models import flood as JF  # noqa: E402
from p2pnetwork_tpu.models import pagerank as JPR  # noqa: E402
from p2pnetwork_tpu.models import sir as JS  # noqa: E402
from p2pnetwork_tpu.sim import engine as JE  # noqa: E402
from p2pnetwork_tpu_torch import models as TM  # noqa: E402
from p2pnetwork_tpu_torch import prng  # noqa: E402
from p2pnetwork_tpu_torch.models import adaptive_flood as TA  # noqa: E402
from p2pnetwork_tpu_torch.models import flood as TF  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine as TE  # noqa: E402
from tests.test_torch_frontier import assert_same_state  # noqa: E402
from tests.test_torch_graph import (LAYOUTS, build_jax,  # noqa: E402
                                    build_port, state_fields)

#: (JAX protocol, port protocol) pairs, by name.
PROTOCOLS = {
    "flood-segment": (JF.Flood(source=0, method="segment"),
                      TF.Flood(source=0, method="segment")),
    "flood-hybrid-bitset": (JF.Flood(source=0, method="hybrid", bitset=True),
                            TF.Flood(source=0, method="hybrid", bitset=True)),
    "flood-frontier": (JF.Flood(source=0, method="frontier"),
                       TF.Flood(source=0, method="frontier")),
    "adaptive-64": (JA.AdaptiveFlood(source=0, method="pallas", k=64),
                    TA.AdaptiveFlood(source=0, method="pallas", k=64)),
}


@pytest.fixture(scope="module")
def graphs():
    return build_jax("ws", **LAYOUTS), build_port("ws", **LAYOUTS)


def assert_same_stats(got, want, rounds):
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w)
        assert got[name].shape == w.shape == (rounds,), name
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)


@pytest.mark.parametrize("name", sorted(PROTOCOLS))
def test_run_and_run_from_stack_the_reference_stats(graphs, name):
    jg, tg = graphs
    jproto, tproto = PROTOCOLS[name]
    key = jax.random.key(0)
    js, jstats = JE.run(jg, jproto, key, 4)
    ts, tstats = TE.run(tg, tproto, prng.key(0), 4)
    assert_same_stats(tstats, jstats, 4)
    assert_same_state(ts, js)
    # Continue past coverage: the stats go on as the reference's do.
    before = {k: v.copy() for k, v in state_fields(ts).items()}
    js2, jstats2 = JE.run_from(jg, jproto, js, key, 9, donate=False)
    ts2, tstats2 = TE.run_from(tg, tproto, ts, prng.key(0), 9)
    assert_same_stats(tstats2, jstats2, 9)
    assert_same_state(ts2, js2)
    for k, v in state_fields(ts).items():  # the given state is untouched
        np.testing.assert_array_equal(v, before[k])


@pytest.mark.parametrize("name", ["flood-hybrid-bitset", "adaptive-64"])
def test_resumed_run_matches(graphs, name):
    jg, tg = graphs
    jproto, tproto = PROTOCOLS[name]
    key = jax.random.key(0)
    js, jstats = JE.run_from(jg, jproto, jproto.init(jg, key), key, 3,
                             donate=False)
    ts, tstats = TE.run_from(tg, tproto, tproto.init(tg, prng.key(0)),
                             prng.key(0), 3)
    assert_same_stats(tstats, jstats, 3)
    jend, jout = JE.run_until_coverage_from(jg, jproto, js, key,
                                            coverage_target=0.99,
                                            max_rounds=64, donate=False)
    tend, tout = TE.run_until_coverage_from(tg, tproto, ts, prng.key(0),
                                            coverage_target=0.99,
                                            max_rounds=64)
    assert tout == jout
    assert_same_state(tend, jend)
    direct, dout = TE.run_until_coverage(tg, tproto, prng.key(0),
                                         coverage_target=0.99, max_rounds=64)
    assert dout["rounds"] == tout["rounds"] + 3
    assert torch.equal(direct.seen, tend.seen)


def test_zero_rounds_return_the_state(graphs):
    _, tg = graphs
    proto = TF.Flood(source=0)
    state = proto.init(tg, prng.key(0))
    got, stats = TE.run_from(tg, proto, state, prng.key(0), 0)
    assert got is state and stats == {}


# ----------------------------------------------- keyed protocols, the loops

SIR_KW = {"beta": 0.3, "gamma": 0.05, "source": 0}


@pytest.mark.parametrize("method", ["segment", "gather", "blocked", "pallas",
                                    "hybrid"])
def test_sir_run_until_coverage_at_one_and_three_steps(graphs, method):
    # The key chain advances on frozen sub-steps too, so T = 3 walks the
    # very keys of T = 1 and must give the reference's dict and state.
    jg, tg = graphs
    key = jax.random.key(0)
    js, jout = JE.run_until_coverage(jg, JS.SIR(method=method, **SIR_KW),
                                     key, coverage_target=0.9,
                                     max_rounds=64)
    for steps in (1, 3):
        ts, tout = TE.run_until_coverage(
            tg, TM.SIR(method=method, **SIR_KW), prng.key(0),
            coverage_target=0.9, max_rounds=64, steps_per_round=steps)
        assert tout == jout, steps
        np.testing.assert_array_equal(ts.status.numpy(),
                                      np.asarray(js.status))
    assert 0 < jout["rounds"] < 64


@pytest.mark.parametrize("method", ["segment", "hybrid"])
def test_run_until_converged_pagerank(graphs, method):
    jg, tg = graphs
    key = jax.random.key(0)
    jproto, tproto = (JPR.PageRank(method=method),
                      TM.PageRank(method=method))
    # The threshold sits midway, in log scale, between two consecutive
    # reference residuals, so sums taken in another order (which move a
    # residual by ~1e-3 relative) cannot change the round that stops.
    _, jstats = JE.run(jg, jproto, key, 40)
    res = np.asarray(jstats["residual"])
    thr = float(np.sqrt(res[19] * res[20]))
    js, jout = JE.run_until_converged(jg, jproto, key, stat="residual",
                                      threshold=thr)
    ts, tout = TE.run_until_converged(tg, tproto, prng.key(0),
                                      stat="residual", threshold=thr)
    assert set(tout) == set(jout) == {"rounds", "value", "messages"}
    assert tout["rounds"] == jout["rounds"] == 21
    assert tout["messages"] == jout["messages"]
    # Tolerance: the L1 residual of reordered f32 sums (see above).
    np.testing.assert_allclose(tout["value"], jout["value"], rtol=1e-3)
    # Resumed from the final state with T = 3: the first round always
    # runs (value0 is inf), finds the residual below, and stops.
    again, aout = TE.run_until_converged(tg, tproto, prng.key(1),
                                         stat="residual", threshold=thr,
                                         state0=ts, steps_per_round=3)
    assert aout["rounds"] == 1 and aout["value"] < thr


def test_run_until_converged_without_rounds_reports_inf(graphs):
    _, tg = graphs
    state, out = TE.run_until_converged(tg, TM.PageRank(), prng.key(0),
                                        stat="residual", threshold=1.0,
                                        max_rounds=0)
    assert out == {"rounds": 0, "value": float("inf"), "messages": 0}


def test_run_until_converged_needs_the_stat(graphs):
    _, tg = graphs
    with pytest.raises(ValueError, match="variance"):
        TE.run_until_converged(tg, TM.PageRank(), prng.key(0),
                               stat="variance", threshold=1.0)
