"""The port's ``engine.run`` / ``run_from`` against the JAX package's.

Both return the final state and every stat stacked to ``[rounds]``; the
stats are counts and f32 ratios of counts, so each round must be equal,
and so must the final states (packed words compared as ``uint32``). A
resumed run — ``run_from`` a few rounds, then ``run_until_coverage_from``
— must return the reference's stacked stats and resumed dict (which counts
the resumed rounds only), end where the direct run ends, and leave the
state it was given as it was."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu.models import adaptive_flood as JA  # noqa: E402
from p2pnetwork_tpu.models import flood as JF  # noqa: E402
from p2pnetwork_tpu.sim import engine as JE  # noqa: E402
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
    ts, tstats = TE.run(tg, tproto, 4)
    assert_same_stats(tstats, jstats, 4)
    assert_same_state(ts, js)
    # Continue past coverage: the stats go on as the reference's do.
    before = {k: v.copy() for k, v in state_fields(ts).items()}
    js2, jstats2 = JE.run_from(jg, jproto, js, key, 9, donate=False)
    ts2, tstats2 = TE.run_from(tg, tproto, ts, 9)
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
    ts, tstats = TE.run_from(tg, tproto, tproto.init(tg), 3)
    assert_same_stats(tstats, jstats, 3)
    jend, jout = JE.run_until_coverage_from(jg, jproto, js, key,
                                            coverage_target=0.99,
                                            max_rounds=64, donate=False)
    tend, tout = TE.run_until_coverage_from(tg, tproto, ts,
                                            coverage_target=0.99,
                                            max_rounds=64)
    assert tout == jout
    assert_same_state(tend, jend)
    direct, dout = TE.run_until_coverage(tg, tproto, coverage_target=0.99,
                                         max_rounds=64)
    assert dout["rounds"] == tout["rounds"] + 3
    assert torch.equal(direct.seen, tend.seen)


def test_zero_rounds_return_the_state(graphs):
    _, tg = graphs
    proto = TF.Flood(source=0)
    state = proto.init(tg)
    got, stats = TE.run_from(tg, proto, state, 0)
    assert got is state and stats == {}
