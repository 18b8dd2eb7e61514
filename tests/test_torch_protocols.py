"""The port's keyed protocols against the JAX package's, on the CPU.

- SIR: every per-round stat and the final ``status`` are equal exactly
  through every dense method (the pressure sums are integers, the draws
  are bit for bit jax's, and ``1 - (1-beta)^k`` is read from a table that
  equals ``1 - jnp.power`` over every ``k`` the graphs can give).
- ``draw_neighbor_slot``: the drawn slots, partners and ``has_neighbor``
  are equal on a healthy graph and after ``fail_nodes``.
- Gossip: partner draws and ``messages`` exact; ``variance`` and ``mean``
  within a stated tolerance (the initial ``normal`` values are within
  3 ulp of jax's, ``tests/test_torch_prng.py``).
- Push-sum and PageRank: sums over arbitrary f32 terms, added in another
  order than the reference's; ``messages`` exact, the rest within a
  stated tolerance.
- ``random_node_failures`` / ``random_edge_failures``: the re-masked
  graphs are equal field for field.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from p2pnetwork_tpu.models import base as JB  # noqa: E402
from p2pnetwork_tpu.models import gossip as JGo  # noqa: E402
from p2pnetwork_tpu.models import pagerank as JPR  # noqa: E402
from p2pnetwork_tpu.models import pushsum as JPS  # noqa: E402
from p2pnetwork_tpu.models import sir as JS  # noqa: E402
from p2pnetwork_tpu.sim import engine as JE  # noqa: E402
from p2pnetwork_tpu.sim import failures as JFa  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu_torch import interop, prng  # noqa: E402
from p2pnetwork_tpu_torch import models as TM  # noqa: E402
from p2pnetwork_tpu_torch.models import base as TB  # noqa: E402
from p2pnetwork_tpu_torch.models import sir as TS  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine as TE  # noqa: E402
from p2pnetwork_tpu_torch.sim import failures as TFa  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402
from tests.test_torch_graph import (LAYOUTS, assert_same_fields,  # noqa: E402
                                    build_jax, build_port, graph_fields,
                                    state_fields)

METHODS = ["segment", "gather", "blocked", "pallas", "hybrid"]
ROUNDS = 30
#: The ladder's SIR rung (benchmarks/ladder.py, bench_sir_1m).
SIR_KW = {"beta": 0.3, "gamma": 0.05, "source": 0}


@pytest.fixture(scope="module")
def ws():
    return build_jax("ws", **LAYOUTS), build_port("ws", **LAYOUTS)


@pytest.fixture(scope="module")
def ba():
    """The gossip rung's graph family at 2,000 nodes."""
    kw = {"seed": 0, "max_degree": 128}
    return (JG.barabasi_albert(2000, 4, **kw),
            TG.barabasi_albert(2000, 4, device="cpu", **kw))


def assert_stats_equal(got, want, names=None):
    assert set(got) == set(want)
    for name in names or want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)


def assert_stats_close(got, want, rtol, atol, names):
    for name in names:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=rtol, atol=atol, err_msg=name)


# ------------------------------------------------------------------- SIR


@pytest.mark.parametrize("beta", [0.05, 0.1, 0.3, 0.5])
def test_escape_table_equals_jnp_power(ws, beta):
    # Over 0..K of the test graph, the table is jnp.power itself; up to
    # 1,000, 1 - table is 1 - jnp.power (the table alone parts from
    # jnp.power at k = 58, 685, 95 and 127 for these betas, in values
    # too small to move 1 - x; ROADMAP §C).
    K = TS.max_pressure(ws[1])
    k = jnp.arange(K + 1, dtype=jnp.float32)
    want = np.asarray(jnp.power(np.float32(1.0 - beta), k))
    np.testing.assert_array_equal(TS.escape_table_host(beta, K), want)
    k = jnp.arange(1001, dtype=jnp.float32)
    want = np.asarray(1.0 - jnp.power(np.float32(1.0 - beta), k))
    np.testing.assert_array_equal(
        np.float32(1.0) - TS.escape_table_host(beta, 1000), want)


@pytest.mark.parametrize("method", METHODS)
def test_sir_run_equals_reference(ws, method):
    jg, tg = ws
    js, jstats = JE.run(jg, JS.SIR(method=method, **SIR_KW),
                        jax.random.key(0), ROUNDS)
    ts, tstats = TE.run(tg, TM.SIR(method=method, **SIR_KW), prng.key(0),
                        ROUNDS)
    assert_stats_equal(tstats, jstats)
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    # The epidemic really ran: it spread, and some nodes recovered.
    assert 0 < float(tstats["r_frac"][-1]) < float(tstats["coverage"][-1])


@pytest.mark.parametrize("method", ["segment", "hybrid"])
def test_sir_state_carries_across(ws, method):
    jg, tg = ws
    jproto = JS.SIR(method=method, **SIR_KW)
    js, _ = JE.run(jg, jproto, jax.random.key(1), 5)
    ts = interop.protocol_state_from_numpy("SIRState", state_fields(js),
                                           device="cpu")
    key = jax.random.key(2)
    js2, jstats = JE.run_from(jg, jproto, js, key, 6, donate=False)
    ts2, tstats = TE.run_from(tg, TM.SIR(method=method, **SIR_KW), ts,
                              interop.key_from_numpy(
                                  jax.random.key_data(key)), 6)
    assert_stats_equal(tstats, jstats)
    np.testing.assert_array_equal(ts2.status.numpy(), np.asarray(js2.status))


# ------------------------------------------------------- neighbor draws


def _slots_equal(jg, tg, seed):
    jslot, jpart, jhas = JB.draw_neighbor_slot(jg, jax.random.key(seed))
    tslot, tpart, thas = TB.draw_neighbor_slot(tg, prng.key(seed))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tpart.numpy(), np.asarray(jpart))
    np.testing.assert_array_equal(thas.numpy(), np.asarray(jhas))
    return thas


@pytest.mark.parametrize("seed", [0, 7])
def test_draw_neighbor_slot_equals_reference(ba, seed):
    _slots_equal(*ba, seed)


def test_draw_neighbor_slot_after_failures(ba):
    jg, tg = ba
    dead = np.arange(0, 2000, 3)
    has = _slots_equal(JFa.fail_nodes(jg, dead), TFa.fail_nodes(tg, dead), 3)
    assert not has.all()  # some rows lost every neighbor


# ----------------------------------------------- gossip, push-sum, PageRank


def test_gossip_equals_reference(ba):
    jg, tg = ba
    js, jstats = JE.run(jg, JGo.Gossip(alpha=0.5), jax.random.key(0),
                        ROUNDS)
    ts, tstats = TE.run(tg, TM.Gossip(alpha=0.5), prng.key(0), ROUNDS)
    assert_stats_equal(tstats, jstats, ["messages"])
    # Tolerance: the initial normal draws are within 3 ulp of jax's and
    # mixing never amplifies a difference; the f32 sums of mean and
    # variance run in another order. 1e-5 relative to the values' scale
    # (variance starts near 1).
    assert_stats_close(tstats, jstats, 1e-5, 1e-6, ["variance", "mean"])
    np.testing.assert_allclose(ts.values.numpy(), np.asarray(js.values),
                               rtol=0, atol=1e-5)


def test_gossip_partners_of_the_first_round_are_exact(ba):
    jg, tg = ba
    key = jax.random.split(jax.random.fold_in(jax.random.key(0), 1),
                           ROUNDS)[0]
    tkey = prng.split(prng.fold_in(prng.key(0), 1), ROUNDS)[0]
    np.testing.assert_array_equal(tkey, jax.random.key_data(key))
    _slots_equal(jg, tg, 0)
    jslot = JB.draw_neighbor_slot(jg, key)[1]
    tslot = TB.draw_neighbor_slot(tg, tkey)[1]
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))


def test_gossip_needs_a_neighbor_table():
    tg = build_port("er", build_neighbor_table=False)
    with pytest.raises(ValueError, match="neighbor table"):
        TM.Gossip().init(tg, prng.key(0))


@pytest.mark.parametrize("method", ["segment", "pallas", "hybrid"])
def test_pushsum_equals_reference(ws, method):
    jg, tg = ws
    js, jstats = JE.run(jg, JPS.PushSum(method=method), jax.random.key(0),
                        ROUNDS)
    ts, tstats = TE.run(tg, TM.PushSum(method=method), prng.key(0), ROUNDS)
    assert_stats_equal(tstats, jstats, ["messages"])
    # Tolerance: every round sums arbitrary f32 shares in another order
    # (B1's rows, the diagonals) than the reference, and the initial
    # normals are within 3 ulp; the totals are ~4,096 and ~100 in
    # magnitude, so 1e-5 relative plus 1e-4 absolute.
    assert_stats_close(tstats, jstats, 1e-5, 1e-4,
                       ["s_total", "w_total", "variance", "mean"])
    for f in ("s", "w"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("method", ["segment", "hybrid"])
def test_pagerank_run_equals_reference(ws, method):
    jg, tg = ws
    js, jstats = JE.run(jg, JPR.PageRank(method=method), jax.random.key(0),
                        ROUNDS)
    ts, tstats = TE.run(tg, TM.PageRank(method=method), prng.key(0), ROUNDS)
    assert_stats_equal(tstats, jstats, ["messages"])
    # Tolerance: sums of f32 shares in another order. rank_total and
    # rank_max to 1e-5 relative; the L1 residual falls to ~1e-6, where
    # reordered sums of ~4,096 terms of ~1e-10 move it by up to ~1e-8.
    assert_stats_close(tstats, jstats, 1e-5, 0, ["rank_total", "rank_max"])
    assert_stats_close(tstats, jstats, 1e-3, 2e-8, ["residual"])
    np.testing.assert_allclose(ts.ranks.numpy(), np.asarray(js.ranks),
                               rtol=1e-5, atol=1e-9)


# -------------------------------------------------------- random failures


@pytest.mark.parametrize("frac", [0.1, 0.5])
def test_random_node_failures_equal(ws, frac):
    jg, tg = ws
    got = TFa.random_node_failures(tg, prng.key(4), frac)
    want = JFa.random_node_failures(jg, jax.random.key(4), frac)
    assert_same_fields(graph_fields(got), graph_fields(want))
    assert not got.node_mask.all()


@pytest.mark.parametrize("frac", [0.1, 0.5])
def test_random_edge_failures_equal(frac):
    # Edge cuts are refused on blocked/hybrid graphs (as in the reference),
    # so the plain build.
    jg, tg = build_jax("ws"), build_port("ws")
    got = TFa.random_edge_failures(tg, prng.key(5), frac)
    want = JFa.random_edge_failures(jg, jax.random.key(5), frac)
    assert_same_fields(graph_fields(got), graph_fields(want))
    assert int(got.edge_mask.sum()) < tg.n_edges
