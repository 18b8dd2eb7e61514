"""The port's membership layer against the JAX package's, on the CPU:
Vivaldi coordinates, the failure detector, anti-entropy, and the weighted
``prng.choice`` that seeds anti-entropy's items.

``choice(p=)`` with replacement must return ``jax.random.choice``'s
indices exactly, for uniform weights, weights masked by failed nodes and
skewed weights; its prefix sum must have ``jnp.cumsum``'s f32 bits (XLA's
CPU scan rounds blockwise, not left to right). The detector and
anti-entropy, which draw through ``prng`` and count, must equal the
reference's dicts, stacked stats and states exactly. Vivaldi's step is
exact: one step from the reference's state gives its bits. Runs from
``init`` start from ``prng.normal`` (within 3 ulp of jax's): their drawn
partners and ``messages`` are exact, their floats within
``VIVALDI_RTOL`` / ``VIVALDI_ATOL`` after 3 rounds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from p2pnetwork_tpu import models as JM  # noqa: E402
from p2pnetwork_tpu.sim import engine as JE  # noqa: E402
from p2pnetwork_tpu.sim import failures as JFa  # noqa: E402
from p2pnetwork_tpu_torch import interop, prng  # noqa: E402
from p2pnetwork_tpu_torch import models as TM  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine as TE  # noqa: E402
from p2pnetwork_tpu_torch.sim import failures as TFa  # noqa: E402
from tests.test_torch_graph import (build_jax, build_port,  # noqa: E402,F401
                                    one_torch_thread, state_fields)
from tests.test_torch_semiring import bits, latency  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

#: Vivaldi after 3 rounds from ``init``, and only there: the init's normal
#: draws are within 3 ulp of jax's (a step from a shared state is exact,
#: ``test_vivaldi_step_is_exact``). The first springs act on points 1e-3
#: apart, whose unit vectors turn those ulps into ~1e-7 relative moves of
#: O(1) coordinates; three rounds of springs grow them to ~1e-5 absolute
#: (measured: 1e-5 on the WS graph at 4,096 nodes), while the stats stay
#: within ~1e-7 relative.
VIVALDI_RTOL, VIVALDI_ATOL = 1e-4, 2e-5


def assert_state_equal(got, want):
    got, want = state_fields(got), state_fields(want)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]),
                                      err_msg=k)


def _dead(n):
    return np.random.default_rng(0).choice(n, size=n // 50, replace=False)


_GRAPHS = {}


def graphs(family, kind=None):
    """``(jax graph, port graph)``: healthy, or with 2% of nodes failed
    (``"failed"``) or marked unresponsive (``"silent"``), as
    ``examples/membership_demo.py`` does."""
    key = (family, kind)
    if key not in _GRAPHS:
        jg, tg = build_jax(family), build_port(family)
        if kind is not None:
            fn = "fail_nodes" if kind == "failed" else "mark_unresponsive"
            dead = _dead(jg.n_nodes)
            jg, tg = getattr(JFa, fn)(jg, dead), getattr(TFa, fn)(tg, dead)
        _GRAPHS[key] = jg, tg
    return _GRAPHS[key]


# ------------------------------------------------------- weighted choice


def _weights(kind, n, rng):
    if kind == "uniform":
        mask = np.ones(n, bool)
    elif kind == "masked":
        mask = rng.random(n) > 0.3
    else:
        return (rng.pareto(1.2, n) * (rng.random(n) > 0.1)).astype(
            np.float32)
    return (mask / max(mask.sum(), 1)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 17, 1000, 4133, 70001])
def test_prefix_sum_has_xla_bits(n):
    x = np.random.default_rng(n).random(n).astype(np.float32)
    np.testing.assert_array_equal(
        bits(prng.cumsum_f32(torch.from_numpy(x))),
        bits(np.asarray(jnp.cumsum(jnp.asarray(x)))))


@pytest.mark.parametrize("kind", ["uniform", "masked", "skewed"])
@pytest.mark.parametrize("n", [5, 1000, 4224, 100_003])
def test_weighted_choice_is_bit_equal(n, kind):
    rng = np.random.default_rng(n)
    p = _weights(kind, n, rng)
    for seed, shape in ((0, (64,)), (7, (3, 50)), (11, ())):
        want = jax.random.choice(jax.random.key(seed), n, shape,
                                 p=jnp.asarray(p))
        got = prng.choice(prng.key(seed), n, shape, p=torch.from_numpy(p),
                          device="cpu")
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    a = torch.arange(n, dtype=torch.int32) * 3
    want = jax.random.choice(jax.random.key(2), jnp.asarray(a.numpy()),
                             (9,), p=jnp.asarray(p))
    got = prng.choice(prng.key(2), a, (9,), p=torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_weighted_choice_refusals():
    with pytest.raises(ValueError, match="p must be"):
        prng.choice(prng.key(0), 5, (2,), p=torch.ones(4), device="cpu")
    with pytest.raises(NotImplementedError, match="replace=False"):
        prng.choice(prng.key(0), 5, (2,), replace=False, p=torch.ones(5),
                    device="cpu")


# --------------------------------------------------------------- Vivaldi


@pytest.mark.parametrize("noise", [0.0, 0.2])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["hops", "latency"])
def test_vivaldi_equals_reference(weighted, noise):
    jg, tg = graphs("ws", "failed")
    if weighted:
        jg, tg = jg.with_weights(latency), tg.with_weights(latency)
    jp, tp = JM.Vivaldi(dim=2, noise=noise), TM.Vivaldi(dim=2, noise=noise)
    js, jst = JE.run(jg, jp, jax.random.key(0), 3)
    ts, tst = TE.run(tg, tp, prng.key(0), 3)
    np.testing.assert_array_equal(tst["messages"].numpy(),
                                  np.asarray(jst["messages"]))
    for k in ("rmse", "mean_rel_err", "mean_ce"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   rtol=VIVALDI_RTOL, err_msg=k)
    assert ts.round.item() == int(js.round) == 3
    for f in ("coord", "height", "ce"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)),
                                   rtol=VIVALDI_RTOL, atol=VIVALDI_ATOL,
                                   err_msg=f)
    i, j = np.arange(0, 400, 3), np.arange(5, 405, 3)
    np.testing.assert_allclose(
        tp.predicted(ts, torch.from_numpy(i), torch.from_numpy(j)).numpy(),
        np.asarray(jp.predicted(js, jnp.asarray(i), jnp.asarray(j))),
        rtol=VIVALDI_RTOL, atol=VIVALDI_ATOL)


@pytest.mark.parametrize("dim,weighted,noise", [
    (2, False, 0.0), (2, True, 0.2), (3, False, 0.0), (3, True, 0.0)],
    ids=["hops", "latency-noise", "hops-dim3", "latency-dim3"])
def test_vivaldi_step_is_exact(dim, weighted, noise):
    # One step from a shared state (the reference's after 3 rounds,
    # carried across): coord, height and ce bit for bit, and predicted.
    # The stats are f32 sums over all nodes, which add in another order:
    # messages exact, the rest within 1e-6 relative.
    jg, tg = graphs("ws", "failed")
    if weighted:
        jg, tg = jg.with_weights(latency), tg.with_weights(latency)
    jp = JM.Vivaldi(dim=dim, noise=noise)
    tp = TM.Vivaldi(dim=dim, noise=noise)
    js, _ = JE.run(jg, jp, jax.random.key(0), 3)
    ts = interop.protocol_state_from_numpy("VivaldiState", state_fields(js),
                                           device="cpu")
    js1, jst = jp.step(jg, js, jax.random.key(9))
    ts1, tst = tp.step(tg, ts, prng.key(9))
    assert_state_equal(ts1, js1)
    assert int(tst["messages"]) == int(jst["messages"])
    for k in ("rmse", "mean_rel_err", "mean_ce"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   rtol=1e-6, err_msg=k)
    i, j = np.arange(0, 400, 3), np.arange(5, 405, 3)
    np.testing.assert_array_equal(
        bits(tp.predicted(ts1, torch.from_numpy(i),
                          torch.from_numpy(j)).numpy()),
        bits(np.asarray(jp.predicted(js1, jnp.asarray(i), jnp.asarray(j)))))


def test_vivaldi_needs_a_complete_table():
    tg = build_port("ba", max_degree=4)
    with pytest.raises(ValueError, match="complete neighbor table"):
        TM.Vivaldi().init(tg, prng.key(0))


# ------------------------------------------------------ failure detector


@pytest.mark.parametrize("family,loss_prob", [
    ("ws", 0.0), ("ws", 0.05), ("ba", 0.0), ("ba", 0.05)])
def test_failure_detector_equals_reference(family, loss_prob):
    jg, tg = graphs(family, "silent")
    jp = JM.FailureDetector(threshold=3, loss_prob=loss_prob)
    tp = TM.FailureDetector(threshold=3, loss_prob=loss_prob)
    js, jout = JE.run_until_converged(jg, jp, jax.random.key(1),
                                      stat="undetected", threshold=1,
                                      max_rounds=4096)
    ts, tout = TE.run_until_converged(tg, tp, prng.key(1),
                                      stat="undetected", threshold=1,
                                      max_rounds=4096)
    assert tout == jout and tout["value"] == 0 and tout["rounds"] > 3
    assert_state_equal(ts, js)
    js, jst = JE.run(jg, jp, jax.random.key(2), 4)
    ts, tst = TE.run(tg, tp, prng.key(2), 4)
    for k in jst:
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]),
                                      err_msg=k)
    assert_state_equal(ts, js)


# ----------------------------------------------------------- anti-entropy


@pytest.mark.parametrize("push,pull", [(True, True), (True, False),
                                       (False, True)])
@pytest.mark.parametrize("kind", [None, "failed"], ids=["healthy", "failed"])
def test_anti_entropy_equals_reference(kind, push, pull):
    jg, tg = graphs("ws", kind)
    jp = JM.AntiEntropy(n_items=64, push=push, pull=pull)
    tp = TM.AntiEntropy(n_items=64, push=push, pull=pull)
    assert_state_equal(tp.init(tg, prng.key(2)),
                       jp.init(jg, jax.random.key(2)))
    js, jout = JE.run_until_converged(jg, jp, jax.random.key(2),
                                      stat="missing", threshold=1,
                                      max_rounds=4096)
    ts, tout = TE.run_until_converged(tg, tp, prng.key(2), stat="missing",
                                      threshold=1, max_rounds=4096)
    assert tout == jout and tout["value"] == 0
    assert_state_equal(ts, js)


def test_anti_entropy_refusals():
    tg = build_port("ws")
    with pytest.raises(ValueError, match="push, pull"):
        TM.AntiEntropy(push=False, pull=False).init(tg, prng.key(0))


# --------------------------------------------------------------- interop


@pytest.mark.parametrize("name", ["VivaldiState", "FailureDetectorState",
                                  "AntiEntropyState"])
def test_states_carry_across_and_resume(name):
    make = {"VivaldiState": lambda M: M.Vivaldi(),
            "FailureDetectorState": lambda M: M.FailureDetector(
                loss_prob=0.05),
            "AntiEntropyState": lambda M: M.AntiEntropy(n_items=8)}[name]
    jg, tg = graphs("ba", "silent" if name == "FailureDetectorState"
                    else "failed")
    jp, tp = make(JM), make(TM)
    js, _ = JE.run(jg, jp, jax.random.key(1), 2)
    ts = interop.protocol_state_from_numpy(name, state_fields(js),
                                           device="cpu")
    assert_state_equal(ts, js)
    js2, jst = JE.run_from(jg, jp, js, jax.random.key(4), 3, donate=False)
    ts2, tst = TE.run_from(tg, tp, ts, prng.key(4), 3)
    np.testing.assert_array_equal(tst["messages"].numpy(),
                                  np.asarray(jst["messages"]))
    if name == "VivaldiState":
        np.testing.assert_allclose(ts2.coord.numpy(), np.asarray(js2.coord),
                                   rtol=VIVALDI_RTOL, atol=VIVALDI_ATOL)
    else:
        assert_state_equal(ts2, js2)
