"""The port's random walks against the JAX package's, on the CPU.

``edge_uniform`` must give the reference's f32 bits for random u32 keys
and for negative i32 inputs. ``RandomWalks`` runs through
``run_until_coverage`` and ``run`` in both packages on the same graph and
key — WS, BA and ER, healthy and churned (runtime links, a failed node
band, cut edges), ``restart_p`` of 0 and 0.1 — and the summary dicts, the
stacked stats and the final ``pos``, ``start`` and ``visited`` must be
equal exactly (counts, bools and f32 ratios of counts). Batched super-steps
(``steps_per_round`` 1, 8 and 32) must give the reference's ``T = 1``
result bit for bit, and a state the reference made must resume in the
port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from p2pnetwork_tpu import models as JM  # noqa: E402
from p2pnetwork_tpu.sim import engine as JE  # noqa: E402
from p2pnetwork_tpu.sim import failures as JFa  # noqa: E402
from p2pnetwork_tpu.sim import topology as JT  # noqa: E402
from p2pnetwork_tpu.utils.edgehash import edge_uniform as j_edge_uniform  # noqa: E402
from p2pnetwork_tpu_torch import interop, prng  # noqa: E402
from p2pnetwork_tpu_torch import models as TM  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine as TE  # noqa: E402
from p2pnetwork_tpu_torch.sim import failures as TFa  # noqa: E402
from p2pnetwork_tpu_torch.sim import topology as TT  # noqa: E402
from p2pnetwork_tpu_torch.utils.edgehash import edge_uniform  # noqa: E402
from tests.test_torch_graph import (build_jax, build_port,  # noqa: E402,F401
                                    one_torch_thread, state_fields)
from tests.test_torch_semiring import bits, churn  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_GRAPHS = {}


def graphs(family, churned=False):
    """``(jax graph, port graph)`` with the source-CSR view; churned: a
    dynamic region of runtime links, a failed node band, cut edges."""
    key = (family, churned)
    if key not in _GRAPHS:
        jg = build_jax(family, source_csr=True)
        tg = build_port(family, source_csr=True)
        if churned:
            jg, tg = churn((JT, JFa), jg), churn((TT, TFa), tg)
        _GRAPHS[key] = jg, tg
    return _GRAPHS[key]


def assert_state_equal(got, want):
    got, want = state_fields(got), state_fields(want)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------ edge_uniform


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edge_uniform_is_bit_equal(seed):
    rng = np.random.default_rng(seed)
    kd = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
    w = rng.integers(-2**31, 2**31, (64, 1), dtype=np.int64).astype(np.int32)
    s = rng.integers(-2**31, 2**31, (64, 1), dtype=np.int64).astype(np.int32)
    r = rng.integers(-2**31, 2**31, (64, 17), dtype=np.int64).astype(np.int32)
    r[:, :3] = [-1, -2**31, 2**31 - 1]  # sentinels and the extremes
    want = j_edge_uniform(jax.random.wrap_key_data(jnp.asarray(kd)),
                          jnp.asarray(w), jnp.asarray(s), jnp.asarray(r))
    got = edge_uniform(kd, torch.from_numpy(w), torch.from_numpy(s),
                       torch.from_numpy(r))
    assert got.dtype == torch.float32 and got.shape == (64, 17)
    np.testing.assert_array_equal(bits(got), bits(np.asarray(want)))
    assert ((got >= 0) & (got < 1)).all()


# ---------------------------------------------------------- RandomWalks


def _pair(**kw):
    return JM.RandomWalks(**kw), TM.RandomWalks(**kw)


@pytest.mark.parametrize("restart_p", [0.0, 0.1])
@pytest.mark.parametrize("churned", [False, True], ids=["healthy", "churn"])
@pytest.mark.parametrize("family", ["ws", "ba", "er"])
def test_random_walks_equal_reference(family, churned, restart_p):
    jg, tg = graphs(family, churned)
    jp, tp = _pair(n_walkers=96, restart_p=restart_p)
    js, jout = JE.run_until_coverage(jg, jp, jax.random.key(3),
                                     coverage_target=0.7, max_rounds=400)
    ts, tout = TE.run_until_coverage(tg, tp, prng.key(3),
                                     coverage_target=0.7, max_rounds=400)
    assert tout == jout and tout["rounds"] > 1
    assert_state_equal(ts, js)
    js, jst = JE.run(jg, jp, jax.random.key(5), 6)
    ts, tst = TE.run(tg, tp, prng.key(5), 6)
    assert set(tst) == set(jst)
    for k in jst:
        np.testing.assert_array_equal(bits(tst[k].numpy().astype(
            np.asarray(jst[k]).dtype)), bits(jst[k]), err_msg=k)
    assert_state_equal(ts, js)


@pytest.mark.parametrize("T", [1, 8, 32])
def test_steps_per_round_are_bit_exact(T):
    jg, tg = graphs("ws", churned=True)
    jp, tp = _pair(n_walkers=128, restart_p=0.1)
    js, jout = JE.run_until_coverage(jg, jp, jax.random.key(0),
                                     coverage_target=0.8, max_rounds=500)
    ts, tout = TE.run_until_coverage(tg, tp, prng.key(0),
                                     coverage_target=0.8, max_rounds=500,
                                     steps_per_round=T)
    assert tout == jout
    assert_state_equal(ts, js)


def test_more_walkers_than_live_nodes_wrap():
    jg, tg = graphs("ba", churned=True)
    jp, tp = _pair(n_walkers=700)
    assert_state_equal(tp.init(tg, prng.key(0)),
                       jp.init(jg, jax.random.key(0)))


def test_state_carries_across_and_resumes():
    jg, tg = graphs("er", churned=True)
    jp, tp = _pair(n_walkers=64, restart_p=0.1)
    js, _ = JE.run(jg, jp, jax.random.key(1), 3)
    ts = interop.protocol_state_from_numpy("RandomWalksState",
                                           state_fields(js), device="cpu")
    js2, jout = JE.run_until_coverage_from(jg, jp, js, jax.random.key(2),
                                           coverage_target=0.6,
                                           max_rounds=300)
    ts2, tout = TE.run_until_coverage_from(tg, tp, ts, prng.key(2),
                                           coverage_target=0.6,
                                           max_rounds=300)
    assert tout == jout
    assert_state_equal(ts2, js2)


def test_walks_refuse_as_the_reference():
    with pytest.raises(ValueError, match="n_walkers"):
        TM.RandomWalks(n_walkers=0)
    with pytest.raises(ValueError, match="restart_p"):
        TM.RandomWalks(restart_p=1.5)
    _, tg = graphs("ws")
    import dataclasses
    bare = dataclasses.replace(tg, src_eid=None, src_offsets=None)
    with pytest.raises(ValueError, match="source-CSR"):
        TM.RandomWalks().init(bare, prng.key(0))
