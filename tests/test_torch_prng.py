"""The port's ``prng`` against ``jax.random`` (jax 0.9.0, threefry2x32,
partitionable bits): keys, ``split``/``fold_in`` chains, raw bits and the
``uniform``/``randint``/``bernoulli``/``permutation``/``choice`` samplers
must be equal bit for bit;
``normal`` within 3 ulp and 4.8e-7 (its ``erf_inv`` is XLA's polynomial,
but the ``log1p`` inside it is torch's, which differs from XLA's in the
last bit for about 1% of arguments; the polynomial carries that bit into
up to 3 ulp of the result).

On the CPU every draw takes the plain version of the threefry kernel; the
kernel itself is held against that plain version in
``tests/test_torch_kernels.py`` (on a card) and in ``chip_smoke.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from p2pnetwork_tpu_torch import interop, prng  # noqa: E402
from p2pnetwork_tpu_torch.ops import threefry  # noqa: E402
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401

#: Seeds whose keys show the seed rule: jax without x64 keeps the low 32
#: bits (``2**32 + 5`` -> ``[0, 5]``, ``-1`` -> ``[0, 0xffffffff]``).
SEEDS = [0, 2**32 + 5, -1, 12345]
SHAPES = [(1,), (31,), (33,), (1000,), (4, 7), (3, 5, 2)]


def jkey(seed):
    return jax.random.key(seed)


def words(jk):
    return np.asarray(jax.random.key_data(jk))


def as_u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_words_equal(seed):
    assert prng.key(seed).dtype == np.uint32
    np.testing.assert_array_equal(prng.key(seed), words(jkey(seed)))
    np.testing.assert_array_equal(prng.PRNGKey(seed),
                                  words(jax.random.PRNGKey(seed)))


def test_seed_rule_words():
    np.testing.assert_array_equal(prng.key(2**32 + 5), [0, 5])
    np.testing.assert_array_equal(prng.key(-1), [0, 0xFFFFFFFF])


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_fold_in_chains_equal(seed):
    jk, tk = jkey(seed), prng.key(seed)
    for step in range(6):
        if step % 2:
            jk, tk = jax.random.fold_in(jk, step * 977), prng.fold_in(
                tk, step * 977)
        else:
            jk, jsub = jax.random.split(jk)
            tk, tsub = prng.split(tk)
            np.testing.assert_array_equal(tsub, words(jsub))
        np.testing.assert_array_equal(tk, words(jk))
    for num in (1, 3, 8, (2, 3)):
        np.testing.assert_array_equal(prng.split(tk, num),
                                      words(jax.random.split(jk, num)))


def test_key_round_trips_through_interop():
    jk = jax.random.fold_in(jkey(7), 3)
    tk = interop.key_from_numpy(words(jk))
    np.testing.assert_array_equal(tk, prng.fold_in(prng.key(7), 3))
    np.testing.assert_array_equal(prng.key_data(prng.wrap_key_data(tk)), tk)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_equal(seed, shape):
    got = prng.random_bits(prng.key(seed), shape, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(as_u32(got),
                                  np.asarray(jax.random.bits(jkey(seed),
                                                             shape)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_equal(seed, shape):
    tk, jk = prng.key(seed), jkey(seed)
    got = prng.uniform(tk, shape, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        as_u32(got), np.asarray(jax.random.uniform(jk, shape)).view(np.uint32))
    # A general range: XLA fuses the scale and shift into one rounding.
    got = prng.uniform(tk, shape, -3.3, 7.1, device="cpu")
    want = jax.random.uniform(jk, shape, minval=-3.3, maxval=7.1)
    np.testing.assert_array_equal(as_u32(got),
                                  np.asarray(want).view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [
    (0, 2**31 - 1),  # as draw_neighbor_slot calls it
    (0, 1), (0, 10), (-5, 3), (3, 3), (9, 2), (0, 65536), (0, 70001),
    (-2**31, 2**31 - 1)])
def test_randint_equal(seed, lo, hi):
    got = prng.randint(prng.key(seed), (513,), lo, hi, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.random.randint(jkey(seed), (513,), lo,
                                                   hi)))


def test_randint_refuses_bounds_jax_refuses():
    with pytest.raises(OverflowError):
        prng.randint(prng.key(0), (4,), 0, 2**40, device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("p", [0.0, 0.05, 0.3, 0.5, 1.0])
def test_bernoulli_equal(seed, p):
    got = prng.bernoulli(prng.key(seed), p, (2, 1001), device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.random.bernoulli(jkey(seed), p,
                                                     (2, 1001))))


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_three_ulp(seed):
    # Exact: the uniform draw, erf_inv and its log1p are XLA's, op for op
    # with XLA's fused multiply-adds (module doc). The name is the one the
    # test had when it held a 3-ulp tolerance.
    n = 1 << 18
    got = prng.normal(prng.key(seed), (n,), device="cpu").numpy()
    want = np.asarray(jax.random.normal(jkey(seed), (n,)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.usefixtures("one_torch_thread")
def test_log1p_f32_equals_xla():
    # Both branches (|x| below and above sqrt(2) - 1), the split, the
    # subnormal clamp and the special values: -1 -> -inf, below -1 -> NaN,
    # +inf -> +inf.
    x = np.concatenate([
        np.linspace(-0.999, 5.0, 40_001, dtype=np.float32),
        np.float32([0.0, -0.0, 1e-30, -1e-30, 1e30, np.inf, -1.0, -2.0,
                    0.41421357, -0.41421357, 0.4142135, -0.4142135])])
    got = prng.log1p_f32(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax.numpy.log1p)(x))
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0], dtype=torch.float32)
    np.testing.assert_array_equal(prng.erf_inv(x).numpy(),
                                  [-np.inf, np.inf, 0.0])


def test_cpu_draws_take_the_plain_version_and_cuda_is_the_default():
    before = threefry.LAUNCHES
    prng.uniform(prng.key(0), (64,), device="cpu")
    assert threefry.LAUNCHES == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            prng.uniform(prng.key(0), (64,))


def test_bits_past_two_to_the_32():
    # The counter's high word: the plain version's hash against the host
    # one at counters around 2**32.
    k0, k1 = (int(w) for w in prng.key(3))
    i = np.arange(2**32 - 20, 2**32 + 20, dtype=np.int64)
    want = [np.bitwise_xor(*prng.threefry2x32(k0, k1, int(c) >> 32,
                                              int(c) & 0xFFFFFFFF))
            for c in i]
    got = threefry.hash_counters(k0, k1, torch.from_numpy(i))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("base", [2**32 - 4, 2**32, 2**33 + 7,
                                  2**40 + 12345, 2**62 - 3])
def test_hash_counters_past_two_to_the_32_equal_jax(base):
    # The counters a draw from a launch offset hashes (the kernel takes
    # their high word as an argument) against jax's own threefry2x32 on
    # the (hi, lo) words: its count's first half is x0, its second x1.
    from jax._src import prng as jprng

    k0, k1 = (int(w) for w in prng.key(7))
    c = np.arange(base, base + 9, dtype=np.uint64)
    hi = (c >> np.uint64(32)).astype(np.uint32)
    lo = (c & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out = np.asarray(jprng.threefry_2x32(
        (jnp.uint32(k0), jnp.uint32(k1)), jnp.asarray(np.concatenate([hi,
                                                                       lo]))))
    got = threefry.hash_counters(k0, k1, torch.from_numpy(c.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  out[:9] ^ out[9:])
    bits = threefry.threefry_bits(k0, k1, 9, "cpu", offset=base)
    np.testing.assert_array_equal(bits.numpy().view(np.uint32),
                                  out[:9] ^ out[9:])


# The span LubyMIS draws its priorities over, [0, 2**31 - 1): its
# multiplier squares 2**16 mod span to 2**32, which wraps to 0.
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (1000,), (4096,), (33, 7)])
def test_randint_at_the_mis_span_equal(seed, shape):
    want = np.asarray(jax.random.randint(jkey(seed), shape, 0, 2**31 - 1))
    got = prng.randint(prng.key(seed), shape, 0, 2**31 - 1, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0


# Sizes across the switch from one sort round to two (ceil(3 ln n /
# ln(2**32 - 1)) is 1 up to 1625, 2 from 1626), where two equal 32-bit
# keys among n are unlikely (p ~ n**2 / 2**33: 3e-4 at 100,000).
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 7, 1625, 1626, 100_000])
def test_permutation_equal(seed, n):
    want = np.asarray(jax.random.permutation(jkey(seed), n))
    got = prng.permutation(prng.key(seed), n, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    x = np.arange(n, dtype=np.int32) * 7 - 3
    np.testing.assert_array_equal(
        prng.permutation(prng.key(seed), torch.from_numpy(x)).numpy(),
        np.asarray(jax.random.permutation(jkey(seed), x)))


def test_permutation_ties_keep_input_order(monkeypatch):
    # XLA's sort_key_val is stable (is_stable=True by default), so equal
    # keys keep their input order; the port's sort is stable too. Equal
    # keys everywhere leave the input as it was.
    monkeypatch.setattr(prng, "random_bits", lambda k, shape, device=None:
                        torch.zeros(shape, dtype=torch.int32, device=device))
    x = torch.arange(5000, dtype=torch.int32)
    assert torch.equal(prng.permutation(prng.key(0), x), x)


@pytest.mark.parametrize("replace", [True, False])
@pytest.mark.parametrize("shape", [(), (5,), (2, 3), (40,)])
@pytest.mark.parametrize("seed", SEEDS)
def test_choice_equal(seed, shape, replace):
    want = np.asarray(jax.random.choice(jkey(seed), 50, shape,
                                        replace=replace))
    got = prng.choice(prng.key(seed), 50, shape, replace=replace,
                      device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    a = (np.arange(3000, dtype=np.int32) * 3 + 1)
    want = np.asarray(jax.random.choice(jkey(seed), a, shape,
                                        replace=replace))
    got = prng.choice(prng.key(seed), torch.from_numpy(a), shape,
                      replace=replace)
    np.testing.assert_array_equal(got.numpy(), want)


def test_choice_refusals():
    with pytest.raises(ValueError, match="larger sample"):
        prng.choice(prng.key(0), 3, (4,), replace=False, device="cpu")
    with pytest.raises(ValueError, match="greater than 0"):
        prng.choice(prng.key(0), 0, (1,), device="cpu")
    with pytest.raises(NotImplementedError, match="weights"):
        prng.choice(prng.key(0), 5, (2,), replace=False, p=torch.ones(5),
                    device="cpu")
    assert prng.choice(prng.key(0), 0, (0,), device="cpu").shape == (0,)
