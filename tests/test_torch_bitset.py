"""The port's packed predicates (``ops/bitset.py``) against the JAX
package's, bit for bit.

The port's words are ``int32`` holding the reference's ``uint32`` bit
patterns, so every comparison views them as ``uint32``. Inputs are numpy
draws from a seed; lengths include a ragged tail and words with bit 31
set (negative as ``int32``, where torch's ``>>`` is arithmetic)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from p2pnetwork_tpu.ops import bitset as JB  # noqa: E402
from p2pnetwork_tpu_torch.ops import bitset as TB  # noqa: E402


def _u32(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.int32
    return t.numpy().view(np.uint32)


def _bits(n, seed, density=0.4):
    bits = np.random.default_rng(seed).random(n) < density
    if n >= 64:
        bits[31] = bits[63] = True  # bit 31 of words 0 and 1
    return bits


@pytest.mark.parametrize("n", [32, 100, 4096])
def test_pack_and_unpack_are_bit_equal(n):
    bits = _bits(n, n)
    want = np.asarray(JB.pack_bits(jnp.asarray(bits)))
    got = TB.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(_u32(got), want)
    assert TB.n_words(n) == JB.n_words(n) == got.shape[0]
    np.testing.assert_array_equal(TB.unpack_bits(got, n).numpy(), bits)
    np.testing.assert_array_equal(
        TB.unpack_bits(got, n).numpy(),
        np.asarray(JB.unpack_bits(jnp.asarray(want), n)))


def test_a_word_with_bit_31_set():
    bits = np.zeros(64, dtype=bool)
    bits[31] = bits[32] = bits[63] = True
    got = TB.pack_bits(torch.from_numpy(bits))
    assert got.tolist() == [-2**31, 1 - 2**31]
    np.testing.assert_array_equal(_u32(got), np.asarray(
        JB.pack_bits(jnp.asarray(bits))))
    assert int(TB.popcount(got)) == 3
    idx = torch.tensor([30, 31, 32, 63], dtype=torch.int32)
    assert TB.test_bits(got, idx).tolist() == [False, True, True, True]


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_popcount_matches(density):
    bits = _bits(4096, 7, density) if density else np.zeros(4096, bool)
    words = TB.pack_bits(torch.from_numpy(bits))
    got = TB.popcount(words)
    assert got.dtype == torch.int32
    assert int(got) == int(JB.popcount(JB.pack_bits(jnp.asarray(bits))))
    assert int(got) == int(bits.sum())


def test_test_and_set_bits_match():
    rng = np.random.default_rng(5)
    bits = _bits(4096, 5)
    idx = rng.integers(0, 4096, 300).astype(np.int32)
    idx[:10] = idx[10:20]  # duplicates
    valid = rng.random(300) < 0.6
    jw = JB.pack_bits(jnp.asarray(bits))
    tw = TB.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(
        TB.test_bits(tw, torch.from_numpy(idx)).numpy(),
        np.asarray(JB.test_bits(jw, jnp.asarray(idx))))
    got = TB.set_bits(tw, torch.from_numpy(idx), torch.from_numpy(valid))
    want = JB.set_bits(jw, jnp.asarray(idx), jnp.asarray(valid))
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
