"""Counter-based random numbers, bit for bit those of ``jax.random``
(jax 0.9.0's default threefry2x32 with ``jax_threefry_partitionable``
on), under ``jax.random``'s names.

A key is two u32 words held on the host: numpy ``uint32[2]``, or
``uint32[..., 2]`` for the keys a :func:`split` returns. ``split`` and
``fold_in`` hash a handful of words, so they run here in numpy, exactly,
with no device launch and no sync. Only draws over a shape touch the
device: the key's two words go to the kernel (``ops/threefry.py``) as
scalar arguments, and the kernel writes one u32 per element,
``bits1 ^ bits2`` of ``threefry2x32(key, hi(i), lo(i))`` over the flat
index ``i`` (jax's ``_threefry_random_bits_partitionable``).

The samplers follow ``jax/_src/random.py``: ``uniform`` sets the top 23
bits as an f32 mantissa in [1, 2) (``_uniform``), ``randint`` reduces two
32-bit draws by span and multiplier in wrapping u32 arithmetic
(``_randint``), ``bernoulli`` is ``uniform < p`` (``_bernoulli``),
``permutation`` sorts by rounds of 32-bit keys (``_shuffle``), ``choice``
with ``p=None`` is ``randint`` with replacement and a prefix of
``permutation`` without, and ``normal`` is ``sqrt(2) *
erf_inv(uniform(nextafter(-1, 0), 1))`` (``_normal_real``). All are
exact: ``normal``'s ``erf_inv`` is XLA's single-precision polynomial
(Giles) and its ``log1p`` the routine XLA's CPU code inlines
(:func:`log1p_f32`), both with the fused multiply-adds XLA's CPU code
makes, evaluated in torch.

``permutation``'s sorts are stable, as XLA's ``sort_key_val`` is by
default (``is_stable=True``): two equal 32-bit keys keep their input
order. A weighted ``choice`` (``p=``) with replacement is jax's
inverse-CDF draw over XLA's CPU prefix sum (:func:`cumsum_f32`); without
replacement it is not ported, nor is ``categorical`` (nothing in the JAX
package calls it).

This is the port's explicit generator for simulations that must be
checkable against the reference. It does not replace ``torch.Generator``,
which gives other numbers. Only f32 floats and i32 integers are drawn,
the types the protocols use.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from p2pnetwork_tpu_torch import _device
from p2pnetwork_tpu_torch.ops import threefry as TF
from p2pnetwork_tpu_torch.ops.threefry import threefry2x32


def _check_key(k) -> np.ndarray:
    k = np.asarray(k)
    if k.dtype != np.uint32 or k.shape != (2,):
        raise TypeError(f"expected a single key (uint32[2]), got "
                        f"{k.dtype}{list(k.shape)}")
    return k


def key(seed: int) -> np.ndarray:
    """The key of an integer seed: ``[0, seed mod 2**32]``, as jax without
    x64 makes it (``key(2**32 + 5)`` is ``[0, 5]``, ``key(-1)`` is
    ``[0, 0xffffffff]``)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


PRNGKey = key


def key_data(k) -> np.ndarray:
    """The key's u32 words (a copy)."""
    return np.array(k, dtype=np.uint32)


def wrap_key_data(data) -> np.ndarray:
    """A key from its u32 words, e.g. ``jax.random.key_data(k)`` as
    numpy."""
    data = np.array(data)
    if data.dtype != np.uint32 or data.shape[-1:] != (2,):
        raise TypeError(f"key data must be uint32[..., 2], got "
                        f"{data.dtype}{list(data.shape)}")
    return data


def split(k, num=2) -> np.ndarray:
    """``num`` new keys (``uint32[*num, 2]``) — jax's fold-like split
    (``prng.py::_threefry_split_foldlike``): key ``i`` is the hash of the
    counter pair ``(i >> 32, i & 0xffffffff)`` over the flat index."""
    k0, k1 = (int(w) for w in _check_key(k))
    shape = tuple(num) if isinstance(num, (tuple, list)) else (int(num),)
    words = [threefry2x32(k0, k1, i >> 32, i & 0xFFFFFFFF)
             for i in range(math.prod(shape))]
    return np.array(words, dtype=np.uint32).reshape(*shape, 2)


def fold_in(k, data: int) -> np.ndarray:
    """A new key from ``k`` and a 32-bit integer: threefry of the pair
    ``threefry_seed(data) = [0, data]`` (``prng.py::_threefry_fold_in``)."""
    k0, k1 = (int(w) for w in _check_key(k))
    return np.array(threefry2x32(k0, k1, 0, int(data) & 0xFFFFFFFF),
                    dtype=np.uint32)


def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def random_bits(k, shape, *, device=None) -> torch.Tensor:
    """32 random bits per element, as ``int32`` with the u32 pattern
    (``jax.random.bits`` viewed as int32)."""
    k, shape = _check_key(k), _shape(shape)
    return TF.threefry_bits(int(k[0]), int(k[1]), math.prod(shape),
                            _device.resolve(device)).reshape(shape)


def uniform(k, shape=(), minval=0.0, maxval=1.0, *,
            device=None) -> torch.Tensor:
    """f32 uniform on ``[minval, maxval)``: the draw's top 23 bits as a
    mantissa in [1, 2), minus 1, scaled and shifted in f32, then
    ``max(minval, .)``."""
    k, shape = _check_key(k), _shape(shape)
    lo = np.float32(minval)
    return TF.threefry_uniform(int(k[0]), int(k[1]), math.prod(shape),
                               float(lo), float(np.float32(maxval) - lo),
                               _device.resolve(device)).reshape(shape)


#: XLA's single-precision ``erf_inv`` (Giles' polynomials), by branch.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


#: XLA's f32 ``log1p``: the rational approximation below ``|x| <
#: sqrt(2) - 1`` (numerator, then denominator, highest power first after
#: the leading 1), Cephes' ``logf`` polynomial in three interleaved parts
#: above it, and the split of ``ln 2`` (``jnp.log1p``'s LLVM IR,
#: ``XLA_FLAGS=--xla_dump_to``, jax 0.9.0).
_LOG1P_NUM = (0.00004527, 0.49854103, 6.5787325, 29.911919, 60.94967,
              57.112965, 20.039553)
_LOG1P_DEN = (15.062909, 83.04757, 221.7624, 309.09872, 216.42789,
              60.11866)
_LOG_POLY = ((0.070376836, -0.1151461, 0.116769984),
             (-0.12420141, 0.14249323, -0.16668057),
             (0.20000714, -0.24999994, 0.3333333))
_LOG1P_SMALL = 0.41421357
_LN2_HI, _LN2_LO = 0.693359375, -0.00021219444


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``log1p`` as XLA's CPU code computes it, op for op, with the
    fused multiply-adds its compiler makes (an add of a product used once
    is one rounding, :func:`ops.threefry.fma_f32`)."""
    def c(v):
        return torch.tensor(v, dtype=torch.float32, device=x.device)

    fma = TF.fma_f32
    # |x| below sqrt(2) - 1: x - x^2 / 2 + x^3 * P(x) / Q(x).
    x2 = x * x
    x0 = x * 0.0  # NaN for an infinite x, as XLA's
    num, den = x0 + _LOG1P_NUM[0], x0 + 1.0
    for a in _LOG1P_NUM[1:]:
        num = fma(num, x, a)
    for a in _LOG1P_DEN:
        den = fma(den, x, a)
    small = x + fma(x2, -0.5, (x * x2) * (num / den))
    # Otherwise log(1 + x): 1 + x = 2^e * m with m in [sqrt(1/2), sqrt(2)).
    y = x + 1.0
    bits = torch.where(y > 1.17549435e-38, y, c(1.17549435e-38)).view(
        torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    below = m < 0.70710677
    e = (((bits >> 23) - 127).float() + 1.0) - below.float()
    f = (m + -1.0) + torch.where(below, m, c(0.0))
    f2 = f * f
    f3 = f2 * f
    p = [fma(fma(f, a0, a1), f, a2) for a0, a1, a2 in _LOG_POLY]
    poly = fma(fma(p[0], f3, p[1]), f3, p[2])
    large = fma(e, _LN2_HI, (f - f2 * 0.5) + fma(poly, f3, e * _LN2_LO))
    large = torch.where(y > 0, large, c(float("nan")))
    large = torch.where(y == 0, c(-float("inf")), large)
    large = torch.where(y == float("inf"), c(float("inf")), large)
    return torch.where(x.abs() < _LOG1P_SMALL, small, large)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """f32 ``erf_inv`` as XLA computes it: Giles' polynomial in
    ``w = -log1p(-x*x)``, two branches split at ``w = 5``, ``±inf`` at
    ``|x| = 1``."""
    w = -log1p_f32(-x * x)
    small = w < 5.0
    # The root taken in f64 and rounded to f32 is the correctly rounded
    # f32 root, as XLA's is; torch's f32 sqrt on the CPU is one ulp off on
    # ~0.7% of inputs (ROADMAP section C).
    w = torch.where(small, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0]).to(x.dtype)
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = TF.fma_f32(p, w, torch.where(small, a, b))
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)


def normal(k, shape=(), *, device=None) -> torch.Tensor:
    """f32 standard normal: ``sqrt(2) * erf_inv(u)`` with ``u`` uniform
    on ``[nextafter(-1, 0), 1)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(k, shape, lo, 1.0, device=device)
    return float(np.float32(np.sqrt(2))) * erf_inv(u)


_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def randint(k, shape, minval: int, maxval, *,
            device=None) -> torch.Tensor:
    """i32 uniform-ish on ``[minval, maxval)`` by jax's reduction: two
    32-bit draws from ``split(k)``, each taken mod ``span``, combined
    with ``multiplier = ((2**16 mod span)**2 mod 2**32) mod span``, all in
    wrapping u32 (so the multiplier is 0 for spans above 2**16).
    ``maxval`` may be an integer tensor broadcast against ``shape`` (a
    bound per element, as the reference's traced ``maxval``); the draws
    then land on its device."""
    shape = _shape(shape)
    minval = int(minval)
    if isinstance(maxval, torch.Tensor):
        # maxval <= minval gives span 1, so minval is always returned.
        span = torch.where(maxval > minval, maxval.long() - minval, 1)
        device = maxval.device
    else:
        maxval = int(maxval)
        if not (_I32_MIN <= min(minval, maxval) <= max(minval, maxval)
                <= _I32_MAX):
            raise OverflowError(f"randint bounds must be i32, got "
                                f"[{minval}, {maxval})")
        span = maxval - minval if maxval > minval else 1
    k1, k2 = split(k)
    mult = ((2**16 % span) ** 2 & 0xFFFFFFFF) % span  # the square wraps
    mask = 0xFFFFFFFF
    higher = random_bits(k1, shape, device=device).long() & mask
    lower = random_bits(k2, shape, device=device).long() & mask
    # mult is nonzero only for spans up to 2**16, so the product stays
    # below 2**32 and i64 holds every step exactly.
    offset = ((higher % span) * mult + lower % span) & mask
    offset = offset % span
    return TF.to_i32((offset + minval) & mask)


def bernoulli(k, p: float = 0.5, shape=(), *, device=None) -> torch.Tensor:
    """bool: ``uniform(k, shape) < f32(p)``."""
    return uniform(k, shape, device=device) < float(np.float32(p))


def _shuffle(k, x: torch.Tensor) -> torch.Tensor:
    """``jax.random``'s ``_shuffle`` along axis 0: ``ceil(3 ln(n) /
    ln(2**32 - 1))`` rounds, each ``k, sub = split(k)`` and a stable sort
    of ``x`` by 32-bit keys ``random_bits(sub, (n,))`` taken unsigned."""
    n = x.shape[0]
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        k, sub = split(k)
        bits = random_bits(sub, (n,), device=x.device)
        # Flipping the sign bit orders the words as unsigned.
        order = torch.sort(bits ^ _I32_MIN, stable=True).indices
        x = x[order]
    return x


def permutation(k, x, *, device=None) -> torch.Tensor:
    """A random permutation of ``arange(x)`` (an int ``x``; i32) or of a
    1-D tensor's elements, as ``jax.random.permutation`` makes it."""
    _check_key(k)
    if isinstance(x, int):
        x = torch.arange(x, dtype=torch.int32,
                         device=_device.resolve(device))
    elif x.dim() != 1:
        raise ValueError("permutation takes an int or a 1-D tensor")
    return _shuffle(k, x)


def cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum of a 1-D tensor with the rounding of
    ``jnp.cumsum`` on the CPU: XLA rewrites the scan's reduce-window into
    blocks of 16, each summed left to right from 0, the blocks' totals
    scanned the same way (recursively), and each block's exclusive prefix
    added to its sums (``tests/test_torch_membership.py`` pins it against
    jax). ``torch.cumsum`` rounds in another order."""
    n = x.shape[0]
    if n <= _SCAN_BLOCK:
        return _scan_columns(x[None, :])[0]
    blocks = torch.nn.functional.pad(x, (0, -n % _SCAN_BLOCK)).reshape(
        -1, _SCAN_BLOCK)
    local = _scan_columns(blocks)
    totals = cumsum_f32(local[:, -1].contiguous())
    prefix = torch.cat([totals.new_zeros(1), totals[:-1]])
    return (local + prefix[:, None]).reshape(-1)[:n]


#: XLA's CPU reduce-window rewrite block (``cumsum_f32``).
_SCAN_BLOCK = 16


def _scan_columns(rows: torch.Tensor) -> torch.Tensor:
    """Each row's inclusive prefix sums, left to right from 0."""
    cols = [rows[:, 0] + 0.0]
    for j in range(1, rows.shape[1]):
        cols.append(cols[-1] + rows[:, j])
    return torch.stack(cols, dim=1)


def choice(k, a, shape=(), replace: bool = True, p=None, *,
           device=None) -> torch.Tensor:
    """``shape`` draws from ``arange(a)`` (an int ``a``) or from a 1-D
    tensor's elements. Uniformly: with replacement ``randint(k, shape, 0,
    n)`` indexes them, without it the first draws of :func:`permutation`.
    With weights ``p`` (f32, one per element) and replacement, jax's
    inverse-CDF draw: ``c = cumsum(p)`` (:func:`cumsum_f32`), ``r = c[-1]
    * (1 - uniform(k, shape))`` and the first index with ``c >= r``. A
    weighted draw without replacement (jax's Gumbel top-k) is not
    ported."""
    shape = _shape(shape)
    n = a if isinstance(a, int) else a.shape[0]
    if not isinstance(a, int) and a.dim() != 1:
        raise ValueError("choice takes an int or a 1-D tensor")
    dev = _device.resolve(device) if isinstance(a, int) else a.device
    if p is not None and not replace:
        raise NotImplementedError("choice with weights p and "
                                  "replace=False is not ported")
    n_draws = math.prod(shape)
    if n_draws == 0:
        return torch.zeros(shape, dtype=torch.int32 if isinstance(a, int)
                           else a.dtype, device=dev)
    if n <= 0:
        raise ValueError("a must be greater than 0 unless no samples are "
                         "taken")
    if p is not None:
        p = torch.as_tensor(p, device=dev).to(torch.float32)
        if p.shape != (n,):
            raise ValueError(
                f"p must be None or a 1D vector with the same size as "
                f"a.shape[0]. p has shape {tuple(p.shape)} and a.shape[0] "
                f"is {n}.")
        cuml = cumsum_f32(p)
        r = cuml[-1] * (1.0 - uniform(k, shape, device=dev))
        ind = torch.searchsorted(cuml, r.reshape(-1)).reshape(shape)
        ind = ind.to(torch.int32)
        return ind if isinstance(a, int) else a[ind.long()]
    if replace:
        ind = randint(k, shape, 0, n, device=dev)
        return ind if isinstance(a, int) else a[ind.long()]
    if n_draws > n:
        raise ValueError(f"Cannot take a larger sample (size {n_draws}) "
                         f"than population (size {n}) when 'replace=False'")
    return permutation(k, a, device=dev)[:n_draws].reshape(shape)
