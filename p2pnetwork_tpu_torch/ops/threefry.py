"""Random bits by threefry2x32: the hand-written CUDA kernel and its plain
version.

Not a TPU kernel's counterpart: the JAX package draws its random numbers
through ``jax.random``, whose threefry XLA fuses into one pass over the
counters. Without a kernel, the plain torch version below is some 150
elementwise launches per draw (20 rounds of add, rotate and xor on i64
masked to 32 bits), which would be most of a round's device time in a
protocol that draws every round (SIR draws twice). ``csrc/threefry.cu``
does it in one launch per 2**32 counters: ``COUNTERS_PER_THREAD``
consecutive counters a thread, computing ``threefry2x32(k0, k1, hi(i),
lo(i))`` in registers and writing ``bits1 ^ bits2`` — jax's
``_threefry_random_bits_partitionable`` — or, for
:func:`threefry_uniform`, the f32 ``uniform`` of those bits (``prng.py``).
It is integer work, 68 instructions per 4-byte store at the least, of
which the 41 rotations and xors run only on the ALU pipe, so that pipe
bounds it, not the bytes; the kernel's 4-counter loop issues its adds on
the FMA pipe. A draw of at most one wave of threads takes a counter a
thread.

A CPU ``device`` takes the plain version; a CUDA one launches the kernel
or raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from p2pnetwork_tpu_torch import _build

#: Kernel launches made by :func:`threefry_bits` and
#: :func:`threefry_uniform`.
LAUNCHES = 0

#: Counters a thread of the kernel hashes per pass of its loop (its
#: ``kPerThread``), stored as one 16-byte vector.
COUNTERS_PER_THREAD = 4

#: The least instructions per counter on Hopper, by pipe (the built
#: kernel's SASS holds these and its loop's own, ``chip_smoke.py`` phase
#: 3c). Only the ALU pipe takes the 20 rotations (one funnel shift each)
#: and the 21 xors. The 27 adds (20 in the rounds, x1's seeding and its 5
#: key injections, x0's last injection; x0's seeding and other injections
#: fold into three-input adds) issue on the ALU or the FMA pipe. (The
#: kernel's 4-counter loop spends 4 more, as IMADs on the FMA pipe, which
#: has no three-input add.)
ALU_OPS = 20 + 21
ADD_OPS = 20 + 1 + 5 + 1
#: The uniform epilogue: the shift-or (one ``LEA.HI``) and the max on the
#: ALU pipe, the subtract and the fused multiply-add on the FMA pipe.
UNIFORM_ALU_OPS = 2
UNIFORM_FMA_OPS = 2

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF

_bound = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = _build.library()
        u, w, q, f, i, p = (ctypes.c_uint32, ctypes.c_uint64,
                            ctypes.c_int64, ctypes.c_float, ctypes.c_int,
                            ctypes.c_void_p)
        lib.p2p_threefry_bits.argtypes = [u, u, w, q, p, i, p]
        lib.p2p_threefry_uniform.argtypes = [u, u, w, q, f, f, p, i, p]
        lib.p2p_threefry_bits.restype = lib.p2p_threefry_uniform.restype = i
        _bound = lib
    return _bound


def to_i32(v: torch.Tensor) -> torch.Tensor:
    """Values in ``[0, 2**32)`` (i64) as i32 with the same bit pattern."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def threefry2x32(k0, k1, x0, x1) -> tuple:
    """The threefry2x32 block of jax (``prng.py::_threefry2x32_lowering``)
    on u32 words: Python ints (a key split, ``prng.py``) or i64 tensors
    of values in ``[0, 2**32)`` (the plain version's counters)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = (x0 + k0) & _M32, (x1 + k1) & _M32
    for g in range(5):
        for r in _ROT[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & _M32
    return x0, x1


def hash_counters(k0: int, k1: int, i: torch.Tensor) -> torch.Tensor:
    """``bits1 ^ bits2`` of threefry2x32 at the i64 counters ``i``, as i64
    in ``[0, 2**32)``."""
    x0, x1 = threefry2x32(k0, k1, i >> 32, i & _M32)
    return x0 ^ x1


def _bits_u32(k0: int, k1: int, n: int, device,
              offset: int = 0) -> torch.Tensor:
    return hash_counters(k0, k1, torch.arange(offset, offset + n,
                                              dtype=torch.int64,
                                              device=device))


def threefry_bits_plain(k0: int, k1: int, n: int, device,
                        offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`threefry_bits`."""
    return to_i32(_bits_u32(k0, k1, n, device, offset))


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to f32, as a fused multiply-add does
    (XLA contracts ``floats * scale + minval`` into one on the CPU, and
    the kernel calls ``__fmaf_rn``). ``a`` is f32; ``b`` and ``c`` are f32
    values (tensors or numbers). The f64 product is exact; the f64 sum
    is rounded to odd (TwoSum gives its error) so that the last rounding,
    to f32, is the only one that counts."""
    def f64(v):
        return torch.as_tensor(v, device=a.device).to(torch.float32).double()

    p = a.double() * f64(b)
    c = f64(c)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    odd = (s.view(torch.int64) & 1) == 1
    s = torch.where((err != 0) & ~odd, torch.nextafter(s, s + err), s)
    return s.to(torch.float32)


def threefry_uniform_plain(k0: int, k1: int, n: int, minval: float,
                           scale: float, device,
                           offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`threefry_uniform`."""
    mant = to_i32((_bits_u32(k0, k1, n, device, offset) >> 9) | 0x3F800000)
    floats = mant.view(torch.float32) - 1.0
    return fma_f32(floats, scale, minval).clamp_min(minval)


def launch_spans(offset: int, n: int) -> list:
    """The kernel launches of a draw of ``n`` counters from ``offset``:
    ``(offset, count)`` pieces in order, none crossing a multiple of
    ``2**32``, so that each launch's counters share their high word and
    count in 32 bits."""
    spans = []
    while n > 0:
        count = min(n, 2**32 - (offset & _M32))
        spans.append((offset, count))
        offset, n = offset + count, n - count
    return spans


def _launch(name: str, n: int, dtype, device, k0: int, k1: int, offset: int,
            *extra) -> torch.Tensor:
    """Allocate the output and launch ``p2p_<name>`` on the current
    stream once per :func:`launch_spans` piece: ``(k0, k1, offset, count,
    *extra, out, device, stream)``."""
    global LAUNCHES
    if device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA device, got {device}")
    if offset < 0 or offset + n > 2**64:
        raise ValueError(f"{name}: counters [{offset}, {offset + n}) leave "
                         f"the 64-bit range")
    out = torch.empty(n, dtype=dtype, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    at = 0
    for start, count in launch_spans(offset, n):
        rc = getattr(_lib(), "p2p_" + name)(
            k0, k1, start, count, *extra, out.data_ptr() + 4 * at,
            device.index or 0, stream)
        if rc != 0:
            raise RuntimeError(f"{name}: kernel launch failed with CUDA "
                               f"error {rc}")
        LAUNCHES += 1
        at += count
    return out


def threefry_bits(k0: int, k1: int, n: int, device,
                  offset: int = 0) -> torch.Tensor:
    """i32[n]: the u32 pattern of ``bits1 ^ bits2`` of
    ``threefry2x32((k0, k1), (i >> 32, i & 0xffffffff))`` for each
    counter ``offset <= i < offset + n``."""
    device = torch.device(device)
    if device.type == "cpu":
        return threefry_bits_plain(k0, k1, n, device, offset)
    return _launch("threefry_bits", n, torch.int32, device, k0, k1, offset)


def threefry_uniform(k0: int, k1: int, n: int, minval: float, scale: float,
                     device, offset: int = 0) -> torch.Tensor:
    """f32[n]: ``max(minval, (mantissa(bits) - 1) * scale + minval)``, the
    f32 ``uniform`` of :func:`threefry_bits` (``scale`` is the f32
    ``maxval - minval``)."""
    device = torch.device(device)
    if device.type == "cpu":
        return threefry_uniform_plain(k0, k1, n, minval, scale, device,
                                      offset)
    return _launch("threefry_uniform", n, torch.float32, device, k0, k1,
                   offset, minval, scale)
