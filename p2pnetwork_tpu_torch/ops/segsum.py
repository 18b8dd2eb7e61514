"""Blocked segment sum: the hand-written CUDA kernel and its plain version.

Replaces ``p2pnetwork_tpu/ops/pallas_edge.py::_segsum_kernel`` (launched
by ``segment_sum_pallas_impl``). For every node-block row ``n``:

    out[n, b] = sum_w signal[src[n, w]] * mask[n, w] * (local_dst[n, w] == b)

The TPU kernel built a one-hot ``[W, block]`` in VMEM and fed it to the
MXU, after XLA had gathered ``signal[src] * mask`` into HBM. On Hopper the
work is ~1 operation per 9 bytes read (``src`` i32 + ``local_dst`` i32 +
``mask`` u8 per slot), far below the card's compute/bandwidth balance, so
the kernel is bound by bytes. Its design (``csrc/segsum.cu``) moves only
those bytes: the gather is fused in, the one-hot never exists, and each
row reduces into a ``block``-wide accumulator in shared memory. At the
1M-node hybrid remainder (``[1954, 640]``, ``block=512``) that is ~11 MB
per round; the ``pallas`` method's blocked layout (``[7813, 1408]``,
``block=128``) ~99 MB.

Two entry points:

- :func:`segsum_or` — bool ``signal``: ``out`` is whether any term is set.
  Flags written into shared memory are idempotent, so it is bit-exact.
- :func:`segsum_sum` — f32 ``signal``, f32 accumulation with shared-memory
  atomics whose order changes from run to run. Exact on integer-valued
  signals (< 2^24); on general f32 it is held to ``rtol = atol = 1e-5``
  against the plain version (the reference's own tolerance for its
  kernel, ``tests/test_blocked_pallas.py``).

A CUDA tensor always goes to the kernel (or the wrapper raises); a CPU
tensor goes to the plain version. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from p2pnetwork_tpu_torch import _build

#: Kernel launches made by :func:`segsum_or` and :func:`segsum_sum`.
LAUNCHES = 0

#: Largest ``block`` the kernel takes: its f32 accumulator lives in the
#: 48 KB of shared memory a block gets without opting in to more.
MAX_BLOCK = 12288

_bound = None


def _lib() -> ctypes.CDLL:
    """The kernel library with its C signatures declared (built on first
    use)."""
    global _bound
    if _bound is None:
        lib = _build.library()
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.p2p_segsum_or, lib.p2p_segsum_sum):
            fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
            fn.restype = i
        _bound = lib
    return _bound


def segsum_or_plain(signal, src, local_dst, mask, block: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`segsum_or`: bool[NB * block]."""
    contrib = (signal[src] & mask).to(torch.float32)
    out = torch.zeros(src.shape[0], block, dtype=torch.float32,
                      device=src.device)
    out.scatter_add_(1, local_dst.long(), contrib)
    return (out > 0).reshape(-1)


def segsum_sum_plain(signal, src, local_dst, mask, block: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`segsum_sum`: f32[NB * block]."""
    contrib = signal[src] * mask.to(signal.dtype)
    out = torch.zeros(src.shape[0], block, dtype=signal.dtype,
                      device=src.device)
    out.scatter_add_(1, local_dst.long(), contrib)
    return out.reshape(-1)


def _launch(name: str, signal, src, local_dst, mask, block: int,
            signal_dtype, out_dtype) -> torch.Tensor:
    """Check the operands, allocate the output and launch the kernel on
    the current stream."""
    global LAUNCHES
    dev = signal.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CPU or CUDA tensors, got {dev}")
    for t, what in ((src, "src"), (local_dst, "local_dst"), (mask, "mask")):
        if t.device != dev:
            raise ValueError(f"{name}: {what} is on {t.device}, signal on {dev}")
    if signal.dtype != signal_dtype or signal.dim() != 1:
        raise ValueError(f"{name}: signal must be 1-D {signal_dtype}, got "
                         f"{signal.dtype} of shape {tuple(signal.shape)}")
    if src.dim() != 2 or src.dtype != torch.int32:
        raise ValueError(f"{name}: src must be i32[NB, W]")
    if local_dst.dtype != torch.int32 or local_dst.shape != src.shape:
        raise ValueError(f"{name}: local_dst must be i32 of src's shape")
    if mask.dtype != torch.bool or mask.shape != src.shape:
        raise ValueError(f"{name}: mask must be bool of src's shape")
    if not 0 < block <= MAX_BLOCK:
        raise ValueError(f"{name}: block must be in [1, {MAX_BLOCK}], got {block}")
    if not all(t.is_contiguous() for t in (signal, src, local_dst, mask)):
        raise ValueError(f"{name}: operands must be contiguous")
    nb, w = src.shape
    out = torch.empty(nb * block, dtype=out_dtype, device=dev)
    if nb == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(_lib(), "p2p_" + name)(
        signal.data_ptr(), src.data_ptr(), local_dst.data_ptr(),
        mask.data_ptr(), out.data_ptr(), nb, w, block, dev.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return out


def segsum_or(signal, src, local_dst, mask, block: int) -> torch.Tensor:
    """``out[n*block + b] = any(signal[src[n, w]] & mask[n, w]
    for w with local_dst[n, w] == b)`` — bool[NB * block]."""
    if signal.device.type == "cpu":
        return segsum_or_plain(signal, src, local_dst, mask, block)
    return _launch("segsum_or", signal, src, local_dst, mask, block,
                   torch.bool, torch.bool)


def segsum_sum(signal, src, local_dst, mask, block: int) -> torch.Tensor:
    """``out[n*block + b] = sum(signal[src[n, w]] * mask[n, w]
    for w with local_dst[n, w] == b)`` — f32[NB * block]."""
    if signal.device.type == "cpu":
        return segsum_sum_plain(signal, src, local_dst, mask, block)
    return _launch("segsum_sum", signal, src, local_dst, mask, block,
                   torch.float32, torch.float32)
