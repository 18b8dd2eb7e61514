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

Both also take the ring's stacked form (``parallel/sharded.py``): a
signal ``[S, B]`` and buckets ``[S, NB, W]`` give ``out [S, NB * block]``,
shard ``d``'s rows reading ``signal[d]``, in one launch. The buckets may
be a strided slice (``[:, t]`` of the ring's ``[S, S, NB, W]`` arrays):
the kernel takes the shard stride, so no copy is made; each shard's
``[NB, W]`` rows must be contiguous.

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
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for fn in (lib.p2p_segsum_or, lib.p2p_segsum_sum):
            fn.argtypes = [p, p, p, p, p, i, i, i, i, q, q, i, p]
            fn.restype = i
        _bound = lib
    return _bound


def _gather(signal, src):
    """``signal[src]``, per shard for a stacked ``[S, B]`` signal."""
    if signal.dim() == 1:
        return signal[src]
    flat = src.reshape(src.shape[0], -1).long()
    return signal.gather(1, flat).reshape(src.shape)


def _reduce(contrib, local_dst, block: int) -> torch.Tensor:
    """``out[..., n, b] = sum_w contrib[..., n, w] * (local_dst == b)``,
    flattened to ``[..., NB * block]``."""
    out = torch.zeros(*contrib.shape[:-1], block, dtype=contrib.dtype,
                      device=contrib.device)
    out.scatter_add_(-1, local_dst.long(), contrib)
    return out.flatten(-2)


def segsum_or_plain(signal, src, local_dst, mask, block: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`segsum_or`: bool[NB * block], or
    bool[S, NB * block] for a stacked signal."""
    contrib = (_gather(signal, src) & mask).to(torch.float32)
    return _reduce(contrib, local_dst, block) > 0


def segsum_sum_plain(signal, src, local_dst, mask, block: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`segsum_sum`: f32[NB * block], or
    f32[S, NB * block] for a stacked signal."""
    contrib = _gather(signal, src) * mask.to(signal.dtype)
    return _reduce(contrib, local_dst, block)


def bucket_geometry(name: str, signal, src, local_dst, mask, block: int):
    """Check a kernel's operands (device, dtypes, shapes, layout) and
    return ``(n_shards, rows_per_shard, width, bucket_stride,
    signal_stride)`` in elements. A 1-D signal with ``[NB, W]`` buckets is
    one shard; a ``[S, B]`` signal takes ``[S, NB, W]`` buckets whose
    per-shard rows are contiguous (any shard stride). The device type is
    checked last, so every other refusal shows on ``meta`` tensors."""
    dev = signal.device
    for t, what in ((src, "src"), (local_dst, "local_dst"), (mask, "mask")):
        if t.device != dev:
            raise ValueError(f"{name}: {what} is on {t.device}, signal on {dev}")
    if src.dtype != torch.int32 or src.dim() != signal.dim() + 1:
        raise ValueError(f"{name}: src must be i32[NB, W] for a 1-D signal "
                         f"or i32[S, NB, W] for an [S, B] one")
    if local_dst.dtype != torch.int32 or local_dst.shape != src.shape:
        raise ValueError(f"{name}: local_dst must be i32 of src's shape")
    if mask.dtype != torch.bool or mask.shape != src.shape:
        raise ValueError(f"{name}: mask must be bool of src's shape")
    if not 0 < block <= MAX_BLOCK:
        raise ValueError(f"{name}: block must be in [1, {MAX_BLOCK}], got {block}")
    if not signal.is_contiguous():
        raise ValueError(f"{name}: signal must be contiguous")
    if signal.dim() == 1:
        if not all(t.is_contiguous() for t in (src, local_dst, mask)):
            raise ValueError(f"{name}: operands must be contiguous")
        nb, w = src.shape
        geometry = 1, nb, w, nb * w, 0
    elif signal.dim() != 2 or src.shape[0] != signal.shape[0]:
        raise ValueError(f"{name}: a stacked signal is [S, B] with "
                         f"[S, NB, W] buckets, got {tuple(signal.shape)} and "
                         f"{tuple(src.shape)}")
    else:
        s, nb, w = src.shape
        strides = src.stride()
        if local_dst.stride() != strides or mask.stride() != strides or (
                nb > 1 and strides[1] != w) or (w > 1 and strides[2] != 1):
            raise ValueError(f"{name}: each shard's [NB, W] rows must be "
                             f"contiguous, with one stride for src, "
                             f"local_dst and mask")
        geometry = s, nb, w, strides[0], signal.stride(0)
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CPU or CUDA tensors, got {dev}")
    return geometry


def _launch(name: str, signal, src, local_dst, mask, block: int,
            signal_dtype, out_dtype) -> torch.Tensor:
    """Check the operands, allocate the output and launch the kernel on
    the current stream."""
    global LAUNCHES
    if signal.dtype != signal_dtype:
        raise ValueError(f"{name}: signal must be {signal_dtype}, got "
                         f"{signal.dtype}")
    s, nb, w, bucket_stride, signal_stride = bucket_geometry(
        name, signal, src, local_dst, mask, block)
    dev = signal.device
    out = torch.empty(*src.shape[:-2], nb * block, dtype=out_dtype, device=dev)
    if s * nb == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(_lib(), "p2p_" + name)(
        signal.data_ptr(), src.data_ptr(), local_dst.data_ptr(),
        mask.data_ptr(), out.data_ptr(), s, nb, w, block, bucket_stride,
        signal_stride, dev.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return out


def segsum_or(signal, src, local_dst, mask, block: int) -> torch.Tensor:
    """``out[n*block + b] = any(signal[src[n, w]] & mask[n, w]
    for w with local_dst[n, w] == b)`` — bool[NB * block], or
    bool[S, NB * block] for a stacked ``[S, B]`` signal."""
    if signal.device.type == "cpu":
        return segsum_or_plain(signal, src, local_dst, mask, block)
    return _launch("segsum_or", signal, src, local_dst, mask, block,
                   torch.bool, torch.bool)


def segsum_sum(signal, src, local_dst, mask, block: int) -> torch.Tensor:
    """``out[n*block + b] = sum(signal[src[n, w]] * mask[n, w]
    for w with local_dst[n, w] == b)`` — f32[NB * block], or
    f32[S, NB * block] for a stacked ``[S, B]`` signal."""
    if signal.device.type == "cpu":
        return segsum_sum_plain(signal, src, local_dst, mask, block)
    return _launch("segsum_sum", signal, src, local_dst, mask, block,
                   torch.float32, torch.float32)
