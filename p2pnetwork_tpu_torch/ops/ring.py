"""Ring halo hop and fused ring step: the hand-written CUDA kernels and
their plain versions, for a ring whose S shards are stacked on one card.

Replaces ``p2pnetwork_tpu/ops/pallas_ring.py``:

- :func:`ring_shift` — ``_ring_halo_copy_kernel`` (B2), one hop: forward,
  shard ``d`` receives shard ``(d - 1) mod S``'s block (``lax.ppermute``
  with ``[(i, (i + 1) % S)]``); ``reverse=True`` the other way. The
  identity at ``S = 1``.
- :func:`ring_segment_sum_or` / :func:`ring_segment_sum_sum` —
  ``_ring_halo_segsum_kernel`` (B3), ``(rot_next, out)``: the forward hop
  of ``rot`` fused into the same launch as B1's segment sum of every
  shard's bucket, shard ``d``'s rows reading ``rot[d, src]``
  (``ops/segsum.py``). ``S < 2`` is refused, as the reference refuses it.

On the TPU each shard is a chip and the hop a DMA between chips. Here the
shards are the leading axis of one tensor, so the hop is a device-local
copy with a rotated shard index (``csrc/ring.cu``), out of place: the ring
issues it before the step's bucket applies, which read the resident
block. Both kernels are bound by device-memory bytes: B2 reads and writes
each byte once (~0.6 us for the bool ``[8, 125008]`` frontier at
3.35 TB/s, so launch latency dominates); in B3 the bucket bytes of B1
dominate and the hop rides in copy blocks beside the row reductions.
B3 takes each row's extent (``ShardedGraph.mxu_extent``): the ring's
buckets are padded to the widest, and on a graph whose edges are mostly
local (the 1M Watts-Strogatz ring) every step's rows but the first are
nearly all padding, which B3 then does not read.

Exactness: the hop and OR are bit-exact. The f32 sum adds in f32 with
shared-memory atomics: exact on integer-valued signals, otherwise held to
``rtol = atol = 1e-5``; non-finite terms spread over their row as the
reference's one-hot product spreads them (``ops/segsum.py``). The reference asks for ``exact=False`` there (one
bf16 pass on a TPU, f32 on the CPU interpreter); the port always sums
f32 terms.

A CUDA tensor always goes to the kernel (or the wrapper raises); a CPU
tensor goes to the plain version. ``SHIFT_LAUNCHES`` and
``SEGSUM_LAUNCHES`` count kernel launches; ``SHIFT_BACK_LAUNCHES`` counts
the reverse hops among B2's (the liveness re-mask's Horner fold,
``parallel/sharded.py``).
"""

from __future__ import annotations

import ctypes

import torch

from p2pnetwork_tpu_torch import _build
from p2pnetwork_tpu_torch.ops import segsum

#: Kernel launches made by :func:`ring_shift`, both directions.
SHIFT_LAUNCHES = 0
#: Those of them with ``reverse=True``.
SHIFT_BACK_LAUNCHES = 0
#: Kernel launches made by :func:`ring_segment_sum_or` / ``_sum``.
SEGSUM_LAUNCHES = 0

_bound = None


def _lib() -> ctypes.CDLL:
    """The kernel library with the ring entries' C signatures declared."""
    global _bound
    if _bound is None:
        lib = _build.library()
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.p2p_ring_shift.argtypes = [p, p, i, q, i, i, p]
        lib.p2p_ring_shift.restype = i
        for fn in (lib.p2p_ring_segsum_or, lib.p2p_ring_segsum_sum):
            fn.argtypes = [p, p, q, p, p, p, p, q, p, i, i, i, i, q, i, p]
            fn.restype = i
        _bound = lib
    return _bound


def ring_shift_plain(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`ring_shift`."""
    return torch.roll(x, -1 if reverse else 1, dims=0)


def ring_shift(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """One ring hop of the stacked ``x [S, ...]`` (any dtype): a new
    tensor with ``out[d] = x[(d - 1) mod S]``, or ``x[(d + 1) mod S]``
    with ``reverse=True``. Returns ``x`` itself at ``S = 1``."""
    global SHIFT_LAUNCHES, SHIFT_BACK_LAUNCHES
    if x.dim() < 1:
        raise ValueError("ring_shift: x must have a leading shard axis")
    if x.shape[0] == 1:
        return x
    if x.device.type == "cpu":
        return ring_shift_plain(x, reverse)
    if not x.is_contiguous():
        raise ValueError("ring_shift: x must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"ring_shift: expected CPU or CUDA tensors, got "
                         f"{x.device}")
    out = torch.empty_like(x)
    shard_bytes = x[0].numel() * x.element_size()
    if shard_bytes == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().p2p_ring_shift(x.data_ptr(), out.data_ptr(), x.shape[0],
                               shard_bytes, int(reverse),
                               x.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"ring_shift: kernel launch failed with CUDA "
                           f"error {rc}")
    SHIFT_LAUNCHES += 1
    SHIFT_BACK_LAUNCHES += int(reverse)
    return out


def _check_ring(name: str, rot) -> None:
    if rot.dim() != 2 or rot.shape[0] < 2:
        raise ValueError(f"{name} needs a ring of >= 2 shards: rot must be "
                         f"[S >= 2, B], got {tuple(rot.shape)}")


def ring_segment_sum_or_plain(rot, src, local_dst, mask, block: int):
    """Plain PyTorch version of :func:`ring_segment_sum_or`, every row at
    its full width."""
    _check_ring("ring_segment_sum_or", rot)
    return (ring_shift_plain(rot),
            segsum.segsum_or_plain(rot, src, local_dst, mask, block))


def ring_segment_sum_sum_plain(rot, src, local_dst, mask, block: int):
    """Plain PyTorch version of :func:`ring_segment_sum_sum`, every row at
    its full width."""
    _check_ring("ring_segment_sum_sum", rot)
    return (ring_shift_plain(rot),
            segsum.segsum_sum_plain(rot, src, local_dst, mask, block))


def _check_extent(name: str, extent, src) -> None:
    """Hold ``extent`` to ``i32[S, NB]`` for ``[S, NB, W]`` buckets, on
    their device, each shard's row extents contiguous (any shard
    stride: the step slice ``[:, t]`` of ``ShardedGraph.mxu_extent``)."""
    if extent.device != src.device or extent.dtype != torch.int32 or \
            extent.dim() != 2 or extent.shape != src.shape[:-1]:
        raise ValueError(f"{name}: extent must be i32[S, NB] on the "
                         f"buckets' device, got {extent.dtype} "
                         f"{tuple(extent.shape)} on {extent.device}")
    if extent.shape[1] > 1 and extent.stride(1) != 1:
        raise ValueError(f"{name}: extent's rows must be contiguous, got "
                         f"strides {extent.stride()}")


def _launch(kind: str, rot, src, local_dst, mask, block: int, dtype,
            extent):
    """Check the operands, allocate both outputs and launch B3's ``kind``
    ("or" or "sum") entry on the current stream."""
    global SEGSUM_LAUNCHES
    name = f"ring_segment_sum_{kind}"
    _check_ring(name, rot)
    if rot.dtype != dtype:
        raise ValueError(f"{name}: rot must be {dtype}, got {rot.dtype}")
    if extent is not None:
        _check_extent(name, extent, src)
    s, nb, w, bucket_stride, signal_stride = segsum.bucket_geometry(
        name, rot, src, local_dst, mask, block)
    dev = rot.device
    rot_next = torch.empty_like(rot)
    out = torch.empty(s, nb * block, dtype=dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(_lib(), f"p2p_ring_segsum_{kind}")(
        rot.data_ptr(), rot_next.data_ptr(), signal_stride, src.data_ptr(),
        local_dst.data_ptr(), mask.data_ptr(),
        None if extent is None else extent.data_ptr(),
        0 if extent is None else extent.stride(0), out.data_ptr(), s, nb, w,
        block, bucket_stride, dev.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    SEGSUM_LAUNCHES += 1
    return rot_next, out


def ring_segment_sum_or(rot, src, local_dst, mask, block: int,
                        extent=None):
    """The fused ring step for OR: ``(ring_shift(rot), out)`` with
    ``out[d, n*block + b] = any(rot[d, src[d, n, w]] & mask[d, n, w]
    for w with local_dst[d, n, w] == b)``. ``rot`` bool ``[S >= 2, B]``;
    the buckets ``[S, NB, W]`` as in :func:`segsum.segsum_or`.

    ``extent`` (``i32[S, NB]``, optional; ``ShardedGraph.mxu_extent``
    sliced as the buckets are) gives each row's extent: every slot from
    it on must be ``(mask, src, local_dst) = (0, 0, 0)``, the layout's
    padding, and the kernel reads no further. The result is the same."""
    if rot.device.type == "cpu":
        return ring_segment_sum_or_plain(rot, src, local_dst, mask, block)
    return _launch("or", rot, src, local_dst, mask, block, torch.bool,
                   extent)


def ring_segment_sum_sum(rot, src, local_dst, mask, block: int,
                         extent=None):
    """The fused ring step for sums: ``(ring_shift(rot), out)`` with
    ``out[d, n*block + b] = sum(rot[d, src[d, n, w]] * mask[d, n, w]
    for w with local_dst[d, n, w] == b)``, f32 ``rot [S >= 2, B]``.
    ``extent`` as in :func:`ring_segment_sum_or`: the padding a row's
    extent skips adds ``rot[d, 0] * 0`` to ``out[d, n*block]`` once, as
    its slots would. Non-finite terms spread over their row as in
    :func:`segsum.segsum_sum` (a non-finite ``rot[d, 0]`` read by the
    padding makes the whole row NaN)."""
    if rot.device.type == "cpu":
        return ring_segment_sum_sum_plain(rot, src, local_dst, mask, block)
    return _launch("sum", rot, src, local_dst, mask, block, torch.float32,
                   extent)
