"""Blocked edge layout (torch counterpart of ``p2pnetwork_tpu/ops/blocked.py``).

With edges sorted by receiver, each ``block``-node output block owns a
contiguous edge range; padding the ranges to one width gives the
``[n_blocks, width]`` arrays that the segment-sum kernel (``segsum.py``)
reduces row by row:

    out[n, b] = sum_w signal[src[n, w]] * mask[n, w] * (local_dst[n, w] == b)

The host build is the reference's, byte for byte. The ``blocked`` method
here is the plain PyTorch version (gather + ``scatter_add_``); the
``pallas`` method runs the same layout through the CUDA kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from p2pnetwork_tpu_torch.ops import segsum
from p2pnetwork_tpu_torch.sim.graph import _padded_row_fill, _round_up

#: Output rows per block of ``Graph.blocked``.
NODE_BLOCK = 128


@dataclasses.dataclass(frozen=True)
class BlockedEdges:
    """Edges regrouped by ``block``-node destination block: ``src`` /
    ``local_dst`` / ``mask`` are ``[n_blocks, width]``, ``width`` a
    multiple of 128 covering the fullest block, ``local_dst`` in
    ``[0, block)``."""

    src: torch.Tensor  # i32[NB, W]
    local_dst: torch.Tensor  # i32[NB, W]
    mask: torch.Tensor  # bool[NB, W]
    block: int

    @property
    def n_blocks(self) -> int:
        return self.src.shape[0]

    @property
    def width(self) -> int:
        return self.src.shape[1]


def build_blocked_arrays_np(senders: np.ndarray, receivers: np.ndarray,
                            n_pad: int, block: int = NODE_BLOCK):
    """The blocked layout as host arrays ``(src, local_dst, mask)``
    (``receivers`` sorted non-decreasing)."""
    nb = _round_up(n_pad, block) // block
    blk = receivers // block
    counts = np.bincount(blk, minlength=nb)
    width = _round_up(max(int(counts.max()), 1), 128)
    starts = np.searchsorted(blk, np.arange(nb))
    take, mask = _padded_row_fill(starts, counts, width)
    e = senders.size
    src_pool = senders if e else np.zeros(1, dtype=np.int32)
    dst_pool = receivers if e else np.zeros(1, dtype=np.int32)
    take = np.minimum(take, max(e - 1, 0))
    src = np.where(mask, src_pool[take], 0).astype(np.int32)
    local_dst = np.where(mask, dst_pool[take] % block, 0).astype(np.int32)
    return src, local_dst, mask


def build_blocked_from_arrays(senders: np.ndarray, receivers: np.ndarray,
                              n_pad: int, block: int = NODE_BLOCK, *,
                              device) -> BlockedEdges:
    """Blocked layout from host edge arrays, moved to ``device``."""
    src, local_dst, mask = build_blocked_arrays_np(senders, receivers, n_pad,
                                                   block)
    return BlockedEdges(
        src=torch.from_numpy(src).to(device),
        local_dst=torch.from_numpy(local_dst).to(device),
        mask=torch.from_numpy(mask).to(device),
        block=block,
    )


def propagate_sum_blocked(blocked: BlockedEdges, signal: torch.Tensor,
                          node_mask: torch.Tensor) -> torch.Tensor:
    """Per-node incoming sum over the blocked layout, plain PyTorch on any
    device. ``signal`` f32[N_pad] -> f32[N_pad]."""
    out = segsum.segsum_sum_plain(signal, blocked.src, blocked.local_dst,
                                  blocked.mask, blocked.block)
    return out[: node_mask.shape[0]] * node_mask.to(out.dtype)


def propagate_or_blocked(blocked: BlockedEdges, signal: torch.Tensor,
                         node_mask: torch.Tensor) -> torch.Tensor:
    """Per-node incoming OR over the blocked layout, plain PyTorch on any
    device. ``signal`` bool[N_pad] -> bool[N_pad]."""
    out = segsum.segsum_or_plain(signal, blocked.src, blocked.local_dst,
                                 blocked.mask, blocked.block)
    return out[: node_mask.shape[0]] & node_mask


def propagate_sum_kernel(blocked: BlockedEdges, signal: torch.Tensor,
                         node_mask: torch.Tensor) -> torch.Tensor:
    """:func:`propagate_sum_blocked` through the CUDA segment-sum kernel
    (its plain version on a CPU tensor) — the port of the reference's
    ``pallas_edge.propagate_sum_pallas``."""
    out = segsum.segsum_sum(signal.to(torch.float32), blocked.src,
                            blocked.local_dst, blocked.mask, blocked.block)
    return out[: node_mask.shape[0]] * node_mask.to(out.dtype)


def propagate_or_kernel(blocked: BlockedEdges, signal: torch.Tensor,
                        node_mask: torch.Tensor) -> torch.Tensor:
    """:func:`propagate_or_blocked` through the CUDA segment-sum kernel's
    OR entry — the port of ``pallas_edge.propagate_or_pallas``."""
    out = segsum.segsum_or(signal, blocked.src, blocked.local_dst,
                           blocked.mask, blocked.block)
    return out[: node_mask.shape[0]] & node_mask
