"""Hybrid diagonal + blocked aggregation (torch counterpart of
``p2pnetwork_tpu/ops/diag.py``) — the dense round of the main path.

Ring-lattice topologies (the Watts–Strogatz benchmark family) put most
edges on a few circular diagonals ``{(v + off) mod n -> v : mask[v]}``.
One diagonal aggregates as a roll plus an elementwise mask, with no gather:

    out[v] |= signal[(v + off) mod n] & mask[v]        (OR)
    out[v] += signal[(v + off) mod n] * mask[v]        (sum)

Edges off the kept diagonals (the rewired ~p fraction of a WS graph) go to
a blocked remainder (``block=512``) reduced by the segment-sum kernel
(``kernel="pallas"``, the name of the reference's lowering) or by its plain
PyTorch version (``kernel="blocked"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from p2pnetwork_tpu_torch.ops import blocked as B
from p2pnetwork_tpu_torch.sim.graph import sort_pairs


@dataclasses.dataclass(frozen=True)
class HybridEdges:
    """Edges split into circular diagonals + unstructured remainder.
    ``masks[d, v]`` is True iff the edge ``(v + offsets[d]) mod n -> v``
    exists; ``remainder`` holds every other edge (None when none is left).
    """

    masks: torch.Tensor  # bool[D, n] (D may be 0)
    remainder: Optional[B.BlockedEdges]
    offsets: Tuple[int, ...]
    n: int


def select_diagonals(senders: np.ndarray, receivers: np.ndarray, n: int,
                     max_diags: int = 64, min_count: Optional[int] = None):
    """The dominant circular offsets of an edge list (host-side): returns
    ``(kept_offsets, per_offset_sel, diag_sel)`` exactly as the reference
    does — offsets by descending edge count, one edge per receiver each,
    and the covered-edge bitmap."""
    if min_count is None:
        min_count = max(n // 256, 128)
    diag_sel = np.zeros(senders.shape[0], dtype=bool)
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    real = np.flatnonzero((senders < n) & (receivers < n))
    kept: list = []
    per_sel: list = []
    if real.size:
        d = senders[real].astype(np.int32) - receivers[real].astype(np.int32)
        off = np.where(d < 0, d + np.int32(n), d)
        counts = np.bincount(off)
        # Filter self-loops and thin offsets BEFORE truncating to max_diags.
        ok = counts >= min_count
        ok[0] = False
        cand = np.flatnonzero(ok)
        kept = [int(o) for o in cand[np.argsort(counts[cand])[::-1]][:max_diags]]
        sorted_off, by_off = sort_pairs(
            off, np.arange(off.shape[0], dtype=np.int32))
        lo = np.searchsorted(sorted_off, kept)
        hi = np.searchsorted(sorted_off, kept, side="right")
        rsorted = bool(receivers.size == 0 or
                       (receivers[1:] >= receivers[:-1]).all())
        for d, o in enumerate(kept):
            sel = real[by_off[lo[d]:hi[d]]]
            # A mask slot holds ONE edge; duplicates stay in the remainder.
            rs = receivers[sel]
            if rsorted:
                first = np.empty(rs.shape[0], dtype=bool)
                if rs.shape[0]:
                    first[0] = True
                    np.not_equal(rs[1:], rs[:-1], out=first[1:])
                sel = sel[first]
            else:
                _, first = np.unique(rs, return_index=True)
                sel = sel[first]
            per_sel.append(sel)
            diag_sel[sel] = True
    return kept, per_sel, diag_sel


def build_hybrid_from_arrays(senders: np.ndarray, receivers: np.ndarray,
                             n: int, n_pad: int, *, block: int = 512,
                             max_diags: int = 64,
                             min_count: Optional[int] = None,
                             device) -> HybridEdges:
    """The hybrid layout from host edge arrays (``receivers`` sorted,
    active edges only), moved to ``device``."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    kept, per_sel, diag_sel = select_diagonals(senders, receivers, n,
                                               max_diags, min_count)
    masks = np.zeros((len(kept), n), dtype=bool)
    for d, sel in enumerate(per_sel):
        masks[d, receivers[sel]] = True
    rem_s = senders[~diag_sel].astype(np.int32, copy=False)
    rem_r = receivers[~diag_sel].astype(np.int32, copy=False)
    remainder = None
    if rem_s.size:
        remainder = B.build_blocked_from_arrays(rem_s, rem_r, n_pad, block,
                                                device=device)
    return HybridEdges(masks=torch.from_numpy(masks).to(device),
                       remainder=remainder, offsets=tuple(kept), n=n)


def _shifted(core: torch.Tensor, off: int, lo: int, m: int) -> torch.Tensor:
    """``core[(v + off) mod n]`` at the mask columns' nodes ``v`` in
    ``[lo, lo + m)``: every node of the whole graph (``m = n``), or a
    rank's owned columns (``sim/graph.py`` ``GraphPart``)."""
    x = torch.roll(core, -off)
    return x if m == core.shape[0] else x[lo:lo + m]


def _diag_or(hybrid: HybridEdges, core: torch.Tensor,
             lo: int = 0) -> torch.Tensor:
    """OR-aggregate the diagonal edges at the mask columns' nodes, the
    first ``lo``. ``core`` is bool[n] (unpadded)."""
    m = hybrid.masks.shape[1]
    acc = torch.zeros(m, dtype=torch.bool, device=core.device)
    for d, off in enumerate(hybrid.offsets):
        acc = acc | (_shifted(core, off, lo, m) & hybrid.masks[d])
    return acc


def _diag_sum(hybrid: HybridEdges, core: torch.Tensor,
              lo: int = 0) -> torch.Tensor:
    """Sum-aggregate the diagonal edges, as :func:`_diag_or`. ``core`` is
    f32[n] (unpadded)."""
    m = hybrid.masks.shape[1]
    acc = torch.zeros(m, dtype=core.dtype, device=core.device)
    for d, off in enumerate(hybrid.offsets):
        acc = acc + _shifted(core, off, lo, m) * hybrid.masks[d].to(
            core.dtype)
    return acc


def _check_kernel(kernel: str) -> None:
    if kernel not in ("pallas", "blocked"):
        raise ValueError(f"kernel must be 'pallas' or 'blocked', got {kernel!r}")


def propagate_or_hybrid(hybrid: HybridEdges, signal: torch.Tensor,
                        node_mask: torch.Tensor, kernel: str = "pallas",
                        lo: int = 0) -> torch.Tensor:
    """Per-node OR over incoming edges: diagonals by roll, the remainder by
    the segment-sum kernel (``"pallas"``) or its plain version
    (``"blocked"``). On a rank's part the result covers the owned nodes
    from ``lo`` (``node_mask`` theirs): the owned mask columns and the
    remainder whose destinations count from ``lo``."""
    _check_kernel(kernel)
    diag = _diag_or(hybrid, signal[: hybrid.n], lo)
    out = torch.nn.functional.pad(diag, (0, node_mask.shape[0] -
                                         diag.shape[0]))
    if hybrid.remainder is not None:
        fn = B.propagate_or_kernel if kernel == "pallas" else B.propagate_or_blocked
        out = out | fn(hybrid.remainder, signal, node_mask)
    return out & node_mask


def propagate_sum_hybrid(hybrid: HybridEdges, signal: torch.Tensor,
                         node_mask: torch.Tensor, kernel: str = "pallas",
                         lo: int = 0) -> torch.Tensor:
    """Per-node sum over incoming edges: diagonals by roll, the remainder
    and ``lo`` as in :func:`propagate_or_hybrid`."""
    _check_kernel(kernel)
    diag = _diag_sum(hybrid, signal[: hybrid.n], lo)
    out = torch.nn.functional.pad(diag, (0, node_mask.shape[0] -
                                         diag.shape[0]))
    if hybrid.remainder is not None:
        fn = (B.propagate_sum_kernel if kernel == "pallas"
              else B.propagate_sum_blocked)
        out = out + fn(hybrid.remainder, signal, node_mask)
    return out * node_mask.to(out.dtype)

