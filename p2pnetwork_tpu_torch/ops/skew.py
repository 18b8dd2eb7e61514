"""Two-level (skew-split) neighbor table: hub-proof gather aggregation
(torch counterpart of ``p2pnetwork_tpu/ops/skew.py``).

Rows are virtual: a node of in-degree ``d`` owns ``ceil(d / W)`` rows of a
fixed width ``W``, so a hub is many rows and cannot widen anyone else's.
One aggregation gathers and reduces each row (``[R, W]`` slots), then
combines the rows into their owners with a scatter over ``R`` elements.
Rows inherit the receiver-sorted COO order: ``owner`` is non-decreasing
and row ``r`` covers the edges ``[start[r], start[r] + W)``, which is what
lets edge failures re-mask the table exactly (``sim/failures.py``).

The host build is the reference's, byte for byte, including its width
choice (:func:`pick_width`, a cost model of the reference's hardware kept
so the port builds the same table). On a weighted graph the table
carries ``weight``, the per-slot view of ``Graph.edge_weight``. OR, max
and min-plus are exact (the latter two reduce ordered keys,
``ops/extremum.py``). The f32 sum adds each row left to right, as XLA's
CPU row reduce does (``ops/rowsum.py``), and the row sums of an
owner in row order on the CPU; on CUDA ``index_add_`` combines an owner's
several rows in the order its atomics land.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from p2pnetwork_tpu_torch.ops import extremum as X
from p2pnetwork_tpu_torch.ops import rowsum as RS
from p2pnetwork_tpu_torch.sim.graph import _padded_row_fill

#: Candidate virtual-row widths (the reference's).
WIDTH_CANDIDATES = (8, 16, 32, 64, 128)

#: The reference's per-slot gather and per-element segment costs; only
#: their ratio matters to the width choice, which must match its build.
_GATHER_CYCLES_PER_SLOT = 8.0
_SEGMENT_CYCLES_PER_ELEM = 33.0


@dataclasses.dataclass(frozen=True)
class SkewTable:
    """Virtual-row incoming-neighbor table: ``src``/``mask`` ``[R_pad, W]``
    (sender and validity per slot), ``owner[r]`` the receiving node of row
    ``r`` (non-decreasing; padding rows own ``n_pad - 1`` with all-False
    masks) and ``start[r]`` the row's first COO edge. ``weight`` is the
    per-slot cost on a weighted graph (None otherwise)."""

    src: torch.Tensor  # i32[R_pad, W]
    mask: torch.Tensor  # bool[R_pad, W]
    owner: torch.Tensor  # i32[R_pad]
    start: torch.Tensor  # i32[R_pad]
    weight: Optional[torch.Tensor] = None  # f32[R_pad, W]

    @property
    def n_rows(self) -> int:
        return self.src.shape[0]

    @property
    def width(self) -> int:
        return self.src.shape[1]

    @property
    def n_slots(self) -> int:
        return self.src.shape[0] * self.src.shape[1]

    def edge_slots(self, e_pad: int) -> torch.Tensor:
        """``[R_pad, W]`` COO edge id of each slot (``start[r] + s``),
        clipped in bounds for padding slots, whose masks are False."""
        slot = torch.arange(self.width, device=self.start.device)
        return (self.start[:, None] + slot).clamp_max(e_pad - 1)


def pick_width(in_degrees: np.ndarray, candidates=WIDTH_CANDIDATES) -> int:
    """The row width minimizing the reference's modelled round cost
    ``gather * slots(W) + segment * rows(W)`` over the degree histogram."""
    d = np.asarray(in_degrees, dtype=np.int64)
    d = d[d > 0]
    if d.size == 0:
        return candidates[0]
    best_w, best_cost = candidates[0], np.inf
    for w in candidates:
        rows = (d + w - 1) // w
        cost = (_GATHER_CYCLES_PER_SLOT * float(rows.sum()) * w
                + _SEGMENT_CYCLES_PER_ELEM * float(rows.sum()))
        if cost < best_cost:
            best_w, best_cost = w, cost
    return best_w


def build_skew_from_arrays(senders: np.ndarray, receivers: np.ndarray,
                           n_pad: int, e_pad: int, width: int = 0,
                           row_pad_multiple: int = 8, *,
                           weights: Optional[np.ndarray] = None,
                           device) -> SkewTable:
    """The table from the receiver-sorted build-time edge list (the
    unpadded COO prefix), built on the host and moved to ``device``;
    ``weights``, aligned with that list, give its ``weight`` view.
    ``width=0`` picks it (:func:`pick_width`); padding rows start at the
    in-bounds sentinel ``e_pad - 1``."""
    senders = np.asarray(senders, dtype=np.int32)
    receivers = np.asarray(receivers, dtype=np.int32)
    e = senders.size
    counts = (np.bincount(receivers, minlength=n_pad).astype(np.int64)
              if e else np.zeros(n_pad, dtype=np.int64))
    if width <= 0:
        width = pick_width(counts)
    rows_per = (counts + width - 1) // width  # zero-degree nodes: no row
    r_total = int(rows_per.sum())
    r_pad = max(-(-r_total // row_pad_multiple) * row_pad_multiple,
                row_pad_multiple)
    owner = np.full(r_pad, n_pad - 1, dtype=np.int32)
    start = np.full(r_pad, e_pad - 1, dtype=np.int32)
    src = np.zeros((r_pad, width), dtype=np.int32)
    mask = np.zeros((r_pad, width), dtype=bool)
    weight = (None if weights is None
              else np.zeros((r_pad, width), dtype=np.float32))
    if r_total:
        node_ids = np.nonzero(rows_per)[0]
        node_starts = np.concatenate(
            ([0], np.cumsum(counts))).astype(np.int64)[:-1]
        own = np.repeat(node_ids, rows_per[node_ids]).astype(np.int32)
        # Slice index within each node's row group: 0..rows_per-1.
        grp = np.cumsum(rows_per[node_ids]) - rows_per[node_ids]
        j = np.arange(r_total, dtype=np.int64) - np.repeat(
            grp, rows_per[node_ids])
        row_start = node_starts[own] + j * width
        row_count = np.minimum(width, counts[own] - j * width)
        take, valid = _padded_row_fill(row_start, row_count, width)
        take_safe = np.minimum(take, max(e - 1, 0))
        pool = senders if e else np.zeros(1, dtype=np.int32)
        owner[:r_total] = own
        start[:r_total] = row_start.astype(np.int32)
        src[:r_total] = np.where(valid, pool[take_safe], 0)
        mask[:r_total] = valid
        if weights is not None:
            wpool = (np.asarray(weights, dtype=np.float32)
                     if e else np.zeros(1, dtype=np.float32))
            weight[:r_total] = np.where(valid, wpool[take_safe], 0.0)
    return SkewTable(*(None if a is None else torch.from_numpy(a).to(device)
                       for a in (src, mask, owner, start, weight)))


def build_skew(graph, width: int = 0) -> SkewTable:
    """The table of a port ``Graph`` (pulls its edge arrays to the host),
    rows over the build-time edge prefix, re-masked by the graph's current
    ``edge_mask`` so a table attached after failures keeps them."""
    e = graph.n_edges
    w = (None if graph.edge_weight is None
         else graph.edge_weight[:e].cpu().numpy())
    t = build_skew_from_arrays(
        graph.senders[:e].cpu().numpy(), graph.receivers[:e].cpu().numpy(),
        graph.n_nodes_padded, graph.n_edges_padded, width=width, weights=w,
        device=graph.device)
    return remask_edges(t, graph.edge_mask, graph.n_edges_padded)


def or_skew(t: SkewTable, signal: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Per-owner OR: any live slot of any of its rows set. bool[n_pad]."""
    part = (signal[t.src] & t.mask).any(dim=1).to(torch.int32)
    agg = torch.zeros(n_pad, dtype=torch.int32, device=signal.device)
    agg.index_add_(0, t.owner, part)
    return agg > 0


def sum_skew(t: SkewTable, signal: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Per-owner sum of ``signal[src] * mask``. f32[n_pad]."""
    part = RS.gather_row_sum(signal, t.src, t.mask)
    agg = torch.zeros(n_pad, dtype=signal.dtype, device=signal.device)
    agg.index_add_(0, t.owner, part)
    return agg


def max_skew(t: SkewTable, signal: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Per-owner max of the live slots' ``signal[src]``; the dtype's
    max-identity (-inf / int min) where an owner has none."""
    ident = X.identity(signal.dtype, True)
    keys = torch.where(t.mask, X.encode(signal, True)[t.src], ident)
    agg = X.scatter(X.rows(keys, True), t.owner, n_pad, ident, True)
    return X.decode(agg, signal.dtype, True)


def min_plus_skew(t: SkewTable, dist: torch.Tensor,
                  n_pad: int) -> torch.Tensor:
    """Per-owner min of ``dist[src] + weight`` (1 per hop without
    weights) over the live slots; +inf where an owner has none."""
    w = t.weight if t.weight is not None else 1.0
    ident = X.identity(dist.dtype, False)
    keys = torch.where(t.mask, X.encode(dist[t.src] + w, False), ident)
    agg = X.scatter(X.rows(keys, False), t.owner, n_pad, ident, False)
    return X.decode(agg, dist.dtype, False)


def remask_nodes(t, node_alive: torch.Tensor):
    """Node-liveness re-mask: a slot survives iff its sender and its row's
    owner are both alive."""
    if t is None:
        return None
    mask = t.mask & node_alive[t.src] & node_alive[t.owner][:, None]
    return dataclasses.replace(t, mask=mask)


def remask_edges(t, edge_mask: torch.Tensor, e_pad: int):
    """Edge-liveness re-mask through the slot -> edge map."""
    if t is None:
        return None
    return dataclasses.replace(t, mask=t.mask & edge_mask[t.edge_slots(e_pad)])
