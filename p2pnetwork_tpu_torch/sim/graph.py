"""Peer-graph representation for the port (torch counterpart of
``p2pnetwork_tpu/sim/graph.py``).

The build runs on the host in numpy exactly as the reference's does, so
every array is byte-identical to the JAX build for the same arguments
(``tests/test_torch_graph.py``); the tensors go to the device once, at the
end of :func:`from_edges`. The reference sorts with its C++ radix core
(``p2pnetwork_tpu/native``); that module documents numpy's stable
``argsort`` and ``unique`` as equivalent, and the port uses those, so it
needs no native build.

Only what the flood main path reads is ported: the COO edges, masks and
degrees, the padded neighbor table, the source-CSR out-edge view, and the
blocked / diagonal+remainder layouts. The dynamic edge region, per-edge
weights, the skew table and node reordering are not (``interop`` refuses
a reference graph that carries dynamic edges).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from p2pnetwork_tpu_torch import _device


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def sort_pairs(keys: np.ndarray, vals: np.ndarray):
    """Stable sort of ``(keys, vals)`` by int32 ``keys`` — the numpy form
    of the reference's ``native.sort_pairs``."""
    keys = np.ascontiguousarray(keys, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.int32)
    order = np.argsort(keys, kind="stable")
    return keys[order], vals[order]


def _padded_row_fill(starts: np.ndarray, counts: np.ndarray, width: int):
    """Ragged rows to a padded ``[rows, width]`` matrix: ``(take, valid)``,
    flat pool indices (0 where padded) and the padding mask."""
    # int32 halves the temporaries, but only when every index fits.
    big = starts.size and int(starts.max()) + width >= 2**31
    dtype = np.int64 if big else np.int32
    slot = np.arange(width, dtype=dtype)
    starts = starts.astype(dtype, copy=False)
    counts = counts.astype(dtype, copy=False)
    valid = slot[None, :] < counts[:, None]
    take = np.where(valid, starts[:, None] + slot[None, :], dtype(0))
    return take, valid


@dataclasses.dataclass(frozen=True)
class Graph:
    """A static-shape peer graph on one device.

    An edge ``(senders[e], receivers[e])`` means messages flow sender ->
    receiver. Edges are sorted by receiver; padded slots point at the last
    padded node and are masked out by ``edge_mask``.
    """

    senders: torch.Tensor  # i32[E_pad]
    receivers: torch.Tensor  # i32[E_pad], non-decreasing
    edge_mask: torch.Tensor  # bool[E_pad]
    node_mask: torch.Tensor  # bool[N_pad]
    in_degree: torch.Tensor  # i32[N_pad]
    out_degree: torch.Tensor  # i32[N_pad]
    neighbors: Optional[torch.Tensor]  # i32[N_pad, max_degree]
    neighbor_mask: Optional[torch.Tensor]  # bool[N_pad, max_degree]
    n_nodes: int
    n_edges: int
    #: False when ``from_edges(max_degree=...)`` capped the table width.
    neighbors_complete: bool = True
    max_degree_cap: Optional[int] = None
    edge_pad_multiple: int = 128
    #: Widest run of one receiver among the live COO entries.
    max_in_span: int = 0
    blocked: Optional[object] = None  # ops/blocked.py BlockedEdges
    hybrid: Optional[object] = None  # ops/diag.py HybridEdges
    # Source-CSR view: src_eid[src_offsets[v]:src_offsets[v+1]] are v's
    # out-edges as indices into senders/receivers/edge_mask.
    src_eid: Optional[torch.Tensor] = None  # i32[E_pad]
    src_offsets: Optional[torch.Tensor] = None  # i32[N_pad + 1]
    max_out_span: int = 0

    @property
    def device(self) -> torch.device:
        return self.node_mask.device

    @property
    def n_nodes_padded(self) -> int:
        return self.node_mask.shape[0]

    @property
    def n_edges_padded(self) -> int:
        return self.senders.shape[0]

    @property
    def max_degree(self) -> int:
        return 0 if self.neighbors is None else self.neighbors.shape[1]

    def gather_row_slots(self, start: torch.Tensor, end: torch.Tensor,
                         width: int):
        """``[K, width]`` out-edge slot gather through the source-CSR view:
        ``(eid, valid)`` for slots ``start[i] + j`` while ``< end[i]``.
        Out-of-row slots read the ``e_pad - 1`` sentinel, which can be a
        live edge: consumers must AND with ``valid``."""
        slot = start[:, None] + torch.arange(width, device=start.device)
        valid = slot < end[:, None]
        eid = self.src_eid[torch.where(valid, slot, self.n_edges_padded - 1)]
        return eid, valid


def _build_source_csr(senders: np.ndarray, edge_mask: np.ndarray,
                      n_pad: int, e_pad: int):
    """Sender-sorted edge-id permutation + row offsets (host-side). Padding
    slots of ``src_eid`` hold ``e_pad - 1`` to stay in bounds."""
    active = np.flatnonzero(edge_mask).astype(np.int32)
    _, sorted_eids = sort_pairs(senders[active], active)
    eid = np.full(e_pad, e_pad - 1, dtype=np.int32)
    eid[: active.size] = sorted_eids
    counts = np.bincount(senders[active], minlength=n_pad).astype(np.int32)
    offsets = np.zeros(n_pad + 1, dtype=np.int32)
    np.cumsum(counts, out=offsets[1:])
    span = int(counts.max()) if active.size else 0
    return eid, offsets, span


def _neighbor_table(senders, receivers, e, n_pad, width):
    """Padded incoming-neighbor table ``[n_pad, width]``; over-degree rows
    get a uniform random ``width``-subset of their in-edges (seed 0, the
    reference's rule)."""
    starts = np.searchsorted(receivers, np.arange(n_pad))
    ends = np.searchsorted(receivers, np.arange(n_pad), side="right")
    take, valid = _padded_row_fill(starts, np.minimum(ends - starts, width),
                                   width)
    capped = np.nonzero(ends - starts > width)[0]
    if capped.size:
        cap_rng = np.random.default_rng(0)
        deg = ends - starts
        cap_edge = np.repeat(capped, deg[capped])
        offs = np.arange(cap_edge.size) - np.repeat(
            np.cumsum(deg[capped]) - deg[capped], deg[capped])
        edge_idx = starts[cap_edge] + offs
        keys = cap_rng.random(edge_idx.size)
        order = np.lexsort((keys, cap_edge))
        rank = np.empty_like(offs)
        rank[order] = offs
        kept = rank < width
        resort = np.lexsort((edge_idx[kept], cap_edge[kept]))
        take[capped] = edge_idx[kept][resort].reshape(capped.size, width)
    pool = senders if e else np.zeros(1, dtype=np.int32)
    take_safe = np.minimum(take, max(e - 1, 0))
    return np.where(valid, pool[take_safe], 0).astype(np.int32), valid


def from_edges(
    senders,
    receivers,
    n_nodes: int,
    *,
    node_pad_multiple: int = 128,
    edge_pad_multiple: int = 128,
    build_neighbor_table: bool = True,
    max_degree: Optional[int] = None,
    blocked: bool = False,
    hybrid: bool = False,
    source_csr: bool = False,
    device=None,
) -> Graph:
    """Build a :class:`Graph` from host edge arrays (the reference's
    ``from_edges`` without ``weights``, ``skew_table`` or ``reorder``).

    Edges are sorted by receiver and padded to ``edge_pad_multiple``; nodes
    to ``node_pad_multiple``. ``blocked`` / ``hybrid`` / ``source_csr``
    attach those layouts from the host arrays in hand. ``device`` as in
    ``_device.resolve``.
    """
    from p2pnetwork_tpu_torch.ops.blocked import build_blocked_from_arrays
    from p2pnetwork_tpu_torch.ops.diag import build_hybrid_from_arrays

    dev = _device.resolve(device)
    senders = np.asarray(senders, dtype=np.int32)
    receivers = np.asarray(receivers, dtype=np.int32)
    if senders.shape != receivers.shape:
        raise ValueError("senders and receivers must have the same shape")
    if senders.size and (senders.max() >= n_nodes or receivers.max() >= n_nodes):
        raise ValueError("edge endpoint out of range")

    receivers, senders = sort_pairs(receivers, senders)
    n_pad = _round_up(max(n_nodes, 1), node_pad_multiple)
    e = senders.size
    e_pad = _round_up(max(e, 1), edge_pad_multiple)

    s = np.zeros(e_pad, dtype=np.int32)
    # Padding receivers with n_pad-1 keeps the array sorted.
    r = np.full(e_pad, n_pad - 1, dtype=np.int32)
    s[:e], r[:e] = senders, receivers
    emask = np.zeros(e_pad, dtype=bool)
    emask[:e] = True
    nmask = np.zeros(n_pad, dtype=bool)
    nmask[:n_nodes] = True
    in_deg = np.bincount(receivers, minlength=n_pad).astype(np.int32)
    out_deg = np.bincount(senders, minlength=n_pad).astype(np.int32)
    max_in_span = max(int(in_deg.max()) if e else 0, 1)

    host = dict(senders=s, receivers=r, edge_mask=emask, node_mask=nmask,
                in_degree=in_deg, out_degree=out_deg, neighbors=None,
                neighbor_mask=None)
    neighbors_complete = True
    if build_neighbor_table:
        width = int(in_deg.max()) if e else 0
        if max_degree is not None:
            neighbors_complete = max_degree >= width
            width = min(width, max_degree)
        host["neighbors"], host["neighbor_mask"] = _neighbor_table(
            senders, receivers, e, n_pad, max(width, 1))

    blocked_rep = hybrid_rep = None
    if blocked:
        blocked_rep = build_blocked_from_arrays(senders, receivers, n_pad,
                                                device=dev)
    if hybrid:
        hybrid_rep = build_hybrid_from_arrays(senders, receivers, n_nodes,
                                              n_pad, device=dev)
    max_out_span = 0
    if source_csr:
        host["src_eid"], host["src_offsets"], max_out_span = \
            _build_source_csr(s, emask, n_pad, e_pad)

    return Graph(
        **{k: None if v is None else torch.from_numpy(v).to(dev)
           for k, v in host.items()},
        n_nodes=n_nodes,
        n_edges=e,
        neighbors_complete=neighbors_complete,
        max_degree_cap=max_degree,
        edge_pad_multiple=edge_pad_multiple,
        max_in_span=max_in_span,
        blocked=blocked_rep,
        hybrid=hybrid_rep,
        max_out_span=max_out_span,
    )


def _undirect(src: np.ndarray, dst: np.ndarray):
    """Duplicate each undirected edge into both directions."""
    return np.concatenate([src, dst]), np.concatenate([dst, src])


def _pair_bits(n: int) -> int:
    """Bits needed to hold an id in ``[0, n)``."""
    return max(int(n - 1).bit_length(), 1)


def _dedup_undirected(src: np.ndarray, dst: np.ndarray, n: int):
    """Unique undirected pairs as ``(lo, hi)`` int32 arrays, keyed
    ``min << b | max`` as the reference does."""
    b = _pair_bits(n)
    lo = np.minimum(src, dst).astype(np.int64)
    hi = np.maximum(src, dst)
    keys = np.unique((lo << b) | hi)
    return (keys >> b).astype(np.int32), (keys & ((1 << b) - 1)).astype(np.int32)


def erdos_renyi(n: int, p: float, seed: int = 0, **kw) -> Graph:
    """G(n, p) random graph (undirected), sampled as the reference does:
    a binomial edge count, uniform pairs with collision dedup."""
    rng = np.random.default_rng(seed)
    n_pairs = n * (n - 1) // 2
    m = rng.binomial(n_pairs, p) if n_pairs < 2**63 else int(p * n_pairs)
    if m == 0:
        return from_edges(np.zeros(0), np.zeros(0), n, **kw)
    b = _pair_bits(n)
    keys = np.zeros(0, dtype=np.int64)
    draw = int(m * 1.2) + 16
    while keys.size < m:
        src = rng.integers(0, n, size=draw, dtype=np.int64)
        dst = rng.integers(0, n, size=draw, dtype=np.int64)
        keep = src != dst
        lo, hi = np.minimum(src[keep], dst[keep]), np.maximum(src[keep], dst[keep])
        keys = np.unique(np.concatenate([keys, (lo << b) | hi]))
        draw *= 2
    keys = rng.permutation(keys)[:m]
    lo = (keys >> b).astype(np.int32)
    hi = (keys & ((1 << b) - 1)).astype(np.int32)
    return from_edges(*_undirect(lo, hi), n, **kw)


def barabasi_albert(n: int, m: int, seed: int = 0, **kw) -> Graph:
    """Barabási–Albert preferential attachment by the linearized chord
    diagram construction, vectorized as the reference does."""
    if m < 1 or m >= n:
        raise ValueError("barabasi_albert requires 1 <= m < n")
    rng = np.random.default_rng(seed)
    N = n * m
    i = np.arange(N, dtype=np.int64)
    u = (rng.random(N) * (2 * i + 1)).astype(np.int64)  # uniform on [0, 2i]
    targets = np.where(u % 2 == 0, u // 2, np.int64(-1))
    parent = np.where(u % 2 == 1, (u - 1) // 2, i)
    unresolved = targets < 0
    while unresolved.any():
        targets = np.where(unresolved, targets[parent], targets)
        parent = parent[parent]  # pointer doubling
        unresolved = targets < 0
    src = i // m
    dst = targets // m
    keep = src != dst
    lo, hi = _dedup_undirected(src[keep], dst[keep], n)
    return from_edges(*_undirect(lo, hi), n, **kw)


def watts_strogatz(n: int, k: int, p: float, seed: int = 0, **kw) -> Graph:
    """Watts–Strogatz small world: ring lattice with ``k`` neighbors per
    node, each edge rewired with probability ``p`` — the generator of the
    million-node benchmark graph."""
    if k % 2 != 0:
        raise ValueError("watts_strogatz requires even k")
    if k >= n:
        raise ValueError("watts_strogatz requires k < n")
    rng = np.random.default_rng(seed)
    base = np.arange(n, dtype=np.int32)
    srcs, dsts = [], []
    for off in range(1, k // 2 + 1):
        ring_dst = base + np.int32(off)
        ring_dst = np.where(ring_dst >= n, ring_dst - np.int32(n), ring_dst)
        rewire = rng.random(n) < p
        new_dst = rng.integers(0, n, size=n, dtype=np.int32)
        dst = np.where(rewire, new_dst, ring_dst)
        dst = np.where(dst == base, ring_dst, dst)
        srcs.append(base)
        dsts.append(dst)
    lo, hi = _dedup_undirected(np.concatenate(srcs), np.concatenate(dsts), n)
    return from_edges(*_undirect(lo, hi), n, **kw)
