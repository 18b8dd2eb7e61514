"""Peer-graph representation for the port (torch counterpart of
``p2pnetwork_tpu/sim/graph.py``).

The build runs on the host in numpy exactly as the reference's does, so
every array is byte-identical to the JAX build for the same arguments
(``tests/test_torch_graph.py``); the tensors go to the device once, at the
end of :func:`from_edges`. The reference sorts with its C++ radix core
(``p2pnetwork_tpu/native``); that module documents numpy's stable
``argsort`` and ``unique`` as equivalent, and the port uses those, so it
needs no native build.

Ported: the COO edges, masks and degrees, the padded neighbor table, the
source-CSR out-edge view, the blocked / diagonal+remainder layouts, the
two-level skew table (``ops/skew.py``), the dynamic edge region of
runtime links (``sim/topology.py``), per-edge weights with their
aligned views (``edge_weight``, ``neighbor_weight``, the skew table's
``weight``), the node reordering of ``from_edges(reorder=...)``
(``sim/layout.py``; every generator forwards it), and the generators:
Erdős–Rényi, Barabási–Albert, Watts–Strogatz and the structured overlays
(``ring``, ``chord``, ``kademlia``, ``complete``; ``build`` from a
topology description). The incremental builds (``apply_delta``,
``grow``) are not.
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
    # In place: a kademlia hub row makes these [n_pad, 31k] at 100K nodes.
    take = starts[:, None] + slot[None, :]
    take[~valid] = 0
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
    skew: Optional[object] = None  # ops/skew.py SkewTable
    # Dynamic edge region (sim/topology.py): unsorted COO slots for links
    # added at runtime, folded into every aggregation method.
    dyn_senders: Optional[torch.Tensor] = None  # i32[K]
    dyn_receivers: Optional[torch.Tensor] = None  # i32[K]
    dyn_mask: Optional[torch.Tensor] = None  # bool[K]
    # Source-CSR view: src_eid[src_offsets[v]:src_offsets[v+1]] are v's
    # out-edges as indices into senders/receivers/edge_mask.
    src_eid: Optional[torch.Tensor] = None  # i32[E_pad]
    src_offsets: Optional[torch.Tensor] = None  # i32[N_pad + 1]
    max_out_span: int = 0
    # Per-edge costs aligned with senders/receivers (None: every hop costs
    # 1), and their view aligned with the neighbor table's slots.
    edge_weight: Optional[torch.Tensor] = None  # f32[E_pad]
    neighbor_weight: Optional[torch.Tensor] = None  # f32[N_pad, max_degree]
    # Node relabeling of a reordered build (``from_edges(reorder=...)``,
    # ``sim/layout.py``): layout_perm[old] = new, layout_inv[new] = old.
    layout_perm: Optional[torch.Tensor] = None  # i32[N_pad]
    layout_inv: Optional[torch.Tensor] = None  # i32[N_pad]

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

    def _live_edges(self):
        """The live static edges as host arrays ``(senders, receivers)``,
        receiver-sorted."""
        emask = self.edge_mask.cpu().numpy()
        return (self.senders.cpu().numpy()[emask],
                self.receivers.cpu().numpy()[emask])

    def with_blocked(self, block: int = 128) -> "Graph":
        """A copy carrying the blocked layout of the live edges."""
        from p2pnetwork_tpu_torch.ops.blocked import build_blocked_from_arrays

        return dataclasses.replace(self, blocked=build_blocked_from_arrays(
            *self._live_edges(), self.n_nodes_padded, block,
            device=self.device))

    def with_hybrid(self, block: int = 512, max_diags: int = 64) -> "Graph":
        """A copy carrying the diagonal+remainder layout of the live
        edges."""
        from p2pnetwork_tpu_torch.ops.diag import build_hybrid_from_arrays

        return dataclasses.replace(self, hybrid=build_hybrid_from_arrays(
            *self._live_edges(), self.n_nodes, self.n_nodes_padded,
            block=block, max_diags=max_diags, device=self.device))

    def with_source_csr(self) -> "Graph":
        """A copy carrying the source-CSR out-edge view of the live
        edges (pulls the edge arrays to the host)."""
        eid, offsets, span = _build_source_csr(
            self.senders.cpu().numpy(), self.edge_mask.cpu().numpy(),
            self.n_nodes_padded, self.n_edges_padded)
        return dataclasses.replace(
            self, src_eid=torch.from_numpy(eid).to(self.device),
            src_offsets=torch.from_numpy(offsets).to(self.device),
            max_out_span=span)

    def with_weights(self, weights) -> "Graph":
        """A copy carrying per-edge costs. ``weights`` is a callable
        ``(senders, receivers) -> f32`` evaluated on the padded edge
        arrays, given as host numpy ``int32`` arrays (a deterministic
        link-cost model, such as an id-hash latency), or an array aligned
        with the receiver-sorted padded edge slots. A complete neighbor
        table gets its aligned ``neighbor_weight`` rebuilt on the host; a
        width-capped one cannot be re-aligned (pass ``weights=`` to
        :func:`from_edges`). The skew table's ``weight`` is one gather
        through its slot -> edge map."""
        if callable(weights):
            weights = weights(self.senders.cpu().numpy(),
                              self.receivers.cpu().numpy())
        if isinstance(weights, torch.Tensor):
            weights = weights.cpu().numpy()
        wh = np.asarray(weights, dtype=np.float32)
        if wh.shape != tuple(self.senders.shape):
            raise ValueError("weights must align with the padded edge slots")
        w = torch.from_numpy(wh).to(self.device)
        nw = None
        if self.neighbors is not None:
            if not self.neighbors_complete:
                raise ValueError(
                    "cannot re-align weights to a width-capped neighbor "
                    "table; rebuild via from_edges(weights=..., "
                    "max_degree=...)")
            # Complete rows are the receiver runs of the build-time edge
            # list, in order (build-time extents, not in_degree: failures
            # change degrees, not the slot layout).
            rh = self.receivers[: self.n_edges].cpu().numpy()
            ids = np.arange(self.n_nodes_padded)
            starts = np.searchsorted(rh, ids)
            counts = np.searchsorted(rh, ids, side="right") - starts
            width = self.neighbors.shape[1]
            take, valid = _padded_row_fill(starts, np.minimum(counts, width),
                                           width)
            nw = torch.from_numpy(np.where(
                valid, wh[np.minimum(take, max(self.n_edges - 1, 0))], 0.0
            ).astype(np.float32)).to(self.device)
        sk = self.skew
        if sk is not None:
            sk = dataclasses.replace(sk, weight=torch.where(
                sk.mask, w[sk.edge_slots(self.n_edges_padded)], 0.0))
        return dataclasses.replace(self, edge_weight=w, neighbor_weight=nw,
                                   skew=sk)

    def with_skew_table(self, width: int = 0) -> "Graph":
        """A copy carrying the two-level neighbor table of the ``skew``
        method (``ops/skew.py``); ``width=0`` picks the width from the
        degree histogram."""
        from p2pnetwork_tpu_torch.ops.skew import build_skew

        return dataclasses.replace(self, skew=build_skew(self, width))

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


def _neighbor_table(senders, receivers, e, n_pad, width, weights=None):
    """Padded incoming-neighbor table ``[n_pad, width]`` and its mask;
    over-degree rows get a uniform random ``width``-subset of their
    in-edges (seed 0, the reference's rule). With ``weights`` (aligned
    with the sorted edges) also the slot-aligned weight view, else
    None."""
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
    take_safe = np.minimum(take, max(e - 1, 0), out=take)
    nw = None
    if weights is not None:
        wpool = weights if e else np.zeros(1, dtype=np.float32)
        nw = np.where(valid, wpool[take_safe], 0.0).astype(np.float32)
    table = pool[take_safe].astype(np.int32, copy=False)
    table[~valid] = 0
    return table, valid, nw


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
    skew_table: bool = False,
    skew_width: int = 0,
    weights=None,
    reorder: Optional[str] = None,
    device=None,
) -> Graph:
    """Build a :class:`Graph` from host edge arrays (the reference's
    ``from_edges``).

    Edges are sorted by receiver and padded to ``edge_pad_multiple``; nodes
    to ``node_pad_multiple``. ``blocked`` / ``hybrid`` / ``source_csr`` /
    ``skew_table`` (of width ``skew_width``, 0 = picked) attach those
    layouts from the host arrays in hand. ``weights`` (f32, aligned with
    ``senders``/``receivers``) go through the same receiver sort and give
    ``edge_weight``, the neighbor table's ``neighbor_weight`` (a capped
    table's too) and the skew table's ``weight``. ``reorder``
    (``"degree"`` or ``"rcm"``, ``sim/layout.py``) relabels the node ids
    before the build and records the mapping (``layout_perm`` /
    ``layout_inv``, identity over the padding ids); map results back with
    ``layout.to_original_order``. ``device`` as in ``_device.resolve``.
    """
    from p2pnetwork_tpu_torch.ops.blocked import build_blocked_from_arrays
    from p2pnetwork_tpu_torch.ops.diag import build_hybrid_from_arrays
    from p2pnetwork_tpu_torch.ops.skew import build_skew_from_arrays

    dev = _device.resolve(device)
    senders = np.asarray(senders, dtype=np.int32)
    receivers = np.asarray(receivers, dtype=np.int32)
    if senders.shape != receivers.shape:
        raise ValueError("senders and receivers must have the same shape")
    if senders.size and (senders.max() >= n_nodes or receivers.max() >= n_nodes):
        raise ValueError("edge endpoint out of range")

    layout_perm = None
    if reorder is not None:
        from p2pnetwork_tpu_torch.sim import layout

        layout_perm = layout.node_permutation(senders, receivers, n_nodes,
                                              strategy=reorder)
        senders, receivers = layout_perm[senders], layout_perm[receivers]

    if weights is not None:
        weights = np.asarray(weights, dtype=np.float32)
        if weights.shape != senders.shape:
            raise ValueError("weights must align with senders/receivers")
        receivers, perm = sort_pairs(receivers,
                                     np.arange(senders.size, dtype=np.int32))
        senders, weights = senders[perm], weights[perm]
    else:
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
                neighbor_mask=None, edge_weight=None, neighbor_weight=None,
                layout_perm=None, layout_inv=None)
    if layout_perm is not None:
        # The identity over the padding ids: the mapping covers the whole
        # padded id space.
        perm = np.concatenate([layout_perm.astype(np.int32),
                               np.arange(n_nodes, n_pad, dtype=np.int32)])
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n_pad, dtype=np.int32)
        host["layout_perm"], host["layout_inv"] = perm, inv
    if weights is not None:
        host["edge_weight"] = np.zeros(e_pad, dtype=np.float32)
        host["edge_weight"][:e] = weights
    neighbors_complete = True
    if build_neighbor_table:
        width = int(in_deg.max()) if e else 0
        if max_degree is not None:
            neighbors_complete = max_degree >= width
            width = min(width, max_degree)
        (host["neighbors"], host["neighbor_mask"],
         host["neighbor_weight"]) = _neighbor_table(
            senders, receivers, e, n_pad, max(width, 1), weights)

    blocked_rep = hybrid_rep = None
    if blocked:
        blocked_rep = build_blocked_from_arrays(senders, receivers, n_pad,
                                                device=dev)
    if hybrid:
        hybrid_rep = build_hybrid_from_arrays(senders, receivers, n_nodes,
                                              n_pad, device=dev)
    skew_rep = None
    if skew_table:
        skew_rep = build_skew_from_arrays(senders, receivers, n_pad, e_pad,
                                          width=skew_width, weights=weights,
                                          device=dev)
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
        skew=skew_rep,
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


def ring(n: int, **kw) -> Graph:
    """Simple bidirectional ring."""
    base = np.arange(n, dtype=np.int32)
    return from_edges(*_undirect(base, (base + 1) % n), n, **kw)


def chord(n: int, **kw) -> Graph:
    """Chord-style structured overlay: the identifier ring plus a finger
    to ``(v + 2^i) mod n`` for every ``2^i < n`` (O(log n) degree and
    diameter; the greedy ``ring``-metric lookups of
    ``models/querybatch.py`` chase these fingers). Undirected."""
    if n < 2:
        raise ValueError("chord requires n >= 2 (no fingers exist below that)")
    base = np.arange(n, dtype=np.int64)
    srcs, dsts = [], []
    i = 0
    while (1 << i) < n:
        srcs.append(base)
        dsts.append((base + (1 << i)) % n)
        i += 1
    lo, hi = _dedup_undirected(np.concatenate(srcs), np.concatenate(dsts), n)
    return from_edges(*_undirect(lo, hi), n, **kw)


def kademlia(n: int, k: int = 1, **kw) -> Graph:
    """Kademlia-style structured overlay: for every node ``v`` and XOR
    bucket ``[2^i, 2^(i+1))`` with ``2^i < n``, edges to the ``k`` closest
    ids ``v ^ (2^i + j)``; where such an id does not exist (``n`` not a
    power of two) the edge falls back to the bucket's ``j``-th lowest id,
    kept when it exists. At ``k = 1`` on a power of two this is the
    hypercube. Undirected, deterministic."""
    if n < 2:
        raise ValueError("kademlia requires n >= 2 (no buckets below that)")
    if k < 1:
        raise ValueError("k must be >= 1")
    v = np.arange(n, dtype=np.int64)
    srcs, dsts = [], []
    i = 0
    while (1 << i) < n:
        width = 1 << i
        bucket_base = ((v >> i) ^ 1) << i
        v_low = v & (width - 1)
        for j in range(min(k, width)):
            ideal = bucket_base + (v_low ^ j)
            cand = np.where(ideal < n, ideal, bucket_base + j)
            keep = cand < n
            srcs.append(v[keep])
            dsts.append(cand[keep])
        i += 1
    lo, hi = _dedup_undirected(np.concatenate(srcs), np.concatenate(dsts), n)
    return from_edges(*_undirect(lo, hi), n, **kw)


def complete(n: int, **kw) -> Graph:
    """Complete graph (every ordered pair) — small ``n`` only."""
    src, dst = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    keep = src != dst
    return from_edges(src[keep].astype(np.int32), dst[keep].astype(np.int32),
                      n, **kw)


def build(topology, device=None) -> Graph:
    """A graph from a topology description: any object with the
    reference's ``TopologyConfig`` fields (``kind``, ``n_nodes``, ``p``,
    ``k``, ``seed``)."""
    kind, n = topology.kind, topology.n_nodes
    if kind == "erdos_renyi":
        return erdos_renyi(n, topology.p, topology.seed, device=device)
    if kind == "barabasi_albert":
        return barabasi_albert(n, topology.k, topology.seed, device=device)
    if kind == "watts_strogatz":
        return watts_strogatz(n, topology.k, topology.p, topology.seed,
                              device=device)
    if kind == "ring":
        return ring(n, device=device)
    if kind == "chord":
        return chord(n, device=device)
    if kind == "kademlia":
        return kademlia(n, topology.k, device=device)
    if kind == "complete":
        return complete(n, device=device)
    raise ValueError(f"unknown topology kind: {kind!r}")
