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
topology description). The incremental builds: :class:`GraphDelta` with
:func:`apply_delta` (edge churn, byte-equal to a fresh :func:`from_edges`
of the merged edge list) and :func:`grow` (new node ids, geometric
capacity). Each build records its host phases
(:func:`last_build_phases`, ``sim_graph_build_seconds_total{phase}``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from p2pnetwork_tpu_torch import _device, telemetry


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


# ------------------------------------------------------ build-phase timing
#
# Where a host build's time goes (dedup, sort, neighbor tables, CSR,
# layouts, the delta passes): per-phase wall seconds accumulate into
# ``sim_graph_build_seconds_total{phase}``, and the latest build's
# breakdown on this thread is :func:`last_build_phases`.

_phases_tls = threading.local()


def _phases_dict() -> dict:
    d = getattr(_phases_tls, "d", None)
    if d is None:
        d = _phases_tls.d = {}
    return d


def _build_seconds():
    return telemetry.default_registry().counter(
        "sim_graph_build_seconds_total",
        "Host-side graph construction wall seconds by build phase.",
        ("phase",))


def _reset_phases() -> None:
    """Start a fresh per-build record, folding in the dedup time a
    generator spent just before it called :func:`from_edges`."""
    d = _phases_dict()
    d.clear()
    pending = getattr(_phases_tls, "pending_dedup", 0.0)
    if pending:
        d["dedup_s"] = round(pending, 6)
        _phases_tls.pending_dedup = 0.0


def _note_dedup(seconds: float) -> None:
    """Generator-side dedup time, credited to the next build."""
    _phases_tls.pending_dedup = getattr(
        _phases_tls, "pending_dedup", 0.0) + seconds
    _build_seconds().labels("dedup").inc(seconds)


def last_build_phases() -> dict:
    """Per-phase wall seconds (``<phase>_s``) of the most recent build
    (``from_edges``, ``apply_delta`` or ``grow``) on this thread."""
    return dict(_phases_dict())


def _note_phase(name: str, seconds: float) -> None:
    d = _phases_dict()
    d[name + "_s"] = round(d.get(name + "_s", 0.0) + seconds, 6)
    _build_seconds().labels(name).inc(seconds)


class _phase:
    """Context manager timing one build phase into the thread's record and
    ``sim_graph_build_seconds_total{phase}``."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _note_phase(self.name, time.perf_counter() - self._t0)
        return False


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

    def apply_delta(self, delta: "GraphDelta", *,
                    edge_pad_multiple: Optional[int] = None,
                    donate: bool = False) -> "Graph":
        """Apply an add/remove edge batch incrementally: see
        :func:`apply_delta`."""
        return apply_delta(self, delta, edge_pad_multiple=edge_pad_multiple,
                           donate=donate)

    def grow(self, n_new_nodes: int, *,
             node_capacity: Optional[int] = None) -> "Graph":
        """Add ``n_new_nodes`` fresh node ids: see :func:`grow`."""
        return grow(self, n_new_nodes, node_capacity=node_capacity)

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


# ------------------------------------------------------- incremental builds
#
# The base COO is receiver-sorted already, so a delta needs only the
# DELTA sorted, plus linear passes to splice it in. These are the port's
# forms of the reference's native merge passes (``p2pnetwork_tpu/native``,
# same results): each binary-searches the delta's ~A entries in the
# E-long sorted arrays, never the other way round, and never sorts E.


def _pair_keys(r: np.ndarray, s: np.ndarray) -> np.ndarray:
    """int64 ``(receiver, sender)`` keys ordering like the pair."""
    return (r.astype(np.int64) << 32) | s.astype(np.int64)


def _delta_antimerge(base_r, base_s, alive, rem_r, rem_s):
    """``(keep, matched)``: the live base edges not removed, and per
    removal whether it hit a live edge. Every live copy of a matched pair
    is removed. ``base_r`` is non-decreasing over all its slots."""
    keep = np.asarray(alive, dtype=bool).copy()
    if rem_r.size == 0 or base_r.size == 0:
        return keep, np.zeros(rem_r.size, dtype=bool)
    # A removal's candidates are the run of its receiver.
    starts = np.searchsorted(base_r, rem_r, side="left")
    counts = np.searchsorted(base_r, rem_r, side="right") - starts
    if int(counts.sum()) > base_r.size:
        # Hub receivers: one pass over every slot's pair key instead.
        uk = np.unique(_pair_keys(rem_r, rem_s))
        bk = _pair_keys(base_r, base_s)
        pos = np.searchsorted(uk, bk)
        hit = keep & (uk[np.minimum(pos, uk.size - 1)] == bk)
        matched_unique = np.zeros(uk.size, dtype=bool)
        matched_unique[pos[hit]] = True
        keep &= ~hit
        return keep, matched_unique[np.searchsorted(
            uk, _pair_keys(rem_r, rem_s))]
    owner = np.repeat(np.arange(rem_r.size), counts)
    slot = np.arange(owner.size) + np.repeat(starts - np.cumsum(counts)
                                             + counts, counts)
    hit = keep[slot] & (base_s[slot] == rem_s[owner])
    matched = np.zeros(rem_r.size, dtype=bool)
    matched[owner[hit]] = True
    keep[slot[hit]] = False
    return keep, matched


def _delta_merge(base_r, base_s, keep, d_r, d_s, out_r, out_s):
    """Stable merge of the kept base edges with a receiver-sorted delta,
    base first on ties (what a stable sort of ``[kept, delta]`` gives),
    written into ``out_r``/``out_s``. Returns ``(posa, posb)``: each base
    slot's merged index (-1 when dropped) and each delta entry's."""
    kept_idx = np.flatnonzero(keep)
    kr, ks = base_r[kept_idx], base_s[kept_idx]
    # A kept edge moves up by the delta receivers strictly below its own.
    below = np.zeros(int(base_r.max(initial=0)) + 2, dtype=np.int32)
    np.cumsum(np.bincount(d_r, minlength=below.size - 1)[:below.size - 1],
              out=below[1:])
    posk = np.arange(kr.size, dtype=np.int32) + below[kr]
    posd = np.arange(d_r.size, dtype=np.int32) + np.searchsorted(
        kr, d_r, side="right").astype(np.int32)
    out_r[posk], out_s[posk] = kr, ks
    out_r[posd], out_s[posd] = d_r, d_s
    posa = np.full(base_r.size, -1, dtype=np.int32)
    posa[kept_idx] = posk
    return posa, posd


def _merge_eids_by_sender(senders, ea, eb, out):
    """Merge two edge-id lists, each sorted by ``(senders[eid], eid)``,
    into ``out`` in that order (the incremental source-CSR merge)."""
    ka = (senders[ea].astype(np.int64) << 32) | ea
    kb = (senders[eb].astype(np.int64) << 32) | eb
    at = np.arange(eb.size) + np.searchsorted(ka, kb, side="right")
    from_b = np.zeros(out.size, dtype=bool)
    from_b[at] = True
    out[at] = eb
    out[~from_b] = ea
    return out


def _as_edge_array(x, dtype=np.int32) -> np.ndarray:
    if x is None:
        return np.zeros(0, dtype=dtype)
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype=dtype).reshape(-1)


class EdgeEndpointError(ValueError):
    """A delta edge names a node id outside ``[0, n_nodes)``. Raised at
    :func:`apply_delta` entry, before any array is touched. ``pairs``
    holds up to 16 offending ``(sender, receiver)`` tuples and ``n_nodes``
    the bound; the message is the reference's."""

    def __init__(self, pairs, n_nodes: int):
        self.pairs = [(int(s), int(r)) for s, r in pairs]
        self.n_nodes = int(n_nodes)
        shown = ", ".join(f"({s}, {r})" for s, r in self.pairs[:5])
        more = ("" if len(self.pairs) <= 5
                else f", +{len(self.pairs) - 5} more")
        super().__init__(
            f"edge endpoint out of range: edge(s) name a node id outside "
            f"[0, {self.n_nodes}) as (sender, receiver): {shown}{more}")


def _check_endpoints(senders: np.ndarray, receivers: np.ndarray,
                     n_nodes: int) -> None:
    """Raise :class:`EdgeEndpointError` for an edge naming an id outside
    ``[0, n_nodes)``."""
    if not senders.size:
        return
    bad = ((senders < 0) | (senders >= n_nodes)
           | (receivers < 0) | (receivers >= n_nodes))
    if bad.any():
        idx = np.flatnonzero(bad)[:16]
        raise EdgeEndpointError(
            list(zip(senders[idx], receivers[idx])), n_nodes)


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """A host-side add/remove batch of directed edges for
    :func:`apply_delta` (host arrays; :meth:`undirected` stores both
    directions of every pair). ``add_weights`` is required exactly when
    the graph carries ``edge_weight``. Every removed ``(sender,
    receiver)`` pair must match a live edge, and removal drops all its
    live copies."""

    add_senders: Optional[np.ndarray] = None  # i32[A]
    add_receivers: Optional[np.ndarray] = None  # i32[A]
    add_weights: Optional[np.ndarray] = None  # f32[A]
    remove_senders: Optional[np.ndarray] = None  # i32[R]
    remove_receivers: Optional[np.ndarray] = None  # i32[R]

    def __post_init__(self):
        set_ = object.__setattr__  # frozen dataclass
        for name in ("add_senders", "add_receivers", "remove_senders",
                     "remove_receivers"):
            set_(self, name, _as_edge_array(getattr(self, name)))
        if self.add_weights is not None:
            set_(self, "add_weights",
                 _as_edge_array(self.add_weights, np.float32))
            if self.add_weights.shape != self.add_senders.shape:
                raise ValueError("add_weights must align with add_senders")
        if self.add_senders.shape != self.add_receivers.shape:
            raise ValueError("add_senders/add_receivers shape mismatch")
        if self.remove_senders.shape != self.remove_receivers.shape:
            raise ValueError(
                "remove_senders/remove_receivers shape mismatch")

    @classmethod
    def undirected(cls, add_senders=None, add_receivers=None,
                   add_weights=None, remove_senders=None,
                   remove_receivers=None) -> "GraphDelta":
        """Both directions of every pair, as the generators store an
        undirected overlay."""
        a_s, a_r = _as_edge_array(add_senders), _as_edge_array(add_receivers)
        r_s = _as_edge_array(remove_senders)
        r_r = _as_edge_array(remove_receivers)
        a_w = None
        if add_weights is not None:
            w = _as_edge_array(add_weights, np.float32)
            a_w = np.concatenate([w, w])
        return cls(add_senders=np.concatenate([a_s, a_r]),
                   add_receivers=np.concatenate([a_r, a_s]),
                   add_weights=a_w,
                   remove_senders=np.concatenate([r_s, r_r]),
                   remove_receivers=np.concatenate([r_r, r_s]))

    @property
    def n_adds(self) -> int:
        return int(self.add_senders.size)

    @property
    def n_removes(self) -> int:
        return int(self.remove_senders.size)


def _host(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.cpu().numpy()


def _delta_neighbor_tables(graph: Graph, out_r, out_s, w_unpadded,
                           static_in, touched, pristine, donate):
    """The neighbor-table part of :func:`apply_delta`: the base table with
    only the touched rows recomputed (and every width-capped row: their
    subsample draws share one RNG stream), byte-equal to the table
    :func:`from_edges` builds from the merged list. With ``donate`` (a
    pristine base, same width) the rows are written into the base's
    tensors in place. Returns ``(neighbors, mask, weight, complete)``,
    tensors on the device or host arrays."""
    e_new = out_r.size
    n_pad = graph.n_nodes_padded
    width_old = graph.max_degree
    true_width = int(static_in.max()) if e_new else 0
    cap = graph.max_degree_cap
    if cap is None and not graph.neighbors_complete:
        cap = width_old  # an incomplete table's width is its cap
    if cap is None:
        complete, width = True, max(true_width, 1)
    else:
        complete = cap >= true_width
        width = max(min(true_width, cap), 1)
    weighted = graph.neighbor_weight is not None
    in_place = donate and pristine and width == width_old
    if not pristine:
        # A failure-masked base: copied rows would keep their holes while
        # a rebuild compacts them, so every row is recomputed.
        touched = np.arange(n_pad, dtype=np.int32)
    if not complete or not graph.neighbors_complete:
        touched = np.union1d(touched, np.flatnonzero(static_in > width))
    rows = np.asarray(touched, dtype=np.int32)

    vals = valid = wvals = None
    if rows.size:
        vals, valid, wvals = _neighbor_table(out_s, out_r, e_new, n_pad,
                                             width, w_unpadded, rows=rows)

    if in_place:
        nb, nbm, nw = graph.neighbors, graph.neighbor_mask, \
            graph.neighbor_weight
        if rows.size:
            idx = torch.from_numpy(rows.astype(np.int64)).to(graph.device)
            nb.index_copy_(0, idx, torch.from_numpy(vals).to(graph.device))
            nbm.index_copy_(0, idx, torch.from_numpy(valid).to(graph.device))
            if weighted:
                nw.index_copy_(0, idx, torch.from_numpy(wvals).to(
                    graph.device))
        return nb, nbm, nw, complete

    nw = None
    if width == width_old and pristine:
        nb, nbm = _host(graph.neighbors).copy(), _host(
            graph.neighbor_mask).copy()
        if weighted:
            nw = _host(graph.neighbor_weight).copy()
    else:
        nb = np.zeros((n_pad, width), dtype=np.int32)
        nbm = np.zeros((n_pad, width), dtype=bool)
        if weighted:
            nw = np.zeros((n_pad, width), dtype=np.float32)
        if pristine:
            c = min(width, width_old)
            nb[:, :c] = _host(graph.neighbors)[:, :c]
            nbm[:, :c] = _host(graph.neighbor_mask)[:, :c]
            if weighted:
                nw[:, :c] = _host(graph.neighbor_weight)[:, :c]
    if rows.size:
        nb[rows], nbm[rows] = vals, valid
        if weighted:
            nw[rows] = wvals
    return nb, nbm, nw, complete


def apply_delta(graph: Graph, delta: GraphDelta, *,
                edge_pad_multiple: Optional[int] = None,
                donate: bool = False) -> Graph:
    """Apply a :class:`GraphDelta` incrementally: the result is byte-equal
    to ``from_edges(kept + adds, n_nodes, ...)`` with the base's layout
    settings, where ``kept`` is the base's LIVE edges in sorted order
    minus the removed pairs. So edges masked by failures are dropped for
    good, ``node_mask`` is kept as it is, the blocked / hybrid / skew
    layouts are rebuilt from the merged arrays with their recorded tuning
    (the hybrid diagonal budget at its defaults, as the reference), and
    the dynamic region and ``layout_perm`` ride along. Delta ids speak
    the graph's (possibly relabeled) id space.

    The host work is O(delta + touched rows) plus linear passes: only the
    delta is sorted, the merge and the source-CSR update are searchsorted
    splices, and only the touched neighbor-table rows are recomputed.

    ``donate=True`` is the rolling form ``g = apply_delta(g, d,
    donate=True)``: on a pristine base (no failure-masked edge) with an
    unchanged table width, the touched neighbor-table rows and the degree
    updates are written into the base graph's tensors in place
    (``index_copy_`` / ``index_add_``) instead of copying the table. The
    base graph, and any graph sharing those tensors, must not be read
    afterwards. The result is byte-equal to ``donate=False``'s.
    """
    _reset_phases()
    n_pad = graph.n_nodes_padded
    dev = graph.device
    pad_mult = edge_pad_multiple or graph.edge_pad_multiple
    add_s, add_r = delta.add_senders, delta.add_receivers
    rem_s, rem_r = delta.remove_senders, delta.remove_receivers
    _check_endpoints(add_s, add_r, graph.n_nodes)
    _check_endpoints(rem_s, rem_r, graph.n_nodes)
    weighted = graph.edge_weight is not None
    if weighted and add_s.size and delta.add_weights is None:
        raise ValueError(
            "graph carries edge weights; GraphDelta adds need add_weights")
    if not weighted and delta.add_weights is not None:
        raise ValueError("add_weights on an unweighted graph: build with "
                         "from_edges(weights=...) first")

    with _phase("delta_sort"):
        # Adds stably by receiver (the order a stable sort of the appended
        # batch gives), removals by (receiver, sender) for the anti-merge.
        add_w = delta.add_weights
        if add_s.size:
            _, perm = sort_pairs(add_r, np.arange(add_s.size,
                                                  dtype=np.int32))
            add_r, add_s = add_r[perm], add_s[perm]
            if weighted:
                add_w = add_w[perm]
        if rem_s.size:
            order = np.lexsort((rem_s, rem_r))
            rem_r, rem_s = rem_r[order], rem_s[order]

    base_s, base_r = _host(graph.senders), _host(graph.receivers)
    emask = _host(graph.edge_mask)
    # Pristine: every build edge still live, the precondition for
    # copy-then-patch of the neighbor table and the CSR.
    pristine = int(np.count_nonzero(emask)) == graph.n_edges

    with _phase("delta_merge"):
        keep, matched = _delta_antimerge(base_r, base_s, emask, rem_r, rem_s)
        if not bool(matched.all()):
            missing = np.flatnonzero(~matched)[:5]
            pairs = [(int(rem_s[i]), int(rem_r[i])) for i in missing]
            raise ValueError(
                f"{int((~matched).sum())} removal pair(s) match no live "
                f"edge (first few as (sender, receiver): {pairs})")
        e_new = int(np.count_nonzero(keep)) + int(add_s.size)
        e_pad = _round_up(max(e_new, 1), pad_mult)
        s_arr = np.zeros(e_pad, dtype=np.int32)
        r_arr = np.full(e_pad, n_pad - 1, dtype=np.int32)
        posa, posb = _delta_merge(base_r, base_s, keep, add_r, add_s,
                                  r_arr, s_arr)
        out_r, out_s = r_arr[:e_new], s_arr[:e_new]
        emask_new = np.zeros(e_pad, dtype=bool)
        emask_new[:e_new] = True
        w_arr = w_unpadded = None
        if weighted:
            w_host = _host(graph.edge_weight)
            w_arr = np.zeros(e_pad, dtype=np.float32)
            kept_slots = posa >= 0
            w_arr[posa[kept_slots]] = w_host[kept_slots]
            if add_s.size:
                w_arr[posb] = add_w
            w_unpadded = w_arr[:e_new]

    with _phase("delta_degrees"):
        # Degrees update from the batch alone. The dynamic region's links
        # stay inside in_degree/out_degree; only the static views (span,
        # table width, CSR counts) subtract them.
        rm_pos = (np.flatnonzero(emask ^ keep) if rem_s.size
                  else np.zeros(0, dtype=np.int64))
        idx_r = np.concatenate([base_r[rm_pos], add_r]).astype(np.int64)
        idx_s = np.concatenate([base_s[rm_pos], add_s]).astype(np.int64)
        step = np.concatenate([np.full(rm_pos.size, -1, np.int32),
                               np.ones(add_s.size, np.int32)])
        if donate:
            in_deg_new, out_deg_new = graph.in_degree, graph.out_degree
            if step.size:
                step_t = torch.from_numpy(step).to(dev)
                in_deg_new.index_add_(0, torch.from_numpy(idx_r).to(dev),
                                      step_t)
                out_deg_new.index_add_(0, torch.from_numpy(idx_s).to(dev),
                                       step_t)
            in_host, out_host = _host(in_deg_new), _host(out_deg_new)
        else:
            in_host = _host(graph.in_degree).copy()
            out_host = _host(graph.out_degree).copy()
            np.add.at(in_host, idx_r, step)
            np.add.at(out_host, idx_s, step)
            in_deg_new, out_deg_new = in_host, out_host
        static_in, static_out = in_host, out_host
        if graph.dyn_mask is not None:
            dm = _host(graph.dyn_mask)
            static_in = in_host - np.bincount(
                _host(graph.dyn_receivers)[dm], minlength=n_pad).astype(
                    np.int32)
            static_out = out_host - np.bincount(
                _host(graph.dyn_senders)[dm], minlength=n_pad).astype(
                    np.int32)
        max_in_span = max(int(static_in.max()) if e_new else 0, 1)

    nb = nbm = nw = None
    complete = graph.neighbors_complete
    if graph.neighbors is not None:
        with _phase("neighbor_table"):
            touched = np.unique(np.concatenate([rem_r, add_r]))
            nb, nbm, nw, complete = _delta_neighbor_tables(
                graph, out_r, out_s, w_unpadded, static_in, touched,
                pristine, donate)

    src_eid = src_offsets = None
    max_out_span = graph.max_out_span
    if graph.src_eid is not None:
        with _phase("source_csr"):
            if pristine:
                counts = static_out[:n_pad]
                src_offsets = np.zeros(n_pad + 1, dtype=np.int32)
                np.cumsum(counts, out=src_offsets[1:])
                max_out_span = int(counts.max()) if e_new else 0
                src_eid = np.full(e_pad, e_pad - 1, dtype=np.int32)
                # The survivors keep their (sender, eid) order under the
                # monotone slot map; the adds' ids merge in by sender.
                mapped = posa[_host(graph.src_eid)[:graph.n_edges]]
                kept_eids = mapped[mapped >= 0]
                if add_s.size:
                    _, add_eids = sort_pairs(add_s, posb)
                    _merge_eids_by_sender(out_s, kept_eids, add_eids,
                                          src_eid[:e_new])
                else:
                    src_eid[:e_new] = kept_eids
            else:
                src_eid, src_offsets, max_out_span = _build_source_csr(
                    s_arr, emask_new, n_pad, e_pad)

    blocked_rep, hybrid_rep, skew_rep = graph.blocked, graph.hybrid, graph.skew
    if blocked_rep is not None or hybrid_rep is not None \
            or skew_rep is not None:
        with _phase("layouts"):
            blocked_rep, hybrid_rep, skew_rep = _rebuild_layouts(
                graph, out_s, out_r, graph.n_nodes, n_pad, e_pad, w_unpadded)

    arrays = {"senders": s_arr, "receivers": r_arr, "edge_mask": emask_new,
              "in_degree": in_deg_new, "out_degree": out_deg_new}
    if nb is not None:
        arrays.update(neighbors=nb, neighbor_mask=nbm)
    if nw is not None:
        arrays["neighbor_weight"] = nw
    if src_eid is not None:
        arrays.update(src_eid=src_eid, src_offsets=src_offsets)
    if w_arr is not None:
        arrays["edge_weight"] = w_arr
    return dataclasses.replace(
        graph, n_edges=e_new, neighbors_complete=complete,
        edge_pad_multiple=pad_mult, max_in_span=max_in_span,
        blocked=blocked_rep, hybrid=hybrid_rep, skew=skew_rep,
        max_out_span=max_out_span,
        **{k: _to_device(v, dev) for k, v in arrays.items()})


def _to_device(v, dev) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.ascontiguousarray(v)).to(dev)


def _rebuild_layouts(graph: Graph, senders, receivers, n: int, n_pad: int,
                     e_pad: int, weights):
    """The graph's blocked / hybrid / skew layouts rebuilt from the live
    receiver-sorted edges with their recorded tuning (block sizes, skew
    width); the hybrid diagonal budget re-derives at its defaults."""
    from p2pnetwork_tpu_torch.ops.blocked import build_blocked_from_arrays
    from p2pnetwork_tpu_torch.ops.skew import build_skew_from_arrays

    dev = graph.device
    blocked, skew = graph.blocked, graph.skew
    if blocked is not None:
        blocked = build_blocked_from_arrays(senders, receivers, n_pad,
                                            blocked.block, device=dev)
    hybrid = _rebuild_hybrid(graph, senders, receivers, n, n_pad)
    if skew is not None:
        skew = build_skew_from_arrays(senders, receivers, n_pad, e_pad,
                                      width=skew.width, weights=weights,
                                      device=dev)
    return blocked, hybrid, skew


def _rebuild_hybrid(graph: Graph, senders, receivers, n: int, n_pad: int):
    """The graph's hybrid layout (None without one) rebuilt from the live
    receiver-sorted edges at ``n`` nodes of ``n_pad``, keeping its
    remainder's block size."""
    from p2pnetwork_tpu_torch.ops.diag import build_hybrid_from_arrays

    hybrid = graph.hybrid
    if hybrid is None:
        return None
    kw = {}
    if hybrid.remainder is not None:
        kw["block"] = hybrid.remainder.block
    return build_hybrid_from_arrays(senders, receivers, n, n_pad,
                                    device=graph.device, **kw)


# ----------------------------------------------------------- live growth


def growth_capacity(demand: int, current: int) -> int:
    """The smallest doubling of ``current`` that covers ``demand``: the
    geometric schedule that makes :func:`grow` amortized (K single-node
    steps cross O(log K) capacity boundaries)."""
    cap = max(int(current), 1)
    demand = int(demand)
    while cap < demand:
        cap *= 2
    return cap


def grow(graph: Graph, n_new_nodes: int, *,
         node_capacity: Optional[int] = None) -> Graph:
    """Add ``n_new_nodes`` fresh live node ids (``n_nodes .. n_nodes +
    n_new_nodes - 1``), repadding the node capacity on the schedule of
    :func:`growth_capacity` when it no longer covers them, or to
    ``node_capacity`` when given (>= both the current capacity and the new
    node count). Existing ids, edges, masks and the dynamic region keep
    their bytes; the capacity-dependent arrays are extended (node mask and
    degrees with zeros, neighbor-table rows empty, the COO padding tail
    re-aimed at the new ``N_pad - 1``, CSR offsets, ``layout_perm`` by the
    identity) and the blocked / hybrid / skew layouts rebuilt at the new
    capacity. The result is byte-equal to :func:`from_edges` of the same
    edges at ``node_pad_multiple=`` the new capacity. Wire the new nodes
    with :func:`apply_delta` afterwards. With nothing to change it returns
    ``graph`` itself. Counted in ``sim_graph_grow_total{repad}``."""
    if n_new_nodes < 0:
        raise ValueError("n_new_nodes must be >= 0")
    n_pad = graph.n_nodes_padded
    new_n = graph.n_nodes + int(n_new_nodes)
    new_pad = growth_capacity(new_n, n_pad)
    if node_capacity is not None:
        if int(node_capacity) < max(new_n, n_pad):
            raise ValueError(
                f"node_capacity {node_capacity} below the grown node "
                f"count {new_n} / current capacity {n_pad}")
        new_pad = int(node_capacity)
    if n_new_nodes == 0 and new_pad == n_pad:
        return graph
    _reset_phases()
    with _phase("grow"):
        g = _grow(graph, new_n, new_pad)
    telemetry.default_registry().counter(
        "sim_graph_grow_total",
        "Live overlay growth steps, split by whether node capacity "
        "repadded.", ("repad",)).labels(
            "true" if new_pad != n_pad else "false").inc()
    return g


def _grow(graph: Graph, new_n: int, new_pad: int) -> Graph:
    n_nodes, n_pad = graph.n_nodes, graph.n_nodes_padded
    e, e_pad = graph.n_edges, graph.n_edges_padded
    dev = graph.device
    s_live = r_live = None
    if graph.blocked is not None or graph.hybrid is not None \
            or graph.skew is not None:
        s_live = _host(graph.senders)[:e]
        r_live = _host(graph.receivers)[:e]

    if new_pad == n_pad:
        # Capacity holds: the new ids go live. Of the layouts only the
        # hybrid's diagonal census depends on n_nodes, so it alone is
        # rebuilt.
        nm = _host(graph.node_mask).copy()
        nm[n_nodes:new_n] = True
        hybrid = _rebuild_hybrid(graph, s_live, r_live, new_n, n_pad)
        return dataclasses.replace(graph, n_nodes=new_n, hybrid=hybrid,
                                   node_mask=_to_device(nm, dev))

    def extend(t, fill=0):
        a = _host(t)
        out = np.full((new_pad,) + a.shape[1:], fill, dtype=a.dtype)
        out[:n_pad] = a
        return out

    nm = extend(graph.node_mask)
    nm[n_nodes:new_n] = True
    # The padding receivers re-aim at the new last id, still >= every live
    # id, so the receiver order survives.
    r_arr = _host(graph.receivers).copy()
    r_arr[e:] = new_pad - 1
    arrays = {"node_mask": nm, "in_degree": extend(graph.in_degree),
              "out_degree": extend(graph.out_degree), "receivers": r_arr}
    for name in ("neighbors", "neighbor_mask", "neighbor_weight"):
        if getattr(graph, name) is not None:
            arrays[name] = extend(getattr(graph, name))
    if graph.src_offsets is not None:
        # New rows own no out-edge: the offsets' tail repeats the total.
        so = _host(graph.src_offsets)
        arrays["src_offsets"] = np.concatenate(
            [so, np.full(new_pad - n_pad, so[-1], dtype=np.int32)])
    if graph.layout_perm is not None:
        ext = np.arange(n_pad, new_pad, dtype=np.int32)
        arrays["layout_perm"] = np.concatenate([_host(graph.layout_perm),
                                                ext])
        arrays["layout_inv"] = np.concatenate([_host(graph.layout_inv), ext])
    w_live = (None if graph.edge_weight is None
              else _host(graph.edge_weight)[:e])
    blocked, hybrid, skew = _rebuild_layouts(graph, s_live, r_live, new_n,
                                             new_pad, e_pad, w_live)
    return dataclasses.replace(
        graph, n_nodes=new_n, blocked=blocked, hybrid=hybrid, skew=skew,
        **{k: _to_device(v, dev) for k, v in arrays.items()})


def _neighbor_table(senders, receivers, e, n_pad, width, weights=None,
                    rows=None):
    """Padded incoming-neighbor table ``[n_pad, width]`` and its mask, or
    with ``rows`` (ascending ids) only those rows, ``[len(rows), width]``.
    Over-degree rows get a uniform random ``width``-subset of their
    in-edges (seed 0, the reference's rule). The draws run over the capped
    rows in order, so a ``rows`` that holds every capped row gives the
    full table's bytes for its rows (:func:`apply_delta` relies on it).
    With ``weights`` (aligned with the sorted edges) also the slot-aligned
    weight view, else None."""
    if rows is None:
        rows = np.arange(n_pad)
    starts = np.searchsorted(receivers, rows)
    deg = np.searchsorted(receivers, rows, side="right") - starts
    take, valid = _padded_row_fill(starts, np.minimum(deg, width), width)
    capped = np.nonzero(deg > width)[0]
    if capped.size:
        cap_rng = np.random.default_rng(0)
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

    _reset_phases()
    layout_perm = None
    if reorder is not None:
        with _phase("reorder"):
            from p2pnetwork_tpu_torch.sim import layout

            layout_perm = layout.node_permutation(senders, receivers,
                                                  n_nodes, strategy=reorder)
            senders, receivers = layout_perm[senders], layout_perm[receivers]

    with _phase("sort"):
        if weights is not None:
            weights = np.asarray(weights, dtype=np.float32)
            if weights.shape != senders.shape:
                raise ValueError("weights must align with senders/receivers")
            receivers, perm = sort_pairs(
                receivers, np.arange(senders.size, dtype=np.int32))
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
        with _phase("neighbor_table"):
            width = int(in_deg.max()) if e else 0
            if max_degree is not None:
                neighbors_complete = max_degree >= width
                width = min(width, max_degree)
            (host["neighbors"], host["neighbor_mask"],
             host["neighbor_weight"]) = _neighbor_table(
                senders, receivers, e, n_pad, max(width, 1), weights)

    blocked_rep = hybrid_rep = skew_rep = None
    t_layouts = time.perf_counter()
    if blocked:
        blocked_rep = build_blocked_from_arrays(senders, receivers, n_pad,
                                                device=dev)
    if hybrid:
        hybrid_rep = build_hybrid_from_arrays(senders, receivers, n_nodes,
                                              n_pad, device=dev)
    if skew_table:
        skew_rep = build_skew_from_arrays(senders, receivers, n_pad, e_pad,
                                          width=skew_width, weights=weights,
                                          device=dev)
    if blocked or hybrid or skew_table:
        _note_phase("layouts", time.perf_counter() - t_layouts)
    max_out_span = 0
    if source_csr:
        with _phase("source_csr"):
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
    t0 = time.perf_counter()
    b = _pair_bits(n)
    lo = np.minimum(src, dst).astype(np.int64)
    hi = np.maximum(src, dst)
    keys = np.unique((lo << b) | hi)
    out = ((keys >> b).astype(np.int32),
           (keys & ((1 << b) - 1)).astype(np.int32))
    _note_dedup(time.perf_counter() - t0)
    return out


def erdos_renyi(n: int, p: float, seed: int = 0, **kw) -> Graph:
    """G(n, p) random graph (undirected), sampled as the reference does:
    a binomial edge count, uniform pairs with collision dedup."""
    rng = np.random.default_rng(seed)
    n_pairs = n * (n - 1) // 2
    m = rng.binomial(n_pairs, p) if n_pairs < 2**63 else int(p * n_pairs)
    if m == 0:
        return from_edges(np.zeros(0), np.zeros(0), n, **kw)
    t0 = time.perf_counter()
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
    _note_dedup(time.perf_counter() - t0)
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
