"""Frontier-compacted propagation: gather only the active rows (torch
counterpart of ``p2pnetwork_tpu/ops/frontier.py``).

``method="frontier"`` prices a round by its frontier: the active nodes are
compacted into a ``k``-slot buffer, their out-edge rows gathered through
the source-CSR view (``Graph.src_eid``/``src_offsets``) and the receivers
scattered into the output — ``k * max_out_span`` slots, whatever the edge
count. Past ``k`` active nodes the round falls back to the dense path.
The reference picks the branch on the device (``lax.cond``); the port
reads the active count on the host once per round (one sync, counted in
``_device.SYNCS``), as ``AdaptiveFlood`` does. The compaction is a cumsum
and a scatter (``jnp.nonzero(size=k, fill_value=...)``'s order and fill,
with no sync of its own). OR, max and min cannot see the order of their
terms (max and min reduce ordered keys, ``ops/extremum.py``), and each
min-plus term is the dense path's f32 add of the same operands (the
weight read at the same edge id), so every result is bit-identical to
the dense methods.

``ROUNDS`` counts the sparse and dense rounds taken. The lane-packed
variant (:func:`propagate_or_lanes_frontier`) compacts the union of every
word's frontier once and decides sparse or dense for the whole batch with
one host read.

On a rank's part of a graph (``sim/graph.py`` ``GraphPart``, the auto
path across ranks) the budget is the whole graph's (``out_span``,
``edge_slots``) and the signal is replicated, so every rank reads the
same active count and takes the same branch. A sparse round gathers the
active nodes' owned out-edges (the rank's own source-CSR rows, whose
receivers it owns) and one ``parallel/mesh.py`` ``assemble`` makes the
whole result on every rank, as the dense methods do.
"""

from __future__ import annotations

import torch

from p2pnetwork_tpu_torch import _device
from p2pnetwork_tpu_torch.ops import bitset as BS
from p2pnetwork_tpu_torch.ops import extremum as X
from p2pnetwork_tpu_torch.parallel import mesh as M
from p2pnetwork_tpu_torch.sim.graph import Graph, edge_slots, out_span

#: Sparse slots (budget * max_out_span) stay under E_pad / this factor.
CROSSOVER_SLOT_FACTOR = 2.0

#: Floor of the compaction buffer (the reference's).
_MIN_BUDGET = 128

#: Rounds the frontier lowerings ran sparse and dense.
ROUNDS = {"sparse": 0, "dense": 0}


def require_csr(graph: Graph) -> None:
    if graph.src_eid is None:
        raise ValueError(
            "method='frontier' requires the source-CSR out-edge view — "
            "build with from_edges(source_csr=True) or "
            "graph.with_source_csr()")


def budget(graph: Graph, crossover=None) -> int:
    """Node budget ``k`` of the compaction buffer. ``crossover=None``
    sizes it from the slot bound and returns 0 (sparse disabled) when even
    ``_MIN_BUDGET`` breaks it; a float in (0, 1] is a fraction of padded
    nodes, an int the budget itself. Clamped to ``[_MIN_BUDGET, n_pad]``."""
    n_pad = graph.n_nodes_padded
    span = max(out_span(graph), 1)
    if crossover is None:
        k = edge_slots(graph) // max(int(CROSSOVER_SLOT_FACTOR * span), 1)
        if k < _MIN_BUDGET:
            return 0
    elif isinstance(crossover, float):
        if not 0.0 < crossover <= 1.0:
            raise ValueError(f"crossover fraction must be in (0, 1], got "
                             f"{crossover}")
        k = int(crossover * n_pad)
    else:
        k = int(crossover)
    return max(_MIN_BUDGET, min(k, n_pad))


def budget_slots(graph: Graph, crossover=None) -> int:
    """Gathered slots of one sparse round, ``k * max_out_span`` (0 when
    sparse is disabled)."""
    k = budget(graph, crossover)
    return k * max(out_span(graph), 1) if k else 0


def budget_slots_lanes(graph: Graph, crossover=None, n_words: int = 1) -> int:
    """The reference's slot bound of one lane-packed sparse round: the
    ``k * span`` gathered slots, times 32 bit-plane lanes, times the
    words. (The port scatters no bit planes — see
    :func:`propagate_or_lanes_frontier` — but keeps the reference's
    number.)"""
    return budget_slots(graph, crossover) * BS.WORD * max(n_words, 1)


def occupancy(graph: Graph, frontier: torch.Tensor) -> torch.Tensor:
    """Active fraction of live nodes (f32 scalar): the integer counts
    divided in f32, as the reference divides them."""
    n = graph.node_mask.sum().clamp_min(1)
    live = (frontier & graph.node_mask).sum()
    return live.to(torch.float32) / n.to(torch.float32)


def compact(flags: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(flags, size=k, fill_value=fill)``: the positions of
    the first ``k`` set flags in ascending order, ``fill`` after them —
    without the host sync of ``torch.nonzero``. i64[k]."""
    rank = torch.cumsum(flags, 0, dtype=torch.int64) - 1
    target = torch.where(flags & (rank < k), rank, k)
    buf = torch.full((k + 1,), fill, dtype=torch.int64, device=flags.device)
    # Unset flags all land in the spare slot k, which is dropped.
    buf.scatter_(0, target, torch.arange(flags.shape[0], device=flags.device))
    return buf[:k]


def set_true(flags: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``flags.at[idx].set(True, mode="drop")`` for ``idx`` in
    ``[0, len(flags)]``: index ``len(flags)`` is the drop sentinel."""
    n = flags.shape[0]
    out = torch.cat([flags, flags.new_zeros(1)])
    out.index_fill_(0, idx.long(), True)
    return out[:n]


def _whole(graph: Graph, out: torch.Tensor) -> torch.Tensor:
    """``out [..., N_pad]`` as is, or on a rank's part its owned slice
    from every rank (the rank's gathered edges reach only the nodes it
    owns)."""
    return M.assembled(graph, M.owned(graph, out))


def _gather_active(graph: Graph, active: torch.Tensor,
                   n_active: torch.Tensor, k: int):
    """The ``k`` compacted active node ids and their ``[k, max_out_span]``
    out-edge ids with the liveness mask (in row, a real slot, a live
    edge): on a part the rank's own rows and its own span. Only right
    when ``n_active <= k``."""
    n_pad = graph.n_nodes_padded
    valid = torch.arange(k, device=active.device) < n_active
    # Fill rows can name a real node (n_pad - 1): `valid` masks them.
    f = torch.where(valid, compact(active, k, n_pad - 1), n_pad - 1)
    eid, in_row = graph.gather_row_slots(
        graph.src_offsets[f], graph.src_offsets[f + 1],
        max(graph.max_out_span, 1))
    evalid = in_row & valid[:, None] & graph.edge_mask[eid]
    return f, eid, evalid


def _sparse_budget(graph: Graph, active: torch.Tensor, crossover):
    """``(k, n_active)`` when this round runs sparse, else None: the
    budget is 0 (sparse cannot win on this graph, see :func:`budget`) or
    the active count, read on the host (one sync), exceeds it."""
    require_csr(graph)
    k = budget(graph, crossover)
    if k:
        n_active = active.sum()
        if _device.host_bool(n_active <= k):
            ROUNDS["sparse"] += 1
            return k, n_active
    ROUNDS["dense"] += 1
    return None


def propagate_or_frontier(graph: Graph, signal: torch.Tensor, dense_fn,
                          crossover=None) -> torch.Tensor:
    """Frontier-compacted neighbor-OR; ``dense_fn(signal)`` is the dense
    fallback taken when the active count exceeds the budget."""
    sparse = _sparse_budget(graph, signal, crossover)
    if sparse is None:
        return dense_fn(signal)
    n_pad = graph.n_nodes_padded
    _, eid, evalid = _gather_active(graph, signal, sparse[1], sparse[0])
    cand = torch.where(evalid, graph.receivers[eid], n_pad).reshape(-1)
    out = set_true(torch.zeros_like(signal), cand)
    return _whole(graph, out & graph.node_mask)


def propagate_or_lanes_frontier(graph: Graph, lanes: torch.Tensor,
                                dense_fn, crossover=None) -> torch.Tensor:
    """Frontier-compacted lane-packed neighbor-OR (``lanes`` ``i32[W,
    N_pad]``, ``ops/bitset.py`` lane algebra): a node is in the batch
    frontier if any lane of any word holds it; that union is compacted
    once, read once on the host to pick sparse or dense for the whole
    batch (``dense_fn(lanes)``), and its out-edge rows serve every word.
    The gathered words go to their receivers through
    ``bitset.or_scatter_lanes``: sorted once by receiver, OR-scanned
    within each receiver's run (no run is longer than the widest
    in-degree), read at each run's end — so the slots that are not live
    edges, sent to the drop index ``n_pad``, cost no atomics on one
    address."""
    active = (lanes != 0).any(dim=0)
    sparse = _sparse_budget(graph, active, crossover)
    if sparse is None:
        return dense_fn(lanes)
    n_pad = graph.n_nodes_padded
    f, eid, evalid = _gather_active(graph, active, sparse[1], sparse[0])
    cand = torch.where(evalid, graph.receivers[eid], n_pad).reshape(-1)
    vals = torch.where(evalid, lanes[:, f][:, :, None], 0).reshape(
        lanes.shape[0], -1)
    out = BS.or_scatter_lanes(n_pad, cand, vals, span=graph.max_in_span)
    return _whole(graph, torch.where(graph.node_mask, out, 0))


def _scatter_terms(graph: Graph, eid, evalid, terms, dtype,
                   largest: bool) -> torch.Tensor:
    """Max (``largest``) or min of the gathered ``[k, span]`` ``terms``
    into their receivers, the identity elsewhere and on dead nodes. The
    slots that are not live edges (most of them while the frontier is
    small) add the identity, which changes nothing, at a node of their
    own position rather than at one drop slot: millions of atomics on one
    address would serialize on the card."""
    ident = X.identity(dtype, largest)
    keys = X.encode(terms.expand(eid.shape), largest).reshape(-1)
    agg = X.scatter_spread(keys, graph.receivers[eid].reshape(-1),
                           evalid.reshape(-1), graph.n_nodes_padded, ident,
                           largest)
    return _whole(graph, X.decode(torch.where(graph.node_mask, agg, ident),
                                  dtype, largest))


def propagate_max_frontier(graph: Graph, signal: torch.Tensor, neutral,
                           dense_fn, crossover=None) -> torch.Tensor:
    """Frontier-compacted neighbor-max. Active = holding a non-neutral
    value (``!=`` keeps NaN senders active, as the dense max spreads NaN);
    neutral senders add the identity either way."""
    active = signal != neutral
    sparse = _sparse_budget(graph, active, crossover)
    if sparse is None:
        return dense_fn(signal)
    f, eid, evalid = _gather_active(graph, active, sparse[1], sparse[0])
    return _scatter_terms(graph, eid, evalid, signal[f][:, None],
                          signal.dtype, True)


def propagate_min_plus_frontier(graph: Graph, dist: torch.Tensor, dense_fn,
                                crossover=None) -> torch.Tensor:
    """Frontier-compacted min-plus relaxation (one Bellman-Ford round).
    Active = a distance other than +inf (NaN included); a +inf sender
    adds +inf everywhere in the dense path too, so skipping it is
    exact."""
    active = dist != torch.inf
    sparse = _sparse_budget(graph, active, crossover)
    if sparse is None:
        return dense_fn(dist)
    f, eid, evalid = _gather_active(graph, active, sparse[1], sparse[0])
    w = 1.0 if graph.edge_weight is None else graph.edge_weight[eid]
    return _scatter_terms(graph, eid, evalid, dist[f][:, None] + w,
                          dist.dtype, False)
