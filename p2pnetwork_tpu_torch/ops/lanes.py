"""Non-boolean query lanes: f32/i32 lane carriers and their byte budget
(torch counterpart of ``p2pnetwork_tpu/ops/lanes.py``).

The query families (``models/querybatch.py``) carry a real value per lane:
an f32 distance, an i32 cursor, two f32 masses. Nothing packs those, so K
lanes cost K full columns and K is budgeted by bytes (:func:`lane_budget`,
refused with :class:`LaneBudgetExceeded`). Lane matrices are node-major,
``[N_pad, K]``: one gathered node row moves K contiguous lane values.

- :func:`propagate_min_plus_lanes` — K Bellman-Ford relaxations a round,
  each column exactly ``ops/segment.py`` ``propagate_min_plus``: every
  term is the same f32 add, and the minimum is taken over ordered i32 keys
  (``ops/extremum.py``), so NaN and ``-0.0`` come out as XLA's whatever
  the order (an integer ``scatter_reduce_`` under ``segment``).
- :func:`propagate_sum_lanes` — K neighbor sums. ``gather`` adds the
  table's columns in order from zero, the reference's float ops one for
  one; ``segment`` is ``index_add_`` over the receiver-sorted edges, which
  adds in edge order on the CPU and by atomics, in no fixed order, on the
  card.
- :func:`dht_hop_lanes` — one greedy DHT hop per lane. Distances are held
  in int64, so the ``0xFFFFFFFF`` sentinel of a masked slot stays the
  largest (as an i32 it would be -1 and win the ``argmin``).

The dynamic edge region is refused here, as the reference refuses it.

On a rank's part of a graph (``sim/graph.py`` ``GraphPart``, the auto
path across ranks) the lane carriers are replicated. The two propagations
compute the owned rows ``[lo, hi)`` from the rank's own edges (or its
rows of the table) and assemble the whole ``[N_pad, K]`` in one
exchange along axis 0 (``parallel/mesh.py`` ``assemble``). A DHT hop is
answered by the rank that owns the cursor, from its rows of the table,
and one ``K``-extent exchange (``mesh.combine``) gives every rank every
answer.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from p2pnetwork_tpu_torch.ops import extremum as X
from p2pnetwork_tpu_torch.ops import segment
from p2pnetwork_tpu_torch.parallel import mesh as M
from p2pnetwork_tpu_torch.sim.graph import Graph, part_of

__all__ = [
    "DEFAULT_LANE_BUDGET_BYTES",
    "LaneBudgetExceeded",
    "lane_bytes",
    "lane_budget",
    "propagate_min_plus_lanes",
    "propagate_sum_lanes",
    "dht_distance",
    "dht_hop_lanes",
]

#: Default lane-carry budget a state; ``P2P_LANE_BUDGET_BYTES`` overrides.
DEFAULT_LANE_BUDGET_BYTES = 1 << 30


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


class LaneBudgetExceeded(ValueError):
    """Lane admission refused: ``requested_bytes`` of lane carry (for
    ``capacity`` lanes of ``dtype[n_pad]`` times ``carriers``) over
    ``budget_bytes``."""

    def __init__(self, requested_bytes: int, budget_bytes: int, *,
                 capacity: int, dtype, n_pad: int, carriers: int):
        self.requested_bytes = int(requested_bytes)
        self.budget_bytes = int(budget_bytes)
        self.capacity = int(capacity)
        self.dtype = dtype
        self.n_pad = int(n_pad)
        self.carriers = int(carriers)
        super().__init__(
            f"{capacity} lanes of {_dtype_name(dtype)}[{n_pad}] x "
            f"{carriers} carrier(s) need {self.requested_bytes:,} bytes "
            f"of lane carry — over the {self.budget_bytes:,}-byte budget. "
            f"Lower K, shrink the graph, or raise the budget "
            f"(budget_bytes= / P2P_LANE_BUDGET_BYTES).")


def lane_bytes(capacity: int, dtype, n_pad: int, *,
               carriers: int = 1) -> int:
    """Bytes of lane carry for ``capacity`` lanes of one ``dtype[n_pad]``
    signal, times ``carriers``. Bool lanes pack 32 to a word; every other
    dtype pays its full width per lane. ``dtype`` is a torch or numpy
    dtype."""
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    if n_pad < 1:
        raise ValueError(f"n_pad must be >= 1, got {n_pad}")
    if carriers < 1:
        raise ValueError(f"carriers must be >= 1, got {carriers}")
    if _dtype_name(dtype) == "bool":
        words = -(-int(capacity) // 32)
        return words * 4 * int(n_pad) * int(carriers)
    return int(capacity) * _itemsize(dtype) * int(n_pad) * int(carriers)


def lane_budget(capacity: int, dtype, n_pad: int, *, carriers: int = 1,
                budget_bytes: int = None) -> int:
    """The byte cost of ``capacity`` lanes, or :class:`LaneBudgetExceeded`
    over the budget (``budget_bytes``, else ``P2P_LANE_BUDGET_BYTES``,
    else :data:`DEFAULT_LANE_BUDGET_BYTES`)."""
    cost = lane_bytes(capacity, dtype, n_pad, carriers=carriers)
    if budget_bytes is None:
        budget_bytes = int(os.environ.get("P2P_LANE_BUDGET_BYTES",
                                          DEFAULT_LANE_BUDGET_BYTES))
    if cost > int(budget_bytes):
        raise LaneBudgetExceeded(cost, budget_bytes, capacity=capacity,
                                 dtype=dtype, n_pad=n_pad, carriers=carriers)
    return cost


def _require_no_dyn(graph: Graph, what: str) -> None:
    if graph.dyn_senders is not None:
        raise ValueError(
            f"{what} does not fold the dynamic runtime-edge region — "
            "consolidate the topology (sim/topology.py consolidate) "
            "before batching queries over it")


def _lane_method(graph: Graph, method: str, what: str) -> str:
    """``method`` resolved for a lane kernel: ``auto`` is ``gather`` under
    the scalar path's waste bound, else ``segment``."""
    _require_no_dyn(graph, what)
    if method == "auto":
        method = "gather" if segment._gather_ok(graph) else "segment"
    if method not in ("gather", "segment"):
        raise ValueError(
            f"{what} supports method 'segment', 'gather' or 'auto', got "
            f"{method!r} (the skew/MXU lowerings have no lane form)")
    if method == "gather":
        segment._require_complete_table(graph)
    return method


def lane_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum`` of two f32 tensors: NaN wins and ``-0.0 < +0.0``
    (ordered keys, ``ops/extremum.py``)."""
    return X.decode(torch.minimum(X.encode(a, False), X.encode(b, False)),
                    torch.float32, False)


def propagate_min_plus_lanes(graph: Graph, dist: torch.Tensor,
                             method: str = "auto") -> torch.Tensor:
    """K min-plus relaxations: ``dist`` is ``f32[N_pad, K]`` and ``out[v,
    k] = min(dist[u, k] + w(u, v))`` over live in-edges, ``+inf`` at dead
    or in-edge-less nodes. ``gather`` takes the complete table's columns
    one by one; ``segment`` scatters the ``[E_pad, K]`` terms' keys."""
    method = _lane_method(graph, method, "propagate_min_plus_lanes")
    weighted = graph.edge_weight is not None
    ident = X.identity(torch.float32, False)
    if method == "gather":
        if weighted and graph.neighbor_weight is None:
            raise ValueError(
                "method='gather' on a weighted graph needs the aligned "
                "neighbor_weight view — build with from_edges(weights=...)"
                " or Graph.with_weights, or use method='segment'")
        out = torch.full(M.owned(graph, dist, 0).shape, ident,
                         dtype=torch.int32, device=dist.device)
        for d in range(graph.neighbors.shape[1]):
            w = graph.neighbor_weight[:, d, None] if weighted else 1.0
            keys = X.encode(dist[graph.neighbors[:, d]] + w, False)
            out = torch.minimum(out, torch.where(
                graph.neighbor_mask[:, d, None], keys, ident))
    else:
        w = graph.edge_weight[:, None] if weighted else 1.0
        keys = torch.where(graph.edge_mask[:, None],
                           X.encode(dist[graph.senders] + w, False), ident)
        out = torch.full(dist.shape, ident, dtype=torch.int32,
                         device=dist.device)
        index = graph.receivers.long()[:, None].expand(keys.shape)
        out = M.owned(graph, out.scatter_reduce_(0, index, keys,
                                                 reduce="amin"), 0)
    out = torch.where(M.owned(graph, graph.node_mask)[:, None], out,
                      ident)
    return M.assembled(graph, X.decode(out, torch.float32, False), 0)


def propagate_sum_lanes(graph: Graph, vals: torch.Tensor,
                        method: str = "auto") -> torch.Tensor:
    """K neighbor sums: ``vals`` is ``f32[N_pad, K]``, each column summed
    like ``propagate_sum(method="segment")``: ``gather`` adds the table's
    columns (receiver-sorted edge order) from zero, term by term."""
    method = _lane_method(graph, method, "propagate_sum_lanes")
    if method == "gather":
        out = torch.zeros_like(M.owned(graph, vals, 0))
        for d in range(graph.neighbors.shape[1]):
            out = out + torch.where(graph.neighbor_mask[:, d, None],
                                    vals[graph.neighbors[:, d]], 0.0)
    else:
        contrib = torch.where(graph.edge_mask[:, None], vals[graph.senders],
                              0.0)
        out = M.owned(graph, torch.zeros_like(vals).index_add_(
            0, graph.receivers, contrib), 0)
    return M.assembled(graph, out * M.owned(
        graph, graph.node_mask).to(vals.dtype)[:, None], 0)


#: Distance of a masked DHT hop candidate: above any real distance.
_DHT_FAR = 0xFFFFFFFF

#: The DHT overlay metrics.
DHT_METRICS = ("ring", "xor")


def dht_distance(node: torch.Tensor, key: torch.Tensor, n: int,
                 metric: str) -> torch.Tensor:
    """Overlay distance from ``node`` to ``key`` (int64, broadcasting):
    ``ring`` is the clockwise ``(key - node) mod n`` (floor mod, as
    ``jnp.mod``), ``xor`` Kademlia's ``node ^ key``."""
    node, key = node.to(torch.int64), key.to(torch.int64)
    if metric == "ring":
        return torch.remainder(key - node, n)
    if metric == "xor":
        return node ^ key
    raise ValueError(
        f"unknown DHT metric {metric!r} — one of {DHT_METRICS}")


def dht_hop_lanes(graph: Graph, cur: torch.Tensor, keys: torch.Tensor,
                  metric: str = "ring"):
    """One greedy DHT hop for K lookups: each cursor (``i32[K]``) steps to
    its live neighbor closest to its key, when strictly closer than the
    cursor itself. Returns ``(next_cur, hopped)``; ties go to the lowest
    neighbor slot (``argmin``'s first minimum). Needs the complete
    neighbor table."""
    segment._require_complete_table(graph)
    _require_no_dyn(graph, "dht_hop_lanes")
    if metric not in DHT_METRICS:
        raise ValueError(
            f"unknown DHT metric {metric!r} — one of {DHT_METRICS}")
    n = graph.n_nodes
    part = part_of(graph)
    cur_l = cur.long()
    if part is not None:  # the owned cursors, from the rank's own rows
        owns = (cur_l >= part.lo) & (cur_l < part.hi)
        cur_l = torch.where(owns, cur_l - part.lo, 0)
    nbrs = graph.neighbors[cur_l]                     # i32[K, D]
    valid = graph.neighbor_mask[cur_l] & graph.node_mask[nbrs.long()]
    d_nbr = torch.where(valid, dht_distance(nbrs, keys[:, None], n, metric),
                        _DHT_FAR)
    d_cur = dht_distance(cur, keys, n, metric)
    slot = torch.argmin(d_nbr, dim=1)
    best = d_nbr.gather(1, slot[:, None])[:, 0]
    hopped = best < d_cur
    nxt = nbrs.gather(1, slot[:, None])[:, 0]
    if part is not None:  # each cursor's owner answers it, 0 elsewhere
        ans = torch.where(owns, torch.stack([nxt, hopped.to(torch.int32)]),
                          0)
        nxt, hopped = M.combine(part, ans, "sum")
        hopped = hopped.to(torch.bool)
    return torch.where(hopped, nxt, cur), hopped
