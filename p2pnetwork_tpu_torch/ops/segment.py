"""Edge-aggregation dispatch (torch counterpart of
``p2pnetwork_tpu/ops/segment.py``).

- ``propagate_or`` — per-receiver OR of a bool node signal (flooding);
- ``propagate_sum`` — per-receiver sum of an f32 node signal;
- ``frontier_messages`` — the point-to-point sends a frontier makes.

Methods, as in the reference:

- ``segment``: COO edges -> ``index_add_`` (plain PyTorch, any graph);
- ``gather``: padded neighbor table -> row gather + reduce;
- ``blocked``: the blocked layout, plain PyTorch (``ops/blocked.py``);
- ``pallas``: the blocked layout through the CUDA segment-sum kernel
  (``ops/segsum.py``; the name is the reference's);
- ``hybrid`` / ``hybrid-blocked``: diagonals by roll, the remainder by the
  kernel or its plain version (``ops/diag.py``);
- ``auto``: ``gather`` while the table's padding waste is bounded, else
  ``segment``.

``skew`` and ``frontier`` are not ported yet and raise.
"""

from __future__ import annotations

import torch

from p2pnetwork_tpu_torch.ops import blocked as B
from p2pnetwork_tpu_torch.ops import diag as D
from p2pnetwork_tpu_torch.sim.graph import Graph

#: ``auto`` prefers the neighbor-table gather only while the table's
#: padding waste (slots / true edges) stays under this bound — the
#: reference's routing rule, kept so ``auto`` picks the same method.
_GATHER_WASTE_BOUND = 4.0

_NOT_PORTED = ("skew", "frontier")


def _gather_ok(graph: Graph) -> bool:
    if graph.neighbors is None or not graph.neighbors_complete:
        return False
    slots = graph.neighbors.shape[0] * graph.neighbors.shape[1]
    return slots <= _GATHER_WASTE_BOUND * max(graph.n_edges, 1)


def _auto_method(graph: Graph) -> str:
    """``auto``'s routing: the plain table while its waste is bounded,
    segment otherwise (the port carries no skew table)."""
    return "gather" if _gather_ok(graph) else "segment"


def _require_complete_table(graph: Graph) -> None:
    if graph.neighbors is None:
        raise ValueError("method='gather' requires a graph with a neighbor table")
    if not graph.neighbors_complete:
        raise ValueError(
            "method='gather' on a width-capped neighbor table would silently "
            "drop edges; use method='segment' for exact aggregation")


def _resolve(graph: Graph, method: str) -> str:
    if method in _NOT_PORTED:
        raise NotImplementedError(f"method={method!r} is not ported yet")
    if method == "auto":
        method = _auto_method(graph)
    if method == "gather":
        _require_complete_table(graph)
    elif method in ("blocked", "pallas") and graph.blocked is None:
        raise ValueError(f"method={method!r} requires a graph built with "
                         f"blocked=True")
    elif method in ("hybrid", "hybrid-blocked") and graph.hybrid is None:
        raise ValueError(f"method={method!r} requires a graph built with "
                         f"hybrid=True")
    elif method not in ("segment", "blocked", "pallas", "hybrid",
                        "hybrid-blocked"):
        raise ValueError(f"unknown aggregation method {method!r}")
    return method


def propagate_or(graph: Graph, signal: torch.Tensor,
                 method: str = "auto") -> torch.Tensor:
    """Per-node OR over incoming neighbors: ``out[v] = any(signal[u], u->v)``.
    ``signal`` is bool[N_pad]; padding edges and nodes contribute nothing."""
    method = _resolve(graph, method)
    if method == "gather":
        vals = signal[graph.neighbors] & graph.neighbor_mask
        return vals.any(dim=1) & graph.node_mask
    if method == "blocked":
        return B.propagate_or_blocked(graph.blocked, signal, graph.node_mask)
    if method == "pallas":
        return B.propagate_or_kernel(graph.blocked, signal, graph.node_mask)
    if method in ("hybrid", "hybrid-blocked"):
        kernel = "pallas" if method == "hybrid" else "blocked"
        return D.propagate_or_hybrid(graph.hybrid, signal, graph.node_mask,
                                     kernel=kernel)
    contrib = (signal[graph.senders] & graph.edge_mask).to(torch.int32)
    agg = torch.zeros(graph.n_nodes_padded, dtype=torch.int32,
                      device=signal.device)
    agg.index_add_(0, graph.receivers, contrib)
    return (agg > 0) & graph.node_mask


def propagate_sum(graph: Graph, signal: torch.Tensor,
                  method: str = "auto") -> torch.Tensor:
    """Per-node sum over incoming neighbors: ``out[v] = sum(signal[u], u->v)``.
    The reference's ``exact=False`` (bf16 MXU inputs) has no counterpart:
    the CUDA kernel always adds f32 terms in f32."""
    method = _resolve(graph, method)
    fmask = graph.node_mask.to(signal.dtype)
    if method == "gather":
        vals = signal[graph.neighbors] * graph.neighbor_mask.to(signal.dtype)
        return vals.sum(dim=1) * fmask
    if method == "blocked":
        return B.propagate_sum_blocked(graph.blocked, signal, graph.node_mask)
    if method == "pallas":
        return B.propagate_sum_kernel(graph.blocked, signal, graph.node_mask)
    if method in ("hybrid", "hybrid-blocked"):
        kernel = "pallas" if method == "hybrid" else "blocked"
        return D.propagate_sum_hybrid(graph.hybrid, signal, graph.node_mask,
                                      kernel=kernel)
    contrib = signal[graph.senders] * graph.edge_mask.to(signal.dtype)
    agg = torch.zeros(graph.n_nodes_padded, dtype=signal.dtype,
                      device=signal.device)
    agg.index_add_(0, graph.receivers, contrib)
    return agg * fmask


def frontier_messages(graph: Graph, frontier: torch.Tensor) -> torch.Tensor:
    """Point-to-point sends this round: every frontier node sends on each
    of its outgoing edges (i64 scalar)."""
    return torch.where(frontier, graph.out_degree, 0).sum()
