"""Edge-aggregation dispatch (torch counterpart of
``p2pnetwork_tpu/ops/segment.py``).

- ``propagate_or`` — per-receiver OR of a bool node signal (flooding);
- ``propagate_sum`` — per-receiver sum of an f32 node signal;
- ``propagate_max`` — per-receiver max (leader election, components);
- ``propagate_min_plus`` — per-receiver ``min(dist[u] + w(u, v))`` over
  ``Graph.edge_weight`` (1 a hop without weights): one Bellman-Ford
  round;
- ``propagate_or_lanes`` — the lane-packed OR of ``32 W`` messages at
  once (``ops/bitset.py`` lane algebra; ``gather``, ``segment``,
  ``frontier`` and ``auto``);
- ``frontier_messages`` — the point-to-point sends a frontier makes.

Methods, as in the reference:

- ``segment``: COO edges -> ``index_add_`` (plain PyTorch, any graph);
- ``gather``: padded neighbor table -> row gather + reduce;
- ``skew``: the two-level table of virtual rows (``ops/skew.py``);
- ``blocked``: the blocked layout, plain PyTorch (``ops/blocked.py``);
- ``pallas``: the blocked layout through the CUDA segment-sum kernel
  (``ops/segsum.py``; the name is the reference's);
- ``hybrid`` / ``hybrid-blocked``: diagonals by roll, the remainder by the
  kernel or its plain version (``ops/diag.py``);
- ``frontier`` (OR, max, min-plus): the active rows through the
  source-CSR view while the frontier is small, else ``auto``
  (``ops/frontier.py``);
- ``auto``: ``gather`` while the table's padding waste is bounded, else
  ``skew`` when the graph carries the table, else ``segment``.

Max and min-plus take ``segment``, ``gather``, ``skew``, ``frontier`` and
``auto`` only, as the reference: its ``blocked``/``pallas``/``hybrid``
ride a one-hot matrix product, which sums. They are scatters and row
reductions here too (no kernel), over ordered integer keys so that
``-0.0``, NaN and the order of the terms come out as XLA's
(``ops/extremum.py``).

The dynamic edge region of runtime links (``sim/topology.py``) is folded
in for every method: the static edges go through the method, the region
through one unsorted scatter, and the two are combined. On a rank's part
the region is whole on every rank (``sim/graph.py`` ``graph_part``), so
its scatter gives every rank the whole fold with no exchange of its own.

On a rank's part of a graph (``sim/graph.py`` ``GraphPart``, the
auto-sharded path across ranks of ``parallel/auto.py``) every aggregation
is owner-computes, through the same code: the method computes the owned
slice ``[lo, hi)`` from the rank's own edges (``pallas`` and ``hybrid``
launch the segment-sum kernel on the rank's own blocks;
``parallel/mesh.py`` ``owned``), and one ``assemble`` makes the whole
result on every rank (``mesh.assembled``). Every method runs there:
``auto`` decides on the whole graph, and so does ``frontier``'s budget
(``ops/frontier.py``), so every rank takes the same method and the same
branch.
"""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch.ops import bitset as BS
from p2pnetwork_tpu_torch.ops import blocked as B
from p2pnetwork_tpu_torch.ops import diag as D
from p2pnetwork_tpu_torch.ops import extremum as X
from p2pnetwork_tpu_torch.ops import frontier as FR
from p2pnetwork_tpu_torch.ops import rowsum as RS
from p2pnetwork_tpu_torch.ops import skew as SK
from p2pnetwork_tpu_torch.parallel import mesh as M
from p2pnetwork_tpu_torch.sim.graph import Graph, part_of

#: ``auto`` prefers the neighbor-table gather only while the table's
#: padding waste (slots / true edges) stays under this bound — the
#: reference's routing rule, kept so ``auto`` picks the same method.
_GATHER_WASTE_BOUND = 4.0


def _gather_ok(graph: Graph) -> bool:
    part = part_of(graph)
    if part is not None:  # the whole graph's choice, every rank's
        return part.gather_ok
    if graph.neighbors is None or not graph.neighbors_complete:
        return False
    slots = graph.neighbors.shape[0] * graph.neighbors.shape[1]
    return slots <= _GATHER_WASTE_BOUND * max(graph.n_edges, 1)


def _auto_method(graph: Graph) -> str:
    """``auto``'s routing: the plain table while its waste is bounded; the
    skew table when the graph carries one; segment otherwise."""
    if _gather_ok(graph):
        return "gather"
    return "skew" if graph.skew is not None else "segment"


def _require_complete_table(graph: Graph) -> None:
    if graph.neighbors is None:
        raise ValueError("method='gather' requires a graph with a neighbor table")
    if not graph.neighbors_complete:
        raise ValueError(
            "method='gather' on a width-capped neighbor table would silently "
            "drop edges; use method='segment' for exact aggregation")


def _resolve(graph: Graph, method: str) -> str:
    if method == "auto":
        method = _auto_method(graph)
    if method == "gather":
        _require_complete_table(graph)
    elif method == "skew" and graph.skew is None:
        raise ValueError("method='skew' requires the two-level neighbor "
                         "table — build with from_edges(skew_table=True) "
                         "or graph.with_skew_table()")
    elif method in ("blocked", "pallas") and graph.blocked is None:
        raise ValueError(f"method={method!r} requires a graph built with "
                         f"blocked=True")
    elif method in ("hybrid", "hybrid-blocked") and graph.hybrid is None:
        raise ValueError(f"method={method!r} requires a graph built with "
                         f"hybrid=True")
    elif method not in ("segment", "skew", "blocked", "pallas", "hybrid",
                        "hybrid-blocked"):
        raise ValueError(f"unknown aggregation method {method!r}")
    return method


def _lo(graph: Graph) -> int:
    """The first node ``parallel/mesh.py`` ``owned`` keeps."""
    part = part_of(graph)
    return 0 if part is None else part.lo


def _static(graph: Graph) -> Graph:
    """``graph`` without its dynamic edge region."""
    return dataclasses.replace(graph, dyn_senders=None, dyn_receivers=None,
                               dyn_mask=None)


def _dynamic_or(graph: Graph, signal: torch.Tensor) -> torch.Tensor:
    """OR over the dynamic edge region."""
    contrib = (signal[graph.dyn_senders] & graph.dyn_mask).to(torch.int32)
    agg = torch.zeros(graph.n_nodes_padded, dtype=torch.int32,
                      device=signal.device)
    agg.index_add_(0, graph.dyn_receivers, contrib)
    return (agg > 0) & graph.node_mask


def _dynamic_sum(graph: Graph, signal: torch.Tensor) -> torch.Tensor:
    """Sum over the dynamic edge region."""
    contrib = signal[graph.dyn_senders] * graph.dyn_mask.to(signal.dtype)
    agg = torch.zeros(graph.n_nodes_padded, dtype=signal.dtype,
                      device=signal.device)
    agg.index_add_(0, graph.dyn_receivers, contrib)
    return agg * graph.node_mask.to(signal.dtype)


def propagate_or(graph: Graph, signal: torch.Tensor, method: str = "auto",
                 *, frontier_crossover=None) -> torch.Tensor:
    """Per-node OR over incoming neighbors: ``out[v] = any(signal[u], u->v)``.
    ``signal`` is bool[N_pad]; padding edges and nodes contribute nothing.
    ``frontier_crossover`` overrides ``method="frontier"``'s budget
    (``ops/frontier.py`` ``budget``)."""
    if graph.dyn_senders is not None:
        return (propagate_or(_static(graph), signal, method,
                             frontier_crossover=frontier_crossover)
                | _dynamic_or(graph, signal))
    if method == "frontier":
        return FR.propagate_or_frontier(
            graph, signal, lambda sig: propagate_or(graph, sig, "auto"),
            crossover=frontier_crossover)
    method = _resolve(graph, method)
    nmask = M.owned(graph, graph.node_mask)
    if method == "gather":
        vals = signal[graph.neighbors] & graph.neighbor_mask
        out = vals.any(dim=1) & nmask
    elif method == "skew":
        out = M.owned(graph, SK.or_skew(graph.skew, signal,
                                       graph.n_nodes_padded)) & nmask
    elif method == "blocked":
        out = B.propagate_or_blocked(graph.blocked, signal, nmask)
    elif method == "pallas":
        out = B.propagate_or_kernel(graph.blocked, signal, nmask)
    elif method in ("hybrid", "hybrid-blocked"):
        kernel = "pallas" if method == "hybrid" else "blocked"
        out = D.propagate_or_hybrid(graph.hybrid, signal, nmask,
                                    kernel=kernel, lo=_lo(graph))
    else:
        contrib = (signal[graph.senders] & graph.edge_mask).to(torch.int32)
        agg = torch.zeros(graph.n_nodes_padded, dtype=torch.int32,
                          device=signal.device)
        agg.index_add_(0, graph.receivers, contrib)
        out = (M.owned(graph, agg) > 0) & nmask
    return M.assembled(graph, out)


def _dynamic_or_lanes(graph: Graph, lanes: torch.Tensor) -> torch.Tensor:
    """Lane-packed OR over the dynamic edge region (unsorted slots), every
    word at once."""
    contrib = torch.where(graph.dyn_mask, lanes[:, graph.dyn_senders], 0)
    out = BS.or_scatter_lanes(graph.n_nodes_padded, graph.dyn_receivers,
                              contrib)
    return torch.where(graph.node_mask, out, 0)


def propagate_or_lanes(graph: Graph, lanes: torch.Tensor,
                       method: str = "auto", *,
                       frontier_crossover=None) -> torch.Tensor:
    """Lane-packed neighbor-OR: ``lanes`` is ``i32[W, N_pad]`` (bit ``L``
    of word ``w`` at node ``v`` is message ``32 w + L``'s signal) and
    ``out[w, v] = OR(lanes[w, u], u -> v)``, word-level, every word in one
    pass. Methods, as the reference's:

    - ``gather``: the neighbor table's columns gathered for every word and
      OR-ed together column by column (torch has no OR reduction; 16
      columns at the batched bench's width);
    - ``segment``: any graph. The reference expands each edge's word into
      ``[E_pad, 32]`` u8 bit planes for a segment max (1 GB for 32 words on
      the 100K-node graph); the port never expands: the receiver-sorted
      edge words are OR-scanned within each receiver's run and the run's
      last slot read (``ops/bitset.py`` ``or_sorted_lanes``, ``log2`` of the
      widest run doubling passes over ``[W, E_pad]``);
    - ``frontier``: one union compaction for all words, one host read
      (``ops/frontier.py`` ``propagate_or_lanes_frontier``), dense
      fallback ``auto``;
    - ``auto``: ``gather`` under the waste bound, else ``segment`` (the
      skew and one-hot lowerings have no word-level form).

    The dynamic region is folded in for every method."""
    if graph.dyn_senders is not None:
        return (propagate_or_lanes(_static(graph), lanes, method,
                                   frontier_crossover=frontier_crossover)
                | _dynamic_or_lanes(graph, lanes))
    if method == "frontier":
        return FR.propagate_or_lanes_frontier(
            graph, lanes, lambda ln: propagate_or_lanes(graph, ln, "auto"),
            crossover=frontier_crossover)
    if method == "auto":
        method = "gather" if _gather_ok(graph) else "segment"
    if method == "gather":
        _require_complete_table(graph)
        out = torch.zeros_like(M.owned(graph, lanes))
        for d in range(graph.neighbors.shape[1]):
            out |= torch.where(graph.neighbor_mask[:, d],
                               lanes[:, graph.neighbors[:, d]], 0)
    elif method == "segment":
        contrib = torch.where(graph.edge_mask, lanes[:, graph.senders], 0)
        # The widest receiver run: a live node's in-degree, plus the
        # padding slots that all name the last padded node.
        span = graph.max_in_span + graph.n_edges_padded - graph.n_edges
        out = M.owned(graph, BS.or_sorted_lanes(
            graph.n_nodes_padded, graph.receivers, contrib, span))
    else:
        raise ValueError(
            f"propagate_or_lanes supports method 'segment', 'gather', "
            f"'frontier' or 'auto', got {method!r} (the skew/MXU lowerings "
            f"have no word-level form)")
    return M.assembled(graph, torch.where(M.owned(graph, graph.node_mask),
                                         out, 0))


def propagate_sum(graph: Graph, signal: torch.Tensor,
                  method: str = "auto", exact: bool = True) -> torch.Tensor:
    """Per-node sum over incoming neighbors: ``out[v] = sum(signal[u], u->v)``.
    ``exact`` is accepted for the reference's signature and has no
    effect: the reference's ``exact=False`` feeds the MXU bf16 inputs,
    while the CUDA kernel always adds f32 terms in f32 (0/1 sums, as SIR's,
    are exact either way). ``frontier`` is an OR lowering only, as in the
    reference. An integer signal (``KCore``'s indicator) keeps its dtype
    under ``segment``, ``gather`` and ``skew``; ``blocked`` and ``pallas``
    sum in f32, as the reference's one-hot product does, and ``hybrid``
    adds that f32 remainder to the integer diagonals (f32 too, unless the
    graph has no remainder)."""
    if graph.dyn_senders is not None:
        return (propagate_sum(_static(graph), signal, method)
                + _dynamic_sum(graph, signal))
    method = _resolve(graph, method)
    nmask = M.owned(graph, graph.node_mask)
    fmask = nmask.to(signal.dtype)
    if method == "gather":
        out = RS.gather_row_sum(signal, graph.neighbors,
                                graph.neighbor_mask) * fmask
    elif method == "skew":
        out = M.owned(graph, SK.sum_skew(graph.skew, signal,
                                        graph.n_nodes_padded)) * fmask
    elif method == "blocked":
        out = B.propagate_sum_blocked(graph.blocked, signal, nmask)
    elif method == "pallas":
        out = B.propagate_sum_kernel(graph.blocked, signal, nmask)
    elif method in ("hybrid", "hybrid-blocked"):
        kernel = "pallas" if method == "hybrid" else "blocked"
        out = D.propagate_sum_hybrid(graph.hybrid, signal, nmask,
                                     kernel=kernel, lo=_lo(graph))
    else:
        contrib = signal[graph.senders] * graph.edge_mask.to(signal.dtype)
        agg = torch.zeros(graph.n_nodes_padded, dtype=signal.dtype,
                          device=signal.device)
        agg.index_add_(0, graph.receivers, contrib)
        out = M.owned(graph, agg) * fmask
    return M.assembled(graph, out)


def neutral_min(dtype):
    """The max-aggregation identity of ``dtype``: ``-inf`` or the integer
    minimum (a Python number). Bool signals are refused: their max is
    ``propagate_or``."""
    if dtype.is_floating_point:
        return -torch.inf
    if dtype == torch.bool:
        raise ValueError(
            "max-aggregation over bool signals is just OR — use "
            "propagate_or / sharded.propagate(op='or') instead")
    return torch.iinfo(dtype).min


def _semiring_method(graph: Graph, method: str, op: str) -> str:
    """``method`` resolved for max (``op="max"``) or min-plus: ``segment``,
    ``gather`` or ``skew``, with the reference's refusals."""
    if method == "auto":
        method = _auto_method(graph)
    if method not in ("segment", "gather", "skew"):
        name = "propagate_max" if op == "max" else "propagate_min_plus"
        raise ValueError(
            f"{name} supports method 'segment', 'gather', 'skew' or "
            f"'frontier', got {method!r} ({op} does not ride the "
            f"one-hot-matmul lowerings)")
    return _resolve(graph, method)


def _dynamic_max(graph: Graph, signal: torch.Tensor) -> torch.Tensor:
    """Max over the dynamic edge region, as keys (``ops/extremum.py``)."""
    ident = X.identity(signal.dtype, True)
    keys = torch.where(graph.dyn_mask,
                       X.encode(signal, True)[graph.dyn_senders], ident)
    return X.scatter(keys, graph.dyn_receivers, graph.n_nodes_padded, ident,
                     True)


def propagate_max(graph: Graph, signal: torch.Tensor, method: str = "auto",
                  *, frontier_crossover=None) -> torch.Tensor:
    """Per-node max over incoming neighbors: ``out[v] = max(signal[u],
    u->v)``. Nodes with no live in-edge, and dead nodes, get the dtype's
    max-identity (``neutral_min``); callers fold the result into their own
    value, which makes it neutral. Methods: ``segment``, ``gather``,
    ``skew``, ``frontier`` and ``auto``."""
    if graph.dyn_senders is not None:
        static = propagate_max(_static(graph), signal, method,
                               frontier_crossover=frontier_crossover)
        return X.decode(torch.maximum(X.encode(static, True),
                                      _dynamic_max(graph, signal)),
                        signal.dtype, True)
    neutral = neutral_min(signal.dtype)
    if method == "frontier":
        return FR.propagate_max_frontier(
            graph, signal, neutral,
            lambda sig: propagate_max(graph, sig, "auto"),
            crossover=frontier_crossover)
    method = _semiring_method(graph, method, "max")
    nmask = M.owned(graph, graph.node_mask)
    if method == "skew":
        return M.assembled(graph, torch.where(nmask, M.owned(
            graph, SK.max_skew(graph.skew, signal, graph.n_nodes_padded)),
            neutral))
    ident = X.identity(signal.dtype, True)
    keys = X.encode(signal, True)
    if method == "gather":
        agg = X.rows(torch.where(graph.neighbor_mask, keys[graph.neighbors],
                                 ident), True)
    else:
        agg = M.owned(graph, X.scatter(
            torch.where(graph.edge_mask, keys[graph.senders], ident),
            graph.receivers, graph.n_nodes_padded, ident, True))
    return M.assembled(graph, X.decode(torch.where(nmask, agg, ident),
                                      signal.dtype, True))


#: Cost of a runtime link (``sim/topology.py`` ``connect``) in weighted
#: propagation: the dynamic region has no weight channel, so new links
#: cost 1 until ``topology.consolidate`` folds them in at that cost.
DYNAMIC_LINK_COST = 1.0


def _dynamic_min_plus(graph: Graph, dist: torch.Tensor) -> torch.Tensor:
    """Min-plus over the dynamic edge region (unit link cost), as keys."""
    ident = X.identity(dist.dtype, False)
    keys = torch.where(graph.dyn_mask, X.encode(
        dist[graph.dyn_senders] + DYNAMIC_LINK_COST, False), ident)
    return X.scatter(keys, graph.dyn_receivers, graph.n_nodes_padded, ident,
                     False)


def propagate_min_plus(graph: Graph, dist: torch.Tensor,
                       method: str = "auto", *,
                       frontier_crossover=None) -> torch.Tensor:
    """Per-node min-plus relaxation: ``out[v] = min(dist[u] + w(u, v))``
    over live incoming edges, one Bellman-Ford round. Weights come from
    ``graph.edge_weight`` (1 a hop without them); each edge's term is one
    f32 add of the same operands in every method, so all give the same
    bits. No live in-edge, or a dead node: ``+inf``. ``gather`` on a
    weighted graph needs ``neighbor_weight`` and ``skew`` the table's
    ``weight``; ``auto`` falls back to ``segment`` without them."""
    if graph.dyn_senders is not None:
        static = propagate_min_plus(_static(graph), dist, method,
                                    frontier_crossover=frontier_crossover)
        return X.decode(torch.minimum(X.encode(static, False),
                                      _dynamic_min_plus(graph, dist)),
                        dist.dtype, False)
    if method == "frontier":
        return FR.propagate_min_plus_frontier(
            graph, dist, lambda d: propagate_min_plus(graph, d, "auto"),
            crossover=frontier_crossover)
    weighted = graph.edge_weight is not None
    if method == "auto":
        method = _auto_method(graph)
        if method == "gather" and weighted and graph.neighbor_weight is None:
            method = "segment"
        if method == "skew" and weighted and graph.skew.weight is None:
            method = "segment"
    method = _semiring_method(graph, method, "min")
    nmask = M.owned(graph, graph.node_mask)
    ident = X.identity(dist.dtype, False)
    if method == "gather":
        if weighted and graph.neighbor_weight is None:
            raise ValueError(
                "method='gather' on a weighted graph needs the aligned "
                "neighbor_weight view — build with from_edges(weights=...) "
                "or Graph.with_weights, or use method='segment'")
        w = graph.neighbor_weight if weighted else 1.0
        agg = X.rows(torch.where(graph.neighbor_mask, X.encode(
            dist[graph.neighbors] + w, False), ident), False)
    elif method == "skew":
        if weighted and graph.skew.weight is None:
            raise ValueError(
                "method='skew' on a weighted graph needs the aligned "
                "weight view — build via from_edges(weights=..., "
                "skew_table=True) or Graph.with_weights, or use "
                "method='segment'")
        return M.assembled(graph, torch.where(nmask, M.owned(
            graph, SK.min_plus_skew(graph.skew, dist, graph.n_nodes_padded)),
            torch.inf))
    else:
        w = graph.edge_weight if weighted else 1.0
        agg = M.owned(graph, X.scatter(torch.where(graph.edge_mask, X.encode(
            dist[graph.senders] + w, False), ident),
            graph.receivers, graph.n_nodes_padded, ident, False))
    return M.assembled(graph, X.decode(torch.where(nmask, agg, ident),
                                      dist.dtype, False))


def frontier_messages(graph: Graph, frontier: torch.Tensor) -> torch.Tensor:
    """Point-to-point sends this round: every frontier node sends on each
    of its outgoing edges (i64 scalar)."""
    return torch.where(frontier, graph.out_degree, 0).sum()

