"""Distance-vector routing: weighted shortest paths and next-hop tables
(torch counterpart of ``p2pnetwork_tpu/models/routing.py``).

One ``propagate_min_plus`` a round over ``graph.edge_weight`` (1 a hop
without weights), where only the nodes whose cost improved last round
advertise. At quiescence (``engine.run_until_converged(stat="changed",
threshold=1)``) ``state.dist`` holds the single-source shortest-path
costs and ``state.parent`` an optimal in-neighbor: the lowest-id
advertiser of the round the node last improved. :meth:`DistanceVector.
next_hops` gives the lowest-id optimal in-neighbor over all of them.
Both compare ``dist[u] + w`` bit for bit with the aggregate, which holds
because every lowering makes that same f32 add (``ops/segment.py``).
Runtime links count at ``segment.DYNAMIC_LINK_COST``. No random number
is drawn.
"""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch.models import base
from p2pnetwork_tpu_torch.models.flood import _over_live
from p2pnetwork_tpu_torch.ops import extremum as X
from p2pnetwork_tpu_torch.ops import segment
from p2pnetwork_tpu_torch.parallel.mesh import assemble
from p2pnetwork_tpu_torch.sim.graph import Graph, part_of

_I32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class DistanceVectorState:
    dist: torch.Tensor  # f32[N_pad] — best known cost; +inf unreached
    parent: torch.Tensor  # i32[N_pad] — an optimal in-neighbor; -1 none
    frontier: torch.Tensor  # bool[N_pad] — improved last round
    round: torch.Tensor  # i32[] — rounds executed so far


def _lowest_achiever(senders, receivers, mask, terms, incoming, n_pad):
    """Per receiver, the lowest sender whose finite ``terms`` equals
    ``incoming[receiver]`` (``_I32_MAX`` when none)."""
    hit = mask & (terms == incoming[receivers]) & torch.isfinite(terms)
    cand = torch.where(hit, senders, _I32_MAX)
    return X.scatter(cand, receivers, n_pad, _I32_MAX, False)


@dataclasses.dataclass(frozen=True)
class DistanceVector:
    """Single-source Bellman-Ford with next-hop extraction; ``method`` is
    ``propagate_min_plus``'s lowering."""

    source: int = 0
    method: str = "auto"

    STATS = ("messages", "changed", "coverage", "max_cost")
    RUNS_ON_PART = True

    def init(self, graph: Graph, key) -> DistanceVectorState:
        base.validate_source(graph, self.source)
        seed = base.source_seed(graph, self.source)
        return DistanceVectorState(
            dist=torch.where(seed, 0.0, torch.inf).to(torch.float32),
            parent=torch.full((graph.n_nodes_padded,), -1, dtype=torch.int32,
                              device=graph.device),
            frontier=seed,
            round=torch.zeros((), dtype=torch.int32, device=graph.device))

    def coverage(self, graph: Graph, state: DistanceVectorState):
        return _over_live((torch.isfinite(state.dist)
                           & graph.node_mask).sum(), graph)

    def next_hops(self, graph: Graph,
                  state: DistanceVectorState) -> torch.Tensor:
        """Per reached non-source node of a converged state, the lowest-id
        in-neighbor with ``dist[u] + w(u, v) == dist[v]``; -1 at the
        source and unreached nodes."""
        best = self._parents(graph, state.dist, state.dist)
        return torch.where(best == _I32_MAX, -1, best)

    def _parents(self, graph: Graph, signal: torch.Tensor,
                 incoming: torch.Tensor) -> torch.Tensor:
        """Lowest-id sender whose relaxation achieves ``incoming``, the
        same f32 add re-made on the edge layout."""
        n_pad = graph.n_nodes_padded
        w = graph.edge_weight if graph.edge_weight is not None else 1.0
        best = _lowest_achiever(graph.senders, graph.receivers,
                                graph.edge_mask, signal[graph.senders] + w,
                                incoming, n_pad)
        if graph.dyn_senders is not None:
            best = torch.minimum(best, _lowest_achiever(
                graph.dyn_senders, graph.dyn_receivers, graph.dyn_mask,
                signal[graph.dyn_senders] + segment.DYNAMIC_LINK_COST,
                incoming, n_pad))
        part = part_of(graph)
        if part is not None:  # the owned receivers' achievers, assembled
            best = assemble(part, best[part.lo:part.hi])
        return best

    def step(self, graph: Graph, state: DistanceVectorState, key):
        signal = torch.where(state.frontier, state.dist, torch.inf)
        incoming = segment.propagate_min_plus(graph, signal, self.method)
        improved = incoming < state.dist
        dist = torch.where(improved, incoming, state.dist)
        parent = torch.where(improved, self._parents(graph, signal, incoming),
                             state.parent)
        reached = torch.isfinite(dist) & graph.node_mask
        stats = {
            "messages": segment.frontier_messages(
                graph, state.frontier & graph.node_mask),
            "changed": improved.sum(),
            "coverage": _over_live(reached.sum(), graph),
            "max_cost": torch.where(reached, dist, -torch.inf).max(),
        }
        return DistanceVectorState(dist=dist, parent=parent,
                                   frontier=improved,
                                   round=state.round + 1), stats
