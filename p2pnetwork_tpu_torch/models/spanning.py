"""Spanning tree over the flood wave (torch counterpart of
``p2pnetwork_tpu/models/spanning.py``).

The BFS wave expands as the flood's; each newly reached node takes as its
parent the highest-id frontier node that delivered to it this round (one
``propagate_max`` of the frontier's ids a round, no random number). The
result is a rooted spanning tree of the source's component:
``parent[source] == source``, every other reached node's parent one hop
closer.
"""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch.models import base
from p2pnetwork_tpu_torch.models.flood import _over_live
from p2pnetwork_tpu_torch.ops import segment
from p2pnetwork_tpu_torch.sim.graph import Graph


@dataclasses.dataclass(frozen=True)
class SpanningTreeState:
    parent: torch.Tensor  # i32[N_pad] — -1 until reached; parent[source]=source
    frontier: torch.Tensor  # bool[N_pad] — reached last round
    dist: torch.Tensor  # i32[N_pad] — hops from source, -1 until reached
    round: torch.Tensor  # i32[]


@dataclasses.dataclass(frozen=True)
class SpanningTree:
    """BFS spanning tree from ``source``, parents the highest-id
    delivering neighbor; ``method`` is ``propagate_max``'s lowering."""

    source: int = 0
    method: str = "auto"

    STATS = ("messages", "coverage", "frontier")

    def init(self, graph: Graph, key) -> SpanningTreeState:
        base.validate_source(graph, self.source)
        seed = base.source_seed(graph, self.source)
        return SpanningTreeState(
            parent=torch.where(seed, self.source, -1).to(torch.int32),
            frontier=seed, dist=torch.where(seed, 0, -1).to(torch.int32),
            round=torch.zeros((), dtype=torch.int32, device=graph.device))

    def coverage(self, graph: Graph, state: SpanningTreeState):
        return _over_live(((state.parent >= 0) & graph.node_mask).sum(),
                          graph)

    def step(self, graph: Graph, state: SpanningTreeState, key):
        ids = torch.arange(graph.n_nodes_padded, dtype=torch.int32,
                           device=graph.device)
        # Frontier nodes offer their id; each unreached receiver adopts
        # the highest offer.
        offer = torch.where(state.frontier & graph.node_mask, ids,
                            segment.neutral_min(torch.int32))
        best = segment.propagate_max(graph, offer, self.method)
        newly = (best >= 0) & (state.parent < 0) & graph.node_mask
        rnd = state.round + 1
        parent = torch.where(newly, best, state.parent)
        stats = {
            "messages": segment.frontier_messages(
                graph, state.frontier & graph.node_mask),
            "coverage": _over_live(((parent >= 0) & graph.node_mask).sum(),
                                   graph),
            "frontier": newly.sum(),
        }
        return SpanningTreeState(parent=parent, frontier=newly,
                                 dist=torch.where(newly, rnd, state.dist),
                                 round=rnd), stats
