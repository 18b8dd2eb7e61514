"""Flooding broadcast with seen-set dedup (torch counterpart of
``p2pnetwork_tpu/models/flood.py``): one round of the whole population is
one masked neighbor-OR (``ops/segment.py``)."""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch.models import base
from p2pnetwork_tpu_torch.ops import frontier, segment
from p2pnetwork_tpu_torch.sim.graph import Graph


@dataclasses.dataclass(frozen=True)
class FloodState:
    """Who has the message, and who got it last round."""

    seen: torch.Tensor  # bool[N_pad]
    frontier: torch.Tensor  # bool[N_pad]


def live_coverage(graph: Graph, seen: torch.Tensor) -> torch.Tensor:
    """Fraction of live nodes in ``seen`` (f32 scalar); the numerator is
    masked so dead-but-seen nodes never push it past 1."""
    n_real = graph.node_mask.sum().clamp_min(1)
    return ((seen & graph.node_mask).sum().to(torch.float32)
            / n_real.to(torch.float32))


@dataclasses.dataclass(frozen=True)
class Flood:
    """Single-source flood. ``source`` is the seed node, ``method`` the
    aggregation lowering (ops/segment.py). ``bitset=True`` (bit-packed
    state) is not ported yet."""

    source: int = 0
    method: str = "auto"
    bitset: bool = False

    STATS = ("messages", "coverage", "frontier", "frontier_occupancy")

    def init(self, graph: Graph) -> FloodState:
        if self.bitset:
            raise NotImplementedError("Flood(bitset=True) is not ported yet")
        base.validate_source(graph, self.source)
        seed = torch.zeros(graph.n_nodes_padded, dtype=torch.bool,
                           device=graph.device)
        seed[self.source] = True
        seed = seed & graph.node_mask
        return FloodState(seen=seed, frontier=seed)

    def coverage(self, graph: Graph, state: FloodState) -> torch.Tensor:
        return live_coverage(graph, state.seen)

    def step(self, graph: Graph, state: FloodState):
        """One synchronous round: frontier nodes broadcast; receivers that
        had not seen the message form the next frontier."""
        delivered = segment.propagate_or(graph, state.frontier, self.method)
        new = delivered & ~state.seen & graph.node_mask
        seen = state.seen | new
        stats = {
            "messages": segment.frontier_messages(graph, state.frontier),
            "coverage": live_coverage(graph, seen),
            "frontier": new.sum(),
            "frontier_occupancy": frontier.occupancy(graph, new),
        }
        return FloodState(seen=seen, frontier=new), stats
