"""Push–pull gossip averaging (torch counterpart of
``p2pnetwork_tpu/models/gossip.py``).

Each node holds a value; one synchronous round has every node draw one
incoming neighbor uniformly from its neighbor row
(``base.draw_neighbor_slot``, exact against the reference) and move
``alpha`` of the way toward that neighbor's value. The initial values are
``prng.normal`` draws, the reference's bit for bit (``prng.py``); the
tests hold the values and their variance to a tolerance, the partner
draws and ``messages`` exactly.

Requires a graph built with a neighbor table (the default).
"""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch import prng
from p2pnetwork_tpu_torch.models import base
from p2pnetwork_tpu_torch.sim.graph import Graph


@dataclasses.dataclass(frozen=True)
class GossipState:
    values: torch.Tensor  # f32[N_pad]


def mean_and_variance(graph: Graph, values: torch.Tensor):
    """f32 mean and variance of ``values`` over the live nodes (the
    reference's sums, divided by the live count)."""
    n_real = graph.node_mask.sum().clamp_min(1).to(torch.float32)
    mean = (values * graph.node_mask).sum() / n_real
    var = torch.where(graph.node_mask, (values - mean) ** 2,
                      0.0).sum() / n_real
    return mean, var


@dataclasses.dataclass(frozen=True)
class Gossip:
    """Randomized pairwise averaging toward consensus."""

    #: Mixing weight toward the sampled neighbor (0.5 = halfway).
    alpha: float = 0.5

    STATS = ("messages", "variance", "mean")
    RUNS_ON_PART = True

    def init(self, graph: Graph, key) -> GossipState:
        if graph.neighbors is None:
            raise ValueError("Gossip requires a graph with a neighbor table")
        values = prng.normal(key, (graph.n_nodes_padded,),
                             device=graph.device)
        # XLA makes the product with a bool mask a select: +0, not -0,
        # where the node is dead.
        return GossipState(values=torch.where(graph.node_mask, values, 0.0))

    def step(self, graph: Graph, state: GossipState, key):
        _, partner, has_slot = base.draw_neighbor_slot(graph, key)
        has_neighbor = has_slot & graph.node_mask
        pulled = state.values[partner]
        mixed = (1.0 - self.alpha) * state.values + self.alpha * pulled
        values = torch.where(has_neighbor, mixed, state.values)
        mean, var = mean_and_variance(graph, values)
        stats = {
            # One pull + one push per sampling node.
            "messages": 2 * has_neighbor.sum(dtype=torch.int32),
            "variance": var,
            "mean": mean,
        }
        return GossipState(values=values), stats
