"""Frontier statistics (torch counterpart of the part of
``p2pnetwork_tpu/ops/frontier.py`` the flood main path reads). The
frontier-compacted ``method="frontier"`` lowering is not ported yet."""

from __future__ import annotations

import torch

from p2pnetwork_tpu_torch.sim.graph import Graph


def occupancy(graph: Graph, frontier: torch.Tensor) -> torch.Tensor:
    """Active fraction of live nodes (f32 scalar): the integer counts
    divided in f32, as the reference divides them."""
    n = graph.node_mask.sum().clamp_min(1)
    live = (frontier & graph.node_mask).sum()
    return live.to(torch.float32) / n.to(torch.float32)
