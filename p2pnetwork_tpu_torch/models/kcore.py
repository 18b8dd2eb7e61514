"""K-core decomposition by peeling (torch counterpart of
``p2pnetwork_tpu/models/kcore.py``).

Every node counts its live in-core neighbors (one ``propagate_sum`` of
the i32 membership indicator a round: B1's sum entry under ``pallas``
and ``hybrid``); a node with fewer than ``k`` leaves. Run with
``engine.run_until_converged(stat="removed", threshold=1)``; at
quiescence ``state.in_core`` is the k-core. The count's dtype follows the
reference's promotion (``ops/segment.py`` ``propagate_sum``); a 0/1 sum
is exact in each.
"""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch.ops import segment
from p2pnetwork_tpu_torch.sim.graph import Graph


@dataclasses.dataclass(frozen=True)
class KCoreState:
    in_core: torch.Tensor  # bool[N_pad] — still a k-core candidate


@dataclasses.dataclass(frozen=True)
class KCore:
    """Iterative k-core peeling; ``method`` is ``propagate_sum``'s
    lowering (any of them)."""

    k: int
    method: str = "auto"

    STATS = ("messages", "removed", "core_size")

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")

    def init(self, graph: Graph, key) -> KCoreState:
        return KCoreState(in_core=graph.node_mask)

    def step(self, graph: Graph, state: KCoreState, key):
        live_deg = segment.propagate_sum(
            graph, state.in_core.to(torch.int32), self.method, exact=False)
        in_core = state.in_core & (live_deg >= self.k)
        removed = state.in_core & ~in_core
        # Leavers notify each neighbor once.
        return KCoreState(in_core=in_core), {
            "messages": segment.frontier_messages(graph, removed),
            "removed": removed.sum(), "core_size": in_core.sum()}
