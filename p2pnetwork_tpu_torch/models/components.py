"""Connected components by label flooding (torch counterpart of
``p2pnetwork_tpu/models/components.py``).

The leader election's propagation read another way: at quiescence each
node holds the highest live id of its component, so the live nodes still
holding their own id count the components (``components``, which only
falls as floods merge). Run with ``engine.run_until_converged(
stat="changed", threshold=1)``. Labels flow along edge direction: on the
symmetric graphs the builders make this is connected components.
"""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch.models.leader import max_flood_step, own_ids
from p2pnetwork_tpu_torch.sim.graph import Graph


@dataclasses.dataclass(frozen=True)
class ConnectedComponentsState:
    label: torch.Tensor  # i32[N_pad] — highest live id heard; -1 on dead nodes
    frontier: torch.Tensor  # bool[N_pad] — adopted a new label last round


@dataclasses.dataclass(frozen=True)
class ConnectedComponents:
    """Max-label flooding to a per-component fixpoint; ``method`` is
    ``propagate_max``'s lowering."""

    method: str = "auto"

    STATS = ("messages", "changed", "components")

    def init(self, graph: Graph, key) -> ConnectedComponentsState:
        return ConnectedComponentsState(label=own_ids(graph),
                                        frontier=graph.node_mask)

    def components(self, graph: Graph, state: ConnectedComponentsState):
        """Live nodes still labelled with their own id."""
        ids = torch.arange(graph.n_nodes_padded, dtype=torch.int32,
                           device=graph.device)
        return ((state.label == ids) & graph.node_mask).sum()

    def step(self, graph: Graph, state: ConnectedComponentsState, key):
        label, changed, msgs = max_flood_step(graph, state.label,
                                              state.frontier, self.method)
        new_state = ConnectedComponentsState(label=label, frontier=changed)
        return new_state, {"messages": msgs, "changed": changed.sum(),
                           "components": self.components(graph, new_state)}
