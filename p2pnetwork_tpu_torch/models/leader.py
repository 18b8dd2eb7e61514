"""Leader election by highest-id flooding (torch counterpart of
``p2pnetwork_tpu/models/leader.py``).

Every node nominates itself, rebroadcasts the highest live id it has
heard the round after it learned it, and adopts anything higher: one
frontier-masked ``propagate_max`` a round. At quiescence (``changed`` 0:
``engine.run_until_converged(stat="changed", threshold=1)``) each
component agrees on its highest live id. ``coverage`` is the share of
live nodes holding the global winner.
"""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch.models.flood import _over_live
from p2pnetwork_tpu_torch.ops import segment
from p2pnetwork_tpu_torch.sim.graph import Graph


@dataclasses.dataclass(frozen=True)
class LeaderElectionState:
    known: torch.Tensor  # i32[N_pad] — highest live id heard; -1 on dead nodes
    frontier: torch.Tensor  # bool[N_pad] — learned something last round


def own_ids(graph: Graph) -> torch.Tensor:
    """i32[N_pad]: each live node's id, -1 on dead nodes."""
    ids = torch.arange(graph.n_nodes_padded, dtype=torch.int32,
                       device=graph.device)
    return torch.where(graph.node_mask, ids, -1)


def max_flood_step(graph: Graph, known: torch.Tensor, frontier: torch.Tensor,
                   method: str):
    """One frontier-masked max-flood round, shared by ``LeaderElection``
    and ``ConnectedComponents``: only last round's learners send (a
    non-frontier node's value was delivered before). Returns ``(known',
    changed, messages)``."""
    signal = torch.where(frontier, known, segment.neutral_min(known.dtype))
    heard = segment.propagate_max(graph, signal, method)
    new_known = torch.where(graph.node_mask, torch.maximum(known, heard), -1)
    changed = (new_known != known) & graph.node_mask
    msgs = segment.frontier_messages(graph, frontier & graph.node_mask)
    return new_known, changed, msgs


@dataclasses.dataclass(frozen=True)
class LeaderElection:
    """Highest-live-id election; ``method`` is ``propagate_max``'s
    lowering."""

    method: str = "auto"

    STATS = ("messages", "changed", "coverage")
    RUNS_ON_PART = True

    def init(self, graph: Graph, key) -> LeaderElectionState:
        return LeaderElectionState(known=own_ids(graph),
                                   frontier=graph.node_mask)

    def coverage(self, graph: Graph, state: LeaderElectionState):
        """Fraction of live nodes already holding the global winner."""
        winner = torch.where(graph.node_mask, state.known, -1).max()
        return _over_live(((state.known == winner) & graph.node_mask).sum(),
                          graph)

    def step(self, graph: Graph, state: LeaderElectionState, key):
        known, changed, msgs = max_flood_step(graph, state.known,
                                              state.frontier, self.method)
        new_state = LeaderElectionState(known=known, frontier=changed)
        return new_state, {"messages": msgs, "changed": changed.sum(),
                           "coverage": self.coverage(graph, new_state)}
