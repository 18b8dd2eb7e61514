"""Bipartiteness / odd-cycle detection by rooted parity flooding (torch
counterpart of ``p2pnetwork_tpu/models/bipartite.py``).

The max-label flood of ``ConnectedComponents`` (``leader.max_flood_step``)
while recording each node's round of last adoption: at quiescence that
round is the node's BFS layer from its component's root (the maximum id),
and a graph is bipartite iff no edge joins two same-component nodes of
equal layer parity. Run with ``engine.run_until_converged(...,
stat="changed", threshold=1)``, then read :meth:`BipartiteCheck.odd_edges`
(directed edge slots violating parity; an undirected odd edge counts 2)
or :meth:`BipartiteCheck.component_bipartite`. Runtime links take part
in the flood and the scan. Deterministic.
"""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch.models.leader import max_flood_step
from p2pnetwork_tpu_torch.ops import extremum as X
from p2pnetwork_tpu_torch.parallel import mesh
from p2pnetwork_tpu_torch.sim.graph import Graph, part_of


@dataclasses.dataclass(frozen=True)
class BipartiteCheckState:
    label: torch.Tensor  # i32[N_pad] — highest live id heard; -1 on dead
    dist: torch.Tensor  # i32[N_pad] — round of last adoption; -1 on dead
    frontier: torch.Tensor  # bool[N_pad] — adopted a new label last round
    round: torch.Tensor  # i32[] — rounds executed so far


def _edge_sets(graph: Graph):
    """The static edges, then the dynamic region when the graph has one,
    as ``(senders, receivers, mask)``."""
    yield graph.senders, graph.receivers, graph.edge_mask
    if graph.dyn_senders is not None:
        yield graph.dyn_senders, graph.dyn_receivers, graph.dyn_mask


def _odd(label, dist, s, r, mask) -> torch.Tensor:
    """bool per slot: same-component endpoints of equal layer parity."""
    ls = label[s]
    same = mask & (ls >= 0) & (ls == label[r])
    return same & (((dist[s] ^ dist[r]) & 1) == 0)


def _odd_edge_slots(graph: Graph, label: torch.Tensor,
                    dist: torch.Tensor) -> torch.Tensor:
    """Directed edge slots violating parity (valid at quiescence); on a
    rank's part every rank's count, summed."""
    count = sum(_odd(label, dist, *e).sum() for e in _edge_sets(graph))
    part = part_of(graph)
    return count if part is None else mesh.all_sum(part.mesh, count)


@dataclasses.dataclass(frozen=True)
class BipartiteCheck:
    """Rooted parity flood to a per-component fixpoint; ``method`` is
    ``propagate_max``'s lowering."""

    method: str = "auto"

    STATS = ("messages", "changed")
    RUNS_ON_PART = True

    def init(self, graph: Graph, key) -> BipartiteCheckState:
        ids = torch.arange(graph.n_nodes_padded, dtype=torch.int32,
                           device=graph.device)
        return BipartiteCheckState(
            label=torch.where(graph.node_mask, ids, -1),
            dist=torch.where(graph.node_mask, 0, -1).to(torch.int32),
            frontier=graph.node_mask,
            round=torch.zeros((), dtype=torch.int32, device=graph.device))

    def odd_edges(self, graph: Graph,
                  state: BipartiteCheckState) -> torch.Tensor:
        """Directed edge slots violating 2-colorability (0: the live graph
        is bipartite)."""
        return _odd_edge_slots(graph, state.label, state.dist)

    def component_bipartite(self, graph: Graph,
                            state: BipartiteCheckState) -> torch.Tensor:
        """bool[N_pad]: does this node's component contain no odd edge?
        (False on dead nodes.) The odd flag lands on the root's id (the
        component label) and is read back through every member's."""
        bad = torch.zeros_like(graph.node_mask)
        for s, r, mask in _edge_sets(graph):
            odd = _odd(state.label, state.dist, s, r, mask)
            bad |= X.scatter_spread(odd.to(torch.int32), state.label[s], odd,
                                    graph.n_nodes_padded, 0, True) > 0
        part = part_of(graph)
        if part is not None:  # any rank's edges may flag a component
            bad = mesh.combine(part, bad, "or")
        return graph.node_mask & ~bad[state.label.clamp_min(0).long()]

    def step(self, graph: Graph, state: BipartiteCheckState, key):
        label, changed, msgs = max_flood_step(graph, state.label,
                                              state.frontier, self.method)
        rnd = state.round + 1
        dist = torch.where(changed, rnd, state.dist)
        return BipartiteCheckState(label=label, dist=dist, frontier=changed,
                                   round=rnd), {
            "messages": msgs, "changed": changed.sum()}
