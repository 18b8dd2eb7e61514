"""Label-propagation community detection (torch counterpart of
``p2pnetwork_tpu/models/labelprop.py``).

Every node starts as its own community and adopts the most frequent label
among its live neighbors and itself. The per-node mode: the neighbor
table's labels with the node's own appended (``[N, D+1]``), each row
sorted, run lengths read off the sorted row by two batched
``searchsorted`` calls; ties go to the smallest label (the first maximum
of the ascending row, which ``argmax`` returns on every device) and the
``_SENTINEL`` padding counts 0. Even ids update on even rounds, odd ids
on odd rounds; ``unsettled`` (adopters over the last two rounds) reaches
0 only when both halves held still: ``engine.run_until_converged(...,
stat="unsettled", threshold=1)``. Gather layout only (a complete neighbor
table); deterministic.
"""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch.sim.graph import Graph

_SENTINEL = 2**31 - 1


def _row_mode(rows: torch.Tensor) -> torch.Tensor:
    """Most frequent value of each ascending-sorted row, ignoring
    ``_SENTINEL``; ties to the smallest value (``_SENTINEL`` for a row of
    padding only)."""
    left = torch.searchsorted(rows, rows, side="left")
    right = torch.searchsorted(rows, rows, side="right")
    count = torch.where(rows == _SENTINEL, 0, right - left)
    return rows.gather(1, count.argmax(dim=1, keepdim=True))[:, 0]


@dataclasses.dataclass(frozen=True)
class LabelPropagationState:
    label: torch.Tensor  # i32[N_pad] — community label; -1 on dead nodes
    changed_prev: torch.Tensor  # i32[] — adopters in the previous round
    round: torch.Tensor  # i32[]


@dataclasses.dataclass(frozen=True)
class LabelPropagation:
    """Community detection by iterated neighborhood-majority voting."""

    STATS = ("messages", "changed", "unsettled", "communities")

    def init(self, graph: Graph, key) -> LabelPropagationState:
        if graph.neighbors is None or not graph.neighbors_complete:
            raise ValueError(
                "LabelPropagation needs the complete neighbor table "
                "(build with from_edges(build_neighbor_table=True))")
        ids = torch.arange(graph.n_nodes_padded, dtype=torch.int32,
                           device=graph.device)
        # changed_prev = 1: the odd half has not moved yet.
        return LabelPropagationState(
            label=torch.where(graph.node_mask, ids, -1),
            changed_prev=torch.ones((), dtype=torch.int32,
                                    device=graph.device),
            round=torch.zeros((), dtype=torch.int32, device=graph.device))

    def communities(self, graph: Graph,
                    state: LabelPropagationState) -> torch.Tensor:
        """Distinct labels held by live nodes."""
        n_pad = graph.n_nodes_padded
        used = torch.zeros(n_pad + 1, dtype=torch.bool, device=graph.device)
        used[torch.where(graph.node_mask, state.label, n_pad).long()] = True
        return used[:n_pad].sum()

    def step(self, graph: Graph, state: LabelPropagationState, key):
        ids = torch.arange(graph.n_nodes_padded, dtype=torch.int32,
                           device=graph.device)
        live_vote = graph.neighbor_mask & graph.node_mask[graph.neighbors]
        votes = torch.where(live_vote, state.label[graph.neighbors],
                            _SENTINEL)
        own = torch.where(graph.node_mask, state.label, _SENTINEL)
        votes = torch.cat([votes, own[:, None]], dim=1)
        mode = _row_mode(torch.sort(votes, dim=1).values)
        # Parity schedule: half the population holds still each round.
        turn = (ids % 2) == (state.round % 2)
        adopt = turn & graph.node_mask & (mode != _SENTINEL)
        label = torch.where(adopt, mode, state.label)
        changed = (label != state.label).sum().to(torch.int32)
        new_state = LabelPropagationState(label=label, changed_prev=changed,
                                          round=state.round + 1)
        return new_state, {
            "messages": live_vote.sum(),
            "changed": changed,
            "unsettled": changed + state.changed_prev,
            "communities": self.communities(graph, new_state),
        }
