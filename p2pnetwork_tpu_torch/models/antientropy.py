"""Anti-entropy replication: push–pull set reconciliation (torch
counterpart of ``p2pnetwork_tpu/models/antientropy.py``).

The state is the population's possession matrix ``bool[N_pad, n_items]``;
each item starts on one live node drawn by a weighted ``prng.choice``
(``p`` uniform over the live nodes: jax's inverse-CDF draw, bit for bit).
A round draws each node's partner (``base.draw_neighbor_slot``), then
merges sets both ways: pull as a gather-OR of the partner's row, push as
a scatter-OR onto it (torch has no OR scatter: a per-cell count of
senders, ``index_add_``, then ``> 0``; exact in any order). Converge with
``engine.run_until_converged(..., stat="missing", threshold=1)``.

On a rank's part (``parallel/auto.py``) the state stays whole on every
rank: the draw's one exchange gives every rank every partner, and the
merge reads nothing else of the table.
"""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch import prng
from p2pnetwork_tpu_torch.models import base
from p2pnetwork_tpu_torch.sim.graph import Graph


@dataclasses.dataclass(frozen=True)
class AntiEntropyState:
    have: torch.Tensor  # bool[N_pad, n_items] — possession matrix
    round: torch.Tensor  # i32[]


@dataclasses.dataclass(frozen=True)
class AntiEntropy:
    """Push–pull anti-entropy over the neighbor table; ``push`` / ``pull``
    pick the exchange directions."""

    n_items: int = 64
    push: bool = True
    pull: bool = True

    STATS = ("messages", "missing", "coverage", "complete_items")
    RUNS_ON_PART = True

    def init(self, graph: Graph, key) -> AntiEntropyState:
        if graph.neighbors is None:
            raise ValueError(
                "AntiEntropy requires a graph with a neighbor table")
        if not (self.push or self.pull):
            raise ValueError("enable push, pull, or both")
        n_pad, dev = graph.n_nodes_padded, graph.device
        n_live = graph.node_mask.sum().clamp_min(1).to(torch.float32)
        p = graph.node_mask.to(torch.float32) / n_live
        holders = prng.choice(key, n_pad, (self.n_items,), p=p, device=dev)
        have = torch.zeros((n_pad, self.n_items), dtype=torch.bool,
                           device=dev)
        have[holders.long(), torch.arange(self.n_items, device=dev)] = True
        return AntiEntropyState(have=have & graph.node_mask[:, None],
                                round=torch.zeros((), dtype=torch.int32,
                                                  device=dev))

    def step(self, graph: Graph, state: AntiEntropyState, key):
        _, partner, has_slot = base.draw_neighbor_slot(graph, key)
        active = has_slot & graph.node_mask & graph.node_mask[partner]
        have = state.have
        if self.pull:
            have = have | (state.have[partner] & active[:, None])
        if self.push:
            # OR each active node's set onto its partner's row, as a count
            # of senders per cell (inactive rows add nothing at row 0).
            sent = torch.zeros(have.shape, dtype=torch.int32,
                               device=have.device)
            sent.index_add_(0, torch.where(active, partner, 0),
                            (state.have & active[:, None]).to(torch.int32))
            have = have | (sent > 0)
        have = have & graph.node_mask[:, None]

        n_live = graph.node_mask.sum().clamp_min(1)
        held = have.sum(dim=0)  # per item
        missing = n_live * self.n_items - held.sum()
        exchanged = int(self.push) + int(self.pull)
        return AntiEntropyState(have=have, round=state.round + 1), {
            "messages": exchanged * active.sum(),
            "missing": missing,
            "coverage": held.sum().to(torch.float32)
            / (n_live * self.n_items).to(torch.float32),
            "complete_items": (held == n_live).sum(),
        }
