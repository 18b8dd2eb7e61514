"""Probabilistic failure detection: randomized ping/ack with suspicion
(torch counterpart of ``p2pnetwork_tpu/models/detector.py``).

Every responsive node pings one uniformly drawn slot of its neighbor table
a round (``base.draw_neighbor_slot``); an answered ping resets that slot's
suspicion, silence increments it, and ``threshold`` consecutive misses
latch the slot as declared dead. Pings and acks are each lost with
probability ``loss_prob`` (two ``prng.uniform`` draws; with the slot draw,
three threefry draws a round, from ``split(key, 3)``). Run against
``failures.mark_unresponsive`` (the dead stay in the tables) with
``engine.run_until_converged(..., stat="undetected", threshold=1)``.

On a rank's part (``parallel/auto.py``) the slot state ``[N_pad, d]``
stays whole and bit-equal on every rank: a rank updates the rows of the
table it owns, and one exchange a round beyond the draw's assembles the
owned rows' suspicion, declarations, dead slots and table mask (packed
in one i32 a slot) along axis 0; the stats are read from whole tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from p2pnetwork_tpu_torch import prng
from p2pnetwork_tpu_torch.models import base
from p2pnetwork_tpu_torch.parallel import mesh as M
from p2pnetwork_tpu_torch.parallel.mesh import assemble
from p2pnetwork_tpu_torch.sim.graph import Graph, part_of


@dataclasses.dataclass(frozen=True)
class FailureDetectorState:
    suspicion: torch.Tensor  # i32[N_pad, d] — consecutive unanswered pings
    declared: torch.Tensor  # bool[N_pad, d] — latched declarations
    round: torch.Tensor  # i32[]


@dataclasses.dataclass(frozen=True)
class FailureDetector:
    """SWIM-style randomized ping/ack over the neighbor table:
    ``threshold`` consecutive misses declare a slot dead; ``loss_prob`` is
    the per-direction message loss (0: an exact detector)."""

    threshold: int = 3
    loss_prob: float = 0.0

    STATS = ("messages", "undetected", "detected", "dead_slots",
             "false_positives")
    RUNS_ON_PART = True

    def init(self, graph: Graph, key) -> FailureDetectorState:
        if graph.neighbors is None:
            raise ValueError(
                "FailureDetector requires a graph with a neighbor table")
        shape = (graph.n_nodes_padded, graph.neighbors.shape[1])
        return FailureDetectorState(
            suspicion=torch.zeros(shape, dtype=torch.int32,
                                  device=graph.device),
            declared=torch.zeros(shape, dtype=torch.bool,
                                 device=graph.device),
            round=torch.zeros((), dtype=torch.int32, device=graph.device))

    def _dead_watched(self, graph: Graph) -> torch.Tensor:
        """bool[N_pad, d]: watched slots whose target is unresponsive,
        seen from a responsive watcher (the owned rows on a part)."""
        return (graph.neighbor_mask & ~graph.node_mask[graph.neighbors]
                & M.owned(graph, graph.node_mask)[:, None])

    def step(self, graph: Graph, state: FailureDetectorState, key):
        n_pad, dev = graph.n_nodes_padded, graph.device
        part = part_of(graph)
        mask = graph.neighbor_mask
        k1, k2, k3 = prng.split(key, 3)
        slot, target, has_slot = base.draw_neighbor_slot(graph, k1)
        pinger = has_slot & graph.node_mask
        responsive = graph.node_mask[target]
        loss = float(np.float32(self.loss_prob))
        ping_ok = prng.uniform(k2, (n_pad,), device=dev) >= loss
        ack_ok = prng.uniform(k3, (n_pad,), device=dev) >= loss
        acked = responsive & ping_ok & ack_ok

        def own(x):
            return M.owned(graph, x, axis=0)

        probed = ((torch.arange(mask.shape[1], device=dev)[None, :]
                   == own(slot)[:, None]) & mask & own(pinger)[:, None])
        old = own(state.suspicion)
        suspicion = torch.where(
            probed, torch.where(own(acked)[:, None], 0, old + 1),
            old).to(torch.int32)
        declared = own(state.declared) | (suspicion >= self.threshold)
        dead = self._dead_watched(graph)
        if part is not None:
            # The owned rows' state, dead slots and table mask in one
            # exchange: every rank holds the whole of each.
            whole = assemble(part, suspicion * 8 + declared.to(torch.int32)
                             * 4 + dead.to(torch.int32) * 2
                             + mask.to(torch.int32), axis=0)
            suspicion = whole // 8
            declared, dead, mask = ((whole & b) != 0 for b in (4, 2, 1))

        n_dead = dead.sum()
        detected = (declared & dead).sum()
        false_pos = (declared & mask & ~dead & graph.node_mask[:, None]).sum()
        stats = {
            # One ping per prober, one ack per delivered ping to a
            # responsive target.
            "messages": pinger.sum() + (pinger & responsive & ping_ok).sum(),
            "undetected": n_dead - detected,
            "detected": detected,
            "dead_slots": n_dead,
            "false_positives": false_pos,
        }
        return FailureDetectorState(suspicion=suspicion, declared=declared,
                                    round=state.round + 1), stats
