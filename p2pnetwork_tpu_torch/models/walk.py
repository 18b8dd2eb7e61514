"""Batched random walks: the peer-sampling / discovery protocol (torch
counterpart of ``p2pnetwork_tpu/models/walk.py``).

A cohort of ``n_walkers`` walkers advances in one batched step: each
walker's out-edge row is gathered through the source-CSR view, one live
edge is chosen uniformly, and the walker moves. A walker with no live
out-edge stays put; with probability ``restart_p`` a walker teleports
back to its start node instead (a ``prng.uniform`` draw, the threefry
kernel on the card, made only when ``restart_p > 0``). ``visited``
accumulates every node any walker has stood on, so ``coverage`` is
discovery progress for ``engine.run_until_coverage``.

The uniform choice is the largest of per-edge uniforms keyed by the edge's
identity (``utils/edgehash.py``), ties to the higher receiver id, as the
reference's. Requires a graph with the source-CSR view.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from p2pnetwork_tpu_torch import prng
from p2pnetwork_tpu_torch.models.flood import _over_live
from p2pnetwork_tpu_torch.sim.graph import Graph
from p2pnetwork_tpu_torch.utils.edgehash import edge_uniform


@dataclasses.dataclass(frozen=True)
class RandomWalksState:
    pos: torch.Tensor  # i32[W] — each walker's current node
    start: torch.Tensor  # i32[W] — restart target (initial position)
    visited: torch.Tensor  # bool[N_pad] — any walker has stood here


@dataclasses.dataclass(frozen=True)
class RandomWalks:
    """``n_walkers`` uniform random walkers with optional restart.
    ``init`` seeds walkers on live nodes evenly spread over the live ids
    (wrapping when there are more walkers than live nodes)."""

    n_walkers: int = 1024
    restart_p: float = 0.0

    STATS = ("messages", "coverage", "stuck")

    def __post_init__(self):
        if self.n_walkers < 1:
            raise ValueError(f"n_walkers must be >= 1, got {self.n_walkers}")
        if not 0.0 <= self.restart_p <= 1.0:
            raise ValueError(f"restart_p must be in [0, 1], got "
                             f"{self.restart_p}")

    def _require_csr(self, graph: Graph) -> None:
        if graph.src_eid is None:
            raise ValueError(
                "RandomWalks requires a source-CSR graph — build with "
                "from_edges(source_csr=True) or graph.with_source_csr()")

    def init(self, graph: Graph, key) -> RandomWalksState:
        self._require_csr(graph)
        n_pad = graph.n_nodes_padded
        live = torch.nonzero(graph.node_mask).reshape(-1).to(torch.int32)
        live_ids = torch.cat([live, live.new_zeros(n_pad - live.numel())])
        n_live = graph.node_mask.sum().clamp_min(1)
        stride = (n_live // self.n_walkers).clamp_min(1)
        w = torch.arange(self.n_walkers, device=graph.device)
        pos = live_ids[(w * stride) % n_live]
        visited = torch.zeros_like(graph.node_mask)
        visited[pos.long()] = True
        return RandomWalksState(pos=pos, start=pos,
                                visited=visited & graph.node_mask)

    def coverage(self, graph: Graph, state: RandomWalksState):
        """Fraction of live nodes some walker has visited (f32)."""
        return _over_live((state.visited & graph.node_mask).sum(), graph)

    def step(self, graph: Graph, state: RandomWalksState, key):
        self._require_csr(graph)
        w = max(graph.max_out_span, 1)
        k_edge, k_restart = prng.split(key)
        pos = state.pos.long()

        # Each walker's out-edge row, liveness-masked [W, w].
        eid, svalid = graph.gather_row_slots(
            graph.src_offsets[pos], graph.src_offsets[pos + 1], w)
        rcv = graph.receivers[eid]
        live = svalid & graph.edge_mask[eid] & graph.node_mask[rcv]

        # Runtime links ride along, membership-tested per walker ([W, D]).
        if graph.dyn_senders is not None:
            dmember = ((graph.dyn_senders[None, :] == state.pos[:, None])
                       & graph.dyn_mask[None, :]
                       & graph.node_mask[graph.dyn_receivers][None, :])
            rcv = torch.cat([rcv, graph.dyn_receivers[None, :].expand(
                dmember.shape)], dim=1)
            live = torch.cat([live, dmember], dim=1)

        # The largest edge-keyed uniform wins; equal uniforms go to the
        # higher receiver id. A walker with no live slot stays put.
        walkers = torch.arange(self.n_walkers, dtype=torch.int32,
                               device=graph.device)
        u = edge_uniform(k_edge, walkers[:, None], state.pos[:, None], rcv)
        u = torch.where(live, u, -1.0)
        m = u.amax(dim=1)
        can_move = m >= 0.0
        best_rcv = torch.where(live & (u == m[:, None]), rcv, -1).amax(dim=1)
        dest = torch.where(can_move, best_rcv, state.pos)

        if self.restart_p > 0.0:
            # Restart wins over the edge move; a dead start falls back to
            # the edge move.
            restart = ((prng.uniform(k_restart, (self.n_walkers,),
                                     device=graph.device)
                        < float(np.float32(self.restart_p)))
                       & graph.node_mask[state.start])
            dest = torch.where(restart, state.start, dest)
            moved = (restart | can_move) & (dest != state.pos)
        else:
            moved = can_move & (dest != state.pos)

        visited = state.visited.clone()
        visited[dest.long()] = True
        visited &= graph.node_mask
        stats = {
            "messages": moved.sum(),
            "coverage": _over_live((visited & graph.node_mask).sum(), graph),
            "stuck": (~can_move).sum(),
        }
        return RandomWalksState(pos=dest, start=state.start,
                                visited=visited), stats
