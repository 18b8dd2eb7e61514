"""PageRank power iteration over the peer graph (torch counterpart of
``p2pnetwork_tpu/models/pagerank.py``).

    r'[v] = (1-d)/N + d * ( sum_{u->v} r[u]/deg_out[u]  +  dangling/N )

with ``dangling`` the rank held by live nodes without out-edges. One
round is one ``propagate_sum`` of ``rank / out_degree`` (B1's sum entry
under ``pallas``/``hybrid``); no random number is drawn. Run it to a
residual with ``engine.run_until_converged(stat="residual")``.
"""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch.ops import segment
from p2pnetwork_tpu_torch.ops import threefry as TF
from p2pnetwork_tpu_torch.sim.graph import Graph


@dataclasses.dataclass(frozen=True)
class PageRankState:
    ranks: torch.Tensor  # f32[N_pad] — sums to 1 over live nodes
    residual: torch.Tensor  # f32[] — L1 change of the last round


def _n_real(graph: Graph) -> torch.Tensor:
    return graph.node_mask.sum().clamp_min(1).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class PageRank:
    damping: float = 0.85
    method: str = "auto"  # aggregation lowering, see ops/segment.py

    STATS = ("messages", "residual", "rank_total", "rank_max")
    RUNS_ON_PART = True

    def init(self, graph: Graph, key) -> PageRankState:
        mask_f = graph.node_mask.to(torch.float32)
        return PageRankState(
            ranks=mask_f / _n_real(graph),
            residual=torch.tensor(torch.inf, device=graph.device))

    def step(self, graph: Graph, state: PageRankState, key):
        mask = graph.node_mask
        n_real = _n_real(graph)
        deg = graph.out_degree.to(torch.float32)
        contrib = torch.where(mask & (graph.out_degree > 0),
                              state.ranks / deg.clamp_min(1.0), 0.0)
        pulled = segment.propagate_sum(graph, contrib, self.method)
        dangling = torch.where(mask & (graph.out_degree == 0), state.ranks,
                               0.0).sum()
        # XLA's CPU code fuses the damped product and its add into one
        # rounding.
        ranks = TF.fma_f32(pulled + dangling / n_real, self.damping,
                           (1.0 - self.damping) / n_real) * mask
        residual = (ranks - state.ranks).abs().sum()
        stats = {
            # Every live node with outgoing links ships one share per edge.
            "messages": segment.frontier_messages(graph, mask),
            "residual": residual,
            "rank_total": ranks.sum(),
            "rank_max": ranks.max(),
        }
        return PageRankState(ranks=ranks, residual=residual), stats
