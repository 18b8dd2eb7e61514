"""Push-sum (weighted) average consensus (torch counterpart of
``p2pnetwork_tpu/models/pushsum.py``).

Every node holds a value mass ``s`` and a weight mass ``w``; each round it
splits both equally over itself and its out-neighbors, so ``s/w``
converges to the mean while ``sum(s)`` and ``sum(w) == N`` are conserved
up to f32 rounding. A round is two ``propagate_sum`` calls over arbitrary
f32 terms (B1's sum entry under ``pallas``/``hybrid``, which adds them in
another order than the reference, so the sums agree to a tolerance);
the only draw is the ``normal`` initial values.
"""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch import prng
from p2pnetwork_tpu_torch.models.gossip import mean_and_variance
from p2pnetwork_tpu_torch.ops import segment
from p2pnetwork_tpu_torch.sim.graph import Graph


@dataclasses.dataclass(frozen=True)
class PushSumState:
    s: torch.Tensor  # f32[N_pad] — value mass
    w: torch.Tensor  # f32[N_pad] — weight mass


def _estimate(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.where(w > 0, s / w.clamp_min(1e-30), 0.0)


@dataclasses.dataclass(frozen=True)
class PushSum:
    """Mass-splitting average consensus. The per-node estimate is ``s/w``."""

    method: str = "auto"  # aggregation lowering, see ops/segment.py

    STATS = ("messages", "s_total", "w_total", "variance", "mean")

    def init(self, graph: Graph, key) -> PushSumState:
        values = prng.normal(key, (graph.n_nodes_padded,),
                             device=graph.device)
        mask = graph.node_mask
        # A select, as XLA makes the product with a bool mask.
        return PushSumState(s=torch.where(mask, values, 0.0),
                            w=mask.to(torch.float32))

    def estimate(self, graph: Graph, state: PushSumState) -> torch.Tensor:
        """Per-node mean estimate ``s/w`` (0 on dead/padded nodes)."""
        return _estimate(state.s, state.w)

    def step(self, graph: Graph, state: PushSumState, key):
        mask_f = graph.node_mask.to(torch.float32)
        # One share kept, one sent along every outgoing edge; sinks keep
        # everything.
        shares = 1.0 / (graph.out_degree.to(torch.float32) + 1.0)
        s_share = state.s * shares
        w_share = state.w * shares
        s = (s_share + segment.propagate_sum(graph, s_share,
                                             self.method)) * mask_f
        w = (w_share + segment.propagate_sum(graph, w_share,
                                             self.method)) * mask_f
        mean, var = mean_and_variance(graph, _estimate(s, w))
        stats = {
            "messages": segment.frontier_messages(graph, graph.node_mask),
            "s_total": s.sum(),
            "w_total": w.sum(),
            "variance": var,
            "mean": mean,
        }
        return PushSumState(s=s, w=w), stats
