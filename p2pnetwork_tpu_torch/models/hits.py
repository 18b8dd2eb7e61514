"""HITS — hubs and authorities (torch counterpart of
``p2pnetwork_tpu/models/hits.py``).

One round is the double power step with L2 normalization::

    a'[v] = sum_{u -> v} h[u]     (one propagate_sum: B1's sum entry
                                   under ``pallas`` / ``hybrid``)
    h'[u] = sum_{u -> v} a'[v]    (a sum over out-edges, keyed by sender)

The hub sum goes through the source-CSR view when the graph has one (the
sender-sorted edge order, its padding slots masked: their ``e_pad - 1``
sentinel can name a live edge), else through an unsorted scatter-add;
runtime links fold into both sides. The f32 sums add in another order than
XLA's, so scores agree with the reference's to rounding, not bit for bit.
Deterministic: no random number is drawn. Dead nodes hold 0.
"""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch.ops import segment
from p2pnetwork_tpu_torch.sim.graph import Graph


@dataclasses.dataclass(frozen=True)
class HITSState:
    hub: torch.Tensor  # f32[N_pad] — L2-normalized over live nodes
    authority: torch.Tensor  # f32[N_pad]
    residual: torch.Tensor  # f32[] — L1 change of both vectors last round


def _norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt((x * x).sum()).clamp_min(1e-30)


@dataclasses.dataclass(frozen=True)
class HITS:
    """Kleinberg's hubs/authorities by alternating power iteration;
    ``method`` is the authority sum's lowering."""

    method: str = "auto"

    STATS = ("messages", "residual")

    def init(self, graph: Graph, key) -> HITSState:
        mask_f = graph.node_mask.to(torch.float32)
        v = mask_f / torch.sqrt(mask_f.sum().clamp_min(1.0))
        return HITSState(hub=v, authority=v, residual=torch.tensor(
            torch.inf, dtype=torch.float32, device=graph.device))

    def _out_sum(self, graph: Graph, signal: torch.Tensor) -> torch.Tensor:
        """``out[u] = sum(signal[r_e], e: s_e = u)`` over live edges."""
        n_pad = graph.n_nodes_padded
        s, r = graph.senders, graph.receivers
        live = graph.edge_mask & graph.node_mask[s] & graph.node_mask[r]
        vals = torch.where(live, signal[r], 0.0)
        out = torch.zeros(n_pad, dtype=torch.float32, device=signal.device)
        if graph.src_eid is not None:
            order = graph.src_eid
            slot_ok = (torch.arange(order.shape[0], device=signal.device)
                       < graph.src_offsets[-1])
            # Padding slots add 0 to whichever sender they name.
            out.index_add_(0, s[order], torch.where(slot_ok, vals[order],
                                                    0.0))
        else:
            out.index_add_(0, s, vals)
        if graph.dyn_senders is not None:
            dlive = (graph.dyn_mask & graph.node_mask[graph.dyn_senders]
                     & graph.node_mask[graph.dyn_receivers])
            out.index_add_(0, graph.dyn_senders,
                           torch.where(dlive, signal[graph.dyn_receivers],
                                       0.0))
        return out * graph.node_mask

    def step(self, graph: Graph, state: HITSState, key):
        mask = graph.node_mask
        authority = _norm(segment.propagate_sum(graph, state.hub,
                                                self.method))
        hub = _norm(self._out_sum(graph, authority)) * mask
        authority = authority * mask
        residual = ((hub - state.hub).abs().sum()
                    + (authority - state.authority).abs().sum())
        stats = {
            "messages": 2 * segment.frontier_messages(graph, mask),
            "residual": residual,
        }
        return HITSState(hub=hub, authority=authority,
                         residual=residual), stats
