"""Plumtree — epidemic broadcast trees (torch counterpart of
``p2pnetwork_tpu/models/plumtree.py``).

One :meth:`Plumtree.step` is one broadcast from ``source`` over the
current eager edge set, run to completion:

- BFS layers over the eager, live edges deliver the message;
- PRUNE: each reached node keeps its lowest-id eager in-edge from a
  strictly earlier layer; every other in-edge of a reached node goes
  lazy. After one broadcast on a static overlay the eager set is a
  spanning tree rooted at the source;
- GRAFT: when the wave dies with live nodes unreached, every unreached
  node with a reached lazy in-neighbor grafts its lowest-id such edge
  back to eager, and the wave goes on. ``grafts`` counts the healed
  links.

The reference runs the broadcast as one device ``while_loop`` with the
graft behind a ``lax.cond``. The port loops on the host: one read of
"did this layer reach anyone" per layer (``_device.SYNCS``), and on a
dead layer only, the graft and one more read of its size. The lowest-id
picks are integer scatter-mins whose non-candidate slots are spread over
the nodes (``ops/extremum.py`` ``scatter_spread``), not sent to one drop
address.

:meth:`Plumtree.tree_graph` extracts the learned eager set as a compact
graph of its own: the eager edges are compacted on the device and only
they (about N) cross to the host for ``from_edges``.
"""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch import _device
from p2pnetwork_tpu_torch.models import base
from p2pnetwork_tpu_torch.models.flood import _over_live
from p2pnetwork_tpu_torch.ops import bitset
from p2pnetwork_tpu_torch.ops import extremum as X
from p2pnetwork_tpu_torch.sim.graph import Graph

_BIG = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class PlumtreeState:
    eager: torch.Tensor  # bool[E_pad] — payload-carrying links
    round: torch.Tensor  # i32[] — broadcasts completed


@dataclasses.dataclass(frozen=True)
class PlumtreeBitState:
    """:class:`PlumtreeState` with the per-edge eager flags packed 32 to a
    word (``ops/bitset.py``; the reference's ``uint32`` words as int32)."""

    #: Fields holding the reference's ``uint32`` words as int32 with the
    #: same bits: checkpoints write them as ``uint32`` (``sim/checkpoint.py``).
    U32_WORDS = ("eager",)

    eager: torch.Tensor  # i32[ceil(E_pad / 32)]
    round: torch.Tensor  # i32[]


def _eager_mask(graph: Graph, eager: torch.Tensor) -> torch.Tensor:
    """Live eager edges."""
    return (graph.edge_mask & eager & graph.node_mask[graph.senders]
            & graph.node_mask[graph.receivers])


def _lowest_eid(cand: torch.Tensor, r: torch.Tensor, eids: torch.Tensor,
                n_pad: int) -> torch.Tensor:
    """bool[E_pad]: the candidate edges that are the lowest-id candidate
    into their receiver."""
    best = X.scatter_spread(eids, r, cand, n_pad, _BIG, False)
    return cand & (best[torch.where(cand, r, 0)] == eids)


def _refuse_dynamic(graph: Graph) -> None:
    if graph.dyn_senders is not None:
        raise ValueError("Plumtree does not track the dynamic edge region; "
                         "consolidate the graph first")


@dataclasses.dataclass(frozen=True)
class Plumtree:
    """Self-optimizing broadcast: flood once, then tree plus lazy repair.
    ``bitset=True`` carries the eager set packed
    (:class:`PlumtreeBitState`): the same trees and stats."""

    source: int = 0
    bitset: bool = False

    STATS = ("messages", "ihave", "duplicates", "grafts", "eager_edges",
             "coverage")

    def init(self, graph: Graph, key):
        base.validate_source(graph, self.source)
        _refuse_dynamic(graph)
        eager = torch.ones(graph.n_edges_padded, dtype=torch.bool,
                           device=graph.device)
        rnd = torch.zeros((), dtype=torch.int32, device=graph.device)
        if self.bitset:
            return PlumtreeBitState(eager=bitset.pack_bits(eager), round=rnd)
        return PlumtreeState(eager=eager, round=rnd)

    @staticmethod
    def _eager_bool(graph: Graph, state) -> torch.Tensor:
        if isinstance(state, PlumtreeBitState):
            return bitset.unpack_bits(state.eager, graph.n_edges_padded)
        return state.eager

    def tree_graph(self, graph: Graph, state, **from_edges_kwargs) -> Graph:
        """The learned eager set as its own compact :class:`Graph`, padded
        to the source graph's node extent (so ids and masks line up), with
        the edges' weights when the graph has them. The compaction runs on
        the device; about N edges cross to the host. ``from_edges_kwargs``
        pick layouts (``source_csr=True``, ...)."""
        from p2pnetwork_tpu_torch.sim.graph import from_edges

        _refuse_dynamic(graph)
        em = _eager_mask(graph, self._eager_bool(graph, state))
        idx = torch.nonzero(em).reshape(-1)
        picked = torch.stack([graph.senders[idx],
                              graph.receivers[idx]]).cpu().numpy()
        if graph.edge_weight is not None:
            from_edges_kwargs.setdefault(
                "weights", graph.edge_weight[idx].cpu().numpy())
        from_edges_kwargs.setdefault("node_pad_multiple",
                                     graph.n_nodes_padded)
        from_edges_kwargs.setdefault("device", graph.device)
        m = from_edges_kwargs["node_pad_multiple"]
        if -(-graph.n_nodes // m) * m != graph.n_nodes_padded:
            raise ValueError(
                f"node_pad_multiple={m} pads to a different node extent "
                f"than the source graph's {graph.n_nodes_padded}")
        g = from_edges(picked[0], picked[1], graph.n_nodes,
                       **from_edges_kwargs)
        return dataclasses.replace(g, node_mask=graph.node_mask & g.node_mask)

    def step(self, graph: Graph, state, key):
        eager = self._eager_bool(graph, state)
        n_pad, e_pad = graph.n_nodes_padded, graph.n_edges_padded
        s, r = graph.senders, graph.receivers
        eids = torch.arange(e_pad, dtype=torch.int32, device=graph.device)
        live_edge = (graph.edge_mask & graph.node_mask[s]
                     & graph.node_mask[r])

        def seg_or(signal, emask):
            contrib = (signal[s] & emask).to(torch.int32)
            agg = torch.zeros(n_pad, dtype=torch.int32, device=graph.device)
            return agg.index_add_(0, r, contrib) > 0

        seed = base.source_seed(graph, self.source)
        dist = torch.where(seed, 0, -1).to(torch.int32)
        frontier, layer, grafts = seed, 0, 0
        while True:
            delivered = seg_or(frontier, live_edge & eager)
            new = delivered & (dist < 0) & graph.node_mask
            if _device.host_bool(new.any()):
                layer += 1
                dist = torch.where(new, layer, dist)
                frontier = new
                continue
            # The wave died: graft the lowest-id lazy edge from a reached
            # sender into each unreached receiver (IHAVE -> GRAFT).
            unreached = graph.node_mask & (dist < 0)
            lazy_cand = live_edge & ~eager & (dist[s] >= 0) & unreached[r]
            graft_edge = _lowest_eid(lazy_cand, r, eids, n_pad)
            _device.SYNCS += 1
            n_graft = int(graft_edge.sum().item())
            if n_graft == 0:
                break
            eager = eager | graft_edge
            # Grafted edges deliver next layer: their senders rejoin the
            # frontier.
            regrow = torch.zeros(n_pad + 1, dtype=torch.bool,
                                 device=graph.device)
            regrow[torch.where(graft_edge, s, n_pad).long()] = True
            frontier = (dist >= 0) & regrow[:n_pad]
            grafts += n_graft

        reached = dist >= 0
        emask = live_edge & eager
        # Every eager edge with a reached sender delivers the payload; a
        # reached node's deliveries beyond the first are duplicates.
        fired = emask & reached[s]
        arrivals = torch.zeros(n_pad, dtype=torch.int32, device=graph.device)
        arrivals.index_add_(0, r, fired.to(torch.int32))
        duplicates = ((arrivals - 1).clamp_min(0)
                      * reached.to(torch.int32)).sum()
        ihave = (live_edge & ~eager & reached[s]).sum()

        # PRUNE: each reached non-source node keeps its lowest-id in-edge
        # from a strictly earlier layer; the rest into reached nodes go
        # lazy; edges into unreached nodes keep their flag.
        ds, dr = dist[s], dist[r]
        parent_cand = emask & (ds >= 0) & (dr >= 1) & (ds < dr)
        is_parent = _lowest_eid(parent_cand, r, eids, n_pad)
        eager = torch.where(live_edge & reached[r], is_parent, eager)

        rnd = state.round + 1
        if isinstance(state, PlumtreeBitState):
            new_state = PlumtreeBitState(eager=bitset.pack_bits(eager),
                                         round=rnd)
        else:
            new_state = PlumtreeState(eager=eager, round=rnd)
        stats = {
            "messages": fired.sum(),
            "ihave": ihave,
            "duplicates": duplicates,
            "grafts": torch.tensor(grafts, dtype=torch.int32,
                                   device=graph.device),
            "eager_edges": (live_edge & eager).sum(),
            "coverage": _over_live((reached & graph.node_mask).sum(), graph),
        }
        return new_state, stats
