"""Borůvka minimum spanning forest — the synchronous core of GHS (torch
counterpart of ``p2pnetwork_tpu/models/boruvka.py``).

One ``step`` is one phase: every fragment picks its minimum outgoing edge
by a lexicographic ``(weight, lo, hi, edge id)`` scatter-min (``lo``/``hi``
the sorted endpoints, so both directions of an edge rank alike), hooks to
the far fragment, breaks mutual hooks toward the lower id, and
pointer-jumps a static ``ceil(log2 n_pad) + 1`` times to the new roots;
every non-root fragment commits its picked edge. Weights are
``graph.edge_weight`` (1 without them) and must be symmetric for the
forest to be minimal.

The weight min follows XLA's: NaN wins and ``-0.0`` orders below
``+0.0``, through ``ops/extremum.py``'s ordered i32 keys; every min is an
integer scatter whose non-candidate slots are spread over the nodes
rather than sent to one drop address. ``mst_weight`` is an f32 sum, equal
to the reference's to rounding (the terms add in another order). Run
with ``engine.run_until_converged(..., stat="changed", threshold=1)``.
Runtime links are not candidates. Deterministic.
"""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch.ops import extremum as X
from p2pnetwork_tpu_torch.sim.graph import Graph

_BIG = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class BoruvkaState:
    comp: torch.Tensor  # i32[N_pad] — fragment representative id; -1 dead
    mst_edge: torch.Tensor  # bool[E_pad] — COO slots committed to the forest
    mst_weight: torch.Tensor  # f32[] — cumulative committed weight
    round: torch.Tensor  # i32[] — phases executed


@dataclasses.dataclass(frozen=True)
class Boruvka:
    """Minimum spanning forest by synchronous fragment merging (COO
    scatters and gathers; no aggregation method)."""

    STATS = ("messages", "changed", "components", "mst_edges", "mst_weight")

    def init(self, graph: Graph, key) -> BoruvkaState:
        ids = torch.arange(graph.n_nodes_padded, dtype=torch.int32,
                           device=graph.device)
        return BoruvkaState(
            comp=torch.where(graph.node_mask, ids, -1),
            mst_edge=torch.zeros(graph.n_edges_padded, dtype=torch.bool,
                                 device=graph.device),
            mst_weight=torch.zeros((), dtype=torch.float32,
                                   device=graph.device),
            round=torch.zeros((), dtype=torch.int32, device=graph.device))

    def components(self, graph: Graph, state: BoruvkaState) -> torch.Tensor:
        """Live nodes still representing themselves."""
        ids = torch.arange(graph.n_nodes_padded, dtype=torch.int32,
                           device=graph.device)
        return ((state.comp == ids) & graph.node_mask).sum()

    def step(self, graph: Graph, state: BoruvkaState, key):
        n_pad, e_pad = graph.n_nodes_padded, graph.n_edges_padded
        dev = graph.device
        ids = torch.arange(n_pad, dtype=torch.int32, device=dev)
        s, r = graph.senders, graph.receivers
        w = (graph.edge_weight if graph.edge_weight is not None
             else torch.ones(e_pad, dtype=torch.float32, device=dev))
        comp = state.comp

        alive = graph.edge_mask & graph.node_mask[s] & graph.node_mask[r]
        cu = torch.where(alive, comp[s], 0)
        cv = torch.where(alive, comp[r], 0)
        cross = alive & (cu != cv)

        def narrow(keys, cand, init, largest=False):
            """Per-fragment min of ``keys`` over ``cand``, read back at
            each edge's fragment."""
            best = X.scatter_spread(keys, cu, cand, n_pad, init, largest)
            return best, best[torch.where(cand, cu, 0)]

        # (weight, lo, hi) lexicographic min, narrowing the candidates.
        ident = X.identity(torch.float32, False)
        wkey = X.encode(w, False)
        _, at = narrow(wkey, cross, ident)
        cand = cross & (w == X.decode(at, torch.float32, False))
        lo, hi = torch.minimum(s, r), torch.maximum(s, r)
        _, at = narrow(lo, cand, _BIG)
        cand = cand & (lo == at)
        _, at = narrow(hi, cand, _BIG)
        cand = cand & (hi == at)
        # Parallel duplicates of one undirected key: the lowest slot.
        eids = torch.arange(e_pad, dtype=torch.int32, device=dev)
        best_e, _ = narrow(eids, cand, _BIG)

        is_rep = (comp == ids) & graph.node_mask
        has_pick = is_rep & (best_e < _BIG)
        pick = torch.where(has_pick, best_e, 0)
        # Hook each picking fragment to the far endpoint's fragment; mutual
        # hooks keep the lower id as root.
        parent = torch.where(is_rep, torch.where(has_pick, cv[pick], ids),
                             ids)
        mutual = (parent[parent] == ids) & (parent != ids)
        parent = torch.where(mutual & (ids < parent), ids, parent)

        # Non-root fragments commit their pick: k-way merges add k-1 edges.
        commits = has_pick & (parent != ids)
        mst_edge = state.mst_edge | (X.scatter_spread(
            commits.to(torch.int32), pick, commits, e_pad, 0, True) > 0)
        added_w = torch.where(commits, w[pick], 0.0).sum()

        # A static doubling schedule collapses any hook forest.
        for _ in range(max(1, (n_pad - 1).bit_length() + 1)):
            parent = parent[parent]
        comp = torch.where(graph.node_mask, parent[comp.clamp_min(0)], -1)

        new_state = BoruvkaState(comp=comp, mst_edge=mst_edge,
                                 mst_weight=state.mst_weight + added_w,
                                 round=state.round + 1)
        return new_state, {
            "messages": cross.sum(),
            "changed": commits.sum(),
            "components": self.components(graph, new_state),
            "mst_edges": mst_edge.sum(),
            "mst_weight": new_state.mst_weight,
        }
