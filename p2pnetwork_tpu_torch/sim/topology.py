"""Dynamic topology: peers joining and links forming at runtime (torch
counterpart of ``p2pnetwork_tpu/sim/topology.py``).

Shapes stay fixed, so growth is capacity planning: padding rows of
``node_mask`` are spare peers (:func:`join_node` activates one), and
:func:`with_capacity` reserves a dynamic edge region — unsorted COO slots
(``Graph.dyn_senders``/``dyn_receivers``/``dyn_mask``) that
:func:`connect` fills on the device. Every aggregation method folds the
region in (``ops/segment.py``), so new links count from the next round
with no rebuild. The layouts that bake in edge order (neighbor table,
blocked, hybrid, skew) keep serving the static edges. :func:`consolidate`
rebuilds through ``from_edges`` with the merged live edges.

Every function returns a new ``Graph``; the input is not modified.

On a rank's part (``sim/graph.py`` ``graph_part``, the auto path across
ranks) the region is whole on every rank: every rank applies every
call, so slot allocation and the whole degree fields stay bit-equal.
:func:`connect`'s test of an existing static edge asks the receiver's
owner (one exchange, :func:`static_edge_exists`), and :func:`consolidate`
gathers the live static edges once and cuts the rebuilt graph again.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from p2pnetwork_tpu_torch.ops.frontier import compact
from p2pnetwork_tpu_torch.ops.segment import DYNAMIC_LINK_COST
from p2pnetwork_tpu_torch.parallel.mesh import combine, gather_ragged
from p2pnetwork_tpu_torch.sim.graph import Graph, _round_up, part_of


def _check_ids_in_range(ids, bound: int, what: str) -> None:
    """Host-side bounds check of ids (a list, array or tensor)."""
    arr = ids.cpu().numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)
    if arr.size and (arr.min() < 0 or arr.max() >= bound):
        raise ValueError(f"{what} id out of range [0, {bound})")


def _ids(graph: Graph, ids) -> torch.Tensor:
    """Ids as a flat i32 tensor on the graph's device."""
    return torch.as_tensor(np.asarray(ids) if not isinstance(
        ids, torch.Tensor) else ids).to(graph.device, torch.int32).reshape(-1)


def with_capacity(graph: Graph, extra_edges: int = 0,
                  extra_nodes: int = 0) -> Graph:
    """Reserve headroom for runtime growth: ``extra_nodes`` more (dead)
    padding rows, ``extra_edges`` slots of dynamic edge region (rounded up
    to 128; an existing region grows, keeping its links). Node growth
    changes shapes and is refused on a graph carrying blocked/hybrid
    layouts."""
    g = graph
    if extra_nodes:
        if part_of(g) is not None:
            raise ValueError(
                "with_capacity(extra_nodes=...) on a rank's part changes "
                "the node extent the ranks split: grow the whole graph, "
                "then cut it (parallel/auto.py shard_graph_auto)")
        if g.blocked is not None or g.hybrid is not None:
            raise ValueError(
                "with_capacity(extra_nodes=...) on a graph carrying "
                "blocked/hybrid layouts: build those after growing, or "
                "pass capacity to the generator instead")
        grow = _round_up(g.n_nodes_padded + extra_nodes, 128) \
            - g.n_nodes_padded
        neighbors, neighbor_mask = g.neighbors, g.neighbor_mask
        if neighbors is not None:
            neighbors = F.pad(neighbors, (0, 0, 0, grow))
            neighbor_mask = F.pad(neighbor_mask, (0, 0, 0, grow))
        src_offsets = g.src_offsets
        if src_offsets is not None:
            # Grown nodes have empty out-rows: repeat the end offset.
            src_offsets = torch.cat(
                [src_offsets, src_offsets[-1:].expand(grow)])
        g = dataclasses.replace(
            g, node_mask=F.pad(g.node_mask, (0, grow)),
            in_degree=F.pad(g.in_degree, (0, grow)),
            out_degree=F.pad(g.out_degree, (0, grow)),
            neighbors=neighbors, neighbor_mask=neighbor_mask,
            src_offsets=src_offsets)
    if extra_edges:
        k = _round_up(extra_edges, 128)
        if g.dyn_senders is not None:
            g = dataclasses.replace(
                g, dyn_senders=F.pad(g.dyn_senders, (0, k)),
                dyn_receivers=F.pad(g.dyn_receivers, (0, k)),
                dyn_mask=F.pad(g.dyn_mask, (0, k)))
        else:
            dev = g.device
            g = dataclasses.replace(
                g, dyn_senders=torch.zeros(k, dtype=torch.int32, device=dev),
                dyn_receivers=torch.zeros(k, dtype=torch.int32, device=dev),
                dyn_mask=torch.zeros(k, dtype=torch.bool, device=dev))
    return g


def _require_dynamic(graph: Graph) -> None:
    if graph.dyn_senders is None:
        raise ValueError("no dynamic edge capacity: build with "
                         "topology.with_capacity(graph, extra_edges=...) "
                         "first")


def static_edge_exists(graph: Graph, s: torch.Tensor,
                       r: torch.Tensor) -> torch.Tensor:
    """bool[B]: is each directed ``(s, r)`` a live static edge? One
    ``searchsorted`` into the receiver-sorted COO per query and a
    ``[B, max_in_span]`` window scan. On a rank's part an edge lives on
    its receiver's owner: each rank answers for its own receivers and
    one ``combine(..., "or")`` gives every rank every answer."""
    if graph.max_in_span > 0:
        lo = torch.searchsorted(graph.receivers, r)
        idx = lo[:, None] + torch.arange(graph.max_in_span,
                                         device=r.device)
        idx = idx.clamp_max(graph.n_edges_padded - 1)
        found = ((graph.receivers[idx] == r[:, None])
                 & (graph.senders[idx] == s[:, None])
                 & graph.edge_mask[idx]).any(dim=1)
    else:
        found = ((graph.senders[None, :] == s[:, None])
                 & (graph.receivers[None, :] == r[:, None])
                 & graph.edge_mask[None, :]).any(dim=1)
    part = part_of(graph)
    return found if part is None else combine(part, found, "or")


def _edge_exists(graph: Graph, s: torch.Tensor, r: torch.Tensor):
    """bool[B]: is each ``(s, r)`` a live static or dynamic edge?"""
    dyn = ((graph.dyn_senders[None, :] == s[:, None])
           & (graph.dyn_receivers[None, :] == r[:, None])
           & graph.dyn_mask[None, :]).any(dim=1)
    return static_edge_exists(graph, s, r) | dyn


def connect(graph: Graph, senders, receivers, *, undirected: bool = True,
            check_capacity: bool = True) -> Graph:
    """Add links at runtime into the first free dynamic slots.
    ``undirected`` stores both directions. A pair that already exists, a
    repeat within the batch and a link with a dead endpoint are dropped.
    ``check_capacity`` checks ids and headroom on the host (a sync) and
    raises when the region is full; without it an overflow drops the
    excess links whole."""
    _require_dynamic(graph)
    if check_capacity:
        _check_ids_in_range(senders, graph.n_nodes_padded, "node")
        _check_ids_in_range(receivers, graph.n_nodes_padded, "node")
    s, r = _ids(graph, senders), _ids(graph, receivers)
    if undirected:
        s, r = torch.cat([s, r]), torch.cat([r, s])
    n = s.shape[0]
    earlier = torch.ones(n, n, dtype=torch.bool, device=s.device).tril(-1)
    dup_prior = ((s[:, None] == s[None, :]) & (r[:, None] == r[None, :])
                 & earlier).any(dim=1)
    valid = (~_edge_exists(graph, s, r) & ~dup_prior
             & graph.node_mask[s] & graph.node_mask[r])
    free = ~graph.dyn_mask
    n_free = free.sum()
    if check_capacity and int(valid.sum()) > int(n_free):
        raise ValueError(
            f"dynamic edge region full ({graph.dyn_senders.shape[0]} "
            f"slots); consolidate with from_edges or reserve more via "
            f"with_capacity")
    # Valid links take the free slots in order; the rest (and any past
    # the free count) go to slot K, which is dropped.
    K = graph.dyn_mask.shape[0]
    free_slots = compact(free, K, K)
    pos = torch.cumsum(valid.to(torch.int64), 0) - 1
    applied = valid & (pos < n_free)
    slots = torch.where(applied, free_slots[pos.clamp(0, K - 1)], K)

    def put(arr, vals):
        out = torch.cat([arr, arr[:1]])
        out[slots] = vals
        return out[:K]

    add = applied.to(torch.int32)
    return dataclasses.replace(
        graph, dyn_senders=put(graph.dyn_senders, s),
        dyn_receivers=put(graph.dyn_receivers, r),
        dyn_mask=put(graph.dyn_mask, torch.ones_like(valid)),
        in_degree=graph.in_degree.index_add(0, r, add),
        out_degree=graph.out_degree.index_add(0, s, add))


def disconnect(graph: Graph, senders, receivers, *,
               undirected: bool = True) -> Graph:
    """Remove dynamic links matched by endpoint pair (static edges go with
    ``sim/failures.py``)."""
    _require_dynamic(graph)
    s, r = _ids(graph, senders), _ids(graph, receivers)
    if undirected:
        s, r = torch.cat([s, r]), torch.cat([r, s])
    hit = ((graph.dyn_senders[:, None] == s[None, :])
           & (graph.dyn_receivers[:, None] == r[None, :])).any(dim=1) \
        & graph.dyn_mask
    h = hit.to(torch.int32)
    zeros = torch.zeros_like(graph.in_degree)
    return dataclasses.replace(
        graph, dyn_mask=graph.dyn_mask & ~hit,
        in_degree=graph.in_degree - zeros.index_add(0, graph.dyn_receivers, h),
        out_degree=graph.out_degree - zeros.index_add(0, graph.dyn_senders,
                                                      h))


def join_node(graph: Graph, node_id: int, peers) -> Graph:
    """Activate a spare (padding) node and connect it to ``peers``."""
    _require_dynamic(graph)
    _check_ids_in_range([node_id], graph.n_nodes_padded, "node")
    node_mask = graph.node_mask.clone()
    node_mask[node_id] = True
    peers = _ids(graph, peers)
    return connect(dataclasses.replace(graph, node_mask=node_mask),
                   torch.full_like(peers, node_id), peers)


def consolidate(graph: Graph, *, extra_edges: int = 0, extra_nodes: int = 0,
                **from_edges_kwargs) -> Graph:
    """Fold runtime links and failures into a fresh static build through
    the port's ``from_edges`` (host-side, one-off): dynamic links become
    static edges (at ``DYNAMIC_LINK_COST`` on a weighted graph, the cost
    they propagated at), dead edges go, liveness stays. Layouts (blocked,
    hybrid, source-CSR) and the neighbor-table settings carry over unless
    ``from_edges_kwargs`` say otherwise; ``extra_edges``/``extra_nodes``
    re-reserve capacity. On a rank's part every rank gathers every rank's
    live static edges (``parallel/mesh.py`` ``gather_ragged``), rebuilds
    the whole graph as one process does, and returns its part of it."""
    from p2pnetwork_tpu_torch.sim.failures import with_node_liveness
    from p2pnetwork_tpu_torch.sim.graph import from_edges, graph_part

    senders, receivers = graph._live_edges()
    weights = None
    if graph.edge_weight is not None:
        weights = graph.edge_weight.cpu().numpy()[
            graph.edge_mask.cpu().numpy()]
    part = part_of(graph)
    if part is not None:
        # Every rank's live static edges in ring order (the whole graph's
        # order): the rebuild is the whole graph's on every rank, cut to
        # the rank's part again at the end.
        cols = [senders, receivers] + ([] if weights is None
                                       else [weights.view(np.int32)])
        rows = gather_ragged(part.mesh, torch.from_numpy(
            np.stack(cols, axis=1).astype(np.int64))).numpy()
        senders, receivers = (rows[:, i].astype(np.int32) for i in (0, 1))
        if weights is not None:
            weights = rows[:, 2].astype(np.int32).view(np.float32)
    if graph.dyn_mask is not None:
        dm = graph.dyn_mask.cpu().numpy()
        senders = np.concatenate(
            [senders, graph.dyn_senders.cpu().numpy()[dm]])
        receivers = np.concatenate(
            [receivers, graph.dyn_receivers.cpu().numpy()[dm]])
        if weights is not None:
            # Runtime links propagated at unit cost; the rebuild keeps it
            # as their static weight.
            weights = np.concatenate([weights, np.full(
                int(dm.sum()), DYNAMIC_LINK_COST, dtype=np.float32)])
    alive = graph.node_mask.cpu().numpy()
    # The rebuilt id space covers joined spare nodes and every endpoint.
    referenced = [graph.n_nodes]
    if alive.any():
        referenced.append(int(np.flatnonzero(alive).max()) + 1)
    if senders.size:
        referenced.append(int(max(senders.max(), receivers.max())) + 1)
    n_eff = max(referenced)
    layout_kw = {
        "blocked": from_edges_kwargs.pop("blocked", graph.blocked is not None),
        "hybrid": from_edges_kwargs.pop("hybrid", graph.hybrid is not None),
        "source_csr": from_edges_kwargs.pop("source_csr",
                                            graph.src_eid is not None),
    }
    from_edges_kwargs.setdefault("build_neighbor_table",
                                 graph.neighbors is not None)
    from_edges_kwargs.setdefault("edge_pad_multiple", graph.edge_pad_multiple)
    if graph.max_degree_cap is not None:
        from_edges_kwargs.setdefault("max_degree", graph.max_degree_cap)
    elif graph.neighbors is not None and not graph.neighbors_complete:
        from_edges_kwargs.setdefault("max_degree", graph.max_degree)
    from_edges_kwargs.setdefault("device", graph.device)
    defer_layouts = bool(extra_nodes)
    if not defer_layouts:
        from_edges_kwargs.update(layout_kw)
    if weights is not None:
        from_edges_kwargs.setdefault("weights", weights)
    g2 = from_edges(senders, receivers, n_eff, **from_edges_kwargs)
    # from_edges marks [0, n_eff) alive; re-apply the real liveness.
    alive2 = np.zeros(g2.n_nodes_padded, dtype=bool)
    span = min(alive.shape[0], g2.n_nodes_padded)
    alive2[:span] = alive[:span]
    g2 = with_node_liveness(g2, torch.from_numpy(alive2).to(g2.device))
    if extra_edges or extra_nodes:
        g2 = with_capacity(g2, extra_edges=extra_edges,
                           extra_nodes=extra_nodes)
    if defer_layouts:
        if layout_kw["blocked"]:
            g2 = g2.with_blocked()
        if layout_kw["hybrid"]:
            g2 = g2.with_hybrid()
        if layout_kw["source_csr"]:
            g2 = g2.with_source_csr()
    return g2 if part is None else graph_part(g2, part.mesh)
