"""Fault injection: node and edge failures as inputs (torch counterpart of
``p2pnetwork_tpu/sim/failures.py``).

Killing nodes or cutting links flips mask bits: the same shapes, no
rebuild, and the next round routes around the damage. Every function
returns a new ``Graph`` with each representation it carries (COO masks,
degrees, neighbor table, blocked layout, hybrid diagonals and remainder,
skew table, dynamic edge region) re-masked consistently on the device;
the input is not modified, so keeping it is how a failure is undone.

``random_node_failures`` / ``random_edge_failures`` draw their Bernoulli
masks from ``prng.py``, bit for bit the reference's.

On a rank's part (``sim/graph.py`` ``graph_part``, the auto path across
ranks) every function takes the whole graph's ids and draws, updates the
whole node fields (the degrees in one exchange) and re-masks the part's
own edges, rows and layouts.

Every injection is counted in ``sim_injected_failures_total{kind}``
(``telemetry/``): the entity count for the deterministic kinds, one per
call for ``partition``, ``preempt`` and the random draws (``*_draw``).
:func:`preempt` arms a run harness's preemption (anything with
``arm_preemption``): ``supervise/runner.py``'s ``SupervisedRun``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from p2pnetwork_tpu_torch import prng, telemetry
from p2pnetwork_tpu_torch.ops import skew as SK
from p2pnetwork_tpu_torch.parallel import mesh as M
from p2pnetwork_tpu_torch.parallel.mesh import combine
from p2pnetwork_tpu_torch.sim.graph import Graph, edge_slots, part_of
from p2pnetwork_tpu_torch.sim.topology import _check_ids_in_range, _ids


def _count_injected(kind: str, ids=None) -> None:
    """Count one injection in ``sim_injected_failures_total{kind}``: the
    number of ids when given, else 1."""
    n = 1
    if isinstance(ids, torch.Tensor):
        n = ids.numel()
    elif ids is not None:
        n = int(np.asarray(ids).size)
    telemetry.default_registry().counter(
        "sim_injected_failures_total",
        "Failures injected into sim graphs, by kind (entity counts for "
        "deterministic kinds, draw counts for *_draw).",
        ("kind",)).labels(kind).inc(n)


def _degrees(graph: Graph, edge_mask: torch.Tensor, dyn_mask=None):
    """``(in_degree, out_degree)`` recomputed from the surviving static
    edges and, when present, dynamic links. On a rank's part the static
    edges are the rank's own: every rank's counts are summed in one
    ``combine`` (the dynamic region is whole on every rank)."""
    live = edge_mask.to(torch.int32)
    zeros = torch.zeros(graph.n_nodes_padded, dtype=torch.int32,
                        device=edge_mask.device)
    in_degree = zeros.index_add(0, graph.receivers, live)
    out_degree = zeros.index_add(0, graph.senders, live)
    part = part_of(graph)
    if part is not None:
        in_degree, out_degree = combine(
            part, torch.stack([in_degree, out_degree]), "sum")
    if dyn_mask is not None:
        dlive = dyn_mask.to(torch.int32)
        in_degree = in_degree.index_add(0, graph.dyn_receivers, dlive)
        out_degree = out_degree.index_add(0, graph.dyn_senders, dlive)
    return in_degree, out_degree


def _remask_blocked(blocked, node_alive: torch.Tensor, lo: int = 0):
    """A blocked layout re-masked to slots whose two endpoints live
    (destinations counted from ``lo``, a part's first owned node)."""
    if blocked is None:
        return None
    nb = blocked.src.shape[0]
    base = torch.arange(nb, dtype=torch.int32,
                        device=node_alive.device)[:, None] * blocked.block
    global_dst = (base + blocked.local_dst + lo).clamp_max(
        node_alive.shape[0] - 1)
    mask = blocked.mask & node_alive[blocked.src] & node_alive[global_dst]
    return dataclasses.replace(blocked, mask=mask)


def _remask_hybrid(hybrid, node_alive: torch.Tensor, lo: int = 0,
                   hi: int = None):
    """Diagonal masks need both endpoints alive; the remainder as
    :func:`_remask_blocked`. On a rank's part the masks hold the owned
    columns ``[lo, hi)``."""
    if hybrid is None:
        return None
    masks = hybrid.masks
    if len(hybrid.offsets):
        core = node_alive[: hybrid.n]
        # mask[d, v] needs v alive and (v + off) % n alive.
        src_alive = torch.stack([torch.roll(core, -off)
                                 for off in hybrid.offsets])
        a = min(lo, hybrid.n)
        b = hybrid.n if hi is None else min(hi, hybrid.n)
        masks = masks & core[None, a:b] & src_alive[:, a:b]
    return dataclasses.replace(
        hybrid, masks=masks,
        remainder=_remask_blocked(hybrid.remainder, node_alive, lo))


def with_node_liveness(graph: Graph, node_alive: torch.Tensor) -> Graph:
    """Apply a liveness mask (bool[N_pad], False = failed): an edge or
    dynamic link lives iff it did and both endpoints live; degrees are
    recomputed; the neighbor table and the blocked, hybrid and skew
    layouts are re-masked in place (shapes unchanged). On a rank's part
    the whole ``node_mask`` is updated, the owned rows and columns of the
    layouts are re-masked, and the degrees take one exchange
    (:func:`_degrees`)."""
    part = part_of(graph)
    lo, hi = (0, None) if part is None else (part.lo, part.hi)
    node_mask = graph.node_mask & node_alive
    edge_mask = (graph.edge_mask & node_mask[graph.senders]
                 & node_mask[graph.receivers])
    dyn_mask = graph.dyn_mask
    if dyn_mask is not None:
        dyn_mask = (dyn_mask & node_mask[graph.dyn_senders]
                    & node_mask[graph.dyn_receivers])
    in_degree, out_degree = _degrees(graph, edge_mask, dyn_mask)
    neighbor_mask = graph.neighbor_mask
    if neighbor_mask is not None:
        neighbor_mask = (neighbor_mask & M.owned(graph, node_mask)[:, None]
                         & node_mask[graph.neighbors])
    return dataclasses.replace(
        graph, node_mask=node_mask, edge_mask=edge_mask, dyn_mask=dyn_mask,
        in_degree=in_degree, out_degree=out_degree,
        neighbor_mask=neighbor_mask,
        blocked=_remask_blocked(graph.blocked, node_mask, lo),
        hybrid=_remask_hybrid(graph.hybrid, node_mask, lo, hi),
        skew=SK.remask_nodes(graph.skew, node_mask))


def _flags(n: int, ids: torch.Tensor, value: bool) -> torch.Tensor:
    """bool[n] that is ``value`` at ``ids`` and the opposite elsewhere."""
    out = torch.full((n,), not value, dtype=torch.bool, device=ids.device)
    out[ids.long()] = value
    return out


def fail_nodes(graph: Graph, node_ids) -> Graph:
    """Fail-stop the given nodes: they neither send nor receive, and their
    edges die with them."""
    _check_ids_in_range(node_ids, graph.n_nodes_padded, "node")
    _count_injected("node", node_ids)
    ids = _ids(graph, node_ids)
    return with_node_liveness(graph, _flags(graph.n_nodes_padded, ids, False))


def mark_unresponsive(graph: Graph, node_ids) -> Graph:
    """Clear ``node_mask`` for the given ids without re-masking edges,
    degrees or tables: the crashed-but-still-configured view a failure
    detector probes. Other protocols want :func:`fail_nodes`."""
    _check_ids_in_range(node_ids, graph.n_nodes_padded, "node")
    _count_injected("node_unresponsive", node_ids)
    node_mask = graph.node_mask.clone()
    node_mask[_ids(graph, node_ids).long()] = False
    return dataclasses.replace(graph, node_mask=node_mask)


def with_edge_liveness(graph: Graph, edge_alive: torch.Tensor) -> Graph:
    """Apply a per-edge liveness mask (bool[E_pad], False = cut link),
    directed. Degrees are recomputed; a complete neighbor table is
    re-masked exactly, a width-capped one dropped (its slot -> edge map is
    gone); the skew table re-masks through its slot -> edge map. Refused
    on graphs carrying blocked/hybrid layouts, whose edge order differs:
    use node failures or rebuild. On a rank's part ``edge_alive`` is
    aligned with the part's own edge slots (:func:`fail_edges` and
    :func:`random_edge_failures` cut the whole graph's to them)."""
    if graph.blocked is not None or graph.hybrid is not None:
        raise ValueError(
            "edge-level failures on a graph with blocked/hybrid "
            "representations would desynchronize them; use fail_nodes / "
            "with_node_liveness, or rebuild from the surviving edge list")
    edge_mask = graph.edge_mask & edge_alive
    in_degree, out_degree = _degrees(graph, edge_mask, graph.dyn_mask)
    neighbors, neighbor_mask = graph.neighbors, graph.neighbor_mask
    if neighbor_mask is not None:
        if graph.neighbors_complete:
            dev = edge_mask.device
            starts = torch.searchsorted(graph.receivers, M.owned(
                graph, torch.arange(graph.n_nodes_padded, dtype=torch.int32,
                                    device=dev)))
            take = starts[:, None] + torch.arange(neighbors.shape[1],
                                                  device=dev)
            take = take.clamp_max(graph.n_edges_padded - 1)
            neighbor_mask = neighbor_mask & edge_mask[take]
        else:
            neighbors = neighbor_mask = None
    return dataclasses.replace(
        graph, edge_mask=edge_mask, in_degree=in_degree,
        out_degree=out_degree, neighbors=neighbors,
        neighbor_mask=neighbor_mask,
        skew=SK.remask_edges(graph.skew, edge_mask, graph.n_edges_padded))


def _own_slots(graph: Graph, flags: torch.Tensor) -> torch.Tensor:
    """Per-edge ``flags`` of the whole graph (``edge_slots`` long) as the
    graph's own: themselves, or on a rank's part those of its edges, the
    whole graph's slots ``[edge_lo, edge_lo + n_edges)`` (its padding
    slots set)."""
    part = part_of(graph)
    if part is None:
        return flags
    out = torch.ones(graph.n_edges_padded, dtype=torch.bool,
                     device=flags.device)
    out[:graph.n_edges] = flags[part.edge_lo:part.edge_lo + graph.n_edges]
    return out


def fail_edges(graph: Graph, edge_ids) -> Graph:
    """Cut specific links (indices into the edge arrays; on a rank's part
    into the whole graph's)."""
    n = edge_slots(graph)
    _check_ids_in_range(edge_ids, n, "edge")
    _count_injected("edge", edge_ids)
    ids = _ids(graph, edge_ids)
    return with_edge_liveness(graph, _own_slots(graph, _flags(n, ids, False)))


def revive_nodes(graph: Graph, node_ids, original: Graph) -> Graph:
    """Un-fail the given nodes, restoring their wiring in ``original`` (the
    graph before the failures): ``original`` re-masked to the previously
    live nodes and the revived ones. Edge cuts made after ``original`` are
    forgotten."""
    _check_ids_in_range(node_ids, graph.n_nodes_padded, "node")
    _count_injected("node_revive", node_ids)
    revived = _flags(graph.n_nodes_padded, _ids(graph, node_ids), True)
    alive = graph.node_mask | (revived & original.node_mask)
    return with_node_liveness(original, alive)


def partition(graph: Graph, groups) -> Graph:
    """Cut every edge, static or dynamic, between two of the node-id
    ``groups`` (nodes in no group are unconstrained). Edge-level, so
    refused on blocked/hybrid graphs as :func:`with_edge_liveness` is."""
    side = np.full(graph.n_nodes_padded, -1, dtype=np.int64)
    for gi, group in enumerate(groups):
        ids = np.asarray(group, dtype=np.int64)
        _check_ids_in_range(ids, graph.n_nodes_padded, "node")
        side[ids] = gi
    _count_injected("partition")
    side_t = torch.from_numpy(side).to(graph.device)

    def crossing(senders, receivers):
        a, b = side_t[senders], side_t[receivers]
        return (a >= 0) & (b >= 0) & (a != b)

    gp = with_edge_liveness(graph, ~crossing(graph.senders, graph.receivers))
    if graph.dyn_mask is not None:
        # with_edge_liveness leaves the dynamic region as it is; a runtime
        # link across the split dies too.
        dyn_mask = gp.dyn_mask & ~crossing(graph.dyn_senders,
                                           graph.dyn_receivers)
        in_degree, out_degree = _degrees(gp, gp.edge_mask, dyn_mask)
        gp = dataclasses.replace(gp, dyn_mask=dyn_mask, in_degree=in_degree,
                                 out_degree=out_degree)
    return gp


#: The names the sockets chaos plane uses for the same failures.
kill_nodes = fail_nodes
cut_links = fail_edges


def preempt(run, at_round: int):
    """Arm a deterministic preemption of a supervised run harness: ``run``
    is anything with ``arm_preemption(at_round)``, which raises at the
    first chunk boundary at or past ``at_round``, before the checkpoint
    due there. Counted as ``sim_injected_failures_total{kind="preempt"}``.
    Returns ``run``."""
    _count_injected("preempt")
    run.arm_preemption(int(at_round))
    return run


def random_node_failures(graph: Graph, key, frac: float) -> Graph:
    """Fail each live node independently with probability ``frac``."""
    _count_injected("node_draw")
    fail = prng.bernoulli(key, frac, (graph.n_nodes_padded,),
                          device=graph.device)
    return with_node_liveness(graph, ~(fail & graph.node_mask))


def random_edge_failures(graph: Graph, key, frac: float) -> Graph:
    """Cut each live directed edge independently with probability
    ``frac``."""
    _count_injected("edge_draw")
    cut = prng.bernoulli(key, frac, (edge_slots(graph),),
                         device=graph.device)
    return with_edge_liveness(graph, _own_slots(graph, ~cut))
