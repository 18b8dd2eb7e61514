"""Frontier-adaptive flood: sparse rounds when the wave is small (torch
counterpart of ``p2pnetwork_tpu/models/adaptive_flood.py``).

Two round implementations, chosen per round by the frontier's out-edge
mass in work items:

- **sparse** (item count ``<= k``): the frontier is a list of ``k``
  work items ``(node, slice)``, each naming one ``W``-wide slice of the
  node's out-edge row in the source-CSR view. One round gathers those
  ``k·W`` slots and the frontier's links in the dynamic edge region
  (``sim/topology.py``), dedups new receivers with a scatter-min first
  claim, marks them seen, and expands the winners back into work items.
- **dense** (item count ``> k``): ``Flood``'s masked OR round, keeping the
  work-item lists ready for the crossing back under ``k``.

Results are bit-identical to ``Flood`` and to the reference, work-item
lists included (``tests/test_torch_flood.py``). ``bitset=True`` carries
the seen/frontier predicates packed (``ops/bitset.py``); the rounds
unpack them and pack their results.

Where the reference branches on the device (``lax.cond``), the port reads
the item count on the host once per round (one sync, counted in
``_device.SYNCS``). The dense round's re-entry compaction is computed
every dense round and selected with ``torch.where``, so it costs no sync.
``jnp.nonzero(size=k, fill_value=...)`` becomes a cumsum + scatter
compaction with the same ascending order and fill value
(``ops/frontier.py`` ``compact``).

``AdaptiveHopDistance`` runs the same wave and records each node's first
round, as ``HopDistance`` does.
"""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch import _device
from p2pnetwork_tpu_torch.models import base
from p2pnetwork_tpu_torch.models.flood import live_coverage
from p2pnetwork_tpu_torch.models.hopdist import reached_coverage
from p2pnetwork_tpu_torch.ops import bitset
from p2pnetwork_tpu_torch.ops import frontier as frontier_ops
from p2pnetwork_tpu_torch.ops import segment
from p2pnetwork_tpu_torch.ops.frontier import compact, set_true
from p2pnetwork_tpu_torch.sim.graph import Graph


@dataclasses.dataclass(frozen=True)
class AdaptiveFloodState:
    seen: torch.Tensor  # bool[N_pad]
    frontier: torch.Tensor  # bool[N_pad]
    fidx: torch.Tensor  # i32[k] — work-item node ids (valid iff fcount <= k)
    fslice: torch.Tensor  # i32[k] — slice index within the node's row
    fcount: torch.Tensor  # i32[] — frontier out-edge mass in work items


@dataclasses.dataclass(frozen=True)
class AdaptiveFloodBitState:
    """``AdaptiveFloodState`` with seen/frontier packed 32 nodes per word."""

    #: Fields holding the reference's ``uint32`` words as int32 with the
    #: same bits: checkpoints write them as ``uint32`` (``sim/checkpoint.py``).
    U32_WORDS = ("seen", "frontier")

    seen: torch.Tensor  # i32[N_pad // 32], u32 bit patterns
    frontier: torch.Tensor  # i32[N_pad // 32]
    fidx: torch.Tensor  # i32[k]
    fslice: torch.Tensor  # i32[k]
    fcount: torch.Tensor  # i32[]


@dataclasses.dataclass(frozen=True)
class AdaptiveFlood:
    """Single-source flood with frontier-sparse small rounds. ``k`` is the
    sparse capacity in work items, ``method`` the dense round's lowering,
    ``slice_width`` the per-item row-slice width (0 = ``min(max_out_span,
    128)``), ``bitset`` packs the predicates
    (:class:`AdaptiveFloodBitState`)."""

    source: int = 0
    method: str = "auto"
    k: int = 1024
    slice_width: int = 0
    bitset: bool = False

    STATS = ("messages", "coverage", "frontier", "frontier_occupancy")

    def init(self, graph: Graph, key):
        seed, fidx, fslice, count = _wave_seed(graph, self.source, self.k,
                                               self.slice_width)
        if self.bitset:
            packed = bitset.pack_bits(seed)
            return AdaptiveFloodBitState(seen=packed, frontier=packed,
                                         fidx=fidx, fslice=fslice,
                                         fcount=count)
        return AdaptiveFloodState(seen=seed, frontier=seed, fidx=fidx,
                                  fslice=fslice, fcount=count)

    def coverage(self, graph: Graph, state):
        return live_coverage(graph, state.seen)

    def step(self, graph: Graph, state, key):
        packed = isinstance(state, AdaptiveFloodBitState)
        n_pad = graph.n_nodes_padded
        seen0, frontier0 = ((bitset.unpack_bits(state.seen, n_pad),
                             bitset.unpack_bits(state.frontier, n_pad))
                            if packed else (state.seen, state.frontier))
        seen, frontier, fidx, fslice, fcount, ncount, msgs = _wave_step(
            graph, self.k, self.slice_width, self.method, seen0, frontier0,
            state.fidx, state.fslice, state.fcount)
        stats = {
            "messages": msgs,
            "coverage": live_coverage(graph, seen),
            "frontier": ncount,
            "frontier_occupancy": frontier_ops.occupancy(graph, frontier),
        }
        if packed:
            return AdaptiveFloodBitState(
                seen=bitset.pack_bits(seen),
                frontier=bitset.pack_bits(frontier), fidx=fidx,
                fslice=fslice, fcount=fcount), stats
        return AdaptiveFloodState(seen=seen, frontier=frontier, fidx=fidx,
                                  fslice=fslice, fcount=fcount), stats


def _slice_width(graph: Graph, slice_width: int) -> int:
    """W: one item per node on quasi-regular graphs, rows wider than 128
    chunked."""
    if slice_width > 0:
        return slice_width
    return max(1, min(graph.max_out_span, 128))


def _one_item_per_node(graph: Graph, w: int) -> bool:
    """No build-time row is wider than ``w``: item expansion is the
    identity and item mass equals node count."""
    return graph.max_out_span <= w


def _row_items(graph: Graph, w: int, nodes: torch.Tensor) -> torch.Tensor:
    """Work items per node: its CSR row in W-wide slices (empty rows cost
    one item, so every frontier node owns a slice-0 item)."""
    row_len = graph.src_offsets[nodes + 1] - graph.src_offsets[nodes]
    return ((row_len + w - 1) // w).clamp_min(1).to(torch.int32)


def _expand_items(graph: Graph, w: int, k: int, wnode: torch.Tensor,
                  node_count: torch.Tensor):
    """Expand ``node_count`` frontier nodes (``wnode``, i32[k]) into
    ``(fidx, fslice, icount)`` work items: per-node counts -> cumsum ->
    searchsorted. An ``icount > k`` result truncates; dense mode then takes
    over and the lists are never read."""
    dev = wnode.device
    if _one_item_per_node(graph, w):
        return wnode, torch.zeros(k, dtype=torch.int32, device=dev), node_count
    pad_node = graph.n_nodes_padded - 1
    p = torch.arange(k, dtype=torch.int32, device=dev)
    items_per = torch.where(p < node_count, _row_items(graph, w, wnode), 0)
    offs = torch.cumsum(items_per, 0, dtype=torch.int32)
    icount = offs[-1]
    starts = offs - items_per
    j = torch.searchsorted(offs, p, right=True).clamp(0, k - 1)
    valid = p < icount
    fidx = torch.where(valid, wnode[j], pad_node)
    fslice = torch.where(valid, p - starts[j], 0).to(torch.int32)
    return fidx, fslice, icount


def _sparse_wave_round(graph: Graph, w: int, k: int, seen, frontier, fidx,
                       fslice, fcount):
    """One frontier-sparse round over exactly ``k·W`` gathered slots.
    Returns ``(seen, frontier, fidx, fslice, icount, node_count, msgs)``."""
    n_pad = graph.n_nodes_padded
    pad_node = n_pad - 1
    dev = seen.device
    p = torch.arange(k, dtype=torch.int32, device=dev)

    fvalid = p < fcount
    f = torch.where(fvalid, fidx, pad_node)
    # Each frontier node owns exactly one slice-0 item, so counting
    # out_degree through those matches frontier_messages send for send.
    msgs = torch.where(fvalid & (fslice == 0), graph.out_degree[f], 0).sum()
    eid, in_row = graph.gather_row_slots(
        graph.src_offsets[f] + fslice * w, graph.src_offsets[f + 1], w)
    evalid = in_row & fvalid[:, None] & graph.edge_mask[eid]
    cand = torch.where(evalid, graph.receivers[eid], pad_node).reshape(-1)
    fresh = evalid.reshape(-1) & ~seen[cand] & graph.node_mask[cand]
    if graph.dyn_senders is not None:
        # The frontier's runtime links: the small region is scanned whole.
        dsend = frontier[graph.dyn_senders] & graph.dyn_mask
        dcand = torch.where(dsend, graph.dyn_receivers, pad_node)
        dfresh = dsend & ~seen[dcand] & graph.node_mask[dcand]
        cand = torch.cat([cand, dcand])
        fresh = torch.cat([fresh, dfresh])

    # First-claim dedup: each fresh slot claims its candidate with its
    # position; the winners hold the minimum claim.
    order = torch.arange(cand.shape[0], dtype=torch.int32, device=dev)
    big = 2**31 - 1
    claim = torch.where(fresh, order, big)
    scratch = torch.full((n_pad,), big, dtype=torch.int32, device=dev)
    scratch.scatter_reduce_(0, cand.long(), claim, reduce="amin")
    winner = fresh & (scratch[cand] == order)
    node_count = winner.sum().to(torch.int32)

    seen = set_true(seen, torch.where(fresh, cand, n_pad))
    new_frontier = set_true(torch.zeros_like(seen),
                             torch.where(winner, cand, n_pad))
    pos = compact(winner, k, fill=cand.shape[0] - 1)
    wnode = torch.where(p < node_count, cand[pos], pad_node)
    fidx, fslice, icount = _expand_items(graph, w, k, wnode, node_count)
    # A node_count > k frontier truncated the lists: saturate so dense
    # mode takes over.
    icount = torch.where(node_count > k, k + 1, icount)
    return seen, new_frontier, fidx, fslice, icount, node_count, msgs


def _dense_wave_round(graph: Graph, w: int, k: int, method: str, seen,
                      frontier, fidx, fslice):
    """One dense round (``Flood``'s masked OR), refreshing the work-item
    lists when the new frontier fits in ``k`` items."""
    delivered = segment.propagate_or(graph, frontier, method)
    new = delivered & ~seen & graph.node_mask
    seen = seen | new
    node_count = new.sum().to(torch.int32)
    if _one_item_per_node(graph, w):
        icount = node_count
    else:
        nodes = torch.arange(graph.n_nodes_padded, device=seen.device)
        icount = torch.where(new, _row_items(graph, w, nodes), 0).sum()
        icount = icount.to(torch.int32)
    wnode = compact(new, k, fill=graph.n_nodes_padded - 1).to(torch.int32)
    cfidx, cfslice, _ = _expand_items(graph, w, k, wnode, node_count)
    refill = icount <= k
    fidx = torch.where(refill, cfidx, fidx)
    fslice = torch.where(refill, cfslice, fslice)
    msgs = segment.frontier_messages(graph, frontier)
    return seen, new, fidx, fslice, icount, node_count, msgs


def _wave_seed(graph: Graph, source: int, k: int, slice_width: int):
    """The source's one-hot (masked by liveness), its work-item lists and
    the item count."""
    base.validate_source(graph, source)
    if graph.src_eid is None:
        raise ValueError("AdaptiveFlood requires a source-CSR graph — build "
                         "with from_edges(source_csr=True)")
    w = _slice_width(graph, slice_width)
    seed = base.source_seed(graph, source)
    wnode = torch.full((k,), graph.n_nodes_padded - 1, dtype=torch.int32,
                       device=graph.device)
    wnode[0] = source
    node_count = seed.sum().to(torch.int32)
    fidx, fslice, icount = _expand_items(graph, w, k, wnode, node_count)
    return seed, fidx, fslice, icount


def _wave_step(graph: Graph, k: int, slice_width: int, method: str, seen,
               frontier, fidx, fslice, fcount):
    """Sparse or dense by the frontier's item count, read on the host."""
    w = _slice_width(graph, slice_width)
    if _device.host_bool(fcount <= k):
        return _sparse_wave_round(graph, w, k, seen, frontier, fidx, fslice,
                                  fcount)
    return _dense_wave_round(graph, w, k, method, seen, frontier, fidx,
                             fslice)


@dataclasses.dataclass(frozen=True)
class AdaptiveHopDistanceState:
    dist: torch.Tensor  # i32[N_pad] — BFS hops from source, -1 = not reached
    frontier: torch.Tensor  # bool[N_pad]
    fidx: torch.Tensor  # i32[k]
    fslice: torch.Tensor  # i32[k]
    fcount: torch.Tensor  # i32[] — item count (W-slice out-edge mass)
    round: torch.Tensor  # i32[]


@dataclasses.dataclass(frozen=True)
class AdaptiveHopDistance:
    """BFS hop distances with frontier-sparse small rounds: the adaptive
    twin of ``HopDistance`` (the wave is the adaptive flood's; nodes
    record the first round that reaches them), equal to it round for
    round."""

    source: int = 0
    method: str = "auto"
    k: int = 1024
    slice_width: int = 0

    STATS = ("messages", "coverage", "frontier", "frontier_occupancy",
             "max_dist")

    def init(self, graph: Graph, key) -> AdaptiveHopDistanceState:
        seed, fidx, fslice, count = _wave_seed(graph, self.source, self.k,
                                               self.slice_width)
        return AdaptiveHopDistanceState(
            dist=torch.where(seed, 0, -1).to(torch.int32), frontier=seed,
            fidx=fidx, fslice=fslice, fcount=count,
            round=torch.zeros((), dtype=torch.int32, device=graph.device))

    def coverage(self, graph: Graph, state):
        return reached_coverage(graph, state.dist)

    def step(self, graph: Graph, state: AdaptiveHopDistanceState, key):
        seen = state.dist >= 0
        _, frontier, fidx, fslice, fcount, ncount, msgs = _wave_step(
            graph, self.k, self.slice_width, self.method, seen,
            state.frontier, state.fidx, state.fslice, state.fcount)
        rnd = state.round + 1
        dist = torch.where(frontier, rnd, state.dist)
        stats = {
            "messages": msgs,
            "coverage": reached_coverage(graph, dist),
            "frontier": ncount,
            "frontier_occupancy": frontier_ops.occupancy(graph, frontier),
            "max_dist": dist.max(),
        }
        return AdaptiveHopDistanceState(
            dist=dist, frontier=frontier, fidx=fidx, fslice=fslice,
            fcount=fcount, round=rnd), stats
