"""Ring-sharded flood on stacked shards (torch counterpart of the part of
``p2pnetwork_tpu/parallel/sharded.py`` that the dense flood reads).

The reference's layout, kept field for field (:class:`ShardedGraph`):

- **Node-partitioned state**: node ``v`` lives on shard ``v // block``;
  per-node tensors are ``[S, block]``.
- **Edge buckets by source shard**: shard ``d`` holds every edge whose
  receiver it owns, grouped into ``S`` buckets by ring distance (bucket
  ``t`` holds edges from shard ``(d - t) mod S``): ``bkt_*`` are
  ``[S, S, E_bkt]``, ``mxu_*`` (the blocked one-hot layout,
  ``mxu=True``/``hybrid=True``) ``[S, S, NB, W]``.
- **Ring exchange**: one round runs ``S`` steps. At step ``t`` shard ``d``
  holds the frontier block of shard ``(d - t) mod S`` and applies bucket
  ``t``; between steps the block hops to the next shard. The last bucket
  is peeled, so a pass makes ``S - 1`` hops.

The reference runs one program per chip under ``shard_map``. Here all S
shards are resident on one device (``mesh.RingMesh``), stacked on axis 0,
and each step works on all shards at once: bucket ``t`` of every shard is
the strided slice ``[:, t]``, reduced in one launch. The hop goes through
the comm seam (:class:`_RingComm`): ``comm="pallas"`` runs the CUDA ring
kernels (``ops/ring.py``: B2 for the bare hop, B3 fusing the hop with the
MXU bucket's segment sum), ``"ppermute"`` the plain ``torch.roll``;
``"auto"`` (the default) picks the kernels on a CUDA device. Results do
not depend on the backend, as in the reference. A ``chaos/device.py``
``FaultSpec`` as ``comm=`` wraps its backend in a ``FaultyComm`` that
faults the forward hops its schedule names, keyed on (round, step,
shard): the ring sets the step before each hop, and
:func:`flood_until_coverage` the global round ``fault_round0 + r``
before each pass, then counts the sites the executed rounds hit into
``chaos_device_faults_total``. A ``FaultyComm`` never fuses, so a faulted
``mxu`` pass runs B2's hop and B1's stacked sum in place of B3.

Churn runs on the device through the same seam: the liveness re-mask
(:func:`with_node_liveness`) collects each ring step's source liveness
with ``S`` forward hops and carries the out-degree counts back to the
sender's shard with ``S - 1`` reverse hops (``shift_back``: B2 run the
other way). Runtime links live in the dynamic region (:func:`with_capacity`,
:func:`connect`, :func:`disconnect`), whose unsorted bucket every ring
pass applies beside the static group at each step.

Ported: :func:`shard_graph` (``mxu``, ``hybrid``; a graph's runtime links
folded into the static buckets, its neighbor table carried),
:func:`flood`, :func:`flood_until_coverage` (dense loop),
:func:`propagate` (``or``, ``sum``, ``max``, ``minplus``), the liveness
re-mask (:func:`with_node_liveness`, :func:`fail_nodes`,
:func:`random_node_failures`), the dynamic region and
:func:`topology_state` / :func:`apply_topology_state`. Not yet: the
sender-CSR view and the frontier-adaptive loop, the flight recorder, the
batched loop and the other ring protocols.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from p2pnetwork_tpu_torch import prng
from p2pnetwork_tpu_torch.models.flood import Flood, FloodState, live_coverage
from p2pnetwork_tpu_torch.ops import blocked as B
from p2pnetwork_tpu_torch.ops import frontier as F
from p2pnetwork_tpu_torch.ops import ring, segment, segsum
from p2pnetwork_tpu_torch.ops.diag import select_diagonals
from p2pnetwork_tpu_torch.parallel.auto import COMM_BACKENDS, resolve_comm
from p2pnetwork_tpu_torch.parallel.mesh import DEFAULT_AXIS, RingMesh
from p2pnetwork_tpu_torch.sim import engine
from p2pnetwork_tpu_torch.sim.graph import _round_up

DEFAULT_COMM = "auto"


# ------------------------------------------------------ halo-exchange seam


class CommPayloadMismatch(TypeError):
    """A halo payload's shape/dtype diverged from the template its ring
    established on its first hop in that direction."""


class _RingComm:
    """One ring's halo-exchange backend: ``shift`` moves every shard's
    block to the NEXT ring shard, ``shift_back`` to the previous. The
    ring issues the hop BEFORE the step's bucket applies; both only read
    the resident block, so the hop is out of place.

    ``fused_segment_sum`` is non-None on the backend that fuses the hop
    with the MXU bucket's segment sum into one launch (kernel B3)."""

    __slots__ = ("backend", "n_shards", "_tpl_fwd", "_tpl_back")

    def __init__(self, backend: str, n_shards: int):
        if backend not in COMM_BACKENDS:
            raise ValueError(
                f"comm must be one of {COMM_BACKENDS} (or 'auto'), got "
                f"{backend!r}")
        self.backend = backend
        self.n_shards = n_shards
        self._tpl_fwd = None
        self._tpl_back = None

    @property
    def fuses(self) -> bool:
        """Whether this backend carries the hop inside the segment sum."""
        return self.backend == "pallas"

    def _check_payload(self, x, direction: str) -> None:
        """Hold the payload to the template of the first hop in
        ``direction``: one ring moves one payload shape per direction."""
        sig = (tuple(x.shape), str(x.dtype))
        slot = "_tpl_fwd" if direction == "shift" else "_tpl_back"
        tpl = getattr(self, slot)
        if tpl is None:
            setattr(self, slot, sig)
        elif tpl != sig:
            raise CommPayloadMismatch(
                f"halo payload {sig[0]}/{sig[1]} does not match the "
                f"template {tpl[0]}/{tpl[1]} this ring established on "
                f"its first {direction} — one ring moves one payload "
                "shape per direction (build a separate pass for a "
                "different payload)")

    def shift(self, x):
        self._check_payload(x, "shift")
        if self.backend == "pallas":
            return ring.ring_shift(x)
        return ring.ring_shift_plain(x)

    def shift_back(self, x):
        self._check_payload(x, "shift_back")
        if self.backend == "pallas":
            return ring.ring_shift(x, reverse=True)
        return ring.ring_shift_plain(x, reverse=True)

    def fused_segment_sum(self, rot, kind, src, local_dst, mask, block,
                          extent):
        """``(rot_next, out)`` — the hop fused with the segment sum of the
        step's MXU bucket (``kind`` "or" or "sum"; ``extent`` its rows'
        extents or None), or None when this backend has no fused form
        (the caller then shifts and applies separately)."""
        if self.backend != "pallas":
            return None
        self._check_payload(rot, "shift")
        fn = ring.ring_segment_sum_or if kind == "or" \
            else ring.ring_segment_sum_sum
        return fn(rot, src, local_dst, mask, block, extent=extent)


def _make_ring_comm(comm, axis_name: str, S: int, device):
    """One ring's comm object: a backend name (resolved for ``device``)
    builds the bare :class:`_RingComm`; a spec object (a
    ``chaos/device.FaultSpec``, carrying a concrete backend) builds its
    wrapper."""
    if isinstance(comm, str):
        return _RingComm(resolve_comm(comm, device), S)
    if not callable(getattr(comm, "make", None)):
        raise TypeError(
            f"comm must be a backend name or a spec object with make() "
            f"(chaos/device.FaultSpec), got {type(comm).__name__}")
    return comm.make(axis_name, S)


# ------------------------------------------------------------ sharded graph


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """A graph partitioned for an ``S``-shard ring, every tensor stacked
    on the shard axis (the reference's fields, names and shapes).

    ``bkt_*`` are ``[S, S, E_bkt]``: row = destination shard, second axis
    the ring step; ``bkt_src`` indexes the rotating frontier block,
    ``bkt_dst`` the shard's own block, each bucket sorted by destination.
    ``mxu_*`` (``mxu=True``) regroup each bucket by ``mxu_block``-node
    destination block (``ops/blocked.py``); under ``hybrid=True`` they hold
    only the edges off the ring-decomposed diagonals, whose pieces
    ``(ring_step, local_shift)`` and masks ``[S, P, B]`` are
    ``diag_pieces``/``diag_masks``. ``dyn_*`` (:func:`with_capacity`) is
    the dynamic edge region, ``[S, S, K]`` in the same bucket layout but
    unsorted: :func:`connect` fills free slots. ``neighbors`` /
    ``neighbors_mask`` (``[S, B, W]``, global ids) are the graph's
    neighbor table, re-masked by liveness as the single-device table is.
    The sender-CSR view is not ported and stays None.

    ``mxu_extent`` is the port's own (the reference has no such field):
    each MXU row's extent (:func:`row_extent`), which kernel B3 reads so
    that it skips a row's padded tail.
    """

    bkt_src: torch.Tensor  # i32[S, S, E_bkt]
    bkt_dst: torch.Tensor  # i32[S, S, E_bkt]
    bkt_mask: torch.Tensor  # bool[S, S, E_bkt]
    node_mask: torch.Tensor  # bool[S, B]
    out_degree: torch.Tensor  # i32[S, B]
    in_degree: torch.Tensor  # i32[S, B]
    n_nodes: int
    n_shards: int
    block: int
    dyn_src: Optional[torch.Tensor] = None
    dyn_dst: Optional[torch.Tensor] = None
    dyn_mask: Optional[torch.Tensor] = None
    neighbors: Optional[torch.Tensor] = None
    neighbors_mask: Optional[torch.Tensor] = None
    mxu_src: Optional[torch.Tensor] = None  # i32[S, S, NB, W]
    mxu_dst: Optional[torch.Tensor] = None  # i32[S, S, NB, W]
    mxu_mask: Optional[torch.Tensor] = None  # bool[S, S, NB, W]
    mxu_extent: Optional[torch.Tensor] = None  # i32[S, S, NB], port only
    diag_masks: Optional[torch.Tensor] = None  # bool[S, P, B]
    diag_pieces: Tuple[Tuple[int, int], ...] = ()
    mxu_block: int = 128
    csr_pos: Optional[torch.Tensor] = None
    csr_offsets: Optional[torch.Tensor] = None
    csr_span: int = 0

    @property
    def n_nodes_padded(self) -> int:
        return self.n_shards * self.block

    @property
    def dyn_capacity(self) -> int:
        return 0 if self.dyn_src is None else self.dyn_src.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.node_mask.device


def _extract_ring_diagonals(senders, receivers, n, S, block, max_diags,
                            min_count):
    """Select dominant circular diagonals and decompose each into static
    ring pieces (host-side; see ``ShardedGraph.diag_pieces``).

    Returns ``(pieces, masks [S, P, block], diag_sel)`` where ``diag_sel``
    flags the edges covered (the rest go to the bucket remainder). Edges
    whose signed offset wraps the real-node boundary stay in the
    remainder: only a diagonal's no-wrap body has the same piece structure
    on every shard."""
    kept, per_sel, diag_sel = select_diagonals(
        senders, receivers, n, max_diags, min_count)
    pieces = []
    mask_rows = []
    for o, sel in zip(kept, per_sel):
        off_s = o if o <= n // 2 else o - n
        v = receivers[sel].astype(np.int64)
        nowrap = (v + off_s >= 0) & (v + off_s < n)
        diag_sel[sel[~nowrap]] = False
        sel = sel[nowrap]
        if not sel.size:
            continue
        dmask = np.zeros(S * block, dtype=bool)
        dmask[receivers[sel]] = True
        dmask = dmask.reshape(S, block)
        q, r = divmod(off_s, block)  # floor division: r in [0, block)
        j = np.arange(block)
        piece_a = dmask & (j + r < block)[None, :]
        piece_b = dmask & (j + r >= block)[None, :]
        t_a = (-q) % S
        t_b = (-q - 1) % S
        if S == 1 or t_a == t_b:
            if piece_a.any() or piece_b.any():
                pieces.append((t_a, int(r)))
                mask_rows.append(dmask)
        else:
            if piece_a.any():
                pieces.append((t_a, int(r)))
                mask_rows.append(piece_a)
            if piece_b.any():
                pieces.append((t_b, int(r)))
                mask_rows.append(piece_b)
    if not pieces:
        return (), None, diag_sel
    return tuple(pieces), np.stack(mask_rows, axis=1), diag_sel


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def row_extent(src: np.ndarray, local_dst: np.ndarray,
               mask: np.ndarray) -> np.ndarray:
    """``i32[...]`` of the rows of ``[..., W]`` slot arrays: 1 + the index
    of each row's last slot whose ``(mask, src, local_dst)`` is not
    ``(0, 0, 0)``, 0 for a row with none. Every slot past a row's extent
    is the blocked layout's padding."""
    used = mask | (src != 0) | (local_dst != 0)
    last = used.shape[-1] - np.argmax(used[..., ::-1], axis=-1)
    return np.where(used.any(axis=-1), last, 0).astype(np.int32)


def shard_graph(graph, mesh: RingMesh, edge_pad_multiple: int = 128,
                mxu: bool = False, hybrid: bool = False, max_diags: int = 64,
                min_count: Optional[int] = None,
                source_csr: bool = False) -> ShardedGraph:
    """Partition ``graph`` for ``mesh`` (host-side, one-off), as the
    reference does, array for array.

    Nodes split into ``S`` contiguous blocks. Every live edge lands in
    bucket ``(dst_shard, ring_step)`` with ``ring_step = (dst_shard -
    src_shard) mod S``. ``mxu=True`` adds the blocked one-hot layout of
    each bucket, which the ring then reduces with the segment-sum kernels
    in place of the segment buckets; ``hybrid=True`` first takes the
    dominant circular diagonals out as roll-and-mask pieces and puts only
    the remainder in that layout. ``source_csr=True`` (the sender-CSR
    view of the frontier-adaptive loop) is not ported yet. A graph's live
    runtime links (``sim/topology.py``) are folded into the static
    buckets, as the reference folds them (its consolidation path)."""
    if source_csr:
        raise NotImplementedError(
            "shard_graph(source_csr=True) is not ported yet")
    S = mesh.n_shards
    emask = _np(graph.edge_mask)
    senders = _np(graph.senders)[emask]
    receivers = _np(graph.receivers)[emask]
    if graph.dyn_mask is not None:
        dmask = _np(graph.dyn_mask)
        senders = np.concatenate([senders, _np(graph.dyn_senders)[dmask]])
        receivers = np.concatenate([receivers,
                                    _np(graph.dyn_receivers)[dmask]])
    block = _round_up(graph.n_nodes_padded, S) // S

    # Diagonal extraction precedes bucketing (its selection indexes the
    # unsorted edge arrays); covered edges leave the applied remainder but
    # stay in the bkt_* arrays.
    diag_pieces: Tuple[Tuple[int, int], ...] = ()
    diag_masks = None
    if hybrid:
        diag_pieces, diag_masks, diag_sel = _extract_ring_diagonals(
            senders, receivers, graph.n_nodes, S, block, max_diags, min_count)
        mxu = True  # the remainder rides the MXU buckets
    else:
        diag_sel = np.zeros(senders.shape[0], dtype=bool)

    flat = (receivers // block) * S + ((receivers // block)
                                       - (senders // block)) % S
    order = np.lexsort((receivers, flat))
    senders_b, receivers_b, flat_b = senders[order], receivers[order], \
        flat[order]
    offsets = np.zeros(S * S + 1, dtype=np.int64)
    np.cumsum(np.bincount(flat_b, minlength=S * S), out=offsets[1:])
    e_bkt = _round_up(max(int(np.diff(offsets).max()), 1), edge_pad_multiple)
    bkt_src = np.zeros((S, S, e_bkt), dtype=np.int32)
    # Padding destinations are block - 1, so each bucket stays dst-sorted.
    bkt_dst = np.full((S, S, e_bkt), block - 1, dtype=np.int32)
    bkt_mask = np.zeros((S, S, e_bkt), dtype=bool)
    for d in range(S):
        for t in range(S):
            lo, hi = offsets[d * S + t], offsets[d * S + t + 1]
            bkt_src[d, t, :hi - lo] = senders_b[lo:hi] % block
            bkt_dst[d, t, :hi - lo] = receivers_b[lo:hi] % block
            bkt_mask[d, t, :hi - lo] = True

    mxu_arrays = None
    mxu_block = 512  # ops/diag.py's remainder block: less padding waste
    if mxu:
        # A subset of the bucket-sorted arrays stays sorted.
        ks = ~diag_sel[order]
        rem_s, rem_r = senders_b[ks], receivers_b[ks]
        rem_offs = np.zeros(S * S + 1, dtype=np.int64)
        np.cumsum(np.bincount(flat_b[ks], minlength=S * S), out=rem_offs[1:])
        per_bucket = []
        for b in range(S * S):
            lo, hi = rem_offs[b], rem_offs[b + 1]
            per_bucket.append(B.build_blocked_arrays_np(
                (rem_s[lo:hi] % block).astype(np.int32),
                (rem_r[lo:hi] % block).astype(np.int32), block, mxu_block))
        nb = max(bs.shape[0] for bs, _, _ in per_bucket)
        w = max(bs.shape[1] for bs, _, _ in per_bucket)
        mxu_arrays = (np.zeros((S, S, nb, w), np.int32),
                      np.zeros((S, S, nb, w), np.int32),
                      np.zeros((S, S, nb, w), bool))
        for b, bucket in enumerate(per_bucket):
            r, c = bucket[0].shape
            for full, part in zip(mxu_arrays, bucket):
                full[b // S, b % S, :r, :c] = part

    pad_n = S * block - graph.n_nodes_padded

    def per_node(t):
        return np.pad(_np(t), (0, pad_n)).reshape(S, block)

    def per_row(t):
        return None if t is None else np.pad(
            _np(t), ((0, pad_n), (0, 0))).reshape(S, block, -1)

    def on(a):
        return None if a is None else torch.from_numpy(a).to(mesh.device)

    mxu_src, mxu_dst, mxu_mask = map(on, mxu_arrays or (None,) * 3)
    mxu_extent = on(row_extent(*mxu_arrays) if mxu_arrays else None)
    return ShardedGraph(
        bkt_src=on(bkt_src), bkt_dst=on(bkt_dst), bkt_mask=on(bkt_mask),
        node_mask=on(per_node(graph.node_mask)),
        out_degree=on(per_node(graph.out_degree)),
        in_degree=on(per_node(graph.in_degree)),
        n_nodes=graph.n_nodes, n_shards=S, block=block,
        neighbors=on(per_row(graph.neighbors)),
        neighbors_mask=on(per_row(graph.neighbor_mask)),
        mxu_src=mxu_src, mxu_dst=mxu_dst, mxu_mask=mxu_mask,
        mxu_extent=mxu_extent, diag_masks=on(diag_masks),
        diag_pieces=diag_pieces, mxu_block=mxu_block)


# --------------------------------------------------------------- churn ops


def with_capacity(sg: ShardedGraph, extra_edges: int) -> ShardedGraph:
    """Reserve ``extra_edges`` dynamic slots per (dst-shard, ring-step)
    bucket, rounded up to a multiple of 8: any distribution of that many
    directed links fits whichever bucket it lands in. Growing an existing
    region keeps every runtime link and adds that many slots again."""
    K = _round_up(max(extra_edges, 1), 8)
    S, dev = sg.n_shards, sg.device
    if sg.dyn_src is not None:
        def pad(x):
            return torch.nn.functional.pad(x, (0, K))

        return dataclasses.replace(sg, dyn_src=pad(sg.dyn_src),
                                   dyn_dst=pad(sg.dyn_dst),
                                   dyn_mask=pad(sg.dyn_mask))
    return dataclasses.replace(
        sg, dyn_src=torch.zeros((S, S, K), dtype=torch.int32, device=dev),
        dyn_dst=torch.zeros((S, S, K), dtype=torch.int32, device=dev),
        dyn_mask=torch.zeros((S, S, K), dtype=torch.bool, device=dev))


def _remask_group(masks_by_t, nm, src, dst, mask, block):
    """One bucket group ``[S, S, W]`` re-masked by both endpoints'
    liveness, with its per-step sender counts ``[S, S, B]`` (on the
    receiver's shard, for the block resident at each step) and its
    in-degree counts ``[S, B]``. Only the live slots are counted: the
    padding slots of a bucket all address one sender and one receiver,
    and their atomic adds would serialise on those two counters (65 of
    69 ms of a 1M re-mask on the H100, phase 4s's profile)."""
    S = src.shape[0]
    src_alive = masks_by_t.gather(2, src.long())
    dst_alive = nm.gather(1, dst.reshape(S, -1).long()).reshape(dst.shape)
    mask = mask & src_alive & dst_alive
    d, t, w = mask.nonzero(as_tuple=True)
    one = torch.ones(d.numel(), dtype=torch.int32, device=nm.device)
    cnt = torch.zeros(S * S * block, dtype=torch.int32, device=nm.device)
    cnt.scatter_add_(0, (d * S + t) * block + src[d, t, w], one)
    cnt_in = torch.zeros(S * block, dtype=torch.int32, device=nm.device)
    cnt_in.scatter_add_(0, d * block + dst[d, t, w], one)
    return mask, cnt.reshape(S, S, block), cnt_in.reshape(S, block)


def with_node_liveness(sg: ShardedGraph, alive, *,
                       comm=DEFAULT_COMM) -> ShardedGraph:
    """Apply a liveness mask (False = failed), global ``[S*block]`` or
    ``[S, block]``: an edge survives iff both endpoints do (the mirror of
    ``sim/failures.with_node_liveness``; the reference's ``_remask_body``).

    The source block of bucket ``t`` is the one resident after ``t`` ring
    rotations, so each step's source liveness is collected with ``S``
    forward hops through the comm seam, as the propagation moves blocks.
    Out-degree counts are made per bucket on the receiver's shard and
    carried back to the sender's shard by a Horner fold of ``S - 1``
    reverse hops (``shift_back``): ``out[s] = sum_t cnt[(s + t) mod S, t]``.
    The segment buckets, the dynamic region, the MXU layout, the diagonal
    pieces and the neighbor table are re-masked; shapes are unchanged, and
    ``mxu_extent`` stays valid (masking only removes slots)."""
    S, B = sg.n_shards, sg.block
    alive = torch.as_tensor(alive, device=sg.device).reshape(S, B)
    comm_obj = _make_ring_comm(comm, DEFAULT_AXIS, S, sg.device)
    nm = sg.node_mask & alive
    rot, masks = nm, []
    for _ in range(S):  # masks[t]: liveness of the block resident at step t
        masks.append(rot)
        rot = comm_obj.shift(rot)
    masks_by_t = torch.stack(masks, dim=1)  # [S (shard), S (step), B]

    bkt_mask, cnt, in_degree = _remask_group(
        masks_by_t, nm, sg.bkt_src, sg.bkt_dst, sg.bkt_mask, B)
    dyn_mask = sg.dyn_mask
    if sg.dyn_capacity:
        dyn_mask, cnt_d, in_d = _remask_group(
            masks_by_t, nm, sg.dyn_src, sg.dyn_dst, sg.dyn_mask, B)
        cnt, in_degree = cnt + cnt_d, in_degree + in_d
    out_degree = cnt[:, S - 1].contiguous()  # a hop's payload is dense
    for t in range(S - 2, -1, -1):
        out_degree = cnt[:, t] + comm_obj.shift_back(out_degree)

    mxu_mask = sg.mxu_mask
    if mxu_mask is not None:
        # Sources by ring-step liveness, destinations by the local
        # mxu_block layout (sim/failures' blocked re-mask).
        _, _, nb, w = sg.mxu_src.shape
        src_alive = masks_by_t.gather(
            2, sg.mxu_src.reshape(S, S, nb * w).long()).reshape(
                sg.mxu_src.shape)
        rows = torch.arange(nb, dtype=torch.int32, device=sg.device)
        gd = torch.clamp(rows[:, None] * sg.mxu_block + sg.mxu_dst,
                         max=B - 1)
        dst_alive = nm.gather(1, gd.reshape(S, -1).long()).reshape(gd.shape)
        mxu_mask = mxu_mask & src_alive & dst_alive

    diag_masks = sg.diag_masks
    if sg.diag_pieces:
        # A piece edge u -> v needs v alive and u, which sits at local
        # (j + r) % B of the block resident at the piece's ring step.
        diag_masks = torch.stack(
            [sg.diag_masks[:, pi] & nm
             & torch.roll(masks_by_t[:, tp], -r, dims=1)
             for pi, (tp, r) in enumerate(sg.diag_pieces)], dim=1)

    neighbors_mask = sg.neighbors_mask
    if neighbors_mask is not None:
        # Global neighbor ids: with every shard on the card, a partner's
        # liveness is read at its global position (the reference reads the
        # same bit from the collected ring blocks).
        flat = nm.reshape(-1)
        neighbors_mask = (neighbors_mask & nm[..., None]
                          & flat[sg.neighbors.long()])
    return dataclasses.replace(
        sg, bkt_mask=bkt_mask, node_mask=nm, out_degree=out_degree,
        in_degree=in_degree, dyn_mask=dyn_mask, mxu_mask=mxu_mask,
        diag_masks=diag_masks, neighbors_mask=neighbors_mask)


def _check_ids(sg: ShardedGraph, *arrays) -> None:
    for a in arrays:
        if a.size and (a.min() < 0 or a.max() >= sg.n_nodes_padded):
            raise ValueError(
                f"node id out of range [0, {sg.n_nodes_padded})")


def fail_nodes(sg: ShardedGraph, node_ids) -> ShardedGraph:
    """Fail-stop the given global node ids (the mirror of
    ``sim/failures.fail_nodes``)."""
    ids = np.asarray(node_ids, dtype=np.int64).reshape(-1)
    _check_ids(sg, ids)
    alive = torch.ones(sg.n_nodes_padded, dtype=torch.bool, device=sg.device)
    alive[torch.from_numpy(ids).to(sg.device)] = False
    return with_node_liveness(sg, alive)


def random_node_failures(sg: ShardedGraph, key, frac: float) -> ShardedGraph:
    """Fail each live node independently with probability ``frac``. The
    draw covers the whole padded population, so when ``S*block`` equals
    the graph's padded size the failure set is the single-device
    ``sim/failures.random_node_failures``'s for the same key."""
    fail = prng.bernoulli(key, frac, (sg.n_nodes_padded,),
                          device=sg.device).reshape(sg.n_shards, sg.block)
    return with_node_liveness(sg, ~(fail & sg.node_mask))


def _queries(sg: ShardedGraph, s: np.ndarray, r: np.ndarray):
    """Each directed pair's bucket: ``(d, t, local sender, local
    receiver)`` as int64 arrays."""
    S, B = sg.n_shards, sg.block
    d = r // B
    return d, (d - s // B) % S, s % B, r % B


#: Slots compared at once by the existence probe of :func:`connect`.
_PROBE_SLOTS = 1 << 25


def _in_buckets(src, dst, mask, d, t, sl, rl) -> torch.Tensor:
    """bool[Q]: whether each query's pair ``(sl, rl)`` is a live slot of
    its bucket ``(d, t)`` of ``[S, S, W]`` arrays, in chunks of queries."""
    w = src.shape[-1]
    out = torch.zeros(d.numel(), dtype=torch.bool, device=src.device)
    if not w:
        return out
    step = max(1, _PROBE_SLOTS // w)
    for lo in range(0, d.numel(), step):
        q = slice(lo, lo + step)
        hit = ((src[d[q], t[q]] == sl[q, None])
               & (dst[d[q], t[q]] == rl[q, None]) & mask[d[q], t[q]])
        out[q] = hit.any(dim=1)
    return out


def connect(sg: ShardedGraph, senders, receivers, *,
            undirected: bool = True) -> ShardedGraph:
    """Add links between global node ids at runtime (the mirror of
    ``sim/topology.connect``).

    Each new directed edge lands in its (dst-shard, ring-step) dynamic
    bucket. Duplicates within the batch (the first wins), pairs with a
    dead endpoint and pairs that already exist, static or dynamic, are
    dropped. The existence probe and the slot writes run on the device;
    the free slots are chosen on the host from the small ``[S, S, K]``
    occupancy mask, the lowest free slot of each bucket in query order,
    as the reference chooses them."""
    if sg.dyn_src is None:
        raise ValueError(
            "no dynamic edge capacity: reserve slots with "
            "sharded.with_capacity(sg, extra_edges=...) first")
    S, K, dev = sg.n_shards, sg.dyn_capacity, sg.device
    s = np.asarray(senders, np.int64).reshape(-1)
    r = np.asarray(receivers, np.int64).reshape(-1)
    _check_ids(sg, s, r)
    if undirected:
        s, r = np.concatenate([s, r]), np.concatenate([r, s])
    _, first = np.unique(s * np.int64(sg.n_nodes_padded) + r,
                         return_index=True)
    keep = np.zeros(s.size, bool)
    keep[first] = True
    alive = _np(sg.node_mask).reshape(-1)
    keep &= alive[s] & alive[r]

    queries = _queries(sg, s, r)
    q = [torch.from_numpy(a).to(dev) for a in queries]
    exists = (_in_buckets(sg.bkt_src, sg.bkt_dst, sg.bkt_mask, *q)
              | _in_buckets(sg.dyn_src, sg.dyn_dst, sg.dyn_mask, *q))
    keep &= ~_np(exists)
    if not keep.any():
        return sg

    d, t, sl, rl = (a[keep] for a in queries)
    occupied = _np(sg.dyn_mask).copy()
    slots = np.empty(d.size, np.int64)
    for i in range(d.size):
        free = np.flatnonzero(~occupied[d[i], t[i]])
        if not free.size:
            raise ValueError(
                f"dynamic bucket ({d[i]}, {t[i]}) full ({K} slots); "
                f"re-shard via shard_graph (consolidation) or reserve more "
                f"via with_capacity")
        slots[i] = free[0]
        occupied[d[i], t[i], free[0]] = True

    d, t, k, sl, rl = (torch.from_numpy(a).to(dev)
                       for a in (d, t, slots, sl, rl))
    dyn_src, dyn_dst, dyn_mask = (x.clone() for x in (
        sg.dyn_src, sg.dyn_dst, sg.dyn_mask))
    dyn_src[d, t, k] = sl.to(torch.int32)
    dyn_dst[d, t, k] = rl.to(torch.int32)
    dyn_mask[d, t, k] = True
    one = torch.ones(d.numel(), dtype=torch.int32, device=dev)
    out_degree = sg.out_degree.index_put(((d - t) % S, sl), one,
                                         accumulate=True)
    in_degree = sg.in_degree.index_put((d, rl), one, accumulate=True)
    return dataclasses.replace(sg, dyn_src=dyn_src, dyn_dst=dyn_dst,
                               dyn_mask=dyn_mask, out_degree=out_degree,
                               in_degree=in_degree)


def disconnect(sg: ShardedGraph, senders, receivers, *,
               undirected: bool = True) -> ShardedGraph:
    """Remove runtime links, matched by endpoint pair (static edges are
    removed with :func:`fail_nodes` or a re-shard). A pair listed twice
    is removed once."""
    if sg.dyn_src is None:
        raise ValueError("graph has no dynamic edge region")
    S, dev = sg.n_shards, sg.device
    s = np.asarray(senders, np.int64).reshape(-1)
    r = np.asarray(receivers, np.int64).reshape(-1)
    if undirected:
        s, r = np.concatenate([s, r]), np.concatenate([r, s])
    _, first = np.unique(s * np.int64(sg.n_nodes_padded) + r,
                         return_index=True)
    s, r = s[np.sort(first)], r[np.sort(first)]
    d, t, sl, rl = (torch.from_numpy(a).to(dev) for a in _queries(sg, s, r))
    hit = ((sg.dyn_src[d, t] == sl[:, None].to(torch.int32))
           & (sg.dyn_dst[d, t] == rl[:, None].to(torch.int32))
           & sg.dyn_mask[d, t])  # [Q, K]
    cleared = torch.zeros(sg.dyn_mask.shape, dtype=torch.int32, device=dev)
    cleared.index_put_((d, t), hit.to(torch.int32), accumulate=True)
    removed = hit.any(dim=1).to(torch.int32)
    return dataclasses.replace(
        sg, dyn_mask=sg.dyn_mask & (cleared == 0),
        out_degree=sg.out_degree.index_put(((d - t) % S, sl), -removed,
                                           accumulate=True),
        in_degree=sg.in_degree.index_put((d, rl), -removed,
                                         accumulate=True))


def topology_state(sg: ShardedGraph) -> dict:
    """The sharded graph's runtime-mutable tensors as a checkpointable
    dict (the mirror of ``sim/checkpoint.topology_state``), under the
    reference's keys."""
    ts = {"bkt_mask": sg.bkt_mask, "node_mask": sg.node_mask,
          "out_degree": sg.out_degree, "in_degree": sg.in_degree}
    if sg.dyn_src is not None:
        ts.update(dyn_src=sg.dyn_src, dyn_dst=sg.dyn_dst,
                  dyn_mask=sg.dyn_mask)
    if sg.neighbors_mask is not None:
        ts["neighbors_mask"] = sg.neighbors_mask
    if sg.mxu_mask is not None:
        ts["mxu_mask"] = sg.mxu_mask
    if sg.diag_masks is not None:
        ts["diag_masks"] = sg.diag_masks
    return ts


def apply_topology_state(sg: ShardedGraph, ts: dict) -> ShardedGraph:
    """Re-apply a :func:`topology_state` onto a structurally equal sharded
    graph (the same shard count, capacity, layout and neighbor table)."""
    expected = set(topology_state(sg))
    if expected != set(ts):
        raise ValueError(
            f"sharded topology state keys mismatch: checkpoint has "
            f"{sorted(ts)}, graph expects {sorted(expected)} — shard the "
            f"same construction (capacity, neighbor table) it came from")
    kw = {}
    for name in sorted(expected):
        cur = getattr(sg, name)
        if tuple(np.shape(ts[name])) != tuple(cur.shape):
            raise ValueError(
                f"sharded topology state mismatch for {name!r}: saved shape "
                f"{tuple(np.shape(ts[name]))}, graph has {tuple(cur.shape)}")
        v = ts[name]
        v = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v))
        kw[name] = v.to(device=sg.device, dtype=cur.dtype)
    return dataclasses.replace(sg, **kw)


# --------------------------------------------------------------- ring pass


def _ring_pass_unrolled(S, rot, groups, diag, acc0, combine, comm):
    """The ring with diagonal pieces: each piece applies at its STATIC
    ring step with its STATIC shift, inside its step, so sums fold in the
    reference's order (the static group, the dynamic group, the pieces).
    The hop is issued before the step's applies."""
    pieces, masks, apply_diag = diag
    wants_step = getattr(comm, "wants_step", False)
    acc = acc0
    for t in range(S):
        if wants_step and t < S - 1:
            comm.set_context(step=t)
        rot_next = comm.shift(rot) if t < S - 1 else rot
        for fn, *arrs in groups:
            acc = combine(acc, fn(rot, *(a[:, t] for a in arrs)))
        for pi, (tp, r) in enumerate(pieces):
            if tp == t:
                acc = combine(acc, apply_diag(rot, r, masks[:, pi]))
        rot = rot_next
    return acc


def _diag_or_piece(rot, r, mask):
    """out[d, j] |= rot[d, (j + r) % B] & mask[d, j] — a static shift."""
    return torch.roll(rot, -r, dims=1) & mask


def _diag_sum_piece(rot, r, mask):
    return torch.roll(rot, -r, dims=1) * mask.to(rot.dtype)


def _diag_max_piece(rot, r, mask):
    return torch.where(mask, torch.roll(rot, -r, dims=1),
                       neutral_min(rot.dtype))


def _diag_minplus_piece(rot, r, mask):
    return torch.where(mask, torch.roll(rot, -r, dims=1) + 1.0, torch.inf)


def _ring_pass(S, frontier, groups, acc0, combine, diag, comm: _RingComm):
    """One full ring rotation of the stacked ``frontier [S, B]``.
    ``groups`` are ``(apply_fn, *arrays)`` bucket groups, every array
    ``[S, S, ...]`` with the ring step on axis 1: the static group (the
    dst-sorted segment buckets or the MXU layout), then the dynamic
    region's unsorted buckets when the graph has one. At step ``t`` each
    group's bucket ``[:, t]`` consumes the resident block and ``combine``
    folds it in.

    The hop is issued before the step's applies. When the static group is
    the MXU layout and the backend fuses, hop and segment sum are one
    launch (kernel B3), and the dynamic bucket, which B3 does not see, is
    applied after it on the same resident block. The last bucket is
    peeled: nothing is left to rotate after it, so a pass makes ``S - 1``
    hops. A comm that keys faults on the ring step (``wants_step``) is
    told the step before each hop."""
    if diag[0]:
        return _ring_pass_unrolled(S, frontier, groups, diag, acc0, combine,
                                   comm)
    # The MXU group's fused form: (kind, post, kernel block, row extents).
    fused = getattr(groups[0][0], "fused", None) if comm.fuses else None
    wants_step = getattr(comm, "wants_step", False)

    def apply_all(acc, rot, t, skip_first=False):
        for fn, *arrs in groups[int(skip_first):]:
            acc = combine(acc, fn(rot, *(a[:, t] for a in arrs)))
        return acc

    rot, acc = frontier, acc0
    for t in range(S - 1):
        if wants_step:
            comm.set_context(step=t)
        if fused is not None:
            kind, post, kblock, extent = fused
            rot_next, out = comm.fused_segment_sum(
                rot, kind, *(a[:, t] for a in groups[0][1:]), kblock,
                None if extent is None else extent[:, t])
            acc = apply_all(combine(acc, post(out)), rot, t, skip_first=True)
        else:
            rot_next = comm.shift(rot)
            acc = apply_all(acc, rot, t)
        rot = rot_next
    return apply_all(acc, rot, S - 1)


def neutral_min(dtype: torch.dtype):
    """The max-aggregation identity for ``dtype`` (-inf / int min), as a
    Python number."""
    if dtype.is_floating_point:
        return -torch.inf
    if dtype == torch.bool:
        raise ValueError(
            "max-aggregation over bool signals is just OR — use "
            "propagate(op='or') instead")
    return torch.iinfo(dtype).min


def _bucket_reduce(block, fill, contrib, dst, reduce):
    """``[S, block]`` per-shard reduction of ``contrib [S, E]`` into
    ``dst``, starting from ``fill``: ``"sum"`` by ``scatter_add_``, else
    ``scatter_reduce_`` with ``reduce``."""
    out = torch.full((contrib.shape[0], block), fill, dtype=contrib.dtype,
                     device=contrib.device)
    if reduce == "sum":
        return out.scatter_add_(1, dst.long(), contrib)
    return out.scatter_reduce_(1, dst.long(), contrib, reduce)


def _bucket_or(block):
    def apply(rot, src, dst, m):
        contrib = (rot.gather(1, src.long()) & m).to(torch.int32)
        return _bucket_reduce(block, 0, contrib, dst, "amax") > 0

    return apply


def _bucket_sum(block):
    def apply(rot, src, dst, m):
        contrib = rot.gather(1, src.long()) * m.to(rot.dtype)
        return _bucket_reduce(block, 0, contrib, dst, "sum")

    return apply


def _bucket_max(block):
    def apply(rot, src, dst, m):
        low = neutral_min(rot.dtype)
        contrib = torch.where(m, rot.gather(1, src.long()), low)
        return _bucket_reduce(block, low, contrib, dst, "amax")

    return apply


def _bucket_minplus(block):
    """Unit-hop min-plus: ``out[v] = min(rot[u] + 1)`` over the bucket's
    live edges (the ring layouts carry no weight channel)."""

    def apply(rot, src, dst, m):
        contrib = torch.where(m, rot.gather(1, src.long()) + 1.0, torch.inf)
        return _bucket_reduce(block, torch.inf, contrib, dst, "amin")

    return apply


def _bucket_mxu(kind, block, mxu_block, extent):
    """Bucket OR (``kind="or"``) or sum through the segment-sum kernel B1
    on all shards in one launch; ``apply.fused`` is the form the fusing
    backend hands to kernel B3 (same reduction, the hop in the launch,
    rows read up to their ``extent [S, S, NB]``)."""
    kernel = segsum.segsum_or if kind == "or" else segsum.segsum_sum

    def post(out):  # [S, NB * mxu_block] -> the block's [S, block]
        return out[:, :block]

    def apply(rot, src, dst, m):  # rot [S, B]; src/dst/m [S, NB, W]
        return post(kernel(rot, src, dst, m, mxu_block))

    apply.fused = (kind, post, mxu_block, extent)
    return apply


def _groups(sg: ShardedGraph, kind: str):
    """The reference's ``_groups_or``/``_groups_sum``: the static group —
    the MXU layout when present, else the segment buckets, never both,
    since the segment buckets hold every edge — then the dynamic region's
    buckets when the graph has a region. The segment appliers do not rely
    on sorted destinations, so one applier serves both groups."""
    bucket = _bucket_or if kind == "or" else _bucket_sum
    if sg.mxu_src is not None:
        static = (_bucket_mxu(kind, sg.block, sg.mxu_block, sg.mxu_extent),
                  sg.mxu_src, sg.mxu_dst, sg.mxu_mask)
    else:
        static = (bucket(sg.block), sg.bkt_src, sg.bkt_dst, sg.bkt_mask)
    return [static] + _dyn_groups(sg, bucket)


def _dyn_groups(sg: ShardedGraph, bucket):
    """The dynamic region's group, or none (no region, or no capacity)."""
    if not sg.dyn_capacity:
        return []
    return [(bucket(sg.block), sg.dyn_src, sg.dyn_dst, sg.dyn_mask)]


def _make_pass(sg: ShardedGraph, comm, op: str, axis_name: str):
    """``pass_(x) -> [S, block]``: one ring rotation aggregating ``x`` over
    every incoming edge with ``op`` (the reference's ``_make_or_pass``,
    ``_make_sum_pass``, ``_make_max_pass``, ``_make_minplus_pass``).
    ``pass_.comm`` is the ring's comm object."""
    S, block = sg.n_shards, sg.block
    comm_obj = _make_ring_comm(comm, axis_name, S, sg.device)
    if op in ("or", "sum"):
        groups = _groups(sg, op)
    else:  # segment buckets only: a one-hot product computes sums
        bucket = _bucket_max if op == "max" else _bucket_minplus
        groups = [(bucket(block), sg.bkt_src, sg.bkt_dst, sg.bkt_mask)] \
            + _dyn_groups(sg, bucket)
    piece = {"or": _diag_or_piece, "sum": _diag_sum_piece,
             "max": _diag_max_piece, "minplus": _diag_minplus_piece}[op]
    diag = (sg.diag_pieces, sg.diag_masks, piece)

    def acc0(x):
        fill = neutral_min(x.dtype) if op == "max" else (
            torch.inf if op == "minplus" else 0)
        return torch.full((S, block), fill, dtype=x.dtype, device=x.device)

    combine = {"or": torch.logical_or, "sum": torch.add,
               "max": torch.maximum, "minplus": torch.minimum}[op]

    def pass_(x):
        return _ring_pass(S, x, groups, acc0(x), combine, diag, comm_obj)

    pass_.comm = comm_obj
    return pass_


# -------------------------------------------------------------------- flood


def _flood_seed(sg: ShardedGraph, source: int) -> torch.Tensor:
    if not 0 <= source < sg.n_nodes_padded:
        raise ValueError(f"source {source} is outside the graph's "
                         f"{sg.n_nodes_padded} padded nodes")
    seed = torch.zeros((sg.n_shards, sg.block), dtype=torch.bool,
                       device=sg.device)
    seed[source // sg.block, source % sg.block] = True
    return seed & sg.node_mask  # a dead source seeds nothing


def init_state(sg: ShardedGraph, protocol, key=None):
    """The sharded initial state of a protocol, ``[S, block]``: Flood ->
    ``(seen, frontier)``. The other protocols are not ported yet."""
    if isinstance(protocol, Flood):
        seed = _flood_seed(sg, protocol.source)
        return (seed, seed)
    raise NotImplementedError(
        f"the port's sharded path implements Flood; got "
        f"{type(protocol).__name__}")


@dataclasses.dataclass(frozen=True)
class _RingFlood:
    """Flood's round on the ring, as a protocol of the port's engine: the
    same stats as ``models/flood.Flood`` (messages, f32 live coverage and
    occupancy), computed over the stacked ``[S, block]`` state.

    With ``round0`` set (a fault-spec comm under
    :func:`flood_until_coverage`), each step tells the comm its global
    round ``round0 + r``, ``r`` counting this run's steps (the loop
    takes one step per round)."""

    pass_: object
    round0: Optional[int] = None
    _steps: list = dataclasses.field(default_factory=lambda: [0])

    STATS = ("messages", "coverage", "frontier", "frontier_occupancy")

    def coverage(self, sg, state: FloodState) -> torch.Tensor:
        return live_coverage(sg, state.seen)

    def step(self, sg, state: FloodState, key):
        if self.round0 is not None:
            self.pass_.comm.set_context(round=self.round0 + self._steps[0])
            self._steps[0] += 1
        delivered = self.pass_(state.frontier)
        new = delivered & ~state.seen & sg.node_mask
        seen = state.seen | new
        stats = {
            "messages": segment.frontier_messages(sg, state.frontier),
            "coverage": live_coverage(sg, seen),
            "frontier": new.sum(),
            "frontier_occupancy": F.occupancy(sg, new),
        }
        return FloodState(seen=seen, frontier=new), stats


def _check_mesh(sg: ShardedGraph, mesh: RingMesh) -> None:
    if mesh.n_shards != sg.n_shards:
        raise ValueError(f"the graph is sharded {sg.n_shards} ways, the "
                         f"mesh has {mesh.n_shards} shards")


def _flood_start(sg, mesh, source, state0, comm, fault_round0=None):
    _check_mesh(sg, mesh)
    pass_ = _make_pass(sg, comm, "or", mesh.axis_name)
    wire = fault_round0 is not None and getattr(pass_.comm, "wants_step",
                                                False)
    proto = _RingFlood(pass_, int(fault_round0) if wire else None)
    seen0, frontier0 = state0 if state0 is not None \
        else init_state(sg, Flood(source=source))
    return proto, FloodState(seen=seen0, frontier=frontier0)


def flood(sg: ShardedGraph, mesh: RingMesh, source: int, rounds: int,
          state0=None, return_state: bool = False, comm=DEFAULT_COMM):
    """Run ``rounds`` of single-source flood on the ring.

    Returns ``(seen [S, block] bool, stats)`` with ``stats`` per-round
    ``messages`` (i64) and ``coverage`` (f32) tensors of length
    ``rounds``. ``state0 = (seen, frontier)`` resumes a run (``source`` is
    then ignored); ``return_state=True`` returns ``((seen, frontier),
    stats)``."""
    proto, state = _flood_start(sg, mesh, source, state0, comm)
    msgs, cov = [], []
    for _ in range(rounds):
        state, stats = proto.step(sg, state, None)  # the flood draws nothing
        msgs.append(stats["messages"])
        cov.append(stats["coverage"])
    empty = torch.zeros(0, device=sg.device)
    stats = {"messages": torch.stack(msgs) if msgs else empty.long(),
             "coverage": torch.stack(cov) if cov else empty}
    if return_state:
        return (state.seen, state.frontier), stats
    return state.seen, stats


def _record_comm_faults(comm, rounds: int, S: int, *,
                        round0: int = 0) -> None:
    """After a fault-spec run: count the faults the executed round window
    hit into ``chaos_device_faults_total{kind}`` (a host replay of the
    schedule). No-op for backend names, empty schedules, hop-free rings
    (S == 1) and zero-round runs."""
    if isinstance(comm, str) or S <= 1 or not rounds:
        return
    schedule = getattr(comm, "schedule", None)
    if schedule is None or not schedule.active:
        return
    from p2pnetwork_tpu_torch.chaos import device as chaos_device

    chaos_device.record_faults(schedule, rounds=int(rounds),
                               n_steps=S - 1, n_shards=S,
                               round0=int(round0))


def flood_until_coverage(sg: ShardedGraph, mesh: RingMesh, source: int, *,
                         coverage_target: float = 0.99,
                         max_rounds: int = 1024, state0=None,
                         return_state: bool = False, adaptive_k: int = 0,
                         comm=DEFAULT_COMM, recorder=None,
                         fault_round0: int = 0):
    """Flood until the live coverage reaches ``coverage_target`` (or
    ``max_rounds``): the dense ring loop, run by the port's engine
    (``sim/engine.py``), so the summary's arithmetic is slice 1's.

    Returns ``(seen [S, block], dict(rounds, coverage, messages,
    frontier_occupancy_mean))`` — the reference's dict, ``messages`` an
    exact int. ``state0``/``return_state`` as in :func:`flood`.
    ``adaptive_k > 0`` and ``recorder`` are not ported yet.

    ``comm`` also takes a ``chaos/device.FaultSpec``: the ring runs on its
    backend with its schedule's faults injected at the halo hops, keyed
    on the global round ``fault_round0 + r`` (a chunked or resumed driver
    passes ``fault_round0`` so each chunk hits the sites an unchunked run
    would), and the faults the executed rounds hit are counted into
    ``chaos_device_faults_total{kind}`` after the run."""
    if adaptive_k > 0:
        raise NotImplementedError(
            "the frontier-adaptive ring loop (adaptive_k > 0) is not ported "
            "yet")
    if recorder is not None:
        raise NotImplementedError(
            "the ring's flight recorder (its ici_bytes column) is not "
            "ported yet")
    proto, state = _flood_start(sg, mesh, source, state0, comm,
                                fault_round0)
    # The flood draws nothing; the engine's key chain runs unread.
    state, out = engine.run_until_coverage_from(
        sg, proto, state, prng.key(0), coverage_target=coverage_target,
        max_rounds=max_rounds)
    _record_comm_faults(comm, out["rounds"], sg.n_shards,
                        round0=fault_round0)
    if return_state:
        return (state.seen, state.frontier), out
    return state.seen, out


# ------------------------------------------- generic value propagation


def propagate(sg: ShardedGraph, mesh: RingMesh, signal: torch.Tensor,
              op: str = "sum", comm=DEFAULT_COMM) -> torch.Tensor:
    """One aggregation pass over every edge of the sharded graph.

    ``signal`` is ``[S, block]`` (bool for ``op="or"``, float for
    ``"sum"``, float/int for ``"max"``, f32 distances for ``"minplus"``);
    returns the per-node aggregate in that layout, masked to live nodes
    (``max`` to the dtype's -inf/int-min identity, ``minplus`` to
    ``+inf``). ``max`` and ``minplus`` need the segment layout: a graph
    sharded with ``mxu``/``hybrid`` is refused, as in the reference."""
    if op not in ("or", "sum", "max", "minplus"):
        raise ValueError(
            f"op must be 'or', 'sum', 'max' or 'minplus', got {op!r}")
    if op in ("max", "minplus") and sg.mxu_src is not None:
        raise ValueError(
            f"op={op!r} cannot ride the MXU one-hot layout — shard_graph "
            "without hybrid/min_count for max/min-aggregating protocols")
    _check_mesh(sg, mesh)
    out = _make_pass(sg, comm, op, mesh.axis_name)(signal)
    if op == "or":
        return out & sg.node_mask
    if op == "max":
        return torch.where(sg.node_mask, out, neutral_min(out.dtype))
    if op == "minplus":
        return torch.where(sg.node_mask, out, torch.inf)
    return out * sg.node_mask.to(out.dtype)
