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
not depend on the backend, as in the reference.

Ported: :func:`shard_graph` (``mxu``, ``hybrid``), :func:`flood`,
:func:`flood_until_coverage` (dense loop) and :func:`propagate` (``or``,
``sum``, ``max``, ``minplus``). Not yet: the dynamic edge region, the
sender-CSR view and the frontier-adaptive loop, liveness re-masking, the
flight recorder, fault-spec comms and the other ring protocols.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from p2pnetwork_tpu_torch.models.flood import Flood, FloodState, live_coverage
from p2pnetwork_tpu_torch.ops import blocked as B
from p2pnetwork_tpu_torch.ops import frontier as F
from p2pnetwork_tpu_torch.ops import ring, segment, segsum
from p2pnetwork_tpu_torch.ops.diag import select_diagonals
from p2pnetwork_tpu_torch.parallel.auto import COMM_BACKENDS, resolve_comm
from p2pnetwork_tpu_torch.parallel.mesh import RingMesh
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

    def fused_segment_sum(self, rot, kind, src, local_dst, mask, block):
        """``(rot_next, out)`` — the hop fused with the segment sum of the
        step's MXU bucket (``kind`` "or" or "sum"), or None when this
        backend has no fused form (the caller then shifts and applies
        separately)."""
        if self.backend != "pallas":
            return None
        self._check_payload(rot, "shift")
        fn = ring.ring_segment_sum_or if kind == "or" \
            else ring.ring_segment_sum_sum
        return fn(rot, src, local_dst, mask, block)


def _comm_name(comm, device) -> str:
    if not isinstance(comm, str):
        raise NotImplementedError(
            "fault-spec comms are not ported yet; pass a backend name")
    return resolve_comm(comm, device)


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
    ``diag_pieces``/``diag_masks``. The dynamic region (``dyn_*``), the
    neighbor table and the sender-CSR view are not ported and stay None.
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
    view of the frontier-adaptive loop) is not ported yet. The port's
    ``Graph`` carries no dynamic edge region (``interop`` refuses one), so
    there are no runtime links to fold in."""
    if source_csr:
        raise NotImplementedError(
            "shard_graph(source_csr=True) is not ported yet")
    S = mesh.n_shards
    emask = _np(graph.edge_mask)
    senders = _np(graph.senders)[emask]
    receivers = _np(graph.receivers)[emask]
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

    def on(a):
        return None if a is None else torch.from_numpy(a).to(mesh.device)

    mxu_src, mxu_dst, mxu_mask = map(on, mxu_arrays or (None,) * 3)
    return ShardedGraph(
        bkt_src=on(bkt_src), bkt_dst=on(bkt_dst), bkt_mask=on(bkt_mask),
        node_mask=on(per_node(graph.node_mask)),
        out_degree=on(per_node(graph.out_degree)),
        in_degree=on(per_node(graph.in_degree)),
        n_nodes=graph.n_nodes, n_shards=S, block=block,
        mxu_src=mxu_src, mxu_dst=mxu_dst, mxu_mask=mxu_mask,
        diag_masks=on(diag_masks), diag_pieces=diag_pieces,
        mxu_block=mxu_block)


# --------------------------------------------------------------- ring pass


def _ring_pass_unrolled(S, rot, group, diag, acc0, combine, comm):
    """The ring with diagonal pieces: each piece applies at its STATIC
    ring step with its STATIC shift, inside its step, so sums fold in the
    reference's order. The hop is issued before the step's applies."""
    fn, *arrs = group
    pieces, masks, apply_diag = diag
    acc = acc0
    for t in range(S):
        rot_next = comm.shift(rot) if t < S - 1 else rot
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


def _ring_pass(S, frontier, group, acc0, combine, diag, comm: _RingComm):
    """One full ring rotation of the stacked ``frontier [S, B]``.
    ``group`` is ``(apply_fn, *arrays)``, every array ``[S, S, ...]`` with
    the ring step on axis 1; at step ``t`` bucket ``[:, t]`` consumes the
    resident block and ``combine`` folds it in. (The reference also folds
    in a dynamic-region group, which the port does not have.)

    The hop is issued before the step's apply. When the group is the MXU
    layout and the backend fuses, hop and segment sum are one launch
    (kernel B3). The last bucket is peeled: nothing is left to rotate
    after it, so a pass makes ``S - 1`` hops."""
    if diag[0]:
        return _ring_pass_unrolled(S, frontier, group, diag, acc0, combine,
                                   comm)
    fn, *arrs = group
    # The MXU group's fused form: (kind, post, kernel block).
    fused = getattr(fn, "fused", None) if comm.fuses else None
    rot, acc = frontier, acc0
    for t in range(S - 1):
        bucket = [a[:, t] for a in arrs]
        if fused is not None:
            kind, post, kblock = fused
            rot_next, out = comm.fused_segment_sum(rot, kind, *bucket,
                                                   kblock)
            acc = combine(acc, post(out))
        else:
            rot_next = comm.shift(rot)
            acc = combine(acc, fn(rot, *bucket))
        rot = rot_next
    return combine(acc, fn(rot, *(a[:, S - 1] for a in arrs)))


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


def _bucket_mxu(kind, block, mxu_block):
    """Bucket OR (``kind="or"``) or sum through the segment-sum kernel B1
    on all shards in one launch; ``apply.fused`` is the form the fusing
    backend hands to kernel B3 (same reduction, the hop in the launch)."""
    kernel = segsum.segsum_or if kind == "or" else segsum.segsum_sum

    def post(out):  # [S, NB * mxu_block] -> the block's [S, block]
        return out[:, :block]

    def apply(rot, src, dst, m):  # rot [S, B]; src/dst/m [S, NB, W]
        return post(kernel(rot, src, dst, m, mxu_block))

    apply.fused = (kind, post, mxu_block)
    return apply


def _static_group(sg: ShardedGraph, kind: str):
    """The reference's ``_groups_or``/``_groups_sum``: the MXU layout when
    present, else the segment buckets — never both, since the segment
    buckets hold every edge."""
    if sg.mxu_src is not None:
        return (_bucket_mxu(kind, sg.block, sg.mxu_block), sg.mxu_src,
                sg.mxu_dst, sg.mxu_mask)
    bucket = _bucket_or if kind == "or" else _bucket_sum
    return (bucket(sg.block), sg.bkt_src, sg.bkt_dst, sg.bkt_mask)


def _make_pass(sg: ShardedGraph, comm: str, op: str):
    """``pass_(x) -> [S, block]``: one ring rotation aggregating ``x`` over
    every incoming edge with ``op`` (the reference's ``_make_or_pass``,
    ``_make_sum_pass``, ``_make_max_pass``, ``_make_minplus_pass``)."""
    S, block = sg.n_shards, sg.block
    comm_obj = _RingComm(comm, S)
    if op in ("or", "sum"):
        group = _static_group(sg, op)
    else:  # segment buckets only: a one-hot product computes sums
        bucket = _bucket_max if op == "max" else _bucket_minplus
        group = (bucket(block), sg.bkt_src, sg.bkt_dst, sg.bkt_mask)
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
        return _ring_pass(S, x, group, acc0(x), combine, diag, comm_obj)

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
    occupancy), computed over the stacked ``[S, block]`` state."""

    pass_: object

    STATS = ("messages", "coverage", "frontier", "frontier_occupancy")

    def coverage(self, sg, state: FloodState) -> torch.Tensor:
        return live_coverage(sg, state.seen)

    def step(self, sg, state: FloodState):
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


def _flood_start(sg, mesh, source, state0, comm):
    _check_mesh(sg, mesh)
    proto = _RingFlood(_make_pass(sg, _comm_name(comm, sg.device), "or"))
    seen0, frontier0 = state0 if state0 is not None \
        else init_state(sg, Flood(source=source))
    return proto, FloodState(seen=seen0, frontier=frontier0)


def flood(sg: ShardedGraph, mesh: RingMesh, source: int, rounds: int,
          state0=None, return_state: bool = False, comm: str = DEFAULT_COMM):
    """Run ``rounds`` of single-source flood on the ring.

    Returns ``(seen [S, block] bool, stats)`` with ``stats`` per-round
    ``messages`` (i64) and ``coverage`` (f32) tensors of length
    ``rounds``. ``state0 = (seen, frontier)`` resumes a run (``source`` is
    then ignored); ``return_state=True`` returns ``((seen, frontier),
    stats)``."""
    proto, state = _flood_start(sg, mesh, source, state0, comm)
    msgs, cov = [], []
    for _ in range(rounds):
        state, stats = proto.step(sg, state)
        msgs.append(stats["messages"])
        cov.append(stats["coverage"])
    empty = torch.zeros(0, device=sg.device)
    stats = {"messages": torch.stack(msgs) if msgs else empty.long(),
             "coverage": torch.stack(cov) if cov else empty}
    if return_state:
        return (state.seen, state.frontier), stats
    return state.seen, stats


def flood_until_coverage(sg: ShardedGraph, mesh: RingMesh, source: int, *,
                         coverage_target: float = 0.99,
                         max_rounds: int = 1024, state0=None,
                         return_state: bool = False, adaptive_k: int = 0,
                         comm: str = DEFAULT_COMM, recorder=None):
    """Flood until the live coverage reaches ``coverage_target`` (or
    ``max_rounds``): the dense ring loop, run by the port's engine
    (``sim/engine.py``), so the summary's arithmetic is slice 1's.

    Returns ``(seen [S, block], dict(rounds, coverage, messages,
    frontier_occupancy_mean))`` — the reference's dict, ``messages`` an
    exact int. ``state0``/``return_state`` as in :func:`flood`.
    ``adaptive_k > 0`` and ``recorder`` are not ported yet."""
    if adaptive_k > 0:
        raise NotImplementedError(
            "the frontier-adaptive ring loop (adaptive_k > 0) is not ported "
            "yet")
    if recorder is not None:
        raise NotImplementedError("the flight recorder is not ported yet")
    proto, state = _flood_start(sg, mesh, source, state0, comm)
    state, out = engine.run_until_coverage_from(
        sg, proto, state, coverage_target=coverage_target,
        max_rounds=max_rounds)
    if return_state:
        return (state.seen, state.frontier), out
    return state.seen, out


# ------------------------------------------- generic value propagation


def propagate(sg: ShardedGraph, mesh: RingMesh, signal: torch.Tensor,
              op: str = "sum", comm: str = DEFAULT_COMM) -> torch.Tensor:
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
    out = _make_pass(sg, _comm_name(comm, sg.device), op)(signal)
    if op == "or":
        return out & sg.node_mask
    if op == "max":
        return torch.where(sg.node_mask, out, neutral_min(out.dtype))
    if op == "minplus":
        return torch.where(sg.node_mask, out, torch.inf)
    return out * sg.node_mask.to(out.dtype)
