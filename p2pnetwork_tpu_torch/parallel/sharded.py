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

The other protocols run on the same passes: SIR (a sum pass of 0/1
pressure), gossip (each node's pull from its partner's resident block),
PageRank and push-sum (sum passes), hop distance (an OR pass) and leader
election (a max pass of i32 ids), with the single-device models'
arithmetic and ``engine``'s key schedules and loops. Their f32 totals are
the reference's: each shard's block summed in XLA's order, then the
shards left to right (:func:`psum_f32`). The draws are the whole
population's (``exact_rng``), one key a 128-node tile (``"tile"``) or one
a shard (``"fold"``). The walk gathers each walker's out-edges through
the per-shard sender-CSR view; the batched plane moves the lane-word
stack ``[S, W, block]`` as the halo payload.

Small frontiers skip the ring: ``adaptive_k > 0`` on
:func:`flood_until_coverage` and :func:`hopdist_until_coverage` runs the
frontier-adaptive wave (:class:`_AdaptiveWave`), gathering a small
frontier's out-edges through the sender-CSR view and running a ring pass
only when the frontier outgrows ``adaptive_k`` work items on some shard.
The ring's flight recorder (``recorder=``) rides the dense flood and the
lane ring, its ``ici_bytes`` column the reference's per-round byte
estimate (``parallel/commviz.py``).

**Across processes** (``parallel/multihost.py``): on a mesh of ``world``
ranks :func:`shard_graph` keeps the rank's ``S / world`` shards (a
:class:`RankShardedGraph`, ``[n_local, ...]`` on axis 0), the blocks
move through :class:`_RankComm` (the cross-rank kernels of
``ops/ring.py``: a pass reads its rotations from one exchange,
``ring_gather``, and sums the MXU group over every step in one launch,
``ring_pass_segsum_*``; payloads that change from hop to hop, a faulted
hop and the re-mask's reverse fold, hop by ``ring_put``) and every
``psum``/``pmax`` of the reference is a process-group
reduction: a round's totals ride one exchange of per-shard partials
gathered in shard order (:func:`_totals`: counts exact, the f32 totals
added as :func:`psum_f32` adds them, maxima), so every rank holds the
same global stats and the engine's loop takes the same exit on each; the
walk takes the reference's two ``pmax`` a round (``mesh.all_max``). The
rank part keeps the global live count (``RankShardedGraph.live``). Every
ring protocol, the re-mask, the dynamic region, the lane plane, the
frontier-adaptive loop (its replicated frontier list an all-gather of
the ranks' compacted ids in ring order, its item budget a ``pmax``), the
recorder (rows from the round's exchanged totals; the lane ring's
per-word sends and occupancy summed once a run) and a fault-spec comm
(faults keyed on the global shard) run across ranks, bit for bit the
one-process ring. At one rank every path is the one-process ring's.

Ported: :func:`shard_graph` (``mxu``, ``hybrid``, ``source_csr``; a
graph's runtime links folded into the static buckets, its neighbor table
carried), :func:`flood`, :func:`flood_until_coverage` (dense and
frontier-adaptive loops, the recorder),
:func:`propagate` (``or``, ``sum``, ``max``, ``minplus``), the liveness
re-mask (:func:`with_node_liveness`, :func:`fail_nodes`,
:func:`random_node_failures`), the dynamic region,
:func:`topology_state` / :func:`apply_topology_state`, :func:`init_state`
for every ring protocol, :func:`sir`, :func:`gossip`, :func:`pagerank`,
:func:`pushsum`, :func:`hopdist`, their run-to-* loops,
:func:`leader_until_quiet`, :func:`walk`, :func:`walk_until_coverage`,
:func:`propagate_or_lanes` and :func:`run_batch_until_coverage` (with
the recorder). Every ring function of the reference's is ported.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from p2pnetwork_tpu_torch import _device, prng
from p2pnetwork_tpu_torch.chaos import device as chaos_device
from p2pnetwork_tpu_torch.models import sir as sir_model
from p2pnetwork_tpu_torch.models.flood import Flood, FloodState
from p2pnetwork_tpu_torch.models.gossip import Gossip
from p2pnetwork_tpu_torch.models.hopdist import HopDistance
from p2pnetwork_tpu_torch.models.pagerank import PageRank
from p2pnetwork_tpu_torch.models.pushsum import PushSum
from p2pnetwork_tpu_torch.models.sir import SIR
from p2pnetwork_tpu_torch.ops import bitset as BS
from p2pnetwork_tpu_torch.ops import blocked as B
from p2pnetwork_tpu_torch.ops import ring, rowsum, segment, segsum
from p2pnetwork_tpu_torch.ops import threefry as TF
from p2pnetwork_tpu_torch.ops.diag import select_diagonals
from p2pnetwork_tpu_torch.parallel import commviz
from p2pnetwork_tpu_torch.parallel.auto import COMM_BACKENDS, resolve_comm
from p2pnetwork_tpu_torch.parallel.mesh import (DEFAULT_AXIS, RingMesh,
                                                all_max, all_sum,
                                                gather_lists,
                                                gather_shards,
                                                shard_spec)
from p2pnetwork_tpu_torch.sim import engine, flightrec
from p2pnetwork_tpu_torch.sim.graph import _round_up
from p2pnetwork_tpu_torch.telemetry import spans
from p2pnetwork_tpu_torch.utils import accum
from p2pnetwork_tpu_torch.utils.edgehash import edge_uniform

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


class _RankComm(_RingComm):
    """The halo exchange of a ring split over ranks (``mesh.world > 1``).
    A pass rotates a block that stays fixed for the pass, so the passes
    read their rotations from one exchange: :meth:`gather` puts every
    rank's ``[n_local, ...]`` stack into every rank's ``[2S, ...]`` slab,
    :meth:`rows` gives a step's rows, :meth:`pass_segment_sum` the MXU
    group's sums over every step in one launch. ``shift`` and
    ``shift_back`` move one hop (the local shards by a roll, the boundary
    shard to the next or previous rank) for payloads that change from hop
    to hop. ``"pallas"`` runs the cross-rank kernels (``ops/ring.py``:
    ``ring_gather``, ``ring_pass_segsum_*``, ``ring_put``; CUDA IPC peer
    writes on the card), ``"ppermute"`` their plain versions (gloo). No
    hop fuses with a sum here (``fuses`` is False): a comm that wraps
    this one (a fault spec, the hop census) moves the hops one at a time
    and applies each step's buckets apart."""

    __slots__ = ("mesh",)

    def __init__(self, backend: str, mesh: RingMesh):
        super().__init__(backend, mesh.n_shards)
        self.mesh = mesh

    @property
    def fuses(self) -> bool:
        return False

    def shift(self, x):
        self._check_payload(x, "shift")
        if self.backend == "pallas":
            return ring.ring_put(x, self.mesh)
        return ring.ring_put_plain(x, self.mesh)

    def shift_back(self, x):
        self._check_payload(x, "shift_back")
        if self.backend == "pallas":
            return ring.ring_put(x, self.mesh, reverse=True)
        return ring.ring_put_plain(x, self.mesh, reverse=True)

    def fused_segment_sum(self, rot, kind, src, local_dst, mask, block,
                          extent):
        return None

    def gather(self, x):
        """The pass's ``[2S, ...]`` slab of every rank's stack ``x`` (held
        to the forward template: a pass moves one payload)."""
        self._check_payload(x, "shift")
        if self.backend == "pallas":
            return ring.ring_gather(x, self.mesh)
        return ring.ring_gather_plain(x, self.mesh)

    def rows(self, slab, t: int):
        """This rank's rows at ring step ``t`` of the pass, a view."""
        return ring.ring_rows(slab, self.mesh.shard_lo, self.mesh.n_local, t)

    def pass_segment_sum(self, slab, kind, src, local_dst, mask, block,
                         extent):
        """The MXU group's sums over every step of the pass (``kind`` "or"
        or "sum"; the ``[L, S, NB, W]`` buckets, ``extent`` their rows'
        extents or None), ``[L, NB * block]``."""
        if self.backend == "pallas":
            fn = ring.ring_pass_segsum_or if kind == "or" \
                else ring.ring_pass_segsum_sum
            return fn(slab, self.mesh.shard_lo, src, local_dst, mask, block,
                      extent=extent)
        fn = ring.ring_pass_segsum_or_plain if kind == "or" \
            else ring.ring_pass_segsum_sum_plain
        return fn(slab, self.mesh.shard_lo, src, local_dst, mask, block)


def _rank_mesh(obj) -> Optional[RingMesh]:
    """The rank mesh of a ring split over processes: ``obj`` is a
    :class:`RankShardedGraph` or a :class:`RingMesh`; None in one
    process."""
    mesh = obj if isinstance(obj, RingMesh) else getattr(obj, "mesh", None)
    return mesh if mesh is not None and mesh.world > 1 else None


def _make_ring_comm(comm, axis_name: str, sg):
    """One ring's comm object for ``sg``: a backend name (resolved for
    its device) builds the bare :class:`_RingComm`, or the
    :class:`_RankComm` of a ring split over ranks; a spec object (a
    ``chaos/device.FaultSpec``, carrying a concrete backend) builds its
    wrapper, handed the rank mesh on a ring split over ranks."""
    mesh = _rank_mesh(sg)
    if isinstance(comm, str):
        backend = resolve_comm(comm, sg.device)
        if mesh is not None:
            return _RankComm(backend, mesh)
        return _RingComm(backend, sg.n_shards)
    if not callable(getattr(comm, "make", None)):
        raise TypeError(
            f"comm must be a backend name or a spec object with make() "
            f"(chaos/device.FaultSpec), got {type(comm).__name__}")
    if mesh is not None:
        return comm.make(axis_name, sg.n_shards, mesh=mesh)
    return comm.make(axis_name, sg.n_shards)


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
    ``csr_pos``/``csr_offsets``/``csr_span`` (``source_csr=True``) are the
    per-shard sender-CSR view over the segment buckets; it indexes bucket
    slots, so liveness re-masks and runtime links need no rebuild.

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

    @property
    def n_local(self) -> int:
        """Shards held here, on axis 0 of every per-shard tensor."""
        return self.node_mask.shape[0]

    @property
    def shard_lo(self) -> int:
        """The global index of the first shard held here."""
        mesh = getattr(self, "mesh", None)
        return 0 if mesh is None else mesh.shard_lo


@dataclasses.dataclass(frozen=True)
class RankShardedGraph(ShardedGraph):
    """One rank's part of a :class:`ShardedGraph` on a ring split over
    processes (``mesh.world > 1``): every per-shard tensor holds the
    ``mesh.n_local`` shards from ``mesh.shard_lo`` on axis 0
    (``mesh.shard_spec``); ``n_shards`` and ``n_nodes`` stay the whole
    ring's. ``dataclasses.replace`` keeps the class and the mesh.
    ``live`` is the whole ring's live node count (i64, 0-d), the
    reference's ``psum`` of the liveness, kept here so that a round pays
    no exchange for it: :func:`_replace` renews it wherever the liveness
    changes."""

    mesh: Optional[RingMesh] = None
    live: Optional[torch.Tensor] = None


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
    the remainder in that layout. ``source_csr=True`` adds the per-shard
    sender-CSR view (:func:`_sender_csr`) that :func:`walk` gathers a
    walker's out-edges through. A graph's live
    runtime links (``sim/topology.py``) are folded into the static
    buckets, as the reference folds them (its consolidation path). On a
    mesh split over ranks every rank builds the whole host layout and
    keeps its own shards' rows (``mesh.shard_spec``)."""
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

    csr = _sender_csr(bkt_src, bkt_mask, S, block, e_bkt,
                      edge_pad_multiple) if source_csr else None

    pad_n = S * block - graph.n_nodes_padded

    def per_node(t):
        return np.pad(_np(t), (0, pad_n)).reshape(S, block)

    def per_row(t):
        return None if t is None else np.pad(
            _np(t), ((0, pad_n), (0, 0))).reshape(S, block, -1)

    rows = shard_spec(mesh)  # every per-shard array: this rank's shards

    def on(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a[rows])).to(mesh.device)

    mxu_src, mxu_dst, mxu_mask = map(on, mxu_arrays or (None,) * 3)
    mxu_extent = on(row_extent(*mxu_arrays) if mxu_arrays else None)
    cls, part = ShardedGraph, {}
    if mesh.world > 1:  # every rank holds the whole host layout: no exchange
        cls, part = RankShardedGraph, {"mesh": mesh, "live": torch.as_tensor(
            int(_np(graph.node_mask).sum()), device=mesh.device)}
    return cls(
        bkt_src=on(bkt_src), bkt_dst=on(bkt_dst), bkt_mask=on(bkt_mask),
        node_mask=on(per_node(graph.node_mask)),
        out_degree=on(per_node(graph.out_degree)),
        in_degree=on(per_node(graph.in_degree)),
        n_nodes=graph.n_nodes, n_shards=S, block=block,
        neighbors=on(per_row(graph.neighbors)),
        neighbors_mask=on(per_row(graph.neighbor_mask)),
        mxu_src=mxu_src, mxu_dst=mxu_dst, mxu_mask=mxu_mask,
        mxu_extent=mxu_extent, diag_masks=on(diag_masks),
        diag_pieces=diag_pieces, mxu_block=mxu_block,
        **({} if csr is None else dict(csr_pos=on(csr[0]),
                                       csr_offsets=on(csr[1]),
                                       csr_span=csr[2])), **part)


def _sender_csr(bkt_src, bkt_mask, S, block, e_bkt, pad_multiple):
    """The per-shard sender-CSR view of the segment buckets (host-side):
    ``csr_pos [S, E_s]`` lists each shard's live bucket slots (``t *
    E_bkt + slot``) grouped by GLOBAL sender id (step ``t`` holds the
    senders of shard ``(d - t) mod S``), slots in order within a sender;
    ``csr_offsets [S, S * block + 1]`` are the groups' starts;
    ``csr_span`` the largest group."""
    n_g = S * block
    rows, counts = [], np.zeros((S, n_g), dtype=np.int64)
    for d in range(S):
        t_idx, slot_idx = np.nonzero(bkt_mask[d])
        g_send = ((d - t_idx) % S) * block + bkt_src[d, t_idx, slot_idx]
        pos = (t_idx * e_bkt + slot_idx).astype(np.int32)
        rows.append(pos[np.argsort(g_send, kind="stable")])
        counts[d] = np.bincount(g_send, minlength=n_g)
    e_s = _round_up(max(max(r.size for r in rows), 1), pad_multiple)
    csr_pos = np.zeros((S, e_s), dtype=np.int32)
    for d, r in enumerate(rows):
        csr_pos[d, :r.size] = r
    csr_offsets = np.zeros((S, n_g + 1), dtype=np.int32)
    np.cumsum(counts, axis=1, out=csr_offsets[:, 1:])
    return csr_pos, csr_offsets, int(counts.max()) if counts.size else 0


# --------------------------------------------------------------- churn ops


def with_capacity(sg: ShardedGraph, extra_edges: int) -> ShardedGraph:
    """Reserve ``extra_edges`` dynamic slots per (dst-shard, ring-step)
    bucket, rounded up to a multiple of 8: any distribution of that many
    directed links fits whichever bucket it lands in. Growing an existing
    region keeps every runtime link and adds that many slots again."""
    K = _round_up(max(extra_edges, 1), 8)
    S, L, dev = sg.n_shards, sg.n_local, sg.device
    if sg.dyn_src is not None:
        def pad(x):
            return torch.nn.functional.pad(x, (0, K))

        return dataclasses.replace(sg, dyn_src=pad(sg.dyn_src),
                                   dyn_dst=pad(sg.dyn_dst),
                                   dyn_mask=pad(sg.dyn_mask))
    return dataclasses.replace(
        sg, dyn_src=torch.zeros((L, S, K), dtype=torch.int32, device=dev),
        dyn_dst=torch.zeros((L, S, K), dtype=torch.int32, device=dev),
        dyn_mask=torch.zeros((L, S, K), dtype=torch.bool, device=dev))


def _remask_group(masks_by_t, nm, src, dst, mask, block):
    """One bucket group ``[L, S, W]`` (``L`` shards held here) re-masked
    by both endpoints' liveness, with its per-step sender counts ``[L, S,
    B]`` (on the receiver's shard, for the block resident at each step)
    and its in-degree counts ``[L, B]``. Only the live slots are counted: the
    padding slots of a bucket all address one sender and one receiver,
    and their atomic adds would serialise on those two counters (65 of
    69 ms of a 1M re-mask on the H100, phase 4s's profile)."""
    L, S = src.shape[:2]
    src_alive = masks_by_t.gather(2, src.long())
    dst_alive = nm.gather(1, dst.reshape(L, -1).long()).reshape(dst.shape)
    mask = mask & src_alive & dst_alive
    d, t, w = mask.nonzero(as_tuple=True)
    one = torch.ones(d.numel(), dtype=torch.int32, device=nm.device)
    cnt = torch.zeros(L * S * block, dtype=torch.int32, device=nm.device)
    cnt.scatter_add_(0, (d * S + t) * block + src[d, t, w], one)
    cnt_in = torch.zeros(L * block, dtype=torch.int32, device=nm.device)
    cnt_in.scatter_add_(0, d * block + dst[d, t, w], one)
    return mask, cnt.reshape(L, S, block), cnt_in.reshape(L, block)


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
    ``mxu_extent`` stays valid (masking only removes slots). On a ring
    split over ranks each rank re-masks its own shards' rows of the
    global ``alive``."""
    S, B, L = sg.n_shards, sg.block, sg.n_local
    alive = torch.as_tensor(alive, device=sg.device).reshape(S, B)[
        sg.shard_lo:sg.shard_lo + L]
    comm_obj = _make_ring_comm(comm, DEFAULT_AXIS, sg)
    nm = sg.node_mask & alive
    rot, masks = nm, []
    for _ in range(S):  # masks[t]: liveness of the block resident at step t
        masks.append(rot)
        rot = comm_obj.shift(rot)
    masks_by_t = torch.stack(masks, dim=1)  # [L (shard), S (step), B]

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
            2, sg.mxu_src.reshape(L, S, nb * w).long()).reshape(
                sg.mxu_src.shape)
        rows = torch.arange(nb, dtype=torch.int32, device=sg.device)
        gd = torch.clamp(rows[:, None] * sg.mxu_block + sg.mxu_dst,
                         max=B - 1)
        dst_alive = nm.gather(1, gd.reshape(L, -1).long()).reshape(gd.shape)
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
        # Global neighbor ids: a partner's liveness is read from the
        # collected ring blocks, as the reference reads it: partner v's
        # block is resident on shard d at ring step (d - v // B) mod S.
        nbr = sg.neighbors.long()
        shards = torch.arange(sg.shard_lo, sg.shard_lo + L,
                              device=sg.device)[:, None, None]
        at = ((shards - nbr // B) % S) * B + nbr % B
        partner_alive = masks_by_t.reshape(L, S * B).gather(
            1, at.reshape(L, -1)).reshape(nbr.shape)
        neighbors_mask = neighbors_mask & nm[..., None] & partner_alive
    return _replace(
        sg, bkt_mask=bkt_mask, node_mask=nm, out_degree=out_degree,
        in_degree=in_degree, dyn_mask=dyn_mask, mxu_mask=mxu_mask,
        diag_masks=diag_masks, neighbors_mask=neighbors_mask)


def _replace(sg: ShardedGraph, **kw) -> ShardedGraph:
    """``dataclasses.replace``, renewing a rank part's global live count
    (one exchange) when ``node_mask`` changes."""
    mesh = _rank_mesh(sg)
    if mesh is not None and "node_mask" in kw:
        kw["live"] = all_sum(mesh, kw["node_mask"].sum())
    return dataclasses.replace(sg, **kw)


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
    return with_node_liveness(sg, ~(fail & global_node_mask(sg)))


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


def global_node_mask(sg: ShardedGraph) -> torch.Tensor:
    """The whole ring's ``node_mask [S, block]``: gathered from the ranks
    of a ring split over processes (one exchange)."""
    mesh = _rank_mesh(sg)
    if mesh is None:
        return sg.node_mask
    return gather_shards(mesh, sg.node_mask.to(torch.uint8)).bool()


def _any_rank(sg: ShardedGraph, flags: np.ndarray) -> np.ndarray:
    """``flags`` (bool) OR-ed over the ranks: every rank computes its own
    shards' entries, False elsewhere."""
    mesh = _rank_mesh(sg)
    if mesh is None:
        return flags
    t = torch.from_numpy(flags.astype(np.int64))
    return all_sum(mesh, t).numpy() > 0


def _owned(sg: ShardedGraph, shard: np.ndarray) -> np.ndarray:
    """bool: which global shard ids are held here."""
    return (shard >= sg.shard_lo) & (shard < sg.shard_lo + sg.n_local)


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
    as the reference chooses them. On a ring split over ranks every rank
    takes the same call: the receiver's rank probes and writes the slot,
    the sender's rank counts the out-degree, and the probe's answers are
    shared (one exchange, and one for the liveness)."""
    if sg.dyn_src is None:
        raise ValueError(
            "no dynamic edge capacity: reserve slots with "
            "sharded.with_capacity(sg, extra_edges=...) first")
    S, K, dev, lo = sg.n_shards, sg.dyn_capacity, sg.device, sg.shard_lo
    s = np.asarray(senders, np.int64).reshape(-1)
    r = np.asarray(receivers, np.int64).reshape(-1)
    _check_ids(sg, s, r)
    if undirected:
        s, r = np.concatenate([s, r]), np.concatenate([r, s])
    _, first = np.unique(s * np.int64(sg.n_nodes_padded) + r,
                         return_index=True)
    keep = np.zeros(s.size, bool)
    keep[first] = True
    alive = _np(global_node_mask(sg)).reshape(-1)
    keep &= alive[s] & alive[r]

    queries = _queries(sg, s, r)
    mine = _owned(sg, queries[0])
    q = [torch.from_numpy(a[mine]).to(dev)
         for a in (queries[0] - lo,) + queries[1:]]
    exists = np.zeros(s.size, bool)
    exists[mine] = _np(_in_buckets(sg.bkt_src, sg.bkt_dst, sg.bkt_mask, *q)
                       | _in_buckets(sg.dyn_src, sg.dyn_dst, sg.dyn_mask,
                                     *q))
    keep &= ~_any_rank(sg, exists)
    if not keep.any():
        return sg

    d, t, sl, rl = (a[keep] for a in queries)
    occupied = _np(sg.dyn_mask).copy()
    slots = np.zeros(d.size, np.int64)
    full = np.zeros(1, bool)
    for i in np.flatnonzero(_owned(sg, d)):
        free = np.flatnonzero(~occupied[d[i] - lo, t[i]])
        if not free.size:
            full[0] = True
            break
        slots[i] = free[0]
        occupied[d[i] - lo, t[i], free[0]] = True
    if _any_rank(sg, full)[0]:
        raise ValueError(
            f"dynamic bucket ({d[i]}, {t[i]}) full ({K} slots); "
            f"re-shard via shard_graph (consolidation) or reserve more "
            f"via with_capacity" if full[0] else
            "a dynamic bucket on another rank is full; re-shard via "
            "shard_graph (consolidation) or reserve more via with_capacity")

    at = _owned(sg, d)
    dd, tt, kk, rr = (torch.from_numpy(a[at]).to(dev)
                      for a in (d - lo, t, slots, rl))
    dyn_src, dyn_dst, dyn_mask = (x.clone() for x in (
        sg.dyn_src, sg.dyn_dst, sg.dyn_mask))
    dyn_src[dd, tt, kk] = torch.from_numpy(sl[at]).to(dev, torch.int32)
    dyn_dst[dd, tt, kk] = rr.to(torch.int32)
    dyn_mask[dd, tt, kk] = True
    in_degree = sg.in_degree.index_put(
        (dd, rr), torch.ones(dd.numel(), dtype=torch.int32, device=dev),
        accumulate=True)
    ds = (d - t) % S  # the sender's shard
    sent = _owned(sg, ds)
    out_degree = sg.out_degree.index_put(
        tuple(torch.from_numpy(a[sent]).to(dev) for a in (ds - lo, sl)),
        torch.ones(int(sent.sum()), dtype=torch.int32, device=dev),
        accumulate=True)
    return dataclasses.replace(sg, dyn_src=dyn_src, dyn_dst=dyn_dst,
                               dyn_mask=dyn_mask, out_degree=out_degree,
                               in_degree=in_degree)


def disconnect(sg: ShardedGraph, senders, receivers, *,
               undirected: bool = True) -> ShardedGraph:
    """Remove runtime links, matched by endpoint pair (static edges are
    removed with :func:`fail_nodes` or a re-shard). A pair listed twice
    is removed once. On a ring split over ranks the receiver's rank
    clears the slot and the sender's rank the out-degree (one
    exchange)."""
    if sg.dyn_src is None:
        raise ValueError("graph has no dynamic edge region")
    S, dev, lo = sg.n_shards, sg.device, sg.shard_lo
    s = np.asarray(senders, np.int64).reshape(-1)
    r = np.asarray(receivers, np.int64).reshape(-1)
    if undirected:
        s, r = np.concatenate([s, r]), np.concatenate([r, s])
    _, first = np.unique(s * np.int64(sg.n_nodes_padded) + r,
                         return_index=True)
    s, r = s[np.sort(first)], r[np.sort(first)]
    queries = _queries(sg, s, r)
    mine = _owned(sg, queries[0])
    d, t, sl, rl = (torch.from_numpy(a[mine]).to(dev)
                    for a in (queries[0] - lo,) + queries[1:])
    hit = ((sg.dyn_src[d, t] == sl[:, None].to(torch.int32))
           & (sg.dyn_dst[d, t] == rl[:, None].to(torch.int32))
           & sg.dyn_mask[d, t])  # [Q, K]
    cleared = torch.zeros(sg.dyn_mask.shape, dtype=torch.int32, device=dev)
    cleared.index_put_((d, t), hit.to(torch.int32), accumulate=True)
    removed = hit.any(dim=1).to(torch.int32)  # the receivers' side
    ds = (queries[0] - queries[1]) % S  # the sender's shard
    sent = _owned(sg, ds)
    dropped = removed  # in one process every query is this one's
    if _rank_mesh(sg) is not None:
        flags = np.zeros(s.size, bool)
        flags[mine] = _np(removed) > 0
        dropped = torch.from_numpy(
            _any_rank(sg, flags)[sent].astype(np.int32)).to(dev)
    return dataclasses.replace(
        sg, dyn_mask=sg.dyn_mask & (cleared == 0),
        out_degree=sg.out_degree.index_put(
            tuple(torch.from_numpy(a[sent]).to(dev)
                  for a in (ds - lo, queries[2])), -dropped,
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
    return _replace(sg, **kw)


# --------------------------------------------------------------- ring pass


def _step_fold(blocks, groups, diag, acc, combine):
    """Fold a pass step by step: at step ``t`` (the ``t``-th block of
    ``blocks``, the one resident there) each group's bucket ``[:, t]``,
    then each diagonal piece of step ``t`` with its static shift, so sums
    fold in the reference's order (the static group, the dynamic group,
    the pieces)."""
    pieces, masks, apply_diag = diag
    for t, rot in enumerate(blocks):
        for fn, *arrs in groups:
            acc = combine(acc, fn(rot, *(a[:, t] for a in arrs)))
        for pi, (tp, r) in enumerate(pieces):
            if tp == t:
                acc = combine(acc, apply_diag(rot, r, masks[:, pi]))
    return acc


def _diag_or_piece(rot, r, mask):
    """out[d, j] |= rot[d, (j + r) % B] & mask[d, j] — a static shift."""
    return torch.roll(rot, -r, dims=1) & mask


def _diag_sum_piece(rot, r, mask):
    # XLA makes the reference's product with the bool mask a select: a
    # masked non-finite term gives 0, not NaN.
    return torch.where(mask, torch.roll(rot, -r, dims=1), 0.0)


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
    told the step before each hop. A ring split over ranks reads the
    pass from one exchange (:func:`_gathered_pass`)."""
    if isinstance(comm, _RankComm):
        return _gathered_pass(S, frontier, groups, acc0, combine, diag, comm)
    if diag[0]:  # the diagonal pieces: every step unrolled, no fusion
        return _step_fold(_rotations(comm, frontier, S), groups, diag, acc0,
                          combine)
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


def _gathered_pass(S, x, groups, acc0, combine, diag, comm: _RankComm):
    """:func:`_ring_pass` on a ring split over ranks: the pass's blocks
    from one gather (:meth:`_RankComm.gather`), each step's rows a view of
    it. The MXU group takes the pass kernel, every step's sums in one
    launch; the other groups (the dynamic region) and the diagonal pieces
    apply at their steps on the step's rows. The plain backend keeps the
    reference's fold order where it shows: an f32 sum with another group
    or pieces beside the MXU group folds step by step (static, dynamic,
    pieces at each step), bit for bit the one-process ring; on the card
    the pass kernel's atomics add in no fixed order anyway (and OR in any
    order is exact)."""
    slab = comm.gather(x)
    fused = getattr(groups[0][0], "fused", None)
    acc, rest = acc0, groups
    if fused is not None and (comm.backend == "pallas" or fused[0] == "or"
                              or (len(groups) == 1 and not diag[0])):
        kind, post, kblock, extent = fused
        acc = combine(acc, post(comm.pass_segment_sum(
            slab, kind, *groups[0][1:], kblock, extent)))
        rest = groups[1:]
    return _step_fold((comm.rows(slab, t) for t in range(S)), rest, diag,
                      acc, combine)


def _rotations(comm, x, S, set_step: bool = True):
    """The blocks resident at ring steps ``0 .. S - 1`` of a pass of
    ``x``: on a ring split over ranks views of one gather, else ``S - 1``
    hops, each issued before its step's block is used (and, with
    ``set_step``, a comm that keys faults on the step told it first)."""
    if isinstance(comm, _RankComm):
        slab = comm.gather(x)
        for t in range(S):
            yield comm.rows(slab, t)
        return
    wants_step = set_step and getattr(comm, "wants_step", False)
    rot = x
    for t in range(S):
        if wants_step and t < S - 1:
            comm.set_context(step=t)
        rot_next = comm.shift(rot) if t < S - 1 else rot
        yield rot
        rot = rot_next


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
    comm_obj = _make_ring_comm(comm, axis_name, sg)
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
        return torch.full((x.shape[0], block), fill, dtype=x.dtype,
                          device=x.device)

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
    seed = torch.zeros((sg.n_local, sg.block), dtype=torch.bool,
                       device=sg.device)
    d = source // sg.block - sg.shard_lo  # on a rank's part: its own rows
    if 0 <= d < sg.n_local:
        seed[d, source % sg.block] = True
    return seed & sg.node_mask  # a dead source seeds nothing


def init_state(sg: ShardedGraph, protocol, key=None):
    """The sharded initial state of a protocol, what ``protocol.init``
    makes on the engine path, laid out ``[S, block]``: Flood -> ``(seen,
    frontier)``; SIR -> ``status``; Gossip -> ``values``; HopDistance ->
    ``(dist, frontier, round)``; PageRank -> ``ranks``; PushSum -> ``(s,
    w)``. Gossip and PushSum draw their values from ``key`` over the whole
    padded population, as the engine does; on a rank's part every state
    is its own shards' rows (a seed only where its shard is held, its
    rows of the whole draw, PageRank's share of the global live count)."""
    S, block, dev = sg.n_shards, sg.block, sg.device
    if isinstance(protocol, Flood):
        seed = _flood_seed(sg, protocol.source)
        return (seed, seed)
    if isinstance(protocol, SIR):
        seed = _flood_seed(sg, protocol.source)
        return seed.to(torch.int32) * sg.node_mask
    if isinstance(protocol, (Gossip, PushSum)):
        vals = prng.normal(key, (sg.n_nodes_padded,), device=dev).reshape(
            S, block)[sg.shard_lo:sg.shard_lo + sg.n_local]
        if isinstance(protocol, Gossip):
            # XLA makes the product with a bool mask a select: +0 where
            # the node is dead.
            return torch.where(sg.node_mask, vals, 0.0)
        mask_f = sg.node_mask.to(torch.float32)
        return (vals * mask_f, mask_f)
    if isinstance(protocol, HopDistance):
        seed = _flood_seed(sg, protocol.source)
        dist = torch.where(seed, 0, -1).to(torch.int32)
        return (dist, seed, torch.zeros((), dtype=torch.int32, device=dev))
    if isinstance(protocol, PageRank):  # over the whole ring's live count
        return sg.node_mask.to(torch.float32) / _n_live(sg).to(torch.float32)
    raise ValueError(
        f"the sharded path implements Flood, SIR, Gossip, HopDistance, "
        f"PageRank and PushSum; got {type(protocol).__name__} — run it on "
        f"the single-device engine, or write its round body around "
        f"sharded.propagate")


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
        covered, n = _rank_sums(sg, (state.seen & sg.node_mask).sum(),
                                sg.node_mask.sum())
        return _ratio(covered, n)

    def step(self, sg, state: FloodState, key):
        if self.round0 is not None:
            self.pass_.comm.set_context(round=self.round0 + self._steps[0])
            self._steps[0] += 1
        nm = sg.node_mask
        delivered = self.pass_(state.frontier)
        new = delivered & ~state.seen & nm
        seen = state.seen | new
        # The round's counts (one exchange on a ring split over ranks),
        # divided in f32 as ``live_coverage`` and ``frontier.occupancy``
        # divide.
        messages, covered, fresh, n = _rank_sums(
            sg, segment.frontier_messages(sg, state.frontier),
            (seen & nm).sum(), new.sum(), nm.sum())
        stats = {
            "messages": messages,
            "coverage": _ratio(covered, n),
            "frontier": fresh,
            "frontier_occupancy": _ratio(fresh, n),
            "covered": covered,
        }
        return FloodState(seen=seen, frontier=new), stats


def _check_mesh(sg: ShardedGraph, mesh: RingMesh) -> None:
    if mesh.n_shards != sg.n_shards:
        raise ValueError(f"the graph is sharded {sg.n_shards} ways, the "
                         f"mesh has {mesh.n_shards} shards")
    part = _rank_mesh(sg)
    held = (1, 0) if part is None else (part.world, part.shard_lo)
    if (mesh.world, mesh.shard_lo) != held:
        raise ValueError(
            f"the graph holds the shards of rank position {held[1]} of "
            f"{held[0]}, the mesh is position {mesh.position} of "
            f"{mesh.world}: shard the graph for this mesh")


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

    ``adaptive_k > 0`` (a graph sharded with ``source_csr=True``) runs the
    frontier-adaptive loop (:func:`_make_adaptive_wave`): rounds whose
    frontier fits ``adaptive_k`` work items on every shard skip the ring
    and gather the frontier's out-edges through the sender-CSR view; the
    results equal the dense loop's bit for bit. It refuses a recorder and
    a fault-spec comm, as the reference does.

    ``recorder`` (a ``sim/flightrec.py`` ``FlightRecorder``, dense loop
    only) keeps a row a round on the device and attaches
    ``out["flight_record"]``: the round's occupancy, sends and running
    total, the covered-node COUNT in the ``coverage`` column, and in
    ``ici_bytes`` the loop's per-round byte estimate
    (``parallel/commviz.py``, the same for both comms). The results equal
    a run without it. On a ring split over ranks every column is made
    from the round's totals, which the round already sums over the ranks
    in its one exchange, so each rank writes the whole ring's rows with
    no exchange of its own.

    ``comm`` also takes a ``chaos/device.FaultSpec``: the ring runs on its
    backend with its schedule's faults injected at the halo hops, keyed
    on the global round ``fault_round0 + r`` (a chunked or resumed driver
    passes ``fault_round0`` so each chunk hits the sites an unchunked run
    would), and the faults the executed rounds hit are counted into
    ``chaos_device_faults_total{kind}`` after the run. On a ring split
    over ranks the faults are keyed on the global shard, and every rank
    counts the whole ring's sites (the reference's host replay runs in
    every process)."""
    if adaptive_k > 0:
        return _flood_adaptive(sg, mesh, source, coverage_target,
                               max_rounds, state0, return_state, adaptive_k,
                               comm, recorder)
    proto, state = _flood_start(sg, mesh, source, state0, comm,
                                fault_round0)
    row_of = None if recorder is None else _flood_row_of(sg,
                                                         proto.pass_.comm)
    # The flood draws nothing; the engine's key chain runs unread.
    state, out = engine.run_until_coverage_from(
        sg, proto, state, prng.key(0), coverage_target=coverage_target,
        max_rounds=max_rounds, recorder=recorder, row_of=row_of)
    _record_comm_faults(comm, out["rounds"], sg.n_shards,
                        round0=fault_round0)
    if return_state:
        return (state.seen, state.frontier), out
    return state.seen, out


def _flood_row_of(sg: ShardedGraph, comm_obj):
    """The recorded dense flood's row columns (the reference's): the
    round's occupancy and sends, the running total's f32 view, the
    covered-node count, one lane and the per-round byte estimate (one
    device fill a run, no host -> device copy)."""
    dev = sg.device
    one = torch.ones((), dtype=torch.float32, device=dev)
    ici = torch.full((), float(commviz.ici_round_bytes(
        "flood", sg.n_shards, sg.block, comm=comm_obj.backend)),
        dtype=torch.float32, device=dev)

    def row_of(stats, messages):
        return dict(occupancy=stats["frontier_occupancy"],
                    new=stats["messages"],
                    total=flightrec.total_f32(*flightrec.limbs(messages)),
                    coverage=stats["covered"], active_lanes=one,
                    ici_bytes=ici)

    return row_of


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


# ---------------------------------------------------------- shared helpers


def live_nodes(sg: ShardedGraph) -> torch.Tensor:
    """The whole ring's live node count (i64, 0-d; the reference's
    ``psum`` of the liveness): a rank part's kept ``live``, no
    exchange."""
    return sg.node_mask.sum() if _rank_mesh(sg) is None else sg.live


def _n_live(sg: ShardedGraph) -> torch.Tensor:
    """The live node count, at least 1."""
    return live_nodes(sg).clamp_min(1)


def _over_live(count: torch.Tensor, sg: ShardedGraph) -> torch.Tensor:
    """An integer count over the live count, divided in f32."""
    return count.to(torch.float32) / _n_live(sg).to(torch.float32)


def _rank_sums(sg: ShardedGraph, *counts: torch.Tensor):
    """The integer ``counts`` (0-d, or vectors of one shape) summed over
    the ranks of a ring split over processes, in one exchange (the
    reference's ``psum`` of each); the counts themselves in one
    process."""
    mesh = _rank_mesh(sg)
    if mesh is None:
        return counts
    return all_sum(mesh, torch.stack([c.to(torch.int64)
                                      for c in counts])).unbind()


def _ratio(count: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """An integer count over a live count (at least 1), in f32."""
    return count.to(torch.float32) / n.clamp_min(1).to(torch.float32)


def psum_f32(x: torch.Tensor, sg: Optional[ShardedGraph] = None
             ) -> torch.Tensor:
    """The 0-d sum of an f32 ``[S, block]`` tensor in the reference's ring
    order: each shard's block summed by ``jnp.sum`` (XLA's CPU order,
    ``ops/rowsum.py``: one row-sum launch for all shards), then ``psum``
    over the shards, which on the 8-device CPU mesh adds shard 0, 1, ...,
    S - 1 left to right (measured: 2,000 of 2,000 draws over eight
    decades; a pairwise tree matched 1,086). On a rank's part (``sg``
    split over processes) the shards' sums are gathered from the ranks in
    shard order first (one exchange), so the total is the same."""
    return _totals(sg, sums=(x,))[0]


def _shard_rows(sg: Optional[ShardedGraph], rows: torch.Tensor
                ) -> torch.Tensor:
    """Per-shard values ``[n_local, ...]`` of every rank, in shard order
    (one exchange on a ring split over processes)."""
    mesh = None if sg is None else _rank_mesh(sg)
    return rows if mesh is None else gather_shards(mesh, rows)


def _totals(sg: ShardedGraph, sums=(), counts=(), maxes=()) -> list:
    """A round's totals over the whole ring, in one exchange on a ring
    split over ranks (none in one process): for each f32 ``[n_local,
    block]`` of ``sums`` its :func:`psum_f32` (each shard's row sum, then
    the shards left to right), for each integer or bool tensor of
    ``counts`` (``[n_local, ...]``) its exact sum (i64), for each of
    ``maxes`` its max in its own dtype (the reference's ``pmax``). The
    per-shard partials ride one ``[n_local, k]`` f64 gather in shard
    order; f64 holds each exactly (f32 row sums and maxima, i32 maxima,
    counts below 2**53). Returned in that order."""
    def rows(x):
        return x.reshape(x.shape[0], -1)

    parts = ([rowsum.row_sum(x) for x in sums]
             + [rows(c).sum(1, dtype=torch.int64) for c in counts]
             + [rows(m).amax(1) for m in maxes])
    cols = _shard_rows(sg, torch.stack([p.to(torch.float64) for p in parts],
                                       dim=1))
    i = iter(range(len(parts)))
    return ([accum.ordered_sum(cols[:, next(i)].to(torch.float32))
             for _ in sums]
            + [cols[:, next(i)].sum().to(torch.int64) for _ in counts]
            + [cols[:, next(i)].amax().to(m.dtype) for m in maxes])


def _rank_max(sg: ShardedGraph, x: torch.Tensor) -> torch.Tensor:
    """``x`` maxed over the ranks of a ring split over processes (one
    exchange, the reference's ``pmax``); ``x`` itself in one process."""
    mesh = _rank_mesh(sg)
    return x if mesh is None else all_max(mesh, x)


#: Node tile of the ``"tile"`` draw mode: one key per 128-node tile,
#: folded from the GLOBAL tile index, so the draws do not depend on the
#: shard count.
RNG_TILE = 128


def _resolve_rng(sg: ShardedGraph, exact_rng: bool, rng: Optional[str]) -> str:
    if exact_rng:
        return "exact"
    if rng is not None:
        if rng not in ("exact", "tile", "fold"):
            raise ValueError(
                f"rng must be 'exact', 'tile' or 'fold', got {rng!r}")
        return rng
    return "tile" if sg.block % RNG_TILE == 0 else "fold"


def _make_draw(sg: ShardedGraph, rng: str, sample=None):
    """``draw(key) -> [S, block]``, every shard's draw for the mode:

    - ``"exact"``: the whole population from ``key``, each shard's block
      sliced from it (the single-device engine's draw, bit for bit);
    - ``"tile"``: one key per 128-node tile, ``fold_in(key, global tile
      index)`` (needs ``block % 128 == 0``);
    - ``"fold"``: ``fold_in(key, shard)`` for each shard's block.

    One threefry launch serves one key, so a draw is one launch
    (``"exact"``), ``S`` (``"fold"``) or ``S * block / 128`` (``"tile"``).
    ``sample(key, n)`` draws ``n`` values (default: f32 uniform on
    ``[0, 1)``). A rank's part draws (or slices) its own shards' rows."""
    S, block, dev = sg.n_shards, sg.block, sg.device
    lo, hi = sg.shard_lo, sg.shard_lo + sg.n_local
    if sample is None:
        def sample(k, n):
            return prng.uniform(k, (n,), device=dev)
    if rng == "tile" and block % RNG_TILE:
        raise ValueError("tile RNG requires block % 128 == 0")

    def draw(key):
        if rng == "exact":
            return sample(key, S * block).reshape(S, block)[lo:hi]
        if rng == "tile":
            per = block // RNG_TILE
            return torch.stack([
                sample(prng.fold_in(key, i), RNG_TILE)
                for i in range(lo * per, hi * per)]).reshape(hi - lo, block)
        return torch.stack([sample(prng.fold_in(key, d), block)
                            for d in range(lo, hi)])

    return draw


# ---------------------------------------------------------------------- SIR


@dataclasses.dataclass(frozen=True)
class _RingSIR:
    """SIR's round on the ring (``models/sir.py``'s arithmetic): the
    infection pressure is a ring sum pass of integer-valued f32 (exact in
    any order), ``(1-beta)^k`` is read from the single-device model's host
    table (``escape_table_host``), and the two uniform draws per round come
    from the draw mode's ``draw``."""

    pass_: object
    draw: object
    escape: torch.Tensor
    gamma: float

    STATS = SIR.STATS

    def coverage(self, sg, status):
        covered, = _totals(sg, counts=[(status != sir_model.SUSCEPTIBLE)
                                       & sg.node_mask])
        return _over_live(covered, sg)

    def step(self, sg, status, key):
        k_inf, k_rec = prng.split(key)
        nm = sg.node_mask
        infected = (status == sir_model.INFECTED) & nm
        susceptible = (status == sir_model.SUSCEPTIBLE) & nm
        pressure = self.pass_(infected.to(torch.float32))
        p_infect = 1.0 - self.escape[pressure.long()]
        newly = susceptible & (self.draw(k_inf) < p_infect)
        recovers = infected & (self.draw(k_rec) < self.gamma)
        status = torch.where(newly, sir_model.INFECTED, status)
        status = torch.where(recovers, sir_model.RECOVERED, status)
        messages, *counts = _totals(sg, counts=[
            torch.where(infected, sg.out_degree, 0)] + [
            m & nm for m in (status == sir_model.SUSCEPTIBLE,
                             status == sir_model.INFECTED,
                             status == sir_model.RECOVERED,
                             status != sir_model.SUSCEPTIBLE)])
        s, i, r, covered = (_over_live(c, sg) for c in counts)
        stats = {"messages": messages, "s_frac": s, "i_frac": i,
                 "r_frac": r, "coverage": covered}
        return status, stats


def _max_in_degree(sg: ShardedGraph) -> int:
    """The largest live in-degree of the whole ring (maxed over the ranks
    of a split ring, one exchange), read once on the host (one counted
    sync): it bounds a round's pressure, so it sizes the escape table,
    the same length on every rank."""
    top = _rank_max(sg, sg.in_degree.max())
    _device.SYNCS += 1
    return max(int(top), 0)


def _sir_start(sg, mesh, protocol, key, exact_rng, rng, status0, comm,
               axis_name):
    _check_mesh(sg, mesh)
    proto = _RingSIR(
        pass_=_make_pass(sg, comm, "sum", axis_name),
        draw=_make_draw(sg, _resolve_rng(sg, exact_rng, rng)),
        escape=sir_model._escape_table(float(protocol.beta),
                                       _max_in_degree(sg), sg.device),
        gamma=float(np.float32(protocol.gamma)))
    if status0 is None:
        status0 = init_state(sg, protocol, key)
    return proto, status0


def sir(sg: ShardedGraph, mesh: RingMesh, protocol, key, rounds: int,
        axis_name: str = DEFAULT_AXIS, exact_rng: bool = False,
        rng: Optional[str] = None, status0=None, comm=DEFAULT_COMM):
    """Run ``rounds`` of SIR (``models/sir.py``) on the ring. Returns
    ``(status [S, block] i32, stats)``, each stat a ``[rounds]`` tensor.
    The key schedule is ``engine.run``'s, so with ``exact_rng=True`` and
    ``S * block`` equal to the graph's padded size the run is the single
    device's, bit for bit. By default the draws are ``"tile"`` (invariant
    across shard counts), or ``"fold"`` when the block is not a multiple
    of 128 (:func:`_make_draw`)."""
    proto, status0 = _sir_start(sg, mesh, protocol, key, exact_rng, rng,
                                status0, comm, axis_name)
    return engine._run_from(sg, proto, status0, key, int(rounds), None)


def sir_until_coverage(sg: ShardedGraph, mesh: RingMesh, protocol, key, *,
                       coverage_target: float = 0.99, max_rounds: int = 1024,
                       axis_name: str = DEFAULT_AXIS, exact_rng: bool = False,
                       rng: Optional[str] = None, status0=None,
                       comm=DEFAULT_COMM):
    """SIR until the ever-infected share of the live population reaches
    ``coverage_target`` (or ``max_rounds``): ``engine.run_until_coverage``'s
    key schedule (the carried key split each round). Returns ``(status,
    dict(rounds, coverage, messages))``, ``messages`` an exact int."""
    proto, status0 = _sir_start(sg, mesh, protocol, key, exact_rng, rng,
                                status0, comm, axis_name)
    target = torch.tensor(coverage_target, dtype=torch.float32,
                          device=sg.device)
    return engine._stat_while(
        sg, proto, status0, key, stat="coverage",
        keep_going=lambda v, r: (v < target) & (r < max_rounds),
        value0=proto.coverage(sg, status0), loop="coverage_sharded",
        value_name="coverage")


# ------------------------------------------------------------------- gossip


@dataclasses.dataclass(frozen=True)
class _RingGossip:
    """Push-pull gossip's round on the ring (``models/gossip.py``). Each
    node draws one valid slot of its (liveness re-masked) neighbor row, as
    the engine draws it, and pulls its partner's value over the ring: at
    step ``t`` the resident block is shard ``(d - t) mod S``'s, and a node
    whose partner lives there takes its value, so every node's sum has
    exactly one term. The hops run through ``comm`` (B2 on f32; across
    ranks one gather a round)."""

    comm: object
    draw: object
    alpha: float
    count: torch.Tensor  # i32[S, B]: valid slots a row
    csum: torch.Tensor  # i32[S, B, W]: running count of valid slots

    STATS = Gossip.STATS

    def step(self, sg, values, key):
        S = sg.n_shards
        nm = sg.node_mask
        has_neighbor = (self.count > 0) & nm
        k = self.draw(key) % self.count.clamp_min(1)
        hit = (self.csum == (k + 1)[..., None]) & sg.neighbors_mask
        slot = hit.to(torch.uint8).argmax(dim=2)  # the first hit, else 0
        partner = sg.neighbors.gather(2, slot[..., None].long())[..., 0]
        p_shard, p_local = partner // sg.block, (partner % sg.block).long()
        shards = torch.arange(sg.shard_lo, sg.shard_lo + sg.n_local,
                              device=sg.device)[:, None]
        pulled = torch.zeros_like(values)
        for t, rot in enumerate(_rotations(self.comm, values, S,
                                           set_step=False)):
            pulled = pulled + torch.where(p_shard == (shards - t) % S,
                                          rot.gather(1, p_local), 0.0)
        mixed = (1.0 - self.alpha) * values + self.alpha * pulled
        values = torch.where(has_neighbor, mixed, values)
        # Per shard: the mean's f32 sum and the two counts, gathered in
        # shard order in one exchange on a ring split over ranks (the
        # variance's sum, which needs the mean, in a second).
        cols = _shard_rows(sg, torch.stack([
            rowsum.row_sum(values * nm).to(torch.float64),
            nm.sum(dim=1, dtype=torch.float64),
            has_neighbor.sum(dim=1, dtype=torch.float64)], dim=1))
        n = cols[:, 1].sum().clamp_min(1).to(torch.float32)
        mean = accum.ordered_sum(cols[:, 0].to(torch.float32)) / n
        var = psum_f32(torch.where(nm, (values - mean) ** 2, 0.0), sg) / n
        stats = {"messages": 2 * cols[:, 2].sum().to(torch.int32),
                 "variance": var, "mean": mean}
        return values, stats


def gossip(sg: ShardedGraph, mesh: RingMesh, protocol, key, rounds: int,
           axis_name: str = DEFAULT_AXIS, exact_rng: bool = False,
           rng: Optional[str] = None, values0=None, comm=DEFAULT_COMM):
    """Run ``rounds`` of push-pull gossip averaging (``models/gossip.py``)
    on the ring. Returns ``(values [S, block] f32, stats)``. The init draw
    and the round keys are ``engine.run``'s, so with ``exact_rng=True``
    and ``S * block`` the padded size the partners are the engine's."""
    if sg.neighbors is None:
        raise ValueError(
            "sharded gossip needs a partner table: shard a graph built "
            "with a neighbor table (from_edges build_neighbor_table=True)")
    _check_mesh(sg, mesh)
    dev = sg.device
    alpha = np.float32(protocol.alpha)

    def sample(k, n):
        return prng.randint(k, (n,), 0, 2**31 - 1, device=dev)

    proto = _RingGossip(
        comm=_make_ring_comm(comm, axis_name, sg),
        draw=_make_draw(sg, _resolve_rng(sg, exact_rng, rng), sample),
        alpha=float(alpha),
        count=sg.neighbors_mask.sum(dim=2, dtype=torch.int32),
        csum=sg.neighbors_mask.cumsum(dim=2, dtype=torch.int32))
    if values0 is None:
        values0 = init_state(sg, protocol, key)
    return engine._run_from(sg, proto, values0, key, int(rounds), None)


# --------------------------------------------------- PageRank and push-sum


@dataclasses.dataclass(frozen=True)
class _RingPageRank:
    """Power iteration on the ring (``models/pagerank.py``'s arithmetic,
    the edge sums by a ring sum pass, the totals by :func:`psum_f32`,
    the damped update with the reference's fused multiply-add)."""

    pass_: object
    damping: float
    one_minus_damping: float

    STATS = PageRank.STATS

    def step(self, sg, ranks, key):
        nm, deg = sg.node_mask, sg.out_degree
        mask_f = nm.to(torch.float32)
        n = _n_live(sg).to(torch.float32)
        contrib = torch.where(nm & (deg > 0),
                              ranks / deg.to(torch.float32).clamp_min(1.0),
                              0.0)
        pulled = self.pass_(contrib)
        dangling = psum_f32(torch.where(nm & (deg == 0), ranks, 0.0), sg)
        # XLA's CPU code fuses this product and add into one rounding.
        new = TF.fma_f32(pulled + dangling / n, self.damping,
                         self.one_minus_damping / n) * mask_f
        residual, total, messages, top = _totals(
            sg, sums=((new - ranks).abs(), new),
            counts=(torch.where(nm, deg, 0),), maxes=(new,))
        stats = {"messages": messages, "residual": residual,
                 "rank_total": total, "rank_max": top}
        return new, stats


def _pagerank_start(sg, mesh, protocol, ranks0, comm, axis_name):
    _check_mesh(sg, mesh)
    proto = _RingPageRank(
        pass_=_make_pass(sg, comm, "sum", axis_name),
        damping=float(np.float32(protocol.damping)),
        one_minus_damping=float(np.float32(1.0 - protocol.damping)))
    if ranks0 is None:
        ranks0 = init_state(sg, protocol)
    return proto, ranks0


def pagerank(sg: ShardedGraph, mesh: RingMesh, protocol, rounds: int,
             axis_name: str = DEFAULT_AXIS, ranks0=None, comm=DEFAULT_COMM):
    """Run ``rounds`` of PageRank power iteration on the ring. Returns
    ``(ranks [S, block] f32, stats)``; no draws."""
    proto, ranks0 = _pagerank_start(sg, mesh, protocol, ranks0, comm,
                                    axis_name)
    # No draws; the engine's key chain runs unread.
    return engine._run_from(sg, proto, ranks0, prng.key(0), int(rounds),
                            None)


def _until_below(sg, proto, state0, stat, tol, max_rounds,
                 steps_per_round):
    """Rounds while ``stats[stat] >= tol`` (and fewer than ``max_rounds``),
    ``steps_per_round`` a super-step, each sub-step re-checking and
    freezing the whole state once the test fails (the reference's
    ``_freeze_while``; bit-exact against ``T = 1``). Returns ``(state,
    dict(rounds, value, messages))``."""
    if steps_per_round < 1:
        raise ValueError(
            f"steps_per_round must be >= 1, got {steps_per_round}")
    thr = torch.tensor(tol, dtype=torch.float32, device=sg.device)
    # The rounds draw nothing; the engine's key chain runs unread.
    return engine._stat_while(
        sg, proto, state0, prng.key(0), stat=stat,
        keep_going=lambda v, r: (v >= thr) & (r < max_rounds),
        value0=float("inf"), loop="converged_sharded",
        steps_per_round=steps_per_round)


def pagerank_until_residual(sg: ShardedGraph, mesh: RingMesh, protocol, *,
                            tol: float = 1e-6, max_rounds: int = 1024,
                            steps_per_round: int = 1,
                            axis_name: str = DEFAULT_AXIS, ranks0=None,
                            comm=DEFAULT_COMM):
    """PageRank until the L1 residual drops below ``tol``
    (``engine.run_until_converged(stat="residual")`` on the ring), ``T =
    steps_per_round`` rounds a super-step. Returns ``(ranks, dict(rounds,
    value, messages))``, ``value`` the last residual."""
    proto, ranks0 = _pagerank_start(sg, mesh, protocol, ranks0, comm,
                                    axis_name)
    return _until_below(sg, proto, ranks0, "residual", tol, max_rounds,
                        int(steps_per_round))


@dataclasses.dataclass(frozen=True)
class _RingPushSum:
    """Push-sum's round on the ring (``models/pushsum.py``'s arithmetic):
    mass split over the out-edges, two ring sum passes a round."""

    pass_: object

    STATS = PushSum.STATS

    def step(self, sg, state, key):
        s, w = state
        nm, deg = sg.node_mask, sg.out_degree
        mask_f = nm.to(torch.float32)
        shares = 1.0 / (deg.to(torch.float32) + 1.0)
        s_share, w_share = s * shares, w * shares
        s = (s_share + self.pass_(s_share)) * mask_f
        w = (w_share + self.pass_(w_share)) * mask_f
        est = torch.where(w > 0, s / w.clamp_min(1e-30), 0.0)
        n = _n_live(sg).to(torch.float32)
        # The totals in two exchanges: the variance needs the mean.
        est_total, s_total, w_total, messages = _totals(
            sg, sums=(est * mask_f, s, w), counts=(torch.where(nm, deg, 0),))
        mean = est_total / n
        var = psum_f32(torch.where(nm, (est - mean) ** 2, 0.0), sg) / n
        stats = {"messages": messages, "s_total": s_total,
                 "w_total": w_total, "variance": var, "mean": mean}
        return (s, w), stats


def _pushsum_start(sg, mesh, protocol, key, state0, comm, axis_name):
    _check_mesh(sg, mesh)
    proto = _RingPushSum(pass_=_make_pass(sg, comm, "sum", axis_name))
    if state0 is None:
        state0 = init_state(sg, protocol, key)
    return proto, tuple(state0)


def pushsum(sg: ShardedGraph, mesh: RingMesh, protocol, key, rounds: int,
            axis_name: str = DEFAULT_AXIS, state0=None, comm=DEFAULT_COMM):
    """Run ``rounds`` of push-sum on the ring. ``key`` seeds the initial
    values as the engine does; ``state0 = (s, w)`` continues a run.
    Returns ``((s, w), stats)``."""
    proto, state0 = _pushsum_start(sg, mesh, protocol, key, state0, comm,
                                   axis_name)
    return engine._run_from(sg, proto, state0, prng.key(0), int(rounds),
                            None)


def pushsum_until_variance(sg: ShardedGraph, mesh: RingMesh, protocol, key,
                           *, tol: float = 1e-9, max_rounds: int = 1024,
                           steps_per_round: int = 1,
                           axis_name: str = DEFAULT_AXIS, state0=None,
                           comm=DEFAULT_COMM):
    """Push-sum until the estimates' variance drops below ``tol``
    (``engine.run_until_converged(stat="variance")`` on the ring). Returns
    ``((s, w), dict(rounds, value, messages))``."""
    proto, state0 = _pushsum_start(sg, mesh, protocol, key, state0, comm,
                                   axis_name)
    return _until_below(sg, proto, state0, "variance", tol, max_rounds,
                        int(steps_per_round))


# ------------------------------------------------------------ hop distance


@dataclasses.dataclass(frozen=True)
class _RingHopDist:
    """BFS's round on the ring (``models/hopdist.py``): the flood wave by
    a ring OR pass; a node records the round that first reaches it."""

    pass_: object

    STATS = HopDistance.STATS

    def step(self, sg, state, key):
        dist, frontier, rnd = state
        nm = sg.node_mask
        new = self.pass_(frontier) & (dist < 0) & nm
        rnd = rnd + 1
        dist = torch.where(new, rnd, dist)
        messages, covered, fresh, far = _totals(
            sg, counts=(torch.where(frontier, sg.out_degree, 0),
                        (dist >= 0) & nm, new), maxes=(dist,))
        stats = {"messages": messages, "coverage": _over_live(covered, sg),
                 "frontier": fresh.to(torch.int32), "max_dist": far}
        return (dist, new, rnd), stats


def _hopdist_state0(sg, protocol, state0):
    return tuple(init_state(sg, protocol) if state0 is None else state0)


def hopdist(sg: ShardedGraph, mesh: RingMesh, protocol, rounds: int,
            axis_name: str = DEFAULT_AXIS, state0=None, comm=DEFAULT_COMM):
    """Run ``rounds`` of BFS hop distance on the ring. Returns ``((dist,
    frontier, round), stats)``, ``dist [S, block] i32`` (-1 unreached)."""
    _check_mesh(sg, mesh)
    proto = _RingHopDist(_make_pass(sg, comm, "or", axis_name))
    return engine._run_from(sg, proto, _hopdist_state0(sg, protocol, state0),
                            prng.key(0), int(rounds), None)


def hopdist_until_coverage(sg: ShardedGraph, mesh: RingMesh, protocol, *,
                           coverage_target: float = 0.99,
                           max_rounds: int = 1024,
                           axis_name: str = DEFAULT_AXIS, state0=None,
                           adaptive_k: int = 0, comm=DEFAULT_COMM):
    """BFS until the reached share of the live population reaches
    ``coverage_target`` or the wave dies out (an empty frontier), or
    ``max_rounds``. Returns ``((dist, frontier, round), dict(rounds,
    coverage, messages))``. The loop reads one flag a round.
    ``adaptive_k > 0`` (a graph sharded with ``source_csr=True``) runs
    small-frontier rounds through the frontier-adaptive wave (see
    :func:`flood_until_coverage`); layers, rounds and messages equal the
    dense loop's. On a ring split over ranks each round's two counts (the
    wave's size and its sends) are summed in one exchange, so every rank
    tests the global frontier."""
    if adaptive_k > 0:
        return _hopdist_adaptive(sg, mesh, protocol, coverage_target,
                                 max_rounds, axis_name, state0, adaptive_k,
                                 comm)
    _check_mesh(sg, mesh)
    pass_ = _make_pass(sg, comm, "or", axis_name)
    dist, frontier, rnd = _hopdist_state0(sg, protocol, state0)
    nm, deg = sg.node_mask, sg.out_degree
    n = _n_live(sg).to(torch.float32)
    target = torch.tensor(coverage_target, dtype=torch.float32,
                          device=sg.device)
    covered, alive = _totals(sg, counts=((dist >= 0) & nm, frontier))
    messages = torch.zeros((), dtype=torch.int64, device=sg.device)
    rounds = 0
    while rounds < max_rounds and _device.host_bool(
            (alive > 0) & (covered.to(torch.float32) / n < target)):
        new = pass_(frontier) & (dist < 0) & nm
        rnd = rnd + 1
        dist = torch.where(new, rnd, dist)
        sent, alive = _totals(sg, counts=(torch.where(frontier, deg, 0), new))
        messages = messages + sent
        covered = covered + alive
        frontier = new
        rounds += 1
    return (dist, frontier, rnd), {
        "rounds": rounds, "coverage": float(covered.to(torch.float32) / n),
        "messages": int(messages)}


def hopdist_until_done(sg: ShardedGraph, mesh: RingMesh, protocol, *,
                       max_rounds: int = 1024, axis_name: str = DEFAULT_AXIS,
                       state0=None, adaptive_k: int = 0, comm=DEFAULT_COMM):
    """BFS until the wave dies out (or ``max_rounds``): the coverage loop
    with an unreachable target. ``rounds`` counts the final round that
    observes the emptied frontier; the max over ``dist`` is the source's
    eccentricity."""
    return hopdist_until_coverage(
        sg, mesh, protocol, coverage_target=2.0, max_rounds=max_rounds,
        axis_name=axis_name, state0=state0, adaptive_k=adaptive_k,
        comm=comm)


# ----------------------------------------- frontier-adaptive coverage loop
#
# The reference's ``_make_adaptive_wave``: rounds whose global frontier is
# small skip the ring. The frontier rides as one replicated list of node
# ids, and each shard gathers only its own edges from those senders
# through the sender-CSR view, in W-wide work items; the round runs dense
# (one ring OR pass) when the largest per-shard item count exceeds ``k``.
# The list is an all-gather of the shards' compacted ids in ring order:
# on one card the stacked ``[S, k]`` tensor itself, across ranks one
# gather through the process group (``mesh.gather_lists``), which also
# carries each shard's sends and covered count; the item budget is a
# ``pmax`` (``mesh.all_max`` across ranks). So a round costs two
# exchanges across ranks and none in one process, and every rank holds
# the same list, budget, counts and branch. Where the reference branches
# on the device (``lax.cond``), the port reads the item budget on the
# host once a round (one sync, counted in ``_device.SYNCS``); every other
# choice stays on the device: ``nonzero(size=k)`` is a cumsum + scatter
# compaction and the dense round's re-entry compaction is a
# ``torch.where`` over both results, exact because the budget saturates
# past ``k``.

#: The 0-based rounds of the latest frontier-adaptive ring run that took
#: the sparse path (the host reads the branch each round anyway).
LAST_SPARSE_ROUNDS: list = []

#: The first-claim dedup's losing claim.
_BIG = 2**31 - 1


def _compact_rows(flags: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """``ops/frontier.compact`` along dim 1 of ``flags [S, n]``: each
    row's first ``k`` set positions, ascending, then ``fill``. i64[S, k].
    The ranks come from one scan of the flattened flags less each row's
    start (a scan along rows of 125,008 runs one block a row)."""
    S, n = flags.shape
    flat = torch.cumsum(flags.reshape(-1), 0, dtype=torch.int64).reshape(S, n)
    starts = flat[:, -1] - flags.sum(1, dtype=torch.int64)
    rank = flat - starts[:, None] - 1
    target = torch.where(flags & (rank < k), rank, k)
    buf = torch.full((S, k + 1), fill, dtype=torch.int64, device=flags.device)
    # Unset flags all land in the spare column k, which is dropped.
    buf.scatter_(1, target, torch.arange(n, device=flags.device).expand(S, n))
    return buf[:, :k]


def _set_true_rows(flags: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``flags[d].at[idx[d]].set(True, mode="drop")`` per row, index
    ``n`` the drop sentinel. Contiguous, as the ring's hop needs it."""
    S, n = flags.shape
    out = torch.cat([flags, flags.new_zeros(S, 1)], dim=1)
    out.scatter_(1, idx.long(), torch.ones_like(idx, dtype=torch.bool))
    return out[:, :n].contiguous()


def _pack_global_frontier(k: int, local_ids: torch.Tensor,
                          local_count: torch.Tensor, pad_id: int):
    """The per-shard winner lists ``[S, k]`` packed at running offsets
    into one replicated ``i32[k]`` list, and the total count. Truncation
    past ``k`` is benign: the total then exceeds ``k`` and the next round
    runs dense, never reading the list."""
    S = local_ids.shape[0]
    counts = local_count.to(torch.int64)
    offs = torch.cumsum(counts, 0) - counts
    idx = torch.arange(k, device=local_ids.device)
    tpos = offs[:, None] + idx
    valid = (idx < counts[:, None]) & (tpos < k)
    out = torch.full((k + 1,), pad_id, dtype=torch.int32,
                     device=local_ids.device)
    # Valid positions are disjoint across shards; the rest hit slot k.
    out.scatter_(0, torch.where(valid, tpos, k).reshape(-1),
                 torch.where(valid, local_ids, pad_id).to(torch.int32)
                 .reshape(-1))
    return out[:k], counts.sum().to(torch.int32)


class _AdaptiveWave:
    """The adaptive wave's pieces over the shards held here (the
    reference's ``_make_adaptive_wave`` closures): :meth:`pack`,
    :meth:`item_budget`, :meth:`sparse_round`, :meth:`dense_round` and
    :meth:`round`, which picks one by the budget. Both rounds map ``(seen,
    frontier, F, fncount)`` to ``(seen, frontier, F, fncount, ficount,
    msgs, covered)``; ``F`` is the replicated ``i32[k]`` frontier list,
    ``fncount`` its node count, ``ficount`` its work-item budget, ``msgs``
    the round's sends and ``covered`` the covered live nodes, each the
    whole ring's (i64 counts)."""

    def __init__(self, sg: ShardedGraph, comm, k: int, axis_name: str):
        S, L, block = sg.n_shards, sg.n_local, sg.block
        self.sg, self.k = sg, int(k)
        self.mesh = _rank_mesh(sg)
        self.pass_ = _make_pass(sg, comm, "or", axis_name)
        self.span = max(sg.csr_span, 1)
        self.w = max(1, min(self.span, 128))  # work-item slice width
        self.pad_id = S * block - 1
        dev = sg.device
        self.idx_k = torch.arange(self.k, device=dev)
        # The global ids of the shards held here, and the ring steps.
        self.my = torch.arange(sg.shard_lo, sg.shard_lo + L, device=dev)
        self.steps = torch.arange(S, device=dev)
        self.lanes = torch.arange(self.w, device=dev)
        self.flat_mask = sg.bkt_mask.reshape(L, -1)
        self.flat_dst = sg.bkt_dst.reshape(L, -1)
        self.offs = sg.csr_offsets.long()  # gathered twice a sparse round
        self.n_rounds = 0
        self.sparse_rounds = []

    def my_new_ids(self, new: torch.Tensor, local_count: torch.Tensor):
        """Each shard's new nodes as global ids, ``[L, k]``-padded."""
        lpos = _compact_rows(new, self.k, self.sg.block - 1)
        ids = self.my[:, None] * self.sg.block + lpos
        return torch.where(self.idx_k < local_count[:, None], ids,
                           self.pad_id)

    def _covered(self, seen: torch.Tensor) -> torch.Tensor:
        """Each shard's covered live nodes, ``[L]``."""
        return (seen & self.sg.node_mask).sum(1)

    def _sends(self, frontier: torch.Tensor) -> torch.Tensor:
        """Each shard's sends of a round from ``frontier``, ``[L]``."""
        return torch.where(frontier, self.sg.out_degree, 0).sum(1)

    def _share(self, local_ids, local_count, *partials):
        """The replicated list and node count packed from every shard's
        ``[L, k]`` ids and ``[L]`` counts, and the whole ring's sum of
        each ``[L]`` partial: one exchange across ranks."""
        lists, counts, cols = gather_lists(self.mesh, local_ids,
                                           local_count, *partials)
        F, ncount = _pack_global_frontier(self.k, lists, counts, self.pad_id)
        return F, ncount, [c.sum() for c in cols]

    def pack(self, frontier: torch.Tensor, seen: torch.Tensor):
        """``(F, fncount, covered)`` of the frontier ``[L, block]`` and the
        covered live nodes of ``seen``."""
        count = frontier.sum(1, dtype=torch.int32)
        F, ncount, (covered,) = self._share(
            self.my_new_ids(frontier, count), count, self._covered(seen))
        return F, ncount, covered

    def item_budget(self, F: torch.Tensor, ncount: torch.Tensor):
        """The sparse-mode budget of list ``F``: the largest per-shard
        W-slice work-item count (the reference's ``pmax``: one exchange
        across ranks), saturated at ``k + 1`` when the node list itself
        overflowed."""
        fvalid = self.idx_k < ncount
        f = torch.where(fvalid, F, self.pad_id).long()
        offs = self.sg.csr_offsets
        row_len = offs[:, f + 1] - offs[:, f]
        items = torch.where(fvalid, (row_len + self.w - 1) // self.w, 0)
        icount = _rank_max(self.sg, items.sum(1).max().to(torch.int32))
        return torch.where(ncount > self.k, self.k + 1, icount)

    def _slots(self, F, fvalid):
        """``(slot, svalid)``, ``[L, k, w]`` positions in each shard's
        sender-CSR rows of the list's work items."""
        L, k, w = self.sg.n_local, self.k, self.w
        f = torch.where(fvalid, F, self.pad_id).long()
        base_row, row_end = self.offs[:, f], self.offs[:, f + 1]  # [L, k]
        if self.span <= w:
            # No row is wider than a slice: item p is list entry p (the
            # node count is <= k in sparse mode).
            slot = base_row[..., None] + self.lanes
            return slot, (slot < row_end[..., None]) & fvalid[:, None]
        # Rows wider than a slice: expand the list into this shard's work
        # items (cumsum + searchsorted over k entries).
        items_per = torch.where(fvalid, (row_end - base_row + w - 1) // w, 0)
        c = torch.cumsum(items_per, 1)
        starts = c - items_per
        idx = self.idx_k.expand(L, k).contiguous()
        j = torch.searchsorted(c, idx, right=True).clamp(0, k - 1)
        base = base_row.gather(1, j) + (idx - starts.gather(1, j)) * w
        slot = base[..., None] + self.lanes
        svalid = (slot < row_end.gather(1, j)[..., None]) \
            & (idx < c[:, -1:])[..., None]
        return slot, svalid

    def sparse_round(self, seen, frontier, F, fncount):
        sg, k = self.sg, self.k
        S, L, block, nm = sg.n_shards, sg.n_local, sg.block, sg.node_mask
        sends = self._sends(frontier)
        fvalid = self.idx_k < fncount
        slot, svalid = self._slots(F, fvalid)
        svalid = svalid.reshape(L, -1)
        pos = sg.csr_pos.gather(
            1, torch.where(svalid, slot.reshape(L, -1), 0)).long()
        evalid = svalid & self.flat_mask.gather(1, pos)
        cand = torch.where(evalid, self.flat_dst.gather(1, pos),
                           block - 1).long()
        fresh = evalid & ~seen.gather(1, cand) & nm.gather(1, cand)
        if sg.dyn_capacity:
            # The frontier's runtime links: the global sender from the
            # ring step, membership by binary search in the sorted list
            # (the -1 sentinel never matches a node).
            g_send = (((self.my[:, None, None] - self.steps[None, :, None])
                       % S) * block + sg.dyn_src).reshape(-1)
            probe = torch.sort(torch.where(fvalid, F, -1).long()).values
            j = torch.searchsorted(probe, g_send).clamp(0, k - 1)
            member = (probe[j] == g_send).reshape(L, -1) \
                & sg.dyn_mask.reshape(L, -1)
            dcand = torch.where(member, sg.dyn_dst.reshape(L, -1),
                                block - 1).long()
            dfresh = member & ~seen.gather(1, dcand) & nm.gather(1, dcand)
            cand = torch.cat([cand, dcand], 1)
            fresh = torch.cat([fresh, dfresh], 1)
        # First-claim dedup onto each shard's own block: each fresh slot
        # claims its receiver with its position, the least claim wins.
        n_slots = cand.shape[1]
        order = torch.arange(n_slots, dtype=torch.int32, device=sg.device)
        claim = torch.where(fresh, order, _BIG)
        scratch = torch.full((L, block), _BIG, dtype=torch.int32,
                             device=sg.device)
        scratch.scatter_reduce_(1, cand, claim, "amin")
        winner = fresh & (scratch.gather(1, cand) == order)
        local_count = winner.sum(1, dtype=torch.int32)
        seen = _set_true_rows(seen, torch.where(fresh, cand, block))
        frontier = _set_true_rows(torch.zeros_like(seen),
                                  torch.where(winner, cand, block))
        wpos = _compact_rows(winner, k, n_slots - 1)
        local_ids = torch.where(self.idx_k < local_count[:, None],
                                self.my[:, None] * block
                                + cand.gather(1, wpos), self.pad_id)
        F, ncount, (msgs, covered) = self._share(
            local_ids, local_count, sends, self._covered(seen))
        return (seen, frontier, F, ncount, self.item_budget(F, ncount),
                msgs, covered)

    def dense_round(self, seen, frontier, F, fncount):
        sg = self.sg
        sends = self._sends(frontier)
        new = self.pass_(frontier) & ~seen & sg.node_mask
        seen = seen | new
        count = new.sum(1, dtype=torch.int32)
        Fc, ncount, (msgs, covered) = self._share(
            self.my_new_ids(new, count), count, sends, self._covered(seen))
        # The budget saturates when ncount > k, so the stale list kept
        # then is never read.
        F = torch.where(ncount <= self.k, Fc, F)
        return (seen, new, F, ncount, self.item_budget(F, ncount), msgs,
                covered)

    def round(self, seen, frontier, F, fncount, ficount):
        """One round, sparse when the budget fits ``k`` (one host read of
        the budget, which every rank holds whole)."""
        self.n_rounds += 1
        if _device.host_bool(ficount <= self.k):
            self.sparse_rounds.append(self.n_rounds - 1)
            return self.sparse_round(seen, frontier, F, fncount)
        return self.dense_round(seen, frontier, F, fncount)


@dataclasses.dataclass(frozen=True)
class _AdaptiveFloodState:
    seen: torch.Tensor  # bool[L, block]
    frontier: torch.Tensor  # bool[L, block]
    F: torch.Tensor  # i32[k], replicated frontier list
    fncount: torch.Tensor  # i32[]
    ficount: torch.Tensor  # i32[]


@dataclasses.dataclass(frozen=True)
class _RingAdaptiveFlood:
    """The adaptive wave's round as a protocol of the port's engine, with
    :class:`_RingFlood`'s stats, so the summary is the dense loop's: the
    frontier's live count is the list's node count (every new node is
    live), and the round's counts come with the list's exchange."""

    wave: _AdaptiveWave

    STATS = _RingFlood.STATS

    def coverage(self, sg, state) -> torch.Tensor:
        return _RingFlood.coverage(self, sg, state)

    def step(self, sg, state: _AdaptiveFloodState, key):
        seen, frontier, F_, fncount, ficount, msgs, covered = \
            self.wave.round(state.seen, state.frontier, state.F,
                            state.fncount, state.ficount)
        n = live_nodes(sg)
        stats = {
            "messages": msgs,
            "coverage": _ratio(covered, n),
            "frontier": fncount,
            "frontier_occupancy": _ratio(fncount, n),
        }
        return _AdaptiveFloodState(seen, frontier, F_, fncount,
                                   ficount), stats


def _adaptive_wave(sg, mesh, comm, adaptive_k, axis_name):
    """Check the adaptive loop's graph and build its wave."""
    if sg.csr_pos is None:
        raise ValueError(
            "adaptive_k requires a sender-CSR sharded graph — build "
            "with shard_graph(source_csr=True)")
    _check_mesh(sg, mesh)
    return _AdaptiveWave(sg, comm, adaptive_k, axis_name)


def _flood_adaptive(sg, mesh, source, coverage_target, max_rounds, state0,
                    return_state, adaptive_k, comm, recorder):
    """:func:`flood_until_coverage` on the adaptive wave, through the
    engine's coverage loop: its exit flag and the wave's branch are the
    two host reads a round."""
    if recorder is not None:
        raise ValueError(
            "the flight recorder is not supported on the adaptive "
            "frontier-sparse path — record the dense loop (adaptive_k=0)")
    if not isinstance(comm, str):
        raise ValueError(
            "fault-spec comms are not supported on the adaptive "
            "frontier-sparse path — inject on the dense loop (adaptive_k=0)")
    wave = _adaptive_wave(sg, mesh, comm, adaptive_k, mesh.axis_name)
    seen0, frontier0 = state0 if state0 is not None \
        else init_state(sg, Flood(source=source))
    F0, ncount0, _ = wave.pack(frontier0, seen0)
    state = _AdaptiveFloodState(seen0, frontier0, F0, ncount0,
                                wave.item_budget(F0, ncount0))
    state, out = engine.run_until_coverage_from(
        sg, _RingAdaptiveFlood(wave), state, prng.key(0),
        coverage_target=coverage_target, max_rounds=max_rounds)
    LAST_SPARSE_ROUNDS[:] = wave.sparse_rounds
    if return_state:
        return (state.seen, state.frontier), out
    return state.seen, out


def _hopdist_adaptive(sg, mesh, protocol, coverage_target, max_rounds,
                      axis_name, state0, adaptive_k, comm):
    """:func:`hopdist_until_coverage` on the adaptive wave: the dense BFS
    loop's exit rule (coverage, wave death or ``max_rounds``), ``seen``
    carried beside ``dist``, one exit read and one branch read a
    round."""
    wave = _adaptive_wave(sg, mesh, comm, adaptive_k, axis_name)
    dist, frontier, rnd = _hopdist_state0(sg, protocol, state0)
    n = _n_live(sg).to(torch.float32)
    target = torch.tensor(coverage_target, dtype=torch.float32,
                          device=sg.device)
    seen = (dist >= 0) & sg.node_mask
    F_, fncount, covered = wave.pack(frontier, seen)
    ficount = wave.item_budget(F_, fncount)
    messages = torch.zeros((), dtype=torch.int64, device=sg.device)
    rounds = 0
    while rounds < max_rounds and _device.host_bool(
            (fncount > 0) & (covered.to(torch.float32) / n < target)):
        seen, frontier, F_, fncount, ficount, msgs, covered = wave.round(
            seen, frontier, F_, fncount, ficount)
        messages = messages + msgs
        rnd = rnd + 1
        dist = torch.where(frontier, rnd, dist)
        rounds += 1
    LAST_SPARSE_ROUNDS[:] = wave.sparse_rounds
    return (dist, frontier, rnd), {
        "rounds": rounds, "coverage": float(covered.to(torch.float32) / n),
        "messages": int(messages)}


# ---------------------------------------------------------- leader election


def leader_until_quiet(sg: ShardedGraph, mesh: RingMesh, *,
                       max_rounds: int = 1024, axis_name: str = DEFAULT_AXIS,
                       comm=DEFAULT_COMM):
    """Highest-live-id leader election run until no node learns anything
    (``models/leader.py`` under ``run_until_converged(stat="changed",
    threshold=1)``): nodes re-broadcast only the round after they learned
    a better candidate, by a ring max pass of i32 ids; the loop ends on
    the first quiet round, which is executed and counted. Returns
    ``(known [S, block] i32, dict(rounds, coverage, messages))``,
    ``coverage`` the share of live nodes agreeing on the global winner.
    Needs the segment layout (max aggregation). On a ring split over ranks
    the max pass rides B2 on i32 across ranks and each round's quiet test
    and sends are one exchange."""
    if sg.mxu_src is not None:
        raise ValueError(
            "leader_until_quiet cannot ride the MXU one-hot layout — "
            "shard_graph without hybrid/min_count for max aggregation")
    _check_mesh(sg, mesh)
    pass_ = _make_pass(sg, comm, "max", axis_name)
    nm, deg = sg.node_mask, sg.out_degree
    neutral = neutral_min(torch.int32)
    lo = sg.shard_lo * sg.block
    ids = torch.arange(lo, lo + nm.numel(), dtype=torch.int32,
                       device=sg.device).reshape(nm.shape)
    known, frontier = torch.where(nm, ids, -1), nm
    changed, = _totals(sg, counts=(nm,))
    messages = torch.zeros((), dtype=torch.int64, device=sg.device)
    rounds = 0
    while rounds < max_rounds and _device.host_bool(changed > 0):
        sent = torch.where(frontier, deg, 0)
        heard = pass_(torch.where(frontier, known, neutral))
        new_known = torch.where(nm, torch.maximum(known, heard), -1)
        frontier = (new_known != known) & nm
        sent, changed = _totals(sg, counts=(sent, frontier))
        messages = messages + sent
        known = new_known
        rounds += 1
    top, = _totals(sg, maxes=(known,))
    agreed, = _totals(sg, counts=((known == top) & nm,))
    return known, {"rounds": rounds,
                   "coverage": float(_over_live(agreed, sg)),
                   "messages": int(messages)}


# ------------------------------------------------------------ random walks


@dataclasses.dataclass(frozen=True)
class _RingWalk:
    """The walker cohort's round on the ring (``models/walk.py``).
    Positions are replicated ``[W]``; each shard scores the candidates
    into its own node block through its sender-CSR view over the bucket
    arrays (re-masks and runtime links need no rebuild). Every candidate's
    uniform is keyed by the edge's identity (``utils/edgehash.py``), so the
    global choice is the max over the shards' maxima, ties to the higher
    receiver id: the reference's ``pmax`` pair, and the engine's draw. The
    state is ``(pos, visited)``. On a ring split over ranks each rank
    scores the candidates into its own shards, the two maxima are taken
    over the ranks (:func:`_rank_max`, two exchanges a round), ``visited``
    holds the rank's rows and its count is summed in a third."""

    start: torch.Tensor  # i32[W]
    alive_start: torch.Tensor  # bool[W]
    span: int
    restart_p: float

    STATS = ("messages", "coverage", "stuck")

    def coverage(self, sg, state):
        visited, = _totals(sg, counts=(state[1] & sg.node_mask,))
        return _over_live(visited, sg)

    def step(self, sg, state, key):
        pos, visited = state
        S, block, dev = sg.n_shards, sg.block, sg.device
        L, lo = sg.n_local, sg.shard_lo
        W = pos.shape[0]
        k_edge, k_restart = prng.split(key)
        nm = sg.node_mask
        shards = torch.arange(lo, lo + L, dtype=torch.int32, device=dev)
        shard_base = (shards * block)[:, None, None]
        walkers = torch.arange(W, dtype=torch.int32, device=dev)[:, None]

        p = pos.long()
        base = sg.csr_offsets[:, p]  # [S, W]
        slot = base[..., None] + torch.arange(self.span, device=dev)
        svalid = slot < sg.csr_offsets[:, p + 1][..., None]
        # Out-of-row slots read slot 0 and are masked (the padding of
        # csr_pos stays in bounds but can alias live slots).
        at = sg.csr_pos.gather(
            1, torch.where(svalid, slot, 0).reshape(L, -1).long())
        flat_dst = sg.bkt_dst.reshape(L, -1)
        dst_local = flat_dst.gather(1, at.long())
        live = (svalid.reshape(L, -1)
                & sg.bkt_mask.reshape(L, -1).gather(1, at.long())
                & nm.gather(1, dst_local.long())).reshape(svalid.shape)
        rcv = shard_base + dst_local.reshape(svalid.shape)
        u = torch.where(live, edge_uniform(k_edge, walkers, pos[:, None],
                                           rcv), -1.0)
        m_loc = u.amax(dim=2)
        r_loc = torch.where(live & (u == m_loc[..., None]), rcv,
                            -1).amax(dim=2)
        if sg.dyn_capacity:
            # Runtime out-edges: global senders from the ring step,
            # membership-tested against the cohort ([S, W, S * K]).
            K = sg.dyn_capacity
            t = torch.arange(S, dtype=torch.int32, device=dev)
            g_send = (((shards[:, None] - t[None, :]) % S)[..., None] * block
                      + sg.dyn_src).reshape(L, 1, S * K)
            d_dst = sg.dyn_dst.reshape(L, S * K)
            member = ((g_send == pos[None, :, None])
                      & sg.dyn_mask.reshape(L, 1, S * K)
                      & nm.gather(1, d_dst.long())[:, None])
            drcv = (shard_base[..., 0] + d_dst)[:, None].expand(member.shape)
            du = torch.where(member, edge_uniform(k_edge, walkers,
                                                  pos[:, None], drcv), -1.0)
            dm = du.amax(dim=2)
            dr = torch.where(member & (du == dm[..., None]), drcv,
                             -1).amax(dim=2)
            r_loc = torch.where(dm > m_loc, dr, torch.where(
                dm == m_loc, torch.maximum(r_loc, dr), r_loc))
            m_loc = torch.maximum(m_loc, dm)
        m = _rank_max(sg, m_loc.amax(dim=0))
        r = _rank_max(sg, torch.where((m_loc == m) & (m >= 0), r_loc,
                                      -1).amax(dim=0))
        can_move = m >= 0.0
        dest = torch.where(can_move, r, pos)
        if self.restart_p > 0.0:
            restart = ((prng.uniform(k_restart, (W,), device=dev)
                        < self.restart_p) & self.alive_start)
            dest = torch.where(restart, self.start, dest)
            moved = (restart | can_move) & (dest != pos)
        else:
            moved = can_move & (dest != pos)
        visited = _mark(sg, visited, dest)
        covered, = _totals(sg, counts=(visited,))
        # The cohort is replicated: its counts need no exchange.
        stats = {"messages": moved.sum(dtype=torch.int32),
                 "coverage": _over_live(covered, sg),
                 "stuck": (~can_move).sum(dtype=torch.int32)}
        return (dest, visited), stats


def _mark(sg: ShardedGraph, flags: torch.Tensor, ids: torch.Tensor
          ) -> torch.Tensor:
    """``flags [n_local, block]`` with the global node ``ids`` set where
    they fall in the shards held here, masked to live nodes (no host
    read: the ids of other ranks' shards land in a dropped slot)."""
    n = flags.numel()
    at = ids.long() - sg.shard_lo * sg.block
    flat = torch.cat([flags.reshape(-1), flags.new_zeros(1)])
    flat[torch.where((at >= 0) & (at < n), at, n)] = True
    return flat[:n].reshape(flags.shape) & sg.node_mask


def _walk_start(sg: ShardedGraph, mesh: RingMesh, protocol, state0):
    """``(walk round, (pos, visited), start)``: ``RandomWalks.init``'s
    walkers (evenly spread over the live ids) unless ``state0 = (pos,
    start, visited)`` resumes a run. On a ring split over ranks the live
    ids are the whole ring's (one gather of the liveness), the positions
    replicated and ``visited`` the rank's rows."""
    if sg.csr_pos is None:
        raise ValueError(
            "the sharded walk requires a sender-CSR sharded graph — build "
            "with shard_graph(source_csr=True)")
    _check_mesh(sg, mesh)
    alive = global_node_mask(sg).reshape(-1)
    if state0 is None:
        live_ids = torch.nonzero(alive).reshape(-1)
        W = protocol.n_walkers
        if live_ids.numel():
            n_live = live_ids.numel()
            stride = max(n_live // W, 1)
            idx = (torch.arange(W, device=sg.device) * stride) % n_live
            pos = live_ids[idx].to(torch.int32)
        else:
            pos = torch.zeros(W, dtype=torch.int32, device=sg.device)
        visited = _mark(sg, torch.zeros_like(sg.node_mask), pos)
        start = pos
    else:
        pos, start, visited = state0
    proto = _RingWalk(start=start, alive_start=alive[start.long()],
                      span=max(sg.csr_span, 1),
                      restart_p=float(np.float32(protocol.restart_p)))
    return proto, (pos, visited), start


def walk(sg: ShardedGraph, mesh: RingMesh, protocol, key, rounds: int,
         axis_name: str = DEFAULT_AXIS, state0=None,
         return_state: bool = False):
    """Run ``rounds`` of the walker cohort (``models/walk.py``
    ``RandomWalks``) on the ring: ``engine.run``'s run, bit for bit, for
    any shard count (the draws are keyed by edge identity). Returns
    ``(visited [S, block] bool, stats)``; with ``return_state=True``
    ``((pos, start, visited), stats)``, the triple :func:`walk` and
    :func:`walk_until_coverage` resume from."""
    proto, state, start = _walk_start(sg, mesh, protocol, state0)
    (pos, visited), stats = engine._run_from(sg, proto, state, key,
                                             int(rounds), None)
    if return_state:
        return (pos, start, visited), stats
    return visited, stats


def walk_until_coverage(sg: ShardedGraph, mesh: RingMesh, protocol, key, *,
                        coverage_target: float = 0.99, max_rounds: int = 1024,
                        steps_per_round: int = 1,
                        axis_name: str = DEFAULT_AXIS, state0=None,
                        return_state: bool = False):
    """Walk until the cohort has visited ``coverage_target`` of the live
    population (``engine.run_until_coverage`` with ``RandomWalks``; the
    key chain split each round), ``steps_per_round`` rounds a super-step.
    Returns ``(visited, dict(rounds, coverage, messages))``; with
    ``return_state=True`` ``((pos, start, visited), dict)``."""
    if steps_per_round < 1:
        raise ValueError(
            f"steps_per_round must be >= 1, got {steps_per_round}")
    proto, state, start = _walk_start(sg, mesh, protocol, state0)
    target = torch.tensor(coverage_target, dtype=torch.float32,
                          device=sg.device)
    (pos, visited), out = engine._stat_while(
        sg, proto, state, key, stat="coverage",
        keep_going=lambda v, r: (v < target) & (r < max_rounds),
        value0=proto.coverage(sg, state), loop="coverage_sharded",
        value_name="coverage", steps_per_round=int(steps_per_round))
    if return_state:
        return (pos, start, visited), out
    return visited, out


# --------------------------------------------------- lane-word batched plane
#
# The batched message plane packs 32 concurrent floods per i32 word
# (``ops/bitset.py``; ``models/messagebatch.py``). Here the lane words are
# the halo payload: the resident block becomes ``[S, W, block]``, so one
# hop a ring step (B2 on the whole word stack) moves the boundary state of
# every in-flight message at once.


def _require_lanes_layout(sg: ShardedGraph, what: str) -> None:
    if sg.mxu_src is not None:
        raise ValueError(
            f"{what} cannot ride the MXU one-hot layout — shard_graph "
            "without hybrid/min_count for the lane-packed batched path "
            "(word-level OR has no one-hot-matmul form)")


def _lane_runs(sg: ShardedGraph):
    """The segment buckets' receivers as one sorted id space a step:
    ``seg [S, S, E]`` (shard ``d``'s ids offset by ``d * (block + E)``;
    the padding slots past each bucket's last used slot get ids of their
    own past the block, so they join no receiver's run) and the longest
    run of one receiver (one counted sync), which bounds the OR scan. On
    a ring split over ranks both are the rank's own (``[n_local, S,
    E]``): the scan has no collective inside, and a longer bound than
    another rank's changes no result, so the read stays rank-local."""
    L, B = sg.n_local, sg.block
    E = sg.bkt_dst.shape[-1]
    # A slot is used unless it is (src 0, dst block - 1, masked): padding.
    used = sg.bkt_mask | (sg.bkt_src != 0) | (sg.bkt_dst != B - 1)
    extent = torch.where(used.any(dim=-1),
                         E - used.flip(-1).to(torch.uint8).argmax(dim=-1), 0)
    idx = torch.arange(E, device=sg.device)
    seg = torch.where(idx >= extent[..., None], B + idx, sg.bkt_dst.long())
    seg = seg + (torch.arange(L, device=sg.device) * (B + E))[:, None, None]
    _, counts = torch.unique_consecutive(seg, return_counts=True)
    _device.SYNCS += 1
    return seg, max(int(counts.max()), 1) if counts.numel() else 1


def _make_or_lanes_pass(sg: ShardedGraph, comm, axis_name: str):
    """``pass_(lanes [S, W, block] i32) -> [S, W, block]``: one ring
    rotation OR-ing every lane of every word over every incoming edge
    (the segment buckets, then the dynamic region's). A bucket's words
    are OR-reduced within each receiver's run of the sorted buckets
    (``ops/bitset.py`` ``or_sorted_lanes``: no bit planes, no atomics on
    the padding's one receiver); the dynamic region's unsorted slots by
    ``or_scatter_lanes``. The hop moves the whole word stack (B2; across
    ranks one ``ring_gather`` a pass of the rank's ``[n_local, W,
    block]``)."""
    S, L, B = sg.n_shards, sg.n_local, sg.block
    E = sg.bkt_dst.shape[-1]
    comm_obj = _make_ring_comm(comm, axis_name, sg)
    seg, span = _lane_runs(sg)
    n_ids = L * (B + E)
    shard_off = (torch.arange(L, device=sg.device) * B)[:, None]

    def gathered(rot, src, mask):  # rot [L, W, B]; src/mask [L, K]
        W = rot.shape[1]
        idx = src.long()[:, None, :].expand(L, W, src.shape[-1])
        return torch.where(mask[:, None, :], rot.gather(2, idx), 0)

    def apply(rot, t):
        W = rot.shape[1]
        words = gathered(rot, sg.bkt_src[:, t], sg.bkt_mask[:, t])
        out = BS.or_sorted_lanes(n_ids, seg[:, t].reshape(-1),
                                 words.transpose(0, 1).reshape(W, -1), span)
        out = out.reshape(W, L, B + E)[..., :B].transpose(0, 1)
        if sg.dyn_capacity:
            dmask = sg.dyn_mask[:, t]
            dst = torch.where(dmask, shard_off + sg.dyn_dst[:, t],
                              L * B).reshape(-1)
            words = gathered(rot, sg.dyn_src[:, t], dmask)
            dyn = BS.or_scatter_lanes(L * B, dst, words.transpose(
                0, 1).reshape(W, -1))
            out = out | dyn.reshape(W, L, B).transpose(0, 1)
        return out

    def pass_(lanes):
        acc = torch.zeros_like(lanes)
        for t, rot in enumerate(_rotations(comm_obj, lanes.contiguous(), S)):
            acc = acc | apply(rot, t)
        return acc

    pass_.comm = comm_obj
    return pass_


def _node_lanes(sg: ShardedGraph) -> torch.Tensor:
    """All 32 lanes set at live nodes, ``i32[S, 1, block]``."""
    return torch.where(sg.node_mask, -1, 0).to(torch.int32)[:, None]


def shard_lanes(sg: ShardedGraph, lanes) -> torch.Tensor:
    """A lane-word stack ``[W, N_pad]`` (``MessageBatch``'s layout) as
    ``[S, W, block]``, the node axis zero-padded to the shard grid (a
    rank's part: its own shards' ``[n_local, W, block]``)."""
    lanes = torch.as_tensor(lanes, device=sg.device)
    pad = sg.n_nodes_padded - lanes.shape[1]
    if pad:
        lanes = torch.nn.functional.pad(lanes, (0, pad))
    w = lanes.shape[0]
    lo = sg.shard_lo
    return lanes.reshape(w, sg.n_shards, sg.block).transpose(0, 1)[
        lo:lo + sg.n_local].contiguous()


def unshard_lanes(sg: ShardedGraph, lanes: torch.Tensor,
                  n_pad: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`shard_lanes`: ``[S, W, block] -> [W, n_pad]``
    (``n_pad`` defaults to the full grid ``S * block``). On a ring split
    over ranks every rank passes its ``[n_local, W, block]`` and gets the
    whole stack (one gather)."""
    lanes = _shard_rows(sg, lanes.contiguous())
    flat = lanes.transpose(0, 1).reshape(lanes.shape[1], -1)
    return flat if n_pad is None else flat[:, :n_pad].contiguous()


def propagate_or_lanes(sg: ShardedGraph, mesh: RingMesh, lanes: torch.Tensor,
                       axis_name: str = DEFAULT_AXIS,
                       comm=DEFAULT_COMM) -> torch.Tensor:
    """Lane-packed neighbor-OR over the sharded graph (the ring's
    ``ops/segment.propagate_or_lanes``): 32 W boolean signals advanced by
    one ring pass, the lane words as the halo payload. ``lanes`` is ``[S,
    W, block]`` (:func:`shard_lanes`); returns the same layout, masked to
    live nodes. Runtime links fold in; needs the segment layout."""
    _require_lanes_layout(sg, "propagate_or_lanes")
    _check_mesh(sg, mesh)
    pass_ = _make_or_lanes_pass(sg, comm, axis_name)
    return pass_(lanes) & _node_lanes(sg)


def _ring_batch_loop(sg, pass_, batch, max_rounds, fault_round0, ring=None):
    """``engine``'s batched loop on the ring, lane for lane
    ``BatchFlood.step``: the same dedup against node-masked words, the
    per-lane coverage numerators by ``lane_counts`` over every shard, the
    latch, the per-word sends and the union-frontier occupancy. One exit
    flag read a round. Returns the final ``[S, W, block]`` planes, the
    lane metadata and the run's device totals. With ``ring`` (a flight
    ring) the run writes the engine's batch row for each round, with the
    loop's per-round byte estimate in ``ici_bytes``. On a ring split over
    ranks a round's per-lane counts and sends are summed as one vector in
    one exchange, so admit, retire and exit agree on every rank; the
    occupancy's per-round counts (and, recorded, the per-word sends the
    rows' ``new`` column adds) in one more at the end, integer numerators
    summed before any division."""
    dev = sg.device
    wire = fault_round0 is not None and getattr(pass_.comm, "wants_step",
                                                False)
    nm, node_lanes = sg.node_mask, _node_lanes(sg)
    n_live = _n_live(sg).to(torch.float32)
    deg = sg.out_degree.to(torch.int64)[:, None]
    seen, frontier, sent = (shard_lanes(sg, getattr(batch, f))
                            for f in ("seen", "frontier", "sent"))
    done, rounds_l, seen_count = batch.done, batch.rounds, batch.seen_count
    admitted, target = batch.admitted, batch.target
    W = seen.shape[1]
    messages = torch.zeros((), dtype=torch.int64, device=dev)
    # A round's rank-local numerators (the union frontier's live count,
    # recorded: the per-word sends) and, recorded, its whole-ring columns.
    local, rows = [], []
    r = 0
    while r < max_rounds and _device.host_bool((admitted & ~done).any()):
        if wire:
            pass_.comm.set_context(round=fault_round0 + r)
        live = admitted & ~done
        live_mask = BS.pack_bits(live)[None, :, None]
        front = frontier & live_mask
        new = pass_(front) & node_lanes & ~seen & live_mask
        seen, sent = seen | new, sent | front
        words = (deg * BS.popcount_words(front)).sum(dim=(0, 2))
        counts = BS.lane_counts(new.transpose(0, 1).reshape(W, -1)
                                ).reshape(-1)
        counts, = _rank_sums(sg, torch.cat([counts.to(torch.int64),
                                            words.sum().reshape(1)]))
        messages = messages + counts[-1]
        seen_count = seen_count + counts[:-1].to(seen_count.dtype)
        done = done | (admitted & (seen_count.to(torch.float32) / n_live
                                   >= target))
        rounds_l = rounds_l + live.to(torch.int32)
        running = admitted & ~done
        frontier = new & BS.pack_bits(running)[None, :, None]
        occ_count = ((frontier != 0).any(dim=1) & nm).sum().reshape(1)
        if ring is None:
            local.append(occ_count)
        else:
            local.append(torch.cat([occ_count, words]))
            # The engine's batch row's whole-ring columns; f32 sums in
            # XLA's order.
            rows.append(torch.stack([
                flightrec.total_f32(*flightrec.limbs(messages)),
                accum.ordered_sum(seen_count.to(torch.float32)),
                running.sum().to(torch.float32)]))
        r += 1
    occ = torch.zeros((), dtype=torch.float32, device=dev)
    if local:
        summed = _rank_sums(sg, torch.stack(local))[0]
        for c in summed[:, 0]:
            occ = occ + c.to(torch.float32) / n_live
        if ring is not None:
            total, coverage, active = torch.stack(rows).unbind(1)
            flightrec.write_rows(
                ring, 0, occupancy=summed[:, 0].to(torch.float32) / n_live,
                new=rowsum.row_sum(summed[:, 1:].to(torch.float32)),
                total=total, coverage=coverage, active_lanes=active,
                ici_bytes=float(commviz.ici_round_bytes(
                    "batch", sg.n_shards, sg.block, n_words=W,
                    comm=pass_.comm.backend)))
    return ((seen, frontier, sent), (done, rounds_l, seen_count),
            (r, messages, occ))


def run_batch_until_coverage(sg: ShardedGraph, mesh: RingMesh, protocol,
                             batch, key=None, *, max_rounds: int = 1024,
                             axis_name: str = DEFAULT_AXIS, comm=DEFAULT_COMM,
                             donate: bool = True, recorder=None,
                             fault_round0: int = 0):
    """Advance every in-flight message of a lane-packed batch on the ring
    until each admitted lane reaches its coverage target (or
    ``max_rounds``): ``engine.run_batch_until_coverage`` on the sharded
    graph, its per-lane results, round counts and summary dict those of
    the single-device loop on the same batch. ``batch`` is a single-device
    ``MessageBatch`` (admission stays on the host side); it is sharded per
    call and returned in its own layout, refreshed at entry against the
    sharded graph's current liveness. ``protocol`` supplies nothing but
    its name (the ring has one lane lowering); ``key`` is unused, and
    ``donate`` has no effect (torch has no buffer donation). Needs the
    segment layout. ``comm`` also takes a ``chaos/device.FaultSpec``, its
    hop faults keyed on the global round ``fault_round0 + r`` and counted
    after the run. ``recorder`` (a ``FlightRecorder``) writes the engine
    loop's row a round (the same columns, and in ``ici_bytes`` the
    loop's per-round byte estimate, ``parallel/commviz.py``) and
    attaches ``out["flight_record"]``; the results equal a run without
    it. On a ring split over ranks every rank makes the same call with
    the same ``batch`` (replicated) and gets the same result, its
    recorded rows included."""
    chaos_device.dispatch_gate("sharded-batch")
    _require_lanes_layout(sg, "sharded run_batch_until_coverage")
    _check_mesh(sg, mesh)
    del key, donate  # the batched flood draws nothing; no donation
    t0 = time.perf_counter()
    n_pad = batch.seen.shape[1]
    tracer = spans.current_tracer()
    snap = engine._lane_snapshot(batch) if tracer is not None else None
    with spans.span("batch_run", loop="sharded", max_rounds=max_rounds):
        if snap is not None:
            engine._emit_batch_entry_events(*snap)
        done0 = batch.done.clone()
        # Entry refresh (BatchFlood.refresh) against the ring's liveness.
        nm_flat = global_node_mask(sg).reshape(-1)[:n_pad]
        seen_count = BS.lane_counts(
            batch.seen & torch.where(nm_flat, -1, 0).to(torch.int32)
        ).reshape(-1)
        n_live = _n_live(sg).to(torch.float32)
        batch = dataclasses.replace(
            batch, seen_count=seen_count,
            done=batch.done | (batch.admitted & (seen_count.to(
                torch.float32) / n_live >= batch.target)))
        pass_ = _make_or_lanes_pass(sg, comm, axis_name)
        ring = None if recorder is None else recorder.init(sg.device)
        planes, lanes, (r, messages, occ) = _ring_batch_loop(
            sg, pass_, batch, max_rounds, fault_round0, ring)
        done, rounds_l, seen_count = lanes
        rounds = torch.tensor(r, dtype=torch.int32, device=sg.device)
        packed = accum.pack_batch_summary(
            rounds, (batch.admitted & ~done).sum(), done.sum(), messages,
            occ / max(r, 1), BS.pack_bits(done), rounds_l)
        t1 = time.perf_counter()
        host, done0 = engine._summary(packed, done0)
        out = accum.unpack_batch_summary(host, batch.n_words)
        _record_comm_faults(comm, out["rounds"], sg.n_shards,
                            round0=fault_round0)
        if ring is not None:
            out["flight_record"] = flightrec.trim(ring, out["rounds"])
        # The three planes in one gather on a ring split over ranks.
        seen, frontier, sent = unshard_lanes(
            sg, torch.cat(planes, dim=1), n_pad).split(planes[0].shape[1])
        batch = dataclasses.replace(
            batch, seen=seen, frontier=frontier, sent=sent, done=done,
            rounds=rounds_l, seen_count=seen_count)
        newly_rounds = engine._newly_completed(out, done0)
        t2 = time.perf_counter()
        if snap is not None:
            engine._emit_batch_exit_events(snap[0], snap[1], out)
        engine._record_batch_summary(
            t2 - t0, t2 - t1, engine._nbytes(packed, ring), out, newly_rounds,
            type(protocol).__name__)
    return batch, out
