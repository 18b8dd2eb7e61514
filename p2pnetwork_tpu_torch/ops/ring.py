"""Ring halo hop and fused ring step: the hand-written CUDA kernels and
their plain versions, for a ring whose S shards are stacked on one card.

Replaces ``p2pnetwork_tpu/ops/pallas_ring.py``:

- :func:`ring_shift` — ``_ring_halo_copy_kernel`` (B2), one hop: forward,
  shard ``d`` receives shard ``(d - 1) mod S``'s block (``lax.ppermute``
  with ``[(i, (i + 1) % S)]``); ``reverse=True`` the other way. The
  identity at ``S = 1``.
- :func:`ring_segment_sum_or` / :func:`ring_segment_sum_sum` —
  ``_ring_halo_segsum_kernel`` (B3), ``(rot_next, out)``: the forward hop
  of ``rot`` fused into the same launch as B1's segment sum of every
  shard's bucket, shard ``d``'s rows reading ``rot[d, src]``
  (``ops/segsum.py``). ``S < 2`` is refused, as the reference refuses it.

On the TPU each shard is a chip and the hop a DMA between chips. Here the
shards are the leading axis of one tensor, so the hop is a device-local
copy with a rotated shard index (``csrc/ring.cu``), out of place: the ring
issues it before the step's bucket applies, which read the resident
block. Both kernels are bound by device-memory bytes: B2 reads and writes
each byte once (~0.6 us for the bool ``[8, 125008]`` frontier at
3.35 TB/s, so launch latency dominates); in B3 the bucket bytes of B1
dominate and the hop rides in copy blocks beside the row reductions.
B3 takes each row's extent (``ShardedGraph.mxu_extent``): the ring's
buckets are padded to the widest, and on a graph whose edges are mostly
local (the 1M Watts-Strogatz ring) every step's rows but the first are
nearly all padding, which B3 then does not read.

Exactness: the hop and OR are bit-exact. The f32 sum adds in f32 with
shared-memory atomics: exact on integer-valued signals, otherwise held to
``rtol = atol = 1e-5``; non-finite terms spread over their row as the
reference's one-hot product spreads them (``ops/segsum.py``). The reference asks for ``exact=False`` there (one
bf16 pass on a TPU, f32 on the CPU interpreter); the port always sums
f32 terms.

A CUDA tensor always goes to the kernel (or the wrapper raises); a CPU
tensor goes to the plain version. ``SHIFT_LAUNCHES`` and
``SEGSUM_LAUNCHES`` count kernel launches; ``SHIFT_BACK_LAUNCHES`` counts
the reverse hops among B2's (the liveness re-mask's Horner fold,
``parallel/sharded.py``).

**Across ranks** (a ring split over processes, ``parallel/multihost.py``:
each rank holds ``n_local`` consecutive shards of the ``S``), B2 and B3
have cross-rank forms (``csrc/ring_peer.cu``). A ring pass rotates a
block that stays fixed for the pass, so it moves it in one exchange:

- :func:`ring_gather` — B2 a pass at a time: every rank's stack written
  into every rank's ``[2S, ...]`` slab in ring order (each block twice,
  so :func:`ring_rows` gives any step's rows as a view), one put kernel
  of CUDA IPC peer writes and one stream wait a pass, where ``S - 1``
  hops took ``S - 1`` hand-overs between the ranks' contexts;
- :func:`ring_pass_segsum_or` / ``_sum`` — B3 a pass at a time: every
  step's segment sum of the rank's MXU buckets over the gathered slab in
  one launch, each output row owned by one worker that loops over the
  steps;
- :func:`ring_put` — B2 a hop at a time, for payloads that change from
  hop to hop (a faulted hop, the re-mask's reverse fold): the local
  shards roll by one and the rank's boundary shard (the last forward,
  the first reverse) goes to the next (previous) rank's receive slot.
  Its result is this rank's rows of ``ring_shift`` of the ``[S, ...]``
  stack.

Memory a rank: the gather's two slabs (by pass parity) of ``2S`` blocks
of the largest payload gathered, e.g. 4 MB for the 1M bool frontier
(``[8, 125008]``), 16 MB for f32, 51.2 MB for the 100K ring's lane words
(``[8, 32, 12512]`` i32); a hop's four slots of the largest shard.

The gather areas (:class:`GatherChannel`) and the hops' receive slots
(:class:`PeerChannel`) are allocated by ``cudaMalloc`` in each rank and
mapped into its peers (every peer, the two neighbours). A call enqueues,
on the current stream and without a host wait, a stream wait until the
peers have released the slab or slot it overwrites (their
acknowledgements of ``seq - 2``), the put kernel, whose last block to
finish signals the receivers with a system-scope release, and a stream
wait until this rank's own counter or flag shows that every sender's
put has landed (a hop then lands its slot with a copy kernel). The waits
are ``cuStreamWaitValue32`` (the GPU's front end polls the word; no
kernel spins), so ranks whose contexts time-slice one card still make
progress. The plain versions run on the host through gloo: an
``all_gather`` a pass, ``isend``/``irecv`` of the boundary shard a hop.
``GATHER_LAUNCHES``, ``PASS_SEGSUM_LAUNCHES`` and ``PUT_LAUNCHES`` count
the kernels, ``LAND_LAUNCHES`` the hops' land kernels.
"""

from __future__ import annotations

import ctypes
import datetime
import math

import torch

from p2pnetwork_tpu_torch import _build, _device
from p2pnetwork_tpu_torch.ops import segsum

#: Kernel launches made by :func:`ring_shift`, both directions.
SHIFT_LAUNCHES = 0
#: Those of them with ``reverse=True``.
SHIFT_BACK_LAUNCHES = 0
#: Kernel launches made by :func:`ring_segment_sum_or` / ``_sum``.
SEGSUM_LAUNCHES = 0
#: Put kernels launched by :func:`ring_put` (both directions).
PUT_LAUNCHES = 0
#: Land kernels, one after each put kernel.
LAND_LAUNCHES = 0
#: Put kernels launched by :func:`ring_gather`, one a ring pass.
GATHER_LAUNCHES = 0
#: Pass kernels launched by :func:`ring_pass_segsum_or` / ``_sum``.
PASS_SEGSUM_LAUNCHES = 0

_bound = None


def _lib() -> ctypes.CDLL:
    """The kernel library with the ring entries' C signatures declared."""
    global _bound
    if _bound is None:
        lib = _build.library()
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.p2p_ring_shift.argtypes = [p, p, i, q, i, i, p]
        lib.p2p_ring_shift.restype = i
        for fn in (lib.p2p_ring_segsum_or, lib.p2p_ring_segsum_sum):
            fn.argtypes = [p, p, q, p, p, p, p, q, p, i, i, i, i, q, i, p]
            fn.restype = i
        u = ctypes.c_uint32
        lib.p2p_peer_alloc.argtypes = [q, i, ctypes.POINTER(p),
                                       ctypes.c_char_p]
        lib.p2p_peer_open.argtypes = [ctypes.c_char_p, i, ctypes.POINTER(p)]
        lib.p2p_peer_close.argtypes = [p, i]
        lib.p2p_peer_free.argtypes = [p, i]
        lib.p2p_ring_put.argtypes = [p, p, i, q, i, u, p, p, p, q, i, p]
        lib.p2p_gather_alloc.argtypes = [q, i, ctypes.POINTER(p),
                                         ctypes.c_char_p]
        lib.p2p_gather_table.argtypes = [p, ctypes.POINTER(ctypes.c_uint64),
                                         i, i]
        lib.p2p_ring_gather.argtypes = [p, i, q, i, i, u, p, i, i, q, i, p]
        for fn in (lib.p2p_ring_pass_segsum_or, lib.p2p_ring_pass_segsum_sum):
            fn.argtypes = [p, q, p, p, p, p, q, q, p, i, i, i, i, i, i, q, q,
                           i, p]
        for fn in (lib.p2p_peer_alloc, lib.p2p_peer_open, lib.p2p_peer_close,
                   lib.p2p_peer_free, lib.p2p_ring_put, lib.p2p_gather_alloc,
                   lib.p2p_gather_table, lib.p2p_ring_gather,
                   lib.p2p_ring_pass_segsum_or,
                   lib.p2p_ring_pass_segsum_sum):
            fn.restype = i
        _bound = lib
    return _bound


def ring_shift_plain(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`ring_shift`."""
    return torch.roll(x, -1 if reverse else 1, dims=0)


def _shift_launches(x, *args, **kwargs) -> int:
    """A hop launches unless the ring has one shard or empty shards."""
    return int(x.dim() < 1 or (x.shape[0] > 1 and x[0].numel() > 0))


def _any_launches(x, *args, **kwargs) -> int:
    """One launch unless the payload is empty."""
    return int(x.numel() > 0)


@_device.kernel("ring_shift", _shift_launches)
def ring_shift(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """One ring hop of the stacked ``x [S, ...]`` (any dtype): a new
    tensor with ``out[d] = x[(d - 1) mod S]``, or ``x[(d + 1) mod S]``
    with ``reverse=True``. Returns ``x`` itself at ``S = 1``."""
    global SHIFT_LAUNCHES, SHIFT_BACK_LAUNCHES
    if x.dim() < 1:
        raise ValueError("ring_shift: x must have a leading shard axis")
    if x.shape[0] == 1:
        return x
    if x.device.type == "cpu":
        return ring_shift_plain(x, reverse)
    if not x.is_contiguous():
        raise ValueError("ring_shift: x must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"ring_shift: expected CPU or CUDA tensors, got "
                         f"{x.device}")
    out = torch.empty_like(x)
    shard_bytes = x[0].numel() * x.element_size()
    if shard_bytes == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().p2p_ring_shift(x.data_ptr(), out.data_ptr(), x.shape[0],
                               shard_bytes, int(reverse),
                               x.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"ring_shift: kernel launch failed with CUDA "
                           f"error {rc}")
    SHIFT_LAUNCHES += 1
    SHIFT_BACK_LAUNCHES += int(reverse)
    return out


def _check_ring(name: str, rot) -> None:
    if rot.dim() != 2 or rot.shape[0] < 2:
        raise ValueError(f"{name} needs a ring of >= 2 shards: rot must be "
                         f"[S >= 2, B], got {tuple(rot.shape)}")


def ring_segment_sum_or_plain(rot, src, local_dst, mask, block: int):
    """Plain PyTorch version of :func:`ring_segment_sum_or`, every row at
    its full width."""
    _check_ring("ring_segment_sum_or", rot)
    return (ring_shift_plain(rot),
            segsum.segsum_or_plain(rot, src, local_dst, mask, block))


def ring_segment_sum_sum_plain(rot, src, local_dst, mask, block: int):
    """Plain PyTorch version of :func:`ring_segment_sum_sum`, every row at
    its full width."""
    _check_ring("ring_segment_sum_sum", rot)
    return (ring_shift_plain(rot),
            segsum.segsum_sum_plain(rot, src, local_dst, mask, block))


def _check_extent(name: str, extent, src) -> None:
    """Hold ``extent`` to ``i32[S, NB]`` for ``[S, NB, W]`` buckets, on
    their device, each shard's row extents contiguous (any shard
    stride: the step slice ``[:, t]`` of ``ShardedGraph.mxu_extent``)."""
    if extent.device != src.device or extent.dtype != torch.int32 or \
            extent.dim() != 2 or extent.shape != src.shape[:-1]:
        raise ValueError(f"{name}: extent must be i32[S, NB] on the "
                         f"buckets' device, got {extent.dtype} "
                         f"{tuple(extent.shape)} on {extent.device}")
    if extent.shape[1] > 1 and extent.stride(1) != 1:
        raise ValueError(f"{name}: extent's rows must be contiguous, got "
                         f"strides {extent.stride()}")


def _launch(kind: str, rot, src, local_dst, mask, block: int, dtype,
            extent):
    """Check the operands, allocate both outputs and launch B3's ``kind``
    ("or" or "sum") entry on the current stream."""
    global SEGSUM_LAUNCHES
    name = f"ring_segment_sum_{kind}"
    _check_ring(name, rot)
    if rot.dtype != dtype:
        raise ValueError(f"{name}: rot must be {dtype}, got {rot.dtype}")
    if extent is not None:
        _check_extent(name, extent, src)
    s, nb, w, bucket_stride, signal_stride = segsum.bucket_geometry(
        name, rot, src, local_dst, mask, block)
    dev = rot.device
    rot_next = torch.empty_like(rot)
    out = torch.empty(s, nb * block, dtype=dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(_lib(), f"p2p_ring_segsum_{kind}")(
        rot.data_ptr(), rot_next.data_ptr(), signal_stride, src.data_ptr(),
        local_dst.data_ptr(), mask.data_ptr(),
        None if extent is None else extent.data_ptr(),
        0 if extent is None else extent.stride(0), out.data_ptr(), s, nb, w,
        block, bucket_stride, dev.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    SEGSUM_LAUNCHES += 1
    return rot_next, out


@_device.kernel("ring_segsum_or")
def ring_segment_sum_or(rot, src, local_dst, mask, block: int,
                        extent=None):
    """The fused ring step for OR: ``(ring_shift(rot), out)`` with
    ``out[d, n*block + b] = any(rot[d, src[d, n, w]] & mask[d, n, w]
    for w with local_dst[d, n, w] == b)``. ``rot`` bool ``[S >= 2, B]``;
    the buckets ``[S, NB, W]`` as in :func:`segsum.segsum_or`.

    ``extent`` (``i32[S, NB]``, optional; ``ShardedGraph.mxu_extent``
    sliced as the buckets are) gives each row's extent: every slot from
    it on must be ``(mask, src, local_dst) = (0, 0, 0)``, the layout's
    padding, and the kernel reads no further. The result is the same."""
    if rot.device.type == "cpu":
        return ring_segment_sum_or_plain(rot, src, local_dst, mask, block)
    return _launch("or", rot, src, local_dst, mask, block, torch.bool,
                   extent)


@_device.kernel("ring_segsum_sum")
def ring_segment_sum_sum(rot, src, local_dst, mask, block: int,
                         extent=None):
    """The fused ring step for sums: ``(ring_shift(rot), out)`` with
    ``out[d, n*block + b] = sum(rot[d, src[d, n, w]] * mask[d, n, w]
    for w with local_dst[d, n, w] == b)``, f32 ``rot [S >= 2, B]``.
    ``extent`` as in :func:`ring_segment_sum_or`: the padding a row's
    extent skips adds ``rot[d, 0] * 0`` to ``out[d, n*block]`` once, as
    its slots would. Non-finite terms spread over their row as in
    :func:`segsum.segsum_sum` (a non-finite ``rot[d, 0]`` read by the
    padding makes the whole row NaN)."""
    if rot.device.type == "cpu":
        return ring_segment_sum_sum_plain(rot, src, local_dst, mask, block)
    return _launch("sum", rot, src, local_dst, mask, block, torch.float32,
                   extent)


# ------------------------------------------------------------ across ranks

#: Bytes of a slot's handle (``cudaIpcMemHandle_t``).
IPC_HANDLE_BYTES = 64
#: Bytes of a receive area's flags and counters before its four slots
#: (``kHeaderBytes`` in ``csrc/ring_peer.cu``).
AREA_HEADER_BYTES = 512


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA error {rc}")


class PeerChannel:
    """This rank's receive area on the card and its two neighbours'
    mapped areas: two slots of ``slot_bytes`` a direction (by step
    parity), the arrival and acknowledgement flags, and the kernels'
    arrival counters (``csrc/ring_peer.cu``). Made by every rank of
    ``mesh`` together (one exchange of IPC handles through the process
    group); ``seq`` counts the hops made in each direction, the same on
    every rank."""

    def __init__(self, mesh, slot_bytes: int):
        import torch.distributed as dist

        lib = _lib()
        self.mesh, self.device = mesh, mesh.device.index or 0
        self.slot_bytes = -(-int(slot_bytes) // 256) * 256
        area = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(IPC_HANDLE_BYTES)
        _check(lib.p2p_peer_alloc(self.slot_bytes, self.device,
                                  ctypes.byref(area), handle),
               "p2p_peer_alloc")
        self.area = area.value
        handles = [None] * mesh.world
        dist.all_gather_object(handles, handle.raw, group=mesh.group)
        self.peers = {}
        for r in {mesh.next_rank, mesh.prev_rank}:
            ptr = ctypes.c_void_p()
            _check(lib.p2p_peer_open(handles[r], self.device,
                                     ctypes.byref(ptr)), "p2p_peer_open")
            self.peers[r] = ptr.value
        dist.barrier(group=mesh.group)
        self.seq = [0, 0]

    def hop(self, reverse: bool):
        """The next hop's ``(seq, down, up)`` in a direction: its sequence
        number, the mapped area of the rank this one sends to and of the
        rank it receives from."""
        d = int(reverse)
        self.seq[d] += 1
        ahead, behind = self.peers[self.mesh.next_rank], \
            self.peers[self.mesh.prev_rank]
        return (self.seq[d],) + ((behind, ahead) if reverse
                                 else (ahead, behind))

    def slot_address(self, rank: int, reverse: bool, seq: int) -> int:
        """The device address, mapped here, of the slot of neighbour
        ``rank`` that hop ``seq`` in a direction writes."""
        return self.peers[rank] + AREA_HEADER_BYTES + (
            2 * int(reverse) + seq % 2) * self.slot_bytes

    def close(self) -> None:
        """Unmap the peers' areas and free this one, after every rank has
        finished its hops (a barrier)."""
        import torch.distributed as dist

        torch.cuda.synchronize(self.mesh.device)
        lib = _lib()
        for ptr in self.peers.values():
            _check(lib.p2p_peer_close(ptr, self.device), "p2p_peer_close")
        dist.barrier(group=self.mesh.group)
        _check(lib.p2p_peer_free(self.area, self.device), "p2p_peer_free")


def peer_channel(mesh, shard_bytes: int) -> PeerChannel:
    """``mesh``'s channel, made at its first hop with slots for 8 bytes a
    payload byte of that hop's shard (so the same shard shape fits in any
    dtype), and made anew (every rank at the same hop) when a payload
    outgrows it."""
    chan = mesh.peer.get("channel")
    if chan is None or chan.slot_bytes < shard_bytes:
        if chan is not None:
            chan.close()
        chan = mesh.peer["channel"] = PeerChannel(mesh, 8 * shard_bytes)
    return chan


#: Bound on one gloo exchange of :func:`ring_put_plain`: a wedged rank
#: raises ``RuntimeError`` after this long instead of hanging its peers.
PLAIN_WAIT_S = 300.0


def _put_geometry(name: str, x: torch.Tensor):
    """The rank's stack ``[n_local, ...]`` checked for a CUDA put; its
    shard bytes."""
    if x.dim() < 1 or x.shape[0] < 1:
        raise ValueError(f"{name}: x must have a leading shard axis")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected CPU or CUDA tensors, got "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    return x[0].numel() * x.element_size()


def ring_put_plain(x: torch.Tensor, mesh, reverse: bool = False
                   ) -> torch.Tensor:
    """Plain version of :func:`ring_put`: the boundary shard sent to the
    next (previous) rank with gloo ``isend``/``irecv`` on the host, the
    local shards rolled by ``torch.roll``."""
    import torch.distributed as dist

    n = x.shape[0]
    boundary, landing = (0, n - 1) if reverse else (n - 1, 0)
    to, frm = (mesh.prev_rank, mesh.next_rank) if reverse \
        else (mesh.next_rank, mesh.prev_rank)
    send = x[boundary].contiguous().cpu()
    recv = torch.empty_like(send)
    wire = (lambda t: t.view(torch.uint8)) if x.dtype == torch.bool \
        else (lambda t: t)
    reqs = [dist.isend(wire(send), to, group=mesh.group),
            dist.irecv(wire(recv), frm, group=mesh.group)]
    for req in reqs:
        req.wait(timeout=datetime.timedelta(seconds=PLAIN_WAIT_S))
    out = torch.roll(x, -1 if reverse else 1, dims=0)
    out[landing] = recv.to(x.device)
    return out


@_device.kernel("ring_put", _any_launches)
def ring_put(x: torch.Tensor, mesh, reverse: bool = False) -> torch.Tensor:
    """One ring hop of this rank's stack ``x [n_local, ...]`` on a ring
    split over ranks: ``out[d] = x[d - 1]`` for ``d >= 1`` and ``out[0]``
    the previous rank's last shard (``reverse``: ``out[d] = x[d + 1]``,
    the last row the next rank's first shard), i.e. this rank's rows of
    :func:`ring_shift` of the whole ``[S, ...]`` stack. Every rank of
    ``mesh`` makes the same calls in the same order."""
    global PUT_LAUNCHES, LAND_LAUNCHES
    if x.device.type == "cpu":
        return ring_put_plain(x, mesh, reverse)
    shard_bytes = _put_geometry("ring_put", x)
    out = torch.empty_like(x)
    if shard_bytes == 0:
        return out
    chan = peer_channel(mesh, shard_bytes)
    seq, down, up = chan.hop(reverse)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _check(_lib().p2p_ring_put(x.data_ptr(), out.data_ptr(), x.shape[0],
                               shard_bytes, int(reverse), seq, chan.area,
                               down, up, chan.slot_bytes, chan.device,
                               stream), "ring_put: kernel launch")
    PUT_LAUNCHES += 1
    LAND_LAUNCHES += 1
    return out


# ------------------------------------------------- a pass's one exchange

#: Bytes of a gather area's header (``kGatherHeaderBytes`` in
#: ``csrc/ring_peer.cu``): flags, acknowledgements, the ranks' areas.
GATHER_HEADER_BYTES = 4096
#: Ranks a gather channel can join (``kMaxWorld``).
GATHER_MAX_WORLD = 128


class _Interface:
    """A device address range as an object torch can wrap without a copy
    (``__cuda_array_interface__``, bytes)."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2}


class GatherChannel:
    """This rank's gather area on the card and every peer's, mapped: two
    slabs of ``slab_bytes`` (by pass parity), the pass counter, the
    acknowledgements and the table of the ranks' areas by ring position
    (``csrc/ring_peer.cu``). Made by every rank of ``mesh`` together (one
    exchange of IPC handles through the process group, every peer's
    handle opened); ``seq`` counts the gathers, the same on every rank.
    :meth:`slab` wraps a pass's slab as a tensor without a copy."""

    def __init__(self, mesh, slab_bytes: int):
        import torch.distributed as dist

        if mesh.world > GATHER_MAX_WORLD:
            raise ValueError(f"ring_gather joins at most {GATHER_MAX_WORLD} "
                             f"ranks, the mesh has {mesh.world}")
        lib = _lib()
        self.mesh, self.device = mesh, mesh.device.index or 0
        self.slab_bytes = -(-int(slab_bytes) // 256) * 256
        area = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(IPC_HANDLE_BYTES)
        _check(lib.p2p_gather_alloc(self.slab_bytes, self.device,
                                    ctypes.byref(area), handle),
               "p2p_gather_alloc")
        self.area = area.value
        handles = [None] * mesh.world
        if mesh.world > 1:
            dist.all_gather_object(handles, handle.raw, group=mesh.group)
        self.peers = {}
        table = (ctypes.c_uint64 * mesh.world)()
        for pos, r in enumerate(mesh.order):
            if r == mesh.rank:
                table[pos] = self.area
                continue
            ptr = ctypes.c_void_p()
            _check(lib.p2p_peer_open(handles[r], self.device,
                                     ctypes.byref(ptr)), "p2p_peer_open")
            self.peers[r] = table[pos] = ptr.value
        _check(lib.p2p_gather_table(self.area, table, mesh.world,
                                    self.device), "p2p_gather_table")
        if mesh.world > 1:
            dist.barrier(group=mesh.group)
        self.seq = 0
        self._bytes = torch.as_tensor(
            _Interface(self.area + GATHER_HEADER_BYTES, 2 * self.slab_bytes),
            device=mesh.device)

    def slab(self, seq: int, dtype: torch.dtype, shape) -> torch.Tensor:
        """Gather ``seq``'s slab as a ``dtype`` tensor of ``shape`` (a view
        of this rank's area: valid until the gather two after it)."""
        lo = (seq % 2) * self.slab_bytes
        nbytes = math.prod(shape) * torch.empty((), dtype=dtype
                                                ).element_size()
        return self._bytes[lo:lo + nbytes].view(dtype).view(shape)

    def close(self) -> None:
        """Unmap the peers' areas and free this one, after every rank has
        finished its gathers (a barrier)."""
        import torch.distributed as dist

        torch.cuda.synchronize(self.mesh.device)
        self._bytes = None
        lib = _lib()
        for ptr in self.peers.values():
            _check(lib.p2p_peer_close(ptr, self.device), "p2p_peer_close")
        if self.mesh.world > 1:
            dist.barrier(group=self.mesh.group)
        _check(lib.p2p_peer_free(self.area, self.device), "p2p_peer_free")


def gather_channel(mesh, slab_bytes: int) -> GatherChannel:
    """``mesh``'s gather channel, made at its first gather with slabs of
    that gather's size, and made anew (every rank at the same gather)
    when a payload outgrows it. The outgrown channel is retired, not
    closed: the last gather's view on it keeps the lifetime
    :func:`ring_gather` promises, and :func:`close_retired` frees it at
    the gather two after that one (``mesh.peer["gathers"]`` counts the
    mesh's gathers, this one included)."""
    chan = mesh.peer.get("gather")
    if chan is None or chan.slab_bytes < slab_bytes:
        if chan is not None:
            # Its last view came from the gather before this one.
            mesh.peer.setdefault("retired", []).append(
                (chan, mesh.peer.get("gathers", 0) + 1))
        chan = mesh.peer["gather"] = GatherChannel(mesh, slab_bytes)
    return chan


def next_gather(mesh, slab_bytes: int) -> GatherChannel:
    """The channel of ``mesh``'s next gather, its ``seq`` advanced, after
    closing the retired channels whose views that gather expires."""
    n = mesh.peer["gathers"] = mesh.peer.get("gathers", 0) + 1
    close_retired(mesh, n)
    chan = gather_channel(mesh, slab_bytes)
    chan.seq += 1
    return chan


def close_retired(mesh, gathers: int) -> None:
    """Close the retired gather channels whose last views expire at the
    mesh's gather number ``gathers`` (every rank at the same gather)."""
    retired = mesh.peer.get("retired")
    if not retired:
        return
    keep = []
    for chan, close_at in retired:
        if gathers >= close_at:
            chan.close()
        else:
            keep.append((chan, close_at))
    mesh.peer["retired"] = keep


def ring_rows(slab: torch.Tensor, shard_lo: int, n_local: int,
              t: int) -> torch.Tensor:
    """The rows a rank's ``n_local`` shards from ``shard_lo`` hold at ring
    step ``t`` of a pass, from its gathered ``[2S, ...]`` slab: row ``d``
    is global shard ``(shard_lo + d - t) mod S``, what ``t`` hops of
    :func:`ring_put` bring. A view (the slab holds every shard twice)."""
    start = (shard_lo - t) % (slab.shape[0] // 2)
    return slab[start:start + n_local]


def ring_gather_plain(x: torch.Tensor, mesh) -> torch.Tensor:
    """Plain version of :func:`ring_gather`: the ranks' stacks by a gloo
    ``all_gather`` on the host, stacked in ring order (as
    ``mesh.gather_shards``, without counting an exchange), twice."""
    import torch.distributed as dist

    wire = x.view(torch.uint8) if x.dtype == torch.bool else x
    host = wire.contiguous().cpu()
    whole = host
    if mesh.world > 1:
        parts = [torch.empty_like(host) for _ in range(mesh.world)]
        dist.all_gather(parts, host, group=mesh.group)
        whole = torch.cat([parts[r] for r in mesh.order])
    return torch.cat([whole, whole]).to(x.device).view(x.dtype)


@_device.kernel("ring_gather", _any_launches)
def ring_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's stack ``x [n_local, ...]`` (any dtype) gathered in ring
    order on a ring split over ranks, twice: ``out [2S, ...]`` with
    ``out[r]`` global shard ``r mod S`` (the ``[S, ...]`` stack of the
    whole ring, then again), so that the rows of any ring step are one
    view (:func:`ring_rows`). One exchange replaces the ``S - 1`` hops of
    :func:`ring_put` a pass. Every rank of ``mesh`` makes the same calls
    in the same order.

    On the card the result is a view of the rank's gather area (no copy;
    ``2 * 2S`` blocks of the payload a rank, both parities): it stays
    valid until the gather two after it on the same mesh, which may
    overwrite it (or, after a payload outgrew the area, free it); clone
    what must live longer."""
    global GATHER_LAUNCHES
    if x.device.type == "cpu":
        return ring_gather_plain(x, mesh)
    shard_bytes = _put_geometry("ring_gather", x)
    S = mesh.n_shards
    shape = (2 * S,) + tuple(x.shape[1:])
    if x.shape[0] != mesh.n_local:
        raise ValueError(f"ring_gather: x must hold the rank's "
                         f"{mesh.n_local} shards, got {x.shape[0]}")
    if shard_bytes == 0:
        return torch.empty(shape, dtype=x.dtype, device=x.device)
    chan = next_gather(mesh, 2 * S * shard_bytes)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _check(_lib().p2p_ring_gather(
        x.data_ptr(), x.shape[0], shard_bytes, S, mesh.shard_lo, chan.seq,
        chan.area, mesh.world, mesh.position, chan.slab_bytes, chan.device,
        stream), "ring_gather: kernel launch")
    GATHER_LAUNCHES += 1
    return chan.slab(chan.seq, x.dtype, shape)


def _fold_steps(kind: str, slab, shard_lo: int, src, local_dst, mask,
                block: int):
    """The pass's fold of B1's plain sum over each step's rows, from
    zeros, steps ascending (the reference's order)."""
    plain = segsum.segsum_or_plain if kind == "or" \
        else segsum.segsum_sum_plain
    L, S, nb = src.shape[:3]
    out = torch.zeros((L, nb * block), device=slab.device,
                      dtype=torch.bool if kind == "or" else torch.float32)
    for t in range(S):
        step = plain(ring_rows(slab, shard_lo, L, t), src[:, t],
                     local_dst[:, t], mask[:, t], block)
        out = out | step if kind == "or" else out + step
    return out


def ring_pass_segsum_or_plain(slab, shard_lo: int, src, local_dst, mask,
                              block: int):
    """Plain version of :func:`ring_pass_segsum_or`, every row at its full
    width."""
    return _fold_steps("or", slab, shard_lo, src, local_dst, mask, block)


def ring_pass_segsum_sum_plain(slab, shard_lo: int, src, local_dst, mask,
                               block: int):
    """Plain version of :func:`ring_pass_segsum_sum`: f32 sums folded step
    by step from zeros, steps ascending."""
    return _fold_steps("sum", slab, shard_lo, src, local_dst, mask, block)


def _pass_geometry(name: str, slab, src, local_dst, mask, block, extent):
    """Check a pass kernel's operands: the ``[2S, B]`` slab, the rank's
    ``[L, S, NB, W]`` buckets (each step's ``[NB, W]`` rows contiguous,
    one set of strides for the three), ``extent`` ``i32[L, S, NB]`` with
    contiguous rows. Returns ``(L, S, NB, W, shard stride, step stride,
    slab row stride)`` in elements."""
    if slab.dim() != 2 or slab.shape[0] % 2 or src.dim() != 4 or \
            src.shape[1] != slab.shape[0] // 2:
        raise ValueError(f"{name}: needs a [2S, B] slab and [L, S, NB, W] "
                         f"buckets, got {tuple(slab.shape)} and "
                         f"{tuple(src.shape)}")
    L, S = src.shape[:2]
    for a, what in ((local_dst, "local_dst"), (mask, "mask")):
        if a.shape != src.shape or a.stride() != src.stride():
            raise ValueError(f"{name}: {what} must have src's shape and "
                             f"strides")
    _, nb, w, shard_stride, signal_stride = segsum.bucket_geometry(
        name, slab[:L], src[:, 0], local_dst[:, 0], mask[:, 0], block)
    if extent is not None and (
            extent.device != src.device or extent.dtype != torch.int32
            or extent.shape != src.shape[:3]
            or (nb > 1 and extent.stride(2) != 1)):
        raise ValueError(f"{name}: extent must be i32[L, S, NB] on the "
                         f"buckets' device with contiguous rows, got "
                         f"{extent.dtype} {tuple(extent.shape)}")
    return L, S, nb, w, shard_stride, src.stride(1), signal_stride


def _pass_launch(kind: str, slab, shard_lo, src, local_dst, mask,
                 block: int, dtype, extent):
    global PASS_SEGSUM_LAUNCHES
    name = f"ring_pass_segsum_{kind}"
    if slab.dtype != dtype:
        raise ValueError(f"{name}: slab must be {dtype}, got {slab.dtype}")
    L, S, nb, w, shard_stride, step_stride, signal_stride = _pass_geometry(
        name, slab, src, local_dst, mask, block, extent)
    dev = slab.device
    out = torch.empty(L, nb * block, dtype=dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _check(getattr(_lib(), f"p2p_ring_pass_segsum_{kind}")(
        slab.data_ptr(), signal_stride, src.data_ptr(), local_dst.data_ptr(),
        mask.data_ptr(), None if extent is None else extent.data_ptr(),
        0 if extent is None else extent.stride(0),
        0 if extent is None else extent.stride(1), out.data_ptr(), L, S,
        int(shard_lo), nb, w, block, shard_stride, step_stride,
        dev.index or 0, stream), f"{name}: kernel launch")
    PASS_SEGSUM_LAUNCHES += 1
    return out


@_device.kernel("ring_pass_segsum_or")
def ring_pass_segsum_or(slab, shard_lo: int, src, local_dst, mask,
                        block: int, extent=None):
    """B3 across ranks for OR, a whole pass in one launch: ``out [L, NB *
    block]`` with ``out[d]`` the OR over ring steps ``t`` of
    :func:`segsum.segsum_or` of the rank's bucket ``[d, t]`` over the
    block resident at step ``t`` (:func:`ring_rows` of the gathered
    ``slab [2S, B]`` bool). ``src``, ``local_dst``, ``mask`` are the
    rank's ``[L, S, NB, W]`` MXU buckets; ``extent`` (``i32[L, S, NB]``,
    optional: ``ShardedGraph.mxu_extent``) each row's extent at each step,
    as :func:`ring_segment_sum_or` reads it."""
    if slab.device.type == "cpu":
        return ring_pass_segsum_or_plain(slab, shard_lo, src, local_dst,
                                         mask, block)
    return _pass_launch("or", slab, shard_lo, src, local_dst, mask, block,
                        torch.bool, extent)


@_device.kernel("ring_pass_segsum_sum")
def ring_pass_segsum_sum(slab, shard_lo: int, src, local_dst, mask,
                         block: int, extent=None):
    """B3 across ranks for f32 sums, a whole pass in one launch: the sum
    over ring steps of :func:`segsum.segsum_sum` of each step's bucket
    (as :func:`ring_pass_segsum_or`). On the card every step's terms add
    into one accumulator with atomics, in an order that varies from run
    to run (exact on integer values); a non-finite term at any step
    spreads over its row as in that step's sum."""
    if slab.device.type == "cpu":
        return ring_pass_segsum_sum_plain(slab, shard_lo, src, local_dst,
                                          mask, block)
    return _pass_launch("sum", slab, shard_lo, src, local_dst, mask, block,
                        torch.float32, extent)
