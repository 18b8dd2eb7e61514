"""The ring a sharded graph runs on (torch counterpart of
``p2pnetwork_tpu/parallel/mesh.py``).

The reference's ring is a JAX device mesh: one shard per chip, hops over
the chips' interconnect. Here the shards are stacked on axis 0 of each
per-shard tensor (``[S, ...]``) and a hop is a copy (``ops/ring.py``).

In one process (``world == 1``) every shard lives on ONE device, which is
how the JAX package's tests run the ring on one host (an 8-device virtual
CPU mesh) and what one H100 holds. Across processes (``world > 1``,
``parallel/multihost.py``) rank ``r`` at ring position ``p`` holds the
``S / world`` consecutive shards ``[p * S / world, (p + 1) * S / world)``
(:func:`shard_spec`), stacked the same way on its own device; a hop then
moves each rank's boundary shard to the next rank (``sharded._RankComm``:
a CUDA IPC peer write on the card, gloo on the CPU), and the reductions
of the reference's ``psum`` go through the process group
(:func:`all_sum`, :func:`all_max`, :func:`gather_shards`,
:func:`gather_lists`).

The auto-sharded path across ranks (``parallel/auto.py``) exchanges
node-extent results: :func:`assemble` puts every rank's owned slice of an
aggregation together, :func:`combine` folds every rank's whole partial
(sums keyed by sender or by component), each in one ``ops/ring.py``
``ring_gather`` (B2's pass form on the card, its gloo plain version on
the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from p2pnetwork_tpu_torch import _device
from p2pnetwork_tpu_torch.sim.graph import part_of

DEFAULT_AXIS = "shards"

#: Exchanges across ranks so far: every :func:`all_sum`, :func:`all_max`,
#: :func:`gather_shards` and :func:`gather_lists` through the process
#: group (``parallel/commviz.py::ring_hop_census`` reads a round's), and
#: every :func:`assemble` and :func:`combine`.
EXCHANGES = 0
#: Bytes this rank has put into :func:`assemble` and :func:`combine`'s
#: gathers so far (its own stack a gather; every other rank receives it
#: whole). ``parallel/commviz.py::auto_hop_census`` reads a round's.
GATHERED_BYTES = 0


@dataclasses.dataclass(frozen=True)
class RingMesh:
    """A ring of ``n_shards`` shards stacked on axis 0 of every per-shard
    tensor. ``world`` processes share it: this one is ``rank`` at ring
    position ``order.index(rank)`` (``order`` lists the ranks around the
    ring, host-major), holding ``n_local`` shards from ``shard_lo`` on
    ``device``; ``group`` is the process group (None in one process).
    ``peer`` holds the hops' IPC channel across ranks."""

    n_shards: int
    axis_name: str
    device: torch.device
    rank: int = 0
    world: int = 1
    order: Tuple[int, ...] = (0,)
    group: Optional[object] = dataclasses.field(default=None, compare=False)
    #: The CUDA IPC channel of the ring's cross-rank hops, made at the
    #: first (``ops/ring.py::peer_channel``).
    peer: dict = dataclasses.field(default_factory=dict, compare=False,
                                   repr=False)

    @property
    def position(self) -> int:
        """This rank's place on the ring."""
        return self.order.index(self.rank)

    @property
    def n_local(self) -> int:
        return self.n_shards // self.world

    @property
    def shard_lo(self) -> int:
        return self.position * self.n_local

    @property
    def next_rank(self) -> int:
        """The rank a forward hop sends to."""
        return self.order[(self.position + 1) % self.world]

    @property
    def prev_rank(self) -> int:
        """The rank a forward hop receives from."""
        return self.order[(self.position - 1) % self.world]


def ring_mesh(n_shards: int, axis_name: str = DEFAULT_AXIS,
              device=None) -> RingMesh:
    """A ring of ``n_shards`` stacked shards on ``device`` (``cuda``
    unless named, as in ``_device.resolve``), all in this process."""
    if n_shards < 1:
        raise ValueError(f"a ring needs >= 1 shard, got {n_shards}")
    return RingMesh(n_shards=int(n_shards), axis_name=axis_name,
                    device=_device.resolve(device))


def shard_spec(mesh: RingMesh) -> slice:
    """The rows of axis 0 of a global ``[S, ...]`` array that this rank
    holds (the reference's ``shard_spec``: the leading axis split over
    the ring): every row in one process."""
    return slice(mesh.shard_lo, mesh.shard_lo + mesh.n_local)


def _exchanged() -> None:
    """Count one exchange through the process group (a host round trip:
    also a sync)."""
    global EXCHANGES
    EXCHANGES += 1
    _device.SYNCS += 1


def all_sum(mesh: RingMesh, x: torch.Tensor) -> torch.Tensor:
    """The elementwise sum of ``x`` (integers) over the ring's ranks, on
    ``x``'s device: ``x`` itself in one process. Across processes one
    exchange through the process group (gloo, on the host), counted in
    ``_device.SYNCS``."""
    if mesh.world == 1:
        return x
    import torch.distributed as dist

    _exchanged()
    host = x.cpu()
    dist.all_reduce(host, group=mesh.group)
    return host.to(x.device)


def all_max(mesh: RingMesh, x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the ring's ranks (the reference's
    ``pmax``), on ``x``'s device: ``x`` itself in one process. Across
    processes one exchange through the process group, counted in
    ``_device.SYNCS``."""
    if mesh.world == 1:
        return x
    import torch.distributed as dist

    _exchanged()
    host = x.cpu()
    dist.all_reduce(host, op=dist.ReduceOp.MAX, group=mesh.group)
    return host.to(x.device)


def gather_shards(mesh: RingMesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``[n_local, ...]`` rows stacked in ring order,
    ``[S, ...]``, on ``x``'s device: ``x`` itself in one process. Across
    processes one all-gather through the process group, counted in
    ``_device.SYNCS``."""
    if mesh.world == 1:
        return x
    import torch.distributed as dist

    _exchanged()
    host = x.contiguous().cpu()
    parts = [torch.empty_like(host) for _ in range(mesh.world)]
    dist.all_gather(parts, host, group=mesh.group)
    return torch.cat([parts[r] for r in mesh.order]).to(x.device)


def gather_lists(mesh: Optional[RingMesh], ids: torch.Tensor,
                 counts: torch.Tensor, *cols: torch.Tensor):
    """Every shard's id list, ``ids [n_local, k]`` of which the first
    ``counts [n_local]`` are set (the rest padding), and per-shard integer
    columns ``cols`` (each ``[n_local]``), gathered from every rank in
    ring order: ``(ids [S, k], counts [S], [col [S], ...])``, so that
    shard ``d``'s list is row ``d`` on every rank (the reference's
    ``all_gather`` of the lists and counts). The inputs themselves in one
    process (``mesh`` None or of one rank). Across processes one
    all-gather of an i64 ``[n_local, k + 1 + len(cols)]`` block, counted
    in ``_device.SYNCS``."""
    if mesh is None or mesh.world == 1:
        return ids, counts, list(cols)
    k = ids.shape[1]
    block = torch.cat([ids.to(torch.int64), counts.to(torch.int64)[:, None]]
                      + [c.to(torch.int64).reshape(-1, 1) for c in cols],
                      dim=1)
    whole = gather_shards(mesh, block)
    return (whole[:, :k], whole[:, k],
            [whole[:, k + 1 + i] for i in range(len(cols))])


def gather_ragged(mesh: Optional[RingMesh], rows: torch.Tensor):
    """Every rank's ``rows [m, c]`` (i64; ``m`` may differ from rank to
    rank) stacked in ring order, ``[sum m, c]``, on ``rows``' device:
    ``rows`` itself in one process. Across processes two exchanges through
    the process group, each counted in ``_device.SYNCS``: the most rows
    any rank holds (:func:`all_max`), then one all-gather of every rank's
    rows padded to it, their count ahead (:func:`gather_shards`). For the
    host rebuilds that need every rank's edges (Plumtree's tree graph,
    ``sim/topology.py`` ``consolidate`` on a part)."""
    if mesh is None or mesh.world == 1:
        return rows
    m, c = rows.shape
    k = int(all_max(mesh, torch.tensor([m], dtype=torch.int64))[0])
    block = torch.zeros((1, k + 1, max(c, 1)), dtype=torch.int64)
    block[0, 0, 0] = m
    block[0, 1:m + 1, :c] = rows.cpu()
    whole = gather_shards(mesh, block)
    return torch.cat([w[1:int(w[0, 0]) + 1, :c] for w in whole]).to(
        rows.device)


#: The folds :func:`combine` takes, by name.
_FOLDS = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum,
          "or": torch.logical_or}


def _gathered(mesh: RingMesh, x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x [n, ...]`` (``n <= mesh.n_local * rows``, zero-padded to it) as
    the rank's ``[n_local, rows, ...]`` stack, ring-gathered: every rank's
    stack in ring order, ``[S * rows, ...]``. A view of the gather area
    on the card (valid until the gather two after it)."""
    from p2pnetwork_tpu_torch.ops import ring

    global EXCHANGES, GATHERED_BYTES
    span = mesh.n_local * rows
    if x.shape[0] < span:
        x = torch.cat([x, x.new_zeros((span - x.shape[0],) + x.shape[1:])])
    x = x.reshape((mesh.n_local, rows) + x.shape[1:]).contiguous()
    EXCHANGES += 1
    GATHERED_BYTES += x.numel() * x.element_size()
    slab = ring.ring_gather(x, mesh)
    return slab[:mesh.n_shards].reshape((-1,) + x.shape[2:])


def assemble(part, owned: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """The whole result, ``N_pad`` along ``axis`` (the last by default;
    0 for the node-major ``[N_pad, K]`` query lanes), on every rank from
    every rank's owned slice ``owned``, ``hi - lo`` along ``axis``
    (``part``: a ``sim/graph.py`` ``Part``): one exchange, the slice
    viewed as the rank's ``[n_local, N_pad / S, ...]`` shards through
    ``ring_gather``. Every owned slice has one author, so every rank gets
    the same bits. The result is a copy (the gather's view is not
    kept)."""
    whole = _gathered(part.mesh, owned.movedim(axis, 0), part.block)
    return whole[:part.n_pad].movedim(0, axis).clone(
        memory_format=torch.contiguous_format)


def owned(graph, full: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """The nodes this process aggregates of a whole tensor, ``N_pad``
    along ``axis``: all of them, or on a rank's part of a graph
    (``sim/graph.py`` ``GraphPart``) the owned ``[lo, hi)``."""
    part = part_of(graph)
    return full if part is None else full.narrow(axis, part.lo,
                                                  part.hi - part.lo)


def owns(graph, nodes: torch.Tensor) -> torch.Tensor:
    """bool, ``nodes``' shape: which of ``nodes`` this process aggregates
    (all of them, or on a rank's part those in ``[lo, hi)``)."""
    part = part_of(graph)
    if part is None:
        return torch.ones_like(nodes, dtype=torch.bool)
    return (nodes >= part.lo) & (nodes < part.hi)


def assembled(graph, out: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """The whole result from ``out``, of :func:`owned`'s extent along
    ``axis``: on a rank's part every rank's owned slice, assembled in one
    exchange (:func:`assemble`)."""
    part = part_of(graph)
    return out if part is None else assemble(part, out, axis)


def combine(part, partial: torch.Tensor, fold: str) -> torch.Tensor:
    """Every rank's whole partial ``partial [..., N_pad]`` folded by
    ``fold`` (``"sum"``, ``"min"``, ``"max"`` or ``"or"``) in ring order,
    the same on every rank: one exchange of ``ring_gather``. For results
    keyed by sender or by component, which any rank's edges may feed."""
    mesh, n = part.mesh, partial.shape[-1]
    rows = -(-n // mesh.n_local)
    whole = _gathered(mesh, partial.movedim(-1, 0), rows)
    parts = whole.reshape((mesh.world, mesh.n_local * rows)
                          + whole.shape[1:])[:, :n]
    op = _FOLDS[fold]
    acc = parts[0]
    for w in range(1, mesh.world):
        acc = op(acc, parts[w])
    return acc.movedim(0, -1).clone(memory_format=torch.contiguous_format)
