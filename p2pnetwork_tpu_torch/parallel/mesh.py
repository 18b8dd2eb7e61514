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
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from p2pnetwork_tpu_torch import _device

DEFAULT_AXIS = "shards"

#: Exchanges through the process group so far (every :func:`all_sum`,
#: :func:`all_max`, :func:`gather_shards` and :func:`gather_lists` across
#: ranks): ``parallel/commviz.py::ring_hop_census`` reads a round's.
EXCHANGES = 0


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
