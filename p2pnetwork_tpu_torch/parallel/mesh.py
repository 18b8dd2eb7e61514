"""The ring a sharded graph runs on (torch counterpart of
``p2pnetwork_tpu/parallel/mesh.py``).

The reference's ring is a JAX device mesh: one shard per chip, hops over
the chips' interconnect. Here every shard lives on ONE device, stacked on
axis 0 of each per-shard tensor (``[S, ...]``), and a hop is a
device-local copy (``ops/ring.py``). This is how the JAX package's tests
run the ring on one host (an 8-device virtual CPU mesh), and what one
H100 can hold. Hops between GPUs are a later backend behind the same
comm seam (``sharded._RingComm``).
"""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch import _device

DEFAULT_AXIS = "shards"


@dataclasses.dataclass(frozen=True)
class RingMesh:
    """A ring of ``n_shards`` shards, all resident on ``device``, stacked
    on axis 0 of every per-shard tensor."""

    n_shards: int
    axis_name: str
    device: torch.device


def ring_mesh(n_shards: int, axis_name: str = DEFAULT_AXIS,
              device=None) -> RingMesh:
    """A ring of ``n_shards`` stacked shards on ``device`` (``cuda``
    unless named, as in ``_device.resolve``)."""
    if n_shards < 1:
        raise ValueError(f"a ring needs >= 1 shard, got {n_shards}")
    return RingMesh(n_shards=int(n_shards), axis_name=axis_name,
                    device=_device.resolve(device))
