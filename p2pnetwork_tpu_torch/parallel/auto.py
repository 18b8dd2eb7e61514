"""Routing of the ring's halo-exchange backend and the auto-sharded path
(torch counterpart of ``p2pnetwork_tpu/parallel/auto.py``).

The reference's :func:`shard_graph_auto`/:func:`run_auto` place a graph's
arrays on a mesh with named shardings and let GSPMD partition the
unchanged engine. Eager torch has no such compiler, so the port has their
one-rank form: the graph goes to the mesh's device and ``run_auto`` is
``engine.run``. A mesh of more than one rank is refused (ROADMAP.md).

The port keeps the reference's backend names so that call sites carry
over, with these meanings:

- ``"pallas"``: the hand-written CUDA ring kernels (``ops/ring.py``): the
  hop (B2) and, on the MXU bucket layout, the hop fused with the segment
  sum (B3). On a CPU tensor their plain versions run.
- ``"ppermute"``: the plain torch hop (``torch.roll`` of the stacked
  shards), each bucket applied apart.
- ``"auto"``: ``"pallas"`` on a CUDA device, ``"ppermute"`` on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

COMM_BACKENDS = ("ppermute", "pallas")


def resolve_comm(comm: str = "auto", device=None) -> str:
    """The backend ``comm`` names on ``device``; raises on an unknown
    name."""
    if comm == "auto":
        return "pallas" if torch.device(device or "cpu").type == "cuda" \
            else "ppermute"
    if comm not in COMM_BACKENDS:
        raise ValueError(
            f"comm must be one of {COMM_BACKENDS + ('auto',)}, got {comm!r}")
    return comm


def _to(x, device):
    """``x`` with every tensor in it (nested frozen dataclasses, as a
    ``Graph`` and its layouts) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _to(getattr(x, f.name), device)
            for f in dataclasses.fields(x) if f.init})
    return x


def shard_graph_auto(graph, mesh, axis_name: str = "shards"):
    """``graph`` placed on ``mesh`` (a ``RingMesh`` or
    ``multihost.Mesh2D``) for :func:`run_auto`: in one process, on the
    mesh's device. ``axis_name`` must name one of the mesh's axes."""
    ring = getattr(mesh, "ring", mesh)
    names = getattr(mesh, "axis_names", (ring.axis_name,))
    if axis_name not in names:
        raise ValueError(f"axis {axis_name!r} is not one of the mesh's "
                         f"{names}")
    if ring.world > 1:
        raise NotImplementedError(
            f"shard_graph_auto over {ring.world} ranks: the reference's "
            f"GSPMD partitioning has no eager-torch counterpart; it waits "
            f"in ROADMAP.md, section A, \"auto.shard_graph_auto across "
            f"ranks\". Use the ring (parallel/sharded.py) across ranks")
    return _to(graph, ring.device)


def run_auto(graph, protocol, key, rounds: int):
    """Run ``rounds`` protocol rounds on a :func:`shard_graph_auto` graph:
    ``engine.run`` (the reference's is ``engine.run`` too, with GSPMD
    partitioning the compiled program)."""
    from p2pnetwork_tpu_torch.sim import engine

    return engine.run(graph, protocol, key, rounds)
