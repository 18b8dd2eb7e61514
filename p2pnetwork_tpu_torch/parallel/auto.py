"""Routing of the ring's halo-exchange backend and the auto-sharded path
(torch counterpart of ``p2pnetwork_tpu/parallel/auto.py``).

The reference's :func:`shard_graph_auto`/:func:`run_auto` place a graph's
arrays on a mesh with named shardings and let GSPMD partition the
unchanged engine. The collectives GSPMD inserts there are node-extent
only (one frontier all-gather a flood round, the f32 pressure for SIR,
scalar stats; the reference's ``tests/test_auto_comm.py``). Eager torch
has no such compiler, so the port writes that partition out as
owner-computes:

- in one process the graph goes to the mesh's device, whole;
- on a ring split over ranks (``multihost.hierarchical_ring_mesh``) each
  rank keeps its part (``sim/graph.py`` ``graph_part``): the node-extent
  fields whole, and the edges whose receiver lies in its nodes ``[lo,
  hi)``, the ``n_local`` shards it holds on the ring. Every aggregation
  (``ops/segment.py``) computes the owned slice from those edges and one
  ``parallel/mesh.py`` ``assemble`` (``ring_gather``, B2's pass form)
  makes the whole result on every rank; sums keyed by sender or by
  component fold every rank's partial (``mesh.combine``). The node state
  is replicated, bit for bit on every rank, so every rank takes the same
  branches and makes the same exchanges in the same order.

``run_auto`` is ``engine.run`` either way, as the reference's is, and
``engine.run_until_coverage``/``run_until_converged`` and the batch and
query loops take a part too, for every protocol of ``models/`` (each
carries ``RUNS_ON_PART``), by every method, ``frontier`` included: its
budget, like the adaptive wave's slice width and work items, is decided
on the whole graph's rows (``sim/graph.py`` ``Part``), so every rank
takes the same branch. The library functions of ``models/`` (hop
distances and diameter bounds, centrality, triangles and the wedge
sample, coloring) take a part as well, and so do the dynamic edge region
(whole on every rank: ``sim/topology.py``) and the failures
(``sim/failures.py``). A ``multihost.Mesh2D`` is cut along its ring's
host-major shard order, whichever axis is named: the reference's
``P("ici")`` replicates the graph across hosts where the port splits it
over every rank, a difference of placement, not of result. The engine
still refuses, by name, a protocol without ``RUNS_ON_PART`` (a user's
own, which may read the edge arrays or the neighbor table past the op
layer and would see the rank's edges alone).

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

from p2pnetwork_tpu_torch.sim.graph import graph_part

COMM_BACKENDS = ("ppermute", "pallas")


def resolve_comm(comm: str = "auto", device=None) -> str:
    """The backend ``comm`` names on ``device`` (the card unless named, as
    ``_device.resolve`` defaults); raises on an unknown name."""
    if comm == "auto":
        dev = torch.device("cuda" if device is None else device)
        return "pallas" if dev.type == "cuda" else "ppermute"
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
    ``multihost.Mesh2D``) for :func:`run_auto`: in one process the whole
    graph on the mesh's device; on a ring split over ranks the rank's
    part (``sim/graph.py`` ``graph_part``), which every rank of the ring
    builds from the same whole graph. ``axis_name`` must name one of the
    mesh's axes; on a ``Mesh2D`` either axis cuts the part along the
    ring's host-major shard order (``multihost.hierarchical_ring_mesh``),
    so the ranks of a host hold consecutive nodes."""
    ring = getattr(mesh, "ring", mesh)
    names = getattr(mesh, "axis_names", (ring.axis_name,))
    if axis_name not in names:
        raise ValueError(f"axis {axis_name!r} is not one of the mesh's "
                         f"{names}")
    if ring.world == 1:
        return _to(graph, ring.device)
    return graph_part(graph, ring)


def run_auto(graph, protocol, key, rounds: int):
    """Run ``rounds`` protocol rounds on a :func:`shard_graph_auto` graph
    or part: ``engine.run`` (the reference's is ``engine.run`` too, with
    GSPMD partitioning the compiled program). On a part every rank of the
    ring calls it with the same arguments."""
    from p2pnetwork_tpu_torch.sim import engine

    return engine.run(graph, protocol, key, rounds)
