"""Carry a graph, a sharded graph or a flood state across from the JAX
package.

The port imports nothing of ``p2pnetwork_tpu``; the caller turns the JAX
objects into plain dicts of numpy arrays and ints (the dataclass fields by
name, nested dicts for ``blocked`` and ``hybrid``) and these functions
build the port's objects from them on ``device``. The tests use this to
run both packages on the very same graph, shards and state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from p2pnetwork_tpu_torch import _device
from p2pnetwork_tpu_torch.models.adaptive_flood import AdaptiveFloodState
from p2pnetwork_tpu_torch.models.flood import FloodState
from p2pnetwork_tpu_torch.ops.blocked import BlockedEdges
from p2pnetwork_tpu_torch.ops.diag import HybridEdges
from p2pnetwork_tpu_torch.parallel.mesh import RingMesh
from p2pnetwork_tpu_torch.parallel.sharded import ShardedGraph
from p2pnetwork_tpu_torch.sim.graph import Graph


def _t(x, dev):
    return None if x is None else torch.from_numpy(np.array(x)).to(dev)


def _blocked(d, dev):
    if d is None:
        return None
    return BlockedEdges(src=_t(d["src"], dev), local_dst=_t(d["local_dst"], dev),
                        mask=_t(d["mask"], dev), block=int(d["block"]))


def graph_from_numpy(fields: dict, device=None) -> Graph:
    """The port's :class:`Graph` from a reference ``Graph``'s fields.

    ``fields`` maps field names to numpy arrays (or None) and the static
    ints; ``blocked`` is a dict with ``src``/``local_dst``/``mask``/
    ``block``, ``hybrid`` one with ``masks``/``offsets``/``n``/
    ``remainder`` (a ``blocked``-style dict or None). Fields the port does
    not model are ignored; non-None dynamic edges are refused."""
    dev = _device.resolve(device)
    if fields.get("dyn_senders") is not None:
        raise NotImplementedError(
            "the dynamic edge region (runtime connects) is not ported yet")
    kw = {}
    for f in dataclasses.fields(Graph):
        if f.name not in fields:
            continue
        v = fields[f.name]
        if f.name == "blocked":
            kw[f.name] = _blocked(v, dev)
        elif f.name == "hybrid":
            kw[f.name] = None if v is None else HybridEdges(
                masks=_t(v["masks"], dev),
                remainder=_blocked(v["remainder"], dev),
                offsets=tuple(int(o) for o in v["offsets"]), n=int(v["n"]))
        elif isinstance(v, np.ndarray):
            kw[f.name] = _t(v, dev)
        else:
            kw[f.name] = v
    return Graph(**kw)


def flood_state_from_numpy(fields: dict, device=None):
    """A ``FloodState`` (``seen``/``frontier``) or, when the fields carry
    the work-item lists, an ``AdaptiveFloodState``, on ``device``."""
    dev = _device.resolve(device)
    cls = AdaptiveFloodState if "fidx" in fields else FloodState
    return cls(**{f.name: _t(fields[f.name], dev)
                  for f in dataclasses.fields(cls)})


#: ``ShardedGraph`` fields the port does not read: carried as None.
_SHARDED_UNPORTED = ("neighbors", "neighbors_mask", "csr_pos", "csr_offsets")


def sharded_graph_from_numpy(fields: dict, mesh: RingMesh) -> ShardedGraph:
    """The port's :class:`ShardedGraph` on ``mesh.device`` from a reference
    ``ShardedGraph``'s fields: the global ``[S, ...]`` arrays (``np.asarray``
    of a sharded JAX array gathers them), the static ints and
    ``diag_pieces``. The neighbor table and the sender-CSR view are
    dropped (nothing ported reads them); a live dynamic region is
    refused."""
    if fields.get("dyn_src") is not None:
        raise NotImplementedError(
            "the dynamic edge region (runtime connects) is not ported yet")
    if fields["n_shards"] != mesh.n_shards:
        raise ValueError(f"the fields are sharded {fields['n_shards']} ways, "
                         f"the mesh has {mesh.n_shards} shards")
    kw = {}
    for f in dataclasses.fields(ShardedGraph):
        if f.name not in fields or f.name in _SHARDED_UNPORTED:
            continue
        v = fields[f.name]
        if f.name == "diag_pieces":
            kw[f.name] = tuple((int(t), int(r)) for t, r in v)
        elif isinstance(v, np.ndarray):
            kw[f.name] = _t(v, mesh.device)
        else:
            kw[f.name] = v
    return ShardedGraph(**kw)
