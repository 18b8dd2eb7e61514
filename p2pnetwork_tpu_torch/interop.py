"""Carry a graph, a sharded graph, a protocol state, a batched message or
query state, or a PRNG key across from the JAX package.

The port imports nothing of ``p2pnetwork_tpu``; the caller turns the JAX
objects into plain dicts of numpy arrays and ints (the dataclass fields by
name, nested dicts for ``blocked``, ``hybrid`` and ``skew``) and these
functions build the port's objects from them on ``device``. The tests use
this to run both packages on the very same graph, shards and state.
A field the port does not model is refused when it is set, never dropped.
Packed predicate words (the reference's ``uint32``) arrive as ``int32``
with the same bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from p2pnetwork_tpu_torch import _device, prng
from p2pnetwork_tpu_torch import models as M
from p2pnetwork_tpu_torch.models import (AdaptiveFloodBitState,
                                         AdaptiveFloodState, FloodBitState,
                                         FloodState)
from p2pnetwork_tpu_torch.models.messagebatch import MessageBatch
from p2pnetwork_tpu_torch.models.querybatch import QueryBatch
from p2pnetwork_tpu_torch.ops.blocked import BlockedEdges
from p2pnetwork_tpu_torch.ops.diag import HybridEdges
from p2pnetwork_tpu_torch.ops.skew import SkewTable
from p2pnetwork_tpu_torch.parallel.mesh import RingMesh
from p2pnetwork_tpu_torch.parallel.sharded import ShardedGraph, row_extent
from p2pnetwork_tpu_torch.sim.graph import Graph


def _t(x, dev):
    if x is None:
        return None
    a = np.array(x)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a).to(dev)


def _refuse_unmodelled(fields: dict, known, what: str) -> None:
    """Raise for a set field the port's ``what`` does not model."""
    extra = sorted(k for k, v in fields.items()
                   if k not in known and v is not None)
    if extra:
        raise NotImplementedError(
            f"the port's {what} does not model {extra}; refusing to drop "
            f"them")


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
    ``remainder`` (a ``blocked``-style dict or None), ``skew`` one with
    ``src``/``mask``/``owner``/``start``/``weight``. Weights
    (``edge_weight``, ``neighbor_weight``, the skew ``weight``) and the
    node relabeling of a reordered build (``layout_perm``,
    ``layout_inv``) are carried; a set field the port does not model is
    refused."""
    dev = _device.resolve(device)
    _refuse_unmodelled(fields, {f.name for f in dataclasses.fields(Graph)},
                       "Graph")
    kw = {}
    for f in dataclasses.fields(Graph):
        if f.name not in fields:
            continue
        v = fields[f.name]
        if f.name == "blocked":
            kw[f.name] = _blocked(v, dev)
        elif f.name == "skew" and v is not None:
            _refuse_unmodelled(v, {f.name for f in dataclasses.fields(
                SkewTable)}, "SkewTable")
            kw[f.name] = SkewTable(**{k.name: _t(v.get(k.name), dev)
                                      for k in dataclasses.fields(SkewTable)})
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
    the work-item lists, an ``AdaptiveFloodState``, on ``device``; their
    packed twins (``FloodBitState``, ``AdaptiveFloodBitState``) when
    ``seen`` is packed words (``uint32``)."""
    dev = _device.resolve(device)
    packed = np.asarray(fields["seen"]).dtype == np.uint32
    cls = {(False, False): FloodState, (False, True): FloodBitState,
           (True, False): AdaptiveFloodState,
           (True, True): AdaptiveFloodBitState}["fidx" in fields, packed]
    _refuse_unmodelled(fields, {f.name for f in dataclasses.fields(cls)},
                       cls.__name__)
    return cls(**{f.name: _t(fields[f.name], dev)
                  for f in dataclasses.fields(cls)})


#: The protocols' states beyond the floods', by the class name both
#: packages use.
_PROTOCOL_STATES = {c.__name__: c for c in (
    M.SIRState, M.GossipState, M.PushSumState, M.PageRankState,
    M.HopDistanceState, M.AdaptiveHopDistanceState, M.LeaderElectionState,
    M.ConnectedComponentsState, M.SpanningTreeState, M.LubyMISState,
    M.KCoreState, M.DistanceVectorState, M.RandomWalksState,
    M.PlumtreeState, M.PlumtreeBitState, M.BrachaState, M.HITSState,
    M.LabelPropagationState, M.BipartiteCheckState, M.BoruvkaState,
    M.VivaldiState, M.FailureDetectorState, M.AntiEntropyState)}


def protocol_state_from_numpy(name: str, fields: dict, device=None):
    """The port's state class ``name`` (the reference's name:
    ``"SIRState"``, ``"DistanceVectorState"``, ... any of
    ``_PROTOCOL_STATES``) from the reference state's fields as numpy
    arrays, on ``device``."""
    cls = _PROTOCOL_STATES[name]
    _refuse_unmodelled(fields, {f.name for f in dataclasses.fields(cls)},
                       name)
    dev = _device.resolve(device)
    return cls(**{f.name: _t(fields[f.name], dev)
                  for f in dataclasses.fields(cls)})


def message_batch_from_numpy(fields: dict, device=None) -> MessageBatch:
    """The port's :class:`MessageBatch` from a reference ``MessageBatch``'s
    fields (the ``uint32`` planes arrive as ``int32`` with the same bits),
    so a batch the reference admitted resumes in the port."""
    _refuse_unmodelled(fields, {f.name for f in dataclasses.fields(
        MessageBatch)}, "MessageBatch")
    dev = _device.resolve(device)
    return MessageBatch(**{f.name: _t(fields[f.name], dev)
                           for f in dataclasses.fields(MessageBatch)})


def query_batch_from_numpy(fields: dict, device=None) -> QueryBatch:
    """The port's :class:`QueryBatch` from a reference ``QueryBatch``'s
    fields, ``payload`` a dict of numpy arrays (``dist``, ``cur`` or
    ``s``/``w``)."""
    _refuse_unmodelled(fields, {f.name for f in dataclasses.fields(
        QueryBatch)}, "QueryBatch")
    dev = _device.resolve(device)
    kw = {f.name: _t(fields[f.name], dev)
          for f in dataclasses.fields(QueryBatch) if f.name != "payload"}
    return QueryBatch(payload={k: _t(v, dev)
                               for k, v in fields["payload"].items()}, **kw)


def key_from_numpy(data) -> np.ndarray:
    """The port's key (``prng.py``) from ``jax.random.key_data(k)`` as
    numpy ``uint32[2]``: the same words, so both packages draw the same
    numbers from it."""
    return prng.wrap_key_data(np.asarray(data))


def sharded_graph_from_numpy(fields: dict, mesh: RingMesh) -> ShardedGraph:
    """The port's :class:`ShardedGraph` on ``mesh.device`` from a reference
    ``ShardedGraph``'s fields: the global ``[S, ...]`` arrays (``np.asarray``
    of a sharded JAX array gathers them), the static ints and
    ``diag_pieces``. The dynamic region (runtime links), the neighbor
    table and the sender-CSR view are carried. ``mxu_extent``, the port's
    own field, is derived from the MXU arrays as ``shard_graph`` derives
    it."""
    if fields["n_shards"] != mesh.n_shards:
        raise ValueError(f"the fields are sharded {fields['n_shards']} ways, "
                         f"the mesh has {mesh.n_shards} shards")
    kw = {}
    for f in dataclasses.fields(ShardedGraph):
        if f.name not in fields:
            continue
        v = fields[f.name]
        if f.name == "diag_pieces":
            kw[f.name] = tuple((int(t), int(r)) for t, r in v)
        elif isinstance(v, np.ndarray):
            kw[f.name] = _t(v, mesh.device)
        else:
            kw[f.name] = v
    if fields.get("mxu_src") is not None:
        kw["mxu_extent"] = _t(row_extent(*(np.asarray(fields[k]) for k in (
            "mxu_src", "mxu_dst", "mxu_mask"))), mesh.device)
    return ShardedGraph(**kw)
