"""Checkpoint / resume for simulation runs, and graph files (torch
counterpart of ``p2pnetwork_tpu/sim/checkpoint.py``).

A checkpoint is the protocol state plus the PRNG key, the round counter
and the message counter: everything a resumed run needs to be
bit-identical to an uninterrupted one. The failures and runtime links a
graph has taken are state too (:func:`topology_state`,
:func:`apply_topology_state`). A graph file (:func:`save_graph`) holds a
built graph with its layouts, so a topology's host build is paid once.

The format is the reference's, so files cross both ways: a single
``.npz`` written atomically, the state's leaves as ``leaf_<i>`` in
flattening order, ``__key__`` (the key's ``uint32[2]`` words),
``__round__`` and ``__messages__`` (int64), ``__treedef__`` (the state's
tree structure as JAX prints it) and ``__sha256__``, a digest of every
other entry that :func:`load` verifies. The port renders the treedef
string from its own dataclasses (same class names, same field order), and
writes the packed predicate words it holds as ``int32`` (the fields a
state class names in its ``U32_WORDS``) back as the reference's
``uint32``, so a port-written file of a state carries the
reference's digest. Loaded leaves land as tensors on the template's
device.

A ring state split over ranks (``parallel/multihost.py``) is saved and
restored by :func:`save_orbax` / :func:`load_orbax`, the reference's
names and signatures, into a directory of the port's own format: one
:func:`save` file a ring shard and a JSON manifest (:data:`MANIFEST`).
Every rank writes its own shards; a load restores onto the template's
ring at any world that divides the shard count, one process included.
The port does not read orbax's format: a directory the JAX package's
``save_orbax`` wrote has no manifest and is refused by name.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import tempfile
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from p2pnetwork_tpu_torch import _device, prng


class CheckpointCorrupt(RuntimeError):
    """A checkpoint file failed integrity verification (truncated,
    bit-flipped or unreadable), as opposed to a template mismatch, which
    stays a ``ValueError``. Carries the path and, for a digest mismatch,
    the expected and actual digests."""

    def __init__(self, path: str, detail: str = "",
                 expected: Optional[str] = None, actual: Optional[str] = None):
        self.path = path
        self.expected = expected
        self.actual = actual
        msg = f"corrupt checkpoint {path!r}"
        if expected is not None:
            msg += (f": content hash mismatch (expected {expected}, got "
                    f"{actual})")
        elif detail:
            msg += f": {detail}"
        super().__init__(msg)


#: npz entry carrying the content digest; excluded from its own hash.
_DIGEST_KEY = "__sha256__"

def _payload_digest(payload: Dict[str, np.ndarray]) -> str:
    """sha256 over every entry (name, dtype, shape, raw bytes) in sorted
    name order, the digest itself excluded."""
    h = hashlib.sha256()
    for name in sorted(payload):
        if name == _DIGEST_KEY:
            continue
        arr = np.ascontiguousarray(payload[name])
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(repr(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


# ------------------------------------------------------------ tree walks
#
# A state is a tree of dataclasses (the protocol states, MessageBatch,
# QueryBatch), dicts, lists and tuples, with None as an empty node and
# everything else a leaf: JAX's pytree rules for these types, so the
# leaves come out in the reference's order and the structure prints as
# its ``str(treedef)``.


def _is_node(x) -> bool:
    return (x is None or isinstance(x, (dict, list, tuple))
            or (dataclasses.is_dataclass(x) and not isinstance(x, type)))


def _children(x):
    """``[(field or None, child)]`` of a node, in flattening order."""
    if isinstance(x, dict):
        return [(None, x[k]) for k in sorted(x)]
    if isinstance(x, (list, tuple)):
        return [(None, c) for c in x]
    return [(f.name, getattr(x, f.name)) for f in dataclasses.fields(x)]


def treedef_str(tree) -> str:
    """The tree's structure as ``str(jax.tree_util.tree_flatten(tree)[1])``
    prints it, e.g. ``PyTreeDef(CustomNode(FloodState[()], [*, *]))``."""
    def render(x) -> str:
        if x is None:
            return "None"
        if not _is_node(x):
            return "*"
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {render(x[k])}"
                                   for k in sorted(x)) + "}"
        if isinstance(x, list):
            return "[" + ", ".join(render(c) for c in x) + "]"
        if isinstance(x, tuple):
            inner = ", ".join(render(c) for c in x)
            return f"({inner},)" if len(x) == 1 else f"({inner})"
        kids = ", ".join(render(c) for _, c in _children(x))
        return f"CustomNode({type(x).__name__}[()], [{kids}])"
    return f"PyTreeDef({render(tree)})"


def _leaves(tree) -> List[Tuple[Any, bool]]:
    """``[(leaf, is_u32_words)]`` in flattening order."""
    out: List[Tuple[Any, bool]] = []

    def walk(x, words=False):
        if x is None:
            return
        if not _is_node(x):
            out.append((x, words))
            return
        u32 = getattr(type(x), "U32_WORDS", ())
        for name, c in _children(x):
            walk(c, name in u32)
    walk(tree)
    return out


def _unflatten(template, leaves: List[Any]):
    """``template``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(x):
        if x is None:
            return None
        if not _is_node(x):
            return next(it)
        if isinstance(x, dict):
            new = {k: build(x[k]) for k in sorted(x)}
            return {k: new[k] for k in x}
        if isinstance(x, (list, tuple)):
            return type(x)(build(c) for c in x)
        return dataclasses.replace(x, **{n: build(c)
                                         for n, c in _children(x)})
    return build(template)


def _to_host(leaf, words: bool) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        arr = leaf.detach().cpu().numpy()
    else:
        arr = np.asarray(leaf)
    if words and arr.dtype == np.int32:
        arr = arr.view(np.uint32)
    return arr


def _like(arr: np.ndarray, template_leaf):
    """A loaded leaf in the template leaf's form: a tensor on its device
    (``uint32`` words as ``int32`` with the same bits), else numpy."""
    if not isinstance(template_leaf, torch.Tensor):
        return arr
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.array(arr)).to(template_leaf.device)


# ------------------------------------------------------------ checkpoints


def _write_npz(path: str, payload: Dict[str, np.ndarray]) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save(path: str, state: Any, key, round_index: int,
         message_count: int = 0) -> None:
    """Atomically write (state, PRNG key, round counter, message counter)
    to ``path`` with the embedded digest :func:`load` verifies."""
    payload = {f"leaf_{i}": _to_host(x, words)
               for i, (x, words) in enumerate(_leaves(state))}
    payload["__key__"] = prng.key_data(key)
    payload["__round__"] = np.asarray(round_index, dtype=np.int64)
    payload["__messages__"] = np.asarray(message_count, dtype=np.int64)
    payload["__treedef__"] = np.frombuffer(treedef_str(state).encode(),
                                           dtype=np.uint8)
    payload[_DIGEST_KEY] = np.frombuffer(
        _payload_digest(payload).encode(), dtype=np.uint8)
    _write_npz(path, payload)


def load(path: str, template: Any, *,
         grow: bool = False) -> Tuple[Any, np.ndarray, int, int]:
    """Load a checkpoint written by :func:`save` (by either package).

    ``template`` is a state of the same structure (e.g. a fresh
    ``protocol.init(...)``); its structure string must equal the file's
    (else ``ValueError``). Returns ``(state, key, round_index,
    message_count)``, the leaves as tensors on the template leaves'
    devices. ``grow=True`` zero-extends leaves written before a
    ``Graph.grow`` repad into the template's larger shapes
    (:func:`grow_state`). A truncated, bit-flipped or unreadable file
    raises :class:`CheckpointCorrupt`; a file without a digest loads
    unverified."""
    try:
        # Read every member inside the guard: npz members load lazily.
        with np.load(path) as data:
            payload = {k: np.asarray(data[k]) for k in data.files}
    except (zipfile.BadZipFile, OSError, EOFError, KeyError,
            ValueError) as e:
        raise CheckpointCorrupt(
            path, detail=f"{type(e).__name__}: {e}") from e
    if _DIGEST_KEY in payload:
        stored_digest = bytes(payload[_DIGEST_KEY]).decode()
        actual = _payload_digest(payload)
        if stored_digest != actual:
            raise CheckpointCorrupt(path, expected=stored_digest,
                                    actual=actual)
    if "__treedef__" not in payload or "__round__" not in payload \
            or "__key__" not in payload:
        raise CheckpointCorrupt(
            path, detail="missing checkpoint bookkeeping entries "
            "(not a checkpoint file, or truncated before the hash format)")
    stored = bytes(payload["__treedef__"]).decode()
    expected = treedef_str(template)
    if stored != expected:
        raise ValueError(f"checkpoint structure mismatch:\n  file: "
                         f"{stored}\n  template: {expected}")
    t_leaves = [x for x, _ in _leaves(template)]
    n = len([k for k in payload if k.startswith("leaf_")])
    if n != len(t_leaves):
        raise ValueError(f"checkpoint has {n} leaves, template "
                         f"{len(t_leaves)}")
    state = _unflatten(template, [_like(payload[f"leaf_{i}"], t)
                                  for i, t in enumerate(t_leaves)])
    if grow:
        state = grow_state(state, template)
    messages = (int(payload["__messages__"]) if "__messages__" in payload
                else 0)
    return (state, prng.wrap_key_data(payload["__key__"]),
            int(payload["__round__"]), messages)


def _dtype_shape(x):
    if isinstance(x, torch.Tensor):
        return x.dtype, tuple(x.shape)
    a = np.asarray(x)
    return a.dtype, a.shape


def grow_state(state: Any, template: Any) -> Any:
    """Zero-extend every leaf of ``state`` into ``template``'s shapes: the
    resume half of ``Graph.grow``'s repad (growth padding is dead, and
    zero is every protocol's state for dead padding). Each leaf must have
    its template leaf's dtype and rank and be no larger along any axis,
    else ``ValueError``; leaves of the template's shape pass through."""
    if treedef_str(state) != treedef_str(template):
        raise ValueError(f"state structure mismatch:\n  state: "
                         f"{treedef_str(state)}\n  template: "
                         f"{treedef_str(template)}")
    out = []
    pairs = zip(_leaves(state), _leaves(template))
    for i, ((s, _), (t, _)) in enumerate(pairs):
        s_dtype, s_shape = _dtype_shape(s)
        t_dtype, t_shape = _dtype_shape(t)
        if s_shape == t_shape and s_dtype == t_dtype:
            out.append(s)
            continue
        if (s_dtype != t_dtype or len(s_shape) != len(t_shape)
                or any(a > b for a, b in zip(s_shape, t_shape))):
            raise ValueError(
                f"state leaf {i} is not repad-growable: saved "
                f"{s_dtype}{s_shape}, template {t_dtype}{t_shape}: a "
                f"repad-compatible leaf matches dtype and rank and only "
                f"grows along axes")
        region = tuple(slice(0, d) for d in s_shape)
        if isinstance(t, torch.Tensor):
            grown = torch.zeros(t_shape, dtype=t_dtype, device=t.device)
            grown[region] = torch.as_tensor(s).to(t.device)
        else:
            grown = np.zeros(t_shape, s_dtype)
            grown[region] = np.asarray(s)
        out.append(grown)
    return _unflatten(template, out)


# -------------------------------------------------------- topology state


def topology_state(graph) -> Dict[str, Any]:
    """The graph's runtime-mutable arrays as a checkpointable dict:
    liveness masks, degrees, the dynamic edge region and the masks of the
    attached layouts. The static arrays are not stored: attach the same
    pristine build and re-apply with :func:`apply_topology_state`."""
    ts: Dict[str, Any] = {
        "node_mask": graph.node_mask,
        "edge_mask": graph.edge_mask,
        "in_degree": graph.in_degree,
        "out_degree": graph.out_degree,
    }
    if graph.neighbor_mask is not None:
        ts["neighbor_mask"] = graph.neighbor_mask
    if graph.dyn_senders is not None:
        ts["dyn_senders"] = graph.dyn_senders
        ts["dyn_receivers"] = graph.dyn_receivers
        ts["dyn_mask"] = graph.dyn_mask
    if graph.blocked is not None:
        ts["blocked_mask"] = graph.blocked.mask
    if graph.hybrid is not None:
        ts["hybrid_masks"] = graph.hybrid.masks
        if graph.hybrid.remainder is not None:
            ts["hybrid_remainder_mask"] = graph.hybrid.remainder.mask
    return ts


def apply_topology_state(graph, ts: Dict[str, Any]):
    """Re-apply a :func:`topology_state` onto a structurally equal graph
    (the same representations and shapes as the one it was taken from).
    Returns a new graph whose failed nodes, cut edges, runtime links and
    degrees are the saved ones. A state without ``neighbor_mask`` onto a
    graph with a width-capped table drops the table, as the run it came
    from did."""
    def _shape(name, current):
        saved_shape = tuple(np.shape(ts[name]))
        if current is None or saved_shape != tuple(current.shape):
            raise ValueError(
                f"topology state mismatch for {name!r}: saved shape "
                f"{saved_shape}, graph has "
                f"{None if current is None else tuple(current.shape)}: "
                f"attach the same graph construction the checkpoint came "
                f"from")

    dev = graph.device
    ts = {k: (v.to(dev) if isinstance(v, torch.Tensor)
              else torch.from_numpy(np.array(v)).to(dev))
          for k, v in ts.items()}
    expected = set(topology_state(graph))
    got = set(ts)
    drop_neighbor_table = False
    if expected - got == {"neighbor_mask"} and not graph.neighbors_complete:
        drop_neighbor_table = True
        expected.discard("neighbor_mask")
    if expected != got:
        raise ValueError(
            f"topology state keys mismatch: checkpoint has {sorted(got)}, "
            f"attached graph expects {sorted(expected)}: attach a graph "
            f"with the same representations (capacity, neighbor table, "
            f"blocked/hybrid) as the one checkpointed")
    for name in ("node_mask", "edge_mask", "in_degree", "out_degree"):
        _shape(name, getattr(graph, name))
    kw: Dict[str, Any] = {name: ts[name] for name in (
        "node_mask", "edge_mask", "in_degree", "out_degree")}
    if "neighbor_mask" in ts:
        _shape("neighbor_mask", graph.neighbor_mask)
        kw["neighbor_mask"] = ts["neighbor_mask"]
    elif drop_neighbor_table:
        kw["neighbors"] = kw["neighbor_mask"] = None
    if "dyn_senders" in ts:
        _shape("dyn_senders", graph.dyn_senders)
        for name in ("dyn_senders", "dyn_receivers", "dyn_mask"):
            kw[name] = ts[name]
    if "blocked_mask" in ts:
        _shape("blocked_mask", graph.blocked.mask)
        kw["blocked"] = dataclasses.replace(graph.blocked,
                                            mask=ts["blocked_mask"])
    if "hybrid_masks" in ts:
        _shape("hybrid_masks", graph.hybrid.masks)
        remainder = graph.hybrid.remainder
        if "hybrid_remainder_mask" in ts:
            _shape("hybrid_remainder_mask", remainder.mask)
            remainder = dataclasses.replace(
                remainder, mask=ts["hybrid_remainder_mask"])
        kw["hybrid"] = dataclasses.replace(
            graph.hybrid, masks=ts["hybrid_masks"], remainder=remainder)
    return dataclasses.replace(graph, **kw)


def load_node_payload(path: str, graph, protocol_state_template):
    """Load a node checkpoint (a payload dict with ``protocol``,
    ``topology`` and ``churn_count``), as the reference's
    ``JaxSimNode.save_checkpoint`` writes it. Returns ``(payload, key,
    round, messages)``. A run that dropped its width-capped neighbor
    table saved no ``neighbor_mask``: retried with a table-less template.
    A checkpoint of the bare protocol state (the older format) loads with
    the graph's topology as attached."""
    ts_template = topology_state(graph)

    def _template(ts):
        return {"protocol": protocol_state_template, "topology": ts,
                "churn_count": np.int64(0)}

    try:
        return load(path, _template(ts_template))
    except ValueError as err:
        if "neighbor_mask" in ts_template and not graph.neighbors_complete:
            ts2 = dict(ts_template)
            ts2.pop("neighbor_mask")
            try:
                return load(path, _template(ts2))
            except ValueError:
                pass
        try:
            state, key, rnd, msgs = load(path, protocol_state_template)
        except ValueError:
            raise err
        payload = {"protocol": state, "topology": topology_state(graph),
                   "churn_count": np.int64(0)}
        return payload, key, rnd, msgs


# ------------------------------------------------- sharded checkpoints
#
# The reference's ``save_orbax``/``load_orbax`` write and read orbax's
# format with the arrays' shardings. The port keeps the roles in a format
# of its own: per-shard files in :func:`save`'s format and a manifest.

#: The manifest of a sharded checkpoint directory, and its format tag.
MANIFEST = "manifest.json"
SHARDED_FORMAT = "p2pnetwork_tpu_torch.sharded_checkpoint"


def _shard_file(d: int) -> str:
    return f"shard_{d:05d}.npz"


def _per_shard(leaf) -> bool:
    """The default placement of a state leaf: per-shard (axis 0 the
    shards held here) for a tensor of two or more dimensions, as every
    ring state's ``[n_local, block, ...]`` and topology leaf is;
    replicated on every rank otherwise (walk positions, counters, keys).
    A state with another layout names it (``per_shard=``)."""
    return isinstance(leaf, torch.Tensor) and leaf.dim() >= 2


def _placement(state, per_shard) -> List[bool]:
    """Each leaf's placement, in flattening order: from ``per_shard`` (a
    tree of the state's structure holding a bool a leaf, True for a
    leaf split over the ring's shards on axis 0) when given, else
    :func:`_per_shard`'s default."""
    leaves = [x for x, _ in _leaves(state)]
    if per_shard is None:
        return [_per_shard(x) for x in leaves]
    if treedef_str(per_shard) != treedef_str(state):
        raise ValueError(f"per_shard does not match the state's structure:"
                         f"\n  per_shard: {treedef_str(per_shard)}\n  "
                         f"state: {treedef_str(state)}")
    flags = [bool(f) for f, _ in _leaves(per_shard)]
    for i, (x, f) in enumerate(zip(leaves, flags)):
        if f and not (isinstance(x, torch.Tensor) and x.dim() >= 1):
            raise ValueError(f"leaf {i} is placed per-shard but has no "
                             f"shard axis (a tensor of >= 1 dimension)")
    return flags


def _ring_layout(n_local: Optional[int]):
    """``(S, shard_lo, n_local, world, group)`` of the ring a state lives
    on: the process group's ranks, host-major as
    ``multihost.hierarchical_ring_mesh`` lays them, each holding
    ``n_local`` shards (the leaves' axis 0); one process holds them
    all."""
    if n_local is None:
        raise ValueError("a state with no per-shard leaf names no ring to "
                         "save or restore")
    from p2pnetwork_tpu_torch.parallel import multihost

    rank, world = multihost._world()
    order = multihost._ranks_host_major()
    group = None
    if world > 1:
        import torch.distributed as dist

        group = dist.group.WORLD
    return (n_local * world, order.index(rank) * n_local, n_local, world,
            group)


def _n_local(leaves, flags) -> Optional[int]:
    sizes = {int(x.shape[0]) for x, f in zip(leaves, flags) if f}
    if len(sizes) > 1:
        raise ValueError(f"per-shard leaves disagree on the shards held "
                         f"here: {sorted(sizes)}; a state of other leaves "
                         f"names each leaf's placement (per_shard=)")
    return sizes.pop() if sizes else None


def _global_shape(x, per_shard: bool, S: int) -> list:
    """A leaf's shape in the whole ring: axis 0 the ``S`` shards for a
    per-shard leaf, its own shape for a replicated one."""
    shape = list(_dtype_shape(x)[1])
    return [S] + shape[1:] if per_shard else shape


def _barrier(world: int, group) -> None:
    if world > 1:
        import torch.distributed as dist

        dist.barrier(group=group)


def save_orbax(path: str, state: Any, key, round_index: int,
               message_count: int = 0, *, per_shard=None) -> None:
    """Checkpoint a ring state (``[n_local, ...]`` leaves on each rank of
    a ring split over processes, or the whole ``[S, ...]`` in one) into
    the directory ``path``, created or overwritten. Every rank of the
    ring calls it together (the reference's collective ``save_orbax``).

    The directory is the port's own, not orbax's: ``shard_<d>.npz`` for
    each ring shard ``d``, in :func:`save`'s format (the per-shard leaves
    cut to the shard's row, the replicated leaves whole, its
    ``__sha256__``), written by the rank that holds it; then, after a
    barrier, rank 0 writes :data:`MANIFEST` (the shard count, the block,
    the world at save, the key, round and message counters, the leaves'
    global shapes and each shard file's digest). The ring is the process
    group's (``multihost.hierarchical_ring_mesh``'s order).

    Each leaf's placement, the counterpart of the reference's array
    sharding, is per-shard (axis 0 the shards held here) or replicated
    (the same whole value on every rank): ``per_shard`` names it, a tree
    of the state's structure with a bool a leaf; by default a tensor of
    two or more dimensions is per-shard and any other leaf replicated.
    The manifest records it."""
    leaves = [x for x, _ in _leaves(state)]
    flags = _placement(state, per_shard)
    S, lo, L, world, group = _ring_layout(_n_local(leaves, flags))
    rank0 = lo == 0
    if rank0:  # a stale manifest never outlives the files it names
        os.makedirs(path, exist_ok=True)
        for old in glob.glob(os.path.join(path, MANIFEST)) + glob.glob(
                os.path.join(path, "shard_*.npz")):
            os.unlink(old)
    _barrier(world, group)
    digests = {}
    for i in range(L):
        row = _unflatten(state, [x[i] if f else x
                                 for x, f in zip(leaves, flags)])
        name = _shard_file(lo + i)
        save(os.path.join(path, name), row, key, round_index, message_count)
        digests[name] = _stored_digest(os.path.join(path, name))
    if world > 1:
        import torch.distributed as dist

        parts = [None] * world
        dist.all_gather_object(parts, digests, group=group)
        digests = {k: v for p in parts for k, v in p.items()}
    if rank0:
        blocks = [int(x.shape[1]) for x, f in zip(leaves, flags)
                  if f and x.dim() == 2]
        manifest = {
            "format": SHARDED_FORMAT, "version": 1, "n_shards": S,
            "block": blocks[0] if blocks else None, "world": world,
            "key": [int(k) for k in prng.key_data(key)],
            "round": int(round_index), "messages": int(message_count),
            "treedef": treedef_str(state),
            "leaves": [{"per_shard": f, "shape": _global_shape(x, f, S),
                        "dtype": str(_dtype_shape(x)[0])}
                       for x, f in zip(leaves, flags)],
            "files": dict(sorted(digests.items()))}
        tmp = os.path.join(path, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, os.path.join(path, MANIFEST))
    _barrier(world, group)


def _stored_digest(path: str) -> str:
    """The ``__sha256__`` entry of a :func:`save` file."""
    with np.load(path) as data:
        return bytes(data[_DIGEST_KEY]).decode()


def read_manifest(path: str) -> dict:
    """The manifest of a :func:`save_orbax` directory. A directory without
    one, such as the JAX package's orbax checkpoint, is refused."""
    where = os.path.join(path, MANIFEST)
    if not os.path.isfile(where):
        raise ValueError(
            f"{path!r} is not a sharded checkpoint of the port: it has no "
            f"{MANIFEST}. The port does not read orbax's format (a "
            f"directory the JAX package's save_orbax wrote); save with "
            f"this module's save_orbax, or move single-file states with "
            f"save/load (the npz format both packages read)")
    with open(where) as f:
        manifest = json.load(f)
    if manifest.get("format") != SHARDED_FORMAT or \
            manifest.get("version") != 1:
        raise ValueError(f"{where!r}: unknown manifest format "
                         f"{manifest.get('format')!r} version "
                         f"{manifest.get('version')!r}")
    return manifest


def load_orbax(path: str, template: Any, *, per_shard=None
               ) -> Tuple[Any, np.ndarray, int, int]:
    """Restore a :func:`save_orbax` directory onto ``template``'s ring: a
    state of the same structure laid out as the resumed run holds it
    (``[n_local, ...]`` per-shard leaves on each rank, at any world that
    divides the saved shard count, or ``[S, ...]`` in one process).
    Each leaf lands as the template places it, the reference's restore by
    the template's sharding: ``per_shard`` (as in :func:`save_orbax`)
    names the template's layout, by default the one the manifest
    recorded at save; a leaf placed otherwise than saved is refused.
    Every rank reads only its own shards' files, each verified against
    its own digest and the manifest's. Returns ``(state, key,
    round_index, message_count)``."""
    manifest = read_manifest(path)
    t_leaves = [x for x, _ in _leaves(template)]
    if treedef_str(template) != manifest["treedef"]:
        raise ValueError(f"checkpoint structure mismatch:\n  saved: "
                         f"{manifest['treedef']}\n  template: "
                         f"{treedef_str(template)}")
    flags = ([bool(leaf["per_shard"]) for leaf in manifest["leaves"]]
             if per_shard is None else _placement(template, per_shard))
    S, lo, L, world, _ = _ring_layout(_n_local(t_leaves, flags))
    if S != manifest["n_shards"]:
        raise ValueError(
            f"{path!r} holds a ring of {manifest['n_shards']} shards, the "
            f"template's ring has {S} ({L} a rank at world {world})")
    for i, (x, f, saved) in enumerate(zip(t_leaves, flags,
                                          manifest["leaves"])):
        shape = _global_shape(x, f, S)
        if (saved["per_shard"], saved["shape"]) != (f, shape):
            raise ValueError(
                f"leaf {i}: saved {saved['shape']} "
                f"({'per-shard' if saved['per_shard'] else 'replicated'}), "
                f"the template's ring holds {shape} "
                f"({'per-shard' if f else 'replicated'})")
    row_template = _unflatten(template, [x[0] if f else x
                                         for x, f in zip(t_leaves, flags)])
    rows = []
    for d in range(lo, lo + L):
        name = _shard_file(d)
        where = os.path.join(path, name)
        if _stored_digest(where) != manifest["files"].get(name):
            raise CheckpointCorrupt(where, expected=manifest["files"].get(
                name), actual=_stored_digest(where))
        rows.append([x for x, _ in _leaves(load(where, row_template)[0])])
    leaves = [torch.stack([r[i] for r in rows]) if f else rows[0][i]
              for i, f in enumerate(flags)]
    key = prng.wrap_key_data(np.asarray(manifest["key"], dtype=np.uint32))
    return (_unflatten(template, leaves), key, int(manifest["round"]),
            int(manifest["messages"]))


# ------------------------------------------------------ graph persistence

#: Array-valued Graph fields in a graph file (absent when None); the
#: static ints travel in the JSON meta record.
_GRAPH_ARRAYS = (
    "senders", "receivers", "edge_mask", "node_mask", "in_degree",
    "out_degree", "neighbors", "neighbor_mask", "dyn_senders",
    "dyn_receivers", "dyn_mask", "src_eid", "src_offsets", "edge_weight",
    "neighbor_weight", "layout_perm", "layout_inv",
)


def save_graph(path: str, graph) -> None:
    """Atomically write a built graph (layouts, weights, the dynamic
    region and any liveness re-masking included) as one ``.npz``: arrays
    plus a JSON record of the static fields, no pickle."""
    def host(t):
        return t.cpu().numpy()

    payload: Dict[str, Any] = {name: host(getattr(graph, name))
                               for name in _GRAPH_ARRAYS
                               if getattr(graph, name) is not None}
    meta: Dict[str, Any] = {
        "version": 1,
        "n_nodes": int(graph.n_nodes),
        "n_edges": int(graph.n_edges),
        "neighbors_complete": bool(graph.neighbors_complete),
        "max_degree_cap": (None if graph.max_degree_cap is None
                           else int(graph.max_degree_cap)),
        "edge_pad_multiple": int(graph.edge_pad_multiple),
        "max_in_span": int(graph.max_in_span),
        "max_out_span": int(graph.max_out_span),
    }
    if graph.blocked is not None:
        meta["blocked_block"] = int(graph.blocked.block)
        payload["blocked_src"] = host(graph.blocked.src)
        payload["blocked_local_dst"] = host(graph.blocked.local_dst)
        payload["blocked_mask"] = host(graph.blocked.mask)
    if graph.skew is not None:
        for name in ("src", "mask", "owner", "start"):
            payload[f"skew_{name}"] = host(getattr(graph.skew, name))
        if graph.skew.weight is not None:
            payload["skew_weight"] = host(graph.skew.weight)
    if graph.hybrid is not None:
        meta["hybrid_offsets"] = [int(o) for o in graph.hybrid.offsets]
        meta["hybrid_n"] = int(graph.hybrid.n)
        payload["hybrid_masks"] = host(graph.hybrid.masks)
        rem = graph.hybrid.remainder
        if rem is not None:
            meta["hybrid_rem_block"] = int(rem.block)
            payload["hybrid_rem_src"] = host(rem.src)
            payload["hybrid_rem_local_dst"] = host(rem.local_dst)
            payload["hybrid_rem_mask"] = host(rem.mask)
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                        dtype=np.uint8)
    _write_npz(path, payload)


def load_graph(path: str, device=None):
    """Load a graph file written by :func:`save_graph` (by either
    package) onto ``device`` (as ``_device.resolve``)."""
    from p2pnetwork_tpu_torch.ops.blocked import BlockedEdges
    from p2pnetwork_tpu_torch.ops.diag import HybridEdges
    from p2pnetwork_tpu_torch.ops.skew import SkewTable
    from p2pnetwork_tpu_torch.sim.graph import Graph

    dev = _device.resolve(device)
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if meta.get("version") != 1:
            raise ValueError(
                f"unknown graph file version: {meta.get('version')}")

        def t(name):
            return (torch.from_numpy(np.array(data[name])).to(dev)
                    if name in data.files else None)

        fields = {name: t(name) for name in _GRAPH_ARRAYS}
        blocked = skew = hybrid = None
        if "blocked_src" in data.files:
            blocked = BlockedEdges(src=t("blocked_src"),
                                   local_dst=t("blocked_local_dst"),
                                   mask=t("blocked_mask"),
                                   block=int(meta["blocked_block"]))
        if "skew_src" in data.files:
            skew = SkewTable(src=t("skew_src"), mask=t("skew_mask"),
                             owner=t("skew_owner"), start=t("skew_start"),
                             weight=t("skew_weight"))
        if "hybrid_masks" in data.files:
            rem = None
            if "hybrid_rem_src" in data.files:
                rem = BlockedEdges(src=t("hybrid_rem_src"),
                                   local_dst=t("hybrid_rem_local_dst"),
                                   mask=t("hybrid_rem_mask"),
                                   block=int(meta["hybrid_rem_block"]))
            hybrid = HybridEdges(masks=t("hybrid_masks"), remainder=rem,
                                 offsets=tuple(int(o) for o in
                                               meta["hybrid_offsets"]),
                                 n=int(meta["hybrid_n"]))
    cap = meta.get("max_degree_cap")
    return Graph(
        n_nodes=int(meta["n_nodes"]), n_edges=int(meta["n_edges"]),
        neighbors_complete=bool(meta["neighbors_complete"]),
        max_degree_cap=None if cap is None else int(cap),
        edge_pad_multiple=int(meta.get("edge_pad_multiple", 128)),
        max_in_span=int(meta["max_in_span"]),
        max_out_span=int(meta["max_out_span"]),
        blocked=blocked, hybrid=hybrid, skew=skew, **fields)
