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

The reference's ``save_orbax``/``load_orbax`` (sharded, multi-host) need
JAX's orbax: refused here by name.
"""

from __future__ import annotations

import dataclasses
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


def save_orbax(*args, **kwargs):
    """Refused: the reference's orbax checkpoints need JAX, which the
    port does not use. Use :func:`save`."""
    raise NotImplementedError(
        "save_orbax needs JAX's orbax, which the port does not use; "
        "use checkpoint.save (the npz format both packages read)")


def load_orbax(*args, **kwargs):
    """Refused: see :func:`save_orbax`. Use :func:`load`."""
    raise NotImplementedError(
        "load_orbax needs JAX's orbax, which the port does not use; "
        "use checkpoint.load (the npz format both packages read). A "
        "checkpoint saved and restored across ranks waits in ROADMAP.md")


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
