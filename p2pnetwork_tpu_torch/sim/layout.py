"""IO-aware node reordering for build-time graph layouts (the port's own
copy of ``p2pnetwork_tpu/sim/layout.py``, numpy only).

Host-side numpy permutations of the node ids, applied by
``graph.from_edges(..., reorder=...)`` before the build:

- ``"degree"`` — relabel by ascending (total degree, old id), so
  neighbor-table rows of similar width are adjacent;
- ``"rcm"`` — reverse Cuthill–McKee, level-synchronous: BFS per component
  from the minimal-(degree, id) seed, each level ordered by (degree, id),
  the whole order reversed, isolated nodes appended in id order.

The permutation is recorded on the graph (``layout_perm[old] = new``,
``layout_inv[new] = old``); every runtime id then speaks the relabeled
space, and :func:`to_original_order` / :func:`to_layout_order` map
per-node results across. The reference sorts the RCM adjacency with its
C++ radix core; the port uses the builder's stable numpy sort, which
orders the pairs the same.
"""

from __future__ import annotations

import numpy as np

#: Reordering strategies from_edges(reorder=...) accepts.
STRATEGIES = ("degree", "rcm")


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    """``inv[perm[i]] = i`` — the other direction of a node relabeling."""
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=perm.dtype)
    return inv


def _total_degrees(senders, receivers, n_nodes: int) -> np.ndarray:
    return (np.bincount(senders, minlength=n_nodes)
            + np.bincount(receivers, minlength=n_nodes))


def degree_permutation(senders, receivers, n_nodes: int) -> np.ndarray:
    """Degree-bucketing relabel: ``perm[old] = new`` with new ids assigned
    in ascending (total degree, old id) order — deterministic, stable,
    groups rows of similar width."""
    senders = np.asarray(senders, dtype=np.int64).reshape(-1)
    receivers = np.asarray(receivers, dtype=np.int64).reshape(-1)
    deg = _total_degrees(senders, receivers, n_nodes)
    order = np.argsort(deg, kind="stable")  # ties resolve by old id
    return invert_permutation(order).astype(np.int32)


def _adjacency_csr(senders, receivers, n_nodes: int):
    """Undirected adjacency in CSR form (both edge directions pooled) —
    the traversal structure RCM walks, sorted by the graph builder's
    stable sort."""
    from p2pnetwork_tpu_torch.sim.graph import sort_pairs

    src = np.concatenate([senders, receivers]).astype(np.int32)
    dst = np.concatenate([receivers, senders]).astype(np.int32)
    src, dst = sort_pairs(src, dst)
    counts = np.bincount(src, minlength=n_nodes)
    offsets = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets, dst


def _gather_neighbors(offsets, dst, frontier):
    """All CSR neighbors of ``frontier``, concatenated (with duplicates)."""
    counts = offsets[frontier + 1] - offsets[frontier]
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=dst.dtype)
    # flat[i] walks each frontier node's slice: start + within-slice rank.
    base = np.repeat(offsets[frontier], counts)
    within = np.arange(total) - np.repeat(
        np.cumsum(counts) - counts, counts)
    return dst[base + within]


def rcm_permutation(senders, receivers, n_nodes: int) -> np.ndarray:
    """Reverse Cuthill–McKee relabel, level-synchronous form:
    ``perm[old] = new``.

    Per connected component (seeded at the minimal-(degree, id) unvisited
    node): BFS levels, each level ordered by (degree, old id) ascending —
    the vectorizable variant of the classic per-parent neighbor ordering,
    with the same locality property (a level's nodes land contiguously,
    adjacent levels adjacently). The concatenated order is reversed (the
    "R" in RCM: reversal provably never worsens, usually improves, profile
    width), then isolated (degree-0) nodes append in id order.
    Deterministic for a given edge list."""
    senders = np.asarray(senders, dtype=np.int64).reshape(-1)
    receivers = np.asarray(receivers, dtype=np.int64).reshape(-1)
    deg = _total_degrees(senders, receivers, n_nodes)
    offsets, dst = _adjacency_csr(senders, receivers, n_nodes)
    visited = np.zeros(n_nodes, dtype=bool)
    isolated = deg == 0
    visited |= isolated  # handled separately, after the reversal
    pieces = []
    while True:
        seeds = np.flatnonzero(~visited)
        if seeds.size == 0:
            break
        seed = seeds[np.lexsort((seeds, deg[seeds]))[0]]
        visited[seed] = True
        level = np.array([seed], dtype=np.int64)
        pieces.append(level)
        while level.size:
            nxt = np.unique(_gather_neighbors(offsets, dst, level))
            nxt = nxt[~visited[nxt]]
            if nxt.size == 0:
                break
            nxt = nxt[np.lexsort((nxt, deg[nxt]))]
            visited[nxt] = True
            pieces.append(nxt)
            level = nxt
    if pieces:
        order = np.concatenate(pieces)[::-1]
    else:
        order = np.zeros(0, dtype=np.int64)
    order = np.concatenate([order, np.flatnonzero(isolated)])
    return invert_permutation(order.astype(np.int32))


def node_permutation(senders, receivers, n_nodes: int, *,
                     strategy: str) -> np.ndarray:
    """Dispatch a reorder strategy name to its permutation
    (``perm[old] = new`` over ``[0, n_nodes)``)."""
    if strategy == "degree":
        return degree_permutation(senders, receivers, n_nodes)
    if strategy == "rcm":
        return rcm_permutation(senders, receivers, n_nodes)
    raise ValueError(
        f"unknown reorder strategy {strategy!r}; expected one of "
        f"{STRATEGIES}")


def _permute(x, perm):
    """Fancy-index ``x`` by a stored permutation without forcing device
    tensors to the host: a tensor ``x`` gathers with the device-resident
    ``perm`` (no sync); a numpy ``x`` pulls the permutation across once."""
    if isinstance(x, np.ndarray):
        return x[perm.cpu().numpy()]
    return x[perm.long()]


def to_original_order(x, graph):
    """View a per-node array of a reordered graph in the ORIGINAL id
    space: ``out[old_id] = x[perm[old_id]]``. Identity for graphs built
    without ``reorder``. Works on numpy arrays and tensors (plain fancy
    indexing; the permutation indexes the leading axis)."""
    if graph.layout_perm is None:
        return x
    return _permute(x, graph.layout_perm)


def to_layout_order(x, graph):
    """The other direction: take a per-node array in ORIGINAL id order
    into the graph's relabeled layout (``out[new_id] = x[inv[new_id]]``)."""
    if graph.layout_inv is None:
        return x
    return _permute(x, graph.layout_inv)
