"""Consistent hashing with virtual nodes — the DHT partitioning rule.

*Which peer owns this key?* — the question under every distributed
store built on overlays like the reference's, where users hand-roll
ownership on top of ``node_message`` routing [ref: README.md:20]. The
classic answer (Karger et al.; the Dynamo/Cassandra partitioner):
hash each node onto a ring at ``vnodes`` points, hash each key once,
and the owner is the first vnode clockwise. Two properties carry the
whole design, and the tests pin both:

- **balance** — with ``v`` vnodes per peer, load concentration drops
  like 1/sqrt(v·n);
- **minimal disruption** — a join/leave moves only the ~1/n slice of
  keys adjacent to the changed peer; every other key keeps its owner
  (the property naive ``hash(key) % n`` lacks entirely).

Pure-function flavor to match the rest of the package: a
:class:`HashRing` is immutable; ``add``/``remove`` return NEW rings, so
"who moved?" is answerable by comparing two rings — which is exactly
what :func:`moved_fraction` does. Hashing is blake2b (stdlib,
deterministic across processes — ids map identically on every peer
with no coordination, the point of the technique).

``owners(keys, k)`` returns k-replica owner lists (distinct peers
walking clockwise), the replication rule DHT stores layer on top.
The ring walk of a bulk lookup is one vectorized numpy
``searchsorted`` over the vnode table; hashing the keys themselves is
per-key blake2b on the host (the honest cost of cross-process-stable
hashes — pre-hash once with :func:`hash_keys` and reuse the positions
when the same key set is resolved repeatedly).
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

import numpy as np

_SPACE = np.uint64(2**64 - 1)


def _h64(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "big")


def _vnode_points(node_id: str, vnodes: int) -> np.ndarray:
    return np.array(
        [_h64(f"{node_id}#{i}".encode()) for i in range(vnodes)],
        dtype=np.uint64)


def hash_keys(keys: Sequence) -> np.ndarray:
    """u64 ring positions for a batch of keys (str or bytes)."""
    out = np.empty(len(keys), dtype=np.uint64)
    for i, k in enumerate(keys):
        out[i] = _h64(k if isinstance(k, bytes) else str(k).encode())
    return out


class HashRing:
    """Immutable consistent-hash ring over string peer ids."""

    def __init__(self, node_ids: Sequence[str] = (), vnodes: int = 64):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = vnodes
        self.node_ids: Tuple[str, ...] = tuple(sorted(set(node_ids)))
        pts, own = [], []
        for idx, nid in enumerate(self.node_ids):
            p = _vnode_points(nid, vnodes)
            pts.append(p)
            own.append(np.full(vnodes, idx, dtype=np.int32))
        if pts:
            points = np.concatenate(pts)
            owners = np.concatenate(own)
            order = np.argsort(points, kind="stable")
            self._points = points[order]
            self._owner_idx = owners[order]
        else:
            self._points = np.empty(0, dtype=np.uint64)
            self._owner_idx = np.empty(0, dtype=np.int32)

    # ------------------------------------------------------------- edits

    def add(self, node_id: str) -> "HashRing":
        return HashRing(self.node_ids + (node_id,), self.vnodes)

    def remove(self, node_id: str) -> "HashRing":
        return HashRing(tuple(i for i in self.node_ids if i != node_id),
                        self.vnodes)

    # ----------------------------------------------------------- lookups

    def owner(self, key) -> str:
        """The peer owning one key."""
        return self.owners_at(hash_keys([key]))[0]

    def owner_indices_at(self, positions: np.ndarray) -> np.ndarray:
        """Index into ``node_ids`` per u64 ring position — the fully
        vectorized bulk path (no Python-object materialization)."""
        if not self.node_ids:
            raise ValueError("empty ring")
        idx = np.searchsorted(self._points, positions, side="left")
        idx = np.where(idx == len(self._points), 0, idx)  # ring wrap
        return self._owner_idx[idx]

    def owners_at(self, positions: np.ndarray) -> List[str]:
        """Owning peer id per u64 ring position."""
        return [self.node_ids[i] for i in self.owner_indices_at(positions)]

    def owners(self, key, k: int = 1) -> List[str]:
        """The first ``k`` DISTINCT peers clockwise from the key — the
        replica set. ``k`` above the peer count returns all peers."""
        if not self.node_ids:
            raise ValueError("empty ring")
        if k <= 0:
            return []
        k = min(k, len(self.node_ids))
        pos = hash_keys([key])[0]
        start = int(np.searchsorted(self._points, pos, side="left"))
        out: List[str] = []
        n = len(self._points)
        for step in range(n):
            nid = self.node_ids[self._owner_idx[(start + step) % n]]
            if nid not in out:
                out.append(nid)
                if len(out) == k:
                    break
        return out

    def load_fractions(self, sample: int = 1 << 16,
                       seed: int = 0) -> dict:
        """Sampled fraction of key space owned per peer."""
        rng = np.random.default_rng(seed)
        pos = rng.integers(0, int(_SPACE), size=sample, dtype=np.uint64)
        idx = self.owner_indices_at(pos)
        counts = np.bincount(idx, minlength=len(self.node_ids))
        return {nid: int(c) / sample
                for nid, c in zip(self.node_ids, counts)}


def moved_fraction(before: HashRing, after: HashRing,
                   sample: int = 1 << 16, seed: int = 0) -> float:
    """Sampled fraction of keys whose owner differs between two rings —
    the disruption metric (consistent hashing's promise: ~1/n per
    single join/leave, against ~1 for modulo hashing)."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, int(_SPACE), size=sample, dtype=np.uint64)
    # Owner INDICES are ring-local (the id lists differ); resolve to id
    # strings through one vectorized fancy-index per ring and compare
    # as arrays — no per-sample Python loop.
    a = np.asarray(before.node_ids, dtype=object)[
        before.owner_indices_at(pos)]
    b = np.asarray(after.node_ids, dtype=object)[
        after.owner_indices_at(pos)]
    return float(np.mean(a != b))
