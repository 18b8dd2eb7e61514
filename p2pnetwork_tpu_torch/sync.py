"""Merkle-tree set reconciliation over the sockets backend.

*Make our stores equal without shipping the whole store* — the sync
problem every replicated system built on overlays like the reference
solves by hand (its dict messages give transport, nothing above it
[ref: README.md:20, p2pnetwork/nodeconnection.py:128-143]). The classic
answer (Merkle 1979; Dynamo/Cassandra anti-entropy, git's object
exchange): arrange item hashes in a hash trie, compare roots, and
descend only into subtrees whose hashes differ — identical stores cost
one round trip, a k-item difference costs O(k · log n) messages however
large the stores are.

:class:`SyncNode` keeps a dict store and a 16-way hash trie over it:

- items live at the hex-digit path of ``blake2b(key)``; every trie
  node's hash folds its children's items, so any single difference
  changes the root;
- :meth:`sync_with` sends our root. On mismatch the PEER walks the
  trie down (``_ms_tree`` / ``_ms_children``), pulling the subtrees it
  lacks (``_ms_pull``) and shipping the ones we lack (``_ms_items``) —
  one walker converges BOTH replicas to the union, and a ``_ms_done``
  (sent after the ships, FIFO-ordered behind them) tells the initiator
  its side is complete too;
- conflicting values for one key resolve deterministically: the
  lexicographically greater value wins on both sides (a documented
  arbitrary-but-convergent rule — bring your own versioning for real
  last-writer-wins semantics).

The sync counter (``sync_messages_sent``) makes the efficiency claim
testable: the suite pins that a 1-item diff over a 500-item store moves
a couple dozen messages, not 500 (tests/test_sync.py).

All state mutates on the node's event loop; :meth:`put` posts there and
:meth:`wait_synced` blocks the caller until the session with a peer has
quiesced on OUR side.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional

from p2pnetwork_tpu_torch import concurrency
from p2pnetwork_tpu_torch.node import Node
from p2pnetwork_tpu_torch.nodeconnection import NodeConnection

FANOUT = 16  # one hex digit per trie level
#: Past this depth a prefix's items ship wholesale (hash collisions on a
#: 128-bit digest never get here; it bounds the walk on any key set).
MAX_DEPTH = 8


def _key_digest(key: str) -> str:
    return hashlib.blake2b(key.encode(), digest_size=16).hexdigest()


def _item_hash(key: str, value: str) -> str:
    return hashlib.blake2b(f"{key}\x00{value}".encode(),
                           digest_size=16).hexdigest()


class SyncNode(Node):
    """A :class:`Node` whose dict store reconciles via Merkle descent.

    Values are strings (serialize structured values yourself — the
    deterministic conflict rule compares the serialized form)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.store: Dict[str, str] = {}
        self._digests: Dict[str, str] = {}  # key -> hex digest (cached)
        self.sync_messages_sent = 0
        self._sync_events: Dict[str, Any] = {}  # peer id -> seam event
        self._walk_pending: Dict[str, int] = {}  # peer id -> open requests
        #: peer id -> root hash from an ``_ms_root`` that arrived while
        #: our walk with that peer was still mid-flight; consumed by
        #: :meth:`_quiesce` to start a follow-up walk.
        self._pending_root: Dict[str, str] = {}

    # ------------------------------------------------------------ app API

    def put(self, key: str, value: str) -> None:
        """Insert an item (posted onto the event loop). Overwrites only
        with a GREATER value — the convergence rule, applied locally too
        so replicas can't be driven apart by local writes mid-sync."""
        loop = self._loop
        if loop is None or loop.is_closed():
            raise RuntimeError("node is not running — call start() first")
        loop.call_soon_threadsafe(self._put_local, key, value)

    def get(self, key: str) -> Optional[str]:
        return self.store.get(key)

    def sync_with(self, n: NodeConnection) -> None:
        """Start a reconciliation session with peer ``n`` (thread-safe).
        Both stores converge to the union; block on :meth:`wait_synced`."""
        loop = self._loop
        if loop is None or loop.is_closed():
            raise RuntimeError("node is not running — call start() first")

        # Clear SYNCHRONOUSLY: posted to the loop, a caller's immediate
        # wait_synced could observe the previous session's still-set
        # event and return before this session even started.
        self._sync_events.setdefault(n.id, concurrency.event()).clear()

        def _do():
            self._send(n, {"_ms_root": self._subtree_hash("")})

        loop.call_soon_threadsafe(_do)

    def wait_synced(self, peer_id: str,
                    timeout: Optional[float] = None) -> bool:
        """Block until the session with ``peer_id`` has quiesced on our
        side (initiator: the peer's ``done`` arrived after its ships;
        responder: our walk's pulls all answered). A peer dying
        mid-session also releases the wait — quiesced is not converged
        then; check the peer's liveness if the distinction matters."""
        return self._sync_events.setdefault(
            peer_id, concurrency.event()).wait(timeout)

    def sync_complete(self, peer_id: str) -> None:
        """Our side of a sync session quiesced. Extension hook."""
        self.debug_print(f"sync_complete: {peer_id}")
        self._dispatch("sync_complete", None, {"peer_id": peer_id})

    # ------------------------------------------------------------- store

    def _put_local(self, key: str, value: str) -> None:
        old = self.store.get(key)
        if old is None or value > old:
            self.store[key] = value
            self._digests[key] = _key_digest(key)

    def _subtree_hash(self, prefix: str) -> str:
        h = hashlib.blake2b(digest_size=16)
        for key in sorted(k for k, d in self._digests.items()
                          if d.startswith(prefix)):
            h.update(_item_hash(key, self.store[key]).encode())
        return h.hexdigest()

    def _children_hashes(self, prefix: str) -> Dict[str, str]:
        # One pass over the store, bucketed by the next digest digit
        # (the naive per-child form scanned the whole store 32 times per
        # _ms_tree request). Key-sorted within each bucket — the same
        # order _subtree_hash uses, so the hashes agree.
        level = len(prefix)
        buckets: Dict[str, list] = {}
        for k, d in self._digests.items():
            if d.startswith(prefix):
                buckets.setdefault(d[: level + 1], []).append(k)
        out = {}
        for p, keys in buckets.items():
            h = hashlib.blake2b(digest_size=16)
            for key in sorted(keys):
                h.update(_item_hash(key, self.store[key]).encode())
            out[p] = h.hexdigest()
        return out

    def _items_under(self, prefix: str):
        return [(k, self.store[k]) for k, d in self._digests.items()
                if d.startswith(prefix)]

    # ---------------------------------------------------------- protocol

    def _send(self, n: NodeConnection, payload: dict) -> None:
        self.sync_messages_sent += 1
        self.send_to_node(n, payload)

    def _quiesce(self, n: NodeConnection, notify_peer: bool) -> None:
        # A fresh initiation from this peer landed while our walk was
        # mid-flight (see node_message's _ms_root branch): the active
        # walk may have passed subtrees BEFORE the peer put the items
        # that prompted its initiation, so releasing the peer's wait now
        # could leave the stores unequal. Run one follow-up walk first;
        # its quiesce releases both sides (or consumes yet another
        # queued root — each follow-up consumes exactly one, so this
        # terminates once initiations stop).
        pending = self._pending_root.pop(n.id, None)
        if pending is not None and pending != self._subtree_hash(""):
            self._bump(n, +1)
            self._send(n, {"_ms_tree": ""})
            return
        if notify_peer:
            self._send(n, {"_ms_done": True})
        self._sync_events.setdefault(n.id, concurrency.event()).set()
        self.sync_complete(n.id)

    def _bump(self, n: NodeConnection, delta: int) -> None:
        c = self._walk_pending.get(n.id, 0) + delta
        self._walk_pending[n.id] = c
        if c <= 0:
            self._walk_pending[n.id] = 0
            # Walk finished: our pulls are in; the peer already holds
            # every item we shipped (FIFO puts them before this done).
            self._quiesce(n, notify_peer=True)

    def _descend(self, n: NodeConnection, prefix: str,
                 remote_children: Dict[str, str]) -> None:
        """Compare the peer's child hashes under ``prefix`` to ours;
        pull what differs toward us, ship what they lack."""
        mine = self._children_hashes(prefix)
        for p in sorted(set(mine) | set(remote_children)):
            if mine.get(p) == remote_children.get(p):
                continue
            if p not in remote_children:
                # They have nothing under p: ship our items outright.
                self._send(n, {"_ms_items": self._items_under(p),
                               "_ms_ship": True})
            elif p not in mine:
                # We have nothing under p: ask for their items wholesale.
                self._bump(n, +1)
                self._send(n, {"_ms_pull": p})
            elif len(p) >= MAX_DEPTH:
                # Depth bound with both sides populated: same-key value
                # CONFLICTS land here (one key, one digest path, two
                # values), so the exchange must go BOTH ways — a pull
                # alone would resolve the conflict on this side only.
                self._send(n, {"_ms_items": self._items_under(p),
                               "_ms_ship": True})
                self._bump(n, +1)
                self._send(n, {"_ms_pull": p})
            else:
                # Both populated, hashes differ: walk down.
                self._bump(n, +1)
                self._send(n, {"_ms_tree": p})

    def node_message(self, node: NodeConnection, data) -> None:
        if not isinstance(data, dict):
            return super().node_message(node, data)
        if "_ms_root" in data:
            # Session start (we are the responder / walker). If OUR walk
            # with this peer is already mid-flight (simultaneous mutual
            # initiation or re-initiation), don't reset its accounting —
            # queue the root instead: the active walk may already have
            # passed subtrees the peer mutated after it visited them, so
            # _quiesce runs a follow-up walk before releasing the
            # peer's wait (tests/test_sync.py::test_reinitiation_mid_walk).
            if self._walk_pending.get(node.id, 0) > 0:
                self._pending_root[node.id] = data["_ms_root"]
                return
            self._sync_events.setdefault(node.id,
                                         concurrency.event()).clear()
            self._walk_pending[node.id] = 0
            if data["_ms_root"] == self._subtree_hash(""):
                self._quiesce(node, notify_peer=True)
            else:
                self._bump(node, +1)
                self._send(node, {"_ms_tree": ""})
            return
        if "_ms_tree" in data:
            p = data["_ms_tree"]
            self._send(node, {"_ms_children": p,
                              "hashes": self._children_hashes(p)})
            return
        if "_ms_children" in data:
            self._descend(node, data["_ms_children"], data["hashes"])
            self._bump(node, -1)  # this walk request resolved
            return
        if "_ms_pull" in data:
            self._send(node, {"_ms_items":
                              self._items_under(data["_ms_pull"])})
            return
        if "_ms_items" in data:
            for k, v in data["_ms_items"]:
                self._put_local(k, v)
            if not data.get("_ms_ship"):
                self._bump(node, -1)  # a pull of ours was answered
            return
        if "_ms_done" in data:
            # The walker finished: its ships precede this on the FIFO
            # stream, so our store already holds everything.
            self._quiesce(node, notify_peer=False)
            return
        super().node_message(node, data)

    def node_disconnected(self, node: NodeConnection) -> None:
        # A peer dying mid-session would otherwise leave waiters blocked
        # for their full timeout: release the session. wait_synced then
        # returns — QUIESCED, not necessarily converged; callers who care
        # can check the peer's liveness before trusting the cut.
        if node.id in self._walk_pending:
            self._walk_pending[node.id] = 0
        self._pending_root.pop(node.id, None)
        ev = self._sync_events.get(node.id)
        if ev is not None and not ev.is_set():
            ev.set()
        super().node_disconnected(node)
