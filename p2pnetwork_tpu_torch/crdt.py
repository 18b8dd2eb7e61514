"""State-based CRDTs over the sockets backend — merge, don't coordinate.

The third classic consistency discipline in this package, beside causal
delivery (causal.py: order the updates) and Merkle reconciliation
(sync.py: diff the stores): make the DATA TYPES conflict-free, so
replicas accept writes locally, gossip their state, and a commutative /
associative / idempotent ``merge`` guarantees convergence no matter how
messages interleave, duplicate, or arrive late. The reference gives its
users dict transport and nothing above it [ref: README.md:20,
p2pnetwork/nodeconnection.py:128-143]; these are the structures
(Shapiro et al. 2011) they end up reimplementing:

- :class:`GCounter` — grow-only counter (per-replica tallies, merge =
  elementwise max);
- :class:`PNCounter` — increment/decrement (two GCounters);
- :class:`LWWRegister` — last-writer-wins register (max by
  ``(timestamp, replica_id)`` — ties break deterministically);
- :class:`ORSet` — observed-remove set (adds tagged uniquely; a remove
  tombstones exactly the tags it has SEEN, so a concurrent re-add
  survives — the add-wins semantics naive tombstone sets get wrong).

All four are plain Python values with ``to_dict`` / ``from_dict`` wire
forms and an algebra the tests pin directly (commutativity,
associativity, idempotence — the convergence theorem's premises).

:class:`CRDTNode` hosts named instances: ``counter/register/set_``
accessors create-or-get, every local mutation broadcasts the full state
(state-based gossip — duplication-safe by idempotence), and inbound
states merge on the event loop. ``sync_all()`` rebroadcasts everything,
the anti-entropy catch-up for peers that joined late.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Set, Tuple

from p2pnetwork_tpu_torch import concurrency
from p2pnetwork_tpu_torch.node import Node
from p2pnetwork_tpu_torch.nodeconnection import NodeConnection

CRDT_KEY = "_crdt"


class GCounter:
    """Grow-only counter: one tally per replica, merge by max."""

    kind = "gcounter"

    def __init__(self, counts: Optional[Dict[str, int]] = None):
        self.counts: Dict[str, int] = dict(counts or {})

    def increment(self, replica: str, by: int = 1) -> None:
        if by < 0:
            raise ValueError("GCounter cannot decrement (use PNCounter)")
        self.counts[replica] = self.counts.get(replica, 0) + by

    @property
    def value(self) -> int:
        return sum(self.counts.values())

    def merge(self, other: "GCounter") -> "GCounter":
        out = dict(self.counts)
        for k, v in other.counts.items():
            out[k] = max(out.get(k, 0), v)
        return GCounter(out)

    def to_dict(self) -> dict:
        return {"counts": dict(self.counts)}

    @classmethod
    def from_dict(cls, d: dict) -> "GCounter":
        return cls(d.get("counts", {}))


class PNCounter:
    """Increment/decrement counter: a positive and a negative GCounter."""

    kind = "pncounter"

    def __init__(self, p: Optional[GCounter] = None,
                 n: Optional[GCounter] = None):
        self.p = p or GCounter()
        self.n = n or GCounter()

    def increment(self, replica: str, by: int = 1) -> None:
        self.p.increment(replica, by)

    def decrement(self, replica: str, by: int = 1) -> None:
        self.n.increment(replica, by)

    @property
    def value(self) -> int:
        return self.p.value - self.n.value

    def merge(self, other: "PNCounter") -> "PNCounter":
        return PNCounter(self.p.merge(other.p), self.n.merge(other.n))

    def to_dict(self) -> dict:
        return {"p": self.p.to_dict(), "n": self.n.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "PNCounter":
        return cls(GCounter.from_dict(d.get("p", {})),
                   GCounter.from_dict(d.get("n", {})))


class LWWRegister:
    """Last-writer-wins register; ties break by replica id, so merges
    agree everywhere even at equal timestamps."""

    kind = "lww"

    def __init__(self, value: Any = None, ts: float = 0.0,
                 replica: str = ""):
        self.value = value
        self.ts = ts
        self.replica = replica

    def set(self, replica: str, value: Any,
            ts: Optional[float] = None) -> None:
        ts = time.time() if ts is None else ts
        if (ts, replica) >= (self.ts, self.replica):
            self.value, self.ts, self.replica = value, ts, replica

    def merge(self, other: "LWWRegister") -> "LWWRegister":
        a, b = (self, other) if (self.ts, self.replica) >= \
            (other.ts, other.replica) else (other, self)
        return LWWRegister(a.value, a.ts, a.replica)

    def to_dict(self) -> dict:
        return {"value": self.value, "ts": self.ts,
                "replica": self.replica}

    @classmethod
    def from_dict(cls, d: dict) -> "LWWRegister":
        return cls(d.get("value"), d.get("ts", 0.0), d.get("replica", ""))


class ORSet:
    """Observed-remove set: adds carry unique tags; a remove tombstones
    only tags it has OBSERVED, so concurrent re-adds win."""

    kind = "orset"

    def __init__(self,
                 adds: Optional[Dict[str, Set[Tuple[str, int]]]] = None,
                 tombs: Optional[Set[Tuple[str, int]]] = None):
        self.adds: Dict[str, Set[Tuple[str, int]]] = {
            k: set(v) for k, v in (adds or {}).items()}
        self.tombs: Set[Tuple[str, int]] = set(tombs or ())
        self._next = 0

    def add(self, replica: str, elem: str) -> None:
        self._next += 1
        self.adds.setdefault(elem, set()).add((replica, self._next))

    def remove(self, elem: str) -> None:
        self.tombs |= self.adds.get(elem, set())

    def __contains__(self, elem: str) -> bool:
        return bool(self.adds.get(elem, set()) - self.tombs)

    def elements(self) -> Set[str]:
        return {e for e, tags in self.adds.items() if tags - self.tombs}

    def merge(self, other: "ORSet") -> "ORSet":
        adds: Dict[str, Set[Tuple[str, int]]] = {
            k: set(v) for k, v in self.adds.items()}
        for k, v in other.adds.items():
            adds.setdefault(k, set()).update(v)
        out = ORSet(adds, self.tombs | other.tombs)
        # Tag counters are per-replica-instance; keep the max so a
        # merged-into instance never reissues a live tag of its own.
        out._next = max(self._next, other._next)
        return out

    def to_dict(self) -> dict:
        return {"adds": {k: [list(tag) for tag in sorted(v)]
                         for k, v in self.adds.items()},
                "tombs": [list(t) for t in sorted(self.tombs)],
                "next": self._next}

    @classmethod
    def from_dict(cls, d: dict) -> "ORSet":
        adds = {k: {(str(a), int(b)) for a, b in v}
                for k, v in d.get("adds", {}).items()}
        tombs = {(str(a), int(b)) for a, b in d.get("tombs", [])}
        out = cls(adds, tombs)
        out._next = int(d.get("next", 0))
        return out


_KINDS = {c.kind: c for c in (GCounter, PNCounter, LWWRegister, ORSet)}


class CRDTNode(Node):
    """A :class:`Node` hosting named CRDTs with state-based gossip.

    Local mutations go through the ``update`` helper (runs the mutation
    on the event loop, then broadcasts the full state); inbound states
    merge on arrival. Convergence needs no ordering, no dedup, and no
    acks — the merge algebra is the whole protocol."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._crdts: Dict[str, Any] = {}
        # Accessors create-on-miss from ANY thread while merges replace
        # entries on the loop; unguarded, a reader's lazy insert could
        # clobber a concurrently merged state (a lost-update race a
        # poll loop can actually hit). One lock covers every
        # check-then-insert and merge-then-replace.
        self._crdt_lock = concurrency.lock()

    # ------------------------------------------------------------ access

    def _get(self, name: str, cls):
        with self._crdt_lock:
            cur = self._crdts.get(name)
        if cur is None:
            # Construct the empty CRDT outside the lock (open-call
            # discipline); setdefault re-checks, so two racing getters
            # agree on one instance and the loser's empty candidate —
            # never published, never mutated — is garbage.
            candidate = cls()
            with self._crdt_lock:
                cur = self._crdts.setdefault(name, candidate)
        if not isinstance(cur, cls):
            raise TypeError(
                f"CRDT {name!r} is a {type(cur).__name__}, "
                f"not {cls.__name__}")
        return cur

    def gcounter(self, name: str) -> GCounter:
        return self._get(name, GCounter)

    def counter(self, name: str) -> PNCounter:
        return self._get(name, PNCounter)

    def register(self, name: str) -> LWWRegister:
        return self._get(name, LWWRegister)

    def set_(self, name: str) -> ORSet:
        return self._get(name, ORSet)

    # ---------------------------------------------------------- mutation

    def update(self, name: str, kind: str, fn,
               done: Optional[Any] = None,
               error: Optional[list] = None) -> None:
        """Run ``fn(crdt)`` on the event loop, then broadcast the state.
        ``kind`` is one of gcounter/pncounter/lww/orset. Thread-safe.
        ``done`` is set even when ``fn`` raises (the exception lands in
        ``error`` — without that, a raising mutation would vanish into
        asyncio's handler and a waiting caller would time out blaming
        the wrong thing)."""
        loop = self._loop
        if loop is None or loop.is_closed():
            raise RuntimeError("node is not running — call start() first")
        cls = _KINDS[kind]

        def _do():
            try:
                crdt = self._get(name, cls)
                fn(crdt)
                self._broadcast(name, crdt)
            except Exception as e:  # noqa: BLE001 — reported to caller
                if error is not None:
                    error.append(e)
                else:
                    raise
            finally:
                if done is not None:
                    done.set()

        loop.call_soon_threadsafe(_do)

    def mutate(self, name: str, kind: str, fn,
               timeout: float = 10.0) -> None:
        """:meth:`update`, but blocks until the mutation has applied
        locally (the broadcast is still asynchronous); re-raises
        whatever ``fn`` raised."""
        ev = concurrency.event()
        err: list = []
        self.update(name, kind, fn, done=ev, error=err)
        if not ev.wait(timeout):
            raise TimeoutError(f"mutation of {name!r} never ran")
        if err:
            raise err[0]

    def sync_all(self) -> None:
        """Rebroadcast every hosted CRDT — catch-up for late joiners.
        Thread-safe; duplication is harmless by idempotence."""
        loop = self._loop
        if loop is None or loop.is_closed():
            raise RuntimeError("node is not running — call start() first")

        def _do():
            # Snapshot under the lock: accessors (gcounter/counter/
            # register/set_) create-on-miss from foreign threads, and a
            # concurrent insert during this loop would raise "dictionary
            # changed size during iteration".
            with self._crdt_lock:
                items = list(self._crdts.items())
            for name, crdt in items:
                self._broadcast(name, crdt)

        loop.call_soon_threadsafe(_do)

    def _broadcast(self, name: str, crdt) -> None:
        self.send_to_nodes({CRDT_KEY: name, "kind": crdt.kind,
                            "state": crdt.to_dict()})

    def crdt_merged(self, name: str, crdt) -> None:
        """An inbound state was merged into ``name``. Extension hook."""
        self.debug_print(f"crdt_merged: {name}")
        self._dispatch("crdt_merged", None, {"name": name})

    # ------------------------------------------------------ interception

    def node_message(self, node: NodeConnection, data) -> None:
        if isinstance(data, dict) and CRDT_KEY in data:
            kind = data.get("kind")
            cls = _KINDS.get(kind)
            if cls is None:
                self.debug_print(f"unknown CRDT kind {kind!r} dropped")
                return
            name = data[CRDT_KEY]
            incoming = cls.from_dict(data.get("state", {}))
            # Empty-CRDT construction and I/O (debug_print) both happen
            # outside the lock; only the check + merge-then-replace —
            # the lost-update window the lock exists for — stay inside.
            # The hot path (name already known) takes the lock ONCE; the
            # first message for a name releases it, constructs the empty
            # CRDT, and retries — the open-call shape _get() uses. A
            # racing insert between iterations just orphans `fresh`.
            fresh = None
            conflict = False
            merged = None
            while True:
                with self._crdt_lock:
                    mine = self._crdts.get(name)
                    if mine is None:
                        mine = fresh
                    if mine is not None:
                        if isinstance(mine, cls):
                            # merge() under the lock is the atomicity
                            # this lock exists for (check + merge +
                            # replace as one step); graftrace refuted
                            # the open-call hazard dynamically — merge
                            # is pure CRDT algebra, acquires no locks
                            # and never blocks, verified across the
                            # seeded crdt_merge_storm schedule battery
                            # (tests/test_graftrace.py pins it).
                            merged = self._crdts[name] = mine.merge(incoming)  # graftlint: ignore[lock-open-call] -- graftrace-refuted: merge() is pure (no locks, no blocking); see crdt_merge_storm scenario
                        else:
                            conflict = True
                        break
                fresh = cls()
            if conflict:
                self.debug_print(f"CRDT kind conflict for {name!r} dropped")
                return
            self.crdt_merged(name, merged)
            return
        super().node_message(node, data)
