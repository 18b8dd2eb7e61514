"""Deterministic, seeded fault injection for the sockets backend.

The sim backend treats failure as a first-class input (`sim/failures.py`:
kill nodes / cut links by flipping device-side masks); this module is the
sockets-side counterpart, mirroring that API name-for-name so a failure
scenario written against one backend reads the same against the other:

==========================  ===========================================
sim (``sim.failures``)      sockets (``ChaosPlane``)
==========================  ===========================================
``kill_nodes(g, ids)``      ``plane.kill_nodes(ids)``
``revive_nodes(g, ids, o)`` ``plane.revive_nodes(ids)``
``cut_links(g, edge_ids)``  ``plane.cut_links(pairs)``
``partition(g, groups)``    ``plane.partition(groups)``
``preempt(run, at_round)``  ``plane.preempt(ids)`` / ``revive_preempted()``
==========================  ===========================================

(The sim's ``preempt`` kills the *run harness* at a round boundary — the
supervised-run lifecycle, ``supervise/runner.py``; the sockets mirror
preempts *peers*: fail-stop now, revive en bloc later — both count under
the shared ``preempt`` fault kind.)

plus sockets-only faults no mask can express: added latency, bandwidth
throttle, frame drop / duplicate / corrupt, and a slow-drain peer (stops
reading so the sender's backpressure bound trips).

Mechanism: :meth:`ChaosPlane.attach` wraps a node's
``create_new_connection`` factory so every accepted or dialed connection
gets its ``(StreamReader, StreamWriter)`` pair wrapped in
:class:`~p2pnetwork_tpu.chaos.streams.ChaosReader` /
:class:`~p2pnetwork_tpu.chaos.streams.ChaosWriter`. No protocol code
changes to be chaos-able, and any ``Node`` subclass (Phi, CRDT, secure…)
is injectable because the seam is the factory the subclass already
honors.

Known seam boundary: the plaintext id handshake runs on the RAW streams
before the factory is called, so a reconnect attempt toward a killed or
partitioned peer still completes TCP + handshake before the wrapped
connection dies on its first read (the factory closes the transport
immediately, so not one application byte crosses). The observable cost is
a transient connected/disconnected event pair per attempt — the
firewall-RST flavor of partition rather than the pulled-cable one — and
give-up policies keyed on ``trials`` can, rarely, see a tick land inside
that sub-millisecond window and reset the count.

Determinism: every per-frame fault decision is drawn from a per-stream
``random.Random`` seeded by ``sha256(seed | src | dst | direction)`` —
the schedule for frame ``i`` of a stream is a pure function of
``(seed, src, dst, i)``, independent of event-loop interleaving across
nodes. Same seed ⇒ byte-identical schedule; different seed ⇒ a different
one. (Give nodes explicit stable ids for cross-run reproducibility —
auto-generated ids are random per process.)

Telemetry: every injected fault increments
``chaos_injected_failures_total{kind}`` in the PR-1 registry — the same
``*_injected_failures_total`` naming the sim uses
(``sim_injected_failures_total{kind}``) — so one snapshot reports
"N faults injected, overlay recovered in T". Deterministic control ops
(``node``/``node_revive``/``link``/``link_heal``) count entities like
the sim's deterministic kinds; ``partition``/``partition_heal`` and the
armed time faults (``latency``/``throttle``/``slow_drain``) count calls;
the per-frame kinds (``drop``/``duplicate``/``corrupt``) count applied
frames. Structural state is mirrored in the
``chaos_active_faults{kind}`` gauge (``dead_nodes``, ``cut_links``,
``partition_groups``, ``slow_drain_nodes``).
"""

from __future__ import annotations

import collections
import hashlib
import random
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from p2pnetwork_tpu_torch import concurrency, telemetry
from p2pnetwork_tpu_torch.chaos.streams import ChaosReader, ChaosWriter

__all__ = ["ChaosPlane"]


class ChaosPlane:
    """One seeded fault-injection controller shared by a whole overlay.

    Attach every node under test, then drive faults from the test/driver
    thread; all methods are thread-safe. Severing ops (kill / cut /
    partition) close matching live connections immediately (via the
    thread-safe ``NodeConnection.stop``) and blackhole + EOF any future
    ones, so recovery machinery (reconnect backoff, phi quarantine) is
    exercised exactly as by a real fault.
    """

    def __init__(self, seed: int = 0,
                 registry: Optional[telemetry.Registry] = None):
        self.seed = int(seed)
        self._lock = concurrency.rlock()
        self._nodes: Dict[str, object] = {}
        self._orig_factory: Dict[str, object] = {}
        self._dead: set = set()
        self._preempted: set = set()    # subset of _dead, revivable en bloc
        self._cut: set = set()          # frozenset({a, b}) pairs
        self._groups: Dict[str, int] = {}
        self._latency = 0.0
        self._jitter = 0.0
        self._rate: Optional[float] = None  # bytes/sec
        self._drop_p = 0.0
        self._dup_p = 0.0
        self._corrupt_p = 0.0
        self._slow: Dict[str, float] = {}
        # Bounded: per-frame faults append one entry each, and a multi-hour
        # soak under armed frame faults must not grow memory without limit.
        # 64k entries comfortably covers determinism audits of test runs.
        self._log: collections.deque = collections.deque(maxlen=65536)
        reg = registry if registry is not None else telemetry.default_registry()
        self._m_injected = reg.counter(
            "chaos_injected_failures_total",
            "Failures injected into the sockets overlay, by kind (entity "
            "counts for node/link ops, applied-frame counts for "
            "drop/duplicate/corrupt, call counts otherwise).",
            ("kind",))
        self._m_active = reg.gauge(
            "chaos_active_faults",
            "Currently armed structural faults (dead nodes, cut links, "
            "partition groups, slow-drain peers).",
            ("kind",))

    # ------------------------------------------------------------- attach

    def attach(self, *nodes):
        """Wrap each node's ``create_new_connection`` so every present and
        future connection runs through the chaos stream proxies. Returns
        the nodes for chaining. Attach BEFORE connecting — existing
        connections are not rewrapped."""
        for node in nodes:
            with self._lock:
                if node.id in self._nodes:
                    continue
                self._nodes[node.id] = node
                orig = node.create_new_connection
                self._orig_factory[node.id] = orig
            def factory(connection, id, host, port, _plane=self, _orig=orig,
                        _nid=node.id, _node=node):
                reader, writer = connection
                if not _plane.link_ok(_nid, str(id)):
                    # The id handshake ran on the raw streams (node code,
                    # before this seam), so a severed peer still completes
                    # it; close the transport NOW so the connection is
                    # born dead — its first read EOFs instantly and the
                    # normal disconnect path reclaims it. The transient
                    # connected/disconnected event pair is the documented
                    # cost of the factory-seam design.
                    try:
                        writer.close()
                    except Exception:
                        pass
                return _orig(
                    (ChaosReader(_plane, _nid, str(id), reader),
                     ChaosWriter(_plane, _nid, str(id), writer,
                                 framing=_node.config.framing)),
                    id, host, port)

            node.create_new_connection = factory
        return nodes[0] if len(nodes) == 1 else nodes

    def detach(self, *nodes) -> None:
        """Restore the original factory; live wrapped connections keep
        their proxies until they close."""
        for node in nodes:
            with self._lock:
                orig = self._orig_factory.pop(node.id, None)
                self._nodes.pop(node.id, None)
            if orig is not None:
                node.create_new_connection = orig

    # -------------------------------------------------- sim-parity faults

    def kill_nodes(self, node_ids: Iterable) -> None:
        """Fail-stop the given node ids: every connection from or to them
        dies, future ones EOF immediately. The processes keep running (a
        kill is a network-visible fault, not SIGKILL) — ``revive_nodes``
        heals."""
        ids = [str(i) for i in node_ids]
        with self._lock:
            self._dead.update(ids)
            for i in ids:
                self._log.append(("node", i, None, None))
        self._count("node", len(ids))
        self._sever(lambda a, b: a in ids or b in ids)
        self._update_gauges()

    def revive_nodes(self, node_ids: Iterable) -> None:
        """Un-kill node ids; reconnect machinery re-establishes links."""
        ids = [str(i) for i in node_ids]
        with self._lock:
            self._dead.difference_update(ids)
            self._preempted.difference_update(ids)
            for i in ids:
                self._log.append(("node_revive", i, None, None))
        self._count("node_revive", len(ids))
        self._update_gauges()

    def preempt(self, node_ids: Iterable) -> None:
        """Preempt node ids: fail-stop now (identical network effect to
        :meth:`kill_nodes`), revive later en bloc via
        :meth:`revive_preempted` — the sockets mirror of the sim side's
        ``failures.preempt`` kill-then-revive lifecycle, and the
        machine-reclaimed flavor of failure (a preempted VM comes back;
        a killed one is a decision). Counted under its own ``preempt``
        kind so a scenario's transient capacity loss reads apart from its
        permanent one."""
        ids = [str(i) for i in node_ids]
        with self._lock:
            self._dead.update(ids)
            self._preempted.update(ids)
            for i in ids:
                self._log.append(("preempt", i, None, None))
        self._count("preempt", len(ids))
        self._sever(lambda a, b: a in ids or b in ids)
        self._update_gauges()

    def revive_preempted(self) -> List[str]:
        """Revive every currently-preempted node (deterministic inverse of
        :meth:`preempt`); returns the revived ids. Reconnect machinery
        re-establishes their links, as after any revive."""
        with self._lock:
            ids = sorted(self._preempted)
            self._preempted.clear()
            self._dead.difference_update(ids)
            for i in ids:
                self._log.append(("preempt_revive", i, None, None))
        self._count("preempt_revive", len(ids))
        self._update_gauges()
        return ids

    def cut_links(self, pairs: Iterable[Tuple]) -> None:
        """Cut the given (a, b) node-id links, both directions."""
        cut = [frozenset((str(a), str(b))) for a, b in pairs]
        with self._lock:
            self._cut.update(cut)
            for pair in cut:
                a, b = sorted(pair)
                self._log.append(("link", a, b, None))
        self._count("link", len(cut))
        self._sever(lambda a, b: frozenset((a, b)) in cut)
        self._update_gauges()

    def heal_links(self, pairs: Iterable[Tuple]) -> None:
        """Restore previously cut links."""
        healed = [frozenset((str(a), str(b))) for a, b in pairs]
        with self._lock:
            self._cut.difference_update(healed)
            for pair in healed:
                a, b = sorted(pair)
                self._log.append(("link_heal", a, b, None))
        self._count("link_heal", len(healed))
        self._update_gauges()

    def partition(self, groups: Sequence[Iterable]) -> None:
        """Split the overlay: nodes in different groups cannot exchange a
        byte; nodes in the same group (or in no group) are unaffected.
        Replaces any previous partition. ``heal_partition`` reunites."""
        mapping = {}
        for gi, group in enumerate(groups):
            for node_id in group:
                mapping[str(node_id)] = gi
        with self._lock:
            self._groups = mapping
            self._log.append(
                ("partition", tuple(sorted(mapping)), len(groups), None))
        self._count("partition", 1)
        self._sever(lambda a, b: not self._same_side(a, b))
        self._update_gauges()

    def heal_partition(self) -> None:
        """Remove the partition; reconnect machinery re-bridges it."""
        with self._lock:
            self._groups = {}
            self._log.append(("partition_heal", None, None, None))
        self._count("partition_heal", 1)
        self._update_gauges()

    # ------------------------------------------------ sockets-only faults

    def add_latency(self, seconds: float, jitter: float = 0.0) -> None:
        """Delay every received chunk by ``seconds`` plus a uniform draw
        from ``[0, jitter)`` (per-stream seeded RNG). 0 disarms — disarm
        calls are logged but not counted as injected failures."""
        armed = seconds > 0 or jitter > 0
        with self._lock:
            self._latency = float(seconds)
            self._jitter = float(jitter)
            self._log.append(("latency", None, None, (seconds, jitter)))
        self._count("latency", 1 if armed else 0)

    def throttle(self, bytes_per_sec: Optional[float]) -> None:
        """Bound receive bandwidth (every chunk sleeps size/rate).
        ``None`` disarms (logged, not counted)."""
        with self._lock:
            self._rate = None if not bytes_per_sec else float(bytes_per_sec)
            self._log.append(("throttle", None, None, bytes_per_sec))
        self._count("throttle", 1 if bytes_per_sec else 0)

    def drop_frames(self, p: float) -> None:
        """Drop each sent frame independently with probability ``p``."""
        with self._lock:
            self._drop_p = float(p)
            self._log.append(("drop_arm", None, None, p))

    def duplicate_frames(self, p: float) -> None:
        """Send each frame twice with probability ``p``."""
        with self._lock:
            self._dup_p = float(p)
            self._log.append(("duplicate_arm", None, None, p))

    def corrupt_frames(self, p: float) -> None:
        """Flip one body byte of each frame with probability ``p``."""
        with self._lock:
            self._corrupt_p = float(p)
            self._log.append(("corrupt_arm", None, None, p))

    def slow_drain(self, node_id, stall: float = 1.0) -> None:
        """Make ``node_id`` drain its sockets one stalled chunk at a time,
        so peers' write buffers grow until their ``max_send_buffer``
        backpressure bound trips. ``stall <= 0`` disarms (logged, not
        counted)."""
        nid = str(node_id)
        with self._lock:
            if stall > 0:
                self._slow[nid] = float(stall)
            else:
                self._slow.pop(nid, None)
            self._log.append(("slow_drain", nid, None, stall))
        self._count("slow_drain", 1 if stall > 0 else 0)
        self._update_gauges()

    def clear_faults(self) -> None:
        """Disarm every non-structural fault (latency, throttle, frame
        faults, slow-drain); kills/cuts/partitions stay."""
        with self._lock:
            self._latency = self._jitter = 0.0
            self._rate = None
            self._drop_p = self._dup_p = self._corrupt_p = 0.0
            self._slow.clear()
            self._log.append(("clear_faults", None, None, None))
        self._update_gauges()

    def reset(self) -> None:
        """Back to a fault-free plane (structural faults included)."""
        with self._lock:
            self._dead.clear()
            self._preempted.clear()
            self._cut.clear()
            self._groups = {}
            self._log.append(("reset", None, None, None))
        self.clear_faults()

    # ------------------------------------------------------------ queries

    def link_ok(self, a: str, b: str) -> bool:
        """May a byte flow between node ids ``a`` and ``b`` right now?"""
        with self._lock:
            if a in self._dead or b in self._dead:
                return False
            if self._cut and frozenset((a, b)) in self._cut:
                return False
            return self._same_side(a, b)

    def _same_side(self, a: str, b: str) -> bool:
        # Takes the plane lock itself: besides link_ok (which already
        # holds it — RLock, re-entry is free), this runs as _sever's
        # predicate on the partition path, where reading _groups unlocked
        # would race a concurrent partition()/heal_partition() swap.
        with self._lock:
            ga = self._groups.get(a)
            gb = self._groups.get(b)
        return ga is None or gb is None or ga == gb

    def frame_fault_probs(self) -> Tuple[float, float, float]:
        with self._lock:
            return self._drop_p, self._dup_p, self._corrupt_p

    def slow_drain_stall(self, node_id: str) -> float:
        with self._lock:
            return self._slow.get(node_id, 0.0)

    def recv_delay(self, nbytes: int, rng: random.Random) -> float:
        """Receive-side sleep for one chunk: latency + jitter + throttle."""
        with self._lock:
            latency, jitter, rate = self._latency, self._jitter, self._rate
        delay = latency
        if jitter > 0:
            delay += jitter * rng.random()
        if rate:
            delay += nbytes / rate
        return delay

    def fault_log(self) -> List[Tuple]:
        """Ordered record of every control op and applied frame fault:
        ``(kind, src, dst, detail)`` tuples. Frame-fault entries carry the
        per-stream frame index as ``detail`` — with stable node ids and
        deterministic per-stream traffic, two runs under the same seed
        produce the identical log. Bounded to the last 65536 entries."""
        with self._lock:
            return list(self._log)

    def fault_schedule(self, src, dst, n_frames: int) -> List[Tuple[float, ...]]:
        """The first ``n_frames`` frame-fault draws for the ``src -> dst``
        stream: ``(r_drop, r_dup, r_corrupt, r_pos)`` per frame. A pure
        function of ``(seed, src, dst)`` — what the determinism tests
        compare byte-for-byte across planes."""
        rng = self._stream_rng(str(src), str(dst), "send")
        return [tuple(rng.random() for _ in range(4)) for _ in range(n_frames)]

    # ----------------------------------------------------------- internal

    def _stream_rng(self, src: str, dst: str, direction: str) -> random.Random:
        """Per-stream RNG: stable under event-loop interleaving because it
        depends only on the seed and the directed endpoint pair (Python's
        builtin hash is process-salted, hence sha256)."""
        digest = hashlib.sha256(
            f"{self.seed}|{src}|{dst}|{direction}".encode()).digest()
        return random.Random(int.from_bytes(digest[:8], "big"))

    def _sever(self, pred) -> None:
        """Close every live attached connection whose (owner, peer) id
        pair matches; NodeConnection.stop is thread-safe and idempotent."""
        with self._lock:
            nodes = list(self._nodes.values())
        for node in nodes:
            for conn in list(node.all_nodes):
                if pred(node.id, conn.id) or pred(conn.id, node.id):
                    conn.stop()

    def _fault_applied(self, kind: str, src: str, dst: str, idx: int) -> None:
        with self._lock:
            self._log.append((kind, src, dst, idx))
        self._m_injected.labels(kind).inc()

    def _count(self, kind: str, n: int) -> None:
        if n:
            self._m_injected.labels(kind).inc(n)

    def _update_gauges(self) -> None:
        with self._lock:
            dead, cut = len(self._dead), len(self._cut)
            preempted = len(self._preempted)
            groups = len(set(self._groups.values()))
            slow = len(self._slow)
        self._m_active.labels("dead_nodes").set(dead)
        self._m_active.labels("preempted_nodes").set(preempted)
        self._m_active.labels("cut_links").set(cut)
        self._m_active.labels("partition_groups").set(groups)
        self._m_active.labels("slow_drain_nodes").set(slow)
