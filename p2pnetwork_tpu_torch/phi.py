"""Phi-accrual failure detection over the sockets backend.

The reference's only liveness signal is TCP noticing a dead socket —
up to its 10-second timeout late, and silent about DEGRADING peers
[ref: p2pnetwork/nodeconnection.py:47, node.py:97]. The modern answer
(Hayashibara et al. 2004; Cassandra's and Akka's detector) replaces the
binary alive/dead verdict with a CONTINUOUS suspicion level: learn each
peer's heartbeat inter-arrival distribution, and report

    phi(peer) = -log10( P(a heartbeat would take this long) )

so phi 1 means "this gap happens 1 in 10 times", phi 8 "1 in 10^8 —
it's gone". The threshold becomes an application policy knob (how many
false positives per true detection you'll pay), and a peer on a slow
link EARNS a wider distribution instead of flapping a fixed timeout.

:class:`PhiAccrualNode`:

- :meth:`tick` broadcasts one heartbeat (app-chosen cadence, like
  CoordinateNode's pings); inbound heartbeats update the per-peer
  inter-arrival window (mean/variance over the last ``window``
  arrivals);
- :meth:`phi` reads the current suspicion for a peer;
  :meth:`suspected` applies a threshold; :meth:`suspicion_levels`
  snapshots every peer;
- the sim backend's :class:`~p2pnetwork_tpu_torch.models.detector.
  FailureDetector` is the batched counterpart (ping/ack with a count
  threshold); this is the wall-clock, per-connection form.

The estimator is the logistic normal-tail approximation (as deployed in
Akka — it never underflows, so phi grows smoothly however long the
silence) with a standard-deviation floor of ``max(min_std, 0.1·mean)``:
a perfectly regular heartbeat stream must not estimate sigma ~ 0 and
alarm on one scheduler jitter. Heartbeats are consumed by the detector
and never reach ``node_message`` subclass traffic.
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Dict, Optional

from p2pnetwork_tpu_torch import concurrency
from p2pnetwork_tpu_torch.node import Node
from p2pnetwork_tpu_torch.nodeconnection import NodeConnection

HB_KEY = "_phi_hb"


class _ArrivalWindow:
    """Inter-arrival statistics over the last ``window`` heartbeats."""

    __slots__ = ("intervals", "last")

    def __init__(self, window: int):
        self.intervals: deque = deque(maxlen=window)
        self.last: Optional[float] = None

    def record(self, now: float) -> None:
        if self.last is not None:
            self.intervals.append(now - self.last)
        self.last = now

    def snapshot(self):
        """``(intervals tuple, last arrival)`` — copied so the estimator
        math runs OUTSIDE the detector lock (graftlint open-call
        discipline: hold the lock to copy, compute after release)."""
        return tuple(self.intervals), self.last


def _mean_std(intervals, min_std: float):
    """Mean/stddev of an interval snapshot, or None with no data."""
    if not intervals:
        return None
    m = sum(intervals) / len(intervals)
    var = sum((x - m) ** 2 for x in intervals) / len(intervals)
    # The floor is RELATIVE to the cadence as well as absolute: a
    # perfectly regular 1 Hz stream must not estimate sigma ~ 0 and
    # saturate suspicion one jitter past the mean.
    return m, max(math.sqrt(var), 0.1 * m, min_std)


def _phi_from(elapsed: float, mean: float, std: float) -> float:
    """-log10 of the upper-tail probability of a gap >= elapsed, via the
    logistic approximation of the normal CDF (Hayashibara's estimator as
    deployed in Akka): p = e / (1 + e) with e = exp(-z (1.5976 +
    0.070566 z^2)). Unlike erfc it never underflows — for large z the
    log-tail continues analytically, so phi keeps growing smoothly with
    the silence instead of clipping at a floor."""
    z = (elapsed - mean) / std
    a = z * (1.5976 + 0.070566 * z * z)
    if a < -30.0:
        return 0.0  # gap far below the mean: p ~ 1
    if a > 30.0:
        return a / math.log(10.0)  # p ~ e^-a, exactly the log tail
    e = math.exp(-a)
    return -math.log10(e / (1.0 + e))


class PhiAccrualNode(Node):
    """A :class:`Node` with adaptive, continuous peer suspicion — and,
    when ``quarantine_threshold`` is set, a quarantine -> probe -> readmit
    lifecycle driven by it:

    - a connected peer whose phi exceeds ``quarantine_threshold`` is
      QUARANTINED: excluded from application broadcasts
      (:meth:`send_to_nodes`) but NOT disconnected — heartbeats from
      :meth:`tick` keep probing it;
    - when its heartbeats resume and phi falls below
      ``readmit_threshold`` (default: half the quarantine threshold —
      hysteresis, so a peer hovering at the threshold does not flap), it
      is READMITTED to broadcasts;
    - a peer quarantined longer than ``evict_after`` seconds (``None`` =
      never) is EVICTED: its connection is closed, handing the address to
      the reconnect registry / application policy.

    Transitions are evaluated on every :meth:`tick` (or explicitly via
    :meth:`check_quarantine`), dispatched as ``node_quarantined`` /
    ``node_readmitted`` events, and counted in the
    ``p2p_quarantine_transitions_total{node, transition}`` family with the
    current count in the ``p2p_quarantined_peers`` gauge."""

    def __init__(self, *args, window: int = 100, min_std: float = 0.01,
                 quarantine_threshold: Optional[float] = None,
                 readmit_threshold: Optional[float] = None,
                 evict_after: Optional[float] = None,
                 **kwargs):
        if readmit_threshold is None:
            readmit_threshold = (quarantine_threshold / 2.0
                                 if quarantine_threshold is not None else None)
        if (quarantine_threshold is not None
                and readmit_threshold >= quarantine_threshold):
            # Inverted hysteresis would flap quarantine/readmit every
            # sweep; validated before the base class binds the socket.
            raise ValueError(
                "readmit_threshold must be below quarantine_threshold")
        super().__init__(*args, **kwargs)
        self.window = window
        self.min_std = min_std
        self.quarantine_threshold = quarantine_threshold
        self.readmit_threshold = readmit_threshold
        self.evict_after = evict_after
        self._arrivals: Dict[str, _ArrivalWindow] = {}
        #: peer id -> monotonic time it entered quarantine.
        self._quarantined: Dict[str, float] = {}
        #: bumped under the lock on every quarantine-set mutation;
        #: _publish_quarantined uses it to publish the gauge OUTSIDE the
        #: lock without letting racing publishers strand a stale value.
        self._quarantine_gen = 0
        # Heartbeats append on the event loop while phi()/suspected()
        # read from monitoring threads; an unguarded deque iteration
        # mid-append raises "deque mutated during iteration".
        self._phi_lock = concurrency.lock()
        self._m_phi = self.telemetry.gauge(
            "p2p_phi_suspicion",
            "Phi-accrual suspicion level per peer (refreshed on "
            "suspicion_levels/phi reads; 0 = healthy or no verdict).",
            ("node", "peer"))
        self._m_heartbeats = self.telemetry.counter(
            "p2p_heartbeats_received_total",
            "Inbound phi-accrual heartbeats consumed by the detector.",
            ("node",)).labels(self.id)
        self._m_quarantined = self.telemetry.gauge(
            "p2p_quarantined_peers",
            "Peers currently quarantined by the phi lifecycle.",
            ("node",)).labels(self.id)
        self._m_transitions = self.telemetry.counter(
            "p2p_quarantine_transitions_total",
            "Phi quarantine lifecycle transitions "
            "(quarantine | readmit | evict).",
            ("node", "transition"))

    # ------------------------------------------------------------ app API

    def tick(self) -> None:
        """Heartbeat every peer and evaluate quarantine transitions
        (thread-safe). Call at the cadence your deployment chooses; the
        detector learns it. Heartbeats go to quarantined peers too —
        they are the PROBE that lets a recovering peer earn readmission."""
        loop = self._loop
        if loop is None or loop.is_closed():
            raise RuntimeError("node is not running — call start() first")
        loop.call_soon_threadsafe(self._tick_on_loop)

    def _tick_on_loop(self) -> None:
        for conn in self.all_nodes:
            self.send_to_node(conn, {HB_KEY: 1})
        if self.quarantine_threshold is not None:
            self.check_quarantine()

    def phi(self, peer_id: str, now: Optional[float] = None) -> float:
        """Current suspicion of ``peer_id``: 0.0 while the stream is
        healthy (or still warming up — no verdict without data),
        climbing without bound as the silence stretches."""
        with self._phi_lock:
            w = self._arrivals.get(peer_id)
            if w is None or w.last is None:
                return 0.0
            intervals, last = w.snapshot()
        # Estimator math runs outside the lock on the copied window, so a
        # hundred-peer suspicion sweep never stalls the heartbeat path.
        stats = _mean_std(intervals, self.min_std)
        if stats is None:
            return 0.0
        now = time.monotonic() if now is None else now
        value = _phi_from(now - last, *stats)
        self._m_phi.labels(self.id, peer_id).set(value)
        return value

    def suspected(self, peer_id: str, threshold: float = 8.0,
                  now: Optional[float] = None) -> bool:
        """Suspicion policy: phi above ``threshold`` (8 ~ a gap this
        long happens less than 1 in 10^8 heartbeats)."""
        return self.phi(peer_id, now) > threshold

    def suspicion_levels(self) -> Dict[str, float]:
        """Snapshot of phi for every peer that has ever heartbeated."""
        now = time.monotonic()
        with self._phi_lock:
            peers = list(self._arrivals)
        return {pid: self.phi(pid, now) for pid in peers}

    # ---------------------------------------------------------- quarantine

    def quarantined(self) -> Dict[str, float]:
        """Currently quarantined peers: ``{peer_id: seconds in quarantine}``."""
        now = time.monotonic()
        with self._phi_lock:
            return {pid: now - since for pid, since in self._quarantined.items()}

    def is_quarantined(self, peer_id: str) -> bool:
        with self._phi_lock:
            return peer_id in self._quarantined

    def check_quarantine(self, now: Optional[float] = None) -> None:
        """Evaluate quarantine / readmit / evict for every connected peer.

        No-op unless ``quarantine_threshold`` is set. Runs on every
        :meth:`tick`; callable directly (e.g. with a synthetic ``now``)
        from tests or monitoring threads."""
        if self.quarantine_threshold is None:
            return
        now = time.monotonic() if now is None else now
        for conn in list(self.all_nodes):
            pid = conn.id
            value = self.phi(pid, now)
            with self._phi_lock:
                since = self._quarantined.get(pid)
            if since is None:
                if value > self.quarantine_threshold:
                    self._transition(pid, "quarantine", now)
                continue
            if value < self.readmit_threshold:
                # Fresh heartbeats pulled phi back down: the probe
                # succeeded, the peer has earned its way back in.
                self._transition(pid, "readmit", now)
            elif (self.evict_after is not None
                  and now - since > self.evict_after):
                if self._transition(pid, "evict", now):
                    conn.stop()

    def _transition(self, peer_id: str, transition: str, now: float) -> bool:
        """Atomically apply one lifecycle transition; returns whether it
        took effect. The state check and the mutation share one lock
        acquisition so concurrent sweeps (loop tick + a monitoring
        thread) cannot double-fire a transition or evict a peer the
        other sweep just readmitted."""
        with self._phi_lock:
            if transition == "quarantine":
                if peer_id in self._quarantined:
                    return False  # another sweep got here first
                self._quarantined[peer_id] = now
            else:
                if self._quarantined.pop(peer_id, None) is None:
                    return False
            self._quarantine_gen += 1
        # Gauge publication happens OUTSIDE the lock (the metric takes its
        # own lock — graftlint's open-call discipline); the generation
        # protocol in _publish_quarantined keeps racing publishers from
        # stranding a stale count.
        self._publish_quarantined()
        self._m_transitions.labels(self.id, transition).inc()
        event = {"quarantine": "node_quarantined",
                 "readmit": "node_readmitted",
                 "evict": "node_evicted"}[transition]
        self.debug_print(f"{event}: {peer_id}")
        self._dispatch(event, None, {"peer": peer_id})
        return True

    def _publish_quarantined(self) -> None:
        """Publish the quarantined-peer count without holding the detector
        lock across the metric call. Snapshot (count, generation) under
        the lock, set the gauge outside it, and re-check the generation:
        whichever publisher observes the final generation also publishes
        the final count, so interleaved publishers cannot strand a stale
        gauge — the property the old set-under-the-lock bought, without
        nesting the metric's lock under ours."""
        while True:
            with self._phi_lock:
                gen = self._quarantine_gen
                count = len(self._quarantined)
            self._m_quarantined.set(count)
            with self._phi_lock:
                if self._quarantine_gen == gen:
                    return

    def send_to_nodes(self, data, exclude=None, compression="none") -> None:
        """Broadcast excluding quarantined peers: a suspected-degrading
        peer stops receiving application traffic (the graceful eviction)
        while heartbeat probes from :meth:`tick` — which bypass this by
        sending per-connection — keep testing it for readmission."""
        exclude = list(exclude or [])
        if self.quarantine_threshold is not None:
            with self._phi_lock:
                bad = set(self._quarantined)
            if bad:
                exclude += [c for c in self.all_nodes
                            if c.id in bad and c not in exclude]
        super().send_to_nodes(data, exclude, compression)

    # ------------------------------------------------------ interception

    def _record_heartbeat(self, peer_id: str,
                          now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._phi_lock:
            self._arrivals.setdefault(
                peer_id, _ArrivalWindow(self.window)).record(now)
        self._m_heartbeats.inc()

    def node_message(self, node: NodeConnection, data) -> None:
        if isinstance(data, dict) and HB_KEY in data:
            self._record_heartbeat(node.id)
            return
        super().node_message(node, data)

    def node_disconnected(self, node: NodeConnection) -> None:
        # TCP already rendered its verdict: drop the window so a
        # reconnecting peer starts a fresh estimate instead of being
        # judged against its pre-crash rhythm. Quarantine state goes with
        # it — a reconnecting peer starts active, not pre-condemned.
        with self._phi_lock:
            self._arrivals.pop(node.id, None)
            self._quarantined.pop(node.id, None)
            self._quarantine_gen += 1
        self._publish_quarantined()
        # Prune (not zero) the gauge: a departed peer must not leave a
        # forever-sample behind — under churn that cardinality only grows.
        self._m_phi.remove(self.id, node.id)
        super().node_disconnected(node)
