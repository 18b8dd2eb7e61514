"""SimService: the batched message plane as a long-lived service (the
port's counterpart of ``p2pnetwork_tpu/serve/service.py``, with its
constructor, request API, records and metric names).

``engine.run_batch_until_coverage`` advances B in-flight floods per
round, and ``BatchFlood.admit`` / ``retire`` are its admission seam.
This module is the front-end over it:

- **request plane** — :meth:`SimService.submit` / :meth:`~SimService.poll`
  / :meth:`~SimService.cancel`, the blocking :meth:`~SimService.wait` /
  :meth:`~SimService.stream`, and :meth:`~SimService.handle_http` (the
  ``/submit``, ``/poll/<ticket>``, ``/cancel/<ticket>``, ``/stats``
  routes as a plain method, which ``telemetry/httpd.MetricsServer``
  mounts with ``service=``);
- **admission control** — a driver loop (:meth:`~SimService.tick`, run
  by a background thread or called synchronously) that admits from a
  bounded FIFO under a pacing budget (AIMD off ``slo_rounds``), runs the
  batch loop in ``chunk_rounds``-round chunks, harvests completed lanes,
  and sheds with a structured reject (:class:`QueueFull`,
  :class:`QuotaExceeded`) counted into ``serve_rejected_total{reason}``;
- **live mutations** — :meth:`~SimService.apply_delta` /
  :meth:`~SimService.grow` queue graph changes that land between ticks;
- **crash tolerance** — chunk keys are ``fold_in(key(seed), round +
  1)``; the batch checkpoints into a ``CheckpointStore`` at tick
  boundaries with the ticket table in a rename-published sidecar
  (``service_state.json``), a write-ahead journal (``serve/journal.py``)
  covers the intents between boundaries, ``arm_preemption`` kills the
  service deterministically, and a new service on the same store resumes
  with per-lane results bit-identical to an uninterrupted run. A
  ``Standby`` (``serve/standby.py``) promotes over the trail with a
  fencing epoch (:class:`FencedEpoch`);
- **determinism** — every control decision is a function of (tick,
  round, queue order, seed); records hold ticks and rounds, never wall
  times. Fed the same seeded traffic (``serve/traffic.py``), the port's
  ticket records equal the reference's.

Host reads: the driver keeps the lanes' ``admitted`` flags on the host
(it made every admission and retirement), so an admitting tick makes one
device read (the new lanes' ``done`` and ``seen_count``), a harvesting
tick one more (the ``seen_count`` of every lane, with the ``seen`` words
when ``record_seen_hash``); both count in ``_device.SYNCS`` beside the
engine's. The packed words are ``int32`` here and are hashed as the
reference's ``uint32``.

A store trail does not cross packages: the sidecar's graph fingerprint
folds each package's own ``sim/layoutcache.py`` sources, so the port
raises :class:`GraphMismatch` on the reference's trail. The journal
crosses. ``heal=`` runs each tick's engine chunk under the self-healing
plane's ``Healer`` (``supervise/heal.py``) and ``slo=`` feeds an SLO
engine (``telemetry/slo.py``), as in the reference.
``hbm_budget_bytes=`` prices every submit and grow against the memory
planner (``analysis/ir/capacity.py``, coefficients fitted on the card)
and sheds what plans past the budget with :class:`MemoryBudgetExceeded`,
before any allocation.

Threading: control-plane state (tickets, queue, quotas, counters) is
guarded by one condition; the device-side batch is confined to the
single driver (whoever calls :meth:`~SimService.tick`). All threads go
through the concurrency seam.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
import urllib.parse
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from p2pnetwork_tpu_torch import _device, concurrency, prng, telemetry
from p2pnetwork_tpu_torch.analysis.ir import capacity as _capacity
from p2pnetwork_tpu_torch.models.messagebatch import BatchFlood
from p2pnetwork_tpu_torch.serve.journal import Journal
from p2pnetwork_tpu_torch.serve.journal import clear_segments as _clear_journal
from p2pnetwork_tpu_torch.sim import checkpoint as ckpt
from p2pnetwork_tpu_torch.sim import engine
from p2pnetwork_tpu_torch.sim import graph as graph_mod
from p2pnetwork_tpu_torch.sim import layoutcache
from p2pnetwork_tpu_torch.supervise.runner import Preempted
from p2pnetwork_tpu_torch.supervise.store import (CheckpointStore,
                                                  atomic_write_json)
from p2pnetwork_tpu_torch.supervise.watchdog import Watchdog
from p2pnetwork_tpu_torch.telemetry import spans

__all__ = [
    "SimService", "Rejected", "QueueFull", "QuotaExceeded",
    "MemoryBudgetExceeded", "DurabilityLost", "FencedEpoch",
    "ServiceClosed", "GraphMismatch", "TERMINAL_STATES", "TICK_PHASES",
    "ticket_trace",
]

_SIDECAR = "service_state.json"

#: Ticket states a record never leaves.
TERMINAL_STATES = frozenset({"done", "cancelled", "timeout"})

#: Submit→completion latency buckets (rounds, queue wait included):
#: floods complete in O(diameter) rounds, queue wait adds chunk-sized
#: steps, so geometric 1..4096 covers both.
_LATENCY_ROUND_BUCKETS = telemetry.exponential_buckets(1.0, 2.0, 13)

#: The tick-phase profiler's phases, in execution order: mutate (queued
#: graph deltas and growth applied between chunks), retire, admit,
#: dispatch, harvest, checkpoint.
TICK_PHASES = ("mutate", "retire", "admit", "dispatch", "harvest",
               "checkpoint")

#: Tick-phase histogram buckets: CPU-tick phases run ~10µs..10s.
_PHASE_SECOND_BUCKETS = telemetry.exponential_buckets(1e-5, 2.0, 20)


def ticket_trace(ticket: str) -> str:
    """The ticket's logical trace id (graftsight correlation): derived
    from the ticket id alone — deterministic, stable across replays —
    so ``/trace?trace_id=tkt-<ticket>`` exports one ticket's
    submit→admit→chunk→fault→heal→complete lifecycle."""
    return f"tkt-{ticket}"


def _delta_fields(delta: "graph_mod.GraphDelta") -> dict:
    """A GraphDelta as JSON-able journal fields (directed form — the
    stored arrays already carry both directions of an undirected
    build), inverted by :func:`_delta_from_fields` at replay."""
    return {
        "add_s": np.asarray(delta.add_senders).tolist(),
        "add_r": np.asarray(delta.add_receivers).tolist(),
        "add_w": (None if delta.add_weights is None
                  else np.asarray(delta.add_weights).tolist()),
        "rem_s": np.asarray(delta.remove_senders).tolist(),
        "rem_r": np.asarray(delta.remove_receivers).tolist(),
    }


def _delta_from_fields(rec: dict) -> "graph_mod.GraphDelta":
    return graph_mod.GraphDelta(
        add_senders=rec.get("add_s"), add_receivers=rec.get("add_r"),
        add_weights=rec.get("add_w"),
        remove_senders=rec.get("rem_s"),
        remove_receivers=rec.get("rem_r"))


def _live_count(graph) -> int:
    """The graph's live node count (one counted host read)."""
    _device.SYNCS += 1
    return int(graph.node_mask.sum())


def _leaves(batch) -> List[torch.Tensor]:
    return [getattr(batch, f.name) for f in dataclasses.fields(batch)]


class _PhaseClock:
    """Per-tick wall breakdown of the serve driver into the
    :data:`TICK_PHASES`. Always measures (``time.perf_counter`` deltas
    — a handful of clock reads per tick); additionally emits a
    ``serve_tick`` span with nested per-phase child spans when a tracer
    is installed. Wall times feed metrics/spans ONLY — never ticket
    records — so the serving plane's determinism contract holds with
    the profiler permanently on."""

    __slots__ = ("phases", "_t0", "_name", "_tracer", "_tick_sid", "_sid")

    def __init__(self, tracer):
        self._tracer = tracer
        self._tick_sid = tracer.begin("serve_tick") \
            if tracer is not None else None
        self._sid = None
        self._name: Optional[str] = None
        self.phases: Dict[str, float] = {}
        self._t0 = time.perf_counter()

    def _close_phase(self, now: float) -> None:
        if self._name is not None:
            self.phases[self._name] = (
                self.phases.get(self._name, 0.0) + (now - self._t0))
        if self._sid is not None:
            self._tracer.end(self._sid)
            self._sid = None

    def enter(self, name: str) -> None:
        now = time.perf_counter()
        self._close_phase(now)
        if self._tracer is not None:
            self._sid = self._tracer.begin(f"tick_{name}",
                                           parent=self._tick_sid)
        self._name, self._t0 = name, now

    def done(self, tick: int) -> Dict[str, float]:
        self._close_phase(time.perf_counter())
        self._name = None
        if self._tick_sid is not None:
            self._tracer.end(self._tick_sid)
            self._tracer.point(
                "tick_phases", parent=self._tick_sid, tick=tick,
                **{ph: self.phases.get(ph, 0.0) for ph in TICK_PHASES})
        return self.phases


class Rejected(RuntimeError):
    """Structured load-shed: the service refused an admission and says
    why, with the numbers the client needs to back off. Subclasses pin
    the reason; :meth:`to_dict` is the HTTP 429 payload."""

    reason = "rejected"

    def __init__(self, message: str, **details):
        self.details = dict(details)
        super().__init__(message)

    def to_dict(self) -> dict:
        return {"error": "rejected", "reason": self.reason, **self.details}


class QueueFull(Rejected):
    """The bounded submit FIFO is at ``queue_depth`` — the surfaced form
    of lane backpressure (the queue only builds while admission runs
    behind arrivals); carries the occupancy numbers to back off on."""

    reason = "queue_full"


class QuotaExceeded(Rejected):
    """The tenant's token bucket is empty this tick."""

    reason = "quota"


class MemoryBudgetExceeded(Rejected):
    """The memory plan prices this admission (or growth) past the
    service's ``hbm_budget_bytes``: refused up front with the planned
    numbers, never an out-of-memory error mid-tick. The plan comes from
    the checked-in coefficients (``analysis/ir/capacity.py``), so the
    check is host arithmetic."""

    reason = "memory_budget"


class DurabilityLost(Rejected):
    """The write-ahead journal can no longer append (disk full, I/O
    error): the service flips to a LOUD shedding mode instead of
    silently accepting work it cannot make durable. Every subsequent
    submit/grow/apply_delta sheds with this reason (``503`` over HTTP,
    ``serve_rejected_total{reason="durability"}``) until a new service
    is constructed on a healthy volume — the trail up to the failure is
    intact and resumes normally. Sticky by design: a journal whose tail
    may be torn must not interleave fresh records after the tear."""

    reason = "durability"


class FencedEpoch(RuntimeError):
    """A demoted (zombie) primary tried to publish against a trail a
    newer epoch owns: :meth:`SimService.checkpoint` found a sidecar
    fencing token above its own. The publish was refused BEFORE
    touching the trail — split-brain is impossible by construction
    (promotion bumps the epoch and publishes the token first; any
    late writer then fails this check). Carries ``ours`` (the zombie's
    epoch) and ``current`` (the token in the sidecar)."""

    def __init__(self, message: str, *, ours: int, current: int):
        self.ours = int(ours)
        self.current = int(current)
        super().__init__(message)


class ServiceClosed(RuntimeError):
    """The service was closed (or its driver died); no more admissions."""


class GraphMismatch(ValueError):
    """The checkpoint trail records a different overlay than the graph
    this service was constructed with.

    The sidecar embeds a layout fingerprint (sim/layoutcache.py source
    digest folded with the graph's node/edge counts and edge-content
    hash), so a trail from overlay A can no longer resume "successfully"
    against overlay B just because the array shapes happen to agree.
    Raised WITHOUT touching the trail — the tickets in it are real;
    reconstruct with the right graph, or pass ``resume=False`` to
    deliberately discard them. Growth steps recorded in the sidecar are
    the sanctioned exception: a trail whose graph grew mid-service
    resumes from the pre-growth construction by replaying those steps.
    """

    def __init__(self, message: str, *, expected: Optional[str] = None,
                 got: Optional[str] = None, directory: str = ""):
        self.expected = expected
        self.got = got
        self.directory = directory
        super().__init__(message)


class SimService:
    """Simulation-as-a-service over ``engine.run_batch_until_coverage``.

    Parameters
    ----------
    graph, protocol:
        The graph to serve broadcasts on and the batched protocol
        (default :class:`~p2pnetwork_tpu_torch.models.messagebatch.BatchFlood`).
    capacity:
        Lane capacity of the batch (rounded up to a whole 32-lane word —
        the real capacity is ``service.capacity``).
    queue_depth:
        Strict bound of the submit FIFO: a submit arriving with the
        queue at this depth is shed with :class:`QueueFull`. The queue
        drains only at tick boundaries, so it builds exactly when
        admission (lanes + pacing) runs behind arrivals — and
        ``queue_depth=0`` sheds every submit (a deliberate
        drain/maintenance mode; the smallest useful depth is 1).
    chunk_rounds:
        Engine rounds per driver tick (one engine call); smaller
        chunks mean finer admission/checkpoint granularity.
    max_ticket_rounds:
        A lane still unfinished after this many applied rounds is cut
        off: its ticket ends ``"timeout"`` (disconnected sources would
        otherwise hold a lane forever).
    seed:
        Base PRNG seed; chunk keys are ``fold_in(key(seed), round + 1)``
        (the supervise-plane schedule, so resume re-walks it).
    store / resume / checkpoint_every_ticks / retain:
        Crash tolerance: a :class:`CheckpointStore` (or directory path)
        the driver checkpoints the batch into every
        ``checkpoint_every_ticks`` ticks, with the ticket table in an
        atomic sidecar. ``resume=True`` (default) restores the newest
        consistent (checkpoint, sidecar) pair at construction;
        ``resume=False`` clears any previous trail.
    journal / journal_fsync:
        The graftdur sub-boundary durability plane (serve/journal.py):
        a write-ahead journal of every admission-plane intent in the
        store directory, appended BEFORE the intent is acknowledged, so
        a SIGKILL between checkpoint boundaries loses no acknowledged
        submit — resume restores the pair, then replays the journal
        suffix (:meth:`replay_next` / the drives' positional
        consumption) with the SAME ticket ids and bit-identical
        results. ``journal=None`` (default) enables it whenever a store
        is configured; ``False`` keeps the boundary-granular legacy
        semantics; ``True`` without a store is an error.
        ``journal_fsync`` is the power-loss policy knob
        (:data:`~p2pnetwork_tpu_torch.serve.journal.FSYNC_POLICIES`:
        ``"record"`` / ``"tick"`` default / ``"off"``). An append
        failure flips the service into :class:`DurabilityLost`
        shedding — loud degradation, never silent un-journaled work.
    epoch:
        Fencing token for hot-standby failover. ``None`` (default)
        adopts the trail's epoch on resume (0 fresh); an explicit int
        pins it — :meth:`~p2pnetwork_tpu_torch.serve.standby.Standby.promote`
        passes ``observed + 1`` so the promoted service's first
        checkpoint publishes a token every zombie-primary publish then
        fails against (:class:`FencedEpoch`).
    quotas:
        Per-tenant token buckets: ``{tenant: (refill_per_tick, burst)}``.
        Unlisted tenants are unlimited. Buckets refill at tick
        boundaries (deterministic), not per wall-second.
    max_active_lanes / slo_rounds:
        Admission pacing. ``max_active_lanes`` caps concurrently running
        lanes (default: full capacity). ``slo_rounds`` arms the AIMD
        controller: a chunk whose completion-rounds p99 exceeds it
        halves the per-tick admit budget; a healthy chunk adds
        ``capacity/16`` back (floor 1, ceiling the active-lane cap).
    done_retention:
        Terminal ticket records kept pollable (oldest evicted past the
        bound, so a long-lived service's table — and its sidecar — stay
        bounded).
    record_seen_hash:
        When True, each completed ticket's summary carries a sha256 of
        its lane's packed ``seen`` bits (as the reference's ``uint32``
        words give them) — the bit-identity witness of resumed runs
        (the harvesting tick's one read then carries the ``seen``
        words; off by default).
    heal:
        A :class:`~p2pnetwork_tpu_torch.supervise.heal.RetryPolicy`: the
        tick's engine chunk runs under a ``Healer`` — the input retained
        as the rollback state, end-of-chunk integrity checks (template
        audit and batch-plane monotonicity, one host read of the batch
        per tick) and policy-routed retry on detected faults (injected
        chip preemptions, wedged dispatches, integrity violations). A
        healed retry re-dispatches the same chunk key against the
        retained input, so recovered ticks are bit-identical to
        undisturbed ones and no admitted lane is lost.
    slo:
        A :class:`~p2pnetwork_tpu_torch.telemetry.slo.SLOEngine` (or
        ``None``). The driver feeds it per-ticket completion rounds and
        wall latency, per-submission shed flags, per-dispatch heal flags
        and per-tick durability flags, and evaluates it once per tick; a
        firing objective with ``admission_signal=True`` halves the admit
        budget that tick. Only deterministic streams may carry the
        signal, so seeded replays stay identical.
    hbm_budget_bytes:
        Per-card device-memory budget of the serving program, or
        ``None`` (no gate). Construction refuses a budget of 0 or less,
        a missing capacity model and a graph that plans over it; submits
        and grows that plan over it (pending growth included) shed with
        :class:`MemoryBudgetExceeded`.
    deadline_s / on_stall:
        Optional supervise-plane watchdog over driver ticks (heartbeat
        per tick; see supervise/watchdog.py for the stall modes).
    idle_wait_s:
        Background-driver poll interval while idle.
    """

    def __init__(self, graph, protocol: Optional[BatchFlood] = None, *,
                 capacity: int = 64, queue_depth: int = 256,
                 chunk_rounds: int = 16, max_ticket_rounds: int = 1024,
                 seed: int = 0,
                 store: Union[CheckpointStore, str, None] = None,
                 resume: bool = True, checkpoint_every_ticks: int = 1,
                 retain: int = 3,
                 journal: Optional[bool] = None,
                 journal_fsync: str = "tick",
                 epoch: Optional[int] = None,
                 quotas: Optional[Dict[str, Tuple[float, float]]] = None,
                 max_active_lanes: Optional[int] = None,
                 slo_rounds: Optional[float] = None,
                 done_retention: int = 4096,
                 record_seen_hash: bool = False,
                 heal=None,
                 slo=None,
                 deadline_s: Optional[float] = None,
                 on_stall: Union[str, Callable] = "raise",
                 idle_wait_s: float = 0.05,
                 hbm_budget_bytes: Optional[float] = None,
                 registry: Optional[telemetry.Registry] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if queue_depth < 0:
            raise ValueError("queue_depth must be >= 0")
        if chunk_rounds < 1:
            raise ValueError("chunk_rounds must be >= 1")
        if checkpoint_every_ticks < 1:
            raise ValueError("checkpoint_every_ticks must be >= 1")
        if done_retention < 1:
            raise ValueError("done_retention must be >= 1")
        self.graph = graph
        self._protocol = protocol if protocol is not None else BatchFlood()
        self._batch = self._protocol.empty(graph, capacity)
        #: Real lane capacity (requested, rounded up to a whole word).
        self.capacity = self._batch.capacity
        #: SLO engine (telemetry/slo.py) or None: fed per-ticket
        #: completion rounds/wall, per-submission shed flags, per-dispatch
        #: heal flags and per-tick durability flags, evaluated once per
        #: tick (pure in its feeds, so seeded replays stay identical).
        self._slo = slo
        self._healer = None
        if heal is not None:
            from p2pnetwork_tpu_torch.supervise.heal import (Healer,
                                                             host_template)

            # Template from the empty batch: every chunk's harvested
            # batch must keep these exact shapes and dtypes.
            self._healer = Healer(heal, template=host_template(self._batch),
                                  monotonic=True, registry=registry)
        self.queue_depth = int(queue_depth)
        self.chunk_rounds = int(chunk_rounds)
        self.max_ticket_rounds = int(max_ticket_rounds)
        self.checkpoint_every_ticks = int(checkpoint_every_ticks)
        self.done_retention = int(done_retention)
        self.seed = int(seed)
        self._base_key = prng.key(self.seed)
        self._n_live = _live_count(graph)
        self._quotas = {str(t): (float(r), float(b))
                        for t, (r, b) in (quotas or {}).items()}
        for t, (r, b) in self._quotas.items():
            if r < 0 or b <= 0:
                raise ValueError(f"quota for {t!r} needs rate >= 0, burst > 0")
        # `is not None`, not truthiness: max_active_lanes=0 must be a
        # loud error, not a silent full-capacity default, and
        # slo_rounds=0.0 (the strictest possible SLO) must not silently
        # DISABLE pacing.
        if max_active_lanes is not None:
            max_active_lanes = int(max_active_lanes)
            if max_active_lanes < 1:
                raise ValueError("max_active_lanes must be >= 1 "
                                 "(use close() or quotas to pause intake)")
            self._target_active = min(max_active_lanes, self.capacity)
        else:
            self._target_active = self.capacity
        if slo_rounds is not None:
            slo_rounds = float(slo_rounds)
            if slo_rounds <= 0:
                raise ValueError("slo_rounds must be > 0 (None disables "
                                 "the AIMD controller)")
        self.slo_rounds = slo_rounds
        # The memory-plan admission gate: price the serving program's
        # per-card footprint from the checked-in coefficients and refuse
        # submits/grows that plan past the budget. `is not None`: 0 must
        # be a loud error.
        if hbm_budget_bytes is not None:
            hbm_budget_bytes = float(hbm_budget_bytes)
            if hbm_budget_bytes <= 0:
                raise ValueError("hbm_budget_bytes must be > 0 (None "
                                 "disables the memory-budget gate)")
        self.hbm_budget_bytes = hbm_budget_bytes
        self._cap_model: Optional[dict] = None
        if hbm_budget_bytes is not None:
            # Loaded once: admission stays host arithmetic, not a JSON
            # read per submit.
            self._cap_model = _capacity.load_membudgets().get(
                "capacity_model")
            planned = self._planned_footprint_bytes(graph.n_nodes_padded)
            if planned is None:
                raise ValueError(
                    "hbm_budget_bytes is set but no capacity model is "
                    "available (membudgets.json lacks `capacity_model`) "
                    "— fit one on the card with tools/fit_capacity.py "
                    "or drop the knob")
            if planned > hbm_budget_bytes:
                # Construction over budget is operator error, not load:
                # a shed here would reject every submit forever.
                raise ValueError(
                    f"graph plans {planned} bytes/chip at construction, "
                    f"over hbm_budget_bytes={int(hbm_budget_bytes)} — "
                    "shard the overlay or raise the budget")
        self._record_seen_hash = bool(record_seen_hash)
        self.idle_wait_s = float(idle_wait_s)
        self.deadline_s = deadline_s
        self.on_stall = on_stall
        self._registry = registry
        # ---- control plane (everything below _cond is guarded by it) --
        self._cond = concurrency.condition()
        self._tickets: Dict[str, dict] = {}
        self._queue: List[str] = []          # pending ticket ids, FIFO
        self._lane_ticket: Dict[int, str] = {}   # running lanes only
        self._cancel_lanes: List[int] = []   # cancelled mid-flight lanes
        self._done_order: List[str] = []     # terminal tids, oldest first
        self._buckets: Dict[str, float] = {
            t: b for t, (_, b) in self._quotas.items()}
        self._admit_budget = self._target_active
        self._round = 0        # cumulative engine rounds
        self._tick = 0         # completed driver ticks
        self._next_ticket = 0
        self._messages = 0     # cumulative exact message total
        self._latencies: List[float] = []   # rolling completion rounds
        self._counts = {"submitted": 0, "completed": 0, "cancelled": 0,
                        "rejected": 0, "timeout": 0, "mutations": 0}
        #: Queued live-mutation plane (graftchurn): (kind, payload, seq)
        #: triples — ("delta", GraphDelta, seq) / ("grow", n_new_nodes,
        #: seq), the seq being the journal record that acknowledged the
        #: intent (None unjournaled) — drained atomically by the
        #: driver's mutate tick phase.
        self._mutations: List[Tuple[str, Any, Optional[int]]] = []
        self._submit_walls: Dict[str, float] = {}
        # ---- graftdur durability plane (lock-guarded like the rest) --
        #: Why the journal refuses appends, or None while durable. Sticky:
        #: every admission sheds DurabilityLost until reconstruction.
        self._durability_lost: Optional[str] = None
        #: Journal records past the last published pair, awaiting replay
        #: (seq-ordered; drives consume positionally, tick()'s mutate
        #: phase is the fallback).
        self._replay_queue: List[dict] = []
        #: Last journal seqno appended AND acknowledged by this service.
        self._j_acked = 0
        #: Seqnos of journaled grow/delta intents still queued in
        #: _mutations (unapplied): the published cover must stay BELOW
        #: them or compaction would eat intents nothing has applied yet.
        self._j_pending_mut: List[int] = []
        #: Anything the sidecar records changed since the last published
        #: pair — gates checkpointing so an IDLE background driver
        #: (ticking every idle_wait_s for quota refill) does not
        #: re-serialize the full batch 20x a second forever.
        self._dirty = False
        self._closed = False
        self._driver_error: Optional[str] = None
        self._preempt_at: Optional[int] = None
        #: Failover fencing epoch (graftdur): published in the sidecar,
        #: checked before every publish (_check_fence). Pinned when the
        #: caller passed one; adopted from the trail otherwise.
        if epoch is not None:
            epoch = int(epoch)
            if epoch < 0:
                raise ValueError("epoch must be >= 0")
        self._epoch = 0 if epoch is None else epoch
        self._epoch_pinned = epoch is not None

        # ---- driver-confined (only the tick() caller touches these) ---
        self._retire_ready: List[int] = []   # harvested lanes to recycle
        #: The lanes' ``admitted`` flags on the host: every admission and
        #: retirement goes through the driver, so the mirror is exact and
        #: admission needs no read of the device flags.
        self._admitted = np.zeros(self.capacity, dtype=bool)
        self._thread: Optional[Any] = None
        self._watchdog: Optional[Watchdog] = None
        #: Crash-seam hooks (chaos/crashstorm.py): called as fn(tick) at
        #: the mid-tick point (between dispatch and harvest) and during
        #: the sidecar publish (between store entry and sidecar rename).
        #: Plain attributes — installing one is a test/chaos action.
        self._tick_fault: Optional[Callable[[int], None]] = None
        self._publish_fault: Optional[Callable[[int], None]] = None
        #: Growth steps applied this service lifetime (sidecar-recorded:
        #: the sanctioned resume path replays them onto the pre-growth
        #: construction). Driver-confined, like the graph they describe.
        self._growth_history: List[dict] = []
        #: Whether the served graph's delta-donate targets (degrees,
        #: neighbor-table rows) are buffers this service owns outright.
        #: The constructor graph is caller-owned — and a no-repad
        #: ``grow`` shares every table buffer with its input — so the
        #: first ``apply_delta`` must copy (``donate=False``), which
        #: rebuilds all donate targets fresh and transfers ownership;
        #: every later delta keeps the in-place churn fast path.
        self._graph_donate_safe = False
        # Graph-identity fingerprint caches (computed lazily, only when
        # a store needs them): the edge-content sha survives growth
        # (edges untouched) but not deltas; the full fingerprint caches
        # until any mutation lands.
        self._edges_sha: Optional[str] = None
        self._graph_fp: Optional[str] = None
        self._graph_fp_base: Optional[str] = None

        reg = registry if registry is not None \
            else telemetry.default_registry()
        self._m_submitted = reg.counter(
            "serve_submitted_total",
            "Broadcast submissions accepted by the serving front-end.",
            ("tenant",))
        self._m_rejected = reg.counter(
            "serve_rejected_total",
            "Submissions load-shed by the serving front-end, by reason "
            "(queue_full = lanes busy and the bounded FIFO at depth; "
            "quota = tenant token bucket empty this tick; memory_budget "
            "= the graftmem capacity plan prices the footprint past "
            "hbm_budget_bytes).", ("reason",))
        self._m_completed = reg.counter(
            "serve_completed_total",
            "Tickets whose broadcast reached its coverage target.")
        self._m_cancelled = reg.counter(
            "serve_cancelled_total", "Tickets cancelled by the client.")
        self._m_timeout = reg.counter(
            "serve_timeouts_total",
            "Tickets cut off at max_ticket_rounds before reaching target.")
        self._m_ticks = reg.counter(
            "serve_ticks_total", "Driver admission-loop iterations.")
        self._m_queue = reg.gauge(
            "serve_queue_depth",
            "Submissions waiting for a lane in the bounded FIFO.")
        self._m_active = reg.gauge(
            "serve_active_lanes",
            "Lanes currently running a ticket's broadcast (the host-side "
            "twin of sim_batch_active_lanes, sampled at tick boundaries).")
        self._m_budget = reg.gauge(
            "serve_admit_budget",
            "Current per-tick admission budget (AIMD-paced when "
            "slo_rounds is set).")
        self._m_latency_rounds = reg.histogram(
            "serve_completion_rounds",
            "Submit-to-completion latency in engine rounds (queue wait "
            "included), one observation per completed ticket.",
            buckets=_LATENCY_ROUND_BUCKETS)
        self._m_latency_s = reg.histogram(
            "serve_latency_seconds",
            "Submit-to-completion wall latency per completed ticket.")
        self._m_phase = reg.histogram(
            "serve_tick_phase_seconds",
            "Per-tick wall time of each driver phase (graftsight "
            "tick-phase profiler): retire/admit/dispatch/harvest/"
            "checkpoint.", ("phase",), buckets=_PHASE_SECOND_BUCKETS)
        self._m_phase_wall = reg.gauge(
            "serve_tick_phase_wall_s",
            "Last tick's wall time per driver phase — a gauge so the "
            "history ring samples it next to the engine's per-run "
            "occupancy/ici columns.", ("phase",))
        self._m_healed_ticks = reg.counter(
            "serve_healed_ticks_total",
            "Driver ticks whose engine chunk needed the Healer "
            "(faulted, then recovered within the retry budget).")
        self._m_mutations = reg.counter(
            "serve_mutations_total",
            "Live graph mutations applied by the driver's mutate tick "
            "phase, by kind (delta = GraphDelta edge churn; grow = node "
            "growth, with or without a capacity repad).", ("kind",))
        self._m_capacity = reg.gauge(
            "graph_capacity",
            "Padded node capacity of the served graph (grows in "
            "geometric repad steps under Graph.grow; the static shape "
            "every compiled consumer is keyed on).")
        self._m_capacity.set(float(graph.n_nodes_padded))
        self._m_journal_lag = reg.gauge(
            "serve_journal_lag",
            "Journal records past the last published checkpoint pair "
            "(last appended seqno minus the pair's covered seqno) — the "
            "replay debt a crash right now would pay, sampled at each "
            "publish.")
        # Tick-phase profile state: written by the driver, snapshotted
        # by /dashboard scrape threads — its own small lock, never
        # nested with _cond.
        self._phase_lock = concurrency.lock()
        self._phase_ring: List[dict] = []  # bounded below
        self._phase_totals: Dict[str, float] = {}
        self._phase_max: Dict[str, float] = {}
        self._phase_ticks = 0

        self._store: Optional[CheckpointStore] = None
        self._journal: Optional[Journal] = None
        if journal_fsync not in ("record", "tick", "off"):
            raise ValueError(
                f"journal_fsync must be 'record', 'tick' or 'off', "
                f"got {journal_fsync!r}")
        if journal and store is None:
            raise ValueError(
                "journal=True needs a checkpoint store (the journal "
                "lives in the store directory; pass store=...)")
        if store is not None:
            self._store = store if isinstance(store, CheckpointStore) \
                else CheckpointStore(store, retain=retain, registry=registry)
            if self._store.retain < 2:
                # retain=1 has a trail-losing window: save() of pair N+1
                # prunes entry N BEFORE the new sidecar publishes, so a
                # kill between the two leaves the surviving sidecar
                # pointing at a deleted entry — resume would discard
                # everything. Two entries guarantee the referenced one
                # survives its successor's prune.
                raise ValueError(
                    "graftserve needs a checkpoint store with retain >= 2 "
                    "(retain=1 can prune the entry the current sidecar "
                    "references before the next sidecar lands)")
            # The as-constructed fingerprint, BEFORE any resume-replayed
            # growth: what a later resume of this trail must present.
            self._graph_fp_base = self._graph_fingerprint()
            if not resume:
                # Clear BEFORE the journal constructs: the fresh journal
                # then scans a clean directory instead of recovering a
                # trail the caller just discarded.
                self._clear_trail()
            if journal is None or journal:
                self._journal = Journal(self._store.directory,
                                        fsync=journal_fsync,
                                        registry=registry)
            if resume:
                self._try_resume()
                if self._journal is not None:
                    # The replay suffix: every record the restored pair
                    # does not cover. With no pair at all (a kill before
                    # the first checkpoint) _j_acked is 0 and EVERY
                    # recovered record replays onto the fresh state.
                    covered = self._j_acked
                    self._replay_queue = [
                        r for r in self._journal.records()
                        if int(r["seq"]) > covered]
            if self._journal is not None:
                self._journal.epoch = self._epoch

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "SimService":
        """Spawn the background driver thread (production mode). The
        deterministic alternative is calling :meth:`tick` yourself —
        serve/traffic.py's :func:`~p2pnetwork_tpu_torch.serve.traffic.drive`
        does, which is what makes seeded runs replayable."""
        with self._cond:
            if self._closed:
                raise ServiceClosed("service is closed")
            if self._thread is not None:
                return self
            self._thread = concurrency.thread(
                target=self._driver_loop, name="SimService-driver",
                daemon=True)
            self._thread.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        """Stop the driver and refuse further submissions (idempotent).
        Queued tickets stay ``queued``; a later service constructed on
        the same store resumes them — which is why a clean close takes
        one FINAL checkpoint after the driver has stopped: submissions
        accepted since the last tick's boundary would otherwise be
        absent from the trail (and their persisted ticket counter
        rolled back, re-issuing their ids to different requests). The
        final checkpoint is skipped when the driver died or cannot be
        joined (the batch may be mid-mutation) and after a
        :class:`Preempted` kill (resume semantics want the PRE-kill
        durable pair)."""
        with self._cond:
            first_close = not self._closed
            self._closed = True
            thread = self._thread
            self._thread = None
            self._cond.notify_all()
        joined = True
        if thread is not None:
            thread.join(timeout=timeout)
            joined = not thread.is_alive()
        if self._watchdog is not None:
            self._watchdog.close()
            self._watchdog = None
        # Re-read the driver's fate AFTER the join: a tick in flight
        # when close() started may still die (or fire an armed
        # preemption) before it observes _closed — a pre-join snapshot
        # would miss that and publish the forbidden post-kill pair.
        with self._cond:
            err = self._driver_error
            dirty = self._dirty
        if joined and self._batch.seen.device.type == "cuda":
            # The driver thread queued its last tick's work on the card:
            # let it finish before the final checkpoint reads the batch
            # and before close() returns.
            torch.cuda.synchronize(self._batch.seen.device)
        if not joined:
            warnings.warn(
                "graftserve: close() timed out joining the driver thread "
                "— it may still be mid-tick and could publish one more "
                "checkpoint pair; do not resume a new service on the "
                "same store until it exits", RuntimeWarning, stacklevel=2)
        if (first_close and joined and err is None and dirty
                and self._store is not None):
            try:
                self._checkpoint()
            except Exception as e:  # a failing final save must not mask
                # the close; the trail just ends at the last boundary.
                warnings.warn(
                    f"graftserve: final close checkpoint failed "
                    f"({type(e).__name__}: {e}); the trail ends at the "
                    "last tick boundary", RuntimeWarning, stacklevel=2)
        if first_close and self._journal is not None:
            # After the final pair (so its rotate/compact ran). Any
            # intent the final pair does NOT cover — journaled-but-
            # unapplied mutations, a skipped final checkpoint — stays
            # in surviving segments for the next resume's replay.
            self._journal.close()

    def __enter__(self) -> "SimService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def arm_preemption(self, at_tick: int) -> None:
        """Arm a one-shot deterministic kill: :class:`Preempted` raises
        out of the tick whose completed-tick count reaches ``at_tick``,
        BEFORE the checkpoint due at that boundary — exactly the damage
        a real SIGKILL there inflicts (supervise-plane semantics). A new
        service on the same store resumes from the last durable pair."""
        with self._cond:
            self._preempt_at = int(at_tick)

    # ------------------------------------------------------ live mutations

    def apply_delta(self, delta: "graph_mod.GraphDelta") -> None:
        """Queue an edge-churn :class:`~p2pnetwork_tpu_torch.sim.graph.GraphDelta`
        for the next tick's mutate phase.

        Mutations apply atomically BETWEEN serve ticks (never inside a
        dispatched chunk): the driver drains the queue first thing each
        tick, in submission order, before retire/admit/dispatch — so a
        chunk either entirely precedes or entirely follows a mutation,
        admitted lanes are never dropped, and tickets completed before
        the mutation tick keep byte-identical results (latched lanes are
        never recomputed). Endpoints are validated HERE, against the
        node count the delta will see after any growth already queued
        ahead of it — a bad id raises a typed
        :class:`~p2pnetwork_tpu_torch.sim.graph.EdgeEndpointError` at the
        caller, not an opaque failure inside the driver."""
        reject: Optional[Rejected] = None
        with self._cond:
            if self._closed:
                raise ServiceClosed(self._driver_error or "service is closed")
            if self._durability_lost is not None:
                reject = DurabilityLost(
                    f"durability lost ({self._durability_lost}) — the "
                    "journal cannot acknowledge this delta",
                    detail=self._durability_lost)
            else:
                n_eff = self.graph.n_nodes + sum(
                    p for k, p, _s in self._mutations if k == "grow")
                graph_mod._check_endpoints(
                    delta.add_senders, delta.add_receivers, n_eff)
                graph_mod._check_endpoints(
                    delta.remove_senders, delta.remove_receivers, n_eff)
                try:
                    seq = self._journal_append_locked(
                        "delta", **_delta_fields(delta))
                except OSError:
                    reject = DurabilityLost(
                        f"journal append failed "
                        f"({self._durability_lost}) — delta refused",
                        detail=self._durability_lost)
                else:
                    self._mutations.append(("delta", delta, seq))
                    if seq is not None:
                        self._j_pending_mut.append(seq)
                    self._cond.notify_all()
        if reject is not None:
            with self._cond:
                self._counts["rejected"] += 1
                self._dirty = True  # shed counts survive resume too
            self._m_rejected.labels(reject.reason).inc()
            if self._slo is not None:
                self._slo.record("shed", 1.0)
            raise reject

    def _planned_footprint_bytes(self, n_padded: int) -> Optional[int]:
        """Per-card planned bytes of the serving program at a node
        capacity (the planner's closed form, host arithmetic). None when
        no capacity model is available, which construction refuses
        whenever the gate is on."""
        lane_words = -(-self.capacity // 32)
        return _capacity.serving_footprint_bytes(
            int(n_padded), int(self.graph.n_edges_padded), lane_words,
            model=self._cap_model)

    def _planned_capacity_nodes(self, extra_nodes: int = 0) -> int:
        """Padded node capacity once every queued grow (plus
        ``extra_nodes``) lands: the geometric repad schedule
        (``graph.growth_capacity``) applied to the pending demand. Caller
        holds ``self._cond`` (reads ``_mutations``)."""
        demand = self.graph.n_nodes + int(extra_nodes) + sum(
            p for k, p, _s in self._mutations if k == "grow")
        current = self.graph.n_nodes_padded
        if demand <= current:
            return current
        return graph_mod.growth_capacity(demand, current)

    def grow(self, n_new_nodes: int) -> None:
        """Queue live overlay growth: ``n_new_nodes`` fresh live nodes
        (ids continuing from the current count) join at the next tick's
        mutate phase via :func:`~p2pnetwork_tpu_torch.sim.graph.grow`.

        When the grown count exceeds the padded capacity the graph
        repads geometrically and the in-flight batch zero-extends with
        it (``MessageBatch.repad``) — zero admitted lanes dropped, the
        latched-completion contract preserved; the next dispatch runs
        at the new shape. Wire
        the new nodes' edges with :meth:`apply_delta` afterwards."""
        n_new_nodes = int(n_new_nodes)
        if n_new_nodes < 0:
            raise ValueError("n_new_nodes must be >= 0")
        reject: Optional[Rejected] = None
        with self._cond:
            if self._closed:
                raise ServiceClosed(self._driver_error or "service is closed")
            if self._durability_lost is not None:
                reject = DurabilityLost(
                    f"durability lost ({self._durability_lost}) — the "
                    "journal cannot acknowledge this growth",
                    detail=self._durability_lost)
            elif self.hbm_budget_bytes is not None:
                planned_cap = self._planned_capacity_nodes(n_new_nodes)
                planned = self._planned_footprint_bytes(planned_cap)
                if planned is not None and planned > self.hbm_budget_bytes:
                    # Refused before the mutation queues: a growth planned
                    # over budget never reaches the mutate phase, where
                    # the repad would run out of memory mid-tick.
                    reject = MemoryBudgetExceeded(
                        f"growth to {planned_cap} padded nodes plans "
                        f"{planned} bytes/chip, over hbm_budget_bytes="
                        f"{int(self.hbm_budget_bytes)} — shard or raise "
                        "the budget",
                        planned_bytes=int(planned),
                        hbm_budget_bytes=int(self.hbm_budget_bytes),
                        planned_capacity=int(planned_cap))
            if reject is None:
                try:
                    seq = self._journal_append_locked("grow",
                                                      n=n_new_nodes)
                except OSError:
                    reject = DurabilityLost(
                        f"journal append failed "
                        f"({self._durability_lost}) — growth refused",
                        detail=self._durability_lost)
            if reject is None:
                self._mutations.append(("grow", n_new_nodes, seq))
                if seq is not None:
                    self._j_pending_mut.append(seq)
                self._cond.notify_all()
        if reject is not None:
            with self._cond:
                self._counts["rejected"] += 1
                self._dirty = True  # shed counts survive resume too
            self._m_rejected.labels(reject.reason).inc()
            if self._slo is not None:
                self._slo.record("shed", 1.0)
            raise reject

    # ---------------------------------------------------------- request API

    def submit(self, source: int, *, target_coverage: float = 0.99,
               tenant: str = "default") -> str:
        """Accept one broadcast request; returns its ticket id.

        Sheds instead of erroring when the service is saturated: every
        lane busy and the FIFO at ``queue_depth`` raises
        :class:`QueueFull`; an empty tenant token bucket raises
        :class:`QuotaExceeded`; a planned footprint past
        ``hbm_budget_bytes`` (pending growth included) raises
        :class:`MemoryBudgetExceeded` — all carry the backpressure
        numbers and count into ``serve_rejected_total{reason}``. A bad
        ``source`` is a caller error (plain ``ValueError``), not a
        shed."""
        source = int(source)
        if not 0 <= source < self.graph.n_nodes_padded:
            raise ValueError(
                f"source {source} outside node range "
                f"[0, {self.graph.n_nodes_padded})")
        target = float(target_coverage)
        if not 0.0 < target <= 1.0:
            raise ValueError(f"target_coverage must be in (0, 1], "
                             f"got {target}")
        tenant = str(tenant)
        reject: Optional[Rejected] = None
        # Wall timestamp taken before the lock, recorded inside it (in
        # the same critical section that publishes the ticket): a
        # second acquisition after publication would race a fast
        # driver completing the ticket first, losing the
        # serve_latency_seconds observation and leaking the entry.
        # It feeds ONLY that histogram — records stay wall-free.
        now = time.perf_counter()
        with self._cond:
            if self._closed:
                raise ServiceClosed(
                    self._driver_error or "service is closed")
            planned = None
            if self.hbm_budget_bytes is not None:
                planned = self._planned_footprint_bytes(
                    self._planned_capacity_nodes())
            if self._durability_lost is not None:
                # Loud degradation (graftdur): an un-journalable submit
                # must never be acknowledged — it would vanish on the
                # next crash while the caller holds a ticket id.
                reject = DurabilityLost(
                    f"durability lost ({self._durability_lost}) — "
                    "shedding until the service is reconstructed on a "
                    "healthy volume", detail=self._durability_lost)
            elif planned is not None and planned > self.hbm_budget_bytes:
                # Over plan (queued growth repads past the budget): stop
                # taking load before the repad lands.
                reject = MemoryBudgetExceeded(
                    f"planned footprint {planned} bytes/chip over "
                    f"hbm_budget_bytes={int(self.hbm_budget_bytes)} "
                    "(pending growth repads past the plan) — back off",
                    planned_bytes=int(planned),
                    hbm_budget_bytes=int(self.hbm_budget_bytes),
                    planned_capacity=int(self._planned_capacity_nodes()))
            elif tenant in self._quotas and self._buckets.get(tenant, 0.0) < 1.0:
                reject = QuotaExceeded(
                    f"tenant {tenant!r} out of quota this tick "
                    f"(refills at the next driver tick)",
                    tenant=tenant,
                    tokens=self._buckets.get(tenant, 0.0),
                    refill_per_tick=self._quotas[tenant][0])
            elif len(self._queue) >= self.queue_depth:
                # The FIFO is strictly bounded: it only builds when
                # admission (lanes + pacing) runs behind arrivals, so a
                # full queue IS the lane-exhaustion backpressure signal,
                # surfaced with the occupancy numbers a client backs
                # off on.
                reject = QueueFull(
                    f"queue at depth {len(self._queue)}/"
                    f"{self.queue_depth} with "
                    f"{len(self._lane_ticket)}/{self.capacity} lanes "
                    "busy — back off and retry",
                    queue_depth=len(self._queue),
                    queue_limit=self.queue_depth,
                    active_lanes=len(self._lane_ticket),
                    capacity=self.capacity)
            else:
                # Append-before-ack (graftdur): the ticket id is
                # journaled BEFORE the counter advances or the record
                # exists, so acknowledged ⟺ journaled. A failing append
                # leaves NO partial ticket and sheds DurabilityLost; a
                # kill mid-append aborts the submit entirely (the caller
                # never saw an id — nothing was lost).
                tid = f"t{self._next_ticket:08d}"
                try:
                    self._journal_append_locked(
                        "submit", ticket=tid, source=source,
                        target=target, tenant=tenant,
                        round=self._round)
                except OSError:
                    reject = DurabilityLost(
                        f"journal append failed "
                        f"({self._durability_lost}) — submit refused",
                        detail=self._durability_lost)
            if reject is None:
                if tenant in self._quotas:
                    self._buckets[tenant] -= 1.0
                self._next_ticket += 1
                self._tickets[tid] = {
                    "ticket": tid, "tenant": tenant, "source": source,
                    "target": target, "status": "queued",
                    "submitted_tick": self._tick,
                    "submitted_round": self._round,
                    "admitted_tick": None, "admitted_round": None,
                    "lane": None, "rounds": None, "seen_count": None,
                    "coverage": None, "latency_rounds": None,
                }
                self._queue.append(tid)
                self._submit_walls[tid] = now
                self._dirty = True
                self._counts["submitted"] += 1
                depth = len(self._queue)
                self._cond.notify_all()
        if reject is not None:
            with self._cond:
                self._counts["rejected"] += 1
                self._dirty = True  # shed counts survive resume too
                if (self._durability_lost is None
                        and reject.reason != "durability"):
                    # Sheds are admission-plane intents too: journaling
                    # them keeps replay positional (the drive maps each
                    # arrival to exactly one record). Best-effort — a
                    # failure here flips DurabilityLost for the NEXT
                    # admission; this one already sheds.
                    try:
                        self._journal_append_locked(
                            "shed", reason=reject.reason, source=source,
                            tenant=tenant)
                    except OSError:
                        pass
            self._m_rejected.labels(reject.reason).inc()
            if self._slo is not None:
                self._slo.record("shed", 1.0)
            raise reject
        # Bound metric cardinality: only configured tenants (and the
        # default) get their own label child — arbitrary client-supplied
        # tenant strings from the HTTP surface collapse to "other"
        # (ticket records keep the raw tenant either way).
        label = tenant if (tenant == "default" or tenant in self._quotas) \
            else "other"
        self._m_submitted.labels(label).inc()
        self._m_queue.set(float(depth))
        if self._slo is not None:
            self._slo.record("shed", 0.0)
        if spans.current_tracer() is not None:
            spans.emit("ticket_submit", trace=ticket_trace(tid),
                       ticket=tid, source=source, tenant=tenant)
        return tid

    def poll(self, ticket: str) -> Optional[dict]:
        """The ticket's current record (a copy), or ``None`` for an
        unknown/evicted id. Records are fully deterministic — ticks,
        rounds, counts; never wall timestamps."""
        with self._cond:
            rec = self._tickets.get(str(ticket))
            return dict(rec) if rec is not None else None

    def cancel(self, ticket: str) -> bool:
        """Cancel a queued or running ticket; True when this call
        transitioned it. A running lane is recycled at the next tick
        boundary (its partial broadcast is abandoned)."""
        cancelled = False
        with self._cond:
            if self._closed:
                # Symmetric with submit(): after close nothing can reach
                # the durable trail, so a cancellation must not be
                # "accepted" and then silently lost on resume.
                return False
            rec = self._tickets.get(str(ticket))
            if (rec is not None
                    and rec["status"] in ("queued", "running")):
                if self._durability_lost is not None:
                    raise DurabilityLost(
                        f"durability lost ({self._durability_lost}) — "
                        "the journal cannot acknowledge this "
                        "cancellation", detail=self._durability_lost)
                try:
                    # Append-before-ack, like submit: a cancellation the
                    # journal never saw would resurrect the ticket on
                    # replay.
                    self._journal_append_locked("cancel",
                                                ticket=str(ticket))
                except OSError as e:
                    raise DurabilityLost(
                        f"journal append failed "
                        f"({self._durability_lost}) — cancellation "
                        "refused", detail=self._durability_lost) from e
            if rec is not None and rec["status"] == "queued":
                rec["status"] = "cancelled"
                self._queue = [t for t in self._queue if t != rec["ticket"]]
                self._mark_terminal_locked(rec["ticket"])
                cancelled = True
            elif rec is not None and rec["status"] == "running":
                rec["status"] = "cancelled"
                lane = rec["lane"]
                if lane is not None:
                    self._lane_ticket.pop(lane, None)
                    self._cancel_lanes.append(lane)
                # lane is None while the ticket is mid-admission (the
                # driver popped it from the queue but has not assigned
                # its lane yet): _admit_on_device sees the terminal
                # status when it records the mapping and routes the
                # freshly assigned lane to _cancel_lanes itself —
                # appending None here would crash the next tick's
                # retire and kill the driver.
                self._mark_terminal_locked(rec["ticket"])
                cancelled = True
            if cancelled:
                self._counts["cancelled"] += 1
                self._dirty = True
                self._submit_walls.pop(str(ticket), None)
                self._cond.notify_all()
        if cancelled:
            self._m_cancelled.inc()
        return cancelled

    def wait(self, ticket: str, timeout: Optional[float] = None) -> dict:
        """Block until the ticket reaches a terminal state; returns its
        record. The await side of the API — ``/poll`` is the polling
        side. Raises ``KeyError`` for unknown ids, ``TimeoutError`` on
        deadline, :class:`ServiceClosed` if the driver dies first."""
        deadline = None if timeout is None \
            else time.monotonic() + float(timeout)
        snap, _, _ = self._await_ticket(ticket, deadline, timeout,
                                        until_tick_change=False)
        return snap

    def stream(self, ticket: str, timeout: Optional[float] = None):
        """Yield the ticket's record after every driver tick until it
        goes terminal (the last yield) — the streaming view of
        :meth:`wait`. Same error contract as :meth:`wait`."""
        deadline = None if timeout is None \
            else time.monotonic() + float(timeout)
        last_tick = -1
        seen_once = False
        while True:
            snap, last_tick, seen_once = self._await_ticket(
                ticket, deadline, timeout, until_tick_change=True,
                last_tick=last_tick, seen_once=seen_once)
            yield snap
            if snap["status"] in TERMINAL_STATES:
                return

    def _await_ticket(self, ticket: str, deadline: Optional[float],
                      timeout: Optional[float], *,
                      until_tick_change: bool, last_tick: int = -1,
                      seen_once: bool = False):
        """The shared condition-wait core of :meth:`wait` /
        :meth:`stream` (ONE copy of the error contract both promise):
        block until the ticket goes terminal — or, when
        ``until_tick_change``, until the driver tick advances — and
        return ``(snapshot, tick, seen_once)``."""
        with self._cond:
            while True:
                rec = self._tickets.get(str(ticket))
                if rec is None:
                    # A ticket that WAS visible and then vanished was
                    # evicted past done_retention before this waiter
                    # woke — its result is gone, but say so honestly
                    # instead of claiming the id never existed.
                    raise KeyError(
                        f"ticket {ticket!r} evicted past done_retention="
                        f"{self.done_retention} before the waiter "
                        "observed its result — raise done_retention"
                        if seen_once else f"unknown ticket {ticket!r}")
                seen_once = True
                if (rec["status"] in TERMINAL_STATES
                        or (until_tick_change and self._tick != last_tick)):
                    return dict(rec), self._tick, seen_once
                if self._closed:
                    raise ServiceClosed(
                        self._driver_error or "service closed while waiting")
                remaining = 1.0 if deadline is None \
                    else deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"ticket {ticket} not terminal after {timeout}s")
                self._cond.wait(timeout=min(remaining, 1.0))

    def tickets(self) -> Dict[str, dict]:
        """Copies of every retained ticket record (determinism probes,
        the chaos-soak comparison)."""
        with self._cond:
            return {tid: dict(rec) for tid, rec in self._tickets.items()}

    def busy(self) -> bool:
        """True while anything is queued or running."""
        with self._cond:
            return bool(self._queue or self._lane_ticket)

    @property
    def driver_running(self) -> bool:
        """True while the background driver thread owns :meth:`tick` —
        synchronous drivers (serve/traffic.drive) must refuse to run
        concurrently with it (the batch is driver-confined)."""
        with self._cond:
            return self._thread is not None

    @property
    def tick_index(self) -> int:
        """Completed driver ticks (what traffic replay aligns on)."""
        with self._cond:
            return self._tick

    @property
    def round_index(self) -> int:
        """Cumulative engine rounds executed."""
        with self._cond:
            return self._round

    def stats(self) -> dict:
        """The ``/stats`` document: queue/lane occupancy, admission
        budget, lifetime counts and completion-rounds percentiles (over
        a rolling window of recent completions)."""
        with self._cond:
            lat = list(self._latencies)
            doc = {
                "capacity": self.capacity,
                "graph_nodes": self.graph.n_nodes,
                "graph_capacity": self.graph.n_nodes_padded,
                "mutations_queued": len(self._mutations),
                "queue_depth": len(self._queue),
                "queue_limit": self.queue_depth,
                "active_lanes": len(self._lane_ticket),
                # cancel-pending lanes left the running map but stay
                # admitted on device until the next retire — not free.
                "free_lanes": max(0, self.capacity - len(self._lane_ticket)
                                  - len(self._cancel_lanes)),
                "admit_budget": self._admit_budget,
                "target_active_lanes": self._target_active,
                "tick": self._tick,
                "round": self._round,
                "messages": self._messages,
                "tickets_retained": len(self._tickets),
                "closed": self._closed,
                "quota_tokens": dict(self._buckets),
                # graftdur durability fields: the fencing epoch, why
                # the service is shedding (None while durable), the
                # unreplayed journal suffix, and the seqno a pair
                # published now would cover.
                "epoch": self._epoch,
                "durability_lost": self._durability_lost,
                "replay_pending": len(self._replay_queue),
                "journal_covered": self._j_covered_locked()
                if self._journal is not None else None,
                **self._counts,
            }
        if self._journal is not None:
            doc["journal"] = self._journal.stats()
        if lat:
            doc["completion_rounds_p50"] = float(np.percentile(lat, 50))
            doc["completion_rounds_p99"] = float(np.percentile(lat, 99))
        return doc

    # ------------------------------------------------------------- the tick

    def tick(self) -> dict:
        """One driver iteration: retire recycled lanes, admit from the
        queue under the pacing budget, advance every running lane one
        ``chunk_rounds`` engine chunk, harvest completions, checkpoint.
        Synchronous and deterministic — the background driver just calls
        this in a loop. Returns ``{"admitted", "completed",
        "executed_rounds", "running", "active"}`` for harness
        bookkeeping (``running`` = lanes in flight during this tick's
        engine chunk, ``active`` = still running after harvest).

        Every tick is profiled into the :data:`TICK_PHASES` wall
        breakdown (``serve_tick_phase_seconds{phase}``, the last-tick
        gauges the history ring samples, and the ``/dashboard`` tick
        slice); with a tracer installed the tick additionally emits a
        ``serve_tick`` span with per-phase children plus per-ticket
        correlated lifecycle events under ``tkt-<ticket>`` trace ids
        (:func:`ticket_trace`). Wall times never enter ticket records
        — the profiler does not move the determinism contract."""
        tracer = spans.current_tracer()
        pc = _PhaseClock(tracer)
        # Mutate first: queued graph deltas / growth land atomically
        # BEFORE this tick's chunk, so the dispatch below runs entirely
        # against the post-mutation graph (and a repadded batch) — never
        # mid-chunk, never half-applied.
        pc.enter("mutate")
        with self._cond:
            if self._closed:
                raise ServiceClosed(self._driver_error or "service is closed")
            # Replay fallback (graftdur): recovered journal records due
            # at or before this tick apply now — drives consume the
            # suffix positionally BEFORE calling tick(), so anything
            # still here belongs to an earlier slot (a non-drive
            # resume). Records for later ticks stay queued.
            while (self._replay_queue
                   and int(self._replay_queue[0].get("tick", 0))
                   <= self._tick):
                self._replay_apply_locked(self._replay_queue.pop(0))
            # Snapshot-then-clear under the lock: the drained list is a
            # fresh private copy, so iterating it during the (slow,
            # lock-free) apply below never touches shared state.
            muts, self._mutations = list(self._mutations), []
        if muts:
            self._apply_mutations(muts)
        pc.enter("retire")
        if self._watchdog is None and self.deadline_s is not None:
            self._watchdog = Watchdog(
                self.deadline_s, name="serve-driver",
                on_stall=self.on_stall, registry=self._registry).start()
        if self._watchdog is not None:
            self._watchdog.heartbeat()
        with self._cond:
            if self._closed:
                raise ServiceClosed(self._driver_error or "service is closed")
            for tenant, (rate, burst) in self._quotas.items():
                self._buckets[tenant] = min(
                    burst, self._buckets.get(tenant, burst) + rate)
            retire = list(self._cancel_lanes)
            self._cancel_lanes = []
        retire.extend(self._retire_ready)
        self._retire_ready = []
        if retire:
            self._batch = self._protocol.retire(self._batch, sorted(retire))
            self._admitted[retire] = False

        # Admission under the pacing budget: free lanes are the
        # non-running ones (every harvested/cancelled lane was just
        # retired above) MINUS any cancel that landed since that retire
        # snapshot — its lane left _lane_ticket but is still admitted
        # on the device until the NEXT tick's retire, so counting it
        # free would over-admit and trip admit()'s LaneExhausted. No
        # device sync needed either way.
        pc.enter("admit")
        admits: List[Tuple[str, int, float]] = []
        with self._cond:
            free = max(0, self.capacity - len(self._lane_ticket)
                       - len(self._cancel_lanes))
            budget = min(
                free, self._admit_budget,
                max(0, self._target_active - len(self._lane_ticket)))
            while self._queue and len(admits) < budget:
                tid = self._queue.pop(0)
                rec = self._tickets[tid]
                rec["status"] = "running"
                rec["admitted_tick"] = self._tick
                rec["admitted_round"] = self._round
                admits.append((tid, rec["source"], rec["target"]))
            round0 = self._round
            tick0 = self._tick
        if admits:
            self._admit_on_device(admits)

        # One engine chunk for every running lane (skipped when idle).
        pc.enter("dispatch")
        lane_tids: List[Tuple[int, str]] = []
        with self._cond:
            running = len(self._lane_ticket)
            if tracer is not None and running:
                # Snapshot BEFORE the chunk: these are the tickets the
                # dispatch served.
                lane_tids = sorted(self._lane_ticket.items())
        executed = 0
        out: dict = {}
        if running:
            chunk_key = prng.fold_in(self._base_key, round0 + 1)

            def dispatch(b):
                return engine.run_batch_until_coverage(
                    self.graph, self._protocol, b, chunk_key,
                    max_rounds=self.chunk_rounds)

            if self._healer is not None:
                # The retained input is the rollback state; a retry
                # re-runs the same chunk key, so a healed tick's results
                # are bit-identical to an undisturbed one.
                self._batch, out = self._healer.run_chunk(
                    dispatch, self._batch, chunk_index=tick0)
            else:
                self._batch, out = dispatch(self._batch)
            executed = int(out["rounds"])
        heal_report = self._healer.last_report \
            if (self._healer is not None and running) else None
        faulted = bool(heal_report and heal_report["events"])
        if faulted and heal_report["healed"]:
            self._m_healed_ticks.inc()
        if tracer is not None:
            self._emit_ticket_chunk_events(lane_tids, tick0, executed,
                                           heal_report)
        if self._tick_fault is not None:
            # Crash seam (chaos/crashstorm.py): mid-tick, after the
            # dispatch, before any of its results reach the ticket
            # table — the window where a kill costs the most state.
            self._tick_fault(tick0)
        pc.enter("harvest")
        completed = self._harvest(out, executed)
        if self._journal is not None:
            # The per-tick durability barrier (fsync="tick" policy):
            # everything acknowledged this tick reaches the platter
            # before the tick ends. A failing barrier is a durability
            # loss like a failing append — flip and shed, loudly, but
            # keep the driver alive (completed work is still real).
            try:
                self._journal.tick_barrier()
            except OSError as e:
                with self._cond:
                    if self._durability_lost is None:
                        self._durability_lost = (
                            f"journal fsync failed: "
                            f"{type(e).__name__}: {e}")
        if self._slo is not None:
            self._feed_slo(running, faulted, tick0)
        if self._watchdog is not None:
            self._watchdog.heartbeat()
        pc.enter("checkpoint")

        # Checkpoint AFTER the preemption gate: an armed kill fires
        # before the checkpoint due at this boundary, like a real
        # SIGKILL (supervise-plane semantics).
        with self._cond:
            fire_preempt = (self._preempt_at is not None
                            and self._tick >= self._preempt_at)
            if fire_preempt:
                self._preempt_at = None
            if admits or retire or completed or executed:
                self._dirty = True
            dirty = self._dirty
            tick_now = self._tick
            active = len(self._lane_ticket)
            qdepth = len(self._queue)
        self._m_ticks.inc()
        self._m_active.set(float(active))
        self._m_queue.set(float(qdepth))
        if fire_preempt:
            # The kill closes the service like the SIGKILL it simulates:
            # further ticks/submits refuse, and close() must NOT take a
            # final checkpoint (resume wants the PRE-kill durable pair).
            with self._cond:
                self._closed = True
                self._driver_error = f"preempted at tick {tick_now}"
                self._cond.notify_all()
            raise Preempted(tick_now)
        if (self._store is not None and dirty
                and tick_now % self.checkpoint_every_ticks == 0):
            self._checkpoint()
        self._record_phases(pc.done(tick0), tick0)
        return {"admitted": len(admits), "completed": completed,
                "executed_rounds": executed, "running": running,
                "active": active}

    def _feed_slo(self, running: int, faulted: bool, tick0: int) -> None:
        """One heal observation per dispatching tick (idle ticks are no
        evidence either way), one durability observation per tick, then
        the tick's evaluation. A firing admission-signal objective is a
        multiplicative decrease of the admit budget; recovery rides the
        AIMD additive increase."""
        if running:
            self._slo.record("heal", 1.0 if faulted else 0.0)
        with self._cond:
            dur_lost = self._durability_lost is not None
        self._slo.record("durability", 1.0 if dur_lost else 0.0)
        self._slo.evaluate(tick0)
        if self._slo.firing(admission_only=True):
            with self._cond:
                self._admit_budget = max(1, self._admit_budget // 2)
                budget_now = self._admit_budget
            self._m_budget.set(float(budget_now))

    def _emit_ticket_chunk_events(self, lane_tids: List[Tuple[int, str]],
                                  tick0: int, executed: int,
                                  heal_report: Optional[dict]) -> None:
        """Per-ticket trace events of one dispatched chunk (tracer on
        only): a ``ticket_chunk`` point under each riding ticket's
        ``tkt-<id>`` trace and, when the Healer's report says the chunk
        faulted, the fault -> integrity-fail -> heal-retry
        (-> heal-recovered) chain — the chunk is shared, so a fault on it
        is an event in every riding ticket's lifecycle."""
        events = heal_report["events"] if heal_report else []
        for lane, tid in lane_tids:
            tr = ticket_trace(tid)
            spans.emit("ticket_chunk", trace=tr, ticket=tid, lane=lane,
                       tick=tick0, rounds=executed, faulted=bool(events))
            for ev in events:
                spans.emit("ticket_fault", trace=tr, ticket=tid,
                           kind=ev["failure"], chunk=heal_report["chunk"],
                           attempt=ev["attempt"])
                if "integrity_kind" in ev:
                    spans.emit("ticket_integrity_fail", trace=tr,
                               ticket=tid, kind=ev["integrity_kind"],
                               leaf=ev.get("leaf", ""),
                               chunk=heal_report["chunk"])
                spans.emit("ticket_heal_retry", trace=tr, ticket=tid,
                           attempt=ev["attempt"], action=ev["action"],
                           degraded=ev["degraded"])
            if events and heal_report["healed"]:
                spans.emit("ticket_heal_recovered", trace=tr, ticket=tid,
                           attempts=heal_report["attempts"],
                           fallback=heal_report["fallback"])

    def _record_phases(self, phases: Dict[str, float], tick: int) -> None:
        """Fold one tick's phase walls into the profiler state: the
        per-phase histogram + last-tick gauges (what the history ring
        joins with the flight recorder's per-round columns) and the
        bounded recent-ticks ring behind :meth:`tick_phases`."""
        row = {"tick": tick}
        for ph in TICK_PHASES:
            s = phases.get(ph, 0.0)
            row[ph] = s
            self._m_phase.labels(ph).observe(s)
            self._m_phase_wall.labels(ph).set(s)
        with self._phase_lock:
            self._phase_ticks += 1
            self._phase_ring.append(row)
            if len(self._phase_ring) > 128:
                del self._phase_ring[:-128]
            for ph in TICK_PHASES:
                s = row[ph]
                self._phase_totals[ph] = self._phase_totals.get(ph, 0.0) + s
                if s > self._phase_max.get(ph, 0.0):
                    self._phase_max[ph] = s

    def tick_phases(self) -> dict:
        """The tick-phase profile (graftsight): ``{"ticks", "per_phase":
        {phase: {"total_s", "mean_s", "last_s", "max_s"}}, "recent":
        [last 32 per-tick rows]}``. Thread-safe — what ``/dashboard``
        and the bench ``serving.tick_phases`` slice read."""
        with self._phase_lock:
            ticks = self._phase_ticks
            totals = dict(self._phase_totals)
            maxes = dict(self._phase_max)
            recent = list(self._phase_ring[-32:])
        per_phase = {}
        for ph in TICK_PHASES:
            tot = totals.get(ph, 0.0)
            per_phase[ph] = {
                "total_s": tot,
                "mean_s": tot / ticks if ticks else 0.0,
                "last_s": recent[-1][ph] if recent else 0.0,
                "max_s": maxes.get(ph, 0.0),
            }
        return {"ticks": ticks, "per_phase": per_phase, "recent": recent}

    def dashboard_slice(self) -> dict:
        """What ``/dashboard`` embeds for this service (duck-typed by
        telemetry/httpd.py): the ``/stats`` document plus the
        tick-phase profile."""
        return {"stats": self.stats(), "tick_phases": self.tick_phases()}

    def _admit_on_device(self, admits: List[Tuple[str, int, float]]) -> None:
        """Seed the popped submissions into open lanes, grouped by
        coverage target (``admit`` takes one target per call), and
        record the lane→ticket mapping. Group order is first-appearance,
        so lane assignment is deterministic."""
        groups: Dict[float, List[Tuple[str, int]]] = {}
        for tid, source, target in admits:
            groups.setdefault(target, []).append((tid, source))
        assigned: List[Tuple[int, str]] = []
        for target, entries in groups.items():
            sources = [source for _, source in entries]
            # LaneExhausted is unreachable by construction here (the
            # budget is capped at the free-lane count, cancel-pending
            # lanes excluded); if the invariant breaks it propagates.
            self._batch, lanes = self._protocol.admit(
                self.graph, self._batch, sources, coverage_target=target,
                open_lanes=np.flatnonzero(~self._admitted))
            self._admitted[lanes] = True
            assigned.extend(zip(lanes.tolist(), [tid for tid, _ in entries]))
        # Lanes whose SEED already meets the target start done at
        # admission: the engine excludes pre-run-done lanes from
        # ``newly_completed_lanes``, so complete their tickets HERE. The
        # new lanes' done flags and seen counts come back in one read.
        lane_ids = [lane for lane, _ in assigned]
        idx = torch.tensor(lane_ids, dtype=torch.int64,
                           device=self._batch.done.device)
        _device.SYNCS += 1
        done_new, seen_new = torch.stack([
            self._batch.done[idx].to(torch.int32),
            self._batch.seen_count[idx]]).tolist()
        done_of = dict(zip(lane_ids, done_new))
        seen_of = dict(zip(lane_ids, seen_new))
        instant = [lane for lane in lane_ids if done_of[lane]]
        hashes = self._hash_lanes(instant) \
            if (self._record_seen_hash and instant) else {}
        completions: List[Tuple[str, dict]] = []
        with self._cond:
            for lane, tid in assigned:
                rec = self._tickets.get(tid)
                if rec is None:
                    # Cancelled AND evicted past done_retention inside
                    # the unlocked admission gap: nothing left to
                    # record — just recycle the lane.
                    self._cancel_lanes.append(lane)
                    continue
                rec["lane"] = lane
                if rec["status"] in TERMINAL_STATES:
                    # Cancelled while mid-admission (status flipped
                    # between the queue pop and this lock): never runs —
                    # recycle the lane instead of mapping it, or the
                    # harvest would flip a terminal ticket back to done.
                    self._cancel_lanes.append(lane)
                elif done_of[lane]:
                    rec["status"] = "done"
                    rec["rounds"] = 0
                    rec["seen_count"] = seen_of[lane]
                    rec["coverage"] = seen_of[lane] / max(self._n_live, 1)
                    rec["latency_rounds"] = (rec["admitted_round"]
                                             - rec["submitted_round"])
                    if lane in hashes:
                        rec["seen_sha256"] = hashes[lane]
                    self._mark_terminal_locked(tid)
                    self._counts["completed"] += 1
                    self._latencies.append(rec["latency_rounds"])
                    self._cancel_lanes.append(lane)  # recycle next tick
                    completions.append((tid, dict(rec)))
                else:
                    self._lane_ticket[lane] = tid
            walls = [(tid, self._submit_walls.pop(tid, None))
                     for tid, _ in completions]
            if completions:
                self._cond.notify_all()
        if spans.current_tracer() is not None:
            for lane, tid in assigned:
                spans.emit("ticket_admit", trace=ticket_trace(tid),
                           ticket=tid, lane=lane)
        self._report_completions(completions, walls)

    def _report_completions(self, completions: List[Tuple[str, dict]],
                            walls: List[Tuple[str, Optional[float]]]) -> None:
        """Post-lock completion reporting shared by the chunk harvest
        and the instant-done admission path: the completed counter, both
        latency histograms, the ``ticket_done`` trace event."""
        now = time.perf_counter()
        tracer = spans.current_tracer()
        for (tid, rec), (_, t_sub) in zip(completions, walls):
            self._m_completed.inc()
            self._m_latency_rounds.observe(rec["latency_rounds"])
            if self._slo is not None:
                self._slo.record("completion_rounds",
                                 rec["latency_rounds"])
            if t_sub is not None:
                self._m_latency_s.observe(now - t_sub)
                if self._slo is not None:
                    self._slo.record("completion_wall_s", now - t_sub)
            if tracer is not None:
                spans.emit("ticket_done", trace=ticket_trace(tid),
                           ticket=tid, rounds=rec["rounds"],
                           latency_rounds=rec["latency_rounds"])

    def _harvest(self, out: dict, executed: int) -> int:
        """Fold one chunk's results back into the ticket table: newly
        completed lanes become ``done`` records (with their latency),
        stragglers past ``max_ticket_rounds`` become ``timeout``; both
        kinds queue for recycling at the next tick's retire."""
        newly = out.get("newly_completed_lanes")
        newly = newly.tolist() if newly is not None else []
        rounds_list = out["lane_rounds"].tolist() if out else []
        seen_hash: Dict[int, str] = {}
        seen_list: List[int] = []
        # The seen counts are read only when a lane completed or may have
        # timed out (with the seen words for the hashes): one read.
        if out and (newly or max(rounds_list, default=0)
                    >= self.max_ticket_rounds):
            hash_now = self._record_seen_hash and bool(newly)
            seen_list, words = self._read_lanes(hash_now)
            if hash_now:
                seen_hash = self._hash_words(words, newly)
        completions: List[Tuple[str, dict]] = []
        recycled: List[int] = []  # folded into the driver-confined
        # _retire_ready AFTER the lock (it is not lock-guarded state)
        with self._cond:
            self._round += executed
            self._messages += int(out["messages"]) if out else 0
            for lane in newly:
                tid = self._lane_ticket.pop(lane, None)
                recycled.append(lane)
                if tid is None:
                    continue  # cancelled mid-chunk; lane already recycled
                rec = self._tickets[tid]
                rec["status"] = "done"
                rec["rounds"] = rounds_list[lane]
                rec["seen_count"] = seen_list[lane]
                rec["coverage"] = seen_list[lane] / max(self._n_live, 1)
                rec["latency_rounds"] = (
                    (rec["admitted_round"] - rec["submitted_round"])
                    + rounds_list[lane])
                if lane in seen_hash:
                    rec["seen_sha256"] = seen_hash[lane]
                self._mark_terminal_locked(tid)
                self._counts["completed"] += 1
                self._latencies.append(rec["latency_rounds"])
                completions.append((tid, dict(rec)))
            if len(self._latencies) > 4096:
                del self._latencies[:-2048]
            # Stragglers past the per-ticket round bound: cut off.
            timed_out: List[Tuple[int, str]] = []
            if rounds_list:
                for lane, tid in list(self._lane_ticket.items()):
                    if rounds_list[lane] >= self.max_ticket_rounds:
                        timed_out.append((lane, tid))
            for lane, tid in timed_out:
                self._lane_ticket.pop(lane, None)
                recycled.append(lane)
                rec = self._tickets[tid]
                rec["status"] = "timeout"
                rec["rounds"] = rounds_list[lane]
                rec["seen_count"] = seen_list[lane]
                rec["coverage"] = seen_list[lane] / max(self._n_live, 1)
                self._mark_terminal_locked(tid)
                self._submit_walls.pop(tid, None)  # never completes
                self._counts["timeout"] += 1
            # AIMD pacing off the chunk's observed completion
            # percentiles: over-SLO p99 halves the budget, a healthy
            # COMPLETING chunk claws back additively. A chunk that
            # completed nothing carries no p99 — if its oldest running
            # lane is already past the SLO that silence IS the overload
            # signal (halve); otherwise it is no evidence either way
            # (hold, never grow — a fully stalled system must not earn
            # additive increase from rounds that finished nothing).
            if self.slo_rounds is not None and out:
                p99 = out.get("completion_rounds_p99")
                oldest = max((rounds_list[lane]
                              for lane in self._lane_ticket), default=0)
                if ((p99 is not None and p99 > self.slo_rounds)
                        or (p99 is None and oldest > self.slo_rounds)):
                    self._admit_budget = max(1, self._admit_budget // 2)
                elif p99 is not None:
                    self._admit_budget = min(
                        self._target_active,
                        self._admit_budget + max(1, self.capacity // 16))
            self._tick += 1
            walls = [(tid, self._submit_walls.pop(tid, None))
                     for tid, _ in completions]
            budget_now = self._admit_budget
            self._cond.notify_all()
        self._retire_ready.extend(recycled)
        self._report_completions(completions, walls)
        tracer = spans.current_tracer()
        for lane, tid in timed_out:
            self._m_timeout.inc()
            if tracer is not None:
                spans.emit("ticket_timeout", trace=ticket_trace(tid),
                           ticket=tid, lane=lane)
        self._m_budget.set(float(budget_now))
        return len(completions)

    def _read_lanes(self, with_words: bool):
        """Every lane's ``seen_count`` (a list) and, when asked, the
        ``seen`` words as the reference's ``uint32[W, N_pad]``, in one
        counted read."""
        b = self._batch
        _device.SYNCS += 1
        if not with_words:
            return b.seen_count.tolist(), None
        host = torch.cat([b.seen_count, b.seen.reshape(-1)]).cpu().numpy()
        cap = b.seen_count.shape[0]
        return (host[:cap].tolist(),
                host[cap:].view(np.uint32).reshape(b.seen.shape))

    def _hash_lanes(self, lanes: List[int]) -> Dict[int, str]:
        """sha256 of each lane's packed seen bits (one counted read)."""
        return self._hash_words(self._read_lanes(True)[1], lanes)

    @staticmethod
    def _hash_words(words: np.ndarray, lanes: List[int]) -> Dict[int, str]:
        """sha256 of each lane's seen bits, ``np.packbits`` of its bit
        plane — the words viewed as ``uint32`` so lane 31's bit is not
        sign-extended."""
        out = {}
        for lane in lanes:
            w, b = divmod(lane, 32)
            bits = ((words[w] >> np.uint32(b)) & np.uint32(1)).astype(np.uint8)
            out[lane] = hashlib.sha256(np.packbits(bits).tobytes()).hexdigest()
        return out

    def _mark_terminal_locked(self, tid: str) -> None:
        """Bound the terminal-record table (caller holds the lock):
        oldest terminal tickets past ``done_retention`` are evicted (a
        later poll returns None, documented)."""
        self._done_order.append(tid)
        while len(self._done_order) > self.done_retention:
            old = self._done_order.pop(0)
            self._tickets.pop(old, None)
            self._submit_walls.pop(old, None)

    # ------------------------------------------- graftdur durability plane

    def _journal_append_locked(self, kind: str, **fields) -> Optional[int]:
        """Append one admission-plane intent record (caller holds
        ``_cond``); returns its seqno, or ``None`` with no journal
        configured. Any failure flips the service into the sticky
        :class:`DurabilityLost` shedding mode BEFORE propagating — the
        intent was never acknowledged, and nothing after a possibly-torn
        tail may be."""
        if self._journal is None:
            return None
        try:
            seq = self._journal.append(kind, tick=self._tick, **fields)
        except BaseException as e:
            if self._durability_lost is None:
                self._durability_lost = (
                    f"journal append failed: {type(e).__name__}: {e}")
            raise
        self._j_acked = seq
        return seq

    def _j_covered_locked(self) -> int:
        """The seqno a pair published NOW covers (caller holds
        ``_cond``): everything acknowledged, MINUS journaled intents the
        pair does not yet reflect — queued-but-unapplied mutations and
        the unconsumed replay suffix. Compaction keys on this, so those
        intents survive in the journal until something applies them."""
        covered = self._j_acked
        if self._j_pending_mut:
            covered = min(covered, self._j_pending_mut[0] - 1)
        if self._replay_queue:
            covered = min(covered,
                          int(self._replay_queue[0]["seq"]) - 1)
        return covered

    def replay_pending(self) -> int:
        """Journal records recovered at resume and not yet replayed."""
        with self._cond:
            return len(self._replay_queue)

    def replay_peek(self) -> Optional[dict]:
        """The next recovered record awaiting replay (a copy), or
        ``None``. Drives use the ``kind``/``tick`` fields to consume
        positionally — each record at its original arrival slot."""
        with self._cond:
            return dict(self._replay_queue[0]) \
                if self._replay_queue else None

    def replay_next(self) -> Optional[dict]:
        """Replay ONE recovered record onto the service state and
        return it (``None`` when the suffix is exhausted). A replayed
        submit re-issues the SAME ticket id the crashed life
        acknowledged (verified against the persisted counter — a
        divergence is a corrupted-trail error, raised loudly); grows
        and deltas re-queue for the next tick's mutate phase; sheds and
        cancels re-apply their counts/transitions. Process metrics
        count live operations only — replay touches none."""
        with self._cond:
            if not self._replay_queue:
                return None
            rec = self._replay_queue.pop(0)
            self._replay_apply_locked(rec)
            return dict(rec)

    def _replay_apply_locked(self, rec: dict) -> None:
        seq = int(rec["seq"])
        kind = rec.get("kind")
        if kind == "submit":
            tid = str(rec["ticket"])
            want = f"t{self._next_ticket:08d}"
            if tid != want:
                raise RuntimeError(
                    f"journal replay diverged: record {seq} "
                    f"acknowledges ticket {tid!r} but this service "
                    f"would issue {want!r} — the checkpoint pair and "
                    "journal disagree (mixed trails?); refusing to "
                    "re-issue an acknowledged id to different work")
            tenant = str(rec.get("tenant", "default"))
            if tenant in self._quotas:
                self._buckets[tenant] = \
                    self._buckets.get(tenant, 0.0) - 1.0
            self._next_ticket += 1
            self._tickets[tid] = {
                "ticket": tid, "tenant": tenant,
                "source": int(rec.get("source", 0)),
                "target": float(rec.get("target", 0.99)),
                "status": "queued",
                "submitted_tick": int(rec.get("tick", self._tick)),
                "submitted_round": int(rec.get("round", self._round)),
                "admitted_tick": None, "admitted_round": None,
                "lane": None, "rounds": None, "seen_count": None,
                "coverage": None, "latency_rounds": None,
            }
            self._queue.append(tid)
            # No _submit_walls entry: wall latency is a live-process
            # observation; completion handlers tolerate the None.
            self._counts["submitted"] += 1
            self._dirty = True
        elif kind == "shed":
            self._counts["rejected"] += 1
            self._dirty = True
        elif kind == "cancel":
            tid = str(rec.get("ticket"))
            r = self._tickets.get(tid)
            if r is not None and r["status"] == "queued":
                r["status"] = "cancelled"
                self._queue = [t for t in self._queue if t != tid]
                self._mark_terminal_locked(tid)
                self._counts["cancelled"] += 1
                self._dirty = True
            elif r is not None and r["status"] == "running":
                r["status"] = "cancelled"
                lane = r["lane"]
                if lane is not None:
                    self._lane_ticket.pop(lane, None)
                    self._cancel_lanes.append(lane)
                self._mark_terminal_locked(tid)
                self._counts["cancelled"] += 1
                self._dirty = True
        elif kind == "grow":
            self._mutations.append(("grow", int(rec.get("n", 0)), seq))
            self._j_pending_mut.append(seq)
        elif kind == "delta":
            self._mutations.append(
                ("delta", _delta_from_fields(rec), seq))
            self._j_pending_mut.append(seq)
        # Unknown kinds skip silently (forward compatibility) but still
        # advance the acknowledged cover below — they WERE acknowledged.
        if seq > self._j_acked:
            self._j_acked = seq
        self._cond.notify_all()

    # ------------------------------------------------------ mutation plane

    def _apply_mutations(
            self, muts: List[Tuple[str, Any, Optional[int]]]) -> None:
        """Drain one tick's queued mutations onto the served graph
        (driver-confined — the graph and batch are the driver's).

        Deltas ride ``apply_delta(donate=...)`` — the first delta
        copies (the constructor graph is caller-owned; see
        ``_graph_donate_safe``), after which every delta takes the
        churn-storm fast path (touched neighbor rows scatter in
        place); growth rides
        ``graph.grow`` with its geometric repad schedule. When the
        padded capacity changes, the in-flight batch zero-extends via
        ``repad`` — zero admitted lanes dropped. A failing
        mutation propagates and kills the driver loudly: mutations are
        operator actions, and a half-applied queue must not be
        silently skipped."""
        g = self.graph
        old_pad = g.n_nodes_padded
        for kind, payload, _seq in muts:
            if kind == "grow":
                g = graph_mod.grow(g, payload)
                self._growth_history.append({
                    "tick": self._tick, "n_new": int(payload),
                    "n_nodes": int(g.n_nodes),
                    "n_pad": int(g.n_nodes_padded)})
            else:
                g = graph_mod.apply_delta(
                    g, payload, donate=self._graph_donate_safe)
                self._graph_donate_safe = True
                self._edges_sha = None   # edge content changed
            self._m_mutations.labels(kind).inc()
            if spans.current_tracer() is not None:
                spans.emit("serve_mutation", kind=kind, tick=self._tick,
                           n_nodes=int(g.n_nodes),
                           n_pad=int(g.n_nodes_padded))
        new_pad = g.n_nodes_padded
        self.graph = g
        self._graph_fp = None            # identity changed either way
        if new_pad != old_pad:
            # Capacity repad: the batch's per-node axes zero-extend (no
            # admitted lane touched; latched completions stay latched)
            # and the next dispatch runs at the grown shape.
            self._batch = self._protocol.repad(self._batch, new_pad)
            if self._healer is not None:
                from p2pnetwork_tpu_torch.supervise.heal import host_template

                self._healer.template = host_template(self._batch)
        n_live = _live_count(g)
        applied = {seq for _, _, seq in muts if seq is not None}
        with self._cond:
            self._n_live = n_live
            self._counts["mutations"] += len(muts)
            self._dirty = True
            if applied:
                # These journaled intents are now IN the service state:
                # the next published pair reflects them, so the cover
                # may advance past their records (a failing mutation
                # propagated above instead — its seq stays pending and
                # the journal keeps the record for the next resume).
                self._j_pending_mut = [
                    s for s in self._j_pending_mut if s not in applied]
        self._m_capacity.set(float(new_pad))

    def _graph_fingerprint(self) -> str:
        """The served graph's identity for the sidecar: the
        sim/layoutcache.py source fingerprint folded with this graph's
        node/edge counts, padded capacity, and edge-content sha. Cached
        until a mutation invalidates it (growth keeps the edge sha —
        edges are untouched — deltas recompute it)."""
        if self._graph_fp is not None:
            return self._graph_fp
        g = self.graph
        if self._edges_sha is None:
            _device.SYNCS += 1
            h = hashlib.sha256()
            for arr in (g.senders, g.receivers, g.edge_mask):
                h.update(np.ascontiguousarray(arr.cpu().numpy()).tobytes())
            self._edges_sha = h.hexdigest()[:16]
        self._graph_fp = layoutcache.fingerprint(params={"serve_graph": {
            "n_nodes": int(g.n_nodes), "n_edges": int(g.n_edges),
            "n_pad": int(g.n_nodes_padded), "edges_sha": self._edges_sha,
        }})
        return self._graph_fp

    # ------------------------------------------------------------- driver

    def _driver_loop(self) -> None:
        """Background production driver: tick whenever there is work (or
        on the idle cadence, which keeps tick-based quota refill
        advancing). Any escape — Preempted included — closes the service
        with the error recorded for submitters/waiters."""
        while True:
            with self._cond:
                if self._closed:
                    return
                if not (self._queue or self._lane_ticket
                        or self._cancel_lanes or self._mutations):
                    self._cond.wait(timeout=self.idle_wait_s)
                if self._closed:
                    return
            try:
                self.tick()
            except ServiceClosed:
                return  # close() landed between the wait and the tick
            except BaseException as e:
                with self._cond:
                    self._closed = True
                    if self._driver_error is None:
                        # tick() may have recorded a deliberate cause
                        # already (a fired preemption) — keep it, so
                        # both driver modes report the event the same.
                        self._driver_error = f"driver died: " \
                            f"{type(e).__name__}: {e}"
                    self._cond.notify_all()
                if isinstance(e, Preempted):
                    return  # deterministic kill: resume via a new service
                raise

    # -------------------------------------------------------- checkpointing

    def _snapshot_locked(self) -> dict:
        # The pair being built covers everything recorded so far; any
        # mutation after this point re-dirties and re-checkpoints.
        self._dirty = False
        return {
            "version": 1,
            "seed": self.seed,
            "round": self._round,
            "tick": self._tick,
            "next_ticket": self._next_ticket,
            "messages": self._messages,
            "queue": list(self._queue),
            "lanes": {str(k): v for k, v in self._lane_ticket.items()},
            "buckets": dict(self._buckets),
            "admit_budget": self._admit_budget,
            "counts": dict(self._counts),
            "done_order": list(self._done_order),
            "latencies": list(self._latencies),
            "tickets": {tid: dict(rec)
                        for tid, rec in self._tickets.items()},
        }

    def _checkpoint(self) -> str:
        """Durably publish the (batch, ticket-table) pair: the batch
        lands as a content-hashed store entry, then the sidecar is
        rename-published REFERENCING that exact entry — a kill between
        the two leaves the previous consistent pair (the sidecar is the
        resume authority, pointing at a never-rewritten entry within the
        retention window)."""
        # Fencing first (graftdur failover): a zombie primary must fail
        # BEFORE its store entry lands, not after — the promoted epoch
        # owns the trail outright.
        self._check_fence()
        # Graph identity (computed outside the lock — it may pull edge
        # arrays to host): the fingerprint gate resume checks, plus the
        # growth steps that sanction a base-fingerprint resume.
        fp = self._graph_fingerprint()
        with self._cond:
            snap = self._snapshot_locked()
            covered = self._j_covered_locked() \
                if self._journal is not None else None
            ours = self._epoch
        snap["graph_fingerprint"] = fp
        snap["graph_fingerprint_base"] = self._graph_fp_base
        snap["growth"] = [dict(s) for s in self._growth_history]
        snap["epoch"] = ours
        if covered is not None:
            # The journal seqno this pair supersedes: resume replays
            # exactly the records past it.
            snap["journal_seqno"] = covered
        try:
            # The store copies each of the batch's fields to the host.
            _device.SYNCS += len(_leaves(self._batch))
            path = self._store.save(self._batch, self._base_key,
                                    snap["round"], snap["messages"])
            snap["checkpoint_file"] = os.path.basename(path)
            if self._publish_fault is not None:
                # Crash seam (chaos/crashstorm.py): between the store
                # entry and the sidecar rename — the classic torn-pair
                # window the previous consistent pair must survive.
                self._publish_fault(snap["tick"])
            atomic_write_json(
                os.path.join(self._store.directory, _SIDECAR), snap,
                suffix=".side.tmp")
        except BaseException:
            # The pair did NOT publish: put the dirty bit back, or a
            # later clean close() would skip its final checkpoint and
            # silently lose everything since the last successful pair.
            with self._cond:
                self._dirty = True
            raise
        if self._journal is not None:
            # The published pair supersedes the journal prefix up to
            # `covered`: rotate the open segment out and drop every
            # closed segment the pair covers. Best-effort — replay
            # filters on journal_seqno anyway, so a failed unlink only
            # costs disk, never correctness.
            try:
                self._journal.rotate()
                self._journal.compact(covered)
            except OSError:
                pass
            self._m_journal_lag.set(
                float(self._journal.last_seq - covered))
        if spans.current_tracer() is not None:
            spans.emit("serve_checkpoint", tick=snap["tick"],
                       round=snap["round"])
        return path

    def checkpoint(self) -> str:
        """Force one durable (batch, sidecar) pair NOW, outside the
        driver's boundary cadence; returns the store entry path. What
        :meth:`~p2pnetwork_tpu_torch.serve.standby.Standby.promote` calls to
        publish its fencing token immediately. Raises
        :class:`FencedEpoch` if a newer epoch owns the trail, and
        ``ValueError`` without a store."""
        if self._store is None:
            raise ValueError("checkpoint() needs a store (pass store=...)")
        return self._checkpoint()

    def _check_fence(self) -> None:
        """Refuse to publish over a trail a newer epoch owns: read the
        current sidecar's fencing token; above ours means a standby
        promoted while we were presumed dead — we are the zombie."""
        if self._store is None:
            return
        with self._cond:
            ours = self._epoch
        side = os.path.join(self._store.directory, _SIDECAR)
        try:
            with open(side, "r", encoding="utf-8") as f:
                current = int(json.load(f).get("epoch", 0))
        except (OSError, ValueError, TypeError):
            return  # no/unreadable sidecar: nothing fences us
        if current > ours:
            raise FencedEpoch(
                f"checkpoint refused: sidecar fencing token (epoch "
                f"{current}) is newer than ours ({ours}) — a "
                "standby promoted over this trail; this service is a "
                "demoted zombie and must not publish",
                ours=ours, current=current)

    def _clear_trail(self) -> None:
        self._store.clear()
        side = os.path.join(self._store.directory, _SIDECAR)
        try:
            os.unlink(side)
        except OSError:
            pass
        # The journal is part of the trail: a discarded pair must not
        # leave a suffix that would replay onto unrelated fresh state.
        if self._journal is not None:
            self._journal.reset()
        else:
            _clear_journal(self._store.directory)
        # Construction-time path, but these are lock-guarded everywhere
        # else — keep the discipline uniform.
        with self._cond:
            self._replay_queue = []
            self._j_acked = 0
            self._j_pending_mut = []

    def _template(self):
        # An empty batch at the service's capacity on its device (the
        # reference shapes it with jax.eval_shape); ~13 MB at 100K nodes
        # and 1,024 lanes.
        return self._protocol.empty(self.graph, self.capacity)

    def _try_resume(self) -> bool:
        """Restore the newest consistent (checkpoint, sidecar) pair; a
        missing or unloadable pair is a fresh start (stale trails
        cleared, runner semantics)."""
        side_path = os.path.join(self._store.directory, _SIDECAR)
        try:
            with open(side_path, "r", encoding="utf-8") as f:
                snap = json.load(f)
        except (OSError, ValueError):
            if self._store.entries():
                self._clear_trail()
            return False
        entry = snap.get("checkpoint_file")
        path = os.path.join(self._store.directory, str(entry))
        # Graph-identity gate (trail-preserving): the sidecar's
        # fingerprint must explain the constructed graph — either it IS
        # the trail's graph, or the trail's recorded growth steps grow
        # the construction into it (the sanctioned exception, replayed
        # here so the batch template below already has the grown
        # shapes). Anything else is a wrong-overlay resume: refuse with
        # the trail intact. Legacy sidecars without a fingerprint skip
        # the gate.
        side_fp = snap.get("graph_fingerprint")
        if side_fp is not None:
            growth = [dict(s) for s in snap.get("growth", [])]
            fp0 = self._graph_fingerprint()
            if fp0 == side_fp:
                self._growth_history = growth
            elif fp0 == snap.get("graph_fingerprint_base"):
                for step in growth:
                    self.graph = graph_mod.grow(
                        self.graph, int(step["n_new"]),
                        node_capacity=int(step["n_pad"]))
                self._graph_fp = None
                self._growth_history = growth
                if self._graph_fingerprint() != side_fp:
                    raise GraphMismatch(
                        f"checkpoint trail at {self._store.directory!r} "
                        "records graph mutations beyond growth (edge "
                        "deltas); replaying the recorded growth onto "
                        "this construction does not reproduce the "
                        "trail's graph — reconstruct the mutated graph "
                        "(persist it with sim/checkpoint.save_graph) or "
                        "pass resume=False to discard the trail",
                        expected=side_fp, got=self._graph_fingerprint(),
                        directory=self._store.directory)
                self._m_capacity.set(float(self.graph.n_nodes_padded))
                # Coverage denominators must see the REGROWN live set:
                # _n_live was computed from the constructed graph, and
                # a stale value would report coverage against the
                # pre-growth overlay (divergent vs an uninterrupted
                # run — the crash-storm campaign caught exactly this).
                n_live = _live_count(self.graph)
                with self._cond:
                    self._n_live = n_live
                if spans.current_tracer() is not None:
                    spans.emit("serve_resume_regrow",
                               steps=len(growth),
                               n_pad=int(self.graph.n_nodes_padded))
            else:
                raise GraphMismatch(
                    f"checkpoint trail at {self._store.directory!r} was "
                    f"written against a different overlay (recorded "
                    f"fingerprint {side_fp}, constructed graph "
                    f"{fp0}) — construct with the graph the trail "
                    "belongs to, or pass resume=False to discard it",
                    expected=side_fp, got=fp0,
                    directory=self._store.directory)
        template = self._template()
        try:
            state, key, rnd, msgs = ckpt.load(path, template)
        except (ckpt.CheckpointCorrupt, OSError):
            # The referenced entry is damaged/missing: the sidecar pair
            # is unusable as a unit — fresh start. (A ValueError —
            # treedef mismatch, i.e. a different protocol — propagates
            # as the caller error it is, like the shape check below.)
            self._clear_trail()
            return False
        # ckpt.load validates the treedef only, and MessageBatch is
        # all-array fields — a trail written at a DIFFERENT capacity or
        # graph size would load "successfully" with wrong shapes and
        # wedge the service later (host budget vs device lanes disagree,
        # shape errors mid-chunk). A config mismatch is a caller
        # error; silently discarding the trail would lose real tickets.
        for got, want in zip(_leaves(state), _leaves(template)):
            if got.shape != want.shape or got.dtype != want.dtype:
                raise ValueError(
                    f"checkpoint trail at {self._store.directory!r} was "
                    "written by a service with a different capacity or "
                    f"graph (stored leaf {tuple(got.shape)}/{got.dtype} vs "
                    f"configured {tuple(want.shape)}/{want.dtype}) — construct "
                    "with the same config, or pass resume=False to "
                    "discard the trail")
        self._batch = state
        self._base_key = key
        # Construction is single-threaded, but the control-plane state
        # restored here is lock-guarded everywhere else — keep the
        # discipline uniform rather than special-casing __init__.
        with self._cond:
            self._round = int(rnd)
            self._messages = int(msgs)
            self._tick = int(snap.get("tick", 0))
            self._next_ticket = int(snap.get("next_ticket", 0))
            self._queue = [str(t) for t in snap.get("queue", [])]
            self._lane_ticket = {int(k): str(v)
                                 for k, v in snap.get("lanes", {}).items()}
            # Merge, don't replace: tenants added to quotas AFTER the
            # trail was written must start at their configured burst
            # (absent from the snapshot), and restored levels never
            # exceed a since-shrunk burst.
            restored = {str(k): float(v)
                        for k, v in snap.get("buckets", {}).items()}
            buckets = {t: b for t, (_, b) in self._quotas.items()}
            for k, v in restored.items():
                buckets[k] = min(v, buckets[k]) if k in buckets else v
            self._buckets = buckets
            self._admit_budget = int(snap.get("admit_budget",
                                              self._admit_budget))
            self._counts.update({k: int(v)
                                 for k, v in snap.get("counts", {}).items()})
            self._done_order = [str(t) for t in snap.get("done_order", [])]
            self._latencies = [float(x) for x in snap.get("latencies", [])]
            self._tickets = {str(tid): dict(rec)
                             for tid, rec in snap.get("tickets", {}).items()}
            # graftdur: the seqno this pair covers — the journal-suffix
            # replay starts right past it (built by __init__ once the
            # journal is constructed).
            self._j_acked = int(snap.get("journal_seqno", 0))
            # Failover fencing: adopt the trail's epoch unless the
            # caller pinned one (promote() pins observed+1).
            if not self._epoch_pinned:
                self._epoch = int(snap.get("epoch", 0))
            running = dict(self._lane_ticket)
        # Lanes admitted in the checkpoint but not running (harvested
        # done / cancelled, not yet recycled when the checkpoint landed)
        # queue for the first tick's retire — zero lanes leak.
        _device.SYNCS += 1
        self._admitted = self._batch.admitted.cpu().numpy().copy()
        admitted = np.flatnonzero(self._admitted).tolist()
        self._retire_ready = [lane for lane in admitted
                              if lane not in running]
        return True

    # ---------------------------------------------------------------- HTTP

    def handle_http(self, method: str, path: str,
                    body: Optional[dict]) -> Optional[Tuple[int, dict]]:
        """The duck-typed httpd seam (telemetry/httpd.py): claim the
        serving endpoints, return ``None`` for everything else.

        - ``POST /submit`` (JSON body) or ``GET /submit?source=N`` —
          202 ``{"ticket", "status"}``, 429 with the structured reject
          on shed, 400 on caller errors, 503 when closed;
        - ``GET /poll/<ticket>`` — the record, or 404;
        - ``POST /cancel/<ticket>`` — ``{"cancelled": bool}``;
        - ``GET /stats`` — the :meth:`stats` document.
        """
        parsed = urllib.parse.urlparse(path)
        route = parsed.path.rstrip("/") or "/"
        if route == "/stats" and method == "GET":
            return 200, self.stats()
        if route == "/submit" and method in ("GET", "POST"):
            args: Dict[str, Any] = {}
            if method == "GET":
                q = urllib.parse.parse_qs(parsed.query)
                if "source" in q:
                    args["source"] = q["source"][0]
                if "target_coverage" in q:
                    args["target_coverage"] = q["target_coverage"][0]
                if "tenant" in q:
                    args["tenant"] = q["tenant"][0]
            else:
                args = dict(body or {})
            if "source" not in args:
                return 400, {"error": "submit needs a source node id"}
            try:
                tid = self.submit(
                    int(args["source"]),
                    target_coverage=float(
                        args.get("target_coverage", 0.99)),
                    tenant=str(args.get("tenant", "default")))
            except DurabilityLost as e:
                # Durability loss is a SERVER fault, not client load:
                # 503 (retry elsewhere / after repair), never a 429
                # back-off hint.
                return 503, e.to_dict()
            except Rejected as e:
                return 429, e.to_dict()
            except ServiceClosed as e:
                return 503, {"error": str(e)}
            except (TypeError, ValueError) as e:
                return 400, {"error": str(e)}
            return 202, {"ticket": tid, "status": "queued"}
        if route.startswith("/poll/") and method == "GET":
            rec = self.poll(route[len("/poll/"):])
            if rec is None:
                return 404, {"error": "unknown ticket"}
            return 200, rec
        if route.startswith("/cancel/") and method == "POST":
            try:
                ok = self.cancel(route[len("/cancel/"):])
            except DurabilityLost as e:
                return 503, e.to_dict()
            return 200, {"cancelled": ok}
        return None
