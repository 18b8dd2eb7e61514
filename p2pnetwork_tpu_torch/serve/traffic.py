"""Seeded open-loop traffic (the port's copy of
``p2pnetwork_tpu/serve/traffic.py``).

One PRNG seed becomes a complete open-loop arrival schedule: Poisson
arrivals whose rate follows a diurnal sinusoid with seeded burst ticks,
sources drawn from a Zipf-weighted hot-key set or uniformly from the
whole graph, tenants from the same stream. :func:`generate` draws from
one numpy ``default_rng(seed)`` stream in the reference's order, so its
schedule is byte-equal to the reference's (:meth:`TrafficSchedule.to_bytes`);
:func:`drive` feeds a :class:`~p2pnetwork_tpu_torch.serve.service.SimService`
one schedule tick per driver tick, consuming a resumed service's journal
replay positionally. Two fresh services driven with the same schedule
give identical ticket records, in either package.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from p2pnetwork_tpu_torch.serve.service import (TERMINAL_STATES,
                                           Rejected, SimService)

__all__ = ["TrafficPattern", "TrafficSchedule", "generate", "drive"]


def _consume_replay(service: SimService, t: int) -> Optional[dict]:
    """Consume the service's journal-replay suffix positionally for ONE
    arrival slot at schedule tick ``t`` (graftdur resume): records for
    later ticks stay queued; non-arrival intents (cancel/grow/delta)
    due here replay in passing; an arrival record (submit/shed) due
    here replays and returns — the drive then SKIPS the fresh
    submission, because the crashed life already acknowledged exactly
    this arrival (same ticket id, same position). ``None`` means the
    arrival was never acknowledged: submit it fresh, and the persisted
    ticket counter re-issues the id it would have gotten."""
    while True:
        head = service.replay_peek()
        if head is None or int(head.get("tick", 0)) > t:
            return None
        if head.get("kind") in ("submit", "shed"):
            return service.replay_next()
        service.replay_next()


@dataclasses.dataclass(frozen=True)
class TrafficPattern:
    """Shape of the open-loop workload (all knobs deterministic given
    the seed; rates are per driver TICK, not per wall-second — the
    service's control plane advances in ticks, so a schedule replays
    identically at any wall speed).

    ``rate`` is the mean Poisson arrivals per tick; ``diurnal_*`` put a
    sinusoidal day-cycle on it (amplitude 0 disables); ``burst_prob``
    ticks spike the rate by ``burst_mult`` (flash crowds);
    ``hot_fraction`` of arrivals draw their source from ``hot_keys``
    Zipf(``zipf_s``)-weighted hot nodes, the rest uniformly from the
    whole graph; ``tenants`` are assigned per arrival from the same
    stream (quota-testing traffic mixes)."""

    ticks: int = 64
    rate: float = 4.0
    hot_fraction: float = 0.5
    hot_keys: int = 8
    zipf_s: float = 1.1
    diurnal_amplitude: float = 0.0
    diurnal_period: float = 24.0
    burst_prob: float = 0.0
    burst_mult: float = 4.0
    tenants: Tuple[str, ...] = ("default",)
    coverage_target: float = 0.99

    def __post_init__(self):
        if self.ticks < 1:
            raise ValueError("ticks must be >= 1")
        if self.rate < 0:
            raise ValueError("rate must be >= 0")
        if not 0.0 <= self.hot_fraction <= 1.0:
            raise ValueError("hot_fraction must be in [0, 1]")
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1)")
        if not self.tenants:
            raise ValueError("need at least one tenant")
        if not 0.0 <= self.burst_prob <= 1.0:
            raise ValueError("burst_prob must be in [0, 1]")
        if self.burst_mult < 0:
            raise ValueError("burst_mult must be >= 0 "
                             "(< 1 models brownouts, > 1 flash crowds)")
        if self.zipf_s < 0:
            raise ValueError("zipf_s must be >= 0 (0 = uniform hot set)")
        if self.hot_keys < 1:
            raise ValueError("hot_keys must be >= 1")
        if self.diurnal_period <= 0:
            raise ValueError("diurnal_period must be > 0")
        if not 0.0 < self.coverage_target <= 1.0:
            # Validated here like every other knob: submit() would
            # reject it anyway, but only mid-drive after the service
            # already advanced — pattern construction is where a bad
            # workload should die.
            raise ValueError("coverage_target must be in (0, 1]")


@dataclasses.dataclass(frozen=True)
class TrafficSchedule:
    """A fully materialized arrival schedule: parallel arrays (one row
    per arrival, tick-ordered) plus the provenance that generated them."""

    pattern: TrafficPattern
    seed: int
    n_nodes: int
    tick: np.ndarray     # i32[arrivals], nondecreasing
    source: np.ndarray   # i32[arrivals]
    tenant: np.ndarray   # i32[arrivals] — index into pattern.tenants

    def __len__(self) -> int:
        return int(self.tick.size)

    @property
    def ticks(self) -> int:
        return self.pattern.ticks

    def arrivals_at(self, t: int) -> List[Tuple[int, str]]:
        """``[(source, tenant), ...]`` arriving at schedule tick ``t``."""
        idx = np.flatnonzero(self.tick == int(t))
        srcs = self.source[idx].tolist()
        tens = self.tenant[idx].tolist()
        return [(s, self.pattern.tenants[ti]) for s, ti in zip(srcs, tens)]

    def to_bytes(self) -> bytes:
        """Canonical serialization — the byte-identity witness the
        determinism tests compare (header JSON + the three arrays)."""
        header = json.dumps({
            "pattern": dataclasses.asdict(self.pattern),
            "seed": self.seed, "n_nodes": self.n_nodes,
            "arrivals": len(self),
        }, sort_keys=True).encode("utf-8")
        return b"\n".join([header, self.tick.tobytes(),
                           self.source.tobytes(), self.tenant.tobytes()])


def generate(pattern: TrafficPattern, n_nodes: int,
             seed: int = 0) -> TrafficSchedule:
    """Materialize the arrival schedule off ONE ``default_rng(seed)``
    stream (draw order is fixed: per tick — burst coin, count; per
    arrival — hot coin, source, tenant), so a run is byte-replayable."""
    if n_nodes < 1:
        raise ValueError("n_nodes must be >= 1")
    rng = np.random.default_rng(int(seed))
    n_hot = max(1, min(int(pattern.hot_keys), int(n_nodes)))
    hot_set = rng.choice(n_nodes, size=n_hot, replace=False).astype(np.int32)
    ranks = np.arange(1, n_hot + 1, dtype=np.float64)
    hot_w = ranks ** (-float(pattern.zipf_s))
    hot_w /= hot_w.sum()
    ticks: List[int] = []
    sources: List[int] = []
    tenants: List[int] = []
    n_tenants = len(pattern.tenants)
    for t in range(pattern.ticks):
        lam = pattern.rate * (1.0 + pattern.diurnal_amplitude * np.sin(
            2.0 * np.pi * t / max(pattern.diurnal_period, 1e-9)))
        if pattern.burst_prob > 0 and rng.random() < pattern.burst_prob:
            lam *= pattern.burst_mult
        count = int(rng.poisson(max(lam, 0.0)))
        for _ in range(count):
            if rng.random() < pattern.hot_fraction:
                src = int(hot_set[rng.choice(n_hot, p=hot_w)])
            else:
                src = int(rng.integers(0, n_nodes))
            ticks.append(t)
            sources.append(src)
            tenants.append(int(rng.integers(0, n_tenants)))
    return TrafficSchedule(
        pattern=pattern, seed=int(seed), n_nodes=int(n_nodes),
        tick=np.asarray(ticks, dtype=np.int32),
        source=np.asarray(sources, dtype=np.int32),
        tenant=np.asarray(tenants, dtype=np.int32))


def drive(service: SimService, schedule: TrafficSchedule, *,
          from_tick: Optional[int] = None, drain: bool = True,
          max_drain_ticks: int = 1024) -> Dict[str, object]:
    """Drive the service with the schedule, one schedule tick per
    driver tick, synchronously (the deterministic mode — the service's
    background thread must NOT be running).

    ``from_tick`` aligns a resumed service with the schedule: default
    ``service.tick_index``, so replaying the same schedule into a
    service restored from a checkpoint re-submits exactly the arrivals
    the killed run lost (ticket ids come from the service's persisted
    counter, so the re-submissions get the SAME ids). ``drain=True``
    keeps ticking (no new arrivals) until nothing is queued or running.

    Returns ``{"tickets": {tid: record}, "shed": [...], "submitted",
    "completed", "replayed", "drain_ticks", "peak_concurrent_lanes",
    "executed_rounds"}`` — every field deterministic for a given
    (schedule, service config). ``peak_concurrent_lanes`` is the most
    lanes in flight during any single engine chunk (the "sustains N
    concurrent lanes" number the bench and the acceptance soak
    publish)."""
    if service.driver_running:
        raise RuntimeError(
            "drive() needs exclusive control of the driver: the "
            "service's background thread is running (construct without "
            "start(), or close() it first) — concurrent ticks would "
            "race the driver-confined batch state")
    start = service.tick_index if from_tick is None else int(from_tick)
    submitted: List[str] = []
    pending: set = set()
    tickets: Dict[str, Optional[dict]] = {}
    shed: List[dict] = []
    peak = 0
    rounds = 0
    def _tick() -> None:
        # Harvest terminal records EVERY tick, not once at the end: a
        # run completing more tickets than the service's done_retention
        # would otherwise lose the oldest results to eviction before
        # the final poll (bench-scale drives routinely do).
        nonlocal peak, rounds
        info = service.tick()
        peak = max(peak, info["running"])
        rounds += info["executed_rounds"]
        # sorted: set iteration order is hash-randomized per process;
        # harvest order must not be. Poll only the PENDING ids — copying
        # the whole retained table every tick would be O(ticks x
        # done_retention) for records already harvested.
        for tid in sorted(pending):
            rec = service.poll(tid)
            if rec is not None and rec["status"] in TERMINAL_STATES:
                tickets[tid] = rec
                pending.discard(tid)

    replayed = 0
    for t in range(start, schedule.ticks):
        for source, tenant in schedule.arrivals_at(t):
            rec = _consume_replay(service, t)
            if rec is not None:
                # The crashed life acknowledged this arrival: its
                # journal record replayed in place of a fresh submit
                # (same ticket id), or its shed re-counted.
                replayed += 1
                if rec["kind"] == "submit":
                    tid = str(rec["ticket"])
                    submitted.append(tid)
                    pending.add(tid)
                else:
                    shed.append({"tick": t, "source": int(source),
                                 "tenant": tenant,
                                 "reason": str(rec.get("reason",
                                                       "replayed"))})
                continue
            try:
                tid = service.submit(
                    source,
                    target_coverage=schedule.pattern.coverage_target,
                    tenant=tenant)
                submitted.append(tid)
                pending.add(tid)
            except Rejected as e:
                shed.append({"tick": t, "source": int(source),
                             "tenant": tenant, "reason": e.reason})
        _tick()
    drained = 0
    while drain and service.busy() and drained < max_drain_ticks:
        _tick()
        drained += 1
    for tid in sorted(pending):  # never terminal (or evicted): last look
        tickets[tid] = service.poll(tid)
    completed = sum(1 for rec in tickets.values()
                    if rec is not None and rec["status"] == "done")
    return {"tickets": tickets, "shed": shed,
            "submitted": len(submitted), "completed": completed,
            "replayed": replayed,
            "drain_ticks": drained, "peak_concurrent_lanes": peak,
            "executed_rounds": rounds}
