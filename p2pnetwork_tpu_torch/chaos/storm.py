"""Churn storms: seeded join/leave/grow overlay churn as a workload (the
port's copy of ``p2pnetwork_tpu/chaos/storm.py``; the same schedule
bytes, events and drive results).

One PRNG seed materializes a complete churn schedule: capacity-only
grows (headroom pre-provisioning), join batches (grow plus an undirected
wiring delta attaching each joiner to seeded live peers), and leaves (a
delta removing every storm-added edge still incident to a departing
joiner). :func:`drive` runs a
:class:`~p2pnetwork_tpu_torch.serve.service.SimService` through it, one
schedule tick per driver tick, optionally interleaved with a traffic
schedule so tickets flow while the overlay churns.

Everything is a pure function of ``(pattern, n_nodes, seed)``: the
schedule serializes to bytes (:meth:`ChurnSchedule.to_bytes`), two
generations are byte-identical, and two fresh services driven with the
same storm and traffic give identical per-ticket records, which is what
makes a faulted-and-healed drive comparable with an unfaulted one.

Leaves are storm-scoped: a departing node sheds exactly the edges the
storm wired for it (the generator tracks them, so removals always name
live edges — ``apply_delta`` refuses phantom removals). Base-graph nodes
never leave. The generator speaks numpy; only :func:`drive` touches the
service.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from p2pnetwork_tpu_torch.serve.service import (TERMINAL_STATES,
                                           Rejected, SimService)
from p2pnetwork_tpu_torch.serve.traffic import TrafficSchedule
from p2pnetwork_tpu_torch.serve.traffic import _consume_replay
from p2pnetwork_tpu_torch.sim.graph import GraphDelta

__all__ = ["ChurnPattern", "ChurnSchedule", "generate", "drive"]

#: Event kinds in schedule-array code order.
EVENT_KINDS = ("grow", "join", "leave")
_KIND_CODE = {k: i for i, k in enumerate(EVENT_KINDS)}


def _replay_mutation(service: SimService, t: int, want_kind: str) -> bool:
    """Positional churn replay (journal resume): when the service's
    journal-replay suffix heads with exactly the mutation this storm
    event would queue (same kind, due at or before tick ``t``), replay
    that record instead of re-queueing a duplicate. The storm schedule
    is seed-deterministic, so records line up event-for-event with the
    re-driven schedule."""
    head = service.replay_peek()
    if (head is not None and int(head.get("tick", 0)) <= t
            and head.get("kind") == want_kind):
        service.replay_next()
        return True
    return False


@dataclasses.dataclass(frozen=True)
class ChurnPattern:
    """Shape of the churn storm (all knobs deterministic given the seed;
    probabilities are per driver TICK — the service's mutation plane
    drains its queue once per tick, so a schedule replays identically at
    any wall speed).

    ``join_prob`` ticks land a join event of ``join_batch`` new nodes,
    each wired undirected to ``fanout`` distinct live peers;
    ``leave_prob`` ticks depart one uniformly-chosen still-live joiner
    (no-op while none have joined); ``grow_prob`` ticks pre-provision
    ``grow_batch`` capacity-only nodes (no wiring — the repad headroom
    pattern)."""

    ticks: int = 32
    join_prob: float = 0.25
    join_batch: int = 4
    fanout: int = 2
    leave_prob: float = 0.1
    grow_prob: float = 0.0
    grow_batch: int = 8

    def __post_init__(self):
        if self.ticks < 1:
            raise ValueError("ticks must be >= 1")
        for name in ("join_prob", "leave_prob", "grow_prob"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if self.join_batch < 1:
            raise ValueError("join_batch must be >= 1")
        if self.fanout < 1:
            raise ValueError("fanout must be >= 1")
        if self.grow_batch < 1:
            raise ValueError("grow_batch must be >= 1")


@dataclasses.dataclass(frozen=True)
class ChurnSchedule:
    """A fully materialized churn schedule: an event table plus the edge
    rows each event adds or removes, all parallel numpy arrays (the
    traffic-schedule idiom), plus the provenance that generated them.

    ``ev_amount`` is the node count for grow/join events and the
    departing node id for leaves. ``edge_event`` maps each undirected
    edge pair ``(edge_a, edge_b)`` to its event row — adds for joins,
    removals for leaves."""

    pattern: ChurnPattern
    seed: int
    n_nodes: int             # base overlay size the storm was drawn for
    ev_tick: np.ndarray      # i32[events], nondecreasing
    ev_kind: np.ndarray      # i32[events] — index into EVENT_KINDS
    ev_amount: np.ndarray    # i32[events]
    edge_event: np.ndarray   # i32[pairs] — owning event row
    edge_a: np.ndarray       # i32[pairs]
    edge_b: np.ndarray       # i32[pairs]

    def __len__(self) -> int:
        return int(self.ev_tick.size)

    @property
    def ticks(self) -> int:
        return self.pattern.ticks

    @property
    def n_final(self) -> int:
        """Live node count after the whole storm lands on the base."""
        kinds = self.ev_kind
        added = self.ev_amount[(kinds == _KIND_CODE["grow"])
                               | (kinds == _KIND_CODE["join"])]
        return int(self.n_nodes + added.sum())

    def events_at(self, t: int) -> List[Tuple[str, int,
                                              Optional[GraphDelta]]]:
        """``[(kind, amount, delta), ...]`` landing at schedule tick
        ``t``, in draw order. ``delta`` is the join wiring / leave
        shedding batch (both directions — :meth:`GraphDelta.undirected`)
        and ``None`` for capacity-only grows."""
        out: List[Tuple[str, int, Optional[GraphDelta]]] = []
        for ev in np.flatnonzero(self.ev_tick == int(t)).tolist():
            kind = EVENT_KINDS[int(self.ev_kind[ev])]
            amount = int(self.ev_amount[ev])
            delta: Optional[GraphDelta] = None
            if kind != "grow":
                rows = np.flatnonzero(self.edge_event == ev)
                a, b = self.edge_a[rows], self.edge_b[rows]
                if kind == "join":
                    delta = GraphDelta.undirected(add_senders=a,
                                                  add_receivers=b)
                else:
                    delta = GraphDelta.undirected(remove_senders=a,
                                                  remove_receivers=b)
            out.append((kind, amount, delta))
        return out

    def to_bytes(self) -> bytes:
        """Canonical serialization — the byte-identity witness the
        determinism tests compare (header JSON + the six arrays)."""
        header = json.dumps({
            "pattern": dataclasses.asdict(self.pattern),
            "seed": self.seed, "n_nodes": self.n_nodes,
            "events": len(self), "pairs": int(self.edge_event.size),
        }, sort_keys=True).encode("utf-8")
        return b"\n".join([header, self.ev_tick.tobytes(),
                           self.ev_kind.tobytes(), self.ev_amount.tobytes(),
                           self.edge_event.tobytes(), self.edge_a.tobytes(),
                           self.edge_b.tobytes()])


def generate(pattern: ChurnPattern, n_nodes: int,
             seed: int = 0) -> ChurnSchedule:
    """Materialize the churn schedule off ONE ``default_rng(seed)``
    stream (draw order is fixed: per tick — grow coin, join coin, per
    joining node its fanout peer draws, leave coin + departing-node
    choice), so a storm is byte-replayable.

    The generator simulates the overlay's bookkeeping as it goes: join
    wiring targets are drawn from the CURRENT live set (base nodes plus
    joiners that have not left), and a leave removes exactly the
    still-live storm edges incident to the departer — so every delta the
    schedule emits is valid against the graph state the drive will have
    at that tick."""
    if n_nodes < 1:
        raise ValueError("n_nodes must be >= 1")
    rng = np.random.default_rng(int(seed))
    cur_n = int(n_nodes)
    live_joined: List[int] = []
    # Storm-added undirected pairs still live, keyed (lo, hi) -> True.
    live_edges: Dict[Tuple[int, int], bool] = {}
    ev_tick: List[int] = []
    ev_kind: List[int] = []
    ev_amount: List[int] = []
    edge_event: List[int] = []
    edge_a: List[int] = []
    edge_b: List[int] = []

    def _emit(t: int, kind: str, amount: int,
              pairs: List[Tuple[int, int]]) -> None:
        ev = len(ev_tick)
        ev_tick.append(t)
        ev_kind.append(_KIND_CODE[kind])
        ev_amount.append(amount)
        for a, b in pairs:
            edge_event.append(ev)
            edge_a.append(a)
            edge_b.append(b)

    for t in range(pattern.ticks):
        if pattern.grow_prob > 0 and rng.random() < pattern.grow_prob:
            _emit(t, "grow", pattern.grow_batch, [])
            cur_n += pattern.grow_batch
        if pattern.join_prob > 0 and rng.random() < pattern.join_prob:
            new = list(range(cur_n, cur_n + pattern.join_batch))
            live = np.concatenate([
                np.arange(n_nodes, dtype=np.int64),
                np.asarray(sorted(live_joined), dtype=np.int64)])
            pairs: List[Tuple[int, int]] = []
            for node in new:
                k = min(pattern.fanout, live.size)
                for peer in rng.choice(live, size=k,
                                       replace=False).tolist():
                    pair = (min(node, int(peer)), max(node, int(peer)))
                    if pair not in live_edges:
                        live_edges[pair] = True
                        pairs.append(pair)
            _emit(t, "join", pattern.join_batch, pairs)
            cur_n += pattern.join_batch
            live_joined.extend(new)
        if pattern.leave_prob > 0 and live_joined \
                and rng.random() < pattern.leave_prob:
            node = int(live_joined.pop(
                int(rng.integers(0, len(live_joined)))))
            shed = [p for p in live_edges if node in p]
            for p in shed:
                del live_edges[p]
            _emit(t, "leave", node, sorted(shed))
    return ChurnSchedule(
        pattern=pattern, seed=int(seed), n_nodes=int(n_nodes),
        ev_tick=np.asarray(ev_tick, dtype=np.int32),
        ev_kind=np.asarray(ev_kind, dtype=np.int32),
        ev_amount=np.asarray(ev_amount, dtype=np.int32),
        edge_event=np.asarray(edge_event, dtype=np.int32),
        edge_a=np.asarray(edge_a, dtype=np.int32),
        edge_b=np.asarray(edge_b, dtype=np.int32))


def drive(service: SimService, storm: ChurnSchedule, *,
          traffic: Optional[TrafficSchedule] = None,
          from_tick: Optional[int] = None, drain: bool = True,
          max_drain_ticks: int = 1024) -> Dict[str, object]:
    """Drive the service through the storm, one schedule tick per driver
    tick, synchronously (the deterministic mode — the service's
    background thread must NOT be running). Each tick queues that tick's
    churn events (``service.grow`` / ``service.apply_delta``; the
    mutation plane applies them atomically at the next tick's ``mutate``
    phase), submits the tick's traffic arrivals when a ``traffic``
    schedule rides along, then ticks.

    ``from_tick`` aligns a resumed service with the schedules (default
    ``service.tick_index`` — the traffic-drive resume contract); churn
    events before ``from_tick`` are assumed already in the resumed
    graph. Returns the traffic-drive result dict plus
    ``{"events": {kind: count}, "graph_nodes", "graph_capacity"}`` —
    every field deterministic for a given (storm, traffic, service
    config)."""
    if service.driver_running:
        raise RuntimeError(
            "drive() needs exclusive control of the driver: the "
            "service's background thread is running (construct without "
            "start(), or close() it first) — concurrent ticks would "
            "race the driver-confined batch state")
    if traffic is not None and traffic.ticks > storm.ticks:
        raise ValueError(
            f"traffic schedule runs {traffic.ticks} ticks but the storm "
            f"only {storm.ticks} — arrivals past the storm would be "
            "dropped silently; generate matching lengths")
    start = service.tick_index if from_tick is None else int(from_tick)
    pending: set = set()
    tickets: Dict[str, Optional[dict]] = {}
    shed: List[dict] = []
    events = {k: 0 for k in EVENT_KINDS}
    submitted = 0
    peak = 0
    rounds = 0

    def _tick() -> None:
        nonlocal peak, rounds
        info = service.tick()
        peak = max(peak, info["running"])
        rounds += info["executed_rounds"]
        for tid in sorted(pending):
            rec = service.poll(tid)
            if rec is not None and rec["status"] in TERMINAL_STATES:
                tickets[tid] = rec
                pending.discard(tid)

    replayed = 0
    for t in range(start, storm.ticks):
        for kind, amount, delta in storm.events_at(t):
            events[kind] += 1
            if kind in ("grow", "join"):
                if not _replay_mutation(service, t, "grow"):
                    service.grow(amount)
            if delta is not None:
                if not _replay_mutation(service, t, "delta"):
                    service.apply_delta(delta)
        if traffic is not None:
            for source, tenant in traffic.arrivals_at(t):
                rec = _consume_replay(service, t)
                if rec is not None:
                    replayed += 1
                    if rec["kind"] == "submit":
                        submitted += 1
                        pending.add(str(rec["ticket"]))
                    else:
                        shed.append({"tick": t, "source": int(source),
                                     "tenant": tenant,
                                     "reason": str(rec.get("reason",
                                                           "replayed"))})
                    continue
                try:
                    tid = service.submit(
                        source,
                        target_coverage=traffic.pattern.coverage_target,
                        tenant=tenant)
                    submitted += 1
                    pending.add(tid)
                except Rejected as e:
                    shed.append({"tick": t, "source": int(source),
                                 "tenant": tenant, "reason": e.reason})
        _tick()
    drained = 0
    while drain and service.busy() and drained < max_drain_ticks:
        _tick()
        drained += 1
    for tid in sorted(pending):
        tickets[tid] = service.poll(tid)
    completed = sum(1 for rec in tickets.values()
                    if rec is not None and rec["status"] == "done")
    return {"tickets": tickets, "shed": shed, "submitted": submitted,
            "completed": completed, "replayed": replayed,
            "drain_ticks": drained,
            "peak_concurrent_lanes": peak, "executed_rounds": rounds,
            "events": events,
            "graph_nodes": int(service.graph.n_nodes),
            "graph_capacity": int(service.graph.n_nodes_padded)}
