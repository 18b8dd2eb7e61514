"""Round engine (torch counterpart of ``p2pnetwork_tpu/sim/engine.py``):
``run`` / ``run_from`` (a fixed number of rounds, per-round stats
stacked), ``run_until_coverage`` / ``run_until_coverage_from`` and
``run_until_converged``, with the reference's signatures (the key after
the protocol) and its key chain: ``run`` hands round ``r`` the key
``split(fold_in(key, 1), rounds)[r]``; the early-exit loops take
``k, sub = split(k)`` before every step. Keys are host words
(``prng.py``), so the chain costs no device work and no sync.

The reference runs the early-exit loop as one ``lax.while_loop`` on the
device. PyTorch has no device-side loop, so the port runs super-steps of
``steps_per_round = T`` protocol steps and reads the exit flag on the host
once per super-step (one sync, counted in ``_device.SYNCS``), then the
run's summary in one more counted transfer. Inside a
super-step the reference's freeze rule holds: each sub-step re-evaluates
the predicate and applies its step only while it holds, and the key chain
advances on frozen sub-steps too, so any ``T`` gives results bit-identical
to ``T = 1``.

The counters follow the reference's arithmetic: the tracked stat and the
running occupancy sum are f32, the stop test compares in f32, the
occupancy mean is the f32 sum divided by the round count. Messages
accumulate exactly in int64 (the reference's two-limb counter holds the
same range).

The batched planes (``run_batch_until_coverage`` for ``BatchFlood``,
``run_queries_until_done`` for the query families) read one exit flag a
round (any lane still running) and hand the whole per-lane summary back in
one device->host transfer (``utils/accum.py``), both counted in
``_device.SYNCS``.

Every run-to-* loop reports its summary to the telemetry plane as the
reference's does, under the reference's metric names and ``loop`` labels
(``coverage``, ``coverage_from``, ``converged``, ``batch``, ``query``):
runs, rounds, exact messages, wall and transfer seconds, the frontier
occupancy histogram, the batch and query gauges and completion
histograms; then one sample of the history ring. The values come from the
summary the loop already transfers, so telemetry adds no host read. With
a tracer installed (``telemetry/spans.py``) the batched loops run under a
``batch_run`` / ``query_run`` span with per-lane ``lane_admit`` /
``lane_resume`` / ``lane_complete`` / ``lane_freeze`` events (and a
``batch_summary`` event); their entry snapshot of the lanes' flags and
rounds is one more transfer, counted in ``_device.SYNCS``.

``run_from``, ``run_until_coverage_from`` and
``run_batch_until_coverage`` open with the reference's chunk-dispatch
gate (``chaos/device.dispatch_gate``, loops ``engine-rounds``,
``engine-coverage`` and ``engine-batch``): an installed
``DispatchChaos`` raises its armed fault there, before the call reads
its input.

``recorder=`` (a ``sim/flightrec.py`` ``FlightRecorder``) on ``run`` /
``run_from``, ``run_until_coverage_from`` and the two batched loops keeps
a per-round ring on the device, one row per applied round (a frozen
sub-step writes none), with the reference's columns for each loop. Its
rows make no host read and no host -> device copy; its one fetch at the
end counts in ``_device.SYNCS``. The results are bit-identical to a run
without it.

Every entry point takes a rank's part of a graph (``parallel/auto.py``'s
auto path across ranks) only for a protocol that says it runs there
(``RUNS_ON_PART``: every protocol of ``models/``, the batched flood and
the query families among them). Any other protocol, such as a user's
own, may read edge arrays or the neighbor table past the op layer,
which on a part would see the rank's edges alone, so it is refused by
name.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from p2pnetwork_tpu_torch import _device, concurrency, prng, telemetry
from p2pnetwork_tpu_torch.chaos import device as chaos_device
from p2pnetwork_tpu_torch.ops import bitset
from p2pnetwork_tpu_torch.ops import threefry as TF
from p2pnetwork_tpu_torch.sim import flightrec
from p2pnetwork_tpu_torch.sim.graph import Graph, part_of
from p2pnetwork_tpu_torch.telemetry import history, spans
from p2pnetwork_tpu_torch.utils import accum

#: Occupancy is a fraction of live nodes in [0, 1]; geometric buckets from
#: ~0.1% up resolve the sparse tail.
_OCCUPANCY_BUCKETS = telemetry.exponential_buckets(1 / 1024, 2.0, 11)
#: Cardinality bound for sim_frontier_occupancy's (loop, protocol) children.
_OCCUPANCY_MAX_CHILDREN = 16
#: Recency order of observed (loop, protocol) pairs: pruning evicts the
#: least recently observed child. Guarded by its own lock: summaries are
#: recorded from whatever thread finished the run.
_occupancy_recency: dict = {}
_occupancy_lock = concurrency.lock()
#: Batched completion rounds, 1 .. 2048.
_COMPLETION_BUCKETS = telemetry.exponential_buckets(1.0, 2.0, 12)


def _observe_occupancy(loop: str, protocol_name: str, value: float) -> None:
    """Record one run's mean per-round frontier occupancy, pruning the
    least-recently-observed labeled children past the cardinality bound."""
    hist = telemetry.default_registry().histogram(
        "sim_frontier_occupancy",
        "Mean per-round frontier occupancy (active fraction of live nodes) "
        "per run-to-* invocation.",
        ("loop", "protocol"), buckets=_OCCUPANCY_BUCKETS)
    key = (loop, protocol_name)
    with _occupancy_lock:
        # Observe inside the lock: a concurrent prune must not evict this
        # child between the observation and its re-insert.
        hist.labels(*key).observe(value)  # graftlint: ignore[lock-open-call] -- must be atomic with the recency re-insert (comment above); metric locks never take this one
        _occupancy_recency.pop(key, None)
        _occupancy_recency[key] = None
        live = {c.labels for c in hist.children()}  # graftlint: ignore[lock-open-call] -- same atomicity; children() is a leaf lock
        for stale in [k for k in _occupancy_recency if k not in live]:
            del _occupancy_recency[stale]
        while len(_occupancy_recency) > _OCCUPANCY_MAX_CHILDREN:
            coldest = next(iter(_occupancy_recency))
            del _occupancy_recency[coldest]
            hist.remove(*coldest)


def _record_run_summary(loop: str, wall_s: float, transfer_s: float,
                        transfer_bytes: int, out: dict,
                        protocol_name: str = "") -> None:
    """Report one host-side run summary to the registry, after its
    transfer (the reference's metric names, help strings and labels)."""
    reg = telemetry.default_registry()
    reg.counter("sim_runs_total", "Completed run-to-* loop invocations.",
                ("loop",)).labels(loop).inc()
    reg.counter("sim_rounds_total", "Protocol rounds executed on device.",
                ("loop",)).labels(loop).inc(float(out["rounds"]))
    reg.counter("sim_messages_total",
                "Messages moved by protocol rounds (exact two-limb totals).",
                ("loop",)).labels(loop).inc(float(out["messages"]))
    reg.histogram("sim_run_seconds",
                  "Wall seconds per run-to-* invocation (dispatch through "
                  "summary transfer).", ("loop",)).labels(loop).observe(wall_s)
    reg.counter("sim_transfer_seconds_total",
                "Seconds blocked on device->host summary transfers (includes "
                "waiting out the device program on async backends)."
                ).inc(transfer_s)
    reg.counter("sim_transfer_bytes_total",
                "Bytes moved by device->host summary transfers."
                ).inc(transfer_bytes)
    if loop.startswith("coverage") and "coverage" in out:
        reg.gauge("sim_last_coverage", "Coverage reached by the most recent "
                  "run-to-coverage loop.", ("loop",)).labels(loop).set(
                      float(out["coverage"]))
    if "frontier_occupancy_mean" in out:
        _observe_occupancy(loop, protocol_name,
                           float(out["frontier_occupancy_mean"]))


def _nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors
               if x is not None)


def _require_stats(protocol, required) -> None:
    missing = [r for r in required if r not in protocol.STATS]
    if missing:
        raise ValueError(f"{type(protocol).__name__} exposes stats "
                         f"{sorted(protocol.STATS)}; this loop needs "
                         f"{sorted(missing)}")


def _require_runs_on_part(graph: Graph, protocol) -> None:
    if part_of(graph) is not None and not getattr(protocol, "RUNS_ON_PART",
                                                  False):
        raise NotImplementedError(
            f"{type(protocol).__name__} on a rank's part: it does not set "
            f"RUNS_ON_PART, so it may read the edge arrays or the neighbor "
            f"table past the op layer, where a part holds the rank's edges "
            f"alone")


def _freeze(live: torch.Tensor, new, old):
    """``new`` where ``live`` holds, else ``old``, field by field (a
    tensor, a tuple of states, or a dataclass of tensors)."""
    if isinstance(old, torch.Tensor):
        return torch.where(live, new, old)
    if isinstance(old, tuple):
        return tuple(_freeze(live, n, o) for n, o in zip(new, old))
    return dataclasses.replace(old, **{
        f.name: torch.where(live, getattr(new, f.name), getattr(old, f.name))
        for f in dataclasses.fields(old)})


def _stat_while(graph: Graph, protocol, state, key, *, stat: str,
                keep_going, value0, loop: str, value_name: str = "value",
                steps_per_round: int = 1, ring=None, row_of=None):
    """Run protocol rounds while ``keep_going(value, rounds)`` holds, where
    ``value`` is the last round's ``stats[stat]`` (``value0`` before any).
    Returns ``(state, summary dict)`` with ``rounds``, ``value_name``
    (the last value) and ``messages`` (and ``frontier_occupancy_mean``
    for the flood family), and reports the summary to the registry and
    the history ring under ``loop``. ``ring`` (a flight-recorder ring)
    gets a row per applied round: the tracked stat in the ``coverage``
    column, the running total through ``flightrec.total_f32``; the
    summary then carries ``flight_record``. ``row_of(stats, messages)``,
    when given, supplies the row's columns in their place (the ring's
    flood records its own)."""
    t0 = time.perf_counter()
    T = int(steps_per_round)
    if T < 1:
        raise ValueError(f"steps_per_round must be >= 1, got {T}")
    dev = graph.device
    rounds = torch.zeros((), dtype=torch.int32, device=dev)
    value = torch.as_tensor(value0, dtype=torch.float32).to(dev)
    messages = torch.zeros((), dtype=torch.int64, device=dev)
    occ = torch.zeros((), dtype=torch.float32, device=dev)
    has_occ = "frontier_occupancy" in protocol.STATS
    if ring is not None:
        one, zero = ring.new_ones(()), ring.new_zeros(())

    # Rounds applied before this super-step: every earlier super-step ran
    # all T sub-steps (a frozen one would have ended the loop), so the
    # recorder's round index is known on the host.
    applied = 0
    while _device.host_bool(keep_going(value, rounds)):
        for j in range(T):
            live = keep_going(value, rounds)
            key, sub = prng.split(key)
            new_state, stats = protocol.step(graph, state, sub)
            state = _freeze(live, new_state, state)
            # The step's own output is frozen into `state`: a live binding
            # would pin a second carry through the next step.
            del new_state
            # An f32 count (Bracha's) truncates, as the reference's cast
            # to its u32 limb does.
            messages = messages + torch.where(
                live, stats["messages"], 0).to(torch.int64)
            if ring is not None and row_of is not None:
                flightrec.write_row(ring, applied + j, live=live,
                                    **row_of(stats, messages))
            elif ring is not None:
                flightrec.write_row(
                    ring, applied + j, live=live,
                    occupancy=stats.get("frontier_occupancy", zero),
                    new=stats["messages"],
                    total=flightrec.total_f32(*flightrec.limbs(messages)),
                    coverage=stats[stat], active_lanes=one, ici_bytes=zero)
            rounds = rounds + live.to(torch.int32)
            value = torch.where(live, stats[stat].to(torch.float32), value)
            if has_occ:
                occ = occ + torch.where(live, stats["frontier_occupancy"],
                                        0.0)
        applied += T
    occ_mean = occ / rounds.clamp_min(1).to(torch.float32)
    t1 = time.perf_counter()
    # The summary in one counted transfer: the two f32s by their bits.
    with _device.counted_syncs():
        n_rounds, n_messages, value, occ_mean = torch.stack(
            [rounds.to(torch.int64), messages,
             value.to(torch.float32).view(torch.int32).to(torch.int64),
             occ_mean.view(torch.int32).to(torch.int64)]).tolist()
    value, occ_mean = np.array([value, occ_mean], dtype=np.int64).astype(
        np.int32).view(np.float32).tolist()
    out = {"rounds": n_rounds, value_name: value, "messages": n_messages}
    if has_occ:
        out["frontier_occupancy_mean"] = occ_mean
    if ring is not None:
        out["flight_record"] = flightrec.trim(ring, n_rounds)
    t2 = time.perf_counter()
    _record_run_summary(loop, t2 - t0, t2 - t1, 24 + _nbytes(ring), out,
                        type(protocol).__name__)
    history.default_history().sample()
    return state, out


def run(graph: Graph, protocol, key, rounds: int, *, recorder=None):
    """Run ``rounds`` rounds from ``protocol.init(graph, key)``. Returns
    ``(final_state, stats)``, each stat stacked to ``[rounds]`` as the
    reference's ``lax.scan`` stacks it, and a ``FlightRecord`` third with
    a ``recorder`` (see :func:`run_from`)."""
    _require_runs_on_part(graph, protocol)
    return _run_from(graph, protocol, protocol.init(graph, key), key,
                     rounds, recorder)


def run_from(graph: Graph, protocol, state, key, rounds: int, *,
             recorder=None):
    """Run ``rounds`` rounds continuing from ``state``, round ``r`` with
    the key ``split(fold_in(key, 1), rounds)[r]``. Returns
    ``(final_state, stats)`` with every stat a ``[rounds]`` tensor on the
    host, fetched in one transfer at the end (the rounds themselves make
    no host read of their own; a protocol's branch reads, as
    ``AdaptiveFlood``'s, still count in ``_device.SYNCS``).

    ``state`` is not modified: torch has no buffer donation, so the
    reference's ``donate`` has no counterpart here. With ``recorder`` (a
    ``FlightRecorder``) each round also writes a ring row (the reference's
    scan form: the ``total`` column is a running f32 sum of ``messages``)
    and the return is ``(final_state, stats, FlightRecord)``."""
    _require_runs_on_part(graph, protocol)
    chaos_device.dispatch_gate("engine-rounds")
    return _run_from(graph, protocol, state, key, rounds, recorder)


def _run_from(graph: Graph, protocol, state, key, rounds: int, recorder):
    rounds = int(rounds)
    keys = prng.split(prng.fold_in(key, 1), rounds)
    ring = None if recorder is None else recorder.init(graph.device)
    if ring is not None:
        one, zero = ring.new_ones(()), ring.new_zeros(())
        total = zero
    per_round = []
    for r in range(rounds):
        state, stats = protocol.step(graph, state, keys[r])
        per_round.append(stats)
        if ring is not None:
            new = stats.get("messages", zero).to(torch.float32)
            total = total + new
            flightrec.write_row(
                ring, r, occupancy=stats.get("frontier_occupancy", zero),
                new=new, total=total, coverage=stats.get("coverage", zero),
                active_lanes=one, ici_bytes=zero)
    out = _stack_stats(per_round)
    if ring is None:
        return state, out
    return state, out, flightrec.trim(ring, rounds)


def _stack_stats(per_round) -> dict:
    """Every stat of every round as ``[rounds]`` host tensors, in one
    device -> host transfer."""
    if not per_round:
        return {}
    names = list(per_round[0])
    # One device -> host transfer: every stat of every round, as f64
    # (exact for the i32/i64 counts and the f32 ratios alike).
    table = torch.stack([torch.stack([s[n].to(torch.float64)
                                      for n in names])
                         for s in per_round]).cpu()
    out = {}
    for i, n in enumerate(names):
        dtype = per_round[0][n].dtype
        out[n] = table[:, i].to(torch.float32 if dtype.is_floating_point
                                else torch.int64)
    return out


def run_until_coverage(graph: Graph, protocol, key, *,
                       coverage_target: float = 0.99, max_rounds: int = 1024,
                       steps_per_round: int = 1):
    """Run from ``protocol.init(graph, key)`` until ``stats['coverage'] >=
    coverage_target`` (or ``max_rounds``), the loop's key chain starting
    from ``key`` too. Returns ``(final_state, dict)`` with ``rounds``,
    ``coverage``, ``messages`` (exact int) and, for the flood family,
    ``frontier_occupancy_mean`` — the reference's dict."""
    _require_runs_on_part(graph, protocol)
    return _coverage_from(
        graph, protocol, protocol.init(graph, key), key, "coverage",
        coverage_target=coverage_target, max_rounds=max_rounds,
        steps_per_round=steps_per_round)


def run_until_coverage_from(graph: Graph, protocol, state0, key, *,
                            coverage_target: float = 0.99,
                            max_rounds: int = 1024,
                            steps_per_round: int = 1, recorder=None,
                            row_of=None):
    """Run-to-coverage continuing from ``state0`` (not modified). The loop
    starts from ``state0``'s true coverage where the protocol can say it,
    so resuming a finished run executes zero rounds. ``recorder`` (a
    ``FlightRecorder``) adds ``out["flight_record"]``, one row per applied
    round at any ``steps_per_round``; ``row_of`` as in
    :func:`_stat_while`."""
    _require_runs_on_part(graph, protocol)
    chaos_device.dispatch_gate("engine-coverage")
    return _coverage_from(graph, protocol, state0, key, "coverage_from",
                          coverage_target=coverage_target,
                          max_rounds=max_rounds,
                          steps_per_round=steps_per_round,
                          recorder=recorder, row_of=row_of)


def _coverage_from(graph: Graph, protocol, state0, key, loop: str, *,
                   coverage_target: float, max_rounds: int,
                   steps_per_round: int, recorder=None, row_of=None):
    _require_stats(protocol, ("coverage", "messages"))
    target = torch.tensor(coverage_target, dtype=torch.float32,
                          device=graph.device)
    cov0 = (protocol.coverage(graph, state0)
            if hasattr(protocol, "coverage") else 0.0)
    state, out = _stat_while(
        graph, protocol, state0, key, stat="coverage",
        keep_going=lambda v, r: (v < target) & (r < max_rounds),
        value0=cov0, loop=loop, value_name="coverage",
        steps_per_round=steps_per_round,
        ring=None if recorder is None else recorder.init(graph.device),
        row_of=row_of)
    return state, out


def run_until_converged(graph: Graph, protocol, key, *, stat: str,
                        threshold: float, max_rounds: int = 1024,
                        state0=None, steps_per_round: int = 1):
    """Run until the scalar ``stats[stat]`` drops below ``threshold`` (or
    ``max_rounds``): PageRank to a residual, push-sum or gossip to a
    variance. Starts from ``state0``, or from ``protocol.init(graph, key)``
    when it is None. Returns ``(state, dict(rounds, value, messages))``
    where ``value`` is the stat after the final round (inf if no round
    ran) and ``messages`` an exact int; the test ``value >= threshold``
    is made in f32, as the reference's."""
    _require_runs_on_part(graph, protocol)
    _require_stats(protocol, (stat, "messages"))
    if state0 is None:
        state0 = protocol.init(graph, key)
    thr = torch.tensor(threshold, dtype=torch.float32, device=graph.device)
    state, out = _stat_while(
        graph, protocol, state0, key, stat=stat,
        keep_going=lambda v, r: (v >= thr) & (r < max_rounds),
        value0=float("inf"), loop="converged",
        steps_per_round=steps_per_round)
    return state, out


# ------------------------------------------------------------ batched planes


def _lane_loop(graph: Graph, protocol, batch, key, max_rounds: int,
               messages_of, add_occupancy, ring=None, row_of=None):
    """Step every running lane until none runs or ``max_rounds`` global
    rounds pass: one host read of the exit flag a round, the reference's
    key chain (``k, sub = split(k)`` before each step). Returns the batch,
    the rounds (i32), the exact messages (i64) and the occupancy sum
    (f32), all on the device. With ``ring``, ``row_of(batch, stats,
    messages)`` gives each round's flight-recorder columns."""
    dev = graph.device
    messages = torch.zeros((), dtype=torch.int64, device=dev)
    occ = torch.zeros((), dtype=torch.float32, device=dev)
    zero = None if ring is None else ring.new_zeros(())
    r = 0
    while r < max_rounds and _device.host_bool(
            (batch.admitted & ~batch.done).any()):
        key, sub = prng.split(key)
        batch, stats = protocol.step(graph, batch, sub)
        messages = messages + messages_of(stats)
        occ = add_occupancy(occ, batch, stats)
        if ring is not None:
            flightrec.write_row(ring, r, ici_bytes=zero,
                                **row_of(batch, stats, messages))
        r += 1
    return batch, torch.tensor(r, dtype=torch.int32, device=dev), \
        messages, occ


def _summary(packed: torch.Tensor, done0: torch.Tensor):
    """The packed summary and the pre-run ``done`` words in one transfer
    (one sync); returns both on the host."""
    with _device.counted_syncs():
        host = torch.cat([packed, bitset.pack_bits(done0)]).cpu().numpy()
    n = packed.shape[0]
    bits = (host[n:].view(np.uint32)[:, None]
            >> np.arange(bitset.WORD, dtype=np.uint32)) & 1
    return host[:n], bits.reshape(-1).astype(bool)[:done0.shape[0]]


def _newly_completed(out: dict, done0: np.ndarray) -> np.ndarray:
    """``newly_completed_lanes`` and, when any, the completion-round
    percentiles over them (numpy's, as the reference computes them).
    Returns those lanes' round counts."""
    newly = out["lane_done"] & ~done0
    out["newly_completed_lanes"] = np.flatnonzero(newly).astype(np.int32)
    newly_rounds = out["lane_rounds"][newly]
    if newly_rounds.size:
        out["completion_rounds_p50"] = float(np.percentile(newly_rounds, 50))
        out["completion_rounds_p99"] = float(np.percentile(newly_rounds, 99))
    return newly_rounds


def _lane_snapshot(batch):
    """The lanes' ``admitted``, ``done`` and ``rounds`` on the host, in one
    counted transfer (the trace plane's entry snapshot)."""
    with _device.counted_syncs():
        host = torch.stack([batch.admitted.to(torch.int32),
                            batch.done.to(torch.int32), batch.rounds]).cpu()
    host = host.numpy()
    return host[0].astype(bool), host[1].astype(bool), host[2]


def _emit_batch_entry_events(admitted0, done0, rounds0) -> None:
    """Per-lane events at a batched run's entry: ``lane_admit`` for lanes
    this run advances for the first time, ``lane_resume`` for lanes
    resuming from an earlier call."""
    running = admitted0 & ~done0
    for lane in np.flatnonzero(running & (rounds0 == 0)).tolist():
        spans.emit("lane_admit", lane=lane)
    for lane in np.flatnonzero(running & (rounds0 > 0)).tolist():
        spans.emit("lane_resume", lane=lane)


def _emit_batch_exit_events(admitted0, done0, out) -> None:
    """Per-lane events at a batched run's exit: ``lane_complete`` for
    lanes that reached target in this call (with their cumulative round
    count), ``lane_freeze`` for running lanes still unfinished."""
    lane_done = out["lane_done"]
    newly = np.flatnonzero(lane_done & ~done0)
    rounds = out["lane_rounds"][newly]
    for lane, r in zip(newly.tolist(), rounds.tolist()):
        spans.emit("lane_complete", lane=lane, rounds=r)
    frozen = np.flatnonzero(admitted0 & ~done0 & ~lane_done)
    for lane in frozen.tolist():
        spans.emit("lane_freeze", lane=lane)


def _record_batch_summary(wall_s: float, transfer_s: float,
                          transfer_bytes: int, out: dict,
                          newly_done_rounds, protocol_name: str) -> None:
    """The shared run counters under ``loop="batch"``, then the batch
    plane's own instruments: ``sim_batch_active_lanes`` and one
    ``sim_batch_completion_rounds`` observation per lane completed in
    this call; then one history sample."""
    _record_run_summary("batch", wall_s, transfer_s, transfer_bytes, out,
                        protocol_name)
    reg = telemetry.default_registry()
    reg.gauge("sim_batch_active_lanes",
              "Lanes still running (admitted, not at target) when the last "
              "batched loop returned — nonzero means max_rounds froze "
              "stragglers.").set(float(out["active_lanes"]))
    hist = reg.histogram(
        "sim_batch_completion_rounds",
        "Rounds each batched message took to reach its coverage target "
        "(one observation per lane completed in a "
        "run_batch_until_coverage call).", buckets=_COMPLETION_BUCKETS)
    for r in newly_done_rounds.tolist():
        hist.observe(r)
    _observe_occupancy("batch", protocol_name,
                       float(out["occupancy_mean"]))
    history.default_history().sample()


def _record_query_summary(wall_s: float, transfer_s: float,
                          transfer_bytes: int, out: dict,
                          newly_done_rounds, protocol_name: str) -> None:
    """The shared run counters under ``loop="query"``, then
    ``sim_query_active_lanes`` and one ``sim_query_completion_rounds``
    observation per lane settled in this call; then one history
    sample."""
    _record_run_summary("query", wall_s, transfer_s, transfer_bytes, out,
                        protocol_name)
    reg = telemetry.default_registry()
    reg.gauge("sim_query_active_lanes",
              "Query lanes still running (admitted, not settled) when "
              "the last run_queries_until_done call returned — nonzero "
              "means max_rounds froze stragglers.").set(
                  float(out["active_lanes"]))
    hist = reg.histogram(
        "sim_query_completion_rounds",
        "Rounds each batched query took to settle (one observation per "
        "lane completed in a run_queries_until_done call).",
        buckets=_COMPLETION_BUCKETS)
    for r in newly_done_rounds.tolist():
        hist.observe(r)
    history.default_history().sample()


def run_batch_until_coverage(graph: Graph, protocol, batch, key, *,
                             max_rounds: int = 1024, donate: bool = True,
                             recorder=None):
    """Advance every in-flight message of a lane-packed batch
    (``models/messagebatch.py``) until each admitted lane reaches its
    coverage target, or ``max_rounds`` global rounds pass. The batch is
    refreshed against the current graph first (``BatchFlood.refresh``).

    Returns ``(batch, out)``: ``rounds`` (global rounds of this call),
    ``messages`` (exact), ``active_lanes``, ``completed``,
    ``occupancy_mean`` (mean union-frontier occupancy), the per-lane
    ``lane_done`` and ``lane_rounds`` (cumulative over calls),
    ``newly_completed_lanes`` and, when any lane completed in this call,
    ``completion_rounds_p50``/``p99`` over those lanes — the reference's
    dict. ``donate`` is accepted and has no effect: ``batch`` is not
    modified (torch has no buffer donation; see :func:`run_from`). With
    ``recorder`` (a ``FlightRecorder``) each global round writes a ring
    row (union-frontier occupancy, the round's sends, the running total,
    the lanes' seen counts summed, the running lanes) and ``out`` carries
    ``flight_record``. With a tracer installed the call runs under a
    ``batch_run`` span with the per-lane events (module doc)."""
    # An armed fault raises before the batch is read, so a healing retry
    # re-dispatches an intact input.
    _require_runs_on_part(graph, protocol)
    chaos_device.dispatch_gate("engine-batch")
    t0 = time.perf_counter()
    tracer = spans.current_tracer()
    with spans.span("batch_run", loop="engine", max_rounds=max_rounds):
        if tracer is not None:
            snap = _lane_snapshot(batch)
            _emit_batch_entry_events(*snap)
        batch, out, newly_rounds, t1, nbytes = _batch_until_coverage(
            graph, protocol, batch, key, max_rounds, recorder)
        t2 = time.perf_counter()
        if tracer is not None:
            _emit_batch_exit_events(snap[0], snap[1], out)
            spans.emit("batch_summary", rounds=int(out["rounds"]),
                       completed=int(out["completed"]),
                       active_lanes=int(out["active_lanes"]),
                       newly_completed=int(
                           out["newly_completed_lanes"].size))
        _record_batch_summary(t2 - t0, t2 - t1, nbytes, out, newly_rounds,
                              type(protocol).__name__)
    return batch, out


def _batch_until_coverage(graph: Graph, protocol, batch, key,
                          max_rounds: int, recorder):
    done0 = batch.done.clone()
    batch = protocol.refresh(graph, batch)
    ring = None if recorder is None else recorder.init(graph.device)

    def row(b, st, messages):
        # f32 sums in XLA's order: the seen counts pass 2^24 at scale.
        return dict(
            occupancy=st["batch_occupancy"],
            new=accum.ordered_sum(st["messages_words"].to(torch.float32)),
            total=flightrec.total_f32(*flightrec.limbs(messages)),
            coverage=accum.ordered_sum(b.seen_count.to(torch.float32)),
            active_lanes=st["active_lanes"])

    batch, rounds, messages, occ = _lane_loop(
        graph, protocol, batch, key, max_rounds,
        lambda st: st["messages_words"].sum(),
        lambda occ, b, st: occ + st["batch_occupancy"], ring, row)
    packed = accum.pack_batch_summary(
        rounds, (batch.admitted & ~batch.done).sum(), batch.done.sum(),
        messages, occ / rounds.clamp_min(1).to(torch.float32),
        bitset.pack_bits(batch.done), batch.rounds)
    t1 = time.perf_counter()
    host, done0 = _summary(packed, done0)
    out = accum.unpack_batch_summary(host, batch.n_words)
    newly_rounds = _newly_completed(out, done0)
    if ring is not None:
        out["flight_record"] = flightrec.trim(ring, out["rounds"])
    nbytes = _nbytes(packed, ring) + 4 * bitset.n_words(done0.shape[0])
    return batch, out, newly_rounds, t1, nbytes


def run_queries_until_done(graph: Graph, protocol, batch, key, *,
                           max_rounds: int = 1024, donate: bool = True,
                           recorder=None):
    """Advance every in-flight query of a lane-packed ``QueryBatch``
    (``models/querybatch.py``: ``MinPlusQueries``, ``DhtLookups``,
    ``PushSumQueries``) until each admitted lane settles, or
    ``max_rounds`` global rounds pass. ``occupancy_mean`` is the mean
    running-lane fraction; ``lane_values`` carries each lane's answer (f32
    or i32 per family); the rest as :func:`run_batch_until_coverage`,
    whose ``donate`` and ``recorder`` rules hold here too (the ring's row:
    the running-lane fraction, the round's sends, the running total, the
    finished lanes, the running lanes). With a tracer installed the call
    runs under a ``query_run`` span with the per-lane events."""
    _require_runs_on_part(graph, protocol)
    t0 = time.perf_counter()
    tracer = spans.current_tracer()
    with spans.span("query_run", loop="engine", max_rounds=max_rounds):
        if tracer is not None:
            snap = _lane_snapshot(batch)
            _emit_batch_entry_events(*snap)
        batch, out, newly_rounds, t1, nbytes = _queries_until_done(
            graph, protocol, batch, key, max_rounds, recorder)
        t2 = time.perf_counter()
        if tracer is not None:
            _emit_batch_exit_events(snap[0], snap[1], out)
        _record_query_summary(t2 - t0, t2 - t1, nbytes, out, newly_rounds,
                              type(protocol).__name__)
    return batch, out


def _queries_until_done(graph: Graph, protocol, batch, key,
                        max_rounds: int, recorder):
    done0 = batch.done.clone()
    batch = protocol.refresh(graph, batch)
    capacity = batch.capacity

    # Running lanes over capacity, summed. The reference divides by the
    # constant capacity, which XLA compiles into a product with its f32
    # reciprocal, fused with the sum's add: one rounding, as fma_f32's.
    inv_capacity = float(np.float32(1) / np.float32(capacity))

    def occupancy(occ, b, stats):
        running = (b.admitted & ~b.done).sum(dtype=torch.int32)
        return TF.fma_f32(running.to(torch.float32), inv_capacity, occ)

    def row(b, st, messages):
        running = (b.admitted & ~b.done).sum(dtype=torch.int32)
        return dict(
            occupancy=running.to(torch.float32) * inv_capacity,
            new=st["messages"],
            total=flightrec.total_f32(*flightrec.limbs(messages)),
            coverage=b.done.sum(dtype=torch.int32), active_lanes=running)

    ring = None if recorder is None else recorder.init(graph.device)
    batch, rounds, messages, occ = _lane_loop(
        graph, protocol, batch, key, max_rounds,
        lambda st: st["messages"], occupancy, ring, row)
    packed = accum.pack_query_summary(
        rounds, (batch.admitted & ~batch.done).sum(), batch.done.sum(),
        messages, occ / rounds.clamp_min(1).to(torch.float32),
        bitset.pack_bits(batch.done), batch.rounds,
        protocol.lane_values(graph, batch),
        values_float=protocol.VALUES_FLOAT)
    t1 = time.perf_counter()
    host, done0 = _summary(packed, done0)
    out = accum.unpack_query_summary(host, capacity,
                                     values_float=protocol.VALUES_FLOAT)
    newly_rounds = _newly_completed(out, done0)
    if ring is not None:
        out["flight_record"] = flightrec.trim(ring, out["rounds"])
    nbytes = _nbytes(packed, ring) + 4 * bitset.n_words(capacity)
    return batch, out, newly_rounds, t1, nbytes
