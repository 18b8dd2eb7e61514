"""Round engine (torch counterpart of the part of
``p2pnetwork_tpu/sim/engine.py`` the flood protocols use): ``run`` /
``run_from`` (a fixed number of rounds, per-round stats stacked) and
``run_until_coverage`` / ``run_until_coverage_from``.

The reference runs the whole loop as one ``lax.while_loop`` on the device.
PyTorch has no device-side loop, so the port runs super-steps of
``steps_per_round = T`` protocol steps and reads the exit flag on the host
once per super-step (one sync, counted in ``_device.SYNCS``). Inside a
super-step the reference's freeze rule holds: each sub-step re-evaluates
the predicate and applies its step only while it holds, so any ``T`` gives
results bit-identical to ``T = 1``.

The counters follow the reference's arithmetic: coverage and the running
occupancy sum are f32, the stop test compares in f32, the occupancy mean
is the f32 sum divided by the round count. Messages accumulate exactly in
int64 (the reference's two-limb counter holds the same range).
"""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch import _device
from p2pnetwork_tpu_torch.sim.graph import Graph


def _require_stats(protocol, required) -> None:
    missing = [r for r in required if r not in protocol.STATS]
    if missing:
        raise ValueError(f"{type(protocol).__name__} exposes stats "
                         f"{sorted(protocol.STATS)}; this loop needs "
                         f"{sorted(missing)}")


def _freeze(live: torch.Tensor, new, old):
    """``new`` where ``live`` holds, else ``old``, field by field."""
    return dataclasses.replace(old, **{
        f.name: torch.where(live, getattr(new, f.name), getattr(old, f.name))
        for f in dataclasses.fields(old)})


def _stat_while(graph: Graph, protocol, state, *, value0: torch.Tensor,
                coverage_target: float, max_rounds: int,
                steps_per_round: int = 1):
    """Run protocol rounds while ``coverage < coverage_target`` and
    ``rounds < max_rounds``. Returns ``(state, summary dict)``."""
    T = int(steps_per_round)
    if T < 1:
        raise ValueError(f"steps_per_round must be >= 1, got {T}")
    dev = value0.device
    target = torch.tensor(coverage_target, dtype=torch.float32, device=dev)
    rounds = torch.zeros((), dtype=torch.int32, device=dev)
    value = value0.to(torch.float32)
    messages = torch.zeros((), dtype=torch.int64, device=dev)
    occ = torch.zeros((), dtype=torch.float32, device=dev)
    has_occ = "frontier_occupancy" in protocol.STATS

    def keep_going(v, r):
        return (v < target) & (r < max_rounds)

    while _device.host_bool(keep_going(value, rounds)):
        for _ in range(T):
            live = keep_going(value, rounds)
            new_state, stats = protocol.step(graph, state)
            state = _freeze(live, new_state, state)
            messages = messages + torch.where(live, stats["messages"], 0)
            rounds = rounds + live.to(torch.int32)
            value = torch.where(live, stats["coverage"].to(torch.float32),
                                value)
            if has_occ:
                occ = occ + torch.where(live, stats["frontier_occupancy"],
                                        0.0)
    occ_mean = occ / rounds.clamp_min(1).to(torch.float32)
    n_rounds, n_messages = torch.stack(
        [rounds.to(torch.int64), messages]).tolist()
    coverage, occ_mean = torch.stack([value, occ_mean]).tolist()
    out = {"rounds": n_rounds, "coverage": coverage, "messages": n_messages}
    if has_occ:
        out["frontier_occupancy_mean"] = occ_mean
    return state, out


def run(graph: Graph, protocol, rounds: int, *, recorder=None):
    """Run ``rounds`` rounds from the protocol's initial state. Returns
    ``(final_state, stats)``, each stat stacked to ``[rounds]`` as the
    reference's ``lax.scan`` stacks it (see :func:`run_from`)."""
    return run_from(graph, protocol, protocol.init(graph), rounds,
                    recorder=recorder)


def run_from(graph: Graph, protocol, state, rounds: int, *, recorder=None):
    """Run ``rounds`` rounds continuing from ``state``. Returns
    ``(final_state, stats)`` with every stat a ``[rounds]`` tensor on the
    host, fetched in one transfer at the end (the rounds themselves make
    no host read of their own; a protocol's branch reads, as
    ``AdaptiveFlood``'s, still count in ``_device.SYNCS``).

    ``state`` is not modified: torch has no buffer donation, so the
    reference's ``donate`` has no counterpart here. The flight recorder
    (``recorder=``) is not ported yet."""
    if recorder is not None:
        raise NotImplementedError("the flight recorder is not ported yet")
    per_round = []
    for _ in range(int(rounds)):
        state, stats = protocol.step(graph, state)
        per_round.append(stats)
    if not per_round:
        return state, {}
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
    return state, out


def run_until_coverage(graph: Graph, protocol, *,
                       coverage_target: float = 0.99, max_rounds: int = 1024,
                       steps_per_round: int = 1):
    """Run from the protocol's initial state until ``stats['coverage'] >=
    coverage_target`` (or ``max_rounds``). Returns ``(final_state, dict)``
    with ``rounds``, ``coverage``, ``messages`` (exact int) and, for the
    flood family, ``frontier_occupancy_mean`` — the reference's dict."""
    return run_until_coverage_from(
        graph, protocol, protocol.init(graph),
        coverage_target=coverage_target, max_rounds=max_rounds,
        steps_per_round=steps_per_round)


def run_until_coverage_from(graph: Graph, protocol, state0, *,
                            coverage_target: float = 0.99,
                            max_rounds: int = 1024,
                            steps_per_round: int = 1):
    """Run-to-coverage continuing from ``state0`` (not modified). The loop
    starts from ``state0``'s true coverage, so resuming a finished run
    executes zero rounds."""
    _require_stats(protocol, ("coverage", "messages"))
    return _stat_while(graph, protocol, state0,
                       value0=protocol.coverage(graph, state0),
                       coverage_target=coverage_target,
                       max_rounds=max_rounds,
                       steps_per_round=steps_per_round)
