"""SLO engine: declarative objectives, rolling windows, multi-window
burn-rate alerts (the port's copy of ``p2pnetwork_tpu/telemetry/slo.py``:
the same objectives, windows, metric names and alert records).

It measures the serving plane's p99 submit->completion objective. An :class:`Objective` declares what
"good" means for one observation stream (``completion_rounds <= 24``,
``shed == 0``, ...) and what fraction of observations must be good
(``goal=0.99`` is a p99 objective: 99% of completions within target).
The :class:`SLOEngine` is fed raw observations (:meth:`SLOEngine.record`
— the serve driver feeds per-ticket completion rounds/wall and
per-submission shed flags, per-tick heal flags) and evaluated once per
driver tick (:meth:`SLOEngine.evaluate`).

Burn rate is the standard SRE quantity: the fraction of the error
budget (``1 - goal``) consumed per unit, so ``burn == 1.0`` means
"exactly on budget" and ``burn == 10`` means "burning budget 10x too
fast". Alerts are MULTI-WINDOW: an objective fires only when both the
fast window (responsive, flappy alone) and the slow window (stable,
laggy alone) burn at or above ``burn_threshold`` — the classic
two-window page condition. Transitions (fire/resolve) are emitted as
structured :class:`~p2pnetwork_tpu_torch.utils.logging.EventLog` records
(the shared JSONL schema via ``to_jsonl``) and counted in
``slo_alerts_total``; the current burn rides the ``slo_burn_rate``
gauge per (objective, window) so the history ring and ``/dashboard``
can plot it.

Windows are counted in OBSERVATIONS, not wall seconds: evaluation is a
pure function of the fed values, so a seeded serve run evaluates
identically every replay — which is what lets AIMD admission consume a
firing objective (``admission_signal=True``) as an explicit,
deterministic backpressure signal (serve/service.py) without breaking
the serving plane's bit-identity contract. Wall-clock objectives
(``completion_wall_s``) are observability-only and must keep
``admission_signal=False``.

Stdlib-only, like the rest of the telemetry plane.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from p2pnetwork_tpu_torch import concurrency
from p2pnetwork_tpu_torch.telemetry.registry import Registry, default_registry
from p2pnetwork_tpu_torch.utils.logging import EventLog

__all__ = ["Objective", "SLOEngine", "serve_objectives"]


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declarative service-level objective.

    ``metric`` names the observation stream this objective judges;
    an observation is GOOD when ``value <= target`` (``mode="le"``) or
    ``value >= target`` (``mode="ge"``). ``goal`` is the required good
    fraction (0.99 = p99). ``fast_window``/``slow_window`` are rolling
    window lengths in observations; the alert condition is burn >=
    ``burn_threshold`` in BOTH windows at once. ``admission_signal``
    marks the objective as safe for AIMD admission to act on — only
    set it on objectives whose observations are deterministic under
    seeded replay (rounds, shed flags), never wall-clock ones."""

    name: str
    metric: str
    target: float
    mode: str = "le"
    goal: float = 0.99
    fast_window: int = 16
    slow_window: int = 64
    burn_threshold: float = 2.0
    admission_signal: bool = False

    def __post_init__(self):
        if self.mode not in ("le", "ge"):
            raise ValueError(f"mode must be 'le' or 'ge', got {self.mode!r}")
        if not 0.0 < self.goal < 1.0:
            raise ValueError(f"goal must be in (0, 1), got {self.goal}")
        if self.fast_window < 1 or self.slow_window < self.fast_window:
            raise ValueError(
                f"need 1 <= fast_window <= slow_window, got "
                f"{self.fast_window}/{self.slow_window}")
        if self.burn_threshold <= 0.0:
            raise ValueError(
                f"burn_threshold must be > 0, got {self.burn_threshold}")

    def good(self, value: float) -> bool:
        return value <= self.target if self.mode == "le" \
            else value >= self.target

    def spec(self) -> dict:
        """The declaration as a plain dict (what /dashboard embeds)."""
        return dataclasses.asdict(self)


def serve_objectives(slo_rounds: float, wall_s: Optional[float] = None,
                     shed_goal: float = 0.95,
                     heal_goal: float = 0.90,
                     durability_goal: Optional[float] = None,
                     ) -> Tuple[Objective, ...]:
    """The default serving objective set: p99 completion rounds
    (deterministic — the one AIMD may act on), optional p99 completion
    wall latency (observability-only), shed rate, heal rate.

    ``durability_goal`` (opt-in) appends a ``durability``
    objective over the service's per-tick durability stream (1.0 while
    the journal is failed / the service sheds ``DurabilityLost``, else
    0.0): a goal of e.g. 0.999 alerts when more than 0.1% of recent
    ticks ran without a working write-ahead journal. Deterministic
    (tick-derived), but observability-only by default — degraded
    durability should page an operator, not throttle admission of the
    work that IS still journalable."""
    objs = [
        Objective("completion_p99_rounds", metric="completion_rounds",
                  target=float(slo_rounds), mode="le", goal=0.99,
                  admission_signal=True),
        Objective("shed_rate", metric="shed", target=0.0, mode="le",
                  goal=shed_goal),
        Objective("heal_rate", metric="heal", target=0.0, mode="le",
                  goal=heal_goal),
    ]
    if wall_s is not None:
        objs.insert(1, Objective("completion_p99_wall_s",
                                 metric="completion_wall_s",
                                 target=float(wall_s), mode="le", goal=0.99))
    if durability_goal is not None:
        objs.append(Objective("durability", metric="durability",
                              target=0.0, mode="le",
                              goal=float(durability_goal)))
    return tuple(objs)


class SLOEngine:
    """Evaluate a set of :class:`Objective`\\ s over rolling windows.

    Thread-safe: :meth:`record` may be called from submitter threads
    while the driver calls :meth:`evaluate`; observation rings and
    firing state serialize on one lock, and gauge writes happen outside
    it (open-call discipline). Alert records land in ``self.log`` (an
    :class:`EventLog`; pass one in to share a stream) as
    ``slo_alert`` events with the full burn context in ``data``."""

    def __init__(self, objectives: Iterable[Objective],
                 registry: Optional[Registry] = None,
                 log: Optional[EventLog] = None):
        self.objectives: Tuple[Objective, ...] = tuple(objectives)
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names in {names}")
        self.log = log if log is not None else EventLog()
        reg = registry if registry is not None else default_registry()
        self._g_burn = reg.gauge(
            "slo_burn_rate",
            "error-budget burn rate per objective and window "
            "(1.0 = exactly on budget)", ("objective", "window"))
        self._g_firing = reg.gauge(
            "slo_firing", "1 while the objective's multi-window burn "
            "alert is firing, else 0", ("objective",))
        self._c_alerts = reg.counter(
            "slo_alerts_total", "burn-rate alert transitions",
            ("objective", "transition"))
        self._lock = concurrency.lock()
        # One bounded ring per observation stream, sized by the widest
        # window that judges it.
        window_by_metric: Dict[str, int] = {}
        for o in self.objectives:
            window_by_metric[o.metric] = max(
                window_by_metric.get(o.metric, 0), o.slow_window)
        self._obs: Dict[str, collections.deque] = {
            m: collections.deque(maxlen=w)
            for m, w in window_by_metric.items()}
        self._firing: Dict[str, bool] = {o.name: False
                                         for o in self.objectives}
        self._last: Dict[str, dict] = {}

    # ------------------------------------------------------------- feeding

    def record(self, metric: str, value: float) -> None:
        """Feed one observation. Streams no objective judges are
        dropped (instrumentation may feed generously)."""
        with self._lock:
            ring = self._obs.get(metric)
            if ring is not None:
                ring.append(float(value))

    # ---------------------------------------------------------- evaluating

    @staticmethod
    def _burn(values: Sequence[float], obj: Objective) -> float:
        if not values:
            return 0.0
        bad = sum(0 if obj.good(v) else 1 for v in values)
        return (bad / len(values)) / (1.0 - obj.goal)

    def evaluate(self, tick: int = -1) -> Dict[str, dict]:
        """Evaluate every objective against its current windows; update
        the gauges; emit fire/resolve transitions. Returns (and caches,
        for :meth:`snapshot`) per-objective state dicts. Pure in the
        fed observations — identical feeds give identical verdicts."""
        states: Dict[str, dict] = {}
        transitions: List[Tuple[Objective, bool, dict]] = []
        # Copy the observation rings under the lock, judge them outside
        # it (open-call discipline: ``Objective.good`` is app-providable
        # code and must not run inside the engine's critical section).
        with self._lock:
            obs = {m: list(ring) for m, ring in self._obs.items()}
        for obj in self.objectives:
            values = obs.get(obj.metric, [])
            slow = values[-obj.slow_window:]
            fast = values[-obj.fast_window:]
            burn_fast = self._burn(fast, obj)
            burn_slow = self._burn(slow, obj)
            good = sum(1 for v in slow if obj.good(v))
            # No verdict before one full fast window: a single bad
            # first observation must not page.
            warmed = len(values) >= obj.fast_window
            firing = bool(warmed
                          and burn_fast >= obj.burn_threshold
                          and burn_slow >= obj.burn_threshold)
            states[obj.name] = {
                "metric": obj.metric,
                "target": obj.target,
                "mode": obj.mode,
                "goal": obj.goal,
                "burn_fast": burn_fast,
                "burn_slow": burn_slow,
                "burn_threshold": obj.burn_threshold,
                "good_ratio": (good / len(slow)) if slow else 1.0,
                "samples": len(slow),
                "firing": firing,
                "admission_signal": obj.admission_signal,
                "tick": tick,
            }
        with self._lock:
            for obj in self.objectives:
                state = states[obj.name]
                if state["firing"] != self._firing[obj.name]:
                    self._firing[obj.name] = state["firing"]
                    transitions.append((obj, state["firing"], dict(state)))
            self._last = states
        # Metric writes and EventLog records outside the engine lock
        # (both take their own locks).
        for obj in self.objectives:
            st = states[obj.name]
            self._g_burn.labels(obj.name, "fast").set(st["burn_fast"])
            self._g_burn.labels(obj.name, "slow").set(st["burn_slow"])
            self._g_firing.labels(obj.name).set(1.0 if st["firing"] else 0.0)
        for obj, firing, state in transitions:
            kind = "fire" if firing else "resolve"
            self._c_alerts.labels(obj.name, kind).inc()
            self.log.record("slo_alert", None,
                            {"objective": obj.name, "transition": kind,
                             **state})
        return states

    # ------------------------------------------------------------- reading

    def firing(self, admission_only: bool = False) -> List[str]:
        """Names of currently-firing objectives (as of the last
        :meth:`evaluate`); ``admission_only`` keeps just the ones AIMD
        admission is allowed to act on."""
        with self._lock:
            last = dict(self._last)
        by_name = {o.name: o for o in self.objectives}
        return [n for n, st in last.items()
                if st["firing"] and (not admission_only
                                     or by_name[n].admission_signal)]

    def snapshot(self) -> dict:
        """JSON-able engine state for ``/dashboard``: every objective's
        declaration + last evaluation, plus recent alert records."""
        with self._lock:
            last = {n: dict(st) for n, st in self._last.items()}
        objectives = {}
        for obj in self.objectives:
            st = last.get(obj.name, {
                "burn_fast": 0.0, "burn_slow": 0.0, "good_ratio": 1.0,
                "samples": 0, "firing": False, "tick": -1})
            objectives[obj.name] = {**obj.spec(), **st}
        alerts = [{"event": r.event, "timestamp": r.timestamp,
                   "data": r.data}
                  for r in self.log.snapshot() if r.event == "slo_alert"]
        return {"objectives": objectives, "alerts": alerts[-32:]}
