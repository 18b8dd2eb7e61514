"""Deadline watchdog over a heartbeat stream (the port's copy of
``p2pnetwork_tpu/supervise/watchdog.py``).

A dispatch that never returns holds its caller forever and the only
witness is the wall clock. :class:`Watchdog` is that witness: a daemon
thread fed heartbeats by a chunked run loop (``supervise/runner.py``,
the serving driver), firing a stall event when the gap between
heartbeats exceeds the deadline. Modes:

- ``"raise"`` (default): :class:`StallTimeout` is raised in the
  supervised thread at its next ``heartbeat()`` (or at context exit);
- ``"warn"``: a ``RuntimeWarning`` from the watchdog thread when the
  stall is detected;
- callable: invoked with the watchdog from the watchdog thread at
  detection time (emergency checkpoint, structured record, kill).

Every stall increments ``supervise_watchdog_timeouts_total{watchdog}``
and publishes the gap as the ``supervise_stall_seconds{watchdog}`` gauge.
The watchdog thread's waits are bounded, and ``close`` joins it with a
timeout.
"""

from __future__ import annotations

import time
import warnings
from typing import Any, Callable, Optional, Union

from p2pnetwork_tpu_torch import concurrency, telemetry

__all__ = ["Watchdog", "StallTimeout"]


class StallTimeout(RuntimeError):
    """A supervised dispatch exceeded its heartbeat deadline."""

    def __init__(self, name: str, stalled_s: float, deadline_s: float):
        self.name = name
        self.stalled_s = stalled_s
        self.deadline_s = deadline_s
        super().__init__(
            f"watchdog[{name}]: no heartbeat for {stalled_s:.1f}s "
            f"(deadline {deadline_s:.1f}s) — device dispatch wedged?")


class Watchdog:
    """Deadline watchdog over a heartbeat stream.

    Usage::

        with Watchdog(deadline_s=30.0, name="1m") as dog:
            for chunk in chunks:
                dog.heartbeat()       # raises StallTimeout here if a
                run_chunk(chunk)      # previous gap breached the deadline
            # exit also raises a pending stall (mode "raise")

    Thread-safe: ``heartbeat`` may be called from any thread; detection
    runs on the watchdog's own daemon thread so a dispatch that never
    returns still produces a stall event (modes "warn"/callable fire from
    that thread at detection time).
    """

    def __init__(self, deadline_s: float, *, name: str = "run",
                 on_stall: Union[str, Callable[["Watchdog"], None]] = "raise",
                 registry: Optional[telemetry.Registry] = None):
        if deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        if not (on_stall in ("raise", "warn") or callable(on_stall)):
            raise ValueError("on_stall must be 'raise', 'warn' or callable")
        self.deadline_s = float(deadline_s)
        self.name = str(name)
        self.on_stall = on_stall
        reg = registry if registry is not None else telemetry.default_registry()
        self._m_timeouts = reg.counter(
            "supervise_watchdog_timeouts_total",
            "Stall events fired by supervised-run watchdogs (one per "
            "heartbeat gap exceeding the deadline).", ("watchdog",)
        ).labels(self.name)
        self._m_stall = reg.gauge(
            "supervise_stall_seconds",
            "Seconds since the supervised run's last heartbeat, as "
            "observed by its watchdog — climbs while a dispatch is "
            "wedged, resets on the next heartbeat.", ("watchdog",)
        ).labels(self.name)
        self._lock = concurrency.lock()
        self._stop = concurrency.event()
        self._last_beat = time.monotonic()
        self._fired_this_gap = False     # one stall event per heartbeat gap
        self._pending_raise: Optional[StallTimeout] = None
        #: Total stall events fired over the watchdog's lifetime.
        self.stalls = 0
        #: Gap length of the most recent stall event (seconds).
        self.last_stall_s = 0.0
        self._thread: Optional[Any] = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "Watchdog":
        if self._thread is not None:
            raise RuntimeError("Watchdog already started")
        self._stop.clear()
        now = time.monotonic()
        with self._lock:
            self._last_beat = now
            self._fired_this_gap = False
        self._thread = concurrency.thread(
            target=self._watch, name=f"Watchdog({self.name})", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop the watchdog thread (bounded join; idempotent). Resets the
        stall gauge: a closed watchdog is not witnessing a stall, and a
        lingering non-zero ``supervise_stall_seconds`` would read as an
        ongoing wedge on an idle process."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.deadline_s + 5.0)
            self._thread = None
        self._m_stall.set(0.0)

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        if exc_type is None:
            self.check()  # a pending stall surfaces even without a final beat
        return False

    # ------------------------------------------------------------ heartbeat

    def heartbeat(self) -> None:
        """Record liveness. In mode ``"raise"``, a stall detected since the
        previous heartbeat raises :class:`StallTimeout` here — in the
        supervised thread, where the caller can unwind cleanly."""
        now = time.monotonic()
        with self._lock:
            self._last_beat = now
            self._fired_this_gap = False
        self._m_stall.set(0.0)
        self.check()

    def check(self) -> None:
        """Raise any pending stall (mode ``"raise"``); no-op otherwise."""
        with self._lock:
            pending, self._pending_raise = self._pending_raise, None
        if pending is not None:
            raise pending

    # ------------------------------------------------------------- internal

    def _watch(self) -> None:
        while True:
            now = time.monotonic()
            with self._lock:
                gap = now - self._last_beat
                remaining = self.deadline_s - gap
                stalled = remaining <= 0
                fire = stalled and not self._fired_this_gap
                if fire:
                    self._fired_this_gap = True
                    self.stalls += 1
                    self.last_stall_s = gap
            if stalled:
                # Keep the gauge climbing while the stall persists; re-check
                # on a short cadence so heartbeat resets surface quickly.
                self._m_stall.set(gap)
                wait = min(1.0, self.deadline_s)
            else:
                wait = max(remaining, 0.01)
            if fire:
                self._m_timeouts.inc()
                self._fire(gap)
            if self._stop.wait(timeout=wait):
                return

    def _fire(self, gap: float) -> None:
        err = StallTimeout(self.name, gap, self.deadline_s)
        if self.on_stall == "raise":
            with self._lock:
                self._pending_raise = err
        elif self.on_stall == "warn":
            warnings.warn(str(err), RuntimeWarning, stacklevel=2)
        else:
            try:
                self.on_stall(self)
            except Exception as e:  # a crashing driver hook must not kill
                # the watchdog thread — the NEXT stall still needs a witness.
                warnings.warn(
                    f"watchdog[{self.name}]: on_stall callback raised "
                    f"{type(e).__name__}: {e}", RuntimeWarning, stacklevel=2)
