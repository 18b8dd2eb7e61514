"""The history plane: a bounded time-series ring over the registry's
gauges (the port's copy of ``p2pnetwork_tpu/telemetry/history.py``).

:class:`History` keeps the recent past of the point-in-time metrics: a
fixed-capacity ring of samples, each a timestamped snapshot of every
gauge child. The engine samples the default history once per run
summary (``sim/engine.py``), so a batched serving loop gets one point
per ``run_batch_until_coverage`` call with no extra wiring.

Stdlib only and thread-safe like the registry.
"""

from __future__ import annotations

import collections
import time
from typing import List, Optional, Tuple

from p2pnetwork_tpu_torch import concurrency
from p2pnetwork_tpu_torch.telemetry.registry import (Gauge, Registry,
                                               default_registry)

__all__ = ["History", "default_history", "set_default_history"]


class History:
    """A fixed-capacity ring of gauge samples.

    ``registry=None`` means "the process default registry, resolved per
    sample" — it survives ``set_default_registry`` swaps. ``capacity``
    bounds the ring; older samples fall off (recent-history
    observability, not long-term storage)."""

    def __init__(self, registry: Optional[Registry] = None,
                 capacity: int = 512):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._registry = registry
        self.capacity = capacity
        self._lock = concurrency.lock()
        self._ring = collections.deque(maxlen=capacity)

    def _resolve(self) -> Registry:
        return self._registry if self._registry is not None \
            else default_registry()

    def sample(self, ts: Optional[float] = None) -> dict:
        """Take one sample: every gauge child's current value, keyed
        ``(name, label-values)``, timestamped. Returns the row (also
        appended to the ring)."""
        ts = time.time() if ts is None else ts
        reg = self._resolve()
        values = {}
        # Read the registry OUTSIDE this ring's lock (open-call
        # discipline: gauge reads take the metric locks).
        for metric in reg.collect():
            if not isinstance(metric, Gauge):
                continue
            for child in metric.children():
                values[(metric.name, child.labels)] = child.value
        row = {"ts": ts, "values": values}
        with self._lock:
            self._ring.append(row)
        return row

    def rows(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def series(self, name: str,
               *labelvalues) -> List[Tuple[float, float]]:
        """One gauge's sampled series as ``[(ts, value), ...]``, label
        values positional in the gauge's label order (none for an
        unlabeled gauge) — samples where the child did not exist yet
        are skipped."""
        key = (name, tuple(str(v) for v in labelvalues))
        out = []
        for row in self.rows():
            v = row["values"].get(key)
            if v is not None:
                out.append((row["ts"], v))
        return out

    def snapshot(self, last: Optional[int] = None) -> dict:
        """JSON-able transposed view — what ``/history`` serves:
        ``{"capacity", "samples", "series": {name: [{"labels": [...],
        "points": [[ts, value], ...]}]}}`` with points in sample
        order. ``last`` keeps only the most recent N samples (the
        ``/history?n=`` query — a long serving run's scrape need not
        ship the whole ring)."""
        rows = self.rows()
        if last is not None:
            if last < 1:
                raise ValueError(f"last must be >= 1, got {last}")
            rows = rows[-last:]
        series: dict = {}
        for row in rows:
            for (name, labelvals), value in row["values"].items():
                series.setdefault(name, {}).setdefault(
                    labelvals, []).append([row["ts"], value])
        return {
            "capacity": self.capacity,
            "samples": len(rows),
            "series": {
                name: [{"labels": list(labelvals), "points": pts}
                       for labelvals, pts in by_labels.items()]
                for name, by_labels in series.items()
            },
        }


_default = History()
_default_lock = concurrency.lock()


def default_history() -> History:
    """The process-wide history ring the engine's run summaries sample
    and ``/history`` serves by default."""
    with _default_lock:
        return _default


def set_default_history(history: History) -> History:
    """Swap the process-wide history, returning the previous one (tests
    isolate by swapping a fresh ring in and restoring after)."""
    global _default
    with _default_lock:
        prev, _default = _default, history
    return prev
