"""Metrics registry: counters, gauges and histograms (the port's copy of
``p2pnetwork_tpu/telemetry/registry.py``). Metric names, help strings,
label names and bucket bounds are the reference's, so a snapshot reads
the same in both packages. The graph builds, the injected failures, the
layout cache, the engine's run summaries and the supervise and serving
planes report through :func:`default_registry`; tests read it back by
:meth:`Registry.value` and :meth:`Registry.snapshot`.

Stdlib only and thread-safe: every update takes its metric's lock.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from p2pnetwork_tpu_torch import concurrency

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry",
    "default_registry", "set_default_registry", "exponential_buckets",
    "DEFAULT_LATENCY_BUCKETS", "DEFAULT_SIZE_BUCKETS",
]

_METRIC_NAME_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def exponential_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """``count`` histogram upper bounds growing geometrically from ``start``
    (the +Inf bucket is implicit — every histogram always has it)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor ** i for i in range(count))


#: Message-latency style buckets: 100 µs .. ~3.3 s, factor 2.
DEFAULT_LATENCY_BUCKETS = exponential_buckets(1e-4, 2.0, 16)
#: Payload-size style buckets: 64 B .. 2 MiB, factor 4.
DEFAULT_SIZE_BUCKETS = exponential_buckets(64.0, 4.0, 9)


class _Child:
    """One labeled sample of a metric. Updates take the parent's lock —
    Python's ``+=`` on a float is not atomic across bytecode boundaries,
    and these update from several node event-loop threads at once."""

    __slots__ = ("_metric", "labels")

    def __init__(self, metric: "_Metric", labels: Tuple[str, ...]):
        self._metric = metric
        self.labels = labels


class _CounterChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, metric, labels):
        super().__init__(metric, labels)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._metric._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._metric._lock:
            return self._value


class _GaugeChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, metric, labels):
        super().__init__(metric, labels)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._metric._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._metric._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._metric._lock:
            return self._value


class _HistogramChild(_Child):
    __slots__ = ("counts", "_sum", "_count")

    def __init__(self, metric, labels):
        super().__init__(metric, labels)
        self.counts = [0] * (len(metric.buckets) + 1)  # last slot = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        buckets = self._metric.buckets
        i = 0
        while i < len(buckets) and value > buckets[i]:
            i += 1
        with self._metric._lock:
            self.counts[i] += 1
            self._sum += value
            self._count += 1

    @property
    def sum(self) -> float:
        with self._metric._lock:
            return self._sum

    @property
    def count(self) -> int:
        with self._metric._lock:
            return self._count

    def cumulative(self) -> List[Tuple[float, int]]:
        """``[(upper_bound, cumulative_count)]`` including the +Inf bucket —
        the Prometheus ``_bucket{le=...}`` series."""
        with self._metric._lock:
            counts = list(self.counts)
        out, running = [], 0
        for ub, c in zip(tuple(self._metric.buckets) + (math.inf,), counts):
            running += c
            out.append((ub, running))
        return out


class _Metric:
    """A named metric family: fixed label names, one child per label-value
    tuple. Calling update methods directly on an unlabeled metric routes to
    its single anonymous child."""

    kind = "untyped"
    _child_cls = _Child

    def __init__(self, name: str, help: str, labelnames: Sequence[str]):
        if not name or not set(name) <= _METRIC_NAME_OK or name[0].isdigit():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = concurrency.lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}

    def labels(self, *values, **kv) -> _Child:
        if values and kv:
            raise ValueError("pass label values positionally or by name, not both")
        if kv:
            try:
                values = tuple(str(kv.pop(n)) for n in self.labelnames)
            except KeyError as e:
                raise ValueError(f"{self.name}: missing label {e}") from None
            if kv:
                raise ValueError(f"{self.name}: unknown labels {sorted(kv)}")
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got {values}")
        with self._lock:
            child = self._children.get(values)
        if child is None:
            # Construct OUTSIDE the lock (a subclass child __init__ is
            # foreign code — open-call discipline); setdefault re-checks,
            # so two racing creators agree on one child and the loser's
            # never-published candidate is garbage.
            candidate = self._child_cls(self, values)
            with self._lock:
                child = self._children.setdefault(values, candidate)
        return child

    def _anon(self) -> _Child:
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; call .labels() first")
        return self.labels()

    def remove(self, *values, **kv) -> None:
        """Drop one labeled child (same addressing as :meth:`labels`).

        Per-peer children otherwise live for the process lifetime — a
        long-lived node under churn should prune point-in-time gauges for
        departed peers. Counters are usually KEPT so totals
        survive reconnects; prune them only when the label value can never
        recur. No-op if the child does not exist."""
        if kv:
            try:
                values = tuple(str(kv[n]) for n in self.labelnames)
            except KeyError as e:
                raise ValueError(f"{self.name}: missing label {e}") from None
        else:
            values = tuple(str(v) for v in values)
        with self._lock:
            self._children.pop(values, None)

    def children(self) -> List[_Child]:
        with self._lock:
            return list(self._children.values())


class Counter(_Metric):
    """Monotonically increasing value (events, bytes, errors)."""

    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, amount: float = 1.0) -> None:
        self._anon().inc(amount)

    @property
    def value(self) -> float:
        return self._anon().value


class Gauge(_Metric):
    """Point-in-time value that can go both ways (connections, suspicion,
    budget bytes)."""

    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, value: float) -> None:
        self._anon().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._anon().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._anon().dec(amount)

    @property
    def value(self) -> float:
        return self._anon().value


class Histogram(_Metric):
    """Distribution over fixed exponential buckets (latencies, frame sizes)."""

    kind = "histogram"
    _child_cls = _HistogramChild

    def __init__(self, name, help, labelnames,
                 buckets: Optional[Iterable[float]] = None):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(float(b) for b in
                          (DEFAULT_LATENCY_BUCKETS if buckets is None else buckets)))
        if not bs:
            raise ValueError("histogram needs at least one finite bucket")
        if bs and math.isinf(bs[-1]):
            bs = bs[:-1]  # +Inf is implicit
        self.buckets = bs

    def observe(self, value: float) -> None:
        self._anon().observe(value)

    @property
    def sum(self) -> float:
        return self._anon().sum

    @property
    def count(self) -> int:
        return self._anon().count


class Registry:
    """Thread-safe collection of metric families; get-or-create semantics so
    instrumentation sites never race over "who registers first"."""

    def __init__(self):
        self._lock = concurrency.lock()
        self._metrics: Dict[str, _Metric] = {}
        self.created_at = time.time()

    # ----------------------------------------------------------- factories

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Metric:
        labelnames = tuple(labelnames)
        with self._lock:
            m = self._metrics.get(name)
        if m is None:
            # Construct outside the lock — metric __init__ validates and
            # allocates (open-call discipline) — then commit atomically;
            # a racing registrant's candidate loses to setdefault and the
            # shared checks below validate against the winner.
            candidate = cls(name, help, labelnames, **kw)
            with self._lock:
                m = self._metrics.setdefault(name, candidate)
        if not isinstance(m, cls):
            raise ValueError(
                f"{name} already registered as a {m.kind}, not a {cls.kind}")
        if m.labelnames != labelnames:
            raise ValueError(
                f"{name} already registered with labels {m.labelnames}, "
                f"not {labelnames}")
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    # ------------------------------------------------------------ queries

    def collect(self) -> List[_Metric]:
        """All metric families, registration-ordered (dicts preserve it)."""
        with self._lock:
            return list(self._metrics.values())

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def value(self, name: str, **labels) -> float:
        """Read one sample's current value — the one-liner tests and quick
        checks want. 0.0 for anything that does not resolve to a touched
        child: unknown family, missing/partial/unknown label sets included
        (a typo'd label is an untouched sample, not a crash)."""
        m = self.get(name)
        if m is None:
            return 0.0
        try:
            key = tuple(str(labels[n]) for n in m.labelnames)
        except KeyError:
            return 0.0
        with m._lock:
            child = m._children.get(key)
        if child is None:
            return 0.0
        return child.count if isinstance(child, _HistogramChild) else child.value

    def snapshot(self) -> Dict[str, dict]:
        """Plain-dict view of every family — the in-process API examples and
        tests consume, and the JSON the exporters serialize.

        ``{name: {"type", "help", "labelnames", "samples": [
        {"labels": {...}, "value": ...} |
        {"labels": {...}, "sum": ..., "count": ..., "buckets": {le: n}}]}}``
        """
        out: Dict[str, dict] = {}
        for m in self.collect():
            samples = []
            for child in m.children():
                labels = dict(zip(m.labelnames, child.labels))
                if isinstance(child, _HistogramChild):
                    samples.append({
                        "labels": labels,
                        "sum": child.sum,
                        "count": child.count,
                        "buckets": {("+Inf" if math.isinf(ub) else repr(ub)): c
                                    for ub, c in child.cumulative()},
                    })
                else:
                    samples.append({"labels": labels, "value": child.value})
            out[m.name] = {"type": m.kind, "help": m.help,
                           "labelnames": list(m.labelnames), "samples": samples}
        return out

    def clear(self) -> None:
        """Drop every registered family (test isolation)."""
        with self._lock:
            self._metrics.clear()


_default = Registry()
_default_lock = concurrency.lock()


def default_registry() -> Registry:
    """The process-wide registry every instrumentation site reports to
    unless handed an explicit one."""
    # Read under the same lock that guards the swap (guarded write,
    # guarded read).
    with _default_lock:
        return _default


def set_default_registry(registry: Registry) -> Registry:
    """Swap the process-wide registry, returning the previous one (tests
    isolate by swapping in a fresh Registry and restoring after)."""
    global _default
    with _default_lock:
        prev, _default = _default, registry
    return prev
