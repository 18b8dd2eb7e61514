"""Metrics registry: labeled counters (the port's copy of
``p2pnetwork_tpu/telemetry/registry.py``, trimmed to what the port
reports: counters with labels, read back by :meth:`Registry.value` and
:meth:`Registry.snapshot`). Metric names, help strings and label names
are the reference's, so a snapshot reads the same in both packages.

Stdlib only and thread-safe: every update takes its metric's lock.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from p2pnetwork_tpu_torch import concurrency

__all__ = ["Counter", "Registry", "default_registry",
           "set_default_registry", "exponential_buckets"]

_METRIC_NAME_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def exponential_buckets(start: float, factor: float,
                        count: int) -> Tuple[float, ...]:
    """``count`` upper bounds growing geometrically from ``start`` (the
    reference's histogram buckets; +Inf is implicit)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor ** i for i in range(count))


class _CounterChild:
    """One labeled sample of a counter."""

    __slots__ = ("_metric", "labels", "_value")

    def __init__(self, metric: "Counter", labels: Tuple[str, ...]):
        self._metric = metric
        self.labels = labels
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._metric._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._metric._lock:
            return self._value


class Counter:
    """A monotonically increasing metric family: fixed label names, one
    child per label-value tuple; an unlabeled counter updates its one
    anonymous child."""

    kind = "counter"

    def __init__(self, name: str, help: str, labelnames: Sequence[str]):
        if not name or not set(name) <= _METRIC_NAME_OK or name[0].isdigit():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = concurrency.lock()
        self._children: Dict[Tuple[str, ...], _CounterChild] = {}

    def labels(self, *values, **kv) -> _CounterChild:
        if values and kv:
            raise ValueError(
                "pass label values positionally or by name, not both")
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
            candidate = _CounterChild(self, values)
            with self._lock:
                child = self._children.setdefault(values, candidate)
        return child

    def _anon(self) -> _CounterChild:
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled {self.labelnames}; "
                             f"call .labels() first")
        return self.labels()

    def inc(self, amount: float = 1.0) -> None:
        self._anon().inc(amount)

    @property
    def value(self) -> float:
        return self._anon().value

    def children(self) -> List[_CounterChild]:
        with self._lock:
            return list(self._children.values())


class Registry:
    """A thread-safe collection of counters with get-or-create
    registration."""

    def __init__(self):
        self._lock = concurrency.lock()
        self._metrics: Dict[str, Counter] = {}

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        labelnames = tuple(labelnames)
        with self._lock:
            m = self._metrics.get(name)
        if m is None:
            candidate = Counter(name, help, labelnames)
            with self._lock:
                m = self._metrics.setdefault(name, candidate)
        if m.labelnames != labelnames:
            raise ValueError(f"{name} already registered with labels "
                             f"{m.labelnames}, not {labelnames}")
        return m

    def collect(self) -> List[Counter]:
        """Every metric family, in registration order."""
        with self._lock:
            return list(self._metrics.values())

    def get(self, name: str) -> Optional[Counter]:
        with self._lock:
            return self._metrics.get(name)

    def value(self, name: str, **labels) -> float:
        """One sample's current value; 0.0 for an unknown family or an
        untouched label set."""
        m = self.get(name)
        if m is None:
            return 0.0
        try:
            key = tuple(str(labels[n]) for n in m.labelnames)
        except KeyError:
            return 0.0
        with m._lock:
            child = m._children.get(key)
        return 0.0 if child is None else child.value

    def snapshot(self) -> Dict[str, dict]:
        """``{name: {"type", "help", "labelnames", "samples": [{"labels",
        "value"}]}}``, the reference's snapshot form for counters."""
        out: Dict[str, dict] = {}
        for m in self.collect():
            samples = [{"labels": dict(zip(m.labelnames, c.labels)),
                        "value": c.value} for c in m.children()]
            out[m.name] = {"type": m.kind, "help": m.help,
                           "labelnames": list(m.labelnames),
                           "samples": samples}
        return out


_default = Registry()
_default_lock = concurrency.lock()


def default_registry() -> Registry:
    """The process-wide registry the port reports to."""
    with _default_lock:
        return _default


def set_default_registry(registry: Registry) -> Registry:
    """Swap the process-wide registry, returning the previous one."""
    global _default
    with _default_lock:
        prev, _default = _default, registry
    return prev
