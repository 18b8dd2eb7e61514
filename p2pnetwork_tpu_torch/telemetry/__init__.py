"""The port's telemetry plane (its copy of ``p2pnetwork_tpu/telemetry``):

- :mod:`~p2pnetwork_tpu_torch.telemetry.registry` — counters, gauges and
  histograms; :func:`default_registry` is the process-wide plane the
  graph builds, failures, layout cache, engine run summaries and the
  supervise and serving planes report to;
- :mod:`~p2pnetwork_tpu_torch.telemetry.spans` — the trace plane: spans
  with parent links, per-lane lifecycle events, Chrome and JSONL export;
- :mod:`~p2pnetwork_tpu_torch.telemetry.history` — a bounded ring of
  gauge samples, one per engine run summary.

The reference's Prometheus/JSONL exporters, HTTP server, SLO engine and
JAX compile hooks are not part of the port.
"""

from p2pnetwork_tpu_torch.telemetry.history import (  # noqa: F401
    History, default_history, set_default_history)
from p2pnetwork_tpu_torch.telemetry.registry import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS, DEFAULT_SIZE_BUCKETS, Counter, Gauge,
    Histogram, Registry, default_registry, exponential_buckets,
    set_default_registry)
from p2pnetwork_tpu_torch.telemetry.spans import (  # noqa: F401
    Tracer, current_tracer, install_tracer, uninstall_tracer)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry",
    "DEFAULT_LATENCY_BUCKETS", "DEFAULT_SIZE_BUCKETS",
    "default_registry", "set_default_registry", "exponential_buckets",
    "History", "default_history", "set_default_history",
    "Tracer", "current_tracer", "install_tracer", "uninstall_tracer",
]
