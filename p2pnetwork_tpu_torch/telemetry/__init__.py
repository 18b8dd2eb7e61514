"""The port's telemetry plane (its copy of ``p2pnetwork_tpu/telemetry``):

- :mod:`~p2pnetwork_tpu_torch.telemetry.registry` — counters, gauges and
  histograms; :func:`default_registry` is the process-wide plane the
  graph builds, failures, layout cache, engine run summaries, the chaos
  and healing planes and the supervise and serving planes report to;
- :mod:`~p2pnetwork_tpu_torch.telemetry.export` — Prometheus text
  exposition and the shared JSONL schema;
- :mod:`~p2pnetwork_tpu_torch.telemetry.httpd` — ``/metrics``,
  ``/history``, ``/trace`` and ``/dashboard`` on a stdlib HTTP server,
  with the serving front-end mountable beside them;
- :mod:`~p2pnetwork_tpu_torch.telemetry.spans` — the trace plane: spans
  with parent links, per-lane lifecycle events, Chrome and JSONL export;
- :mod:`~p2pnetwork_tpu_torch.telemetry.history` — a bounded ring of
  gauge samples, one per engine run summary;
- :mod:`~p2pnetwork_tpu_torch.telemetry.slo` — the SLO engine:
  declarative objectives over rolling windows, multi-window burn-rate
  alerts.

The reference's JAX compile hooks (``jaxhooks.py``) have no counterpart
yet: nothing in the port is compiled or captured.
"""

from p2pnetwork_tpu_torch.telemetry.export import (  # noqa: F401
    event_record, metric_records, to_prometheus, write_jsonl)
from p2pnetwork_tpu_torch.telemetry.history import (  # noqa: F401
    History, default_history, set_default_history)
from p2pnetwork_tpu_torch.telemetry.registry import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS, DEFAULT_SIZE_BUCKETS, Counter, Gauge,
    Histogram, Registry, default_registry, exponential_buckets,
    set_default_registry)
from p2pnetwork_tpu_torch.telemetry.httpd import MetricsServer  # noqa: F401
from p2pnetwork_tpu_torch.telemetry.slo import (  # noqa: F401
    Objective, SLOEngine, serve_objectives)
from p2pnetwork_tpu_torch.telemetry.spans import (  # noqa: F401
    Tracer, current_tracer, install_tracer, uninstall_tracer)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry",
    "DEFAULT_LATENCY_BUCKETS", "DEFAULT_SIZE_BUCKETS",
    "default_registry", "set_default_registry", "exponential_buckets",
    "event_record", "metric_records", "to_prometheus", "write_jsonl",
    "History", "default_history", "set_default_history",
    "MetricsServer",
    "Objective", "SLOEngine", "serve_objectives",
    "Tracer", "current_tracer", "install_tracer", "uninstall_tracer",
]
