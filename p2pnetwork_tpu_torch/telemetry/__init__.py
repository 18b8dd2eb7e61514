"""The port's telemetry: the metrics registry (``registry.py``, its copy
of ``p2pnetwork_tpu/telemetry/registry.py``'s counters). The graph
builds, the injected failures and the layout cache report through
:func:`default_registry`. Spans, the history ring and the engine's run
summaries are not ported yet."""

from p2pnetwork_tpu_torch.telemetry.registry import (  # noqa: F401
    Counter, Registry, default_registry, exponential_buckets,
    set_default_registry)

__all__ = ["Counter", "Registry", "default_registry",
           "set_default_registry", "exponential_buckets"]
