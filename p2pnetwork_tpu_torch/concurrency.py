"""The concurrency seam: one factory for the lock the telemetry registry
takes (the port's copy of ``p2pnetwork_tpu/concurrency.py``, trimmed to
what the port uses).

Code of the port never calls ``threading.Lock()`` directly; it calls
:func:`lock`, so a test-time provider can substitute an instrumented
primitive. With no provider installed (the default) :func:`lock` returns
the stdlib lock. Stdlib only.
"""

from __future__ import annotations

import threading as _threading
from typing import Any, Optional

__all__ = ["lock", "install"]

#: The active provider, or None for raw stdlib primitives.
_provider: Optional[Any] = None
# The seam's own bootstrap lock is raw: it exists before any provider.
_provider_lock = _threading.Lock()


def _current() -> Optional[Any]:
    with _provider_lock:
        return _provider


def install(provider: Optional[Any]) -> Optional[Any]:
    """Swap the process-wide provider (``None`` restores the stdlib
    primitives); returns the previous one."""
    global _provider
    with _provider_lock:
        prev, _provider = _provider, provider
    return prev


def lock():
    """A mutex (``threading.Lock`` semantics: non-reentrant)."""
    p = _current()
    if p is None:
        return _threading.Lock()
    return p.lock()
