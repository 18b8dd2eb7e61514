"""The concurrency seam: one factory for every thread, lock, condition,
event, queue and sleep the port uses (its copy of
``p2pnetwork_tpu/concurrency.py``).

Code of the port never constructs ``threading.Lock()``,
``threading.Thread(...)``, ``queue.Queue()`` or calls ``time.sleep()``
directly: it calls :func:`lock`, :func:`rlock`, :func:`condition`,
:func:`event`, :func:`thread`, :func:`fifo_queue` and :func:`sleep`
here, so a test-time provider (any object with the same-named factory
methods) can substitute instrumented primitives and serialize the
threads of the serving and supervise planes under a seeded scheduler.
With no provider installed (the default) these return the stdlib
objects; the substitution costs one guarded read at construction.
Install is process-wide: :func:`install` swaps the provider,
:func:`substituted` scopes it to a block.

Stdlib only.
"""

from __future__ import annotations

import queue as _queue_mod
import threading as _threading
import time as _time
from contextlib import contextmanager
from typing import Any, Callable, Optional

__all__ = [
    "lock", "rlock", "condition", "event", "thread", "fifo_queue",
    "sleep", "install", "installed", "substituted",
]

#: The active provider, or None for raw stdlib primitives; guarded so the
#: swap and every construction-time read agree.
_provider: Optional[Any] = None
# The seam's own bootstrap lock must be raw: it exists before any
# provider can, and instrumenting it would recurse.
_provider_lock = _threading.Lock()  # graftlint: ignore[raw-concurrency-primitive] -- the seam's bootstrap lock predates any provider


def _current() -> Optional[Any]:
    with _provider_lock:
        return _provider


def install(provider: Optional[Any]) -> Optional[Any]:
    """Swap the process-wide provider (``None`` restores raw stdlib
    primitives); returns the previous provider so callers can restore
    it. Prefer :func:`substituted` for scoped use."""
    global _provider
    with _provider_lock:
        prev, _provider = _provider, provider
    return prev


def installed() -> Optional[Any]:
    """The active provider, or ``None`` (raw stdlib)."""
    return _current()


@contextmanager
def substituted(provider: Optional[Any]):
    """Install ``provider`` for the duration of the block, restoring the
    previous provider (usually ``None``) on exit, even on error."""
    prev = install(provider)
    try:
        yield provider
    finally:
        install(prev)


# ------------------------------------------------------------- factories
#
# Each factory reads the provider under the seam lock, then constructs
# OUTSIDE it (a provider factory is foreign code). The raw constructions
# below are the one sanctioned home of these calls.

def lock():
    """A mutex (``threading.Lock`` semantics: non-reentrant)."""
    p = _current()
    if p is None:
        return _threading.Lock()  # graftlint: ignore[raw-concurrency-primitive] -- the seam itself
    return p.lock()


def rlock():
    """A reentrant mutex (``threading.RLock`` semantics)."""
    p = _current()
    if p is None:
        return _threading.RLock()  # graftlint: ignore[raw-concurrency-primitive] -- the seam itself
    return p.rlock()


def condition(lock: Optional[Any] = None):
    """A condition variable (``threading.Condition`` semantics)."""
    p = _current()
    if p is None:
        return _threading.Condition(lock)  # graftlint: ignore[raw-concurrency-primitive] -- the seam itself
    return p.condition(lock)


def event():
    """A one-way flag (``threading.Event`` semantics)."""
    p = _current()
    if p is None:
        return _threading.Event()  # graftlint: ignore[raw-concurrency-primitive] -- the seam itself
    return p.event()


def thread(target: Optional[Callable] = None, *, name: Optional[str] = None,
           args: tuple = (), kwargs: Optional[dict] = None,
           daemon: Optional[bool] = None):
    """A thread handle (``threading.Thread`` call-shape subset the repo
    uses: target/name/args/kwargs/daemon keywords, ``start``/``join``/
    ``is_alive``/``name``/``daemon``)."""
    p = _current()
    if p is None:
        return _threading.Thread(  # graftlint: ignore[raw-concurrency-primitive] -- the seam itself
            target=target, name=name, args=args, kwargs=kwargs or {},
            daemon=daemon)
    return p.thread(target=target, name=name, args=args,
                    kwargs=kwargs or {}, daemon=daemon)


def fifo_queue(maxsize: int = 0):
    """A FIFO queue (``queue.Queue`` semantics, including the
    ``queue.Empty``/``queue.Full`` exceptions)."""
    p = _current()
    if p is None:
        return _queue_mod.Queue(maxsize)  # graftlint: ignore[raw-concurrency-primitive] -- the seam itself
    return p.fifo_queue(maxsize)


def sleep(seconds: float) -> None:
    """``time.sleep`` through the seam: a provider turns it into a pure
    scheduling point (no wall time passes under graftrace)."""
    p = _current()
    if p is None:
        _time.sleep(seconds)  # graftlint: ignore[raw-concurrency-primitive] -- the seam itself
        return
    p.sleep(seconds)
