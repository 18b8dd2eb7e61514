"""Kernel-build accounting: the port's counterpart of the reference's
``p2pnetwork_tpu/telemetry/jaxhooks.py``.

The reference's hot paths are jitted programs, and "where did the time
go" starts with how much of it was compilation: ``jaxhooks`` routes JAX's
compile events into ``jax_compiles_total`` and
``jax_compile_seconds_total{stage}``. The port compiles its hand-written
kernels at run time instead: the first CUDA call of a kernel wrapper
builds ``csrc/*.cu`` with ``nvcc`` into one library and loads it
(``_build.py``). Each build reports here, into the subscribed registries:

- ``kernel_builds_total``: builds that ran ``nvcc`` (a rebuild detector:
  a run that finds its library on disk loads it and builds nothing);
- ``kernel_build_seconds_total{stage="nvcc"|"load"}``: wall seconds of
  the compile and link, and of loading the library.

As in the reference, one hook fans out to a set of subscribed registries
(``None`` is "the process default, resolved per event"); subscription is
what :func:`install` and :func:`uninstall` add and remove. Nothing here
imports torch.
"""

from __future__ import annotations

from typing import Optional

from p2pnetwork_tpu_torch import concurrency
from p2pnetwork_tpu_torch.telemetry.registry import Registry, default_registry

__all__ = ["install", "uninstall", "installed", "compile_seconds",
           "compile_count", "report", "STAGES"]

#: The stages a build reports.
STAGES = ("nvcc", "load")

_lock = concurrency.lock()
_registries: set = set()


def report(stage: str, seconds: float, built: bool = False) -> None:
    """One build stage finished (``_build.py`` calls this): add its
    seconds, and count a build when ``built`` (the ``nvcc`` stage ran)."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    with _lock:
        subscribed = list(_registries)
    # Resolved outside the lock: default_registry() takes the registry
    # module's own lock.
    targets = {default_registry() if r is None else r for r in subscribed}
    for reg in targets:
        reg.counter(
            "kernel_build_seconds_total",
            "Wall seconds spent building the kernel library, by stage.",
            ("stage",)).labels(stage=stage).inc(seconds)
        if built:
            reg.counter(
                "kernel_builds_total",
                "Builds of the kernel library that ran nvcc.").inc()


def install(registry: Optional[Registry] = None) -> bool:
    """Subscribe ``registry`` (``None``: the process default, resolved per
    event) to build events. Idempotent; always True (the reference
    returns False where its hook API is missing)."""
    with _lock:
        _registries.add(registry)
    return True


def uninstall(registry: Optional[Registry] = None) -> None:
    with _lock:
        _registries.discard(registry)


def installed(registry: Optional[Registry] = None) -> bool:
    with _lock:
        return registry in _registries


def compile_seconds(registry: Optional[Registry] = None,
                    stage: str = "nvcc") -> float:
    """Wall seconds recorded for one build stage so far (callers take
    deltas around the region they attribute)."""
    return (registry or default_registry()).value(
        "kernel_build_seconds_total", stage=stage)


def compile_count(registry: Optional[Registry] = None) -> float:
    return (registry or default_registry()).value("kernel_builds_total")
