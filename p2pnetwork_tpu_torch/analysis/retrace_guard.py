"""Runtime complement to graftlint: per-block kernel-build budgets (the
port's counterpart of ``p2pnetwork_tpu/analysis/retrace_guard.py``).

The reference guards jit compiles: a block that retraces shows as the
compile counter climbing. The port compiles its hand-written kernels at
run time (``_build.py``: ``nvcc`` at the first CUDA call, once a process
unless the sources change), so what a warm block must not do is build:
:class:`retrace_guard` counts the kernel builds of its block through
``telemetry/buildhooks.py`` (``kernel_builds_total``) and turns a breach
of its budget into an exception (tests), a warning (benches) or a
callback (drivers).

Counting is process-wide, as in the reference: run guards around
single-flow regions, not concurrently.

Usage::

    from p2pnetwork_tpu_torch.analysis.retrace_guard import retrace_guard

    with retrace_guard("steady-state", budget=0):
        for _ in range(100):
            step(state)          # raises RetraceBudgetExceeded on a build

    with retrace_guard("first-call", budget=1, on_breach="warn") as g:
        run_stage()
    print(g.compiles, g.breached)
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional, Union

from p2pnetwork_tpu_torch.telemetry import buildhooks
from p2pnetwork_tpu_torch.telemetry.registry import Registry, default_registry

__all__ = ["retrace_guard", "RetraceBudgetExceeded"]


class RetraceBudgetExceeded(RuntimeError):
    """A guarded block built the kernel library more often than its
    budget."""

    def __init__(self, block: str, compiles: int, budget: int):
        self.block = block
        self.compiles = compiles
        self.budget = budget
        super().__init__(
            f"retrace_guard[{block}]: {compiles} kernel build(s), budget "
            f"{budget} — something inside rebuilt the kernels (a changed "
            "source, a lost build directory, or a fresh process)")


class retrace_guard:
    """Context manager asserting a kernel-build budget over its block.

    ``block`` labels errors, warnings and the counters
    (``retrace_guard_compiles_total{block}``,
    ``retrace_guard_breaches_total{block}``); ``budget`` is the builds
    the block may make (0: everything warm); ``registry`` the telemetry
    registry (default: the process default); ``on_breach`` is
    ``"raise"`` (default), ``"warn"`` or a callable given the guard. An
    exception already leaving the block takes precedence."""

    def __init__(self, block: str, budget: int,
                 registry: Optional[Registry] = None,
                 on_breach: Union[str, Callable[["retrace_guard"],
                                                None]] = "raise"):
        if budget < 0:
            raise ValueError("budget must be >= 0")
        if not (on_breach in ("raise", "warn") or callable(on_breach)):
            raise ValueError("on_breach must be 'raise', 'warn' or callable")
        self.block = str(block)
        self.budget = int(budget)
        self.on_breach = on_breach
        self._registry = registry
        self._start: Optional[float] = None
        #: Kernel builds during the block (valid after exit).
        self.compiles: int = 0
        #: Whether the block exceeded its budget (valid after exit).
        self.breached: bool = False
        self._active = False

    def _reg(self) -> Registry:
        return self._registry if self._registry is not None \
            else default_registry()

    def _count(self) -> float:
        buildhooks.install(self._registry)
        return buildhooks.compile_count(self._registry)

    def __enter__(self) -> "retrace_guard":
        if self._active:
            raise RuntimeError("retrace_guard is not reentrant")
        self._active = True
        self.compiles = 0
        self.breached = False
        self._start = self._count()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._active = False
        self.compiles = int(self._count() - self._start)
        reg = self._reg()
        reg.counter(
            "retrace_guard_compiles_total",
            "Kernel builds observed inside retrace_guard blocks.",
            ("block",)).labels(self.block).inc(self.compiles)
        self.breached = self.compiles > self.budget
        if not self.breached:
            return False
        reg.counter(
            "retrace_guard_breaches_total",
            "retrace_guard blocks that exceeded their build budget.",
            ("block",)).labels(self.block).inc()
        if exc_type is not None:
            return False  # the block's own failure outranks the breach
        if self.on_breach == "raise":
            raise RetraceBudgetExceeded(self.block, self.compiles,
                                        self.budget)
        if self.on_breach == "warn":
            warnings.warn(
                f"retrace_guard[{self.block}]: {self.compiles} build(s) "
                f"over budget {self.budget}", RuntimeWarning, stacklevel=2)
        else:
            self.on_breach(self)
        return False
