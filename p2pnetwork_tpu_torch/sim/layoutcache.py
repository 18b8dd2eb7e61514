"""Content-addressed persistence of built graph layouts (torch counterpart
of ``p2pnetwork_tpu/sim/layoutcache.py``).

A built graph (COO, neighbor table, kernel layouts, CSR: everything
``sim/checkpoint.py::save_graph`` writes) is paid for once per (build
code, topology parameters, layout flags) and reloaded after. An entry's
file name carries a :func:`fingerprint` of the port's own graph-build
sources and of the caller's ``params``, so editing that code or changing
a parameter names another file: a stale layout is never found, never
loaded. :func:`clear` deletes the entries.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Callable, Iterable, Optional, Tuple

from p2pnetwork_tpu_torch import telemetry

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Package-relative sources whose code determines a built graph's arrays
#: and kernel layouts.
DEFAULT_SOURCES = (
    "sim/graph.py",
    "sim/layout.py",
    "sim/topology.py",
    "sim/checkpoint.py",
    "ops/blocked.py",
    "ops/diag.py",
    "ops/skew.py",
    "ops/bitset.py",
    "ops/frontier.py",
)


def fingerprint(*, params: Optional[dict] = None,
                extra_sources: Iterable[str] = (),
                digest_size: int = 6) -> str:
    """Hex digest naming one layout configuration: the bytes of every
    :data:`DEFAULT_SOURCES` file and of ``extra_sources`` (absolute
    paths), then the canonical JSON of ``params`` (pass every topology
    argument and layout flag that shapes the build)."""
    h = hashlib.blake2b(digest_size=digest_size)
    for rel in DEFAULT_SOURCES:
        try:
            with open(os.path.join(_PKG_DIR, rel), "rb") as f:
                h.update(f.read())
        except OSError:
            # Absence is fingerprinted too: a source appearing later
            # still invalidates.
            h.update(f"<absent:{rel}>".encode())
    for path in extra_sources:
        with open(path, "rb") as f:
            h.update(f.read())
    if params:
        h.update(json.dumps(params, sort_keys=True, default=str).encode())
    return h.hexdigest()


def default_cache_dir() -> str:
    """``$P2P_LAYOUT_CACHE_DIR``, else ``p2pnetwork_tpu_torch/layouts``
    under the user's cache directory."""
    env = os.environ.get("P2P_LAYOUT_CACHE_DIR")
    if env:
        return env
    cache = os.environ.get("XDG_CACHE_HOME",
                           os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(cache, "p2pnetwork_tpu_torch", "layouts")


def entry_path(name: str, *, cache_dir: Optional[str] = None,
               params: Optional[dict] = None,
               extra_sources: Iterable[str] = ()) -> str:
    """The file a configuration persists to."""
    fp = fingerprint(params=params, extra_sources=extra_sources)
    return os.path.join(cache_dir or default_cache_dir(),
                        f"{name}_{fp}.npz")


def _miss_counter():
    return telemetry.default_registry().counter(
        "layout_cache_miss_total",
        "Layout-cache misses by cause; every miss costs a full graph "
        "build.", ("reason",))


def cached_graph(name: str, build: Callable, *,
                 cache_dir: Optional[str] = None,
                 params: Optional[dict] = None,
                 extra_sources: Iterable[str] = (),
                 enabled: Optional[bool] = None,
                 on_miss: Optional[Callable] = None,
                 log: Optional[Callable[[str], None]] = None,
                 device=None) -> Tuple:
    """Load the stored layout of ``(name, fingerprint)`` onto ``device``,
    or ``build()`` it and store it. Returns ``(graph, seconds,
    from_cache)``.

    A cache failure falls back to a fresh ``build()``: the fingerprint
    pins the build code and params and builds are seed-deterministic,
    so the cache only saves time. Every miss is counted in
    ``layout_cache_miss_total{reason=missing|corrupt|disabled}`` and
    passed to ``on_miss(reason, path, error)``. ``enabled`` defaults to
    ``$P2P_LAYOUT_CACHE != "0"``; ``log`` gets one line per load or
    store."""
    from p2pnetwork_tpu_torch.sim import checkpoint as ckpt

    if enabled is None:
        enabled = os.environ.get("P2P_LAYOUT_CACHE", "1") != "0"
    cache_dir = cache_dir or default_cache_dir()
    path = None
    if enabled:
        path = entry_path(name, cache_dir=cache_dir, params=params,
                          extra_sources=extra_sources)

    def _miss(reason: str, error: Optional[str] = None) -> None:
        _miss_counter().labels(reason=reason).inc()
        if on_miss is not None:
            on_miss(reason, path, error)

    if enabled and os.path.exists(path):
        try:
            t0 = time.perf_counter()
            g = ckpt.load_graph(path, device=device)
            dt = time.perf_counter() - t0
            if log is not None:
                log(f"{name}: loaded cached graph in {dt:.1f}s ({path})")
            return g, dt, True
        except Exception as e:
            _miss("corrupt", f"{type(e).__name__}: {e}")
    elif enabled:
        _miss("missing")
    else:
        _miss("disabled")
    t0 = time.perf_counter()
    g = build()
    dt = time.perf_counter() - t0
    if enabled:
        try:
            os.makedirs(cache_dir, exist_ok=True)
            ckpt.save_graph(path, g)
            if log is not None:
                log(f"{name}: built in {dt:.1f}s, cached to {path}")
        except Exception as e:  # a full disk must not sink the caller
            if log is not None:
                log(f"{name}: cache save failed ({type(e).__name__}: {e})")
    return g, dt, False


def clear(cache_dir: Optional[str] = None) -> int:
    """Delete every ``.npz`` entry under the cache directory (current and
    stale fingerprints). Returns the number of files removed."""
    cache_dir = cache_dir or default_cache_dir()
    removed = 0
    try:
        names = os.listdir(cache_dir)
    except OSError:
        return 0
    for fname in names:
        if fname.endswith(".npz"):
            try:
                os.unlink(os.path.join(cache_dir, fname))
                removed += 1
            except OSError:
                pass
    return removed
