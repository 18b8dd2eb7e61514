"""Tracing and profiling for the sim backend (torch counterpart of
``p2pnetwork_tpu/utils/trace.py``).

- :func:`run_traced`: run a protocol and emit one JSON line a round (the
  round index and every stat the round computed), then a summary line
  with the wall time. The rounds run through ``sim/engine.run``, which
  brings the whole stats history to the host in one transfer at the end,
  so tracing reads nothing per round.
- :func:`annotate`: name a region so that it shows in profiler timelines
  (``torch.profiler.record_function``).
- :func:`profile`: capture a ``torch.profiler`` profile around a block,
  written as a Chrome trace (Perfetto or ``chrome://tracing`` read it)
  into ``log_dir``; on a CUDA machine it records the card's kernels too.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from typing import IO, Iterator, Optional, Union

import torch

from p2pnetwork_tpu_torch import telemetry
from p2pnetwork_tpu_torch.telemetry import buildhooks

__all__ = ["annotate", "profile", "run_traced"]

#: Bytes of one stat of one round in the history a run brings back: the
#: reference's 32-bit counts and f32 ratios (the port's engine widens its
#: counts to i64 on the device; the history it reports is the same).
STAT_BYTES = 4

_TRACES = itertools.count()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Name the enclosed work in profiler timelines."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block (the host, and the card's kernels when
    CUDA is available) and write it into ``log_dir`` as a Chrome trace,
    ``trace-<pid>-<n>.json``. Yields the profiler, whose
    ``key_averages()`` a caller may read after the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{next(_TRACES)}.json"))


def _open_sink(sink: Union[str, IO, None]):
    if sink is None or hasattr(sink, "write"):
        return sink, False
    return open(sink, "a", encoding="utf-8"), True


def run_traced(graph, protocol, key, rounds: int, *,
               sink: Union[str, IO, None] = None, label: str = "run",
               profile_dir: Optional[str] = None):
    """Run ``rounds`` protocol rounds, returning ``(state, records)``.

    ``records`` is a list of dicts, one a round, each holding the label,
    the round index and every stat the protocol computed (as floats):
    the reference's records. When ``sink`` is a path or a file object,
    each record is also written as one JSON line, then the summary line:
    ``wall_s``, ``compile_seconds`` (the seconds the run spent building
    and loading the kernel library, ``telemetry/buildhooks.py``: 0.0 when
    it was loaded before, what the reference reports on a compile-cache
    hit), ``device_transfer_bytes``
    (the size of the stats history brought back to the host, which is
    added to ``sim_transfer_bytes_total``), ``n_nodes`` and ``n_edges``.
    ``profile_dir`` also profiles the run into that directory
    (:func:`profile`). The graph's device runs the rounds: the card
    unless the graph was built on the CPU."""
    from p2pnetwork_tpu_torch.sim import engine

    reg = telemetry.default_registry()
    buildhooks.install(reg)
    built0 = sum(buildhooks.compile_seconds(reg, s)
                 for s in buildhooks.STAGES)
    ctx = profile(profile_dir) if profile_dir else contextlib.nullcontext()
    t0 = time.perf_counter()
    with ctx:
        with annotate(f"{label}:rounds={rounds}"):
            # engine.run returns the history on the host: the run is done.
            state, stats = engine.run(graph, protocol, key, rounds)
    wall_s = time.perf_counter() - t0
    compile_s = sum(buildhooks.compile_seconds(reg, s)
                    for s in buildhooks.STAGES) - built0

    host_stats = {k: v.numpy() for k, v in stats.items()}
    transfer_bytes = STAT_BYTES * sum(v.size for v in host_stats.values())
    reg.counter(
        "sim_transfer_bytes_total",
        "Bytes moved by device->host summary transfers.").inc(transfer_bytes)
    records = [{"label": label, "round": i,
                **{k: float(v[i]) for k, v in host_stats.items()}}
               for i in range(rounds)]
    summary = {
        "label": label,
        "summary": True,
        "rounds": rounds,
        "wall_s": wall_s,
        "compile_seconds": compile_s,
        "device_transfer_bytes": transfer_bytes,
        "n_nodes": graph.n_nodes,
        "n_edges": graph.n_edges,
    }

    f, close = _open_sink(sink)
    if f is not None:
        try:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
            f.write(json.dumps(summary) + "\n")
        finally:
            if close:
                f.close()
    return state, records
