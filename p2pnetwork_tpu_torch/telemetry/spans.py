"""The trace plane: trace ids, spans with parent links, exporters (the
port's copy of ``p2pnetwork_tpu/telemetry/spans.py``; span and event
names and their fields are the reference's).

A :class:`Tracer` collects spans (named intervals with parent links
forming one tree per trace) and point events (zero-duration spans) from
the instrumented seams: the engine's batched runs (``batch_run`` and
``query_run`` spans with per-lane ``lane_admit`` / ``lane_resume`` /
``lane_complete`` / ``lane_freeze`` events), the message batch's control
plane (``lane_submit`` on ``BatchFlood.admit``, ``lane_retire`` on
``BatchFlood.retire``), the supervise plane (``supervised_run`` spans,
``chunk`` / ``checkpoint`` / ``resume`` events) and the serving driver
(``serve_tick`` spans, per-ticket events under ``tkt-<id>`` traces).

Exports: :meth:`Tracer.to_chrome` (Chrome/Perfetto trace-event JSON) and
:meth:`Tracer.to_records` (JSONL records of ``type: "event"``).

Installation is process-wide and off by default: every seam goes through
:func:`emit` / :func:`span`, which cost one None-check when no tracer is
installed. Span storage is lock-guarded and the current-span stack is
thread-local. Stdlib only.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import IO, List, Optional, Union

from p2pnetwork_tpu_torch import concurrency

__all__ = ["Span", "Tracer", "install_tracer", "uninstall_tracer",
           "current_tracer", "emit", "span"]


class Span:
    """One span: a named interval in a trace tree. ``t1 is None`` while
    still open. ``args`` are the caller's structured attributes (lane
    ids, round counts, paths)."""

    __slots__ = ("span_id", "trace_id", "parent_id", "name", "t0", "t1",
                 "tid", "args")

    def __init__(self, span_id: int, trace_id: str,
                 parent_id: Optional[int], name: str, t0: float,
                 tid: int, args: dict):
        self.span_id = span_id
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.t1: Optional[float] = None
        self.tid = tid
        self.args = args


_trace_seq = [0]
_trace_seq_lock = concurrency.lock()


def _new_trace_id() -> str:
    with _trace_seq_lock:
        _trace_seq[0] += 1
        n = _trace_seq[0]
    return f"trace-{os.getpid():x}-{n}"


class Tracer:
    """A span collector for one trace. The constructor opens the ROOT
    span (named after the trace) — every span whose caller gives no
    parent and has no enclosing :meth:`span` context nests under it, so
    a finished trace is always ONE tree.

    ``max_spans`` bounds the store like every other graftscope plane
    (the flight ring's ``capacity``, the history ring's deque): past
    it, the OLDEST non-root spans drop (``dropped_spans`` counts them)
    — a process-wide tracer left installed on a serving loop keeps the
    recent past instead of growing without bound. The root span is
    pinned (never dropped), so the tree keeps its anchor; a surviving
    span whose dropped ancestor is gone re-parents visually to nothing
    — exporters still emit its recorded ``parent_id``.

    ``clock`` is injectable for deterministic tests; it must return
    seconds (float) and be monotone non-decreasing.
    """

    def __init__(self, name: str = "run", clock=time.time,
                 max_spans: int = 100_000):
        if max_spans < 1:
            raise ValueError(f"max_spans must be >= 1, got {max_spans}")
        self._clock = clock
        self._lock = concurrency.lock()
        self._spans = collections.deque(maxlen=max_spans)
        self._by_id = {}  # span_id -> Span for O(1) end(); evicts with
        self._dropped = 0  # the deque
        self._root_span: Optional[Span] = None  # pinned, not in the deque
        self._next_id = 1
        self._tls = threading.local()  # per-thread current-span stack
        self.trace_id = _new_trace_id()
        self.root = self.begin(name, parent=-1)

    # ------------------------------------------------------------- recording

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _current(self) -> Optional[int]:
        st = self._stack()
        return st[-1] if st else getattr(self, "root", None)

    def begin(self, name: str, parent: Optional[int] = None,
              trace: Optional[str] = None, **args) -> int:
        """Open a span; returns its id. ``parent=None`` nests under the
        calling thread's current :meth:`span` context (the root span
        when there is none); ``parent=-1`` makes a root (no parent).
        ``trace`` overrides the span's trace id — graftsight's ticket-
        scoped correlation: lifecycle events for one serve ticket carry
        ``tkt-<id>`` so :meth:`to_chrome` can export that ticket's tree
        alone, while the span still nests in this tracer's store."""
        if parent is None:
            parent = self._current()
        elif parent == -1:
            parent = None
        t0 = self._clock()
        tid = threading.get_ident()
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            sp = Span(sid, trace if trace is not None else self.trace_id,
                      parent, name, t0, tid, args)
            if self._root_span is None:
                self._root_span = sp  # pinned outside the bounded deque
            else:
                if len(self._spans) == self._spans.maxlen:
                    # the deque evicts its oldest span on append
                    self._dropped += 1
                    self._by_id.pop(self._spans[0].span_id, None)
                self._spans.append(sp)
            self._by_id[sid] = sp
        return sid

    def end(self, span_id: int) -> None:
        t1 = self._clock()
        with self._lock:
            sp = self._by_id.get(span_id)
            if sp is not None and sp.t1 is None:
                sp.t1 = t1

    def point(self, name: str, parent: Optional[int] = None,
              trace: Optional[str] = None, **args) -> int:
        """A zero-duration span (an instantaneous lifecycle event)."""
        sid = self.begin(name, parent=parent, trace=trace, **args)
        self.end(sid)
        return sid

    @contextlib.contextmanager
    def span(self, name: str, trace: Optional[str] = None, **args):
        """Open a span for the dynamic extent of the block; spans and
        events recorded inside (on this thread) nest under it."""
        sid = self.begin(name, trace=trace, **args)
        st = self._stack()
        st.append(sid)
        try:
            yield sid
        finally:
            st.pop()
            self.end(sid)

    def close(self) -> None:
        """End the root span (idempotent; exporters treat still-open
        spans as ending 'now', so closing is optional but tidy)."""
        self.end(self.root)

    # ------------------------------------------------------------- reading

    def spans(self) -> List[Span]:
        """Every retained span, root first (oldest-dropped past
        ``max_spans`` — see :attr:`dropped_spans`)."""
        with self._lock:
            root = [] if self._root_span is None else [self._root_span]
            return root + list(self._spans)

    @property
    def dropped_spans(self) -> int:
        """Spans evicted by the ``max_spans`` bound (0 = complete)."""
        with self._lock:
            return self._dropped

    def find(self, name: str) -> List[Span]:
        return [sp for sp in self.spans() if sp.name == name]

    def traces(self) -> dict:
        """Retained span counts per trace id, insertion-ordered — the
        tracer's own trace id first, then every ticket-scoped override
        (:meth:`begin`'s ``trace=``) in first-seen order. What the
        ``/dashboard`` recent-traces table lists."""
        counts: dict = {}
        for sp in self.spans():
            counts[sp.trace_id] = counts.get(sp.trace_id, 0) + 1
        return counts

    # ------------------------------------------------------------ exporters

    def to_chrome(self, trace_id: Optional[str] = None) -> dict:
        """The Chrome/Perfetto trace-event document: one ``ph: "X"``
        complete event per span (µs timestamps), span/parent/trace ids
        in ``args`` so the tree survives the format. ``trace_id``
        filters to one logical trace (a single ticket's lifecycle when
        the serve plane stamped ``tkt-<id>`` trace overrides).

        The top-level ``metadata`` reports what the document does NOT
        contain: ``dropped_spans`` counts spans evicted by the
        ``max_spans`` bound — a serving soak that overflowed the store
        exports a document that says so instead of silently reading as
        complete."""
        now = self._clock()
        events = []
        traces = set()
        for sp in self.spans():
            traces.add(sp.trace_id)
            if trace_id is not None and sp.trace_id != trace_id:
                continue
            t1 = now if sp.t1 is None else sp.t1
            events.append({
                "name": sp.name,
                "cat": "graftscope",
                "ph": "X",
                "ts": sp.t0 * 1e6,
                "dur": max(t1 - sp.t0, 0.0) * 1e6,
                "pid": os.getpid(),
                "tid": sp.tid,
                "args": {"span_id": sp.span_id, "parent_id": sp.parent_id,
                         "trace_id": sp.trace_id, **sp.args},
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {
                "dropped_spans": self.dropped_spans,
                "spans": len(events),
                "traces": 1 if trace_id is not None else len(traces),
                "trace_id": trace_id if trace_id is not None
                            else self.trace_id,
            },
        }

    def to_records(self) -> List[dict]:
        """Every span as one record in the shared telemetry JSONL schema
        (telemetry/export.py) — ``type: "event"``, span identity in
        ``labels``, duration and caller attributes in ``data``."""
        now = self._clock()
        out = []
        for sp in self.spans():
            t1 = now if sp.t1 is None else sp.t1
            out.append({
                "type": "event", "name": sp.name, "ts": sp.t0,
                "labels": {
                    "trace": sp.trace_id,
                    "span": str(sp.span_id),
                    "parent": "" if sp.parent_id is None
                              else str(sp.parent_id),
                },
                "data": {"duration_s": max(t1 - sp.t0, 0.0), **sp.args},
            })
        return out

    def write_jsonl(self, sink: Union[str, IO, None]) -> int:
        """Append :meth:`to_records` as JSON lines to ``sink`` (a path,
        opened in append mode, or a writable file object; ``None``
        writes nothing); returns the number of lines written."""
        records = self.to_records()
        f, close = (open(sink, "a", encoding="utf-8"), True) \
            if isinstance(sink, str) else (sink, False)
        if f is None:
            return 0
        try:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
        finally:
            if close:
                f.close()
        return len(records)

    def write_chrome(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_chrome(), f, indent=1)
        return path


# --------------------------------------------------------- process install

_installed: Optional[Tracer] = None
_install_lock = concurrency.lock()


def install_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install ``tracer`` as the process-wide trace collector, returning
    the previous one (restore it when done — tests do)."""
    global _installed
    with _install_lock:
        prev, _installed = _installed, tracer
    return prev


def uninstall_tracer() -> Optional[Tracer]:
    return install_tracer(None)


def current_tracer() -> Optional[Tracer]:
    with _install_lock:
        return _installed


def emit(name: str, trace: Optional[str] = None, **args) -> None:
    """Record a point event on the installed tracer; no-op (one
    None-check) when tracing is off — the instrumentation seams call
    this unconditionally. ``trace`` stamps a logical trace id on the
    event (graftsight's per-ticket correlation)."""
    t = current_tracer()
    if t is not None:
        t.point(name, trace=trace, **args)


@contextlib.contextmanager
def span(name: str, trace: Optional[str] = None, **args):
    """A span on the installed tracer for the dynamic extent of the
    block; a plain no-op context when tracing is off."""
    t = current_tracer()
    if t is None:
        yield None
        return
    with t.span(name, trace=trace, **args) as sid:
        yield sid
