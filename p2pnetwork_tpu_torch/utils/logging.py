"""A bounded structured event log (the port's copy of
``p2pnetwork_tpu/utils/logging.py``): the SLO engine records its alert
transitions here (``telemetry/slo.py``), so tests and applications assert
on event history instead of parsing stdout.

:meth:`EventLog.to_jsonl` exports the history in the telemetry plane's
JSONL schema (``telemetry.export.event_record``: ``type: "event"`` lines
that interleave with metric samples in one stream). Stdlib only.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import IO, Any, Deque, List, Optional, Union

from p2pnetwork_tpu_torch import concurrency


@dataclasses.dataclass(frozen=True)
class EventRecord:
    """One framework event: name, monotonic timestamp, involved peer, data."""

    event: str
    timestamp: float
    peer_id: Optional[str]
    data: Any = None


class EventLog:
    """Bounded, thread-safe in-memory event history."""

    def __init__(self, maxlen: int = 4096):
        self._events: Deque[EventRecord] = collections.deque(maxlen=maxlen)
        self._lock = concurrency.lock()

    def record(self, event: str, peer_id: Optional[str] = None, data: Any = None) -> None:
        rec = EventRecord(event, time.monotonic(), peer_id, data)
        with self._lock:
            self._events.append(rec)

    def snapshot(self) -> List[EventRecord]:
        with self._lock:
            return list(self._events)

    def count(self, event: Optional[str] = None) -> int:
        with self._lock:
            if event is None:
                return len(self._events)
            return sum(1 for e in self._events if e.event == event)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def to_jsonl(self, sink: Union[str, IO]) -> int:
        """Append the history to ``sink`` (path or file object), one line
        per event in the shared telemetry JSONL schema — the same envelope
        ``telemetry.export.write_jsonl`` gives metric samples, so socket
        events and metrics land in one stream a single parser reads.
        Returns the number of lines written."""
        from p2pnetwork_tpu_torch.telemetry import export

        return export.write_records(
            (export.event_record(e.event, e.timestamp, e.peer_id, e.data)
             for e in self.snapshot()), sink)
