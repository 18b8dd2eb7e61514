"""Registry exporters: Prometheus text exposition and the JSONL stream
(the port's copy of ``p2pnetwork_tpu/telemetry/export.py``; equal
registry contents render to equal text in both packages).

One schema, two encodings. The JSONL stream is the machine-readable side —
one self-describing record per line, each carrying ``type`` (counter /
gauge / histogram / event), ``name``, ``ts``, ``labels`` and the value
payload — shared with ``utils/logging.EventLog.to_jsonl`` so events and metric
samples interleave in one file without schema drift. The
Prometheus side is the text-exposition format (0.0.4) a scraper or the
bundled stdlib endpoint (:mod:`p2pnetwork_tpu_torch.telemetry.httpd`) serves.
"""

from __future__ import annotations

import json
import math
import time
from typing import IO, Iterator, Optional, Union

from p2pnetwork_tpu_torch.telemetry.registry import (Registry,
                                                     _HistogramChild,
                                                     default_registry)

__all__ = ["to_prometheus", "metric_records", "write_jsonl", "event_record",
           "write_records"]


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labelnames, labelvalues, extra: str = "") -> str:
    parts = [f'{n}="{_escape_label(v)}"' for n, v in zip(labelnames, labelvalues)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 2 ** 53:
        return str(int(v))
    return repr(float(v))


def to_prometheus(registry: Optional[Registry] = None) -> str:
    """Render every family as Prometheus text exposition (version 0.0.4):
    ``# HELP`` / ``# TYPE`` headers, ``_bucket{le=...}`` / ``_sum`` /
    ``_count`` series for histograms."""
    registry = registry or default_registry()
    lines = []
    for m in registry.collect():
        if m.help:
            lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for child in m.children():
            if isinstance(child, _HistogramChild):
                for ub, cum in child.cumulative():
                    le = "+Inf" if math.isinf(ub) else _fmt_value(ub)
                    labels = _fmt_labels(m.labelnames, child.labels,
                                         f'le="{le}"')
                    lines.append(f"{m.name}_bucket{labels} {cum}")
                labels = _fmt_labels(m.labelnames, child.labels)
                lines.append(f"{m.name}_sum{labels} {_fmt_value(child.sum)}")
                lines.append(f"{m.name}_count{labels} {child.count}")
            else:
                labels = _fmt_labels(m.labelnames, child.labels)
                lines.append(f"{m.name}{labels} {_fmt_value(child.value)}")
    return "\n".join(lines) + "\n"


def metric_records(registry: Optional[Registry] = None,
                   ts: Optional[float] = None) -> Iterator[dict]:
    """One JSONL-schema dict per sample of every family in ``registry``."""
    registry = registry or default_registry()
    ts = time.time() if ts is None else ts
    for name, fam in registry.snapshot().items():
        for sample in fam["samples"]:
            rec = {"type": fam["type"], "name": name, "ts": ts,
                   "labels": sample["labels"]}
            if fam["type"] == "histogram":
                rec.update(sum=sample["sum"], count=sample["count"],
                           buckets=sample["buckets"])
            else:
                rec["value"] = sample["value"]
            yield rec


def event_record(event: str, timestamp: float, peer_id=None,
                 data=None) -> dict:
    """An EventLog record in the shared JSONL schema — ``type: "event"``
    beside the metric types, so one stream carries both."""
    try:
        json.dumps(data)
    except (TypeError, ValueError):
        data = repr(data)  # exceptions and arbitrary objects ride as repr
    return {"type": "event", "name": event, "ts": timestamp,
            "labels": {} if peer_id is None else {"peer": str(peer_id)},
            "data": data}


def write_records(records, sink: Union[str, IO, None]) -> int:
    """Append schema records as JSON lines to ``sink`` (path = append mode,
    or any writable file object); returns the number of lines written. The
    single sink-dispatch used by every JSONL producer (metric samples here,
    socket events via ``EventLog.to_jsonl``) so their file semantics cannot
    drift apart."""
    records = list(records)
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


def write_jsonl(registry: Optional[Registry] = None,
                sink: Union[str, IO, None] = None,
                ts: Optional[float] = None) -> int:
    """Append every sample as one JSON line to ``sink`` (path or file
    object); returns the number of lines written."""
    return write_records(metric_records(registry, ts), sink)
