"""The serving plane's write-ahead intent journal (the port's copy of
``p2pnetwork_tpu/serve/journal.py``; the wire format is the reference's,
so a journal written by either package reads in the other, record for
record).

The checkpoint pair (store entry + sidecar) is boundary-granular: a kill
between tick boundaries would lose every intent acknowledged since the
last pair. The journal closes that window with an append-only,
CRC-per-record, segment-rotated log of every admission-plane intent
(submit / cancel / shed / grow / delta):

- an intent is acknowledged only after its record is appended;
- records carry monotonic seqnos; the sidecar records the seqno its pair
  covers (``journal_seqno``), so resume restores the pair and replays
  the records past it;
- a record whose length or CRC does not check out truncates the scan (a
  kill mid-append costs the one unacknowledged record);
- segments rotate at checkpoint boundaries and closed segments the
  published pair covers are deleted.

Record wire format (little-endian)::

    u32 payload_len | u32 crc32(payload) | payload

with the payload a compact sorted-keys JSON object ``{"seq", "epoch",
"kind", "tick", ...per-kind fields}``. Appends go through an unbuffered
fd; the ``fsync`` policy (:data:`FSYNC_POLICIES`) decides what a power
loss can take: ``"record"`` syncs per append, ``"tick"`` once per driver
tick (:meth:`Journal.tick_barrier`), ``"off"`` never.

A constructed :class:`Journal` never appends to a pre-existing segment:
it scans what is there, keeps the recovered records for the service's
replay, and opens a fresh segment whose seqnos continue the last intact
record. ``fault_hook(event, seq)`` is the fault-injection seam
(``"append_begin"`` / ``"append_mid"`` / ``"append_end"`` / ``"fsync"``).

Stdlib only.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from p2pnetwork_tpu_torch import telemetry

__all__ = ["Journal", "read_records", "clear_segments",
           "FSYNC_POLICIES", "RECORD_KINDS"]

_HEADER = struct.Struct("<II")

#: Admission-plane intent kinds a journal records.
RECORD_KINDS = ("submit", "cancel", "shed", "grow", "delta")

#: What a power loss may take: "record" fsyncs every append, "tick"
#: once per driver tick (default), "off" never (page cache only — a
#: SIGKILL still loses nothing; see the module docstring).
FSYNC_POLICIES = ("record", "tick", "off")


def _segment_name(index: int) -> str:
    return f"journal_{index:06d}.wal"


def _segment_paths(directory: str) -> List[Tuple[int, str]]:
    """``(index, path)`` for every journal segment, index-ordered."""
    out: List[Tuple[int, str]] = []
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        if not (name.startswith("journal_") and name.endswith(".wal")):
            continue
        try:
            idx = int(name[len("journal_"):-len(".wal")])
        except ValueError:
            continue
        out.append((idx, os.path.join(directory, name)))
    out.sort()
    return out


def _scan_segment(path: str) -> Tuple[List[dict], int]:
    """Parse one segment: ``(records, corrupt)`` where ``corrupt`` is 1
    when the scan stopped at a torn/corrupt record (everything after it
    is unreachable — record boundaries are length-prefixed)."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return [], 1
    records: List[dict] = []
    off = 0
    while off < len(blob):
        if off + _HEADER.size > len(blob):
            return records, 1  # torn header
        length, crc = _HEADER.unpack_from(blob, off)
        start = off + _HEADER.size
        end = start + length
        if end > len(blob):
            return records, 1  # torn payload
        payload = blob[start:end]
        if zlib.crc32(payload) != crc:
            return records, 1  # bit rot / overwritten tail
        try:
            doc = json.loads(payload.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            return records, 1
        if not isinstance(doc, dict) or "seq" not in doc:
            return records, 1
        records.append(doc)
        off = end
    return records, 0


def read_records(directory: str) -> Tuple[List[dict], int]:
    """Scan every segment under ``directory`` in order: ``(records,
    corrupt_tail)``. Truncates at the first corrupt record — and, since
    seqnos are contiguous by construction, refuses to leap a gap (a
    segment whose first record does not continue the sequence marks
    everything from it on unrecoverable). Pure read: touches no file
    for writing, creates nothing — safe on a dead service's trail."""
    records: List[dict] = []
    corrupt = 0
    expect: Optional[int] = None
    for _, path in _segment_paths(directory):
        segment, torn = _scan_segment(path)
        for doc in segment:
            seq = int(doc["seq"])
            if expect is not None and seq != expect:
                return records, corrupt + 1
            records.append(doc)
            expect = seq + 1
        corrupt += torn
        if torn:
            # Records beyond a torn segment cannot be contiguous with
            # the recovered prefix (the torn record ate a seqno) — and
            # the next constructed Journal already refused to append
            # after a torn tail, so in practice there is nothing there.
            break
    return records, corrupt


def clear_segments(directory: str) -> None:
    """Delete every journal segment under ``directory`` (fresh-start /
    ``resume=False`` semantics; the service's ``_clear_trail``)."""
    for _, path in _segment_paths(directory):
        try:
            os.unlink(path)
        except OSError:
            pass


class Journal:
    """One directory's write-ahead intent journal (see module doc).

    Parameters
    ----------
    directory:
        Where segments live — the service passes its checkpoint store
        directory, so pair + journal travel as one trail.
    fsync:
        One of :data:`FSYNC_POLICIES` (default ``"tick"``).
    fault_hook:
        Optional ``(event, seq)`` callable, the crash/fault injection
        seam (see module doc). Settable after construction too.
    registry:
        Telemetry registry for the ``serve_journal_*`` families
        (default: the process default registry).
    """

    def __init__(self, directory: str, *, fsync: str = "tick",
                 fault_hook: Optional[Callable[[str, int], None]] = None,
                 registry: Optional[telemetry.Registry] = None):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"fsync policy {fsync!r} not in {FSYNC_POLICIES}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.fsync_policy = fsync
        self.fault_hook = fault_hook
        self.epoch = 0
        self._failed: Optional[str] = None
        self._closed = False
        self._synced = True       # nothing unsynced yet
        self._appended = 0
        self._bytes = 0
        self._fsyncs = 0
        # Recover what a previous life left: records for the service's
        # replay, per-segment last-seqnos for compaction.
        records, corrupt = read_records(self.directory)
        self._recovered = records
        self._corrupt_tail = corrupt
        #: Closed segments (recovered ones included): index ->
        #: (path, last_seq or None when empty/unreadable).
        self._closed_segments: Dict[int, Tuple[str, Optional[int]]] = {}
        # Map each recovered record to its segment for last-seq
        # bookkeeping: re-scan per segment (cheap — already page-hot).
        max_idx = -1
        for idx, path in _segment_paths(self.directory):
            seg, _ = _scan_segment(path)
            last = int(seg[-1]["seq"]) if seg else None
            self._closed_segments[idx] = (path, last)
            max_idx = idx
        last_seq = int(records[-1]["seq"]) if records else 0
        self._next_seq = last_seq + 1
        # Fresh segment for this life's appends (lazy-opened: an idle
        # service creates no file).
        self._cur_index = max_idx + 1
        self._cur_count = 0
        self._cur_last: Optional[int] = None
        self._fd = None
        reg = registry if registry is not None \
            else telemetry.default_registry()
        self._m_appends = reg.counter(
            "serve_journal_appends_total",
            "Admission-plane intent records appended to the write-ahead "
            "journal, by kind.", ("kind",))
        self._m_bytes = reg.counter(
            "serve_journal_bytes_total",
            "Bytes appended to the write-ahead journal (headers "
            "included).")
        self._m_fsyncs = reg.counter(
            "serve_journal_fsyncs_total",
            "fsync barriers issued by the journal (per-record policy "
            "syncs every append; per-tick syncs once per dirty tick).")
        self._m_segments = reg.gauge(
            "serve_journal_segments",
            "Live journal segment files (rotated at checkpoint "
            "boundaries, compacted once the pair covers them).")
        self._m_segments.set(float(len(self._closed_segments)))

    # ---------------------------------------------------------- recovery

    def records(self) -> List[dict]:
        """The records recovered at construction (the replay suffix
        source). Copies — callers may mutate freely."""
        return [dict(r) for r in self._recovered]

    @property
    def last_seq(self) -> int:
        """Seqno of the last appended (or recovered) record; 0 when the
        journal has never held one."""
        return self._next_seq - 1

    @property
    def failed(self) -> Optional[str]:
        """Why this journal refuses appends, or ``None`` while healthy."""
        return self._failed

    # ---------------------------------------------------------- appending

    def _hook(self, event: str, seq: int) -> None:
        if self.fault_hook is not None:
            self.fault_hook(event, seq)

    def _ensure_open(self):
        if self._fd is None:
            # O_EXCL claim with retry: two journal instances over one
            # directory (a promoted standby plus a not-yet-dead zombie
            # primary) must never interleave writes into one segment
            # file — each claims its own, and the seq-continuity check
            # in read_records truncates at the first divergence.
            while True:
                path = os.path.join(self.directory,
                                    _segment_name(self._cur_index))
                try:
                    raw = os.open(path,
                                  os.O_WRONLY | os.O_CREAT | os.O_EXCL
                                  | getattr(os, "O_APPEND", 0), 0o644)
                    break
                except FileExistsError:
                    self._cur_index += 1
            # Unbuffered: every write reaches the kernel immediately, so
            # an appended record survives SIGKILL without any fsync
            # (fsync only matters for power loss — module doc).
            self._fd = os.fdopen(raw, "ab", buffering=0)
            self._m_segments.set(
                float(len(self._closed_segments) + 1))
        return self._fd

    def append(self, kind: str, **fields: Any) -> int:
        """Durably append one intent record; returns its seqno. Raises
        ``OSError`` when the journal is failed/closed or the write
        fails — at which point the record is NOT acknowledged (the tail
        may be torn) and the journal refuses further appends."""
        if self._closed:
            raise OSError(f"journal at {self.directory!r} is closed")
        if self._failed is not None:
            raise OSError(
                f"journal at {self.directory!r} failed previously "
                f"({self._failed}); the segment tail may be torn")
        seq = self._next_seq
        doc = {"seq": seq, "epoch": int(self.epoch), "kind": str(kind)}
        doc.update(fields)
        payload = json.dumps(doc, sort_keys=True,
                             separators=(",", ":")).encode("utf-8")
        header = _HEADER.pack(len(payload), zlib.crc32(payload))
        try:
            fd = self._ensure_open()
            self._hook("append_begin", seq)
            fd.write(header)
            self._hook("append_mid", seq)
            fd.write(payload)
            self._hook("append_end", seq)
            if self.fsync_policy == "record":
                self._do_fsync()
            else:
                self._synced = False
        except BaseException as e:
            # OSError (real or injected disk-full) or a simulated-kill
            # exception: either way bytes may be torn mid-record.
            self._failed = f"{type(e).__name__}: {e}"
            raise
        self._next_seq = seq + 1
        self._cur_count += 1
        self._cur_last = seq
        self._appended += 1
        self._bytes += len(header) + len(payload)
        self._m_appends.labels(str(kind)).inc()
        self._m_bytes.inc(len(header) + len(payload))
        return seq

    def _do_fsync(self) -> None:
        self._hook("fsync", self._next_seq)
        os.fsync(self._fd.fileno())
        self._fsyncs += 1
        self._synced = True
        self._m_fsyncs.inc()

    def tick_barrier(self) -> None:
        """The per-tick durability barrier: under the ``"tick"`` policy,
        fsync once if anything was appended since the last barrier.
        No-op under ``"record"`` (already synced) and ``"off"``."""
        if (self.fsync_policy != "tick" or self._synced
                or self._fd is None or self._failed is not None):
            return
        try:
            self._do_fsync()
        except OSError as e:
            self._failed = f"{type(e).__name__}: {e}"
            raise

    # -------------------------------------------- rotation and compaction

    def rotate(self) -> None:
        """Close the current segment (if it holds records) and start a
        fresh one — called at checkpoint boundaries so compaction works
        on whole segments the new pair covers."""
        if self._fd is None:
            return
        if self._cur_count == 0:
            return  # nothing in it; keep appending here
        path = os.path.join(self.directory,
                            _segment_name(self._cur_index))
        try:
            self._fd.close()
        except OSError:
            pass
        self._closed_segments[self._cur_index] = (path, self._cur_last)
        self._fd = None
        self._cur_index += 1
        self._cur_count = 0
        self._cur_last = None
        self._m_segments.set(float(len(self._closed_segments)))

    def compact(self, covered_seq: int) -> None:
        """Delete closed segments entirely covered by the published
        pair (``last record seq <= covered_seq``) plus empty ones.
        Segments holding any record beyond ``covered_seq`` — e.g.
        journaled-but-unapplied mutations — survive for replay."""
        covered_seq = int(covered_seq)
        for idx in sorted(self._closed_segments):
            path, last = self._closed_segments[idx]
            if last is not None and last > covered_seq:
                continue
            try:
                os.unlink(path)
            except OSError:
                continue  # keep the bookkeeping; retry next boundary
            del self._closed_segments[idx]
        open_seg = 0 if self._fd is None else 1
        self._m_segments.set(
            float(len(self._closed_segments) + open_seg))

    # ------------------------------------------------------------- admin

    def stats(self) -> dict:
        """The ``/stats`` durability sub-document."""
        return {
            "fsync_policy": self.fsync_policy,
            "last_seq": self.last_seq,
            "appended": self._appended,
            "appended_bytes": self._bytes,
            "fsyncs": self._fsyncs,
            "segments": len(self._closed_segments)
            + (0 if self._fd is None else 1),
            "recovered": len(self._recovered),
            "corrupt_tail": self._corrupt_tail,
            "failed": self._failed,
        }

    def reset(self) -> None:
        """Fresh start: drop every segment and recovered record, seqnos
        restart at 1 (``resume=False`` / damaged-trail semantics)."""
        self.close()
        clear_segments(self.directory)
        self._recovered = []
        self._corrupt_tail = 0
        self._closed_segments = {}
        self._next_seq = 1
        self._cur_index = 0
        self._cur_count = 0
        self._cur_last = None
        self._failed = None
        self._closed = False
        self._synced = True
        self._m_segments.set(0.0)

    def close(self) -> None:
        """Close the append fd (final fsync under ``"tick"`` first).
        Idempotent; a closed journal refuses appends."""
        if self._fd is not None:
            if (self.fsync_policy == "tick" and not self._synced
                    and self._failed is None):
                try:
                    self._do_fsync()
                except OSError:
                    pass  # closing anyway; the trail ends here
            try:
                self._fd.close()
            except OSError:
                pass
            self._closed_segments[self._cur_index] = (
                os.path.join(self.directory,
                             _segment_name(self._cur_index)),
                self._cur_last)
            self._fd = None
        self._closed = True
