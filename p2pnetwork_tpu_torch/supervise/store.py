"""Atomic checkpoint directory on top of ``sim/checkpoint.py`` (the port's
copy of ``p2pnetwork_tpu/supervise/store.py``; same file names and
manifest layout).

:class:`CheckpointStore` keeps a small rotation instead of one file:

- every entry is its own content-hashed file
  (``ckpt_r<round>_<sha12>.npz``), written atomically, never rewritten;
- ``manifest.json`` (``{"version", "latest", "entries": [{"file",
  "round", "message_count", "sha256"}]}``) is updated by atomic rename
  AFTER the entry lands, so a kill between the two leaves the previous
  manifest and at worst one orphaned, loadable entry;
- retention keeps the last ``retain`` entries, pruning oldest-first;
- resume (:meth:`CheckpointStore.load_latest`) walks entries
  newest-first, verifying the manifest's file hash and the in-file
  digest, and skips corrupt, partial or missing entries.

The store moves ``(state, key, round, message_count)`` tuples, the
``sim/checkpoint.py`` contract; ``supervise/runner.py`` owns cadence and
resume policy.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import warnings
from typing import Any, Dict, List, Optional, Tuple

from p2pnetwork_tpu_torch import concurrency, telemetry
from p2pnetwork_tpu_torch.sim import checkpoint as ckpt
from p2pnetwork_tpu_torch.telemetry import spans

__all__ = ["CheckpointStore", "atomic_write_json"]

_MANIFEST = "manifest.json"


def atomic_write_json(path: str, doc: Any, *,
                      suffix: str = ".json.tmp",
                      durable: bool = True) -> None:
    """Rename-publish ``doc`` as JSON at ``path``: tmp file in the same
    directory, ``os.replace``, tmp unlinked on failure. The ONE home of
    this crash-safety pattern — the manifest below and graftserve's
    sidecar (serve/service.py) both publish through it, so the graftdur
    hardening below landed everywhere at once.

    ``durable=True`` (default) closes the power-loss windows a bare
    rename leaves open: the temp file is fsynced BEFORE the rename (so
    the name can never point at unwritten bytes) and the directory
    entry is fsynced AFTER it (so the publish itself survives the
    cut). A SIGKILL never needed either — the rename is atomic in the
    page cache — so callers on the hot path that only fear kills (not
    power) may pass ``durable=False`` and skip both syncs. The
    directory fsync is best-effort: some filesystems refuse
    ``open(O_RDONLY)`` on directories, and losing IT costs only the
    rename, never consistency."""
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(path)), suffix=suffix)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1)
            if durable:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    if durable:
        try:
            dfd = os.open(os.path.dirname(os.path.abspath(path)),
                          os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(dfd)
        except OSError:
            pass
        finally:
            os.close(dfd)


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


class CheckpointStore:
    """A retention-bounded directory of content-hashed checkpoints.

    Single-*process* by design (one supervised run owns one directory),
    but not single-thread: ``emergency_checkpoint`` is documented safe
    from a watchdog ``on_stall`` hook, so the manifest read-modify-write
    in :meth:`save` is serialized by a lock. Readers (resume, the bench
    parent publishing a partial record) only ever see complete files
    because both the entries and the manifest are rename-published.
    """

    def __init__(self, directory: str, *, retain: int = 3,
                 registry: Optional[telemetry.Registry] = None):
        if retain < 1:
            raise ValueError("retain must be >= 1")
        self.directory = os.path.abspath(directory)
        self.retain = int(retain)
        os.makedirs(self.directory, exist_ok=True)
        # Serializes the manifest read-modify-write: the run thread's
        # boundary save can race an emergency_checkpoint fired from the
        # watchdog's on_stall thread.
        self._save_lock = concurrency.lock()
        reg = registry if registry is not None else telemetry.default_registry()
        self._m_written = reg.counter(
            "supervise_checkpoints_written_total",
            "Checkpoint entries durably published by supervised runs.")
        self._m_skipped = reg.counter(
            "supervise_checkpoints_skipped_total",
            "Checkpoint entries skipped during resume, by cause (corrupt "
            "in-file digest, manifest/file hash mismatch, missing file, "
            "template mismatch; manifest-missing counts a resume that "
            "fell back to a directory scan because the manifest itself "
            "was gone or unreadable).", ("reason",))

    # -------------------------------------------------------------- writing

    def save(self, state: Any, key, round_index: int,
             message_count: int = 0) -> str:
        """Durably publish one checkpoint entry; returns its path.

        Write order is the crash-safety argument: (1) the entry lands
        under a temp name via ``checkpoint.save`` (itself atomic), (2) it
        is renamed to its content-hashed final name, (3) the manifest is
        rename-replaced to reference it, (4) retention prunes. A SIGKILL
        after any step leaves a loadable store."""
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".entry.tmp")
        os.close(fd)
        try:
            ckpt.save(tmp, state, key, round_index, message_count)
            sha = _file_sha256(tmp)
            fname = f"ckpt_r{int(round_index):012d}_{sha[:12]}.npz"
            final = os.path.join(self.directory, fname)
            os.replace(tmp, final)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        with self._save_lock:
            entries = [e for e in self._read_manifest()
                       if e.get("file") != fname]
            new = {"file": fname, "round": int(round_index),
                   "message_count": int(message_count), "sha256": sha}
            entries.append(new)
            entries.sort(key=lambda e: (e["round"], e["file"]))
            keep = entries[-self.retain:]
            if new not in keep:
                # The fresh entry sorted below the retained window (a
                # stale higher-round trail shares the directory —
                # resume=False reuse; the runner clears such trails, this
                # is the store-level backstop): a save must never prune
                # ITS OWN checkpoint, so evict the oldest survivor
                # instead. `new` has the lowest round of `keep`, so
                # prepending preserves round order.
                keep = [new] + keep[1:] if self.retain > 1 else [new]
            pruned = [e for e in entries if e not in keep]
            self._write_manifest(keep)
        for e in pruned:
            try:
                os.unlink(os.path.join(self.directory, e["file"]))
            except OSError:
                pass  # already gone — retention is best-effort cleanup
        self._m_written.inc()
        return final

    def clear(self) -> None:
        """Delete every entry and the manifest — the fresh-trail reset.

        The runner calls this when a run starts from round 0 into a
        directory that still holds a previous trail (``resume=False``, or
        every prior entry proved unloadable): two interleaved trails in
        one manifest would make ``load_latest`` resume the WRONG run the
        moment the stale trail's rounds are higher."""
        with self._save_lock:
            for name in list(os.listdir(self.directory)):  # graftlint: ignore[lock-open-call] -- serializing store mutation against concurrent save() IS this lock's job; local fs ops, bounded
                if name == _MANIFEST or (name.startswith("ckpt_r")
                                         and name.endswith(".npz")):
                    try:
                        os.unlink(os.path.join(self.directory, name))  # graftlint: ignore[lock-open-call] -- same: the clear must be atomic w.r.t. save
                    except OSError:
                        pass  # already gone

    def _write_manifest(self, entries: List[Dict[str, Any]]) -> None:
        doc = {"version": 1,
               "latest": entries[-1]["file"] if entries else None,
               "entries": entries}
        atomic_write_json(os.path.join(self.directory, _MANIFEST), doc,
                          suffix=".manifest.tmp")

    # -------------------------------------------------------------- reading

    def _read_manifest(self) -> List[Dict[str, Any]]:
        """Manifest entries oldest-first; [] when absent/unreadable (the
        resume path then falls back to a directory scan)."""
        path = os.path.join(self.directory, _MANIFEST)
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
            entries = doc.get("entries", [])
            return [e for e in entries
                    if isinstance(e, dict) and "file" in e and "round" in e]
        except (OSError, ValueError):
            return []

    def _scan_entries(self) -> List[Dict[str, Any]]:
        """Directory-scan fallback when the manifest is gone: every
        ``ckpt_r*.npz`` present, oldest-first, hashes unvalidated at the
        manifest level (the in-file digest still guards each load)."""
        found = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        for name in names:
            if not (name.startswith("ckpt_r") and name.endswith(".npz")):
                continue
            try:
                rnd = int(name[len("ckpt_r"):].split("_")[0])
            except ValueError:
                continue
            found.append({"file": name, "round": rnd, "sha256": None})
        found.sort(key=lambda e: (e["round"], e["file"]))
        return found

    def entries(self) -> List[Dict[str, Any]]:
        """Manifest entries oldest-first (directory scan if no manifest)."""
        return self._read_manifest() or self._scan_entries()

    def latest_round(self) -> Optional[int]:
        ents = self.entries()
        return int(ents[-1]["round"]) if ents else None

    def load_latest(self, template: Any, *, grow: bool = False) -> Optional[
            Tuple[Any, Any, int, int, str]]:
        """Restore the newest loadable checkpoint, skipping damage.

        Walks entries newest-first; each candidate must (a) exist, (b)
        match the manifest's file hash when one is recorded, and (c) pass
        ``checkpoint.load``'s in-file digest and structure checks. Any
        failure skips to the next-older entry (counted into
        ``supervise_checkpoints_skipped_total{reason}``). ``grow=True``
        accepts repad-compatible entries written before a ``Graph.grow``
        capacity change (leaves zero-extended into the template's grown
        shapes via ``checkpoint.grow_state``); entries that cannot grow
        into the template still skip as ``template_mismatch``. A resume whose
        manifest is gone/unreadable but whose directory still holds
        entries falls back to the scan, counted once as
        ``{reason="manifest-missing"}``, and the entry it recovers is
        logged (warning + ``store_scan_recovery`` trace event) — damage
        survived should be visible, not silent. Returns
        ``(state, key, round_index, message_count, path)``, or ``None``
        when no entry is loadable (fresh start)."""
        ents = self._read_manifest()
        scan_fallback = False
        if not ents:
            ents = self._scan_entries()
            if ents:
                # A trail with no manifest is damage (the manifest is
                # rename-published after every entry), not a fresh dir —
                # count the fallback; an empty directory stays silent.
                scan_fallback = True
                self._m_skipped.labels("manifest-missing").inc()
        for entry in reversed(ents):
            path = os.path.join(self.directory, entry["file"])
            if not os.path.exists(path):
                self._m_skipped.labels("missing").inc()
                continue
            recorded = entry.get("sha256")
            if recorded is not None and _file_sha256(path) != recorded:
                self._m_skipped.labels("hash_mismatch").inc()
                continue
            try:
                state, key, rnd, msgs = ckpt.load(path, template, grow=grow)
            except ckpt.CheckpointCorrupt:
                self._m_skipped.labels("corrupt").inc()
                continue
            except ValueError:
                # Structure mismatch: the file is intact but from another
                # protocol/graph — a caller problem, but resume-over-
                # damage semantics say keep walking, counted distinctly.
                self._m_skipped.labels("template_mismatch").inc()
                continue
            if scan_fallback:
                warnings.warn(
                    f"checkpoint manifest missing/unreadable in "
                    f"{self.directory}; recovered entry "
                    f"{entry['file']!r} (round {rnd}) via directory "
                    f"scan", RuntimeWarning, stacklevel=2)
                if spans.current_tracer() is not None:
                    spans.emit("store_scan_recovery", round=int(rnd),
                               path=path)
            return state, key, rnd, msgs, path
        return None
