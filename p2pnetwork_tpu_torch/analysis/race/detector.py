"""graftrace detector: vector-clock happens-before race detection over
one explored schedule (the port's copy of the JAX package's
``analysis/race/detector.py``).

The scheduler (sched.py) serializes managed tasks; this module decides
which of the serialized accesses were ordered by *synchronization* and
which merely by the coin flip of the schedule. Standard vector-clock
happens-before (FastTrack's epoch comparison, without its shadow-word
compression — schedules here are test-sized):

- every task carries a clock ``{tid: count}``, ticked per operation;
- **release → acquire**: a lock stores its releaser's clock; an acquirer
  joins it — two critical sections of one lock are always ordered;
- **start / join**: a spawned task inherits its parent's clock; a join
  folds the child's final clock back into the joiner;
- **event set → wait**: an event accumulates every setter's clock; a
  successful wait joins it (conditions' notify/wait map to the same
  edge);
- **queue put → get**: each item carries its putter's clock; the getter
  joins it.

Tracked shared state is declared, not inferred at runtime: either
explicitly (:class:`Shared` cells, the fixture-grade form with exact
source lines) or by :func:`watch`, which auto-tracks the attributes
graftlint's lock model already inventories as lock-guarded (an attribute
somewhere mutated under a held lock) on any instance — intercepting
reads/writes via a generated subclass, with container values wrapped so
``d[k] = v`` counts as the write it is. Two conflicting accesses (at
least one write) whose clocks are unordered are a race: reported as a
P0 :class:`~p2pnetwork_tpu_torch.analysis.core.Finding` at the racing access's
``file:line``, naming both sites and both held locksets, flowing through
the same severity/baseline/suppression machinery as graftlint.

Soundness note: in the OBSERVED schedule, HB detection has no false
positives — accesses consistently guarded by any one lock are always
ordered through that lock's clock. Accumulated event clocks and the
explored-schedule set bound the false-*negative* rate; that is what
``--schedules K`` buys down.
"""

from __future__ import annotations

import inspect
import os
from typing import Any, Dict, FrozenSet, List, Optional, Set, Tuple

from p2pnetwork_tpu_torch.analysis import core
from p2pnetwork_tpu_torch.analysis.concurrency import _concurrency
from p2pnetwork_tpu_torch.analysis.core import Finding, Module
from p2pnetwork_tpu_torch.analysis.race import sched as _sched

__all__ = ["Detector", "Shared", "watch", "guarded_attrs",
           "RACE_RULE", "DEADLOCK_RULE", "ERROR_RULE"]

RACE_RULE = "graftrace-race"
DEADLOCK_RULE = "graftrace-deadlock"
ERROR_RULE = "graftrace-error"

#: Container methods that mutate in place — the same vocabulary
#: graftlint's lock model uses to classify guarded-state writes.
from p2pnetwork_tpu_torch.analysis.concurrency import _MUTATORS as _WRITE_METHODS


# ------------------------------------------------------------ vector clocks

def _join(into: Dict[int, int], other: Dict[int, int]) -> None:
    for tid, c in other.items():
        if c > into.get(tid, 0):
            into[tid] = c


def _ordered_before(epoch: Tuple[int, int], clock: Dict[int, int]) -> bool:
    """Did the access at ``epoch = (tid, count)`` happen-before a task
    whose current clock is ``clock``? The standard epoch test."""
    tid, count = epoch
    return count <= clock.get(tid, 0)


class _Access:
    __slots__ = ("tid", "epoch", "site", "lockset", "is_write")

    def __init__(self, tid: int, epoch: Tuple[int, int],
                 site: Tuple[str, int], lockset: FrozenSet[str],
                 is_write: bool):
        self.tid = tid
        self.epoch = epoch
        self.site = site
        self.lockset = lockset
        self.is_write = is_write


class Detector:
    """Happens-before state for one schedule; the scheduler drives the
    ``on_*`` hooks, tracked state drives :meth:`access`."""

    def __init__(self):
        self.clocks: Dict[int, Dict[int, int]] = {}
        self.locksets: Dict[int, Set[str]] = {}
        self.lock_clocks: Dict[str, Dict[int, int]] = {}
        self.event_clocks: Dict[str, Dict[int, int]] = {}
        self.finish_clocks: Dict[int, Dict[int, int]] = {}
        # var key -> (last write, reads since that write)
        self.vars: Dict[str, Tuple[Optional[_Access], List[_Access]]] = {}
        self.findings: List[Finding] = []
        self._reported: Set[Tuple] = set()
        self._task_names: Dict[int, str] = {}

    # ------------------------------------------------------ schedule hooks

    def _tick(self, tid: int) -> None:
        clock = self.clocks.setdefault(tid, {tid: 0})
        clock[tid] = clock.get(tid, 0) + 1

    def on_spawn(self, parent: Optional[int], tid: int) -> None:
        clock = dict(self.clocks.get(parent, {})) if parent is not None \
            else {}
        clock[tid] = 1
        self.clocks[tid] = clock
        self.locksets[tid] = set()
        if parent is not None:
            self._tick(parent)

    def on_finish(self, tid: int) -> None:
        self.finish_clocks[tid] = dict(self.clocks.get(tid, {}))

    def on_join(self, tid: int, child: int) -> None:
        _join(self.clocks.setdefault(tid, {tid: 0}),
              self.finish_clocks.get(child, self.clocks.get(child, {})))
        self._tick(tid)

    def on_acquire(self, tid: int, label: str) -> None:
        _join(self.clocks.setdefault(tid, {tid: 0}),
              self.lock_clocks.get(label, {}))
        self.locksets.setdefault(tid, set()).add(label)
        self._tick(tid)

    def on_release(self, tid: int, label: str) -> None:
        self._tick(tid)
        self.lock_clocks[label] = dict(self.clocks.get(tid, {}))
        self.locksets.setdefault(tid, set()).discard(label)

    def on_event_set(self, tid: int, label: str) -> None:
        self._tick(tid)
        _join(self.event_clocks.setdefault(label, {}),
              self.clocks.get(tid, {}))

    def on_event_wait(self, tid: int, label: str) -> None:
        _join(self.clocks.setdefault(tid, {tid: 0}),
              self.event_clocks.get(label, {}))
        self._tick(tid)

    def on_queue_put(self, tid: int, label: str) -> Dict[int, int]:
        self._tick(tid)
        return dict(self.clocks.get(tid, {}))

    def on_queue_get(self, tid: int, label: str,
                     clock: Optional[Dict[int, int]]) -> None:
        if clock:
            _join(self.clocks.setdefault(tid, {tid: 0}), clock)
        self._tick(tid)

    # ------------------------------------------------------------- accesses

    def access(self, tid: int, var: str, is_write: bool,
               site: Tuple[str, int]) -> None:
        """One read/write of tracked variable ``var`` by task ``tid`` at
        ``site``; checks it against every conflicting prior access not
        ordered before the current clock."""
        clock = self.clocks.setdefault(tid, {tid: 0})
        self._tick(tid)
        cur = _Access(tid, (tid, clock[tid]), site,
                      frozenset(self.locksets.get(tid, ())), is_write)
        last_write, reads = self.vars.get(var, (None, []))
        if last_write is not None and last_write.tid != tid \
                and not _ordered_before(last_write.epoch, clock):
            self._report(var, last_write, cur)
        if is_write:
            for r in reads:
                if r.tid != tid and not _ordered_before(r.epoch, clock):
                    self._report(var, r, cur)
            self.vars[var] = (cur, [])
        else:
            # One live read per task is enough: a newer read of the same
            # task supersedes the older for HB purposes.
            reads = [r for r in reads if r.tid != tid] + [cur]
            self.vars[var] = (last_write, reads)

    def _report(self, var: str, prev: _Access, cur: _Access) -> None:
        key = (var, prev.site, cur.site, prev.is_write, cur.is_write)
        if key in self._reported:
            return
        self._reported.add(key)
        path, line = cur.site
        pfile, pline = prev.site
        verb = "write" if cur.is_write else "read"
        pverb = "write" if prev.is_write else "read"
        locks = ",".join(sorted(cur.lockset)) or "no locks"
        plocks = ",".join(sorted(prev.lockset)) or "no locks"
        self.findings.append(Finding(
            severity="P0", file=_sched._relpath(path), line=line, col=0,
            rule=RACE_RULE,
            message=(f"unordered {verb} of {var} (held: {locks}) races "
                     f"a {pverb} at {_sched._relpath(pfile)}:{pline} "
                     f"(held: {plocks}) — no happens-before edge "
                     "(lock, start/join, event, queue) orders them")))


# ---------------------------------------------------------------- Shared

class Shared:
    """An explicitly declared shared cell — the ``track()`` primitive in
    its simplest form. ``get``/``set`` are scheduling points and tracked
    accesses, so the racy fixture's ``cell.set(...)`` line is exactly
    where a finding anchors. Outside an exploration it is just a box."""

    __slots__ = ("_value", "_label")

    def __init__(self, value: Any = None, label: Optional[str] = None):
        self._value = value
        self._label = str(label) if label is not None else None

    def _var(self) -> str:
        # Unlabeled cells resolve to a per-object creation-order label
        # ("shared0", "shared1", ...) under the active scheduler:
        # keying two distinct cells on one literal would alias them into
        # a single detector variable and fabricate races between
        # unrelated data.
        if self._label is not None:
            return self._label
        rt = _sched.runtime()
        if rt is None:
            return "shared"
        return rt[0].label_for(self, "shared")

    def get(self) -> Any:
        _report_access(self._var(), False)
        return self._value

    def set(self, value: Any) -> None:
        _report_access(self._var(), True)
        self._value = value


def _report_access(var: str, is_write: bool) -> None:
    rt = _sched.runtime()
    if rt is None:
        return
    scheduler, det = rt
    task = scheduler.current_task()
    if task is None:
        return
    site = _sched.call_site()
    scheduler.yield_point("write" if is_write else "read", var)
    det.access(task.tid, var, is_write, site)


# ----------------------------------------------------------------- watch

#: Parsed-module cache for guarded-attribute inference (keyed by file).
_module_cache: Dict[str, Optional[Module]] = {}  # graftlint: ignore[unbounded-cache] -- keyed by source file path; bounded by the finite set of modules the process imports


def _module_for(cls: type) -> Optional[Module]:
    try:
        path = inspect.getsourcefile(cls)
    except TypeError:
        return None
    if path is None:
        return None
    path = os.path.abspath(path)
    if path not in _module_cache:
        try:
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
            _module_cache[path] = Module(path, source,
                                         relpath=_sched._relpath(path))
        except (OSError, SyntaxError, ValueError):
            _module_cache[path] = None
    return _module_cache[path]


def guarded_attrs(cls: type) -> Dict[str, Set[str]]:
    """``{attr: {lock ids}}`` for every attribute some method of ``cls``
    (or an ancestor) mutates while holding a lock — the same inventory
    graftlint's lock-guard rule builds, reused as the auto-tracking set.
    Lock attributes themselves are excluded (they are the guards)."""
    out: Dict[str, Set[str]] = {}
    for klass in cls.__mro__:
        if klass is object:
            continue
        module = _module_for(klass)
        if module is None:
            continue
        conc = _concurrency(module)
        lock_attrs = set(conc.class_locks.get(klass.__name__, ()))
        for summary in conc.summaries.values():
            if summary.class_name != klass.__name__:
                continue
            for attr, _site, held, mutation in summary.attr_access:
                if mutation and held and attr not in lock_attrs:
                    out.setdefault(attr, set()).update(held)
    return out


class _TrackedContainer:
    """Wraps a container value of a watched attribute so its operations
    report as reads/writes of that attribute (``d[k] = v`` through the
    attribute is a write of the guarded state, which plain
    ``__getattribute__`` interception would misread as a read)."""

    __slots__ = ("_obj", "_var")

    def __init__(self, obj: Any, var: str):
        object.__setattr__(self, "_obj", obj)
        object.__setattr__(self, "_var", var)

    def __getattr__(self, name: str) -> Any:
        obj = object.__getattribute__(self, "_obj")
        var = object.__getattribute__(self, "_var")
        target = getattr(obj, name)
        if callable(target):
            is_write = name in _WRITE_METHODS

            def call(*a, **k):
                _report_access(var, is_write)
                return target(*a, **k)
            return call
        _report_access(var, False)
        return target

    def _read(self):
        _report_access(object.__getattribute__(self, "_var"), False)
        return object.__getattribute__(self, "_obj")

    def _write(self):
        _report_access(object.__getattribute__(self, "_var"), True)
        return object.__getattribute__(self, "_obj")

    def __getitem__(self, k):
        return self._read()[k]

    def __setitem__(self, k, v):
        self._write()[k] = v

    def __delitem__(self, k):
        del self._write()[k]

    def __contains__(self, k):
        return k in self._read()

    def __iter__(self):
        return iter(self._read())

    def __len__(self):
        return len(self._read())

    def __bool__(self):
        return bool(self._read())

    def __eq__(self, other):
        return self._read() == other

    def __ne__(self, other):
        return self._read() != other

    def __repr__(self):
        return repr(object.__getattribute__(self, "_obj"))

    def __hash__(self):
        return hash(object.__getattribute__(self, "_obj"))

    def __ior__(self, other):  # set |= / tombs |= ...
        obj = self._write()
        obj |= other
        object.__setattr__(self, "_obj", obj)
        return self


import collections as _collections

#: Container values of watched attributes get the mutation-aware proxy.
#: deque matters: EventLog and phi's arrival windows are deque-backed,
#: and an unwrapped deque's append would classify as a read — exactly
#: the "deque mutated during iteration" race class going invisible.
_CONTAINER_TYPES = (dict, list, set, _collections.deque)


def watch(obj: Any, attrs: Optional[Set[str]] = None,
          label: Optional[str] = None) -> Any:
    """Auto-track ``obj``'s lock-guarded attributes (or an explicit
    ``attrs`` set) for the active exploration, in place.

    The instance's class is swapped for a generated subclass whose
    ``__getattribute__``/``__setattr__`` report tracked accesses to the
    detector (each a scheduling point) before delegating; container
    values come back wrapped so mutations classify as writes. Returns
    ``obj`` for chaining. A no-op set of attrs leaves the object
    untouched."""
    if getattr(type(obj), "_graftrace_tracked", None) is not None:
        return obj  # already watched — idempotent
    tracked = set(attrs) if attrs is not None else \
        set(guarded_attrs(type(obj)))
    if not tracked:
        return obj
    rt = _sched.runtime()
    if rt is None:
        return obj
    scheduler, _det = rt
    base = type(obj)
    prefix = label if label is not None else \
        scheduler.label_for(obj, base.__name__)
    tracked_fs = frozenset(tracked)

    def var_of(name: str) -> str:
        return f"{prefix}.{name}"

    def __getattribute__(self, name):
        value = base.__getattribute__(self, name)
        if name in tracked_fs:
            _report_access(var_of(name), False)
            if isinstance(value, _CONTAINER_TYPES):
                return _TrackedContainer(value, var_of(name))
        return value

    def __setattr__(self, name, value):
        if name in tracked_fs:
            _report_access(var_of(name), True)
        base.__setattr__(self, name, value)

    watched = type(f"Watched{base.__name__}", (base,), {
        "__slots__": (),
        "__getattribute__": __getattribute__,
        "__setattr__": __setattr__,
        "_graftrace_tracked": tracked_fs,
    })
    obj.__class__ = watched
    return obj
