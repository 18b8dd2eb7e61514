"""graftrace scheduler: deterministic, replayable thread-interleaving
exploration for the seam-routed concurrency plane (the port's copy of
the JAX package's ``analysis/race/sched.py``).

graftlint reasons about lock discipline from the AST; this module
executes it. The shape is loom/Shuttle for this codebase's thread plane:

- Code under test runs in **managed tasks** — real OS threads whose every
  seam primitive operation (:mod:`p2pnetwork_tpu_torch.concurrency` routed
  through :class:`TraceProvider`) is a *yield point*. Exactly one task
  runs between yield points; at each point the scheduler picks the next
  task, so one seeded run IS one totally-ordered schedule.
- The pick policy is **PCT-style random priorities** (Burckhardt et al.,
  ASPLOS 2010): each task draws a random priority at spawn, the
  highest-priority runnable task runs, and priority-change points
  (classic PCT pre-draws ``d-1`` of them over an estimated length; here
  a seeded per-step coin, so the expected count tracks the actual
  schedule length) redraw a random task's priority — cheap, seedable,
  and effective at surfacing ordering bugs within a handful of seeds.
- Every schedule is a **pure function of its seed**: the trace (one
  ``(task, op, target)`` row per step) is recorded, serializable to a
  replay file, and two runs of the same body under the same seed produce
  byte-identical traces — the property the port's graftrace tests pin.

Blocking is modeled, not suffered: a task whose operation cannot proceed
(lock held elsewhere, event unset, queue empty) parks with a wake
predicate; the scheduler never picks it until the predicate holds. When
NOTHING can run, timed waits time out (highest priority first — still
deterministic), and if nothing is timed either, that is a real deadlock:
reported as a P0 finding with every blocked task's site, then unwound by
delivering :class:`DeadlockError` so carrier threads exit.

Wall-clock never enters scheduling decisions — ``sleep`` is a pure yield
point, timeouts fire only at quiescence — so schedules cannot flake on
machine speed.

The scheduler's OWN internals (carrier threads, the per-task handoff
events) must be raw stdlib primitives: instrumenting the instrument
would recurse, hence the inline suppressions.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue as _queue_mod
import random
import sys
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from p2pnetwork_tpu_torch import concurrency
from p2pnetwork_tpu_torch.analysis.core import Finding

__all__ = [
    "DeadlockError", "ScheduleBudgetExceeded", "Scheduler",
    "TraceProvider", "RunResult", "explore", "runtime",
    "write_replay", "load_replay",
]

#: Files whose frames are the instrumentation itself, skipped when
#: attributing a yield/access to a source site.
_INTERNAL_FILES = frozenset({"sched.py", "detector.py", "concurrency.py"})


class DeadlockError(RuntimeError):
    """Delivered into every blocked task when the schedule wedged with no
    runnable and no timed-out wait — unwinds the carrier threads."""


class ScheduleBudgetExceeded(RuntimeError):
    """The schedule ran past ``max_steps`` yield points — a livelock (or
    a scenario that polls forever) rather than a terminating body."""


def call_site() -> Tuple[str, int]:
    """(abs file, line) of the nearest frame OUTSIDE the instrumentation
    — the source line a yield point or tracked access belongs to."""
    f = sys._getframe(1)
    while f is not None:
        base = os.path.basename(f.f_code.co_filename)
        if base not in _INTERNAL_FILES:
            return os.path.abspath(f.f_code.co_filename), f.f_lineno
        f = f.f_back
    return "<unknown>", 0


class _Task:
    __slots__ = ("tid", "name", "state", "resume", "priority", "op",
                 "block_check", "timeout_eligible", "deliver", "exc",
                 "thread", "block_site")

    def __init__(self, tid: int, name: str):
        self.tid = tid
        self.name = name
        self.state = "new"       # new|runnable|blocked|running|finished
        # The carrier handoff pair is raw by necessity (module docstring).
        self.resume = threading.Event()  # graftlint: ignore[raw-concurrency-primitive] -- scheduler internals stay raw
        self.priority = 0.0
        self.op: Tuple[str, str] = ("spawn", name)
        self.block_check: Optional[Callable[[], bool]] = None
        self.timeout_eligible = False
        self.deliver: Any = None          # None | "timeout" | BaseException
        self.exc: Optional[BaseException] = None
        self.thread: Optional[threading.Thread] = None
        self.block_site: Tuple[str, int] = ("<unknown>", 0)


class Scheduler:
    """One seeded exploration of one schedule. See the module docstring
    for the model; use :func:`explore` rather than driving this directly.
    """

    #: Real-time bound on one scheduled step: a managed task that fails
    #: to reach its next yield point in this long called something that
    #: blocks OUTSIDE the seam (a raw lock, a socket) — fail loudly.
    STEP_WALL_TIMEOUT_S = 60.0

    def __init__(self, seed: int = 0, *, detector=None,
                 max_steps: int = 50_000, change_prob: float = 0.1,
                 epsilon: float = 0.25):
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self.detector = detector
        self.max_steps = int(max_steps)
        #: PCT-style policy knob: per-step probability that one random
        #: task's priority is redrawn. Classic PCT pre-draws d-1 change
        #: points over an estimated schedule length; scenario lengths
        #: here span two orders of magnitude, so a per-step coin (same
        #: seeded stream, still fully deterministic) keeps the expected
        #: change count proportional to the actual length instead of
        #: wasting every change point past the end of a short schedule.
        self.change_prob = float(change_prob)
        #: Exploration knob: probability of scheduling a uniformly random
        #: runnable task instead of the highest-priority one. Priorities
        #: alone drive each task through its whole critical section in
        #: one burst (good for depth), but an AB/BA hazard lives in a
        #: ONE-step window between two acquires — the epsilon picks are
        #: what land inside such windows within a handful of seeds.
        self.epsilon = float(epsilon)
        self.tasks: List[_Task] = []
        self.trace: List[Tuple[str, str, str]] = []
        self.findings: List[Finding] = []
        self.errors: List[Tuple[str, BaseException]] = []
        self.steps = 0
        self._control = threading.Event()  # graftlint: ignore[raw-concurrency-primitive] -- scheduler internals stay raw
        self._tls = threading.local()
        # Deterministic labels for primitives: creation order is itself
        # deterministic under the scheduler, so "lock0"/"event2" name the
        # same object in every run of a seed. Pinned refs keep id() from
        # being recycled onto a different object mid-run.
        self._labels: Dict[int, str] = {}
        self._label_counts: Dict[str, int] = {}
        self._pins: List[Any] = []

    # -------------------------------------------------------------- labels

    def label_for(self, obj: Any, kind: str) -> str:
        key = id(obj)
        lab = self._labels.get(key)
        if lab is None:
            n = self._label_counts.get(kind, 0)
            self._label_counts[kind] = n + 1
            lab = f"{kind}{n}"
            self._labels[key] = lab
            self._pins.append(obj)
        return lab

    # --------------------------------------------------------------- tasks

    def current_task(self) -> Optional[_Task]:
        return getattr(self._tls, "task", None)

    def spawn(self, fn: Callable[[], None], name: Optional[str] = None
              ) -> _Task:
        tid = len(self.tasks)
        task = _Task(tid, name or f"T{tid}")
        task.priority = self.rng.random()
        self.tasks.append(task)
        parent = self.current_task()
        if self.detector is not None:
            self.detector.on_spawn(
                parent.tid if parent is not None else None, tid)

        def _body():
            self._tls.task = task
            # Deliberately unbounded: a carrier legitimately waits its
            # whole (virtual) lifetime for its next turn; the SCHEDULER
            # side bounds every step (STEP_WALL_TIMEOUT_S), which is the
            # end that can actually diagnose a wedge.
            task.resume.wait()  # graftlint: ignore[wait-untimed] -- carrier handoff; the scheduler side is the bounded one
            task.resume.clear()
            try:
                self._deliver(task)
                fn()
            except BaseException as e:  # noqa: BLE001 — reported upward
                task.exc = e
            finally:
                task.state = "finished"
                if self.detector is not None:
                    self.detector.on_finish(task.tid)
                self._control.set()

        t = threading.Thread(  # graftlint: ignore[raw-concurrency-primitive] -- carrier threads ARE the scheduler
            target=_body, name=f"graftrace-{task.name}", daemon=True)
        task.thread = t
        task.state = "runnable"
        t.start()
        return task

    # --------------------------------------------------------- yield point

    def yield_point(self, op: str, target: str = "", *,
                    block_check: Optional[Callable[[], bool]] = None,
                    timeout_eligible: bool = False) -> str:
        """Called by instrumented primitives from a managed task: park
        until scheduled (or until ``block_check`` holds). Returns "ok",
        or "timeout" when a quiescent scheduler expired this task's timed
        wait. Raises whatever the scheduler injected (deadlock unwind).
        Unmanaged threads pass straight through ("external")."""
        task = self.current_task()
        if task is None or task.state == "finished":
            return "external"
        task.op = (op, target)
        task.block_site = call_site()
        task.block_check = block_check
        if block_check is not None and not block_check():
            task.state = "blocked"
            task.timeout_eligible = timeout_eligible
        else:
            task.state = "runnable"
        self._control.set()
        task.resume.wait()  # graftlint: ignore[wait-untimed] -- carrier handoff; the scheduler side is the bounded one
        task.resume.clear()
        return self._deliver(task)

    def _deliver(self, task: _Task) -> str:
        d, task.deliver = task.deliver, None
        task.state = "running"
        task.block_check = None
        task.timeout_eligible = False
        if d == "timeout":
            return "timeout"
        if isinstance(d, BaseException):
            raise d
        return "ok"

    # ----------------------------------------------------------- main loop

    def run(self, body: Callable[[], None]) -> None:
        """Drive ``body`` (as the managed "main" task) and everything it
        spawns to completion under one schedule."""
        main = self.spawn(body, name="main")
        while True:
            runnable = [
                t for t in self.tasks
                if t.state == "runnable"
                or (t.state == "blocked" and t.block_check is not None
                    and t.block_check())
            ]
            if not runnable:
                if all(t.state == "finished" for t in self.tasks):
                    break
                blocked = [t for t in self.tasks if t.state == "blocked"]
                timed = [t for t in blocked if t.timeout_eligible]
                if timed:
                    # Quiescent: fire the highest-priority timed wait —
                    # deterministic, and the only moment "time passes".
                    victim = max(timed, key=lambda t: (t.priority, -t.tid))
                    victim.deliver = "timeout"
                    victim.state = "runnable"
                    continue
                self._report_deadlock(blocked)
                for t in blocked:
                    t.deliver = DeadlockError(
                        f"graftrace: schedule deadlocked at step "
                        f"{self.steps} (seed {self.seed})")
                    t.state = "runnable"
                continue
            self.steps += 1
            if self.steps > self.max_steps:
                self._abort_all()
                raise ScheduleBudgetExceeded(
                    f"graftrace: schedule exceeded {self.max_steps} steps "
                    f"(seed {self.seed}) — livelock or unbounded polling")
            if len(self.tasks) > 1 and self.rng.random() < self.change_prob:
                victim = self.tasks[self.rng.randrange(len(self.tasks))]
                victim.priority = self.rng.random()
            if len(runnable) > 1 and self.rng.random() < self.epsilon:
                nxt = runnable[self.rng.randrange(len(runnable))]
            else:
                nxt = max(runnable, key=lambda t: (t.priority, -t.tid))
            self._step(nxt)
        for t in self.tasks:
            if t.exc is not None and not isinstance(t.exc, DeadlockError):
                self.errors.append((t.name, t.exc))

    def _step(self, task: _Task) -> None:
        self.trace.append((task.name,) + task.op)
        task.state = "running"
        self._control.clear()
        task.resume.set()
        if not self._control.wait(timeout=self.STEP_WALL_TIMEOUT_S):
            raise RuntimeError(
                f"graftrace: task {task.name!r} did not reach a yield "
                f"point within {self.STEP_WALL_TIMEOUT_S}s — it is "
                "blocking outside the seam (raw lock? socket? real "
                "sleep?); route the primitive through "
                "p2pnetwork_tpu_torch.concurrency")

    def _abort_all(self) -> None:
        """Best-effort unwind on budget exhaustion: deliver the abort into
        every parked task so carrier threads exit."""
        for t in self.tasks:
            if t.state in ("blocked", "runnable"):
                t.deliver = ScheduleBudgetExceeded("schedule budget")
                t.resume.set()

    def _report_deadlock(self, blocked: List[_Task]) -> None:
        chain = "; ".join(
            f"{t.name} blocked on {t.op[0]} {t.op[1]}".strip()
            for t in sorted(blocked, key=lambda t: t.tid))
        for t in blocked:
            path, line = t.block_site
            self.findings.append(Finding(
                severity="P0", file=_relpath(path), line=line, col=0,
                rule="graftrace-deadlock",
                message=(f"deadlock: {t.name} blocked on "
                         f"{t.op[0]} {t.op[1]} with no runnable task "
                         f"and no timed wait left ({chain})")))


def _repo_root() -> str:
    # <root>/p2pnetwork_tpu_torch/analysis/race/sched.py -> <root>
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))


def _relpath(path: str) -> str:
    """Repo-root-relative path for findings (the baseline keys on these);
    files outside the checkout stay absolute rather than growing ../.."""
    try:
        rel = os.path.relpath(os.path.abspath(path), _repo_root())
    except ValueError:
        return path
    return path if rel.startswith("..") else rel


# ------------------------------------------------------ trace primitives
#
# Each primitive mirrors its threading/queue counterpart's call shape but
# resolves every operation through the scheduler. State mutations happen
# only while the owning task is the single running task, so the model
# itself needs no locking for managed use.


class TraceLock:
    _REENTRANT = False

    def __init__(self, sched: Scheduler, det, kind: str = "lock"):
        self._sched = sched
        self._det = det
        self._label = sched.label_for(self, kind)
        self._owner: Optional[int] = None
        self._count = 0

    def _free_for(self, task: _Task) -> bool:
        return self._owner is None or (
            self._REENTRANT and self._owner == task.tid)

    def acquire(self, blocking: bool = True,
                timeout: Optional[float] = None) -> bool:
        task = self._sched.current_task()
        if task is None:
            raise RuntimeError(
                "graftrace primitives are confined to managed tasks")
        if not blocking:
            # One scheduling point, then an immediate verdict — a
            # try-acquire never parks.
            self._sched.yield_point("try_acquire", self._label)
            return self._take_if_free(task)
        timed = timeout is not None and timeout >= 0
        while True:
            r = self._sched.yield_point(
                "acquire", self._label,
                block_check=lambda: self._free_for(task),
                timeout_eligible=timed)
            if r == "timeout":
                return False
            if self._take_if_free(task):
                return True

    def _take_if_free(self, task: _Task) -> bool:
        if self._owner == task.tid and self._REENTRANT:
            self._count += 1
            return True
        if self._owner is None:
            self._owner = task.tid
            self._count = 1
            if self._det is not None:
                self._det.on_acquire(task.tid, self._label)
            return True
        return False

    def release(self) -> None:
        task = self._sched.current_task()
        if task is None or self._owner != task.tid:
            raise RuntimeError(
                f"release of {self._label} by a non-owner")
        self._count -= 1
        if self._count == 0:
            self._owner = None
            if self._det is not None:
                self._det.on_release(task.tid, self._label)
        self._sched.yield_point("release", self._label)

    def locked(self) -> bool:
        self._sched.yield_point("locked?", self._label)
        return self._owner is not None

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


class TraceRLock(TraceLock):
    _REENTRANT = True

    def __init__(self, sched: Scheduler, det):
        super().__init__(sched, det, kind="rlock")


class TraceCondition:
    """Condition variable over a TraceLock (or a fresh one)."""

    def __init__(self, sched: Scheduler, det, lock: Optional[TraceLock] = None):
        self._sched = sched
        self._det = det
        self._lock = lock if lock is not None else TraceLock(sched, det)
        self._label = sched.label_for(self, "cond")
        self._waiting: set = set()   # live, un-notified tickets
        self._notified: set = set()
        self._waiter_seq = 0

    # Lock-protocol passthrough so ``with cond:`` works.
    def acquire(self, *a, **k):
        return self._lock.acquire(*a, **k)

    def release(self):
        self._lock.release()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self._lock.release()
        return False

    def wait(self, timeout: Optional[float] = None) -> bool:
        task = self._sched.current_task()
        if task is None or self._lock._owner != task.tid:
            raise RuntimeError("cond.wait without holding its lock")
        ticket = self._waiter_seq = self._waiter_seq + 1
        self._waiting.add(ticket)
        saved, self._lock._count = self._lock._count, 0
        self._lock._owner = None
        if self._det is not None:
            self._det.on_release(task.tid, self._lock._label)
        got = "ok" == self._sched.yield_point(
            "cond_wait", self._label,
            block_check=lambda: ticket in self._notified,
            timeout_eligible=timeout is not None)
        # Retire the ticket permanently (a timed-out waiter included) so
        # notify can never re-spend it on a completed wait.
        self._waiting.discard(ticket)
        self._notified.discard(ticket)
        # Reacquire regardless of outcome (the threading contract).
        while True:
            r = self._sched.yield_point(
                "reacquire", self._lock._label,
                block_check=lambda: self._lock._owner is None)
            if self._lock._owner is None:
                self._lock._owner = task.tid
                self._lock._count = saved
                if self._det is not None:
                    self._det.on_acquire(task.tid, self._lock._label)
                break
            del r
        return got

    def notify(self, n: int = 1) -> None:
        task = self._sched.current_task()
        pending = sorted(self._waiting - self._notified)
        for ticket in pending[:n]:
            self._notified.add(ticket)
        if self._det is not None and task is not None:
            self._det.on_event_set(task.tid, self._label)
        self._sched.yield_point("notify", self._label)

    def notify_all(self) -> None:
        self.notify(n=self._waiter_seq)


class TraceEvent:
    def __init__(self, sched: Scheduler, det):
        self._sched = sched
        self._det = det
        self._label = sched.label_for(self, "event")
        self._flag = False

    def set(self) -> None:
        task = self._sched.current_task()
        self._flag = True
        if self._det is not None and task is not None:
            self._det.on_event_set(task.tid, self._label)
        self._sched.yield_point("set", self._label)

    def clear(self) -> None:
        self._flag = False
        self._sched.yield_point("clear", self._label)

    def is_set(self) -> bool:
        self._sched.yield_point("is_set?", self._label)
        return self._flag

    def wait(self, timeout: Optional[float] = None) -> bool:
        task = self._sched.current_task()
        r = self._sched.yield_point(
            "wait", self._label,
            block_check=lambda: self._flag,
            timeout_eligible=timeout is not None)
        if r == "timeout" and not self._flag:
            return False
        if self._det is not None and task is not None:
            self._det.on_event_wait(task.tid, self._label)
        return True


class TraceQueue:
    """FIFO queue with the stdlib's exception contract; each item carries
    its putter's clock so get() inherits a happens-before edge."""

    def __init__(self, sched: Scheduler, det, maxsize: int = 0):
        self._sched = sched
        self._det = det
        self._label = sched.label_for(self, "queue")
        self._maxsize = int(maxsize)
        self._items: List[Tuple[Any, Any]] = []  # (item, putter clock)

    def _has_room(self) -> bool:
        return self._maxsize <= 0 or len(self._items) < self._maxsize

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        task = self._sched.current_task()
        if not block:
            self._sched.yield_point("try_put", self._label)
            if not self._has_room():
                raise _queue_mod.Full
        else:
            r = self._sched.yield_point(
                "put", self._label, block_check=self._has_room,
                timeout_eligible=timeout is not None)
            if not self._has_room():
                if r == "timeout":
                    raise _queue_mod.Full
                return self.put(item, block, timeout)  # spurious resume
        clock = None
        if self._det is not None and task is not None:
            clock = self._det.on_queue_put(task.tid, self._label)
        self._items.append((item, clock))

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get(self, block: bool = True,
            timeout: Optional[float] = None) -> Any:
        task = self._sched.current_task()
        if not block:
            self._sched.yield_point("try_get", self._label)
            if not self._items:
                raise _queue_mod.Empty
        else:
            r = self._sched.yield_point(
                "get", self._label,
                block_check=lambda: bool(self._items),
                timeout_eligible=timeout is not None)
            if not self._items:
                if r == "timeout":
                    raise _queue_mod.Empty
                return self.get(block, timeout)  # spurious resume
        item, clock = self._items.pop(0)
        if self._det is not None and task is not None:
            self._det.on_queue_get(task.tid, self._label, clock)
        return item

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def qsize(self) -> int:
        self._sched.yield_point("qsize?", self._label)
        return len(self._items)

    def empty(self) -> bool:
        self._sched.yield_point("empty?", self._label)
        return not self._items

    def task_done(self) -> None:  # join() accounting is not modeled
        pass


class TraceThread:
    """The threading.Thread call-shape subset the repo uses, running the
    target as a managed task."""

    def __init__(self, sched: Scheduler, det, target=None, name=None,
                 args=(), kwargs=None, daemon=None):
        self._sched = sched
        self._det = det
        self._target = target
        self._args = args
        self._kwargs = kwargs or {}
        # An unnamed thread gets its spawn-order name ("T<tid>") at
        # start(): any per-run-independent counter here would leak
        # process history into trace task names and break the
        # same-seed-byte-identical replay contract.
        self.name = name
        self.daemon = bool(daemon)
        self._task: Optional[_Task] = None

    def _run(self) -> None:
        if self._target is not None:
            self._target(*self._args, **self._kwargs)

    def start(self) -> None:
        if self._task is not None:
            raise RuntimeError("threads can only be started once")
        self._task = self._sched.spawn(self._run, name=self.name)
        self.name = self._task.name  # resolves the T<tid> default
        self._sched.yield_point("start", self.name)

    def join(self, timeout: Optional[float] = None) -> None:
        task = self._sched.current_task()
        child = self._task
        if child is None:
            return
        r = self._sched.yield_point(
            "join", child.name,
            block_check=lambda: child.state == "finished",
            timeout_eligible=timeout is not None)
        if child.state == "finished" and r != "timeout" \
                and self._det is not None and task is not None:
            self._det.on_join(task.tid, child.tid)

    def is_alive(self) -> bool:
        self._sched.yield_point("is_alive?", self.name or "unstarted")
        return self._task is not None and self._task.state != "finished"


class TraceProvider:
    """The :mod:`p2pnetwork_tpu_torch.concurrency` provider graftrace installs:
    every factory returns the instrumented counterpart bound to one
    scheduler/detector pair."""

    def __init__(self, sched: Scheduler, det=None):
        self._sched = sched
        self._det = det if det is not None else sched.detector

    def lock(self):
        return TraceLock(self._sched, self._det)

    def rlock(self):
        return TraceRLock(self._sched, self._det)

    def condition(self, lock=None):
        return TraceCondition(self._sched, self._det, lock)

    def event(self):
        return TraceEvent(self._sched, self._det)

    def thread(self, target=None, name=None, args=(), kwargs=None,
               daemon=None):
        return TraceThread(self._sched, self._det, target=target,
                           name=name, args=args, kwargs=kwargs,
                           daemon=daemon)

    def fifo_queue(self, maxsize: int = 0):
        return TraceQueue(self._sched, self._det, maxsize)

    def sleep(self, seconds: float) -> None:
        # Virtual: a pure scheduling point. No wall time passes, so a
        # schedule can never flake on machine speed.
        self._sched.yield_point("sleep", f"{seconds:g}")


# ------------------------------------------------------------ run driver

_active_lock = threading.Lock()  # graftlint: ignore[raw-concurrency-primitive] -- guards the runtime swap itself
_active: Optional[Tuple[Scheduler, Any]] = None


def runtime() -> Optional[Tuple[Scheduler, Any]]:
    """The (scheduler, detector) of the exploration in flight, if any —
    how Shared cells and watched objects find their reporting sink."""
    with _active_lock:
        return _active


@dataclasses.dataclass
class RunResult:
    """One explored schedule: its seed, trace, findings and errors."""

    seed: int
    steps: int
    trace: List[Tuple[str, str, str]]
    findings: List[Finding]
    errors: List[Tuple[str, str]]
    #: The budget the schedule ran under — recorded into replay files so
    #: a schedule explored with a raised budget replays under the same.
    max_steps: int = 50_000

    @property
    def ok(self) -> bool:
        return not self.findings and not self.errors

    def trace_lines(self) -> List[str]:
        return [" ".join(row).rstrip() for row in self.trace]


def explore(body: Callable[[], None], *, seed: int = 0,
            max_steps: int = 50_000, change_prob: float = 0.1,
            epsilon: float = 0.25, detector=None) -> RunResult:
    """Run ``body`` once under the deterministic scheduler with ``seed``.

    ``body`` executes as the managed main task with the TraceProvider
    installed on the concurrency seam: every primitive it (or the
    library code it drives) constructs through the seam is instrumented,
    every spawned ``concurrency.thread`` becomes a managed task, and the
    detector accumulates happens-before state. Returns the
    :class:`RunResult`; same body + same seed ⇒ identical trace and
    findings (the replay contract).
    """
    global _active
    if detector is None:
        from p2pnetwork_tpu_torch.analysis.race.detector import Detector
        detector = Detector()
    sched = Scheduler(seed=seed, detector=detector, max_steps=max_steps,
                      change_prob=change_prob, epsilon=epsilon)
    provider = TraceProvider(sched, detector)
    with _active_lock:
        if _active is not None:
            raise RuntimeError("explore() does not nest")
        _active = (sched, detector)
    prev = concurrency.install(provider)
    try:
        sched.run(body)
    finally:
        concurrency.install(prev)
        with _active_lock:
            _active = None
    findings = sorted(set(detector.findings) | set(sched.findings))
    errors = [(name, f"{type(e).__name__}: {e}")
              for name, e in sched.errors]
    return RunResult(seed=seed, steps=sched.steps, trace=list(sched.trace),
                     findings=findings, errors=errors, max_steps=max_steps)


# ------------------------------------------------------------ replay I/O

def write_replay(path: str, scenario: str, result: RunResult) -> str:
    """Persist one schedule so a failing interleaving reruns from its
    seed: the seed is the authority, the recorded trace is the oracle a
    replay is checked byte-for-byte against."""
    doc = {
        "scenario": scenario,
        "seed": result.seed,
        "steps": result.steps,
        "max_steps": result.max_steps,
        "trace": [list(row) for row in result.trace],
        "findings": [f.to_json() for f in result.findings],
        "errors": list(result.errors),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return path


def load_replay(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if "scenario" not in doc or "seed" not in doc or "trace" not in doc:
        raise ValueError(f"{path}: not a graftrace replay file")
    return doc
