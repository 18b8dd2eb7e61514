"""Deliberately-racy / clean-twin fixture bodies for the port's graftrace
tests: ``tests/graftrace_fixtures.py`` on the port's seam, line for line
below this docstring, so the same bodies run under both packages'
schedulers.

One pair per happens-before edge kind the detector derives:
release→acquire (lock), thread start, thread join, event set→wait, and
queue put→get. Each racy body carries exactly one ``# RACY`` marker on
the access the detector must anchor its finding at — the tests assert
the finding's ``file:line`` equals that marker's line, pinning not just
"a race was found" but "found at the right source line". Clean twins
differ only by the synchronization that orders the same accesses.

Also registered as (non-builtin) graftrace scenarios so the CLI tests
can drive them through ``--scenarios-from`` and prove the nonzero exit.
"""

from p2pnetwork_tpu_torch import concurrency
from p2pnetwork_tpu_torch.analysis.race import Shared
from p2pnetwork_tpu_torch.analysis.race.scenarios import scenario


def _pair(target_a, target_b):
    t1 = concurrency.thread(target=target_a, name="A")
    t2 = concurrency.thread(target=target_b, name="B")
    t1.start()
    t2.start()
    t1.join()
    t2.join()


# ---------------------------------------------------------- lock edge

def lock_racy():
    cell = Shared(0, label="cell")
    lk = concurrency.lock()

    def a():
        with lk:
            cell.set(cell.get() + 1)

    def b():
        cell.set(5)  # RACY

    _pair(a, b)


def lock_clean():
    cell = Shared(0, label="cell")
    lk = concurrency.lock()

    def a():
        with lk:
            cell.set(cell.get() + 1)

    def b():
        with lk:
            cell.set(5)

    _pair(a, b)


# --------------------------------------------------------- start edge

def start_racy():
    cell = Shared(0, label="cell")

    def r():
        cell.get()

    t = concurrency.thread(target=r, name="R")
    t.start()
    cell.set(1)  # RACY
    t.join()


def start_clean():
    cell = Shared(0, label="cell")
    cell.set(1)  # before start: ordered by the spawn edge

    def r():
        cell.get()

    t = concurrency.thread(target=r, name="R")
    t.start()
    t.join()


# ---------------------------------------------------------- join edge

def join_racy():
    cell = Shared(0, label="cell")

    def w():
        cell.set(1)

    t = concurrency.thread(target=w, name="W")
    t.start()
    cell.get()  # RACY
    t.join()


def join_clean():
    cell = Shared(0, label="cell")

    def w():
        cell.set(1)

    t = concurrency.thread(target=w, name="W")
    t.start()
    t.join()
    cell.get()  # after join: ordered by the join edge


# --------------------------------------------------------- event edge

def event_racy():
    cell = Shared(0, label="cell")
    ev = concurrency.event()

    def w():
        cell.set(1)
        ev.set()

    def r():
        cell.get()  # RACY

    _pair(w, r)


def event_clean():
    cell = Shared(0, label="cell")
    ev = concurrency.event()

    def w():
        cell.set(1)
        ev.set()

    def r():
        ev.wait()
        cell.get()  # ordered by set -> wait

    _pair(w, r)


# --------------------------------------------------------- queue edge

def queue_racy():
    cell = Shared(0, label="cell")
    q = concurrency.fifo_queue()

    def p():
        cell.set(1)
        q.put("token")

    def c():
        cell.get()  # RACY

    _pair(p, c)


def queue_clean():
    cell = Shared(0, label="cell")
    q = concurrency.fifo_queue()

    def p():
        cell.set(1)
        q.put("token")

    def c():
        q.get()
        cell.get()  # ordered by put -> get

    _pair(p, c)


TWINS = {
    "lock": (lock_racy, lock_clean),
    "start": (start_racy, start_clean),
    "join": (join_racy, join_clean),
    "event": (event_racy, event_clean),
    "queue": (queue_racy, queue_clean),
}


# CLI-drivable registrations (non-builtin: never part of the CI gate).

@scenario("fixture_lock_racy",
          "deliberately racy lock twin (test fixture)", builtin=False)
def _fixture_lock_racy():
    return lock_racy


@scenario("fixture_lock_clean",
          "clean lock twin (test fixture)", builtin=False)
def _fixture_lock_clean():
    return lock_clean
