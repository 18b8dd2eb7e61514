"""The port's graftrace (``p2pnetwork_tpu_torch/analysis/race/``) held
against the JAX package's: on the reference's five fixture pairs (one per
happens-before edge kind), for seeds 0-7, the port's ``explore`` gives the
same schedule, line for line, and the same findings, each racy one
anchored at its file's ``# RACY`` line; replay files, the deadlock and
budget paths, the detector's inventory of the port's classes, and the
CLI.

The fixtures are ``tests/graftrace_fixtures.py`` for the reference and
its copy on the port's seam, ``tests/torch_graftrace_fixtures.py``, for
the port. Findings are compared with each file's lines taken relative to
its first body (the copy's docstring is longer) and the package names
folded.
"""

import json
import os
import re
import sys

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import graftrace_fixtures as ref_fx  # noqa: E402
import torch_graftrace_fixtures as fx  # noqa: E402
from p2pnetwork_tpu.analysis.race import explore as ref_explore  # noqa: E402
from p2pnetwork_tpu_torch import concurrency, telemetry  # noqa: E402
from p2pnetwork_tpu_torch.analysis.race import (  # noqa: E402
    DEADLOCK_RULE, RACE_RULE, Detector, ScheduleBudgetExceeded, Shared,
    explore, guarded_attrs, load_replay, watch, write_replay,
)
from p2pnetwork_tpu_torch.analysis.race.__main__ import (  # noqa: E402
    main as graftrace_main, run_battery,
)
from p2pnetwork_tpu_torch.analysis.race.scenarios import (  # noqa: E402
    SCENARIOS, builtin_names, scenario,
)
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401

pytestmark = [pytest.mark.race, pytest.mark.usefixtures("one_torch_thread")]

FIXTURE_FILE = os.path.abspath(fx.__file__)
SEEDS = range(8)
BODIES = sorted(f"{kind}_{twin}" for kind in fx.TWINS
                for twin in ("racy", "clean"))


def _first_body_line(path):
    with open(path, encoding="utf-8") as f:
        return next(i for i, ln in enumerate(f, 1)
                    if ln.startswith("def _pair"))


_OFFSETS = {os.path.basename(m.__file__): _first_body_line(m.__file__)
            for m in (fx, ref_fx)}


def _fold(text):
    """A fixture file's ``name:line`` as ``FIXTURES:line-from-body``, the
    package names folded."""
    def sub(m):
        base = os.path.basename(m.group(1))
        return f"FIXTURES:{int(m.group(2)) - _OFFSETS[base]}"
    text = re.sub(r"(\S*graftrace_fixtures\.py):(\d+)", sub, text)
    return text.replace("p2pnetwork_tpu_torch", "p2pnetwork_tpu")


def _findings(result):
    return [(f.rule, f.severity,
             _fold(f"{f.file}:{f.line}"), f.col, _fold(f.message))
            for f in result.findings]


def marker_line(body_name, marker="# RACY"):
    with open(FIXTURE_FILE, encoding="utf-8") as f:
        lines = f.read().splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith(f"def {body_name}"))
    return next(i for i, ln in enumerate(lines[start:], start + 1)
                if marker in ln)


# ============================================ parity with the reference

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("body", BODIES)
def test_schedule_and_findings_equal_reference(body, seed):
    mine = explore(getattr(fx, body), seed=seed)
    ref = ref_explore(getattr(ref_fx, body), seed=seed)
    assert mine.trace_lines() == ref.trace_lines()
    assert mine.steps == ref.steps
    assert _findings(mine) == _findings(ref)
    assert mine.errors == ref.errors == []


@pytest.mark.parametrize("kind", sorted(fx.TWINS))
def test_racy_twin_caught_at_its_racy_line(kind):
    racy, clean = fx.TWINS[kind]
    rel = os.path.relpath(FIXTURE_FILE, os.path.dirname(
        os.path.dirname(FIXTURE_FILE)))
    hits = [f for s in SEEDS for f in explore(racy, seed=s).findings]
    assert hits and all(f.rule == RACE_RULE and f.severity == "P0"
                        for f in hits)
    assert (rel, marker_line(racy.__name__)) in {(f.file, f.line)
                                                  for f in hits}
    for s in SEEDS:
        r = explore(clean, seed=s)
        assert not r.findings and not r.errors, (kind, s)


# ================================================== determinism, replay

def test_replay_file_replays_to_the_same_trace(tmp_path):
    r = explore(fx.lock_racy, seed=5)
    path = write_replay(str(tmp_path / "t.json"), "fixture_lock_racy", r)
    doc = load_replay(path)
    assert doc["seed"] == 5 and doc["max_steps"] == r.max_steps
    assert [tuple(row) for row in doc["trace"]] == r.trace
    assert doc["findings"] == [f.to_json() for f in r.findings]
    again = explore(fx.lock_racy, seed=doc["seed"],
                    max_steps=doc["max_steps"])
    assert again.trace == r.trace and again.findings == r.findings


def test_unnamed_threads_replay_identically_across_runs():
    def body():
        t = concurrency.thread(target=lambda: None)  # deliberately unnamed
        t.start()
        t.join()
    assert explore(body, seed=3).trace == explore(body, seed=3).trace


def test_seeds_explore_different_schedules():
    traces = {tuple(explore(fx.lock_clean, seed=s).trace) for s in SEEDS}
    assert len(traces) > 1


# ================================================= deadlock, budget, cv

def _ab_ba():
    l1, l2 = concurrency.lock(), concurrency.lock()

    def a():
        with l1:
            with l2:
                pass

    def b():
        with l2:
            with l1:
                pass
    fx._pair(a, b)


def test_order_inversion_found_and_unwound():
    hits = [s for s in range(20)
            if any(f.rule == DEADLOCK_RULE
                   for f in explore(_ab_ba, seed=s).findings)]
    assert hits, "AB/BA deadlock not found in 20 seeds"
    r = explore(_ab_ba, seed=hits[0])
    assert any(f.severity == "P0" for f in r.findings) and not r.errors
    ref = ref_explore(lambda: ref_fx._pair(*_ref_ab_ba()), seed=hits[0])
    assert r.trace_lines() == ref.trace_lines()


def _ref_ab_ba():
    from p2pnetwork_tpu import concurrency as ref_conc
    l1, l2 = ref_conc.lock(), ref_conc.lock()

    def a():
        with l1:
            with l2:
                pass

    def b():
        with l2:
            with l1:
                pass
    return a, b


def test_timed_wait_times_out_at_quiescence():
    got = []

    def body():
        got.append(concurrency.event().wait(timeout=1.0))
    r = explore(body, seed=0)
    assert got == [False] and not r.findings and not r.errors


def test_budget_bound_catches_livelock():
    def spin():
        ev = concurrency.event()
        while not ev.is_set():
            concurrency.sleep(0.01)
    with pytest.raises(ScheduleBudgetExceeded):
        explore(spin, seed=0, max_steps=500)


def test_condition_notify_reaches_a_live_waiter():
    def run_one(seed):
        outcomes = {}

        def body():
            cv = concurrency.condition()

            def waiter(name):
                with cv:
                    outcomes[name] = cv.wait(timeout=1.0)

            for name in ("first", "second"):
                t = concurrency.thread(target=waiter, args=(name,),
                                       name=name)
                t.start()
                with cv:
                    cv.notify()
                t.join()
        r = explore(body, seed=seed)
        assert not r.errors and not r.findings
        return outcomes["second"]
    assert any(run_one(s) for s in range(6))


# ============================================================= detector

def test_guarded_attrs_of_the_ports_classes():
    from p2pnetwork_tpu_torch.chaos.plane import ChaosPlane
    from p2pnetwork_tpu_torch.crdt import CRDTNode
    from p2pnetwork_tpu_torch.phi import PhiAccrualNode
    from p2pnetwork_tpu_torch.serve.service import SimService
    assert {"_arrivals", "_quarantined", "_quarantine_gen"} \
        <= set(guarded_attrs(PhiAccrualNode))
    assert "_crdts" in guarded_attrs(CRDTNode)
    assert {"_dead", "_cut", "_groups"} <= set(guarded_attrs(ChaosPlane))
    # The serving front end's state is guarded by its condition: the
    # inventory sees the port's seam (a lock id, not a name guess).
    served = guarded_attrs(SimService)
    assert served["_tickets"] == served["_queue"] == {"SimService._cond"}
    assert served["_phase_ring"] == {"SimService._phase_lock"}


def test_watch_is_noop_outside_exploration():
    from p2pnetwork_tpu_torch.chaos.plane import ChaosPlane
    plane = ChaosPlane(seed=0, registry=telemetry.Registry())
    assert watch(plane) is plane and type(plane).__name__ == "ChaosPlane"


def test_watch_catches_unlocked_container_write():
    class Box:
        def __init__(self):
            self._lk = concurrency.lock()
            self.items = {}

        def put_locked(self, k):
            with self._lk:
                self.items[k] = 1

        def put_bare(self, k):
            self.items[k] = 1

    def body():
        box = watch(Box(), attrs={"items"})
        fx._pair(lambda: box.put_locked("a"), lambda: box.put_bare("b"))

    assert any(f.rule == RACE_RULE for s in range(4)
               for f in explore(body, seed=s).findings)


def test_shared_and_vector_clocks():
    cell = Shared(7, label="x")
    cell.set(9)
    assert cell.get() == 9
    det = Detector()
    det.on_spawn(None, 0)
    det.on_spawn(0, 1)
    det.access(0, "v", True, ("f.py", 1))
    det.on_spawn(0, 2)
    det.access(1, "v", False, ("f.py", 2))
    det.access(0, "v", True, ("f.py", 3))
    det.access(1, "v", False, ("f.py", 4))
    assert any(f.rule == RACE_RULE for f in det.findings)


# ================================================================= CLI

def test_racy_fixture_exits_nonzero_through_scenarios_from(capsys):
    rc = graftrace_main(["--scenarios-from", FIXTURE_FILE,
                         "--scenario", "fixture_lock_racy",
                         "--schedules", "3"])
    out = capsys.readouterr().out
    assert rc == 1 and RACE_RULE in out
    rc = graftrace_main(["--scenarios-from", FIXTURE_FILE,
                         "--scenario", "fixture_lock_clean",
                         "--schedules", "3"])
    assert rc == 0 and "clean" in capsys.readouterr().out


def test_cli_json_trace_dir_and_replay(tmp_path, capsys):
    rc = graftrace_main(["--scenarios-from", FIXTURE_FILE,
                         "--scenario", "fixture_lock_racy",
                         "--schedules", "2", "--seed", "1", "--json",
                         "--trace-dir", str(tmp_path)])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1 and doc["ok"] is False
    assert doc["findings"][0]["rule"] == RACE_RULE
    assert doc["findings"][0]["file"].endswith("torch_graftrace_fixtures.py")
    traces = sorted(tmp_path.glob("fixture_lock_racy_s*.json"))
    assert traces
    rc = graftrace_main(["--scenarios-from", FIXTURE_FILE,
                         "--replay", str(traces[0])])
    assert rc == 1 and "byte-identical" in capsys.readouterr().out


def test_replay_divergence_is_exit_2(tmp_path, capsys):
    path = write_replay(str(tmp_path / "t.json"), "fixture_lock_racy",
                        explore(fx.lock_racy, seed=2))
    with open(path) as f:
        doc = json.load(f)
    doc["trace"][4] = ["ghost", "acquire", "lock99"]
    with open(path, "w") as f:
        json.dump(doc, f)
    assert graftrace_main(["--scenarios-from", FIXTURE_FILE,
                           "--replay", path]) == 2
    assert "DIVERGED" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--scenario", "no_such_scenario"],
    ["--scenarios-from", "no/such/file.py"],
    ["--schedules", "0"],
], ids=["unknown", "missing-file", "no-schedules"])
def test_bad_invocations_exit_2(argv, capsys):
    assert graftrace_main(argv) == 2


def test_device_scenarios_need_a_device(capsys, monkeypatch):
    # Without a card the device scenarios refuse to run rather than fall
    # back to the CPU: the CLI exits 2 and names the way out.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert graftrace_main(["--scenario", "serve_admit_storm",
                           "--schedules", "1"]) == 2
    assert "device='cpu'" in capsys.readouterr().err


def test_battery_counts_telemetry_and_survives_livelock():
    def spin():
        ev = concurrency.event()
        while not ev.is_set():
            concurrency.sleep(0)

    @scenario("fixture_livelock", "spins forever", builtin=False)
    def _fixture_livelock():
        return spin

    reg = telemetry.Registry()
    findings, stats = run_battery(
        ["fixture_livelock", "partition_heal", "fixture_lock_racy"], seed=0,
        schedules=2, max_steps=300, registry=reg)
    live, heal, racy = stats
    assert live["errors"] and "ScheduleBudgetExceeded" in \
        live["errors"][0]["error"]
    assert heal["schedules"] == 2 and racy["schedules"] == 2
    assert reg.value("graftrace_schedules_total") == 6
    assert reg.value("graftrace_races_total", rule=RACE_RULE) >= 1
    assert {f.rule for f in findings} >= {"graftrace-error", RACE_RULE}


def test_list_scenarios_names_the_ten_builtins(capsys):
    assert graftrace_main(["--list-scenarios"]) == 0
    out = capsys.readouterr().out
    assert len(builtin_names()) == 10
    assert all(name in out for name in builtin_names())
    assert {n for n in builtin_names() if SCENARIOS[n].device} == {
        "watchdog_emergency_checkpoint", "serve_admit_storm",
        "churn_storm_vs_serve", "sight_scrape_under_serve",
        "journal_vs_close"}
