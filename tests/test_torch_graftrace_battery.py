"""graftrace's ten builtin scenarios over the port's own modules, on the
CPU: each explored at the CLI's default of 8 seeded schedules, every
schedule clean (no race, deadlock or task error), none unavailable. The
device scenarios (the watchdog's checkpoint and the four serving ones)
put their graphs and state on ``device="cpu"`` here; ``chip_smoke.py``
runs the same battery with them on the card."""

import pytest

torch = pytest.importorskip("torch")

from p2pnetwork_tpu_torch import telemetry  # noqa: E402
from p2pnetwork_tpu_torch.analysis.race import explore  # noqa: E402
from p2pnetwork_tpu_torch.analysis.race.__main__ import (  # noqa: E402
    DEFAULT_SCHEDULES, run_battery,
)
from p2pnetwork_tpu_torch.analysis.race.scenarios import (  # noqa: E402
    SCENARIOS, builtin_names,
)
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401

pytestmark = [pytest.mark.race, pytest.mark.usefixtures("one_torch_thread")]


def test_the_battery_is_ten_scenarios_at_eight_schedules():
    assert DEFAULT_SCHEDULES == 8
    assert builtin_names() == sorted([
        "connect_disconnect_storm", "phi_quarantine", "crdt_merge_storm",
        "registry_storm", "partition_heal", "watchdog_emergency_checkpoint",
        "serve_admit_storm", "churn_storm_vs_serve",
        "sight_scrape_under_serve", "journal_vs_close"])


@pytest.mark.parametrize("name", builtin_names())
def test_scenario_is_clean_at_every_schedule(name):
    entry = SCENARIOS[name]
    for seed in range(DEFAULT_SCHEDULES):
        r = explore(entry.make("cpu"), seed=seed)
        assert r.steps > 0
        assert not r.findings, (
            f"{name} seed {seed}:\n"
            + "\n".join(f.render() for f in r.findings))
        assert not r.errors, f"{name} seed {seed}: {r.errors}"


def test_run_battery_counts_every_schedule():
    # The CLI's library entry over two scenarios: stats rows, the
    # schedules counter, and nothing skipped.
    reg = telemetry.Registry()
    names = ["registry_storm", "watchdog_emergency_checkpoint"]
    findings, stats = run_battery(names, seed=0, schedules=2,
                                  registry=reg, device="cpu")
    assert findings == []
    assert [s["scenario"] for s in stats] == names
    assert all(s["schedules"] == 2 and s["steps"] > 0
               and s["skipped"] is None and not s["errors"] for s in stats)
    assert reg.value("graftrace_schedules_total") == 4


@pytest.mark.parametrize("name", ["churn_storm_vs_serve", "serve_admit_storm",
                                  "sight_scrape_under_serve"])
def test_schedule_does_not_depend_on_the_clock(name, monkeypatch):
    # C11: a tick's phase walls decided whether the tick wrote
    # SimService._phase_max, so one seed's schedule changed with the
    # machine's speed (replay diverged from run to run). Two clocks, one
    # steady and one whose ticks grow longer, must give one trace.
    import itertools
    import time

    def steady():
        c = itertools.count()
        return lambda: float(next(c))

    def slowing():
        c = itertools.count()
        return lambda: float(next(c)) ** 2

    traces = []
    for clock in (steady, slowing):
        monkeypatch.setattr(time, "perf_counter", clock())
        traces.append(explore(SCENARIOS[name].make("cpu"), seed=0).trace)
    assert traces[0] == traces[1]
