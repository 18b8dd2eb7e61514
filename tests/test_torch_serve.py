"""The port's serving plane against the JAX package's, on the CPU.

- ``generate``'s schedule, byte for byte.
- ``drive`` on ``watts_strogatz(300, 6, 0.2, seed=3)`` and ``ring(128)``
  at capacity 32: the ticket tables, shed lists, counts and the
  completion-round percentiles equal the reference's.
- Quotas, cancellation, and ``apply_delta`` / ``grow`` mid-drive: the
  same records in both packages.
- Journals written by either package read back in the other, record for
  record; ``Standby.refresh`` of either reads the port's trail the same.
- A store trail preempted mid-drive and resumed is bit-identical to the
  uninterrupted run (``seen_sha256`` included, equal to the reference's);
  ``Standby.promote`` fences the old primary (``FencedEpoch``).
- The background driver (``start`` / ``wait`` / ``close``); the graph
  fingerprint refusing the reference's trail (``GraphMismatch``);
  ``heal`` and ``slo`` accepted (``tests/test_torch_heal.py`` and
  ``tests/test_torch_slo.py`` hold them against the reference) and
  ``hbm_budget_bytes`` refused; the host reads of one tick, counted.

Every comparison is exact: records hold ints, strings and the f32
target as a Python float.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu import serve as RS  # noqa: E402
from p2pnetwork_tpu import telemetry as RT  # noqa: E402
from p2pnetwork_tpu.serve import journal as RJ  # noqa: E402
from p2pnetwork_tpu.sim import graph as RG  # noqa: E402
from p2pnetwork_tpu_torch import _device  # noqa: E402
from p2pnetwork_tpu_torch import serve as PS  # noqa: E402
from p2pnetwork_tpu_torch import telemetry as PT  # noqa: E402
from p2pnetwork_tpu_torch.models import messagebatch as PMB  # noqa: E402
from p2pnetwork_tpu_torch.serve import journal as PJ  # noqa: E402
from p2pnetwork_tpu_torch.serve.service import Preempted  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as PG  # noqa: E402
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PATTERN = dict(ticks=12, rate=12.0, hot_fraction=0.5, hot_keys=8,
               diurnal_amplitude=0.3, diurnal_period=6.0, burst_prob=0.125,
               burst_mult=3.0, coverage_target=0.99)
GRAPHS = {
    "ws300": (lambda: RG.watts_strogatz(300, 6, 0.2, seed=3),
              lambda: PG.watts_strogatz(300, 6, 0.2, seed=3, device="cpu")),
    "ring128": (lambda: RG.ring(128), lambda: PG.ring(128, device="cpu")),
}


@pytest.fixture(scope="module")
def graphs():
    return {name: (r(), p()) for name, (r, p) in GRAPHS.items()}


def service(pkg, g, **kw):
    kw.setdefault("capacity", 32)
    kw.setdefault("queue_depth", 16)
    kw.setdefault("chunk_rounds", 4)
    kw.setdefault("seed", 0)
    kw.setdefault("registry", (RT if pkg is RS else PT).Registry())
    return pkg.SimService(g, **kw)


def schedules(g_r, g_p, seed=0, **over):
    pat = dict(PATTERN, **over)
    return (RS.generate(RS.TrafficPattern(**pat), g_r.n_nodes, seed=seed),
            PS.generate(PS.TrafficPattern(**pat), g_p.n_nodes, seed=seed))


def stats_counts(svc) -> dict:
    s = svc.stats()
    return {k: s.get(k) for k in (
        "submitted", "completed", "cancelled", "rejected", "timeout",
        "mutations", "tick", "round", "messages", "queue_depth",
        "active_lanes", "admit_budget", "graph_nodes", "graph_capacity",
        "completion_rounds_p50", "completion_rounds_p99")}


#: The drives held against the reference: (graph, service options). The
#: last paces admission by AIMD off ``slo_rounds`` (ring floods take ~60
#: rounds, so the budget halves).
DRIVES = {"ws300": ("ws300", {}), "ring128": ("ring128", {}),
          "ring128-aimd": ("ring128", {"slo_rounds": 16.0,
                                       "max_active_lanes": 24})}


@pytest.fixture(scope="module")
def reference_drives(graphs):
    """The reference's drive of each case (its compiles are the slow
    part of this file, so each runs once)."""
    out = {}
    for case, (name, kw) in DRIVES.items():
        g_r, g_p = graphs[name]
        s_r, _ = schedules(g_r, g_p)
        svc = service(RS, g_r, record_seen_hash=True, **kw)
        out[case] = (RS.drive(svc, s_r), stats_counts(svc))
    return out


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("over", [{}, {"tenants": ("a", "b", "c"),
                                       "zipf_s": 0.0, "burst_prob": 0.5}])
def test_generate_byte_equal(seed, over):
    pat = dict(PATTERN, **over)
    r = RS.generate(RS.TrafficPattern(**pat), 1000, seed=seed)
    p = PS.generate(PS.TrafficPattern(**pat), 1000, seed=seed)
    assert len(r) > 0 and r.to_bytes() == p.to_bytes()


@pytest.mark.parametrize("case", list(DRIVES))
def test_drive_equals_reference(graphs, reference_drives, case):
    name, kw = DRIVES[case]
    g_r, g_p = graphs[name]
    _, s_p = schedules(g_r, g_p)
    svc = service(PS, g_p, record_seen_hash=True, **kw)
    got = PS.drive(svc, s_p)
    want, want_stats = reference_drives[case]
    assert got["shed"] and got["completed"] > 0
    assert got == want
    assert stats_counts(svc) == want_stats
    if "slo_rounds" in kw:
        assert want_stats["admit_budget"] < kw["max_active_lanes"]


def _mutation_drive(pkg, g, delta_cls):
    """Submit, tick, queue growth and a delta wiring the new nodes, cancel
    a queued and a running ticket, tick to the end."""
    svc = service(pkg, g, quotas={"q": (1.0, 2.0)}, queue_depth=64)
    sheds = []
    tids = []
    for i in range(60):
        try:
            tids.append(svc.submit(
                (i * 37) % g.n_nodes, tenant="q" if i % 3 == 0 else "default"))
        except pkg.Rejected as e:
            sheds.append(e.to_dict())
    svc.tick()
    running = [t for t in tids if svc.poll(t)["status"] == "running"]
    queued = [t for t in tids if svc.poll(t)["status"] == "queued"]
    cancels = [svc.cancel(running[0]), svc.cancel(queued[0]),
               svc.cancel(queued[0])]
    n = g.n_nodes
    s0, r0 = int(np.asarray(g.senders)[0]), int(np.asarray(g.receivers)[0])
    svc.grow(4)
    svc.apply_delta(delta_cls.undirected(
        add_senders=[n, n + 1, n + 2, n + 3, n],
        add_receivers=[0, n, n + 1, n + 2, 5],
        remove_senders=[s0], remove_receivers=[r0]))
    for _ in range(3):
        svc.tick()
    tids.append(svc.submit(n + 3))
    for _ in range(40):
        if not svc.busy():
            break
        svc.tick()
    return svc.tickets(), sheds, cancels, stats_counts(svc)


def test_quotas_cancel_and_mutations_mid_drive():
    g_r = RG.watts_strogatz(300, 6, 0.2, seed=3)
    g_p = PG.watts_strogatz(300, 6, 0.2, seed=3, device="cpu")
    want = _mutation_drive(RS, g_r, RG.GraphDelta)
    got = _mutation_drive(PS, g_p, PG.GraphDelta)
    assert want[1] and want[2] == [True, True, False]
    assert want[3]["mutations"] == 2 and want[3]["graph_nodes"] == 304
    assert got == want


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_journals_cross_read(graphs, tmp_path, writer):
    """A service's journal (submits, sheds, a cancel, growth and a delta)
    reads back record for record in the other package."""
    g_r, g_p = graphs["ws300"]
    pkg, g, delta = ((PS, g_p, PG.GraphDelta) if writer == "port"
                     else (RS, g_r, RG.GraphDelta))
    svc = service(pkg, g, store=str(tmp_path), journal=True,
                  queue_depth=4, journal_fsync="off")
    tids = []
    for s in range(8):
        try:
            tids.append(svc.submit(s))
        except pkg.QueueFull:
            pass
    svc.cancel(tids[1])
    svc.grow(2)
    svc.apply_delta(delta.undirected(add_senders=[300], add_receivers=[1]))
    recs_r, corrupt_r = RJ.read_records(str(tmp_path))
    recs_p, corrupt_p = PJ.read_records(str(tmp_path))
    kinds = [r["kind"] for r in recs_p]
    assert kinds == ["submit"] * 4 + ["shed"] * 4 + ["cancel", "grow",
                                                      "delta"]
    assert recs_r == recs_p and corrupt_r == corrupt_p == 0
    # A journal object of the other package recovers the same records.
    other = (RJ if writer == "port" else PJ).Journal(str(tmp_path))
    assert other.records() == recs_p
    other.close()
    obs_r = RS.Standby(g_r, str(tmp_path)).refresh()
    obs_p = PS.Standby(g_p, str(tmp_path)).refresh()
    assert obs_r == obs_p and obs_p["replay_pending"] == len(recs_p)
    svc.close()


def test_journal_append_equal_bytes(tmp_path):
    """The same appends through each package's Journal give the same
    segment bytes."""
    out = []
    for mod in (RJ, PJ):
        d = tmp_path / mod.__name__.split(".")[0]
        j = mod.Journal(str(d), fsync="record")
        j.append("submit", tick=0, ticket="t00000000", source=3,
                 target=0.99, tenant="default", round=0)
        j.append("shed", tick=1, reason="queue_full", source=4,
                 tenant="a")
        j.append("grow", tick=2, n=5)
        j.close()
        segs = sorted(os.listdir(d))
        out.append([(s, (d / s).read_bytes()) for s in segs])
    assert out[0] == out[1]


def test_store_resume_bit_identical(graphs, reference_drives, tmp_path):
    g_r, g_p = graphs["ws300"]
    _, s_p = schedules(g_r, g_p)
    kw = dict(record_seen_hash=True, journal=True, journal_fsync="off")
    svc = service(PS, g_p, store=str(tmp_path), resume=False, **kw)
    svc.arm_preemption(6)
    with pytest.raises(Preempted):
        PS.drive(svc, s_p)
    killed = svc.tickets()
    assert any(r["status"] in ("running", "queued") for r in killed.values())
    res = service(PS, g_p, store=str(tmp_path), **kw)
    assert res.tick_index == 5
    got = PS.drive(res, s_p)
    ref = service(PS, g_p, record_seen_hash=True)
    PS.drive(ref, s_p)
    assert res.tickets() == ref.tickets()
    want = reference_drives["ws300"][0]["tickets"]
    assert {t: r["seen_sha256"] for t, r in res.tickets().items()} == {
        t: r["seen_sha256"] for t, r in want.items()}
    assert got["replayed"] > 0
    res.close()


def test_standby_promote_fences_the_primary(graphs, tmp_path):
    g_r, g_p = graphs["ws300"]
    primary = service(PS, g_p, store=str(tmp_path), journal=True,
                      journal_fsync="off")
    tids = [primary.submit(s) for s in (1, 2, 3)]
    primary.tick()
    late = primary.submit(9)  # journaled past the last pair
    standby = PS.Standby(g_p, str(tmp_path), capacity=32, queue_depth=16,
                         chunk_rounds=4, seed=0,
                         registry=PT.Registry())
    obs = standby.refresh()
    assert obs["epoch"] == 0 and obs["replay_pending"] == 1
    promoted = standby.promote()
    assert promoted.stats()["epoch"] == 1
    with pytest.raises(PS.FencedEpoch) as e:
        primary.checkpoint()
    assert (e.value.ours, e.value.current) == (0, 1)
    while promoted.replay_next() is not None:
        pass
    while promoted.busy():
        promoted.tick()
    done = promoted.tickets()
    assert all(done[t]["status"] == "done" for t in tids + [late])
    promoted.close()


def test_background_driver_start_wait_close(graphs, tmp_path):
    _, g_p = graphs["ws300"]
    svc = service(PS, g_p, store=str(tmp_path), idle_wait_s=0.01)
    svc.start()
    tids = [svc.submit(s) for s in (0, 17, 150)]
    recs = [svc.wait(t, timeout=60) for t in tids]
    assert [r["status"] for r in recs] == ["done"] * 3
    stream = list(svc.stream(tids[0], timeout=10))
    assert stream[-1]["status"] == "done"
    svc.close()
    assert not svc.driver_running
    with pytest.raises(PS.ServiceClosed):
        svc.submit(1)
    # The final checkpoint covers everything: a new service resumes it.
    again = service(PS, g_p, store=str(tmp_path))
    assert {t: again.poll(t)["status"] for t in tids} == {
        t: "done" for t in tids}
    again.close()


def test_port_refuses_the_reference_trail(graphs, tmp_path):
    """Trails do not cross packages: the sidecar's graph fingerprint
    folds each package's own layout sources."""
    g_r, g_p = graphs["ws300"]
    ref = service(RS, g_r, store=str(tmp_path), journal=False)
    ref.submit(4)
    ref.tick()
    ref.close()
    with pytest.raises(PS.GraphMismatch) as e:
        service(PS, g_p, store=str(tmp_path), journal=False)
    assert e.value.expected != e.value.got
    assert os.path.exists(tmp_path / "service_state.json")  # trail kept


def _heal_policy():
    from p2pnetwork_tpu_torch.supervise.heal import RetryPolicy

    return RetryPolicy(backoff_base_s=0.0)


def _slo_engine():
    from p2pnetwork_tpu_torch.telemetry.slo import (SLOEngine,
                                                    serve_objectives)

    return SLOEngine(serve_objectives(slo_rounds=64), registry=PT.Registry())


@pytest.mark.parametrize("knob", [{"heal": _heal_policy},
                                  {"slo": _slo_engine},
                                  {"hbm_budget_bytes": lambda: 1e9}])
def test_refused_options_name_the_roadmap(graphs, knob):
    """Options once refused, naming the ROADMAP item that queued them,
    now run: ``heal`` and ``slo`` (slice 10) and ``hbm_budget_bytes``
    (slice 13, the memory planner fitted on the card; its gate is held to
    the reference's in ``tests/test_torch_capacity.py``). A service takes
    each and ticks."""
    _, g_p = graphs["ring128"]
    kw = {k: make() for k, make in knob.items()}
    svc = service(PS, g_p, **kw)
    svc.submit(3)
    assert svc.tick()["running"] == 1
    svc.close()


def test_one_tick_host_reads_are_counted(graphs):
    """An admitting, dispatching, harvesting tick reads the device once
    for admission, once per exit flag and once for the summary in the
    engine, and once for the harvest; ``BatchFlood.admit`` without the
    driver's host lanes counts its own read."""
    _, g_p = graphs["ws300"]
    svc = service(PS, g_p, chunk_rounds=16)
    for s in (0, 100, 200):
        svc.submit(s)
    before = _device.SYNCS
    info = svc.tick()
    rounds = info["executed_rounds"]
    assert info["completed"] == 3 and rounds < 16
    assert _device.SYNCS - before == 1 + (rounds + 1) + 1 + 1
    before = _device.SYNCS
    assert svc.tick()["executed_rounds"] == 0  # retire only: no read
    assert _device.SYNCS == before
    proto = PMB.BatchFlood()
    b = proto.empty(g_p, 32)
    before = _device.SYNCS
    b, lanes = proto.admit(g_p, b, [3, 4])
    assert _device.SYNCS - before == 1 and lanes.tolist() == [0, 1]
    b2, lanes2 = proto.admit(g_p, b, [5], open_lanes=np.arange(2, 32))
    assert _device.SYNCS - before == 1 and lanes2.tolist() == [2]
    b3, lanes3 = proto.admit(g_p, b, [5])
    assert all(torch.equal(getattr(b2, f), getattr(b3, f))
               for f in ("seen", "frontier", "admitted", "done", "source"))


def test_http_seam(graphs):
    _, g_p = graphs["ws300"]
    svc = service(PS, g_p, queue_depth=1)
    code, body = svc.handle_http("POST", "/submit", {"source": 5})
    assert (code, body["status"]) == (202, "queued")
    code, shed = svc.handle_http("GET", "/submit?source=6", None)
    assert code == 429 and shed["reason"] == "queue_full"
    assert svc.handle_http("GET", f"/poll/{body['ticket']}", None)[0] == 200
    assert svc.handle_http("POST", f"/cancel/{body['ticket']}", None) == (
        200, {"cancelled": True})
    assert svc.handle_http("GET", "/stats", None)[1]["cancelled"] == 1
    assert svc.handle_http("GET", "/metrics", None) is None
    svc.tick()
    phases = svc.dashboard_slice()["tick_phases"]
    assert phases["ticks"] == 1 and set(phases["per_phase"]) == set(
        PS.service.TICK_PHASES)
