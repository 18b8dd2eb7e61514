"""The port's churn and crash storms (``chaos/storm.py``,
``chaos/crashstorm.py``) against the JAX package's, on the CPU.

- ``storm.generate(...).to_bytes()`` and ``crashstorm.generate(...)``
  byte-equal to the reference's, with the same validation.
- ``storm.drive`` on the reference's 32-node storm with traffic: the
  events, tickets, sheds and counts equal the reference's drive; the
  same storm healed through a preempt and a wedge equals it too.
- The crash seams (``install``) and ``acked_tickets`` on a trail, read
  the same by both packages' scans; a resumed service after a
  ``sidecar_publish`` kill equal to the uninterrupted one.
- One small crash campaign of subprocess children on the CPU (a
  ``journal_append`` and a ``sidecar_publish`` kill, both landing), its
  child script importing torch and the port only.

Every comparison is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu import serve as RS  # noqa: E402
from p2pnetwork_tpu import telemetry as RT  # noqa: E402
from p2pnetwork_tpu.chaos import crashstorm as RC  # noqa: E402
from p2pnetwork_tpu.chaos import device as RD  # noqa: E402
from p2pnetwork_tpu.chaos import storm as RSt  # noqa: E402
from p2pnetwork_tpu.sim import graph as RG  # noqa: E402
from p2pnetwork_tpu.supervise import heal as RH  # noqa: E402
from p2pnetwork_tpu_torch import chaos as PChaos  # noqa: E402
from p2pnetwork_tpu_torch import serve as PS  # noqa: E402
from p2pnetwork_tpu_torch import telemetry as PT  # noqa: E402
from p2pnetwork_tpu_torch.chaos import crashstorm as PC  # noqa: E402
from p2pnetwork_tpu_torch.chaos import device as PD  # noqa: E402
from p2pnetwork_tpu_torch.chaos import storm as PSt  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as PG  # noqa: E402
from p2pnetwork_tpu_torch.supervise import heal as PH  # noqa: E402
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

#: The reference's storm of its drive test (tests/test_graftchurn.py).
STORM = dict(ticks=24, join_prob=0.5, join_batch=3, fanout=2,
             leave_prob=0.3, grow_prob=0.2, grow_batch=4)
PATTERNS = [STORM, {}, dict(ticks=10, join_prob=0.5, join_batch=8, fanout=3,
                            leave_prob=0.3, grow_prob=0.2, grow_batch=16)]


@pytest.fixture(autouse=True)
def no_dispatch_chaos():
    prev_r = RD.install_dispatch_chaos(None)
    prev_p = PD.install_dispatch_chaos(None)
    yield
    RD.install_dispatch_chaos(prev_r)
    PD.install_dispatch_chaos(prev_p)


@pytest.mark.parametrize("pattern", PATTERNS, ids=["drive", "default",
                                                   "soak"])
@pytest.mark.parametrize("seed", [7, 11])
def test_storm_schedule_byte_equal(pattern, seed):
    r = RSt.generate(RSt.ChurnPattern(**pattern), 1000, seed=seed)
    p = PSt.generate(PSt.ChurnPattern(**pattern), 1000, seed=seed)
    assert len(p) > 0 and p.to_bytes() == r.to_bytes()
    assert p.n_final == r.n_final
    t = int(p.ev_tick[len(p) // 2])
    got = [(k, a, None if d is None else (d.add_senders, d.add_receivers,
                                          d.remove_senders,
                                          d.remove_receivers))
           for k, a, d in p.events_at(t)]
    want = [(k, a, None if d is None else (d.add_senders, d.add_receivers,
                                           d.remove_senders,
                                           d.remove_receivers))
            for k, a, d in r.events_at(t)]
    assert str(got) == str(want)


def test_storm_validation_and_lazy_names():
    for kw in (dict(ticks=0), dict(join_prob=1.5), dict(join_batch=0),
               dict(fanout=0), dict(grow_batch=0)):
        with pytest.raises(ValueError):
            PSt.ChurnPattern(**kw)
    with pytest.raises(ValueError):
        PSt.generate(PSt.ChurnPattern(), 0)
    assert PChaos.ChurnPattern is PSt.ChurnPattern
    assert PChaos.KillPoint is PC.KillPoint
    with pytest.raises(AttributeError):
        PChaos.nothing_here  # noqa: B018


@pytest.mark.parametrize("args", [(6, 9, 32), (5, 3, 24), (2, 0, 8)])
def test_crash_schedule_byte_equal(args):
    n, seed, ticks = args
    r = RC.generate(n, seed=seed, ticks=ticks)
    p = PC.generate(n, seed=seed, ticks=ticks)
    assert p.to_bytes() == r.to_bytes() and len(p) == n
    assert {"journal_append", "sidecar_publish"} <= {k.kind for k in p.kills}


def test_crash_schedule_validation():
    with pytest.raises(ValueError):
        PC.generate(1, require=("journal_append", "sidecar_publish"))
    with pytest.raises(ValueError):
        PC.generate(3, require=("disk_full",))
    with pytest.raises(ValueError):
        PC.KillPoint("meteor", 3)
    with pytest.raises(ValueError):
        PC.KillPoint("tick", 0)
    sched = PC.CrashSchedule(kills=(PC.KillPoint("disk_full", 1),), seed=0)
    with pytest.raises(PC.CampaignError, match="availability"):
        PC.run_campaign("/nonexistent-unused", sched)


# ---------------------------------------------------------------- drives


def _edges(rng, n, target):
    s = rng.integers(0, n, target * 3).astype(np.int32)
    r = rng.integers(0, n, target * 3).astype(np.int32)
    keep = s != r
    keys = np.unique(s[keep].astype(np.int64) * n + r[keep])[:target]
    return (keys // n).astype(np.int32), (keys % n).astype(np.int32)


def _storm_graphs():
    s, r = _edges(np.random.default_rng(0), 32, 200)
    return (RG.grow(RG.from_edges(s, r, 32, node_pad_multiple=32), 0,
                    node_capacity=256),
            PG.grow(PG.from_edges(s, r, 32, node_pad_multiple=32,
                                  device="cpu"), 0, node_capacity=256))


def _service(pkg, g, **kw):
    kw.setdefault("capacity", 8)
    kw.setdefault("chunk_rounds", 2)
    kw.setdefault("seed", 5)
    kw.setdefault("record_seen_hash", True)
    kw.setdefault("max_ticket_rounds", 40)
    kw.setdefault("registry", (RT if pkg is RS else PT).Registry())
    return pkg.SimService(g, **kw)


@pytest.fixture(scope="module")
def reference_storm_drive():
    g_r, _ = _storm_graphs()
    storm = RSt.generate(RSt.ChurnPattern(**STORM), 32, seed=7)
    tr = RS.generate(RS.TrafficPattern(ticks=24, rate=1.5,
                                       coverage_target=0.5), 32, seed=3)
    svc = _service(RS, g_r, heal=RH.RetryPolicy(backoff_base_s=0.0))
    out = RSt.drive(svc, storm, traffic=tr)
    svc.close()
    return out


def _port_storm_drive(**kw):
    _, g_p = _storm_graphs()
    storm = PSt.generate(PSt.ChurnPattern(**STORM), 32, seed=7)
    tr = PS.generate(PS.TrafficPattern(ticks=24, rate=1.5,
                                       coverage_target=0.5), 32, seed=3)
    svc = _service(PS, g_p, **kw)
    out = PSt.drive(svc, storm, traffic=tr)
    svc.close()
    return out, storm


def test_storm_drive_equals_the_reference(reference_storm_drive):
    got, storm = _port_storm_drive()
    assert got == reference_storm_drive
    assert got["graph_nodes"] == storm.n_final
    assert got["events"]["join"] > 0 and got["events"]["leave"] > 0
    assert got["submitted"] > 0


def test_healed_storm_drive_equals_the_reference(reference_storm_drive):
    reg, chaos_reg = PT.Registry(), PT.Registry()
    PD.install_dispatch_chaos(PD.DispatchChaos(
        preempt_at=(1,), wedge_at=(3,), registry=chaos_reg))
    got, _ = _port_storm_drive(heal=PH.RetryPolicy(max_attempts=4,
                                                   backoff_base_s=0.0),
                               registry=reg)
    assert got == reference_storm_drive
    assert chaos_reg.value("chaos_device_faults_total", kind="preempt") == 1
    assert chaos_reg.value("chaos_device_faults_total", kind="wedge") == 1
    assert reg.value("heal_retries_total", outcome="healed") == 2
    assert reg.value("heal_retries_total", outcome="exhausted") == 0


def test_drive_refuses_mismatched_traffic():
    _, g_p = _storm_graphs()
    storm = PSt.generate(PSt.ChurnPattern(ticks=4), 32, seed=1)
    tr = PS.generate(PS.TrafficPattern(ticks=8, rate=1.0), 32, seed=1)
    svc = _service(PS, g_p)
    with pytest.raises(ValueError, match="storm"):
        PSt.drive(svc, storm, traffic=tr)
    svc.close()


# ------------------------------------------------------------ crash seams


class _Kill(Exception):
    """In-process stand-in for SIGKILL, raised out of a crash seam."""


def _die():
    raise _Kill()


def test_seams_and_acked_tickets_equal_the_reference(tmp_path):
    g = PG.watts_strogatz(300, 6, 0.2, seed=3, device="cpu")
    sched = PS.generate(PS.TrafficPattern(ticks=12, rate=3.0), 300, seed=4)
    ref = _service(PS, g, capacity=16, chunk_rounds=4, seed=0,
                   max_ticket_rounds=1024)
    PS.drive(ref, sched)
    ref.close()
    d = str(tmp_path)
    svc = _service(PS, g, capacity=16, chunk_rounds=4, seed=0,
                   max_ticket_rounds=1024, store=d,
                   checkpoint_every_ticks=3)
    PC.install(svc, PC.KillPoint("sidecar_publish", 5), action=_die)
    with pytest.raises(_Kill):
        PS.drive(svc, sched)
    acked = PC.acked_tickets(d)
    assert acked and acked == RC.acked_tickets(d)
    del svc
    res = _service(PS, g, capacity=16, chunk_rounds=4, seed=0,
                   max_ticket_rounds=1024, store=d)
    PS.drive(res, sched)
    assert res.tickets() == ref.tickets()
    assert acked <= set(res.tickets())
    res.close()
    with pytest.raises(ValueError, match="journaled"):
        PC.install(_service(PS, g), PC.KillPoint("journal_append", 1))


def test_small_crash_campaign_on_the_cpu(tmp_path):
    sched = PC.CrashSchedule(kills=(PC.KillPoint("journal_append", 3),
                                    PC.KillPoint("sidecar_publish", 6)),
                             seed=0)
    report = PC.run_campaign(str(tmp_path), sched,
                             config={"device": "cpu"},
                             env={"OMP_NUM_THREADS": "1"}, timeout=300.0)
    assert [k["landed"] for k in report["kills"]] == [True, True]
    assert 0 < report["acked_seen"] <= report["tickets"]
    script = (tmp_path / "crashstorm_child.py").read_text()
    assert "import torch" in script and "jax" not in script
