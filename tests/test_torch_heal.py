"""The port's self-healing plane (``supervise/heal.py``, ``heal=`` on
``SimService`` and ``SupervisedRun``) against the JAX package's, on the
CPU.

- ``state_checksum``: equal digests in both packages for the same
  ``MessageBatch`` (packed words hashed as ``uint32``), flood state and
  dict/tuple trees; a dispatch of the batch loop leaves its input's
  digest unchanged (the port's ``donate`` has no effect).
- ``audit_state`` / ``check_monotonic``: the same kind, leaf and message
  on the same damage.
- ``RetryPolicy``: backoffs and routes equal the reference's.
- ``Healer``: a one-shot fault healed, an exhausted budget, unroutable
  errors untouched, integrity routed to the fallback, a checksum verify
  catching silent corruption, a store rollback.
- A healed service drive under ``DispatchChaos`` (a preempt and a wedge)
  equal to the reference's unfaulted ticket table, seen hashes included,
  with the reference's counts; the ticket trace events of a faulted
  chunk; a healed ``SupervisedRun`` bit-identical to the reference's
  unfaulted run; the service's own preemption not swallowed, nor a chip
  loss without ``heal=``.

Every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from p2pnetwork_tpu import serve as RS  # noqa: E402
from p2pnetwork_tpu import supervise as RSV  # noqa: E402
from p2pnetwork_tpu import telemetry as RT  # noqa: E402
from p2pnetwork_tpu.chaos import device as RD  # noqa: E402
from p2pnetwork_tpu.models import flood as RF  # noqa: E402
from p2pnetwork_tpu.models import messagebatch as RMB  # noqa: E402
from p2pnetwork_tpu.sim import engine as RE  # noqa: E402
from p2pnetwork_tpu.sim import graph as RG  # noqa: E402
from p2pnetwork_tpu.supervise import heal as RH  # noqa: E402
from p2pnetwork_tpu_torch import _device, prng  # noqa: E402
from p2pnetwork_tpu_torch import serve as PS  # noqa: E402
from p2pnetwork_tpu_torch import supervise as PSV  # noqa: E402
from p2pnetwork_tpu_torch import telemetry as PT  # noqa: E402
from p2pnetwork_tpu_torch.chaos import device as PD  # noqa: E402
from p2pnetwork_tpu_torch.models import flood as PF  # noqa: E402
from p2pnetwork_tpu_torch.models import messagebatch as PMB  # noqa: E402
from p2pnetwork_tpu_torch.parallel import mesh as TM  # noqa: E402
from p2pnetwork_tpu_torch.parallel import sharded as TS  # noqa: E402
from p2pnetwork_tpu_torch.serve.service import Preempted  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine as PE  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as PG  # noqa: E402
from p2pnetwork_tpu_torch.supervise import heal as PH  # noqa: E402
from p2pnetwork_tpu_torch.telemetry import spans  # noqa: E402
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SOURCES = [3, 9, 77, 200]
FAULTS = dict(preempt_at=(1,), wedge_at=(3,))


@pytest.fixture(autouse=True)
def no_dispatch_chaos():
    prev_r = RD.install_dispatch_chaos(None)
    prev_p = PD.install_dispatch_chaos(None)
    yield
    RD.install_dispatch_chaos(prev_r)
    PD.install_dispatch_chaos(prev_p)


@pytest.fixture(scope="module")
def graphs():
    return (RG.watts_strogatz(300, 6, 0.2, seed=3),
            PG.watts_strogatz(300, 6, 0.2, seed=3, device="cpu"))


@pytest.fixture(scope="module")
def batches(graphs):
    """The same admitted batch, then two rounds of it, in each package."""
    g_r, g_p = graphs
    out = []
    for mod, eng, g, key in ((RMB, RE, g_r, jax.random.key(0)),
                             (PMB, PE, g_p, prng.key(0))):
        proto = mod.BatchFlood()
        b0, _ = proto.admit(g, proto.empty(g, 40), SOURCES,
                            coverage_target=0.95)
        b0, _ = proto.admit(g, b0, [11, 12], coverage_target=0.02)
        kw = {"donate": False} if mod is RMB else {}
        b1, _ = eng.run_batch_until_coverage(g, proto, b0, key,
                                             max_rounds=2, **kw)
        out.append((b0, b1))
    return out


# ------------------------------------------------------------- checksums


def test_batch_checksums_equal_across_packages(batches):
    (r0, r1), (p0, p1) = batches
    assert PH.state_checksum(p0) == RH.state_checksum(r0)
    assert PH.state_checksum(p1) == RH.state_checksum(r1)
    assert PH.state_checksum(p0) != PH.state_checksum(p1)


def test_tree_checksums_equal_across_packages(graphs):
    g_r, g_p = graphs
    rs = RF.Flood(source=5).init(g_r, jax.random.key(0))
    ps = PF.Flood(source=5).init(g_p, prng.key(0))
    assert PH.state_checksum(ps) == RH.state_checksum(rs)
    x = np.arange(16, dtype=np.int32)
    tree_r = {"b": (jnp.asarray(x), jnp.float32(2.5)), "a": [jnp.asarray(x)]}
    tree_p = {"b": (torch.from_numpy(x), torch.tensor(2.5)),
              "a": [torch.from_numpy(x)]}
    assert PH.state_checksum(tree_p) == RH.state_checksum(tree_r)
    flipped = {"b": (torch.from_numpy(x ^ (np.arange(16) == 7)),
                     torch.tensor(2.5)), "a": [torch.from_numpy(x)]}
    assert PH.state_checksum(flipped) != PH.state_checksum(tree_p)


def test_batch_dispatch_leaves_its_input_untouched(graphs, batches):
    """The retained input is the healer's rollback state: a dispatch of
    the batch loop must not modify it."""
    _, g_p = graphs
    _, (p0, _) = batches
    before = PH.state_checksum(p0)
    PE.run_batch_until_coverage(g_p, PMB.BatchFlood(), p0, prng.key(1),
                                max_rounds=4)
    assert PH.state_checksum(p0) == before


# --------------------------------------------------------------- checks


def _raised(fn, *args):
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 — the exception is the result
        return (type(e).__name__, getattr(e, "kind", None),
                getattr(e, "leaf", None), str(e))
    return None


def test_audit_state_equals_the_reference():
    tpl = {"a": np.zeros((4,), np.float32), "b": np.zeros(2, np.int32)}
    cases = [
        {"a": np.ones(4, np.float32), "b": np.ones(2, np.int32)},
        {"a": np.zeros(5, np.float32), "b": np.zeros(2, np.int32)},
        {"a": np.zeros(4, np.int32), "b": np.zeros(2, np.int32)},
        {"a": np.array([1.0, np.nan, 0.0, 0.0], np.float32),
         "b": np.zeros(2, np.int32)},
        {"a": np.zeros(4, np.float32)},
    ]
    for case in cases:
        want = _raised(RH.audit_state, case, tpl)
        got = _raised(PH.audit_state,
                      {k: torch.from_numpy(v) for k, v in case.items()}, tpl)
        assert got == want


def test_batch_audit_and_monotonicity_equal_the_reference(batches):
    (r0, r1), (p0, p1) = batches
    r_tpl = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype), r0)
    p_tpl = PH.host_template(p0)
    assert _raised(PH.audit_state, p1, p_tpl) is None
    assert _raised(PH.audit_state, p1, r_tpl) is None  # numpy template
    damage = [
        lambda b, z: dataclasses.replace(b, seen=z(b.seen)),
        lambda b, z: dataclasses.replace(b, rounds=b.rounds - 1),
        lambda b, z: dataclasses.replace(b, seen_count=b.seen_count - 1),
        lambda b, z: dataclasses.replace(b, done=z(b.done)),
        lambda b, z: dataclasses.replace(b, target=b.target * np.nan),
        lambda b, z: dataclasses.replace(b, source=b.source[:-1]),
    ]
    assert np.asarray(r1.done).any()
    for hurt in damage:
        bad_r, bad_p = hurt(r1, jnp.zeros_like), hurt(p1, torch.zeros_like)
        assert _raised(PH.check_monotonic, p1, bad_p) \
            == _raised(RH.check_monotonic, r1, bad_r)
        assert _raised(PH.audit_state, bad_p, p_tpl) \
            == _raised(RH.audit_state, bad_r, r_tpl)
    assert _raised(PH.check_monotonic, p1, p0) \
        == _raised(RH.check_monotonic, r1, r0)
    PH.check_monotonic((1, 2), (3, 4))  # non-batch states pass


def test_one_host_pull_per_checked_chunk(batches):
    _, (p0, p1) = batches
    h = PH.Healer(PH.RetryPolicy(), template=PH.host_template(p0),
                  registry=PT.Registry())
    before = _device.SYNCS
    h.check(p0, p1, chunk=0)
    assert _device.SYNCS == before  # CPU tensors: nothing to wait for


# --------------------------------------------------------------- policy


@pytest.mark.parametrize("kw", [
    {}, dict(max_attempts=5, backoff_base_s=0.1, backoff_max_s=0.5,
             jitter=0.5, seed=42), dict(seed=7, jitter=1.0),
    dict(backoff_base_s=0.0)])
def test_retry_policy_equals_the_reference(kw):
    r, p = RH.RetryPolicy(**kw), PH.RetryPolicy(**kw)
    for salt in (0, 1, 17):
        assert p.delays(6, salt=salt) == r.delays(6, salt=salt)
    for cls in ("integrity", "preempt", "wedged", "unknown", None):
        assert p.action_for(cls) == r.action_for(cls)


def test_retry_policy_validation_and_classes():
    for kw in (dict(max_attempts=0), dict(jitter=2.0),
               dict(backoff_base_s=-1.0)):
        with pytest.raises(ValueError):
            PH.RetryPolicy(**kw)
    with pytest.raises(ValueError, match="route"):
        PH.RetryPolicy(routes={"integrity": "pray"})
    with pytest.raises(ValueError, match="1-based"):
        PH.RetryPolicy().backoff_s(0)
    from p2pnetwork_tpu_torch.supervise.watchdog import StallTimeout

    assert PH.classify_failure(PH.IntegrityViolation("checksum")) \
        == "integrity"
    assert PH.classify_failure(PD.ChipLost(0)) == "preempt"
    assert PH.classify_failure(PD.WedgedDispatch(1)) == "wedged"
    assert PH.classify_failure(StallTimeout("x", 1.0, 0.5)) == "wedged"
    assert PH.classify_failure(ValueError("nope")) is None
    assert str(PH.IntegrityViolation("template", leaf=".seen", chunk=3,
                                     shard=2, detail="d")) \
        == str(RH.IntegrityViolation("template", leaf=".seen", chunk=3,
                                     shard=2, detail="d"))


# --------------------------------------------------------------- healer


def _policy(**kw):
    kw.setdefault("backoff_base_s", 0.0)
    return PH.RetryPolicy(**kw)


def test_healer_heals_a_one_shot_fault_and_counts():
    reg = PT.Registry()
    calls = []

    def dispatch(s):
        calls.append(s)
        if len(calls) == 1:
            raise PD.ChipLost(0)
        return s + 1, {"ok": True}

    h = PH.Healer(_policy(max_attempts=3), registry=reg)
    assert h.run_chunk(dispatch, 10, chunk_index=0) == (11, {"ok": True})
    assert calls == [10, 10]  # the retained input, rolled back
    assert reg.value("heal_retries_total", outcome="retry") == 1
    assert reg.value("heal_retries_total", outcome="healed") == 1
    assert reg.value("heal_rollbacks_total", source="retained") == 1
    assert h.last_report == {
        "chunk": 0, "attempts": 2, "healed": True, "fallback": False,
        "exhausted": False, "events": [{"attempt": 1, "failure": "preempt",
                                        "action": "retry",
                                        "degraded": False}]}


def test_healer_budget_and_unroutable_errors():
    reg = PT.Registry()

    def wedged(s):
        raise PD.WedgedDispatch(0)

    with pytest.raises(PD.WedgedDispatch):
        PH.Healer(_policy(max_attempts=2), registry=reg).run_chunk(wedged, 0)
    assert reg.value("heal_retries_total", outcome="exhausted") == 1
    assert reg.value("heal_retries_total", outcome="retry") == 1

    def buggy(s):
        raise KeyError("caller bug, not a device fault")

    with pytest.raises(KeyError):
        PH.Healer(_policy(), registry=PT.Registry()).run_chunk(buggy, 0)


def test_healer_routes_integrity_to_the_fallback():
    reg = PT.Registry()
    tpl = {"x": np.zeros(4, np.float32)}

    def bad(s):
        return {"x": torch.full((4,), float("nan"))}, {}

    def good(s):
        return {"x": torch.ones(4)}, {}

    h = PH.Healer(_policy(max_attempts=3), template=tpl,
                  fallback_dispatch=good, registry=reg)
    state, _ = h.run_chunk(bad, {"x": torch.zeros(4)}, chunk_index=1)
    assert torch.equal(state["x"], torch.ones(4))
    assert reg.value("heal_retries_total", outcome="fallback") == 1
    assert reg.value("quake_integrity_failures_total", kind="nonfinite") == 1
    assert h.last_report["events"][0]["leaf"] == "['x']"


def test_healer_verify_catches_silent_corruption():
    """Corrupt halo hops mint well-formed but wrong states; only the
    checksum against a clean fold catches them, and the heal then lands
    bit-identical to the clean path."""
    g = PG.watts_strogatz(512, 6, 0.1, seed=1, device="cpu")
    mesh = TM.ring_mesh(8, device="cpu")
    sg = TS.shard_graph(g, mesh)
    spec = PD.FaultSpec(PD.FaultSchedule(seed=11, corrupt=0.3), "ppermute")

    def run(comm):
        def dispatch(state):
            return TS.flood_until_coverage(sg, mesh, 3, state0=state,
                                           return_state=True, comm=comm)
        return dispatch

    reg = PT.Registry()
    state0 = TS.init_state(sg, PF.Flood(source=3))
    h = PH.Healer(_policy(max_attempts=3), fallback_dispatch=run("pallas"),
                  verify_dispatch=run("pallas"), registry=reg)
    healed, _ = h.run_chunk(run(spec), state0, chunk_index=0)
    clean, _ = run("ppermute")(state0)
    assert PH.state_checksum(healed) == PH.state_checksum(clean)
    assert reg.value("quake_integrity_failures_total", kind="checksum") == 1
    assert reg.value("heal_retries_total", outcome="fallback") == 1


def test_healer_rolls_back_to_the_store(tmp_path):
    store = PSV.CheckpointStore(str(tmp_path), registry=PT.Registry())
    tpl = {"x": np.zeros(4, np.int32)}
    store.save({"x": torch.arange(4, dtype=torch.int32)}, prng.key(0), 3, 30)
    inputs = []

    def dispatch(s):
        inputs.append(s["x"].clone())
        if len(inputs) == 1:
            raise PD.ChipLost(0)
        return s, {}

    reg = PT.Registry()
    h = PH.Healer(_policy(max_attempts=2), template=tpl, store=store,
                  monotonic=False, registry=reg)
    h.run_chunk(dispatch, {"x": torch.zeros(4, dtype=torch.int32)})
    assert torch.equal(inputs[1], torch.arange(4, dtype=torch.int32))
    assert reg.value("heal_rollbacks_total", source="store") == 1


# ------------------------------------------------ serve and supervise


def _service(pkg, g, **kw):
    kw.setdefault("capacity", 32)
    kw.setdefault("chunk_rounds", 4)
    kw.setdefault("seed", 0)
    kw.setdefault("record_seen_hash", True)
    kw.setdefault("registry", (RT if pkg is RS else PT).Registry())
    heal = RH if pkg is RS else PH
    kw.setdefault("heal", heal.RetryPolicy(max_attempts=4,
                                           backoff_base_s=0.0))
    return pkg.SimService(g, **kw)


PATTERN = dict(ticks=10, rate=6.0, coverage_target=0.9)


@pytest.fixture(scope="module")
def reference_drive(graphs):
    g_r, _ = graphs
    svc = _service(RS, g_r)
    out = RS.drive(svc, RS.generate(RS.TrafficPattern(**PATTERN),
                                    g_r.n_nodes, seed=7))
    svc.close()
    return out


def test_healed_drive_equals_the_reference(graphs, reference_drive):
    _, g_p = graphs
    sched = PS.generate(PS.TrafficPattern(**PATTERN), g_p.n_nodes, seed=7)
    clean = _service(PS, g_p)
    want = PS.drive(clean, sched)
    clean.close()
    assert want == reference_drive

    reg, chaos_reg = PT.Registry(), PT.Registry()
    PD.install_dispatch_chaos(PD.DispatchChaos(registry=chaos_reg,
                                               **FAULTS))
    svc = _service(PS, g_p, registry=reg)
    tracer = spans.Tracer("heal")
    prev = spans.install_tracer(tracer)
    try:
        got = PS.drive(svc, sched)
    finally:
        spans.install_tracer(prev)
    svc.close()
    assert got == reference_drive  # seen hashes included
    assert got["completed"] > 0
    assert chaos_reg.value("chaos_device_faults_total", kind="preempt") == 1
    assert chaos_reg.value("chaos_device_faults_total", kind="wedge") == 1
    assert reg.value("heal_retries_total", outcome="healed") == 2
    assert reg.value("serve_healed_ticks_total") == 2
    kinds = {e.args["kind"] for e in tracer.find("ticket_fault")}
    assert kinds == {"preempt", "wedged"}
    assert tracer.find("ticket_heal_recovered")
    assert tracer.find("heal_retry") and tracer.find("dispatch_fault")


def test_integrity_fault_heals_with_the_ticket_chain(graphs, monkeypatch):
    """A chunk whose result loses seen bits fails the monotonicity check
    and is re-run; the riding tickets' traces carry the chain."""
    _, g_p = graphs
    clean = _service(PS, g_p)
    tids = [clean.submit(s) for s in SOURCES]
    for _ in range(6):
        clean.tick()
    want = [clean.poll(t) for t in tids]
    clean.close()

    real = PE.run_batch_until_coverage
    armed = {"on": True}

    def corrupting(graph, protocol, batch, key, **kw):
        b, out = real(graph, protocol, batch, key, **kw)
        if armed["on"]:
            armed["on"] = False
            b = dataclasses.replace(b, seen=torch.zeros_like(b.seen))
        return b, out

    monkeypatch.setattr(PE, "run_batch_until_coverage", corrupting)
    reg = PT.Registry()
    svc = _service(PS, g_p, registry=reg)
    tracer = spans.Tracer("heal")
    prev = spans.install_tracer(tracer)
    try:
        got_tids = [svc.submit(s) for s in SOURCES]
        for _ in range(6):
            svc.tick()
    finally:
        spans.install_tracer(prev)
    assert [svc.poll(t) for t in got_tids] == want
    svc.close()
    assert reg.value("quake_integrity_failures_total",
                     kind="monotonicity") == 1
    fails = tracer.find("ticket_integrity_fail")
    assert fails and fails[0].args["kind"] == "monotonicity"
    assert fails[0].args["leaf"] == "seen"


def test_service_preemption_not_swallowed(graphs):
    _, g_p = graphs
    svc = _service(PS, g_p)
    svc.submit(3)
    svc.arm_preemption(1)
    with pytest.raises(Preempted):
        for _ in range(3):
            svc.tick()


def test_chip_loss_without_heal_propagates(graphs):
    """Without ``heal=`` nothing swallows an injected chip loss: the tick
    raises it, and the ticket stays running for a retry of the tick."""
    _, g_p = graphs
    svc = _service(PS, g_p, heal=None)
    tid = svc.submit(3)
    PD.install_dispatch_chaos(PD.DispatchChaos(preempt_at=(0,)))
    with pytest.raises(PD.ChipLost):
        svc.tick()
    assert svc.poll(tid)["status"] == "running"
    svc.tick()  # one-shot: the next dispatch runs
    assert svc.stats()["round"] > 0
    svc.close()


def test_healed_supervised_run_equals_the_reference(tmp_path):
    g_r = RG.watts_strogatz(512, 6, 0.1, seed=1)
    g_p = PG.watts_strogatz(512, 6, 0.1, seed=1, device="cpu")
    ref = RSV.SupervisedRun(g_r, RF.Flood(source=0), str(tmp_path / "ref"),
                            chunk_rounds=3, registry=RT.Registry())
    st_ref, sum_ref = ref.run_until_coverage(jax.random.key(0),
                                             max_rounds=64)
    reg = PT.Registry()
    run = PSV.SupervisedRun(g_p, PF.Flood(source=0), str(tmp_path / "heal"),
                            chunk_rounds=3,
                            heal=PH.RetryPolicy(max_attempts=3,
                                                backoff_base_s=0.0),
                            registry=reg)
    PD.install_dispatch_chaos(PD.DispatchChaos(preempt_at=(1,)))
    seen_reports = []
    run.on_chunk = lambda r, info: seen_reports.append(info["heal"])
    st, summary = run.run_until_coverage(prng.key(0), max_rounds=64)
    assert PH.state_checksum(st) == RH.state_checksum(st_ref)
    for k in ("rounds", "messages", "coverage", "chunks"):
        assert summary[k] == sum_ref[k], k
    assert reg.value("heal_retries_total", outcome="healed") == 1
    assert sum(1 for r in seen_reports if r["events"]) == 1
