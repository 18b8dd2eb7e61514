"""The port's supervise plane against the JAX package's, on the CPU.

- ``CheckpointStore``: the manifest's layout, retention, and resume past
  a corrupt newest entry, a missing entry and a lost manifest, with the
  same ``supervise_checkpoints_*`` counts as the reference's store given
  the same damage; a port-written store resumes in the reference.
- ``Watchdog``: a stall is detected, counted and raised at the next
  heartbeat; heartbeats keep it quiet.
- ``SupervisedRun`` of ``Flood`` (run-to-coverage) and ``SIR`` (a fixed
  number of rounds, keyed chunks): the final state's bits and the
  summary equal the reference's, uninterrupted and after a preemption
  and resume. ``heal=`` works (``tests/test_torch_heal.py`` holds healed
  runs against the reference); a failure class its policy routes to
  ``raise`` is refused healing and propagates.
"""

import json
import os
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu import supervise as RSV  # noqa: E402
from p2pnetwork_tpu import telemetry as RT  # noqa: E402
from p2pnetwork_tpu.models import flood as RF  # noqa: E402
from p2pnetwork_tpu.models import sir as RSIR  # noqa: E402
from p2pnetwork_tpu.sim import graph as RG  # noqa: E402
from p2pnetwork_tpu_torch import prng  # noqa: E402
from p2pnetwork_tpu_torch import supervise as PSV  # noqa: E402
from p2pnetwork_tpu_torch import telemetry as PT  # noqa: E402
from p2pnetwork_tpu_torch.models import flood as PF  # noqa: E402
from p2pnetwork_tpu_torch.models import sir as PSIR  # noqa: E402
from p2pnetwork_tpu_torch.sim import failures as PFa  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as PG  # noqa: E402
from tests.test_torch_graph import (assert_same_fields,  # noqa: E402,F401
                                    one_torch_thread, state_fields)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 2048


@pytest.fixture(scope="module")
def graphs():
    return (RG.watts_strogatz(N, 6, 0.1, seed=4),
            PG.watts_strogatz(N, 6, 0.1, seed=4, device="cpu"))


def _stores(tmp_path, retain=3):
    rr, pr = RT.Registry(), PT.Registry()
    return ((RSV.CheckpointStore(str(tmp_path / "ref"), retain=retain,
                                 registry=rr), rr),
            (PSV.CheckpointStore(str(tmp_path / "port"), retain=retain,
                                 registry=pr), pr))


def _fill(store, state, key, rounds):
    return [store.save(state, key, r, 10 * r) for r in rounds]


def _manifest(store):
    with open(os.path.join(store.directory, "manifest.json")) as f:
        return json.load(f)


def _masked(doc):
    """The manifest with the content hashes masked (zip members of the
    two packages' files need not be byte-equal)."""
    ents = [{k: (v[:17] if k == "file" else v) for k, v in e.items()
             if k != "sha256"} for e in doc["entries"]]
    return {"version": doc["version"], "latest": doc["latest"][:17],
            "entries": ents}


def test_store_manifest_and_retention(graphs, tmp_path):
    g_r, g_p = graphs
    (rs, _), (ps, _) = _stores(tmp_path)
    _fill(rs, RF.Flood(source=3).init(g_r, jax.random.key(0)),
          jax.random.key(5), [1, 2, 3, 4])
    _fill(ps, PF.Flood(source=3).init(g_p, prng.key(0)), prng.key(5),
          [1, 2, 3, 4])
    doc = _manifest(ps)
    assert set(doc) == {"version", "latest", "entries"}
    assert [e["round"] for e in doc["entries"]] == [2, 3, 4]
    assert set(doc["entries"][0]) == {"file", "round", "message_count",
                                      "sha256"}
    assert _masked(doc) == _masked(_manifest(rs))
    files = sorted(n for n in os.listdir(ps.directory) if n.endswith(".npz"))
    assert files == sorted(e["file"] for e in doc["entries"])
    assert ps.latest_round() == rs.latest_round() == 4


def test_port_store_resumes_in_the_reference(graphs, tmp_path):
    g_r, g_p = graphs
    (_, _), (ps, _) = _stores(tmp_path)
    state, _ = _run_port_flood(g_p, 3)
    ps.save(state, prng.key(9), 3, 123)
    template = RF.Flood(source=3).init(g_r, jax.random.key(0))
    got = RSV.CheckpointStore(ps.directory).load_latest(template)
    assert got is not None
    r_state, key, rnd, msgs, _ = got
    assert (rnd, msgs) == (3, 123)
    assert np.asarray(jax.random.key_data(key)).tolist() == [0, 9]
    assert_same_fields(state_fields(r_state), state_fields(state))


def _run_port_flood(g, rounds):
    from p2pnetwork_tpu_torch.sim import engine
    proto = PF.Flood(source=3)
    return engine.run_from(g, proto, proto.init(g, prng.key(0)),
                           prng.key(0), rounds)


def _damage(store, kind):
    ents = store.entries()
    if kind == "corrupt":
        path = os.path.join(store.directory, ents[-1]["file"])
        with open(path, "r+b") as f:
            f.seek(100)
            f.write(b"\xff" * 16)
    elif kind == "missing":
        os.unlink(os.path.join(store.directory, ents[-1]["file"]))
    else:
        os.unlink(os.path.join(store.directory, "manifest.json"))


@pytest.mark.parametrize("kind", ["corrupt", "missing", "manifest"])
def test_resume_skips_damage_like_the_reference(graphs, tmp_path, kind):
    g_r, g_p = graphs
    (rs, rr), (ps, pr) = _stores(tmp_path)
    r_state = RF.Flood(source=3).init(g_r, jax.random.key(0))
    p_state = PF.Flood(source=3).init(g_p, prng.key(0))
    _fill(rs, r_state, jax.random.key(5), [1, 2, 3])
    _fill(ps, p_state, prng.key(5), [1, 2, 3])
    _damage(rs, kind)
    _damage(ps, kind)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = rs.load_latest(r_state)
        got = ps.load_latest(p_state)
    assert got[2:4] == want[2:4]
    assert got[2] == (3 if kind == "manifest" else 2)
    name = "supervise_checkpoints_skipped_total"
    assert pr.snapshot()[name] == rr.snapshot()[name]
    assert pr.value("supervise_checkpoints_written_total") == 3


def test_watchdog_stall_raised_and_counted():
    reg = PT.Registry()
    dog = PSV.Watchdog(0.05, name="w", registry=reg).start()
    time.sleep(0.3)
    with pytest.raises(PSV.StallTimeout) as e:
        dog.heartbeat()
    assert e.value.name == "w" and e.value.stalled_s >= 0.05
    for _ in range(5):
        time.sleep(0.01)
        dog.heartbeat()
    dog.close()
    assert dog.stalls == 1
    assert reg.value("supervise_watchdog_timeouts_total", watchdog="w") == 1
    assert reg.value("supervise_stall_seconds", watchdog="w") == 0.0
    with pytest.raises(ValueError):
        PSV.Watchdog(0)


CASES = {
    "flood": (lambda: RF.Flood(source=7), lambda: PF.Flood(source=7),
              "run_until_coverage", {"max_rounds": 64}),
    "sir": (lambda: RSIR.SIR(beta=0.3, gamma=0.1),
            lambda: PSIR.SIR(beta=0.3, gamma=0.1), "run_rounds",
            {"rounds": 11}),
}


def _supervised(pkg, g, proto, entry, kw, directory, preempt_at=None):
    mod, key = ((RSV, jax.random.key(1)) if pkg == "ref"
                else (PSV, prng.key(1)))
    reg = (RT if pkg == "ref" else PT).Registry()
    run = mod.SupervisedRun(g, proto, str(directory), chunk_rounds=3,
                            registry=reg)
    if preempt_at is not None:
        if pkg == "ref":
            run.arm_preemption(preempt_at)
        else:
            PFa.preempt(run, preempt_at)
        with pytest.raises(mod.Preempted):
            getattr(run, entry)(key, **kw)
        run = mod.SupervisedRun(g, proto, str(directory), chunk_rounds=3,
                                registry=reg)
    state, summary = getattr(run, entry)(key, **kw)
    summary.pop("checkpoint_path")
    return state_fields(state), summary


@pytest.mark.parametrize("case", list(CASES))
def test_supervised_runs_equal_reference(graphs, tmp_path, case):
    g_r, g_p = graphs
    make_r, make_p, entry, kw = CASES[case]
    want = _supervised("ref", g_r, make_r(), entry, kw, tmp_path / "r")
    got = _supervised("port", g_p, make_p(), entry, kw, tmp_path / "p")
    assert_same_fields(got[0], want[0])
    assert got[1] == want[1]
    assert got[1]["chunks"] > 2
    # Preempted mid-run and resumed: the same bits again.
    res = _supervised("port", g_p, make_p(), entry, kw, tmp_path / "q",
                      preempt_at=6)
    assert_same_fields(res[0], want[0])
    assert res[1]["resumed_from"] == 3
    assert res[1]["rounds"] == want[1]["rounds"]
    assert res[1]["messages"] == want[1]["messages"]


def test_heal_is_refused(graphs, tmp_path):
    """A chip loss whose class the policy routes to ``raise`` is refused
    healing: it propagates from the first attempt, counted as no retry."""
    from p2pnetwork_tpu_torch.chaos import device as PD
    from p2pnetwork_tpu_torch.supervise.heal import RetryPolicy

    reg = PT.Registry()
    run = PSV.SupervisedRun(
        graphs[1], PF.Flood(), str(tmp_path), chunk_rounds=2,
        heal=RetryPolicy(routes={"preempt": "raise"}), registry=reg)
    prev = PD.install_dispatch_chaos(PD.DispatchChaos(preempt_at=(0,)))
    try:
        with pytest.raises(PD.ChipLost):
            run.run_until_coverage(prng.key(0), max_rounds=8)
    finally:
        PD.install_dispatch_chaos(prev)
    assert reg.value("heal_retries_total", outcome="retry") == 0
    assert reg.value("supervise_runs_total", outcome="error") == 1
