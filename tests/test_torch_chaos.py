"""The port's device chaos plane (``chaos/device.py`` and the ring's
fault-spec comms) against the JAX package's, on the CPU.

- ``FaultSchedule``: the kind at every (round, step, shard) of a grid,
  ``sites_between`` / ``counts_between``, and ``corrupt_payload`` on
  bool, ``uint8``, ``int16``, ``int32`` and ``float32`` payloads, equal to
  the reference's bit for bit (jax 0.9.0's threefry; the narrow payloads
  take the low bits of the 32-bit draw).
- A faulted ring flood on the 4,096-node WS graph, S = 8, under the three
  schedules of the reference's quake tests: dict, final ``seen`` and
  ``chaos_device_faults_total`` equal to the reference's (its ring on
  ``ppermute``, which it pins bit-identical to its Pallas hop), by every
  layout and both port backends; an empty schedule equal to the bare
  backend; a chunked flood (``fault_round0``) equal to the unchunked one;
  ``propagate(op="max")`` with corrupt hops exact against the
  reference.
- ``DispatchChaos``: one-shot, the gates of ``run_from``,
  ``run_until_coverage_from`` and ``run_batch_until_coverage`` (and no
  gate on ``run`` / ``run_until_coverage``, as in the reference), no-op
  while uninstalled, install returning the previous injector.

Every comparison is exact.
"""

import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from p2pnetwork_tpu import telemetry as RT  # noqa: E402
from p2pnetwork_tpu.chaos import device as RD  # noqa: E402
from p2pnetwork_tpu.parallel import mesh as JM  # noqa: E402
from p2pnetwork_tpu.parallel import sharded as JS  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu_torch import prng  # noqa: E402
from p2pnetwork_tpu_torch import telemetry as PT  # noqa: E402
from p2pnetwork_tpu_torch.chaos import device as PD  # noqa: E402
from p2pnetwork_tpu_torch.models.flood import Flood  # noqa: E402
from p2pnetwork_tpu_torch.models.messagebatch import BatchFlood  # noqa: E402
from p2pnetwork_tpu_torch.parallel import mesh as TM  # noqa: E402
from p2pnetwork_tpu_torch.parallel import sharded as TS  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

S = 8
#: The reference's quake schedules (tests/test_graftquake.py).
SCHEDULES = {
    "zero-delay": dict(seed=7, zero=0.15, delay=0.1),
    "corrupt-zero-delay": dict(seed=5, corrupt=0.05, zero=0.1, delay=0.1),
    "blackout-round-1": dict(seed=0, zero=1.0, start_round=1,
                             stop_round=2),
}
#: Windows, explicit sites and a dense corrupt schedule besides.
GRID_SCHEDULES = dict(SCHEDULES, **{
    "windowed": dict(seed=4, corrupt=0.1, zero=0.1, delay=0.1,
                     start_round=2, stop_round=5),
    "sites": dict(seed=3, corrupt=0.3,
                  sites=((2, 1, 1, "delay"), (7, 2, 3, "zero"))),
    "empty": dict(seed=9),
})
LAYOUTS = {"segment": {}, "mxu": {"mxu": True}, "hybrid": {"hybrid": True}}


@pytest.fixture(autouse=True)
def no_dispatch_chaos():
    prev_r = RD.install_dispatch_chaos(None)
    prev_p = PD.install_dispatch_chaos(None)
    yield
    RD.install_dispatch_chaos(prev_r)
    PD.install_dispatch_chaos(prev_p)


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < S:
        pytest.skip(f"needs {S} devices (the virtual CPU mesh of conftest)")
    return JM.ring_mesh(S), TM.ring_mesh(S, device="cpu")


@functools.lru_cache(maxsize=None)
def _graphs():
    return (JG.watts_strogatz(4096, 10, 0.1, seed=0),
            TG.watts_strogatz(4096, 10, 0.1, seed=0, device="cpu"))


@functools.lru_cache(maxsize=None)
def _sharded(layout):
    jg, tg = _graphs()
    return (JS.shard_graph(jg, JM.ring_mesh(S), **LAYOUTS[layout]),
            TS.shard_graph(tg, TM.ring_mesh(S, device="cpu"),
                           **LAYOUTS[layout]))


def _fault_counts(reg):
    return {k: reg.value("chaos_device_faults_total", kind=k)
            for k in RD.FAULT_KINDS}


# ------------------------------------------------------- fault schedules


@pytest.mark.parametrize("name", list(GRID_SCHEDULES))
def test_kinds_on_a_grid_equal_the_reference(name):
    kw = GRID_SCHEDULES[name]
    ref, port = RD.FaultSchedule(**kw), PD.FaultSchedule(**kw)
    rr, tt, dd = (a.ravel() for a in np.meshgrid(
        np.arange(12), np.arange(S - 1), np.arange(S), indexing="ij"))
    want = np.asarray(jax.vmap(ref.kind_at)(rr, tt, dd))
    np.testing.assert_array_equal(port.kinds(rr, tt, dd), want)
    assert port.kind_at(int(rr[-1]), int(tt[-1]), int(dd[-1])) == want[-1]
    assert port.active == ref.active


@pytest.mark.parametrize("name", list(GRID_SCHEDULES))
def test_sites_and_counts_equal_the_reference(name):
    kw = GRID_SCHEDULES[name]
    ref, port = RD.FaultSchedule(**kw), PD.FaultSchedule(**kw)
    for window in ((0, 10), (3, 8), (5, 5)):
        assert port.sites_between(*window, S - 1, S) \
            == ref.sites_between(*window, S - 1, S)
        assert port.counts_between(*window, S - 1, S) \
            == ref.counts_between(*window, S - 1, S)


def _payload(dtype, n=257):
    rng = np.random.default_rng(0)
    if dtype == np.bool_:
        return rng.integers(0, 2, n).astype(bool)
    if dtype == np.float32:
        return rng.standard_normal(n).astype(np.float32)
    return rng.integers(np.iinfo(dtype).min, np.iinfo(dtype).max, n,
                        endpoint=True).astype(dtype)


@pytest.mark.parametrize("dtype", [np.bool_, np.uint8, np.int16, np.int32,
                                   np.float32],
                         ids=["bool", "uint8", "int16", "int32", "float32"])
def test_corrupt_payload_equals_the_reference(dtype):
    kw = dict(seed=5, corrupt=1.0, corrupt_density=0.25)
    ref, port = RD.FaultSchedule(**kw), PD.FaultSchedule(**kw)
    x = _payload(dtype)
    for site in ((0, 0, 0), (3, 2, 5), (17, 6, 7)):
        want = np.asarray(ref.corrupt_payload(jnp.asarray(x), *site))
        got = port.corrupt_payload(torch.from_numpy(x.copy()), *site)
        assert got.dtype == torch.from_numpy(x).dtype
        assert got.numpy().tobytes() == want.tobytes()
        assert got.numpy().tobytes() != x.tobytes()


def test_schedule_and_spec_validation_match_the_reference():
    for kw, match in ((dict(corrupt=0.7, zero=0.4), "probabilities"),
                      (dict(delay=-0.1), "probabilities"),
                      (dict(corrupt_density=0.0), "corrupt_density"),
                      (dict(sites=((0, 0, 0, "explode"),)), "kind")):
        for mod in (RD, PD):
            with pytest.raises(ValueError, match=match):
                mod.FaultSchedule(**kw)
    with pytest.raises(ValueError, match="resolve 'auto'"):
        PD.FaultSpec(PD.FaultSchedule(), backend="auto")
    a = PD.FaultSpec(PD.FaultSchedule(seed=1, zero=0.1), "pallas")
    b = PD.FaultSpec(PD.FaultSchedule(seed=1, zero=0.1), "pallas")
    assert a == b and {a: 1}[b] == 1
    assert PD.FaultSchedule(sites=[[1, 0, 0, "zero"]]).sites \
        == ((1, 0, 0, "zero"),)


def test_unreachable_sites_warn():
    spec = PD.FaultSpec(PD.FaultSchedule(sites=(
        (0, 1, 2, "zero"), (0, 9, 0, "corrupt"), (3, 0, 7, "delay"))))
    with pytest.warns(PD.UnreachableFaultSite, match="2 explicit"):
        spec.make("shards", 4)
    with warnings.catch_warnings():
        warnings.simplefilter("error", PD.UnreachableFaultSite)
        PD.FaultSpec(PD.FaultSchedule(sites=((0, 1, 2, "zero"),))).make(
            "shards", 4)


def test_record_faults_is_the_host_replay():
    sched = PD.FaultSchedule(seed=1, zero=0.3)
    reg = PT.Registry()
    counts = PD.record_faults(sched, rounds=5, n_steps=S - 1, n_shards=S,
                              registry=reg)
    assert counts == sched.counts_between(0, 5, S - 1, S)
    assert counts == RD.record_faults(RD.FaultSchedule(seed=1, zero=0.3),
                                      rounds=5, n_steps=S - 1, n_shards=S,
                                      registry=RT.Registry())
    assert reg.value("chaos_device_faults_total", kind="zero") \
        == counts["zero"]


# ------------------------------------------------- faulted ring floods


@functools.lru_cache(maxsize=None)
def _reference_flood(name):
    jsg, _ = _sharded("segment")
    reg = RT.default_registry()
    before = _fault_counts(reg)
    spec = RD.FaultSpec(RD.FaultSchedule(**SCHEDULES[name]), "ppermute")
    seen, out = JS.flood_until_coverage(jsg, JM.ring_mesh(S), 3,
                                        max_rounds=64, comm=spec)
    after = _fault_counts(reg)
    return (np.asarray(seen), out,
            {k: after[k] - before[k] for k in RD.FAULT_KINDS})


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", list(SCHEDULES))
def test_faulted_ring_flood_equals_the_reference(meshes, name, layout):
    want_seen, want, want_counts = _reference_flood(name)
    _, tsg = _sharded(layout)
    reg = PT.default_registry()
    for backend in ("ppermute", "pallas"):
        before = _fault_counts(reg)
        spec = PD.FaultSpec(PD.FaultSchedule(**SCHEDULES[name]), backend)
        seen, out = TS.flood_until_coverage(tsg, meshes[1], 3,
                                            max_rounds=64, comm=spec)
        after = _fault_counts(reg)
        assert out == want, backend
        np.testing.assert_array_equal(seen.numpy(), want_seen)
        assert {k: after[k] - before[k] for k in RD.FAULT_KINDS} \
            == want_counts
    if layout == "segment":
        # The faults move the run: the blackout costs rounds.
        _, clean = TS.flood_until_coverage(tsg, meshes[1], 3, max_rounds=64)
        assert out != clean


@pytest.mark.parametrize("layout", ["segment", "mxu"])
def test_empty_schedule_is_the_bare_backend(meshes, layout):
    _, tsg = _sharded(layout)
    for backend in ("ppermute", "pallas"):
        bare_seen, bare = TS.flood_until_coverage(tsg, meshes[1], 3,
                                                  comm=backend)
        spec = PD.FaultSpec(PD.FaultSchedule(seed=9), backend)
        seen, out = TS.flood_until_coverage(tsg, meshes[1], 3, comm=spec)
        assert out == bare
        assert torch.equal(seen, bare_seen)


def test_chunked_flood_keys_the_global_round(meshes):
    """A flood resumed with ``fault_round0`` hits the sites an unchunked
    run hits: the same final state and rounds."""
    _, tsg = _sharded("segment")
    spec = PD.FaultSpec(PD.FaultSchedule(**SCHEDULES["zero-delay"]),
                        "ppermute")
    (seen_u, front_u), whole = TS.flood_until_coverage(
        tsg, meshes[1], 3, comm=spec, return_state=True)
    state, r = None, 0
    for _ in range(16):
        state, part = TS.flood_until_coverage(
            tsg, meshes[1], 3, comm=spec, max_rounds=3, state0=state,
            return_state=True, fault_round0=r)
        r += part["rounds"]
        if part["rounds"] < 3:
            break
    assert r == whole["rounds"]
    assert torch.equal(state[0], seen_u) and torch.equal(state[1], front_u)


def test_faulted_propagate_equals_the_reference(meshes):
    """``propagate`` runs at round 0, as the reference's does; the corrupt
    hops of an ``int32`` payload flip bits through ``random_bits``."""
    jsg, tsg = _sharded("segment")
    sig = np.random.default_rng(3).integers(-1000, 1000, (S, tsg.block))
    sig = sig.astype(np.int32)
    kw = dict(seed=2, corrupt=0.4, zero=0.2, delay=0.2)
    want = JS.propagate(jsg, meshes[0], jnp.asarray(sig), op="max",
                        comm=RD.FaultSpec(RD.FaultSchedule(**kw),
                                          "ppermute"))
    got = TS.propagate(tsg, meshes[1], torch.from_numpy(sig), op="max",
                       comm=PD.FaultSpec(PD.FaultSchedule(**kw), "pallas"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bare = TS.propagate(tsg, meshes[1], torch.from_numpy(sig), op="max")
    assert not torch.equal(got, bare)


# ------------------------------------------------------- dispatch chaos


def _batch(g, sources, capacity=32):
    proto = BatchFlood()
    b, _ = proto.admit(g, proto.empty(g, capacity), list(sources),
                       coverage_target=0.95)
    return proto, b


def test_batch_gate_preempts_once():
    g = TG.watts_strogatz(256, 4, 0.2, seed=0, device="cpu")
    proto, batch = _batch(g, [3, 9])
    reg = PT.Registry()
    PD.install_dispatch_chaos(PD.DispatchChaos(preempt_at=(0,),
                                               registry=reg))
    with pytest.raises(PD.ChipLost) as e:
        engine.run_batch_until_coverage(g, proto, batch, prng.key(0))
    assert e.value.dispatch_index == 0
    assert reg.value("chaos_device_faults_total", kind="preempt") == 1
    _, out = engine.run_batch_until_coverage(g, proto, batch, prng.key(0))
    assert out["completed"] == 2


def test_the_gated_loops_are_the_references():
    g = TG.watts_strogatz(256, 4, 0.2, seed=0, device="cpu")
    proto, key = Flood(source=0), prng.key(0)
    dc = PD.DispatchChaos(wedge_at=(0, 1))
    PD.install_dispatch_chaos(dc)
    # Not gated, as in the reference.
    engine.run(g, proto, key, 2)
    engine.run_until_coverage(g, proto, key, max_rounds=2)
    assert dc.dispatches == 0
    with pytest.raises(PD.WedgedDispatch):
        engine.run_until_coverage_from(g, proto, proto.init(g, key), key,
                                       max_rounds=2)
    with pytest.raises(PD.WedgedDispatch):
        engine.run_from(g, proto, proto.init(g, key), key, 2)
    engine.run_from(g, proto, proto.init(g, key), key, 2)  # disarmed
    assert dc.dispatches == 3


def test_uninstalled_gate_is_a_noop_and_install_returns_previous():
    g = TG.watts_strogatz(256, 4, 0.2, seed=0, device="cpu")
    proto, batch = _batch(g, [3])
    _, out = engine.run_batch_until_coverage(g, proto, batch, prng.key(0))
    assert out["completed"] == 1
    a, b = PD.DispatchChaos(), PD.DispatchChaos()
    assert PD.install_dispatch_chaos(a) is None
    assert PD.install_dispatch_chaos(b) is a
    assert PD.install_dispatch_chaos(None) is b
