"""The ring's sender-CSR view and walk, and its lane-packed batched plane
(``parallel/sharded.py``), against the JAX package's ring.

The JAX ring runs on the 8-device virtual CPU mesh of
``tests/conftest.py`` with ``comm="ppermute"``; the port runs both of its
comms. Everything here is exact: the CSR arrays byte for byte, the walk's
visited set and stats (its draws are keyed by edge identity), the lane
words, every field of the returned batch and the batched summary dict.
Graphs: ``ws512`` and the ragged ER(300) of ``tests/test_torch_ring.py``,
healthy and churned (failed nodes, then runtime links).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu.chaos import device as RD  # noqa: E402
from p2pnetwork_tpu.models import messagebatch as JMB  # noqa: E402
from p2pnetwork_tpu.models import walk as JW  # noqa: E402
from p2pnetwork_tpu.parallel import mesh as JM  # noqa: E402
from p2pnetwork_tpu.parallel import sharded as JS  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu.telemetry import registry as RT  # noqa: E402
from p2pnetwork_tpu_torch import prng  # noqa: E402
from p2pnetwork_tpu_torch import telemetry as PT  # noqa: E402
from p2pnetwork_tpu_torch.chaos import device as PD  # noqa: E402
from p2pnetwork_tpu_torch.models import messagebatch as TMB  # noqa: E402
from p2pnetwork_tpu_torch.models import walk as TW  # noqa: E402
from p2pnetwork_tpu_torch.parallel import mesh as TM  # noqa: E402
from p2pnetwork_tpu_torch.parallel import sharded as TS  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

S = 8
GRAPHS = {
    "ws512": ("watts_strogatz", (512, 4, 0.2), {"seed": 0}),
    "er300": ("erdos_renyi", (300, 0.02), {"seed": 1}),
}
CASES = [(g, c) for g in GRAPHS for c in (False, True)]
CASE_IDS = [f"{g}-{'churned' if c else 'healthy'}" for g, c in CASES]
COMMS = ("ppermute", "pallas")
FAILED = [5, 40, 77]
LINKS = ([2, 9, 100], [280, 260, 7])
#: The fault schedule of the faulted batch: every kind, early rounds.
FAULTS = dict(seed=5, corrupt=0.2, zero=0.2, delay=0.2)


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < S:
        pytest.skip(f"needs {S} devices (the virtual CPU mesh of conftest)")
    return JM.ring_mesh(S), TM.ring_mesh(S, device="cpu")


@pytest.fixture(autouse=True)
def no_dispatch_chaos():
    prev = PD.install_dispatch_chaos(None)
    yield
    PD.install_dispatch_chaos(prev)


@functools.lru_cache(maxsize=None)
def _graphs(name):
    fn, args, kw = GRAPHS[name]
    return (getattr(JG, fn)(*args, **kw),
            getattr(TG, fn)(*args, **kw, device="cpu"))


@functools.lru_cache(maxsize=None)
def _sharded(name, churned, csr=False):
    jg, tg = _graphs(name)
    jsg = JS.shard_graph(jg, JM.ring_mesh(S), source_csr=csr)
    tsg = TS.shard_graph(tg, TM.ring_mesh(S, device="cpu"), source_csr=csr)
    if churned:
        jsg = JS.connect(JS.with_capacity(JS.fail_nodes(jsg, FAILED), 16),
                         *LINKS)
        tsg = TS.connect(TS.with_capacity(TS.fail_nodes(tsg, FAILED), 16),
                         *LINKS)
    return jsg, tsg


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- sender-CSR, walk


@pytest.mark.parametrize("layout", [{}, {"mxu": True}, {"hybrid": True}],
                         ids=["segment", "mxu", "hybrid"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_source_csr_is_byte_equal(meshes, name, layout):
    jg, tg = _graphs(name)
    jsg = JS.shard_graph(jg, meshes[0], source_csr=True, **layout)
    tsg = TS.shard_graph(tg, meshes[1], source_csr=True, **layout)
    for f in ("csr_pos", "csr_offsets"):
        got, want = getattr(tsg, f).numpy(), np.asarray(getattr(jsg, f))
        assert (got.dtype, got.shape) == (want.dtype, want.shape), f
        assert got.tobytes() == want.tobytes(), f
    assert tsg.csr_span == jsg.csr_span > 0


@functools.lru_cache(maxsize=None)
def _jax_walk(name, churned, restart_p):
    jsg, _ = _sharded(name, churned, csr=True)
    proto = JW.RandomWalks(n_walkers=64, restart_p=restart_p)
    fixed = JS.walk(jsg, JM.ring_mesh(S), proto, jax.random.key(3), 12,
                    return_state=True)
    until = JS.walk_until_coverage(jsg, JM.ring_mesh(S), proto,
                                   jax.random.key(4), coverage_target=0.6,
                                   state0=fixed[0])
    return fixed, until


@pytest.mark.parametrize("name,churned,restart_p", [
    (g, c, 0.0) for g, c in CASES] + [("ws512", True, 0.2)],
    ids=CASE_IDS + ["ws512-churned-restart"])
def test_walk_equals_reference(meshes, name, churned, restart_p):
    (want_state, want_stats), (want_visited, want_out) = _jax_walk(
        name, churned, restart_p)
    _, tsg = _sharded(name, churned, csr=True)
    proto = TW.RandomWalks(n_walkers=64, restart_p=restart_p)
    state, stats = TS.walk(tsg, meshes[1], proto, prng.key(3), 12,
                           return_state=True)
    for got, want in zip(state, want_state):
        _same(got, want)
    for k in want_stats:
        # The engine's stacked stats: ints as i64, the port's convention.
        np.testing.assert_array_equal(stats[k].numpy(), want_stats[k])
    # The run to coverage, resumed from the fixed rounds, at T = 1 and 3.
    for T in (1, 3):
        visited, out = TS.walk_until_coverage(
            tsg, meshes[1], proto, prng.key(4), coverage_target=0.6,
            state0=state, steps_per_round=T)
        _same(visited, want_visited)
        assert out == want_out


def test_walk_refusals(meshes):
    _, tsg = _sharded("ws512", False)
    with pytest.raises(ValueError, match="sender-CSR"):
        TS.walk(tsg, meshes[1], TW.RandomWalks(n_walkers=4), prng.key(0), 1)
    _, csr = _sharded("ws512", False, csr=True)
    with pytest.raises(ValueError, match="steps_per_round"):
        TS.walk_until_coverage(csr, meshes[1], TW.RandomWalks(n_walkers=4),
                               prng.key(0), steps_per_round=0)


# ------------------------------------------------------------- the lanes


def _lanes(n_pad, words=3, seed=0):
    return np.random.default_rng(seed).integers(
        0, 2**32, (words, n_pad), dtype=np.uint32)


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("name,churned", CASES, ids=CASE_IDS)
def test_propagate_or_lanes_equals_reference(meshes, name, churned, comm):
    jsg, tsg = _sharded(name, churned)
    lanes = _lanes(_graphs(name)[1].n_nodes_padded)
    want = JS.propagate_or_lanes(jsg, meshes[0], JS.shard_lanes(jsg, lanes))
    sharded = TS.shard_lanes(tsg, torch.from_numpy(lanes.view(np.int32)))
    assert sharded.shape == (S, 3, tsg.block) and sharded.is_contiguous()
    _same(TS.unshard_lanes(tsg, sharded, lanes.shape[1]), lanes)
    _same(TS.propagate_or_lanes(tsg, meshes[1], sharded, comm=comm), want)


def _batch_pair(name, seed=0):
    jg, tg = _graphs(name)
    sources = np.random.default_rng(seed).integers(0, tg.n_nodes, 40)
    jp, tp = JMB.BatchFlood(), TMB.BatchFlood()
    return (jp, jp.init(jg, sources.astype(np.int32), coverage_target=0.9,
                        capacity=64)), \
        (tp, tp.init(tg, sources.astype(np.int32), coverage_target=0.9,
                     capacity=64))


def _same_batch(got, want):
    for f in ("seen", "frontier", "sent", "source", "admitted", "done",
              "rounds", "seen_count", "target"):
        _same(getattr(got, f), getattr(want, f))


def _same_out(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            _same(got[k], w)
        else:
            assert got[k] == w, k


@functools.lru_cache(maxsize=None)
def _jax_batch(name, churned):
    jsg, _ = _sharded(name, churned)
    (jp, jb), _ = _batch_pair(name)
    return JS.run_batch_until_coverage(jsg, JM.ring_mesh(S), jp, jb,
                                       max_rounds=64, donate=False)


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("name,churned", [("ws512", False), ("er300", True)],
                         ids=["ws512-healthy", "er300-churned"])
def test_run_batch_until_coverage_equals_reference(meshes, name, churned,
                                                   comm):
    want_batch, want_out = _jax_batch(name, churned)
    _, tsg = _sharded(name, churned)
    _, (tp, tb) = _batch_pair(name)
    got_batch, got_out = TS.run_batch_until_coverage(
        tsg, meshes[1], tp, tb, max_rounds=64, comm=comm)
    _same_batch(got_batch, want_batch)
    _same_out(got_out, want_out)
    assert got_out["completed"] > 0


def test_chunked_batch_resumes_the_lanes(meshes):
    # Chunks of 2 rounds carry the lanes in the batch itself: the last
    # chunk ends on the unchunked run's batch.
    want_batch, want_out = _jax_batch("ws512", False)
    _, tsg = _sharded("ws512", False)
    _, (tp, tb) = _batch_pair("ws512")
    rounds = 0
    for _ in range(32):
        tb, out = TS.run_batch_until_coverage(tsg, meshes[1], tp, tb,
                                              max_rounds=2)
        rounds += out["rounds"]
        if not out["active_lanes"]:
            break
    assert rounds == want_out["rounds"]
    _same_batch(tb, want_batch)


def _fault_counts(reg, kinds):
    return {k: reg.value("chaos_device_faults_total", kind=k) or 0
            for k in kinds}


def test_faulted_batch_equals_reference(meshes):
    # A FaultSpec comm faults the word stack's hops, keyed on the global
    # round fault_round0 + r; the faults the run hit are counted.
    jsg, tsg = _sharded("ws512", False)
    (jp, jb), (tp, tb) = _batch_pair("ws512", seed=1)
    jreg, treg = RT.default_registry(), PT.default_registry()
    j0, t0 = (_fault_counts(r, RD.FAULT_KINDS) for r in (jreg, treg))
    want_batch, want_out = JS.run_batch_until_coverage(
        jsg, meshes[0], jp, jb, max_rounds=64, donate=False, fault_round0=1,
        comm=RD.FaultSpec(RD.FaultSchedule(**FAULTS), "ppermute"))
    got_batch, got_out = TS.run_batch_until_coverage(
        tsg, meshes[1], tp, tb, max_rounds=64, fault_round0=1,
        comm=PD.FaultSpec(PD.FaultSchedule(**FAULTS), "pallas"))
    _same_batch(got_batch, want_batch)
    _same_out(got_out, want_out)
    j1, t1 = (_fault_counts(r, RD.FAULT_KINDS) for r in (jreg, treg))
    hit = {k: j1[k] - j0[k] for k in RD.FAULT_KINDS}
    assert {k: t1[k] - t0[k] for k in RD.FAULT_KINDS} == hit
    assert sum(hit.values()) > 0


def test_batch_gate_and_refusals(meshes):
    _, tsg = _sharded("ws512", False)
    _, (tp, tb) = _batch_pair("ws512")
    reg = PT.Registry()
    PD.install_dispatch_chaos(PD.DispatchChaos(preempt_at=(0,),
                                               registry=reg))
    with pytest.raises(PD.ChipLost):
        TS.run_batch_until_coverage(tsg, meshes[1], tp, tb)
    assert reg.value("chaos_device_faults_total", kind="preempt") == 1
    PD.install_dispatch_chaos(None)
    with pytest.raises(NotImplementedError, match="item 13"):
        TS.run_batch_until_coverage(tsg, meshes[1], tp, tb,
                                    recorder=object())
    mxu = TS.shard_graph(_graphs("ws512")[1], meshes[1], mxu=True)
    with pytest.raises(ValueError, match="MXU one-hot"):
        TS.run_batch_until_coverage(mxu, meshes[1], tp, tb)
    with pytest.raises(ValueError, match="MXU one-hot"):
        TS.propagate_or_lanes(mxu, meshes[1], TS.shard_lanes(mxu, tb.seen))
