"""The batched message plane against the JAX package, on the CPU.

- The lane algebra (``ops/bitset.py``): expand/collapse, the 32x32 bit
  transpose, lane counts (plain and weighted) and the lane-wide
  scatter-OR, word for word as ``uint32``.
- ``propagate_or_lanes`` by every method on WS, ER and BA, healthy and
  churned (runtime links, failed nodes), word for word.
- ``BatchFlood`` through ``run_batch_until_coverage``: the summary dict,
  every field of the final batch and ``lane_messages`` equal the
  reference's exactly, at ragged capacities and by every method; each
  lane equals the port's own single ``Flood``; a dead source; failures
  between calls (the latched ``refresh``); admit, retire, admit;
  ``LaneExhausted``.
- The batch and query summaries, byte for byte; the structured overlays
  (``ring``, ``chord``, ``kademlia``, ``complete``, ``build``), byte for
  byte; a batch the reference admitted, carried by ``interop`` and
  resumed in the port.

No float is compared here: every result is an integer, a bool or a word.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from p2pnetwork_tpu.models import messagebatch as JMB  # noqa: E402
from p2pnetwork_tpu.ops import bitset as JBS  # noqa: E402
from p2pnetwork_tpu.ops import segment as JS  # noqa: E402
from p2pnetwork_tpu.sim import engine as JE  # noqa: E402
from p2pnetwork_tpu.sim import failures as JFa  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu.utils import accum as JA  # noqa: E402
from p2pnetwork_tpu_torch import interop, prng  # noqa: E402
from p2pnetwork_tpu_torch.models import flood as TF  # noqa: E402
from p2pnetwork_tpu_torch.models import messagebatch as TMB  # noqa: E402
from p2pnetwork_tpu_torch.ops import bitset as TBS  # noqa: E402
from p2pnetwork_tpu_torch.ops import frontier as TFR  # noqa: E402
from p2pnetwork_tpu_torch.ops import segment as TS  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine as TE  # noqa: E402
from p2pnetwork_tpu_torch.sim import failures as TFa  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402
from p2pnetwork_tpu_torch.utils import accum as TA  # noqa: E402
from tests.test_torch_churn import JAX_MODS, PORT_MODS, churn  # noqa: E402
from tests.test_torch_graph import (FAMILIES, assert_same_fields,  # noqa: E402
                                    build_jax, build_port, graph_fields,
                                    state_fields)

KEY = jax.random.key(0)
PKEY = prng.key(0)
N = 2048


def u32(x) -> np.ndarray:
    """Either package's words as numpy ``uint32``."""
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).view(np.uint32)


def t32(a: np.ndarray) -> torch.Tensor:
    """numpy ``uint32`` words as the port's ``int32``."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def words(shape, seed, density=0.5):
    rng = np.random.default_rng(seed)
    bits = rng.random((*shape, 32)) < density
    return (bits * (np.uint64(1) << np.arange(32, dtype=np.uint64))).sum(
        -1).astype(np.uint32)


@pytest.fixture(scope="module")
def ws():
    kw = {"seed": 0, "source_csr": True}
    return (JG.watts_strogatz(N, 10, 0.1, **kw),
            TG.watts_strogatz(N, 10, 0.1, device="cpu", **kw))


# ------------------------------------------------------------- lane algebra


def test_expand_and_collapse_equal_reference():
    w = words((5, 7), 0)
    got = TBS.expand_lanes(t32(w))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JBS.expand_lanes(jnp.asarray(w))))
    np.testing.assert_array_equal(u32(TBS.collapse_lanes(got)), w)
    assert u32(TBS.collapse_lanes(torch.ones(32, dtype=torch.bool))) == \
        np.uint32(0xFFFFFFFF)


@pytest.mark.parametrize("shape", [(32,), (2, 5, 32)])
def test_transpose_bits32_equals_reference(shape):
    w = words(shape, 1)
    np.testing.assert_array_equal(
        u32(TBS.transpose_bits32(t32(w))),
        np.asarray(JBS.transpose_bits32(jnp.asarray(w))))


@pytest.mark.parametrize("n,density,weighted", [
    (1000, 0.5, False), (1000, 0.02, True), (33, 1.0, False),
    (33, 1.0, True)])
def test_lane_counts_equal_reference(n, density, weighted):
    w = words((n,), n, density)
    wt = np.random.default_rng(2).integers(0, 40, n).astype(np.int32)
    got = TBS.lane_counts(t32(w), torch.from_numpy(wt) if weighted else None)
    want = JBS.lane_counts(jnp.asarray(w),
                           jnp.asarray(wt) if weighted else None)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,k,span", [(50, 400, None), (50, 400, 400),
                                      (7, 3, None), (300, 1000, None)])
def test_or_scatter_lanes_equals_reference(n, k, span):
    rng = np.random.default_rng(k)
    # Duplicates compose; index n (and beyond) drops.
    idx = rng.integers(0, n + 3, k).astype(np.int32)
    vals = words((k,), k + 1, 0.2)
    want = np.asarray(JBS.or_scatter_lanes(n, jnp.asarray(idx),
                                           jnp.asarray(vals)))
    got = TBS.or_scatter_lanes(n, torch.from_numpy(idx), t32(vals), span)
    np.testing.assert_array_equal(u32(got), want)
    # Leading word axes scatter every word at once.
    vals2 = words((2, k), k + 2, 0.2)
    got2 = TBS.or_scatter_lanes(n, torch.from_numpy(idx), t32(vals2), span)
    for w in range(2):
        np.testing.assert_array_equal(u32(got2[w]), np.asarray(
            JBS.or_scatter_lanes(n, jnp.asarray(idx), jnp.asarray(vals2[w]))))


# ----------------------------------------------------- propagate_or_lanes


@functools.lru_cache(maxsize=6)
def _graphs(family, churned):
    jg, tg = (build_jax(family, source_csr=True),
              build_port(family, source_csr=True))
    if churned:
        n = FAMILIES[family][1][0]
        jg, tg = churn(JAX_MODS, jg, n), churn(PORT_MODS, tg, n)
    return jg, tg


@pytest.mark.parametrize("method", ["gather", "segment", "frontier", "auto"])
@pytest.mark.parametrize("churned", [False, True], ids=["healthy", "churned"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_propagate_or_lanes_equals_reference(family, churned, method):
    jg, tg = _graphs(family, churned)
    n_pad = tg.n_nodes_padded
    # A sparse batch (the frontier's sparse branch) and a dense one.
    for seed, density in ((3, 0.002), (4, 0.3)):
        lanes = words((3, n_pad), seed, density)
        want = np.asarray(JS.propagate_or_lanes(jg, jnp.asarray(lanes),
                                                method))
        got = TS.propagate_or_lanes(tg, t32(lanes), method)
        np.testing.assert_array_equal(u32(got), want, err_msg=str(density))


def test_frontier_lanes_take_both_branches(ws):
    _, tg = ws
    TFR.ROUNDS.update(sparse=0, dense=0)
    for density in (0.0005, 0.5):
        TS.propagate_or_lanes(tg, t32(words((2, tg.n_nodes_padded), 5,
                                            density)), "frontier")
    assert TFR.ROUNDS == {"sparse": 1, "dense": 1}
    assert TFR.budget_slots_lanes(tg, None, 3) == \
        TFR.budget_slots(tg) * 32 * 3


@pytest.mark.parametrize("method", ["skew", "blocked", "hybrid"])
def test_propagate_or_lanes_refuses_other_methods(ws, method):
    with pytest.raises(ValueError, match="no word-level form"):
        TS.propagate_or_lanes(ws[1], torch.zeros((1, N), dtype=torch.int32),
                              method)


# --------------------------------------------------------------- BatchFlood


def assert_same_batch(got, want):
    """Every field of a port batch equals the reference's (words as u32)."""
    assert_same_fields(state_fields(got),
                       {k: (v.view(np.int32) if v.dtype == np.uint32 else v)
                        for k, v in state_fields(want).items()})


def assert_same_out(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def check_port(tg, method, tbatch, want, max_rounds=64):
    """The port's run of ``tbatch`` by ``method`` against the reference's
    ``want = ((batch, out), lane_messages)``."""
    tp = TMB.BatchFlood(method=method)
    ts, tout = TE.run_batch_until_coverage(tg, tp, tbatch, PKEY,
                                           max_rounds=max_rounds)
    (js, jout), jmsgs = want
    assert_same_out(tout, jout)
    assert_same_batch(ts, js)
    np.testing.assert_array_equal(TMB.lane_messages(tg, ts).numpy(), jmsgs)
    return ts, tout


def run_reference(jg, method, jbatch, max_rounds=64):
    jp = JMB.BatchFlood(method=method)
    js, jout = JE.run_batch_until_coverage(jg, jp, jbatch, KEY,
                                           max_rounds=max_rounds,
                                           donate=False)
    return (js, jout), np.asarray(JMB.lane_messages(jg, js))


def run_both(jg, tg, method, sources, max_rounds=64, jbatch=None,
             tbatch=None, **kw):
    if jbatch is None:
        jbatch = JMB.BatchFlood(method=method).init(jg, sources, **kw)
        tbatch = TMB.BatchFlood(method=method).init(tg, sources, **kw)
    want = run_reference(jg, method, jbatch, max_rounds)
    return want[0], check_port(tg, method, tbatch, want, max_rounds)


@functools.lru_cache(maxsize=4)
def reference_sweep(capacity):
    """The reference's ``auto`` run of ``capacity`` seeded sources on the
    module's graph (every method returns it: the reference pins its
    lowerings equal, and ``test_propagate_or_lanes_equals_reference``
    holds the port's lowerings to each of the reference's)."""
    jg = JG.watts_strogatz(N, 10, 0.1, seed=0, source_csr=True)
    sources = np.random.default_rng(capacity).integers(0, N, capacity)
    sources = sources.astype(np.int32)
    jp = JMB.BatchFlood()
    return sources, run_reference(jg, "auto", jp.init(jg, sources))


@pytest.mark.parametrize("method,capacity", [
    ("auto", 1), ("auto", 31), ("auto", 33), ("auto", 96),
    ("gather", 33), ("segment", 33), ("frontier", 33)])
def test_batch_flood_equals_reference_and_single_floods(ws, method,
                                                        capacity):
    _, tg = ws
    sources, want = reference_sweep(capacity)
    ts, tout = check_port(tg, method,
                          TMB.BatchFlood(method).init(tg, sources), want)
    assert tout["completed"] == capacity and tout["messages"] > 0
    # Lane by lane, the port's own single Flood from the same source.
    msgs = TMB.lane_messages(tg, ts).numpy()
    for lane in sorted({0, capacity // 2, capacity - 1}):
        state, single = TE.run_until_coverage(
            tg, TF.Flood(source=int(sources[lane])), PKEY, max_rounds=64)
        assert torch.equal(TMB.lane_seen(ts, lane), state.seen)
        assert tout["lane_rounds"][lane] == single["rounds"]
        assert msgs[lane] == single["messages"]
    assert tout["messages"] == int(msgs.sum())


def test_dead_source_spins_to_max_rounds(ws):
    jg, tg = ws
    jg = JFa.fail_nodes(jg, np.array([5], np.int32))
    tg = TFa.fail_nodes(tg, np.array([5], np.int32))
    _, (ts, tout) = run_both(jg, tg, "auto", [5, 9], max_rounds=12)
    assert tout["rounds"] == 12 and tout["active_lanes"] == 1
    assert not TMB.lane_seen(ts, 0).any()


def test_refresh_latches_across_failures_between_calls(ws):
    jg, tg = ws
    sources = [0, 700, 1500]
    (js, _), (ts, _) = run_both(jg, tg, "auto", sources, max_rounds=3)
    # Fail a band between calls: coverage is re-counted on the new mask.
    band = np.arange(100, 600, dtype=np.int32)
    jf, tf = JFa.fail_nodes(jg, band), TFa.fail_nodes(tg, band)
    (js, _), (ts, tout) = run_both(jf, tf, "auto", None, jbatch=js,
                                   tbatch=ts)
    # Then fail more: done lanes stay done (latched).
    more = np.arange(600, 1400, dtype=np.int32)
    _, (_, tout2) = run_both(JFa.fail_nodes(jf, more),
                             TFa.fail_nodes(tf, more), "auto", None,
                             jbatch=js, tbatch=ts)
    assert tout2["rounds"] == 0 and tout2["lane_done"][:3].all()


def test_admit_retire_admit_equals_reference(ws):
    jg, tg = ws
    jp, tp = JMB.BatchFlood(), TMB.BatchFlood()
    (js, _), (ts, _) = run_both(jg, tg, "auto", None,
                                jbatch=jp.init(jg, [3, 3, 40], capacity=40),
                                tbatch=tp.init(tg, [3, 3, 40], capacity=40))
    js, ts = jp.retire(js, [1]), tp.retire(ts, [1])
    assert_same_batch(ts, js)
    js, jl = jp.admit(jg, js, [8, 8, 2047, 3], coverage_target=0.5)
    ts, tl = tp.admit(tg, ts, [8, 8, 2047, 3], coverage_target=0.5)
    np.testing.assert_array_equal(tl, jl)
    assert_same_batch(ts, js)
    (js, _), (ts, _) = run_both(jg, tg, "auto", None, jbatch=js, tbatch=ts)
    assert TMB.free_lane_count(ts) == JMB.free_lane_count(js) == 64 - 6
    js, ts = jp.retire(js), tp.retire(ts)
    assert_same_batch(ts, js)
    assert TMB.free_lane_count(ts) == 64


def test_lane_exhausted_and_lane_checks(ws):
    _, tg = ws
    tp = TMB.BatchFlood()
    batch = tp.init(tg, list(range(30)))
    with pytest.raises(TMB.LaneExhausted) as err:
        tp.admit(tg, batch, list(range(3)))
    assert (err.value.requested, err.value.free_lanes,
            err.value.capacity) == (3, 2, 32)
    assert isinstance(err.value, ValueError)
    with pytest.raises(ValueError, match="outside this batch"):
        TMB.lane_seen(batch, 32)
    with pytest.raises(ValueError, match="outside this batch"):
        tp.retire(batch, [-1])
    with pytest.raises(ValueError, match="out of range"):
        tp.admit(tg, tp.empty(tg, 4), [N + 200])
    repadded = tp.repad(batch, tg.n_nodes_padded + 128)
    assert repadded.seen.shape == (1, tg.n_nodes_padded + 128)
    assert torch.equal(repadded.seen[:, :tg.n_nodes_padded], batch.seen)


# ------------------------------------------------------------- summaries


@pytest.mark.parametrize("messages", [0, 906_310_616, 2**32 + 5,
                                      (7 << 32) + 2**31 + 3])
def test_batch_and_query_summaries_equal_reference(messages):
    rng = np.random.default_rng(messages % 97)
    done = words((3,), 1)
    lane_rounds = rng.integers(0, 60, 96).astype(np.int32)
    vals = rng.random(96).astype(np.float32)
    hi, lo = messages >> 32, messages & 0xFFFFFFFF
    args = (7, 2, 94)
    want = np.asarray(JA.pack_batch_summary(
        *map(jnp.int32, args), (jnp.int32(hi), jnp.uint32(lo)),
        jnp.float32(0.7055689692497253), jnp.asarray(done),
        jnp.asarray(lane_rounds)))
    got = TA.pack_batch_summary(
        *map(torch.tensor, args), torch.tensor(messages),
        torch.tensor(0.7055689692497253), t32(done),
        torch.from_numpy(lane_rounds))
    np.testing.assert_array_equal(got.numpy(), want)
    out = TA.unpack_batch_summary(got.numpy(), 3)
    assert out["messages"] == messages
    assert_same_out(out, JA.unpack_batch_summary(want, 3))
    for values_float, v in ((True, vals), (False, lane_rounds * 3)):
        want = np.asarray(JA.pack_query_summary(
            *map(jnp.int32, args), (jnp.int32(hi), jnp.uint32(lo)),
            jnp.float32(0.25), jnp.asarray(done), jnp.asarray(lane_rounds),
            jnp.asarray(v), values_float=values_float))
        got = TA.pack_query_summary(
            *map(torch.tensor, args), torch.tensor(messages),
            torch.tensor(0.25), t32(done), torch.from_numpy(lane_rounds),
            torch.from_numpy(v), values_float=values_float)
        np.testing.assert_array_equal(got.numpy(), want)
        assert_same_out(
            TA.unpack_query_summary(got.numpy(), 90,
                                    values_float=values_float),
            JA.unpack_query_summary(want, 90, values_float=values_float))


# ------------------------------------------------------------- overlays


@pytest.mark.parametrize("name,args", [
    ("ring", (2,)), ("ring", (37,)), ("chord", (2,)), ("chord", (100,)),
    ("chord", (1000,)), ("kademlia", (2,)), ("kademlia", (64,)),
    ("kademlia", (100,)), ("kademlia", (1000, 3)), ("kademlia", (37, 3)),
    ("complete", (9,))])
def test_overlays_are_byte_equal(name, args):
    assert_same_fields(
        graph_fields(getattr(TG, name)(*args, device="cpu")),
        graph_fields(getattr(JG, name)(*args)))


@pytest.mark.parametrize("kind,n,k,p", [
    ("chord", 100, 0, 0.0), ("kademlia", 100, 3, 0.0), ("ring", 50, 0, 0.0),
    ("watts_strogatz", 200, 4, 0.1), ("barabasi_albert", 200, 2, 0.0),
    ("erdos_renyi", 200, 0, 0.05), ("complete", 6, 0, 0.0)])
def test_build_from_a_topology_description(kind, n, k, p):
    topo = types.SimpleNamespace(kind=kind, n_nodes=n, k=k, p=p, seed=3)
    assert_same_fields(graph_fields(TG.build(topo, device="cpu")),
                       graph_fields(JG.build(topo)))
    with pytest.raises(ValueError, match="unknown topology"):
        TG.build(types.SimpleNamespace(kind="torus", n_nodes=4),
                 device="cpu")


# ---------------------------------------------------------------- interop


def test_reference_admitted_batch_resumes_in_the_port(ws):
    jg, tg = ws
    jp = JMB.BatchFlood()
    jbatch = jp.init(jg, [1, 77, 1900], capacity=40)
    js, _ = JE.run_batch_until_coverage(jg, jp, jbatch, KEY, max_rounds=2,
                                        donate=False)
    fields = {k: np.asarray(v) for k, v in
              dataclasses.asdict(js).items()}
    ts = interop.message_batch_from_numpy(fields, device="cpu")
    assert_same_batch(ts, js)
    run_both(jg, tg, "auto", None, jbatch=js, tbatch=ts)
    with pytest.raises(NotImplementedError, match="extra"):
        interop.message_batch_from_numpy(dict(fields, extra=np.zeros(1)),
                                         device="cpu")
