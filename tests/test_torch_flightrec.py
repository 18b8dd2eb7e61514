"""The port's flight recorder against the JAX package's, on the CPU.

In every loop that records (``run_from``'s per-round form,
``run_until_coverage_from``'s early-exit loop at 1 and 3 steps per
super-step, the batch loop and the query loop) the ring's rows equal the
reference's bit for bit, including the wrap (``dropped``) of a ring
shorter than the run, and the run returns exactly what it returns without
a recorder. The recorder's only host transfer is the ring's one fetch at
the end of the run, counted in ``_device.SYNCS``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu import models as JM  # noqa: E402
from p2pnetwork_tpu.models import messagebatch as JMB  # noqa: E402
from p2pnetwork_tpu.models import querybatch as JQ  # noqa: E402
from p2pnetwork_tpu.sim import engine as JE  # noqa: E402
from p2pnetwork_tpu.sim import flightrec as JR  # noqa: E402
from p2pnetwork_tpu_torch import models as TM  # noqa: E402
from p2pnetwork_tpu_torch import _device, prng  # noqa: E402
from p2pnetwork_tpu_torch.models import messagebatch as TMB  # noqa: E402
from p2pnetwork_tpu_torch.models import querybatch as TQ  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine as TE  # noqa: E402
from p2pnetwork_tpu_torch.sim import flightrec as TR  # noqa: E402
from tests.test_torch_analytics import churn  # noqa: E402
from tests.test_torch_analytics import JFa, JT, TFa, TT  # noqa: E402
from tests.test_torch_graph import (LAYOUTS, build_jax,  # noqa: E402
                                    build_port, one_torch_thread,
                                    state_fields)
from tests.test_torch_semiring import bits  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_G = {}


def graphs(churned=False):
    if churned not in _G:
        jg, tg = build_jax("ws", **LAYOUTS), build_port("ws", **LAYOUTS)
        if churned:
            jg, tg = churn((JT, JFa), jg), churn((TT, TFa), tg)
        _G[churned] = jg, tg
    return _G[churned]


def assert_same_record(got, want):
    assert (got.rounds, got.capacity, got.dropped) == (
        want.rounds, want.capacity, want.dropped)
    assert got.columns == want.columns == TR.REC_COLS
    assert got.rows.dtype == np.float32 and got.rows.shape == want.rows.shape
    np.testing.assert_array_equal(bits(got.rows), bits(want.rows))
    assert got.as_dict() == want.as_dict()


def syncs(run):
    """``(result, host syncs counted during run())``."""
    before = _device.SYNCS
    out = run()
    return out, _device.SYNCS - before


def assert_same_state(got, want):
    g, w = state_fields(got), state_fields(want)
    for k in w:
        gk = g[k].view(np.uint32) if w[k].dtype == np.uint32 else g[k]
        np.testing.assert_array_equal(bits(gk), bits(w[k]), err_msg=k)


FLOODS = {
    "hybrid": lambda M: M.AdaptiveFlood(source=0, method="hybrid"),
    "frontier-bitset": lambda M: M.AdaptiveFlood(source=0,
                                                 method="frontier",
                                                 bitset=True),
    "sir": lambda M: M.SIR(beta=0.3, gamma=0.1, source=0, method="hybrid"),
}


@pytest.mark.parametrize("capacity", [4, 64], ids=["wraps", "fits"])
@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", sorted(FLOODS))
def test_coverage_loop_rows_equal_reference(name, steps, capacity):
    jg, tg = graphs(churned=name == "hybrid")
    jp, tp = FLOODS[name](JM), FLOODS[name](TM)
    kw = dict(coverage_target=0.9, steps_per_round=steps, max_rounds=64)
    js, jout = JE.run_until_coverage_from(
        jg, jp, jp.init(jg, jax.random.key(0)), jax.random.key(0),
        recorder=JR.FlightRecorder(capacity), donate=False, **kw)
    ts0 = tp.init(tg, prng.key(0))
    (ts, tout), rec_syncs = syncs(lambda: TE.run_until_coverage_from(
        tg, tp, ts0, prng.key(0), recorder=TR.FlightRecorder(capacity),
        **kw))
    assert_same_record(tout.pop("flight_record"), jout.pop("flight_record"))
    assert tout == jout
    assert_same_state(ts, js)
    (off_state, off), off_syncs = syncs(lambda: TE.run_until_coverage_from(
        tg, tp, ts0, prng.key(0), **kw))
    assert off == tout
    assert rec_syncs == off_syncs + 1
    assert_same_state(off_state, ts)


@pytest.mark.parametrize("capacity", [5, 32], ids=["wraps", "fits"])
@pytest.mark.parametrize("name", ["hybrid", "sir"])
def test_run_from_rows_equal_reference(name, capacity):
    jg, tg = graphs()
    jp, tp = FLOODS[name](JM), FLOODS[name](TM)
    js, jst, jrec = JE.run_from(jg, jp, jp.init(jg, jax.random.key(1)),
                                jax.random.key(1), 12, donate=False,
                                recorder=JR.FlightRecorder(capacity))
    ts0 = tp.init(tg, prng.key(1))
    ts, tst, trec = TE.run_from(tg, tp, ts0, prng.key(1), 12,
                                recorder=TR.FlightRecorder(capacity))
    assert_same_record(trec, jrec)
    assert_same_state(ts, js)
    off_state, off = TE.run_from(tg, tp, ts0, prng.key(1), 12)
    assert set(off) == set(tst)
    for k in off:
        np.testing.assert_array_equal(off[k].numpy(), tst[k].numpy())
    assert_same_state(off_state, ts)
    _, _, rec = TE.run(tg, tp, prng.key(1), 12,
                       recorder=TR.FlightRecorder(capacity))
    assert_same_record(rec, jrec)


@pytest.mark.parametrize("capacity", [3, 64], ids=["wraps", "fits"])
def test_batch_loop_rows_equal_reference(capacity):
    jg, tg = graphs(churned=True)
    src = np.array([0, 7, 900, 2000, 3999, 11, 12, 13, 14] * 4)
    jp, tp = JMB.BatchFlood(), TMB.BatchFlood()
    jb, jout = JE.run_batch_until_coverage(
        jg, jp, jp.init(jg, src), jax.random.key(0), donate=False,
        recorder=JR.FlightRecorder(capacity))
    tb0 = tp.init(tg, src)
    (tb, tout), rec_syncs = syncs(lambda: TE.run_batch_until_coverage(
        tg, tp, tb0, prng.key(0), recorder=TR.FlightRecorder(capacity)))
    assert_same_record(tout.pop("flight_record"), jout.pop("flight_record"))
    (_, off), off_syncs = syncs(lambda: TE.run_batch_until_coverage(
        tg, tp, tb0, prng.key(0)))
    assert rec_syncs == off_syncs + 1
    for k in jout:
        np.testing.assert_array_equal(np.asarray(tout[k]),
                                      np.asarray(jout[k]), err_msg=k)
        np.testing.assert_array_equal(np.asarray(off[k]),
                                      np.asarray(tout[k]), err_msg=k)


QUERIES = {
    "min-plus": (lambda Q: Q.MinPlusQueries(),
                 lambda p, g: p.init(g, [0, 9, 300], [100, 200, 4000],
                                     capacity=5)),
    "dht": (lambda Q: Q.DhtLookups(),
            lambda p, g: p.init(g, [0, 9, 300], [100, 200, 4000])),
}


@pytest.mark.parametrize("capacity", [2, 64], ids=["wraps", "fits"])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_loop_rows_equal_reference(name, capacity):
    jg, tg = graphs()
    make, init = QUERIES[name]
    jp, tp = make(JQ), make(TQ)
    jb, jout = JE.run_queries_until_done(
        jg, jp, init(jp, jg), jax.random.key(0), donate=False,
        recorder=JR.FlightRecorder(capacity))
    tb0 = init(tp, tg)
    (tb, tout), rec_syncs = syncs(lambda: TE.run_queries_until_done(
        tg, tp, tb0, prng.key(0), recorder=TR.FlightRecorder(capacity)))
    assert_same_record(tout.pop("flight_record"), jout.pop("flight_record"))
    (_, off), off_syncs = syncs(lambda: TE.run_queries_until_done(
        tg, tp, tb0, prng.key(0)))
    assert rec_syncs == off_syncs + 1
    for k in jout:
        np.testing.assert_array_equal(bits(np.asarray(tout[k])),
                                      bits(np.asarray(jout[k])), err_msg=k)
        np.testing.assert_array_equal(np.asarray(off[k]),
                                      np.asarray(tout[k]), err_msg=k)


def test_ring_helpers_equal_reference():
    with pytest.raises(ValueError, match="capacity must be >= 1"):
        TR.FlightRecorder(0)
    ring = TR.FlightRecorder(4).init("cpu")
    jring = JR.FlightRecorder(4).init()
    for r in range(7):
        vals = dict(occupancy=r / 3, new=r * 7, total=2.0**30 + r,
                    coverage=0.5, active_lanes=3, ici_bytes=0.0)
        TR.write_row(ring, r, **vals)
        jring = JR.write_row(jring, r, **vals)
    TR.write_row(ring, 7, live=torch.tensor(False), occupancy=9, new=9,
                 total=9, coverage=9, active_lanes=9, ici_bytes=9)
    np.testing.assert_array_equal(bits(ring.numpy()),
                                  bits(np.asarray(jring)))
    for rounds in (0, 3, 4, 7, 9):
        assert_same_record(TR.trim(ring, rounds),
                           JR.trim(np.asarray(jring), rounds))
    for total in (0, 5, 2**24 + 1, 2**32 + 3, 2**40 + 2**33 + 77):
        hi, lo = TR.limbs(torch.tensor(total, dtype=torch.int64))
        assert lo.item() == total % 2**32
        want = JR.total_f32(jax.numpy.int32(total >> 32),
                            jax.numpy.uint32(total % 2**32))
        assert TR.total_f32(hi, lo).numpy().view(np.int32) == np.asarray(
            want).view(np.int32)
