"""The batched query plane against the JAX package, on the CPU.

- ``ops/lanes.py``: the byte budget (``lane_bytes``, ``lane_budget``,
  ``LaneBudgetExceeded``) equal to the reference's; ``propagate_min_plus_
  lanes`` by ``gather`` and ``segment``, weighted and unweighted, by bits
  (NaN, ``-0.0`` and ``inf`` terms included); ``propagate_sum_lanes`` by
  bits (both add in the reference's order on the CPU); ``dht_hop_lanes``
  under both metrics, with dead nodes and ties.
- The three families through ``run_queries_until_done``: min-plus by every
  method, weighted and unweighted — the summary and the distance field by
  bits; DHT lookups on chord (``ring``) and kademlia (``xor``) — cursors
  exact; push-sum by every method — ``rounds``, ``lane_rounds``,
  ``messages`` and ``lane_done`` exact, the masses and answers within
  ``PUSHSUM_RTOL``/``PUSHSUM_ATOL`` (the seed fields come from ``normal``,
  within 3 ulp of jax's, and the variance sums add in another order than
  XLA's GEMV).
- Lifecycle: admit, retire, admit; ``LaneExhausted``; the budget errors
  of every family; a reference-admitted batch carried by ``interop`` and
  resumed.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from p2pnetwork_tpu.models import querybatch as JQ  # noqa: E402
from p2pnetwork_tpu.ops import lanes as JL  # noqa: E402
from p2pnetwork_tpu.sim import engine as JE  # noqa: E402
from p2pnetwork_tpu.sim import failures as JFa  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu_torch import interop, prng  # noqa: E402
from p2pnetwork_tpu_torch.models import messagebatch as TMB  # noqa: E402
from p2pnetwork_tpu_torch.models import querybatch as TQ  # noqa: E402
from p2pnetwork_tpu_torch.ops import lanes as TL  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine as TE  # noqa: E402
from p2pnetwork_tpu_torch.sim import failures as TFa  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402
from tests.test_torch_semiring import latency  # noqa: E402

KEY = jax.random.key(0)
PKEY = prng.key(0)
N = 1024
#: Push-sum masses and answers: the seed fields are within 3 ulp of
#: jax's, and the variance is summed in another order than XLA's.
PUSHSUM_RTOL, PUSHSUM_ATOL = 1e-4, 1e-6
#: The admitted seed fields: ``prng.normal`` is within 3 ulp of jax's,
#: under 8e-7 of the value.
NORMAL_RTOL = 8e-7


def both(name, *args, **kw):
    return (getattr(JG, name)(*args, **kw),
            getattr(TG, name)(*args, device="cpu", **kw))


@pytest.fixture(scope="module")
def ws():
    return both("watts_strogatz", N, 6, 0.2, seed=3)


@pytest.fixture(scope="module")
def wsw(ws):
    """The same graph with the routing rung's id-hash latencies."""
    return ws[0].with_weights(latency), ws[1].with_weights(latency)


def np_of(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def bits(x):
    return np_of(x).astype(np.float32).view(np.int32)


def assert_same_out(got, want, float_tol=None):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        if k == "lane_values" and float_tol:
            np.testing.assert_allclose(got[k], want[k], rtol=float_tol[0],
                                       atol=float_tol[1])
        elif k == "lane_values" and got[k].dtype == np.float32:
            np.testing.assert_array_equal(bits(got[k]), bits(want[k]))
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


def assert_same_batch(got, want, float_tol=None):
    for f in dataclasses.fields(want):
        if f.name == "payload":
            continue
        np.testing.assert_array_equal(np_of(getattr(got, f.name)),
                                      np.asarray(getattr(want, f.name)),
                                      err_msg=f.name)
    assert set(got.payload) == set(want.payload)
    for k, v in want.payload.items():
        g = np_of(got.payload[k])
        assert g.dtype == np.asarray(v).dtype and g.shape == v.shape, k
        if float_tol and g.dtype == np.float32:
            np.testing.assert_allclose(g, np.asarray(v), rtol=float_tol[0],
                                       atol=float_tol[1], err_msg=k)
        elif g.dtype == np.float32:
            np.testing.assert_array_equal(bits(g), bits(v), err_msg=k)
        else:
            np.testing.assert_array_equal(g, np.asarray(v), err_msg=k)


def run_both(jg, tg, jproto, tproto, jqb, tqb, max_rounds=256,
             float_tol=None):
    js, jout = JE.run_queries_until_done(jg, jproto, jqb, KEY,
                                         max_rounds=max_rounds, donate=False)
    ts, tout = TE.run_queries_until_done(tg, tproto, tqb, PKEY,
                                         max_rounds=max_rounds)
    assert_same_out(tout, jout, float_tol)
    assert_same_batch(ts, js, float_tol)
    return (js, jout), (ts, tout)


# ------------------------------------------------------------- budget


@pytest.mark.parametrize("cap,jdt,tdt,n_pad,carriers", [
    (1024, bool, torch.bool, 100_096, 1), (33, bool, torch.bool, 128, 2),
    (64, jnp.float32, torch.float32, 100_096, 1),
    (32, jnp.float32, torch.float32, 100_096, 2),
    (2048, jnp.int32, torch.int32, 1, 1)])
def test_lane_bytes_equal_reference(cap, jdt, tdt, n_pad, carriers):
    want = JL.lane_bytes(cap, jdt, n_pad, carriers=carriers)
    assert TL.lane_bytes(cap, tdt, n_pad, carriers=carriers) == want
    assert TL.lane_bytes(cap, np.dtype(jdt), n_pad,
                         carriers=carriers) == want
    assert TL.lane_budget(cap, tdt, n_pad, carriers=carriers) == want


def test_budget_errors(monkeypatch, ws):
    _, tg = ws
    with pytest.raises(TL.LaneBudgetExceeded) as err:
        TL.lane_budget(64, torch.float32, 1000, budget_bytes=1000)
    e = err.value
    assert (e.requested_bytes, e.budget_bytes, e.capacity, e.n_pad,
            e.carriers) == (256_000, 1000, 64, 1000, 1)
    assert "float32[1000]" in str(e) and isinstance(e, ValueError)
    for bad in ({"capacity": 0}, {"n_pad": 0}, {"carriers": 0}):
        kw = dict(capacity=1, dtype=torch.float32, n_pad=1, carriers=1)
        kw.update(bad)
        with pytest.raises(ValueError):
            TL.lane_bytes(kw.pop("capacity"), kw.pop("dtype"),
                          kw.pop("n_pad"), **kw)
    monkeypatch.setenv("P2P_LANE_BUDGET_BYTES", "100")
    with pytest.raises(TL.LaneBudgetExceeded):
        TL.lane_budget(1, torch.float32, 26)
    monkeypatch.delenv("P2P_LANE_BUDGET_BYTES")
    n_pad = tg.n_nodes_padded
    # Each family refuses at init and at admit (a hand-built batch).
    for proto, carriers, make in (
            (TQ.MinPlusQueries, 1, lambda p: p.init(tg, [0], [1])),
            (TQ.PushSumQueries, 2, lambda p: p.init(tg, [1])),
            (TQ.DhtLookups, 1, lambda p: p.init(tg, [0], [1]))):
        cost = TL.lane_bytes(1, torch.float32,
                             1 if proto is TQ.DhtLookups else n_pad,
                             carriers=carriers)
        with pytest.raises(TQ.LaneBudgetExceeded):
            make(proto(budget_bytes=cost - 1))
        qb = make(proto())
        with pytest.raises(TQ.LaneBudgetExceeded):
            args = ([1],) if proto is TQ.PushSumQueries else ([1], [2])
            proto(budget_bytes=cost - 1).admit(tg, qb, *args)


# -------------------------------------------------------- lane kernels


def lane_field(n_pad, k, seed, special=False):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 5, (n_pad, k)).astype(np.float32)
    d[rng.random(d.shape) < 0.4] = np.inf
    if special:
        d[rng.random(d.shape) < 0.01] = np.nan
        d[rng.random(d.shape) < 0.02] = -0.0
        d[rng.random(d.shape) < 0.02] = 0.0
    return d


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("method", ["gather", "segment", "auto"])
@pytest.mark.parametrize("special", [False, True], ids=["finite", "nan-zero"])
def test_min_plus_lanes_equal_reference_by_bits(ws, wsw, method, weighted,
                                                special):
    jg, tg = wsw if weighted else ws
    d = lane_field(tg.n_nodes_padded, 5, 1, special)
    want = JL.propagate_min_plus_lanes(jg, jnp.asarray(d), method)
    got = TL.propagate_min_plus_lanes(tg, torch.from_numpy(d), method)
    np.testing.assert_array_equal(np.isnan(np_of(got)),
                                  np.isnan(np.asarray(want)))
    ok = ~np.isnan(np.asarray(want))
    np.testing.assert_array_equal(bits(got)[ok], bits(want)[ok])


@pytest.mark.parametrize("method", ["gather", "segment"])
def test_sum_lanes_equal_reference_by_bits(ws, method):
    jg, tg = ws
    v = np.random.default_rng(2).normal(
        size=(tg.n_nodes_padded, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        bits(TL.propagate_sum_lanes(tg, torch.from_numpy(v), method)),
        bits(JL.propagate_sum_lanes(jg, jnp.asarray(v), method)))


@pytest.mark.parametrize("method", ["skew", "blocked"])
def test_lane_kernels_refuse_other_methods_and_dynamic_edges(ws, method):
    _, tg = ws
    m = torch.zeros((tg.n_nodes_padded, 2))
    with pytest.raises(ValueError, match="lane form"):
        TL.propagate_min_plus_lanes(tg, m, method)
    with pytest.raises(ValueError, match="lane form"):
        TL.propagate_sum_lanes(tg, m, method)
    from p2pnetwork_tpu_torch.sim import topology as TT
    dyn = TT.connect(TT.with_capacity(tg, extra_edges=4), [0], [5])
    with pytest.raises(ValueError, match="dynamic"):
        TL.propagate_sum_lanes(dyn, m, "segment")
    with pytest.raises(ValueError, match="dynamic"):
        TL.dht_hop_lanes(dyn, torch.zeros(1, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32))
    capped = TG.watts_strogatz(200, 6, 0.2, seed=3, max_degree=2,
                               device="cpu")
    with pytest.raises(ValueError, match="capped|neighbor table"):
        TL.propagate_min_plus_lanes(capped, torch.zeros((256, 1)), "gather")


@pytest.mark.parametrize("metric", ["ring", "xor"])
@pytest.mark.parametrize("name,n", [("chord", 300), ("kademlia", 300),
                                    ("ring", 8)])
def test_dht_hop_equals_reference(name, n, metric):
    jg, tg = both(name, n)
    dead = np.arange(0, n, 7, dtype=np.int32)[1:]
    jg, tg = JFa.fail_nodes(jg, dead), TFa.fail_nodes(tg, dead)
    rng = np.random.default_rng(n)
    cur = rng.integers(0, n, 400).astype(np.int32)
    keys = rng.integers(0, n, 400).astype(np.int32)
    if name == "ring":  # 1 and 7 are both 3 from 4 around an 8-ring: a tie
        cur[:2], keys[:2] = 0, 4
    jn, jh = JL.dht_hop_lanes(jg, jnp.asarray(cur), jnp.asarray(keys),
                              metric)
    tn, th = TL.dht_hop_lanes(tg, torch.from_numpy(cur),
                              torch.from_numpy(keys), metric)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert tn.dtype == torch.int32
    np.testing.assert_array_equal(
        TL.dht_distance(torch.tensor([5, 0]), torch.tensor([2, 3]), n,
                        metric).numpy(),
        np.asarray(JL.dht_distance(jnp.array([5, 0]), jnp.array([2, 3]), n,
                                   metric)).astype(np.int64))
    with pytest.raises(ValueError, match="metric"):
        TL.dht_hop_lanes(tg, torch.from_numpy(cur), torch.from_numpy(keys),
                         "euclid")


# ----------------------------------------------------------- families


def pairs(k, seed, n=N):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, k).astype(np.int32),
            rng.integers(0, n, k).astype(np.int32))


@pytest.mark.parametrize("method", ["auto", "gather", "segment"])
@pytest.mark.parametrize("weighted", [False, True])
def test_min_plus_queries_equal_reference(ws, wsw, method, weighted):
    jg, tg = wsw if weighted else ws
    srcs, tgts = pairs(20, 5)
    srcs[0] = tgts[0]  # settled at admission
    jp, tp = JQ.MinPlusQueries(method=method), TQ.MinPlusQueries(method)
    _, (ts, tout) = run_both(jg, tg, jp, tp, jp.init(jg, srcs, tgts,
                                                     capacity=24),
                             tp.init(tg, srcs, tgts, capacity=24))
    assert tout["completed"] == 20 and tout["lane_rounds"][0] == 0
    np.testing.assert_array_equal(TQ.lane_dist(ts, 3).numpy(),
                                  ts.payload["dist"][:, 3].numpy())


def test_min_plus_dead_and_unreachable_lanes(ws):
    jg, tg = ws
    dead = np.arange(500, 520, dtype=np.int32)
    jg, tg = JFa.fail_nodes(jg, dead), TFa.fail_nodes(tg, dead)
    jp, tp = JQ.MinPlusQueries(), TQ.MinPlusQueries()
    srcs, tgts = [505, 3, 9], [3, 510, 1000]
    _, (_, tout) = run_both(jg, tg, jp, tp, jp.init(jg, srcs, tgts),
                            tp.init(tg, srcs, tgts))
    assert np.isinf(tout["lane_values"][:2]).all()


@pytest.mark.parametrize("name,metric,n", [
    ("chord", "ring", 1000), ("kademlia", "xor", 1000),
    ("kademlia", "xor", 1024), ("chord", "xor", 600)])
def test_dht_lookups_equal_reference(name, metric, n):
    jg, tg = both(name, n)
    dead = np.array([n // 3], dtype=np.int32)
    jg, tg = JFa.fail_nodes(jg, dead), TFa.fail_nodes(tg, dead)
    orgs, keys = pairs(200, n, n)
    orgs[0], keys[1], keys[2] = dead[0], dead[0], orgs[2]
    jp, tp = JQ.DhtLookups(metric=metric), TQ.DhtLookups(metric=metric)
    _, (_, tout) = run_both(jg, tg, jp, tp, jp.init(jg, orgs, keys),
                            tp.init(tg, orgs, keys), max_rounds=128)
    assert tout["lane_rounds"][2] == 0
    assert (tout["lane_values"] == keys).sum() >= 190


@pytest.mark.parametrize("method", ["auto", "gather", "segment"])
def test_push_sum_queries_equal_reference(ws, method):
    jg, tg = ws
    seeds = (np.arange(6) * 7 + 1).astype(np.int32)
    jp, tp = (JQ.PushSumQueries(method=method),
              TQ.PushSumQueries(method=method))
    # The admitted fields: the normal draws within 3 ulp.
    jqb, tqb = jp.init(jg, seeds, threshold=1e-4, capacity=8), \
        tp.init(tg, seeds, threshold=1e-4, capacity=8)
    assert_same_batch(tqb, jqb, (NORMAL_RTOL, 0.0))
    _, (_, tout) = run_both(jg, tg, jp, tp, jqb, tqb, max_rounds=512,
                            float_tol=(PUSHSUM_RTOL, PUSHSUM_ATOL))
    assert tout["completed"] == 6 and tout["rounds"] > 5


def test_push_sum_seed_salt_and_threshold(ws):
    _, tg = ws
    a = TQ.PushSumQueries(seed_salt=0).init(tg, [3])
    b = TQ.PushSumQueries(seed_salt=1).init(tg, [3])
    assert not torch.equal(a.payload["s"], b.payload["s"])
    with pytest.raises(ValueError, match="threshold"):
        TQ.PushSumQueries().init(tg, [3], threshold=0.0)
    # Under threshold at admission: done with 0 rounds.
    qb = TQ.PushSumQueries().init(tg, [3], threshold=1e9)
    _, out = TE.run_queries_until_done(tg, TQ.PushSumQueries(), qb, PKEY)
    assert out["lane_done"][0] and out["lane_rounds"][0] == 0


def test_admit_retire_admit_equals_reference(ws):
    jg, tg = ws
    jp, tp = JQ.MinPlusQueries(), TQ.MinPlusQueries()
    srcs, tgts = pairs(5, 11)
    (js, _), (ts, _) = run_both(jg, tg, jp, tp,
                                jp.init(jg, srcs, tgts, capacity=8),
                                tp.init(tg, srcs, tgts, capacity=8),
                                max_rounds=3)
    js, ts = jp.retire(js, [0, 4]), tp.retire(ts, [0, 4])
    assert_same_batch(ts, js)
    srcs2, tgts2 = pairs(4, 12)
    js, jl = jp.admit(jg, js, srcs2, tgts2)
    ts, tl = tp.admit(tg, ts, srcs2, tgts2)
    np.testing.assert_array_equal(tl, jl)
    (js, _), (ts, tout) = run_both(jg, tg, jp, tp, js, ts)
    # Only the resumed and new lanes complete in this call.
    np.testing.assert_array_equal(tout["newly_completed_lanes"],
                                  np.flatnonzero(tout["lane_done"]))
    assert TQ.free_query_lanes(ts) == JQ.free_query_lanes(js) == 1
    with pytest.raises(TMB.LaneExhausted) as err:
        tp.admit(tg, ts, [1, 2], [3, 4])
    assert (err.value.requested, err.value.free_lanes,
            err.value.capacity) == (2, 1, 8)
    with pytest.raises(ValueError, match="outside this batch"):
        tp.retire(ts, [8])
    with pytest.raises(ValueError, match="outside this batch"):
        TQ.lane_dist(ts, -1)
    with pytest.raises(ValueError, match="pairs"):
        tp.admit(tg, ts, [1, 2], [3])
    with pytest.raises(ValueError, match="id space"):
        TQ.DhtLookups().init(tg, [0], [N + 5])
    with pytest.raises(ValueError, match="metric"):
        TQ.DhtLookups(metric="euclid")


def test_max_rounds_freezes_stragglers(ws):
    jg, tg = ws
    jp, tp = JQ.PushSumQueries(), TQ.PushSumQueries()
    (_, jout), (_, tout) = run_both(
        jg, tg, jp, tp, jp.init(jg, [1, 2]), tp.init(tg, [1, 2]),
        max_rounds=4, float_tol=(PUSHSUM_RTOL, PUSHSUM_ATOL))
    assert tout["active_lanes"] == 2 and tout["rounds"] == 4
    assert "completion_rounds_p50" not in tout


def test_reference_admitted_batch_resumes_in_the_port(ws):
    jg, tg = ws
    jp, tp = JQ.MinPlusQueries(), TQ.MinPlusQueries()
    srcs, tgts = pairs(6, 13)
    js, _ = JE.run_queries_until_done(jg, jp, jp.init(jg, srcs, tgts), KEY,
                                      max_rounds=2, donate=False)
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if f.name != "payload"}
    fields["payload"] = {k: np.asarray(v) for k, v in js.payload.items()}
    ts = interop.query_batch_from_numpy(fields, device="cpu")
    assert_same_batch(ts, js)
    run_both(jg, tg, jp, tp, js, ts)
