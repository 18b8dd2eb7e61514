"""The ring's flight recorder (``parallel/sharded.py``: ``recorder=`` on
``flood_until_coverage`` and ``run_batch_until_coverage``) and its
``ici_bytes`` column (``parallel/commviz.py``) against the JAX package's
ring: the mirror of ``TestShardedRecorder`` (``tests/test_graftscope.py``).

The JAX ring runs on the 8-device virtual CPU mesh of
``tests/conftest.py`` with ``comm="ppermute"``; the port runs both of its
comms. Rows are compared whole and by bits, ``ici_bytes`` included: the
reference prices a traced program (``commviz.jaxpr_comm_census``), the
port lists the same collectives by hand, and the two censuses are also
compared primitive by primitive, at the test shapes and, by an abstract
trace of the reference's loop, at the 1M ring's shapes.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from p2pnetwork_tpu.models.messagebatch import BatchFlood as JBatch  # noqa: E402
from p2pnetwork_tpu.parallel import commviz as JC  # noqa: E402
from p2pnetwork_tpu.parallel import mesh as JM  # noqa: E402
from p2pnetwork_tpu.parallel import sharded as JS  # noqa: E402
from p2pnetwork_tpu.sim import engine as JE  # noqa: E402
from p2pnetwork_tpu.sim import flightrec as JF  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu_torch import _device, prng  # noqa: E402
from p2pnetwork_tpu_torch.models.messagebatch import BatchFlood  # noqa: E402
from p2pnetwork_tpu_torch.parallel import commviz as TC  # noqa: E402
from p2pnetwork_tpu_torch.parallel import mesh as TM  # noqa: E402
from p2pnetwork_tpu_torch.parallel import sharded as TS  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine as TE  # noqa: E402
from p2pnetwork_tpu_torch.sim import flightrec  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

COMMS = ("ppermute", "pallas")
LAYOUTS = {"segment": {}, "mxu": {"mxu": True}, "hybrid": {"hybrid": True}}
CAPACITY = 64
#: The batch of ``TestShardedRecorder``: 40 sources on the 512-node graph.
SOURCES = np.arange(40, dtype=np.int32) * 3 % 512


@pytest.fixture(scope="module", autouse=True)
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (the virtual CPU mesh of conftest)")


@functools.lru_cache(maxsize=None)
def _graphs(S=8, churned=False):
    jg = JG.watts_strogatz(512, 4, 0.1, seed=0)
    tg = TG.watts_strogatz(512, 4, 0.1, seed=0, device="cpu")
    jm, tm = JM.ring_mesh(S), TM.ring_mesh(S, device="cpu")
    jsg, tsg = JS.shard_graph(jg, jm), TS.shard_graph(tg, tm)
    if churned:
        jsg = JS.connect(JS.with_capacity(JS.fail_nodes(jsg, [7, 300]), 8),
                         [2, 9], [400, 130])
        tsg = TS.connect(TS.with_capacity(TS.fail_nodes(tsg, [7, 300]), 8),
                         [2, 9], [400, 130])
    return jg, tg, jm, tm, jsg, tsg


@functools.lru_cache(maxsize=None)
def _jax_flood_rec(S=8, churned=False):
    _, _, jm, _, jsg, _ = _graphs(S, churned)
    seen, out = JS.flood_until_coverage(
        jsg, jm, 0, coverage_target=0.99, max_rounds=64, comm="ppermute",
        recorder=JF.FlightRecorder(capacity=CAPACITY))
    return np.asarray(seen), out


# ------------------------------------------------------------- dense flood


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_flood_rows_equal_reference(layout, comm):
    _, tg, _, tm, _, _ = _graphs()
    tsg = TS.shard_graph(tg, tm, **LAYOUTS[layout])
    want_seen, want = _jax_flood_rec()
    want = dict(want)
    want_fr = want.pop("flight_record")
    s1, o1 = TS.flood_until_coverage(tsg, tm, 0, coverage_target=0.99,
                                     max_rounds=64, comm=comm)
    before = _device.SYNCS
    s2, o2 = TS.flood_until_coverage(
        tsg, tm, 0, coverage_target=0.99, max_rounds=64, comm=comm,
        recorder=flightrec.FlightRecorder(capacity=CAPACITY))
    # The recorder's one fetch is its only extra host read.
    assert _device.SYNCS - before == o2["rounds"] + 2
    fr = o2.pop("flight_record")
    assert o1 == o2 == want
    np.testing.assert_array_equal(s1.numpy(), s2.numpy())
    np.testing.assert_array_equal(s2.numpy(), want_seen)
    assert fr.rows.shape[0] == o1["rounds"]
    assert fr.rows.dtype == want_fr.rows.dtype
    assert fr.rows.tobytes() == want_fr.rows.tobytes()
    ici = fr.column("ici_bytes")
    assert ici[0] > 0 and np.all(ici == ici[0])
    assert fr.column("coverage")[-1] == (s2 & tsg.node_mask).sum().item()


def test_flood_rows_under_churn():
    _, _, _, tm, _, tsg = _graphs(churned=True)
    want_seen, want = _jax_flood_rec(churned=True)
    seen, out = TS.flood_until_coverage(
        tsg, tm, 0, coverage_target=0.99, max_rounds=64,
        recorder=flightrec.FlightRecorder(capacity=CAPACITY), comm="pallas")
    assert out["flight_record"].rows.tobytes() \
        == want["flight_record"].rows.tobytes()
    np.testing.assert_array_equal(seen.numpy(), want_seen)


def test_flood_ring_wraps_like_reference():
    # A ring shorter than the run keeps its last rows, oldest first.
    _, _, jm, tm, jsg, tsg = _graphs()
    rec_j, rec_t = JF.FlightRecorder(capacity=3), flightrec.FlightRecorder(
        capacity=3)
    _, jout = JS.flood_until_coverage(jsg, jm, 0, max_rounds=64,
                                      comm="ppermute", recorder=rec_j)
    _, tout = TS.flood_until_coverage(tsg, tm, 0, max_rounds=64,
                                      recorder=rec_t)
    jfr, tfr = jout["flight_record"], tout["flight_record"]
    assert (tfr.rounds, tfr.dropped) == (jfr.rounds, jfr.dropped) != (0, 0)
    assert tfr.rows.tobytes() == jfr.rows.tobytes()


@pytest.mark.parametrize("S", [1, 2, 8])
def test_ici_equal_across_comms(S):
    _, _, _, tm, _, tsg = _graphs(S)
    cols = []
    for comm in COMMS:
        _, out = TS.flood_until_coverage(
            tsg, tm, 0, max_rounds=64, comm=comm,
            recorder=flightrec.FlightRecorder(capacity=CAPACITY))
        cols.append(out["flight_record"].column("ici_bytes"))
    np.testing.assert_array_equal(cols[0], cols[1])
    want = _jax_flood_rec(S)[1]["flight_record"].column("ici_bytes")
    np.testing.assert_array_equal(cols[0], want)


# ---------------------------------------------------------------- lane ring


@functools.lru_cache(maxsize=None)
def _jax_batch(S=8):
    jg, _, jm, _, jsg, _ = _graphs(S)
    proto = JBatch()
    rec = JF.FlightRecorder(capacity=CAPACITY)
    _, sharded = JS.run_batch_until_coverage(
        jsg, jm, proto, proto.init(jg, SOURCES), max_rounds=64,
        comm="ppermute", donate=False, recorder=rec)
    _, single = JE.run_batch_until_coverage(
        jg, proto, proto.init(jg, SOURCES), jax.random.key(0),
        donate=False, max_rounds=64, recorder=rec)
    return sharded, single


def _summary(out):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in out.items() if k != "flight_record"}


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("S", [2, 8])
def test_batch_rows_equal_reference_and_engine(S, comm):
    _, tg, _, tm, _, tsg = _graphs(S)
    proto = BatchFlood()
    rec = flightrec.FlightRecorder(capacity=CAPACITY)
    b1, o1 = TS.run_batch_until_coverage(
        tsg, tm, proto, proto.init(tg, SOURCES), max_rounds=64, comm=comm)
    b2, o2 = TS.run_batch_until_coverage(
        tsg, tm, proto, proto.init(tg, SOURCES), max_rounds=64, comm=comm,
        recorder=rec)
    fr = o2["flight_record"]
    assert _summary(o1) == _summary(o2)
    for f in ("seen", "frontier", "sent", "done", "rounds", "seen_count"):
        np.testing.assert_array_equal(getattr(b1, f).numpy(),
                                      getattr(b2, f).numpy())
    want_sharded, want_single = _jax_batch(S)
    assert _summary(o2) == _summary(want_sharded)
    # Whole rows against the JAX ring's, ici_bytes included.
    assert fr.rows.tobytes() == want_sharded["flight_record"].rows.tobytes()
    # Every column before ici_bytes against both packages' engine loop.
    _, oe = TE.run_batch_until_coverage(
        tg, proto, proto.init(tg, SOURCES), prng.key(0), max_rounds=64,
        recorder=rec)
    ici = flightrec.REC_COLS.index("ici_bytes")
    np.testing.assert_array_equal(fr.rows[:, :ici],
                                  oe["flight_record"].rows[:, :ici])
    np.testing.assert_array_equal(
        fr.rows[:, :ici], want_single["flight_record"].rows[:, :ici])
    assert fr.column("ici_bytes")[0] > 0


# ----------------------------------------------------------- byte model


def _jax_flood_census(S, block, n_dyn=0):
    """The reference's census of its dense flood loop at these shapes, by
    an abstract trace (no arrays are made)."""
    sd = jax.ShapeDtypeStruct
    m = JM.ring_mesh(S)
    fn = JS._flood_cov_fn(m, m.axis_names[0], S, block, 64, (), 128,
                          "ppermute")
    i32, b = jnp.int32, jnp.bool_
    args = (sd((), jnp.float32), sd((S, S, 128), i32), sd((S, S, 128), i32),
            sd((S, S, 128), b), sd((S, S, n_dyn), i32),
            sd((S, S, n_dyn), i32), sd((S, S, n_dyn), b),
            sd((S, S, 0, 0), i32), sd((S, S, 0, 0), i32),
            sd((S, S, 0, 0), b), sd((S, 0, block), b), sd((S, block), b),
            sd((S, block), i32), sd((S, block), b), sd((S, block), b))
    return JC.jaxpr_comm_census(fn, args, S)


def _jax_batch_census(S, block, W):
    sd = jax.ShapeDtypeStruct
    m = JM.ring_mesh(S)
    fn = JS._batch_cov_fn(m, m.axis_names[0], S, block, 64, "ppermute",
                          False)
    i32, b, u32 = jnp.int32, jnp.bool_, jnp.uint32
    lanes = 32 * W
    args = (sd((S, S, 128), i32), sd((S, S, 128), i32), sd((S, S, 128), b),
            sd((S, S, 0), i32), sd((S, S, 0), i32), sd((S, S, 0), b),
            sd((S, block), b), sd((S, block), i32),
            *(sd((S, W, block), u32),) * 3,
            sd((lanes,), i32), sd((lanes,), b), sd((lanes,), b),
            sd((lanes,), i32), sd((lanes,), i32), sd((lanes,), jnp.float32))
    return JC.jaxpr_comm_census(fn, args, S)


#: (S, block): the test shapes and the 1M ring's (1,000,064 nodes on 8
#: shards), and for the lane ring also its lane words.
FLOOD_SHAPES = [(1, 512), (2, 256), (8, 64), (8, 125_008)]
BATCH_SHAPES = [(2, 256, 2), (8, 64, 4), (8, 12_512, 32), (8, 125_008, 32)]


@pytest.mark.parametrize("S,block", FLOOD_SHAPES)
def test_flood_census_equals_reference(S, block):
    want = _jax_flood_census(S, block)
    assert TC.ring_census("flood", S, block) == want
    assert TC.ici_round_bytes("flood", S, block) == sum(
        r["bytes"] for r in want.values())
    pallas = TC.ring_census("flood", S, block, comm="pallas")
    assert sum(r["bytes"] for r in pallas.values()) == sum(
        r["bytes"] for r in want.values())


def test_flood_census_ignores_the_dynamic_region():
    assert _jax_flood_census(8, 64, n_dyn=8) == TC.ring_census("flood", 8, 64)


@pytest.mark.parametrize("S,block,W", BATCH_SHAPES)
def test_batch_census_equals_reference(S, block, W):
    want = _jax_batch_census(S, block, W)
    assert TC.ring_census("batch", S, block, n_words=W) == want
    assert TC.ici_round_bytes("batch", S, block, n_words=W) == sum(
        r["bytes"] for r in want.values())


def test_ring_model_bytes_equals_reference():
    for prim in ("ppermute", "ring_dma", "psum", "pmax", "pmin",
                 "all_gather", "all_to_all", "reduce_scatter", "other"):
        for nbytes in (1, 4, 7, 4096, 125_008):
            for s in (1, 2, 3, 8):
                assert TC.ring_model_bytes(prim, nbytes, s) \
                    == JC.ring_model_bytes(prim, nbytes, s)


def test_adaptive_path_refuses_recorder():
    _, tg, _, tm, _, _ = _graphs()
    sg = TS.shard_graph(tg, tm, source_csr=True)
    with pytest.raises(ValueError, match="adaptive"):
        TS.flood_until_coverage(sg, tm, 0, adaptive_k=64,
                                recorder=flightrec.FlightRecorder())
