"""The port's ring plane (``parallel/``, ``ops/ring.py``) against the JAX
package's, on the same graphs.

The JAX side runs on the 8-device virtual CPU mesh that
``tests/conftest.py`` sets up (these tests skip with fewer devices), with
``comm="ppermute"``: this jax has no ``pltpu.TPUMemorySpace``, so the
reference's Pallas ring kernels cannot run here, and its own parity
contract pins them bit-identical to ``ppermute`` (tests/test_ring.py).
Its blocked segment sum runs in the Pallas interpreter. The port runs
both of its backends, ``"ppermute"`` and ``"pallas"`` (on the CPU the
kernels' plain versions).

What must agree: the sharded fields byte for byte; flood dicts, per-round
stats and final ``seen`` exactly; ``propagate`` exactly, except f32 sums
of random values, held to ``rtol = atol = 1e-5`` (the packages add a
node's terms in other orders; integer-valued sums are exact). Graphs:
``ws512`` and the ragged ER(300) of tests/test_ring.py, and the main
path's WS shape at 4,096 nodes; layouts ``segment``, ``mxu``, ``hybrid``.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from p2pnetwork_tpu.ops.pallas_edge import segment_sum_pallas_impl  # noqa: E402
from p2pnetwork_tpu.parallel import mesh as JM  # noqa: E402
from p2pnetwork_tpu.parallel import sharded as JS  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu_torch import interop  # noqa: E402
from p2pnetwork_tpu_torch.models.flood import Flood  # noqa: E402
from p2pnetwork_tpu_torch.ops import ring  # noqa: E402
from p2pnetwork_tpu_torch.parallel import auto  # noqa: E402
from p2pnetwork_tpu_torch.parallel import mesh as TM  # noqa: E402
from p2pnetwork_tpu_torch.parallel import sharded as TS  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402
from tests.test_torch_kernels import (  # noqa: E402
    assert_same_reduction, extent_buckets, extent_signal,
    truncated_reduction)

S = 8
RTOL = ATOL = 1e-5
TARGET = 0.99
MAX_ROUNDS = 64

GRAPHS = {
    "ws512": ("watts_strogatz", (512, 4, 0.2), {"seed": 0}),
    # 300 nodes pad to 384: 48-node blocks, the last shard all padding.
    "er300": ("erdos_renyi", (300, 0.02), {"seed": 1}),
    "ws4096": ("watts_strogatz", (4096, 10, 0.1), {"seed": 0}),
}
LAYOUTS = {"segment": {}, "mxu": {"mxu": True}, "hybrid": {"hybrid": True}}
CASES = [(g, lay) for g in GRAPHS for lay in LAYOUTS]
CASE_IDS = [f"{g}-{lay}" for g, lay in CASES]
COMMS = ("ppermute", "pallas")
#: Port ShardedGraph fields the reference does not have.
PORT_ONLY = ("mxu_extent",)


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < S:
        pytest.skip(f"needs {S} devices (the virtual CPU mesh of conftest)")
    return JM.ring_mesh(S), TM.ring_mesh(S, device="cpu")


@functools.lru_cache(maxsize=None)
def _graphs(name):
    fn, args, kw = GRAPHS[name]
    return (getattr(JG, fn)(*args, **kw),
            getattr(TG, fn)(*args, **kw, device="cpu"))


@functools.lru_cache(maxsize=None)
def _sharded(name, layout):
    jm, tm = JM.ring_mesh(S), TM.ring_mesh(S, device="cpu")
    jg, tg = _graphs(name)
    return (JS.shard_graph(jg, jm, **LAYOUTS[layout]),
            TS.shard_graph(tg, tm, **LAYOUTS[layout]))


@functools.lru_cache(maxsize=None)
def _jax_coverage(name, layout):
    jsg, _ = _sharded(name, layout)
    seen, out = JS.flood_until_coverage(jsg, JM.ring_mesh(S), 0,
                                        coverage_target=TARGET,
                                        max_rounds=MAX_ROUNDS,
                                        comm="ppermute")
    return np.asarray(seen), out


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def case(request, meshes):
    return request.param


def sharded_fields(sg) -> dict:
    """Either package's ShardedGraph as numpy arrays and static values."""
    out = {}
    for f in dataclasses.fields(sg):
        v = getattr(sg, f.name)
        if isinstance(v, torch.Tensor):
            v = v.numpy()
        elif isinstance(v, jax.Array):
            v = np.asarray(v)
        out[f.name] = v
    return out


def assert_same_fields(got: dict, want: dict):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), key
            assert (g.dtype, g.shape) == (w.dtype, w.shape), key
            assert g.tobytes() == w.tobytes(), key
        else:
            assert g == w, (key, g, w)


def _loop_extent(src, dst, mask):
    """Each row's extent, found by a loop: 1 + the last slot whose
    (mask, src, local_dst) is not (0, 0, 0), or 0."""
    out = np.zeros(src.shape[:-1], dtype=np.int32)
    for row in np.ndindex(*src.shape[:-1]):
        used = np.flatnonzero(mask[row] | (src[row] != 0) | (dst[row] != 0))
        out[row] = used[-1] + 1 if used.size else 0
    return out


def _port_fields_vs_reference(tsg, jsg):
    """Both packages' fields, the port-only ones popped (the extent held
    against a loop over the reference's MXU arrays)."""
    got, want = sharded_fields(tsg), sharded_fields(jsg)
    extent = got.pop("mxu_extent")
    if want["mxu_src"] is None:
        assert extent is None
    else:
        np.testing.assert_array_equal(extent, _loop_extent(
            want["mxu_src"], want["mxu_dst"], want["mxu_mask"]))
    assert set(PORT_ONLY) == set(sharded_fields(tsg)) - set(
        sharded_fields(jsg))
    return got, want


# ------------------------------------------------------------ the shards


def test_shards_are_byte_equal(case):
    jsg, tsg = _sharded(*case)
    assert_same_fields(*_port_fields_vs_reference(tsg, jsg))


def test_main_path_shapes_at_4096(meshes):
    _, seg = _sharded("ws4096", "segment")
    _, mxu = _sharded("ws4096", "mxu")
    _, hyb = _sharded("ws4096", "hybrid")
    assert seg.block == 512 and seg.mxu_src is None and seg.diag_pieces == ()
    assert tuple(mxu.mxu_src.shape) == (S, S, 1, 4736) and mxu.mxu_block == 512
    assert tuple(hyb.mxu_src.shape) == (S, S, 1, 128)
    assert len(hyb.diag_pieces) == 20
    assert tuple(hyb.diag_masks.shape) == (S, 20, 512)


def test_mxu_extent_marks_each_rows_padding(meshes):
    # At 4,096 nodes, as at 1M (PERF.md §4): step 0 holds nearly every
    # edge, the other steps a few per row; past each extent only padding.
    _, tsg = _sharded("ws4096", "mxu")
    ext = tsg.mxu_extent.numpy()
    assert ext.shape == tuple(tsg.mxu_src.shape[:-1])
    assert ext[:, 0].min() > 4000 and ext[:, 1:].max() < 200
    w = np.arange(tsg.mxu_src.shape[-1])
    past = w >= ext[..., None]
    for a in (tsg.mxu_src, tsg.mxu_dst, tsg.mxu_mask):
        assert not a.numpy()[past].any()
    live = tsg.mxu_mask.numpy()
    assert (live.sum(-1) == ext).all()  # the real rows: live prefixes


def test_ragged_last_shard(meshes):
    _, tsg = _sharded("er300", "segment")
    live = tsg.node_mask.sum(dim=1).tolist()
    assert tsg.block == 48 and live == [48] * 6 + [12, 0]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_interop_shards_equal_the_ports_own(meshes, layout):
    jsg, tsg = _sharded("ws512", layout)
    carried = interop.sharded_graph_from_numpy(sharded_fields(jsg),
                                               meshes[1])
    assert_same_fields(sharded_fields(carried), sharded_fields(tsg))
    want = TS.flood_until_coverage(tsg, meshes[1], 0, coverage_target=TARGET)
    got = TS.flood_until_coverage(carried, meshes[1], 0,
                                  coverage_target=TARGET)
    assert got[1] == want[1] and torch.equal(got[0], want[0])


# ----------------------------------------------------------------- floods


@pytest.mark.parametrize("comm", COMMS)
def test_flood_until_coverage_equals_reference(case, meshes, comm):
    _, tsg = _sharded(*case)
    want_seen, want = _jax_coverage(*case)
    seen, got = TS.flood_until_coverage(tsg, meshes[1], 0,
                                        coverage_target=TARGET,
                                        max_rounds=MAX_ROUNDS, comm=comm)
    assert got == want
    np.testing.assert_array_equal(seen.numpy(), want_seen)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_ws4096_numbers(meshes, layout):
    # The reference's dict on the main path's graph at 4,096 nodes, from
    # both packages (the port with its default comm).
    _, tsg = _sharded("ws4096", layout)
    _, got = TS.flood_until_coverage(tsg, meshes[1], 0,
                                     coverage_target=TARGET,
                                     max_rounds=MAX_ROUNDS)
    want = {"rounds": 7, "coverage": 1.0, "messages": 39940,
            "frontier_occupancy_mean": 0.142822265625}
    assert _jax_coverage("ws4096", layout)[1] == want and got == want


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_flood_fixed_rounds_equals_reference(meshes, layout, comm):
    jsg, tsg = _sharded("ws512", layout)
    jseen, jstats = JS.flood(jsg, meshes[0], source=0, rounds=4,
                             comm="ppermute")
    seen, stats = TS.flood(tsg, meshes[1], source=0, rounds=4, comm=comm)
    np.testing.assert_array_equal(seen.numpy(), np.asarray(jseen))
    assert set(stats) == set(jstats)
    for key in stats:
        np.testing.assert_array_equal(stats[key].numpy(),
                                      np.asarray(jstats[key]))


def test_resumed_run_equals_reference(meshes):
    jsg, tsg = _sharded("ws512", "hybrid")
    (jseen, jfront), _ = JS.flood(jsg, meshes[0], 0, rounds=2,
                                  return_state=True, comm="ppermute")
    state0 = (torch.from_numpy(np.array(jseen)),
              torch.from_numpy(np.array(jfront)))
    (want_seen, want_front), want = JS.flood_until_coverage(
        jsg, meshes[0], 0, coverage_target=TARGET, comm="ppermute",
        state0=(jseen, jfront), return_state=True)
    (seen, front), got = TS.flood_until_coverage(
        tsg, meshes[1], 0, coverage_target=TARGET, state0=state0,
        return_state=True)
    assert got == want
    np.testing.assert_array_equal(seen.numpy(), np.asarray(want_seen))
    np.testing.assert_array_equal(front.numpy(), np.asarray(want_front))


# -------------------------------------------------------------- propagate


def _signal(sg, kind, seed):
    rng = np.random.default_rng(seed)
    n = sg.n_shards * sg.block
    if kind == "or":
        x = rng.random(n) < 0.2
    elif kind == "ints":
        x = rng.integers(0, 64, n).astype(np.float32)
    elif kind == "minplus":
        x = np.where(np.arange(n) % 97 == 0, 0.0, np.inf).astype(np.float32)
    else:
        x = rng.standard_normal(n).astype(np.float32)
    return x.reshape(sg.n_shards, sg.block)


def _both(case, meshes, op, kind, comm, seed=7):
    jsg, tsg = _sharded(*case)
    x = _signal(tsg, kind, seed)
    want = np.asarray(JS.propagate(jsg, meshes[0], jnp.asarray(x), op,
                                   comm="ppermute"))
    got = TS.propagate(tsg, meshes[1], torch.from_numpy(x), op,
                       comm=comm).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    return got, want


@pytest.mark.parametrize("comm", COMMS)
def test_propagate_or_is_bit_equal(case, meshes, comm):
    np.testing.assert_array_equal(*_both(case, meshes, "or", "or", comm))


@pytest.mark.parametrize("comm", COMMS)
def test_propagate_sum_within_tolerance(case, meshes, comm):
    got, want = _both(case, meshes, "sum", "f32", comm)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("comm", COMMS)
def test_propagate_integer_sum_is_exact(case, meshes, comm):
    np.testing.assert_array_equal(*_both(case, meshes, "sum", "ints", comm))


@pytest.mark.parametrize("op,kind", [("max", "f32"), ("minplus", "minplus")])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_propagate_max_minplus_exact_on_segment(meshes, name, op, kind):
    np.testing.assert_array_equal(
        *_both((name, "segment"), meshes, op, kind, "pallas"))


@pytest.mark.parametrize("layout", ["mxu", "hybrid"])
@pytest.mark.parametrize("op", ["max", "minplus"])
def test_propagate_max_refused_on_mxu_layout(meshes, layout, op):
    jsg, tsg = _sharded("ws512", layout)
    x = _signal(tsg, "f32", 0)
    with pytest.raises(ValueError, match="MXU one-hot layout"):
        JS.propagate(jsg, meshes[0], jnp.asarray(x), op)
    with pytest.raises(ValueError, match="MXU one-hot layout"):
        TS.propagate(tsg, meshes[1], torch.from_numpy(x), op)


# ------------------------------------- ring kernels against the reference


def _jax_ppermute(x, reverse):
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = JM.ring_mesh(S)
    perm = ([((i + 1) % S, i) for i in range(S)] if reverse
            else [(i, (i + 1) % S) for i in range(S)])
    spec = P("shards")
    fn = JS.shard_map(lambda xb: jax.lax.ppermute(xb, "shards", perm),
                      mesh=mesh, in_specs=spec, out_specs=spec,
                      check_vma=False)
    return np.asarray(jax.jit(fn)(jax.device_put(
        jnp.asarray(x), NamedSharding(mesh, spec))))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype,shape", [
    (np.bool_, (64,)), (np.int32, (64,)), (np.float32, (48,)),
    (np.uint32, (3, 64)),
])
def test_ring_shift_matches_ppermute(meshes, dtype, shape, reverse):
    x = np.random.default_rng(0).integers(0, 100, (S,) + shape).astype(dtype)
    got = ring.ring_shift(torch.from_numpy(x), reverse=reverse)
    np.testing.assert_array_equal(got.numpy(), _jax_ppermute(x, reverse))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", [
    (torch.int32, (S, 125_008)), (torch.int32, (S, 128)),
    (torch.int32, (S, 125_007)),
], ids=["4s-degrees", "small", "odd"])
def test_ring_shift_reverse_on_card_at_4s_shapes(dtype, shape):
    # Phase 4s's reverse hops: the re-mask's Horner fold carries i32
    # out-degree counts [8, 125008] back one shard per hop.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run via chip_smoke.py)")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 2**20, shape, generator=g, device="cuda").to(dtype)
    back = ring.SHIFT_BACK_LAUNCHES
    got = ring.ring_shift(x, reverse=True)
    assert ring.SHIFT_BACK_LAUNCHES == back + 1
    assert torch.equal(got, ring.ring_shift_plain(x, reverse=True))
    assert torch.equal(got, torch.roll(x, -1, dims=0))


@pytest.mark.parametrize("kind", ["or", "sum"])
def test_ring_segment_sum_matches_ppermute_plus_segsum(meshes, kind):
    rng = np.random.default_rng(1)
    nb, w, blk, b = 8, 512, 128, 96
    src = rng.integers(0, b, (S, nb, w)).astype(np.int32)
    dst = rng.integers(0, blk, (S, nb, w)).astype(np.int32)
    mask = rng.random((S, nb, w)) < 0.7
    if kind == "or":
        rot = rng.random((S, b)) < 0.3
        contrib = (np.take_along_axis(rot, src.reshape(S, -1), 1)
                   .reshape(src.shape) & mask).astype(np.float32)
        fn = ring.ring_segment_sum_or
    else:
        rot = rng.standard_normal((S, b)).astype(np.float32)
        contrib = np.take_along_axis(rot, src.reshape(S, -1), 1).reshape(
            src.shape) * mask
        fn = ring.ring_segment_sum_sum
    want = np.stack([np.asarray(segment_sum_pallas_impl(
        jnp.asarray(contrib[d]), jnp.asarray(dst[d]), blk, exact=False))
        for d in range(S)]).reshape(S, -1)
    rot_next, out = fn(*(torch.from_numpy(a) for a in (rot, src, dst, mask)),
                       blk)
    np.testing.assert_array_equal(rot_next.numpy(), _jax_ppermute(rot, False))
    if kind == "or":
        np.testing.assert_array_equal(out.numpy(), want > 0)
    else:
        np.testing.assert_allclose(out.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["or", "f32", "ints", "nonfinite"])
def test_truncated_rows_equal_full_width_and_reference(meshes, kind):
    # B3's reading of rows up to their extent (plus the one padding term
    # of the sum), modelled in numpy, against the port's full-width plain
    # version and the reference's Pallas segment sum of each shard, on
    # rows whose masks are not prefixes. With a non-finite rot[d, 0]
    # (read only by the padding) the reference's one-hot product spreads
    # the NaN over its row's outputs, and so does the port: the NaN sets
    # must be equal, and every other output agree.
    rng = np.random.default_rng(13)
    nb, w, blk, b = 6, 512, 128, 96
    src, dst, mask, extent = extent_buckets(rng, S, nb, w, blk, b)
    rot = extent_signal(rng, kind, S, b)
    model = truncated_reduction(rot, src, dst, mask, extent, blk)
    fn = (ring.ring_segment_sum_or_plain if kind == "or"
          else ring.ring_segment_sum_sum_plain)
    assert_same_reduction(fn(rot, src, dst, mask, blk)[1].numpy(), model,
                          kind)
    r, sn, dn, mn = (t.numpy() for t in (rot, src, dst, mask))
    gathered = np.take_along_axis(r, sn.reshape(S, -1), 1).reshape(sn.shape)
    with np.errstate(invalid="ignore"):  # inf * 0 in the padding
        contrib = ((gathered & mn) if kind == "or"
                   else gathered * mn).astype(np.float32)
    want = np.stack([np.asarray(segment_sum_pallas_impl(
        jnp.asarray(contrib[d]), jnp.asarray(dn[d]), blk, exact=False))
        for d in range(S)]).reshape(S, -1)
    if kind == "or":
        want = want > 0
    assert_same_reduction(want, model, kind)
    if kind == "nonfinite":
        assert np.isnan(want).any() and not np.isnan(want).all()


# ------------------------------------------------- routing and refusals


def test_resolve_comm():
    assert auto.resolve_comm("ppermute") == "ppermute"
    assert auto.resolve_comm("pallas") == "pallas"
    assert auto.resolve_comm("auto", "cpu") == "ppermute"
    assert auto.resolve_comm("auto", torch.device("cuda")) == "pallas"
    with pytest.raises(ValueError, match="comm must be one of"):
        auto.resolve_comm("smoke-signals")
    assert auto.COMM_BACKENDS == JS.COMM_BACKENDS


def test_comm_payload_template_is_held(meshes):
    comm = TS._RingComm("ppermute", S)
    comm.shift(torch.zeros(S, 4, dtype=torch.bool))
    with pytest.raises(TS.CommPayloadMismatch):
        comm.shift(torch.zeros(S, 4, dtype=torch.float32))
    comm.shift_back(torch.zeros(S, 2))  # the reverse owns its template
    with pytest.raises(ValueError, match="comm must be one of"):
        TS._RingComm("nope", S)


@pytest.mark.parametrize("call,exc", [
    (lambda sg, m: TS.flood_until_coverage(sg, m, 0, adaptive_k=64),
     NotImplementedError),
    (lambda sg, m: TS.flood_until_coverage(sg, m, 0, recorder=object()),
     NotImplementedError),
    (lambda sg, m: TS.flood_until_coverage(sg, m, 0, comm=object()),
     TypeError),
    (lambda sg, m: TS.flood(sg, m, 0, 1, comm="carrier-pigeon"), ValueError),
    (lambda sg, m: TS.flood(sg, TM.ring_mesh(4, device="cpu"), 0, 1),
     ValueError),
    (lambda sg, m: TS.flood(sg, m, sg.n_nodes_padded, 1), ValueError),
    (lambda sg, m: TS.propagate(sg, m, sg.node_mask, "xor"), ValueError),
    (lambda sg, m: TS.init_state(sg, object()), ValueError),
], ids=["adaptive", "recorder", "fault-spec", "bad-comm", "mesh-size",
        "bad-source", "bad-op", "other-protocol"])
def test_unported_and_bad_arguments_raise(meshes, call, exc):
    _, tsg = _sharded("ws512", "segment")
    with pytest.raises(exc):
        call(tsg, meshes[1])


def test_init_state_is_the_flood_seed(meshes):
    _, tsg = _sharded("er300", "segment")
    seen, frontier = TS.init_state(tsg, Flood(source=50))
    assert seen is frontier and seen.shape == (S, 48)
    assert seen.nonzero().tolist() == [[1, 2]]
