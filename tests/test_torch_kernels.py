"""The segment-sum kernel (``ops/segsum.py``, ``csrc/segsum.cu``) and its
plain version. Needs no JAX, so it also runs on the machine with the card:

    python -m pytest tests/test_torch_kernels.py -q

On the CPU the plain version is held against a loop and the wrapper's
refusals are checked; the ``cuda``-marked tests launch the kernel and skip
without a card. Tolerance for the f32 sum: ``rtol = atol = 1e-5`` (the
reference's own for its kernel, tests/test_blocked_pallas.py), since the
kernel's shared-memory atomics add in a varying order; integer-valued sums
and OR are exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from p2pnetwork_tpu_torch.ops import segsum  # noqa: E402

RTOL = ATOL = 1e-5


def _random_layout(rng, nb, w, block, n_pad):
    src = rng.integers(0, n_pad, (nb, w)).astype(np.int32)
    dst = rng.integers(0, block, (nb, w)).astype(np.int32)
    mask = rng.random((nb, w)) < 0.8
    return src, dst, mask


def _loop_segsum(values, src, dst, mask, block):
    out = np.zeros((src.shape[0], block), dtype=np.float64)
    for n in range(src.shape[0]):
        for w in range(src.shape[1]):
            if mask[n, w]:
                out[n, dst[n, w]] += values[src[n, w]]
    return out.reshape(-1)


@pytest.mark.parametrize("block", [128, 512])
def test_plain_versions_match_a_loop(block):
    rng = np.random.default_rng(block)
    n_pad = 1024
    src, dst, mask = _random_layout(rng, 5, 256, block, n_pad)
    sig = rng.random(n_pad) < 0.1
    vals = rng.integers(-8, 8, n_pad).astype(np.float32)
    t = [torch.from_numpy(a) for a in (src, dst, mask)]
    got_or = segsum.segsum_or(torch.from_numpy(sig), *t, block)
    got_sum = segsum.segsum_sum(torch.from_numpy(vals), *t, block)
    assert got_or.dtype == torch.bool and got_sum.dtype == torch.float32
    np.testing.assert_array_equal(
        got_or.numpy(), _loop_segsum(sig.astype(np.float64), src, dst, mask,
                                     block) > 0)
    # Integer-valued terms: exact whatever the order.
    np.testing.assert_array_equal(
        got_sum.numpy(), _loop_segsum(vals, src, dst, mask, block))


def test_masked_slot_keeps_reference_nan_semantics():
    # signal * mask: a non-finite signal behind a masked slot still makes
    # a NaN term, as the reference's contrib does, and the reference's
    # one-hot product spreads a non-finite term over its row: NaN at every
    # other destination, the plain sum (here +inf) at its own. Row 0: a
    # live +inf at destination 1; row 1: a masked +inf; row 2: finite.
    sig = torch.tensor([np.inf, 1.0])
    src = torch.tensor([[0, 1], [0, 1], [1, 1]], dtype=torch.int32)
    dst = torch.tensor([[1, 1], [0, 5], [2, 3]], dtype=torch.int32)
    mask = torch.tensor([[True, True], [False, True], [True, True]])
    out = segsum.segsum_sum(sig, src, dst, mask, 128).reshape(3, 128)
    assert out[0, 1] == np.inf
    assert torch.isnan(out[0, :1]).all() and torch.isnan(out[0, 2:]).all()
    assert torch.isnan(out[1]).all()
    want = torch.zeros(128)
    want[2] = want[3] = 1.0
    assert torch.equal(out[2], want)


def test_wrapper_refuses_other_devices():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        segsum.segsum_or(torch.zeros(8, dtype=torch.bool, **meta),
                         torch.zeros(1, 4, dtype=torch.int32, **meta),
                         torch.zeros(1, 4, dtype=torch.int32, **meta),
                         torch.zeros(1, 4, dtype=torch.bool, **meta), 128)


#: Row counts around the row engine's persistent grid: whatever the
#: card's residency m (blocks per SM, at most 8) on its 132 SMs, one count
#: 2 * 132 * m - 1 leaves the grid's last block one row, and one count
#: 132 * m + 1 gives its first block a row more than every other.
_GRID_EDGES = ([(2 * 132 * m - 1, 640, 128, 0) for m in range(1, 9)]
               + [(132 * m + 1, 640, 128, 0) for m in range(1, 9)])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run via chip_smoke.py)")


@pytest.mark.cuda
@pytest.mark.parametrize("nb,w,block,offset", [
    pytest.param(1954, 640, 512, 0, id="1954-640-512"),
    pytest.param(7813, 1408, 128, 0, id="7813-1408-128"),
    (5, 7, 128, 0), (9, 33, 128, 0), (300, 1407, 128, 0),
    (300, 1408, 128, 1), (300, 1408, 128, 4),
    (245, 128, 512, 0), (245, 32, 512, 0), (50, 4864, 512, 0),
    (64, 32, 1, 0), (64, 24, 1, 0), (64, 640, 1, 0), (64, 1408, 1, 0),
    (64, 640, 512, 0),
    (64, 640, segsum.MAX_BLOCK, 0), (64, 128, segsum.MAX_BLOCK, 0),
    (1, 1408, 128, 0), (3, 1408, 128, 0), (4, 1408, 128, 0),
    (7, 1408, 128, 0), (2111, 128, 512, 0), (8447, 128, 512, 0),
    *_GRID_EDGES,
], ids=lambda v: str(v))
def test_kernel_matches_plain_on_card(nb, w, block, offset):
    # offset: the rows start `offset` elements into their buffers, so a
    # nonzero one leaves them unaligned (1: the scalar path; 4: src 16-byte
    # aligned but mask not). block = 1 sums a whole row into one element,
    # so every thread of a row group (W = 640: 128 threads; W = 1408: the
    # whole 256-thread block) adds into one shared address. The narrow
    # block = 1 rows (~20-26 live slots, as many terms per output as the
    # blocked layout's) are held to the f32 tolerance too; the wide ones
    # (~500-1,100 terms of N(0, 1) per output) are not, since f32 rounding
    # of an unordered sum that long leaves outputs near zero outside
    # rtol = atol = 1e-5 on either side: OR and integer values hold them.
    _card()
    rng = np.random.default_rng(nb)
    n_pad = 1_000_064

    def on_card(a):
        flat = torch.zeros(offset + a.size, dtype=torch.from_numpy(a).dtype,
                           device="cuda")
        flat[offset:] = torch.from_numpy(a.reshape(-1)).cuda()
        return flat[offset:].view(a.shape)

    src, dst, mask = (on_card(a)
                      for a in _random_layout(rng, nb, w, block, n_pad))
    sig = torch.from_numpy(rng.random(n_pad) < 0.1).cuda()
    before = segsum.LAUNCHES
    got = segsum.segsum_or(sig, src, dst, mask, block)
    assert segsum.LAUNCHES == before + 1
    assert torch.equal(got, segsum.segsum_or_plain(sig, src, dst, mask, block))
    x = torch.from_numpy(rng.standard_normal(n_pad).astype(np.float32)).cuda()
    if block > 1 or w <= 64:
        torch.testing.assert_close(
            segsum.segsum_sum(x, src, dst, mask, block),
            segsum.segsum_sum_plain(x, src, dst, mask, block),
            rtol=RTOL, atol=ATOL)
    xi = torch.round(x * 8)
    assert torch.equal(segsum.segsum_sum(xi, src, dst, mask, block),
                       segsum.segsum_sum_plain(xi, src, dst, mask, block))


# ---------------------------------------------------------------- the ring
#
# Kernels B2 (``ring.ring_shift``) and B3 (``ring.ring_segment_sum_*``) and
# B1's stacked-shard entry, on the ring's layout: buckets are the strided
# step slice ``[:, t]`` of ``[S, S, NB, W]`` arrays. The hop and OR are
# bit-exact; B3's f32 sum has B1's tolerance (shared-memory atomics).

from p2pnetwork_tpu_torch.ops import ring  # noqa: E402


def _ring_buckets(rng, s, nb, w, block, b, step=1):
    """Bucket ``step`` of random ``[S, S, NB, W]`` ring arrays (strided
    views, as the ring passes them) and a bool/f32/int-valued ``rot``."""
    src = torch.from_numpy(rng.integers(0, b, (s, s, nb, w)).astype(np.int32))
    dst = torch.from_numpy(
        rng.integers(0, block, (s, s, nb, w)).astype(np.int32))
    mask = torch.from_numpy(rng.random((s, s, nb, w)) < 0.7)
    flags = torch.from_numpy(rng.random((s, b)) < 0.3)
    vals = torch.from_numpy(rng.standard_normal((s, b)).astype(np.float32))
    ints = torch.from_numpy(rng.integers(-8, 8, (s, b)).astype(np.float32))
    return (src[:, step], dst[:, step], mask[:, step]), flags, vals, ints


def _loop_ring_segsum(rot, src, dst, mask, block):
    rot, src, dst, mask = (t.numpy() for t in (rot, src, dst, mask))
    s, nb, _ = src.shape
    out = np.stack([_loop_segsum(rot[d].astype(np.float64), src[d], dst[d],
                                 mask[d], block) for d in range(s)])
    return out.reshape(s, nb * block)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype,shape", [
    (torch.bool, (8, 48)), (torch.float32, (3, 37)), (torch.int32, (5, 2, 7)),
])
def test_ring_shift_plain_matches_a_loop(reverse, dtype, shape):
    x = torch.arange(int(np.prod(shape))).reshape(shape).to(dtype)
    got = ring.ring_shift(x, reverse=reverse)
    s = shape[0]
    for d in range(s):
        src = (d + 1) % s if reverse else (d - 1) % s
        assert torch.equal(got[d], x[src])


def test_ring_shift_single_shard_is_identity():
    x = torch.arange(8.0)[None]
    assert ring.ring_shift(x) is x and ring.ring_shift(x, reverse=True) is x


@pytest.mark.parametrize("block", [128, 512])
def test_ring_segment_sum_plain_matches_a_loop(block):
    rng = np.random.default_rng(block + 1)
    (src, dst, mask), flags, _, ints = _ring_buckets(rng, 4, 3, 256, block, 96)
    rot_next, got = ring.ring_segment_sum_or(flags, src, dst, mask, block)
    assert torch.equal(rot_next, torch.roll(flags, 1, 0))
    np.testing.assert_array_equal(
        got.numpy(), _loop_ring_segsum(flags, src, dst, mask, block) > 0)
    rot_next, got = ring.ring_segment_sum_sum(ints, src, dst, mask, block)
    assert torch.equal(rot_next, torch.roll(ints, 1, 0))
    np.testing.assert_array_equal(
        got.numpy(), _loop_ring_segsum(ints, src, dst, mask, block))


def test_stacked_segsum_plain_matches_per_shard_calls():
    rng = np.random.default_rng(5)
    (src, dst, mask), flags, vals, _ = _ring_buckets(rng, 3, 2, 128, 128, 64)
    assert not src.is_contiguous()  # the ring's strided step slice
    got_or = segsum.segsum_or(flags, src, dst, mask, 128)
    got_sum = segsum.segsum_sum(vals, src, dst, mask, 128)
    for d in range(3):
        args = (src[d].contiguous(), dst[d].contiguous(), mask[d].contiguous())
        assert torch.equal(got_or[d], segsum.segsum_or(flags[d], *args, 128))
        assert torch.equal(got_sum[d], segsum.segsum_sum(vals[d], *args, 128))


@pytest.mark.parametrize("rot", [torch.zeros(1, 64, dtype=torch.bool),
                                 torch.zeros(64, dtype=torch.bool)],
                         ids=["one-shard", "no-shard-axis"])
def test_ring_segment_sum_refuses_fewer_than_two_shards(rot):
    b = torch.zeros(1, 1, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="ring of >= 2"):
        ring.ring_segment_sum_or(rot, b, b, b.bool(), 128)


def _meta(*shape, dtype):
    return torch.zeros(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("call,match", [
    (lambda: ring.ring_shift(_meta(4, 8, dtype=torch.bool)), "CPU or CUDA"),
    (lambda: ring.ring_shift(_meta(8, 4, dtype=torch.bool).t()),
     "contiguous"),
    (lambda: ring.ring_segment_sum_or(
        _meta(4, 64, dtype=torch.bool), _meta(4, 2, 128, dtype=torch.int32),
        _meta(4, 2, 128, dtype=torch.int32),
        _meta(4, 2, 128, dtype=torch.bool), 128), "CPU or CUDA"),
    (lambda: ring.ring_segment_sum_sum(
        _meta(4, 64, dtype=torch.bool), _meta(4, 2, 128, dtype=torch.int32),
        _meta(4, 2, 128, dtype=torch.int32),
        _meta(4, 2, 128, dtype=torch.bool), 128), "must be torch.float32"),
    (lambda: ring.ring_segment_sum_or(
        _meta(4, 64, dtype=torch.bool),
        _meta(4, 128, 2, dtype=torch.int32).transpose(1, 2),
        _meta(4, 128, 2, dtype=torch.int32).transpose(1, 2),
        _meta(4, 128, 2, dtype=torch.bool).transpose(1, 2), 128),
     "rows must be contiguous"),
    (lambda: segsum.segsum_or(
        _meta(4, 64, dtype=torch.bool), _meta(3, 2, 128, dtype=torch.int32),
        _meta(3, 2, 128, dtype=torch.int32),
        _meta(3, 2, 128, dtype=torch.bool), 128), "stacked signal"),
    (lambda: segsum.segsum_sum(
        _meta(64, dtype=torch.float32), _meta(2, 2, 128, dtype=torch.int32),
        _meta(2, 2, 128, dtype=torch.int32),
        _meta(2, 2, 128, dtype=torch.bool), 128), "src must be"),
    (lambda: ring.ring_segment_sum_or(
        _meta(4, 64, dtype=torch.bool), _meta(4, 2, 128, dtype=torch.int32),
        _meta(4, 2, 128, dtype=torch.int32),
        _meta(4, 2, 128, dtype=torch.bool), 128,
        extent=_meta(4, 2, dtype=torch.int64)), "extent must be i32"),
    (lambda: ring.ring_segment_sum_sum(
        _meta(4, 64, dtype=torch.float32),
        _meta(4, 2, 2, 128, dtype=torch.int32)[:, 1],
        _meta(4, 2, 2, 128, dtype=torch.int32)[:, 1],
        _meta(4, 2, 2, 128, dtype=torch.bool)[:, 1], 128,
        extent=_meta(4, 4, dtype=torch.int32)[:, ::2]),
     "rows must be contiguous"),
], ids=["shift-device", "shift-layout", "segsum-device", "segsum-dtype",
        "segsum-rows", "stacked-shards", "stacked-dims", "extent-dtype",
        "extent-layout"])
def test_ring_wrappers_refuse_what_the_kernels_do_not_take(call, match):
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype,shape", [
    (torch.bool, (8, 125008)), (torch.float32, (8, 125008)),
    (torch.uint8, (3, 37)), (torch.int32, (5, 7)), (torch.int32, (8, 3, 64)),
    (torch.uint8, (8, 1)), (torch.uint8, (8, 15)), (torch.uint8, (8, 17)),
    (torch.bool, (8, 125007)), (torch.float32, (8, 3, 33)),
    (torch.int32, (3, 2, 31)), (torch.int32, (8, 32, 12512)),
], ids=["bool-1M", "f32-1M", "bytes", "words", "lanes", "shard-1B",
        "shard-15B", "shard-17B", "shard-125007B", "f32-lanes",
        "i32-lanes", "lane-stack-1024"])
def test_ring_shift_kernel_matches_plain_on_card(reverse, dtype, shape):
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 100, shape, generator=g, device="cuda").to(dtype)
    before, back = ring.SHIFT_LAUNCHES, ring.SHIFT_BACK_LAUNCHES
    got = ring.ring_shift(x, reverse=reverse)
    assert ring.SHIFT_LAUNCHES == before + 1
    assert ring.SHIFT_BACK_LAUNCHES == back + int(reverse)
    assert torch.equal(got, ring.ring_shift_plain(x, reverse=reverse))


@pytest.mark.cuda
@pytest.mark.parametrize("s,nb,w,block,b", [
    (8, 4, 640, 512, 2000), (3, 5, 256, 128, 300),
    (1, 4, 640, 512, 2000), (2, 7, 1408, 128, 3000), (3, 3, 528, 128, 300),
    (3, 3, 520, 128, 300), (3, 5, 130, 128, 300), (2, 3, 1407, 128, 300),
    (3, 5, 33, 128, 300), (2, 3, 32, 1, 50), (2, 3, 20, 1, 50),
    (8, 245, 128, 512, 125008), (8, 245, 4864, 512, 125008),
], ids=lambda v: str(v))
def test_ring_segment_sum_kernel_matches_plain_on_card(s, nb, w, block, b):
    # Step 1 of [S, S, NB, W] arrays: a strided slice, unaligned where
    # NB * W is not a multiple of 4 (W = 130, 1407, 33). S = 1 runs B1's
    # stacked entry alone (B3 refuses a ring of fewer than two shards).
    # block = 1 rows are narrow, as in test_kernel_matches_plain_on_card.
    _card()
    rng = np.random.default_rng(s)
    (src, dst, mask), flags, vals, ints = (
        tuple(t.cuda() for t in x) if isinstance(x, tuple) else x.cuda()
        for x in _ring_buckets(rng, s, nb, w, block, b, step=min(s - 1, 1)))
    if s >= 2:
        before = ring.SEGSUM_LAUNCHES
        got = ring.ring_segment_sum_or(flags, src, dst, mask, block)
        assert ring.SEGSUM_LAUNCHES == before + 1
        want = ring.ring_segment_sum_or_plain(flags, src, dst, mask, block)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        got = ring.ring_segment_sum_sum(vals, src, dst, mask, block)
        want = ring.ring_segment_sum_sum_plain(vals, src, dst, mask, block)
        assert torch.equal(got[0], want[0])
        torch.testing.assert_close(got[1], want[1], rtol=RTOL, atol=ATOL)
        got = ring.ring_segment_sum_sum(ints, src, dst, mask, block)
        want = ring.ring_segment_sum_sum_plain(ints, src, dst, mask, block)
        assert torch.equal(got[1], want[1])
    # B1's stacked entry on the same strided buckets.
    before = segsum.LAUNCHES
    assert torch.equal(segsum.segsum_or(flags, src, dst, mask, block),
                       segsum.segsum_or_plain(flags, src, dst, mask, block))
    torch.testing.assert_close(
        segsum.segsum_sum(vals, src, dst, mask, block),
        segsum.segsum_sum_plain(vals, src, dst, mask, block),
        rtol=RTOL, atol=ATOL)
    assert torch.equal(segsum.segsum_sum(ints, src, dst, mask, block),
                       segsum.segsum_sum_plain(ints, src, dst, mask, block))
    assert segsum.LAUNCHES == before + 3


# -------------------------------------------------------- B3's row extents
#
# ``extent`` (``ShardedGraph.mxu_extent``, sliced as the buckets are): from
# a row's extent on, every slot is the layout's padding ``(0, 0, 0)``,
# which B3 then skips; the sum adds ``rot[d, 0] * 0`` to the row's first
# output once, as those slots would. The plain versions read every slot.

from p2pnetwork_tpu_torch.parallel.sharded import row_extent  # noqa: E402


def extent_buckets(rng, s, nb, w, block, b, *, ext_lo=0, ext_hi=None,
                   live=0.6, sort=False):
    """Step 1 of ``[S, 2, NB, W]`` buckets (strided slices, as the ring
    passes them) whose rows end at random extents in ``[ext_lo, ext_hi]``
    (the whole range: the first row 0, the last W). Inside a row, masks
    are ``live``-random (not a prefix), every source is >= 1 (so the last
    slot is not padding) and ``sort`` sorts the destinations, as the ring
    layout has them. Returns ``(src, dst, mask, extent)``."""
    shape = (s, 2, nb, w)
    hi = w if ext_hi is None else ext_hi
    ext = rng.integers(ext_lo, hi + 1, shape[:-1])
    if ext_lo == 0 and ext_hi is None:
        ext[:, 1, 0], ext[:, 1, -1] = 0, w
    inside = np.arange(w) < ext[..., None]
    src = np.where(inside, rng.integers(1, b, shape), 0)
    dst = rng.integers(0, block, shape)
    dst = np.where(inside, np.sort(dst, axis=-1) if sort else dst, 0)
    mask = inside & (rng.random(shape) < live)
    return tuple(torch.from_numpy(a.astype(t))[:, 1] for a, t in (
        (src, np.int32), (dst, np.int32), (mask, np.bool_),
        (ext, np.int32)))


def extent_signal(rng, kind, s, b):
    """``rot [S, B]``: bool for "or", N(0, 1) for "f32", integer values
    for "ints", and "nonfinite": N(0, 1) with NaN (even shards) or inf
    (odd shards) at ``rot[d, 0]``, which only the padding reads."""
    if kind == "or":
        return torch.from_numpy(rng.random((s, b)) < 0.3)
    if kind == "ints":
        return torch.from_numpy(rng.integers(-8, 8, (s, b)).astype(np.float32))
    x = rng.standard_normal((s, b)).astype(np.float32)
    if kind == "nonfinite":
        x[0::2, 0], x[1::2, 0] = np.nan, np.inf
    return torch.from_numpy(x)


def truncated_reduction(rot, src, dst, mask, extent, block):
    """B3's output as its rows are read with extents: each row summed
    (float64) up to its extent, plus one ``rot[d, 0] * 0`` at its first
    output where the extent is below W; OR is a sum of flags > 0. A sum
    row with non-finite terms is NaN at every output but their one
    destination (the reference's one-hot spread, ``ops/segsum.py``)."""
    rot, src, dst, mask, extent = (t.numpy() for t in (rot, src, dst, mask,
                                                       extent))
    s, nb, w = src.shape
    out = np.zeros((s, nb, block))
    for d in range(s):
        for n in range(nb):
            e = extent[d, n]
            vals = rot[d][src[d, n, :e]]
            if rot.dtype == np.bool_:
                np.add.at(out[d, n], dst[d, n, :e], vals & mask[d, n, :e])
                continue
            terms = vals.astype(np.float64) * mask[d, n, :e]
            bad = set(dst[d, n, :e][~np.isfinite(terms)].tolist())
            np.add.at(out[d, n], dst[d, n, :e], terms)
            if e < w:
                with np.errstate(invalid="ignore"):  # inf * 0 is NaN
                    pad = np.float64(rot[d, 0]) * 0.0
                out[d, n, 0] += pad
                if not np.isfinite(pad):
                    bad.add(0)
            for b in range(block):
                if bad and (len(bad) > 1 or b not in bad):
                    out[d, n, b] = np.nan
    out = out.reshape(s, nb * block)
    return out > 0 if rot.dtype == np.bool_ else out


def same_bits(a, b) -> bool:
    """Bit-equal tensors (a NaN equals a NaN of the same bits)."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def assert_same_reduction(got, want, kind):
    """OR and integer sums exactly; f32 sums within tolerance, NaN where
    and only where ``want`` has it."""
    got = np.asarray(got, dtype=np.float64 if kind != "or" else np.bool_)
    if kind in ("or", "ints"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["or", "f32", "ints", "nonfinite"])
def test_truncated_rows_equal_the_plain_version(kind):
    rng = np.random.default_rng(11)
    src, dst, mask, extent = extent_buckets(rng, 4, 6, 64, 128, 96)
    assert torch.equal(extent, torch.from_numpy(row_extent(
        src.numpy(), dst.numpy(), mask.numpy())))
    rot = extent_signal(rng, kind, 4, 96)
    fn = ring.ring_segment_sum_or if kind == "or" else ring.ring_segment_sum_sum
    rot_next, got = fn(rot, src, dst, mask, 128, extent=extent)
    assert same_bits(rot_next, torch.roll(rot, 1, 0))
    want = truncated_reduction(rot, src, dst, mask, extent, 128)
    assert_same_reduction(got.numpy(), want, kind)
    if kind == "nonfinite":  # the padding term is what poisons them
        assert np.isnan(want[:, 0]).all()


#: B3 with extents on the card: (s, nb, w, block, b, extent_buckets'
#: keywords). The ring's real steps at 1M nodes (``real-sparse``: steps
#: 1 to 6; ``real-dense``: step 0), random rows, rows all padding or all
#: used, and geometries that do not take the extent path (W = 130: rows
#: not aligned; MAX_BLOCK: a warp's accumulator per row does not fit),
#: where B3 reads every row at full width.
_EXTENT_CASES = {
    "real-sparse": (8, 245, 4864, 512, 125008,
                    dict(ext_lo=1, ext_hi=99, live=1.0, sort=True)),
    "real-dense": (8, 245, 4864, 512, 125008,
                   dict(ext_lo=4500, ext_hi=4864, live=1.0, sort=True)),
    "random": (3, 5, 640, 128, 300, {}),
    "random-sorted": (3, 9, 1408, 128, 3000, dict(sort=True)),
    "extent-0": (3, 5, 640, 128, 300, dict(ext_hi=0)),
    "extent-w": (3, 5, 640, 128, 300, dict(ext_lo=640)),
    "block-1": (2, 3, 32, 1, 50, {}),
    "unaligned": (3, 5, 130, 128, 300, {}),
    "block-max": (2, 3, 640, segsum.MAX_BLOCK, 300, {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["or", "f32", "ints", "nonfinite"])
@pytest.mark.parametrize("case", sorted(_EXTENT_CASES))
def test_ring_segment_sum_extent_kernel_matches_plain_on_card(case, kind):
    _card()
    s, nb, w, block, b, kw = _EXTENT_CASES[case]
    rng = np.random.default_rng(len(case))
    src, dst, mask, extent = (t.cuda() for t in extent_buckets(
        rng, s, nb, w, block, b, **kw))
    rot = extent_signal(rng, kind, s, b).cuda()
    fn = ring.ring_segment_sum_or if kind == "or" else ring.ring_segment_sum_sum
    plain = (ring.ring_segment_sum_or_plain if kind == "or"
             else ring.ring_segment_sum_sum_plain)
    want_next, want = plain(rot, src, dst, mask, block)
    # The extents as the ring slices them (strided), contiguous, and none.
    for ext in (extent, extent.contiguous(), None):
        before = ring.SEGSUM_LAUNCHES
        rot_next, got = fn(rot, src, dst, mask, block, extent=ext)
        assert ring.SEGSUM_LAUNCHES == before + 1
        assert same_bits(rot_next, want_next)
        assert_same_reduction(got.cpu().numpy(), want.cpu().numpy().astype(
            np.float64 if kind != "or" else np.bool_), kind)


# ------------------------------------------------- non-finite terms (C1)


def _poison(rng, x, src, n=3):
    """NaN, +inf and -inf at the sources of ``n`` random slots of
    ``src`` (any shape), and +inf at source 0, which the layouts' padding
    slots read. ``x`` is a numpy signal, ``[B]`` or ``[S, B]``."""
    flat = src.reshape(src.shape[0], -1) if x.ndim == 2 else src.reshape(1, -1)
    for d in range(flat.shape[0]):
        row = x[d] if x.ndim == 2 else x
        picks = flat[d][rng.choice(flat.shape[1], n, replace=False)]
        row[picks] = [np.nan, np.inf, -np.inf][:n]
        row[0] = np.inf
    return x


def _same_nan_and_close(got, want):
    assert torch.equal(got.isnan(), want.isnan()) and want.isnan().any()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("nb,w,block,offset", [
    (1954, 640, 512, 0), (7813, 1408, 128, 0), (300, 1407, 128, 0),
    (300, 1408, 128, 1), (245, 32, 512, 0), (64, 128, segsum.MAX_BLOCK, 0),
], ids=lambda v: str(v))
def test_kernel_spreads_nonfinite_terms_as_plain_on_card(nb, w, block,
                                                         offset):
    # B1's sum with non-finite terms at live slots and at padding slots
    # (source 0 behind a False mask, several destinations: their rows go
    # all NaN): the kernel's NaN set equals the plain version's, every
    # other output within tolerance.
    _card()
    rng = np.random.default_rng(nb + offset)
    n_pad = 1_000_064
    src, dst, mask = _random_layout(rng, nb, w, block, n_pad)
    src[::7, -5:], mask[::7, -5:] = 0, False
    x = _poison(rng, rng.standard_normal(n_pad).astype(np.float32), src)

    def on_card(a):
        flat = torch.zeros(offset + a.size, dtype=torch.from_numpy(a).dtype,
                           device="cuda")
        flat[offset:] = torch.from_numpy(a.reshape(-1)).cuda()
        return flat[offset:].view(a.shape)

    args = (on_card(x), on_card(src), on_card(dst), on_card(mask), block)
    _same_nan_and_close(segsum.segsum_sum(*args),
                        segsum.segsum_sum_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("extents", [False, True])
@pytest.mark.parametrize("case", ["real-dense", "real-sparse", "random"])
def test_ring_segment_sum_spreads_nonfinite_terms_on_card(case, extents):
    # B3's sum (and B1's stacked entry) with non-finite terms at live
    # slots and at rot[d, 0], read by each row's padding, with and
    # without the rows' extents.
    _card()
    s, nb, w, block, b, kw = _EXTENT_CASES[case]
    rng = np.random.default_rng(len(case) + extents)
    src, dst, mask, extent = (t.cuda() for t in extent_buckets(
        rng, s, nb, w, block, b, **kw))
    rot = torch.from_numpy(_poison(
        rng, rng.standard_normal((s, b)).astype(np.float32),
        src.cpu().numpy())).cuda()
    want_next, want = ring.ring_segment_sum_sum_plain(rot, src, dst, mask,
                                                      block)
    rot_next, got = ring.ring_segment_sum_sum(
        rot, src, dst, mask, block, extent=extent if extents else None)
    assert same_bits(rot_next, want_next)
    _same_nan_and_close(got, want)
    if not extents:
        _same_nan_and_close(segsum.segsum_sum(rot, src, dst, mask, block),
                            segsum.segsum_sum_plain(rot, src, dst, mask,
                                                    block))


# ------------------------------------------------ threefry (ops/threefry.py)

#: Counter counts around the kernel's block (256), the draws that narrow
#: its blocks (fewer than one block an SM), one wave of a counter a thread
#: (132 SMs x 8 blocks x 256 threads; 6 or 7 blocks if registers allow no
#: more) and past it, where a thread takes 4 counters (the scalar head and
#: tail take the rest), one persistent wave of those and past it, where
#: threads loop, the first design's grid cap (132 * 32 blocks of 256), and
#: the 1M draw.
_WAVE = 132 * 8 * 256
_THREEFRY_SIZES = [1, 2, 3, 4, 5, 31, 33, 255, 257, 4096, 4099, 100_096,
                   132 * 6 * 256 + 1, 132 * 7 * 256 + 3, _WAVE, _WAVE + 1,
                   _WAVE + 6, 4 * _WAVE - 1, 4 * _WAVE + 5,
                   132 * 32 * 256 + 1, 2**20 + 7]
#: Draws from a counter offset: across 2**32 (two launches, the second
#: writing from an output address 8 bytes past a 16-byte boundary), at
#: 2**32 itself and in a higher word.
_THREEFRY_OFFSETS = [(2**32 - 6, 4103), (2**32 - 1, 2), (2**32, 33),
                     (2**33 + 5, 1000), (2**32 - 2**20, 2**21 + 3)]


def test_threefry_plain_matches_the_numpy_hash():
    from p2pnetwork_tpu_torch import prng
    from p2pnetwork_tpu_torch.ops import threefry

    k0, k1 = (int(w) for w in prng.key(9))
    want = [np.bitwise_xor(*prng.threefry2x32(k0, k1, 0, i))
            for i in range(1000)]
    got = threefry.threefry_bits(k0, k1, 1000, "cpu")
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("offset,n,want", [
    (0, 0, []), (0, 5, [(0, 5)]), (2**32 - 6, 4103, [(2**32 - 6, 6),
                                                    (2**32, 4097)]),
    (2**32, 2**32, [(2**32, 2**32)]),
    (2**33 + 5, 2**33, [(2**33 + 5, 2**32 - 5), (3 * 2**32, 2**32),
                        (4 * 2**32, 5)])])
def test_threefry_launch_spans_split_at_multiples_of_two_to_the_32(
        offset, n, want):
    from p2pnetwork_tpu_torch.ops import threefry

    spans = threefry.launch_spans(offset, n)
    assert spans == want
    assert sum(c for _, c in spans) == n
    for start, count in spans:
        assert 0 < count <= 2**32 - (start & 0xFFFFFFFF)


@pytest.mark.parametrize("offset,n", _THREEFRY_OFFSETS[:4])
def test_threefry_plain_draws_from_an_offset(offset, n):
    # The plain version's offset is the counters' start: its draw is the
    # tail of a longer one from 0 where that fits, and the hash of those
    # counters in any case.
    from p2pnetwork_tpu_torch import prng
    from p2pnetwork_tpu_torch.ops import threefry

    k0, k1 = (int(w) for w in prng.key(5))
    got = threefry.threefry_bits(k0, k1, n, "cpu", offset=offset)
    want = threefry.hash_counters(
        k0, k1, torch.arange(offset, offset + n, dtype=torch.int64))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.numpy().astype(np.uint32))
    got = threefry.threefry_uniform(k0, k1, n, 0.0, 1.0, "cpu",
                                    offset=offset)
    np.testing.assert_array_equal(
        got.numpy(), threefry.threefry_uniform_plain(
            k0, k1, n + 3, 0.0, 1.0, "cpu", offset=offset - 3).numpy()[3:])


def test_threefry_wrapper_refuses_other_devices():
    from p2pnetwork_tpu_torch.ops import threefry

    with pytest.raises(ValueError, match="CPU or CUDA"):
        threefry.threefry_bits(0, 1, 8, "meta")


@pytest.mark.cuda
@pytest.mark.parametrize("n", _THREEFRY_SIZES)
@pytest.mark.parametrize("key", [(0, 0), (0, 0xFFFFFFFF), (0x9E3779B9, 7)])
def test_threefry_kernel_matches_plain_on_card(n, key):
    # Bits and the f32 uniform epilogue, bit for bit.
    from p2pnetwork_tpu_torch.ops import threefry

    _card()
    dev = torch.device("cuda")
    got = threefry.threefry_bits(*key, n, dev)
    assert torch.equal(got.cpu(), threefry.threefry_bits_plain(*key, n, "cpu"))
    lo, scale = float(np.float32(-3.3)), float(np.float32(10.4))
    for args in ((0.0, 1.0), (lo, scale)):
        got = threefry.threefry_uniform(*key, n, *args, dev)
        want = threefry.threefry_uniform_plain(*key, n, *args, "cpu")
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("offset,n", _THREEFRY_OFFSETS)
def test_threefry_kernel_draws_across_two_to_the_32_on_card(offset, n):
    # One launch per 2**32 counters; the counters' high word reaches the
    # kernel as a launch argument. Held against the hash of the counters.
    from p2pnetwork_tpu_torch.ops import threefry

    _card()
    dev = torch.device("cuda")
    key = (0x9E3779B9, 7)
    launches = threefry.LAUNCHES
    got = threefry.threefry_bits(*key, n, dev, offset=offset)
    assert threefry.LAUNCHES - launches == len(
        threefry.launch_spans(offset, n))
    want = threefry.hash_counters(
        *key, torch.arange(offset, offset + n, dtype=torch.int64))
    assert torch.equal(got.cpu(), threefry.to_i32(want))
    got = threefry.threefry_uniform(*key, n, -3.5, 10.5, dev, offset=offset)
    want = threefry.threefry_uniform_plain(*key, n, -3.5, 10.5, "cpu",
                                           offset=offset)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


# ------------------------------------- max, min-plus and analytics on card
#
# No kernel of its own: max and min-plus are torch scatters and row
# reductions over ordered integer keys (ops/extremum.py). Their CUDA
# lowerings (i32 atomics, row reductions) must give the CPU's bits, NaN
# and signed zeros included; the protocols on top also launch B1 and
# threefry. Each is held against the same call on the CPU.


def _latency(s, r):
    h = s.astype(np.uint32) * np.uint32(2654435761) + r.astype(np.uint32)
    return 1.0 + (h % 2048).astype(np.float32) / 1024.0


def _churned_pair():
    from p2pnetwork_tpu_torch.sim import failures, topology
    from p2pnetwork_tpu_torch.sim import graph as G

    out = []
    for dev in ("cpu", "cuda"):
        g = G.watts_strogatz(4096, 10, 0.1, seed=0, blocked=True,
                             hybrid=True, source_csr=True, skew_table=True,
                             device=dev).with_weights(_latency)
        g = topology.with_capacity(g, extra_edges=128)
        g = topology.connect(g, np.arange(0, 40, 2), np.arange(900, 940, 2))
        out.append(failures.fail_nodes(g, np.arange(500, 700)))
    return out


def _bits(t):
    a = t.cpu().clone()
    if a.dtype.is_floating_point:
        a[torch.isnan(a)] = torch.nan
        return a.view(torch.int32)
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["segment", "gather", "skew", "frontier"])
def test_max_and_min_plus_on_card_equal_cpu(method):
    from p2pnetwork_tpu_torch.ops import segment

    _card()
    cpu, gpu = _churned_pair()
    n = cpu.n_nodes_padded
    rng = np.random.default_rng(0)
    vals = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, -2.0],
                    np.float32)
    sparse = np.full(n, -np.inf, np.float32)
    sparse[[3, 10, 50]] = [np.nan, -0.0, 0.0]
    signals = [vals[rng.integers(0, vals.size, n)], sparse,
               rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
               (rng.random(n) * 10).astype(np.float32)]
    for x in signals:
        xs = torch.from_numpy(x)
        for fn in (segment.propagate_max, segment.propagate_min_plus):
            if fn is segment.propagate_min_plus and x.dtype == np.int32:
                continue
            want = fn(cpu, xs, method)
            got = fn(gpu, xs.cuda(), method)
            assert got.device.type == "cuda"
            assert torch.equal(_bits(got), _bits(want)), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["segment", "gather", "skew", "frontier"])
def test_routing_on_card_equals_cpu(method):
    from p2pnetwork_tpu_torch import models, prng
    from p2pnetwork_tpu_torch.sim import engine

    _card()
    res = []
    for g in _churned_pair():
        proto = models.DistanceVector(source=1, method=method)
        st, out = engine.run_until_converged(g, proto, prng.key(0),
                                             stat="changed", threshold=1)
        res.append((out, _bits(st.dist), st.parent.cpu(),
                    proto.next_hops(g, st).cpu()))
    assert res[0][0] == res[1][0]
    for a, b in zip(res[0][1:], res[1][1:]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_analytics_on_card_equal_cpu():
    # MIS draws through threefry's bits and announces through B1's OR;
    # KCore sums through B1's sum entry (f32 under pallas and hybrid);
    # permutation sorts threefry keys on the card.
    from p2pnetwork_tpu_torch import models, prng
    from p2pnetwork_tpu_torch.sim import engine

    _card()
    cpu, gpu = _churned_pair()
    runs = [(models.LubyMIS(method="gather", or_method="hybrid"),
             "undecided", "in_mis"),
            (models.KCore(k=9, method="pallas"), "removed", "in_core"),
            (models.KCore(k=9, method="hybrid"), "removed", "in_core"),
            (models.AdaptiveHopDistance(source=2, method="hybrid", k=64),
             "frontier", "dist"),
            (models.SpanningTree(source=2, method="gather"), "frontier",
             "parent")]
    for proto, stat, field in runs:
        (sa, oa), (sb, ob) = (engine.run_until_converged(
            g, proto, prng.key(3), stat=stat, threshold=1)
            for g in (cpu, gpu))
        assert oa == ob, proto
        assert torch.equal(getattr(sa, field), getattr(sb, field).cpu())
    a = prng.permutation(prng.key(5), 100_000, device="cpu")
    assert torch.equal(a, prng.permutation(prng.key(5), 100_000,
                                           device="cuda").cpu())
    assert models.diameter_bounds(cpu, prng.key(1), 4, "hybrid") == \
        models.diameter_bounds(gpu, prng.key(1), 4, "hybrid")


@pytest.mark.cuda
@pytest.mark.parametrize("delay_rank", [0, 1])
def test_ring_put_across_two_ranks(delay_rank):
    """B2's and B3's cross-rank forms (``csrc/ring_peer.cu``: the hop, the
    pass kernel) at 2 ranks on the card against their plain versions and
    the global roll, then 256 hops with one rank held back before each
    put, every block checked (``tests/torch_rank_worker.py::card_puts``)."""
    _card()
    from p2pnetwork_tpu_torch.parallel import multihost
    from tests import torch_rank_worker

    steps = 256
    parts = multihost.launch(f"{torch_rank_worker.__file__}:card_puts", 2,
                             (8, steps, delay_rank), timeout=300,
                             device="cuda")
    for p in parts:
        assert p["errors"] == []
        assert p["bad"] == 0
        assert p["puts"] == p["lands"] == steps


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 8])
def test_ring_gather_across_ranks(world):
    """A pass's one exchange (``ring_gather``) at 2 and 8 ranks on the
    card: bool, f32, i32 and the lane words against its plain version and
    the global stack, every step's rows against the global roll, the pass
    kernel of both kinds against its plain version and the fold from
    hops, then 128 gathers with the last rank held back, every step's
    rows checked (``tests/torch_rank_worker.py::card_gather``)."""
    _card()
    from p2pnetwork_tpu_torch.parallel import multihost
    from tests import torch_rank_worker

    steps = 128
    parts = multihost.launch(f"{torch_rank_worker.__file__}:card_gather",
                             world, (8, steps), timeout=600, device="cuda")
    for p in parts:
        assert p["errors"] == []
        assert p["bad"] == 0
        assert p["gathers"] == steps


@pytest.mark.cuda
@pytest.mark.parametrize("payload", ["i32", "lanes", "segsum_sum"])
def test_protocol_payloads_across_two_ranks(payload):
    """The cross-rank kernels on the ring protocols' payloads at 2 ranks:
    B2 on election's i32 ids and on the lane plane's 3-D word stack
    ``[4, 32, 12512]``, B3's sum form across ranks (the pass kernel: SIR,
    PageRank, push-sum on ``mxu``), each against its plain version and
    the global roll or the fold from hops, bit for bit
    (``tests/torch_rank_worker.py::card_payload``)."""
    _card()
    from p2pnetwork_tpu_torch.parallel import multihost
    from tests import torch_rank_worker

    parts = multihost.launch(f"{torch_rank_worker.__file__}:card_payload",
                             2, (8, payload), timeout=300, device="cuda")
    for p in parts:
        assert p["errors"] == [] and p["checked"] > 0


def _close(got, want, what):
    """Equal, but f32 within ``RTOL``/``ATOL``: the card's f32 sums add
    with atomics in a varying order."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _close(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]")
    elif isinstance(want, (float, np.floating)) or (
            isinstance(want, np.ndarray) and want.dtype.kind == "f"):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want), what
    else:
        assert got == want, what


@pytest.mark.cuda
def test_rank_protocols_on_the_card_equal_one_process(tmp_path):
    """The ring's protocols (``tests/torch_rank_worker.py::protocols``) on
    the card at 2 ranks of 4 shards (B2 and B3 across ranks on f32, i32,
    bool and the lane words), equal to the same runs on one process's
    8-shard ring: integers, bools and digests exactly, f32 within
    ``RTOL``/``ATOL`` (the card's sums add in a varying order)."""
    _card()
    from p2pnetwork_tpu_torch.parallel import multihost
    from tests import torch_rank_worker as W

    one = W.gather_runs([W.protocols(8, str(tmp_path / "one"), True,
                                     "cuda")])
    got = W.gather_runs(multihost.launch(
        f"{W.__file__}:protocols", 2, (8, str(tmp_path / "ranks"), True,
                                       "cuda"), timeout=600, device="cuda"))
    assert sorted(got) == sorted(one)
    for name in one:
        _close(got[name], one[name], name)


@pytest.mark.cuda
def test_rank_suite_on_the_card_equals_one_process():
    """The reference worker's suite (``tests/torch_rank_worker.py``) on
    the card, 2 ranks of 4 shards (the cross-rank kernels), equals the
    same suite on one process's 8-shard ring (the one-card kernels), bit
    for bit, but for ``propagate("sum")`` of random f32 values: the card's
    sums add with atomics in a varying order (``scatter_add_``, B1, B3),
    so those are held to ``RTOL``/``ATOL``."""
    _card()
    from p2pnetwork_tpu_torch.parallel import multihost
    from tests import torch_rank_worker as W

    one = W.suite(8, "cuda")
    got = W.gather(multihost.launch(f"{W.__file__}:suite", 2, (8, "cuda"),
                                    timeout=300, device="cuda"))
    for phase, fields in got.items():
        for k, v in fields.items():
            want = one[phase][k]
            if isinstance(v, dict):
                assert v == want, (phase, k)
            else:
                assert v.dtype == want.dtype and v.shape == want.shape
                if k == "sum":
                    np.testing.assert_allclose(v, want, rtol=RTOL, atol=ATOL)
                else:
                    assert v.tobytes() == want.tobytes(), (phase, k)
