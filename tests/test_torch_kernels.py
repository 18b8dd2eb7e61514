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
    # signal * mask: a non-finite signal behind a masked slot still
    # poisons its destination, as the reference's contrib does.
    sig = torch.tensor([np.inf, 1.0])
    src = torch.tensor([[0, 1]], dtype=torch.int32)
    dst = torch.tensor([[0, 1]], dtype=torch.int32)
    mask = torch.tensor([[False, True]])
    out = segsum.segsum_sum(sig, src, dst, mask, 128)
    assert torch.isnan(out[0]) and out[1] == 1.0


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
], ids=["shift-device", "shift-layout", "segsum-device", "segsum-dtype",
        "segsum-rows", "stacked-shards", "stacked-dims"])
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
    (torch.int32, (3, 2, 31)),
], ids=["bool-1M", "f32-1M", "bytes", "words", "lanes", "shard-1B",
        "shard-15B", "shard-17B", "shard-125007B", "f32-lanes",
        "i32-lanes"])
def test_ring_shift_kernel_matches_plain_on_card(reverse, dtype, shape):
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 100, shape, generator=g, device="cuda").to(dtype)
    before = ring.SHIFT_LAUNCHES
    got = ring.ring_shift(x, reverse=reverse)
    assert ring.SHIFT_LAUNCHES == before + 1
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
