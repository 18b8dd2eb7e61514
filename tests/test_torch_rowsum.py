"""The ordered row-sum kernel (``ops/rowsum.py``, ``csrc/rowsum.cu``) and
its plain version, against XLA's reduce.

On the CPU the wrappers take the plain version, whose bits are held to
``jnp.sum``'s on the CPU (the reduce the JAX package's ``gather`` and
``skew`` sums and its 1-D sums make) at every width whose order is
measured: exact, no tolerance. The order of the span kernel (rows of
more than 1,024 terms) is emulated with torch from :func:`RS.wide_plan`
and held to both. The ``cuda``-marked tests launch the kernel, at those
widths and at deeper ones (> 1,024 terms, up to 32^4 + 1 in two
launches), and hold it bit for bit to the plain version on the card;
they skip without a card. On the card's machine, which has no JAX:

    python -m pytest tests/test_torch_rowsum.py -q -m cuda
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from p2pnetwork_tpu_torch.ops import rowsum as RS  # noqa: E402
from p2pnetwork_tpu_torch.utils import accum  # noqa: E402


def _jnp():
    # JAX only where the reference is asked: the card's machine has none,
    # and runs the ``cuda`` tests of this file alone.
    return pytest.importorskip("jax.numpy")


def bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _terms(rng, rows, width):
    """f32 terms over six decades, so the order of adds shows."""
    return (rng.standard_normal((rows, width))
            * 10.0 ** rng.uniform(-3, 3, (rows, width))).astype(np.float32)


WIDTHS = [1, 5, 17, 31, 32, 33, 40, 48, 64, 90, 128, 130, 256, 1000]


@pytest.mark.parametrize("width", WIDTHS)
def test_row_sum_equals_xla(width):
    jnp = _jnp()
    v = _terms(np.random.default_rng(width), 257, width)
    got = RS.row_sum(torch.from_numpy(v))
    np.testing.assert_array_equal(bits(got.numpy()),
                                  bits(jnp.sum(jnp.asarray(v), axis=1)))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("nonfinite", [False, True], ids=["finite", "inf"])
def test_gather_row_sum_equals_xla(width, nonfinite):
    jnp = _jnp()
    rng = np.random.default_rng(100 + width)
    signal = _terms(rng, 1, 500)[0]
    if nonfinite:
        # A masked-out inf gives NaN (inf * 0), a live one inf.
        signal[rng.integers(0, 500, 20)] = np.inf
    idx = rng.integers(0, 500, (300, width)).astype(np.int32)
    mask = rng.random((300, width)) < 0.8
    got = RS.gather_row_sum(torch.from_numpy(signal), torch.from_numpy(idx),
                            torch.from_numpy(mask))
    want = jnp.sum(jnp.asarray(signal)[idx] * jnp.asarray(mask, jnp.float32),
                   axis=1)
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))


@pytest.mark.parametrize("n", [1, 32, 1000, 1024, 4096, 125008])
def test_ordered_sum_equals_xla(n):
    jnp = _jnp()
    x = _terms(np.random.default_rng(n), 1, n)[0]
    got = accum.ordered_sum(torch.from_numpy(x))
    assert got.shape == ()
    assert bits(got.numpy()) == bits(jnp.sum(jnp.asarray(x)))


def test_integer_terms_sum_directly():
    rng = np.random.default_rng(1)
    signal = torch.from_numpy(rng.integers(-9, 9, 50).astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, 50, (40, 7)).astype(np.int32))
    mask = torch.from_numpy(rng.random((40, 7)) < 0.5)
    got = RS.gather_row_sum(signal, idx, mask)
    assert got.dtype == torch.int32
    want = (signal[idx.long()] * mask).sum(dim=1)
    torch.testing.assert_close(got, want.to(torch.int32), rtol=0, atol=0)
    assert torch.equal(RS.row_sum(idx), idx.sum(dim=1, dtype=torch.int32))


def test_wrappers_refuse_what_the_kernel_does_not_take():
    # A non-CPU tensor goes to the kernel, which adds f32 terms only; the
    # refusal comes before any launch (a meta tensor stands in).
    f64 = torch.zeros(4, 3, dtype=torch.float64, device="meta")
    with pytest.raises(TypeError, match="adds f32 terms"):
        RS.row_sum(f64)
    sig = torch.zeros(8, device="meta")
    with pytest.raises(TypeError, match="i32 indices and a bool mask"):
        RS.gather_row_sum(sig, torch.zeros(2, 3, dtype=torch.int64,
                                           device="meta"),
                          torch.zeros(2, 3, dtype=torch.bool, device="meta"))


def test_tile_rows_fit_the_kernel_buffers():
    # Every width the tile path takes (33 to 1,024 terms) gets at least one
    # row a tile, and a tile's terms, padded products (windows of 32 at a
    # stride of 33) and window sums fit the kernel's buffers; one row more
    # would not (the tile is as large as they let it be).
    assert RS.tile_rows(0) == RS.tile_rows(32) == RS.tile_rows(1025) == 0
    for w in range(33, 1025):
        n = -(-w // 32)

        def fits(r):
            return (r * w <= RS.TILE_TERMS
                    and r * n * 33 <= RS.TILE_SLOTS
                    and r * (n | 1) <= RS.TILE_SUM_SLOTS)
        r = RS.tile_rows(w)
        assert r >= 1 and fits(r) and not fits(r + 1), w
    assert [RS.tile_rows(w) for w in (33, 64, 128, 1000, 1024)] == \
        [32, 32, 16, 2, 2]


@pytest.fixture
def one_torch_thread():
    """Torch ops on one thread (xdist's workers share the cores), then the
    count restored; elementwise f32 adds give the same bits either way."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_wide_plan_levels():
    # Each level's items and front zeros down to the top of <= 32: the
    # ring's shard blocks at 1M (one span pass: 123 warps a row, a top of
    # 123 window sums) and 100K (13), and a row past 32^4 in two passes.
    assert RS.wide_plan(125008) == ([(125008, 8), (3907, 14), (123, 2)], 4)
    assert RS.wide_plan(12512) == ([(12512, 0), (391, 12)], 13)
    assert RS.wide_plan(1024) == ([(1024, 0)], 32)
    assert RS.wide_plan(17) == ([], 17)
    assert RS.span_outputs(125008) == [123]
    assert RS.span_outputs(12512) == [13]
    assert RS.span_outputs(1024) == []
    assert RS.span_outputs(1025) == [2]
    assert RS.span_outputs(32 ** 4) == [1024]
    assert RS.span_outputs(32 ** 4 + 1) == [1025, 2]
    assert [RS.launches_for(w) for w in (0, 17, 1024, 125008, 32 ** 4,
                                         32 ** 4 + 1)] == [1, 1, 1, 1, 1, 2]


def _sequential(terms):
    """``[..., k] -> [...]``: left to right from +0, one add a column."""
    acc = terms.new_zeros(terms.shape[:-1])
    for j in range(terms.shape[-1]):
        acc = acc + terms[..., j]
    return acc


def _warp_sum(items, first, count, windows):
    """One warp of the span kernel on ``[rows, count]`` items: for each
    of ``first``'s entries (``[spans]`` item offsets), load j of lane l is
    item ``first + 32 j + l``, zero outside the row; lane k adds window k
    (its 32 slots) left to right from +0, then the lanes' sums add in lane
    order. ``[rows, spans]``."""
    k = torch.arange(windows)[None, :, None]
    s = torch.arange(32)[None, None, :]
    c = first[:, None, None] + 32 * k + s
    terms = torch.where((c >= 0) & (c < count),
                        items[:, c.clamp(0, count - 1)],
                        torch.zeros((), dtype=items.dtype))
    return _sequential(_sequential(terms))


def _span_emulation(vals):
    """The span kernel's order for ``[rows, W > 1,024]`` on the CPU, from
    :func:`RS.wide_plan` alone: each pass's warp m sums the real items
    ``32 (32 m - f1) - f0 + [0, 1,024)``; passes repeat on the window sums
    until <= 1,024 are left, which the row's last warp sums as a row of n
    items (one is itself, <= 32 left to right, wider windows of the row
    padded with ``(32 ceil(n / 32) - n) // 2`` zeros in front)."""
    levels, top = RS.wide_plan(vals.shape[1])
    items = [n for n, _ in levels] + [top]
    l, cur = 0, vals
    while cur.shape[1] > RS.SPAN:
        m = torch.arange(items[l + 2])
        cur = _warp_sum(cur, 32 * (32 * m - levels[l + 1][1]) - levels[l][1],
                        items[l], 32)
        l += 2
    n = cur.shape[1]
    if n == 1:
        return cur[:, 0]
    if n <= 32:
        return _sequential(cur)
    windows = -(-n // 32)
    return _warp_sum(cur, torch.tensor([-((32 * windows - n) // 2)]), n,
                     windows)[:, 0]


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("width", [1025, 1056, 2500, 12512, 32769, 125008,
                                   32 ** 4 + 1])
def test_span_emulation_equals_xla(width):
    # Rows with inf terms, with -0 terms, and of +-0 only (their sum +0,
    # as XLA's); one row at the widest.
    jnp = _jnp()
    rng = np.random.default_rng(width)
    rows = 1 if width > 32 ** 4 else 4
    v = _terms(rng, rows, width)
    v[0, rng.random(width) < 0.1] = -0.0
    if rows > 1:
        v[1, rng.integers(0, width, 3)] = np.inf
        v[2] = np.where(rng.random(width) < 0.5, 0.0, -0.0)
    got = _span_emulation(torch.from_numpy(v))
    np.testing.assert_array_equal(bits(got.numpy()),
                                  bits(jnp.sum(jnp.asarray(v), axis=1)))
    np.testing.assert_array_equal(
        bits(got.numpy()), bits(RS.row_sum_plain(torch.from_numpy(v))))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run via chip_smoke.py)")


#: The kernel's paths: a thread a row (the gather entry's <= 32 terms), a
#: warp a row (the dense entry's <= 1,024), tiles (the gather entry's 33
#: to 1,024), a warp a level-1 window (> 1,024: the ring's shard blocks
#: 12,512 and 125,008; 32^4 in one launch, 32^4 + 1 in two).
CARD_WIDTHS = [0, 1, 17, 32, 33, 40, 100, 128, 500, 700, 1000, 1024, 1025,
               2500, 12512, 32768, 40000, 125008, 32 ** 4, 32 ** 4 + 1]


@pytest.mark.cuda
@pytest.mark.parametrize("width", CARD_WIDTHS)
def test_kernel_matches_plain_on_card(width):
    _card()
    rng = np.random.default_rng(width)
    # The ring's per-shard sums are 8 rows of a 1M (100K) population's
    # blocks.
    rows = 8 if width in (12512, 125008) else 3 if width > 1024 else 1000
    v = torch.from_numpy(_terms(rng, rows, width)).cuda()
    launches = RS.LAUNCHES
    got = RS.row_sum(v)
    assert RS.LAUNCHES == launches + RS.launches_for(width)
    assert torch.equal(got.view(torch.int32),
                       RS.row_sum_plain(v).view(torch.int32))
    signal = torch.from_numpy(_terms(rng, 1, 4096)[0]).cuda()
    signal[::97] = float("inf")
    idx = torch.from_numpy(rng.integers(0, 4096, (rows, width))
                           .astype(np.int32)).cuda()
    mask = torch.from_numpy(rng.random((rows, width)) < 0.8).cuda()
    got = RS.gather_row_sum(signal, idx, mask)
    want = RS.gather_row_sum_plain(signal, idx, mask)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


#: Kernel edges: (width, rows). Narrow rows (17, the 1M table's; 1, 31,
#: 32) at row counts that are not multiples of the 8-term chunk or of a
#: block; wide rows (33, 128 the BA shape's, 1,024) that leave the last
#: tile partial (one row past whole tiles, and fewer rows than a tile);
#: the recorder's one-row dense sums; rows of more than 1,024 terms (the
#: span passes: the shard blocks, a last window of one term, two passes).
EDGE_CASES = [(17, 3 * 120 + 1), (17, 7), (128, 5 * 16 + 1), (128, 3),
              (1024, 2 * 3 + 1), (33, 32 * 4 + 31), (1, 2049), (31, 67),
              (32, 1), (1024, 1), (1025, 5), (12512, 8), (125008, 3),
              (32 ** 4 + 1, 2)]


def _same_on_cpu(got, want):
    """``got`` (the kernel's, on the card) against the CPU's plain
    version: NaN at the same rows (the CPU's inf * 0 sets the sign bit
    of its NaN, the card's does not), the bits equal elsewhere."""
    got = got.cpu()
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def _view(t, skip):
    """``t``'s values in a buffer ``skip`` elements in: a view whose base
    is ``skip`` elements past an aligned allocation."""
    buf = torch.empty(t.numel() + skip, dtype=t.dtype, device=t.device)
    view = buf[skip:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("skip", [0, 1, 3])
@pytest.mark.parametrize("width,rows", EDGE_CASES)
def test_kernel_edges_on_card(width, rows, skip):
    # Bases 4 and 12 bytes past a 16-byte boundary for the indices and
    # values, 1 and 3 for the mask; inf terms (NaN where masked out), -0
    # terms (a one-term row keeps its -0) and rows of +-0 only (-0 alone,
    # and both). Bit for bit against the plain version on the card, and
    # against the CPU's.
    _card()
    rng = np.random.default_rng(width * 1000 + rows + skip)
    v = _terms(rng, rows, width)
    v[rng.random((rows, width)) < 0.1] = -0.0
    v[rng.random((rows, width)) < 0.02] = np.inf
    v[0] = -0.0
    if rows > 1:
        v[-1] = np.where(rng.random(width) < 0.5, 0.0, -0.0)
    vals = _view(torch.from_numpy(v).cuda(), skip)
    launches = RS.LAUNCHES
    got = RS.row_sum(vals)
    assert RS.LAUNCHES == launches + RS.launches_for(width)
    want = RS.row_sum_plain(vals)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert _same_on_cpu(got, RS.row_sum_plain(vals.cpu()))
    signal = _terms(rng, 1, 4099)[0]
    signal[::97] = np.inf
    signal[1::89] = -0.0
    signal = _view(torch.from_numpy(signal).cuda(), skip)
    idx = _view(torch.from_numpy(rng.integers(0, 4099, (rows, width))
                                 .astype(np.int32)).cuda(), skip)
    mask = _view(torch.from_numpy(rng.random((rows, width)) < 0.7).cuda(),
                 skip)
    got = RS.gather_row_sum(signal, idx, mask)
    want = RS.gather_row_sum_plain(signal, idx, mask)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert _same_on_cpu(got, RS.gather_row_sum_plain(
        signal.cpu(), idx.cpu(), mask.cpu()))
