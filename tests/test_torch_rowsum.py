"""The ordered row-sum kernel (``ops/rowsum.py``, ``csrc/rowsum.cu``) and
its plain version, against XLA's reduce.

On the CPU the wrappers take the plain version, whose bits are held to
``jnp.sum``'s on the CPU (the reduce the JAX package's ``gather`` and
``skew`` sums and its 1-D sums make) at every width whose order is
measured: exact, no tolerance. The ``cuda``-marked tests launch the
kernel, at those widths and at deeper ones (> 1,024 terms, three
levels), and hold it bit for bit to the plain version on the card; they
skip without a card. On the card's machine, which has no JAX:

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


#: Widths whose order XLA's CPU reduce is measured for: <= 32, and
#: multiples of 32 (ROADMAP.md, known differences).
WIDTHS = [1, 5, 17, 31, 32, 64, 128, 256]


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


@pytest.mark.parametrize("n", [1, 32, 1024, 4096])
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


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run via chip_smoke.py)")


#: The kernel's paths: one thread a row (<= 32 terms, > 1,024), one lane a
#: window (33 to 1,024, 1 to 32 rows a warp).
CARD_WIDTHS = [0, 1, 17, 32, 33, 40, 100, 128, 500, 700, 1000, 1024, 1025,
               2500, 40000]


@pytest.mark.cuda
@pytest.mark.parametrize("width", CARD_WIDTHS)
def test_kernel_matches_plain_on_card(width):
    _card()
    rng = np.random.default_rng(width)
    rows = 3 if width > 1024 else 1000
    v = torch.from_numpy(_terms(rng, rows, width)).cuda()
    launches = RS.LAUNCHES
    got = RS.row_sum(v)
    assert RS.LAUNCHES == launches + 1
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
