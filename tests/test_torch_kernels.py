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


@pytest.mark.cuda
@pytest.mark.parametrize("nb,w,block", [(1954, 640, 512), (7813, 1408, 128)])
def test_kernel_matches_plain_on_card(nb, w, block):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run via chip_smoke.py)")
    rng = np.random.default_rng(nb)
    n_pad = 1_000_064
    src, dst, mask = (torch.from_numpy(a).cuda()
                      for a in _random_layout(rng, nb, w, block, n_pad))
    sig = torch.from_numpy(rng.random(n_pad) < 0.1).cuda()
    before = segsum.LAUNCHES
    got = segsum.segsum_or(sig, src, dst, mask, block)
    assert segsum.LAUNCHES == before + 1
    assert torch.equal(got, segsum.segsum_or_plain(sig, src, dst, mask, block))
    x = torch.from_numpy(rng.standard_normal(n_pad).astype(np.float32)).cuda()
    torch.testing.assert_close(segsum.segsum_sum(x, src, dst, mask, block),
                               segsum.segsum_sum_plain(x, src, dst, mask, block),
                               rtol=RTOL, atol=ATOL)
    xi = torch.round(x * 8)
    assert torch.equal(segsum.segsum_sum(xi, src, dst, mask, block),
                       segsum.segsum_sum_plain(xi, src, dst, mask, block))
