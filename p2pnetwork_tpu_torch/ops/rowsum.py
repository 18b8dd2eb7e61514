"""Row sums of f32 terms in XLA's CPU order: the hand-written CUDA kernel
(``csrc/rowsum.cu``) and its plain version.

Not a TPU kernel's counterpart: the JAX package's ``gather`` and ``skew``
sums (a row of gathered terms summed by ``jnp.sum``) and the batch
recorder's 1-D sums are XLA reduces, and the port gives their bits only by
adding in their order (:data:`REDUCE_WINDOW`). torch's vectorized ``sum``
adds in another order and differs in the last bit. The plain version
below keeps the order with one elementwise launch per column of a window;
the kernels add in that order too, and fuse the gather and the mask
product into the sum (:func:`gather_row_sum`): a thread a row of <= 32
terms; rows of 33 to 1,024 in tiles (:func:`tile_rows`) staged through
shared memory. For :func:`row_sum` (the 1-D sums) a warp loads a row of
<= 1,024 terms once and adds its windows. Rows of more than 1,024 terms
(the ring's shard totals), in both entries: a warp a level-1 window of
1,024 terms, and the last warp of a row to finish adds the row's window
sums, in one launch up to 32^4 terms a row (:func:`wide_plan`,
:func:`span_outputs`).

A CPU tensor takes the plain version; a CUDA f32 one launches the kernel,
and any other CUDA float raises. Integer terms are summed directly (their
order does not matter). ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from p2pnetwork_tpu_torch import _build, _device

#: Kernel launches made by :func:`row_sum` and :func:`gather_row_sum`.
LAUNCHES = 0

#: The window of XLA's CPU tree reduction (measured with jax 0.9.0): a
#: reduced axis longer than this is summed window by window, each window
#: left to right from 0, and the window sums are reduced the same way.
REDUCE_WINDOW = 32

#: Terms of a span kernel warp's level-1 window (``csrc/rowsum.cu``): rows
#: wider than this take the span passes.
SPAN = REDUCE_WINDOW ** 2

#: The gather kernel's tile buffers (``csrc/rowsum.cu``, rows of 33 to
#: 1,024 terms): terms staged a tile, product words (each window padded to
#: an odd stride) and window sums.
TILE_TERMS = 2048
TILE_SLOTS = 2112
TILE_SUM_SLOTS = 128

_bound = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = _build.library()
        q, i, p = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
        lib.p2p_row_sum_f32.argtypes = [p, q, q, p, i, p, p, p, i, p]
        lib.p2p_gather_row_sum_f32.argtypes = [p, p, p, q, q, q, p, i, p, p,
                                               p, i, p]
        lib.p2p_row_sum_f32.restype = i
        lib.p2p_gather_row_sum_f32.restype = i
        _bound = lib
    return _bound


def tile_rows(width: int) -> int:
    """Rows of ``width`` terms in one of the gather kernel's tiles (rows of
    33 to 1,024 terms): as many as fit ``TILE_TERMS`` terms,
    ``TILE_SLOTS`` product words (windows of 32 padded to 33 words) and
    ``TILE_SUM_SLOTS`` window sums (an odd stride a row); 0 for the widths
    the tile path does not take. The launch may take fewer, so that every
    block gets the same number of tiles."""
    if width <= REDUCE_WINDOW or width > REDUCE_WINDOW ** 2:
        return 0
    n = -(-width // REDUCE_WINDOW)
    return min(TILE_TERMS // width, TILE_SLOTS // (n * (REDUCE_WINDOW + 1)),
               TILE_SUM_SLOTS // (n | 1))


def wide_plan(width: int) -> tuple[list[tuple[int, int]], int]:
    """The levels of XLA's window reduction of a row of ``width`` terms:
    ``([(items, front), ...], top)``, each level of more than 32 items with
    the zeros padded in front of it (``p // 2`` of ``p = -items mod 32``),
    then the item count of the top (<= 32, added left to right). 125,008
    terms: ``([(125008, 8), (3907, 14), (123, 2)], 4)``."""
    levels, n = [], width
    while n > REDUCE_WINDOW:
        pad = -n % REDUCE_WINDOW
        levels.append((n, pad // 2))
        n = (n + pad) // REDUCE_WINDOW
    return levels, n


def span_outputs(width: int) -> list[int]:
    """The window sums a row of ``width`` > :data:`SPAN` terms has after
    each of the span kernel's passes, one launch each: a pass takes two
    levels of :func:`wide_plan`, and the last leaves <= 1,024 (125,008
    terms: ``[123]``; 1,048,577: ``[1025, 2]``). Empty for narrower
    rows."""
    levels, top = wide_plan(width)
    items = [n for n, _ in levels] + [top]
    return [items[l + 2] for l in range(0, len(items), 2)
            if items[l] > SPAN]


def launches_for(width: int) -> int:
    """Kernel launches a row sum of rows of ``width`` terms makes."""
    return max(1, len(span_outputs(width)))


def row_sum_plain(vals: torch.Tensor) -> torch.Tensor:
    """``vals.sum(dim=1)`` for a ``[rows, W]`` float tensor, in the order
    XLA's CPU reduce adds: a row of one column is that term, rows of <= 32
    columns are added left to right from 0, longer ones window by window.
    A row whose width is not a multiple of 32 is padded with ``p = -W mod
    32`` zeros, ``p // 2`` in front and the rest behind (XLA's
    ``reduce-window`` padding), at every level. One add per column of a
    window, for all windows at once, and level (32 for 1,024 terms, then
    32 more)."""
    rows, width = vals.shape
    if width == 1:
        # XLA reduces one term to itself: no add, so a -0 stays -0.
        return vals[:, 0].clone()
    if width > REDUCE_WINDOW:
        # A sum that starts from +0 is never -0, so the zeros leave the
        # bits of every partial sum as they are.
        pad = -width % REDUCE_WINDOW
        if pad:
            vals = torch.nn.functional.pad(vals, (pad // 2, pad - pad // 2))
        return row_sum_plain(
            _window_sums(vals.reshape(rows, -1, REDUCE_WINDOW)))
    return _window_sums(vals[:, None, :])[:, 0]


def _window_sums(windows: torch.Tensor) -> torch.Tensor:
    """``[rows, n, w] -> [rows, n]``: each window added left to right
    from 0, one add per column for all windows at once."""
    total = windows.new_zeros(windows.shape[:2])
    for j in range(windows.shape[2]):
        total = total + windows[:, :, j]
    return total


def gather_row_sum_plain(signal: torch.Tensor, idx: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """``row_sum_plain(signal[idx] * mask)``: the gather, the mask product
    and the ordered sum as separate launches."""
    return row_sum_plain(signal[idx] * mask.to(signal.dtype))


def _check_f32(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel adds f32 terms, got "
                        f"{t.dtype}")


#: The span kernel's arrival counters by (device, stream): one zero a row,
#: which every launch leaves at zero (a row's last warp resets its count),
#: so they are zeroed once. A buffer a stream, so that launches on two
#: streams never share a count.
_COUNTERS: dict = {}  # graftlint: ignore[unbounded-cache] -- one buffer per (device, stream) that launches the span kernel: a process has a fixed few, and a buffer must outlive its launches


def _counters(device, stream, rows: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < rows:
        buf = torch.zeros(rows, dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def _launch(entry: str, rows: int, width: int, device,
            *args) -> torch.Tensor:
    global LAUNCHES
    out = torch.empty(rows, dtype=torch.float32, device=device)
    if rows == 0:
        return out
    stream = torch.cuda.current_stream(device).cuda_stream
    # Rows of more than SPAN terms: the plan, the passes' window sums and
    # the counters (span_passes in csrc/rowsum.cu); null otherwise.
    plan, levels, work, count = None, 0, None, None
    outputs = span_outputs(width)
    if outputs:
        steps, top = wide_plan(width)
        flat = [v for level in steps for v in level] + [top]
        plan, levels = (ctypes.c_int64 * len(flat))(*flat), len(steps)
        work = torch.empty(rows * sum(outputs), dtype=torch.float32,
                           device=device)
        count = _counters(device, stream, rows)
    rc = getattr(_lib(), entry)(
        *args, plan, levels, None if work is None else work.data_ptr(),
        None if count is None else count.data_ptr(), out.data_ptr(),
        device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: kernel launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES += launches_for(width)
    return out


def _row_sum_launches(vals, *args, **kwargs) -> int:
    if not vals.dtype.is_floating_point or vals.dim() != 2:
        return 0
    return launches_for(vals.shape[1]) if vals.shape[0] else 0


def _gather_launches(signal, idx, *args, **kwargs) -> int:
    if not signal.dtype.is_floating_point or idx.dim() != 2:
        return 0
    return launches_for(idx.shape[1]) if idx.shape[0] else 0


@_device.kernel("row_sum", _row_sum_launches)
def row_sum(vals: torch.Tensor) -> torch.Tensor:
    """The ``[rows]`` sums of a ``[rows, W]`` tensor's rows, f32 ones in
    XLA's order (:func:`row_sum_plain`)."""
    if not vals.dtype.is_floating_point:
        return vals.sum(dim=1, dtype=vals.dtype)
    if vals.device.type == "cpu":
        return row_sum_plain(vals)
    _check_f32("row_sum", vals)
    vals = vals.contiguous()
    rows, width = vals.shape
    return _launch("p2p_row_sum_f32", rows, width, vals.device,
                   vals.data_ptr(), rows, width)


@_device.kernel("gather_row_sum", _gather_launches)
def gather_row_sum(signal: torch.Tensor, idx: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum_j signal[idx[r, j]] * mask[r, j]`` over ``[rows, W]``
    index (i32) and bool mask tables: the ``gather`` and ``skew`` row sums,
    f32 ones in XLA's order. Every index must lie in ``signal`` (padding
    slots point at a real id, masked out)."""
    if not signal.dtype.is_floating_point:
        return (signal[idx] * mask.to(signal.dtype)).sum(dim=1,
                                                         dtype=signal.dtype)
    if signal.device.type == "cpu":
        return gather_row_sum_plain(signal, idx, mask)
    _check_f32("gather_row_sum", signal)
    if idx.dtype != torch.int32 or mask.dtype != torch.bool:
        raise TypeError(f"gather_row_sum: expected i32 indices and a bool "
                        f"mask, got {idx.dtype} and {mask.dtype}")
    signal, idx, mask = signal.contiguous(), idx.contiguous(), \
        mask.contiguous()
    rows, width = idx.shape
    return _launch("p2p_gather_row_sum_f32", rows, width, signal.device,
                   signal.data_ptr(), idx.data_ptr(), mask.data_ptr(), rows,
                   width, tile_rows(width))
