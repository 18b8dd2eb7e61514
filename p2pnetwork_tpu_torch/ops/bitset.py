"""Bit-packed node predicates, 32 nodes per word (torch counterpart of the
node-packing half of ``p2pnetwork_tpu/ops/bitset.py``).

Bit ``i`` of word ``w`` is node ``32 * w + i`` (LSB first). The reference's
words are ``uint32``; torch has no unsigned 32-bit arithmetic, so here
they are ``int32`` holding the same bit patterns (``interop`` moves them
as a numpy ``uint32`` view). Two consequences: ``>>`` on int32 is an
arithmetic shift, which still gives bit ``b`` as ``(w >> b) & 1``; and
torch has no popcount, so :func:`popcount` runs a SWAR count in int64 on
the zero-extended words.

The lane view (the second half) is the transpose: one word per NODE whose
bit ``L`` is message lane ``L``'s predicate, ``B`` messages stacked as
``ceil(B / 32)`` such vectors (``i32[W, N_pad]``, lane ``b = 32 w + L``)
— the carry layout of the batched message plane
(``models/messagebatch.py``). Every shift there is masked, since ``>>``
on int32 fills with the sign bit.
"""

from __future__ import annotations

import torch

WORD = 32  #: bits per packed word

_WEIGHTS = [1 << b for b in range(WORD)]


def n_words(n_bits: int) -> int:
    """Words needed to hold ``n_bits`` predicates."""
    return (n_bits + WORD - 1) // WORD


def _to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` to int32 with the same low 32 bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """``bool[n] -> i32[ceil(n / 32)]``; a ragged tail packs as zeros."""
    pad = -bits.shape[0] % WORD
    if pad:
        bits = torch.cat([bits, bits.new_zeros(pad)])
    weights = torch.tensor(_WEIGHTS, dtype=torch.int64, device=bits.device)
    lanes = bits.reshape(-1, WORD).to(torch.int64)
    return _to_i32((lanes * weights).sum(dim=1))


def unpack_bits(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """``i32[W] -> bool[n_bits]``, the inverse of :func:`pack_bits`."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    lanes = (words[:, None] >> shifts) & 1
    return lanes.reshape(-1)[:n_bits].to(torch.bool)


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each word (i64, same shape): a SWAR count on the
    zero-extended words."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits over the whole bitset (i32 scalar)."""
    return popcount_words(words).sum().to(torch.int32)


def test_bits(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """bool of bit ``idx[i]`` for each index (indices in range)."""
    return ((words[idx >> 5] >> (idx & 31)) & 1).to(torch.bool)


def set_bits(words: torch.Tensor, idx: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """The bitset with bit ``idx[i]`` set wherever ``valid[i]``
    (duplicates are fine), through a bool scatter and a repack."""
    n = words.shape[0] * WORD
    hit = torch.zeros(n + 1, dtype=torch.bool, device=words.device)
    hit[torch.where(valid, idx, n).long()] = True
    return words | pack_bits(hit[:n])


# --------------------------------------------------------------- lane algebra


def expand_lanes(lanes: torch.Tensor) -> torch.Tensor:
    """``i32[...] -> bool[..., 32]``: bit ``L`` of each word becomes lane
    column ``L``."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=lanes.device)
    return ((lanes[..., None] >> shifts) & 1).to(torch.bool)


def collapse_lanes(bits: torch.Tensor) -> torch.Tensor:
    """``bool[..., 32] -> i32[...]``, the inverse of :func:`expand_lanes`.
    Lane 31 weighs ``2**31``, so the sum is taken in int64 and wrapped."""
    weights = torch.tensor(_WEIGHTS, dtype=torch.int64, device=bits.device)
    return _to_i32((bits.to(torch.int64) * weights).sum(dim=-1))


#: (shift, mask) passes of the 32x32 bit-matrix transpose (Hacker's
#: Delight 7-3), the reference's schedule. Each mask clears the top
#: ``shift`` bits, which is what makes the arithmetic ``>>`` of int32 act
#: as the reference's logical shift of uint32.
_TRANSPOSE_STEPS = (
    (16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F),
    (2, 0x33333333), (1, 0x55555555),
)


def transpose_bits32(a: torch.Tensor) -> torch.Tensor:
    """Transpose 32x32 bit blocks, ``i32[..., 32] -> i32[..., 32]``:
    output word ``L``'s bit ``i`` is input word ``31 - i``'s bit
    ``31 - L`` (both axes reversed, as the reference's)."""
    shape = a.shape
    for j, m in _TRANSPOSE_STEPS:
        pairs = a.reshape(*shape[:-1], WORD // (2 * j), 2, j)
        top, bot = pairs[..., 0, :], pairs[..., 1, :]
        t = (top ^ (bot >> j)) & m
        a = torch.stack([top ^ t, bot ^ (t << j)], dim=-2).reshape(shape)
    return a


def lane_counts(lanes: torch.Tensor, weights: torch.Tensor = None
                ) -> torch.Tensor:
    """Per-lane counts over nodes, ``i32[..., N] -> i32[..., 32]``: entry
    ``L`` counts the nodes whose lane-``L`` bit is set (leading axes are
    the words of a batch, as the reference's ``vmap``). With ``weights``
    (``i32[N]``) each set bit adds its node's weight instead of 1 — that
    form expands the ``[N, 32]`` bit planes, so keep it out of round
    loops; the unweighted form rides :func:`transpose_bits32` and a
    popcount."""
    if weights is not None:
        planes = expand_lanes(lanes).to(torch.int64)
        return (planes * weights.to(torch.int64)[:, None]).sum(
            dim=-2).to(torch.int32)
    n = lanes.shape[-1]
    if n % WORD:  # whole 32-word blocks; zero words count nothing
        lanes = torch.nn.functional.pad(lanes, (0, WORD - n % WORD))
    blocks = transpose_bits32(lanes.reshape(*lanes.shape[:-1], -1, WORD))
    counts = popcount_words(blocks).sum(dim=-2)
    return counts.flip(-1).to(torch.int32)  # the lane axis lands reversed


def _segmented_or(words: torch.Tensor, seg: torch.Tensor,
                 span: int) -> torch.Tensor:
    """Inclusive OR scan of ``words`` (``i32[..., S]``) within runs of
    equal ``seg`` (``[S]``, sorted): position ``i`` ends up holding the OR
    of its run up to ``i``, provided no run is longer than ``span``
    (``ceil(log2(span))`` doubling passes, word-level, no bit planes).
    This is the port's OR-reduction over receiver-sorted slots: torch has
    no bitwise-OR scatter or segment reduction."""
    s, span = 1, min(span, seg.shape[0])
    while s < span:
        same = seg[s:] == seg[:-s]
        head, tail = words[..., :s], words[..., s:]
        words = torch.cat(
            [head, torch.where(same, tail | words[..., :-s], tail)], dim=-1)
        s *= 2
    return words


def _segment_ends(seg: torch.Tensor, n: int):
    """``(last, present)`` for ids ``0..n-1`` over sorted ``seg``: the
    position of each id's last slot, and whether it has any."""
    ids = torch.arange(n, dtype=seg.dtype, device=seg.device)
    last = torch.searchsorted(seg, ids, right=True) - 1
    present = last >= 0
    last = last.clamp_min(0)
    return last, present & (seg[last] == ids)


def or_sorted_lanes(n: int, seg: torch.Tensor, words: torch.Tensor,
                    span: int) -> torch.Tensor:
    """Per-id OR of lane words over slots sorted by id: ``words``
    ``i32[..., S]`` at ids ``seg`` (``[S]``, sorted, no run longer than
    ``span``) to ``i32[..., n]``, 0 where an id has no slot; ids outside
    ``[0, n)`` are not read."""
    scanned = _segmented_or(words, seg, span)
    last, present = _segment_ends(seg, n)
    return torch.where(present, scanned[..., last], 0)


def or_scatter_lanes(n: int, idx: torch.Tensor, vals: torch.Tensor,
                     span: int = None) -> torch.Tensor:
    """Lane-wide scatter-OR, ``i32[n]`` with ``out[idx[i]] |= vals[i]``
    (``vals`` may carry leading word axes: ``[..., S]``). Indices outside
    ``[0, n)`` drop — point invalid slots at ``n``, as the reference's
    ``mode="drop"`` callers do. No index is hit by more than one write:
    the slots are sorted by index once and OR-reduced within each index's
    run (:func:`or_sorted_lanes`; ``span`` bounds a run, default the slot
    count). So slots aimed at one dropped index cost no atomics on one
    address, as the reference's bit-plane ``.at[].max`` would on the
    card."""
    order = torch.argsort(idx, stable=True)
    return or_sorted_lanes(n, idx[order], vals[..., order],
                           idx.shape[0] if span is None else span)
