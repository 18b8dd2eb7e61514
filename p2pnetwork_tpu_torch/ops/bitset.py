"""Bit-packed node predicates, 32 nodes per word (torch counterpart of the
node-packing half of ``p2pnetwork_tpu/ops/bitset.py``).

Bit ``i`` of word ``w`` is node ``32 * w + i`` (LSB first). The reference's
words are ``uint32``; torch has no unsigned 32-bit arithmetic, so here
they are ``int32`` holding the same bit patterns (``interop`` moves them
as a numpy ``uint32`` view). Two consequences: ``>>`` on int32 is an
arithmetic shift, which still gives bit ``b`` as ``(w >> b) & 1``; and
torch has no popcount, so :func:`popcount` runs a SWAR count in int64 on
the zero-extended words. The per-message lane view of the reference
(``expand_lanes`` and the rest) waits for the batched message plane.
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


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits over the whole bitset (i32 scalar)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return x.sum().to(torch.int32)


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
