"""Max and min reductions with XLA's semantics, for ``propagate_max`` and
``propagate_min_plus`` (port-only helpers; the reference calls
``jax.ops.segment_max``/``segment_min``, ``jnp.max``/``min``,
``.at[].max``/``min`` and ``jnp.maximum``/``minimum``).

XLA's max and min, on the CPU as on the TPU, order ``-0.0`` below
``+0.0`` and let a NaN term win, whatever the order of the terms. Torch's
``scatter_reduce_``/``amax``/``maximum`` keep whichever zero they met
first, and their float atomics on CUDA promise no NaN rule. So f32 values
are reduced as ordered i32 keys: the bits of a finite or infinite value,
negatives with their magnitude bits flipped, compare as the values do
with ``-0.0 < +0.0``; a NaN becomes the key that wins (the largest for
max, the smallest for min) and comes back as torch's NaN (its sign and
payload are not kept). Integer signals are reduced as they are: their
max and min have no such cases. Every reduction is then an integer
scatter or row reduction, exact and independent of the order of its
terms on any device. The protocols reduce i32 and f32 only, the types
the reference's run in; other floats are refused.
"""

from __future__ import annotations

import torch

_I32 = torch.iinfo(torch.int32)
#: The key of f32 ``+inf`` (its bits); ``-inf``'s is ``-_INF_KEY - 1``,
#: as ``encode(-x) = -encode(x) - 1`` for every non-NaN ``x``.
_INF_KEY = 0x7F800000


def _nan_key(largest: bool) -> int:
    return _I32.max if largest else _I32.min


def _check_float(dtype) -> None:
    if dtype.is_floating_point and dtype != torch.float32:
        raise TypeError(f"max/min aggregation takes f32 or integer signals, "
                        f"got {dtype}")


def encode(x: torch.Tensor, largest: bool) -> torch.Tensor:
    """``x`` as keys ordered as XLA's max (``largest``) or min orders
    ``x``; integer tensors are their own keys."""
    _check_float(x.dtype)
    if not x.dtype.is_floating_point:
        return x
    bits = x.view(torch.int32)
    key = torch.where(bits < 0, bits ^ _I32.max, bits)
    return torch.where(torch.isnan(x), _nan_key(largest), key)


def decode(key: torch.Tensor, dtype, largest: bool) -> torch.Tensor:
    """The values of :func:`encode`'s keys."""
    if not dtype.is_floating_point:
        return key
    bits = torch.where(key < 0, key ^ _I32.max, key)
    return torch.where(key == _nan_key(largest), torch.nan,
                       bits.view(torch.float32))


def identity(dtype, largest: bool) -> int:
    """The reduction's identity as a key: the key of ``-inf``/``+inf``
    (f32) or the integer type's min/max."""
    _check_float(dtype)
    if dtype.is_floating_point:
        return -_INF_KEY - 1 if largest else _INF_KEY
    info = torch.iinfo(dtype)
    return info.min if largest else info.max


def scatter(keys: torch.Tensor, index: torch.Tensor, n: int, init: int,
            largest: bool) -> torch.Tensor:
    """Per-segment max/min of ``keys`` into ``n`` slots, ``init`` (the
    :func:`identity`) where no key lands: ``jax.ops.segment_max``/
    ``segment_min`` on keys."""
    out = torch.full((n,), init, dtype=keys.dtype, device=keys.device)
    return out.scatter_reduce_(0, index.long(), keys,
                               reduce="amax" if largest else "amin")


def rows(keys: torch.Tensor, largest: bool) -> torch.Tensor:
    """Max/min of each row of a ``[R, W]`` key matrix."""
    return keys.amax(dim=1) if largest else keys.amin(dim=1)


def scatter_spread(keys: torch.Tensor, index: torch.Tensor,
                   valid: torch.Tensor, n: int, init: int,
                   largest: bool) -> torch.Tensor:
    """:func:`scatter` of the ``valid`` keys only: the reference's
    ``.at[where(valid, index, n)].min(..., mode="drop")``. The other slots
    add ``init`` (which changes nothing) at a slot of their own position
    rather than at one drop address, where millions of atomics would
    serialize on the card."""
    spread = torch.arange(keys.shape[0], device=keys.device) % n
    return scatter(torch.where(valid, keys, init),
                   torch.where(valid, index.long(), spread), n, init,
                   largest)
