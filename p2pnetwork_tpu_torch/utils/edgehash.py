"""Stateless per-(walker, edge) uniforms (torch counterpart of
``p2pnetwork_tpu/utils/edgehash.py``).

The walker cohort (``models/walk.py``) draws one uniform per candidate
edge per round, keyed by the edge's identity (round key, walker, sender,
receiver) rather than its array slot, so any party that can name the edge
computes the same number. The mix is a boost-style ``hash_combine`` over
the inputs followed by murmur3's ``fmix32`` finalizer, on u32 words.

Torch has no wrapping u32 arithmetic (and no unsigned multiply on CUDA),
so the words are held in int64 as values in ``[0, 2**32)`` and every
``*``, ``+`` and ``<<`` is masked back to 32 bits; ``>>`` of a masked
word is the logical shift. The top 24 bits, as f32 times ``2**-24``, are
the same numbers as the reference's on every device.
"""

from __future__ import annotations

import torch

from p2pnetwork_tpu_torch import prng

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _u32(v, device) -> torch.Tensor:
    """An int tensor (or number) as int64 words in ``[0, 2**32)``: an
    int32 input is reinterpreted as uint32, as the reference's
    ``astype(uint32)`` does."""
    return torch.as_tensor(v, device=device).to(torch.int64) & _M32


def edge_uniform(key, walker, sender, receiver) -> torch.Tensor:
    """f32 uniforms in [0, 1), one per broadcast element of ``(walker,
    sender, receiver)`` under the host ``key`` (``prng.py``).

    Inputs broadcast like torch operands (``[W, 1]`` against ``[W,
    slots]`` is the typical shape); negative int32 inputs hash as their
    u32 patterns."""
    kd = [int(w) for w in prng.key_data(key)]
    dev = receiver.device if isinstance(receiver, torch.Tensor) else None
    # The key's two words combine on the host, in Python ints: no device
    # work and no host->device copy for them.
    h = kd[0] ^ _GOLDEN
    for v in (kd[1], walker, sender, receiver):
        v = v & _M32 if isinstance(v, int) else _u32(v, dev)
        # boost::hash_combine: h ^ (v + golden + (h << 6) + (h >> 2)).
        h = h ^ ((v + _GOLDEN + ((h << 6) & _M32) + (h >> 2)) & _M32)
    # murmur3 fmix32.
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
