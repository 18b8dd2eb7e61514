"""The batched planes' one-transfer run summaries (the port's copy of
``p2pnetwork_tpu/utils/accum.py``'s batch and query layouts), and
:func:`ordered_sum`, the f32 1-D sum in the reference's order of adds.

A run summary is one ``i32`` vector, so the host gets a whole B-message
or K-query result in one device->host transfer, in the reference's
layout: a head ``[rounds, active_lanes, completed, hi, lo-bits,
occupancy-bits]``, the ``done`` lane flags packed as words, each lane's
applied-round count and, for queries, each lane's answer. The port counts
messages in int64 (the reference in a two-limb ``(hi: i32, lo: u32)``
counter); the head splits the int64 into the same two limbs, so the
unpackers below are the reference's, byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch

from p2pnetwork_tpu_torch.ops import rowsum

#: Fixed slots of the batch summary ahead of the per-lane vectors.
_BATCH_HEAD = 6


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """The 0-d sum of a 1-D tensor in XLA's CPU order
    (``ops/rowsum.py::row_sum``)."""
    return rowsum.row_sum(x.reshape(1, -1))[0]


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(1).to(torch.int32)


def pack_batch_summary(rounds, active_lanes, completed,
                       messages: torch.Tensor, occ_mean: torch.Tensor,
                       done_words: torch.Tensor,
                       lane_rounds: torch.Tensor) -> torch.Tensor:
    """``i32[6 + W + B]``: the head (``messages`` an int64 scalar,
    ``occ_mean`` an f32 scalar, both bit-cast), then ``done_words``
    (``i32[W]``, ``ops/bitset.py`` lane order) and ``lane_rounds``."""
    lo = messages & 0xFFFFFFFF
    head = torch.cat([
        _i32(rounds), _i32(active_lanes), _i32(completed),
        _i32(messages >> 32),
        _i32(torch.where(lo >= 2**31, lo - 2**32, lo)),
        occ_mean.to(torch.float32).reshape(1).view(torch.int32)])
    return torch.cat([head, done_words.reshape(-1).to(torch.int32),
                      lane_rounds.to(torch.int32)])


def pack_query_summary(rounds, active_lanes, completed, messages, occ_mean,
                       done_words, lane_rounds, lane_values: torch.Tensor, *,
                       values_float: bool) -> torch.Tensor:
    """``i32[6 + W + K + K]``: :func:`pack_batch_summary` plus each lane's
    answer, f32 bit-cast (``values_float``) or raw i32 (DHT cursors)."""
    vals = (lane_values.to(torch.float32).view(torch.int32) if values_float
            else lane_values.to(torch.int32))
    return torch.cat([
        pack_batch_summary(rounds, active_lanes, completed, messages,
                           occ_mean, done_words, lane_rounds),
        vals.reshape(-1)])


def unpack_batch_summary(packed, n_words: int) -> dict:
    """Host-side inverse of :func:`pack_batch_summary`: ``rounds`` /
    ``active_lanes`` / ``completed`` / ``messages`` (exact int) /
    ``occupancy_mean`` and the per-lane ``lane_done`` (bool[B]) and
    ``lane_rounds`` (i32[B])."""
    arr = np.asarray(packed)
    messages = (int(arr[3]) << 32) + int(arr[4:5].view(np.uint32)[0])
    done_words = arr[_BATCH_HEAD:_BATCH_HEAD + n_words].view(np.uint32)
    bits = (done_words[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    return {
        "rounds": int(arr[0]),
        "active_lanes": int(arr[1]),
        "completed": int(arr[2]),
        "messages": messages,
        "occupancy_mean": float(arr[5:6].view(np.float32)[0]),
        "lane_done": bits.reshape(-1).astype(bool),
        "lane_rounds": arr[_BATCH_HEAD + n_words:].astype(np.int32),
    }


def unpack_query_summary(packed, capacity: int, *,
                         values_float: bool) -> dict:
    """Host-side inverse of :func:`pack_query_summary`; ``lane_done``
    trimmed to ``capacity``, ``lane_values`` f32 or i32."""
    arr = np.asarray(packed)
    capacity = int(capacity)
    n_words = -(-capacity // 32)
    core_len = _BATCH_HEAD + n_words + capacity
    out = unpack_batch_summary(arr[:core_len], n_words)
    out["lane_done"] = out["lane_done"][:capacity]
    vals = arr[core_len:]
    out["lane_values"] = (vals.view(np.float32) if values_float
                          else vals.astype(np.int32))
    return out
