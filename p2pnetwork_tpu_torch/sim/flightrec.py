"""Flight recorder: a per-round ring of records kept on the device (torch
counterpart of ``p2pnetwork_tpu/sim/flightrec.py``).

The run-to-* loops hand back per-run aggregates only. With a
:class:`FlightRecorder` they also keep a bounded ``f32[capacity, 7]``
ring of per-round rows on the graph's device: one row write a round,
with no host read and no host -> device copy (the loops hand in device
tensors made once a run), and one transfer at the end of the run,
counted in ``_device.SYNCS``. A run longer than ``capacity`` keeps its
last ``capacity`` rows (:func:`trim` puts them oldest first). The
recorder only writes its own ring, so a run's results are bit-identical
with it and without it.

Columns (``REC_COLS``), one row per applied round:

- ``round``: the 1-based round of this call;
- ``occupancy``: frontier occupancy (the batch loop: the union
  frontier's; the query loop: running lanes over capacity);
- ``new``: messages sent this round;
- ``total``: the running message total as one f32 (exact only below
  2^24; the summary keeps the exact count);
- ``coverage``: the loop's coverage numerator in its native form: the
  tracked stat of the single-message loops (a coverage fraction for the
  floods), the masked seen-count total of the batch loop, the finished
  lanes of the query loop;
- ``active_lanes``: 1 for a single-message loop, the running lanes of
  the batched loops;
- ``ici_bytes``: the loop's interconnect bytes a round, 0 on one card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from p2pnetwork_tpu_torch import _device

__all__ = ["REC_COLS", "FlightRecorder", "FlightRecord", "write_row",
           "write_rows", "total_f32", "limbs", "trim"]

#: Column order of one per-round record.
REC_COLS = ("round", "occupancy", "new", "total", "coverage",
            "active_lanes", "ici_bytes")


@dataclasses.dataclass(frozen=True)
class FlightRecorder:
    """The recorder's configuration: ``capacity`` bounds the ring (a
    longer run keeps its last ``capacity`` rounds; ``FlightRecord.dropped``
    says how many were overwritten)."""

    capacity: int = 256

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"flight-recorder capacity must be >= 1, got "
                             f"{self.capacity}")

    def init(self, device) -> torch.Tensor:
        """A fresh zeroed ring on ``device``."""
        return torch.zeros((self.capacity, len(REC_COLS)),
                           dtype=torch.float32, device=device)


def _f32(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32).reshape(())
    # A host number becomes a fill on the device: a host -> device copy
    # would synchronise the stream.
    return torch.full((), float(v), dtype=torch.float32, device=device)


def write_row(ring: torch.Tensor, round_index: int, *, occupancy, new,
              total, coverage, active_lanes, ici_bytes,
              live=None) -> torch.Tensor:
    """Write one record at ``round_index % capacity`` in place and return
    ``ring``. ``round_index`` counts the rounds executed before this one;
    the row's ``round`` column is 1-based. Values (device tensors or host
    numbers) are cast to f32. No call reads the device or copies to it,
    so a row costs no sync. With ``live`` (a 0-d bool tensor) the write
    happens only where it holds: a frozen sub-step of a super-step writes
    nothing."""
    dev = ring.device
    slot = int(round_index) % ring.shape[0]
    row = torch.stack([
        _f32(int(round_index) + 1, dev), _f32(occupancy, dev),
        _f32(new, dev), _f32(total, dev), _f32(coverage, dev),
        _f32(active_lanes, dev), _f32(ici_bytes, dev)])
    if live is not None:
        row = torch.where(live, row, ring[slot])
    ring[slot] = row
    return ring


def write_rows(ring: torch.Tensor, round0: int, *, occupancy, new, total,
               coverage, active_lanes, ici_bytes) -> torch.Tensor:
    """Write the rows of rounds ``round0 .. round0 + R - 1`` at once, in
    place, and return ``ring``: each column a ``[R]`` tensor or a host
    number for every row, as :func:`write_row` would write them one by
    one (a run longer than the capacity keeps its last rows). A loop that
    learns a column only at the end of its run (a ring split over ranks
    sums its rows' numerators in one exchange a run) writes its rows
    here, in one indexed store."""
    dev, cap = ring.device, ring.shape[0]
    cols = (occupancy, new, total, coverage, active_lanes, ici_bytes)
    n = next(int(c.numel()) for c in cols if isinstance(c, torch.Tensor))
    keep = min(n, cap)
    first = int(round0) + n - keep
    rounds = torch.arange(first + 1, first + keep + 1, dtype=torch.float32,
                          device=dev)

    def col(v):
        if isinstance(v, torch.Tensor):
            return v.to(torch.float32).reshape(-1)[n - keep:]
        return torch.full((keep,), float(v), dtype=torch.float32, device=dev)

    rows = torch.stack([rounds] + [col(c) for c in cols], dim=1)
    slots = torch.arange(first, first + keep, device=dev) % cap
    ring[slots] = rows
    return ring


def total_f32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The two-limb message total as one f32, ``f32(hi) * 2^32 +
    f32(lo)`` (the ``total`` column's view). The port counts in int64:
    split it with :func:`limbs` first."""
    return hi.to(torch.float32) * float(2.0 ** 32) + lo.to(torch.float32)


def limbs(messages: torch.Tensor):
    """``(hi, lo)`` of an exact int64 count: the reference's two-limb
    accumulator, ``lo`` its low 32 bits as an unsigned value."""
    return messages >> 32, messages & 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class FlightRecord:
    """One run's ring on the host: rows oldest first, trimmed to the
    rounds executed; ``dropped`` counts the rows overwritten."""

    rows: np.ndarray  # f32[min(rounds, capacity), len(REC_COLS)]
    rounds: int
    capacity: int
    dropped: int

    @property
    def columns(self):
        return REC_COLS

    def column(self, name: str) -> np.ndarray:
        return self.rows[:, REC_COLS.index(name)]

    def as_dict(self) -> dict:
        """JSON-able form: the columns by name plus the wrap
        accounting."""
        return {"rounds": self.rounds, "capacity": self.capacity,
                "dropped": self.dropped,
                "columns": {name: self.column(name).tolist()
                            for name in REC_COLS}}


def trim(ring, rounds: int) -> FlightRecord:
    """The ring (a host array or a tensor) oldest first, trimmed to the
    rounds executed."""
    if isinstance(ring, torch.Tensor):
        with _device.counted_syncs():
            ring = ring.cpu().numpy()
    ring = np.asarray(ring)
    capacity, rounds = int(ring.shape[0]), int(rounds)
    if rounds <= capacity:
        rows, dropped = np.array(ring[:rounds]), 0
    else:
        rows = np.roll(ring, -(rounds % capacity), axis=0)
        dropped = rounds - capacity
    return FlightRecord(rows=rows, rounds=rounds, capacity=capacity,
                        dropped=dropped)
