"""Routing of the ring's halo-exchange backend (torch counterpart of
``resolve_comm`` in ``p2pnetwork_tpu/parallel/auto.py``).

The port keeps the reference's backend names so that call sites carry
over, with these meanings:

- ``"pallas"``: the hand-written CUDA ring kernels (``ops/ring.py``): the
  hop (B2) and, on the MXU bucket layout, the hop fused with the segment
  sum (B3). On a CPU tensor their plain versions run.
- ``"ppermute"``: the plain torch hop (``torch.roll`` of the stacked
  shards), each bucket applied apart.
- ``"auto"``: ``"pallas"`` on a CUDA device, ``"ppermute"`` on the CPU.
"""

from __future__ import annotations

import torch

COMM_BACKENDS = ("ppermute", "pallas")


def resolve_comm(comm: str = "auto", device=None) -> str:
    """The backend ``comm`` names on ``device``; raises on an unknown
    name."""
    if comm == "auto":
        return "pallas" if torch.device(device or "cpu").type == "cuda" \
            else "ppermute"
    if comm not in COMM_BACKENDS:
        raise ValueError(
            f"comm must be one of {COMM_BACKENDS + ('auto',)}, got {comm!r}")
    return comm
