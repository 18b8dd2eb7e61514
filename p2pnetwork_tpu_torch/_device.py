"""Device resolution and host-sync accounting for the port.

Every entry point takes ``device=None``. ``None`` means the CUDA card: the
port is written for it, and a silent CPU fallback would turn a missing
CUDA install into a run that is right but a thousand times slower. The CPU runs
only when asked for by name (``device="cpu"``), as the tests do.

``SYNCS`` counts the host reads of device values that the round loops make
(the run-to-coverage exit flag, the adaptive flood's sparse/dense branch).
Each is a device->host synchronisation on CUDA; ``chip_smoke.py`` prints
the count per run.
"""

from __future__ import annotations

import torch

#: Host reads of device scalars made by the round loops (see module doc).
SYNCS = 0


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and
    not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "p2pnetwork_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU explicitly"
        )
    return dev


def host_bool(flag: torch.Tensor) -> bool:
    """Read a 0-d bool tensor on the host, counting the sync."""
    global SYNCS
    SYNCS += 1
    return bool(flag.item())
