"""Device resolution and host-sync accounting for the port.

Every entry point takes ``device=None``. ``None`` means the CUDA card: the
port is written for it, and a silent CPU fallback would turn a missing
CUDA install into a run that is right but a thousand times slower. The CPU runs
only when asked for by name (``device="cpu"``), as the tests do.

``SYNCS`` counts the host reads of device values that the round loops make
(the run-to-coverage exit flag, the adaptive flood's sparse/dense branch).
Each is a device->host synchronisation on CUDA; ``chip_smoke.py`` prints
the count per run. A counted read is made under :func:`counted_syncs`,
which adds to ``SYNCS`` and declares the read to graftaudit's census
(``analysis/ir/census.py``), so the audit tells a counted exit read from
an unplanned one.

:func:`kernel` marks a hand-written kernel's wrapper: under a census the
wrapper counts as its kernel's launches, whichever twin runs (the CUDA
kernel or, on a CPU tensor, its plain version), and the torch calls of
the plain version are not counted. Without a census it costs one global
read a call.
"""

from __future__ import annotations

import contextlib
import functools

import torch

#: Host reads of device scalars made by the round loops (see module doc).
SYNCS = 0

#: The census recording this process's torch calls
#: (``analysis/ir/census.py``), or None.
CENSUS = None


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


@contextlib.contextmanager
def counted_syncs(n: int = 1):
    """Count ``n`` syncs in ``SYNCS`` for the host reads made in the
    block, and declare those reads to an active census."""
    global SYNCS
    SYNCS += n
    census = CENSUS
    if census is None:
        yield
        return
    with census.declared():
        yield


def host_bool(flag: torch.Tensor) -> bool:
    """Read a 0-d bool tensor on the host, counting the sync."""
    with counted_syncs():
        return bool(flag.item())


def _one_launch(*args, **kwargs) -> int:
    return 1


def kernel(name: str, launches=_one_launch):
    """Decorate the wrapper of the hand-written kernel ``name``.
    ``launches(*args, **kwargs)`` is the number of launches the call
    makes on the card (0 where the wrapper runs no kernel, as a row sum
    of integers)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            census = CENSUS
            if census is None:
                return fn(*args, **kwargs)
            n = launches(*args, **kwargs)
            if not n:
                return fn(*args, **kwargs)
            return census.kernel(name, n, fn, args, kwargs)

        return wrapper

    return deco
