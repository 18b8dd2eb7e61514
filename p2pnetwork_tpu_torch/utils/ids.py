"""Node identity generation.

Parity with the reference scheme [ref: p2pnetwork/node.py:85-90]:
sha512 over host + port + a random integer in [1, 99999999], hex-encoded.
"""

from __future__ import annotations

import hashlib
import random


def generate_id(host: str, port: int, rng: random.Random | None = None) -> str:
    """Generate a unique hex node id [ref: node.py:85-90]."""
    r = rng if rng is not None else random
    digest = hashlib.sha512()
    digest.update((host + str(port) + str(r.randint(1, 99999999))).encode("ascii"))
    return digest.hexdigest()
