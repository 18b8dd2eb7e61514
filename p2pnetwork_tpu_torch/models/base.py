"""The protocol seam shared by the port's models (torch counterpart of
``p2pnetwork_tpu/models/base.py``).

A protocol is a dataclass of static hyperparameters with
``init(graph, key) -> state`` and ``step(graph, state, key) -> (state,
stats)``, where ``stats`` maps names to 0-d device tensors and ``key`` is
a host key of ``prng.py`` (numpy ``uint32[2]``). ``STATS`` names the
stats ``step`` returns, so the engine knows them before any round runs.
Floods take their key and ignore it, as the reference's do.
:class:`Protocol` is that interface as a structural type.
"""

from __future__ import annotations

from typing import Any, Dict
from typing import Protocol as TypingProtocol
from typing import Tuple

import numpy as np
import torch

from p2pnetwork_tpu_torch import prng
from p2pnetwork_tpu_torch.parallel.mesh import assemble
from p2pnetwork_tpu_torch.sim.graph import Graph, part_of

State = Any
Stats = Dict[str, torch.Tensor]


class Protocol(TypingProtocol):
    """Structural interface every sim protocol implements (the
    reference's ``models/base.py::Protocol``; ``key`` a host key of
    ``prng.py``)."""

    def init(self, graph: Graph, key: np.ndarray) -> State: ...

    def step(self, graph: Graph, state: State,
             key: np.ndarray) -> Tuple[State, Stats]: ...


def draw_neighbor_slot(graph: Graph, key, weights=None):
    """One uniform draw per node over its valid neighbor-table slots: the
    k-th-set-bit sampler of the reference (``randint`` over ``[0, 2**31 -
    1)``, taken mod the row's valid count, then the slot whose running
    count of valid slots reaches it). After failures the table is
    re-masked, so the draw stays uniform over live neighbors; runtime
    links are not candidates.

    Returns ``(slot, partner, has_neighbor)``: the drawn column (i32), the
    neighbor id it holds (row 0's entry where no valid slot exists), and
    whether the row had a valid slot. Callers gate on ``has_neighbor``.
    With ``weights`` (an f32 table aligned with the neighbor table, such
    as ``neighbor_weight``) a fourth value is the drawn slot's weight.

    On a rank's part (``sim/graph.py`` ``GraphPart``) the owned rows draw
    from the same ``N_pad`` counters as the whole graph's and the three
    (four) are assembled in one exchange (``parallel/mesh.py``), the
    weight as its f32 bits."""
    part = part_of(graph)
    mask = graph.neighbor_mask
    count = mask.sum(dim=1, dtype=torch.int32)
    u = prng.randint(key, (graph.n_nodes_padded,), 0, 2**31 - 1,
                     device=graph.device)
    if part is not None:  # the owned rows' counters
        u = u[part.lo:part.hi]
    k = u % count.clamp_min(1)
    csum = mask.cumsum(dim=1, dtype=torch.int32)
    hit = (csum == (k + 1)[:, None]) & mask
    # argmax returns the first maximum, and 0 on an all-false row, as
    # jnp.argmax does.
    slot = hit.to(torch.uint8).argmax(dim=1)
    partner = graph.neighbors.gather(1, slot[:, None])[:, 0]
    out = [slot.to(torch.int32), partner, count > 0]
    if weights is not None:
        out.append(weights.gather(1, slot[:, None])[:, 0])
    if part is not None:
        cols = [out[0], out[1], out[2].to(torch.int32)]
        if weights is not None:
            cols.append(out[3].view(torch.int32))
        whole = assemble(part, torch.stack(cols))
        out = [whole[0], whole[1], whole[2] > 0]
        if weights is not None:
            out.append(whole[3].contiguous().view(torch.float32))
    return tuple(out)


def validate_source(graph: Graph, source: int) -> None:
    """Reject a source index outside the padded id space. Ids in
    ``[n_nodes, n_nodes_padded)`` are allowed; dead ids are zeroed by the
    ``& node_mask`` every seed applies."""
    if not 0 <= source < graph.n_nodes_padded:
        raise ValueError(
            f"source {source} out of range for padded id space "
            f"[0, {graph.n_nodes_padded})"
        )


def source_seed(graph: Graph, source) -> torch.Tensor:
    """bool[N_pad]: ``source`` alone, masked by liveness (all False when
    the source is dead) — the seed of the single-source protocols."""
    seed = torch.zeros(graph.n_nodes_padded, dtype=torch.bool,
                       device=graph.device)
    seed[source] = True
    return seed & graph.node_mask
