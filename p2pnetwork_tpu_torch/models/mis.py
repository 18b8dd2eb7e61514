"""Luby's maximal independent set (torch counterpart of
``p2pnetwork_tpu/models/mis.py``).

Each round every undecided node draws a priority (``prng.randint`` over
``[0, 2**31 - 1)``, the threefry kernel's bits entry on the card); a node
whose draw strictly beats every undecided neighbor's (one
``propagate_max``) joins the set, and its neighbors leave contention (one
``propagate_or``: B1's OR entry under ``or_method`` ``pallas``/
``hybrid``). Equal draws leave both undecided for the round. Run with
``engine.run_until_converged(stat="undecided", threshold=1)``; the set is
independent on the symmetric graphs the builders make.
"""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch import prng
from p2pnetwork_tpu_torch.ops import segment
from p2pnetwork_tpu_torch.sim.graph import Graph


@dataclasses.dataclass(frozen=True)
class LubyMISState:
    in_mis: torch.Tensor  # bool[N_pad] — decided: member of the set
    undecided: torch.Tensor  # bool[N_pad] — still in contention


@dataclasses.dataclass(frozen=True)
class LubyMIS:
    """Randomized MIS; ``method`` is ``propagate_max``'s lowering,
    ``or_method`` the announcement's (``propagate_or``'s)."""

    method: str = "auto"
    or_method: str = "auto"

    STATS = ("messages", "undecided", "mis_size")
    RUNS_ON_PART = True

    def init(self, graph: Graph, key) -> LubyMISState:
        return LubyMISState(in_mis=torch.zeros_like(graph.node_mask),
                            undecided=graph.node_mask)

    def step(self, graph: Graph, state: LubyMISState, key):
        undecided = state.undecided
        draws = prng.randint(key, undecided.shape, 0, 2**31 - 1,
                             device=graph.device)
        # Decided and dead nodes carry the identity: they outrank nobody.
        prio = torch.where(undecided, draws, segment.neutral_min(draws.dtype))
        heard = segment.propagate_max(graph, prio, self.method)
        join = undecided & (prio > heard)
        lost = segment.propagate_or(graph, join, self.or_method)
        in_mis = state.in_mis | join
        undecided = undecided & ~join & ~lost
        # Every contender sent its draw, every winner its announcement.
        msgs = (segment.frontier_messages(graph, state.undecided)
                + segment.frontier_messages(graph, join))
        return LubyMISState(in_mis=in_mis, undecided=undecided), {
            "messages": msgs, "undecided": undecided.sum(),
            "mis_size": in_mis.sum()}
