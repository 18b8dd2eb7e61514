"""Flooding broadcast with seen-set dedup (torch counterpart of
``p2pnetwork_tpu/models/flood.py``): one round of the whole population is
one masked neighbor-OR (``ops/segment.py``). ``bitset=True`` carries the
seen/frontier predicates packed 32 nodes per word (``ops/bitset.py``);
the round's set algebra and counts then run on words, bit-identical to
the bool state."""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch.models import base
from p2pnetwork_tpu_torch.ops import bitset, frontier, segment
from p2pnetwork_tpu_torch.sim.graph import Graph


@dataclasses.dataclass(frozen=True)
class FloodState:
    """Who has the message, and who got it last round."""

    seen: torch.Tensor  # bool[N_pad]
    frontier: torch.Tensor  # bool[N_pad]


@dataclasses.dataclass(frozen=True)
class FloodBitState:
    """``FloodState`` packed 32 nodes per word (``ops/bitset.py``)."""

    #: Fields holding the reference's ``uint32`` words as int32 with the
    #: same bits: checkpoints write them as ``uint32`` (``sim/checkpoint.py``).
    U32_WORDS = ("seen", "frontier")

    seen: torch.Tensor  # i32[N_pad // 32], u32 bit patterns
    frontier: torch.Tensor  # i32[N_pad // 32]


def _over_live(count: torch.Tensor, graph: Graph) -> torch.Tensor:
    """``count`` over the live node count, in f32 (the reference's
    division)."""
    n_real = graph.node_mask.sum().clamp_min(1)
    return count.to(torch.float32) / n_real.to(torch.float32)


def live_coverage(graph: Graph, seen: torch.Tensor) -> torch.Tensor:
    """Fraction of live nodes in ``seen`` (f32 scalar, bool or packed);
    the numerator is masked so dead-but-seen nodes never push it past 1."""
    if seen.dtype == torch.int32:
        return _over_live(
            bitset.popcount(seen & bitset.pack_bits(graph.node_mask)), graph)
    return _over_live((seen & graph.node_mask).sum(), graph)


@dataclasses.dataclass(frozen=True)
class Flood:
    """Single-source flood. ``source`` is the seed node, ``method`` the
    aggregation lowering (ops/segment.py), ``bitset`` packs the state
    (:class:`FloodBitState`), ``frontier_crossover`` overrides
    ``method="frontier"``'s budget (``ops/frontier.py``)."""

    source: int = 0
    method: str = "auto"
    bitset: bool = False
    frontier_crossover: object = None

    STATS = ("messages", "coverage", "frontier", "frontier_occupancy")
    RUNS_ON_PART = True

    def init(self, graph: Graph, key):
        base.validate_source(graph, self.source)
        seed = base.source_seed(graph, self.source)
        if self.bitset:
            packed = bitset.pack_bits(seed)
            return FloodBitState(seen=packed, frontier=packed)
        return FloodState(seen=seed, frontier=seed)

    def coverage(self, graph: Graph, state) -> torch.Tensor:
        return live_coverage(graph, state.seen)

    def _propagate(self, graph: Graph, frontier_: torch.Tensor):
        return segment.propagate_or(graph, frontier_, self.method,
                                    frontier_crossover=self.frontier_crossover)

    def step(self, graph: Graph, state, key):
        """One synchronous round: frontier nodes broadcast; receivers that
        had not seen the message form the next frontier. Floods draw no
        random numbers: ``key`` is taken and ignored, as the reference's
        floods ignore theirs."""
        if isinstance(state, FloodBitState):
            return self._step_bits(graph, state)
        delivered = self._propagate(graph, state.frontier)
        new = delivered & ~state.seen & graph.node_mask
        seen = state.seen | new
        stats = {
            "messages": segment.frontier_messages(graph, state.frontier),
            "coverage": live_coverage(graph, seen),
            "frontier": new.sum(),
            "frontier_occupancy": frontier.occupancy(graph, new),
        }
        return FloodState(seen=seen, frontier=new), stats

    def _step_bits(self, graph: Graph, state: FloodBitState):
        """The packed round: the same per-node logic on words (AND-NOT, OR,
        popcount); only the propagate's input is unpacked."""
        frontier_ = bitset.unpack_bits(state.frontier, graph.n_nodes_padded)
        delivered = self._propagate(graph, frontier_)
        node_bits = bitset.pack_bits(graph.node_mask)
        new = bitset.pack_bits(delivered) & ~state.seen & node_bits
        seen = state.seen | new
        n_new = bitset.popcount(new)
        stats = {
            "messages": segment.frontier_messages(graph, frontier_),
            "coverage": _over_live(bitset.popcount(seen & node_bits), graph),
            # i64, as the dense round's count: the two carries give one
            # stats signature.
            "frontier": n_new.to(torch.int64),
            "frontier_occupancy": _over_live(n_new, graph),
        }
        return FloodBitState(seen=seen, frontier=new), stats
