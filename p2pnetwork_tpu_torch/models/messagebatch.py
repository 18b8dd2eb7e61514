"""Batched message plane: B concurrent floods as one lane-packed state
(torch counterpart of ``p2pnetwork_tpu/models/messagebatch.py``).

``seen``/``frontier``/``sent`` are ``i32[W, N_pad]`` words whose bit ``L``
of word ``w`` at node ``v`` is message ``32 w + L``'s predicate
(``ops/bitset.py`` lane algebra; the reference's ``uint32`` bits), and one
round-step (``ops/segment.py`` ``propagate_or_lanes``) advances every
message in flight. Lane by lane the semantics are the single flood's: the
same seed masking, the same ``new = delivered & ~seen & alive`` dedup, the
same masked coverage numerator and round accounting, so each lane's final
``seen`` and round count equal an independent ``Flood`` run's. Completed
lanes freeze: they leave the batch frontier.

Admission is staggered: :meth:`BatchFlood.admit` seeds new messages into
open lanes between engine calls and :meth:`BatchFlood.retire` recycles
them, the seam a serving front-end drives (``serve/service.py``); the
engine side is ``sim/engine.py`` ``run_batch_until_coverage``. With a
tracer installed (``telemetry/spans.py``) they emit the reference's
``lane_submit`` and ``lane_retire`` events.

Per-word send subtotals (``messages_words``) are int64 here; the
reference's are u32 words folded into a two-limb counter, which holds the
same exact total (906,310,616 messages in the bench's B = 1,024 call).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from p2pnetwork_tpu_torch import _device
from p2pnetwork_tpu_torch.models import base
from p2pnetwork_tpu_torch.ops import bitset, frontier, segment
from p2pnetwork_tpu_torch.sim.graph import Graph
from p2pnetwork_tpu_torch.telemetry import spans


class LaneExhausted(ValueError):
    """Admission refused: more messages than open lanes — the batch
    plane's backpressure signal, with the numbers an admission controller
    acts on: ``requested``, ``free_lanes`` and ``capacity``."""

    def __init__(self, requested: int, free_lanes: int, capacity: int):
        self.requested = int(requested)
        self.free_lanes = int(free_lanes)
        self.capacity = int(capacity)
        super().__init__(
            f"admit of {self.requested} messages into a batch with only "
            f"{self.free_lanes} open lanes of {self.capacity} — "
            "retire completed lanes or grow capacity")


@dataclasses.dataclass(frozen=True)
class MessageBatch:
    """Lane-packed state of up to ``capacity = 32 W`` concurrent floods;
    lane ``b`` lives at bit ``b % 32`` of word ``b // 32``. A lane is OPEN
    while ``~admitted``, RUNNING while ``admitted & ~done``, FROZEN once
    ``done``; ``rounds`` counts the steps applied to it. ``sent`` records
    which nodes have broadcast for each lane (a flood node sends once), so
    :func:`lane_messages` derives each lane's total on demand."""

    #: Fields holding the reference's ``uint32`` words as int32 with the
    #: same bits: checkpoints write them as ``uint32`` (``sim/checkpoint.py``).
    U32_WORDS = ("seen", "frontier", "sent")

    seen: torch.Tensor        # i32[W, N_pad]
    frontier: torch.Tensor    # i32[W, N_pad]
    sent: torch.Tensor        # i32[W, N_pad]
    source: torch.Tensor      # i32[capacity], -1 on open lanes
    admitted: torch.Tensor    # bool[capacity]
    done: torch.Tensor        # bool[capacity]
    rounds: torch.Tensor      # i32[capacity]
    seen_count: torch.Tensor  # i32[capacity], live nodes holding it
    target: torch.Tensor      # f32[capacity], coverage target

    @property
    def n_words(self) -> int:
        return self.seen.shape[0]

    @property
    def capacity(self) -> int:
        return self.n_words * bitset.WORD

    @property
    def n_nodes_padded(self) -> int:
        return self.seen.shape[1]

    def repad(self, new_n_pad: int) -> "MessageBatch":
        """The batch at a larger node capacity: the three bit planes
        zero-extended to ``new_n_pad`` columns (the new nodes are unseen
        by every lane), the per-lane metadata unchanged."""
        new_n_pad = int(new_n_pad)
        n_pad = self.n_nodes_padded
        if new_n_pad == n_pad:
            return self
        if new_n_pad < n_pad:
            raise ValueError(
                f"repad to {new_n_pad} below the current node capacity "
                f"{n_pad} — lanes cannot shrink without dropping state")
        pad = (0, new_n_pad - n_pad)
        return dataclasses.replace(
            self, seen=torch.nn.functional.pad(self.seen, pad),
            frontier=torch.nn.functional.pad(self.frontier, pad),
            sent=torch.nn.functional.pad(self.sent, pad))


def _lane_word(batch: MessageBatch, lane: int):
    """(word, bit) of a lane id, bounds-checked."""
    lane = int(lane)
    if not 0 <= lane < batch.capacity:
        raise ValueError(
            f"lane {lane} outside this batch's capacity "
            f"{batch.capacity} — stale or foreign lane id?")
    return divmod(lane, bitset.WORD)


def lane_seen(batch: MessageBatch, lane: int) -> torch.Tensor:
    """One lane's ``seen`` predicate, ``bool[N_pad]``."""
    w, b = _lane_word(batch, lane)
    return ((batch.seen[w] >> b) & 1).to(torch.bool)


def lane_frontier(batch: MessageBatch, lane: int) -> torch.Tensor:
    """One lane's ``frontier`` predicate, ``bool[N_pad]``."""
    w, b = _lane_word(batch, lane)
    return ((batch.frontier[w] >> b) & 1).to(torch.bool)


def open_lanes_of(admitted: torch.Tensor) -> np.ndarray:
    """The open lanes of an ``admitted`` vector, in order (one host read,
    counted in ``_device.SYNCS``)."""
    _device.SYNCS += 1
    return np.flatnonzero(~admitted.cpu().numpy())


def emit_submits(lanes: np.ndarray, sources: np.ndarray) -> None:
    """One ``lane_submit`` event per admitted lane (no-op without a
    tracer)."""
    if spans.current_tracer() is not None:
        for lane, src in zip(lanes.tolist(), sources.tolist()):
            spans.emit("lane_submit", lane=lane, source=src)


def emit_retires(release: torch.Tensor) -> None:
    """One ``lane_retire`` event per released lane (no-op without a
    tracer; with one, a device release set is read, counted)."""
    if spans.current_tracer() is not None:
        if release.device.type != "cpu":
            _device.SYNCS += 1
        for lane in np.flatnonzero(release.cpu().numpy()).tolist():
            spans.emit("lane_retire", lane=lane)


def _node_words(graph: Graph) -> torch.Tensor:
    """All 32 lanes set at live nodes, none elsewhere (i32[N_pad])."""
    return torch.where(graph.node_mask, -1, 0).to(torch.int32)


def _over_live(count: torch.Tensor, graph: Graph) -> torch.Tensor:
    """Integer counts over the live node count, in f32."""
    n_live = graph.node_mask.sum().clamp_min(1)
    return count.to(torch.float32) / n_live.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class BatchFlood:
    """B single-source floods advanced together. ``method`` is the
    lane-packed lowering (``auto``/``gather``/``segment``/``frontier``),
    ``frontier_crossover`` the shared compaction budget's override."""

    method: str = "auto"
    frontier_crossover: object = None

    # ------------------------------------------------------------ lifecycle

    def empty(self, graph: Graph, capacity: int) -> MessageBatch:
        """An all-open batch of ``capacity`` lanes, rounded up to a whole
        word."""
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        n_words = bitset.n_words(capacity)
        cap = n_words * bitset.WORD
        dev = graph.device
        planes = lambda: torch.zeros(  # noqa: E731
            (n_words, graph.n_nodes_padded), dtype=torch.int32, device=dev)
        return MessageBatch(
            seen=planes(), frontier=planes(), sent=planes(),
            source=torch.full((cap,), -1, dtype=torch.int32, device=dev),
            admitted=torch.zeros(cap, dtype=torch.bool, device=dev),
            done=torch.zeros(cap, dtype=torch.bool, device=dev),
            rounds=torch.zeros(cap, dtype=torch.int32, device=dev),
            seen_count=torch.zeros(cap, dtype=torch.int32, device=dev),
            target=torch.ones(cap, dtype=torch.float32, device=dev))

    def init(self, graph: Graph, sources, *, coverage_target: float = 0.99,
             capacity: int = None) -> MessageBatch:
        """A fresh batch with one lane admitted per source (duplicates are
        independent messages); ``capacity`` reserves open lanes for later
        :meth:`admit` waves."""
        sources = np.asarray(sources, dtype=np.int32).reshape(-1)
        if sources.size == 0:
            raise ValueError("init needs at least one source")
        cap = capacity if capacity is not None else sources.size
        if cap < sources.size:
            raise ValueError(f"capacity {cap} < {sources.size} sources")
        batch, _ = self.admit(graph, self.empty(graph, cap), sources,
                              coverage_target=coverage_target)
        return batch

    def admit(self, graph: Graph, batch: MessageBatch, sources, *,
              coverage_target: float = 0.99, open_lanes=None):
        """Seed new messages into OPEN lanes; returns ``(batch,
        lane_ids)`` (numpy i32, in ``sources`` order). Each lane's seed is
        ``Flood.init``'s: masked by liveness (a dead source seeds nothing
        and spins to ``max_rounds``, as the single run does), and a lane
        already at its target starts ``done``. Raises
        :class:`LaneExhausted` when open lanes run out. The open lanes are
        read from the batch (one counted host read) unless the caller
        keeps them on the host and passes them, in order, as
        ``open_lanes`` (the serving driver does)."""
        sources = np.asarray(sources, dtype=np.int32).reshape(-1)
        if sources.size == 0:
            return batch, np.zeros(0, dtype=np.int32)
        bad = (sources < 0) | (sources >= graph.n_nodes_padded)
        if bad.any():
            base.validate_source(graph, int(sources[bad.argmax()]))
        open_lanes = (open_lanes_of(batch.admitted) if open_lanes is None
                      else np.asarray(open_lanes))
        if sources.size > open_lanes.size:
            raise LaneExhausted(sources.size, open_lanes.size,
                                batch.capacity)
        lanes = open_lanes[:sources.size].astype(np.int32)
        # Two lanes of one word may seed the same node: fold those cells'
        # bits on the host first (sort by cell, OR each run), so one
        # indexed write per cell sets them all.
        w_idx = lanes // bitset.WORD
        cell_bits = np.uint32(1) << (lanes % bitset.WORD).astype(np.uint32)
        cell_key = w_idx.astype(np.int64) * graph.n_nodes_padded + sources
        order = np.argsort(cell_key, kind="stable")
        starts = np.flatnonzero(
            np.diff(cell_key[order], prepend=cell_key[order[0]] - 1))
        folded = np.bitwise_or.reduceat(cell_bits[order], starts)
        dev = graph.device
        ws = torch.from_numpy(w_idx[order][starts].astype(np.int64)).to(dev)
        vs = torch.from_numpy(sources[order][starts].astype(np.int64)).to(dev)
        bits = torch.where(graph.node_mask[vs],
                           torch.from_numpy(folded.view(np.int32)).to(dev), 0)
        seen, front = batch.seen.clone(), batch.frontier.clone()
        seen[ws, vs] = seen[ws, vs] | bits
        front[ws, vs] = front[ws, vs] | bits
        src = torch.from_numpy(sources).to(dev)
        lanes_t = torch.from_numpy(lanes.astype(np.int64)).to(dev)
        count0 = graph.node_mask[src.long()].to(torch.int32)
        tgt = torch.tensor(coverage_target, dtype=torch.float32, device=dev)
        emit_submits(lanes, sources)
        # `sent` needs no seed: the source enters it in its first round.
        return dataclasses.replace(
            batch, seen=seen, frontier=front,
            source=batch.source.index_put((lanes_t,), src),
            admitted=batch.admitted.index_fill(0, lanes_t, True),
            done=batch.done.index_put((lanes_t,),
                                      _over_live(count0, graph) >= tgt),
            rounds=batch.rounds.index_fill(0, lanes_t, 0),
            seen_count=batch.seen_count.index_put((lanes_t,), count0),
            target=batch.target.index_put((lanes_t,), tgt.expand(
                lanes_t.shape[0])),
        ), lanes

    def repad(self, batch: MessageBatch, new_n_pad: int) -> MessageBatch:
        """:meth:`MessageBatch.repad`, the protocol's spelling."""
        return batch.repad(new_n_pad)

    def retire(self, batch: MessageBatch, lanes=None) -> MessageBatch:
        """Release lanes back to OPEN (default: every ``done`` lane),
        clearing their bits. Read their results first: this erases
        them."""
        if lanes is None:
            rel = batch.done
        else:
            ids = np.asarray(lanes, dtype=np.int64).reshape(-1)
            bad = (ids < 0) | (ids >= batch.capacity)
            if bad.any():
                raise ValueError(
                    f"retire of lane {int(ids[bad.argmax()])} outside "
                    f"this batch's capacity {batch.capacity} — stale or "
                    "foreign lane id?")
            release = np.zeros(batch.capacity, dtype=bool)
            release[ids] = True
            rel = torch.from_numpy(release).to(batch.done.device)
        emit_retires(rel)
        keep = ~bitset.pack_bits(rel)[:, None]
        return dataclasses.replace(
            batch, seen=batch.seen & keep, frontier=batch.frontier & keep,
            sent=batch.sent & keep,
            source=torch.where(rel, -1, batch.source),
            admitted=batch.admitted & ~rel, done=batch.done & ~rel,
            rounds=torch.where(rel, 0, batch.rounds),
            seen_count=torch.where(rel, 0, batch.seen_count))

    # ----------------------------------------------------------------- step

    def refresh(self, graph: Graph, batch: MessageBatch) -> MessageBatch:
        """Re-count each lane's masked coverage against the CURRENT graph
        (failures between engine calls move both the numerator and the
        live count) and add the completions that gives. ``done`` is
        latched: a completed lane stays done even if later failures drop
        its coverage under target (its frontier is already cleared). The
        engine calls this before its loop."""
        seen_count = bitset.lane_counts(
            batch.seen & _node_words(graph)).reshape(-1)
        done = batch.done | (batch.admitted
                             & (_over_live(seen_count, graph)
                                >= batch.target))
        return dataclasses.replace(batch, seen_count=seen_count, done=done)

    def step(self, graph: Graph, batch: MessageBatch, key):
        """One round of every RUNNING lane; frozen and open lanes are out
        of the batch frontier. ``key`` is taken and ignored, as floods
        ignore theirs. Per round only word-level work: the per-lane
        coverage numerators by ``lane_counts`` (transpose + popcount), the
        sends by a per-node popcount against ``out_degree``."""
        live = batch.admitted & ~batch.done
        live_mask = bitset.pack_bits(live)[:, None]
        front = batch.frontier & live_mask
        delivered = segment.propagate_or_lanes(
            graph, front, self.method,
            frontier_crossover=self.frontier_crossover)
        new = delivered & ~batch.seen & live_mask
        seen = batch.seen | new
        sent = batch.sent | front
        # `new` is node-masked and the mask is static within a run, so the
        # incremental count equals Flood's sum(seen & node_mask) once the
        # batch was refreshed at entry.
        seen_count = batch.seen_count + bitset.lane_counts(new).reshape(-1)
        done = batch.done | (batch.admitted
                             & (_over_live(seen_count, graph)
                                >= batch.target))
        rounds = batch.rounds + live.to(torch.int32)
        running = batch.admitted & ~done
        frontier_next = new & bitset.pack_bits(running)[:, None]
        stats = {
            # Per-word sends, int64: out_degree times each node's lane
            # popcount.
            "messages_words": (graph.out_degree.to(torch.int64)
                               * bitset.popcount_words(front)).sum(dim=1),
            "active_lanes": running.sum(dtype=torch.int32),
            "completed": done.sum(dtype=torch.int32),
            "batch_occupancy": frontier.occupancy(
                graph, (frontier_next != 0).any(dim=0)),
        }
        return dataclasses.replace(
            batch, seen=seen, frontier=frontier_next, sent=sent, done=done,
            rounds=rounds, seen_count=seen_count), stats


def free_lane_count(batch: MessageBatch) -> int:
    """How many lanes :meth:`BatchFlood.admit` can still seed (one small
    host read)."""
    return int(batch.capacity - int(batch.admitted.sum()))


def lane_messages(graph: Graph, batch: MessageBatch) -> torch.Tensor:
    """Each lane's total sends, ``i32[capacity]``: the out-degree-weighted
    count of its ``sent`` predicate (a flood node sends once), priced at
    the graph's CURRENT ``out_degree`` as the reference's. A word at a
    time: all words' int64 bit planes at once would be 0.8 GB at the
    bench's width."""
    return torch.stack([bitset.lane_counts(s, graph.out_degree)
                        for s in batch.sent]).reshape(-1)
