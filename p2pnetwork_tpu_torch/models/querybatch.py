"""Batched query lanes: route lookups, DHT chases and aggregations, one
lane-packed state per family (torch counterpart of
``p2pnetwork_tpu/models/querybatch.py``).

- :class:`MinPlusQueries` — K shortest-path queries as a node-major
  ``f32[N_pad, K]`` min-plus carry (``ops/lanes.py``); a lane freezes when
  its target's distance settles (first arrival without weights, the lane's
  fixpoint with them).
- :class:`DhtLookups` — greedy successor chases on the structured overlays
  (``sim/graph.py`` ``chord``/``kademlia``): one ``i32`` cursor per
  lookup.
- :class:`PushSumQueries` — independent push-sum aggregations (the
  mass-splitting of ``models/pushsum.py``) over ``[N_pad, K]`` masses,
  each lane frozen when its estimate variance drops under its threshold.

The lifecycle is the flood plane's (``models/messagebatch.py``): open,
running, frozen lanes; ``admit``/``retire`` between engine calls with
:class:`~p2pnetwork_tpu_torch.models.messagebatch.LaneExhausted` as
backpressure; completions latch; K is budgeted by bytes
(``ops/lanes.py`` ``lane_budget``). The engine side is ``sim/engine.py``
``run_queries_until_done``.

The reference reduces ``[N, K]`` lane fields with an f32 GEMV
(``_lane_sum``). Where that sum is an integer below ``2**24`` — the
changed-lane test and min-plus's per-lane messages — the port sums in
integers, equal in any order. Where it is a float (push-sum's mean and
variance) the port multiplies and sums in f32 on the vector units, never a
matmul that TF32 could round, and its order differs from XLA's: the
values agree to a tolerance (``tests/test_torch_queries.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from p2pnetwork_tpu_torch import prng
from p2pnetwork_tpu_torch.models import base
from p2pnetwork_tpu_torch.models.messagebatch import (
    LaneExhausted, emit_retires, emit_submits, open_lanes_of)
from p2pnetwork_tpu_torch.ops import lanes as L
from p2pnetwork_tpu_torch.ops import segment
from p2pnetwork_tpu_torch.ops.lanes import LaneBudgetExceeded  # noqa: F401
from p2pnetwork_tpu_torch.sim.graph import Graph

__all__ = [
    "QueryBatch",
    "MinPlusQueries",
    "DhtLookups",
    "PushSumQueries",
    "LaneBudgetExceeded",
    "lane_dist",
    "free_query_lanes",
]


@dataclasses.dataclass(frozen=True)
class QueryBatch:
    """Lane-packed state of up to ``capacity`` queries of one family.
    ``payload`` holds the family's carriers: ``{"dist": f32[N_pad, K]}``
    (min-plus), ``{"cur": i32[K]}`` (DHT), ``{"s", "w": f32[N_pad, K]}``
    (push-sum). ``target`` is the target node or lookup key (-1 where the
    family takes none), ``threshold`` push-sum's variance target (0
    elsewhere)."""

    payload: dict
    source: torch.Tensor     # i32[K], -1 on open lanes
    target: torch.Tensor     # i32[K]
    threshold: torch.Tensor  # f32[K]
    admitted: torch.Tensor   # bool[K]
    done: torch.Tensor       # bool[K]
    rounds: torch.Tensor     # i32[K]

    @property
    def capacity(self) -> int:
        return self.admitted.shape[0]


def _check_lane(qb: QueryBatch, lane: int) -> int:
    lane = int(lane)
    if not 0 <= lane < qb.capacity:
        raise ValueError(
            f"lane {lane} outside this batch's capacity {qb.capacity} — "
            f"stale or foreign lane id?")
    return lane


def lane_dist(qb: QueryBatch, lane: int) -> torch.Tensor:
    """One min-plus lane's distance field, ``f32[N_pad]``."""
    return qb.payload["dist"][:, _check_lane(qb, lane)]


def free_query_lanes(qb: QueryBatch) -> int:
    """Open-lane count (one small host read)."""
    return int(qb.capacity - int(qb.admitted.sum()))


def _assign_lanes(qb: QueryBatch, ids: np.ndarray) -> np.ndarray:
    """The first open lanes for ``ids`` (one counted host read), with a
    ``lane_submit`` event each under a tracer."""
    open_lanes = open_lanes_of(qb.admitted)
    if ids.size > open_lanes.size:
        raise LaneExhausted(ids.size, open_lanes.size, qb.capacity)
    lanes = open_lanes[:ids.size].astype(np.int32)
    emit_submits(lanes, ids)
    return lanes


def _validate_node_ids(graph: Graph, ids: np.ndarray) -> None:
    bad = (ids < 0) | (ids >= graph.n_nodes_padded)
    if bad.any():
        base.validate_source(graph, int(ids[bad.argmax()]))


def _release_mask(qb: QueryBatch, lanes_arg) -> torch.Tensor:
    """The ``bool[K]`` release set of a retire (default: the done
    lanes), bounds-checked."""
    if lanes_arg is None:
        emit_retires(qb.done)
        return qb.done
    ids = np.asarray(lanes_arg, dtype=np.int64).reshape(-1)
    bad = (ids < 0) | (ids >= qb.capacity)
    if bad.any():
        raise ValueError(
            f"retire of lane {int(ids[bad.argmax()])} outside this "
            f"batch's capacity {qb.capacity} — stale or foreign lane id?")
    release = np.zeros(qb.capacity, dtype=bool)
    release[ids] = True
    emit_retires(torch.from_numpy(release))
    return torch.from_numpy(release).to(qb.done.device)


def _retire_metadata(qb: QueryBatch, payload: dict,
                     rel: torch.Tensor) -> QueryBatch:
    return dataclasses.replace(
        qb, payload=payload,
        source=torch.where(rel, -1, qb.source),
        target=torch.where(rel, -1, qb.target),
        threshold=torch.where(rel, 0.0, qb.threshold),
        admitted=qb.admitted & ~rel, done=qb.done & ~rel,
        rounds=torch.where(rel, 0, qb.rounds))


def _admitted(qb: QueryBatch, lanes_np: np.ndarray, *, source, done,
              target=None, threshold=None, payload) -> QueryBatch:
    """``qb`` with ``lanes_np`` admitted: their metadata set, rounds 0."""
    lanes = torch.from_numpy(lanes_np.astype(np.int64)).to(qb.done.device)
    put = lambda t, v: t.index_put((lanes,), v)  # noqa: E731
    return dataclasses.replace(
        qb, payload=payload, source=put(qb.source, source),
        target=qb.target if target is None else put(qb.target, target),
        threshold=(qb.threshold if threshold is None
                   else put(qb.threshold, threshold)),
        admitted=qb.admitted.index_fill(0, lanes, True),
        done=put(qb.done, done), rounds=qb.rounds.index_fill(0, lanes, 0))


def _lane_sum(weights: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """``sum_n weights[n] * mat[n, k]`` per lane in f32, by an elementwise
    product and a column sum (no matmul, so no TF32 rounding)."""
    return (weights[:, None] * mat).sum(dim=0)


def _live_messages(live: torch.Tensor, per_lane: torch.Tensor):
    """This round's sends over the live lanes, int64."""
    return torch.where(live, per_lane, 0).sum(dtype=torch.int64)


def _empty_metadata(capacity: int, device) -> dict:
    cap = int(capacity)
    if cap < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    return dict(
        source=torch.full((cap,), -1, dtype=torch.int32, device=device),
        target=torch.full((cap,), -1, dtype=torch.int32, device=device),
        threshold=torch.zeros(cap, dtype=torch.float32, device=device),
        admitted=torch.zeros(cap, dtype=torch.bool, device=device),
        done=torch.zeros(cap, dtype=torch.bool, device=device),
        rounds=torch.zeros(cap, dtype=torch.int32, device=device))


def _pairs(a, b, what: str, names: tuple):
    a = np.asarray(a, dtype=np.int32).reshape(-1)
    b = np.asarray(b, dtype=np.int32).reshape(-1)
    if a.size != b.size:
        raise ValueError(f"{a.size} {names[0]} vs {b.size} {names[1]} — "
                         f"{what} are ({names[2]}) pairs")
    return a, b


def _init_capacity(n: int, capacity, what: str) -> int:
    if n == 0:
        raise ValueError(f"init needs at least one {what}")
    cap = capacity if capacity is not None else n
    if cap < n:
        raise ValueError(f"capacity {cap} < {n} {what}s")
    return cap


# --------------------------------------------------------------- min-plus


@dataclasses.dataclass(frozen=True)
class MinPlusQueries:
    """K shortest-path lookups: lane ``k`` relaxes a distance column from
    ``source[k]`` each round and answers ``dist[target[k]]`` (``+inf`` =
    unreachable). Unweighted, the lane freezes when its target's distance
    turns finite (BFS first arrival); weighted, or unreachable, at its
    fixpoint (a round that changed nothing)."""

    method: str = "auto"
    budget_bytes: int = None

    VALUES_FLOAT = True
    RUNS_ON_PART = True

    def _budget(self, graph: Graph, capacity: int) -> None:
        L.lane_budget(capacity, torch.float32, graph.n_nodes_padded,
                      carriers=1, budget_bytes=self.budget_bytes)

    def empty(self, graph: Graph, capacity: int) -> QueryBatch:
        self._budget(graph, capacity)
        return QueryBatch(
            payload={"dist": torch.full(
                (graph.n_nodes_padded, int(capacity)), torch.inf,
                dtype=torch.float32, device=graph.device)},
            **_empty_metadata(capacity, graph.device))

    def init(self, graph: Graph, sources, targets, *,
             capacity: int = None) -> QueryBatch:
        sources, targets = _pairs(sources, targets, "route lookups",
                                  ("sources", "targets", "source, target"))
        cap = _init_capacity(sources.size, capacity, "query")
        qb, _ = self.admit(graph, self.empty(graph, cap), sources, targets)
        return qb

    def admit(self, graph: Graph, qb: QueryBatch, sources, targets):
        """Seed route lookups into OPEN lanes; returns ``(batch,
        lane_ids)``. A live source that is its own target starts done at
        distance 0; a dead source seeds an all-inf lane."""
        self._budget(graph, qb.capacity)
        sources, targets = _pairs(sources, targets, "route lookups",
                                  ("sources", "targets", "source, target"))
        if sources.size == 0:
            return qb, np.zeros(0, dtype=np.int32)
        _validate_node_ids(graph, sources)
        _validate_node_ids(graph, targets)
        lanes_np = _assign_lanes(qb, sources)
        dev = graph.device
        src = torch.from_numpy(sources).to(dev)
        tgt = torch.from_numpy(targets).to(dev)
        lanes = torch.from_numpy(lanes_np.astype(np.int64)).to(dev)
        seeded = graph.node_mask[src.long()]
        seed_val = torch.where(seeded, 0.0, torch.inf)
        dist = qb.payload["dist"].index_put((src.long(), lanes), seed_val)
        return _admitted(qb, lanes_np, source=src, target=tgt,
                         done=seeded & (src == tgt),
                         payload={"dist": dist}), lanes_np

    def retire(self, qb: QueryBatch, lanes=None) -> QueryBatch:
        rel = _release_mask(qb, lanes)
        dist = torch.where(rel[None, :], torch.inf, qb.payload["dist"])
        return _retire_metadata(qb, {"dist": dist}, rel)

    def refresh(self, graph: Graph, qb: QueryBatch) -> QueryBatch:
        """The identity: nothing here is mask-derived, and completions
        latch."""
        return qb

    def step(self, graph: Graph, qb: QueryBatch, key):
        """One Bellman-Ford round of every RUNNING lane."""
        dist = qb.payload["dist"]
        live = qb.admitted & ~qb.done
        relaxed = L.lane_min(dist, L.propagate_min_plus_lanes(
            graph, dist, self.method))
        new_dist = torch.where(live[None, :], relaxed, dist)
        improved = new_dist != dist
        changed = improved.any(dim=0)
        k_idx = torch.arange(qb.capacity, device=dist.device)
        tgt = qb.target.clamp(0, graph.n_nodes_padded - 1).long()
        at_target = new_dist[tgt, k_idx]
        if graph.edge_weight is None:
            finished = torch.isfinite(at_target) | ~changed
        else:
            finished = ~changed
        per_lane = (improved.to(torch.int64)
                    * graph.out_degree.to(torch.int64)[:, None]).sum(dim=0)
        stats = {
            "messages": _live_messages(live, per_lane),
            "changed_lanes": (live & changed).sum(dtype=torch.int32),
        }
        return dataclasses.replace(
            qb, payload={"dist": new_dist}, done=qb.done | (live & finished),
            rounds=qb.rounds + live.to(torch.int32)), stats

    def lane_values(self, graph: Graph, qb: QueryBatch) -> torch.Tensor:
        """``dist[target]`` per lane (+inf on open lanes)."""
        k_idx = torch.arange(qb.capacity, device=qb.done.device)
        tgt = qb.target.clamp(0, graph.n_nodes_padded - 1).long()
        return torch.where(qb.admitted, qb.payload["dist"][tgt, k_idx],
                           torch.inf)


# -------------------------------------------------------------- DHT chase


@dataclasses.dataclass(frozen=True)
class DhtLookups:
    """K greedy DHT lookups: each cursor hops to its closest live neighbor
    under ``metric`` (``ring``: Chord's clockwise distance, ``xor``:
    Kademlia's) and freezes when it arrives at the key or stalls (no
    strictly closer neighbor). Keys live in ``[0, n_nodes)``; the answer
    is the final cursor (``found`` is ``lane_values == target``)."""

    metric: str = "ring"
    budget_bytes: int = None

    VALUES_FLOAT = False
    RUNS_ON_PART = True

    def __post_init__(self):
        if self.metric not in L.DHT_METRICS:
            raise ValueError(
                f"unknown DHT metric {self.metric!r} — one of "
                f"{L.DHT_METRICS}")

    def _budget(self, graph: Graph, capacity: int) -> None:
        L.lane_budget(capacity, torch.int32, 1, carriers=1,
                      budget_bytes=self.budget_bytes)

    def empty(self, graph: Graph, capacity: int) -> QueryBatch:
        self._budget(graph, capacity)
        return QueryBatch(
            payload={"cur": torch.zeros(int(capacity), dtype=torch.int32,
                                        device=graph.device)},
            **_empty_metadata(capacity, graph.device))

    def init(self, graph: Graph, origins, keys, *,
             capacity: int = None) -> QueryBatch:
        origins, keys = _pairs(origins, keys, "DHT lookups",
                               ("origins", "keys", "origin, key"))
        cap = _init_capacity(origins.size, capacity, "lookup")
        qb, _ = self.admit(graph, self.empty(graph, cap), origins, keys)
        return qb

    def admit(self, graph: Graph, qb: QueryBatch, origins, keys):
        """Seed lookups into OPEN lanes; returns ``(batch, lane_ids)``. An
        origin at its key completes at admission (0 hops), a dead origin
        completes at once as a failed lookup."""
        self._budget(graph, qb.capacity)
        origins, keys = _pairs(origins, keys, "DHT lookups",
                               ("origins", "keys", "origin, key"))
        if origins.size == 0:
            return qb, np.zeros(0, dtype=np.int32)
        _validate_node_ids(graph, origins)
        bad = (keys < 0) | (keys >= graph.n_nodes)
        if bad.any():
            raise ValueError(
                f"lookup key {int(keys[bad.argmax()])} outside the "
                f"overlay id space [0, {graph.n_nodes}) — keys speak "
                "the ring/xor metric's modulus, not the padded space")
        lanes_np = _assign_lanes(qb, origins)
        dev = graph.device
        org = torch.from_numpy(origins).to(dev)
        key_ids = torch.from_numpy(keys).to(dev)
        lanes = torch.from_numpy(lanes_np.astype(np.int64)).to(dev)
        alive = graph.node_mask[org.long()]
        return _admitted(
            qb, lanes_np, source=org, target=key_ids,
            done=(org == key_ids) | ~alive,
            payload={"cur": qb.payload["cur"].index_put((lanes,), org)}
        ), lanes_np

    def retire(self, qb: QueryBatch, lanes=None) -> QueryBatch:
        rel = _release_mask(qb, lanes)
        return _retire_metadata(
            qb, {"cur": torch.where(rel, 0, qb.payload["cur"])}, rel)

    def refresh(self, graph: Graph, qb: QueryBatch) -> QueryBatch:
        """The identity: an arrived lookup stays arrived; a running chase
        reads the CURRENT mask at its next hop."""
        return qb

    def step(self, graph: Graph, qb: QueryBatch, key):
        """One greedy hop of every RUNNING lookup (a message per hop)."""
        cur = qb.payload["cur"]
        live = qb.admitted & ~qb.done
        nxt, hopped = L.dht_hop_lanes(graph, cur, qb.target, self.metric)
        new_cur = torch.where(live, nxt, cur)
        arrived = new_cur == qb.target
        stats = {
            "messages": (live & hopped).sum(dtype=torch.int64),
            "arrived_lanes": (live & arrived).sum(dtype=torch.int32),
        }
        return dataclasses.replace(
            qb, payload={"cur": new_cur},
            done=qb.done | (live & (arrived | ~hopped)),
            rounds=qb.rounds + live.to(torch.int32)), stats

    def lane_values(self, graph: Graph, qb: QueryBatch) -> torch.Tensor:
        """The final cursor per lane (-1 on open lanes)."""
        return torch.where(qb.admitted, qb.payload["cur"], -1)


# --------------------------------------------------------------- push-sum


@dataclasses.dataclass(frozen=True)
class PushSumQueries:
    """Independent push-sum aggregations sharing the round's edge
    gathers: lane ``k`` splits its own ``s``/``w`` columns as
    ``models/pushsum.py`` does and freezes when its estimate variance is
    under its threshold. Its seed field is ``normal(fold_in(key(
    seed_salt), seed))`` masked to live nodes (``prng.py``, within 3 ulp
    of jax's draws). Under ``gather`` each step's sums are the reference's
    float ops in the reference's order."""

    method: str = "auto"
    seed_salt: int = 0
    budget_bytes: int = None

    VALUES_FLOAT = True
    RUNS_ON_PART = True

    def _budget(self, graph: Graph, capacity: int) -> None:
        L.lane_budget(capacity, torch.float32, graph.n_nodes_padded,
                      carriers=2, budget_bytes=self.budget_bytes)

    def empty(self, graph: Graph, capacity: int) -> QueryBatch:
        self._budget(graph, capacity)
        zeros = torch.zeros((graph.n_nodes_padded, int(capacity)),
                            dtype=torch.float32, device=graph.device)
        return QueryBatch(payload={"s": zeros, "w": zeros.clone()},
                          **_empty_metadata(capacity, graph.device))

    def init(self, graph: Graph, seeds, *, threshold: float = 1e-4,
             capacity: int = None) -> QueryBatch:
        seeds = np.asarray(seeds, dtype=np.int32).reshape(-1)
        cap = _init_capacity(seeds.size, capacity, "query")
        qb, _ = self.admit(graph, self.empty(graph, cap), seeds,
                           threshold=threshold)
        return qb

    def admit(self, graph: Graph, qb: QueryBatch, seeds, *,
              threshold: float = 1e-4):
        """Seed aggregation queries into OPEN lanes; returns ``(batch,
        lane_ids)``. Every lane runs at least one round before its
        variance is read (``run_until_converged``'s contract), unless it
        is under threshold at admission."""
        self._budget(graph, qb.capacity)
        if not threshold > 0:
            raise ValueError(
                f"threshold must be > 0, got {threshold} (push-sum "
                "variance has an f32 floor — see run_until_converged)")
        seeds = np.asarray(seeds, dtype=np.int32).reshape(-1)
        if seeds.size == 0:
            return qb, np.zeros(0, dtype=np.int32)
        lanes_np = _assign_lanes(qb, seeds)
        dev = graph.device
        base_key = prng.key(self.seed_salt)
        n_pad = graph.n_nodes_padded
        values = torch.stack([
            prng.normal(prng.fold_in(base_key, int(s)), (n_pad,), device=dev)
            for s in seeds])                          # f32[count, N_pad]
        mask_f = graph.node_mask.to(torch.float32)
        s_cols = (values * mask_f[None, :]).T
        w_cols = mask_f[:, None].expand(n_pad, seeds.size)
        lanes = torch.from_numpy(lanes_np.astype(np.int64)).to(dev)
        payload = {k: v.clone() for k, v in qb.payload.items()}
        payload["s"][:, lanes] = s_cols
        payload["w"][:, lanes] = w_cols
        count = lanes.shape[0]
        return _admitted(
            qb, lanes_np, source=torch.from_numpy(seeds).to(dev),
            threshold=torch.full((count,), threshold, dtype=torch.float32,
                                 device=dev),
            done=torch.zeros(count, dtype=torch.bool, device=dev),
            payload=payload), lanes_np

    def retire(self, qb: QueryBatch, lanes=None) -> QueryBatch:
        rel = _release_mask(qb, lanes)
        payload = {k: torch.where(rel[None, :], 0.0, v)
                   for k, v in qb.payload.items()}
        return _retire_metadata(qb, payload, rel)

    def refresh(self, graph: Graph, qb: QueryBatch) -> QueryBatch:
        """The identity: converged estimates latch."""
        return qb

    def _mean(self, graph: Graph, s, w):
        """Per-lane estimates ``s/w`` (0 where ``w`` is 0) and their mean
        over live nodes, as ``models/pushsum.py``'s stats."""
        mask_f = graph.node_mask.to(torch.float32)
        est = torch.where(w > 0, s / w.clamp_min(1e-30), 0.0)
        n_real = graph.node_mask.sum().clamp_min(1).to(torch.float32)
        return est, mask_f, n_real, _lane_sum(mask_f, est) / n_real

    def _variance(self, graph: Graph, s, w) -> torch.Tensor:
        est, mask_f, n_real, mean = self._mean(graph, s, w)
        return _lane_sum(mask_f, (est - mean[None, :]) ** 2) / n_real

    def step(self, graph: Graph, qb: QueryBatch, key):
        """One mass-splitting round of every RUNNING lane. Convergence is
        read on the ENTERING masses, as the reference's: the round that
        crosses is the last applied either way."""
        s, w = qb.payload["s"], qb.payload["w"]
        var = self._variance(graph, s, w)
        done = qb.done | (qb.admitted & (var < qb.threshold))
        live = qb.admitted & ~done
        mask_f = graph.node_mask.to(torch.float32)[:, None]
        shares = (1.0 / (graph.out_degree.to(torch.float32) + 1.0))[:, None]
        s_sh = s * shares
        w_sh = w * shares
        s2 = (s_sh + L.propagate_sum_lanes(graph, s_sh, self.method)) * mask_f
        w2 = (w_sh + L.propagate_sum_lanes(graph, w_sh, self.method)) * mask_f
        per_round = segment.frontier_messages(graph, graph.node_mask)
        stats = {
            "messages": per_round * live.sum(dtype=torch.int64),
            "variance_max": torch.where(live, var, 0.0).max(),
        }
        return dataclasses.replace(
            qb, payload={"s": torch.where(live[None, :], s2, s),
                         "w": torch.where(live[None, :], w2, w)},
            done=done, rounds=qb.rounds + live.to(torch.int32)), stats

    def lane_values(self, graph: Graph, qb: QueryBatch) -> torch.Tensor:
        """The network-mean estimate per lane (0 on open lanes)."""
        mean = self._mean(graph, qb.payload["s"], qb.payload["w"])[-1]
        return torch.where(qb.admitted, mean, 0.0)
