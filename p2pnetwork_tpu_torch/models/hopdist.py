"""Hop distance (BFS layers) from a source node (torch counterpart of
``p2pnetwork_tpu/models/hopdist.py``).

A round is the flood's masked frontier-OR (``propagate_or``: B1's OR
entry under ``pallas``/``hybrid``); nodes record the round at which the
wave first reaches them, so the final state is the exact BFS hop count
(-1 unreached). No random number is drawn.

:func:`bfs_distances`, :func:`eccentricities` and :func:`diameter_bounds`
run the wave to its end. The reference loops on the device
(``lax.while_loop``, ``lax.map``); the port loops on the host and reads
whether the frontier is empty once a round (one sync each, counted in
``_device.SYNCS``).
"""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch import _device, prng
from p2pnetwork_tpu_torch.models import base
from p2pnetwork_tpu_torch.models.flood import _over_live
from p2pnetwork_tpu_torch.ops import segment
from p2pnetwork_tpu_torch.sim.graph import Graph


@dataclasses.dataclass(frozen=True)
class HopDistanceState:
    dist: torch.Tensor  # i32[N_pad] — BFS hops from source, -1 = not reached
    frontier: torch.Tensor  # bool[N_pad] — nodes first reached last round
    round: torch.Tensor  # i32[] — rounds executed so far


def reached_coverage(graph: Graph, dist: torch.Tensor) -> torch.Tensor:
    """Fraction of live nodes with a hop count (f32)."""
    return _over_live(((dist >= 0) & graph.node_mask).sum(), graph)


@dataclasses.dataclass(frozen=True)
class HopDistance:
    """Single-source BFS hop counts. ``source`` is the seed node index,
    ``method`` the OR lowering (``ops/segment.py``)."""

    source: int = 0
    method: str = "auto"

    STATS = ("messages", "coverage", "frontier", "max_dist")
    RUNS_ON_PART = True

    def init(self, graph: Graph, key) -> HopDistanceState:
        base.validate_source(graph, self.source)
        seed = base.source_seed(graph, self.source)
        return HopDistanceState(
            dist=torch.where(seed, 0, -1).to(torch.int32), frontier=seed,
            round=torch.zeros((), dtype=torch.int32, device=graph.device))

    def coverage(self, graph: Graph, state: HopDistanceState):
        return reached_coverage(graph, state.dist)

    def step(self, graph: Graph, state: HopDistanceState, key):
        delivered = segment.propagate_or(graph, state.frontier, self.method)
        new = delivered & (state.dist < 0) & graph.node_mask
        rnd = state.round + 1
        dist = torch.where(new, rnd, state.dist)
        stats = {
            "messages": segment.frontier_messages(graph, state.frontier),
            "coverage": reached_coverage(graph, dist),
            "frontier": new.sum(),
            # The source's eccentricity once the wave dies out.
            "max_dist": dist.max(),
        }
        return HopDistanceState(dist=dist, frontier=new, round=rnd), stats


def bfs_distances(graph: Graph, src, method: str = "auto") -> torch.Tensor:
    """Single-source BFS distance field i32[N_pad] (-1 unreached), the
    wave run until its frontier is empty."""
    seed = base.source_seed(graph, src)
    dist = torch.where(seed, 0, -1).to(torch.int32)
    frontier, rnd = seed, 0
    while _device.host_bool(frontier.any()):
        delivered = segment.propagate_or(graph, frontier, method)
        frontier = delivered & (dist < 0) & graph.node_mask
        rnd += 1
        dist = torch.where(frontier, rnd, dist)
    return dist


def eccentricities(graph: Graph, sources, method: str = "auto"):
    """One full BFS per source: ``(ecc, reached)``, both i32[S] — the
    farthest hop from each source within its component (-1 for a dead
    source) and how many live nodes its wave touched."""
    ecc, reached = [], []
    for src in torch.as_tensor(sources).reshape(-1).tolist():
        dist = bfs_distances(graph, src, method)
        ecc.append(dist.max())
        reached.append(((dist >= 0) & graph.node_mask).sum())
    return (torch.stack(ecc).to(torch.int32),
            torch.stack(reached).to(torch.int32))


def diameter_bounds(graph: Graph, key, samples: int = 16,
                    method: str = "auto") -> dict:
    """The sampled diameter bracket ``[max ecc, 2 * min ecc]`` over
    ``samples`` sources drawn uniformly from the live nodes without
    replacement (``prng.choice``). Returns ``lower``, ``upper``,
    ``radius_upper`` (the least sampled eccentricity) and ``connected``
    (every sampled wave reached every live node) as Python scalars."""
    alive = torch.nonzero(graph.node_mask).reshape(-1).to(torch.int32)
    if alive.numel() == 0:
        return {"lower": 0, "upper": 0, "radius_upper": 0,
                "connected": False}
    picks = prng.choice(key, alive, shape=(min(samples, alive.numel()),),
                        replace=False)
    ecc, reached = eccentricities(graph, picks, method)
    ecc, reached = ecc.tolist(), reached.tolist()
    return {"lower": max(ecc), "upper": 2 * min(ecc),
            "radius_upper": min(ecc),
            "connected": all(r == alive.numel() for r in reached)}
