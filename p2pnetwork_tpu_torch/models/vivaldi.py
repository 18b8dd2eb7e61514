"""Vivaldi network coordinates — decentralized latency embedding, batched
(torch counterpart of ``p2pnetwork_tpu/models/vivaldi.py``).

Every node keeps a Euclidean coordinate plus a height (its access-link
penalty); each round every live node springs against one neighbor drawn
from its table (``base.draw_neighbor_slot``, threefry's bits), the link's
weight (``neighbor_weight``; 1 a hop unweighted) being the measured RTT,
optionally jittered by ``noise`` (a ``prng.uniform`` draw). The update is
the paper's adaptive timestep: confidence ``w = ei/(ei+ej)``, step ``cc
w``, an EWMA of each node's error, and the height pulled toward the
residual. The init is ``1e-3 * prng.normal`` (jax's bits).

A step is exact: from the same state it gives the reference's bits (the
norm as XLA computes it, :func:`_norm`). The tests hold runs from
``init`` to the reference's within a tolerance, the drawn partners and
``messages`` exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from p2pnetwork_tpu_torch import prng
from p2pnetwork_tpu_torch.models import base
from p2pnetwork_tpu_torch.ops import threefry as TF
from p2pnetwork_tpu_torch.sim.graph import Graph


@dataclasses.dataclass(frozen=True)
class VivaldiState:
    coord: torch.Tensor  # f32[N_pad, dim] — Euclidean part
    height: torch.Tensor  # f32[N_pad] — access-link penalty (>= height_min)
    ce: torch.Tensor  # f32[N_pad] — local error estimate in [0, 1]
    round: torch.Tensor  # i32[]


def _norm(x: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(x, axis=-1)`` with XLA's CPU bits: the squares
    accumulate by fused multiply-adds, ``fma(x1, x1, x0 * x0)`` chained
    over the dimensions, and the root is correctly rounded (taken in f64,
    rounded once; torch's f32 ``sqrt`` on the CPU is not)."""
    acc = x[..., 0] * x[..., 0]
    for d in range(1, x.shape[-1]):
        acc = TF.fma_f32(x[..., d], x[..., d], acc)
    return torch.sqrt(acc.double()).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class Vivaldi:
    """Height-vector Vivaldi over the neighbor table: ``dim`` Euclidean
    dimensions, the paper's gains ``cc`` and ``ce_gain``, multiplicative
    RTT jitter ``noise``, and the positive height floor
    ``height_min``."""

    dim: int = 2
    cc: float = 0.25
    ce_gain: float = 0.25
    noise: float = 0.0
    height_min: float = 1e-3

    STATS = ("messages", "rmse", "mean_rel_err", "mean_ce")

    def init(self, graph: Graph, key) -> VivaldiState:
        if graph.neighbors is None or not graph.neighbors_complete:
            raise ValueError(
                "Vivaldi needs the complete neighbor table "
                "(build with from_edges(build_neighbor_table=True))")
        n_pad, dev = graph.n_nodes_padded, graph.device
        coord = 1e-3 * prng.normal(key, (n_pad, self.dim), device=dev)
        return VivaldiState(
            # A select, as XLA makes the product with a bool mask.
            coord=torch.where(graph.node_mask[:, None], coord, 0.0),
            height=torch.full((n_pad,), float(np.float32(self.height_min)),
                              dtype=torch.float32, device=dev),
            ce=torch.ones(n_pad, dtype=torch.float32, device=dev),
            round=torch.zeros((), dtype=torch.int32, device=dev))

    def predicted(self, state: VivaldiState, i, j) -> torch.Tensor:
        """Predicted latency between node index arrays ``i`` and ``j``."""
        return (_norm(state.coord[i] - state.coord[j]) + state.height[i]
                + state.height[j])

    def step(self, graph: Graph, state: VivaldiState, key):
        k_pick, k_noise = prng.split(key)
        slot, partner, has = base.draw_neighbor_slot(graph, k_pick)
        active = has & graph.node_mask & graph.node_mask[partner]

        if graph.neighbor_weight is not None:
            rtt = graph.neighbor_weight.gather(1, slot[:, None].long())[:, 0]
        else:
            rtt = torch.ones(graph.n_nodes_padded, dtype=torch.float32,
                             device=graph.device)
        if self.noise > 0.0:
            rtt = rtt * (1.0 + self.noise * prng.uniform(
                k_noise, rtt.shape, -1.0, 1.0, device=graph.device))

        xi, xj = state.coord, state.coord[partner]
        hi, hj = state.height, state.height[partner]
        dvec = xi - xj
        dist = _norm(dvec)
        pred = dist + hi + hj
        unit = dvec / dist.clamp_min(1e-9)[:, None]

        w = state.ce / (state.ce + state.ce[partner]).clamp_min(1e-9)
        err = pred - rtt  # positive: we predict too far -> pull closer
        rel_err = err.abs() / rtt.clamp_min(1e-9)
        delta = self.cc * w

        move = (-delta * err)[:, None] * unit
        coord = torch.where(active[:, None], xi + move, xi)
        height = torch.where(
            active,
            (hi - delta * err * (hi / pred.clamp_min(1e-9))).clamp_min(
                self.height_min),
            hi)
        gain = self.ce_gain * w
        ce = torch.where(
            active, (rel_err * gain + state.ce * (1.0 - gain)).clamp(0.0,
                                                                     1.0),
            state.ce)

        new_state = VivaldiState(coord=coord, height=height, ce=ce,
                                 round=state.round + 1)
        n_act = active.sum().clamp_min(1).to(torch.float32)
        n_live = graph.node_mask.sum().clamp_min(1).to(torch.float32)
        return new_state, {
            "messages": active.sum(),  # one ping/ack per sampled spring
            "rmse": torch.sqrt(torch.where(active, err * err, 0.0).sum()
                               / n_act),
            "mean_rel_err": torch.where(active, rel_err, 0.0).sum() / n_act,
            "mean_ce": torch.where(graph.node_mask, ce, 0.0).sum() / n_live,
        }
