"""Sampled closeness and betweenness centrality (torch counterpart of
``p2pnetwork_tpu/models/centrality.py``).

- :func:`closeness_sample`: one BFS wave per source
  (``hopdist.bfs_distances``: ``propagate_or`` a layer, B1's OR entry
  under ``pallas`` / ``hybrid``), accumulating ``1/d`` (harmonic) or the
  distances (classic) at every node.
- :func:`betweenness_sample`: Brandes per source — a forward BFS counting
  shortest paths (``sigma``), then the dependencies accumulated from the
  deepest layer back, one ``propagate_sum`` a layer either way (B1's sum
  entry under ``pallas`` / ``hybrid``). On the symmetric edge sets the
  builders make, "pull from my successors" is an ordinary in-edge sum
  with a sender-side layer mask.

The reference scans the sources and loops the layers on the device
(``lax.scan``, ``lax.while_loop``); the port loops both on the host and
reads whether the forward frontier is empty once a layer (one sync each,
``_device.SYNCS``); the backward sweep runs the layers the forward pass
counted, with no read. Path counts and sums are f32: the results agree
with the reference's to rounding (the sums add in another order).
"""

from __future__ import annotations

import torch

from p2pnetwork_tpu_torch import _device
from p2pnetwork_tpu_torch.models import base
from p2pnetwork_tpu_torch.models.hopdist import bfs_distances
from p2pnetwork_tpu_torch.ops import segment
from p2pnetwork_tpu_torch.sim.graph import Graph


def _sources(sources) -> list:
    return [int(s) for s in torch.as_tensor(sources).reshape(-1).tolist()]


def _live_scale(graph: Graph, srcs: list) -> torch.Tensor:
    """``n_live / S_live`` in f32 (live sources only in the divisor)."""
    n_live = graph.node_mask.sum().clamp_min(1)
    s_live = graph.node_mask[srcs].sum().clamp_min(1)
    return n_live.to(torch.float32) / s_live.to(torch.float32)


def closeness_sample(graph: Graph, sources, method: str = "auto",
                     harmonic: bool = True,
                     normalized: bool = False) -> torch.Tensor:
    """Closeness centrality ``f32[N_pad]`` from BFS waves over
    ``sources``: the harmonic sum of ``1/d`` (default), or ``reached /
    sum(d)`` over the sampled sources (``harmonic=False``).
    ``normalized=True`` rescales the harmonic sum by ``n_live /
    S_live``."""
    if normalized and not harmonic:
        raise ValueError(
            "normalized=True is defined for the harmonic estimator only "
            "(classic closeness has no unbiased sampled rescale here)")
    srcs = _sources(sources)
    zeros = torch.zeros(graph.n_nodes_padded, dtype=torch.float32,
                        device=graph.device)
    inv_sum, d_sum, reach = zeros, zeros, zeros
    for src in srcs:
        d = bfs_distances(graph, src, method)
        hit = (d > 0) & graph.node_mask[src]  # excludes the source itself
        df = d.to(torch.float32)
        inv_sum = inv_sum + torch.where(hit, 1.0 / df.clamp_min(1.0), 0.0)
        d_sum = d_sum + torch.where(hit, df, 0.0)
        reach = reach + hit.to(torch.float32)
    if harmonic:
        out = inv_sum
        if normalized:
            out = out * _live_scale(graph, srcs)
    else:
        out = torch.where(d_sum > 0, reach / d_sum.clamp_min(1.0), 0.0)
    return out * graph.node_mask


def _brandes(graph: Graph, src: int, method: str) -> torch.Tensor:
    """One source's dependencies ``delta`` (0 at the source)."""
    seed = base.source_seed(graph, src)
    d = torch.where(seed, 0, -1).to(torch.int32)
    sigma = seed.to(torch.float32)
    frontier, layer = seed, 0
    # Forward: sigma[v] sums sigma over frontier in-neighbors, assigned
    # the layer v is first reached (contrib > 0 is delivery: every
    # frontier node carries sigma >= 1).
    while _device.host_bool(frontier.any()):
        contrib = segment.propagate_sum(
            graph, sigma * frontier.to(torch.float32), method)
        new = (contrib > 0) & (d < 0) & graph.node_mask
        layer += 1
        d = torch.where(new, layer, d)
        sigma = sigma + torch.where(new, contrib, 0.0)
        frontier = new
    # Backward, deepest layer first: successors (d == L) send
    # (1 + delta) / sigma, predecessors (d == L - 1) take sigma times it.
    delta = torch.zeros_like(sigma)
    for L in range(layer, 0, -1):
        coef = torch.where((d == L) & (sigma > 0),
                           (1.0 + delta) / sigma.clamp_min(1.0), 0.0)
        acc = segment.propagate_sum(graph, coef, method)
        delta = delta + torch.where(d == L - 1, sigma * acc, 0.0)
    return torch.where(seed, 0.0, delta)


def betweenness_sample(graph: Graph, sources, method: str = "auto",
                       normalized: bool = False) -> torch.Tensor:
    """Accumulated Brandes dependencies ``f32[N_pad]`` over ``sources``
    (a dead source adds nothing). ``normalized=True`` rescales by
    ``n_live / S_live``."""
    srcs = _sources(sources)
    bc = torch.zeros(graph.n_nodes_padded, dtype=torch.float32,
                     device=graph.device)
    for src in srcs:
        bc = bc + torch.where(graph.node_mask[src],
                              _brandes(graph, src, method), 0.0)
    if normalized:
        bc = bc * _live_scale(graph, srcs)
    return bc
