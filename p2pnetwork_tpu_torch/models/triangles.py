"""Triangle counting, clustering coefficients and wedge-closure sampling
(torch counterpart of ``p2pnetwork_tpu/models/triangles.py``).

- exact: every directed edge slot ``(s, r)`` intersects the two complete
  neighbor rows — a ``[B, d, d]`` masked equality per block of ``B``
  edges, blocks sized so one holds about ``_BLOCK_BUDGET`` compares —
  and the per-edge counts add up exactly (integers). Each triangle is
  seen 6 times.
- estimated (:func:`transitivity_sample`): wedge centers drawn with
  probability proportional to ``d(d-1)`` through a cumulative-weight
  ``searchsorted``, two distinct out-slots through the source-CSR view,
  closure by ``topology.static_edge_exists``. The three draws are
  ``prng.randint`` from ``split(key, 3)`` (the threefry kernel on the
  card), bit for bit the reference's.

Counts are exact on the symmetric graphs the builders make; graphs with
a dynamic edge region are refused (fold runtime links in with
``topology.consolidate``).
"""

from __future__ import annotations

import numpy as np
import torch

from p2pnetwork_tpu_torch import _device, prng
from p2pnetwork_tpu_torch.ops.segment import _require_complete_table
from p2pnetwork_tpu_torch.sim.graph import Graph

#: Target compares per ``[B, d, d]`` block (the reference's bound on a
#: block's memory).
_BLOCK_BUDGET = 1 << 20


def _require_static(graph: Graph, what: str) -> None:
    if graph.dyn_senders is not None:
        raise ValueError(
            f"{what} counts the static edge set only, but this graph "
            "carries a dynamic edge region (topology.with_capacity); "
            "fold runtime links into the static layout first with "
            "topology.consolidate")


def _edge_block(graph: Graph) -> int:
    d = max(graph.max_degree, 1)
    return int(np.clip(_BLOCK_BUDGET // (d * d), 1, 4096))


def _edge_common_counts(graph: Graph, edge_block: int) -> torch.Tensor:
    """i32[E_pad]: per directed edge slot, the live third vertices
    adjacent to both endpoints (0 on masked slots)."""
    out = []
    for lo in range(0, graph.n_edges_padded, edge_block):
        s = graph.senders[lo:lo + edge_block]
        r = graph.receivers[lo:lo + edge_block]
        ns, ms = graph.neighbors[s], graph.neighbor_mask[s]
        nr, mr = graph.neighbors[r], graph.neighbor_mask[r]
        eq = ((ns[:, :, None] == nr[:, None, :]) & ms[:, :, None]
              & mr[:, None, :])
        out.append(eq.sum(dim=(1, 2), dtype=torch.int32)
                   * graph.edge_mask[lo:lo + edge_block])
    return torch.cat(out)


def count_triangles(graph: Graph, *, edge_block: int = None) -> int:
    """Exact triangle count of the live undirected graph (Python int)."""
    _require_complete_table(graph)
    _require_static(graph, "count_triangles")
    cnt = _edge_common_counts(graph, edge_block or _edge_block(graph))
    _device.SYNCS += 1
    total = int(cnt.sum(dtype=torch.int64).item())
    assert total % 6 == 0, "directed slot closure must come in sixes"
    return total // 6


def triangles_per_node(graph: Graph, *,
                       edge_block: int = None) -> torch.Tensor:
    """i32[N_pad]: triangles through each node (exact, live graph)."""
    _require_complete_table(graph)
    _require_static(graph, "triangles_per_node")
    cnt = _edge_common_counts(graph, edge_block or _edge_block(graph))
    two_tri = torch.zeros(graph.n_nodes_padded, dtype=torch.int32,
                          device=graph.device)
    two_tri.index_add_(0, graph.senders, cnt)
    return two_tri // 2


def local_clustering(graph: Graph, *,
                     edge_block: int = None) -> torch.Tensor:
    """f32[N_pad]: ``2 tri_v / (d_v (d_v - 1))`` over live degrees (0
    where ``d < 2``)."""
    tri = triangles_per_node(graph, edge_block=edge_block)
    d = graph.in_degree  # == out_degree on the symmetric builder graphs
    denom = d * (d - 1)
    return torch.where(denom > 0,
                       2.0 * tri.to(torch.float32)
                       / denom.clamp_min(1).to(torch.float32), 0.0)


def transitivity(graph: Graph, *, edge_block: int = None) -> float:
    """Global clustering coefficient ``3T / #wedges`` (0 without
    wedges)."""
    t = count_triangles(graph, edge_block=edge_block)
    d = graph.in_degree.cpu().numpy().astype(np.int64)
    wedges = int((d * (d - 1)).sum()) // 2
    return 3.0 * t / wedges if wedges else 0.0


def _sample_closed(graph: Graph, key, samples: int):
    from p2pnetwork_tpu_torch.sim.topology import static_edge_exists

    d = graph.out_degree
    cum = torch.cumsum(d * (d - 1), dim=0, dtype=torch.int32)
    # The draws' bounds are device tensors, as the reference's are traced.
    k1, k2, k3 = prng.split(key, 3)
    u = prng.randint(k1, (samples,), 0, cum[-1].clamp_min(1))
    centers = torch.searchsorted(cum, u, right=True)
    dc = d[centers]
    j1 = prng.randint(k2, (samples,), 0, dc.clamp_min(1))
    j2 = prng.randint(k3, (samples,), 0, (dc - 1).clamp_min(1))
    j2 = torch.where(j2 >= j1, j2 + 1, j2)  # distinct second slot
    row0 = graph.src_offsets[centers]
    last = graph.n_edges_padded - 1
    e1 = graph.src_eid[(row0 + j1).clamp_max(last)]
    e2 = graph.src_eid[(row0 + j2).clamp_max(last)]
    a, b = graph.receivers[e1], graph.receivers[e2]
    valid = (dc >= 2) & graph.edge_mask[e1] & graph.edge_mask[e2]
    closed = static_edge_exists(graph, a, b) & valid
    return closed.sum(), valid.sum()


def transitivity_sample(graph: Graph, key, samples: int = 65536) -> float:
    """Unbiased global-clustering estimate by uniform wedge sampling over
    the built graph (samples touching dead edges are rejected)."""
    _require_static(graph, "transitivity_sample")
    if graph.src_eid is None:
        raise ValueError(
            "transitivity_sample needs the source-CSR view: build with "
            "from_edges(source_csr=True) or graph.with_source_csr()")
    d = graph.out_degree.cpu().numpy().astype(np.int64)
    if int((d * (d - 1)).sum()) >= 2**31:
        raise ValueError("wedge count exceeds int32 sampling range")
    closed, valid = _sample_closed(graph, key, samples)
    _device.SYNCS += 1
    closed, valid = torch.stack([closed, valid]).tolist()
    return closed / valid if valid else 0.0
