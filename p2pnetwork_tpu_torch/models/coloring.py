"""Greedy graph coloring by iterated Luby MIS (torch counterpart of
``p2pnetwork_tpu/models/coloring.py``).

Color class ``c`` is a maximal independent set of the graph with classes
``0..c-1`` removed: each class runs ``LubyMIS`` to quiescence through
``engine.run_until_converged`` with the key ``fold_in(key, c)``, then
leaves the graph by ``failures.with_node_liveness`` (no rebuild). The
coloring is proper on the symmetric graphs the builders make.
"""

from __future__ import annotations

import torch

from p2pnetwork_tpu_torch import _device, prng
from p2pnetwork_tpu_torch.models.mis import LubyMIS
from p2pnetwork_tpu_torch.sim import engine, failures
from p2pnetwork_tpu_torch.sim.graph import Graph


def color_via_mis(graph: Graph, key, *, max_colors: int = 256,
                  max_rounds_per_color: int = 256, method: str = "auto"):
    """Greedy-color ``graph``: ``(colors, n_colors)``, ``colors`` i32[N_pad]
    (-1 on dead and padding nodes). Raises when ``max_colors`` classes
    leave nodes uncolored or a class does not quiesce within
    ``max_rounds_per_color``. ``method`` serves both of ``LubyMIS``'s
    aggregations."""
    proto = LubyMIS(method=method, or_method=method)
    colors = torch.full((graph.n_nodes_padded,), -1, dtype=torch.int32,
                        device=graph.device)
    g = graph
    for c in range(max_colors):
        if not _device.host_bool(g.node_mask.any()):
            return colors, c
        st, out = engine.run_until_converged(
            g, proto, prng.fold_in(key, c), stat="undecided", threshold=1,
            max_rounds=max_rounds_per_color)
        if out["value"] != 0:
            raise RuntimeError(
                f"color class {c} did not quiesce in {max_rounds_per_color} "
                f"rounds ({int(out['value'])} nodes undecided) — raise "
                f"max_rounds_per_color")
        colors = torch.where(st.in_mis, c, colors)
        g = failures.with_node_liveness(g, g.node_mask & ~st.in_mis)
    left = int(g.node_mask.sum().item())
    if left:
        raise RuntimeError(
            f"{left} nodes uncolored after {max_colors} classes — raise "
            f"max_colors (Δ+1 always suffices)")
    return colors, max_colors
