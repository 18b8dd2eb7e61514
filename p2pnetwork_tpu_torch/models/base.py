"""The protocol seam shared by the port's models (torch counterpart of
``p2pnetwork_tpu/models/base.py``).

A protocol is a dataclass of static hyperparameters with
``init(graph) -> state`` and ``step(graph, state) -> (state, stats)``,
where ``stats`` maps names to 0-d device tensors. ``STATS`` names the
stats ``step`` returns, so the engine knows them before any round runs.
Floods draw no random numbers, so the port's protocols take no key.
"""

from __future__ import annotations

from p2pnetwork_tpu_torch.sim.graph import Graph


def validate_source(graph: Graph, source: int) -> None:
    """Reject a source index outside the padded id space. Ids in
    ``[n_nodes, n_nodes_padded)`` are allowed; dead ids are zeroed by the
    ``& node_mask`` every seed applies."""
    if not 0 <= source < graph.n_nodes_padded:
        raise ValueError(
            f"source {source} out of range for padded id space "
            f"[0, {graph.n_nodes_padded})"
        )
