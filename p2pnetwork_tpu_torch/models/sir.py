"""SIR epidemic / rumor spread (torch counterpart of
``p2pnetwork_tpu/models/sir.py``).

Nodes are Susceptible / Infected / Recovered. Each round an infected node
transmits along each out-edge with probability ``beta``, so a susceptible
node with ``k`` infected in-neighbors escapes with ``(1-beta)^k``, and an
infected node recovers with probability ``gamma``. The infection pressure
``k`` is one ``propagate_sum`` per round (B1's sum entry under the
``pallas`` and ``hybrid`` methods); the two draws per round come from
``prng.py``, bit for bit the reference's.

``(1-beta)^k`` is read from a table of ``k = 0..K`` made once per
``(beta, K)`` on the host, ``K`` the graph's largest possible in-degree
(static edges plus dynamic slots, known on the host at build time, so no
sync). Each entry is ``f32(1 - beta)`` raised in f64 and rounded to f32,
which equals the reference's ``jnp.power`` for small ``k`` (every ``k``
below 95 at ``beta = 0.3``; ROADMAP §C lists where they part), and is the
same number on the card and the CPU. ``torch.pow`` is not: it differs
from ``jnp.power`` on the CPU, and CUDA's ``powf`` is not correctly
rounded.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from p2pnetwork_tpu_torch import prng
from p2pnetwork_tpu_torch.models import base
from p2pnetwork_tpu_torch.models.flood import _over_live
from p2pnetwork_tpu_torch.ops import segment
from p2pnetwork_tpu_torch.sim.graph import Graph

SUSCEPTIBLE = 0
INFECTED = 1
RECOVERED = 2


@dataclasses.dataclass(frozen=True)
class SIRState:
    status: torch.Tensor  # i32[N_pad] in {0, 1, 2}


def escape_table_host(beta: float, k_max: int) -> np.ndarray:
    """f32 ``(1 - beta)^k`` for ``k = 0..k_max``: the f32 base raised in
    f64, rounded once to f32."""
    base_ = np.float64(np.float32(1.0 - beta))
    return (base_ ** np.arange(k_max + 1, dtype=np.float64)).astype(
        np.float32)


@functools.lru_cache(maxsize=16)
def _escape_table(beta: float, k_max: int, device: torch.device):
    return torch.from_numpy(escape_table_host(beta, k_max)).to(device)


def max_pressure(graph: Graph) -> int:
    """The largest in-degree a node can have: the widest static in-run
    plus every dynamic slot (host ints, no device read)."""
    dyn = 0 if graph.dyn_senders is None else graph.dyn_senders.shape[0]
    return graph.max_in_span + dyn


@dataclasses.dataclass(frozen=True)
class SIR:
    beta: float = 0.3  # per-edge transmission probability per round
    gamma: float = 0.1  # per-round recovery probability
    source: int = 0
    method: str = "auto"

    STATS = ("messages", "s_frac", "i_frac", "r_frac", "coverage")
    RUNS_ON_PART = True

    def init(self, graph: Graph, key) -> SIRState:
        base.validate_source(graph, self.source)
        status = torch.zeros(graph.n_nodes_padded, dtype=torch.int32,
                             device=graph.device)
        status[self.source] = INFECTED
        return SIRState(status=status * graph.node_mask)

    def coverage(self, graph: Graph, state: SIRState) -> torch.Tensor:
        """Ever-infected fraction (matches the ``coverage`` stat)."""
        return _over_live(((state.status != SUSCEPTIBLE)
                           & graph.node_mask).sum(), graph)

    def step(self, graph: Graph, state: SIRState, key):
        k_inf, k_rec = prng.split(key)
        dev, n = graph.device, graph.n_nodes_padded
        infected = (state.status == INFECTED) & graph.node_mask
        susceptible = (state.status == SUSCEPTIBLE) & graph.node_mask

        # k = number of infected in-neighbors (an exact integer in f32).
        pressure = segment.propagate_sum(graph, infected.to(torch.float32),
                                         self.method, exact=False)
        escape = _escape_table(float(self.beta), max_pressure(graph), dev)
        p_infect = 1.0 - escape[pressure.long()]
        newly_infected = susceptible & (prng.uniform(k_inf, n, device=dev)
                                        < p_infect)
        recovers = infected & (prng.uniform(k_rec, n, device=dev)
                               < float(np.float32(self.gamma)))

        status = torch.where(newly_infected, INFECTED, state.status)
        status = torch.where(recovers, RECOVERED, status)

        def frac(code):
            return _over_live(((status == code) & graph.node_mask).sum(),
                              graph)

        stats = {
            # Every infected node transmits along each outgoing edge.
            "messages": segment.frontier_messages(graph, infected),
            "s_frac": frac(SUSCEPTIBLE),
            "i_frac": frac(INFECTED),
            "r_frac": frac(RECOVERED),
            "coverage": _over_live(((status != SUSCEPTIBLE)
                                    & graph.node_mask).sum(), graph),
        }
        return SIRState(status=status), stats
