"""Bracha reliable broadcast — Byzantine-tolerant delivery, batched (torch
counterpart of ``p2pnetwork_tpu/models/bracha.py``).

With ``n >= 3f + 1`` nodes of which at most ``f`` are Byzantine, every
honest node delivers the same value, the broadcaster's when it is honest.
Per round: INITIAL (round 1) from the broadcaster; ECHO(v) on INITIAL(v),
at most once; READY(v) on ``2f+1`` ECHO(v) or ``f+1`` READY(v), at most
once; deliver v on ``2f+1`` READY(v). The ids in ``byzantine`` equivocate
by receiver parity from round 1 on.

Each threshold count is one ``propagate_sum`` of a 0/1 f32 signal under
the protocol's ``method`` (B1's sum entry under ``pallas`` and
``hybrid``): two at ``init`` (the Byzantine in-neighbor count and the
broadcaster's reach) and four a round (ECHO and READY, per value). The
counts are small integers in f32, exact in every method. ``messages`` is
an f32 sum of out-degrees, as the reference's (exact below 2**24 a
term). Deterministic: no random number is drawn.
"""

from __future__ import annotations

import dataclasses

import torch

from p2pnetwork_tpu_torch.models import base
from p2pnetwork_tpu_torch.ops import segment
from p2pnetwork_tpu_torch.sim.graph import Graph


@dataclasses.dataclass(frozen=True)
class BrachaState:
    echo_sent: torch.Tensor  # bool[N_pad, 2] — ECHO(v) broadcast
    ready_sent: torch.Tensor  # bool[N_pad, 2] — READY(v) broadcast
    value: torch.Tensor  # i32[N_pad] — delivered value; -1 undelivered
    round: torch.Tensor  # i32[]
    byz_in: torch.Tensor  # f32[N_pad] — Byzantine in-neighbor count
    from_src: torch.Tensor  # bool[N_pad] — broadcaster reaches this node


@dataclasses.dataclass(frozen=True)
class Bracha:
    """Byzantine reliable broadcast with a parity-equivocating adversary.
    ``f`` sets the quorum thresholds (``2f+1`` / ``f+1``); ``method`` is
    ``propagate_sum``'s lowering."""

    source: int = 0
    source_value: int = 1
    f: int = 1
    byzantine: tuple = ()
    method: str = "auto"

    STATS = ("messages", "changed", "delivered", "coverage", "agreement")
    RUNS_ON_PART = True

    def __post_init__(self):
        if self.source_value not in (0, 1):
            raise ValueError("source_value must be 0 or 1")
        if self.f < 0:
            raise ValueError("f must be >= 0")

    def _byz_mask(self, graph: Graph) -> torch.Tensor:
        m = torch.zeros_like(graph.node_mask)
        for b in self.byzantine:  # scalar fills: no host->device copy
            m[b] = True
        return m & graph.node_mask

    def _one(self, graph: Graph, sig: torch.Tensor) -> torch.Tensor:
        return segment.propagate_sum(graph, sig.to(torch.float32),
                                     self.method)

    def init(self, graph: Graph, key) -> BrachaState:
        base.validate_source(graph, self.source)
        for b in self.byzantine:
            if not 0 <= b < graph.n_nodes_padded:
                raise ValueError(
                    f"byzantine id {b} out of range for padded id space "
                    f"[0, {graph.n_nodes_padded})")
        n_pad, dev = graph.n_nodes_padded, graph.device
        src_hot = base.source_seed(graph, self.source)
        return BrachaState(
            echo_sent=torch.zeros((n_pad, 2), dtype=torch.bool, device=dev),
            ready_sent=torch.zeros((n_pad, 2), dtype=torch.bool, device=dev),
            value=torch.full((n_pad,), -1, dtype=torch.int32, device=dev),
            round=torch.zeros((), dtype=torch.int32, device=dev),
            byz_in=self._one(graph, self._byz_mask(graph)),
            # Every node "sends to itself" too (standard quorum counting).
            from_src=(self._one(graph, src_hot) > 0) | src_hot)

    def coverage(self, graph: Graph, state: BrachaState) -> torch.Tensor:
        """Delivered fraction of live honest nodes (f32)."""
        honest = graph.node_mask & ~self._byz_mask(graph)
        n = honest.sum().clamp_min(1)
        return (((state.value >= 0) & honest).sum().to(torch.float32)
                / n.to(torch.float32))

    def step(self, graph: Graph, state: BrachaState, key):
        n_pad = graph.n_nodes_padded
        parity = torch.arange(n_pad, dtype=torch.int32,
                              device=graph.device) % 2
        byz = self._byz_mask(graph)
        honest = graph.node_mask & ~byz
        rnd = state.round + 1

        # The Byzantine ECHO/READY for value v land on receivers of
        # parity v, every round.
        byz_for = torch.stack([torch.where(parity == 0, state.byz_in, 0.0),
                               torch.where(parity == 1, state.byz_in, 0.0)],
                              dim=1)

        # INITIAL: round 1 only; a Byzantine source equivocates by parity.
        init_val = torch.where(byz[self.source], parity, self.source_value)
        got_initial = state.from_src & (rnd == 1)
        initial = torch.stack([got_initial & (init_val == 0),
                               got_initial & (init_val == 1)], dim=1)

        def counted(sent):
            own = (sent & honest[:, None]).to(torch.float32)
            return torch.stack([self._one(graph, sent[:, 0] & honest),
                                self._one(graph, sent[:, 1] & honest)],
                               dim=1) + byz_for + own

        echo_cnt = counted(state.echo_sent)
        ready_cnt = counted(state.ready_sent)
        q_echo = q_deliver = float(2 * self.f + 1)
        q_amp = float(self.f + 1)

        never_echoed = ~state.echo_sent.any(dim=1)
        new_echo = initial & never_echoed[:, None] & honest[:, None]
        echo_sent = state.echo_sent | new_echo

        # READY: at most one value ever; simultaneous crossings break
        # toward the larger count, then value 0.
        ready_ok = (echo_cnt >= q_echo) | (ready_cnt >= q_amp)
        never_ready = ~state.ready_sent.any(dim=1)
        pick1 = ready_ok[:, 1] & (~ready_ok[:, 0]
                                  | (ready_cnt[:, 1] > ready_cnt[:, 0]))
        pick = torch.stack([ready_ok[:, 0] & ~pick1, pick1], dim=1)
        new_ready = pick & never_ready[:, None] & honest[:, None]
        ready_sent = state.ready_sent | new_ready

        # DELIVER on 2f+1 READYs, once; both values at once picks 0.
        deliver = ((ready_cnt >= q_deliver) & (state.value == -1)[:, None]
                   & honest[:, None])
        value = torch.where(deliver[:, 0], 0,
                            torch.where(deliver[:, 1], 1, state.value)
                            ).to(torch.int32)

        new_state = BrachaState(echo_sent=echo_sent, ready_sent=ready_sent,
                                value=value, round=rnd, byz_in=state.byz_in,
                                from_src=state.from_src)
        any0 = ((value == 0) & honest).any()
        any1 = ((value == 1) & honest).any()
        changed = (new_echo.sum() + new_ready.sum()
                   + (value != state.value).sum())
        out_deg = graph.out_degree.to(torch.float32)
        first = torch.where(rnd == 1, out_deg[self.source], 0.0)
        stats = {
            "messages": ((new_echo.any(dim=1) * out_deg).sum()
                         + (new_ready.any(dim=1) * out_deg).sum()
                         + first + torch.where(byz, out_deg, 0.0).sum()),
            "changed": changed,
            "delivered": ((value >= 0) & honest).sum(),
            "coverage": self.coverage(graph, new_state),
            "agreement": (~(any0 & any1)).to(torch.int32),
        }
        return new_state, stats
