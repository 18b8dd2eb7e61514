"""graftaudit's carry audit (the port's counterpart of
``p2pnetwork_tpu/analysis/ir/donation.py``).

The reference donates each engine loop's state carry, so a run never holds
two copies of it, and audits that its compiler honoured the donation.
Torch has no donation: the port's loops return a new state and drop the
old one (``sim/engine.py``). What donation protected is the property this
audit holds: a run never keeps two carries alive. Each of the reference's
eleven carry programs, under the reference's names, runs for ``r`` and
``2r`` rounds (and one) under the live-storage tracker
(``census.LiveTracker``):

- ``ir-carry-retained`` (P1): the peak grows with the rounds by more than
  the stats rows a run keeps (``ROW_BYTES`` a round): a loop that keeps
  each round's carry, as a list of states would;
- ``ir-carry-doubled`` (P1): the peak at ``r`` rounds exceeds a one-round
  run's (the new carry and the step's temporaries) by more than one carry
  (the previous round's, which the step reads) and the stats rows: a loop
  that holds a second carry for its whole run;
- ``ir-carry-unverifiable`` (P1): the program failed to run.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from p2pnetwork_tpu_torch.analysis.core import Finding
from p2pnetwork_tpu_torch.analysis.ir.registry import flatten, shape_class

__all__ = ["CarryAudit", "all_carry_audits", "measure_carry", "audit_carry",
           "ROW_BYTES", "SLACK_BYTES", "ROUNDS"]

#: Bytes a round may add for the stats rows a run keeps: up to 8 scalar
#: stats in their copies (the per-round row, its f64 table row and its
#: host columns).
ROW_BYTES = 256
#: Bytes of the loop's own scalars (round counts, flags, totals).
SLACK_BYTES = 1024
#: The audit's ``r``: each program runs 1, ``r`` and ``2r`` rounds.
ROUNDS = 3


@dataclasses.dataclass(frozen=True)
class CarryAudit:
    """One carry program: ``build(device)`` returns ``(run, carry)``,
    ``run(rounds)`` a run of that many rounds from ``carry`` (the input
    state, whose storages are not the run's)."""

    name: str
    build: Callable
    doc: str = ""


def _flood_state(g):
    from p2pnetwork_tpu_torch.analysis.ir.registry import _resume_state

    return _resume_state(g)


def _pushsum_state(g):
    import torch

    from p2pnetwork_tpu_torch.models.pushsum import PushSumState

    n = g.n_nodes_padded
    return PushSumState(s=torch.linspace(0.0, 1.0, n, device=g.device),
                        w=torch.ones(n, device=g.device))


def all_carry_audits() -> List[CarryAudit]:
    """The engine's carry programs, under the reference's names."""
    from p2pnetwork_tpu_torch import prng

    def recorder(rec):
        from p2pnetwork_tpu_torch.sim import flightrec

        return flightrec.FlightRecorder(capacity=64) if rec else None

    def run_from(rec):
        def build(device):
            from p2pnetwork_tpu_torch.models.flood import Flood
            from p2pnetwork_tpu_torch.sim import engine

            g = shape_class("ws1k", device)
            state = _flood_state(g)
            return (lambda r: engine.run_from(
                g, Flood(source=0), state, prng.key(0), r,
                recorder=recorder(rec))), state
        return build

    def coverage_from(rec):
        def build(device):
            from p2pnetwork_tpu_torch.models.flood import Flood
            from p2pnetwork_tpu_torch.sim import engine

            g = shape_class("ws1k", device)
            state = _flood_state(g)
            # A target past 1 keeps the loop to its max_rounds.
            return (lambda r: engine.run_until_coverage_from(
                g, Flood(source=0), state, prng.key(0),
                coverage_target=2.0, max_rounds=r,
                recorder=recorder(rec))), state
        return build

    def converged_from(device):
        from p2pnetwork_tpu_torch.models.pushsum import PushSum
        from p2pnetwork_tpu_torch.sim import engine

        g = shape_class("ws1k", device)
        state = _pushsum_state(g)
        return (lambda r: engine.run_until_converged(
            g, PushSum(), prng.key(0), stat="variance", threshold=-1.0,
            max_rounds=r, state0=state)), state

    def batch_from(rec, repad=False):
        def build(device):
            from p2pnetwork_tpu_torch.models.messagebatch import BatchFlood
            from p2pnetwork_tpu_torch.sim import engine
            from p2pnetwork_tpu_torch.sim import graph as G

            g = shape_class("ws1k", device)
            proto = BatchFlood(method="auto")
            batch = proto.init(g, np.arange(32, dtype=np.int32) * 11 % 900)
            if repad:
                # Across the pad boundary (live growth): the zero-extended
                # batch runs on the grown graph like the original.
                g = G.grow(g, 200)
                batch = proto.repad(batch, g.n_nodes_padded)
            return (lambda r: engine.run_batch_until_coverage(
                g, proto, batch, prng.key(0), max_rounds=r,
                recorder=recorder(rec))), batch
        return build

    def query_from(rec):
        def build(device):
            from p2pnetwork_tpu_torch.models.querybatch import MinPlusQueries
            from p2pnetwork_tpu_torch.sim import engine

            g = shape_class("ws1k", device)
            proto = MinPlusQueries(method="auto")
            qb = proto.init(g, np.arange(8, dtype=np.int32) * 11 % 900,
                            np.arange(8, dtype=np.int32) * 37 % 900)
            return (lambda r: engine.run_queries_until_done(
                g, proto, qb, prng.key(0), max_rounds=r,
                recorder=recorder(rec))), qb
        return build

    def sharded_batch_from(device):
        from p2pnetwork_tpu_torch.models.messagebatch import BatchFlood
        from p2pnetwork_tpu_torch.parallel import mesh as M
        from p2pnetwork_tpu_torch.parallel import sharded as SH

        g = shape_class("ws1k", device)
        mesh = M.ring_mesh(8, device=g.device)
        sg = SH.shard_graph(g, mesh)
        batch = BatchFlood().init(g, np.arange(32, dtype=np.int32) * 11 % 900)
        return (lambda r: SH.run_batch_until_coverage(
            sg, mesh, BatchFlood(), batch, max_rounds=r,
            comm="ppermute")), batch

    return [
        CarryAudit("engine/run_from", run_from(False),
                   "fixed-rounds resume loop (engine.run_from)"),
        CarryAudit("sharded/batch_from", sharded_batch_from,
                   "the ring's batched loop "
                   "(parallel/sharded.run_batch_until_coverage)"),
        CarryAudit("engine/coverage_from", coverage_from(False),
                   "run-to-coverage resume loop "
                   "(engine.run_until_coverage_from)"),
        CarryAudit("engine/converged_from", converged_from,
                   "run-to-convergence loop (engine.run_until_converged)"),
        CarryAudit("engine/batch_from", batch_from(False),
                   "batched loop (engine.run_batch_until_coverage)"),
        CarryAudit("engine/batch_from_repad", batch_from(False, repad=True),
                   "batched loop after a live repad (graph.grow + "
                   "BatchFlood.repad)"),
        CarryAudit("engine/query_from", query_from(False),
                   "batched query loop (engine.run_queries_until_done)"),
        CarryAudit("engine/query_from_rec", query_from(True),
                   "batched query loop with the flight recorder"),
        CarryAudit("engine/run_from_rec", run_from(True),
                   "fixed-rounds resume loop with the flight recorder"),
        CarryAudit("engine/coverage_from_rec", coverage_from(True),
                   "run-to-coverage resume loop with the flight recorder"),
        CarryAudit("engine/batch_from_rec", batch_from(True),
                   "batched loop with the flight recorder"),
    ]


def _peak(run, rounds: int, carry, device) -> int:
    from p2pnetwork_tpu_torch.analysis.ir import census as C

    with C.run_census(device, track=True, inputs=flatten(carry)) as c:
        result = run(rounds)
        del result
    return c.tracker.peak


def _carry_bytes(carry) -> int:
    seen, total = set(), 0
    for t in flatten(carry):
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            total += st.nbytes()
    return total


def measure_carry(audit: CarryAudit, device=None) -> dict:
    """``{"carry", "peak_1", "peak_r", "peak_2r", "rounds"}`` of one
    program on ``device`` (the card unless named)."""
    from p2pnetwork_tpu_torch import _device

    dev = _device.resolve(device)
    run, carry = audit.build(dev)
    rounds = ROUNDS
    return {"rounds": rounds, "carry": _carry_bytes(carry),
            "peak_1": _peak(run, 1, carry, dev),
            "peak_r": _peak(run, rounds, carry, dev),
            "peak_2r": _peak(run, 2 * rounds, carry, dev)}


def carry_findings(name: str, m: dict) -> List[Finding]:
    """The rules over one measurement (module doc)."""
    r = m["rounds"]
    out: List[Finding] = []
    growth = m["peak_2r"] - m["peak_r"]
    if growth > r * ROW_BYTES + SLACK_BYTES:
        out.append(Finding(
            severity="P1", file=name, line=0, col=0,
            rule="ir-carry-retained",
            message=(f"peak live bytes grow with the rounds: {m['peak_r']} "
                     f"at {r} rounds, {m['peak_2r']} at {2 * r} (+{growth}, "
                     f"the stats rows allow {r * ROW_BYTES}) — the loop "
                     "keeps each round's carry (a carry of "
                     f"{m['carry']} bytes)")))
    bound = m["peak_1"] + m["carry"] + r * ROW_BYTES + SLACK_BYTES
    if m["peak_r"] > bound:
        out.append(Finding(
            severity="P1", file=name, line=0, col=0,
            rule="ir-carry-doubled",
            message=(f"peak live bytes {m['peak_r']} at {r} rounds exceed "
                     f"one round's {m['peak_1']} plus one carry "
                     f"({m['carry']}) and the stats rows (bound {bound}) — "
                     "the loop holds a second carry")))
    return out


def audit_carry(audits: Optional[List[CarryAudit]] = None, device=None
                ) -> List[Finding]:
    """Run every carry program and return the findings, worst first."""
    out: List[Finding] = []
    for audit in (audits if audits is not None else all_carry_audits()):
        try:
            m = measure_carry(audit, device)
        except Exception as e:  # noqa: BLE001 — failure IS the finding
            out.append(Finding(
                severity="P1", file=audit.name, line=0, col=0,
                rule="ir-carry-unverifiable",
                message=f"the carry program failed to run: "
                        f"{type(e).__name__}: {e}"))
            continue
        out.extend(carry_findings(audit.name, m))
    return sorted(out)
