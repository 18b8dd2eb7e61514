"""graftaudit's cost ratchet: each lowering's census, pinned per PR (the
port's counterpart of ``p2pnetwork_tpu/analysis/ir/budgets.py``).

The reference prices a compiled program by its compiler's cost analysis.
The port prices one run of a lowering by its census (``census.py``): the
launches (tensor-producing torch calls plus hand-written kernel
launches), each kernel's launches by name, the host syncs and uploads,
the bytes the calls touch and, on the ring, the exchange census and its
byte estimate. A census counts function calls, not aten ops, and a kernel
counts as its launches whichever twin runs, so the numbers are the same on
the CPU and on the card and do not drift with torch's decompositions.

The counts are held EXACTLY: one more launch a round, or one more sync,
is the regression this gate exists for. Bytes (and the exchange byte
estimate) are held within ``tolerance`` (0.2, stored in the file), and a
shrink past it asks for a re-bless, as in the reference. Stale entries
fail; ``--write-budgets`` blesses (commit the diff: it is the review
artifact); the file records the torch it was blessed on.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

from p2pnetwork_tpu_torch.analysis.core import Finding
from p2pnetwork_tpu_torch.analysis.ir.registry import (Trace,
                                                       parse_shape_class)

__all__ = ["collect_costs", "load_budgets", "write_budgets",
           "check_budgets", "default_budgets_path", "DEFAULT_TOLERANCE",
           "EXACT_METRICS", "TOLERANT_METRICS", "SCHEMA"]

SCHEMA = "graftaudit-budgets-torch-v1"
DEFAULT_TOLERANCE = 0.20
#: Held exactly (a count).
EXACT_METRICS = ("launches", "syncs", "uploads")
#: Held within the tolerance.
TOLERANT_METRICS = ("bytes", "ici_bytes_est")


def default_budgets_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "budgets.json")


def cost_of(trace: Trace) -> dict:
    """The cost record of one traced lowering."""
    rec = trace.census
    out = {"launches": rec.launches, "kernels": dict(sorted(
        rec.kernels.items())), "syncs": rec.syncs, "uploads": rec.uploads,
        "bytes": rec.bytes}
    if trace.entry.n_shards > 1:
        out["exchanges"] = dict(sorted(trace.exchanges.items()))
        out["ici_bytes_est"] = int(trace.ici_bytes_est)
    return out


def collect_costs(traces: Sequence[Trace]) -> Dict[str, dict]:
    """``{name: cost record}`` of every lowering that ran (a failed one
    already fired ``ir-trace-error``)."""
    return {t.entry.name: cost_of(t) for t in traces if t.error is None}


def load_budgets(path: Optional[str] = None) -> dict:
    """The checked-in budget document (``{}`` when absent)."""
    path = path or default_budgets_path()
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def write_budgets(costs: Dict[str, dict], path: Optional[str] = None,
                  tolerance: float = DEFAULT_TOLERANCE) -> str:
    """Bless the current costs as the new budgets."""
    import torch

    path = path or default_budgets_path()
    payload = {
        "schema": SCHEMA,
        "comment": ("graftaudit cost budgets: each lowering's census "
                    "(analysis/ir/census.py) of one run at the 1k "
                    "shape-classes. Counts (launches, kernels, syncs, "
                    "uploads, exchanges) are held exactly, bytes within "
                    "`tolerance`; bless deliberate changes with "
                    "`python -m p2pnetwork_tpu_torch.analysis.ir --device "
                    "cpu --write-budgets` and commit the diff."),
        "torch": torch.__version__,
        "tolerance": tolerance,
        "entries": {k: costs[k] for k in sorted(costs)},
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    return path


def _ratchet(name: str, message: str, severity: str = "P1") -> Finding:
    return Finding(severity=severity, file=name, line=0, col=0,
                   rule="ir-cost-ratchet", message=message)


def _class_of(name: str) -> str:
    """The shape-class suffix of a lowering name (a stale row must say
    which class's record went stale)."""
    cls = name.rsplit("@", 1)[-1] if "@" in name else "?"
    try:
        parse_shape_class(cls)
        return cls
    except ValueError:
        return "?"


def check_budgets(costs: Dict[str, dict], budgets: dict,
                  tolerance: Optional[float] = None,
                  skipped: Optional[Sequence[str]] = None) -> List[Finding]:
    """Current costs against the blessed budgets. Fails on any change of
    a count (launches, syncs, uploads, a kernel's launches, the exchange
    census), bytes past the tolerance either way (a shrink is P2: bless
    the win), new lowerings without a budget (P2), stale entries (P2) and
    blessed error records. ``skipped`` names lowerings this run could not
    audit; their entries are not stale."""
    entries = budgets.get("entries", {})
    if tolerance is None:
        tolerance = float(budgets.get("tolerance", DEFAULT_TOLERANCE))
    out: List[Finding] = []
    for name, cost in sorted(costs.items()):
        budget = entries.get(name)
        if budget is None:
            out.append(_ratchet(
                name, "new lowering with no blessed budget — run "
                      "`--write-budgets` and commit budgets.json",
                severity="P2"))
            continue
        if "error" in budget:
            out.append(_ratchet(
                name, "blessed budget is an error record — nothing to "
                      "ratchet against; re-bless with --write-budgets "
                      "once the lowering runs"))
            continue
        for metric in EXACT_METRICS:
            have, want = cost.get(metric), budget.get(metric)
            if want is not None and have != want:
                out.append(_ratchet(
                    name, f"{metric} changed: {want} -> {have} (held "
                          "exactly) — explain it, or bless it with "
                          "--write-budgets"))
        for metric in ("kernels", "exchanges"):
            have = dict(cost.get(metric, {}))
            want = dict(budget.get(metric, {}))
            if have != want:
                out.append(_ratchet(
                    name, f"{metric} census changed: {want} -> {have} — "
                          "verify the launches and hops, then bless"))
        for metric in TOLERANT_METRICS:
            have, want = cost.get(metric), budget.get(metric)
            if have is None or want is None or want <= 0:
                continue
            ratio = have / want
            if ratio > 1.0 + tolerance:
                out.append(_ratchet(
                    name, f"{metric} grew {ratio:.2f}x over budget "
                          f"({have} vs {want}, tolerance {tolerance:.0%}) "
                          "— explain the regression or bless it with "
                          "--write-budgets"))
            elif ratio < 1.0 - tolerance:
                out.append(_ratchet(
                    name, f"{metric} shrank to {ratio:.2f}x of budget "
                          f"({have} vs {want}) — bless it "
                          "(--write-budgets) so the ratchet holds the new "
                          "level", severity="P2"))
    stale = sorted(set(entries) - set(costs) - set(skipped or ()))
    for name in stale:
        out.append(_ratchet(
            name, f"budget entry for a lowering the registry no longer "
                  f"produces (shape-class {_class_of(name)}) — regenerate "
                  "budgets.json (--write-budgets) so the file matches "
                  "HEAD", severity="P2"))
    return sorted(out)
