"""graftaudit's rules: what a lowering must never do (the port's
counterpart of ``p2pnetwork_tpu/analysis/ir/rules.py``).

Rules read the census of a :class:`~.registry.Trace` and emit graftlint's
:class:`~p2pnetwork_tpu_torch.analysis.core.Finding` records with the
LOWERING NAME in the file slot (``or/frontier@ws1k:0``). A finding's
baseline identity is ``(rule, lowering, anchor)``: the anchor is the call
its message names first, between backticks (``Tensor.double``), so the
baseline grandfathers one root and not every f64 the lowering makes.

========================  =====  ==============================================
rule                      sev    fires on
========================  =====  ==============================================
``ir-trace-error``        P1     a registry lowering that no longer runs — a
                                 dead entry gates nothing
``ir-host-sync``          P0     a host read of a device tensor inside a
                                 lowering that no ``_device.counted_syncs``
                                 declares: a device->host sync the loop did
                                 not plan
``ir-f64-widen``          P1     a call that makes float64 device values from
                                 none (anchored at the call's name): doubled
                                 bytes on every value it touches
``ir-gather-slot-budget`` P1     a frontier lowering, given a frontier within
                                 its budget, that gathers or scatters more
                                 slots than ``k * span``: the compaction no
                                 longer bounds its work
``ir-sig-parity``         P0     lowerings of one (op, shape-class) group whose
                                 output dtypes and shapes disagree
========================  =====  ==============================================
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from p2pnetwork_tpu_torch.analysis.core import SEVERITIES, Finding
from p2pnetwork_tpu_torch.analysis.ir.registry import Trace

__all__ = ["IRRule", "all_ir_rules", "run_ir_rules", "parity_findings",
           "anchor", "load_ir_baseline", "write_ir_baseline",
           "apply_ir_baseline", "default_baseline_path"]


@dataclasses.dataclass(frozen=True)
class IRRule:
    """One census check: ``run(trace)`` yields messages; id and severity
    are stamped into Findings here."""

    id: str
    severity: str
    doc: str
    run: Callable[[Trace], Iterable[str]]


_IR_RULES: Dict[str, IRRule] = {}  # graftlint: ignore[unbounded-cache] -- rule registry filled once at import by @_register, a fixed vocabulary


def _register(id: str, severity: str, doc: str):
    if severity not in SEVERITIES:
        raise ValueError(f"unknown severity {severity!r}")

    def deco(fn):
        _IR_RULES[id] = IRRule(id=id, severity=severity, doc=doc, run=fn)
        return fn
    return deco


def all_ir_rules() -> Dict[str, IRRule]:
    return dict(_IR_RULES)


def _finding(rule: IRRule, trace: Trace, message: str) -> Finding:
    return Finding(severity=rule.severity, file=trace.entry.name, line=0,
                   col=0, rule=rule.id, message=message)


def run_ir_rules(traces: Sequence[Trace],
                 rules: Dict[str, IRRule] = None) -> List[Finding]:
    """Every rule over every trace, sorted worst-first like graftlint."""
    rules = rules if rules is not None else all_ir_rules()
    out: List[Finding] = []
    for trace in traces:
        for rule in rules.values():
            out.extend(_finding(rule, trace, msg)
                       for msg in rule.run(trace))
    return sorted(out)


# ----------------------------------------------------------------- rules


@_register(
    "ir-trace-error", "P1",
    "A registry lowering failed to run: the audit can no longer see this "
    "code path, so the gate is off for it.")
def rule_trace_error(trace: Trace) -> Iterable[str]:
    if trace.error is not None:
        yield (f"lowering failed to run: {trace.error} — fix the entry or "
               "the code path it names; a lowering that does not run is "
               "ungated")


@_register(
    "ir-host-sync", "P0",
    "A host read of a device tensor that no counted sync declares: a "
    "device->host sync the loop did not plan.")
def rule_host_sync(trace: Trace) -> Iterable[str]:
    if trace.census is None:
        return
    for call, n in sorted(trace.census.undeclared.items()):
        yield (f"`{call}` x{n}: a host read of a device tensor that no "
               "`_device.counted_syncs` counts — a sync per execution on "
               "the card; keep the value on the device, or count the read "
               "where the loop needs it")


@_register(
    "ir-f64-widen", "P1",
    "A call that makes float64 device values from none: doubled bytes on "
    "every value downstream, and a precision the reference does not "
    "compute in.")
def rule_f64_widen(trace: Trace) -> Iterable[str]:
    if trace.census is None:
        return
    rec = trace.census
    for call, n in sorted(rec.f64_widen.items()):
        carried = sum(rec.f64.values()) - sum(rec.f64_widen.values())
        yield (f"`{call}` x{n} widens to float64 ({carried} call(s) carry "
               "float64 on) — compute in f32, or grandfather the root with "
               "its reason")


@_register(
    "ir-gather-slot-budget", "P1",
    "A frontier lowering that, given a frontier within its budget, moves "
    "more slots than k*span: the sparse path no longer bounds its work.")
def rule_gather_slot_budget(trace: Trace) -> Iterable[str]:
    budget = trace.entry.slot_budget
    if budget is None or trace.census is None:
        return
    slots = trace.census.slots
    if not slots:
        yield ("no gather or scatter ran in a lowering with a frontier slot "
               "budget — the compaction has been taken out")
        return
    call, worst = max(sorted(slots.items()), key=lambda kv: kv[1])
    if worst > budget:
        yield (f"`{call}` moves {worst} slots > k*span {budget} on a "
               "frontier within the budget — the compaction no longer "
               "bounds work by the frontier")


# ------------------------------------------------------------ parity gate


def parity_findings(traces: Sequence[Trace]) -> List[Finding]:
    """Every lowering of one ``(op, shape_class)`` parity group must give
    the same output signature; the majority is taken as intended and
    each minority entry gets one P0 finding."""
    groups: Dict[tuple, List[Trace]] = {}
    for t in traces:
        if t.entry.parity and t.out_sig is not None:
            groups.setdefault((t.entry.op, t.entry.shape_class),
                              []).append(t)
    out: List[Finding] = []
    for (op, cls), members in sorted(groups.items()):
        sigs: Dict[str, List[Trace]] = {}
        for t in members:
            sigs.setdefault(t.out_sig, []).append(t)
        if len(sigs) <= 1:
            continue
        majority = max(sigs.values(), key=len)[0].out_sig
        for sig, ts in sorted(sigs.items()):
            if sig == majority:
                continue
            for t in ts:
                out.append(Finding(
                    severity="P0", file=t.entry.name, line=0, col=0,
                    rule="ir-sig-parity",
                    message=(f"output signature diverges from the other "
                             f"`{op}@{cls}` lowerings: {sig} != {majority} "
                             "— variants of one op must be drop-in "
                             "interchangeable")))
    return sorted(out)


# --------------------------------------------------------------- baseline


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def anchor(f: Finding) -> str:
    """The call a finding's message names first (between backticks)."""
    parts = f.message.split("`")
    return parts[1] if len(parts) > 2 else ""


def _key(f: Finding) -> Tuple[str, str, str]:
    return (f.rule, f.file, anchor(f))


def load_ir_baseline(path: Optional[str] = None) -> dict:
    """``{(rule, lowering, anchor): (count, reason)}``; a missing file is
    an empty baseline."""
    path = path or default_baseline_path()
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    out: dict = {}
    for e in data.get("findings", ()):
        key = (e["rule"], e["file"], e.get("code", ""))
        n, _ = out.get(key, (0, ""))
        out[key] = (n + int(e.get("count", 1)), e.get("reason", ""))
    return out


def write_ir_baseline(findings: Sequence[Finding],
                      path: Optional[str] = None) -> str:
    """Grandfather ``findings``, keeping the reasons of entries already in
    the file (a new entry's reason is left for the reviewer to write)."""
    path = path or default_baseline_path()
    old = load_ir_baseline(path)
    counts: Dict[Tuple[str, str, str], int] = {}
    for f in findings:
        counts[_key(f)] = counts.get(_key(f), 0) + 1
    entries = [{"rule": r, "file": fl, "code": c, "count": n,
                "reason": old.get((r, fl, c), (0, ""))[1]}
               for (r, fl, c), n in sorted(counts.items())]
    payload = {
        "comment": ("graftaudit grandfathered findings, each with its "
                    "reason. Entries match on (rule, lowering, the call "
                    "the message names first). Shrink it by fixing "
                    "findings; regenerate with --write-baseline."),
        "findings": entries,
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    return path


def apply_ir_baseline(findings: Sequence[Finding], baseline: dict
                      ) -> Tuple[List[Finding], List[Finding]]:
    """Split into (new, grandfathered); each baseline entry absorbs at
    most its count."""
    budget = {k: n for k, (n, _) in baseline.items()}
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        key = _key(f)
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old
