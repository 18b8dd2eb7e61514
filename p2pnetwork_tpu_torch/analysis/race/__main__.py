"""graftrace CLI: ``python -m p2pnetwork_tpu_torch.analysis.race [options]``.

The dynamic half of the port's analysis gate (graftlint = source AST,
graftrace = executed schedules): run every
builtin scenario across K seeded schedules, report races/deadlocks as
findings through the shared severity/baseline/suppression machinery, and
exit nonzero on anything not baselined. Exit codes match graftlint:
0 — clean; 1 — findings to fix; 2 — bad invocation or a replay that
diverged (nondeterminism is itself a failure).

Typical invocations (``M`` = ``python -m p2pnetwork_tpu_torch.analysis.race``)::

    M                                           # the gate, on the card
    M --device cpu                              # the gate, on the CPU
    M --device cpu --seed 7 --schedules 16      # dig at one seed range
    M --scenario phi_quarantine --trace-dir traces
    M --replay traces/phi_quarantine_s7.json
    M --scenarios-from my_scenarios.py --scenario my_storm
    M --list-scenarios

The watchdog and serving scenarios put their graphs and state on
``--device`` (``cuda`` unless named); without a card, pass ``--device
cpu`` or the run exits 2.

Replay workflow: a failing schedule written with ``--trace-dir`` reruns
byte-identically from its seed; ``--replay FILE`` re-executes it and
verifies the recorded trace step for step before reporting the findings.

Telemetry: every explored schedule counts into
``graftrace_schedules_total`` and every distinct race into
``graftrace_races_total{rule}`` in the default registry.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

from p2pnetwork_tpu_torch import _device, telemetry
from p2pnetwork_tpu_torch.analysis import core
from p2pnetwork_tpu_torch.analysis.race import scenarios as scen
from p2pnetwork_tpu_torch.analysis.race import sched as _sched
from p2pnetwork_tpu_torch.analysis.race.sched import (
    explore, load_replay, write_replay,
)

DEFAULT_SCHEDULES = 8


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graftrace",
        description=("Deterministic schedule exploration + happens-before "
                     "race detection over the seam-routed thread plane. "
                     "Zero non-baselined findings is the CI gate."))
    p.add_argument("--seed", type=int, default=0,
                   help="first schedule seed (default 0)")
    p.add_argument("--schedules", type=int, default=DEFAULT_SCHEDULES,
                   metavar="K",
                   help=f"seeded schedules per scenario (seed..seed+K-1; "
                        f"default {DEFAULT_SCHEDULES})")
    p.add_argument("--scenario", action="append", default=None,
                   metavar="NAME",
                   help="run only this scenario (repeatable)")
    p.add_argument("--scenarios-from", default=None, metavar="FILE",
                   help="import a python file registering extra scenarios "
                        "(they join --scenario selection, not the default "
                        "battery)")
    p.add_argument("--replay", default=None, metavar="FILE",
                   help="re-run the schedule recorded in FILE from its "
                        "seed and verify the trace is byte-identical "
                        "before reporting its findings")
    p.add_argument("--trace-dir", default=None, metavar="DIR",
                   help="write a replay file for every schedule that "
                        "produced findings")
    p.add_argument("--device", default=None, metavar="DEV",
                   help="device of the scenarios' graphs and state "
                        "(default: cuda)")
    p.add_argument("--max-steps", type=int, default=50_000,
                   help="per-schedule step budget (livelock bound)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output (one JSON document)")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help="baseline file (default: the package's checked-in "
                        "analysis/race/baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="report grandfathered findings too (exit code "
                        "still keys on non-baselined ones)")
    p.add_argument("--write-baseline", action="store_true",
                   help="grandfather every current finding and exit 0 "
                        "(races found during development should be FIXED, "
                        "not baselined — this exists for annotating "
                        "refuted hazards and for bootstrap)")
    p.add_argument("--list-scenarios", action="store_true",
                   help="print the scenario table and exit")
    return p


def _load_scenarios_file(path: str) -> None:
    spec = importlib.util.spec_from_file_location(
        f"_graftrace_scenarios_{abs(hash(path))}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)


def _select(names: Optional[List[str]]) -> List[str]:
    if names is None:
        return scen.builtin_names()
    unknown = [n for n in names if n not in scen.SCENARIOS]
    if unknown:
        raise SystemExit(
            f"graftrace: unknown scenario(s): {', '.join(unknown)} "
            "(try --list-scenarios)")
    return list(names)


def _modules_for(findings: List[core.Finding]
                 ) -> Dict[str, core.Module]:
    """Parse each flagged file once so suppressions and baseline
    fingerprints see the same Module view graftlint would."""
    root = _sched._repo_root()
    out: Dict[str, core.Module] = {}
    for f in findings:
        if f.file in out:
            continue
        path = f.file if os.path.isabs(f.file) \
            else os.path.join(root, f.file)
        try:
            with open(path, "r", encoding="utf-8") as fh:
                out[f.file] = core.Module(path, fh.read(), relpath=f.file)
        except (OSError, SyntaxError, ValueError):
            continue  # unsuppressable, unfingerprintable — stays gated
    return out


def _resolve_device(names: List[str], device):
    """The device of the named scenarios' tensors: ``cuda`` unless named,
    resolved (raising without a card) only when one of them places any."""
    if any(scen.SCENARIOS[n].device for n in names):
        return _device.resolve(device)
    return device


def run_battery(names: List[str], *, seed: int, schedules: int,
                max_steps: int = 50_000, trace_dir: Optional[str] = None,
                registry: Optional[telemetry.Registry] = None,
                device=None,
                ) -> Tuple[List[core.Finding], List[dict]]:
    """Explore each scenario across ``schedules`` seeds; returns the
    deduplicated findings and per-scenario stats (the library entry the
    CLI and tests share). ``device`` places the tensors of the scenarios
    that have any (``cuda`` when None; raises without a card)."""
    device = _resolve_device(names, device)
    reg = registry if registry is not None else telemetry.default_registry()
    m_sched = reg.counter(
        "graftrace_schedules_total",
        "Seeded schedules explored by graftrace.")
    m_races = reg.counter(
        "graftrace_races_total",
        "Distinct graftrace findings, by rule.", ("rule",))
    all_findings: List[core.Finding] = []
    seen_keys = set()
    stats: List[dict] = []
    for name in names:
        entry = scen.SCENARIOS[name]
        row = {"scenario": name, "schedules": 0, "steps": 0,
               "findings": 0, "errors": [], "skipped": None}
        try:
            entry.make(device)  # availability probe (imports, deps)
        except scen.ScenarioUnavailable as e:
            row["skipped"] = str(e)
            stats.append(row)
            continue
        for s in range(seed, seed + schedules):
            body = entry.make(device)
            try:
                result = explore(body, seed=s, max_steps=max_steps)
            except Exception as e:
                # A livelocked schedule (ScheduleBudgetExceeded) or a
                # raw-blocking wedge (the step wall timeout) is a
                # verdict on that scenario, not a reason to abandon the
                # rest of the battery with a traceback.
                m_sched.inc()
                row["schedules"] += 1
                row["errors"].append({"seed": s, "task": "<scheduler>",
                                      "error": f"{type(e).__name__}: {e}"})
                f = core.Finding(
                    severity="P1", file=f"<scenario:{name}>", line=0,
                    col=0, rule="graftrace-error",
                    message=(f"schedule aborted: {type(e).__name__}: "
                             f"{e} (seed {s})"))
                key = (f.rule, f.file, f.line, f.message)
                if key not in seen_keys:
                    seen_keys.add(key)
                    all_findings.append(f)
                    m_races.labels(f.rule).inc()
                    row["findings"] += 1
                continue
            m_sched.inc()
            row["schedules"] += 1
            row["steps"] += result.steps
            for name_err in result.errors:
                row["errors"].append({"seed": s, "task": name_err[0],
                                      "error": name_err[1]})
                all_findings.append(core.Finding(
                    severity="P1", file=f"<scenario:{name}>", line=0,
                    col=0, rule="graftrace-error",
                    message=(f"task {name_err[0]} raised "
                             f"{name_err[1]} (seed {s})")))
            fresh = []
            for f in result.findings:
                key = (f.rule, f.file, f.line, f.message)
                if key in seen_keys:
                    continue
                seen_keys.add(key)
                fresh.append(f)
                m_races.labels(f.rule).inc()
            row["findings"] += len(fresh)
            all_findings.extend(fresh)
            if trace_dir and (result.findings or result.errors):
                os.makedirs(trace_dir, exist_ok=True)
                write_replay(
                    os.path.join(trace_dir, f"{name}_s{s}.json"),
                    name, result)
        stats.append(row)
    return sorted(set(all_findings)), stats


def _replay(path: str, as_json: bool, device=None) -> int:
    doc = load_replay(path)
    name = doc["scenario"]
    if name not in scen.SCENARIOS:
        print(f"graftrace: replay names unknown scenario {name!r}",
              file=sys.stderr)
        return 2
    entry = scen.SCENARIOS[name]
    try:
        device = _resolve_device([name], device)
    except RuntimeError as e:
        print(f"graftrace: {e}", file=sys.stderr)
        return 2
    body = entry.make(device)
    result = explore(body, seed=int(doc["seed"]),
                     max_steps=int(doc.get("max_steps", 50_000)))
    recorded = [tuple(row) for row in doc["trace"]]
    if recorded != result.trace:
        divergence = next(
            (i for i, (a, b) in enumerate(zip(recorded, result.trace))
             if a != b), min(len(recorded), len(result.trace)))
        print(f"graftrace: REPLAY DIVERGED at step {divergence} "
              f"(recorded {len(recorded)} steps, got "
              f"{len(result.trace)}) — the scenario is nondeterministic, "
              "which is itself a bug", file=sys.stderr)
        return 2
    if as_json:
        print(json.dumps({
            "scenario": name, "seed": doc["seed"], "replayed": True,
            "identical": True,
            "findings": [f.to_json() for f in result.findings],
            "errors": list(result.errors),
        }, indent=1))
    else:
        print(f"graftrace: replay of {name} seed {doc['seed']} is "
              f"byte-identical ({len(result.trace)} steps)")
        for f in result.findings:
            print(f.render())
        for task_name, err in result.errors:
            print(f"error: task {task_name} raised {err}")
    # Errors fail a replay exactly like findings do: run_battery gated
    # (and recorded) this schedule because of them.
    return 1 if (result.findings or result.errors) else 0


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)

    if args.scenarios_from:
        try:
            _load_scenarios_file(args.scenarios_from)
        except Exception as e:
            # Any failure loading the user's file — missing, unreadable,
            # syntax error, crash at import — is a bad invocation, not a
            # traceback: the documented exit-2 class.
            print(f"graftrace: cannot load {args.scenarios_from}: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            return 2

    if args.list_scenarios:
        width = max((len(n) for n in scen.SCENARIOS), default=10)
        for name, entry in sorted(scen.SCENARIOS.items()):
            tag = "" if entry.builtin else "  [extra]"
            print(f"{name:<{width}}  {entry.doc}{tag}")
        return 0

    if args.replay:
        try:
            return _replay(args.replay, args.as_json, args.device)
        except (OSError, ValueError) as e:
            print(f"graftrace: {e}", file=sys.stderr)
            return 2

    if args.schedules < 1:
        print("graftrace: --schedules must be >= 1", file=sys.stderr)
        return 2

    try:
        names = _select(args.scenario)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2

    try:
        device = _resolve_device(names, args.device)
    except RuntimeError as e:
        # No card for the device scenarios: a bad invocation, not a
        # verdict on the code (the scenarios never ran).
        print(f"graftrace: {e}", file=sys.stderr)
        return 2
    findings, stats = run_battery(
        names, seed=args.seed, schedules=args.schedules,
        max_steps=args.max_steps, trace_dir=args.trace_dir, device=device)

    modules = _modules_for(findings)
    suppressed = [f for f in findings
                  if f.file in modules and modules[f.file].suppressed(f)]
    gated = [f for f in findings
             if not (f.file in modules and modules[f.file].suppressed(f))]

    baseline_path = args.baseline or default_baseline_path()
    if args.write_baseline:
        kept: Dict = {}
        path = core.write_baseline(gated, modules, baseline_path,
                                   keep=kept)
        print(f"graftrace: wrote {len(gated)} finding(s) to {path}")
        return 0

    baseline = core.load_baseline(baseline_path)
    new, grandfathered = core.apply_baseline(gated, modules, baseline)

    skipped = [s for s in stats if s["skipped"]]
    if args.as_json:
        print(json.dumps({
            "findings": [f.to_json() for f in new],
            "baselined": ([f.to_json() for f in grandfathered]
                          if args.no_baseline else len(grandfathered)),
            "suppressed": len(suppressed),
            "scenarios": stats,
            "ok": not new,
        }, indent=1))
        return 1 if new else 0

    for f in new:
        print(f.render())
    if args.no_baseline and grandfathered:
        print(f"-- {len(grandfathered)} baselined finding(s):")
        for f in grandfathered:
            print("   " + f.render())
    for s in skipped:
        print(f"-- skipped {s['scenario']}: {s['skipped']}")
    n_sched = sum(s["schedules"] for s in stats)
    n_steps = sum(s["steps"] for s in stats)
    if new:
        print(f"graftrace: {len(new)} finding(s) over {n_sched} "
              f"schedule(s); {len(grandfathered)} baselined")
        return 1
    suffix = f" ({len(grandfathered)} baselined)" if grandfathered else ""
    print(f"graftrace: clean{suffix} — {len(stats) - len(skipped)} "
          f"scenario(s), {n_sched} schedule(s), {n_steps} steps")
    return 0


def _cli() -> int:
    try:
        return main()
    except BrokenPipeError:
        return 0


if __name__ == "__main__":
    sys.exit(_cli())
