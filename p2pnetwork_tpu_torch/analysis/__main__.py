"""graftlint CLI: ``python -m p2pnetwork_tpu_torch.analysis [paths...]``.

Exit codes: 0 — no non-baselined findings; 1 — findings to fix; 2 — bad
invocation. Stdlib-only, so the gate runs without torch and costs a few
seconds of wall time on the whole package.

Typical invocations::

    python -m p2pnetwork_tpu_torch.analysis p2pnetwork_tpu_torch/   # the CI gate
    python -m p2pnetwork_tpu_torch.analysis --json some/file.py
    python -m p2pnetwork_tpu_torch.analysis --no-baseline p2pnetwork_tpu_torch/
    python -m p2pnetwork_tpu_torch.analysis --write-baseline p2pnetwork_tpu_torch/
    python -m p2pnetwork_tpu_torch.analysis --list-rules
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

from p2pnetwork_tpu_torch.analysis import core


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graftlint",
        description=("AST analysis for lock discipline and unbounded "
                     "caches. Zero non-baselined findings is the CI "
                     "gate; suppress judged-acceptable sites inline with "
                     "`# graftlint: ignore[rule-id] -- rationale`."))
    p.add_argument("paths", nargs="*", default=["p2pnetwork_tpu_torch"],
                   help="files or directories to analyze "
                        "(default: p2pnetwork_tpu_torch)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output (one JSON document)")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help="baseline file (default: the package's checked-in "
                        "analysis/baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="report grandfathered findings too (exit code "
                        "still keys on non-baselined ones)")
    p.add_argument("--write-baseline", action="store_true",
                   help="grandfather every current finding into the "
                        "baseline file and exit 0 (refused with --rules/"
                        "--severity: a filtered run must not overwrite "
                        "other rules' grandfathered entries)")
    p.add_argument("--no-suppressions", action="store_true",
                   help="report inline-suppressed findings as well "
                        "(audit mode; does not affect the exit code)")
    p.add_argument("--root", default=None, metavar="DIR",
                   help="directory reported file paths (and baseline "
                        "entries) are relative to; default: this "
                        "package's repository root when it contains "
                        "every analyzed path, else the current directory "
                        "— so the gate matches its baseline from any cwd")
    p.add_argument("--rules", default=None, metavar="ID[,ID...]",
                   help="run only these rule ids")
    p.add_argument("--severity", default=None, choices=core.SEVERITIES,
                   metavar="P0..P3",
                   help="only report findings at or above this severity")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    return p


def _select_rules(spec: Optional[str]) -> Dict[str, core.Rule]:
    rules = core.all_rules()
    if spec is None:
        return rules
    wanted = [r.strip() for r in spec.split(",") if r.strip()]
    unknown = [r for r in wanted if r not in rules]
    if unknown:
        raise SystemExit(f"graftlint: unknown rule(s): {', '.join(unknown)}"
                         f" (try --list-rules)")
    return {r: rules[r] for r in wanted}


def _resolve_root(root_arg: Optional[str], paths: Sequence[str]) -> str:
    """Directory file paths are reported relative to. The baseline keys on
    these paths, so the gate must resolve them identically from ANY cwd:
    prefer this package's repository root whenever it contains everything
    analyzed — a run from any subdirectory of the checkout (or from an
    arbitrary directory) then keys files exactly as the checked-in
    baseline does — and fall back to the cwd otherwise (other projects,
    tmp-dir test fixtures)."""
    if root_arg is not None:
        return os.path.abspath(root_arg)
    cwd = os.getcwd()
    abs_paths = [os.path.abspath(p) for p in paths]

    def under(base: str) -> bool:
        try:
            return all(os.path.commonpath([p, base]) == base
                       for p in abs_paths)
        except ValueError:  # different drives (windows)
            return False

    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(core.__file__))))
    if under(repo_root):
        return repo_root
    return cwd


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)

    if args.list_rules:
        rules = core.all_rules()
        width = max(len(r) for r in rules)
        for rule in sorted(rules.values(),
                           key=lambda r: (r.severity, r.id)):
            print(f"{rule.id:<{width}}  {rule.severity}  {rule.doc}")
        return 0

    if args.write_baseline and (args.rules or args.severity):
        print("graftlint: refusing --write-baseline on a filtered run "
              "(--rules/--severity): it would silently drop every other "
              "rule's grandfathered entries. Rerun unfiltered.",
              file=sys.stderr)
        return 2

    rules = _select_rules(args.rules)
    modules: Dict[str, core.Module] = {}
    # Analyze with suppressions OFF and split afterwards: the audit view
    # (--no-suppressions) must never leak suppressed findings into the
    # gating set, so the exit code stays identical either way.
    try:
        findings = core.analyze_paths(
            args.paths, rules=rules,
            root=_resolve_root(args.root, args.paths),
            respect_suppressions=False, collect_sources=modules)
    except FileNotFoundError as e:
        # A missing target is a broken invocation, not a clean tree.
        print(f"graftlint: {e}", file=sys.stderr)
        return 2
    if args.severity is not None:
        cutoff = core.SEVERITIES.index(args.severity)
        findings = [f for f in findings
                    if core.SEVERITIES.index(f.severity) <= cutoff]
    suppressed = [f for f in findings
                  if f.file in modules and modules[f.file].suppressed(f)]
    gated = [f for f in findings
             if not (f.file in modules and modules[f.file].suppressed(f))]

    if args.write_baseline:
        # A path-subset run (`--write-baseline some/dir`) must not drop
        # grandfathered entries belonging to files it never analyzed —
        # the same hazard the --rules/--severity refusal above guards.
        # Keep those verbatim; entries for analyzed files are replaced
        # (so fixing findings still shrinks the file).
        kept = {key: n
                for key, n in core.load_baseline(args.baseline).items()
                if key[1] not in modules}
        path = core.write_baseline(gated, modules, args.baseline, keep=kept)
        print(f"graftlint: wrote {len(gated)} finding(s) to {path}"
              + (f" (kept {sum(kept.values())} for unanalyzed files)"
                 if kept else ""))
        return 0

    baseline = core.load_baseline(args.baseline)
    new, grandfathered = core.apply_baseline(gated, modules, baseline)

    if args.as_json:
        doc = {
            "findings": [f.to_json() for f in new],
            "baselined": ([f.to_json() for f in grandfathered]
                          if args.no_baseline else len(grandfathered)),
            "suppressed": ([f.to_json() for f in suppressed]
                           if args.no_suppressions else len(suppressed)),
            "counts": _counts(new),
            "ok": not new,
        }
        print(json.dumps(doc, indent=1))
        return 1 if new else 0

    for f in new:
        print(f.render())
    if args.no_baseline and grandfathered:
        print(f"-- {len(grandfathered)} baselined finding(s):")
        for f in grandfathered:
            print("   " + f.render())
    if args.no_suppressions and suppressed:
        print(f"-- {len(suppressed)} suppressed finding(s) (audit view; "
              "not gated):")
        for f in suppressed:
            print("   " + f.render())
    if new:
        counts = ", ".join(f"{n} {sev}" for sev, n in _counts(new).items())
        print(f"graftlint: {len(new)} finding(s) ({counts}); "
              f"{len(grandfathered)} baselined")
        return 1
    suffix = f" ({len(grandfathered)} baselined)" if grandfathered else ""
    print(f"graftlint: clean{suffix}")
    return 0


def _counts(findings) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for f in findings:
        out[f.severity] = out.get(f.severity, 0) + 1
    return dict(sorted(out.items()))


def _cli() -> int:
    try:
        return main()
    except BrokenPipeError:
        # `graftlint ... | head` closing the pipe early is not an error.
        return 0


if __name__ == "__main__":
    sys.exit(_cli())
