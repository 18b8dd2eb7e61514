"""graftlint core: findings, suppressions, baseline, and the file driver
(the port's copy of the JAX package's ``analysis/core.py``).

The port's threaded plane (the serving front end, supervise, the sockets
nodes, the chaos plane, telemetry's HTTP server) carries lock-using
modules whose deadlock and blocking-under-lock hazards only surface
under load. These are *lock-discipline* properties, enforceable
statically, per change, from the AST alone.

This module is the rule-agnostic machinery:

- :class:`Finding` — one diagnostic: rule id, severity (P0 worst..P3),
  ``file:line:col``, message. Sorted worst-first, then by location.
- :class:`Module` — one parsed file handed to every rule: path, source,
  AST, import-alias tables (``torch``/``numpy`` however they were bound),
  and the per-line suppression table.
- Suppressions — ``# graftlint: ignore[RULE-A,RULE-B]`` on (or inside the
  statement starting at) the flagged line silences those rules there; a
  bare ``# graftlint: ignore`` silences every rule on that line. Keep a
  rationale in the same comment: suppressions are grep-able design notes.
- Baseline — ``baseline.json`` grandfathers pre-existing findings so the
  CLI can gate *new* ones. Entries fingerprint on ``(rule, file,
  stripped source line)``, not line numbers, so unrelated edits above a
  finding don't churn the file; counts bound how many identical findings
  one fingerprint absorbs. Regenerate with
  ``python -m p2pnetwork_tpu_torch.analysis --write-baseline``; shrink it
  by fixing findings (stale entries are pruned on rewrite).

Rules live in :mod:`p2pnetwork_tpu_torch.analysis.concurrency` (lock
discipline) and :mod:`p2pnetwork_tpu_torch.analysis.torchrules` (the
backend-neutral ``unbounded-cache``). Everything here is stdlib-only.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding", "Module", "Rule", "register_rule", "all_rules",
    "analyze_paths", "analyze_source", "load_baseline", "write_baseline",
    "apply_baseline", "default_baseline_path", "SEVERITIES",
]

#: Worst-first severity order. P0: will deadlock / retrace unboundedly.
#: P1: blocks or syncs on a hot path. P2: discipline drift that becomes a
#: P0/P1 under refactoring. P3: informational.
SEVERITIES = ("P0", "P1", "P2", "P3")

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*ignore(?:\[(?P<rules>[A-Za-z0-9_,\- ]+)\])?")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One diagnostic. Field order defines sort order: severity first
    (P0 < P1 lexically, which is also worst-first), then location."""

    severity: str
    file: str
    line: int
    col: int
    rule: str
    message: str

    def fingerprint(self, source_line: str) -> Tuple[str, str, str]:
        """Line-number-free identity used by the baseline: the rule, the
        file, and the stripped source text of the flagged line."""
        return (self.rule, self.file, source_line.strip())

    def render(self) -> str:
        return (f"{self.file}:{self.line}:{self.col}: "
                f"{self.severity} [{self.rule}] {self.message}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class Module:
    """One parsed source file, pre-chewed for rules: AST, import aliases,
    suppression table, and a line accessor for baseline fingerprints."""

    def __init__(self, path: str, source: str, relpath: Optional[str] = None):
        self.path = path
        self.relpath = relpath if relpath is not None else path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # name the module was bound to -> canonical package, e.g. both
        # ``import numpy as np`` and ``from torch import float64 as f64``
        # land in these tables so rules match usage, not spelling.
        self.aliases: Dict[str, str] = {}       # local name -> top package
        self.from_imports: Dict[str, str] = {}  # local name -> "pkg.attr"
        self._collect_imports()
        self.suppressions = self._collect_suppressions()

    # ------------------------------------------------------------ imports

    def _collect_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    local = a.asname or a.name.split(".")[0]
                    self.aliases[local] = a.name.split(".")[0]
                    if a.asname and "." in a.name:
                        # ``import torch.nn.functional as F``: F ->
                        # torch.nn.functional
                        self.from_imports[a.asname] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    local = a.asname or a.name
                    self.from_imports[local] = f"{node.module}.{a.name}"
                    self.aliases.setdefault(local,
                                            node.module.split(".")[0])

    def imports_package(self, package: str) -> bool:
        return (package in self.aliases.values()
                or any(v == package or v.startswith(package + ".")
                       for v in self.from_imports.values()))

    def names_for(self, dotted: str) -> Set[str]:
        """Local names that resolve to ``dotted`` (e.g.
        ``torch.nn.functional`` -> {"F"}; ``numpy`` -> {"np", "numpy"})."""
        out = {local for local, full in self.from_imports.items()
               if full == dotted}
        out |= {local for local, pkg in self.aliases.items()
                if pkg == dotted and "." not in dotted
                and local not in self.from_imports}
        return out

    # ------------------------------------------------------- suppressions

    def _collect_suppressions(self) -> Dict[int, Optional[Set[str]]]:
        """1-based line -> set of suppressed rule ids, or ``None`` for all
        rules. Comments are read straight off the source lines (ast drops
        them); only lines actually containing the marker pay the regex.

        A marker covers the whole innermost *simple statement* containing
        it, so a comment on any continuation line of a multi-line call
        silences findings anchored at the statement's first line (and
        vice versa) — the documented "on or inside the flagged statement"
        contract. On a compound statement it covers the header lines
        only; a marker on a comment-only line between statements covers
        just that line (i.e. nothing) rather than the enclosing block."""
        markers: Dict[int, Optional[Set[str]]] = {}
        for i, text in enumerate(self.lines, start=1):
            if "graftlint" not in text:
                continue
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            rules = m.group("rules")
            if rules is None:
                markers[i] = None
            elif markers.get(i, ()) is not None:
                # Merge rule ids; an existing bare ignore (None) already
                # suppresses everything and must not be narrowed.
                ids = {r.strip() for r in rules.split(",") if r.strip()}
                markers[i] = set(markers.get(i) or ()) | ids
        if not markers:
            return {}
        spans = []
        for s in ast.walk(self.tree):
            if not isinstance(s, ast.stmt):
                continue
            end = getattr(s, "end_lineno", None) or s.lineno
            body = getattr(s, "body", None)
            if isinstance(body, list) and body \
                    and isinstance(body[0], ast.stmt):
                # Compound statement (def/with/if/for/...): only its
                # HEADER lines count as "inside" it. A marker in the body
                # belongs to an inner statement — or, on a comment-only
                # line between statements, to nothing: matching the full
                # span would let one stray comment silence every finding
                # in the enclosing function.
                end = max(s.lineno, body[0].lineno - 1)
            spans.append((s.lineno, end))
        table: Dict[int, Optional[Set[str]]] = {}

        def merge(line: int, ids: Optional[Set[str]]) -> None:
            if ids is None:
                table[line] = None
            elif table.get(line, ()) is not None:
                table[line] = set(table.get(line) or ()) | ids

        for line, ids in markers.items():
            best = None
            for lo, hi in spans:
                if lo <= line <= hi and (
                        best is None or hi - lo < best[1] - best[0]):
                    best = (lo, hi)
            lo, hi = best if best is not None else (line, line)
            for covered in range(lo, hi + 1):
                merge(covered, ids)
        return table

    def suppressed(self, finding: Finding) -> bool:
        allowed = self.suppressions.get(finding.line, ())
        if allowed is None:
            return True
        return finding.rule in allowed

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""


@dataclasses.dataclass(frozen=True)
class Rule:
    """A registered check: ``run(module)`` yields Findings (severity and
    id are stamped here so rule bodies only supply location + message)."""

    id: str
    severity: str
    doc: str
    run: Callable[[Module], Iterable[Finding]]


_RULES: Dict[str, Rule] = {}  # graftlint: ignore[unbounded-cache] -- rule registry: one entry per @register_rule decorator at import time, fixed vocabulary


def register_rule(id: str, severity: str, doc: str):
    """Decorator for rule functions ``fn(module) -> iterable of (node,
    message)``; wraps them to emit stamped :class:`Finding` records."""
    if severity not in SEVERITIES:
        raise ValueError(f"unknown severity {severity!r}")

    def deco(fn):
        def run(module: Module):
            for node, message in fn(module):
                yield Finding(severity=severity, file=module.relpath,
                              line=getattr(node, "lineno", 0),
                              col=getattr(node, "col_offset", 0),
                              rule=id, message=message)
        if id in _RULES:
            raise ValueError(f"duplicate rule id {id!r}")
        _RULES[id] = Rule(id=id, severity=severity, doc=doc, run=run)
        return fn
    return deco


def all_rules() -> Dict[str, Rule]:
    # Importing the rule modules registers them; deferred so core stays
    # importable mid-bootstrap (the rule modules import this one).
    from p2pnetwork_tpu_torch.analysis import concurrency, torchrules  # noqa: F401
    return dict(_RULES)


# ---------------------------------------------------------------- driver

def _iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if not os.path.exists(p):
            # A typo'd target must not analyze zero files and report
            # "clean" — that permanently disables the gate with a green
            # check. The CLI maps this to exit 2.
            raise FileNotFoundError(f"no such file or directory: {p}")
        if os.path.isfile(p):
            yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if not d.startswith(".") and
                             d not in ("__pycache__", "bench_cache"))
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def analyze_source(source: str, path: str = "<string>",
                   rules: Optional[Dict[str, Rule]] = None,
                   respect_suppressions: bool = True) -> List[Finding]:
    """Run every rule over one source string (the test-fixture entry)."""
    module = Module(path, source)
    return _run_rules(module, rules if rules is not None else all_rules(),
                      respect_suppressions)


def _run_rules(module: Module, rules: Dict[str, Rule],
               respect_suppressions: bool) -> List[Finding]:
    out: List[Finding] = []
    for rule in rules.values():
        for finding in rule.run(module):
            if respect_suppressions and module.suppressed(finding):
                continue
            out.append(finding)
    return sorted(out)


def analyze_paths(paths: Sequence[str],
                  rules: Optional[Dict[str, Rule]] = None,
                  root: Optional[str] = None,
                  respect_suppressions: bool = True,
                  collect_sources: Optional[Dict[str, Module]] = None,
                  ) -> List[Finding]:
    """Run every rule over every ``.py`` file under ``paths``.

    ``root`` makes reported file paths relative (baseline entries must not
    bake in an absolute checkout path). A file that fails to parse yields
    a single P1 ``parse-error`` finding instead of killing the run — a
    linter that dies on one bad file gates nothing.
    """
    if rules is None:
        rules = all_rules()
    root = os.path.abspath(root) if root else os.getcwd()
    findings: List[Finding] = []
    for path in _iter_py_files(paths):
        rel = os.path.relpath(os.path.abspath(path), root)
        try:
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
            module = Module(path, source, relpath=rel)
        except (SyntaxError, ValueError, UnicodeDecodeError, OSError) as e:
            # ValueError covers ast.parse on NUL bytes — the contract is
            # "unanalyzable file = one P1 finding", never a dead run.
            findings.append(Finding(
                severity="P1", file=rel, line=getattr(e, "lineno", 0) or 0,
                col=0, rule="parse-error",
                message=f"could not analyze: {type(e).__name__}: {e}"))
            continue
        if collect_sources is not None:
            collect_sources[rel] = module
        findings.extend(_run_rules(module, rules, respect_suppressions))
    return sorted(findings)


# --------------------------------------------------------------- baseline

def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def load_baseline(path: Optional[str] = None) -> Dict[Tuple[str, str, str], int]:
    """``{(rule, file, stripped line): allowed count}``. A missing file is
    an empty baseline — the clean-tree state needs no artifact."""
    path = path or default_baseline_path()
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    out: Dict[Tuple[str, str, str], int] = {}
    for entry in data.get("findings", ()):
        key = (entry["rule"], entry["file"], entry["code"])
        out[key] = out.get(key, 0) + int(entry.get("count", 1))
    return out


def write_baseline(findings: Sequence[Finding],
                   modules: Dict[str, Module],
                   path: Optional[str] = None,
                   keep: Optional[Dict[Tuple[str, str, str], int]] = None,
                   ) -> str:
    """Grandfather ``findings`` (typically the current run's full output):
    collapse to fingerprint counts and write the JSON artifact. ``keep``
    carries prior entries to preserve verbatim (the CLI passes entries for
    files a path-subset run did not analyze, so such a run cannot
    silently drop other files' grandfathered findings)."""
    path = path or default_baseline_path()
    counts: Dict[Tuple[str, str, str], int] = dict(keep or {})
    for f in findings:
        module = modules.get(f.file)
        code = module.line_text(f.line) if module else ""
        key = f.fingerprint(code)
        counts[key] = counts.get(key, 0) + 1
    entries = [{"rule": rule, "file": file, "code": code, "count": n}
               for (rule, file, code), n in sorted(counts.items())]
    payload = {
        "comment": ("graftlint grandfathered findings. Entries match on "
                    "(rule, file, stripped source line) — line-number "
                    "drift does not churn this file. Shrink it by fixing "
                    "findings; regenerate with --write-baseline."),
        "findings": entries,
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1, sort_keys=False)
        f.write("\n")
    return path


def apply_baseline(findings: Sequence[Finding],
                   modules: Dict[str, Module],
                   baseline: Dict[Tuple[str, str, str], int],
                   ) -> Tuple[List[Finding], List[Finding]]:
    """Split into (new, grandfathered). Each baseline fingerprint absorbs
    at most its recorded count — a *new* duplicate of an old finding on
    the same line still fails the gate."""
    budget = dict(baseline)
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        module = modules.get(f.file)
        code = module.line_text(f.line) if module else ""
        key = f.fingerprint(code)
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old
