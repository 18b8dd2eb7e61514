"""graftaudit CLI: ``python -m p2pnetwork_tpu_torch.analysis.ir``.

Exit codes as graftlint's: 0 — no non-baselined findings; 1 — findings
to fix; 2 — bad invocation (or no card when the card is asked for). The
lowerings run on the card unless ``--device`` names another; tier-1 runs
``--device cpu``, and the census it checks is the one the card gives.

Typical invocations::

    python -m p2pnetwork_tpu_torch.analysis.ir --device cpu   # the gate
    python -m p2pnetwork_tpu_torch.analysis.ir                # on the card
    ... --json                    # one JSON document
    ... --no-cost                 # rules and parity only (no carry audit,
                                  #   no ratchets)
    ... --write-budgets           # bless the census into budgets.json
    ... --write-membudgets        # bless peak bytes into membudgets.json
    ... --plan                    # the 1M-node planner (no building)
    ... --list-lowerings / --list-rules
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graftaudit",
        description=("Census audit of the port's lowerings: host-sync, f64 "
                     "and slot rules, signature parity, the carry audit, "
                     "and the cost and memory ratchets."))
    p.add_argument("--device", default=None,
                   help="device the lowerings run on (default: the card; "
                        "`cpu` for the CPU)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output (one JSON document with "
                        "findings, census and memory tables)")
    p.add_argument("--budgets", default=None, metavar="PATH",
                   help="budgets file (default: the package's "
                        "analysis/ir/budgets.json)")
    p.add_argument("--write-budgets", action="store_true",
                   help="bless the current census into the budgets file "
                        "and exit 0 (commit the diff)")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help="grandfathered-findings baseline (default: "
                        "analysis/ir/baseline.json)")
    p.add_argument("--write-baseline", action="store_true",
                   help="grandfather every current finding into the "
                        "baseline file (keeping stored reasons) and exit 0")
    p.add_argument("--no-cost", action="store_true",
                   help="skip the carry audit and both ratchets (the fast "
                        "rule pass)")
    p.add_argument("--membudgets", default=None, metavar="PATH",
                   help="memory-budgets file (default: the package's "
                        "analysis/ir/membudgets.json)")
    p.add_argument("--write-membudgets", action="store_true",
                   help="bless the current peak bytes into the membudgets "
                        "file (its capacity_model kept) and exit 0")
    p.add_argument("--no-mem", action="store_true",
                   help="skip the memory ratchet, keep the cost pass")
    p.add_argument("--plan", nargs="?", const="northstar", default=None,
                   metavar="SPEC",
                   help="print a capacity plan from the checked-in "
                        "coefficients and exit (no building). SPEC is "
                        "k=v[,k=v...] over nodes, lanes, hbm_gb, headroom, "
                        "entry; bare --plan is the 1M-node / 10k-lane "
                        "serving shape")
    p.add_argument("--tolerance", type=float, default=None,
                   help="bytes tolerance override (fraction; default: the "
                        "value stored in the budgets file)")
    p.add_argument("--rules", default=None, metavar="ID[,ID...]",
                   help="run only these census rule ids (parity, carry "
                        "and ratchet gates still run unless skipped)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    p.add_argument("--list-lowerings", action="store_true",
                   help="print the lowering registry and exit")
    return p


def _parse_plan_spec(spec: str) -> dict:
    """``nodes=200000,lanes=4096,hbm_gb=8`` -> capacity.plan kwargs (the
    1M-node, 10k-lane serving shape for omitted keys)."""
    kw: dict = {"n_nodes": 1_000_000, "lanes": 10_016}
    if spec and spec != "northstar":
        for part in spec.split(","):
            k, sep, v = part.partition("=")
            k = k.strip()
            if not sep or not k:
                raise ValueError(f"bad --plan token {part!r} "
                                 "(want k=v[,k=v...])")
            if k == "nodes":
                kw["n_nodes"] = int(v)
            elif k == "lanes":
                kw["lanes"] = int(v)
            elif k == "hbm_gb":
                kw["per_chip_hbm_bytes"] = float(v) * 1024**3
            elif k == "headroom":
                kw["headroom"] = float(v)
            elif k == "entry":
                kw["entry"] = v.strip()
            else:
                raise ValueError(
                    f"unknown --plan key {k!r} (known: nodes, lanes, "
                    "hbm_gb, headroom, entry)")
    return kw


def _render_plan(doc: dict) -> None:
    gib = 1024**3
    print(f"capacity plan — {doc['entry']}")
    print(f"  overlay   {doc['n_nodes']:,} nodes (padded {doc['n_pad']:,} "
          f"nodes / {doc['e_pad']:,} edge slots)")
    print(f"  lanes     {doc['lanes']:,} ({doc['lane_words']} u32 words)")
    print(f"  global    {doc['global_bytes'] / gib:.2f} GiB modeled "
          "resident bytes")
    print(f"  card      {doc['per_chip_hbm_bytes'] / gib:.1f} GiB "
          f"(headroom {doc['headroom']:.0%})")
    for row in doc["per_chip"]:
        mark = "fits" if row["fits"] else "OVER"
        print(f"    shards={row['shards']:<5d} "
              f"{row['per_chip_bytes'] / gib:7.2f} GiB/card  {mark}")
    rec = doc["recommended_shards"]
    print("  recommend "
          + (f"{rec} shard(s)" if rec else
             "NOTHING in the candidate list fits — raise shards or memory"))


_GATE_RULES = (
    ("ir-sig-parity", "P0", "output signatures of one (op, shape-class) "
     "group must agree (rules.parity_findings)"),
    ("ir-cost-ratchet", "P1", "the census against the blessed budgets.json "
     "(budgets.check_budgets)"),
    ("ir-carry-retained", "P1", "a loop's peak grows with its rounds "
     "(donation.audit_carry)"),
    ("ir-carry-doubled", "P1", "a loop holds a second carry "
     "(donation.audit_carry)"),
    ("ir-carry-unverifiable", "P1", "a carry program failed to run "
     "(donation.audit_carry)"),
    ("ir-mem-regression", "P1", "peak live bytes against the blessed "
     "membudgets.json (memory.check_membudgets; a shrink is P2)"),
    ("ir-mem-unbudgeted", "P1", "a lowering with no blessed memory budget "
     "(memory.check_membudgets)"),
    ("ir-mem-model-drift", "P2", "the census walk and the tracker disagree "
     "on output bytes (memory.check_membudgets)"),
)


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)

    from p2pnetwork_tpu_torch.analysis.ir import capacity as C

    if args.plan is not None:
        try:
            doc = C.plan(**_parse_plan_spec(args.plan))
        except ValueError as e:
            print(f"graftaudit: {e}", file=sys.stderr)
            return 2
        if args.as_json:
            print(json.dumps(doc, indent=1))
        else:
            _render_plan(doc)
        return 0

    from p2pnetwork_tpu_torch.analysis.ir import rules

    if args.list_rules:
        table = rules.all_ir_rules()
        width = max(len(r) for r in list(table) + [g[0] for g in
                                                   _GATE_RULES])
        for rule in sorted(table.values(), key=lambda r: (r.severity, r.id)):
            print(f"{rule.id:<{width}}  {rule.severity}  {rule.doc}")
        for rid, sev, doc in _GATE_RULES:
            print(f"{rid:<{width}}  {sev}  {doc}")
        return 0

    from p2pnetwork_tpu_torch.analysis.ir import registry

    entries = registry.all_lowerings()
    if args.list_lowerings:
        width = max(len(e.name) for e in entries)
        for e in entries:
            parity = "parity" if e.parity else "      "
            print(f"{e.name:<{width}}  {parity}  {e.doc or e.op}")
        return 0

    selected = rules.all_ir_rules()
    if args.rules:
        wanted = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in wanted if r not in selected]
        if unknown:
            print(f"graftaudit: unknown rule(s): {', '.join(unknown)} "
                  "(try --list-rules)", file=sys.stderr)
            return 2
        selected = {r: selected[r] for r in wanted}
    if args.no_cost and (args.write_budgets or args.write_membudgets):
        print("graftaudit: --write-budgets/--write-membudgets need the "
              "cost pass; drop --no-cost", file=sys.stderr)
        return 2
    if args.no_mem and args.write_membudgets:
        print("graftaudit: --write-membudgets needs the memory pass; drop "
              "--no-mem", file=sys.stderr)
        return 2

    from p2pnetwork_tpu_torch import _device
    from p2pnetwork_tpu_torch.analysis.ir import budgets as B
    from p2pnetwork_tpu_torch.analysis.ir import donation
    from p2pnetwork_tpu_torch.analysis.ir import memory as M

    device = _device.resolve(args.device)  # raises without the card
    with_mem = not args.no_cost and not args.no_mem
    traces = [registry.trace_lowering(e, device, memory=with_mem)
              for e in entries]
    findings = rules.run_ir_rules(traces, selected)
    findings += rules.parity_findings(traces)

    costs: Dict[str, dict] = {}
    if not args.no_cost:
        findings += donation.audit_carry(device=device)
        costs = B.collect_costs(traces)
        if args.write_budgets:
            broken = sorted(t.entry.name for t in traces if t.error)
            if broken:
                print("graftaudit: refusing --write-budgets while "
                      "lowering(s) fail to run: " + ", ".join(broken),
                      file=sys.stderr)
                return 2
            stored = B.load_budgets(args.budgets).get("tolerance")
            tol = (args.tolerance if args.tolerance is not None
                   else stored if stored is not None
                   else B.DEFAULT_TOLERANCE)
            path = B.write_budgets(costs, args.budgets, tolerance=tol)
            print(f"graftaudit: wrote {len(costs)} budget entr(ies) to "
                  f"{path}")
            if not args.write_membudgets:
                return 0
        else:
            findings += B.check_budgets(costs, B.load_budgets(args.budgets),
                                        tolerance=args.tolerance)

    mem_records: Dict[str, dict] = {}
    if with_mem:
        mem_records = M.collect_memory(traces)
        if args.write_membudgets:
            broken = sorted(t.entry.name for t in traces if t.error)
            if broken:
                print("graftaudit: refusing --write-membudgets while "
                      "lowering(s) fail to run: " + ", ".join(broken),
                      file=sys.stderr)
                return 2
            stored = M.load_membudgets(args.membudgets).get("tolerance")
            tol = stored if stored is not None else M.DEFAULT_TOLERANCE
            path = M.write_membudgets(mem_records, args.membudgets,
                                      tolerance=tol)
            print(f"graftaudit: wrote {len(mem_records)} memory budget "
                  f"entr(ies) to {path}")
            return 0
        findings += M.check_membudgets(
            mem_records, M.load_membudgets(args.membudgets))

    findings = sorted(findings)
    if args.write_baseline:
        path = rules.write_ir_baseline(findings, args.baseline)
        print(f"graftaudit: wrote {len(findings)} finding(s) to {path}")
        return 0
    new, grandfathered = rules.apply_ir_baseline(
        findings, rules.load_ir_baseline(args.baseline))

    census = {t.entry.name: t.census.to_json() for t in traces
              if t.census is not None}
    if args.as_json:
        import torch

        doc = {
            "findings": [f.to_json() for f in new],
            "baselined": len(grandfathered),
            "device": str(device),
            "torch": torch.__version__,
            "lowerings": [t.entry.name for t in traces],
            "census": census,
            "exchanges": {t.entry.name: t.exchanges for t in traces
                          if t.exchanges},
            "costs": costs,
            "memory": mem_records,
            "ok": not new,
        }
        print(json.dumps(doc, indent=1))
        return 1 if new else 0

    for f in new:
        print(f.render())
    if new:
        counts: Dict[str, int] = {}
        for f in new:
            counts[f.severity] = counts.get(f.severity, 0) + 1
        summary = ", ".join(f"{n} {sev}" for sev, n in sorted(counts.items()))
        print(f"graftaudit: {len(new)} finding(s) ({summary}); "
              f"{len(grandfathered)} baselined")
        return 1
    suffix = f" ({len(grandfathered)} baselined)" if grandfathered else ""
    print(f"graftaudit: clean{suffix} — {len(traces)} lowering(s) audited "
          f"on {device}"
          + ("" if args.no_cost else
             f", {len(costs)} cost-ratcheted"
             + (f", {len(mem_records)} memory-ratcheted" if with_mem
                else "") + ", carries verified"))
    return 0


def _cli() -> int:
    try:
        return main()
    except BrokenPipeError:
        return 0
    except RuntimeError as e:
        if "CUDA device" not in str(e):
            raise
        print(f"graftaudit: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(_cli())
