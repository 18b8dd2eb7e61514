#!/usr/bin/env python3
"""Wall times of the port's 1M-node floods, for trees compared in turns on
one card.

    python3 tools/flood_walls.py [--reps 15] TREE [TREE ...]

Each TREE is a checkout of the repo (e.g. the parent commit unpacked with
``git archive`` next to this one); list them in turns, such as ``parent
tree tree parent``. Each runs in a process of its own that imports that
tree's ``p2pnetwork_tpu_torch``, builds ``chip_smoke.py``'s phase-4 graph
(``watts_strogatz(1_000_000, 10, 0.1, seed=0)`` with the blocked, hybrid
and source-CSR layouts) and floods it from node 0 to 0.99 coverage by
``frontier`` + bitset, ``hybrid`` and ``pallas``: one warm-up run, then
``--reps`` runs, each timed on the host clock to a device sync. Prints the
card's ``nvidia-smi`` line, then one JSON line per tree: per method the
median and quartiles in ms. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

METHODS = (("frontier", {"method": "frontier", "bitset": True}),
           ("hybrid", {"method": "hybrid"}), ("pallas", {"method": "pallas"}))


def quartiles(times):
    ms = sorted(1e3 * t for t in times)
    at = lambda q: ms[round(q * (len(ms) - 1))]  # noqa: E731
    return {"median_ms": at(0.5), "q1_ms": at(0.25), "q3_ms": at(0.75)}


def one_tree(tree: str, reps: int) -> dict:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    from p2pnetwork_tpu_torch.models.flood import Flood
    from p2pnetwork_tpu_torch.sim import engine
    from p2pnetwork_tpu_torch.sim import graph as graph_mod

    g = graph_mod.watts_strogatz(1_000_000, 10, 0.1, seed=0, blocked=True,
                                 hybrid=True, source_csr=True)
    # Trees from before the engine took a key call it without one.
    keyed = "key" in inspect.signature(engine.run_until_coverage).parameters
    key = ()
    if keyed:
        from p2pnetwork_tpu_torch import prng
        key = (prng.key(0),)
    out = {"tree": tree}
    for name, kw in METHODS:
        proto = Flood(source=0, **kw)
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.run_until_coverage(g, proto, *key, coverage_target=0.99,
                                      max_rounds=64)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = quartiles(times[1:])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_tree(args.trees[0], args.reps)), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for tree in args.trees:
        run = subprocess.run([sys.executable, __file__, "--one", "--reps",
                              str(args.reps), tree], capture_output=True,
                             text=True)
        if run.returncode != 0:
            print(run.stderr, file=sys.stderr)
            return run.returncode
        print(run.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
