#!/usr/bin/env python3
"""Rank 0's walls of the 1M ring split over rank processes on one card,
for trees compared in turns.

    python3 tools/rank_walls.py [--reps 5] TREE [TREE ...]

Each TREE is a checkout of the repo (e.g. the parent commit unpacked with
``git archive`` into the git-ignored ``_proof/``); list them in turns,
such as ``parent tree tree parent``. Each tree runs in a process of its
own, run from the tree's root, which starts the ranks through that
tree's ``parallel/multihost.launch`` (the ranks run ``python -m`` from
that directory, so every rank imports that tree and loads the kernels
it built). The ranks build ``chip_smoke.py``'s phase-4 graph
(``watts_strogatz(1_000_000, 10, 0.1, seed=0)``), shard it 8 ways and
run the dense flood from node 0 to 0.99 on ``mxu`` and ``segment`` at
worlds 2 and 8, and at world 8 ``PR_ROUNDS`` rounds of PageRank on
``mxu``. Each run: one warm-up, then ``--reps`` runs, every
rank synchronised and barriered before each, timed on the host clock to a
device sync. Prints the card's ``nvidia-smi`` line, then one JSON line a
tree: each run's median, every wall (rank 0's, ms) and its launches by
counter. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

#: Runs by world: (name, layout).
RUNS = {2: (("flood", "mxu"), ("flood", "segment")),
        8: (("flood", "mxu"), ("flood", "segment"), ("pagerank", "mxu"))}
PR_ROUNDS = 21
N_NODES = 1_000_000
SHARDS = 8
LAYOUTS = {"mxu": {"mxu": True}, "segment": {}}


def _counts(ring, segsum) -> dict:
    names = ("PUT_LAUNCHES", "LAND_LAUNCHES", "PUT_SEGSUM_LAUNCHES",
             "GATHER_LAUNCHES", "PASS_SEGSUM_LAUNCHES")
    out = {n: getattr(ring, n) for n in names if hasattr(ring, n)}
    out["SEGSUM_LAUNCHES"] = segsum.LAUNCHES
    return out


def rank_runs(reps: int) -> dict:
    """One rank's runs of ``RUNS`` at its world (a ``multihost.launch``
    target): rank 0's walls matter, every rank runs the same calls."""
    import torch
    import torch.distributed as dist

    from p2pnetwork_tpu_torch.models import PageRank
    from p2pnetwork_tpu_torch.ops import ring, segsum
    from p2pnetwork_tpu_torch.parallel import multihost, sharded
    from p2pnetwork_tpu_torch.sim import graph as graph_mod

    mesh = multihost.hierarchical_ring_mesh(n_shards=SHARDS)
    g = graph_mod.watts_strogatz(N_NODES, 10, 0.1, seed=0)
    out = {"rank": mesh.rank, "world": mesh.world,
           "package": str(Path(ring.__file__).parents[1])}
    for name, layout in RUNS[mesh.world]:
        sg = sharded.shard_graph(g, mesh, **LAYOUTS[layout])
        if name == "flood":
            def run():
                return sharded.flood_until_coverage(
                    sg, mesh, 0, coverage_target=0.99, max_rounds=64)
        else:
            def run():
                return sharded.pagerank(sg, mesh, PageRank(), PR_ROUNDS)
        walls, counts = [], None
        for i in range(reps + 1):
            torch.cuda.synchronize()
            dist.barrier()
            before = _counts(ring, segsum)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            if counts is None:
                counts = {k: v - before[k]
                          for k, v in _counts(ring, segsum).items()}
        out[f"{name}-{layout}"] = {"walls_ms": walls[1:],
                                   "median_ms": statistics.median(walls[1:]),
                                   "launches": counts}
        del sg
        torch.cuda.empty_cache()
    return out


def one_tree(tree: str, reps: int) -> dict:
    sys.path.insert(0, str(Path(tree).resolve()))
    from p2pnetwork_tpu_torch.parallel import multihost

    out = {"tree": tree, "package": str(Path(multihost.__file__).parents[1])}
    for world in RUNS:
        t0 = time.perf_counter()
        parts = multihost.launch(f"{Path(__file__).resolve()}:rank_runs",
                                 world, (reps,), timeout=600, device="cuda")
        out[f"world{world}"] = {k: v for k, v in parts[0].items()
                                if k not in ("rank", "world")}
        out[f"world{world}"]["launch_s"] = time.perf_counter() - t0
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_tree(args.trees[0], args.reps)), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for tree in args.trees:
        root = Path(tree).resolve()
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--one", "--reps", str(args.reps), str(root)],
                             capture_output=True, text=True, cwd=root)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        print(run.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
