#!/usr/bin/env python3
"""Device times of the port's threefry and row-sum kernels, for trees
compared in turns on one card.

    python3 tools/kernel_times.py [--reps 50] TREE [TREE ...]

Each TREE is a checkout of the repo (e.g. the parent commit unpacked with
``git archive`` into the git-ignored ``_proof/`` next to this one); list
them in turns, such as ``parent tree tree parent``. Each runs in a process
of its own that imports that tree's ``p2pnetwork_tpu_torch`` (and so
builds that tree's kernels) and times, as ``chip_smoke.py``'s
``cuda_times`` does (CUDA events, the L2 flushed before each launch), and
back to back (``-b2b``: ``chip_smoke.back_to_back_ms``, no flush):

- threefry bits and uniform at 1,000,064, 100,096 and 4,096 counters
  (``chip_smoke.THREEFRY_TIMED``);
- the row sums on ``chip_smoke.rowsum_cases``: the ``gather`` entry on the
  1M WS graph's neighbor table ``[1,000,064, 17]`` and on the BA shape
  ``[100,096, 128]``, the dense entry on ``[1, 1024]`` and ``[1, 32]``
  (beside it, ``-library``: ``sum(dim=1)``);
- the dense entry on the ring's shard totals, ``[8, 125008]`` (1M) and
  ``[8, 12512]`` (the 100K gossip ring), ``chip_smoke.shard_rowsum_input``
  (``rowsum-shards-BLOCK``, with ``-library``);
- the launch floor (an empty kernel), where the tree's library has one.

The neighbor table is built once, by the first tree's graph module
(``watts_strogatz(1_000_000, 10, 0.1, seed=0)``), and handed to the
others through a file in a temporary directory. Prints the card's
``nvidia-smi`` line, one JSON line per tree (ms by entry) and last a
``summary`` line: per tree path, the mean over its runs. Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    """This checkout's ``chip_smoke.py``, loaded by path so that the
    tree's package, first on ``sys.path``, is the one imported."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _table(cache: Path):
    import torch

    if not cache.exists():
        from p2pnetwork_tpu_torch.sim import graph as graph_mod
        g = graph_mod.watts_strogatz(1_000_000, 10, 0.1, seed=0)
        torch.save({"neighbors": g.neighbors.cpu(),
                    "neighbor_mask": g.neighbor_mask.cpu()}, cache)
    t = torch.load(cache)
    return t["neighbors"].cuda(), t["neighbor_mask"].cuda()


def one_tree(tree: str, reps: int, cache: Path) -> dict:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    from p2pnetwork_tpu_torch import _build, prng
    from p2pnetwork_tpu_torch.ops import rowsum, threefry

    pkg = Path(threefry.__file__).resolve()
    if Path(tree).resolve() not in pkg.parents:
        raise SystemExit(f"kernel_times: imported {pkg}, not {tree}'s")
    cs = _chip_smoke()
    dev = torch.device("cuda")
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    lib = _build.library()
    k = prng.key(0)
    k0, k1 = int(k[0]), int(k[1])
    out = {"tree": tree}

    def timed(key, fn):
        out[key] = cs.cuda_times(fn, reps, flush)
        out[key + "-b2b"] = cs.back_to_back_ms(fn, reps)

    # The first timing of a process reads high (clocks, first launches):
    # one is made and dropped.
    cs.cuda_times(lambda: threefry.threefry_bits(k0, k1, cs.N_PAD, dev), reps,
                  flush)
    out["launch_floor_ms"] = cs.launch_floor_ms(_build, flush) \
        if hasattr(lib, "p2p_noop") else None
    for n in cs.THREEFRY_TIMED:
        timed(f"threefry-bits-{n}",
              lambda: threefry.threefry_bits(k0, k1, n, dev))
        timed(f"threefry-uniform-{n}",
              lambda: threefry.threefry_uniform(k0, k1, n, 0.0, 1.0, dev))
    for entry, name, args in cs.rowsum_cases(*_table(cache)):
        kernel = rowsum.gather_row_sum if entry == "gather" \
            else rowsum.row_sum
        timed(f"rowsum-{name}", lambda: kernel(*args))
        if entry == "dense":
            out[f"rowsum-{name}-library"] = cs.cuda_times(
                lambda: args[0].sum(dim=1), reps, flush)
    for block in (cs.RING_BLOCK, cs.RING_GOSSIP_BLOCK):
        x = cs.shard_rowsum_input(block)
        timed(f"rowsum-shards-{block}", lambda: rowsum.row_sum(x))
        out[f"rowsum-shards-{block}-library"] = cs.cuda_times(
            lambda: x.sum(dim=1), reps, flush)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--cache", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_tree(args.trees[0], args.reps,
                                  Path(args.cache))), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    runs: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tree in args.trees:
            run = subprocess.run(
                [sys.executable, __file__, "--one", "--reps", str(args.reps),
                 "--cache", str(Path(tmp) / "table.pt"), tree],
                capture_output=True, text=True)
            if run.returncode != 0:
                print(run.stdout, run.stderr, file=sys.stderr)
                return run.returncode
            line = json.loads(run.stdout.strip().splitlines()[-1])
            print(json.dumps(line), flush=True)
            runs.setdefault(tree, []).append(line)
    summary = {}
    for tree, lines in runs.items():
        keys = [k for k in lines[0] if k != "tree"]
        summary[tree] = {k: None if lines[0][k] is None else
                         sum(x[k] for x in lines) / len(lines) for k in keys}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
