#!/usr/bin/env python3
"""Fit the memory planner's coefficients (``p2pnetwork_tpu_torch/analysis/
ir/capacity.py``) on the card, from measured peaks of the serving program.

    python3 tools/fit_capacity.py [--out PATH] [--sizes 65536,...]
                                  [--words 1,8,32]

For each graph family (``ws``: ``watts_strogatz(n, 10, 0.1, seed=0,
source_csr=True)``; ``ba``: ``barabasi_albert(n, 5, seed=0,
source_csr=True, build_neighbor_table=False)``), each size and each
lane-word count ``W``, it builds
a ``SimService`` of ``32 W`` lanes on the graph (the batched flood under
the engine, ``capacity.DEFAULT_SERVING_ENTRY``), submits one ticket a
lane and ticks until they are done. A point's bytes are the graph's
resident bytes (``capacity.resident_bytes``) plus
``torch.cuda.max_memory_allocated()`` over the service's life less the
allocation before it was built (after ``gc.collect()``,
``torch.cuda.empty_cache()`` and ``reset_peak_memory_stats()``). The
sizes start at 64K nodes, where the program's bytes dominate the
allocator's 512-byte rounding and its 2 MB segments. Each family also
runs at a second density (``PROBES``) at two sizes, which separates the
node slope from the edge slope.

The fit (``capacity.fit_capacity_model``) goes to ``--out`` (default: the
package's ``analysis/ir/membudgets.json``) as ``{"capacity_model": ...}``,
with the fit points, ``max_resid`` and the card (its ``nvidia-smi`` name
and power limit, and its memory). A line per point, then a ``summary``
line, go to standard output. Needs one CUDA card; exits 2 without one.
"""

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from p2pnetwork_tpu_torch.analysis.ir import capacity  # noqa: E402

#: family -> (generator, args, keywords) of the fit graphs. The BA graph
#: carries no neighbor table, as the 1M BA rung of ``chip_smoke.py``: its
#: hubs would make the table ``[N, max_degree]``, quadratic in N.
FAMILIES = {"ws": ("watts_strogatz", (10, 0.1), {}),
            "ba": ("barabasi_albert", (5,), {"build_neighbor_table": False})}
SIZES = (65_536, 131_072, 262_144, 1_000_000)
WORDS = (1, 8, 32)
#: family -> (args, sizes) of the density probes: a second edges-per-node
#: ratio at two sizes, so the fit can tell the node slope from the edge
#: slope (one ratio alone makes the two columns collinear). They stay out
#: of the family's edges-per-node model, which ``plan`` reads.
PROBES = {"ws": ((6, 0.1), (65_536, 262_144)),
          "ba": ((3,), (65_536, 262_144))}
MAX_TICKS = 64


def card() -> dict:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    name, power = (s.strip() for s in line.split(",", 1))
    return {"name": name, "power_limit": power, "nvidia_smi": line,
            "total_memory": torch.cuda.get_device_properties(0).total_memory}


def measure(serve, g, words: int) -> dict:
    """One point: the serving program's peak bytes over a graph."""
    lanes = 32 * words
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    svc = serve.SimService(g, capacity=lanes, queue_depth=lanes,
                           chunk_rounds=4, seed=0)
    for s in (np.arange(lanes, dtype=np.int64) * 7919) % g.n_nodes:
        svc.submit(int(s))
    ticks = 0
    while ticks < MAX_TICKS and svc.stats()["completed"] < lanes:
        svc.tick()
        ticks += 1
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    done = svc.stats()["completed"]
    svc.close()
    del svc
    return {"service_peak_bytes": int(peak), "ticks": ticks,
            "completed": int(done)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=capacity.default_membudgets_path())
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--words", default=",".join(map(str, WORDS)))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fit_capacity: no CUDA device", file=sys.stderr)
        return 2
    from p2pnetwork_tpu_torch import serve
    from p2pnetwork_tpu_torch.sim import graph as G

    sizes = [int(s) for s in args.sizes.split(",")]
    words = [int(w) for w in args.words.split(",")]
    the_card = card()
    print(the_card["nvidia_smi"], flush=True)
    t0 = time.perf_counter()
    records = []
    runs = [(fam, fn, fargs, fkw, n, True)
            for fam, (fn, fargs, fkw) in FAMILIES.items() for n in sizes]
    runs += [(fam, FAMILIES[fam][0], pargs, FAMILIES[fam][2], n, False)
             for fam, (pargs, psizes) in PROBES.items() for n in psizes]
    for fam, fn, fargs, fkw, n, main_density in runs:
        g = getattr(G, fn)(n, *fargs, seed=0, source_csr=True, **fkw)
        g_bytes = capacity.resident_bytes(g)
        for w in words:
            m = measure(serve, g, w)
            rec = {"entry": f"cov/batchflood-engine@{fam}",
                   "graph": f"{fn}{(n, *fargs)}", "n_nodes": int(n),
                   "n_pad": int(g.n_nodes_padded),
                   "e_pad": int(g.n_edges_padded), "lane_words": w,
                   "graph_fit": main_density, "graph_bytes": g_bytes,
                   "bytes": g_bytes + m["service_peak_bytes"], **m}
            records.append(rec)
            print(json.dumps({"phase": "fit-point", **rec}), flush=True)
        del g
    model = capacity.fit_capacity_model(
        [{k: r[k] for k in ("entry", "graph", "n_nodes", "n_pad", "e_pad",
                            "lane_words", "graph_fit", "graph_bytes",
                            "bytes")}
         for r in records], card=the_card)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump({"capacity_model": model}, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({"phase": "summary", "out": args.out,
                      "points": len(records),
                      "max_resid": model["max_resid"],
                      "entries": model["entries"], "lane": model["lane"],
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
