#!/usr/bin/env python3
"""What ``torch.profiler`` costs on a run of many small launches, and
whether ``chip_smoke.py``'s way of reading it gives the same device time.

    python3 tools/profiler_cost.py

Runs ``chip_smoke.py``'s discovery rung once (4,096 walkers to 0.99 of the
1M-node WS graph, ~186K kernel launches, all small), then profiles it
three ways: host and device events summed by ``key_averages()`` (the
script's way before slice 7), device events only by ``key_averages()``,
and device events only summed from the raw events (``profile_run``'s way).
Prints the card's ``nvidia-smi`` line, then one JSON line per way: the
run's wall under the profiler, the profiler's exit, the summing's host
seconds, the device total and the launches. Needs one CUDA card.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_cost: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as C
    from p2pnetwork_tpu_torch import models as M
    from p2pnetwork_tpu_torch.sim import engine
    from p2pnetwork_tpu_torch.sim import graph as G

    print(C.gpu_line(), flush=True)
    g = G.watts_strogatz(C.N_NODES, 10, 0.1, seed=0, source_csr=True,
                         build_neighbor_table=False)
    walk = M.RandomWalks(n_walkers=C.WALKERS)

    def run():
        engine.run_until_coverage(g, walk, C.KEY, coverage_target=0.99,
                                  max_rounds=8192)

    run()  # warm-up
    cuda = torch.autograd.DeviceType.CUDA
    for name, acts, raw in (
            ("host+device, key_averages",
             [ProfilerActivity.CPU, ProfilerActivity.CUDA], False),
            ("device, key_averages", [ProfilerActivity.CUDA], False),
            ("device, raw events", [ProfilerActivity.CUDA], True)):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        if raw:
            durs = [ev.duration_ns() / 1e3
                    for ev in prof.profiler.kineto_results.events()
                    if ev.device_type() == cuda and ev.duration_ns()]
            busy_us, launches = sum(durs), len(durs)
        else:
            rows = [ev for ev in prof.key_averages()
                    if ev.device_type == cuda and ev.self_device_time_total]
            busy_us = sum(ev.self_device_time_total for ev in rows)
            launches = sum(ev.count for ev in rows)
        print(json.dumps({"way": name, "run_wall_s": wall,
                          "exit_s": t1 - t0 - wall,
                          "sum_s": time.perf_counter() - t1,
                          "device_busy_us": busy_us,
                          "launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
