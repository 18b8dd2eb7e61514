#!/usr/bin/env python3
"""A short look at the 1M ring's other protocols on one card, before
``chip_smoke.py``'s phase 4t checks them in full.

    python3 tools/ring_probe.py

Prints the card's ``nvidia-smi`` line, then:

- the row sum at the ring's per-shard shape, f32 ``[8, 125008]``: the
  kernel's, its plain version's and ``sum(dim=1)``'s mean ms over
  back-to-back launches (CUDA events, no L2 flush), and whether the
  kernel's bits equal the plain version's;
- phase 4's graph (``watts_strogatz(1_000_000, 10, 0.1, seed=0)``)
  sharded 8 ways in each layout, and on each: SIR with ``exact_rng=True``
  (held to ``chip_smoke.EXPECTED_SIR``) and with the default draws, and
  the run to 0.5; PageRank (21 rounds, and to ``EXPECTED_PAGERANK``'s
  threshold) and push-sum (30 rounds) under ``mxu`` and ``hybrid``; hop
  distance to the end and leader election under ``segment`` (held to
  ``chip_smoke.EXPECTED_ANALYTICS``). A line per run: the first run's and
  a second run's host seconds and the first run's launches by kernel.

Needs one CUDA card; exits 2 without one.
"""

import hashlib
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as C  # noqa: E402


def ms_per_launch(fn, n):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(True), torch.cuda.Event(True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def main() -> int:
    if not torch.cuda.is_available():
        print("ring_probe: no CUDA device", file=sys.stderr)
        return 2
    from p2pnetwork_tpu_torch import _build, _device
    from p2pnetwork_tpu_torch.models import (SIR, HopDistance, PageRank,
                                             PushSum)
    from p2pnetwork_tpu_torch.ops import ring, rowsum, segsum, threefry
    from p2pnetwork_tpu_torch.parallel import mesh as M
    from p2pnetwork_tpu_torch.parallel import sharded as S
    from p2pnetwork_tpu_torch.sim import graph as G

    print(C.gpu_line(), flush=True)
    _build.library()
    x = torch.randn(C.RING_SHARDS, C.RING_BLOCK, device="cuda")
    print(json.dumps({
        "rowsum_ms": ms_per_launch(lambda: rowsum.row_sum(x), 10),
        "plain_ms": ms_per_launch(lambda: rowsum.row_sum_plain(x), 5),
        "sum_dim1_ms": ms_per_launch(lambda: x.sum(dim=1), 20),
        "exact": bool(torch.equal(
            rowsum.row_sum(x).view(torch.int32),
            rowsum.row_sum_plain(x).view(torch.int32)))}), flush=True)
    g = G.watts_strogatz(C.N_NODES, 10, 0.1, seed=0)
    mesh = M.ring_mesh(C.RING_SHARDS)

    def run(label, fn):
        segsum.LAUNCHES = ring.SEGSUM_LAUNCHES = ring.SHIFT_LAUNCHES = 0
        threefry.LAUNCHES = rowsum.LAUNCHES = _device.SYNCS = 0
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if len(walls) == 1:
                counts = {"segsum": segsum.LAUNCHES,
                          "ring_segsum": ring.SEGSUM_LAUNCHES,
                          "ring_shift": ring.SHIFT_LAUNCHES,
                          "threefry": threefry.LAUNCHES,
                          "rowsum": rowsum.LAUNCHES, "syncs": _device.SYNCS}
        print(json.dumps({"run": label, "first_s": walls[0],
                          "second_s": walls[1], **counts}), flush=True)
        return out

    def sha(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()

    for layout, kw in C.RING_LAYOUTS:
        sg = S.shard_graph(g, mesh, **kw)
        sir = SIR(**C.SIR_RUNG)
        status, stats = run(f"sir-exact-{layout}", lambda: S.sir(
            sg, mesh, sir, C.KEY, C.SIR_ROUNDS, exact_rng=True))
        got = {k: v.tolist() for k, v in stats.items()}
        got["status_sha256"] = sha(status)
        print(json.dumps({"sir_exact_equals_reference":
                          got == C.EXPECTED_SIR}), flush=True)
        run(f"sir-fold-{layout}",
            lambda: S.sir(sg, mesh, sir, C.KEY, C.SIR_ROUNDS))
        run(f"sir-coverage-{layout}", lambda: S.sir_until_coverage(
            sg, mesh, sir, C.KEY, coverage_target=0.5, max_rounds=64))
        if layout == "segment":
            (dist, _, _), _ = run("hopdist", lambda: S.hopdist_until_done(
                sg, mesh, HopDistance(source=0)))
            known, _ = run("leader", lambda: S.leader_until_quiet(sg, mesh))
            print(json.dumps({
                "hop_equals_reference": sha(dist)
                == C.EXPECTED_ANALYTICS["hop"]["sha256"],
                "leader_equals_reference": sha(known)
                == C.EXPECTED_ANALYTICS["leader"]["sha256"]}), flush=True)
        else:
            run(f"pagerank-{layout}", lambda: S.pagerank(
                sg, mesh, PageRank(), 21))
            run(f"pagerank-until-{layout}", lambda: S.pagerank_until_residual(
                sg, mesh, PageRank(), tol=C.EXPECTED_PAGERANK["threshold"]))
            run(f"pushsum-{layout}", lambda: S.pushsum(
                sg, mesh, PushSum(), C.KEY, 30))
        del sg
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
