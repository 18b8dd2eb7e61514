#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``p2pnetwork_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py     # needs one CUDA card

Phases, in order; any failure exits non-zero before the result line:

1. Device: the card's name and power limit, as ``nvidia-smi`` reports them.
2. Build: the CUDA kernels from ``p2pnetwork_tpu_torch/csrc`` (nvcc, sm_90a).
3. Kernel vs plain version: the segment-sum kernel on seeded random inputs
   at the 1M-node main path's two layouts — the hybrid remainder
   ``[1954, 640]`` with ``block=512`` and the blocked layout
   ``[7813, 1408]`` with ``block=128``. OR must be bit-equal, the f32 sum
   within ``rtol = atol = 1e-5`` and exactly equal on integer values. Times
   the kernel, its plain version and one PyTorch call (``scatter_add_`` on
   pre-gathered terms) with CUDA events, L2 flushed before each launch.
4. Main path: the 1M-node Watts–Strogatz graph flooded from node 0 to 99%
   coverage by ``run_until_coverage`` with ``Flood(pallas)``,
   ``Flood(hybrid)``, ``AdaptiveFlood(hybrid, k=1024)`` and ``k=2048``.
   Each must return the JAX reference's numbers exactly, and the kernel
   must have been launched in each run. Then each method's steady-state
   wall time (median of 5) and one run under ``torch.profiler``: device
   kernel time, launches and idle share.
5. Result: a JSON line of kernel numbers, then the last line
   ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

#: The JAX reference's run-to-0.99 summary on the 1M-node benchmark graph.
#: Every method returns it (the reference pins them bit-identical to
#: ``segment``). Regenerate on the CPU with the JAX package:
#:   JAX_PLATFORMS=cpu python -c "import jax; from p2pnetwork_tpu.sim import graph as G, engine; from p2pnetwork_tpu.models import Flood; g = G.watts_strogatz(1_000_000, 10, 0.1, seed=0, blocked=True, hybrid=True, source_csr=True); print(engine.run_until_coverage(g, Flood(method='segment'), jax.random.key(0), coverage_target=0.99, max_rounds=64)[1])"
EXPECTED_1M = {"rounds": 11, "coverage": 0.9997529983520508,
               "messages": 9372400,
               "frontier_occupancy_mean": 0.09088654816150665}
N_NODES = 1_000_000
N_PAD = 1_000_064

#: (layout, rows, width, block, share of live slots) of the main path's
#: two kernel layouts at 1M nodes; the live shares are those of the real
#: layouts (0.80 and 0.91 at 100K nodes, measured on the CPU build).
LAYOUTS = [("hybrid-remainder", 1954, 640, 512, 0.8),
           ("blocked", 7813, 1408, 128, 0.9)]

#: H100 SXM data-sheet peaks: HBM bytes/s and non-tensor f32 ops/s.
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12

RTOL = ATOL = 1e-5


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_times(fn, reps: int, flush: torch.Tensor) -> float:
    """Mean device ms of ``fn()`` over ``reps`` launches, each after an L2
    flush. All launches are enqueued behind a device sleep, so host-side
    launch overhead leaves no gaps between the timed events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def bound(nb, w, live_slots, signal_bytes, out_bytes):
    """Least device time in ms and what sets it: every mask byte, the src
    and destination of each live slot, the signal and the output once over
    the HBM rate, or one operation per slot over the vector rate."""
    by_bytes = (nb * w + 8 * live_slots + signal_bytes + out_bytes) \
        / HBM_BYTES_PER_S
    by_ops = nb * w / VECTOR_OPS_PER_S
    if by_bytes >= by_ops:
        return 1e3 * by_bytes, "bytes"
    return 1e3 * by_ops, "operations"


def kernel_phase(segsum, flush):
    """Phase 3: kernel vs plain version at the main path's layouts."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    rows, max_err = [], 0.0
    for layout, nb, w, block, live in LAYOUTS:
        src = torch.randint(0, N_PAD, (nb, w), generator=gen, device=dev,
                            dtype=torch.int32)
        dst = torch.randint(0, block, (nb, w), generator=gen, device=dev,
                            dtype=torch.int32)
        mask = torch.rand(nb, w, generator=gen, device=dev) < live
        flags = torch.rand(N_PAD, generator=gen, device=dev) < 0.1
        x = torch.randn(N_PAD, generator=gen, device=dev)
        xi = torch.randint(0, 16, (N_PAD,), generator=gen,
                           device=dev).to(torch.float32)
        args = (src, dst, mask)

        if not torch.equal(segsum.segsum_or(flags, *args, block),
                           segsum.segsum_or_plain(flags, *args, block)):
            fail(f"segsum_or differs from its plain version ({layout})")
        got = segsum.segsum_sum(x, *args, block)
        want = segsum.segsum_sum_plain(x, *args, block)
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            fail(f"segsum_sum outside rtol=atol={RTOL} ({layout}): {err}")
        if not torch.equal(segsum.segsum_sum(xi, *args, block),
                           segsum.segsum_sum_plain(xi, *args, block)):
            fail(f"segsum_sum inexact on integer values ({layout})")
        torch.cuda.synchronize()

        contrib_or = (flags[src] & mask).to(torch.float32)
        contrib_sum = x[src] * mask.to(torch.float32)
        lib_out = torch.zeros(nb, block, device=dev)
        dst64 = dst.long()
        live_slots = int(mask.sum().item())
        for entry, sig, sig_bytes, out_bytes, contrib in (
                ("or", flags, N_PAD, nb * block, contrib_or),
                ("sum", x, 4 * N_PAD, 4 * nb * block, contrib_sum)):
            kernel = getattr(segsum, f"segsum_{entry}")
            plain = getattr(segsum, f"segsum_{entry}_plain")
            least, bound_by = bound(nb, w, live_slots, sig_bytes, out_bytes)
            rows.append({
                "layout": layout, "entry": entry, "shape": [nb, w],
                "block": block, "live_slots": live_slots,
                "ms": cuda_times(lambda: kernel(sig, *args, block), 50, flush),
                "plain_ms": cuda_times(lambda: plain(sig, *args, block), 20,
                                       flush),
                "library_ms": cuda_times(
                    lambda: lib_out.scatter_add_(1, dst64, contrib), 50,
                    flush),
                "bound_ms": least, "bound_by": bound_by,
            })
    return rows, max_err


def main_path(engine, segsum, device_mod, graph_mod, models):
    """Phase 4: the 1M-node flood contest through the port's entry points.
    Returns the kernel launches counted over the four checked runs."""
    Flood, AdaptiveFlood = models
    t0 = time.perf_counter()
    g = graph_mod.watts_strogatz(N_NODES, 10, 0.1, seed=0, blocked=True,
                                 hybrid=True, source_csr=True)
    torch.cuda.synchronize()
    rem = g.hybrid.remainder
    print(json.dumps({"phase": "graph", "build_s": time.perf_counter() - t0,
                      "n_pad": g.n_nodes_padded, "e_pad": g.n_edges_padded,
                      "diagonals": len(g.hybrid.offsets),
                      "hybrid_remainder": list(rem.src.shape),
                      "blocked": list(g.blocked.src.shape),
                      "max_out_span": g.max_out_span}), flush=True)
    contest = [("pallas", Flood(source=0, method="pallas")),
               ("hybrid", Flood(source=0, method="hybrid")),
               ("adaptive-1024", AdaptiveFlood(source=0, method="hybrid",
                                               k=1024)),
               ("adaptive-2048", AdaptiveFlood(source=0, method="hybrid",
                                               k=2048))]
    n_live = g.node_mask.sum()
    runs = []
    segsum.LAUNCHES = 0
    for name, proto in contest:
        before, device_mod.SYNCS = segsum.LAUNCHES, 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = engine.run_until_coverage(g, proto, coverage_target=0.99,
                                               max_rounds=64)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = segsum.LAUNCHES - before
        if out != EXPECTED_1M:
            fail(f"{name} returned {out}, the reference gives {EXPECTED_1M}")
        cov = ((state.seen & g.node_mask).sum().to(torch.float32)
               / n_live.to(torch.float32)).item()
        if cov != out["coverage"] or state.seen.shape != (N_PAD,):
            fail(f"{name}: final state disagrees with its summary")
        if launches == 0:
            fail(f"{name} never launched the segment-sum kernel")
        runs.append({"method": name, "first_run_s": wall,
                     "launches": launches, "syncs": device_mod.SYNCS})
    total_launches = segsum.LAUNCHES
    # Steady state and device time per method, outside the counted runs.
    for run, (_, proto) in zip(runs, contest):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.run_until_coverage(g, proto, coverage_target=0.99,
                                      max_rounds=64)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        run["wall_s"] = sorted(times)[len(times) // 2]
        run["wall_s_all"] = times
        run["profile"] = profile_run(engine, g, proto)
        print(json.dumps({"phase": "main-path", **run}), flush=True)
    return total_launches


def profile_run(engine, g, proto) -> dict:
    """One run under torch.profiler: wall time, device kernel time and
    launches, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run_until_coverage(g, proto, coverage_target=0.99,
                                  max_rounds=64)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side kernel records only (the host-side aten ops carry their
    # kernels' time as well and would count it twice).
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.self_device_time_total), reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    return {"wall_s": wall, "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / wall,
            "kernel_launches": sum(r[2] for r in rows),
            "segsum_us": sum(us for us, k, _ in rows if "segsum" in k),
            "top": [{"kernel": k[:60], "us": us, "count": c}
                    for us, k, c in rows[:6]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing checked", file=sys.stderr)
        return 2
    from p2pnetwork_tpu_torch import _build, _device
    from p2pnetwork_tpu_torch.models.adaptive_flood import AdaptiveFlood
    from p2pnetwork_tpu_torch.models.flood import Flood
    from p2pnetwork_tpu_torch.ops import segsum
    from p2pnetwork_tpu_torch.sim import engine
    from p2pnetwork_tpu_torch.sim import graph as graph_mod

    # 1. Device.
    gpu = gpu_line()
    print(gpu, flush=True)
    print(json.dumps({"phase": "device", "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "name": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count()}), flush=True)

    # 2. Build.
    _build.library()
    print(_build.LAST_BUILD["log"], flush=True)
    print(json.dumps({"phase": "build",
                      "seconds": _build.LAST_BUILD["seconds"],
                      "compiled": _build.LAST_BUILD["compiled"]}), flush=True)

    # 3. Kernel vs plain version.
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    rows, max_err = kernel_phase(segsum, flush)
    for row in rows:
        print(json.dumps({"phase": "kernel", **row}), flush=True)
    del flush

    # 4. Main path.
    launches = main_path(engine, segsum, _device, graph_mod,
                         (Flood, AdaptiveFlood))

    # 5. Result. The kernel's row is its main-path use: the OR entry on the
    # hybrid remainder that the adaptive and hybrid floods run.
    head = rows[0]
    print(json.dumps({"kernels": [{
        "name": "segsum",
        "route": "cuda",
        "source": "p2pnetwork_tpu_torch/csrc/segsum.cu",
        "replaces": "p2pnetwork_tpu/ops/pallas_edge.py:41",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
