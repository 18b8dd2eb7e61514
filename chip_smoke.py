#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``p2pnetwork_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py     # needs one CUDA card

Phases, in order; any failure exits non-zero before the result line:

1. Device: the card's name and power limit, as ``nvidia-smi`` reports them.
2. Build: the CUDA kernels from ``p2pnetwork_tpu_torch/csrc`` (nvcc, sm_90a).
3. Kernel vs plain version, on seeded random inputs at the 1M-node
   shapes, L2 flushed before each timed launch (CUDA events). Each row
   times the kernel, its plain version and one PyTorch call:
   - B1, the segment sum, at the single-device path's two layouts — the
     hybrid remainder ``[1954, 640]`` with ``block=512`` and the blocked
     layout ``[7813, 1408]`` with ``block=128`` — and its stacked-shard
     entry on the ring's hybrid buckets ``[8, 245, 128]`` (a strided step
     slice). OR bit-equal, f32 sum within ``rtol = atol = 1e-5``, exact on
     integer values. Library call: ``scatter_add_`` on pre-gathered terms.
     Beside the two single-device layouts, ``local_src_ms``: the same rows
     with sources drawn from ``LOCAL_SOURCES`` nodes, whose gathers stay
     in L1/L2 (the gap to ``ms`` is the cost of gathers spread over the
     whole signal).
   - B2, the ring hop, on bool and f32 ``[8, 125008]``, both directions:
     bit-equal. Library call: ``torch.roll``.
   - B3, the fused ring step, on ``rot [8, 125008]`` with the ``mxu``
     layout's buckets ``[8, 245, 4864]``, block 512: OR and ``rot_next``
     bit-equal, sum within tolerance, integer sum exact. Library call:
     ``scatter_add_`` on pre-gathered terms.
   Then the row engine's edge geometries, each against its plain version
   (OR bit-equal, integer sums exact, f32 sums within tolerance): B1 at
   an odd width (1407), rows not 16-byte aligned, narrow rows (W = 128,
   32), ``block`` 1 and ``MAX_BLOCK``, row counts that leave the
   persistent grid's last block one row, and a strided, unaligned stacked
   slice (with B3); B2 at per-shard sizes that are not multiples of 16
   bytes, both directions.
4. Main path: the 1M-node Watts–Strogatz graph flooded from node 0 to 99%
   coverage by ``run_until_coverage`` with ``Flood(pallas)``,
   ``Flood(hybrid)``, ``AdaptiveFlood(hybrid, k=1024)`` and ``k=2048``.
   Each must return the JAX reference's numbers exactly, and the kernel
   must have been launched in each run. Then each method's steady-state
   wall time (median of 5) and one run under ``torch.profiler``: device
   kernel time, launches and idle share.
4b. Ring: the same graph sharded 8 ways on the card
   (``parallel.sharded.shard_graph``) in the ``segment``, ``mxu`` and
   ``hybrid`` layouts, each flooded to 99% by ``flood_until_coverage``
   with the default comm (the CUDA ring kernels). Each must return the
   same numbers and the same final ``seen`` as phase 4, and launch the
   layout's kernels: B2 (segment), B3 and B1 (mxu), B2 and B1 (hybrid).
   On ``mxu`` one integer-valued ``propagate(op="sum")`` must equal the
   ``comm="ppermute"`` result exactly. Then wall, syncs and a profile per
   layout, as in phase 4.
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
#: ``segment``), and so does its 8-shard ring in each layout. Regenerate on
#: the CPU with the JAX package:
#:   JAX_PLATFORMS=cpu python -c "import jax; from p2pnetwork_tpu.sim import graph as G, engine; from p2pnetwork_tpu.models import Flood; g = G.watts_strogatz(1_000_000, 10, 0.1, seed=0, blocked=True, hybrid=True, source_csr=True); print(engine.run_until_coverage(g, Flood(method='segment'), jax.random.key(0), coverage_target=0.99, max_rounds=64)[1])"
#: and, for the ring (add ``mxu=True`` or ``hybrid=True`` to shard_graph):
#:   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 python -c "from p2pnetwork_tpu.sim import graph as G; from p2pnetwork_tpu.parallel import mesh, sharded; m = mesh.ring_mesh(8); g = G.watts_strogatz(1_000_000, 10, 0.1, seed=0); print(sharded.flood_until_coverage(sharded.shard_graph(g, m), m, 0, coverage_target=0.99, max_rounds=64, comm='ppermute')[1])"
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

#: The ring at 1M nodes and 8 shards: the shard block, and (layout, NB, W,
#: live share) of one ring step's buckets ``[8, NB, W]``, block 512. Live
#: shares are the whole layouts' (9,999,994 of 8·8·245·4864 slots for
#: ``mxu``; 999,700 of 8·8·245·128 for ``hybrid``), from the JAX package's
#: shard_graph at 1M on the CPU.
RING_SHARDS = 8
RING_BLOCK = 125_008
RING_MXU = ("mxu", 245, 4864, 0.131)
RING_HYBRID = ("hybrid", 245, 128, 0.498)
RING_LAYOUTS = [("segment", {}), ("mxu", {"mxu": True}),
                ("hybrid", {"hybrid": True})]

#: H100 SXM data-sheet peaks: HBM bytes/s and non-tensor f32 ops/s.
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12

RTOL = ATOL = 1e-5

#: B1's edge geometries (label, NB, W, block, offset in elements of the
#: rows into their buffers). At block 1 a row's ~26 live slots all sum
#: into one element, about the blocked layout's 10 terms per output: a
#: row of hundreds of N(0, 1) terms would leave f32 rounding of an
#: unordered sum above rtol = atol = 1e-5 on either side. Row counts 2 * 132 * m - 1 leave the
#: persistent grid's last block one row whatever the residency m (blocks
#: per SM, at most 8) on 132 SMs; 132 * m + 1 give its first block one row
#: more than the others.
B1_EDGES = [("odd-width", 300, 1407, 128, 0),
            ("rows-unaligned", 300, 1408, 128, 1),
            ("mask-unaligned", 300, 1408, 128, 4),
            ("narrow-128", 245, 128, 512, 0),
            ("narrow-32", 245, 32, 512, 0),
            ("block-1", 64, 32, 1, 0),
            ("block-max", 64, 640, None, 0),
            ("block-max-narrow", 64, 128, None, 0),
            *[(f"grid-last-one-{m}", 2 * 132 * m - 1, 640, 128, 0)
              for m in range(1, 9)],
            *[(f"grid-first-extra-{m}", 132 * m + 1, 640, 128, 0)
              for m in range(1, 9)]]
#: B2's per-shard payloads that are not multiples of 16 bytes.
B2_EDGES = [(torch.bool, (RING_SHARDS, RING_BLOCK - 1)),
            (torch.uint8, (RING_SHARDS, 17)),
            (torch.int32, (RING_SHARDS, 3, 31))]


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


def ring_buckets(gen, nb, w, block, live):
    """Seeded random buckets of one ring step, as the ring passes them:
    the strided slice ``[:, 1]`` of ``[8, 2, NB, W]`` arrays."""
    dev = torch.device("cuda")
    shape = (RING_SHARDS, 2, nb, w)
    src = torch.randint(0, RING_BLOCK, shape, generator=gen, device=dev,
                        dtype=torch.int32)
    dst = torch.randint(0, block, shape, generator=gen, device=dev,
                        dtype=torch.int32)
    mask = torch.rand(shape, generator=gen, device=dev) < live
    return src[:, 1], dst[:, 1], mask[:, 1]


def ring_signals(gen):
    """Bool, f32 and integer-valued f32 ``rot [8, 125008]``."""
    shape, dev = (RING_SHARDS, RING_BLOCK), torch.device("cuda")
    return (torch.rand(shape, generator=gen, device=dev) < 0.1,
            torch.randn(shape, generator=gen, device=dev),
            torch.randint(0, 16, shape, generator=gen,
                          device=dev).to(torch.float32))


def pregathered(sig, src, mask):
    """The terms a ``scatter_add_`` yardstick sums, gathered up front."""
    flat = src.reshape(src.shape[0], -1).long()
    terms = sig.gather(1, flat).reshape(src.shape).to(torch.float32)
    return (terms * mask).reshape(-1, src.shape[-1])


def ring_kernel_phase(ring, segsum, flush):
    """Phase 3, the ring's kernels: B1's stacked entry, B2 and B3 against
    their plain versions at the 1M/S=8 shapes."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = torch.device("cuda")
    flags, x, xi = ring_signals(gen)
    rows, max_err = [], {"segsum": 0.0, "ring_shift": 0.0,
                         "ring_segsum": 0.0}

    # B2: the hop.
    for sig, tag in ((flags, "bool"), (x, "f32")):
        for reverse in (False, True):
            if not torch.equal(ring.ring_shift(sig, reverse=reverse),
                               ring.ring_shift_plain(sig, reverse=reverse)):
                fail(f"ring_shift differs from its plain version ({tag}, "
                     f"reverse={reverse})")
        nbytes = sig.numel() * sig.element_size()
        rows.append({
            "kernel": "ring_shift", "entry": tag,
            "shape": list(sig.shape),
            "ms": cuda_times(lambda: ring.ring_shift(sig), 50, flush),
            "plain_ms": cuda_times(lambda: ring.ring_shift_plain(sig), 50,
                                   flush),
            "library_ms": cuda_times(lambda: torch.roll(sig, 1, 0), 50,
                                     flush),
            "bound_ms": 1e3 * 2 * nbytes / HBM_BYTES_PER_S,
            "bound_by": "bytes"})

    # B1 stacked (hybrid buckets) and B3 (mxu buckets), block 512.
    block = 512
    for kernel, (layout, nb, w, live) in (("segsum", RING_HYBRID),
                                          ("ring_segsum", RING_MXU)):
        src, dst, mask = ring_buckets(gen, nb, w, block, live)
        args = (src, dst, mask, block)
        live_slots = int(mask.sum().item())
        lib_out = torch.zeros(RING_SHARDS * nb, block, device=dev)
        dst64 = dst.reshape(-1, w).long()
        for entry, sig in (("or", flags), ("sum", x)):
            if kernel == "segsum":
                fn = getattr(segsum, f"segsum_{entry}")
                plain = getattr(segsum, f"segsum_{entry}_plain")
                got, want = fn(sig, *args), plain(sig, *args)
                exact = entry == "or" or torch.equal(
                    fn(xi, *args), plain(xi, *args))
            else:
                fn = getattr(ring, f"ring_segment_sum_{entry}")
                plain = getattr(ring, f"ring_segment_sum_{entry}_plain")
                (rot_next, got), (want_next, want) = (fn(sig, *args),
                                                      plain(sig, *args))
                if not torch.equal(rot_next, want_next):
                    fail(f"ring_segment_sum_{entry}: rot_next differs")
                exact = entry == "or" or torch.equal(
                    fn(xi, *args)[1], plain(xi, *args)[1])
            if entry == "or" and not torch.equal(got, want):
                fail(f"{kernel} OR differs from its plain version")
            if not exact:
                fail(f"{kernel} sum inexact on integer values")
            err = (got.float() - want.float()).abs().max().item()
            max_err[kernel] = max(max_err[kernel], err)
            if not torch.allclose(got.float(), want.float(), rtol=RTOL,
                                  atol=ATOL):
                fail(f"{kernel} {entry} outside rtol=atol={RTOL}: {err}")
            torch.cuda.synchronize()
            sig_bytes = sig.numel() * sig.element_size()
            out_bytes = RING_SHARDS * nb * block * sig.element_size()
            if kernel == "ring_segsum":  # the hop writes rot_next too
                out_bytes += sig_bytes
            least, bound_by = bound(RING_SHARDS * nb, w, live_slots,
                                    sig_bytes, out_bytes)
            terms = pregathered(sig, src, mask)
            rows.append({
                "kernel": kernel, "layout": layout, "entry": entry,
                "shape": [RING_SHARDS, nb, w], "block": block,
                "live_slots": live_slots,
                "ms": cuda_times(lambda: fn(sig, *args), 50, flush),
                "plain_ms": cuda_times(lambda: plain(sig, *args), 20, flush),
                "library_ms": cuda_times(
                    lambda: lib_out.scatter_add_(1, dst64, terms), 50, flush),
                "bound_ms": least, "bound_by": bound_by})
    return rows, max_err


#: Sources drawn from this many nodes only, for ``local_src_ms``: the
#: same rows with gathers that stay in L1/L2.
LOCAL_SOURCES = 4096


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
        local_src = src % LOCAL_SOURCES
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
                "local_src_ms": cuda_times(
                    lambda: kernel(sig, local_src, dst, mask, block), 50,
                    flush),
                "bound_ms": least, "bound_by": bound_by,
            })
    return rows, max_err


def check_b1(segsum, label, flags, x, xi, src, dst, mask, block) -> float:
    """B1 (single or stacked) against its plain version on one geometry:
    OR bit-equal, f32 sum within tolerance, integer-valued sum exact.
    Returns the sum's max abs error."""
    args = (src, dst, mask, block)
    if not torch.equal(segsum.segsum_or(flags, *args),
                       segsum.segsum_or_plain(flags, *args)):
        fail(f"segsum_or differs from its plain version ({label})")
    got, want = segsum.segsum_sum(x, *args), segsum.segsum_sum_plain(x, *args)
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        fail(f"segsum_sum outside rtol=atol={RTOL} ({label}): {err}")
    if not torch.equal(segsum.segsum_sum(xi, *args),
                       segsum.segsum_sum_plain(xi, *args)):
        fail(f"segsum_sum inexact on integer values ({label})")
    return err


def edge_phase(ring, segsum) -> dict:
    """Phase 3, the row engine's edge geometries and B2's odd payloads,
    each against its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    dev = torch.device("cuda")
    flags = torch.rand(N_PAD, generator=gen, device=dev) < 0.1
    x = torch.randn(N_PAD, generator=gen, device=dev)
    xi = torch.randint(-8, 8, (N_PAD,), generator=gen,
                       device=dev).to(torch.float32)
    errs = {}
    for label, nb, w, block, offset in B1_EDGES:
        block = block or segsum.MAX_BLOCK

        def rows(t):  # contiguous [nb, w] rows `offset` elements in
            flat = torch.empty(offset + nb * w, dtype=t.dtype, device=dev)
            flat[offset:] = t.reshape(-1)
            return flat[offset:].view(nb, w)

        src = rows(torch.randint(0, N_PAD, (nb, w), generator=gen,
                                 device=dev, dtype=torch.int32))
        dst = rows(torch.randint(0, block, (nb, w), generator=gen,
                                 device=dev, dtype=torch.int32))
        mask = rows(torch.rand(nb, w, generator=gen, device=dev) < 0.8)
        errs[label] = check_b1(segsum, label, flags, x, xi, src, dst, mask,
                               block)

    # A stacked step slice [:, 1] of [3, 3, 5, 130] buckets: W = 130 and
    # the slice 650 elements in, so no row is 16-byte aligned. B1's
    # stacked entry and B3.
    s, nb, w, block, b = 3, 5, 130, 128, 300
    shape = (s, s, nb, w)
    src = torch.randint(0, b, shape, generator=gen, device=dev,
                        dtype=torch.int32)[:, 1]
    dst = torch.randint(0, block, shape, generator=gen, device=dev,
                        dtype=torch.int32)[:, 1]
    mask = (torch.rand(shape, generator=gen, device=dev) < 0.7)[:, 1]
    rot = torch.rand(s, b, generator=gen, device=dev) < 0.3
    rx = torch.randn(s, b, generator=gen, device=dev)
    rxi = torch.randint(-8, 8, (s, b), generator=gen,
                        device=dev).to(torch.float32)
    errs["stacked-unaligned"] = check_b1(segsum, "stacked-unaligned", rot,
                                         rx, rxi, src, dst, mask, block)
    for entry, sig in (("or", rot), ("sum", rx), ("sum", rxi)):
        fn = getattr(ring, f"ring_segment_sum_{entry}")
        plain = getattr(ring, f"ring_segment_sum_{entry}_plain")
        (nxt, got), (want_nxt, want) = (fn(sig, src, dst, mask, block),
                                        plain(sig, src, dst, mask, block))
        exact = entry == "or" or sig is rxi
        if not torch.equal(nxt, want_nxt) or (
                exact and not torch.equal(got, want)) or not torch.allclose(
                    got.float(), want.float(), rtol=RTOL, atol=ATOL):
            fail(f"ring_segment_sum_{entry} differs from its plain version "
                 f"(stacked-unaligned)")

    for dtype, shape in B2_EDGES:
        xs = torch.randint(0, 100, shape, generator=gen,
                           device=dev).to(dtype)
        for reverse in (False, True):
            if not torch.equal(ring.ring_shift(xs, reverse=reverse),
                               ring.ring_shift_plain(xs, reverse=reverse)):
                fail(f"ring_shift differs from its plain version on "
                     f"{dtype} {list(shape)} (reverse={reverse})")
    torch.cuda.synchronize()
    print(json.dumps({"phase": "edges", "b1_sum_max_abs_err": errs,
                      "b2": [[str(d), list(sh)] for d, sh in B2_EDGES]}),
          flush=True)
    return errs


def main_path(engine, segsum, device_mod, graph_mod, models):
    """Phase 4: the 1M-node flood contest through the port's entry points.
    Returns the kernel launches counted over the four checked runs, the
    graph and the final ``seen`` every method reached."""
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
        seen = state.seen
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
        run["profile"] = profile_run(lambda: engine.run_until_coverage(
            g, proto, coverage_target=0.99, max_rounds=64))
        print(json.dumps({"phase": "main-path", **run}), flush=True)
    return total_launches, g, seen


#: Launches each ring layout must make (> 0): kernel name -> counter.
RING_EXPECT = {"segment": ("ring_shift",),
               "mxu": ("ring_segsum", "segsum"),
               "hybrid": ("ring_shift", "segsum")}


def ring_counts(ring, segsum) -> dict:
    return {"segsum": segsum.LAUNCHES, "ring_shift": ring.SHIFT_LAUNCHES,
            "ring_segsum": ring.SEGSUM_LAUNCHES}


def reset_counts(ring, segsum, device_mod) -> None:
    segsum.LAUNCHES = ring.SHIFT_LAUNCHES = ring.SEGSUM_LAUNCHES = 0
    device_mod.SYNCS = 0


def ring_path(g, want_seen, ring, segsum, device_mod, sharded, mesh_mod):
    """Phase 4b: phase 4's graph sharded 8 ways on the card, flooded to
    99% in each layout with the default comm. Returns each kernel's
    launches summed over the three checked runs."""
    mesh = mesh_mod.ring_mesh(RING_SHARDS)
    totals = dict.fromkeys(ring_counts(ring, segsum), 0)
    for layout, kw in RING_LAYOUTS:
        t0 = time.perf_counter()
        sg = sharded.shard_graph(g, mesh, **kw)
        torch.cuda.synchronize()
        print(json.dumps({
            "phase": "ring-graph", "layout": layout,
            "build_s": time.perf_counter() - t0, "block": sg.block,
            "bkt": list(sg.bkt_src.shape),
            "mxu": None if sg.mxu_src is None else list(sg.mxu_src.shape),
            "live_slots": int(sg.bkt_mask.sum().item()),
            "mxu_live_slots": None if sg.mxu_mask is None
            else int(sg.mxu_mask.sum().item()),
            "diag_pieces": len(sg.diag_pieces)}), flush=True)

        def run():
            return sharded.flood_until_coverage(
                sg, mesh, 0, coverage_target=0.99, max_rounds=64)

        reset_counts(ring, segsum, device_mod)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seen, out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ring_counts(ring, segsum)
        syncs = device_mod.SYNCS
        if out != EXPECTED_1M:
            fail(f"ring {layout} returned {out}, the reference gives "
                 f"{EXPECTED_1M}")
        if seen.shape != (RING_SHARDS, sg.block) or not torch.equal(
                seen.reshape(-1)[:N_PAD], want_seen):
            fail(f"ring {layout}: final seen differs from phase 4's")
        missing = [k for k in RING_EXPECT[layout] if launches[k] == 0]
        if missing:
            fail(f"ring {layout} never launched {missing}")
        for k, n in launches.items():
            totals[k] += n
        record = {"layout": layout, "first_run_s": wall,
                  "launches": launches, "syncs": syncs}
        if layout == "mxu":
            gen = torch.Generator(device="cuda").manual_seed(2)
            sig = torch.randint(0, 16, (RING_SHARDS, sg.block),
                                generator=gen, device="cuda").to(torch.float32)
            if not torch.equal(
                    sharded.propagate(sg, mesh, sig, "sum"),
                    sharded.propagate(sg, mesh, sig, "sum", comm="ppermute")):
                fail("ring mxu: integer-valued propagate(sum) differs "
                     "between the kernels and comm='ppermute'")
            record["propagate_sum_exact"] = True
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        record["wall_s"] = sorted(times)[len(times) // 2]
        record["wall_s_all"] = times
        record["profile"] = profile_run(run)
        print(json.dumps({"phase": "ring-path", **record}), flush=True)
        del sg
        torch.cuda.empty_cache()
    return totals


def profile_run(run) -> dict:
    """One ``run()`` under torch.profiler: wall time, device kernel time
    and launches, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
            "segsum_us": sum(us for us, k, _ in rows
                             if "segsum" in k and "ring" not in k),
            "ring_us": sum(us for us, k, _ in rows if "ring_" in k),
            "top": [{"kernel": k[:100], "us": us, "count": c}
                    for us, k, c in rows[:6]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing checked", file=sys.stderr)
        return 2
    from p2pnetwork_tpu_torch import _build, _device
    from p2pnetwork_tpu_torch.models.adaptive_flood import AdaptiveFlood
    from p2pnetwork_tpu_torch.models.flood import Flood
    from p2pnetwork_tpu_torch.ops import ring, segsum
    from p2pnetwork_tpu_torch.parallel import mesh as mesh_mod
    from p2pnetwork_tpu_torch.parallel import sharded
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

    # 3. Kernel vs plain version, edge geometries.
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    rows, max_err = kernel_phase(segsum, flush)
    ring_rows, ring_err = ring_kernel_phase(ring, segsum, flush)
    for row in rows + ring_rows:
        print(json.dumps({"phase": "kernel", **row}), flush=True)
    edge_phase(ring, segsum)
    del flush

    # 4. Main path.
    launches, g, seen = main_path(engine, segsum, _device, graph_mod,
                                  (Flood, AdaptiveFlood))

    # 4b. Ring.
    ring_launches = ring_path(g, seen, ring, segsum, _device, sharded,
                              mesh_mod)

    # 5. Result. Each kernel's row is its main-path use: B1's OR entry on
    # the hybrid remainder (the adaptive and hybrid floods), B2's forward
    # hop of the bool frontier, B3's OR entry on the mxu buckets; launches
    # summed over the checked runs of phases 4 and 4b.
    def row(name, source, replaces, at, n, err):
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return {"name": name, "route": "cuda",
                "source": f"p2pnetwork_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": n, "max_abs_err": err,
                **{k: at[k] for k in keys}}

    print(json.dumps({"kernels": [
        row("segsum", "segsum.cu", "p2pnetwork_tpu/ops/pallas_edge.py:41",
            rows[0], launches + ring_launches["segsum"],
            max(max_err, ring_err["segsum"])),
        row("ring_shift", "ring.cu", "p2pnetwork_tpu/ops/pallas_ring.py:72",
            ring_rows[0], ring_launches["ring_shift"],
            ring_err["ring_shift"]),
        row("ring_segsum", "ring.cu",
            "p2pnetwork_tpu/ops/pallas_ring.py:126",
            next(r for r in ring_rows if r["kernel"] == "ring_segsum"),
            ring_launches["ring_segsum"], ring_err["ring_segsum"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
