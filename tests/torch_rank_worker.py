"""The rank side of ``tests/test_torch_multihost.py``: the reference's
two-process phase suite (``tests/multihost_worker.py``, phases 1-3) on the
port's ring split over ranks, run in each rank process by
``parallel/multihost.launch``. It imports torch and the port only.

Each rank returns its local results (its shards' rows and the global
summaries) as numpy arrays and Python values; the test gathers the rows
in rank order and holds them to the JAX ring and the port's one-process
ring.
"""

import numpy as np
import torch

#: The reference worker's graph: ``G.watts_strogatz(512, 6, 0.2, seed=0)``.
GRAPH = (512, 6, 0.2)
LAYOUTS = {"segment": {}, "mxu": {"mxu": True}, "hybrid": {"hybrid": True}}
FAIL_IDS = (3, GRAPH[0] // 2)
GOSSIP = dict(alpha=0.5, key=1, rounds=5)
SIGNAL_SEED = 7


def signal(n_pad: int) -> np.ndarray:
    """The f32 signal of the ``propagate("sum")`` check, ``[n_pad]``."""
    return np.random.default_rng(SIGNAL_SEED).standard_normal(
        n_pad).astype(np.float32)


def suite(n_shards: int, device: str = "cpu") -> dict:
    """Phases 1-3 of the reference worker and a ``propagate`` of each op
    on this rank's shards of ``n_shards`` (all of them in one process)."""
    torch.set_num_threads(1)
    from p2pnetwork_tpu_torch import prng
    from p2pnetwork_tpu_torch.models.gossip import Gossip
    from p2pnetwork_tpu_torch.parallel import multihost, sharded
    from p2pnetwork_tpu_torch.sim import graph as G

    multi = multihost.initialize_distributed()
    mesh = multihost.hierarchical_ring_mesh(n_shards=n_shards,
                                            device=device)
    g = G.watts_strogatz(*GRAPH, seed=0, device=mesh.device)
    out = {"rank": mesh.rank, "shard_lo": mesh.shard_lo,
           "order": mesh.order, "multi": multi}
    for layout, kw in LAYOUTS.items():
        sg = sharded.shard_graph(g, mesh, **kw)
        seen, res = sharded.flood_until_coverage(sg, mesh, 0,
                                                 coverage_target=0.99)
        sig = torch.from_numpy(signal(sg.n_nodes_padded)).reshape(
            n_shards, sg.block)[sg.shard_lo:sg.shard_lo + sg.n_local].to(
                mesh.device)
        out[layout] = {"seen": _np(seen), "out": res,
                       "sum": _np(sharded.propagate(sg, mesh, sig, "sum"))}
        if layout == "segment":
            out[layout].update(
                max=_np(sharded.propagate(sg, mesh, sig, "max")),
                minplus=_np(sharded.propagate(sg, mesh, sig.abs(),
                                              "minplus")),
                orr=_np(sharded.propagate(sg, mesh, sig > 1.0, "or")))
    sg = sharded.shard_graph(g, mesh)
    vals, stats = sharded.gossip(sg, mesh, Gossip(alpha=GOSSIP["alpha"]),
                                 prng.key(GOSSIP["key"]), GOSSIP["rounds"],
                                 exact_rng=True)
    out["gossip"] = {"values": _np(vals),
                     **{k: _np(v) for k, v in stats.items()}}
    n = g.n_nodes
    sgc = sharded.with_capacity(sharded.fail_nodes(sg, list(FAIL_IDS)), 8)
    sgc = sharded.connect(sgc, [1], [n - 2])
    seen, res = sharded.flood_until_coverage(sgc, mesh, 0,
                                             coverage_target=0.9)
    out["churn"] = {"seen": _np(seen), "out": res,
                    "out_degree": _np(sgc.out_degree),
                    "in_degree": _np(sgc.in_degree),
                    "neighbors_mask": _np(sgc.neighbors_mask)}
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def gather(parts: list) -> dict:
    """The ranks' results of :func:`suite`: each phase's rows stacked in
    rank order (``[S, ...]``); each summary and per-round stat, which
    every rank computes whole, checked equal across the ranks."""
    def one(rows):
        if isinstance(rows[0], dict) or rows[0].ndim == 1:
            assert all(_equal(r, rows[0]) for r in rows), rows
            return rows[0]
        return np.concatenate(rows)

    return {phase: {k: one([p[phase][k] for p in parts])
                    for k in parts[0][phase]}
            for phase in list(LAYOUTS) + ["gossip", "churn"]}


def _equal(a, b) -> bool:
    return a == b if isinstance(a, dict) else np.array_equal(a, b)


def fail_on(rank: int, pid_dir: str) -> None:
    """Write this rank's pid into ``pid_dir``, then raise on ``rank``;
    the others wait in a collective that does not complete (``rank`` -1:
    every rank waits, a hang), which the launcher must stop."""
    import os
    import time

    import torch.distributed as dist

    me = dist.get_rank()
    with open(os.path.join(pid_dir, f"pid{me}"), "w") as f:
        f.write(str(os.getpid()))
    dist.barrier()  # every pid is written before any rank fails
    if me == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    if rank < 0:
        time.sleep(3600)
    dist.barrier()


def _global_stack(mesh, step: int, width: int, device) -> torch.Tensor:
    """The ring's whole ``[S, width]`` i32 payload of the ordering check:
    every element names its shard, its step and its offset."""
    g = torch.arange(mesh.n_shards, device=device, dtype=torch.int32)
    j = torch.arange(width, device=device, dtype=torch.int32)
    return g[:, None] * 1_000_003 + step * 7919 + j[None, :]


def card_puts(n_shards: int, steps: int, delay_rank: int) -> dict:
    """The cross-rank kernels on the card against their plain versions and
    the global ``torch.roll`` of the stacked blocks (gathered through the
    group), then ``steps`` hops of a payload that names its shard and step,
    one rank held back by a sleep kernel before each put (and on the host
    every 64 steps), every landed block checked."""
    import time

    from p2pnetwork_tpu_torch.ops import ring, segsum
    from p2pnetwork_tpu_torch.parallel import mesh as M
    from p2pnetwork_tpu_torch.parallel import multihost

    mesh = multihost.hierarchical_ring_mesh(n_shards=n_shards)
    dev, lo, L = mesh.device, mesh.shard_lo, mesh.n_local
    gen = torch.Generator(device=dev).manual_seed(11 + mesh.rank)
    errors = []

    def want(x, reverse):
        whole = M.gather_shards(mesh, x.view(torch.uint8)
                                if x.dtype == torch.bool else x)
        return torch.roll(whole, -1 if reverse else 1, 0)[lo:lo + L].view(
            x.dtype)

    def check(name, got, expect):
        if got.dtype != expect.dtype or not torch.equal(got, expect):
            errors.append(name)

    # A 16-byte shard first: the rank's IPC channel is made for it, then
    # made anew (on every rank at the same hop) for the wider payloads.
    for dtype, width in ((torch.bool, 16), (torch.bool, 125008),
                         (torch.float32, 125008), (torch.int32, 1001),
                         (torch.bool, 1001), (torch.bool, 125007)):
        x = torch.randint(0, 1 << 20, (L, width), generator=gen, device=dev,
                          dtype=torch.int32)
        x = (x % 2 == 1) if dtype == torch.bool else x.to(dtype)
        for reverse in (False, True):
            expect = want(x, reverse)
            check(f"ring_put {dtype} {width} reverse={reverse}",
                  ring.ring_put(x, mesh, reverse), expect)
            check(f"ring_put_plain {dtype} {width} reverse={reverse}",
                  ring.ring_put_plain(x, mesh, reverse), expect)

    nb, w, block = 245, 64, 512
    B = 125008
    src = torch.randint(0, B, (L, nb, w), generator=gen, device=dev,
                        dtype=torch.int32)
    dst = torch.randint(0, block, (L, nb, w), generator=gen, device=dev,
                        dtype=torch.int32).sort(dim=2).values
    mask = torch.rand((L, nb, w), generator=gen, device=dev) < 0.7
    extent = torch.full((L, nb), w, dtype=torch.int32, device=dev)
    rot_or = torch.rand((L, B), generator=gen, device=dev) < 0.3
    rot_sum = torch.randint(-8, 8, (L, B), generator=gen, device=dev).to(
        torch.float32)  # integer-valued: exact in any order
    for kind, rot in (("or", rot_or), ("sum", rot_sum)):
        fused = getattr(ring, f"ring_put_segsum_{kind}")
        plain = getattr(ring, f"ring_put_segsum_{kind}_plain")
        p_next, p_out = plain(rot, mesh, src, dst, mask, block)
        check(f"ring_put_segsum_{kind}_plain hop", p_next, want(rot, False))
        for ext in (None, extent):
            got_next, got_out = fused(rot, mesh, src, dst, mask, block,
                                      extent=ext)
            tag = f"ring_put_segsum_{kind} extent={ext is not None}"
            check(f"{tag} hop", got_next, p_next)
            check(f"{tag} sum", got_out, p_out)

    width = 125008
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    counts0 = (ring.PUT_LAUNCHES, ring.LAND_LAUNCHES)
    for s in range(steps):
        if mesh.rank == delay_rank:
            torch.cuda._sleep(100_000)
            if s % 64 == 0:
                time.sleep(0.05)
        whole = _global_stack(mesh, s, width, dev)
        reverse = s % 3 == 2
        got = ring.ring_put(whole[lo:lo + L].contiguous(), mesh, reverse)
        expect = torch.roll(whole, -1 if reverse else 1, 0)[lo:lo + L]
        bad += (got != expect).sum()
    torch.cuda.synchronize()
    return {"errors": errors, "bad": int(bad), "steps": steps,
            "puts": ring.PUT_LAUNCHES - counts0[0],
            "lands": ring.LAND_LAUNCHES - counts0[1]}
