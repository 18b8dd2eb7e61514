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
    group), the pass kernel against its plain version
    (:func:`pass_kernel_errors`), then ``steps`` hops of a payload that
    names its shard and step, one rank held back by a sleep kernel before
    each put (and on the host every 64 steps), every landed block
    checked."""
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
    # made anew (on every rank at the same hop) for the wider payloads:
    # the protocols' (election's i32 ids, the lane plane's i32 word stack
    # [L, 32, 12512] of the 100K ring) among them.
    for dtype, shape in ((torch.bool, (16,)), (torch.bool, (125008,)),
                         (torch.float32, (125008,)), (torch.int32, (1001,)),
                         (torch.int32, (125008,)), (torch.int32, (32, 12512)),
                         (torch.bool, (1001,)), (torch.bool, (125007,))):
        x = torch.randint(0, 1 << 20, (L, *shape), generator=gen,
                          device=dev, dtype=torch.int32)
        x = (x % 2 == 1) if dtype == torch.bool else x.to(dtype)
        for reverse in (False, True):
            expect = want(x, reverse)
            check(f"ring_put {dtype} {shape} reverse={reverse}",
                  ring.ring_put(x, mesh, reverse), expect)
            check(f"ring_put_plain {dtype} {shape} reverse={reverse}",
                  ring.ring_put_plain(x, mesh, reverse), expect)

    for kind in ("or", "sum"):
        errors += pass_kernel_errors(mesh, kind)

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


# ------------------------------------------- the ring's protocols by rank

#: ``protocols``' parameters (``tests/test_torch_multihost_protocols.py``
#: runs the JAX ring and the one-process port on the same ones).
SIR_KW = dict(beta=0.3, gamma=0.1, source=0)
SIR_TARGET = 0.5
ROUNDS = 5
#: Keys, by run (``prng.key`` seeds).
KEYS = dict(sir=0, pushsum=1, gossip=1, walk=2, ckpt=2)
#: Run-to-threshold levels: on ``mxu`` and ``hybrid`` the f32 stats are
#: the reference's bits, so the stopping round is too.
PR_TOL, PS_TOL = 1e-4, 1e-3
HOP_ROUNDS = 3
WALKERS, WALK_ROUNDS, RESTART_P = 64, 8, 0.1
LANES = 64
LANE_SEED = 0
#: The PageRank node's call sequence (``node_calls``) and its threshold.
NODE_LINKS = ([1, 40], [300, 41])
NODE_CHURN = 0.05
NODE_TOL = 1e-4
#: Which of each layout's runs: consensus on the MXU layouts, max and OR
#: passes (and the lane plane) on ``segment``.
CONSENSUS_LAYOUTS = ("mxu", "hybrid")


def lane_sources(n_nodes: int) -> np.ndarray:
    return np.random.default_rng(LANE_SEED).integers(
        0, n_nodes, size=LANES).astype(np.int32)


class NodeEvents:
    """A sim node's ``node_message`` payloads (its callback)."""

    def __init__(self):
        self.events = []

    def __call__(self, event, node, other, data):
        if event == "node_message":
            self.events.append(data)


def node_calls(node, path: str) -> None:
    """The PageRank node's population calls, each collective on a ring
    split over ranks: rounds, failures, runtime links, churn, a
    checkpoint (a directory across ranks, a file in one process), then
    the run to the residual."""
    node.run_rounds(2)
    node.fail_sim_nodes(list(FAIL_IDS))
    node.connect_sim_nodes(*NODE_LINKS)
    node.inject_sim_churn(NODE_CHURN)
    node.run_rounds(1)
    node.save_checkpoint(path)
    node.run_until_converged("residual", NODE_TOL, max_rounds=64)


def _rows_and_same(rows=None, **same) -> dict:
    """A run's record: ``rows`` the rank's per-shard arrays (stacked in
    rank order by :func:`gather_runs`), ``same`` the values every rank
    holds whole (checked equal)."""
    return {"rows": {k: _np(v) for k, v in (rows or {}).items()},
            "same": {k: _np(v) if isinstance(v, torch.Tensor) else v
                     for k, v in same.items()}}


def _stats(stats) -> dict:
    return {k: _np(v) for k, v in stats.items()}


def protocols(n_shards: int, ckpt_dir: str, save: bool = False,
              device: str = "cpu") -> dict:
    """The ring's protocols on this rank's shards of ``n_shards`` (all of
    them in one process): SIR on every layout and to a coverage,
    PageRank and push-sum with their run-to-threshold loops on the MXU
    layouts, hop distance (fixed rounds and to the end) and leader
    election on ``segment``, the walk with and without restarts, the
    lane plane, the reference worker's fourth phase (gossip values saved
    with ``save_orbax`` when ``save``, then restored) and, at world 2 and
    in one process, a PageRank ``TorchSimNode`` on the ``mxu`` ring."""
    torch.set_num_threads(1)
    from p2pnetwork_tpu_torch import prng
    from p2pnetwork_tpu_torch.models import (SIR, Gossip, HopDistance,
                                             PageRank, PushSum, RandomWalks)
    from p2pnetwork_tpu_torch.models.messagebatch import BatchFlood
    from p2pnetwork_tpu_torch.parallel import multihost, sharded
    from p2pnetwork_tpu_torch.sim import checkpoint
    from p2pnetwork_tpu_torch.sim import graph as G

    multihost.initialize_distributed()
    mesh = multihost.hierarchical_ring_mesh(n_shards=n_shards,
                                            device=device)
    g = G.watts_strogatz(*GRAPH, seed=0, device=mesh.device)
    out = {"rank": mesh.rank, "world": mesh.world}
    for layout, kw in LAYOUTS.items():
        sg = sharded.shard_graph(g, mesh, **kw)
        status, st = sharded.sir(sg, mesh, SIR(**SIR_KW),
                                 prng.key(KEYS["sir"]), ROUNDS,
                                 exact_rng=True)
        out[f"sir-{layout}"] = _rows_and_same({"status": status},
                                              **_stats(st))
        if layout in CONSENSUS_LAYOUTS:
            ranks, st = sharded.pagerank(sg, mesh, PageRank(), ROUNDS)
            out[f"pagerank-{layout}"] = _rows_and_same({"ranks": ranks},
                                                       **_stats(st))
            ranks, res = sharded.pagerank_until_residual(
                sg, mesh, PageRank(), tol=PR_TOL, max_rounds=64)
            out[f"pagerank_until-{layout}"] = _rows_and_same(
                {"ranks": ranks}, out=res)
            key = prng.key(KEYS["pushsum"])
            (s, w), st = sharded.pushsum(sg, mesh, PushSum(), key, ROUNDS)
            out[f"pushsum-{layout}"] = _rows_and_same({"s": s, "w": w},
                                                      **_stats(st))
            (s, w), res = sharded.pushsum_until_variance(
                sg, mesh, PushSum(), key, tol=PS_TOL, max_rounds=64)
            out[f"pushsum_until-{layout}"] = _rows_and_same(
                {"s": s, "w": w}, out=res)
            continue
        status, res = sharded.sir_until_coverage(
            sg, mesh, SIR(**SIR_KW), prng.key(KEYS["sir"]),
            coverage_target=SIR_TARGET, max_rounds=64)
        out["sir_until"] = _rows_and_same({"status": status}, out=res)
        hop = HopDistance(source=0)
        (dist, front, rnd), st = sharded.hopdist(sg, mesh, hop, HOP_ROUNDS)
        out["hopdist"] = _rows_and_same({"dist": dist, "frontier": front},
                                        round=rnd, **_stats(st))
        (dist, front, rnd), res = sharded.hopdist_until_done(sg, mesh, hop)
        out["hopdist_until_done"] = _rows_and_same(
            {"dist": dist, "frontier": front}, round=rnd, out=res)
        known, res = sharded.leader_until_quiet(sg, mesh)
        out["leader"] = _rows_and_same({"known": known}, out=res)
        proto = BatchFlood(method="segment")
        batch, res = sharded.run_batch_until_coverage(
            sg, mesh, proto, proto.init(g, lane_sources(g.n_nodes),
                                        coverage_target=0.99),
            max_rounds=64)
        out["lanes"] = _rows_and_same(out=res, **{
            f: getattr(batch, f) for f in ("seen", "frontier", "sent",
                                           "done", "rounds", "seen_count")})
    sg = sharded.shard_graph(g, mesh, source_csr=True)
    for name, p in (("walk", 0.0), ("walk_restart", RESTART_P)):
        (pos, start, visited), st = sharded.walk(
            sg, mesh, RandomWalks(n_walkers=WALKERS, restart_p=p),
            prng.key(KEYS["walk"]), WALK_ROUNDS, return_state=True)
        out[name] = _rows_and_same({"visited": visited}, pos=pos,
                                   start=start, **_stats(st))
    # The reference worker's fourth phase: the gossip values saved
    # collectively, restored onto this ring, equal to the engine's.
    sg = sharded.shard_graph(g, mesh)
    vals, _ = sharded.gossip(sg, mesh, Gossip(alpha=GOSSIP["alpha"]),
                             prng.key(GOSSIP["key"]), GOSSIP["rounds"],
                             exact_rng=True)
    if save:
        checkpoint.save_orbax(ckpt_dir, {"vals": vals},
                              prng.key(KEYS["ckpt"]), GOSSIP["rounds"])
    restored, key, rnd, msgs = checkpoint.load_orbax(ckpt_dir,
                                                     {"vals": vals})
    out["ckpt"] = _rows_and_same({"vals": restored["vals"]}, key=key,
                                 round=rnd, messages=msgs,
                                 equal=bool(torch.equal(restored["vals"],
                                                        vals)))
    if mesh.world <= 2:
        out["node"] = node_run(g, mesh, ckpt_dir)
    return out


def node_run(g, mesh, ckpt_dir: str) -> dict:
    """The PageRank node's record: its events and final ranks, then a
    fresh node restored from the mid-run checkpoint, run to the same
    residual."""
    import os

    from p2pnetwork_tpu_torch.models import PageRank
    from p2pnetwork_tpu_torch.sim.simnode import TorchSimNode

    path = os.path.join(ckpt_dir, f"node-{mesh.world}" + (
        "" if mesh.world > 1 else ".npz"))

    def make(rec):
        return TorchSimNode(graph=g, protocol=PageRank(), seed=3,
                            callback=rec, mesh=mesh, dynamic_edges=8,
                            layout="mxu")

    rec, again = NodeEvents(), NodeEvents()
    node = make(rec)
    node_calls(node, path)
    fresh = make(again)
    fresh.load_checkpoint(path)
    fresh.run_until_converged("residual", NODE_TOL, max_rounds=64)
    return _rows_and_same(
        {"ranks": node.sim_state, "resumed": fresh.sim_state},
        events=rec.events, resumed_events=again.events,
        alive=node.sim_node_alive, counters=(
            node.sim_round, node.sim_message_count, node._churn_count,
            fresh.sim_round, fresh.sim_message_count, fresh._churn_count))


def restore(n_shards: int, ckpt_dir: str) -> dict:
    """The checkpoint of :func:`protocols` restored onto this rank's
    shards of a fresh ring (world 1 through the launcher)."""
    torch.set_num_threads(1)
    from p2pnetwork_tpu_torch.parallel import multihost
    from p2pnetwork_tpu_torch.sim import checkpoint

    multihost.initialize_distributed()
    mesh = multihost.hierarchical_ring_mesh(n_shards=n_shards, device="cpu")
    manifest = checkpoint.read_manifest(ckpt_dir)
    template = {"vals": torch.zeros((mesh.n_local, manifest["block"]))}
    restored, key, rnd, msgs = checkpoint.load_orbax(ckpt_dir, template)
    return {"ckpt": _rows_and_same({"vals": restored["vals"]}, key=key,
                                   round=rnd, messages=msgs,
                                   world=mesh.world)}


def gather_runs(parts: list) -> dict:
    """The ranks' records of :func:`protocols`: each run's ``rows``
    stacked in rank order (``[S, ...]``), its ``same`` values checked
    equal on every rank."""
    out = {}
    for name in parts[0]:
        if not isinstance(parts[0][name], dict):
            continue
        same = parts[0][name]["same"]
        for p in parts[1:]:
            assert _equal_tree(p[name]["same"], same), name
        out[name] = {**{k: np.concatenate([p[name]["rows"][k]
                                           for p in parts])
                        for k in parts[0][name]["rows"]}, **same}
    return out


def _equal_tree(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_tree(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal_tree(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    return a == b


def card_payload(n_shards: int, payload: str) -> dict:
    """The cross-rank kernels on one of the protocols' payloads on the
    card, both directions, against their plain versions and the global
    ``torch.roll`` (gathered through the group): ``"i32"`` election's ids
    ``[n_local, 125008]``, ``"lanes"`` the lane plane's words ``[n_local,
    32, 12512]`` (B2), ``"segsum_sum"`` B3's sum form, the pass kernel
    (:func:`pass_kernel_errors`)."""
    from p2pnetwork_tpu_torch.ops import ring
    from p2pnetwork_tpu_torch.parallel import mesh as M
    from p2pnetwork_tpu_torch.parallel import multihost

    mesh = multihost.hierarchical_ring_mesh(n_shards=n_shards)
    dev, lo, L = mesh.device, mesh.shard_lo, mesh.n_local
    gen = torch.Generator(device=dev).manual_seed(17 + mesh.rank)
    errors, checked = [], 0

    def roll(x, reverse):
        whole = M.gather_shards(mesh, x)
        return torch.roll(whole, -1 if reverse else 1, 0)[lo:lo + L]

    if payload in ("i32", "lanes"):
        shape = (125008,) if payload == "i32" else (32, 12512)
        x = torch.randint(-2**31, 2**31 - 1, (L, *shape), generator=gen,
                          device=dev, dtype=torch.int32)
        for reverse in (False, True):
            want = roll(x, reverse)
            for name in ("ring_put", "ring_put_plain"):
                checked += 1
                if not torch.equal(getattr(ring, name)(x, mesh, reverse),
                                   want):
                    errors.append(f"{name} {payload} reverse={reverse}")
    else:
        checked += 1
        errors += pass_kernel_errors(mesh, "sum")
    torch.cuda.synchronize()
    return {"errors": errors, "checked": checked}


# ---------------------------------- the ring's last refusals, by rank

#: ``adaptive``'s parameters (``tests/test_torch_multihost_adaptive.py``
#: runs the JAX ring and the one-process port on the same ones).
ADAPTIVE_K = 16
#: The recorders' ring: shorter than the runs, so the rows wrap.
REC_CAPACITY = 4
#: The reference's faulted-flood schedule (``chip_smoke.py``
#: ``RING_FAULTS``, from its ``tests/test_graftquake.py``).
RING_FAULTS = dict(seed=5, corrupt=0.05, zero=0.1, delay=0.1)
FAULT_KINDS = ("corrupt", "zero", "delay")
#: The placed checkpoint's layout: the flood's seen set and each shard's
#: covered count per shard (a leaf of two dimensions and one of one), the
#: lane batch's seen words (``[words, nodes]``) replicated.
PLACED = {"seen": True, "lanes": False, "counts": True}


def _fault_counts() -> dict:
    from p2pnetwork_tpu_torch import telemetry

    reg = telemetry.default_registry()
    return {k: reg.value("chaos_device_faults_total", kind=k)
            for k in FAULT_KINDS}


def _record(fr) -> dict:
    """A flight record's rows (compared by bits) and wrap accounting."""
    return {"rows": fr.rows, "rounds": fr.rounds, "dropped": fr.dropped}


def placed_state(sg, seen, batch_seen) -> dict:
    """The placed checkpoint's state on this rank (``PLACED``)."""
    return {"seen": seen.to(torch.int32), "lanes": batch_seen,
            "counts": (seen & sg.node_mask).sum(1)}


def adaptive(n_shards: int, ckpt_dir: str, save: bool = False,
             device: str = "cpu") -> dict:
    """What the ring refused across ranks before, on this rank's shards
    of ``n_shards`` (all of them in one process): on every layout the
    frontier-adaptive flood and hop distance, the recorded dense flood
    and the faulted flood (``RING_FAULTS``); on ``segment`` the recorded
    lane ring beside its plain run; the hop census by host (``per_host``
    half the world); the placed checkpoint saved when ``save``, then
    restored. Each run also says how many exchanges it made."""
    torch.set_num_threads(1)
    from p2pnetwork_tpu_torch.chaos import device as chaos_device
    from p2pnetwork_tpu_torch.models import HopDistance
    from p2pnetwork_tpu_torch.models.messagebatch import BatchFlood
    from p2pnetwork_tpu_torch.parallel import commviz
    from p2pnetwork_tpu_torch.parallel import mesh as M
    from p2pnetwork_tpu_torch.parallel import multihost, sharded
    from p2pnetwork_tpu_torch.sim import checkpoint, flightrec
    from p2pnetwork_tpu_torch.sim import graph as G

    multihost.initialize_distributed()
    mesh = multihost.hierarchical_ring_mesh(n_shards=n_shards,
                                            device=device)
    g = G.watts_strogatz(*GRAPH, seed=0, device=mesh.device)
    out = {"rank": mesh.rank, "world": mesh.world}

    def run(name, fn, rows, same):
        """Record run ``name``: ``rows(result)`` its per-shard arrays,
        ``same(result)`` its whole-ring values, and its exchanges."""
        e0 = M.EXCHANGES
        result = fn()
        out[name] = _rows_and_same(rows(result), exchanges=M.EXCHANGES - e0,
                                   **same(result))

    for layout, kw in LAYOUTS.items():
        sg = sharded.shard_graph(g, mesh, source_csr=True, **kw)
        run(f"adaptive-{layout}",
            lambda: sharded.flood_until_coverage(sg, mesh, 0,
                                                 adaptive_k=ADAPTIVE_K),
            lambda r: {"seen": r[0]},
            lambda r: dict(out=r[1], sparse=list(sharded.LAST_SPARSE_ROUNDS)))
        run(f"adaptive_hop-{layout}",
            lambda: sharded.hopdist_until_coverage(
                sg, mesh, HopDistance(source=0), adaptive_k=ADAPTIVE_K),
            lambda r: {"dist": r[0][0], "frontier": r[0][1]},
            lambda r: dict(round=r[0][2], out=r[1],
                           sparse=list(sharded.LAST_SPARSE_ROUNDS)))
        run(f"recorded-{layout}",
            lambda: sharded.flood_until_coverage(
                sg, mesh, 0, recorder=flightrec.FlightRecorder(
                    REC_CAPACITY)),
            lambda r: {"seen": r[0]},
            lambda r: dict(out={k: v for k, v in r[1].items()
                                if k != "flight_record"},
                           record=_record(r[1]["flight_record"])))
        c0 = _fault_counts()
        spec = chaos_device.FaultSpec(
            chaos_device.FaultSchedule(**RING_FAULTS), "ppermute")
        run(f"faulted-{layout}",
            lambda: sharded.flood_until_coverage(sg, mesh, 0, max_rounds=64,
                                                 comm=spec),
            lambda r: {"seen": r[0]},
            lambda r: dict(out=r[1], faults={
                k: v - c0[k] for k, v in _fault_counts().items()}))
    sg = sharded.shard_graph(g, mesh, source_csr=True)
    proto = BatchFlood(method="segment")
    for name, rec in (("lanes", None), ("lanes_recorded",
                                        flightrec.FlightRecorder(
                                            REC_CAPACITY))):
        run(name, lambda: sharded.run_batch_until_coverage(
            sg, mesh, proto, proto.init(g, lane_sources(g.n_nodes),
                                        coverage_target=0.99),
            max_rounds=64, recorder=rec),
            lambda r: {},
            lambda r: dict(seen=r[0].seen, out={
                k: v for k, v in r[1].items() if k != "flight_record"},
                record=(_record(r[1]["flight_record"])
                        if "flight_record" in r[1] else None)))
    out["census"] = commviz.ring_hop_census(
        sg, mesh, multihost.host_of(mesh, max(mesh.world // 2, 1)))
    out["node"] = adaptive_node(g, mesh)
    seen, _ = sharded.flood_until_coverage(sg, mesh, 0, adaptive_k=ADAPTIVE_K)
    state = placed_state(sg, seen, out["lanes"]["same"]["seen"])
    state["lanes"] = torch.from_numpy(state["lanes"]).to(mesh.device)
    path = f"{ckpt_dir}/placed"
    if save:
        checkpoint.save_orbax(path, state, prng_key(), 3, 7,
                              per_shard=PLACED)
    restored, key, rnd, msgs = checkpoint.load_orbax(path, state,
                                                     per_shard=PLACED)
    out["placed"] = _rows_and_same(
        {k: restored[k] for k in ("seen", "counts")},
        lanes=restored["lanes"], key=key, round=rnd, messages=msgs,
        equal=all(torch.equal(restored[k], state[k]) for k in state))
    return out


def adaptive_node(g, mesh) -> dict:
    """A Flood ``TorchSimNode`` on the ring with ``adaptive_k``: a round,
    then the run to 0.99 through the frontier-adaptive loop. Its events,
    summary, rows and sparse rounds."""
    from p2pnetwork_tpu_torch.models import Flood
    from p2pnetwork_tpu_torch.parallel import sharded
    from p2pnetwork_tpu_torch.sim.simnode import TorchSimNode

    rec = NodeEvents()
    node = TorchSimNode(graph=g, protocol=Flood(source=0), seed=0,
                        callback=rec, mesh=mesh, adaptive_k=ADAPTIVE_K)
    node.run_rounds(1)
    summary = node.run_until_coverage(0.99)
    return _rows_and_same({"seen": node.sim_state[0]}, summary=summary,
                          events=rec.events,
                          sparse=list(sharded.LAST_SPARSE_ROUNDS),
                          counters=(node.sim_round, node.sim_message_count))


def prng_key():
    from p2pnetwork_tpu_torch import prng

    return prng.key(KEYS["ckpt"])


def census(n_shards: int, per_host: int, device: str = "cpu") -> dict:
    """The hop census by host of the flood on this rank's ring."""
    torch.set_num_threads(1)
    from p2pnetwork_tpu_torch.parallel import commviz, multihost, sharded
    from p2pnetwork_tpu_torch.sim import graph as G

    multihost.initialize_distributed()
    mesh = multihost.hierarchical_ring_mesh(n_shards=n_shards,
                                            device=device)
    g = G.watts_strogatz(256, 6, 0.2, seed=0, device=mesh.device)
    return commviz.ring_hop_census(sharded.shard_graph(g, mesh), mesh,
                                   multihost.host_of(mesh, per_host))


def restore_placed(n_shards: int, ckpt_dir: str) -> dict:
    """The placed checkpoint of :func:`adaptive` restored onto this
    rank's shards of a fresh ring (world 1 through the launcher): the
    template the rank's own zeros, laid out as ``PLACED``."""
    torch.set_num_threads(1)
    from p2pnetwork_tpu_torch.parallel import multihost
    from p2pnetwork_tpu_torch.sim import checkpoint

    multihost.initialize_distributed()
    mesh = multihost.hierarchical_ring_mesh(n_shards=n_shards, device="cpu")
    path = f"{ckpt_dir}/placed"
    manifest = checkpoint.read_manifest(path)
    shapes = {k: leaf["shape"] for k, leaf in zip(sorted(PLACED),
                                                  manifest["leaves"])}
    template = {
        "seen": torch.zeros((mesh.n_local, manifest["block"]),
                            dtype=torch.int32),
        "lanes": torch.zeros(shapes["lanes"], dtype=torch.int32),
        "counts": torch.zeros(mesh.n_local, dtype=torch.int64)}
    restored, key, rnd, msgs = checkpoint.load_orbax(path, template,
                                                     per_shard=PLACED)
    return {"placed": _rows_and_same(
        {k: restored[k] for k in ("seen", "counts")},
        lanes=restored["lanes"], key=key, round=rnd, messages=msgs)}


# ------------------------------------------- a pass's one exchange, by rank

#: ``rotations``' payloads: ``(dtype, shape of a shard)``.
ROTATION_PAYLOADS = ((torch.int32, (2, 33)), (torch.bool, (65,)),
                     (torch.float32, (17,)))
#: The pass kernel's buckets on the CPU: rows a shard, slots a row (a
#: multiple of 4: the extent path's geometry), receivers a row, signal
#: width a shard.
PASS_GEOMETRY = dict(nb=5, w=24, block=16, width=80)
#: The same on the card: the 1M ring's ``mxu`` step geometry.
CARD_PASS_GEOMETRY = dict(nb=245, w=64, block=512, width=125008)
#: The dynamic region of ``rotations``' propagate runs: runtime links.
DYN_LINKS = ([1, 5, 300], [GRAPH[0] - 2, 200, 7])
DYN_LAYOUTS = ("mxu", "hybrid")


def swapped(order) -> tuple:
    """A ring order with each pair of neighbours swapped: the ranks around
    the ring no longer in rank order (a hierarchical mesh's host-major
    order in miniature)."""
    order = list(order)
    for i in range(0, len(order) - 1, 2):
        order[i], order[i + 1] = order[i + 1], order[i]
    return tuple(order)


def global_payload(n_shards: int, dtype, shape) -> torch.Tensor:
    """The whole ring's ``[S, *shape]`` payload, each element a function
    of its shard and offset."""
    n = int(np.prod(shape))
    v = (torch.arange(n_shards)[:, None] * 1009
         + torch.arange(n)[None, :] * 7).reshape(n_shards, *shape)
    return (v % 3 == 1) if dtype == torch.bool else v.to(dtype)


def pass_buckets(n_shards: int, seed: int, geometry=None) -> dict:
    """The whole ring's ``[S, S, NB, W]`` buckets in the MXU layout's form
    (each row's live slots a prefix up to its extent, the padding ``(0,
    0, 0)``), their extents ``[S, S, NB]`` and integer-valued f32 and
    bool signals ``[S, width]`` (f32 sums exact in any order), as numpy
    arrays."""
    g = geometry or PASS_GEOMETRY
    rng = np.random.default_rng(seed)
    shape = (n_shards, n_shards, g["nb"], g["w"])
    ext = rng.integers(0, g["w"] + 1, shape[:3]).astype(np.int32)
    live = np.arange(g["w"]) < ext[..., None]
    src = np.where(live, rng.integers(0, g["width"], shape), 0)
    dst = np.where(live, np.sort(rng.integers(0, g["block"], shape), -1), 0)
    mask = live & (rng.random(shape) < 0.8)
    return {"src": src.astype(np.int32), "dst": dst.astype(np.int32),
            "mask": mask, "extent": ext,
            "sum": rng.integers(-8, 8, (n_shards, g["width"])).astype(
                np.float32),
            "or": rng.random((n_shards, g["width"])) < 0.3}


def hop_fold(mesh, kind: str, x, src, dst, mask, block: int):
    """The pass's fold step by step from ``S - 1`` :func:`ring_put` hops
    (their plain versions on the CPU) and B1's plain sum a step: what
    the pass kernel computes from one gather."""
    from p2pnetwork_tpu_torch.ops import ring, segsum

    plain = segsum.segsum_or_plain if kind == "or" \
        else segsum.segsum_sum_plain
    acc, rot = None, x
    for t in range(mesh.n_shards):
        step = plain(rot, src[:, t], dst[:, t], mask[:, t], block)
        acc = step if acc is None else (acc | step if kind == "or"
                                        else acc + step)
        if t < mesh.n_shards - 1:
            rot = ring.ring_put(rot, mesh)
    return acc


def pass_kernel_errors(mesh, kind: str) -> list:
    """The pass kernel of ``kind`` on the card at the 1M ring's step
    geometry (``CARD_PASS_GEOMETRY``), with and without extents, against
    its plain version and the fold from ``S - 1`` hops: OR and the
    integer-valued sums bit for bit. The names of what differs."""
    from p2pnetwork_tpu_torch.ops import ring

    g = CARD_PASS_GEOMETRY
    lo, L = mesh.shard_lo, mesh.n_local
    b = pass_buckets(mesh.n_shards, 1234, g)
    dev = mesh.device
    src, dst, mask, ext, x = (
        torch.from_numpy(b[k][lo:lo + L]).to(dev).contiguous()
        for k in ("src", "dst", "mask", "extent", kind))
    slab = ring.ring_gather(x, mesh).clone()
    errors = []
    plain_slab = ring.ring_gather_plain(x, mesh)
    if not torch.equal(slab, plain_slab):
        errors.append(f"ring_gather {kind} slab")
    fn = getattr(ring, f"ring_pass_segsum_{kind}")
    want = getattr(ring, f"ring_pass_segsum_{kind}_plain")(
        plain_slab, lo, src, dst, mask, g["block"])
    folded = hop_fold(mesh, kind, x, src, dst, mask, g["block"])
    if not torch.equal(want, folded):
        errors.append(f"ring_pass_segsum_{kind}_plain against the hops")
    for e in (None, ext):
        got = fn(slab, lo, src, dst, mask, g["block"], extent=e)
        if not torch.equal(got, want):
            errors.append(f"ring_pass_segsum_{kind} extent={e is not None}")
    return errors


def rotations(n_shards: int, device: str = "cpu") -> dict:
    """A pass's one exchange on this rank's shards of ``n_shards``, on the
    hierarchical mesh's ring order and on one with neighbours swapped
    (:func:`swapped`): for each of ``ROTATION_PAYLOADS`` the gathered
    slab, each step's rows and the same step from chained ``ring_put``
    hops; the pass kernel of each kind on :func:`pass_buckets` (extents
    given and not) and the fold from hops; then ``propagate`` of a sum
    and an OR on the reference worker's graph with failures and runtime
    links (a dynamic region) on the MXU layouts."""
    torch.set_num_threads(1)
    import dataclasses

    from p2pnetwork_tpu_torch.ops import ring
    from p2pnetwork_tpu_torch.parallel import multihost

    multihost.initialize_distributed()
    base = multihost.hierarchical_ring_mesh(n_shards=n_shards,
                                            device=device)
    S = n_shards
    out = {"rank": base.rank, "world": base.world}
    for name, order in (("ring", base.order), ("swapped",
                                              swapped(base.order))):
        mesh = dataclasses.replace(base, order=order, peer={})
        lo, L = mesh.shard_lo, mesh.n_local
        rec = {"shard_lo": lo, "payloads": []}
        for dtype, shape in ROTATION_PAYLOADS:
            x = global_payload(S, dtype, shape)[lo:lo + L].to(mesh.device)
            slab = ring.ring_gather(x, mesh)
            rows, hops, rot = [], [], x
            for t in range(S):
                rows.append(_np(ring.ring_rows(slab, lo, L, t)))
                hops.append(_np(rot))
                rot = ring.ring_put(rot, mesh)
            rec["payloads"].append({"slab": _np(slab), "rows": rows,
                                    "hops": hops})
        b = pass_buckets(S, 5)
        src, dst, mask, ext = (torch.from_numpy(b[k][lo:lo + L]).to(
            mesh.device) for k in ("src", "dst", "mask", "extent"))
        for kind in ("or", "sum"):
            x = torch.from_numpy(b[kind][lo:lo + L]).to(mesh.device)
            slab = ring.ring_gather(x, mesh)
            fn = getattr(ring, f"ring_pass_segsum_{kind}")
            block = PASS_GEOMETRY["block"]
            rec[f"pass_{kind}"] = _np(fn(slab, lo, src, dst, mask, block))
            rec[f"pass_{kind}_extent"] = _np(fn(slab, lo, src, dst, mask,
                                                block, extent=ext))
            rec[f"hops_{kind}"] = _np(hop_fold(mesh, kind, x, src, dst,
                                               mask, block))
        out[name] = rec
    out.update(dyn_propagate(base))
    return out


def dyn_propagate(mesh) -> dict:
    """``propagate`` of a sum and an OR on the reference worker's graph
    with failures and runtime links (a dynamic region) on the MXU
    layouts, this rank's rows (every row in one process)."""
    from p2pnetwork_tpu_torch.parallel import sharded
    from p2pnetwork_tpu_torch.sim import graph as G

    g = G.watts_strogatz(*GRAPH, seed=0, device=mesh.device)
    out = {}
    for layout in DYN_LAYOUTS:
        sg = sharded.shard_graph(g, mesh, **LAYOUTS[layout])
        sgc = sharded.with_capacity(sharded.fail_nodes(sg, list(FAIL_IDS)),
                                    8)
        sgc = sharded.connect(sgc, *DYN_LINKS)
        sig = torch.from_numpy(signal(sg.n_nodes_padded)).reshape(
            mesh.n_shards, sg.block)[sg.shard_lo:sg.shard_lo + sg.n_local]
        sig = sig.to(mesh.device)
        out[f"dyn-{layout}"] = {
            "sum": _np(sharded.propagate(sgc, mesh, sig, "sum")),
            "or": _np(sharded.propagate(sgc, mesh, sig > 1.0, "or"))}
    return out


def card_gather(n_shards: int, steps: int) -> dict:
    """The pass's exchange on the card: ``ring_gather`` of bool, f32, i32
    and the lane words against its plain version and the global stack
    (each step's rows too), the pass kernel of both kinds
    (:func:`pass_kernel_errors`), then ``steps`` gathers of an i32
    payload that names its shard and gather, the last rank held back by a
    sleep kernel before each (and on the host every 64), every step's
    rows of every gather checked, with the launches counted; last, a
    view read after a gather that outgrew the gather area (C10)."""
    import time

    from p2pnetwork_tpu_torch.ops import ring
    from p2pnetwork_tpu_torch.parallel import multihost

    mesh = multihost.hierarchical_ring_mesh(n_shards=n_shards)
    dev, lo, L, S = mesh.device, mesh.shard_lo, mesh.n_local, n_shards
    errors = []
    for dtype, shape in ((torch.bool, (16,)), (torch.bool, (125008,)),
                         (torch.float32, (125008,)),
                         (torch.int32, (125008,)), (torch.int32, (32, 12512)),
                         (torch.bool, (125007,))):
        whole = global_payload(S, dtype, shape).to(dev)
        x = whole[lo:lo + L].contiguous()
        slab = ring.ring_gather(x, mesh)
        if not torch.equal(slab, torch.cat([whole, whole])):
            errors.append(f"ring_gather {dtype} {shape}")
        if not torch.equal(ring.ring_gather_plain(x, mesh), slab):
            errors.append(f"ring_gather_plain {dtype} {shape}")
        for t in range(S):
            if not torch.equal(ring.ring_rows(slab, lo, L, t),
                               torch.roll(whole, t, 0)[lo:lo + L]):
                errors.append(f"ring_rows {dtype} {shape} step {t}")
    for kind in ("or", "sum"):
        errors += pass_kernel_errors(mesh, kind)
    g = torch.arange(S, device=dev, dtype=torch.int32)[:, None]
    j = torch.arange(125008, device=dev, dtype=torch.int32)[None, :]
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    launches0 = ring.GATHER_LAUNCHES
    for s in range(steps):
        if mesh.rank == mesh.world - 1:
            torch.cuda._sleep(100_000)
            if s % 64 == 0:
                time.sleep(0.05)
        whole = g * 1_000_003 + s * 7919 + j
        slab = ring.ring_gather(whole[lo:lo + L].contiguous(), mesh)
        for t in range(S):
            bad += (ring.ring_rows(slab, lo, L, t)
                    != torch.roll(whole, t, 0)[lo:lo + L]).sum()
    torch.cuda.synchronize()
    gathers = ring.GATHER_LAUNCHES - launches0
    # C10: a view read after the next gather outgrew the gather area (the
    # old area retired, not freed, until the gather two after the view).
    small = global_payload(S, torch.int32, (4, 125008)).to(dev)
    view = ring.ring_gather(small[lo:lo + L].contiguous(), mesh)
    big = global_payload(S, torch.int32, (64, 12512)).to(dev)
    ring.ring_gather(big[lo:lo + L].contiguous(), mesh)
    torch.cuda.synchronize()
    if not torch.equal(view, torch.cat([small, small])):
        errors.append("a view read after a gather that outgrew the area")
    return {"errors": errors, "bad": int(bad), "steps": steps,
            "gathers": gathers}
