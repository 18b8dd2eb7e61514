"""The rank side of ``tests/test_torch_auto_ranks.py``: the reference's
auto-parity cases (``parallel/auto.py``'s ``shard_graph_auto`` and
``run_auto``) on the port's rank ring, run in each rank process by
``parallel/multihost.launch``. It imports torch and the port only.

Each rank returns every case's final state (replicated: the test holds
every rank's bits equal), its stats (or its loop's summary), the
exchanges it made (counted in ``parallel/mesh.EXCHANGES``), the payload
of each (recorded from ``ops/ring.ring_gather_plain``, which the CPU path
runs) and the sparse and dense rounds of the frontier lowerings
(``ops/frontier.ROUNDS``).
"""

import numpy as np
import torch

#: The twelve protocols of the reference's auto tests, as ``(graph,
#: protocol, rounds, key)``: ``graph`` a generator call of both packages,
#: ``protocol`` a constructor call by name. The cited inputs:
#: ``tests/test_sharded.py::TestAutoSharding`` (WS 512 with k = 6),
#: ``tests/test_skew.py::TestAutoPath``, ``tests/test_routing.py``
#: (``_ws_weighted(512, 10)``), ``tests/test_hits.py``,
#: ``tests/test_labelprop.py``, ``tests/test_boruvka.py``
#: (``_ws_weighted(128, 13)``), ``tests/test_bracha.py`` and
#: ``tests/test_auto_comm.py::TestHybridBlockedAuto``.
WS512 = ("watts_strogatz", (512, 6, 0.2), {"seed": 0})
CASES = {
    "flood": (WS512, ("Flood", {"source": 0, "method": "segment"}), 5, 0),
    "sir": (WS512, ("SIR", {"beta": 0.3, "gamma": 0.1,
                            "method": "segment"}), 5, 0),
    "gossip": (WS512, ("Gossip", {"alpha": 0.5}), 5, 0),
    "components": (WS512, ("ConnectedComponents", {"method": "segment"}),
                   5, 0),
    "mis": (WS512, ("LubyMIS", {"method": "segment",
                                "or_method": "segment"}), 5, 0),
    "kcore": (WS512, ("KCore", {"k": 4, "method": "segment"}), 5, 0),
    "bipartite": (WS512, ("BipartiteCheck", {"method": "segment"}), 5, 0),
    "skew_flood": (("barabasi_albert", (4096, 4), {"seed": 0,
                                                   "skew_table": True}),
                   ("Flood", {"source": 0, "method": "skew"}), 5, 1),
    "routing": (("ws_weighted", (512, 10), {}),
                ("DistanceVector", {"source": 0, "method": "segment"}), 6,
                0),
    "hits": (("watts_strogatz", (256, 4, 0.2), {"seed": 1}),
             ("HITS", {"method": "segment"}), 8, 0),
    "labelprop": (("watts_strogatz", (256, 4, 0.2), {"seed": 1}),
                  ("LabelPropagation", {}), 16, 0),
    "boruvka": (("ws_weighted", (128, 13), {}), ("Boruvka", {}), 10, 0),
    "bracha": (("complete", (16,), {}),
               ("Bracha", {"source": 0, "f": 2, "byzantine": (3, 5),
                           "method": "segment"}), 8, 0),
    "flood_hybrid_blocked": (
        ("watts_strogatz", (4096, 6, 0.2), {"seed": 0, "hybrid": True}),
        ("Flood", {"source": 0, "method": "hybrid-blocked"}), 8, 0),
    "sir_hybrid_blocked": (
        ("watts_strogatz", (2048, 6, 0.2), {"seed": 1, "hybrid": True}),
        ("SIR", {"beta": 0.3, "gamma": 0.1, "method": "hybrid-blocked"}),
        6, 0),
}
#: The protocols that read the op layer, the adaptive wave (``k`` small
#: enough that it runs sparse and overflows ``k``), the frontier
#: lowering, the batched flood and the query families, on graphs of the
#: reference's tests' sizes. Those named in ``LOOPS`` run through their
#: loop (``max_rounds`` in the rounds column) from the batch ``LOOPS``
#: makes.
WS_CSR = ("watts_strogatz", (4096, 6, 0.2),
          {"seed": 0, "hybrid": True, "source_csr": True})
CASES.update({
    "adaptive_flood": (WS_CSR, ("AdaptiveFlood", {
        "source": 0, "method": "hybrid", "k": 32}), 8, 0),
    "adaptive_hop": (WS_CSR, ("AdaptiveHopDistance", {
        "source": 0, "method": "hybrid", "k": 32}), 8, 0),
    "flood_frontier": (WS_CSR, ("Flood", {"source": 0,
                                          "method": "frontier"}), 8, 0),
    "hopdist": (WS512, ("HopDistance", {"source": 0,
                                        "method": "segment"}), 6, 0),
    "leader": (WS512, ("LeaderElection", {"method": "gather"}), 6, 0),
    "pagerank": (WS512, ("PageRank", {"method": "segment"}), 8, 0),
    "pushsum": (WS512, ("PushSum", {"method": "segment"}), 8, 0),
    "spanning": (WS512, ("SpanningTree", {"source": 0,
                                          "method": "gather"}), 6, 0),
    "batch_flood": (WS_CSR, ("BatchFlood", {"method": "frontier"}), 64, 0),
    "minplus": (("ws_latency", (512, 3), {}),
                ("MinPlusQueries", {"method": "auto"}), 256, 0),
    "pushsum_queries": (WS512, ("PushSumQueries", {"method": "auto"}), 512,
                        0),
    "dht": (("chord", (1000,), {}), ("DhtLookups", {"metric": "ring"}), 128,
            0),
})


def _draws(n: int, *sizes: int) -> list:
    """Seeded node ids in ``[0, n)``, one i32 array a size."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, n, k).astype(np.int32) for k in sizes]


#: The loop and the batch of each loop case: ``(loop, init(n_nodes) ->
#: (args, kwargs))``, ``loop`` ``"batch"`` (``run_batch_until_coverage``)
#: or ``"queries"`` (``run_queries_until_done``).
LOOPS = {
    "batch_flood": ("batch", lambda n: (_draws(n, 40), {})),
    "minplus": ("queries", lambda n: (_draws(n, 16, 16), {})),
    "pushsum_queries": ("queries", lambda n: (
        [(np.arange(6) * 7 + 1).astype(np.int32)],
        {"threshold": 1e-4, "capacity": 8})),
    "dht": ("queries", lambda n: (_draws(n, 200, 200), {})),
}

#: The flood under the kernel methods (B1 on the rank's own blocks;
#: its plain version on the CPU), on the hybrid-blocked case's graph with
#: the blocked layout too.
KERNEL_FLOODS = {
    "flood_hybrid": "hybrid",
    "flood_pallas": "pallas",
}
KERNEL_GRAPH = ("watts_strogatz", (4096, 6, 0.2),
                {"seed": 0, "hybrid": True, "blocked": True})
#: What world 4 runs: the flood family and SIR.
FLOOD_FAMILY = ("flood", "sir", "skew_flood", "flood_hybrid_blocked",
                "sir_hybrid_blocked", "flood_hybrid", "flood_pallas",
                "adaptive_flood")


def ws_weighted_costs(s, r):
    """The reference's ``tests/test_routing.py::_ws_weighted`` link costs
    (deterministic, from the edge endpoints)."""
    return 0.25 + ((s * 7919 + r * 104729) % 97) / 50.0


def latency_costs(s, r):
    """The ladder's id-hash link latency (``benchmarks/ladder.py``
    ``bench_routing``): multiples of 1/1024, the same f32 in either
    package."""
    h = s.astype(np.uint32) * np.uint32(2654435761) + r.astype(np.uint32)
    return 1.0 + (h % 2048).astype(np.float32) / 1024.0


def build(G, spec, **kw):
    """A graph of either package from a ``CASES`` graph spec (``G`` that
    package's ``sim.graph``)."""
    kind, args, extra = spec
    if kind == "ws_weighted":
        n, seed = args
        return G.watts_strogatz(n, 4, 0.2, seed=seed, **kw).with_weights(
            ws_weighted_costs)
    if kind == "ws_latency":
        n, seed = args
        return G.watts_strogatz(n, 6, 0.2, seed=seed, **kw).with_weights(
            latency_costs)
    return getattr(G, kind)(*args, **extra, **kw)


def case(name: str):
    """``(graph spec, (protocol name, kwargs), rounds, key)`` of a case,
    the kernel floods included."""
    if name in KERNEL_FLOODS:
        return (KERNEL_GRAPH, ("Flood", {"source": 0,
                                         "method": KERNEL_FLOODS[name]}),
                8, 0)
    return CASES[name]


def state_np(state) -> dict:
    """A protocol state's fields as numpy arrays (a batch's ``payload``
    dict as ``payload.<name>``)."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, dict):
            out.update({f"{f.name}.{k}": np.asarray(x.cpu())
                        for k, x in v.items()})
        else:
            out[f.name] = v.cpu().numpy()
    return out


def protocol(models, cls: str, kw: dict):
    """Protocol ``cls`` of a package's ``models`` (its batch and query
    families from their modules)."""
    import importlib

    for mod in ("", ".messagebatch", ".querybatch"):
        m = importlib.import_module(models.__name__ + mod)
        if hasattr(m, cls):
            return getattr(m, cls)(**kw)
    raise AttributeError(cls)


def run_case(name: str, g, models, run_auto, prng) -> tuple:
    """``(state fields, stats)`` of case ``name`` on ``g`` (a whole graph
    or a part): its loop's summary for the cases of ``LOOPS``."""
    from p2pnetwork_tpu_torch.sim import engine

    _, (cls, kw), rounds, key = case(name)
    proto = protocol(models, cls, kw)
    if name not in LOOPS:
        state, stats = run_auto(g, proto, prng.key(key), rounds)
        return state_np(state), {k: v.numpy() for k, v in stats.items()}
    loop, init = LOOPS[name]
    args, kwargs = init(g.n_nodes)
    run = (engine.run_batch_until_coverage if loop == "batch"
           else engine.run_queries_until_done)
    state, out = run(g, proto, proto.init(g, *args, **kwargs),
                     prng.key(key), max_rounds=rounds)
    return state_np(state), {k: np.asarray(v.cpu() if isinstance(
        v, torch.Tensor) else v) for k, v in out.items()}


def auto_runs(n_shards: int, names: tuple, device: str = "cpu") -> dict:
    """Every case of ``names`` on this rank's part of a ring of
    ``n_shards`` shards: its state, stats, exchanges and payloads."""
    torch.set_num_threads(1)
    from p2pnetwork_tpu_torch import models, prng
    from p2pnetwork_tpu_torch.ops import frontier, ring
    from p2pnetwork_tpu_torch.parallel import auto, mesh as M, multihost
    from p2pnetwork_tpu_torch.sim import graph as G

    multihost.initialize_distributed()
    mesh = multihost.hierarchical_ring_mesh(n_shards=n_shards,
                                            device=device)
    payloads = []
    plain = ring.ring_gather_plain

    def recorded(x, m):
        payloads.append((tuple(x.shape), str(x.dtype),
                         x.numel() * x.element_size()))
        return plain(x, m)

    ring.ring_gather_plain = recorded
    out = {"rank": mesh.rank, "world": mesh.world, "runs": {}}
    for name in names:
        part = auto.shard_graph_auto(build(G, case(name)[0], device="cpu"),
                                     mesh)
        assert G.part_of(part) is not None
        before, payloads[:] = M.EXCHANGES, []
        frontier.ROUNDS.update(sparse=0, dense=0)
        state, stats = run_case(name, part, models, auto.run_auto, prng)
        out["runs"][name] = {"state": state, "stats": stats,
                             "exchanges": M.EXCHANGES - before,
                             "payloads": list(payloads),
                             "frontier_rounds": dict(frontier.ROUNDS),
                             "n_pad": part.n_nodes_padded,
                             "block": part.part.block}
    ring.ring_gather_plain = plain
    return out


#: Every op of ``ops/segment.py`` by every method it takes on a part,
#: on a graph that carries every layout and weights.
OPS_GRAPH = ("watts_strogatz", (1024, 6, 0.2),
             {"seed": 3, "hybrid": True, "blocked": True, "skew_table": True,
              "source_csr": True})
OP_METHODS = {
    "or": ("segment", "gather", "skew", "blocked", "pallas", "hybrid",
           "hybrid-blocked", "auto"),
    "sum": ("segment", "gather", "skew", "blocked", "pallas", "hybrid",
            "hybrid-blocked", "auto"),
    "sum_i32": ("segment", "gather", "skew", "auto"),
    "max": ("segment", "gather", "skew", "auto"),
    "min_plus": ("segment", "gather", "skew", "auto"),
    "or_lanes": ("segment", "gather", "auto"),
    "min_plus_lanes": ("segment", "gather", "auto"),
    "sum_lanes": ("segment", "gather", "auto"),
    "dht": ("ring", "xor"),
}
#: The ops that take ``method="frontier"``: each run on its ``op_signals``
#: input and on a sparse one (``sparse_signals``), so that both branches
#: run.
FRONTIER_OPS = ("or", "max", "min_plus", "or_lanes")


def ops_graph(G, device="cpu"):
    """``OPS_GRAPH`` with the routing rung's weights."""
    return build(G, OPS_GRAPH, device=device).with_weights(
        ws_weighted_costs)


def op_signals(n_pad: int) -> dict:
    """Seeded inputs of every op (numpy): bools, 0/1 floats (exact sums
    in any order), ints, costs and lane words."""
    rng = np.random.default_rng(5)
    dist = rng.uniform(0, 8, n_pad).astype(np.float32)
    dist[rng.random(n_pad) < 0.3] = np.inf
    lane_dist = rng.uniform(0, 8, (n_pad, 4)).astype(np.float32)
    lane_dist[rng.random(lane_dist.shape) < 0.5] = np.inf
    return {"or": rng.random(n_pad) < 0.2,
            "sum": (rng.random(n_pad) < 0.5).astype(np.float32),
            "sum_i32": rng.integers(0, 5, n_pad, dtype=np.int32),
            "max": rng.integers(-2**20, 2**20, n_pad, dtype=np.int32),
            "min_plus": dist,
            "or_lanes": rng.integers(-2**31, 2**31, (3, n_pad),
                                     dtype=np.int64).astype(np.int32),
            "min_plus_lanes": lane_dist,
            "sum_lanes": rng.standard_normal((n_pad, 4)).astype(np.float32),
            "dht": rng.integers(0, n_pad, (2, 64)).astype(np.int32)}


def sparse_signals(n_pad: int) -> dict:
    """``FRONTIER_OPS``' inputs with 2% of the nodes active (the rest
    false, the integer minimum, ``+inf``, zero words)."""
    rng = np.random.default_rng(6)
    on = rng.random(n_pad) < 0.02
    dense = op_signals(n_pad)
    return {"or": on,
            "max": np.where(on, dense["max"], np.iinfo(np.int32).min).astype(
                np.int32),
            "min_plus": np.where(on, dense["min_plus"], np.inf).astype(
                np.float32),
            "or_lanes": np.where(on, dense["or_lanes"], 0).astype(np.int32)}


def run_ops(g) -> dict:
    """Every ``(op, method)`` of ``OP_METHODS`` on ``g`` (whole or a
    part); ``("frontier", op)`` for ``FRONTIER_OPS``: the results on both
    inputs and the sparse and dense rounds taken; and one neighbor draw,
    as numpy."""
    from p2pnetwork_tpu_torch import prng
    from p2pnetwork_tpu_torch.models import base
    from p2pnetwork_tpu_torch.ops import frontier, lanes, segment

    def dht(g, sig, metric):
        return lanes.dht_hop_lanes(g, sig[0], sig[1], metric)

    fns = {"or": segment.propagate_or, "sum": segment.propagate_sum,
           "sum_i32": segment.propagate_sum, "max": segment.propagate_max,
           "min_plus": segment.propagate_min_plus,
           "or_lanes": segment.propagate_or_lanes,
           "min_plus_lanes": lanes.propagate_min_plus_lanes,
           "sum_lanes": lanes.propagate_sum_lanes, "dht": dht}
    n_pad = g.n_nodes_padded
    sig = {k: torch.from_numpy(v) for k, v in op_signals(n_pad).items()}
    sparse = {k: torch.from_numpy(v) for k, v in sparse_signals(
        n_pad).items()}

    def as_np(x):
        return tuple(t.numpy() for t in x) if isinstance(x, tuple) \
            else x.numpy()

    out = {(op, m): as_np(fns[op](g, sig[op], m))
           for op, methods in OP_METHODS.items() for m in methods}
    for op in FRONTIER_OPS:
        frontier.ROUNDS.update(sparse=0, dense=0)
        got = [fns[op](g, x[op], "frontier").numpy() for x in (sig, sparse)]
        out[("frontier", op)] = (*got, np.array(
            [frontier.ROUNDS["sparse"], frontier.ROUNDS["dense"]]))
    out[("draw", "")] = tuple(
        t.numpy() for t in base.draw_neighbor_slot(g, prng.key(4)))
    return out


def ops_runs(n_shards: int) -> dict:
    """:func:`run_ops` on this rank's part of :func:`ops_graph`."""
    torch.set_num_threads(1)
    from p2pnetwork_tpu_torch.parallel import auto, multihost
    from p2pnetwork_tpu_torch.sim import graph as G

    multihost.initialize_distributed()
    mesh = multihost.hierarchical_ring_mesh(n_shards=n_shards, device="cpu")
    return {"rank": mesh.rank,
            "ops": run_ops(auto.shard_graph_auto(ops_graph(G), mesh))}


# ------------------------------------------- the library across ranks
#
# The rest of ``models/`` on a rank's part: the walks, Plumtree, the
# failure detector, anti-entropy, Vivaldi, the library functions
# (triangles, centrality, hop distances, coloring), the dynamic edge
# region with failures and ``consolidate``, and a ``Mesh2D``. Each case
# is one function of a package namespace ``P`` (either package: its
# ``G``raph, ``M``odels, ``E``ngine, ``F``ailures, ``T``opology,
# ``TRI``angles, ``C``entrality, ``H``opdist, ``COL``oring modules,
# ``key(k)``, ``place(g)`` (the auto placement) and ``method(name)``
# (the reference's name for a port method)), so that the test runs the
# reference through the very same calls.

#: Nodes failed (or silenced) in the library cases' graphs.
LIB_DEAD = (3, 17, 100, 101, 102, 640, 777)
#: The centrality cases' sources (900 is dead).
LIB_SOURCES = (0, 3, 77, 500, 900)


def _lib_graph(P, n=1024, seed=0, **kw):
    return P.G.watts_strogatz(n, 6, 0.2, seed=seed, **P.build_kw, **kw)


def _fields(state) -> dict:
    """A state's fields as numpy (either package)."""
    import dataclasses

    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def _stats(stats) -> dict:
    return {k: np.asarray(v) for k, v in stats.items()}


def _walk(P, restart_p=0.0, loop=None, churned=False):
    """Walkers on a graph with failed nodes, or on :func:`_churned`'s
    (runtime links on a part ride with their receiver's owner): 256
    walkers there to coverage 0.8, so that walkers start on the links'
    senders 0 and 7, restart to them and take links (without the links
    the walks differ)."""
    if churned:
        g, n, cover = _churned(P), 256, 0.8
    else:
        g, n, cover = P.place(P.F.fail_nodes(_lib_graph(
            P, source_csr=True), np.array(LIB_DEAD))), 64, 0.5
    proto = P.M.RandomWalks(n_walkers=n, restart_p=restart_p)
    if loop is None:
        st, stats = P.E.run(g, proto, P.key(0), 12)
        return {"state": _fields(st), "stats": _stats(stats)}
    kw = {"steps_per_round": loop} if P.port else {}
    st, out = P.E.run_until_coverage(g, proto, P.key(1),
                                     coverage_target=cover, max_rounds=64,
                                     **kw)
    return {"state": _fields(st), "stats": {k: np.asarray(out[k]) for k in (
        "rounds", "coverage", "messages")}}


def _plumtree(P, bits=False):
    g = P.place(_lib_graph(P, n=512))
    st, stats = P.E.run(g, P.M.Plumtree(source=0, bitset=bits), P.key(0), 3)
    return {"state": _fields(st), "stats": _stats(stats)}


def _plumtree_graft(P):
    """A broadcast on the whole overlay, a failed band that cuts the
    tree, two broadcasts that graft around it, and the tree graph."""
    g = P.place(_lib_graph(P, n=512))
    proto = P.M.Plumtree(source=0)
    st = proto.init(g, P.key(0))
    st, first = proto.step(g, st, P.key(0))
    g = P.F.fail_nodes(g, np.arange(40, 60))
    st, second = proto.step(g, st, P.key(0))
    st, third = proto.step(g, st, P.key(0))
    tree = proto.tree_graph(g, st)
    live = np.asarray(tree.edge_mask)
    return {"state": _fields(st), "stats": {
        f"{i}.{k}": np.asarray(v) for i, s in enumerate((first, second,
                                                         third))
        for k, v in s.items()},
        "tree": {"senders": np.asarray(tree.senders)[live],
                 "receivers": np.asarray(tree.receivers)[live],
                 "node_mask": np.asarray(tree.node_mask),
                 "in_degree": np.asarray(tree.in_degree)}}


def _detector(P):
    g = P.place(P.F.mark_unresponsive(_lib_graph(P, seed=1),
                                      np.array(LIB_DEAD)))
    st, out = P.E.run_until_converged(
        g, P.M.FailureDetector(threshold=3, loss_prob=0.05), P.key(1),
        stat="undetected", threshold=1, max_rounds=256)
    return {"state": _fields(st), "stats": {k: np.asarray(out[k]) for k in (
        "rounds", "value", "messages")}}


def _antientropy(P):
    g = P.place(P.F.fail_nodes(_lib_graph(P, seed=1), np.array(LIB_DEAD)))
    st, out = P.E.run_until_converged(
        g, P.M.AntiEntropy(n_items=16), P.key(2), stat="missing",
        threshold=1, max_rounds=256)
    return {"state": _fields(st), "stats": {k: np.asarray(out[k]) for k in (
        "rounds", "value", "messages")}}


def _vivaldi(P):
    g = P.F.fail_nodes(_lib_graph(P, seed=1).with_weights(latency_costs),
                       np.array(LIB_DEAD))
    st, stats = P.E.run(P.place(g), P.M.Vivaldi(dim=2, noise=0.2),
                        P.key(0), 3)
    return {"state": _fields(st), "stats": _stats(stats)}


def _triangles(P):
    g = P.place(P.F.fail_nodes(_lib_graph(P, seed=2, source_csr=True),
                               np.array(LIB_DEAD)))
    T = P.TRI
    return {"state": {
        "per_node": np.asarray(T.triangles_per_node(g)),
        "clustering": np.asarray(T.local_clustering(g)),
        "blocked_count": np.asarray(T.count_triangles(g, edge_block=7))},
        "stats": {"count": np.asarray(T.count_triangles(g)),
                  "transitivity": np.asarray(T.transitivity(g)),
                  "sample": np.asarray(T.transitivity_sample(
                      g, P.key(0), 4096)),
                  "sample_5": np.asarray(T.transitivity_sample(
                      g, P.key(5), 999))}}


def _centrality(P):
    g = P.place(P.F.fail_nodes(_lib_graph(P, seed=3, hybrid=True),
                               np.array(LIB_DEAD)))
    hy = P.method("hybrid")
    src = np.array(LIB_SOURCES, np.int32)
    ecc, reached = P.H.eccentricities(g, src[:3], hy)
    bounds = P.H.diameter_bounds(g, P.key(3), 4, hy)
    return {"state": {
        "closeness": np.asarray(P.C.closeness_sample(g, src, hy)),
        "closeness_classic": np.asarray(P.C.closeness_sample(
            g, src, hy, harmonic=False)),
        "betweenness": np.asarray(P.C.betweenness_sample(g, src, hy)),
        "bfs": np.asarray(P.H.bfs_distances(g, 0, hy)),
        "ecc": np.asarray(ecc), "reached": np.asarray(reached)},
        "stats": {k: np.asarray(v) for k, v in bounds.items()}}


def _coloring(P):
    g = P.place(_lib_graph(P, seed=4))
    colors, n = P.COL.color_via_mis(g, P.key(2), method="segment")
    return {"state": {"colors": np.asarray(colors)},
            "stats": {"n_colors": np.asarray(n)}}


#: The flood methods through the dynamic region (the churn case), each
#: on the same churned graph.
CHURN_METHODS = ("segment", "gather", "skew", "blocked", "pallas",
                 "hybrid", "hybrid-blocked", "frontier", "auto")


def _floods(P, g, methods, rounds: int, out: dict) -> None:
    """Flood ``g`` from node 0 by each of ``methods`` into ``out``'s
    ``seen.<method>`` and ``<method>.<stat>``. A flood's result does not
    depend on its method (the reference's own method-parity tests), so
    the reference floods once, by ``segment``, and that result stands for
    every method the port runs."""
    for m in methods if P.port else ("segment",):
        st, stats = P.E.run(g, P.M.Flood(source=0, method=P.method(m)),
                            P.key(0), rounds)
        out["state"][f"seen.{m}"] = np.asarray(st.seen)
        out["stats"].update({f"{m}.{k}": np.asarray(v)
                             for k, v in stats.items()})
    for m in () if P.port else methods:
        out["state"][f"seen.{m}"] = out["state"]["seen.segment"]
        out["stats"].update({f"{m}.{k}": out["stats"][f"segment.{k}"]
                             for k in ("messages", "coverage", "frontier",
                                       "frontier_occupancy")})


def _churned(P):
    """A graph with every layout, 128 runtime slots, links connected and
    one disconnected, a failed band: the port churns the rank's part.
    The reference churns the whole graph and places it after (its eager
    calls on placed arrays compile a program each; the result does not
    depend on the placement)."""
    g = P.T.with_capacity(_lib_graph(P, n=2048, seed=5, blocked=True,
                                     hybrid=True, skew_table=True,
                                     source_csr=True), extra_edges=128)
    g = P.place(g) if P.port else g
    g = P.T.connect(g, np.array([0, 5, 900, 1500, 2000, 7]),
                    np.array([1000, 1800, 3, 40, 1, 1201]))
    g = P.T.disconnect(g, np.array([900]), np.array([3]))
    g = P.F.fail_nodes(g, np.arange(300, 340))
    return g if P.port else P.place(g)


def _churn(P):
    g = _churned(P)
    out = {"state": {k: np.asarray(getattr(g, k)) for k in (
        "dyn_senders", "dyn_receivers", "dyn_mask", "in_degree",
        "out_degree", "node_mask")}, "stats": {}}
    _floods(P, g, CHURN_METHODS, 8, out)
    c = P.T.consolidate(g)
    st, stats = P.E.run(c, P.M.Flood(source=0, method=P.method("hybrid")),
                        P.key(0), 8)
    out["state"]["seen.consolidated"] = np.asarray(st.seen)
    out["state"].update({f"consolidated.{k}": np.asarray(getattr(c, k))
                         for k in ("in_degree", "out_degree", "node_mask")})
    out["stats"].update({f"consolidated.{k}": np.asarray(v)
                         for k, v in stats.items()})
    return out


def _edge_failures(P):
    """Links cut by the whole graph's ids, by a draw and by a partition
    (edge-level failures: no blocked or hybrid layout), flooded by the
    methods that read the COO edges, the neighbor table and the skew
    table."""
    g = P.place(_lib_graph(P, seed=6, skew_table=True))
    g = P.F.fail_edges(g, np.arange(0, 6000, 37))
    g = P.F.random_edge_failures(g, P.key(3), 0.05)
    g = P.F.partition(g, [np.arange(0, 300), np.arange(300, 600)])
    out = {"state": {k: np.asarray(getattr(g, k)) for k in (
        "in_degree", "out_degree", "node_mask")}, "stats": {}}
    _floods(P, g, ("segment", "gather", "skew"), 6, out)
    return out


LIBRARY = {
    "walk": _walk,
    "walk_restart": lambda P: _walk(P, restart_p=0.1),
    "walk_t1": lambda P: _walk(P, loop=1),
    "walk_t32": lambda P: _walk(P, restart_p=0.1, loop=32),
    "walk_churn_t1": lambda P: _walk(P, restart_p=0.1, loop=1,
                                     churned=True),
    "walk_churn_t32": lambda P: _walk(P, restart_p=0.1, loop=32,
                                      churned=True),
    "plumtree": _plumtree,
    "plumtree_bits": lambda P: _plumtree(P, bits=True),
    "plumtree_graft": _plumtree_graft,
    "detector": _detector,
    "antientropy": _antientropy,
    "vivaldi": _vivaldi,
    "triangles": _triangles,
    "centrality": _centrality,
    "coloring": _coloring,
    "churn": _churn,
    "edge_failures": _edge_failures,
}
#: What world 4 runs of :data:`LIBRARY`.
LIBRARY_W4 = ("walk_t32", "walk_churn_t32", "plumtree_graft", "detector",
              "vivaldi", "triangles", "churn")


class Package:
    """The namespace a :data:`LIBRARY` case runs on: the port's modules,
    its keys, and its placement on ``mesh`` (whole when None)."""

    port = True
    build_kw = {"device": "cpu"}

    def __init__(self, mesh=None):
        from p2pnetwork_tpu_torch import models, prng
        from p2pnetwork_tpu_torch.models import (centrality, coloring,
                                                 hopdist, triangles)
        from p2pnetwork_tpu_torch.parallel import auto
        from p2pnetwork_tpu_torch.sim import engine, failures, topology
        from p2pnetwork_tpu_torch.sim import graph

        self.G, self.M, self.E, self.F, self.T = (graph, models, engine,
                                                  failures, topology)
        self.TRI, self.C, self.H, self.COL = (triangles, centrality, hopdist,
                                              coloring)
        self.key = prng.key
        self._mesh, self._auto = mesh, auto

    def place(self, g):
        return g if self._mesh is None else self._auto.shard_graph_auto(
            g, self._mesh)

    @staticmethod
    def method(name: str) -> str:
        return name


def library_runs(n_shards: int, names: tuple) -> dict:
    """Every case of ``names`` (:data:`LIBRARY`) on this rank's part of a
    ring of ``n_shards`` shards: its results, the exchanges it made and
    the dtype of each gather's payload."""
    torch.set_num_threads(1)
    from p2pnetwork_tpu_torch.ops import ring
    from p2pnetwork_tpu_torch.parallel import mesh as M, multihost

    multihost.initialize_distributed()
    mesh = multihost.hierarchical_ring_mesh(n_shards=n_shards, device="cpu")
    P = Package(mesh)
    payloads = []
    plain = ring.ring_gather_plain

    def recorded(x, m):
        payloads.append(str(x.dtype))
        return plain(x, m)

    ring.ring_gather_plain = recorded
    out = {"rank": mesh.rank, "runs": {}}
    try:
        for name in names:
            before, payloads[:] = M.EXCHANGES, []
            run = LIBRARY[name](P)
            run.update(exchanges=M.EXCHANGES - before,
                       payloads=list(payloads))
            out["runs"][name] = run
        g = P.place(_lib_graph(P, n=512))
        out["plumtree_part"] = {"edge_lo": g.part.edge_lo,
                                "n_edges": g.n_edges,
                                "e_pad": g.n_edges_padded}
    finally:
        ring.ring_gather_plain = plain
    return out


def mesh2d_runs(n_shards: int, hosts: int) -> dict:
    """The reference's two 2-D mesh auto tests on this rank's part of a
    ``mesh_2d(hosts=hosts)``, under both axis names, and the hop census
    by host of one flood round and of one PageRank round (f32) on the
    last case's graph."""
    torch.set_num_threads(1)
    from p2pnetwork_tpu_torch import models, prng
    from p2pnetwork_tpu_torch.parallel import auto, commviz, multihost
    from p2pnetwork_tpu_torch.sim import graph as G

    multihost.initialize_distributed()
    mesh = multihost.mesh_2d(hosts=hosts, n_shards=n_shards, device="cpu")
    host_of = multihost.host_of(mesh.ring, mesh.ring.world // hosts)
    out = {"rank": mesh.ring.rank, "shape": mesh.shape, "runs": {}}
    for axis in mesh.axis_names:
        for name, (args, seed, rounds) in MESH2D_CASES.items():
            g = G.watts_strogatz(*args, seed=seed, device="cpu")
            gs = auto.shard_graph_auto(g, mesh, axis_name=axis)
            flood = models.Flood(source=0, method="segment")
            st, _ = auto.run_auto(gs, flood, prng.key(0), rounds)
            census = commviz.auto_hop_census(
                mesh.ring, host_of,
                lambda: auto.run_auto(gs, flood, prng.key(0), 1))
            out["runs"][(axis, name)] = {"seen": st.seen.numpy(),
                                         "n_pad": gs.n_nodes_padded,
                                         "census": census}
        # One PageRank round: its f32 assemble by host.
        census = commviz.auto_hop_census(
            mesh.ring, host_of,
            lambda: auto.run_auto(gs, models.PageRank(method="segment"),
                                  prng.key(0), 1))
        out["runs"][(axis, "pagerank")] = {"n_pad": gs.n_nodes_padded,
                                           "census": census}
    return out


#: The reference's 2-D mesh auto tests: ``(watts_strogatz args, seed,
#: rounds)`` of ``tests/test_multihost.py::test_mesh_2d_auto_run`` and
#: ``tests/test_mesh2d_comm.py::TestMesh2dAutoPlacement::
#: test_results_match_engine_on_2d_mesh``.
MESH2D_CASES = {"mesh_2d_auto_run": ((512, 4, 0.1), 1, 5),
                "results_match_engine": ((2048, 6, 0.2), 0, 6)}
