"""The rest of ``models/`` on the auto path across ranks: the walks (on
a churned graph too), Plumtree, the failure detector, anti-entropy, Vivaldi, the library
functions (triangles and the wedge sample, closeness, betweenness, hop
distances and diameter bounds, coloring), the dynamic edge region with
``connect``/``disconnect``/failures/``consolidate`` on a part, the
edge-level failures (links cut by id, by a draw, by a partition), and a
``multihost.Mesh2D`` across ranks, against the JAX package.

Rank processes started by ``multihost.launch`` at worlds 2 and 4 (S = 8),
joined by gloo on loopback, each run ``tests/torch_auto_worker.py``'s
``library_runs`` (torch and the port only): the cases of its
``LIBRARY``, each one function that this test runs through the
reference's modules too, on the reference's auto placement
(``shard_graph_auto`` on ``ring_mesh(8)``). World 2 runs every case,
world 4 ``LIBRARY_W4``. ``mesh2d_runs`` runs the reference's two 2-D
mesh auto tests at world 4 on ``mesh_2d(hosts=2)``, under both axis
names. The checks:

1. against the reference: bools and ints exactly, f32 exactly where the
   port's own tests hold them so (the walks, the detector, anti-entropy,
   closeness, clustering, the floods), else within their stated
   tolerances: Vivaldi ``VIVALDI_RTOL``/``VIVALDI_ATOL``
   (``tests/test_torch_membership.py``), betweenness ``BC_RTOL``/
   ``BC_ATOL`` (``tests/test_torch_library.py``). Plumtree's eager set is
   edge-extent: every rank's flags, put together by
   ``interop.plumtree_state_from_parts``, are the reference's whole set;
2. every rank's results are bit-equal to every other rank's (Plumtree:
   its own edges' flags cut from the whole by
   ``interop.plumtree_state_to_part``) and to the one-process port's;
3. the exchanges each case makes (``parallel/mesh.EXCHANGES``) and their
   payload dtypes, pinned per round;
4. the 2-D mesh: the floods equal the reference's, and the bytes a
   round moves between hosts (``commviz.auto_hop_census``): a gather
   moves ``(W - W / H) * N_pad * elem``, which for a bool flood at world
   4 on two hosts stays within one node-extent array, ``4 * N_pad`` (the
   counterpart of the reference's
   ``test_dcn_traffic_bounded_by_node_extent``), and for an f32 round is
   over it, ``8 * N_pad``.
"""

import concurrent.futures
import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu import models as JMOD  # noqa: E402
from p2pnetwork_tpu.models import centrality as JC  # noqa: E402
from p2pnetwork_tpu.models import coloring as JCOL  # noqa: E402
from p2pnetwork_tpu.models import hopdist as JH  # noqa: E402
from p2pnetwork_tpu.models import triangles as JTR  # noqa: E402
from p2pnetwork_tpu.parallel import auto as JA  # noqa: E402
from p2pnetwork_tpu.parallel import mesh as JM  # noqa: E402
from p2pnetwork_tpu.parallel import multihost as JMH  # noqa: E402
from p2pnetwork_tpu.sim import engine as JE  # noqa: E402
from p2pnetwork_tpu.sim import failures as JF  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu.sim import topology as JT  # noqa: E402
from p2pnetwork_tpu_torch import _device, interop  # noqa: E402
from p2pnetwork_tpu_torch.parallel import auto as TA  # noqa: E402
from p2pnetwork_tpu_torch.parallel import mesh as TM  # noqa: E402
from p2pnetwork_tpu_torch.parallel import multihost  # noqa: E402
from tests import torch_auto_worker as W  # noqa: E402
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401
from tests.test_torch_library import BC_ATOL, BC_RTOL  # noqa: E402
from tests.test_torch_membership import (VIVALDI_ATOL,  # noqa: E402
                                         VIVALDI_RTOL)

S = 8
WORLDS = {2: tuple(W.LIBRARY), 4: W.LIBRARY_W4}
WORKER = str(Path(W.__file__).resolve())
#: Seconds a world's rank processes may take before the launcher stops
#: them.
RANK_TIMEOUT = 240
HOSTS = 2
#: f32 results held within a tolerance, ``(rtol, atol)``, by case and
#: field; every other field of every case exactly.
TOL = {("vivaldi", k): (VIVALDI_RTOL, VIVALDI_ATOL) for k in (
    "coord", "height", "ce", "rmse", "mean_rel_err", "mean_ce")}
TOL[("centrality", "betweenness")] = (BC_RTOL, BC_ATOL)
#: The reference's method for the port's kernel methods.
JAX_METHOD = {"hybrid": "hybrid-blocked", "pallas": "blocked"}


class Reference:
    """:class:`tests.torch_auto_worker.Package`'s namespace over the JAX
    package, placed as its ``run_auto`` places a graph."""

    port = False
    build_kw = {}
    G, M, E, F, T = JG, JMOD, JE, JF, JT
    TRI, C, H, COL = JTR, JC, JH, JCOL
    key = staticmethod(jax.random.key)

    @staticmethod
    def place(g):
        return JA.shard_graph_auto(g, JM.ring_mesh(S))

    @staticmethod
    def method(name: str) -> str:
        return JAX_METHOD.get(name, name)


def _launch_all() -> dict:
    out = {world: multihost.launch(f"{WORKER}:library_runs", world,
                                   (S, names), timeout=RANK_TIMEOUT,
                                   device="cpu")
           for world, names in WORLDS.items()}
    out["mesh2d"] = multihost.launch(f"{WORKER}:mesh2d_runs", 4,
                                     (S, HOSTS), timeout=RANK_TIMEOUT,
                                     device="cpu")
    return out


@pytest.fixture(scope="module")
def ranks():
    """The future of :func:`_launch_all`: the rank processes run in a
    thread while this process computes the references."""
    if len(jax.devices()) < S:
        pytest.skip(f"needs {S} devices (the virtual CPU mesh of conftest)")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(_launch_all)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            for name in W.LIBRARY:
                _reference(name)
                _one_process(name)
            for name in W.MESH2D_CASES:
                _mesh2d_reference(name)
        finally:
            torch.set_num_threads(n)
        yield future


@functools.lru_cache(maxsize=None)
def _reference(name: str) -> dict:
    return W.LIBRARY[name](Reference)


@functools.lru_cache(maxsize=None)
def _one_process(name: str):
    """The case on the port's one-process engine, and the host reads it
    made (``_device.SYNCS``)."""
    n = torch.get_num_threads()
    try:
        before = _device.SYNCS
        out = W.LIBRARY[name](W.Package())
        return out, _device.SYNCS - before
    finally:
        torch.set_num_threads(n)


def _plumtree_whole(parts, name: str) -> dict:
    """The whole eager set from every rank's (rank order), as the
    reference's state fields."""
    cls = "PlumtreeBitState" if name == "plumtree_bits" else "PlumtreeState"
    n_edges_padded = _reference(name)["state"]["eager"].shape[0]
    if cls == "PlumtreeBitState":
        n_edges_padded *= 32
    pieces = [(p["runs"][name]["state"], p["plumtree_part"]["n_edges"],
               p["plumtree_part"]["e_pad"]) for p in parts]
    return interop.plumtree_state_from_parts(cls, pieces, n_edges_padded)


def _state(parts, name: str) -> dict:
    """Rank 0's state, or Plumtree's whole one put together."""
    if name.startswith("plumtree"):
        return _plumtree_whole(parts, name)
    return parts[0]["runs"][name]["state"]


def _hold(got, want, name: str, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, what, got.shape, want.shape)
    tol = TOL.get((name, what))
    if tol is None:
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=f"{name}.{what}")
    else:
        np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1],
                                   err_msg=f"{name}.{what}")


CASES = [(w, n) for w, names in WORLDS.items() for n in names]


@pytest.mark.parametrize("world,name", CASES)
def test_library_on_a_part_matches_reference(ranks, world, name,
                                             one_torch_thread):
    parts = ranks.result()[world]
    want = _reference(name)
    got = _state(parts, name)
    assert set(got) == set(want["state"]), name
    for k, v in want["state"].items():
        _hold(got[k], v, name, k)
    stats = parts[0]["runs"][name]["stats"]
    assert set(stats) == set(want["stats"]), name
    for k, v in want["stats"].items():
        _hold(stats[k], v, name, k.split(".")[-1])
    for k, v in want.get("tree", {}).items():
        _hold(parts[0]["runs"][name]["tree"][k], v, name, f"tree.{k}")


@pytest.mark.parametrize("world,name", CASES)
def test_ranks_agree_and_equal_one_process(ranks, world, name,
                                           one_torch_thread):
    """Every rank's results bit-equal to rank 0's and to the one-process
    port's (Plumtree: each rank's flags are its own edges' of the one
    process's whole set)."""
    parts = ranks.result()[world]
    one, _ = _one_process(name)
    first = parts[0]["runs"][name]
    for p in parts:
        run = p["runs"][name]
        for part in ("stats", "tree"):
            for k, v in one.get(part, {}).items():
                assert run[part][k].tobytes() == np.asarray(v).tobytes(), (
                    name, part, k, p["rank"])
        assert run["exchanges"] == first["exchanges"], (name, p["rank"])
        if not name.startswith("plumtree"):
            for k, v in one["state"].items():
                assert run["state"][k].tobytes() == v.tobytes(), (
                    name, k, p["rank"])
            continue
        info = p["plumtree_part"]
        own = one["state"]["eager"]
        if name == "plumtree_bits":
            own = interop._eager_bits(own, own.shape[0] * 32, True)
        lo, n = info["edge_lo"], info["n_edges"]
        bits = interop._eager_bits(run["state"]["eager"], info["e_pad"],
                                   name == "plumtree_bits")
        assert (bits[:n] == own[lo:lo + n]).all() and bits[n:].all(), (
            name, p["rank"])


def test_plumtree_state_cuts_to_a_part_and_back(ranks, one_torch_thread):
    """``interop``'s cut of the reference's whole eager set to each
    rank's part, and back, gives the reference's set again; a part's
    state resumes on its own edges' flags."""
    parts = ranks.result()[2]
    whole = Reference.place(W._lib_graph(Reference, n=512))
    g = W._lib_graph(W.Package(), n=512)
    for name, cls in (("plumtree", "PlumtreeState"),
                      ("plumtree_bits", "PlumtreeBitState")):
        ref = _reference(name)["state"]
        pieces = []
        for p in parts:
            mesh = TM.RingMesh(n_shards=S, axis_name=TM.DEFAULT_AXIS,
                               device=torch.device("cpu"), rank=p["rank"],
                               world=2, order=(0, 1))
            gp = TA.shard_graph_auto(g, mesh)
            assert gp.part.edge_lo == p["plumtree_part"]["edge_lo"]
            st = interop.plumtree_state_to_part(cls, ref, gp)
            assert st.eager.numpy().tobytes() == p["runs"][name]["state"][
                "eager"].tobytes()
            pieces.append(({"eager": st.eager.numpy(),
                            "round": st.round.numpy()}, gp.n_edges,
                           gp.n_edges_padded))
        back = interop.plumtree_state_from_parts(
            cls, pieces, whole.n_edges_padded)
        assert back["eager"].tobytes() == ref["eager"].tobytes()


#: The exchanges a case makes a round, by payload dtype. ``rounds``:
#: the steps the case ran (its stats' ``rounds`` for a loop, a super-step
#: of ``T`` steps counting ``T``).
def _walk_steps(name: str, stats: dict) -> int:
    if name in ("walk", "walk_restart"):
        return 12
    t = 32 if name.endswith("t32") else 1
    return -(-int(stats["rounds"]) // t) * t


@pytest.mark.parametrize("world,name", CASES)
def test_exchanges_are_pinned(ranks, world, name, one_torch_thread):
    run = ranks.result()[world][0]["runs"][name]
    kinds = run["payloads"]
    n = run["exchanges"]
    _, syncs = _one_process(name)
    if name.startswith("walk_churn"):
        # The churned graph's connect edge test (bool) and failures'
        # degrees (i32), then one i64 key a walker a step.
        assert n == 2 + _walk_steps(name, run["stats"])
        assert kinds[:2] == ["torch.bool", "torch.int32"]
        assert set(kinds[2:]) == {"torch.int64"}
    elif name.startswith("walk"):
        # One i64 key a walker a step (the combine of the best slots).
        assert n == _walk_steps(name, run["stats"])
        assert set(kinds) == {"torch.int64"}
    elif name == "detector":
        # The draw's assemble and the owned slot rows' assemble.
        assert n == 2 * int(run["stats"]["rounds"])
        assert set(kinds) == {"torch.int32"}
    elif name in ("antientropy", "vivaldi"):
        # The draw's one assemble (Vivaldi's weight rides it).
        rounds = 3 if name == "vivaldi" else int(run["stats"]["rounds"])
        assert n == rounds and set(kinds) == {"torch.int32"}
    elif name.startswith("plumtree"):
        # A bool assemble a layer and an i32 combine a dead layer (the
        # graft check): as many as the one process's host reads; one i64
        # combine of the stats a broadcast; the tree graph's gather
        # (max + all-gather through the group, no payload here).
        # The graft case adds the failures' degrees (one i32 combine)
        # and the tree graph's two.
        broadcasts = 3
        assert kinds.count("torch.int64") == broadcasts
        assert n == syncs + broadcasts + (3 if name == "plumtree_graft"
                                          else 0)
    elif name == "triangles":
        # A call: one assemble of the table (i32) and one combine of the
        # counts; the sample: one combine of the slot answers and one of
        # the closing edges (bool).
        assert n == 14
        assert kinds.count("torch.bool") == 2
    elif name == "churn":
        # 9 floods and the consolidated one, 8 rounds a bool assemble;
        # connect's edge test (bool); the failures' degrees (i32); the
        # consolidation's two exchanges through the group.
        assert n == 10 * 8 + 1 + 1 + 2
        assert kinds.count("torch.bool") == 81
        assert kinds.count("torch.int32") == 1
    elif name == "edge_failures":
        # The three failures' degrees (an i32 combine each), and 3
        # floods of 6 rounds, a bool assemble a round.
        assert n == 3 + 3 * 6
        assert kinds.count("torch.int32") == 3
    else:
        assert n > 0
    if world == 4 and name in WORLDS[2]:
        assert n == ranks.result()[2][0]["runs"][name]["exchanges"]


# ------------------------------------------------------ the 2-D mesh


@functools.lru_cache(maxsize=None)
def _mesh2d_reference(name: str):
    """The reference's ``run_auto`` on its ``mesh_2d(hosts=2)``, and its
    ``engine.run`` of the whole graph (its two tests' oracles)."""
    args, seed, rounds = W.MESH2D_CASES[name]
    jg = JG.watts_strogatz(*args, seed=seed)
    flood = JMOD.Flood(source=0, method="segment")
    jgs = JA.shard_graph_auto(jg, JMH.mesh_2d(hosts=HOSTS), axis_name="ici")
    auto, _ = JA.run_auto(jgs, flood, jax.random.key(0), rounds)
    whole, _ = JE.run(jg, flood, jax.random.key(0), rounds)
    return np.asarray(auto.seen), np.asarray(whole.seen)


@pytest.mark.parametrize("axis", ["ici", "dcn"])
@pytest.mark.parametrize("name", sorted(W.MESH2D_CASES))
def test_mesh_2d_auto_run_matches_reference(ranks, name, axis,
                                            one_torch_thread):
    """``tests/test_multihost.py::test_mesh_2d_auto_run`` and
    ``tests/test_mesh2d_comm.py::TestMesh2dAutoPlacement::
    test_results_match_engine_on_2d_mesh`` at world 4 on ``mesh_2d(hosts=
    2)``: every rank's flood equals the reference's auto run and its
    whole-graph run."""
    parts = ranks.result()["mesh2d"]
    auto, whole = _mesh2d_reference(name)
    for p in parts:
        assert p["shape"] == (HOSTS, S // HOSTS)
        seen = p["runs"][(axis, name)]["seen"]
        np.testing.assert_array_equal(seen, auto)
        np.testing.assert_array_equal(seen, whole)


#: The 2-D mesh runs' world.
MESH2D_WORLD = 4


def _cross_host_bytes(n_pad: int, elem: int) -> int:
    """The bytes one node-extent gather moves between ranks of different
    hosts: each rank's ``N_pad / W`` owned slice lands in the ``W - W / H``
    ranks of the other hosts, ``(W - W / H) * N_pad * elem`` in all. It
    grows with the world and the payload's width."""
    return (MESH2D_WORLD - MESH2D_WORLD // HOSTS) * n_pad * elem


@pytest.mark.parametrize("axis", ["ici", "dcn"])
@pytest.mark.parametrize("name", sorted(W.MESH2D_CASES))
def test_cross_host_bytes_bounded_by_node_extent(ranks, name, axis,
                                                 one_torch_thread):
    """A flood round's bytes between ranks of different hosts (the hop
    census) stay within one node-extent array, ``4 * N_pad``: the
    round's one bool assemble puts each rank's ``N_pad / 4`` owned flags
    into the slabs of the two ranks of the other host, ``2 * N_pad``."""
    for p in ranks.result()["mesh2d"]:
        run = p["runs"][(axis, name)]
        census, n_pad = run["census"], run["n_pad"]
        assert census["exchanges"] == 1
        assert census["rank_bytes"] == n_pad // MESH2D_WORLD
        assert census["bytes_cross"] == _cross_host_bytes(n_pad, 1)
        assert 0 < census["bytes_cross"] <= 4 * n_pad
        assert census["bytes_within"] == n_pad


@pytest.mark.parametrize("axis", ["ici", "dcn"])
def test_cross_host_bytes_of_an_f32_round(ranks, axis, one_torch_thread):
    """One PageRank round's f32 assemble moves ``(W - W / H) * N_pad *
    4`` bytes between hosts, ``8 * N_pad`` at world 4 on two hosts: over
    the reference's one node-extent array, as every exchange is a gather
    from every rank to every other (ROADMAP: a placement that keeps the
    exchanges inside a host is still to come)."""
    for p in ranks.result()["mesh2d"]:
        run = p["runs"][(axis, "pagerank")]
        census, n_pad = run["census"], run["n_pad"]
        assert census["exchanges"] == 1
        assert census["rank_bytes"] == n_pad // MESH2D_WORLD * 4
        assert census["bytes_cross"] == _cross_host_bytes(n_pad, 4)
        assert census["bytes_cross"] == 8 * n_pad > 4 * n_pad
        assert census["bytes_within"] == 4 * n_pad
