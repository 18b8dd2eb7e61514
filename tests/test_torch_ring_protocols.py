"""The ring's other protocols (``parallel/sharded.py``: SIR, gossip,
PageRank, push-sum, hop distance, leader election) against the JAX
package's ring, on the same graphs.

The JAX ring runs on the 8-device virtual CPU mesh of
``tests/conftest.py`` with ``comm="ppermute"`` (this jax cannot run the
reference's Pallas ring kernels; its own tests pin them equal to
``ppermute``), and each of its results is computed once and shared by
the port's two comms, ``"ppermute"`` and ``"pallas"`` (on the CPU the
kernels' plain versions). Graphs: ``ws512`` and the ragged ER(300) of
``tests/test_torch_ring.py`` (48-node blocks, the last shard all
padding), under the ``segment``, ``mxu`` and ``hybrid`` layouts, and a
1,024-node WS graph (128-node blocks) for the ``"tile"`` draw mode.

What must agree:

- integers, bools and ``messages`` exactly, and every stat of SIR, gossip
  and hop distance (their f32 stats are integer counts over the live
  count, or sums the port adds in the reference's order: each shard's
  block by XLA's row order, ``ops/rowsum.py``, then shard 0 to 7). In
  both packages these three give the same results under every layout
  (their edge sums are of 0/1 terms, exact in any order, and gossip's
  pull has one term a node), so the reference runs them on its
  ``segment`` layout, once a graph, and each port layout is held to that;
- PageRank's and push-sum's f32 values and stats exactly under ``mxu``
  and ``hybrid``; under ``segment`` within ``RTOL`` / ``ATOL``, because
  the reference's ``segment_sum`` adds a node's terms in another order
  than ``scatter_add_`` (``tests/test_torch_ring.py`` holds ``propagate``
  to the same tolerance). Their run-to-threshold loops are given a
  threshold midway, in log scale, between two of the reference's
  rounds, so that tolerance cannot move the stopping round.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu.models import gossip as JGO  # noqa: E402
from p2pnetwork_tpu.models import hopdist as JHD  # noqa: E402
from p2pnetwork_tpu.models import pagerank as JPR  # noqa: E402
from p2pnetwork_tpu.models import pushsum as JPS  # noqa: E402
from p2pnetwork_tpu.models import sir as JSIR  # noqa: E402
from p2pnetwork_tpu.parallel import mesh as JM  # noqa: E402
from p2pnetwork_tpu.parallel import sharded as JS  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu_torch import _device, prng  # noqa: E402
from p2pnetwork_tpu_torch.models import gossip as TGO  # noqa: E402
from p2pnetwork_tpu_torch.models import hopdist as THD  # noqa: E402
from p2pnetwork_tpu_torch.models import pagerank as TPR  # noqa: E402
from p2pnetwork_tpu_torch.models import pushsum as TPS  # noqa: E402
from p2pnetwork_tpu_torch.models import sir as TSIR  # noqa: E402
from p2pnetwork_tpu_torch.models.flood import Flood  # noqa: E402
from p2pnetwork_tpu_torch.parallel import mesh as TM  # noqa: E402
from p2pnetwork_tpu_torch.parallel import sharded as TS  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

S = 8
RTOL, ATOL = 1e-5, 1e-9
GRAPHS = {
    "ws512": ("watts_strogatz", (512, 4, 0.2), {"seed": 0}),
    "er300": ("erdos_renyi", (300, 0.02), {"seed": 1}),
    "ws1024": ("watts_strogatz", (1024, 6, 0.2), {"seed": 0}),
}
LAYOUTS = {"segment": {}, "mxu": {"mxu": True}, "hybrid": {"hybrid": True}}
CASES = [(g, lay) for g in ("ws512", "er300") for lay in LAYOUTS]
CASE_IDS = [f"{g}-{lay}" for g, lay in CASES]
COMMS = ("ppermute", "pallas")
SIR_KW = dict(beta=0.3, gamma=0.05, source=3)
#: Nodes failed, then links added, in the churned cases.
FAILED = [5, 40, 77, 301]
LINKS = ([2, 9, 100], [280, 260, 7])


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < S:
        pytest.skip(f"needs {S} devices (the virtual CPU mesh of conftest)")
    return JM.ring_mesh(S), TM.ring_mesh(S, device="cpu")


@functools.lru_cache(maxsize=None)
def _sharded(name, layout, churned=False):
    fn, args, kw = GRAPHS[name]
    jm, tm = JM.ring_mesh(S), TM.ring_mesh(S, device="cpu")
    jsg = JS.shard_graph(getattr(JG, fn)(*args, **kw), jm, **LAYOUTS[layout])
    tsg = TS.shard_graph(getattr(TG, fn)(*args, **kw, device="cpu"), tm,
                         **LAYOUTS[layout])
    if churned:
        jsg = JS.connect(JS.with_capacity(JS.fail_nodes(jsg, FAILED), 16),
                         *LINKS)
        tsg = TS.connect(TS.with_capacity(TS.fail_nodes(tsg, FAILED), 16),
                         *LINKS)
    return jsg, tsg


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(got, want, tol=False):
    """Equal arrays, dicts or tuples of them: f32 by bits (NaN-free), or
    within ``RTOL``/``ATOL`` when ``tol``; everything else exactly."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_same(got[k], want[k], tol and k not in ("messages",
                                                           "rounds"))
        return
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w, tol)
        return
    g, w = _np(got), _np(want)
    if isinstance(want, (int, float)) and not isinstance(want, bool):
        g, w = np.float64(g), np.float64(w)
    if w.dtype.kind == "f" and tol:
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    elif w.dtype == np.float32:
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    else:
        np.testing.assert_array_equal(g, w)


def _tol(layout):
    return layout == "segment"


# ----------------------------------------------------------------- init


@pytest.mark.parametrize("proto", ["sir", "gossip", "hopdist", "pagerank",
                                   "pushsum"])
def test_init_state_equals_reference(meshes, proto):
    jsg, tsg = _sharded("ws512", "segment", churned=True)
    jp, tp = {
        "sir": (JSIR.SIR(**SIR_KW), TSIR.SIR(**SIR_KW)),
        "gossip": (JGO.Gossip(), TGO.Gossip()),
        "hopdist": (JHD.HopDistance(source=9), THD.HopDistance(source=9)),
        "pagerank": (JPR.PageRank(), TPR.PageRank()),
        "pushsum": (JPS.PushSum(), TPS.PushSum()),
    }[proto]
    want = JS.init_state(jsg, jp, jax.random.key(4))
    got = TS.init_state(tsg, tp, prng.key(4))
    assert_same(got, want)


def test_init_state_refuses_other_protocols(meshes):
    _, tsg = _sharded("er300", "segment")
    with pytest.raises(ValueError, match="implements Flood, SIR, Gossip"):
        TS.init_state(tsg, object())
    seen, frontier = TS.init_state(tsg, Flood(source=50))
    assert seen is frontier and seen.nonzero().tolist() == [[1, 2]]


# ------------------------------------------------------------------- SIR


@functools.lru_cache(maxsize=None)
def _jax_sir(name, churned=False, rng=None, until=False):
    jsg, _ = _sharded(name, "segment", churned)
    jm, proto = JM.ring_mesh(S), JSIR.SIR(**SIR_KW)
    if until:
        return JS.sir_until_coverage(jsg, jm, proto, jax.random.key(1),
                                     coverage_target=0.5, max_rounds=40,
                                     rng=rng, comm="ppermute")
    return JS.sir(jsg, jm, proto, jax.random.key(0), 12, rng=rng,
                  comm="ppermute")


def _port_sir(name, layout, comm, churned=False, rng=None, until=False):
    _, tsg = _sharded(name, layout, churned)
    tm, proto = TM.ring_mesh(S, device="cpu"), TSIR.SIR(**SIR_KW)
    if until:
        return TS.sir_until_coverage(tsg, tm, proto, prng.key(1),
                                     coverage_target=0.5, max_rounds=40,
                                     rng=rng, comm=comm)
    return TS.sir(tsg, tm, proto, prng.key(0), 12, rng=rng, comm=comm)


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("name,layout", CASES, ids=CASE_IDS)
def test_sir_equals_reference(meshes, name, layout, comm):
    assert_same(_port_sir(name, layout, comm), _jax_sir(name))


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sir_until_coverage_equals_reference(meshes, layout, comm):
    got = _port_sir("ws512", layout, comm, until=True)
    assert_same(got, _jax_sir("ws512", until=True))
    assert 0 < got[1]["rounds"] < 40


def test_sir_churned_equals_reference(meshes):
    assert_same(_port_sir("ws512", "segment", "pallas", churned=True),
                _jax_sir("ws512", churned=True))


@pytest.mark.parametrize("rng", ["exact", "tile", "fold"])
def test_sir_draw_modes_equal_reference(meshes, rng):
    # 1,024 nodes: 128-node blocks, so "tile" is the default, and
    # S * block is the padded size, so "exact" is the single device's run.
    got = _port_sir("ws1024", "segment", "ppermute", rng=rng)
    assert_same(got, _jax_sir("ws1024", rng=rng))
    if rng == "tile":
        assert_same(_port_sir("ws1024", "segment", "ppermute"), got)


def test_draw_modes_launch_counts(meshes):
    # One threefry key a launch: "exact" 1 a draw, "fold" S, "tile"
    # S * block / 128; the draws of a shard are its slice of "exact"'s.
    _, tsg = _sharded("ws1024", "segment")
    counts = {}
    for rng in ("exact", "tile", "fold"):
        draw = TS._make_draw(tsg, rng)
        keys = []
        real = prng.fold_in
        prng.fold_in = lambda k, d: keys.append(d) or real(k, d)
        try:
            out = draw(prng.key(7))
        finally:
            prng.fold_in = real
        assert out.shape == (S, 128) and out.dtype == torch.float32
        counts[rng] = len(keys) or 1
    assert counts == {"exact": 1, "tile": S, "fold": S}
    _, small = _sharded("er300", "segment")
    assert TS._resolve_rng(small, False, None) == "fold"
    assert TS._resolve_rng(tsg, False, None) == "tile"
    with pytest.raises(ValueError, match="tile RNG requires"):
        TS._make_draw(small, "tile")
    with pytest.raises(ValueError, match="rng must be"):
        TS._resolve_rng(tsg, False, "dice")


# ---------------------------------------------------------------- gossip


@functools.lru_cache(maxsize=None)
def _jax_gossip(name):
    jsg, _ = _sharded(name, "segment")
    return JS.gossip(jsg, JM.ring_mesh(S), JGO.Gossip(alpha=0.5),
                     jax.random.key(3), 6, comm="ppermute")


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("name,layout", CASES, ids=CASE_IDS)
def test_gossip_equals_reference(meshes, name, layout, comm):
    _, tsg = _sharded(name, layout)
    got = TS.gossip(tsg, meshes[1], TGO.Gossip(alpha=0.5), prng.key(3), 6,
                    comm=comm)
    assert_same(got, _jax_gossip(name))


# ------------------------------------------------ hop distance, leader


@functools.lru_cache(maxsize=None)
def _jax_hopdist(name, resumed=False):
    jsg, _ = _sharded(name, "segment")
    jm, proto = JM.ring_mesh(S), JHD.HopDistance(source=9)
    if not resumed:
        return JS.hopdist_until_done(jsg, jm, proto, comm="ppermute")
    fixed = JS.hopdist(jsg, jm, proto, 3, comm="ppermute")
    return (fixed,
            JS.hopdist_until_coverage(jsg, jm, proto, coverage_target=0.6,
                                      comm="ppermute"),
            JS.hopdist_until_done(jsg, jm, proto, state0=fixed[0],
                                  comm="ppermute"))


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("name,layout", CASES, ids=CASE_IDS)
def test_hopdist_until_done_equals_reference(meshes, name, layout, comm):
    _, tsg = _sharded(name, layout)
    got = TS.hopdist_until_done(tsg, meshes[1], THD.HopDistance(source=9),
                                comm=comm)
    assert_same(got, _jax_hopdist(name))


@pytest.mark.parametrize("comm", COMMS)
def test_hopdist_rounds_and_resume_equal_reference(meshes, comm):
    # Fixed rounds, the coverage loop, and the loop to the end resumed
    # from the fixed rounds' (dist, frontier, round).
    _, tsg = _sharded("ws512", "segment")
    proto, tm = THD.HopDistance(source=9), meshes[1]
    fixed = TS.hopdist(tsg, tm, proto, 3, comm=comm)
    got = (fixed,
           TS.hopdist_until_coverage(tsg, tm, proto, coverage_target=0.6,
                                     comm=comm),
           TS.hopdist_until_done(tsg, tm, proto, state0=fixed[0],
                                 comm=comm))
    assert_same(got, _jax_hopdist("ws512", resumed=True))


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("name", ["ws512", "er300"])
def test_leader_until_quiet_equals_reference(meshes, name, comm):
    jsg, tsg = _sharded(name, "segment", churned=True)
    want = JS.leader_until_quiet(jsg, meshes[0], comm="ppermute")
    syncs = _device.SYNCS
    got = TS.leader_until_quiet(tsg, meshes[1], comm=comm)
    assert_same(got, want)
    # One exit flag a round, the quiet round included.
    assert _device.SYNCS - syncs == got[1]["rounds"] + 1


@pytest.mark.parametrize("call", [
    lambda sg, m: TS.leader_until_quiet(sg, m),
    lambda sg, m: TS.hopdist_until_coverage(sg, m, THD.HopDistance(),
                                            adaptive_k=8),
    lambda sg, m: TS.sir(sg, TM.ring_mesh(4, device="cpu"),
                         TSIR.SIR(), prng.key(0), 1),
    lambda sg, m: TS.sir(sg, m, TSIR.SIR(), prng.key(0), 1, rng="dice"),
], ids=["leader-on-mxu", "adaptive", "mesh-size", "bad-rng"])
def test_refusals(meshes, call):
    _, tsg = _sharded("ws512", "mxu")
    with pytest.raises((ValueError, NotImplementedError)):
        call(tsg, meshes[1])
