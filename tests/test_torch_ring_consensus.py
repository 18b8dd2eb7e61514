"""PageRank and push-sum on the ring (``parallel/sharded.py``) against the
JAX package's ring: the fixed-round runs, the run-to-threshold loops and
their ``T``-round super-steps.

The JAX ring runs on the 8-device virtual CPU mesh of
``tests/conftest.py`` with ``comm="ppermute"``, once a case, shared by
the port's two comms (``tests/test_torch_ring_protocols.py`` says why;
its graphs, layouts and comparison are this file's). f32 values and
stats are exact under ``mxu`` and ``hybrid`` (the damped update has the
reference's fused multiply-add, the totals its order of adds) and within
``RTOL`` / ``ATOL`` under ``segment``, whose ``segment_sum`` adds a
node's terms in another order than ``scatter_add_``. A run-to-threshold
loop is given a threshold midway, in log scale, between two of the
reference's rounds, so that tolerance cannot move its stopping round.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu.models import pagerank as JPR  # noqa: E402
from p2pnetwork_tpu.models import pushsum as JPS  # noqa: E402
from p2pnetwork_tpu.parallel import mesh as JM  # noqa: E402
from p2pnetwork_tpu.parallel import sharded as JS  # noqa: E402
from p2pnetwork_tpu_torch import prng  # noqa: E402
from p2pnetwork_tpu_torch.models import pagerank as TPR  # noqa: E402
from p2pnetwork_tpu_torch.models import pushsum as TPS  # noqa: E402
from p2pnetwork_tpu_torch.parallel import sharded as TS  # noqa: E402
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401
from tests.test_torch_ring_protocols import (  # noqa: E402,F401
    CASE_IDS, CASES, COMMS, LAYOUTS, S, _sharded, _tol, assert_same, meshes)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _midway(values, k):
    """A threshold midway, in log scale, between rounds ``k`` and ``k +
    1`` of a decreasing stat."""
    v = np.asarray(values, np.float64)
    return float(np.sqrt(v[k] * v[k + 1]))


@functools.lru_cache(maxsize=None)
def _jax_pagerank(name, layout, churned=False):
    jsg, _ = _sharded(name, layout, churned)
    return JS.pagerank(jsg, JM.ring_mesh(S), JPR.PageRank(), 10,
                       comm="ppermute")


@functools.lru_cache(maxsize=None)
def _jax_pagerank_until(layout):
    jsg, _ = _sharded("ws512", layout)
    tol = _midway(_jax_pagerank("ws512", layout)[1]["residual"], 6)
    return JS.pagerank_until_residual(jsg, JM.ring_mesh(S), JPR.PageRank(),
                                      tol=tol, max_rounds=40,
                                      comm="ppermute"), tol


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("name,layout", CASES, ids=CASE_IDS)
def test_pagerank_equals_reference(meshes, name, layout, comm):
    _, tsg = _sharded(name, layout)
    assert_same(TS.pagerank(tsg, meshes[1], TPR.PageRank(), 10, comm=comm),
                _jax_pagerank(name, layout), _tol(layout))


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pagerank_until_residual_equals_reference(meshes, layout, comm):
    want, tol = _jax_pagerank_until(layout)
    _, tsg = _sharded("ws512", layout)
    got = TS.pagerank_until_residual(tsg, meshes[1], TPR.PageRank(),
                                     tol=tol, max_rounds=40, comm=comm)
    assert_same(got, want, _tol(layout))
    assert got[1]["rounds"] == 8


def test_pagerank_churned_equals_reference(meshes):
    _, tsg = _sharded("ws512", "segment", churned=True)
    assert_same(TS.pagerank(tsg, meshes[1], TPR.PageRank(), 10,
                            comm="pallas"),
                _jax_pagerank("ws512", "segment", churned=True), True)


@functools.lru_cache(maxsize=None)
def _jax_pushsum(name, layout):
    jsg, _ = _sharded(name, layout)
    return JS.pushsum(jsg, JM.ring_mesh(S), JPS.PushSum(), jax.random.key(5),
                      10, comm="ppermute")


@functools.lru_cache(maxsize=None)
def _jax_pushsum_until(layout):
    jsg, _ = _sharded("ws512", layout)
    tol = _midway(_jax_pushsum("ws512", layout)[1]["variance"], 5)
    return JS.pushsum_until_variance(jsg, JM.ring_mesh(S), JPS.PushSum(),
                                     jax.random.key(5), tol=tol,
                                     max_rounds=40, comm="ppermute"), tol


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("name,layout", CASES, ids=CASE_IDS)
def test_pushsum_equals_reference(meshes, name, layout, comm):
    _, tsg = _sharded(name, layout)
    assert_same(TS.pushsum(tsg, meshes[1], TPS.PushSum(), prng.key(5), 10,
                           comm=comm), _jax_pushsum(name, layout),
                _tol(layout))


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pushsum_until_variance_equals_reference(meshes, layout, comm):
    want, tol = _jax_pushsum_until(layout)
    _, tsg = _sharded("ws512", layout)
    got = TS.pushsum_until_variance(tsg, meshes[1], TPS.PushSum(),
                                    prng.key(5), tol=tol, max_rounds=40,
                                    comm=comm)
    assert_same(got, want, _tol(layout))
    assert got[1]["rounds"] == 7


@pytest.mark.parametrize("layout", ["segment", "hybrid"])
def test_freeze_while_batches_are_exact(meshes, layout):
    # T rounds a super-step, each sub-step re-checking and freezing the
    # state once the test fails: T = 3 gives T = 1's result, which is the
    # reference's; a stop mid super-step (7 and 6 rounds) freezes.
    _, tsg = _sharded("ws512", layout)
    pr_until, pr_tol = _jax_pagerank_until(layout)
    ps_until, ps_tol = _jax_pushsum_until(layout)
    for T in (1, 3):
        got = TS.pagerank_until_residual(tsg, meshes[1], TPR.PageRank(),
                                         tol=pr_tol, max_rounds=40,
                                         steps_per_round=T)
        assert_same(got, pr_until, _tol(layout))
        got = TS.pushsum_until_variance(tsg, meshes[1], TPS.PushSum(),
                                        prng.key(5), tol=ps_tol,
                                        max_rounds=40, steps_per_round=T)
        assert_same(got, ps_until, _tol(layout))
    with pytest.raises(ValueError, match="steps_per_round"):
        TS.pagerank_until_residual(tsg, meshes[1], TPR.PageRank(),
                                   steps_per_round=0)


