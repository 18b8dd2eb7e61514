"""The port's aggregation against the JAX package, method by method.

Inputs are made with numpy from a seed and handed to both packages; the
graph is built once by the JAX package and carried across with
``interop.graph_from_numpy``. The JAX side runs its ``pallas`` and
``hybrid`` methods through the Pallas interpreter, as its own tests do on
the CPU.

Tolerances: OR is bit-exact. Sums are held to ``rtol = atol = 1e-5`` (the
reference's own, tests/test_blocked_pallas.py), because the two packages
add each node's terms in different orders; integer-valued sums are exact.
The kernel's own checks are in ``test_torch_kernels.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from p2pnetwork_tpu.ops import segment as JS  # noqa: E402
from p2pnetwork_tpu_torch import interop  # noqa: E402
from p2pnetwork_tpu_torch.ops import segment as TS  # noqa: E402
from tests.test_torch_graph import (FAMILIES, LAYOUTS, build_jax,  # noqa: E402
                                    graph_fields)

METHODS = ["segment", "gather", "blocked", "pallas", "hybrid",
           "hybrid-blocked", "auto"]
RTOL = ATOL = 1e-5


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def graphs(request):
    jg = build_jax(request.param, **LAYOUTS)
    return jg, interop.graph_from_numpy(graph_fields(jg), device="cpu")


@pytest.mark.parametrize("method", METHODS)
def test_or_is_bit_equal(graphs, method):
    jg, tg = graphs
    rng = np.random.default_rng(0)
    sig = (rng.random(jg.n_nodes_padded) < 0.15) & np.asarray(jg.node_mask)
    want = np.asarray(JS.propagate_or(jg, jnp.asarray(sig), method))
    got = TS.propagate_or(tg, torch.from_numpy(sig), method).numpy()
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", METHODS)
def test_sum_within_tolerance(graphs, method):
    jg, tg = graphs
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(jg.n_nodes_padded).astype(np.float32)
         * np.asarray(jg.node_mask))
    want = np.asarray(JS.propagate_sum(jg, jnp.asarray(x), method))
    got = TS.propagate_sum(tg, torch.from_numpy(x), method).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method", ["pallas", "hybrid"])
def test_integer_sum_is_exact(graphs, method):
    jg, tg = graphs
    rng = np.random.default_rng(2)
    x = rng.integers(0, 64, jg.n_nodes_padded).astype(np.float32)
    want = np.asarray(JS.propagate_sum(jg, jnp.asarray(x), method))
    got = TS.propagate_sum(tg, torch.from_numpy(x), method).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("where", ["live", "padding"])
@pytest.mark.parametrize("method", ["pallas", "hybrid"])
def test_nonfinite_sum_spreads_as_the_reference(graphs, method, where):
    # The reference's one-hot product spreads a non-finite term over its
    # node-block row (NaN at every other destination); the port's sum
    # does the same. "live": NaN, +inf and -inf at three live nodes that
    # send on real edges; "padding": +inf at node 0, which every padding
    # slot of the blocked layouts reads (behind a False mask). The NaN
    # sets must be equal and every other output agree.
    jg, tg = graphs
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(jg.n_nodes_padded).astype(np.float32)
         * np.asarray(jg.node_mask))
    if where == "padding":
        x[0] = np.inf
    else:
        senders = np.flatnonzero(np.asarray(jg.out_degree)[1:jg.n_nodes]) + 1
        x[rng.choice(senders, 3, replace=False)] = [np.nan, np.inf, -np.inf]
    want = np.asarray(JS.propagate_sum(jg, jnp.asarray(x), method))
    got = TS.propagate_sum(tg, torch.from_numpy(x), method).numpy()
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
