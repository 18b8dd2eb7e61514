"""The port's node reordering against the JAX package's, on the CPU.

``degree_permutation``, ``rcm_permutation`` and ``node_permutation`` must
return the reference's permutations; ``from_edges(reorder=...)`` through
every generator must give the reference's graph byte for byte, the
relabeling (``layout_perm``/``layout_inv``) included; ``interop`` carries
it; ``to_original_order`` and ``to_layout_order`` invert each other on
numpy arrays and tensors; and a flood over a reordered graph, mapped back,
equals the flood over the graph built without reordering.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu.sim import layout as JL  # noqa: E402
from p2pnetwork_tpu_torch import interop, prng  # noqa: E402
from p2pnetwork_tpu_torch import models as TM  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine as TE  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402
from p2pnetwork_tpu_torch.sim import layout as TL  # noqa: E402
from tests.test_torch_graph import (FAMILIES, LAYOUTS,  # noqa: E402,F401
                                    assert_same_fields, build_jax,
                                    build_port, graph_fields,
                                    one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _edges(seed, n=300, m=900, isolated=20):
    """Random directed edges over ``n`` nodes, the last ``isolated`` ids
    touched by none, with several components."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n - isolated, m).astype(np.int32)
    r = rng.integers(0, n - isolated, m).astype(np.int32)
    r = np.where(s < 100, r % 100, np.maximum(r, 100)).astype(np.int32)
    return s, r, n


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("strategy", ["degree", "rcm"])
def test_permutations_equal_reference(strategy, seed):
    s, r, n = _edges(seed)
    want = JL.node_permutation(s, r, n, strategy=strategy)
    got = TL.node_permutation(s, r, n, strategy=strategy)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TL.invert_permutation(got),
                                  JL.invert_permutation(want))
    assert sorted(got.tolist()) == list(range(n))


def test_permutations_of_an_empty_graph():
    for strategy in TL.STRATEGIES:
        np.testing.assert_array_equal(
            TL.node_permutation(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                5, strategy=strategy),
            JL.node_permutation(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                5, strategy=strategy))
    with pytest.raises(ValueError, match="unknown reorder"):
        TL.node_permutation([0], [1], 2, strategy="bfs")


@pytest.mark.parametrize("strategy", ["degree", "rcm"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_reordered_build_is_byte_equal(family, strategy):
    jg = build_jax(family, reorder=strategy, **LAYOUTS)
    tg = build_port(family, reorder=strategy, **LAYOUTS)
    assert tg.layout_perm is not None
    assert_same_fields(graph_fields(tg), graph_fields(jg))
    carried = interop.graph_from_numpy(graph_fields(jg), device="cpu")
    assert_same_fields(graph_fields(carried), graph_fields(tg))


def test_weighted_reordered_build_is_byte_equal():
    s, r, n = _edges(4)
    w = np.random.default_rng(4).random(s.size).astype(np.float32)
    kw = dict(weights=w, reorder="rcm", skew_table=True, source_csr=True)
    assert_same_fields(graph_fields(TG.from_edges(s, r, n, device="cpu",
                                                  **kw)),
                       graph_fields(JG.from_edges(s, r, n, **kw)))


def test_order_maps_invert_each_other():
    tg = build_port("ba", reorder="rcm")
    jg = build_jax("ba", reorder="rcm")
    x = np.random.default_rng(0).random(tg.n_nodes_padded).astype(np.float32)
    for arr in (x, torch.from_numpy(x)):
        back = TL.to_layout_order(TL.to_original_order(arr, tg), tg)
        np.testing.assert_array_equal(np.asarray(back), x)
    np.testing.assert_array_equal(np.asarray(TL.to_original_order(x, tg)),
                                  np.asarray(JL.to_original_order(x, jg)))
    np.testing.assert_array_equal(TL.to_layout_order(torch.from_numpy(x),
                                                     tg).numpy(),
                                  np.asarray(JL.to_layout_order(x, jg)))
    plain = build_port("ba")
    assert TL.to_original_order(x, plain) is x


@pytest.mark.parametrize("strategy", ["degree", "rcm"])
def test_reordered_flood_maps_back_to_the_plain_flood(strategy):
    plain = build_port("ws", **LAYOUTS)
    tg = build_port("ws", reorder=strategy, **LAYOUTS)
    src = 17
    new_src = int(tg.layout_perm[src])
    ps, pout = TE.run_until_coverage(plain, TM.Flood(source=src,
                                                     method="hybrid"),
                                     prng.key(0), coverage_target=1.0)
    rs, rout = TE.run_until_coverage(tg, TM.Flood(source=new_src,
                                                  method="hybrid"),
                                     prng.key(0), coverage_target=1.0)
    assert rout == pout
    assert torch.equal(TL.to_original_order(rs.seen, tg), ps.seen)
