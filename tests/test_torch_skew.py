"""The port's two-level skew table (``ops/skew.py``) against the JAX
package's.

The host build is byte-equal (picked and forced widths, with and without
failures before a late ``with_skew_table``); OR over the table is
bit-equal; the f32 sum adds each owner's row sums in another order than
the reference's segment sum, so it is held to ``rtol = atol = 1e-5``
(integer-valued sums are exact). ``auto`` must route to ``skew`` on a
graph that carries the table and no usable neighbor table, and the skew
flood must return the reference's dict."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from p2pnetwork_tpu.models import flood as JF  # noqa: E402
from p2pnetwork_tpu.ops import segment as JS  # noqa: E402
from p2pnetwork_tpu.ops import skew as JSK  # noqa: E402
from p2pnetwork_tpu.sim import engine as JE  # noqa: E402
from p2pnetwork_tpu.sim import failures as JFa  # noqa: E402
from p2pnetwork_tpu_torch import interop, prng  # noqa: E402
from p2pnetwork_tpu_torch.models import flood as TF  # noqa: E402
from p2pnetwork_tpu_torch.ops import segment as TS  # noqa: E402
from p2pnetwork_tpu_torch.ops import skew as TSK  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine as TE  # noqa: E402
from p2pnetwork_tpu_torch.sim import failures as TFa  # noqa: E402
from tests.test_torch_graph import (FAMILIES, assert_same_fields,  # noqa: E402
                                    build_jax, build_port, graph_fields)

RTOL = ATOL = 1e-5
#: The ladder's BA rung as built there: no neighbor table, skew table on.
SKEW_KW = dict(build_neighbor_table=False, source_csr=True, skew_table=True)


@pytest.mark.parametrize("width", [0, 16])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_build_is_byte_equal(family, width):
    kw = dict(SKEW_KW, skew_width=width)
    got, want = build_port(family, **kw), build_jax(family, **kw)
    assert_same_fields(graph_fields(got), graph_fields(want))
    assert got.skew.width == want.skew.width
    assert (got.skew.n_rows, got.skew.n_slots) == (want.skew.n_rows,
                                                   want.skew.n_slots)
    e_pad = got.n_edges_padded
    np.testing.assert_array_equal(got.skew.edge_slots(e_pad).numpy(),
                                  np.asarray(want.skew.edge_slots(e_pad)))
    assert TSK.pick_width(got.in_degree.numpy()) == JSK.pick_width(
        np.asarray(want.in_degree))


def test_late_table_keeps_failures():
    # with_skew_table after node failures re-masks the new table by the
    # graph's current edge mask, as the reference's build_skew does.
    ids = np.arange(10, 60)
    jg = JFa.fail_nodes(build_jax("ba", source_csr=True), ids)
    tg = TFa.fail_nodes(build_port("ba", source_csr=True), ids)
    assert_same_fields(graph_fields(tg.with_skew_table()),
                       graph_fields(jg.with_skew_table()))


@pytest.fixture(scope="module")
def ba():
    return build_jax("ba", **SKEW_KW), build_port("ba", **SKEW_KW)


def test_or_and_sum_over_the_table(ba):
    jg, tg = ba
    rng = np.random.default_rng(0)
    n = jg.n_nodes_padded
    sig = rng.random(n) < 0.2
    np.testing.assert_array_equal(
        TS.propagate_or(tg, torch.from_numpy(sig), "skew").numpy(),
        np.asarray(JS.propagate_or(jg, jnp.asarray(sig), "skew")))
    x = rng.standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(
        TS.propagate_sum(tg, torch.from_numpy(x), "skew").numpy(),
        np.asarray(JS.propagate_sum(jg, jnp.asarray(x), "skew")),
        rtol=RTOL, atol=ATOL)
    xi = rng.integers(-8, 8, n).astype(np.float32)
    np.testing.assert_array_equal(
        TS.propagate_sum(tg, torch.from_numpy(xi), "skew").numpy(),
        np.asarray(JS.propagate_sum(jg, jnp.asarray(xi), "skew")))
    got = TSK.or_skew(tg.skew, torch.from_numpy(sig), n)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JSK.or_skew(jg.skew, jnp.asarray(sig), n)))


def test_auto_routes_to_skew(ba):
    jg, tg = ba
    assert TS._auto_method(tg) == JS._auto_method(jg) == "skew"
    sig = np.zeros(jg.n_nodes_padded, dtype=bool)
    sig[:5] = True
    np.testing.assert_array_equal(
        TS.propagate_or(tg, torch.from_numpy(sig)).numpy(),
        TS.propagate_or(tg, torch.from_numpy(sig), "skew").numpy())


@pytest.mark.parametrize("method", ["skew", "auto", "segment"])
def test_skew_flood_matches(ba, method):
    jg, tg = ba
    js, jout = JE.run_until_coverage(jg, JF.Flood(source=0, method=method),
                                     jax.random.key(0), coverage_target=0.99,
                                     max_rounds=64)
    ts, tout = TE.run_until_coverage(tg, TF.Flood(source=0, method=method),
                                     prng.key(0), coverage_target=0.99,
                                     max_rounds=64)
    assert tout == jout
    np.testing.assert_array_equal(ts.seen.numpy(), np.asarray(js.seen))


def test_interop_carries_the_table_and_refuses_weights(ba):
    # Weights are carried since the weighted aggregations were ported
    # (the table's and the graph's alike), and the node relabeling since
    # reordered builds were; a field the port does not model is refused.
    jg, tg = ba
    fields = graph_fields(jg)
    assert_same_fields(graph_fields(interop.graph_from_numpy(
        fields, device="cpu")), graph_fields(tg))
    weight = np.arange(tg.skew.src.numel(), dtype=np.float32).reshape(
        tg.skew.src.shape)
    fields["skew"] = dict(fields["skew"], weight=weight)
    carried = interop.graph_from_numpy(fields, device="cpu")
    np.testing.assert_array_equal(carried.skew.weight.numpy(), weight)
    perm = np.arange(tg.n_nodes_padded, dtype=np.int32)[::-1].copy()
    fields["layout_perm"] = fields["layout_inv"] = perm
    carried = interop.graph_from_numpy(fields, device="cpu")
    np.testing.assert_array_equal(carried.layout_perm.numpy(), perm)
    fields["delta_log"] = perm
    with pytest.raises(NotImplementedError, match="delta_log"):
        interop.graph_from_numpy(fields, device="cpu")


def test_skew_needs_the_table():
    tg = build_port("er")
    with pytest.raises(ValueError, match="skew"):
        TS.propagate_or(tg, torch.zeros(tg.n_nodes_padded, dtype=torch.bool),
                        "skew")
