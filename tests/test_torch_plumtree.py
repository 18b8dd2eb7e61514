"""The port's Plumtree against the JAX package's, on the CPU.

Broadcasts run step by step in both packages on the same graph: the first
(a flood that prunes the eager set to a tree), a second over the tree
(no duplicates), and a third after a band of nodes failed, whose wave
dies early and must graft lazy links back. The eager set (as bools, or as
the packed words of the bit state compared as ``uint32``), the round and
every stat must equal the reference's exactly. ``tree_graph`` must give
the reference's graph byte for byte, weighted and not, and a flood over
it the reference's dict. A state the reference made resumes in the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu import models as JM  # noqa: E402
from p2pnetwork_tpu.sim import engine as JE  # noqa: E402
from p2pnetwork_tpu.sim import failures as JFa  # noqa: E402
from p2pnetwork_tpu_torch import _device, interop, prng  # noqa: E402
from p2pnetwork_tpu_torch import models as TM  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine as TE  # noqa: E402
from p2pnetwork_tpu_torch.sim import failures as TFa  # noqa: E402
from p2pnetwork_tpu_torch.sim import topology as TT  # noqa: E402
from tests.test_torch_graph import (assert_same_fields,  # noqa: E402,F401
                                    build_jax, build_port, graph_fields,
                                    one_torch_thread, state_fields)
from tests.test_torch_semiring import latency  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def assert_state_equal(got, want):
    got, want = state_fields(got), state_fields(want)
    assert set(got) == set(want)
    for k in want:
        w = want[k]
        g = got[k].view(np.uint32) if w.dtype == np.uint32 else got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def assert_stats_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].item() == np.asarray(want[k]).item(), k


def broadcasts(family, bitset, source=0, weighted=False):
    """Three broadcasts in both packages, the third after failures;
    returns the graphs and the port's states after each."""
    jg, tg = build_jax(family), build_port(family)
    if weighted:
        jg, tg = jg.with_weights(latency), tg.with_weights(latency)
    jp = JM.Plumtree(source=source, bitset=bitset)
    tp = TM.Plumtree(source=source, bitset=bitset)
    js, ts = jp.init(jg, jax.random.key(0)), tp.init(tg, prng.key(0))
    assert_state_equal(ts, js)
    out = []
    for b in range(3):
        if b == 2:
            dead = np.arange(jg.n_nodes // 7, jg.n_nodes // 7 + 40)
            jg, tg = JFa.fail_nodes(jg, dead), TFa.fail_nodes(tg, dead)
        js, jst = jp.step(jg, js, jax.random.key(b))
        ts, tst = tp.step(tg, ts, prng.key(b))
        assert_stats_equal(tst, jst)
        assert_state_equal(ts, js)
        out.append((tst, js, ts))
    return jg, tg, jp, tp, out


@pytest.mark.parametrize("bitset", [False, True], ids=["bool", "bits"])
@pytest.mark.parametrize("family", ["ws", "ba", "er"])
def test_broadcasts_equal_reference(family, bitset):
    _, _, _, _, out = broadcasts(family, bitset)
    first, second, healed = (o[0] for o in out)
    assert first["duplicates"] > 0
    assert second["duplicates"] == 0
    assert second["messages"] < first["messages"]
    if family != "er":  # the ER graph at this size has isolated nodes
        assert healed["grafts"] > 0


def test_graft_syncs_once_a_layer_and_twice_a_dead_layer():
    _, tg, _, tp, out = broadcasts("ws", False)
    ts = out[-1][2]
    _device.SYNCS = 0
    ts2, st = tp.step(tg, ts, prng.key(9))
    # The eager tree has healed: no graft, one read a layer plus the dead
    # layer's second read.
    assert st["grafts"].item() == 0 and _device.SYNCS >= 3


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
def test_tree_graph_is_byte_equal(weighted):
    jg, tg, jp, tp, out = broadcasts("ws", True, weighted=weighted)
    for _, js, ts in out:
        jt = jp.tree_graph(jg, js, source_csr=True)
        tt = tp.tree_graph(tg, ts, source_csr=True)
        assert_same_fields(graph_fields(tt), graph_fields(jt))
    # The steady broadcast: a flood over the extracted tree.
    jst, jout = JE.run_until_coverage(jt, JM.Flood(source=0),
                                      jax.random.key(0),
                                      coverage_target=1.0, max_rounds=256)
    tst, tout = TE.run_until_coverage(tt, TM.Flood(source=0), prng.key(0),
                                      coverage_target=1.0, max_rounds=256)
    assert tout == jout
    np.testing.assert_array_equal(tst.seen.numpy(), np.asarray(jst.seen))


def test_state_carries_across_and_resumes():
    for bitset, name in ((False, "PlumtreeState"),
                         (True, "PlumtreeBitState")):
        jg, tg = build_jax("ba"), build_port("ba")
        jp = JM.Plumtree(source=3, bitset=bitset)
        tp = TM.Plumtree(source=3, bitset=bitset)
        js, _ = jp.step(jg, jp.init(jg, jax.random.key(0)),
                        jax.random.key(0))
        ts = interop.protocol_state_from_numpy(name, state_fields(js),
                                               device="cpu")
        js2, jst = jp.step(jg, js, jax.random.key(1))
        ts2, tst = tp.step(tg, ts, prng.key(1))
        assert_stats_equal(tst, jst)
        assert_state_equal(ts2, js2)


def test_plumtree_refuses_as_the_reference():
    tg = build_port("ws")
    with pytest.raises(ValueError, match="source"):
        TM.Plumtree(source=tg.n_nodes_padded).init(tg, prng.key(0))
    dyn = TT.with_capacity(tg, extra_edges=8)
    with pytest.raises(ValueError, match="dynamic"):
        TM.Plumtree().init(dyn, prng.key(0))
    st = TM.Plumtree().init(tg, prng.key(0))
    with pytest.raises(ValueError, match="node_pad_multiple"):
        TM.Plumtree().tree_graph(tg, st, node_pad_multiple=7)
