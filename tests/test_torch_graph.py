"""The port's graph builds against the JAX package: every array field is
byte-equal (same dtype, same shape, same bytes) for the same generator
arguments and layout flags, the static ints equal, and a graph carried
across by ``interop.graph_from_numpy`` equals the port's own build.

Also the home of the JAX -> numpy field helpers the other
``test_torch_*`` files share."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu_torch import interop  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402

#: Graph families at the sizes the reference's blocked/Pallas parity tests
#: use for ER and BA, and the main path's WS shape at 4,096 nodes.
FAMILIES = {
    "ws": ("watts_strogatz", (4096, 10, 0.1), {"seed": 0}),
    "er": ("erdos_renyi", (500, 0.02), {"seed": 1}),
    "ba": ("barabasi_albert", (300, 4), {"seed": 2}),
}
#: The layout flags of the main path's graph build.
LAYOUTS = {"blocked": True, "hybrid": True, "source_csr": True}

#: Reference Graph fields the port does not model; None on these builds.
UNPORTED = ("skew", "dyn_senders", "dyn_receivers", "dyn_mask",
            "edge_weight", "neighbor_weight", "layout_perm", "layout_inv")


def build_jax(family, **kw):
    name, args, fkw = FAMILIES[family]
    return getattr(JG, name)(*args, **fkw, **kw)


def build_port(family, **kw):
    name, args, fkw = FAMILIES[family]
    return getattr(TG, name)(*args, **fkw, device="cpu", **kw)


def _np(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _blocked_fields(b):
    if b is None:
        return None
    return {"src": _np(b.src), "local_dst": _np(b.local_dst),
            "mask": _np(b.mask), "block": b.block}


def graph_fields(g) -> dict:
    """Either package's Graph as a dict of numpy arrays and static ints,
    ``blocked``/``hybrid`` as nested dicts (``interop``'s input format)."""
    out = {}
    for f in dataclasses.fields(g):
        v = getattr(g, f.name)
        if f.name in UNPORTED:
            assert v is None, f"{f.name} is set but not ported"
        elif f.name == "blocked":
            out[f.name] = _blocked_fields(v)
        elif f.name == "hybrid":
            out[f.name] = None if v is None else {
                "masks": _np(v.masks), "offsets": tuple(v.offsets), "n": v.n,
                "remainder": _blocked_fields(v.remainder)}
        elif isinstance(v, (jax.Array, torch.Tensor)):
            out[f.name] = _np(v)
        else:
            out[f.name] = v
    return out


def state_fields(state) -> dict:
    """A flood state (either package) as a dict of numpy arrays."""
    return {f.name: _np(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def assert_same_fields(got, want, path=""):
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for key in want:
        g, w = got[key], want[key]
        where = f"{path}{key}"
        if isinstance(w, dict):
            assert isinstance(g, dict), where
            assert_same_fields(g, w, where + ".")
        elif isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), where
            assert g.dtype == w.dtype and g.shape == w.shape, (
                where, g.dtype, w.dtype, g.shape, w.shape)
            assert g.tobytes() == w.tobytes(), where
        else:
            assert g == w, (where, g, w)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_build_with_layouts_is_byte_equal(family):
    got = graph_fields(build_port(family, **LAYOUTS))
    want = graph_fields(build_jax(family, **LAYOUTS))
    assert got["blocked"] is not None and got["hybrid"] is not None
    assert got["src_eid"] is not None
    assert_same_fields(got, want)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plain_build_is_byte_equal(family):
    assert_same_fields(graph_fields(build_port(family)),
                       graph_fields(build_jax(family)))


def test_capped_neighbor_table_is_byte_equal():
    # Over-degree rows keep a seeded random subset of their in-edges.
    got = graph_fields(build_port("ba", max_degree=3))
    want = graph_fields(build_jax("ba", max_degree=3))
    assert got["neighbors_complete"] is False
    assert_same_fields(got, want)


def test_main_path_shapes_at_4096():
    # The WS build the flood main path runs, at 4,096 nodes.
    g = build_port("ws", **LAYOUTS)
    assert len(g.hybrid.offsets) == 10
    assert tuple(g.hybrid.remainder.src.shape) == (8, 640)
    assert g.hybrid.remainder.block == 512
    assert tuple(g.blocked.src.shape) == (32, 1408)
    assert g.blocked.block == 128
    assert g.max_out_span == 15


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_interop_graph_equals_port_build(family):
    carried = interop.graph_from_numpy(
        graph_fields(build_jax(family, **LAYOUTS)), device="cpu")
    assert_same_fields(graph_fields(carried),
                       graph_fields(build_port(family, **LAYOUTS)))


def test_gather_row_slots_matches_reference():
    jg = build_jax("ba", source_csr=True)
    tg = build_port("ba", source_csr=True)
    rng = np.random.default_rng(3)
    nodes = rng.integers(0, jg.n_nodes_padded, size=64).astype(np.int32)
    offs = np.asarray(jg.src_offsets)
    start, end = offs[nodes], offs[nodes + 1]
    w = jg.max_out_span
    jeid, jvalid = jg.gather_row_slots(jnp.asarray(start), jnp.asarray(end), w)
    teid, tvalid = tg.gather_row_slots(torch.from_numpy(start),
                                       torch.from_numpy(end), w)
    np.testing.assert_array_equal(teid.numpy(), np.asarray(jeid))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("call", [
    lambda: TG.watts_strogatz(10, 3, 0.1, device="cpu"),
    lambda: TG.watts_strogatz(10, 10, 0.1, device="cpu"),
    lambda: TG.barabasi_albert(10, 10, device="cpu"),
    lambda: TG.from_edges([0, 5], [1, 2], 4, device="cpu"),
    lambda: TG.from_edges([0, 1], [1], 4, device="cpu"),
])
def test_bad_arguments_raise(call):
    with pytest.raises(ValueError):
        call()


def test_empty_graph_builds():
    got = graph_fields(TG.erdos_renyi(50, 0.0, device="cpu"))
    want = graph_fields(JG.erdos_renyi(50, 0.0))
    assert got["n_edges"] == 0
    assert_same_fields(got, want)
