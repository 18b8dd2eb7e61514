"""The port's state and graph files against the JAX package, on the CPU.

A checkpoint written by either package loads in the other, and a file the
port writes for a state carries the reference's ``__sha256__`` for the
same state: the same leaves with the same dtypes (the packed words as
``uint32``), the same key words and counters, and the same treedef
string, which the port renders from its own dataclasses for every state
class. Graph files cross both ways with every array byte-equal. Also:
``CheckpointCorrupt`` on truncated and bit-flipped files, structure
mismatches, ``grow_state`` / ``load(grow=True)`` after a repad,
``topology_state`` / ``apply_topology_state``, ``load_node_payload``,
the refused orbax entry points, and the layout cache's fingerprint and
miss reasons.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from p2pnetwork_tpu import models as JM  # noqa: E402
from p2pnetwork_tpu.models import adaptive_flood as JAF  # noqa: E402
from p2pnetwork_tpu.models import flood as JFlood  # noqa: E402
from p2pnetwork_tpu.models import messagebatch as JMB  # noqa: E402
from p2pnetwork_tpu.models import plumtree as JPT  # noqa: E402
from p2pnetwork_tpu.models import querybatch as JQ  # noqa: E402
from p2pnetwork_tpu.sim import checkpoint as JC  # noqa: E402
from p2pnetwork_tpu.sim import engine as JE  # noqa: E402
from p2pnetwork_tpu.sim import failures as JFa  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu_torch import models as TM  # noqa: E402
from p2pnetwork_tpu_torch import prng, telemetry  # noqa: E402
from p2pnetwork_tpu_torch.models import messagebatch as TMB  # noqa: E402
from p2pnetwork_tpu_torch.models import querybatch as TQ  # noqa: E402
from p2pnetwork_tpu_torch.sim import checkpoint as TC  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine as TE  # noqa: E402
from p2pnetwork_tpu_torch.sim import failures as TFa  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402
from p2pnetwork_tpu_torch.sim import layoutcache  # noqa: E402
from tests.test_torch_analytics import ALL, churn  # noqa: E402
from tests.test_torch_analytics import JT, TT  # noqa: E402
from tests.test_torch_graph import (LAYOUTS, assert_same_fields,  # noqa: E402
                                    build_jax, build_port, graph_fields,
                                    one_torch_thread, state_fields)
from tests.test_torch_semiring import bits, latency  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

#: Every state class of the port, by the name both packages use.
STATE_CLASSES = sorted(
    [n for n in dir(TM) if n.endswith("State")] + ["MessageBatch",
                                                   "QueryBatch"])
assert {"FloodBitState", "AdaptiveFloodBitState", "PlumtreeBitState",
        "VivaldiState"} <= set(STATE_CLASSES)


def _cls(mods, name):
    """The class ``name`` in either package's ``models`` (the packed
    states live in their protocol's module)."""
    for mod in mods:
        if hasattr(mod, name):
            return getattr(mod, name)
    raise LookupError(name)


JMODS = (JM, JMB, JQ, JFlood, JAF, JPT)
TMODS = (TM, TMB, TQ)


def _instance(cls, leaf, none_first=False):
    kw = {}
    for i, f in enumerate(dataclasses.fields(cls)):
        kw[f.name] = ({"s": leaf(), "w": leaf()} if f.name == "payload"
                      else None if (none_first and i == 0) else leaf())
    return cls(**kw)


@pytest.mark.parametrize("none_first", [False, True],
                         ids=["leaves", "none-leaf"])
@pytest.mark.parametrize("name", STATE_CLASSES)
def test_treedef_string_is_jax_s(name, none_first):
    jcls, tcls = _cls(JMODS, name), _cls(TMODS, name)
    assert ([f.name for f in dataclasses.fields(tcls)]
            == [f.name for f in dataclasses.fields(jcls)])
    # The packed word fields a class declares are its own fields.
    assert set(getattr(tcls, "U32_WORDS", ())) <= {
        f.name for f in dataclasses.fields(tcls)}
    jobj = _instance(jcls, lambda: jnp.zeros(1), none_first)
    tobj = _instance(tcls, lambda: torch.zeros(1), none_first)
    assert TC.treedef_str(tobj) == str(jax.tree_util.tree_flatten(jobj)[1])
    nested = {"protocol": tobj, "topology": {"b": 1, "a": (2,)},
              "churn_count": np.int64(0), "x": [None, (1, 2)]}
    jnested = {"protocol": jobj, "topology": {"b": 1, "a": (2,)},
               "churn_count": np.int64(0), "x": [None, (1, 2)]}
    assert TC.treedef_str(nested) == str(
        jax.tree_util.tree_flatten(jnested)[1])


_G = {}


def graphs():
    if "ws" not in _G:
        _G["ws"] = build_jax("ws", **ALL), build_port("ws", **ALL)
    return _G["ws"]


def _run(jg, tg, jp, tp, rounds=3):
    js, _ = JE.run(jg, jp, jax.random.key(0), rounds)
    ts, _ = TE.run(tg, tp, prng.key(0), rounds)
    return js, ts


def _flood(M, **kw):
    return M.AdaptiveFlood(source=0, **kw)


#: The states saved across, each made by both packages' own entry
#: points on the shared WS graph (:func:`make_states`).
STATES = ("AdaptiveFloodState", "AdaptiveFloodBitState", "FloodBitState",
          "SIRState", "PlumtreeBitState", "DistanceVectorState",
          "MessageBatch", "QueryBatch")


def make_states(name):
    """``(jax state, port state, jax template, port template)``."""
    jg, tg = graphs()
    if name == "MessageBatch":
        src = np.array([0, 5, 77, 4000])
        jb = JMB.BatchFlood().init(jg, src)
        tb = TMB.BatchFlood().init(tg, src)
        jb, _ = JE.run_batch_until_coverage(jg, JMB.BatchFlood(), jb,
                                            jax.random.key(0), max_rounds=3,
                                            donate=False)
        tb, _ = TE.run_batch_until_coverage(tg, TMB.BatchFlood(), tb,
                                            prng.key(0), max_rounds=3)
        return jb, tb, JMB.BatchFlood().init(jg, src), \
            TMB.BatchFlood().init(tg, src)
    if name == "QueryBatch":
        jp, tp = JQ.MinPlusQueries(), TQ.MinPlusQueries()
        jb = jp.init(jg, [0, 9], [100, 200])
        tb = tp.init(tg, [0, 9], [100, 200])
        jb, _ = JE.run_queries_until_done(jg, jp, jb, jax.random.key(0),
                                          max_rounds=2, donate=False)
        tb, _ = TE.run_queries_until_done(tg, tp, tb, prng.key(0),
                                          max_rounds=2)
        return jb, tb, jp.init(jg, [0, 9], [100, 200]), \
            tp.init(tg, [0, 9], [100, 200])
    make = {
        "AdaptiveFloodState": lambda M: _flood(M, method="hybrid"),
        "AdaptiveFloodBitState": lambda M: _flood(M, method="frontier",
                                                  bitset=True),
        "FloodBitState": lambda M: M.Flood(source=0, bitset=True),
        "SIRState": lambda M: M.SIR(beta=0.3, gamma=0.1, source=0,
                                    method="hybrid"),
        "PlumtreeBitState": lambda M: M.Plumtree(source=3, bitset=True),
        "DistanceVectorState": lambda M: M.DistanceVector(source=0),
    }[name]
    jp, tp = make(JM), make(TM)
    js, ts = _run(jg, tg, jp, tp)
    assert type(ts).__name__ == name
    return js, ts, jp.init(jg, jax.random.key(0)), tp.init(tg, prng.key(0))


def _digest(path):
    with np.load(path) as data:
        return bytes(data["__sha256__"]).decode()


def assert_same_state(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        k, wv, gv = f.name, getattr(want, f.name), getattr(got, f.name)
        if isinstance(wv, dict):
            assert set(gv) == set(wv), k
            for kk in wv:
                np.testing.assert_array_equal(bits(np.asarray(gv[kk])),
                                              bits(np.asarray(wv[kk])))
            continue
        gk, wk = np.asarray(gv), np.asarray(wv)
        if wk.dtype == np.uint32:
            gk = gk.view(np.uint32)
        assert gk.dtype == wk.dtype and gk.shape == wk.shape, k
        np.testing.assert_array_equal(bits(gk), bits(wk), err_msg=k)


@pytest.mark.parametrize("name", STATES)
def test_checkpoints_cross_both_ways(tmp_path, name):
    js, ts, jtemplate, ttemplate = make_states(name)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    JC.save(jpath, js, jax.random.key(7), 3, 2**40 + 5)
    TC.save(tpath, ts, prng.key(7), 3, 2**40 + 5)
    assert _digest(tpath) == _digest(jpath)
    got, key, rnd, msgs = TC.load(jpath, ttemplate)
    assert (rnd, msgs) == (3, 2**40 + 5)
    np.testing.assert_array_equal(key, prng.key(7))
    assert_same_state(got, js)
    assert type(got) is type(ts)
    back, jkey, rnd, msgs = JC.load(tpath, jtemplate)
    assert (rnd, msgs) == (3, 2**40 + 5)
    np.testing.assert_array_equal(jax.random.key_data(jkey),
                                  jax.random.key_data(jax.random.key(7)))
    assert_same_state(ts, back)


def test_structure_mismatch_and_corrupt_files(tmp_path):
    js, ts, _, ttemplate = make_states("SIRState")
    path = str(tmp_path / "c.npz")
    TC.save(path, ts, prng.key(1), 2)
    with pytest.raises(ValueError, match="structure mismatch"):
        TC.load(path, TM.FloodState(seen=torch.zeros(1),
                                    frontier=torch.zeros(1)))
    raw = open(path, "rb").read()
    trunc = str(tmp_path / "trunc.npz")
    open(trunc, "wb").write(raw[: len(raw) // 2])
    with pytest.raises(TC.CheckpointCorrupt, match="corrupt checkpoint"):
        TC.load(trunc, ttemplate)
    # A bit flipped inside the stored leaf (npz is uncompressed): the
    # member's CRC catches it.
    leaf = ts.status.numpy().tobytes()
    at = raw.index(leaf) + len(leaf) // 2
    flipped = str(tmp_path / "flip.npz")
    open(flipped, "wb").write(raw[:at] + bytes([raw[at] ^ 1])
                              + raw[at + 1:])
    with pytest.raises(TC.CheckpointCorrupt, match="corrupt checkpoint"):
        TC.load(flipped, ttemplate)
    # The same flip in a well-formed archive: the digest catches it.
    with np.load(path) as data:
        payload = {k: np.array(data[k]) for k in data.files}
    payload["leaf_0"].view(np.uint8)[len(leaf) // 2] ^= 1
    np.savez(flipped, **payload)
    with pytest.raises(TC.CheckpointCorrupt, match="hash mismatch") as e:
        TC.load(flipped, ttemplate)
    assert e.value.expected != e.value.actual
    with pytest.raises(TC.CheckpointCorrupt, match="bookkeeping"):
        np.savez(str(tmp_path / "bare.npz"), leaf_0=np.zeros(3))
        TC.load(str(tmp_path / "bare.npz"), ttemplate)


def test_orbax_is_refused_by_name(tmp_path):
    # save_orbax/load_orbax write and read the port's own sharded format
    # (tests/test_torch_multihost_protocols.py); a directory without its
    # manifest, as JAX's orbax writes one, is refused by name, and a
    # state with no per-shard leaf names no ring to save.
    (tmp_path / "_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="manifest.json.*orbax"):
        TC.load_orbax(str(tmp_path), None)
    with pytest.raises(ValueError, match="no per-shard leaf"):
        TC.save_orbax(str(tmp_path), None, prng.key(0), 0)


@pytest.mark.parametrize("family", ["ws", "er", "ba"])
@pytest.mark.parametrize("kind", ["layouts", "weighted-churned"])
def test_graph_files_cross_both_ways(tmp_path, family, kind):
    jg, tg = build_jax(family, **ALL), build_port(family, **ALL)
    if kind != "layouts":
        jg, tg = jg.with_weights(latency), tg.with_weights(latency)
        jg, tg = churn((JT, JFa), jg), churn((TT, TFa), tg)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    JC.save_graph(jpath, jg)
    TC.save_graph(tpath, tg)
    want = graph_fields(jg)
    assert_same_fields(graph_fields(TC.load_graph(jpath, device="cpu")),
                       want)
    assert_same_fields(graph_fields(JC.load_graph(tpath)), want)


def test_grow_state_after_a_repad(tmp_path):
    # A flood checkpointed at capacity 4,096, resumed on the graph grown
    # to 8,192: zero-extended, then equal to the reference's resume.
    jg, tg = graphs()
    jp, tp = _flood(JM, method="hybrid"), _flood(TM, method="hybrid")
    js, ts = _run(jg, tg, jp, tp)
    path = str(tmp_path / "g.npz")
    TC.save(path, ts, prng.key(3), 3)
    jg2, tg2 = JG.grow(jg, 100), TG.grow(tg, 100)
    ttemplate = tp.init(tg2, prng.key(0))
    got, *_ = TC.load(path, ttemplate, grow=True)
    want, *_ = JC.load(path, jp.init(jg2, jax.random.key(0)), grow=True)
    assert_same_state(got, want)
    with pytest.raises(ValueError, match="not repad-growable"):
        TC.grow_state(ttemplate, ts)
    jout = JE.run_until_coverage_from(jg2, jp, want, jax.random.key(4),
                                      donate=False)[1]
    tout = TE.run_until_coverage_from(tg2, tp, got, prng.key(4))[1]
    assert tout == jout


def payload_fields(payload):
    return {k: v.numpy() for k, v in payload["topology"].items()}


def test_topology_state_and_node_payload(tmp_path):
    # A node checkpoint written by the reference (protocol, topology,
    # churn_count) loads in the port and re-applies onto the pristine
    # build; and the other way round.
    jg0, tg0 = graphs()
    dead = np.arange(100, 300)
    jg, tg = JFa.fail_nodes(jg0, dead), TFa.fail_nodes(tg0, dead)
    jp, tp = _flood(JM, method="hybrid"), _flood(TM, method="hybrid")
    js, ts = _run(jg, tg, jp, tp)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    JC.save(jpath, {"protocol": js, "topology": JC.topology_state(jg),
                    "churn_count": np.int64(4)}, jax.random.key(2), 3, 9)
    TC.save(tpath, {"protocol": ts, "topology": TC.topology_state(tg),
                    "churn_count": np.int64(4)}, prng.key(2), 3, 9)
    assert _digest(tpath) == _digest(jpath)
    payload, key, rnd, msgs = TC.load_node_payload(
        jpath, tg0, tp.init(tg0, prng.key(0)))
    assert (rnd, msgs, int(payload["churn_count"])) == (3, 9, 4)
    assert_same_state(payload["protocol"], js)
    # (The topology state holds no skew mask, in either package: the
    # restored skew table is the pristine build's.)
    restored = TC.apply_topology_state(tg0, payload["topology"])
    jrestored = JC.apply_topology_state(jg0, payload_fields(payload))
    assert_same_fields(graph_fields(restored), graph_fields(jrestored))
    assert_same_fields(graph_fields(dataclasses.replace(restored,
                                                        skew=tg.skew)),
                       graph_fields(tg))
    jpayload, *_ = JC.load_node_payload(tpath, jg0,
                                        jp.init(jg0, jax.random.key(0)))
    assert_same_fields(graph_fields(JC.apply_topology_state(
        jg0, jpayload["topology"])), graph_fields(jrestored))
    # The bare protocol state (the older format) loads with the graph's
    # topology as attached.
    bare = str(tmp_path / "bare.npz")
    JC.save(bare, js, jax.random.key(2), 3)
    payload, *_ = TC.load_node_payload(bare, tg, tp.init(tg, prng.key(0)))
    assert_same_state(payload["protocol"], js)
    with pytest.raises(ValueError, match="keys mismatch"):
        TC.apply_topology_state(build_port("ws"), TC.topology_state(tg))


def test_layout_cache_fingerprint_and_misses(tmp_path, monkeypatch):
    monkeypatch.setenv("P2P_LAYOUT_CACHE_DIR", str(tmp_path / "env"))
    assert layoutcache.default_cache_dir() == str(tmp_path / "env")
    monkeypatch.delenv("P2P_LAYOUT_CACHE_DIR")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert layoutcache.default_cache_dir() == str(
        tmp_path / "xdg" / "p2pnetwork_tpu_torch" / "layouts")
    a = layoutcache.fingerprint(params={"n": 1})
    assert a == layoutcache.fingerprint(params={"n": 1})
    assert a != layoutcache.fingerprint(params={"n": 2})
    script = tmp_path / "build.py"
    script.write_text("x = 1\n")
    b = layoutcache.fingerprint(params={"n": 1}, extra_sources=[script])
    script.write_text("x = 2\n")
    assert b != layoutcache.fingerprint(params={"n": 1},
                                        extra_sources=[script])
    reg = telemetry.Registry()
    prev = telemetry.set_default_registry(reg)
    try:
        calls, misses = [], []

        def build():
            calls.append(1)
            return build_port("er", **LAYOUTS)

        kw = dict(cache_dir=str(tmp_path / "c"), params={"n": 500},
                  device="cpu",
                  on_miss=lambda reason, path, err: misses.append(reason))
        g1, _, hit1 = layoutcache.cached_graph("er", build, **kw)
        g2, _, hit2 = layoutcache.cached_graph("er", build, **kw)
        assert (hit1, hit2, len(calls)) == (False, True, 1)
        assert_same_fields(graph_fields(g2), graph_fields(g1))
        path = layoutcache.entry_path("er", cache_dir=kw["cache_dir"],
                                      params={"n": 500})
        open(path, "wb").write(b"not a zip")
        layoutcache.cached_graph("er", build, **kw)
        layoutcache.cached_graph("er", build, enabled=False, **kw)
        assert misses == ["missing", "corrupt", "disabled"]
        assert [reg.value("layout_cache_miss_total", reason=r)
                for r in ("missing", "corrupt", "disabled")] == [1, 1, 1]
        assert layoutcache.clear(kw["cache_dir"]) == 1
        assert os.listdir(kw["cache_dir"]) == []
    finally:
        telemetry.set_default_registry(prev)
