"""The port's socket node subclasses (``crdt.py``, ``phi.py``,
``causal.py``, ``snapshot.py``, ``sync.py``, ``termination.py``,
``securenode.py``, ``coordnode.py``) and ``utils/chash.py`` against the
reference's own cases, and against reference nodes over real sockets.

The reference's test modules ``tests/test_{crdt,phi,causal,snapshot,
sync,termination,securenode,coordnode,chash}.py`` are loaded here with
their imports pointed at the port (``p2pnetwork_tpu`` ->
``p2pnetwork_tpu_torch``), and every case they hold is collected under a
``Port`` prefix: the same cases, run against the port's classes, with
nothing copied. One case is left out and replaced:
``TestLiveCoordinates::test_ping_pong_and_convergence`` bounds a
predicted loopback RTT and waits on a wall-clock deadline, which is
flaky under load in the reference too; its port counterpart below checks
the same exchange without a wall-time bound.

Then the wire-level protocols are driven across the two packages, one
port node and one reference node on loopback: a CRDT merge, a Merkle
anti-entropy session, signed envelopes (Ed25519, and the shared-key
HMAC fallback the port keeps for an install without ``cryptography``)
and causal delivery order. ``HashRing`` places keys exactly as the
reference's does.
"""

import random
import re
import types
from pathlib import Path

import numpy as np
import pytest

import p2pnetwork_tpu as ref
import p2pnetwork_tpu.securenode as ref_secure
import p2pnetwork_tpu_torch as port
import p2pnetwork_tpu_torch.securenode as port_secure
from p2pnetwork_tpu.utils import chash as ref_chash
from p2pnetwork_tpu_torch.utils import chash as port_chash
from tests.helpers import stop_all, wait_until

HOST = "127.0.0.1"
ROOT = Path(__file__).resolve().parent
#: The reference's test modules whose cases run against the port.
MODULES = ("crdt", "phi", "causal", "snapshot", "sync", "termination",
           "securenode", "coordnode", "chash")
#: Cases left out (a wall-clock bound), each replaced below.
REPLACED = {("coordnode", "TestLiveCoordinates",
             "test_ping_pong_and_convergence")}


def _port_copy(name: str) -> types.ModuleType:
    """The reference's ``tests/test_<name>.py`` with its imports pointed
    at the port, as a module of its own."""
    path = ROOT / f"test_{name}.py"
    src = re.sub(r"\bp2pnetwork_tpu\b", "p2pnetwork_tpu_torch",
                 path.read_text())
    src = src.replace("from .helpers import", "from tests.helpers import")
    mod = types.ModuleType(f"tests.port_test_{name}")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def _collect():
    """Every case of the reference modules, renamed under ``Port``:
    classes ``TestX`` -> ``TestPort<Module>X``, functions ``test_x`` ->
    ``test_port_<module>_x``; the modules' fixtures keep their names."""
    out = {}
    for name in MODULES:
        mod = _port_copy(name)
        for attr, obj in vars(mod).items():
            if getattr(obj, "_pytestfixturefunction", None) is not None \
                    or type(obj).__name__ == "FixtureFunctionDefinition":
                out[attr] = obj
            elif attr.startswith("Test") and isinstance(obj, type):
                gone = [t for (m, c, t) in REPLACED
                        if (m, c) == (name, attr)]
                body = {k: v for k, v in vars(obj).items()
                        if k not in gone and k not in ("__dict__",
                                                       "__weakref__")}
                out[f"TestPort{name.title()}{attr[4:]}"] = type(
                    f"TestPort{name.title()}{attr[4:]}", obj.__bases__, body)
            elif attr.startswith("test_") and callable(obj):
                out[f"test_port_{name}_{attr[5:]}"] = obj
    return out


globals().update(_collect())


# ---------------------------------------------- the replaced live case


def test_port_coordnode_live_ping_pong():
    """``test_ping_pong_and_convergence`` without its wall-time bounds:
    ticks produce RTT samples on both sides, the samples move the
    coordinates out of the init blob, and the mutual prediction is a
    finite non-negative time."""
    a = port.CoordinateNode(HOST, 0, id="A")
    b = port.CoordinateNode(HOST, 0, id="B")
    nodes = [a, b]
    try:
        for n in nodes:
            n.start()
        assert a.connect_with_node(HOST, b.port)
        assert wait_until(lambda: len(a.all_nodes) == 1
                          and len(b.all_nodes) == 1, timeout=60.0)
        for _ in range(60):
            a.tick()
            b.tick()
        assert wait_until(lambda: a.samples >= 40 and b.samples >= 40,
                          timeout=120.0), (a.samples, b.samples)
        assert any(abs(x) > 1e-5 for x in a.coord + b.coord)
        bc, bh, _ = b.coordinate()
        assert np.isfinite(a.predicted_rtt(bc, bh))
        assert a.predicted_rtt(bc, bh) >= 0.0
    finally:
        stop_all(nodes)


# ------------------------------------------- across the two packages


def _connected(a, b):
    for n in (a, b):
        n.start()
    assert a.connect_with_node(HOST, b.port)
    assert wait_until(lambda: len(a.all_nodes) == 1
                      and len(b.all_nodes) == 1)


@pytest.mark.parametrize("port_first", [True, False],
                         ids=["port-connects", "reference-connects"])
def test_crdt_merge_across_packages(port_first):
    p = port.CRDTNode(HOST, 0, id="P")
    r = ref.CRDTNode(HOST, 0, id="R")
    try:
        _connected(*((p, r) if port_first else (r, p)))
        p.mutate("hits", "pncounter", lambda c: c.increment("P", 5))
        r.mutate("hits", "pncounter", lambda c: c.increment("R", 9))
        p.mutate("room", "orset", lambda s: s.add("P", "alice"))
        r.mutate("room", "orset", lambda s: s.add("R", "bob"))
        r.mutate("cfg", "lww", lambda g: g.set("R", "v1", ts=1.0))
        p.mutate("cfg", "lww", lambda g: g.set("P", "v2", ts=2.0))
        assert wait_until(lambda: all(
            n.counter("hits").value == 14
            and n.set_("room").elements() == {"alice", "bob"}
            and n.register("cfg").value == "v2" for n in (p, r)),
            timeout=20.0)
        p.mutate("room", "orset", lambda s: s.remove("alice"))
        assert wait_until(lambda: r.set_("room").elements() == {"bob"},
                          timeout=20.0)
        assert p.counter("hits").to_dict() == r.counter("hits").to_dict()
        assert p.set_("room").to_dict() == r.set_("room").to_dict()
    finally:
        stop_all([p, r])


def test_sync_anti_entropy_across_packages():
    p = port.SyncNode(HOST, 0, id="P")
    r = ref.SyncNode(HOST, 0, id="R")
    rng = random.Random(4)
    try:
        _connected(p, r)
        shared = [(f"s{i}", f"v{i}") for i in range(60)]
        for node, tag in ((p, "p"), (r, "r")):
            for k, v in shared:
                node.put(k, v)
            for i in range(30):
                node.put(f"{tag}{i}", f"{tag}-{rng.randrange(1000)}")
        # One conflicting key, resolved by the convergence rule.
        p.put("clash", "from-port")
        r.put("clash", "from-reference")
        assert wait_until(lambda: len(p.store) == 91 and len(r.store) == 91)
        p.sync_with(p.all_nodes[0])
        assert p.wait_synced("R", timeout=20.0)
        assert r.wait_synced("P", timeout=20.0)
        assert p.store == r.store and len(p.store) == 121
        # And the other direction: the reference initiates.
        r.put("late", "x")
        assert wait_until(lambda: r.get("late") == "x")
        r.sync_with(r.all_nodes[0])
        assert r.wait_synced("P", timeout=20.0)
        assert p.wait_synced("R", timeout=20.0)
        assert p.store == r.store
    finally:
        stop_all([p, r])


@pytest.mark.parametrize("scheme", ["ed25519", "hmac"])
def test_signed_envelopes_across_packages(scheme, monkeypatch):
    kw = {}
    if scheme == "hmac":
        for mod in (port_secure, ref_secure):
            monkeypatch.setattr(mod, "_HAVE_ED25519", False)
        kw = {"network_key": b"shared-secret"}
    got = {"P": [], "R": []}

    def recorder(who):
        def cb(event, node, other, data):
            if event in ("secure_message", "secure_message_invalid"):
                got[who].append((event, data))
        return cb

    p = port_secure.SecureNode(HOST, 0, id="P", callback=recorder("P"), **kw)
    r = ref_secure.SecureNode(HOST, 0, id="R", callback=recorder("R"), **kw)
    try:
        assert p.scheme == r.scheme
        _connected(p, r)
        p.send_to_nodes_signed({"tx": "p->r", "amount": 5})
        r.send_to_nodes_signed({"tx": "r->p", "amount": 7})
        assert wait_until(lambda: got["P"] and got["R"], timeout=20.0)
        assert got["R"] == [("secure_message", {"tx": "p->r", "amount": 5})]
        assert got["P"] == [("secure_message", {"tx": "r->p", "amount": 7})]
        # Each side verifies the other's envelopes, and refuses a
        # tampered one by the same reason.
        env = p.make_envelope({"amount": 10})
        assert r.check_envelope(env) is None
        env["payload"]["amount"] = 1000
        assert r.check_envelope(env) == p.check_envelope(env) \
            == "hash mismatch"
        assert p.message_count_rerr == r.message_count_rerr == 0
    finally:
        stop_all([p, r])


class _PortRecorder(port.CausalNode):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.delivered = []

    def causal_message(self, node, data):
        self.delivered.append(data)


class _RefRecorder(ref.CausalNode):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.delivered = []

    def causal_message(self, node, data):
        self.delivered.append(data)


def test_causal_order_across_packages():
    """A reacting chain over a triangle of two reference nodes and one
    port node: each of B's reactions causally follows the message of A's
    it answers, so every node delivers each ``a-i`` before ``b-re-a-i``,
    whichever package it runs."""
    a = _RefRecorder(HOST, 0, id="A")
    b = _PortRecorder(HOST, 0, id="B")
    c = _RefRecorder(HOST, 0, id="C")
    nodes = [a, b, c]
    rounds = 10
    try:
        for n in nodes:
            n.start()
        assert a.connect_with_node(HOST, b.port)
        assert b.connect_with_node(HOST, c.port)
        assert c.connect_with_node(HOST, a.port)
        assert wait_until(lambda: all(len(n.all_nodes) == 2 for n in nodes))
        orig = b.causal_message

        def reacting(node, data):
            orig(node, data)
            if isinstance(data, str) and data.startswith("a-"):
                b.send_causal(f"b-re-{data}")

        b.causal_message = reacting
        for i in range(rounds):
            a.send_causal(f"a-{i}")
        assert wait_until(lambda: len(c.delivered) >= 2 * rounds
                          and len(a.delivered) >= rounds, timeout=20.0)
        for n in (a, c):
            seq = n.delivered
            for i in range(rounds):
                reply = f"b-re-a-{i}"
                if f"a-{i}" in seq and reply in seq:
                    assert seq.index(f"a-{i}") < seq.index(reply)
            # Per-sender order holds.
            mine = [x for x in seq if x.startswith("a-")]
            assert mine == sorted(mine, key=lambda s: int(s[2:]))
        assert [x for x in b.delivered if x.startswith("a-")] \
            == [f"a-{i}" for i in range(rounds)]
        assert all(n.undelivered() == 0 for n in nodes)
    finally:
        stop_all(nodes)


# ------------------------------------------------------------- HashRing


@pytest.mark.parametrize("vnodes", [1, 64, 256])
def test_hash_ring_places_keys_as_the_reference(vnodes):
    peers = [f"peer-{i}" for i in range(12)]
    pr = port_chash.HashRing(peers, vnodes=vnodes)
    rr = ref_chash.HashRing(peers, vnodes=vnodes)
    keys = [f"key-{i}" for i in range(2000)] + [b"raw", 7, "", "é"]
    for key in keys:
        assert pr.owner(key) == rr.owner(key)
        assert pr.owners(key, 3) == rr.owners(key, 3)
    np.testing.assert_array_equal(port_chash.hash_keys(keys[:2000]),
                                  ref_chash.hash_keys(keys[:2000]))
    pos = np.random.default_rng(vnodes).integers(
        0, 2**64 - 1, size=4096, dtype=np.uint64)
    np.testing.assert_array_equal(pr.owner_indices_at(pos),
                                  rr.owner_indices_at(pos))
    assert pr.load_fractions() == rr.load_fractions()
    grown = (pr.add("peer-new"), rr.add("peer-new"))
    assert port_chash.moved_fraction(pr, grown[0]) \
        == ref_chash.moved_fraction(rr, grown[1])
