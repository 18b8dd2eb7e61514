"""The port's sockets backend (``config.py``, ``utils/ids.py``, ``wire.py``,
``nodeconnection.py``, ``node.py``): its own copy of the JAX package's,
held against it.

- **Wire bytes**: every frame a port node can put on the wire is the
  reference's byte for byte (str, dict, bytes payloads; no compression,
  zlib, bzip2, lzma; both framings), and each package decodes the other's.
- **Live sockets**: a port ``Node`` and a reference ``Node`` connect both
  ways over localhost and exchange messages; each sees the event names and
  counters the same pair of reference nodes sees.

Every socket test waits on its own deadline of a few seconds
(``tests/helpers.wait_until``) and stops its nodes in ``finally``.
"""

import dataclasses
import random
import socket

import pytest

from p2pnetwork_tpu import config as JC  # noqa: E402
from p2pnetwork_tpu import node as JN  # noqa: E402
from p2pnetwork_tpu import wire as JW  # noqa: E402
from p2pnetwork_tpu.utils import ids as JIDS  # noqa: E402
from p2pnetwork_tpu_torch import config as TC  # noqa: E402
from p2pnetwork_tpu_torch import node as TN  # noqa: E402
from p2pnetwork_tpu_torch import telemetry  # noqa: E402
from p2pnetwork_tpu_torch import wire as TW  # noqa: E402
from p2pnetwork_tpu_torch.utils import generate_id  # noqa: E402
from tests.helpers import EventRecorder, stop_all, wait_until  # noqa: E402

HOST = "127.0.0.1"
PAYLOADS = {"str": "héllo, peer", "dict": {"k": [1, 2.5, "v"], "n": None},
            "bytes": b"\x00\x01raw\xff"}
COMPRESSIONS = ("none", "zlib", "bzip2", "lzma")
DEADLINE = 5.0


@pytest.mark.parametrize("framing", ["eot", "length"])
@pytest.mark.parametrize("compression", COMPRESSIONS)
@pytest.mark.parametrize("kind", sorted(PAYLOADS))
def test_frames_are_the_references_bytes(kind, compression, framing):
    data = PAYLOADS[kind]
    got = TW.encode_frame(data, compression=compression, framing=framing)
    want = JW.encode_frame(data, compression=compression, framing=framing)
    assert got == want
    # Each package decodes the other's frame to the payload.
    for dec_mod, frame in ((TW, want), (JW, got)):
        dec = dec_mod.make_decoder(framing)
        frames = list(dec.feed(frame))
        assert len(frames) == 1
        parse = (dec_mod.parse_length_body if framing == "length"
                 else dec_mod.parse_packet)
        assert parse(frames[0]) == data


@pytest.mark.parametrize("algo", COMPRESSIONS[1:])
def test_compress_and_decompress_cross(algo):
    raw = TW.encode_payload({"x": list(range(50))})
    assert TW.compress(raw, algo) == JW.compress(raw, algo)
    assert TW.decompress(JW.compress(raw, algo)) == raw
    assert JW.decompress(TW.compress(raw, algo)) == raw


def test_config_and_ids_are_the_references():
    assert [f.name for f in dataclasses.fields(TC.NodeConfig)] == [
        f.name for f in dataclasses.fields(JC.NodeConfig)]
    assert dataclasses.asdict(TC.NodeConfig()) == dataclasses.asdict(
        JC.NodeConfig())
    assert generate_id("h", 1, random.Random(7)) == JIDS.generate_id(
        "h", 1, random.Random(7))


def _pair(port_side: str, recs, registry=None):
    """Start nodes "A" (dialer) and "B" (listener); ``port_side`` says
    which of them is the port's (``"A"``, ``"B"``, ``"both"`` or
    ``"none"``)."""
    nodes = []
    for name, rec in zip("AB", recs):
        cls = TN.Node if port_side in (name, "both") else JN.Node
        kw = {"registry": registry} if cls is TN.Node and registry else {}
        node = cls(HOST, 0, id=name, callback=rec, **kw)
        node.start()
        nodes.append(node)
    return nodes


def _exchange(port_side: str, registry=None):
    """A dials B, each sends the other one dict and one str; returns the
    events each saw (up to B's stop), the counters, and B's view of A."""
    recs = [EventRecorder(), EventRecorder()]
    a, b = _pair(port_side, recs, registry)
    try:
        assert a.connect_with_node(HOST, b.port)
        assert wait_until(lambda: len(b.nodes_inbound) == 1, DEADLINE)
        a.send_to_nodes({"from": "A"})
        assert wait_until(lambda: recs[1].count("node_message") == 1,
                          DEADLINE)
        b.send_to_nodes("from B", compression="zlib")
        assert wait_until(lambda: recs[0].count("node_message") == 1,
                          DEADLINE)
        counters = [(n.message_count_send, n.message_count_recv,
                     n.message_count_rerr) for n in (a, b)]
        peers = ([c.id for c in a.nodes_outbound],
                 [c.id for c in b.nodes_inbound])
        events = [list(r.events) for r in recs]
    finally:
        stop_all([a, b])
    return events, counters, peers, recs


@pytest.mark.parametrize("port_side", ["A", "B", "both"],
                         ids=["port-dials", "port-listens", "port-only"])
def test_live_exchange_matches_reference_pair(port_side):
    want, want_counters, want_peers, want_recs = _exchange("none")
    got, counters, peers, recs = _exchange(port_side)
    assert got == want
    assert counters == want_counters == [(1, 1, 0), (1, 1, 0)]
    assert peers == want_peers == (["B"], ["A"])
    assert got[0] == [("outbound_node_connected", "B", {}),
                      ("node_message", "B", "from B")]
    assert got[1] == [("inbound_node_connected", "A", {}),
                      ("node_message", "A", {"from": "A"})]
    # After the stop, the same disconnect and stop events on both sides.
    for r, w in zip(recs, want_recs):
        assert sorted(set(r.names())) == sorted(set(w.names()))


def test_port_node_counts_into_the_ports_registry():
    reg = telemetry.Registry()
    _exchange("both", registry=reg)
    for node in "AB":
        assert reg.value("p2p_messages_sent_total", node=node) == 1
        assert reg.value("p2p_messages_received_total", node=node) == 1
        assert reg.value("p2p_recv_errors_total", node=node) == 0
    assert reg.value("p2p_events_total", node="A",
                     event="outbound_node_connected") == 1
    assert reg.value("p2p_events_total", node="B",
                     event="inbound_node_connected") == 1


def test_connect_to_a_dead_port_fails_like_the_reference():
    recs = [EventRecorder(), EventRecorder()]
    nodes = [TN.Node(HOST, 0, id="T", callback=recs[0]),
             JN.Node(HOST, 0, id="J", callback=recs[1])]
    for n in nodes:
        n.start()
    try:
        # A port that was bound and closed again: nothing listens there.
        with socket.socket() as probe:
            probe.bind((HOST, 0))
            dead = probe.getsockname()[1]
        for n in nodes:
            assert n.connect_with_node(HOST, dead) is False
        assert [r.names() for r in recs] == [
            ["outbound_node_connection_error"]] * 2
    finally:
        stop_all(nodes)
