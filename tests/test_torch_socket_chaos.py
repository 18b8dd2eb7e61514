"""The port's socket chaos (``chaos/plane.py``, ``chaos/streams.py``)
against the JAX package's.

- **Decisions**: for the same seed and the same frame sequence, the port's
  ``ChaosPlane`` draws the reference's per-stream schedule, and its
  ``ChaosWriter`` drops, duplicates and corrupts the very frames the
  reference's does, writing the same bytes and the same fault log. The
  control operations (kills, cuts, partitions, preemption) give the same
  link verdicts, logs and counters.
- **Live**: a seeded partition of port nodes over localhost severs the
  crossing link, its heal lets the reconnecting node back in, and the
  message sent after the heal is delivered.

Every socket test waits on its own deadline (``tests/helpers.wait_until``)
and stops its nodes in ``finally``.
"""

import random

import pytest

from p2pnetwork_tpu import telemetry as JT  # noqa: E402
from p2pnetwork_tpu.chaos import ChaosPlane as JPlane  # noqa: E402
from p2pnetwork_tpu.chaos import streams as JS  # noqa: E402
from p2pnetwork_tpu_torch import chaos as TCH  # noqa: E402
from p2pnetwork_tpu_torch import telemetry as TT  # noqa: E402
from p2pnetwork_tpu_torch.chaos import streams as TS  # noqa: E402
from p2pnetwork_tpu_torch.config import NodeConfig  # noqa: E402
from p2pnetwork_tpu_torch.node import Node  # noqa: E402
from tests.helpers import EventRecorder, stop_all, wait_until  # noqa: E402

HOST = "127.0.0.1"
DEADLINE = 10.0
FAST = dict(reconnect_interval=0.05, reconnect_backoff_base=0.1,
            reconnect_backoff_max=0.5)


def _planes(seed):
    return (TCH.ChaosPlane(seed=seed, registry=TT.Registry()),
            JPlane(seed=seed, registry=JT.Registry()))


class _Sink:
    """A StreamWriter stand-in that keeps what was written."""

    def __init__(self):
        self.chunks = []

    def write(self, data):
        self.chunks.append(bytes(data))


def _frames(n, seed=0):
    rng = random.Random(seed)
    return [bytes(rng.randrange(5, 256) for _ in range(rng.randrange(1, 40)))
            + b"\x04" for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1234, 2**40 + 3])
def test_fault_schedules_equal_reference(seed):
    port, ref = _planes(seed)
    for src, dst in (("A", "B"), ("B", "A"), ("n-7", "n-12")):
        assert port.fault_schedule(src, dst, 64) == ref.fault_schedule(
            src, dst, 64)
        for direction in ("send", "recv"):
            assert port._stream_rng(src, dst, direction).random() == \
                ref._stream_rng(src, dst, direction).random()


@pytest.mark.parametrize("framing", ["eot", "length"])
@pytest.mark.parametrize("probs", [(0.2, 0.2, 0.3), (0.0, 0.5, 0.0),
                                   (0.0, 0.0, 1.0)],
                         ids=["mixed", "duplicate", "corrupt-all"])
def test_writer_decisions_equal_reference(probs, framing):
    port, ref = _planes(99)
    outs = []
    for plane, mod in ((port, TS), (ref, JS)):
        plane.drop_frames(probs[0])
        plane.duplicate_frames(probs[1])
        plane.corrupt_frames(probs[2])
        sink = _Sink()
        writer = mod.ChaosWriter(plane, "A", "B", sink, framing=framing)
        for frame in _frames(200):
            writer.write(frame)
        outs.append((sink.chunks, plane.fault_log()))
    assert outs[0] == outs[1]
    assert len(outs[0][1]) > 3  # faults were applied
    counts = {k: port._m_injected.labels(k).value
              for k in ("drop", "duplicate", "corrupt")}
    assert counts == {k: ref._m_injected.labels(k).value
                      for k in ("drop", "duplicate", "corrupt")}


def test_receive_delays_equal_reference():
    port, ref = _planes(5)
    for plane in (port, ref):
        plane.add_latency(0.01, jitter=0.02)
        plane.throttle(1e6)
    rngs = [p._stream_rng("A", "B", "recv") for p in (port, ref)]
    assert [port.recv_delay(n, rngs[0]) for n in range(0, 4000, 97)] == [
        ref.recv_delay(n, rngs[1]) for n in range(0, 4000, 97)]


def test_control_operations_equal_reference():
    port, ref = _planes(3)
    pairs = [(a, b) for a in "ABCDE" for b in "ABCDE" if a != b]
    verdicts = []
    for plane in (port, ref):
        seen = []
        plane.kill_nodes(["A"])
        seen.append([plane.link_ok(a, b) for a, b in pairs])
        plane.revive_nodes(["A"])
        plane.cut_links([("B", "C")])
        plane.partition([["A", "B"], ["C", "D"]])
        seen.append([plane.link_ok(a, b) for a, b in pairs])
        plane.preempt(["E"])
        seen.append([plane.link_ok(a, b) for a, b in pairs])
        seen.append(plane.revive_preempted())
        plane.heal_partition()
        plane.heal_links([("B", "C")])
        seen.append([plane.link_ok(a, b) for a, b in pairs])
        seen.append(plane.fault_log())
        seen.append({k: plane._m_injected.labels(k).value for k in (
            "node", "node_revive", "link", "link_heal", "partition",
            "partition_heal", "preempt")})
        verdicts.append(seen)
    assert verdicts[0] == verdicts[1]
    assert all(verdicts[0][-2])  # everything healed


def test_chaos_package_exports():
    assert {"ChaosPlane", "ChaosReader", "ChaosWriter"} <= set(TCH.__all__)
    assert TCH.ChaosReader is TS.ChaosReader
    assert TCH.ChaosWriter is TS.ChaosWriter


def test_live_partition_and_heal():
    reg = TT.Registry()
    plane = TCH.ChaosPlane(seed=7, registry=reg)
    recs = {name: EventRecorder() for name in "AB"}
    nodes = {name: Node(HOST, 0, id=name, callback=recs[name],
                        config=NodeConfig(**FAST)) for name in "AB"}
    plane.attach(*nodes.values())
    for n in nodes.values():
        n.start()
    a, b = nodes["A"], nodes["B"]
    try:
        assert a.connect_with_node(HOST, b.port, reconnect=True)
        assert wait_until(lambda: len(b.nodes_inbound) == 1, DEADLINE)
        plane.partition([["A"], ["B"]])
        assert wait_until(lambda: not a.nodes_outbound, DEADLINE)
        # Nothing crosses while partitioned.
        a.send_to_nodes({"during": True})
        plane.heal_partition()
        assert wait_until(
            lambda: any(c.id == "B" for c in a.nodes_outbound), DEADLINE)
        a.send_to_nodes({"after": "heal"})
        assert wait_until(lambda: {"after": "heal"} in recs["B"].messages(),
                          DEADLINE)
        assert {"during": True} not in recs["B"].messages()
        assert reg.value("chaos_injected_failures_total",
                         kind="partition") == 1
        assert reg.value("chaos_injected_failures_total",
                         kind="partition_heal") == 1
        assert reg.value("chaos_active_faults", kind="partition_groups") == 0
        assert [e[0] for e in plane.fault_log()] == ["partition",
                                                     "partition_heal"]
    finally:
        stop_all(list(nodes.values()))
