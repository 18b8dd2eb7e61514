"""Live Vivaldi coordinates on the sockets backend — the two pillars met.

The sim backend learns latency embeddings over a WEIGHTED GRAPH
(models/vivaldi.py); this module runs the same spring rule over REAL
measured round-trips: each :class:`CoordinateNode` periodically pings a
random peer, timestamps the pong, and springs its coordinate toward the
observation — so a deployment gets "which replica is closest to me?"
from live traffic, the way Serf/Consul run their network tomography.
The reference offers nothing here (no RTT measurement anywhere; its
keep-alive is the 10-second socket timeout [ref:
p2pnetwork/nodeconnection.py:47]).

Wire protocol (dict payloads over the ordinary frame format, invisible
to application traffic like every other protocol layer in this
package):

- ``{"_viv_ping": seq}`` — answered as ``{"_viv_pong": seq}`` plus the
  RESPONDER's current coordinate/height/error, so one round-trip yields
  both the RTT sample and the remote state Vivaldi needs;
- the pinger timestamps sends in a local table keyed by ``seq`` and
  computes ``rtt`` on the pong from its own monotonic clock (no clock
  sync, no timestamps on the wire), then applies the height-vector
  update (models/vivaldi.py's rule, scalar form). Outstanding entries
  for pongs that never come back are pruned by age on later ticks.

Pings ride :meth:`tick`, called by the application or a timer of its
choosing (the examples use ``loop.call_later`` chains; tests drive it
directly for determinism). Every update runs on the node's event loop;
``coordinate()`` snapshots are safe from any thread.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Optional, Tuple

from p2pnetwork_tpu_torch.node import Node
from p2pnetwork_tpu_torch.nodeconnection import NodeConnection

PING_KEY = "_viv_ping"
PONG_KEY = "_viv_pong"


class CoordinateNode(Node):
    """A :class:`Node` maintaining a live Vivaldi coordinate.

    ``dim``/``cc``/``ce_gain``/``height_min`` mirror
    :class:`~p2pnetwork_tpu_torch.models.vivaldi.Vivaldi`; ``rtt_floor``
    clamps measured round-trips (loopback measures microseconds — the
    floor keeps the relative-error arithmetic meaningful)."""

    def __init__(self, *args, dim: int = 2, cc: float = 0.25,
                 ce_gain: float = 0.25, height_min: float = 1e-6,
                 rtt_floor: float = 1e-6, ping_expiry: float = 30.0,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.dim = dim
        self.cc = cc
        self.ce_gain = ce_gain
        self.height_min = height_min
        self.rtt_floor = rtt_floor
        self.ping_expiry = ping_expiry
        rng = random.Random(self.id)
        self._rng = rng
        # Tiny seeded spread — same rationale as the sim model's init.
        self.coord: List[float] = [1e-6 * rng.uniform(-1, 1)
                                   for _ in range(dim)]
        self.height: float = height_min
        self.ce: float = 1.0
        self.samples: int = 0
        self._seq = 0
        self._inflight: Dict[int, float] = {}  # seq -> monotonic send time

    # ------------------------------------------------------------ app API

    def coordinate(self) -> Tuple[List[float], float, float]:
        """Snapshot ``(coord, height, error_estimate)``."""
        return list(self.coord), self.height, self.ce

    def predicted_rtt(self, coord: List[float], height: float) -> float:
        """Predicted RTT to a peer advertising ``(coord, height)``."""
        d = sum((a - b) ** 2 for a, b in zip(self.coord, coord)) ** 0.5
        return d + self.height + height

    def tick(self) -> None:
        """Ping one random peer (no-op with no peers). Thread-safe; call
        from a timer at whatever cadence suits the deployment."""
        loop = self._loop
        if loop is None or loop.is_closed():
            raise RuntimeError("node is not running — call start() first")

        def _do():
            now = time.monotonic()
            # Prune pings whose pong never came back (dead peers): the
            # table would otherwise grow for the node's lifetime.
            if self._inflight:
                stale = [s for s, t in self._inflight.items()
                         if now - t > self.ping_expiry]
                for s in stale:
                    del self._inflight[s]
            peers = self.all_nodes
            if not peers:
                return
            peer = self._rng.choice(peers)
            self._seq += 1
            self._inflight[self._seq] = now
            self.send_to_node(peer, {PING_KEY: self._seq})

        loop.call_soon_threadsafe(_do)

    def coordinate_updated(self, rtt: float) -> None:
        """A sample was absorbed (override / observe; default logs)."""
        self.debug_print(f"coordinate_updated: rtt={rtt:.6f} ce={self.ce:.3f}")

    # ------------------------------------------------------ spring update

    def _absorb(self, rtt: float, r_coord: List[float], r_height: float,
                r_ce: float) -> None:
        if len(r_coord) != self.dim:
            # A peer running a different dimensionality (or a malformed
            # pong) — zip would silently TRUNCATE our coordinate to the
            # shorter length, permanently. Drop the sample instead.
            self.debug_print(
                f"coordinate sample dropped: peer dim {len(r_coord)} != "
                f"ours {self.dim}")
            return
        rtt = max(rtt, self.rtt_floor)
        dvec = [a - b for a, b in zip(self.coord, r_coord)]
        dist = max(sum(d * d for d in dvec) ** 0.5, 1e-12)
        pred = dist + self.height + r_height
        err = pred - rtt
        w = self.ce / max(self.ce + r_ce, 1e-12)
        rel_err = abs(err) / rtt
        delta = self.cc * w
        self.coord = [x - delta * err * (d / dist)
                      for x, d in zip(self.coord, dvec)]
        self.height = max(self.height - delta * err * (self.height / pred),
                          self.height_min)
        self.ce = min(max(rel_err * (self.ce_gain * w)
                          + self.ce * (1.0 - self.ce_gain * w), 0.0), 1.0)
        self.samples += 1
        self.coordinate_updated(rtt)

    # ------------------------------------------------------ interception

    def node_message(self, node: NodeConnection, data) -> None:
        if isinstance(data, dict) and PING_KEY in data:
            self.send_to_node(node, {
                PONG_KEY: data[PING_KEY],
                "coord": list(self.coord), "height": self.height,
                "ce": self.ce,
            })
            return
        if isinstance(data, dict) and PONG_KEY in data:
            sent = self._inflight.pop(data[PONG_KEY], None)
            if sent is not None:
                self._absorb(time.monotonic() - sent,
                             list(data.get("coord") or [0.0] * self.dim),
                             float(data.get("height") or 0.0),
                             float(data.get("ce") or 1.0))
            return
        super().node_message(node, data)
