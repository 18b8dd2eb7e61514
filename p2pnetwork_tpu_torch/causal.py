"""Causal broadcast over the sockets backend — vector clocks, batched none.

The reference delivers messages in raw arrival order [ref:
p2pnetwork/nodeconnection.py:207-218 — one callback per frame as the
bytes land]; two broadcasts related by happened-before (B read A's
message, then reacted) can reach a third peer reversed, and every
protocol its users build on ``node_message`` inherits that hazard
silently. The classic repair is Birman–Schiper–Stephenson causal
broadcast: stamp each broadcast with the sender's vector clock, and
hold back any received message until every message it causally depends
on has been delivered. Its transport preconditions — FIFO per-peer
channels, a stable sender id — are exactly what the per-connection TCP
stream and the id handshake already give.

:class:`CausalNode` adds:

- :meth:`send_causal`: broadcast with a vector-clock stamp (runs on the
  node's event loop; safe from any thread);
- :meth:`causal_message`: the delivery hook — invoked in CAUSAL order,
  which is the whole point; also dispatched to the ``callback`` under
  the ``"causal_message"`` event name;
- plain (unstamped) traffic is untouched: it flows through
  ``node_message``'s usual path, so ``CausalNode`` interoperates with
  ordinary peers — causal ordering applies among the peers that speak
  it.

Delivery rule for an envelope from sender ``j`` carrying clock ``W``:
deliver when ``W[j] == vc[j] + 1`` (the next message from ``j``) and
``W[k] <= vc[k]`` for every other ``k`` (all its dependencies are in);
otherwise buffer. Each delivery merges clocks and re-scans the buffer,
so a single arrival can release a whole chain.

Honest limits (the algorithm's, not the implementation's): causal order
is bought with blocking — if a sender crashes after some peers received
its message and others did not, messages causally after it stay
buffered on the peers that missed it (inspect :meth:`undelivered`).
Full resilience needs a reliable-broadcast layer underneath (see
models/bracha.py for the Byzantine-grade version of that idea, on the
sim backend).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from p2pnetwork_tpu_torch.node import Node
from p2pnetwork_tpu_torch.nodeconnection import NodeConnection

#: Envelope keys. A dict payload carrying both is consumed as a causal
#: envelope and never reaches the plain node_message path.
VC_KEY = "_vc"
VC_FROM_KEY = "_vc_from"


def _le_all(w: Dict[str, int], vc: Dict[str, int], skip: str) -> bool:
    return all(c <= vc.get(k, 0) for k, c in w.items() if k != skip)


class CausalNode(Node):
    """A :class:`Node` whose stamped broadcasts are delivered causally."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # Both mutated only on the event loop (send_causal posts there).
        self.vc: Dict[str, int] = {}
        self._held: List[Tuple[str, Dict[str, int], Any, NodeConnection]] = []

    # ------------------------------------------------------------ app API

    def send_causal(self, data, compression: str = "none") -> None:
        """Broadcast ``data`` to every peer with a causal stamp.

        Thread-safe: the clock tick and the sends run as one event-loop
        callback, so concurrent callers serialize and every stamp is
        unique and ordered."""
        loop = self._loop
        if loop is None or loop.is_closed():
            raise RuntimeError("node is not running — call start() first")

        def _do():
            self.vc[self.id] = self.vc.get(self.id, 0) + 1
            envelope = {VC_KEY: dict(self.vc), VC_FROM_KEY: self.id,
                        "payload": data}
            self.send_to_nodes(envelope, compression=compression)
            # Standard self-delivery: the sender sees its own message in
            # the causal stream too (node=None marks an own message).
            self.causal_message(None, data)

        loop.call_soon_threadsafe(_do)

    def causal_message(self, node: NodeConnection, data) -> None:
        """A causally-ordered delivery. Override me. ``node`` is the
        connection the envelope arrived on (None for this node's own
        broadcasts, self-delivered at send time); the ORIGINATOR id is
        in the clock you just merged."""
        self.debug_print(f"causal_message: {data!r}")
        self._dispatch("causal_message", node, data)

    def undelivered(self) -> int:
        """Envelopes held back waiting on causal dependencies — nonzero
        steady-state means a dependency was lost (crashed sender)."""
        return len(self._held)

    # ---------------------------------------------------------- delivery

    def _deliverable(self, sender: str, w: Dict[str, int]) -> bool:
        return (w.get(sender, 0) == self.vc.get(sender, 0) + 1
                and _le_all(w, self.vc, skip=sender))

    def _deliver(self, sender: str, w: Dict[str, int], payload,
                 conn: NodeConnection) -> None:
        for k, c in w.items():
            if c > self.vc.get(k, 0):
                self.vc[k] = c
        self.causal_message(conn, payload)

    def _on_envelope(self, conn: NodeConnection, envelope: dict) -> None:
        sender = envelope[VC_FROM_KEY]
        w = envelope[VC_KEY]
        payload = envelope.get("payload")
        if w.get(sender, 0) <= self.vc.get(sender, 0):
            return  # stale duplicate (already delivered); FIFO TCP makes
            #         this reachable only via app-level resend
        if not self._deliverable(sender, w):
            self._held.append((sender, w, payload, conn))
            return
        self._deliver(sender, w, payload, conn)
        # One delivery can release a chain: re-scan until a full pass
        # holds nothing deliverable. The re-scan also PURGES entries gone
        # stale since they were buffered — a resent copy of a message that
        # was held at arrival passes the arrival staleness check, and once
        # the original delivers it would otherwise sit in _held forever
        # (inflating undelivered() and leaking under repeated resends).
        progress = True
        while progress and self._held:
            progress = False
            for i, (s, hw, hp, hc) in enumerate(self._held):
                if hw.get(s, 0) <= self.vc.get(s, 0):
                    del self._held[i]
                    progress = True
                    break
                if self._deliverable(s, hw):
                    del self._held[i]
                    self._deliver(s, hw, hp, hc)
                    progress = True
                    break

    # ------------------------------------------------------ interception

    def node_message(self, node: NodeConnection, data) -> None:
        if isinstance(data, dict) and VC_KEY in data and VC_FROM_KEY in data:
            self._on_envelope(node, data)
            return
        super().node_message(node, data)
