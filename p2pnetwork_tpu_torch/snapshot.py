"""Chandy–Lamport consistent global snapshots over the sockets backend.

The sim backend can checkpoint because its whole world is one array
state (sim/checkpoint.py); a REAL overlay of reference-style nodes has
no such luxury — state is spread across processes with messages in
flight, and naively asking every node to dump state records a cut that
never existed (a message counted at neither or both ends). The
reference has no answer at all — no persistence of any kind [ref:
p2pnetwork/node.py:85-90, ids regenerated per run; SURVEY.md section 5
"Checkpoint / resume — Absent"]. Chandy–Lamport (1985) is THE classic
fix, and its one hard requirement — FIFO channels — is exactly what the
per-connection TCP stream already provides.

:class:`SnapshotNode` extends :class:`~p2pnetwork_tpu_torch.node.Node` with
the marker discipline:

- ``take_snapshot()``: record local state (:meth:`capture_state`), then
  send a marker on every channel and start recording every incoming
  channel;
- first marker for a snapshot id: same local start, and that channel's
  state is empty;
- later markers: stop recording that channel — the recorded messages
  ARE the channel state of the cut;
- markers received on every channel: the local snapshot is complete —
  :meth:`snapshot_complete` fires (and dispatches the
  ``"snapshot_complete"`` callback event, extending the reference's
  ten-event vocabulary).

Atomicity contract: everything runs on the node's single event loop
(the same design that removed the reference's cross-thread races,
node.py module docstring). ``capture_state`` is invoked on the loop
thread, back-to-back with marker emission, so application state
mutated only from event handlers — or from closures passed to
:meth:`post` — is captured atomically with respect to the cut. State
mutated from foreign threads is outside the contract (the mutation and
its sends could straddle the markers); route such writes through
``post``.

Application traffic moves to the :meth:`app_message` hook — override it
instead of ``node_message`` (which now intercepts markers); its default
preserves the reference behavior (debug print + ``"node_message"``
callback dispatch). A peer that dies mid-snapshot releases its channel
with whatever was recorded (the cut degrades like the network did,
instead of hanging). Concurrent snapshots with distinct ids interleave
safely — recording is tracked per id, the standard generalization.
"""

from __future__ import annotations

import uuid
from typing import Any, Callable, Dict, Optional

from p2pnetwork_tpu_torch import concurrency
from p2pnetwork_tpu_torch.node import Node
from p2pnetwork_tpu_torch.nodeconnection import NodeConnection

#: Payload key marking a snapshot marker frame. Dict payloads carrying it
#: are consumed by the algorithm and never reach ``app_message``.
MARKER_KEY = "_cl_marker"


class _Pending:
    """Book-keeping for one in-progress snapshot id on one node."""

    __slots__ = ("state", "recording", "channels")

    def __init__(self, state: Any):
        self.state = state
        self.recording: Dict[NodeConnection, list] = {}
        self.channels: Dict[str, list] = {}


class SnapshotNode(Node):
    """A :class:`Node` that can take part in consistent global snapshots.

    Override :meth:`capture_state` to say what your node's state IS, and
    :meth:`app_message` for application traffic. Any participant may call
    :meth:`take_snapshot`; every reachable participant completes its local
    snapshot, retrievable via :meth:`get_snapshot` / :meth:`wait_snapshot`.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # Only mutated on the event loop; read via get_snapshot anywhere.
        self._snap_pending: Dict[str, _Pending] = {}
        self._snap_done: Dict[str, dict] = {}
        # Completion events, keyed by sid; created lazily from ANY thread
        # (setdefault under the GIL) — waiting must work even before the
        # posted _local_start has run, or before this node has ever heard
        # of the id (a remote participant awaiting the initiator's cut).
        self._snap_events: Dict[str, Any] = {}  # sid -> seam event

    # ------------------------------------------------------------ app API

    def capture_state(self) -> Any:
        """The node state the snapshot should record; called on the event
        loop at the cut instant. Default: the reference's counters."""
        return {
            "message_count_send": self.message_count_send,
            "message_count_recv": self.message_count_recv,
        }

    def app_message(self, node: NodeConnection, data) -> None:
        """Application traffic (everything that is not a marker). Default
        keeps reference behavior: debug print + callback dispatch."""
        super().node_message(node, data)

    def post(self, fn: Callable[[], None]) -> None:
        """Run ``fn()`` on the node's event loop — the supported way to
        mutate snapshot-visible state (and send its messages) from outside
        an event handler, keeping the mutation atomic w.r.t. the cut."""
        loop = self._loop
        if loop is None or loop.is_closed():
            raise RuntimeError("node is not running — call start() first")
        loop.call_soon_threadsafe(fn)

    def take_snapshot(self, snapshot_id: Optional[str] = None) -> str:
        """Initiate a global snapshot; returns its id immediately.

        Thread-safe (posts onto the loop). The local result lands in
        :meth:`get_snapshot`; remote participants each complete their own
        local snapshot under the same id."""
        sid = snapshot_id if snapshot_id is not None else uuid.uuid4().hex
        if sid in self._snap_done or sid in self._snap_pending:
            # A reused id would silently no-op (_local_start's idempotency
            # exists for duplicate MARKERS) and hand back the stale cut as
            # if fresh. Periodic callers: generate ids, or discard_snapshot
            # the old cut first.
            raise ValueError(f"snapshot id {sid!r} was already used")
        self.post(lambda: self._local_start(sid))
        return sid

    def get_snapshot(self, sid: str) -> Optional[dict]:
        """The completed local snapshot for ``sid``, or None if not done:
        ``{"id", "node_id", "state", "channels": {peer_id: [messages]}}``."""
        return self._snap_done.get(sid)

    def wait_snapshot(self, sid: str, timeout: Optional[float] = None
                      ) -> Optional[dict]:
        """Block the calling thread until ``sid`` completes locally (or
        ``timeout`` elapses — then returns None)."""
        self._snap_events.setdefault(sid, concurrency.event()).wait(timeout)
        return self.get_snapshot(sid)

    def discard_snapshot(self, sid: str) -> Optional[dict]:
        """Return the completed snapshot for ``sid`` (or None) and release
        its retained state. Completed cuts — recorded channel payloads
        included — are otherwise kept forever so late ``get_snapshot``
        readers work; a periodic checkpointer must discard each cut after
        consuming it or the retention is a slow leak."""
        snap = self._snap_done.get(sid)

        def _drop():
            self._snap_done.pop(sid, None)
            self._snap_events.pop(sid, None)

        self.post(_drop)
        return snap

    def snapshot_complete(self, snapshot: dict) -> None:
        """Local snapshot for one id is complete (markers arrived on every
        channel). Extension hook + ``"snapshot_complete"`` callback event."""
        self.debug_print(f"snapshot_complete: {snapshot['id']}")
        self._dispatch("snapshot_complete", None, snapshot)

    # ----------------------------------------------------- marker machine

    def _local_start(self, sid: str) -> None:
        """Record state, mark every channel, start recording — the atomic
        local cut (runs as one uninterrupted loop callback)."""
        if sid in self._snap_pending or sid in self._snap_done:
            return
        pend = _Pending(self.capture_state())
        for conn in self.all_nodes:
            pend.recording[conn] = []
        self._snap_pending[sid] = pend
        self.send_to_nodes({MARKER_KEY: sid})
        if not pend.recording:  # no peers: the cut is just local state
            self._finish(sid, pend)

    def _release_channel(self, pend: _Pending, node: NodeConnection) -> None:
        # extend, not assign: two connections can share a peer id (a
        # simultaneous mutual dial races the outbound duplicate guard), and
        # assignment would clobber the first channel's recorded messages —
        # losing them from the cut. The merged list is still the channel
        # state of the cut for that peer.
        pend.channels.setdefault(node.id, []).extend(pend.recording.pop(node))

    def _on_marker(self, node: NodeConnection, sid: str) -> None:
        self._local_start(sid)  # no-op if this id already started here
        pend = self._snap_pending.get(sid)
        if pend is None or node not in pend.recording:
            return  # duplicate marker, or a post-cut connection
        self._release_channel(pend, node)
        if not pend.recording:
            self._finish(sid, pend)

    def _finish(self, sid: str, pend: _Pending) -> None:
        snapshot = {
            "id": sid,
            "node_id": self.id,
            "state": pend.state,
            "channels": pend.channels,
        }
        self._snap_done[sid] = snapshot
        del self._snap_pending[sid]
        self._snap_events.setdefault(sid, concurrency.event()).set()
        self.snapshot_complete(snapshot)

    # ------------------------------------------------------ interceptions

    def node_message(self, node: NodeConnection, data) -> None:
        if isinstance(data, dict) and MARKER_KEY in data:
            self._on_marker(node, data[MARKER_KEY])
            return
        # Pre-marker messages are the channel state of the cut.
        for pend in self._snap_pending.values():
            rec = pend.recording.get(node)
            if rec is not None:
                rec.append(data)
        self.app_message(node, data)

    def node_disconnected(self, node: NodeConnection) -> None:
        # A dead peer can never deliver its marker: release its channel
        # with what was recorded so the snapshot completes instead of
        # hanging — the cut reflects the failure, like the network does.
        for sid in list(self._snap_pending):
            pend = self._snap_pending[sid]
            if node in pend.recording:
                self._release_channel(pend, node)
                if not pend.recording:
                    self._finish(sid, pend)
        super().node_disconnected(node)
