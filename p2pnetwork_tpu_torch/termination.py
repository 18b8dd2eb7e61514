"""Dijkstra–Scholten termination detection over the sockets backend.

"Has the computation I started actually FINISHED everywhere?" — the
question every diffusing protocol (flood, query fan-out, recursive
lookup) built on the reference's ``node_message`` cannot answer: silence
is indistinguishable from in-flight work [ref: p2pnetwork/node.py:334 —
fire-and-forget delivery, no acknowledgements anywhere]. The classic
answer for diffusing computations is Dijkstra–Scholten (1980): grow a
spanning tree of "engagements" as the work spreads, retire leaves as
they go quiet, and when the tree has collapsed back into the root the
root KNOWS the whole computation — every message included — is done.

:class:`TerminationNode` runs the accounting under an app-defined
computation:

- the root calls :meth:`start_diffusing` (becoming its own engager);
- work moves with :meth:`send_work` (inside :meth:`work_message`
  handlers or from the root) — each send adds to the sender's deficit;
- an idle node's first work message ENGAGES it (that sender becomes its
  parent in the detection tree); any other work message is acknowledged
  immediately;
- a node acknowledges its ENGAGER only once it is passive (its
  ``work_message`` handler returned) with zero deficit (all its own
  sends acknowledged) — detaching from the tree;
- when the ROOT's deficit reaches zero, :meth:`computation_terminated`
  fires: a true global claim, not a timeout heuristic.

The handler-scoped activity model keeps the bookkeeping deterministic:
a node is active exactly while its ``work_message`` handler runs on the
event loop, so "passive" needs no app signal — long-lived local work
should re-enter through self-addressed messages rather than blocking
the loop. Multiple concurrent computations are tracked per root id.

Honest limits: like the algorithm, this assumes reliable channels —
a peer crashing mid-computation orphans its subtree's acknowledgements
and the root waits forever (``deficit()`` exposes the stuck count;
pair with the reconnect machinery or a SnapshotNode cut to diagnose).
"""

from __future__ import annotations

import threading
import uuid
from typing import Dict, Optional

from p2pnetwork_tpu_torch import concurrency
from p2pnetwork_tpu_torch.node import Node
from p2pnetwork_tpu_torch.nodeconnection import NodeConnection

WORK_KEY = "_ds_work"  # envelope: {_ds_work: comp_id, payload: ...}
ACK_KEY = "_ds_ack"  # envelope: {_ds_ack: comp_id}


class _Comp:
    """Per-computation detection state on one node."""

    __slots__ = ("engager", "deficit", "is_root")

    def __init__(self, engager: Optional[NodeConnection], is_root: bool):
        self.engager = engager  # None for the root
        self.deficit = 0  # our sends not yet acknowledged
        self.is_root = is_root


class TerminationNode(Node):
    """A :class:`Node` that detects termination of diffusing computations."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # Mutated only on the event loop.
        self._comps: Dict[str, _Comp] = {}
        self._active_comp: Optional[str] = None  # set while handler runs
        # Root-side id ledger, reserved SYNCHRONOUSLY in start_diffusing:
        # checking _comps alone races the posted closure that creates the
        # entry (a second start_diffusing can sneak in before the loop
        # runs the first), so the reservation must happen caller-side.
        self._cids_used: set = set()
        self._cid_lock = concurrency.lock()
        # Local-completion events, creatable from ANY thread (setdefault
        # under the GIL): wait_terminated must work even before the
        # posted start_diffusing closure has created the comp entry.
        self._term_events: Dict[str, threading.Event] = {}

    # ------------------------------------------------------------ app API

    def work_message(self, node: Optional[NodeConnection], comp_id: str,
                     data) -> None:
        """Application work arrived (or, at the root, the computation
        starts — then ``node`` is None). Override me; the node is ACTIVE
        for this computation exactly while this handler runs, and
        :meth:`send_work` calls made here are charged to it."""
        self.debug_print(f"work_message: {comp_id}: {data!r}")
        self._dispatch("work_message", node, {"comp_id": comp_id,
                                              "data": data})

    def computation_terminated(self, comp_id: str) -> None:
        """The ROOT's detection fired: every work message of ``comp_id``
        has been processed and acknowledged, globally."""
        self.debug_print(f"computation_terminated: {comp_id}")
        self._dispatch("computation_terminated", None, {"comp_id": comp_id})

    def start_diffusing(self, data, comp_id: Optional[str] = None) -> str:
        """Become the root of a new diffusing computation: run
        :meth:`work_message` locally (whose sends seed the spread).
        Thread-safe; returns the computation id."""
        cid = comp_id if comp_id is not None else uuid.uuid4().hex
        loop = self._loop
        if loop is None or loop.is_closed():
            raise RuntimeError("node is not running — call start() first")

        # Eager, caller-visible rejection: raised inside the posted
        # closure it would vanish into asyncio's exception handler and
        # the caller would mistake the OLD run's completion for this
        # one's. The reservation is synchronous (lock-guarded ledger) so
        # two back-to-back calls cannot both pass before the loop runs.
        with self._cid_lock:
            # All three ledgers matter: _cids_used catches root-side
            # reuse racing the posted closure; _comps catches an id this
            # node is currently ENGAGED in as a non-root (rooting it too
            # would clobber the engagement and orphan the real root's
            # ack); _term_events catches an id we already detached from
            # (its set event would make wait_terminated lie about the
            # new run).
            if (cid in self._cids_used or cid in self._comps
                    or cid in self._term_events):
                raise ValueError(f"computation id {cid!r} already used")
            self._cids_used.add(cid)

        def _do():
            if cid in self._comps:
                return  # engaged via marker since the reservation — the
                #         engagement wins; rooting would clobber it
            self._comps[cid] = _Comp(engager=None, is_root=True)
            self._run_handler(None, cid, data)

        loop.call_soon_threadsafe(_do)
        return cid

    def send_work(self, n: NodeConnection, data,
                  comp_id: Optional[str] = None) -> None:
        """Send one unit of work to peer ``n`` under a computation. Inside
        a :meth:`work_message` handler the computation is implied;
        ``comp_id`` is for other EVENT-LOOP code (another handler, a
        scheduled callback). Must run on the node's loop — a foreign
        thread bumping ``deficit`` would race ``_maybe_detach`` and could
        fire a FALSE termination while its message is still in flight,
        so the root seeds the spread from its own ``work_message``."""
        if threading.current_thread() is not self:
            raise RuntimeError(
                "send_work must run on the node's event loop (e.g. inside "
                "a work_message handler)")
        cid = comp_id if comp_id is not None else self._active_comp
        if cid is None:
            raise RuntimeError("send_work outside a work_message handler "
                               "needs an explicit comp_id")
        comp = self._comps.get(cid)
        if comp is None:
            raise RuntimeError(f"unknown computation {cid!r}")
        comp.deficit += 1
        self.send_to_node(n, {WORK_KEY: cid, "payload": data})

    def deficit(self, comp_id: str) -> int:
        """Outstanding unacknowledged sends for a computation (0 after
        local detach; at the root, 0 means terminated)."""
        comp = self._comps.get(comp_id)
        return 0 if comp is None else comp.deficit

    def wait_terminated(self, comp_id: str,
                        timeout: Optional[float] = None) -> bool:
        """Block until this node DETACHES from ``comp_id`` — at the root,
        that is global termination — or ``timeout`` elapses (False).

        Completed ids stay on record; a long-lived node launching
        unbounded computations should :meth:`forget_computation` ids it
        is done asking about (that also releases them for reuse)."""
        return self._term_events.setdefault(
            comp_id, concurrency.event()).wait(timeout)

    def forget_computation(self, comp_id: str) -> None:
        """Release the completion record of a finished computation (and
        allow the id's reuse). No-op while it is still running."""
        if comp_id not in self._comps:
            self._term_events.pop(comp_id, None)
            with self._cid_lock:
                self._cids_used.discard(comp_id)

    # ------------------------------------------------------ the machinery

    def _run_handler(self, node: Optional[NodeConnection], cid: str,
                     data) -> None:
        prev, self._active_comp = self._active_comp, cid
        try:
            self.work_message(node, cid, data)
        finally:
            self._active_comp = prev
        self._maybe_detach(cid)

    def _maybe_detach(self, cid: str) -> None:
        comp = self._comps.get(cid)
        if comp is None or comp.deficit > 0:
            return
        # Passive (no handler running for cid here — we only get called
        # after handlers return or acks arrive) with zero deficit.
        if comp.is_root:
            del self._comps[cid]
            self._term_events.setdefault(cid, concurrency.event()).set()
            self.computation_terminated(cid)
        elif comp.engager is not None:
            engager, comp.engager = comp.engager, None
            del self._comps[cid]
            self._term_events.setdefault(cid, concurrency.event()).set()
            self.send_to_node(engager, {ACK_KEY: cid})

    def _on_work(self, node: NodeConnection, cid: str, payload) -> None:
        comp = self._comps.get(cid)
        if comp is None:
            # First contact: this sender engages us into the tree. Its
            # ack is deferred until we detach.
            self._comps[cid] = _Comp(engager=node, is_root=False)
            self._run_handler(node, cid, payload)
        else:
            # Already engaged: process, then ack this message right away.
            self._run_handler(node, cid, payload)
            self.send_to_node(node, {ACK_KEY: cid})

    def _on_ack(self, node: NodeConnection, cid: str) -> None:
        comp = self._comps.get(cid)
        if comp is None or comp.deficit <= 0:
            return  # stray ack (e.g. from a computation we detached)
        comp.deficit -= 1
        self._maybe_detach(cid)

    # ------------------------------------------------------ interception

    def node_message(self, node: NodeConnection, data) -> None:
        if isinstance(data, dict):
            if WORK_KEY in data:
                self._on_work(node, data[WORK_KEY], data.get("payload"))
                return
            if ACK_KEY in data:
                self._on_ack(node, data[ACK_KEY])
                return
        super().node_message(node, data)
