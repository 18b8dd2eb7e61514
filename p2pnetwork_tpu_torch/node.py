"""Node orchestration for the sockets backend.

``Node`` is the same concept as the reference's ``Node``
[ref: p2pnetwork/node.py:13]: a TCP server plus peer registry plus
broadcast/unicast sender, extended by subclassing its event methods or by
passing a ``callback(event, main_node, connected_node, data)``
[ref: node.py:24-29]. The full ten-event vocabulary, the
``create_new_connection`` factory seam [ref: node.py:196-201] and the
reconnect policy hook [ref: node.py:354-363] are preserved name-for-name, and
the wire format interoperates with live reference nodes (see wire.py).

Runtime design (deliberately different, SURVEY.md section 7): instead of one
accept thread per node plus one thread per connection with 10 ms poll loops
[ref: node.py:227-280, nodeconnection.py:186-229], each ``Node`` runs a single
asyncio event loop on one background thread. All peer-registry state is
mutated only from that loop, which designs out the reference's unlocked
cross-thread list mutation (SURVEY.md section 2.3.6). Public methods are
thread-safe facades that post onto the loop.

Deliberate fixes over the reference (SURVEY.md section 2.3), each noted
inline: single reconnect key (2.3.1), no mutable default argument (2.3.5),
``message_count_rerr`` actually counts errors (2.3.7), EOF during the
outbound handshake is an error instead of a phantom empty-id peer.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import random
import socket
import threading
import time
from typing import Callable, List, Optional, Union

from p2pnetwork_tpu_torch import concurrency, telemetry
from p2pnetwork_tpu_torch.config import NodeConfig
from p2pnetwork_tpu_torch.nodeconnection import NodeConnection
from p2pnetwork_tpu_torch.utils import EventLog, generate_id


class Node(threading.Thread):
    """A peer node: TCP server, peer registry, broadcast, event hooks.

    Constructor parity [ref: node.py:32]: ``Node(host, port, id=None,
    callback=None, max_connections=0)``; ``config`` adds typed tunables the
    reference hard-codes (SURVEY.md section 5 "Config"). Binding happens here,
    so port conflicts surface at construction like the reference's
    ``init_server`` [ref: node.py:92-98]. ``port=0`` binds an ephemeral port
    and stores the chosen one on ``self.port``.

    ``Node`` IS a ``threading.Thread``, like the reference's
    [ref: node.py:13] — ``isinstance`` checks, ``.name``, ``.daemon`` and
    ``join``/``is_alive`` behave as applications expect. The thread body
    (:meth:`run`) hosts the asyncio event loop rather than a blocking
    accept loop.
    """

    def __init__(self, host: str, port: int, id: Optional[str] = None,
                 callback: Optional[Callable] = None, max_connections: int = 0,
                 config: Optional[NodeConfig] = None,
                 registry: Optional[telemetry.Registry] = None):
        super().__init__(name=f"Node({host}:{port})", daemon=True)
        self.host = host
        self.port = port
        self.callback = callback
        self.config = config or NodeConfig()

        # Set when the node should stop [ref: node.py:36]. Constructed
        # through the concurrency seam (like every primitive in this
        # plane) so graftrace can instrument it.
        self.terminate_flag = concurrency.event()

        # Peer registries [ref: node.py:46-52]. Only mutated on the loop.
        self.nodes_inbound: List[NodeConnection] = []
        self.nodes_outbound: List[NodeConnection] = []
        self.reconnect_to_nodes: List[dict] = []

        # Identity [ref: node.py:54-58].
        self.id = generate_id(host, port) if id is None else str(id)

        # Message counters [ref: node.py:64-67]; rerr is live here (2.3.7).
        self.message_count_send = 0
        self.message_count_recv = 0
        self.message_count_rerr = 0

        self.max_connections = max_connections  # [ref: node.py:70]
        self.debug = False  # [ref: node.py:73]

        # Structured event history (addition; SURVEY.md section 5 "Metrics").
        self.event_log = EventLog()

        # Telemetry plane (telemetry/): same registry across every node in
        # the process unless one is injected per node. The legacy
        # message_count_* ints stay authoritative for parity; _record_*
        # below keeps them and these families in lockstep.
        self.telemetry = registry if registry is not None \
            else telemetry.default_registry()
        t = self.telemetry
        self._m_sent = t.counter(
            "p2p_messages_sent_total", "Messages queued for send, per node.",
            ("node",)).labels(self.id)
        self._m_recv = t.counter(
            "p2p_messages_received_total",
            "Frames received and delivered upward, per node.",
            ("node",)).labels(self.id)
        self._m_rerr = t.counter(
            "p2p_recv_errors_total",
            "Send/receive/parse errors (the reference's message_count_rerr, "
            "live here).", ("node",)).labels(self.id)
        self._m_bytes_sent = t.counter(
            "p2p_bytes_sent_total", "Framed bytes written, per peer.",
            ("node", "peer"))
        self._m_bytes_recv = t.counter(
            "p2p_bytes_received_total", "Raw bytes read, per peer.",
            ("node", "peer"))
        self._m_handle = t.histogram(
            "p2p_message_handle_seconds",
            "Per-message latency from frame decode through the "
            "node_message handler.", ("node",)).labels(self.id)
        self._m_conns = t.gauge(
            "p2p_connections", "Currently connected peers, by direction.",
            ("node", "direction"))
        self._m_reconnects = t.counter(
            "p2p_reconnect_attempts_total",
            "Reconnect attempts against registered dropped peers.",
            ("node",)).labels(self.id)
        self._m_next_retry = t.gauge(
            "p2p_reconnect_next_retry_seconds",
            "Seconds until the next reconnect attempt of a registered "
            "dropped peer (0 while connected).", ("node", "peer"))
        self._m_reconnect_trigger_timeouts = t.counter(
            "p2p_reconnect_trigger_timeouts_total",
            "Manual reconnect_nodes() triggers that timed out waiting on a "
            "busy or wedged event loop.", ("node",)).labels(self.id)
        self._m_undelivered = t.counter(
            "p2p_shutdown_undelivered_total",
            "Bytes still queued toward peers when a deadline-bounded "
            "Node.stop(deadline=) gave up draining them.",
            ("node",)).labels(self.id)
        # Decorrelated-jitter draws for the reconnect backoff; per-node so
        # chaos tests can reseed one node without touching global state.
        self._reconnect_rng = random.Random()
        self._m_events = t.counter(
            "p2p_events_total", "Framework events fired, by event name.",
            ("node", "event"))

        # Bind now so errors surface in the constructor [ref: node.py:92-98].
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((self.host, self.port))
        self.sock.listen(self.config.listen_backlog)
        self.sock.setblocking(False)
        if self.port == 0:
            self.port = self.sock.getsockname()[1]
            # Re-stamp the thread name with the resolved ephemeral port so
            # thread dumps distinguish concurrent port-0 nodes.
            self.name = f"Node({self.host}:{self.port})"
        print(f"Initialisation of the Node on port: {self.port} on node ({self.id})")

        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._stop_event: Optional[asyncio.Event] = None
        # Drain budget of a deadline-bounded stop(); None = legacy close.
        self._stop_deadline: Optional[float] = None
        # NOT named _started: threading.Thread owns that attribute.
        self._ready = concurrency.event()

    # ------------------------------------------------------------ telemetry

    def _record_send(self) -> None:
        """Bump the send counter — legacy int and telemetry family together."""
        self.message_count_send += 1
        self._m_sent.inc()

    def _record_recv(self) -> None:
        self.message_count_recv += 1
        self._m_recv.inc()

    def _record_rerr(self) -> None:
        self.message_count_rerr += 1
        self._m_rerr.inc()

    def _update_conn_gauges(self) -> None:
        self._m_conns.labels(self.id, "inbound").set(len(self.nodes_inbound))
        self._m_conns.labels(self.id, "outbound").set(len(self.nodes_outbound))

    # ------------------------------------------------------------- registry

    @property
    def all_nodes(self) -> List[NodeConnection]:
        """All connected peers, inbound then outbound [ref: node.py:75-78]."""
        return self.nodes_inbound + self.nodes_outbound

    def debug_print(self, message: str) -> None:
        """Print ``message`` when ``self.debug`` is set [ref: node.py:80-83]."""
        if self.debug:
            print(f"DEBUG ({self.id}): {message}")

    def generate_id(self) -> str:
        """Generate a fresh unique id [ref: node.py:85-90]."""
        return generate_id(self.host, self.port)

    def print_connections(self) -> None:
        """Print an inbound/outbound connection overview [ref: node.py:100-104]."""
        print("Node connection overview:")
        print(f"Total nodes connected with us: {len(self.nodes_inbound)}")
        print(f"Total nodes connected to     : {len(self.nodes_outbound)}")

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        """Start the node's thread and begin accepting peers
        [ref: node.py:13 — ``Node`` is a ``threading.Thread``].

        Unlike a bare ``Thread.start``, returns only once the server is
        accepting (or failed to start), so ``connect_with_node`` right
        after ``start()`` never races the loop coming up. The wait is
        BOUNDED: a loop that cannot come up within 30 s (interpreter
        wedged before ``_main`` runs its first statement) raises instead
        of hanging the caller forever."""
        super().start()
        if not self._ready.wait(timeout=30.0):
            raise RuntimeError(
                "Node.start: event loop did not come up within 30s")

    def run(self) -> None:
        """Thread body: host the node's asyncio event loop."""
        asyncio.run(self._main())

    async def _main(self) -> None:
        """Loop body: serve, tick the reconnect registry, shut down cleanly.

        The asyncio analog of the reference's accept loop + epilogue
        [ref: node.py:227-280]."""
        self._loop = asyncio.get_running_loop()
        self._stop_event = asyncio.Event()
        try:
            self._server = await asyncio.start_server(self._handle_inbound, sock=self.sock)
        except Exception as e:
            self.debug_print(f"Node: could not start server: {e}")
            self._ready.set()
            return
        self._ready.set()
        try:
            while not self._stop_event.is_set():
                try:
                    await asyncio.wait_for(
                        self._stop_event.wait(), timeout=self.config.reconnect_interval
                    )
                except asyncio.TimeoutError:
                    # Periodic reconnect check; the reference runs this every
                    # accept-loop tick [ref: node.py:265].
                    await self._reconnect_tick()
        finally:
            await self._shutdown()

    async def _shutdown(self) -> None:
        """Stop epilogue [ref: node.py:269-280]: close server, stop peers, join.

        A deadline-bounded stop first drains outbound write buffers within
        the deadline (:meth:`stop`); whatever is still queued past it is
        counted into ``p2p_shutdown_undelivered_total`` and force-aborted,
        so the supervised-shutdown story holds on the sockets backend too:
        bounded exit, with the loss measured instead of silent."""
        print("Node stopping...")
        if self._server is not None:
            self._server.close()
        conns = list(self.all_nodes)
        if self._stop_deadline is not None:
            await self._drain_outbound(conns, self._stop_deadline)
        for conn in conns:
            conn.stop()
        for conn in conns:
            await conn.wait_closed()
        if self._server is not None:
            # Python 3.12+: wait_closed() also waits for the connection
            # transports start_server spawned, so it must come after the
            # per-connection closes above or it deadlocks.
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=5.0)
            except asyncio.TimeoutError:
                self.debug_print("Node: server.wait_closed timed out")
        print("Node stopped")

    async def _drain_outbound(self, conns, deadline: float) -> int:
        """Wait (up to ``deadline`` seconds) for every peer's write buffer
        to empty; returns the bytes abandoned past the deadline.

        Undrained connections are marked for force-abort so the close
        epilogue stays prompt — a peer that stopped reading must not turn
        a bounded stop into a 10 s-per-connection graceful-close wait.
        Abandoned bytes count into ``p2p_shutdown_undelivered_total``."""
        def _buffered(conn) -> int:
            transport = conn.writer.transport
            if transport is None or transport.is_closing():
                return 0
            try:
                return int(transport.get_write_buffer_size())
            except Exception:
                return 0

        give_up_at = time.monotonic() + max(float(deadline), 0.0)
        while True:
            remaining = sum(_buffered(c) for c in conns)
            if remaining == 0:
                return 0
            if time.monotonic() >= give_up_at:
                break
            await asyncio.sleep(0.01)
        for conn in conns:
            if _buffered(conn) > 0:
                conn._abort = True  # undrained: stop() force-aborts
        self._m_undelivered.inc(remaining)
        self.event_log.record(
            "shutdown_undelivered", None,
            {"bytes": remaining, "deadline": deadline})
        self.debug_print(
            f"stop: abandoned {remaining} undelivered byte(s) after "
            f"{deadline}s drain deadline")
        return remaining

    def stop(self, deadline: Optional[float] = None) -> None:
        """Request the node to stop [ref: node.py:191-194].

        Thread-safe and idempotent, like the reference's flag-set.

        ``deadline`` (seconds) opts into a *measured* shutdown: the stop
        epilogue drains every peer's outbound queue for at most that long
        before closing; bytes still queued past the deadline are reported
        via the ``p2p_shutdown_undelivered_total`` counter and a
        ``shutdown_undelivered`` event-log record, and their connections
        are force-aborted so the stop itself stays bounded. Without a
        deadline the legacy behavior is unchanged (graceful close, the
        per-connection ``wait_closed`` 10 s bound)."""
        self.node_request_to_stop()
        if deadline is not None:
            self._stop_deadline = float(deadline)
        self.terminate_flag.set()
        loop, stop_event = self._loop, self._stop_event
        if loop is not None and stop_event is not None and not loop.is_closed():
            try:
                loop.call_soon_threadsafe(stop_event.set)
            except RuntimeError:
                pass  # loop already closed — nothing left to stop

    # join() and is_alive() are the inherited threading.Thread methods.

    # ------------------------------------------------------------- inbound

    async def _handle_inbound(self, reader: asyncio.StreamReader,
                              writer: asyncio.StreamWriter) -> None:
        """Accept-path: gate on max_connections, handshake, register, event.

        Mirrors [ref: node.py:232-263]: receive the peer's ``"id:port"``
        first, then send our id; the stored port is the peer's *server* port
        when present (inbound port semantics, SURVEY.md section 2.3.8)."""
        peername = writer.get_extra_info("peername") or ("?", 0)
        try:
            self.debug_print("Node: Wait for incoming connection")
            # Connection-limit gate [ref: node.py:239]; 0 means unlimited.
            if self.max_connections != 0 and len(self.nodes_inbound) >= self.max_connections:
                self.debug_print(
                    "New connection is closed. You have reached the maximum connection limit!"
                )
                writer.close()
                return
            handshake = await asyncio.wait_for(
                reader.read(4096), timeout=self.config.connect_timeout
            )
            connected_node_id = handshake.decode("utf-8")
            connected_node_port = peername[1]  # backward compat [ref: node.py:242]
            if ":" in connected_node_id:
                connected_node_id, port_str = connected_node_id.split(":")
                connected_node_port = int(port_str)
            writer.write(self.id.encode("utf-8"))  # [ref: node.py:246]
            await writer.drain()

            conn = self.create_new_connection(
                (reader, writer), connected_node_id, peername[0], connected_node_port
            )
            conn.start()
            self.nodes_inbound.append(conn)
            self._update_conn_gauges()
            self.inbound_node_connected(conn)
        except Exception as e:
            self._record_rerr()
            try:
                writer.close()
            except Exception:
                pass
            self.inbound_node_connection_error(e)

    # ------------------------------------------------------------- outbound

    def connect_with_node(self, host: str, port: int, reconnect: bool = False) -> bool:
        """Connect to a peer at ``host:port`` [ref: node.py:122-176].

        Guard parity: self-connect refused (``False``), already-connected
        host:port is a no-op (``True``), duplicate peer id after handshake
        sends the reference's ``"CLOSING: ..."`` string and reports ``True``.
        With ``reconnect=True`` the address is registered for automatic
        reconnection [ref: node.py:165-169].

        Thread-safe. When called from within an event handler (i.e. on the
        node's own loop), the connection attempt is scheduled in the
        background and this returns ``True`` if the guards pass; failures are
        then reported through ``outbound_node_connection_error`` — the
        reference's error channel [ref: node.py:173-176]. Use
        :meth:`connect_with_node_async` in async code for the exact result.
        """
        if host == self.host and port == self.port:
            print("connect_with_node: Cannot connect with yourself!!")
            return False
        for node in self.all_nodes:
            if node.host == host and node.port == port:
                print(f"connect_with_node: Already connected with this node ({node.id}).")
                return True
        loop = self._loop
        if loop is None or not loop.is_running():
            self.debug_print("connect_with_node: node is not running — call start() first")
            return False
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is loop:
            loop.create_task(self.connect_with_node_async(host, port, reconnect))
            return True
        fut = asyncio.run_coroutine_threadsafe(
            self.connect_with_node_async(host, port, reconnect), loop
        )
        # Bounded like reconnect_nodes(): a healthy attempt legitimately
        # spends one connect timeout on TCP establishment and one on the
        # handshake read; an unbounded .result() would hang this caller
        # forever on a wedged loop (e.g. a stuck user handler).
        bound = 2.0 * self.config.connect_timeout + 1.0
        try:
            return fut.result(timeout=bound)
        except concurrent.futures.TimeoutError:
            self.event_log.record(
                "connect_trigger_timeout", None,
                {"host": host, "port": port, "timeout": bound})
            self.debug_print(
                f"connect_with_node: no result within {bound}s — event "
                "loop busy or wedged; the attempt continues in the "
                "background (outbound_node_connected/. .._error still fire)"
            )
            return False

    async def connect_with_node_async(self, host: str, port: int,
                                      reconnect: bool = False) -> bool:
        """Async core of :meth:`connect_with_node`; runs on the node's loop."""
        if host == self.host and port == self.port:
            print("connect_with_node: Cannot connect with yourself!!")
            return False
        for node in self.all_nodes:
            if node.host == host and node.port == port:
                print(f"connect_with_node: Already connected with this node ({node.id}).")
                return True
        node_ids = [node.id for node in self.all_nodes]
        writer = None
        try:
            self.debug_print(f"connecting to {host} port {port}")
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, port), timeout=self.config.connect_timeout
            )
            # Plaintext id handshake, parity for interop [ref: node.py:148-150]:
            # send "id:port", receive the peer's id.
            writer.write(f"{self.id}:{self.port}".encode("utf-8"))
            await writer.drain()
            handshake = await asyncio.wait_for(
                reader.read(4096), timeout=self.config.connect_timeout
            )
            if not handshake:
                # Peer closed before completing the handshake (e.g. its
                # connection limit). The reference would register a phantom
                # empty-id peer here; we fail instead (deliberate fix).
                raise ConnectionError("peer closed the connection during the handshake")
            connected_node_id = handshake.decode("utf-8")

            # Duplicate-peer guard [ref: node.py:153-156].
            if self.id == connected_node_id or connected_node_id in node_ids:
                writer.write("CLOSING: Already having a connection together".encode("utf-8"))
                writer.close()
                return True

            conn = self.create_new_connection((reader, writer), connected_node_id, host, port)
            conn.start()
            self.nodes_outbound.append(conn)
            self._update_conn_gauges()
            self.outbound_node_connected(conn)

            # Reconnect registration [ref: node.py:165-169]; single "trials"
            # key — the reference writes "tries" but reads "trials"
            # (SURVEY.md section 2.3.1).
            if reconnect:
                self.debug_print(
                    f"connect_with_node: Reconnection check is enabled on node {host}:{port}"
                )
                self.reconnect_to_nodes.append({
                    "host": host, "port": port, "trials": 0,
                    # Per-entry backoff state: last drawn delay and the
                    # monotonic deadline of the next attempt.
                    "backoff": 0.0, "next_retry_at": 0.0,
                })
            return True
        except Exception as error:
            if writer is not None:
                try:
                    writer.close()
                except Exception:
                    pass
            self._record_rerr()
            self.debug_print(f"connect_with_node: Could not connect with node. ({error})")
            self.outbound_node_connection_error(error)
            return False

    def disconnect_with_node(self, node: NodeConnection) -> None:
        """Close one outbound connection [ref: node.py:178-189].

        Fires ``node_disconnect_with_outbound_node`` before closing; peers we
        did not initiate the connection to cannot be disconnected this way."""
        if node in self.nodes_outbound:
            self.node_disconnect_with_outbound_node(node)
            node.stop()
        else:
            self.debug_print(
                "Node disconnect_with_node: cannot disconnect with a node with which "
                "we are not connected."
            )

    # ------------------------------------------------------------ messaging

    def send_to_nodes(self, data: Union[str, dict, bytes],
                      exclude: Optional[List[NodeConnection]] = None,
                      compression: str = "none") -> None:
        """Broadcast ``data`` to every connected peer not in ``exclude``.

        [ref: node.py:106-112]; ``exclude`` defaults to ``None`` instead of a
        shared mutable list (SURVEY.md section 2.3.5)."""
        exclude = exclude or []
        for n in self.all_nodes:
            if n not in exclude:
                self.send_to_node(n, data, compression)

    def send_to_node(self, n: NodeConnection, data: Union[str, dict, bytes],
                     compression: str = "none") -> None:
        """Unicast ``data`` to peer ``n`` [ref: node.py:114-120].

        Counter-then-membership-check order preserved [ref: node.py:116-117]."""
        self._record_send()
        if n in self.all_nodes:
            n.send(data, compression=compression)
        else:
            self.debug_print("Node send_to_node: Could not send the data, node is not found!")

    # ------------------------------------------------------------ factories

    def create_new_connection(self, connection, id: str, host: str, port: int) -> NodeConnection:
        """Factory seam for substituting a custom connection class
        [ref: node.py:196-201]. ``connection`` is an asyncio
        ``(StreamReader, StreamWriter)`` pair."""
        return NodeConnection(self, connection, id, host, port)

    # ------------------------------------------------------------ reconnect

    async def _reconnect_tick(self) -> None:
        """Re-establish registered outbound connections that dropped.

        [ref: node.py:203-225] with the single-key fix (SURVEY.md 2.3.1): each
        entry is ``{"host", "port", "trials", "backoff", "next_retry_at"}``;
        the policy hook ``node_reconnection_error`` decides retry (True) vs
        deregister (False) per trial count.

        Retry cadence is per-entry exponential backoff with decorrelated
        jitter (delay_{n+1} ~ U[base, 3 * delay_n], capped at
        ``reconnect_backoff_max``) instead of the reference's fixed-interval
        hammering of dead peers; ``reconnect_interval`` stays the tick floor.
        Backoff resets on successful reconnect; the time to the next attempt
        is published as the ``p2p_reconnect_next_retry_seconds`` gauge.

        Due entries dial CONCURRENTLY: a serial walk would stall the tick
        (and node shutdown, and manual triggers) for up to
        ``K * connect_timeout`` when K peers are unreachable rather than
        refusing. Each entry's next-retry deadline is stamped AFTER its
        dial completes, from a fresh clock read — computing it up front
        would let a slow dial consume the whole delay before it starts."""
        dials = []
        for entry in list(self.reconnect_to_nodes):
            host, port = entry["host"], entry["port"]
            peer_key = f"{host}:{port}"
            self.debug_print(f"reconnect_nodes: Checking node {host}:{port}")
            found = any(
                n.host == host and n.port == port for n in self.nodes_outbound
            )
            if found:
                entry["trials"] = 0
                entry["backoff"] = 0.0
                entry["next_retry_at"] = 0.0
                self._m_next_retry.labels(self.id, peer_key).set(0.0)
                self.debug_print(f"reconnect_nodes: Node {host}:{port} still running!")
                continue
            now = time.monotonic()
            next_retry_at = entry.get("next_retry_at", 0.0)
            if now < next_retry_at:
                self._m_next_retry.labels(self.id, peer_key).set(next_retry_at - now)
                continue
            if entry.get("dialing"):
                # A dial from an overlapping tick (manual trigger racing
                # the periodic one) is still in flight; a second dial
                # would double-count trials and can register a duplicate
                # connection if the peer comes back mid-window.
                continue
            entry["trials"] += 1
            self._m_reconnects.inc()
            if self.node_reconnection_error(host, port, entry["trials"]):
                entry["dialing"] = True
                dials.append(self._dial_registered(entry, host, port))
            else:
                self.debug_print(
                    f"reconnect_nodes: Removing node ({host}:{port}) from the reconnection list!"
                )
                self.reconnect_to_nodes.remove(entry)
                # Deregistered: prune the gauge so the dead peer does not
                # leave a forever-sample behind.
                self._m_next_retry.remove(self.id, peer_key)
        if dials:
            await asyncio.gather(*dials)

    async def _dial_registered(self, entry: dict, host: str, port: int) -> None:
        """One reconnect dial plus its post-dial backoff bookkeeping."""
        try:
            await self.connect_with_node_async(host, port)
        finally:
            entry["dialing"] = False
            base = self.config.reconnect_backoff_base
            prev = entry.get("backoff") or base
            backoff = min(self.config.reconnect_backoff_max,
                          self._reconnect_rng.uniform(base, prev * 3.0))
            entry["backoff"] = backoff
            entry["next_retry_at"] = time.monotonic() + backoff
            # A successful dial is reset by the found-check on the next tick.
            self._m_next_retry.labels(self.id, f"{host}:{port}").set(backoff)

    def reconnect_nodes(self) -> None:
        """Manual trigger of one reconnect check [ref: node.py:203].

        Thread-safe; from an event handler (i.e. on the node's own loop) the
        check is scheduled in the background instead of awaited, since
        blocking the loop on its own work would deadlock.

        The cross-thread wait is BOUNDED at ``2 * config.connect_timeout``
        plus one second of headroom — a healthy tick's slowest dial may
        legitimately consume one connect timeout on TCP establishment and a
        second on the handshake read: an unbounded ``.result()`` would hang
        the caller forever if the loop is wedged (e.g. a stuck user handler).
        On timeout the check keeps running on the loop, and the caller gets
        a structured warning — a ``reconnect_trigger_timeout`` event-log
        record plus the ``p2p_reconnect_trigger_timeouts_total`` counter."""
        loop = self._loop
        if loop is None or not loop.is_running():
            return
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is loop:
            loop.create_task(self._reconnect_tick())
            return
        fut = asyncio.run_coroutine_threadsafe(self._reconnect_tick(), loop)
        bound = 2.0 * self.config.connect_timeout + 1.0
        try:
            fut.result(timeout=bound)
        except concurrent.futures.TimeoutError:
            self._m_reconnect_trigger_timeouts.inc()
            self.event_log.record(
                "reconnect_trigger_timeout", None, {"timeout": bound})
            self.debug_print(
                f"reconnect_nodes: tick did not complete within {bound}s — "
                "event loop busy or wedged; the check continues in the "
                "background"
            )

    # -------------------------------------------------------------- events
    #
    # The ten-event Extension API [ref: node.py:282-363]: subclasses override
    # these; each also dispatches to the optional callback with the exact
    # event-name strings of the reference, and records into the event log.

    def _dispatch(self, event: str, connected_node, data) -> None:
        peer_id = getattr(connected_node, "id", None)
        self.event_log.record(event, peer_id, data)
        self._m_events.labels(self.id, event).inc()
        if self.callback is not None:
            self.callback(event, self, connected_node, data)

    def outbound_node_connected(self, node: NodeConnection) -> None:
        """We successfully connected to ``node`` [ref: node.py:282-287]."""
        self.debug_print(f"outbound_node_connected: {node.id}")
        self._dispatch("outbound_node_connected", node, {})

    def outbound_node_connection_error(self, exception: Exception) -> None:
        """An outbound connection attempt failed [ref: node.py:289-293]."""
        self.debug_print(f"outbound_node_connection_error: {exception}")
        self._dispatch("outbound_node_connection_error", None, {"exception": exception})

    def inbound_node_connected(self, node: NodeConnection) -> None:
        """A peer connected to us [ref: node.py:295-299]."""
        self.debug_print(f"inbound_node_connected: {node.id}")
        self._dispatch("inbound_node_connected", node, {})

    def inbound_node_connection_error(self, exception: Exception) -> None:
        """Accepting a peer failed [ref: node.py:301-305]."""
        self.debug_print(f"inbound_node_connection_error: {exception}")
        self._dispatch("inbound_node_connection_error", None, {"exception": exception})

    def node_disconnected(self, node: NodeConnection) -> None:
        """Route a dead connection to the inbound/outbound variant
        [ref: node.py:307-319], removing it from the registry."""
        self.debug_print(f"node_disconnected: {node.id}")
        if node in self.nodes_inbound:
            self.nodes_inbound.remove(node)
            self._update_conn_gauges()
            self.inbound_node_disconnected(node)
        if node in self.nodes_outbound:
            self.nodes_outbound.remove(node)
            self._update_conn_gauges()
            self.outbound_node_disconnected(node)

    def inbound_node_disconnected(self, node: NodeConnection) -> None:
        """A peer that had connected to us went away [ref: node.py:321-326]."""
        self.debug_print(f"inbound_node_disconnected: {node.id}")
        self._dispatch("inbound_node_disconnected", node, {})

    def outbound_node_disconnected(self, node: NodeConnection) -> None:
        """A peer we had connected to went away [ref: node.py:328-332]."""
        self.debug_print(f"outbound_node_disconnected: {node.id}")
        self._dispatch("outbound_node_disconnected", node, {})

    def node_message(self, node: NodeConnection, data) -> None:
        """A peer sent us a message [ref: node.py:334-338]."""
        self.debug_print(f"node_message: {node.id}: {data}")
        self._dispatch("node_message", node, data)

    def node_disconnect_with_outbound_node(self, node: NodeConnection) -> None:
        """We are about to close an outbound connection [ref: node.py:340-345]."""
        self.debug_print(f"node wants to disconnect with other outbound node: {node.id}")
        self._dispatch("node_disconnect_with_outbound_node", node, {})

    def node_request_to_stop(self) -> None:
        """The node was asked to stop [ref: node.py:347-352].

        Callback signature parity: the reference passes ``{}`` for the
        connected-node argument here [ref: node.py:352]."""
        self.debug_print("node is requested to stop!")
        self.event_log.record("node_request_to_stop", None, {})
        self._m_events.labels(self.id, "node_request_to_stop").inc()
        if self.callback is not None:
            self.callback("node_request_to_stop", self, {}, {})

    def node_reconnection_error(self, host: str, port: int, trials: int) -> bool:
        """Reconnect policy hook [ref: node.py:354-363]: return ``True`` to
        keep retrying ``host:port``, ``False`` to deregister it."""
        self.debug_print(
            f"node_reconnection_error: Reconnecting to node {host}:{port} (trials: {trials})"
        )
        return True

    # ------------------------------------------------------------------ repr

    def __str__(self) -> str:
        return f"Node: {self.host}:{self.port}"

    def __repr__(self) -> str:
        return f"<Node {self.host}:{self.port} id: {self.id}>"
