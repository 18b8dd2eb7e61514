"""Per-peer transport for the sockets backend.

``NodeConnection`` has the same role and public surface as the reference's
class of the same name [ref: p2pnetwork/nodeconnection.py:9]: it represents
one TCP connection with a peer (inbound or outbound), owns framing /
serialization / compression for that peer, delivers parsed messages upward
through ``main_node.node_message`` [ref: nodeconnection.py:216] and reports
its own death through ``main_node.node_disconnected``
[ref: nodeconnection.py:228].

The concurrency design is deliberately different (SURVEY.md section 7): the
reference runs one OS thread per connection with a 10 ms poll loop
[ref: nodeconnection.py:186-229]; here each connection is an asyncio task on
its owning ``Node``'s event loop — no polling, no per-connection thread, and
no data races because every piece of peer state is only ever touched from
that one loop (the reference mutates shared lists from 3+ thread types with
no locks, SURVEY.md section 2.3.6).

Public surface parity:
- ``send(data, encoding_type='utf-8', compression='none')``
  [ref: nodeconnection.py:107]
- ``stop()`` [ref: nodeconnection.py:162]
- ``set_info/get_info`` and the ``info`` dict [ref: nodeconnection.py:231-235]
- ``id``, ``host``, ``port``, ``main_node``, ``EOT_CHAR``, ``COMPR_CHAR``
  attributes; ``__str__``/``__repr__`` [ref: nodeconnection.py:237-244]
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import time
from typing import Any, Optional, Tuple, Union

from p2pnetwork_tpu_torch import concurrency, wire

#: The transport handed to ``create_new_connection`` — an asyncio stream pair.
StreamPair = Tuple[asyncio.StreamReader, asyncio.StreamWriter]


class NodeConnection:
    """One peer connection: framing, serialization, compression, delivery.

    Constructor signature mirrors the reference factory contract
    [ref: node.py:196-201]: ``(main_node, connection, id, host, port)``, where
    ``connection`` is the transport — an ``(StreamReader, StreamWriter)`` pair
    here instead of a raw socket.
    """

    def __init__(self, main_node, connection: StreamPair, id: str, host: str, port: int):
        self.host = host
        self.port = port
        self.main_node = main_node
        self.reader, self.writer = connection

        # Parity: ids are always strings [ref: nodeconnection.py:35].
        self.id = str(id)

        # Exposed for parity with the reference's per-instance constants
        # [ref: nodeconnection.py:38-41]; the codec itself lives in wire.py.
        self.EOT_CHAR = wire.EOT_CHAR
        self.COMPR_CHAR = wire.COMPR_CHAR

        # Per-connection key/value store [ref: nodeconnection.py:44, :231-235].
        self.info: dict = {}

        # Parity flag; set by stop(). An event so non-loop threads can
        # observe it, like the reference's flag [ref: nodeconnection.py:32];
        # seam-constructed so graftrace can instrument it.
        self.terminate_flag = concurrency.event()

        self._decoder = wire.make_decoder(
            main_node.config.framing,
            max_buffer=main_node.config.max_recv_buffer,
        )
        self._task: Optional[asyncio.Task] = None
        # Set when the transport is known bad (send failure / backpressure
        # trip): stop() then force-aborts instead of draining gracefully.
        self._abort = False

        # Per-peer byte accounting (telemetry/): children resolved once per
        # connection, not per frame — .labels() is a dict lookup under a
        # lock and this is the transport hot path.
        self._m_bytes_sent = main_node._m_bytes_sent.labels(
            main_node.id, self.id)
        self._m_bytes_recv = main_node._m_bytes_recv.labels(
            main_node.id, self.id)

        self.main_node.debug_print(
            f"NodeConnection.send: Started with client ({self.id}) '{self.host}:{self.port}'"
        )

    # ------------------------------------------------------------------ send

    def compress(self, data: bytes, compression: str) -> Optional[bytes]:
        """Compress ``data``; returns ``None`` for an unknown algorithm.

        Behavior parity with [ref: nodeconnection.py:53-82] including the
        debug-printed compression ratio [ref: nodeconnection.py:80]; the codec
        wire format lives in :func:`wire.compress`.
        """
        self.main_node.debug_print(f"{self.id}:compress:{compression}")
        try:
            compressed = wire.compress(data, compression)
        except wire.UnknownCompressionError:
            self.main_node.debug_print(f"{self.id}:compress:Unknown compression")
            return None
        if data:
            ratio = int(10000 * len(compressed) / len(data)) / 100
            self.main_node.debug_print(f"{self.id}:compress:compression:{ratio}%")
        return compressed

    def decompress(self, compressed: bytes) -> bytes:
        """Decompress a tagged payload [ref: nodeconnection.py:84-105].

        The node's receive-buffer bound doubles as the decompression
        OUTPUT bound: a frame small enough to pass the framing decoder
        must not be allowed to expand past what the node would ever have
        accepted on the wire (amplification-bomb containment the
        reference lacks). A blob past the bound raises
        ``wire.DecompressionBombError``, which the recv loop counts as a
        receive error and drops — never a partial expansion, never
        compressed bytes delivered as if they were the message."""
        return wire.decompress(compressed,
                               max_output=self.main_node.config.max_recv_buffer)

    def parse_packet(self, packet: bytes) -> Union[str, dict, bytes]:
        """Decode one de-framed packet [ref: nodeconnection.py:167-184].

        Routes through ``self.decompress`` so subclasses overriding the codec
        (e.g. to add encryption) affect the receive path, as in the reference
        [ref: nodeconnection.py:171]. Under ``framing="length"`` the body
        carries an explicit compression flag byte instead of the sniffable
        trailing marker (wire.py), so arbitrary binary decodes intact."""
        if self.main_node.config.framing == "length":
            if packet[:1] == wire.LENGTH_COMPRESSED:
                return wire.decode_payload(self.decompress(packet[1:]))
            return wire.decode_payload(packet[1:])
        if packet.find(wire.COMPR_CHAR) == len(packet) - 1:
            packet = self.decompress(packet[:-1])
        return wire.decode_payload(packet)

    def send(self, data: Union[str, dict, bytes], encoding_type: Optional[str] = None,
             compression: str = "none") -> None:
        """Serialize, frame and queue ``data`` for transmission.

        Thread-safe: may be called from any thread (the write itself happens
        on the owning node's event loop). ``encoding_type`` defaults to the
        node's ``config.encoding`` (utf-8). Behavior parity with
        [ref: nodeconnection.py:107-160]:

        - str / dict / bytes dispatch (dict as JSON),
        - invalid payload type -> debug message only,
        - compression goes through ``self.compress`` so subclasses can
          override the codec, as in the reference [ref: nodeconnection.py:119];
          an unknown algorithm sends nothing (the reference's silent-drop,
          nodeconnection.py:120-121) but ``message_count_rerr`` is
          incremented (the reference defines that counter and never uses it,
          SURVEY.md section 2.3.7),
        - a transport failure closes the connection (the reference's
          close-on-failure policy, nodeconnection.py:123-126).
        """
        encoding = encoding_type or self.main_node.config.encoding
        try:
            raw = wire.encode_payload(data, encoding)
        except TypeError:
            self.main_node.debug_print(
                "datatype used is not valid please use str, dict (will be send as json) or bytes"
            )
            return
        except Exception as e:
            self.main_node.debug_print(f"nodeconnection send: Error encoding data: {e}")
            self.main_node._record_rerr()
            return
        if compression == "none":
            payload, is_compressed = raw, False
        else:
            blob = self.compress(raw, compression)
            if blob is None:
                self.main_node._record_rerr()
                return
            payload, is_compressed = blob, True
        try:
            frame = wire.wrap_frame(payload, self.main_node.config.framing,
                                    compressed=is_compressed)
        except ValueError as e:  # e.g. body beyond the 4-byte length prefix
            self.main_node.debug_print(f"nodeconnection send: {e}")
            self.main_node._record_rerr()
            return

        loop = self.main_node._loop
        if loop is None or loop.is_closed():
            self.main_node.debug_print("nodeconnection send: node is not running")
            return
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is loop:
            self._write(frame)
        else:
            try:
                loop.call_soon_threadsafe(self._write, frame)
            except RuntimeError:
                self.main_node.debug_print("nodeconnection send: node is not running")

    def _write(self, frame: bytes) -> None:
        """Write one frame on the event loop; failure closes the connection.

        Gates on transport state, not ``terminate_flag``: a send queued
        just before ``stop()`` must still flush during the graceful close
        (stop sets the flag synchronously, but this callback runs before
        stop's close callback on the same loop queue)."""
        if self._abort or self.writer.is_closing():
            return
        try:
            self.writer.write(frame)
            self._m_bytes_sent.inc(len(frame))
            # Backpressure bound: the reference's blocking sendall stalled the
            # sender when the peer stopped reading; asyncio buffers instead.
            # A peer that falls further behind than max_send_buffer is treated
            # as a failed transport (same close-on-failure policy).
            transport = self.writer.transport
            if (transport is not None
                    and transport.get_write_buffer_size() > self.main_node.config.max_send_buffer):
                raise BufferError(
                    f"peer is not reading: write buffer exceeds "
                    f"{self.main_node.config.max_send_buffer} bytes"
                )
        except Exception as e:
            self.main_node.debug_print(f"nodeconnection send: Error sending data to node: {e}")
            self.main_node._record_rerr()
            # Failed transports don't drain: a graceful close would wait on
            # the (possibly never-read) buffer forever, wedging the recv
            # task. Mark for force-abort, then apply the reference's
            # close-on-failure policy [ref: nodeconnection.py:123-126].
            self._abort = True
            self.stop()

    # ------------------------------------------------------- receive lifecycle

    def start(self) -> None:
        """Start the receive task on the owning node's event loop.

        Parity seam with ``thread_client.start()`` [ref: node.py:159, :249];
        callable from the loop itself or from another thread.
        """
        loop = self.main_node._loop
        if loop is None:
            raise RuntimeError("NodeConnection.start: owning node is not running")
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is loop:
            self._task = loop.create_task(self._recv_loop())
        else:
            fut = asyncio.run_coroutine_threadsafe(self._spawn(), loop)
            # Spawning a task is queue-bounded work; if it cannot complete
            # within the connect timeout the loop is wedged, and an
            # unbounded wait here would wedge the caller with it.
            timeout = self.main_node.config.connect_timeout + 1.0
            try:
                fut.result(timeout=timeout)
            except concurrent.futures.TimeoutError:
                fut.cancel()
                raise RuntimeError(
                    f"NodeConnection.start: owning node's event loop did "
                    f"not schedule the receive task within {timeout}s")

    async def _spawn(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._recv_loop())

    async def _recv_loop(self) -> None:
        """Receive chunks, de-frame, parse, deliver upward.

        The asyncio analog of the reference's thread main loop
        [ref: nodeconnection.py:186-229]: on EOF or error the connection is
        closed and ``main_node.node_disconnected(self)`` fires exactly once
        [ref: nodeconnection.py:228].
        """
        node = self.main_node
        try:
            while not self.terminate_flag.is_set():
                chunk = await self.reader.read(node.config.recv_chunk)
                if not chunk:  # EOF — peer closed
                    break
                self._m_bytes_recv.inc(len(chunk))
                try:
                    for packet in self._decoder.feed(chunk):
                        node._record_recv()  # [ref: nodeconnection.py:215]
                        t0 = time.perf_counter()
                        try:
                            node.node_message(self, self.parse_packet(packet))
                            node._m_handle.observe(time.perf_counter() - t0)
                        except Exception as e:
                            # Neither a crashing user handler nor a bad
                            # frame (DecompressionBombError included) may
                            # kill the transport (in the reference either
                            # kills the recv thread without cleanup); the
                            # frame is dropped and counted.
                            node._record_rerr()
                            node.debug_print(
                                f"parse/handler error, frame dropped: {e!r}")
                except wire.FrameOverflowError as e:
                    node._record_rerr()
                    node.debug_print(f"NodeConnection: {e}")
                    break
        except asyncio.CancelledError:
            pass
        except Exception as e:
            node.debug_print("Unexpected error")
            node.debug_print(str(e))
        finally:
            self.terminate_flag.set()
            try:
                self.writer.close()
            except Exception:
                pass
            node.node_disconnected(self)  # [ref: nodeconnection.py:228]
            node.debug_print("NodeConnection: Stopped")

    def stop(self) -> None:
        """Request connection termination [ref: nodeconnection.py:162-165].

        Thread-safe. Closing the transport wakes the receive task (its read
        returns EOF), which then runs the disconnect epilogue.
        """
        self.terminate_flag.set()
        loop = self.main_node._loop
        if loop is None or loop.is_closed():
            return

        def _close():
            try:
                transport = self.writer.transport
                if self._abort and transport is not None:
                    # The transport already failed (send error or
                    # max_send_buffer trip): a graceful close would wait
                    # for a buffer the peer is not draining, so the recv
                    # task would never see EOF. Drop the buffer and close.
                    transport.abort()
                else:
                    # Graceful: flush anything queued, then FIN — in-flight
                    # frames sent just before stop() still reach the peer.
                    self.writer.close()
            except Exception:
                pass

        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is loop:
            _close()
        else:
            try:
                loop.call_soon_threadsafe(_close)
            except RuntimeError:
                pass  # loop closed between the check and the post — idempotent

    async def wait_closed(self, timeout: float = 10.0) -> None:
        """Await full termination of the receive task (loop-side helper).

        Bounded: a peer that never drains our graceful close would
        otherwise pin the recv task (no EOF) and wedge ``Node.stop()``;
        past ``timeout`` the transport is force-aborted."""
        if self._task is None:
            return
        try:
            await asyncio.wait_for(asyncio.shield(self._task), timeout)
        except asyncio.TimeoutError:
            try:
                transport = self.writer.transport
                if transport is not None:
                    transport.abort()
            except Exception:
                pass
            try:
                await self._task
            except Exception:
                pass
        except Exception:
            pass

    # ------------------------------------------------------------------ info

    def set_info(self, key: str, value: Any) -> None:
        """Store auxiliary data on this connection [ref: nodeconnection.py:231]."""
        self.info[key] = value

    def get_info(self, key: str) -> Any:
        """Fetch auxiliary data from this connection [ref: nodeconnection.py:234]."""
        return self.info[key]

    # ------------------------------------------------------------------ repr

    def __str__(self) -> str:
        return "NodeConnection: {}:{} <-> {}:{} ({})".format(
            self.main_node.host, self.main_node.port, self.host, self.port, self.id
        )

    def __repr__(self) -> str:
        return "<NodeConnection: Node {}:{} <-> Connection {}:{}>".format(
            self.main_node.host, self.main_node.port, self.host, self.port
        )
