"""Fault-injecting proxies for one ``NodeConnection`` stream pair.

The chaos plane never touches protocol code: ``ChaosPlane.attach`` wraps the
``(StreamReader, StreamWriter)`` pair at the ``create_new_connection``
factory seam [ref: p2pnetwork/node.py:196-201], so every byte a connection
reads or writes flows through these two proxies. Anything not explicitly
intercepted delegates to the wrapped stream (``__getattr__``), which keeps
``NodeConnection``'s transport bookkeeping (``is_closing``, write-buffer
size, ``transport.abort``) working unchanged.

Fault placement is deliberately asymmetric:

- **frame faults** (drop / duplicate / corrupt) live on the WRITE side,
  because ``NodeConnection._write`` issues exactly one ``write()`` per
  frame — so the faults are frame-aligned and their schedule is a pure
  function of ``(seed, src, dst, frame index)``;
- **time faults** (added latency, bandwidth throttle, slow-drain stall)
  live on the READ side, where the coroutine can ``await asyncio.sleep``
  without reordering writes;
- **severed links** (killed endpoint, cut link, partition) blackhole
  writes and turn the next read into EOF, which drives the connection
  through the normal death path (``node_disconnected`` fires, reconnect
  and quarantine logic take over) — chaos exercises the same recovery
  machinery a real failure would.
"""

from __future__ import annotations

import asyncio


class ChaosWriter:
    """StreamWriter proxy applying seeded frame faults on the send side.

    Each delivered frame consumes exactly four draws from the per-stream
    RNG (drop, duplicate, corrupt, corrupt-position), whether or not any
    frame fault is armed — so the fault schedule for frame ``i`` depends
    only on ``(seed, src, dst, i)``, never on which faults were active
    earlier. Blackholed frames (severed link) consume no draws: they are
    timing-dependent and must not shift the schedule of the frames that
    do get through.
    """

    def __init__(self, plane, node_id: str, peer_id: str, writer,
                 framing: str = "eot"):
        self._plane = plane
        self._node_id = node_id
        self._peer_id = peer_id
        self._writer = writer
        self._rng = plane._stream_rng(node_id, peer_id, "send")
        self._frame_idx = 0
        # Corruptable byte range depends on the frame layout (wire.py):
        # "eot" frames are payload + trailing delimiter (spare the last
        # byte); "length" frames are 4-byte length prefix + compression
        # flag + payload (spare the first five — corrupting the prefix
        # would desync or tear down the stream instead of damaging one
        # payload, and the flag byte never reaches the application).
        self._framing = framing
        self._corrupt_lo = 5 if framing == "length" else 0
        self._corrupt_hi_off = 0 if framing == "length" else 1

    def write(self, data: bytes) -> None:
        plane = self._plane
        if not plane.link_ok(self._node_id, self._peer_id):
            # Severed link: blackhole silently. The read side reports the
            # EOF; counting these would make counters timing-dependent.
            return
        idx = self._frame_idx
        self._frame_idx += 1
        r_drop, r_dup, r_corrupt, r_pos = (self._rng.random(),
                                           self._rng.random(),
                                           self._rng.random(),
                                           self._rng.random())
        drop_p, dup_p, corrupt_p = plane.frame_fault_probs()
        if r_drop < drop_p:
            # Drop decides first: a dropped frame must not also count a
            # corruption that never reached the wire (per-frame kinds
            # count APPLIED faults). The draws above happen regardless,
            # so the seeded schedule is unaffected by fault ordering.
            plane._fault_applied("drop", self._node_id, self._peer_id, idx)
            return
        span = len(data) - self._corrupt_hi_off - self._corrupt_lo
        if r_corrupt < corrupt_p and span > 0:
            # Flip one PAYLOAD byte (framing metadata is spared, see
            # __init__) so the corruption surfaces as a decode error /
            # wrong payload on the peer (counted there as rerr), not as
            # a desynced or wedged stream.
            pos = self._corrupt_lo + int(r_pos * span)
            flipped = data[pos] ^ 0x5A
            if self._framing == "eot" and flipped == 0x04:
                # 0x5E would flip INTO the EOT delimiter and split the
                # frame in two; a fallback mask keeps the damage inside
                # one payload (0x5E ^ 0x25 = 0x7B, never 0x04).
                flipped = data[pos] ^ 0x25
            data = data[:pos] + bytes([flipped]) + data[pos + 1:]
            plane._fault_applied("corrupt", self._node_id, self._peer_id, idx)
        self._writer.write(data)
        if r_dup < dup_p:
            plane._fault_applied("duplicate", self._node_id, self._peer_id, idx)
            self._writer.write(data)

    def __getattr__(self, name):
        return getattr(self._writer, name)


class ChaosReader:
    """StreamReader proxy applying time faults and severed-link EOF."""

    def __init__(self, plane, node_id: str, peer_id: str, reader):
        self._plane = plane
        self._node_id = node_id
        self._peer_id = peer_id
        self._reader = reader
        self._rng = plane._stream_rng(node_id, peer_id, "recv")

    async def read(self, n: int = -1) -> bytes:
        plane = self._plane
        if not plane.link_ok(self._node_id, self._peer_id):
            return b""  # severed: the connection sees a clean EOF
        stall = plane.slow_drain_stall(self._node_id)
        if stall > 0:
            # Slow-drain peer: this node stops draining its sockets, so
            # the SENDER's write buffer grows until its max_send_buffer
            # backpressure bound trips — the fault is observed remotely.
            await asyncio.sleep(stall)
        chunk = await self._reader.read(n)
        if not chunk:
            return chunk
        delay = plane.recv_delay(len(chunk), self._rng)
        if delay > 0:
            await asyncio.sleep(delay)
        if not plane.link_ok(self._node_id, self._peer_id):
            return b""  # link severed while the chunk was in flight
        return chunk

    def __getattr__(self, name):
        return getattr(self._reader, name)
