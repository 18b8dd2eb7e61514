"""Wire format of the sockets backend.

Byte-compatible with the reference implementation so that a tpu-p2p node can
interoperate with a live reference node on the same network:

- Frames are delimited by an EOT byte (``0x04``)
  [ref: p2pnetwork/nodeconnection.py:38].
- Compressed frames carry a trailing COMPR marker byte (``0x02``) just before
  the EOT [ref: nodeconnection.py:41, :121].
- A compressed payload is ``base64(compressed_bytes + algo_tag)`` where the
  tag is the literal suffix ``b'zlib'`` / ``b'bzip2'`` / ``b'lzma'``
  [ref: nodeconnection.py:63-70, :92-99].
- Payloads are ``str`` (utf-8), ``dict`` (JSON) or raw ``bytes``
  [ref: nodeconnection.py:114-156].
- Parse order on receive: strip + decompress if marked, try utf-8 decode, try
  JSON, fall back to str, fall back to raw bytes
  [ref: nodeconnection.py:167-184].

Everything in this module is a pure function (plus one small stateful stream
decoder) so the wire format is unit-testable without sockets.

Deliberate fixes over the reference (SURVEY.md section 2.3):
- empty frames (EOT at buffer position 0) are consumed instead of wedging the
  stream forever [ref bug: nodeconnection.py:211],
- the receive buffer is bounded; exceeding it raises ``FrameOverflowError``
  instead of growing without limit [ref bug: nodeconnection.py:206].

Inherited wire-format limitation (kept for interop): raw ``bytes`` payloads
containing the EOT byte ``0x04`` corrupt framing, exactly as in the
reference. Sending such payloads with ``compression=`` enabled is safe —
the base64 alphabet contains no control bytes. Deployments that do not need
reference interop can instead opt into ``framing="length"``
(``NodeConfig.framing``): 4-byte big-endian length prefix + one compression
flag byte + payload, which carries arbitrary binary safely — no delimiter to
corrupt and no marker byte to sniff (a raw payload may freely end in 0x02).
Both peers must use the same framing; the default stays ``"eot"``
(reference-compatible).
"""

from __future__ import annotations

import base64
import bz2
import json
import lzma
import zlib
from typing import Iterator, Optional, Union

Payload = Union[str, dict, list, bytes]

#: End-of-transmission frame delimiter [ref: nodeconnection.py:38].
EOT_CHAR = b"\x04"
#: Marker appended to compressed payloads [ref: nodeconnection.py:41].
COMPR_CHAR = b"\x02"

#: algorithm name -> (compress fn, wire tag suffix) [ref: nodeconnection.py:63-70]
_CODECS = {
    "zlib": (lambda raw: zlib.compress(raw, 6), b"zlib"),
    "bzip2": (bz2.compress, b"bzip2"),
    "lzma": (lzma.compress, b"lzma"),
}


class UnknownCompressionError(ValueError):
    """Raised when an unknown compression algorithm name is requested."""


class FrameOverflowError(RuntimeError):
    """Raised when the stream buffer exceeds its bound without an EOT."""


def compress(raw: bytes, algorithm: str) -> bytes:
    """Compress ``raw`` and tag it with the algorithm suffix, base64-encoded.

    Wire format parity: ``base64(compressed + tag)`` [ref:
    nodeconnection.py:63-70]. Unlike the reference (which returns ``None`` and
    silently sends nothing, nodeconnection.py:72-74), an unknown algorithm
    raises :class:`UnknownCompressionError` so callers can surface the error.
    """
    try:
        fn, tag = _CODECS[algorithm]
    except KeyError:
        raise UnknownCompressionError(
            f"unknown compression algorithm: {algorithm!r} "
            f"(choose from {sorted(_CODECS)} or 'none')"
        ) from None
    return base64.b64encode(fn(raw) + tag)


class DecompressionBombError(ValueError):
    """Decompressed output would exceed the caller's ``max_output`` bound.

    PROPAGATES out of :func:`decompress` (unlike codec failures, which
    fall back to the as-is contract): the caller asked for the bound, so
    containment must be observable — the sockets recv path catches it as
    a receive error (rerr) and drops the frame rather than delivering
    either a partial expansion or compressed bytes masquerading as the
    message."""


def _bounded_decompress(data: bytes, max_output: int, make,
                        multistream: bool) -> bytes:
    """Decompress with a hard output bound via incremental decompressors.

    Semantics parity with the unbounded stdlib functions: bz2/lzma
    concatenate multiple streams (``multistream=True``), zlib returns the
    first stream and ignores trailing bytes. A stream that ends before
    its end-of-stream marker raises EOFError — the same
    codec-failure class the unbounded path raises, so the caller's as-is
    fallback applies; only genuinely over-bound output raises
    :class:`DecompressionBombError`."""
    if max_output <= 0:
        # zlib's max_length=0 means UNLIMITED (bz2/lzma's means "0 bytes"):
        # a zero/negative bound must contain, not silently disable.
        raise DecompressionBombError(
            f"max_output must be positive, got {max_output}")
    out = b""
    while True:
        d = make()
        budget = max_output - len(out)
        chunk = d.decompress(data, max(budget, 0))
        out += chunk
        if not d.eof:
            if len(out) >= max_output:
                raise DecompressionBombError(
                    f"decompressed output exceeds {max_output} bytes")
            raise EOFError("compressed stream ended before end-of-stream")
        data = d.unused_data
        if not multistream or not data:
            return out


def decompress(blob: bytes, max_output: Optional[int] = None) -> bytes:
    """Base64-decode ``blob`` and decompress according to its tag suffix.

    Mirrors the reference's tag sniffing [ref: nodeconnection.py:92-99]: an
    unrecognised tag, or a codec failure, returns the b64-decoded bytes as-is
    [ref: nodeconnection.py:100-101]. Deliberate fix over the reference: its
    b64decode sits outside the try, so a malformed frame carrying the COMPR
    marker raises out of packet parsing [ref bug: nodeconnection.py:91];
    here bytes that aren't base64 at all come back unchanged, honoring the
    as-is contract.

    ``max_output`` bounds the DECOMPRESSED size — without it a ~100 KB
    frame (well inside any receive-buffer bound) can expand to gigabytes
    on the receiving host, an amplification the reference inherits
    unbounded [ref: nodeconnection.py:84-105] and the frame-size bound
    cannot see. Exceeding the bound raises
    :class:`DecompressionBombError` — observable, unlike codec failures,
    because silently delivering the compressed bytes as if they were the
    message would be indistinguishable from a real payload. ``None``
    keeps the historical unbounded behavior; the sockets backend passes
    its receive-buffer bound here (nodeconnection.py ``decompress``).
    """
    try:
        data = base64.b64decode(blob)
    except Exception:
        return blob
    try:
        if data[-4:] == b"zlib":
            if max_output is None:
                return zlib.decompress(data[:-4])
            return _bounded_decompress(data[:-4], max_output,
                                       zlib.decompressobj, False)
        if data[-5:] == b"bzip2":
            if max_output is None:
                return bz2.decompress(data[:-5])
            return _bounded_decompress(data[:-5], max_output,
                                       bz2.BZ2Decompressor, True)
        if data[-4:] == b"lzma":
            if max_output is None:
                return lzma.decompress(data[:-4])
            return _bounded_decompress(data[:-4], max_output,
                                       lzma.LZMADecompressor, True)
    except DecompressionBombError:
        raise
    except Exception:
        pass
    return data


def encode_payload(data: Payload, encoding: str = "utf-8") -> bytes:
    """Serialize a payload by type: str -> text, dict/list -> JSON, bytes raw.

    [ref: nodeconnection.py:114/128/145; JSON for dicts at :131]. Raises
    ``TypeError`` for unsupported types (the reference only debug-prints,
    nodeconnection.py:158-160; callers preserve that behavior at the
    connection layer).
    """
    if isinstance(data, str):
        return data.encode(encoding)
    if isinstance(data, (dict, list)):
        return json.dumps(data).encode(encoding)
    if isinstance(data, (bytes, bytearray)):
        return bytes(data)
    raise TypeError(
        "datatype used is not valid please use str, dict (will be send as "
        f"json) or bytes: got {type(data).__name__}"
    )


#: Length-framing body flag bytes. framing="length" is this framework's
#: own format with no reference compatibility to preserve, so compression
#: is an EXPLICIT leading flag — not the reference's sniffable trailing
#: marker, which silently eats a 0x02 that legitimately ends a raw
#: payload. Body layout (the one released layout of this mode): 1 flag
#: byte + payload; both peers must run the same framework version, as
#: with any non-interop wire format.
LENGTH_PLAIN = b"\x00"
LENGTH_COMPRESSED = b"\x01"


def wrap_frame(payload: bytes, framing: str = "eot",
               compressed: bool = False) -> bytes:
    """Wrap a serialized (and possibly compressed) payload for the wire —
    the single place framing rules, compression marking, and bounds
    checks live; used by :func:`encode_frame` and the connection send
    path alike. ``payload`` is the raw encoded bytes, or the b64 blob
    from :func:`compress` when ``compressed``."""
    if framing == "eot":
        if compressed:
            return payload + COMPR_CHAR + EOT_CHAR
        return payload + EOT_CHAR
    if framing == "length":
        body = (LENGTH_COMPRESSED if compressed else LENGTH_PLAIN) + payload
        if len(body) > 0xFFFFFFFF:
            raise ValueError("frame body exceeds the 4-byte length prefix")
        return len(body).to_bytes(4, "big") + body
    raise ValueError(f"unknown framing mode: {framing!r} "
                     f"(choose 'eot' or 'length')")


def encode_frame(
    data: Payload, encoding: str = "utf-8", compression: str = "none",
    framing: str = "eot",
) -> bytes:
    """Build one on-wire frame.

    ``framing="eot"`` (default): payload [+ COMPR] + EOT — byte-compatible
    with the reference [ref: nodeconnection.py:117 (plain) and :121
    (compressed)]. ``framing="length"``: 4-byte big-endian length prefix +
    flag byte + payload — safe for arbitrary binary (no delimiter to
    corrupt, no marker to sniff), NOT reference-compatible.
    """
    raw = encode_payload(data, encoding)
    if compression == "none":
        return wrap_frame(raw, framing, compressed=False)
    return wrap_frame(compress(raw, compression), framing, compressed=True)


def parse_length_body(body: bytes) -> Payload:
    """Decode one length-framed body (flag byte + payload) — the
    ``framing="length"`` counterpart of :func:`parse_packet`."""
    if body[:1] == LENGTH_COMPRESSED:
        return decode_payload(decompress(body[1:]))
    return decode_payload(body[1:])


def parse_packet(packet: bytes) -> Payload:
    """Decode one de-framed packet back into str / dict / bytes.

    Parse order parity [ref: nodeconnection.py:167-184]: a trailing COMPR
    marker means decompress first; then utf-8 decode; then JSON; falling back
    to the decoded str and finally the raw bytes.
    """
    # Parity: the reference treats a packet as compressed only when the FIRST
    # 0x02 is the last byte [ref: nodeconnection.py:170] — endswith() would
    # misfire on raw-bytes payloads containing an interior 0x02.
    if packet.find(COMPR_CHAR) == len(packet) - 1:
        packet = decompress(packet[:-1])
    return decode_payload(packet)


def decode_payload(packet: bytes) -> Payload:
    """The utf-8 -> JSON -> str -> bytes fallback chain on decompressed bytes
    [ref: nodeconnection.py:173-184]."""
    try:
        text = packet.decode("utf-8")
    except UnicodeDecodeError:
        return packet
    try:
        return json.loads(text)
    except ValueError:
        # JSONDecodeError, but also e.g. the int-digit-limit ValueError that
        # json.loads raises for absurdly long numeric strings.
        return text


class FrameDecoder:
    """Incremental EOT-delimited stream decoder with a bounded buffer.

    Replaces the reference's inline buffer scan [ref: nodeconnection.py:206-218]
    with two deliberate fixes (SURVEY.md section 2.3.2/2.3.3): empty frames are
    consumed (an EOT at position 0 no longer wedges the stream), and the buffer
    is bounded by ``max_buffer`` bytes.
    """

    def __init__(self, max_buffer: int = 64 * 1024 * 1024):
        self.max_buffer = max_buffer
        self._buffer = b""

    def feed(self, chunk: bytes) -> Iterator[bytes]:
        """Feed a received chunk; yield each complete (de-framed) packet."""
        if not chunk:
            return
        self._buffer += chunk
        start = 0
        try:
            while True:
                eot = self._buffer.find(EOT_CHAR, start)
                if eot < 0:
                    break
                yield self._buffer[start:eot]
                start = eot + 1
        finally:
            if start:
                self._buffer = self._buffer[start:]
        if len(self._buffer) > self.max_buffer:
            overflow = len(self._buffer)
            self._buffer = b""
            raise FrameOverflowError(
                f"receive buffer exceeded {self.max_buffer} bytes "
                f"({overflow} buffered) without an EOT delimiter"
            )

    @property
    def pending(self) -> int:
        """Number of buffered bytes not yet terminated by an EOT."""
        return len(self._buffer)


class LengthFrameDecoder:
    """Incremental length-prefixed stream decoder (``framing="length"``).

    Same ``feed``/``pending`` surface as :class:`FrameDecoder`, so the
    connection layer swaps decoders without caring which framing is active.
    A declared frame length beyond ``max_buffer`` is rejected immediately
    (:class:`FrameOverflowError`) — a malicious 4 GiB header cannot make the
    receiver buffer it first.
    """

    _HEADER = 4

    def __init__(self, max_buffer: int = 64 * 1024 * 1024):
        self.max_buffer = max_buffer
        self._buffer = b""

    def feed(self, chunk: bytes) -> Iterator[bytes]:
        """Feed a received chunk; yield each complete frame body."""
        if not chunk:
            return
        self._buffer += chunk
        while len(self._buffer) >= self._HEADER:
            body_len = int.from_bytes(self._buffer[:self._HEADER], "big")
            # Header-inclusive bound: buffered bytes never exceed
            # max_buffer, exactly as advertised.
            if body_len > self.max_buffer - self._HEADER:
                self._buffer = b""
                raise FrameOverflowError(
                    f"declared frame length {body_len} exceeds the "
                    f"{self.max_buffer}-byte receive bound"
                )
            end = self._HEADER + body_len
            if len(self._buffer) < end:
                break
            yield self._buffer[self._HEADER:end]
            self._buffer = self._buffer[end:]

    @property
    def pending(self) -> int:
        """Number of buffered bytes not yet forming a complete frame."""
        return len(self._buffer)


def make_decoder(framing: str, max_buffer: int = 64 * 1024 * 1024):
    """Decoder for a framing mode: ``"eot"`` or ``"length"``."""
    if framing == "eot":
        return FrameDecoder(max_buffer=max_buffer)
    if framing == "length":
        return LengthFrameDecoder(max_buffer=max_buffer)
    raise ValueError(f"unknown framing mode: {framing!r} "
                     f"(choose 'eot' or 'length')")
