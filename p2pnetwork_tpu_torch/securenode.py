"""SecureNode: signed, integrity-checked messaging on top of ``Node``.

The reference README advertises a ``SecureNode`` showcase ("uses JSON,
hashing and signing to communicate between the nodes",
[ref: README.md:224-238]) and its examples directory describes the design:
"All nodes have a private/public key and signs all the messages they send.
These messages are also verified... checked on integrity and
non-repudiation" [ref: examples/README.md:10-16]. The class itself is
absent from the reference snapshot (SURVEY.md section 2.2, documented-but-
absent) — this module actually ships it.

Design (new, not a port — the reference's showcase used pycryptodome RSA):

- Every node holds an Ed25519 keypair; the public key travels with each
  message, so receivers verify without any key exchange protocol.
- The envelope is a plain dict (so it rides the existing dict wire path,
  JSON + EOT framing [ref: nodeconnection.py:128-143]):
  ``{"_secure": 1, "scheme": ..., "payload": ..., "hash": sha512-hex,
  "signature": hex, "public_key": hex, "signer": node-id, "nonce": hex}``
- ``hash`` covers the canonical JSON of ``(payload, signer, nonce)``;
  the signature covers the hash. Tampering with any of payload, claimed
  signer id, or nonce invalidates the message.
- **Signer identity is bound to a key by pinning.** A traveling key alone
  proves nothing (anyone can sign "alice"'s messages with their own key),
  so receivers hold a ``signer id -> public key`` table: pre-pin with
  :meth:`trust_key` (out-of-band distribution — the strong mode), or rely
  on the default trust-on-first-use (the first verified envelope from a
  signer pins its key; later envelopes under a different key are
  rejected). The verified key is handed to the ``secure_message`` hook so
  applications can enforce stricter policies.
- **Replay protection**: each verified (signer, nonce) pair is remembered
  in a bounded window (``replay_window``, drop-oldest); a captured envelope
  re-sent inside the window is rejected as ``"replayed nonce"``.
  Applications needing protection beyond the window should timestamp their
  payloads.
- Valid messages fire the ``secure_message`` hook (and the ``"secure_message"``
  callback event); invalid ones fire ``secure_message_invalid``, count into
  ``message_count_rerr``, and are never delivered as payload.

Ed25519 comes from the ``cryptography`` package when available; otherwise
SecureNode falls back to HMAC-SHA512 with a shared ``network_key`` (still
integrity-checked, no longer third-party-verifiable — the fallback is
explicit in ``self.scheme``).
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
from typing import Any, Callable, Optional

from p2pnetwork_tpu_torch.node import Node

try:  # asymmetric path (preferred): Ed25519 via `cryptography`
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )

    _HAVE_ED25519 = True
except ImportError:  # pragma: no cover - exercised only without cryptography
    _HAVE_ED25519 = False

import hmac as _hmac


def canonical_json(data: Any) -> bytes:
    """Deterministic JSON bytes: sorted keys, no whitespace."""
    return json.dumps(data, sort_keys=True, separators=(",", ":")).encode("utf-8")


def payload_digest(payload: Any, signer: str, nonce: str) -> str:
    """SHA-512 hex over the canonical (payload, signer, nonce) triple."""
    body = canonical_json({"payload": payload, "signer": signer, "nonce": nonce})
    return hashlib.sha512(body).hexdigest()


class SecureNode(Node):
    """A :class:`Node` whose dict messages are signed and verified.

    Extra hooks beyond the base ten-event vocabulary:

    - ``secure_message(node, payload, signer_id, public_key_hex)`` — a
      verified message (callback event ``"secure_message"``).
    - ``secure_message_invalid(node, envelope, reason)`` — failed
      verification (callback event ``"secure_message_invalid"``); also
      increments ``message_count_rerr``.

    Non-envelope messages still reach the plain ``node_message`` hook, so a
    SecureNode can talk to plain nodes (their traffic is just unverified).
    """

    def __init__(self, host: str, port: int, id: Optional[str] = None,
                 callback: Optional[Callable] = None, max_connections: int = 0,
                 private_key: Optional[bytes] = None,
                 network_key: Optional[bytes] = None, **kw):
        # Key setup first: a key error must not leave a bound socket behind.
        if _HAVE_ED25519:
            self.scheme = "ed25519"
            self._private = (
                Ed25519PrivateKey.from_private_bytes(private_key)
                if private_key is not None else Ed25519PrivateKey.generate()
            )
            self._public_hex = self._private.public_key().public_bytes_raw().hex()
        else:
            self.scheme = "hmac-sha512"
            if network_key is None:
                raise ValueError(
                    "without the `cryptography` package SecureNode needs a "
                    "shared network_key for the HMAC fallback"
                )
            self._network_key = network_key
            self._public_hex = ""
        # Pinned signer id -> public key hex (see trust_key / TOFU).
        # Explicitly trusted pins are never evicted; TOFU-learned entries
        # are bounded (oldest-learned evicted) — without a cap any peer
        # could mint signer ids until memory runs out.
        self.known_keys: dict = {}
        self.max_known_keys = 65536
        self._explicit_pins: set = set()
        # Replay window: the most recent verified nonces per signer. A
        # captured envelope re-sent within the window is rejected; the
        # window is bounded (drop-oldest), so indefinite storage is not
        # required and very old replays are an application-level concern
        # (e.g. timestamp payloads if that matters).
        self.replay_window = 4096
        # Signer entries are themselves bounded (FIFO eviction): under
        # TOFU any peer can mint fresh signer ids, and an unbounded
        # signer->window dict would be a memory-exhaustion vector.
        self.max_tracked_signers = 1024
        self._seen_nonces: dict = {}  # signer -> (set, deque), insertion-ordered
        super().__init__(host, port, id=id, callback=callback,
                         max_connections=max_connections, **kw)
        if self.scheme == "ed25519":
            self.known_keys[self.id] = self._public_hex
            self._explicit_pins.add(self.id)  # own key is never evicted

    def trust_key(self, signer_id: str, public_key_hex: str) -> None:
        """Pin ``signer_id`` to a public key (out-of-band distribution).

        Envelopes claiming that signer under any other key are rejected.
        Explicit pins are permanent (never evicted from the bounded TOFU
        table). Without a pin, the first verified envelope pins its key
        (trust-on-first-use)."""
        self.known_keys[str(signer_id)] = public_key_hex
        self._explicit_pins.add(str(signer_id))

    def _tofu_pin(self, signer: str, public_key_hex: str) -> None:
        """Learn a key on first use, evicting the oldest learned (never an
        explicitly trusted) entry when the table is full."""
        if len(self.known_keys) >= self.max_known_keys:
            for k in self.known_keys:
                if k not in self._explicit_pins:
                    del self.known_keys[k]
                    break
        self.known_keys[signer] = public_key_hex

    # ------------------------------------------------------------------ keys

    @property
    def public_key_hex(self) -> str:
        """This node's public key (hex), empty under the HMAC fallback."""
        return self._public_hex

    def _sign(self, digest_hex: str) -> str:
        if self.scheme == "ed25519":
            return self._private.sign(digest_hex.encode()).hex()
        return _hmac.new(self._network_key, digest_hex.encode(),
                         hashlib.sha512).hexdigest()

    def _verify(self, digest_hex: str, signature_hex: str,
                public_key_hex: str) -> bool:
        if self.scheme == "ed25519":
            try:
                pub = Ed25519PublicKey.from_public_bytes(bytes.fromhex(public_key_hex))
                pub.verify(bytes.fromhex(signature_hex), digest_hex.encode())
                return True
            except Exception:
                return False
        if not isinstance(signature_hex, str):
            return False  # compare_digest raises on non-str; a forgery must
            # count as invalid, not crash the verification path
        expect = _hmac.new(self._network_key, digest_hex.encode(),
                           hashlib.sha512).hexdigest()
        return _hmac.compare_digest(expect, signature_hex)

    # ------------------------------------------------------------------ send

    def make_envelope(self, payload: Any) -> dict:
        """Sign ``payload`` into a self-verifying envelope dict."""
        nonce = os.urandom(16).hex()
        digest = payload_digest(payload, self.id, nonce)
        return {
            "_secure": 1,
            "scheme": self.scheme,
            "payload": payload,
            "signer": self.id,
            "nonce": nonce,
            "hash": digest,
            "signature": self._sign(digest),
            "public_key": self._public_hex,
        }

    def send_to_nodes_signed(self, payload: Any, exclude=None,
                             compression: str = "none") -> None:
        """Broadcast a signed payload (JSON-representable data)."""
        self.send_to_nodes(self.make_envelope(payload), exclude=exclude,
                           compression=compression)

    def send_to_node_signed(self, peer, payload: Any,
                            compression: str = "none") -> None:
        """Unicast a signed payload to one connected peer."""
        self.send_to_node(peer, self.make_envelope(payload),
                          compression=compression)

    # --------------------------------------------------------------- receive

    def check_envelope(self, envelope: Any) -> Optional[str]:
        """Return None when the envelope verifies, else the failure reason.

        Verification = scheme match, hash integrity, signature validity
        under the embedded key, and signer-to-key binding (pinned or TOFU).
        A verified first-seen signer gets its key pinned here.
        """
        if not isinstance(envelope, dict) or envelope.get("_secure") != 1:
            return "not a secure envelope"
        for field in ("payload", "signer", "nonce", "hash", "signature"):
            if field not in envelope:
                return f"missing field {field!r}"
        if not isinstance(envelope["nonce"], str):
            # A list nonce is JSON-legal and would verify, but an unhashable
            # nonce must read as invalid, not blow up the replay tracking.
            return "nonce must be a string"
        scheme = envelope.get("scheme", "ed25519")
        if scheme != self.scheme:
            return f"scheme mismatch: envelope {scheme}, local {self.scheme}"
        digest = payload_digest(envelope["payload"], envelope["signer"],
                                envelope["nonce"])
        if digest != envelope["hash"]:
            return "hash mismatch"
        public_key = envelope.get("public_key", "")
        if not self._verify(digest, envelope["signature"], public_key):
            return "bad signature"
        signer = str(envelope["signer"])
        if self.scheme == "ed25519":
            pinned = self.known_keys.get(signer)
            if pinned is None:
                self._tofu_pin(signer, public_key)  # trust-on-first-use
            elif pinned != public_key:
                return f"key mismatch for signer {signer!r}"
        if not self._record_nonce(signer, envelope["nonce"]):
            return "replayed nonce"
        return None

    def _record_nonce(self, signer: str, nonce) -> bool:
        """Track ``nonce`` in the signer's replay window; False if seen.

        Signer entries are evicted least-recently-ACTIVE (each accepted
        message refreshes its signer), so flushing a victim's window by
        minting fresh signers requires outpacing the victim's own traffic
        — plain FIFO would let one burst of new ids evict an active signer
        and reopen replays of its captured envelopes.
        """
        entry = self._seen_nonces.pop(signer, None)
        if entry is None:
            while len(self._seen_nonces) >= self.max_tracked_signers:
                self._seen_nonces.pop(next(iter(self._seen_nonces)))
            entry = (set(), collections.deque())
        self._seen_nonces[signer] = entry  # (re)insert at the fresh end
        seen, order = entry
        if nonce in seen:
            return False
        seen.add(nonce)
        order.append(nonce)
        if len(order) > self.replay_window:
            seen.discard(order.popleft())
        return True

    def node_message(self, node, data) -> None:
        """Route envelopes through verification; pass other traffic through."""
        if isinstance(data, dict) and data.get("_secure") == 1:
            reason = self.check_envelope(data)
            if reason is None:
                self.secure_message(node, data["payload"], data["signer"],
                                    data.get("public_key", ""))
            else:
                self.message_count_rerr += 1
                self.secure_message_invalid(node, data, reason)
            return
        super().node_message(node, data)

    # ----------------------------------------------------------------- hooks

    def secure_message(self, node, payload, signer_id: str,
                       public_key_hex: str = "") -> None:
        """A verified signed message arrived. Override me."""
        self.debug_print(f"secure_message from {signer_id}: {payload}")
        self.event_log.record("secure_message", peer_id=getattr(node, "id", None),
                              data=payload)
        if self.callback is not None:
            self.callback("secure_message", self, node, payload)

    def secure_message_invalid(self, node, envelope, reason: str) -> None:
        """A signed message failed verification. Override me."""
        self.debug_print(f"secure_message_invalid: {reason}")
        self.event_log.record("secure_message_invalid",
                              peer_id=getattr(node, "id", None), data=reason)
        if self.callback is not None:
            self.callback("secure_message_invalid", self, node, envelope)
