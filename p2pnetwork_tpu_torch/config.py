"""Typed configuration for both backends.

The reference has no config system at all — configuration is six constructor
parameters plus two mutable attributes [ref: p2pnetwork/node.py:32, :70-73]
(SURVEY.md section 5 "Config / flag system"). We keep that ethos: small typed
dataclasses with defaults chosen for parity, no argparse/env/yaml machinery.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class NodeConfig:
    """Tunables of the sockets backend (defaults = reference behavior)."""

    #: Bytes per receive call [ref: nodeconnection.py:196].
    recv_chunk: int = 4096
    #: Bound on the un-framed receive buffer (fixes SURVEY section 2.3.3;
    #: the reference buffer is unbounded, nodeconnection.py:206).
    max_recv_buffer: int = 64 * 1024 * 1024
    #: Bound on the per-connection outbound write buffer. The reference's
    #: blocking sendall gave natural backpressure; under asyncio a peer that
    #: stops reading would otherwise buffer without limit. Exceeding the
    #: bound closes the connection (same policy as a send failure).
    max_send_buffer: int = 16 * 1024 * 1024
    #: TCP connect + handshake timeout [ref: 10 s socket timeouts,
    #: node.py:97, nodeconnection.py:47].
    connect_timeout: float = 10.0
    #: Seconds between reconnect-registry checks. The reference piggybacks the
    #: check on every accept-loop tick [ref: node.py:265]; a dedicated timer is
    #: the event-loop equivalent. This is the tick FLOOR: per-entry
    #: exponential backoff (below) decides which entries actually retry on
    #: a given tick.
    reconnect_interval: float = 0.5
    #: First-retry delay of the per-entry reconnect backoff. The reference
    #: retries every dead peer at the fixed tick cadence forever; here each
    #: entry backs off with decorrelated jitter — delay_{n+1} drawn uniform
    #: from [base, 3 * delay_n], capped — so a fleet reconnecting after a
    #: peer restart does not stampede it in lockstep.
    reconnect_backoff_base: float = 0.5
    #: Cap on the per-entry backoff delay.
    reconnect_backoff_max: float = 30.0
    #: Listen backlog [ref: listen(1), node.py:98 — raised here deliberately].
    listen_backlog: int = 16
    #: Default text encoding for str/dict payloads.
    encoding: str = "utf-8"
    #: Frame delimiting: "eot" (reference-compatible 0x04 delimiter; raw
    #: bytes containing 0x04 corrupt framing, wire.py) or "length"
    #: (4-byte length prefix — safe for arbitrary binary, both peers must
    #: opt in; no reference interop).
    framing: str = "eot"

    def __post_init__(self):
        # Fail at construction, not deep inside per-connection setup where
        # the error would surface as a generic connection failure.
        if self.framing not in ("eot", "length"):
            raise ValueError(
                f"unknown framing mode: {self.framing!r} "
                f"(choose 'eot' or 'length')"
            )
        if self.reconnect_backoff_base <= 0:
            raise ValueError("reconnect_backoff_base must be positive")
        if self.reconnect_backoff_max < self.reconnect_backoff_base:
            raise ValueError(
                "reconnect_backoff_max must be >= reconnect_backoff_base")


@dataclasses.dataclass
class TopologyConfig:
    """Which random graph to build (see sim/graph.py generators)."""

    kind: str = "watts_strogatz"  # erdos_renyi | barabasi_albert | watts_strogatz | ring | chord | kademlia | complete
    n_nodes: int = 1024
    #: erdos_renyi: edge probability; watts_strogatz: rewire probability.
    p: float = 0.01
    #: barabasi_albert: edges per new node; watts_strogatz: ring degree;
    #: kademlia: bucket width.
    k: int = 10
    seed: int = 0


#: Valid MeshConfig.comm values — parallel/sharded.COMM_BACKENDS plus
#: "auto". A literal on purpose (config stays importable without jax);
#: pinned equal to sharded's tuple by tests/test_ring.py.
COMM_CHOICES = ("ppermute", "pallas", "auto")


@dataclasses.dataclass
class MeshConfig:
    """TPU mesh layout for the sharded propagation path.

    ``shards`` is the number of graph partitions laid out along the ring
    (axis name ``"shards"``); cross-shard edges resolve via ppermute rotation
    over that axis (ICI-friendly; see parallel/sharded.py).
    """

    shards: int = 1
    axis_name: str = "shards"
    #: Halo-exchange backend of the ring path: "ppermute" (XLA
    #: collective-permute), "pallas" (async remote-copy DMA kernels,
    #: ops/pallas_ring.py — overlaps the ICI hop with shard-local
    #: propagation), or "auto" (pallas on TPU, ppermute elsewhere —
    #: parallel/auto.resolve_comm).
    comm: str = "ppermute"

    def __post_init__(self):
        if self.comm not in COMM_CHOICES:
            raise ValueError(
                f"unknown comm backend: {self.comm!r} "
                f"(choose one of {COMM_CHOICES})")


@dataclasses.dataclass
class SimConfig:
    """One simulation run = topology + protocol + schedule + mesh."""

    topology: TopologyConfig = dataclasses.field(default_factory=TopologyConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    #: Maximum rounds to run (static bound for lax.scan / while_loop).
    max_rounds: int = 64
    #: Stop when this fraction of nodes has been covered (flood) — device-side
    #: early exit via lax.while_loop.
    coverage_target: float = 0.99
    seed: int = 0
