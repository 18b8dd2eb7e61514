"""TorchSimNode — the bridge between the Node extension API and the port's
simulation (its counterpart of ``p2pnetwork_tpu/sim/simnode.py``'s
``JaxSimNode``).

A ``Node`` subclass on the same extend-or-callback seam as every other
node, whose "peers" are a simulated population on the card instead of
socket threads. It is still a real sockets node (the port's own copy of
``node.py``): it binds a port, accepts connections and can broadcast to
live peers; its population-scale traffic happens as batched graph
propagation.

The bridge is the reference's: socket peers deliver asynchronous
per-message callbacks, the population advances in synchronous rounds, and
events about the population arrive through the standard ``node_message``
hook with a :class:`SimPeer` as the connected node and one dict per
completed round, so callback applications observe the simulation with no
new API. The events, summaries and checkpoint files are the reference's:
a checkpoint written by either package loads in the other.

The population runs on the graph's device (the mesh's on the ring). Its
events fire on the thread that drives the simulation, never on the
node's socket loop thread, so no callback of the loop touches a device
tensor.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from p2pnetwork_tpu_torch import prng
from p2pnetwork_tpu_torch.models.flood import Flood
from p2pnetwork_tpu_torch.models.gossip import Gossip
from p2pnetwork_tpu_torch.models.hopdist import HopDistance
from p2pnetwork_tpu_torch.models.pagerank import PageRank
from p2pnetwork_tpu_torch.models.pushsum import PushSum
from p2pnetwork_tpu_torch.models.sir import SIR
from p2pnetwork_tpu_torch.node import Node
from p2pnetwork_tpu_torch.parallel import sharded
from p2pnetwork_tpu_torch.sim import checkpoint as ckpt
from p2pnetwork_tpu_torch.sim import engine, failures, topology
from p2pnetwork_tpu_torch.sim.graph import Graph


def _host(v) -> np.ndarray:
    """A stat or summary value as numpy (one transfer for a tensor)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class SimPeer:
    """Stand-in for ``NodeConnection`` representing the simulated population.

    Carries the connection surface events expose (``id``, ``host``, ``port``,
    ``info``, ``set_info/get_info``) so callbacks written against socket
    peers work unchanged. ``send`` is a debug no-op: messages enter the
    simulation through protocol state, not a socket."""

    def __init__(self, main_node: Node, n_nodes: int):
        self.main_node = main_node
        self.id = f"sim:{n_nodes}-nodes"
        self.host = "hbm"
        self.port = 0
        self.info: dict = {}

    def send(self, data, encoding_type=None, compression="none") -> None:
        self.main_node.debug_print(
            "SimPeer.send: the simulated population is driven by protocol "
            "state, not socket sends"
        )

    def stop(self) -> None:  # parity surface; nothing to stop
        pass

    def set_info(self, key: str, value: Any) -> None:
        self.info[key] = value

    def get_info(self, key: str) -> Any:
        return self.info[key]

    def __str__(self) -> str:
        return f"SimPeer({self.id})"

    __repr__ = __str__


class TorchSimNode(Node):
    """A ``Node`` whose population-scale peers live on the card.

    Usage::

        node = TorchSimNode("127.0.0.1", 0, graph=g, protocol=Flood(source=0))
        node.start()                  # normal sockets lifecycle
        stats = node.run_rounds(10)   # 10 batched propagation rounds
        node.stop(); node.join()

    Pass ``mesh=parallel.mesh.ring_mesh(S)`` to run the population on the
    ring (``parallel/sharded.py``, every shard on one card): the same
    events and stepping, churn, link and checkpoint methods, on the
    sharded representation, for Flood, SIR, Gossip, HopDistance, PageRank
    and PushSum as the reference's backend dispatches them. There
    ``adaptive_k > 0`` (Flood and HopDistance) shards the graph with its
    sender-CSR view and runs ``run_until_coverage`` through the ring's
    frontier-adaptive loop, with the same results.

    Each completed round fires ``node_message`` with ``{"sim_round": r,
    **round_stats}``. ``sim_message_count`` accumulates the simulated
    message volume; the socket counters stay reserved for socket traffic.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 graph: Optional[Graph] = None, protocol=None, seed: int = 0,
                 mesh=None, dynamic_edges: int = 0, rng: Optional[str] = None,
                 layout: str = "hybrid", adaptive_k: int = 0,
                 **node_kwargs):
        super().__init__(host, port, **node_kwargs)
        self.sim_graph: Optional[Graph] = None
        self.sim_protocol = None
        self.sim_state = None
        self.sim_round = 0
        self.sim_message_count = 0
        self.sim_peer: Optional[SimPeer] = None
        self.sim_mesh = None
        self.sim_sharded = None
        self._sim_rng: Optional[str] = None
        self._sim_key: Optional[np.ndarray] = None
        self._sim_adaptive_k = 0
        self._churn_count = 0
        if graph is not None and protocol is not None:
            self.attach_simulation(graph, protocol, seed=seed, mesh=mesh,
                                   dynamic_edges=dynamic_edges, rng=rng,
                                   layout=layout, adaptive_k=adaptive_k)

    # ------------------------------------------------------------- plumbing

    def attach_simulation(self, graph: Graph, protocol, seed: int = 0,
                          mesh=None, dynamic_edges: int = 0,
                          rng: Optional[str] = None,
                          layout: str = "hybrid",
                          adaptive_k: int = 0) -> None:
        """Attach (or replace) the simulated population.

        ``mesh`` switches the node onto the ring (``parallel/sharded.py``):
        the population is partitioned over its shards and every stepping,
        churn and checkpoint operation below drives the sharded
        representation. There ``sim_graph`` stays the pristine attach-time
        build (the template of checkpoints); the live topology is
        ``sim_sharded``, read through ``sim_node_alive``.
        ``dynamic_edges`` reserves runtime link capacity on the sharded
        graph; ``layout`` picks its edge layout, ``'hybrid'``, ``'mxu'``
        or ``'segment'`` (all exact). ``rng`` is the reference's sharded
        RNG mode, which only the ring's keyed protocols read.
        ``adaptive_k > 0`` (mesh only; Flood and HopDistance) also builds
        the sender-CSR view and runs ``run_until_coverage`` through the
        ring's frontier-adaptive loop (the same results).
        """
        if layout not in ("hybrid", "mxu", "segment"):
            raise ValueError(
                f"layout must be 'hybrid', 'mxu' or 'segment', got "
                f"{layout!r}"
            )
        if adaptive_k > 0:
            if mesh is None:
                raise ValueError(
                    "adaptive_k drives the mesh backend's coverage loop; "
                    "on the single-device backend use "
                    "protocol=AdaptiveFlood(...) on a source_csr=True graph"
                )
            if not isinstance(protocol, (Flood, HopDistance)):
                raise ValueError(
                    f"adaptive_k applies to Flood and HopDistance on the "
                    f"mesh backend; got {type(protocol).__name__}"
                )
        self.sim_graph = graph
        self.sim_protocol = protocol
        self._sim_key = prng.key(seed)
        self.sim_mesh = mesh
        self._sim_rng = rng
        self._sim_adaptive_k = adaptive_k
        if mesh is not None:
            sg = sharded.shard_graph(graph, mesh, mxu=layout == "mxu",
                                     hybrid=layout == "hybrid",
                                     source_csr=adaptive_k > 0)
            if dynamic_edges:
                sg = sharded.with_capacity(sg, dynamic_edges)
            self.sim_sharded = sg
            self.sim_state = sharded.init_state(sg, protocol, self._sim_key)
        else:
            self.sim_sharded = None
            self.sim_state = protocol.init(graph, self._sim_key)
        self.sim_round = 0
        self.sim_message_count = 0
        self._churn_count = 0
        self.sim_peer = SimPeer(self, graph.n_nodes)
        self.debug_print(
            f"attach_simulation: {graph.n_nodes} nodes / {graph.n_edges} edges, "
            f"protocol {type(protocol).__name__}"
            + (f", {mesh.n_shards}-shard ring" if mesh is not None else "")
        )

    def _require_sim(self):
        if self.sim_graph is None:
            raise RuntimeError("TorchSimNode: no simulation attached; call attach_simulation()")

    @property
    def sim_node_alive(self) -> np.ndarray:
        """Liveness of the simulated population (bool, one entry per padded
        node) from whichever backend is active: on the ring the live
        topology is ``sim_sharded``, ``sim_graph`` the pristine build."""
        self._require_sim()
        if self.sim_mesh is not None:
            return _host(self.sim_sharded.node_mask).reshape(-1)
        return _host(self.sim_graph.node_mask)

    # ------------------------------------------------------------- stepping

    def _run_rounds_sharded(self, rounds: int, seg_key):
        """A ``run_rounds`` segment on the ring, by protocol."""
        sg, mesh, proto = self.sim_sharded, self.sim_mesh, self.sim_protocol
        if isinstance(proto, Flood):
            return sharded.flood(sg, mesh, proto.source, rounds,
                                 state0=self.sim_state, return_state=True)
        if isinstance(proto, SIR):
            return sharded.sir(sg, mesh, proto, seg_key, rounds,
                               rng=self._sim_rng, status0=self.sim_state)
        if isinstance(proto, Gossip):
            return sharded.gossip(sg, mesh, proto, seg_key, rounds,
                                  rng=self._sim_rng, values0=self.sim_state)
        if isinstance(proto, HopDistance):
            return sharded.hopdist(sg, mesh, proto, rounds,
                                   state0=self.sim_state)
        if isinstance(proto, PageRank):
            return sharded.pagerank(sg, mesh, proto, rounds,
                                    ranks0=self.sim_state)
        if isinstance(proto, PushSum):
            return sharded.pushsum(sg, mesh, proto, seg_key, rounds,
                                   state0=self.sim_state)
        raise ValueError(
            f"the sharded backend implements Flood, SIR, Gossip, "
            f"HopDistance, PageRank and PushSum; got {type(proto).__name__}")

    def run_rounds(self, rounds: int) -> dict:
        """Advance the population ``rounds`` synchronous rounds, then fire
        ``node_message`` once per round (aggregate stats dict) through the
        standard event path. Returns the stacked stats as numpy arrays."""
        self._require_sim()
        # Per-segment key: deterministic in (seed, segment start).
        seg_key = prng.fold_in(self._sim_key, self.sim_round)
        if self.sim_mesh is not None:
            self.sim_state, stats = self._run_rounds_sharded(rounds, seg_key)
        else:
            self.sim_state, stats = engine.run_from(
                self.sim_graph, self.sim_protocol, self.sim_state, seg_key,
                rounds,
            )
        host_stats = {k: _host(v) for k, v in stats.items()}
        for r in range(rounds):
            round_stats = {k: host_stats[k][r].item() for k in host_stats}
            if "messages" in round_stats:
                self.sim_message_count += int(round_stats["messages"])
            self.sim_round += 1
            self.node_message(self.sim_peer, {"sim_round": self.sim_round, **round_stats})
        return host_stats

    def _finish_run(self, out: dict) -> dict:
        """Shared tail of the run-to-* loops: host summary, round/message
        accounting, and the single summary ``node_message`` event."""
        summary = {k: _host(v).item() for k, v in out.items()}
        self.sim_round += int(summary["rounds"])
        self.sim_message_count += int(summary["messages"])
        self.node_message(self.sim_peer, {"sim_run": True, **summary})
        return summary

    def run_until_coverage(self, coverage_target: float = 0.99,
                           max_rounds: int = 1024) -> dict:
        """Run-to-coverage continuing from the current state (no per-round
        events; one summary ``node_message`` at the end). On the ring this
        is ``sharded.flood_until_coverage``."""
        self._require_sim()
        seg_key = prng.fold_in(self._sim_key, self.sim_round)
        if self.sim_mesh is not None:
            sg, mesh, proto = (self.sim_sharded, self.sim_mesh,
                               self.sim_protocol)
            if isinstance(proto, Flood):
                self.sim_state, out = sharded.flood_until_coverage(
                    sg, mesh, proto.source, coverage_target=coverage_target,
                    max_rounds=max_rounds, state0=self.sim_state,
                    return_state=True, adaptive_k=self._sim_adaptive_k)
            elif isinstance(proto, HopDistance):
                self.sim_state, out = sharded.hopdist_until_coverage(
                    sg, mesh, proto, coverage_target=coverage_target,
                    max_rounds=max_rounds, state0=self.sim_state,
                    adaptive_k=self._sim_adaptive_k)
            elif isinstance(proto, SIR):
                self.sim_state, out = sharded.sir_until_coverage(
                    sg, mesh, proto, seg_key,
                    coverage_target=coverage_target, max_rounds=max_rounds,
                    rng=self._sim_rng, status0=self.sim_state)
            else:
                raise ValueError(
                    "run_until_coverage on the sharded backend implements "
                    "Flood, SIR and HopDistance; the protocol must expose "
                    "a coverage stat")
        else:
            self.sim_state, out = engine.run_until_coverage_from(
                self.sim_graph, self.sim_protocol, self.sim_state, seg_key,
                coverage_target=coverage_target, max_rounds=max_rounds,
            )
        return self._finish_run(out)

    def run_until_converged(self, stat: str, threshold: float,
                            max_rounds: int = 1024) -> dict:
        """Run-to-convergence continuing from the current state
        (``engine.run_until_converged``): advance until ``stats[stat]``
        drops below ``threshold``, PageRank to a residual, PushSum/Gossip
        to a variance."""
        self._require_sim()
        seg_key = prng.fold_in(self._sim_key, self.sim_round)
        if self.sim_mesh is not None:
            sg, mesh, proto = (self.sim_sharded, self.sim_mesh,
                               self.sim_protocol)
            if isinstance(proto, PageRank) and stat == "residual":
                self.sim_state, out = sharded.pagerank_until_residual(
                    sg, mesh, proto, tol=threshold, max_rounds=max_rounds,
                    ranks0=self.sim_state)
            elif isinstance(proto, PushSum) and stat == "variance":
                self.sim_state, out = sharded.pushsum_until_variance(
                    sg, mesh, proto, seg_key, tol=threshold,
                    max_rounds=max_rounds, state0=self.sim_state)
            else:
                raise ValueError(
                    "run_until_converged on the sharded backend implements "
                    "PageRank (stat='residual') and PushSum "
                    "(stat='variance'); run other protocols on the "
                    "single-device backend or step them with run_rounds")
        else:
            self.sim_state, out = engine.run_until_converged(
                self.sim_graph, self.sim_protocol, seg_key, stat=stat,
                threshold=threshold, max_rounds=max_rounds,
                state0=self.sim_state)
        return self._finish_run(out)

    # ------------------------------------------------------------- topology

    def _sim_topology_event(self, change: str) -> None:
        """Population topology changes surface through ``node_message``,
        like round stats; SimPeer is in no socket registry, so the
        disconnect dispatcher ignores it."""
        mask = (self.sim_sharded.node_mask if self.sim_mesh is not None
                else self.sim_graph.node_mask)
        alive = int(mask.sum().item())
        self.node_message(
            self.sim_peer, {"sim_topology": change, "alive_nodes": alive}
        )

    def fail_sim_nodes(self, node_ids) -> None:
        """Fail-stop simulated peers (``sim/failures.py``, or the ring's
        re-mask on the mesh backend)."""
        self._require_sim()
        if self.sim_mesh is not None:
            self.sim_sharded = sharded.fail_nodes(self.sim_sharded, node_ids)
        else:
            self.sim_graph = failures.fail_nodes(self.sim_graph, node_ids)
        self._sim_topology_event("fail_nodes")

    def inject_sim_churn(self, frac: float, seed: Optional[int] = None) -> None:
        """Randomly fail ``frac`` of the live simulated population.

        Each call draws fresh randomness by default (an internal counter
        folds into the node's sim key); pass ``seed`` only to reproduce
        one specific churn event.
        """
        self._require_sim()
        if seed is not None:
            key = prng.key(seed)
        else:
            self._churn_count += 1
            key = prng.fold_in(
                prng.fold_in(self._sim_key, 0x0C0C), self._churn_count
            )
        if self.sim_mesh is not None:
            self.sim_sharded = sharded.random_node_failures(
                self.sim_sharded, key, frac
            )
        else:
            self.sim_graph = failures.random_node_failures(
                self.sim_graph, key, frac
            )
        self._sim_topology_event("churn")

    def connect_sim_nodes(self, senders, receivers) -> None:
        """Add links between simulated peers at runtime
        (``sim/topology.py``, or the ring's dynamic region). Needs dynamic
        capacity (``topology.with_capacity`` / ``dynamic_edges=`` at
        attach)."""
        self._require_sim()
        if self.sim_mesh is not None:
            self.sim_sharded = sharded.connect(
                self.sim_sharded, senders, receivers
            )
        else:
            self.sim_graph = topology.connect(self.sim_graph, senders, receivers)
        self._sim_topology_event("connect")

    # ----------------------------------------------------------- checkpoint

    def save_checkpoint(self, path: str) -> None:
        """Persist protocol state, PRNG key, round/message counters and the
        topology mutation state (failed nodes, cut edges, runtime links,
        churn counter) in the reference's format (``sim/checkpoint.py``),
        so a restored run sees the network as it was, not as it was
        built."""
        self._require_sim()
        payload = {
            "protocol": self.sim_state,
            "topology": self._topology_state(),
            "churn_count": np.int64(self._churn_count),
        }
        ckpt.save(path, payload, self._sim_key, self.sim_round,
                  self.sim_message_count)

    def _topology_state(self):
        if self.sim_mesh is not None:
            return sharded.topology_state(self.sim_sharded)
        return ckpt.topology_state(self.sim_graph)

    def load_checkpoint(self, path: str) -> None:
        """Restore a checkpoint taken from a node (of either package) with
        the same pristine graph construction and protocol: the checkpoint's
        topology state is re-applied onto the attached graph, and the churn
        counter is restored, so the next ``inject_sim_churn()`` draws
        fresh randomness. Everything is validated before the node
        changes."""
        self._require_sim()
        if self.sim_mesh is not None:
            template = {
                "protocol": sharded.init_state(
                    self.sim_sharded, self.sim_protocol, prng.key(0)
                ),
                "topology": sharded.topology_state(self.sim_sharded),
                "churn_count": np.int64(0),
            }
            payload, key, rnd, msgs = ckpt.load(path, template)
            self.sim_sharded = sharded.apply_topology_state(
                self.sim_sharded, payload["topology"]
            )
        else:
            proto_template = self.sim_protocol.init(self.sim_graph,
                                                    prng.key(0))
            payload, key, rnd, msgs = ckpt.load_node_payload(
                path, self.sim_graph, proto_template
            )
            self.sim_graph = ckpt.apply_topology_state(self.sim_graph,
                                                       payload["topology"])
        self.sim_state = payload["protocol"]
        self._sim_key = key
        self.sim_round = rnd
        self.sim_message_count = msgs
        self._churn_count = int(payload["churn_count"])
