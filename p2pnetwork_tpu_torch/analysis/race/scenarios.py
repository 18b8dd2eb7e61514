"""graftrace scenario battery: the threaded plane's hazard surfaces as
deterministic, seed-explorable bodies.

Each scenario drives REAL library objects — nodes, the chaos plane, the
watchdog/checkpoint pair, the telemetry registry — from managed threads
that mirror the production thread roles (one "loop" thread for
loop-confined state, plus the foreign threads the public API documents
as safe callers). No sockets traffic flows and no event loop runs: what
is under test is exactly the cross-thread shared-state discipline, which
is the part the asyncio confinement does NOT cover and chaos soaks only
sample. Lock-guarded attributes are auto-tracked
(:func:`~p2pnetwork_tpu_torch.analysis.race.detector.watch`), so any
unordered conflicting access — or any deadlock — in ANY explored
schedule fails the gate.

Determinism rules for scenario authors:

- pass explicit ``now=`` timestamps into everything that branches on
  time (phi sweeps, quarantine evictions) — wall clock must never pick
  the code path;
- iterate deterministically (dicts, sorted sets);
- close what you open (sockets, watchdog threads) inside the body, so a
  schedule ends with every task finished.

Scenarios self-describe optional dependencies: a factory raising
:class:`ScenarioUnavailable` (e.g. no torch for the supervise scenario)
reports as a skip with its reason, never as a crash of the battery.

The watchdog and the four serving scenarios put their graphs and state
on a device (``device=True`` at registration; the factory takes it): the
battery's device, ``cuda`` unless the caller names another, as for every
entry point of the port.
"""

from __future__ import annotations

import shutil
import tempfile
from typing import Callable, Dict, List, NamedTuple, Optional

from p2pnetwork_tpu_torch import _device, concurrency
from p2pnetwork_tpu_torch.analysis.race.detector import watch

__all__ = ["SCENARIOS", "ScenarioUnavailable", "scenario", "builtin_names",
           "admit_storm", "ADMIT_STORM_SERVICE"]


class ScenarioUnavailable(RuntimeError):
    """Raised by a factory whose dependencies are absent on this image;
    the battery reports a skip with this reason."""


class _Scenario(NamedTuple):
    name: str
    doc: str
    factory: Callable[..., Callable[[], None]]
    builtin: bool
    #: The factory takes the device its graphs and state go on.
    device: bool = False

    def make(self, device=None) -> Callable[[], None]:
        """The body of one schedule; ``device`` reaches the factories
        that place tensors (resolved there: ``cuda`` when None)."""
        if self.device:
            return self.factory(device)
        return self.factory()


#: name -> scenario. Builtins are the CI battery; externally registered
#: scenarios (``--scenarios-from``, test fixtures) join the registry but
#: not the default gate.
SCENARIOS: Dict[str, _Scenario] = {}  # graftlint: ignore[unbounded-cache] -- scenario registry: builtins at import plus explicit --scenarios-from registrations, not per-request growth


def scenario(name: str, doc: str, *, builtin: bool = True,
             device: bool = False):
    """Register a scenario factory. The factory runs OUTSIDE the managed
    world (imports, dependency checks, graph builds); the body it returns
    runs as the managed main task, once per explored schedule. With
    ``device=True`` the factory takes the device to place tensors on."""
    def deco(factory):
        # Last registration wins: an external scenarios file is loaded
        # both by import and by --scenarios-from in the same process
        # (tests do), and re-registration must refresh, not crash.
        SCENARIOS[name] = _Scenario(name, doc, factory, builtin, device)
        return factory
    return deco


def builtin_names() -> List[str]:
    return [n for n, s in sorted(SCENARIOS.items()) if s.builtin]


# --------------------------------------------------------------- helpers

class _StubConn:
    """The NodeConnection surface the registry/chaos/phi paths touch:
    id/host/port, a thread-safe stop(), a counting send(). No transport."""

    def __init__(self, id: str, host: str = "127.0.0.1", port: int = 0):
        self.id = str(id)
        self.host = host
        self.port = port
        self.stopped = concurrency.event()
        self.sent: int = 0

    def stop(self) -> None:
        self.stopped.set()

    def send(self, data, compression: str = "none") -> None:
        self.sent += 1


def _fresh_registry():
    # Constructed inside the managed body so its locks are instrumented.
    from p2pnetwork_tpu_torch import telemetry
    return telemetry.Registry()


# -------------------------------------------------------------- scenarios

@scenario(
    "connect_disconnect_storm",
    "Peer registry churn under chaos severing: a loop-role thread "
    "registers/deregisters connections via node_disconnected while "
    "foreign threads broadcast, trigger reconnect checks and the chaos "
    "plane kills/partitions/revives — the recovery surface the chaos "
    "soaks exercise, here under every explored interleaving.")
def _connect_disconnect_storm():
    from p2pnetwork_tpu_torch.chaos.plane import ChaosPlane
    from p2pnetwork_tpu_torch.node import Node

    def body():
        reg = _fresh_registry()
        node = Node("127.0.0.1", 0, id="n0", registry=reg)
        try:
            plane = watch(ChaosPlane(seed=7, registry=reg))
            watch(node.event_log)
            plane.attach(node)
            conns = [_StubConn(f"p{i}") for i in range(4)]
            node.nodes_inbound.extend(conns[:2])
            node.nodes_outbound.extend(conns[2:])

            def loop_role():
                # The event-loop thread's share: registry mutation plus
                # upward dispatch (event log, conn gauges).
                node.node_disconnected(conns[0])
                node.nodes_inbound.append(conns[0])
                node.node_disconnected(conns[2])
                node.nodes_outbound.append(conns[2])

            def broadcaster():
                for _ in range(3):
                    node.send_to_nodes({"k": 1})
                    # Apps log custom events from their own threads; the
                    # EventLog is documented thread-safe, so the storm
                    # must drive it cross-thread (the loop role records
                    # disconnect events into the same deque).
                    node.event_log.record("app_note", None, {})

            def chaos_role():
                plane.kill_nodes(["p0"])
                plane.partition([["n0", "p1"], ["p2", "p3"]])
                plane.heal_partition()
                plane.revive_nodes(["p0"])
                plane.cut_links([("n0", "p3")])
                plane.heal_links([("n0", "p3")])

            def prober():
                for a, b in (("n0", "p0"), ("n0", "p1"), ("n0", "p3")):
                    plane.link_ok(a, b)
                plane.fault_log()
                node.event_log.count("inbound_node_disconnected")
                node.event_log.snapshot()

            ts = [concurrency.thread(target=f, name=nm)
                  for nm, f in (("loop", loop_role), ("bcast", broadcaster),
                                ("chaos", chaos_role), ("probe", prober))]
            for t in ts:
                t.start()
            for t in ts:
                t.join()  # graftlint: ignore[wait-untimed] -- managed-world join: deliberately unbounded so a wedged schedule reports as a graftrace deadlock, not a silent timeout
            plane.detach(node)
        finally:
            node.sock.close()
    return body


@scenario(
    "phi_quarantine",
    "Phi quarantine transitions under concurrent sweeps: heartbeats land "
    "while a loop-role tick and a monitoring thread both evaluate "
    "quarantine/readmit/evict, a peer disconnects mid-sweep, and the "
    "chaos plane severs — the _phi_lock discipline, checked "
    "dynamically.")
def _phi_quarantine():
    from p2pnetwork_tpu_torch.chaos.plane import ChaosPlane
    from p2pnetwork_tpu_torch.phi import PhiAccrualNode

    def body():
        reg = _fresh_registry()
        node = PhiAccrualNode(
            "127.0.0.1", 0, id="n0", window=8, quarantine_threshold=2.0,
            evict_after=50.0, registry=reg)
        try:
            watch(node)
            plane = watch(ChaosPlane(seed=3, registry=reg))
            plane.attach(node)
            conns = [_StubConn(f"p{i}") for i in range(3)]
            node.nodes_inbound.extend(conns)

            def heartbeats():
                # A healthy cadence for p0, then silence; p1 heartbeats
                # throughout. Explicit timestamps: the detector must see
                # the same arithmetic in every schedule.
                for t in range(1, 9):
                    node._record_heartbeat("p0", now=float(t))
                for t in range(1, 17):
                    node._record_heartbeat("p1", now=float(t))

            def tick_sweep():
                # The loop-role tick: quarantines p0 once its silence
                # stretches (phi at now=200 is astronomically high).
                node.check_quarantine(now=200.0)
                node.check_quarantine(now=300.0)  # evict_after exceeded

            def monitor_sweep():
                node.phi("p0", now=250.0)
                node.check_quarantine(now=250.0)
                node.is_quarantined("p0")
                node.suspicion_levels()

            def churn():
                node.node_disconnected(conns[2])
                plane.kill_nodes(["p1"])
                plane.revive_nodes(["p1"])

            ts = [concurrency.thread(target=f, name=nm)
                  for nm, f in (("hb", heartbeats), ("tick", tick_sweep),
                                ("mon", monitor_sweep), ("churn", churn))]
            for t in ts:
                t.start()
            for t in ts:
                t.join()  # graftlint: ignore[wait-untimed] -- managed-world join: deliberately unbounded so a wedged schedule reports as a graftrace deadlock, not a silent timeout
            plane.detach(node)
        finally:
            node.sock.close()
    return body


@scenario(
    "crdt_merge_storm",
    "CRDT merge storm: inbound state merges on the loop-role thread race "
    "create-on-miss accessors from foreign threads — the lost-update "
    "window _crdt_lock exists for, and the dynamic verdict on the "
    "merge-under-lock hazard graftlint's suppression cites.")
def _crdt_merge_storm():
    from p2pnetwork_tpu_torch.crdt import CRDTNode

    def body():
        reg = _fresh_registry()
        node = CRDTNode("127.0.0.1", 0, id="n0", registry=reg)
        try:
            watch(node)
            src = _StubConn("peer")

            def merges():
                # The loop-role thread: one merge stream, first-contact
                # construct-and-retry included (the baseline entry's
                # exact line runs here, under every explored schedule).
                for i in range(1, 4):
                    node.node_message(src, {
                        "_crdt": "hits", "kind": "gcounter",
                        "state": {"counts": {"peer": i}}})
                node.node_message(src, {
                    "_crdt": "names", "kind": "orset",
                    "state": {"adds": {"a": [["peer", 1]]},
                              "tombs": [], "next": 1}})

            def accessor_a():
                node.gcounter("hits").value
                node.gcounter("fresh").value  # create-on-miss race

            def accessor_b():
                node.set_("names").elements()
                node.gcounter("hits").value

            ts = [concurrency.thread(target=f, name=nm)
                  for nm, f in (("loop", merges), ("acc-a", accessor_a),
                                ("acc-b", accessor_b))]
            for t in ts:
                t.start()
            for t in ts:
                t.join()  # graftlint: ignore[wait-untimed] -- managed-world join: deliberately unbounded so a wedged schedule reports as a graftrace deadlock, not a silent timeout
        finally:
            node.sock.close()
    return body


@scenario(
    "registry_storm",
    "Concurrent metric creation: racing get-or-create of families and "
    "labeled children, updates, and snapshot/value readers — the "
    "setdefault re-check discipline telemetry/registry.py documents, "
    "checked under every explored interleaving.")
def _registry_storm():
    def body():
        from p2pnetwork_tpu_torch.telemetry.registry import Registry
        reg = watch(Registry())

        def creator_a():
            c = watch(reg.counter("storm_total", "x", ("who",)))
            c.labels("a").inc()
            reg.gauge("storm_gauge", "y").set(1.0)

        def creator_b():
            c = watch(reg.counter("storm_total", "x", ("who",)))
            c.labels("a").inc()
            c.labels("b").inc(2.0)
            reg.histogram("storm_hist", "z").observe(0.5)

        def reader():
            reg.value("storm_total", who="a")
            reg.snapshot()
            reg.collect()

        ts = [concurrency.thread(target=f, name=nm)
              for nm, f in (("mk-a", creator_a), ("mk-b", creator_b),
                            ("read", reader))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()  # graftlint: ignore[wait-untimed] -- managed-world join: deliberately unbounded so a wedged schedule reports as a graftrace deadlock, not a silent timeout
    return body


@scenario(
    "watchdog_emergency_checkpoint",
    "Watchdog stall firing emergency_checkpoint from the on-stall "
    "thread while the run thread swaps the fallback and saves boundary "
    "checkpoints — the _fb_lock/_save_lock discipline supervise documents "
    "as thread-safe, driven from the exact threads it promises.",
    device=True)
def _watchdog_emergency_checkpoint(device=None):
    try:
        import torch
        from p2pnetwork_tpu_torch import prng
        from p2pnetwork_tpu_torch.supervise.runner import SupervisedRun
        from p2pnetwork_tpu_torch.supervise.store import CheckpointStore
        from p2pnetwork_tpu_torch.supervise.watchdog import Watchdog
    except Exception as e:  # pragma: no cover - torch-less image
        raise ScenarioUnavailable(f"needs torch/supervise: {e}") from e
    dev = _device.resolve(device)
    key = prng.key(0)
    state = {"x": torch.arange(4, dtype=torch.int32, device=dev)}

    def body():
        reg = _fresh_registry()
        tmp = tempfile.mkdtemp(prefix="graftrace_wd_")
        try:
            store = watch(CheckpointStore(tmp, retain=2, registry=reg))
            run = watch(SupervisedRun(
                None, None, store, chunk_rounds=4, registry=reg))
            hook_saved = []

            def on_stall(dog):
                # The documented on-stall driver seam, from the
                # watchdog-role thread: persist the live fallback.
                hook_saved.append(run.emergency_checkpoint())

            wd = watch(Watchdog(deadline_s=60.0, name="graftrace",
                                on_stall=on_stall, registry=reg))
            wd.start()

            def run_role():
                # Chunk boundaries: publish fallback, save, retract.
                for rnd in (4, 8):
                    run._set_fallback((state, key, rnd, 0))
                    store.save(state, key, rnd, 0)
                    run._set_fallback(None)
                    wd.heartbeat()

            def watchdog_role():
                # The detection-time path _watch runs on its own thread:
                # fire a stall while the run thread is mid-boundary.
                wd._fire(75.0)
                wd._fire(80.0)

            ts = [concurrency.thread(target=f, name=nm)
                  for nm, f in (("run", run_role),
                                ("stall", watchdog_role))]
            for t in ts:
                t.start()
            for t in ts:
                t.join()  # graftlint: ignore[wait-untimed] -- managed-world join: deliberately unbounded so a wedged schedule reports as a graftrace deadlock, not a silent timeout
            wd.close()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return body


@scenario(
    "serve_admit_storm",
    "The serving front-end's control plane under exploration: foreign "
    "threads submit/poll/cancel/stream while the driver-role thread "
    "runs admission ticks (retire → admit → engine chunk → harvest) — "
    "the submit/poll/driver interleavings SimService._cond exists for, "
    "driven from the exact thread roles the serve API documents.",
    device=True)
def _serve_admit_storm(device=None):
    try:
        import torch  # noqa: F401
        from p2pnetwork_tpu_torch.serve.service import (  # noqa: F401
            Rejected, SimService)
        from p2pnetwork_tpu_torch.sim import graph as G
    except Exception as e:  # pragma: no cover - torch-less image
        raise ScenarioUnavailable(f"needs torch/serve: {e}") from e
    dev = _device.resolve(device)
    # Built OUTSIDE the managed world: the graph is immutable input, and
    # its construction (host sorts, the copy to the device) is not under
    # test.
    g = G.watts_strogatz(24, 4, 0.1, seed=1, source_csr=True, device=dev)
    return admit_storm(g)


#: The SimService settings of ``serve_admit_storm``: a small service whose
#: 3-deep queue and metered tenant make shedding part of the schedule.
ADMIT_STORM_SERVICE = dict(capacity=8, queue_depth=3, chunk_rounds=4, seed=0)


def admit_storm(g, *, service=None, drain: bool = False,
                results: Optional[List[dict]] = None):
    """The body of ``serve_admit_storm`` over graph ``g``: a driver-role
    thread runs three admission ticks while two submitters and a prober
    call in. ``service`` overrides :data:`ADMIT_STORM_SERVICE`. With
    ``drain`` the main task then ticks until nothing is queued or running
    and appends every ticket record to ``results``, so a caller can hold
    each completed ticket against an unscheduled service's (the schedule
    must change no result)."""
    from p2pnetwork_tpu_torch.serve.service import SimService
    kw = dict(ADMIT_STORM_SERVICE if service is None else service)
    # Warm the engine path outside the managed world too: the first
    # batched run lazily registers the default-registry sim_* families
    # (and builds the kernels on a card). Registered under an installed
    # provider, those PROCESS-GLOBAL metric locks would be bound to one
    # schedule's scheduler and explode in the next ("graftrace
    # primitives are confined to managed tasks"); warmed here they are
    # raw stdlib locks, and every explored schedule starts warm.
    warm = SimService(g, **kw)
    warm.submit(1)
    warm.tick()
    warm.close()

    def body():
        from p2pnetwork_tpu_torch.serve.service import Rejected, SimService
        reg = _fresh_registry()
        svc = watch(SimService(g, quotas={"metered": (1.0, 2.0)},
                               registry=reg, **kw))

        def driver_role():
            # The admission-control loop's share, run synchronously so
            # a wedged schedule is a graftrace deadlock, not a hang.
            for _ in range(3):
                svc.tick()

        def submitter_a():
            for s in (1, 2, 3):
                try:
                    svc.submit(s)
                except Rejected:
                    pass  # load shed is a designed outcome, not a bug

        def submitter_b():
            for s in (4, 5):
                try:
                    svc.submit(s, tenant="metered")
                except Rejected:
                    pass

        def prober():
            svc.poll("t00000000")
            svc.stats()
            svc.busy()
            svc.tickets()
            svc.cancel("t00000001")
            svc.poll("t-unknown")

        ts = [concurrency.thread(target=f, name=nm)
              for nm, f in (("driver", driver_role),
                            ("sub-a", submitter_a), ("sub-b", submitter_b),
                            ("probe", prober))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()  # graftlint: ignore[wait-untimed] -- managed-world join: deliberately unbounded so a wedged schedule reports as a graftrace deadlock, not a silent timeout
        if drain:
            while svc.busy():
                svc.tick()
            if results is not None:
                results.extend(svc.tickets().values())
        svc.close()
    return body


@scenario(
    "churn_storm_vs_serve",
    "The graftchurn mutation plane under exploration: a foreign thread "
    "queues live overlay mutations (grow + a wiring delta, whose "
    "endpoint validation reads the queued-grow total under _cond) and "
    "another submits tickets while the driver-role thread runs "
    "admission ticks whose mutate phase drains the queue — the "
    "mutate/submit/stats interleavings the atomic between-tick "
    "mutation contract promises to serialize.",
    device=True)
def _churn_storm_vs_serve(device=None):
    try:
        import torch  # noqa: F401
        from p2pnetwork_tpu_torch.serve.service import (  # noqa: F401
            Rejected, SimService)
        from p2pnetwork_tpu_torch.sim import graph as G
    except Exception as e:  # pragma: no cover - torch-less image
        raise ScenarioUnavailable(f"needs torch/serve: {e}") from e
    dev = _device.resolve(device)
    g = G.watts_strogatz(24, 4, 0.1, seed=1, source_csr=True, device=dev)

    def mutations():
        return [("grow", 2),
                ("delta", G.GraphDelta.undirected(add_senders=[24, 25],
                                                  add_receivers=[0, 1]))]

    # Warm OUTSIDE the managed world (the serve_admit_storm rule): the
    # first mutation lazily registers the sim_graph_grow/serve_mutation
    # metric families; warmed here, every explored schedule starts warm
    # on raw locks.
    warm = SimService(g, capacity=8, queue_depth=3, chunk_rounds=4, seed=0)
    warm.submit(1)
    for kind, payload in mutations():
        warm.grow(payload) if kind == "grow" else warm.apply_delta(payload)
    warm.tick()
    warm.tick()
    warm.close()

    def body():
        from p2pnetwork_tpu_torch.serve.service import Rejected, SimService
        reg = _fresh_registry()
        svc = watch(SimService(
            g, capacity=8, queue_depth=3, chunk_rounds=4, seed=0,
            registry=reg))

        def driver_role():
            for _ in range(3):
                svc.tick()

        def mutator():
            for kind, payload in mutations():
                if kind == "grow":
                    svc.grow(payload)
                else:
                    svc.apply_delta(payload)

        def submitter():
            for s in (1, 2):
                try:
                    svc.submit(s)
                except Rejected:
                    pass  # load shed is a designed outcome, not a bug

        def prober():
            svc.stats()
            svc.busy()
            svc.tickets()

        ts = [concurrency.thread(target=f, name=nm)
              for nm, f in (("driver", driver_role), ("mutate", mutator),
                            ("submit", submitter), ("probe", prober))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()  # graftlint: ignore[wait-untimed] -- managed-world join: deliberately unbounded so a wedged schedule reports as a graftrace deadlock, not a silent timeout
        svc.close()
    return body


@scenario(
    "sight_scrape_under_serve",
    "The graftsight observability plane under exploration: scraper "
    "threads read /dashboard's document (dashboard_doc, sockets-free), "
    "the Prometheus text, trace exports and the tick-phase profile "
    "while the driver-role thread runs admission ticks through an "
    "armed dispatch fault and its heal retry — every cross-thread "
    "read of the tracer store, SLO rings, phase ring and heal "
    "counters racing the writer that is mid-tick.",
    device=True)
def _sight_scrape_under_serve(device=None):
    try:
        import torch  # noqa: F401
        from p2pnetwork_tpu_torch.serve.service import (  # noqa: F401
            Rejected, SimService)
        from p2pnetwork_tpu_torch.sim import graph as G
        from p2pnetwork_tpu_torch.supervise.heal import RetryPolicy
    except Exception as e:  # pragma: no cover - torch-less image
        raise ScenarioUnavailable(f"needs torch/serve: {e}") from e
    dev = _device.resolve(device)
    g = G.watts_strogatz(24, 4, 0.1, seed=1, source_csr=True, device=dev)
    # Warm OUTSIDE the managed world, heal path included: a healing
    # service dispatches through the retained-input path, so its engine
    # path (and the registry's process-global sim_* locks) must be warm
    # before any schedule runs (see serve_admit_storm).
    warm = SimService(g, capacity=8, queue_depth=4, chunk_rounds=4, seed=0,
                      heal=RetryPolicy(backoff_base_s=0.0))
    warm.submit(1)
    warm.tick()
    warm.close()

    def body():
        from p2pnetwork_tpu_torch import telemetry
        from p2pnetwork_tpu_torch.chaos import device as chaos_device
        from p2pnetwork_tpu_torch.serve.service import Rejected, SimService
        from p2pnetwork_tpu_torch.supervise.heal import RetryPolicy
        from p2pnetwork_tpu_torch.telemetry import spans
        from p2pnetwork_tpu_torch.telemetry.export import to_prometheus
        from p2pnetwork_tpu_torch.telemetry.httpd import dashboard_doc
        from p2pnetwork_tpu_torch.telemetry.slo import (
            SLOEngine, serve_objectives)
        from p2pnetwork_tpu_torch.utils.logging import EventLog

        reg = _fresh_registry()
        hist = telemetry.History(capacity=32)
        slo = SLOEngine(serve_objectives(slo_rounds=64),
                        registry=reg, log=EventLog())
        tracer = telemetry.Tracer(max_spans=2048)
        prev_tracer = spans.install_tracer(tracer)
        # One preempt at the first dispatch of every schedule: the
        # driver's heal retry runs WHILE the scrapers read, so the
        # fault/heal counters and per-ticket replay race real readers.
        prev_chaos = chaos_device.install_dispatch_chaos(
            chaos_device.DispatchChaos(preempt_at=(0,), registry=reg))
        try:
            svc = watch(SimService(
                g, capacity=8, queue_depth=4, chunk_rounds=4, seed=0,
                heal=RetryPolicy(backoff_base_s=0.0), slo=slo,
                registry=reg))

            def driver_role():
                for _ in range(3):
                    svc.tick()

            def submitter():
                for s in (1, 2, 3):
                    try:
                        svc.submit(s)
                    except Rejected:
                        pass

            def scraper_a():
                # The /dashboard + /metrics scrape path, sockets-free.
                dashboard_doc(reg, hist, tracer, slo, svc)
                to_prometheus(reg)
                slo.snapshot()

            def scraper_b():
                # The /trace + /history scrape path plus the profile.
                tracer.to_chrome()
                tracer.traces()
                hist.snapshot(last=8)
                svc.tick_phases()
                svc.dashboard_slice()

            ts = [concurrency.thread(target=f, name=nm)
                  for nm, f in (("driver", driver_role),
                                ("submit", submitter),
                                ("scrape-a", scraper_a),
                                ("scrape-b", scraper_b))]
            for t in ts:
                t.start()
            for t in ts:
                t.join()  # graftlint: ignore[wait-untimed] -- managed-world join: deliberately unbounded so a wedged schedule reports as a graftrace deadlock, not a silent timeout
            svc.close()
        finally:
            chaos_device.install_dispatch_chaos(prev_chaos)
            spans.install_tracer(prev_tracer)
    return body


@scenario(
    "partition_heal",
    "The partition-heal soak's control plane under exploration: "
    "partition, concurrent traffic probing link_ok on both sides, heal, "
    "kill/revive — the seeded 8-node soak proves recovery end to end "
    "over real sockets; this proves its ChaosPlane bookkeeping has no "
    "interleaving that tears the partition state.")
def _partition_heal():
    from p2pnetwork_tpu_torch.chaos.plane import ChaosPlane

    def body():
        reg = _fresh_registry()
        plane = watch(ChaosPlane(seed=11, registry=reg))
        side_a = [f"a{i}" for i in range(4)]
        side_b = [f"b{i}" for i in range(4)]

        def splitter():
            plane.partition([side_a, side_b])
            plane.heal_partition()
            plane.partition([side_a[:2] + side_b[:2],
                             side_a[2:] + side_b[2:]])
            plane.heal_partition()

        def traffic():
            for a in side_a[:2]:
                for b in side_b[:2]:
                    plane.link_ok(a, b)
            plane.fault_log()

        def churn():
            plane.kill_nodes([side_b[0]])
            plane.link_ok(side_a[0], side_b[0])
            plane.revive_nodes([side_b[0]])
            plane.cut_links([(side_a[1], side_b[1])])
            plane.heal_links([(side_a[1], side_b[1])])

        ts = [concurrency.thread(target=f, name=nm)
              for nm, f in (("split", splitter), ("traffic", traffic),
                            ("churn", churn))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()  # graftlint: ignore[wait-untimed] -- managed-world join: deliberately unbounded so a wedged schedule reports as a graftrace deadlock, not a silent timeout
    return body


@scenario(
    "journal_vs_close",
    "The graftdur durability plane under exploration: a foreign thread "
    "submits (each acknowledgement is a journal append inside _cond) "
    "while the driver-role thread runs boundary ticks (tick_barrier "
    "fsync + rotate/compact inside _checkpoint), a closer runs the "
    "final-checkpoint close() path, and a promoter fences the trail "
    "via Standby.promote() — the append/close/promote interleavings "
    "where a zombie's publish must die as FencedEpoch, never as a "
    "torn pair or a silently un-journaled acknowledgement.",
    device=True)
def _journal_vs_close(device=None):
    try:
        import torch  # noqa: F401
        from p2pnetwork_tpu_torch.serve.service import (  # noqa: F401
            DurabilityLost, FencedEpoch, Rejected, ServiceClosed,
            SimService)
        from p2pnetwork_tpu_torch.serve.standby import Standby  # noqa: F401
        from p2pnetwork_tpu_torch.sim import graph as G
    except Exception as e:  # pragma: no cover - torch-less image
        raise ScenarioUnavailable(f"needs torch/serve: {e}") from e
    dev = _device.resolve(device)
    g = G.watts_strogatz(24, 4, 0.1, seed=1, source_csr=True, device=dev)

    # Warm OUTSIDE the managed world (the serve_admit_storm rule): the
    # first journaled service registers the serve_journal_* metric
    # families; the warm promote additionally runs the resumed-
    # construction path. Warmed here, every explored schedule starts warm
    # on raw locks.
    warm_dir = tempfile.mkdtemp(prefix="graftrace_dur_warm_")
    try:
        warm = SimService(g, capacity=8, queue_depth=3, chunk_rounds=4,
                          seed=0, store=warm_dir)
        warm.submit(1)
        warm.tick()
        warm_p = Standby(g, warm_dir, capacity=8, queue_depth=3,
                         chunk_rounds=4, seed=0).promote()
        warm_p.close()
        warm.close()
    finally:
        shutil.rmtree(warm_dir, ignore_errors=True)

    def body():
        from p2pnetwork_tpu_torch.serve.service import (
            DurabilityLost, FencedEpoch, Rejected, ServiceClosed,
            SimService)
        from p2pnetwork_tpu_torch.serve.standby import Standby
        reg = _fresh_registry()
        d = tempfile.mkdtemp(prefix="graftrace_dur_")
        try:
            svc = watch(SimService(
                g, capacity=8, queue_depth=3, chunk_rounds=4, seed=0,
                store=d, registry=reg))
            # One published pair before the races: promote() then
            # resumes real state instead of clearing an empty trail.
            svc.submit(1)
            svc.tick()

            def driver_role():
                for _ in range(3):
                    try:
                        svc.tick()
                    except (FencedEpoch, ServiceClosed):
                        # Designed outcomes: the promoter fenced our
                        # boundary publish (we are the zombie now), or
                        # the closer beat us to the driver.
                        return

            def submitter():
                for s in (2, 3):
                    try:
                        svc.submit(s)
                    except (Rejected, ServiceClosed):
                        pass  # shed / post-close submit: designed

            def closer():
                try:
                    svc.close()
                except FencedEpoch:
                    pass  # final checkpoint fenced: the zombie's close

            def promoter():
                reg2 = _fresh_registry()
                promoted = watch(Standby(
                    g, d, capacity=8, queue_depth=3, chunk_rounds=4,
                    seed=0, registry=reg2).promote())
                promoted.close()

            ts = [concurrency.thread(target=f, name=nm)
                  for nm, f in (("driver", driver_role),
                                ("submit", submitter),
                                ("close", closer),
                                ("promote", promoter))]
            for t in ts:
                t.start()
            for t in ts:
                t.join()  # graftlint: ignore[wait-untimed] -- managed-world join: deliberately unbounded so a wedged schedule reports as a graftrace deadlock, not a silent timeout
            try:
                svc.close()
            except FencedEpoch:
                pass  # the promoter owns the trail now
        finally:
            shutil.rmtree(d, ignore_errors=True)
    return body
