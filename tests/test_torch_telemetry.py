"""The port's telemetry plane against the JAX package's, on the CPU.

- Registry semantics: the same operations on a counter, a gauge and a
  histogram give the same snapshot (bucket bounds, cumulative counts,
  sums) and the same refusals.
- The ``Tracer``: the same spans and events give the same Chrome and JSONL
  documents once process ids, thread ids, trace ids and the clock are
  taken out.
- The engine's run summaries: after the same flood, batch and query runs
  (run-to-coverage, its resume form, run-to-converged, the batch loop,
  the query loop) both registries hold the same ``sim_*`` families with
  the same help and labels, and equal exact counters, the batch gauge
  and the completion-round buckets; the history ring took one sample per
  run.
- The lane events of a batch (``lane_submit``, ``lane_admit``,
  ``lane_resume``, ``lane_freeze``, ``lane_complete``, ``lane_retire``,
  ``batch_summary``) and of a query batch, in order, with their fields.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu import telemetry as RT  # noqa: E402
from p2pnetwork_tpu.models import flood as RF  # noqa: E402
from p2pnetwork_tpu.models import messagebatch as RMB  # noqa: E402
from p2pnetwork_tpu.models import pagerank as RPR  # noqa: E402
from p2pnetwork_tpu.models import querybatch as RQB  # noqa: E402
from p2pnetwork_tpu.sim import engine as RE  # noqa: E402
from p2pnetwork_tpu.sim import graph as RG  # noqa: E402
from p2pnetwork_tpu.telemetry import history as RH  # noqa: E402
from p2pnetwork_tpu_torch import prng  # noqa: E402
from p2pnetwork_tpu_torch import telemetry as PT  # noqa: E402
from p2pnetwork_tpu_torch.models import flood as PF  # noqa: E402
from p2pnetwork_tpu_torch.models import messagebatch as PMB  # noqa: E402
from p2pnetwork_tpu_torch.models import pagerank as PPR  # noqa: E402
from p2pnetwork_tpu_torch.models import querybatch as PQB  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine as PE  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as PG  # noqa: E402
from p2pnetwork_tpu_torch.telemetry import history as PH  # noqa: E402
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 1024


def _ops_counter(reg):
    c = reg.counter("c_total", "a counter", ("k",))
    c.labels("a").inc()
    c.labels(k="b").inc(2.5)
    c.labels("a").inc(0)
    reg.counter("plain_total", "plain").inc(3)


def _ops_gauge(reg):
    g = reg.gauge("g", "a gauge", ("k",))
    g.labels("x").set(4)
    g.labels("x").dec(1.5)
    g.labels("y").inc()
    g.labels("y").inc(-3)
    g.remove("y")
    reg.gauge("plain_g", "plain").set(-2)


def _ops_histogram(reg):
    h = reg.histogram("h_seconds", "a histogram", ("k",),
                      buckets=[0.5, 1.0, 2.0, float("inf")])
    for v in (0.1, 0.5, 0.50001, 1.0, 3.0, 1e9, -1.0):
        h.labels("a").observe(v)
    d = reg.histogram("d_seconds", "default buckets")
    for v in (1e-5, 1e-3, 0.02, 4.0):
        d.observe(v)


def _refusals(pkg):
    out = []
    reg = pkg.Registry()
    reg.counter("x_total", "", ("a",))
    for f in (lambda: reg.counter("x_total", "", ("b",)),
              lambda: reg.gauge("x_total", ""),
              lambda: reg.counter("bad name"),
              lambda: reg.counter("x_total", "", ("a",)).inc(),
              lambda: reg.counter("x_total", "", ("a",)).labels("v").inc(-1),
              lambda: reg.histogram("h", "", buckets=[float("inf")]),
              lambda: pkg.exponential_buckets(0, 2, 3)):
        try:
            f()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("ops", [_ops_counter, _ops_gauge, _ops_histogram],
                         ids=["counter", "gauge", "histogram"])
def test_registry_semantics_equal(ops):
    r, p = RT.Registry(), PT.Registry()
    ops(r)
    ops(p)
    assert r.snapshot() == p.snapshot()
    for m in r.collect():
        for child in m.children():
            labels = dict(zip(m.labelnames, child.labels))
            assert r.value(m.name, **labels) == p.value(m.name, **labels)
    assert r.value("nope") == p.value("nope") == 0.0


def test_registry_refusals_and_buckets_equal():
    assert _refusals(RT) == _refusals(PT)
    assert PT.DEFAULT_LATENCY_BUCKETS == RT.DEFAULT_LATENCY_BUCKETS
    assert PT.DEFAULT_SIZE_BUCKETS == RT.DEFAULT_SIZE_BUCKETS
    assert PT.exponential_buckets(1, 2.0, 13) == RT.exponential_buckets(
        1, 2.0, 13)


def _trace(pkg, max_spans):
    ticks = itertools.count()
    t = pkg.Tracer("run", clock=lambda: float(next(ticks)),
                   max_spans=max_spans)
    with t.span("outer", a=1) as sid:
        t.point("lane_admit", lane=3)
        inner = t.begin("inner", parent=sid, b="x")
        t.point("ticket_done", trace="tkt-t00000001", ticket="t00000001")
        t.end(inner)
    t.point("tail", parent=-1)
    t.close()
    return t


def _strip_chrome(doc):
    for ev in doc["traceEvents"]:
        ev.pop("pid")
        ev.pop("tid")
        if ev["args"]["trace_id"].startswith("trace-"):
            ev["args"]["trace_id"] = "self"
    doc["metadata"].pop("trace_id")
    return doc


def _strip_records(recs):
    for rec in recs:
        if rec["labels"]["trace"].startswith("trace-"):
            rec["labels"]["trace"] = "self"
    return recs


@pytest.mark.parametrize("max_spans", [100, 3])
def test_tracer_documents_equal(max_spans):
    r, p = _trace(RT, max_spans), _trace(PT, max_spans)
    assert _strip_chrome(r.to_chrome()) == _strip_chrome(p.to_chrome())
    assert _strip_records(r.to_records()) == _strip_records(p.to_records())
    assert r.dropped_spans == p.dropped_spans
    assert [s.name for s in r.find("lane_admit")] == [
        s.name for s in p.find("lane_admit")]
    assert list(r.traces().values()) == list(p.traces().values())
    one = _strip_chrome(p.to_chrome(trace_id="tkt-t00000001"))
    assert one == _strip_chrome(r.to_chrome(trace_id="tkt-t00000001"))


def test_tracer_jsonl(tmp_path):
    p = _trace(PT, 100)
    path = tmp_path / "t.jsonl"
    assert p.write_jsonl(str(path)) == len(p.spans())
    assert len(path.read_text().splitlines()) == len(p.spans())


@pytest.fixture(scope="module")
def graphs():
    return (RG.watts_strogatz(N, 6, 0.1, seed=2, source_csr=True),
            PG.watts_strogatz(N, 6, 0.1, seed=2, source_csr=True,
                              device="cpu"))


def _runs(pkg, g):
    """The same runs through each package's engine."""
    if pkg == "ref":
        E, F, MB, QB, PR = RE, RF, RMB, RQB, RPR
        key = jax.random.key(0)
    else:
        E, F, MB, QB, PR = PE, PF, PMB, PQB, PPR
        key = prng.key(0)
    flood = F.Flood(source=5)
    state, _ = E.run_until_coverage(g, flood, key, max_rounds=4)
    E.run_until_coverage_from(g, flood, state, key)
    E.run_until_converged(g, PR.PageRank(), key, stat="residual",
                          threshold=1e-3, max_rounds=64)
    proto = MB.BatchFlood()
    b = proto.init(g, np.array([1, 2, 3, 700], np.int32), capacity=40)
    b, _ = E.run_batch_until_coverage(g, proto, b, key, max_rounds=3)
    b, _ = E.run_batch_until_coverage(g, proto, b, key, max_rounds=64)
    b, _ = proto.admit(g, proto.retire(b, [1, 2]), np.array([9], np.int32))
    E.run_batch_until_coverage(g, proto, b, key, max_rounds=64)
    q = QB.MinPlusQueries()
    qb = q.init(g, np.array([0, 10], np.int32), np.array([500, 11], np.int32))
    qb, _ = E.run_queries_until_done(g, q, qb, key, max_rounds=2)
    qb, _ = E.run_queries_until_done(g, q, qb, key, max_rounds=64)
    q.retire(qb)


def _traced_runs(pkg, g):
    regs = {"ref": (RT, RH), "port": (PT, PH)}[pkg]
    T, H = regs
    reg, hist = T.Registry(), H.History(capacity=64)
    prev_reg = T.set_default_registry(reg)
    prev_hist = H.set_default_history(hist)
    ticks = itertools.count()
    tracer = T.Tracer("t", clock=lambda: float(next(ticks)))
    prev_tr = T.install_tracer(tracer)
    try:
        _runs(pkg, g)
    finally:
        T.install_tracer(prev_tr)
        H.set_default_history(prev_hist)
        T.set_default_registry(prev_reg)
    return reg, hist, tracer


@pytest.fixture(scope="module")
def both(graphs):
    return _traced_runs("ref", graphs[0]), _traced_runs("port", graphs[1])


def _sim_families(reg):
    return {m.name: (m.kind, m.help, m.labelnames,
                     getattr(m, "buckets", None))
            for m in reg.collect() if m.name.startswith("sim_")}


EXACT = ("sim_runs_total", "sim_rounds_total", "sim_messages_total",
         "sim_batch_active_lanes", "sim_query_active_lanes",
         "sim_last_coverage")


def test_run_summaries_equal(both):
    (r_reg, r_hist, _), (p_reg, p_hist, _) = both
    assert _sim_families(r_reg) == _sim_families(p_reg)
    r_snap, p_snap = r_reg.snapshot(), p_reg.snapshot()
    for name in EXACT:
        key = lambda s: sorted(s["labels"].items())  # noqa: E731
        assert sorted(r_snap[name]["samples"], key=key) == sorted(
            p_snap[name]["samples"], key=key), name
    for name in ("sim_batch_completion_rounds", "sim_query_completion_rounds",
                 "sim_frontier_occupancy"):
        got = {tuple(sorted(s["labels"].items())): (s["count"], s["buckets"])
               for s in p_snap[name]["samples"]}
        want = {tuple(sorted(s["labels"].items())): (s["count"], s["buckets"])
                for s in r_snap[name]["samples"]}
        assert got == want, name
    runs = sum(s["value"] for s in p_snap["sim_runs_total"]["samples"])
    assert runs == 8 and len(p_hist.rows()) == len(r_hist.rows()) == 8
    assert p_hist.series("sim_batch_active_lanes") and [
        v for _, v in p_hist.series("sim_batch_active_lanes")] == [
        v for _, v in r_hist.series("sim_batch_active_lanes")]


def _events(tracer):
    lanes = ("lane_", "batch_summary", "batch_run", "query_run")
    return [(s.name, {k: v for k, v in s.args.items()})
            for s in tracer.spans() if s.name.startswith(lanes)]


def test_lane_events_equal(both):
    (_, _, r_tr), (_, _, p_tr) = both
    got, want = _events(p_tr), _events(r_tr)
    names = {n for n, _ in got}
    assert {"lane_submit", "lane_admit", "lane_resume", "lane_freeze",
            "lane_complete", "lane_retire", "batch_summary", "batch_run",
            "query_run"} <= names
    assert got == want
    # The batch_run spans nest their lane events.
    runs = p_tr.find("batch_run")
    inside = [s for s in p_tr.spans() if s.parent_id == runs[0].span_id]
    assert inside and all(s.name.startswith(("lane_", "batch_summary"))
                          for s in inside)
