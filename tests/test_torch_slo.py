"""The port's SLO engine, exporters and HTTP endpoint
(``telemetry/slo.py``, ``telemetry/export.py``, ``telemetry/httpd.py``,
``utils/logging.py``) against the JAX package's, on the CPU.

- ``Objective`` / ``serve_objectives``: the same declarations and
  validation; ``SLOEngine`` fed the same seeded streams: the same
  per-tick states, firings, gauges, counters and alert records.
- ``SimService(slo=)``: a drive whose admission objective fires equals
  the reference's drive (tickets, sheds, admit budget, SLO snapshot).
- ``to_prometheus`` / ``metric_records`` / ``write_jsonl`` /
  ``EventLog.to_jsonl``: equal text for equal registry contents.
- ``MetricsServer`` on localhost, beside the reference's: the same
  status codes and documents for ``/metrics``, ``/metrics.json``,
  ``/history`` and ``/trace`` with their query-parameter cases,
  ``/dashboard`` and ``/dashboard.json``, and the service mount
  (``/submit``, ``/poll``, ``/stats``), a bad body and an unknown path.

Every comparison is exact (wall-clock fields aside, which are named).
"""

import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu import serve as RS  # noqa: E402
from p2pnetwork_tpu import telemetry as RT  # noqa: E402
from p2pnetwork_tpu.sim import graph as RG  # noqa: E402
from p2pnetwork_tpu.telemetry import export as RX  # noqa: E402
from p2pnetwork_tpu.telemetry import history as RHi  # noqa: E402
from p2pnetwork_tpu.telemetry import httpd as RHt  # noqa: E402
from p2pnetwork_tpu.telemetry import slo as RSlo  # noqa: E402
from p2pnetwork_tpu.telemetry import spans as RSp  # noqa: E402
from p2pnetwork_tpu.utils import logging as RL  # noqa: E402
from p2pnetwork_tpu_torch import serve as PS  # noqa: E402
from p2pnetwork_tpu_torch import telemetry as PT  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as PG  # noqa: E402
from p2pnetwork_tpu_torch.telemetry import export as PX  # noqa: E402
from p2pnetwork_tpu_torch.telemetry import history as PHi  # noqa: E402
from p2pnetwork_tpu_torch.telemetry import httpd as PHt  # noqa: E402
from p2pnetwork_tpu_torch.telemetry import slo as PSlo  # noqa: E402
from p2pnetwork_tpu_torch.telemetry import spans as PSp  # noqa: E402
from p2pnetwork_tpu_torch.utils import logging as PL  # noqa: E402
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

#: The same package-neutral modules by name, for building twins.
REF = dict(slo=RSlo, reg=RT, log=RL, export=RX, hist=RHi, httpd=RHt,
           spans=RSp, serve=RS)
PORT = dict(slo=PSlo, reg=PT, log=PL, export=PX, hist=PHi, httpd=PHt,
            spans=PSp, serve=PS)


def _alerts(eng):
    """Alert records without their monotonic timestamps."""
    return [(r.event, r.peer_id, r.data) for r in eng.log.snapshot()]


# ------------------------------------------------------------ objectives


def test_objectives_equal_the_reference():
    for kw in (dict(slo_rounds=24), dict(slo_rounds=8, wall_s=2.0),
               dict(slo_rounds=16, durability_goal=0.999, shed_goal=0.9)):
        assert [o.spec() for o in PSlo.serve_objectives(**kw)] \
            == [o.spec() for o in RSlo.serve_objectives(**kw)]
    for kw, match in ((dict(mode="eq"), "mode"), (dict(goal=1.0), "goal"),
                      (dict(fast_window=8, slow_window=4), "fast_window"),
                      (dict(burn_threshold=0.0), "burn_threshold")):
        for m in (RSlo, PSlo):
            with pytest.raises(ValueError, match=match):
                m.Objective("o", metric="m", target=1.0, **kw)
    with pytest.raises(ValueError, match="duplicate"):
        PSlo.SLOEngine([PSlo.Objective("o", metric="m", target=1.0)] * 2,
                       registry=PT.Registry())


def _engine(mods):
    objs = [mods["slo"].Objective("rounds_p", metric="rounds", target=10.0,
                                  goal=0.5, fast_window=4, slow_window=8,
                                  admission_signal=True),
            mods["slo"].Objective("wall_p", metric="wall", target=0.5,
                                  mode="le", goal=0.9, fast_window=2,
                                  slow_window=6),
            mods["slo"].Objective("ok_ge", metric="ok", target=1.0,
                                  mode="ge", goal=0.75, fast_window=3,
                                  slow_window=3, burn_threshold=1.0)]
    reg = mods["reg"].Registry()
    return mods["slo"].SLOEngine(objs, registry=reg,
                                 log=mods["log"].EventLog()), reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_equals_the_reference_on_seeded_streams(seed):
    rng = np.random.default_rng(seed)
    (re, rreg), (pe, preg) = _engine(REF), _engine(PORT)
    for tick in range(40):
        for _ in range(int(rng.integers(0, 4))):
            v = float(rng.choice([1.0, 99.0], p=[0.55, 0.45]))
            re.record("rounds", v)
            pe.record("rounds", v)
        w = float(rng.random())
        ok = float(rng.integers(0, 2))
        for eng in (re, pe):
            eng.record("wall", w)
            eng.record("ok", ok)
            eng.record("unjudged", 1.0)
        assert pe.evaluate(tick) == re.evaluate(tick)
        assert pe.firing() == re.firing()
        assert pe.firing(admission_only=True) \
            == re.firing(admission_only=True)
    assert _alerts(pe) == _alerts(re) and _alerts(pe)
    assert preg.snapshot() == rreg.snapshot()
    snap_p, snap_r = pe.snapshot(), re.snapshot()
    for s in (snap_p, snap_r):
        for a in s["alerts"]:
            a.pop("timestamp")
    assert snap_p == snap_r


# ----------------------------------------------------------- service slo=


def _slo_drive(mods, g):
    reg = mods["reg"].Registry()
    slo = mods["slo"].SLOEngine(
        [mods["slo"].Objective("tight_rounds", metric="completion_rounds",
                               target=4.0, goal=0.5, fast_window=2,
                               slow_window=4, burn_threshold=2.0,
                               admission_signal=True),
         *mods["slo"].serve_objectives(slo_rounds=1024)[1:]],
        registry=reg, log=mods["log"].EventLog())
    svc = mods["serve"].SimService(g, capacity=32, queue_depth=16,
                                   chunk_rounds=4, seed=0, slo=slo,
                                   record_seen_hash=True, registry=reg)
    sched = mods["serve"].generate(mods["serve"].TrafficPattern(
        ticks=10, rate=6.0, coverage_target=0.9), g.n_nodes, seed=7)
    out = mods["serve"].drive(svc, sched)
    svc.close()
    snap = slo.snapshot()
    for a in snap["alerts"]:
        a.pop("timestamp")
    return out, svc.stats()["admit_budget"], snap, _alerts(slo)


def test_service_slo_equals_the_reference():
    want = _slo_drive(REF, RG.watts_strogatz(300, 6, 0.2, seed=3))
    got = _slo_drive(PORT, PG.watts_strogatz(300, 6, 0.2, seed=3,
                                             device="cpu"))
    assert got == want
    assert want[2]["objectives"]["tight_rounds"]["firing"] \
        or any(a[2]["transition"] == "fire" for a in want[3])
    assert want[1] < 32  # the firing objective cut the admit budget


# ---------------------------------------------------------------- export


def _fill(reg_mod):
    reg = reg_mod.Registry()
    reg.counter("c_total", 'help "quoted"\nline', ("kind",)).labels(
        'a"b\\c').inc(3)
    reg.counter("plain_total", "").inc(0.5)
    g = reg.gauge("g", "gauge", ("x", "y"))
    g.labels("1", "2").set(float("inf"))
    g.labels("3", "4").set(-2.0)
    h = reg.histogram("h_seconds", "hist", ("loop",),
                      buckets=(0.1, 1.0, 2.5))
    for v in (0.05, 0.5, 0.5, 3.0, 1e9):
        h.labels("a").observe(v)
    reg.histogram("empty_seconds", "none")
    return reg


def test_exports_equal_the_reference():
    r, p = _fill(RT), _fill(PT)
    assert PX.to_prometheus(p) == RX.to_prometheus(r)
    assert list(PX.metric_records(p, ts=5.0)) \
        == list(RX.metric_records(r, ts=5.0))
    sinks = io.StringIO(), io.StringIO()
    assert PX.write_jsonl(p, sinks[0], ts=1.0) \
        == RX.write_jsonl(r, sinks[1], ts=1.0)
    assert sinks[0].getvalue() == sinks[1].getvalue()
    assert PX.event_record("e", 1.5, 7, {"k": object}) \
        == RX.event_record("e", 1.5, 7, {"k": object})


def test_event_log_equals_the_reference(tmp_path):
    logs = RL.EventLog(maxlen=3), PL.EventLog(maxlen=3)
    for log in logs:
        for i in range(5):
            log.record("ev", None if i % 2 else f"p{i}", {"i": i})
        assert log.count() == 3 and log.count("ev") == 3
    assert [(e.event, e.peer_id, e.data) for e in logs[1].snapshot()] \
        == [(e.event, e.peer_id, e.data) for e in logs[0].snapshot()]
    path = tmp_path / "events.jsonl"
    assert logs[1].to_jsonl(str(path)) == 3
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [(x["name"], x["labels"], x["data"]) for x in lines] \
        == [("ev", {"peer": "p2"}, {"i": 2}), ("ev", {}, {"i": 3}),
            ("ev", {"peer": "p4"}, {"i": 4})]
    logs[1].clear()
    assert logs[1].count() == 0


# ----------------------------------------------------------------- httpd


def _get(port, path, data=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method="POST" if data is not None
                                 else "GET")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


def _server_world(mods, g):
    reg = _fill(mods["reg"])
    reg.gauge("sight_g", "g").set(0.0)
    hist = mods["hist"].History(reg, capacity=16)
    for i in range(6):
        reg.gauge("sight_g", "g").set(float(i))
        hist.sample(ts=float(i))
    tracer = mods["spans"].Tracer("srv")
    tracer.point("mine", trace="tkt-t0")
    tracer.point("other", trace="tkt-t1")
    slo = mods["slo"].SLOEngine(mods["slo"].serve_objectives(slo_rounds=8),
                                registry=reg)
    slo.record("completion_rounds", 4.0)
    slo.evaluate(0)
    svc = mods["serve"].SimService(g, capacity=32, chunk_rounds=4, seed=0,
                                   registry=reg)
    return reg, hist, tracer, slo, svc


QUERIES = ["/metrics", "/", "/metrics.json", "/history", "/history?n=2",
           "/history?n=zero", "/history?n=0", "/history?n=-3",
           "/trace?trace_id=tkt-t0", "/trace?trace_id=", "/stats",
           "/poll/{ticket}", "/poll/nope", "/submit?source=5", "/nope"]


def _strip(path, body):
    """A response body with its wall-clock and trace-id fields dropped."""
    if path in ("/metrics", "/"):
        return body
    doc = json.loads(body)
    if path.startswith("/trace"):
        for ev in doc.get("traceEvents", []):
            for k in ("ts", "dur", "pid"):
                ev.pop(k, None)
            ev.pop("tid", None)
    return doc


def test_metrics_server_answers_as_the_reference():
    g_r = RG.watts_strogatz(300, 6, 0.2, seed=3)
    g_p = PG.watts_strogatz(300, 6, 0.2, seed=3, device="cpu")
    answers = []
    for mods, g in ((REF, g_r), (PORT, g_p)):
        reg, hist, tracer, slo, svc = _server_world(mods, g)
        got = {}
        with mods["httpd"].MetricsServer(reg, port=0, history=hist,
                                         tracer=tracer, service=svc,
                                         slo=slo) as srv:
            assert srv.url.endswith(f":{srv.port}/metrics")
            post = _get(srv.port, "/submit",
                        json.dumps({"source": 3}).encode())
            got["post"] = (post[0], json.loads(post[2]))
            svc.tick()
            for q in QUERIES:
                code, ctype, body = _get(
                    srv.port, q.format(ticket=got["post"][1]["ticket"]))
                got[q] = (code, ctype, _strip(q, body) if code == 200
                          else json.loads(body).get("error")
                          if ctype == "application/json" else None)
            got["bad-body"] = _get(srv.port, "/submit", b"{not json")[:2]
            got["post-404"] = _get(srv.port, "/nope", b"{}")[0]
            code, _, page = _get(srv.port, "/dashboard")
            island = page.split('<script id="data" '
                                'type="application/json">')[1]
            island = json.loads(island.split("</script>")[0]
                                .replace("<\\/", "</"))
            code_j, _, doc = _get(srv.port, "/dashboard.json")
            doc = json.loads(doc)
            got["dashboard"] = (code, code_j, sorted(doc), sorted(island),
                                doc["slo"],
                                {t: n for t, n in doc["traces"]["recent"]
                                 .items() if t.startswith("tkt-")},
                                doc["traces"]["total"],
                                sorted(doc["service"]))
        srv.close()  # idempotent
        svc.close()
        answers.append(got)
    want, got = answers
    for key in want:
        if key in ("/stats", "/metrics.json", "/metrics", "/"):
            continue  # the registries' own families differ (see below)
        assert got[key] == want[key], key
    assert got["/stats"][:2] == want["/stats"][:2]
    assert got["/history?n=2"][2]["series"]["sight_g"][0]["points"] \
        == [[4.0, 4.0], [5.0, 5.0]]
    assert got["post"][0] == 202 and got["/poll/{ticket}"][0] == 200
    assert got["/history?n=0"][0] == 400 and got["/nope"][0] == 404
    # /metrics carries the services' serve_ families: present in both,
    # and the families the test filled render equal.
    for fam in ("c_total", "h_seconds", "serve_submitted_total",
                "slo_burn_rate"):
        assert f"# TYPE {fam} " in got["/metrics"][2]
    lines = [x for x in got["/metrics"][2].splitlines()
             if x.split("{")[0].split(" ")[0] in ("c_total", "g",
                                                  "h_seconds_bucket")]
    assert lines == [x for x in want["/metrics"][2].splitlines()
                     if x.split("{")[0].split(" ")[0] in
                     ("c_total", "g", "h_seconds_bucket")]


def test_dashboard_doc_without_slo_or_service():
    reg = PT.Registry()
    doc = PHt.dashboard_doc(reg, PHi.History(reg, capacity=4), None, None,
                            None)
    assert doc["slo"] is None and doc["service"] is None \
        and doc["traces"] is None
    json.dumps(doc)
