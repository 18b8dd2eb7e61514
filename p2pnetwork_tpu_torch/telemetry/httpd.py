"""Live scrape endpoint: a stdlib HTTP server exposing the registry (the
port's copy of ``p2pnetwork_tpu/telemetry/httpd.py``, its routes,
parameters and documents).

``GET /metrics`` serves Prometheus text exposition; ``GET /metrics.json``
the registry snapshot as JSON; ``GET /history`` the history ring
(:mod:`p2pnetwork_tpu_torch.telemetry.history`; ``?n=`` limits to the
last N samples); ``GET /trace`` the installed trace plane as
Chrome/Perfetto trace-event JSON (:mod:`p2pnetwork_tpu_torch.telemetry.spans`;
an empty ``traceEvents`` array when no tracer is installed;
``?trace_id=`` exports one logical trace, e.g. one serve ticket's
``tkt-<id>`` lifecycle). Malformed query params are a 400 with the error
named, never a 500. ``GET /dashboard`` serves a self-contained HTML
snapshot (metrics, recent history, SLO state, recent traces and the bound
service's tick-phase profile, embedded as one JSON document);
``GET /dashboard.json`` is the same document bare. Zero dependencies:
``http.server.ThreadingHTTPServer`` on one daemon thread.

An application mounts its own endpoints next to the telemetry ones via
``service=``: any object with ``handle_http(method, path, body) ->
(status, payload_dict) | None`` gets every request the built-in routes do
not claim (``None`` falls through to 404). The serving front-end
(:class:`p2pnetwork_tpu_torch.serve.SimService`: ``/submit``,
``/poll/<t>``, ``/cancel/<t>``, ``/stats``) is the one implementation,
duck-typed here so this module stays stdlib-only.
"""

from __future__ import annotations

import http.server
import json
import time
import urllib.parse
from typing import Any, Optional

from p2pnetwork_tpu_torch import concurrency
from p2pnetwork_tpu_torch.telemetry.registry import Registry, default_registry
from p2pnetwork_tpu_torch.telemetry import export, history, spans

__all__ = ["MetricsServer", "dashboard_doc"]

#: /dashboard bounds what it embeds — it is a snapshot for a browser
#: tab, not a bulk-export path (/metrics.json, /history and /trace
#: remain the full-fidelity endpoints).
_DASHBOARD_HISTORY_N = 128
_DASHBOARD_TRACES_N = 64


class _BadQuery(ValueError):
    """A malformed query param — the handler answers 400, not 500."""


def _query_int(params: dict, key: str) -> Optional[int]:
    """Parse an optional positive-int query param; :class:`_BadQuery`
    names the offending value on anything else."""
    vals = params.get(key)
    if not vals:
        return None
    try:
        n = int(vals[-1])
    except ValueError:
        raise _BadQuery(f"{key} must be an integer, got {vals[-1]!r}")
    if n < 1:
        raise _BadQuery(f"{key} must be >= 1, got {n}")
    return n


def dashboard_doc(registry: Registry, hist: Any, tracer: Optional[Any],
                  slo: Optional[Any], service: Optional[Any]) -> dict:
    """The one JSON document behind ``/dashboard`` and
    ``/dashboard.json``: metrics snapshot, recent history samples, the
    SLO engine's state (duck-typed ``snapshot()``), a recent-traces
    table, and the bound service's dashboard slice (duck-typed
    ``dashboard_slice()`` — :class:`p2pnetwork_tpu_torch.serve.SimService`
    publishes its tick-phase profile and stats through it). Module-level
    so a test can exercise the exact scrape path without sockets."""
    doc: dict = {
        "generated_unix": time.time(),
        "metrics": registry.snapshot(),
        "history": hist.snapshot(last=_DASHBOARD_HISTORY_N),
        "slo": None,
        "traces": None,
        "service": None,
    }
    if slo is not None:
        doc["slo"] = slo.snapshot()
    if tracer is not None:
        by_trace = tracer.traces()
        doc["traces"] = {
            "trace_id": tracer.trace_id,
            "dropped_spans": tracer.dropped_spans,
            "recent": dict(list(by_trace.items())[-_DASHBOARD_TRACES_N:]),
            "total": len(by_trace),
        }
    if service is not None:
        slicer = getattr(service, "dashboard_slice", None)
        if callable(slicer):
            doc["service"] = slicer()
    return doc


#: Self-contained dashboard page: the snapshot JSON rides in a
#: <script type="application/json"> island and a few lines of inline JS
#: render the tables — no assets, no CDN, works from a file:// save.
_DASHBOARD_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>graftsight dashboard</title>
<style>
 body{font-family:monospace;margin:1.5em;background:#111;color:#ddd}
 h1{font-size:1.2em} h2{font-size:1em;margin-top:1.2em;color:#8cf}
 table{border-collapse:collapse;margin:.3em 0}
 td,th{border:1px solid #444;padding:.15em .5em;text-align:left}
 .firing{color:#f66;font-weight:bold} .ok{color:#6d6}
 pre{white-space:pre-wrap}
</style></head><body>
<h1>graftsight dashboard</h1>
<div id="out">(rendering…)</div>
<script id="data" type="application/json">__DATA__</script>
<script>
 const d = JSON.parse(document.getElementById("data").textContent);
 const esc = s => String(s).replace(/[&<>]/g,
   c => ({"&":"&amp;","<":"&lt;",">":"&gt;"}[c]));
 const row = cells => "<tr>" + cells.map(c => "<td>" + esc(c) +
   "</td>").join("") + "</tr>";
 let h = "<h2>SLOs</h2>";
 if (d.slo && d.slo.objectives) {
   h += "<table><tr><th>objective</th><th>state</th><th>good</th>" +
        "<th>burn fast</th><th>burn slow</th><th>samples</th></tr>";
   for (const [name, o] of Object.entries(d.slo.objectives))
     h += "<tr><td>" + esc(name) + "</td><td class=" +
          (o.firing ? "firing>FIRING" : "ok>ok") + "</td>" +
          [o.good_ratio, o.burn_fast, o.burn_slow, o.samples]
            .map(v => "<td>" + esc(v) + "</td>").join("") + "</tr>";
   h += "</table>";
 } else h += "<p>(no SLO engine bound)</p>";
 h += "<h2>Tick phases</h2>";
 const tp = d.service && d.service.tick_phases;
 if (tp && tp.ticks) {
   h += "<p>ticks: " + esc(tp.ticks) + "</p><table><tr><th>phase</th>" +
        "<th>total s</th><th>mean s</th><th>last s</th><th>max s</th></tr>";
   for (const [ph, s] of Object.entries(tp.per_phase))
     h += row([ph, s.total_s.toExponential(3), s.mean_s.toExponential(3),
               s.last_s.toExponential(3), s.max_s.toExponential(3)]);
   h += "</table>";
 } else h += "<p>(no service bound / no ticks yet)</p>";
 h += "<h2>Recent traces</h2>";
 if (d.traces) {
   h += "<p>dropped spans: " + esc(d.traces.dropped_spans) +
        "</p><table><tr><th>trace id</th><th>spans</th></tr>";
   for (const [t, n] of Object.entries(d.traces.recent)) h += row([t, n]);
   h += "</table>";
 } else h += "<p>(no tracer installed)</p>";
 h += "<h2>History</h2><p>" + esc(d.history.samples) +
      " samples embedded (series: " +
      esc(Object.keys(d.history.series).length) + ")</p>";
 h += "<h2>Raw snapshot</h2><pre>" +
      esc(JSON.stringify(d, null, 1).slice(0, 20000)) + "</pre>";
 document.getElementById("out").innerHTML = h;
</script></body></html>
"""


class _Handler(http.server.BaseHTTPRequestHandler):
    registry: Registry      # stamped onto the subclass by MetricsServer
    history: Optional[Any]  # History or None (None = process default)
    tracer: Optional[Any]   # Tracer or None (None = installed tracer)
    service: Optional[Any] = None  # handle_http provider or None
    slo: Optional[Any] = None      # SLO engine (snapshot()) or None

    def _respond(self, status: int, body: bytes, ctype: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _respond_json(self, status: int, payload: Any) -> None:
        self._respond(status, json.dumps(payload).encode("utf-8"),
                      "application/json")

    def _dispatch_service(self, method: str, body: Optional[dict]) -> bool:
        """Offer the request to the bound service; True when it claimed
        it. Service errors become a 500 with the error named — a buggy
        handler must not wedge the scrape thread."""
        if self.service is None:
            return False
        try:
            resp = self.service.handle_http(method, self.path, body)
        except Exception as e:
            self._respond_json(
                500, {"error": f"{type(e).__name__}: {e}"})
            return True
        if resp is None:
            return False
        status, payload = resp
        self._respond_json(int(status), payload)
        return True

    def _resolve_history(self):
        return self.history if self.history is not None \
            else history.default_history()

    def _resolve_tracer(self):
        return self.tracer if self.tracer is not None \
            else spans.current_tracer()

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler's contract
        split = urllib.parse.urlsplit(self.path)
        path = split.path
        # keep_blank_values: ``?trace_id=`` must reach the validator (and
        # 400) rather than silently parse as "no param".
        params = urllib.parse.parse_qs(split.query, keep_blank_values=True)
        try:
            if path in ("/metrics", "/"):
                body = export.to_prometheus(self.registry).encode("utf-8")
                self._respond(200, body,
                              "text/plain; version=0.0.4; charset=utf-8")
                return
            if path == "/metrics.json":
                self._respond_json(200, self.registry.snapshot())
                return
            if path == "/history":
                n = _query_int(params, "n")
                self._respond_json(200,
                                   self._resolve_history().snapshot(last=n))
                return
            if path == "/trace":
                trace_id = None
                if "trace_id" in params:
                    trace_id = params["trace_id"][-1]
                    if not trace_id:
                        raise _BadQuery("trace_id must be non-empty")
                tracer = self._resolve_tracer()
                doc = tracer.to_chrome(trace_id=trace_id) \
                    if tracer is not None \
                    else {"traceEvents": [], "displayTimeUnit": "ms",
                          "metadata": {"dropped_spans": 0, "spans": 0,
                                       "traces": 0, "trace_id": None}}
                self._respond_json(200, doc)
                return
            if path in ("/dashboard", "/dashboard.json"):
                doc = dashboard_doc(self.registry, self._resolve_history(),
                                    self._resolve_tracer(), self.slo,
                                    self.service)
                if path == "/dashboard.json":
                    self._respond_json(200, doc)
                    return
                # "</" must not terminate the script island early — the
                # standard JSON-in-HTML embedding escape.
                blob = json.dumps(doc).replace("</", "<\\/")
                page = _DASHBOARD_HTML.replace("__DATA__", blob)
                self._respond(200, page.encode("utf-8"),
                              "text/html; charset=utf-8")
                return
        except _BadQuery as e:
            self._respond_json(400, {"error": str(e)})
            return
        if self._dispatch_service("GET", None):
            return
        self.send_error(404)

    def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler's contract
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            length = 0
        raw = self.rfile.read(length) if length > 0 else b""
        body: Optional[dict] = None
        if raw:
            try:
                parsed = json.loads(raw.decode("utf-8"))
                body = parsed if isinstance(parsed, dict) else None
            except ValueError:
                self._respond_json(400, {"error": "body is not JSON"})
                return
        if self._dispatch_service("POST", body):
            return
        self.send_error(404)

    def log_message(self, fmt, *args):  # scrapes must not spam stdout
        pass


class MetricsServer:
    """Serve ``registry`` over HTTP on a background daemon thread.

    ``port=0`` binds an ephemeral port (read it back from ``.port`` after
    :meth:`start` — the OS-assigned port is reported, so test fixtures
    and co-located services never race over fixed ports).
    ``history``/``tracer`` bind a specific history ring / trace collector
    to ``/history`` and ``/trace``; by default those endpoints follow the
    process-wide
    :func:`~p2pnetwork_tpu_torch.telemetry.history.default_history` and the
    tracer installed via
    :func:`~p2pnetwork_tpu_torch.telemetry.spans.install_tracer`, resolved per
    request. ``service`` mounts application endpoints beside the
    telemetry ones (module docstring); ``slo`` binds an SLO
    engine (:class:`p2pnetwork_tpu_torch.telemetry.slo.SLOEngine`, duck-typed
    ``snapshot()``) into ``/dashboard``. ``start``/:meth:`close` are
    idempotent and safe to race from several threads — the whole
    lifecycle is serialized by one lock, so concurrent start/close pairs
    settle into a consistent state instead of leaking a server or
    double-binding a port. Usable as a context manager::

        with MetricsServer(port=0) as srv:
            print(f"curl http://127.0.0.1:{srv.port}/metrics")
    """

    def __init__(self, registry: Optional[Registry] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 history: Optional[Any] = None,
                 tracer: Optional[Any] = None,
                 service: Optional[Any] = None,
                 slo: Optional[Any] = None):
        self.registry = registry or default_registry()
        self.history = history
        self.tracer = tracer
        self.service = service
        self.slo = slo
        self.host = host
        self.port = port
        #: The port asked for at construction: a close() must rebind the
        #: SAME ephemeral request (0 = "any"), not the port the previous
        #: start happened to get (which may be taken by then).
        self._requested_port = port
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[Any] = None
        # Serializes the whole start/stop lifecycle: concurrent starts
        # must agree on ONE bound server, and a close racing a start must
        # observe either the unstarted or the fully-started state.
        self._lifecycle_lock = concurrency.lock()

    def start(self) -> "MetricsServer":
        with self._lifecycle_lock:
            if self._httpd is not None:
                return self
            handler = type("BoundHandler", (_Handler,),
                           {"registry": self.registry,
                            "history": self.history,
                            "tracer": self.tracer,
                            "service": self.service,
                            "slo": self.slo})
            self._httpd = http.server.ThreadingHTTPServer(  # graftlint: ignore[lock-open-call] -- the bind must be atomic with the started-state publish, or two racing starts double-bind
                (self.host, self._requested_port), handler)
            self.port = self._httpd.server_address[1]
            self._thread = concurrency.thread(  # graftlint: ignore[lock-open-call] -- same lifecycle atomicity; the seam factory only constructs
                target=self._httpd.serve_forever,
                name=f"MetricsServer({self.host}:{self.port})", daemon=True)
            self._thread.start()  # graftlint: ignore[lock-open-call] -- same lifecycle atomicity; start() does not block on the serve loop
        return self

    def stop(self) -> None:
        """Shut the server down and release the port. Idempotent — a
        second (or concurrent) call is a no-op; :meth:`close` is the
        same operation under the conventional resource name."""
        with self._lifecycle_lock:
            httpd, thread = self._httpd, self._thread
            self._httpd = self._thread = None
            if httpd is None:
                return
            httpd.shutdown()  # graftlint: ignore[lock-open-call] -- teardown must be atomic with the stopped-state publish; bounded (serve loop poll interval)
            httpd.server_close()  # graftlint: ignore[lock-open-call] -- same teardown atomicity
            if thread is not None:
                thread.join(timeout=5.0)  # graftlint: ignore[lock-open-call] -- same teardown atomicity; bounded join

    def close(self) -> None:
        """Alias of :meth:`stop` (idempotent)."""
        self.stop()

    @property
    def url(self) -> str:
        with self._lifecycle_lock:
            port = self.port
        return f"http://{self.host}:{port}/metrics"

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
