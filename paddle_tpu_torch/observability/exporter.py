"""Pull-based metrics exporter: stdlib HTTP, Prometheus text + JSON.

A daemon-thread ``http.server`` serving the process-global
`metrics.MetricRegistry`:

    GET /metrics             Prometheus text format 0.0.4
    GET /metrics.json        full registry snapshot as JSON
    GET /fleet/metrics       merged fleet registry (Prometheus, per-worker
                             labels) when a fleet.FleetCollector is active
    GET /fleet/metrics.json  collected fleet snapshot as JSON
    GET /fleet/trace         merged cross-worker chrome-trace JSON
    GET /alerts              SLO engine state (specs, burn rates, firing
                             alerts) when a slo.SloEngine is installed
    GET /healthz             liveness probe: plain 200 "ok" until an SLO
                             engine is installed, then a JSON
                             {status, firing, ...} body that turns
                             503/degraded while a page-severity alert
                             fires (each probe ticks the engine)
    GET /capacity            autoscaling state (policy, live/retiring
                             replicas, recent scale decisions) when a
                             capacity.CapacityController is installed

Enabled via ``PADDLE_TPU_METRICS_PORT`` (the engines call
`ensure_started_from_env()` at construction — one getenv when unset, so
serving/training pay nothing unless the operator opted in). Port 0 binds
an ephemeral port; read it back from ``exporter.port`` / ``exporter.url``.
Starting the exporter also enables the metrics registry — a scrape
endpoint with nothing feeding it would be useless.

Stdlib-only (counterpart of paddle_tpu/observability/exporter.py).
"""
from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from . import metrics as _metrics

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(BaseHTTPRequestHandler):
    registry = None  # class attr, bound per-server subclass

    def _send(self, code, body, ctype):
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        reg = self.registry or _metrics.default_registry()
        if path in ("/metrics", "/"):
            self._send(200, reg.to_prometheus(), PROM_CONTENT_TYPE)
        elif path in ("/metrics.json", "/snapshot"):
            self._send(200, json.dumps(reg.snapshot(), sort_keys=True),
                       "application/json")
        elif path.startswith("/fleet/"):
            self._do_fleet(path)
        elif path == "/healthz":
            self._do_healthz()
        elif path == "/alerts":
            self._do_alerts()
        elif path == "/capacity":
            self._do_capacity()
        else:
            self._send(404, "not found\n", "text/plain")

    def _do_healthz(self):
        from . import slo as _slo
        eng = _slo.active_engine()
        if eng is None:
            # no SLO engine installed: the original plain liveness
            # contract (200 "ok") — probes written against it keep working
            self._send(200, "ok\n", "text/plain")
            return
        try:
            st = eng.poll()  # scrape-driven evaluation, like /fleet/*
        except Exception as exc:
            self._send(503, f"slo evaluation failed: {exc}\n", "text/plain")
            return
        code = 503 if st["status"] == "degraded" else 200
        self._send(code, json.dumps(st, sort_keys=True, default=str),
                   "application/json")

    def _do_alerts(self):
        from . import slo as _slo
        eng = _slo.active_engine()
        if eng is None:
            self._send(404, "no slo engine installed\n", "text/plain")
            return
        try:
            eng.tick()
            doc = eng.doc()
        except Exception as exc:
            self._send(503, f"slo evaluation failed: {exc}\n", "text/plain")
            return
        self._send(200, json.dumps(doc, sort_keys=True, default=str),
                   "application/json")

    def _do_capacity(self):
        from . import capacity as _capacity
        ctl = _capacity.active_controller()
        if ctl is None:
            self._send(404, "no capacity controller installed\n",
                       "text/plain")
            return
        try:
            doc = ctl.doc()  # state only — scrapes must not drive scaling
        except Exception as exc:
            self._send(503, f"capacity state failed: {exc}\n", "text/plain")
            return
        self._send(200, json.dumps(doc, sort_keys=True, default=str),
                   "application/json")

    def _do_fleet(self, path):
        from . import fleet as _fleet
        coll = _fleet.active_collector()
        if coll is None:
            self._send(404, "no fleet collector installed\n", "text/plain")
            return
        try:
            fleet_snap = coll.collect()  # a scrape is a federation pass
        except Exception as exc:  # dead store mid-scrape: 503, not a crash
            self._send(503, f"fleet collect failed: {exc}\n", "text/plain")
            return
        if path == "/fleet/metrics":
            self._send(200, _fleet.fleet_to_prometheus(fleet_snap),
                       PROM_CONTENT_TYPE)
        elif path == "/fleet/metrics.json":
            self._send(200, json.dumps(fleet_snap, sort_keys=True,
                                       default=str), "application/json")
        elif path == "/fleet/trace":
            self._send(200, json.dumps(coll.merged_chrome_trace()),
                       "application/json")
        else:
            self._send(404, "not found\n", "text/plain")

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass


class MetricsExporter:
    """HTTP scrape endpoint for a MetricRegistry (daemon thread)."""

    def __init__(self, registry: Optional[_metrics.MetricRegistry] = None,
                 port: int = 0, host: str = "127.0.0.1"):
        self.registry = registry or _metrics.default_registry()
        self.host = host
        self.port = port
        self._server = None
        self._thread = None

    def start(self) -> "MetricsExporter":
        if self._server is not None:
            return self
        handler = type("_BoundHandler", (_Handler,),
                       {"registry": self.registry})
        self._server = ThreadingHTTPServer((self.host, self.port), handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="paddle-tpu-metrics",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
            if self._thread is not None:
                self._thread.join(timeout=5)
                self._thread = None

    @property
    def running(self) -> bool:
        return self._server is not None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"


_global: Optional[MetricsExporter] = None
_lock = threading.Lock()


def start_exporter(port: int = 0, host: str = "127.0.0.1") -> MetricsExporter:
    """Start (or return) the process-global exporter; enables metrics."""
    global _global
    with _lock:
        if _global is None or not _global.running:
            _metrics.enable()
            _global = MetricsExporter(port=port, host=host).start()
        return _global


def get_exporter() -> Optional[MetricsExporter]:
    return _global


def stop_exporter() -> None:
    global _global
    with _lock:
        if _global is not None:
            _global.stop()
            _global = None


def ensure_started_from_env() -> Optional[MetricsExporter]:
    """Start the global exporter iff PADDLE_TPU_METRICS_PORT is set.

    Idempotent; called from engine constructors. Returns the exporter (or
    None when the env var is absent/invalid).
    """
    raw = os.environ.get("PADDLE_TPU_METRICS_PORT")
    if not raw:
        return _global
    try:
        port = int(raw)
    except ValueError:
        return _global
    with _lock:
        already = _global is not None and _global.running
    if already:
        return _global
    return start_exporter(port=port)
