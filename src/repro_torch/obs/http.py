"""Wire surface: a stdlib background HTTP exporter for the telemetry.

Port of `repro/obs/http.py`, unchanged: the same endpoints, content types
and JSON bodies.

The repo's first network endpoint — everything before this PR exported
telemetry as files (metrics JSONL / Prometheus textfiles). `MetricsServer`
runs a `http.server.ThreadingHTTPServer` on a daemon thread and serves:

  * ``GET /metrics``  — the live registry in Prometheus text exposition
    format (`obs.export.prometheus_text`), scrape-ready;
  * ``GET /healthz``  — liveness JSON (status, uptime, scrape count);
  * ``GET /slo``      — burn-rate verdicts from an attached
    `slo.SloPlane` (`{"slos": [...]}`; empty list when none attached).

Serving is pure host-side Python over the always-on registry: a scrape
never touches the solver, never blocks on device work, and launches
nothing on the card. Registry reads are
lock-free snapshots — metric mutation is monotone, so a torn read is at
worst one observation stale (same contract as `obs.export`).

Default bind is loopback with an ephemeral port (`port=0`); read the
bound port from `server.port` after `start()`. Use as a context manager
for scoped serving::

    with MetricsServer(slo_plane=plane) as srv:
        print(srv.url("/metrics"))
        ... serve traffic ...
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .export import prometheus_text
from .metrics import MetricsRegistry, REGISTRY

__all__ = ["MetricsServer", "PROMETHEUS_CONTENT_TYPE"]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(BaseHTTPRequestHandler):
    # set per-server via the factory in MetricsServer.start
    server_ref: "MetricsServer"

    def do_GET(self):   # noqa: N802 - BaseHTTPRequestHandler API
        srv = self.server_ref
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            srv.registry.counter("obs_scrapes", path="/metrics").inc()
            body = prometheus_text(srv.registry).encode()
            self._reply(200, PROMETHEUS_CONTENT_TYPE, body)
        elif path == "/healthz":
            srv.registry.counter("obs_scrapes", path="/healthz").inc()
            body = json.dumps(dict(
                status="ok",
                uptime_s=time.monotonic() - srv._t_start)).encode()
            self._reply(200, "application/json", body)
        elif path == "/slo":
            srv.registry.counter("obs_scrapes", path="/slo").inc()
            plane = srv.slo_plane
            verdicts = plane.check() if plane is not None else []
            body = json.dumps(dict(slos=verdicts),
                              allow_nan=False).encode()
            self._reply(200, "application/json", body)
        else:
            self._reply(404, "application/json",
                        b'{"error": "not found", '
                        b'"paths": ["/metrics", "/healthz", "/slo"]}')

    def _reply(self, code: int, ctype: str, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):   # silence per-request stderr spam
        pass


class MetricsServer:
    """Background scrape endpoint over one registry (+ optional SLO plane).

    Parameters
    ----------
    registry : the `MetricsRegistry` to expose (default: the global one).
    slo_plane : an `slo.SloPlane` whose `check()` backs ``/slo``.
    host, port : bind address; `port=0` (default) picks an ephemeral port,
        available as `self.port` after `start()`.
    observe_period_s : when set (and an `slo_plane` is attached), `start()`
        also spins up an `slo.SloObserver` daemon sampling the plane's
        burn-rate rings every that many seconds, so ``/slo`` verdicts stay
        window-accurate even when nobody scrapes and the serving loop
        stalls. The observer is stopped (cleanly, mid-sleep) on `stop()`.
    observe_clock : injectable clock for that observer (tests drive the
        rings with logical ticks).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 slo_plane=None, host: str = "127.0.0.1", port: int = 0,
                 observe_period_s: Optional[float] = None,
                 observe_clock=None):
        self.registry = registry if registry is not None else REGISTRY
        self.slo_plane = slo_plane
        self.host = host
        self.port = int(port)
        self.observe_period_s = observe_period_s
        self.observe_clock = observe_clock
        self.observer = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._t_start = time.monotonic()

    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            return self
        handler = type("BoundHandler", (_Handler,), dict(server_ref=self))
        self._httpd = ThreadingHTTPServer((self.host, self.port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._t_start = time.monotonic()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="obs-http")
        self._thread.start()
        if self.observe_period_s is not None and self.slo_plane is not None:
            from .slo import SloObserver   # local: no import cycle at load
            self.observer = SloObserver(self.slo_plane,
                                        period_s=self.observe_period_s,
                                        clock=self.observe_clock).start()
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        if self.observer is not None:
            self.observer.stop()
            self.observer = None
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join()
        self._httpd = None
        self._thread = None

    @property
    def running(self) -> bool:
        return self._httpd is not None

    def url(self, path: str = "/metrics") -> str:
        if not path.startswith("/"):
            path = "/" + path
        return f"http://{self.host}:{self.port}{path}"

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
