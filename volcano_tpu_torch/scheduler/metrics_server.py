"""Prometheus scrape endpoint for the scheduler metrics.

The port's copy of ``volcano_tpu/scheduler/metrics_server.py``.  The
reference serves /metrics on :8080 from the scheduler binary
(KB/cmd/kube-batch/app/server.go:86-89); here a daemon-threaded stdlib
HTTP server exposes the same series (``scheduler/metrics.py`` keeps the
reference's collector names) and the debug views of the port's own
modules:

* ``/metrics``: ``metrics.expose_text()``;
* ``/debug/trace``: the flight recorder (``trace.debug_payload``);
* ``/debug/timeseries``: the cycle ring (``timeseries.debug_payload``);
* ``/debug/prof``: the critical-path profile (``vtprof.debug_payload``);
* ``/debug/digest``: the scheduler mirror's state digest, its pending
  events, its checks and divergences (``vtaudit.debug_payload``);
* ``/healthz``: ``ok``.

The fleet's merged ``/metrics`` waits for ROADMAP item 13.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from volcano_tpu_torch import timeseries, trace, vtaudit, vtprof
from volcano_tpu_torch.scheduler import metrics

_JSON_VIEWS = {
    "/debug/timeseries": timeseries.debug_payload,
    "/debug/prof": vtprof.debug_payload,
    "/debug/digest": vtaudit.debug_payload,
}


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 (stdlib API)
        if self.path.startswith("/metrics"):
            body = metrics.expose_text().encode()
            ctype, code = "text/plain; version=0.0.4", 200
        elif self.path.startswith("/debug/trace"):
            body = json.dumps(trace.debug_payload()).encode()
            ctype, code = "application/json", 200
        elif self.path in _JSON_VIEWS:
            body = json.dumps(_JSON_VIEWS[self.path]()).encode()
            ctype, code = "application/json", 200
        elif self.path == "/healthz":
            body, ctype, code = b"ok\n", "text/plain", 200
        else:
            body, ctype, code = b"not found\n", "text/plain", 404
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # no per-request stderr lines
        pass


class MetricsServer:
    """Serve the views above on 127.0.0.1; port 0 picks a free one."""

    def __init__(self, port: int = 8080, host: str = "127.0.0.1"):
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="vt-metrics", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            self._server.server_close()  # never started: just free the socket
            return
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
        self._thread = None
