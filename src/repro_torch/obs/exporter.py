"""Tiny stdlib HTTP exporter for a process's MetricsRegistry
(``repro/obs/exporter.py``).

One ``MetricsExporter`` per party daemon and per dealer daemon, started
on an ephemeral 127.0.0.1 port when metrics are requested
(``PartyCluster(metrics=True)`` / ``TRIDENT_METRICS=1``); the port is
published back to the parent over the existing channels (the cluster's
ready ack, the dealer's status queue), so the parent's health scraper
(``health.py``) never needs new plumbing.

Endpoints:

  * ``/metrics``       -- Prometheus text exposition (point a real
    Prometheus at the five ports for a long-lived deployment);
  * ``/metrics.json``  -- the registry snapshot as JSON (what the health
    scraper and tests consume: typed samples with ``updated``
    wall-clock timestamps for age-gated probes);
  * ``/healthz``       -- liveness ping (label + pid + uptime).

The server is a daemonized ``ThreadingHTTPServer``: scrapes never block
the protocol threads (the registry lock is held only per-update /
per-snapshot), and the thread dies with the process.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .registry import MetricsRegistry, get_registry


class MetricsExporter:
    """Serve a registry over HTTP; ``.port`` is the bound ephemeral port."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.registry = registry if registry is not None else get_registry()
        handler = _make_handler(self.registry)
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"metrics-exporter-{self.port}")
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _make_handler(registry: MetricsRegistry):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/metrics":
                body = registry.render_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif self.path == "/metrics.json":
                body = json.dumps(registry.snapshot()).encode()
                ctype = "application/json"
            elif self.path == "/healthz":
                import os
                import time
                body = json.dumps({
                    "ok": True, "label": registry.label,
                    "rank": registry.rank, "pid": os.getpid(),
                    "uptime_s": time.time() - registry.created,
                }).encode()
                ctype = "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):   # scrapes stay off stderr
            pass

    return Handler
