"""Shared stdlib JSON-HTTP server scaffolding for the serving facades
(the serving gateway today) — one place for handler/json/start/stop/
context-manager mechanics.

Port of `deeplearning4j_tpu/utils/http_server.py`; it imports neither JAX
nor anything of the JAX package, and ``GET /metrics`` exposes the port's
own registry (optimize/metrics.py).

Serving-grade hardening (docs/serving.md): requests are handled on a
BOUNDED thread pool (`pool_size` concurrent handlers — unbounded
thread-per-request falls over exactly when a gateway is overloaded,
which is when it matters), `stop()` is graceful (close the listening
socket so no new connection is accepted, then finish every in-flight
handler before returning), and any server can expose the process-global
metrics registry at ``GET /metrics`` with `expose_metrics=True` (the
Prometheus scrape surface).
"""
from __future__ import annotations

import json
import threading
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

# route tables: {path: handler(request_dict_or_None) -> (code, obj)}
Routes = Dict[str, Callable]


class _PooledHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer whose per-connection work runs on a bounded
    ThreadPoolExecutor instead of an unbounded thread-per-request."""

    def __init__(self, addr, handler_cls, pool_size: int):
        super().__init__(addr, handler_cls)
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, int(pool_size)),
            thread_name_prefix="JsonHttpServer")

    def process_request(self, request, client_address):
        try:
            self._pool.submit(self.process_request_thread, request,
                              client_address)
        except RuntimeError:  # pool already shut down: closing race
            self.shutdown_request(request)

    def close_pool(self):
        # wait=True: every in-flight handler finishes before stop()
        # returns — the graceful half of graceful shutdown.
        self._pool.shutdown(wait=True)


class JsonHttpServer:
    """Bind GET/POST route tables; handlers return (status, json_obj).
    Handler exceptions become 400s (client-visible, server stays up)."""

    def __init__(self, get_routes: Routes, post_routes: Routes,
                 port: int = 0, host: str = "127.0.0.1",
                 raw_get_routes: Optional[Routes] = None,
                 pool_size: int = 8, expose_metrics: bool = False):
        self._get = dict(get_routes)
        self._post = dict(post_routes)
        # raw routes return (status, content_type, body_bytes) — /trace
        # and /metrics; JSON routes stay JSON
        self._raw_get = dict(raw_get_routes or {})
        if expose_metrics and "/metrics" not in self._raw_get:
            self._raw_get["/metrics"] = _metrics_route
        self._port = int(port)
        self._host = host
        self._pool_size = int(pool_size)
        self._httpd: Optional[_PooledHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def start(self):
        get_routes, post_routes = self._get, self._post
        raw_get_routes = self._raw_get

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _dispatch(self, routes, payload, path=None):
                fn = routes.get(path if path is not None else self.path)
                if fn is None:
                    self._json(404, {"error": "unknown path"})
                    return
                try:
                    self._json(*fn(payload))
                except Exception as e:  # bad request must not kill server
                    self._json(400, {"error": str(e)})

            def do_GET(self):
                # GET handlers receive the parsed query string (or None
                # when there is none) — `/debug/requests?model=a&tier=b`
                # routes on the bare path like every other endpoint.
                path, _, query = self.path.partition("?")
                raw = raw_get_routes.get(path)
                if raw is not None:
                    try:
                        code, ctype, body = raw()
                    except Exception as e:
                        self._json(400, {"error": str(e)})
                        return
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                params = (dict(urllib.parse.parse_qsl(query))
                          if query else None)
                self._dispatch(get_routes, params, path=path)

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n))
                except Exception as e:
                    self._json(400, {"error": f"bad JSON: {e}"})
                    return
                self._dispatch(post_routes, payload)

        self._httpd = _PooledHTTPServer((self._host, self._port), Handler,
                                        self._pool_size)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Graceful: stop accepting (shutdown + close the listening
        socket), then wait for every in-flight handler to finish."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd.close_pool()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def _metrics_route():
    """GET /metrics — Prometheus text exposition of the process-global
    registry."""
    from ..optimize.metrics import registry
    body = registry().prometheus_text().encode()
    return 200, "text/plain; version=0.0.4; charset=utf-8", body


def json_request(url: str, payload=None, timeout: float = 5.0):
    """One-call JSON client for the in-repo servers: POST `payload` (GET
    when None), parse the JSON reply. Always passes a socket timeout — a
    caller must never block forever on a half-dead peer. Raises urllib's
    errors on non-2xx or timeout; the caller decides whether that is
    transient."""
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    headers = {"Content-Type": "application/json"} if data else {}
    req = urllib.request.Request(url, data=data, headers=headers)
    with urllib.request.urlopen(req, timeout=float(timeout)) as r:
        return json.loads(r.read().decode())
