"""Shared stdlib HTTP plumbing for the embedded servers.

The port's own copy of the JAX package's ``obs/httpd.py``.  In the
JAX package two subsystems embed a ThreadingHTTPServer on a daemon
thread: the ops surface (obs/server.py — /healthz /readyz /metrics
/progress /report) and the query/serving layer (serve/api.py — /v1/*);
this package ports the first.  The byte-level send helpers and the
start/close/port lifecycle live here (HTTP/1.1 keep-alive framing, JSON
error envelopes, daemon-thread shutdown).

- :class:`JsonHandler` — BaseHTTPRequestHandler with ``_send`` /
  ``_send_json``, access-log routing to the obs logger at DEBUG, and a
  ``do_GET`` that parses the URL once and dispatches to the subclass's
  ``_route(path, query)`` under the standard error envelope (a broken
  endpoint reports a 500 JSON body; it must never kill the server
  thread — the surface exists to diagnose trouble).  (The JAX package's
  server-sent-event helpers serve its ``/v1`` feed, which is not
  ported.)
- :class:`Httpd` — ThreadingHTTPServer with daemon worker threads, a
  ``port`` property (useful with port 0 ephemeral binds in tests and
  smokes), and ``start()``/``close()`` managing the serve_forever thread.
"""

from __future__ import annotations

import http.server
import json
import threading
from urllib.parse import parse_qs, urlsplit

from firebird_tpu_torch.obs import tracing


class JsonHandler(http.server.BaseHTTPRequestHandler):
    """Request handler base: subclasses implement ``_route(path, query)``
    where ``query`` is the parse_qs dict (values are lists)."""

    server_version = "firebird/1"
    protocol_version = "HTTP/1.1"
    # Subsystem logger category for access lines (DEBUG, not stderr spam).
    log_category = "change-detection"

    def log_message(self, fmt, *args):
        from firebird_tpu_torch.obs import logger
        logger(self.log_category).debug("http %s", fmt % args)

    def _send(self, code: int, body: bytes, ctype: str,
              headers: dict | None = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        headers = headers or {}
        for k, v in headers.items():
            self.send_header(k, str(v))
        # Trace propagation: a response produced under a TraceContext
        # (serve mints one per request) echoes its id, so a client can
        # join its slow call to server-side spans/exemplars/logs.
        ctx = tracing.current_context()
        if ctx is not None and "X-Firebird-Trace" not in headers:
            self.send_header("X-Firebird-Trace", ctx.batch_id)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj,
                   headers: dict | None = None) -> None:
        self._send(code, json.dumps(obj, default=str).encode(),
                   "application/json", headers)

    def do_GET(self):  # noqa: N802 (stdlib handler naming)
        self._dispatch_safely(self._route)

    def do_POST(self):  # noqa: N802 (stdlib handler naming)
        # Drain any request body first: leaving it unread desyncs the
        # HTTP/1.1 keep-alive stream for the client's next request.
        # Bodies past a sane bound aren't drained (nothing here takes a
        # payload) — the connection is closed after the response instead,
        # so a capped drain can never leave stray bytes to be parsed as
        # the next request line.
        try:
            n = int(self.headers.get("Content-Length") or 0)
            if n > (1 << 20):
                self.close_connection = True
            else:
                while n > 0:
                    chunk = self.rfile.read(min(n, 1 << 16))
                    if not chunk:
                        break
                    n -= len(chunk)
        except (ValueError, OSError):
            pass
        self._dispatch_safely(self._route_post)

    def _dispatch_safely(self, route) -> None:
        parts = urlsplit(self.path)
        try:
            route(parts.path, parse_qs(parts.query))
        except BrokenPipeError:
            pass                       # client went away mid-response
        except Exception as e:         # a broken endpoint must report, not
            # kill the serving thread
            try:
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            except Exception:
                pass

    def _route(self, path: str, query: dict) -> None:
        raise NotImplementedError

    def _route_post(self, path: str, query: dict) -> None:
        """Default POST surface: nothing accepts writes unless a
        subclass says so (the ops server's /profile does)."""
        self._send_json(405, {"error": f"POST not supported on {path!r}"})


class Httpd(http.server.ThreadingHTTPServer):
    """Threading HTTP server on a daemon thread; ``port`` is the bound
    port (useful when constructed with port 0 for an ephemeral bind)."""

    daemon_threads = True
    allow_reuse_address = True
    # socketserver's default listen backlog is 5: a replica fleet's
    # load generator opening ~100 keep-alive connections in one burst
    # overflows it and the excess see connection resets — a transport
    # error the client books against the SERVER.  128 absorbs any sane
    # connection storm; steady state is unaffected (keep-alive reuses).
    request_queue_size = 128
    thread_name = "firebird-httpd"

    def __init__(self, addr, handler_cls):
        super().__init__(addr, handler_cls)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self.server_address[1]

    def start(self) -> "Httpd":
        self._thread = threading.Thread(
            target=self.serve_forever, kwargs={"poll_interval": 0.25},
            name=self.thread_name, daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self.shutdown()
        self.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
