"""Stdlib HTTP front-end of the port's serving path.

Endpoints:

* ``POST /v1/kernels/<name>/infer`` -- body ``{"inputs": [[...], ...]}``
  (or ``"input": [...]`` for one row), optional ``"timeout_ms"``.  Replies
  ``{"kernel", "generation", "outputs": [[...], ...], "argmax": [...]}``;
  outputs are float64 rendered by json's shortest round-trip repr, so the
  bytes decode to EXACTLY the floats the run_kernel batch path computes.
* ``GET /healthz`` -- ``200 ok`` once every background warmup finished
  (``503 warming`` before, ``503 draining`` during shutdown), with the
  registered kernels and the queued rows per kernel.
* ``GET /metrics`` -- Prometheus text; ``?format=json`` for the JSON
  snapshot, which includes each hand-written kernel's launch count.

Status mapping: 200 result; 400 malformed body, wrong input width or too
many rows; 404 unknown kernel or path; 429 queue full (with
Retry-After); 503 draining; 504 deadline exceeded; 500 anything else.

``ThreadingHTTPServer`` gives one thread per connection; they all block in
``MicroBatcher.submit``, and each kernel's worker thread is the only one
launching its forward.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import numpy as np

from ..utils.nn_log import nn_out, nn_warn
from .batcher import DeadlineExceeded, MicroBatcher, QueueFull, ServeClosed
from .metrics import ServeMetrics
from .registry import ModelRegistry


class _HTTPError(Exception):
    def __init__(self, status: int, reason: str, message: str,
                 retry_after: float | None = None):
        super().__init__(message)
        self.status = status
        self.reason = reason
        self.retry_after = retry_after


class ServeApp:
    """Registry + one micro-batcher per kernel + the request handlers."""

    def __init__(self, max_batch: int = 64, max_queue_rows: int = 256,
                 linger_s: float = 0.0, default_timeout_s: float = 30.0,
                 parity: str = "strict", fast_threshold: int = 256,
                 device="cuda"):
        self.metrics = ServeMetrics()
        self.registry = ModelRegistry(max_batch=max_batch, parity=parity,
                                      fast_threshold=fast_threshold,
                                      device=device, metrics=self.metrics)
        self.max_queue_rows = int(max_queue_rows)
        self.linger_s = float(linger_s)
        self.default_timeout_s = float(default_timeout_s)
        self.batchers: dict[str, MicroBatcher] = {}
        self._warmups: list[threading.Thread] = []
        self._closing = False
        self.t_start = time.monotonic()

    def add_model(self, conf_path: str, warmup: bool = True,
                  background: bool = False):
        model = self.registry.register_conf(conf_path)
        if model is None:
            return None
        b = MicroBatcher(model, self.metrics,
                         max_queue_rows=self.max_queue_rows,
                         linger_s=self.linger_s)
        self.batchers[model.name] = b
        self.metrics.register_queue(model.name, b.depth)
        if warmup and background:
            th = threading.Thread(target=self._warm, args=(model,),
                                  name=f"hpnn-warmup-{model.name}",
                                  daemon=True)
            self._warmups.append(th)
            th.start()
        elif warmup:
            self._warm(model)
        nn_out(f"serve: registered kernel '{model.name}' "
               f"({'-'.join(map(str, model.topology))}, "
               f"{model.dtype_name}, {model.kind})\n")
        return model

    def _warm(self, model) -> None:
        try:
            self.registry.warmup(model)
        except Exception as exc:  # a failed warmup must not kill serving
            nn_warn(f"serve: warmup of '{model.name}' failed: {exc}\n")

    def warming(self) -> bool:
        return any(th.is_alive() for th in self._warmups)

    # --- handlers -------------------------------------------------------
    def healthz(self) -> tuple[int, dict]:
        status = ("draining" if self._closing
                  else "warming" if self.warming() else "ok")
        body = {"status": status, "kernels": self.registry.names(),
                "device": str(self.registry.device),
                "uptime_s": time.monotonic() - self.t_start,
                "queue_depth": {k: b.depth()
                                for k, b in sorted(self.batchers.items())}}
        return (200 if status == "ok" else 503), body

    def handle_infer(self, name: str, body: bytes) -> dict:
        if self._closing:
            raise _HTTPError(503, "draining", "server draining")
        b = self.batchers.get(name)
        if b is None:
            raise _HTTPError(404, "not_found", f"unknown kernel '{name}'")
        try:
            req = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise _HTTPError(400, "bad_request", f"bad JSON: {exc}")
        if not isinstance(req, dict):
            raise _HTTPError(400, "bad_request", "body must be an object")
        raw = req.get("inputs")
        if raw is None:
            one = req.get("input")
            raw = None if one is None else [one]
        try:
            xs = np.asarray(raw, dtype=np.float64)
        except (TypeError, ValueError) as exc:
            raise _HTTPError(400, "bad_request", f"bad inputs: {exc}")
        model = b.model
        if xs.ndim != 2 or xs.shape[1] != model.n_inputs:
            raise _HTTPError(400, "bad_request",
                             f"inputs must be (rows, {model.n_inputs}); "
                             f"got {list(xs.shape)}")
        if not 1 <= xs.shape[0] <= b.max_batch:
            raise _HTTPError(400, "bad_request",
                             f"rows must be in [1, {b.max_batch}]; "
                             f"got {xs.shape[0]}")
        timeout_s = self.default_timeout_s
        if "timeout_ms" in req:
            try:
                timeout_s = float(req["timeout_ms"]) / 1e3
            except (TypeError, ValueError):
                raise _HTTPError(400, "bad_request", "bad timeout_ms")
        try:
            outs = b.submit(xs, timeout_s)
        except QueueFull as exc:
            raise _HTTPError(429, "queue_full", str(exc), retry_after=1.0)
        except DeadlineExceeded as exc:
            raise _HTTPError(504, "deadline", str(exc))
        except ServeClosed as exc:
            raise _HTTPError(503, "draining", str(exc))
        except Exception as exc:
            raise _HTTPError(500, "error", f"{type(exc).__name__}: {exc}")
        return {"kernel": name,
                "generation": int(model.generation),
                "outputs": outs.tolist(),
                "argmax": [int(i) for i in np.argmax(outs, axis=1)]}

    def close(self, drain: bool = True) -> None:
        self._closing = True
        for b in self.batchers.values():
            b.close(drain=drain)
        for th in self._warmups:
            th.join(timeout=30.0)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "hpnn_tpu_torch-serve"

    def log_message(self, fmt, *args):  # the console grammar stays clean
        return

    def _send(self, status: int, payload, headers=None,
              content_type: str = "application/json") -> None:
        data = (payload if isinstance(payload, str)
                else json.dumps(payload)).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        app: ServeApp = self.server.app
        url = urlsplit(self.path)
        if url.path == "/healthz":
            status, body = app.healthz()
            self._send(status, body)
        elif url.path == "/metrics":
            fmt = parse_qs(url.query).get("format", [""])[0]
            if fmt == "json":
                self._send(200, app.metrics.render_json())
            else:
                self._send(200, app.metrics.render_prometheus(),
                           content_type="text/plain; version=0.0.4")
        else:
            self._send(404, {"error": "not_found", "message": url.path})

    def do_POST(self):
        app: ServeApp = self.server.app
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n) if n > 0 else b""
        parts = urlsplit(self.path).path.strip("/").split("/")
        if len(parts) != 4 or parts[:2] != ["v1", "kernels"] \
                or parts[3] != "infer":
            self._send(404, {"error": "not_found", "message": self.path})
            return
        try:
            out = app.handle_infer(parts[2], body)
        except _HTTPError as exc:
            app.metrics.count_request(exc.reason)
            headers = ({"Retry-After": str(max(1, round(exc.retry_after)))}
                       if exc.retry_after is not None else None)
            self._send(exc.status, {"error": exc.reason,
                                    "message": str(exc)}, headers)
            return
        app.metrics.count_request("ok")
        self._send(200, out)


def make_server(addr: str, port: int, app: ServeApp) -> ThreadingHTTPServer:
    httpd = ThreadingHTTPServer((addr, port), _Handler)
    httpd.daemon_threads = True
    httpd.app = app
    return httpd


def serve_in_thread(app: ServeApp, addr: str = "127.0.0.1", port: int = 0):
    """Bind and serve on a background thread: ``(httpd, thread)``.  Stop
    with ``httpd.shutdown(); httpd.server_close(); app.close()``."""
    httpd = make_server(addr, port, app)
    th = threading.Thread(target=httpd.serve_forever,
                          name="hpnn-serve-http", daemon=True)
    th.start()
    return httpd, th
