"""Serving counters: requests by outcome, batches and their fill, the
bucket cache's hits and misses, request latency percentiles, the launch
count of every hand-written kernel, and whether the native sample loader
serves corpus reads (``native_io``).  Rendered as JSON
(``GET /metrics?format=json``) or Prometheus text (``GET /metrics``)."""

from __future__ import annotations

import json
import threading
from collections import deque

import numpy as np

_LATENCY_WINDOW = 4096  # most recent request latencies kept for p50/p99


class ServeMetrics:
    def __init__(self):
        self._lock = threading.Lock()
        self.requests: dict[str, int] = {}
        self.batches = 0
        self.batch_rows = 0
        self.bucket_rows = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self._latency = deque(maxlen=_LATENCY_WINDOW)
        self._queues: dict[str, object] = {}

    def count_request(self, outcome: str) -> None:
        with self._lock:
            self.requests[outcome] = self.requests.get(outcome, 0) + 1

    def count_batch(self, rows: int, bucket: int) -> None:
        with self._lock:
            self.batches += 1
            self.batch_rows += rows
            self.bucket_rows += bucket

    def count_cache(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self.cache_hits += 1
            else:
                self.cache_misses += 1

    def observe_latency(self, seconds: float) -> None:
        with self._lock:
            self._latency.append(seconds)

    def register_queue(self, name: str, depth_fn) -> None:
        """A live queue-depth gauge (queued rows) for one kernel."""
        with self._lock:
            self._queues[name] = depth_fn

    def snapshot(self) -> dict:
        from ..io.samples import native_io_status
        from ..ops.kernels import fused_linear_act

        with self._lock:
            lat = np.asarray(self._latency, dtype=np.float64)
            snap = {
                "requests": dict(self.requests),
                "batches": self.batches,
                "batch_rows": self.batch_rows,
                "batch_fill_ratio": (self.batch_rows / self.bucket_rows
                                     if self.bucket_rows else 0.0),
                "compile_cache": {"hits": self.cache_hits,
                                  "misses": self.cache_misses},
                "latency": {
                    "count": int(lat.size),
                    "p50_ms": (float(np.percentile(lat, 50)) * 1e3
                               if lat.size else 0.0),
                    "p99_ms": (float(np.percentile(lat, 99)) * 1e3
                               if lat.size else 0.0),
                },
                "queue_depth": {k: int(fn()) for k, fn in
                                sorted(self._queues.items())},
            }
        snap["kernel_launches"] = {
            "fused_linear_act": fused_linear_act.launches}
        # "off" only under HPNN_NO_NATIVE_IO: a loader that fails to
        # build raises instead
        snap["native_io"] = native_io_status()
        return snap

    def render_json(self) -> str:
        return json.dumps(self.snapshot())

    def render_prometheus(self) -> str:
        s = self.snapshot()
        lines = ["# TYPE hpnn_serve_requests_total counter"]
        lines += [f'hpnn_serve_requests_total{{outcome="{k}"}} {v}'
                  for k, v in sorted(s["requests"].items())]
        lines += ["# TYPE hpnn_serve_batches_total counter",
                  f"hpnn_serve_batches_total {s['batches']}",
                  "# TYPE hpnn_serve_batch_fill_ratio gauge",
                  f"hpnn_serve_batch_fill_ratio {s['batch_fill_ratio']}",
                  "# TYPE hpnn_serve_compile_cache_total counter",
                  'hpnn_serve_compile_cache_total{result="hit"} '
                  f"{s['compile_cache']['hits']}",
                  'hpnn_serve_compile_cache_total{result="miss"} '
                  f"{s['compile_cache']['misses']}",
                  "# TYPE hpnn_serve_latency_ms gauge",
                  f'hpnn_serve_latency_ms{{quantile="0.5"}} '
                  f"{s['latency']['p50_ms']}",
                  f'hpnn_serve_latency_ms{{quantile="0.99"}} '
                  f"{s['latency']['p99_ms']}",
                  "# TYPE hpnn_serve_queue_depth gauge"]
        lines += [f'hpnn_serve_queue_depth{{kernel="{k}"}} {v}'
                  for k, v in s["queue_depth"].items()]
        lines += ["# TYPE hpnn_kernel_launches_total counter"]
        lines += [f'hpnn_kernel_launches_total{{kernel="{k}"}} {v}'
                  for k, v in s["kernel_launches"].items()]
        lines += ["# HELP hpnn_serve_native_io Native sample-loader in use "
                  "(1=on, 0=Python parser).",
                  "# TYPE hpnn_serve_native_io gauge",
                  f"hpnn_serve_native_io "
                  f"{1 if s['native_io'] == 'on' else 0}"]
        return "\n".join(lines) + "\n"
