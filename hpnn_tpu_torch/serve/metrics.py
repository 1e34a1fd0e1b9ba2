"""Serving metrics: latency histograms, counters and gauges (the port's
copy of ``hpnn_tpu/serve/metrics.py`` for the families single-host
serving has).

A small thread-safe registry that renders both the Prometheus text
exposition format (``GET /metrics``) and a JSON snapshot
(``GET /metrics?format=json``).  The latency histogram uses log-spaced
buckets, so p50/p99 come out of one pass over 62 counters with a
bounded relative error (about 26% a bucket step, reported as the upper
edge).

Families: requests by outcome; device batches, batched rows and the
mean batch fill; the bucket cache's hits and misses; the request, queue
and device histograms; the request-path phases (:data:`PHASES`, plus
``queue_wait`` aliased to the queue histogram); latency by (kernel,
bucket) with the ``slow_request`` event; per-bucket device accounting;
model info and generation gauges, reload counters and per-generation
request counters (capped at :data:`ServeMetrics.GEN_LABELS_KEPT` labels);
per-lane queue depth.  The port adds the launch count of every
hand-written kernel (``kernel_launches``).  Queue and lane depths are
live gauges read through callbacks at render time, so they cannot go
stale.
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Callable

from ..utils.env import env_float

# log-spaced latency bounds: 100 us .. ~107 s, factor 1.26 (log10 step
# 0.1) -- 61 buckets, enough to tell a 2 ms batch from a 50 ms queue
# stall
_BUCKET_FACTOR = 10.0 ** 0.1
_BUCKET_MIN_S = 1e-4
_N_BUCKETS = 61

_REQUEST_OUTCOMES = ("ok", "queue_full", "quota_exceeded", "deadline",
                     "bad_request", "not_found", "error", "shed")

# request-path phases: parse/respond are per request, the batch-level
# segments are observed once per device batch.  queue_wait is NOT a
# histogram here: ``queue_latency`` measures exactly that interval and
# is aliased into the phases snapshot.  On a CUDA device pad_h2d, device
# and d2h read timing events recorded around the copy in, the forward
# and the copy out (the registry's ``collect``); on the CPU they are
# host walls.
PHASES = ("parse", "batch_assembly", "pad_h2d", "device", "d2h",
          "respond")


def _escape_label(value) -> str:
    """Prometheus label-value escaping (backslash, double quote,
    newline)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class LatencyHistogram:
    """Log-bucketed latency histogram with percentile estimation.

    An ``observe`` carrying a trace id competes to be the histogram's
    exemplar, the slowest recent traced observation: it takes the slot
    when it is at least as slow as the incumbent or the incumbent is
    older than :data:`EXEMPLAR_MAX_AGE_S`.  No port path passes trace ids
    yet, so the slot stays empty until tracing is ported."""

    EXEMPLAR_MAX_AGE_S = 60.0

    def __init__(self):
        self._counts = [0] * (_N_BUCKETS + 1)  # +1 overflow bucket
        self._sum = 0.0
        self._n = 0
        self._exemplar: tuple[float, str, float] | None = None
        self._lock = threading.Lock()

    @staticmethod
    def _bucket(seconds: float) -> int:
        if seconds <= _BUCKET_MIN_S:
            return 0
        i = int(math.log(seconds / _BUCKET_MIN_S)
                / math.log(_BUCKET_FACTOR)) + 1
        return min(i, _N_BUCKETS)

    @staticmethod
    def _upper_bound(i: int) -> float:
        """Upper edge of bucket i (seconds)."""
        return _BUCKET_MIN_S * _BUCKET_FACTOR ** i

    def observe(self, seconds: float, trace_id: str | None = None) -> None:
        with self._lock:
            self._counts[self._bucket(seconds)] += 1
            self._sum += seconds
            self._n += 1
            if trace_id:
                ex = self._exemplar
                now = time.monotonic()
                if (ex is None or seconds >= ex[0]
                        or now - ex[2] > self.EXEMPLAR_MAX_AGE_S):
                    self._exemplar = (seconds, trace_id, now)

    def exemplar(self) -> dict | None:
        """The slowest recent traced observation, or None."""
        with self._lock:
            ex = self._exemplar
        if ex is None:
            return None
        return {"seconds": round(ex[0], 6), "trace_id": ex[1],
                "age_s": round(max(0.0, time.monotonic() - ex[2]), 3)}

    @property
    def count(self) -> int:
        return self._n

    @property
    def total(self) -> float:
        return self._sum

    def percentile(self, p: float) -> float:
        """Estimated p-th percentile in seconds (the upper bucket edge:
        conservative).  0.0 when empty."""
        with self._lock:
            if self._n == 0:
                return 0.0
            rank = p / 100.0 * self._n
            seen = 0
            for i, c in enumerate(self._counts):
                seen += c
                if seen >= rank:
                    return self._upper_bound(i)
            return self._upper_bound(_N_BUCKETS)

    def snapshot(self) -> dict:
        with self._lock:
            n, s = self._n, self._sum
            # sparse bucket counts ride the snapshot, so a reader can
            # merge distributions and compute honest union quantiles
            counts = {str(i): c for i, c in enumerate(self._counts) if c}
        out = {
            "count": n,
            "sum_seconds": round(s, 6),
            "mean_ms": round(s / n * 1e3, 3) if n else 0.0,
            "p50_ms": round(self.percentile(50) * 1e3, 3),
            "p99_ms": round(self.percentile(99) * 1e3, 3),
            "counts": counts,
        }
        ex = self.exemplar()
        if ex is not None:
            out["exemplar"] = ex
        return out

    @staticmethod
    def percentile_from_counts(counts: dict, n: int, p: float) -> float:
        """Percentile (seconds) from a sparse ``{bucket_index: count}``
        map, the same upper-edge estimate :meth:`percentile` uses."""
        if n <= 0:
            return 0.0
        by_idx = {int(k): int(v) for k, v in counts.items()}
        covered = sum(by_idx.values())
        if covered <= 0:
            # observations without bucket detail read as unknown (0),
            # not as the overflow bucket's edge
            return 0.0
        # rank against the observations that have buckets, so a partial
        # detail set still ends inside the buckets
        rank = p / 100.0 * min(n, covered)
        seen = 0
        for i in sorted(by_idx):
            seen += by_idx[i]
            if seen >= rank:
                return LatencyHistogram._upper_bound(i)
        return LatencyHistogram._upper_bound(_N_BUCKETS)

    @classmethod
    def merge_snapshots(cls, snaps) -> dict:
        """Merge histogram snapshots: counts and sums add, quantiles are
        recomputed from the merged buckets (a real quantile of the union,
        not an average of quantiles)."""
        counts: dict[str, int] = {}
        n, total = 0, 0.0
        for sn in snaps:
            if not sn:
                continue
            n += int(sn.get("count", 0))
            total += float(sn.get("sum_seconds", 0.0))
            for k, c in (sn.get("counts") or {}).items():
                counts[str(k)] = counts.get(str(k), 0) + int(c)
        return {
            "count": n,
            "sum_seconds": round(total, 6),
            "mean_ms": round(total / n * 1e3, 3) if n else 0.0,
            "p50_ms": round(
                cls.percentile_from_counts(counts, n, 50) * 1e3, 3),
            "p99_ms": round(
                cls.percentile_from_counts(counts, n, 99) * 1e3, 3),
            "counts": counts,
        }


class ServeMetrics:
    """One metrics registry per server instance (tests need isolation,
    so it is not a module-level singleton)."""

    # newest generations kept as distinct labels per kernel; a watched
    # training run mints one generation a snapshot, so an uncapped map
    # would leak label cardinality on a long-lived server
    GEN_LABELS_KEPT = 16
    # below this many observations a bucket has no meaningful p99, and
    # the slow-request flag cannot fire
    SLOW_SPAN_MIN_COUNT = 50

    def __init__(self):
        self._lock = threading.Lock()
        self.latency = LatencyHistogram()        # whole-request wall
        self.queue_latency = LatencyHistogram()  # enqueue -> dispatch
        self.device_time = LatencyHistogram()    # a batch's device span
        self.phases: dict[str, LatencyHistogram] = {
            p: LatencyHistogram() for p in PHASES}
        # per-(kernel, bucket) whole-request latency: the slow-request
        # flag compares a request against its own kernel and bucket
        self._bucket_latency: dict[tuple[str, int],
                                   LatencyHistogram] = {}
        self.requests = {k: 0 for k in _REQUEST_OUTCOMES}
        self.rows_total = 0
        self.batches_total = 0
        self._fill_sum = 0.0  # sum of rows/bucket over completed batches
        # bucket -> [batches, rows, device_seconds]
        self._buckets: dict[int, list] = {}
        self.cache_hits = 0
        self.cache_misses = 0
        self._depth_fns: dict[str, Callable[[], int]] = {}
        self._lane_fns: dict[str, Callable[[], dict]] = {}
        # model lifecycle: generation (1 at registration, bumped by every
        # hot reload), last (re)load time and labels, reload outcomes,
        # and requests per (kernel, generation)
        self._model_info: dict[str, dict] = {}
        self.reloads = {"ok": 0, "error": 0}
        self._gen_requests: dict[str, dict[str, int]] = {}
        # the job scheduler's gauges, read through a callback at render
        # time (like queue depth) so they can never go stale
        self._jobs_fn: Callable[[], dict] | None = None

    # --- write side -----------------------------------------------------
    def count_request(self, outcome: str) -> None:
        with self._lock:
            self.requests[outcome] = self.requests.get(outcome, 0) + 1

    def count_batch(self, rows: int, bucket: int) -> None:
        with self._lock:
            self.batches_total += 1
            self.rows_total += rows
            self._fill_sum += rows / float(bucket)

    def count_device(self, rows: int, bucket: int, seconds: float) -> None:
        """One completed device batch.  ``seconds`` is the batch's device
        span: on a CUDA device the timing events from the start of the
        copy in to the end of the copy out; on the CPU the host wall from
        dispatch to the host rows (an upper bound)."""
        self.device_time.observe(seconds)
        with self._lock:
            acc = self._buckets.setdefault(bucket, [0, 0, 0.0])
            acc[0] += 1
            acc[1] += rows
            acc[2] += seconds

    def observe_phase(self, phase: str, seconds: float,
                      trace_id: str | None = None) -> None:
        """One request-path phase duration (see PHASES; unknown names are
        dropped rather than minting unbounded series)."""
        h = self.phases.get(phase)
        if h is not None:
            h.observe(seconds, trace_id=trace_id)

    def bucket_latency(self, kernel: str, bucket: int) -> LatencyHistogram:
        """The whole-request latency histogram of one (kernel, bucket)."""
        key = (kernel, bucket)
        with self._lock:
            h = self._bucket_latency.get(key)
            if h is None:
                h = self._bucket_latency[key] = LatencyHistogram()
            return h

    def slow_threshold_s(self, hist: LatencyHistogram) -> float | None:
        """``HPNN_SLOW_SPAN_MULT`` (default 4) x the histogram's p99, or
        None while the flag cannot fire (too few observations, or the
        knob at 0)."""
        mult = env_float("HPNN_SLOW_SPAN_MULT", 4.0)
        if mult <= 0.0:
            return None
        if hist.count < self.SLOW_SPAN_MIN_COUNT:
            return None
        return mult * hist.percentile(99)

    def count_cache(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self.cache_hits += 1
            else:
                self.cache_misses += 1

    def register_queue(self, name: str, depth_fn: Callable[[], int]) -> None:
        """A live queue-depth gauge (queued rows) for one kernel."""
        with self._lock:
            self._depth_fns[name] = depth_fn

    def register_lanes(self, name: str, fn: Callable[[], dict]) -> None:
        """A live per-lane queued-rows gauge for one kernel (the
        batcher's ``lane_depths``)."""
        with self._lock:
            self._lane_fns[name] = fn

    def set_model_info(self, name: str, generation: int,
                       loaded_at: float, kind: str | None = None,
                       trainer: str | None = None,
                       route: str | None = None) -> None:
        """A kernel's generation and last (re)load time, and, when given,
        its head ``kind``, ``trainer`` and serving ``route`` labels (kept
        by callers that refresh only the generation)."""
        with self._lock:
            info = self._model_info.get(name, {})
            info["generation"] = int(generation)
            info["last_reload_ts"] = round(float(loaded_at), 3)
            if kind is not None:
                info["kind"] = str(kind)
            if trainer is not None:
                info["trainer"] = str(trainer)
            if route is not None:
                info["route"] = str(route)
            self._model_info[name] = info

    def set_jobs_source(self, fn: Callable[[], dict] | None) -> None:
        """Attach the job scheduler's live metrics callback (queue depth,
        running jobs, trained epochs, slices)."""
        with self._lock:
            self._jobs_fn = fn

    def count_reload(self, ok: bool) -> None:
        with self._lock:
            self.reloads["ok" if ok else "error"] += 1

    def count_generation(self, kernel: str, generation: int) -> None:
        """One request served by ``generation`` of ``kernel``.  Counts
        older than the newest :data:`GEN_LABELS_KEPT` generations fold
        into one ``"older"`` label (totals are kept)."""
        with self._lock:
            d = self._gen_requests.setdefault(kernel, {})
            g = str(int(generation))
            d[g] = d.get(g, 0) + 1
            numeric = [k for k in d if k != "older"]
            if len(numeric) > self.GEN_LABELS_KEPT:
                for k in sorted(numeric, key=int)[:-self.GEN_LABELS_KEPT]:
                    d["older"] = d.get("older", 0) + d.pop(k)

    def generation_requests(self, kernel: str) -> dict:
        """One kernel's per-generation request counters."""
        with self._lock:
            return dict(self._gen_requests.get(kernel, {}))

    # --- read side ------------------------------------------------------
    def batch_fill_ratio(self) -> float:
        """The mean over completed batches of rows / bucket."""
        with self._lock:
            return (self._fill_sum / self.batches_total
                    if self.batches_total else 0.0)

    def bucket_stats(self) -> dict:
        """Per-bucket device accounting with derived rows/s (keys are
        the bucket sizes as strings)."""
        with self._lock:
            items = {b: list(acc) for b, acc in self._buckets.items()}
        return {
            str(b): {
                "batches": n, "rows": rows,
                "device_s": round(secs, 6),
                "rows_per_s": round(rows / secs, 2) if secs > 0 else 0.0,
            }
            for b, (n, rows, secs) in sorted(items.items())
        }

    def snapshot(self) -> dict:
        from ..io.samples import native_io_status
        from ..ops.kernels import fused_linear_act

        # the gauges' callbacks take the batchers' locks: call them
        # outside our own
        depths = {name: fn() for name, fn in list(self._depth_fns.items())}
        lanes = {name: fn() for name, fn in list(self._lane_fns.items())}
        jobs_fn = self._jobs_fn   # it takes the scheduler's locks too
        jobs = jobs_fn() if jobs_fn is not None else None
        with self._lock:
            out = {
                "requests": dict(self.requests),
                "rows_total": self.rows_total,
                "batches_total": self.batches_total,
                "compile_cache": {"hits": self.cache_hits,
                                  "misses": self.cache_misses},
                "models": {n: dict(v)
                           for n, v in self._model_info.items()},
                "reloads": dict(self.reloads),
                "generations": {k: dict(v)
                                for k, v in self._gen_requests.items()},
                "jobs": jobs,
                # "off" only under HPNN_NO_NATIVE_IO: a loader that
                # fails to build raises instead
                "native_io": native_io_status(),
            }
        out["batch_fill_ratio"] = round(self.batch_fill_ratio(), 4)
        out["queue_depth"] = depths
        out["lanes"] = lanes
        out["latency"] = self.latency.snapshot()
        out["queue_latency"] = self.queue_latency.snapshot()
        out["device_time"] = self.device_time.snapshot()
        out["buckets"] = self.bucket_stats()
        out["phases"] = {p: h.snapshot() for p, h in self.phases.items()
                         if h.count}
        if self.queue_latency.count:
            # queue_wait IS queue_latency: aliased, never observed twice
            out["phases"]["queue_wait"] = out["queue_latency"]
        with self._lock:
            blat = dict(self._bucket_latency)
        by_kernel: dict = {}
        for (kernel, b), h in sorted(blat.items()):
            by_kernel.setdefault(kernel, {})[str(b)] = h.snapshot()
        out["latency_by_bucket"] = by_kernel
        out["kernel_launches"] = {
            "fused_linear_act": fused_linear_act.launches}
        return out

    def render_json(self) -> str:
        return json.dumps(self.snapshot()) + "\n"

    def render_prometheus(self) -> str:
        """Prometheus text exposition (type comments and samples)."""
        snap = self.snapshot()
        lines = [
            "# HELP hpnn_serve_requests_total Requests by outcome.",
            "# TYPE hpnn_serve_requests_total counter",
        ]
        for outcome, n in sorted(snap["requests"].items()):
            lines.append(
                f'hpnn_serve_requests_total'
                f'{{outcome="{_escape_label(outcome)}"}} {n}')
        lines += [
            "# HELP hpnn_serve_rows_total Input rows batched to device.",
            "# TYPE hpnn_serve_rows_total counter",
            f"hpnn_serve_rows_total {snap['rows_total']}",
            "# HELP hpnn_serve_batches_total Device launches dispatched.",
            "# TYPE hpnn_serve_batches_total counter",
            f"hpnn_serve_batches_total {snap['batches_total']}",
            "# HELP hpnn_serve_batch_fill_ratio Mean rows/bucket per batch.",
            "# TYPE hpnn_serve_batch_fill_ratio gauge",
            f"hpnn_serve_batch_fill_ratio {snap['batch_fill_ratio']}",
            "# HELP hpnn_serve_compile_cache_total Forward-callable cache.",
            "# TYPE hpnn_serve_compile_cache_total counter",
            'hpnn_serve_compile_cache_total{result="hit"} '
            f"{snap['compile_cache']['hits']}",
            'hpnn_serve_compile_cache_total{result="miss"} '
            f"{snap['compile_cache']['misses']}",
            "# HELP hpnn_serve_native_io Native sample-loader in use "
            "(1=on, 0=Python parser).",
            "# TYPE hpnn_serve_native_io gauge",
            f"hpnn_serve_native_io "
            f"{1 if snap['native_io'] == 'on' else 0}",
            "# HELP hpnn_serve_reloads_total Hot model reloads by result.",
            "# TYPE hpnn_serve_reloads_total counter",
            'hpnn_serve_reloads_total{result="ok"} '
            f"{snap['reloads']['ok']}",
            'hpnn_serve_reloads_total{result="error"} '
            f"{snap['reloads']['error']}",
            "# HELP hpnn_serve_model_generation Model weights generation "
            "(1 at registration; +1 per hot reload).",
            "# TYPE hpnn_serve_model_generation gauge",
        ]
        for name, info in sorted(snap["models"].items()):
            lines.append(
                f'hpnn_serve_model_generation'
                f'{{kernel="{_escape_label(name)}"}} '
                f"{info['generation']}")
        lines += [
            "# HELP hpnn_serve_model_last_reload_timestamp_seconds "
            "Unix time of the kernel's last weights (re)load.",
            "# TYPE hpnn_serve_model_last_reload_timestamp_seconds gauge",
        ]
        for name, info in sorted(snap["models"].items()):
            lines.append(
                "hpnn_serve_model_last_reload_timestamp_seconds"
                f'{{kernel="{_escape_label(name)}"}} '
                f'{info["last_reload_ts"]}')
        lines += [
            "# HELP hpnn_serve_model_info Kernel output-head type, "
            "trainer and serving route (value is always 1; labels "
            "carry the facts).",
            "# TYPE hpnn_serve_model_info gauge",
        ]
        for name, info in sorted(snap["models"].items()):
            lines.append(
                "hpnn_serve_model_info"
                f'{{kernel="{_escape_label(name)}",'
                f'type="{_escape_label(info.get("kind", "unknown"))}",'
                f'trainer="{_escape_label(info.get("trainer", "none"))}",'
                f'route="{_escape_label(info.get("route", "strict"))}"'
                "} 1")
        lines += [
            "# HELP hpnn_serve_generation_requests_total Requests "
            "routed per model generation (A/B pinning).",
            "# TYPE hpnn_serve_generation_requests_total counter",
        ]
        for kernel, gens in sorted(snap["generations"].items()):
            for gen, n in sorted(
                    gens.items(),
                    key=lambda kv: -1 if kv[0] == "older" else int(kv[0])):
                lines.append(
                    "hpnn_serve_generation_requests_total"
                    f'{{kernel="{_escape_label(kernel)}",'
                    f'generation="{_escape_label(gen)}"}} {n}')
        if snap.get("jobs") is not None:
            lines += _jobs_prometheus(snap["jobs"])
        lines += [
            "# HELP hpnn_serve_queue_depth Requests waiting per kernel.",
            "# TYPE hpnn_serve_queue_depth gauge",
        ]
        for name, depth in sorted(snap["queue_depth"].items()):
            lines.append(
                f'hpnn_serve_queue_depth'
                f'{{kernel="{_escape_label(name)}"}} {depth}')
        if snap.get("lanes"):
            lines += [
                "# HELP hpnn_serve_lane_depth Rows queued per QoS "
                "priority lane.",
                "# TYPE hpnn_serve_lane_depth gauge",
            ]
            for name, lanes in sorted(snap["lanes"].items()):
                for lane, rows in sorted(lanes.items()):
                    lines.append(
                        "hpnn_serve_lane_depth"
                        f'{{kernel="{_escape_label(name)}",'
                        f'lane="{_escape_label(lane)}"}} {rows}')
        lines += [
            "# HELP hpnn_serve_bucket_rows_per_sec Device rows/sec per "
            "batch bucket.",
            "# TYPE hpnn_serve_bucket_rows_per_sec gauge",
        ]
        for bucket, st in sorted(snap["buckets"].items(),
                                 key=lambda kv: int(kv[0])):
            lines.append(
                f'hpnn_serve_bucket_rows_per_sec{{bucket="{bucket}"}} '
                f"{st['rows_per_s']}")
        lines += [
            "# HELP hpnn_serve_bucket_device_seconds_total Device wall "
            "per batch bucket.",
            "# TYPE hpnn_serve_bucket_device_seconds_total counter",
        ]
        for bucket, st in sorted(snap["buckets"].items(),
                                 key=lambda kv: int(kv[0])):
            lines.append(
                f'hpnn_serve_bucket_device_seconds_total{{bucket='
                f'"{bucket}"}} {st["device_s"]}')
        for key in ("latency", "queue_latency", "device_time"):
            h = snap[key]
            lines += [
                f"# HELP hpnn_serve_{key}_seconds Request {key} summary.",
                f"# TYPE hpnn_serve_{key}_seconds summary",
                f'hpnn_serve_{key}_seconds{{quantile="0.5"}} '
                f"{h['p50_ms'] / 1e3}",
                f'hpnn_serve_{key}_seconds{{quantile="0.99"}} '
                f"{h['p99_ms'] / 1e3}",
                f"hpnn_serve_{key}_seconds_sum {h['sum_seconds']}",
                f"hpnn_serve_{key}_seconds_count {h['count']}",
            ]
        if snap["phases"]:
            lines += [
                "# HELP hpnn_serve_phase_seconds Request-path phase "
                "latency (parse/queue_wait/batch_assembly/pad_h2d/"
                "device/d2h/respond).",
                "# TYPE hpnn_serve_phase_seconds summary",
            ]
            for ph, h in sorted(snap["phases"].items()):
                lab = _escape_label(ph)
                lines += [
                    f'hpnn_serve_phase_seconds{{phase="{lab}",'
                    f'quantile="0.5"}} {h["p50_ms"] / 1e3}',
                    f'hpnn_serve_phase_seconds{{phase="{lab}",'
                    f'quantile="0.99"}} {h["p99_ms"] / 1e3}',
                    f'hpnn_serve_phase_seconds_sum{{phase="{lab}"}} '
                    f'{h["sum_seconds"]}',
                    f'hpnn_serve_phase_seconds_count{{phase="{lab}"}} '
                    f'{h["count"]}',
                ]
        if snap["latency_by_bucket"]:
            lines += [
                "# HELP hpnn_serve_bucket_latency_seconds Whole-request "
                "latency per kernel and batch bucket.",
                "# TYPE hpnn_serve_bucket_latency_seconds summary",
            ]
            for kernel, buckets in sorted(
                    snap["latency_by_bucket"].items()):
                klab = _escape_label(kernel)
                for bucket, h in sorted(buckets.items(),
                                        key=lambda kv: int(kv[0])):
                    pre = (f'hpnn_serve_bucket_latency_seconds'
                           f'{{kernel="{klab}",bucket="{bucket}"')
                    lines += [
                        f'{pre},quantile="0.5"}} {h["p50_ms"] / 1e3}',
                        f'{pre},quantile="0.99"}} {h["p99_ms"] / 1e3}',
                        f'hpnn_serve_bucket_latency_seconds_sum'
                        f'{{kernel="{klab}",bucket="{bucket}"}} '
                        f'{h["sum_seconds"]}',
                        f'hpnn_serve_bucket_latency_seconds_count'
                        f'{{kernel="{klab}",bucket="{bucket}"}} '
                        f'{h["count"]}',
                    ]
        lines += [
            "# HELP hpnn_kernel_launches_total Launches of each "
            "hand-written kernel in this process.",
            "# TYPE hpnn_kernel_launches_total counter",
        ]
        lines += [f'hpnn_kernel_launches_total{{kernel="{k}"}} {v}'
                  for k, v in snap["kernel_launches"].items()]
        return "\n".join(lines) + "\n"


def _jobs_prometheus(j: dict) -> list[str]:
    """The ``hpnn_jobs_*`` families of one jobs snapshot (the JAX
    package's names, help texts and labels)."""
    running = j.get("running") or {}
    lines = [
        "# HELP hpnn_jobs_queue_depth Training jobs queued.",
        "# TYPE hpnn_jobs_queue_depth gauge",
        f"hpnn_jobs_queue_depth {j['queue_depth']}",
        "# HELP hpnn_jobs_running Whether a training job is "
        "running (1) or the device serves eval only (0).",
        "# TYPE hpnn_jobs_running gauge",
        f"hpnn_jobs_running {1 if running else 0}",
        "# HELP hpnn_jobs_trained_epochs_total Cumulative "
        "epochs trained by the jobs subsystem.",
        "# TYPE hpnn_jobs_trained_epochs_total counter",
        f"hpnn_jobs_trained_epochs_total {j['trained_epochs_total']}",
        "# HELP hpnn_jobs_upload_chunks_total Corpus chunks "
        "accepted by the chunked upload endpoints.",
        "# TYPE hpnn_jobs_upload_chunks_total counter",
        f"hpnn_jobs_upload_chunks_total {j.get('upload_chunks_total', 0)}",
    ]
    if running:
        lines += [
            "# HELP hpnn_jobs_running_epoch Running job's last "
            "completed epoch.",
            "# TYPE hpnn_jobs_running_epoch gauge",
            f"hpnn_jobs_running_epoch {running.get('epoch', 0)}",
        ]
        if running.get("mean_err") is not None:
            lines += [
                "# HELP hpnn_jobs_running_mean_err Running "
                "job's last epoch mean final error.",
                "# TYPE hpnn_jobs_running_mean_err gauge",
                f"hpnn_jobs_running_mean_err {running['mean_err']}",
            ]
    lines += [
        "# HELP hpnn_jobs_total Jobs by lifecycle status.",
        "# TYPE hpnn_jobs_total gauge",
    ]
    for status, n in sorted(j.get("by_status", {}).items()):
        lines.append(f'hpnn_jobs_total{{status="{_escape_label(status)}"}}'
                     f" {n}")
    if "slice_devices_total" in j:
        # the worker pool's device occupancy and one row per pinned job
        lines += [
            "# HELP hpnn_jobs_slices_active Training jobs "
            "holding a device slice.",
            "# TYPE hpnn_jobs_slices_active gauge",
            f"hpnn_jobs_slices_active {j['slices_active']}",
            "# HELP hpnn_jobs_slice_devices_in_use Devices "
            "held by job slices (of hpnn_jobs_slice_devices_total).",
            "# TYPE hpnn_jobs_slice_devices_in_use gauge",
            f"hpnn_jobs_slice_devices_in_use {j['slice_devices_in_use']}",
            "# HELP hpnn_jobs_slice_devices_total Devices the "
            "placement scheduler owns.",
            "# TYPE hpnn_jobs_slice_devices_total gauge",
            f"hpnn_jobs_slice_devices_total {j['slice_devices_total']}",
            "# HELP hpnn_jobs_queued_placements Slice requests "
            "waiting for devices to free.",
            "# TYPE hpnn_jobs_queued_placements gauge",
            f"hpnn_jobs_queued_placements {j.get('queued_placements', 0)}",
            "# HELP hpnn_jobs_slice_devices Devices pinned per "
            "running job (dp x tp grid labels).",
            "# TYPE hpnn_jobs_slice_devices gauge",
        ]
        for rj in j.get("running_jobs") or []:
            sl = rj.get("slice") or {}
            if not sl:
                continue
            lines.append(
                "hpnn_jobs_slice_devices"
                f'{{job="{_escape_label(rj["job"])}",'
                f'kernel="{_escape_label(rj.get("kernel") or "")}",'
                f'dp="{sl.get("dp", 1)}",'
                f'tp="{sl.get("tp", 1)}"}} '
                f'{sl.get("size", 0)}')
    return lines


__all__ = ["PHASES", "LatencyHistogram", "ServeMetrics"]
