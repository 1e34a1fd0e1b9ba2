"""Stdlib HTTP front-end of the port's serving path (the port of
``hpnn_tpu/serve/server.py``).

Endpoints:

* ``POST /v1/kernels/<name>/infer`` -- body ``{"inputs": [[...], ...]}``
  (or ``"input": [...]`` for one row), optional ``"timeout_ms"``.  Replies
  ``{"kernel", "generation", "outputs": [[...], ...], "argmax": [...]}``;
  outputs are float64 rendered by json's shortest round-trip repr, so the
  bytes decode to EXACTLY the floats the run_kernel batch path computes
  with the weights of the generation the reply names.
* ``POST /v1/kernels/<name>/reload`` -- hot-swap the model's weights from
  disk (optional body ``{"kernel": "<path>", "set_generation": G}``)
  without dropping in-flight traffic; a same-topology swap reuses every
  cached bucket.  ``serve_nn --watch-ckpt`` polls a checkpoint manifest
  and reloads on every generation bump through the same path.
* ``GET /healthz`` -- ``200 ok`` once every background warmup finished
  (``503 warming`` before, ``503 draining`` during shutdown), with the
  registered kernels, their head types and trainers, the parity, the
  uptime and the queued rows per kernel.
* ``GET /metrics`` -- Prometheus text; ``?format=json`` for the JSON
  snapshot (``serve/metrics.py``).  On a mesh router ``?fleet=1``
  federates every worker's snapshot: per-worker series and fleet rollups,
  a dead worker an explicit ``hpnn_fleet_worker_up 0``.
* ``GET /v1/debug/trace[?trace=ID&limit=N&since_seq=S&spool=1&timeline=1]``
  -- the flight recorder (``obs/``) as NDJSON, one completed span a line;
  404 until tracing is on (``--trace`` / ``HPNN_TRACE=1``).  An infer
  request's trace id (``X-HPNN-Trace-Id``, or minted) is echoed in the
  response header and body, and its tree ``serve.request`` -> {``parse``,
  ``queue_wait``, ``batch_assembly``, ``pad_h2d``, ``device_launch``,
  ``d2h``, ``respond``} is in the recorder before the reply leaves.
  ``spool=1`` reads the ``--span-dir`` spool back, ``timeline=1`` renders
  the incident timeline; ``GET /v1/debug/trace/search`` and
  ``/v1/debug/trace/critical`` answer from the spool's indexes (the ring
  without one).  On a mesh router the trace and search are fleet-merged
  (the router's spans and every worker's collected ones, host-tagged,
  also of workers that have died); ``since_seq`` and ``local=1`` page
  this process's ring only.  With ``--trace-sample P`` keep/drop is decided once at a
  trace's birth; an explicit trace id or a high-priority request always
  captures.
* ``POST /v1/debug/profile`` -- ``{"seconds": N, "dir": PATH?}``: a
  ``torch.profiler`` capture of the live server (a Chrome trace; the
  card's kernels by their ``__global__`` names), behind the auth token;
  409 while one runs, 501 when the profiler cannot start.  The default
  destination is ``--profile-dir``, else a fresh temp dir.

The serve mesh (``serve/mesh/``): ``serve_nn --mesh-role router``
(``ServeApp.enable_mesh_router``) fans its batches over registered
workers through ``mesh.backend.RemoteBackend``; ``--mesh-role worker``
(``enable_mesh_worker``) serves normally and heartbeats to its router.
``--mesh-role standby --primary HOST:PORT`` (``enable_mesh_standby``) is a
router held passive that mirrors the primary's ``GET /v1/mesh/state`` and
takes over after ``--takeover-after`` missed polls; a primary started with
``--standby HOST:PORT`` advertises it in every ack, so worker heartbeats
alternate to it when the primary dies.  ``--autoscale MIN:MAX``
(``enable_autoscale``) turns the desired-workers gauge into spawned and
retired local workers (``mesh.autoscale.WorkerSupervisor``).

* ``POST /v1/mesh/register`` -- a worker's heartbeat (``{"addr",
  "kernels", "jobs", "blobs"}``) or goodbye (``{"retiring": true}``); the
  ack carries the fleet's generation and content-addressed blob per
  kernel, the standby's address and the spill-protection token.  503
  without a router role, or on a passive standby.
* ``GET /v1/mesh/workers`` -- the worker table; ``GET /v1/mesh/state`` --
  the table and per-kernel blobs (behind the token when one is set);
  ``GET /v1/mesh/blob/<sha256>`` -- a blob's bytes (a worker serves the
  blobs its cache holds to swarm peers); ``POST /v1/mesh/bundle`` and
  ``GET /v1/mesh/bundles?scope=S`` -- replicated checkpoint bundles
  (``--replicate-to http://router``).
* A router's reload is fleet-coherent: the workers land the new weights
  at one target generation (from the blob, sha256-checked), then the
  router flips.

With ``serve_nn --jobs N`` (``ServeApp.enable_jobs``, ``jobs/``), the
training service:

* ``POST /v1/kernels/<name>/train`` -- submit a training job (JSON with a
  server-side ``samples`` dir, or multipart/form-data: a ``params`` JSON
  field and corpus file parts); 202 with the job record.
* ``POST /v1/kernels/<name>/train/chunked`` -- submit on the first corpus
  chunk; ``POST /v1/jobs/<id>/corpus[?final=1]`` appends the rest.  A
  body over ``HPNN_JOBS_MAX_BODY_MB`` is a 413 that names the chunked
  endpoint.
* ``GET /v1/jobs[?state=S&limit=N]``, ``GET /v1/jobs/<id>`` and
  ``GET /v1/jobs/<id>/events`` (chunked NDJSON until the job is terminal).
* ``POST /v1/jobs/<id>/{cancel,promote,rollback}``.

Request headers:

* ``X-HPNN-Generation: G`` -- pin the request to generation G (the
  current one or a retained one; 404 ``unknown_generation`` otherwise).
  Unpinned traffic goes to the live weights, or with ``--ab-fraction``
  during a swap window partly to the previous generation.
* ``X-HPNN-Priority: high|normal|low`` -- the queue lane; dequeue is
  lane-ordered, earliest-deadline-first within a lane.
* ``X-HPNN-Deadline-Ms: N`` -- the request's own deadline (wins over the
  body's ``timeout_ms``): an expired one is a 504 at admission; it rides
  the mesh RPC, so workers hold the same budget.
* ``X-HPNN-Client: ID`` -- the quota key of ``--quota-rows`` token buckets
  (else the auth token, else the peer address).

Admission (``serve/mesh/qos.py``, ``obs/slo.py``): ``--quota-rows``
charges each client per row before the queue (429 ``quota_exceeded`` with
the bucket's refill as Retry-After; refunded when the queue refuses);
``--slo-p99-ms``/``--slo-availability`` track per-kernel burn rates (only
server-caused failures spend the availability budget); with
``--shed-low`` a burning budget serves the low lane from a retained older
generation (``X-HPNN-Served-Stale: 1``) or sheds it (429 ``shed``), with
hysteresis.  ``/healthz`` reports ``slo_burning`` and ``shed_engaged``,
``/metrics`` the quota, shed, SLO and autoscale (desired workers)
families.  ``HPNN_FAULT`` injects faults into this server's replies and
the mesh's RPCs (``serve/mesh/chaos.py``).

The mutating endpoints (reload, the train submits, corpus chunks, job
actions, profile captures) honor ``--auth-token`` /
``HPNN_SERVE_TOKEN``: when configured, a request without the matching
``Authorization: Bearer`` (or ``X-HPNN-Token``) header gets 401.

Status mapping: 200 result (202 for a train submit); 400 malformed body,
wrong input width, too many rows, a bad header or bad job params; 401
missing or invalid token on a mutating endpoint; 403 infer traffic
without the router's ``X-HPNN-Router`` token on a ``--require-router``
worker; 404 unknown kernel, job, path, blob or pinned generation, tracing
off or no spool on a debug read;
409 reload failed (the old weights keep serving), a job action in a
conflicting state, a closed upload or a profile already running; 413 a
jobs body over its cap; 429 queue full, quota exceeded or shed
(Retry-After from the queue's measured drain rate, the quota bucket's
refill or the shed gate's hysteresis; 1 s for the job queue); 501
profiler unavailable; 503 draining, ``jobs_disabled`` without
``--jobs``, ``mesh_disabled``, or no live mesh worker
(``mesh_unavailable``), or a passive standby (``standby_passive``: the
client's move is one retry against the other router of the pair); 504
deadline exceeded; 507 a bundle the router could not spool; 500 anything
else.  An error body is ``{"error": <message>,
"reason": <outcome>}``.

``ThreadingHTTPServer`` gives one thread per connection; they all block
in ``MicroBatcher.submit`` and each kernel's worker thread is the only one
launching its forward.
"""

from __future__ import annotations

import contextlib
import hmac
import json
import math
import os
import re
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..obs import trace as obs_trace
from ..utils.nn_log import nn_dbg, nn_out, nn_warn
from .batcher import DeadlineExceeded, MicroBatcher, QueueFull, ServeClosed
from .mesh import chaos
from .mesh import qos
from .mesh.backend import NoLiveWorker, RemoteHTTPError
from .metrics import ServeMetrics
from .registry import ModelRegistry

_INFER_RE = re.compile(r"^/v1/kernels/([^/]+)/infer$")
_RELOAD_RE = re.compile(r"^/v1/kernels/([^/]+)/reload$")
_TRAIN_RE = re.compile(r"^/v1/kernels/([^/]+)/train$")
_TRAIN_CHUNKED_RE = re.compile(r"^/v1/kernels/([^/]+)/train/chunked$")
_JOB_CORPUS_RE = re.compile(r"^/v1/jobs/([^/]+)/corpus$")
_JOB_RE = re.compile(r"^/v1/jobs/([^/]+)$")
_JOB_EVENTS_RE = re.compile(r"^/v1/jobs/([^/]+)/events$")
_JOB_ACTION_RE = re.compile(
    r"^/v1/jobs/([^/]+)/(cancel|promote|rollback)$")
_BLOB_RE = re.compile(r"^/v1/mesh/blob/([0-9a-f]{64})$")


class _HTTPError(Exception):
    def __init__(self, status: int, outcome: str, message: str,
                 retry_after: float | None = None):
        super().__init__(message)
        self.status = status
        self.outcome = outcome
        self.retry_after = retry_after  # seconds; 429s render the header


def _jobs_body_cap_bytes() -> int:
    """The body cap of the jobs endpoints: one POST (a single-shot train
    submit or one corpus chunk) carries at most HPNN_JOBS_MAX_BODY_MB (0
    disables).  It is enforced from the Content-Length, before the body
    is read; an oversized single-shot submit gets a 413 that points at
    the chunked endpoint."""
    from ..utils.env import env_int

    return env_int("HPNN_JOBS_MAX_BODY_MB", 64, lo=0) << 20


def _read_spool(path: str | None) -> bytes:
    """A request body spooled to disk by ``_spool_body`` (its size was
    capped from the Content-Length, so one read is bounded)."""
    if not path:
        return b""
    with open(path, "rb") as fp:
        return fp.read()


def _parse_multipart(body: bytes,
                     content_type: str) -> tuple[dict, list]:
    """A multipart/form-data train submit: the ``params`` field (JSON)
    and the corpus file parts (filename -> sample text bytes), decoded by
    the stdlib email parser."""
    import email.parser
    import email.policy

    try:
        msg = email.parser.BytesParser(
            policy=email.policy.default).parsebytes(
            b"Content-Type: " + content_type.encode("latin-1")
            + b"\r\nMIME-Version: 1.0\r\n\r\n" + body)
    except Exception as exc:
        raise _HTTPError(400, "bad_request", f"bad multipart body: {exc}")
    if not msg.is_multipart():
        raise _HTTPError(400, "bad_request",
                         "multipart body has no parts (bad boundary?)")
    params: dict = {}
    files: list[tuple[str, bytes]] = []
    for part in msg.iter_parts():
        payload = part.get_payload(decode=True)
        if payload is None:
            continue
        fname = part.get_filename()
        if fname:
            files.append((fname, payload))
            continue
        field = part.get_param("name", header="content-disposition")
        if field == "params":
            try:
                params = json.loads(payload.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError) as exc:
                raise _HTTPError(400, "bad_request",
                                 f"bad params JSON: {exc}")
            if not isinstance(params, dict):
                raise _HTTPError(400, "bad_request",
                                 "'params' must be a JSON object")
    return params, files


def _tp_mesh_from_env(device):
    """The tp@K tier's model axis from ``HPNN_TP_DEVICES``: a LocalMesh
    over the first K cards this process sees (K capped to them with the
    JAX package's warning; one device on ``--device cpu``), or None below
    two.  Kernels over the per-device budget serve row-sharded on it."""
    import torch

    from ..parallel.mesh import LocalMesh, tp_device_count

    dev = torch.device(device)
    n_visible = torch.cuda.device_count() if dev.type == "cuda" else 1
    k = tp_device_count(n_visible)
    if k <= 1:
        return None
    nn_out(f"serve: TP mesh 1x{k} ready (over-budget kernels serve "
           "row-sharded)\n")
    return LocalMesh([torch.device("cuda", i) for i in range(k)])


class ServeApp:
    """Registry + one micro-batcher per kernel + metrics: everything the
    HTTP handler needs, independent of the socket layer (tests drive it
    directly and through real HTTP)."""

    def __init__(self, max_batch: int = 64, max_queue_rows: int = 256,
                 linger_s: float = 0.0, default_timeout_s: float = 30.0,
                 parity: str = "strict", fast_threshold: int = 256,
                 device="cuda", metrics: ServeMetrics | None = None,
                 auth_token: str | None = None, ab_fraction: float = 0.0,
                 trace: bool | None = None, trace_sample: float | None = None,
                 span_dir: str | None = None,
                 profile_dir: str | None = None,
                 quota_rows: float = 0.0,
                 quota_burst: float | None = None,
                 slo_p99_ms: float | None = None,
                 slo_availability: float | None = None,
                 require_router: bool = False,
                 shed_low: bool | None = None):
        self.metrics = metrics or ServeMetrics()
        self.auth_token = auth_token or None
        self.profile_dir = profile_dir  # /v1/debug/profile default dest
        # spill protection (worker side): serve only infer traffic that
        # carries the router's X-HPNN-Router token (learned from the
        # registration ack), so router-side quotas cannot be bypassed by
        # calling this worker directly
        self.require_router = bool(require_router)
        # SLO tracking, built only when an objective is set: the off path
        # is `self.slo is None`
        self.slo = None
        self.shedder = None
        if slo_p99_ms is not None or slo_availability is not None:
            from ..obs.slo import SloTracker

            self.slo = SloTracker(availability=slo_availability,
                                  p99_ms=slo_p99_ms)
            self.metrics.set_slo(self.slo)
            # SLO-driven shedding: while an objective burns, the LOW lane
            # is refused at admission (429 with the clear hysteresis as
            # Retry-After).  Opt-in (--shed-low / HPNN_SHED=1)
            if shed_low is None:
                shed_low = os.environ.get("HPNN_SHED", "") == "1"
            if shed_low:
                self.shedder = qos.LoadShedder(self.slo)
                self.metrics.set_shed_source(self.shedder.snapshot)
        # per-client token-bucket quotas (rows/s; 0 = none)
        self.quota = (qos.QuotaTable(quota_rows, quota_burst)
                      if quota_rows and quota_rows > 0 else None)
        self.mesh_router = None  # MeshRouter once enable_mesh_router()
        self.mesh_worker = None  # WorkerAgent when serving as a worker
        self.mesh_standby = None  # StandbyMonitor on a standby router
        self.autoscaler = None   # WorkerSupervisor once enable_autoscale()
        # span tracing: an explicit flag wins -- True enables, False
        # disables (even when HPNN_TRACE was set at init_all), None
        # defers to the env
        if trace:
            obs_trace.enable()
        elif trace is None:
            obs_trace.enable_from_env()
        else:
            obs_trace.disable()
        # head-based sampling: decided once at a trace's birth (do_POST);
        # the flag wins over HPNN_TRACE_SAMPLE
        if trace_sample is not None:
            obs_trace.set_sample_rate(trace_sample)
        # durable span export: spans stream off the ring into rotating
        # NDJSON segments under span_dir, so they survive SIGKILL
        self.span_exporter = None
        span_dir = span_dir or os.environ.get("HPNN_SPAN_DIR") or None
        if span_dir:
            from ..obs.export import SpanExporter

            self.span_exporter = SpanExporter(span_dir)
            obs_trace.set_exporter(self.span_exporter)
        self.registry = ModelRegistry(max_batch=max_batch, parity=parity,
                                      fast_threshold=fast_threshold,
                                      device=device, metrics=self.metrics,
                                      ab_fraction=ab_fraction,
                                      tp_mesh=_tp_mesh_from_env(device))
        self.batchers: dict[str, MicroBatcher] = {}
        self.max_queue_rows = int(max_queue_rows)
        self.linger_s = float(linger_s)
        self.default_timeout_s = float(default_timeout_s)
        self._warming: set[str] = set()
        self._warming_lock = threading.Lock()
        self._watchers: list[threading.Thread] = []
        self._closed = False
        self.jobs = None              # the JobScheduler (enable_jobs)
        self.started_mono = time.monotonic()  # /healthz uptime_s
        # the autoscaling signal (queued rows and drain rate -> desired
        # workers), read live at /metrics render time
        self.metrics.set_autoscale_source(self.autoscale_snapshot)
        if self.quota is not None:
            self.metrics.set_quota_source(self.quota.snapshot)

    def _warm(self, model) -> None:
        try:
            n = model.warmup()
            nn_out(f"serve: warmed {n} batch bucket(s) for "
                   f"'{model.name}'\n")
        except Exception as exc:  # a failed warmup must not kill serving
            nn_warn(f"serve: warmup failed for '{model.name}': {exc}\n")
        finally:
            with self._warming_lock:
                self._warming.discard(model.name)

    def warming(self) -> list[str]:
        """Kernels whose background warmup is still running."""
        with self._warming_lock:
            return sorted(self._warming)

    def add_model(self, conf_path: str, name: str | None = None,
                  warmup: bool = True, background: bool = False):
        """Register one ``.conf`` (the files run_nn takes).  With
        ``warmup`` every batch bucket runs once now, or on a daemon
        thread with ``background`` (``/healthz`` reports ``warming``
        until it finishes).  A name collision is a registration failure
        (None, diagnosed by the registry)."""
        model = self.registry.register_conf(conf_path, name=name)
        if model is None:
            return None
        if warmup and self.mesh_router is None:
            # a router launches nothing itself: warming its buckets on
            # the card would only delay readiness
            if background:
                with self._warming_lock:
                    self._warming.add(model.name)
                threading.Thread(
                    target=self._warm, args=(model,),
                    name=f"hpnn-warmup-{model.name}", daemon=True).start()
            else:
                self._warm(model)
        backend = (self.mesh_router.backend_for(model)
                   if self.mesh_router is not None else None)
        b = MicroBatcher(model, metrics=self.metrics,
                         max_queue_rows=self.max_queue_rows,
                         linger_s=self.linger_s, backend=backend)
        self.batchers[model.name] = b
        self.metrics.register_queue(model.name, b.depth)
        self.metrics.register_lanes(model.name, b.lane_depths)
        return model

    def infer(self, name: str, xs: np.ndarray,
              timeout_s: float | None = None) -> np.ndarray:
        b = self.batchers.get(name)
        if b is None:
            raise KeyError(name)
        return b.submit(xs, timeout_s if timeout_s is not None
                        else self.default_timeout_s)

    def close(self, drain: bool = True) -> None:
        self._closed = True  # also stops the manifest watchers
        if self.autoscaler is not None:
            # first: a supervisor spawning or retiring mid-shutdown would
            # fight the drain below; its managed workers get the same
            # drain-then-SIGTERM they get at scale-down
            self.autoscaler.close()
        if self.jobs is not None:
            # the jobs first: a running job finishes its in-flight epoch,
            # snapshots and lands `interrupted` (resumable) before the
            # eval batchers stop
            self.jobs.drain()
        if self.mesh_worker is not None:
            # the goodbye only on a graceful drain: drain=False stands
            # for a crash and must look like one to the router
            self.mesh_worker.close(goodbye=drain)
        if self.mesh_standby is not None:
            self.mesh_standby.close()
        for b in self.batchers.values():
            b.close(drain=drain)
        if self.mesh_router is not None:
            # after the batchers: draining batches still need the pool's
            # RPC executor
            self.mesh_router.close()
        if self.span_exporter is not None:
            # after everything that records spans: the last spans land
            # in a final rotated segment
            if obs_trace.get_exporter() is self.span_exporter:
                obs_trace.set_exporter(None)
            self.span_exporter.close()

    def uptime_s(self) -> float:
        return time.monotonic() - self.started_mono

    # --- auth (mutating endpoints) --------------------------------------
    def authorized(self, headers) -> bool:
        """True when no token is configured, or the request carries it
        (``Authorization: Bearer <token>`` or ``X-HPNN-Token``), compared
        in constant time."""
        tok = self.auth_token
        if not tok:
            return True
        if not headers:
            return False
        # compare bytes: compare_digest raises TypeError on non-ASCII str,
        # and header values arrive latin-1-decoded -- an unauthenticated
        # client must get a 401, never a traceback
        want = tok.encode("utf-8")

        def _eq(supplied: str) -> bool:
            return hmac.compare_digest(
                supplied.encode("utf-8", "surrogateescape"), want)

        auth = headers.get("Authorization", "")
        if auth.startswith("Bearer ") and _eq(auth[7:].strip()):
            return True
        return _eq(headers.get("X-HPNN-Token") or "")

    # --- online training jobs -------------------------------------------
    def enable_jobs(self, job_dir: str, capacity: int = 8,
                    preempt_wait_s: float = 2.0,
                    auto_promote: bool = False,
                    auto_resume: bool | None = None,
                    replicate_to: str | None = None,
                    job_workers: int = 1, devices=None):
        """Attach the train-while-serving job service (``serve_nn --jobs
        N``): a bounded queue, ``job_workers`` slice-pinned scheduler
        workers over ``devices`` (default: this process's cards, or the
        CPU device) and the persistent job store under ``job_dir``, with
        its gauges in /metrics.  ``auto_promote`` evaluates a finished
        job's candidate generation on a held-out test dir and promotes or
        rolls back; ``auto_resume``/``replicate_to`` re-queue interrupted
        jobs from their newest verified bundle, local or replicated."""
        from ..jobs import JobScheduler

        # jobs consume retained generations (rollback, pins, canary
        # counters) even without an A/B fraction
        self.registry.retain_generations = True
        self.jobs = JobScheduler(self, job_dir, capacity=capacity,
                                 preempt_wait_s=preempt_wait_s,
                                 auto_promote=auto_promote,
                                 auto_resume=auto_resume,
                                 replicate_to=replicate_to,
                                 job_workers=job_workers, devices=devices)
        self.metrics.set_jobs_source(self.jobs.metrics_snapshot)
        return self.jobs

    # --- the serve mesh ---------------------------------------------------
    def enable_mesh_router(self, required_workers: int = 1,
                           health_interval_s: float = 1.0,
                           standby_addr: str | None = None,
                           router_token: str | None = None):
        """Make this app a mesh ROUTER (``serve_nn --mesh-role router``):
        models registered after this call get a ``RemoteBackend`` that
        fans their batches over the worker pool, /healthz reports
        ``warming`` until ``required_workers`` are live, and reloads
        become fleet-coherent broadcasts.  Must run before ``add_model``
        (the backend is wired at batcher creation).  ``standby_addr``
        advertises this router's standby to workers; ``router_token`` pins
        the spill-protection secret (default: a random one)."""
        from .mesh.router import MeshRouter

        if self.batchers:
            raise RuntimeError("enable_mesh_router must run before any "
                               "add_model (backends are wired at "
                               "batcher creation)")
        self.mesh_router = MeshRouter(
            self, required=required_workers,
            health_interval_s=health_interval_s,
            standby_addr=standby_addr,
            router_token=router_token)
        self.metrics.set_mesh_source(self.mesh_router.metrics_snapshot)
        return self.mesh_router

    def enable_mesh_standby(self, primary_addr: str,
                            required_workers: int = 1,
                            health_interval_s: float = 1.0,
                            router_token: str | None = None,
                            takeover_after: int | None = None,
                            poll_interval_s: float | None = None):
        """Make this app the PASSIVE STANDBY of ``primary_addr``
        (``serve_nn --mesh-role standby --primary HOST:PORT``): a full
        mesh router whose admission answers 503 ``standby_passive`` while
        a monitor mirrors the primary (worker table, kernel generations
        through content-addressed blobs, spill token) and takes over after
        ``takeover_after`` consecutive unreachable polls.  Must run before
        ``add_model``, like :meth:`enable_mesh_router`."""
        from .mesh.standby import StandbyMonitor

        self.enable_mesh_router(required_workers=required_workers,
                                health_interval_s=health_interval_s,
                                router_token=router_token)
        self.mesh_standby = StandbyMonitor(
            self, primary_addr, takeover_after=takeover_after,
            poll_interval_s=poll_interval_s).start()
        return self.mesh_standby

    def standby_passive(self) -> bool:
        """True while this server is a standby that has not taken over
        (infer, reload, registration and bundles answer 503)."""
        return self.mesh_standby is not None and self.mesh_standby.passive

    def _refuse_if_passive(self, reload: bool = False) -> None:
        """503 ``standby_passive`` on a passive standby: the primary still
        owns the fleet, and the client's move is one retry against it."""
        if not self.standby_passive():
            return
        primary = self.mesh_standby.primary
        raise _HTTPError(503, "standby_passive", (
            "this router is a passive standby; reload through the "
            f"primary ({primary})") if reload else
            f"this router is a passive standby of {primary}")

    def enable_mesh_worker(self, router_addr: str, advertise: str,
                           interval_s: float | None = None):
        """Make this app a mesh WORKER (``serve_nn --mesh-role worker``):
        start the heartbeat agent that registers ``advertise`` with the
        router at ``router_addr`` and catches this server's generations
        up to the fleet's.  Call once the socket is bound (the advertised
        address needs the real port)."""
        from .mesh.worker import WorkerAgent

        self.mesh_worker = WorkerAgent(self, router_addr, advertise,
                                       interval_s=interval_s).start()
        self.metrics.set_swarm_source(self.mesh_worker.swarm_snapshot)
        return self.mesh_worker

    def handle_mesh_register(self, body: bytes) -> dict:
        """POST /v1/mesh/register: a worker's registration heartbeat, or
        its goodbye (``{"retiring": true}``)."""
        if self.mesh_router is None:
            raise _HTTPError(503, "mesh_disabled",
                             "this server is not a mesh router "
                             "(start serve_nn with --mesh-role router)")
        # a worker's heartbeat loop alternates straight back to the
        # primary on this 503
        self._refuse_if_passive()
        try:
            req = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise _HTTPError(400, "bad_request", f"bad JSON: {exc}")
        if not isinstance(req, dict) or not req.get("addr"):
            raise _HTTPError(400, "bad_request",
                             "body must be an object with 'addr'")
        addr = str(req["addr"])
        # every later RPC and health poll reaches the worker at addr: a
        # port-less or junk addr is refused here, not found later as
        # ValueErrors in the dispatch path
        host, _, port = addr.rpartition(":")
        if not (host and port.isdigit() and 0 < int(port) < 65536):
            raise _HTTPError(400, "bad_request",
                             f"'addr' must be HOST:PORT, got {addr!r}")
        if req.get("retiring") is True:
            # a worker saying goodbye (SIGTERM drain): out of routing
            # now, not after health misses
            known = self.mesh_router.pool.retire(addr, via="goodbye")
            return {"ok": True, "retiring": True, "known": known}
        kernels = req.get("kernels")
        if kernels is not None and not isinstance(kernels, dict):
            raise _HTTPError(400, "bad_request",
                             "'kernels' must be an object")
        jobs = req.get("jobs")
        if jobs is not None and not isinstance(jobs, dict):
            jobs = None  # advisory: junk is ignored, not refused
        blobs = req.get("blobs")
        if blobs is not None and not isinstance(blobs, list):
            blobs = None  # advisory has-set: ignored when junk
        return self.mesh_router.register_worker(addr, kernels,
                                                jobs=jobs, blobs=blobs)

    def handle_mesh_state(self, headers) -> dict:
        """GET /v1/mesh/state: the worker table and per-kernel generation
        and blob.  With an auth token configured the whole endpoint needs
        it and the spill token rides along; with auth off it is open but
        the token is left out (a public secret protects nothing)."""
        if self.mesh_router is None:
            raise _HTTPError(404, "mesh_disabled",
                             "this server is not a mesh router")
        if not self.authorized(headers):
            raise _HTTPError(401, "unauthorized",
                             "missing or invalid auth token")
        # standby re-pairing: a freshly started standby announces itself
        # on every mirror poll; an ACTIVE router adopts it at run time, so
        # its registration acks advertise the new pair to workers without
        # a restart (behind the auth token whenever one is configured)
        standby = (headers.get("X-HPNN-Standby") or "").strip()
        if standby and not self.standby_passive():
            host, _, port = standby.rpartition(":")
            if (host and port.isdigit() and 0 < int(port) < 65536
                    and self.mesh_router.standby_addr != standby):
                from .mesh.events import mesh_event

                prev = self.mesh_router.standby_addr
                self.mesh_router.standby_addr = standby
                mesh_event("standby_attached",
                           f"mesh: standby {standby} attached "
                           f"(replacing {prev or 'none'}); workers "
                           "learn it from the next heartbeat ack\n",
                           standby=standby, previous=prev)
        return self.mesh_router.state_snapshot(bool(self.auth_token))

    def handle_mesh_bundle(self, query: str, body: bytes) -> dict:
        """POST /v1/mesh/bundle?scope=S&tag=T&epoch=N: a training host
        replicating one packed checkpoint bundle.  The bytes land in the
        router's content-addressed blob store and its durable spool; the
        reply's sha256 is what the shipper checks against its own."""
        from ..utils.env import env_int

        if self.mesh_router is None:
            raise _HTTPError(503, "mesh_disabled",
                             "this server is not a mesh router "
                             "(start serve_nn with --mesh-role router)")
        self._refuse_if_passive()
        params = dict(kv.split("=", 1)
                      for kv in query.split("&") if "=" in kv)
        scope = params.get("scope") or ""
        if not scope:
            raise _HTTPError(400, "bad_request",
                             "missing 'scope' query parameter")
        if not body:
            raise _HTTPError(400, "bad_request", "empty bundle body")
        max_mb = env_int("HPNN_MESH_BUNDLE_MAX_MB", 256, lo=1)
        if len(body) > max_mb << 20:
            raise _HTTPError(413, "too_large",
                             f"bundle exceeds {max_mb} MB")
        try:
            epoch = int(params.get("epoch") or 0)
        except ValueError:
            raise _HTTPError(400, "bad_request", "bad 'epoch'")
        try:
            return self.mesh_router.store_bundle(
                scope, body, params.get("tag") or "", epoch)
        except OSError as exc:
            # the durable spool write is part of the contract: the
            # shipper retries instead of trusting a volatile copy
            raise _HTTPError(507, "spool_failure",
                             f"bundle spool write failed: {exc}")

    def enable_autoscale(self, router_addr: str, confs: list[str],
                         min_workers: int = 1, max_workers: int = 4,
                         cooldown_s: float | None = None,
                         worker_args: tuple = (),
                         poll_s: float | None = None,
                         start: bool = True):
        """Attach the elastic worker supervisor (``serve_nn --autoscale
        MIN:MAX`` on a router): the desired-workers gauge becomes an
        actuator that spawns and retires local port workers on this
        server's device (or drives the ``HPNN_AUTOSCALE_EXEC`` hook); see
        ``serve/mesh/autoscale.py``."""
        from .mesh.autoscale import WorkerSupervisor

        # an auth-enabled router's spawned workers send the token with
        # their registration heartbeats; env, not argv (ps never shows it)
        extra_env = ({"HPNN_SERVE_TOKEN": self.auth_token}
                     if self.auth_token else None)
        self.autoscaler = WorkerSupervisor(
            self, router_addr, confs, min_workers=min_workers,
            max_workers=max_workers, cooldown_s=cooldown_s,
            poll_s=poll_s, worker_args=worker_args,
            extra_env=extra_env)
        if start:
            self.autoscaler.start()
        return self.autoscaler

    def autoscale_snapshot(self) -> dict:
        """The autoscaling signal /metrics renders: queued rows, the
        measured drain rate and the desired-worker gauge derived from
        them (``mesh.qos.desired_workers``); with a supervisor attached,
        its actuator counters under ``supervisor``."""
        queued = sum(b.depth() for b in self.batchers.values())
        rate = sum(b.drain_rate() for b in self.batchers.values())
        live = (self.mesh_router.pool.live_count()
                if self.mesh_router is not None else 1)
        out = {"queued_rows": queued,
               "drain_rows_per_s": round(rate, 2),
               "live_workers": live,
               "desired_workers": qos.desired_workers(queued, rate, live)}
        if self.autoscaler is not None:
            out["supervisor"] = self.autoscaler.snapshot()
        return out

    # --- model lifecycle (hot reload) -----------------------------------
    def reload_model(self, name: str, kernel_path: str | None = None,
                     set_generation: int | None = None,
                     broadcast: bool = True) -> dict:
        """Swap a model's weights from disk under traffic (the registry's
        ``reload``); raises KeyError for an unknown kernel, ValueError
        when the weights cannot be loaded or uploaded (the served weights
        stay untouched).  Counted into the reload metrics either way.  On
        a mesh router every reload is fleet-coherent: the weights go to
        the live workers at one target generation first, then the router
        flips its own (``broadcast=False`` is the coordinator's own
        call)."""
        if (broadcast and self.mesh_router is not None
                and set_generation is None):
            return self.mesh_router.coherent_reload(name, kernel_path)
        result, reason = self.registry.reload(
            name, kernel_path, set_generation=set_generation)
        if result is None:
            self.metrics.count_reload(False)
            if "unknown kernel" in reason:
                raise KeyError(name)
            raise ValueError(reason)
        self.metrics.count_reload(True)
        return result

    def poll_ckpt_reload(self, name: str, ckpt_dir: str,
                         state: dict) -> dict | None:
        """One manifest poll: hot-reload ``name`` when the checkpoint
        manifest's ``generation`` moved past ``state['gen']``.  Returns the
        reload result, or None when nothing new was loadable."""
        from ..ckpt import read_manifest

        m = read_manifest(ckpt_dir)
        if not m:
            return None
        gen = m.get("generation", 0)
        if gen == state.get("gen", 0):
            return None
        rel = m.get("kernel")
        if not rel:
            state["gen"] = gen
            return None
        try:
            with obs_trace.span("serve.hot_swap", kernel=name,
                                manifest_generation=gen):
                result = self.reload_model(name,
                                           os.path.join(ckpt_dir, rel))
        except Exception as exc:
            # the generation is not consumed: a transient failure on a
            # run's last bump would otherwise leave the server stale
            # forever; the next poll retries
            nn_warn(f"serve: watched reload of '{name}' from "
                    f"{ckpt_dir} failed (will retry): {exc}\n")
            return None
        state["gen"] = gen
        return result

    def watch_manifest(self, name: str, ckpt_dir: str,
                       interval_s: float = 2.0) -> threading.Thread:
        """Poll a checkpoint directory's manifest and hot-reload ``name``
        whenever its ``generation`` moves: a training run checkpointing
        into that directory streams its progress into serving.  The
        manifest and every bundle are published by atomic rename, so a
        poll never sees a half-written kernel."""
        # baseline 0, not the manifest's current generation: a manifest
        # that already exists when the watch starts is loaded on the
        # first poll
        state = {"gen": 0}

        def loop():
            while not self._closed:
                time.sleep(interval_s)
                if not self._closed:
                    self.poll_ckpt_reload(name, ckpt_dir, state)

        t = threading.Thread(target=loop, daemon=True,
                             name=f"hpnn-ckpt-watch-{name}")
        t.start()
        self._watchers.append(t)
        nn_out(f"serve: watching {ckpt_dir} for '{name}' reloads "
               f"(every {interval_s:g}s)\n")
        return t

    # --- handlers -------------------------------------------------------
    def healthz(self) -> tuple[int, dict]:
        warming = self.warming()
        mesh = None
        if self.mesh_router is not None:
            mesh = self.mesh_router.readiness()
        elif self.mesh_worker is not None:
            mesh = self.mesh_worker.info()
        if self.mesh_standby is not None:
            # a standby reports its own readiness axis: "passive" (do not
            # route here) until takeover, then the router quorum contract
            mesh = dict(mesh or {})
            mesh.update(self.mesh_standby.info())
        # a mesh router is not ready until a quorum of workers is: its
        # own state says nothing about whether a request could be served
        status = ("draining" if self._closed
                  else "passive" if self.standby_passive()
                  else "warming" if warming
                  or (mesh is not None and mesh.get("quorum") is False)
                  else "ok")
        reg = self.registry
        body = {"status": status,
                "kernels": reg.names(),
                "kernel_types": {
                    n: {"type": m.kind, "trainer": m.trainer}
                    for n in reg.names()
                    if (m := reg.get(n)) is not None},
                "parity": reg.parity,
                "device": str(reg.device),
                "uptime_s": round(self.uptime_s(), 3),
                "queue_depth": {name: b.depth() for name, b in
                                self.batchers.items()},
                "active_jobs": 0 if self.jobs is None else
                self.jobs.queue.depth() + self.jobs.running_count(),
                # a burning error budget and an engaged shed gate, for
                # probes that do not parse /metrics
                "slo_burning": (self.slo.burning_count
                                if self.slo is not None else 0),
                "shed_engaged": (bool(self.shedder.active)
                                 if self.shedder is not None else False)}
        if self.jobs is not None:
            # which device slices the job workers hold, and how many
            # asks await placement
            body["job_slices"] = self.jobs.slices.occupancy()
        if mesh is not None:
            body["mesh"] = mesh
        if warming:
            body["warming"] = warming
        return (200 if status == "ok" else 503), body

    # --- observability ------------------------------------------------
    def handle_debug_profile(self, body: bytes) -> dict:
        """POST /v1/debug/profile: a ``torch.profiler`` capture of the
        LIVE server for ``{"seconds": N}`` -- traffic keeps flowing; the
        profiler observes from the side.  ``{"dir": PATH}`` overrides
        ``--profile-dir``; with neither, a fresh temp directory is minted
        and returned.  409 while another capture runs (the profiler is a
        process singleton), 501 when it cannot start here."""
        from ..obs import profiler

        req = {}
        if body.strip():
            try:
                req = json.loads(body.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError) as exc:
                raise _HTTPError(400, "bad_request", f"bad JSON: {exc}")
            if not isinstance(req, dict):
                raise _HTTPError(400, "bad_request",
                                 "body must be an object")
        try:
            seconds = float(req.get("seconds", 1.0))
        except (TypeError, ValueError):
            raise _HTTPError(400, "bad_request", "bad 'seconds'")
        if not 0.0 < seconds <= profiler.MAX_CAPTURE_S:
            raise _HTTPError(
                400, "bad_request",
                f"'seconds' must be in (0, {profiler.MAX_CAPTURE_S:g}]")
        out_dir = req.get("dir") or self.profile_dir
        if out_dir is None:
            import tempfile

            out_dir = tempfile.mkdtemp(prefix="hpnn-profile-")
        try:
            rec = profiler.capture(seconds, out_dir)
        except profiler.ProfilerBusy as exc:
            raise _HTTPError(409, "profile_busy", str(exc))
        except profiler.ProfilerUnavailable as exc:
            raise _HTTPError(501, "profile_unavailable", str(exc))
        rec["requested_seconds"] = seconds
        return rec

    def _analysis_spans(self) -> list[dict]:
        """The in-memory spans analysis reads without a spool: this
        process's ring, plus on a mesh router the fleet store's collected
        worker spans."""
        if self.mesh_router is not None:
            return self.mesh_router.fleet.merged_spans(drain=True)
        return obs_trace.snapshot()

    def handle_trace_search(self, params: dict,
                            federate: bool = True) -> dict:
        """GET /v1/debug/trace/search: per-trace summaries from the trace
        index (the ``--span-dir`` sidecars; the ring without a spool).  On
        a mesh router the query federates across the live workers, and
        the fleet store keeps dead workers' collected spans queryable;
        ``federate=False`` (``?local=1``) answers from this process
        only."""
        from ..obs import index as trace_index

        try:
            if self.span_exporter is not None:
                # pending spans become searchable first (drain, not
                # flush: a polling search must not force rotations)
                self.span_exporter.drain()
                payload = trace_index.search(self.span_exporter.span_dir,
                                             params)
            else:
                payload = trace_index.search_spans(self._analysis_spans(),
                                                   params)
        except (TypeError, ValueError) as exc:
            raise _HTTPError(400, "bad_request", f"bad query: {exc}")
        if federate and self.mesh_router is not None:
            have = {r["trace"] for r in payload["traces"]}
            remote = self.mesh_router.fleet.federated_search(params)
            merged = list(payload["traces"])
            for addr in sorted(remote):
                for row in remote[addr] or []:
                    if row.get("trace") in have:
                        continue  # the collector's or spool's copy wins
                    have.add(row.get("trace"))
                    row["host"] = addr
                    merged.append(row)
            merged.sort(key=lambda r: (-(r.get("start_ts") or 0.0),
                                       r.get("trace") or ""))
            limit = payload["query"].get("limit")
            if limit is not None and limit >= 0:
                merged = merged[:limit]
            payload["traces"] = merged
            payload["count"] = len(merged)
        return payload

    def handle_trace_critical(self, params: dict) -> dict:
        """GET /v1/debug/trace/critical: per-phase p50/p99 critical-path
        self-time over the sampled traces.  From the span spool when one
        is configured (byte-identical to ``obs.tool critical`` over the
        same directory), else from the ring."""
        from ..obs import analyze

        try:
            kernel = params.get("kernel") or None
            window_s = (float(params["window"])
                        if params.get("window") not in (None, "")
                        else None)
            limit = (int(params["limit"])
                     if params.get("limit") not in (None, "") else None)
        except (TypeError, ValueError) as exc:
            raise _HTTPError(400, "bad_request", f"bad query: {exc}")
        if self.span_exporter is not None:
            self.span_exporter.drain()
            return analyze.critical_from_dir(
                self.span_exporter.span_dir, kernel=kernel,
                window_s=window_s, limit=limit)
        return analyze.critical_from_spans(
            self._analysis_spans(), kernel=kernel, window_s=window_s,
            limit=limit)

    def handle_trace_timeline(self, params: dict) -> str:
        """GET /v1/debug/trace?timeline=1: the incident timeline as NDJSON
        -- spans, structured events and job state transitions in one
        time-ordered narrative; spool-backed when a span dir is
        configured (so ``obs.tool timeline`` reproduces it)."""
        from ..obs import analyze

        try:
            since = (float(params["since"])
                     if params.get("since") not in (None, "") else None)
            until = (float(params["until"])
                     if params.get("until") not in (None, "") else None)
            limit = (int(params["limit"])
                     if params.get("limit") not in (None, "") else None)
        except (TypeError, ValueError) as exc:
            raise _HTTPError(400, "bad_request", f"bad query: {exc}")
        if self.span_exporter is not None:
            from ..obs.export import read_spool

            self.span_exporter.drain()
            spans = read_spool(self.span_exporter.span_dir)
        else:
            spans = self._analysis_spans()
        return analyze.render_timeline(
            analyze.build_timeline(spans, since=since, until=until,
                                   limit=limit))

    def handle_infer(self, name: str, body: bytes, headers=None,
                     trace_ctx: tuple[str, str] | None = None,
                     peer: str | None = None) -> dict:
        """One infer request; ``trace_ctx`` is the HTTP layer's
        ``(trace_id, root_span_id)`` when this request is traced, ``peer``
        the client address (the last quota key).  Admission order: spill
        protection, then the shed gate before the rows are parsed, then
        the quota charged per row before the queue (refunded when the
        queue refuses)."""
        # a passive standby: the documented client move is one retry
        # against the other router of the pair (the primary)
        self._refuse_if_passive()
        if self.require_router and self.mesh_worker is not None:
            # spill protection: only the router's stamped traffic is
            # served, so its quotas cannot be bypassed
            want = self.mesh_worker.router_token
            got = (headers.get("X-HPNN-Router") or "") if headers else ""
            if not want or not hmac.compare_digest(
                    got.encode("utf-8", "surrogateescape"),
                    want.encode("utf-8")):
                raise _HTTPError(
                    403, "router_only",
                    "this worker only serves traffic routed through "
                    "the mesh router (missing or invalid "
                    "X-HPNN-Router token)")
        b = self.batchers.get(name)
        if b is None:
            raise _HTTPError(404, "not_found", f"unknown kernel '{name}'")
        t_parse0 = time.monotonic()
        try:
            req = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise _HTTPError(400, "bad_request", f"bad JSON: {exc}")
        if not isinstance(req, dict):
            raise _HTTPError(400, "bad_request", "body must be an object")
        # an explicit X-HPNN-Generation pin wins; otherwise an open A/B
        # window sends a fraction to the previous generation; None is the
        # live weights
        requested = headers.get("X-HPNN-Generation") if headers else None
        if requested is not None:
            try:
                requested = int(requested)
            except (TypeError, ValueError):
                raise _HTTPError(400, "bad_request",
                                 "X-HPNN-Generation must be an integer")
        if self.mesh_router is not None and requested is not None:
            # the router retains no generations itself: the pin passes
            # through and the worker checks it (its 404 comes back)
            gen = requested
        else:
            try:
                gen = b.model.resolve_generation(requested)
            except KeyError:
                raise _HTTPError(
                    404, "unknown_generation",
                    f"kernel '{name}' has no pinned generation "
                    f"{requested} (retained: "
                    f"{b.model.generation_table()['retained']})")
        try:
            lane = qos.parse_priority(
                headers.get("X-HPNN-Priority") if headers else None)
        except ValueError as exc:
            raise _HTTPError(400, "bad_request", str(exc))
        # SLO-driven shedding: while a budget burns the LOW lane is
        # refused before its rows are parsed or its quota charged.  The
        # 429 is a client-visible policy outcome and spends no budget
        served_stale = False
        if self.shedder is not None and self.shedder.gate_engaged(lane):
            # brownout before shedding: a kernel that retains an older
            # generation serves the low lane from it (flagged
            # X-HPNN-Served-Stale), and only a kernel with nothing to
            # fall back to sheds.  An explicit pin is never overridden
            stale_gen = None
            if requested is None:
                table = b.model.generation_table()
                prior = [g for g in table.get("retained", ())
                         if g < table.get("current", 0)]
                if prior:
                    stale_gen = max(prior)
            if stale_gen is None:
                self.shedder.count_shed()
                raise _HTTPError(
                    429, "shed",
                    "low-priority traffic shed: the availability budget "
                    "is burning (retry later or raise X-HPNN-Priority)",
                    retry_after=self.shedder.retry_after_s())
            gen = stale_gen
            served_stale = True
            self.shedder.count_stale()
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
        deadline_hdr = (headers.get("X-HPNN-Deadline-Ms") if headers
                        else None)
        if deadline_hdr is not None:
            # the header is the request's deadline: it wins over the body
            # timeout and the server default
            try:
                timeout_s = qos.parse_deadline_ms(deadline_hdr)
            except (TypeError, ValueError):
                raise _HTTPError(400, "bad_request",
                                 "X-HPNN-Deadline-Ms must be a number")
        # the per-client quota, charged per row before queue admission:
        # an over-quota client never holds queue capacity
        quota_key = None
        if self.quota is not None:
            quota_key = qos.client_key(headers, peer)
            allowed, wait_s = self.quota.allow(quota_key,
                                               float(xs.shape[0]))
            if not allowed:
                raise _HTTPError(
                    429, "quota_exceeded",
                    f"client quota exceeded ({self.quota.rate:g} rows/s"
                    f"; retry in {wait_s:.2f}s)", retry_after=wait_s)
        t_parse1 = time.monotonic()
        self.metrics.observe_phase("parse", t_parse1 - t_parse0)
        if trace_ctx is not None:
            obs_trace.record("parse", t_parse0, t_parse1,
                             trace_id=trace_ctx[0], parent_id=trace_ctx[1],
                             rows=int(xs.shape[0]))
        try:
            outs, served_gen = b.submit(xs, timeout_s, gen=gen,
                                        return_gen=True, lane=lane,
                                        trace=trace_ctx)
        except QueueFull as exc:
            if quota_key is not None:
                # the charge bought no service: refunded, or obedient
                # Retry-After clients burn their quota on backpressure
                self.quota.refund(quota_key, float(xs.shape[0]))
            raise _HTTPError(429, "queue_full", str(exc),
                             retry_after=getattr(exc, "retry_after_s",
                                                 None)
                             or b.retry_after_s())
        except DeadlineExceeded as exc:
            raise _HTTPError(504, "deadline", str(exc))
        except ServeClosed as exc:
            raise _HTTPError(503, "error", str(exc))
        except NoLiveWorker as exc:
            raise _HTTPError(503, "mesh_unavailable", str(exc))
        except RemoteHTTPError as exc:
            # a worker's status the router passes through as it is (a
            # 404 unknown_generation on a pin)
            raise _HTTPError(exc.status, exc.reason, str(exc))
        except Exception as exc:
            raise _HTTPError(500, "error", f"{type(exc).__name__}: {exc}")
        if served_gen is None:  # registry stand-ins without generations
            served_gen = gen if gen is not None else model.generation
        self.metrics.count_generation(name, served_gen)
        out = {"kernel": name,
               "generation": int(served_gen),
               "outputs": outs.tolist(),
               "argmax": [int(i) for i in np.argmax(outs, axis=1)]}
        if served_stale:
            out["served_stale"] = True
        if trace_ctx is not None:
            out["trace"] = trace_ctx[0]
        return out

    def handle_reload(self, name: str, body: bytes) -> dict:
        """POST /v1/kernels/<name>/reload: optional JSON body
        ``{"kernel": "<path>"}`` picks the weights file (default: the
        model's last source); ``{"set_generation": G}`` pins the
        post-swap generation (the mesh broadcast's form), and ``{"blob":
        {"sha256", "size"}}`` names content-addressed weights instead of
        a path: a mesh worker pulls the bytes from its router (or a
        hinted peer), checks the hash, then loads them -- no shared
        filesystem needed.  409 when the weights cannot be landed (the
        old weights keep serving), or for a blob without a worker
        agent."""
        self._refuse_if_passive(reload=True)
        kernel_path = None
        set_generation = None
        blob = None
        if body.strip():
            try:
                req = json.loads(body.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError) as exc:
                raise _HTTPError(400, "bad_request", f"bad JSON: {exc}")
            if not isinstance(req, dict):
                raise _HTTPError(400, "bad_request",
                                 "body must be an object")
            kernel_path = req.get("kernel")
            if kernel_path is not None and not isinstance(kernel_path,
                                                          str):
                raise _HTTPError(400, "bad_request",
                                 "'kernel' must be a path string")
            set_generation = req.get("set_generation")
            if set_generation is not None:
                try:
                    set_generation = int(set_generation)
                except (TypeError, ValueError):
                    raise _HTTPError(400, "bad_request",
                                     "'set_generation' must be an "
                                     "integer")
            blob = req.get("blob")
            if blob is not None and not (isinstance(blob, dict)
                                         and blob.get("sha256")):
                raise _HTTPError(400, "bad_request",
                                 "'blob' must be an object with "
                                 "'sha256'")
        if blob is not None and kernel_path is None:
            kernel_path = self._fetch_reload_blob(blob, req.get("peers"))
        try:
            return self.reload_model(name, kernel_path,
                                     set_generation=set_generation)
        except KeyError:
            raise _HTTPError(404, "not_found", f"unknown kernel '{name}'")
        except ValueError as exc:
            raise _HTTPError(409, "reload_failed", str(exc))
        except Exception as exc:
            raise _HTTPError(500, "error", f"{type(exc).__name__}: {exc}")

    def _fetch_reload_blob(self, blob: dict, peers) -> str:
        """A content-addressed reload: the announced bytes pulled from
        the router this worker heartbeats to (or a hinted peer),
        sha256-checked, into the local blob cache; returns the path."""
        from .mesh import transport
        from .mesh.worker import swarm_enabled

        agent = self.mesh_worker
        if agent is None:
            raise _HTTPError(
                409, "reload_failed",
                "blob reload needs a mesh worker agent (no router to "
                "fetch the bytes from)")
        fetch_headers = None
        if self.auth_token:
            fetch_headers = {"Authorization": f"Bearer {self.auth_token}"}
        if not (swarm_enabled() and isinstance(peers, list)):
            peers = ()
        try:
            path, source, misses = transport.fetch_blob_from(
                agent.current, str(blob["sha256"]), blob.get("size"),
                agent.blob_dir, peers=peers, timeout_s=20.0,
                headers=fetch_headers, rng=agent._rng)
        except transport.BlobError as exc:
            raise _HTTPError(409, "reload_failed",
                             f"blob fetch failed: {exc}")
        agent.count_fetch(source, misses, bool(peers))
        return path

    # --- job endpoints --------------------------------------------------
    def _jobs_or_503(self):
        if self.jobs is None:
            raise _HTTPError(503, "jobs_disabled",
                             "online training is disabled "
                             "(start serve_nn with --jobs N)")
        return self.jobs

    @staticmethod
    def _submit_error(exc) -> _HTTPError:
        """A submit's JobQueueFull -> 429, unknown kernel -> 404, any
        other JobError -> 400."""
        from ..jobs import JobQueueFull

        if isinstance(exc, JobQueueFull):
            return _HTTPError(429, "queue_full", str(exc))
        msg = str(exc)
        if "unknown kernel" in msg:
            return _HTTPError(404, "not_found", msg)
        return _HTTPError(400, "bad_request", msg)

    def handle_train(self, name: str, body: bytes,
                     content_type: str = "") -> dict:
        """POST /v1/kernels/<name>/train: submit a training job, as JSON
        (a server-side ``samples`` path) or multipart/form-data (a
        ``params`` JSON field and corpus file parts).  202 with the job
        record; 400 bad params, 404 unknown kernel, 429 queue full."""
        from ..jobs import JobError, JobQueueFull

        jobs = self._jobs_or_503()
        corpus_files = None
        if content_type.startswith("multipart/form-data"):
            params, corpus_files = _parse_multipart(body, content_type)
        elif body.strip():
            try:
                params = json.loads(body.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError) as exc:
                raise _HTTPError(400, "bad_request", f"bad JSON: {exc}")
            if not isinstance(params, dict):
                raise _HTTPError(400, "bad_request",
                                 "body must be an object")
        else:
            params = {}
        try:
            _job, record = jobs.admit(name, params,
                                      corpus_files=corpus_files)
        except (JobQueueFull, JobError) as exc:
            raise self._submit_error(exc)
        return record

    def handle_train_chunked(self, name: str, spool: str | None,
                             content_type: str = "") -> dict:
        """POST /v1/kernels/<name>/train/chunked: submit a training job
        on its first corpus chunk (multipart: ``params`` and file parts).
        The job queues at once and holds training until the upload
        closes; 202 with the job record as admitted (``queued``, even
        when a worker already holds the job) and the chunk endpoint."""
        from ..jobs import JobError, JobQueueFull

        jobs = self._jobs_or_503()
        params, files = _parse_multipart(_read_spool(spool), content_type)
        try:
            out = jobs.submit_chunked(name, params, files)
        except (JobQueueFull, JobError) as exc:
            raise self._submit_error(exc)
        out["upload"] = {"endpoint": f"/v1/jobs/{out['job_id']}/corpus",
                         "chunks": 1, "complete": False}
        return out

    def handle_job_corpus(self, job_id: str, spool: str | None,
                          content_type: str = "",
                          query: str = "") -> dict:
        """POST /v1/jobs/<id>/corpus[?final=1]: append one corpus chunk
        to a chunked-upload job; ``final=1`` closes the upload (with
        files, or as a bare close) and releases the runner's hold."""
        import urllib.parse

        from ..jobs import JobError

        jobs = self._jobs_or_503()
        q = urllib.parse.parse_qs(query or "")
        final = (q.get("final") or ["0"])[-1] in ("1", "true")
        body = _read_spool(spool)
        files: list = []
        if body.strip():
            try:
                _params, files = _parse_multipart(body, content_type)
            except _HTTPError as exc:
                # a bare close is often an empty multipart (the closing
                # boundary only): no files, not a malformed body
                if "no parts" not in str(exc):
                    raise
        if not files and not final:
            raise _HTTPError(400, "bad_request",
                             "chunk carries no corpus files (send "
                             "files, or final=1 to close the upload)")
        try:
            return jobs.upload_chunk(job_id, files, final)
        except JobError as exc:
            msg = str(exc)
            if "unknown job" in msg:
                raise _HTTPError(404, "not_found", msg)
            if "no open chunked" in msg or "no longer accepting" in msg:
                raise _HTTPError(409, "conflict", msg)
            raise _HTTPError(400, "bad_request", msg)

    def handle_job_get(self, job_id: str) -> dict:
        jobs = self._jobs_or_503()
        snap = jobs.get(job_id)
        if snap is None:
            raise _HTTPError(404, "not_found", f"unknown job '{job_id}'")
        return snap

    def handle_job_list(self, state: str | None = None,
                        limit: str | None = None) -> dict:
        """GET /v1/jobs[?state=S&limit=N]: the whole history, or the
        records in one lifecycle state and/or the N most recent (ids are
        monotonic, so the tail is the recency window)."""
        from ..jobs.state import JOB_STATES

        jobs = self._jobs_or_503()
        records = jobs.list()
        if state is not None:
            if state not in JOB_STATES:
                raise _HTTPError(
                    400, "bad_request",
                    f"'state' must be one of {list(JOB_STATES)}: "
                    f"{state!r}")
            records = [r for r in records if r.get("status") == state]
        if limit is not None:
            try:
                n = int(limit)
            except ValueError:
                raise _HTTPError(400, "bad_request",
                                 f"'limit' must be an integer: {limit!r}")
            if n < 1:
                raise _HTTPError(400, "bad_request",
                                 f"'limit' must be >= 1: {n}")
            records = records[-n:]
        return {"jobs": records}

    def handle_job_action(self, job_id: str, action: str) -> dict:
        """POST /v1/jobs/<id>/{cancel,promote,rollback}.  Cancel stops the
        job at its next epoch boundary (a final snapshot is written);
        promote/rollback finalize the job's A/B window on its kernel."""
        from ..jobs import JobError

        jobs = self._jobs_or_503()
        job = jobs.store.get(job_id)
        if job is None:
            raise _HTTPError(404, "not_found", f"unknown job '{job_id}'")
        if action == "cancel":
            try:
                return jobs.cancel(job_id)
            except JobError as exc:
                raise _HTTPError(409, "conflict", str(exc))
        model = self.registry.get(job.kernel)
        if model is None:
            raise _HTTPError(404, "not_found",
                             f"job '{job_id}' kernel '{job.kernel}' is "
                             "not registered")
        if action == "promote":
            result = model.promote()
        else:  # rollback
            try:
                result = model.rollback()
            except KeyError as exc:
                raise _HTTPError(409, "conflict", str(exc))
            # a rollback is a weights swap: the lifecycle metrics follow,
            # as for a reload
            self.metrics.count_reload(True)
            self.metrics.set_model_info(model.name, model.generation,
                                        model.loaded_at)
        jobs.finalize(job_id,
                      "promoted" if action == "promote" else "rolled_back")
        result["job"] = jobs.get(job_id)
        return result


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "hpnn_tpu_torch-serve"
    # TCP_NODELAY: a reply is two writes (headers, then body), and with
    # Nagle's algorithm the body waits for the client's delayed ACK of the
    # headers -- about 40 ms on every keep-alive request
    disable_nagle_algorithm = True

    @property
    def app(self) -> ServeApp:
        return self.server.app  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # the console grammar stays clean
        nn_dbg("serve: " + (fmt % args) + "\n")

    def _chaos_server(self) -> bool:
        """Server-side ``HPNN_FAULT`` injection: this server's own reply
        path produces the failure, so a client's recovery (the router's
        retry elsewhere, the transport's stale retry, a blob re-fetch)
        meets real half-written bytes.  Consulted before any handler:
        ``http`` fabricates a ``code`` reply, ``latency`` sleeps ``ms``
        and goes on, ``truncate`` sends headers for a full body and half
        of it, and ``reset``/``reset-after``/``timeout`` sever the
        connection without a reply.  True when the fault consumed the
        request."""
        rule = chaos.pick(self.path, side="server")
        if rule is None:
            return False
        if rule.kind == "latency":
            time.sleep(rule.ms / 1e3)
            return False
        if rule.kind == "http":
            self._reply(rule.code, {"error": "injected fault",
                                    "reason": "chaos"})
            return True
        if rule.kind == "truncate":
            body = (json.dumps({"ok": True, "note": "chaos-truncate"})
                    + "\n").encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body[:len(body) // 2])
            self.wfile.flush()
            self.close_connection = True
            return True
        # reset / reset-after / timeout: sever without a reply
        with contextlib.suppress(OSError):
            self.connection.shutdown(socket.SHUT_RDWR)
        self.close_connection = True
        return True

    def _reply(self, status: int, payload,
               content_type: str = "application/json",
               extra_headers: dict | None = None) -> None:
        body = ((json.dumps(payload) + "\n").encode("utf-8")
                if content_type == "application/json" else payload)
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:
        if self._chaos_server():
            return
        path, _, query = self.path.partition("?")
        if path == "/healthz":
            status, body = self.app.healthz()
            self._reply(status, body)
        elif path == "/metrics":
            self._do_get_metrics(query)
        elif path.startswith("/v1/debug/trace"):
            self._do_get_trace(path, query)
        elif path.startswith("/v1/mesh/"):
            self._do_get_mesh(path, query)
        else:
            self._do_get_jobs(path, query)

    def _do_get_metrics(self, query: str) -> None:
        """``/metrics``; on a mesh router ``?fleet=1`` federates every
        worker's snapshot (per-worker series and fleet rollups; a dead
        worker is an explicit ``hpnn_fleet_worker_up 0``)."""
        router = self.app.mesh_router
        fleet = "fleet=1" in query and router is not None
        if "format=json" in query:
            if fleet:
                from .metrics import fleet_rollup

                workers = router.fleet.federated_metrics()
                self._reply(200, {"router": self.app.metrics.snapshot(),
                                  "workers": workers,
                                  "rollup": fleet_rollup(workers)})
            else:
                self._reply(200, self.app.metrics.snapshot())
            return
        text = (self.app.metrics.render_fleet_prometheus(
            router.fleet.federated_metrics()) if fleet
            else self.app.metrics.render_prometheus())
        self._reply(200, text.encode("utf-8"),
                    content_type="text/plain; version=0.0.4")

    def _do_get_mesh(self, path: str, query: str) -> None:
        """The router's mesh reads: the worker table, the state feed, the
        replicated-bundle index and content-addressed blobs (a worker
        serves the blobs its own cache holds to swarm peers)."""
        router = self.app.mesh_router
        if path == "/v1/mesh/state":
            try:
                self._reply(200, self.app.handle_mesh_state(self.headers))
            except _HTTPError as exc:
                self._reply(exc.status,
                            {"error": str(exc), "reason": exc.outcome})
            return
        m = _BLOB_RE.match(path)
        if path == "/v1/mesh/bundles" or m is not None:
            # fleet internals and the weights themselves: behind the
            # auth token whenever one is configured
            if not self.app.authorized(self.headers):
                self._reply(401, {"error": "missing or invalid auth "
                                  "token", "reason": "unauthorized"})
                return
        if m is not None:
            data = (router.blob_bytes(m.group(1))
                    if router is not None else None)
            if data is None and self.app.mesh_worker is not None:
                # the swarm's fast path: peers re-check the sha, so a
                # stale cache entry misleads nobody
                data = self.app.mesh_worker.blob_bytes(m.group(1))
            if data is None:
                self._reply(404, {"error": f"unknown blob {m.group(1)}",
                                  "reason": "not_found"})
                return
            self._reply(200, data, content_type="application/octet-stream")
            return
        if router is None:
            self._reply(404, {"error": "not a mesh router",
                              "reason": "mesh_disabled"})
            return
        if path not in ("/v1/mesh/workers", "/v1/mesh/bundles"):
            self._reply(404, {"error": f"no route {path}",
                              "reason": "not_found"})
            return
        if path == "/v1/mesh/workers":
            self._reply(200, {"workers": router.pool.table(),
                              "required": router.required,
                              "live": router.pool.live_count()})
            return
        params = dict(kv.split("=", 1) for kv in query.split("&")
                      if "=" in kv)
        scope = params.get("scope") or ""
        self._reply(200, {"scope": scope,
                          "bundles": router.bundle_list(scope)})

    def _do_get_trace(self, path: str, query: str) -> None:
        """The flight recorder's read endpoints (see the module doc); the
        JAX package's query grammar and status codes."""
        params = dict(
            kv.split("=", 1) for kv in query.split("&") if "=" in kv)
        if path in ("/v1/debug/trace/search", "/v1/debug/trace/critical"):
            # 404 only when there is nothing to answer from
            if self.app.span_exporter is None \
                    and not obs_trace.enabled():
                self._reply(404, {"error": "tracing is disabled and no "
                                  "span spool is configured (start "
                                  "serve_nn with --trace and/or "
                                  "--span-dir)",
                                  "reason": "tracing_disabled"})
                return
            try:
                if path.endswith("/search"):
                    out = self.app.handle_trace_search(
                        params, federate=params.get("local") != "1")
                else:
                    out = self.app.handle_trace_critical(params)
            except _HTTPError as exc:
                self._reply(exc.status,
                            {"error": str(exc), "reason": exc.outcome})
                return
            self._reply(200, out)
            return
        if path != "/v1/debug/trace":
            self._reply(404, {"error": f"no route {path}"})
            return
        limit = since_seq = None
        try:
            if params.get("limit"):
                limit = int(params["limit"])
            if params.get("since_seq"):
                since_seq = int(params["since_seq"])
        except ValueError:
            self._reply(400, {"error": "bad limit/since_seq",
                              "reason": "bad_request"})
            return
        trace_id = params.get("trace") or None
        if params.get("timeline") == "1":
            if self.app.span_exporter is None and not obs_trace.enabled():
                self._reply(404, {"error": "tracing is disabled and no "
                                  "span spool is configured",
                                  "reason": "tracing_disabled"})
                return
            try:
                text = self.app.handle_trace_timeline(params)
            except _HTTPError as exc:
                self._reply(exc.status,
                            {"error": str(exc), "reason": exc.outcome})
                return
            self._reply(200, text.encode("utf-8"),
                        content_type="application/x-ndjson")
            return
        if params.get("spool") == "1":
            # read back through the durable spool: the rotated segments
            # and the open spool files, so a trace evicted from the ring
            # (or recorded by an earlier process on the same --span-dir)
            # is still answerable
            exp = self.app.span_exporter
            if exp is None:
                self._reply(404, {"error": "no span spool (start "
                                  "serve_nn with --span-dir)",
                                  "reason": "spool_disabled"})
                return
            from ..obs.export import read_spool

            exp.drain()   # pending spans readable; no forced rotation
            spans = read_spool(exp.span_dir, trace_id=trace_id,
                               limit=limit)
            self._reply(200, obs_trace.render_ndjson(spans)
                        .encode("utf-8"),
                        content_type="application/x-ndjson")
            return
        if not obs_trace.enabled():
            self._reply(404, {"error": "tracing is disabled (start "
                              "serve_nn with --trace or HPNN_TRACE=1)",
                              "reason": "tracing_disabled"})
            return
        router = self.app.mesh_router
        # ?since_seq and ?local=1 page this process's ring (the fleet
        # collector's per-host protocol); otherwise a router serves the
        # fleet-merged view: its spans (role=router) and every worker's
        if (router is not None and since_seq is None
                and params.get("local") != "1"):
            text = router.fleet.merged_dump(trace_id=trace_id, limit=limit)
        else:
            text = obs_trace.dump_ndjson(trace_id=trace_id, limit=limit,
                                         since_seq=since_seq)
        # the scraper's cursor (newest recorded seq) and the ring's
        # identity: a changed ring id invalidates any stored cursor
        self._reply(200, text.encode("utf-8"),
                    content_type="application/x-ndjson",
                    extra_headers={"X-HPNN-Trace-Seq":
                                   str(obs_trace.last_seq()),
                                   "X-HPNN-Trace-Ring":
                                   obs_trace.ring_id()})

    def _do_get_jobs(self, path: str, query: str) -> None:
        try:
            if path == "/v1/jobs":
                import urllib.parse

                q = urllib.parse.parse_qs(query or "")
                self._reply(200, self.app.handle_job_list(
                    state=(q.get("state") or [None])[-1],
                    limit=(q.get("limit") or [None])[-1]))
                return
            m = _JOB_EVENTS_RE.match(path)
            if m is not None:
                self._stream_job_events(m.group(1))
                return
            m = _JOB_RE.match(path)
            if m is not None:
                self._reply(200, self.app.handle_job_get(m.group(1)))
                return
        except _HTTPError as exc:
            self._reply(exc.status,
                        {"error": str(exc), "reason": exc.outcome})
            return
        self._reply(404, {"error": f"no route {path}"})

    # --- job progress streaming ----------------------------------------
    def _write_chunk(self, data: bytes) -> None:
        """One HTTP/1.1 chunked-transfer frame (b"" is the terminator)."""
        if data:
            self.wfile.write(b"%X\r\n" % len(data) + data + b"\r\n")
        else:
            self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    def _stream_job_events(self, job_id: str,
                           max_s: float = 3600.0) -> None:
        """GET /v1/jobs/<id>/events: a chunked NDJSON feed, one line per
        observed change (status, epoch, error trajectory, generation
        swaps, slice), closed when the job is terminal.  A client that
        disconnects ends the stream; the job is unaffected."""
        from ..jobs.state import TERMINAL_STATES

        snap = self.app.handle_job_get(job_id)  # 404/503 before headers
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        last = None
        deadline = time.monotonic() + max_s
        try:
            while time.monotonic() < deadline:
                slice_ = snap.get("slice")
                key = (snap["status"], snap["epoch"],
                       len(snap["errors"]), len(snap["generations"]),
                       slice_ is not None)
                if key != last:
                    last = key
                    event = {
                        "job": snap["job_id"],
                        "kernel": snap["kernel"],
                        "status": snap["status"],
                        "epoch": snap["epoch"],
                        "epochs": snap["epochs"],
                        "errors": snap["errors"],
                        "generations": snap["generations"],
                        "slice": slice_,
                    }
                    self._write_chunk(
                        (json.dumps(event) + "\n").encode("utf-8"))
                if snap["status"] in TERMINAL_STATES:
                    break
                time.sleep(0.05)
                snap = self.app.handle_job_get(job_id)
            self._write_chunk(b"")
        except (BrokenPipeError, ConnectionResetError, _HTTPError):
            self.close_connection = True

    def do_POST(self) -> None:
        path = self.path.partition("?")[0]
        ck = _TRAIN_CHUNKED_RE.match(path)
        jc = _JOB_CORPUS_RE.match(path)
        tr = _TRAIN_RE.match(path)
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            self.close_connection = True  # unknown body length: resync
            self.app.metrics.count_request("bad_request")
            self._reply(400, {"error": "bad Content-Length",
                              "reason": "bad_request"})
            return
        cap = _jobs_body_cap_bytes()
        if cap and length > cap and (ck or jc or tr):
            self._refuse_too_large(length, cap, ck or tr)
            return
        spool = None
        if ck or jc:
            # corpus chunks stream to a disk spool as they leave the
            # socket: no more than one capped chunk sits in memory
            body = b""
            spool = self._spool_body(length)
        else:
            # drain the body first, whatever the route: unread bytes
            # would be parsed as the next request line on a keep-alive
            # connection
            body = self.rfile.read(length) if length > 0 else b""
        try:
            self._do_post_routed(path, body, spool, ck, jc, tr)
        finally:
            if spool is not None:
                with contextlib.suppress(OSError):
                    os.unlink(spool)

    def _refuse_too_large(self, length: int, cap: int, named) -> None:
        """413 from the Content-Length alone, the body discarded in
        bounded pieces (replying while the client still sends would show
        it a broken pipe instead of the 413); a single-shot submit is
        pointed at the chunked endpoint."""
        self.close_connection = True
        self.app.metrics.count_request("too_large")
        remaining = length
        while remaining > 0:
            piece = self.rfile.read(min(1 << 20, remaining))
            if not piece:
                break
            remaining -= len(piece)
        chunked = (f"/v1/kernels/{named.group(1)}/train/chunked" if named
                   else "/v1/kernels/<name>/train/chunked")
        self._reply(413, {
            "error": f"body is {length} bytes; the per-request cap "
                     f"is {cap} (HPNN_JOBS_MAX_BODY_MB)",
            "reason": "too_large",
            "hint": "split the corpus across chunked uploads: "
                    f"POST {chunked} with the first files, then "
                    "POST /v1/jobs/<id>/corpus per chunk "
                    "(?final=1 on the last)",
        }, extra_headers={"X-HPNN-Chunked-Endpoint": chunked})

    def _spool_body(self, length: int) -> str:
        """Drain the request body to a temp spool file in bounded pieces;
        returns its path (the caller unlinks it)."""
        import tempfile

        fd, spool = tempfile.mkstemp(prefix=".hpnn-upload-",
                                     suffix=".spool")
        with os.fdopen(fd, "wb") as fp:
            remaining = length
            while remaining > 0:
                piece = self.rfile.read(min(1 << 20, remaining))
                if not piece:
                    break
                fp.write(piece)
                remaining -= len(piece)
        return spool

    def _do_post_routed(self, path: str, body: bytes, spool, ck, jc,
                        tr) -> None:
        if self._chaos_server():
            return
        r = _RELOAD_RE.match(path)
        a = _JOB_ACTION_RE.match(path)
        prof = path == "/v1/debug/profile"
        mesh_reg = path == "/v1/mesh/register"
        bundle = path == "/v1/mesh/bundle"
        if (r or tr or a or ck or jc or prof or mesh_reg or bundle) \
                and not self.app.authorized(self.headers):
            # every mutating endpoint sits behind the token when one is
            # configured; infer, metrics and healthz stay open
            self._reply(401, {"error": "missing or invalid auth token",
                              "reason": "unauthorized"},
                        extra_headers={"WWW-Authenticate": "Bearer"})
            return
        ctype = self.headers.get("Content-Type", "")
        # route -> (call, success status); a submit's 429 carries
        # Retry-After
        if r is not None:
            call, ok = (lambda: self.app.handle_reload(r.group(1), body),
                        200)
        elif tr is not None:
            call, ok = (lambda: self.app.handle_train(
                tr.group(1), body, content_type=ctype), 202)
        elif ck is not None:
            call, ok = (lambda: self.app.handle_train_chunked(
                ck.group(1), spool, content_type=ctype), 202)
        elif jc is not None:
            call, ok = (lambda: self.app.handle_job_corpus(
                jc.group(1), spool, content_type=ctype,
                query=self.path.partition("?")[2]), 200)
        elif a is not None:
            call, ok = (lambda: self.app.handle_job_action(a.group(1),
                                                           a.group(2)),
                        200)
        elif prof:
            call, ok = (lambda: self.app.handle_debug_profile(body), 200)
        elif mesh_reg:
            call, ok = (lambda: self.app.handle_mesh_register(body), 200)
        elif bundle:
            call, ok = (lambda: self.app.handle_mesh_bundle(
                self.path.partition("?")[2], body), 200)
        else:
            self._do_infer(path, body)
            return
        try:
            out = call()
        except _HTTPError as exc:
            headers = ({"Retry-After": "1"}
                       if exc.status == 429 and (tr or ck) else None)
            self._reply(exc.status,
                        {"error": str(exc), "reason": exc.outcome},
                        extra_headers=headers)
            return
        self._reply(ok, out)

    def _do_infer(self, path: str, body: bytes) -> None:
        m = _INFER_RE.match(path)
        if m is None:
            self.app.metrics.count_request("not_found")
            self._reply(404, {"error": f"no route {self.path}"})
            return
        # the trace id: the client's X-HPNN-Trace-Id, or minted while
        # tracing is on; echoed either way.  Keep/drop is decided here,
        # once, at the trace's birth: a dropped trace mints no context,
        # so everything downstream takes the tracing-off path.  An
        # explicit id or a high-priority request forces capture.
        trace_hdr = (self.headers.get("X-HPNN-Trace-Id") or "").strip()
        trace_ctx = None
        if obs_trace.enabled():
            prio = (self.headers.get("X-HPNN-Priority") or "").strip()
            force = bool(trace_hdr) or prio.lower() in ("high", "0")
            if obs_trace.sample_trace(force=force):
                trace_ctx = (trace_hdr or obs_trace.new_trace_id(),
                             obs_trace.new_span_id())
        echo = ({"X-HPNN-Trace-Id": trace_ctx[0]} if trace_ctx
                else ({"X-HPNN-Trace-Id": trace_hdr} if trace_hdr
                      else None))
        t_req0 = time.monotonic()
        try:
            out = self.app.handle_infer(m.group(1), body,
                                        headers=self.headers,
                                        trace_ctx=trace_ctx,
                                        peer=self.client_address[0])
        except _HTTPError as exc:
            self.app.metrics.count_request(exc.outcome)
            if self.app.slo is not None and exc.outcome != "not_found":
                # availability SLO: only server-caused failures (5xx)
                # spend budget; a client's bad input or over-quota 429
                # does not.  Unknown kernels stay out entirely: the name
                # is client-supplied, and an objective per junk name
                # would be an unauthenticated cardinality leak
                self.app.slo.record_outcome(m.group(1), exc.status < 500)
            headers = dict(echo or {})
            if exc.status == 429:
                # Retry-After from the queue's measured drain rate
                headers["Retry-After"] = str(
                    max(1, math.ceil(exc.retry_after or 1.0)))
            if trace_ctx is not None:
                obs_trace.record("serve.request", t_req0, time.monotonic(),
                                 trace_id=trace_ctx[0],
                                 span_id=trace_ctx[1], kernel=m.group(1),
                                 outcome=exc.outcome, status=exc.status)
            self._reply(exc.status,
                        {"error": str(exc), "reason": exc.outcome},
                        extra_headers=headers or None)
            return
        self.app.metrics.count_request("ok")
        if self.app.slo is not None:
            self.app.slo.record_outcome(m.group(1), True)
        if trace_ctx is not None:
            # the root completes before the response bytes leave: once
            # the client can query /v1/debug/trace, its tree is there
            # (the respond span lands right after the write)
            obs_trace.record("serve.request", t_req0, time.monotonic(),
                             trace_id=trace_ctx[0], span_id=trace_ctx[1],
                             kernel=m.group(1), outcome="ok",
                             generation=out.get("generation"))
        t_resp0 = time.monotonic()
        if out.pop("served_stale", False):
            # brownout: the body's generation names the retained weights
            echo = dict(echo or {})
            echo["X-HPNN-Served-Stale"] = "1"
        self._reply(200, out, extra_headers=echo)
        t_resp1 = time.monotonic()
        self.app.metrics.observe_phase("respond", t_resp1 - t_resp0)
        if trace_ctx is not None:
            obs_trace.record("respond", t_resp0, t_resp1,
                             trace_id=trace_ctx[0], parent_id=trace_ctx[1])


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # socketserver's default listen backlog is 5: a burst of concurrent
    # clients would be reset by the kernel before admission control runs;
    # backpressure must come from the 429 path, not the accept queue
    request_queue_size = 128

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # the live client sockets: with the mesh's keep-alive transport a
        # server whose handler threads keep answering pooled connections
        # is not dead, so an in-process stand-in for a kill must sever
        # them (abort_connections)
        self._conns: set = set()
        self._conns_lock = threading.Lock()

    def process_request(self, request, client_address):
        with self._conns_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def abort_connections(self) -> None:
        """Sever every live client connection: with ``shutdown()`` and
        ``server_close()``, the in-process stand-in for a SIGKILL."""
        with self._conns_lock:
            conns = list(self._conns)
        for sock in conns:
            with contextlib.suppress(OSError):
                sock.shutdown(socket.SHUT_RDWR)


def make_server(addr: str, port: int, app: ServeApp) -> ThreadingHTTPServer:
    httpd = _Server((addr, port), _Handler)
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
