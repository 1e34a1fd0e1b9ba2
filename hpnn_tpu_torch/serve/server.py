"""Stdlib HTTP front-end of the port's serving path (the port of
``hpnn_tpu/serve/server.py`` for one host).

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
  snapshot (``serve/metrics.py``).

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
  body's ``timeout_ms``): an expired one is a 504 at admission.

The mutating endpoints (reload, the train submits, corpus chunks, job
actions) honor ``--auth-token`` / ``HPNN_SERVE_TOKEN``: when configured,
a request without the matching ``Authorization: Bearer`` (or
``X-HPNN-Token``) header gets 401.

Status mapping: 200 result (202 for a train submit); 400 malformed body,
wrong input width, too many rows, a bad header or bad job params; 401
missing or invalid token on a mutating endpoint; 404 unknown kernel, job,
path or pinned generation; 409 reload failed (the old weights keep
serving), a job action in a conflicting state or a closed upload; 413 a
jobs body over its cap; 429 queue full (Retry-After from the queue's
measured drain rate; 1 s for the job queue); 503 draining, or
``jobs_disabled`` without ``--jobs``; 504 deadline exceeded; 500 anything
else.  An error body is ``{"error": <message>, "reason": <outcome>}``.

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
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..utils.nn_log import nn_dbg, nn_out, nn_warn
from . import qos
from .batcher import DeadlineExceeded, MicroBatcher, QueueFull, ServeClosed
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
                 auth_token: str | None = None, ab_fraction: float = 0.0):
        self.metrics = metrics or ServeMetrics()
        self.auth_token = auth_token or None
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
        if warmup:
            if background:
                with self._warming_lock:
                    self._warming.add(model.name)
                threading.Thread(
                    target=self._warm, args=(model,),
                    name=f"hpnn-warmup-{model.name}", daemon=True).start()
            else:
                self._warm(model)
        b = MicroBatcher(model, metrics=self.metrics,
                         max_queue_rows=self.max_queue_rows,
                         linger_s=self.linger_s)
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
        if self.jobs is not None:
            # the jobs first: a running job finishes its in-flight epoch,
            # snapshots and lands `interrupted` (resumable) before the
            # eval batchers stop
            self.jobs.drain()
        for b in self.batchers.values():
            b.close(drain=drain)

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

    # --- model lifecycle (hot reload) -----------------------------------
    def reload_model(self, name: str, kernel_path: str | None = None,
                     set_generation: int | None = None) -> dict:
        """Swap a model's weights from disk under traffic (the registry's
        ``reload``); raises KeyError for an unknown kernel, ValueError
        when the weights cannot be loaded or uploaded (the served weights
        stay untouched).  Counted into the reload metrics either way."""
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
            result = self.reload_model(name, os.path.join(ckpt_dir, rel))
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
        status = ("draining" if self._closed
                  else "warming" if warming else "ok")
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
                self.jobs.queue.depth() + self.jobs.running_count()}
        if self.jobs is not None:
            # which device slices the job workers hold, and how many
            # asks await placement
            body["job_slices"] = self.jobs.slices.occupancy()
        if warming:
            body["warming"] = warming
        return (200 if status == "ok" else 503), body

    def handle_infer(self, name: str, body: bytes, headers=None) -> dict:
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
        self.metrics.observe_phase("parse", time.monotonic() - t_parse0)
        try:
            outs, served_gen = b.submit(xs, timeout_s, gen=gen,
                                        return_gen=True, lane=lane)
        except QueueFull as exc:
            raise _HTTPError(429, "queue_full", str(exc),
                             retry_after=getattr(exc, "retry_after_s",
                                                 None)
                             or b.retry_after_s())
        except DeadlineExceeded as exc:
            raise _HTTPError(504, "deadline", str(exc))
        except ServeClosed as exc:
            raise _HTTPError(503, "error", str(exc))
        except Exception as exc:
            raise _HTTPError(500, "error", f"{type(exc).__name__}: {exc}")
        if served_gen is None:  # registry stand-ins without generations
            served_gen = gen if gen is not None else model.generation
        self.metrics.count_generation(name, served_gen)
        return {"kernel": name,
                "generation": int(served_gen),
                "outputs": outs.tolist(),
                "argmax": [int(i) for i in np.argmax(outs, axis=1)]}

    def handle_reload(self, name: str, body: bytes) -> dict:
        """POST /v1/kernels/<name>/reload: optional JSON body
        ``{"kernel": "<path>"}`` picks the weights file (default: the
        model's last source); ``{"set_generation": G}`` pins the
        post-swap generation.  A ``blob`` (a content-addressed weights
        blob) needs a serve-mesh worker, which the port does not have:
        409, as the JAX package answers without one.  409 when the
        weights cannot be landed (the old weights keep serving)."""
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
            raise _HTTPError(
                409, "reload_failed",
                "blob reload needs a mesh worker agent (no router to "
                "fetch the bytes from)")
        try:
            return self.reload_model(name, kernel_path,
                                     set_generation=set_generation)
        except KeyError:
            raise _HTTPError(404, "not_found", f"unknown kernel '{name}'")
        except ValueError as exc:
            raise _HTTPError(409, "reload_failed", str(exc))
        except Exception as exc:
            raise _HTTPError(500, "error", f"{type(exc).__name__}: {exc}")

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
            job = jobs.submit(name, params, corpus_files=corpus_files)
        except (JobQueueFull, JobError) as exc:
            raise self._submit_error(exc)
        return job.to_dict()

    def handle_train_chunked(self, name: str, spool: str | None,
                             content_type: str = "") -> dict:
        """POST /v1/kernels/<name>/train/chunked: submit a training job
        on its first corpus chunk (multipart: ``params`` and file parts).
        The job queues at once and holds training until the upload
        closes; 202 with the job record and the chunk endpoint."""
        from ..jobs import JobError, JobQueueFull

        jobs = self._jobs_or_503()
        params, files = _parse_multipart(_read_spool(spool), content_type)
        try:
            job = jobs.submit_chunked(name, params, files)
        except (JobQueueFull, JobError) as exc:
            raise self._submit_error(exc)
        out = job.to_dict()
        out["upload"] = {"endpoint": f"/v1/jobs/{job.job_id}/corpus",
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
        path, _, query = self.path.partition("?")
        if path == "/healthz":
            status, body = self.app.healthz()
            self._reply(status, body)
        elif path == "/metrics":
            if "format=json" in query:
                self._reply(200, self.app.metrics.snapshot())
            else:
                self._reply(200, self.app.metrics.render_prometheus()
                            .encode("utf-8"),
                            content_type="text/plain; version=0.0.4")
        else:
            self._do_get_jobs(path, query)

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
        r = _RELOAD_RE.match(path)
        a = _JOB_ACTION_RE.match(path)
        if (r or tr or a or ck or jc) \
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
        try:
            out = self.app.handle_infer(m.group(1), body,
                                        headers=self.headers)
        except _HTTPError as exc:
            self.app.metrics.count_request(exc.outcome)
            headers = None
            if exc.status == 429:
                # Retry-After from the queue's measured drain rate
                headers = {"Retry-After": str(
                    max(1, math.ceil(exc.retry_after or 1.0)))}
            self._reply(exc.status,
                        {"error": str(exc), "reason": exc.outcome},
                        extra_headers=headers)
            return
        self.app.metrics.count_request("ok")
        t_resp0 = time.monotonic()
        self._reply(200, out)
        self.app.metrics.observe_phase("respond", time.monotonic() - t_resp0)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # socketserver's default listen backlog is 5: a burst of concurrent
    # clients would be reset by the kernel before admission control runs;
    # backpressure must come from the 429 path, not the accept queue
    request_queue_size = 128


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
