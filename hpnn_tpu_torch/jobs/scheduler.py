"""Job scheduler: train while serving (the port of
``hpnn_tpu/jobs/scheduler.py``).

A pool of K worker threads (``--job-workers K``, default 1) drains the
bounded :class:`~.queue.JobQueue` strictly FIFO.  Each worker acquires a
disjoint contiguous device slice from the shared
:class:`~.placement.SliceManager` (best fit, strict-FIFO grants;
``dp_devices``/``tp_devices``/``model_parallel`` submit params size the
ask, an undeclared job gets the fair default share) and drives its job
through the reentrant training entry pinned to that slice
(``api.train_job(..., devices=slice)``: the configure/train_loop/
checkpoint path ``train_nn`` runs, so a job's ``kernel.opt`` is the bytes
of the offline CLI run of its conf on as many devices; the slice is the
job's training grid).  The slice is released on every
terminal path, and a per-tick ``reclaim`` sweep frees any slice whose owner
is no longer installed.

The device is shared with eval traffic at epoch granularity.  The port's
kernels launch on the current CUDA stream from the worker and from the
batchers alike, so a served batch waits behind a running epoch launch;
between epochs the job waits for the batchers:

* the trainer calls back at every epoch boundary (``on_epoch``); the
  worker updates the persistent job record, flushes the due snapshot,
  hot-reloads the published bundle into the serving registry (the
  manifest-generation path ``--watch-ckpt`` polls, driven synchronously so
  a swap lands the moment its bundle is durable), and then yields: while
  eval traffic is queued on any batcher, the next epoch waits (bounded by
  ``preempt_wait_s``);
* cancel and graceful drain latch the job's stop event; the in-flight
  epoch finishes, the checkpoint manager writes a final snapshot, and the
  job lands ``cancelled`` or ``interrupted``, resumable through a
  ``resume_job`` submit or an offline ``train_nn --resume``.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
import time

from ..obs import trace as obs_trace
from ..utils import nn_log
from ..utils.env import env_device_cap, env_float, env_int
from ..utils.nn_log import nn_out, nn_warn
from .placement import SliceManager, plan_request, process_devices
from .queue import JobQueue, JobQueueFull
from .state import (
    JOB_CONSOLE,
    JOB_CORPUS,
    TERMINAL_STATES,
    JobError,
    JobState,
    JobStore,
)

__all__ = ["JobScheduler", "JobQueueFull", "JobError"]

_TRAINERS = ("BP", "BPM", "CG")
_DTYPES = ("f64", "f32", "bf16")
_TYPES = ("ANN", "SNN", "LNN")

# chunked upload: a job admitted on its first corpus chunk carries this
# marker in its dir until the last chunk lands; the runner holds training
# (bounded by HPNN_JOBS_UPLOAD_WAIT_S) while admission, conf generation,
# queue dwell and the incremental pack build overlap the upload
JOB_UPLOAD_MARKER = ".upload-incomplete"

# the yield gate resumes training only after the batcher queues stay
# drained this many consecutive 1 ms ticks: a saturated closed-loop client
# dips to zero for a tick between a drain and its next arrivals
YIELD_QUIESCE_TICKS = 10

# console.log prefixes per captured nn_log level
_LOG_PREFIX = {"dbg": "NN(DBG): ", "out": "NN: ", "cout": "",
               "warn": "NN(WARN): ", "error": "NN(ERR): ", "raw": ""}


def _as_int(params: dict, key: str, default: int, floor: int = 0) -> int:
    v = params.get(key, default)
    try:
        v = int(v)
    except (TypeError, ValueError):
        raise JobError(f"'{key}' must be an integer: {v!r}")
    if v < floor:
        raise JobError(f"'{key}' must be >= {floor}: {v}")
    return v


class JobScheduler:
    def __init__(self, app, job_dir: str, capacity: int = 8,
                 preempt_wait_s: float = 2.0,
                 auto_promote: bool = False,
                 auto_resume: bool | None = None,
                 replicate_to: str | None = None,
                 job_workers: int = 1, devices=None):
        self.app = app
        # eval-driven auto-promotion: a job that lands "done" has its
        # candidate generation evaluated against the pre-job baseline on
        # a held-out test dir, then promoted or rolled back
        self.auto_promote = bool(auto_promote)
        # lease-based auto-resume: interrupted jobs (crash recovery,
        # expired leases) are re-queued from their newest verified
        # local-or-replicated bundle under a retry budget
        if auto_resume is None:
            auto_resume = os.environ.get("HPNN_JOB_AUTO_RESUME") == "1"
        self.auto_resume = bool(auto_resume)
        # bundle replication (a directory or a mesh router): each job's CheckpointManager
        # ships verified bundles there, auto-resume restores from it
        self.replicate_to = replicate_to \
            or os.environ.get("HPNN_REPLICATE_TO") or None
        self.lease_s = env_float("HPNN_JOB_LEASE_S", 60.0, lo=1.0)
        self.max_retries = env_int("HPNN_JOB_MAX_RETRIES", 3, lo=0)
        self.retry_backoff_s = env_float("HPNN_JOB_RETRY_BACKOFF_S",
                                         1.0, lo=0.0)
        self.auto_resumes_total = 0
        self.store = JobStore(job_dir)
        recovered = self.store.recover()
        if recovered:
            nn_out(f"jobs: recovered {len(recovered)} interrupted "
                   f"job(s) from {job_dir}: {', '.join(recovered)}\n")
        self.queue = JobQueue(capacity)
        self.preempt_wait_s = float(preempt_wait_s)
        # auto-resume schedule: job_id -> monotonic due time
        self._resume_due: dict[str, float] = {}
        self._resume_last_scan = 0.0
        self._mu = threading.Lock()
        # open chunked uploads: job_id -> {"writer", "chunks", "deadline"}
        # (guarded by _mu; the on-disk marker alone decides whether a job
        # may train)
        self._uploads: dict[str, dict] = {}
        self.upload_chunks_total = 0
        self.upload_wait_s = env_float("HPNN_JOBS_UPLOAD_WAIT_S",
                                       120.0, lo=1.0)
        # each worker pins its job to a disjoint slice of the serve
        # process's devices; HPNN_DP_DEVICES bounds an undeclared job's
        # fair share (a declared dp_devices/tp_devices ask wins)
        self.workers = max(1, int(job_workers))
        if devices is None:
            devices = process_devices(app.registry.device)
        self.slices = SliceManager(devices, workers=self.workers)
        self._default_cap = env_device_cap("HPNN_DP_DEVICES",
                                           self.slices.n)
        # running jobs: job_id -> {"job", "stop", "cancel", "slice"}
        # (guarded by _mu); _pending_cancel latches cancels that land
        # between a worker's queue pop and its install
        self._running: dict[str, dict] = {}
        self._pending_cancel: set[str] = set()
        self._draining = False
        self._paused = False
        self._closed = False
        self._threads = [
            threading.Thread(target=self._loop, args=(i,),
                             name=f"hpnn-job-worker-{i}", daemon=True)
            for i in range(self.workers)]
        for t in self._threads:
            t.start()

    # --- submission ------------------------------------------------------
    def submit(self, kernel: str, params: dict,
               corpus_files: list[tuple[str, bytes]] | None = None,
               upload_incomplete: bool = False) -> JobState:
        """:meth:`admit`'s job alone."""
        return self.admit(kernel, params, corpus_files=corpus_files,
                          upload_incomplete=upload_incomplete)[0]

    def admit(self, kernel: str, params: dict,
              corpus_files: list[tuple[str, bytes]] | None = None,
              upload_incomplete: bool = False) -> tuple[JobState, dict]:
        """Validate, materialize the job dir (conf and uploaded corpus)
        and enqueue.  Returns the job and its record as admitted
        (``"status": "queued"``), taken before the queue submit: a worker
        may dequeue the job and mark it running before the caller renders
        its reply.  Raises :class:`JobError` (HTTP 400) on bad
        parameters, :class:`JobQueueFull` (429) when the queue is full.

        ``upload_incomplete`` (chunked uploads): the job enters the queue
        with its first chunk on disk and the marker that holds the runner
        until :meth:`upload_chunk` sees the last chunk; the marker is
        written before the queue submit, so a job scheduled at once never
        trains on a partial corpus."""
        model = self.app.registry.get(kernel)
        if model is None:
            raise JobError(f"unknown kernel '{kernel}'")
        if not isinstance(params, dict):
            raise JobError("params must be a JSON object")
        if self.queue.depth() >= self.queue.capacity:
            # reject before creating the job dir: a 429 leaves nothing
            raise JobQueueFull(
                f"job queue at {self.queue.depth()}/{self.queue.capacity}")
        clean = self._sanitize(model, params, corpus_files)
        job = self.store.create(kernel, clean)
        try:
            if corpus_files:
                cdir = os.path.join(job.path, JOB_CORPUS)
                os.makedirs(cdir, exist_ok=True)
                for name, data in corpus_files:
                    base = os.path.basename(name)
                    if not base or base.startswith("."):
                        raise JobError(f"bad corpus file name {name!r}")
                    with open(os.path.join(cdir, base), "wb") as fp:
                        fp.write(data)
                clean["samples"] = cdir
            if upload_incomplete:
                with open(os.path.join(job.path, JOB_UPLOAD_MARKER),
                          "w") as fp:
                    fp.write(f"{int(time.time())}\n")
            job.epochs = clean["epochs"]
            job.start_epoch = clean.get("start_epoch", 0)
            job.epoch = job.start_epoch
            job.resumed_from = clean.get("resumed_from")
            self._write_conf(job, model, clean)
            self.store.update(job)
            record = self.store.snapshot(job.job_id)
            self.queue.submit(job)
        except Exception:
            # the job never ran: a failed admission (429 racing the
            # pre-check, a bad upload name, a closed queue) leaves no
            # record or directory behind
            self.store.discard(job)
            raise
        nn_out(f"jobs: {job.job_id} queued for kernel '{kernel}' "
               f"({clean['epochs']} epoch(s), train={clean['train']})\n")
        return job, record

    # --- chunked upload --------------------------------------------------
    def submit_chunked(self, kernel: str, params: dict,
                       first_chunk: list[tuple[str, bytes]]) -> dict:
        """Admit a job on its first corpus chunk: it is queued at once
        (conf written, marker held), the chunk's rows enter an incremental
        pack build (``io.corpus.ChunkedPackWriter``), and later
        :meth:`upload_chunk` calls append the rest.  Returns the job's
        record as admitted (``"status": "queued"``), whatever a worker
        has done with the job since."""
        if not first_chunk:
            raise JobError("chunk 1 must carry at least one corpus file")
        model = self.app.registry.get(kernel)
        if model is None:
            raise JobError(f"unknown kernel '{kernel}'")
        job, record = self.admit(kernel, params, corpus_files=first_chunk,
                                 upload_incomplete=True)
        from ..io.corpus import ChunkedPackWriter

        writer = ChunkedPackWriter(os.path.join(job.path, JOB_CORPUS),
                                   model.n_inputs, model.n_outputs)
        writer.add_sample_files(
            [os.path.basename(n) for n, _ in first_chunk])
        with self._mu:
            self._uploads[job.job_id] = {
                "writer": writer, "chunks": 1,
                "deadline": time.monotonic() + self.upload_wait_s}
            self.upload_chunks_total += 1
        return record

    def upload_chunk(self, job_id: str,
                     corpus_files: list[tuple[str, bytes]],
                     final: bool) -> dict:
        """Append one corpus chunk to a job admitted by
        :meth:`submit_chunked`.  The final chunk (which may be empty: a
        bare close) assembles the pack and releases the runner's hold."""
        with self._mu:
            sess = self._uploads.get(job_id)
        if sess is None:
            job = self.store.get(job_id)
            if job is None:
                raise JobError(f"unknown job '{job_id}'")
            raise JobError(f"job '{job_id}' has no open chunked upload")
        job = self.store.get(job_id)
        if job is None or job.status in TERMINAL_STATES:
            self._drop_upload(job_id, aborted=True)
            raise JobError(f"job '{job_id}' is no longer accepting "
                           "corpus chunks")
        cdir = os.path.join(job.path, JOB_CORPUS)
        names = []
        for name, data in corpus_files:
            base = os.path.basename(name)
            if not base or base.startswith("."):
                raise JobError(f"bad corpus file name {name!r}")
            path = os.path.join(cdir, base)
            if os.path.exists(path):
                raise JobError(f"duplicate corpus file {base!r}")
            with open(path, "wb") as fp:
                fp.write(data)
            names.append(base)
        if names:
            sess["writer"].add_sample_files(names)
        with self._mu:
            sess["chunks"] += 1
            self.upload_chunks_total += 1
            chunks = sess["chunks"]
        if final:
            # the pack before the hold is released: the runner's load
            # then replays it instead of reading every file (a refused
            # pack still trains from the files)
            sess["writer"].finalize()
            self._drop_upload(job_id, aborted=False)
            with contextlib.suppress(OSError):
                os.unlink(os.path.join(job.path, JOB_UPLOAD_MARKER))
        return {"job": job_id, "chunks": chunks,
                "complete": bool(final)}

    def _drop_upload(self, job_id: str, aborted: bool) -> None:
        with self._mu:
            sess = self._uploads.pop(job_id, None)
        if sess is not None and aborted:
            sess["writer"].abort()

    def _await_upload(self, job: JobState,
                      stop: threading.Event) -> bool:
        """Hold the runner until the job's upload completes (the marker
        disappears).  False, with the terminal status recorded, when the
        hold ends in a stop or times out."""
        marker = os.path.join(job.path, JOB_UPLOAD_MARKER)
        if not os.path.exists(marker):
            return True
        with self._mu:
            sess = self._uploads.get(job.job_id)
        deadline = (sess["deadline"] if sess is not None
                    else time.monotonic() + self.upload_wait_s)
        self.store.update(job, status="running", started=time.time(),
                          lease_expires=(time.time()
                                         + self.upload_wait_s
                                         + self.lease_s))
        while os.path.exists(marker):
            if stop.is_set():
                self._drop_upload(job.job_id, aborted=True)
                status = ("cancelled" if self._is_cancelled(job.job_id)
                          else "interrupted")
                self.store.update(job, status=status,
                                  error="stopped during corpus upload",
                                  finished=time.time(),
                                  lease_expires=0.0)
                nn_out(f"jobs: {job.job_id} {status} during corpus "
                       "upload\n")
                return False
            if time.monotonic() > deadline:
                self._drop_upload(job.job_id, aborted=True)
                self.store.update(
                    job, status="failed",
                    error=f"corpus upload incomplete after "
                          f"{self.upload_wait_s:.0f}s",
                    finished=time.time(), lease_expires=0.0)
                nn_out(f"jobs: {job.job_id} failed: corpus upload "
                       f"incomplete after {self.upload_wait_s:.0f}s\n")
                return False
            time.sleep(0.05)
        return True

    def _sanitize(self, model, params: dict, corpus_files) -> dict:
        clean: dict = {}
        clean["epochs"] = _as_int(params, "epochs", 1, floor=1)
        clean["ckpt_every"] = _as_int(params, "ckpt_every", 1)
        clean["ckpt_keep"] = _as_int(params, "ckpt_keep", 0)
        clean["seed"] = _as_int(params, "seed", 1)
        train = str(params.get("train") or model.nn.conf.train
                    or "BP").upper()
        if train not in _TRAINERS:
            raise JobError(f"'train' must be one of {_TRAINERS}: {train}")
        clean["train"] = train
        ktype = str(params.get("type") or model.kind).upper()
        if ktype not in _TYPES:
            raise JobError(f"'type' must be one of {_TYPES}: {ktype}")
        clean["type"] = ktype
        # the native linear head rides the job conf: inherited from the
        # served model unless overridden, so a job trains the head it
        # serves
        lnn = str(params.get("lnn")
                  or getattr(model.nn.conf, "lnn", None) or "").lower()
        if lnn and lnn != "native":
            raise JobError(f"'lnn' must be 'native': {lnn}")
        clean["lnn"] = lnn
        dtype = str(params.get("dtype") or model.dtype_name)
        if dtype not in _DTYPES:
            raise JobError(f"'dtype' must be one of {_DTYPES}: {dtype}")
        clean["dtype"] = dtype
        # the slice ask: dp_devices x tp_devices sizes it; model_parallel
        # also writes the conf's [model] line and batch its [batch] line
        for key in ("dp_devices", "tp_devices", "model_parallel",
                    "batch"):
            v = _as_int(params, key, 0)
            if v:
                clean[key] = v
        hidden = params.get("hidden", list(model.topology[1:-1]))
        if isinstance(hidden, int):
            hidden = [hidden]
        try:
            hidden = [int(h) for h in hidden]
        except (TypeError, ValueError):
            raise JobError(f"'hidden' must be int(s): {hidden!r}")
        if not hidden or any(h < 1 for h in hidden):
            raise JobError(f"'hidden' layers must be >= 1: {hidden}")
        clean["hidden"] = hidden
        tests = params.get("test_samples")
        if tests:
            # held-out eval corpus for --auto-promote: a server-side dir
            tests = os.path.abspath(str(tests))
            if not os.path.isdir(tests):
                raise JobError(
                    f"'test_samples' is not a directory: {tests}")
            clean["test_samples"] = tests
        resume_id = params.get("resume_job")
        if resume_id:
            prev = self.store.get(str(resume_id))
            if prev is None:
                raise JobError(f"unknown resume_job '{resume_id}'")
            if not prev.resumable:
                raise JobError(
                    f"job '{resume_id}' is not resumable "
                    f"(status {prev.status})")
            clean["resumed_from"] = prev.job_id
            # continue the prior job's checkpoint history (one run, one
            # manifest) and, by default, its corpus and goal
            clean["ckpt_dir"] = prev.ckpt_dir
            clean["start_epoch"] = prev.epoch
            clean.setdefault("samples", prev.params.get("samples"))
            if "epochs" not in params:
                clean["epochs"] = max(prev.epochs, prev.epoch)
            # an equal-size slice (not necessarily the same devices)
            for key in ("dp_devices", "tp_devices", "model_parallel",
                        "batch"):
                if key not in clean and prev.params.get(key):
                    clean[key] = int(prev.params[key])
        if corpus_files:
            if params.get("samples"):
                raise JobError(
                    "pass a server-side 'samples' path OR upload corpus "
                    "files, not both")
        else:
            # an explicit path overrides a resumed job's inherited corpus
            samples = params.get("samples") or clean.get("samples")
            if not samples:
                raise JobError("missing 'samples' (server-side corpus "
                               "path) or a multipart corpus upload")
            samples = os.path.abspath(str(samples))
            if not os.path.isdir(samples):
                raise JobError(f"'samples' is not a directory: {samples}")
            clean["samples"] = samples
        return clean

    def _write_conf(self, job: JobState, model, clean: dict) -> None:
        """The generated train_nn conf, in the grammar the offline CLI
        parses: ``train_nn`` on this file reproduces the job."""
        lines = [
            f"[name] {job.kernel}",
            f"[type] {clean['type']}",
            "[init] generate",
            f"[seed] {clean['seed']}",
            f"[input] {model.n_inputs}",
            "[hidden] " + " ".join(str(h) for h in clean["hidden"]),
            f"[output] {model.n_outputs}",
            f"[train] {clean['train']}",
            f"[dtype] {clean['dtype']}",
            f"[sample_dir] {clean['samples']}",
        ]
        if clean.get("batch"):
            lines.append(f"[batch] {clean['batch']}")
        if clean.get("model_parallel"):
            lines.append(f"[model] {clean['model_parallel']}")
        if clean["train"] == "CG":
            # [train] CG alone warns and falls through like the reference;
            # the keyword engages the batched CG trainer
            lines.insert(lines.index(f"[train] {clean['train']}") + 1,
                         "[trainer] cg")
        if clean.get("lnn"):
            lines.insert(lines.index(f"[type] {clean['type']}") + 1,
                         f"[lnn] {clean['lnn']}")
        with open(job.conf_path, "w") as fp:
            fp.write("\n".join(lines) + "\n")

    # --- workers ----------------------------------------------------------
    def _is_cancelled(self, job_id: str) -> bool:
        with self._mu:
            run = self._running.get(job_id)
            return bool(run is not None and run["cancel"])

    def _reclaim_tick(self) -> None:
        """Free any slice whose owner is no longer an installed running
        job (the backstop behind the workers' inline releases)."""
        def live(job_id: str) -> bool:
            with self._mu:
                return job_id in self._running
        for job_id in self.slices.reclaim(live):
            nn_warn(f"jobs: reclaimed leaked device slice of "
                    f"{job_id}\n")
            nn_log.nn_event("job_slice_reclaimed", job=job_id)

    def _loop(self, widx: int = 0) -> None:
        while not self._closed:
            if widx == 0:
                # housekeeping rides worker 0's poll: one tick bounds the
                # reclaim and auto-resume latency
                try:
                    self._reclaim_tick()
                    if self.auto_resume:
                        self._auto_resume_tick()
                except Exception as exc:  # noqa: BLE001 -- recovery
                    # machinery must never kill the worker
                    nn_warn(f"jobs: housekeeping tick error (loop "
                            f"continues): {type(exc).__name__}: "
                            f"{exc}\n")
            job = self.queue.take(timeout_s=0.1)
            if job is None:
                continue
            if self._paused:
                # pause() may land while this thread waits in take():
                # hand the job back untouched
                self.queue.requeue_front(job)
                time.sleep(0.02)
                continue
            with self._mu:
                if self._closed or self._draining:
                    # going down: the queued job never ran, leave it
                    # resumable instead of dropping it
                    self._pending_cancel.discard(job.job_id)
                    self.store.update(job, status="interrupted",
                                      error="server shutdown before run",
                                      finished=time.time())
                    continue
                run = {"job": job, "stop": threading.Event(),
                       "cancel": False, "slice": None}
                self._running[job.job_id] = run
                if job.job_id in self._pending_cancel:
                    # a cancel latched between the queue and this install
                    self._pending_cancel.discard(job.job_id)
                    run["cancel"] = True
                    run["stop"].set()
            try:
                self._place_and_run(job, run)
            except Exception as exc:  # noqa: BLE001 -- one broken job
                # must not kill the scheduler
                nn_warn(f"jobs: {job.job_id} failed: {exc}\n")
                self.store.update(job, status="failed",
                                  error=f"{type(exc).__name__}: {exc}",
                                  finished=time.time())
            finally:
                self.slices.release(job.job_id)
                with self._mu:
                    self._running.pop(job.job_id, None)
                    # a cancel that raced completion leaves a stale latch
                    self._pending_cancel.discard(job.job_id)

    def _place_and_run(self, job: JobState, run: dict) -> None:
        """Acquire the job's slice (blocking, FIFO: the job stays
        ``queued`` while it waits), record the placement, run."""
        size, tp = plan_request(job.params, self.slices.n)
        if size <= 0:
            size = min(self.slices.default_share(), self._default_cap)
        placed = None
        if not run["stop"].is_set():
            placed = self.slices.acquire(job.job_id, size, tp=tp,
                                         stop=run["stop"])
        if placed is None:
            # stopped (cancel/drain) while waiting, or the manager closed:
            # the job never trained
            status = ("cancelled" if run["cancel"] else "interrupted")
            self.store.update(job, status=status,
                              error="stopped before slice grant",
                              finished=time.time(), lease_expires=0.0)
            nn_out(f"jobs: {job.job_id} {status} before slice grant\n")
            return
        run["slice"] = placed
        self.store.update(job, slice=placed.describe())
        nn_log.nn_event("job_slice_granted", job=job.job_id,
                        **placed.describe())
        self._run_job(job, run["stop"], placed.devices)

    # --- lease-based auto-resume ------------------------------------------
    def _auto_resume_tick(self) -> None:
        """One recovery scan (throttled, on worker 0 between queue
        polls): expired-lease actives are recovered to ``interrupted``,
        interrupted jobs are scheduled for re-queue under the retry
        budget, and due schedules fire."""
        now = time.monotonic()
        if now - self._resume_last_scan < 0.25:
            return
        self._resume_last_scan = now
        if self._draining or self._closed or self._paused:
            return
        lease_now = time.time()  # leases are persisted wall clock
        with self._mu:
            running = set(self._running)
        candidates = self.store.scan_recovery()
        if not candidates:
            self._resume_due.clear()
            return
        for job in candidates:
            job_id = job.job_id
            if job_id in running:
                continue
            if (job.status in ("running", "snapshotting")
                    and job.lease_expires
                    and lease_now > job.lease_expires):
                # an active record nobody drives: its owner died
                nn_warn(f"jobs: {job_id} lease expired "
                        f"{lease_now - job.lease_expires:.1f}s ago; "
                        "recovering to interrupted\n")
                self.store.update(job, status="interrupted",
                                  error="lease expired")
                nn_log.nn_event("job_lease_expired", job=job_id,
                                kernel=job.kernel)
            if job.status != "interrupted":
                self._resume_due.pop(job_id, None)
                continue
            if job.job_id in self._resume_due:
                if now >= self._resume_due[job_id]:
                    self._resume_due.pop(job_id, None)
                    self._try_auto_resume(job)
                continue
            if job.retries >= self.max_retries:
                self.store.update(
                    job, status="failed",
                    error=f"auto-resume retry budget exhausted "
                          f"({job.retries}/{self.max_retries})",
                    finished=time.time())
                nn_log.nn_event("job_auto_resume_failed", job=job_id,
                                kernel=job.kernel, retries=job.retries)
                nn_warn(f"jobs: {job_id} failed: auto-resume retry "
                        f"budget exhausted "
                        f"({job.retries}/{self.max_retries})\n")
                continue
            delay = (self.retry_backoff_s * (2.0 ** job.retries)
                     * (0.5 + random.random()))
            self._resume_due[job_id] = now + delay

    def _newest_intact_bundle(self, ckpt_dir: str):
        """(bundle path, epoch) of the newest verified bundle, without
        loading its arrays (``train_job``'s resume loads them once)."""
        import json

        from ..ckpt import candidate_bundles, verify_bundle

        for bundle in candidate_bundles(ckpt_dir):
            ok, reason = verify_bundle(bundle)
            if not ok:
                nn_log.nn_event("ckpt_fallback", bundle=bundle,
                                reason=reason)
                continue
            try:
                with open(os.path.join(bundle, "snapshot.json")) as fp:
                    meta = json.load(fp)
                return bundle, int(meta.get("epoch", 0))
            except (OSError, ValueError, UnicodeDecodeError):
                continue
        return None, 0

    def _try_auto_resume(self, job: JobState) -> None:
        """Re-queue one interrupted job from its newest verified bundle:
        the local checkpoint dir first, the replica directory when nothing
        local is intact.  A job with no intact bundle anywhere restarts
        from scratch (the trajectory is deterministic, so the final kernel
        is the same bytes either way)."""
        ckpt_dir = job.ckpt_dir
        bundle, epoch = (None, 0)
        if os.path.isdir(ckpt_dir):
            bundle, epoch = self._newest_intact_bundle(ckpt_dir)
        if bundle is None and self.replicate_to:
            from ..ckpt.replicate import resolve_scope, restore_bundle

            with nn_log.capture():  # restore warnings belong to the
                # event stream, not the serve console
                restored = restore_bundle(
                    self.replicate_to, resolve_scope(ckpt_dir), ckpt_dir,
                    auth_token=self.app.auth_token)
            if restored is not None:
                bundle, epoch = self._newest_intact_bundle(ckpt_dir)
        resume_from = ckpt_dir if bundle is not None else None
        self.store.update(job, status="queued", retries=job.retries + 1,
                          epoch=epoch, auto_resume_from=resume_from,
                          error=None, lease_expires=0.0)
        try:
            self.queue.submit(job)
        except JobQueueFull:
            # the queue is busy: try again on a later scan without
            # burning retry budget (nothing was attempted)
            self.store.update(job, status="interrupted",
                              retries=job.retries - 1,
                              error="auto-resume deferred (queue full)")
            return
        self.auto_resumes_total += 1
        nn_log.nn_event("job_auto_resume", job=job.job_id,
                        kernel=job.kernel, retry=job.retries,
                        from_epoch=epoch,
                        verified_bundle=os.path.basename(bundle)
                        if bundle else None)
        nn_out(f"jobs: {job.job_id} auto-resumed (attempt "
               f"{job.retries}/{self.max_retries}) from "
               f"{'epoch %d' % epoch if bundle else 'scratch'}\n")

    def _run_job(self, job: JobState, stop: threading.Event,
                 devices=None) -> None:
        # one trace a job, keyed by the job id: every epoch span,
        # snapshot write and hot swap on this worker thread nests under
        # it -- `GET /v1/debug/trace?trace=job:<id>` is the job's tree
        with obs_trace.span("jobs.run", trace_id=f"job:{job.job_id}",
                            job=job.job_id, kernel=job.kernel,
                            epochs=job.epochs):
            self._run_job_traced(job, stop, devices)

    def _run_job_traced(self, job: JobState, stop: threading.Event,
                        devices=None) -> None:
        from ..api import train_job

        # chunked upload in flight: hold training until the last chunk
        # lands (bounded by HPNN_JOBS_UPLOAD_WAIT_S)
        if not self._await_upload(job, stop):
            return
        model = self.app.registry.get(job.kernel)
        if self.auto_promote and model is not None:
            # pin the pre-job serving generation now: per-epoch swaps bump
            # and prune generations, and "promote if better" means better
            # than what served before this job.  (The JAX package touches
            # its lazily uploaded device weights here first; the port's
            # holder exists from registration, so retention always has
            # the outgoing weights to keep.)
            self.store.update(job, baseline_generation=model.generation)
        self.store.update(job, status="running", started=time.time(),
                          lease_expires=time.time() + self.lease_s)
        ckpt_dir = job.ckpt_dir
        watch_state = {"gen": 0}
        resume = job.auto_resume_from \
            or ((job.resumed_from and ckpt_dir) or None)

        def on_epoch(epoch: int, manager) -> None:
            due = (manager is not None and manager.every
                   and epoch % manager.every == 0) or epoch >= job.epochs
            errors = list(manager.errors) if manager is not None else []
            # the epoch boundary is the lease heartbeat
            lease = time.time() + self.lease_s
            if due and manager is not None:
                # the async bundle write must be durable before the
                # registry swaps it in
                self.store.update(job, status="snapshotting",
                                  epoch=epoch, errors=errors,
                                  lease_expires=lease)
                manager.flush()
                self._reload_into_serving(job, ckpt_dir, watch_state)
                self.store.update(job, status="running")
            else:
                self.store.update(job, epoch=epoch, errors=errors,
                                  lease_expires=lease)
            self._yield_to_eval(stop)

        entries: list = []
        with nn_log.capture(entries):
            result = train_job(
                job.conf_path, epochs=job.epochs, ckpt_dir=ckpt_dir,
                ckpt_every=job.params.get("ckpt_every", 1),
                ckpt_keep=job.params.get("ckpt_keep", 0),
                kernel_out=job.kernel_out, resume=resume,
                stop=stop, on_epoch=on_epoch,
                replicate_to=self.replicate_to,
                auth_token=self.app.auth_token, devices=devices)
        self._write_console(job, entries)
        # record_final bumped the manifest generation: swap the finished
        # kernel in (the last bundle's weights; the bump keeps an outside
        # --watch-ckpt watcher coherent with this one)
        self._reload_into_serving(job, ckpt_dir, watch_state)
        if not result["ok"]:
            status, error = "failed", result["error"]
        elif result["interrupted"]:
            status = ("cancelled" if self._is_cancelled(job.job_id)
                      else "interrupted")
            error = None
        else:
            status, error = "done", None
        self.store.update(job, status=status, error=error,
                          epoch=result["epoch"],
                          errors=list(result["errors"]),
                          finished=time.time(), lease_expires=0.0)
        nn_out(f"jobs: {job.job_id} {status} at epoch "
               f"{result['epoch']}/{job.epochs}\n")
        if status == "done" and self.auto_promote:
            try:
                self._auto_promote(job)
            except Exception as exc:  # noqa: BLE001 -- a broken eval
                # must not re-fail a done job (the operator endpoints
                # still work)
                nn_warn(f"jobs: {job.job_id} auto-promote failed: "
                        f"{type(exc).__name__}: {exc}\n")
                self.store.update(job, auto_promote={
                    "action": "skipped",
                    "reason": f"{type(exc).__name__}: {exc}"})

    # --- eval-driven auto-promotion ---------------------------------------
    def _skip_promote(self, job: JobState, reason: str) -> None:
        nn_out(f"jobs: {job.job_id} auto-promote skipped: {reason}\n")
        self.store.update(job, auto_promote={"action": "skipped",
                                             "reason": reason})

    def _eval_generation(self, kernel: str, xs, ts, gen: int,
                         objective: str = "accuracy"):
        """Test error of one pinned generation over the test rows, through
        the serving path (pinned batcher submits, counted in the A/B
        generation counters like any request).  ``objective`` is
        'accuracy' (argmax classification error, the ANN/SNN default) or
        'mse' (the regression objective of a native LNN).  Returns
        (error, generations that served, requests)."""
        import numpy as np

        b = self.app.batchers.get(kernel)
        if b is None:
            raise JobError(f"kernel '{kernel}' has no batcher")
        wrong = requests = 0
        sq_sum = 0.0
        served_all: set[int] = set()
        for i in range(0, xs.shape[0], b.max_batch):
            chunk = np.asarray(xs[i:i + b.max_batch], dtype=np.float64)
            outs, served = b.submit(chunk, 30.0, gen=gen,
                                    return_gen=True)
            served = int(served if served is not None else gen)
            served_all.add(served)
            self.app.metrics.count_generation(kernel, served)
            if objective == "mse":
                d = (np.asarray(outs, np.float64)
                     - np.asarray(ts[i:i + chunk.shape[0]], np.float64))
                sq_sum += float(np.sum(d * d))
            else:
                want = np.argmax(ts[i:i + chunk.shape[0]], axis=1)
                wrong += int(np.sum(np.argmax(outs, axis=1) != want))
            requests += 1
        if objective == "mse":
            err = sq_sum / float(xs.shape[0] * ts.shape[1])
        else:
            err = wrong / float(xs.shape[0])
        return err, served_all, requests

    def _auto_promote(self, job: JobState) -> None:
        """Promote if better: evaluate the finished job's candidate
        generation against the pre-job baseline on a held-out test dir
        (the job's ``test_samples``, else the serving conf's
        ``[test_dir]``) and finalize -- promote on no regression, roll
        back on regression.  The decision record (both errors, the
        generations, the A/B counters as canary evidence) lands in the job
        record and an ``auto_promote`` event."""
        from ..io import corpus as corpus_io
        from ..io.samples import list_sample_dir
        from ..models.kernel import is_regression

        model = self.app.registry.get(job.kernel)
        if model is None:
            return self._skip_promote(job, "kernel no longer registered")
        if not job.generations:
            return self._skip_promote(job, "job landed no generation")
        table = model.generation_table()
        candidate = table["current"]
        ab = table["ab_window"]
        job_gens = set(int(g) for g in job.generations)
        # baseline: the generation serving at job start while retained;
        # else the A/B window's prev; else the newest retained pre-job
        # generation.  A job whose per-epoch swaps pruned every pre-job
        # generation skips (submit with ckpt_every=0 for a clean
        # before/after comparison)
        baseline = None
        if (job.baseline_generation is not None
                and job.baseline_generation in table["retained"]):
            baseline = int(job.baseline_generation)
        elif ab and ab.get("prev") is not None:
            baseline = int(ab["prev"])
        else:
            prior = [g for g in table["retained"] if g not in job_gens]
            if prior:
                baseline = max(prior)
        if baseline is None:
            return self._skip_promote(
                job, "no retained pre-job baseline generation "
                "(submit with ckpt_every=0, or raise gen_keep)")
        test_dir = job.params.get("test_samples") or model.nn.conf.tests
        if not test_dir or not os.path.isdir(str(test_dir)):
            return self._skip_promote(
                job, "no test dir (pass 'test_samples' in the submit "
                "or a [test_dir] in the serving conf)")
        test_dir = str(test_dir)
        names = list_sample_dir(test_dir)
        if not names:
            return self._skip_promote(job,
                                      f"test dir {test_dir} is empty")
        with obs_trace.span("jobs.auto_promote", job=job.job_id,
                            kernel=job.kernel, candidate=candidate,
                            baseline=baseline):
            return self._promote_on_eval(job, model, test_dir, names,
                                         candidate, baseline)

    def _promote_on_eval(self, job: JobState, model, test_dir: str,
                         names: list, candidate: int,
                         baseline: int) -> None:
        """The eval and the decision of :meth:`_auto_promote`."""
        from ..io import corpus as corpus_io
        from ..models.kernel import is_regression

        _events, xs, ts = corpus_io.load_ordered(
            test_dir, names, list(range(len(names))), "TESTING",
            model.n_inputs, model.n_outputs)
        if xs is None or xs.shape[0] == 0:
            return self._skip_promote(
                job, f"no loadable test rows under {test_dir}")
        # a linear head (native LNN) is judged by MSE: a constant output
        # would ace argmax accuracy on 1-wide targets
        objective = "mse" if is_regression(model.kind) else "accuracy"
        base_err, base_served, base_req = self._eval_generation(
            job.kernel, xs, ts, baseline, objective=objective)
        if base_served != {baseline}:
            # the baseline was pruned between the table read and the eval
            # (weights_for fell back): no decision against wrong weights
            return self._skip_promote(
                job, f"baseline generation {baseline} no longer "
                f"servable (got {sorted(base_served)})")
        cand_err, _cand_served, cand_req = self._eval_generation(
            job.kernel, xs, ts, candidate, objective=objective)
        canary = self.app.metrics.generation_requests(job.kernel)
        record = {
            "objective": objective,
            "test_dir": test_dir,
            "test_rows": int(xs.shape[0]),
            "candidate": candidate,
            "baseline": baseline,
            "candidate_err": round(cand_err, 6),
            "baseline_err": round(base_err, 6),
            "eval_requests": base_req + cand_req,
            # the A/B generation counters are the canary evidence: how
            # much traffic each generation served (canary fraction, pins
            # and this eval)
            "canary_requests": {
                str(candidate): canary.get(str(candidate), 0),
                str(baseline): canary.get(str(baseline), 0)},
        }
        if cand_err <= base_err:
            model.promote()
            record["action"] = action = "auto_promoted"
        else:
            model.rollback(gen=baseline)
            # a rollback is a weights swap: the lifecycle metrics follow,
            # as for the operator endpoint
            self.app.metrics.count_reload(True)
            self.app.metrics.set_model_info(
                model.name, model.generation, model.loaded_at)
            record["action"] = action = "auto_rolled_back"
        self.store.update(job, finalized=action, auto_promote=record)
        nn_log.nn_event("auto_promote", job=job.job_id,
                        kernel=job.kernel, **record)
        nn_out(f"jobs: {job.job_id} {action}: candidate gen "
               f"{candidate} err {cand_err:.4f} vs baseline gen "
               f"{baseline} err {base_err:.4f} "
               f"({xs.shape[0]} test rows)\n")

    def _reload_into_serving(self, job: JobState, ckpt_dir: str,
                             watch_state: dict) -> None:
        result = self.app.poll_ckpt_reload(job.kernel, ckpt_dir,
                                           watch_state)
        if result is not None:
            self.store.update(job, generations=job.generations
                              + [int(result["generation"])])

    def _yield_to_eval(self, stop: threading.Event) -> None:
        """The preemption gate: while eval traffic is queued, the next
        epoch waits (at most ``preempt_wait_s``).  Training resumes only
        after the queues stay drained for a short quiesce window, so a
        momentary zero between a saturated client's drain and its next
        arrivals does not let an epoch barge in.  The wait is a span
        (``jobs.yield_to_eval``): device contention shows in the job's
        trace as time spent here."""
        with obs_trace.span("jobs.yield_to_eval"):
            deadline = time.monotonic() + self.preempt_wait_s
            quiet = 0
            while not stop.is_set() and time.monotonic() < deadline:
                depths = [b.depth() for b in self.app.batchers.values()]
                if any(depths):
                    quiet = 0
                elif (quiet := quiet + 1) >= YIELD_QUIESCE_TICKS:
                    return
                time.sleep(0.001)

    def _write_console(self, job: JobState, entries: list) -> None:
        try:
            with open(os.path.join(job.path, JOB_CONSOLE), "w") as fp:
                for level, text in entries:
                    fp.write(_LOG_PREFIX.get(level, "") + text)
        except OSError:
            pass  # the log is a convenience, never a failure

    # --- control ----------------------------------------------------------
    def get(self, job_id: str) -> dict | None:
        return self.store.snapshot(job_id)

    def list(self) -> list[dict]:
        return self.store.list()

    def active(self) -> dict:
        """The running jobs (the first id and its trace id, which a mesh
        worker's heartbeat advertises so ``?trace=job:<id>`` on the router
        finds the right worker's spans) and the queued count;
        ``running_jobs`` lists the whole pool."""
        with self._mu:
            ids = sorted(self._running)
        cur = ids[0] if ids else None
        return {"running": cur,
                "trace": f"job:{cur}" if cur else None,
                "running_jobs": ids,
                "queued": self.queue.depth()}

    def running_count(self) -> int:
        with self._mu:
            return len(self._running)

    def cancel(self, job_id: str) -> dict:
        """Cancel a queued job at once, or latch the running job's stop
        event (the in-flight epoch finishes, a final snapshot is written,
        the job lands ``cancelled``, resumable)."""
        job = self.store.get(job_id)
        if job is None:
            raise KeyError(job_id)
        if self.queue.remove(job_id):
            self.store.update(job, status="cancelled",
                              error="cancelled while queued",
                              finished=time.time())
            return self.store.snapshot(job_id)
        with self._mu:
            run = self._running.get(job_id)
            if run is not None:
                run["cancel"] = True
                run["stop"].set()
                return self.store.snapshot(job_id)
            if job.status not in TERMINAL_STATES:
                # a worker popped the job but has not installed it yet (or
                # pause() is cycling it): latch, honoured at install
                self._pending_cancel.add(job_id)
                return self.store.snapshot(job_id)
        raise JobError(f"job '{job_id}' already {job.status}")

    def finalize(self, job_id: str, how: str) -> None:
        job = self.store.get(job_id)
        if job is not None:
            self.store.update(job, finalized=how)

    def pause(self) -> None:
        """Hold the workers between jobs (the queue keeps admitting)."""
        self._paused = True

    def resume(self) -> None:
        self._paused = False

    def drain(self, timeout_s: float = 120.0) -> None:
        """Graceful shutdown: stop admitting, latch every running job's
        stop event (the in-flight epoch finishes, a final snapshot, the
        job ``interrupted``), park queued jobs interrupted and
        resumable."""
        with self._mu:
            self._draining = True
            for run in self._running.values():
                run["stop"].set()
            open_uploads = list(self._uploads)
        for job_id in open_uploads:
            # open uploads die with the server: the chunks are swept, the
            # marker stays, so a recovered job fails its bounded wait
            # instead of training on part of its corpus
            self._drop_upload(job_id, aborted=True)
        self.queue.close()
        self._closed = True
        self.slices.close()
        deadline = time.monotonic() + timeout_s
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        if any(t.is_alive() for t in self._threads):
            nn_warn("jobs: scheduler did not drain in time\n")
        while True:
            job = self.queue.take(timeout_s=0.0)
            if job is None:
                break
            self.store.update(job, status="interrupted",
                              error="server shutdown before run",
                              finished=time.time())

    # --- observability ----------------------------------------------------
    def metrics_snapshot(self) -> dict:
        with self._mu:
            ids = sorted(self._running)
        running_jobs = []
        for job_id in ids:
            snap = self.store.snapshot(job_id) or {}
            errs = snap.get("errors") or []
            running_jobs.append({
                "job": job_id,
                "kernel": snap.get("kernel"),
                "epoch": snap.get("epoch", 0),
                "epochs": snap.get("epochs", 0),
                "mean_err": errs[-1] if errs else None,
                "slice": snap.get("slice"),
            })
        occ = self.slices.occupancy()
        return {
            "queue_depth": self.queue.depth(),
            # "running" keeps its single-job shape (the first of the
            # pool); "running_jobs" is the pool
            "running": running_jobs[0] if running_jobs else None,
            "running_jobs": running_jobs,
            "workers": self.workers,
            "slices_active": occ["slices_active"],
            "slice_devices_in_use": occ["devices_in_use"],
            "slice_devices_total": occ["devices_total"],
            "queued_placements": occ["queued_placements"],
            "by_status": self.store.by_status(),
            "trained_epochs_total": self.store.trained_epochs(),
            "auto_resumes_total": self.auto_resumes_total,
            "upload_chunks_total": self.upload_chunks_total,
        }
