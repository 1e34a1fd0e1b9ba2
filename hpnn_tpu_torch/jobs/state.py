"""Persistent job state for the online training service (the port of
``hpnn_tpu/jobs/state.py``; the records and the directory layout are the
JAX package's, so either package's server reads the other's history).

One directory per job under the server's ``--job-dir``:

    <job-dir>/
        job-000001/
            job.json        the job record (atomic io.atomic writes)
            nn.conf         the generated training conf (train_nn format)
            corpus/         uploaded sample files (absent when the submit
                            named a server-side path)
            ckpt/           the job's checkpoint directory (bundles and
                            manifest: what hot reload reads and what
                            --resume semantics continue from)
            kernel.opt      the final trained kernel (the bytes an offline
                            ``train_nn`` of nn.conf writes)
            console.log     the captured training console stream

Every ``job.json`` write goes through the tmp+fsync+rename writer
(``io/atomic.py``), so a crashed server never leaves a half-written record
and a restarted server reports the whole history: jobs active at the crash
are recovered to ``interrupted``, resumable from their last snapshot.

Job lifecycle::

    queued -> running <-> snapshotting -> done
                       \\-> failed | cancelled | interrupted
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time

from ..io.atomic import atomic_write_text

JOB_STATES = ("queued", "running", "snapshotting", "done", "failed",
              "cancelled", "interrupted")
# states a crashed server recovers to "interrupted" on restart
ACTIVE_STATES = ("queued", "running", "snapshotting")
TERMINAL_STATES = ("done", "failed", "cancelled", "interrupted")

JOB_JSON = "job.json"
JOB_CONF = "nn.conf"
JOB_CORPUS = "corpus"
JOB_CKPT = "ckpt"
JOB_KERNEL = "kernel.opt"
JOB_CONSOLE = "console.log"


class JobError(Exception):
    """Invalid job submission or an action in a conflicting state."""


@dataclasses.dataclass
class JobState:
    """One training job's record (serialized verbatim to job.json)."""

    job_id: str
    kernel: str                      # target registry kernel name
    params: dict                     # sanitized submit parameters
    path: str                        # the job's directory
    status: str = "queued"
    epochs: int = 1                  # the run's goal
    start_epoch: int = 0             # >0 when resuming a prior job
    epoch: int = 0                   # last epoch the trainer completed
    errors: list = dataclasses.field(default_factory=list)
    generations: list = dataclasses.field(default_factory=list)
    error: str | None = None         # failure diagnostic
    finalized: str | None = None     # "promoted" | "rolled_back", or
    #                                  "auto_promoted"/"auto_rolled_back"
    auto_promote: dict | None = None  # the eval-driven decision record
    baseline_generation: int | None = None  # serving generation at job
    #                                  start (auto-promote's baseline)
    resumed_from: str | None = None  # prior job id (resume submits)
    # lease-based auto-resume: a running job's lease is refreshed at every
    # epoch boundary (HPNN_JOB_LEASE_S); an active record whose lease
    # expired has a dead owner and is recovered to interrupted, and
    # interrupted jobs are re-queued from their newest verified bundle
    # under a bounded retry budget (HPNN_JOB_MAX_RETRIES)
    lease_expires: float = 0.0       # wall clock (persisted timestamp)
    retries: int = 0                 # auto-resume attempts so far
    auto_resume_from: str | None = None  # ckpt dir to resume from
    # the device slice the scheduler granted: {"devices", "dp", "tp",
    # "size"}; the last grant stays part of the job's history
    slice: dict | None = None
    created: float = 0.0
    started: float = 0.0
    finished: float = 0.0

    @property
    def conf_path(self) -> str:
        return os.path.join(self.path, JOB_CONF)

    @property
    def ckpt_dir(self) -> str:
        # a resumed job continues the PRIOR job's checkpoint history (one
        # run, one manifest: train_nn --resume PATH), recorded in params
        return self.params.get("ckpt_dir") or os.path.join(self.path,
                                                           JOB_CKPT)

    @property
    def kernel_out(self) -> str:
        return os.path.join(self.path, JOB_KERNEL)

    @property
    def resumable(self) -> bool:
        """An interrupted/cancelled job with at least one snapshot can
        continue through a ``resume_job`` submit (--resume semantics)."""
        return (self.status in ("interrupted", "cancelled")
                and os.path.isfile(os.path.join(self.ckpt_dir,
                                                "manifest.json")))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["resumable"] = self.resumable
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "JobState":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def _record_transition(job_id: str, kernel: str, prev: str,
                       status: str, epoch: int) -> None:
    """One job lifecycle transition as a zero-duration recorder span
    (``?trace=job:<id>`` and the timeline both see it); never raises into
    the store's write path."""
    try:
        from ..obs import trace as obs_trace

        if not obs_trace.enabled():
            return
        now = time.monotonic()
        obs_trace.record("job.state", now, now,
                         trace_id=f"job:{job_id}", parent_id=None,
                         job=job_id, kernel=kernel, status=status,
                         previous=prev, epoch=epoch)
    except Exception:
        pass


class JobStore:
    """Directory-backed job index: create/load/update, crash recovery.

    One lock serializes every record mutation and snapshot read, so HTTP
    threads see a consistent record while a worker updates it; the writes
    are atomic on disk, so an outside reader of job.json sees the old or
    the new record whole.  A status change also lands in the flight
    recorder as a zero-duration ``job.state`` span under the job's trace
    id (``job:<id>``), the incident timeline's jobs feed.
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._mu = threading.RLock()
        self._jobs: dict[str, JobState] = {}
        self._next = 1
        self._load_existing()

    # --- persistence ----------------------------------------------------
    def _load_existing(self) -> None:
        for name in sorted(os.listdir(self.root)):
            jpath = os.path.join(self.root, name, JOB_JSON)
            if not os.path.isfile(jpath):
                continue
            try:
                with open(jpath) as fp:
                    job = JobState.from_dict(json.load(fp))
            except (OSError, json.JSONDecodeError, TypeError):
                continue  # a half-created job dir is not fatal
            job.path = os.path.join(self.root, name)  # survive dir moves
            self._jobs[job.job_id] = job
            try:
                self._next = max(self._next,
                                 int(name.split("-")[-1]) + 1)
            except ValueError:
                pass

    def recover(self) -> list[str]:
        """Mark jobs that were active when the previous server died as
        ``interrupted`` (their last snapshot makes them resumable);
        returns the recovered ids."""
        recovered = []
        with self._mu:
            for job in self._jobs.values():
                if job.status in ACTIVE_STATES:
                    job.status = "interrupted"
                    job.error = "server restarted mid-job"
                    self._save_locked(job)
                    recovered.append(job.job_id)
        return recovered

    def _save_locked(self, job: JobState) -> None:
        atomic_write_text(os.path.join(job.path, JOB_JSON),
                          json.dumps(job.to_dict(), indent=1) + "\n")

    # --- API ------------------------------------------------------------
    def create(self, kernel: str, params: dict) -> JobState:
        with self._mu:
            job_id = f"job-{self._next:06d}"
            self._next += 1
            path = os.path.join(self.root, job_id)
            os.makedirs(path, exist_ok=True)
            job = JobState(job_id=job_id, kernel=kernel, params=params,
                           path=path, created=time.time())
            self._jobs[job_id] = job
            self._save_locked(job)
        # the birth transition: the timeline's first jobs entry
        _record_transition(job_id, kernel, "", "queued", 0)
        return job

    def discard(self, job: JobState) -> None:
        """Remove a job that never ran (admission failed mid-submit): a
        rejected submit leaves no record or directory behind."""
        with self._mu:
            self._jobs.pop(job.job_id, None)
            shutil.rmtree(job.path, ignore_errors=True)

    def update(self, job: JobState, **fields) -> None:
        """Mutate and persist under the store lock (the workers' only
        write path; HTTP readers snapshot under the same lock).  A status
        change is recorded as a ``job.state`` span outside the lock."""
        with self._mu:
            prev = job.status
            for k, v in fields.items():
                setattr(job, k, v)
            self._save_locked(job)
            status = job.status
            epoch = job.epoch
        if status != prev:
            _record_transition(job.job_id, job.kernel, prev, status, epoch)

    def get(self, job_id: str) -> JobState | None:
        with self._mu:
            return self._jobs.get(job_id)

    def snapshot(self, job_id: str) -> dict | None:
        with self._mu:
            job = self._jobs.get(job_id)
            return None if job is None else job.to_dict()

    def list(self) -> list[dict]:
        with self._mu:
            return [self._jobs[j].to_dict() for j in sorted(self._jobs)]

    def scan_recovery(self) -> list[JobState]:
        """The records the auto-resume tick cares about (active or
        interrupted), as live objects in id order: the idle tick must not
        pay a per-job ``to_dict`` under the lock the training thread
        needs."""
        with self._mu:
            return [self._jobs[j] for j in sorted(self._jobs)
                    if self._jobs[j].status in ("running",
                                                "snapshotting",
                                                "interrupted")]

    def trained_epochs(self) -> int:
        """Cumulative epochs trained across all jobs, from in-memory
        fields only (a /metrics scrape must not stat every manifest)."""
        with self._mu:
            return sum(max(0, j.epoch - j.start_epoch)
                       for j in self._jobs.values())

    def by_status(self) -> dict[str, int]:
        with self._mu:
            counts: dict[str, int] = {}
            for job in self._jobs.values():
                counts[job.status] = counts.get(job.status, 0) + 1
            return counts
