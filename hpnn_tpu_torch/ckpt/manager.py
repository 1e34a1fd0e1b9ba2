"""CheckpointManager: epoch-boundary snapshots off the critical path.

The port's copy of the JAX package's ``ckpt/manager.py``.  The training
loop hands the manager a *captured* copy of the state at each epoch
boundary (the weight list -- the epoch pipeline's join replaces it with
new float64 numpy arrays, never mutates it in place -- a copy of the RNG
words and the error trajectory) and keeps running; the bundle is
formatted and fsync'd on the shared ``io.corpus.io_pool`` executor.  The
writer thread touches numpy arrays only, never a torch tensor or a CUDA
stream.  Writes are CHAINED through done-callbacks (a queued snapshot is
submitted only when its predecessor finishes), so bundles and manifest
generations land in epoch order on at most one pool thread.

Console discipline: the manager prints its one ``CKPT: snapshot ...``
line synchronously on the training thread; the writer is silenced
(``nn_log.capture``) so a background completion can never interleave
with the per-sample training stream, whose bytes a resumed run must
reproduce.

Failures are never dropped: the first writer exception is re-raised from
:meth:`flush` (the CLI flushes before declaring the run done).

A multi-process run (``HPNN_DISTRIBUTED``) writes one bundle a snapshot:
every rank meets ``coord.snapshot_barrier`` on the training thread (the
ranks prove they bundle the same epoch), then rank 0 alone writes, and the
bundle records the world size that agreed on it.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from ..io.conf import NN_TRAIN_BPM
from ..obs import trace as obs_trace
from ..parallel import coord
from ..utils import nn_log
from ..utils.nn_log import nn_out
from . import snapshot as snap


class CheckpointManager:
    def __init__(self, ckpt_dir: str, every: int = 1, keep_last: int = 0,
                 target_epochs: int = 0, replicate_to: str | None = None,
                 auth_token: str | None = None):
        self.ckpt_dir = ckpt_dir
        self.every = max(0, int(every))
        self.keep_last = max(0, int(keep_last))
        # the run's --epochs goal, recorded in every bundle so a bare
        # --resume knows how far the interrupted run meant to go
        self.target_epochs = max(0, int(target_epochs))
        # replication: each VERIFIED bundle is shipped to --replicate-to
        # on its own io_pool future, outside the snapshot chain flush()
        # joins (a slow destination never stalls an epoch boundary);
        # pending ships are joined at record_final, where a failure warns
        self.replicator = None
        self._rep_futures: list = []
        if replicate_to:
            from .replicate import Replicator

            self.replicator = Replicator(replicate_to, ckpt_dir,
                                         auth_token=auth_token)
        self.errors: list[float | None] = []
        self.last_saved_epoch = 0
        self._future = None
        self._lock = threading.Lock()

    # --- trajectory -------------------------------------------------------
    def seed_errors(self, errors) -> None:
        """Carry the restored trajectory across a resume so the manifest
        keeps the WHOLE run's error curve."""
        self.errors = list(errors)

    # --- capture ----------------------------------------------------------
    def _capture(self, nn, epoch: int) -> dict:
        conf = nn.conf
        kernel = nn.kernel
        momentum = kernel.momentum
        if momentum is None and conf.train == NN_TRAIN_BPM:
            # the reference zeroes the dw buffers at every sample entry
            # (ann_raz_momentum, ann.c:2391) and frees them at epoch end,
            # so the canonical BPM momentum state AT an epoch boundary is
            # all-zeros -- that is what the bundle records
            momentum = [np.zeros_like(w) for w in kernel.weights]
        return {
            "weights": list(kernel.weights),  # replaced per epoch
            "momentum": None if momentum is None
            else [np.array(m, dtype=np.float64) for m in momentum],
            "rng_state": (nn.shuffle_rng.get_state()
                          if nn.shuffle_rng is not None else None),
            "seed": int(conf.seed),
            "epoch": int(epoch),
            "errors": list(self.errors),
            "name": kernel.name,
            "train": conf.train,
            "dtype": conf.dtype,
            "target_epochs": self.target_epochs,
            # native-trainer carry, copied: the next epoch may mutate it
            "trainer_state": ({k: np.array(v) for k, v in
                               nn.trainer_state.items()}
                              if getattr(nn, "trainer_state", None)
                              else None),
            # the world size that agreed on this bundle behind the barrier
            "world_size": coord.world_size(),
        }

    # --- saving -----------------------------------------------------------
    def epoch_done(self, nn, epoch: int, mean_err: float | None) -> None:
        self.errors.append(None if mean_err is None else float(mean_err))
        if self.every and epoch % self.every == 0:
            self.save(nn, epoch)

    def save(self, nn, epoch: int, sync: bool = False) -> None:
        if coord.world_size() > 1:
            # the coherent global step: the barrier runs here, on the
            # training thread (never on the writer: a pool-thread
            # collective would race the next epoch's), then rank 0 alone
            # writes the bundle
            if not coord.snapshot_barrier(epoch):
                raise OSError(
                    f"snapshot barrier failed at epoch {epoch}: ranks "
                    "disagree on the bundle epoch (no bundle written)")
            if coord.process_index() != 0:
                self.last_saved_epoch = int(epoch)
                return
        job = self._capture(nn, epoch)
        self.last_saved_epoch = int(epoch)
        # the one console line, emitted HERE (a fixed position in the
        # training stream); the tag alone, so streams stay comparable
        # across --ckpt-dir locations
        nn_out(f"CKPT: snapshot {snap.snapshot_tag(epoch)}\n")
        if sync:
            self.flush()
            with obs_trace.span("ckpt.snapshot_write", epoch=job["epoch"],
                                sync=True):
                self._write(job)
            return
        from concurrent.futures import Future

        from ..io.corpus import io_pool

        # the write runs on a pool thread, its span parented under the
        # caller's epoch span: the context is captured here, recorded there
        ctx = obs_trace.current_ctx()
        # bundles land in epoch order, but the chain never PARKS a pool
        # worker waiting on its predecessor: each job is submitted from
        # the previous future's done-callback, so at most ONE pool thread
        # writes at any time
        fut = Future()
        with self._lock:
            prev = self._future
            self._future = fut
        if prev is None:
            io_pool().submit(self._run_job, job, fut, None, ctx)
        else:
            prev.add_done_callback(
                lambda p: io_pool().submit(self._run_job, job, fut, p, ctx))

    def _run_job(self, job: dict, fut, prev, ctx=None) -> None:
        if prev is not None and prev.exception() is not None:
            fut.set_exception(prev.exception())  # first failure wins
            return
        try:
            t0 = time.monotonic()
            with nn_log.capture():  # the writer never prints
                self._write(job)
            if obs_trace.enabled():
                obs_trace.record(
                    "ckpt.snapshot_write", t0, time.monotonic(),
                    trace_id=ctx[0] if ctx else None,
                    parent_id=ctx[1] if ctx else None,
                    epoch=job["epoch"], sync=False)
        except Exception as exc:  # noqa: BLE001 -- surfaced at flush
            fut.set_exception(exc)
        else:
            fut.set_result(None)

    def _write(self, job: dict) -> None:
        entry = snap.write_snapshot(
            self.ckpt_dir, job["epoch"], weights=job["weights"],
            momentum=job["momentum"], rng_state=job["rng_state"],
            seed=job["seed"], errors=job["errors"], name=job["name"],
            train=job["train"], dtype=job["dtype"],
            target_epochs=job["target_epochs"],
            trainer_state=job.get("trainer_state"),
            world_size=job.get("world_size", 1))
        snap.publish_snapshot(self.ckpt_dir, entry, seed=job["seed"],
                              errors=job["errors"],
                              keep_last=self.keep_last)
        if self.replicator is not None:
            # only a bundle that passed its verified write ever ships; a
            # separate future, NOT this chain: flush() never waits on the
            # destination
            from ..io.corpus import io_pool

            with self._lock:
                self._rep_futures.append(io_pool().submit(
                    self._replicate_silent,
                    os.path.join(self.ckpt_dir, entry["tag"])))

    def _replicate_silent(self, bundle_dir: str) -> list:
        with nn_log.capture() as entries:  # pool thread: never prints
            self.replicator.replicate(bundle_dir)
        return entries

    def drain_replication(self) -> None:
        """Join every pending replica ship: called at run end so a
        finishing process does not cut its last bundles' replication
        short.  A failed ship's warning is emitted here, on the training
        thread, after the training stream."""
        with self._lock:
            futures, self._rep_futures = self._rep_futures, []
        for fut in futures:
            nn_log.replay(e for e in fut.result() if e[0] == "warn")

    def flush(self) -> None:
        """Block until every queued bundle is durably published;
        re-raises the first writer failure."""
        with self._lock:
            fut = self._future
            self._future = None
        if fut is not None:
            fut.result()

    def record_final(self, kernel_path: str) -> None:
        """After train_nn's final ``kernel.opt`` dump: flush pending
        bundles, stamp the manifest with the final kernel's path and
        fingerprint (run_nn's staleness guard), then join pending replica
        ships -- the run's end is the one place waiting on the
        destination is right."""
        self.flush()
        snap.record_final_kernel(self.ckpt_dir, kernel_path)
        self.drain_replication()
