"""Multi-epoch training driver with resumable, crash-safe state.

The reference trains in 1+N *rounds*: each round is a fresh process that
reloads ``kernel.opt`` and re-seeds the shuffle
(``tutorials/mnist/tutorial.bash:125-197``).  ``train_nn --epochs N`` runs
the same per-sample convergence epochs in one process: the seeded glibc
shuffle stream continues across them (one ``srandom`` at the start, each
epoch's shuffle consuming the next draws), so the whole N-epoch trajectory
is a pure function of (conf, corpus, seed), and the epochs go through the
device-resident pipeline (``api._EpochPipeline``) when the corpus allows.

That determinism is what makes checkpoint/resume bit-exact: a bundle
written at the epoch-k boundary (float64 weights, BPM momentum, the RNG
words, the epoch counter; ``ckpt.snapshot``) fully determines epochs
k+1..N, so a run resumed with ``--resume`` replays the identical console
stream and lands on a byte-identical ``kernel.opt``.

SIGTERM and SIGINT do not kill the run mid-epoch: the handler latches a
stop flag, the in-flight epoch finishes, a final synchronous snapshot is
written (with checkpointing on) and the run ends cleanly.
``HPNN_CKPT_KILL_AT_EPOCH=k`` drives that path at a deterministic epoch
boundary (the tests use it).
"""

from __future__ import annotations

import os
import signal
import threading
import time

from ..parallel import coord
from ..utils.env import env_int
from ..utils.glibc_random import GlibcRandom
from ..utils.nn_log import nn_out


def _install_handlers(stop: threading.Event):
    """Latch ``stop`` on SIGTERM/SIGINT; returns the previous handlers.
    Only the main thread may install: elsewhere signals keep their default
    behavior."""
    if threading.current_thread() is not threading.main_thread():
        return None

    def handler(signum, frame):
        stop.set()

    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig, handler)
        except (ValueError, OSError):
            pass
    return prev


def _restore_handlers(prev) -> None:
    for sig, old in (prev or {}).items():
        try:
            signal.signal(sig, old)
        except (ValueError, OSError):
            pass


def train_loop(nn, epochs: int, manager=None, start_epoch: int = 0,
               rng_state: list[int] | None = None,
               stop: threading.Event | None = None, on_epoch=None,
               device="cuda") -> tuple[bool, bool]:
    """Run epochs ``start_epoch+1 .. epochs`` of :func:`api.train_kernel`
    on ``device``; returns ``(trained_ok, interrupted)``.

    ``manager`` (a :class:`ckpt.manager.CheckpointManager`, or None for
    checkpointing off) takes every epoch's mean final error in epoch
    order and writes the due bundles.  ``rng_state`` (from a snapshot)
    restores the shuffle stream; otherwise it starts from ``conf.seed``
    (seed 0 -> time(), written back: the reference's ``srandom``
    semantics, libhpnn.c:1218).  ``stop`` is an external stop event a
    caller shares (a cancel latches it as a SIGTERM would); without one
    the loop owns an event wired to the signal handlers.
    ``on_epoch(epoch, manager)`` is called on the training thread at every
    epoch boundary, after the epoch's checkpoint bookkeeping and before
    the interruption checks.  The ``EPOCH %8d/%8d`` banner prints only
    when ``epochs > 1`` or the run resumed, so a single epoch keeps the
    reference's stream.

    When the epochs go through the device-resident pipeline, this loop
    drives its join points: epoch k's lines are rendered while epoch k+1
    runs, and the queue drains in byte order (lines, banners, CKPT
    messages) at a due snapshot, at the final epoch, at a latched signal
    and at the kill hook -- where the float64 host weights are needed
    anyway.  The drained epochs' summaries reach the manager in epoch
    order, so the manifest equals the unpipelined run's."""
    from ..api import (pipeline_active, pipeline_defer_out, pipeline_join,
                       train_kernel)
    from ..obs import trace as obs_trace

    conf = nn.conf
    if rng_state is not None:
        nn.shuffle_rng = GlibcRandom.from_state(rng_state)
    elif nn.shuffle_rng is None:
        if conf.seed == 0:
            conf.seed = int(time.time())
        nn.shuffle_rng = GlibcRandom(conf.seed)
    kill_at = env_int("HPNN_CKPT_KILL_AT_EPOCH", 0)
    world = coord.world_size()
    banner = epochs > 1 or start_epoch > 0
    if stop is None:
        stop = threading.Event()
    prev_handlers = _install_handlers(stop)
    interrupted = False
    last_epoch = start_epoch
    pending: list[int] = []   # epochs whose summaries the manager lacks

    def drain() -> None:
        """Join the pipeline's deferred epochs in order: console bytes,
        host weights, then the manager's trajectory and due saves."""
        sums = pipeline_join(nn)
        for ep, summary in zip(pending, sums):
            if manager is not None:
                manager.epoch_done(nn, ep, summary.get("mean_final")
                                   if summary else None)
        del pending[:]

    nn._pipeline_defer = True  # train_kernel leaves the joins to this loop
    try:
        for epoch in range(start_epoch + 1, epochs + 1):
            last_epoch = epoch
            # the epoch's span root: train_kernel's phases, the deferred
            # stats drain, the snapshot write and the jobs scheduler's
            # epoch callback (hot swap, eval yield) nest under it through
            # the thread-local span stack -- a no-op when tracing is off
            with obs_trace.span("train.epoch", epoch=epoch, epochs=epochs):
                if banner:
                    text = f"EPOCH {epoch:8d}/{epochs:8d}\n"
                    if not pipeline_defer_out(nn, text):
                        nn_out(text)
                if not train_kernel(nn, device=device):
                    drain()
                    return False, False
                # coordinated stop: a signal caught by one rank latches the
                # stop on every rank at this boundary, so no rank runs ahead
                # into the next epoch's collectives alone
                stopping = stop.is_set()
                if world > 1:
                    stopping = coord.any_flag(stopping)
                    if stopping:
                        stop.set()
                if pipeline_active(nn):
                    pending.append(epoch)
                    # join only where the unpipelined loop needs the host
                    # state: a due snapshot, the final epoch, a latched
                    # signal, or the kill hook about to fire
                    due = (manager is not None and manager.every
                           and epoch % manager.every == 0)
                    if (due or epoch == epochs or stopping
                            or (kill_at and epoch == kill_at)):
                        drain()
                elif manager is not None:
                    stats = nn.last_epoch_stats
                    manager.epoch_done(nn, epoch, stats.get("mean_final")
                                       if stats else None)
                if on_epoch is not None:
                    on_epoch(epoch, manager)
            if kill_at and epoch == kill_at and epoch < epochs:
                # the real signal path at a deterministic boundary
                os.kill(os.getpid(), signal.SIGTERM)
            if (stopping if world > 1 else stop.is_set()) \
                    and epoch < epochs:
                interrupted = True
                # the stop's own span (the port's; the JAX package has
                # none): its join, final snapshot and message
                with obs_trace.span("train.stop", epoch=epoch):
                    drain()  # a signal may land after the join check
                    # above: the final snapshot must see synced weights
                    if manager is not None:
                        # final snapshot, synchronous: the process is about
                        # to exit, nothing may stay queued
                        if manager.last_saved_epoch != epoch:
                            manager.save(nn, epoch, sync=True)
                        manager.flush()
                        nn_out(f"CKPT: interrupted at epoch {epoch}/{epochs}"
                               "; state saved -- continue with train_nn "
                               "--resume\n")
                    else:
                        nn_out(f"CKPT: interrupted at epoch {epoch}/{epochs} "
                               "(checkpointing off; partial state only in "
                               "kernel.opt)\n")
                break
        if (not interrupted and manager is not None
                and last_epoch > start_epoch
                and manager.last_saved_epoch != last_epoch):
            # clean completion off the --ckpt-every grid (every=0
            # included): the final epoch always gets a bundle, so the
            # manifest's latest kernel is the finished model
            manager.save(nn, last_epoch)
    finally:
        drain()  # no pending line or weight outlives the run
        nn._pipeline_defer = False
        _restore_handlers(prev_handlers)
        if manager is not None:
            manager.flush()
    return True, interrupted
