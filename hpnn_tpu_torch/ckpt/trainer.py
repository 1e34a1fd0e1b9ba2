"""Multi-epoch training driver, with checkpointing off.

The reference trains in 1+N *rounds*: each round is a fresh process that
reloads ``kernel.opt`` and re-seeds the shuffle
(``tutorials/mnist/tutorial.bash:125-197``).  ``train_nn --epochs N`` runs
the same per-sample convergence epochs in one process: the seeded glibc
shuffle stream continues across them (one ``srandom`` at the start, each
epoch's shuffle consuming the next draws), so the whole N-epoch trajectory
is a pure function of (conf, corpus, seed), and the epochs go through the
device-resident pipeline (``api._EpochPipeline``) when the corpus allows.

SIGTERM and SIGINT do not kill the run mid-epoch: the handler latches a
stop flag, the in-flight epoch finishes, and the run ends with what it has
trained (``kernel.opt``).  ``HPNN_CKPT_KILL_AT_EPOCH=k`` drives that path
at a deterministic epoch boundary (the tests use it).
"""

from __future__ import annotations

import os
import signal
import threading
import time

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


def train_loop(nn, epochs: int, device="cuda") -> tuple[bool, bool]:
    """Run epochs 1..``epochs`` of :func:`api.train_kernel` on ``device``;
    returns ``(trained_ok, interrupted)``.

    The shuffle stream starts from ``conf.seed`` (seed 0 -> time(), written
    back: the reference's ``srandom`` semantics, libhpnn.c:1218) and
    continues across epochs.  The ``EPOCH %8d/%8d`` banner prints only when
    ``epochs > 1``, so a single epoch keeps the reference's stream.

    When the epochs go through the device-resident pipeline, this loop
    drives its join points: epoch k's lines are rendered while epoch k+1
    runs, and the queue drains in byte order (lines, banners, the
    interruption message) at the final epoch, at an interrupt and at the
    kill hook -- where the float64 host weights are needed anyway."""
    from ..api import pipeline_defer_out, pipeline_join, train_kernel

    conf = nn.conf
    if nn.shuffle_rng is None:
        if conf.seed == 0:
            conf.seed = int(time.time())
        nn.shuffle_rng = GlibcRandom(conf.seed)
    kill_at = env_int("HPNN_CKPT_KILL_AT_EPOCH", 0)
    banner = epochs > 1
    stop = threading.Event()
    prev_handlers = _install_handlers(stop)
    interrupted = False
    nn._pipeline_defer = True  # train_kernel leaves the joins to this loop
    try:
        for epoch in range(1, epochs + 1):
            if banner:
                text = f"EPOCH {epoch:8d}/{epochs:8d}\n"
                if not pipeline_defer_out(nn, text):
                    nn_out(text)
            if not train_kernel(nn, device=device):
                pipeline_join(nn)
                return False, False
            if epoch == epochs or stop.is_set() or epoch == kill_at:
                pipeline_join(nn)
            if kill_at and epoch == kill_at and epoch < epochs:
                # the real signal path at a deterministic boundary
                os.kill(os.getpid(), signal.SIGTERM)
            if stop.is_set() and epoch < epochs:
                interrupted = True
                pipeline_join(nn)  # a signal may land after the check above
                nn_out(f"CKPT: interrupted at epoch {epoch}/{epochs} "
                       "(checkpointing off; partial state only in "
                       "kernel.opt)\n")
                break
    finally:
        pipeline_join(nn)  # no pending line or weight outlives the run
        nn._pipeline_defer = False
        _restore_handlers(prev_handlers)
    return True, interrupted
