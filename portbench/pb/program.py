"""The system under test, driven as ``train_nn --epochs N`` drives it:
``api.configure`` on the conf, the epoch pipeline (``api._EpochPipeline``:
the corpus resident on the card, one launch an epoch) and
``ckpt.trainer.train_loop`` over ``api.train_kernel``.

Set-up builds one trainer (the conf's kernel and the pipeline) and drives
it through three steps on rows of its own (``step``: the pipeline's own
epoch call, gather and launch, on a given order), whose lines and weights
the reference follows; the same object then trains the window.  The
benchmark takes from the program only its lines, its weights after the
steps and at the window's last epoch boundaries, its counters and its
spans."""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

EPOCH_CAP = 1_000_000


@contextlib.contextmanager
def stdout_to(path: str):
    """The program's console lines into ``path`` (appended)."""
    old = sys.stdout
    with open(path, "a") as f:
        sys.stdout = f
        try:
            yield
        finally:
            sys.stdout = old


class Program:
    def __init__(self, conf_path: str, device, verbosity: int):
        import torch
        from hpnn_tpu_torch import api
        from hpnn_tpu_torch.utils import nn_log

        self.torch, self.api = torch, api
        self.device = torch.device(device)
        nn_log.set_verbosity(verbosity)
        self.nn = api.configure(conf_path)
        if self.nn is None:
            raise RuntimeError(f"the program refused the conf {conf_path}")
        conf = self.nn.conf
        self.kind = api.kernel_kind(conf)
        self.momentum = conf.train == "BPM"
        self.pipe = None

    def build_pipeline(self) -> None:
        """The resident corpus (the pack, or the files on a first run) and
        its upload; the shuffle stream from the conf's seed."""
        from hpnn_tpu_torch.utils.glibc_random import GlibcRandom

        nn = self.nn
        nn.shuffle_rng = GlibcRandom(nn.conf.seed)
        self.pipe = self.api._pipeline_for(nn, nn.conf, self.device)
        if self.pipe is None:
            raise RuntimeError("the corpus did not go resident: the epoch "
                               "pipeline refused it")

    def weights(self) -> list:
        return [w.copy() for w in self.nn.kernel.weights]

    def step(self, order: list[int]) -> list:
        """One epoch of the pipeline on listing rows ``order``: its lines
        are printed, its weights joined; returns them (float64)."""
        events, sel = self.pipe.rc.epoch_events(order)
        self.pipe.run_epoch(self.nn, events, sel, self.kind, self.momentum)
        self.api.pipeline_join(self.nn)
        return self.weights()

    def warm_gather(self) -> None:
        """The window's on-card gather at its full size, once."""
        torch = self.torch
        n = self.pipe.rc.n_rows
        perm = torch.arange(n, dtype=torch.int32).to(self.device)
        xs = self.pipe.x_dev.index_select(0, perm)
        ts = self.pipe.t_dev.index_select(0, perm)
        del xs, ts
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def window(self, seconds: float, keep: int) -> dict:
        """Whole epochs through ``train_loop`` until ``seconds`` have
        passed: at each epoch's boundary (the next epoch already queued)
        the loop waits for the previous epoch's end and stops when the
        one in flight is due to end past the deadline.  Returns the
        window's wall seconds and the program's weights (device tensors)
        at its last ``keep`` epoch boundaries: key e before window epoch
        e (0-based), e + 1 after it."""
        from hpnn_tpu_torch.ckpt.trainer import train_loop

        torch, cuda = self.torch, self.device.type == "cuda"
        stop = threading.Event()
        carry = {0: tuple(self.pipe.weights)}
        ends: list[float] = []
        marks: list = []

        def on_epoch(epoch, manager):
            carry[epoch] = tuple(self.pipe.weights)
            carry.pop(epoch - keep, None)
            if cuda:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(self.device))
                marks.append(ev)
                if len(marks) < 2:
                    return
                marks[-2].synchronize()
                del marks[:-2]
            ends.append(time.perf_counter())
            prev = ends[-2] if len(ends) > 1 else t0
            if ends[-1] + (ends[-1] - prev) >= t0 + seconds:
                stop.set()

        t0 = time.perf_counter()
        ok, _ = train_loop(self.nn, EPOCH_CAP, stop=stop, on_epoch=on_epoch,
                           device=self.device)
        self.sync()
        wall = time.perf_counter() - t0
        if not ok:
            raise RuntimeError("train_loop reported a failed epoch")
        return {"window_s": wall, "boundaries": carry}

    def counters(self) -> dict:
        from hpnn_tpu_torch.ops import convergence_kernel as b1

        return {"b1_launches": b1.train_epoch_kernel.launches}

    def epoch_metrics(self) -> dict:
        return dict(self.api.EPOCH_METRICS)

    def reset_metrics(self) -> None:
        self.api.reset_epoch_metrics()

    def last_load(self) -> dict:
        from hpnn_tpu_torch.io import corpus

        return dict(corpus.LAST_LOAD)

    def close(self) -> None:
        """Drop the program's state on the device."""
        self.pipe = None
        self.nn = None
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


def corpus_cache_env(cache_dir: str) -> None:
    """The program's corpus packs in a fixed directory inside the
    checkout, set before the program is imported."""
    packs = os.path.join(cache_dir, "packs")
    os.makedirs(packs, exist_ok=True)
    os.environ["HPNN_CORPUS_CACHE"] = packs
