#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hpnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Run from the root of a checkout.  It drives the port's main path on the
card at full width and fails (non-zero exit, no result line) on any
fault; no phase catches its own failure.

1. Device: the ``nvidia-smi`` name and power limit, torch's CUDA version.
2. Build: every hand-written kernel from ``hpnn_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together), with the build time and the
   compiler's register/spill report; fails when any entry of the tile
   kernel has a stack frame or spills (its design keeps nothing in local
   memory: a spill read after a grid barrier is an L2 round trip).
3. Each kernel against its plain torch version on the card, at the
   slice's shapes (784->300 with the activation, 300->10 without, 851->230
   and 230->230 with; B in {1, 3, 64, 512, 4096}; a ragged 13x37 at B=5)
   in float32, bfloat16 and float64, inputs from a seeded numpy generator
   in [-1, 1] and, for the MNIST input layer, at pixel scale [0, 255].
   Limits: float32 1e-5 ([-1, 1]) and 1e-4 (pixel scale), bfloat16 2e-2,
   float64 1e-12.
4. ``run_nn`` through the port's CLI on a seeded synthetic test dir in the
   reference's sample format: MNIST 784-300-10 ANN and SNN at float64,
   float32 and bfloat16, and XRD 851-230-230 ANN at float32, each with a
   kernel from ``generate_kernel(seed)`` dumped to a kernel file.  Each
   run must launch the kernel and match the plain path on the card within
   the limits of phase 3.
5. ``serve_nn`` on 127.0.0.1 (port 0, strict tier) with the MNIST ANN and
   SNN kernels at float32 and float64: requests of 1, 3 and 64 rows, then
   8 concurrent ones; every answer 200 and bit-identical to the rows run_nn
   computed (for SNN that covers the softmax after the kernel too).
6. Device times with CUDA events (median of 20 back-to-back runs of 10
   calls, host dispatch hidden behind a GPU spin) of the kernel, its plain
   version and ``torch.matmul`` + activation (the library yardstick the
   port never calls), beside the bound: the larger of the operations over
   the card's peak for the type and the bytes over 3.35 TB/s.
7. The training epoch kernel (``train_epoch``) against its plain torch
   version on the card at full width, on a seeded separable corpus (one
   bar per class): MNIST 784-300-10 ANN and SNN x BP and BPM x f64, f32 and
   bf16, XRD 851-230-230 ANN BPM at f64 and f32, native LNN 784-300-10 at
   f64, MNIST ANN BP f64 whose last output's target is 2^-30 below 1
   (in double not the target class; the exact 1 of class 0 or 1 is), and
   784-2304-10 ANN BP f64, more rows than the card holds warps at once (a
   plan must take several rows a warp); 2-8 samples a run (ANN and LNN samples from two classes: the first
   sample of each class is the one that takes thousands of iterations,
   and the plain loop pays a host round trip per iteration; SNN from four:
   past about five classes at pixel scale, float32's exp range runs out in
   the softmax without max-subtraction and a sample runs to MAX_ITER with
   NaN weights, in the plain loop as in the kernel).  Limits: f64
   identical n_iter/first_ok/success, init_err and final dEp within 1e-12,
   weights within 1e-10; f32 identical first_ok/success, |dn_iter| <=
   max(4, 2%), weights within 5e-3; bf16 the f32 limits (both versions
   round every operation to bf16; only the order of the float32 sums
   differs).  Each run also goes through the kernel's other launch plan
   (W_0's rows resident in shared memory, or in device memory), which must
   give the same bits, and its grid barriers, as the kernel counts them,
   must be 2L - 2 an iteration.  Before the runs, the first launch of each
   dtype and plan is timed against a second (the one-off cost of loading
   the kernels); after them, a 30000-10-10 f64 net, whose staged vectors
   do not fit in a block's shared memory, must be refused with ValueError.
8. The resume contract: the f64 MNIST ANN BP epoch as launches under an
   iteration budget of 100 equals one launch bit for bit, in more than one
   launch.
9. ``train_nn`` end to end (``cli.train_nn_main``, the MNIST tutorial conf
   at the default f64, 512 training files), then ``run_nn`` of the trained
   ``kernel.opt`` on 512 test files: at least 80% PASS.  The epoch is then
   run again through the kernel alone for its device time, and through
   ``train_tile`` at tile 1, whose weights and stats must be bit-identical
   to ``train_epoch``'s.
10. The batched-tile epoch kernel (``train_tile``) against its plain torch
   version on the card: MNIST 784-300-10 ANN (two classes) and SNN (four)
   x BP and BPM x f64, f32 and bf16 at tile 8 over two groups and a ragged
   tail (19 samples), XRD 851-230-230 ANN BPM at f64 and f32 at tile 4,
   native LNN at f64, the weight storage modes "bf16" and "f32" under
   f32, and 784-2304-10 ANN BP f64 at tile 8 (more rows than the card
   holds warps: a block owns 18 rows of W_0), with phase 7's limits
   (f32/bf16 weights relative to the largest weight, ``TRAIN_LIMIT``'s
   note).  Each run's grid barriers, as the kernel counts them, must be
   2L - 2 a lockstep iteration; the 784-2304-10 run also goes through three
   other launch plans (W_0's rows in place; the inputs in lane chunks
   with the head's vectors off chip; the block's scratch in its workspace
   slice), which must give the same bits.  Then 784-4096-10 ANN BP f64 at
   tile 512 (512 samples, 3 iterations at most), where the plan itself
   puts the block's scratch in the workspace, held to the plain version.
   Last, a 30000-10-10 f64 net, whose one lane's input does not fit in a
   block's shared memory, must be refused with ValueError.
11. Its three bitwise contracts: tile=1 equals the ``train_epoch`` kernel
   (weights and stats) for ANN and LNN at f64, f32 and bf16 and SNN at f32
   and bf16, BP and BPM; a ragged tail's masked lanes are inert (tile 4
   over 6 samples equals the first group, then the two tail rows alone at
   tile 2); launches of one group equal one launch.
12. ``train_nn --tile 32`` end to end on phase 9's files and conf, then
   ``run_nn`` of its ``kernel.opt``: at least 80% PASS, ``train_tile``
   launched and ``train_epoch`` not.  The epoch is then run again through
   the kernel alone, twice, for its device time (the first and the second
   launch): lockstep iterations (a group runs as long as its slowest
   lane), lane-iterations (the sum of n_iter), grid barriers a lockstep
   iteration as the kernel counts them (2L - 2), and the rate beside
   phase 9's per-sample kernel on the same files.  Last, ``--tile auto``'s
   autotuner at that width measures its candidates once, a second call is
   a cache hit, and the epoch on the same files at each of its candidate
   tiles (one launch each) shows whether its choice is the fastest epoch.
13. ``fused_bpm_update`` against its plain version, bit for bit, at the
   MNIST and XRD layers (300x784, 10x300, 230x851, 230x230) and at
   4096x4096 (past the 50 MB L2), f64 and f32: its warm time (back-to-back
   calls on the same buffers), its cold time (calls rotating over copies
   of the inputs that together span twice the L2), an empty kernel's
   launch-to-launch time in the same loop (the floor) and the byte bound.
14. Batch invariance of ``fused_linear_act`` (run right after phase 3):
   at each of phase 3's four layers and each dtype, one seeded B=4096
   call, and the same rows in calls of B = 1, 3, 64 and 512, from row 0
   and from an odd row, bit for bit.  Those calls cross every launch plan
   the wrapper picks (tile shapes, stages split or not), so they hold the
   fixed summation order the strict serving tier rests on.
16. ``train_nn --epochs 3`` (run right after phase 12) on phase 9's files
   and conf, per sample and at ``--tile 32``, through the device-resident
   epoch pipeline: ``train_epoch`` (or ``train_tile``) launched exactly 3
   times, ``EPOCH_METRICS.h2d_bytes`` 3 * 512 * 4 (one int32 permutation an
   epoch), the stream and kernel.opt byte-identical to the
   ``HPNN_NO_EPOCH_PIPELINE=1`` route on the card, each epoch's device time
   and the run's wall time, and ``run_nn`` of kernel.opt at 80% PASS or
   more.
17. ``train_nn --resume`` (run right after phase 16) on phase 9's files
   and conf, per sample and at ``--tile 32``: ``--epochs 3 --ckpt-every 1
   --ckpt-dir ck --replicate-to rep``; the same killed at epoch 1
   (``HPNN_CKPT_KILL_AT_EPOCH=1``) and resumed with ``--resume``; that
   ``ck`` deleted and resumed again with ``--replicate-to rep`` (epoch 1
   restored from the replica).  kernel.opt of every run byte-identical to
   phase 16's checkpointing-off run; each resumed stream from EPOCH 2 on
   byte-identical to the first run's, the killed stream its prefix; the
   epoch kernel launched 3 times in the first run and 1 + 2 across the
   kill and the resume (2 in the replica resume), the resident route in
   every run; every bundle passes ``verify_bundle``, the manifests'
   generations and the replica blobs counted; ``run_nn --ckpt-dir ck`` of
   the resumed kernel.opt (>= 80% PASS) warns of no fingerprint mismatch,
   and of one after a digit of kernel.opt is changed, naming both paths.
   The runs' wall times beside phase 16's and the bundles' bytes.
18. The corpus pipeline (run right after phase 17): the native sample
   loader must be on.  ``run_nn`` of a generated MNIST 784-300-10 ANN f64
   and XRD 851-230-230 ANN f32 kernel on a fresh 4096-file dir each, in
   three load modes: cache off, serial, Python parser
   (``HPNN_NO_CORPUS_CACHE=1 HPNN_NO_PARALLEL_IO=1 HPNN_NO_NATIVE_IO=1``);
   cold (parallel native reads, the pack built); warm (from the pack).
   The streams must be byte-identical, the outputs bit-identical, each
   run must launch ``fused_linear_act`` and report its load mode; each
   load's time, each run's wall time and the pack's bytes are printed.
   Then ``train_nn --epochs 3`` on phase 9's files and conf with the
   cache off and warm (the test dir's pack removed first, so the warm
   run's prefetch builds it during the epochs): streams and kernel.opt
   byte-identical, each epoch's device time both ways; then ``run_nn`` of
   kernel.opt must load the test dir from the prefetched pack.
19. ``serve_nn``, the rest (run right after phase 18): MNIST 784-300-10
   ANN f64 (phase 9's trained kernel) and XRD 851-230-230 ANN f32 served
   with ``-b 64 --ab-fraction 0.25 --watch-ckpt mnist=D --watch-interval
   0.2 --auth-token T --no-warmup``; 8 client threads send 1-, 3- and
   64-row requests while a ``train_nn --epochs 3 --ckpt-every 1
   --ckpt-keep 3 --ckpt-dir D`` subprocess trains on phase 9's files, so
   its snapshots hot-reload into serving.  Then: a retained generation
   pinned with ``X-HPNN-Generation`` answers with its own weights, an
   unknown pin is 404, a reload without the token 401, a reload of a bad
   path 409 while the old weights keep answering, low/normal/high
   requests queued behind a paused batcher dispatch high first, an
   expired ``X-HPNN-Deadline-Ms`` is 504 with no launch, and a reload to
   784-100-10 serves the new shape.  Every answer must be bit-identical to
   the strict forward of the weights its ``generation`` label names (the
   kernel file that generation loaded), and ``fused_linear_act`` must have
   launched 2 times a batch ``/metrics`` counts.  Prints ``/metrics``
   p50/p99 by phase, each swap's wall time and the requests a second.
21. ``[model]`` row sharding (run right after phase 20).  At world 1 on
   the card the model axis clamps to one shard: ``train_nn`` of phase 9's
   conf and files with ``[model] 2``, ``-S 2`` and ``--model-parallel 2``
   each prints the JAX package's clamp warning, launches ``train_epoch``
   once, and gives the unsharded run's stream (minus the warning) and
   kernel.opt byte for byte; ``--epochs 3`` with ``[model] 2`` reports the
   ``tp-resident`` pipeline, ``tp_devices`` 1, 3 launches and phase 16's
   kernel.opt; ``run_nn`` of phase 4's MNIST ANN f64 conf with ``[model]
   2`` warns, launches ``fused_linear_act`` twice and gives phase 4's
   outputs and verdict lines.  The tp@K serving tier on a LocalMesh of the
   card repeated 2 and 4 times (``HPNN_EPOCH_DEVICE_BUDGET_MB=0``), ring
   and all-gather schedules: MNIST ANN f64 and XRD 851-230-230 ANN f32 at
   buckets 1, 3 and 64 against the strict tier (1e-12 f64, 1e-5 f32), each
   shard's first-layer rows bit-identical to the full layer's, the
   ``fused_linear_act`` launches a batch and the device ms a batch beside
   the strict tier's.  Meanwhile 2 gloo CPU ranks train ``[model] 2`` per
   sample on the first 64 of phase 9's files (from the kernel the earlier
   phases trained on them) and 4 ranks ``[batch] 32`` x
   ``[model] 2`` for 2 epochs on the 512, held to the card's one process
   (the lines equal; kernel.opt within 1e-12 per sample, 1e-11 on the
   grid).
22. The jobs service (run right after phase 21): ``serve_nn -b 64
   --ab-fraction 0.25 --jobs 2 --auto-promote`` (an in-process
   ``ServeApp``) serves a generated MNIST ANN f64 784-300-10 kernel to 8
   closed-loop clients of 1 and 64 rows.  Job A, a JSON submit of the
   tutorial conf (BP, f64, seed 10958) on phase 9's 512 files with its 512
   test files held out, 3 epochs, a snapshot each: ``done``, exactly 3
   ``train_epoch`` launches, at least 3 swaps, kernel.opt byte-identical to
   the port's offline ``train_nn --epochs 3 --ckpt-every 1`` of its
   generated conf, and its auto-promote decision printed with its eval
   requests.  Job B, 64 of those files uploaded in 4 chunks, 2 epochs: its
   pack equal to a ``ChunkedPackWriter`` of the same chunks.  Job C, job
   A's submit again, cancelled after its first epoch and resumed with
   ``resume_job`` to epoch 3: kernel.opt byte-identical to job A's.  A
   second server on the job dir reports the four jobs.  No reply other
   than 200, every answer bit-identical to the strict forward of the
   kernel file its generation loaded, and ``fused_linear_act`` launched 2
   times a batch.  Prints job A's epochs' device time beside phase 16's,
   the yield gate's wait an epoch, each swap's wall time, the 1-row client
   p50/p99 with no job and during job A, the launches, each job's submit
   to done and the phase's seconds.
15. One JSON line of every kernel (launches on its main path, the largest
   kernel-vs-plain error over every cell and dtype, times and bound;
   ``fused_linear_act`` adds its B=1 cell and its worst ratio to the
   library call over phase 6's cells; ``train_epoch`` its grid barriers an
   iteration as its kernel counted them, its launch plan and shared bytes
   a block at phase 9's widths, and its first and second launch;
   ``train_tile`` the same for phase 12's epoch, the autotuner's tile and
   the epoch's time at each candidate tile, its build's stack frame and
   the wide run's workspace plan; both their launches and epoch times in
   phase 16 and their launches and wall times in phase 17
   (``ckpt_launches``, ``ckpt_wall_s``), and phase 18's epoch times
   (``corpus_epochs_device_ms``); ``fused_linear_act`` phase 18's
   launches (``corpus_launches``); both their launches in phase 22
   (``jobs_launches``) and job A's epoch times
   (``jobs_epochs_device_ms``); ``fused_bpm_update`` its warm, cold and
   floor times; ``train_epoch`` and ``fused_linear_act`` their launches on
   phase 21's paths, ``tp_launches``), then the result line.

Main paths: ``fused_linear_act``'s is phases 4-5, ``train_epoch``'s phase 9
and ``train_tile``'s phase 12 (train_nn, then run_nn of its kernel, which
launches ``fused_linear_act`` too), phase 16's two ``--epochs`` runs,
phase 17's checkpointed, killed and resumed runs, phase 18's runs and
phase 19's server (``serve_rest_launches``), phase 21's TP routes
(``tp_launches``) and phase 22's server and jobs (``jobs_launches``);
every count is set to 0 just before a path and read
just after it.  ``fused_bpm_update`` has no caller on any
path, as in the JAX package: its ``launches`` are the paths' (0), its
``phase_launches`` phase 13's.  ``--json PATH`` also writes every cell's
numbers to PATH.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK = {"f32": 67e12, "f64": 67e12, "bf16": 989e12}   # H100 SXM, dense
HBM_BYTES_PER_S = 3.35e12
LIMIT = {"f32": 1e-5, "f32-pixel": 1e-4, "bf16": 2e-2, "f64": 1e-12}
BATCHES = (1, 3, 64, 512, 4096)
TIMED_BATCHES = (1, 64, 512, 4096)
INVARIANCE_BATCHES = (1, 3, 64, 512)   # phase 14: against one B=4096 call
INVARIANCE_ROW = 1001                  # phase 14: the odd first row
SPIN_CYCLES = 10_000_000    # ~5 ms of GPU clock: covers one run's enqueue
# (label, N, M, act, input scale) -- the layers of the main path
LAYERS = (("784->300", 300, 784, True, "pixel"),
          ("300->10", 10, 300, False, "unit"),
          ("851->230", 230, 851, True, "unit"),
          ("230->230", 230, 230, True, "unit"))
N_FILES = 4096
MNIST = (784, [300], 10)
XRD = (851, [230], 230)
# phase 7: a hidden layer with more rows than an H100 holds warps at once
# (132 SMs x 8 warps x the blocks an SM holds), so the epoch kernel's grid
# is what the card holds and a warp takes several rows of a layer
WIDE = (784, [2304], 10)
# phase 7: an input layer too wide for the epoch kernel's staged vectors
# in one block's shared memory at f64, which the wrapper refuses
TOO_WIDE = (30000, [10], 10)
TRAIN_FILES = 512          # phase 9: training files, and as many test files
# phase 7 runs: (tag, topology, kind, momentum, dtype, classes, samples)
TRAIN_RUNS = (
    [("mnist", MNIST, k, m, d, (0, 1) if k == "ANN" else (0, 1, 2, 3), 8)
     for k in ("ANN", "SNN") for m in (False, True)
     for d in ("f64", "f32", "bf16")]
    + [("xrd", XRD, "ANN", True, d, (0, 1), 4) for d in ("f64", "f32")]
    + [("mnist", MNIST, "LNN", False, "f64", (0, 1), 8)]
    + [("near1", MNIST, "ANN", False, "f64", (0, 1), 2)]
    + [("wide", WIDE, "ANN", False, "f64", (0, 1), 2)])
# the "near1" run's last output target: 2^-30 below 1, so in double it is
# not the target class (the exact 1 of class 0 or 1 is), as in hpnn_tpu
NEAR_ONE = 1.0 - 2.0**-30
# kernel vs plain, per dtype: (n_iter slack: absolute, relative; weights).
# f32: the envelope of tests/test_pallas_convergence.py:35-57, with 2%
# where it has 1%: an XRD ANN BPM sample runs 20-37k iterations and its
# stop (dEp <= 1e-6) falls where the f32 error moves by a few ULPs an
# iteration, so the two sum orders stopped 1.08% apart on one sample (on
# the H100).  bf16 rounds every operation to bf16 in both versions, so
# only the order of the float32 sums differs, as at f32: it is held to the
# f32 limits (measured: identical n_iter and weights in all six runs).
TRAIN_LIMIT = {"f64": (0, 0.0, 1e-10), "f32": (4, 0.02, 5e-3),
               "bf16": (4, 0.02, 5e-3)}
# Phase 10 holds f32/bf16 weights to that limit times the largest plain
# weight (at least 1): MNIST SNN BPM f32 at tile 8 grows its first-layer
# weights to many times 1 in a few pixel-scale steps, and there two f32 sum
# orders of the same math end farther apart than 5e-3: the plain version
# run on the CPU and on the card does, by as much as the kernel and the
# card's plain version (on the H100), and the gap closes when the card's
# plain takes its three matrix products from the CPU.
# phase 10 runs: (tag, topology, kind, momentum, dtype, classes, samples,
# tile, storage)
TILE_RUNS = (
    [("mnist", MNIST, k, m, d, (0, 1) if k == "ANN" else (0, 1, 2, 3), 19,
      8, None) for k in ("ANN", "SNN") for m in (False, True)
     for d in ("f64", "f32", "bf16")]
    + [("xrd", XRD, "ANN", True, d, (0, 1), 4, 4, None) for d in ("f64",
                                                                  "f32")]
    + [("mnist", MNIST, "LNN", False, "f64", (0, 1), 19, 8, None)]
    + [("mnist", MNIST, "ANN", False, "f32", (0, 1), 19, 8, st)
       for st in ("bf16", "f32")]
    + [("wide", WIDE, "ANN", False, "f64", (0, 1), 19, 8, None)])
# phase 10: a hidden layer so wide that at tile 512 the tile kernel's block
# scratch (the lanes' deltas and a_0 of a block's 32 rows) does not fit in
# shared memory and goes to the block's workspace slice; a few lockstep
# iterations (max_iter) of one group of 512 samples
WIDE_SCRATCH = ((784, [4096], 10), 512, 3)
TRAIN_TILE = 32            # phase 12: train_nn --tile
# phase 13: the MNIST and XRD layers (N, M) and one past the 50 MB L2
BPM_SHAPES = ((300, 784), (10, 300), (230, 851), (230, 230), (4096, 4096))
BPM_COLD_BYTES = 100 << 20   # phase 13: the inputs a cold run rotates over
BPM_COLD_RUN = 256           # phase 13: the most launches a timed cold run
SPIN_PER_LAUNCH = 100_000    # GPU cycles of spin per queued launch (~50 us)
EPOCHS = 3                   # phase 16: train_nn --epochs
KILL_AT = 1                  # phase 17: HPNN_CKPT_KILL_AT_EPOCH


def log(msg: str) -> None:
    print(msg, flush=True)


def _dtypes():
    import torch

    return {"f32": torch.float32, "bf16": torch.bfloat16,
            "f64": torch.float64}


def _limit(dtype: str, scale: str) -> float:
    if dtype == "f32" and scale == "pixel":
        return LIMIT["f32-pixel"]
    return LIMIT[dtype]


def _inputs(rng, b, m, scale):
    if scale == "pixel":
        return rng.integers(0, 256, (b, m)).astype(np.float64)
    return rng.uniform(-1.0, 1.0, (b, m))


def _to_card(a, dtype):
    import torch

    return torch.as_tensor(a, dtype=torch.float64).cuda().to(dtype)


# --- phase 1-2 --------------------------------------------------------------

def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    return card


def phase_build():
    """Build every kernel; fails when the compiler gives any kernel of the
    tile kernel's library a stack frame or spills (its design keeps nothing
    in local memory).  Returns how many it checked, and their frame and
    spill bytes (0)."""
    from hpnn_tpu_torch.ops import build
    from hpnn_tpu_torch.ops.convergence_tile_kernel import _ENTRY

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {len(libs)} kernel(s) in "
        f"{time.perf_counter() - t0:.2f} s into {build.BUILD_DIR}")
    for name in libs:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")
    frames = re.findall(
        r"Function properties for (\S+)\s+(\d+) bytes stack frame, (\d+) "
        r"bytes spill stores, (\d+) bytes spill loads",
        build.build_log("train_tile"))
    bad = [f for f in frames if any(map(int, f[1:]))]
    # each entry point compiled with its block scratch on chip and off
    if len(frames) < 2 * len(_ENTRY) or bad:
        raise AssertionError(f"train_tile: {len(frames)} kernels compiled; "
                             "with a stack frame or spills (bytes of frame, "
                             f"spill stores, spill loads): {bad}")
    return {"entries": len(frames), "stack_frame_bytes": 0,
            "spill_bytes": 0}


# --- phase 3 ----------------------------------------------------------------

def phase_kernel_vs_plain():
    import torch

    from hpnn_tpu_torch.ops.kernels import (fused_linear_act,
                                            fused_linear_act_plain)

    rng = np.random.default_rng(20260101)
    errs = {}
    cases = [(label, n, m, act, scale, b) for label, n, m, act, scale
             in LAYERS for b in BATCHES]
    cases += [("784->300", 300, 784, True, "unit", b) for b in BATCHES]
    cases.append(("37->13", 13, 37, True, "unit", 5))
    for label, n, m, act, scale, b in cases:
        w = rng.uniform(-1.0, 1.0, (n, m)) / np.sqrt(m)
        x = _inputs(rng, b, m, scale)
        for dname, dt in _dtypes().items():
            wt, xt = _to_card(w, dt), _to_card(x, dt)
            got = fused_linear_act(wt, xt, act=act)
            want = fused_linear_act_plain(wt, xt, act=act)
            torch.cuda.synchronize()
            err = (got.double() - want.double()).abs().max().item()
            lim = _limit(dname, scale)
            errs[(label, scale, dname, b)] = err
            if not err <= lim:
                raise AssertionError(
                    f"fused_linear_act {label} {dname} B={b} ({scale}): "
                    f"max |kernel - plain| = {err:.3e} > {lim:g}")
    worst = {d: max(e for k, e in errs.items() if k[2] == d)
             for d in _dtypes()}
    log(f"kernel vs plain: {len(errs)} cells within limits; worst "
        + ", ".join(f"{d} {e:.3e}" for d, e in worst.items()))
    return errs


# --- phase 14 ---------------------------------------------------------------

def phase_invariance():
    """Rows of one B=4096 call against the same rows in smaller calls,
    bit for bit, at every layer and dtype; returns the plans crossed."""
    import torch

    from hpnn_tpu_torch.ops.kernels import _plan, fused_linear_act

    def _plan_key(b, n, m, dt):
        plan = _plan(b, n, m, dt)
        return plan.tile, plan.per_group, plan.groups

    rng = np.random.default_rng(20260105)
    rows, plans = 0, set()
    for label, n, m, act, scale in LAYERS:
        w = rng.uniform(-1.0, 1.0, (n, m)) / np.sqrt(m)
        x = _inputs(rng, 4096, m, scale)
        for dname, dt in _dtypes().items():
            wt, xt = _to_card(w, dt), _to_card(x, dt)
            full = fused_linear_act(wt, xt, act=act)
            plans.add(_plan_key(4096, n, m, dt))
            for b in INVARIANCE_BATCHES:
                plans.add(_plan_key(b, n, m, dt))
                for lo in (0, INVARIANCE_ROW):
                    part = fused_linear_act(wt, xt[lo:lo + b], act=act)
                    torch.cuda.synchronize()
                    if not _bitwise(part, full[lo:lo + b]):
                        raise AssertionError(
                            f"fused_linear_act {label} {dname}: rows "
                            f"{lo}:{lo + b} of a B={b} call differ from "
                            "the same rows of the B=4096 call")
                    rows += b
    plans = sorted(plans)
    log(f"batch invariance: {rows} rows over {len(LAYERS)} layers x "
        f"{len(_dtypes())} dtypes bit-identical to the B=4096 calls, "
        f"across {len(plans)} plans (tile, stages a group, groups): "
        + ", ".join(f"{t}/{g}/{z}" for t, g, z in plans))
    return plans


# --- phase 4 ----------------------------------------------------------------

def _write_corpus(dirpath, n_in, n_out, scale, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(dirpath)
    for i in range(N_FILES):
        x = _inputs(rng, 1, n_in, scale)[0]
        label = int(rng.integers(n_out))
        with open(os.path.join(dirpath, f"s{i:05d}.txt"), "w") as fp:
            fp.write(f"[input] {n_in}\n")
            fp.write(" ".join(f"{v:7.5f}" for v in x) + "\n")
            fp.write(f"[output] {n_out}  #{label}\n")
            fp.write(" ".join("1.0" if j == label else "-1.0"
                              for j in range(n_out)) + "\n")


def _setup_runs(tmp):
    from hpnn_tpu_torch.io.kernel_io import dump_kernel_to_path
    from hpnn_tpu_torch.models.kernel import generate_kernel

    runs = []
    for tag, (n_in, hid, n_out), scale, seed in (
            ("mnist", MNIST, "pixel", 10958), ("xrd", XRD, "unit", 851)):
        tests = os.path.join(tmp, f"{tag}_tests")
        _write_corpus(tests, n_in, n_out, scale, seed)
        kern, _ = generate_kernel(seed, n_in, hid, n_out)
        kpath = os.path.join(tmp, f"{tag}_kernel.opt")
        dump_kernel_to_path(kern, kpath)
        combos = ([(k, d) for k in ("ANN", "SNN") for d in
                   ("f64", "f32", "bf16")] if tag == "mnist"
                  else [("ANN", "f32")])
        for kind, dtype in combos:
            name = f"{tag}_{kind.lower()}_{dtype}"
            conf = os.path.join(tmp, f"{name}.conf")
            with open(conf, "w") as fp:
                fp.write(f"[name] {name}\n[type] {kind}\n[init] {kpath}\n"
                         f"[seed] 10958\n[input] {n_in}\n"
                         f"[hidden] {' '.join(map(str, hid))}\n"
                         f"[output] {n_out}\n[train] BP\n"
                         f"[test_dir] {tests}\n[dtype] {dtype}\n")
            runs.append((name, conf, kind, dtype, scale))
    return runs


def phase_run_nn(runs):
    import torch

    from hpnn_tpu_torch import cli
    from hpnn_tpu_torch.api import configure, dtype_of, load_tests
    from hpnn_tpu_torch.models.kernel import weights_to_torch
    from hpnn_tpu_torch.ops.kernels import (batched_forward_plain,
                                            fused_linear_act)

    results, rows_cache = {}, {}
    for name, conf, kind, dtype, scale in runs:
        before = fused_linear_act.launches
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc, outs = cli.run_nn(["-v", "-v", "--device", "cuda", conf])
        wall = time.perf_counter() - t0
        text = out.getvalue()
        launched = fused_linear_act.launches - before
        if rc != 0 or outs is None:
            raise AssertionError(f"run_nn {name}: rc={rc}")
        if launched <= 0:
            raise AssertionError(f"run_nn {name}: no kernel launch")
        n_tested = text.count("TESTING FILE:")
        if n_tested != N_FILES or outs.shape[0] != N_FILES:
            raise AssertionError(f"run_nn {name}: {n_tested} files tested")
        if not np.all(np.isfinite(outs)):
            raise AssertionError(f"run_nn {name}: non-finite outputs")
        nn = configure(conf)
        key = nn.conf.tests
        if key not in rows_cache:
            from hpnn_tpu_torch.io.corpus import LAST_LOAD

            t0 = time.perf_counter()
            rows_cache[key] = load_tests(nn)[1]
            log(f"corpus {os.path.basename(key)}: {N_FILES} files loaded "
                f"on the host in {time.perf_counter() - t0:.2f} s "
                f"({LAST_LOAD['mode']}; native_io: {LAST_LOAD['native_io']})")
        xs = rows_cache[key]
        dt = dtype_of(nn.conf)
        weights = weights_to_torch(nn.kernel.weights, dt, "cuda")
        plain = batched_forward_plain(
            weights, torch.as_tensor(xs).cuda().to(dt), kind)
        err = float(np.max(np.abs(
            outs - plain.double().cpu().numpy())))
        lim = _limit(dtype, scale)
        if not err <= lim:
            raise AssertionError(f"run_nn {name}: max |kernel - plain| = "
                                 f"{err:.3e} > {lim:g}")
        log(f"run_nn {name}: {n_tested} files, PASS={text.count('[PASS]')}"
            f", launches={launched}, max |kernel - plain| = {err:.3e} "
            f"(limit {lim:g}), {wall:.2f} s")
        results[name] = (outs, xs)
    return results


# --- phase 5 ----------------------------------------------------------------

def _post(url, rows):
    body = json.dumps({"inputs": rows.tolist()}).encode()
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def phase_serve(runs, results):
    from hpnn_tpu_torch import cli
    from hpnn_tpu_torch.ops.kernels import fused_linear_act
    from hpnn_tpu_torch.serve.server import serve_in_thread

    confs = {name: conf for name, conf, *_ in runs}
    served = ("mnist_ann_f32", "mnist_ann_f64",
              "mnist_snn_f32", "mnist_snn_f64")
    before = fused_linear_act.launches
    app, _ = cli.serve_app(["-p", "0", "--device", "cuda",
                            "--warmup-mode", "sync",
                            *(confs[n] for n in served)])
    if app is None:
        raise AssertionError("serve_nn: no app")
    httpd, th = serve_in_thread(app, "127.0.0.1", 0)
    base = "http://%s:%d" % httpd.server_address[:2]
    n_req = 0
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            if r.status != 200:
                raise AssertionError(f"healthz {r.status}")
        for name in served:
            outs, xs = results[name]
            url = f"{base}/v1/kernels/{name}/infer"

            def check(lo, hi, url=url, outs=outs, xs=xs, name=name):
                status, body = _post(url, xs[lo:hi])
                got = np.asarray(body["outputs"], np.float64)
                if status != 200 or not np.array_equal(got, outs[lo:hi]):
                    raise AssertionError(
                        f"serve {name} rows {lo}:{hi}: status {status}, "
                        "answer not bit-identical to run_nn")

            for lo, hi in ((0, 1), (1, 4), (4, 68)):
                check(lo, hi)
                n_req += 1
            spans = [(100 + 9 * i, 100 + 9 * i + 1 + i) for i in range(8)]
            errors = []

            def one(lo, hi):
                try:
                    check(lo, hi)
                except Exception as exc:  # re-raised below, on this thread
                    errors.append(exc)

            threads = [threading.Thread(target=one, args=s) for s in spans]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                if t.is_alive():
                    raise AssertionError("serve: a request never returned")
            if errors:
                raise errors[0]
            n_req += len(spans)
        with urllib.request.urlopen(base + "/metrics?format=json",
                                    timeout=60) as r:
            snap = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.close(drain=True)
        th.join(timeout=60)
    launched = fused_linear_act.launches - before
    if launched <= 0:
        raise AssertionError("serve: no kernel launch")
    log(f"serve_nn: {n_req} requests over {len(served)} kernels, all 200 "
        f"and bit-identical to run_nn; launches={launched}; batches="
        f"{snap['batches_total']}; cache={snap['compile_cache']}")


# --- phase 6 ----------------------------------------------------------------

def _device_ms(fn, launches=10, runs=20):
    """Device time of one call of ``fn``: the median over ``runs`` of a
    back-to-back run of ``launches`` calls between two CUDA events.  A GPU
    spin (``torch.cuda._sleep``) is queued first, so the host has enqueued
    the whole run before the first call starts and host overhead does not
    enter the measurement."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def _bound(b, n, m, dtype):
    item = {"f32": 4, "bf16": 2, "f64": 8}[dtype]
    t_ops = 2.0 * b * n * m / PEAK[dtype]
    t_bytes = (b * m + n * m + b * n) * item / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_times():
    from hpnn_tpu_torch.ops.activations import ann_act
    from hpnn_tpu_torch.ops.kernels import (fused_linear_act,
                                            fused_linear_act_plain)

    import torch

    rng = np.random.default_rng(7)
    cells = []
    for label, n, m, act, scale in LAYERS:
        w = rng.uniform(-1.0, 1.0, (n, m)) / np.sqrt(m)
        for b in TIMED_BATCHES:
            x = _inputs(rng, b, m, scale)
            for dname, dt in _dtypes().items():
                wt, xt = _to_card(w, dt), _to_card(x, dt)

                def library(wt=wt, xt=xt, act=act):
                    z = torch.matmul(xt, wt.T)
                    return ann_act(z) if act else z

                def kernel(wt=wt, xt=xt, act=act):
                    return fused_linear_act(wt, xt, act=act)

                def plain(wt=wt, xt=xt, act=act):
                    return fused_linear_act_plain(wt, xt, act=act)

                ms = _device_ms(kernel)
                plain_ms = _device_ms(plain)
                library_ms = _device_ms(library)
                bound_ms, bound_by = _bound(b, n, m, dname)
                cells.append({"layer": label, "dtype": dname, "B": b,
                              "ms": ms, "plain_ms": plain_ms,
                              "library_ms": library_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by})
                log(f"time fused_linear_act {label} {dname} B={b}: "
                    f"ms={ms:.5f} plain_ms={plain_ms:.5f} "
                    f"library_ms={library_ms:.5f} "
                    f"bound_ms={bound_ms:.5f} ({bound_by})")
    return cells


# --- phase 7-9: the training epoch kernel ----------------------------------

def _bar_corpus(n, topology, classes, seed):
    """A separable corpus: class c lights one bar (60 pixels at 250 on the
    MNIST width, 3 inputs at 1.0 on the XRD width), plus one random input
    (tests/test_tutorials.py:26-31).  Returns (xs, ts, labels)."""
    n_in, _, n_out = topology
    mnist = n_in == 784
    width, value = (60, 250.0) if mnist else (3, 1.0)
    rng = np.random.default_rng(seed)
    xs = np.zeros((n, n_in))
    ts = -np.ones((n, n_out))
    labels = [classes[i % len(classes)] for i in range(n)]
    for i, c in enumerate(labels):
        xs[i, c * width:(c + 1) * width] = value
        xs[i, rng.integers(0, n_in)] = (rng.integers(0, 256) if mnist
                                        else rng.uniform(0.0, 1.0))
        ts[i, c] = 1.0
    return xs, ts, labels


def _train_inputs(topology, dtype, classes, samples, seed=31):
    import torch

    from hpnn_tpu_torch.models.kernel import generate_kernel

    n_in, hid, n_out = topology
    xs, ts, _ = _bar_corpus(samples, topology, classes, seed)
    kern, _ = generate_kernel(10958, n_in, hid, n_out)
    dt = _dtypes()[dtype]
    wdt = torch.float32 if dt == torch.bfloat16 else dt
    return (tuple(_to_card(w, wdt) for w in kern.weights),
            _to_card(xs, dt), _to_card(ts, dt))


def _params(weights):
    return sum(w.shape[0] * w.shape[1] for w in weights)


def _train_bound(weights, momentum, iters, dtype, n_samples):
    """The least time of an epoch of ``iters`` iterations: the operations
    the kernel does per iteration (the update fused into the forward:
    BP 3 flops a weight, BPM 5, the forward's multiply-add 2; the hidden
    deltas 2 a weight of every layer but the first) over the card's peak,
    against the bytes of the epoch's inputs and outputs read and written
    once (weights in and out, samples, targets, stats; the weights stay on
    the chip between iterations) over 3.35 TB/s.  Returns (bound_ms,
    bound_by, flops_per_iteration)."""
    p = _params(weights)
    p_hidden = p - weights[0].shape[0] * weights[0].shape[1]
    flops_it = (7 if momentum else 5) * p + 2 * p_hidden
    item = {"f32": 4, "bf16": 2, "f64": 8}[dtype]
    witem = 4 if dtype == "bf16" else item
    n_in, n_out = weights[0].shape[1], weights[-1].shape[0]
    nbytes = 2 * p * witem + n_samples * (n_in + n_out) * item \
        + n_samples * 5 * 8
    t_ops = iters * flops_it / PEAK[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops_it)


def _check_train(tag, dtype, sk, sp, wk, wp, name="train_epoch",
                 scaled=False):
    """Kernel stats/weights against the plain version's; raises above the
    dtype's limits (``scaled``: f32/bf16 weights relative to the largest
    plain weight, as phase 10 holds them).  Returns (max weight diff, max
    |dn_iter|)."""
    k, p = sk.cpu().numpy(), sp.cpu().numpy()
    slack, rel, wlim = TRAIN_LIMIT[dtype]
    if scaled and dtype != "f64":
        wlim *= max(1.0, max(float(b.double().abs().max()) for b in wp))
    werr = max(float((a.double() - b.double()).abs().max())
               for a, b in zip(wk, wp))
    dn = np.abs(k[:, 2] - p[:, 2])
    bad = []
    if not np.array_equal(k[:, [1, 4]], p[:, [1, 4]]):
        bad.append("first_ok/success differ")
    if not np.all(dn <= np.maximum(slack, rel * p[:, 2])):
        bad.append(f"n_iter {k[:, 2].tolist()} vs {p[:, 2].tolist()}")
    if dtype == "f64":
        eerr = float(np.abs(k[:, [0, 3]] - p[:, [0, 3]]).max())
        if not eerr <= 1e-12:
            bad.append(f"init_err/final_dep differ by {eerr:.3e}")
    if not werr <= wlim:
        bad.append(f"weights differ by {werr:.3e} > {wlim:g}")
    if bad:
        raise AssertionError(f"{name} {tag}: " + "; ".join(bad))
    return werr, float(dn.max())


def phase_train_vs_plain():
    import torch

    from hpnn_tpu_torch.ops.convergence_kernel import (train_epoch_kernel,
                                                       train_epoch_plain)

    # a launch of each dtype and plan first, so that no timed run below
    # pays for loading the library and its kernels; each first launch is
    # timed (host clock) against a second on the same inputs, whose
    # difference is the one-off cost a fresh process pays
    first = {}
    for dtype in _dtypes():
        w, x, t = _train_inputs(MNIST, dtype, (0,), 1)
        for resident in (0, 1):
            ms = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                train_epoch_kernel(w, x, t, "ANN", False, _plan=resident)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            first[f"{dtype} {'resident' if resident else 'staged'}"] = {
                "first_ms": ms[0], "second_ms": ms[1]}
    log("train_epoch first launch, then a second on the same inputs (1 "
        "MNIST ANN BP sample), ms: " + ", ".join(
            f"{k} {v['first_ms']:.2f} then {v['second_ms']:.2f}"
            for k, v in first.items()))
    results = []
    for name, topo, kind, momentum, dtype, classes, n in TRAIN_RUNS:
        w, x, t = _train_inputs(topo, dtype, classes, n)
        if name == "near1":
            t[:, -1] = NEAR_ONE
        tag = (f"{name} {kind} {'BPM' if momentum else 'BP'} {dtype} "
               f"({n} samples)")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        wk, sk = train_epoch_kernel(w, x, t, kind, momentum)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        plan = dict(train_epoch_kernel.plan)
        per_iter = _barriers_per_iter(w, sk)
        # the other plan (W_0 in device memory, or resident) on the same
        # inputs: the same bits
        wo, so = train_epoch_kernel(w, x, t, kind, momentum,
                                    _plan=0 if plan["resident"] else 1)
        torch.cuda.synchronize()
        if not (_bitwise(wk, wo) and _bitwise(sk, so)):
            raise AssertionError(f"train_epoch {tag}: the {plan} plan and "
                                 f"{train_epoch_kernel.plan} differ")
        if name == "wide" and max(plan["rows0"],
                                  train_epoch_kernel.plan["rows0"]) < 2:
            raise AssertionError(f"train_epoch {tag}: no plan took several "
                                 f"rows a warp ({plan}, "
                                 f"{train_epoch_kernel.plan})")
        t0 = time.perf_counter()
        wp, sp = train_epoch_plain(w, x, t, kind, momentum)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        werr, dn = _check_train(tag, dtype, sk, sp, wk, wp)
        k, p = sk.cpu().numpy(), sp.cpu().numpy()
        iters, p_iters = int(k[:, 2].sum()), int(p[:, 2].sum())
        bound_ms, bound_by, flops_it = _train_bound(w, momentum, iters,
                                                    dtype, n)
        same = int(np.sum((k[:, 1] == p[:, 1]) & (k[:, 4] == p[:, 4])))
        results.append({"run": tag, "dtype": dtype, "kind": kind,
                        "momentum": momentum, "samples": n,
                        "iters": iters, "plain_iters": p_iters,
                        "max_dn_iter": dn, "max_abs_err": werr,
                        "verdicts_equal": same, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "flops_per_iter": flops_it,
                        "plan": plan, "other_plan":
                            dict(train_epoch_kernel.plan),
                        "barriers_per_iter": per_iter,
                        "n_iter": k[:, 2].astype(int).tolist(),
                        "plain_n_iter": p[:, 2].astype(int).tolist()})
        log(f"train_epoch {tag}: iterations {iters} (plain {p_iters}), "
            f"max |dn_iter| {dn:g}, verdicts equal {same}/{n}, max |kernel - "
            f"plain| weights {werr:.3e}; kernel {ms:.2f} ms = "
            f"{ms * 1e3 / iters:.2f} us/iter on {plan['blocks']} blocks "
            f"x {plan['warps']} warps, {plan['rows0']} row(s) of W_0 a warp, "
            f"{'resident' if plan['resident'] else 'staged'} plan "
            f"({plan['smem_bytes']} shared bytes a block; the other plan "
            f"bit-identical), {per_iter:g} grid barriers an iteration, "
            f"plain {plain_ms * 1e3 / p_iters:.1f} us/iter, "
            f"bound {bound_ms * 1e6 / iters:.4f} ns/iter ({bound_by})")
    worst = {d: max((r["max_abs_err"] for r in results if r["dtype"] == d),
                    default=0.0) for d in _dtypes()}
    log("train_epoch vs plain: all runs within limits; worst weight error "
        + ", ".join(f"{d} {e:.3e}" for d, e in worst.items()))
    # widths whose staged vectors do not fit in a block's shared memory:
    # refused with a clear error, nothing launched
    w, x, t = _train_inputs(TOO_WIDE, "f64", (0, 1), 1)
    before = train_epoch_kernel.launches
    try:
        train_epoch_kernel(w, x, t, "ANN", False)
    except ValueError as exc:
        refusal = str(exc)
    else:
        raise AssertionError(f"train_epoch at {TOO_WIDE} f64 launched")
    if train_epoch_kernel.launches != before:
        raise AssertionError("train_epoch counted a refused launch")
    log(f"train_epoch at {TOO_WIDE} f64 refused: {refusal}")
    return results, first


def _barriers_per_iter(weights, stats):
    """The grid barriers the last epoch launch took an iteration, as its
    kernel counted them; raises unless that is 2L - 2 (L >= 2 layers; 1 for
    L = 1) and its iterations are those of its stats rows."""
    from hpnn_tpu_torch.ops.convergence_kernel import train_epoch_kernel

    in_iters, _, iters = train_epoch_kernel.syncs.tolist()
    n_iter = stats.n_iter if hasattr(stats, "n_iter") else stats[:, 2]
    trained = int(n_iter[n_iter >= 0].sum())
    layers = len(weights)
    want = 2 * layers - 2 if layers > 1 else 1
    if iters != trained or in_iters != want * iters:
        raise AssertionError(f"train_epoch: {in_iters} grid barriers in "
                             f"{iters} iterations ({trained} in the stats), "
                             f"not {want} an iteration")
    return in_iters / iters


def phase_resume():
    import torch

    from hpnn_tpu_torch.ops.convergence_kernel import (train_epoch_cuda,
                                                       train_epoch_kernel)

    w, x, t = _train_inputs(MNIST, "f64", (0, 1), 8)
    before = train_epoch_kernel.launches
    w1, s1 = train_epoch_cuda(w, x, t, "ANN", False)
    one = train_epoch_kernel.launches - before
    w2, s2 = train_epoch_cuda(w, x, t, "ANN", False, iter_budget=100)
    many = train_epoch_kernel.launches - before - one
    torch.cuda.synchronize()
    if one != 1 or many <= 1:
        raise AssertionError(f"resume: {one} launch(es) unbudgeted, {many} "
                             "budgeted")
    equal = all(np.array_equal(a.cpu().numpy(), b.cpu().numpy())
                for a, b in zip(w1, w2)) and all(
        np.array_equal(getattr(s1, f).numpy(), getattr(s2, f).numpy())
        for f in s1._fields)
    if not equal:
        raise AssertionError("resume: budgeted launches differ from one "
                             "launch")
    log(f"resume: f64 MNIST ANN BP epoch ({int(s1.n_iter.sum())} "
        f"iterations) in {many} launches at a budget of 100 iterations is "
        "bit-identical to 1 launch")
    return many


def _write_samples(dirpath, xs, ts, labels):
    os.makedirs(dirpath)
    for i, (x, t, c) in enumerate(zip(xs, ts, labels)):
        with open(os.path.join(dirpath, f"s{i:05d}.txt"), "w") as fp:
            fp.write(f"[input] {x.shape[0]}\n")
            fp.write(" ".join(f"{v:.1f}" for v in x) + "\n")
            fp.write(f"[output] {t.shape[0]}  #{c}\n")
            fp.write(" ".join(f"{v:.1f}" for v in t) + "\n")


def phase_train_nn(tmp):
    """train_nn on the MNIST tutorial conf (tutorials/mnist/tutorial.bash:
    36-48: ANN, BP, [init] generate, [seed] 10958, 784-300-10, f64), then
    run_nn of its kernel.opt."""
    from hpnn_tpu_torch import cli

    root = os.path.join(tmp, "train_nn")
    classes = tuple(range(10))
    for sub, seed in (("samples", 5), ("tests", 6)):
        xs, ts, labels = _bar_corpus(TRAIN_FILES, MNIST, classes, seed)
        _write_samples(os.path.join(root, sub), xs, ts, labels)
    conf = ("[name] mnist\n[type] ANN\n[init] generate\n[seed] 10958\n"
            "[input] 784\n[hidden] 300\n[output] 10\n[train] BP\n"
            "[sample_dir] ./samples\n[test_dir] ./tests\n")
    with open(os.path.join(root, "nn.conf"), "w") as fp:
        fp.write(conf)
    with open(os.path.join(root, "run.conf"), "w") as fp:
        fp.write(conf.replace("[init] generate", "[init] kernel.opt"))
    cwd = os.getcwd()
    os.chdir(root)
    try:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.train_nn_main(["-v", "-v", "--device", "cuda",
                                    "nn.conf"])
        wall = time.perf_counter() - t0
        text = out.getvalue()
        lines = [ln for ln in text.splitlines() if "TRAINING FILE:" in ln]
        iters = [int(m) for m in re.findall(r"N_ITER=\s*(\d+)", text)]
        if rc != 0 or len(lines) != TRAIN_FILES or len(iters) != TRAIN_FILES:
            raise AssertionError(f"train_nn: rc={rc}, {len(lines)} lines, "
                                 f"{len(iters)} with N_ITER")
        for f in ("kernel.tmp", "kernel.opt"):
            if not os.path.isfile(f):
                raise AssertionError(f"train_nn: {f} was not written")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc, outs = cli.run_nn(["-v", "-v", "--device", "cuda",
                                   "run.conf"])
        n_pass = out.getvalue().count("[PASS]")
        if rc != 0 or outs is None or not np.all(np.isfinite(outs)):
            raise AssertionError(f"run_nn of the trained kernel: rc={rc}")
        if n_pass < 0.8 * TRAIN_FILES:
            raise AssertionError(f"run_nn of the trained kernel: PASS "
                                 f"{n_pass}/{TRAIN_FILES} < 80%")
    finally:
        os.chdir(cwd)
    n_ok = text.count("SUCCESS!")
    log(f"train_nn: {TRAIN_FILES} files, {sum(iters)} iterations, "
        f"SUCCESS {n_ok}, wall {wall:.2f} s; run_nn of kernel.opt: PASS "
        f"{n_pass}/{TRAIN_FILES}")
    return {"root": root, "iters": sum(iters), "wall_s": wall,
            "success": n_ok, "pass": n_pass}


def phase_train_time(e2e):
    """Device time of phase 9's epoch: the same conf, shuffle and samples
    through the kernel alone, between two CUDA events; then the same epoch
    through ``train_tile`` at tile 1, which must give the same bits."""
    import torch

    from hpnn_tpu_torch.models.kernel import weights_to_torch
    from hpnn_tpu_torch.ops.convergence import stats_record
    from hpnn_tpu_torch.ops.convergence_kernel import (train_epoch_cuda,
                                                       train_epoch_kernel)
    from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile

    nn, xs, ts = _epoch_inputs(e2e["root"])
    w = weights_to_torch(nn.kernel.weights, torch.float64, "cuda")
    x, t = _to_card(xs, torch.float64), _to_card(ts, torch.float64)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    wk, st = train_epoch_cuda(w, x, t, "ANN", False)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    plan = dict(train_epoch_kernel.plan)
    per_iter = _barriers_per_iter(w, st)
    iters = int(st.n_iter.sum())
    if iters != e2e["iters"]:
        raise AssertionError(f"train_nn epoch replay: {iters} iterations, "
                             f"train_nn printed {e2e['iters']}")
    wt, stt = train_tile(w, x, t, "ANN", False, tile=1)
    stt = stats_record(stt, torch.float64)
    if not (_bitwise(tuple(wk), tuple(wt))
            and _bitwise(tuple(st), tuple(stt))):
        raise AssertionError("train_nn epoch: train_tile at tile 1 is not "
                             "bit-identical to train_epoch")
    bound_ms, bound_by, flops_it = _train_bound(w, False, iters, "f64",
                                                xs.shape[0])
    log(f"train_nn epoch on the card: {ms:.1f} ms device time, {iters} "
        f"iterations = {ms * 1e3 / iters:.2f} us/iter "
        f"({iters / ms * 1e3:.0f} iterations/s) on {plan['blocks']} blocks, "
        f"{'resident' if plan['resident'] else 'staged'} plan, "
        f"{plan['smem_bytes']} shared bytes a block, {per_iter:g} grid "
        f"barriers an iteration; bound {bound_ms:.4f} ms "
        f"({bound_by}, {flops_it} flops an iteration); train_tile at tile 1 "
        "bit-identical")
    return {"ms": ms, "iters": iters, "us_per_iter": ms * 1e3 / iters,
            "bound_ms": bound_ms, "bound_by": bound_by, "plan": plan,
            "barriers_per_iter": per_iter}


# --- phase 10-12: the batched-tile epoch kernel ----------------------------

def _lockstep(n_iter, tile):
    """Lockstep iterations of a tiled epoch: each group runs as long as its
    slowest lane, so the sum over groups of the largest n_iter."""
    n_iter = np.asarray(n_iter, dtype=np.int64)
    return int(sum(n_iter[g:g + tile].max()
                   for g in range(0, n_iter.shape[0], tile)))


def _tile_bound(weights, momentum, lockstep, lane_iters, dtype, n_samples):
    """The least time of a tiled epoch: per lockstep iteration with S live
    lanes about 4SP + 2SP_hidden + 2P flops for BP (each lane's update
    product and sum and its forward multiply-add, its hidden deltas, then
    lr*g and the add once a weight; BPM adds 3P for the momentum), summed
    over this run's iterations (the sum of S over them is the
    lane-iterations), over the card's peak; against the bytes of the
    epoch's inputs and outputs read and written once.  Returns (bound_ms,
    bound_by, flops)."""
    p = _params(weights)
    p_hidden = p - weights[0].shape[0] * weights[0].shape[1]
    flops = ((4 * p + 2 * p_hidden) * lane_iters
             + (5 if momentum else 2) * p * lockstep)
    item = {"f32": 4, "bf16": 2, "f64": 8}[dtype]
    witem = 4 if dtype == "bf16" else item
    n_in, n_out = weights[0].shape[1], weights[-1].shape[0]
    nbytes = 2 * p * witem + n_samples * (n_in + n_out) * item \
        + n_samples * 5 * 8
    t_ops = flops / PEAK[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops)


def phase_tile_vs_plain():
    import torch

    from hpnn_tpu_torch.ops.convergence_tile import train_epoch_tiled_plain
    from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile

    results = []
    for name, topo, kind, momentum, dtype, classes, n, tile, storage \
            in TILE_RUNS:
        w, x, t = _train_inputs(topo, dtype, classes, n)
        tag = (f"{name} {kind} {'BPM' if momentum else 'BP'} {dtype} tile "
               f"{tile}" + (f" storage {storage}" if storage else "")
               + f" ({n} samples)")
        kw = dict(tile=tile, storage=storage)
        # a launch of two lockstep iterations first, so that the timed one
        # excludes the lazy load of this entry point's code
        train_tile(w, x, t, kind, momentum, max_iter=1, **kw)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        wk, sk = train_tile(w, x, t, kind, momentum, **kw)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        plan = dict(train_tile.plan)
        per_lock = _tile_barriers(w, sk, tile)
        if name == "wide":
            # other launch plans on the same inputs: W_0's rows in place (or
            # on chip), the inputs in lane chunks with the head's vectors
            # off chip, and the block's scratch in its workspace slice; the
            # same bits
            for force in ({"resident": not plan["resident"]},
                          {"x_lanes": 2, "head": False},
                          {"scratch": False}):
                wo, so = train_tile(w, x, t, kind, momentum, _plan=force,
                                    **kw)
                torch.cuda.synchronize()
                if not (_bitwise(wk, wo) and _bitwise(sk, so)):
                    raise AssertionError(f"train_tile {tag}: the {plan} plan "
                                         f"and {train_tile.plan} differ")
        t0 = time.perf_counter()
        wp, sp = train_epoch_tiled_plain(w, x, t, kind, momentum, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        werr, dn = _check_train(tag, dtype, sk, sp, wk, wp,
                                name="train_tile", scaled=True)
        k, p = sk.cpu().numpy(), sp.cpu().numpy()
        lanes, lock = int(k[:, 2].sum()), _lockstep(k[:, 2], tile)
        p_lock = _lockstep(p[:, 2], tile)
        bound_ms, bound_by, _ = _tile_bound(w, momentum, lock, lanes, dtype,
                                            n)
        results.append({"run": tag, "dtype": dtype, "kind": kind,
                        "momentum": momentum, "samples": n, "tile": tile,
                        "storage": storage, "lane_iters": lanes,
                        "lockstep": lock, "plain_lockstep": p_lock,
                        "max_dn_iter": dn, "max_abs_err": werr, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "plan": plan,
                        "barriers_per_lockstep": per_lock,
                        "n_iter": k[:, 2].astype(int).tolist(),
                        "plain_n_iter": p[:, 2].astype(int).tolist()})
        log(f"train_tile {tag}: lockstep iterations {lock} (plain "
            f"{p_lock}), lane-iterations {lanes}, max |dn_iter| {dn:g}, "
            f"max |kernel - plain| weights {werr:.3e}; kernel {ms:.2f} ms "
            f"= {ms * 1e3 / lock:.2f} us/lockstep iteration on "
            f"{plan['blocks']} blocks x {plan['warps']} warps, "
            f"{'resident' if plan['resident'] else 'staged'} W_0, "
            f"{plan['smem_bytes']} shared bytes a block, {per_lock:g} grid "
            f"barriers a lockstep iteration"
            + (", three other plans bit-identical" if name == "wide"
               else "")
            + f"; plain {plain_ms * 1e3 / p_lock:.1f} us/lockstep "
            f"iteration, bound {bound_ms * 1e3 / lock:.4f} us/lockstep "
            f"iteration ({bound_by})")
    worst = {d: max((r["max_abs_err"] for r in results if r["dtype"] == d),
                    default=0.0) for d in _dtypes()}
    log("train_tile vs plain: all runs within limits; worst weight error "
        + ", ".join(f"{d} {e:.3e}" for d, e in worst.items()))
    results.append(_tile_wide_scratch())
    # an input layer whose one lane's input does not fit in a block's
    # shared memory: refused with a clear error, nothing launched
    w, x, t = _train_inputs(TOO_WIDE, "f64", (0, 1), 2)
    before = train_tile.launches
    try:
        train_tile(w, x, t, "ANN", False, tile=8)
    except ValueError as exc:
        refusal = str(exc)
    else:
        raise AssertionError(f"train_tile at {TOO_WIDE} f64 launched")
    if train_tile.launches != before:
        raise AssertionError("train_tile counted a refused launch")
    log(f"train_tile at {TOO_WIDE} f64 refused: {refusal}")
    return results


def _tile_wide_scratch():
    """A hidden layer whose block scratch does not fit in shared memory at
    tile 512 (``WIDE_SCRATCH``): the plan puts it in the workspace, and a
    few lockstep iterations of one group hold to the plain version."""
    import torch

    from hpnn_tpu_torch.ops.convergence_tile import train_epoch_tiled_plain
    from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile

    topo, tile, max_iter = WIDE_SCRATCH
    w, x, t = _train_inputs(topo, "f64", (0, 1), tile)
    kw = dict(tile=tile, max_iter=max_iter)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    wk, sk = train_tile(w, x, t, "ANN", False, **kw)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    plan = dict(train_tile.plan)
    if plan["scratch_on_chip"] or not plan["ws_bytes"]:
        raise AssertionError(f"train_tile {topo} tile {tile}: plan {plan} "
                             "keeps the block scratch on chip")
    per_lock = _tile_barriers(w, sk, tile)
    wp, sp = train_epoch_tiled_plain(w, x, t, "ANN", False, **kw)
    torch.cuda.synchronize()
    tag = f"{topo[0]}-{topo[1][0]}-{topo[2]} ANN BP f64 tile {tile}"
    werr, dn = _check_train(tag, "f64", sk, sp, wk, wp, name="train_tile")
    k = sk.cpu().numpy()
    lanes, lock = int(k[:, 2].sum()), _lockstep(k[:, 2], tile)
    log(f"train_tile {tag} ({tile} samples, max_iter {max_iter}): block "
        f"scratch in the workspace ({plan['ws_bytes']} bytes a block, "
        f"{plan['smem_bytes']} shared), {lock} lockstep iterations, "
        f"{lanes} lane-iterations, max |kernel - plain| weights "
        f"{werr:.3e}, {per_lock:g} grid barriers a lockstep iteration; "
        f"kernel {ms:.2f} ms (first launch of this entry)")
    return {"run": tag, "dtype": "f64", "kind": "ANN", "momentum": False,
            "samples": tile, "tile": tile, "storage": None,
            "lane_iters": lanes, "lockstep": lock, "max_dn_iter": dn,
            "max_abs_err": werr, "ms": ms, "plan": plan,
            "barriers_per_lockstep": per_lock}


def _tile_barriers(weights, stats, tile):
    """The grid barriers the last tile launch took a lockstep iteration,
    as its kernel counted them; raises unless that is 2L - 2 (L >= 2
    layers; 1 for L = 1) and its lockstep iterations are those of its
    stats rows."""
    from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile

    in_iters, _, lock = train_tile.syncs.tolist()
    n_iter = stats[:, 2].cpu().numpy() if hasattr(stats, "cpu") else \
        np.asarray(stats.n_iter)
    trained = _lockstep(n_iter[n_iter >= 0], tile)
    layers = len(weights)
    want = 2 * layers - 2 if layers > 1 else 1
    if lock != trained or in_iters != want * lock:
        raise AssertionError(f"train_tile: {in_iters} grid barriers in "
                             f"{lock} lockstep iterations ({trained} in the "
                             f"stats), not {want} a lockstep iteration")
    return in_iters / lock


def _bitwise(a, b):
    """True when two tensors, or two sequences of tensors, hold the same
    bits."""
    import torch

    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.contiguous().view(torch.uint8),
                        y.contiguous().view(torch.uint8))
        for x, y in zip(a, b))


def phase_tile_contracts():
    """The three bitwise contracts of the tile kernel on the card."""
    import torch

    from hpnn_tpu_torch.ops.convergence_kernel import train_epoch_kernel
    from hpnn_tpu_torch.ops.convergence_tile import train_epoch_tiled
    from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile

    n_tile1 = 0
    for kind, dtypes in (("ANN", ("f64", "f32", "bf16")),
                         ("LNN", ("f64", "f32", "bf16")),
                         ("SNN", ("f32", "bf16"))):
        classes = (0, 1, 2, 3) if kind == "SNN" else (0, 1)
        for dtype in dtypes:
            for momentum in (False, True):
                w, x, t = _train_inputs(MNIST, dtype, classes, 8)
                w1, s1 = train_epoch_kernel(w, x, t, kind, momentum)
                w2, s2 = train_tile(w, x, t, kind, momentum, tile=1)
                torch.cuda.synchronize()
                if not (_bitwise(w1, w2) and _bitwise(s1, s2)):
                    raise AssertionError(
                        f"tile=1 {kind} {'BPM' if momentum else 'BP'} "
                        f"{dtype}: not bit-identical to train_epoch")
                n_tile1 += 1
    masked = []
    for kind, momentum, dtype in (("ANN", False, "f64"),
                                  ("SNN", True, "f32")):
        classes = (0, 1, 2, 3) if kind == "SNN" else (0, 1)
        w, x, t = _train_inputs(MNIST, dtype, classes, 6)
        w_pad, s_pad = train_tile(w, x, t, kind, momentum, tile=4)
        w_a, s_a = train_tile(w, x[:4].contiguous(), t[:4].contiguous(),
                              kind, momentum, tile=4)
        w_b, s_b = train_tile(w_a, x[4:].contiguous(), t[4:].contiguous(),
                              kind, momentum, tile=2)
        torch.cuda.synchronize()
        if not (_bitwise(w_pad, w_b)
                and _bitwise(s_pad, torch.cat([s_a, s_b]))):
            raise AssertionError(f"masked lanes {kind} {dtype}: the ragged "
                                 "tail differs from its rows alone")
        masked.append(f"{kind} {'BPM' if momentum else 'BP'} {dtype}")
    w, x, t = _train_inputs(MNIST, "f64", (0, 1), 19)
    before = train_tile.launches
    w1, s1 = train_epoch_tiled(w, x, t, "ANN", True, tile=8)
    one = train_tile.launches - before
    w2, s2 = train_epoch_tiled(w, x, t, "ANN", True, tile=8,
                               launch_groups=1)
    many = train_tile.launches - before - one
    if one != 1 or many != 3:
        raise AssertionError(f"group budget: {one} launch(es) unbudgeted, "
                             f"{many} at one group each")
    if not (_bitwise(w1, w2) and _bitwise(tuple(s1), tuple(s2))):
        raise AssertionError("group budget: launches of one group differ "
                             "from one launch")
    log(f"train_tile contracts: tile=1 bit-identical to train_epoch in "
        f"{n_tile1} runs; masked tail lanes inert ({', '.join(masked)}); "
        f"3 launches of one group bit-identical to 1 launch "
        f"({int(s1.n_iter.sum())} lane-iterations)")
    return {"tile1_runs": n_tile1, "masked": masked, "budget_launches": many}


def phase_train_nn_tile(e2e):
    """train_nn --tile 32 on phase 9's files and conf, then run_nn of its
    kernel.opt."""
    from hpnn_tpu_torch import cli

    cwd = os.getcwd()
    os.chdir(e2e["root"])
    try:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.train_nn_main(["-v", "-v", "--device", "cuda",
                                    "--tile", str(TRAIN_TILE), "nn.conf"])
        wall = time.perf_counter() - t0
        text = out.getvalue()
        iters = [int(m) for m in re.findall(r"N_ITER=\s*(\d+)", text)]
        if rc != 0 or len(iters) != TRAIN_FILES:
            raise AssertionError(f"train_nn --tile: rc={rc}, {len(iters)} "
                                 "lines with N_ITER")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc, outs = cli.run_nn(["-v", "-v", "--device", "cuda",
                                   "run.conf"])
        n_pass = out.getvalue().count("[PASS]")
        if rc != 0 or outs is None or not np.all(np.isfinite(outs)):
            raise AssertionError(f"run_nn of the tile-trained kernel: rc={rc}")
        if n_pass < 0.8 * TRAIN_FILES:
            raise AssertionError(f"run_nn of the tile-trained kernel: PASS "
                                 f"{n_pass}/{TRAIN_FILES} < 80%")
    finally:
        os.chdir(cwd)
    n_ok = text.count("SUCCESS!")
    log(f"train_nn --tile {TRAIN_TILE}: {TRAIN_FILES} files, {sum(iters)} "
        f"lane-iterations, SUCCESS {n_ok}, wall {wall:.2f} s; run_nn of "
        f"kernel.opt: PASS {n_pass}/{TRAIN_FILES}")
    return {"iters": sum(iters), "wall_s": wall, "success": n_ok,
            "pass": n_pass}


def _epoch_inputs(root):
    """Phase 9's conf, shuffle and samples, as the train path loads them."""
    from hpnn_tpu_torch.api import configure, shuffle_order
    from hpnn_tpu_torch.io.corpus import load_ordered
    from hpnn_tpu_torch.io.samples import list_sample_dir

    cwd = os.getcwd()
    os.chdir(root)
    try:
        nn = configure("nn.conf")
        names = list_sample_dir(nn.conf.samples)
        _, xs, ts = load_ordered(nn.conf.samples, names,
                                 shuffle_order(nn.conf, len(names)),
                                 "TRAINING", 784, 10)
    finally:
        os.chdir(cwd)
    return nn, xs, ts


def _tile_epoch(w, x, t, tile):
    """One launch of the tile kernel over the whole epoch, behind a GPU
    spin; returns (device ms between CUDA events, stats)."""
    import torch

    from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    _, st = train_tile(w, x, t, "ANN", False, tile=tile)
    end.record()
    end.synchronize()
    return start.elapsed_time(end), st


def phase_tile_time(e2e, tile_e2e, epoch):
    """Device time of phase 12's epoch: the same conf, shuffle and samples
    through one launch of the kernel, twice (the first and the second
    launch), with the grid barriers the kernel counted."""
    import torch

    from hpnn_tpu_torch.models.kernel import weights_to_torch
    from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile

    nn, xs, ts = _epoch_inputs(e2e["root"])
    w = weights_to_torch(nn.kernel.weights, torch.float64, "cuda")
    x, t = _to_card(xs, torch.float64), _to_card(ts, torch.float64)
    first_ms, st = _tile_epoch(w, x, t, TRAIN_TILE)
    ms, st2 = _tile_epoch(w, x, t, TRAIN_TILE)
    if not _bitwise(st, st2):
        raise AssertionError("train_nn --tile epoch: two launches differ")
    plan = dict(train_tile.plan)
    per_lock = _tile_barriers(w, st, TRAIN_TILE)
    n_iter = st[:, 2].cpu().numpy()
    lanes, lock = int(n_iter.sum()), _lockstep(n_iter, TRAIN_TILE)
    if lanes != tile_e2e["iters"]:
        raise AssertionError(f"train_nn --tile epoch replay: {lanes} "
                             f"lane-iterations, train_nn printed "
                             f"{tile_e2e['iters']}")
    bound_ms, bound_by, flops = _tile_bound(w, False, lock, lanes, "f64",
                                            xs.shape[0])
    rate = lanes / ms * 1e3
    b1_rate = epoch["iters"] / epoch["ms"] * 1e3
    log(f"train_nn --tile {TRAIN_TILE} epoch on the card: {ms:.1f} ms "
        f"device time (first launch {first_ms:.1f} ms), {lock} lockstep "
        f"iterations ({ms * 1e3 / lock:.2f} us each), {lanes} "
        f"lane-iterations ({rate:.0f} a second; the per-sample kernel on "
        f"the same files: {b1_rate:.0f} iterations a second, "
        f"{rate / b1_rate:.2f}x) on {plan['blocks']} blocks x "
        f"{plan['warps']} warps, {'resident' if plan['resident'] else 'staged'}"
        f" W_0, {plan['smem_bytes']} shared bytes a block, {per_lock:g} grid "
        f"barriers a lockstep iteration; bound "
        f"{bound_ms * 1e3 / lock:.4f} us/lockstep iteration ({bound_by}, "
        f"{flops / lock:.0f} flops a lockstep iteration)")
    return {"ms": ms, "first_ms": first_ms, "lockstep": lock,
            "lane_iters": lanes, "us_per_lockstep": ms * 1e3 / lock,
            "lane_iters_per_s": rate, "b1_iters_per_s": b1_rate,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_us_per_lockstep": bound_ms * 1e3 / lock, "plan": plan,
            "barriers_per_lockstep": per_lock}


def phase_tile_auto(e2e, tuned, tile_epoch):
    """Phase 12's epoch, on the same files, at each tile ``--tile auto``
    tries (tile 32's from ``tile_epoch``, the others one launch each): the
    epoch's device time and lane-iterations a second, so the probe's
    choice is held to what wins on a real epoch."""
    import torch

    from hpnn_tpu_torch.models.kernel import weights_to_torch
    from hpnn_tpu_torch.ops.autotune import _DEFAULT_TILES

    nn, xs, ts = _epoch_inputs(e2e["root"])
    w = weights_to_torch(nn.kernel.weights, torch.float64, "cuda")
    x, t = _to_card(xs, torch.float64), _to_card(ts, torch.float64)
    epochs = {}
    for tile in _DEFAULT_TILES:
        if tile == TRAIN_TILE:
            epochs[tile] = {k: tile_epoch[k] for k in (
                "ms", "lockstep", "lane_iters", "us_per_lockstep",
                "lane_iters_per_s")}
            continue
        ms, st = _tile_epoch(w, x, t, tile)
        n_iter = st[:, 2].cpu().numpy()
        lanes, lock = int(n_iter.sum()), _lockstep(n_iter, tile)
        epochs[tile] = {"ms": ms, "lockstep": lock, "lane_iters": lanes,
                        "us_per_lockstep": ms * 1e3 / lock,
                        "lane_iters_per_s": lanes / ms * 1e3}
    chosen = int(tuned["tile"])
    fastest = min(epochs, key=lambda k: epochs[k]["ms"])
    ratio = epochs[chosen]["ms"] / epochs[fastest]["ms"]
    log("train_nn epoch by tile, on phase 12's files: " + "; ".join(
        f"tile {k}: {e['ms']:.1f} ms, {e['lockstep']} lockstep iterations "
        f"({e['us_per_lockstep']:.2f} us each), {e['lane_iters']} "
        f"lane-iterations ({e['lane_iters_per_s']:.0f} a second)"
        for k, e in epochs.items())
        + f". The autotuner chose tile {chosen}; the fastest epoch is tile "
        f"{fastest}" + (" (the probe's choice wins)" if chosen == fastest
                        else f" ({ratio:.2f}x faster than the probe's "
                             "choice)"))
    return {"tile": chosen, "fastest_tile": fastest,
            "by_tile": {str(k): e for k, e in epochs.items()},
            **{k: epochs[chosen][k] for k in ("ms", "lockstep", "lane_iters",
                                              "us_per_lockstep",
                                              "lane_iters_per_s")}}


def phase_autotune(tmp):
    """``--tile auto`` on the card: the autotuner times its candidates at
    phase 12's width and type (MNIST ANN BP f64), with its cache in a fresh
    directory; a second call must be a cache hit that measures nothing."""
    import torch

    from hpnn_tpu_torch.ops import autotune

    shapes = ((MNIST[1][0], MNIST[0]), (MNIST[2], MNIST[1][0]))
    saved = {k: os.environ.pop(k, None)
             for k in ("HPNN_AUTOTUNE_CACHE", "HPNN_NO_AUTOTUNE")}
    os.environ["HPNN_AUTOTUNE_CACHE"] = os.path.join(tmp, "autotune")
    try:
        autotune.clear_memo()
        t0 = time.perf_counter()
        dec = autotune.decide_tile(shapes, torch.float64, "ANN", False,
                                   device="cuda")
        wall = time.perf_counter() - t0
        autotune.clear_memo()   # a fresh process over the same cache file
        again = autotune.decide_tile(shapes, torch.float64, "ANN", False,
                                     device="cuda")
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    if dec["source"] != "measured" or again["source"] != "cache" \
            or (again["tile"], again["storage"]) != (dec["tile"],
                                                     dec["storage"]):
        raise AssertionError(f"autotune: {dec} then {again}")
    log(f"autotune (--tile auto) at MNIST ANN BP f64: tile {dec['tile']}, "
        f"storage {dec['storage']}, route {dec['route']}, measured in "
        f"{wall:.2f} s (lane-iterations a second: "
        + ", ".join(f"{k} {v:.0f}" for k, v in dec["cells"].items())
        + "); the second call was a cache hit")
    return {"tile": dec["tile"], "storage": dec["storage"],
            "route": dec["route"], "cells": dec["cells"], "wall_s": wall}


# --- phase 13: fused_bpm_update --------------------------------------------

def _bpm_arrays(rng, n, m):
    """w, dw, d, h of one seeded (n, m) update, float64 numpy."""
    return (rng.uniform(-1, 1, (n, m)) / np.sqrt(m),
            rng.uniform(-1e-3, 1e-3, (n, m)), rng.uniform(-1, 1, n),
            rng.uniform(0, 1, m))


def _bpm_sets(first, n, m, item):
    """``first`` and copies of it on the card, as many as make the inputs
    of consecutive calls span BPM_COLD_BYTES (twice the L2): a call finds
    none of its inputs in L2."""
    count = max(2, -(-BPM_COLD_BYTES // ((2 * n * m + n + m) * item)))
    return [first] + [tuple(v.clone() for v in first)
                      for _ in range(count - 1)]


def _rotating_ms(calls, runs=5):
    """Device time of one call when consecutive calls take consecutive
    entries of ``calls`` (cold caches): the median over ``runs`` of a
    back-to-back run of up to BPM_COLD_RUN launches between two CUDA
    events, behind a GPU spin long enough for the host to queue them."""
    import torch

    launches = min(max(len(calls), 10), BPM_COLD_RUN)
    for call in calls[:3]:
        call()
    torch.cuda.synchronize()
    times, k = [], 0
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES + launches * SPIN_PER_LAUNCH)
        start.record()
        for _ in range(launches):
            calls[k % len(calls)]()
            k += 1
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def _bpm_bound_ms(n, m, item):
    """The byte bound: w, dw, d, h read and w', dw' written once."""
    return (4 * n * m + n + m) * item / HBM_BYTES_PER_S * 1e3


def phase_bpm():
    """``fused_bpm_update`` against its plain version, bit for bit, at every
    shape and dtype; its warm time (back-to-back calls on the same
    buffers), cold time (calls rotating over inputs twice the L2), the
    empty kernel's floor in the same loop, and the byte bound."""
    import torch

    from hpnn_tpu_torch.ops.kernels import (empty_launch, fused_bpm_update,
                                            fused_bpm_update_plain)

    rng = np.random.default_rng(13)
    lr, alpha = 0.0005, 0.2
    floor_ms = _device_ms(lambda: empty_launch("cuda"))
    cells = []
    for n, m in BPM_SHAPES:
        arrays = _bpm_arrays(rng, n, m)
        for dname in ("f64", "f32"):
            dt = _dtypes()[dname]
            item = 8 if dname == "f64" else 4
            first = tuple(_to_card(a, dt) for a in arrays)
            before = tuple(v.clone() for v in first)
            got = fused_bpm_update(*first, lr, alpha)
            plan = fused_bpm_update.plan
            want = fused_bpm_update_plain(*first, lr, alpha)
            torch.cuda.synchronize()
            if not (_bitwise(got, want) and _bitwise(first, before)):
                err = max(float((a.double() - b.double()).abs().max())
                          for a, b in zip(got, want))
                raise AssertionError(f"fused_bpm_update {n}x{m} {dname}: "
                                     f"not bit-identical to the plain "
                                     f"version (max diff {err:.3e}), or "
                                     "an input changed")
            del got, want, before
            ms = _device_ms(lambda: fused_bpm_update(*first, lr, alpha))
            plain_ms = _device_ms(
                lambda: fused_bpm_update_plain(*first, lr, alpha))
            sets = _bpm_sets(first, n, m, item)
            cold_ms = _rotating_ms(
                [lambda v=v: fused_bpm_update(*v, lr, alpha) for v in sets])
            del sets
            bound_ms = _bpm_bound_ms(n, m, item)
            cells.append({"shape": f"{n}x{m}", "dtype": dname,
                          "max_abs_err": 0.0, "ms": ms, "cold_ms": cold_ms,
                          "floor_ms": floor_ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": "bytes",
                          "plan": plan._asdict()})
            log(f"fused_bpm_update {n}x{m} {dname}: bit-identical to plain; "
                f"warm ms={ms:.5f} cold ms={cold_ms:.5f} "
                f"floor ms={floor_ms:.5f} plain_ms={plain_ms:.5f} "
                f"bound_ms={bound_ms:.5f} (bytes, {bound_ms / cold_ms:.0%} "
                f"of it cold); plan {tuple(plan)}")
    return cells


# --- phase 16: train_nn --epochs -------------------------------------------

def _train_epochs(root, extra, env=None):
    """``train_nn -v -v --epochs 3`` (plus ``extra``) on the card in
    ``root``, with the launch counts set to 0 just before it; returns the
    run's stream, kernel.opt, wall time, launches and EPOCH_METRICS."""
    from hpnn_tpu_torch import api, cli
    from hpnn_tpu_torch.ops.convergence_kernel import train_epoch_kernel
    from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile
    from hpnn_tpu_torch.ops.kernels import fused_bpm_update, fused_linear_act

    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    cwd = os.getcwd()
    os.chdir(root)
    try:
        api.reset_epoch_metrics()
        for fn in (train_epoch_kernel, train_tile, fused_linear_act,
                   fused_bpm_update):
            fn.launches = 0
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.train_nn_main(["-v", "-v", "--device", "cuda",
                                    "--epochs", str(EPOCHS), *extra,
                                    "nn.conf"])
        wall = time.perf_counter() - t0
        launches = {"train_epoch": train_epoch_kernel.launches,
                    "train_tile": train_tile.launches,
                    "fused_linear_act": fused_linear_act.launches,
                    "fused_bpm_update": fused_bpm_update.launches}
        with open("kernel.opt") as fp:
            opt = fp.read()
    finally:
        os.chdir(cwd)
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rc != 0:
        raise AssertionError(f"train_nn --epochs {EPOCHS} {extra}: rc={rc}"
                             f"\n{err.getvalue()[-2000:]}")
    return {"out": out.getvalue(), "err": err.getvalue(), "opt": opt,
            "wall_s": wall, "launches": launches,
            "metrics": dict(api.EPOCH_METRICS)}


def phase_train_epochs(e2e):
    """``train_nn --epochs 3`` on phase 9's files and conf, per sample and
    at ``--tile 32``: the epoch kernel launched once an epoch, one int32
    permutation uploaded an epoch, the stream and kernel.opt byte-identical
    to the ``HPNN_NO_EPOCH_PIPELINE=1`` route on the card, each epoch's
    device time beside the run's wall time, and ``run_nn`` of kernel.opt
    at 80% PASS or more."""
    from hpnn_tpu_torch import cli
    from hpnn_tpu_torch.ops.kernels import fused_linear_act

    runs = {}
    for tag, extra, kernel in (("per-sample", (), "train_epoch"),
                               (f"tile {TRAIN_TILE}",
                                ("--tile", str(TRAIN_TILE)), "train_tile")):
        restage = _train_epochs(e2e["root"], extra,
                                {"HPNN_NO_EPOCH_PIPELINE": "1"})
        res = _train_epochs(e2e["root"], extra)   # the path: counts from 0
        met = res["metrics"]
        if met["mode"] != "resident" or met["epochs"] != EPOCHS \
                or met["h2d_bytes"] != EPOCHS * TRAIN_FILES * 4:
            raise AssertionError(f"train_nn --epochs {EPOCHS} ({tag}): "
                                 f"EPOCH_METRICS {met}")
        if len(met["device_ms"]) != EPOCHS:
            raise AssertionError(f"train_nn --epochs {EPOCHS} ({tag}): "
                                 f"{len(met['device_ms'])} epoch times")
        n_iter = res["out"].count("N_ITER=")
        if n_iter != EPOCHS * TRAIN_FILES:
            raise AssertionError(f"train_nn --epochs {EPOCHS} ({tag}): "
                                 f"{n_iter} lines with N_ITER")
        if restage["metrics"]["mode"] != "restage":
            raise AssertionError(f"HPNN_NO_EPOCH_PIPELINE=1 ({tag}): "
                                 f"{restage['metrics']}")
        for part in ("out", "err", "opt"):
            if res[part] != restage[part]:
                raise AssertionError(f"train_nn --epochs {EPOCHS} ({tag}): "
                                     f"the resident route's {part} differs "
                                     "from the restaging route's")
        cwd = os.getcwd()
        os.chdir(e2e["root"])
        try:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc, outs = cli.run_nn(["-v", "-v", "--device", "cuda",
                                       "run.conf"])
        finally:
            os.chdir(cwd)
        n_pass = out.getvalue().count("[PASS]")
        if rc != 0 or outs is None or not np.all(np.isfinite(outs)) \
                or n_pass < 0.8 * TRAIN_FILES:
            raise AssertionError(f"run_nn after --epochs ({tag}): rc={rc}, "
                                 f"PASS {n_pass}/{TRAIN_FILES}")
        # the path's counts, read after its run_nn
        got = dict(res["launches"], fused_linear_act=fused_linear_act.launches)
        other = "train_tile" if kernel == "train_epoch" else "train_epoch"
        if got[kernel] != EPOCHS or got[other] != 0 \
                or got["fused_linear_act"] <= 0:
            raise AssertionError(f"train_nn --epochs {EPOCHS} ({tag}) + "
                                 f"run_nn: launches {got}, want {kernel} "
                                 f"{EPOCHS}, {other} 0, fused_linear_act > 0")
        iters = [sum(int(v) for v in re.findall(r"N_ITER=\s*(\d+)", block))
                 for block in res["out"].split("EPOCH ")[1:]]
        runs[tag] = {"launches": got, "wall_s": res["wall_s"],
                     "opt_sha256": hashlib.sha256(
                         res["opt"].encode()).hexdigest(),
                     "restage_wall_s": restage["wall_s"],
                     "epoch_device_ms": met["device_ms"],
                     "epoch_iters": iters,
                     "h2d_bytes": met["h2d_bytes"],
                     "setup_h2d_bytes": met["setup_h2d_bytes"],
                     "restage_h2d_bytes": restage["metrics"]["h2d_bytes"],
                     "stage_s": met["stage_s"], "shuffle_s": met["shuffle_s"],
                     "pass": n_pass}
        log(f"train_nn --epochs {EPOCHS} ({tag}) + run_nn: {kernel} "
            f"launched {got[kernel]} times, fused_linear_act "
            f"{got['fused_linear_act']}; epochs' device time "
            + ", ".join(f"{ms:.1f}" for ms in met["device_ms"])
            + f" ms ({', '.join(map(str, iters))} iterations); wall "
            f"{res['wall_s']:.2f} s (restaging route {restage['wall_s']:.2f} "
            f"s); H2D {met['h2d_bytes']} bytes over the epochs and "
            f"{met['setup_h2d_bytes']} once (restaging "
            f"{restage['metrics']['h2d_bytes']}); stream and kernel.opt "
            f"byte-identical to the restaging route; run_nn PASS "
            f"{n_pass}/{TRAIN_FILES}")
    return runs


# --- phase 17: train_nn --resume -------------------------------------------

def _ckpt_train(cwd, argv, env=None):
    """``train_nn -v -v --device cuda`` (plus ``argv``) in ``cwd`` with
    every launch count set to 0 just before it; returns the run's stream,
    kernel.opt's sha256, wall time, launches and EPOCH_METRICS."""
    from hpnn_tpu_torch import api, cli
    from hpnn_tpu_torch.ops.convergence_kernel import train_epoch_kernel
    from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile
    from hpnn_tpu_torch.ops.kernels import fused_bpm_update, fused_linear_act

    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    here = os.getcwd()
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    try:
        api.reset_epoch_metrics()
        for fn in (train_epoch_kernel, train_tile, fused_linear_act,
                   fused_bpm_update):
            fn.launches = 0
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.train_nn_main(["-v", "-v", "--device", "cuda", *argv])
        wall = time.perf_counter() - t0
        launches = {"train_epoch": train_epoch_kernel.launches,
                    "train_tile": train_tile.launches,
                    "fused_linear_act": fused_linear_act.launches,
                    "fused_bpm_update": fused_bpm_update.launches}
        with open("kernel.opt", "rb") as fp:
            sha = hashlib.sha256(fp.read()).hexdigest()
    finally:
        os.chdir(here)
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rc != 0:
        raise AssertionError(f"train_nn {argv} in {cwd}: rc={rc}\n"
                             f"{err.getvalue()[-2000:]}")
    return {"out": out.getvalue(), "err": err.getvalue(), "sha": sha,
            "wall_s": wall, "launches": launches,
            "metrics": dict(api.EPOCH_METRICS)}


def _ckpt_run_nn(cwd, argv):
    """``run_nn -v -v --device cuda`` (plus ``argv``) in ``cwd``: (rc,
    outputs, stdout)."""
    from hpnn_tpu_torch import cli

    here = os.getcwd()
    os.chdir(cwd)
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc, outs = cli.run_nn(["-v", "-v", "--device", "cuda", *argv])
    finally:
        os.chdir(here)
    return rc, outs, out.getvalue()


def _ckpt_dir_check(ck, rep, tag, generation, blobs):
    """Three bundles, each passing ``verify_bundle``; the manifest at
    ``generation`` with ``ep00000003`` latest; ``blobs`` replicas in
    ``rep``.  Returns each bundle's bytes."""
    from hpnn_tpu_torch import ckpt
    from hpnn_tpu_torch.ckpt.replicate import read_scope_index, scope_for

    tags = sorted(t for t in os.listdir(ck) if t.startswith("ep"))
    want = [ckpt.snapshot_tag(e) for e in range(1, EPOCHS + 1)]
    if tags != want:
        raise AssertionError(f"{tag}: bundles {tags}, want {want}")
    sizes = {}
    for t in tags:
        ok, reason = ckpt.verify_bundle(os.path.join(ck, t))
        if not ok:
            raise AssertionError(f"{tag}: {t} fails verify_bundle: {reason}")
        sizes[t] = {f: os.path.getsize(os.path.join(ck, t, f))
                    for f in (ckpt.SNAPSHOT_KERNEL, ckpt.SNAPSHOT_STATE,
                              ckpt.SNAPSHOT_META)}
    man = ckpt.read_manifest(ck)
    if man["generation"] != generation or man["latest"] != want[-1]:
        raise AssertionError(f"{tag}: manifest generation "
                             f"{man['generation']} latest {man['latest']}, "
                             f"want {generation} and {want[-1]}")
    index = read_scope_index(os.path.join(rep, scope_for(ck)))
    n_blobs = len([f for f in os.listdir(os.path.join(rep, scope_for(ck)))
                   if f.endswith(".bundle")])
    if len(index) != blobs or n_blobs != blobs:
        raise AssertionError(f"{tag}: {n_blobs} replica blobs, "
                             f"{len(index)} indexed, want {blobs}")
    return sizes


def _flip_digit(path):
    """Change the last weight digit of a kernel file (it still loads)."""
    with open(path, "rb") as fp:
        data = bytearray(fp.read())
    i = max(i for i, c in enumerate(data) if chr(c).isdigit())
    data[i] = ord("1") if data[i] != ord("1") else ord("2")
    with open(path, "wb") as fp:
        fp.write(bytes(data))


def phase_ckpt_resume(e2e, epochs_runs):
    """``train_nn --resume`` on phase 9's files and conf, per sample and at
    ``--tile 32``: (1) ``--epochs 3 --ckpt-every 1 --ckpt-dir ck
    --replicate-to rep``; (2) the same killed at epoch 1
    (``HPNN_CKPT_KILL_AT_EPOCH``), resumed with ``--resume`` in the same
    directory; (3) its ``ck`` deleted and resumed again with
    ``--replicate-to rep``, which restores epoch 1 from the replica.
    kernel.opt of every run equals phase 16's checkpointing-off run's;
    each resumed stream from EPOCH 2 on equals run 1's, the killed one is
    its prefix; the epoch kernel launched 3 times in run 1, 1 + 2 across
    the kill and the resume, 2 in the replica resume, always resident;
    every bundle verified, the manifests and replicas counted; then
    ``run_nn --ckpt-dir ck`` of the resumed kernel.opt (>= 80% PASS, no
    fingerprint warning) and of the same file with one digit changed (the
    warning, naming both paths).  Records the wall times beside phase 16's
    and the bundles' bytes."""
    from hpnn_tpu_torch import ckpt

    src = e2e["root"]
    out = {}
    for tag, extra, kernel in (("per-sample", (), "train_epoch"),
                               (f"tile {TRAIN_TILE}",
                                ("--tile", str(TRAIN_TILE)), "train_tile")):
        other = "train_tile" if kernel == "train_epoch" else "train_epoch"
        root = os.path.join(src, "ckpt-" + tag.replace(" ", ""))
        os.makedirs(root)
        conf = os.path.join(root, "nn.conf")
        with open(os.path.join(src, "nn.conf")) as fp:
            text = fp.read().replace("./samples", os.path.join(src, "samples"))
        text = text.replace("./tests", os.path.join(src, "tests"))
        with open(conf, "w") as fp:
            fp.write(text)
        run_conf = os.path.join(root, "run.conf")
        with open(run_conf, "w") as fp:
            fp.write(text.replace("[init] generate", "[init] kernel.opt"))
        full_dir, part_dir = os.path.join(root, "full"), \
            os.path.join(root, "part")
        argv = ["--epochs", str(EPOCHS), "--ckpt-every", "1", "--ckpt-dir",
                "ck", "--replicate-to", "rep", *extra, conf]
        resume = ["--epochs", str(EPOCHS), "--resume", "--ckpt-dir", "ck",
                  *extra, conf]
        full = _ckpt_train(full_dir, argv)
        kill = _ckpt_train(part_dir, argv,
                           {"HPNN_CKPT_KILL_AT_EPOCH": str(KILL_AT)})
        res = _ckpt_train(part_dir, resume)
        shutil.rmtree(os.path.join(part_dir, "ck"))
        rep_res = _ckpt_train(part_dir, [*resume[:-1], "--replicate-to",
                                         "rep", conf])
        # (a) one trajectory, with or without snapshots and a kill
        want = epochs_runs[tag]["opt_sha256"]
        for name, run in (("run 1", full), ("the resume", res),
                          ("the replica resume", rep_res)):
            if run["sha"] != want:
                raise AssertionError(f"phase 17 ({tag}): {name}'s kernel.opt "
                                     "differs from phase 16's run's")
        # (b), (c) the streams
        mark = f"NN: EPOCH {2:8d}/{EPOCHS:8d}\n"
        tail = full["out"][full["out"].index(mark):]
        for name, run in (("the resume", res),
                          ("the replica resume", rep_res)):
            if mark not in run["out"] or \
                    run["out"][run["out"].index(mark):] != tail:
                raise AssertionError(f"phase 17 ({tag}): {name}'s stream "
                                     "from EPOCH 2 differs from run 1's")
        stop = "NN: CKPT: interrupted at epoch"
        if stop not in kill["out"] or not full["out"].startswith(
                kill["out"][:kill["out"].index(stop)]):
            raise AssertionError(f"phase 17 ({tag}): the killed run's stream "
                                 "is not a prefix of run 1's")
        # (d) launches and the route
        counts = [(name, run["launches"][kernel], n)
                  for name, run, n in (("run 1", full, EPOCHS),
                                       ("the killed run", kill, KILL_AT),
                                       ("the resume", res, EPOCHS - KILL_AT),
                                       ("the replica resume", rep_res,
                                        EPOCHS - KILL_AT))]
        for name, got, n in counts:
            if got != n:
                raise AssertionError(f"phase 17 ({tag}): {kernel} launched "
                                     f"{got} times in {name}, want {n}")
        for name, run in (("run 1", full), ("the killed run", kill),
                          ("the resume", res), ("the replica resume",
                                                rep_res)):
            if run["launches"][other] != 0 \
                    or run["metrics"]["mode"] != "resident":
                raise AssertionError(f"phase 17 ({tag}): {name}: launches "
                                     f"{run['launches']}, EPOCH_METRICS "
                                     f"{run['metrics']}")
        # (e) the checkpoint dirs: run 1's three snapshots and its final
        # stamp; the replica resume's restored epoch 1, 2 and 3 and stamp
        sizes = _ckpt_dir_check(os.path.join(full_dir, "ck"),
                                os.path.join(full_dir, "rep"),
                                f"{tag} run 1", EPOCHS + 1, EPOCHS)
        _ckpt_dir_check(os.path.join(part_dir, "ck"),
                        os.path.join(part_dir, "rep"),
                        f"{tag} replica resume", EPOCHS, EPOCHS)
        man = ckpt.read_manifest(os.path.join(part_dir, "ck"))
        if man["final_fingerprint"] != "sha256:" + rep_res["sha"]:
            raise AssertionError(f"phase 17 ({tag}): the manifest's final "
                                 "fingerprint is not kernel.opt's")
        # (f) run_nn's staleness guard, on the resumed kernel.opt
        rc, outs, text = _ckpt_run_nn(part_dir, ["--ckpt-dir", "ck",
                                                 run_conf])
        n_pass = text.count("[PASS]")
        if rc != 0 or outs is None or not np.all(np.isfinite(outs)) \
                or n_pass < 0.8 * TRAIN_FILES or "fingerprint" in text:
            raise AssertionError(f"phase 17 ({tag}): run_nn --ckpt-dir ck: "
                                 f"rc={rc}, PASS {n_pass}/{TRAIN_FILES}, "
                                 f"warned: {'fingerprint' in text}")
        kpath = os.path.join(part_dir, "kernel.opt")
        shutil.copyfile(kpath, kpath + ".orig")
        _flip_digit(kpath)
        rc, _, text = _ckpt_run_nn(part_dir, ["--ckpt-dir", "ck", run_conf])
        os.replace(kpath + ".orig", kpath)
        warn = (f"NN(WARN): kernel fingerprint mismatch: {kpath} does not "
                f"match the manifest {os.path.join(part_dir, 'ck')}"
                "/manifest.json (stale or modified weights?)\n")
        if rc != 0 or warn not in text:
            raise AssertionError(f"phase 17 ({tag}): run_nn of a changed "
                                 f"kernel.opt: rc={rc}, no warning")
        off = epochs_runs[tag]["wall_s"]
        bundle = sum(sizes["ep00000001"].values())
        out[tag] = {
            "launches": {"run": full["launches"][kernel],
                         "killed": kill["launches"][kernel],
                         "resumed": res["launches"][kernel],
                         "replica_resumed": rep_res["launches"][kernel]},
            "wall_s": {"run": full["wall_s"], "no_ckpt": off,
                       "killed": kill["wall_s"], "resumed": res["wall_s"],
                       "replica_resumed": rep_res["wall_s"]},
            "snapshot_cost_s": (full["wall_s"] - off) / EPOCHS,
            "epoch_device_ms": full["metrics"]["device_ms"],
            "bundle_bytes": sizes, "pass": n_pass,
            "fused_bpm_update": sum(r["launches"]["fused_bpm_update"]
                                    for r in (full, kill, res, rep_res))}
        log(f"train_nn --resume ({tag}): kernel.opt of run 1, the resume and "
            f"the replica resume identical to phase 16's; {kernel} launched "
            f"{full['launches'][kernel]}, {kill['launches'][kernel]} + "
            f"{res['launches'][kernel]}, {rep_res['launches'][kernel]}; wall "
            f"{full['wall_s']:.3f} s with a snapshot an epoch against "
            f"{off:.3f} s without (phase 16), "
            f"{(full['wall_s'] - off) / EPOCHS * 1e3:.1f} ms a snapshot; "
            f"killed run {kill['wall_s']:.3f} s, resume {res['wall_s']:.3f} "
            f"s, replica resume {rep_res['wall_s']:.3f} s; a bundle "
            f"{bundle} bytes ({', '.join(f'{k} {v}' for k, v in sizes['ep00000001'].items())}); "
            f"run_nn PASS {n_pass}/{TRAIN_FILES}, the fingerprint warning "
            "only on the changed kernel")
    return out


# --- phase 18: the corpus pipeline ------------------------------------------

# load mode -> (env, the mode load_ordered reports, native_io)
CORPUS_MODES = (("off", {"HPNN_NO_CORPUS_CACHE": "1", "HPNN_NO_PARALLEL_IO": "1",
                         "HPNN_NO_NATIVE_IO": "1"}, "serial", "off"),
                ("cold", {}, "parallel", "on"),
                ("warm", {}, "pack", "on"))


@contextlib.contextmanager
def _corpus_env(env):
    """``env`` set for the block (the native loader probed anew on entry
    and exit, as HPNN_NO_NATIVE_IO may change)."""
    from hpnn_tpu_torch.io import samples

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    samples._native_lib = None
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        samples._native_lib = None


def _corpus_run_nn(tag, topology, scale, seed, dtype, tmp):
    """``run_nn -v -v`` of a generated ANN kernel on a fresh 4096-file dir
    in each load mode: byte-identical streams, bit-identical outputs, and
    ``fused_linear_act`` launched each time (its count set to 0 just before
    each run, read just after)."""
    from hpnn_tpu_torch import cli
    from hpnn_tpu_torch.io import corpus
    from hpnn_tpu_torch.io.kernel_io import dump_kernel_to_path
    from hpnn_tpu_torch.models.kernel import generate_kernel
    from hpnn_tpu_torch.ops.kernels import fused_linear_act

    n_in, hid, n_out = topology
    tests = os.path.join(tmp, f"corpus_{tag}")
    t0 = time.perf_counter()
    _write_corpus(tests, n_in, n_out, scale, seed)
    write_s = time.perf_counter() - t0
    kern, _ = generate_kernel(seed, n_in, hid, n_out)
    kpath = os.path.join(tmp, f"corpus_{tag}_kernel.opt")
    dump_kernel_to_path(kern, kpath)
    conf = os.path.join(tmp, f"corpus_{tag}.conf")
    with open(conf, "w") as fp:
        fp.write(f"[name] corpus_{tag}\n[type] ANN\n[init] {kpath}\n"
                 f"[seed] 10958\n[input] {n_in}\n"
                 f"[hidden] {' '.join(map(str, hid))}\n[output] {n_out}\n"
                 f"[train] BP\n[test_dir] {tests}\n[dtype] {dtype}\n")
    if os.path.exists(corpus.pack_path(tests)):
        raise AssertionError(f"{tests}: a pack exists before the cold run")
    runs = {}
    for mode, env, want, native in CORPUS_MODES:
        with _corpus_env(env):
            fused_linear_act.launches = 0
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc, outs = cli.run_nn(["-v", "-v", "--device", "cuda", conf])
            wall = time.perf_counter() - t0
            launched = fused_linear_act.launches
        load = dict(corpus.LAST_LOAD)
        if rc != 0 or outs is None or outs.shape != (N_FILES, n_out) \
                or not np.all(np.isfinite(outs)):
            raise AssertionError(f"corpus run_nn {tag} ({mode}): rc={rc}")
        if load["mode"] != want or load["native_io"] != native \
                or load["rows"] != N_FILES:
            raise AssertionError(f"corpus run_nn {tag} ({mode}): load {load}"
                                 f", want {want}, native_io {native}")
        if launched <= 0:
            raise AssertionError(f"corpus run_nn {tag} ({mode}): "
                                 "fused_linear_act was not launched")
        runs[mode] = {"out": out.getvalue(), "outs": outs, "wall_s": wall,
                      "load_s": load["seconds"], "launches": launched}
    for mode in ("cold", "warm"):
        if runs[mode]["out"] != runs["off"]["out"]:
            raise AssertionError(f"corpus run_nn {tag}: the {mode} stream "
                                 "differs from the cache-off stream")
        if runs[mode]["outs"].tobytes() != runs["off"]["outs"].tobytes():
            raise AssertionError(f"corpus run_nn {tag}: the {mode} outputs "
                                 "differ from the cache-off outputs")
    pack = os.path.getsize(corpus.pack_path(tests))
    data = N_FILES * (n_in + n_out) * 8
    if pack < data:
        raise AssertionError(f"corpus {tag}: pack of {pack} bytes < data "
                             f"region {data}")
    log(f"corpus run_nn {tag} ({n_in}-{'-'.join(map(str, hid))}-{n_out} ANN "
        f"{dtype}, {N_FILES} files written in {write_s:.2f} s): "
        + "; ".join(f"{m} load {r['load_s']:.3f} s, wall {r['wall_s']:.2f} s"
                    f", launches {r['launches']}" for m, r in runs.items())
        + f"; streams byte-identical, outputs bit-identical; pack {pack} "
        f"bytes (data region {data})")
    return {"pack_bytes": pack, "data_bytes": data, "write_s": write_s,
            **{m: {k: r[k] for k in ("load_s", "wall_s", "launches")}
               for m, r in runs.items()}}


def phase_corpus(e2e, tmp):
    """The corpus pipeline on the card (run after phase 17): the native
    loader on; MNIST 784-300-10 ANN f64 and XRD 851-230-230 ANN f32
    ``run_nn`` in three load modes; ``train_nn --epochs 3`` on phase 9's
    files warm against ``HPNN_NO_CORPUS_CACHE=1`` (kernel.opt and streams
    byte-identical, each epoch's device time both ways) with the test
    dir's pack removed first, so that the warm run's prefetch builds it
    during the epochs; then ``run_nn`` of kernel.opt loads from that
    pack."""
    from hpnn_tpu_torch import api, cli
    from hpnn_tpu_torch.io import corpus, samples
    from hpnn_tpu_torch.ops.kernels import fused_linear_act

    with _corpus_env({}):
        if os.environ.get("HPNN_NO_NATIVE_IO") \
                or samples.native_io_status() != "on":
            raise AssertionError("the native sample loader is not on")
    res = {"run_nn": {
        "mnist": _corpus_run_nn("mnist", MNIST, "pixel", 1801, "f64", tmp),
        "xrd": _corpus_run_nn("xrd", XRD, "unit", 1802, "f32", tmp)}}
    root = e2e["root"]
    samples_dir = os.path.join(root, "samples")
    tests_dir = os.path.join(root, "tests")
    off = _train_epochs(root, (), {"HPNN_NO_CORPUS_CACHE": "1"})
    off_load = dict(corpus.LAST_LOAD)
    corpus.prefetch_pack_async(samples_dir, MNIST[0], MNIST[2]).join()
    if os.path.exists(corpus.pack_path(tests_dir)):
        os.unlink(corpus.pack_path(tests_dir))
    warm = _train_epochs(root, ())
    warm_load = dict(corpus.LAST_LOAD)
    if api._prefetch_thread is not None:
        api._prefetch_thread.join()
    for part in ("out", "err", "opt"):
        if warm[part] != off[part]:
            raise AssertionError(f"train_nn --epochs {EPOCHS}: the warm "
                                 f"run's {part} differs from the cache-off "
                                 "run's")
    if off_load["mode"] != "parallel" or warm_load["mode"] != "pack":
        raise AssertionError(f"train_nn --epochs {EPOCHS} loads: off "
                             f"{off_load}, warm {warm_load}")
    for r in (off, warm):
        if r["launches"]["train_epoch"] != EPOCHS \
                or len(r["metrics"]["device_ms"]) != EPOCHS:
            raise AssertionError(f"train_nn --epochs {EPOCHS}: launches "
                                 f"{r['launches']}, epochs' device times "
                                 f"{r['metrics']['device_ms']}")
    if not os.path.isfile(corpus.pack_path(tests_dir)):
        raise AssertionError("the warm run's prefetch left no pack of the "
                             "test dir")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        fused_linear_act.launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc, outs = cli.run_nn(["-v", "-v", "--device", "cuda",
                                   "run.conf"])
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    run_load = dict(corpus.LAST_LOAD)
    n_pass = out.getvalue().count("[PASS]")
    if rc != 0 or outs is None or run_load["mode"] != "pack" \
            or fused_linear_act.launches <= 0 or n_pass < 0.8 * TRAIN_FILES:
        raise AssertionError(f"run_nn after the prefetch: rc={rc}, load "
                             f"{run_load}, launches "
                             f"{fused_linear_act.launches}, PASS {n_pass}")
    res["train_nn_epochs"] = {
        m: {"wall_s": r["wall_s"], "epoch_device_ms": r["metrics"]
            ["device_ms"], "load_s": ld["seconds"], "load_mode": ld["mode"],
            "stage_s": r["metrics"]["stage_s"]}
        for m, r, ld in (("off", off, off_load), ("warm", warm, warm_load))}
    res["run_nn_after_prefetch"] = {"load_s": run_load["seconds"],
                                    "wall_s": wall, "pass": n_pass,
                                    "pack_bytes": os.path.getsize(
                                        corpus.pack_path(tests_dir))}
    log(f"train_nn --epochs {EPOCHS} on {TRAIN_FILES} files: cache off "
        f"(load {off_load['seconds']:.3f} s, {off_load['mode']}) epochs' "
        "device time " + ", ".join(f"{ms:.1f}" for ms in
                                   off["metrics"]["device_ms"])
        + f" ms, wall {off['wall_s']:.2f} s; warm (load "
        f"{warm_load['seconds']:.3f} s, pack; the test dir prefetched during "
        "the epochs) " + ", ".join(f"{ms:.1f}" for ms in
                                   warm["metrics"]["device_ms"])
        + f" ms, wall {warm['wall_s']:.2f} s; kernel.opt and streams "
        f"byte-identical; run_nn after it: load {run_load['seconds']:.3f} s "
        f"(pack), wall {wall:.2f} s, PASS {n_pass}/{TRAIN_FILES}")
    return res


# --- phase 19 ---------------------------------------------------------------

SERVE_CLIENTS = 8            # phase 19: client threads
SERVE_ROWS = (1, 3, 64)      # phase 19: request sizes, cycled
SERVE_POOL = 4096            # phase 19: distinct input rows a model
SERVE_TOKEN = "T"            # phase 19: serve_nn --auth-token
SERVE_WATCH_S = 0.2          # phase 19: --watch-interval
SHRUNK = (784, [100], 10)    # phase 19: the topology-changing reload


def _http(base, path, payload, headers=None, method="POST"):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _dump_generated(path, topology, seed):
    from hpnn_tpu_torch.io.kernel_io import dump_kernel_to_path
    from hpnn_tpu_torch.models.kernel import generate_kernel

    n_in, hid, n_out = topology
    dump_kernel_to_path(generate_kernel(seed, n_in, hid, n_out)[0], path)


def _serve_conf(path, name, kernel, topology, dtype):
    n_in, hid, n_out = topology
    with open(path, "w") as fp:
        fp.write(f"[name] {name}\n[type] ANN\n[init] {kernel}\n"
                 f"[seed] 10958\n[input] {n_in}\n"
                 f"[hidden] {' '.join(map(str, hid))}\n[output] {n_out}\n"
                 f"[train] BP\n[dtype] {dtype}\n")


def _strict_pool(kernel_file, dtype, pool):
    """The strict forward of a kernel file's weights over the whole input
    pool on the card (one B=4096 call a layer; phase 14 holds rows of such
    a call bit for bit against every batch size the server uses)."""
    import torch

    from hpnn_tpu_torch.io.kernel_io import load_kernel
    from hpnn_tpu_torch.models.kernel import weights_to_torch
    from hpnn_tpu_torch.ops.kernels import batched_forward_fused

    w = weights_to_torch(load_kernel(kernel_file).weights, dtype, "cuda")
    x = torch.as_tensor(pool, dtype=torch.float64).cuda().to(dtype)
    return batched_forward_fused(w, x, "ANN").double().cpu().numpy()


def phase_serve_rest(e2e, tmp, card):
    """``serve_nn`` with generations, hot reload, A/B pinning, QoS lanes
    and the full metrics on the card, while ``train_nn --epochs 3
    --ckpt-every 1`` streams its snapshots into it (run after phase 18).
    Every answer must be bit-identical to the strict forward of the
    weights its generation label names; ``fused_linear_act`` must launch
    2 times a batch ``/metrics`` counts."""
    import torch

    from hpnn_tpu_torch import cli
    from hpnn_tpu_torch.ckpt import read_manifest
    from hpnn_tpu_torch.ops.kernels import fused_linear_act
    from hpnn_tpu_torch.serve.server import serve_in_thread

    root = os.path.join(tmp, "serve_rest")
    os.makedirs(root)
    for sub in ("samples", "tests"):
        os.symlink(os.path.join(e2e["root"], sub), os.path.join(root, sub))
    shutil.copy(os.path.join(e2e["root"], "nn.conf"), root)
    ck = os.path.join(root, "ck")
    mnist0 = os.path.join(root, "mnist0.opt")
    shutil.copy(os.path.join(e2e["root"], "kernel.opt"), mnist0)
    xrd_k = os.path.join(root, "xrd.opt")
    _dump_generated(xrd_k, XRD, 851)
    shrunk = os.path.join(root, "shrunk.opt")
    _dump_generated(shrunk, SHRUNK, 7)
    _serve_conf(os.path.join(root, "mnist.conf"), "mnist", mnist0, MNIST,
                "f64")
    _serve_conf(os.path.join(root, "xrd.conf"), "xrd", xrd_k, XRD, "f32")
    rng = np.random.default_rng(19)
    pools = {"mnist": _inputs(rng, SERVE_POOL, MNIST[0], "pixel"),
             "xrd": _inputs(rng, SERVE_POOL, XRD[0], "unit")}
    dtypes = {"mnist": torch.float64, "xrd": torch.float32}
    # generation -> the kernel file it served, copied when it loaded
    gen_files = {"mnist": {1: mnist0}, "xrd": {1: xrd_k}}
    swaps, reloads = [], {"busy": 0, "t_end": 0.0}

    fused_linear_act.launches = 0          # phase 19's path from here
    app, _ = cli.serve_app([
        "-p", "0", "--device", "cuda", "--no-warmup", "-b", "64", "-q",
        str(64 * SERVE_CLIENTS),
        "--ab-fraction", "0.25", "--watch-ckpt", f"mnist={ck}",
        "--watch-interval", str(SERVE_WATCH_S), "--auth-token", SERVE_TOKEN,
        os.path.join(root, "mnist.conf"), os.path.join(root, "xrd.conf")])
    if app is None:
        raise AssertionError("serve_nn (phase 19): no app")
    model = app.registry.get("mnist")
    real_reload, real_swap = app.reload_model, model.swap_kernel

    def reload_model(name, kernel_path=None, **kw):
        reloads["busy"] += 1
        try:
            res = real_reload(name, kernel_path, **kw)
            # copy what loaded at once, so the check reads those bytes
            keep = os.path.join(root, f"{name}-gen{res['generation']}.opt")
            shutil.copy(res["source"], keep)
            gen_files[name][res["generation"]] = keep
            return res
        finally:
            reloads["busy"] -= 1
            reloads["t_end"] = time.monotonic()

    def swap_kernel(*a, **kw):
        t0 = time.perf_counter()
        res = real_swap(*a, **kw)
        swaps.append(time.perf_counter() - t0)
        return res

    app.reload_model, model.swap_kernel = reload_model, swap_kernel
    httpd, th = serve_in_thread(app, "127.0.0.1", 0)
    base = "http://%s:%d" % httpd.server_address[:2]
    answers, failures = [], []
    stop = threading.Event()

    def client(i):
        name = "xrd" if i >= SERVE_CLIENTS - 2 else "mnist"
        k = i
        while not stop.is_set():
            rows = SERVE_ROWS[k % len(SERVE_ROWS)]
            lo = (97 * k + 31 * i) % (SERVE_POOL - rows)
            k += 1
            st, body = _http(base, f"/v1/kernels/{name}/infer",
                             {"inputs": pools[name][lo:lo + rows].tolist()})
            if st != 200:
                failures.append((name, st, body))
                return
            answers.append((name, lo, rows, body["generation"],
                            np.asarray(body["outputs"], np.float64)))

    trainer = None
    log_path = os.path.join(root, "train_nn.log")
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(SERVE_CLIENTS)]
        t_traffic = time.perf_counter()
        for t in threads:
            t.start()
        with open(log_path, "w") as logf:
            trainer = subprocess.Popen(
                [sys.executable, "-m", "hpnn_tpu_torch.cli", "train_nn",
                 "-v", "-v", "--device", "cuda", "--epochs", str(EPOCHS),
                 "--ckpt-every", "1", "--ckpt-keep", "3", "--ckpt-dir", ck,
                 "nn.conf"], cwd=root, stdout=logf, stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONPATH=ROOT))
            rc = trainer.wait(timeout=300)
        t_trained = time.monotonic()
        if rc != 0:
            raise AssertionError(f"train_nn (phase 19): rc={rc}\n"
                                 + open(log_path).read()[-2000:])
        # the watcher has caught up once no reload is running and a few
        # poll periods passed since the run's last manifest write
        end = time.monotonic() + 60
        while time.monotonic() < end and (
                reloads["busy"] or time.monotonic() - max(
                    t_trained, reloads["t_end"]) < 4 * SERVE_WATCH_S):
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=120)
            if t.is_alive():
                raise AssertionError("serve (phase 19): a client hung")
        traffic_s = time.perf_counter() - t_traffic
        if failures:
            raise AssertionError(f"serve (phase 19): non-200 answers "
                                 f"{failures[:3]}")
        manifest = read_manifest(ck)
        table = model.generation_table()
        snap0 = app.metrics.snapshot()
        if snap0["reloads"]["error"] or not table["retained"]:
            raise AssertionError(f"serve (phase 19): reloads "
                                 f"{snap0['reloads']}, table {table}")
        checks = []

        def infer(name, lo, rows, headers=None, want=200):
            st, body = _http(base, f"/v1/kernels/{name}/infer",
                             {"inputs": pools[name][lo:lo + rows].tolist()},
                             headers)
            if st != want:
                raise AssertionError(f"serve (phase 19) {headers}: status "
                                     f"{st}, wanted {want}: {body}")
            if st == 200:
                answers.append((name, lo, rows, body["generation"],
                                np.asarray(body["outputs"], np.float64)))
            return body

        # a pinned retained generation answers with its own weights
        old = table["retained"][0]
        body = infer("mnist", 5, 3, {"X-HPNN-Generation": str(old)})
        if body["generation"] != old:
            raise AssertionError(f"pin {old} answered generation "
                                 f"{body['generation']}")
        checks.append(f"pin {old} -> {old}")
        body = infer("mnist", 5, 3, {"X-HPNN-Generation": "999"}, want=404)
        checks.append(f"pin 999 -> 404 {body['reason']}")
        reload_url = "/v1/kernels/mnist/reload"
        auth = {"Authorization": f"Bearer {SERVE_TOKEN}"}
        st, body = _http(base, reload_url, {})
        if st != 401:
            raise AssertionError(f"reload without the token: {st}")
        checks.append("reload without token -> 401")
        gen_before = model.generation
        st, body = _http(base, reload_url,
                         {"kernel": os.path.join(root, "missing.opt")}, auth)
        if st != 409 or model.generation != gen_before:
            raise AssertionError(f"reload of a bad path: {st} {body}")
        body = infer("mnist", 7, 64)
        checks.append(f"bad path -> 409; generation {gen_before} still "
                      "answers")
        # QoS lanes: a paused batcher dispatches high, normal, low
        b = app.batchers["mnist"]
        lanes, real_dispatch = [], b.backend.dispatch

        def dispatch(xs, gen=None, deadline=None, lane=None):
            lanes.append(lane)
            return real_dispatch(xs, gen=gen, deadline=deadline, lane=lane)

        b.backend.dispatch = dispatch
        b.pause()
        qos_threads = []
        for n, prio in enumerate(("low", "normal", "high")):
            t = threading.Thread(target=infer, args=(
                "mnist", 64 * n, 64, {"X-HPNN-Priority": prio}))
            t.start()
            qos_threads.append(t)
            end = time.monotonic() + 30
            while b.depth() < 64 * (n + 1) and time.monotonic() < end:
                time.sleep(0.005)
        b.resume()
        for t in qos_threads:
            t.join(timeout=60)
        b.backend.dispatch = real_dispatch
        if lanes != [0, 1, 2]:
            raise AssertionError(f"paused batcher dispatched lanes {lanes}"
                                 ", wanted high, normal, low")
        checks.append("low/normal/high queued -> dispatched high first")
        before = fused_linear_act.launches
        body = infer("mnist", 0, 1, {"X-HPNN-Deadline-Ms": "0"}, want=504)
        if fused_linear_act.launches != before:
            raise AssertionError("an expired deadline launched the kernel")
        checks.append(f"expired deadline -> 504 {body['reason']}, no launch")
        # a topology-changing reload serves the new shape
        st, body = _http(base, reload_url, {"kernel": shrunk}, auth)
        if st != 200 or not body["topology_changed"] \
                or body["topology"] != [SHRUNK[0], *SHRUNK[1], SHRUNK[2]]:
            raise AssertionError(f"topology-changing reload: {st} {body}")
        body = infer("mnist", 11, 3)
        if body["generation"] != model.generation:
            raise AssertionError("the new topology is not what answers")
        checks.append(f"reload to {'-'.join(map(str, model.topology))} "
                      f"-> generation {model.generation} serves it")
        snap = app.metrics.snapshot()
        launches = fused_linear_act.launches   # the path ends here
    finally:
        stop.set()
        if trainer is not None and trainer.poll() is None:
            trainer.kill()
            trainer.wait()
        httpd.shutdown()
        httpd.server_close()
        app.close(drain=True)
        th.join(timeout=60)
    if launches != 2 * snap["batches_total"]:
        raise AssertionError(f"fused_linear_act launched {launches} times "
                             f"for {snap['batches_total']} batches")
    # every answer against the strict forward of its generation's file
    refs, n_gens = {}, {}
    for name, lo, rows, gen, outs in answers:
        key = (name, gen)
        if key not in refs:
            refs[key] = _strict_pool(gen_files[name][gen], dtypes[name],
                                     pools[name])
        n_gens[key] = n_gens.get(key, 0) + 1
        if not np.array_equal(outs, refs[key][lo:lo + rows]):
            raise AssertionError(f"serve (phase 19): {name} generation "
                                 f"{gen} rows {lo}:{lo + rows} not "
                                 "bit-identical to its strict forward")
    phases = {p: {"p50_ms": h["p50_ms"], "p99_ms": h["p99_ms"],
                  "count": h["count"]} for p, h in snap["phases"].items()}
    res = {"requests": len(answers), "traffic_s": traffic_s,
           "requests_per_s": len(answers) / traffic_s,
           "answers_by_generation": {f"{n} {g}": c
                                     for (n, g), c in sorted(n_gens.items())},
           "manifest_generation": manifest["generation"],
           "reloads": snap["reloads"], "swap_s": swaps,
           "batches": snap["batches_total"], "launches": launches,
           "batch_fill_ratio": snap["batch_fill_ratio"],
           "latency": {k: snap["latency"][k] for k in ("p50_ms", "p99_ms")},
           "phases": phases, "checks": checks}
    log(f"serve_nn rest (phase 19): {len(answers)} answers over "
        f"{len(n_gens)} (kernel, generation) pairs, all 200 and "
        "bit-identical to the strict forward of their generation "
        f"({res['answers_by_generation']}); manifest generation "
        f"{manifest['generation']}, reloads {snap['reloads']}; swap "
        + ", ".join(f"{s * 1e3:.2f}" for s in swaps) + " ms; "
        f"{res['requests_per_s']:.1f} requests/s over {traffic_s:.2f} s; "
        f"batches {snap['batches_total']}, fused_linear_act launches "
        f"{launches} (2 a batch); fill {snap['batch_fill_ratio']}; "
        + "; ".join(checks))
    log(f"serve_nn rest (phase 19) p50/p99 ms ({card}): request "
        f"{snap['latency']['p50_ms']}/{snap['latency']['p99_ms']}, "
        + ", ".join(f"{p} {v['p50_ms']}/{v['p99_ms']}"
                    for p, v in sorted(phases.items())))
    return res


# --- phase 20: the batched trainers ----------------------------------------

BATCH_FILES = 4096          # phase 20: the [batch] runs' corpora
CG_LIMIT = {"f64": 1e-9, "f32": 1e-2}   # batched search vs transcription
DIST_LIMIT_S = 120          # phase 20: each gloo rank's time limit


def _b_conf(root, kind, train, topology, samples, extra=""):
    """A generated-kernel conf over ``samples`` (an absolute dir) in
    ``root``, with no test dir (so no run prefetches one beside its
    epochs)."""
    n_in, hid, n_out = topology
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "nn.conf"), "w") as fp:
        fp.write(f"[name] batched\n[type] {kind}\n[init] generate\n"
                 f"[seed] 10958\n[input] {n_in}\n"
                 f"[hidden] {' '.join(map(str, hid))}\n[output] {n_out}\n"
                 f"[train] {train}\n[sample_dir] {samples}\n{extra}")
    return root


def _dp_replay(samples, bsz):
    """The [batch] BPM epoch of MNIST f64 alone on the card (no CLI, no
    other thread), median of 3 between CUDA events: (device ms, host ms
    of the launches)."""
    import torch

    from hpnn_tpu_torch.io.corpus import load_resident
    from hpnn_tpu_torch.io.samples import list_sample_dir
    from hpnn_tpu_torch.models.kernel import generate_kernel
    from hpnn_tpu_torch.parallel import dp

    rc = load_resident(samples, list_sample_dir(samples), 784, 10)
    kern, _ = generate_kernel(10958, 784, [300], 10)
    shapes = tuple(tuple(w.shape) for w in kern.weights)
    nb = rc.n_rows // bsz
    x = _to_card(np.asarray(rc.X[:nb * bsz]), torch.float64)
    t = _to_card(np.asarray(rc.T[:nb * bsz]), torch.float64)
    xb, tb = x.view(nb, bsz, -1), t.view(nb, bsz, -1)
    mb = torch.ones(nb, bsz, dtype=torch.float64, device="cuda")
    w = dp.dp_resident_carry([_to_card(v, torch.float64)
                              for v in kern.weights])
    got = []
    for _ in range(4):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        dp.dp_epoch(w, xb, tb, mb, "ANN", True, 0.0005, 0.2, shapes)
        end.record()
        host = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        got.append((start.elapsed_time(end), host))
    return sorted(got[1:])[1]


def _cg_module(tag, kind, dtype, xs, ts):
    """One CG epoch (8 iterations) of the generated MNIST kernel on the
    card, with the batched line search under
    ``set_sync_debug_mode("error")`` and with the transcribed one: device
    time of each, and the weights held to CG_LIMIT."""
    import torch

    from hpnn_tpu_torch.models.kernel import generate_kernel
    from hpnn_tpu_torch.train import cg

    kern, _ = generate_kernel(10958, 784, [300], 10)
    dt = _dtypes()[dtype]
    shapes = tuple(tuple(w.shape) for w in kern.weights)
    flat = torch.cat([_to_card(w, dt).reshape(-1) for w in kern.weights])
    x, t = _to_card(xs, dt), _to_card(ts, dt)
    z = torch.zeros_like(flat)

    def run(plain):
        args = (flat, z, z.clone(), torch.tensor(False, device="cuda"),
                torch.tensor(0, dtype=torch.int32, device="cuda"), x, t,
                kind, shapes, 8)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if not plain:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = cg.cg_epoch(*args, plain=plain)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        end.record()
        end.synchronize()
        return start.elapsed_time(end), out

    run(False)                                  # warm the libraries
    ms, dev = run(False)
    plain_ms, pl = run(True)
    scale = max(1.0, float(pl[0].abs().max()))
    err = float((dev[0] - pl[0]).abs().max())
    e0, e1 = float(dev[3]), float(dev[4])
    if not (err <= CG_LIMIT[dtype] * scale and np.isfinite(e1) and e1 <= e0):
        raise AssertionError(f"CG {tag}: batched vs transcribed search "
                             f"{err:.3e} (limit {CG_LIMIT[dtype]} x "
                             f"{scale:g}), E0 {e0} E1 {e1}")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "bitwise": bool(torch.equal(dev[0], pl[0])), "E0": e0, "E1": e1}


def phase_batched(e2e, tmp):
    """Phase 20: the CG trainer, [batch] data parallelism, [batch]+[tile],
    HPNN_DISTRIBUTED and their kill + --resume, on the card."""
    import torch

    from hpnn_tpu_torch.ops.convergence_tile import (train_epoch_tiled,
                                                     train_epoch_tiled_plain)
    from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile
    from hpnn_tpu_torch.models.kernel import weights_to_torch
    from hpnn_tpu_torch.train import cg

    root = os.path.join(tmp, "batched")
    mnist512 = os.path.join(e2e["root"], "samples")
    res = {"cg": {}, "dp": {}, "tile": {}, "dist": {}, "resume": {},
           "part_wall_s": {}}
    t_part = [time.perf_counter()]

    def done(name):
        now = time.perf_counter()
        res["part_wall_s"][name] = now - t_part[0]
        t_part[0] = now
    # --- CG: batched search vs transcription, then train_nn --trainer cg.
    # The MNIST bars scaled to [0, 1] (pixel / 255): at pixel scale a
    # probe saturates hidden units past exp's range, and the autograd of
    # the literal 2/(1+exp(-x))-1 is then 0 * inf = NaN -- in the JAX
    # package's jax.value_and_grad as in torch (measured on the CPU, both
    # packages NaN after one epoch); SNN and the native LNN take 0/1
    # targets (with -1 targets the SNN loss has no lower bound)
    xs, ts, labels = _bar_corpus(TRAIN_FILES, MNIST, tuple(range(10)), 5)
    xs = np.round(xs / 255.0, 1)
    cg_dirs = {"pm1": (ts, os.path.join(root, "cg_pm1")),
               "01": ((ts + 1.0) / 2.0, os.path.join(root, "cg_01"))}
    for cts, d in cg_dirs.values():
        _write_samples(d, xs, cts, labels)
    cg_cases = (("mnist ANN f64", "ANN", "f64", "", "pm1"),
                ("mnist SNN f64", "SNN", "f64", "", "01"),
                ("mnist LNN-native f64", "LNN", "f64", "[lnn] native\n",
                 "01"),
                ("mnist ANN f32", "ANN", "f32", "[dtype] f32\n", "pm1"))
    for tag, kind, dtype, extra, tgt in cg_cases:
        cts, cdir = cg_dirs[tgt]
        mod = _cg_module(tag, kind, dtype, xs, cts)
        cwd = _b_conf(os.path.join(root, "cg", tag.replace(" ", "_")),
                      kind, "CG", MNIST, cdir, extra)
        cg.CG_METRICS.update(epochs=0, iters=0, device_ms=[])
        run = _ckpt_train(cwd, ["--trainer", "cg", "--epochs", str(EPOCHS),
                                "nn.conf"], {"HPNN_CG_SYNC_DEBUG": "error"})
        lines = re.findall(r"E0=\s*(\S+) E1=\s*(\S+)", run["out"])
        if len(lines) != EPOCHS or len(cg.CG_METRICS["device_ms"]) != EPOCHS \
                or not all(np.isfinite(float(b)) and float(b) <= float(a)
                           for a, b in lines):
            raise AssertionError(f"train_nn --trainer cg ({tag}): {lines}, "
                                 f"{cg.CG_METRICS}")
        dms = list(cg.CG_METRICS["device_ms"])
        res["cg"][tag] = {**mod, "epoch_device_ms": dms,
                          "ms_per_iter": [m / 8 for m in dms],
                          "evals_per_iter": cg.EVALS_PER_ITER,
                          "wall_s": run["wall_s"],
                          "E": [[float(a), float(b)] for a, b in lines]}
        log(f"CG {tag}: batched search {mod['ms']:.2f} ms an epoch of 8 "
            f"iterations with no host synchronisation, transcribed "
            f"{mod['plain_ms']:.2f} ms, weights "
            f"{'bit-identical' if mod['bitwise'] else 'within'} "
            f"({mod['max_abs_err']:.3e}); train_nn --trainer cg --epochs "
            f"{EPOCHS}: epochs' device time "
            + ", ".join(f"{m:.2f}" for m in dms) + f" ms "
            f"({dms[-1] / 8:.3f} ms an iteration, {cg.EVALS_PER_ITER} loss "
            f"evaluations an iteration), E1 {lines[-1][1]}")
    done("cg")
    # --- [batch] B on 4096 files
    dirs = {}
    for name, topo, classes, seed in (("mnist", MNIST, tuple(range(10)), 7),
                                      ("xrd", XRD, tuple(range(230)), 8)):
        bx, bt, bl = _bar_corpus(BATCH_FILES, topo, classes, seed)
        dirs[name] = os.path.join(root, f"{name}{BATCH_FILES}")
        _write_samples(dirs[name], bx, bt, bl)
    done("write_4096")
    for corpus, topo, dtype in (("mnist", MNIST, "f64"),
                                ("mnist", MNIST, "bf16"),
                                ("xrd", XRD, "f32")):
        for bsz in (32, 128):
            for train in ("BP", "BPM"):
                tag = f"{corpus} {dtype} batch {bsz} {train}"
                cwd = _b_conf(os.path.join(root, "dp", tag.replace(" ", "_")),
                              "ANN", train, topo, dirs[corpus],
                              f"[batch] {bsz}\n[dtype] {dtype}\n")
                run = _ckpt_train(cwd, ["--epochs", str(EPOCHS), "nn.conf"])
                met = run["metrics"]
                nb = -(-BATCH_FILES // bsz)
                errs = [float(v) for v in
                        re.findall(r"TRAINING BATCH\s+\d+\t err=\s*(\S+)",
                                   run["out"])]
                if met["mode"] != "dp-resident" \
                        or met["h2d_bytes"] != EPOCHS * nb * bsz * 4 \
                        or len(met["device_ms"]) != EPOCHS \
                        or len(errs) != EPOCHS * nb \
                        or not np.all(np.isfinite(errs)) \
                        or sum(run["launches"].values()) != 0:
                    raise AssertionError(f"[batch] {tag}: {met}, "
                                         f"{len(errs)} batch lines, "
                                         f"launches {run['launches']}")
                dms = met["device_ms"]
                res["dp"][tag] = {
                    "epoch_device_ms": dms, "wall_s": run["wall_s"],
                    "samples_per_s": BATCH_FILES * EPOCHS / sum(dms) * 1e3,
                    "h2d_bytes": met["h2d_bytes"],
                    "setup_h2d_bytes": met["setup_h2d_bytes"],
                    "first_err": errs[0], "last_epoch_mean_err":
                        float(np.mean(errs[-nb:]))}
                log(f"[batch] {tag}: epochs' device time "
                    + ", ".join(f"{m:.1f}" for m in dms) + " ms = "
                    f"{res['dp'][tag]['samples_per_s']:.0f} samples/s; "
                    f"H2D {met['h2d_bytes']} bytes over the epochs (the "
                    f"slot maps) and {met['setup_h2d_bytes']} once; wall "
                    f"{run['wall_s']:.2f} s")
                if tag == "mnist f64 batch 32 BPM":
                    re_run = _ckpt_train(cwd, ["--epochs", str(EPOCHS),
                                               "nn.conf"],
                                         {"HPNN_NO_EPOCH_PIPELINE": "1"})
                    if (re_run["out"], re_run["sha"]) != (run["out"],
                                                          run["sha"]):
                        raise AssertionError(f"[batch] {tag}: the restaging "
                                             "route differs")
                    res["dp"][tag]["restage_wall_s"] = re_run["wall_s"]
    replay_ms, replay_host = _dp_replay(dirs["mnist"], 32)
    res["dp_replay"] = {"cell": "mnist f64 batch 32 BPM, one epoch",
                        "ms": replay_ms, "host_ms": replay_host}
    log(f"[batch] mnist f64 batch 32 BPM epoch alone on the card: "
        f"{replay_ms:.1f} ms between events, {replay_host:.1f} ms of host "
        "launches (median of 3)")
    done("dp")
    # --- [batch] 32 + [tile] T: launches, invariance, the plain version
    tile_root = _b_conf(os.path.join(root, "tile"), "ANN", "BP", MNIST,
                        mnist512, "[batch] 32\n")
    groups = -(-TRAIN_FILES // 32)
    tile_runs = {}
    for t in (4, 1):
        run = _ckpt_train(tile_root, ["--epochs", "2", "--tile", str(t),
                                      "nn.conf"])
        want = 2 * -(-groups // t)
        if run["launches"]["train_tile"] != want \
                or run["launches"]["train_epoch"] != 0 \
                or run["out"].count("N_ITER=") != 2 * TRAIN_FILES:
            raise AssertionError(f"[batch] 32 --tile {t}: launches "
                                 f"{run['launches']}, want train_tile {want}")
        tile_runs[t] = run
    if (tile_runs[4]["out"], tile_runs[4]["sha"]) != (tile_runs[1]["out"],
                                                      tile_runs[1]["sha"]):
        raise AssertionError("[batch] 32: --tile 4 and --tile 1 differ")
    nn, exs, ets = _epoch_inputs(tile_root)
    w = weights_to_torch(nn.kernel.weights, torch.float64, "cuda")
    x, t = _to_card(exs, torch.float64), _to_card(ets, torch.float64)
    train_tile.launches = 0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    wk, sk = train_epoch_tiled(w, x, t, "ANN", False, tile=32,
                               launch_groups=4, defer_stats=True)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    tile_launches = train_tile.launches
    wp, sp = train_epoch_tiled_plain(w, x, t, "ANN", False, tile=32)
    werr, dn = _check_train("[batch] 32 tile 4", "f64", sk, sp, wk, wp,
                            name="train_tile", scaled=True)
    lane_iters = int(sk[:, 2].sum().item())
    iters_cli = sum(int(v) for v in re.findall(
        r"N_ITER=\s*(\d+)", tile_runs[4]["out"].split("EPOCH ")[1]))
    if iters_cli != lane_iters:
        raise AssertionError(f"[batch] 32 tile 4: train_nn's first epoch "
                             f"ran {iters_cli} lane iterations, the replay "
                             f"{lane_iters}")
    bitwise = _bitwise(tuple(wk), tuple(wp)) and _bitwise(sk, sp)
    res["tile"] = {"launches": {t: r["launches"]["train_tile"]
                                for t, r in tile_runs.items()},
                   "replay_launches": tile_launches, "epoch_ms": ms,
                   "lane_iters": lane_iters,
                   "lane_iters_per_s": lane_iters / ms * 1e3,
                   "max_abs_err": werr, "bitwise": bitwise}
    log(f"[batch] 32 + --tile 4 / --tile 1: train_tile launched "
        f"{tile_runs[4]['launches']['train_tile']} / "
        f"{tile_runs[1]['launches']['train_tile']} times in 2 epochs, "
        f"streams and kernel.opt identical; the epoch replayed in "
        f"{tile_launches} launches: {ms:.1f} ms, {lane_iters} lane "
        f"iterations = {lane_iters / ms * 1e3:.0f} lane-iterations/s, "
        f"against train_epoch_tiled_plain "
        f"{'bit-identical' if bitwise else f'within {werr:.3e}'}")
    done("tile")
    # --- HPNN_DISTRIBUTED: world 1 on NCCL, 2 gloo ranks, the bailout
    dist_root = _b_conf(os.path.join(root, "dist"), "ANN", "BPM", MNIST,
                        mnist512, "[batch] 32\n")
    argv = ["-v", "-v", "-v", "--epochs", "2", "nn.conf"]
    one = _ckpt_train(dist_root, argv)
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    nccl = _ckpt_train(dist_root, argv, {
        "HPNN_DISTRIBUTED": "1", "HPNN_COORDINATOR": f"127.0.0.1:{port}",
        "HPNN_NUM_PROCESSES": "1", "HPNN_PROCESS_ID": "0"})
    strip = lambda o: "".join(ln for ln in o.splitlines(True)   # noqa: E731
                              if not ln.startswith("NN(DBG):"))
    if "rank 0 of 1 (nccl)" not in nccl["out"] \
            or strip(nccl["out"]) != strip(one["out"]) \
            or nccl["sha"] != one["sha"]:
        raise AssertionError("HPNN_DISTRIBUTED=1 at world 1 on NCCL is not "
                             "bit-identical to one process")
    with open(os.path.join(dist_root, "kernel.opt")) as fp:
        ref = fp.read()
    gloo = _gloo_ranks(2, dist_root, ["-v", "-v", "--epochs", "2"])
    with open(os.path.join(dist_root, "kernel.opt")) as fp:
        got = fp.read()
    gerr = _kernel_diff(ref, got)
    batch_lines = lambda o: re.findall(r"TRAINING BATCH[^\n]*", o)  # noqa
    if any(r[0] != 0 for r in gloo) or gerr > 1e-11 \
            or batch_lines(gloo[0][1]) != batch_lines(one["out"]):
        raise AssertionError(f"2 gloo ranks: rcs {[r[0] for r in gloo]}, "
                             f"weights {gerr:.3e} from one process")
    bad = os.path.join(dist_root, "bad.conf")
    with open(os.path.join(dist_root, "nn.conf")) as fp:
        text = fp.read()
    with open(bad, "w") as fp:
        fp.write(text.replace(mnist512, mnist512 + "_missing"))
    t0 = time.perf_counter()
    bail = _gloo_ranks(2, dist_root, ["-v", "-v"], confs=["nn.conf",
                                                          "bad.conf"])
    bail_s = time.perf_counter() - t0
    if any(r[0] == 0 for r in bail) or "coordinated bailout" not in bail[0][2]:
        raise AssertionError(f"a missing sample dir on rank 1: rcs "
                             f"{[r[0] for r in bail]}")
    res["dist"] = {"nccl_world1_bitwise": True, "gloo2_max_abs_err": gerr,
                   "bailout_s": bail_s}
    log(f"HPNN_DISTRIBUTED: world 1 on NCCL bit-identical to one process; "
        f"2 gloo CPU ranks within {gerr:.3e} of the card's one process; a "
        f"missing sample dir on rank 1 ended both ranks non-zero in "
        f"{bail_s:.1f} s")
    done("dist")
    # --- kill at epoch 1 + --resume: CG and [batch] 32 BPM
    for tag, kind, train, extra, flags, sdir in (
            ("cg", "ANN", "CG", "", ["--trainer", "cg"],
             cg_dirs["pm1"][1]),
            ("batch 32 BPM", "ANN", "BPM", "[batch] 32\n", [], mnist512)):
        base = os.path.join(root, "resume", tag.replace(" ", "_"))
        ck = ["--epochs", str(EPOCHS), "--ckpt-every", "1", "--ckpt-dir",
              "ck", *flags, "nn.conf"]
        full = _ckpt_train(_b_conf(base + "_full", kind, train, MNIST,
                                   sdir, extra), ck)
        part = _b_conf(base + "_part", kind, train, MNIST, sdir, extra)
        _ckpt_train(part, ck, {"HPNN_CKPT_KILL_AT_EPOCH": str(KILL_AT)})
        resumed = _ckpt_train(part, ["--epochs", str(EPOCHS), "--resume",
                                     "--ckpt-dir", "ck", *flags, "nn.conf"])
        if resumed["sha"] != full["sha"]:
            raise AssertionError(f"--resume ({tag}): kernel.opt differs from "
                                 "the uninterrupted run's")
        res["resume"][tag] = {"full_wall_s": full["wall_s"],
                              "resume_wall_s": resumed["wall_s"]}
        log(f"kill at epoch {KILL_AT} + --resume ({tag}): kernel.opt "
            f"byte-identical to the uninterrupted run; wall "
            f"{resumed['wall_s']:.2f} s (uninterrupted {full['wall_s']:.2f})")
    done("resume")
    log("phase 20 wall by part: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in res["part_wall_s"].items()))
    return res


TP_WARN = "NN(WARN): [model] 2 > 1 visible device(s); using 1\n"
TP_FILES = 64              # phase 21: the per-sample gloo run's files
TP_SERVE_BUCKETS = (1, 3, 64)
TP_LIMIT = {"f64": 1e-12, "f32": 1e-5}   # tp@K answers vs the strict tier


def _tp_train(cwd, argv, base, launches, tag):
    """A phase 21 ``train_nn`` at world 1 (the counts set to 0 just before
    it): the clamp warning once an epoch before that epoch's lines, the
    stream without it equal to ``base``'s, and ``train_epoch`` launched
    ``launches`` times."""
    run = _ckpt_train(cwd, argv)
    warn = run["out"].count(TP_WARN)
    epochs = max(1, run["out"].count("EPOCH "))
    got = run["launches"]
    if warn != epochs or run["out"].index(TP_WARN) > run["out"].index(
            "TRAINING FILE") or got["train_epoch"] != launches \
            or got["train_tile"] != 0:
        raise AssertionError(f"{tag}: {warn} clamp warnings in {epochs} "
                             f"epoch(s), launches {got}")
    if base is not None and (run["out"].replace(TP_WARN, "") != base["out"]
                             or run["sha"] != base["sha"]):
        raise AssertionError(f"{tag}: the stream or kernel.opt differs from "
                             "the unsharded run's")
    return run


def _tp_serve(runs, results):
    """The tp@K serving tier on a LocalMesh of the one card repeated K
    times (every kernel over a zero budget): answers against the strict
    tier, each shard's first-layer rows against the full layer's, B2
    launches and device ms a batch beside the strict tier's."""
    import torch

    from hpnn_tpu_torch import ops
    from hpnn_tpu_torch.ops.kernels import fused_linear_act
    from hpnn_tpu_torch.parallel import LocalMesh, tp
    from hpnn_tpu_torch.serve.registry import ModelRegistry

    confs = {name: (conf, dtype) for name, conf, _, dtype, _ in runs}
    strict = ModelRegistry(max_batch=64, device="cuda")
    cells = {}
    old = {k: os.environ.get(k) for k in ("HPNN_EPOCH_DEVICE_BUDGET_MB",
                                          "HPNN_NO_TP_OVERLAP")}
    os.environ["HPNN_EPOCH_DEVICE_BUDGET_MB"] = "0"
    try:
        for name in ("mnist_ann_f64", "xrd_ann_f32"):
            conf, dtype = confs[name]
            ref_model = strict.register_conf(conf, name=name)
            xs = results[name][1]
            for k in (2, 4):
                mesh = LocalMesh([torch.device("cuda", 0)] * k)
                for sched in ("ring", "gather"):
                    if sched == "gather":
                        os.environ["HPNN_NO_TP_OVERLAP"] = "1"
                    else:
                        os.environ.pop("HPNN_NO_TP_OVERLAP", None)
                    reg = ModelRegistry(max_batch=64, device="cuda",
                                        tp_mesh=mesh)
                    m = reg.register_conf(conf, name=name)
                    if reg.route_for(m) != f"tp@{k}":
                        raise AssertionError(f"tp@{k} {name}: route "
                                             f"{reg.route_for(m)}")
                    tag = f"{name} tp@{k} {sched}"
                    cell = {"launches_per_batch": {}, "max_abs_err": 0.0,
                            "ms": {}, "strict_ms": {}}
                    for b in TP_SERVE_BUCKETS:
                        rows = xs[:b]
                        fused_linear_act.launches = 0   # the batch's path
                        h = reg.dispatch(m, rows)
                        got = reg.collect(h)
                        cell["launches_per_batch"][b] = \
                            fused_linear_act.launches
                        want = strict.forward(ref_model, rows)
                        err = float(np.abs(got - want).max())
                        if h.tier != f"tp@{k}" or not err <= TP_LIMIT[dtype]:
                            raise AssertionError(
                                f"{tag} B={b}: tier {h.tier}, {err:.3e} "
                                f"from the strict tier")
                        cell["max_abs_err"] = max(cell["max_abs_err"], err)
                        carry, _ = m.tp_weights(mesh)
                        dt = m.dtype
                        x = torch.as_tensor(rows).cuda().to(dt)
                        fn, _ = ops.select_run_batch(dt, device="cuda",
                                                     model_mesh=mesh)
                        # four calls a timed run: the spin covers their
                        # enqueue (2K + 2 launches and the adds each)
                        cell["ms"][b] = _device_ms(
                            lambda: fn(carry, x, m.kind), launches=4,
                            runs=10)
                        sw = ref_model.mlp.weights
                        sfn, _ = ops.select_run_batch(dt, device="cuda")
                        cell["strict_ms"][b] = _device_ms(
                            lambda: sfn(sw, x, m.kind), launches=4,
                            runs=10)
                    # a shard's first-layer block is the full layer's rows
                    w0 = ref_model.mlp.weights[0]
                    x = torch.as_tensor(xs[:64]).cuda().to(m.dtype)
                    full = fused_linear_act(w0, x, True)
                    blocks = torch.cat([fused_linear_act(s_[0], x, True)
                                        for s_ in carry.shards], dim=1)
                    if not torch.equal(blocks[:, :w0.shape[0]], full):
                        raise AssertionError(f"{tag}: a row block's rows "
                                             "differ from the full layer's")
                    cell["blocks_bitwise"] = True
                    cell["weight_bytes_per_shard"] = tp.carry_bytes(carry)
                    cells[tag] = cell
                    log(f"serve {tag}: answers within "
                        f"{cell['max_abs_err']:.3e} of the strict tier "
                        f"(limit {TP_LIMIT[dtype]:g}), row blocks "
                        f"bit-identical to the full layer's rows; "
                        f"fused_linear_act a batch "
                        f"{cell['launches_per_batch']}; device ms a batch "
                        + ", ".join(f"B={b} {cell['ms'][b]:.4f} (strict "
                                    f"{cell['strict_ms'][b]:.4f})"
                                    for b in TP_SERVE_BUCKETS))
    finally:
        for kk, v in old.items():
            if v is None:
                os.environ.pop(kk, None)
            else:
                os.environ[kk] = v
    return cells


def phase_tp(e2e, tmp, runs, results, epochs_runs):
    """Phase 21: ``[model]`` row sharding.  At world 1 on the card the
    model axis clamps to one shard and the TP routes run the existing
    kernels; the tp@K serving tier puts K row blocks on the one card; 2
    and 4 gloo CPU ranks run the sharded engines against the card's one
    process."""
    from hpnn_tpu_torch import cli
    from hpnn_tpu_torch.ops.kernels import fused_linear_act

    res = {"train": {}, "run_nn": {}, "serve": {}, "gloo": {},
           "part_wall_s": {}}
    t_part = [time.perf_counter()]

    def done(name):
        now = time.perf_counter()
        res["part_wall_s"][name] = now - t_part[0]
        t_part[0] = now

    root = os.path.join(tmp, "tp")
    mnist512 = os.path.join(e2e["root"], "samples")
    # --- the card's one-process references of the gloo runs, then the
    # gloo ranks in the background (CPU only) while the card works.  The
    # per-sample run starts from a kernel trained on these files (the
    # one the earlier phases left), so its 64 samples take tens of
    # iterations each, not thousands: on the CPU every iteration pays
    # three collectives
    s64 = os.path.join(root, "samples64")
    os.makedirs(s64)
    for f in sorted(os.listdir(mnist512))[:TP_FILES]:
        shutil.copy(os.path.join(mnist512, f), s64)
    pre = os.path.join(root, "pre.opt")
    shutil.copy(os.path.join(e2e["root"], "kernel.opt"), pre)
    gloo = {}
    for tag, world, samples, extra, flags, init in (
            ("per-sample [model] 2", 2, s64, "[model] 2\n", [], pre),
            ("[batch] 32 x [model] 2", 4, mnist512,
             "[batch] 32\n[model] 2\n", ["--epochs", "2"], None)):
        dirs = []
        for side in ("card", "gloo"):
            d = _b_conf(os.path.join(root, tag.replace(" ", "_") + side),
                        "ANN", "BP", MNIST, samples, extra)
            if init:
                path = os.path.join(d, "nn.conf")
                with open(path) as fp:
                    text = fp.read()
                with open(path, "w") as fp:
                    fp.write(text.replace("[init] generate",
                                          f"[init] {init}"))
            dirs.append(d)
        ref, cwd = dirs
        card = _ckpt_train(ref, [*flags, "nn.conf"])
        with open(os.path.join(ref, "kernel.opt")) as fp:
            card_opt = fp.read()
        t0 = time.perf_counter()
        procs = _gloo_start(world, cwd, ["-v", "-v", *flags])
        gloo[tag] = (world, cwd, card, card_opt, procs, t0)
    done("gloo_start")
    # --- train_nn at world 1: [model] 2, -S 2, --model-parallel 2
    here = e2e["root"]
    with open(os.path.join(here, "nn.conf")) as fp:
        conf = fp.read()
    with open(os.path.join(here, "tp.conf"), "w") as fp:
        fp.write(conf + "[model] 2\n")
    base = _ckpt_train(here, ["nn.conf"])
    iters = sum(int(v) for v in re.findall(r"N_ITER=\s*(\d+)", base["out"]))
    if base["launches"]["train_epoch"] != 1:
        raise AssertionError(f"phase 21's unsharded run: {base['launches']}")
    for tag, argv in (("[model] 2", ["tp.conf"]),
                      ("-S 2", ["-S", "2", "nn.conf"]),
                      ("--model-parallel 2",
                       ["--model-parallel", "2", "nn.conf"])):
        run = _tp_train(here, argv, base, 1, f"train_nn {tag}")
        res["train"][tag] = {"launches": run["launches"],
                             "wall_s": run["wall_s"],
                             "mode": run["metrics"]["mode"],
                             "tp_devices": run["metrics"]["tp_devices"]}
    ep = _tp_train(here, ["--epochs", str(EPOCHS), "tp.conf"], None, EPOCHS,
                   f"train_nn --epochs {EPOCHS} [model] 2")
    met = ep["metrics"]
    if met["mode"] != "tp-resident" or met["tp_devices"] != 1 \
            or ep["sha"] != epochs_runs["per-sample"]["opt_sha256"] \
            or len(met["device_ms"]) != EPOCHS:
        raise AssertionError(f"train_nn --epochs {EPOCHS} [model] 2: "
                             f"{met}, kernel.opt differs from phase 16's: "
                             f"{ep['sha'] != epochs_runs['per-sample']['opt_sha256']}")
    res["train"][f"--epochs {EPOCHS} [model] 2"] = {
        "launches": ep["launches"], "wall_s": ep["wall_s"],
        "mode": met["mode"], "tp_devices": met["tp_devices"],
        "epoch_device_ms": met["device_ms"],
        "weight_bytes_per_device": met["weight_bytes_per_device"]}
    log(f"train_nn [model] 2, -S 2, --model-parallel 2 at world 1: the "
        f"clamp warning, train_epoch launched once each, streams and "
        f"kernel.opt byte-identical to the unsharded run ({iters} "
        f"iterations; phase 9: {e2e['iters']}); --epochs {EPOCHS}: "
        f"{met['mode']}, tp_devices {met['tp_devices']}, train_epoch "
        f"{ep['launches']['train_epoch']} launches, epochs' device time "
        + ", ".join(f"{m:.1f}" for m in met["device_ms"])
        + " ms, kernel.opt byte-identical to phase 16's")
    done("train")
    # --- run_nn [model] 2: the warning, 2 B2 launches, phase 4's verdicts
    name = "mnist_ann_f64"
    conf_path = next(c for n, c, *_ in runs if n == name)
    with open(conf_path) as fp:
        text = fp.read()
    tp_conf = conf_path.replace(".conf", "_model2.conf")
    with open(tp_conf, "w") as fp:
        fp.write(text + "[model] 2\n")
    outs_txt = {}
    for tag, path in (("plain", conf_path), ("[model] 2", tp_conf)):
        fused_linear_act.launches = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc, outs = cli.run_nn(["-v", "-v", "--device", "cuda", path])
        outs_txt[tag] = (rc, outs, out.getvalue(),
                         fused_linear_act.launches)
    rc, outs, text_tp, launched = outs_txt["[model] 2"]
    if rc != 0 or launched != 2 or text_tp.count(TP_WARN) != 1 \
            or text_tp.replace(TP_WARN, "") != outs_txt["plain"][2] \
            or not np.array_equal(outs, results[name][0]):
        raise AssertionError(f"run_nn [model] 2: rc={rc}, launches "
                             f"{launched}, warning "
                             f"{text_tp.count(TP_WARN)}, outputs equal to "
                             f"phase 4's: "
                             f"{np.array_equal(outs, results[name][0])}")
    res["run_nn"] = {"launches": launched, "pass": text_tp.count("[PASS]")}
    log(f"run_nn [model] 2 ({name}): the clamp warning, fused_linear_act "
        f"launched {launched} times, verdict lines and outputs identical to "
        f"phase 4's (PASS {text_tp.count('[PASS]')}/{N_FILES})")
    done("run_nn")
    # --- the tp@K serving tier on one card
    res["serve"] = _tp_serve(runs, results)
    done("serve")
    # --- the gloo ranks against the card's one process
    for tag, (world, cwd, card, card_opt, procs, t0) in gloo.items():
        ranks = _gloo_wait(procs)
        wall = time.perf_counter() - t0
        with open(os.path.join(cwd, "kernel.opt")) as fp:
            got = fp.read()
        err = _kernel_diff(card_opt, got)
        limit = 1e-11 if "batch" in tag else 1e-12
        key = "TRAINING BATCH" if "batch" in tag else "TRAINING FILE"
        lines = lambda o: re.findall(key + r"[^\n]*", o)  # noqa: E731
        if any(r[0] != 0 for r in ranks) or err > limit \
                or lines(ranks[0][1]) != lines(card["out"]) \
                or not lines(card["out"]):
            raise AssertionError(
                f"{world} gloo ranks ({tag}): rcs {[r[0] for r in ranks]}, "
                f"weights {err:.3e} from the card (limit {limit:g}), lines "
                f"equal {lines(ranks[0][1]) == lines(card['out'])}\n"
                f"{ranks[0][2][-1500:]}")
        n_iter = sum(int(v) for v in re.findall(r"N_ITER=\s*(\d+)",
                                                ranks[0][1]))
        res["gloo"][tag] = {"world": world, "max_abs_err": err,
                            "wall_s": wall, "iters": n_iter,
                            "card_wall_s": card["wall_s"]}
        log(f"{world} gloo CPU ranks, {tag}: {key} lines equal to the "
            f"card's one process, kernel.opt within {err:.3e} (limit "
            f"{limit:g}); wall {wall:.1f} s from the ranks' start, "
            "process start and corpus load included"
            + (f" ({n_iter} iterations)" if n_iter else "")
            + f"; the card's one process {card['wall_s']:.2f} s")
    done("gloo_wait")
    log("phase 21 wall by part: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in res["part_wall_s"].items()))
    return res


def _kernel_diff(a: str, b: str) -> float:
    """Largest weight difference of two kernel texts."""
    va = np.array([float(v) for v in re.findall(r"-?\d+\.\d+", a)])
    vb = np.array([float(v) for v in re.findall(r"-?\d+\.\d+", b)])
    if va.shape != vb.shape:
        return float("inf")
    return float(np.abs(va - vb).max()) if va.size else 0.0


def _gloo_start(world, cwd, argv, confs=None):
    """Start ``train_nn --device cpu`` as ``world`` gloo ranks in ``cwd``
    (no card visible to them); :func:`_gloo_wait` collects them."""
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    procs = []
    for r in range(world):
        env = dict(os.environ, HPNN_DISTRIBUTED="1",
                   HPNN_COORDINATOR=f"127.0.0.1:{port}",
                   HPNN_NUM_PROCESSES=str(world), HPNN_PROCESS_ID=str(r),
                   HPNN_DIST_TIMEOUT_S="60", OMP_NUM_THREADS="2",
                   CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "hpnn_tpu_torch.cli", "train_nn", *argv,
             "--device", "cpu", confs[r] if confs else "nn.conf"],
            cwd=cwd, env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    return procs


def _gloo_wait(procs):
    """Each rank's (rc, stdout, stderr), each with a time limit; a rank
    past it is killed, and so are the others."""
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=DIST_LIMIT_S)
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _gloo_ranks(world, cwd, argv, confs=None):
    """``train_nn --device cpu`` as ``world`` gloo ranks in ``cwd``, each
    with a time limit: a list of (rc, stdout, stderr)."""
    return _gloo_wait(_gloo_start(world, cwd, argv, confs))


# --- phase 22: the jobs service -------------------------------------------

JOB_CLIENTS = 8             # phase 22: closed-loop client threads
JOB_ROWS = (1, 64)          # phase 22: request sizes, alternated
JOB_QUIET_S = 3.0           # phase 22: traffic alone, before job A
JOB_B_FILES = 64            # phase 22: job B's uploaded files
JOB_B_CHUNKS = 4            # phase 22: ... in this many chunks
JOB_B_EPOCHS = 2


def _post_body(base, path, body, ctype):
    req = urllib.request.Request(base + path, data=body,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _multipart(params, files, boundary="hpnnPhase22"):
    """A multipart/form-data body: an optional ``params`` JSON field and
    one part a (name, bytes) corpus file; returns (body, content type)."""
    parts = []
    if params is not None:
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="params"\r\n\r\n{json.dumps(params)}\r\n'
                     .encode())
    for name, data in files:
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="corpus"; filename="{name}"\r\n'
                     'Content-Type: application/octet-stream\r\n\r\n'
                     .encode() + data + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def _job_wait(base, jid, done=("done", "failed", "cancelled",
                               "interrupted"), key="status",
              timeout_s=600.0):
    """Poll GET /v1/jobs/<id> until ``key`` is in ``done`` (or, for a
    callable ``done``, until it holds); returns the record."""
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        st, snap = _http(base, f"/v1/jobs/{jid}", None, method="GET")
        if st != 200:
            raise AssertionError(f"GET /v1/jobs/{jid}: {st} {snap}")
        if (done(snap) if callable(done) else snap[key] in done):
            return snap
        time.sleep(0.005)
    raise AssertionError(f"job {jid} stalled: {snap}")


def _pctl(xs, p):
    return float(np.percentile(xs, p)) if xs else float("nan")


def phase_jobs(e2e, epochs_runs, tmp, card, device="cuda"):
    """Phase 22: ``serve_nn --jobs 2 --auto-promote`` serves an MNIST ANN
    f64 784-300-10 kernel to 8 closed-loop clients while job A trains the
    tutorial conf on phase 9's files (3 epochs, a snapshot each, held out
    on phase 9's test files), job B trains 64 files uploaded in 4 chunks,
    and job C, job A's submit again, is cancelled after its first epoch
    and resumed to epoch 3; then a second server on the same job dir
    reports the history."""
    from hpnn_tpu_torch import api, cli
    from hpnn_tpu_torch.io.corpus import ChunkedPackWriter, pack_path
    from hpnn_tpu_torch.ops.convergence_kernel import train_epoch_kernel
    from hpnn_tpu_torch.ops.kernels import fused_linear_act
    from hpnn_tpu_torch.serve.server import serve_in_thread

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "jobs_phase")
    os.makedirs(root)
    served = os.path.join(root, "mnist0.opt")
    _dump_generated(served, MNIST, 10958)
    conf = os.path.join(root, "mnist.conf")
    _serve_conf(conf, "mnist", served, MNIST, "f64")
    job_dir = os.path.join(root, "jobs")
    pool = _inputs(np.random.default_rng(22), SERVE_POOL, MNIST[0], "pixel")
    samples = os.path.join(e2e["root"], "samples")
    job_a = {"epochs": EPOCHS, "seed": 10958, "train": "BP", "dtype": "f64",
             "hidden": MNIST[1], "samples": samples, "ckpt_every": 1,
             "test_samples": os.path.join(e2e["root"], "tests")}
    gen_files = {1: served}     # generation -> the kernel file it serves
    swaps, yields = [], []      # (job, wall s) of each swap / gate wait
    serve_argv = ["-p", "0", "--device", device, "--no-warmup", "-b", "64",
                  "-q", str(64 * JOB_CLIENTS), "--ab-fraction", "0.25",
                  "--jobs", "2", "--auto-promote", "--job-dir", job_dir,
                  conf]

    fused_linear_act.launches = 0          # phase 22's path from here
    banner = io.StringIO()
    with contextlib.redirect_stdout(banner):
        app, _ = cli.serve_app(serve_argv)
    if app is None or "SERVE: online training enabled (queue=2, job-dir=" \
            f"{job_dir}, ab-fraction=0.25, auth=OFF (pass --auth-token), " \
            "auto-promote)\n" not in banner.getvalue():
        raise AssertionError(f"serve_nn --jobs (phase 22): {banner.getvalue()}")
    model, sched = app.registry.get("mnist"), app.jobs
    real_reload, real_rollback = app.reload_model, model.rollback
    real_into, real_yield = sched._reload_into_serving, sched._yield_to_eval

    def reload_model(name, kernel_path=None, **kw):
        res = real_reload(name, kernel_path, **kw)
        # copy what loaded at once, so the check reads those bytes
        keep = os.path.join(root, f"gen{res['generation']}.opt")
        shutil.copy(res["source"], keep)
        gen_files[res["generation"]] = keep
        return res

    def rollback(gen=None):
        res = real_rollback(gen)
        gen_files[res["generation"]] = gen_files[res["rolled_back_to"]]
        return res

    def reload_into(job, ckpt_dir, state):
        g0, t0 = model.generation, time.perf_counter()
        real_into(job, ckpt_dir, state)
        if model.generation != g0:
            swaps.append((job.job_id, time.perf_counter() - t0))

    def yield_to_eval(stop):
        t0 = time.perf_counter()
        real_yield(stop)
        yields.append(time.perf_counter() - t0)

    app.reload_model, model.rollback = reload_model, rollback
    sched._reload_into_serving = reload_into
    sched._yield_to_eval = yield_to_eval
    httpd, th = serve_in_thread(app, "127.0.0.1", 0)
    base = "http://%s:%d" % httpd.server_address[:2]
    answers, failures, lat = [], [], []
    stop = threading.Event()

    def client(i):
        k = i
        while not stop.is_set():
            rows = JOB_ROWS[k % len(JOB_ROWS)]
            lo = (97 * k + 31 * i) % (SERVE_POOL - rows)
            k += 1
            t0 = time.time()
            st, body = _http(base, "/v1/kernels/mnist/infer",
                             {"inputs": pool[lo:lo + rows].tolist()})
            t1 = time.time()
            if st != 200:
                failures.append((st, body))
                return
            answers.append((lo, rows, body["generation"],
                            np.asarray(body["outputs"], np.float64)))
            lat.append((t0, t1 - t0, rows))

    jobs, walls = {}, {}

    def submit(tag, params):
        t0 = time.perf_counter()
        st, job = _http(base, "/v1/kernels/mnist/train", params)
        if st != 202:
            raise AssertionError(f"job {tag} (phase 22): {st} {job}")
        return job["job_id"], t0

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(JOB_CLIENTS)]
    try:
        for t in threads:
            t.start()
        t_quiet = time.time()
        time.sleep(JOB_QUIET_S)
        quiet = (t_quiet, time.time())
        # job A: the tutorial conf, 3 epochs, a snapshot and a swap each
        train_epoch_kernel.launches = 0
        api.reset_epoch_metrics()
        n_yield = len(yields)
        jid, t0 = submit("A", job_a)
        jobs["A"] = _job_wait(base, jid)
        walls["A"] = time.perf_counter() - t0
        b1_launches = train_epoch_kernel.launches
        device_ms = list(api.EPOCH_METRICS["device_ms"])
        yields_a = yields[n_yield:]
        jobs["A"] = _job_wait(base, jid, lambda s: s["auto_promote"])
        # job B: 64 files uploaded in 4 chunks, 2 epochs
        names = sorted(os.listdir(samples))[:JOB_B_FILES]
        per = JOB_B_FILES // JOB_B_CHUNKS
        chunks = [names[i:i + per] for i in range(0, JOB_B_FILES, per)]

        def files(chunk):
            return [(n, open(os.path.join(samples, n), "rb").read())
                    for n in chunk]

        t0 = time.perf_counter()
        st, job = _post_body(base, "/v1/kernels/mnist/train/chunked",
                             *_multipart({"epochs": JOB_B_EPOCHS,
                                          "seed": 10958, "train": "BP",
                                          "ckpt_every": 1},
                                         files(chunks[0])))
        if st != 202:
            raise AssertionError(f"job B (phase 22): {st} {job}")
        jid_b = job["job_id"]
        for n, chunk in enumerate(chunks[1:], 2):
            final = "?final=1" if n == len(chunks) else ""
            st, out = _post_body(base, f"/v1/jobs/{jid_b}/corpus{final}",
                                 *_multipart(None, files(chunk)))
            if st != 200 or out != {"job": jid_b, "chunks": n,
                                    "complete": bool(final)}:
                raise AssertionError(f"job B chunk {n}: {st} {out}")
        jobs["B"] = _job_wait(base, jid_b)
        walls["B"] = time.perf_counter() - t0
        # job C: job A's submit, cancelled after its first epoch, resumed
        jid, t0 = submit("C", job_a)
        _job_wait(base, jid, lambda s: s["epoch"] >= 1)
        st, body = _http(base, f"/v1/jobs/{jid}/cancel", {})
        jobs["C"] = _job_wait(base, jid)
        walls["C"] = time.perf_counter() - t0
        if st != 200 or jobs["C"]["status"] != "cancelled" \
                or not 1 <= jobs["C"]["epoch"] < EPOCHS \
                or not jobs["C"]["resumable"]:
            raise AssertionError(f"job C (phase 22): cancel {st}, "
                                 f"{jobs['C']}")
        jid, t0 = submit("C'", {"resume_job": jid, "epochs": EPOCHS})
        jobs["C'"] = _job_wait(base, jid)
        walls["C'"] = time.perf_counter() - t0
        stop.set()
        for t in threads:
            t.join(timeout=120)
            if t.is_alive():
                raise AssertionError("jobs (phase 22): a client hung")
        snap = app.metrics.snapshot()
        launches = fused_linear_act.launches   # the path ends here
    finally:
        stop.set()
        httpd.shutdown()
        httpd.server_close()
        app.close(drain=True)
        th.join(timeout=60)
    if failures:
        raise AssertionError(f"jobs (phase 22): non-200 answers "
                             f"{failures[:3]}")
    for tag in ("A", "B", "C'"):
        if jobs[tag]["status"] != "done":
            raise AssertionError(f"job {tag} (phase 22): {jobs[tag]}")
    a, b = jobs["A"], jobs["B"]
    if b1_launches != EPOCHS or len(a["generations"]) < 3:
        raise AssertionError(f"job A (phase 22): train_epoch launched "
                             f"{b1_launches} times, generations "
                             f"{a['generations']}")
    if device == "cuda" and len(device_ms) != EPOCHS:
        raise AssertionError(f"job A (phase 22): epoch times {device_ms}")
    if launches != 2 * snap["batches_total"]:
        raise AssertionError(f"fused_linear_act launched {launches} times "
                             f"for {snap['batches_total']} batches")

    def opt(rec):
        with open(os.path.join(rec["path"], "kernel.opt"), "rb") as fp:
            return fp.read()

    # job A against the offline train_nn of its own conf
    offline = os.path.join(root, "offline")
    os.makedirs(offline)
    cwd = os.getcwd()
    os.chdir(offline)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.train_nn_main(
                ["-v", "-v", "--device", device, "--epochs", str(EPOCHS),
                 "--ckpt-every", "1", "--ckpt-dir", "ck",
                 os.path.join(a["path"], "nn.conf")])
        with open("kernel.opt", "rb") as fp:
            offline_opt = fp.read()
    finally:
        os.chdir(cwd)
    if rc != 0 or opt(a) != offline_opt:
        raise AssertionError(f"job A (phase 22): kernel.opt differs from "
                             f"the offline train_nn (rc {rc})")
    if opt(jobs["C'"]) != opt(a):
        raise AssertionError("job C (phase 22): the cancelled and resumed "
                             "job's kernel.opt differs from job A's")
    # job B's pack: a ChunkedPackWriter of the same chunks of its files
    cdir = os.path.join(b["path"], "corpus")
    with open(pack_path(cdir), "rb") as fp:
        pack = fp.read()
    os.unlink(pack_path(cdir))
    writer = ChunkedPackWriter(cdir, MNIST[0], MNIST[2])
    for chunk in chunks:
        writer.add_sample_files(chunk)
    if not writer.finalize() or open(pack_path(cdir), "rb").read() != pack:
        raise AssertionError("job B (phase 22): the upload's pack differs "
                             "from a ChunkedPackWriter of its chunks")
    # a second server on the job dir reports the history
    with contextlib.redirect_stdout(io.StringIO()):
        app2, _ = cli.serve_app(serve_argv)
    try:
        history = {j["job_id"]: j["status"] for j in app2.jobs.list()}
    finally:
        app2.close(drain=True)
    want = {jobs[t]["job_id"]: jobs[t]["status"] for t in jobs}
    if history != want:
        raise AssertionError(f"restart (phase 22): history {history}, "
                             f"wanted {want}")
    # every answer against the strict forward of its generation's file
    refs, n_gens = {}, {}
    for lo, rows, gen, outs in answers:
        if gen not in refs:
            refs[gen] = _strict_pool(gen_files[gen], _dtypes()["f64"], pool)
        n_gens[gen] = n_gens.get(gen, 0) + 1
        if not np.array_equal(outs, refs[gen][lo:lo + rows]):
            raise AssertionError(f"jobs (phase 22): generation {gen} rows "
                                 f"{lo}:{lo + rows} not bit-identical to "
                                 "its strict forward")
    one_row = {k: [s for t0, s, r in lat if r == 1 and lo <= t0 <= hi]
               for k, (lo, hi) in (("no job", quiet),
                                   ("job A", (a["started"],
                                              a["finished"])))}
    rec, resumed = a["auto_promote"], "C'"
    res = {"answers": len(answers),
           "answers_by_generation": {str(g): c
                                     for g, c in sorted(n_gens.items())},
           "b1_launches": b1_launches, "b2_launches": launches,
           "batches": snap["batches_total"],
           "epoch_device_ms": device_ms,
           "phase16_epoch_device_ms": epochs_runs["per-sample"]
           ["epoch_device_ms"],
           "yield_s": yields_a,
           "swap_s": {t: [s for j, s in swaps if j == jobs[t]["job_id"]]
                      for t in jobs},
           "one_row_ms": {k: {"p50": _pctl(v, 50) * 1e3,
                              "p99": _pctl(v, 99) * 1e3, "n": len(v)}
                          for k, v in one_row.items()},
           "submit_to_done_s": walls,
           "generations": {t: jobs[t]["generations"] for t in jobs},
           "auto_promote": rec,
           "cancelled_at_epoch": jobs["C"]["epoch"],
           "pack_bytes": len(pack),
           "seconds": time.perf_counter() - t_phase}
    log(f"jobs (phase 22): {len(answers)} answers over generations "
        f"{res['answers_by_generation']}, all 200 and bit-identical to the "
        "strict forward of their generation; job A done in "
        f"{walls['A']:.2f} s, train_epoch launched {b1_launches} times "
        f"(one an epoch), generations {a['generations']}, kernel.opt "
        f"byte-identical to the offline train_nn; job B ({JOB_B_FILES} "
        f"files in {JOB_B_CHUNKS} chunks) done in "
        f"{walls['B']:.2f} s, pack ({len(pack)} bytes) equal to a "
        "ChunkedPackWriter's; job C cancelled at epoch "
        f"{jobs['C']['epoch']} and resumed to {EPOCHS} in "
        f"{walls['C'] + walls[resumed]:.2f} s, kernel.opt "
        "byte-identical to job A's; restart reports "
        f"{len(history)} jobs; fused_linear_act launched {launches} "
        f"times ({snap['batches_total']} batches)")
    log(f"jobs (phase 22) auto-promote: {rec['action']} candidate gen "
        f"{rec['candidate']} err {rec['candidate_err']} vs baseline gen "
        f"{rec['baseline']} err {rec['baseline_err']}, "
        f"{rec['eval_requests']} eval requests over {rec['test_rows']} "
        "test rows")
    log(f"jobs (phase 22) times ({card}): job A epochs' device time "
        + ", ".join(f"{ms:.1f}" for ms in device_ms) + " ms (phase 16: "
        + ", ".join(f"{ms:.1f}" for ms in res["phase16_epoch_device_ms"])
        + " ms); yield gate " + ", ".join(f"{s:.3f}" for s in yields_a)
        + " s an epoch; swaps " + ", ".join(
            f"{s:.3f}" for s in res["swap_s"]["A"]) + " s; 1-row p50/p99 "
        + ", ".join(f"{k} {v['p50']:.1f}/{v['p99']:.1f} ms (n={v['n']})"
                    for k, v in res["one_row_ms"].items())
        + "; submit to done " + ", ".join(
            f"{t} {s:.2f} s" for t, s in walls.items())
        + f"; phase {res['seconds']:.1f} s")
    return res


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write every cell's numbers to PATH")
    json_path = ap.parse_args(argv).json
    try:
        import torch
    except ImportError:
        sys.stderr.write("chip_smoke: torch is not installed\n")
        return 1
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device is visible "
                         "(torch.cuda.is_available() is False)\n")
        return 1
    if not os.path.isdir(os.path.join(ROOT, "hpnn_tpu_torch")):
        sys.stderr.write("chip_smoke: run it from a checkout of the repo "
                         "(hpnn_tpu_torch/ is missing)\n")
        return 1
    sys.path.insert(0, ROOT)
    from hpnn_tpu_torch import runtime
    from hpnn_tpu_torch.ops.convergence_kernel import train_epoch_kernel
    from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile
    from hpnn_tpu_torch.ops.kernels import fused_bpm_update, fused_linear_act

    def reset_counts():
        fused_linear_act.launches = 0
        train_epoch_kernel.launches = 0
        train_tile.launches = 0
        fused_bpm_update.launches = 0

    t_start = time.perf_counter()
    runtime.pin_full_float32()
    card = phase_device()
    built = phase_build()
    errs = phase_kernel_vs_plain()
    invariance_plans = phase_invariance()
    train, first_launch = phase_train_vs_plain()
    resume_launches = phase_resume()
    tile_runs = phase_tile_vs_plain()
    contracts = phase_tile_contracts()
    with tempfile.TemporaryDirectory(prefix="hpnn_chip_smoke_") as tmp:
        runs = _setup_runs(tmp)
        reset_counts()                         # fused_linear_act's path
        results = phase_run_nn(runs)
        phase_serve(runs, results)
        launches = fused_linear_act.launches
        bpm_path = fused_bpm_update.launches   # no path calls it
        reset_counts()                         # train_epoch's path
        e2e = phase_train_nn(tmp)
        train_launches = train_epoch_kernel.launches
        train_path_fused = fused_linear_act.launches
        bpm_path += fused_bpm_update.launches
        if train_launches <= 0 or train_path_fused <= 0:
            raise AssertionError(
                f"train_nn + run_nn: train_epoch launched "
                f"{train_launches} times, fused_linear_act "
                f"{train_path_fused}")
        log(f"train path launches: train_epoch {train_launches}, "
            f"fused_linear_act {train_path_fused}")
        epoch = phase_train_time(e2e)
        reset_counts()                         # train_tile's path
        tile_e2e = phase_train_nn_tile(e2e)
        tile_launches = train_tile.launches
        tile_path = {"train_tile": tile_launches,
                     "train_epoch": train_epoch_kernel.launches,
                     "fused_linear_act": fused_linear_act.launches}
        bpm_path += fused_bpm_update.launches
        if tile_launches <= 0 or tile_path["train_epoch"] != 0 \
                or tile_path["fused_linear_act"] <= 0:
            raise AssertionError(f"train_nn --tile + run_nn launches: "
                                 f"{tile_path}")
        log("tile path launches: " + ", ".join(
            f"{k} {v}" for k, v in tile_path.items()))
        epochs_runs = phase_train_epochs(e2e)   # each run counts from 0
        bpm_path += sum(r["launches"]["fused_bpm_update"]
                        for r in epochs_runs.values())
        ckpt_runs = phase_ckpt_resume(e2e, epochs_runs)   # each run too
        bpm_path += sum(r["fused_bpm_update"] for r in ckpt_runs.values())
        corpus_res = phase_corpus(e2e, tmp)      # each run counts from 0
        serve_rest = phase_serve_rest(e2e, tmp, card)  # from 0 too
        tile_epoch = phase_tile_time(e2e, tile_e2e, epoch)
        tuned = phase_autotune(tmp)
        tile_auto = phase_tile_auto(e2e, tuned, tile_epoch)
        batched = phase_batched(e2e, tmp)       # each run counts from 0
        tp_res = phase_tp(e2e, tmp, runs, results, epochs_runs)  # from 0
        jobs_res = phase_jobs(e2e, epochs_runs, tmp, card)     # from 0
    cells = phase_times()
    bpm = phase_bpm()
    rep = next(c for c in cells if c["layer"] == "784->300"
               and c["dtype"] == "f32" and c["B"] == 4096)
    rep1 = next(c for c in cells if c["layer"] == "784->300"
                and c["dtype"] == "f32" and c["B"] == 1)
    worst = max(cells, key=lambda c: c["ms"] / c["library_ms"])
    cell = next(r for r in train if r["run"].startswith("mnist ANN BP f64"))
    first_cell = next(iter(first_launch))   # the library's first launch
    tcell = next(r for r in tile_runs
                 if r["run"].startswith("mnist ANN BP f64 tile 8"))
    bcell = next(c for c in bpm if c["shape"] == "300x784"
                 and c["dtype"] == "f32")
    ep_b1 = epochs_runs["per-sample"]
    ep_b4 = epochs_runs[f"tile {TRAIN_TILE}"]
    ck_b1 = ckpt_runs["per-sample"]
    ck_b4 = ckpt_runs[f"tile {TRAIN_TILE}"]
    kernels = {"kernels": [{
        "name": "fused_linear_act", "route": "cuda",
        "source": "hpnn_tpu_torch/csrc/fused_linear_act.cu",
        "replaces": "hpnn_tpu/ops/pallas_kernels.py:84",
        "launches": launches,
        "max_abs_err": max(errs.values()),
        "max_abs_err_by_dtype": {d: max(e for k, e in errs.items()
                                        if k[2] == d) for d in _dtypes()},
        "ms": rep["ms"], "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"],
        "timed_cell": "784->300 f32 B=4096 (the run_nn MNIST input "
                      "layer)",
        "b1_ms": rep1["ms"], "b1_plain_ms": rep1["plain_ms"],
        "b1_library_ms": rep1["library_ms"], "b1_bound_ms": rep1["bound_ms"],
        "b1_cell": "784->300 f32 B=1 (a strict serving bucket)",
        "worst_library_ratio": worst["ms"] / worst["library_ms"],
        "worst_library_ratio_cell": f"{worst['layer']} {worst['dtype']} "
                                    f"B={worst['B']}",
        "invariance_plans": len(invariance_plans),
        "serve_rest_launches": serve_rest["launches"],
        "serve_rest_batches": serve_rest["batches"],
        "corpus_launches": {f"{tag} {m}": r[m]["launches"]
                            for tag, r in corpus_res["run_nn"].items()
                            for m in ("off", "cold", "warm")},
        "tp_launches": {
            "run_nn [model] 2": tp_res["run_nn"]["launches"],
            **{f"{tag} B={b}": c["launches_per_batch"][b]
               for tag, c in tp_res["serve"].items()
               for b in TP_SERVE_BUCKETS}},
        "jobs_launches": jobs_res["b2_launches"],
        "jobs_batches": jobs_res["batches"]}, {
        "name": "train_epoch", "route": "cuda",
        "source": "hpnn_tpu_torch/csrc/train_epoch.cu",
        "replaces": "hpnn_tpu/ops/convergence_pallas.py:208",
        "launches": train_launches,
        "max_abs_err": max(r["max_abs_err"] for r in train),
        "max_abs_err_by_dtype": {d: max(r["max_abs_err"] for r in train
                                        if r["dtype"] == d)
                                 for d in _dtypes()},
        "ms": cell["ms"], "plain_ms": cell["plain_ms"],
        "bound_ms": cell["bound_ms"], "bound_by": cell["bound_by"],
        "library_ms": None,
        "us_per_iter": cell["ms"] * 1e3 / cell["iters"],
        "plain_us_per_iter": cell["plain_ms"] * 1e3 / cell["plain_iters"],
        "bound_us_per_iter": cell["bound_ms"] * 1e3 / cell["iters"],
        "timed_cell": f"{cell['run']}, one epoch of {cell['iters']} "
                      "iterations",
        "train_nn_epoch_ms": epoch["ms"],
        "train_nn_us_per_iter": epoch["us_per_iter"],
        "train_nn_iters": epoch["iters"],
        "barriers_per_iter": epoch["barriers_per_iter"],
        "first_launch_cell": f"{first_cell}, 1 MNIST ANN BP sample",
        "first_launch_ms": first_launch[first_cell]["first_ms"],
        "second_launch_ms": first_launch[first_cell]["second_ms"],
        "smem_bytes_per_block": epoch["plan"]["smem_bytes"],
        "resident_plan": epoch["plan"]["resident"],
        "blocks": epoch["plan"]["blocks"],
        "budgeted_launches": resume_launches,
        "epochs_launches": ep_b1["launches"]["train_epoch"],
        "epochs_device_ms": ep_b1["epoch_device_ms"],
        "epochs_wall_s": ep_b1["wall_s"],
        "ckpt_launches": ck_b1["launches"],
        "ckpt_wall_s": ck_b1["wall_s"],
        "corpus_epochs_device_ms": {
            m: r["epoch_device_ms"]
            for m, r in corpus_res["train_nn_epochs"].items()},
        "tp_launches": {f"train_nn {tag}": r["launches"]["train_epoch"]
                        for tag, r in tp_res["train"].items()},
        "jobs_launches": jobs_res["b1_launches"],
        "jobs_epochs_device_ms": jobs_res["epoch_device_ms"]}, {
        "name": "train_tile", "route": "cuda",
        "source": "hpnn_tpu_torch/csrc/train_tile.cu",
        "replaces": "hpnn_tpu/ops/convergence_tile.py:423",
        "launches": tile_launches,
        "max_abs_err": max(r["max_abs_err"] for r in tile_runs),
        "max_abs_err_by_dtype": {d: max(r["max_abs_err"] for r in tile_runs
                                        if r["dtype"] == d)
                                 for d in _dtypes()},
        "ms": tcell["ms"], "plain_ms": tcell["plain_ms"],
        "bound_ms": tcell["bound_ms"], "bound_by": tcell["bound_by"],
        "library_ms": None,
        "us_per_lockstep": tcell["ms"] * 1e3 / tcell["lockstep"],
        "plain_us_per_lockstep": (tcell["plain_ms"] * 1e3
                                  / tcell["plain_lockstep"]),
        "timed_cell": f"{tcell['run']}, one epoch of {tcell['lockstep']} "
                      f"lockstep iterations",
        "train_nn_epoch_ms": tile_epoch["ms"],
        "train_nn_lockstep": tile_epoch["lockstep"],
        "train_nn_lane_iters": tile_epoch["lane_iters"],
        "train_nn_us_per_lockstep": tile_epoch["us_per_lockstep"],
        "train_nn_lane_iters_per_s": tile_epoch["lane_iters_per_s"],
        "train_epoch_iters_per_s": tile_epoch["b1_iters_per_s"],
        "train_nn_bound_us_per_lockstep":
            tile_epoch["bound_us_per_lockstep"],
        "barriers_per_lockstep": tile_epoch["barriers_per_lockstep"],
        "plan": {k: tile_epoch["plan"][k] for k in ("blocks", "warps",
                                                     "scratch_on_chip",
                                                     "resident",
                                                     "smem_bytes")},
        "first_launch_ms": tile_epoch["first_ms"],
        "second_launch_ms": tile_epoch["ms"],
        "auto_tile": tile_auto["tile"],
        "auto_tile_us_per_lockstep": tile_auto["us_per_lockstep"],
        "auto_tile_lane_iters_per_s": tile_auto["lane_iters_per_s"],
        "fastest_epoch_tile": tile_auto["fastest_tile"],
        "epoch_ms_by_tile": {k: e["ms"]
                             for k, e in tile_auto["by_tile"].items()},
        "stack_frame_bytes": built["stack_frame_bytes"],
        "spill_bytes": built["spill_bytes"],
        "scratch_plan": {k: tile_runs[-1]["plan"][k] for k in (
            "scratch_on_chip", "smem_bytes", "ws_bytes")},
        "contracts": contracts,
        "epochs_launches": ep_b4["launches"]["train_tile"],
        "epochs_device_ms": ep_b4["epoch_device_ms"],
        "epochs_wall_s": ep_b4["wall_s"],
        "ckpt_launches": ck_b4["launches"],
        "ckpt_wall_s": ck_b4["wall_s"],
        "batch_tile_launches": batched["tile"]["launches"],
        "batch_tile_epoch_ms": batched["tile"]["epoch_ms"],
        "batch_tile_lane_iters_per_s": batched["tile"]["lane_iters_per_s"],
        "batch_tile_vs_plain_bitwise": batched["tile"]["bitwise"],
        "batch_tile_max_abs_err": batched["tile"]["max_abs_err"]}, {
        "name": "fused_bpm_update", "route": "cuda",
        "source": "hpnn_tpu_torch/csrc/fused_bpm_update.cu",
        "replaces": "hpnn_tpu/ops/pallas_kernels.py:141",
        "launches": bpm_path,
        "phase_launches": fused_bpm_update.launches,
        "max_abs_err": max(c["max_abs_err"] for c in bpm),
        "max_abs_err_by_dtype": {d: max(c["max_abs_err"] for c in bpm
                                        if c["dtype"] == d)
                                 for d in ("f64", "f32")},
        "ms": bcell["ms"], "plain_ms": bcell["plain_ms"],
        "bound_ms": bcell["bound_ms"], "bound_by": bcell["bound_by"],
        "library_ms": None,
        "timed_cell": "300x784 f32 (the MNIST input layer), warm",
        "warm_ms": bcell["ms"], "cold_ms": bcell["cold_ms"],
        "floor_ms": bcell["floor_ms"],
        "by_shape": {f"{c['shape']} {c['dtype']}": {
            k: c[k] for k in ("ms", "cold_ms", "bound_ms")}
            for c in bpm}}]}
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)),
                    exist_ok=True)
        with open(json_path, "w") as fp:
            json.dump({"card": card, "kernels": kernels["kernels"],
                       "cells": cells, "train_runs": train,
                       "train_first_launch": first_launch,
                       "train_nn": {**e2e, "epoch": epoch},
                       "tile_runs": tile_runs, "tile_contracts": contracts,
                       "train_nn_tile": {**tile_e2e, "epoch": tile_epoch,
                                         "launches": tile_path},
                       "autotune": tuned, "tile_auto": tile_auto,
                       "train_nn_epochs": epochs_runs,
                       "train_nn_resume": ckpt_runs,
                       "corpus": corpus_res,
                       "serve_rest": serve_rest,
                       "batched": batched,
                       "tp": tp_res,
                       "jobs": jobs_res,
                       "invariance_plans": invariance_plans,
                       "bpm": bpm,
                       "errors": [{"layer": k[0], "scale": k[1],
                                   "dtype": k[2], "B": k[3],
                                   "max_abs_err": v}
                                  for k, v in errs.items()]}, fp, indent=1)
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
