"""`nn_def`-level API: configure / run_kernel.

The port of the JAX package's ``api.py`` inference half (the reference's
orchestration layer, ``src/libhpnn.c:540-1536``): the ``.conf`` -> kernel
workflow, the seeded shuffle and the test grammar the tutorials scrape.
The whole test set is one batched forward on the device (every layer
product in the hand-written ``fused_linear_act`` kernel on CUDA) instead of
one host-driven GEMV chain per file.

Test grammar (``libhpnn.c:1388-1517``), at verbosity > 1:
    "NN: TESTING FILE: %16.16s\\t"  then for ANN " [PASS]\\n" or
    " [FAIL idx=%i]\\n"; for SNN " BEST CLASS idx=%i P=%15.10f" first; for
    the native LNN " MSE=%15.10f\\n".

Quirks preserved on purpose (each cited):

* skipped unreadable samples leave the "TESTING FILE: name\\t" line without
  a newline, so the next line concatenates (``libhpnn.c:1230-1242``);
* the ANN test verdict initializes its target index to TRUE(=1), so a test
  file with no target > 0.5 "passes" iff the argmax is 1
  (``libhpnn.c:1443-1450``);
* guess starts at n_outputs, so an all-<= -1 output vector fails with an
  out-of-range guess (``libhpnn.c:1443``);
* the test order is the seeded glibc shuffle of the readdir listing
  (``libhpnn.c:1218-1229``), reproduced stream-exactly.

Training (``train_kernel``, ``libhpnn.c:1149-1305``) is one epoch of
per-sample train-to-convergence over the seeded shuffle of the sample dir,
in the hand-written epoch kernel on CUDA and the eager loop on the CPU,
then the reference's per-sample grammar (``ann.c:2322-2366``,
``snn.c:1496-1499``), at verbosity > 1:
    "NN: TRAINING FILE: %16.16s\\t init=%15.10f OK|NO N_ITER=%8i
    final=%15.10f SUCCESS!|FAIL!\\n" (snn_train_BP prints no verdict), and
    at verbosity > 2 "NN(DBG): bad optimization!\\n" after a final dEp
    above 0.1.

Multi-epoch runs (``ckpt.trainer.train_loop``, ``train_nn --epochs N``)
continue one glibc shuffle stream (``NNDef.shuffle_rng``) and train
through :class:`_EpochPipeline`: the corpus read and uploaded once a run,
the weights kept on the device, one int32 permutation uploaded an epoch.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from .io.conf import NN_TYPE_ANN, NN_TYPE_LNN, NN_TYPE_SNN, NN_TYPE_UKN
from .io.conf import NN_TRAIN_BP, NN_TRAIN_BPM, NNConf, load_conf
from .io import corpus as corpus_io
from .io.corpus import load_resident
from .io.kernel_io import load_kernel
from .io.samples import list_sample_dir
from .models.kernel import (Kernel, generate_kernel, is_regression,
                            weights_to_numpy, weights_to_torch)
from .ops.convergence import stats_record
from .utils import nn_log
from .utils.glibc_random import GlibcRandom, shuffled_indices
from .utils.nn_log import nn_cout, nn_dbg, nn_error, nn_out, nn_warn

DTYPES = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}
LATER = "is not ported yet: a later slice of hpnn_tpu_torch brings it"


@dataclasses.dataclass
class NNDef:
    """The reference's `nn_def` handle (include/libhpnn.h:78-89)."""

    conf: NNConf
    kernel: Kernel | None = None
    # persistent shuffle stream of a multi-epoch run (ckpt.trainer): when
    # set, every train_kernel call continues this glibc stream instead of
    # re-seeding; None keeps the reference's one srandom per process
    shuffle_rng: GlibcRandom | None = None
    # the last train_kernel epoch's summary (samples, mean final dEp,
    # successes)
    last_epoch_stats: dict | None = None
    # the CG trainer's carry (cg_* arrays) restored from a snapshot bundle;
    # carried into the next bundle unchanged (the CG trainer is not ported)
    trainer_state: dict | None = None


def configure(path: str) -> NNDef | None:
    """_NN(load,conf): parse the .conf then generate or load the kernel
    (``libhpnn.c:658-884``).  Single process: no agreement gate."""
    conf = load_conf(path)
    if conf is None:
        return None
    if conf.need_init:
        if conf.type == NN_TYPE_UKN:
            nn_error("no kernel type given!\n")
            return None
        # ann_generate leaves the kernel name NULL (libhpnn.c:969-971 never
        # copies the conf name), so the dump prints glibc's "(null)"
        kernel, eff_seed = generate_kernel(
            conf.seed, conf.n_inputs, conf.hiddens, conf.n_outputs,
            name="(null)")
        # ann_generate writes the time()-derived seed back into the conf
        # (libhpnn.c:970 passes &_CONF.seed)
        conf.seed = eff_seed
    else:
        if conf.f_kernel is None:
            nn_error("can't load kernel: no filename!\n")
            return None
        kernel = load_kernel(conf.f_kernel)
        if kernel is None:
            # exact reference string (libhpnn.c:862)
            nn_error("FAILED to load the NN kernel!\n")
            return None
    # ann_kernel_allocate's memory accounting line (ann.c:197), printed on
    # both the generate and load paths
    nn_out(f"[CPU] ANN total allocation: {kernel.allocation_bytes} "
           "(bytes)\n")
    # _NN(load,conf)'s own accounting (libhpnn.c:872): sizeof(nn_def)=72
    # plus the strlen of every duplicated string and 4 bytes per [hidden]
    # entry
    def_bytes = 72 + len(conf.name or "") + 4 * len(conf.hiddens) \
        + len(conf.f_kernel or "") + len(conf.samples or "") \
        + len(conf.tests or "")
    nn_out(f"NN definition allocation: {def_bytes} (bytes)\n")
    return NNDef(conf=conf, kernel=kernel)


def dtype_of(conf: NNConf) -> torch.dtype:
    """The conf's ``[dtype]`` (f64 default, f32, bf16) as a torch dtype."""
    return DTYPES.get(conf.dtype, torch.float64)


def native_lnn(conf: NNConf) -> bool:
    """Native linear-output LNN opt-in: ``[lnn] native`` / ``--lnn
    native`` or ``HPNN_LNN_NATIVE=1``.  Off, an LNN conf keeps the
    reference's warn-and-SNN-fallthrough byte-for-byte."""
    if conf.type != NN_TYPE_LNN:
        return False
    if conf.lnn == "native":
        return True
    return os.environ.get("HPNN_LNN_NATIVE", "") not in ("", "0")


def kernel_kind(conf: NNConf) -> str:
    """The compute family a conf's model evaluates with: the reference
    routes LNN through the SNN code paths (``libhpnn.c:1455-1456``)
    unless the native linear head is opted in."""
    if conf.type == NN_TYPE_ANN:
        return NN_TYPE_ANN
    if native_lnn(conf):
        return NN_TYPE_LNN
    return NN_TYPE_SNN


def _tile_request(conf: NNConf) -> int:
    """Batched-tile engine request: HPNN_TILE (an integer or "auto") wins
    over the conf's ``[tile]`` and the CLI's ``--tile``.  0 = off (the
    per-sample engine), >0 = the group size, -1 = autotuned."""
    env = os.environ.get("HPNN_TILE")
    if env:
        if env.strip().lower() == "auto":
            return -1
        try:
            return max(0, int(env))
        except ValueError:
            nn_warn(f"HPNN_TILE={env!r} is not an integer or 'auto'; "
                    "tile engine off\n")
            return 0
    return conf.tile


def _tile_storage_env() -> str | None:
    """HPNN_TILE_STORAGE, validated: bf16/f32/f64 pass through, anything
    else warns and is ignored (a bad env knob must not abort a training
    run from deep inside the kernel)."""
    env = os.environ.get("HPNN_TILE_STORAGE")
    if not env:
        return None
    v = env.strip().lower()
    if v in ("bf16", "f32", "f64"):
        return v
    nn_warn(f"HPNN_TILE_STORAGE={env!r} is not bf16/f32/f64; legacy "
            "storage used\n")
    return None


def _resolve_tile(conf: NNConf, weights, dtype, kind: str, momentum: bool,
                  device) -> tuple[int, str | None]:
    """Concrete (tile, storage) for a non-zero tile request: an explicit
    tile passes through; ``auto`` asks the measured autotuner
    (``ops.autotune``; its heuristic when measurement is off).
    ``HPNN_TILE_STORAGE`` beats the autotuner's storage choice."""
    req = _tile_request(conf)
    env_storage = _tile_storage_env()
    if req > 0:
        return req, env_storage
    from .ops import autotune

    dec = autotune.decide_tile([tuple(w.shape) for w in weights], dtype,
                               kind, momentum, device=device)
    storage = env_storage if env_storage is not None else dec["storage"]
    nn_dbg(f"autotune: tile={dec['tile']} route={dec['route']} "
           f"storage={storage}"
           + (" (HPNN_TILE_STORAGE override)"
              if env_storage is not None and env_storage != dec["storage"]
              else "")
           + f" ({dec['source']})\n")
    return int(dec["tile"]), storage


def _unported_route(conf: NNConf) -> str | None:
    """The conf keyword that selects a training route the port does not
    have yet ([batch] N: data parallel, [model] N: row sharding,
    [trainer] cg: the CG trainer), or None."""
    if conf.batch > 0:
        return "[batch]"
    if conf.model > 1:
        return "[model]"
    if conf.trainer == "cg":
        return "[trainer] cg"
    return None


def shuffle_order(conf: NNConf, n: int, rng=None) -> list[int]:
    """Seeded shuffle of n files (libhpnn.c:1218-1229); seed 0 -> time()
    written back into the conf, as the reference mutates _CONF.seed.  A
    persistent ``rng`` (multi-epoch training, NNDef.shuffle_rng) continues
    its stream instead of re-seeding."""
    if rng is not None:
        return shuffled_indices(rng, n)
    if conf.seed == 0:
        conf.seed = int(time.time())
    return shuffled_indices(GlibcRandom(conf.seed), n)


# per-process epoch accounting: epochs trained, host-to-device bytes
# uploaded by the epochs (h2d_bytes) and once for the run
# (setup_h2d_bytes: the resident corpus and the first weights), the host
# seconds between the shuffle and the launch (stage_s) and of the glibc
# shuffle itself (shuffle_s), the route ("resident" or "restage"), and on
# a card each resident epoch's device time from its gather to the end of
# its launch (device_ms, CUDA events, filled as the epochs are joined)
EPOCH_METRICS = {"epochs": 0, "h2d_bytes": 0, "setup_h2d_bytes": 0,
                 "stage_s": 0.0, "shuffle_s": 0.0, "mode": None,
                 "device_ms": []}


def reset_epoch_metrics() -> None:
    EPOCH_METRICS.update(epochs=0, h2d_bytes=0, setup_h2d_bytes=0,
                         stage_s=0.0, shuffle_s=0.0, mode=None, device_ms=[])


# test-dir prefetch started by the last train_kernel call: tests join it
# to see its pack land; a run never waits for it
_prefetch_thread = None


def _upload(a, dtype: torch.dtype, dev) -> torch.Tensor:
    """A float64 numpy array on ``dev`` in ``dtype``: cast on the host,
    then one upload of the working type's bytes.  A read-only array (a
    warm pack's memmap) is copied first: torch wraps only writable
    memory."""
    if not a.flags.writeable:
        a = np.array(a, dtype=np.float64)
    return torch.as_tensor(a, dtype=torch.float64).to(dtype).to(dev)


def _load_library(dev: torch.device, name: str) -> None:
    """Load (or build) a kernel's library ahead of its first launch on a
    card, while a corpus load runs on its own thread; nothing on the
    CPU."""
    if dev.type == "cuda":
        from .ops import build

        build.load(name)


def _prefetch_tests(conf: NNConf, kernel: Kernel) -> None:
    """Build the test dir's pack in the background while an epoch runs,
    so the run_nn after it loads warm."""
    global _prefetch_thread
    _prefetch_thread = None
    if conf.tests:
        _prefetch_thread = corpus_io.prefetch_pack_async(
            conf.tests, kernel.n_inputs, kernel.n_outputs)


def _load_tests_async(nn: NNDef):
    """Start loading the test dir in shuffle order on a background thread
    (:func:`io.corpus.load_ordered_async`), or None when the dir cannot be
    listed (after the reference's error line)."""
    conf = nn.conf
    names = list_sample_dir(conf.tests)
    if names is None:
        nn_error(f"can't open test directory: {conf.tests}\n")
        return None
    order = shuffle_order(conf, len(names))
    return corpus_io.load_ordered_async(conf.tests, names, order, "TESTING",
                                        nn.kernel.n_inputs,
                                        nn.kernel.n_outputs)


def load_tests(nn: NNDef):
    """The test dir in shuffle order: ``(events, X, T)`` as
    :func:`io.corpus.load_ordered` returns them, or None when the dir
    cannot be listed (after the reference's error line)."""
    handle = _load_tests_async(nn)
    return None if handle is None else handle.result()


def run_kernel(nn: NNDef, device="cuda", parity: str = "strict"):
    """_NN(run,kernel) (``libhpnn.c:1306-1536``): one batched forward over
    the whole test dir on ``device``, then the reference's per-file
    grammar.  Returns the (rows, n_out) float64 outputs in shuffle order
    (None when nothing was evaluated)."""
    from . import ops

    conf = nn.conf
    if nn.kernel is None or conf.tests is None or conf.type == NN_TYPE_UKN:
        return None
    # the test dir loads on its own thread (a warm load maps the pack the
    # training run prefetched) while this one uploads the weights and
    # loads the kernel's library
    handle = _load_tests_async(nn)
    if handle is None:
        return None
    dtype = dtype_of(conf)
    # LNN evaluates through the SNN branch (libhpnn.c:1455-1456) unless
    # the native linear-output head is opted in
    kind = kernel_kind(conf)
    dev = torch.device(device)
    weights = weights_to_torch(nn.kernel.weights, dtype, dev)
    run_batch_fn, route = ops.select_run_batch(dtype, parity=parity,
                                               kind=kind, device=dev)
    if route == "fused":
        _load_library(dev, "fused_linear_act")
    events, xs, ts = handle.result()
    if xs is None:
        for line, _ in events:
            nn_out(line)
        return None
    xs_dev = torch.as_tensor(xs, dtype=torch.float64).to(dev).to(dtype)
    outs = run_batch_fn(weights, xs_dev, kind).to(
        device="cpu", dtype=torch.float64).numpy()
    _print_verdicts(events, outs, ts, kind, nn.kernel.n_outputs)
    return outs


def train_kernel(nn: NNDef, device="cuda") -> bool:
    """_NN(train,kernel) (``libhpnn.c:1149-1305``): the seeded shuffle of
    the sample dir, one epoch of per-sample train-to-convergence on
    ``device``, the per-sample console lines.  The trained weights go back
    to ``nn.kernel.weights`` as float64 numpy arrays.  In a multi-epoch run
    (``nn.shuffle_rng`` set) the epoch goes through the run's
    :class:`_EpochPipeline` when the corpus allows one."""
    from . import ops

    conf = nn.conf
    if nn.kernel is None or conf.samples is None or conf.type == NN_TYPE_UKN:
        return False
    unported = _unported_route(conf)
    if unported:
        nn_error(f"{unported} {LATER}\n")
        return False
    momentum = conf.train == NN_TRAIN_BPM
    # LNN without the native opt-in warns here and in finish() but trains
    # through the SNN fallthrough (libhpnn.c:1180-1182, 1260-1261, 1291)
    supported = conf.type in (NN_TYPE_ANN, NN_TYPE_SNN) or native_lnn(conf)

    def prologue() -> None:
        if not supported:
            nn_error("unimplemented NN type!\n")
        elif momentum:
            nn.kernel.momentum_init()  # ann_momentum_init (libhpnn.c:1175)

    def finish() -> bool:
        if not supported:
            nn_error("unimplemented NN type!\n")
        elif momentum:
            nn.kernel.momentum_free()  # ann_momentum_free (libhpnn.c:1297)
        return True

    dev = torch.device(device)
    if pipeline_active(nn) and getattr(nn, "_pipeline_defer", False):
        # deferred epochs: the prologue's stdout (MOMENTUM ALLOC) queues
        # behind the previous epoch's lines; its stderr emits now
        with nn_log.capture() as pro:
            prologue()
        nn_log.replay([e for e in pro if e[0] == "error"])
        rest = [e for e in pro if e[0] != "error"]
        if rest:
            nn._epoch_pipeline.pending.append(("entries", rest))
    else:
        prologue()
    nn.last_epoch_stats = None
    pipe = _pipeline_for(nn, conf, dev)
    if pipe is not None:
        return _train_kernel_pipelined(nn, pipe, kernel_kind(conf),
                                       momentum, finish)
    names = list_sample_dir(conf.samples)
    if names is None:
        nn_error(f"can't open sample directory: {conf.samples}\n")
        return False
    t_sh = time.perf_counter()
    order = shuffle_order(conf, len(names), nn.shuffle_rng)
    EPOCH_METRICS["shuffle_s"] += time.perf_counter() - t_sh
    t_stage = time.perf_counter()
    # the corpus loads on its own thread while this one uploads the
    # master weights and loads the epoch kernel's library
    handle = corpus_io.load_ordered_async(conf.samples, names, order,
                                          "TRAINING", nn.kernel.n_inputs,
                                          nn.kernel.n_outputs)
    dtype = dtype_of(conf)
    kind = kernel_kind(conf)
    # [dtype] bf16 trains float32 master weights (bfloat16 samples,
    # activations and deltas): bfloat16 storage rounds BPM-sized updates
    # away
    master = torch.float32 if dtype == torch.bfloat16 else dtype
    weights = weights_to_torch(nn.kernel.weights, master, dev)
    if conf.train in (NN_TRAIN_BP, NN_TRAIN_BPM):
        with nn_log.capture():   # its warning prints with the decision below
            tiled = bool(_tile_request(conf))
        _load_library(dev, "train_tile" if tiled else "train_epoch")
    events, xs, ts = handle.result()
    if xs is None or conf.train not in (NN_TRAIN_BP, NN_TRAIN_BPM):
        # CG/SPLX are declared but unimplemented (libhpnn.c:1253-1257):
        # each per-file header is printed, nothing trains, and the call
        # returns TRUE -- every header is left unterminated
        for line, _ in events:
            nn_out(line)
        return finish()
    xs_dev, ts_dev = _upload(xs, dtype, dev), _upload(ts, dtype, dev)
    EPOCH_METRICS["stage_s"] += time.perf_counter() - t_stage
    EPOCH_METRICS["h2d_bytes"] += (xs_dev.nbytes + ts_dev.nbytes
                                   + sum(w.nbytes for w in weights))
    EPOCH_METRICS["epochs"] += 1
    EPOCH_METRICS["mode"] = "restage"
    tile, storage = 0, None
    if _tile_request(conf):
        # groups of S trained to convergence in lockstep: a documented
        # trajectory divergence for S > 1, the per-sample grammar unchanged
        tile, storage = _resolve_tile(conf, weights, dtype, kind, momentum,
                                      dev)
    train_epoch_fn, _ = ops.select_train_epoch(dtype, kind=kind, device=dev,
                                               tile=tile, storage=storage)
    _prefetch_tests(conf, nn.kernel)
    new_weights, stats = train_epoch_fn(weights, xs_dev, ts_dev, kind,
                                        momentum, alpha=0.2)  # libhpnn.c:1248
    nn.kernel.weights = weights_to_numpy(new_weights)
    nn.last_epoch_stats = _emit_training_lines(events, stats, kind, momentum)
    return finish()


class _EpochPipeline:
    """Device-resident multi-epoch training state (resident mode).

    Built once a multi-epoch run (``ckpt.trainer.train_loop`` drives it
    through :func:`train_kernel`): the corpus is read once in listing
    order (``io.corpus.load_resident``) and uploaded once in the working
    dtype, the weights stay on the device across epochs in the master
    dtype (float32 under ``[dtype] bf16``), and the tile decision is made
    once.  Each epoch's host work is the glibc shuffle (a byte-parity
    obligation), the shuffle-order events and skip diagnostics rebuilt
    from the corpus's status codes, and one upload of an int32
    permutation; an ``index_select`` on the card gathers the epoch's rows
    for one ``train_epoch`` or ``train_tile`` launch.  Its stats come back
    through a non-blocking copy and an event, so epoch k+1 is queued
    before epoch k's stats are read; the console lines wait in
    ``pending`` (with literals such as the trainer's EPOCH banner) and
    :meth:`join` renders them in order at the run's join points.

    The trajectory is bit-identical to the restaging route (a cast then a
    gather equals a gather then a cast; the master weights round-trip
    through float64 losslessly), and the console stream byte-identical.
    ``HPNN_NO_EPOCH_PIPELINE=1`` takes the restaging route."""

    mode = "resident"

    def __init__(self, rc, dtype: torch.dtype, device: torch.device):
        self.rc = rc                      # ResidentCorpus (listing order)
        self.dtype = dtype
        self.wdtype = torch.float32 if dtype == torch.bfloat16 else dtype
        self.device = device
        self.weights = None               # device carry across epochs
        self.x_dev = None
        self.t_dev = None
        self.train_fn = None
        # console segments in order: ("out", text) literals, ("entries",
        # captured output) and _EpochLines of epochs not rendered yet
        self.pending: list = []

    @classmethod
    def build(cls, nn, conf, device):
        """The pipeline for this run, or None when the corpus is missing,
        empty, or has non-replayable diagnostics (the run then restages
        every epoch).  A warm pack loads the corpus without reading its
        files."""
        names = list_sample_dir(conf.samples)
        if not names:
            return None
        rc = load_resident(conf.samples, names, nn.kernel.n_inputs,
                           nn.kernel.n_outputs)
        if rc is None or rc.n_rows == 0:
            return None
        pipe = cls(rc, dtype_of(conf), device)
        # the one corpus upload of the run
        pipe.x_dev = _upload(rc.X, pipe.dtype, device)
        pipe.t_dev = _upload(rc.T, pipe.dtype, device)
        EPOCH_METRICS["setup_h2d_bytes"] += (pipe.x_dev.nbytes
                                             + pipe.t_dev.nbytes)
        rc.release_rows()
        nn_dbg(f"epoch pipeline: {pipe.mode}, {rc.n_rows} row(s)\n")
        return pipe

    def run_epoch(self, nn, events, sel, kind: str, momentum: bool) -> int:
        """Queue one epoch's device work on the resident corpus and its
        stats readback; returns the bytes this epoch uploaded."""
        from . import ops

        if self.weights is None:
            # the first epoch stages the float64 host weights; afterwards
            # the carry stays on the device
            self.weights = weights_to_torch(nn.kernel.weights, self.wdtype,
                                            self.device)
            EPOCH_METRICS["setup_h2d_bytes"] += sum(
                w.nbytes for w in self.weights)
        if self.train_fn is None:
            tile, storage = 0, None
            if _tile_request(nn.conf):
                tile, storage = _resolve_tile(nn.conf, self.weights,
                                              self.dtype, kind, momentum,
                                              self.device)
            self.train_fn, _ = ops.select_train_epoch(
                self.dtype, kind=kind, device=self.device, tile=tile,
                storage=storage, defer_stats=True)
        perm, start = torch.from_numpy(sel), None
        if self.device.type == "cuda":
            # pinned, so the upload queues behind the previous epoch's
            # launch instead of waiting for it
            perm = perm.pin_memory()
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self.device))
        sel_dev = perm.to(self.device, non_blocking=True)  # the upload
        xs = self.x_dev.index_select(0, sel_dev)
        ts = self.t_dev.index_select(0, sel_dev)
        self.weights, stats = self.train_fn(self.weights, xs, ts, kind,
                                            momentum, alpha=0.2)
        self.pending.append(_EpochLines(events, stats, self.dtype, kind,
                                        momentum, nn_log.get_verbosity(),
                                        start))
        return sel.nbytes

    def join(self, nn) -> list[dict]:
        """Emit the pending console segments in order and copy the weight
        carry back to ``nn.kernel.weights`` (float64, what kernel.opt
        dumps).  Returns the joined epochs' summaries, oldest first."""
        sums = []
        for item in self.pending:
            if isinstance(item, _EpochLines):
                text, summary = item.render()
                nn_log.nn_raw(text)
                sums.append(summary)
                nn.last_epoch_stats = summary
            elif item[0] == "out":
                nn_out(item[1])
            else:
                nn_log.replay(item[1])
        self.pending = []
        if self.weights is not None:
            nn.kernel.weights = weights_to_numpy(self.weights)
        return sums


class _EpochLines:
    """One queued epoch's console lines: its stats record comes back from
    the card through a non-blocking copy into pinned memory, and
    :meth:`render` waits on the copy's event only when the lines are due
    (and then reads the epoch's device time from ``start``)."""

    def __init__(self, events, stats: torch.Tensor, dtype, kind: str,
                 momentum: bool, verbosity: int, start=None):
        self.events = events
        self.dtype, self.kind, self.momentum = dtype, kind, momentum
        self.verbosity = verbosity
        self.start = start
        self.end = self.done = None
        if stats.device.type == "cuda":
            stream = torch.cuda.current_stream(stats.device)
            self.end = torch.cuda.Event(enable_timing=True)
            self.end.record(stream)
            host = torch.empty(stats.shape, dtype=stats.dtype,
                               pin_memory=True)
            host.copy_(stats, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record(stream)
            stats = host
        self.stats = stats

    def render(self):
        if self.done is not None:
            self.done.synchronize()
            if self.start is not None:
                EPOCH_METRICS["device_ms"].append(
                    self.start.elapsed_time(self.end))
        stats = stats_record(self.stats, self.dtype)
        return _render_training_lines(self.events, stats, self.kind,
                                      self.momentum, self.verbosity)


def _pipeline_for(nn, conf, device):
    """The run's epoch pipeline: the one built at its first epoch (the
    decision is made once a run), a new one when this multi-epoch run
    qualifies, else None (the restaging route)."""
    cur = getattr(nn, "_epoch_pipeline", None)
    if isinstance(cur, _EpochPipeline):
        return cur
    if cur is False:
        return None
    pipe = None
    if (nn.shuffle_rng is not None
            and conf.train in (NN_TRAIN_BP, NN_TRAIN_BPM)
            and not os.environ.get("HPNN_NO_EPOCH_PIPELINE")):
        pipe = _EpochPipeline.build(nn, conf, device)
    nn._epoch_pipeline = pipe if pipe is not None else False
    return pipe


def pipeline_active(nn) -> bool:
    """True when ``nn`` trains through the device-resident pipeline."""
    return isinstance(getattr(nn, "_epoch_pipeline", None), _EpochPipeline)


def pipeline_defer_out(nn, text: str) -> bool:
    """Queue an NN_OUT line behind the pipeline's pending epochs (the
    trainer's EPOCH banner follows the previous epoch's lines).  Returns
    False when no pipeline is active: the caller prints it."""
    if not pipeline_active(nn):
        return False
    nn._epoch_pipeline.pending.append(("out", text))
    return True


def pipeline_join(nn) -> list[dict]:
    """Drain the pipeline at a join point; [] when none is active."""
    if not pipeline_active(nn):
        return []
    return nn._epoch_pipeline.join(nn)


def _train_kernel_pipelined(nn, pipe: _EpochPipeline, kind: str,
                            momentum: bool, finish) -> bool:
    """One epoch through the resident pipeline: shuffle, events and skip
    diagnostics from the corpus's status codes, the int32 permutation's
    upload, the on-card gather and one launch; the console lines wait in
    the pipeline until the trainer joins it (at once for a caller that
    does not defer)."""
    conf = nn.conf
    t0 = time.perf_counter()
    order = shuffle_order(conf, len(pipe.rc.names), nn.shuffle_rng)
    t1 = time.perf_counter()
    events, sel = pipe.rc.epoch_events(order)
    _prefetch_tests(conf, nn.kernel)
    EPOCH_METRICS["h2d_bytes"] += pipe.run_epoch(nn, events, sel, kind,
                                                 momentum)
    EPOCH_METRICS["shuffle_s"] += t1 - t0
    EPOCH_METRICS["stage_s"] += time.perf_counter() - t1
    EPOCH_METRICS["epochs"] += 1
    EPOCH_METRICS["mode"] = pipe.mode
    finish()
    if not getattr(nn, "_pipeline_defer", False):
        pipe.join(nn)
    return True


def _render_training_lines(events, stats, kind: str, momentum: bool,
                           verbosity: int):
    """The reference's per-sample training stream (ann.c:2322-2366,
    snn.c:1496-1499) for one epoch, formatted column-wise with numpy and
    joined once; the verbosity gates and prefixes are applied here.
    Returns (stdout_text, epoch_summary)."""
    final_dep = np.asarray(stats.final_dep, dtype=np.float64)
    success = np.asarray(stats.success)
    n = int(final_dep.shape[0])
    summary = {"samples": n,
               "mean_final": float(np.mean(final_dep)) if n else None,
               "success": int(np.sum(success)) if n else 0}
    if verbosity <= 1:
        return "", summary
    blocks: list[str] = []
    if n:
        init_err = np.asarray(stats.init_err, dtype=np.float64)
        first_ok = np.asarray(stats.first_ok)
        n_iter = np.asarray(stats.n_iter).astype(np.int64)
        b = np.char.mod(" init=%15.10f", init_err)
        b = np.char.add(b, np.where(first_ok, " OK", " NO"))
        b = np.char.add(b, np.char.mod(" N_ITER=%8d", n_iter))
        b = np.char.add(b, np.char.mod(" final=%15.10f", final_dep))
        if kind == NN_TYPE_SNN and not momentum:
            # snn_train_BP ends without a verdict (snn.c:1496-1499)
            b = np.char.add(b, "\n")
        else:
            b = np.char.add(b, np.where(success, " SUCCESS!\n",
                                        " FAIL!\n"))
        if verbosity > 2:
            b = np.char.add(b, np.where(final_dep > 0.1,
                                        "NN(DBG): bad optimization!\n", ""))
        blocks = b.tolist()
    parts: list[str] = []
    for line, i in events:
        parts.append("NN: ")
        parts.append(line)
        # skipped file: header only, no newline (libhpnn.c:1242)
        if i is not None:
            parts.append(blocks[i])
    return "".join(parts), summary


def _emit_training_lines(events, stats, kind: str, momentum: bool) -> dict:
    """Render + emit the per-sample training stream; returns the epoch
    summary."""
    text, summary = _render_training_lines(events, stats, kind, momentum,
                                           nn_log.get_verbosity())
    nn_log.nn_raw(text)
    return summary


def _print_verdicts(events, outs, ts, kind: str, n_out: int) -> None:
    for line, i in events:
        nn_out(line)
        if i is None:
            continue
        out, t = outs[i], ts[i]
        if kind == NN_TYPE_ANN:
            # res=-1.; guess=n_outputs; is_ok=TRUE(=1)  (libhpnn.c:1443-1450)
            res = -1.0
            guess = n_out
            target = 1
            for idx in range(n_out):
                if res < out[idx]:
                    guess = idx
                    res = out[idx]
                if t[idx] > 0.5:
                    target = idx
            if guess == target:
                nn_cout(" [PASS]\n")
            else:
                nn_cout(f" [FAIL idx={target + 1}]\n")
        elif is_regression(kind):
            # native LNN regression grammar: per-output values at DBG, one
            # MSE summary per file, no PASS/FAIL verdict
            nn_dbg("   IDX |          OUTPUT |          TARGET\n")
            nn_dbg("-------|-----------------|----------------\n")
            for idx in range(n_out):
                nn_dbg(f" {idx + 1:5d} | {out[idx]:15.10f} "
                       f"| {t[idx]:15.10f}\n")
            nn_dbg("-------|-----------------|----------------\n")
            mse = float(np.mean((out - t) ** 2))
            nn_cout(f" MSE={mse:15.10f}\n")
        else:
            # SNN: res=0; guess=0; is_ok=0  (libhpnn.c:1499-1514)
            res = 0.0
            guess = 0
            target = 0
            nn_dbg(" CLASS | PROBABILITY (%)\n")
            nn_dbg("-------|----------------\n")
            for idx in range(n_out):
                nn_dbg(f" {idx + 1:5d} | {out[idx] * 100.0:15.10f}\n")
                if out[idx] > res:
                    res = out[idx]
                    guess = idx
                if t[idx] > 0.1:
                    target = idx
            nn_dbg("-------|----------------\n")
            nn_cout(f" BEST CLASS idx={guess + 1} P={res * 100.0:15.10f}")
            if guess == target:
                nn_cout(" [PASS]\n")
            else:
                nn_cout(f" [FAIL idx={target + 1}]\n")


__all__ = ["EPOCH_METRICS", "NNDef", "configure", "dtype_of", "kernel_kind",
           "load_tests", "native_lnn", "pipeline_active",
           "pipeline_defer_out", "pipeline_join", "reset_epoch_metrics",
           "run_kernel", "shuffle_order", "train_kernel"]
