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

Two more training routes, the JAX package's batched trainers:

* an opted-in native trainer (``train.native_trainer``: ``[trainer] cg``,
  ``--trainer cg`` or ``HPNN_TRAINER=cg`` on a ``[train] CG`` conf) takes
  the whole epoch (``train.cg``), one ``TRAINING CG`` line an epoch;
* ``[batch] B`` trains minibatch data-parallel (``parallel.dp``), one
  ``TRAINING BATCH`` line a batch; with ``[tile]`` every batch-sized group
  trains to convergence in the ``train_tile`` kernel instead (over its
  devices' data mesh in torch code), with the per-sample grammar;
* ``[model] N`` (or ``--model-parallel N``, or ``-S N``) trains with the
  weights' rows sharded over N devices (``parallel.tp``): per sample, or
  beside ``[batch]`` on a (data x model) grid.  ``run_nn`` evaluates such
  a conf through the row-sharded ring engine.

The devices, as the JAX package takes them (:func:`_local_devices`): in
one process the thread's :func:`device_slice`, else the visible cards of a
``cuda`` run from the named one on (``cuda`` or ``cuda:0``: every card;
``cuda:1``: the cards from 1), else the one CPU device; across processes
(``HPNN_DISTRIBUTED``) every rank's such devices (the cards
``runtime.init_all`` gave it), the grid over them process-major (a
``parallel.mesh.Grid``).  A request above them clamps with the JAX
package's warning; on one device the unsharded routes run.

Tracing (``utils/trace.py``, ``obs/``) at the JAX package's places and
names: the ``#PROF`` phases ``warmup``, ``load_samples``/``load_tests``,
``train_epoch`` (``train_epoch_<trainer>``, ``train_epoch_dp``,
``train_epoch_tp`` on those routes) and ``eval_batch``, each also a span
under tracing; ``HPNN_DBG_TRACE``'s ``train-in``/``train-out`` checksums
around a restaged epoch (and so no resident pipeline under it); the
pipeline's ``corpus_load``, ``corpus_gather``, ``device_launch`` and
``stats_drain`` spans.  The port adds ``kernel_parse`` (the kernel file's
parse in :func:`configure`) and, under ``stats_drain``, ``stats_wait``
(a readback's wait on the card), ``epoch_render`` (an epoch's lines
rendered and written) and ``weights_export`` (the carry copied back to
float64), and ``ckpt.trainer`` adds ``train.stop``; the JAX package has
none of the five.  While span tracing is on, the pipeline's per-sample B1
launches take the kernel's instrumented instantiation, whose per-block
phase cycles come back with the epoch's stats into
``EPOCH_METRICS["b1_cycles"]``.  The resident ``[batch]`` epoch gathers
its batch rows on the card inside its ``device_launch`` span, where the JAX
package's resident DP program gathers inside its launch; the host-streamed
shard mode takes one ``device_launch`` span a shard (``mode="sharded"``,
``shard_lo``).  Spans and
phases are host intervals: a launch returns before the card finishes,
and nothing here synchronizes for them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time

import numpy as np
import torch

from .io.conf import NN_TYPE_ANN, NN_TYPE_LNN, NN_TYPE_SNN, NN_TYPE_UKN
from .io.conf import NN_TRAIN_BP, NN_TRAIN_BPM, NNConf, load_conf
from .parallel import coord
from .io import corpus as corpus_io
from .io.corpus import load_resident
from .io.kernel_io import load_kernel
from .io.samples import list_sample_dir
from .models.kernel import (Kernel, generate_kernel, is_regression,
                            weights_to_numpy, weights_to_torch)
from .obs import trace as obs_trace
from .ops import convergence_kernel as b1_kernel
from .ops.convergence import stats_record
from .utils import nn_log
from .utils.glibc_random import GlibcRandom, shuffled_indices
from .utils.nn_log import nn_cout, nn_dbg, nn_error, nn_out, nn_warn
from .utils.trace import phase, trace_enabled, trace_weights

DTYPES = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}


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
    # the CG trainer's carry (cg_d, cg_g, cg_meta: unpadded float64), the
    # snapshot payload a resume restores
    trainer_state: dict | None = None

    # _NN(get,n_inputs) and _NN(get,n_outputs) (libhpnn.c:1013-1066)
    @property
    def n_inputs(self) -> int:
        return self.kernel.n_inputs if self.kernel else 0

    @property
    def n_outputs(self) -> int:
        return self.kernel.n_outputs if self.kernel else 0


def dump_kernel_def(nn: NNDef, fp) -> bool:
    """_NN(dump,kernel) (libhpnn.c:996-1008): the kernel in the reference's
    text format to ``fp``; False without a kernel."""
    from .io.kernel_io import dump_kernel

    if nn.kernel is None:
        return False
    dump_kernel(nn.kernel, fp)
    return True


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
        with obs_trace.span("kernel_parse"):
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


def _model_shards(conf: NNConf) -> int:
    """Row-sharding degree: ``[model] N`` (``--model-parallel N`` sets it)
    wins; else the ``-S`` stream count (the reference's streams-a-GPU row
    split, ``cuda_ann.cu:536-537``)."""
    if conf.model > 0:
        return conf.model
    from . import runtime

    return runtime.lib_runtime.n_streams


def _local_devices(device) -> list:
    """The devices this process trains over, in order: the thread's
    pinned slice (:func:`device_slice`; repeats allowed), else on a card
    the cards from ``device`` on -- at world 1 the visible ones (``cuda``
    resolves to the current card, ``cuda:0`` by default, so a ``cuda``
    run takes every card and ``cuda:1`` the cards from 1, never card 0);
    across processes the ones this rank holds (``runtime``) -- else
    ``device`` alone (the CPU)."""
    sl = slice_devices()
    if sl is not None:
        return [torch.device(d) for d in sl]
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev]
    if coord.world_size() > 1:
        from . import runtime

        held = list(runtime.lib_runtime.devices) or [dev]
        return held[held.index(dev):] if dev in held else [dev]
    first = 0 if dev.index is None else dev.index
    return [torch.device("cuda", i)
            for i in range(first, torch.cuda.device_count())]


def _device_total(device) -> int:
    """Every device of the run: this process's at world 1, the world's
    across processes (each rank holding as many as this one, which the
    agreement gates hold)."""
    return coord.world_size() * len(_local_devices(device))


def _model_axis(shards: int, device):
    """``(mesh, k, warning or None)``: the model axis of the TP train and
    eval routes, ``shards`` clamped to the run's devices with the JAX
    package's warning text.  At world 1 a request of k > 1 takes the
    first k of this process's devices (a ``LocalMesh``).  Across
    processes the axis is a model group of the first k of the world's
    devices, repeated over the rest as data replicas, R x k with R =
    devices // k, so every rank trains (the JAX package's ranks outside
    its one group hold no shard); a layout that still leaves a rank
    without a shard is refused (:class:`DPRefused`)."""
    from .parallel.mesh import make_mesh

    world = coord.world_size()
    ndev = _device_total(device)
    warn = None
    if shards > ndev:
        warn = f"[model] {shards} > {ndev} visible device(s); using {ndev}\n"
        shards = ndev
    devs = _local_devices(device)
    if world > 1:
        try:
            mesh = make_mesh(max(1, ndev // shards), shards, device=device,
                             devices=devs)
        except ValueError as exc:
            raise DPRefused(f"[model] {shards}: {exc} (refused)") from None
        return mesh, shards, warn
    return (make_mesh(n_data=1, n_model=shards, device=device,
                      devices=devs[:shards] if shards > 1 else None),
            shards, warn)


def _clamped_model_mesh(shards: int, device):
    """``(mesh, k)`` of :func:`_model_axis`, its clamp warning printed."""
    mesh, k, warn = _model_axis(shards, device)
    if warn:
        nn_warn(warn)
    return mesh, k


def _hybrid_banner(n_data: int, n_model: int) -> str:
    """The [batch] x [model] grid's banner, shared restage/resident."""
    return (f"DP: hybrid mesh {n_data}x{n_model} "
            "(batch rows over data, weight rows over model)\n")


def _hybrid_model_axis(shards: int, ndev: int):
    """``(n_model, warning or None)`` for [model] beside [batch]: the
    largest divisor of the grid's devices not above the request (the
    grid covers every device, so the model axis must divide it).  Shared
    by the restage route and the pipeline, so the warnings stay
    byte-identical."""
    if shards <= 1:
        return 1, None
    if ndev == 1:
        return 1, f"[model] {shards} > 1 visible device(s); using 1\n"
    n_model = min(shards, ndev)
    while ndev % n_model:
        n_model -= 1
    if n_model != shards:
        return n_model, (f"[model] {shards} clamped to {n_model} "
                         f"(device count {ndev})\n")
    return n_model, None


class DPRefused(RuntimeError):
    """A data-parallel request this process layout cannot honour."""


def _dp_device_count(device) -> int:
    """The devices of the [batch] routes (the whole grid beside [model]).

    At world 1, as in the JAX package: a thread's pinned slice wins
    outright (its length is the grid); else this process's devices
    (:func:`_local_devices`) capped by ``HPNN_DP_DEVICES``, with the
    JAX package's warning for a cap above them.  Across processes every
    rank's devices (:func:`_device_total`) capped the same way, the grid
    the first of them process-major; a cap that leaves a rank without a
    shard would need it to sit out of the run, which the port cannot
    express, so it is refused (:class:`DPRefused`)."""
    from .utils.env import env_device_cap, env_int

    world = coord.world_size()
    if world > 1:
        total = _device_total(device)
        per = total // world
        need = (world - 1) * per + 1
        cap = env_int("HPNN_DP_DEVICES", 0)
        if 0 < cap < need:
            raise DPRefused(
                f"HPNN_DP_DEVICES={cap} < {need} "
                + ("processes" if per == 1 else
                   f"devices ({world} processes of {per})")
                + ": every rank of the world holds a data shard, so the "
                "cap cannot be honoured (refused)")
        return env_device_cap("HPNN_DP_DEVICES", total)
    sl = slice_devices()
    if sl is not None:
        return len(sl)
    return env_device_cap("HPNN_DP_DEVICES", len(_local_devices(device)))


def _dp_mesh(n_data: int, n_model: int, device):
    """The [batch] routes' grid: the first ``n_data * n_model`` of the
    run's devices (this process's at world 1, every rank's across
    processes, process-major), or None on one device."""
    from .parallel.mesh import make_mesh

    if n_data * n_model == 1 and coord.world_size() == 1:
        return None
    return make_mesh(n_data, n_model, device=device,
                     devices=_local_devices(device))


def _dp_slot_map(s: int, bsz: int, n_batches: int, bsz_pad: int):
    """Epoch-invariant [batch] slot geometry, the one source for both the
    restage staging and the resident pipeline: real row i lands at flat
    slot (i//bsz)*bsz_pad + i%bsz, every other slot is a masked pad.
    Returns (pos, mask) with mask (n_batches, bsz_pad) float64 of 1.0 on
    real slots."""
    pos = (np.arange(s) // bsz) * bsz_pad + np.arange(s) % bsz
    mask = np.zeros((n_batches, bsz_pad), np.float64)
    mask.reshape(-1)[pos] = 1.0
    return pos, mask


def _dp_banner_lines(s: int, bsz: int, n_batches: int, bsz_pad: int,
                     n_data: int, unsharded: bool) -> list[str]:
    """[batch] minibatch-route console banners, the one source for the
    restage and resident routes (a byte-parity surface)."""
    lines = []
    if unsharded:
        lines.append("DP: one device visible; minibatch training runs "
                     "unsharded\n")
    padded_rows = n_batches * bsz_pad - s
    if padded_rows:
        lines.append(f"DP: padding {padded_rows} masked row(s) "
                     f"(S={s}, batch={bsz} -> {bsz_pad} over {n_data} "
                     "data-shard(s))\n")
    return lines


def _dp_tiled_banner(group: int, pad_to: int, meshed: bool,
                     storage) -> str:
    """[batch]+[tile] engine banner, shared restage/resident (parity
    surface)."""
    eff = -(-group // pad_to) * pad_to
    return ("DP: batched-tile convergence engine (group=" + str(group)
            + (f" -> {eff} over {pad_to} data-shard(s)" if eff != group
               else "")
            + (f", mesh={pad_to}" if meshed else "")
            + (f", storage={storage}" if storage else "") + ")\n")


def _dp_layout(conf: NNConf, device):
    """``(ndev, n_data, n_model, warning or None)`` of a [batch] run: the
    data axis's devices and, with [model] beside it, the grid's split."""
    ndev = _dp_device_count(device)
    n_model, warn = _hybrid_model_axis(_model_shards(conf), ndev)
    return ndev, ndev // n_model, n_model, warn


def _dp_geometry(conf: NNConf, s: int, n_data: int):
    """(bsz, n_batches, bsz_pad) of a [batch] epoch over s rows and
    ``n_data`` data shards."""
    bsz = min(conf.batch, s)
    n_batches = -(-s // bsz)
    bsz_pad = -(-bsz // n_data) * n_data
    return bsz, n_batches, bsz_pad


def _dp_tiled_route(conf: NNConf) -> bool:
    """[batch] + [tile] takes the batched-tile engine in one process (over
    its devices' data mesh when it has several); a multi-process run keeps
    minibatch DP (the engine is single-process), and so does [model]
    beside them (with the JAX package's warning)."""
    return (bool(_tile_request(conf)) and coord.world_size() == 1
            and _model_shards(conf) <= 1)


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
# On the [batch] routes also the data axis (dp_devices) and the update
# state's bytes on this rank's device against a replicated layout's
# On the [model] routes the model axis (tp_devices) and the weight bytes
# one device holds (weight_bytes_per_device, the largest row-block shard)
# At the pipeline's joins: the host seconds of rendering and writing the
# epochs' lines (render_s), on a card the gap from an epoch's end to the
# next epoch's start between epochs queued with no join between them
# (boundary_ms, CUDA events), and while span tracing is on B1's cycles
# by phase (b1_cycles: ops.convergence_kernel.PHASES -> cycles, summed
# over the launches' blocks)
EPOCH_METRICS = {"epochs": 0, "h2d_bytes": 0, "setup_h2d_bytes": 0,
                 "stage_s": 0.0, "shuffle_s": 0.0, "mode": None,
                 "device_ms": [], "dp_devices": 0,
                 "opt_state_bytes_per_device": 0,
                 "opt_state_replicated_bytes": 0, "tp_devices": 1,
                 "weight_bytes_per_device": 0, "render_s": 0.0,
                 "boundary_ms": [], "b1_cycles": {}}


def reset_epoch_metrics() -> None:
    EPOCH_METRICS.update(epochs=0, h2d_bytes=0, setup_h2d_bytes=0,
                         stage_s=0.0, shuffle_s=0.0, mode=None, device_ms=[],
                         dp_devices=0, opt_state_bytes_per_device=0,
                         opt_state_replicated_bytes=0, tp_devices=1,
                         weight_bytes_per_device=0, render_s=0.0,
                         boundary_ms=[], b1_cycles={})


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
    grammar.  ``[model] N`` (or ``-S N``) evaluates through the
    row-sharded ring engine over N devices (``parallel.tp.tp_eval_batch``:
    this process's, or every rank's, :func:`_model_axis`); one device
    clamps to one shard with the JAX package's warning.
    Returns the (rows, n_out) float64 outputs in shuffle order (None when
    nothing was evaluated)."""
    from . import ops

    conf = nn.conf
    if nn.kernel is None or conf.tests is None or conf.type == NN_TYPE_UKN:
        return None
    # the test dir loads on its own thread (a warm load maps the pack the
    # training run prefetched) while this one uploads the weights and
    # loads the kernel's library
    handle = _load_tests_async(nn)
    if handle is None:
        coord.agree_all(False, (0, 0, 0))
        return None
    dtype = dtype_of(conf)
    # LNN evaluates through the SNN branch (libhpnn.c:1455-1456) unless
    # the native linear-output head is opted in
    kind = kernel_kind(conf)
    dev = torch.device(device)
    with phase("warmup"):
        weights = weights_to_torch(nn.kernel.weights, dtype, dev)
        run_batch_fn, route = ops.select_run_batch(dtype, parity=parity,
                                                   kind=kind, device=dev)
        if route == "fused" or _model_shards(conf) > 1:
            _load_library(dev, "fused_linear_act")
    with phase("load_tests"):
        events, xs, ts = handle.result()
    # a rank whose test dir differs drags every rank out of the sharded
    # evaluation's collectives (the JAX package's run-path gate)
    fp = ((xs.shape[0], nn.kernel.n_inputs, nn.kernel.n_outputs)
          if xs is not None else (0, 0, 0))
    if not coord.agree_all(xs is not None, fp,
                           devices=len(_local_devices(dev))):
        if xs is None:
            for line, _ in events:
                nn_out(line)
        return None
    shards = _model_shards(conf)
    if shards > 1:
        try:
            mesh, k = _clamped_model_mesh(shards, dev)
        except DPRefused as exc:
            nn_error(f"{exc}\n")
            return None
        if k > 1:
            run_batch_fn, _ = ops.select_run_batch(
                dtype, parity=parity, kind=kind, device=dev, model_mesh=mesh)
    with phase("eval_batch"):
        xs_dev = torch.as_tensor(xs, dtype=torch.float64).to(dev).to(dtype)
        outs = run_batch_fn(weights, xs_dev, kind).to(
            device="cpu", dtype=torch.float64).numpy()
    _print_verdicts(events, outs, ts, kind, nn.kernel.n_outputs)
    return outs


def train_kernel(nn: NNDef, device="cuda") -> bool:
    """_NN(train,kernel) (``libhpnn.c:1149-1305``): the seeded shuffle of
    the sample dir, one epoch on ``device``, the console lines.  The epoch
    is per-sample train-to-convergence (or the batched-tile engine under
    ``[tile]``), an opted-in native trainer's (``[trainer] cg``),
    minibatch data-parallel under ``[batch]``, or row-sharded under
    ``[model] N`` (per sample, or on a grid beside ``[batch]``).  The
    trained weights go back to ``nn.kernel.weights`` as float64 numpy
    arrays.  In a multi-epoch run
    (``nn.shuffle_rng`` set) a BP/BPM epoch goes through the run's
    :class:`_EpochPipeline` when the corpus allows one."""
    from . import ops
    from .train import native_trainer

    conf = nn.conf
    if nn.kernel is None or conf.samples is None or conf.type == NN_TYPE_UKN:
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
    try:
        pipe = _pipeline_for(nn, conf, dev)
        if pipe is not None:
            return _train_kernel_pipelined(nn, pipe, kernel_kind(conf),
                                           momentum, finish)
        names = list_sample_dir(conf.samples)
        if names is None:
            # the failing rank names its cause, then drags its peers out
            # of the agreement gate (ann.c:242-248, extended to the data)
            nn_error(f"can't open sample directory: {conf.samples}\n")
            coord.agree_all(False, (0,) * coord.FINGERPRINT_WIDTH)
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
        # activations and deltas): bfloat16 storage rounds BPM-sized
        # updates away
        master = torch.float32 if dtype == torch.bfloat16 else dtype
        entry = native_trainer(conf)
        trainable = conf.train in (NN_TRAIN_BP, NN_TRAIN_BPM)
        with phase("warmup"):
            weights = weights_to_torch(nn.kernel.weights, master, dev)
            if entry is None and trainable:
                # the tile request's warning prints with the decision
                with nn_log.capture():
                    tiled = bool(_tile_request(conf))
                if _model_shards(conf) > 1 and conf.batch <= 0:
                    _load_library(dev, "train_epoch"
                                  if coord.world_size() == 1
                                  else "fused_linear_act")
                elif conf.batch <= 0 or _dp_tiled_route(conf):
                    _load_library(dev, "train_tile" if tiled
                                  else "train_epoch")
        with phase("load_samples"):
            events, xs, ts = handle.result()
        # agreement gate before any return path: a rank whose corpus
        # differs drags every rank out of the coming collectives
        if not coord.agree_all(True, (0 if xs is None else xs.shape[0],
                                      nn.kernel.n_inputs,
                                      nn.kernel.n_outputs, 0),
                               devices=len(_local_devices(dev))):
            return False
        if entry is not None and xs is not None:
            # the native trainer takes the whole epoch (its own grammar);
            # [dtype] bf16 runs it on the float32 masters throughout
            xs_dev, ts_dev = _upload(xs, master, dev), _upload(ts, master,
                                                               dev)
            EPOCH_METRICS["stage_s"] += time.perf_counter() - t_stage
            EPOCH_METRICS["h2d_bytes"] += (xs_dev.nbytes + ts_dev.nbytes
                                           + sum(w.nbytes for w in weights))
            EPOCH_METRICS["epochs"] += 1
            EPOCH_METRICS["mode"] = f"restage-{entry.name}"
            trace_weights(weights, "train-in")
            with phase(f"train_epoch_{entry.name}"):
                new = entry.run_epoch(nn, weights, xs_dev, ts_dev, kind,
                                      master)
                nn.kernel.weights = weights_to_numpy(new)
            ok = finish()
            trace_weights(nn.kernel.weights, "train-out")
            return ok
        if xs is None or not trainable:
            # CG/SPLX are declared but unimplemented (libhpnn.c:1253-1257):
            # each per-file header is printed, nothing trains, and the call
            # returns TRUE -- every header is left unterminated
            for line, _ in events:
                nn_out(line)
            return finish()
        trace_weights(weights, "train-in")
        if conf.batch > 0:
            if coord.world_size() == 1:
                _prefetch_tests(conf, nn.kernel)
            EPOCH_METRICS["stage_s"] += time.perf_counter() - t_stage
            with phase("train_epoch_dp"):
                ok = _train_kernel_dp(nn, weights, xs, ts, kind, momentum,
                                      finish, events, dev)
            trace_weights(nn.kernel.weights, "train-out")
            return ok
        if _model_shards(conf) > 1:
            if coord.world_size() == 1:
                _prefetch_tests(conf, nn.kernel)
            EPOCH_METRICS["stage_s"] += time.perf_counter() - t_stage
            with phase("train_epoch_tp"):
                ok = _train_kernel_tp(nn, weights, xs, ts, kind, momentum,
                                      finish, events, dev)
            trace_weights(nn.kernel.weights, "train-out")
            return ok
        xs_dev, ts_dev = _upload(xs, dtype, dev), _upload(ts, dtype, dev)
        EPOCH_METRICS["stage_s"] += time.perf_counter() - t_stage
        EPOCH_METRICS["h2d_bytes"] += (xs_dev.nbytes + ts_dev.nbytes
                                       + sum(w.nbytes for w in weights))
        EPOCH_METRICS["epochs"] += 1
        EPOCH_METRICS["mode"] = "restage"
        tile, storage = 0, None
        if _tile_request(conf):
            # groups of S trained to convergence in lockstep: a documented
            # trajectory divergence for S > 1, the per-sample grammar
            # unchanged
            tile, storage = _resolve_tile(conf, weights, dtype, kind,
                                          momentum, dev)
        train_epoch_fn, _ = ops.select_train_epoch(dtype, kind=kind,
                                                   device=dev, tile=tile,
                                                   storage=storage)
        _prefetch_tests(conf, nn.kernel)
        with phase("train_epoch"):
            new_weights, stats = train_epoch_fn(weights, xs_dev, ts_dev,
                                                kind, momentum,
                                                alpha=0.2)  # :1248
            nn.kernel.weights = weights_to_numpy(new_weights)
        nn.last_epoch_stats = _emit_training_lines(events, stats, kind,
                                                   momentum)
        ok = finish()
        trace_weights(nn.kernel.weights, "train-out")
        return ok
    except DPRefused as exc:
        nn_error(f"{exc}\n")
        return False


def _dp_stage_batches(xs, ts, s: int, bsz: int, n_batches: int,
                      bsz_pad: int):
    """[batch] host staging: one fancy-index scatter of the shuffled rows
    into (n_batches, bsz_pad, n) float64 arrays.  Returns (xb, tb, mb)
    with pad slots zero and mask 1.0 on real slots."""
    xb = np.zeros((n_batches, bsz_pad, xs.shape[1]), np.float64)
    tb = np.zeros((n_batches, bsz_pad, ts.shape[1]), np.float64)
    pos, mb = _dp_slot_map(s, bsz, n_batches, bsz_pad)
    xb.reshape(-1, xs.shape[1])[pos] = xs
    tb.reshape(-1, ts.shape[1])[pos] = ts
    return xb, tb, mb


def _note_opt_state(dw, shapes, wdtype) -> None:
    """The update state's measured bytes a shard (the BPM momentum slice)
    beside the bytes a replicated layout would hold."""
    from .parallel.mesh import per_device_bytes

    params = sum(int(np.prod(sh)) for sh in shapes)
    itemsize = torch.empty((), dtype=wdtype).element_size()
    # a flat slice, the local grid's slices (one a data shard) or the
    # hybrid's row blocks (one tuple a shard): the largest shard's bytes
    shards = ([] if dw is None else
              list(dw) if isinstance(dw, (tuple, list)) else [dw])
    EPOCH_METRICS["opt_state_bytes_per_device"] = max(
        (per_device_bytes(v if isinstance(v, (tuple, list)) else [v])
         for v in shards), default=0)
    EPOCH_METRICS["opt_state_replicated_bytes"] = \
        params * itemsize * (dw is not None)


def _train_kernel_tp(nn: NNDef, weights, xs, ts, kind: str, momentum: bool,
                     finish, events, dev) -> bool:
    """Row-sharded per-sample epoch (``[model] N``, ``-S N``), restaged
    from the host: the model axis clamped to the visible devices (this
    process's, or every rank's, :func:`_model_axis`), the epoch of
    ``parallel.tp.tp_train_epoch_resident`` (at one shard the per-sample
    route itself: the ``train_epoch`` kernel on a card), every sample in
    the reference's order and grammar."""
    from .ops.convergence import stats_record
    from .parallel.tp import (carry_bytes, tp_export_weights,
                              tp_resident_carry, tp_train_epoch_resident)

    conf = nn.conf
    dtype = dtype_of(conf)
    mesh, k = _clamped_model_mesh(_model_shards(conf), dev)
    t_stage = time.perf_counter()
    xs_dev, ts_dev = _upload(xs, dtype, dev), _upload(ts, dtype, dev)
    carry = tp_resident_carry(weights, mesh)
    EPOCH_METRICS["stage_s"] += time.perf_counter() - t_stage
    EPOCH_METRICS["h2d_bytes"] += (xs_dev.nbytes + ts_dev.nbytes
                                   + sum(w.nbytes for w in weights))
    EPOCH_METRICS["epochs"] += 1
    EPOCH_METRICS["mode"] = "tp-restage"
    EPOCH_METRICS["tp_devices"] = k
    EPOCH_METRICS["weight_bytes_per_device"] = carry_bytes(carry)
    carry, stats = tp_train_epoch_resident(carry, xs_dev, ts_dev, kind,
                                           momentum, mesh, alpha=0.2)
    nn.last_epoch_stats = _emit_training_lines(
        events, stats_record(stats, dtype), kind, momentum)
    nn.kernel.weights = list(tp_export_weights(carry, mesh))
    return finish()


def _train_kernel_dp(nn: NNDef, weights, xs, ts, kind: str, momentum: bool,
                     finish, events, dev) -> bool:
    """Data-parallel minibatch epoch ([batch] B), restaged from the host.

    The reference's per-family learning rates and BPM update order, one
    minibatch step a batch of B shuffled samples.  Every sample trains:
    batches are padded to a multiple of the data shards with masked rows
    (numerically the unpadded batch).  Each data shard's share of every
    batch's slots (``parallel.mesh.shard_bounds``) is uploaded to its own
    device: the shards are the run's devices (this process's at world 1,
    every rank's across processes: a ``parallel.mesh.Grid``), and the
    gradient sums are added over them.  With [model] beside [batch] the
    devices form a (data x model) grid (``parallel.tp.tp_dp_train_epoch``).
    With a tile request in one process the route swaps its engine for the
    batched-tile one (:func:`_train_kernel_dp_tiled`)."""
    from . import ops
    from .parallel.dp import dp_epoch, dp_export_weights, dp_resident_carry
    from .parallel.mesh import shard_bounds

    conf = nn.conf
    if _tile_request(conf):
        if coord.world_size() > 1:
            # once a process, not once an epoch
            if not getattr(nn, "_tile_mp_warned", False):
                nn._tile_mp_warned = True
                nn_warn("[tile] engine is single-controller; multi-process "
                        "[batch] runs keep minibatch DP\n")
        elif _model_shards(conf) > 1:
            nn_warn("[tile] + [model] hybrid is not supported; minibatch "
                    "DP keeps the hybrid mesh\n")
        else:
            return _train_kernel_dp_tiled(nn, weights, xs, ts, kind,
                                          momentum, finish, events, dev)
    t_stage = time.perf_counter()
    lr = ops.bpm_learn_rate(kind) if momentum else ops.bp_learn_rate(kind)
    s = xs.shape[0]
    dtype = dtype_of(conf)
    ndev, n_data, n_model, clamp_warn = _dp_layout(conf, dev)
    if clamp_warn:
        nn_warn(clamp_warn)
    if n_model > 1:
        nn_out(_hybrid_banner(n_data, n_model))
    bsz, n_batches, bsz_pad = _dp_geometry(conf, s, n_data)
    for line in _dp_banner_lines(s, bsz, n_batches, bsz_pad, n_data,
                                 unsharded=ndev == 1):
        nn_out(line)
    xb, tb, mb = _dp_stage_batches(xs, ts, s, bsz, n_batches, bsz_pad)
    mesh = _dp_mesh(n_data, n_model, dev)
    hybrid = mesh is not None and n_model > 1
    # one block a data shard this process holds, uploaded to its device
    blocks = (list(zip(mesh.data_ids, mesh.data_devices()))
              if mesh is not None else [(0, dev)])
    jxb, jtb, jmb = [], [], []
    for d, bdev in blocks:
        lo, hi = shard_bounds(bsz_pad, n_data, d)
        jxb.append(_upload(np.ascontiguousarray(xb[:, lo:hi]), dtype, bdev))
        jtb.append(_upload(np.ascontiguousarray(tb[:, lo:hi]), dtype, bdev))
        jmb.append(_upload(np.ascontiguousarray(mb[:, lo:hi]), dtype, bdev))
    shapes = tuple(tuple(int(d) for d in w.shape) for w in weights)
    EPOCH_METRICS["stage_s"] += time.perf_counter() - t_stage
    EPOCH_METRICS["h2d_bytes"] += (sum(a.nbytes for a in jxb + jtb + jmb)
                                   + sum(w.nbytes for w in weights))
    EPOCH_METRICS["epochs"] += 1
    EPOCH_METRICS["mode"] = "dp-restage"
    EPOCH_METRICS["dp_devices"] = n_data
    EPOCH_METRICS["tp_devices"] = n_model
    if hybrid:
        from .parallel.tp import (carry_bytes, tp_dp_resident_carry,
                                  tp_dp_train_epoch, tp_export_weights)

        carry = tp_dp_resident_carry(weights, mesh)
        EPOCH_METRICS["weight_bytes_per_device"] = carry_bytes(carry)
        carry, dw, errs = tp_dp_train_epoch(carry, jxb, jtb, jmb, kind,
                                            momentum, lr, 0.2, mesh=mesh)
        _note_opt_state(dw, shapes, weights[0].dtype)
        new_weights = list(tp_export_weights(carry, mesh))
    else:
        w_flat = dp_resident_carry(weights, n_data)
        if mesh is None:
            jxb, jtb, jmb = jxb[0], jtb[0], jmb[0]
        w_flat, dw, errs = dp_epoch(w_flat, jxb, jtb, jmb, kind, momentum,
                                    lr, 0.2, shapes, mesh=mesh)
        _note_opt_state(dw, shapes, w_flat.dtype)
        new_weights = dp_export_weights(w_flat, shapes)
    errs = errs.to(device="cpu", dtype=torch.float64).numpy()
    for i in range(n_batches):
        nn_out(f"TRAINING BATCH {i:8d}\t err={errs[i]:15.10f}\n")
    nn.last_epoch_stats = {"samples": int(s),
                           "mean_final": float(np.mean(errs)),
                           "success": 0}
    nn.kernel.weights = new_weights
    return finish()


def _train_kernel_dp_tiled(nn: NNDef, weights, xs, ts, kind: str,
                           momentum: bool, finish, events, dev) -> bool:
    """[batch] + [tile]: the batched-tile convergence engine on the [batch]
    route.  The [batch] value is the convergence group (the S lanes of
    each lockstep step); a positive [tile] value sets how many groups ride
    one ``train_tile`` launch -- execution granularity only, the stats and
    weights identical for any value.  Over several devices of this
    process each group's lanes shard over their data mesh (torch code,
    no kernel), the group padded to a multiple of the shards."""
    from .parallel.dp import dp_tiled_epoch

    conf = nn.conf
    dtype = dtype_of(conf)
    s = xs.shape[0]
    group = min(conf.batch, s)
    req = _tile_request(conf)
    if req < 0:
        nn_warn("[tile] auto on the [batch] route: the group size IS "
                "the minibatch and [tile] only sets launch granularity "
                "(results identical for any value) -- the autotuner "
                "does not apply; default launch sizing used\n")
    storage = _tile_storage_env()
    ndev = _dp_device_count(dev)
    mesh = _dp_mesh(ndev, 1, dev)
    nn_out(_dp_tiled_banner(group, ndev, meshed=mesh is not None,
                            storage=storage))
    t_stage = time.perf_counter()
    xs_dev, ts_dev = _upload(xs, dtype, dev), _upload(ts, dtype, dev)
    EPOCH_METRICS["stage_s"] += time.perf_counter() - t_stage
    EPOCH_METRICS["h2d_bytes"] += (xs_dev.nbytes + ts_dev.nbytes
                                   + sum(w.nbytes for w in weights))
    EPOCH_METRICS["epochs"] += 1
    EPOCH_METRICS["mode"] = "dp-tiled-restage"
    EPOCH_METRICS["dp_devices"] = ndev
    new_w, stats = dp_tiled_epoch(weights, xs_dev, ts_dev, kind, momentum,
                                  group, alpha=0.2,
                                  launch_groups=max(0, req), storage=storage,
                                  mesh=mesh)
    # the per-sample grammar again: load order == stats order
    nn.last_epoch_stats = _emit_training_lines(events, stats, kind, momentum)
    nn.kernel.weights = weights_to_numpy(new_w)
    return finish()


class _EpochPipeline:
    """Device-resident multi-epoch training state.

    Built once a multi-epoch run (``ckpt.trainer.train_loop`` drives it
    through :func:`train_kernel`): the corpus is read once in listing
    order (``io.corpus.load_resident``) and uploaded once in the working
    dtype, the weights stay on the device across epochs in the master
    dtype (float32 under ``[dtype] bf16``), and the tile decision is made
    once.  Each epoch's host work is the glibc shuffle (a byte-parity
    obligation), the shuffle-order events and skip diagnostics rebuilt
    from the corpus's status codes, and one upload of an int32
    permutation; an ``index_select`` on the card gathers the epoch's rows.
    Its stats come back through a non-blocking copy and an event, so
    epoch k+1 is queued before epoch k's stats are read; the console lines
    wait in ``pending`` (with literals such as the trainer's EPOCH banner)
    and :meth:`join` renders them in order at the run's join points.

    Modes: ``resident`` (per sample, or the batched-tile engine under
    ``[tile]``: one ``train_epoch`` or ``train_tile`` launch an epoch),
    ``sharded`` (the same engines on a corpus over the device budget: see
    below),
    ``dp-resident`` (``[batch]``: the permutation scattered into batch
    slots, gathered and reshaped on the card, the minibatch epoch of
    ``parallel.dp`` on the flat weight carry; in a multi-process run each
    rank gathers its own share of every batch's slots) and
    ``dp-tiled-resident`` (``[batch]`` + ``[tile]`` in one process: the
    batched-tile engine with the batch as the group), and on the ``[model]``
    routes ``tp-resident`` (the per-sample epoch on row blocks of the model
    axis, ``parallel.tp``) and ``dp-tp-resident`` (``[batch]`` x
    ``[model]``: the minibatch epoch on the (data x model) grid).  The
    row-sharded carries stay on the device and are gathered only at the
    join points (a snapshot, the end); a clamp warning is re-emitted each
    epoch after that epoch's banner, where the restaging route prints it.

    A corpus larger than the device budget (``HPNN_EPOCH_DEVICE_BUDGET_MB``;
    unset, half the card's free memory when the pipeline is built, or on
    the CPU the JAX package's 4096 MB), or a forced
    ``HPNN_EPOCH_SHARD_ROWS`` below the row count, takes the ``sharded``
    mode: the corpus stays on the host, each epoch's shuffled selection is
    cut into shards of ``shard_rows`` rows (two shards live at once, so
    the budget's half a shard), each shard is gathered on the host from the
    listing-order rows and uploaded on ``io.corpus.io_pool()`` (pinned
    memory and a copy stream, ordered before the launch by an event) while
    the previous shard trains, and the weights stay on the card from launch
    to launch: one ``train_epoch`` (or ``train_tile``) launch a shard, the
    stats concatenated.  Per sample this is the resident trajectory bit for
    bit; a ``[batch]`` or ``[model]`` corpus over the budget restages.

    The trajectory is bit-identical to the restaging route (a cast then a
    gather equals a gather then a cast; the master weights round-trip
    through float64 losslessly; a masked slot contributes exactly zero
    whichever row fills it), and the console stream byte-identical.
    ``HPNN_NO_EPOCH_PIPELINE=1`` takes the restaging route."""

    def __init__(self, rc, dtype: torch.dtype, device: torch.device,
                 dp: str | None = None, mesh=None, tp: bool = False,
                 tp_warn: str | None = None, shard_rows: int = 0):
        self.rc = rc                      # ResidentCorpus (listing order)
        self.dtype = dtype
        self.wdtype = torch.float32 if dtype == torch.bfloat16 else dtype
        self.device = device
        self.dp = dp                      # None | "sgd" | "tiled"
        self.mesh = mesh                  # the run's grid, or None
        self.tp = tp                      # pure [model], per sample
        self.tp_warn = tp_warn            # the clamp warning, each epoch
        self.hybrid = hybrid = (dp == "sgd" and mesh is not None
                                and mesh.n_model > 1)
        self.shard_rows = shard_rows      # > 0: the host-streamed mode
        self._copy_stream = None          # its uploads' stream on a card
        self.mode = ("tp-resident" if tp else
                     "sharded" if shard_rows else
                     {None: "resident",
                      "sgd": "dp-tp-resident" if hybrid else "dp-resident",
                      "tiled": "dp-tiled-resident"}[dp])
        self.weights = None               # device carry across epochs
        self.shapes = None                # weight shapes ([batch] carry)
        self.x_dev = None                 # the resident rows on ``device``
        self.t_dev = None
        self.rows = {}                    # device -> its resident (x, t)
        self.train_fn = None
        self.b1 = False                   # train_fn is B1 on a card
        self._dp_state = None             # per-run [batch] geometry
        # the readback queued last since the last join: the next epoch's
        # start follows its end on the card
        self._last = None
        # console segments in order: ("out", text) literals, ("entries",
        # captured output) and the line renderers of epochs not joined yet
        self.pending: list = []

    @classmethod
    def build(cls, nn, conf, device):
        """The pipeline for this run, or None when the corpus is missing,
        empty, or has non-replayable diagnostics (the run then restages
        every epoch).  A warm pack loads the corpus without reading its
        files.  In a multi-process run the rows stay pack-backed
        (``prefer_mmap``) and upload in row blocks; every rank holds the
        whole corpus on its device and gathers its own slots from it."""
        names = list_sample_dir(conf.samples)
        if not names:
            return None
        multi = coord.world_size() > 1
        with obs_trace.span("corpus_load", samples=conf.samples,
                            files=len(names)):
            rc = load_resident(conf.samples, names, nn.kernel.n_inputs,
                               nn.kernel.n_outputs, prefer_mmap=multi)
        if rc is None or rc.n_rows == 0:
            return None
        dp, mesh, tp, tp_warn = None, None, False, None
        n_data = n_model = 1
        shards = _model_shards(conf)
        if conf.batch > 0:
            if (_tile_request(conf) and shards > 1
                    and coord.world_size() == 1):
                # [tile]+[model] keeps the restage route, which warns and
                # trains minibatch DP
                return None
            dp = "tiled" if _dp_tiled_route(conf) else "sgd"
            ndev, n_data, n_model, tp_warn = _dp_layout(conf, device)
            mesh = _dp_mesh(n_data, n_model, device)
        elif shards > 1:
            # pure [model]: the per-sample TP epoch on the model axis (at
            # one shard after the clamp too: the same route, so kill and
            # --resume stay byte-exact); the clamp warning is re-emitted
            # every epoch
            try:
                mesh, n_model, tp_warn = _model_axis(shards, device)
            except DPRefused:
                return None   # the restaging route refuses it
            tp = True
        dtype = dtype_of(conf)
        row_bytes = ((rc.X.shape[1] + rc.T.shape[1])
                     * torch.empty((), dtype=dtype).element_size())
        shard_rows = _shard_rows(rc.n_rows, row_bytes, n_data, device)
        if shard_rows and (dp or tp):
            nn_dbg("epoch pipeline: [batch]/[model] corpus over the "
                   "per-device budget (host-stream sharding is "
                   "single-device machinery); restaging\n")
            return None
        pipe = cls(rc, dtype, device, dp=dp, mesh=mesh, tp=tp,
                   tp_warn=tp_warn, shard_rows=shard_rows)
        if not shard_rows:
            # the one corpus upload of the run: to each distinct device of
            # a local grid's data shards, whose slots are gathered there
            for dev in pipe.row_devices():
                x = _upload_rows(rc, "x", pipe.dtype, dev)
                t = _upload_rows(rc, "t", pipe.dtype, dev)
                pipe.rows[dev] = (x, t)
                EPOCH_METRICS["setup_h2d_bytes"] += x.nbytes + t.nbytes
            pipe.x_dev, pipe.t_dev = next(iter(pipe.rows.values()))
            rc.release_rows()
        EPOCH_METRICS["tp_devices"] = n_model
        if dp or tp:
            EPOCH_METRICS["dp_devices"] = n_data
        nn_dbg(f"epoch pipeline: {pipe.mode}, {rc.n_rows} row(s)"
               + (f", shard={shard_rows}" if shard_rows else "")
               + (f", mesh={n_data}x{n_model}" if mesh is not None else "")
               + "\n")
        return pipe

    def row_devices(self) -> list:
        """Where the resident corpus is uploaded: each distinct data
        device of a [batch] grid of this process, else ``device``."""
        if self.dp == "sgd" and self.mesh is not None:
            return list(dict.fromkeys(self.mesh.data_devices()))
        return [self.device]

    def _stage_weights(self, nn) -> None:
        """The first epoch stages the float64 host weights; afterwards the
        carry stays on the device."""
        if self.weights is None:
            self.weights = weights_to_torch(nn.kernel.weights, self.wdtype,
                                            self.device)
            EPOCH_METRICS["setup_h2d_bytes"] += sum(
                w.nbytes for w in self.weights)
            self.shapes = tuple(tuple(int(d) for d in w.shape)
                                for w in self.weights)

    def _upload_sel(self, sel: np.ndarray, dev=None):
        """The epoch's one upload (an int32 index vector) to ``dev``
        (``device`` by default) and, on a card, a timing event recorded
        before it."""
        dev = self.device if dev is None else dev
        perm, start = torch.from_numpy(np.ascontiguousarray(sel)), None
        if dev.type == "cuda":
            # pinned, so the upload queues behind the previous epoch's
            # launch instead of waiting for it
            perm = perm.pin_memory()
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(dev))
        return perm.to(dev, non_blocking=True), start

    def run_epoch(self, nn, events, sel, kind: str, momentum: bool) -> int:
        """Queue one epoch's device work on the resident corpus and its
        stats readback; returns the bytes this epoch uploaded."""
        from . import ops

        if self.dp == "sgd":
            return self._run_epoch_dp(nn, sel, kind, momentum)
        if self.tp:
            return self._run_epoch_tp(nn, events, sel, kind, momentum)
        self._stage_weights(nn)
        if self.train_fn is None:
            if self.dp == "tiled":
                self.train_fn = self._dp_tiled_fn(nn.conf, kind, momentum)
            else:
                tile, storage = 0, None
                if _tile_request(nn.conf):
                    tile, storage = _resolve_tile(nn.conf, self.weights,
                                                  self.dtype, kind, momentum,
                                                  self.device)
                self.train_fn, route = ops.select_train_epoch(
                    self.dtype, kind=kind, device=self.device, tile=tile,
                    storage=storage, defer_stats=True)
                self.b1 = route == "kernel"
        if self.dp == "tiled":
            st = self._dp_state
            if st["auto_warn"]:
                nn_warn("[tile] auto on the [batch] route: the group size "
                        "IS the minibatch and [tile] only sets launch "
                        "granularity (results identical for any value) -- "
                        "the autotuner does not apply; default launch "
                        "sizing used\n")
            self.pending.append(("out", st["banner"]))
        if self.shard_rows:
            self.weights, stats, start, h2d, cycles = self._sharded_epoch(
                sel, kind, momentum)
            self._queue(_EpochLines(events, stats, self.dtype, kind,
                                    momentum, nn_log.get_verbosity(), start,
                                    cycles))
            return h2d
        with obs_trace.span("corpus_gather", rows=int(sel.size)):
            sel_dev, start = self._upload_sel(sel)
            xs = self.x_dev.index_select(0, sel_dev)
            ts = self.t_dev.index_select(0, sel_dev)
        with obs_trace.span("device_launch", rows=int(sel.size),
                            mode=self.mode):
            self.weights, stats, cycles = self._launch(self.weights, xs, ts,
                                                       kind, momentum)
        self._queue(_EpochLines(events, stats, self.dtype, kind, momentum,
                                nn_log.get_verbosity(), start, cycles))
        return sel.nbytes

    def _launch(self, weights, xs, ts, kind: str, momentum: bool):
        """One launch of the epoch function: (weights, stats, B1's phase
        counts on the card).  B1 on a card takes its instrumented
        instantiation while span tracing is on; else no counts."""
        if not (self.b1 and obs_trace.enabled()):
            w, stats = self.train_fn(weights, xs, ts, kind, momentum,
                                     alpha=0.2)
            return w, stats, []
        w, stats = self.train_fn(weights, xs, ts, kind, momentum, alpha=0.2,
                                 phases=True)
        counts = b1_kernel.train_epoch_kernel.phases
        return w, stats, [] if counts is None else [counts]

    def _queue(self, lines) -> None:
        """Queue an epoch's lines; its readback notes the end of the epoch
        queued before it, when no join came between the two."""
        lines.readback.prev_end = (self._last.end if self._last is not None
                                   else None)
        self._last = lines.readback
        self.pending.append(lines)

    def _sharded_epoch(self, sel, kind: str, momentum: bool):
        """One shuffled epoch over a corpus kept on the host: shards of
        ``shard_rows`` rows gathered from the listing-order rows and
        uploaded on the io_pool while the previous shard trains, the
        weights carried on the device from launch to launch.  Returns
        (weights, the concatenated (S, 5) stats, the start event on a card,
        the bytes uploaded, each launch's B1 phase counts when
        instrumented)."""
        X, T, k = self.rc.X, self.rc.T, self.shard_rows
        n = int(sel.size)
        dev, dtype = self.device, self.dtype
        cuda = dev.type == "cuda"
        compute = start = None
        if cuda:
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(dev)
            compute = torch.cuda.current_stream(dev)
            start = torch.cuda.Event(enable_timing=True)
            start.record(compute)

        def prep(lo):
            # the host gather, then the same cast as the resident upload
            idx = sel[lo:lo + k]
            xs = torch.as_tensor(X[idx], dtype=torch.float64).to(dtype)
            ts = torch.as_tensor(T[idx], dtype=torch.float64).to(dtype)
            if not cuda:
                return xs, ts, None
            xs, ts = xs.pin_memory(), ts.pin_memory()
            with torch.cuda.stream(self._copy_stream):
                xs = xs.to(dev, non_blocking=True)
                ts = ts.to(dev, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._copy_stream)
            return xs, ts, done

        pool = corpus_io.io_pool()
        w, parts, h2d, cycles = self.weights, [], 0, []
        nxt = pool.submit(prep, 0)
        for lo in range(0, n, k):
            xs, ts, done = nxt.result()
            if lo + k < n:
                nxt = pool.submit(prep, lo + k)
            if done is not None:
                # the launch waits for its shard's copy; the copy stream's
                # memory is held until the launch has read it
                compute.wait_event(done)
                xs.record_stream(compute)
                ts.record_stream(compute)
            h2d += xs.nbytes + ts.nbytes
            with obs_trace.span("device_launch", shard_lo=lo,
                                rows=int(xs.shape[0]), mode=self.mode):
                w, st, counts = self._launch(w, xs, ts, kind, momentum)
            parts.append(st)
            cycles += counts
        stats = parts[0] if len(parts) == 1 else torch.cat(parts)
        return w, stats, start, h2d, cycles

    def _run_epoch_tp(self, nn, events, sel, kind: str,
                      momentum: bool) -> int:
        """One per-sample epoch on the resident row-block carry
        (``parallel.tp.tp_train_epoch_resident``): only the permutation
        crosses to the device."""
        from .parallel.tp import (carry_bytes, tp_resident_carry,
                                  tp_train_epoch_resident)

        if self.tp_warn:
            self.pending.append(("entries", [("warn", self.tp_warn)]))
        if self.weights is None:
            self._stage_weights(nn)
            self.weights = tp_resident_carry(self.weights, self.mesh)
            EPOCH_METRICS["weight_bytes_per_device"] = carry_bytes(
                self.weights)
        with obs_trace.span("corpus_gather", rows=int(sel.size)):
            sel_dev, start = self._upload_sel(sel)
            xs = self.x_dev.index_select(0, sel_dev)
            ts = self.t_dev.index_select(0, sel_dev)
        with obs_trace.span("device_launch", rows=int(sel.size),
                            mode=self.mode):
            self.weights, stats = tp_train_epoch_resident(
                self.weights, xs, ts, kind, momentum, self.mesh, alpha=0.2)
        self._queue(_EpochLines(events, stats, self.dtype, kind, momentum,
                                nn_log.get_verbosity(), start))
        return sel.nbytes

    def _dp_tiled_fn(self, conf, kind: str, momentum: bool):
        """The [batch]+[tile] epoch function and its banner (the strings of
        :func:`_train_kernel_dp_tiled`)."""
        import functools

        from .parallel.dp import dp_tiled_epoch

        group = min(conf.batch, self.rc.n_rows)
        req = _tile_request(conf)
        storage = _tile_storage_env()
        n_data = self.mesh.n_data if self.mesh is not None else 1
        self._dp_state = {
            "auto_warn": req < 0,
            "banner": _dp_tiled_banner(group, n_data,
                                       meshed=self.mesh is not None,
                                       storage=storage)}
        return functools.partial(dp_tiled_epoch, group=group,
                                 launch_groups=max(0, req), storage=storage,
                                 defer_stats=True, mesh=self.mesh)

    def _run_epoch_dp(self, nn, sel, kind: str, momentum: bool) -> int:
        """One minibatch epoch on the resident corpus: the host scatters
        the permutation into each local data shard's batch slots (the
        epoch's only uploads, each to its shard's device), the shards'
        devices gather and reshape their batches and the epoch runs on the
        flat weight carry (on the hybrid grid, on the row-block carry of
        ``parallel.tp.tp_dp_train_epoch``)."""
        from . import ops
        from .parallel.dp import dp_epoch, dp_resident_carry
        from .parallel.mesh import shard_bounds

        if self._dp_state is None:
            s = self.rc.n_rows
            ndev, n_data, n_model, _ = _dp_layout(nn.conf, self.device)
            bsz, n_batches, bsz_pad = _dp_geometry(nn.conf, s, n_data)
            pos, mask = _dp_slot_map(s, bsz, n_batches, bsz_pad)
            owners = (list(zip(self.mesh.data_ids, self.mesh.data_devices()))
                      if self.mesh is not None else [(0, self.device)])
            blocks = []
            for d, dev in owners:
                lo, hi = shard_bounds(bsz_pad, n_data, d)
                blocks.append((lo, hi, dev, _upload(
                    np.ascontiguousarray(mask[:, lo:hi]), self.dtype, dev)))
            self._stage_weights(nn)
            banners = _dp_banner_lines(s, bsz, n_batches, bsz_pad, n_data,
                                       unsharded=ndev == 1)
            if self.hybrid:
                from .parallel.tp import carry_bytes, tp_dp_resident_carry

                banners = [_hybrid_banner(n_data, n_model)] + banners
                self.weights = tp_dp_resident_carry(self.weights, self.mesh)
                EPOCH_METRICS["weight_bytes_per_device"] = carry_bytes(
                    self.weights)
            else:
                self.weights = dp_resident_carry(self.weights, n_data)
            self._dp_state = {
                "s": s, "pos": pos, "blocks": blocks, "n_data": n_data,
                "n_batches": n_batches, "bsz_pad": bsz_pad,
                "lr": (ops.bpm_learn_rate(kind) if momentum
                       else ops.bp_learn_rate(kind)),
                "banners": banners}
            EPOCH_METRICS["dp_devices"] = n_data
        st = self._dp_state
        if self.tp_warn:
            # the restaging route warns before each epoch's banners
            self.pending.append(("entries", [("warn", self.tp_warn)]))
        for text in st["banners"]:
            self.pending.append(("out", text))
        # padded slots read row 0: their mask is 0, so they add nothing
        slots = np.zeros(st["n_batches"] * st["bsz_pad"], np.int32)
        slots[st["pos"]] = sel
        slots = slots.reshape(st["n_batches"], -1)
        sels, start, h2d = [], None, 0
        for lo, hi, dev, _ in st["blocks"]:
            mine = np.ascontiguousarray(slots[:, lo:hi])
            sel_dev, ev = self._upload_sel(mine.reshape(-1), dev)
            start = ev if start is None else start
            sels.append((sel_dev, mine.shape, dev))
            h2d += mine.nbytes
        # the gather on the card belongs to the epoch's launches, as the
        # JAX package's resident DP epoch gathers inside its program
        with obs_trace.span("device_launch", rows=int(sel.size),
                            mode=self.mode, n_data=st["n_data"]):
            xb, tb = [], []
            for sel_dev, (nb, width), dev in sels:
                x, t = self.rows[dev]
                xb.append(x.index_select(0, sel_dev).view(nb, width, -1))
                tb.append(t.index_select(0, sel_dev).view(nb, width, -1))
            mb = [b[3] for b in st["blocks"]]
            if self.hybrid:
                from .parallel.tp import tp_dp_train_epoch

                self.weights, dw, errs = tp_dp_train_epoch(
                    self.weights, xb, tb, mb, kind, momentum, st["lr"], 0.2,
                    mesh=self.mesh)
            elif self.mesh is not None:
                self.weights, dw, errs = dp_epoch(
                    self.weights, xb, tb, mb, kind, momentum, st["lr"], 0.2,
                    self.shapes, mesh=self.mesh)
            else:
                self.weights, dw, errs = dp_epoch(
                    self.weights, xb[0], tb[0], mb[0], kind, momentum,
                    st["lr"], 0.2, self.shapes)
        _note_opt_state(dw, self.shapes, self.wdtype)
        self._queue(_DPLines(errs, st["s"], nn_log.get_verbosity(), start))
        return h2d

    def join(self, nn) -> list[dict]:
        """Emit the pending console segments in order and copy the weight
        carry back to ``nn.kernel.weights`` (float64, what kernel.opt
        dumps).  Returns the joined epochs' summaries, oldest first."""
        from .parallel.dp import dp_export_weights

        with obs_trace.span("stats_drain", pending=len(self.pending)):
            return self._join(nn, dp_export_weights)

    def _join(self, nn, dp_export_weights) -> list[dict]:
        sums = []
        for item in self.pending:
            if isinstance(item, (_EpochLines, _DPLines)):
                item.readback.result()
                with obs_trace.span("epoch_render"):
                    t0 = time.perf_counter()
                    text, summary = item.render()
                    nn_log.nn_raw(text)
                    EPOCH_METRICS["render_s"] += time.perf_counter() - t0
                sums.append(summary)
                nn.last_epoch_stats = summary
            elif item[0] == "out":
                nn_out(item[1])
            else:
                nn_log.replay(item[1])
        self.pending = []
        self._last = None
        if self.weights is None:
            return sums
        with obs_trace.span("weights_export"):
            if self.tp or self.hybrid:
                from .parallel.tp import tp_export_weights

                # the row blocks gathered (a collective across ranks:
                # every rank joins at the same points) and unpadded
                nn.kernel.weights = list(tp_export_weights(self.weights,
                                                           self.mesh))
            elif self.dp == "sgd":
                nn.kernel.weights = dp_export_weights(self.weights,
                                                      self.shapes)
            else:
                nn.kernel.weights = weights_to_numpy(self.weights)
        return sums


# the device budget of the epoch pipeline when HPNN_EPOCH_DEVICE_BUDGET_MB
# is unset: this share of the card's free memory, or on the CPU the JAX
# package's default, so the CPU tests decide as it does
BUDGET_FREE_SHARE = 0.5
CPU_BUDGET_MB = 4096


def _shard_rows(n_rows: int, row_bytes: int, n_data: int, dev) -> int:
    """The sharded mode's rows a shard, or 0 for the resident upload.  A
    set ``HPNN_EPOCH_SHARD_ROWS`` decides alone (out of range or malformed,
    it forces the resident upload; the budget is not checked); else a
    corpus over the device budget (``n_data`` devices share it) gets
    shards of half the budget each, since two are live at once."""
    from .utils.env import env_int

    if os.environ.get("HPNN_EPOCH_SHARD_ROWS"):
        forced = env_int("HPNN_EPOCH_SHARD_ROWS", 0)
        return forced if 0 < forced < n_rows else 0
    if dev.type == "cuda":
        free, _ = torch.cuda.mem_get_info(dev)
        default_mb = int(free * BUDGET_FREE_SHARE) >> 20
    else:
        default_mb = CPU_BUDGET_MB
    budget = env_int("HPNN_EPOCH_DEVICE_BUDGET_MB", default_mb, lo=0) << 20
    if budget and n_rows * row_bytes // n_data > budget:
        return max(1, budget // row_bytes // 2)
    return 0


def _upload_rows(rc, which: str, dtype: torch.dtype, dev) -> torch.Tensor:
    """The resident corpus's X (``which="x"``) or T on ``dev``: one upload,
    or (pack-backed rows of a multi-process run) row blocks read through
    :meth:`ResidentCorpus.padded_row_block`, so no float64 copy of the
    whole corpus is made on the host."""
    src = rc.X if which == "x" else rc.T
    if isinstance(src, np.memmap):
        n, width = int(src.shape[0]), int(src.shape[1])
        out = torch.empty((n, width), dtype=dtype, device=dev)
        step = max(1, (64 << 20) // max(1, width * 8))
        for lo in range(0, n, step):
            hi = min(n, lo + step)
            out[lo:hi] = _upload(rc.padded_row_block(which, lo, hi, n),
                                 dtype, dev)
        return out
    return _upload(src, dtype, dev)


class _EpochLines:
    """One queued epoch's console lines: its stats record comes back from
    the card through a non-blocking copy into pinned memory, and
    :meth:`render` waits on the copy's event only when the lines are due
    (and then reads the epoch's device time from ``start``).  ``cycles``
    are the instrumented B1 launches' phase counts, copied back with the
    stats."""

    def __init__(self, events, stats: torch.Tensor, dtype, kind: str,
                 momentum: bool, verbosity: int, start=None, cycles=()):
        self.events = events
        self.dtype, self.kind, self.momentum = dtype, kind, momentum
        self.verbosity = verbosity
        self.readback = _Readback(stats, start, cycles)

    def render(self):
        stats = stats_record(self.readback.result(), self.dtype)
        return _render_training_lines(self.events, stats, self.kind,
                                      self.momentum, self.verbosity)


class _DPLines:
    """One queued [batch] epoch's ``TRAINING BATCH`` lines (one a batch)
    and its summary, rendered from the per-batch mean errors when due."""

    def __init__(self, errs: torch.Tensor, n_samples: int, verbosity: int,
                 start=None):
        self.n_samples = n_samples
        self.verbosity = verbosity
        self.readback = _Readback(errs, start)

    def render(self):
        return _render_dp_lines(self.readback.result(), self.n_samples,
                                self.verbosity)


class _Readback:
    """A device tensor's non-blocking copy into pinned host memory, with an
    event to wait on; on the CPU the tensor itself.  ``start`` (an event
    recorded before the epoch's upload) gives the epoch's device time, and
    ``prev_end`` (the end of the epoch queued just before, set by the
    pipeline) the card's gap between the two.  ``cycles``, B1's phase
    counts, ride the same copy and event."""

    def __init__(self, t: torch.Tensor, start=None, cycles=()):
        self.start = start
        self.end = self.done = self.prev_end = None
        self.cycles = list(cycles)
        if t.device.type == "cuda":
            stream = torch.cuda.current_stream(t.device)
            self.end = torch.cuda.Event(enable_timing=True)
            self.end.record(stream)
            t = _to_pinned(t)
            self.cycles = [_to_pinned(c) for c in self.cycles]
            self.done = torch.cuda.Event()
            self.done.record(stream)
        self.t = t

    def result(self) -> torch.Tensor:
        if self.done is not None:
            with obs_trace.span("stats_wait"):
                self.done.synchronize()
            if self.start is not None:
                EPOCH_METRICS["device_ms"].append(
                    self.start.elapsed_time(self.end))
                if self.prev_end is not None:
                    EPOCH_METRICS["boundary_ms"].append(
                        self.prev_end.elapsed_time(self.start))
            cyc = EPOCH_METRICS["b1_cycles"]
            for c in self.cycles:
                for name, v in zip(b1_kernel.PHASES, c.sum(0).tolist()):
                    cyc[name] = cyc.get(name, 0) + v
            self.done = self.prev_end = None
        return self.t


def _to_pinned(t: torch.Tensor) -> torch.Tensor:
    """A non-blocking copy of device tensor ``t`` into pinned host memory,
    on the current stream."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _render_dp_lines(errs, n_samples: int, verbosity: int):
    """The minibatch console stream (one ``TRAINING BATCH`` line a batch,
    :func:`_train_kernel_dp`'s format) and the epoch summary the
    checkpoint manifest records.  Returns (stdout_text, epoch_summary)."""
    errs = np.asarray(errs.to(torch.float64) if isinstance(errs, torch.Tensor)
                      else errs, dtype=np.float64)
    summary = {"samples": int(n_samples),
               "mean_final": float(np.mean(errs)) if errs.size else None,
               "success": 0}
    if verbosity <= 1:
        return "", summary
    text = "".join(f"NN: TRAINING BATCH {i:8d}\t err={e:15.10f}\n"
                   for i, e in enumerate(errs))
    return text, summary


def _pipeline_for(nn, conf, device):
    """The run's epoch pipeline: the one built at its first epoch (the
    decision is made once a run), a new one when this multi-epoch run
    qualifies, else None (the restaging route).  Across processes the
    minibatch [batch] route (hybrid too) and the [model] per-sample route
    ride it.  ``HPNN_DBG_TRACE`` keeps the run on the restaging route, as
    in the JAX package: the weight checksums read each epoch's weights
    on the host."""
    cur = getattr(nn, "_epoch_pipeline", None)
    if isinstance(cur, _EpochPipeline):
        return cur
    if cur is False:
        return None
    pipe = None
    if (nn.shuffle_rng is not None
            and conf.train in (NN_TRAIN_BP, NN_TRAIN_BPM)
            and not os.environ.get("HPNN_NO_EPOCH_PIPELINE")
            and not trace_enabled()
            and (coord.world_size() == 1
                 or (conf.batch > 0 and not _tile_request(conf))
                 or (conf.batch <= 0 and _model_shards(conf) > 1))):
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
    upload, the on-card gather and the epoch's launches; the console lines
    wait in the pipeline until the trainer joins it (at once for a caller
    that does not defer).  Every rank's shuffle must give the same
    permutation: its crc32 rides the agreement gate."""
    import zlib

    conf = nn.conf
    t0 = time.perf_counter()
    order = shuffle_order(conf, len(pipe.rc.names), nn.shuffle_rng)
    t1 = time.perf_counter()
    events, sel = pipe.rc.epoch_events(order)
    if not coord.agree_all(True, (int(sel.size), nn.kernel.n_inputs,
                                  nn.kernel.n_outputs,
                                  zlib.crc32(np.ascontiguousarray(sel)
                                             .tobytes())),
                           devices=len(_local_devices(pipe.device))):
        return False
    if coord.world_size() == 1:
        _prefetch_tests(conf, nn.kernel)
    with phase("train_epoch"):
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


# --- the jobs service's training entry --------------------------------------
#
# The jobs scheduler (``jobs/scheduler.py``) runs K workers, each pinned to
# a disjoint slice of the serve process's device list.  The slice is
# thread-local: a worker wraps its ``train_job`` in ``device_slice``, which
# also makes the slice's first card this thread's current CUDA device.
# Every device decision above (``_local_devices``: the [batch] data axis,
# the [model] axis, their grid, CG's flat state) reads the slice first, so
# the slice a job gets is its training grid, as in the JAX package; an
# explicit slice wins over ``HPNN_DP_DEVICES``.

_DEVICE_SLICE = threading.local()


def slice_devices() -> list | None:
    """This thread's pinned device slice, or None (whole process)."""
    return getattr(_DEVICE_SLICE, "devices", None)


@contextlib.contextmanager
def device_slice(devices):
    """Pin this thread's device decisions to ``devices`` (nest-safe; a
    no-op for a falsy list; repeats allowed, so ``["cpu"] * 4`` is a
    four-device grid on the CPU).  On a card, ``devices[0]`` is the
    thread's current CUDA device for the duration, so nothing unsharded
    lands on another card."""
    if not devices:
        yield
        return
    prev = getattr(_DEVICE_SLICE, "devices", None)
    _DEVICE_SLICE.devices = list(devices)
    dev = torch.device(devices[0])
    try:
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            yield
    finally:
        _DEVICE_SLICE.devices = prev


def train_job(conf_path: str, *, epochs: int, ckpt_dir: str,
              ckpt_every: int = 1, ckpt_keep: int = 0,
              kernel_out: str | None = None, resume: str | None = None,
              stop=None, on_epoch=None, replicate_to: str | None = None,
              auth_token: str | None = None, devices=None) -> dict:
    """Reentrant in-process training (the jobs service's entry).

    ``train_nn``'s checkpoint path -- configure, ``ckpt.train_loop`` with
    crash-safe snapshots, the final kernel dump and the manifest stamp --
    without the process-wide side effects the CLI owns: no runtime
    init/deinit, no cwd-relative ``kernel.tmp``/``kernel.opt`` (the caller
    names ``kernel_out``), no stderr writes, and signal handlers only on
    the main thread.  So a serve process's worker thread can call it while
    eval traffic runs, and the same conf, corpus and seed give the kernel
    bytes of an offline ``train_nn --epochs N --ckpt-every K``.

    ``resume`` names a checkpoint dir or bundle to continue bit-exactly
    (``--resume``).  ``stop``/``on_epoch`` pass through to
    :func:`ckpt.trainer.train_loop`.  ``auth_token`` is the serve token a
    mesh-router ``replicate_to`` wants.  ``devices`` pins the run to a device
    slice (:func:`device_slice`): its devices are the run's grid
    (``[batch]``, ``[model]``), its first device the home of everything
    unsharded; None trains on the runtime's device (the card unless
    ``init_all`` chose the CPU).

    Returns ``{"ok", "interrupted", "epoch", "errors", "error"}``, the JAX
    package's keys; it does not raise for conf or corpus problems (the
    scheduler maps the dict to a job status).  A checkpoint writer failure
    raises, as the CLI's flush-before-done does, and so does a kernel
    failure on a card: a job never trains on a plain version."""
    with device_slice(devices):
        if devices:
            device = torch.device(devices[0])
        else:
            from . import runtime

            device = runtime.lib_runtime.device or "cuda"
        return _train_job_pinned(
            conf_path, epochs=epochs, ckpt_dir=ckpt_dir,
            ckpt_every=ckpt_every, ckpt_keep=ckpt_keep,
            kernel_out=kernel_out, resume=resume, stop=stop,
            on_epoch=on_epoch, replicate_to=replicate_to,
            auth_token=auth_token, device=device)


def _train_job_pinned(conf_path: str, *, epochs: int, ckpt_dir: str,
                      ckpt_every: int, ckpt_keep: int,
                      kernel_out: str | None, resume: str | None,
                      stop, on_epoch, replicate_to: str | None,
                      auth_token: str | None, device) -> dict:
    from .ckpt import CheckpointManager, load_snapshot, train_loop
    from .io.kernel_io import dump_kernel_to_path

    def fail(msg: str) -> dict:
        return {"ok": False, "interrupted": False, "epoch": 0,
                "errors": [], "error": msg}

    nn = configure(conf_path)
    if nn is None or nn.kernel is None:
        return fail(f"cannot read NN configuration {conf_path}")
    snap = None
    start_epoch = 0
    if resume:
        snap = load_snapshot(resume)
        if snap is None:
            return fail(f"no resumable snapshot at {resume}")
        if snap.topology != list(nn.kernel.params):
            return fail(f"snapshot topology {snap.topology} does not "
                        f"match the configured kernel "
                        f"{list(nn.kernel.params)}")
        if snap.world_size != coord.world_size():
            return fail(f"snapshot {snap.tag} was written by a "
                        f"{snap.world_size}-process run; this run has "
                        f"{coord.world_size()}")
        # float64 weights from the bundle (not the quantized text), the
        # effective seed, the CG carry; the shuffle words go to train_loop
        nn.kernel.weights = list(snap.weights)
        nn.conf.seed = snap.seed
        nn.trainer_state = snap.trainer_state
        start_epoch = snap.epoch
    mgr = CheckpointManager(ckpt_dir, every=ckpt_every,
                            keep_last=ckpt_keep, target_epochs=epochs,
                            replicate_to=replicate_to,
                            auth_token=auth_token)
    if snap is not None:
        mgr.seed_errors(snap.errors)
    if start_epoch >= epochs:
        # nothing left to train (a job interrupted in its final epoch):
        # finish as a completed run does -- the dump, and record_final's
        # generation bump, which tells watchers the run ended
        if kernel_out:
            dump_kernel_to_path(nn.kernel, kernel_out)
            mgr.record_final(kernel_out)
        else:
            mgr.flush()
        return {"ok": True, "interrupted": False, "epoch": start_epoch,
                "errors": list(mgr.errors), "error": None}
    trained, interrupted = train_loop(
        nn, epochs, manager=mgr, start_epoch=start_epoch,
        rng_state=snap.rng_state if snap is not None else None,
        stop=stop, on_epoch=on_epoch, device=device)
    if not trained:
        mgr.flush()
        return fail("training failed")
    if kernel_out:
        # an interrupted run dumps too, as the CLI does: kernel_out holds
        # the last trained state
        dump_kernel_to_path(nn.kernel, kernel_out)
        mgr.record_final(kernel_out)
    else:
        mgr.flush()
    return {"ok": True, "interrupted": bool(interrupted),
            "epoch": len(mgr.errors), "errors": list(mgr.errors),
            "error": None}


__all__ = ["EPOCH_METRICS", "NNDef", "configure", "device_slice", "dtype_of",
           "kernel_kind", "load_tests", "native_lnn", "pipeline_active",
           "pipeline_defer_out", "pipeline_join", "reset_epoch_metrics",
           "run_kernel", "shuffle_order", "slice_devices", "train_job",
           "train_kernel"]
