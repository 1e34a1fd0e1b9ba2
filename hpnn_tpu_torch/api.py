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
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from .io.conf import NN_TYPE_ANN, NN_TYPE_LNN, NN_TYPE_SNN, NN_TYPE_UKN
from .io.conf import NN_TRAIN_BP, NN_TRAIN_BPM, NNConf, load_conf
from .io.corpus import load_ordered
from .io.kernel_io import load_kernel
from .io.samples import list_sample_dir
from .models.kernel import (Kernel, generate_kernel, is_regression,
                            weights_to_numpy, weights_to_torch)
from .utils import nn_log
from .utils.glibc_random import GlibcRandom, shuffled_indices
from .utils.nn_log import nn_cout, nn_dbg, nn_error, nn_out

DTYPES = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}


@dataclasses.dataclass
class NNDef:
    """The reference's `nn_def` handle (include/libhpnn.h:78-89)."""

    conf: NNConf
    kernel: Kernel | None = None
    # the last train_kernel epoch's summary (samples, mean final dEp,
    # successes)
    last_epoch_stats: dict | None = None


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


def shuffle_order(conf: NNConf, n: int) -> list[int]:
    """Seeded shuffle of n files (libhpnn.c:1218-1229); seed 0 -> time()
    written back into the conf, as the reference mutates _CONF.seed."""
    if conf.seed == 0:
        conf.seed = int(time.time())
    return shuffled_indices(GlibcRandom(conf.seed), n)


def load_tests(nn: NNDef):
    """The test dir in shuffle order: ``(events, X, T)`` as
    :func:`io.corpus.load_ordered` returns them, or None when the dir
    cannot be listed (after the reference's error line)."""
    conf = nn.conf
    names = list_sample_dir(conf.tests)
    if names is None:
        nn_error(f"can't open test directory: {conf.tests}\n")
        return None
    order = shuffle_order(conf, len(names))
    return load_ordered(conf.tests, names, order, "TESTING",
                        nn.kernel.n_inputs, nn.kernel.n_outputs)


def run_kernel(nn: NNDef, device="cuda", parity: str = "strict"):
    """_NN(run,kernel) (``libhpnn.c:1306-1536``): one batched forward over
    the whole test dir on ``device``, then the reference's per-file
    grammar.  Returns the (rows, n_out) float64 outputs in shuffle order
    (None when nothing was evaluated)."""
    from . import ops

    conf = nn.conf
    if nn.kernel is None or conf.tests is None or conf.type == NN_TYPE_UKN:
        return None
    loaded = load_tests(nn)
    if loaded is None:
        return None
    events, xs, ts = loaded
    if xs is None:
        for line, _ in events:
            nn_out(line)
        return None
    dtype = dtype_of(conf)
    # LNN evaluates through the SNN branch (libhpnn.c:1455-1456) unless
    # the native linear-output head is opted in
    kind = kernel_kind(conf)
    dev = torch.device(device)
    weights = weights_to_torch(nn.kernel.weights, dtype, dev)
    xs_dev = torch.as_tensor(xs, dtype=torch.float64).to(dev).to(dtype)
    run_batch_fn, _ = ops.select_run_batch(dtype, parity=parity, kind=kind,
                                           device=dev)
    outs = run_batch_fn(weights, xs_dev, kind).to(
        device="cpu", dtype=torch.float64).numpy()
    _print_verdicts(events, outs, ts, kind, nn.kernel.n_outputs)
    return outs


def train_kernel(nn: NNDef, device="cuda") -> bool:
    """_NN(train,kernel) (``libhpnn.c:1149-1305``): the seeded shuffle of
    the sample dir, one epoch of per-sample train-to-convergence on
    ``device``, the per-sample console lines.  The trained weights go back
    to ``nn.kernel.weights`` as float64 numpy arrays."""
    from . import ops

    conf = nn.conf
    if nn.kernel is None or conf.samples is None or conf.type == NN_TYPE_UKN:
        return False
    momentum = conf.train == NN_TRAIN_BPM
    # LNN without the native opt-in warns here and in finish() but trains
    # through the SNN fallthrough (libhpnn.c:1180-1182, 1260-1261, 1291)
    supported = conf.type in (NN_TYPE_ANN, NN_TYPE_SNN) or native_lnn(conf)
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

    nn.last_epoch_stats = None
    names = list_sample_dir(conf.samples)
    if names is None:
        nn_error(f"can't open sample directory: {conf.samples}\n")
        return False
    order = shuffle_order(conf, len(names))
    events, xs, ts = load_ordered(conf.samples, names, order, "TRAINING",
                                  nn.kernel.n_inputs, nn.kernel.n_outputs)
    if xs is None or conf.train not in (NN_TRAIN_BP, NN_TRAIN_BPM):
        # CG/SPLX are declared but unimplemented (libhpnn.c:1253-1257):
        # each per-file header is printed, nothing trains, and the call
        # returns TRUE -- every header is left unterminated
        for line, _ in events:
            nn_out(line)
        return finish()
    dtype = dtype_of(conf)
    kind = kernel_kind(conf)
    dev = torch.device(device)
    # [dtype] bf16 trains float32 master weights (bfloat16 samples,
    # activations and deltas): bfloat16 storage rounds BPM-sized updates
    # away
    master = torch.float32 if dtype == torch.bfloat16 else dtype
    weights = weights_to_torch(nn.kernel.weights, master, dev)
    xs_dev = torch.as_tensor(xs, dtype=torch.float64).to(dev).to(dtype)
    ts_dev = torch.as_tensor(ts, dtype=torch.float64).to(dev).to(dtype)
    train_epoch_fn, _ = ops.select_train_epoch(dtype, kind=kind, device=dev)
    new_weights, stats = train_epoch_fn(weights, xs_dev, ts_dev, kind,
                                        momentum, alpha=0.2)  # libhpnn.c:1248
    nn.kernel.weights = weights_to_numpy(new_weights)
    nn.last_epoch_stats = _emit_training_lines(events, stats, kind, momentum)
    return finish()


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


__all__ = ["NNDef", "configure", "dtype_of", "kernel_kind", "load_tests",
           "native_lnn", "run_kernel", "shuffle_order", "train_kernel"]
