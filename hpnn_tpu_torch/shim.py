"""Python entry points of the port's C library (``csrc/hpnn_shim.c``).

The C library serves the reference's whole ``_NN(a,b)`` surface
(``include/libhpnn.h``) from an embedded interpreter; every call lands here
or in :mod:`hpnn_tpu_torch.api`.  These helpers keep the C side a plain
dispatcher: enum to string mapping, handle creation, the kernel lifecycle
of the varargs calls, and the runtime knobs all live in Python.  The port
of ``hpnn_tpu/shim.py``.

Enum values mirror the reference header (``nn_type``, ``nn_train``); the C
side passes the raw ints.  The C surface has no ``--device``:
:func:`init_all` takes the device from ``HPNN_DEVICE`` (default ``cuda``),
that flag's counterpart, and a GPU that is asked for and not visible makes
it return -1 with the ``NN(ERR)`` line, as the CLIs exit non-zero.
"""

from __future__ import annotations

import os

from . import runtime
from .api import NNDef, dump_kernel_def
from .api import run_kernel as _run_kernel
from .api import train_kernel as _train_kernel
from .io.conf import (NN_TRAIN_BP, NN_TRAIN_BPM, NN_TRAIN_CG, NN_TRAIN_SPLX,
                      NN_TRAIN_UKN, NN_TYPE_ANN, NN_TYPE_LNN, NN_TYPE_SNN,
                      NN_TYPE_UKN, NNConf, dump_conf)
from .io.kernel_io import load_kernel
from .io.samples import read_sample
from .models.kernel import generate_kernel
from .utils import nn_log
from .utils.nn_log import nn_out

_TYPE_TO_INT = {NN_TYPE_ANN: 0, NN_TYPE_LNN: 1, NN_TYPE_SNN: 2,
                NN_TYPE_UKN: -1}
_INT_TO_TYPE = {v: k for k, v in _TYPE_TO_INT.items()}
_TRAIN_TO_INT = {NN_TRAIN_BP: 0, NN_TRAIN_BPM: 1, NN_TRAIN_CG: 2,
                 NN_TRAIN_SPLX: 3, NN_TRAIN_UKN: -1}
_INT_TO_TRAIN = {v: k for k, v in _TRAIN_TO_INT.items()}


# --- the runtime ------------------------------------------------------------

# the knobs the C surface sets and reads back (libhpnn.c:409-539); only -S
# (the stream count, runtime.set_cuda_streams) changes what the port does
_knobs = {"omp_threads": 1, "omp_blas": 1, "mpi_tasks": 1, "n_gpu": 1}


def init_all(init_verbose: int = 0) -> int:
    """_NN(init,all) (libhpnn.c:326-347) on ``HPNN_DEVICE`` (default
    ``cuda``): the verbosity is ``init_verbose`` while the runtime comes up
    and 0 after, as in the JAX package.  Returns 0, or -1 with an NN(ERR)
    line when the device is not visible."""
    _knobs.update(omp_threads=1, omp_blas=1, mpi_tasks=1, n_gpu=1)
    nn_log.set_verbosity(int(init_verbose))
    rc = runtime.init_all(os.environ.get("HPNN_DEVICE") or "cuda")
    nn_log.set_verbosity(0)
    return rc


def deinit_all() -> int:
    return runtime.deinit_all()


def toggle_dry() -> None:
    """_NN(toggle,dry): the reference's ``nn_dry^=nn_dry`` always yields
    FALSE (libhpnn.c:88-90); a no-op here as there."""


def return_capabilities() -> int:
    """The capability bits of the live runtime, recomputed on each call
    (the reference re-derives its compile-time bits the same way)."""
    return runtime.return_capabilities()


def unset_capability(bit: int) -> None:
    """_NN(unset,capability): masks the STORED runtime bit."""
    runtime.lib_runtime.capability &= ~int(bit)


def _true(*_args) -> bool:
    """_NN(init|deinit,OMP|MPI|CUDA|BLAS): torch brings its own threads,
    device and BLAS up with the first call; a one-process world is an MPI
    world of one."""
    return True


init_omp = init_mpi = init_cuda = init_blas = _true
deinit_omp = deinit_mpi = deinit_cuda = deinit_blas = _true


def set_omp_threads(n: int) -> bool:
    _knobs["omp_threads"] = max(1, int(n))
    return True


def get_omp_threads() -> int:
    return _knobs["omp_threads"]


def set_omp_blas(n: int) -> bool:
    _knobs["omp_blas"] = max(1, int(n))
    return True


def get_omp_blas() -> int:
    return _knobs["omp_blas"]


def set_mpi_tasks(n: int) -> bool:
    nn_log.nn_warn("process count is owned by the launcher; "
                   "stored for reporting only\n")
    _knobs["mpi_tasks"] = max(1, int(n))
    return True


def get_mpi_tasks() -> int:
    from .parallel import coord

    return max(_knobs["mpi_tasks"], coord.world_size())


def get_curr_mpi_task() -> int:
    from .parallel import coord

    return coord.process_index()


def set_n_gpu(n: int) -> bool:
    nn_log.nn_warn("device count is owned by the platform runtime; "
                   "stored for reporting only\n")
    _knobs["n_gpu"] = max(1, int(n))
    return True


def get_n_gpu() -> int:
    return _knobs["n_gpu"]


def set_cuda_streams(n: int) -> bool:
    return runtime.set_cuda_streams(n)


def get_cuda_streams() -> int:
    return runtime.get_cuda_streams()


def get_n_devices() -> int:
    """Devices of the runtime's kind this process sees (1 on the CPU)."""
    import torch

    dev = runtime.lib_runtime.device
    if dev is not None and dev.type == "cuda":
        return torch.cuda.device_count()
    return 1


# --- the handle -------------------------------------------------------------

def new_nndef() -> NNDef:
    """A blank handle for _NN(init,conf)-style construction."""
    return NNDef(conf=NNConf())


def conf_as_tuple(nn: NNDef):
    """The C mirror's pull: (name, type, need_init, seed, f_kernel, train,
    samples, tests) with the enums as the reference's ints."""
    c = nn.conf
    return (c.name, _TYPE_TO_INT.get(c.type, -1), int(bool(c.need_init)),
            int(c.seed), c.f_kernel, _TRAIN_TO_INT.get(c.train, -1),
            c.samples, c.tests)


def conf_set(nn: NNDef, key: str, value) -> None:
    """The C accessors' push; enum ints map to the conf's strings."""
    c = nn.conf
    if key == "type":
        c.type = _INT_TO_TYPE.get(int(value), NN_TYPE_UKN)
    elif key == "train":
        c.train = _INT_TO_TRAIN.get(int(value), NN_TRAIN_UKN)
    elif key == "need_init":
        c.need_init = bool(value)
    elif key == "seed":
        c.seed = int(value)
    elif key in ("name", "f_kernel", "samples", "tests"):
        setattr(c, key, value)
    else:
        raise KeyError(key)


def generate_kernel_dims(nn: NNDef, n_inputs: int, n_outputs: int,
                         hiddens) -> bool:
    """_NN(generate,kernel) (libhpnn.c:954-980): a kernel from explicit
    dimensions on conf.seed, the effective seed written back (the reference
    passes &_CONF.seed to ann_generate)."""
    if nn.conf.type not in (NN_TYPE_ANN, NN_TYPE_SNN):
        return False
    if n_inputs <= 0 or n_outputs <= 0 or not hiddens:
        return False
    kernel, eff_seed = generate_kernel(
        nn.conf.seed, int(n_inputs), [int(h) for h in hiddens],
        int(n_outputs), name="(null)")
    nn.conf.seed = eff_seed
    nn.kernel = kernel
    nn_out(f"[CPU] ANN total allocation: {kernel.allocation_bytes} "
           "(bytes)\n")
    return True


def load_kernel_file(nn: NNDef) -> bool:
    """_NN(load,kernel) (libhpnn.c:981-996)."""
    if nn.conf.f_kernel is None:
        return False
    if nn.conf.type not in (NN_TYPE_ANN, NN_TYPE_SNN):
        return False
    kernel = load_kernel(nn.conf.f_kernel)
    if kernel is None:
        return False
    nn.kernel = kernel
    nn_out(f"[CPU] ANN total allocation: {kernel.allocation_bytes} "
           "(bytes)\n")
    return True


def free_kernel(nn: NNDef) -> None:
    """_NN(free,kernel) (libhpnn.c:941-953)."""
    nn.kernel = None


def dump_kernel_to(nn: NNDef, pyfile) -> bool:
    if nn.kernel is None:
        return False
    return dump_kernel_def(nn, pyfile)


def dump_conf_to(nn: NNDef, pyfile) -> None:
    """_NN(dump,conf) (libhpnn.c:885-937)."""
    dump_conf(nn.conf, pyfile, kernel=nn.kernel)


def get_n_hiddens(nn: NNDef) -> int:
    return nn.kernel.n_hiddens if nn.kernel else 0


def get_h_neurons(nn: NNDef, layer: int) -> int:
    """_NN(get,h_neurons): the neurons of hidden layer ``layer`` (0-based,
    libhpnn.c:1040-1053)."""
    if nn.kernel is None:
        return 0
    hid = nn.kernel.hiddens
    if layer >= len(hid):
        return 0
    return int(hid[int(layer)])


def read_sample_lists(path: str):
    """_NN(read,sample): (list_in, list_out), or None on failure."""
    vec_in, vec_out = read_sample(path)
    if vec_in is None or vec_out is None:
        return None
    return [float(v) for v in vec_in], [float(v) for v in vec_out]


# --- the drivers ------------------------------------------------------------

def train_kernel(nn: NNDef) -> bool:
    """_NN(train,kernel) on the device :func:`init_all` chose; False when
    it chose none (its NN(ERR) line said why)."""
    dev = runtime.lib_runtime.device
    return dev is not None and _train_kernel(nn, device=dev)


def run_kernel(nn: NNDef) -> None:
    """_NN(run,kernel) on the device :func:`init_all` chose; nothing when
    it chose none."""
    dev = runtime.lib_runtime.device
    if dev is not None:
        _run_kernel(nn, device=dev)
