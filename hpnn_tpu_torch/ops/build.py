"""Build and load the port's hand-written CUDA kernels.

Each source under ``hpnn_tpu_torch/csrc/`` is compiled by ``nvcc`` into a
shared library with a plain C interface and loaded with ``ctypes`` -- no
PyTorch headers, so a build takes seconds.  Libraries go to
``build/hpnn_tpu_torch/`` beside the package (git-ignored), named by a hash
of the source and the flags, so an edited source rebuilds and an unchanged
one is reused.  Nothing here runs at import time: the first CUDA call of a
kernel builds it, and :func:`build_all` builds every kernel at once (one
``nvcc`` per source, all started together).

The native sample loader (``csrc/sample_loader.c``, plain C for the host)
is built the same way by the host C compiler (:func:`host_cc`) at its
first use; :func:`build_all` builds the CUDA kernels only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "hpnn_tpu_torch")

# kernel name -> source file under csrc/
SOURCES = {"fused_linear_act": "fused_linear_act.cu",
           "train_epoch": "train_epoch.cu",
           "train_tile": "train_tile.cu",
           "fused_bpm_update": "fused_bpm_update.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# host library name -> source file under csrc/, built by the C compiler
HOST_SOURCES = {"sample_loader": "sample_loader.c"}
CC_FLAGS = ("-O2", "-Wall", "-fPIC", "-shared")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else /usr/local/cuda's,
    else the one on PATH.  Raises when there is none."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source at "
                       "first use")


def host_cc() -> list[str]:
    """The host C compiler: $CC (split like a shell word list), else
    ``cc``, else ``gcc`` on PATH.  Raises when there is none."""
    if os.environ.get("CC"):
        return shlex.split(os.environ["CC"])
    for cand in ("cc", "gcc"):
        path = shutil.which(cand)
        if path:
            return [path]
    raise RuntimeError("no host C compiler found (set CC, or put cc or gcc "
                       "on PATH); the port's native sample loader is built "
                       "from csrc/sample_loader.c at first use")


def _source_flags(name: str) -> tuple[str, tuple[str, ...]]:
    if name in HOST_SOURCES:
        return HOST_SOURCES[name], CC_FLAGS
    return SOURCES[name], NVCC_FLAGS


def library_path(name: str) -> str:
    """Where library ``name`` lives for the current source."""
    source, flags = _source_flags(name)
    with open(os.path.join(CSRC, source), "rb") as fp:
        digest = hashlib.sha256(fp.read() + " ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start the compiler for one library; None when it is already
    built."""
    out = library_path(name)
    if os.path.isfile(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp-{os.getpid()}"
    source, flags = _source_flags(name)
    compiler = host_cc() if name in HOST_SOURCES else [nvcc()]
    cmd = [*compiler, *flags, "-o", tmp, os.path.join(CSRC, source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    """Wait for one compiler; keep its log (for nvcc's ``-Xptxas -v``:
    registers, shared memory, spills) beside the library and move the
    library in place."""
    if started is None:
        return library_path(name)
    proc, tmp, out = started
    log, _ = proc.communicate()
    with open(out[:-3] + ".log", "w") as fp:
        fp.write(log)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"{os.path.basename(proc.args[0])} failed for "
                           f"{_source_flags(name)[0]} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return out


def build_all(names=None) -> dict[str, str]:
    """Build every CUDA kernel (or ``names``) in parallel; returns name ->
    path of its shared library."""
    names = list(SOURCES if names is None else names)
    with _lock:
        started = {n: _start(n) for n in names}
        return {n: _finish(n, started[n]) for n in names}


def build_log(name: str) -> str:
    """The compiler's output for library ``name`` (empty if it was built by
    an earlier process that left no log)."""
    path = library_path(name)[:-3] + ".log"
    if not os.path.isfile(path):
        return ""
    with open(path) as fp:
        return fp.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a kernel, or the host sample loader),
    built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all([name])[name]
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(path)
    return lib
