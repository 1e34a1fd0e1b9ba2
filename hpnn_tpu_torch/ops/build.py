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

The C API (:func:`shim_library`): ``csrc/hpnn_shim.c`` is built by the
host C compiler with the embedding flags of the interpreter that builds it
(``sysconfig``, what ``python3-config --embed`` gives) into
``libhpnn_tpu_torch-<sha16>.so``, and :func:`c_program` compiles a C program
of the public API (``native/train_nn.c`` and ``native/run_nn.c``
unmodified, and the port's ``csrc/apitest.c``) against the port's headers
(``csrc/include``) and that library, into the same build directory.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shlex
import shutil
import subprocess
import sys
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

# the C API: its embedding library and the C programs built against it
SHIM_SOURCE = "hpnn_shim.c"
INCLUDE = os.path.join(CSRC, "include")
NATIVE = os.path.join(os.path.dirname(_PKG), "native")
C_PROGRAMS = {"train_nn": os.path.join(NATIVE, "train_nn.c"),
              "run_nn": os.path.join(NATIVE, "run_nn.c"),
              "apitest": os.path.join(CSRC, "apitest.c")}

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


def _c_string(value: str) -> str:
    """``value`` as a C string literal (a -D macro's value)."""
    return json.dumps(value)


def embed_flags() -> tuple[list[str], list[str]]:
    """(compile flags, link flags) that embed the running interpreter, as
    ``python3-config --includes`` and ``--ldflags --embed`` give them, plus
    the paths the library bakes in: the checkout (``HPNN_PYROOT``), this
    interpreter (``HPNN_PYEXE``; a venv's python makes the embedded one
    find the venv) and its site-packages (``HPNN_PYSITE``).  Raises when
    the interpreter has no shared libpython to link."""
    import site
    import sysconfig

    var = sysconfig.get_config_var
    if not var("Py_ENABLE_SHARED"):
        raise RuntimeError(
            f"{sys.executable} has no shared libpython (Py_ENABLE_SHARED "
            "is 0): the C API's library embeds the interpreter and needs "
            "one")
    paths = sysconfig.get_paths()
    sites = [p for p in [*site.getsitepackages(), paths["purelib"],
                         paths["platlib"]] if os.path.isdir(p)]
    sites = list(dict.fromkeys(sites))
    cflags = [f"-I{INCLUDE}", f"-I{paths['include']}",
              f"-I{paths['platinclude']}",
              f"-DHPNN_PYROOT={_c_string(os.path.dirname(_PKG))}",
              f"-DHPNN_PYEXE={_c_string(sys.executable)}",
              f"-DHPNN_PYSITE={_c_string(':'.join(sites))}"]
    libdir = var("LIBDIR")
    ldflags = [f"-L{libdir}", f"-lpython{var('LDVERSION')}",
               *shlex.split(var("LIBS") or ""),
               *shlex.split(var("SYSLIBS") or ""), f"-Wl,-rpath,{libdir}"]
    return cflags, ldflags


def _digest(paths, flags) -> str:
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as fp:
            h.update(fp.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _headers() -> list[str]:
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(INCLUDE)
                  for f in fs if f.endswith(".h"))


def _compile(cmd: list[str], out: str) -> str:
    """Run one host-compiler command whose ``-o`` target is ``out``: it
    writes a temporary name that then replaces ``out``, and its log goes
    beside ``out``."""
    tmp = f"{out}.tmp-{os.getpid()}"
    cmd = [tmp if c == out else c for c in cmd]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(out + ".log", "w") as fp:
        fp.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed for "
                           f"{os.path.basename(out)} (exit "
                           f"{proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def shim_library() -> str:
    """Path of the C API's library (``libhpnn_tpu_torch-<sha16>.so``), built
    first if needed: ``csrc/hpnn_shim.c`` and the headers, hashed with the
    flags (so another interpreter or checkout builds its own)."""
    cflags, ldflags = embed_flags()
    src = os.path.join(CSRC, SHIM_SOURCE)
    flags = [*CC_FLAGS, *cflags, *ldflags]
    name = f"libhpnn_tpu_torch-{_digest([src, *_headers()], flags)}.so"
    out = os.path.join(BUILD_DIR, name)
    with _lock:
        if not os.path.isfile(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            _compile([*host_cc(), *CC_FLAGS, f"-Wl,-soname,{name}",
                      *cflags, "-o", out, src, *ldflags], out)
    return out


def c_program(name: str) -> str:
    """Path of the C program ``name`` (:data:`C_PROGRAMS`) built against
    the port's headers and :func:`shim_library`, first if needed.  Its
    source is compiled from an unmodified copy in the build directory, so
    its ``#include "libhpnn_tpu.h"`` finds the port's header."""
    lib = shim_library()
    src = C_PROGRAMS[name]
    flags = ["-O2", "-Wall", f"-I{INCLUDE}", "-Wl,-rpath,$ORIGIN", lib]
    out = os.path.join(BUILD_DIR,
                       f"{name}-{_digest([src, *_headers()], flags)}")
    with _lock:
        if not os.path.isfile(out):
            copy = f"{out}.c"
            shutil.copyfile(src, copy)
            _compile([*host_cc(), "-O2", "-Wall", f"-I{INCLUDE}", "-o", out,
                      copy, lib, "-Wl,-rpath,$ORIGIN"], out)
    return out
