"""Crash-safe file writes: tmp + fsync + rename.

The port's copy of the JAX package's ``io/atomic.py``.  The reference dumps its kernel with a plain
``fopen``/``fprintf`` pass (``tests/train_nn.c:224-243``): a crash
mid-write leaves a truncated file.  Every writer here goes through the
POSIX durable-replace sequence instead:

1. write the full payload to a temp file **in the destination directory**
   (rename is only atomic within one filesystem);
2. flush + ``fsync`` the temp file so the bytes are on disk before the
   name flip;
3. ``os.replace`` onto the destination (atomic on POSIX: readers see the
   old complete file or the new complete file, never a mix);
4. best-effort ``fsync`` of the parent directory so the rename itself
   survives a power cut (skipped silently where the FS refuses directory
   fsync).

Used by ``io.kernel_io.dump_kernel_to_path``, the autotuner's decision
cache (``ops/autotune.py``) and the checkpoint replica index
(``ckpt/replicate.py``).

Fault injection: every write consults the chaos layer's io domain
(``HPNN_FAULT`` rules such as ``enospc@manifest:times=1`` or
``bitflip@state.npz``) through :func:`io_fault_hook`, so the snapshot
retry and verified-resume paths are testable without a failing disk.
The hook costs nothing while chaos is unarmed: the serve package (where
the chaos module lives) is not even imported unless ``HPNN_FAULT`` is set
or a test armed it.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile

_CHAOS_MOD = __name__.rsplit(".", 2)[0] + ".serve.mesh.chaos"


def io_fault_hook(path: str, data: bytes) -> bytes:
    """Consult the chaos io domain for one pending durable write: raises
    (enospc/eio), delays (latency), or returns the payload -- possibly
    corrupted (torn/bitflip) -- that should reach the disk.  A no-op that
    imports nothing while chaos is unarmed."""
    chaos = sys.modules.get(_CHAOS_MOD)
    if chaos is None:
        if not os.environ.get("HPNN_FAULT"):
            return data  # unarmed: never pull in the serve stack
        import importlib

        chaos = importlib.import_module(_CHAOS_MOD)
    rule = chaos.pick_io(path)
    if rule is None:
        return data
    return chaos.apply_io_fault(rule, path, data)


def fsync_dir(path: str) -> None:
    """Best-effort fsync of a DIRECTORY so a just-renamed entry survives
    power loss; silently skipped where the FS does not support it."""
    with contextlib.suppress(OSError):
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Durably replace ``path`` with ``data`` (tmp + fsync + rename)."""
    data = io_fault_hook(path, data)
    dirpath = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix="." + os.path.basename(path) + ".",
                               suffix=".tmp", dir=dirpath)
    try:
        with os.fdopen(fd, "wb") as fp:
            fp.write(data)
            fp.flush()
            os.fsync(fp.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    fsync_dir(dirpath)


def atomic_write_text(path: str, text: str,
                      encoding: str = "utf-8") -> None:
    atomic_write_bytes(path, text.encode(encoding))
