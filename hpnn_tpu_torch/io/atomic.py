"""Crash-safe file writes: tmp + fsync + rename.

The port's copy of the JAX package's ``io/atomic.py``, without its
fault-injection hook.  The reference dumps its kernel with a plain
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
"""

from __future__ import annotations

import contextlib
import os
import tempfile


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
