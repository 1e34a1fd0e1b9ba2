"""Corpus loading in the seeded shuffle order: the serial semantics of the
JAX package's ``io.corpus.load_ordered``.

The reference prints each ``"<HEADER> FILE: <name>\\t"`` line BEFORE it
reads the file (``src/libhpnn.c:1230-1242``) and skips unreadable samples
without terminating that line, so the next header concatenates onto it.
:func:`load_ordered` returns those headers as events for run_kernel to
print, and emits each file's read diagnostics (stderr) in shuffle order,
exactly where the reference emits them.

The JAX package adds a packed corpus cache, a thread pool and a
device-resident corpus on top of these semantics; they are not part of
this port yet.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..utils.nn_log import nn_dbg, nn_error
from .samples import read_sample


def load_ordered(dirpath: str, names: list[str], order: list[int],
                 header: str, n_in: int, n_out: int):
    """Read samples in shuffled order.

    Returns (events, X, T): events is a list of (header_line, row) pairs
    in shuffle order; row is None for skipped files (their header is
    still printed, unterminated, exactly like the reference which emits
    the "FILE: name\\t" header before attempting the read).  X (rows,
    n_in) and T (rows, n_out) are float64, or None when no file loaded.
    """
    t0 = time.perf_counter()
    xs, ts, events = [], [], []
    for idx in order:
        name = names[idx]
        # NN_OUT(stdout,"%s FILE: %16.16s\t") -- printed before the read
        line = f"{header} FILE: {name[:16]:>16}\t"
        vec_in, vec_out = read_sample(os.path.join(dirpath, name))
        if vec_in is None or vec_out is None:
            events.append((line, None))
            continue
        if vec_in.shape[0] < n_in or vec_out.shape[0] < n_out:
            # a section count SMALLER than the kernel dimension makes the
            # reference copy past its allocation (libhpnn.c:1243, undefined
            # behavior); we skip with a diagnostic -- documented deviation
            nn_error(f"sample {name} dimension mismatch, skipped!\n")
            events.append((line, None))
            continue
        # a LARGER count is deterministic in the reference: it copies the
        # first kernel-dimension values and ignores the rest -- truncate
        events.append((line, len(xs)))
        xs.append(vec_in[:n_in])
        ts.append(vec_out[:n_out])
    nn_dbg(f"load: {len(names)} file(s), {len(xs)} row(s) in "
           f"{time.perf_counter() - t0:.3f}s (serial)\n")
    if not xs:
        return events, None, None
    return events, np.stack(xs), np.stack(ts)
