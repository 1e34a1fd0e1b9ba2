"""Corpus loading in the seeded shuffle order: the serial semantics of the
JAX package's ``io.corpus.load_ordered``.

The reference prints each ``"<HEADER> FILE: <name>\\t"`` line BEFORE it
reads the file (``src/libhpnn.c:1230-1242``) and skips unreadable samples
without terminating that line, so the next header concatenates onto it.
:func:`load_ordered` returns those headers as events for run_kernel to
print, and emits each file's read diagnostics (stderr) in shuffle order,
exactly where the reference emits them.

:func:`load_resident` reads a corpus once in listing order for the
multi-epoch pipeline (``api._EpochPipeline``): every file's diagnostics are
classified into status codes that :class:`ResidentCorpus` replays in each
epoch's shuffle order, byte for byte what :func:`load_ordered` emits.  The
JAX package's packed corpus cache, pack-build lock and parallel reader
are not part of this port yet: each file is read serially once a run.

:func:`io_pool` is the process's one bounded background executor
(``HPNN_IO_THREADS`` wide): the checkpoint manager writes its bundles on
it.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from ..utils import nn_log
from ..utils.env import env_int
from ..utils.nn_log import nn_dbg, nn_error
from .samples import read_sample

# per-file status codes of a resident corpus (>= 0: the file's packed row)
ST_SILENT = -1    # unopenable/empty file: (None, None), no diagnostic
ST_IN_FAIL = -2   # "sample <path> input read failed!" on stderr
ST_OUT_FAIL = -3  # "sample <path> output read failed!" on stderr
ST_DIM = -4       # "sample <name> dimension mismatch, skipped!"
LOADED = "loaded"

_pool = None
_pool_lock = threading.Lock()


def io_threads() -> int:
    """The pool's width: ``HPNN_IO_THREADS`` when set (at least 1; a
    malformed value reads 1), 1 under ``HPNN_NO_PARALLEL_IO``, else the
    CPU count capped at 32."""
    if os.environ.get("HPNN_IO_THREADS"):
        return env_int("HPNN_IO_THREADS", 1, lo=1)
    if os.environ.get("HPNN_NO_PARALLEL_IO"):
        return 1
    return max(1, min(32, os.cpu_count() or 1))


def io_pool():
    """The shared background executor, created at first use with
    :func:`io_threads` workers (the width is fixed then)."""
    global _pool
    with _pool_lock:
        if _pool is None:
            from concurrent.futures import ThreadPoolExecutor

            _pool = ThreadPoolExecutor(max_workers=io_threads(),
                                       thread_name_prefix="hpnn-io")
        return _pool


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


def _order_events(dirpath, names, order, status, lines):
    """Shuffle-order replay of per-file status codes: the header events
    and skip diagnostics, byte-identical to what :func:`load_ordered`
    emits.  Returns (events, sel) where sel holds the packed row index of
    each loaded file in shuffle order; ``lines`` are the header lines in
    listing order."""
    rows, events = [], []
    for idx in order:
        name = names[idx]
        line = lines[idx]
        st = status[idx]
        if st >= 0:
            events.append((line, len(rows)))
            rows.append(st)
            continue
        if st == ST_IN_FAIL:
            nn_error(f"sample {os.path.join(dirpath, name)} "
                     "input read failed!\n")
        elif st == ST_OUT_FAIL:
            nn_error(f"sample {os.path.join(dirpath, name)} "
                     "output read failed!\n")
        elif st == ST_DIM:
            nn_error(f"sample {name} dimension mismatch, skipped!\n")
        events.append((line, None))
    return events, np.asarray(rows, dtype=np.int32)


def _classify(dirpath, name, vec_in, vec_out, diags, n_in, n_out):
    """Status code for one read result, or None when its diagnostics do
    not match a replayable pattern."""
    if vec_in is None or vec_out is None:
        if not diags:
            return ST_SILENT
        if len(diags) == 1 and diags[0][0] == "error":
            path = os.path.join(dirpath, name)
            if diags[0][1] == f"sample {path} input read failed!\n":
                return ST_IN_FAIL
            if diags[0][1] == f"sample {path} output read failed!\n":
                return ST_OUT_FAIL
        return None
    if diags:
        return None
    if vec_in.shape[0] < n_in or vec_out.shape[0] < n_out:
        return ST_DIM
    return LOADED


def _classify_results(dirpath, names, n_in, n_out, results):
    """(status, X, T) in listing order from the read results, or None when
    any file's diagnostics are non-replayable."""
    status, rows_x, rows_t = [], [], []
    for idx, name in enumerate(names):
        vec_in, vec_out, diags = results[idx]
        st = _classify(dirpath, name, vec_in, vec_out, diags, n_in, n_out)
        if st is None:
            return None
        if st is LOADED:
            status.append(len(rows_x))
            rows_x.append(np.ascontiguousarray(vec_in[:n_in], np.float64))
            rows_t.append(np.ascontiguousarray(vec_out[:n_out], np.float64))
        else:
            status.append(st)
    if not rows_x:
        return status, None, None
    return status, np.stack(rows_x), np.stack(rows_t)


class ResidentCorpus:
    """One listing-order copy of a training corpus, read once a run for the
    device-resident epoch pipeline (``api._EpochPipeline``).

    ``X``/``T`` hold the loaded rows in listing order and ``status`` maps
    each listing index to its row (>= 0) or skip class (< 0).  Every
    epoch's console bytes and device gather indices come from these through
    :meth:`epoch_events`, so after the first read no epoch touches the
    corpus files again."""

    def __init__(self, dirpath: str, names: list[str], status: list[int],
                 X, T):
        self.dirpath = dirpath
        self.names = names
        self.status = status
        self.X = X            # (n_rows, n_in) float64, listing order, or None
        self.T = T
        self.n_rows = 0 if X is None else int(X.shape[0])
        # header lines are the same every epoch: formatted once
        self._lines = [f"TRAINING FILE: {n[:16]:>16}\t" for n in names]

    def release_rows(self) -> None:
        """Drop the host rows once the device holds the corpus (epoch
        replay needs only names, status and headers)."""
        self.X = None
        self.T = None

    def epoch_events(self, order: list[int]):
        """(events, sel) for one epoch's shuffle order; emits the skip
        diagnostics (stderr) exactly like the per-file load would."""
        return _order_events(self.dirpath, self.names, order, self.status,
                             self._lines)


def _read_captured(path: str):
    with nn_log.capture() as diags:
        vec_in, vec_out = read_sample(path)
    return vec_in, vec_out, diags


def load_resident(dirpath: str, names: list[str], n_in: int, n_out: int):
    """Read a corpus once in listing order for device residency: every file
    serially, its diagnostics captured and classified into replayable
    status codes.  Returns a :class:`ResidentCorpus`, or None when a file's
    diagnostics are non-replayable (the caller keeps the per-epoch
    :func:`load_ordered` route, which emits them as they come).  Prints
    nothing of its own beyond a dbg summary: the per-epoch skip
    diagnostics come from :meth:`ResidentCorpus.epoch_events`."""
    if n_in <= 0 or n_out <= 0:
        return None
    t0 = time.perf_counter()
    results = [_read_captured(os.path.join(dirpath, n)) for n in names]
    classified = _classify_results(dirpath, names, n_in, n_out, results)
    if classified is None:
        nn_dbg("resident corpus: non-replayable diagnostics; "
               "per-epoch loads\n")
        return None
    status, X, T = classified
    rc = ResidentCorpus(dirpath, names, status, X, T)
    nn_dbg(f"resident corpus: {len(names)} file(s), {rc.n_rows} row(s) "
           f"staged once in {time.perf_counter() - t0:.3f}s\n")
    return rc
