"""Verbosity-gated logging reproducing the reference's stdout grammar.

The reference routes all output through five printf-macros gated on a global
verbosity level (``include/libhpnn.h:95-122`` of ovhpa/hpnn):

    NN_DBG    verbose > 2   prefix "NN(DBG): "
    NN_OUT    verbose > 1   prefix "NN: "
    NN_COUT   verbose > 1   no prefix (continuation lines)
    NN_WARN   verbose > 0   prefix "NN(WARN): "
    NN_ERROR  always        prefix "NN(ERR): "   (stderr)

Only rank 0 prints (``common.h:81-86`` gates _OUT on MPI rank 0).  The port
runs one process, so the rank is 0 unless :func:`set_rank` says otherwise.

The tutorials scrape this grammar with grep/awk (e.g.
``tutorials/mnist/tutorial.bash:179-183`` counts PASS lines), so these exact
strings are a de-facto API of the framework.

``HPNN_LOG_JSON=1`` switches EMISSION to one JSON object per line
(``{"ts","level","msg"}``) for log pipelines; gating is unchanged and the
default stays byte-identical to the reference.

:func:`capture` diverts this thread's output into a list of (level, text)
entries and :func:`replay` emits them later through the gated functions:
the multi-epoch pipeline reads a corpus once with each file's diagnostics
captured, and queues output behind epochs whose lines are not rendered yet.

:func:`nn_event` is a structured operational event (a checkpoint bundle
that failed verification, ``ckpt_fallback``): ``event: k=v ...`` through
:func:`nn_warn` in text mode, one ungated JSON object under
``HPNN_LOG_JSON=1``.  The JAX package also mirrors each event into its
flight recorder; the port has no tracing yet.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time

_verbosity = 0
_rank = 0
_tls = threading.local()


def set_rank(rank: int) -> None:
    """The process rank output is gated on (0 in a single-process run)."""
    global _rank
    _rank = int(rank)


def set_verbosity(level: int) -> None:
    global _verbosity
    _verbosity = int(level)


def get_verbosity() -> int:
    return _verbosity


def inc_verbosity() -> None:
    global _verbosity
    _verbosity += 1
    # _NN(inc,verbose) logs the new level at DBG, so only the third -v
    # onward actually prints (libhpnn.c:73)
    nn_dbg(f"verbosity set to {_verbosity}.\n")


def dec_verbosity() -> None:
    global _verbosity
    if _verbosity > 0:
        _verbosity -= 1


def _emit(stream, text: str) -> None:
    if _rank == 0:
        stream.write(text)
        stream.flush()


def log_json_enabled() -> bool:
    return os.environ.get("HPNN_LOG_JSON", "") not in ("", "0")


def _write(stream, level: str, prefix: str, text: str) -> None:
    """One gated log line: reference-format ``prefix + text``, or a JSON
    object when HPNN_LOG_JSON=1."""
    if log_json_enabled():
        _emit(stream, json.dumps({"ts": round(time.time(), 3),
                                  "level": level, "msg": text}) + "\n")
    else:
        _emit(stream, prefix + text)


@contextlib.contextmanager
def capture(into: list | None = None):
    """Divert this thread's nn_* output into a list of (level, text)."""
    entries = into if into is not None else []
    prev = getattr(_tls, "sink", None)
    _tls.sink = entries
    try:
        yield entries
    finally:
        _tls.sink = prev


def replay(entries) -> None:
    """Emit captured entries through the normal gated functions."""
    fns = {"dbg": nn_dbg, "out": nn_out, "cout": nn_cout, "warn": nn_warn,
           "error": nn_error, "raw": nn_raw}
    for level, text in entries:
        if level == "event":   # a structured event captured in JSON mode
            _emit(sys.stdout, text if text.endswith("\n") else text + "\n")
            continue
        fns[level](text)


def nn_event(event: str, **fields) -> None:
    """A structured operational event.  ``HPNN_LOG_JSON=1`` emits one
    ungated JSON line (an event is data, not chatter); text mode renders
    ``event: k=v ...`` through :func:`nn_warn`, so the verbosity gate
    applies."""
    if log_json_enabled():
        # the full record is rendered before the capture check, so a
        # captured event replays byte for byte (ts = emission time)
        rec = {"ts": round(time.time(), 3), "level": "event",
               "event": event}
        rec.update(fields)
        line = json.dumps(rec)
        if not _captured("event", line):
            _emit(sys.stdout, line + "\n")
        return
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    nn_warn(f"{event}: {body}\n")


def _captured(level: str, text: str) -> bool:
    sink = getattr(_tls, "sink", None)
    if sink is None:
        return False
    sink.append((level, text))
    return True


def nn_dbg(text: str) -> None:
    if _captured("dbg", text):
        return
    if _verbosity > 2:
        _write(sys.stdout, "dbg", "NN(DBG): ", text)


def nn_out(text: str) -> None:
    if _captured("out", text):
        return
    if _verbosity > 1:
        _write(sys.stdout, "out", "NN: ", text)


def nn_cout(text: str) -> None:
    """Continuation output -- no prefix (libhpnn.h:107-111)."""
    if _captured("cout", text):
        return
    if _verbosity > 1:
        _write(sys.stdout, "cout", "", text)


def nn_warn(text: str) -> None:
    if _captured("warn", text):
        return
    if _verbosity > 0:
        _write(sys.stdout, "warn", "NN(WARN): ", text)


def nn_error(text: str) -> None:
    if _captured("error", text):
        return
    _write(sys.stderr, "error", "NN(ERR): ", text)


def nn_raw(text: str) -> None:
    """Pre-rendered stdout block: prefixes AND the verbosity gate were
    already applied when the text was formatted, so emission is a single
    ungated write."""
    if text and not _captured("raw", text):
        if log_json_enabled():
            _write(sys.stdout, "raw", "", text)
        else:
            _emit(sys.stdout, text)
