"""Checksum tracing and opt-in phase timers (the port of
``hpnn_tpu/utils/trace.py``).

The reference ships two developer debug aids and no timers:
``DBG_TRACE(array,N)`` prints ``#DBG: acc=%.15f`` -- the plain sum of an
array (``include/libhpnn/ann.h:29-33`` of ovhpa/hpnn) -- and has no call
sites in the shipped sources.  Here both are runtime knobs:

* ``HPNN_DBG_TRACE=1`` makes ``train_nn`` print the reference-format
  checksum line for every weight matrix entering and leaving training.
  A tensor on the card is read back as float64 on the host and summed by
  numpy, as the JAX package sums ``np.asarray`` of its arrays, so the
  line is byte-identical to the JAX package's for the same f64 weights.
* ``HPNN_PROFILE=1`` makes the CLIs print ``#PROF: <phase> <secs>``
  lines (sample load / epoch / eval ...).

Both print on rank 0 only, whatever the verbosity, like the reference's
macros.  ``phase`` additionally records a span into the flight recorder
(:mod:`hpnn_tpu_torch.obs`) whenever span tracing is on; the two knobs
are independent.
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager

import numpy as np

from . import nn_log


def trace_enabled() -> bool:
    return os.environ.get("HPNN_DBG_TRACE", "") not in ("", "0")


def profile_enabled() -> bool:
    return os.environ.get("HPNN_PROFILE", "") not in ("", "0")


def _emit(text: str) -> None:
    # nn_log owns the rank-0 output gate; one copy only
    nn_log._emit(sys.stdout, text)


def _host_f64(array) -> np.ndarray:
    """``array`` as a float64 numpy array on the host (a torch tensor on
    any device is copied back first)."""
    import torch

    if isinstance(array, torch.Tensor):
        return array.detach().to(device="cpu", dtype=torch.float64).numpy()
    return np.asarray(array, dtype=np.float64)


def dbg_trace(array, label: str | None = None) -> None:
    """The DBG_TRACE analog: print the array's plain f64 sum in the
    reference's exact format (``#DBG: acc=%.15f``), optionally prefixed
    by a label naming the traced array."""
    acc = float(np.sum(_host_f64(array)))
    head = f"#DBG[{label}]: " if label else "#DBG: "
    _emit(f"{head}acc={acc:.15f}\n")


def trace_weights(weights, tag: str) -> None:
    """Checksum every weight matrix when HPNN_DBG_TRACE=1 (no cost
    otherwise); tag names the site, e.g. 'train-in' / 'train-out'."""
    if not trace_enabled():
        return
    for i, w in enumerate(weights):
        dbg_trace(w, f"{tag} W{i}")


@contextmanager
def phase(name: str, **attrs):
    """Time a phase of a run: prints a ``#PROF:`` line when HPNN_PROFILE=1,
    and records a span into the flight recorder when span tracing is on
    (nested under this thread's active span).  ``attrs`` land on the
    span; the #PROF line format is unchanged.

    Both are host intervals: a kernel launched inside the phase may still
    run on the card when the phase ends, unless the phase ends in a host
    read.  Nothing here synchronizes the card."""
    from ..obs import trace as obs_trace

    prof = profile_enabled()
    sp = obs_trace.span(name, **attrs)  # shared no-op when tracing off
    if not prof:
        with sp:
            yield
        return
    t0 = time.perf_counter()
    try:
        with sp:
            yield
    finally:
        _emit(f"#PROF: {name} {time.perf_counter() - t0:.3f}s\n")
