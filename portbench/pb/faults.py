"""Faults planted under the timed path, for the readings that show the
output check fails them (``control.py --fault``) and for the CPU tests.
Each wraps the epoch function that ``hpnn_tpu_torch.ops.select_train_epoch``
returns and acts only while armed, which the harness does for the
measured window alone: the window's full-size epochs carry the fault, the
set-up's steps do not.  ``order`` reverses every window epoch's shuffle
instead."""

from __future__ import annotations

import contextlib
import functools

_ARMED = [False]


@contextlib.contextmanager
def armed():
    """A planted fault acts inside this block (the harness's window)."""
    _ARMED[0] = True
    try:
        yield
    finally:
        _ARMED[0] = False


def _unchanged(fn, weights, xs, ts, *a, **k):
    """The epoch trains, then hands back the weights it was given."""
    _, stats = fn(weights, xs, ts, *a, **k)
    return tuple(w.clone() for w in weights), stats


def _half(fn, weights, xs, ts, *a, **k):
    """Half of the rows trained; their stats stand in for the rest."""
    import torch

    h = max(1, xs.shape[0] // 2)
    w, stats = fn(weights, xs[:h], ts[:h], *a, **k)
    return w, stats[torch.arange(xs.shape[0], device=stats.device) % h]


def _altered(fn, weights, xs, ts, *a, **k):
    """One stats row a launch off by one iteration where it is produced."""
    w, stats = fn(weights, xs, ts, *a, **k)
    stats = stats.clone()
    stats[stats.shape[0] // 2, 2] += 1.0
    return w, stats


EPOCH_FAULTS = {"state_unchanged": _unchanged, "half_rows": _half,
                "answer_altered": _altered}
NAMES = (*EPOCH_FAULTS, "order")


def _when_armed(fault, fn, *a, **k):
    return fault(fn, *a, **k) if _ARMED[0] else fn(*a, **k)


@contextlib.contextmanager
def planted(name: str):
    """The program with fault ``name`` planted, for the block's duration;
    it acts while ``armed``."""
    from hpnn_tpu_torch import api, ops

    if name == "order":
        real = api.shuffle_order

        def reversed_order(*a, **k):
            order = real(*a, **k)
            return order[::-1] if _ARMED[0] else order

        api.shuffle_order = reversed_order
        try:
            yield
        finally:
            api.shuffle_order = real
        return
    real_select, fault = ops.select_train_epoch, EPOCH_FAULTS[name]

    def broken(*a, **k):
        fn, route = real_select(*a, **k)
        return functools.partial(_when_armed, fault, fn), route

    ops.select_train_epoch = broken
    try:
        yield
    finally:
        ops.select_train_epoch = real_select
