"""Tolerant environment-knob parsing, shared by every subsystem that
reads an ``HPNN_*`` tuning value: a malformed value falls back to the
default instead of raising -- a typo'd knob must degrade a tunable,
never kill a server.  ``lo``/``hi`` clamp the RETURNED value (parsed or
default) into the knob's sane range, replacing the ad-hoc ``max(1, ...)``
wrappers each call site used to carry.  The fallback/clamp contract is
tested once, in tests/test_env.py, for every consumer."""

from __future__ import annotations

import os


def _clamp(v, lo, hi):
    if lo is not None and v < lo:
        v = lo
    if hi is not None and v > hi:
        v = hi
    return v


def env_int(name: str, default: int, lo: int | None = None,
            hi: int | None = None) -> int:
    try:
        v = int(os.environ.get(name, "") or default)
    except ValueError:
        v = default
    return _clamp(v, lo, hi)


def env_float(name: str, default: float, lo: float | None = None,
              hi: float | None = None) -> float:
    try:
        v = float(os.environ.get(name, "") or default)
    except ValueError:
        v = default
    return _clamp(v, lo, hi)


_warned_device_caps: set[str] = set()


def env_device_cap(name: str, n_devices: int,
                   default: int | None = None) -> int:
    """Device-count cap knob (``HPNN_DP_DEVICES`` / ``HPNN_TP_DEVICES``).

    Unset/0/malformed -> ``default`` (or all ``n_devices`` when
    ``default`` is None); an explicit value clamps into
    ``[1, n_devices]``.  An over-ask warns ONCE per knob name through
    the shared nn_warn stream -- per-call warns would differ between
    the resident and restage epoch paths and break console byte-parity.
    """
    n = max(1, int(n_devices))
    cap = env_int(name, 0)
    if cap <= 0:
        return n if default is None else _clamp(int(default), 1, n)
    if cap > n and name not in _warned_device_caps:
        _warned_device_caps.add(name)
        from .nn_log import nn_warn
        nn_warn(f"{name}={cap} > {n} visible device(s); using {n}\n")
    return _clamp(cap, 1, n)
