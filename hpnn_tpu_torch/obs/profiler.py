"""On-demand device profiling: ``torch.profiler`` behind a process lock
(the port of ``hpnn_tpu/obs/profiler.py``).

Two consumers:

* ``POST /v1/debug/profile {"seconds": N}`` on a live server --
  :func:`capture` starts a profile, sleeps N seconds on the HTTP handler
  thread (the card keeps serving; the profiler observes from the side),
  stops, and reports the artifact.  One capture at a time process-wide:
  the profiler (CUPTI on the card) is a process singleton, so a second
  concurrent start is refused with :class:`ProfilerBusy`.
* ``train_nn/run_nn/serve_nn --profile-dir D`` -- :func:`profile_run`
  wraps a whole run (started after init, stopped in the CLI's finally).

The artifact is one Chrome trace (``<host>_<pid>.<ms>.pt.trace.json``, the
name ``torch.profiler.tensorboard_trace_handler`` gives, so TensorBoard's
PyTorch plugin and ``chrome://tracing`` both load the directory).  With a
card visible it records ``ProfilerActivity.CPU`` and
``ProfilerActivity.CUDA``: the device rows hold every kernel the process
launched, the hand-written ones (plain C libraries launched through
``ctypes`` on torch's current stream) under their ``__global__`` names,
with category ``kernel``.  On a CPU-only host it records CPU activity
only.  The JAX package writes XLA's ``plugins/profile`` directory
instead: a stated deviation.

While a capture runs, every ``obs.trace`` span also opens a
``torch.profiler.record_function`` of its name (``trace.
set_profiler_ranges``), so the trace shows the program's spans as host
ranges beside the kernels, on the profiler's clock.

Failures to start are reported as :class:`ProfilerUnavailable`: the
serving layer maps it to an HTTP status instead of a traceback, and a CLI
run warns and continues unprofiled (profiling is an observation, never a
reason to fail the run).
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time

from . import trace as obs_trace

_lock = threading.Lock()
_active: dict | None = None

# bound a live-server capture: a forgotten 1e9-second profile must not
# pin the (singleton) profiler forever
MAX_CAPTURE_S = 300.0


class ProfilerUnavailable(RuntimeError):
    """torch.profiler could not start (or no capture is running)."""


class ProfilerBusy(RuntimeError):
    """A capture is already running (the profiler is a singleton)."""


def _activities():
    from torch.profiler import ProfilerActivity

    import torch

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _all_threads_config():
    """``(experimental_config, threads)``: the profiler's experimental
    config with ``profile_all_threads``, and what the capture covers.
    Without it a capture started on one thread (a live server's HTTP
    handler) records no host operators of any other (the batchers, the
    mesh router's RPC threads).  A torch without the field gives the
    default config, and the record says the capture is the calling
    thread's only."""
    import torch

    cfg_cls = getattr(getattr(torch._C, "_profiler", None),
                      "_ExperimentalConfig", None)
    try:
        return cfg_cls(profile_all_threads=True), "all"
    except TypeError as exc:  # also a missing class (None is not callable)
        return None, (f"calling thread only (torch {torch.__version__}: "
                      f"no profile_all_threads: {exc})")


def _start_trace():
    cfg, threads = _all_threads_config()
    try:
        import torch.profiler

        prof = torch.profiler.profile(activities=_activities(),
                                      experimental_config=cfg)
        prof.start()
        prof.hpnn_threads = threads
    except Exception as exc:  # noqa: BLE001 -- anything here means "no
        # profile", and the caller chose between 501 and a warning
        raise ProfilerUnavailable(
            f"torch.profiler failed to start: {type(exc).__name__}: {exc}")
    obs_trace.set_profiler_ranges(torch.profiler.record_function)
    return prof


def _stop_trace(prof, out_dir: str) -> str:
    """Stop ``prof`` and write its Chrome trace into ``out_dir``; returns
    the file's path.  Pending device work is waited for first, so the
    last kernels' activity records are complete."""
    import torch

    obs_trace.set_profiler_ranges(None)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{socket.gethostname()}_{os.getpid()}."
        f"{int(time.time() * 1000)}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


def active() -> dict | None:
    """The in-flight capture's public record, or None."""
    with _lock:
        if _active is None:
            return None
        return {k: v for k, v in _active.items()
                if not k.startswith("_")}


def start(out_dir: str) -> dict:
    """Begin a capture into ``out_dir``; raises ProfilerBusy /
    ProfilerUnavailable."""
    global _active
    with _lock:
        if _active is not None:
            raise ProfilerBusy(
                f"profile already running into {_active['dir']}")
        # "started" is a display/persist timestamp (wall); the elapsed
        # math in stop() uses the monotonic anchor
        _active = {"dir": out_dir, "started": time.time(),
                   "_mono": time.monotonic()}
    t0 = time.monotonic()
    try:
        prof = _start_trace()
    except BaseException:
        with _lock:
            _active = None
        raise
    with _lock:
        _active["_prof"] = prof
        # whose host operators the trace holds: "all", or why only the
        # calling thread's
        _active["threads"] = prof.hpnn_threads
        # what starting cost (the first start in a process initialises
        # CUPTI); the capture's window begins after it
        _active["start_s"] = round(time.monotonic() - t0, 3)
        _active["_mono"] = time.monotonic()
    return active()


def stop() -> dict:
    """End the in-flight capture and write its trace; returns its record
    (``dir``, ``started``, ``start_s``, ``seconds`` captured, ``stop_s``,
    ``trace_file``; raises ProfilerUnavailable when none is running)."""
    global _active
    with _lock:
        rec = _active
    if rec is None or "_prof" not in rec:
        raise ProfilerUnavailable("no profile is running")
    t0 = time.monotonic()
    try:
        path = _stop_trace(rec["_prof"], rec["dir"])
    finally:
        with _lock:
            _active = None
    out = {k: v for k, v in rec.items() if not k.startswith("_")}
    out["seconds"] = round(t0 - rec["_mono"], 3)
    # what stopping cost: the activity buffers processed, the trace written
    out["stop_s"] = round(time.monotonic() - t0, 3)
    out["trace_file"] = path
    return out


def capture(seconds: float, out_dir: str) -> dict:
    """One-shot capture: start, sleep ``seconds`` (clamped to
    ``MAX_CAPTURE_S``), stop.  Blocking -- the debug endpoint runs it on
    the request's own handler thread."""
    seconds = min(max(0.0, float(seconds)), MAX_CAPTURE_S)
    start(out_dir)
    try:
        time.sleep(seconds)
    finally:
        rec = stop()
    return rec


@contextlib.contextmanager
def profile_run(out_dir: str | None):
    """Whole-run capture for the CLIs (``--profile-dir D``); a None dir
    is a no-op so call sites stay unconditional.  Start failures warn
    and run unprofiled; the stop is best-effort on the way out."""
    if not out_dir:
        yield
        return
    try:
        start(out_dir)
    except (ProfilerBusy, ProfilerUnavailable) as exc:
        from ..utils.nn_log import nn_warn

        nn_warn(f"profile: {exc}; run continues unprofiled\n")
        yield
        return
    try:
        yield
    finally:
        with contextlib.suppress(Exception):
            stop()
