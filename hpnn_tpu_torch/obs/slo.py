"""SLO tracking (the port's copy of ``hpnn_tpu/obs/slo.py``): per-kernel
availability + latency objectives with multi-window error-budget burn
rates.

An SLO here is the standard two-piece contract:

* **availability** -- at most ``1 - target`` of requests may fail with
  a server-caused error (HTTP >= 500: internal errors, mesh
  unavailability, deadline expiry).  Client-caused 4xx (bad input,
  over-quota 429) spends no budget.
* **latency** -- at most 1 % of completed requests may exceed the p99
  target (``--slo-p99-ms``); the budget is the 1 % by construction.

Each objective is tracked per kernel over TWO sliding windows -- a fast
one (default 300 s, ``HPNN_SLO_FAST_S``) and a slow one (default
3600 s, ``HPNN_SLO_SLOW_S``) -- as time-bucketed counters, so memory is
O(window / bucket) regardless of traffic and a burn-rate read is one
pass over ~256 buckets.  The *burn rate* is ``bad_fraction / budget``:
1.0 means the error budget is being spent exactly at the rate that
exhausts it over the SLO period, 14.4 (the classic fast-page threshold,
``HPNN_SLO_BURN``) means a 30-day budget dies in ~2 days.

**Alerting** follows the multi-window rule: an objective is *burning*
only when the fast AND slow windows both exceed the threshold -- the
fast window makes the alert responsive, the slow window keeps a brief
blip from paging.  On the transition into burning a structured
``nn_event("slo_burn", ...)`` fires (one JSON line under
``HPNN_LOG_JSON=1``); the event re-arms when the objective stops
burning, so a sustained incident emits one alert, not one per scrape.

Zero-cost when off: serving constructs no tracker unless an SLO knob is
set (``--slo-p99-ms`` / ``--slo-availability``), and every call site
guards on ``tracker is not None`` -- the off path is one attribute
read.

The burn signal is also an ACTUATOR input: the
transition-maintained ``burning_count`` / :meth:`SloTracker.any_burning`
is what ``serve.mesh.qos.LoadShedder`` polls per request to shed the
low QoS lane at admission while a budget burns -- one int read on the
healthy path, never a bucket scan.
"""

from __future__ import annotations

import threading
import time

from ..utils.env import env_float
from ..utils.nn_log import nn_event

# burn-rate threshold: both windows past it => burning (page-worthy)
_DEFAULT_BURN = 14.4
_DEFAULT_FAST_S = 300.0
_DEFAULT_SLOW_S = 3600.0


class _Window:
    """Time-bucketed (total, bad) counters covering the slow window;
    both burn rates read from one bucket map."""

    __slots__ = ("width", "keep", "buckets")

    def __init__(self, slow_s: float, fast_s: float,
                 resolution: int = 256):
        # bucket width: coarse enough that the slow window stays
        # ~resolution buckets, but ALWAYS fine enough that the FAST
        # window spans >= 8 buckets -- with e.g. a 24 h slow window and
        # a 300 s fast one, slow_s/256 alone would exceed the fast
        # window and its fraction would intermittently cover ZERO
        # buckets (burn flapping to 0 mid-incident)
        self.width = max(min(slow_s / resolution, fast_s / 8.0), 0.001)
        self.keep = int(slow_s / self.width) + 2
        self.buckets: dict[int, list] = {}  # idx -> [total, bad]

    def add(self, now: float, bad: bool) -> None:
        idx = int(now / self.width)
        acc = self.buckets.get(idx)
        if acc is None:
            acc = self.buckets[idx] = [0, 0]
            if len(self.buckets) > self.keep:  # prune past the slow win
                floor = idx - self.keep
                for k in [k for k in self.buckets if k < floor]:
                    del self.buckets[k]
        acc[0] += 1
        if bad:
            acc[1] += 1

    def fraction(self, now: float, window_s: float) -> tuple[float, int]:
        """(bad fraction, total) over the trailing ``window_s``."""
        floor = int((now - window_s) / self.width)
        total = bad = 0
        for idx, (t, b) in self.buckets.items():
            if idx > floor:
                total += t
                bad += b
        return (bad / total if total else 0.0), total


class _Objective:
    __slots__ = ("budget", "window", "burning", "kind", "last_eval")

    def __init__(self, kind: str, budget: float, slow_s: float,
                 fast_s: float):
        self.kind = kind
        self.budget = max(budget, 1e-9)
        self.window = _Window(slow_s, fast_s)
        self.burning = False
        self.last_eval = 0.0  # monotonic; throttles hot-path evals


class SloTracker:
    """Per-kernel availability/latency SLO state.  ``record_outcome``
    feeds the availability objective (every request, ok or not);
    ``record_latency`` feeds the latency objective (completed requests
    only -- the micro-batcher's honest whole-request wall)."""

    def __init__(self, availability: float | None = None,
                 p99_ms: float | None = None,
                 fast_s: float | None = None,
                 slow_s: float | None = None,
                 burn_threshold: float | None = None):
        self.availability = availability
        self.p99_ms = p99_ms
        self.fast_s = (fast_s if fast_s is not None
                       else env_float("HPNN_SLO_FAST_S", _DEFAULT_FAST_S))
        self.slow_s = (slow_s if slow_s is not None
                       else env_float("HPNN_SLO_SLOW_S", _DEFAULT_SLOW_S))
        self.slow_s = max(self.slow_s, self.fast_s)
        self.burn_threshold = (
            burn_threshold if burn_threshold is not None
            else env_float("HPNN_SLO_BURN", _DEFAULT_BURN))
        # hot-path evaluation throttle: a burn read scans the bucket
        # map, so records between ticks skip it -- alerts still fire no
        # later than the next tick or /metrics scrape (snapshot always
        # evaluates).  Scaled to the fast window so second-scale test
        # windows stay effectively per-record
        self.eval_interval_s = min(1.0, self.fast_s / 10.0)
        self._lock = threading.Lock()
        # (kernel, kind) -> _Objective, created on first record
        self._objectives: dict[tuple[str, str], _Objective] = {}
        self.alerts_total = 0
        # count of currently-burning objectives, maintained at the
        # burn/clear transitions: what an actuator (the load shedder)
        # polls per request -- one int read, no lock, no bucket scan
        self.burning_count = 0

    # objectives are per-kernel forever; a registry serves a handful of
    # kernels, so anything past this cap is junk input (defense in
    # depth behind the server's not-found exclusion) -- dropped, never
    # a memory / label-cardinality leak
    MAX_KERNELS = 128

    def _obj(self, kernel: str, kind: str,
             budget: float) -> _Objective | None:
        key = (kernel, kind)
        o = self._objectives.get(key)
        if o is None:
            if len(self._objectives) >= 2 * self.MAX_KERNELS:
                return None
            o = self._objectives[key] = _Objective(
                kind, budget, self.slow_s, self.fast_s)
        return o

    def record_outcome(self, kernel: str, ok: bool) -> None:
        """One request against the availability objective; ``ok`` is
        False only for server-caused failures (HTTP >= 500)."""
        if self.availability is None:
            return
        with self._lock:
            o = self._obj(kernel, "availability",
                          1.0 - self.availability)
            if o is None:
                return
            now = time.monotonic()
            o.window.add(now, not ok)
            self._maybe_evaluate_locked(kernel, o, now)

    def record_latency(self, kernel: str, seconds: float) -> None:
        """One completed request against the latency objective (bad
        when it exceeded the p99 target; the 1 % tail IS the budget)."""
        if self.p99_ms is None:
            return
        with self._lock:
            o = self._obj(kernel, "latency", 0.01)
            if o is None:
                return
            now = time.monotonic()
            o.window.add(now, seconds * 1e3 > self.p99_ms)
            self._maybe_evaluate_locked(kernel, o, now)

    # --- burn evaluation ------------------------------------------------
    def _burns_locked(self, o: _Objective,
                      now: float) -> tuple[float, float, int]:
        ffrac, _ = o.window.fraction(now, self.fast_s)
        sfrac, total = o.window.fraction(now, self.slow_s)
        return ffrac / o.budget, sfrac / o.budget, total

    def _maybe_evaluate_locked(self, kernel: str, o: _Objective,
                               now: float) -> None:
        """Throttled hot-path evaluation: the full bucket scan runs at
        most once per eval interval per objective."""
        if now - o.last_eval >= self.eval_interval_s:
            self._evaluate_locked(kernel, o)

    def _evaluate_locked(self, kernel: str, o: _Objective) -> None:
        o.last_eval = time.monotonic()
        fast, slow, total = self._burns_locked(o, o.last_eval)
        burning = (fast >= self.burn_threshold
                   and slow >= self.burn_threshold and total > 0)
        if burning and not o.burning:
            o.burning = True
            self.alerts_total += 1
            self.burning_count += 1
            # fire OUTSIDE the hot path's lock?  The event is one
            # formatted line; holding the lock keeps the transition
            # atomic (no double-fire from racing requests)
            nn_event("slo_burn", kernel=kernel, objective=o.kind,
                     fast_burn=round(fast, 2), slow_burn=round(slow, 2),
                     threshold=self.burn_threshold,
                     budget=o.budget)
        elif not burning and o.burning:
            o.burning = False
            self.burning_count = max(0, self.burning_count - 1)
            nn_event("slo_burn_cleared", kernel=kernel,
                     objective=o.kind, fast_burn=round(fast, 2),
                     slow_burn=round(slow, 2))

    def any_burning(self) -> bool:
        """True while at least one objective is burning -- the signal
        an actuator polls per request.  Deliberately reads the
        transition-maintained counter (one int read); freshness is
        bounded by the eval throttle + the /metrics scrape, both of
        which re-evaluate idle objectives."""
        return self.burning_count > 0

    def evaluate_now(self) -> bool:
        """Force a full re-evaluation of every objective (windows may
        have slid past the bad events with no new traffic to trigger
        the throttled hot-path eval).  Returns :meth:`any_burning`."""
        with self._lock:
            for (kernel, _kind), o in list(self._objectives.items()):
                self._evaluate_locked(kernel, o)
        return self.any_burning()

    # --- read side ------------------------------------------------------
    def snapshot(self) -> dict:
        """Per-kernel burn-rate gauges (what /metrics renders).
        Re-evaluates each objective, so an alert fires no later than
        the next scrape even on an idle kernel."""
        now = time.monotonic()
        out: dict = {
            "availability_target": self.availability,
            "p99_target_ms": self.p99_ms,
            "fast_window_s": self.fast_s,
            "slow_window_s": self.slow_s,
            "burn_threshold": self.burn_threshold,
            "kernels": {},
        }
        with self._lock:
            for (kernel, kind), o in sorted(self._objectives.items()):
                self._evaluate_locked(kernel, o)
                fast, slow, total = self._burns_locked(o, now)
                out["kernels"].setdefault(kernel, {})[kind] = {
                    "fast_burn": round(fast, 4),
                    "slow_burn": round(slow, 4),
                    "burning": o.burning,
                    "window_requests": total,
                    "budget": o.budget,
                }
            out["alerts_total"] = self.alerts_total
        return out
