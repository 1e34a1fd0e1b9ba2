"""Traffic QoS policy pieces: priority lanes, per-client token-bucket
quotas, deadline parsing, and the autoscaling signal.

These are deliberately transport-free (stdlib + arithmetic only) so the
same policy objects serve the single-process server and the mesh router
-- the HTTP layer parses headers into lane/deadline values here, the
micro-batcher orders its queue by them, and /metrics derives the
desired-worker gauge from the queue state they shape.

* **Lanes** -- ``X-HPNN-Priority: high|normal|low`` (or ``0|1|2``).
  Lower lane number dequeues first; within a lane the micro-batcher
  dequeues earliest-deadline-first (EDF), so an urgent short-deadline
  request overtakes a lazy bulk one without starving whole lanes of
  accounting (per-lane queue depth is a /metrics gauge).
* **Quotas** -- one token bucket per client key (the auth token, the
  ``X-HPNN-Client`` header, or the peer address as a last resort),
  charged per ROW (the unit admission and batching are counted in).
  A denied request gets 429 ``quota_exceeded`` with a ``Retry-After``
  computed from the bucket's own refill rate -- the client is told
  exactly when tokens exist again.
* **Autoscaling signal** -- :func:`desired_workers` converts (queued
  rows, measured drain rate, live workers) into "how many workers the
  current backlog needs to drain within HPNN_MESH_TARGET_DRAIN_S".
  It is a *signal*, not a controller: smoothing/hysteresis belong to
  whatever autoscaler consumes the gauge (``serve/mesh/autoscale.py``
  is the in-tree one).
* **SLO-driven shedding** -- :class:`LoadShedder` turns the SLO burn
  signal (``obs/slo.py``) into an admission actuator: while an error
  budget is burning, LOW-lane requests are rejected at admission (429
  ``shed`` + honest Retry-After) so the remaining budget is spent on
  the traffic that matters; hysteresis keeps the gate from flapping
 .
"""

from __future__ import annotations

import math
import os
import threading
import time

from ...utils.env import env_float, env_int

# lane numbering: dequeue order, lowest first.  "normal" is the default
# for requests that carry no X-HPNN-Priority header.
LANE_HIGH, LANE_NORMAL, LANE_LOW = 0, 1, 2
LANES = {"high": LANE_HIGH, "normal": LANE_NORMAL, "low": LANE_LOW}
LANE_NAMES = {v: k for k, v in LANES.items()}


def parse_priority(value: str | None) -> int:
    """Header value -> lane number; None/empty is the normal lane.
    Raises ValueError on anything else (the HTTP layer 400s -- a typo'd
    priority silently served as normal would be an invisible QoS bug)."""
    if value is None:
        return LANE_NORMAL
    v = value.strip().lower()
    if not v:
        return LANE_NORMAL
    if v in LANES:
        return LANES[v]
    if v in ("0", "1", "2"):
        return int(v)
    raise ValueError(
        f"bad priority {value!r} (use high|normal|low or 0|1|2)")


def parse_deadline_ms(value: str) -> float:
    """``X-HPNN-Deadline-Ms`` header value -> seconds remaining.
    Raises ValueError on non-numeric input; zero/negative values parse
    (the server maps them to an immediate 504 -- an already-expired
    deadline is a deadline outcome, not a malformed request)."""
    v = float(value.strip())
    if not math.isfinite(v):
        raise ValueError(f"bad deadline {value!r}")
    return v / 1e3


def client_key(headers, peer: str | None = None) -> str:
    """Quota bucket key precedence: explicit client id header, then the
    auth token (one quota per credential), then the peer address --
    anonymous same-host clients share one bucket, which is the honest
    default when nothing identifies them."""
    if headers:
        cid = headers.get("X-HPNN-Client")
        if cid:
            return f"client:{cid.strip()}"
        auth = headers.get("Authorization") or headers.get("X-HPNN-Token")
        if auth:
            return f"token:{auth.strip()}"
    return f"peer:{peer or 'anon'}"


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst`` cap.
    ``allow(cost)`` either spends and admits, or reports how long until
    ``cost`` tokens exist (the Retry-After the 429 carries)."""

    __slots__ = ("rate", "burst", "tokens", "t_last", "last_used")

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.t_last = time.monotonic()
        self.last_used = self.t_last  # LRU age for table eviction

    def allow(self, cost: float = 1.0,
              now: float | None = None) -> tuple[bool, float]:
        now = time.monotonic() if now is None else now
        self.tokens = min(self.burst, self.tokens
                          + max(0.0, now - self.t_last) * self.rate)
        self.t_last = now
        self.last_used = now
        # a cost above the burst can never fit the bucket, but it must
        # neither be un-admittable forever (a 429 whose Retry-After can
        # never come true) nor under-billed (a burst-sized charge would
        # let large requests sustain cost/burst times the quota).  DEBT
        # model: such a request is admitted only when the bucket is
        # FULL, and charged its true cost -- tokens go negative and the
        # client pays the whole thing back at the refill rate before
        # anything else is admitted.  Long-run rate stays exact.
        threshold = min(cost, self.burst)
        if self.tokens >= threshold:
            self.tokens -= cost
            return True, 0.0
        wait = ((threshold - self.tokens) / self.rate if self.rate > 0
                else 60.0)
        return False, max(wait, 1e-3)

    def refund(self, cost: float) -> None:
        """Give tokens back (a charged request that was never served --
        e.g. rejected by queue admission right after the quota spend)."""
        self.tokens = min(self.burst, self.tokens + cost)


class QuotaTable:
    """Per-client token buckets, bounded.  Past ``max_clients`` distinct
    keys the least-recently-used bucket is evicted -- an adversarial
    client minting fresh ids must not grow server memory without bound
    (a freshly (re)minted bucket starts at full burst, so eviction can
    only ever be too GENEROUS, never wrongly deny)."""

    def __init__(self, rows_per_s: float, burst: float | None = None,
                 max_clients: int = 1024):
        if rows_per_s <= 0:
            raise ValueError(f"quota rate must be > 0: {rows_per_s}")
        self.rate = float(rows_per_s)
        # default burst: 2s of rate, but never below one max-ish request
        self.burst = float(burst) if burst else max(2.0 * self.rate, 64.0)
        self.max_clients = int(max_clients)
        self._buckets: dict[str, TokenBucket] = {}
        self._lock = threading.Lock()

    def allow(self, key: str, cost: float = 1.0) -> tuple[bool, float]:
        with self._lock:
            b = self._buckets.get(key)
            if b is None:
                b = self._buckets[key] = TokenBucket(self.rate, self.burst)
                if len(self._buckets) > self.max_clients:
                    lru = min(self._buckets,
                              key=lambda k: self._buckets[k].last_used)
                    del self._buckets[lru]
            return b.allow(cost)

    def refund(self, key: str, cost: float) -> None:
        """Return a charge that never bought service (the queue-full
        path: quota spent, then admission rejected the rows anyway --
        without the refund, obedient Retry-After clients burn their
        quota on 429s and get double-penalized for backpressure)."""
        with self._lock:
            b = self._buckets.get(key)
            if b is not None:
                b.refund(cost)

    def snapshot(self) -> dict:
        with self._lock:
            return {"clients": len(self._buckets),
                    "rows_per_s": self.rate, "burst": self.burst}


class LoadShedder:
    """SLO-driven admission gate for the low QoS lane.

    State machine, evaluated inline at admission (the off path is one
    bool + one int read):

    * **engage** the moment any SLO objective is burning (the
      tracker's transition-maintained ``burning_count``): low-lane
      requests get 429 ``shed`` with a Retry-After derived from the
      clear hysteresis -- an honest "when will you take me again";
    * **clear** only after the burn has been out for
      ``clear_after_s`` (``HPNN_SHED_CLEAR_S``, default 15 s)
      CONTINUOUSLY -- hysteresis, so a budget oscillating around the
      threshold does not flap the gate per request;
    * while active with no fresh traffic re-evaluating the windows,
      the shedder itself re-evaluates the tracker (throttled) so the
      gate can clear even if the shed traffic was the only traffic.

    Only lanes >= ``shed_lane`` (default: the low lane) are shed --
    high/normal traffic is exactly why the budget is being protected.
    """

    def __init__(self, tracker, clear_after_s: float | None = None,
                 shed_lane: int = LANE_LOW):
        self.tracker = tracker
        self.clear_after_s = (
            clear_after_s if clear_after_s is not None
            else env_float("HPNN_SHED_CLEAR_S", 15.0, lo=0.0))
        self.shed_lane = int(shed_lane)
        self._lock = threading.Lock()
        self.active = False
        self.engaged_total = 0
        self.shed_total = 0
        self.stale_served_total = 0
        self._last_burn = 0.0
        self._last_eval = 0.0
        self._eval_every = min(0.5, max(self.clear_after_s / 8.0, 0.01))

    def should_shed(self, lane: int) -> bool:
        """The admission decision for one request (also advances the
        engage/clear state machine).  Counts the shed; callers that can
        degrade instead (brownout stale-serve) use
        :meth:`gate_engaged` + the explicit counters."""
        if self.gate_engaged(lane):
            self.count_shed()
            return True
        return False

    def count_shed(self) -> None:
        with self._lock:
            self.shed_total += 1

    def count_stale(self) -> None:
        """A low-lane request served STALE (pinned to a retained prior
        generation) instead of shed -- the brownout rung between full
        service and 429 (ROADMAP 2c)."""
        with self._lock:
            self.stale_served_total += 1

    def gate_engaged(self, lane: int) -> bool:
        """Advance the engage/clear state machine and report whether
        this request's lane is gated, WITHOUT counting anything: the
        caller picks the degradation rung (serve stale vs shed) and
        records it via :meth:`count_stale` / :meth:`count_shed`."""
        if not self.active and not self.tracker.any_burning():
            return False  # steady healthy state: zero-cost
        from .events import mesh_event

        with self._lock:
            now = time.monotonic()
            burning = self.tracker.any_burning()
            if self.active and burning \
                    and now - self._last_eval >= self._eval_every:
                # shed traffic may be the ONLY traffic: without a
                # forced re-eval the windows never slide and the gate
                # never clears
                self._last_eval = now
                burning = self.tracker.evaluate_now()
            if burning:
                self._last_burn = now
                if not self.active:
                    self.active = True
                    self.engaged_total += 1
                    mesh_event(
                        "shed_engaged",
                        "mesh: shedding low-lane traffic (SLO error "
                        "budget burning)\n", level="warn",
                        lane=LANE_NAMES.get(self.shed_lane, "low"))
            elif self.active \
                    and now - self._last_burn >= self.clear_after_s:
                self.active = False
                mesh_event(
                    "shed_cleared",
                    "mesh: low-lane shedding cleared (SLO burn out "
                    f"for {self.clear_after_s:g}s)\n",
                    level="out", shed_total=self.shed_total)
            return self.active and lane >= self.shed_lane

    def retry_after_s(self) -> float:
        """What the 429 tells an obedient client: the clear hysteresis
        is the MINIMUM time until the low lane re-admits once the burn
        stops, clamped to the same [1, 60] band as the queue's."""
        return max(1.0, min(60.0, self.clear_after_s))

    def snapshot(self) -> dict:
        with self._lock:
            return {"active": self.active,
                    "engaged_total": self.engaged_total,
                    "shed_total": self.shed_total,
                    "stale_served_total": self.stale_served_total,
                    "clear_after_s": self.clear_after_s,
                    "shed_lane": LANE_NAMES.get(self.shed_lane, "low")}


def desired_workers(queued_rows: int, drain_rows_per_s: float,
                    live_workers: int,
                    target_drain_s: float | None = None,
                    max_workers: int | None = None) -> int:
    """The autoscaling gauge: workers the CURRENT backlog needs so it
    drains within ``target_drain_s`` at the measured per-worker rate.

    * no backlog -> 1 (the floor; idle capacity is the autoscaler's
      scale-down decision to smooth, not this signal's);
    * backlog but no measured rate yet -> ``live + 1`` (something is
      queued and nothing is draining: ask for more and let the next
      sample refine);
    * otherwise ``ceil(backlog / (per_worker_rate * target))``, clamped
      to [1, HPNN_MESH_MAX_WORKERS].
    """
    if target_drain_s is None:
        target_drain_s = env_float("HPNN_MESH_TARGET_DRAIN_S", 1.0)
    if max_workers is None:
        max_workers = env_int("HPNN_MESH_MAX_WORKERS", 64)
    live = max(1, int(live_workers))
    if queued_rows <= 0:
        return 1
    if drain_rows_per_s <= 0:
        return min(live + 1, max_workers)
    per_worker = drain_rows_per_s / live
    need = math.ceil(queued_rows / max(per_worker * target_drain_s, 1e-9))
    return max(1, min(int(need), max_workers))
