"""Traffic QoS headers: priority lanes and per-request deadlines (the
port's copy of ``hpnn_tpu/serve/mesh/qos.py``'s lane and deadline
parsing).

* **Lanes** -- ``X-HPNN-Priority: high|normal|low`` (or ``0|1|2``).  The
  lower lane number dequeues first; within a lane the micro-batcher
  dequeues earliest-deadline-first (EDF).
* **Deadlines** -- ``X-HPNN-Deadline-Ms: N`` is the request's own budget
  in milliseconds; zero or negative parses (the server answers 504 at
  admission: an expired deadline is a deadline outcome, not a malformed
  request).
"""

from __future__ import annotations

import math

# lane numbering: dequeue order, lowest first.  "normal" is the default
# for requests that carry no X-HPNN-Priority header.
LANE_HIGH, LANE_NORMAL, LANE_LOW = 0, 1, 2
LANES = {"high": LANE_HIGH, "normal": LANE_NORMAL, "low": LANE_LOW}
LANE_NAMES = {v: k for k, v in LANES.items()}


def parse_priority(value: str | None) -> int:
    """Header value -> lane number; None/empty is the normal lane.
    Raises ValueError on anything else (the HTTP layer answers 400: a
    mistyped priority served as normal would be an invisible QoS bug)."""
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
    """``X-HPNN-Deadline-Ms`` header value -> seconds remaining.  Raises
    ValueError on non-numeric or non-finite input."""
    v = float(value.strip())
    if not math.isfinite(v):
        raise ValueError(f"bad deadline {value!r}")
    return v / 1e3


__all__ = ["LANE_HIGH", "LANE_NORMAL", "LANE_LOW", "LANES", "LANE_NAMES",
           "parse_priority", "parse_deadline_ms"]
