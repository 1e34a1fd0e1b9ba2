"""Mesh lifecycle events: one helper that makes worker register/eject/
readmit, failover retries and reload broadcasts (a) visible on the
console, (b) machine-readable under ``HPNN_LOG_JSON=1``, and (c) part
of the flight recorder, so the whole fleet timeline is reconstructable
from ONE trace dump.

Every lifecycle transition calls :func:`mesh_event` with a structured
event name + fields and the human console line the pre-fleet code
printed.  Emission rules:

* default (text) mode prints exactly the legacy human line through the
  same gated ``nn_out``/``nn_warn`` -- the console stream is
  byte-identical to the pre-event lines, so nothing scraping it breaks;
* ``HPNN_LOG_JSON=1`` emits the structured ``nn_event`` record instead
  (one JSON object per line -- the machine consumer opted in);
* with tracing on, the event also lands in the flight recorder as a
  zero-duration span under the well-known trace id
  :data:`MESH_TRACE_ID`, so ``GET /v1/debug/trace?trace=mesh`` (on the
  router: fleet-merged) IS the mesh's event timeline.
"""

from __future__ import annotations

import time

from ...obs import trace as obs_trace
from ...utils import nn_log

# the well-known trace id lifecycle spans file under: one query pulls
# the whole fleet timeline out of any recorder dump
MESH_TRACE_ID = "mesh"


def mesh_event(event: str, human: str, level: str = "out",
               **fields) -> None:
    """One mesh lifecycle transition.  ``human`` is the legacy console
    line (byte-identical in text mode); ``level`` picks its gate
    ("out", "warn" or "dbg").  ``fields`` are the structured payload
    for the JSON event and the recorder span."""
    if nn_log.log_json_enabled():
        # _record_span=False: the mesh.<event> recorder span below is
        # this event's one span -- no event.mesh_* double
        nn_log.nn_event(f"mesh_{event}", _record_span=False, **fields)
    elif level == "warn":
        nn_log.nn_warn(human)
    elif level == "dbg":
        nn_log.nn_dbg(human)
    else:
        nn_log.nn_out(human)
    if obs_trace.enabled():
        now = time.monotonic()
        obs_trace.record(f"mesh.{event}", now, now,
                         trace_id=MESH_TRACE_ID, **fields)
