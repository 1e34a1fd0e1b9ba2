"""Observability of the port (the port of ``hpnn_tpu/obs``): structured
span tracing, an in-process flight recorder, a durable span spool with
its index and analytics, and on-demand device profiling.

* :mod:`.trace` -- spans.  ``span("name")`` times a region and records
  it (name, trace id, parent, monotonic start, duration, attributes)
  into a bounded ring buffer -- the *flight recorder* -- that is
  dumpable as NDJSON at any time (``GET /v1/debug/trace`` on a live
  server, or :func:`dump_to_dir` from a signal handler).  Tracing is
  OFF by default and the off path is a single global ``is None`` check
  returning a shared no-op singleton -- zero allocation, so the serving
  hot path pays nothing when idle.  Spans are HOST intervals: a kernel
  launch returns before the card finishes, so a span around one ends
  when the host moves on; the card's own times are the serve path's
  CUDA events and the profile.
* the serving and training paths thread trace CONTEXT through them:
  a serve request's trace id (``X-HPNN-Trace-Id``, or generated) links
  the HTTP handler's spans to the batcher's even though they run on
  different threads (explicit ``trace_id``/``parent_id`` on
  :func:`record`); training epochs nest their phases through the
  thread-local span stack.
* :mod:`.export` ships recorded spans through a bounded background
  spool into rotating NDJSON segments (``--span-dir``), :mod:`.index`
  gives each finalized segment a sidecar index, :mod:`.analyze` builds
  critical-path reports and the incident timeline, and :mod:`.tool`
  answers the same queries offline.
* :mod:`.profiler` -- ``torch.profiler`` wrapped for one-shot live
  captures (``POST /v1/debug/profile``) and whole-run captures
  (``train_nn --profile-dir D``): a Chrome trace with the card's kernels
  (the hand-written ones under their ``__global__`` names) beside the
  host's operators.

``HPNN_TRACE=1`` enables tracing at ``init_all`` / server start;
``HPNN_TRACE_BUFFER=N`` sizes the ring (default 8192 spans);
``HPNN_TRACE_SAMPLE=p`` / ``--trace-sample`` decides keep/drop ONCE at
trace birth (explicit trace ids and high-QoS requests force capture).
Spans carry a monotone ``seq`` for incremental collection
(``/v1/debug/trace?since_seq=N``), and :func:`set_role` names the
process's role in auto-dump filenames.
"""

# --- structured event-name registry ---------------------------------------
# Every ``nn_event``/``mesh_event`` name emitted anywhere in the tree,
# declared HERE with the subsystem category the incident timeline files
# it under (the JAX package's table, copied whole: a spool either
# package wrote files the same events).  A source-scanning test fails on
# any literal event name missing from this table, so the
# timeline's event -> category mapping can never silently rot: adding
# an event means declaring it.  (``mesh_event`` names emit with the
# ``mesh_`` prefix -- declare the prefixed form.)
EVENT_NAMES: dict[str, str] = {
    # serve hot path
    "slow_request": "serve",
    # SLO error-budget burn (obs/slo.py)
    "slo_burn": "slo",
    "slo_burn_cleared": "slo",
    # checkpoint verification / resume fallback (ckpt/)
    "ckpt_fallback": "ckpt",
    # online-training jobs lifecycle (jobs/)
    "job_lease_expired": "jobs",
    "job_auto_resume": "jobs",
    "job_auto_resume_failed": "jobs",
    "job_slice_granted": "jobs",
    "job_slice_reclaimed": "jobs",
    "auto_promote": "jobs",
    # mesh lifecycle (serve/mesh/, emitted via mesh_event)
    "mesh_worker_registered": "mesh",
    "mesh_worker_readmitted": "mesh",
    "mesh_worker_retiring": "mesh",
    "mesh_worker_removed": "mesh",
    "mesh_worker_ejected": "mesh",
    "mesh_worker_router_switch": "mesh",
    "mesh_worker_catch_up": "mesh",
    "mesh_failover_retry": "mesh",
    "mesh_reload_broadcast": "mesh",
    "mesh_bundle_replicated": "mesh",
    "mesh_standby_mirror": "standby",
    "mesh_standby_takeover": "standby",
    "mesh_standby_attached": "standby",
    "mesh_shed_engaged": "slo",
    "mesh_shed_cleared": "slo",
    "mesh_autoscale_spawn": "autoscale",
    "mesh_autoscale_retire": "autoscale",
    "mesh_autoscale_confirmed": "autoscale",
    "mesh_autoscale_unconfirmed": "autoscale",
    "mesh_autoscale_reaped": "autoscale",
}

from .trace import (  # noqa: F401
    current_ctx,
    disable,
    dump_ndjson,
    dump_to_dir,
    enable,
    enable_from_env,
    enabled,
    get_exporter,
    get_role,
    last_seq,
    new_span_id,
    new_trace_id,
    record,
    render_ndjson,
    ring_id,
    sample_stats,
    sample_trace,
    set_exporter,
    set_role,
    set_sample_rate,
    snapshot,
    span,
)

__all__ = [
    "current_ctx", "disable", "dump_ndjson", "dump_to_dir", "enable",
    "enable_from_env", "enabled", "get_exporter", "get_role",
    "last_seq", "new_span_id", "new_trace_id", "record",
    "render_ndjson", "ring_id", "sample_stats", "sample_trace",
    "set_exporter", "set_role", "set_sample_rate", "snapshot", "span",
    "EVENT_NAMES",
]
