"""Span tracing + the in-process flight recorder (the port of
``hpnn_tpu/obs/trace.py``; spans, ids, sampling and dumps are the JAX
package's, byte for byte).

A *span* is one timed region: ``{"name", "trace", "span", "parent",
"ts", "dur_s", "thread", ...attrs}``.  Spans belong to a *trace* (one
request, one training job, one CLI run); parentage makes the dump a
tree.  Completed spans land in a bounded ring buffer -- the flight
recorder -- oldest evicted first, so a long-lived server always holds
the most recent window of activity and a crash dump shows what the
process was doing right before the fault.

Design constraints (the serving p99 budget):

* **off = free.**  The global state is one module attribute; when it is
  ``None``, :func:`span` returns a shared no-op singleton and
  :func:`record` returns immediately -- no object allocation, no lock,
  no clock read.  The acceptance floor (serve_bench p99 regression
  < 5 % with tracing disabled) is held by this guard.
* **on = cheap.**  A span is one small object, two monotonic clock
  reads, and one deque append under a lock at completion.  Nothing is
  formatted until a dump is requested.
* **observe, never perturb.**  Recording never prints, never touches
  the device, and never raises into the traced code path (ring append
  failures are impossible by construction; attribute rendering happens
  at dump time inside the dump call).

Cross-thread correlation: the implicit parent is thread-local (nested
``with span(...)`` blocks form a stack), and code that hops threads --
the micro-batcher completing a request admitted by an HTTP thread --
passes ``trace_id``/``parent_id`` explicitly to :func:`record` with
measured start/end times.  Trace ids are caller-meaningful strings
(a request's ``X-HPNN-Trace-Id``, a job id); :func:`new_trace_id`
mints a random one when the caller has none.

Cross-HOST correlation: every recorded span carries a
monotone per-process ``seq`` number, so a remote collector (the mesh
router's fleet drain) can page the ring incrementally with
``since_seq=N`` instead of re-shipping the whole window every poll --
:func:`snapshot` filters on it and :func:`last_seq` is the cursor a
scraper stores.  ``seq`` restarts when the ring is re-enabled (or the
process restarts); collectors detect that by a ``last_seq`` smaller
than their cursor and rewind to 0.  :func:`set_role` names this
process's mesh role (router/worker/local): the SIGTERM/fault auto-dump
filename includes it (``trace-<reason>-<role>-<pid>.ndjson``) so a
killed fleet's post-mortems are attributable at a glance.

Head-based sampling: full capture cannot survive fleet QPS,
so the keep/drop decision is made ONCE at trace birth --
:func:`sample_trace` -- and everything under a dropped trace takes the
zero-allocation no-op path (the HTTP layer simply never mints a
trace context).  ``HPNN_TRACE_SAMPLE=p`` / ``serve_nn --trace-sample``
set the probability; an explicit ``X-HPNN-Trace-Id`` or a high-QoS
request FORCES capture (``force=True``), so a debugging client or the
traffic you page on always records; ``HPNN_TRACE_SAMPLE_SEED`` makes
the coin deterministic for tests.  Sampled/dropped/forced counters are
exported in /metrics.  With no sampler configured every trace is kept
-- byte-identical to the pre-sampling behavior.

Profiler ranges: while an ``obs.profiler`` capture runs, every
:func:`span` also opens a ``torch.profiler.record_function`` of its name,
so the span stands in the capture's Chrome trace as a host range on the
profiler's own clock, beside the kernels.  The capture switches this on
and off (:func:`set_profiler_ranges`); with no capture running a span
pays one read of a module global for it (and a None in its own slot).  :func:`record`'s spans, timed
by their caller, have no range.

Durable export: :func:`set_exporter` attaches an
:class:`~.export.SpanExporter`; every completed span is then ALSO
offered to its bounded background spool (rotating NDJSON segment files
under ``--span-dir``), so post-hoc analysis survives SIGKILL of this
process -- and :func:`dump_to_dir` reuses that spool (one writer, not
two) whenever an exporter is active.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import uuid
from collections import deque

_DEFAULT_CAPACITY = 8192

# the whole on/off switch: a _State when tracing, None when off
_state: "_State | None" = None
_tls = threading.local()
# this process's mesh role ("router"/"worker"/"local"); None outside a
# serving context -- names the auto-dump file, never the hot path
_role: str | None = None
# head-based sampling: None = keep every trace (the default); a
# _Sampler when HPNN_TRACE_SAMPLE / --trace-sample set one
_sampler: "_Sampler | None" = None
# durable span spool: None = ring only; an export.SpanExporter when a
# --span-dir is configured (set_exporter)
_exporter = None
# torch.profiler.record_function while an obs.profiler capture runs (each
# span then also opens a range of its name), None otherwise
_range = None


class _State:
    __slots__ = ("ring", "lock", "capacity", "wall_base", "mono_base",
                 "seq", "ring_id")

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self.ring: deque[dict] = deque(maxlen=self.capacity)
        self.lock = threading.Lock()
        self.seq = 0  # monotone span counter (the since_seq cursor)
        # ring identity: a fresh id per enable()/process, so a remote
        # collector can tell "this ring restarted" (cursor invalid)
        # apart from "entries were evicted" (cursor fine) -- seq alone
        # cannot distinguish a restart that already out-ran the cursor
        self.ring_id = uuid.uuid4().hex[:16]
        # one wall/monotonic anchor pair per enable(): span timestamps
        # are monotonic (elapsed math must survive clock steps) and the
        # dump renders them as wall time through this anchor
        self.wall_base = time.time()
        self.mono_base = time.monotonic()

    def wall(self, mono: float) -> float:
        return self.wall_base + (mono - self.mono_base)


def enabled() -> bool:
    return _state is not None


def enable(capacity: int | None = None) -> None:
    """Turn tracing on (idempotent; a repeat call with a different
    capacity re-rings, dropping recorded spans)."""
    global _state
    if capacity is None:
        from ..utils.env import env_int

        capacity = env_int("HPNN_TRACE_BUFFER", _DEFAULT_CAPACITY, lo=16)
    if _state is not None and _state.capacity == capacity:
        return
    _state = _State(capacity)


def disable() -> None:
    global _state
    _state = None


def enable_from_env() -> bool:
    """Enable when ``HPNN_TRACE`` is set truthy (the init_all / server
    startup hook); returns the resulting enabled state."""
    if os.environ.get("HPNN_TRACE", "") not in ("", "0"):
        enable()
    set_sample_rate_from_env()
    return enabled()


class _Sampler:
    """The head-sampling coin: one decision per trace at birth.  A
    dedicated ``random.Random`` (seedable via ``HPNN_TRACE_SAMPLE_SEED``
    for deterministic tests) so the decision stream is independent of
    every other RNG in the process; counters are the honest ledger of
    what the recorder did NOT see."""

    __slots__ = ("rate", "rng", "lock", "sampled_total",
                 "dropped_total", "forced_total")

    def __init__(self, rate: float, seed: int | None = None):
        self.rate = min(max(float(rate), 0.0), 1.0)
        self.rng = random.Random(seed)
        self.lock = threading.Lock()
        self.sampled_total = 0
        self.dropped_total = 0
        self.forced_total = 0

    def decide(self, force: bool = False) -> bool:
        with self.lock:
            if force:
                self.forced_total += 1
                self.sampled_total += 1
                return True
            if self.rng.random() < self.rate:
                self.sampled_total += 1
                return True
            self.dropped_total += 1
            return False


def set_sample_rate(rate: float | None,
                    seed: int | None = None) -> None:
    """Configure head sampling: traces are kept with probability
    ``rate`` (forced captures always win).  ``None`` (or a rate >= 1
    with no seed) removes the sampler -- every trace is kept and the
    counters disappear from /metrics."""
    global _sampler
    if rate is None:
        _sampler = None
        return
    if seed is None:
        env_seed = os.environ.get("HPNN_TRACE_SAMPLE_SEED", "")
        if env_seed:
            try:
                seed = int(env_seed)
            except ValueError:
                seed = None
    _sampler = _Sampler(rate, seed=seed)


def set_sample_rate_from_env() -> None:
    """Install a sampler when ``HPNN_TRACE_SAMPLE`` is set (idempotent
    no-op otherwise) -- the init_all / server-startup hook."""
    raw = os.environ.get("HPNN_TRACE_SAMPLE", "")
    if not raw:
        return
    try:
        set_sample_rate(float(raw))
    except ValueError:
        pass  # a malformed rate must not kill startup; keep-all default


def sample_trace(force: bool = False) -> bool:
    """The birth decision: should this trace be captured?  ``force``
    (an explicit ``X-HPNN-Trace-Id``, a high-QoS request) always keeps
    and is counted separately.  Without a sampler every trace is kept
    -- no lock, no counter, the pre-sampling fast path."""
    s = _sampler
    if s is None:
        return True
    return s.decide(force)


def sample_stats() -> dict | None:
    """Sampling counters for /metrics (None when no sampler is
    configured -- the series must not exist for a keep-all recorder)."""
    s = _sampler
    if s is None:
        return None
    with s.lock:
        return {"rate": s.rate, "sampled_total": s.sampled_total,
                "dropped_total": s.dropped_total,
                "forced_total": s.forced_total}


def set_exporter(exporter) -> None:
    """Attach (or, with None, detach) the durable span spool: every
    span recorded from here on is ALSO offered to
    ``exporter.offer(span)`` (an :class:`~.export.SpanExporter`)."""
    global _exporter
    _exporter = exporter


def get_exporter():
    return _exporter


def set_profiler_ranges(range_fn) -> None:
    """``range_fn`` (``torch.profiler.record_function``) while a profiler
    capture runs, None when it stops: each span entered meanwhile also
    opens ``range_fn(name)`` for its duration."""
    global _range
    _range = range_fn


def set_role(role: str | None) -> None:
    """Name this process's mesh role (router/worker/local) for the
    auto-dump filename; None restores the role-less legacy name."""
    global _role
    _role = role


def get_role() -> str | None:
    return _role


def last_seq() -> int:
    """The newest recorded span's ``seq`` (0 when tracing is off or
    nothing recorded) -- what ``X-HPNN-Trace-Seq`` reports so scrapers
    can page with ``since_seq`` and detect ring restarts."""
    st = _state
    return st.seq if st is not None else 0


def ring_id() -> str:
    """This ring's identity (fresh per enable()/process; "" when
    tracing is off) -- ``X-HPNN-Trace-Ring`` carries it so a collector
    invalidates its cursor on ANY restart, even one whose new seq
    already passed the old cursor."""
    st = _state
    return st.ring_id if st is not None else ""


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_ctx() -> tuple[str, str] | None:
    """The innermost active span's ``(trace_id, span_id)`` on this
    thread, or None -- what cross-thread code captures to parent its
    explicit :func:`record` calls."""
    st = getattr(_tls, "stack", None)
    if not st:
        return None
    top = st[-1]
    return (top.trace_id, top.span_id)


class _NoopSpan:
    """Shared do-nothing span: what :func:`span` hands out while
    tracing is off.  One module-level instance, so the disabled path
    allocates NOTHING."""

    __slots__ = ()
    trace_id = ""
    span_id = ""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **attrs):
        return self


_NOOP = _NoopSpan()


class Span:
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "_t0", "_st", "_range")

    def __init__(self, st: _State, name: str, trace_id: str | None,
                 parent_id: str | None, attrs: dict | None):
        self.name = name
        self.span_id = uuid.uuid4().hex[:16]
        self.attrs = attrs
        self._st = st
        self._t0 = 0.0
        self._range = None
        if trace_id is None:
            ctx = current_ctx()
            if ctx is not None:
                trace_id, parent_id = ctx[0], ctx[1]
            else:
                trace_id = new_trace_id()
        self.trace_id = trace_id
        self.parent_id = parent_id

    def annotate(self, **attrs) -> "Span":
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        range_fn = _range
        if range_fn is not None:
            self._range = range_fn(self.name)
            self._range.__enter__()
        self._t0 = time.monotonic()
        _stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.monotonic()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        if exc_type is not None:
            self.annotate(error=f"{exc_type.__name__}: {exc}")
        _append(self._st, self.name, self.trace_id, self.span_id,
                self.parent_id, self._t0, t1, self.attrs)
        return False


def span(name: str, trace_id: str | None = None,
         parent_id: str | None = None, **attrs):
    """Context manager timing one region.  With tracing off this is the
    shared no-op singleton; on, the span nests under this thread's
    innermost active span unless ``trace_id``/``parent_id`` pin it
    explicitly."""
    st = _state
    if st is None:
        return _NOOP
    return Span(st, name, trace_id, parent_id, attrs or None)


def _append(st: _State, name: str, trace_id: str, span_id: str,
            parent_id: str | None, t0: float, t1: float,
            attrs: dict | None) -> None:
    rec = {
        "name": name,
        "trace": trace_id,
        "span": span_id,
        "parent": parent_id,
        "ts": round(st.wall(t0), 6),
        "dur_s": round(t1 - t0, 9),
        "thread": threading.current_thread().name,
    }
    if attrs:
        rec.update(attrs)
    with st.lock:
        st.seq += 1
        rec["seq"] = st.seq
        st.ring.append(rec)
    exp = _exporter
    if exp is not None:
        # the spool's bounded queue never blocks the traced path: a
        # full queue drops (counted), the ring is unaffected
        exp.offer(rec)


def record(name: str, t0: float, t1: float,
           trace_id: str | None = None, parent_id: str | None = None,
           span_id: str | None = None, **attrs) -> str:
    """Record a completed span from measured ``time.monotonic()``
    endpoints -- the cross-thread form (the batcher timing a batch
    segment for each member request).  ``span_id`` lets a caller
    pre-mint the id (the HTTP handler hands its root span's id to the
    batcher BEFORE the root completes).  Returns the span id ("" when
    tracing is off)."""
    st = _state
    if st is None:
        return ""
    if trace_id is None:
        ctx = current_ctx()
        if ctx is not None:
            trace_id, parent_id = ctx[0], ctx[1]
        else:
            trace_id = new_trace_id()
    if span_id is None:
        span_id = uuid.uuid4().hex[:16]
    _append(st, name, trace_id, span_id, parent_id, t0, t1,
            attrs or None)
    return span_id


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def snapshot(trace_id: str | None = None,
             limit: int | None = None,
             since_seq: int | None = None) -> list[dict]:
    """Recorded spans, oldest first; ``trace_id`` filters to one trace,
    ``since_seq`` keeps spans recorded after that cursor (incremental
    paging), ``limit`` keeps the newest N."""
    st = _state
    if st is None:
        return []
    with st.lock:
        spans = list(st.ring)
    if since_seq is not None and since_seq > 0:
        spans = [s for s in spans if s.get("seq", 0) > since_seq]
    if trace_id is not None:
        spans = [s for s in spans if s["trace"] == trace_id]
    if limit is not None:
        # limit <= 0 means "at most nothing" -- spans[-0:] would be the
        # WHOLE list, not an empty one
        spans = spans[-limit:] if limit > 0 else []
    return spans


def dump_ndjson(trace_id: str | None = None,
                limit: int | None = None,
                since_seq: int | None = None) -> str:
    """The flight-recorder dump: one JSON object per line (NDJSON),
    oldest span first -- what ``GET /v1/debug/trace`` serves."""
    return render_ndjson(snapshot(trace_id=trace_id, limit=limit,
                                  since_seq=since_seq))


def render_ndjson(spans: list[dict]) -> str:
    """Span dicts -> NDJSON text (the same line format dump_ndjson
    emits) -- what fleet-merged dumps render through."""
    if not spans:
        return ""
    return "\n".join(json.dumps(s, sort_keys=True) for s in spans) + "\n"


def dump_to_dir(dirpath: str, reason: str = "dump",
                extra_spans: list[dict] | None = None) -> str | None:
    """Write the recorder to ``<dirpath>/trace-<reason>[-<role>]-<pid>
    .ndjson`` (the SIGTERM/fault auto-dump; the role lands in the name
    once :func:`set_role` ran, so a killed fleet's dumps don't all look
    alike).  ``extra_spans`` ride along time-sorted into the same file
    -- a mesh router passes its last collected worker spans so remote
    halves of in-flight traces survive the process.  Best-effort:
    returns the path, or None when tracing is off / nothing is recorded
    / the write fails -- a dying process must not die harder because
    its post-mortem failed.

    With a durable exporter attached (``--span-dir``), the dump REUSES
    the spool instead of writing a second ad-hoc file: the ring's spans
    are already streaming there, so the post-mortem is one flush +
    rotate -- extra spans ride into the same segment, and the returned
    path is the rotated segment."""
    exp = _exporter
    if exp is not None:
        try:
            if extra_spans:
                for s in extra_spans:
                    exp.offer(s)
            return exp.flush(reason=reason)
        except Exception:
            return None
    spans = snapshot()
    if extra_spans:
        spans = sorted(spans + list(extra_spans),
                       key=lambda s: s.get("ts", 0.0))
    text = render_ndjson(spans)
    if not text:
        return None
    role = f"-{_role}" if _role else ""
    path = os.path.join(dirpath,
                        f"trace-{reason}{role}-{os.getpid()}.ndjson")
    try:
        os.makedirs(dirpath, exist_ok=True)
        with open(path, "w") as fp:
            fp.write(text)
    except OSError:
        return None
    return path
