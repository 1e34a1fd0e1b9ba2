"""Critical-path attribution + the black-box incident timeline (the
port of ``hpnn_tpu/obs/analyze.py``: the same reports, byte for byte).

The spool/ring give us span TREES; this module turns them into the two
answers an operator actually asks for:

* **which phase owns the latency?** -- :func:`critical_path` walks one
  trace's span tree backward from the latest-finishing span, always
  descending into the child that finished last, and charges each
  phase its SELF time along that path (the gap no child covers).
  :func:`critical_report` aggregates over many traces into per-phase
  p50/p99 self-time and the share of the p99 each phase owns
  ("queue_wait owns 61% of p99") -- the report ``GET
  /v1/debug/trace/critical`` serves.
* **what happened, in order?** -- :func:`build_timeline` merges spans,
  structured events (``mesh_*``/``slo_burn``/``ckpt_fallback``/
  autoscale -- recorded as zero-duration spans under the ``mesh``/
  ``events`` trace ids), and job state transitions (``job.state``
  spans) into one time-ordered view, so a takeover or shed incident
  reads as a single narrative (``GET /v1/debug/trace?timeline=1`` and
  ``obs.tool timeline``).

Cross-host stitching: a worker's half of a traced request arrives as a
SECOND root under the same trace id (the RPC carries the trace id, not
a span parent).  :func:`build_tree` re-parents such orphan roots under
the smallest enclosing span from another host -- the router's
``device_launch`` window that physically contained the RPC -- so the
critical path descends into the remote tree and the router's phase is
charged only for what the worker did NOT account for (queueing,
network, injected latency).  Timestamps across hosts share wall-clock
anchoring; containment uses a small slack (``_CLOCK_SLACK_S``) and
self-times clip at zero, so modest skew degrades attribution gracefully
instead of producing negative time.
"""

from __future__ import annotations

import math

# cross-host containment slack: wall anchors on two processes of one
# fleet disagree by clock-read jitter, not leap seconds
_CLOCK_SLACK_S = 0.005


def _start(s: dict) -> float:
    return s.get("ts", 0.0) or 0.0


def _end(s: dict) -> float:
    return _start(s) + (s.get("dur_s", 0.0) or 0.0)


def build_tree(spans: list[dict]) -> tuple[list[dict],
                                           dict[str, list[dict]]]:
    """(roots, children-by-span-id) for ONE trace's spans, deduplicated
    by span id.  Orphan roots (no parent, or a parent id the dump never
    caught) from a DIFFERENT host are re-parented under the smallest
    span that encloses them in time -- the cross-host stitch."""
    by_id: dict[str, dict] = {}
    for s in spans:
        sid = s.get("span")
        if sid:
            by_id.setdefault(sid, s)
    uniq = list(by_id.values())
    children: dict[str, list[dict]] = {}
    roots: list[dict] = []
    for s in uniq:
        parent = s.get("parent")
        if parent and parent in by_id:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)
    if len(roots) > 1:
        stitched = []
        for r in sorted(roots, key=_end):
            host = r.get("host")
            best = None
            for c in uniq:
                if c is r or c.get("host") == host:
                    continue
                if (_start(c) - _CLOCK_SLACK_S <= _start(r)
                        and _end(r) <= _end(c) + _CLOCK_SLACK_S):
                    if best is None or (_end(c) - _start(c)
                                        < _end(best) - _start(best)):
                        best = c
            if best is not None:
                children.setdefault(best["span"], []).append(r)
            else:
                stitched.append(r)
        roots = stitched
    _nest_contained_siblings(children)
    for kids in children.values():
        kids.sort(key=_start)
    roots.sort(key=_start)
    return roots, children


# sibling-containment epsilon: spans recorded from the same timestamp
# pair land within the dump's 1e-6 ts rounding of each other
_SIBLING_EPS_S = 5e-5


def _nest_contained_siblings(children: dict[str, list[dict]]) -> None:
    """Re-parent a span under the smallest STRICTLY-LONGER sibling
    whose interval contains it.  The batcher records a remote batch's
    ``mesh.route`` (the whole worker-RPC window) as a SIBLING of the
    ``device_launch``/``d2h`` segments it temporally contains; nesting
    them makes the critical path descend through the RPC window into
    the worker's stitched tree instead of charging ``mesh.route`` for
    time the worker accounted for.  Strictly-longer keeps the relation
    acyclic; local sequential phase spans (disjoint intervals) are
    untouched."""
    for parent in list(children):
        kids = children[parent]
        if len(kids) < 2:
            continue
        moved: dict[int, dict] = {}
        for i, c in enumerate(kids):
            c_dur = _end(c) - _start(c)
            best = None
            for s in kids:
                s_dur = _end(s) - _start(s)
                if s is c or s_dur <= c_dur:
                    continue
                if (_start(s) - _SIBLING_EPS_S <= _start(c)
                        and _end(c) <= _end(s) + _SIBLING_EPS_S):
                    if best is None or s_dur < (_end(best)
                                                - _start(best)):
                        best = s
            if best is not None:
                moved[i] = best
        if not moved:
            continue
        children[parent] = [c for i, c in enumerate(kids)
                            if i not in moved]
        for i, target in moved.items():
            children.setdefault(target["span"], []).append(kids[i])


def critical_path(spans: list[dict]) -> list[tuple[dict, float]]:
    """The trace's critical path as ``[(span, self_seconds), ...]``
    outermost first.  At each span the walk moves backward from the
    span's end: the child that finished last (and had started by the
    cursor) is on the path and is descended into; the stretches no
    such child covers are the span's SELF time -- the time that phase,
    and nothing underneath it, was the reason the trace wasn't done."""
    roots, children = build_tree(spans)
    if not roots:
        return []
    # the path starts at the root that finished last: that end IS the
    # trace's completion
    root = max(roots, key=_end)
    path: list[tuple[dict, float]] = []

    def walk(span: dict) -> None:
        kids = children.get(span.get("span") or "", [])
        cursor = _end(span)
        lo = _start(span)
        self_s = 0.0
        descend: list[dict] = []
        while True:
            cand = None
            for c in kids:
                if _start(c) >= cursor:
                    continue
                if cand is None or _end(c) > _end(cand):
                    cand = c
            if cand is None or _end(cand) <= lo:
                break
            gap = cursor - min(_end(cand), cursor)
            if gap > 0:
                self_s += gap
            descend.append(cand)
            cursor = _start(cand)
            if cursor <= lo:
                break
        if cursor > lo:
            self_s += cursor - lo
        path.append((span, max(self_s, 0.0)))
        for c in descend:
            walk(c)

    walk(root)
    return path


def phase_self_times(spans: list[dict]) -> dict[str, float]:
    """Per-phase (span name) self seconds along ONE trace's critical
    path; multiple same-name spans on the path fold together."""
    out: dict[str, float] = {}
    for span, self_s in critical_path(spans):
        name = span.get("name") or "?"
        out[name] = out.get(name, 0.0) + self_s
    return out


def _percentile(sorted_vals: list[float], p: float) -> float:
    """Nearest-rank percentile over pre-sorted values (deterministic,
    no interpolation -- byte-stable across live and offline runs)."""
    if not sorted_vals:
        return 0.0
    rank = max(1, math.ceil(p / 100.0 * len(sorted_vals)))
    return sorted_vals[rank - 1]


def critical_report(traces: list[list[dict]], kernel: str | None,
                    window_s: float | None,
                    min_spans: int = 2) -> dict:
    """Aggregate critical-path attribution over many traces -- the
    ``/v1/debug/trace/critical`` payload.  Traces with fewer than
    ``min_spans`` spans carry no phase structure and are skipped (a
    lone root tells us the total, not who owns it)."""
    per_phase: dict[str, list[float]] = {}
    totals: list[float] = []
    analyzed = 0
    for spans in traces:
        if len(spans) < min_spans:
            continue
        phases = phase_self_times(spans)
        if not phases:
            continue
        analyzed += 1
        totals.append(sum(phases.values()))
        for name, self_s in phases.items():
            per_phase.setdefault(name, []).append(self_s)
    totals.sort()
    report_phases: dict[str, dict] = {}
    for name in sorted(per_phase):
        per_phase[name].sort()
    p99s = {name: _percentile(vals, 99.0)
            for name, vals in per_phase.items()}
    p99_sum = sum(p99s.values())
    for name in sorted(per_phase):
        vals = per_phase[name]
        p99 = p99s[name]
        report_phases[name] = {
            "count": len(vals),
            "p50_self_ms": round(_percentile(vals, 50.0) * 1e3, 3),
            "p99_self_ms": round(p99 * 1e3, 3),
            # this phase's slice of the p99 critical path: the number
            # the MFU/serve benches rank optimization targets by
            "share_p99": round(p99 / p99_sum, 4) if p99_sum > 0
            else 0.0,
        }
    top = max(report_phases,
              key=lambda n: report_phases[n]["p99_self_ms"],
              default=None)
    out = {
        "kernel": kernel,
        "window_s": window_s,
        "traces_analyzed": analyzed,
        "critical_ms": {
            "p50": round(_percentile(totals, 50.0) * 1e3, 3),
            "p99": round(_percentile(totals, 99.0) * 1e3, 3),
        },
        "phases": report_phases,
        "top_phase": top,
    }
    return out


_DEFAULT_CRITICAL_TRACES = 256


def _critical_trace_budget(limit: int | None) -> int:
    if limit is not None:
        return int(limit)
    from ..utils.env import env_int

    return env_int("HPNN_TRACE_CRITICAL_TRACES",
                   _DEFAULT_CRITICAL_TRACES, lo=1)


def critical_from_dir(span_dir: str, kernel: str | None = None,
                      window_s: float | None = None,
                      limit: int | None = None) -> dict:
    """The ``/v1/debug/trace/critical`` payload computed from a span
    spool on disk -- the live endpoint (with ``--span-dir``) and
    ``obs.tool critical`` both call THIS, so a post-mortem reproduces
    the live answer byte-for-byte."""
    import time

    from . import index as trace_index

    params: dict = {"limit": _critical_trace_budget(limit)}
    if kernel:
        params["kernel"] = kernel
    if window_s is not None:
        # span ts are wall_base-anchored persisted stamps
        params["since"] = time.time() - window_s  # vs wall_base ts
    rows = trace_index.search(span_dir, params)["traces"]
    by_trace = trace_index.fetch_traces(span_dir,
                                        [r["trace"] for r in rows])
    traces = [by_trace[r["trace"]] for r in rows
              if r["trace"] in by_trace]
    return critical_report(traces, kernel or None, window_s)


def critical_from_spans(spans: list[dict],
                        kernel: str | None = None,
                        window_s: float | None = None,
                        limit: int | None = None) -> dict:
    """The same payload over in-memory spans (ring + fleet store) --
    what a server WITHOUT a span spool answers from."""
    import time

    from . import index as trace_index

    params: dict = {"limit": _critical_trace_budget(limit)}
    if kernel:
        params["kernel"] = kernel
    if window_s is not None:
        # span ts are wall_base-anchored persisted stamps
        params["since"] = time.time() - window_s  # vs wall_base ts
    rows = trace_index.search_spans(spans, params)["traces"]
    wanted = {r["trace"] for r in rows}
    by_trace: dict[str, list[dict]] = {}
    for s in spans:
        tid = s.get("trace")
        if tid in wanted:
            by_trace.setdefault(tid, []).append(s)
    return critical_report(list(by_trace.values()), kernel or None,
                           window_s)


# --- incident timeline ------------------------------------------------------

def _event_category(name: str) -> str | None:
    """Timeline category for a span name, via the event-name registry
    (``obs.EVENT_NAMES``): ``event.<n>``/``mesh.<n>`` spans map back to
    their declared structured-event names; ``job.state`` spans are the
    jobs lifecycle."""
    from . import EVENT_NAMES

    if name == "job.state":
        return "jobs"
    if name.startswith("event."):
        return EVENT_NAMES.get(name[len("event."):], "event")
    if name.startswith("mesh."):
        return EVENT_NAMES.get("mesh_" + name[len("mesh."):], "mesh")
    return None


_ENTRY_ATTR_SKIP = frozenset((
    "name", "trace", "span", "parent", "ts", "dur_s", "thread", "seq"))


def build_timeline(spans: list[dict], since: float | None = None,
                   until: float | None = None,
                   limit: int | None = None) -> list[dict]:
    """The incident timeline: every event span (mesh lifecycle,
    structured ``nn_event``s, job state transitions) plus every ROOT
    span (requests, job runs, training epochs) as one time-ordered
    list of entries.  Child phase spans are deliberately folded away --
    the timeline is the narrative, ``?trace=ID`` is the microscope."""
    entries: list[dict] = []
    seen: set = set()
    for s in spans:
        if not isinstance(s, dict):
            continue
        name = s.get("name") or "?"
        if name == "trace.truncated":
            continue  # merger bookkeeping, not an incident event
        category = _event_category(name)
        is_root = s.get("parent") is None
        if category is None and not is_root:
            continue
        ts = s.get("ts", 0.0) or 0.0
        if since is not None and ts < since:
            continue
        if until is not None and ts > until:
            continue
        key = s.get("span") or (name, ts)
        if key in seen:
            continue
        seen.add(key)
        entry = {
            "ts": round(ts, 6),
            "kind": category or "span",
            "name": name,
            "trace": s.get("trace"),
        }
        if s.get("dur_s"):
            entry["dur_ms"] = round(s["dur_s"] * 1e3, 3)
        if s.get("host") is not None:
            entry["host"] = s["host"]
        if s.get("role") is not None:
            entry["role"] = s["role"]
        detail = {k: v for k, v in s.items()
                  if k not in _ENTRY_ATTR_SKIP
                  and k not in ("host", "role")}
        if detail:
            entry["detail"] = {k: detail[k] for k in sorted(detail)}
        entries.append(entry)
    entries.sort(key=lambda e: (e["ts"], e["name"], e.get("trace")
                                or ""))
    if limit is not None and limit >= 0:
        entries = entries[-limit:] if limit > 0 else []
    return entries


def render_timeline(entries: list[dict]) -> str:
    """Timeline entries -> NDJSON (one entry per line, key-sorted) --
    what ``?timeline=1`` serves and ``obs.tool timeline`` prints, so
    the two are byte-comparable."""
    import json

    if not entries:
        return ""
    return "\n".join(json.dumps(e, sort_keys=True)
                     for e in entries) + "\n"
