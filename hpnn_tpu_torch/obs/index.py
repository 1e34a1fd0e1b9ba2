"""Cross-host trace index over the durable span spool (the port of
``hpnn_tpu/obs/index.py``: the same sidecars, byte for byte).

The exporter made spans durable -- rotating NDJSON segments under
``--span-dir`` -- but the spool was write-only in practice: answering
"which traces were slow for kernel X?" meant re-parsing every segment
body.  This module gives each FINALIZED segment a sidecar index::

    spans-<unix>-<pid>-<seq>.ndjson          the segment (unchanged)
    spans-<unix>-<pid>-<seq>.ndjson.idx.json the sidecar

The sidecar maps ``trace id -> byte offsets`` of that trace's lines
inside the segment plus a per-trace summary (kernel, root span name,
status, start timestamp, wall extent, span count), so

* :func:`search` answers kernel/trace/min_ms/status/since/until
  queries from the sidecars alone -- segment BODIES are read only for
  traces the caller actually fetches;
* :func:`fetch_trace` seeks straight to a trace's lines instead of
  scanning the directory.

Index lifecycle:

* **built at rotation** -- the exporter calls :func:`build_index` on
  the writer thread right after a segment is finalized (indexing rides
  rotation, never the request path; ``HPNN_TRACE_INDEX=0`` disables);
* **lazily back-filled** -- :func:`ensure_index` builds the sidecar
  for a pre-existing / foreign segment the first time a query touches
  it, and REBUILDS it when it is stale (segment size mismatch -- a
  finalized segment never changes, so staleness means a torn or
  half-copied sidecar) or unreadable.  A failed sidecar write degrades
  to the in-memory scan result -- queries never fail because the
  directory is read-only;
* **open spools are always scanned** -- the in-progress ``.spool-*``
  files have no sidecar by construction (they are still growing).

Every summary field is derived deterministically from the span lines,
so the live endpoints and the offline tool (:mod:`.tool`) produce
byte-identical answers over the same directory.
"""

from __future__ import annotations

import json
import os

from ..utils.env import env_int

INDEX_SUFFIX = ".idx.json"
INDEX_VERSION = 1

_DEFAULT_SEARCH_LIMIT = 100


def index_enabled() -> bool:
    """``HPNN_TRACE_INDEX`` gate (default on): 0 disables rotation-time
    builds AND lazy back-fill -- every query scans segment bodies."""
    return os.environ.get("HPNN_TRACE_INDEX", "") != "0"


def search_limit_default() -> int:
    return env_int("HPNN_TRACE_SEARCH_LIMIT", _DEFAULT_SEARCH_LIMIT,
                   lo=1)


def index_path(segment_path: str) -> str:
    return segment_path + INDEX_SUFFIX


# --- per-segment summaries --------------------------------------------------

def _new_summary() -> dict:
    return {"offsets": [], "spans": 0, "kernel": None, "root": None,
            "status": None, "start_ts": None, "end_ts": None}


def _fold_span(summary: dict, span: dict, offset: int | None) -> None:
    """Fold one span line into its trace's summary (offset is None for
    in-memory spans, e.g. the flight-recorder ring)."""
    if offset is not None:
        summary["offsets"].append(offset)
    summary["spans"] += 1
    ts = span.get("ts")
    if isinstance(ts, (int, float)):
        if summary["start_ts"] is None or ts < summary["start_ts"]:
            summary["start_ts"] = ts
        end = ts + (span.get("dur_s") or 0.0)
        if summary["end_ts"] is None or end > summary["end_ts"]:
            summary["end_ts"] = end
    name = span.get("name") or ""
    if (summary["kernel"] is None and span.get("kernel")
            and not name.startswith(("event.", "mesh."))):
        # request/job/epoch spans name their kernel; a structured
        # EVENT mentioning one (slo_burn kernel=..., slow_request)
        # must not drag the whole events/mesh trace into that
        # kernel's search and critical-path results
        summary["kernel"] = str(span["kernel"])
    if span.get("parent") is None:
        # roots carry the trace's identity: the EARLIEST root (the
        # request/job/epoch that opened the trace) names it, the
        # NEWEST root with an outcome is its status -- a retried
        # request's final verdict wins
        rts = ts if isinstance(ts, (int, float)) else 0.0
        if summary["root"] is None or rts < summary["_root_ts"]:
            summary["root"] = span.get("name")
            summary["_root_ts"] = rts
        if span.get("outcome") is not None \
                and rts >= summary.get("_status_ts", -1.0):
            summary["status"] = str(span["outcome"])
            summary["_status_ts"] = rts


def _finish_summary(tid: str, summary: dict) -> dict:
    start = summary["start_ts"] or 0.0
    end = summary["end_ts"] or start
    out = {
        "trace": tid,
        "kernel": summary["kernel"],
        "root": summary["root"],
        "status": summary["status"],
        "start_ts": round(start, 6),
        "dur_ms": round((end - start) * 1e3, 3),
        "spans": summary["spans"],
    }
    if summary["offsets"]:
        out["offsets"] = summary["offsets"]
    return out


def summarize_spans(spans: list[dict]) -> list[dict]:
    """Per-trace summary rows for IN-MEMORY spans (the ring / fleet
    store path, and the open-spool scan) -- the same derivation the
    sidecar stores, minus byte offsets."""
    acc: dict[str, dict] = {}
    for s in spans:
        if not isinstance(s, dict):
            continue
        if s.get("name") == "trace.truncated":
            continue  # fleet-merger bookkeeping, not trace content
        tid = s.get("trace")
        if not tid:
            continue
        summary = acc.get(tid)
        if summary is None:
            summary = acc[tid] = _new_summary()
        _fold_span(summary, s, None)
    return [_finish_summary(tid, summ) for tid, summ in acc.items()]


def _scan_segment(path: str) -> dict[str, dict]:
    """Parse one NDJSON file tracking byte offsets; returns trace id ->
    raw summary.  Torn tails (a killed writer's half line) are skipped,
    like :func:`..export.read_spool`."""
    acc: dict[str, dict] = {}
    with open(path, "rb") as fp:
        offset = 0
        for raw in fp:
            line_off = offset
            offset += len(raw)
            line = raw.strip()
            if not line:
                continue
            try:
                s = json.loads(line.decode("utf-8"))
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue  # torn tail
            if not isinstance(s, dict):
                continue
            tid = s.get("trace")
            if not tid:
                continue
            summary = acc.get(tid)
            if summary is None:
                summary = acc[tid] = _new_summary()
            _fold_span(summary, s, line_off)
    return acc


def build_index(segment_path: str) -> dict | None:
    """Scan one finalized segment and write its sidecar (atomic
    tmp+fsync+rename).  Returns the index dict, or None when the
    segment is unreadable.  A failed sidecar WRITE still returns the
    in-memory index -- the caller's query proceeds, only the cache is
    lost (read-only span dirs stay queryable)."""
    try:
        st = os.stat(segment_path)
        acc = _scan_segment(segment_path)
    except OSError:
        return None
    idx = {
        "version": INDEX_VERSION,
        "segment": os.path.basename(segment_path),
        "size": st.st_size,
        "traces": {tid: _finish_summary(tid, summ)
                   for tid, summ in acc.items()},
    }
    for t in idx["traces"].values():
        t.pop("trace", None)  # keyed by trace id; no duplicate field
    try:
        from ..io.atomic import atomic_write_text

        atomic_write_text(index_path(segment_path),
                          json.dumps(idx, sort_keys=True) + "\n")
    except OSError:
        pass
    return idx


def load_index(segment_path: str) -> dict | None:
    """The sidecar, or None when missing / unreadable / wrong version /
    STALE (size mismatch vs the segment -- finalized segments never
    change, so a mismatch means the sidecar is the broken half)."""
    try:
        with open(index_path(segment_path), encoding="utf-8") as fp:
            idx = json.load(fp)
        seg_size = os.stat(segment_path).st_size
    except (OSError, json.JSONDecodeError):
        return None
    if (not isinstance(idx, dict)
            or idx.get("version") != INDEX_VERSION
            or idx.get("size") != seg_size
            or not isinstance(idx.get("traces"), dict)):
        return None
    return idx


def ensure_index(segment_path: str) -> dict | None:
    """Load-or-build: the lazy back-fill path queries go through.  A
    missing or stale sidecar falls back to a scan whose result REPAIRS
    the sidecar for the next query.  With ``HPNN_TRACE_INDEX=0`` the
    scan result is returned without writing anything."""
    idx = load_index(segment_path)
    if idx is not None:
        return idx
    if not index_enabled():
        try:
            acc = _scan_segment(segment_path)
        except OSError:
            return None
        return {"version": INDEX_VERSION,
                "segment": os.path.basename(segment_path),
                "traces": {tid: _finish_summary(tid, summ)
                           for tid, summ in acc.items()}}
    return build_index(segment_path)


# --- directory-level queries ------------------------------------------------

def _merge_row(into: dict, row: dict) -> None:
    """Fold one segment's summary of a trace into the cross-segment
    row (a trace routinely spans segments: its spans arrive over
    several rotations)."""
    into["spans"] += row.get("spans", 0)
    rs = row.get("start_ts")
    if rs is not None and (into["start_ts"] is None
                           or rs < into["start_ts"]):
        into["start_ts"] = rs
        if row.get("root") is not None:
            into["root"] = row["root"]
    elif into["root"] is None and row.get("root") is not None:
        into["root"] = row["root"]
    r_end = (row.get("start_ts") or 0.0) + (row.get("dur_ms")
                                            or 0.0) / 1e3
    if r_end > into["_end"]:
        into["_end"] = r_end
        if row.get("status") is not None:
            into["status"] = row["status"]
    elif into["status"] is None and row.get("status") is not None:
        into["status"] = row["status"]
    if into["kernel"] is None and row.get("kernel") is not None:
        into["kernel"] = row["kernel"]


def _dir_rows(span_dir: str) -> dict[str, dict]:
    """Every trace in the spool as a merged cross-segment row keyed by
    trace id: finalized segments through their sidecars (built/
    repaired as needed), open spools by scan."""
    from .export import list_segments

    rows: dict[str, dict] = {}

    def fold(tid: str, row: dict, segment: str | None) -> None:
        into = rows.get(tid)
        if into is None:
            into = rows[tid] = {
                "trace": tid, "kernel": None, "root": None,
                "status": None, "start_ts": None, "spans": 0,
                "_end": 0.0, "_segments": []}
        if into["start_ts"] is None:
            into["start_ts"] = row.get("start_ts")
        _merge_row(into, row)
        if segment is not None:
            into["_segments"].append(
                (segment, row.get("offsets") or None))

    finalized = list_segments(span_dir)
    for seg in finalized:
        idx = ensure_index(seg)
        if idx is None:
            continue
        for tid, row in idx["traces"].items():
            fold(tid, row, seg)
    for path in list_segments(span_dir, include_open=True):
        if path in finalized:
            continue
        try:
            acc = _scan_segment(path)
        except OSError:
            continue
        for tid, summ in acc.items():
            fold(tid, _finish_summary(tid, summ), path)
    return rows


def normalize_query(params: dict) -> dict:
    """Validated + normalized search parameters (shared by the live
    endpoint and the offline tool, so both echo the SAME query object
    and produce byte-identical payloads).  Raises ValueError on a
    malformed number."""
    q: dict = {}
    if params.get("kernel"):
        q["kernel"] = str(params["kernel"])
    if params.get("trace"):
        q["trace"] = str(params["trace"])
    if params.get("status"):
        q["status"] = str(params["status"])
    for key in ("min_ms", "since", "until"):
        if params.get(key) not in (None, ""):
            q[key] = float(params[key])
    if params.get("limit") not in (None, ""):
        q["limit"] = int(params["limit"])
    else:
        q["limit"] = search_limit_default()
    return q


def filter_rows(rows: list[dict], q: dict) -> list[dict]:
    """Apply a normalized query to summary rows: filters, then
    newest-first ordering, then the limit.  Deterministic tie-break on
    trace id so repeated queries over the same spool are byte-stable."""
    out = []
    for r in rows:
        if q.get("kernel") is not None and r.get("kernel") != q["kernel"]:
            continue
        if q.get("trace") is not None and r.get("trace") != q["trace"]:
            continue
        if q.get("status") is not None and r.get("status") != q["status"]:
            continue
        if q.get("min_ms") is not None \
                and (r.get("dur_ms") or 0.0) < q["min_ms"]:
            continue
        start = r.get("start_ts") or 0.0
        if q.get("since") is not None and start < q["since"]:
            continue
        if q.get("until") is not None and start > q["until"]:
            continue
        out.append(r)
    out.sort(key=lambda r: (-(r.get("start_ts") or 0.0),
                            r.get("trace") or ""))
    limit = q.get("limit")
    if limit is not None and limit >= 0:
        out = out[:limit]
    return out


def _public_row(row: dict) -> dict:
    # one canonical key order for every search source, so live and
    # offline payloads over the same spool are byte-identical
    return {"trace": row.get("trace"), "kernel": row.get("kernel"),
            "root": row.get("root"), "status": row.get("status"),
            "start_ts": row.get("start_ts"),
            "dur_ms": row.get("dur_ms"), "spans": row.get("spans")}


def search(span_dir: str, params: dict) -> dict:
    """The query payload ``GET /v1/debug/trace/search`` serves when a
    span spool is configured -- and EXACTLY what ``obs.tool search``
    prints offline.  ``params`` are raw string-ish values (query
    string / argv); see :func:`normalize_query` for the keys."""
    q = normalize_query(params)
    rows = []
    for r in _dir_rows(span_dir).values():
        start = r.get("start_ts") or 0.0
        r["dur_ms"] = round(max(r["_end"] - start, 0.0) * 1e3, 3)
        rows.append(r)
    rows = [_public_row(r) for r in filter_rows(rows, q)]
    return {"query": q, "count": len(rows), "traces": rows}


def search_spans(spans: list[dict], params: dict) -> dict:
    """The same search payload over IN-MEMORY spans (the ring / fleet
    store) -- what a server without a span spool answers from."""
    q = normalize_query(params)
    rows = [_public_row(r)
            for r in filter_rows(summarize_spans(spans), q)]
    return {"query": q, "count": len(rows), "traces": rows}


def fetch_trace(span_dir: str, trace_id: str) -> list[dict]:
    """Every spooled span of one trace, seeked through the sidecar
    offsets (segments without offsets -- or open spools -- are
    scanned), time-ordered like the merged dump."""
    return fetch_traces(span_dir, [trace_id]).get(trace_id, [])


def fetch_traces(span_dir: str,
                 trace_ids: list[str]) -> dict[str, list[dict]]:
    """Batch form of :func:`fetch_trace`: ONE directory pass (sidecars
    parsed / open spools scanned once) serves every requested trace --
    what the critical-path report fans out through."""
    rows = _dir_rows(span_dir)
    out: dict[str, list[dict]] = {}
    for trace_id in trace_ids:
        row = rows.get(trace_id)
        if row is None:
            continue
        spans: list[dict] = []
        for seg, offsets in row["_segments"]:
            try:
                if offsets:
                    with open(seg, "rb") as fp:
                        for off in offsets:
                            fp.seek(off)
                            line = fp.readline()
                            try:
                                s = json.loads(line.decode("utf-8"))
                            except (json.JSONDecodeError,
                                    UnicodeDecodeError):
                                continue
                            if isinstance(s, dict) \
                                    and s.get("trace") == trace_id:
                                spans.append(s)
                else:
                    for s in _iter_spans(seg):
                        if s.get("trace") == trace_id:
                            spans.append(s)
            except OSError:
                continue
        spans.sort(key=lambda s: (s.get("ts", 0.0), s.get("seq", 0)))
        out[trace_id] = spans
    return out


def _iter_spans(path: str):
    with open(path, "rb") as fp:
        for raw in fp:
            line = raw.strip()
            if not line:
                continue
            try:
                s = json.loads(line.decode("utf-8"))
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue
            if isinstance(s, dict):
                yield s
