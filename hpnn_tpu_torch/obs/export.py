"""Durable span export: a bounded background spool shipping completed
spans off the flight-recorder ring into rotating NDJSON segment files
(the port of ``hpnn_tpu/obs/export.py``: the same segments, byte for
byte).

The ring answers "what was this process doing right before now?",
but it dies with the process and evicts under load.  The exporter makes
the answer DURABLE without touching the traced hot path:

* **bounded offer** -- :meth:`SpanExporter.offer` appends to a bounded
  in-memory queue and returns; a full queue drops the span (counted in
  ``dropped_total`` -- an honest ledger, never backpressure into the
  serving path).  ``obs.trace._append`` offers every recorded span, so
  whatever head sampling kept is what the spool holds.
* **incremental segment writes** -- a daemon writer drains the queue
  into the current OPEN segment (``.spool-<pid>.open`` inside
  ``span_dir``), one JSON object per line, flushed per batch: after a
  SIGKILL the flushed lines are already with the OS, so the segment
  survives the process (fsync happens at rotation, so a power cut may
  cost the open segment's tail -- the same honesty gradient as the
  checkpoint writers).
* **rotation** -- when the open segment passes the size cap
  (``HPNN_SPAN_SEGMENT_KB``) or age cap (``HPNN_SPAN_SEGMENT_AGE_S``)
  it is fsync'd and atomically renamed to
  ``spans-<unix>-<pid>-<seq>.ndjson`` (the :mod:`..io.atomic`
  tmp+fsync+rename sequence -- the open file IS the temp file), and the
  parent directory is fsync'd, so finalized segments are durable
  through power loss.
* **retention** -- after every rotation, finalized segments beyond
  ``HPNN_SPAN_DIR_MAX_MB`` total (or older than ``HPNN_SPAN_KEEP_S``,
  when set) are deleted oldest-first; the sweep counts what it removed
  (``segments_pruned_total``) -- bounded disk, never a silent grow.

:func:`read_spool` is the read side: every finalized segment plus the
open spools, oldest first -- what ``GET /v1/debug/trace?spool=1``
serves and what a post-mortem reads after the process is gone.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from ..io.atomic import fsync_dir
from ..utils.env import env_float, env_int

_DEFAULT_SEGMENT_KB = 512
_DEFAULT_SEGMENT_AGE_S = 30.0
_DEFAULT_DIR_MAX_MB = 64
_DEFAULT_QUEUE_SPANS = 8192

SEGMENT_PREFIX = "spans-"
OPEN_PREFIX = ".spool-"


class SpanExporter:
    """See the module doc.  One instance per process (attached via
    ``obs.trace.set_exporter``); every method is thread-safe."""

    def __init__(self, span_dir: str,
                 segment_bytes: int | None = None,
                 segment_age_s: float | None = None,
                 max_dir_bytes: int | None = None,
                 keep_s: float | None = None,
                 queue_spans: int | None = None):
        self.span_dir = os.path.abspath(span_dir)
        os.makedirs(self.span_dir, exist_ok=True)
        self.segment_bytes = (
            segment_bytes if segment_bytes is not None
            else env_int("HPNN_SPAN_SEGMENT_KB", _DEFAULT_SEGMENT_KB,
                         lo=1) * 1024)
        self.segment_age_s = (
            segment_age_s if segment_age_s is not None
            else env_float("HPNN_SPAN_SEGMENT_AGE_S",
                           _DEFAULT_SEGMENT_AGE_S, lo=0.05))
        self.max_dir_bytes = (
            max_dir_bytes if max_dir_bytes is not None
            else env_int("HPNN_SPAN_DIR_MAX_MB", _DEFAULT_DIR_MAX_MB,
                         lo=1) * (1 << 20))
        self.keep_s = (keep_s if keep_s is not None
                       else env_float("HPNN_SPAN_KEEP_S", 0.0, lo=0.0))
        cap = (queue_spans if queue_spans is not None
               else env_int("HPNN_SPAN_QUEUE", _DEFAULT_QUEUE_SPANS,
                            lo=64))
        self._q: deque = deque()
        self._q_cap = int(cap)
        self._cv = threading.Condition()
        # serializes segment file IO (writer thread vs flush vs close)
        self._io = threading.Lock()
        self._open_path = os.path.join(
            self.span_dir, f"{OPEN_PREFIX}{os.getpid()}.open")
        self._fp = None
        self._open_bytes = 0
        self._open_since = time.monotonic()
        self._seq = 0
        self.exported_total = 0
        self.dropped_total = 0
        self.rotations_total = 0
        self.segments_pruned_total = 0
        # trace-index sidecars: built right after a segment
        # finalizes, ON the writer thread -- indexing rides rotation,
        # never the request path (HPNN_TRACE_INDEX=0 opts out; queries
        # then fall back to scans)
        from .index import index_enabled

        self.index_segments = index_enabled()
        self.index_builds_total = 0
        self.index_build_s_total = 0.0
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name="hpnn-span-exporter", daemon=True)
        self._thread.start()

    # --- producer side ---------------------------------------------------
    def offer(self, span: dict) -> bool:
        """Enqueue one completed span (non-blocking); False + counted
        when the bounded queue is full."""
        with self._cv:
            if self._closed or len(self._q) >= self._q_cap:
                self.dropped_total += 1
                return False
            self._q.append(span)
            self._cv.notify()
        return True

    # --- writer ----------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cv:
                if not self._q and not self._closed:
                    # bounded wait: the age-based rotation must fire
                    # even when nothing new arrives
                    self._cv.wait(timeout=min(0.5, self.segment_age_s))
                batch = list(self._q)
                self._q.clear()
                closed = self._closed
            with self._io:
                if batch:
                    self._write_locked(batch)
                self._maybe_rotate_locked()
            if closed:
                return

    def _ensure_open_locked(self):
        if self._fp is None:
            self._fp = open(self._open_path, "a", encoding="utf-8")
            self._open_bytes = self._fp.tell()
            self._open_since = time.monotonic()
        return self._fp

    def _write_locked(self, batch: list[dict]) -> None:
        for s in batch:
            try:
                line = json.dumps(s, sort_keys=True) + "\n"
            except (TypeError, ValueError):
                self.dropped_total += 1  # unserializable attr: drop it
                continue
            fp = self._ensure_open_locked()
            fp.write(line)
            self._open_bytes += len(line.encode("utf-8"))
            self.exported_total += 1
            if self._open_bytes >= self.segment_bytes:
                # rotate INSIDE a large drain, or one busy batch would
                # blow arbitrarily far past the segment cap
                self._maybe_rotate_locked()
        if self._fp is not None:
            # flush per batch: the bytes are with the OS, so a
            # SIGKILL'd process's spool is readable (fsync waits for
            # rotation)
            self._fp.flush()

    def _maybe_rotate_locked(self, force: bool = False) -> str | None:
        if self._fp is None or self._open_bytes == 0:
            return None
        age = time.monotonic() - self._open_since
        if not (force or self._open_bytes >= self.segment_bytes
                or age >= self.segment_age_s):
            return None
        fp = self._fp
        fp.flush()
        os.fsync(fp.fileno())
        fp.close()
        self._fp = None
        self._seq += 1
        # int(time.time()): the persisted segment timestamp in the name
        final = os.path.join(
            self.span_dir,
            f"{SEGMENT_PREFIX}{int(time.time())}-{os.getpid()}"
            f"-{self._seq:06d}.ndjson")
        try:
            os.replace(self._open_path, final)
        except OSError:
            return None
        fsync_dir(self.span_dir)
        self._open_bytes = 0
        self.rotations_total += 1
        self._retain_locked()
        if self.index_segments:
            # sidecar build rides the rotation (writer thread): search
            # never pays a back-fill for segments this process wrote
            t0 = time.monotonic()
            try:
                from .index import build_index

                build_index(final)
                self.index_builds_total += 1
                self.index_build_s_total += time.monotonic() - t0
            except Exception:
                pass  # queries fall back to the lazy scan-and-repair
        return final

    def _retain_locked(self) -> None:
        """Oldest-first prune of FINALIZED segments past the size/age
        caps (the open spools are never touched)."""
        try:
            names = sorted(n for n in os.listdir(self.span_dir)
                           if n.startswith(SEGMENT_PREFIX)
                           and n.endswith(".ndjson"))
        except OSError:
            return
        entries = []
        for n in names:
            p = os.path.join(self.span_dir, n)
            try:
                st = os.stat(p)
            except OSError:
                continue
            entries.append((st.st_mtime, p, st.st_size))
        entries.sort()
        total = sum(sz for _, _, sz in entries)
        now = time.time()  # vs persisted segment mtimes ("updated")
        for mtime, path, sz in entries[:-1]:  # keep the newest always
            too_big = total > self.max_dir_bytes
            too_old = self.keep_s > 0 and now - mtime > self.keep_s
            if not (too_big or too_old):
                continue
            try:
                os.unlink(path)
            except OSError:
                continue
            try:  # the sidecar index dies with its segment
                from .index import index_path

                os.unlink(index_path(path))
            except OSError:
                pass
            total -= sz
            self.segments_pruned_total += 1

    # --- control ---------------------------------------------------------
    def drain(self) -> None:
        """Make every offered span readable NOW (write + flush the
        open segment) WITHOUT forcing a rotation -- the ``?spool=1``
        read path.  ``read_spool`` already includes open spools, so a
        polling dashboard must not turn every query into an fsync +
        rename + retention sweep."""
        with self._cv:
            batch = list(self._q)
            self._q.clear()
        with self._io:
            if batch:
                self._write_locked(batch)

    def flush(self, reason: str = "flush") -> str | None:
        """Drain the queue and force-rotate the open segment; returns
        the finalized segment's path (None when nothing was spooled).
        This is the SIGTERM/fault auto-dump: the spool already holds
        the ring's history, so a post-mortem is one rotation."""
        with self._cv:
            batch = list(self._q)
            self._q.clear()
        with self._io:
            if batch:
                self._write_locked(batch)
            path = self._maybe_rotate_locked(force=True)
        if path is None:
            # nothing pending: the newest finalized segment IS the
            # post-mortem (everything was already rotated out)
            segs = list_segments(self.span_dir)
            path = segs[-1] if segs else None
        return path

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=5.0)
        with self._io:
            self._maybe_rotate_locked(force=True)
            if self._fp is not None:  # pragma: no cover - empty spool
                self._fp.close()
                self._fp = None

    def stats(self) -> dict:
        with self._io:
            open_bytes = self._open_bytes
        segs = list_segments(self.span_dir)
        oldest_age = 0.0
        if segs:
            try:
                mtime = os.stat(segs[0]).st_mtime
                oldest_age = max(0.0, time.time() - mtime)  # "updated"
            except OSError:
                pass
        return {"span_dir": self.span_dir,
                "exported_total": self.exported_total,
                "dropped_total": self.dropped_total,
                "rotations_total": self.rotations_total,
                "segments_pruned_total": self.segments_pruned_total,
                "segments": len(segs),
                "open_bytes": open_bytes,
                "oldest_segment_age_s": round(oldest_age, 3),
                "index_builds_total": self.index_builds_total,
                "index_build_s_total": round(self.index_build_s_total,
                                             6),
                "queue_depth": len(self._q)}


# --- read side -------------------------------------------------------------

def list_segments(span_dir: str, include_open: bool = False) -> list[str]:
    """Finalized segment paths oldest first (by name: the unix stamp +
    seq sort lexically); ``include_open`` appends in-progress spools."""
    try:
        names = os.listdir(span_dir)
    except OSError:
        return []
    segs = sorted(os.path.join(span_dir, n) for n in names
                  if n.startswith(SEGMENT_PREFIX)
                  and n.endswith(".ndjson"))
    if include_open:
        segs += sorted(os.path.join(span_dir, n) for n in names
                       if n.startswith(OPEN_PREFIX)
                       and n.endswith(".open"))
    return segs


def read_spool(span_dir: str, trace_id: str | None = None,
               limit: int | None = None) -> list[dict]:
    """Every span in the spool (finalized segments + open spools),
    oldest segment first; ``trace_id`` filters, ``limit`` keeps the
    newest N.  Tolerant of torn tails: a half-written last line (the
    process died mid-write) is skipped, everything before it is
    served."""
    spans: list[dict] = []
    for path in list_segments(span_dir, include_open=True):
        try:
            with open(path, encoding="utf-8") as fp:
                for line in fp:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        s = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail of a killed writer
                    if isinstance(s, dict):
                        spans.append(s)
        except OSError:
            continue
    if trace_id is not None:
        spans = [s for s in spans if s.get("trace") == trace_id]
    if limit is not None:
        spans = spans[-limit:] if limit > 0 else []
    return spans
