"""Fleet observability: cross-host trace collection + metrics
federation for the serve mesh.

Every process has a flight recorder and serving is multi-host --
but a trace that crosses the worker RPC ended up sharded
across rings: the router's ``GET /v1/debug/trace`` only knew the
router's half.  :class:`FleetObserver` closes that gap on the router:

* **incremental collection** -- a background loop pages every known
  worker's recorder with ``GET /v1/debug/trace?since_seq=<cursor>``
  (spans carry a monotone per-process ``seq``; the ``X-HPNN-Trace-Seq``
  response header is the worker's newest seq, so a header BELOW the
  cursor means the worker restarted and the cursor rewinds to 0).
  Collected spans are tagged ``host=<worker addr>, role=worker`` and
  retained in a bounded per-worker store -- so an ejected or kill -9'd
  worker's last window of spans survives the worker.
* **merged queries** -- the router's own ``/v1/debug/trace`` serves the
  MERGED view: its local ring (tagged ``role=router``) plus the store,
  deduplicated by span id, time-ordered.  A query drains the live
  workers first, so ``?trace=ID`` right after a request returns the
  complete route -> worker -> device tree from one endpoint; that also
  makes job traces (``?trace=job:<id>``) and the mesh lifecycle
  timeline (``?trace=mesh``) fleet-wide.
* **metrics federation** -- ``federated_metrics()`` pulls each worker's
  JSON metrics snapshot for ``GET /metrics?fleet=1``; dead workers
  federate as ``None`` (an explicit gap -- never stale numbers), and
  ``serve.metrics.fleet_rollup`` sums the counters and merges the
  latency histograms into fleet series.

Knobs: ``HPNN_FLEET_POLL_S`` (background drain period, default 2 s),
``HPNN_FLEET_TRACE_BUFFER`` (spans retained per worker, default 4096).
The collector exists only on a mesh router and only does work when
tracing / a fleet scrape asks -- a worker or single-process server
pays nothing.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from collections import deque

from ...obs import trace as obs_trace
from ...utils.env import env_float, env_int
from ...utils.nn_log import nn_dbg
from . import transport
from .backend import TRANSPORT_ERRORS

_DEFAULT_POLL_S = 2.0
_DEFAULT_CAPACITY = 4096


def get_raw(addr: str, path: str, timeout_s: float = 5.0,
            headers: dict | None = None) -> tuple[int, bytes, dict]:
    """One GET returning (status, raw body, response headers) through
    the mesh's keep-alive transport -- the NDJSON trace endpoint is not
    JSON, so ``backend.get_json`` cannot fetch it."""
    return transport.request(addr, "GET", path, headers=headers,
                             timeout_s=timeout_s)


class FleetObserver:
    """The router-side collector + federation client (see module doc).
    One instance per MeshRouter; all access is thread-safe."""

    def __init__(self, pool, poll_interval_s: float | None = None,
                 capacity: int | None = None,
                 auth_token: str | None = None):
        self.pool = pool
        self.poll_interval_s = (
            poll_interval_s if poll_interval_s is not None
            else env_float("HPNN_FLEET_POLL_S", _DEFAULT_POLL_S))
        self.capacity = max(64, capacity if capacity is not None
                            else env_int("HPNN_FLEET_TRACE_BUFFER",
                                         _DEFAULT_CAPACITY))
        self.auth_token = auth_token
        self.host = socket.gethostname()  # the router's host tag
        self._store: dict[str, deque] = {}   # addr -> tagged span deque
        self._cursors: dict[str, int] = {}   # addr -> last seq consumed
        self._rings: dict[str, str] = {}     # addr -> last seen ring id
        # spans EVICTED from a per-worker store deque (capacity hit):
        # the merged view reports these as an explicit truncation
        # marker instead of silently narrowing the window
        self._evicted: dict[str, int] = {}   # addr -> dropped spans
        self._lock = threading.Lock()
        # serializes whole drains (background loop vs query-time drain):
        # cursors must advance under exactly one drain at a time or two
        # racers would double-collect a page
        self._drain_lock = threading.Lock()
        self.spans_collected_total = 0
        self.drains_total = 0
        self._closed = False
        self._thread: threading.Thread | None = None

    # --- lifecycle -------------------------------------------------------
    def start(self) -> "FleetObserver":
        def loop():
            while not self._closed:
                time.sleep(self.poll_interval_s)
                if self._closed:
                    return
                # the merged endpoint 404s while router tracing is off,
                # so background collection would be unreadable chatter;
                # drain_once() itself stays ungated for direct callers
                if not obs_trace.enabled():
                    continue
                try:
                    self.drain_once()
                except Exception as exc:  # the collector must never
                    # die for good over one malformed response
                    nn_dbg(f"fleet: drain error (loop continues): "
                           f"{type(exc).__name__}: {exc}\n")

        self._thread = threading.Thread(
            target=loop, name="hpnn-fleet-collector", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._closed = True

    # --- trace collection ------------------------------------------------
    def _fetch_page(self, addr: str, since_seq: int
                    ) -> tuple[list[dict], int, str] | None:
        """One worker ring page: (span dicts, worker's last seq, ring
        id), or None when the worker is unreachable / has tracing
        off."""
        headers = {}
        if self.auth_token:
            headers["Authorization"] = f"Bearer {self.auth_token}"
        try:
            status, raw, resp_headers = get_raw(
                addr, f"/v1/debug/trace?since_seq={since_seq}&local=1",
                timeout_s=2.0, headers=headers)
        except TRANSPORT_ERRORS:
            return None
        if status != 200:
            return None  # 404: tracing disabled on that worker
        try:
            last = int(resp_headers.get("X-HPNN-Trace-Seq", "0"))
        except ValueError:
            last = 0
        ring = resp_headers.get("X-HPNN-Trace-Ring", "")
        spans = []
        for line in raw.decode("utf-8", "replace").splitlines():
            if not line.strip():
                continue
            try:
                s = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(s, dict):
                spans.append(s)
        return spans, last, ring

    def drain_once(self) -> int:
        """Page every reachable worker's ring past our cursor; returns
        the number of spans collected.  Dead workers are skipped (their
        already-collected window stays in the store -- that IS the
        point), and a worker whose seq went BACKWARD (restart,
        re-enable) rewinds the cursor and re-pages from 0."""
        from .router import STATE_DEAD

        collected = 0
        with self._drain_lock:
            # REMOVED workers (autoscale retire/reap -- gone from the
            # pool table on purpose, unlike merely-dead ones) take
            # their store/cursor/ring state with them: autoscale churn
            # mints a fresh ephemeral addr per spawn, and without this
            # prune a long-lived tracing router would accumulate a
            # full span ring per corpse forever
            known = {w.addr for w in self.pool.workers()}
            with self._lock:
                for addr in [a for a in self._store if a not in known]:
                    del self._store[addr]
                    self._evicted.pop(addr, None)
            for d in (self._cursors, self._rings):
                for addr in [a for a in d if a not in known]:
                    del d[addr]
            for w in self.pool.workers():
                if w.state == STATE_DEAD:
                    continue
                addr = w.addr
                cursor = self._cursors.get(addr, 0)
                page = self._fetch_page(addr, cursor)
                if page is None:
                    continue
                spans, last, ring = page
                # restart detection: the ring id changed (restart that
                # may already have out-run our cursor), or -- for rings
                # predating the id header -- the seq went backward
                known_ring = self._rings.get(addr)
                if ((ring and ring != known_ring
                     and known_ring is not None)
                        or last < cursor):
                    cursor = 0
                    page = self._fetch_page(addr, 0)
                    if page is None:
                        continue
                    spans, last, ring = page
                if ring:
                    self._rings[addr] = ring
                if spans:
                    with self._lock:
                        ring = self._store.get(addr)
                        if ring is None:
                            ring = self._store[addr] = deque(
                                maxlen=self.capacity)
                        for s in spans:
                            s["host"] = addr
                            s["role"] = "worker"
                            if len(ring) == ring.maxlen:
                                # the append below evicts the oldest:
                                # count it, the merged view reports it
                                self._evicted[addr] = \
                                    self._evicted.get(addr, 0) + 1
                            ring.append(s)
                        self.spans_collected_total += len(spans)
                    collected += len(spans)
                    exp = obs_trace.get_exporter()
                    if exp is not None:
                        # durable export: collected worker
                        # spans ride the router's spool too, so the
                        # remote halves of traces survive a SIGKILL of
                        # BOTH the worker and this router
                        for s in spans:
                            exp.offer(s)
                self._cursors[addr] = max(last, cursor)
            self.drains_total += 1
        return collected

    def collected_spans(self, trace_id: str | None = None) -> list[dict]:
        """Every retained worker span (the router's post-mortem dump
        appends these so remote halves of traces survive a SIGTERM)."""
        with self._lock:
            spans = [s for ring in self._store.values() for s in ring]
        if trace_id is not None:
            spans = [s for s in spans if s.get("trace") == trace_id]
        return spans

    def merged_spans(self, trace_id: str | None = None,
                     limit: int | None = None,
                     drain: bool = True) -> list[dict]:
        """The fleet-merged view: router ring (tagged role=router) +
        collected worker spans, deduplicated by span id, time-ordered
        oldest first.  ``drain=True`` pages the live workers first so a
        query reflects spans recorded moments ago.

        Truncation is EXPLICIT: when the bounded
        per-worker store has evicted spans, or ``limit`` cut the
        result, the last entry is a synthetic ``trace.truncated``
        marker carrying the dropped counts -- a narrowed window must
        announce itself, not masquerade as the whole history."""
        if drain:
            try:
                self.drain_once()
            except Exception:
                pass  # a failed refresh still serves the store
        merged: dict = {}
        for s in obs_trace.snapshot(trace_id=trace_id):
            t = dict(s)
            t.setdefault("host", self.host)
            t.setdefault("role", "router")
            merged[t.get("span") or id(t)] = t
        # collected copies win: a worker's own report of its span is
        # authoritative for host/role (matters only when test processes
        # share one in-process ring; disjoint in a real fleet)
        for s in self.collected_spans(trace_id=trace_id):
            merged[s.get("span") or id(s)] = s
        if trace_id is not None:
            # follow span LINKS: a coalesced batch rides the RPC under
            # its head's trace id, and every member's mesh.route span
            # names it as remote_trace -- pulling the linked traces'
            # WORKER spans completes a non-head member's tree (the
            # worker's device spans honestly served this member's rows)
            linked = {s.get("remote_trace") for s in merged.values()
                      if s.get("remote_trace")} - {trace_id}
            for lt in linked:
                for s in self.collected_spans(trace_id=lt):
                    merged.setdefault(s.get("span") or id(s), s)
        spans = sorted(merged.values(),
                       key=lambda s: (s.get("ts", 0.0),
                                      s.get("seq", 0)))
        dropped_limit = 0
        if limit is not None:
            kept = spans[-limit:] if limit > 0 else []
            dropped_limit = len(spans) - len(kept)
            spans = kept
        with self._lock:
            evicted = dict(self._evicted)
        dropped_store = sum(evicted.values())
        if dropped_store or dropped_limit:
            marker = {
                "name": "trace.truncated",
                "trace": trace_id or "mesh",
                "span": "truncation-marker",
                "parent": None,
                # anchored to the newest retained span: the marker
                # must sort last, and minting a fresh wall read here
                # would say nothing truthful about WHEN spans dropped
                "ts": spans[-1].get("ts", 0.0) if spans else 0.0,
                "dur_s": 0.0,
                "role": "router",
                "host": self.host,
                "dropped_spans": dropped_store + dropped_limit,
            }
            if dropped_store:
                marker["dropped_store"] = dropped_store
                marker["dropped_by_host"] = evicted
            if dropped_limit:
                marker["dropped_limit"] = dropped_limit
            spans = spans + [marker]
        return spans

    def merged_dump(self, trace_id: str | None = None,
                    limit: int | None = None) -> str:
        return obs_trace.render_ndjson(
            self.merged_spans(trace_id=trace_id, limit=limit))

    # --- trace search federation -------------------------------
    def federated_search(self, params: dict) -> dict:
        """Every LIVE worker's ``/v1/debug/trace/search?...&local=1``
        result rows keyed by addr (None = unreachable / no index
        there).  Dead workers are deliberately skipped: their spans
        are already in this router's store/spool -- that IS how dead
        hosts stay queryable.  Workers are queried concurrently on the
        pool's RPC executor, like the metrics federation."""
        import urllib.parse

        qs = urllib.parse.urlencode(
            {k: v for k, v in params.items()
             if v not in (None, "") and k != "local"})
        path = "/v1/debug/trace/search?local=1" + (
            "&" + qs if qs else "")
        headers = {}
        if self.auth_token:
            headers["Authorization"] = f"Bearer {self.auth_token}"

        def query(addr: str):
            try:
                status, raw, _h = get_raw(addr, path, timeout_s=2.0,
                                          headers=headers)
                if status != 200:
                    return None
                body = json.loads(raw.decode("utf-8"))
            except TRANSPORT_ERRORS:
                return None
            except (UnicodeDecodeError, json.JSONDecodeError):
                return None
            rows = body.get("traces") if isinstance(body, dict) else None
            return rows if isinstance(rows, list) else None

        from .router import STATE_DEAD

        out: dict = {}
        futures = {}
        for w in self.pool.workers():
            if w.state == STATE_DEAD:
                continue
            futures[w.addr] = self.pool.executor.submit(query, w.addr)
        for addr, fut in futures.items():
            try:
                out[addr] = fut.result(timeout=5.0)
            except Exception:
                out[addr] = None
        return out

    # --- metrics federation ----------------------------------------------
    def federated_metrics(self) -> dict:
        """Every known worker's JSON metrics snapshot keyed by addr;
        ``None`` marks a worker that could not be scraped (dead or
        unreachable) -- an explicit gap, never stale numbers.  Workers
        are scraped CONCURRENTLY on the pool's RPC executor: N
        degraded-but-connectable workers must cost one 2 s timeout,
        not N sequential ones (a Prometheus scrape_timeout budget)."""
        from .backend import get_json
        from .router import STATE_DEAD

        headers = {}
        if self.auth_token:
            headers["Authorization"] = f"Bearer {self.auth_token}"

        def scrape(addr: str):
            try:
                status, body = get_json(addr, "/metrics?format=json",
                                        timeout_s=2.0, headers=headers)
            except TRANSPORT_ERRORS:
                return None
            return body if status == 200 and body else None

        out: dict = {}
        futures = {}
        for w in self.pool.workers():
            if w.state == STATE_DEAD:
                out[w.addr] = None
            else:
                futures[w.addr] = self.pool.executor.submit(scrape,
                                                            w.addr)
        for addr, fut in futures.items():
            try:
                out[addr] = fut.result(timeout=5.0)
            except Exception:
                out[addr] = None
        return out

    def stats(self) -> dict:
        """Collector accounting for /metrics + the obs bench."""
        with self._lock:
            retained = sum(len(r) for r in self._store.values())
            tracked = len(self._store)
            evicted = sum(self._evicted.values())
        return {"spans_collected_total": self.spans_collected_total,
                "spans_retained": retained,
                "spans_evicted_total": evicted,
                "workers_tracked": tracked,
                "drains_total": self.drains_total,
                "poll_interval_s": self.poll_interval_s,
                "capacity_per_worker": self.capacity}
