"""Router-side mesh state: the worker pool and the fleet coordinator.

:class:`WorkerPool` is the routing table.  Workers announce themselves
(``POST /v1/mesh/register``, repeated as a heartbeat) and the pool
health-checks every known worker's ``/healthz`` on a poll loop:

* **placement** -- ``pick(kernel, bucket)`` routes a batch with
  bucket-affinity + least-depth: among live workers at the minimum
  in-flight depth, the worker that last served this (kernel, bucket) is
  preferred -- its bucket cache is warm for exactly this padded shape -- and
  ties rotate round-robin.  Workers whose registered weights generation
  matches the router's are preferred over stale ones (availability
  still wins: a stale worker beats no worker).
* **ejection / readmission** -- a transport failure during dispatch
  ejects immediately (connection refused is decisive); health-check
  failures eject after ``HPNN_MESH_EJECT_AFTER`` consecutive misses.
  A later healthy ``/healthz`` (or a fresh registration -- the worker
  restarted) readmits, and the worker's own heartbeat loop catches its
  weights generation up before it reports current again.

:class:`MeshRouter` owns the pool plus fleet-coherent reload: a reload
on the router (manual POST or the ckpt-manifest watcher) broadcasts
``{"kernel": path, "set_generation": G}`` to every live worker FIRST,
ejects any worker that fails to land it, and only then flips the
router's own generation label -- so the fleet never serves two
generations under one label longer than the broadcast takes, and
``X-HPNN-Generation`` pins mean the same weights on every host.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

from ...utils.env import env_float as _env_float
from ...utils.env import env_int as _env_int
from ...utils.nn_log import nn_warn
from .backend import (
    TRANSPORT_ERRORS,
    NoLiveWorker,
    RemoteBackend,
    get_json,
    post_json,
)
from .events import mesh_event
from .worker import swarm_enabled

STATE_LIVE = "live"
STATE_WARMING = "warming"   # registered, /healthz still 503-warming
STATE_DEAD = "dead"
# being drained out on purpose (autoscale retire / worker goodbye):
# never routed, never health-promoted back to live.  Exits: removal
# (the supervisor reaped the process), a registration arriving AFTER
# the retire grace window (the drain is long over -- this is a
# restarted process that wants back in, not the dying one's last
# heartbeat), or the health loop forgetting a retiring corpse whose
# heartbeats stopped a grace window ago
STATE_RETIRING = "retiring"


class BlobStore:
    """Content-addressed kernel bytes the router serves at
    ``GET /v1/mesh/blob/<sha256>`` (tentpole b): reload broadcasts and
    registration acks carry ``{sha256, size}`` instead of a filesystem
    path, and workers on DISJOINT filesystems pull the weights over
    HTTP, verifying the hash on their side.  The sha256 is the same
    digest ``ckpt/snapshot.py`` records in the checkpoint manifest
    (the bytes are the ``kernel.opt`` text encoding), so a blob is
    cross-checkable against the manifest that produced it.

    Bounded LRU by total bytes (``HPNN_MESH_BLOB_CACHE_MB``, default
    256): old generations age out; the CURRENT generation of every
    served kernel is re-inserted on demand from the router's own source
    file."""

    def __init__(self, max_mb: int | None = None):
        self.max_bytes = (max_mb if max_mb is not None
                          else _env_int("HPNN_MESH_BLOB_CACHE_MB",
                                        256)) * (1 << 20)
        self._blobs: OrderedDict[str, bytes] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        # observability: LRU pressure and the
        # router's blob-serving egress were invisible; /metrics renders
        # both (hpnn_mesh_blob_evictions_total / _egress_bytes_total)
        self.evictions_total = 0
        self.egress_bytes_total = 0
        self.serves_total = 0

    def put(self, data: bytes) -> dict:
        """Insert (idempotent) and return the ``{sha256, size}`` meta
        a broadcast/ack carries."""
        sha = hashlib.sha256(data).hexdigest()
        with self._lock:
            if sha in self._blobs:
                self._blobs.move_to_end(sha)
            else:
                self._blobs[sha] = data
                self._bytes += len(data)
                while (self._bytes > self.max_bytes
                       and len(self._blobs) > 1):
                    _old, dropped = self._blobs.popitem(last=False)
                    self._bytes -= len(dropped)
                    self.evictions_total += 1
        return {"sha256": sha, "size": len(data)}

    def get(self, sha: str) -> bytes | None:
        with self._lock:
            data = self._blobs.get(sha)
            if data is not None:
                self._blobs.move_to_end(sha)
            return data

    def count_egress(self, n: int) -> None:
        """One blob served over HTTP: ``n`` bytes left this host."""
        with self._lock:
            self.serves_total += 1
            self.egress_bytes_total += int(n)

    def stats(self) -> dict:
        with self._lock:
            return {"blobs": len(self._blobs), "bytes": self._bytes,
                    "max_bytes": self.max_bytes,
                    "evictions_total": self.evictions_total,
                    "serves_total": self.serves_total,
                    "egress_bytes_total": self.egress_bytes_total}


class Worker:
    """One registered worker host."""

    __slots__ = ("wid", "addr", "state", "fails", "inflight", "routed",
                 "failovers", "kernels", "created_at", "last_seen",
                 "jobs", "retired_at", "goodbye", "blobs")

    def __init__(self, addr: str):
        self.wid = addr  # the advertised addr IS the identity
        self.addr = addr
        self.state = STATE_LIVE
        self.fails = 0
        self.inflight = 0
        self.routed = 0
        self.failovers = 0
        self.kernels: dict[str, dict] = {}
        self.jobs: dict | None = None  # heartbeat-advertised job state
        # swarm who-has index: sha256 PREFIXES this worker's
        # heartbeat advertised -- the router picks peer hints from it
        self.blobs: set[str] = set()
        self.created_at = time.time()  # displayed registration timestamp
        self.last_seen = time.monotonic()
        self.retired_at = 0.0  # monotonic; set when retiring starts
        self.goodbye = False   # said {"retiring": true} (graceful exit)

    def has_blob(self, sha: str) -> bool:
        """Does the advertised has-set cover this sha?  Prefix match,
        so router and worker need not agree on the prefix length."""
        return any(sha.startswith(p) for p in self.blobs)

    def to_dict(self) -> dict:
        d = {"addr": self.addr, "state": self.state,
             "consecutive_failures": self.fails,
             "inflight": self.inflight, "routed": self.routed,
             "failovers": self.failovers,
             "registered_at": round(self.created_at, 3),
             "kernels": {n: dict(v) for n, v in self.kernels.items()}}
        if self.jobs is not None:
            d["jobs"] = dict(self.jobs)
        if self.blobs:
            # the standby's mirror adopts the who-has index, so a
            # takeover keeps swarming without waiting a heartbeat round
            d["blobs"] = sorted(self.blobs)
        return d


class WorkerPool:
    def __init__(self, eject_after: int | None = None,
                 auth_token: str | None = None,
                 router_token: str | None = None):
        self.eject_after = (eject_after if eject_after is not None
                            else _env_int("HPNN_MESH_EJECT_AFTER", 2))
        # how long a retirement "owns" the addr: registrations inside
        # the window are the DYING process's heartbeats (stay
        # retiring); after it, a registration is a restarted process
        # that wants back in (promote), and a retiring corpse whose
        # heartbeats stopped this long ago is forgotten by the health
        # loop -- without the window, one goodbye would brick the addr
        # forever (retiring was sticky across restarts)
        self.retire_grace_s = _env_float("HPNN_MESH_RETIRE_GRACE_S",
                                         60.0, lo=0.1)
        self.auth_token = auth_token
        # the spill-protection token RemoteBackend stamps on every
        # dispatch RPC (X-HPNN-Router); workers learn it from the
        # registration ack
        self.router_token = router_token
        self._workers: dict[str, Worker] = {}
        self._affinity: dict[tuple[str, int], str] = {}
        self._rr = 0
        self._lock = threading.Lock()
        self.failovers_total = 0
        # RPC executor: bounded, shared by every RemoteBackend.  Its
        # width is the HARD cap on concurrent worker RPCs (the backend's
        # pipeline depth clamps to it): fleets past 16 workers need
        # HPNN_MESH_RPC_THREADS raised to keep one batch in flight per
        # worker.  Threads block on HTTP, not CPU, so they are cheap.
        self.rpc_threads = _env_int("HPNN_MESH_RPC_THREADS", 16)
        self.executor = ThreadPoolExecutor(
            max_workers=self.rpc_threads,
            thread_name_prefix="hpnn-mesh-rpc")
        self._closed = False
        self._health_thread: threading.Thread | None = None

    # --- membership ------------------------------------------------------
    def register(self, addr: str, kernels: dict | None = None,
                 jobs: dict | None = None,
                 blobs: list | None = None) -> Worker:
        """Create or refresh a worker entry (registration doubles as the
        heartbeat).  A re-registering dead worker is readmitted -- the
        process restarted or the partition healed.  A WARMING worker
        stays warming: its heartbeat only proves the process is up; the
        health loop promotes it when /healthz says ok (otherwise the
        2s heartbeat would flap the 1s health demotion live/warming
        and the router's quorum readiness with it)."""
        with self._lock:
            w = self._workers.get(addr)
            if w is None:
                w = self._workers[addr] = Worker(addr)
                mesh_event("worker_registered",
                           f"mesh: worker {addr} registered\n",
                           worker=addr)
            elif w.state == STATE_DEAD:
                mesh_event("worker_readmitted",
                           f"mesh: worker {addr} readmitted "
                           "(re-registration)\n",
                           worker=addr, via="re-registration")
            if w.state == STATE_RETIRING:
                # inside the grace window this is the dying process's
                # own heartbeat -- it must not re-enter routing; past
                # it, the drain is long over and a registering process
                # is a RESTART that wants back in
                if (time.monotonic() - w.retired_at
                        > self.retire_grace_s):
                    w.state = STATE_LIVE
                    w.goodbye = False  # this is a fresh process
                    mesh_event("worker_readmitted",
                               f"mesh: worker {addr} readmitted "
                               "(re-registration after retirement)\n",
                               worker=addr, via="post-retire")
            elif w.state != STATE_WARMING:
                w.state = STATE_LIVE
            w.fails = 0
            w.last_seen = time.monotonic()
            if kernels:
                w.kernels = {str(k): dict(v) for k, v in kernels.items()
                             if isinstance(v, dict)}
            if jobs is not None and isinstance(jobs, dict):
                w.jobs = jobs
            if blobs is not None and isinstance(blobs, (list, tuple)):
                # the heartbeat's has-set REPLACES the index entry (the
                # worker's cache is the truth; evicted blobs drop out)
                w.blobs = {str(p).lower() for p in blobs
                           if isinstance(p, str) and p}
            return w

    def workers(self) -> list[Worker]:
        with self._lock:
            return list(self._workers.values())

    def live_count(self) -> int:
        with self._lock:
            return sum(1 for w in self._workers.values()
                       if w.state == STATE_LIVE)

    def table(self) -> dict:
        with self._lock:
            return {w.wid: w.to_dict() for w in self._workers.values()}

    # --- placement -------------------------------------------------------
    def pick(self, kernel: str, bucket: int,
             exclude: set | None = None,
             want_gen: int | None = None) -> Worker:
        """Bucket-affinity + least-depth placement (see module doc)."""
        with self._lock:
            live = [w for w in self._workers.values()
                    if w.state == STATE_LIVE
                    and (not exclude or w.wid not in exclude)]
            if not live:
                raise NoLiveWorker(
                    f"no live worker for kernel '{kernel}' "
                    f"({len(self._workers)} known)")
            # heterogeneous fleets: a worker that advertised kernels
            # but NOT this one would answer 404 (no retry -- an HTTP
            # answer is not a transport failure); prefer advertisers,
            # fall back to anyone (a bare registration lists nothing)
            adv = [w for w in live if not w.kernels or kernel in w.kernels]
            live = adv or live
            if want_gen is not None:
                matched = [w for w in live
                           if w.kernels.get(kernel, {}).get("generation")
                           in (None, want_gen)]
                live = matched or live  # stale beats unavailable
            min_depth = min(w.inflight for w in live)
            best = [w for w in live if w.inflight == min_depth]
            akey = (kernel, int(bucket))
            aff = self._affinity.get(akey)
            chosen = next((w for w in best if w.wid == aff), None)
            if chosen is None:
                chosen = best[self._rr % len(best)]
                self._rr += 1
                self._affinity[akey] = chosen.wid
            chosen.routed += 1
            return chosen

    def note_dispatch(self, worker: Worker) -> None:
        with self._lock:
            worker.inflight += 1

    def note_done(self, worker: Worker) -> None:
        with self._lock:
            worker.inflight = max(0, worker.inflight - 1)

    # --- elastic lifecycle ------------------------------------
    def retire(self, addr: str, via: str = "autoscale") -> bool:
        """Take a worker OUT of routing on purpose (scale-down /
        graceful goodbye): placement skips it, the health loop leaves
        it alone, and in-flight batches finish normally -- the drain
        half of drain-then-SIGTERM.  False for unknown workers."""
        with self._lock:
            w = self._workers.get(addr)
            if w is not None and via == "goodbye":
                # the exec-hook ack: an observed
                # goodbye is the confirmation a hook-driven retire
                # really happened on the external system
                w.goodbye = True
            if w is None or w.state == STATE_RETIRING:
                return w is not None
            w.state = STATE_RETIRING
            w.retired_at = time.monotonic()
        mesh_event("worker_retiring",
                   f"mesh: worker {addr} retiring ({via})\n",
                   worker=addr, via=via)
        return True

    def unretire(self, addr: str) -> bool:
        """Cancel a retirement that never happened (the exec hook
        failed): the worker is healthy and goes straight back into
        routing."""
        with self._lock:
            w = self._workers.get(addr)
            if w is None or w.state != STATE_RETIRING:
                return False
            w.state = STATE_LIVE
            w.retired_at = 0.0
        mesh_event("worker_readmitted",
                   f"mesh: worker {addr} readmitted "
                   "(retirement cancelled)\n",
                   worker=addr, via="unretire")
        return True

    def inflight_of(self, addr: str) -> int:
        """Batches currently in flight to one worker (the drain gate:
        SIGTERM waits for 0)."""
        with self._lock:
            w = self._workers.get(addr)
            return w.inflight if w is not None else 0

    def remove(self, addr: str) -> bool:
        """Forget a worker entirely (its process is gone): the table,
        affinity entries and quorum math stop counting it."""
        with self._lock:
            w = self._workers.pop(addr, None)
            if w is None:
                return False
            for key in [k for k, wid in self._affinity.items()
                        if wid == addr]:
                del self._affinity[key]
        mesh_event("worker_removed",
                   f"mesh: worker {addr} removed\n",
                   level="dbg", worker=addr)
        return True

    # --- health ----------------------------------------------------------
    def report_failure(self, worker: Worker, exc: Exception) -> None:
        """A dispatch-time transport failure: decisive, eject NOW (the
        health loop readmits when /healthz answers again)."""
        with self._lock:
            worker.fails += 1
            self.failovers_total += 1
            worker.failovers += 1
            if worker.state != STATE_DEAD:
                worker.state = STATE_DEAD
                mesh_event("worker_ejected",
                           f"mesh: worker {worker.addr} ejected "
                           f"({type(exc).__name__}: {exc})\n",
                           level="warn", worker=worker.addr,
                           via="dispatch",
                           error=f"{type(exc).__name__}: {exc}")

    def report_ok(self, worker: Worker) -> None:
        """A successful dispatch or an ok /healthz poll: THE promotion
        path back to live (readmission for the dead, warm-up completion
        for the warming -- registration heartbeats deliberately never
        promote, see ``register``)."""
        with self._lock:
            worker.fails = 0
            worker.last_seen = time.monotonic()
            if worker.state == STATE_RETIRING:
                return  # healthy, but being drained out on purpose
            if worker.state == STATE_DEAD:
                worker.state = STATE_LIVE
                mesh_event("worker_readmitted",
                           f"mesh: worker {worker.addr} readmitted\n",
                           worker=worker.addr, via="health")
            elif worker.state == STATE_WARMING:
                worker.state = STATE_LIVE

    def check_health_once(self) -> None:
        """One poll round over every known worker (dead ones included --
        that is the readmission path).  RETIRING workers are not
        polled, but a retiring CORPSE -- heartbeats stopped a full
        grace window ago, so the process is really gone -- is
        forgotten here: the exec-hook retire path has no subprocess to
        reap, and without this sweep its table entry would linger
        forever."""
        now = time.monotonic()
        for w in self.workers():
            if w.state == STATE_RETIRING:
                if (now - w.last_seen > self.retire_grace_s
                        and now - w.retired_at > self.retire_grace_s):
                    self.remove(w.addr)
                continue
            try:
                status, body = get_json(w.addr, "/healthz", timeout_s=2.0)
            except TRANSPORT_ERRORS as exc:
                with self._lock:
                    w.fails += 1
                    if (w.state != STATE_DEAD
                            and w.fails >= self.eject_after):
                        w.state = STATE_DEAD
                        mesh_event(
                            "worker_ejected",
                            f"mesh: worker {w.addr} ejected "
                            f"(health: {type(exc).__name__})\n",
                            level="warn", worker=w.addr, via="health",
                            error=type(exc).__name__)
                continue
            if status == 200 and body.get("status") == "ok":
                self.report_ok(w)
            elif body.get("status") == "warming":
                with self._lock:
                    # reachable but compiling: not routable yet, but not
                    # a failure either
                    if w.state != STATE_DEAD:
                        w.state = STATE_WARMING
                    w.fails = 0
                    w.last_seen = time.monotonic()
            else:
                with self._lock:
                    w.fails += 1
                    if (w.state != STATE_DEAD
                            and w.fails >= self.eject_after):
                        w.state = STATE_DEAD
                        mesh_event(
                            "worker_ejected",
                            f"mesh: worker {w.addr} ejected "
                            f"(health: {status} "
                            f"{body.get('status')})\n",
                            level="warn", worker=w.addr, via="health",
                            error=f"{status} {body.get('status')}")

    def start_health_loop(self, interval_s: float) -> None:
        def loop():
            while not self._closed:
                time.sleep(interval_s)
                if self._closed:
                    return
                try:
                    self.check_health_once()
                except Exception as exc:  # the loop IS the mesh's
                    # ejection/readmission engine: one malformed worker
                    # entry must not silently kill it for good
                    nn_warn(f"mesh: health poll error (loop continues): "
                            f"{type(exc).__name__}: {exc}\n")

        self._health_thread = threading.Thread(
            target=loop, name="hpnn-mesh-health", daemon=True)
        self._health_thread.start()

    def close(self) -> None:
        self._closed = True
        self.executor.shutdown(wait=False)


class MeshRouter:
    """The app-facing coordinator: pool + fleet-coherent reload + the
    content-addressed blob store.  ``standby_addr`` names this router's
    health-checked standby (advertised to workers in every registration
    ack, so their heartbeats know where to fail over); ``router_token``
    is the spill-protection secret (minted when not supplied -- standby
    pairs should share one via ``--router-token`` /
    ``HPNN_MESH_ROUTER_TOKEN`` so takeover does not orphan
    ``--require-router`` workers; the standby also adopts the
    primary's token from the auth-guarded ``/v1/mesh/state`` mirror)."""

    def __init__(self, app, required: int = 1,
                 health_interval_s: float = 1.0,
                 standby_addr: str | None = None,
                 router_token: str | None = None):
        import secrets

        from .fleet import FleetObserver

        self.app = app
        self.required = max(1, int(required))
        self.standby_addr = standby_addr
        self.router_token = router_token or secrets.token_hex(16)
        self.blobs = BlobStore()
        # per-kernel blob meta cache, keyed by the generation it was
        # computed at: recomputed (one file read + hash) after a reload
        self._blob_meta: dict[str, tuple[int, dict]] = {}
        self._blob_lock = threading.Lock()
        # replicated checkpoint bundles: training hosts POST
        # packed bundles to /v1/mesh/bundle; the bytes live in the
        # content-addressed BlobStore the weight distribution uses (a
        # recovering host pulls them back over GET /v1/mesh/blob/<sha>)
        # AND in a durable disk spool (HPNN_MESH_BUNDLE_DIR) -- the
        # whole point of replication is surviving restarts, so LRU
        # eviction or a router restart must never lose a replica the
        # shipper was told landed.  The index maps each replication
        # scope to its bundles (memory first, disk on a cold start).
        import tempfile

        self._bundle_index: dict[str, list[dict]] = {}
        self._bundle_lock = threading.Lock()
        self._bundle_keep = _env_int("HPNN_MESH_BUNDLE_KEEP", 64, lo=1)
        self.bundle_dir = os.environ.get("HPNN_MESH_BUNDLE_DIR") \
            or os.path.join(tempfile.gettempdir(), "hpnn-mesh-bundles")
        self.pool = WorkerPool(auth_token=app.auth_token,
                               router_token=self.router_token)
        self.pool.start_health_loop(health_interval_s)
        # fleet observability: incremental worker-ring
        # collection + metrics federation; idle when tracing is off on
        # the workers and nothing scrapes ?fleet=1
        self.fleet = FleetObserver(
            self.pool, auth_token=app.auth_token).start()
        # serializes whole fleet reloads: the --watch-ckpt watcher
        # racing a manual POST must not broadcast two different weight
        # files under one target generation
        self._reload_lock = threading.Lock()

    def backend_for(self, model) -> RemoteBackend:
        return RemoteBackend(self.pool, model)

    def set_router_token(self, token: str) -> None:
        """Adopt a (standby-mirrored) spill-protection token: future
        dispatch RPCs and registration acks carry it."""
        self.router_token = token
        self.pool.router_token = token

    def close(self) -> None:
        self.fleet.close()
        self.pool.close()

    # --- content-addressed weights (GET /v1/mesh/blob/<sha>) -------------
    def blob_for(self, name: str) -> dict | None:
        """The ``{sha256, size}`` meta of ``name``'s CURRENT weights,
        inserting the bytes into the blob store on demand (reads the
        model's source file once per generation).  None when the model
        has no on-disk source to serve."""
        model = self.app.registry.get(name)
        if model is None:
            return None
        with self._blob_lock:
            cached = self._blob_meta.get(name)
            if (cached is not None and cached[0] == model.generation
                    and self.blobs.get(cached[1]["sha256"])
                    is not None):
                # meta current AND the bytes still resident: an
                # LRU-evicted blob must be re-read from source below,
                # or the ack would advertise a sha this router 404s
                return cached[1]
            src = model.source
            if not src:
                return None
            try:
                with open(src, "rb") as fp:
                    data = fp.read()
            except OSError:
                return None
            meta = self.blobs.put(data)
            self._blob_meta[name] = (model.generation, meta)
            return meta

    def blob_bytes(self, sha: str) -> bytes | None:
        """The HTTP layer's lookup for ``GET /v1/mesh/blob/<sha>``; a
        miss re-checks every served model's current source (an LRU
        eviction or router restart must not 404 the fleet's CURRENT
        generation).  Served bytes count into the egress totals -- the
        number the swarm bench reads to prove the router NIC left the
        reload hot path."""
        data = self.blobs.get(sha)
        if data is None:
            for name in self.app.registry.names():
                meta = self.blob_for(name)
                if meta is not None and meta["sha256"] == sha:
                    data = self.blobs.get(sha)
                    break
        if data is None:
            # replicated checkpoint bundles have a durable spool the LRU
            # cannot evict and a restart cannot lose
            data = self.bundle_blob_bytes(sha)
        if data is not None:
            self.blobs.count_egress(len(data))
        return data

    # --- swarm who-has index ----------------------------------
    def holders_of(self, sha: str, exclude: str | None = None,
                   cap: int = 8) -> list[str]:
        """Worker addresses whose advertised has-set covers ``sha`` --
        the peer-hint list a registration ack or reload broadcast
        carries.  Dead/retiring workers never seed (a hint to a corpse
        just costs the fetcher one bounded miss, but why hand them
        out); the fetcher jitters the order, so this list is stable."""
        out = []
        for w in self.pool.workers():
            if w.state in (STATE_DEAD, STATE_RETIRING):
                continue
            if w.addr == exclude:
                continue
            if w.has_blob(sha):
                out.append(w.addr)
                if len(out) >= cap:
                    break
        return out

    # --- replicated checkpoint bundles (POST /v1/mesh/bundle) ------------
    def _bundle_scope_dir(self, scope: str) -> str:
        safe = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in str(scope))[:64]
        return os.path.join(self.bundle_dir, safe)

    def store_bundle(self, scope: str, data: bytes, tag: str,
                     epoch: int) -> dict:
        """Accept one replicated checkpoint bundle: bytes into the
        content-addressed blob store AND the durable disk spool
        (``HPNN_MESH_BUNDLE_DIR``) -- a replica the shipper was told
        landed must survive LRU eviction and a router restart.  The
        per-scope index (newest last, bounded to
        ``HPNN_MESH_BUNDLE_KEEP``, pruned bundles unlinked) is kept in
        memory and mirrored to the spool's ``index.json``.  Returns
        the ``{sha256, size}`` the shipper verifies against its own
        digest; the disk write is part of the contract -- a spool
        failure fails the request so the shipper retries instead of
        trusting a volatile copy."""
        from ...ckpt import replicate as ckpt_replicate

        sha = hashlib.sha256(data).hexdigest()
        sdir = self._bundle_scope_dir(scope)
        ckpt_replicate.write_scope_blob(sdir, data, sha)
        meta = self.blobs.put(data)
        entry = {"sha256": meta["sha256"], "size": meta["size"],
                 "tag": str(tag), "epoch": int(epoch),
                 "stored_at": time.time()}
        with self._bundle_lock:
            # the shared spool protocol (ckpt/replicate.py): dedup,
            # sort, trim to keep-N, atomic index.json, unlink pruned
            self._bundle_index[str(scope)] = \
                ckpt_replicate.update_scope_index(sdir, entry,
                                                  self._bundle_keep)
        mesh_event("bundle_replicated",
                   f"mesh: stored replicated bundle {tag} "
                   f"(scope {scope}, {meta['size']} B)\n",
                   level="dbg", scope=str(scope), tag=str(tag),
                   epoch=int(epoch), sha256=meta["sha256"])
        return meta

    def _load_scope_index_locked(self, scope: str) -> list[dict]:
        """The live per-scope index; a cold start (empty memory) reads
        the spool's index.json so replicas survive router restarts."""
        index = self._bundle_index.get(scope)
        if index is not None:
            return index
        from ...ckpt.replicate import read_scope_index

        index = self._bundle_index[scope] = read_scope_index(
            self._bundle_scope_dir(scope))
        return index

    def bundle_list(self, scope: str) -> list[dict]:
        with self._bundle_lock:
            return [dict(e)
                    for e in self._load_scope_index_locked(str(scope))]

    def bundle_blob_bytes(self, sha: str) -> bytes | None:
        """Spool fallback for ``GET /v1/mesh/blob/<sha>``: a bundle
        evicted from the LRU (or stored by a previous router process)
        is re-read from disk, re-verified, and re-inserted."""
        if not sha or not all(c in "0123456789abcdef" for c in sha):
            return None
        with self._bundle_lock:
            scopes = list(self._bundle_index)
        try:
            disk_scopes = os.listdir(self.bundle_dir)
        except OSError:
            disk_scopes = []
        for sdir in {*(self._bundle_scope_dir(s) for s in scopes),
                     *(os.path.join(self.bundle_dir, d)
                       for d in disk_scopes)}:
            path = os.path.join(sdir, f"{sha}.bundle")
            try:
                with open(path, "rb") as fp:
                    data = fp.read()
            except OSError:
                continue
            if hashlib.sha256(data).hexdigest() != sha:
                nn_warn(f"mesh: spooled bundle {path} fails its "
                        "sha256; ignoring\n")
                continue
            self.blobs.put(data)
            return data
        return None

    def bundle_stats(self) -> dict:
        with self._bundle_lock:
            return {"scopes": len(self._bundle_index),
                    "bundles": sum(len(v) for v in
                                   self._bundle_index.values()),
                    "spool_dir": self.bundle_dir}

    # --- registration (POST /v1/mesh/register) ---------------------------
    def register_worker(self, addr: str, kernels: dict | None,
                        jobs: dict | None = None,
                        blobs: list | None = None) -> dict:
        self.pool.register(addr, kernels, jobs=jobs, blobs=blobs)
        # the ack tells the worker where the fleet SHOULD be: current
        # generation + weights blob (and source path, for shared-mount
        # fleets) per kernel, so an ejected/late worker catches itself
        # up before taking traffic again -- plus the standby to follow
        # on takeover and the spill-protection token.  With the swarm
        # on, each kernel's blob also carries peer hints, so the
        # heartbeat catch-up path swarms exactly like a broadcast.
        ack = {"ok": True, "live": self.pool.live_count(),
               "required": self.required,
               "kernels": self._kernel_state(exclude=addr),
               "router_token": self.router_token}
        if self.standby_addr:
            ack["standby"] = self.standby_addr
        return ack

    def _kernel_state(self, exclude: str | None = None) -> dict:
        state = {}
        swarm = swarm_enabled()
        for name in self.app.registry.names():
            model = self.app.registry.get(name)
            if model is None:
                continue
            info = {"generation": model.generation,
                    "source": model.source}
            blob = self.blob_for(name)
            if blob is not None:
                info["blob"] = blob
                if swarm:
                    peers = self.holders_of(blob["sha256"],
                                            exclude=exclude)
                    if peers:
                        info["peers"] = peers
            state[name] = info
        return state

    # --- standby mirror (GET /v1/mesh/state) -----------------------------
    def state_snapshot(self, include_token: bool = False) -> dict:
        """What a standby needs to mirror: the worker table, per-kernel
        generation + blob, and -- only on an AUTH-GUARDED request
        (``include_token``) -- the spill-protection token, so an
        unauthenticated client can never read the secret that
        ``--require-router`` workers trust."""
        snap = {"role": "router", "workers": self.pool.table(),
                "kernels": self._kernel_state(),
                "required": self.required}
        if self.standby_addr:
            snap["standby"] = self.standby_addr
        if include_token:
            snap["router_token"] = self.router_token
        return snap

    # --- readiness (healthz quorum) --------------------------------------
    def readiness(self) -> dict:
        table = self.pool.table()
        live = sum(1 for w in table.values() if w["state"] == STATE_LIVE)
        out = {"role": "router", "required": self.required,
               "live": live, "quorum": live >= self.required,
               "workers": {wid: {"state": w["state"],
                                 "inflight": w["inflight"],
                                 "consecutive_failures":
                                     w["consecutive_failures"]}
                           for wid, w in table.items()}}
        if self.standby_addr:
            out["standby"] = self.standby_addr
        return out

    # --- fleet-coherent reload ------------------------------------------
    def coherent_reload(self, name: str,
                        kernel_path: str | None = None) -> dict:
        """Broadcast-then-flip: push the new weights to every live
        worker at an explicit target generation, eject stragglers, then
        reload the router's own copy at the SAME generation (the traffic
        flip -- from here the router's label, A/B windows and pins all
        mean the new fleet-wide weights).  Whole reloads serialize on
        ``_reload_lock``: two racers (manifest watcher + manual POST)
        land as two DISTINCT generations in sequence, never two weight
        sets under one number.  Raises like a local reload: KeyError
        unknown kernel, ValueError unloadable file."""
        with self._reload_lock:
            return self._coherent_reload_locked(name, kernel_path)

    def _coherent_reload_locked(self, name: str,
                                kernel_path: str | None) -> dict:
        model = self.app.registry.get(name)
        if model is None:
            raise KeyError(name)
        src = kernel_path or model.source
        if not src:
            raise ValueError(
                f"kernel '{name}' has no weights file to reload from")
        # validate the file HERE before touching the fleet: a typo'd
        # path would otherwise make every worker answer 409, eject them
        # all, and punch a fleet-wide 503 hole for a request that could
        # never have succeeded
        from ...io.kernel_io import load_kernel

        if load_kernel(src) is None:
            raise ValueError(f"failed to load kernel from {src}")
        target = model.generation + 1
        # content-addressed distribution (tentpole b): the broadcast
        # carries {sha256, size} -- never a filesystem path -- and the
        # workers pull the bytes from THIS router's blob endpoint,
        # verifying the hash on their side.  That is what lets a fleet
        # of cloud VMs with disjoint filesystems land one coherent
        # reload.
        try:
            with open(src, "rb") as fp:
                data = fp.read()
        except OSError as exc:
            raise ValueError(f"failed to read kernel bytes from {src}: "
                             f"{exc}")
        blob = self.blobs.put(data)
        with self._blob_lock:
            self._blob_meta[name] = (target, blob)
        ok_workers, failed = [], []
        headers = {}
        if self.app.auth_token:
            headers["Authorization"] = f"Bearer {self.app.auth_token}"
        swarm = swarm_enabled()

        def _push(w, peers) -> bool:
            payload = {"blob": blob, "set_generation": target}
            if peers:
                payload["peers"] = peers
            try:
                status, body, _ = post_json(
                    w.addr, f"/v1/kernels/{name}/reload",
                    payload, timeout_s=30.0, headers=headers)
            except TRANSPORT_ERRORS as exc:
                self.pool.report_failure(w, exc)
                return False
            if status != 200:
                # the worker answered but could not land the weights:
                # eject it from routing until its heartbeat catches up,
                # or the fleet would serve two generations indefinitely
                self.pool.report_failure(
                    w, RuntimeError(f"reload HTTP {status}: "
                                    f"{body.get('error')}"))
                return False
            w.kernels.setdefault(name, {})["generation"] = \
                body.get("generation", target)
            if swarm:
                # the worker just landed + verified these bytes: index
                # it as a holder NOW so the next wave (and heartbeat
                # acks) can hint it, without a heartbeat round-trip
                w.blobs.add(blob["sha256"])
            return True

        alive = [w for w in self.pool.workers()
                 if w.state != STATE_DEAD]  # readmission catches dead up
        if swarm and len(alive) > 1:
            # swarm fan-out: the router seeds only K workers
            # (its egress stays O(K), not O(N)); every later wave is
            # hinted at the confirmed holders and sized to their count,
            # so availability doubles per wave -- the tree/ring
            # broadcast shape, not root-serialized sends.  Waves run
            # concurrently; a wave with zero surviving holders falls
            # back to seeding from the router again, so a seed failure
            # degrades to the origin path instead of stranding the tail.
            seeds_n = _env_int("HPNN_MESH_SWARM_SEEDS", 2, lo=1)
            pending = list(alive)
            holders: list = []
            wave = pending[:seeds_n]
            pending = pending[seeds_n:]
            while wave:
                hints = [h.addr for h in holders[:8]]
                with ThreadPoolExecutor(max_workers=len(wave)) as ex:
                    landed = list(ex.map(lambda w: _push(w, hints),
                                         wave))
                for w, okd in zip(wave, landed):
                    if okd:
                        ok_workers.append(w.wid)
                        holders.append(w)
                    else:
                        failed.append(w.wid)
                step = len(holders) if holders else seeds_n
                wave = pending[:step]
                pending = pending[step:]
        else:
            for w in alive:
                if _push(w, None):
                    ok_workers.append(w.wid)
                else:
                    failed.append(w.wid)
        mesh_event("reload_broadcast",
                   f"mesh: broadcast reload '{name}' gen {target}: "
                   f"{len(ok_workers)} ok, {len(failed)} failed\n",
                   level="dbg", kernel=name, generation=target,
                   workers_ok=len(ok_workers),
                   workers_failed=len(failed))
        result = self.app.reload_model(name, src, set_generation=target,
                                      broadcast=False)
        result["mesh"] = {"target_generation": target,
                          "workers_reloaded": ok_workers,
                          "workers_failed": failed,
                          "blob": blob}
        return result

    # --- metrics ---------------------------------------------------------
    def metrics_snapshot(self) -> dict:
        table = self.pool.table()
        by_state: dict[str, int] = {}
        for w in table.values():
            by_state[w["state"]] = by_state.get(w["state"], 0) + 1
        from . import transport

        return {"role": "router", "required": self.required,
                "live": by_state.get(STATE_LIVE, 0),
                "workers_by_state": by_state,
                "failovers_total": self.pool.failovers_total,
                "workers": table,
                "fleet_collector": self.fleet.stats(),
                "blobs": self.blobs.stats(),
                "bundles": self.bundle_stats(),
                "transport": transport.default_pool().stats(),
                "standby": self.standby_addr}
