"""Worker-side mesh agent: registration heartbeat + generation catch-up.

A mesh worker IS a complete single-process server (same registry,
batcher, tiers, metrics, tracing) -- the only worker-specific machinery
is this agent, which on a daemon loop

1. POSTs ``/v1/mesh/register`` to its current router every
   ``HPNN_MESH_HEARTBEAT_S`` seconds -- JITTERED (x0.8-1.2) so a fleet
   of workers does not heartbeat in lockstep -- advertising its address
   and the per-kernel weights generation it currently serves;
2. reads the router's ack -- the fleet's CURRENT generation plus the
   content-addressed weights blob (and source path, for shared-mount
   fleets) per kernel -- and catches itself up when it is BEHIND:
   the blob is pulled from the router over HTTP and sha256-verified,
   so a worker on a DISJOINT filesystem rejoins at the right weights
   with no shared mount and no operator action.  A worker AHEAD of the
   router (the window between a broadcast landing here and the
   router's own flip) never rolls back;
3. on registration failure BACKS OFF exponentially (jittered, capped
   at ``HPNN_MESH_HEARTBEAT_CAP_S``) instead of tight-looping log spam
   against a dead router, and -- when the ack ever named a standby --
   ALTERNATES between the primary and the standby, so heartbeats land
   on whichever router survives a takeover within a few backoff steps.

The ack also carries the router's spill-protection token
(``X-HPNN-Router``): a worker started with ``--require-router`` only
serves infer traffic stamped with it, so per-client quotas enforced at
the router cannot be bypassed by hitting the worker directly.

The agent also flips ``registry.retain_generations`` on: mesh reloads
must keep previous generations pinnable, or ``X-HPNN-Generation``
through the router would silently fall back to current weights.
"""

from __future__ import annotations

import os
import random
import tempfile
import threading
import time

from ...utils.env import env_float, env_int
from ...utils.nn_log import nn_warn
from . import transport
from .backend import TRANSPORT_ERRORS, post_json
from .events import mesh_event


def _heartbeat_s(default: float = 2.0) -> float:
    return env_float("HPNN_MESH_HEARTBEAT_S", default)


def swarm_enabled() -> bool:
    """Peer-to-peer blob fan-out.  ``HPNN_MESH_SWARM=0`` is
    the escape hatch: router-only pulls, byte-identical to the
    router-only path (no peer hints sent, none consumed)."""
    return env_int("HPNN_MESH_SWARM", 1) != 0


def hasset_prefix_len() -> int:
    """Hex chars of each advertised sha prefix (compactness knob): 12
    gives 48 bits -- collision-safe for any real fleet's blob count
    while keeping a 32-entry has-set under 500 bytes per heartbeat."""
    return env_int("HPNN_MESH_HASSET_PREFIX", 12, lo=4, hi=64)


def hasset_max() -> int:
    """Most blobs one heartbeat advertises (newest first)."""
    return env_int("HPNN_MESH_HASSET_MAX", 32, lo=1)


def _path_matches_blob(path: str, blob: dict) -> bool:
    """Does the file at ``path`` already hold exactly the announced
    bytes?  Shared-mount fleets short-circuit the HTTP fetch this way;
    a same-named but DIFFERENT file on a disjoint host does not.
    Streams the hash in bounded chunks."""
    return transport.verify_blob_file(
        path, str(blob.get("sha256", "")).lower(), blob.get("size"))


class WorkerAgent:
    def __init__(self, app, router_addr: str, advertise_addr: str,
                 interval_s: float | None = None,
                 blob_dir: str | None = None):
        self.app = app
        self.router_addr = router_addr   # the configured primary
        self.standby: str | None = None  # learned from the ack
        self.current = router_addr       # where heartbeats go NOW
        self.advertise = advertise_addr
        self.interval_s = (interval_s if interval_s is not None
                           else _heartbeat_s())
        self.router_token: str | None = None  # spill-protection secret
        # local home for fetched content-addressed blobs: per-process
        # by default so two workers on one host never race a file
        self.blob_dir = blob_dir \
            or os.environ.get("HPNN_MESH_BLOB_DIR") \
            or os.path.join(tempfile.gettempdir(),
                            f"hpnn-blobs-{os.getpid()}")
        self.registered = False
        self._closed = False
        self._thread: threading.Thread | None = None
        self._warned = False
        self._rng = random.Random()
        # swarm accounting: fetch outcomes (hit = a hinted
        # peer served the bytes, miss = one peer try failed, fallback =
        # peers exhausted and the router served) plus this worker's OWN
        # blob-serving egress -- what the bench reads to prove the
        # router NIC left the reload hot path
        self._swarm_lock = threading.Lock()
        self.swarm_hits = 0
        self.swarm_misses = 0
        self.swarm_fallbacks = 0
        self.blob_serves = 0
        self.blob_egress_bytes = 0
        # registration-failure backoff: base = one heartbeat period,
        # capped so a long-dead router costs one probe per cap period
        self._backoff = transport.Backoff(
            base_s=self.interval_s,
            cap_s=env_float("HPNN_MESH_HEARTBEAT_CAP_S", 30.0),
            rng=self._rng)
        # previous generations must stay pinnable through mesh reloads
        app.registry.retain_generations = True

    # --- one heartbeat ---------------------------------------------------
    def beat(self) -> bool:
        """Register/heartbeat once against ``self.current``; returns
        True when that router acked.  Catch-up reloads run inline (they
        are rare and the loop is a daemon thread, not a request path).
        On failure the target alternates to the other router of the
        pair (when one is known) so a takeover is followed without any
        push channel."""
        kernels = {}
        for name in self.app.registry.names():
            model = self.app.registry.get(name)
            if model is not None:
                kernels[name] = {
                    "generation": model.generation,
                    "n_inputs": model.n_inputs,
                    "n_outputs": model.n_outputs,
                    "topology": list(model.topology),
                }
        headers = {}
        if self.app.auth_token:
            headers["Authorization"] = f"Bearer {self.app.auth_token}"
        payload = {"addr": self.advertise, "kernels": kernels}
        if swarm_enabled():
            # who-has advertisement: compact sha prefixes of the local
            # blob cache, so the router's worker table doubles as the
            # swarm's who-has-what index.  Every completed fetch lands
            # in blob_dir, so availability re-advertises itself on the
            # next heartbeat without a dedicated gossip channel
            payload["blobs"] = self.blob_has_set()
        if self.app.jobs is not None:
            # fleet-wide job visibility: the router's worker
            # table names the running job + its trace id, so
            # `?trace=job:<id>` on the router finds the right worker's
            # spans without asking every host
            payload["jobs"] = self.app.jobs.active()
        target = self.current
        try:
            status, ack, _ = post_json(
                target, "/v1/mesh/register",
                payload, timeout_s=5.0, headers=headers)
        except TRANSPORT_ERRORS as exc:
            if not self._warned:
                # once, not every beat: the router may simply start
                # later (and the loop is backing off anyway)
                nn_warn(f"mesh: cannot reach router {target} ({exc}); "
                        "retrying with backoff\n")
                self._warned = True
            self._register_failed(target)
            return False
        if status != 200:
            if (ack.get("reason") != "standby_passive"
                    and not self._warned):
                nn_warn(f"mesh: router {target} rejected registration "
                        f"(HTTP {status}: {ack.get('error')})\n")
                self._warned = True
            # a passive standby saying "not yet" is expected while the
            # primary lives: alternate straight back
            self._register_failed(target)
            return False
        self._warned = False
        self.registered = True
        self._backoff.reset()
        # the PAIR follows the acks: the router
        # that just acked is the active half, and whatever standby it
        # advertises is the other -- so after a takeover + a fresh
        # standby attaching, failure alternation spans the CURRENT
        # pair, not the original (possibly long-dead) primary
        self.router_addr = target
        standby = ack.get("standby")
        if isinstance(standby, str) and standby and standby != target:
            self.standby = standby
        elif self.standby == target:
            # the old standby IS this active router and it advertises
            # no replacement: the pair is down to one.  A stale
            # self.standby equal to the target would make alternation
            # a no-op forever ("other" == target); clear it until a
            # new standby attaches and the acks re-advertise a pair
            self.standby = None
        token = ack.get("router_token")
        if isinstance(token, str) and token:
            self.router_token = token
        self._catch_up(ack.get("kernels") or {})
        return True

    def _register_failed(self, target: str) -> None:
        self.registered = False
        if self.standby is not None:
            # alternate within the pair: after a takeover the survivor
            # answers within one flip (plus the backoff delay)
            other = (self.standby if target == self.router_addr
                     else self.router_addr)
            if other and other != target:
                self.current = other
                mesh_event("worker_router_switch",
                           f"mesh: heartbeat switching to {other} "
                           f"(after failure against {target})\n",
                           level="dbg", worker=self.advertise,
                           target=other, failed=target)

    def _catch_up(self, ack_kernels: dict) -> None:
        for name, info in ack_kernels.items():
            model = self.app.registry.get(name)
            if model is None or not isinstance(info, dict):
                continue
            want = info.get("generation")
            src = info.get("source")
            blob = info.get("blob")
            if not isinstance(want, int):
                continue
            if model.generation >= want:
                continue  # current, or ahead mid-broadcast: never back
            path = None
            if isinstance(blob, dict) and blob.get("sha256"):
                if (src and os.path.exists(src)
                        and _path_matches_blob(src, blob)):
                    path = src  # shared mount: the bytes are local
                else:
                    headers = None
                    if self.app.auth_token:
                        headers = {"Authorization":
                                   f"Bearer {self.app.auth_token}"}
                    peers = info.get("peers")
                    if not (swarm_enabled()
                            and isinstance(peers, list)):
                        peers = ()
                    try:
                        path, source, misses = transport.fetch_blob_from(
                            self.current, str(blob["sha256"]),
                            blob.get("size"), self.blob_dir,
                            peers=peers, timeout_s=20.0,
                            headers=headers, rng=self._rng)
                    except transport.BlobError as exc:
                        nn_warn(f"mesh: cannot catch '{name}' up to "
                                f"generation {want}: {exc}\n")
                        continue
                    self.count_fetch(source, misses, bool(peers))
            elif src and os.path.exists(src):
                path = src  # pre-blob router: trust the shared mount
            if path is None:
                nn_warn(f"mesh: cannot catch '{name}' up to generation "
                        f"{want}: no blob announced and {src!r} not "
                        "readable from this host\n")
                continue
            try:
                self.app.reload_model(name, path, set_generation=want)
                mesh_event("worker_catch_up",
                           f"mesh: caught '{name}' up to generation "
                           f"{want} from {path}\n",
                           level="dbg", kernel=name, generation=want,
                           worker=self.advertise)
            except (ValueError, KeyError) as exc:
                nn_warn(f"mesh: catch-up reload of '{name}' failed: "
                        f"{exc}\n")

    # --- swarm blob serving ----------------------------------
    def blob_has_set(self) -> list[str]:
        """Compact who-has advertisement: sha256 prefixes
        (``HPNN_MESH_HASSET_PREFIX`` hex chars) of the blobs this
        worker's cache holds, newest first, at most
        ``HPNN_MESH_HASSET_MAX`` entries.  File NAMES are trusted --
        every landed blob was sha-verified at fetch time, and a peer
        pull re-verifies anyway."""
        try:
            names = os.listdir(self.blob_dir)
        except OSError:
            return []
        rows = []
        for n in names:
            sha = n[:-4] if n.endswith(".opt") else ""
            if len(sha) == 64 and all(c in "0123456789abcdef"
                                      for c in sha):
                try:
                    mt = os.path.getmtime(os.path.join(self.blob_dir, n))
                except OSError:
                    continue
                rows.append((mt, sha))
        rows.sort(reverse=True)
        k = hasset_prefix_len()
        return [sha[:k] for _mt, sha in rows[:hasset_max()]]

    def blob_bytes(self, sha256: str) -> bytes | None:
        """Serve a cached blob to a PEER -- the worker half of the
        swarm (``GET /v1/mesh/blob/<sha>`` routes here when this server
        is a worker).  None when the cache does not hold it (the peer
        falls back to its next source); egress is counted so the bench
        can prove who served what."""
        path = os.path.join(self.blob_dir, f"{sha256.lower()}.opt")
        try:
            with open(path, "rb") as fp:
                data = fp.read()
        except OSError:
            return None
        with self._swarm_lock:
            self.blob_serves += 1
            self.blob_egress_bytes += len(data)
        return data

    def count_fetch(self, source: str, misses: int,
                    had_peers: bool) -> None:
        """Record one multi-source fetch outcome into the swarm
        counters (cache re-use counts as nothing: no bytes moved)."""
        with self._swarm_lock:
            self.swarm_misses += misses
            if source == "cache":
                return
            if not had_peers:
                return
            if source in (self.current, self.router_addr):
                self.swarm_fallbacks += 1
            else:
                self.swarm_hits += 1

    def swarm_snapshot(self) -> dict:
        """The per-worker swarm counters /metrics renders."""
        with self._swarm_lock:
            return {"enabled": swarm_enabled(),
                    "hits": self.swarm_hits,
                    "misses": self.swarm_misses,
                    "fallbacks": self.swarm_fallbacks,
                    "blob_serves": self.blob_serves,
                    "blob_egress_bytes": self.blob_egress_bytes}

    # --- lifecycle -------------------------------------------------------
    def next_delay(self, ok: bool) -> float:
        """The loop's sleep after one beat: a jittered heartbeat period
        in steady state, the (jittered, capped) exponential backoff
        schedule while registration keeps failing."""
        if ok:
            return self.interval_s * self._rng.uniform(0.8, 1.2)
        return max(self.interval_s * 0.25, self._backoff.next_delay())

    def start(self) -> "WorkerAgent":
        def loop():
            while not self._closed:
                ok = self.beat()
                time.sleep(self.next_delay(ok))

        self._thread = threading.Thread(
            target=loop, name="hpnn-mesh-worker", daemon=True)
        self._thread.start()
        return self

    def close(self, goodbye: bool = True) -> None:
        """Stop the heartbeat loop and -- on a GRACEFUL exit -- say
        goodbye to the current router (best-effort ``{"retiring":
        true}``): the router pulls this worker out of routing
        immediately instead of discovering the death through health
        misses, the clean half of a drain-then-SIGTERM retirement
       .  ``goodbye=False`` is the abrupt path (crash
        simulation, drain=False shutdown): dying silently is the
        point, so the router's failover machinery gets exercised."""
        if self._closed:
            return
        self._closed = True
        if not goodbye:
            return
        headers = {}
        if self.app.auth_token:
            headers["Authorization"] = f"Bearer {self.app.auth_token}"
        try:
            post_json(self.current, "/v1/mesh/register",
                      {"addr": self.advertise, "retiring": True},
                      timeout_s=2.0, headers=headers)
        except TRANSPORT_ERRORS:
            pass  # the router is gone too: health misses clean up

    def info(self) -> dict:
        """What the worker's /healthz reports under ``mesh``."""
        out = {"role": "worker", "router": self.router_addr,
               "current_router": self.current,
               "advertise": self.advertise,
               "registered": self.registered}
        if self.standby is not None:
            out["standby"] = self.standby
        return out
