"""Router standby: passive mirror + health-checked takeover (the port of
``hpnn_tpu/serve/mesh/standby.py``).

The mesh router was the fleet's last single point of failure: workers
re-register and catch up generations on their own, but every one
of those recovery paths converges on ONE router process.  A standby
closes that hole without any consensus machinery, by reusing exactly
the recovery machinery the fleet already has:

* ``serve_nn --mesh-role router --standby HOST:PORT`` runs the PRIMARY;
  its registration acks advertise the standby address, so every
  worker's heartbeat loop knows where to go when the primary dies.
* ``serve_nn --mesh-role standby --primary HOST:PORT`` runs the
  STANDBY: a full mesh router held PASSIVE -- infer, reload and
  registration all answer ``503 standby_passive`` -- while this
  monitor polls the primary's auth-guarded ``GET /v1/mesh/state`` and
  mirrors everything a takeover needs:

  - the **worker table** (addresses + advertised kernels) is seeded
    into the standby's own pool, whose health loop keeps the states
    honest;
  - **per-kernel generation + blob**: when the primary moves to a new
    generation, the standby pulls the content-addressed blob FROM THE
    PRIMARY, verifies its sha256, reloads its own registry at the same
    generation, and inserts the bytes into its own blob store -- so
    weight distribution survives the primary (workers can pull any
    current blob from the survivor);
  - the **spill-protection token** (only when an auth token guards the
    mirror), so ``--require-router`` workers keep accepting routed
    traffic across the takeover.

* **takeover** -- ``HPNN_MESH_TAKEOVER_AFTER`` consecutive mirror-poll
  transport failures (default 3; a reachable primary answering an
  error is NOT a death) flip the standby active: admission opens, and
  the already-mirrored worker table routes immediately.  Workers whose
  heartbeats fail against the primary back off and alternate to the
  standby (``worker.WorkerAgent``), re-registering and catching up
  generations exactly as an ejected worker always has.  Clients
  observe the documented contract: a request that fails against the
  dead primary succeeds on a SINGLE retry against the standby.

Split-brain note: takeover is one-shot and the standby never yields
back.  A revived primary must be restarted as the NEW standby of the
survivor (``--mesh-role standby --primary <survivor>``); restarting it
as a primary is an operator error this layer does not arbitrate.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time

from ...utils.env import env_float, env_int
from ...utils.nn_log import nn_dbg, nn_warn
from . import transport
from .backend import TRANSPORT_ERRORS, get_json
from .events import mesh_event


class StandbyMonitor:
    """The standby-side poll/mirror/takeover loop (see module doc).
    Owned by a ServeApp whose MeshRouter is held passive."""

    def __init__(self, app, primary_addr: str,
                 takeover_after: int | None = None,
                 poll_interval_s: float | None = None,
                 blob_dir: str | None = None):
        self.app = app
        self.router = app.mesh_router
        if self.router is None:
            raise RuntimeError("StandbyMonitor needs an enabled mesh "
                               "router (enable_mesh_router first)")
        self.primary = primary_addr
        self.takeover_after = (
            takeover_after if takeover_after is not None
            else env_int("HPNN_MESH_TAKEOVER_AFTER", 3))
        self.poll_interval_s = (
            poll_interval_s if poll_interval_s is not None
            else env_float("HPNN_MESH_STANDBY_POLL_S", 1.0))
        self.blob_dir = blob_dir \
            or os.environ.get("HPNN_MESH_BLOB_DIR") \
            or os.path.join(tempfile.gettempdir(),
                            f"hpnn-blobs-{os.getpid()}")
        # runtime re-pairing: the address THIS
        # standby answers at, advertised on every mirror poll
        # (X-HPNN-Standby) so a surviving ACTIVE router adopts a
        # freshly started standby without a restart -- its next
        # registration acks then tell every worker where the new
        # standby is.  Set by the serve CLI once the socket is bound.
        self.advertise: str | None = None
        self.passive = True
        self.misses = 0
        self.mirrors_total = 0
        self.takeovers_total = 0
        self._closed = False
        self._thread: threading.Thread | None = None

    # --- one poll --------------------------------------------------------
    def poll_once(self) -> bool:
        """Poll the primary once; returns True when it answered.  Only
        TRANSPORT failures count toward takeover -- a primary that is up
        but answering errors still owns the fleet.  A no-op once
        ACTIVE: the survivor must never re-adopt state (or a token)
        from a wrongly-revived old primary."""
        if not self.passive:
            return True
        headers = {}
        if self.app.auth_token:
            headers["Authorization"] = f"Bearer {self.app.auth_token}"
        if self.advertise:
            # announce ourselves: a surviving active router adopts this
            # standby at runtime and re-advertises the pair to workers
            headers["X-HPNN-Standby"] = self.advertise
        try:
            status, body = get_json(self.primary, "/v1/mesh/state",
                                    timeout_s=3.0, headers=headers)
        except TRANSPORT_ERRORS as exc:
            self.misses += 1
            nn_dbg(f"standby: primary {self.primary} unreachable "
                   f"({type(exc).__name__}; miss "
                   f"{self.misses}/{self.takeover_after})\n")
            if self.passive and self.misses >= self.takeover_after:
                self.activate(reason=f"{type(exc).__name__}: {exc}")
            return False
        self.misses = 0
        if status == 200 and isinstance(body, dict):
            try:
                self._mirror(body)
            except Exception as exc:  # mirroring is best-effort: one
                # malformed field must not kill the monitor loop
                nn_warn(f"standby: mirror error (loop continues): "
                        f"{type(exc).__name__}: {exc}\n")
        return True

    def _mirror(self, state: dict) -> None:
        self.mirrors_total += 1
        # worker table: seed/refresh every non-dead entry; the
        # standby's own health loop keeps the states honest from there
        workers = state.get("workers") or {}
        for addr, w in workers.items():
            if not isinstance(w, dict) or w.get("state") == "dead":
                continue
            # blobs: the primary's who-has index rides in to_dict(),
            # so a takeover keeps swarming instead of re-learning who
            # holds what one heartbeat at a time
            self.router.pool.register(str(addr), w.get("kernels"),
                                      blobs=w.get("blobs"))
        # spill-protection token: present only on an auth-guarded
        # mirror; adopting it keeps --require-router workers serving
        # routed traffic across a takeover
        token = state.get("router_token")
        if token and token != self.router.router_token:
            self.router.set_router_token(str(token))
        # kernel state: follow the primary's generation by pulling the
        # content-addressed blob FROM the primary and reloading locally
        # at the same number -- after a takeover the standby both
        # serves and *distributes* the fleet's current weights
        for name, info in (state.get("kernels") or {}).items():
            if not isinstance(info, dict):
                continue
            model = self.app.registry.get(name)
            want = info.get("generation")
            blob = info.get("blob")
            if (model is None or not isinstance(want, int)
                    or want <= model.generation
                    or not isinstance(blob, dict)):
                continue
            headers = None
            if self.app.auth_token:
                headers = {"Authorization":
                           f"Bearer {self.app.auth_token}"}
            try:
                path = transport.fetch_blob(
                    self.primary, str(blob.get("sha256")),
                    blob.get("size"), self.blob_dir, timeout_s=20.0,
                    headers=headers)
            except transport.BlobError as exc:
                nn_warn(f"standby: cannot mirror '{name}' generation "
                        f"{want}: {exc}\n")
                continue
            try:
                self.app.reload_model(name, path, set_generation=want)
            except (KeyError, ValueError) as exc:
                nn_warn(f"standby: mirror reload of '{name}' failed: "
                        f"{exc}\n")
                continue
            with open(path, "rb") as fp:
                meta = self.router.blobs.put(fp.read())
            with self.router._blob_lock:
                self.router._blob_meta[name] = (want, meta)
            mesh_event("standby_mirror",
                       f"standby: mirrored '{name}' at generation "
                       f"{want} from {self.primary}\n",
                       level="dbg", kernel=name, generation=want,
                       primary=self.primary)

    # --- takeover --------------------------------------------------------
    def activate(self, reason: str = "operator") -> None:
        """Flip this standby ACTIVE: admission opens and the mirrored
        worker table starts routing.  One-shot -- there is no yield
        back (see the split-brain note in the module doc)."""
        if not self.passive:
            return
        self.passive = False
        self.takeovers_total += 1
        mesh_event("standby_takeover",
                   f"mesh: standby taking over from {self.primary} "
                   f"({reason}); {self.router.pool.live_count()} "
                   "mirrored worker(s)\n",
                   level="warn", primary=self.primary, reason=reason,
                   workers=self.router.pool.live_count())

    # --- lifecycle -------------------------------------------------------
    def start(self) -> "StandbyMonitor":
        def loop():
            # the loop ends at takeover: an active survivor stops
            # watching the old primary for good (one-shot semantics)
            while not self._closed and self.passive:
                time.sleep(self.poll_interval_s)
                if self._closed:
                    return
                try:
                    self.poll_once()
                except Exception as exc:  # pragma: no cover - belt
                    nn_warn(f"standby: poll error (loop continues): "
                            f"{type(exc).__name__}: {exc}\n")

        self._thread = threading.Thread(
            target=loop, name="hpnn-mesh-standby", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._closed = True

    def info(self) -> dict:
        """What /healthz reports under ``mesh`` for a standby."""
        return {"role": "standby", "passive": self.passive,
                "primary": self.primary, "misses": self.misses,
                "takeover_after": self.takeover_after,
                "takeovers_total": self.takeovers_total}
