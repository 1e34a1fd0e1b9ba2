"""Elastic worker lifecycle: the router-side supervisor that turns the
``hpnn_serve_desired_workers`` gauge into an actuator (the port of
``hpnn_tpu/serve/mesh/autoscale.py``).

``mesh.qos.desired_workers`` converts (queued rows, measured drain rate,
live workers) into "how many workers this backlog needs";
:class:`WorkerSupervisor` closes the loop on a poll cadence:

* **scale up** -- when the clamped desired count exceeds the routable
  (live + warming) worker count, spawn ONE local ``python -m
  hpnn_tpu_torch.cli serve_nn --mesh-role worker`` subprocess pointed at
  this router, on the router's ``--device`` (the same confs the router
  serves), then wait out the cooldown before acting
  again -- one step per cooldown, so a transient spike cannot fork-bomb
  the host;
* **scale down** -- when desired drops below routable (and above
  ``min_workers``), retire the YOUNGEST supervisor-managed worker via
  drain-then-SIGTERM: the pool marks it ``retiring`` (placement skips
  it, the health loop leaves it alone -- the existing eject machinery's
  clean sibling), the supervisor waits for its in-flight batches to
  reach zero, sends SIGTERM (the worker's own graceful drain finishes
  anything admitted and says goodbye), and only escalates to SIGKILL
  after ``HPNN_AUTOSCALE_DRAIN_S``.  Zero non-200: nothing is routed to
  a retiring worker and nothing in flight is abandoned;
* **bounds + cooldown** -- ``min_workers``/``max_workers`` clamp the
  desired count; ``HPNN_AUTOSCALE_COOLDOWN_S`` spaces actions so the
  signal's own reaction to a spawn (drain rate jumps) settles before
  the next decision -- the hysteresis an actuator needs that the raw
  gauge deliberately does not provide;
* **exec hook** -- real fleets do not spawn workers with
  ``subprocess`` on the router.  ``HPNN_AUTOSCALE_EXEC=CMD`` replaces
  both actions with one shell command invoked with
  ``HPNN_AUTOSCALE_ACTION=spawn|retire`` (+ ``HPNN_AUTOSCALE_ROUTER``,
  ``HPNN_AUTOSCALE_DESIRED``, and for retires
  ``HPNN_AUTOSCALE_WORKER``) in its environment -- the k8s/slurm/etc.
  integration point; the supervisor still does the pool-side drain
  bookkeeping either way.
* **exec-hook ack** -- a hook exiting 0 proves
  the COMMAND ran, not that the fleet scaled.  Each hook action now
  awaits observable confirmation within ``HPNN_AUTOSCALE_CONFIRM_S``:
  a spawn is confirmed by a NEW worker registration, a retire by the
  victim's goodbye heartbeat (or its table entry disappearing).  An
  unconfirmed action is counted (``unconfirmed_total``), evented
  (``autoscale_unconfirmed``), undone pool-side (a stranded retiring
  victim goes back into routing) and retried after the normal
  cooldown; no second action starts while a confirmation is pending.

Every action is a ``mesh_event`` (console line / JSON / recorder span
under trace id "mesh"), and the supervisor's counters ride the
``autoscale`` section of /metrics.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

from ...utils.env import env_float
from ...utils.nn_log import nn_warn
from .events import mesh_event
from .router import STATE_LIVE, STATE_RETIRING, STATE_WARMING

_DEFAULT_POLL_S = 1.0
_DEFAULT_COOLDOWN_S = 30.0
_DEFAULT_DRAIN_S = 20.0
# a worker process's start to its bound port: PERF.md section 6 records
# a worker's start-to-registered at 8.0-12.5 s on an H100 (the torch
# import, the CUDA context and the kernel library's load); 60 s leaves
# room for a loaded host
_SPAWN_BIND_TIMEOUT_S = 60.0


class _Managed:
    """One supervisor-spawned worker subprocess."""

    __slots__ = ("proc", "addr", "port", "spawned_at")

    def __init__(self, proc, addr: str, port: int):
        self.proc = proc
        self.addr = addr
        self.port = port
        self.spawned_at = time.monotonic()


class WorkerSupervisor:
    def __init__(self, app, router_addr: str, confs: list[str],
                 min_workers: int = 1, max_workers: int = 4,
                 cooldown_s: float | None = None,
                 poll_s: float | None = None,
                 drain_s: float | None = None,
                 worker_args: tuple = (),
                 exec_hook: str | None = None,
                 spawn_fn=None,
                 extra_env: dict | None = None):
        if app.mesh_router is None:
            raise RuntimeError("the autoscale supervisor needs a mesh "
                               "router (serve_nn --mesh-role router)")
        self.app = app
        self.pool = app.mesh_router.pool
        self.router_addr = router_addr
        self.confs = list(confs)
        self.min_workers = max(0, int(min_workers))
        self.max_workers = max(self.min_workers, int(max_workers))
        self.cooldown_s = (cooldown_s if cooldown_s is not None
                           else env_float("HPNN_AUTOSCALE_COOLDOWN_S",
                                          _DEFAULT_COOLDOWN_S, lo=0.0))
        self.poll_s = (poll_s if poll_s is not None
                       else env_float("HPNN_AUTOSCALE_POLL_S",
                                      _DEFAULT_POLL_S, lo=0.05))
        self.drain_s = (drain_s if drain_s is not None
                        else env_float("HPNN_AUTOSCALE_DRAIN_S",
                                       _DEFAULT_DRAIN_S, lo=0.1))
        self.worker_args = tuple(worker_args)
        # the spawned workers compute where the router was asked to: a
        # CPU router (the tests) never spawns a CUDA worker
        self.device = app.registry.device.type
        self.exec_hook = (exec_hook if exec_hook is not None
                          else os.environ.get("HPNN_AUTOSCALE_EXEC")
                          or None)
        self._spawn_fn = spawn_fn  # test seam: replaces subprocess
        # extra environment for spawned workers (the router's auth
        # token rides here -- env, not argv, so `ps` never shows it)
        self.extra_env = dict(extra_env or {})
        self._managed: list[_Managed] = []
        self._mu = threading.Lock()
        self._last_action = 0.0  # monotonic; 0 = act immediately
        # exec-hook ack: one pending confirmation record
        # {"action", "worker", "deadline", "baseline"} -- no further
        # actions until it confirms or expires
        self.confirm_s = env_float("HPNN_AUTOSCALE_CONFIRM_S", 30.0,
                                   lo=0.1)
        self._pending_confirm: dict | None = None
        self.confirmed_total = 0
        self.unconfirmed_total = 0
        self.spawns_total = 0
        self.retires_total = 0
        self._closed = False
        self._thread: threading.Thread | None = None

    # --- lifecycle -------------------------------------------------------
    def start(self) -> "WorkerSupervisor":
        def loop():
            while not self._closed:
                time.sleep(self.poll_s)
                if self._closed:
                    return
                try:
                    self.tick()
                except Exception as exc:  # the supervisor must survive
                    # one bad tick (a dead subprocess, a racing close)
                    nn_warn(f"autoscale: tick error (loop continues): "
                            f"{type(exc).__name__}: {exc}\n")

        self._thread = threading.Thread(
            target=loop, name="hpnn-autoscale", daemon=True)
        self._thread.start()
        return self

    def close(self, retire_managed: bool = True) -> None:
        self._closed = True
        if not retire_managed:
            return
        with self._mu:
            managed = list(self._managed)
            self._managed.clear()
        for m in managed:
            self._stop_managed(m, reason="shutdown")

    # --- one decision ----------------------------------------------------
    def routable_count(self) -> int:
        """Workers that can (or are about to) take traffic: live +
        warming.  Retiring/dead workers are capacity already leaving."""
        return sum(1 for w in self.pool.workers()
                   if w.state in (STATE_LIVE, STATE_WARMING))

    def tick(self) -> str | None:
        """One control-loop step; returns "spawn"/"retire"/None (what
        it did).  Public so tests and benches can drive the loop
        deterministically."""
        self._reap()
        if not self._check_confirm():
            return None  # a hook action is still awaiting its ack
        snap = self.app.autoscale_snapshot()
        desired = max(self.min_workers,
                      min(int(snap["desired_workers"]),
                          self.max_workers))
        current = self.routable_count()
        now = time.monotonic()
        if now - self._last_action < self.cooldown_s:
            return None
        if desired > current:
            if self._spawn_one(desired):
                self._last_action = time.monotonic()
                return "spawn"
        elif desired < current and current > self.min_workers:
            if self._retire_one(desired):
                self._last_action = time.monotonic()
                return "retire"
        return None

    def _check_confirm(self) -> bool:
        """Resolve the pending exec-hook confirmation, if any.  Returns
        True when the loop is free to act (nothing pending)."""
        pending = self._pending_confirm
        if pending is None:
            return True
        addrs = {w.addr: w for w in self.pool.workers()}
        confirmed = False
        if pending["action"] == "spawn":
            # a registration we had not seen at hook time IS the ack
            confirmed = any(a not in pending["baseline"]
                            for a in addrs)
        else:
            victim = pending["worker"]
            w = addrs.get(victim)
            confirmed = w is None or w.goodbye
        if confirmed:
            self._pending_confirm = None
            self.confirmed_total += 1
            mesh_event("autoscale_confirmed",
                       f"autoscale: exec hook {pending['action']} "
                       "confirmed\n", level="dbg",
                       action=pending["action"],
                       **({"worker": pending["worker"]}
                          if pending.get("worker") else {}))
            return True
        if time.monotonic() < pending["deadline"]:
            return False  # still inside the confirmation window
        # expired unconfirmed: count, event, undo pool-side bookkeeping
        # and let the ordinary cooldown gate the retry
        self._pending_confirm = None
        self.unconfirmed_total += 1
        if pending["action"] == "retire" and pending.get("worker"):
            # the victim never left: back into routing it goes
            self.pool.unretire(pending["worker"])
        mesh_event("autoscale_unconfirmed",
                   f"autoscale: exec hook {pending['action']} "
                   f"UNCONFIRMED after {self.confirm_s:g}s; will retry "
                   "after cooldown\n", level="warn",
                   action=pending["action"], confirm_s=self.confirm_s,
                   **({"worker": pending["worker"]}
                      if pending.get("worker") else {}))
        return True

    def _reap(self) -> None:
        """Forget managed workers whose process already exited (crash,
        external kill): the pool entry goes too, so quorum math and
        the routable count stop seeing a corpse."""
        with self._mu:
            gone = [m for m in self._managed
                    if m.proc is not None and m.proc.poll() is not None]
            for m in gone:
                self._managed.remove(m)
        for m in gone:
            self.pool.remove(m.addr)
            mesh_event("autoscale_reaped",
                       f"autoscale: worker {m.addr} exited "
                       f"(rc {m.proc.returncode}); removed\n",
                       level="warn", worker=m.addr,
                       rc=m.proc.returncode)

    # --- scale up --------------------------------------------------------
    def _spawn_one(self, desired: int) -> bool:
        if self.exec_hook:
            return self._run_hook("spawn", desired=desired)
        with self._mu:
            if len(self._managed) + 1 > self.max_workers:
                return False
        try:
            if self._spawn_fn is not None:
                m = self._spawn_fn(self)
            else:
                m = self._spawn_subprocess()
        except Exception as exc:
            nn_warn(f"autoscale: spawn failed: "
                    f"{type(exc).__name__}: {exc}\n")
            return False
        if m is None:
            return False
        with self._mu:
            self._managed.append(m)
        self.spawns_total += 1
        mesh_event("autoscale_spawn",
                   f"autoscale: spawned worker {m.addr} "
                   f"(desired {desired})\n",
                   worker=m.addr, desired=desired)
        return True

    def _spawn_subprocess(self) -> _Managed | None:
        """Start one worker on THIS host -- the port's own CLI (never the
        JAX package's app) on the router's device -- and wait for its
        "SERVE: listening" line (the bound port is the advertised
        identity)."""
        # the directory that holds the hpnn_tpu_torch package
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        cmd = [sys.executable, "-u", "-m", "hpnn_tpu_torch.cli",
               "serve_nn", "-p", "0", "--mesh-role", "worker",
               "--router", self.router_addr, "--device", self.device,
               *self.worker_args, *self.confs]
        env = dict(os.environ,
                   PYTHONPATH=repo + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   **self.extra_env)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                env=env)
        port_box: list[int] = []
        ready = threading.Event()

        def drain():
            for line in proc.stdout:
                if "SERVE: listening on" in line and not port_box:
                    try:
                        port_box.append(int(line.rsplit(":", 1)[1]))
                    except ValueError:  # pragma: no cover - malformed
                        pass
                    ready.set()
            ready.set()  # EOF: the process died before binding

        threading.Thread(target=drain, daemon=True,
                         name="hpnn-autoscale-drain").start()
        if not ready.wait(_SPAWN_BIND_TIMEOUT_S) or not port_box:
            proc.kill()
            raise RuntimeError("spawned worker never bound its port")
        port = port_box[0]
        return _Managed(proc, f"127.0.0.1:{port}", port)

    # --- scale down ------------------------------------------------------
    def _retire_one(self, desired: int) -> bool:
        with self._mu:
            m = self._managed[-1] if self._managed else None
            if m is not None:
                self._managed.remove(m)
        if m is None:
            if self.exec_hook:
                victim = self._youngest_live_addr()
                if victim is None:
                    return False
                self.pool.retire(victim, via="autoscale")
                if self._run_hook("retire", desired=desired,
                                  worker=victim):
                    return True
                # the hook never retired anything: put the healthy
                # worker straight back into routing instead of
                # stranding it in the retiring state
                self.pool.unretire(victim)
                return False
            return False  # only externally-managed workers remain
        self._stop_managed(m, reason=f"desired {desired}")
        self.retires_total += 1
        return True

    def _youngest_live_addr(self) -> str | None:
        live = [w for w in self.pool.workers() if w.state == STATE_LIVE]
        if not live:
            return None
        return max(live, key=lambda w: w.created_at).addr

    def _stop_managed(self, m: _Managed, reason: str) -> None:
        """Drain-then-SIGTERM: stop routing, wait for in-flight zero,
        let the worker's own graceful shutdown finish, escalate to
        SIGKILL only past the drain budget."""
        self.pool.retire(m.addr, via="autoscale")
        deadline = time.monotonic() + self.drain_s
        while (self.pool.inflight_of(m.addr) > 0
               and time.monotonic() < deadline):
            time.sleep(0.02)
        if m.proc is not None and m.proc.poll() is None:
            try:
                m.proc.terminate()  # SIGTERM: serve_nn drains + exits 0
                m.proc.wait(timeout=self.drain_s)
            except subprocess.TimeoutExpired:
                nn_warn(f"autoscale: worker {m.addr} ignored SIGTERM "
                        f"for {self.drain_s:g}s; killing\n")
                m.proc.kill()
                try:
                    m.proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:  # pragma: no cover
                    pass
        self.pool.remove(m.addr)
        mesh_event("autoscale_retire",
                   f"autoscale: retired worker {m.addr} ({reason})\n",
                   worker=m.addr, reason=reason)

    # --- exec hook -------------------------------------------------------
    def _run_hook(self, action: str, desired: int,
                  worker: str | None = None) -> bool:
        env = dict(os.environ,
                   HPNN_AUTOSCALE_ACTION=action,
                   HPNN_AUTOSCALE_ROUTER=self.router_addr,
                   HPNN_AUTOSCALE_DESIRED=str(desired))
        if worker is not None:
            env["HPNN_AUTOSCALE_WORKER"] = worker
        # snapshot the baseline BEFORE the hook runs: a blocking hook
        # ("scale && wait-for-ready") can let the new worker register
        # while the command is still executing, and that registration
        # must count as the confirmation, not as pre-existing
        baseline = {w.addr for w in self.pool.workers()}
        try:
            rc = subprocess.call(self.exec_hook, shell=True, env=env,
                                 timeout=60.0)
        except Exception as exc:
            nn_warn(f"autoscale: exec hook failed: "
                    f"{type(exc).__name__}: {exc}\n")
            return False
        if rc != 0:
            nn_warn(f"autoscale: exec hook rc {rc} for {action}\n")
            return False
        if action == "spawn":
            self.spawns_total += 1
        else:
            self.retires_total += 1
        # the ack: rc 0 only proves the command ran; hold
        # further actions until the fleet OBSERVABLY changed (a new
        # registration / the victim's goodbye) or the window expires
        self._pending_confirm = {
            "action": action,
            "worker": worker,
            "deadline": time.monotonic() + self.confirm_s,
            "baseline": baseline,
        }
        # literal event names (not an f-string): the obs.EVENT_NAMES
        # source-scan registry keys every emitted name statically
        mesh_event("autoscale_spawn" if action == "spawn"
                   else "autoscale_retire",
                   f"autoscale: exec hook {action} "
                   f"(desired {desired}; awaiting confirmation)\n",
                   desired=desired, hook=True,
                   **({"worker": worker} if worker else {}))
        return True

    # --- observability ---------------------------------------------------
    def snapshot(self) -> dict:
        with self._mu:
            managed = len(self._managed)
        pending = self._pending_confirm
        return {"managed": managed,
                "min_workers": self.min_workers,
                "max_workers": self.max_workers,
                "cooldown_s": self.cooldown_s,
                "spawns_total": self.spawns_total,
                "retires_total": self.retires_total,
                "exec_hook": bool(self.exec_hook),
                "confirm_s": self.confirm_s,
                "confirmed_total": self.confirmed_total,
                "unconfirmed_total": self.unconfirmed_total,
                "pending_confirm": (pending["action"] if pending
                                    else None)}
