"""The serve mesh: request fan-out over worker processes (the port of
``hpnn_tpu/serve/mesh``).

A router (``serve_nn --mesh-role router``) fans whole requests over
replicated workers (``serve_nn --mesh-role worker``), and keeps their
weights coherent by broadcasting one generation with a content-addressed
blob instead of reassembling activations.  Every worker is a complete
single-process server whose batcher launches the port's kernels; the
router's batchers launch nothing on their own: their backend is the
worker RPC.

* :mod:`backend`   -- ``RemoteBackend``, the router's side of the worker
  RPC behind the batcher's backend seam (``batcher.LocalBackend`` is the
  in-process one); retry once elsewhere on worker loss, the trace id
  carried across the hop.
* :mod:`router`    -- ``WorkerPool`` (registration, health-driven
  ejection and readmission, bucket-affinity and least-depth placement)
  and ``MeshRouter`` (fleet-coherent reload, the blob and bundle store).
* :mod:`worker`    -- ``WorkerAgent``: the heartbeat, generation
  catch-up from the router's blob, and swarm blob serving.
* :mod:`qos`       -- priority lanes, deadlines, per-client token-bucket
  quotas, the SLO-driven low-lane shedder and the desired-workers
  signal (the single copy the plain server uses too).
* :mod:`fleet`     -- the router's incremental worker-trace collector
  and the metrics federation behind ``GET /metrics?fleet=1``.
* :mod:`events`    -- ``mesh_event``: lifecycle lines, ``nn_event``
  records under ``HPNN_LOG_JSON=1`` and recorder spans.
* :mod:`transport` -- the keep-alive RPC layer (pooled connections,
  stale-socket retry, backoff, verified blob fetches).
* :mod:`chaos`     -- seeded fault injection (``HPNN_FAULT``).
* :mod:`standby`   -- ``StandbyMonitor``: the passive router mirror
  (worker table, kernel generations and blobs, spill token) that takes
  over when the primary stops answering its polls.
* :mod:`autoscale` -- ``WorkerSupervisor``: the desired-workers gauge as
  an actuator that spawns and retires local port workers (drain, then
  SIGTERM), or drives the ``HPNN_AUTOSCALE_EXEC`` hook.

Everything here is stdlib and numpy; torch is touched only by the
workers' own registries.
"""

from .backend import NoLiveWorker, RemoteBackend, RemoteHTTPError
from .events import MESH_TRACE_ID, mesh_event
from .fleet import FleetObserver
from .qos import LANE_NAMES, LANES, QuotaTable, desired_workers
from .router import BlobStore, MeshRouter, WorkerPool
from .standby import StandbyMonitor
from .worker import WorkerAgent

__all__ = [
    "NoLiveWorker", "RemoteBackend", "RemoteHTTPError",
    "LANES", "LANE_NAMES", "QuotaTable", "desired_workers",
    "MeshRouter", "WorkerPool", "WorkerAgent", "BlobStore",
    "StandbyMonitor", "FleetObserver", "MESH_TRACE_ID", "mesh_event",
]
