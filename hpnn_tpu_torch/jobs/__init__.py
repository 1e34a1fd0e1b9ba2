"""Online training service: train a kernel while serving it (the port of
``hpnn_tpu/jobs``).

``POST /v1/kernels/<name>/train`` submits a training job into a bounded
queue; scheduler workers train it through ``api.train_job`` (the
``train_nn`` checkpoint path) on a device slice, yield the device to the
micro-batching eval queue at every epoch boundary, hot-reload each
epoch's snapshot into the serving registry (with A/B generation pinning),
and persist job state through ``io/atomic.py`` so a restarted server
reports its whole history.

* :mod:`state`     -- persistent :class:`JobState` records and the
  directory-backed :class:`JobStore` (crash recovery to ``interrupted``);
* :mod:`queue`     -- the bounded FIFO :class:`JobQueue`
  (:class:`JobQueueFull` -> HTTP 429);
* :mod:`placement` -- the best-fit, strict-FIFO :class:`SliceManager`;
* :mod:`scheduler` -- the :class:`JobScheduler` workers: epoch-boundary
  snapshot/reload/yield, cancel and drain, chunked uploads, lease-based
  auto-resume and eval-driven auto-promotion.
"""

from .queue import JobQueue, JobQueueFull
from .scheduler import JobScheduler
from .state import (
    ACTIVE_STATES,
    JOB_STATES,
    TERMINAL_STATES,
    JobError,
    JobState,
    JobStore,
)

__all__ = [
    "ACTIVE_STATES", "JOB_STATES", "TERMINAL_STATES",
    "JobError", "JobQueue", "JobQueueFull", "JobScheduler",
    "JobState", "JobStore",
]
