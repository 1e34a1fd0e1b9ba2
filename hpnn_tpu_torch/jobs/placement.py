"""Device-slice placement for concurrent training jobs (the port of
``hpnn_tpu/jobs/placement.py``).

One serve process owns one device list: every card it sees when it serves
on the GPU, the one CPU device under ``--device cpu`` (tests pass explicit
lists).  K scheduler workers run K jobs at once, each pinned to a disjoint
contiguous slice of that list:

* :class:`SliceManager` owns the list and a free/busy bitmap.  ``acquire``
  carves a best-fit contiguous run (the smallest free run that fits,
  lowest index on ties), which keeps large runs whole for large asks.
* Grants are strict FIFO: a request is granted only when it is the oldest
  pending one, so a whole-list ask parks at the head and drains the list
  instead of starving behind later small asks.
* Slices are reclaimed by the owning worker's ``release`` on every
  terminal path, by ``reclaim`` (the scheduler tick's sweep that frees a
  slice whose owner is no longer running) and by ``close`` (drain).

The slice a job gets determines its training mesh, as in the JAX
package: ``api.train_job(..., devices=slice.devices)`` pins the job's
thread to it, and its conf's ``[batch]``/``[model]`` shard over the
slice's devices (a k-device grid; its first device holds everything
unsharded).  ``dp``/``tp`` on a placement are bookkeeping for operators
(/v1/jobs, /metrics): the conf, not the ask, splits the grid.
"""

from __future__ import annotations

import threading
import time


def process_devices(device) -> list:
    """The device list a serve process on ``device`` places jobs over:
    every visible card for a CUDA device, else the one CPU device."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def plan_request(params: dict, n_devices: int) -> tuple[int, int]:
    """(slice_size, tp_width) asked for by a job's params.

    ``dp_devices`` * ``tp_devices`` (``model_parallel`` stands in for the
    TP width when ``tp_devices`` is absent).  Size 0 means no declaration:
    the manager hands out its fair default share.  Over-asks clamp to the
    device list.
    """
    dp = int(params.get("dp_devices") or 0)
    tp = int(params.get("tp_devices") or params.get("model_parallel") or 0)
    if dp <= 0 and tp <= 0:
        return 0, 1
    tp = max(1, tp)
    size = max(1, dp) * tp
    if size > n_devices:
        size = n_devices
    if tp > size:
        tp = size
    return size, tp


def _device_id(dev, position: int) -> int:
    """A device's id in a placement record: a card's index, else its
    position in the list (the CPU device, or the integers tests use)."""
    index = getattr(dev, "index", None)
    return index if isinstance(index, int) else position


class SlicePlacement:
    """One granted slice: the contiguous device run a job is pinned to."""

    __slots__ = ("job_id", "devices", "start", "size", "dp", "tp")

    def __init__(self, job_id: str, devices: list, start: int,
                 size: int, tp: int = 1):
        self.job_id = job_id
        self.devices = list(devices)
        self.start = start
        self.size = size
        self.tp = max(1, min(tp, size))
        self.dp = max(1, size // self.tp)

    def describe(self) -> dict:
        """JSON-safe record carried on the job (/v1/jobs, events)."""
        return {"devices": [_device_id(d, i + self.start)
                            for i, d in enumerate(self.devices)],
                "dp": self.dp, "tp": self.tp, "size": self.size}


class SliceManager:
    """Best-fit contiguous slice allocator with strict-FIFO granting."""

    def __init__(self, devices, workers: int = 1):
        self.devices = list(devices)
        self.n = len(self.devices)
        self.workers = max(1, int(workers))
        self._free = [True] * self.n
        self._owners: dict[str, SlicePlacement] = {}
        self._pending: list[dict] = []
        self._cv = threading.Condition()
        self._closed = False

    # -- sizing --------------------------------------------------------

    def default_share(self) -> int:
        """Fair share for an undeclared job: the list split evenly over
        the worker pool."""
        return max(1, self.n // self.workers)

    # -- allocation ----------------------------------------------------

    def _best_fit(self, size: int) -> int | None:
        """Start index of the smallest free contiguous run >= size."""
        best = None
        best_len = None
        i = 0
        while i < self.n:
            if not self._free[i]:
                i += 1
                continue
            j = i
            while j < self.n and self._free[j]:
                j += 1
            run = j - i
            if run >= size and (best_len is None or run < best_len):
                best, best_len = i, run
            i = j
        return best

    def try_acquire(self, job_id: str, size: int = 0,
                    tp: int = 1) -> SlicePlacement | None:
        """Non-blocking acquire; still queues behind older waiters
        (returns None rather than leapfrog the FIFO)."""
        with self._cv:
            if self._closed or job_id in self._owners:
                return None
            if self._pending:
                return None
            return self._grant(job_id, size, tp)

    def acquire(self, job_id: str, size: int = 0, tp: int = 1,
                stop: threading.Event | None = None,
                timeout_s: float | None = None) -> SlicePlacement | None:
        """Block until this request is the oldest pending one and a
        best-fit run is free; None on stop, close or timeout."""
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        ticket = {"job_id": job_id}
        with self._cv:
            if self._closed or job_id in self._owners:
                return None
            self._pending.append(ticket)
            try:
                while True:
                    if self._closed:
                        return None
                    if stop is not None and stop.is_set():
                        return None
                    if self._pending[0] is ticket:
                        placed = self._grant(job_id, size, tp)
                        if placed is not None:
                            return placed
                    # the grant is tried before the deadline check, so
                    # timeout_s=0.0 means exactly one non-blocking try
                    if deadline is not None \
                            and time.monotonic() >= deadline:
                        return None
                    self._cv.wait(0.05)
            finally:
                if ticket in self._pending:
                    self._pending.remove(ticket)
                self._cv.notify_all()

    def _grant(self, job_id: str, size: int, tp: int):
        size = max(1, min(int(size) or self.default_share(), self.n))
        start = self._best_fit(size)
        if start is None:
            return None
        for i in range(start, start + size):
            self._free[i] = False
        placed = SlicePlacement(job_id, self.devices[start:start + size],
                                start, size, tp=tp)
        self._owners[job_id] = placed
        return placed

    # -- reclamation ---------------------------------------------------

    def release(self, job_id: str) -> bool:
        with self._cv:
            placed = self._owners.pop(job_id, None)
            if placed is None:
                return False
            for i in range(placed.start, placed.start + placed.size):
                self._free[i] = True
            self._cv.notify_all()
            return True

    def reclaim(self, live) -> list[str]:
        """Free every slice whose owner ``live(job_id)`` disowns (the
        scheduler tick's sweep: a slice whose owner died without releasing
        frees within one tick instead of blocking the queue)."""
        with self._cv:
            dead = [j for j in self._owners if not live(j)]
        for j in dead:
            self.release(j)
        return dead

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    # -- visibility ----------------------------------------------------

    def occupancy(self) -> dict:
        """Snapshot for /healthz and /metrics."""
        with self._cv:
            in_use = sum(1 for f in self._free if not f)
            return {
                "devices_total": self.n,
                "devices_in_use": in_use,
                "slices_active": len(self._owners),
                "queued_placements": len(self._pending),
                "slices": {j: p.describe()
                           for j, p in self._owners.items()},
            }
