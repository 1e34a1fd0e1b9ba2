"""The traced run's device view: the program's ``torch.profiler`` capture
(``hpnn_tpu_torch.obs.profiler``, CUDA activity) over the window, read
back from its Chrome trace, and the program's spans (``obs.trace``) that
say what the host was doing in each idle gap of the card.

The window is marked in the capture by a ``record_function`` of the
benchmark's own; its host timestamp ties the capture's clock to the
spans' wall clock."""

from __future__ import annotations

import contextlib
import json
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "portbench.window"


class Capture:
    """Start the capture (and the program's spans) before the window."""

    def __init__(self, out_dir: str):
        from hpnn_tpu_torch.obs import profiler

        self.out_dir = out_dir
        self.profiler = profiler

    def start(self) -> None:
        self.profiler.start(self.out_dir)

    @contextlib.contextmanager
    def window(self):
        import torch

        self.wall0 = time.time()
        with torch.profiler.record_function(MARK):
            yield

    def stop(self) -> "Trace":
        record = self.profiler.stop()
        with open(record["trace_file"]) as f:
            events = json.load(f).get("traceEvents", [])
        return Trace(events, self.wall0)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """Device activity inside the window, in seconds."""

    def __init__(self, events: list, wall0: float):
        marks = [e for e in events if e.get("name") == MARK
                 and e.get("ph") == "X"]
        if not marks:
            raise RuntimeError("the capture holds no window mark")
        m = marks[0]
        self.lo, self.hi = float(m["ts"]), float(m["ts"]) + float(m["dur"])
        self.offset_us = self.lo - wall0 * 1e6
        self.ops = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            a = max(self.lo, float(e["ts"]))
            b = min(self.hi, float(e["ts"]) + float(e.get("dur", 0.0)))
            if b > a:
                self.ops.append((e.get("name", "?"), a, b))

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    def busy_intervals(self):
        return _union([(a, b) for _, a, b in self.ops])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernel_s(self, name_part: str) -> float | None:
        """Device seconds of the kernels whose name holds ``name_part``,
        None when there are none."""
        ts = [b - a for n, a, b in self.ops if name_part in n]
        return sum(ts) * 1e-6 if ts else None

    def top_ops(self, k: int = 10):
        by = {}
        for n, a, b in self.ops:
            by[n] = by.get(n, 0.0) + (b - a) * 1e-6
        return sorted(([n[:160], s] for n, s in by.items()),
                      key=lambda p: -p[1])[:k]

    def idle_gaps(self, spans: list, k: int = 10):
        """The longest stretches of the window with no device activity,
        each named by the innermost program span the host was in at its
        middle ("none" outside every span)."""
        busy = self.busy_intervals()
        edges = [self.lo] + [x for iv in busy for x in iv] + [self.hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        marked = []
        for s in spans:
            a = float(s["ts"]) * 1e6 + self.offset_us
            marked.append((s["name"], a, a + float(s["dur_s"]) * 1e6))
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            mid = 0.5 * (a + b)
            inside = [(hi - lo, n) for n, lo, hi in marked if lo <= mid <= hi]
            out.append([min(inside)[1] if inside else "none",
                        (b - a) * 1e-6])
        return out
