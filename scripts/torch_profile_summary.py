#!/usr/bin/env python3
"""Summarise a ``torch.profiler`` Chrome trace of the port.

    python3 scripts/torch_profile_summary.py TRACE.pt.trace.json [...]

A trace written by ``train_nn``/``run_nn --profile-dir`` or ``POST
/v1/debug/profile`` (``hpnn_tpu_torch/obs/profiler.py``) holds device
kernels (category ``kernel``), the CUDA runtime calls that launched them
(``cuda_runtime``) and torch's operators on the profiling thread
(``cpu_op``).  This prints, for each file: the events by category; each
kernel name (template arguments cut) with its count and its total,
smallest and largest duration in microseconds; the runtime calls by name
with their count and mean duration; and how many kernels carry a
correlation id linking them to their launch.  It reads the file only.
"""

from __future__ import annotations

import collections
import json
import re
import sys


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces and template
    arguments: ``void (anonymous namespace)::simt_kernel<...>(...)`` ->
    ``simt_kernel``."""
    head = name.split("(", 1)[0] if not name.startswith("void (") else \
        name[len("void "):]
    head = re.sub(r"\(anonymous namespace\)::", "", head)
    head = head.split("<", 1)[0].split("(", 1)[0]
    return head.rsplit("::", 1)[-1].replace("void ", "").strip()


def summarise(path: str) -> dict:
    with open(path) as fp:
        events = json.load(fp)["traceEvents"]
    cats = collections.Counter(e.get("cat") for e in events)
    kernels: dict = {}
    runtime: dict = {}
    linked = 0
    for e in events:
        cat = e.get("cat")
        if cat == "kernel" and e.get("ph") == "X":
            k = kernels.setdefault(_short(e["name"]), [])
            k.append(float(e.get("dur", 0.0)))
            linked += "correlation" in e.get("args", {})
        elif cat == "cuda_runtime" and e.get("ph") == "X":
            runtime.setdefault(e["name"], []).append(float(e.get("dur", 0.0)))
    return {"file": path,
            "categories": {str(k): v for k, v in sorted(
                cats.items(), key=lambda kv: str(kv[0]))},
            "kernels": {n: {"count": len(d), "total_us": round(sum(d), 3),
                            "min_us": round(min(d), 3),
                            "max_us": round(max(d), 3)}
                        for n, d in sorted(kernels.items())},
            "runtime": {n: {"count": len(d),
                            "mean_us": round(sum(d) / len(d), 3)}
                        for n, d in sorted(runtime.items())},
            "kernels_linked_to_launch": linked}


def main(argv=None) -> int:
    paths = sys.argv[1:] if argv is None else argv
    if not paths:
        sys.stderr.write(__doc__.split("\n\n")[1] + "\n")
        return 2
    for p in paths:
        print(json.dumps(summarise(p), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
