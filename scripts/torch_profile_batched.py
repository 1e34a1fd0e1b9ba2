#!/usr/bin/env python3
"""Where the time of the port's batched trainers goes, on one NVIDIA GPU.

    python3 scripts/torch_profile_batched.py [--out PATH]

Two epochs at the MNIST width (784-300-10, f64, a generated kernel, the
seeded bar corpus of ``chip_smoke.py``):

* a ``[batch] 32`` BPM minibatch epoch (``parallel.dp.dp_epoch``) over
  4096 rows, 128 steps;
* a CG epoch (``train.cg.cg_epoch``, 8 iterations) over 512 rows scaled
  to [0, 1].

For each: the host time of its launches and the device span between two
CUDA events (after two warm-up epochs), then ``torch.profiler``'s table of
the operators by self host time and by self device time, and the launch
count.  Run from the root of a checkout.
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    return start.elapsed_time(end), host


def _profile(name, fn, out):
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    dev, host = _timed(fn)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    launches = sum(e.count for e in ka if e.key.startswith("cu")
                   and "Launch" in e.key)
    # the kernels' own rows (the operators' rows repeat their time)
    busy = sum(e.self_device_time_total for e in ka
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    out.write(f"{name}: device span {dev:.2f} ms, host launches "
              f"{host:.2f} ms, {launches} kernel launches, device busy "
              f"{busy:.2f} ms\n")
    out.write(ka.table(sort_by="self_cpu_time_total", row_limit=12) + "\n")
    out.write(ka.table(sort_by="self_cuda_time_total", row_limit=12) + "\n")
    out.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the report here")
    out_path = ap.parse_args(argv).out
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("no CUDA device is visible\n")
        return 1
    import chip_smoke as cs
    from hpnn_tpu_torch import runtime
    from hpnn_tpu_torch.models.kernel import generate_kernel
    from hpnn_tpu_torch.parallel import dp
    from hpnn_tpu_torch.train import cg

    runtime.pin_full_float32()
    kern, _ = generate_kernel(10958, 784, [300], 10)
    shapes = tuple(tuple(w.shape) for w in kern.weights)
    ws = [torch.as_tensor(w).cuda() for w in kern.weights]
    xs, ts, _ = cs._bar_corpus(4096, cs.MNIST, tuple(range(10)), 7)
    xb = torch.as_tensor(xs).cuda().view(128, 32, 784)
    tb = torch.as_tensor(ts).cuda().view(128, 32, 10)
    mb = torch.ones(128, 32, dtype=torch.float64, device="cuda")
    w = dp.dp_resident_carry(ws)
    xs5, ts5, _ = cs._bar_corpus(512, cs.MNIST, tuple(range(10)), 5)
    x5 = torch.as_tensor(np.round(xs5 / 255.0, 1)).cuda()
    t5 = torch.as_tensor(ts5).cuda()
    flat = torch.cat([v.reshape(-1) for v in ws])
    z = torch.zeros_like(flat)

    def cg_epoch():
        cg.cg_epoch(flat, z, z.clone(), torch.tensor(False, device="cuda"),
                    torch.tensor(0, dtype=torch.int32, device="cuda"), x5,
                    t5, "ANN", shapes, 8)

    outs = [sys.stdout]
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        outs.append(open(out_path, "w"))

    class Tee:
        def write(self, text):
            for o in outs:
                o.write(text)

        def flush(self):
            for o in outs:
                o.flush()

    tee = Tee()
    tee.write(f"{torch.cuda.get_device_name(0)}\n")
    _profile("[batch] 32 BPM epoch, MNIST f64, 4096 rows",
             lambda: dp.dp_epoch(w, xb, tb, mb, "ANN", True, 0.0005, 0.2,
                                 shapes), tee)
    _profile("CG epoch (8 iterations), MNIST f64, 512 rows", cg_epoch, tee)
    for o in outs[1:]:
        o.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
