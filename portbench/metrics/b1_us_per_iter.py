"""Layer: B1, the per-sample epoch kernel (``ops/convergence_kernel.py``
over ``csrc/train_epoch.cu``).  Microseconds of B1's device time in the
window (the profiler's kernels by name) per iteration trained (the sum
of the window's N_ITER).  Moves ``train_iters_per_s``."""


def read(ctx):
    roof = ctx.load("roofline", "b1")
    t = ctx.kernel_s(roof.KERNEL_NAME)
    n = ctx.iterations
    return t / n * 1e6 if t and n else None
