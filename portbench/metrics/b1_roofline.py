"""Layer: B1, the per-sample epoch kernel.  The least time the chip could
take for the window's B1 work (``roofline/b1.py``'s operations over the
f64 peak, or its bytes over the bandwidth, whichever is larger) as a share
of B1's device time in the window.  Moves ``train_iters_per_s``."""


def read(ctx):
    roof = ctx.load("roofline", "b1")
    t = ctx.kernel_s(roof.KERNEL_NAME)
    if not t:
        return None
    flops, nbytes = roof.work(ctx.config, ctx.epochs)
    return 100.0 * ctx.peaks.bound_s(flops, nbytes, ctx.dtype) / t
