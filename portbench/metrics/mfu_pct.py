"""Layer: the whole training step over the window.  The operations of the
window's training (the route's kernel file under ``roofline/``, from the
window's N_ITER) over the window's wall time at the f64 peak, as a share.
Moves ``train_iters_per_s``."""


def read(ctx):
    if not ctx.epochs or ctx.device_type != "cuda":
        return None
    roof = ctx.load("roofline", ctx.traffic["kernel"])
    flops, _ = roof.work(ctx.config, ctx.epochs)
    return 100.0 * flops / (ctx.window_s * ctx.peaks.ROOF_FLOPS[ctx.dtype])
