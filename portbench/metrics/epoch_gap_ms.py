"""Layer: the epoch pipeline (``api._EpochPipeline`` under
``ckpt/trainer.py`` ``train_loop``).  Milliseconds a window epoch in which
the card was not inside an epoch's work: the window's wall less the sum
of the program's per-epoch device time (``api.EPOCH_METRICS["device_ms"]``:
CUDA events from the gather to the end of the launch), over the epochs.
Moves ``train_iters_per_s``."""


def read(ctx):
    dev = ctx.epoch_metrics.get("device_ms") or []
    if not dev or not ctx.epochs:
        return None
    return (ctx.window_s * 1e3 - sum(dev)) / len(ctx.epochs)
