"""Layer: the epoch pipeline (``api._EpochPipeline``).  Microseconds on
the card from one window epoch's end (the event after its launch) to the
next epoch's start (the event before its upload), between epochs queued
with no join between them, averaged over the window's boundaries
(``api.EPOCH_METRICS["boundary_ms"]``, CUDA events read at the join).
Moves ``train_iters_per_s``."""


def read(ctx):
    gaps = ctx.epoch_metrics.get("boundary_ms") or []
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
