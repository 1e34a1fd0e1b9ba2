"""Layer: the join (``api._EpochPipeline.join``, at ``train_loop``'s
join points: the window's end here).  Host seconds of rendering and
writing the window's training lines, summed over its epochs
(``api.EPOCH_METRICS["render_s"]``, the ``epoch_render`` spans' time).
Moves ``train_iters_per_s``."""


def read(ctx):
    return ctx.epoch_metrics.get("render_s") or None
