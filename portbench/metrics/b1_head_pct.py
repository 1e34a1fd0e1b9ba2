"""Layer: B1, the per-sample epoch kernel (``csrc/train_epoch.cu``'s
instrumented instantiation, launched while span tracing is on).  The
share of B1's cycles that thread 0 of its blocks spent in the output head
(``head()`` with the prefetch of W_1's column), out of all four phases
(``api.EPOCH_METRICS["b1_cycles"]``, summed over the window's launches
and blocks).  Moves ``train_iters_per_s``."""


def read(ctx):
    cycles = ctx.epoch_metrics.get("b1_cycles") or {}
    total = sum(cycles.values())
    return 100.0 * cycles.get("head", 0) / total if total else None
