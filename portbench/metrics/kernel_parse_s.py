"""Layer: configure (``api.configure``).  Seconds of the set-up's parse of
the kernel file (``io.kernel_io.load_kernel``), the program's
``kernel_parse`` span, read from its span ring
(``hpnn_tpu_torch.obs.trace.snapshot``; tracing is on from before
``configure`` in a traced run).  None when the ring does not hold the
span.  Moves ``setup_s``."""


def read(ctx):
    from hpnn_tpu_torch.obs import trace

    spans = [s for s in trace.snapshot() if s["name"] == "kernel_parse"]
    return spans[-1]["dur_s"] if spans else None
