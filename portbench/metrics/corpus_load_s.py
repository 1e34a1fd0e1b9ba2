"""Layer: the corpus (``hpnn_tpu_torch/io/corpus.py``).  Seconds of the
set-up's load of the resident corpus (``load_resident``: the pack, or
the files and the pack's write on a checkout's first run), as the
program's ``io.corpus.LAST_LOAD`` records them.  Moves ``setup_s``."""


def read(ctx):
    return ctx.last_load.get("seconds")
