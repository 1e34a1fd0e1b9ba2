"""``python -m hpnn_tpu_torch {run_nn,serve_nn} [args...]``."""

from .cli import main

raise SystemExit(main())
