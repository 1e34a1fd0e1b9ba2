"""The port's serving path: registry (generations, hot reload, A/B
pinning), micro-batcher (QoS lanes with EDF, pipelined dispatch), metrics
and the HTTP front-end (``python -m hpnn_tpu_torch.cli serve_nn``)."""

from .batcher import (DeadlineExceeded, LocalBackend, MicroBatcher,
                      QueueFull, ServeClosed)
from .metrics import PHASES, LatencyHistogram, ServeMetrics
from .registry import ModelRegistry, ServedModel, bucket_rows
from .server import ServeApp, make_server, serve_in_thread

__all__ = [
    "DeadlineExceeded", "LocalBackend", "MicroBatcher", "QueueFull",
    "ServeClosed", "PHASES", "LatencyHistogram", "ServeMetrics",
    "ModelRegistry", "ServedModel", "bucket_rows",
    "ServeApp", "make_server", "serve_in_thread",
]
