"""The port's serving path: registry, micro-batcher and HTTP front-end
(``python -m hpnn_tpu_torch.cli serve_nn``)."""

from .batcher import DeadlineExceeded, MicroBatcher, QueueFull, ServeClosed
from .metrics import ServeMetrics
from .registry import ModelRegistry, ServedModel, bucket_rows
from .server import ServeApp, make_server, serve_in_thread

__all__ = [
    "DeadlineExceeded", "MicroBatcher", "QueueFull", "ServeClosed",
    "ServeMetrics", "ModelRegistry", "ServedModel", "bucket_rows",
    "ServeApp", "make_server", "serve_in_thread",
]
