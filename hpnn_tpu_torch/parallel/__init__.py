"""Data parallelism over ``torch.distributed`` (the port of the JAX
package's ``parallel/``, its data-parallel half): the flat update-state
layout (``mesh``), the load-failure agreement gate and the snapshot
barrier (``coord``), and the minibatch and batched-tile epochs (``dp``).
The ``[model]`` row sharding (``parallel/tp.py``) is not ported yet."""

from .coord import (agree_all, any_flag, process_index, snapshot_barrier,
                    world_size)
from .dp import (batched_grads, dp_epoch, dp_export_weights,
                 dp_resident_carry, dp_tiled_epoch, dp_train_step,
                 dp_train_step_momentum)
from .mesh import (flatten_state, per_device_bytes, shard_bounds,
                   unflatten_state)

__all__ = [
    "agree_all", "any_flag", "process_index", "snapshot_barrier",
    "world_size",
    "batched_grads", "dp_epoch", "dp_export_weights", "dp_resident_carry",
    "dp_tiled_epoch", "dp_train_step", "dp_train_step_momentum",
    "flatten_state", "per_device_bytes", "shard_bounds",
    "unflatten_state",
]
