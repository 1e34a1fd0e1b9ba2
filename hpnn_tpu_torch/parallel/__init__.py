"""Parallelism over the devices of one process and over
``torch.distributed`` (the port of the JAX package's ``parallel/``): the
flat update-state layout, the row-sharding padding and the (data x model)
grids (``mesh``), the load-failure agreement gate and the
snapshot barrier (``coord``), the minibatch and batched-tile epochs and
the sharded serving forward (``dp``), and the ``[model]`` row-sharded
engines (``tp``)."""

from .coord import (agree_all, any_flag, process_index, snapshot_barrier,
                    world_size)
from .dp import (batched_grads, dp_epoch, dp_eval_batch, dp_export_weights,
                 dp_resident_carry, dp_tiled_epoch, dp_train_step,
                 dp_train_step_momentum)
from .mesh import (DataMesh, Grid, LocalGrid, LocalMesh, data_mesh,
                   flatten_state, layer_sharding, make_mesh, pad_topology,
                   per_device_bytes, shard_bounds, tp_device_count,
                   unflatten_state, unpad_topology)
from .tp import (TPCarry, tp_dp_resident_carry, tp_dp_train_epoch,
                 tp_engine_carry, tp_eval_batch, tp_export_weights,
                 tp_forward, tp_forward_colsharded, tp_forward_explicit,
                 tp_overlap_enabled, tp_resident_carry, tp_run_batch,
                 tp_run_batch_colsharded, tp_train_epoch,
                 tp_train_epoch_resident, tp_train_sample)

__all__ = [
    "agree_all", "any_flag", "process_index", "snapshot_barrier",
    "world_size",
    "batched_grads", "dp_epoch", "dp_eval_batch", "dp_export_weights",
    "dp_resident_carry", "dp_tiled_epoch", "dp_train_step",
    "dp_train_step_momentum",
    "DataMesh", "Grid", "LocalGrid", "LocalMesh", "data_mesh",
    "flatten_state", "layer_sharding", "make_mesh", "pad_topology",
    "per_device_bytes", "shard_bounds", "tp_device_count",
    "unflatten_state", "unpad_topology",
    "TPCarry", "tp_dp_resident_carry", "tp_dp_train_epoch",
    "tp_engine_carry", "tp_eval_batch", "tp_export_weights", "tp_forward",
    "tp_forward_colsharded", "tp_forward_explicit", "tp_overlap_enabled",
    "tp_resident_carry", "tp_run_batch", "tp_run_batch_colsharded",
    "tp_train_epoch", "tp_train_epoch_resident", "tp_train_sample",
]
