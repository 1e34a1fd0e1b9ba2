"""hpnn_tpu_torch: the PyTorch/CUDA port of hpnn_tpu, for NVIDIA Hopper.

hpnn_tpu rebuilds libhpnn (ovhpa/hpnn): small bias-free MLPs (ANN with a
sigmoid head, SNN with a softmax(x-1) head, a native LNN with a linear
head), the reference's ``.conf`` and kernel text formats and its
byte-exact stdout grammar.  This package runs the same system on PyTorch;
every kernel hpnn_tpu wrote in Pallas for the TPU becomes a kernel written
by hand for Hopper (``csrc/``).  It imports neither JAX nor hpnn_tpu.

Ported so far: ``python -m hpnn_tpu_torch.cli run_nn`` and ``serve_nn``
(every layer product in the CUDA kernel ``fused_linear_act``), and
``train_nn`` per sample (``train_epoch``), in tiles (``train_tile``), over
``--epochs N`` on a device-resident pipeline, with checkpoint bundles and
a bit-exact ``--resume`` (``ckpt/``), with the CG trainer (``train/``) and
``[batch]`` data parallelism and ``[model]`` row sharding over
``torch.distributed`` (``parallel/``), the jobs service, ``serve_nn
--jobs N``, which trains a kernel while serving it (``jobs/``), and
observability: spans, the flight recorder and span spool, ``#PROF`` and
``#DBG``, and ``torch.profiler`` captures (``obs/``).
Citations like ``src/ann.c:883`` point into the reference C library;
``hpnn_tpu/...`` into the JAX package this ports.
"""
