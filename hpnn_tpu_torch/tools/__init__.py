"""Data-preparation tools of the port (host code, no torch): ``pmnist``
(MNIST idx -> samples) and ``pdif`` (RRUFF DIF/XY -> XRD samples), the
port's own copies of the JAX package's rebuilds of the reference
converters (``tutorials/mnist/prepare_mnist.c`` and
``tutorials/ann/{prepare_dif.c,file_dif.c}``).

    python -m hpnn_tpu_torch.tools.pmnist [--reference-quirks] SAMPLES TESTS
    python -m hpnn_tpu_torch.tools.pdif ...
"""
