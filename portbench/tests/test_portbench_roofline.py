"""The operation and byte counts against PERF.md's kernel table."""

import pytest

from toy import spec

MNIST = {"input": 784, "hidden": [300], "output": 10, "train": "BP"}
XRD = {"input": 851, "hidden": [230], "output": 230, "train": "BPM"}


def test_portbench_b1_flops_per_iteration():
    b1 = spec.load_module("roofline", "b1")
    assert b1.flops_per_iter(MNIST) == 1_197_000
    assert b1.flops_per_iter(XRD) == 7 * 248_630 + 2 * 52_900


@pytest.mark.parametrize("cfg,bound_us", [(MNIST, 0.0179), (XRD, 0.0276)])
def test_portbench_b1_bound_per_iteration(cfg, bound_us):
    b1 = spec.load_module("roofline", "b1")
    peaks = spec.load_module("roofline", "peaks")
    flops, nbytes = b1.work(cfg, [[1]])
    assert round(flops / peaks.FP64_TENSOR_FLOPS * 1e6, 4) == bound_us
    assert peaks.bound_s(flops * 1e6, nbytes) == flops * 1e6 / 67e12
