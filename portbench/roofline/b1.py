"""Operations and bytes of B1, the per-sample epoch kernel
(``hpnn_tpu_torch/csrc/train_epoch.cu``): one iteration of one sample
(forward, deltas, update, fresh forward) is 5P + 2P_hidden flops under BP
and 7P + 2P_hidden under BPM, P the weights, P_hidden those of the layers
after the first (784-300-10 BP: 1,197,000 flops).  Bytes once an epoch:
its rows read, the weights read and written, a stats row of five float64
written a sample."""

KERNEL_NAME = "train_epoch_kernel"


def _sizes(config):
    widths = [config["input"], *config["hidden"], config["output"]]
    layers = [widths[i] * widths[i + 1] for i in range(len(widths) - 1)]
    return sum(layers), sum(layers[1:]), widths[0] + widths[-1]


def flops_per_iter(config) -> int:
    p, p_hidden, _ = _sizes(config)
    return (7 if config["train"] == "BPM" else 5) * p + 2 * p_hidden


def work(config, epochs) -> tuple[float, float]:
    """(flops, bytes) of the epochs, each a list of its rows' N_ITER."""
    p, _, row = _sizes(config)
    flops = float(sum(sum(e) for e in epochs)) * flops_per_iter(config)
    nbytes = sum(8.0 * (len(e) * (row + 5) + 2 * p) for e in epochs)
    return flops, nbytes
