"""Synthetic RRUFF powder-XRD corpus in the sample format of the
reference's ``prepare_dif`` (``pdif -i 850 -o 230``): 851 inputs (the
temperature slot T/273.15, then 850 bins of 0.1 degree over 5-90 degrees
2-theta, normalised to a maximum of 1, as ``%7.5f``) and a one-hot target
of +-1.0 over all 230 space groups.

Real RRUFF files are not in the repository.  Each space group gets five
signature peaks and each mineral three of its own, over an XY spectrum
sampled every 0.1 degree with uniform noise (the repository's
``scripts/parity_xrd.py`` ``make_rruff``).  The conversion that
``hpnn_tpu_torch.tools.pdif`` applies to such a DIF and raw file pair is
frozen here as arithmetic: the raw points as their ``%.3f``/``%.4f`` text
reads back, the bin edges accumulated one interval at a time, each point
added to the first bin whose upper edge lies above it, the temperature
25 C.  ``groups`` space groups are spread evenly over 1..230.

``generate(root, spec)`` writes ``spec["groups"] * spec["per_group"]``
files ``R000000``.. into ``root``.
"""

from __future__ import annotations

import os

import numpy as np

N_BINS, N_OUT = 850, 230
MIN_THETA, MAX_THETA = 5.0, 90.0
TEMP = 25.0 + 273.15


def _grid():
    t = np.array([float(f"{v:.3f}") for v in np.arange(5.0, 90.0, 0.1)])
    interval = (MAX_THETA - MIN_THETA) / N_BINS
    hi, edges = MIN_THETA + interval, []
    for _ in range(N_BINS):
        edges.append(hi)
        hi += interval
    return t, np.array(edges)


def space_group(g: int, groups: int) -> int:
    return 1 + (g * (N_OUT - 1)) // (groups - 1) if groups > 1 else 1


def _sample_text(inputs, sg: int) -> str:
    head = " ".join(["%7.5f"] * len(inputs)) % tuple(inputs.tolist())
    out = " ".join("1.0" if k == sg - 1 else "-1.0" for k in range(N_OUT))
    return (f"[input] {N_BINS + 1}\n{head}\n[output] {N_OUT}\n{out}\n")


def generate(root: str, spec: dict) -> None:
    groups, per_group = int(spec["groups"]), int(spec["per_group"])
    rng = np.random.default_rng(int(spec["data_seed"]))
    t, edges = _grid()
    keep = t >= MIN_THETA
    slot = np.searchsorted(edges, t, side="right")
    keep &= slot < N_BINS
    k = 0
    for g in range(groups):
        sg = space_group(g, groups)
        class_peaks = [(float(rng.uniform(8, 85)),
                        float(rng.uniform(300, 900))) for _ in range(5)]
        for _ in range(per_group):
            own = [(float(rng.uniform(8, 85)), float(rng.uniform(80, 400)))
                   for _ in range(3)]
            inten = np.zeros_like(t)
            for p, i in class_peaks + own:
                inten = inten + i * np.exp(-((t - p) ** 2) / 0.05)
            inten = inten + rng.uniform(0, 3, t.size)
            raw = np.array([float(f"{v:.4f}") for v in inten])
            bins = np.zeros(N_BINS)
            np.add.at(bins, slot[keep], raw[keep])
            top = max(0.0, float(bins.max()))
            inputs = np.concatenate([[TEMP / 273.15], bins / top])
            with open(os.path.join(root, f"R{k:06d}"), "w") as f:
                f.write(_sample_text(inputs, sg))
            k += 1
