"""A toy corpus for the benchmark's own CPU tests: ``samples`` points of
``width`` inputs in [0, ``scale``] around one centre a class, one-hot +-1.0
targets over ``classes`` outputs, in the reference's sample format.  Small
networks train on it in a few hundred iterations a sample, so a whole run
of the harness fits a test."""

from __future__ import annotations

import os

import numpy as np


def generate(root: str, spec: dict) -> None:
    rng = np.random.default_rng(int(spec["data_seed"]))
    width, classes = int(spec["width"]), int(spec["classes"])
    centres = rng.uniform(0.0, 1.0, (classes, width))
    for k in range(int(spec["samples"])):
        c = k % classes
        x = np.clip(centres[c] + rng.normal(0.0, 0.05, width), 0.0, 1.0)
        x = x * float(spec.get("scale", 1.0))
        t = -np.ones(classes)
        t[c] = 1.0
        with open(os.path.join(root, f"t{k:04d}.txt"), "w") as f:
            f.write(f"[input] {width}\n"
                    + " ".join(["%7.5f"] * width) % tuple(x.tolist())
                    + f"\n[output] {classes}\n"
                    + " ".join(["%.1f"] * classes) % tuple(t.tolist())
                    + "\n")
