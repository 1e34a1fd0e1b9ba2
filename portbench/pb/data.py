"""A run's inputs, made by the benchmark from the seed and the data files:
the corpus (a dataset: fixed by the configuration, written once into a
cache directory inside the checkout), the initial weights (drawn on the
device from ``--seed``, written as the conf's ``[init]`` kernel file) and
the conf itself.  The program reads the files; the plain reference takes
the same values from here and from the sample files."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np

from . import spec as pb_spec


def conf_seed(seed: int) -> int:
    """The conf's ``[seed]`` (an unsigned int; 0 would mean the clock)."""
    return int(seed) % (2**31 - 1) + 1


def corpus_dir(cell) -> str:
    """The cell's corpus directory, generated on the first call in this
    checkout (into a fixed ``.partial`` directory, renamed when whole)."""
    corpus = cell.config["corpus"]
    key = hashlib.sha1(json.dumps(corpus, sort_keys=True).encode()
                       ).hexdigest()[:12]
    root = os.path.join(cell.cache_dir, "corpora")
    final = os.path.join(root, f"{corpus['generator']}-{key}")
    if os.path.isdir(final):
        return final
    partial = final + ".partial"
    shutil.rmtree(partial, ignore_errors=True)
    os.makedirs(partial)
    pb_spec.load_module("corpora", corpus["generator"]).generate(partial,
                                                                 corpus)
    os.replace(partial, final)
    return final


def layer_shapes(config: dict) -> list[tuple[int, int]]:
    widths = [config["input"], *config["hidden"], config["output"]]
    return [(widths[i + 1], widths[i]) for i in range(len(widths) - 1)]


def draw_weights(config: dict, seed: int, device) -> list[np.ndarray]:
    """Initial weights uniform in +-1/sqrt(fan-in) (hpnn's
    ``ann_generate``), drawn in float64 by one generator on ``device`` and
    rounded as the kernel file's ``%17.15f`` text reads back."""
    import torch

    shapes = layer_shapes(config)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    total = sum(n * m for n, m in shapes)
    u = torch.rand(total, generator=gen, dtype=torch.float64,
                   device=device).cpu().numpy()
    out, lo = [], 0
    for n, m in shapes:
        w = 2.0 * (u[lo:lo + n * m] - 0.5) / np.sqrt(m)
        text = (" ".join(["%17.15f"] * w.size) % tuple(w.tolist())).split()
        out.append(np.array(text, dtype=np.float64).reshape(n, m))
        lo += n * m
    return out


def kernel_text(config: dict, weights: list[np.ndarray]) -> str:
    """The weights in hpnn's kernel file format (``ann_dump``)."""
    widths = [config["input"], *config["hidden"], config["output"]]
    parts = ["[name] portbench\n",
             "[param] " + " ".join(str(w) for w in widths) + "\n",
             f"[input] {widths[0]}\n"]
    for li, w in enumerate(weights):
        n, m = w.shape
        last = li == len(weights) - 1
        parts.append(f"[output] {n}\n" if last else f"[hidden {li + 1}] {n}\n")
        for j in range(n):
            parts.append(f"[neuron {j + 1}] {m}\n")
            parts.append(" ".join(["%17.15f"] * m) % tuple(w[j].tolist())
                         + "\n")
    return "".join(parts)


def conf_text(cell, kernel_path: str, samples: str, seed: int,
              dtype: str | None = None) -> str:
    cfg = cell.config
    lines = [f"[name] {cell.name}", f"[type] {cfg['type']}",
             f"[init] {kernel_path}", f"[seed] {conf_seed(seed)}",
             f"[input] {cfg['input']}",
             "[hidden] " + " ".join(str(h) for h in cfg["hidden"]),
             f"[output] {cfg['output']}", f"[train] {cfg['train']}",
             f"[sample_dir] {samples}", f"[dtype] {dtype or cfg['dtype']}"]
    return "\n".join(lines) + "\n"


def read_sample(path: str) -> tuple[np.ndarray, np.ndarray]:
    """One sample file as written by the corpus generators: the values of
    the line after ``[input] n`` and after ``[output] m``."""
    with open(path) as f:
        lines = f.read().split("\n")
    x = np.array(lines[1].split(), dtype=np.float64)
    t = np.array(lines[3].split(), dtype=np.float64)
    return x, t


def listing(dirpath: str) -> list[str]:
    """The sample directory in readdir order, dotfiles left out: the list
    the seeded shuffle permutes (hpnn reads it the same way)."""
    return [n for n in os.listdir(dirpath) if not n.startswith(".")]
