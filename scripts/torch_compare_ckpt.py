#!/usr/bin/env python3
"""Where a checkpointed ``train_nn`` run of the port spends its time on the
card: the same run with and without snapshots, the parts of a snapshot,
and a resume.

    python3 scripts/torch_compare_ckpt.py [--reps N] [--json PATH]
        [--profile-dir DIR]

On ``chip_smoke.py`` phase 9's 512 seeded MNIST files and conf (784-300-10
ANN BP f64), per sample and at ``--tile 32``, each repetition runs in this
order, every run ``train_nn -v -v --epochs 3`` on the card:

* ``off``: no checkpoints (phase 16's run);
* ``join_only``: ``--ckpt-every 1`` with the bundle writer replaced by a
  no-op, so what is left is the cost of joining the pipeline at every
  epoch (the host weights copied back, the lines rendered before the next
  epoch is queued) and the manager's bookkeeping;
* ``ckpt``: ``--ckpt-every 1`` (phase 17's first run);
* ``killed``: the same killed after epoch 1 (``HPNN_CKPT_KILL_AT_EPOCH=1``);
* ``resume``: ``--resume`` of the killed run's bundle;
* ``off_1``: ``--epochs 1`` without checkpoints (the killed run's work
  without its snapshot).

It prints each run's wall times (host clock) and their medians, profiles
one ``ckpt`` run and the resume of a fresh killed run (cProfile of the
training thread, cumulative, written under ``--profile-dir``), and times
the snapshot's host parts alone on the trained weights, five times each: ``dumps_kernel`` (the ``%17.15f`` text),
the ``state.npz`` bytes, ``write_snapshot`` whole (both, three sha256,
staged writes, read-back, fsyncs), ``publish_snapshot``, ``load_snapshot``
and ``verify_bundle``.  Prints the card's name and power limit first.
Needs one CUDA device; exits non-zero if a run fails.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from hpnn_tpu_torch import ckpt, runtime  # noqa: E402
from hpnn_tpu_torch.ckpt import manager as ckpt_manager  # noqa: E402
from hpnn_tpu_torch.ckpt import snapshot  # noqa: E402
from hpnn_tpu_torch.io.kernel_io import dumps_kernel, load_kernel  # noqa: E402


def _absolute_conf(root):
    """Phase 9's conf with absolute corpus paths (runs go to subdirs)."""
    with open(os.path.join(root, "nn.conf")) as fp:
        text = fp.read()
    text = text.replace("./samples", os.path.join(root, "samples"))
    text = text.replace("./tests", os.path.join(root, "tests"))
    conf = os.path.join(root, "abs.conf")
    with open(conf, "w") as fp:
        fp.write(text)
    return conf


def _run(cwd, argv, env=None, write=True):
    """One ``train_nn`` through ``chip_smoke._ckpt_train``; with
    ``write=False`` the manager's bundle writer only makes the dir."""
    real = ckpt_manager.CheckpointManager._write
    if not write:
        ckpt_manager.CheckpointManager._write = (
            lambda self, job: os.makedirs(self.ckpt_dir, exist_ok=True))
    try:
        return cs._ckpt_train(cwd, argv, env)
    finally:
        ckpt_manager.CheckpointManager._write = real


def _runs(root, conf, reps):
    walls = {}
    for rep in range(reps):
        for tag, extra in (("per-sample", ()),
                           (f"tile {cs.TRAIN_TILE}",
                            ("--tile", str(cs.TRAIN_TILE)))):
            d = os.path.join(root, f"r{rep}-{tag.replace(' ', '')}")
            base = ["--epochs", str(cs.EPOCHS), *extra]
            ck = ["--ckpt-every", "1", "--ckpt-dir", "ck"]
            plan = (("off", [*base, conf], None, True),
                    ("join_only", [*base, *ck, conf], None, False),
                    ("ckpt", [*base, *ck, conf], None, True),
                    ("killed", [*base, *ck, conf],
                     {"HPNN_CKPT_KILL_AT_EPOCH": str(cs.KILL_AT)}, True),
                    ("resume", [*base, "--resume", "--ckpt-dir",
                                os.path.join(d, "killed", "ck"), conf],
                     None, True),
                    ("off_1", ["--epochs", "1", *extra, conf], None, True))
            for name, argv, env, write in plan:
                r = _run(os.path.join(d, name), argv, env, write)
                walls.setdefault(f"{tag} {name}", []).append(r["wall_s"])
    return walls


def _profiles(root, conf, out_dir):
    """cProfile (the training thread only) of a per-sample ``ckpt`` run and
    of the resume of a fresh killed run."""
    texts = {}
    ck = ["--epochs", str(cs.EPOCHS), "--ckpt-every", "1", "--ckpt-dir", "ck"]
    killed = os.path.join(root, "profile-killed")
    _run(killed, [*ck, conf], {"HPNN_CKPT_KILL_AT_EPOCH": str(cs.KILL_AT)})
    for name, argv in (("ckpt", [*ck, conf]),
                       ("resume", ["--epochs", str(cs.EPOCHS), "--resume",
                                   "--ckpt-dir", os.path.join(killed, "ck"),
                                   conf])):
        prof = cProfile.Profile()
        prof.enable()
        _run(os.path.join(root, "profile-" + name), argv)
        prof.disable()
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(45)
        texts[name] = buf.getvalue()
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"ckpt_profile_{name}.txt"),
                      "w") as fp:
                fp.write(texts[name])
    return texts


def _pieces(root, times=5):
    """The snapshot's host parts alone, on the trained kernel.opt."""
    k = load_kernel(os.path.join(root, "kernel.opt"))
    ck = os.path.join(root, "pieces")
    rng = list(range(33))
    got = {n: [] for n in ("dumps_kernel", "state_npz", "write_snapshot",
                           "publish_snapshot", "load_snapshot",
                           "verify_bundle")}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        got[name].append(time.perf_counter() - t0)
        return out

    for i in range(1, times + 1):
        timed("dumps_kernel", lambda: dumps_kernel(k))
        timed("state_npz", lambda: snapshot._state_npz_bytes(
            k.weights, None, rng, i, 1))
        entry = timed("write_snapshot", lambda: snapshot.write_snapshot(
            ck, i, weights=k.weights, momentum=None, rng_state=rng, seed=1,
            errors=[0.1] * i))
        timed("publish_snapshot", lambda: snapshot.publish_snapshot(
            ck, entry, seed=1, errors=[0.1] * i))
        timed("load_snapshot", lambda: ckpt.load_snapshot(ck))
        timed("verify_bundle", lambda: ckpt.verify_bundle(
            os.path.join(ck, snapshot.snapshot_tag(i))))
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3,
                    help="repetitions of the six runs (default 3)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write every number to PATH")
    ap.add_argument("--profile-dir", metavar="DIR", default=None,
                    help="write the two cProfile tables under DIR")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("torch_compare_ckpt: no CUDA device is visible\n")
        return 1
    runtime.pin_full_float32()
    card = cs.phase_device()
    cs.phase_build()
    with tempfile.TemporaryDirectory(prefix="hpnn_ckpt_cmp_") as tmp:
        e2e = cs.phase_train_nn(tmp)
        conf = _absolute_conf(e2e["root"])
        walls = _runs(e2e["root"], conf, args.reps)
        profiles = _profiles(e2e["root"], conf, args.profile_dir)
        pieces = _pieces(e2e["root"])
    median = {k: statistics.median(v) for k, v in walls.items()}
    piece_median = {k: statistics.median(v) for k, v in pieces.items()}
    for k, v in walls.items():
        cs.log(f"{k}: wall " + ", ".join(f"{x:.3f}" for x in v)
               + f" s (median {median[k]:.3f})")
    for k, v in pieces.items():
        cs.log(f"{k}: " + ", ".join(f"{x * 1e3:.1f}" for x in v)
               + f" ms (median {piece_median[k] * 1e3:.1f})")
    for name, text in profiles.items():
        cs.log(f"--- cProfile of the {name} run (cumulative) ---")
        cs.log("\n".join(text.splitlines()[:40]))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fp:
            json.dump({"card": card, "walls_s": walls, "median_s": median,
                       "pieces_s": pieces, "pieces_median_s": piece_median},
                      fp, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
