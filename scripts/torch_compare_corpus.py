#!/usr/bin/env python3
"""What the corpus pipeline saves the port's ``run_nn`` and ``--resume`` on
the card: the same runs with the cache off, cold and warm.

    python3 scripts/torch_compare_corpus.py [--reps N] [--fresh N]
        [--json PATH]

Load modes (``chip_smoke.CORPUS_MODES``): ``off`` is the cache off, serial
reads and the Python parser (``HPNN_NO_CORPUS_CACHE=1 HPNN_NO_PARALLEL_IO=1
HPNN_NO_NATIVE_IO=1``); ``cold`` reads every file in parallel through the
native parser and writes the pack (the pack is removed before each cold
run); ``warm`` loads from the pack.  The sample files are in the page
cache in every mode.  Each repetition runs, in this order:

* ``run_nn -v -v`` in this process of a generated MNIST 784-300-10 ANN f64
  and XRD 851-230-230 ANN f32 kernel on 4096 seeded files each (phase 4's
  corpora), off, cold, warm: host wall time and the load's own time;
* with ``--fresh N`` (default 3), MNIST ``run_nn -v -v -v`` as a fresh
  ``python -m hpnn_tpu_torch.cli`` process, off, cold, warm: the process's
  wall time (interpreter, torch import, CUDA context and library loads
  included) and the load time its dbg line reports;
* ``train_nn -v -v --epochs 3 --ckpt-every 1`` on phase 9's 512 files and
  conf, the same killed after epoch 1, and its ``--resume``, with the
  cache off and then warm: wall times, the resume's over the whole run's.

Last, one more warm MNIST ``run_nn`` in this process under cProfile (the
largest cumulative entries: where the wall time that is not the load
goes).  Prints the card's name and power limit first, each run's numbers
and their medians.  Needs one CUDA device; exits non-zero if a run fails.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import io
import json
import os
import pstats
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from hpnn_tpu_torch import cli, runtime  # noqa: E402
from hpnn_tpu_torch.io import corpus  # noqa: E402
from hpnn_tpu_torch.io.kernel_io import dump_kernel_to_path  # noqa: E402
from hpnn_tpu_torch.models.kernel import generate_kernel  # noqa: E402

LOAD_LINE = re.compile(r"NN\(DBG\): load: \d+ file\(s\), \d+ row\(s\) in "
                       r"([0-9.]+)s \((\w+); native_io: (\w+)\)")


def _setup(tmp):
    """Phase 4's two corpora and a kernel and conf for each."""
    confs = {}
    for tag, (n_in, hid, n_out), scale, seed, dtype in (
            ("mnist", cs.MNIST, "pixel", 10958, "f64"),
            ("xrd", cs.XRD, "unit", 851, "f32")):
        tests = os.path.join(tmp, f"{tag}_tests")
        cs._write_corpus(tests, n_in, n_out, scale, seed)
        kern, _ = generate_kernel(seed, n_in, hid, n_out)
        kpath = os.path.join(tmp, f"{tag}_kernel.opt")
        dump_kernel_to_path(kern, kpath)
        conf = os.path.join(tmp, f"{tag}.conf")
        with open(conf, "w") as fp:
            fp.write(f"[name] {tag}\n[type] ANN\n[init] {kpath}\n"
                     f"[seed] 10958\n[input] {n_in}\n"
                     f"[hidden] {' '.join(map(str, hid))}\n[output] {n_out}\n"
                     f"[train] BP\n[test_dir] {tests}\n[dtype] {dtype}\n")
        confs[tag] = (conf, tests)
    return confs


def _drop_pack(dirpath):
    for suffix in ("", ".lock"):
        with contextlib.suppress(FileNotFoundError):
            os.unlink(corpus.pack_path(dirpath) + suffix)


def _run_nn(conf, tests, mode, env, want):
    if mode == "cold":
        _drop_pack(tests)
    with cs._corpus_env(env):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc, outs = cli.run_nn(["-v", "-v", "--device", "cuda", conf])
        wall = time.perf_counter() - t0
    load = dict(corpus.LAST_LOAD)
    if rc != 0 or outs is None or load["mode"] != want:
        raise AssertionError(f"run_nn {conf} ({mode}): rc={rc}, load {load}")
    return {"wall_s": wall, "load_s": load["seconds"], "text": out.getvalue()}


def _fresh(conf, tests, mode, env, want):
    if mode == "cold":
        _drop_pack(tests)
    full = dict(os.environ, PYTHONPATH=ROOT, **env)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "hpnn_tpu_torch.cli",
                          "run_nn", "-v", "-v", "-v", conf], env=full,
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    m = LOAD_LINE.search(res.stdout)
    if res.returncode != 0 or m is None or m.group(2) != want:
        raise AssertionError(f"fresh run_nn {conf} ({mode}): rc="
                             f"{res.returncode}\n{res.stderr[-2000:]}")
    return {"wall_s": wall, "load_s": float(m.group(1))}


def _resume(root, conf, mode, env, rep):
    """A checkpointed run, the same killed after epoch 1 and its resume."""
    d = os.path.join(root, f"resume-{mode}-{rep}")
    base = ["--epochs", str(cs.EPOCHS), "--ckpt-every", "1"]
    walls = {}
    with cs._corpus_env(env):
        for name, argv, kill in (
                ("ckpt", [*base, "--ckpt-dir", "ck", conf], None),
                ("killed", [*base, "--ckpt-dir", "ck", conf],
                 {"HPNN_CKPT_KILL_AT_EPOCH": str(cs.KILL_AT)}),
                ("resume", ["--epochs", str(cs.EPOCHS), "--resume",
                            "--ckpt-dir", os.path.join(d, "killed", "ck"),
                            conf], None)):
            r = cs._ckpt_train(os.path.join(d, name), argv, kill)
            walls[name] = r["wall_s"]
            walls[f"{name}_load_mode"] = corpus.LAST_LOAD["mode"]
    return walls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3,
                    help="repetitions of the in-process runs (default 3)")
    ap.add_argument("--fresh", type=int, default=3,
                    help="repetitions of the fresh-process runs (default 3)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write every number to PATH")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("torch_compare_corpus: no CUDA device is visible\n")
        return 1
    runtime.pin_full_float32()
    card = cs.phase_device()
    cs.phase_build()
    times: dict[str, list] = {}
    with tempfile.TemporaryDirectory(prefix="hpnn_corpus_cmp_") as tmp:
        confs = _setup(tmp)
        e2e = cs.phase_train_nn(tmp)
        conf9 = os.path.join(e2e["root"], "abs.conf")
        with open(os.path.join(e2e["root"], "nn.conf")) as fp:
            text = fp.read()
        with open(conf9, "w") as fp:
            fp.write(text.replace("./", e2e["root"] + "/"))
        for rep in range(args.reps):
            for tag, (conf, tests) in confs.items():
                texts = set()
                for mode, env, want, _native in cs.CORPUS_MODES:
                    r = _run_nn(conf, tests, mode, env, want)
                    texts.add(r["text"])
                    for k in ("wall_s", "load_s"):
                        times.setdefault(f"run_nn {tag} {mode} {k}",
                                         []).append(r[k])
                if len(texts) != 1:
                    raise AssertionError(f"run_nn {tag}: the streams differ "
                                         "between load modes")
            for mode, env, _want, _native in (cs.CORPUS_MODES[0],
                                              cs.CORPUS_MODES[2]):
                r = _resume(e2e["root"], conf9, mode, env, rep)
                for k, v in r.items():
                    times.setdefault(f"train_nn {mode} {k}", []).append(v)
        conf, tests = confs["mnist"]
        prof = cProfile.Profile()
        prof.enable()
        _run_nn(conf, tests, "warm", {}, "pack")
        prof.disable()
        table = io.StringIO()
        pstats.Stats(prof, stream=table).sort_stats("cumulative") \
            .print_stats(30)
        for _rep in range(args.fresh):
            for mode, env, want, _native in cs.CORPUS_MODES:
                r = _fresh(conf, tests, mode, env, want)
                for k in ("wall_s", "load_s"):
                    times.setdefault(f"fresh run_nn mnist {mode} {k}",
                                     []).append(r[k])
    median = {k: statistics.median(v) for k, v in times.items()
              if not isinstance(v[0], str)}
    for k, v in times.items():
        if k in median:
            cs.log(f"{k}: " + ", ".join(f"{x:.3f}" for x in v)
                   + f" (median {median[k]:.3f})")
        else:
            cs.log(f"{k}: {', '.join(v)}")
    for mode in ("off", "warm"):
        ratio = (median[f"train_nn {mode} resume"]
                 / median[f"train_nn {mode} ckpt"])
        cs.log(f"resume over the checkpointed run ({mode}): {ratio:.3f}")
    cs.log("--- cProfile of a warm MNIST run_nn (cumulative) ---")
    cs.log("\n".join(table.getvalue().splitlines()[:45]))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fp:
            json.dump({"card": card, "times": times, "median": median}, fp,
                      indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
