"""One run of one cell: set-up, the measured window, the reference's
check, the metrics and the result line."""

from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from . import check, data, faults, lines, program, reference, spec, tracing

BANNED = ("jax", "jaxlib", "flax", "hpnn_tpu")


def log(msg: str) -> None:
    sys.stderr.write(f"portbench: {msg}\n")
    sys.stderr.flush()


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``hpnn_tpu_torch`` is not ``hpnn_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in BANNED)


def device_facts(torch, device) -> dict:
    """The card's name and count, and what ``nvidia-smi`` says of its
    power limit and clocks."""
    facts = {"kind": torch.cuda.get_device_name(device),
             "count": torch.cuda.device_count()}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        facts["nvidia_smi"] = out.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        facts["nvidia_smi"] = f"unavailable: {exc}"
    return facts


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader may read."""

    config: dict
    traffic: dict
    epochs: list
    window_s: float
    epoch_metrics: dict
    last_load: dict
    trace: object
    device_type: str

    peaks = None

    @property
    def dtype(self) -> str:
        return self.config["dtype"]

    @property
    def iterations(self) -> int:
        return int(sum(sum(e) for e in self.epochs))

    def load(self, kind: str, name: str):
        return spec.load_module(kind, name)

    def kernel_s(self, name_part: str):
        return None if self.trace is None else self.trace.kernel_s(name_part)


def step_orders(n: int, rows: int, seed: int) -> list[list[int]]:
    """The set-up steps' listing rows: three disjoint sets drawn from the
    seed."""
    pick = np.random.default_rng(seed).choice(n, 3 * rows, replace=False)
    return [pick[i * rows:(i + 1) * rows].tolist() for i in range(3)]


def _rows(corpus: str, names: list[str], order: list[int]):
    pairs = [data.read_sample(os.path.join(corpus, names[i])) for i in order]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))


def _report(where: str, seen: list) -> None:
    """The first mismatched rows, for the record of a run not correct."""
    for i, r, row in seen[:3]:
        log(f"mismatch {where} row {i}: program {r}; reference "
            f"init={row[0]!r} first_ok={row[1]:.0f} n_iter={row[2]:.0f} "
            f"final={row[3]!r} success={row[4]:.0f}")


def reference_check(cell, seed: int, corpus: str, names: list[str],
                    w0, orders, step_rows, step_weights, epochs,
                    boundaries, device) -> dict:
    """The compared numbers (``check.py``).  ``boundaries`` holds the
    program's weights at the window's last epoch boundaries: index e is
    before window epoch e (0-based), e + 1 after it."""
    momentum = cell.config["train"] == "BPM"
    chk = cell.check
    ref = reference.Trainer(w0, momentum, device)
    mismatch, gap, w_gap, lo = 0, 0.0, 0.0, 0
    for j, (order, w_prog) in enumerate(zip(orders, step_weights)):
        got = ref.run(*_rows(corpus, names, order)).numpy()
        seen = []
        m, g = check.row_gaps(step_rows[lo:lo + len(order)], got, seen)
        mismatch, gap, lo = mismatch + m, max(gap, g), lo + len(order)
        w_gap = max(w_gap, check.change_gap(w0, w_prog, ref.weights()))
        _report(f"set-up step {j + 1}", seen)
    mismatch += max(0, len(step_rows) - lo)
    order_errors, window_orders = check.order_errors(
        epochs, names, data.conf_seed(seed))
    k = check.replay_rows(epochs[0], int(chk["replay_first_iterations"]))
    got = ref.run(*_rows(corpus, names, window_orders[0][:k])).numpy()
    seen = []
    m, g = check.row_gaps(epochs[0][:k], got, seen)
    mismatch, gap = mismatch + m, max(gap, g)
    _report(f"window epoch 1, {k} rows replayed", seen)
    budget = int(chk["replay_epoch_iterations"])
    fit, unreplayed = check.whole_epochs(
        epochs, int(chk["replay_last_epochs"]), budget)
    epoch_w_gap = 0.0
    for e in fit:
        start, end = boundaries[e], boundaries[e + 1]
        trainer = reference.Trainer(start, momentum, device)
        got = trainer.run(*_rows(corpus, names, window_orders[e]),
                          cap=2 * budget).numpy()
        seen = []
        m, g = check.row_gaps(epochs[e], got, seen)
        mismatch, gap = mismatch + m, max(gap, g)
        epoch_w_gap = max(epoch_w_gap, check.change_gap(
            start, end, trainer.weights()))
        _report(f"window epoch {e + 1}, replayed whole", seen)
    if unreplayed:
        log(f"{unreplayed} of the window's last epochs not replayed whole: "
            f"missing, or over {budget} iterations of the program's")
    return {"order_errors": order_errors, "row_mismatch": mismatch,
            "err_gap": gap, "w_gap": w_gap, "epoch_w_gap": epoch_w_gap,
            "unreplayed": unreplayed}


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, dtype: str | None = None) -> dict:
    """One run; returns the result object (``correct`` and the rest)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device(device).type == "cuda"
    facts = device_facts(torch, torch.device(device)) if cuda else {
        "kind": "cpu", "count": 1}
    log(f"device {facts}")
    cfg = cell.config
    corpus = data.corpus_dir(cell)
    program.corpus_cache_env(cell.cache_dir)
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        w0 = data.draw_weights(cfg, seed, device)
        kpath, cpath = os.path.join(tmp, "kernel.init"), os.path.join(
            tmp, "nn.conf")
        with open(kpath, "w") as f:
            f.write(data.kernel_text(cfg, w0))
        with open(cpath, "w") as f:
            f.write(data.conf_text(cell, kpath, corpus, seed, dtype))
        logs = {k: os.path.join(tmp, f"{k}.log")
                for k in ("setup", "steps", "window")}
        capture = None
        if trace:
            from hpnn_tpu_torch.obs import trace as obs_trace

            obs_trace.enable()
            capture = tracing.Capture(os.path.join(tmp, "profile"))
        phases = {"inputs": time.perf_counter() - t_start}
        with program.stdout_to(logs["setup"]):
            prog = program.Program(cpath, device,
                                   int(cell.traffic.get("verbosity", 3)))
            phases["configure"] = time.perf_counter() - t_start
            prog.build_pipeline()
            phases["pipeline"] = time.perf_counter() - t_start
        names = data.listing(corpus)
        orders = step_orders(len(names), int(cell.check["warmup_rows"]),
                             seed)
        with program.stdout_to(logs["steps"]):
            step_weights = [prog.step(o) for o in orders]
        phases["steps"] = time.perf_counter() - t_start
        prog.warm_gather()
        prog.reset_metrics()
        last_load = prog.last_load()
        if capture is not None:
            capture.start()
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s (ends of its phases: "
            + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
            + f"); window of {seconds} s")
        with program.stdout_to(logs["window"]), (
                capture.window() if capture else contextlib.nullcontext()
        ), faults.armed():
            win = prog.window(seconds,
                              int(cell.check["replay_last_epochs"]) + 1)
        tr = capture.stop() if capture else None
        spans = obs_trace.snapshot() if trace else []
        peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
        em, counters = prog.epoch_metrics(), prog.counters()
        boundaries = {e: [w.detach().to("cpu", torch.float64).numpy()
                          for w in ws]
                      for e, ws in win["boundaries"].items()}
        prog.close()
        del prog
        step_rows = lines.read(logs["steps"])
        step_rows = step_rows[0] if step_rows else []
        epochs = lines.read(logs["window"])
        n_iter = [[r.n_iter for r in e if r is not None and r.n_iter > 0]
                  for e in epochs]
        attempted = sum(len(e) for e in epochs)
        failed = attempted - sum(len(e) for e in n_iter)
        log(f"window {win['window_s']:.3f} s, {len(epochs)} epoch(s), "
            f"{attempted} rows; the reference's check")
        t_ref = time.perf_counter()
        numbers = reference_check(cell, seed, corpus, names, w0, orders,
                                  step_rows, step_weights, epochs,
                                  boundaries, device)
        log(f"reference {time.perf_counter() - t_ref:.3f} s")
    limits = {**cfg["check"]["limits"],
              **cell.traffic.get("check", {}).get("limits", {})}
    correct, compared = check.verdict(numbers, limits)
    ctx = Context(config=cfg if dtype is None else {**cfg, "dtype": dtype},
                  traffic=cell.traffic, epochs=n_iter,
                  window_s=win["window_s"], epoch_metrics=em,
                  last_load=last_load, trace=tr,
                  device_type="cuda" if cuda else "cpu")
    ctx.peaks = spec.load_module("roofline", "peaks")
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = spec.load_module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = {"train_iters_per_s": ctx.iterations / win["window_s"],
               "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": facts["kind"],
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps(spans)}
    result["window"] = {"epochs": len(epochs), "iterations": ctx.iterations,
                        "epoch_iterations": [sum(e) for e in n_iter],
                        "first_epoch_ms": (em.get("device_ms") or [None])[0],
                        "seconds": win["window_s"], "counters": counters}
    result["check"] = compared
    return result
