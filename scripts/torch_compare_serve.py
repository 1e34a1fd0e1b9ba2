#!/usr/bin/env python3
"""Serve latency of the port's ``serve_nn`` at fixed offered loads.

    python3 scripts/torch_compare_serve.py [--json PATH] [--previous DIR]
        [--seconds 10] [--reps 3] [--clients 1,8,32] [--rows 1,64]
        [--mesh 4] [--parity-only]

Starts ``python -m hpnn_tpu_torch.cli serve_nn`` as its own process on the
card (``-b 64``, strict tier, every bucket warmed first) with a generated
MNIST 784-300-10 ANN float64 kernel (seed 10958), and drives it from this
process with closed-loop clients: each client thread keeps one keep-alive
connection and sends its next request as soon as the last one answered.
Every cell (1, 8 and 32 clients of 1- and 64-row requests) runs for
``--seconds``; one more cell runs 8 clients of each row count with a
``POST /v1/kernels/mnist/reload`` of the same kernel file every second.

For every cell it reports the client-side p50/p99 (the request's wall as
the client sees it: HTTP, JSON, queue and device), the requests a second,
the rows a batch, and from the server's ``/metrics?format=json`` (the
difference of the snapshots taken before and after the cell) the
server-side request p50/p99, each phase's p50 and the batch fill (the
mean over batches of rows / bucket).  Each cell's numbers are medians
over ``--reps`` repetitions; each repetition starts a fresh server.

Each repetition also times the registry alone in a fresh process of
each tree: the median wall of 2000 synchronous ``ModelRegistry.forward``
calls of 1 and 64 rows (pad, copy in, the two launches, copy out, no
HTTP, no batcher): the host cost of one batch.

The tier table (this tree only, in this process; the counterpart of the
JAX package's ``scripts/serve_bench.py`` ``compare_parity``): the same
kernel at f64, f32 and bf16 in a ``strict`` registry, a ``fast`` one
and a ``fast@meshN`` one (``--mesh N`` shards: distinct cards where the
host has N, else the one card repeated N times), each bucket of 64 and
256 rows timed as one synchronous registry call (pad, copy in, the
forward, copy out) after a warm pass, the median of 50 calls, with
rows a second, the speedup over ``strict``, the
largest difference from the strict answer and whether the sharded answer
is bit-identical to the ``fast`` one.  ``--parity-only`` runs just it.

``--previous DIR`` (repeatable) runs the same table against another
checkout's ``hpnn_tpu_torch`` (for example ``git archive`` of an earlier
commit unpacked into DIR); the repetitions rotate the order of the
trees.  A
tree whose server has no reload endpoint or no phase histograms reports
those columns as null.  The card's ``nvidia-smi`` name and power limit
lead the output.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST = (784, [300], 10)
POOL = 1024              # distinct input rows
BODIES = 16              # pre-encoded request bodies per row count
TOKEN = "T"
PARITY_BUCKETS = (64, 256)          # the tier table's buckets
PARITY_DTYPES = ("f64", "f32", "bf16")
PARITY_REPS = 50                    # synchronous calls a cell


def log(msg: str) -> None:
    print(msg, flush=True)


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not measured (no nvidia-smi)"


def _setup(tmp: str) -> str:
    sys.path.insert(0, ROOT)
    from hpnn_tpu_torch.io.kernel_io import dump_kernel_to_path
    from hpnn_tpu_torch.models.kernel import generate_kernel

    n_in, hid, n_out = MNIST
    kpath = os.path.join(tmp, "kernel.opt")
    dump_kernel_to_path(generate_kernel(10958, n_in, hid, n_out)[0], kpath)
    conf = os.path.join(tmp, "mnist.conf")
    with open(conf, "w") as fp:
        fp.write(f"[name] mnist\n[type] ANN\n[init] {kpath}\n"
                 f"[seed] 10958\n[input] {n_in}\n[hidden] {hid[0]}\n"
                 f"[output] {n_out}\n[train] BP\n[dtype] f64\n")
    return conf


class Server:
    """``serve_nn`` of one tree in its own process."""

    def __init__(self, tree: str, conf: str, device: str, auth: bool):
        argv = [sys.executable, "-m", "hpnn_tpu_torch.cli", "serve_nn",
                "-p", "0", "--device", device, "-b", "64", "-q", "4096",
                "--warmup-mode", "sync", conf]
        if auth:
            argv[-1:-1] = ["--auth-token", TOKEN]
        self.proc = subprocess.Popen(
            argv, cwd=tree, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=dict(os.environ, PYTHONPATH=tree))
        self.lines = []
        for line in self.proc.stdout:
            self.lines.append(line)
            if line.startswith("SERVE: listening on http://"):
                hostport = line.split("http://", 1)[1].strip()
                self.host, port = hostport.rsplit(":", 1)
                self.port = int(port)
                break
        else:
            raise RuntimeError("serve_nn did not start:\n"
                               + "".join(self.lines[-20:]))
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self) -> None:
        for line in self.proc.stdout:
            self.lines.append(line)

    def request(self, method, path, body=None, headers=None):
        conn = http.client.HTTPConnection(self.host, self.port, timeout=120)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            r = conn.getresponse()
            return r.status, json.loads(r.read())
        finally:
            conn.close()

    def metrics(self) -> dict:
        return self.request("GET", "/metrics?format=json")[1]

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)   # drains, exits 0
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def _bodies(rows: int) -> list[bytes]:
    rng = np.random.default_rng(rows)
    pool = rng.integers(0, 256, (POOL, MNIST[0])).astype(np.float64)
    return [json.dumps({"inputs": pool[lo:lo + rows].tolist()}).encode()
            for lo in rng.integers(0, POOL - rows, BODIES)]


def _cell(srv: Server, clients: int, rows: int, seconds: float,
          reload_every: float | None) -> dict:
    bodies = _bodies(rows)
    lat: list[list[float]] = [[] for _ in range(clients)]
    errors: list = []
    swaps: list[float] = []
    stop = threading.Event()

    def client(i):
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=120)
        k = i
        hdr = {"Content-Type": "application/json"}
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                conn.request("POST", "/v1/kernels/mnist/infer",
                             body=bodies[k % BODIES], headers=hdr)
                r = conn.getresponse()
                r.read()
                if r.status != 200:
                    errors.append(r.status)
                    return
                lat[i].append(time.perf_counter() - t0)
                k += 1
        except Exception as exc:  # reported below
            errors.append(repr(exc))
        finally:
            conn.close()

    def reloader():
        while not stop.wait(reload_every):
            t0 = time.perf_counter()
            st, body = srv.request(
                "POST", "/v1/kernels/mnist/reload", b"{}",
                {"Authorization": f"Bearer {TOKEN}"})
            if st != 200:
                errors.append(("reload", st, body))
                return
            swaps.append(time.perf_counter() - t0)

    before = srv.metrics()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    if reload_every:
        threads.append(threading.Thread(target=reloader))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    after = srv.metrics()
    if errors:
        raise RuntimeError(f"{clients} clients x {rows} rows: {errors[:3]}")
    every = np.asarray([v for per in lat for v in per])
    out = {"requests": int(every.size), "requests_per_s": every.size / wall,
           "client_p50_ms": float(np.percentile(every, 50)) * 1e3,
           "client_p99_ms": float(np.percentile(every, 99)) * 1e3}
    out.update(_server_side(before, after))
    if reload_every:
        out["reloads"] = len(swaps)
        out["reload_wall_ms"] = (statistics.median(swaps) * 1e3
                                 if swaps else None)
    return out


def _pct(counts: dict, p: float) -> float | None:
    """Upper bucket edge of the p-th percentile of a sparse histogram
    (the server's own estimate, ``serve/metrics.py``)."""
    n = sum(counts.values())
    if n <= 0:
        return None
    rank, seen = p / 100.0 * n, 0
    for i in sorted(counts):
        seen += counts[i]
        if seen >= rank:
            return 1e-4 * 10.0 ** (0.1 * i) * 1e3
    return None


def _hist_diff(a: dict | None, b: dict | None) -> dict:
    ca = {int(k): v for k, v in ((a or {}).get("counts") or {}).items()}
    cb = {int(k): v for k, v in ((b or {}).get("counts") or {}).items()}
    return {i: cb.get(i, 0) - ca.get(i, 0) for i in set(ca) | set(cb)
            if cb.get(i, 0) - ca.get(i, 0) > 0}


def _server_side(before: dict, after: dict) -> dict:
    """A cell's server-side numbers from two ``/metrics`` snapshots."""
    nb = "batches_total" if "batches_total" in after else "batches"
    nr = "rows_total" if "rows_total" in after else "batch_rows"
    batches = after[nb] - before[nb]
    rows = after[nr] - before[nr]
    out = {"batches": batches,
           "rows_per_batch": rows / batches if batches else None,
           "server_p50_ms": None, "server_p99_ms": None, "fill": None,
           "phase_p50_ms": None}
    if "counts" not in after.get("latency", {}):
        return out          # a server without the histograms
    lat = _hist_diff(before.get("latency"), after.get("latency"))
    out["server_p50_ms"] = _pct(lat, 50)
    out["server_p99_ms"] = _pct(lat, 99)
    # the mean over batches of rows / bucket, from per-bucket counts
    fill_sum, n = 0.0, 0
    for b, st in after.get("buckets", {}).items():
        old = before.get("buckets", {}).get(b, {"batches": 0, "rows": 0})
        fill_sum += (st["rows"] - old["rows"]) / int(b)
        n += st["batches"] - old["batches"]
    out["fill"] = fill_sum / n if n else None
    out["phase_p50_ms"] = {
        p: _pct(_hist_diff(before.get("phases", {}).get(p), h), 50)
        for p, h in after.get("phases", {}).items()}
    return out


def _median(cells: list[dict]) -> dict:
    out = {}
    for k in cells[0]:
        vals = [c[k] for c in cells]
        if isinstance(vals[0], dict):
            out[k] = {p: statistics.median([v[p] for v in vals
                                            if v.get(p) is not None])
                      if any(v.get(p) is not None for v in vals) else None
                      for p in vals[0]}
        elif all(isinstance(v, (int, float)) for v in vals):
            out[k] = statistics.median(vals)
        else:
            out[k] = vals[0]
    return out


def _run_tree(tree, conf, args, has_reload):
    srv = Server(tree, conf, args.device, auth=has_reload)
    cells = {}
    try:
        for clients in args.clients:
            for rows in args.rows:
                cells[f"{clients}x{rows}"] = _cell(srv, clients, rows,
                                                   args.seconds, None)
        if has_reload:
            for rows in args.rows:
                cells[f"8x{rows} reload/s"] = _cell(srv, 8, rows,
                                                    args.seconds, 1.0)
    finally:
        srv.close()
    return cells


REGISTRY_LOOP = """
import json, sys, time
import numpy as np
from hpnn_tpu_torch.serve.registry import ModelRegistry
reg = ModelRegistry(max_batch=64, device=sys.argv[2])
model = reg.register_conf(sys.argv[1])
out = {}
for rows in (1, 64):
    x = np.random.default_rng(rows).integers(0, 256, (rows, 784)) * 1.0
    for _ in range(50):
        model.infer(x)
    walls = []
    for _ in range(2000):
        t0 = time.perf_counter()
        model.infer(x)
        walls.append(time.perf_counter() - t0)
    out[str(rows)] = sorted(walls)[len(walls) // 2] * 1e3
print("REGISTRY " + json.dumps(out))
"""


def _registry_loop(tree: str, conf: str, device: str) -> dict:
    """Median ms of one synchronous registry forward (1 and 64 rows) in a
    fresh process of ``tree``."""
    res = subprocess.run([sys.executable, "-c", REGISTRY_LOOP, conf, device],
                         cwd=tree, env=dict(os.environ, PYTHONPATH=tree),
                         capture_output=True, text=True, timeout=600)
    for line in res.stdout.splitlines():
        if line.startswith("REGISTRY "):
            return json.loads(line[len("REGISTRY "):])
    raise RuntimeError(f"registry loop in {tree}: {res.stderr[-2000:]}")


def compare_parity(conf: str, mesh_n: int, device: str,
                   seed: int = 42) -> list[dict]:
    """The strict / fast / fast@meshN tier table of this tree (see the
    module docstring).  Every registry serves the same kernel file."""
    sys.path.insert(0, ROOT)
    from hpnn_tpu_torch.parallel.mesh import DataMesh, data_mesh
    from hpnn_tpu_torch.runtime import resolve_device
    from hpnn_tpu_torch.serve.registry import ModelRegistry

    dev = resolve_device(device)
    mesh = data_mesh(mesh_n, dev) if dev.type == "cuda" else None
    if mesh is None or mesh.n_data != mesh_n:
        mesh = DataMesh([dev] * mesh_n)
    buckets, cap = PARITY_BUCKETS, max(PARITY_BUCKETS)
    text = open(conf).read()
    rows = []
    rng = np.random.default_rng(seed)
    for dname in PARITY_DTYPES:
        dconf = conf.replace(".conf", f"_{dname}.conf")
        with open(dconf, "w") as fp:
            fp.write(text.replace("[dtype] f64", f"[dtype] {dname}"))
        tiers = {
            "strict": ModelRegistry(max_batch=cap, device=device),
            "fast": ModelRegistry(max_batch=cap, parity="fast",
                                  fast_threshold=min(buckets),
                                  device=device),
            f"fast@mesh{mesh_n}": ModelRegistry(
                max_batch=cap, parity="fast", fast_threshold=min(buckets),
                device=device, mesh=mesh)}
        models = {t: reg.register_conf(dconf) for t, reg in tiers.items()}
        for bucket in buckets:
            xs = rng.integers(0, 256, (bucket, MNIST[0])).astype(np.float64)
            row = {"dtype": dname, "bucket": bucket,
                   "mesh_devices": [str(d) for d in mesh.devices]}
            outs = {}
            for tier, model in models.items():
                outs[tier] = model.infer(xs)            # the warm pass
                walls = []
                for _ in range(PARITY_REPS):
                    t0 = time.perf_counter()
                    model.infer(xs)
                    walls.append(time.perf_counter() - t0)
                dt = statistics.median(walls)
                row[tier] = {"tier": tiers[tier].tier_for(bucket),
                             "ms_per_batch": dt * 1e3,
                             "rows_per_s": bucket / dt}
            base = row["strict"]["rows_per_s"]
            for tier in models:
                if tier != "strict":
                    row[tier]["speedup_vs_strict"] = \
                        row[tier]["rows_per_s"] / base
                    row[tier]["max_abs_diff_vs_strict"] = float(
                        np.abs(outs[tier] - outs["strict"]).max())
            row[f"fast@mesh{mesh_n}"]["bitwise_vs_fast"] = bool(
                np.array_equal(outs[f"fast@mesh{mesh_n}"], outs["fast"]))
            rows.append(row)
    return rows


def _has_reload(tree: str) -> bool:
    path = os.path.join(tree, "hpnn_tpu_torch", "serve", "server.py")
    with open(path) as fp:
        return "/reload" in fp.read()


def _fmt(v, nd=3):
    return "null" if v is None else f"{v:.{nd}f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None, metavar="PATH")
    ap.add_argument("--previous", action="append", default=[],
                    metavar="DIR", help="another checkout to measure beside "
                    "this one (repeatable)")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--clients", default="1,8,32")
    ap.add_argument("--rows", default="1,64")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", type=int, default=4, metavar="N",
                    help="shards of the fast@meshN row (default 4)")
    ap.add_argument("--parity-only", action="store_true",
                    help="run the tier table alone")
    args = ap.parse_args(argv)
    args.clients = [int(c) for c in args.clients.split(",")]
    args.rows = [int(r) for r in args.rows.split(",")]
    card = _card()
    log(card)
    with tempfile.TemporaryDirectory(prefix="hpnn_serve_tiers_") as tmp:
        parity = compare_parity(_setup(tmp), args.mesh, args.device)
    mesh_tier = f"fast@mesh{args.mesh}"
    log(f"tier table ({card}; median ms of {PARITY_REPS} synchronous "
        f"registry calls; {mesh_tier} on {parity[0]['mesh_devices']})")
    log("dtype bucket  strict ms   fast ms (x strict, max diff)   "
        f"{mesh_tier} ms (x strict, max diff, bits = fast)")
    for r in parity:
        f, m = r["fast"], r[mesh_tier]
        log(f"{r['dtype']:5} {r['bucket']:6}  "
            f"{r['strict']['ms_per_batch']:9.4f} {f['ms_per_batch']:9.4f} "
            f"({f['speedup_vs_strict']:.2f}x, "
            f"{f['max_abs_diff_vs_strict']:.2e})   "
            f"{m['ms_per_batch']:9.4f} ({m['speedup_vs_strict']:.2f}x, "
            f"{m['max_abs_diff_vs_strict']:.2e}, {m['bitwise_vs_fast']}) "
            f"[{f['tier']}, {m['tier']}]")
    if args.parity_only:
        if args.json:
            os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                        exist_ok=True)
            with open(args.json, "w") as fp:
                json.dump({"card": card, "args": vars(args),
                           "parity": parity}, fp, indent=1)
        return 0
    trees = {"this": ROOT}
    for i, prev in enumerate(args.previous):
        trees["previous" + (str(i + 1) if i else "")] = os.path.abspath(prev)
    runs = {name: [] for name in trees}
    registry = {name: [] for name in trees}
    with tempfile.TemporaryDirectory(prefix="hpnn_serve_cmp_") as tmp:
        conf = _setup(tmp)
        for rep in range(args.reps):
            k = rep % len(trees)
            order = list(trees)[k:] + list(trees)[:k]
            if rep % 2:
                order = order[::-1]
            for name in order:
                t0 = time.perf_counter()
                registry[name].append(_registry_loop(trees[name], conf,
                                                     args.device))
                runs[name].append(_run_tree(trees[name], conf, args,
                                            _has_reload(trees[name])))
                log(f"rep {rep + 1}/{args.reps} {name}: "
                    f"{time.perf_counter() - t0:.1f} s")
    table = {name: {cell: _median([r[cell] for r in reps])
                    for cell in reps[0]}
             for name, reps in runs.items()}
    reg_table = {name: _median(r) for name, r in registry.items()}
    log(f"medians of {args.reps} ({card}); ms unless named")
    for name, r in reg_table.items():
        log(f"{name:9} registry forward alone: 1 row {_fmt(r['1'])}, "
            f"64 rows {_fmt(r['64'])}")
    log("tree      cell             req/s     client p50/p99      "
        "server p50/p99     rows/batch  fill    phases p50")
    for name, cells in table.items():
        for cell, c in cells.items():
            ph = c["phase_p50_ms"]
            phases = ("null" if ph is None else " ".join(
                f"{p}={_fmt(v)}" for p, v in sorted(ph.items())))
            extra = (f" reload {_fmt(c['reload_wall_ms'], 1)} ms x"
                     f"{c['reloads']}" if "reloads" in c else "")
            log(f"{name:9} {cell:16} {c['requests_per_s']:9.1f} "
                f"{_fmt(c['client_p50_ms'])}/{_fmt(c['client_p99_ms'])}  "
                f"{_fmt(c['server_p50_ms'])}/{_fmt(c['server_p99_ms'])}  "
                f"{_fmt(c['rows_per_batch'], 2)}  {_fmt(c['fill'])}  "
                f"{phases}{extra}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fp:
            json.dump({"card": card, "args": vars(args), "parity": parity,
                       "medians": table,
                       "registry_ms": reg_table, "runs": runs,
                       "registry_runs": registry, "trees": trees}, fp,
                      indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
