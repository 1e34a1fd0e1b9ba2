"""train_nn / run_nn / serve_nn command-line entry points of the port.

    python -m hpnn_tpu_torch.cli train_nn [-h] [-v]... [-x] [-O n] [-B n]
        [-S n] [--device {cuda,cpu}] [--lnn native] [conf]
    python -m hpnn_tpu_torch.cli run_nn [-h] [-v]... [-O n] [-B n] [-S n]
        [--device {cuda,cpu}] [--lnn native] [conf]
    python -m hpnn_tpu_torch.cli serve_nn [-v]... [-a ADDR] [-p PORT]
        [-b MAX_BATCH] [-q QUEUE_ROWS] [--linger-ms MS] [--timeout-s S]
        [--parity {strict,fast}] [--fast-threshold N]
        [--warmup-mode {background,sync,off}] [--device {cuda,cpu}]
        [conf ...]

``train_nn`` and ``run_nn`` keep the reference parser
(``tests/train_nn.c:59-255``, ``tests/run_nn.c:66-234``): flags combine
(``-vv``), ``-x`` is accepted and does nothing (as in the reference),
-O/-B/-S take attached or separated values (checked, then ignored: PyTorch
owns host threads and CUDA streams), the conf defaults to ``./nn.conf``.
``train_nn`` dumps the untrained kernel to ``kernel.tmp`` before training
and the trained one to ``kernel.opt`` after (``train_nn.c:224-243``).
Every command runs on the GPU unless
``--device cpu`` is given; asking for the GPU on a host without one exits
non-zero before anything is computed.  The JAX package's other options
(checkpoints, caches, profiling, mesh serving, jobs, tracing, QoS) are
refused with a message naming them: later slices of the port bring them.
"""

from __future__ import annotations

import sys

from . import runtime
from .api import configure, run_kernel, train_kernel
from .utils import nn_log

LATER = "is not ported yet: a later slice of hpnn_tpu_torch brings it"


def _help_text(name: str) -> str:
    train = name == "train_nn"
    lines = [
        "***********************************",
        f"usage:  {name} [-options] [input]",
        "***********************************",
        "options:",
        "-h \tdisplay this help;",
        "-v \tincrease verbosity;",
    ]
    if train:
        lines.append("-x \tdiscard results (accepted, does nothing).")
    lines += [
        "-O \tnumber of host threads (accepted and ignored).",
        "-B \tnumber of BLAS threads (accepted and ignored).",
        "-S \tnumber of CUDA streams (accepted and ignored).",
    ]
    if train:
        lines.append("\t(the row-sharded route -S selects in hpnn_tpu is "
                     "ROADMAP item 7.)")
    lines += [
        "--device {cuda,cpu} \twhere to compute (default cuda; no",
        "\tfallback: without a GPU, cuda exits non-zero).",
        "--lnn native \topt into the native LNN regression head",
        "\t(linear output + MSE grammar); HPNN_LNN_NATIVE=1 is the",
        "\tenv equivalent.",
        "***********************************",
        "input:     neural network .def file",
        "contains the network definition and",
        "topology. May contain weight values",
        "or context for a random generation.",
        "***********************************",
    ]
    return "\n".join(lines) + "\n"


def _leading_uint(value: str) -> int | None:
    """GET_UINT is atoi-style: the leading digits (run_nn.c:124)."""
    digits = ""
    for ch in value:
        if not ch.isdigit():
            break
        digits += ch
    return int(digits) if digits else None


def _parse_args(argv: list[str], name: str):
    """Reference-style parse; returns (filename, extras) or None on -h,
    raises SystemExit(-1) on syntax errors."""
    filename = None
    extras = {"device": "cuda", "lnn": None}
    choices = {"--device": ("device", runtime.DEVICES),
               "--lnn": ("lnn", ("native",))}
    numeric = "OBS"   # thread/BLAS/stream counts: checked, then ignored
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "-":
            # bare '-': the reference's switch loop ignores it (run_nn.c:86)
            i += 1
            continue
        key, eq, val = arg.partition("=")
        if key in choices:
            dest, allowed = choices[key]
            if not eq:
                i += 1
                val = argv[i] if i < len(argv) else ""
            if val.strip().lower() not in allowed:
                sys.stderr.write(f"syntax error: bad {key} parameter!\n")
                sys.stdout.write(_help_text(name))
                raise SystemExit(-1)
            extras[dest] = val.strip().lower()
            i += 1
            continue
        if arg.startswith("--"):
            sys.stderr.write(f"{name}: {key} {LATER}\n")
            raise SystemExit(-1)
        if arg.startswith("-"):
            j = 1
            while j < len(arg):
                c = arg[j]
                if c == "h":
                    sys.stdout.write(_help_text(name))
                    return None
                if c == "v":
                    # increment live so the third -v logs "verbosity set
                    # to 3." exactly like _NN(inc,verbose) (libhpnn.c:73)
                    nn_log.inc_verbosity()
                    j += 1
                    continue
                if c == "x" and name == "train_nn":
                    j += 1  # _NN(toggle,dry): a no-op in the reference
                    continue
                if c in numeric:
                    if j + 1 < len(arg):
                        value = arg[j + 1:]
                    else:
                        i += 1
                        value = (argv[i] if i < len(argv) else "").lstrip()
                    if not _leading_uint(value):
                        sys.stderr.write(
                            f"syntax error: bad -{c} parameter!\n")
                        sys.stdout.write(_help_text(name))
                        raise SystemExit(-1)
                    break  # no combination after a numeric switch
                sys.stderr.write("syntax error: unrecognized option!\n")
                sys.stdout.write(_help_text(name))
                raise SystemExit(-1)
        else:
            if filename is not None:
                # second filename: the reference fails silently
                raise SystemExit(-1)
            filename = arg
        i += 1
    return filename or "./nn.conf", extras


def run_nn(argv: list[str] | None = None):
    """run_nn (tests/run_nn.c:66-234).  Returns ``(rc, outputs)``: the exit
    code and the (rows, n_out) float64 outputs of the evaluated test dir
    in shuffle order (None when nothing was evaluated)."""
    argv = sys.argv[1:] if argv is None else argv
    nn_log.set_verbosity(0)
    try:
        parsed = _parse_args(argv, "run_nn")
        if parsed is None:
            return 0, None
        filename, extras = parsed
        if runtime.init_all(extras["device"]) != 0:
            return -1, None
        neural = configure(filename)
        if neural is None:
            sys.stderr.write(
                "FAILED to read NN configuration file! (ABORTING)\n")
            return -1, None
        if extras["lnn"]:
            neural.conf.lnn = extras["lnn"]
        outs = run_kernel(neural, device=runtime.lib_runtime.device)
        return 0, outs
    finally:
        runtime.deinit_all()


def run_nn_main(argv: list[str] | None = None) -> int:
    return run_nn(argv)[0]


def train_nn_main(argv: list[str] | None = None) -> int:
    """train_nn (tests/train_nn.c:59-255): configure, dump kernel.tmp, one
    training epoch on the device, dump kernel.opt.  Returns the exit
    code."""
    from .io.kernel_io import dump_kernel_to_path

    argv = sys.argv[1:] if argv is None else argv
    nn_log.set_verbosity(0)
    try:
        parsed = _parse_args(argv, "train_nn")
        if parsed is None:
            return 0
        filename, extras = parsed
        if runtime.init_all(extras["device"]) != 0:
            return -1
        neural = configure(filename)
        if neural is None:
            sys.stderr.write(
                "FAILED to read NN configuration file! (ABORTING)\n")
            return -1
        if extras["lnn"]:
            neural.conf.lnn = extras["lnn"]
        try:
            dump_kernel_to_path(neural.kernel, "kernel.tmp")
        except OSError:
            sys.stderr.write("FAILED to open kernel.tmp for WRITE!\n")
            return -1
        if not train_kernel(neural, device=runtime.lib_runtime.device):
            sys.stderr.write("FAILED to train kernel!\n")
            return -1
        try:
            dump_kernel_to_path(neural.kernel, "kernel.opt")
        except OSError:
            # the reference prints the kernel.tmp message on both dump
            # failures (tests/train_nn.c:243)
            sys.stderr.write("FAILED to open kernel.tmp for WRITE!\n")
            return -1
        return 0
    finally:
        runtime.deinit_all()


def _serve_parser():
    import argparse

    ap = argparse.ArgumentParser(
        prog="serve_nn",
        description="serve trained hpnn kernels over HTTP "
                    "(POST /v1/kernels/<name>/infer) from the port")
    ap.add_argument("confs", nargs="*", default=["./nn.conf"],
                    metavar="conf", help="nn.conf files (run_nn format; "
                    "default ./nn.conf); each registers one kernel")
    ap.add_argument("-v", "--verbose", action="count", default=0,
                    help="increase verbosity (repeatable)")
    ap.add_argument("-a", "--addr", default="127.0.0.1",
                    help="bind address (default 127.0.0.1)")
    ap.add_argument("-p", "--port", type=int, default=8080,
                    help="bind port; 0 picks an ephemeral one")
    ap.add_argument("-b", "--max-batch", type=int, default=64,
                    help="max rows per device launch / largest batch "
                    "bucket (default 64)")
    ap.add_argument("-q", "--queue-rows", type=int, default=256,
                    help="bounded queue capacity in rows; admission "
                    "beyond it is rejected with 429 (default 256)")
    ap.add_argument("--linger-ms", type=float, default=0.0,
                    help="wait this long after the first queued request "
                    "so concurrent clients can fill the batch (default 0)")
    ap.add_argument("--timeout-s", type=float, default=30.0,
                    help="default per-request deadline (default 30)")
    ap.add_argument("--parity", choices=("strict", "fast"),
                    default="strict",
                    help="serving tier: 'strict' answers bit-identically "
                    "to run_nn (default); 'fast' routes buckets >= "
                    "--fast-threshold to the throughput path")
    ap.add_argument("--fast-threshold", type=int, default=256,
                    help="smallest batch bucket the 'fast' tier applies "
                    "to (default 256)")
    ap.add_argument("--warmup-mode", choices=("background", "sync", "off"),
                    default="background",
                    help="run every batch bucket once before serving: "
                    "'background' (default) binds at once and reports "
                    "'warming' on /healthz until done; 'sync' warms "
                    "before binding; 'off' skips warmup")
    ap.add_argument("--device", choices=runtime.DEVICES, default="cuda",
                    help="where to compute (default cuda; no fallback)")
    return ap


def serve_app(argv: list[str]):
    """Parse serve_nn's arguments and build the app: ``(app, args)``, or
    ``(None, rc)`` when the command must exit with ``rc``.  The app's
    kernels are registered; nothing is bound yet."""
    ap = _serve_parser()
    args, rest = ap.parse_known_intermixed_args(argv)
    if rest:
        sys.stderr.write(f"serve_nn: {rest[0].split('=')[0]} {LATER}\n")
        return None, 2
    from .serve.server import ServeApp

    nn_log.set_verbosity(0)
    for _ in range(args.verbose):
        nn_log.inc_verbosity()
    if runtime.init_all(args.device) != 0:
        runtime.deinit_all()
        return None, -1
    app = ServeApp(max_batch=args.max_batch, max_queue_rows=args.queue_rows,
                   linger_s=args.linger_ms / 1e3,
                   default_timeout_s=args.timeout_s, parity=args.parity,
                   fast_threshold=args.fast_threshold,
                   device=runtime.lib_runtime.device)
    n_ok = 0
    for conf in args.confs:
        model = app.add_model(conf, warmup=args.warmup_mode != "off",
                              background=args.warmup_mode == "background")
        if model is None:
            sys.stderr.write(f"FAILED to load NN configuration file "
                             f"{conf}! (skipping)\n")
        else:
            n_ok += 1
    if n_ok == 0:
        sys.stderr.write("no kernel could be registered (ABORTING)\n")
        app.close(drain=False)
        runtime.deinit_all()
        return None, -1
    return app, args


def serve_nn_main(argv: list[str] | None = None) -> int:
    """serve_nn: a long-lived inference server over the same ``.conf``
    files run_nn takes.  SIGTERM/SIGINT drain: admission stops, every
    admitted request is answered, then the process exits 0."""
    import signal
    import threading

    from .serve.server import make_server

    argv = sys.argv[1:] if argv is None else argv
    app, args = serve_app(argv)
    if app is None:
        return args
    httpd = make_server(args.addr, args.port, app)
    host, port = httpd.server_address[:2]
    # unconditional: with -p 0 this line is how a launcher learns the port
    sys.stdout.write(f"SERVE: listening on http://{host}:{port}\n")
    sys.stdout.flush()

    def _drain(signum, frame):
        sys.stdout.write("SERVE: draining...\n")
        sys.stdout.flush()
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig, _drain)
        except ValueError:  # not the main thread: no handlers
            pass
    try:
        httpd.serve_forever()
    finally:
        for sig, old in prev.items():
            signal.signal(sig, old)
        httpd.server_close()
        app.close(drain=True)
        runtime.deinit_all()
    return 0


COMMANDS = {"train_nn": train_nn_main, "run_nn": run_nn_main,
            "serve_nn": serve_nn_main}


def main(argv: list[str] | None = None) -> int:
    """``python -m hpnn_tpu_torch.cli {train_nn,run_nn,serve_nn}
    [args...]``."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        sys.stderr.write("usage: python -m hpnn_tpu_torch.cli "
                         f"{{{','.join(COMMANDS)}}} [args...]\n")
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
