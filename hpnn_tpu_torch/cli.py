"""train_nn / run_nn / serve_nn command-line entry points of the port.

    python -m hpnn_tpu_torch.cli train_nn [-h] [-v]... [-x] [-O n] [-B n]
        [-S n] [--device {cuda,cpu}] [--lnn native] [--tile S|auto]
        [--model-parallel N] [--trainer {cg,bp,bpm}] [--epochs N] [--ckpt-every N] [--ckpt-dir DIR] [--ckpt-keep N]
        [--resume [PATH]] [--replicate-to DEST] [--corpus-cache DIR]
        [--corpus-cache-max-mb N] [--profile-dir DIR] [conf]
    python -m hpnn_tpu_torch.cli run_nn [-h] [-v]... [-O n] [-B n] [-S n]
        [--device {cuda,cpu}] [--lnn native] [--ckpt-dir DIR]
        [--corpus-cache DIR] [--corpus-cache-max-mb N] [--profile-dir DIR]
        [conf]
    python -m hpnn_tpu_torch.cli serve_nn [-v]... [-a ADDR] [-p PORT]
        [-b MAX_BATCH] [-q QUEUE_ROWS] [--linger-ms MS] [--timeout-s S]
        [--parity {strict,fast}] [--fast-threshold N] [--mesh N]
        [--warmup-mode {background,sync,off}] [--device {cuda,cpu}]
        [--jobs N [--job-workers K] [--job-dir DIR] [--job-auto-resume]
        [--replicate-to DEST] [--auto-promote]] [--trace]
        [--trace-sample P] [--span-dir DIR] [--profile-dir DIR]
        [--quota-rows F [--quota-burst N]] [--slo-p99-ms F]
        [--slo-availability F] [--shed-low]
        [--mesh-role router [--workers N] [--router-token T]
        [--mesh-health-interval S] [--standby HOST:PORT]
        [--autoscale MIN:MAX [--autoscale-cooldown S]]]
        [--mesh-role worker --router HOST:PORT [--advertise HOST:PORT]
        [--require-router]]
        [--mesh-role standby --primary HOST:PORT [--takeover-after N]
        [--advertise HOST:PORT]] [conf ...]

``train_nn`` and ``run_nn`` keep the reference parser
(``tests/train_nn.c:59-255``, ``tests/run_nn.c:66-234``): flags combine
(``-vv``), ``-x`` is accepted and does nothing (as in the reference),
-O/-B/-S take attached or separated values (checked; -O and -B are then
ignored: PyTorch owns host threads; -S N is the row-sharding degree when
the conf sets no ``[model]``, as the reference's streams split each
layer's rows), the conf defaults to ``./nn.conf``.
``train_nn`` dumps the untrained kernel to ``kernel.tmp`` before training
and the trained one to ``kernel.opt`` after (``train_nn.c:224-243``);
``--tile S`` (or ``auto``) trains through the batched-tile engine and wins
over the conf's ``[tile]``.  ``--trainer cg`` trains with the batched
conjugate-gradient trainer (``train.cg``; ``bp``/``bpm`` select the
reference trainers) and sets the conf's ``[train]`` to match.  A
``[batch] B`` conf trains minibatch data-parallel, over the
``torch.distributed`` world when ``HPNN_DISTRIBUTED`` is set
(``runtime``); a ``[model] N`` conf (``--model-parallel N`` wins over it,
``-S N`` stands in for it) shards every layer's rows over N ranks of that
world (``parallel.tp``), and ``run_nn`` evaluates it row-sharded.
``--epochs N`` trains N epochs in one process
(``ckpt.trainer.train_loop``: one continuing shuffle stream, the corpus and
the weights resident on the device).  ``--ckpt-every/--ckpt-dir/
--ckpt-keep`` write crash-safe snapshot bundles at epoch boundaries
(``ckpt/``, the JAX package's format), ``--resume [PATH]`` continues a
killed run bit-exactly from the newest intact bundle, and
``--replicate-to DEST`` ships each bundle to a second directory, or to a
serve-mesh router (``http://HOST:PORT``), that a resume restores from
when no local bundle survives.  ``run_nn`` warns when
a checkpoint manifest (``--ckpt-dir``, default ``./ckpt``) recorded a
different fingerprint for the kernel it evaluates.  ``--corpus-cache DIR``
puts the packed corpus cache (``io.corpus``) in DIR for this command and
``--corpus-cache-max-mb N`` caps that dir's size.
``serve_nn --jobs N`` adds the online training service
(``jobs/``: ``POST /v1/kernels/<name>/train`` trains a kernel while it is
served, each epoch's snapshot hot-reloaded), with ``--job-workers K``,
``--job-dir DIR``, ``--job-auto-resume``, ``--replicate-to DIR`` and
``--auto-promote``.  ``serve_nn --trace`` turns on span tracing and the
flight recorder (``obs/``; ``--trace-sample P`` head-samples it,
``--span-dir DIR`` spools the spans durably), ``--profile-dir DIR`` is
where ``POST /v1/debug/profile`` writes its ``torch.profiler`` capture,
and ``train_nn``/``run_nn --profile-dir DIR`` profile the whole run.
``HPNN_PROFILE=1`` prints ``#PROF: <phase> <secs>`` lines and
``HPNN_DBG_TRACE=1`` the ``#DBG`` weight checksums (``utils/trace.py``).
A serve_nn that drains on SIGTERM, or dies of a fault, dumps its flight
recorder into the job dir (or the cwd).  Every command runs on the GPU
unless ``--device cpu`` is given; asking for the GPU on a host without
one exits non-zero before anything is computed.  ``serve_nn --mesh-role
router|worker|standby`` runs the serve mesh (``serve/mesh/``): a router
with ``--standby`` and its passive standby with ``--primary`` (takeover
after ``--takeover-after`` missed polls), and ``--autoscale MIN:MAX`` for
spawned and retired local workers.  Every option of the JAX package's
commands is taken, except its XLA compilation cache (``--compile-cache``),
which is refused with a line of its own; ``serve_nn --parity fast --mesh
N`` shards the fast buckets over a data mesh of N cards (capped to the
visible cards, floored to a power of two; inert under strict parity, no
mesh on the CPU).  An option neither package knows gets the JAX
package's answer (the reference's "unrecognized option" and the usage
text for train_nn/run_nn, argparse's error for serve_nn).
"""

from __future__ import annotations

import os
import sys

from . import runtime
from .api import configure, run_kernel, train_kernel
from .obs.profiler import profile_run
from .utils import nn_log
from .utils.trace import phase


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
        "-S \tnumber of device shards (the [model] row split when",
        "\tthe conf sets no [model]).",
    ]
    lines += [
        "--device {cuda,cpu} \twhere to compute (default cuda; no",
        "\tfallback: without a GPU, cuda exits non-zero).",
        "--lnn native \topt into the native LNN regression head",
        "\t(linear output + MSE grammar); HPNN_LNN_NATIVE=1 is the",
        "\tenv equivalent.",
        "--corpus-cache DIR \tpacked corpus cache location (default:",
        "\ta dotfile next to each sample dir; HPNN_NO_CORPUS_CACHE=1 off).",
        "--corpus-cache-max-mb N \tLRU size cap on the --corpus-cache",
        "\tdir: least-recently-used packs past the cap are evicted (the",
        "\tin-flight run's pack never is; 0: no cap).",
        "--ckpt-dir DIR \tcheckpoint directory (default ./ckpt).",
        "--profile-dir DIR \tcapture the whole run as a torch.profiler",
        "\tChrome trace into DIR (TensorBoard-loadable; the card's",
        "\tkernels under their names).",
    ]
    if train:
        lines += [
            "--trainer T \tselect the trainer from the registry:",
            "\t'cg' (batched nonlinear conjugate gradient,",
            "\tPolak-Ribiere + restart, on-device line search;",
            "\tHPNN_CG_ITERS iterations per epoch), 'bp', or 'bpm'.",
            "\tWins over the conf [train]/[trainer] keywords; CG",
            "\tstate (direction/gradient/restarts) rides snapshot",
            "\tbundles and resumes bit-exactly.",
            "--model-parallel N \tshard every layer's neuron rows over",
            "\tN ranks (the reference's MPI_Allgather row split,",
            "\toverlapped ring schedule); wins over the conf [model]",
            "\tkeyword.  Composes with [batch] on a 2-D data x model",
            "\tgrid; HPNN_NO_TP_OVERLAP=1 falls back to whole-layer",
            "\tall-gathers.",
            "--tile S \tbatched-tile convergence engine: train groups",
            "\tof S samples per GEMM-shaped step (per-lane convergence",
            "\tmasking; documented trajectory divergence vs per-sample",
            "\ttraining for S>1).  'auto' asks the topology autotuner",
            "\t(HPNN_NO_AUTOTUNE=1 disables; HPNN_AUTOTUNE_CACHE=DIR",
            "\trelocates the decision cache); 0 keeps per-sample mode.",
            "--epochs N \ttrain N epochs in this process (default 1):",
            "\tthe shuffle stream continues across epochs and the",
            "\tcorpus and weights stay on the device",
            "\t(HPNN_NO_EPOCH_PIPELINE=1 restages every epoch).",
            "--ckpt-every N \tsnapshot every N epoch boundaries (atomic,",
            "\twritten off the critical path; 0: only at the end or on",
            "\ta signal).",
            "--ckpt-keep N \tretention: keep the last N snapshots and the",
            "\tbest-by-error one (0: keep all).",
            "--resume [PATH] \tcontinue bit-exactly from the latest",
            "\tsnapshot in PATH (a ckpt dir or bundle; default",
            "\t--ckpt-dir): weights, BPM momentum, shuffle-RNG state",
            "\tand epoch counter are restored.  Bundles are VERIFIED",
            "\tagainst their recorded sha256 fingerprints; a corrupt",
            "\tbundle falls back to the newest intact one.",
            "--replicate-to DEST \tship each verified snapshot bundle,",
            "\tcontent-addressed, to DEST (a directory, or",
            "\thttp://HOST:PORT of a mesh router); --resume restores",
            "\tfrom DEST when no local bundle survives.  Default:",
            "\t$HPNN_REPLICATE_TO.",
        ]
    lines += [
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


def _syntax_error(name: str, key: str):
    sys.stderr.write(f"syntax error: bad {key} parameter!\n")
    sys.stdout.write(_help_text(name))
    raise SystemExit(-1)


# long options taking a value: option -> (extras key, commands); the
# checkpoint directory parses for run_nn too (its staleness guard)
# (--replicate-to parses for run_nn too, which reads nothing of it: the
# JAX package's run_nn takes it the same way)
_STR_OPTS = {"--ckpt-dir": ("ckpt_dir", ("train_nn", "run_nn")),
             "--replicate-to": ("replicate_to", ("train_nn", "run_nn")),
             "--corpus-cache": ("corpus_cache", ("train_nn", "run_nn")),
             "--profile-dir": ("profile_dir", ("train_nn", "run_nn"))}
# unsigned long options: option -> (extras key, least value, commands)
_UINT_OPTS = {"--epochs": ("epochs", 1, ("train_nn",)),
              "--model-parallel": ("model_parallel", 1, ("train_nn",)),
              "--ckpt-every": ("ckpt_every", 0, ("train_nn",)),
              "--ckpt-keep": ("ckpt_keep", 0, ("train_nn",)),
              "--corpus-cache-max-mb": ("corpus_cache_max_mb", 0,
                                        ("train_nn", "run_nn"))}
_COMPILE_CACHE_REFUSAL = ("names the JAX package's XLA compilation cache; "
                          "the port compiles no XLA programs (refused)")


def _parse_args(argv: list[str], name: str):
    """Reference-style parse; returns (filename, extras) or None on -h,
    raises SystemExit(-1) on syntax errors."""
    filename = None
    extras = {"device": "cuda", "lnn": None, "tile": None, "resume": None,
              "trainer": None, "streams": None}
    extras.update({dest: None for dest, _ in _STR_OPTS.values()})
    extras.update({dest: None for dest, _, _ in _UINT_OPTS.values()})
    choices = {"--device": ("device", runtime.DEVICES),
               "--lnn": ("lnn", ("native",))}
    if name == "train_nn":
        choices["--trainer"] = ("trainer", ("cg", "bp", "bpm"))
    numeric = "OBS"   # thread/BLAS counts checked then ignored; -S kept
    train = name == "train_nn"
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
                _syntax_error(name, key)
            extras[dest] = val.strip().lower()
            i += 1
            continue
        if key == "--resume" and train:
            # --resume [PATH]: the value is optional (default: the ckpt
            # dir).  A separated token is the path only when it looks like
            # a checkpoint -- otherwise it is the trailing conf filename
            # ("train_nn --resume nn.conf").  --resume=PATH is explicit.
            if eq:
                if not val:
                    _syntax_error(name, key)
                extras["resume"] = val
            else:
                from .ckpt import looks_like_checkpoint

                nxt = argv[i + 1] if i + 1 < len(argv) else None
                if nxt and not nxt.startswith("-") \
                        and looks_like_checkpoint(nxt):
                    extras["resume"] = nxt
                    i += 1
                else:
                    extras["resume"] = True
            i += 1
            continue
        if key == "--tile" and train:
            if not eq:
                i += 1
                val = argv[i] if i < len(argv) else ""
            # GET_UINT-style leading digits, or "auto": the measured
            # autotuner decision
            tile = -1 if val.strip().lower() == "auto" else _leading_uint(val)
            if tile is None:
                _syntax_error(name, key)
            extras["tile"] = tile
            i += 1
            continue
        if key in _UINT_OPTS and name in _UINT_OPTS[key][2]:
            dest, least, _ = _UINT_OPTS[key]
            if not eq:
                i += 1
                val = argv[i] if i < len(argv) else ""
            value = _leading_uint(val)   # GET_UINT-style
            if value is None or value < least:
                _syntax_error(name, key)
            extras[dest] = value
            i += 1
            continue
        if key in _STR_OPTS and name in _STR_OPTS[key][1]:
            if not eq:
                i += 1
                val = argv[i] if i < len(argv) else ""
            if not val:
                _syntax_error(name, key)
            extras[_STR_OPTS[key][0]] = val
            i += 1
            continue
        if key == "--compile-cache":
            # the one option of the JAX package's train_nn/run_nn with no
            # counterpart here: a line of its own, not a syntax error
            sys.stderr.write(f"{name}: {key} {_COMPILE_CACHE_REFUSAL}\n")
            raise SystemExit(-1)
        if arg.startswith("-"):
            # any other option neither package knows falls to the
            # reference's "unrecognized option" below, as in the JAX
            # package (its '-' switch character matches no flag)
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
                    if c == "S":
                        extras["streams"] = _leading_uint(value)
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
        with phase("init_all"):
            if _init(extras) != 0:
                return -1, None
        # --profile-dir D: the run under a torch.profiler capture; a
        # start failure warns and runs unprofiled
        with _corpus_options(extras), profile_run(extras["profile_dir"]):
            return _run_nn_body(filename, extras)
    finally:
        runtime.deinit_all()


def _init(extras: dict) -> int:
    """``runtime.init_all`` on the command's device, then the ``-S``
    stream count (init resets the runtime's state, as the reference's
    ``_NN(init,all)`` does before its CLIs set their knobs)."""
    if runtime.init_all(extras["device"]) != 0:
        return -1
    if extras["streams"]:
        runtime.set_cuda_streams(extras["streams"])
    return 0


def _corpus_options(extras: dict):
    """The command's ``--corpus-cache``/``--corpus-cache-max-mb``: they win
    over the ``HPNN_CORPUS_CACHE*`` env knobs for this command only."""
    from .io.corpus import cache_settings

    return cache_settings(extras["corpus_cache"],
                          extras["corpus_cache_max_mb"])


def _run_nn_body(filename: str, extras: dict):
    with phase("configure"):
        neural = configure(filename)
    if neural is None:
        sys.stderr.write("FAILED to read NN configuration file! (ABORTING)\n")
        return -1, None
    if extras["lnn"]:
        neural.conf.lnn = extras["lnn"]
    if neural.conf.f_kernel:
        # staleness guard: when a checkpoint manifest recorded a
        # fingerprint for this exact kernel file and the bytes no longer
        # match, warn with both paths (and evaluate anyway)
        ckpt_dir = extras["ckpt_dir"] or "./ckpt"
        if os.path.isdir(ckpt_dir):
            from .ckpt import check_kernel_fingerprint

            check_kernel_fingerprint(neural.conf.f_kernel, ckpt_dir)
    with phase("run_kernel"):
        outs = run_kernel(neural, device=runtime.lib_runtime.device)
    return 0, outs


def run_nn_main(argv: list[str] | None = None) -> int:
    return run_nn(argv)[0]


def train_nn_main(argv: list[str] | None = None) -> int:
    """train_nn (tests/train_nn.c:59-255): configure, dump kernel.tmp, one
    training epoch on the device, dump kernel.opt; with ``--epochs N``,
    checkpointing or ``--resume``, the epochs run through
    ``ckpt.trainer.train_loop``.  Returns the exit code."""
    argv = sys.argv[1:] if argv is None else argv
    nn_log.set_verbosity(0)
    try:
        parsed = _parse_args(argv, "train_nn")
        if parsed is None:
            return 0
        filename, extras = parsed
        replicate_to = extras["replicate_to"] \
            or os.environ.get("HPNN_REPLICATE_TO") or None
        with phase("init_all"):
            if _init(extras) != 0:
                return -1
        # --profile-dir D: the whole run (configure, train, dump) under a
        # torch.profiler capture; a start failure warns and runs
        # unprofiled
        with _corpus_options(extras), profile_run(extras["profile_dir"]):
            return _train_nn_body(filename, extras, replicate_to)
    finally:
        runtime.deinit_all()


def _resume_snapshot(resume, ckpt_dir: str, replicate_to: str | None):
    """The snapshot a ``--resume`` continues from (None after the
    "FAILED to resume" line): the newest intact local bundle, else the
    newest intact replica restored from ``replicate_to`` into the
    checkpoint directory."""
    from .ckpt import SNAPSHOT_STATE, load_snapshot

    resume_path = resume if isinstance(resume, str) else ckpt_dir
    snap = load_snapshot(resume_path)
    if snap is None and replicate_to:
        # replicas ship under scope_for(<ckpt dir>): a --resume naming a
        # bundle dir (or a file inside one) resolves to its enclosing
        # checkpoint dir, for the scope and as the restore target
        from .ckpt.replicate import resolve_scope, restore_bundle

        rdir = resume_path
        if os.path.isfile(rdir):
            rdir = os.path.dirname(rdir) or "."
        if os.path.isfile(os.path.join(rdir, SNAPSHOT_STATE)):
            rdir = os.path.dirname(os.path.abspath(rdir))
        if restore_bundle(replicate_to, resolve_scope(rdir),
                          rdir) is not None:
            snap = load_snapshot(rdir)
    if snap is None:
        sys.stderr.write("FAILED to resume: no loadable snapshot! "
                         "(ABORTING)\n")
    return snap


def _train_nn_body(filename: str, extras: dict,
                   replicate_to: str | None) -> int:
    from .ckpt import CheckpointManager, refresh_final_kernel, train_loop
    from .io.kernel_io import dump_kernel_to_path

    epochs = extras["epochs"] or 1
    resume = extras["resume"]
    ckpt_on = bool(resume or extras["ckpt_dir"]
                   or extras["ckpt_every"] is not None
                   or extras["ckpt_keep"] is not None)
    ckpt_dir = extras["ckpt_dir"] or "./ckpt"
    every = extras["ckpt_every"] if extras["ckpt_every"] is not None else 1
    keep = extras["ckpt_keep"] or 0
    with phase("configure"):
        neural = configure(filename)
    if neural is None:
        sys.stderr.write("FAILED to read NN configuration file! (ABORTING)\n")
        return -1
    if extras["lnn"]:
        neural.conf.lnn = extras["lnn"]
    if extras["tile"] is not None:
        neural.conf.tile = extras["tile"]   # the flag wins over [tile]
    if extras["model_parallel"] is not None:
        # --model-parallel N: the row-sharding degree, wins over [model]
        neural.conf.model = extras["model_parallel"]
    if extras["trainer"]:
        # --trainer cg|bp|bpm selects a registry trainer and coerces the
        # conf's [train], so snapshots and serving report it coherently
        from .io.conf import NN_TRAIN_BP, NN_TRAIN_BPM, NN_TRAIN_CG

        neural.conf.trainer = extras["trainer"]
        neural.conf.train = {"cg": NN_TRAIN_CG, "bpm": NN_TRAIN_BPM,
                             "bp": NN_TRAIN_BP}[extras["trainer"]]
    snap = None
    start_epoch = 0
    if resume:
        snap = _resume_snapshot(resume, ckpt_dir, replicate_to)
        if snap is None:
            return -1
        if snap.topology != list(neural.kernel.params):
            sys.stderr.write(
                f"FAILED to resume: snapshot topology {snap.topology} "
                f"does not match the configured kernel "
                f"{list(neural.kernel.params)}! (ABORTING)\n")
            return -1
        from .parallel import coord

        if snap.world_size != coord.world_size():
            # a bundle is bit-exact only along the world size that wrote
            # it: refuse on every rank instead of silently diverging
            sys.stderr.write(
                f"FAILED to resume: snapshot {snap.tag} was written by "
                f"a {snap.world_size}-process run, but this run has "
                f"{coord.world_size()} process(es)! Relaunch with the "
                "matching HPNN_NUM_PROCESSES (or retrain). (ABORTING)\n")
            return -1
        # bit-exact restore: float64 weights from state.npz (not the
        # quantized text), the effective seed, the epoch counter and the
        # CG carry; the shuffle words go to train_loop.  BPM momentum
        # rides the bundle too, but every route re-zeroes it where the
        # reference does (a sample's entry, ann.c:2391; a [batch] epoch's
        # start), so restoring it changes nothing
        neural.kernel.weights = list(snap.weights)
        neural.conf.seed = snap.seed
        neural.trainer_state = snap.trainer_state
        start_epoch = snap.epoch
        if isinstance(resume, str) and not extras["ckpt_dir"]:
            # an explicit --resume PATH names the run's checkpoint home:
            # continued snapshots go back there, not to ./ckpt
            ckpt_dir = os.path.dirname(snap.path)
        if extras["epochs"] is None and snap.target_epochs:
            # a bare --resume continues to the interrupted run's own
            # --epochs goal (recorded in the bundle)
            epochs = snap.target_epochs
        if start_epoch >= epochs:
            sys.stderr.write(
                f"CKPT: snapshot is already at epoch {start_epoch} of "
                f"{epochs}; nothing left to train (pass --epochs N to "
                "extend the run)\n")
    try:
        dump_kernel_to_path(neural.kernel, "kernel.tmp")
    except OSError:
        sys.stderr.write("FAILED to open kernel.tmp for WRITE!\n")
        return -1
    device = runtime.lib_runtime.device
    mgr = None
    if epochs > 1 or ckpt_on or start_epoch:
        if ckpt_on:
            mgr = CheckpointManager(ckpt_dir, every=every, keep_last=keep,
                                    target_epochs=epochs,
                                    replicate_to=replicate_to)
            if snap is not None:
                mgr.seed_errors(snap.errors)
        with phase("train_kernel"):
            trained, _interrupted = train_loop(
                neural, epochs, manager=mgr, start_epoch=start_epoch,
                rng_state=snap.rng_state if snap is not None else None,
                device=device)
    else:
        with phase("train_kernel"):
            trained = train_kernel(neural, device=device)
    if not trained:
        sys.stderr.write("FAILED to train kernel!\n")
        return -1
    from .parallel import coord

    if coord.process_index():
        # every rank holds the gathered weights; rank 0 alone writes them,
        # as the reference's master does (tests/train_nn.c:224-243)
        return 0
    try:
        dump_kernel_to_path(neural.kernel, "kernel.opt")
    except OSError:
        # the reference prints the kernel.tmp message on both dump
        # failures (tests/train_nn.c:243)
        sys.stderr.write("FAILED to open kernel.tmp for WRITE!\n")
        return -1
    if mgr is not None:
        try:
            mgr.record_final("kernel.opt")
        except Exception as exc:
            sys.stderr.write(f"FAILED to publish checkpoint manifest: "
                             f"{exc}\n")
            return -1
    else:
        # a plain retrain: if a manifest from an earlier checkpointed run
        # tracks this exact kernel.opt, refresh its fingerprint so
        # run_nn's staleness guard stays truthful
        refresh_final_kernel(ckpt_dir, "kernel.opt")
    return 0


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
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="shard 'fast' buckets over N devices on a data "
                    "mesh (0: single device; -1: all local devices; "
                    "capped to what is available)")
    ap.add_argument("--warmup-mode", choices=("background", "sync", "off"),
                    default="background",
                    help="run every batch bucket once before serving: "
                    "'background' (default) binds at once and reports "
                    "'warming' on /healthz until done; 'sync' warms "
                    "before binding; 'off' skips warmup")
    ap.add_argument("--no-warmup", action="store_true",
                    help="alias for --warmup-mode off")
    ap.add_argument("--watch-ckpt", action="append", default=[],
                    metavar="[NAME=]DIR",
                    help="watch a checkpoint directory's manifest and "
                    "hot-reload the named kernel on every generation "
                    "bump; NAME defaults to the only registered kernel "
                    "(repeatable)")
    ap.add_argument("--watch-interval", type=float, default=2.0,
                    metavar="S", help="manifest poll period in seconds "
                    "(default 2.0)")
    ap.add_argument("--ab-fraction", type=float, default=0.0,
                    metavar="F",
                    help="A/B generation pinning: during a hot swap this "
                    "fraction of unpinned traffic keeps going to the "
                    "previous weights generation until a promote or "
                    "rollback (0: every swap is immediate; "
                    "X-HPNN-Generation pins per request either way)")
    ap.add_argument("--auth-token", default=None, metavar="TOKEN",
                    help="require this bearer token (or X-HPNN-Token) on "
                    "every mutating endpoint: reload, train submits, job "
                    "actions, profile captures.  Default: "
                    "$HPNN_SERVE_TOKEN; unset = open")
    ap.add_argument("--trace", action="store_true", default=False,
                    help="enable span tracing + the flight recorder "
                    "(GET /v1/debug/trace; every infer request gets a "
                    "trace id, X-HPNN-Trace-Id honored/echoed).  "
                    "Default: $HPNN_TRACE; off costs nothing")
    ap.add_argument("--trace-sample", type=float, default=None,
                    metavar="P",
                    help="head-based trace sampling: keep each new "
                    "trace with probability P (decided once at trace "
                    "birth; an explicit X-HPNN-Trace-Id or a high-QoS "
                    "request always captures; dropped requests take "
                    "the zero-allocation no-trace path).  Default: "
                    "$HPNN_TRACE_SAMPLE, else keep everything")
    ap.add_argument("--span-dir", default=None, metavar="DIR",
                    help="durable span export: stream recorded spans "
                    "into rotating NDJSON segments under DIR "
                    "(fsync-on-rotate, size/age retention via "
                    "HPNN_SPAN_* knobs), so traces survive SIGKILL; "
                    "GET /v1/debug/trace?spool=1 reads them back.  "
                    "Default: $HPNN_SPAN_DIR, else ring-only")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="destination for POST /v1/debug/profile "
                    "torch.profiler captures (default: a fresh temp dir "
                    "per capture)")
    ap.add_argument("--device", choices=runtime.DEVICES, default="cuda",
                    help="where to compute (default cuda; no fallback)")
    ap.add_argument("--jobs", type=int, default=0, metavar="N",
                    help="enable the online training service with an "
                    "N-job bounded queue (POST /v1/kernels/<name>/train; "
                    "0: disabled).  Scheduler workers share the device "
                    "with eval traffic at epoch granularity and hot-swap "
                    "every epoch-boundary snapshot into serving")
    ap.add_argument("--job-workers", type=int, default=None, metavar="K",
                    help="(with --jobs) concurrent training jobs: K "
                    "scheduler workers, each pinned to a disjoint "
                    "best-fit slice of this process's devices.  Default: "
                    "$HPNN_JOB_WORKERS or 1")
    ap.add_argument("--job-dir", default="./jobs", metavar="DIR",
                    help="persistent job state/corpus/checkpoint root "
                    "(default ./jobs); a restarted server reports the "
                    "directory's job history")
    ap.add_argument("--job-auto-resume", action="store_true",
                    default=False,
                    help="(with --jobs) lease-based auto-resume: "
                    "interrupted and expired-lease jobs are re-queued "
                    "from their newest verified local-or-replicated "
                    "bundle, bounded by HPNN_JOB_MAX_RETRIES with "
                    "jittered backoff, then failed with a reason.  "
                    "Default: $HPNN_JOB_AUTO_RESUME=1")
    ap.add_argument("--replicate-to", default=None, metavar="DEST",
                    help="(with --jobs) ship every verified snapshot "
                    "bundle, content-addressed, to DEST: a directory, or "
                    "a mesh router as http://HOST:PORT (POST "
                    "/v1/mesh/bundle); auto-resume restores from DEST "
                    "when the local dir is lost.  Default: "
                    "$HPNN_REPLICATE_TO")
    ap.add_argument("--auto-promote", action="store_true", default=False,
                    help="(with --jobs) when a training job finishes, "
                    "evaluate its candidate generation against the "
                    "pre-job baseline on a held-out test dir (the "
                    "submit's 'test_samples' or the conf's [test_dir]) "
                    "and promote if better, roll back on regression")
    ap.add_argument("--shed-low", action="store_true", default=False,
                    help="SLO-driven load shedding: while an --slo-* "
                    "error budget is burning, refuse LOW-lane "
                    "(X-HPNN-Priority: low) traffic at admission with "
                    "429 + Retry-After; clears after HPNN_SHED_CLEAR_S "
                    "of quiet (hysteresis).  Default: $HPNN_SHED=1")
    ap.add_argument("--quota-rows", type=float, default=0.0, metavar="F",
                    help="per-client token-bucket quota in rows/s (keyed "
                    "by X-HPNN-Client, the auth token, or the peer "
                    "address; over-quota requests get 429 with a "
                    "refill-derived Retry-After; 0: no quota)")
    ap.add_argument("--quota-burst", type=float, default=None,
                    metavar="N",
                    help="quota bucket burst capacity in rows (default: "
                    "max(2 x rate, 64))")
    ap.add_argument("--slo-p99-ms", type=float, default=None,
                    metavar="F",
                    help="latency SLO: at most 1%% of completed requests "
                    "may exceed F ms.  Enables per-kernel error-budget "
                    "burn-rate gauges in /metrics and an slo_burn event "
                    "when the fast AND slow windows (HPNN_SLO_FAST_S/"
                    "HPNN_SLO_SLOW_S) both burn past HPNN_SLO_BURN "
                    "(default 14.4).  Unset: no SLO tracking")
    ap.add_argument("--slo-availability", type=float, default=None,
                    metavar="F",
                    help="availability SLO target in [0, 1) (e.g. "
                    "0.999): server-caused failures (HTTP >= 500) spend "
                    "the 1-F error budget; same gauges and alerts as "
                    "--slo-p99-ms")
    ap.add_argument("--mesh-role", choices=("router", "worker", "standby"),
                    default=None,
                    help="serve mesh: 'router' fans infer requests over "
                    "registered worker processes (no local launches; "
                    "/healthz warms until --workers N are live); "
                    "'worker' serves normally AND registers with "
                    "--router (heartbeat, generation catch-up); "
                    "'standby' passively mirrors --primary and takes "
                    "over routing when the primary stops answering")
    ap.add_argument("--router", default=None, metavar="HOST:PORT",
                    help="the router to register with (required for "
                    "--mesh-role worker)")
    ap.add_argument("--standby", default=None, metavar="HOST:PORT",
                    help="(router) advertise this standby address in "
                    "every registration ack, so worker heartbeats fail "
                    "over to it when this router dies")
    ap.add_argument("--primary", default=None, metavar="HOST:PORT",
                    help="(standby) the primary router to mirror and "
                    "take over from (required for --mesh-role standby)")
    ap.add_argument("--takeover-after", type=int, default=None,
                    metavar="N",
                    help="(standby) consecutive unreachable mirror polls "
                    "before takeover (default $HPNN_MESH_TAKEOVER_AFTER "
                    "or 3)")
    ap.add_argument("--router-token", default=None, metavar="TOKEN",
                    help="spill-protection token the router stamps on "
                    "its worker RPCs (X-HPNN-Router) and workers learn "
                    "from the registration ack.  Default: "
                    "$HPNN_MESH_ROUTER_TOKEN, else a random one")
    ap.add_argument("--require-router", action="store_true",
                    default=False,
                    help="(worker) only serve infer traffic bearing the "
                    "router's X-HPNN-Router token (403 otherwise), so "
                    "router quotas cannot be bypassed.  Default: "
                    "$HPNN_MESH_REQUIRE_ROUTER=1")
    ap.add_argument("--advertise", default=None, metavar="HOST:PORT",
                    help="(worker) the address the router reaches this "
                    "worker at (default: 127.0.0.1:<bound port>)")
    ap.add_argument("--workers", type=int, default=1, metavar="N",
                    help="(router) quorum: /healthz reports 'warming' "
                    "until N workers are live (default 1)")
    ap.add_argument("--mesh-health-interval", type=float, default=1.0,
                    metavar="S",
                    help="(router) worker health-check period (default "
                    "1.0 s; ejection after HPNN_MESH_EJECT_AFTER "
                    "consecutive misses)")
    ap.add_argument("--autoscale", default=None, metavar="MIN:MAX",
                    help="(router) elastic worker lifecycle: a supervisor "
                    "drives the hpnn_serve_desired_workers gauge by "
                    "spawning and retiring local worker processes "
                    "(python -m hpnn_tpu_torch.cli serve_nn --mesh-role "
                    "worker, on this router's --device) within [MIN, MAX] "
                    "(drain, then SIGTERM, on retire; HPNN_AUTOSCALE_EXEC "
                    "replaces the process actions for real fleets)")
    ap.add_argument("--autoscale-cooldown", type=float, default=None,
                    metavar="S",
                    help="least seconds between autoscale actions "
                    "(default $HPNN_AUTOSCALE_COOLDOWN_S or 30)")
    return ap


# serve_nn options of the JAX package that the port refuses with a line of
# their own (argparse would call an unknown option an unrecognized
# argument)
_SERVE_OWN_REFUSALS = {
    "--compile-cache": _COMPILE_CACHE_REFUSAL,
}


def serve_app(argv: list[str]):
    """Parse serve_nn's arguments and build the app: ``(app, args)``, or
    ``(None, rc)`` when the command must exit with ``rc``.  The app's
    kernels are registered and the manifest watchers started; nothing is
    bound yet, so a worker's heartbeat starts in
    :func:`start_mesh_worker`, after the bind."""
    own = [a for a in argv if a.split("=")[0] in _SERVE_OWN_REFUSALS]
    if own:
        key = own[0].split("=")[0]
        sys.stderr.write(f"serve_nn: {key} {_SERVE_OWN_REFUSALS[key]}\n")
        return None, 2
    ap = _serve_parser()
    args, rest = ap.parse_known_intermixed_args(argv)
    if rest:
        # an option neither package knows: argparse's own usage and error
        # lines and exit code 2, as the JAX package's parse_args gives them
        sys.stderr.write(ap.format_usage() + f"{ap.prog}: error: "
                         f"unrecognized arguments: {' '.join(rest)}\n")
        return None, 2
    replicate_to = (args.replicate_to or os.environ.get("HPNN_REPLICATE_TO")
                    or None)
    autoscale = None
    if args.autoscale is not None:
        lo, sep, hi = args.autoscale.partition(":")
        if sep and lo.isdigit() and hi.isdigit() and int(lo) <= int(hi) \
                and int(hi) >= 1:
            autoscale = (int(lo), int(hi))
    for bad, msg in (
            (args.mesh_role == "worker" and not args.router,
             "--mesh-role worker requires --router HOST:PORT"),
            (args.mesh_role == "standby" and not args.primary,
             "--mesh-role standby requires --primary HOST:PORT"),
            (args.slo_availability is not None
             and not 0.0 <= args.slo_availability < 1.0,
             f"--slo-availability must be in [0, 1): "
             f"{args.slo_availability}"),
            (args.slo_p99_ms is not None and args.slo_p99_ms <= 0.0,
             f"--slo-p99-ms must be > 0: {args.slo_p99_ms}"),
            (args.autoscale is not None and args.mesh_role != "router",
             "--autoscale requires --mesh-role router"),
            (args.autoscale is not None and autoscale is None,
             f"--autoscale must be MIN:MAX with 0 <= MIN <= MAX, MAX >= 1: "
             f"{args.autoscale!r}")):
        if bad:
            sys.stderr.write(f"{msg} (ABORTING)\n")
            return None, -1
    from .serve.server import ServeApp

    nn_log.set_verbosity(0)
    for _ in range(args.verbose):
        nn_log.inc_verbosity()
    if runtime.init_all(args.device) != 0:
        runtime.deinit_all()
        return None, -1
    warmup_mode = "off" if args.no_warmup else args.warmup_mode
    if not 0.0 <= args.ab_fraction <= 1.0:
        sys.stderr.write(f"--ab-fraction must be in [0, 1]: "
                         f"{args.ab_fraction} (ABORTING)\n")
        runtime.deinit_all()
        return None, -1
    if args.trace_sample is not None \
            and not 0.0 <= args.trace_sample <= 1.0:
        sys.stderr.write(f"--trace-sample must be in [0, 1]: "
                         f"{args.trace_sample} (ABORTING)\n")
        runtime.deinit_all()
        return None, -1
    from .obs import trace as obs_trace

    # this process's role names its post-mortem dump files
    # (trace-<reason>-<role>-<pid>.ndjson)
    obs_trace.set_role(args.mesh_role or "local")
    auth_token = (args.auth_token or os.environ.get("HPNN_SERVE_TOKEN")
                  or None)
    require_router = (args.require_router
                      or os.environ.get("HPNN_MESH_REQUIRE_ROUTER") == "1")
    app = ServeApp(max_batch=args.max_batch, max_queue_rows=args.queue_rows,
                   linger_s=args.linger_ms / 1e3,
                   default_timeout_s=args.timeout_s, parity=args.parity,
                   fast_threshold=args.fast_threshold,
                   mesh_devices=(None if args.mesh < 0 else args.mesh),
                   device=runtime.lib_runtime.device,
                   auth_token=auth_token, ab_fraction=args.ab_fraction,
                   trace=args.trace or None, trace_sample=args.trace_sample,
                   span_dir=args.span_dir, profile_dir=args.profile_dir,
                   quota_rows=args.quota_rows, quota_burst=args.quota_burst,
                   slo_p99_ms=args.slo_p99_ms,
                   slo_availability=args.slo_availability,
                   require_router=require_router,
                   shed_low=args.shed_low or None)
    router_token = (args.router_token
                    or os.environ.get("HPNN_MESH_ROUTER_TOKEN") or None)
    if args.mesh_role == "router":
        # before add_model: batchers are wired to the worker pool at
        # creation, and a router warms nothing on the card
        app.enable_mesh_router(
            required_workers=max(1, args.workers),
            health_interval_s=args.mesh_health_interval,
            standby_addr=args.standby, router_token=router_token)
        sby = f", standby {args.standby}" if args.standby else ""
        sys.stdout.write(f"SERVE: mesh router (quorum "
                         f"{max(1, args.workers)} worker(s); workers "
                         f"register via POST /v1/mesh/register{sby})\n")
    elif args.mesh_role == "standby":
        # a full mesh router held passive: it mirrors --primary and takes
        # over when the primary stops answering its polls
        app.enable_mesh_standby(
            args.primary, required_workers=max(1, args.workers),
            health_interval_s=args.mesh_health_interval,
            router_token=router_token, takeover_after=args.takeover_after)
        sys.stdout.write(f"SERVE: mesh standby (mirroring {args.primary}; "
                         f"takeover after "
                         f"{app.mesh_standby.takeover_after} missed "
                         "polls)\n")
    n_ok = 0
    for conf in args.confs:
        model = app.add_model(conf, warmup=warmup_mode != "off",
                              background=warmup_mode == "background")
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
    for spec in args.watch_ckpt:
        wname, eq, wdir = spec.partition("=")
        if not eq:
            wname, wdir = "", wname
        if not wname:
            names = app.registry.names()
            if len(names) != 1:
                sys.stderr.write(
                    f"--watch-ckpt {spec}: NAME= is required when "
                    f"{len(names)} kernels are registered (ABORTING)\n")
                app.close(drain=False)
                runtime.deinit_all()
                return None, -1
            wname = names[0]
        if app.registry.get(wname) is None:
            sys.stderr.write(f"--watch-ckpt: unknown kernel '{wname}' "
                             "(ABORTING)\n")
            app.close(drain=False)
            runtime.deinit_all()
            return None, -1
        app.watch_manifest(wname, wdir, interval_s=args.watch_interval)
    if args.jobs > 0:
        from .utils.env import env_int

        app.enable_jobs(args.job_dir, capacity=args.jobs,
                        auto_promote=args.auto_promote,
                        auto_resume=args.job_auto_resume or None,
                        replicate_to=replicate_to,
                        job_workers=args.job_workers
                        or env_int("HPNN_JOB_WORKERS", 1, lo=1))
        jobs = app.jobs
        tok = "on" if auth_token else "OFF (pass --auth-token)"
        promo = ", auto-promote" if args.auto_promote else ""
        res = ", auto-resume" if jobs.auto_resume else ""
        rep = (f", replicate-to={jobs.replicate_to}"
               if jobs.replicate_to else "")
        wrk = (f", workers={jobs.workers} over {jobs.slices.n} device(s)"
               if jobs.workers > 1 else "")
        sys.stdout.write(f"SERVE: online training enabled "
                         f"(queue={args.jobs}, job-dir={args.job_dir}, "
                         f"ab-fraction={args.ab_fraction:g}, "
                         f"auth={tok}{promo}{res}{rep}{wrk})\n")
    elif args.auto_promote:
        sys.stderr.write("serve: --auto-promote is inert without "
                         "--jobs N (ignored)\n")
    args.autoscale_bounds = autoscale
    return app, args


def start_mesh(app, args, port: int) -> None:
    """What serve_nn starts once the socket is bound to ``port``: a
    standby's advertised address (its mirror polls announce it, so a
    surviving active router adopts it), the autoscale supervisor (its
    workers register against this router's real port) and a worker's
    heartbeat (:func:`start_mesh_worker`)."""
    if app.mesh_standby is not None:
        app.mesh_standby.advertise = args.advertise or f"127.0.0.1:{port}"
    if args.autoscale_bounds is not None:
        lo, hi = args.autoscale_bounds
        worker_args = ["--parity", args.parity,
                       "--fast-threshold", str(args.fast_threshold),
                       "-b", str(args.max_batch),
                       "-q", str(args.queue_rows)]
        if args.trace:
            worker_args.append("--trace")
        if args.trace_sample is not None:
            worker_args += ["--trace-sample", str(args.trace_sample)]
        app.enable_autoscale(f"127.0.0.1:{port}", list(args.confs),
                             min_workers=lo, max_workers=hi,
                             cooldown_s=args.autoscale_cooldown,
                             worker_args=tuple(worker_args))
        sys.stdout.write(f"SERVE: autoscale supervisor on [{lo}, {hi}] "
                         f"workers (cooldown "
                         f"{app.autoscaler.cooldown_s:g}s)\n")
    start_mesh_worker(app, args, port)


def start_mesh_worker(app, args, port: int) -> None:
    """With ``--mesh-role worker``, start the heartbeat agent once the
    socket is bound to ``port`` (the advertised default needs it); the
    agent retries until the router is reachable.  A no-op for other
    roles."""
    if args.mesh_role != "worker":
        return
    advertise = args.advertise or f"127.0.0.1:{port}"
    app.enable_mesh_worker(args.router, advertise)
    sys.stdout.write(f"SERVE: mesh worker (router {args.router}, "
                     f"advertising {advertise})\n")


def serve_nn_main(argv: list[str] | None = None) -> int:
    """serve_nn: a long-lived inference server over the same ``.conf``
    files run_nn takes.  SIGTERM/SIGINT drain: admission stops, a running
    training job finishes its epoch, snapshots and lands ``interrupted``,
    every admitted request is answered, then the process exits 0.  The
    flight recorder is dumped on the way out (and on a fault escaping the
    server loop) into the job dir, or the cwd without jobs; with a span
    spool the spool is the post-mortem."""
    import signal
    import threading

    from .serve.server import make_server

    argv = sys.argv[1:] if argv is None else argv
    app, args = serve_app(argv)
    if app is None:
        return args
    httpd = make_server(args.addr, args.port, app)
    host, port = httpd.server_address[:2]
    start_mesh(app, args, port)
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
    dump_dir = args.job_dir if args.jobs > 0 else "."
    dumped = False
    try:
        httpd.serve_forever()
    except Exception:
        from .obs import trace as obs_trace

        path = obs_trace.dump_to_dir(dump_dir, reason="fault")
        dumped = True   # one post-mortem a process, fault-tagged
        if path:
            sys.stderr.write(f"SERVE: flight recorder dumped to {path}\n")
        raise
    finally:
        for sig, old in prev.items():
            signal.signal(sig, old)
        httpd.server_close()
        app.close(drain=True)
        if not dumped:
            _shutdown_dump(app, dump_dir)
        runtime.deinit_all()
    return 0


def _shutdown_dump(app, dump_dir: str) -> None:
    """The drain's post-mortem: with a span spool, the spool itself
    (``app.close`` flushed and rotated every span into finalized
    segments); else the ring dumped as NDJSON into ``dump_dir``."""
    from .obs import trace as obs_trace

    if app.span_exporter is not None:
        from .obs.export import list_segments

        segs = list_segments(app.span_exporter.span_dir)
        path = segs[-1] if segs else None
    else:
        path = obs_trace.dump_to_dir(dump_dir, reason="shutdown")
    if path:
        sys.stdout.write(f"SERVE: flight recorder dumped to {path}\n")
        sys.stdout.flush()


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
