"""The port's ``#PROF`` phases and ``#DBG`` checksums against the JAX
package, on the CPU.

``HPNN_PROFILE=1`` prints ``#PROF: <phase> <secs>`` lines and
``HPNN_DBG_TRACE=1`` the reference's ``#DBG: acc=%.15f`` weight checksums
(``hpnn_tpu_torch/utils/trace.py``).  The same seeded 8-6-3 SNN corpus
(an SNN BPM sample converges in a few hundred iterations of the port's
eager CPU loop) goes
through ``hpnn_tpu.cli`` and the port's CLI with ``--device cpu``:

* the phase names come in the same order for ``train_nn`` per sample, at
  ``--tile 4``, with ``--epochs 2`` and with ``[batch] 4``, and for
  ``run_nn``;
* the ``#DBG`` lines come at the same sites, byte-identical on the same
  f64 weights;
* with ``HPNN_TRACE=1`` as well as both knobs, the console (less the
  ``#PROF``/``#DBG`` lines) and ``kernel.opt`` are byte-identical to the
  untraced run.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from hpnn_tpu_torch.utils.trace import dbg_trace, trace_weights

N_IN, N_HID, N_OUT = 8, 6, 3
N_SAMP = 6
KNOBS = ("HPNN_PROFILE", "HPNN_DBG_TRACE", "HPNN_TRACE")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """One intra-op thread (the eager loop is dispatch-bound), no tracing
    knob leaking in, tracing off before and after."""
    from hpnn_tpu.obs import trace as jax_obs
    from hpnn_tpu_torch.obs import trace as port_obs

    for k in KNOBS + ("HPNN_TRACE_SAMPLE",):
        monkeypatch.delenv(k, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax_obs.disable()
    port_obs.disable()


def _write_corpus(dirpath, rng):
    os.makedirs(dirpath)
    for i in range(N_SAMP):
        cls = i % N_OUT
        x = rng.uniform(-1, 1, N_IN)
        x[cls] += 2.0
        t = np.zeros(N_OUT)
        t[cls] = 1.0
        with open(os.path.join(dirpath, f"s{i:03d}"), "w") as fp:
            fp.write(f"[input] {N_IN}\n"
                     + " ".join(f"{v:7.5f}" for v in x)
                     + f"\n[output] {N_OUT}\n"
                     + " ".join(f"{v:.1f}" for v in t) + "\n")


@pytest.fixture
def corpus(tmp_path, monkeypatch):
    from hpnn_tpu.io import samples as jax_samples

    rng = np.random.default_rng(7)
    _write_corpus(str(tmp_path / "samples"), rng)
    _write_corpus(str(tmp_path / "tests"), rng)
    monkeypatch.chdir(tmp_path)
    # the JAX package's one-time native-IO warning stays out of streams
    monkeypatch.setattr(jax_samples, "_native_warned", True)
    # one data device on the JAX side, as one port process has
    monkeypatch.setenv("HPNN_DP_DEVICES", "1")
    return tmp_path


def _conf(path, extra=""):
    path.write_text(
        "[name] tiny\n[type] SNN\n[init] generate\n[seed] 1234\n"
        f"[input] {N_IN}\n[hidden] {N_HID}\n[output] {N_OUT}\n"
        "[train] BPM\n[sample_dir] ./samples\n[test_dir] ./tests\n"
        + extra)
    return str(path)


def _run(pkg, cmd, argv, env):
    """One CLI run in the cwd with ``env`` set for the call: (rc, stdout,
    kernel.opt bytes or None)."""
    if pkg == "jax":
        from hpnn_tpu import cli
        from hpnn_tpu.utils import nn_log
    else:
        from hpnn_tpu_torch import cli
        from hpnn_tpu_torch.utils import nn_log

        argv = ["--device", "cpu"] + argv
    if os.path.exists("kernel.opt") and cmd == "train_nn":
        os.unlink("kernel.opt")
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            nn_log.set_verbosity(0)
            rc = getattr(cli, f"{cmd}_main")(argv)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    kern = None
    if cmd == "train_nn" and os.path.exists("kernel.opt"):
        with open("kernel.opt", "rb") as fp:
            kern = fp.read()
    return rc, out.getvalue(), kern


def _prof_names(text):
    return re.findall(r"^#PROF: (\S+) [0-9.]+s$", text, re.M)


def test_dbg_trace_reference_format_on_tensors(capsys):
    """'#DBG: acc=%.15f' of the plain f64 sum, for a numpy array and a
    torch tensor of any dtype alike."""
    arr = np.array([[1.25, -0.25], [2.0, 0.5]])
    dbg_trace(arr)
    dbg_trace(torch.tensor(arr), "W0")
    dbg_trace(torch.tensor(arr, dtype=torch.float32), "W1")
    assert capsys.readouterr().out == (
        "#DBG: acc=3.500000000000000\n"
        "#DBG[W0]: acc=3.500000000000000\n"
        "#DBG[W1]: acc=3.500000000000000\n")


def test_trace_weights_off_prints_nothing(capsys, monkeypatch):
    trace_weights([np.ones(3)], "train-in")
    assert capsys.readouterr().out == ""
    monkeypatch.setenv("HPNN_DBG_TRACE", "1")
    trace_weights([np.ones(3), torch.ones(2, 2)], "train-in")
    assert capsys.readouterr().out == (
        "#DBG[train-in W0]: acc=3.000000000000000\n"
        "#DBG[train-in W1]: acc=4.000000000000000\n")


@pytest.mark.parametrize("variant,extra,args", [
    ("per-sample", "", []),
    ("tile4", "", ["--tile", "4"]),
    ("epochs2", "", ["--epochs", "2"]),
    ("batch4", "[batch] 4\n", []),
])
def test_prof_phase_order_train_nn(corpus, variant, extra, args):
    """#PROF phase names in the same order through both packages."""
    conf = _conf(corpus / "nn.conf", extra)
    got = {}
    for pkg in ("jax", "port"):
        rc, out, _ = _run(pkg, "train_nn", ["-vv"] + args + [conf],
                          {"HPNN_PROFILE": "1"})
        assert rc == 0, (pkg, out)
        got[pkg] = _prof_names(out)
    assert got["port"] == got["jax"], got
    assert got["port"][:2] == ["init_all", "configure"]
    assert got["port"][-1] == "train_kernel"


def test_prof_phase_order_run_nn(corpus):
    conf = _conf(corpus / "nn.conf")
    assert _run("jax", "train_nn", [conf], {})[0] == 0
    (corpus / "run.conf").write_text(
        (corpus / "nn.conf").read_text().replace("[init] generate",
                                                 "[init] kernel.opt"))
    got = {}
    for pkg in ("jax", "port"):
        rc, out, _ = _run(pkg, "run_nn", ["-vv", str(corpus / "run.conf")],
                          {"HPNN_PROFILE": "1"})
        assert rc == 0
        got[pkg] = _prof_names(out)
    assert got["port"] == got["jax"] == [
        "init_all", "configure", "warmup", "load_tests", "eval_batch",
        "run_kernel"]


@pytest.mark.parametrize("args", [[], ["--epochs", "2"]])
def test_dbg_lines_f64(corpus, args):
    """The #DBG lines come at the same sites in both packages (the
    checksums keep a multi-epoch run on the restaging route in both);
    train-in is byte-identical (the same generated weights), train-out
    within the trajectories' known f64 drift (tests/test_torch_epochs.py
    holds kernel.opt to 5e-12), and each package's line is the same bytes
    on the same weights."""
    from hpnn_tpu.io.kernel_io import load_kernel
    from hpnn_tpu.utils import trace as jax_trace

    conf = _conf(corpus / "nn.conf")
    got = {}
    for pkg in ("jax", "port"):
        rc, out, _ = _run(pkg, "train_nn", args + [conf],
                          {"HPNN_DBG_TRACE": "1"})
        assert rc == 0
        got[pkg] = [ln for ln in out.splitlines() if ln.startswith("#DBG")]
    epochs = 2 if args else 1
    assert [ln.split("]")[0] for ln in got["port"]] == epochs * [
        "#DBG[train-in W0", "#DBG[train-in W1", "#DBG[train-out W0",
        "#DBG[train-out W1"]
    assert got["port"][:2] == got["jax"][:2]
    for p, j in zip(got["port"], got["jax"]):
        assert p.split(":")[0] == j.split(":")[0]
        assert abs(float(p.split("=")[1]) - float(j.split("=")[1])) < 5e-12
    weights = load_kernel("kernel.opt").weights
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        for w in weights:
            jax_trace.dbg_trace(w, "W")
            dbg_trace(torch.tensor(w), "W")
    lines = buf.getvalue().splitlines()
    assert lines[0::2] == lines[1::2]


@pytest.mark.parametrize("args", [["-vv"], ["-vv", "--epochs", "2"],
                                  ["-vv", "--tile", "4"]])
def test_console_and_kernel_identical_with_tracing(corpus, args):
    """HPNN_TRACE=1 with HPNN_PROFILE and HPNN_DBG_TRACE: the console less
    the #PROF/#DBG lines, and kernel.opt, equal the untraced run's."""
    from hpnn_tpu_torch.obs import trace as obs_trace

    conf = _conf(corpus / "nn.conf")
    rc, plain, kern = _run("port", "train_nn", args + [conf], {})
    assert rc == 0 and kern
    obs_trace.disable()
    rc, traced, kern_t = _run("port", "train_nn", args + [conf],
                              {k: "1" for k in KNOBS})
    assert rc == 0
    assert obs_trace.enabled() and obs_trace.snapshot()
    kept = "".join(ln for ln in traced.splitlines(True)
                   if not ln.startswith(("#PROF", "#DBG")))
    assert kept == plain
    assert kern_t == kern


def test_boosted_ann_first_difference_is_an_exp_ulp(tmp_path):
    """Where the two packages' f64 trajectories first part on the 8-6-3
    ANN BP corpus boosted to 200 (ROADMAP Queue C 7): from the same
    generated weights, two BP iterations of its first sample leave the
    weights bit-identical; the second iteration's fresh forward differs in
    one output activation, because ``exp`` of the same pre-activation
    rounds one ulp apart in XLA and in torch (the expression and its
    order are the same in both); the third iteration's update carries it
    into one weight.  (The #DBG checksums show the run's epoch-1 weights
    apart; an overshooting sample later amplifies the ulp.)"""
    import jax
    import jax.numpy as jnp

    from hpnn_tpu.models.kernel import generate_kernel
    from hpnn_tpu.ops import activations as jax_act
    from hpnn_tpu.ops import steps as jax_steps
    from hpnn_tpu_torch.ops import activations as port_act
    from hpnn_tpu_torch.ops import steps as port_steps
    from test_torch_jobs import write_corpus

    def bits(a):
        return np.asarray(a, np.float64).view(np.int64)

    write_corpus(tmp_path / "s", 8, 5, boost=200.0)
    lines = open(tmp_path / "s" / "s004").read().split("\n")
    x = np.array([float(v) for v in lines[1].split()])
    t = np.array([float(v) for v in lines[3].split()])
    w0 = [np.asarray(w, np.float64)
          for w in generate_kernel(6, 8, [6], 3)[0].weights]
    lr = jax_steps.bp_learn_rate("ANN")
    step = jax.jit(jax_steps.train_step, static_argnames=("kind",))
    wj = tuple(jnp.asarray(w) for w in w0)
    wp = tuple(torch.tensor(w) for w in w0)
    aj = jax.jit(jax_steps.forward, static_argnames=("kind",))(
        wj, jnp.asarray(x), kind="ANN")
    ap = port_steps.forward(wp, torch.tensor(x), "ANN")
    for it in (1, 2, 3):
        wj, aj, _ = step(wj, aj, jnp.asarray(x), jnp.asarray(t), kind="ANN",
                         lr=lr)
        wp, ap, _ = port_steps.train_step(wp, ap, torch.tensor(x),
                                          torch.tensor(t), "ANN", lr)
        w_diff = [np.argwhere(bits(a) != bits(b.numpy())).tolist()
                  for a, b in zip(wj, wp)]
        a_diff = [np.nonzero(bits(a) != bits(b.numpy()))[0].tolist()
                  for a, b in zip(aj, ap)]
        if it == 1:
            assert w_diff == [[], []] and a_diff == [[], []]
        elif it == 2:
            assert w_diff == [[], []] and a_diff == [[], [1]]
            # the same pre-activation through both packages' ann_act
            h0 = np.asarray(aj[0])
            z = np.asarray(wj[1]) @ h0
            zj = jnp.asarray(z)
            hj = np.asarray(jax.jit(jax_act.ann_act)(zj))
            hp = port_act.ann_act(torch.tensor(z)).numpy()
            assert np.nonzero(bits(hj) != bits(hp))[0].tolist() == [1]
            ej = np.asarray(jax.jit(lambda v: jnp.exp(-1.0 * v))(zj))
            ep = torch.exp(-torch.tensor(z)).numpy()
            assert abs(int(bits(ej)[1]) - int(bits(ep)[1])) == 1
        else:
            assert w_diff == [[], [[1, 0]]]


def test_train_and_run_nn_profile_dir(corpus, monkeypatch):
    """``--profile-dir D`` (once refused as a later slice's) wraps the run
    in a torch.profiler capture: ``run_nn`` writes a Chrome trace into D
    with the same stream as without it; a capture already running makes
    ``train_nn`` warn and go on unprofiled with the same kernel.opt, as the
    JAX package's does.  (A profiled ``train_nn`` on the CPU records every
    operator of the eager loop; phase 23 of chip_smoke.py profiles one on
    the card.)"""
    import json

    from hpnn_tpu_torch.obs import profiler

    def busy(out_dir):
        raise profiler.ProfilerBusy("profile already running into elsewhere")

    conf = _conf(corpus / "nn.conf")
    rc, plain, kern = _run("port", "train_nn", ["-v", conf], {})
    with monkeypatch.context() as m:
        m.setattr(profiler, "start", busy)
        rc2, out, kern2 = _run("port", "train_nn",
                               ["-v", "--profile-dir", "prof", conf], {})
    assert rc == rc2 == 0 and kern2 == kern and not os.path.exists("prof")
    assert out == ("NN(WARN): profile: profile already running into "
                   "elsewhere; run continues unprofiled\n" + plain)
    (corpus / "run.conf").write_text(
        (corpus / "nn.conf").read_text().replace("[init] generate",
                                                 "[init] kernel.opt"))
    run = ["-vv", str(corpus / "run.conf")]
    rc, plain, _ = _run("port", "run_nn", run, {})
    rc2, out, _ = _run("port", "run_nn", ["--profile-dir", "prof"] + run, {})
    assert rc == rc2 == 0 and out == plain
    (trace,) = os.listdir("prof")
    assert trace.endswith(".pt.trace.json")
    with open(os.path.join("prof", trace)) as fp:
        assert isinstance(json.load(fp)["traceEvents"], list)
