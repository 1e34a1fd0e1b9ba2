"""The CG trainer of the PyTorch port against the JAX package, on the CPU.

The same numpy-seeded inputs go through ``hpnn_tpu`` and ``hpnn_tpu_torch``
in one process:

* the CG epoch at module level (``train.cg.cg_epoch`` against the JAX
  package's compiled epoch) for ANN, SNN and the native LNN at f64 and f32,
  and the port's batched line search against its step-by-step transcription
  (``line_search_plain``: the JAX loops as Python loops) on the same data;
* ``train_nn --trainer cg --epochs 3`` through both CLIs on
  tests/test_torch_epochs.py's corpus (8-6-3, nine files and two skip
  files), the same conf through ``[trainer] cg`` and ``HPNN_TRAINER``;
* ``HPNN_CG_ITERS``, the state-size-mismatch restart, ``trainer_label``
  and the untrainable ``[train] CG`` fallthrough without the opt-in.

Tolerances, with their reasons:

* f64: the ``-v -v`` stream byte-identical (E0/E1/|g| print to 1e-10) and
  kernel.opt weights within 1e-9.  The gradient is autograd of the same
  chain in both packages, but XLA and torch sum in different orders, so
  the weights differ in the last bits; the line search's comparisons are
  never near a tie at these sizes (measured: 2e-14 at one epoch, 2e-10 at
  three SNN epochs, where CG drives the loss to 0 and the weights grow).
* f32: E1 within 1e-4 relative and the weights within 1e-2.  An f32 loss
  differs between the packages by a few ULPs, and that moves a bracketing
  decision (a probe's ``<`` against the current loss) now and then, so a
  step's length differs by a factor of 2 or a refine third; the loss
  reached is the same to about five digits (measured: 2e-3 on the weights
  of the SNN case, 4e-6 relative on E1).
* the batched search against its transcription: bit-identical (the same
  probes, the same comparisons).
"""

import os
import re

import numpy as np
import pytest
import torch

from test_torch_epochs import VARIANTS, _jax, _port, _setup, _weights

SHAPES = ((5, 6), (3, 5))
KINDS = ("ANN", "SNN", "LNN")
CG_VARIANTS = {
    "ANN": ("ANN-BP", ""),
    "SNN": ("SNN-BP", ""),
    "LNN-native": ("LNN-native", ""),
    "ANN-f32": ("ANN-BP", "[dtype] f32\n"),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(kind, seed=0, s=12):
    rng = np.random.default_rng(seed)
    ws = [rng.uniform(-1, 1, sh) for sh in SHAPES]
    xs = rng.uniform(-1, 1, (s, SHAPES[0][1]))
    low = -1.0 if kind == "ANN" else 0.0
    ts = np.where(rng.uniform(size=(s, SHAPES[-1][0])) > 0.5, 1.0, low)
    return ws, xs, ts


def _jax_epoch(kind, ws, xs, ts, np_dtype, iters=8):
    import jax.numpy as jnp

    from hpnn_tpu.train import cg as jcg

    total = sum(int(np.prod(s)) for s in SHAPES)
    fn = jcg._compiled_epoch(SHAPES, kind, iters, jnp.dtype(np_dtype).name)
    flat = jnp.concatenate([jnp.asarray(w, np_dtype).reshape(-1)
                            for w in ws])
    z = jnp.zeros(total, np_dtype)
    out = fn(flat, z, z, jnp.asarray(False), jnp.int32(0),
             jnp.asarray(xs, np_dtype), jnp.asarray(ts, np_dtype))
    return [np.asarray(v, np.float64) for v in out]


def _port_epoch(kind, ws, xs, ts, dtype, iters=8, plain=False):
    from hpnn_tpu_torch.train import cg

    total = sum(int(np.prod(s)) for s in SHAPES)
    flat = torch.cat([torch.as_tensor(w).to(dtype).reshape(-1) for w in ws])
    z = torch.zeros(total, dtype=dtype)
    out = cg.cg_epoch(flat, z, z.clone(), torch.tensor(False),
                      torch.tensor(0, dtype=torch.int32),
                      torch.as_tensor(xs).to(dtype),
                      torch.as_tensor(ts).to(dtype), kind, SHAPES, iters,
                      plain=plain)
    return [v.double().numpy() for v in out]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_cg_epoch_matches_jax(kind, prec):
    """One 8-iteration CG epoch from the same weights: flat weights,
    direction, gradient, E0, E1, |g| and the restart count."""
    ws, xs, ts = _problem(kind)
    np_dt, dt = ((np.float64, torch.float64) if prec == "f64"
                 else (np.float32, torch.float32))
    j = _jax_epoch(kind, ws, xs, ts, np_dt)
    p = _port_epoch(kind, ws, xs, ts, dt)
    assert int(j[6]) == int(p[6])
    if prec == "f64":
        assert np.abs(j[0] - p[0]).max() < 1e-9
        for a, b in zip(j[3:6], p[3:6]):
            assert abs(float(a) - float(b)) < 1e-12
    else:
        assert np.abs(j[0] - p[0]).max() < 1e-2
        assert abs(float(j[4]) - float(p[4])) <= 1e-4 * abs(float(j[4]))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_batched_line_search_equals_transcription(kind, prec):
    """The epoch with the batched search and with the transcribed one:
    bit-identical on the CPU, where a probe's loss does not depend on the
    probes evaluated beside it."""
    ws, xs, ts = _problem(kind, seed=3)
    dt = torch.float64 if prec == "f64" else torch.float32
    a = _port_epoch(kind, ws, xs, ts, dt)
    b = _port_epoch(kind, ws, xs, ts, dt, plain=True)
    for u, v in zip(a, b):
        assert np.array_equal(u, v)


def _phi_cases():
    """Loss curves along a search direction, each a function of the step
    vector: a quadratic with its minimum at 0.3 (shrink then refine), one
    at 37 (grow), one that never improves (no step), one improving only
    below 2^-20 (a long shrink), a plateau (ties everywhere) and a NaN
    beyond t = 2 (NaN probes stop both loops)."""
    return {
        "quad": lambda t: (t - 0.3) ** 2,
        "far": lambda t: (t - 37.0) ** 2,
        "flat_up": lambda t: 1.0 + t,
        "tiny": lambda t: (t - 2.0 ** -21) ** 2,
        "plateau": lambda t: torch.zeros_like(t),
        "nan": lambda t: torch.where(t > 2.0, torch.full_like(t, np.nan),
                                     (t - 1.5) ** 2),
    }


@pytest.mark.parametrize("case", list(_phi_cases()))
def test_line_search_probes_match_transcription(case):
    """The batched search evaluates every probe the JAX loops visit: the
    transcription's halving and doubling probes are prefixes of its probe
    vectors, its refine pairs and final probe are the batched search's
    own, in order, and both return the same step.  The JAX search itself
    (jax.numpy, the same curve) returns that step too."""
    import jax.numpy as jnp

    from hpnn_tpu.train.cg import _line_search as jax_search
    from hpnn_tpu_torch.train.cg import line_search, line_search_plain

    f = _phi_cases()[case]
    l0 = f(torch.zeros(1, dtype=torch.float64))
    seen_b, seen_p = [], []

    def rec(into):
        def phis(tv):
            into.append(tv.clone())
            return f(tv)
        return phis

    tb = line_search(rec(seen_b), l0)
    tp = line_search_plain(rec(seen_p), l0)
    assert torch.equal(tb, tp)
    plain = [float(v) for v in torch.cat(seen_p)]
    halving, doubling = seen_b[0].tolist(), seen_b[1].tolist()
    k = 1
    while k < len(plain) and plain[k] == plain[k - 1] * 0.5:
        k += 1
    assert plain[:k] == halving[:k]
    rest = plain[k:]
    j = 0
    while j < len(rest) and j < len(doubling) and rest[j] == doubling[j]:
        j += 1
    assert j >= 1
    tail = [float(v) for v in torch.cat(seen_b[2:])]
    assert rest[j:] == tail
    jt = jax_search(lambda w: _jnp_phi(case, w),
                    jnp.zeros((1,), jnp.float64),
                    jnp.ones((1,), jnp.float64), float(l0))
    assert float(jt) == float(tb)


def _jnp_phi(case, w):
    """The curves of :func:`_phi_cases` in jax.numpy, of the weights
    f + t*d with f = 0 and d = 1 (so w is t)."""
    import jax.numpy as jnp

    t = w[0]
    return {
        "quad": (t - 0.3) ** 2,
        "far": (t - 37.0) ** 2,
        "flat_up": 1.0 + t,
        "tiny": (t - 2.0 ** -21) ** 2,
        "plateau": jnp.zeros_like(t),
        "nan": jnp.where(t > 2.0, jnp.nan, (t - 1.5) ** 2),
    }[case]


def _cg_line(out):
    return re.findall(r"TRAINING CG\t samples=\s*\d+ iters=\s*\d+ .*\n", out)


@pytest.mark.parametrize("variant", list(CG_VARIANTS))
def test_train_nn_cg_matches_jax(tmp_path, monkeypatch, variant):
    """``train_nn -v -v --trainer cg --epochs 3``: one TRAINING CG line an
    epoch; at f64 the streams byte-identical and kernel.opt within 1e-9,
    at f32 the f32 envelope of the module docstring."""
    base, extra = CG_VARIANTS[variant]
    kind, train, conf_extra, _ = VARIANTS[base]
    VARIANTS["_cg"] = (kind, train, conf_extra + extra, ())
    try:
        _setup(tmp_path, monkeypatch, "_cg")
    finally:
        VARIANTS.pop("_cg")
    argv = ["-v", "-v", "--epochs", "3", "--trainer", "cg", "nn.conf"]
    j = _jax(argv, {"HPNN_DP_DEVICES": "1"})
    p = _port(argv)
    assert j[0] == p[0] == 0, p[2]
    assert p[3] == j[3]                    # kernel.tmp
    assert len(_cg_line(p[1])) == 3
    assert "TRAINING FILE" not in p[1]
    werr = max(float(np.abs(a - b).max())
               for a, b in zip(_weights(j[4]), _weights(p[4])))
    if extra:
        assert werr < 1e-2
        ej = [float(m) for m in re.findall(r"E1=\s*([-\d.]+)", j[1])]
        ep = [float(m) for m in re.findall(r"E1=\s*([-\d.]+)", p[1])]
        assert np.allclose(ep, ej, rtol=1e-4, atol=1e-9)
    else:
        assert p[1] == j[1] and p[2] == j[2]
        assert werr < 1e-9


@pytest.mark.parametrize("route", ["conf", "flag", "env", "env-native"])
def test_cg_opt_in_routes_train_like_jax(tmp_path, monkeypatch, route):
    """A ``[train] CG`` conf trains with CG through ``[trainer] cg``,
    ``--trainer cg``, ``HPNN_TRAINER=cg`` and ``HPNN_TRAINER=native`` --
    the environment route used to fall through to the untrainable
    reference branch in the port (unterminated headers, exit 0, an
    unchanged kernel)."""
    conf_extra = "[trainer] cg\n" if route == "conf" else ""
    VARIANTS["_cg"] = ("ANN", "CG", conf_extra, ())
    try:
        _setup(tmp_path, monkeypatch, "_cg")
    finally:
        VARIANTS.pop("_cg")
    argv = ["-v", "-v", "nn.conf"]
    env = {"HPNN_DP_DEVICES": "1"}
    if route == "flag":
        argv = ["-v", "-v", "--trainer", "cg", "nn.conf"]
    elif route.startswith("env"):
        env["HPNN_TRAINER"] = "native" if route == "env-native" else "cg"
    j = _jax(argv, env)
    p = _port(argv, env)
    assert j[0] == p[0] == 0
    assert p[1] == j[1] and p[2] == j[2]
    assert len(_cg_line(p[1])) == 1
    assert p[4] != p[3]                    # the kernel trained


def test_cg_conf_without_opt_in_keeps_reference_fallthrough(tmp_path,
                                                           monkeypatch):
    """Without an opt-in a ``[train] CG`` conf keeps the reference's
    untrainable branch in both packages: every header unterminated,
    nothing trained, exit 0."""
    VARIANTS["_cg"] = ("ANN", "CG", "", ())
    try:
        _setup(tmp_path, monkeypatch, "_cg")
    finally:
        VARIANTS.pop("_cg")
    monkeypatch.delenv("HPNN_TRAINER", raising=False)
    j = _jax(["-v", "-v", "nn.conf"])
    p = _port(["-v", "-v", "nn.conf"])
    assert j[0] == p[0] == 0 and p[1] == j[1] and p[2] == j[2]
    assert "TRAINING CG" not in p[1]
    assert p[4] == p[3]


@pytest.mark.parametrize("train", ["BP", "BPM", "CG", "SPLX"])
def test_trainer_label_matches_jax(train):
    """``trainer_label`` answers the registry name of the conf's [train]
    ("cg" for CG; it answered "none" in the port), and the registries
    hold the same trainers."""
    from hpnn_tpu.io.conf import NNConf as JConf
    from hpnn_tpu.train import trainer_label as jlabel
    from hpnn_tpu.train import trainer_names as jnames
    from hpnn_tpu_torch.io.conf import NNConf
    from hpnn_tpu_torch.train import trainer_label, trainer_names

    value = {"BP": "BP", "BPM": "BPM", "CG": "CG", "SPLX": "SPLX"}[train]
    jc, pc = JConf(), NNConf()
    jc.train = pc.train = value
    assert trainer_label(pc) == jlabel(jc)
    assert trainer_names() == jnames() == ["bp", "bpm", "cg"]
    if train == "CG":
        assert trainer_label(pc) == "cg"


@pytest.mark.parametrize("trainer,env,want", [
    ("cg", "", "cg"), ("", "cg", "cg"), ("", "native", "cg"),
    ("", "0", None), ("", "", None), ("bp", "", None), ("", "bpm", None)])
def test_native_trainer_gate_matches_jax(monkeypatch, trainer, env, want):
    from hpnn_tpu.io.conf import NNConf as JConf
    from hpnn_tpu.train import native_trainer as jnative
    from hpnn_tpu_torch.io.conf import NNConf
    from hpnn_tpu_torch.train import native_trainer

    monkeypatch.setenv("HPNN_TRAINER", env)
    jc, pc = JConf(), NNConf()
    jc.train = pc.train = "CG"
    jc.trainer = pc.trainer = trainer
    got, jgot = native_trainer(pc), jnative(jc)
    assert (got and got.name) == (jgot and jgot.name) == want


@pytest.mark.parametrize("raw", ["", "3", "0", "-2", "abc", "2.5"])
def test_cg_iters_env_matches_jax(monkeypatch, capsys, raw):
    """``HPNN_CG_ITERS``: default 8, at least 1, and the same warning (and
    default) on a value that is not an integer."""
    from hpnn_tpu.train.cg import cg_iters_per_epoch as jiters
    from hpnn_tpu.utils import nn_log as jlog
    from hpnn_tpu_torch.train.cg import cg_iters_per_epoch
    from hpnn_tpu_torch.utils import nn_log

    monkeypatch.setenv("HPNN_CG_ITERS", raw)
    jlog.set_verbosity(1)
    nn_log.set_verbosity(1)
    try:
        j = jiters()
        jout = capsys.readouterr()
        p = cg_iters_per_epoch()
        pout = capsys.readouterr()
    finally:
        jlog.set_verbosity(0)
        nn_log.set_verbosity(0)
    assert p == j
    assert (pout.out, pout.err) == (jout.out, jout.err)
    if raw in ("abc", "2.5"):
        assert "is not an integer" in pout.out + pout.err and p == 8


def test_cg_iters_env_sets_the_epoch(tmp_path, monkeypatch):
    """``HPNN_CG_ITERS=3`` runs three iterations an epoch in both packages
    (the TRAINING CG line says so) with the same stream."""
    VARIANTS["_cg"] = ("SNN", "CG", "", ())
    try:
        _setup(tmp_path, monkeypatch, "_cg")
    finally:
        VARIANTS.pop("_cg")
    env = {"HPNN_CG_ITERS": "3", "HPNN_DP_DEVICES": "1"}
    argv = ["-v", "-v", "--trainer", "cg", "nn.conf"]
    j = _jax(argv, env)
    p = _port(argv, env)
    assert p[1] == j[1] and "iters=   3" in p[1]


def test_cg_state_size_mismatch_restarts_clean(capsys):
    """A snapshot whose cg_* vectors do not match the parameter count warns
    and restarts from steepest descent (as the JAX package's
    tests/test_ckpt.py pins for it): the epoch equals a fresh one, and a
    correctly sized state is written back."""
    from hpnn_tpu_torch.train.cg import run_cg_epoch
    from hpnn_tpu_torch.utils import nn_log

    class NN:
        pass

    def epoch(state):
        nn = NN()
        nn.conf = type("C", (), {"batch": 0, "seed": 1})()
        nn.trainer_state = state
        ws, xs, ts = _problem("LNN", seed=5, s=4)
        out = run_cg_epoch(nn, [torch.as_tensor(w) for w in ws],
                           torch.as_tensor(xs), torch.as_tensor(ts), "LNN",
                           torch.float64)
        return nn, out

    nn_log.set_verbosity(1)
    try:
        nn, out = epoch({"cg_d": np.zeros(5), "cg_g": np.zeros(5),
                         "cg_meta": np.asarray([1, 0, 8], np.int64)})
        warn = capsys.readouterr()
        fresh_nn, fresh = epoch(None)
    finally:
        nn_log.set_verbosity(0)
    assert "CG state size mismatch" in warn.out + warn.err
    assert tuple(w.shape for w in out) == SHAPES
    assert nn.trainer_state["cg_d"].shape == (sum(a * b for a, b in SHAPES),)
    for a, b in zip(out, fresh):
        assert torch.equal(a, b)
    assert np.array_equal(nn.trainer_state["cg_d"],
                          fresh_nn.trainer_state["cg_d"])


def test_cg_bf16_runs_on_f32_masters_like_jax(tmp_path, monkeypatch):
    """``[dtype] bf16`` runs CG on the f32 masters throughout, in both
    packages: the port's bf16 CG run equals its own f32 CG run bit for bit,
    and the JAX package's bf16 run within the f32 envelope."""
    VARIANTS["_cg"] = ("ANN", "CG", "[dtype] bf16\n", ())
    try:
        _setup(tmp_path, monkeypatch, "_cg")
    finally:
        VARIANTS.pop("_cg")
    argv = ["-v", "-v", "--trainer", "cg", "nn.conf"]
    j = _jax(argv, {"HPNN_DP_DEVICES": "1"})
    p = _port(argv)
    conf = open("nn.conf").read()
    with open("nn.conf", "w") as fp:
        fp.write(conf.replace("[dtype] bf16", "[dtype] f32"))
    p32 = _port(argv)
    assert p[0] == p32[0] == j[0] == 0
    assert p[1] == p32[1] and p[4] == p32[4]
    werr = max(float(np.abs(a - b).max())
               for a, b in zip(_weights(j[4]), _weights(p[4])))
    assert werr < 1e-2
