"""train_nn of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs go through both packages:

* float64: the port's ``ops.convergence.train_epoch`` (the CPU route and the
  epoch kernel's plain version) against ``hpnn_tpu.ops.train_epoch`` for
  ANN/SNN/LNN x BP/BPM.  Every n_iter, first_ok and success is identical,
  init_err/final_dep agree within 1e-12 and the weights within 5e-12 (plus
  6e-15 per iteration on SNN: the exp-residual drift model
  tests/test_parity_fuzz.py holds hpnn_tpu to against the C reference).
* float32 and bfloat16: against the Pallas kernel
  ``convergence_pallas.train_epoch_pallas(..., interpret=True)``.  float32
  keeps the envelope of tests/test_pallas_convergence.py:35-57 (success and
  first_ok identical, |dn_iter| <= max(4, 1%), weights within 5e-3).
  bfloat16 keeps success and first_ok identical, |dn_iter| <= max(16, 10%)
  and weights within 5e-3: the per-sample stop is dEp <= 1e-6, so once the
  trajectories differ in the last bit (torch's tanh/exp against XLA's)
  bfloat16's 8-bit mantissa moves the stopping iteration by a few percent
  (3.3% and 6.0% measured on the ANN cases; XLA also keeps excess float32
  precision inside its bfloat16 fusions, where torch rounds every op).
  SNN's error grows to ~10-30 as its non-target outputs go to zero; its
  float32 ULP (1-2e-6) then exceeds delta and the stopping iteration is set
  by rounding noise in any two implementations, so the float32/bfloat16
  SNN cases use a deep net whose samples stop before that regime.
* float64 targets 2^-30 below 1: not the target class in double, through
  ``train_sample`` and ``train_epoch_plain`` against ``hpnn_tpu``'s
  ``train_sample`` and ``train_epoch``.
* the budget contract (start_idx, iter_budget, copied-through rows, -1
  sentinels) against ``_train_epoch_core(..., budgeted=True)``, and
  budgeted host resumes equal to one launch bit for bit.
* ``python -m hpnn_tpu_torch.cli train_nn -v -v -v --device cpu`` against
  ``hpnn_tpu.cli.train_nn_main`` on the four corpora of
  tests/test_parity_fuzz.py: stdout and stderr byte-identical except the
  two debug lines that carry a wall time or the device (``load:``,
  ``runtime:``) and the sign of an effectively-zero final dEp (the same
  normalisation tests/test_reference_parity.py applies); kernel.tmp
  byte-identical; kernel.opt within the parity_fuzz bound.
"""

import contextlib
import glob
import io
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# (kind, train, n_in, hiddens, n_out, conf_seed, n_samples, corpus_seed):
# the tuples of tests/test_parity_fuzz.py:51-56
FUZZ_CASES = [
    ("ANN", "BPM", 8, [3], 1, 1026263659, 2, 11),
    ("ANN", "BP", 2, [3, 6, 8], 3, 791585799, 6, 13),
    ("SNN", "BP", 6, [2, 5], 3, 502935467, 6, 26),
    ("SNN", "BPM", 2, [1], 5, 48314918, 6, 32),
]
# the first two samples of the third corpus: a ~2k-iteration run
SMALL_CASE = ("SNN", "BP", 6, [2, 5], 3, 502935467, 2, 26)


@pytest.fixture(autouse=True)
def _one_thread():
    """The eager loop is dispatch-bound; one intra-op thread keeps it from
    contending with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(kseed, seed, s, n_in, hid, n_out, lo, hi):
    from hpnn_tpu.models.kernel import generate_kernel

    kern, _ = generate_kernel(kseed, n_in, hid, n_out)
    rng = np.random.default_rng(seed)
    xs = rng.uniform(lo, hi, (s, n_in))
    ts = -np.ones((s, n_out))
    ts[np.arange(s), rng.integers(0, n_out, s)] = 1.0
    return kern.weights, xs, ts


# ANN converges in ~1e4 iterations per sample, SNN/LNN in ~1e2-1e3
PROBLEMS = {
    "ANN": (123, 0, 1, 13, [37], 11, -3.0, 3.0),
    "SNN": (123, 0, 3, 12, [9], 5, 0.0, 1.0),
    "LNN": (123, 0, 3, 13, [37], 11, 0.0, 1.0),
    "deep": (7, 1, 2, 10, [8, 6, 7], 4, 0.0, 1.0),
}


def _torch(a, dtype):
    return torch.as_tensor(np.asarray(a, np.float64)).to(dtype).contiguous()


def _port_epoch(w, xs, ts, kind, momentum, dtype):
    from hpnn_tpu_torch.ops import train_epoch

    return train_epoch(tuple(_torch(a, dtype) for a in w), _torch(xs, dtype),
                       _torch(ts, dtype), kind, momentum)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32) if a.dtype == jnp.bfloat16
                      else a, np.float64)


@pytest.mark.parametrize("momentum", [False, True], ids=["BP", "BPM"])
@pytest.mark.parametrize("kind", ["ANN", "SNN", "LNN"])
def test_train_epoch_f64_matches_jax(kind, momentum):
    from hpnn_tpu import ops as jax_ops

    w, xs, ts = _problem(*PROBLEMS[kind])
    jw, jst = jax_ops.train_epoch(tuple(jnp.asarray(a) for a in w),
                                  jnp.asarray(xs), jnp.asarray(ts), kind,
                                  momentum)
    pw, pst = _port_epoch(w, xs, ts, kind, momentum, torch.float64)
    for f in ("n_iter", "first_ok", "success"):
        np.testing.assert_array_equal(np.asarray(getattr(jst, f)),
                                      getattr(pst, f).numpy(), err_msg=f)
    for f in ("init_err", "final_dep"):
        np.testing.assert_allclose(getattr(pst, f).numpy(),
                                   np.asarray(getattr(jst, f)), rtol=0,
                                   atol=1e-12, err_msg=f)
    iters = int(np.asarray(jst.n_iter).sum())
    tol = 5e-12 + (iters * 6e-15 if kind == "SNN" else 0.0)
    werr = max(float(np.abs(np.asarray(a) - b.numpy()).max())
               for a, b in zip(jw, pw))
    assert werr < tol, (werr, tol, iters)
    assert all(b.dtype == torch.float64 for b in pw)


# f64 targets whose largest entry is 2^-30 below 1: not the target class in
# double, so the two-class sample never becomes OK and runs to MAX_ITER
NEAR_ONE = {"two": (4, [3], 2, [0.0, 1.0 - 2.0**-30]),
            "three": (4, [3], 3, [-1.0, 1.0, 1.0 - 2.0**-30])}


@pytest.mark.parametrize("route", ["sample", "epoch"])
@pytest.mark.parametrize("case", sorted(NEAR_ONE))
def test_near_one_f64_target_is_not_the_class(case, route):
    """The target class is the last index with t == 1 compared in double,
    as hpnn_tpu (and the reference) compare it."""
    from hpnn_tpu import ops as jax_ops
    from hpnn_tpu.models.kernel import generate_kernel
    from hpnn_tpu.ops.convergence import train_sample as jax_sample
    from hpnn_tpu_torch.ops.convergence import train_sample
    from hpnn_tpu_torch.ops.convergence_kernel import train_epoch_plain

    n_in, hid, n_out, t = NEAR_ONE[case]
    w, _ = generate_kernel(123, n_in, hid, n_out)
    x = np.random.default_rng(0).uniform(0.0, 1.0, n_in)
    t = np.asarray(t)
    pw = tuple(_torch(a, torch.float64) for a in w.weights)
    jw0 = tuple(jnp.asarray(a) for a in w.weights)
    if route == "sample":
        jw, jst = jax_sample(jw0, jnp.asarray(x), jnp.asarray(t), "ANN",
                             False)
        pw, row = train_sample(pw, _torch(x, torch.float64),
                               _torch(t, torch.float64), "ANN", False)
        want = [int(jst.n_iter), bool(jst.first_ok), bool(jst.success)]
        got = [row[2], bool(row[1]), bool(row[4])]
    else:
        jw, jst = jax_ops.train_epoch(jw0, jnp.asarray(x[None]),
                                      jnp.asarray(t[None]), "ANN", False)
        pw, st = train_epoch_plain(pw, _torch(x[None], torch.float64),
                                   _torch(t[None], torch.float64), "ANN",
                                   False)
        want = [int(jst.n_iter[0]), bool(jst.first_ok[0]),
                bool(jst.success[0])]
        got = [int(st[0, 2]), bool(st[0, 1] > 0.5), bool(st[0, 4] > 0.5)]
    assert got == want
    werr = max(float(np.abs(np.asarray(a) - b.numpy()).max())
               for a, b in zip(jw, pw))
    assert werr < 5e-12, werr


def _pallas(w, xs, ts, kind, momentum, jdt):
    from hpnn_tpu.ops.convergence_pallas import train_epoch_pallas

    return train_epoch_pallas(tuple(jnp.asarray(a, jnp.float32) for a in w),
                              jnp.asarray(xs, jdt), jnp.asarray(ts, jdt),
                              kind, momentum, interpret=True)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind,momentum,problem", [
    ("ANN", False, "ANN"), ("ANN", True, "ANN"),
    ("SNN", False, "deep"), ("SNN", True, "deep")],
    ids=["ANN-BP", "ANN-BPM", "SNN-BP", "SNN-BPM"])
def test_train_epoch_f32_bf16_match_pallas_interpret(kind, momentum, problem,
                                                     dtype):
    kseed, seed, s, *rest = PROBLEMS[problem]
    if dtype == "f32" and problem == "deep":
        s = 1   # the second sample already stops in the noise regime
    w, xs, ts = _problem(kseed, seed, s, *rest)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jw, jst = _pallas(w, xs, ts, kind, momentum, jdt)
    pw, pst = _port_epoch(w, xs, ts, kind, momentum, tdt)
    assert all(b.dtype == torch.float32 for b in pw)   # master weights
    for f in ("first_ok", "success"):
        np.testing.assert_array_equal(np.asarray(getattr(jst, f)),
                                      getattr(pst, f).numpy(), err_msg=f)
    n1 = np.asarray(jst.n_iter, np.float64)
    n2 = pst.n_iter.numpy().astype(np.float64)
    slack = (4, 0.01) if dtype == "f32" else (16, 0.10)
    assert np.all(np.abs(n1 - n2) <= np.maximum(slack[0], slack[1] * n1)), \
        (n1, n2)
    for a, b in zip(jw, pw):
        np.testing.assert_allclose(b.numpy(), _np(a), rtol=0, atol=5e-3)
    np.testing.assert_allclose(pst.init_err.numpy(), _np(jst.init_err),
                               rtol=1e-2, atol=1e-3)


def test_budgeted_launch_matches_pallas_sentinels_and_copy_through():
    """start_idx=2, budget=1: rows before start and after the first trained
    sample keep the -1 sentinel; a second launch from 3 copies rows 0-2
    through and trains row 3 -- as the budgeted Pallas program does."""
    from hpnn_tpu.ops.convergence_pallas import _precision, _train_epoch_core
    from hpnn_tpu_torch.ops.convergence_kernel import train_epoch_kernel

    kseed, seed, _, *rest = PROBLEMS["ANN"]
    w, xs, ts = _problem(kseed, seed, 5, *rest)
    jw0 = tuple(jnp.asarray(a, jnp.float32) for a in w)
    kw = dict(alpha=0.2, delta=-1.0, lr=None, interpret=True,
              precision=_precision(), budgeted=True)
    jw1, jst1 = _train_epoch_core(jw0, jnp.asarray(xs, jnp.float32),
                                  jnp.asarray(ts, jnp.float32), "ANN", False,
                                  ctrl=jnp.asarray([2, 1], jnp.int32), **kw)
    jw2, jst2 = _train_epoch_core(jw1, jnp.asarray(xs, jnp.float32),
                                  jnp.asarray(ts, jnp.float32), "ANN", False,
                                  ctrl=jnp.asarray([3, 1], jnp.int32),
                                  stats_prev=jst1, **kw)
    pw0 = tuple(_torch(a, torch.float32) for a in w)
    x, t = _torch(xs, torch.float32), _torch(ts, torch.float32)
    pw1, pst1 = train_epoch_kernel(pw0, x, t, "ANN", False, start_idx=2,
                                   iter_budget=1)
    pw2, pst2 = train_epoch_kernel(pw1, x, t, "ANN", False, start_idx=3,
                                   iter_budget=1, stats_prev=pst1)
    for jst, pst in ((jst1, pst1), (jst2, pst2)):
        j = np.asarray(jst)[:, :5].astype(np.float64)
        p = pst.numpy()
        trained = j[:, 2] >= 0
        np.testing.assert_array_equal(p[:, 2] >= 0, trained)
        np.testing.assert_array_equal(p[~trained], j[~trained])   # sentinels
        np.testing.assert_array_equal(p[trained][:, [1, 4]],
                                      j[trained][:, [1, 4]])
        assert np.all(np.abs(p[trained, 2] - j[trained, 2])
                      <= np.maximum(4, 0.01 * j[trained, 2]))
    assert (pst1[:2, 2] == -1).all() and (pst1[3:, 2] == -1).all()
    assert pst1[2, 2] >= 1
    assert torch.equal(pst2[2], pst1[2])          # copied through
    assert pst2[3, 2] >= 1 and (pst2[4:, 2] == -1).all()
    for a, b in zip(jw2, pw2):
        np.testing.assert_allclose(b.numpy(), _np(a), rtol=0, atol=5e-3)


@pytest.mark.parametrize("kind,momentum", [("SNN", False), ("SNN", True),
                                           ("LNN", True)])
def test_budgeted_resumes_equal_one_launch_bitwise(monkeypatch, kind,
                                                   momentum):
    from hpnn_tpu_torch.ops import convergence_kernel as ck

    kseed, seed, _, *rest = PROBLEMS["SNN"]
    w, xs, ts = _problem(kseed, seed, 4, *rest)
    pw = tuple(_torch(a, torch.float64) for a in w)
    x, t = _torch(xs, torch.float64), _torch(ts, torch.float64)
    w1, st1 = ck.train_epoch_kernel(pw, x, t, kind, momentum)
    calls = []
    real = ck.train_epoch_kernel

    def counting(*a, **k):
        calls.append(k["start_idx"])
        return real(*a, **k)

    monkeypatch.setattr(ck, "train_epoch_kernel", counting)
    w2, st2 = ck.train_epoch_cuda(pw, x, t, kind, momentum, iter_budget=1)
    assert calls == [0, 1, 2, 3]      # one sample per budgeted launch
    assert all(torch.equal(a, b) for a, b in zip(w1, w2))
    rec = ck.stats_record(st1, torch.float64)
    for f in rec._fields:
        assert torch.equal(getattr(rec, f), getattr(st2, f)), f


def test_cpu_tensors_never_launch_the_kernels():
    from hpnn_tpu_torch.ops.convergence_kernel import train_epoch_kernel
    from hpnn_tpu_torch.ops.kernels import fused_linear_act

    before = (train_epoch_kernel.launches, fused_linear_act.launches)
    w, xs, ts = _problem(*PROBLEMS["SNN"])
    train_epoch_kernel(tuple(_torch(a, torch.float32) for a in w),
                       _torch(xs, torch.float32), _torch(ts, torch.float32),
                       "SNN", True)
    assert (train_epoch_kernel.launches, fused_linear_act.launches) == before


@pytest.mark.parametrize("plan", [0, 1])
def test_forced_plan_on_cpu_tensors_is_the_plain_version(plan):
    """A forced launch plan only matters to the kernel: CPU tensors take the
    plain version and give the same bits with or without it."""
    from hpnn_tpu_torch.ops.convergence_kernel import train_epoch_kernel

    w, xs, ts = _problem(*PROBLEMS["SNN"])
    args = (tuple(_torch(a, torch.float64) for a in w),
            _torch(xs, torch.float64), _torch(ts, torch.float64), "SNN", True)
    before = train_epoch_kernel.launches
    w1, st1 = train_epoch_kernel(*args)
    w2, st2 = train_epoch_kernel(*args, _plan=plan)
    assert train_epoch_kernel.launches == before
    assert all(torch.equal(a, b) for a, b in zip(w1, w2))
    assert torch.equal(st1, st2)


def _bad_args():
    w, xs, ts = _problem(*PROBLEMS["SNN"])
    W = tuple(_torch(a, torch.float64) for a in w)
    X, T = _torch(xs, torch.float64), _torch(ts, torch.float64)
    return {
        "dtype": ((tuple(v.half() for v in W), X.half(), T.half()), {},
                  TypeError),
        "mixed": ((W, X, T.float()), {}, TypeError),
        "contiguity": ((W, X.T.contiguous().T, T), {}, ValueError),
        "shape-chain": ((W[::-1], X, T), {}, ValueError),
        "outputs": ((W, X, T[:, :3].contiguous()), {}, ValueError),
        "stats_prev": ((W, X, T), {"stats_prev": torch.zeros(3, 4)},
                       ValueError),
        "kind": ((W, X, T), {"kind": "XNN"}, ValueError),
    }


@pytest.mark.parametrize("case", ["dtype", "mixed", "contiguity",
                                  "shape-chain", "outputs", "stats_prev",
                                  "kind"])
def test_wrapper_rejects_bad_inputs(case):
    from hpnn_tpu_torch.ops.convergence_kernel import train_epoch_kernel

    args, kw, exc = _bad_args()[case]
    kind = kw.pop("kind", "SNN")
    with pytest.raises(exc):
        train_epoch_kernel(*args, kind, False, **kw)


@pytest.mark.parametrize("device,name", [("cpu", "loop"), ("cuda", "kernel"),
                                         ("cuda:0", "kernel")])
def test_select_train_epoch_routes(device, name):
    from hpnn_tpu_torch import ops

    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        for kind in ("ANN", "SNN", "LNN"):
            fn, got = ops.select_train_epoch(dtype, kind=kind, device=device)
            assert got == name
            assert fn is (ops.train_epoch_cuda if name == "kernel"
                          else ops.train_epoch)


@pytest.mark.parametrize("verbosity", [1, 2, 3])
@pytest.mark.parametrize("kind,momentum", [("ANN", False), ("SNN", False),
                                           ("SNN", True), ("LNN", True)])
def test_render_training_lines_matches_jax(kind, momentum, verbosity):
    """The per-sample grammar, including snn_train_BP's missing verdict,
    skipped files' unterminated headers and the DBG 'bad optimization!'
    line after a final dEp above 0.1."""
    from hpnn_tpu.api import _render_training_lines as jax_render
    from hpnn_tpu.ops import SampleStats as JaxStats
    from hpnn_tpu_torch.api import _render_training_lines as port_render
    from hpnn_tpu_torch.ops import SampleStats

    events = [("TRAINING FILE:              s00\t", 0),
              ("TRAINING FILE:              bad\t", None),
              ("TRAINING FILE:              s01\t", 1),
              ("TRAINING FILE:              s02\t", 2)]
    cols = dict(init_err=[0.5, -12.25, 3.0], first_ok=[True, False, True],
                n_iter=[32, 102400, 7], final_dep=[1e-7, 0.25, -1e-16],
                success=[True, False, False])
    jst = JaxStats(**{k: jnp.asarray(v) for k, v in cols.items()})
    pst = SampleStats(**{k: torch.tensor(v, dtype=torch.float64)
                         if k in ("init_err", "final_dep") else torch.tensor(v)
                         for k, v in cols.items()})
    want = jax_render(events, jst, kind, momentum, verbosity)
    got = port_render(events, pst, kind, momentum, verbosity)
    assert got == want
    if verbosity > 2:
        assert "NN(DBG): bad optimization!" in got[0]


def test_train_nn_dump_failures(tmp_path, monkeypatch, capsys):
    """A kernel.tmp that cannot be written stops before training; a
    kernel.opt that cannot be written prints the reference's kernel.tmp
    message (tests/train_nn.c:243); both exit non-zero."""
    from hpnn_tpu_torch.cli import train_nn_main

    monkeypatch.chdir(tmp_path)
    _write_fuzz_case(tmp_path, *SMALL_CASE)
    for blocked in ("kernel.tmp", "kernel.opt"):
        (tmp_path / blocked).mkdir()
        assert train_nn_main(["-v", "-v", "--device", "cpu",
                              "nn.conf"]) != 0
        io_ = capsys.readouterr()
        assert io_.err.endswith("FAILED to open kernel.tmp for WRITE!\n")
        assert ("N_ITER=" in io_.out) == (blocked == "kernel.opt")
        (tmp_path / blocked).rmdir()


# --- the slice: train_nn end to end ----------------------------------------

def _write_fuzz_case(tmp_path, kind, train, n_in, hiddens, n_out, seed,
                     n_samples, corpus_seed, extra=""):
    rng = np.random.default_rng(corpus_seed)
    for d in ("samples", "tests"):
        (tmp_path / d).mkdir()
        for i in range(n_samples):
            cls = i % n_out
            x = rng.uniform(-3, 3, n_in)
            t = -np.ones(n_out)
            t[cls] = 1.0
            with open(tmp_path / d / f"s{i:02d}", "w") as fp:
                fp.write(f"[input] {n_in}\n"
                         + " ".join(f"{v:8.5f}" for v in x) + "\n")
                fp.write(f"[output] {n_out}\n"
                         + " ".join(f"{v:.1f}" for v in t) + "\n")
    (tmp_path / "nn.conf").write_text(
        f"[name] fuzz\n[type] {kind}\n[init] generate\n[seed] {seed}\n"
        f"[input] {n_in}\n[hidden] {' '.join(map(str, hiddens))}\n"
        f"[output] {n_out}\n[train] {train}\n"
        f"[sample_dir] ./samples\n[test_dir] ./tests\n{extra}")


def _stream(text):
    drop = ("NN(DBG): load:", "NN(DBG): runtime:")
    return "\n".join(line for line in text.split("\n")
                     if not line.startswith(drop)).replace(
        "-0.0000000000", " 0.0000000000")


def _capture(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


def _train_both(tmp_path, argv, port_extra=()):
    """JAX train_nn then the port's, in tmp_path; returns both results with
    each side's kernel.tmp text and kernel.opt weights."""
    import hpnn_tpu.api as jax_api
    from hpnn_tpu.cli import train_nn_main as jax_train
    from hpnn_tpu.io.kernel_io import load_kernel
    from hpnn_tpu_torch.cli import train_nn_main as port_train

    res = []
    for fn, args in ((jax_train, argv),
                     (port_train, [*argv[:-1], "--device", "cpu",
                                   *port_extra, argv[-1]])):
        for f in ("kernel.tmp", "kernel.opt"):
            if (tmp_path / f).exists():
                (tmp_path / f).unlink()
        rc, out, err = _capture(fn, args)
        if jax_api._prefetch_thread is not None:
            jax_api._prefetch_thread.join()
        tmp = (tmp_path / "kernel.tmp").read_text()
        opt = load_kernel(str(tmp_path / "kernel.opt"))
        res.append((rc, out, err, tmp, opt.weights if opt else None))
    return res


@pytest.mark.parametrize("case", range(len(FUZZ_CASES)),
                         ids=[f"{c[0]}-{c[1]}-{len(c[3])}h" for c in
                              FUZZ_CASES])
def test_train_nn_f64_byte_parity_on_fuzz_corpora(tmp_path, monkeypatch,
                                                  case):
    monkeypatch.chdir(tmp_path)
    kind = FUZZ_CASES[case][0]
    _write_fuzz_case(tmp_path, *FUZZ_CASES[case])
    (jrc, jout, jerr, jtmp, jw), (prc, pout, perr, ptmp, pw) = _train_both(
        tmp_path, ["-v", "-v", "-v", "nn.conf"])
    assert jrc == 0 and prc == 0
    assert _stream(pout) == _stream(jout)
    assert perr == jerr
    assert ptmp == jtmp
    assert pout.count("TRAINING FILE:") == FUZZ_CASES[case][6]
    iters = sum(int(m) for m in re.findall(r"N_ITER=\s*(\d+)", jout))
    tol = 5e-12 + (iters * 6e-15 if kind == "SNN" else 0.0)
    werr = max(float(np.abs(a - b).max()) for a, b in zip(jw, pw))
    assert werr < tol, (werr, tol, iters)


@pytest.mark.parametrize("variant", ["default", "native"])
def test_train_nn_lnn(tmp_path, monkeypatch, variant):
    """Default LNN warns twice on stderr and trains as SNN; ``--lnn
    native`` trains the linear head -- both as hpnn_tpu does."""
    monkeypatch.chdir(tmp_path)
    _write_fuzz_case(tmp_path, "LNN", "BP", 6, [2, 5], 3, 502935467, 4, 26,
                     extra="[lnn] native\n" if variant == "native" else "")
    (jrc, jout, jerr, jtmp, jw), (prc, pout, perr, ptmp, pw) = _train_both(
        tmp_path, ["-v", "-v", "nn.conf"])
    assert jrc == prc == 0
    assert pout == jout and perr == jerr and ptmp == jtmp
    n_warn = perr.count("NN(ERR): unimplemented NN type!\n")
    assert n_warn == (2 if variant == "default" else 0)
    assert pout.count("N_ITER=") == 4
    werr = max(float(np.abs(a - b).max()) for a, b in zip(jw, pw))
    assert werr < 5e-12 + 6e-15 * sum(
        int(m) for m in re.findall(r"N_ITER=\s*(\d+)", jout))


def test_train_nn_cg_is_headers_only(tmp_path, monkeypatch):
    """[train] CG is declared but untrainable: every header is printed
    unterminated, nothing trains, rc 0, kernel.opt == kernel.tmp."""
    monkeypatch.chdir(tmp_path)
    _write_fuzz_case(tmp_path, "ANN", "CG", 8, [3], 2, 1026263659, 3, 11)
    (jrc, jout, jerr, jtmp, jw), (prc, pout, perr, ptmp, pw) = _train_both(
        tmp_path, ["-v", "-v", "nn.conf"])
    assert jrc == prc == 0
    assert pout == jout and perr == jerr and ptmp == jtmp
    assert pout.count("TRAINING FILE:") == 3 and "N_ITER" not in pout
    assert all(np.array_equal(a, b) for a, b in zip(jw, pw))


def test_run_nn_of_port_trained_kernel_matches_jax(tmp_path, monkeypatch,
                                                   capsys):
    from hpnn_tpu.cli import run_nn_main as jax_run
    from hpnn_tpu_torch.cli import run_nn, train_nn_main

    monkeypatch.chdir(tmp_path)
    _write_fuzz_case(tmp_path, *SMALL_CASE)
    assert train_nn_main(["--device", "cpu", "nn.conf"]) == 0
    conf = (tmp_path / "nn.conf").read_text().replace(
        "[init] generate", "[init] kernel.opt")
    (tmp_path / "run.conf").write_text(conf)
    capsys.readouterr()
    assert jax_run(["-v", "-v", "run.conf"]) == 0
    jax_io = capsys.readouterr()
    rc, outs = run_nn(["-v", "-v", "--device", "cpu", "run.conf"])
    port_io = capsys.readouterr()
    assert rc == 0 and outs.shape == (2, 3)
    assert port_io.out == jax_io.out and port_io.err == jax_io.err
    assert port_io.out.count("BEST CLASS") == 2


@pytest.mark.parametrize("argv", [["-v", "-v", "--device", "cuda"],
                                  ["-v", "-v"]], ids=["explicit", "default"])
def test_train_nn_cuda_without_gpu_exits_nonzero(tmp_path, monkeypatch,
                                                 capsys, argv):
    from hpnn_tpu_torch.cli import train_nn_main

    monkeypatch.chdir(tmp_path)
    _write_fuzz_case(tmp_path, *SMALL_CASE)
    assert train_nn_main([*argv, "nn.conf"]) != 0
    io_ = capsys.readouterr()
    assert "no GPU is visible" in io_.err and "TRAINING FILE" not in io_.out
    assert not (tmp_path / "kernel.opt").exists()


# the JAX package's train_nn options the port does not have (the
# checkpoint options are ported: tests/test_torch_ckpt.py, a mesh-router
# --replicate-to destination included; the corpus-cache options too:
# test_train_nn_corpus_cache_option below; --model-parallel:
# test_train_nn_model_parallel_option_takes_the_tp_route)
UNPORTED_TRAIN_OPTIONS = {"--compile-cache": "2"}


def test_train_nn_model_parallel_option_takes_the_tp_route(tmp_path,
                                                           monkeypatch):
    """``--model-parallel 2``, once refused, is the row-sharding degree
    (it wins over a conf's [model]); one process clamps it to one shard
    with the JAX package's warning and trains the unsharded route: the
    same kernel.opt bytes as without it."""
    from hpnn_tpu_torch.cli import train_nn_main

    monkeypatch.chdir(tmp_path)
    _write_fuzz_case(tmp_path, *SMALL_CASE, extra="[model] 3\n")
    rc, out, err = _capture(train_nn_main, ["-v", "-v", "--model-parallel",
                                            "2", "--device", "cpu",
                                            "nn.conf"])
    opt = (tmp_path / "kernel.opt").read_text()
    conf = (tmp_path / "nn.conf").read_text()
    (tmp_path / "nn.conf").write_text(conf.replace("[model] 3\n", ""))
    rc0, out0, _ = _capture(train_nn_main, ["-v", "-v", "--device", "cpu",
                                            "nn.conf"])
    warn = "NN(WARN): [model] 2 > 1 visible device(s); using 1\n"
    assert rc == rc0 == 0 and "later slice" not in err
    assert out.index(warn) < out.index("TRAINING FILE")
    assert out.replace(warn, "") == out0
    assert opt == (tmp_path / "kernel.opt").read_text()


@pytest.mark.parametrize("opt", list(UNPORTED_TRAIN_OPTIONS))
def test_train_nn_unported_option_exits_nonzero(tmp_path, monkeypatch,
                                                capsys, opt):
    from hpnn_tpu_torch.cli import train_nn_main

    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        train_nn_main([opt, UNPORTED_TRAIN_OPTIONS[opt], "--device", "cpu",
                       "nn.conf"])
    assert exc.value.code != 0
    assert capsys.readouterr().err.startswith(f"train_nn: {opt} ")
    assert not (tmp_path / "kernel.tmp").exists()


@pytest.mark.parametrize("value", ["cg", "bp", "bpm", "CG", "splx"])
def test_train_nn_trainer_option_parses_like_jax(value):
    """``--trainer`` (refused by the port until the CG trainer came): the
    registry names parse, case-folded, as in the JAX package; another
    value is a syntax error in both."""
    from hpnn_tpu.cli import _parse_args as jax_parse
    from hpnn_tpu_torch.cli import _parse_args as port_parse

    argv = ["--trainer", value, "nn.conf"]
    if value == "splx":
        for parse in (lambda: jax_parse(argv, "train_nn", train=True),
                      lambda: port_parse(argv, "train_nn")):
            with contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(io.StringIO()), \
                    pytest.raises(SystemExit):
                parse()
        return
    with contextlib.redirect_stdout(io.StringIO()):
        _, _, jx = jax_parse(argv, "train_nn", train=True)
        _, px = port_parse(argv, "train_nn")
    assert px["trainer"] == jx["trainer"] == value.lower()


@pytest.mark.parametrize("opt", ["--corpus-cache", "--corpus-cache-max-mb"])
def test_train_nn_corpus_cache_option(tmp_path, monkeypatch, capsys, opt):
    """The corpus-cache options the port once refused: ``--corpus-cache
    DIR`` puts the training and test dirs' packs in DIR (the test dir's
    from the prefetch) and no sibling pack is written;
    ``--corpus-cache-max-mb 1`` caps DIR, evicting an older 2 MB pack but
    never the run's own.  The option holds for the one command."""
    import hpnn_tpu_torch.api as api
    from hpnn_tpu_torch.cli import train_nn_main
    from hpnn_tpu_torch.io import corpus

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("HPNN_NO_CORPUS_CACHE", raising=False)
    monkeypatch.delenv("HPNN_CORPUS_CACHE_MAX_MB", raising=False)
    _write_fuzz_case(tmp_path, *SMALL_CASE)
    cache = tmp_path / "cache"
    argv = ["--corpus-cache", str(cache)]
    if opt == "--corpus-cache-max-mb":
        cache.mkdir()
        old = cache / "corpus-0000old.pack"
        old.write_bytes(b"\0" * (2 << 20))
        os.utime(old, ns=(10**9, 10**9))
        argv += [opt, "1"]
    assert train_nn_main(["-v", "-v", *argv, "--device", "cpu",
                          "nn.conf"]) == 0
    if api._prefetch_thread is not None:
        api._prefetch_thread.join()
    assert capsys.readouterr().out.count("N_ITER=") == 2
    with corpus.cache_settings(str(cache)):
        packs = [corpus.pack_path("samples"), corpus.pack_path("tests")]
    assert all(os.path.isfile(p) for p in packs)
    assert sorted(glob.glob(str(cache / "corpus-*.pack"))) == sorted(packs)
    assert not os.path.exists(tmp_path / ".samples.hpnn.pack")
    assert corpus.pack_path("samples") == str(tmp_path
                                              / ".samples.hpnn.pack")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_train_nn_cli_f32_bf16(tmp_path, monkeypatch, capsys, dtype):
    """[dtype] f32/bf16 train through the CLI: the epoch's float32 master
    weights land in kernel.opt, equal to the plain epoch on the same
    shuffled samples."""
    from hpnn_tpu_torch.api import configure, shuffle_order
    from hpnn_tpu_torch.cli import train_nn_main
    from hpnn_tpu_torch.io.corpus import load_ordered
    from hpnn_tpu_torch.io.kernel_io import load_kernel
    from hpnn_tpu_torch.io.samples import list_sample_dir

    monkeypatch.chdir(tmp_path)
    _write_fuzz_case(tmp_path, *SMALL_CASE, extra=f"[dtype] {dtype}\n")
    assert train_nn_main(["-v", "-v", "--device", "cpu", "nn.conf"]) == 0
    assert capsys.readouterr().out.count("N_ITER=") == 2
    nn = configure("nn.conf")
    names = list_sample_dir(nn.conf.samples)
    _, xs, ts = load_ordered(nn.conf.samples, names,
                             shuffle_order(nn.conf, len(names)), "TRAINING",
                             6, 3)
    from hpnn_tpu_torch.ops import train_epoch

    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    # float32 masters cast once from the kernel's float64 weights
    w, _ = train_epoch(tuple(_torch(a, torch.float32)
                             for a in nn.kernel.weights),
                       _torch(xs, tdt), _torch(ts, tdt), "SNN", False)
    got = load_kernel("kernel.opt").weights
    for a, b in zip(got, w):
        # kernel.opt keeps 15 decimals of the float32 master weights
        np.testing.assert_allclose(a, b.double().numpy(), rtol=0,
                                   atol=1e-14)


def test_train_nn_help_and_flags(tmp_path, monkeypatch, capsys):
    from hpnn_tpu_torch.cli import main, train_nn_main

    monkeypatch.chdir(tmp_path)
    assert train_nn_main(["-h"]) == 0
    text = capsys.readouterr().out
    assert "-x \t" in text and "-S \tnumber of device shards" in text
    assert "ROADMAP" not in text
    _write_fuzz_case(tmp_path, *SMALL_CASE)
    # -x is a no-op, -O/-B are checked and ignored, -S 2 is the row split
    # (one process: one shard, the JAX package's warning), ./nn.conf
    # default
    assert main(["train_nn", "-vvx", "-O", "2", "-B4", "-S", "2",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("N_ITER=") == 2
    assert "[model] 2 > 1 visible device(s); using 1" in out
    assert (tmp_path / "kernel.opt").exists()
    with pytest.raises(SystemExit):
        train_nn_main(["-S", "0", "--device", "cpu"])
