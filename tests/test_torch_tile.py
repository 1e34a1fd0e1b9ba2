"""train_nn --tile of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs go through both packages:

* float64: the port's ``train_epoch_tiled`` (the CPU route and the
  ``train_tile`` kernel's plain version) against
  ``hpnn_tpu.ops.convergence_tile.train_epoch_tiled(route="xla")`` for
  ANN/SNN/native LNN x BP/BPM x tile 1, 3 and 4 over 6 samples (the last two
  ragged).  Every n_iter, first_ok and success is identical, init_err and
  final_dep agree within 1e-12 and the weights within 5e-12 (plus 6e-15 per
  iteration on SNN: the bound tests/test_parity_fuzz.py holds hpnn_tpu to
  against the C reference).
* float32 and bfloat16 at storage None: against the Pallas route in
  interpret mode (tile 1 and 4) on a bounded trajectory (delta=1e9: each
  lane stops once its argmax is right past MIN), with the envelopes
  tests/test_torch_train.py holds the per-sample float32/bfloat16 epoch to:
  first_ok and success identical; float32 |dn_iter| <= max(4, 1%),
  bfloat16 <= max(16, 10%) (torch's tanh/exp against XLA's move bfloat16's
  stopping iteration); weights within 5e-3.
* storage "bf16" and "f32": against JAX at the same storage on the bounded
  32-iteration trajectory of tests/test_tile_convergence.py:142-200, inside
  its ULP envelopes (512 bfloat16 ULP, 64 float32 ULP) of JAX's weights.
* tile=1 against the port's per-sample ``train_epoch`` at float64 (not bit
  for bit on the CPU: torch's gemm and gemv may order sums differently; the
  bitwise contract is the card's, checked by chip_smoke.py).
* ``launch_groups``, ``select_train_epoch``'s tile axis, the wrapper's
  checks, the autotuner's cache, and ``train_nn -v -v -v --device cpu``
  with ``[tile]``, ``--tile``, ``HPNN_TILE`` and ``--tile auto`` against
  ``hpnn_tpu.cli.train_nn_main``: stdout and stderr byte-identical (minus
  the lines tests/test_torch_train.py strips and the autotune debug line,
  which names the port's route), kernel.tmp byte-identical, kernel.opt
  within the parity_fuzz bound.
* ``[batch]``, ``[model]`` and ``[trainer] cg`` confs, which the port
  once refused, take their routes (``[model]`` in one process: one shard,
  with the JAX package's warning).
"""

import json
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_train import (FUZZ_CASES, SMALL_CASE, _capture, _stream,
                              _torch, _train_both, _write_fuzz_case)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, n_in, hid, n_out, n, lo=0.0, hi=1.0):
    from hpnn_tpu.models.kernel import generate_kernel

    kern, _ = generate_kernel(seed, n_in, list(hid), n_out)
    rng = np.random.default_rng(seed)
    xs = rng.uniform(lo, hi, (n, n_in))
    ts = -np.ones((n, n_out))
    ts[np.arange(n), rng.integers(0, n_out, n)] = 1.0
    return kern.weights, xs, ts


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32) if a.dtype == jnp.bfloat16
                      else a, np.float64)


def _jax_tiled(w, xs, ts, kind, momentum, jdt, wdt=None, **kw):
    from hpnn_tpu.ops.convergence_tile import train_epoch_tiled

    return train_epoch_tiled(tuple(jnp.asarray(a, wdt or jdt) for a in w),
                             jnp.asarray(xs, jdt), jnp.asarray(ts, jdt), kind,
                             momentum, **kw)


def _port_tiled(w, xs, ts, kind, momentum, dtype, wdt=None, **kw):
    from hpnn_tpu_torch.ops import train_epoch_tiled

    return train_epoch_tiled(tuple(_torch(a, wdt or dtype) for a in w),
                             _torch(xs, dtype), _torch(ts, dtype), kind,
                             momentum, **kw)


# ANN and LNN stop on a looser dEp than the reference's 1e-6 (which takes
# ~1e5 iterations for ANN here); SNN keeps the reference's delta
F64_DELTA = {"ANN": 1e-3, "SNN": -1.0, "LNN": 1e-5}


@pytest.mark.parametrize("tile", [1, 3, 4])
@pytest.mark.parametrize("momentum", [False, True], ids=["BP", "BPM"])
@pytest.mark.parametrize("kind", ["ANN", "SNN", "LNN"])
def test_tiled_f64_matches_jax_xla(kind, momentum, tile):
    w, xs, ts = _problem(7, 9, [8], 3, 6)
    delta = F64_DELTA[kind]
    jw, jst = _jax_tiled(w, xs, ts, kind, momentum, jnp.float64, tile=tile,
                         route="xla", delta=delta)
    pw, pst = _port_tiled(w, xs, ts, kind, momentum, torch.float64,
                          tile=tile, delta=delta)
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


@pytest.mark.parametrize("tile", [1, 4])
@pytest.mark.parametrize("momentum", [False, True], ids=["BP", "BPM"])
@pytest.mark.parametrize("kind", ["ANN", "SNN"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tiled_f32_bf16_match_pallas_interpret(dtype, kind, momentum, tile):
    w, xs, ts = _problem(7, 7, [6, 5], 4, 6)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jw, jst = _jax_tiled(w, xs, ts, kind, momentum, jdt, wdt=jnp.float32,
                         tile=tile, route="pallas", interpret=True,
                         delta=1e9)
    pw, pst = _port_tiled(w, xs, ts, kind, momentum, tdt,
                          wdt=torch.float32, tile=tile, delta=1e9)
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


def _aligned_problem(seed, n):
    """tests/test_tile_convergence.py:142-155: targets on the net's
    initial argmax, so with delta=1e9 every lane stops at MIN_BP_ITER+1."""
    from hpnn_tpu.models.kernel import generate_kernel

    kern, _ = generate_kernel(seed, 16, [12], 4)
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 1, (n, 16))
    v = xs
    for w in kern.weights:
        v = np.tanh(v @ np.asarray(w, np.float64).T)
    ts = -np.ones((n, 4))
    ts[np.arange(n), v.argmax(axis=1)] = 1.0
    return kern.weights, xs, ts


def _max_ulp(ref, got, mant_bits):
    """tests/test_tile_convergence.py:158-168."""
    worst = 0.0
    for a, b in zip(ref, got):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        mag = np.maximum(np.abs(a), 1e-30)
        ulp = 2.0 ** (np.floor(np.log2(mag)) - (mant_bits - 1))
        worst = max(worst, float((np.abs(a - b) / ulp).max()))
    return worst


@pytest.mark.parametrize("storage,jdt,tdt,wdt,mant,limit", [
    ("bf16", jnp.float32, torch.float32, torch.bfloat16, 8, 512.0),
    ("f32", jnp.float64, torch.float64, torch.float32, 24, 64.0)])
def test_storage_modes_match_jax_within_ulp_envelope(storage, jdt, tdt, wdt,
                                                     mant, limit):
    w, xs, ts = _aligned_problem(5, 8)
    jw, jst = _jax_tiled(w, xs, ts, "ANN", False, jdt, tile=8, route="xla",
                         storage=storage, delta=1e9)
    pw, pst = _port_tiled(w, xs, ts, "ANN", False, tdt, tile=8,
                          storage=storage, delta=1e9)
    assert all(b.dtype == wdt for b in pw)
    np.testing.assert_array_equal(np.asarray(jst.n_iter), pst.n_iter.numpy())
    assert int(pst.n_iter.max()) <= 40   # the bounded regime
    assert _max_ulp([_np(a) for a in jw], [b.double() for b in pw],
                    mant) < limit


@pytest.mark.parametrize("kind", ["ANN", "SNN", "LNN"])
def test_plain_tile1_matches_per_sample_epoch_f64(kind):
    from hpnn_tpu_torch.ops import train_epoch

    w, xs, ts = _problem(7, 9, [8], 3, 4)
    delta = F64_DELTA[kind]
    pw, pst = _port_tiled(w, xs, ts, kind, True, torch.float64, tile=1,
                          delta=delta)
    sw, sst = train_epoch(tuple(_torch(a, torch.float64) for a in w),
                          _torch(xs, torch.float64),
                          _torch(ts, torch.float64), kind, True, delta=delta)
    for f in ("n_iter", "first_ok", "success"):
        assert torch.equal(getattr(pst, f), getattr(sst, f)), f
    for f in ("init_err", "final_dep"):
        np.testing.assert_allclose(getattr(pst, f).numpy(),
                                   getattr(sst, f).numpy(), rtol=0,
                                   atol=1e-12)
    for a, b in zip(pw, sw):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=5e-12)


@pytest.mark.parametrize("launch_groups", [1, 2])
def test_launch_groups_equal_one_launch_bitwise(monkeypatch, launch_groups):
    from hpnn_tpu_torch.ops import convergence_tile_kernel as ck
    from hpnn_tpu_torch.ops import train_epoch_tiled

    w, xs, ts = _problem(7, 9, [8], 3, 7)
    args = (tuple(_torch(a, torch.float64) for a in w),
            _torch(xs, torch.float64), _torch(ts, torch.float64), "SNN",
            True)
    w1, s1 = train_epoch_tiled(*args, tile=2)
    starts = []
    real = ck.train_tile

    def counting(*a, **k):
        starts.append(k["start_group"])
        return real(*a, **k)

    monkeypatch.setattr(ck, "train_tile", counting)
    w2, s2 = train_epoch_tiled(*args, tile=2, launch_groups=launch_groups)
    assert starts == list(range(0, 4, launch_groups))
    assert all(torch.equal(a, b) for a, b in zip(w1, w2))
    for f in s1._fields:
        assert torch.equal(getattr(s1, f), getattr(s2, f)), f


def test_plain_group_budget_sentinels_and_copy_through():
    """A launch of one group from group 1 leaves the other rows at the
    n_iter = -1 sentinel; a second launch from group 2 copies them
    through."""
    from hpnn_tpu_torch.ops import train_tile

    w, xs, ts = _problem(7, 9, [8], 3, 5)
    pw = tuple(_torch(a, torch.float64) for a in w)
    x, t = _torch(xs, torch.float64), _torch(ts, torch.float64)
    w1, st1 = train_tile(pw, x, t, "SNN", False, tile=2, start_group=1,
                         group_budget=1)
    assert (st1[[0, 1, 4], 2] == -1).all() and (st1[2:4, 2] >= 1).all()
    _, st2 = train_tile(w1, x, t, "SNN", False, tile=2, start_group=2,
                        group_budget=5, stats_prev=st1)
    assert torch.equal(st2[:4], st1[:4]) and st2[4, 2] >= 1


@pytest.mark.parametrize("device,name", [("cpu", "tile-loop"),
                                         ("cuda", "tile-kernel"),
                                         ("cuda:0", "tile-kernel")])
def test_select_train_epoch_tile_axis(device, name):
    from hpnn_tpu_torch import ops

    fn, got = ops.select_train_epoch(torch.float32, kind="SNN",
                                     device=device, tile=4, storage="bf16")
    assert got == name
    assert fn.func is ops.train_epoch_tiled
    assert fn.keywords == {"tile": 4, "storage": "bf16"}
    assert ops.select_train_epoch(torch.float32, device=device)[1] == (
        "kernel" if device != "cpu" else "loop")
    with pytest.raises(ValueError):
        ops.select_train_epoch(torch.float32, device=device, tile=-1)
    if device == "cpu":
        w, xs, ts = _problem(3, 10, [8], 3, 5)
        _, st = fn(tuple(_torch(a, torch.float32) for a in w),
                   _torch(xs, torch.float32), _torch(ts, torch.float32),
                   "SNN", False)
        assert st.n_iter.shape == (5,) and int(st.n_iter.min()) > 0


def test_cpu_tensors_never_launch_the_tile_kernel():
    from hpnn_tpu_torch.ops import train_tile

    before = train_tile.launches
    w, xs, ts = _problem(3, 10, [8], 3, 5)
    train_tile(tuple(_torch(a, torch.float32) for a in w),
               _torch(xs, torch.float32), _torch(ts, torch.float32), "SNN",
               True, tile=2)
    assert train_tile.launches == before


def _bad_tile_args():
    w, xs, ts = _problem(3, 10, [8], 3, 5)
    W = tuple(_torch(a, torch.float64) for a in w)
    X, T = _torch(xs, torch.float64), _torch(ts, torch.float64)
    return {
        "dtype": ((W, X.half(), T.half()), {}, TypeError),
        "mixed": ((W, X, T.float()), {}, TypeError),
        "contiguity": ((W, X.T.contiguous().T, T), {}, ValueError),
        "shape-chain": ((W[::-1], X, T), {}, ValueError),
        "outputs": ((W, X, T[:, :2].contiguous()), {}, ValueError),
        "stats_prev": ((W, X, T), {"stats_prev": torch.zeros(3, 4)},
                       ValueError),
        "tile": ((W, X, T), {"tile": 0}, ValueError),
        "storage": ((W, X, T), {"storage": "f16"}, ValueError),
        "kind": ((W, X, T), {"kind": "XNN"}, ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_tile_args()))
def test_tile_wrapper_rejects_bad_inputs(case):
    from hpnn_tpu_torch.ops import train_tile

    args, kw, exc = _bad_tile_args()[case]
    kind = kw.pop("kind", "SNN")
    with pytest.raises(exc):
        train_tile(*args, kind, False, **kw)


# --- the slice: train_nn --tile end to end ---------------------------------

# the two quickest of the parity_fuzz corpora: ANN BPM and SNN BP
CLI_CASES = (0, 2)
# (variant, conf extra line, env, argv before the conf)
TILE_VARIANTS = {
    "conf": ("[tile] 4\n", {}, []),
    "flag": ("", {}, ["--tile", "4"]),
    "flag=": ("", {}, ["--tile=4"]),
    "env-beats-conf": ("[tile] 8\n", {"HPNN_TILE": "4"}, []),
    "auto": ("", {"HPNN_NO_AUTOTUNE": "1"}, ["--tile", "auto"]),
}
AUTOTUNE_DBG = "NN(DBG): autotune:"


def _strip_autotune(text):
    lines = text.split("\n")
    return ("\n".join(ln for ln in lines if not ln.startswith(AUTOTUNE_DBG)),
            [ln for ln in lines if ln.startswith(AUTOTUNE_DBG)])


@pytest.mark.parametrize("variant", list(TILE_VARIANTS))
@pytest.mark.parametrize("case", CLI_CASES,
                         ids=[f"{FUZZ_CASES[c][0]}-{FUZZ_CASES[c][1]}"
                              for c in CLI_CASES])
def test_train_nn_tile_matches_jax_cli(tmp_path, monkeypatch, case,
                                       variant):
    extra, env, flags = TILE_VARIANTS[variant]
    monkeypatch.chdir(tmp_path)
    for k in ("HPNN_TILE", "HPNN_TILE_STORAGE", "HPNN_NO_AUTOTUNE",
              "HPNN_AUTOTUNE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _write_fuzz_case(tmp_path, *FUZZ_CASES[case], extra=extra)
    (jrc, jout, jerr, jtmp, jw), (prc, pout, perr, ptmp, pw) = _train_both(
        tmp_path, ["-v", "-v", "-v", *flags, "nn.conf"])
    assert jrc == 0 and prc == 0
    jbody, jdbg = _strip_autotune(_stream(jout))
    pbody, pdbg = _strip_autotune(_stream(pout))
    assert pbody == jbody
    assert perr == jerr
    assert ptmp == jtmp
    assert pout.count("N_ITER=") == FUZZ_CASES[case][6]
    if variant == "auto":
        assert jdbg == [f"{AUTOTUNE_DBG} tile=32 route=xla storage=None "
                        "(heuristic)"]
        assert pdbg == [f"{AUTOTUNE_DBG} tile=32 route=loop storage=None "
                        "(heuristic)"]
    else:
        assert jdbg == pdbg == []
    iters = sum(int(m) for m in re.findall(r"N_ITER=\s*(\d+)", jout))
    tol = 5e-12 + (iters * 6e-15 if FUZZ_CASES[case][0] == "SNN" else 0.0)
    werr = max(float(np.abs(a - b).max()) for a, b in zip(jw, pw))
    assert werr < tol, (werr, tol, iters)


def test_train_nn_tile_trains_groups(tmp_path, monkeypatch):
    """The tile route is taken: [tile] 4 over 6 samples runs the tiled
    epoch (two groups), not the per-sample one."""
    from hpnn_tpu_torch.cli import train_nn_main
    from hpnn_tpu_torch.ops import convergence_tile_kernel as ck

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("HPNN_TILE", raising=False)
    _write_fuzz_case(tmp_path, *FUZZ_CASES[2], extra="[tile] 4\n")
    calls = []
    real = ck.train_tile

    def counting(*a, **k):
        calls.append((k["tile"], k["start_group"]))
        return real(*a, **k)

    monkeypatch.setattr(ck, "train_tile", counting)
    rc, out, _ = _capture(train_nn_main, ["-v", "-v", "--device", "cpu",
                                          "nn.conf"])
    assert rc == 0 and out.count("N_ITER=") == 6
    assert calls == [(4, 0)]


@pytest.mark.parametrize("name,value", [("HPNN_TILE", "junk"),
                                        ("HPNN_TILE_STORAGE", "f16")])
def test_bad_tile_env_warnings_match_jax(tmp_path, monkeypatch, name, value):
    monkeypatch.chdir(tmp_path)
    for k in ("HPNN_TILE", "HPNN_TILE_STORAGE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv(name, value)
    _write_fuzz_case(tmp_path, *FUZZ_CASES[2],
                     extra="[tile] 4\n" if name != "HPNN_TILE" else "")
    (jrc, jout, jerr, _, _), (prc, pout, perr, _, _) = _train_both(
        tmp_path, ["-v", "nn.conf"])
    assert jrc == prc == 0
    warn = [ln for ln in jout.split("\n") if "NN(WARN):" in ln]
    assert warn and warn == [ln for ln in pout.split("\n")
                             if "NN(WARN):" in ln]
    assert value in warn[0]
    assert pout == jout and perr == jerr


@pytest.mark.parametrize("extra", ["[model] 2\n", "[batch] 4\n[model] 2\n"],
                         ids=["model", "batch-model"])
def test_model_route_keywords_train_on_one_shard(tmp_path, monkeypatch,
                                                 extra):
    """A conf that asks for row sharding ([model] 2, alone or beside
    [batch]), which the port once refused, trains in one process on one
    shard: the JAX package's clamp warning before the training lines, and
    kernel.opt byte-identical to the same conf without [model] (one shard
    is the unsharded route)."""
    from hpnn_tpu_torch.cli import train_nn_main

    monkeypatch.chdir(tmp_path)
    runs = []
    _write_fuzz_case(tmp_path, *SMALL_CASE, extra=extra)
    conf = (tmp_path / "nn.conf").read_text()
    for text in (conf, conf.replace("[model] 2\n", "")):
        (tmp_path / "nn.conf").write_text(text)
        rc, out, err = _capture(train_nn_main, ["-v", "-v", "--device",
                                                "cpu", "nn.conf"])
        runs.append((rc, out, err, (tmp_path / "kernel.opt").read_text()))
    warn = "NN(WARN): [model] 2 > 1 visible device(s); using 1\n"
    (rc, out, err, opt), (rc0, out0, _, opt0) = runs
    assert rc == rc0 == 0 and "FAILED" not in err
    assert out.count(warn) == 1
    assert out.index(warn) < out.index("TRAINING")
    assert out.replace(warn, "") == out0
    assert opt == opt0


@pytest.mark.parametrize("extra,marker", [("[batch] 4\n", "TRAINING BATCH"),
                                          ("[trainer] cg\n", "TRAINING CG")])
def test_formerly_unported_route_keywords_train_like_jax(tmp_path,
                                                         monkeypatch, extra,
                                                         marker):
    """The keywords the port once refused now train, as in the JAX
    package: ``[batch] 4`` minibatch data-parallel, and ``[trainer] cg``
    the CG trainer (the keyword also sets ``[train]`` to CG).  Streams
    byte-identical, weights within 1e-11."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HPNN_DP_DEVICES", "1")
    _write_fuzz_case(tmp_path, *FUZZ_CASES[2], extra=extra)
    import hpnn_tpu_torch.api as api

    (jrc, jout, jerr, jtmp, jw), (prc, pout, perr, ptmp, pw) = _train_both(
        tmp_path, ["-v", "-v", "nn.conf"])
    if api._prefetch_thread is not None:  # it reads ./tests: end it here
        api._prefetch_thread.join()
    assert jrc == prc == 0
    assert pout == jout and perr == jerr and ptmp == jtmp
    assert marker in pout
    assert max(float(np.abs(a - b).max()) for a, b in zip(jw, pw)) < 1e-11


@pytest.mark.parametrize("extra", ["[model] 1\n", "[trainer] bpm\n",
                                   "[batch] 0\n"])
def test_ported_route_keywords_still_train(tmp_path, monkeypatch, extra):
    from hpnn_tpu_torch.cli import train_nn_main

    monkeypatch.chdir(tmp_path)
    _write_fuzz_case(tmp_path, "SNN", "BP", 6, [2, 5], 3, 502935467, 2, 26,
                     extra=extra)
    rc, out, _ = _capture(train_nn_main, ["-v", "-v", "--device", "cpu",
                                          "nn.conf"])
    assert rc == 0 and out.count("N_ITER=") == 2


@pytest.mark.parametrize("argv,tile", [(["--tile", "16"], 16),
                                       (["--tile=auto"], -1),
                                       (["--tile", "7x"], 7),
                                       (["--tile=0"], 0)])
def test_cli_tile_flag_parses_like_jax(argv, tile):
    from hpnn_tpu.cli import _parse_args as jax_parse
    from hpnn_tpu_torch.cli import _parse_args as port_parse

    _, _, jx = jax_parse([*argv, "nn.conf"], "train_nn", train=True)
    _, px = port_parse([*argv, "nn.conf"], "train_nn")
    assert jx["tile"] == px["tile"] == tile


def test_cli_tile_flag_errors(capsys):
    from hpnn_tpu_torch.cli import _parse_args, train_nn_main

    with pytest.raises(SystemExit):
        _parse_args(["--tile", "x", "nn.conf"], "train_nn")
    assert "bad --tile parameter" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        _parse_args(["--tile", "4", "nn.conf"], "run_nn")
    # run_nn knows no --tile, as in the JAX package: the reference's line
    assert capsys.readouterr().err == "syntax error: unrecognized option!\n"
    assert train_nn_main(["-h"]) == 0
    assert "--tile S \tbatched-tile convergence engine" in \
        capsys.readouterr().out


# --- autotuner ----------------------------------------------------------------

SHAPES = ((8, 10), (3, 8))


@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    from hpnn_tpu_torch.ops import autotune

    monkeypatch.setenv("HPNN_AUTOTUNE_CACHE", str(tmp_path))
    monkeypatch.setenv("HPNN_AUTOTUNE", "1")   # measure on the CPU
    monkeypatch.delenv("HPNN_NO_AUTOTUNE", raising=False)
    autotune.clear_memo()
    yield tmp_path
    autotune.clear_memo()


def test_autotune_measures_then_caches(tune_cache, monkeypatch):
    from hpnn_tpu_torch.ops import autotune

    dec = autotune.decide_tile(SHAPES, torch.float32, "ANN", False,
                               device="cpu", tiles=(1, 2), storages=(None,))
    assert dec["source"] == "measured" and dec["route"] == "loop"
    assert dec["tile"] in (1, 2) and set(dec["cells"]) == {
        "tile1-native-loop", "tile2-native-loop"}
    cache = json.loads((tune_cache / "autotune.json").read_text())
    assert list(cache) == ["cpu|tile|ANN|BP|float32|8.10x3.8"]
    autotune.clear_memo()   # a fresh process over the same file

    def boom(*a, **k):
        raise AssertionError("a cache hit must not measure")

    monkeypatch.setattr(autotune, "_measure_tile", boom)
    monkeypatch.setattr(autotune, "_time_epoch", boom)
    dec2 = autotune.decide_tile(SHAPES, torch.float32, "ANN", False,
                                device="cpu", tiles=(1, 2), storages=(None,))
    assert dec2["source"] == "cache" and dec2["tile"] == dec["tile"]
    assert autotune.describe_tile(SHAPES, torch.float32, "ANN", False,
                                  device="cpu")["source"] == "cache"


def test_autotune_cache_key_is_device_scoped(tune_cache):
    from hpnn_tpu_torch.ops import autotune

    key = autotune._key("tile", SHAPES, "SNN", True, torch.bfloat16, "cpu")
    assert key == "cpu|tile|SNN|BPM|bfloat16|8.10x3.8"


def test_autotune_cuda_key_names_the_kernel(tune_cache, monkeypatch):
    """A card's decision is keyed by the tile kernel's library (a digest of
    its source and build flags): an entry measured on another version of
    the kernel is measured again, not returned."""
    from hpnn_tpu_torch.ops import autotune, build

    monkeypatch.setattr(autotune, "_device_name", lambda device: "Card")
    key = autotune._key("tile", SHAPES, "ANN", False, torch.float64, "cuda")
    lib = os.path.splitext(os.path.basename(
        build.library_path("train_tile")))[0]
    assert key == f"Card|{lib}|tile|ANN|BP|float64|8.10x3.8"
    stale = key.replace(lib, "train_tile-0123456789abcdef")
    old = {"tile": 512, "route": "kernel", "storage": None, "cells": {}}
    (tune_cache / "autotune.json").write_text(json.dumps({stale: old}))
    monkeypatch.setattr(autotune, "_measure_tile", lambda *a, **k: {
        "tile": 32, "route": "kernel", "storage": None, "cells": {}})
    dec = autotune.decide_tile(SHAPES, torch.float64, "ANN", False,
                               device="cuda")
    assert dec["source"] == "measured" and dec["tile"] == 32
    cache = json.loads((tune_cache / "autotune.json").read_text())
    assert cache == {stale: old, key: {"tile": 32, "route": "kernel",
                                       "storage": None, "cells": {}}}
    autotune.clear_memo()
    again = autotune.decide_tile(SHAPES, torch.float64, "ANN", False,
                                 device="cuda")
    assert again["source"] == "cache" and again["tile"] == 32


def test_no_autotune_gives_the_heuristic(monkeypatch, tmp_path):
    from hpnn_tpu_torch.ops import autotune

    monkeypatch.setenv("HPNN_AUTOTUNE_CACHE", str(tmp_path))
    monkeypatch.setenv("HPNN_NO_AUTOTUNE", "1")
    monkeypatch.setenv("HPNN_AUTOTUNE", "1")
    monkeypatch.setattr(autotune, "_measure_tile",
                        lambda *a, **k: (_ for _ in ()).throw(
                            AssertionError()))
    autotune.clear_memo()
    for device, route in (("cpu", "loop"), ("cuda", "kernel")):
        dec = autotune.decide_tile(SHAPES, torch.float64, "ANN", False,
                                   device=device)
        assert dec == {"tile": 32, "route": route, "storage": None,
                       "source": "heuristic"}
    assert not (tmp_path / "autotune.json").exists()
    assert autotune.describe_tile(SHAPES, torch.float64, "ANN", False,
                                  device="cpu")["source"] == "off"
    monkeypatch.delenv("HPNN_NO_AUTOTUNE")
    monkeypatch.delenv("HPNN_AUTOTUNE")
    assert not autotune.enabled("cpu") and autotune.enabled("cuda")
