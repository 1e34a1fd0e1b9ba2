"""``[batch] B`` data-parallel training of the PyTorch port against the JAX
package, on the CPU, in one process.

The same seeded corpus (tests/test_torch_epochs.py's: 8-6-3, nine files
and two skip files) and conf go through ``hpnn_tpu.cli.train_nn_main`` and
the port's ``train_nn_main`` with ``--device cpu``, the JAX side pinned to
one device (``HPNN_DP_DEVICES=1``: a JAX process that sees several CPU
devices would take its mesh route):

* ``[batch] 4`` with BP and BPM, one epoch and ``--epochs 3``, for ANN,
  SNN and the native LNN; the resident pipeline against the restaging
  route; odd batch padding and the masks; the bf16 denominator;
* ``[batch] 4`` + ``[tile]`` (the batched-tile engine with the batch as
  the group) and its launch tiling;
* kill at epoch 1 of 3 and ``--resume`` for a ``[batch]`` BPM run and a CG
  run, and bundles resumed across the packages both ways.

Tolerances, with their reasons:

* f64: the ``-v -v`` stream byte-identical and kernel.opt weights within
  1e-11 after three epochs (a minibatch product sums its rows in another
  order in XLA than in torch; measured: 0 to 1e-15);
* bf16 (f32 masters, products promoted to f32 as XLA promotes them):
  weights within 1e-5 and each batch's error within 1e-5 relative (f32
  rounding of differently ordered sums over three epochs; measured 0);
* the port's own kill + ``--resume`` and restage against resident:
  byte-identical.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from test_torch_epochs import (N_SAMP, VARIANTS, _jax, _port, _setup,
                               _weights)

ONE = {"HPNN_DP_DEVICES": "1"}
DP_VARIANTS = ["ANN-BP", "ANN-BPM", "SNN-BP", "SNN-BPM", "LNN-native"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup_with(tmp_path, monkeypatch, variant, extra):
    kind, train, conf_extra, _ = VARIANTS[variant]
    VARIANTS["_dp"] = (kind, train, conf_extra + extra, ())
    try:
        _setup(tmp_path, monkeypatch, "_dp")
    finally:
        VARIANTS.pop("_dp")


def _werr(a, b):
    """Largest weight difference of two kernel.opt texts (str or bytes)."""
    a, b = (v.decode() if isinstance(v, bytes) else v for v in (a, b))
    return max(float(np.abs(x - y).max())
               for x, y in zip(_weights(a), _weights(b)))


@pytest.mark.parametrize("epochs", [1, 3])
@pytest.mark.parametrize("variant", DP_VARIANTS)
def test_dp_matches_jax(tmp_path, monkeypatch, variant, epochs):
    _setup_with(tmp_path, monkeypatch, variant, "[batch] 4\n")
    argv = ["-v", "-v", "--epochs", str(epochs), "nn.conf"]
    j = _jax(argv, ONE)
    p = _port(argv, ONE)
    assert j[0] == p[0] == 0, p[2]
    assert p[1] == j[1] and p[2] == j[2] and p[3] == j[3]
    assert p[1].count("TRAINING BATCH") == 3 * epochs
    assert "DP: padding 3 masked row(s) (S=9, batch=4 -> 4 over 1 " \
           "data-shard(s))" in p[1]
    assert _werr(j[4], p[4]) < 1e-11


@pytest.mark.parametrize("variant", ["ANN-BPM", "SNN-BP", "LNN-native"])
def test_dp_pipeline_equals_restage(tmp_path, monkeypatch, variant):
    """The resident pipeline and HPNN_NO_EPOCH_PIPELINE=1: identical bytes;
    after the setup upload each resident epoch uploads only its slot map
    (3 batches x 4 slots of int32)."""
    import hpnn_tpu_torch.api as api

    _setup_with(tmp_path, monkeypatch, variant, "[batch] 4\n")
    argv = ["-v", "-v", "--epochs", "3", "nn.conf"]
    api.reset_epoch_metrics()
    restage = _port(argv, {"HPNN_NO_EPOCH_PIPELINE": "1"})
    off = dict(api.EPOCH_METRICS)
    api.reset_epoch_metrics()
    resident = _port(argv)
    on = dict(api.EPOCH_METRICS)
    assert restage[0] == 0 and resident == restage
    assert off["mode"] == "dp-restage" and on["mode"] == "dp-resident"
    assert on["h2d_bytes"] == 3 * 3 * 4 * 4
    assert on["dp_devices"] == off["dp_devices"] == 1


def test_dp_odd_padding_and_masks():
    """A batch padded with masked rows gives the unpadded batch's mean
    gradient and error (the SNN head makes a zero row non-neutral, so the
    mask is what makes it so), and both packages' ``batched_grads`` agree
    on it; the BP and BPM steps agree too."""
    import jax.numpy as jnp

    from hpnn_tpu.parallel import dp as jdp
    from hpnn_tpu_torch.parallel import dp

    rng = np.random.default_rng(11)
    ws = [rng.uniform(-1, 1, (5, 7)), rng.uniform(-1, 1, (3, 5))]
    xs = rng.uniform(-1, 1, (7, 7))
    ts = np.where(rng.uniform(size=(7, 3)) > 0.5, 1.0, 0.0)
    pad = 3
    xp = np.concatenate([xs, np.zeros((pad, 7))])
    tp = np.concatenate([ts, np.zeros((pad, 3))])
    mask = np.concatenate([np.ones(7), np.zeros(pad)])
    T = lambda a: torch.as_tensor(a)                       # noqa: E731
    g0, e0 = dp.batched_grads(tuple(map(T, ws)), T(xs), T(ts), "SNN")
    g1, e1 = dp.batched_grads(tuple(map(T, ws)), T(xp), T(tp), "SNN",
                              T(mask))
    gu, eu = dp.batched_grads(tuple(map(T, ws)), T(xp), T(tp), "SNN")
    jg, je = jdp.batched_grads(tuple(map(jnp.asarray, ws)), jnp.asarray(xp),
                               jnp.asarray(tp), "SNN", jnp.asarray(mask))
    assert abs(float(e1) - float(e0)) < 1e-15
    assert abs(float(e1) - float(je)) < 1e-15
    assert abs(float(eu) - float(e0)) > 1e-6          # unmasked pads count
    for a, b, c in zip(g0, g1, jg):
        assert np.abs(a.numpy() - b.numpy()).max() < 1e-15
        assert np.abs(b.numpy() - np.asarray(c)).max() < 1e-15
    w1, _ = dp.dp_train_step(tuple(map(T, ws)), T(xp), T(tp), "SNN", 0.01,
                             T(mask))
    jw1, _ = jdp.dp_train_step(tuple(map(jnp.asarray, ws)), jnp.asarray(xp),
                               jnp.asarray(tp), "SNN", 0.01,
                               jnp.asarray(mask))
    zero = tuple(torch.zeros_like(T(w)) for w in ws)
    w2, dw2, _ = dp.dp_train_step_momentum(tuple(map(T, ws)), zero, T(xp),
                                           T(tp), "SNN", 0.01, 0.2, T(mask))
    jw2, jdw2, _ = jdp.dp_train_step_momentum(
        tuple(map(jnp.asarray, ws)), tuple(jnp.zeros_like(w) for w in ws),
        jnp.asarray(xp), jnp.asarray(tp), "SNN", 0.01, 0.2,
        jnp.asarray(mask))
    for a, b in zip((*w1, *w2, *dw2), (*jw1, *jw2, *jdw2)):
        assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-15


def test_dp_bf16_large_batch_denominator():
    """With bf16 rows past 256 the mean's denominator counts rows exactly
    (bf16 integers saturate at 256): the port's bf16 gradient matches its
    f32 one within bf16 noise (a saturated count would scale it 1.5x) and
    the JAX package's bf16 gradient (tests/test_parallel.py's case)."""
    import jax.numpy as jnp

    from hpnn_tpu.parallel.dp import batched_grads as jgrads
    from hpnn_tpu_torch.parallel.dp import batched_grads

    b, pad = 384, 128
    rng = np.random.default_rng(31)
    ws = [rng.uniform(-1, 1, (6, 8)) * 0.5, rng.uniform(-1, 1, (4, 6)) * 0.5]
    xs = rng.uniform(-1, 1, (b + pad, 8))
    ts = -np.ones((b + pad, 4))
    ts[np.arange(b + pad), rng.integers(0, 4, b + pad)] = 1.0
    mask = np.concatenate([np.ones(b), np.zeros(pad)])

    def port(dtype):
        return batched_grads(tuple(torch.as_tensor(w).to(dtype) for w in ws),
                             torch.as_tensor(xs).to(dtype),
                             torch.as_tensor(ts).to(dtype), "ANN",
                             torch.as_tensor(mask).to(dtype))

    g32, e32 = port(torch.float32)
    g16, e16 = port(torch.bfloat16)
    jg16, je16 = jgrads(tuple(jnp.asarray(w, jnp.bfloat16) for w in ws),
                        jnp.asarray(xs, jnp.bfloat16),
                        jnp.asarray(ts, jnp.bfloat16), "ANN",
                        jnp.asarray(mask, jnp.bfloat16))
    np.testing.assert_allclose(float(e16), float(e32), rtol=0.1)
    np.testing.assert_allclose(float(e16), float(je16), rtol=0.02)
    for a, c, jc in zip(g16, g32, jg16):
        ref = c.float().numpy()
        scale = np.abs(ref).max()
        assert np.abs(a.float().numpy() - ref).max() < 0.1 * scale
        assert np.abs(a.float().numpy()
                      - np.asarray(jc, np.float32)).max() < 0.05 * scale


def test_dp_bf16_matches_jax_within_envelope(tmp_path, monkeypatch):
    _setup_with(tmp_path, monkeypatch, "SNN-BPM",
                "[batch] 5\n[dtype] bf16\n")
    argv = ["-v", "-v", "--epochs", "3", "nn.conf"]
    j = _jax(argv, ONE)
    p = _port(argv, ONE)
    assert j[0] == p[0] == 0, p[2]
    ej = [float(v) for v in re.findall(r"err=\s*([-\d.]+)", j[1])]
    ep = [float(v) for v in re.findall(r"err=\s*([-\d.]+)", p[1])]
    assert len(ep) == len(ej) == 6
    assert np.allclose(ep, ej, rtol=1e-5, atol=1e-9)
    assert _werr(j[4], p[4]) < 1e-5


@pytest.mark.parametrize("variant", ["ANN-BP", "ANN-BPM", "SNN-BPM"])
def test_dp_tiled_matches_jax(tmp_path, monkeypatch, variant):
    """``[batch] 4`` + ``[tile] 2``: the batched-tile engine with groups of
    four, two groups a launch, and the per-sample grammar."""
    _setup_with(tmp_path, monkeypatch, variant, "[batch] 4\n[tile] 2\n")
    argv = ["-v", "-v", "--epochs", "3", "nn.conf"]
    j = _jax(argv, ONE)
    p = _port(argv, ONE)
    assert j[0] == p[0] == 0, p[2]
    assert p[1] == j[1] and p[2] == j[2]
    assert p[1].count("DP: batched-tile convergence engine (group=4)") == 3
    assert p[1].count("N_ITER=") == 3 * N_SAMP
    assert _werr(j[4], p[4]) < 1e-11


def test_dp_tiled_launch_tiling_is_invisible(tmp_path, monkeypatch):
    """The [tile] value on the [batch] route is launch granularity only:
    one, two or all groups a launch give the same bytes, restaged or
    resident."""
    _setup_with(tmp_path, monkeypatch, "SNN-BPM", "[batch] 4\n")
    runs = []
    for tile in ("1", "2", "9"):
        for env in ({}, {"HPNN_NO_EPOCH_PIPELINE": "1"}):
            runs.append(_port(["-v", "-v", "--epochs", "2", "--tile", tile,
                               "nn.conf"], env))
    assert runs[0][0] == 0 and "N_ITER=" in runs[0][1]
    assert all(r == runs[0] for r in runs)


def test_batch_with_model_takes_the_grid_route(tmp_path, monkeypatch):
    """[batch] beside [model] 2, once refused, trains on the (data x
    model) grid; in one process the model axis clamps to 1 with the JAX
    package's warning before the batch lines, and the run is the
    [batch]-only run otherwise (the same kernel.opt bytes)."""
    _setup_with(tmp_path, monkeypatch, "ANN-BP", "[batch] 4\n[model] 2\n")
    p = _port(["-v", "-v", "nn.conf"])
    conf = (tmp_path / "nn.conf").read_text()
    (tmp_path / "nn.conf").write_text(conf.replace("[model] 2\n", ""))
    q = _port(["-v", "-v", "nn.conf"])
    warn = "NN(WARN): [model] 2 > 1 visible device(s); using 1\n"
    assert p[0] == q[0] == 0 and p[2] == q[2]
    assert p[1].index(warn) < p[1].index("TRAINING BATCH")
    assert p[1].replace(warn, "") == q[1]
    assert p[4] == q[4]


@pytest.mark.parametrize("cap", ["1", "3"])
def test_dp_devices_cap(tmp_path, monkeypatch, cap):
    """``HPNN_DP_DEVICES`` caps the data axis at the world size: one
    process with a cap of 3 warns once, as the JAX package does for a cap
    over its visible devices, and runs unsharded -- the stream of the JAX
    package pinned to one device."""
    from hpnn_tpu_torch.utils import env as penv

    monkeypatch.setattr(penv, "_warned_device_caps", set())
    _setup_with(tmp_path, monkeypatch, "ANN-BP", "[batch] 3\n")
    argv = ["-v", "-v", "nn.conf"]
    j = _jax(argv, ONE)
    p = _port(argv, {"HPNN_DP_DEVICES": cap})
    assert j[0] == p[0] == 0
    warn = "NN(WARN): HPNN_DP_DEVICES=3 > 1 visible device(s); using 1\n"
    assert p[1].replace(warn, "") == j[1] and p[2] == j[2]
    assert p[1].count(warn) == (cap == "3")


def test_dp_opt_state_bytes_are_measured(tmp_path, monkeypatch):
    """One process holds the whole BPM momentum: its measured bytes equal
    the replicated layout's (the 1/N claim is held in
    tests/test_torch_multiproc.py)."""
    import hpnn_tpu_torch.api as api

    _setup_with(tmp_path, monkeypatch, "ANN-BPM", "[batch] 4\n")
    api.reset_epoch_metrics()
    p = _port(["--epochs", "2", "nn.conf"])
    assert p[0] == 0
    params = 6 * 8 + 3 * 6
    assert api.EPOCH_METRICS["opt_state_bytes_per_device"] == params * 8
    assert api.EPOCH_METRICS["opt_state_replicated_bytes"] == params * 8


# --- kill + --resume, and bundles across the packages ----------------------

RESUME_CASES = {"dp-bpm": ("ANN", "BPM", "[batch] 4\n", ()),
                "dp-snn": ("SNN", "BP", "[batch] 3\n", ()),
                "cg": ("SNN", "CG", "", ("--trainer", "cg"))}


def _resume_runs(tmp_path, case):
    """For a case: the port's and the JAX package's uninterrupted
    checkpointed runs, their kill-at-epoch-1 runs, the port's resume of
    its own bundle and each package's resume of the other's."""
    from test_torch_ckpt import _train, _write_corpus

    kind, train, extra, flags = RESUME_CASES[case]
    root = str(tmp_path)
    rng = np.random.default_rng(7)
    _write_corpus(os.path.join(root, "samples"), rng, kind, 2.0)
    _write_corpus(os.path.join(root, "tests"), rng, kind, 2.0)
    conf = os.path.join(root, "nn.conf")
    with open(conf, "w") as fp:
        fp.write(f"[name] tiny\n[type] {kind}\n[init] generate\n"
                 f"[seed] 4321\n[input] 8\n[hidden] 6\n[output] 2\n"
                 f"[train] {train}\n[sample_dir] {root}/samples\n"
                 f"[test_dir] {root}/tests\n" + extra)
    argv = ["-v", "-v", "--epochs", "3", "--ckpt-every", "1",
            "--ckpt-dir", "ck", *flags, conf]
    resume = ["-v", "-v", "--epochs", "3", "--resume", "--ckpt-dir", "ck",
              *flags, conf]
    kill = {"HPNN_CKPT_KILL_AT_EPOCH": "1", **ONE}
    p = lambda name: os.path.join(root, name)           # noqa: E731
    runs = {"pfull": _train("port", argv, p("pfull"), ONE),
            "jfull": _train("jax", argv, p("jfull"), ONE),
            "pkill": _train("port", argv, p("pkill"), kill),
            "jkill": _train("jax", argv, p("jkill"), kill)}
    shutil.copytree(p("pkill/ck"), p("ppart/ck"))
    runs["ppart"] = _train("port", resume, p("ppart"), ONE)
    shutil.copytree(p("jkill/ck"), p("xp/ck"))
    runs["xp"] = _train("port", resume, p("xp"), ONE)
    shutil.copytree(p("pkill/ck"), p("xj/ck"))
    runs["xj"] = _train("jax", resume, p("xj"), ONE)
    return runs


def _tail(out):
    mark = "NN: EPOCH        2/       3\n"
    assert mark in out, out[-400:]
    return out[out.index(mark):]


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_kill_resume_and_cross_package_bundles(tmp_path, monkeypatch, case):
    """Kill at epoch 1 of 3 + ``--resume``: the port's kernel.opt is its
    uninterrupted run's byte for byte (the CG carry and the epoch state
    ride the bundle); a JAX bundle resumes in the port and a port bundle
    in the JAX package, each to the other's stream (f64: within 1e-9 for
    CG, 1e-11 for [batch])."""
    from hpnn_tpu.io import samples as jax_samples

    monkeypatch.setattr(jax_samples, "_native_warned", True)
    monkeypatch.chdir(tmp_path)
    runs = _resume_runs(tmp_path, case)
    for name, r in runs.items():
        assert r["rc"] == 0, (name, r["err"])
    tol = 1e-9 if case == "cg" else 1e-11
    assert runs["ppart"]["opt"] == runs["pfull"]["opt"]
    assert _tail(runs["ppart"]["out"]) == _tail(runs["pfull"]["out"])
    assert runs["pfull"]["out"] == runs["jfull"]["out"]
    assert _tail(runs["xp"]["out"]) == _tail(runs["jfull"]["out"])
    assert _tail(runs["xj"]["out"]) == _tail(runs["pfull"]["out"])
    for a, b in (("xp", "jfull"), ("xj", "pfull"), ("pfull", "jfull")):
        assert _werr(runs[a]["opt"], runs[b]["opt"]) < tol
    if case == "cg":
        assert runs["pfull"]["out"].count("TRAINING CG") == 3
        assert "restarts=" in runs["ppart"]["out"]


@pytest.mark.parametrize("block", [(0, 4), (3, 9), (7, 12), (9, 12)])
def test_padded_row_block_and_prefer_mmap_match_jax(tmp_path, block):
    """``load_resident(prefer_mmap=True)`` on a cold dir leaves pack-backed
    memmap rows in both packages, and ``padded_row_block`` cuts the same
    float64 blocks (zero rows past the corpus, up to a padded total)."""
    from hpnn_tpu.io import corpus as jcorpus
    from hpnn_tpu.io.samples import list_sample_dir as jlist
    from hpnn_tpu_torch.io import corpus

    xs = np.random.default_rng(3).uniform(-1, 1, (N_SAMP, 8))
    for d in ("p", "j"):          # one cold dir for each package
        os.makedirs(tmp_path / d)
        for i, x in enumerate(xs):
            with open(tmp_path / d / f"s{i:02d}", "w") as fp:
                fp.write("[input] 8\n" + " ".join(f"{v:.5f}" for v in x)
                         + "\n[output] 3\n1.0 -1.0 -1.0\n")
    prc = corpus.load_resident(str(tmp_path / "p"),
                               jlist(str(tmp_path / "p")), 8, 3,
                               prefer_mmap=True)
    jrc = jcorpus.load_resident(str(tmp_path / "j"),
                                jlist(str(tmp_path / "j")), 8, 3,
                                prefer_mmap=True)
    assert isinstance(prc.X, np.memmap) and isinstance(jrc.X, np.memmap)
    lo, hi = block
    for which in ("x", "t"):
        a = prc.padded_row_block(which, lo, hi, 12)
        b = jrc.padded_row_block(which, lo, hi, 12)
        assert a.dtype == np.float64 and np.array_equal(a, b)
    with pytest.raises(ValueError):
        prc.padded_row_block("x", 5, 13, 12)
