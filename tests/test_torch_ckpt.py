"""Checkpoints and ``train_nn --resume`` of the PyTorch port against the JAX
package, on the CPU.

The corpus is tests/test_ckpt.py's tiny one cut further for the port's
eager CPU loop (about 0.1 ms an iteration): 8-6-2, six separable files,
and a kernel the JAX package trained for one plain epoch as ``[init]`` (a
generated kernel spends about 30,000 iterations on its first epoch here;
from the trained one each epoch takes 100-8,000, so every run is well
under a second).  The same seeded files and conf go through
``hpnn_tpu.cli.train_nn_main`` and the port's ``train_nn_main`` with
``--device cpu``:

* kill at epoch 1 of 3 (``HPNN_CKPT_KILL_AT_EPOCH=1``) and ``--resume``:
  the port's ``kernel.opt`` byte-identical to its own uninterrupted run;
  its stream from ``EPOCH 2`` on byte-identical to ``hpnn_tpu``'s
  uninterrupted stream, its f64 ``kernel.opt`` within 5e-12 of it (plus
  6e-15 an iteration on SNN, tests/test_parity_fuzz.py's drift model), for
  ANN BP, ANN BPM, SNN BPM, the native LNN, ANN at ``--tile 4`` and ANN BP
  f32 (port against port only);
* bundles across packages, both ways, at f64: each package resumes the
  other's epoch-1 bundle to the other's stream; the two bundles agree key
  by key; ``pack_bundle`` blobs are byte-identical and each package's
  ``unpack_bundle`` reads the other's;
* tests/test_ckpt.py's CLI, format and manager cases run through both
  packages with their outputs compared, the corrupt-bundle fallback and
  the replica restore of tests/test_train_chaos.py, and ``train_loop``'s
  ``stop``/``on_epoch`` hooks.
"""

import contextlib
import io
import json
import os
import re
import shutil
import threading

import numpy as np
import pytest
import torch

N_IN, N_HID, N_OUT = 8, 6, 2
N_SAMP = 6
EPOCHS = 3
MARK = f"NN: EPOCH        2/{EPOCHS:8d}\n"

# variant -> ([type], [train], extra conf lines, extra CLI arguments, the
# class input's offset, held to the JAX package)
VARIANTS = {
    "ANN-BP": ("ANN", "BP", "", (), 2.0, True),
    "ANN-BPM": ("ANN", "BPM", "", (), 2.0, True),
    "SNN-BPM": ("SNN", "BPM", "", (), 2.0, True),
    "LNN-native": ("LNN", "BP", "[lnn] native\n", (), 5.0, True),
    "ANN-BP-tile4": ("ANN", "BP", "", ("--tile", "4"), 2.0, True),
    "ANN-BP-f32": ("ANN", "BP", "[dtype] f32\n", (), 2.0, False),
}
F64 = [v for v, spec in VARIANTS.items() if spec[5]]


@pytest.fixture(autouse=True)
def _one_thread():
    """The eager loop is dispatch-bound; one intra-op thread keeps it from
    contending with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_corpus(dirpath, rng, kind, boost):
    """Six files of two classes: uniform [-1, 1] inputs, ``boost`` added
    to input ``class``; ANN targets -1/1, SNN and LNN 0/1."""
    os.makedirs(dirpath)
    low = -1.0 if kind == "ANN" else 0.0
    for i in range(N_SAMP):
        cls = i % N_OUT
        x = rng.uniform(-1, 1, N_IN)
        x[cls] += boost
        t = np.full(N_OUT, low)
        t[cls] = 1.0
        with open(os.path.join(dirpath, f"s{i:03d}"), "w") as fp:
            fp.write(f"[input] {N_IN}\n"
                     + " ".join(f"{v:7.5f}" for v in x)
                     + f"\n[output] {N_OUT}\n"
                     + " ".join(f"{v:.1f}" for v in t) + "\n")


def _reset_logs():
    from hpnn_tpu.utils import nn_log as jax_log
    from hpnn_tpu_torch.utils import nn_log

    jax_log.set_verbosity(0)
    nn_log.set_verbosity(0)


def _call(fn, argv, env=None):
    """``fn(argv)`` with ``env`` set for the call: (rc, stdout, stderr)."""
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    out, err = io.StringIO(), io.StringIO()
    _reset_logs()
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = fn(argv)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        _reset_logs()
    return rc, out.getvalue(), err.getvalue()


def _train(pkg, argv, cwd, env=None):
    """One ``train_nn`` of ``pkg`` ("jax" or "port") in ``cwd`` (created):
    a dict of rc, stdout, stderr and kernel.opt's bytes."""
    os.makedirs(cwd, exist_ok=True)
    here = os.getcwd()
    os.chdir(cwd)
    try:
        if os.path.exists("kernel.opt"):
            os.unlink("kernel.opt")
        if pkg == "jax":
            import hpnn_tpu.api as jax_api
            from hpnn_tpu.cli import train_nn_main

            rc, out, err = _call(train_nn_main, argv, env)
            if jax_api._prefetch_thread is not None:
                jax_api._prefetch_thread.join()
        else:
            from hpnn_tpu_torch.cli import train_nn_main

            rc, out, err = _call(train_nn_main,
                                 [*argv[:-1], "--device", "cpu", argv[-1]],
                                 env)
        opt = None
        if os.path.exists("kernel.opt"):
            with open("kernel.opt", "rb") as fp:
                opt = fp.read()
    finally:
        os.chdir(here)
    return {"rc": rc, "out": out, "err": err, "opt": opt}


def _run_nn(pkg, argv, cwd):
    here = os.getcwd()
    os.chdir(cwd)
    try:
        if pkg == "jax":
            from hpnn_tpu.cli import run_nn_main

            return _call(run_nn_main, argv)
        from hpnn_tpu_torch.cli import run_nn_main

        return _call(run_nn_main, [*argv[:-1], "--device", "cpu", argv[-1]])
    finally:
        os.chdir(here)


def _make_case(root, variant):
    """The corpus, a one-epoch trained ``pre.opt`` (JAX package, f64) and
    ``nn.conf`` under ``root``; returns the conf's absolute path."""
    from hpnn_tpu.io import samples as jax_samples

    kind, train, extra, _, boost, _ = VARIANTS[variant]
    rng = np.random.default_rng(7)
    _write_corpus(os.path.join(root, "samples"), rng, kind, boost)
    _write_corpus(os.path.join(root, "tests"), rng, kind, boost)
    base = (f"[name] tiny\n[type] {kind}\n[seed] 1234\n"
            f"[input] {N_IN}\n[hidden] {N_HID}\n[output] {N_OUT}\n"
            f"[train] {train}\n[sample_dir] {root}/samples\n"
            f"[test_dir] {root}/tests\n")
    lnn = "[lnn] native\n" if "[lnn]" in extra else ""
    with open(os.path.join(root, "pre.conf"), "w") as fp:
        fp.write("[init] generate\n" + base + lnn)
    # the JAX package's one-time native-IO warning stays out of streams
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_samples, "_native_warned", True)
        res = _train("jax", [os.path.join(root, "pre.conf")],
                     os.path.join(root, "pre"))
    assert res["rc"] == 0, res["err"]
    os.replace(os.path.join(root, "pre", "kernel.opt"),
               os.path.join(root, "pre.opt"))
    conf = os.path.join(root, "nn.conf")
    with open(conf, "w") as fp:
        fp.write(f"[init] {root}/pre.opt\n" + base + extra)
    return conf


def _weights(blob):
    from hpnn_tpu.io.kernel_io import load_kernel

    path = os.path.join(os.getcwd(), "_cmp.opt")
    with open(path, "wb") as fp:
        fp.write(blob)
    try:
        return load_kernel(path).weights
    finally:
        os.unlink(path)


def _tol(kind, stream):
    iters = sum(int(m) for m in re.findall(r"N_ITER=\s*(\d+)", stream))
    return 5e-12 + (iters * 6e-15 if kind == "SNN" else 0.0)


def _werr(a, b):
    return max(float(np.abs(x - y).max())
               for x, y in zip(_weights(a), _weights(b)))


def _tail(out):
    assert MARK in out, out[-400:]
    return out[out.index(MARK):]


_CASES: dict = {}


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    """Every variant's runs, made once for the module (each test reads
    what it holds from them).  For variant v, under its own root:
    ``pfull``/``jfull`` the uninterrupted checkpointed runs of the port and
    the JAX package; the killed runs of both in ``kill/`` (so their
    manifests name the same final kernel path), their checkpoint dirs kept
    as ``pck``/``jck``; ``ppart`` the port's resume of its own bundle,
    ``xp`` the port's resume of the JAX bundle, ``xj`` the JAX package's
    resume of the port's."""
    import hpnn_tpu_torch.api as api
    from hpnn_tpu.io import samples as jax_samples

    def make(variant):
        if variant in _CASES:
            return _CASES[variant]
        root = str(tmp_path_factory.mktemp(variant))
        conf = _make_case(root, variant)
        extra = list(VARIANTS[variant][3])
        jax_too = VARIANTS[variant][5]
        argv = ["-v", "-v", "--epochs", str(EPOCHS), "--ckpt-every", "1",
                "--ckpt-dir", "ck", *extra, conf]
        resume = ["-v", "-v", "--epochs", str(EPOCHS), "--resume",
                  "--ckpt-dir", "ck", *extra, conf]
        kill = {"HPNN_CKPT_KILL_AT_EPOCH": "1"}
        p = lambda name: os.path.join(root, name)   # noqa: E731
        runs = {"root": root, "conf": conf}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_samples, "_native_warned", True)
            api.reset_epoch_metrics()
            runs["pfull"] = _train("port", argv, p("pfull"))
            runs["pfull_metrics"] = dict(api.EPOCH_METRICS)
            runs["pkill"] = _train("port", argv, p("kill"), kill)
            os.rename(p("kill/ck"), p("pck"))
            shutil.copytree(p("pck"), p("ppart/ck"))
            api.reset_epoch_metrics()
            runs["ppart"] = _train("port", resume, p("ppart"))
            runs["ppart_metrics"] = dict(api.EPOCH_METRICS)
            if jax_too:
                runs["jfull"] = _train("jax", argv, p("jfull"))
                runs["jkill"] = _train("jax", argv, p("kill"), kill)
                os.rename(p("kill/ck"), p("jck"))
                shutil.copytree(p("jck"), p("xp/ck"))
                runs["xp"] = _train("port", resume, p("xp"))
                shutil.copytree(p("pck"), p("xj/ck"))
                runs["xj"] = _train("jax", resume, p("xj"))
        _CASES[variant] = runs
        return runs

    return make


# --- kill at epoch 1 of 3 and resume ---------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_kill_and_resume_is_byte_identical(scenarios, variant):
    """The port's killed-then-resumed run ends on its uninterrupted run's
    kernel.opt, byte for byte, and replays its stream from EPOCH 2 on; the
    killed run's stream is a prefix of the uninterrupted one."""
    runs = scenarios(variant)
    full, kill, part = runs["pfull"], runs["pkill"], runs["ppart"]
    assert full["rc"] == kill["rc"] == part["rc"] == 0, part["err"]
    assert part["opt"] == full["opt"]
    assert _tail(part["out"]) == _tail(full["out"])
    stop = "NN: CKPT: interrupted at epoch 1/3; state saved -- continue " \
           "with train_nn --resume\n"
    assert kill["out"].endswith(stop)
    assert "EPOCH        2/" not in kill["out"]
    assert full["out"].startswith(kill["out"][:kill["out"].index(stop)])
    # one CKPT line an epoch, after the epoch's lines, before the banner
    for e in range(1, EPOCHS + 1):
        line = f"NN: CKPT: snapshot ep{e:08d}\n"
        assert full["out"].count(line) == 1
        if e < EPOCHS:
            assert full["out"].index(line) < full["out"].index(
                f"NN: EPOCH {e + 1:8d}/")
    assert full["out"].rindex("N_ITER=") < full["out"].index(
        f"NN: CKPT: snapshot ep{EPOCHS:08d}\n")


@pytest.mark.parametrize("variant", F64)
def test_resumed_run_matches_jax(scenarios, variant):
    """At f64 the port's resumed stream from EPOCH 2 on equals the JAX
    package's uninterrupted stream, and its kernel.opt is within the
    parity_fuzz bound of it; the uninterrupted streams are equal whole."""
    runs = scenarios(variant)
    kind = VARIANTS[variant][0]
    jfull, pfull, part = runs["jfull"], runs["pfull"], runs["ppart"]
    assert jfull["rc"] == 0, jfull["err"]
    assert pfull["out"] == jfull["out"]
    assert pfull["err"] == jfull["err"]
    assert _tail(part["out"]) == _tail(jfull["out"])
    assert _werr(part["opt"], jfull["opt"]) < _tol(kind, jfull["out"])


@pytest.mark.parametrize("variant", F64)
def test_jax_bundle_resumes_in_the_port(scenarios, variant):
    runs = scenarios(variant)
    kind = VARIANTS[variant][0]
    assert runs["jkill"]["rc"] == 0 and runs["xp"]["rc"] == 0, \
        runs["xp"]["err"]
    assert _tail(runs["xp"]["out"]) == _tail(runs["jfull"]["out"])
    assert _werr(runs["xp"]["opt"], runs["jfull"]["opt"]) \
        < _tol(kind, runs["jfull"]["out"])


@pytest.mark.parametrize("variant", F64)
def test_port_bundle_resumes_in_jax(scenarios, variant):
    runs = scenarios(variant)
    kind = VARIANTS[variant][0]
    assert runs["xj"]["rc"] == 0, runs["xj"]["err"]
    assert _tail(runs["xj"]["out"]) == _tail(runs["jfull"]["out"])
    assert _werr(runs["xj"]["opt"], runs["pfull"]["opt"]) \
        < _tol(kind, runs["jfull"]["out"])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_checkpointed_runs_are_resident(scenarios, variant):
    """A checkpointed run and its resume go through the device-resident
    epoch pipeline: one int32 permutation uploaded an epoch."""
    runs = scenarios(variant)
    for key, epochs in (("pfull_metrics", EPOCHS),
                        ("ppart_metrics", EPOCHS - 1)):
        met = runs[key]
        assert met["mode"] == "resident", met
        assert met["epochs"] == epochs
        assert met["h2d_bytes"] == epochs * 4 * N_SAMP


def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


_VOLATILE = {"created", "updated", "fingerprint", "fingerprints",
             "final_fingerprint"}


def _same_json(a, b, tol, swap=("", "")):
    """Same keys; equal non-float fields (apart from times and
    fingerprints, and with ``swap`` applied to ``a``'s paths); floats
    within ``tol``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (a, b)
        for k in a:
            if k not in _VOLATILE:
                _same_json(a[k], b[k], tol, swap)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_json(x, y, tol, swap)
    elif isinstance(a, float):
        assert isinstance(b, float) and abs(a - b) <= tol, (a, b)
    elif isinstance(a, str):
        assert a.replace(*swap) == b, (a, b)
    else:
        assert a == b and type(a) is type(b), (a, b)


@pytest.mark.parametrize("variant", F64)
def test_bundles_agree_across_packages(scenarios, variant):
    """The two packages' epoch-1 bundles: the same npz keys, shapes and
    dtypes, equal ``rng`` and ``meta``, weights within the bound;
    snapshot.json and manifest.json with the same keys and equal fields
    apart from the times and fingerprints."""
    runs = scenarios(variant)
    root = runs["root"]
    tol = _tol(VARIANTS[variant][0], runs["jfull"]["out"])
    jb = os.path.join(root, "jck", "ep00000001")
    pb = os.path.join(root, "pck", "ep00000001")
    jz, pz = _npz(os.path.join(jb, "state.npz")), \
        _npz(os.path.join(pb, "state.npz"))
    assert sorted(jz) == sorted(pz)
    for k in jz:
        assert jz[k].shape == pz[k].shape and jz[k].dtype == pz[k].dtype, k
        if k.startswith("w"):
            assert float(np.abs(jz[k] - pz[k]).max()) < tol, k
        else:
            np.testing.assert_array_equal(jz[k], pz[k])
    assert "rng" in pz and pz["rng"].shape == (33,)
    for name in ("snapshot.json",):
        with open(os.path.join(jb, name)) as a, \
                open(os.path.join(pb, name)) as b:
            _same_json(json.load(a), json.load(b), 1e-12)
    with open(os.path.join(root, "jck", "manifest.json")) as a, \
            open(os.path.join(root, "pck", "manifest.json")) as b:
        _same_json(json.load(a), json.load(b), 1e-12)


@pytest.mark.parametrize("variant", ["ANN-BPM", "SNN-BPM"])
def test_pack_bundle_blobs_are_identical_across_packages(scenarios, variant,
                                                         tmp_path):
    from hpnn_tpu.ckpt import replicate as jax_rep
    from hpnn_tpu_torch.ckpt import replicate, verify_bundle

    runs = scenarios(variant)
    for src in ("jck", "pck"):
        bundle = os.path.join(runs["root"], src, "ep00000001")
        jblob, jmeta = jax_rep.pack_bundle(bundle)
        pblob, pmeta = replicate.pack_bundle(bundle)
        assert pblob == jblob and pmeta == jmeta
        # each package unpacks the other's blob to the same bytes
        for unpack, dest in ((replicate.unpack_bundle, "p"),
                             (jax_rep.unpack_bundle, "j")):
            out = unpack(jblob if dest == "p" else pblob,
                         str(tmp_path / f"{src}-{dest}"))
            assert verify_bundle(out) == (True, "ok") or \
                verify_bundle(out)[0]
            for name in ("kernel.opt", "state.npz", "snapshot.json"):
                with open(os.path.join(out, name), "rb") as a, \
                        open(os.path.join(bundle, name), "rb") as b:
                    assert a.read() == b.read()
        bad = bytearray(jblob)
        bad[len(bad) // 2] ^= 0xFF
        with pytest.raises(replicate.ReplicateError):
            replicate.unpack_bundle(bytes(bad), str(tmp_path / "bad"))


def test_replica_restores_a_lost_checkpoint_dir(scenarios, tmp_path):
    """Kill with ``--replicate-to``, lose the checkpoint dir, resume with
    ``--replicate-to``: epoch 1 comes back from the replica and the run
    ends on the uninterrupted kernel.opt; the JAX package restores the
    port's replica the same way, to the same stream."""
    runs = scenarios("ANN-BP")
    conf = runs["conf"]
    base = ["-v", "-v", "--epochs", str(EPOCHS), "--ckpt-dir", "ck",
            "--replicate-to", "rep"]
    outs = {}
    for pkg in ("port", "jax"):
        cwd = str(tmp_path / pkg)
        kill = _train("port", [*base, "--ckpt-every", "1", conf], cwd,
                      {"HPNN_CKPT_KILL_AT_EPOCH": "1"})
        assert kill["rc"] == 0
        rep = [d for d in os.listdir(os.path.join(cwd, "rep"))]
        assert len(rep) == 1
        blobs = [f for f in os.listdir(os.path.join(cwd, "rep", rep[0]))
                 if f.endswith(".bundle")]
        assert len(blobs) == 1
        shutil.rmtree(os.path.join(cwd, "ck"))
        res = _train(pkg, [*base, "--resume", conf], cwd)
        assert res["rc"] == 0, res["err"]
        assert os.path.isdir(os.path.join(cwd, "ck", "ep00000001"))
        outs[pkg] = res
    assert outs["port"]["opt"] == runs["pfull"]["opt"]
    assert _tail(outs["port"]["out"]) == _tail(outs["jax"]["out"])
    assert _werr(outs["jax"]["opt"], runs["jfull"]["opt"]) < 5e-12


def test_replica_failure_warns_at_the_end(scenarios, tmp_path):
    """A destination that cannot be written costs a warning a bundle after
    the training stream, never the run or its bundles."""
    runs = scenarios("ANN-BP")
    (tmp_path / "rep").write_text("a file where the replica dir should be")
    res = _train("port", ["-v", "--epochs", "2", "--ckpt-every", "1",
                          "--ckpt-dir", "ck", "--replicate-to", "rep",
                          runs["conf"]], str(tmp_path))
    assert res["rc"] == 0, res["err"]
    warns = [ln for ln in res["out"].splitlines() if "replication of" in ln]
    assert len(warns) == 2 and res["out"].endswith(warns[-1] + "\n")
    assert warns[0].startswith("NN(WARN): CKPT: replication of ")
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "ep00000001", "ep00000002", "manifest.json"]


def test_replicate_to_router_exits_later(tmp_path, monkeypatch, scenarios):
    """``--replicate-to http://...`` (a mesh router) is refused before
    anything is written, as an option and from ``HPNN_REPLICATE_TO``."""
    from hpnn_tpu_torch.cli import train_nn_main

    runs = scenarios("ANN-BP")
    monkeypatch.chdir(tmp_path)
    err = io.StringIO()
    with pytest.raises(SystemExit) as exc, contextlib.redirect_stderr(err):
        train_nn_main(["--epochs", "2", "--replicate-to",
                       "http://127.0.0.1:1", "--device", "cpu",
                       runs["conf"]])
    assert exc.value.code != 0 and "not ported yet" in err.getvalue()
    assert not (tmp_path / "kernel.tmp").exists()
    res = _train("port", ["--epochs", "2", runs["conf"]],
                 str(tmp_path / "env"),
                 {"HPNN_REPLICATE_TO": "http://127.0.0.1:1"})
    assert res["rc"] != 0 and "not ported yet" in res["err"]
    assert os.listdir(tmp_path / "env") == []


# --- tests/test_ckpt.py's cases, through both packages ---------------------

def _both(scenarios, tmp_path, steps):
    """Run ``steps`` -- a list of (argv-without-conf, env) -- in
    ``tmp_path/<pkg>`` for each package; returns {pkg: [results]}."""
    conf = scenarios("ANN-BP")["conf"]
    got = {}
    for pkg in ("jax", "port"):
        cwd = str(tmp_path / pkg)
        got[pkg] = [_train(pkg, ["-v", "-v", *argv, conf], cwd, env)
                    for argv, env in steps]
    return got


def _manifest(tmp_path, pkg, ckdir="ck"):
    from hpnn_tpu_torch.ckpt import read_manifest

    return read_manifest(str(tmp_path / pkg / ckdir))


def _same_manifests(tmp_path, ckdir="ck"):
    """The two packages' manifests of ``_both``'s runs agree."""
    _same_json(_manifest(tmp_path, "jax", ckdir),
               _manifest(tmp_path, "port", ckdir), 1e-12,
               (str(tmp_path / "jax"), str(tmp_path / "port")))


def test_resume_restores_error_trajectory_and_epoch(scenarios, tmp_path):
    got = _both(scenarios, tmp_path, [
        (["--epochs=2", "--ckpt-every=1", "--ckpt-dir=ck"], None),
        (["--epochs=4", "--resume", "--ckpt-dir=ck"], None)])
    for pkg in ("jax", "port"):
        first, second = got[pkg]
        assert first["rc"] == second["rc"] == 0
        assert "NN: EPOCH        3/       4" in second["out"]
        assert "NN: EPOCH        2/" not in second["out"]
    assert got["port"][1]["out"] == got["jax"][1]["out"]
    mj, mp = _manifest(tmp_path, "jax"), _manifest(tmp_path, "port")
    assert mp["epoch"] == 4 and len(mp["errors"]) == 4
    assert mp["generation"] == mj["generation"] == 6
    _same_manifests(tmp_path)


def test_bare_resume_continues_to_recorded_target(scenarios, tmp_path):
    """A bare --resume continues to the killed run's own --epochs goal;
    resuming a completed run trains nothing and says so."""
    full = scenarios("ANN-BP")["pfull"]
    got = _both(scenarios, tmp_path, [
        (["--epochs=3", "--ckpt-every=1", "--ckpt-dir=ck"],
         {"HPNN_CKPT_KILL_AT_EPOCH": "1"}),
        (["--resume", "--ckpt-dir=ck"], None),
        (["--resume", "--ckpt-dir=ck"], None)])
    port, jax = got["port"], got["jax"]
    assert [r["rc"] for r in port] == [0, 0, 0]
    assert "NN: EPOCH        3/       3" in port[1]["out"]
    assert port[1]["opt"] == full["opt"]
    assert port[1]["out"] == jax[1]["out"]
    note = "nothing left to train"
    assert note in port[2]["err"] and port[2]["err"] == jax[2]["err"]
    assert port[2]["out"] == jax[2]["out"]
    assert port[2]["opt"] == port[1]["opt"]


def test_every_zero_still_bundles_final_epoch(scenarios, tmp_path):
    from hpnn_tpu_torch import ckpt

    got = _both(scenarios, tmp_path, [
        (["--epochs=2", "--ckpt-every=0", "--ckpt-dir=ck"], None)])
    out = got["port"][0]["out"]
    assert "CKPT: snapshot ep00000001" not in out
    assert "CKPT: snapshot ep00000002" in out
    assert out == got["jax"][0]["out"]
    assert _manifest(tmp_path, "port")["latest"] == "ep00000002"
    snap = ckpt.load_snapshot(str(tmp_path / "port" / "ck"))
    assert snap.epoch == 2 and snap.target_epochs == 2
    _same_manifests(tmp_path)


def test_ckpt_keep_alone_enables_checkpointing(scenarios, tmp_path):
    got = _both(scenarios, tmp_path, [(["--epochs=2", "--ckpt-keep=5"],
                                       None)])
    assert "CKPT: snapshot" in got["port"][0]["out"]
    assert got["port"][0]["out"] == got["jax"][0]["out"]
    mp = _manifest(tmp_path, "port", "ckpt")   # the default ./ckpt
    assert mp is not None and mp["retention"]["keep_last"] == 5
    _same_manifests(tmp_path, "ckpt")


def test_signal_snapshot_off_the_grid(scenarios, tmp_path):
    """--ckpt-every 2 and a kill at epoch 1: the signal path still writes
    a final snapshot for the odd epoch."""
    from hpnn_tpu_torch import ckpt

    got = _both(scenarios, tmp_path, [
        (["--epochs=4", "--ckpt-every=2", "--ckpt-dir=ck"],
         {"HPNN_CKPT_KILL_AT_EPOCH": "1"})])
    out = got["port"][0]["out"]
    assert "CKPT: snapshot ep00000001" in out
    assert out == got["jax"][0]["out"]
    snap = ckpt.load_snapshot(str(tmp_path / "port" / "ck"))
    assert snap is not None and snap.epoch == 1


def test_explicit_resume_path_keeps_checkpoint_home(scenarios, tmp_path):
    home = {pkg: str(tmp_path / pkg / "home") for pkg in ("jax", "port")}
    conf = scenarios("ANN-BP")["conf"]
    res = {}
    for pkg in ("jax", "port"):
        cwd = str(tmp_path / pkg)
        kill = _train(pkg, ["--epochs=3", "--ckpt-every=1",
                            "--ckpt-dir=home", conf], cwd,
                      {"HPNN_CKPT_KILL_AT_EPOCH": "1"})
        assert kill["rc"] == 0
        res[pkg] = _train(pkg, ["-v", "-v", f"--resume={home[pkg]}", conf],
                          cwd)
        assert res[pkg]["rc"] == 0
        assert not os.path.isdir(os.path.join(cwd, "ckpt"))
    assert res["port"]["out"] == res["jax"]["out"]
    mj, mp = _manifest(tmp_path, "jax", "home"), \
        _manifest(tmp_path, "port", "home")
    assert mp["epoch"] == 3 and mp["generation"] == mj["generation"] == 5


@pytest.mark.parametrize("case", ["no-snapshot", "topology"])
def test_resume_failures_are_loud(scenarios, tmp_path, case):
    conf = scenarios("ANN-BP")["conf"]
    res = {}
    for pkg in ("jax", "port"):
        cwd = str(tmp_path / pkg)
        target = conf
        if case == "topology":
            first = _train(pkg, ["--epochs=1", "--ckpt-every=1",
                                 "--ckpt-dir=ck", conf], cwd)
            assert first["rc"] == 0
            target = os.path.join(cwd, "other.conf")
            with open(conf) as fp, open(target, "w") as out:
                text = fp.read().replace(f"[hidden] {N_HID}", "[hidden] 5")
                out.write(re.sub(r"\[init\] \S+", "[init] generate", text))
        res[pkg] = _train(pkg, ["--resume", "--ckpt-dir=ck", target], cwd)
    assert res["port"]["rc"] == -1
    assert res["port"]["err"] == res["jax"]["err"].replace(
        str(tmp_path / "jax"), str(tmp_path / "port"))
    assert "FAILED to resume" in res["port"]["err"]
    assert not os.path.exists(tmp_path / "port" / "kernel.tmp") \
        or case == "topology"


def test_world_size_mismatch_is_refused(scenarios, tmp_path):
    """A bundle a multi-process run wrote resumes only at that world size:
    the port runs one process and refuses it before writing anything."""
    runs = scenarios("ANN-BP")
    ck = tmp_path / "ck"
    shutil.copytree(os.path.join(runs["root"], "pck"), ck)
    meta_path = ck / "ep00000001" / "snapshot.json"
    meta = json.loads(meta_path.read_text())
    meta["world_size"] = 2
    meta_path.write_text(json.dumps(meta, indent=1) + "\n")
    manifest = json.loads((ck / "manifest.json").read_text())
    for entry in manifest["snapshots"]:
        entry["fingerprints"].pop("snapshot.json")
    (ck / "manifest.json").write_text(json.dumps(manifest))
    res = _train("port", ["--resume", "--ckpt-dir=ck", runs["conf"]],
                 str(tmp_path))
    assert res["rc"] == -1
    assert "written by a 2-process run" in res["err"]
    assert not (tmp_path / "kernel.tmp").exists()


def _flip_bit(path, pos):
    with open(path, "r+b") as fp:
        data = bytearray(fp.read())
        pos %= len(data)
        data[pos] ^= 0x10
        fp.seek(0)
        fp.write(bytes(data))


def test_corrupt_newest_bundle_falls_back(scenarios, tmp_path):
    """Kill at epoch 2, corrupt the newest bundle, resume: both packages
    warn with the same text, walk back to epoch 1 and replay the same
    stream; the port ends on the uninterrupted kernel.opt."""
    runs = scenarios("ANN-BP")
    conf = runs["conf"]
    res = {}
    for pkg in ("jax", "port"):
        cwd = str(tmp_path / pkg)
        kill = _train(pkg, ["--epochs=3", "--ckpt-every=1",
                            "--ckpt-dir=ck", conf], cwd,
                      {"HPNN_CKPT_KILL_AT_EPOCH": "2"})
        assert kill["rc"] == 0
        _flip_bit(os.path.join(cwd, "ck", "ep00000002", "state.npz"), 4096)
        res[pkg] = _train(pkg, ["-v", "-v", "--epochs=3", "--resume",
                                "--ckpt-dir=ck", conf], cwd)
        assert res[pkg]["rc"] == 0
        out = res[pkg]["out"]
        assert "failed verification (state.npz: sha256 mismatch)" in out
        assert "ckpt_fallback: bundle=" in out
    assert res["port"]["out"] == res["jax"]["out"].replace(
        str(tmp_path / "jax"), str(tmp_path / "port"))
    assert res["port"]["opt"] == runs["pfull"]["opt"]


def test_run_nn_warns_on_fingerprint_mismatch(scenarios, tmp_path):
    """run_nn's staleness guard, with --ckpt-dir and with the default
    ./ckpt: no warning on the recorded kernel, the same warning with both
    paths on a changed one, none after a plain retrain refreshed it."""
    conf = scenarios("ANN-BP")["conf"]
    outs = {}
    for pkg in ("jax", "port"):
        cwd = str(tmp_path / pkg)
        for ck in ("ckpt", "elsewhere"):
            assert _train(pkg, ["--epochs=1", "--ckpt-every=1",
                                f"--ckpt-dir={ck}", conf], cwd)["rc"] == 0
        cont = os.path.join(cwd, "cont.conf")
        with open(conf) as fp, open(cont, "w") as out:
            out.write(re.sub(r"\[init\] \S+", "[init] kernel.opt",
                             fp.read()))
        got = [_run_nn(pkg, ["-v", cont], cwd),
               _run_nn(pkg, ["-v", "--ckpt-dir", "elsewhere", cont], cwd)]
        with open(os.path.join(cwd, "kernel.opt"), "a") as fp:
            fp.write("\n")   # the weights change behind the manifest
        got += [_run_nn(pkg, ["-v", cont], cwd),
                _run_nn(pkg, ["-v", "--ckpt-dir=elsewhere", cont], cwd)]
        assert _train(pkg, [conf], cwd)["rc"] == 0   # a plain retrain
        got += [_run_nn(pkg, ["-v", cont], cwd)]
        outs[pkg] = got
    port = outs["port"]
    assert all(rc == 0 for rc, _, _ in port)
    assert "fingerprint mismatch" not in port[0][1] + port[1][1]
    for (_, out, _), ck in ((port[2], "ckpt"), (port[3], "elsewhere")):
        kp = str(tmp_path / "port" / "kernel.opt")
        assert (f"NN(WARN): kernel fingerprint mismatch: {kp} does not "
                f"match the manifest {tmp_path / 'port' / ck}"
                "/manifest.json (stale or modified weights?)\n") in out
    assert "fingerprint mismatch" not in port[4][1]
    jax = outs["jax"]
    for (prc, pout, perr), (jrc, jout, jerr) in zip(port, jax):
        assert prc == jrc
        assert pout == jout.replace(str(tmp_path / "jax"),
                                    str(tmp_path / "port"))


# --- bundle format, retention and the manager ------------------------------

def _gen(seed, n_in, hiddens, n_out):
    from hpnn_tpu_torch.models.kernel import generate_kernel

    return generate_kernel(seed, n_in, hiddens, n_out)[0]


def test_snapshot_round_trip_is_bit_exact_across_packages(tmp_path):
    from hpnn_tpu import ckpt as jax_ckpt
    from hpnn_tpu_torch import ckpt
    from hpnn_tpu_torch.io.kernel_io import load_kernel
    from hpnn_tpu_torch.utils.glibc_random import GlibcRandom

    k = _gen(42, 5, [4], 3)
    k.weights = [w + np.pi * 1e-7 for w in k.weights]  # past %17.15f
    rng = GlibcRandom(99)
    rng.randoms(17)
    kw = dict(weights=k.weights,
              momentum=[np.zeros_like(w) for w in k.weights],
              rng_state=rng.get_state(), seed=99,
              errors=[0.5, 0.25, 0.125], name=k.name, train="BPM")
    for mod, tag in ((ckpt, "p"), (jax_ckpt, "j")):
        entry = mod.write_snapshot(str(tmp_path / tag), 3, **kw)
        mod.publish_snapshot(str(tmp_path / tag), entry, seed=99,
                             errors=kw["errors"])
    for reader in (ckpt, jax_ckpt):
        for tag in ("p", "j"):
            snap = reader.load_snapshot(str(tmp_path / tag))
            assert snap.epoch == 3 and snap.seed == 99
            for a, b in zip(snap.weights, k.weights):
                assert a.dtype == np.float64
                np.testing.assert_array_equal(a, b)
            assert len(snap.momentum) == 2
            assert snap.rng_state == rng.get_state()
            assert snap.errors == [0.5, 0.25, 0.125]
    for name in ("kernel.opt", "state.npz"):
        a = (tmp_path / "p" / "ep00000003" / name).read_bytes()
        assert a == (tmp_path / "j" / "ep00000003" / name).read_bytes()
    snap = ckpt.load_snapshot(str(tmp_path / "p"))
    k2 = load_kernel(os.path.join(snap.path, ckpt.SNAPSHOT_KERNEL))
    assert [int(p) for p in k2.params] == snap.topology == [5, 4, 3]
    assert snap.fingerprint == ckpt.fingerprint_file(
        os.path.join(snap.path, ckpt.SNAPSHOT_KERNEL))


def test_snapshot_write_leaves_no_tmp(tmp_path):
    from hpnn_tpu_torch import ckpt

    ck = str(tmp_path / "ck")
    k = _gen(1, 4, [3], 2)
    for epoch in (1, 2):
        ckpt.write_snapshot(ck, epoch, weights=k.weights, momentum=None,
                            rng_state=None, seed=1, errors=[])
    assert sorted(os.listdir(ck)) == ["ep00000001", "ep00000002"]
    # a stale stage from a crashed writer is cleaned up on rewrite
    os.makedirs(os.path.join(ck, f".tmp.ep00000002.{os.getpid()}"))
    ckpt.write_snapshot(ck, 2, weights=k.weights, momentum=None,
                        rng_state=None, seed=1, errors=[])
    assert not any(n.startswith(".tmp") for n in os.listdir(ck))


def test_retention_keeps_last_n_plus_best(tmp_path):
    from hpnn_tpu import ckpt as jax_ckpt
    from hpnn_tpu_torch import ckpt

    k = _gen(1, 4, [3], 2)
    errs = [0.5, 0.1, 0.4, 0.3]   # best at epoch 2
    tags = {}
    for mod, tag in ((ckpt, "p"), (jax_ckpt, "j")):
        ck = str(tmp_path / tag)
        for epoch in range(1, len(errs) + 1):
            entry = mod.write_snapshot(ck, epoch, weights=k.weights,
                                       momentum=None, rng_state=None,
                                       seed=1, errors=errs[:epoch])
            manifest = mod.publish_snapshot(ck, entry, seed=1,
                                            errors=errs[:epoch],
                                            keep_last=2)
        tags[tag] = sorted(t for t in os.listdir(ck) if t.startswith("ep"))
        assert [s["tag"] for s in manifest["snapshots"]] == tags[tag]
        assert manifest["latest"] == "ep00000004"
    assert tags["p"] == tags["j"] == ["ep00000002", "ep00000003",
                                      "ep00000004"]


def test_manager_write_failures_surface_at_flush(tmp_path):
    from hpnn_tpu_torch.ckpt import CheckpointManager

    class NN:
        pass

    nn = NN()
    nn.conf = type("C", (), {"train": "BP", "seed": 1, "dtype": "f64"})()
    nn.kernel = _gen(3, 4, [3], 2)
    nn.shuffle_rng = None
    mgr = CheckpointManager(str(tmp_path / "nope" / "deep"), every=1)
    (tmp_path / "nope").write_text("in the way")   # the dir cannot exist
    mgr.epoch_done(nn, 1, 0.5)
    with pytest.raises(OSError):
        mgr.flush()


def test_manager_writes_in_epoch_order_on_the_pool(tmp_path):
    """Queued bundles land in epoch order with one generation each, and
    the writer prints nothing: the one CKPT line a snapshot is the
    training thread's."""
    from hpnn_tpu_torch.ckpt import CheckpointManager, read_manifest
    from hpnn_tpu_torch.utils import nn_log

    class NN:
        pass

    nn = NN()
    nn.conf = type("C", (), {"train": "BPM", "seed": 5, "dtype": "f64"})()
    nn.kernel = _gen(3, 4, [3], 2)
    nn.shuffle_rng = None
    nn.trainer_state = None
    mgr = CheckpointManager(str(tmp_path / "ck"), every=1, keep_last=0)
    with nn_log.capture() as lines:
        for epoch in range(1, 6):
            mgr.epoch_done(nn, epoch, 1.0 / epoch)
        mgr.flush()
    assert lines == [("out", f"CKPT: snapshot ep{e:08d}\n")
                     for e in range(1, 6)]
    man = read_manifest(str(tmp_path / "ck"))
    assert man["generation"] == 5 and man["latest"] == "ep00000005"
    assert [s["epoch"] for s in man["snapshots"]] == [1, 2, 3, 4, 5]
    with np.load(tmp_path / "ck" / "ep00000003" / "state.npz") as z:
        assert sorted(z.files) == ["m0", "m1", "meta", "w0", "w1"]
        assert not z["m0"].any()   # BPM momentum is zero at a boundary


def test_resume_path_grammar(tmp_path, capsys):
    """--resume [PATH]: a separated token is the path only when it looks
    like a checkpoint, as in the JAX package's parser."""
    from hpnn_tpu import cli as jax_cli
    from hpnn_tpu_torch import ckpt, cli

    ck = tmp_path / "ck"
    ck.mkdir()
    (ck / "manifest.json").write_text("{}")
    assert ckpt.looks_like_checkpoint(str(ck))
    assert not ckpt.looks_like_checkpoint(str(tmp_path / "nn.conf"))
    for argv in (["--resume", str(ck), "some.conf"],
                 ["--resume", "some.conf"], [f"--resume={ck}"],
                 ["--resume", "--ckpt-every", "2", "x.conf"]):
        port = cli._parse_args(argv, "train_nn")
        jax = jax_cli._parse_args(argv, "train_nn", train=True)
        assert port[0] == jax[0]
        for key in ("resume", "ckpt_every", "ckpt_dir", "ckpt_keep"):
            assert port[1][key] == jax[2][key], key
        _reset_logs()
    for argv in (["--epochs", "0"], ["--resume="], ["--ckpt-every", "x"],
                 ["--ckpt-dir="]):
        with pytest.raises(SystemExit):
            cli._parse_args(argv, "train_nn")
    with pytest.raises(SystemExit):
        cli._parse_args(["--resume", "x"], "run_nn")
    assert cli._parse_args(["--ckpt-dir", "d", "a.conf"],
                           "run_nn")[1]["ckpt_dir"] == "d"
    capsys.readouterr()


# --- train_loop's hooks ----------------------------------------------------

def test_stop_latched_from_on_epoch_ends_with_a_final_bundle(scenarios,
                                                             tmp_path,
                                                             monkeypatch):
    """A ``stop`` event latched from ``on_epoch`` at epoch 2 of 4 ends the
    run there with a final bundle, as in hpnn_tpu, with the same stream
    and manifest."""
    from hpnn_tpu import api as jax_api
    from hpnn_tpu import ckpt as jax_ckpt
    from hpnn_tpu_torch import api, ckpt
    from hpnn_tpu_torch.utils import nn_log

    conf = scenarios("ANN-BP")["conf"]
    got = {}
    for pkg, mod_api, mod_ckpt in (("jax", jax_api, jax_ckpt),
                                   ("port", api, ckpt)):
        cwd = tmp_path / pkg
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        stop = threading.Event()
        seen = []

        def on_epoch(epoch, manager, stop=stop, seen=seen):
            seen.append((epoch, manager.last_saved_epoch))
            if epoch == 2:
                stop.set()

        out = io.StringIO()
        _reset_logs()
        nn_log.set_verbosity(2)
        from hpnn_tpu.utils import nn_log as jax_log

        jax_log.set_verbosity(2)
        with contextlib.redirect_stdout(out):
            nn = mod_api.configure(conf)
            mgr = mod_ckpt.CheckpointManager("ck", every=3,
                                             target_epochs=4)
            kw = {"device": "cpu"} if pkg == "port" else {}
            ok = mod_ckpt.train_loop(nn, 4, manager=mgr, stop=stop,
                                     on_epoch=on_epoch, **kw)
            mgr.record_final("final.opt")
        _reset_logs()
        if pkg == "jax" and jax_api._prefetch_thread is not None:
            jax_api._prefetch_thread.join()
        got[pkg] = (ok, seen, out.getvalue(),
                    ckpt.read_manifest(str(cwd / "ck")))
    ok, seen, out, man = got["port"]
    assert ok == (True, True)
    assert seen == [(1, 0), (2, 0)]
    assert out.endswith("NN: CKPT: snapshot ep00000002\nNN: CKPT: "
                        "interrupted at epoch 2/4; state saved -- "
                        "continue with train_nn --resume\n")
    assert man["latest"] == "ep00000002"
    assert got["jax"][:3] == got["port"][:3]
    _same_json(got["jax"][3], man, 1e-12,
               (str(tmp_path / "jax"), str(tmp_path / "port")))


# --- the shared modules the checkpoints use --------------------------------

def test_nn_event_text_json_and_replay(monkeypatch, capsys):
    from hpnn_tpu.utils import nn_log as jax_log
    from hpnn_tpu_torch.utils import nn_log

    for mod in (nn_log, jax_log):
        mod.set_verbosity(1)
        mod.nn_event("ckpt_fallback", bundle="b-1", reason="torn")
    text = capsys.readouterr().out
    assert text == "NN(WARN): ckpt_fallback: bundle=b-1 reason=torn\n" * 2
    monkeypatch.setenv("HPNN_LOG_JSON", "1")
    nn_log.set_verbosity(0)   # an event in JSON mode is not gated
    with nn_log.capture() as entries:
        nn_log.nn_event("ckpt_fallback", bundle="b-2", reason="torn")
    assert capsys.readouterr().out == ""
    nn_log.replay(entries)
    rec = json.loads(capsys.readouterr().out)
    assert rec["level"] == "event" and rec["event"] == "ckpt_fallback"
    assert rec["bundle"] == "b-2" and rec["reason"] == "torn"
    _reset_logs()


def test_atomic_write_text_matches_jax(tmp_path):
    from hpnn_tpu.io import atomic as jax_atomic
    from hpnn_tpu_torch.io import atomic

    text = "[name] é\n1.5\n"
    atomic.atomic_write_text(str(tmp_path / "p"), text)
    jax_atomic.atomic_write_text(str(tmp_path / "j"), text)
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()
    assert sorted(os.listdir(tmp_path)) == ["j", "p"]   # no stage left


@pytest.mark.parametrize("env,want", [({}, None),
                                      ({"HPNN_IO_THREADS": "3"}, 3),
                                      ({"HPNN_IO_THREADS": "0"}, 1),
                                      ({"HPNN_IO_THREADS": "x"}, 1),
                                      ({"HPNN_NO_PARALLEL_IO": "1"}, 1)])
def test_io_threads_matches_jax(monkeypatch, env, want):
    from hpnn_tpu.io import corpus as jax_corpus
    from hpnn_tpu_torch.io import corpus

    for k in ("HPNN_IO_THREADS", "HPNN_NO_PARALLEL_IO"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert corpus.io_threads() == jax_corpus.io_threads()
    if want is not None:
        assert corpus.io_threads() == want
    assert corpus.io_pool() is corpus.io_pool()
