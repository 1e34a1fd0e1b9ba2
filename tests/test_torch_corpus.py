"""The port's corpus pipeline against the JAX package's, on the CPU.

A seeded corpus with every skip class -- an empty file (silent), a zero
input count (input read failed), a non-digit output count (output read
failed), a section count below the kernel's (dimension mismatch), an
over-long section (truncated) and values split over two lines (declined
by the native parser, re-read by the Python one) -- goes through
``hpnn_tpu.io.corpus`` and ``hpnn_tpu_torch.io.corpus``:

* ``load_ordered`` and ``load_resident`` give the same events, rows (bit
  for bit), stdout (at -v -v -v, the load line's time aside) and stderr,
  with the cache off (serial, Python parser), cold (parallel, native,
  pack built) and warm (from the pack);
* the packs of the two packages are byte-identical, and each package
  warm-loads the other's;
* a pack is invalidated by a touch, a resize, an added and a removed
  file; a corrupted data byte gives the JAX package's warning and a
  rebuild; ``gc_cache`` evicts the same list; a prefetch prints nothing;
  ``ChunkedPackWriter`` gives the direct pack's bytes;
* the native loader (``csrc/sample_loader.c``, built by ``ops/build.py``)
  agrees with both Python parsers, and fails loudly where it must;
* ``train_nn -v -v --epochs 3`` then ``run_nn -v -v`` through the port's
  CLI give the same bytes with the cache off, cold and warm, and the
  stream of the JAX package; a ``--resume`` warm-loads.

Each package gets its own cache dir wherever a mode is under test (both
read ``HPNN_CORPUS_CACHE``, and a pack is found by its dir's path), and
one dir only where a test shares packs on purpose.
"""

import contextlib
import io
import os
import re
import shutil
import subprocess

import numpy as np
import pytest

from hpnn_tpu.io import corpus as jcorpus
from hpnn_tpu.io import samples as jsamples
from hpnn_tpu.utils import nn_log as jlog
from hpnn_tpu_torch.io import corpus as tcorpus
from hpnn_tpu_torch.io import samples as tsamples
from hpnn_tpu_torch.utils import nn_log as tlog
from hpnn_tpu_torch.utils.glibc_random import GlibcRandom, shuffled_indices

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IN, N_OUT = 6, 3
CORPUS_ENV = ("HPNN_NO_CORPUS_CACHE", "HPNN_CORPUS_CACHE",
              "HPNN_CORPUS_CACHE_MAX_MB", "HPNN_NO_NATIVE_IO", "HPNN_IO_LIB",
              "HPNN_IO_THREADS", "HPNN_NO_PARALLEL_IO")
# mode -> (env, the load line's "(<mode>; native_io: <on|off>)")
MODES = {
    "off": ({"HPNN_NO_CORPUS_CACHE": "1", "HPNN_NO_PARALLEL_IO": "1",
             "HPNN_NO_NATIVE_IO": "1"}, "serial; native_io: off"),
    "cold": ({"HPNN_IO_THREADS": "4"}, "parallel; native_io: on"),
    "warm": ({"HPNN_IO_THREADS": "4"}, "pack; native_io: on"),
}


@pytest.fixture(scope="module", autouse=True)
def _jax_native_lib():
    """The JAX package's native loader, built as its own tests build it,
    so that both packages parse natively in the native modes."""
    r = subprocess.run(["make", "-C", os.path.join(REPO, "native"),
                        "libhpnn_io.so"], capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    yield
    jsamples._native_lib = None
    tsamples._native_lib = None


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """No ambient corpus knob, verbosity 3 in both packages, both native
    libraries probed anew, and the cache settings restored afterwards."""
    for k in CORPUS_ENV:
        monkeypatch.delenv(k, raising=False)
    jsamples._native_lib = tsamples._native_lib = None
    jlog.set_verbosity(3)
    tlog.set_verbosity(3)
    yield
    jlog.set_verbosity(0)
    tlog.set_verbosity(0)
    for mod in (jcorpus, tcorpus):
        mod.set_cache_dir(None)
        mod.set_cache_max_mb(None)
    jsamples._native_lib = tsamples._native_lib = None


def _write(path, text):
    with open(path, "w") as fp:
        fp.write(text)


def _values(vs):
    return " ".join(f"{v:8.5f}" for v in vs)


def _mixed_corpus(d, seed=7, n=12):
    """``n`` clean files and one of each skip class."""
    os.makedirs(d)
    rng = np.random.default_rng(seed)
    for i in range(n):
        _write(os.path.join(d, f"s{i:03d}"),
               f"[input] {N_IN}\n{_values(rng.uniform(-1, 1, N_IN))}\n"
               f"[output] {N_OUT}\n{_values(rng.uniform(-1, 1, N_OUT))}\n")
    _write(os.path.join(d, "empty"), "")
    _write(os.path.join(d, "bad_in"), "[input] 0\n\n[output] 3\n1 0 0\n")
    _write(os.path.join(d, "bad_out"),
           "[input] 6\n1 2 3 4 5 6\n[output] x\n1\n")
    _write(os.path.join(d, "short_dim"), "[input] 2\n1 2\n[output] 3\n1 0 0\n")
    _write(os.path.join(d, "long"),
           f"[input] 9\n{_values(rng.uniform(-1, 1, 9))}\n"
           f"[output] 4\n{_values(rng.uniform(-1, 1, 4))}\n")
    _write(os.path.join(d, "split"),
           "[input] 6\n0.5 0.25 0.125\n1 2 3\n[output] 3\n1 0 0\n")
    return d


def _listing(d, seed=1234):
    names = tsamples.list_sample_dir(d)
    assert names == jsamples.list_sample_dir(d)
    return names, shuffled_indices(GlibcRandom(seed), len(names))


def _env(monkeypatch, mode):
    for k in CORPUS_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in MODES[mode][0].items():
        monkeypatch.setenv(k, v)
    jsamples._native_lib = tsamples._native_lib = None


def _caches(tmp_path):
    """Each package's own cache dir."""
    jdir, tdir = str(tmp_path / "jcache"), str(tmp_path / "tcache")
    jcorpus.set_cache_dir(jdir)
    tcorpus.set_cache_dir(tdir)
    return jdir, tdir


def _captured(capsys, fn):
    capsys.readouterr()
    res = fn()
    cap = capsys.readouterr()
    return res, cap.out, cap.err


def _norm(text, *paths):
    """A stream with the load lines' times and the cache dirs blanked."""
    text = re.sub(r" in \d+\.\d+s", " in Ts", text)
    for p in paths:
        text = text.replace(p, "<cache>")
    return text


def _same_rows(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _pack_bytes(mod, d):
    with open(mod.pack_path(d), "rb") as fp:
        return fp.read()


# --- the two loaders in every mode ------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
def test_load_ordered_matches_jax(tmp_path, monkeypatch, capsys, mode):
    d = _mixed_corpus(str(tmp_path / "tests"))
    names, order = _listing(d)
    jdir, tdir = _caches(tmp_path)
    _env(monkeypatch, mode)
    args = (d, names, order, "TESTING", N_IN, N_OUT)
    if mode == "warm":
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            jcorpus.load_ordered(*args)
            tcorpus.load_ordered(*args)
    jres, jout, jerr = _captured(capsys, lambda: jcorpus.load_ordered(*args))
    tres, tout, terr = _captured(capsys, lambda: tcorpus.load_ordered(*args))
    assert tres[0] == jres[0]
    _same_rows(tres[1], jres[1])
    _same_rows(tres[2], jres[2])
    assert _norm(tout, tdir) == _norm(jout, jdir)
    assert terr == jerr
    assert f"({MODES[mode][1]})\n" in tout
    # every skip class reached the stream, once, in shuffle order
    assert terr.count("input read failed") == 1
    assert terr.count("output read failed") == 1
    assert terr.count("dimension mismatch") == 1
    assert [e[1] is None for e in tres[0]].count(True) == 4
    assert tres[1].shape == (14, N_IN)   # 12 clean + long + split
    assert os.path.isfile(tcorpus.pack_path(d)) == (mode != "off")


@pytest.mark.parametrize("mode", list(MODES))
def test_load_resident_matches_jax(tmp_path, monkeypatch, capsys, mode):
    d = _mixed_corpus(str(tmp_path / "samples"))
    names, order = _listing(d)
    jdir, tdir = _caches(tmp_path)
    _env(monkeypatch, mode)
    args = (d, names, N_IN, N_OUT)
    if mode == "warm":
        with contextlib.redirect_stdout(io.StringIO()):
            jcorpus.load_resident(*args)
            tcorpus.load_resident(*args)
    jrc, jout, jerr = _captured(capsys, lambda: jcorpus.load_resident(*args))
    trc, tout, terr = _captured(capsys, lambda: tcorpus.load_resident(*args))
    assert trc.status == jrc.status and trc.n_rows == jrc.n_rows == 14
    _same_rows(trc.X, jrc.X)
    _same_rows(trc.T, jrc.T)
    assert terr == jerr == ""
    # the port's line adds the load mode to the JAX package's
    assert _norm(tout).replace(f" ({MODES[mode][1]})", "") == _norm(jout)
    assert f"({MODES[mode][1]})\n" in tout
    (jev, jsel), jout, jerr = _captured(capsys,
                                        lambda: jrc.epoch_events(order))
    (tev, tsel), tout, terr = _captured(capsys,
                                        lambda: trc.epoch_events(order))
    assert tev == jev and tsel.tobytes() == jsel.tobytes()
    assert (tout, terr) == (jout, jerr) and terr.count("NN(ERR)") == 3


def test_pack_bytes_identical_to_jax(tmp_path, monkeypatch):
    """The same dir packed by each package, into its own cache dir: the
    same bytes, header JSON and trailer included, from either loader."""
    d = _mixed_corpus(str(tmp_path / "tests"))
    names, order = _listing(d)
    _caches(tmp_path)
    _env(monkeypatch, "cold")
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        jcorpus.load_ordered(d, names, order, "TESTING", N_IN, N_OUT)
        tcorpus.load_ordered(d, names, order, "TESTING", N_IN, N_OUT)
        packed = _pack_bytes(tcorpus, d)
        os.unlink(tcorpus.pack_path(d))
        tcorpus.load_resident(d, names, N_IN, N_OUT)
    assert tcorpus.pack_path(d) != jcorpus.pack_path(d)
    assert os.path.basename(tcorpus.pack_path(d)) \
        == os.path.basename(jcorpus.pack_path(d))
    jbytes = _pack_bytes(jcorpus, d)
    assert packed == jbytes == _pack_bytes(tcorpus, d)
    assert jbytes[:8] == b"HPNNPK01" and jbytes[-40:-32] == b"HPNNSH01"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pack_warm_loads_across_packages(tmp_path, monkeypatch, capsys,
                                         writer):
    """One shared cache dir: a pack written by either package is a warm
    load in the other, with the writer's rows, events and stderr; the
    pack's bytes are left as they were."""
    d = _mixed_corpus(str(tmp_path / "tests"))
    names, order = _listing(d)
    shared = str(tmp_path / "shared")
    jcorpus.set_cache_dir(shared)
    tcorpus.set_cache_dir(shared)
    _env(monkeypatch, "cold")
    first, second = (jcorpus, tcorpus) if writer == "jax" \
        else (tcorpus, jcorpus)
    args = (d, names, order, "TESTING", N_IN, N_OUT)
    wres, wout, werr = _captured(capsys, lambda: first.load_ordered(*args))
    built = _pack_bytes(first, d)
    rres, rout, rerr = _captured(capsys, lambda: second.load_ordered(*args))
    assert "(parallel; native_io: on)" in wout
    assert "(pack; native_io: on)" in rout
    assert rres[0] == wres[0] and rerr == werr
    _same_rows(rres[1], wres[1])
    _same_rows(rres[2], wres[2])
    assert _pack_bytes(second, d) == built
    rc, out, _ = _captured(
        capsys, lambda: second.load_resident(d, names, N_IN, N_OUT))
    assert rc.n_rows == 14 and "staged once" in out
    if second is tcorpus:
        assert "(pack; native_io: on)" in out
    assert _pack_bytes(second, d) == built


def test_concurrent_cold_loads_read_each_file_once(tmp_path, monkeypatch,
                                                   capsys):
    """Eight threads cold-load one dir at once (a short switch interval, a
    widened read): the build lock lets one of them read the files and the
    others load its pack, so every file is read once and every thread gets
    the same events, rows and diagnostics."""
    import sys
    import threading
    import time

    d = _mixed_corpus(str(tmp_path / "tests"))
    names, order = _listing(d)
    _caches(tmp_path)
    _env(monkeypatch, "cold")
    reads, real = [], tcorpus.read_sample_fast

    def slow(path, n_in, n_out):
        reads.append(path)
        time.sleep(0.002)
        return real(path, n_in, n_out)

    monkeypatch.setattr(tcorpus, "read_sample_fast", slow)
    results = [None] * 8

    def load(i):
        results[i] = tcorpus.load_ordered(d, names, order, "TESTING",
                                          N_IN, N_OUT)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=load, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(reads) == sorted(os.path.join(d, n) for n in names)
    for events, X, T in results[1:]:
        assert events == results[0][0]
        _same_rows(X, results[0][1])
        _same_rows(T, results[0][2])
    assert capsys.readouterr().err.count("input read failed") == 8


def _mutate(d, how):
    if how == "touch":
        st = os.stat(os.path.join(d, "s000"))
        os.utime(os.path.join(d, "s000"),
                 ns=(st.st_atime_ns, st.st_mtime_ns + 5 * 10**9))
    elif how == "resize":
        path = os.path.join(d, "s001")
        st = os.stat(path)
        with open(path, "a") as fp:
            fp.write("\n")
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))  # size only
    elif how == "add":
        _write(os.path.join(d, "s999"),
               "[input] 6\n1 2 3 4 5 6\n[output] 3\n1 -1 -1\n")
    else:
        os.unlink(os.path.join(d, "s002"))


@pytest.mark.parametrize("how", ["touch", "resize", "add", "remove"])
def test_pack_invalidation(tmp_path, monkeypatch, capsys, how):
    """A touched, resized, added or removed file invalidates the pack: the
    next load reads the files (the JAX package's answer on the changed
    dir) and rebuilds it, and the load after that is warm again."""
    d = _mixed_corpus(str(tmp_path / "tests"))
    _jdir, tdir = _caches(tmp_path)
    _env(monkeypatch, "cold")

    def load(mod):
        names, order = _listing(d)
        return _captured(capsys, lambda: mod.load_ordered(
            d, names, order, "TESTING", N_IN, N_OUT))

    load(tcorpus)
    assert "(pack;" in load(tcorpus)[1]
    _mutate(d, how)
    jres, _, jerr = load(jcorpus)
    tres, tout, terr = load(tcorpus)
    assert "(parallel; native_io: on)" in tout
    assert tres[0] == jres[0] and terr == jerr
    _same_rows(tres[1], jres[1])
    assert "(pack; native_io: on)" in load(tcorpus)[1]
    assert _pack_bytes(tcorpus, d) == _pack_bytes(jcorpus, d)


def test_corrupt_data_byte_rebuilds(tmp_path, monkeypatch, capsys):
    """One flipped byte in the data region fails the content sha256: the
    JAX package's warning, the rows read from the files, the pack
    rebuilt."""
    d = _mixed_corpus(str(tmp_path / "tests"))
    names, order = _listing(d)
    jdir, tdir = _caches(tmp_path)
    _env(monkeypatch, "cold")
    args = (d, names, order, "TESTING", N_IN, N_OUT)
    outs = {}
    for mod, cdir in ((jcorpus, jdir), (tcorpus, tdir)):
        _captured(capsys, lambda: mod.load_ordered(*args))
        hdr, data_off = mod._read_pack_header(mod.pack_path(d))
        with open(mod.pack_path(d), "r+b") as fp:
            fp.seek(data_off + 8 * N_IN + 3)
            byte = fp.read(1)
            fp.seek(-1, os.SEEK_CUR)
            fp.write(bytes([byte[0] ^ 0x40]))
        res, out, err = _captured(capsys, lambda: mod.load_ordered(*args))
        outs[mod] = (res, _norm(out, cdir), err)
        assert "(pack;" in _captured(capsys,
                                     lambda: mod.load_ordered(*args))[1]
    tres, tout, terr = outs[tcorpus]
    jres, jout, jerr = outs[jcorpus]
    assert tout == jout and terr == jerr and tres[0] == jres[0]
    _same_rows(tres[1], jres[1])
    assert ("NN(WARN): corpus cache: <cache>/corpus-"
            in tout) and ("failed its content sha256; rebuilding the pack "
                          "from source files\n" in tout)
    assert "(parallel; native_io: on)" in tout
    assert _pack_bytes(tcorpus, d) == _pack_bytes(jcorpus, d)


def test_gc_cache_evicts_the_same_list(tmp_path):
    """Two copies of one cache dir over a 1 MB cap: both packages evict
    the same packs, oldest first, keep the protected one and remove the
    evicted packs' lock files."""
    ages = {"a": 5, "b": 1, "c": 4, "d": 2, "e": 3}
    for mod, sub in ((jcorpus, "j"), (tcorpus, "t")):
        cdir = tmp_path / sub
        cdir.mkdir()
        for key, age in ages.items():
            path = cdir / f"corpus-{key * 20}.pack"
            path.write_bytes(b"\0" * (400 << 10))
            (cdir / f"corpus-{key * 20}.pack.lock").write_bytes(b"")
            os.utime(path, ns=(age * 10**9, age * 10**9))
        (cdir / "other.bin").write_bytes(b"\0" * (4 << 20))
        mod.set_cache_dir(str(cdir))
        mod.set_cache_max_mb(1)
    protect = ("corpus-" + "d" * 20 + ".pack",)
    evicted = {}
    for mod, sub in ((jcorpus, "j"), (tcorpus, "t")):
        got = mod.gc_cache(protect=tuple(str(tmp_path / sub / p)
                                         for p in protect))
        evicted[sub] = [os.path.basename(p) for p in got]
        left = sorted(os.listdir(tmp_path / sub))
        evicted[sub + "-left"] = left
    assert evicted["t"] == evicted["j"] == [
        "corpus-" + k * 20 + ".pack" for k in ("b", "e", "c")]
    assert evicted["t-left"] == evicted["j-left"]
    assert "corpus-" + "b" * 20 + ".pack.lock" not in evicted["t-left"]
    tcorpus.set_cache_max_mb(0)
    assert tcorpus.gc_cache() == []


def test_prefetch_prints_nothing(tmp_path, monkeypatch, capsys):
    """A prefetch builds the pack silently (at -v -v -v, with skip
    diagnostics in the dir); a second one finds it warm; with the cache
    off there is no prefetch at all."""
    d = _mixed_corpus(str(tmp_path / "tests"))
    _caches(tmp_path)
    _env(monkeypatch, "cold")
    capsys.readouterr()
    t = tcorpus.prefetch_pack_async(d, N_IN, N_OUT)
    t.join()
    assert capsys.readouterr() == ("", "")
    before = os.stat(tcorpus.pack_path(d)).st_mtime_ns
    tcorpus.prefetch_pack_async(d, N_IN, N_OUT).join()
    assert os.stat(tcorpus.pack_path(d)).st_mtime_ns == before
    assert capsys.readouterr() == ("", "")
    names, order = _listing(d)
    _, out, _ = _captured(capsys, lambda: tcorpus.load_ordered(
        d, names, order, "TESTING", N_IN, N_OUT))
    assert "(pack; native_io: on)" in out
    monkeypatch.setenv("HPNN_NO_CORPUS_CACHE", "1")
    assert tcorpus.prefetch_pack_async(d, N_IN, N_OUT) is None


def test_chunked_writer_matches_direct_pack(tmp_path, monkeypatch):
    """``ChunkedPackWriter``: three chunks added out of listing order give
    the JAX package's direct pack, byte for byte (and its own chunked
    writer's); a torn chunk is caught at finalize."""
    d = _mixed_corpus(str(tmp_path / "tests"))
    names, order = _listing(d)
    _caches(tmp_path)
    _env(monkeypatch, "cold")
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        jcorpus.load_ordered(d, names, order, "TESTING", N_IN, N_OUT)
    direct = _pack_bytes(jcorpus, d)
    chunks = [sorted(names)[i::3] for i in range(3)]
    for mod in (tcorpus, jcorpus):
        w = mod.ChunkedPackWriter(d, N_IN, N_OUT)
        for c in chunks:
            assert w.add_sample_files(c)
        assert w.n_chunks == 3 and w.n_rows == 14
        assert w.finalize()
        assert _pack_bytes(mod, d) == direct
        assert not [p for p in os.listdir(os.path.dirname(mod.pack_path(d)))
                    if ".chunk" in p]
    w = tcorpus.ChunkedPackWriter(d, N_IN, N_OUT)
    for c in chunks:
        assert w.add_sample_files(c)
    with open(f"{tcorpus.pack_path(d)}.chunk00001", "r+b") as fp:
        fp.seek(-50, os.SEEK_END)
        fp.write(b"\x7f")
    tlog.set_verbosity(1)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert not w.finalize()
    assert out.getvalue() == ("NN(WARN): corpus cache: chunk "
                              f"{os.path.basename(tcorpus.pack_path(d))}"
                              ".chunk00001 failed its sha256; chunked pack "
                              "abandoned\n")


# --- the native loader ------------------------------------------------------

# (name, content, n_in, n_out): the cases of tests/test_native_io.py
NATIVE_CASES = [
    ("clean", "[input] 4\n1.0 2.5 -3 4e-2\n[output] 2\n1.0 -1.0\n", 4, 2),
    ("multiline", "[input] 4\n1.0 2.5\n-3 4e-2\n[output] 2\n1.0\n-1.0\n",
     4, 2),
    ("bracketless", "[input 4\n1 2 3 4\n[output 2\n1 -1\n", 4, 2),
    ("leading-junk", "# hdr\n\n[input] 2\n5 6\n[output] 1\n1\n", 2, 1),
    ("exponents", "[input] 3\n1e5 -2.5E-3 0.0\n[output] 1\n-1\n", 3, 1),
    ("larger-than-hint", "[input] 8\n1 2 3 4 5 6 7 8\n[output] 2\n1 -1\n",
     4, 2),
    ("smaller-than-hint", "[input] 2\n1 2\n[output] 1\n1\n", 4, 2),
    ("zero-count", "[input] 0\n\n[output] 2\n1 -1\n", 4, 2),
    ("bad-token", "[input] 2\n1 x2\n[output] 2\n1 -1\n", 4, 2),
    ("short-data", "[input] 4\n1 2\n[output] 2\n1 -1\n", 4, 2),
    ("no-output", "[input] 2\n1 2\n", 4, 2),
    ("empty", "", 4, 2),
    ("float-count", "[input] 4.5\n1 2 3 4\n[output] 2\n1 -1\n", 4, 2),
    ("junk-count", "[input] 2abc\n1 2\n[output] 2\n1 -1\n", 4, 2),
    ("hex-token", "[input] 2\n0x1A 2\n[output] 2\n1 -1\n", 4, 2),
    ("nan-paren", "[input] 2\nnan(123) 2\n[output] 2\n1 -1\n", 4, 2),
]


@pytest.mark.parametrize("name,content,n_in,n_out", NATIVE_CASES,
                         ids=[c[0] for c in NATIVE_CASES])
def test_native_matches_python_and_jax(tmp_path, capsys, name, content,
                                       n_in, n_out):
    path = str(tmp_path / "s.txt")
    _write(path, content)
    reads = []
    for fn in (lambda: tsamples.read_sample_fast(path, n_in, n_out),
               lambda: tsamples.read_sample(path),
               lambda: jsamples.read_sample(path)):
        reads.append(_captured(capsys, fn))
    assert tsamples.native_io_status() == "on"
    (fin, fout), ferr = reads[0][0], reads[0][2]
    for (a_in, a_out), _, err in reads[1:]:
        assert err == ferr
        for a, b in ((a_in, fin), (a_out, fout)):
            assert (a is None) == (b is None)
            if a is not None:
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_native_loader_is_the_ports_build(tmp_path):
    """The library comes from csrc/sample_loader.c through ops/build.py,
    into build/hpnn_tpu_torch/, named by its source and flags -- never the
    JAX package's native/libhpnn_io.so; an unopenable file reads (None,
    None)."""
    from hpnn_tpu_torch.ops import build

    lib = tsamples._native()
    path = build.library_path("sample_loader")
    assert lib._name == path and os.path.isfile(path)
    assert os.path.dirname(path) == build.BUILD_DIR
    assert re.fullmatch(r"sample_loader-[0-9a-f]{16}\.so",
                        os.path.basename(path))
    assert "sample_loader" not in build.SOURCES   # build_all: CUDA only
    assert tsamples.read_sample_fast(str(tmp_path / "nope"), 4, 2) \
        == (None, None)


def test_no_native_io_opt_out(tmp_path, monkeypatch):
    _write(tmp_path / "s.txt", "[input] 1\n7\n[output] 1\n1\n")
    monkeypatch.setenv("HPNN_NO_NATIVE_IO", "1")
    assert tsamples.native_io_status() == "off"
    a, b = tsamples.read_sample_fast(str(tmp_path / "s.txt"), 1, 1)
    assert float(a[0]) == 7.0 and float(b[0]) == 1.0


def test_missing_io_lib_raises(tmp_path, monkeypatch):
    """``HPNN_IO_LIB`` naming no library raises, from the status probe and
    from a load's calling thread; nothing is cached, so the next call
    tries again."""
    d = _mixed_corpus(str(tmp_path / "tests"))
    names, order = _listing(d)
    monkeypatch.setenv("HPNN_IO_LIB", str(tmp_path / "missing.so"))
    with pytest.raises(RuntimeError, match="HPNN_IO_LIB=.*missing.so"):
        tsamples.native_io_status()
    with pytest.raises(RuntimeError, match="missing.so"):
        tcorpus.load_ordered(d, names, order, "TESTING", N_IN, N_OUT)
    monkeypatch.delenv("HPNN_IO_LIB")
    assert tsamples.native_io_status() == "on"


def test_failed_loader_build_raises_with_compiler_output(tmp_path,
                                                         monkeypatch):
    from hpnn_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setenv("CC", "sh -c 'echo broken-compiler-output >&2; "
                             "exit 3' --")
    with pytest.raises(RuntimeError, match="(?s)exit 3.*broken-compiler"):
        tsamples.native_io_status()
    assert not os.listdir(tmp_path / "build") or all(
        p.endswith(".log") for p in os.listdir(tmp_path / "build"))


@pytest.mark.parametrize("off", [False, True], ids=["on", "off"])
def test_serve_metrics_report_native_io(monkeypatch, off):
    from hpnn_tpu_torch.serve.metrics import ServeMetrics

    if off:
        monkeypatch.setenv("HPNN_NO_NATIVE_IO", "1")
    m = ServeMetrics()
    want = "off" if off else "on"
    assert m.snapshot()["native_io"] == want
    assert f"\nhpnn_serve_native_io {0 if off else 1}\n" \
        in m.render_prometheus()


# --- the CLI in every mode --------------------------------------------------

def _cycle(monkeypatch, env, port=True):
    """``train_nn -v -v --epochs 3`` then ``run_nn -v -v`` of kernel.opt in
    the cwd under ``env``: ((rc, stdout, stderr, kernel.tmp, kernel.opt),
    (rc, stdout, stderr)), the package's prefetch joined in between."""
    import hpnn_tpu.api as japi
    import hpnn_tpu_torch.api as tapi
    from hpnn_tpu.cli import run_nn_main as jrun
    from hpnn_tpu_torch.cli import run_nn_main as trun
    from test_torch_epochs import EPOCHS, _jax, _port

    jsamples._native_lib = tsamples._native_lib = None
    argv = ["-v", "-v", "--epochs", str(EPOCHS), "nn.conf"]
    train = (_port if port else _jax)(argv, env)
    thread = (tapi if port else japi)._prefetch_thread
    if thread is not None:
        thread.join()
    with monkeypatch.context() as m:
        for k, v in env.items():
            m.setenv(k, v)
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            if port:
                rc = trun(["-v", "-v", "--device", "cpu", "run.conf"])
            else:
                rc = jrun(["-v", "-v", "run.conf"])
    return train, (rc, out.getvalue(), err.getvalue())


def test_cli_bytes_equal_in_every_mode(tmp_path, monkeypatch):
    """The port's ``train_nn -v -v --epochs 3`` + ``run_nn -v -v``: the same
    stdout, stderr, kernel.tmp and kernel.opt with the cache off (serial,
    Python parser), cold (packs built, the test dir's by the prefetch) and
    warm (no file read at all), and the JAX package's streams and
    kernel.tmp, its kernel.opt within test_torch_epochs' bound."""
    from test_torch_epochs import _assert_parity, _setup

    _setup(tmp_path, monkeypatch, "ANN-BP")
    (tmp_path / "run.conf").write_text(
        (tmp_path / "nn.conf").read_text().replace("[init] generate",
                                                   "[init] kernel.opt"))
    tcache = str(tmp_path / "tcache")
    off = _cycle(monkeypatch, {"HPNN_NO_CORPUS_CACHE": "1",
                               "HPNN_NO_NATIVE_IO": "1",
                               "HPNN_IO_THREADS": "1"})
    cold = _cycle(monkeypatch, {"HPNN_CORPUS_CACHE": tcache})
    with tcorpus.cache_settings(tcache):
        packs = [tcorpus.pack_path(s) for s in ("samples", "tests")]
    assert all(os.path.isfile(p) for p in packs)

    def no_reads(*a, **k):
        raise AssertionError("a warm run read a sample file")

    with monkeypatch.context() as m:
        m.setattr(tcorpus, "_read_results", no_reads)
        warm = _cycle(monkeypatch, {"HPNN_CORPUS_CACHE": tcache})
    jax = _cycle(monkeypatch, {"HPNN_CORPUS_CACHE": str(tmp_path / "jcache")},
                 port=False)
    assert off == cold == warm
    _assert_parity(jax[0], off[0], "ANN")
    assert jax[1] == off[1]
    assert off[1][0] == 0 and off[1][1].count("TESTING FILE:") == 11
    assert off[0][2].count("input read failed") == 3


def test_resume_warm_loads(tmp_path, monkeypatch):
    """A run killed at epoch 1 of 3 and ``--resume``d reads its corpus from
    the pack the first run left: the resume's resident-corpus dbg line
    names the pack mode, and kernel.opt equals the uninterrupted run's."""
    from test_torch_epochs import _port, _setup

    _setup(tmp_path, monkeypatch, "ANN-BP")
    monkeypatch.setenv("HPNN_CORPUS_CACHE", str(tmp_path / "tcache"))
    argv = ["-v", "-v", "--epochs", "3", "--ckpt-every", "1", "--ckpt-dir",
            "ck", "nn.conf"]
    whole = _port(argv)
    shutil.rmtree(tmp_path / "ck")
    killed = _port(argv, {"HPNN_CKPT_KILL_AT_EPOCH": "1"})
    assert whole[0] == killed[0] == 0
    resumed = _port(["-v", "-v", "-v", "--epochs", "3", "--resume",
                     "--ckpt-dir", "ck", "nn.conf"])
    assert resumed[0] == 0 and resumed[4] == whole[4]
    assert re.search(r"\nNN\(DBG\): resident corpus: 11 file\(s\), 9 row\(s\) "
                     r"staged once in [0-9.]+s \(pack; native_io: on\)\n",
                     resumed[1])
