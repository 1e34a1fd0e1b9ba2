"""Corpus ingestion: the parallel reader, the packed corpus cache and the
overlapped loads -- the port of the JAX package's ``io.corpus``, with the
same on-disk pack format, so each package warm-loads the other's packs.

The reference prints each ``"<HEADER> FILE: <name>\\t"`` line BEFORE it
reads the file (``src/libhpnn.c:1230-1242``) and skips unreadable samples
without terminating that line, so the next header concatenates onto it.
:func:`load_ordered` returns those headers as events for run_kernel to
print, and emits each file's read diagnostics (stderr) in shuffle order,
exactly where the reference emits them.  Three layers keep that stream
byte-identical while the files stop being parsed serially in Python:

1. **Parallel reader** -- per-file reads fan across :func:`io_pool`
   through the native parser (``samples.read_sample_fast``; it releases
   the interpreter lock, and declined files are re-read by the Python
   parser inside the worker).  Each worker captures its console output
   (``nn_log.capture``) and the assembly replays it in shuffle order, at
   the position the serial read emitted it.

2. **Packed corpus cache** -- the first load of a dir writes one binary
   pack (``HPNNPK01``: a JSON header with the listing, sizes, mtimes and
   per-file status codes, then the x and t rows as float64 in listing
   order, then a ``HPNNSH01`` sha256 trailer) as a dotfile SIBLING of the
   dir (never inside it: the listing feeds the seeded shuffle), or under
   ``--corpus-cache DIR`` / ``HPNN_CORPUS_CACHE``.  A warm load maps the
   pack after one stat pass over the listing; any listing, size, mtime or
   dims change invalidates it and the per-file reads rebuild it.  A flock
   guards the build, so two processes cold-loading one dir read it once.
   ``HPNN_NO_CORPUS_CACHE=1`` bypasses packing.

3. **Overlap** -- :func:`load_ordered_async` runs a load on a background
   thread (its console output replayed by ``result()``) while the caller
   uploads weights and loads the kernel's library;
   :func:`prefetch_pack_async` builds another dir's pack silently
   (``api.train_kernel`` points it at the test dir while the epoch runs,
   so the following ``run_nn`` warm-loads).

:func:`load_resident` reads a corpus once in listing order for the
multi-epoch pipeline (``api._EpochPipeline``), warm from the pack when it
can: every file's diagnostics are classified into status codes that
:class:`ResidentCorpus` replays in each epoch's shuffle order, byte for
byte what :func:`load_ordered` emits.  A file whose diagnostics match no
replayable pattern makes the dir unpackable and non-resident (correctness
first, cache second).

:class:`ChunkedPackWriter` builds the same pack one chunk at a time; no
port path calls it yet (the JAX package's jobs service does).

Env knobs: ``HPNN_IO_THREADS`` (pool width; default min(32, cpus)),
``HPNN_NO_PARALLEL_IO=1`` (serial reads), ``HPNN_NO_CORPUS_CACHE=1``,
``HPNN_CORPUS_CACHE=DIR``, ``HPNN_CORPUS_CACHE_MAX_MB`` (LRU cap on the
cache dir), and samples.py's ``HPNN_NO_NATIVE_IO``/``HPNN_IO_LIB``.  The
checkpoint writer runs on :func:`io_pool` too.
"""

from __future__ import annotations

import contextlib
import glob
import hashlib
import json
import os
import struct
import threading
import time

import numpy as np

from ..utils import nn_log
from ..utils.env import env_int
from ..utils.nn_log import nn_dbg, nn_error, nn_warn
from . import samples
from .samples import read_sample_fast

PACK_MAGIC = b"HPNNPK01"
PACK_VERSION = 1
ALIGN = 64
# content trailer: sha256 over the header blob and the data region,
# appended after the data; a warm load verifies it once a process
TRAILER_MAGIC = b"HPNNSH01"
CHUNK_MAGIC = b"HPNNCK01"

# per-file status codes of a packed or resident corpus, listing order
# (>= 0: the file's row in the packed x/t arrays)
ST_SILENT = -1    # unopenable/empty file: (None, None), no diagnostic
ST_IN_FAIL = -2   # "sample <path> input read failed!" on stderr
ST_OUT_FAIL = -3  # "sample <path> output read failed!" on stderr
ST_DIM = -4       # "sample <name> dimension mismatch, skipped!"
LOADED = "loaded"

# packs this process has content-verified, keyed by (path, trailer) so a
# rebuilt pack is verified again; bounded
_verified_packs: dict[tuple, None] = {}
_VERIFIED_PACKS_MAX = 64
# packs in use by this process's runs: the cache GC never evicts them.
# Insertion-ordered and bounded, so a long-lived process does not exempt
# every pack it ever touched from the LRU cap
_ACTIVE_PACKS_MAX = 16
_active_packs: dict[str, None] = {}

_cache_dir_override: str | None = None
_cache_max_mb_override: int | None = None

# the process's last load_ordered or load_resident, as its dbg line gives
# it: mode ("pack", "parallel" or "serial"), files, rows, seconds and
# native_io (chip_smoke.py and scripts/torch_compare_corpus.py read it)
LAST_LOAD: dict = {}

_pool = None
_pool_lock = threading.Lock()


# --- knobs ------------------------------------------------------------------

def cache_enabled() -> bool:
    return not os.environ.get("HPNN_NO_CORPUS_CACHE")


def set_cache_dir(path: str | None) -> None:
    """Explicit pack location (the CLI's ``--corpus-cache DIR``); wins
    over ``HPNN_CORPUS_CACHE``."""
    global _cache_dir_override
    _cache_dir_override = path


def _cache_dir() -> str | None:
    return _cache_dir_override or os.environ.get("HPNN_CORPUS_CACHE") or None


def set_cache_max_mb(mb: int | None) -> None:
    """LRU size cap of the cache dir (the CLI's ``--corpus-cache-max-mb``);
    wins over ``HPNN_CORPUS_CACHE_MAX_MB``.  0 or None: no cap."""
    global _cache_max_mb_override
    _cache_max_mb_override = None if mb is None else int(mb)


def _cache_max_bytes() -> int:
    if _cache_max_mb_override is not None:
        return _cache_max_mb_override << 20
    return env_int("HPNN_CORPUS_CACHE_MAX_MB", 0, lo=0) << 20


@contextlib.contextmanager
def cache_settings(cache_dir: str | None = None, max_mb: int | None = None):
    """:func:`set_cache_dir` and :func:`set_cache_max_mb` for the span of a
    ``with`` block (None leaves a setting as it is), then the settings
    from before: one CLI command's ``--corpus-cache`` options."""
    saved = _cache_dir_override, _cache_max_mb_override
    if cache_dir:
        set_cache_dir(cache_dir)
    if max_mb is not None:
        set_cache_max_mb(max_mb)
    try:
        yield
    finally:
        set_cache_dir(saved[0])
        set_cache_max_mb(saved[1])


def _note_active(path: str) -> None:
    ap = os.path.abspath(path)
    _active_packs.pop(ap, None)          # re-insertion refreshes the age
    _active_packs[ap] = None
    while len(_active_packs) > _ACTIVE_PACKS_MAX:
        _active_packs.pop(next(iter(_active_packs)))


def gc_cache(protect: tuple[str, ...] = ()) -> list[str]:
    """Evict least-recently-used packs from the cache dir until it fits
    under the cap (no cap: nothing to do).  A pack's age is its mtime,
    which every warm load bumps.  Packs in ``protect`` or in use by this
    process are kept; sibling dotfile packs (no cache dir) are out of
    scope.  Returns the evicted paths."""
    cap = _cache_max_bytes()
    cdir = _cache_dir()
    if not cap or not cdir or not os.path.isdir(cdir):
        return []
    entries = []
    for p in glob.glob(os.path.join(cdir, "corpus-*.pack")):
        try:
            st = os.stat(p)
        except OSError:
            continue
        entries.append((st.st_mtime_ns, st.st_size, os.path.abspath(p)))
    total = sum(e[1] for e in entries)
    keep = set(os.path.abspath(p) for p in protect) | set(_active_packs)
    evicted = []
    for _mtime, size, path in sorted(entries):
        if total <= cap:
            break
        if path in keep:
            continue
        try:
            os.unlink(path)
        except OSError:
            continue
        # the pack's lock file goes with it (at worst a concurrent holder
        # causes one duplicate build)
        with contextlib.suppress(OSError):
            os.unlink(path + ".lock")
        total -= size
        evicted.append(path)
    if evicted:
        nn_dbg(f"corpus cache: evicted {len(evicted)} LRU pack(s) "
               f"over the {cap >> 20} MB cap\n")
    return evicted


@contextlib.contextmanager
def _pack_build_lock(dirpath: str):
    """flock-guarded section for building ``dirpath``'s pack: a second
    process cold-loading the same dir waits here, then re-probes the
    winner's pack instead of reading every file.  Yields True when the
    lock is held; an OS failure yields False (a duplicate build wastes
    time, never correctness: pack writes are atomic replaces).  The lock
    file sits beside the pack; the kernel releases a crashed holder's."""
    path = pack_path(dirpath) + ".lock"
    fd = None
    try:
        import fcntl

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
        fcntl.flock(fd, fcntl.LOCK_EX)
    except Exception:
        if fd is not None:
            with contextlib.suppress(OSError):
                os.close(fd)
        yield False
        return
    try:
        yield True
    finally:
        with contextlib.suppress(OSError):
            fcntl.flock(fd, fcntl.LOCK_UN)
        with contextlib.suppress(OSError):
            os.close(fd)


def io_threads() -> int:
    """The pool's width: ``HPNN_IO_THREADS`` when set (at least 1; a
    malformed value reads 1), 1 under ``HPNN_NO_PARALLEL_IO``, else the
    CPU count capped at 32."""
    if os.environ.get("HPNN_IO_THREADS"):
        return env_int("HPNN_IO_THREADS", 1, lo=1)
    if os.environ.get("HPNN_NO_PARALLEL_IO"):
        return 1
    return max(1, min(32, os.cpu_count() or 1))


def io_pool():
    """The process's one bounded background executor (corpus reads, stat
    passes, checkpoint writes), created at first use with
    :func:`io_threads` workers (the width is fixed then)."""
    global _pool
    with _pool_lock:
        if _pool is None:
            from concurrent.futures import ThreadPoolExecutor

            _pool = ThreadPoolExecutor(max_workers=io_threads(),
                                       thread_name_prefix="hpnn-io")
        return _pool


def pack_path(dirpath: str) -> str:
    """A dir's pack: the dotfile sibling ``.<dir>.hpnn.pack``, or a
    hash-keyed file under the cache dir when one is configured."""
    ap = os.path.abspath(dirpath)
    cdir = _cache_dir()
    if cdir:
        key = hashlib.sha1(ap.encode()).hexdigest()[:20]
        return os.path.join(cdir, f"corpus-{key}.pack")
    return os.path.join(os.path.dirname(ap),
                        f".{os.path.basename(ap)}.hpnn.pack")


# --- fingerprint ------------------------------------------------------------

def _stat_listing(dirpath: str, names: list[str]):
    """(sizes, mtimes_ns) of the listing, or None when an entry fails to
    stat.  This pass is a warm load's cost, so a big listing spreads it
    over the pool in contiguous chunks (os.stat releases the GIL)."""

    def stat_chunk(chunk):
        out = []
        for n in chunk:
            st = os.stat(os.path.join(dirpath, n))
            out.append((st.st_size, st.st_mtime_ns))
        return out

    try:
        k = min(io_threads(), 16)
        if k > 1 and len(names) > 512:
            step = -(-len(names) // k)
            futs = [io_pool().submit(stat_chunk,
                                     names[i * step:(i + 1) * step])
                    for i in range(k)]
            pairs = [p for f in futs for p in f.result()]
        else:
            pairs = stat_chunk(names)
    except OSError:
        return None
    return [p[0] for p in pairs], [p[1] for p in pairs]


# --- pack read --------------------------------------------------------------

def _aligned(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def _read_pack_header(path: str):
    """(header dict, data offset), or None on any structural problem."""
    try:
        with open(path, "rb") as fp:
            if fp.read(8) != PACK_MAGIC:
                return None
            raw = fp.read(8)
            if len(raw) != 8:
                return None
            (hlen,) = struct.unpack("<Q", raw)
            if hlen > 1 << 30:
                return None
            blob = fp.read(hlen)
            if len(blob) != hlen:
                return None
            hdr = json.loads(blob.decode("utf-8"))
    except (OSError, ValueError, UnicodeDecodeError):
        return None
    if not isinstance(hdr, dict) or hdr.get("version") != PACK_VERSION:
        return None
    return hdr, _aligned(16 + hlen)


def _sha256_prefix(fp, n: int):
    """sha256 of the first ``n`` bytes of an open file, or None when it
    is shorter."""
    fp.seek(0)
    h = hashlib.sha256()
    while n > 0:
        chunk = fp.read(min(1 << 20, n))
        if not chunk:
            return None
        h.update(chunk)
        n -= len(chunk)
    return h.digest()


def _pack_content_ok(path: str, data_end: int) -> bool:
    """Check the header and data region against the trailer's sha256,
    once a process for each (path, trailer).  A pack without a trailer
    passes: its stat fingerprint is the only guard it has."""
    try:
        with open(path, "rb") as fp:
            fp.seek(data_end)
            trailer = fp.read(8 + 32)
            if trailer[:8] != TRAILER_MAGIC or len(trailer) != 40:
                return True
            key = (os.path.abspath(path), trailer)
            if key in _verified_packs:
                return True
            if _sha256_prefix(fp, data_end) != trailer[8:]:
                return False
    except OSError:
        return False
    _verified_packs[key] = None
    while len(_verified_packs) > _VERIFIED_PACKS_MAX:
        _verified_packs.pop(next(iter(_verified_packs)))
    return True


def _try_load_pack(dirpath: str, names: list[str], n_in: int, n_out: int,
                   probe_only: bool = False):
    """Validate the pack against the dir as it is now: (status, X, T),
    X and T read-only memmaps, on a hit (True when ``probe_only``); None
    on any miss (missing, stale or corrupt: the caller reads the files)."""
    path = pack_path(dirpath)
    got = _read_pack_header(path)
    if got is None:
        return None
    hdr, data_off = got
    if hdr.get("n_in") != n_in or hdr.get("n_out") != n_out:
        return None
    if hdr.get("names") != names:
        return None  # files added, removed or reordered
    stats = _stat_listing(dirpath, names)
    if stats is None:
        return None
    sizes, mtimes = stats
    if hdr.get("sizes") != sizes or hdr.get("mtimes") != mtimes:
        return None  # files touched or resized
    status = hdr.get("status")
    n_rows = hdr.get("n_rows")
    if (not isinstance(status, list) or len(status) != len(names)
            or not isinstance(n_rows, int)):
        return None
    need = data_off + n_rows * (n_in + n_out) * 8
    try:
        if os.path.getsize(path) < need:
            return None  # a torn write
    except OSError:
        return None
    if probe_only:
        return True
    if not _pack_content_ok(path, need):
        nn_warn(f"corpus cache: {path} failed its content sha256; "
                "rebuilding the pack from source files\n")
        with contextlib.suppress(OSError):
            os.unlink(path)
        return None
    # the LRU age of a served pack (the header fingerprints its content,
    # so the bump cannot serve stale rows), and this run's protection
    with contextlib.suppress(OSError):
        os.utime(path)
    _note_active(path)
    if n_rows == 0:
        return status, None, None
    X = np.memmap(path, dtype=np.float64, mode="r", offset=data_off,
                  shape=(n_rows, n_in))
    T = np.memmap(path, dtype=np.float64, mode="r",
                  offset=data_off + n_rows * n_in * 8,
                  shape=(n_rows, n_out))
    return status, X, T


def _order_events(dirpath, names, order, header, status, lines=None):
    """Shuffle-order replay of per-file status codes: the header events
    and skip diagnostics, byte-identical to what the per-file read emits.
    Returns (events, sel), sel the packed row of each loaded file in
    shuffle order; ``lines`` optionally holds the header lines formatted
    once (listing order)."""
    rows, events = [], []
    for idx in order:
        name = names[idx]
        line = (lines[idx] if lines is not None
                else f"{header} FILE: {name[:16]:>16}\t")
        st = status[idx]
        if st >= 0:
            events.append((line, len(rows)))
            rows.append(st)
            continue
        if st == ST_IN_FAIL:
            nn_error(f"sample {os.path.join(dirpath, name)} "
                     "input read failed!\n")
        elif st == ST_OUT_FAIL:
            nn_error(f"sample {os.path.join(dirpath, name)} "
                     "output read failed!\n")
        elif st == ST_DIM:
            nn_error(f"sample {name} dimension mismatch, skipped!\n")
        events.append((line, None))
    return events, np.asarray(rows, dtype=np.int32)


def _assemble_pack(dirpath, names, order, header, status, X, T):
    """A pack in shuffle order: the events, rows and diagnostics the
    per-file route gives; the fancy index copies the selected rows out of
    the mapping into fresh (writable) arrays."""
    events, sel = _order_events(dirpath, names, order, header, status)
    if sel.size == 0:
        return events, None, None
    return events, np.asarray(X[sel]), np.asarray(T[sel])


# --- per-file reads ---------------------------------------------------------

def _quiet_read(path: str, n_in: int, n_out: int):
    """One file read with its console output captured for ordered replay;
    runs on pool workers and inline alike."""
    with nn_log.capture() as diags:
        vec_in, vec_out = read_sample_fast(path, n_in, n_out)
    return vec_in, vec_out, diags


def _read_results(dirpath: str, names: list[str], n_in: int, n_out: int):
    """Every file read, each with its captured output; returns (results
    in listing order, "serial" or "parallel")."""
    # the native library is built or loaded here, once, on the calling
    # thread: a failed build raises to the caller, not inside a worker
    samples._native()
    paths = [os.path.join(dirpath, n) for n in names]
    if io_threads() <= 1 or len(paths) <= 2:
        return [_quiet_read(p, n_in, n_out) for p in paths], "serial"
    pool = io_pool()
    futs = [pool.submit(_quiet_read, p, n_in, n_out) for p in paths]
    return [f.result() for f in futs], "parallel"


def _assemble_results(dirpath, names, order, header, n_in, n_out, results):
    """The reference's skip semantics (``libhpnn.c:1230-1242``) over fresh
    read results: each file's captured diagnostics replay at the position
    the serial read emitted them."""
    xs, ts, events = [], [], []
    for idx in order:
        name = names[idx]
        # NN_OUT(stdout,"%s FILE: %16.16s\t") -- printed before the read
        line = f"{header} FILE: {name[:16]:>16}\t"
        vec_in, vec_out, diags = results[idx]
        nn_log.replay(diags)
        if vec_in is None or vec_out is None:
            events.append((line, None))
            continue
        if vec_in.shape[0] < n_in or vec_out.shape[0] < n_out:
            # a section count SMALLER than the kernel dimension makes the
            # reference copy past its allocation (libhpnn.c:1243, undefined
            # behavior); we skip with a diagnostic -- documented deviation
            nn_error(f"sample {name} dimension mismatch, skipped!\n")
            events.append((line, None))
            continue
        # a LARGER count is deterministic in the reference: it copies the
        # first kernel-dimension values and ignores the rest -- truncate
        events.append((line, len(xs)))
        xs.append(vec_in[:n_in])
        ts.append(vec_out[:n_out])
    if not xs:
        return events, None, None
    return events, np.stack(xs), np.stack(ts)


def _classify(dirpath, name, vec_in, vec_out, diags, n_in, n_out):
    """Status code for one read result, or None when its diagnostics do
    not match a replayable pattern."""
    if vec_in is None or vec_out is None:
        if not diags:
            return ST_SILENT
        if len(diags) == 1 and diags[0][0] == "error":
            path = os.path.join(dirpath, name)
            if diags[0][1] == f"sample {path} input read failed!\n":
                return ST_IN_FAIL
            if diags[0][1] == f"sample {path} output read failed!\n":
                return ST_OUT_FAIL
        return None
    if diags:
        return None
    if vec_in.shape[0] < n_in or vec_out.shape[0] < n_out:
        return ST_DIM
    return LOADED


def _classify_results(dirpath, names, n_in, n_out, results):
    """(status, X, T) in listing order from the read results, or None when
    any file's diagnostics are non-replayable."""
    status, rows_x, rows_t = [], [], []
    for idx, name in enumerate(names):
        vec_in, vec_out, diags = results[idx]
        st = _classify(dirpath, name, vec_in, vec_out, diags, n_in, n_out)
        if st is None:
            return None
        if st is LOADED:
            status.append(len(rows_x))
            rows_x.append(np.ascontiguousarray(vec_in[:n_in], np.float64))
            rows_t.append(np.ascontiguousarray(vec_out[:n_out], np.float64))
        else:
            status.append(st)
    if not rows_x:
        return status, None, None
    return status, np.stack(rows_x), np.stack(rows_t)


# --- pack write -------------------------------------------------------------

def _header_blob(hdr: dict) -> bytes:
    return json.dumps(hdr, separators=(",", ":")).encode("utf-8")


def _pack_head(magic: bytes, blob: bytes) -> bytes:
    """Magic, header length, header, zeros up to the aligned data."""
    return (magic + struct.pack("<Q", len(blob)) + blob
            + b"\0" * (_aligned(16 + len(blob)) - 16 - len(blob)))


def _append_trailer(tmp: str) -> None:
    """Stream the written file once and append its sha256 trailer."""
    digest = hashlib.sha256()
    with open(tmp, "rb") as fp:
        for chunk in iter(lambda: fp.read(1 << 20), b""):
            digest.update(chunk)
    with open(tmp, "ab") as fp:
        fp.write(TRAILER_MAGIC)
        fp.write(digest.digest())


def _save_pack(dirpath, names, n_in, n_out, results, stats) -> bool:
    """Write the pack from fresh read results (rows in LISTING order, so
    the pack does not depend on the shuffle seed; atomic replace).  Any
    anomaly leaves no pack and is not an error.

    ``stats`` is the fingerprint taken BEFORE the reads: a file modified
    mid-load then carries its old stat, and the next load rebuilds."""
    if stats is None:
        return False
    status, rows_x, rows_t = [], [], []
    for idx, name in enumerate(names):
        vec_in, vec_out, diags = results[idx]
        st = _classify(dirpath, name, vec_in, vec_out, diags, n_in, n_out)
        if st is None:
            nn_dbg(f"corpus cache: {name} has non-replayable "
                   "diagnostics; dir not packed\n")
            return False
        if st is LOADED:
            status.append(len(rows_x))
            rows_x.append(np.ascontiguousarray(vec_in[:n_in], np.float64))
            rows_t.append(np.ascontiguousarray(vec_out[:n_out], np.float64))
        else:
            status.append(st)
    sizes, mtimes = stats
    hdr = {"version": PACK_VERSION, "n_in": n_in, "n_out": n_out,
           "n_rows": len(rows_x), "names": names,
           "sizes": sizes, "mtimes": mtimes, "status": status}
    path = pack_path(dirpath)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # tmp litter of writers killed mid-write (never served: the
        # replace is atomic); ours is created just below
        for stale in glob.glob(f"{path}.tmp.*"):
            with contextlib.suppress(OSError):
                os.unlink(stale)
        with open(tmp, "wb") as fp:
            fp.write(_pack_head(PACK_MAGIC, _header_blob(hdr)))
            if rows_x:
                np.stack(rows_x).tofile(fp)
                np.stack(rows_t).tofile(fp)
        _append_trailer(tmp)
        os.replace(tmp, path)
    except OSError as exc:
        nn_dbg(f"corpus cache: pack write failed ({exc})\n")
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        return False
    _note_active(path)
    gc_cache(protect=(path,))
    return True


# --- chunked pack build -----------------------------------------------------

def _read_chunk(path: str):
    """(header dict, data offset) of one chunk file, verified against its
    own sha256 trailer; None on any structural or integrity problem."""
    try:
        with open(path, "rb") as fp:
            if fp.read(8) != CHUNK_MAGIC:
                return None
            raw = fp.read(8)
            if len(raw) != 8:
                return None
            (hlen,) = struct.unpack("<Q", raw)
            if hlen > 1 << 30:
                return None
            blob = fp.read(hlen)
            if len(blob) != hlen:
                return None
            hdr = json.loads(blob.decode("utf-8"))
            if not isinstance(hdr, dict) \
                    or hdr.get("version") != PACK_VERSION:
                return None
            data_off = _aligned(16 + hlen)
            n_rows = hdr.get("n_rows")
            n_in, n_out = hdr.get("n_in"), hdr.get("n_out")
            if not all(isinstance(v, int) for v in (n_rows, n_in, n_out)):
                return None
            data_end = data_off + n_rows * (n_in + n_out) * 8
            fp.seek(data_end)
            trailer = fp.read(8 + 32)
            if trailer[:8] != TRAILER_MAGIC or len(trailer) != 40:
                return None
            if _sha256_prefix(fp, data_end) != trailer[8:]:
                return None
    except (OSError, ValueError, UnicodeDecodeError):
        return None
    return hdr, data_off


class ChunkedPackWriter:
    """A pack built one chunk at a time, while later chunks of the corpus
    are still arriving.

    Each :meth:`add_chunk` writes a self-contained chunk file beside the
    pack path with its own header and sha256 trailer, so a torn chunk is
    caught at :meth:`finalize` before any row reaches the pack.
    ``finalize`` streams the verified chunks into the ``HPNNPK01`` layout
    (all x rows, then all t rows, in the dir's listing order; the trailer;
    an atomic replace): the same bytes as :func:`_save_pack` of the whole
    dir, so a warm load cannot tell them apart."""

    def __init__(self, dirpath: str, n_in: int, n_out: int):
        self.dirpath = dirpath
        self.n_in = int(n_in)
        self.n_out = int(n_out)
        self._pack = pack_path(dirpath)
        self._chunks: list[str] = []
        self._names: list[str] = []
        self._n_rows = 0
        self._broken = False

    @property
    def n_rows(self) -> int:
        return self._n_rows

    @property
    def n_chunks(self) -> int:
        return len(self._chunks)

    def add_chunk(self, names, status, X, T) -> bool:
        """Append one chunk: ``status`` maps each of ``names`` to a row
        LOCAL to this chunk (>= 0) or a skip class (< 0); ``X``/``T`` hold
        the chunk's rows.  False (and the writer is spent) on a write
        failure: the corpus still loads from its files, without a pack."""
        if self._broken:
            return False
        n_rows = 0 if X is None else int(X.shape[0])
        hdr = {"version": PACK_VERSION, "seq": len(self._chunks),
               "n_in": self.n_in, "n_out": self.n_out,
               "n_rows": n_rows, "names": list(names),
               "status": [int(s) for s in status]}
        path = f"{self._pack}.chunk{len(self._chunks):05d}"
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            digest = hashlib.sha256()
            with open(path, "wb") as fp:
                head = _pack_head(CHUNK_MAGIC, _header_blob(hdr))
                fp.write(head)
                digest.update(head)
                if n_rows:
                    for rows, width in ((X, self.n_in), (T, self.n_out)):
                        b = np.ascontiguousarray(rows[:, :width],
                                                 np.float64).tobytes()
                        fp.write(b)
                        digest.update(b)
                fp.write(TRAILER_MAGIC)
                fp.write(digest.digest())
        except OSError as exc:
            nn_dbg(f"corpus cache: chunk write failed ({exc})\n")
            self._broken = True
            return False
        self._chunks.append(path)
        self._names.extend(names)
        self._n_rows += n_rows
        return True

    def add_sample_files(self, names) -> bool:
        """Read ``names`` (in the writer's dir) with the corpus readers,
        classify their diagnostics and append them as one chunk.  False
        when a file's diagnostics are non-replayable or the write fails."""
        if self._broken:
            return False
        results, _mode = _read_results(self.dirpath, list(names),
                                       self.n_in, self.n_out)
        classified = _classify_results(self.dirpath, list(names),
                                       self.n_in, self.n_out, results)
        if classified is None:
            self._broken = True
            return False
        status, X, T = classified
        return self.add_chunk(names, status, X, T)

    def finalize(self) -> bool:
        """Verify every chunk and assemble the pack; the chunk files are
        removed either way.

        The pack stores rows in the dir's readdir order, which is not
        known while chunks arrive: the dir is listed now and each listed
        name's row is copied from its chunk in listing order (row-sized
        reads, never the whole corpus in memory).  A listing that differs
        from the chunks' names refuses the pack.  The fingerprint is taken
        now, as :func:`_save_pack` takes it."""
        if self._broken or not self._chunks:
            self.abort()
            return False
        listing = samples.list_sample_dir(self.dirpath)
        if listing is None or sorted(listing) != sorted(self._names):
            nn_dbg("corpus cache: dir listing does not match the "
                   "uploaded chunks; chunked pack skipped\n")
            self.abort()
            return False
        stats = _stat_listing(self.dirpath, listing)
        if stats is None:
            self.abort()
            return False
        heads = []
        for path in self._chunks:
            got = _read_chunk(path)
            if got is None:
                nn_warn(f"corpus cache: chunk {os.path.basename(path)} "
                        "failed its sha256; chunked pack abandoned\n")
                self.abort()
                return False
            heads.append(got)
        # name -> (skip class or local row, chunk index, data offset)
        where: dict = {}
        for ci, (chdr, data_off) in enumerate(heads):
            for name, st in zip(chdr["names"], chdr["status"]):
                where[name] = (int(st), ci, data_off)
        status, plan = [], []
        for name in listing:
            st, ci, data_off = where[name]
            if st >= 0:
                status.append(len(plan))
                plan.append((ci, data_off, st))
            else:
                status.append(st)
        sizes, mtimes = stats
        hdr = {"version": PACK_VERSION, "n_in": self.n_in,
               "n_out": self.n_out, "n_rows": len(plan),
               "names": listing, "sizes": sizes, "mtimes": mtimes,
               "status": status}
        tmp = f"{self._pack}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as out:
                out.write(_pack_head(PACK_MAGIC, _header_blob(hdr)))
                for region in ("x", "t"):
                    self._copy_rows(out, region, plan, heads)
            _append_trailer(tmp)
            os.replace(tmp, self._pack)
        except OSError as exc:
            nn_dbg(f"corpus cache: chunked pack assembly failed "
                   f"({exc})\n")
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            self.abort()
            return False
        self.abort()  # the chunk files are spent
        _note_active(self._pack)
        gc_cache(protect=(self._pack,))
        return True

    def _copy_rows(self, out, region: str, plan, heads) -> None:
        """One region (x or t) of the pack, row by row from the chunks."""
        row_b = 8 * (self.n_in if region == "x" else self.n_out)
        fps = {}
        try:
            for ci, data_off, local_row in plan:
                fp = fps.get(ci)
                if fp is None:
                    fp = fps[ci] = open(self._chunks[ci], "rb")
                skip = (heads[ci][0]["n_rows"] * self.n_in * 8
                        if region == "t" else 0)
                fp.seek(data_off + skip + local_row * row_b)
                piece = fp.read(row_b)
                if len(piece) != row_b:
                    raise OSError(f"chunk {self._chunks[ci]} truncated")
                out.write(piece)
        finally:
            for fp in fps.values():
                with contextlib.suppress(OSError):
                    fp.close()

    def abort(self) -> None:
        """Remove the chunk files (idempotent)."""
        for path in self._chunks:
            with contextlib.suppress(OSError):
                os.unlink(path)
        self._chunks = []


# --- the loader entry points ------------------------------------------------

def load_ordered(dirpath: str, names: list[str], order: list[int],
                 header: str, n_in: int, n_out: int):
    """Read samples in shuffled order: the pack when it is warm, else the
    files (building the pack), with byte-identical console output.

    Returns (events, X, T): events is a list of (header_line, row) pairs
    in shuffle order; row is None for skipped files (their header is
    still printed, unterminated, exactly like the reference which emits
    the "FILE: name\\t" header before attempting the read).  X (rows,
    n_in) and T (rows, n_out) are float64, or None when no file loaded.
    """
    t0 = time.perf_counter()
    packing = cache_enabled() and n_in > 0 and n_out > 0
    mode, out = None, None
    if packing:
        got = _try_load_pack(dirpath, names, n_in, n_out)
        if got is not None:
            out, mode = _assemble_pack(dirpath, names, order, header,
                                       *got), "pack"
    if mode is None:
        with (_pack_build_lock(dirpath) if packing
              else contextlib.nullcontext(False)) as locked:
            if locked:
                # another loader may have held the lock first: its
                # pack (checked against the dir as it is now) saves the
                # reads
                got = _try_load_pack(dirpath, names, n_in, n_out)
                if got is not None:
                    out, mode = _assemble_pack(dirpath, names, order,
                                               header, *got), "pack"
            if mode is None:
                # the fingerprint is taken BEFORE the reads (_save_pack)
                stats = _stat_listing(dirpath, names) if packing else None
                results, mode = _read_results(dirpath, names, n_in, n_out)
                out = _assemble_results(dirpath, names, order, header,
                                        n_in, n_out, results)
                if packing:
                    _save_pack(dirpath, names, n_in, n_out, results, stats)
    events, X, T = out
    stats = _note_load(mode, names, X, t0)
    # dbg only: the -v -v stream is the same in every mode, so the mode
    # cannot print there
    nn_dbg(f"load: {stats['files']} file(s), {stats['rows']} row(s) in "
           f"{stats['seconds']:.3f}s ({mode}; "
           f"native_io: {stats['native_io']})\n")
    return events, X, T


def _note_load(mode: str, names: list[str], X, t0: float) -> dict:
    LAST_LOAD.clear()
    LAST_LOAD.update(mode=mode, files=len(names),
                     rows=0 if X is None else int(X.shape[0]),
                     seconds=time.perf_counter() - t0,
                     native_io=samples.native_io_status())
    return LAST_LOAD


class ResidentCorpus:
    """One listing-order copy of a corpus, read once a run for the
    device-resident epoch pipeline (``api._EpochPipeline``).

    ``X``/``T`` hold the loaded rows in listing order (the pack's own
    layout; read-only memmaps after a warm load) and ``status`` maps each
    listing index to its row (>= 0) or skip class (< 0).  Every epoch's
    console bytes and device gather indices come from these through
    :meth:`epoch_events`, so after the first read no epoch touches the
    corpus files again."""

    def __init__(self, dirpath: str, names: list[str], status: list[int],
                 X, T, header: str = "TRAINING"):
        self.dirpath = dirpath
        self.names = names
        self.status = status
        self.X = X            # (n_rows, n_in) float64, listing order, or None
        self.T = T
        self.header = header
        self.n_rows = 0 if X is None else int(X.shape[0])
        # header lines are the same every epoch: formatted once
        self._lines = [f"{header} FILE: {n[:16]:>16}\t" for n in names]

    def release_rows(self) -> None:
        """Drop the host rows once the device holds the corpus (epoch
        replay needs only names, status and headers)."""
        self.X = None
        self.T = None

    def epoch_events(self, order: list[int]):
        """(events, sel) for one epoch's shuffle order; emits the skip
        diagnostics (stderr) exactly like the per-file load would."""
        return _order_events(self.dirpath, self.names, order, self.header,
                             self.status, lines=self._lines)

    def padded_row_block(self, which: str, lo: int, hi: int,
                         total_rows: int) -> np.ndarray:
        """Rows ``[lo, hi)`` of X (``which="x"``) or T as a contiguous
        float64 block, zero rows standing in past ``n_rows`` (a pad up to
        ``total_rows``).  With pack-backed memmap rows only the requested
        range's pages are read, so a rank uploading its corpus in blocks
        never holds a float64 copy of the whole of it."""
        src = self.X if which == "x" else self.T
        if not 0 <= lo <= hi <= total_rows:
            raise ValueError(f"row block [{lo}, {hi}) outside "
                             f"[0, {total_rows})")
        width = int(src.shape[1]) if src is not None else 0
        real_hi = min(hi, self.n_rows)
        if lo >= real_hi:  # a block of padding only
            return np.zeros((hi - lo, width), np.float64)
        block = np.ascontiguousarray(src[lo:real_hi], np.float64)
        if hi > real_hi:
            block = np.concatenate(
                [block, np.zeros((hi - real_hi, width), np.float64)])
        return block


def load_resident(dirpath: str, names: list[str], n_in: int, n_out: int,
                  header: str = "TRAINING", prefer_mmap: bool = False):
    """Read a corpus once in listing order for device residency: the pack
    when it is warm, else every file under the build lock, classified into
    replayable status codes, and the pack written for the next run.
    Returns a :class:`ResidentCorpus`, or None when a file's diagnostics
    are non-replayable (the caller keeps the per-epoch
    :func:`load_ordered` route, which emits them as they come).  Prints
    nothing of its own beyond a dbg summary: the per-epoch skip
    diagnostics come from :meth:`ResidentCorpus.epoch_events`.

    ``prefer_mmap=True`` (the multi-process pipeline) swaps a cold load's
    in-memory rows for the freshly written pack's memmaps, so a rank that
    built the pack still uploads from pack pages."""
    if n_in <= 0 or n_out <= 0:
        return None
    t0 = time.perf_counter()
    got, mode = None, "pack"
    if cache_enabled():
        got = _try_load_pack(dirpath, names, n_in, n_out)
    if got is None:
        with _pack_build_lock(dirpath) as locked:
            if locked and cache_enabled():
                got = _try_load_pack(dirpath, names, n_in, n_out)
            if got is None:
                stats = _stat_listing(dirpath, names)
                results, mode = _read_results(dirpath, names, n_in, n_out)
                got = _classify_results(dirpath, names, n_in, n_out, results)
                if got is None:
                    nn_dbg("resident corpus: non-replayable diagnostics; "
                           "per-epoch loads\n")
                    return None
                if (cache_enabled()
                        and _save_pack(dirpath, names, n_in, n_out, results,
                                       stats) and prefer_mmap):
                    got = _try_load_pack(dirpath, names, n_in, n_out) or got
    rc = ResidentCorpus(dirpath, names, *got, header=header)
    stats = _note_load(mode, names, rc.X, t0)
    nn_dbg(f"resident corpus: {len(names)} file(s), {rc.n_rows} row(s) "
           f"staged once in {stats['seconds']:.3f}s ({mode}; "
           f"native_io: {stats['native_io']})\n")
    return rc


class LoadHandle:
    """A corpus load running on a background thread.  Its console output
    is captured there and replayed by :meth:`result` on the caller's
    thread, so the stream is byte-identical to a foreground load and never
    interleaves with the caller's own output."""

    def __init__(self, fn):
        self._box: dict = {}
        self._out: list = []

        def run():
            try:
                with nn_log.capture(into=self._out):
                    self._box["r"] = fn()
            except BaseException as exc:  # re-raised by result()
                self._box["e"] = exc

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="hpnn-corpus-load")
        self._thread.start()

    def result(self):
        self._thread.join()
        nn_log.replay(self._out)
        if "e" in self._box:
            raise self._box["e"]
        return self._box["r"]


def load_ordered_async(dirpath: str, names: list[str], order: list[int],
                       header: str, n_in: int, n_out: int) -> LoadHandle:
    """:func:`load_ordered` on a background thread: the caller warms the
    device route meanwhile and joins with ``handle.result()``."""
    return LoadHandle(lambda: load_ordered(dirpath, names, order, header,
                                           n_in, n_out))


def prefetch_pack_async(dirpath: str, n_in: int,
                        n_out: int) -> threading.Thread | None:
    """Build ``dirpath``'s pack in the background when it is missing or
    stale: silent (all console output discarded), best-effort, a daemon
    thread.  Returns the thread (tests join it), or None when the cache
    is off."""
    if not cache_enabled() or n_in <= 0 or n_out <= 0:
        return None

    def run():
        try:
            names = samples.list_sample_dir(dirpath)
            if not names:
                return
            if _try_load_pack(dirpath, names, n_in, n_out, probe_only=True):
                return  # already warm
            with nn_log.capture():  # a prefetch never prints
                with _pack_build_lock(dirpath):
                    # a foreground load (or another process) may have
                    # built it while this thread waited for the lock
                    if _try_load_pack(dirpath, names, n_in, n_out,
                                      probe_only=True):
                        return
                    stats = _stat_listing(dirpath, names)
                    results, _ = _read_results(dirpath, names, n_in, n_out)
                    _save_pack(dirpath, names, n_in, n_out, results, stats)
        except Exception:
            pass  # an optimisation: never fatal

    t = threading.Thread(target=run, daemon=True,
                         name="hpnn-corpus-prefetch")
    t.start()
    return t
