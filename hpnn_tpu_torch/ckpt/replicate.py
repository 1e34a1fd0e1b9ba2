"""Checkpoint bundle replication to a directory: the port's copy of the
JAX package's ``ckpt/replicate.py``, with the same container and spool
format, so each package reads the other's replicas.

Snapshots that exist only on the training host die with its disk.  This
module ships every VERIFIED bundle somewhere else, content-addressed, and
can restore the newest intact one:

* **container** -- :func:`pack_bundle` serializes one bundle
  (``kernel.opt`` + ``state.npz`` + ``snapshot.json``) into a single
  deterministic blob: magic, JSON header with per-file sizes and sha256s
  plus the bundle's kernel fingerprint, then the raw file bytes.  The
  blob's own sha256 is its address; :func:`unpack_bundle` re-verifies
  every file hash before a byte lands on disk.
* **destination** -- ``--replicate-to DIR`` writes
  ``<DIR>/<scope>/<sha256>.bundle`` (atomic, via ``io.atomic``) plus an
  ``index.json``.  The JAX package's other destination,
  ``http://HOST:PORT`` (a serve-mesh router), waits for the port's serve
  mesh: it is refused here.
* **scope** -- one checkpoint stream's identity (:func:`scope_for`: the
  ckpt dir's basename + a stable hash of its absolute path), so one
  destination serves many runs without collisions.
* **restore** -- :func:`restore_bundle` walks the destination's index
  newest-first, verifies each blob's sha256 AND the unpacked bundle's
  recorded fingerprints (``snapshot.verify_bundle``), and materializes
  the newest intact bundle into a local checkpoint dir.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import time

from ..utils.nn_log import nn_dbg, nn_warn
from . import snapshot as snap

_MAGIC = b"HPNNBNDL"
_VERSION = 1
# the bundle files a replica carries, in container order
_FILES = (snap.SNAPSHOT_KERNEL, snap.SNAPSHOT_STATE, snap.SNAPSHOT_META)
_INDEX = "index.json"


class ReplicateError(Exception):
    """A bundle could not be shipped to, or restored from, a replica
    destination."""


def scope_for(ckpt_dir: str) -> str:
    """A checkpoint stream's default replica identity: readable
    basename + a hash of the absolute path (two jobs named ``ckpt`` on
    one host must not collide at the destination).  Path-derived, so
    recovery from a DIFFERENT host needs the checkpoint dir to resolve
    to the same absolute path -- cross-path recovery sets an explicit
    ``HPNN_REPLICATE_SCOPE`` on both ends (:func:`resolve_scope`)."""
    path = os.path.abspath(ckpt_dir)
    digest = hashlib.sha256(path.encode("utf-8")).hexdigest()[:12]
    base = os.path.basename(path.rstrip(os.sep)) or "ckpt"
    safe = "".join(c if c.isalnum() or c in "._-" else "_"
                   for c in base)[:40]
    return f"{safe}-{digest}"


def resolve_scope(ckpt_dir: str) -> str:
    """The replica scope every ship AND restore site uses:
    ``HPNN_REPLICATE_SCOPE`` (the cross-host recovery knob -- set it
    identically on the shipping and recovering side), else the
    path-derived default."""
    return os.environ.get("HPNN_REPLICATE_SCOPE") or scope_for(ckpt_dir)


# --- container --------------------------------------------------------------

def pack_bundle(bundle_dir: str) -> tuple[bytes, dict]:
    """Serialize one on-disk bundle into a single content-addressed
    blob; returns ``(blob, meta)`` where meta carries the blob sha256,
    tag/epoch and the kernel fingerprint cross-checkable against the
    checkpoint manifest.  Raises :class:`ReplicateError` on an
    incomplete bundle."""
    files = []
    payloads = []
    for name in _FILES:
        try:
            with open(os.path.join(bundle_dir, name), "rb") as fp:
                data = fp.read()
        except OSError as exc:
            raise ReplicateError(
                f"bundle {bundle_dir} incomplete: {name}: {exc}")
        files.append({"name": name, "size": len(data),
                      "sha256": hashlib.sha256(data).hexdigest()})
        payloads.append(data)
    meta = {}
    try:
        meta = json.loads(payloads[_FILES.index(snap.SNAPSHOT_META)]
                          .decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        pass
    header = {"version": _VERSION, "tag": os.path.basename(bundle_dir),
              "epoch": int(meta.get("epoch", 0) or 0),
              "kernel_fingerprint": meta.get("fingerprint"),
              "files": files}
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    out = _MAGIC + struct.pack("<Q", len(blob)) + blob + b"".join(payloads)
    return out, {"sha256": hashlib.sha256(out).hexdigest(),
                 "size": len(out), "tag": header["tag"],
                 "epoch": header["epoch"],
                 "kernel_fingerprint": header["kernel_fingerprint"]}


def read_bundle_header(data: bytes) -> tuple[dict, int]:
    """(header, payload offset) of a packed bundle blob; raises
    :class:`ReplicateError` on any structural problem."""
    if len(data) < 16 or data[:8] != _MAGIC:
        raise ReplicateError("not a packed bundle (bad magic)")
    (hlen,) = struct.unpack("<Q", data[8:16])
    if hlen > 1 << 30 or len(data) < 16 + hlen:
        raise ReplicateError("truncated bundle header")
    try:
        header = json.loads(data[16:16 + hlen].decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as exc:
        raise ReplicateError(f"bad bundle header: {exc}")
    if not isinstance(header, dict) or header.get("version") != _VERSION:
        raise ReplicateError("unsupported bundle version")
    return header, 16 + hlen


def unpack_bundle(data: bytes, dest_dir: str) -> str:
    """Materialize a packed bundle under ``dest_dir/<tag>``, verifying
    every file's recorded sha256 BEFORE anything is renamed into place
    (staged-dir + rename, same crash discipline as the snapshot
    writer).  Returns the bundle path."""
    import shutil

    header, off = read_bundle_header(data)
    tag = str(header.get("tag") or "")
    if not tag.startswith("ep"):
        raise ReplicateError(f"bad bundle tag {tag!r}")
    final = os.path.join(dest_dir, tag)
    tmp = os.path.join(dest_dir, f".tmp.restore.{tag}.{os.getpid()}")
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        for entry in header.get("files", []):
            name = os.path.basename(str(entry.get("name", "")))
            size = int(entry.get("size", -1))
            if name not in _FILES or size < 0 \
                    or off + size > len(data):
                raise ReplicateError(f"bad file entry {entry!r}")
            chunk = data[off:off + size]
            off += size
            if hashlib.sha256(chunk).hexdigest() != entry.get("sha256"):
                raise ReplicateError(f"{name}: sha256 mismatch in "
                                     "packed bundle")
            with open(os.path.join(tmp, name), "wb") as fp:
                fp.write(chunk)
                fp.flush()
                os.fsync(fp.fileno())
        snap.fsync_dir(tmp)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    snap.fsync_dir(dest_dir)
    return final


# --- destinations -----------------------------------------------------------

def _is_http(dest: str) -> bool:
    return dest.startswith(("http://", "https://"))


def http_refusal(dest: str) -> str:
    """The message for a mesh-router destination, which the port does not
    have yet."""
    from ..api import LATER

    return f"--replicate-to {dest}: replication to a mesh router {LATER}"


class Replicator:
    """Ships verified bundles to one directory (see module doc).

    ``replicate`` is synchronous -- the CheckpointManager submits it to
    the io_pool so the training loop never waits on it; a failing
    destination costs a warning per bundle, never the run.  A mesh-router
    destination is refused when the Replicator is made."""

    def __init__(self, dest: str, ckpt_dir: str):
        if _is_http(dest):
            raise ReplicateError(http_refusal(dest))
        self.dest = dest
        self.scope = resolve_scope(ckpt_dir)

    # --- ship ------------------------------------------------------------
    def replicate(self, bundle_dir: str) -> dict | None:
        """Pack + ship one bundle; returns its replica meta (sha256,
        size, tag, lag_s) or None on failure (warned -- replication is
        belt-and-braces, the local bundle already verified)."""
        t0 = time.monotonic()
        try:
            blob, meta = pack_bundle(bundle_dir)
            self._ship_dir(blob, meta)
        except (ReplicateError, OSError) as exc:
            nn_warn(f"CKPT: replication of {bundle_dir} to {self.dest} "
                    f"failed: {type(exc).__name__}: {exc}\n")
            return None
        meta["lag_s"] = round(time.monotonic() - t0, 4)
        nn_dbg(f"CKPT: replicated {meta['tag']} "
               f"({meta['size']} B, sha {meta['sha256'][:12]}...) to "
               f"{self.dest} in {meta['lag_s']}s\n")
        return meta

    def _ship_dir(self, blob: bytes, meta: dict) -> None:
        from ..utils.env import env_int

        root = os.path.join(os.path.abspath(self.dest), self.scope)
        write_scope_blob(root, blob, meta["sha256"])
        update_scope_index(
            root,
            {k: meta[k] for k in ("sha256", "size", "tag", "epoch",
                                  "kernel_fingerprint")},
            # retention: a multi-hundred-epoch run must not grow the
            # replica without bound (the local dir's keep-last already
            # bounds what resume can want)
            keep=env_int("HPNN_REPLICATE_KEEP", 64, lo=1))


# --- the shared directory-spool protocol ------------------------------------
# The Replicator's DIR destination writes sha-addressed ``<sha>.bundle``
# files plus one ``index.json`` per scope through these helpers (in the
# JAX package a mesh router's bundle spool shares them), so the format
# lives in exactly one place.

def read_scope_index(root: str) -> list[dict]:
    """The scope dir's index entries (empty on absent/corrupt)."""
    try:
        with open(os.path.join(root, _INDEX)) as fp:
            doc = json.load(fp)
    except (OSError, ValueError, UnicodeDecodeError):
        return []
    bundles = doc.get("bundles") if isinstance(doc, dict) else None
    return [b for b in bundles or []
            if isinstance(b, dict) and b.get("sha256")]


def write_scope_blob(root: str, blob: bytes, sha256: str) -> str:
    """Land one content-addressed blob in the scope dir (atomic,
    idempotent).  Returns the path."""
    from ..io.atomic import atomic_write_bytes

    os.makedirs(root, exist_ok=True)
    dest = os.path.join(root, f"{sha256}.bundle")
    if not os.path.isfile(dest):
        atomic_write_bytes(dest, blob)
    return dest


def update_scope_index(root: str, entry: dict, keep: int) -> list[dict]:
    """Fold one entry into the scope index: dedup by sha256, sort by
    (epoch, tag) -- tolerating entries missing either field -- trim to
    the newest ``keep``, atomically rewrite ``index.json``, unlink
    pruned blobs.  Returns the kept entries (newest last)."""
    from ..io.atomic import atomic_write_text

    index = read_scope_index(root)
    index = [e for e in index if e.get("sha256") != entry["sha256"]]
    index.append(entry)
    index.sort(key=lambda e: (e.get("epoch", 0), e.get("tag", "")))
    pruned, index = index[:-keep], index[-keep:]
    atomic_write_text(os.path.join(root, _INDEX),
                      json.dumps({"version": 1, "bundles": index},
                                 indent=1) + "\n")
    for old in pruned:
        try:
            os.unlink(os.path.join(root, f"{old.get('sha256')}.bundle"))
        except OSError:
            pass
    return index


# --- restore ----------------------------------------------------------------


def list_replicated(dest: str, scope: str) -> list[dict]:
    """The destination's replica index for one scope, oldest-first."""
    if _is_http(dest):
        raise ReplicateError(http_refusal(dest))
    return read_scope_index(os.path.join(os.path.abspath(dest), scope))


def _fetch_blob(dest: str, scope: str, entry: dict) -> bytes | None:
    sha = str(entry.get("sha256") or "")
    try:
        with open(os.path.join(os.path.abspath(dest), scope,
                               f"{sha}.bundle"), "rb") as fp:
            raw = fp.read()
    except OSError:
        return None
    if hashlib.sha256(raw).hexdigest() != sha:
        return None
    return raw


def restore_bundle(dest: str, scope: str, into_dir: str) -> str | None:
    """Materialize the NEWEST intact replicated bundle of ``scope``
    into ``into_dir`` (a checkpoint dir): blob sha256 verified, files
    verified on unpack, and the landed bundle verified once more
    against its own recorded fingerprints.  Walks older replicas on
    any failure; returns the restored bundle path or None."""
    try:
        index = list_replicated(dest, scope)
    except ReplicateError as exc:
        nn_warn(f"CKPT: cannot restore from {dest}: {exc}\n")
        return None
    for entry in sorted(index, key=lambda e: (e.get("epoch", 0),
                                              e.get("tag", "")),
                        reverse=True):
        raw = _fetch_blob(dest, scope, entry)
        if raw is None:
            nn_warn(f"CKPT: replica {entry.get('sha256', '?')[:12]}... "
                    f"of {scope} unreadable/corrupt on {dest}; trying "
                    "older\n")
            continue
        try:
            os.makedirs(into_dir, exist_ok=True)
            bundle = unpack_bundle(raw, into_dir)
        except (ReplicateError, OSError) as exc:
            nn_warn(f"CKPT: replica {entry.get('tag')} failed to "
                    f"unpack: {exc}; trying older\n")
            continue
        ok, reason = snap.verify_bundle(bundle)
        if not ok:
            nn_warn(f"CKPT: restored replica {bundle} failed "
                    f"verification ({reason}); trying older\n")
            continue
        return bundle
    return None
