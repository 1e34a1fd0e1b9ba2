"""On-disk snapshot format of the checkpoint subsystem: the port's copy of
the JAX package's ``ckpt/snapshot.py``, with every file name, JSON key and
npz key unchanged, so a bundle written by either package resumes in the
other.

A checkpoint directory holds a flat set of snapshot bundles plus one
manifest:

    <ckpt-dir>/
        manifest.json            latest tag, generation counter,
                                 fingerprints, error trajectory,
                                 retention policy, snapshot index
        ep00000003/              one bundle per checkpointed epoch
            kernel.opt           weights, reference text format
                                 (io.kernel_io -- loadable by run_nn,
                                 serve_nn and the compiled reference)
            state.npz            bit-exact training state: float64
                                 weights (w0..wN), BPM momentum buffers
                                 (m0..mN), the 33-word glibc shuffle-RNG
                                 state, epoch counter, effective seed
                                 (and the CG trainer's cg_* arrays,
                                 carried unchanged)
            snapshot.json        per-bundle manifest (tag, epoch, seed,
                                 fingerprints, mean error, topology)

Two weight encodings on purpose: the text format is the framework's
interop surface (``%17.15f`` quantizes), while ``state.npz`` carries the
raw float64 bits, so ``train_nn --resume`` continues to a byte-identical
``kernel.opt``.  A card's master weights (float64, or float32 under f32
and bf16) round-trip through float64 losslessly.

Crash safety: every bundle is staged under a dot-tmp directory, each file
fsync'd and read back against its intended bytes (bounded retry with
jittered backoff: ``HPNN_CKPT_WRITE_RETRIES``, ``HPNN_CKPT_RETRY_BACKOFF_S``),
then the directory is renamed into place and the parent fsync'd: readers
see a complete bundle or none.  The manifest goes through a staged,
verified replace too, and its ``generation`` counter increments on every
publish.  Every file's sha256 is recorded (``snapshot.json``
``fingerprints``, and the manifest entry, which also covers
``snapshot.json``); :func:`load_snapshot` walks the candidate bundles
newest first and skips any whose bytes no longer match, with a
``ckpt_fallback`` event, so a resume starts from the newest intact state.
The JAX package's chaos hook on durable writes (``io_fault_hook``) is not
part of the port yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import shutil
import time

import numpy as np

from ..io.atomic import fsync_dir
from ..io.kernel_io import dumps_kernel, encode_kernel_text, load_kernel
from ..models.kernel import Kernel

MANIFEST = "manifest.json"
SNAPSHOT_META = "snapshot.json"
SNAPSHOT_STATE = "state.npz"
SNAPSHOT_KERNEL = "kernel.opt"
MANIFEST_VERSION = 1


def snapshot_tag(epoch: int) -> str:
    return f"ep{int(epoch):08d}"


def fingerprint_bytes(data: bytes) -> str:
    return "sha256:" + hashlib.sha256(data).hexdigest()


def fingerprint_file(path: str) -> str | None:
    try:
        with open(path, "rb") as fp:
            return fingerprint_bytes(fp.read())
    except OSError:
        return None


@dataclasses.dataclass
class SnapshotState:
    """Everything ``train_nn --resume`` restores."""

    weights: list[np.ndarray]          # float64, bit-exact
    momentum: list[np.ndarray] | None  # BPM dw buffers (None for BP)
    rng_state: list[int] | None        # glibc shuffle stream (33 words)
    epoch: int
    seed: int
    errors: list[float]                # per-epoch mean final error
    tag: str
    path: str                          # bundle directory
    fingerprint: str | None            # of kernel.opt in the bundle
    target_epochs: int = 0             # the run's --epochs goal (0: unknown)
    # native-trainer carry: flat f64 arrays keyed cg_d/cg_g/cg_meta for
    # the CG trainer (None for BP/BPM); carried unchanged
    trainer_state: dict | None = None
    # process count of the writing run: a resume at a DIFFERENT world
    # size is refused loudly (the run's collectives depend on it).  1 for
    # legacy bundles, and always 1 in the port (one process)
    world_size: int = 1

    @property
    def topology(self) -> list[int]:
        return [int(self.weights[0].shape[1]),
                *[int(w.shape[0]) for w in self.weights]]


def _durable_write(path: str, data: bytes) -> None:
    """Plain write + fsync (used INSIDE a staged tmp bundle, where the
    directory rename provides the atomicity)."""
    with open(path, "wb") as fp:
        fp.write(data)
        fp.flush()
        os.fsync(fp.fileno())


def _state_npz_bytes(weights, momentum, rng_state, epoch: int,
                     seed: int, trainer_state=None) -> bytes:
    arrays = {f"w{i}": np.asarray(w, dtype=np.float64)
              for i, w in enumerate(weights)}
    if momentum is not None:
        arrays.update({f"m{i}": np.asarray(m, dtype=np.float64)
                       for i, m in enumerate(momentum)})
    if rng_state is not None:
        arrays["rng"] = np.asarray(rng_state, dtype=np.int64)
    if trainer_state:
        # native-trainer carry (CG direction/grad/meta); keys are
        # namespaced "cg_*" so the momentum loader's "m"-prefix filter
        # and these never collide
        for k, v in trainer_state.items():
            if not k.startswith("cg_"):
                raise ValueError(f"trainer_state key {k!r} must be "
                                 "namespaced 'cg_*'")
            arrays[k] = np.asarray(v)
    arrays["meta"] = np.asarray([int(epoch), int(seed)], dtype=np.int64)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def write_retries() -> int:
    from ..utils.env import env_int

    return env_int("HPNN_CKPT_WRITE_RETRIES", 3, lo=0)


def _retry_backoff_s(attempt: int) -> float:
    """Jittered exponential backoff between bundle-write attempts."""
    import random

    from ..utils.env import env_float

    base = env_float("HPNN_CKPT_RETRY_BACKOFF_S", 0.05, lo=0.0)
    return base * (2.0 ** attempt) * (0.5 + random.random())


def _verify_staged(path: str, data: bytes) -> None:
    """Read a just-staged file back and compare against the intended
    payload: a torn or bit-flipped write is caught HERE, before the
    bundle rename can ever publish it (raises OSError to the retry
    loop)."""
    with open(path, "rb") as fp:
        if fp.read() != data:
            raise OSError(f"verify-after-write mismatch on {path}")


def write_snapshot(ckpt_dir: str, epoch: int, *, weights, momentum,
                   rng_state, seed: int, errors, name: str = "(null)",
                   train: str = "", dtype: str = "f64",
                   target_epochs: int = 0, trainer_state=None,
                   world_size: int = 1) -> dict:
    """Write one atomic bundle for ``epoch``; returns its index entry
    (tag/epoch/mean_err/fingerprint) for the manifest.  Every staged
    file is read back and byte-verified before the directory rename;
    a failed or corrupted write is retried (bounded, jittered backoff)
    and the LAST failure is raised -- a bundle either publishes
    verified or not at all.

    Runs on the io_pool writer thread in production -- it must not
    print (the caller owns the console stream's byte parity).
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    tag = snapshot_tag(epoch)
    final = os.path.join(ckpt_dir, tag)
    tmp = os.path.join(ckpt_dir, f".tmp.{tag}.{os.getpid()}")
    kernel_text = dumps_kernel(Kernel(name=name, weights=list(weights)))
    kernel_bytes = encode_kernel_text(kernel_text)
    state_bytes = _state_npz_bytes(weights, momentum, rng_state, epoch,
                                   seed, trainer_state)
    fp_kernel = fingerprint_bytes(kernel_bytes)
    errors = [None if e is None else float(e) for e in errors]
    meta = {
        "tag": tag,
        "epoch": int(epoch),
        "seed": int(seed),
        "fingerprint": fp_kernel,
        "fingerprints": {SNAPSHOT_KERNEL: fp_kernel,
                         SNAPSHOT_STATE: fingerprint_bytes(state_bytes)},
        "mean_err": errors[-1] if errors else None,
        "errors": errors,
        "topology": [int(weights[0].shape[1]),
                     *[int(w.shape[0]) for w in weights]],
        "train": train,
        "dtype": dtype,
        "momentum": momentum is not None,
        "trainer_state": bool(trainer_state),
        "target_epochs": int(target_epochs),
        # how many processes agreed that this epoch is the bundle --
        # resume refuses a different world size
        "world_size": int(world_size),
        "barrier_epoch": int(epoch) if int(world_size) > 1 else None,
        "created": time.time(),
    }
    meta_bytes = (json.dumps(meta, indent=1) + "\n").encode()
    files = ((SNAPSHOT_KERNEL, kernel_bytes),
             (SNAPSHOT_STATE, state_bytes),
             (SNAPSHOT_META, meta_bytes))
    last_exc: BaseException | None = None
    for attempt in range(write_retries() + 1):
        if attempt:
            time.sleep(_retry_backoff_s(attempt - 1))
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        try:
            os.makedirs(tmp)
            for fname, data in files:
                fpath = os.path.join(tmp, fname)
                _durable_write(fpath, data)
                _verify_staged(fpath, data)
            fsync_dir(tmp)
            if os.path.isdir(final):  # re-snapshot of the same epoch
                shutil.rmtree(final)
            os.replace(tmp, final)
        except OSError as exc:
            # transient disk trouble (ENOSPC burst, torn write): clean
            # the stage and retry -- nothing was ever renamed into
            # place, so no reader saw a partial bundle
            last_exc = exc
            with contextlib.suppress(OSError):
                shutil.rmtree(tmp)
            continue
        except BaseException:
            with contextlib.suppress(OSError):
                shutil.rmtree(tmp)
            raise
        fsync_dir(ckpt_dir)
        # the manifest entry carries EVERY file's fingerprint --
        # including snapshot.json's own, which cannot self-certify --
        # so verify_bundle has an external cross-check for each byte
        # of the bundle
        return {"tag": tag, "epoch": int(epoch),
                "mean_err": meta["mean_err"], "fingerprint": fp_kernel,
                "fingerprints": dict(
                    meta["fingerprints"],
                    **{SNAPSHOT_META: fingerprint_bytes(meta_bytes)})}
    raise OSError(f"CKPT: bundle {tag} failed verified write after "
                  f"{write_retries() + 1} attempt(s): {last_exc}")


# --- manifest ---------------------------------------------------------------

def manifest_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, MANIFEST)


def read_manifest(ckpt_dir: str) -> dict | None:
    """The checkpoint directory's manifest, or None when absent or
    unparseable (a half-created dir is not an error -- watchers poll)."""
    try:
        with open(manifest_path(ckpt_dir), "r") as fp:
            m = json.load(fp)
    except (OSError, ValueError, UnicodeDecodeError):
        # ValueError covers JSONDecodeError; UnicodeDecodeError covers
        # bit-rot that breaks the utf-8 stream itself
        return None
    return m if isinstance(m, dict) else None


def write_manifest(ckpt_dir: str, manifest: dict) -> None:
    """Verified manifest publish: tmp+fsync+rename via io.atomic, read
    back and compared, retried (bounded, jittered backoff) on any
    failure.  Because the replace is atomic and only runs after the
    temp file fsync'd, a failed attempt leaves the PREVIOUS manifest
    intact -- a disk fault can cost a generation bump, never a
    poisoned manifest."""
    manifest = dict(manifest)
    manifest["version"] = MANIFEST_VERSION
    manifest["updated"] = time.time()
    payload = (json.dumps(manifest, indent=1) + "\n").encode("utf-8")
    path = manifest_path(ckpt_dir)
    stage = f"{path}.stage.{os.getpid()}"
    last_exc: Exception | None = None
    for attempt in range(write_retries() + 1):
        if attempt:
            time.sleep(_retry_backoff_s(attempt - 1))
        try:
            # stage + verify FIRST, replace LAST: the previous
            # manifest must never be overwritten by bytes that have
            # not already been read back intact (a persistently
            # corrupting disk then exhausts the retries with the OLD
            # manifest still published)
            _durable_write(stage, payload)
            _verify_staged(stage, payload)
            os.replace(stage, path)
        except OSError as exc:
            last_exc = exc
            with contextlib.suppress(OSError):
                os.unlink(stage)
            continue
        fsync_dir(os.path.dirname(os.path.abspath(path)))
        return
    raise OSError(f"CKPT: manifest write failed after "
                  f"{write_retries() + 1} attempt(s): {last_exc}")


def publish_snapshot(ckpt_dir: str, entry: dict, *, seed: int, errors,
                     keep_last: int = 0) -> dict:
    """Fold one bundle's index entry into the manifest (generation bump)
    and apply retention.  Returns the manifest written."""
    prev = read_manifest(ckpt_dir) or {}
    snaps = [s for s in prev.get("snapshots", [])
             if s.get("tag") != entry["tag"]]
    snaps.append(entry)
    snaps.sort(key=lambda s: s.get("epoch", 0))
    manifest = dict(prev)
    manifest.update({
        "generation": int(prev.get("generation", 0)) + 1,
        "latest": entry["tag"],
        "epoch": entry["epoch"],
        "seed": int(seed),
        "fingerprint": entry["fingerprint"],
        "kernel": os.path.join(entry["tag"], SNAPSHOT_KERNEL),
        "errors": [None if e is None else float(e) for e in errors],
        "retention": {"keep_last": int(keep_last), "keep_best": True},
        "snapshots": snaps,
    })
    manifest["snapshots"] = _apply_retention(ckpt_dir, snaps, keep_last)
    write_manifest(ckpt_dir, manifest)
    return manifest


def record_final_kernel(ckpt_dir: str, kernel_path: str) -> None:
    """Stamp the manifest with the path + fingerprint of the final
    ``kernel.opt`` train_nn wrote, so ``run_nn`` (and ops tooling) can
    detect a stale or hand-edited weights file (generation bump: a
    watching server hot-reloads the finished kernel)."""
    fp = fingerprint_file(kernel_path)
    if fp is None:
        return
    manifest = read_manifest(ckpt_dir) or {}
    manifest["generation"] = int(manifest.get("generation", 0)) + 1
    manifest["final_kernel"] = os.path.abspath(kernel_path)
    manifest["final_fingerprint"] = fp
    write_manifest(ckpt_dir, manifest)


def refresh_final_kernel(ckpt_dir: str, kernel_path: str) -> None:
    """Keep the manifest honest across PLAIN (non-checkpointed)
    retrains: when a manifest already tracks exactly this kernel file,
    re-record its fingerprint after a fresh dump -- otherwise every
    later ``run_nn`` would warn 'stale or modified weights' about a
    kernel that is actually NEWER than the manifest, training users to
    ignore the guard.  A no-op when no manifest tracks the file."""
    manifest = read_manifest(ckpt_dir)
    if not manifest:
        return
    if manifest.get("final_kernel") == os.path.abspath(kernel_path):
        record_final_kernel(ckpt_dir, kernel_path)


def _apply_retention(ckpt_dir: str, snaps: list[dict],
                     keep_last: int) -> list[dict]:
    """keep-last-N + best-by-error: the N most recent bundles always
    survive, and so does the lowest-mean-error one (keep_last <= 0 keeps
    everything).  Pruned bundles are deleted from disk."""
    if keep_last <= 0 or len(snaps) <= keep_last:
        return snaps
    by_epoch = sorted(snaps, key=lambda s: s.get("epoch", 0))
    keep = {s["tag"] for s in by_epoch[-keep_last:]}
    scored = [s for s in snaps if s.get("mean_err") is not None]
    if scored:
        keep.add(min(scored, key=lambda s: s["mean_err"])["tag"])
    kept = []
    for s in by_epoch:
        if s["tag"] in keep:
            kept.append(s)
            continue
        with contextlib.suppress(OSError):
            shutil.rmtree(os.path.join(ckpt_dir, s["tag"]))
    return kept


# --- resume ----------------------------------------------------------------

def _bundle_tags(path: str) -> list[str]:
    """Bundle directory names under a checkpoint dir, newest epoch
    first (tags sort lexically == numerically by construction)."""
    try:
        return sorted((t for t in os.listdir(path)
                       if t.startswith("ep") and os.path.isfile(
                           os.path.join(path, t, SNAPSHOT_STATE))),
                      reverse=True)
    except OSError:
        return []


def candidate_bundles(path: str) -> list[str]:
    """Every bundle a ``--resume``/recovery of ``path`` could load,
    newest-first: an explicit bundle dir leads, then the manifest's
    latest, then every remaining on-disk bundle by descending epoch --
    the walk-back order for verified resume."""
    path = os.path.abspath(path)
    if os.path.isfile(path):
        path = os.path.dirname(path)
    if not os.path.isdir(path):
        return []
    out: list[str] = []
    if os.path.isfile(os.path.join(path, SNAPSHOT_STATE)):
        # an explicit bundle dir: it leads, its siblings are fallback
        out.append(path)
        path = os.path.dirname(path)
    manifest = read_manifest(path)
    if manifest and manifest.get("latest"):
        bundle = os.path.join(path, manifest["latest"])
        if os.path.isfile(os.path.join(bundle, SNAPSHOT_STATE)):
            out.append(bundle)
    out.extend(os.path.join(path, t) for t in _bundle_tags(path))
    seen: set[str] = set()
    return [b for b in out if not (b in seen or seen.add(b))]


def _manifest_fingerprints(bundle: str) -> dict:
    """The manifest's recorded per-file fingerprints for this bundle
    (empty when the manifest is absent/corrupt/legacy).  This is the
    EXTERNAL cross-check: ``snapshot.json`` cannot certify its own
    bytes, so its sha256 lives in the manifest entry."""
    manifest = read_manifest(os.path.dirname(os.path.abspath(bundle)))
    if not manifest:
        return {}
    tag = os.path.basename(bundle.rstrip(os.sep))
    for entry in manifest.get("snapshots", []):
        if isinstance(entry, dict) and entry.get("tag") == tag:
            prints = entry.get("fingerprints")
            return prints if isinstance(prints, dict) else {}
    return {}


def verify_bundle(bundle: str) -> tuple[bool, str]:
    """ENFORCE a bundle's recorded fingerprints: every file
    named in ``snapshot.json``'s ``fingerprints`` map -- plus the
    manifest entry's cross-check, which covers ``snapshot.json``
    itself -- must hash to its recorded sha256, and ``state.npz`` must
    structurally parse.  An unparseable ``snapshot.json`` is corrupt
    (bundles publish atomically; a half file cannot exist).  Legacy
    bundles (no ``fingerprints``) fall back to the kernel-only
    ``fingerprint`` field plus the parse check.  Returns
    ``(ok, reason)`` -- reason names the first failing file."""
    meta = None
    with contextlib.suppress(OSError, ValueError, UnicodeDecodeError):
        with open(os.path.join(bundle, SNAPSHOT_META)) as fp:
            meta = json.load(fp)
    if not isinstance(meta, dict):
        return False, f"{SNAPSHOT_META}: missing or unparseable"
    prints = dict(_manifest_fingerprints(bundle))
    own = meta.get("fingerprints")
    if isinstance(own, dict):
        # the bundle's own map fills anything the manifest lacks; on
        # conflict the manifest wins (it is the external witness)
        for k, v in own.items():
            prints.setdefault(k, v)
    elif not prints and meta.get("fingerprint"):
        prints[SNAPSHOT_KERNEL] = meta["fingerprint"]
    for fname, recorded in sorted(prints.items()):
        actual = fingerprint_file(os.path.join(bundle, fname))
        if actual is None:
            return False, f"{fname}: unreadable"
        if actual != recorded:
            return False, f"{fname}: sha256 mismatch"
    try:
        with np.load(os.path.join(bundle, SNAPSHOT_STATE),
                     allow_pickle=False) as z:
            if "meta" not in z.files:
                return False, f"{SNAPSHOT_STATE}: missing meta"
    except (OSError, KeyError, ValueError) as exc:
        return False, f"{SNAPSHOT_STATE}: {type(exc).__name__}: {exc}"
    return True, "ok"


def _load_bundle_state(bundle: str) -> SnapshotState | None:
    from ..utils.nn_log import nn_error

    try:
        with np.load(os.path.join(bundle, SNAPSHOT_STATE),
                     allow_pickle=False) as z:
            weights = [z[k] for k in sorted(
                (k for k in z.files if k.startswith("w")),
                key=lambda k: int(k[1:]))]
            momentum = [z[k] for k in sorted(
                (k for k in z.files if k.startswith("m") and k != "meta"),
                key=lambda k: int(k[1:]))] or None
            rng = [int(v) for v in z["rng"]] if "rng" in z.files else None
            trainer_state = {k: z[k] for k in z.files
                             if k.startswith("cg_")} or None
            epoch, seed = (int(v) for v in z["meta"])
    except (OSError, KeyError, ValueError) as exc:
        nn_error(f"CKPT: unreadable snapshot state in {bundle}: {exc}\n")
        return None
    meta = {}
    with contextlib.suppress(OSError, ValueError, UnicodeDecodeError):
        with open(os.path.join(bundle, SNAPSHOT_META)) as fp:
            meta = json.load(fp)
    errors = [e for e in meta.get("errors", [])]
    fp_actual = fingerprint_file(os.path.join(bundle, SNAPSHOT_KERNEL))
    return SnapshotState(weights=weights, momentum=momentum,
                         rng_state=rng, epoch=epoch, seed=seed,
                         errors=errors, tag=os.path.basename(bundle),
                         path=bundle, fingerprint=fp_actual,
                         target_epochs=int(meta.get("target_epochs", 0)),
                         trainer_state=trainer_state,
                         world_size=int(meta.get("world_size", 1)))


def load_snapshot(path: str, verify: bool = True) -> SnapshotState | None:
    """Load a bundle (or a checkpoint dir's latest bundle) back into
    host state.  Weights come from ``state.npz`` -- bit-exact float64,
    NOT the quantized text -- which is what makes resume byte-identical.

    Verified resume with last-good fallback: candidates are
    tried newest-first; a bundle whose bytes no longer match its
    recorded fingerprints (or fail to parse) is SKIPPED with a loud
    ``ckpt_fallback`` structured event + NN(WARN), and the walk
    continues to the newest intact bundle -- resume never crashes on,
    or silently trains from, a corrupted snapshot.  Returns None (with
    an NN(ERR) diagnostic) when nothing intact is found."""
    from ..utils.nn_log import nn_error, nn_event, nn_warn

    candidates = candidate_bundles(path)
    if not candidates:
        nn_error(f"CKPT: no resumable snapshot at {path}\n")
        return None
    for bundle in candidates:
        if verify:
            ok, reason = verify_bundle(bundle)
            if not ok:
                nn_warn(f"CKPT: snapshot {bundle} failed verification "
                        f"({reason}); falling back to the previous "
                        "intact bundle\n")
                nn_event("ckpt_fallback", bundle=bundle, reason=reason)
                continue
        snap = _load_bundle_state(bundle)
        if snap is not None:
            return snap
    nn_error(f"CKPT: no INTACT snapshot at {path} "
             f"({len(candidates)} candidate(s) all failed "
             "verification)\n")
    return None


def looks_like_checkpoint(path: str) -> bool:
    """Is ``path`` plausibly a checkpoint dir/bundle/file?  The CLI's
    ``--resume [PATH]`` grammar uses this to tell an optional resume
    path from the trailing conf filename."""
    if os.path.isdir(path):
        return (os.path.isfile(os.path.join(path, MANIFEST))
                or os.path.isfile(os.path.join(path, SNAPSHOT_STATE))
                or any(t.startswith("ep") for t in os.listdir(path)))
    return os.path.basename(path) in (MANIFEST, SNAPSHOT_META,
                                      SNAPSHOT_STATE)


def check_kernel_fingerprint(kernel_path: str | None,
                             ckpt_dir: str) -> bool:
    """``run_nn`` guard: when the checkpoint manifest has a
    recorded fingerprint for this exact kernel file and the bytes on
    disk no longer match, WARN with both paths instead of silently
    evaluating stale/modified weights.  Returns False on mismatch."""
    from ..utils.nn_log import nn_warn

    if not kernel_path:
        return True
    manifest = read_manifest(ckpt_dir)
    if not manifest:
        return True
    kp = os.path.abspath(kernel_path)
    recorded = None
    if manifest.get("final_kernel") == kp:
        recorded = manifest.get("final_fingerprint")
    elif manifest.get("kernel") and os.path.join(
            os.path.abspath(ckpt_dir), manifest["kernel"]) == kp:
        recorded = manifest.get("fingerprint")
    if not recorded:
        return True
    actual = fingerprint_file(kp)
    if actual is None or actual == recorded:
        return True
    nn_warn(f"kernel fingerprint mismatch: {kp} does not match the "
            f"manifest {manifest_path(os.path.abspath(ckpt_dir))} "
            "(stale or modified weights?)\n")
    return False


def load_bundle_kernel(bundle: str):
    """The bundle's text-format kernel (what serve hot-reload swaps in)."""
    return load_kernel(os.path.join(bundle, SNAPSHOT_KERNEL))
