"""Checkpoints and multi-epoch training (``train_nn --epochs N
--ckpt-every K --ckpt-dir D --resume``): crash-safe epoch-boundary
snapshot bundles and bit-exact resume, in the JAX package's on-disk
format.  ``snapshot.py`` is the format, ``manager.py`` the writer on the
shared io pool, ``replicate.py`` the directory replica, ``trainer.py`` the
multi-epoch loop with its SIGTERM/SIGINT final snapshot."""

from .manager import CheckpointManager
from .replicate import Replicator, pack_bundle, restore_bundle, unpack_bundle
from .snapshot import (
    MANIFEST,
    SNAPSHOT_KERNEL,
    SNAPSHOT_META,
    SNAPSHOT_STATE,
    SnapshotState,
    candidate_bundles,
    check_kernel_fingerprint,
    fingerprint_bytes,
    fingerprint_file,
    load_bundle_kernel,
    load_snapshot,
    looks_like_checkpoint,
    manifest_path,
    publish_snapshot,
    read_manifest,
    record_final_kernel,
    refresh_final_kernel,
    snapshot_tag,
    verify_bundle,
    write_manifest,
    write_snapshot,
)
from .trainer import train_loop

__all__ = [
    "CheckpointManager", "MANIFEST", "SNAPSHOT_KERNEL", "SNAPSHOT_META",
    "SNAPSHOT_STATE", "SnapshotState", "candidate_bundles",
    "check_kernel_fingerprint",
    "fingerprint_bytes", "fingerprint_file", "load_bundle_kernel",
    "load_snapshot", "looks_like_checkpoint", "manifest_path", "publish_snapshot",
    "read_manifest", "record_final_kernel", "refresh_final_kernel", "snapshot_tag", "train_loop",
    "verify_bundle", "write_manifest", "write_snapshot",
    "Replicator", "pack_bundle", "unpack_bundle", "restore_bundle",
]
