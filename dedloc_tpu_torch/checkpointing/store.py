"""Local content-addressed shard store: durable sharded checkpoints and
resumable restore downloads.

Layout under one root directory::

    <root>/manifest-<step>.bin     serialized CheckpointManifest
    <root>/shards/<sha256hex>.bin  raw fp32 shard bytes, content-addressed

Shards are keyed by their own digest, so a shard unchanged between steps is
stored ONCE and shared by every manifest that references it (embedding rows
that stopped moving, frozen heads, optimizer moments at rest) — rotation
keeps the newest ``keep`` manifests and garbage-collects shards nothing
references. Writes are atomic (tmp + rename) and reads re-verify the digest,
so a torn write or bit-rot surfaces as a missing shard, never as silently
adopted garbage.

Two consumers:

- the coordinator writes a sharded checkpoint per pulled state (the durable
  manifest trail next to the legacy ``checkpoint-<step>/state.bin``);
- a restoring peer points the fetcher at a store so partially-downloaded
  restores RESUME: shards fetched before a crash are verified from disk and
  only the missing ones are pulled again.
"""
from __future__ import annotations

import hashlib
import os
import re
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from dedloc_tpu_torch.checkpointing.manifest import (
    DEFAULT_SHARD_SIZE,
    CheckpointManifest,
    assemble_tree,
    build_manifest,
    shard_bytes,
)
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_MANIFEST_RE = re.compile(r"^manifest-(\d+)\.bin$")

# a *.tmp file older than this is an orphan from a write killed between
# mkstemp and os.replace (a live put finishes in seconds); same crashed-write
# junk class — and the same age guard — as utils.checkpoint's .ckpt-tmp-* sweep
ORPHAN_TMP_MAX_AGE_S = 3600.0


def _sweep_orphan_tmpfiles(
    directory: str, max_age_s: float = ORPHAN_TMP_MAX_AGE_S
) -> None:
    if not os.path.isdir(directory):
        return
    # dedlint: disable=clock-wall — compared against st_mtime (wall by
    # definition); virtual time would mis-age real files
    now = time.time()  # dedlint: disable=clock-wall
    for name in os.listdir(directory):
        if not name.endswith(".tmp"):
            continue
        path = os.path.join(directory, name)
        try:
            if now - os.path.getmtime(path) >= max_age_s:
                os.unlink(path)
        except OSError:
            continue  # raced with a completing put's os.replace


class ShardStore:
    """Content-addressed shard + manifest storage under one directory."""

    def __init__(self, root: str):
        self.root = root
        self.shard_dir = os.path.join(root, "shards")

    # -------------------------------------------------------------- shards

    def _shard_path(self, digest: bytes) -> str:
        return os.path.join(self.shard_dir, digest.hex() + ".bin")

    def has_shard(self, digest: bytes) -> bool:
        return os.path.isfile(self._shard_path(digest))

    def put_shard(self, digest: bytes, raw: bytes) -> str:
        """Atomically persist a shard (no-op if already present — content
        addressing makes re-puts free)."""
        path = self._shard_path(digest)
        if os.path.isfile(path):
            return path
        os.makedirs(self.shard_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.shard_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(raw)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path

    def get_shard(self, digest: bytes) -> Optional[bytes]:
        """Read a shard back, RE-VERIFYING its digest: a corrupt cached
        shard (torn write, bit-rot) is deleted and reported missing, so it
        gets re-fetched instead of poisoning a resumed restore."""
        path = self._shard_path(digest)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            return None
        if hashlib.sha256(raw).digest() != digest:
            logger.warning(f"dropping corrupt cached shard {digest.hex()[:12]}")
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        return raw

    def missing_shards(self, manifest: CheckpointManifest) -> List[int]:
        return [
            i
            for i, digest in enumerate(manifest.shard_digests)
            if not self.has_shard(digest)
        ]

    # ----------------------------------------------------------- manifests

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.root, f"manifest-{step}.bin")

    def put_manifest(self, manifest: CheckpointManifest) -> str:
        os.makedirs(self.root, exist_ok=True)
        path = self._manifest_path(manifest.step)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(manifest.to_bytes())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path

    def manifest_steps(self) -> List[int]:
        """All stored manifest steps, oldest -> newest."""
        if not os.path.isdir(self.root):
            return []
        steps = []
        for name in os.listdir(self.root):
            m = _MANIFEST_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def load_manifest(self, step: int) -> Optional[CheckpointManifest]:
        try:
            with open(self._manifest_path(step), "rb") as f:
                return CheckpointManifest.from_bytes(f.read())
        except (OSError, ValueError, KeyError):
            return None

    def latest_manifest(self) -> Optional[CheckpointManifest]:
        """Newest manifest whose file parses; a truncated newest manifest
        falls back to the next one, mirroring load_latest_checkpoint."""
        for step in reversed(self.manifest_steps()):
            manifest = self.load_manifest(step)
            if manifest is not None:
                return manifest
            logger.warning(
                f"sharded manifest-{step}.bin is corrupt; trying next-newest"
            )
        return None

    # ------------------------------------------------------------ rotation

    def gc(self, keep: Optional[int] = 2) -> None:
        """Keep the newest ``keep`` manifests (None = all), delete every
        shard no kept manifest references, and sweep *.tmp orphans left by
        writes killed mid-put (age-guarded so in-flight puts survive)."""
        _sweep_orphan_tmpfiles(self.root)
        _sweep_orphan_tmpfiles(self.shard_dir)
        steps = self.manifest_steps()
        if keep is not None:
            for step in steps[:-keep] if keep else steps:
                try:
                    os.unlink(self._manifest_path(step))
                except OSError:
                    pass
            steps = steps[-keep:] if keep else []
        referenced = set()
        for step in steps:
            manifest = self.load_manifest(step)
            if manifest is not None:
                referenced.update(d.hex() for d in manifest.shard_digests)
        if not os.path.isdir(self.shard_dir):
            return
        for name in os.listdir(self.shard_dir):
            if not name.endswith(".bin"):
                continue
            if name[: -len(".bin")] not in referenced:
                try:
                    os.unlink(os.path.join(self.shard_dir, name))
                except OSError:
                    pass


def save_sharded_checkpoint(
    root: str,
    tree: Dict[str, np.ndarray],
    step: int,
    shard_size: int = DEFAULT_SHARD_SIZE,
    metadata: Optional[Dict[str, Any]] = None,
    keep: Optional[int] = 2,
) -> CheckpointManifest:
    """Write ``tree`` as a manifest + content-addressed shards under
    ``root`` and rotate old manifests. Shards shared with prior steps are
    deduplicated by construction."""
    store = ShardStore(root)
    manifest, flat = build_manifest(
        tree, step, shard_size=shard_size, metadata=metadata
    )
    for i, digest in enumerate(manifest.shard_digests):
        store.put_shard(digest, shard_bytes(flat, manifest, i))
    store.put_manifest(manifest)
    store.gc(keep=keep)
    return manifest


def load_sharded_checkpoint(
    root: str, step: Optional[int] = None
) -> Optional[Tuple[int, Dict[str, np.ndarray], Dict[str, Any]]]:
    """(step, tree, metadata) from the local store (newest manifest when
    ``step`` is None); None when absent or incomplete/corrupt."""
    store = ShardStore(root)
    manifest = (
        store.load_manifest(step) if step is not None else store.latest_manifest()
    )
    if manifest is None:
        return None
    shards: Dict[int, np.ndarray] = {}
    for i, digest in enumerate(manifest.shard_digests):
        raw = store.get_shard(digest)
        if raw is None or len(raw) != manifest.shard_nbytes(i):
            logger.warning(
                f"sharded checkpoint at step {manifest.step} is missing "
                f"shard {i}; cannot load locally"
            )
            return None
        shards[i] = np.frombuffer(raw, dtype=np.float32)
    return manifest.step, assemble_tree(manifest, shards), manifest.metadata
