"""Local checkpoint save/resume with rotation.

Capability parity with the reference's local checkpoint mechanism
(albert/run_trainer.py:56-70 scans ``output_dir/checkpoint*`` for the latest
and resumes; albert/arguments.py:125-126 ``save_steps=500,
save_total_limit=2``). The peer-to-peer mechanism (``load_state_from_peers``)
lives in the averager; this module is the disk mirror used when a whole
collaboration restarts.

Format: one directory per step — ``checkpoint-<step>/`` containing
``state.bin`` (framework wire format, see core/serialization.py) and
``metadata.bin``. Writes go to a temp dir first and are renamed into place,
so a crash mid-save never corrupts the latest checkpoint.
"""
from __future__ import annotations

import os
import re
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from dedloc_tpu_torch.core.serialization import (
    CompressionType,
    deserialize_tree,
    pack_obj,
    serialize_tree,
    unpack_obj,
)
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")

# a .ckpt-tmp-* dir older than this is an orphan from a crashed save (a
# LIVE save finishes in seconds-to-minutes); swept on the next save so
# crashed saves stop accumulating junk in output_dir forever
ORPHAN_TMP_MAX_AGE_S = 3600.0


def sweep_orphan_tmpdirs(
    output_dir: str,
    max_age_s: float = ORPHAN_TMP_MAX_AGE_S,
    now: Optional[float] = None,
) -> List[str]:
    """Delete ``.ckpt-tmp-*`` dirs older than ``max_age_s`` (crashed-save
    leftovers). The age guard keeps a CONCURRENT in-flight save's tmp dir
    safe. Returns the swept paths."""
    if not os.path.isdir(output_dir):
        return []
    now = time.time() if now is None else now
    swept = []
    for name in os.listdir(output_dir):
        if not name.startswith(".ckpt-tmp-"):
            continue
        path = os.path.join(output_dir, name)
        try:
            age = now - os.path.getmtime(path)
        except OSError:
            continue  # raced with the rename of a completing save
        if age >= max_age_s:
            logger.info(f"sweeping orphaned checkpoint tmp dir {path}")
            shutil.rmtree(path, ignore_errors=True)
            swept.append(path)
    return swept


def list_checkpoints(output_dir: str) -> List[Tuple[int, str]]:
    """All checkpoints under ``output_dir``, sorted oldest → newest by step."""
    if not os.path.isdir(output_dir):
        return []
    found = []
    for name in os.listdir(output_dir):
        m = _CKPT_RE.match(name)
        path = os.path.join(output_dir, name)
        if m and os.path.isfile(os.path.join(path, "state.bin")):
            found.append((int(m.group(1)), path))
    found.sort()
    return found


def latest_checkpoint(output_dir: str) -> Optional[Tuple[int, str]]:
    ckpts = list_checkpoints(output_dir)
    return ckpts[-1] if ckpts else None


def save_checkpoint(
    output_dir: str,
    step: int,
    tree: Dict[str, np.ndarray],
    metadata: Optional[Dict[str, Any]] = None,
    save_total_limit: Optional[int] = 2,
) -> str:
    """Atomically write ``checkpoint-<step>`` and rotate old ones."""
    os.makedirs(output_dir, exist_ok=True)
    sweep_orphan_tmpdirs(output_dir)
    final = os.path.join(output_dir, f"checkpoint-{step}")
    tmp = tempfile.mkdtemp(prefix=".ckpt-tmp-", dir=output_dir)
    try:
        with open(os.path.join(tmp, "state.bin"), "wb") as f:
            f.write(serialize_tree(tree, CompressionType.NONE))
        with open(os.path.join(tmp, "metadata.bin"), "wb") as f:
            f.write(pack_obj(metadata or {}))
        if os.path.isdir(final):  # re-saving the same step: replace
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if save_total_limit is not None:
        for _step, path in list_checkpoints(output_dir)[:-save_total_limit]:
            logger.info(f"rotating out old checkpoint {path}")
            shutil.rmtree(path, ignore_errors=True)
    return final


def load_checkpoint(
    path: str,
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    with open(os.path.join(path, "state.bin"), "rb") as f:
        tree = deserialize_tree(f.read())
    meta_path = os.path.join(path, "metadata.bin")
    metadata: Dict[str, Any] = {}
    if os.path.isfile(meta_path):
        with open(meta_path, "rb") as f:
            metadata = unpack_obj(f.read())
    return tree, metadata


def load_latest_checkpoint(
    output_dir: str,
) -> Optional[Tuple[int, Dict[str, np.ndarray], Dict[str, Any]]]:
    """(step, tree, metadata) of the newest LOADABLE checkpoint, or None.

    A corrupt or truncated ``state.bin`` (host died mid-write on a non-
    atomic filesystem, disk bit-rot) falls back to the next-newest
    checkpoint instead of crashing resume — losing ``save_steps`` worth of
    progress beats losing the run."""
    for step, path in reversed(list_checkpoints(output_dir)):
        try:
            tree, metadata = load_checkpoint(path)
            return step, tree, metadata
        except Exception as e:  # noqa: BLE001 — corrupt checkpoint
            logger.warning(
                f"checkpoint {path} is corrupt ({e!r}); trying next-newest"
            )
    return None
