"""Checkpoint hub publication: git-backed and directory-mirror uploaders.

Capability parity with the reference coordinator's hub upload
(albert/run_first_peer.py:123-147): every ``upload_interval`` the coordinator
pulls the collaboration state, writes a local checkpoint, and publishes it —
there via ``save_pretrained`` + ``torch.save`` + ``git add/commit/push`` to
the HF hub, here via a pluggable ``upload_fn(checkpoint_path, step)`` built
by one of these factories. The git uploader works against ANY git remote
(a local bare repo in tests, an HTTPS hub remote in production); the
directory mirror is the zero-dependency fallback.

Git identity is passed per-invocation (``git -c user.name=...``) so the
uploader never touches the user's or repository's git config.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import Callable, Optional

from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

UploadFn = Callable[[str, int], None]

_GIT_ID = [
    "-c", "user.name=dedloc-coordinator",
    "-c", "user.email=coordinator@dedloc.invalid",
]


def _git(repo: str, *argv: str, timeout: float = 300.0) -> str:
    # a hung remote (stalled network during push/fetch) must not wedge the
    # caller forever — the coordinator's loop depends on this bound
    out = subprocess.run(
        ["git", *_GIT_ID, "-C", repo, *argv],
        capture_output=True,
        text=True,
        timeout=timeout,
    )
    if out.returncode != 0:
        # surface git's actual stderr — CalledProcessError alone hides it
        raise RuntimeError(
            f"git {' '.join(argv)} failed ({out.returncode}): "
            f"{out.stderr.strip() or out.stdout.strip()}"
        )
    return out.stdout.strip()


def _mirror_checkpoint(checkpoint_path: str, dest: str) -> None:
    """Copy a checkpoint dir's files into ``dest`` (latest-wins layout, like
    the reference overwriting model files in its hub working tree)."""
    os.makedirs(dest, exist_ok=True)
    for name in os.listdir(checkpoint_path):
        src = os.path.join(checkpoint_path, name)
        dst = os.path.join(dest, name)
        if os.path.isdir(src):
            shutil.copytree(src, dst, dirs_exist_ok=True)
        else:
            shutil.copy2(src, dst)


def git_hub_uploader(
    work_dir: str,
    remote_url: Optional[str] = None,
    branch: str = "main",
) -> UploadFn:
    """``upload_fn`` that commits each checkpoint into a git working tree at
    ``work_dir`` and (when ``remote_url`` is set) pushes it.

    The working tree holds the LATEST checkpoint's files at its root plus a
    ``step.txt`` marker; history preserves every published step as a commit —
    the same shape as the reference's hub repository.
    """

    def upload(checkpoint_path: str, step: int) -> None:
        os.makedirs(work_dir, exist_ok=True)
        if not os.path.isdir(os.path.join(work_dir, ".git")):
            _git(work_dir, "init", "--initial-branch", branch)
            if remote_url:
                _git(work_dir, "remote", "add", "origin", remote_url)
                # a fresh work_dir against a hub with history (coordinator
                # restart) must build on the remote tip, or every push is
                # rejected as non-fast-forward forever
                try:
                    _git(work_dir, "fetch", "origin", branch)
                    _git(work_dir, "checkout", "-B", branch, "FETCH_HEAD")
                except RuntimeError:
                    pass  # empty remote: first-ever publish
        _mirror_checkpoint(checkpoint_path, work_dir)
        with open(os.path.join(work_dir, "step.txt"), "w") as f:
            f.write(str(step))
        _git(work_dir, "add", "-A")
        status = _git(work_dir, "status", "--porcelain")
        if not status:
            logger.info(f"hub: step {step} identical to HEAD; nothing to push")
            return
        _git(work_dir, "commit", "-m", f"checkpoint at collaboration step {step}")
        if remote_url:
            _git(work_dir, "push", "origin", branch)
        logger.info(f"hub: published checkpoint step {step}")

    return upload


def directory_mirror_uploader(dest_root: str) -> UploadFn:
    """``upload_fn`` that mirrors each checkpoint to
    ``dest_root/checkpoint-<step>`` plus a ``latest`` marker file — the
    zero-dependency hub for air-gapped deployments."""

    def upload(checkpoint_path: str, step: int) -> None:
        dest = os.path.join(dest_root, f"checkpoint-{step}")
        _mirror_checkpoint(checkpoint_path, dest)
        tmp = os.path.join(dest_root, ".latest.tmp")
        with open(tmp, "w") as f:
            f.write(str(step))
        os.replace(tmp, os.path.join(dest_root, "latest"))
        logger.info(f"hub mirror: published checkpoint step {step} -> {dest}")

    return upload


def build_upload_fn(
    hub_git_dir: str = "",
    hub_git_remote: str = "",
    hub_mirror_dir: str = "",
) -> Optional[UploadFn]:
    """Resolve coordinator CLI flags into an upload_fn (None = seam unused)."""
    if hub_git_dir:
        return git_hub_uploader(hub_git_dir, hub_git_remote or None)
    if hub_mirror_dir:
        return directory_mirror_uploader(hub_mirror_dir)
    return None
