"""The port's kernel build (``dedloc_tpu_torch/ops/_build.py``) on the CPU:
the library name follows every source it is built from, headers included,
and importing the ops needs no CUDA compiler."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from dedloc_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_library_path_is_stable(csrc_copy):
    assert _build.library_path("flash_attention") == _build.library_path("flash_attention")


@pytest.mark.parametrize("edited", ["flash_attention.cu", "hopper.cuh"])
def test_editing_a_source_or_header_renames_the_library(csrc_copy, edited):
    before = _build.library_path("flash_attention")
    path = csrc_copy / edited
    path.write_text(path.read_text() + "\n// edited\n")
    after = _build.library_path("flash_attention")
    assert after != before and after.parent == before.parent


def test_a_new_header_renames_the_library(csrc_copy):
    before = _build.library_path("flash_attention")
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path("flash_attention") != before


def test_importing_the_ops_needs_no_nvcc(tmp_path):
    """With no nvcc on PATH or under CUDA_HOME, the kernel modules import
    and only a build raises."""
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path / "none"),
               PYTHONPATH=str(REPO))
    code = (
        "from dedloc_tpu_torch.ops import _build, flash_attention, fused_ln\n"
        "try:\n"
        "    _build.find_nvcc()\n"
        "except RuntimeError:\n"
        "    print('no nvcc')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "no nvcc"
