"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points default to the card, and its kernel wrappers take the plain
versions only for CPU tensors (launching nothing)."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dedloc_tpu_torch.ops import flash_attention as fa
from dedloc_tpu_torch.ops import fused_ln as fl
from dedloc_tpu_torch.roles.common import build_model, drop_collator_keys

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
import dedloc_tpu_torch
# the compiled wire codec (native/_wirecodec.so, built at first use) is
# loaded with ctypes, not imported
names = [m.name for m in pkgutil.walk_packages(dedloc_tpu_torch.__path__,
                                               "dedloc_tpu_torch.")
         if m.name != "dedloc_tpu_torch.native._wirecodec"]
for name in names:
    importlib.import_module(name)
banned = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "chex")
          or m == "dedloc_tpu" or m.startswith("dedloc_tpu.")]
print(len(names), "torch" in sys.modules, banned)
"""


def test_package_imports_no_jax_and_nothing_of_dedloc_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    n_modules, has_torch, banned = out.stdout.strip().split(" ", 2)
    assert int(n_modules) >= 15
    assert has_torch == "True"
    assert banned == "[]", banned


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model("tiny")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        drop_collator_keys({"input_ids": np.zeros((1, 4), np.int32),
                            "attention_mask": np.ones((1, 4), np.int32),
                            "token_type_ids": np.zeros((1, 4), np.int32),
                            "mlm_labels": np.zeros((1, 4), np.int32),
                            "sop_labels": np.zeros((1,), np.int32)})
    cfg, model = build_model("tiny", device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def _reset():
    for w in fa.WRAPPERS + fl.WRAPPERS:
        w.launches = 0


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    _reset()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 16, 2, 16, generator=g, requires_grad=True)
               for _ in range(3))
    fa.flash_attention(q, k, v, torch.zeros(2, 16)).sum().backward()
    x, r = (torch.randn(8, 32, generator=g, requires_grad=True) for _ in range(2))
    gamma, beta = torch.ones(32, requires_grad=True), torch.zeros(32)
    fl.ln_residual(x, r, gamma, beta).sum().backward()
    with torch.no_grad():
        fl.ln_residual(x, r, gamma, beta)
    assert q.grad is not None and x.grad is not None
    assert {w.__name__: w.launches for w in fa.WRAPPERS + fl.WRAPPERS} == {
        "flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0,
        "ln_fwd": 0, "ln_bwd": 0}


def test_wrappers_refuse_devices_without_a_kernel():
    meta = torch.empty(2, 16, 2, 16, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        fa.flash_fwd(meta, meta, meta, torch.empty(2, 16, device="meta"))
    rows = torch.empty(8, 32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        fl.ln_fwd(rows, rows, torch.empty(32, device="meta"),
                  torch.empty(32, device="meta"), 1e-12)


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = lambda cwd: subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120)
    here = run(REPO)
    assert here.returncode != 0 and here.stdout == ""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = run(tmp_path)
    assert alone.returncode != 0 and alone.stdout == ""


_SLICE_MODULES = ("dedloc_tpu_torch.parallel.mesh", "dedloc_tpu_torch.parallel.sharding",
                  "dedloc_tpu_torch.parallel.zero", "dedloc_tpu_torch.parallel.pipeline",
                  "dedloc_tpu_torch.collaborative.slice")


def test_slice_modules_import_alone_and_their_mesh_defaults_to_the_card():
    """The mesh modules of the parallel-axes slice import with nothing of
    JAX (the probe above walks them too), and ``make_mesh`` resolves the
    card unless the caller names the CPU, like every entry point."""
    code = ("import importlib, sys\n"
            f"for m in {_SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'dedloc_tpu')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
    from dedloc_tpu_torch.parallel.mesh import make_mesh

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(1)
    assert make_mesh(1, device_type="cpu").device.type == "cpu"
