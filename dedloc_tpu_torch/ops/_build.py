"""Build and load the port's CUDA C++ kernels.

Each source under ``ops/csrc/`` is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). The library lands in ``dedloc_tpu_torch/build/``, named
by a hash of its source, the headers beside it (``csrc/*.cuh``) and the
flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is. Building happens at first use, never at
import: the CPU-only test environment has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
]

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    for candidate in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels are "
        "built from source on the machine with the card"
    )


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of that source,
    every header under ``csrc/`` (any of them may be included) and the
    flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(name: str) -> None:
    """Compile ``ops/csrc/<name>.cu`` unless its current library exists.
    nvcc's output (with ptxas's register and spill report) goes to the
    library's ``.log``; a failed build raises with that log."""
    with _lock:
        out = library_path(name)
        if out.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = out.with_suffix(".log")
        with open(log, "w") as f:
            rc = subprocess.run(
                [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=f, stderr=subprocess.STDOUT,
            ).returncode
        if rc != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu (rc={rc}):\n" + log.read_text())
        os.replace(tmp, out)


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``ops/csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def build_log(name: str) -> str:
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""
