"""ctypes loader + numpy wrappers for the native wire codec.

The reference keeps its wire hot loops in native dependency code (protobuf/
grpc C++ wheels, NCCL — SURVEY.md §2.7); this package is the TPU build's
in-tree equivalent (native/wirecodec.cpp). The .so is compiled lazily with
g++ on first import (no pybind11 in the image, so plain `extern "C"` +
ctypes); every entry point has a numpy fallback so the framework works on
machines without a toolchain. `AVAILABLE` reports which path is active.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO_PATH = os.path.join(_HERE, "_wirecodec.so")
_SRC_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native")

_lib: Optional[ctypes.CDLL] = None


def _build() -> bool:
    src = os.path.join(_SRC_DIR, "wirecodec.cpp")
    if not os.path.exists(src):
        return False
    # build to a per-pid temp path and rename into place: concurrent
    # importers must never CDLL a half-written .so
    tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            [
                "g++", "-O3", "-fPIC", "-std=c++17", "-shared",
                src, "-o", tmp,
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _SO_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _stale() -> bool:
    src = os.path.join(_SRC_DIR, "wirecodec.cpp")
    try:
        return os.path.getmtime(src) > os.path.getmtime(_SO_PATH)
    except OSError:
        return False


def _load() -> Optional[ctypes.CDLL]:
    if (not os.path.exists(_SO_PATH) or _stale()) and not _build():
        if not os.path.exists(_SO_PATH):
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    lib.f32_to_f16.argtypes = [f32p, u16p, i64]
    lib.f16_to_f32.argtypes = [u16p, f32p, i64]
    lib.quantize_uint8.argtypes = [f32p, u8p, i64, f32p, f32p]
    lib.dequantize_uint8.argtypes = [u8p, f32p, i64, ctypes.c_float, ctypes.c_float]
    lib.axpy_f32.argtypes = [f32p, f32p, ctypes.c_float, i64]
    lib.scale_f32.argtypes = [f32p, ctypes.c_float, i64]
    lib.crc32c.argtypes = [u8p, i64]
    lib.crc32c.restype = ctypes.c_uint32
    return lib


_lib = _load()
AVAILABLE = _lib is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def f32_to_f16(x: np.ndarray) -> np.ndarray:
    """fp32 -> IEEE fp16 bytes-compatible array (round-to-nearest-even)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    if _lib is None:
        return x.astype(np.float16)
    out = np.empty(x.shape, dtype=np.float16)
    _lib.f32_to_f16(
        _ptr(x, ctypes.c_float),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        x.size,
    )
    return out


def f16_to_f32(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float16)
    if _lib is None:
        return x.astype(np.float32)
    out = np.empty(x.shape, dtype=np.float32)
    _lib.f16_to_f32(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        _ptr(out, ctypes.c_float),
        x.size,
    )
    return out


def quantize_uint8(x: np.ndarray) -> Tuple[np.ndarray, float, float]:
    """Fused min/max + affine encode. Returns (q, lo, scale)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    if _lib is None:
        lo = float(x.min()) if x.size else 0.0
        hi = float(x.max()) if x.size else 0.0
        scale = (hi - lo) / 255.0 or 1.0
        q = np.clip(np.rint((x - lo) / scale), 0, 255).astype(np.uint8)
        return q, lo, scale
    q = np.empty(x.shape, dtype=np.uint8)
    lo = ctypes.c_float()
    scale = ctypes.c_float()
    _lib.quantize_uint8(
        _ptr(x, ctypes.c_float),
        _ptr(q, ctypes.c_uint8),
        x.size,
        ctypes.byref(lo),
        ctypes.byref(scale),
    )
    return q, float(lo.value), float(scale.value)


def dequantize_uint8(q: np.ndarray, lo: float, scale: float) -> np.ndarray:
    q = np.ascontiguousarray(q, dtype=np.uint8)
    if _lib is None:
        return q.astype(np.float32) * scale + lo
    out = np.empty(q.shape, dtype=np.float32)
    _lib.dequantize_uint8(
        _ptr(q, ctypes.c_uint8), _ptr(out, ctypes.c_float), q.size, lo, scale
    )
    return out


def axpy(acc: np.ndarray, x: np.ndarray, w: float) -> np.ndarray:
    """acc += w * x in place (acc must be contiguous fp32). Returns acc."""
    assert acc.dtype == np.float32 and acc.flags["C_CONTIGUOUS"]
    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.size != acc.size:
        # peer-controlled shapes must fail loudly, not read out of bounds
        raise ValueError(f"axpy size mismatch: acc {acc.size} vs x {x.size}")
    if _lib is None:
        acc += np.float32(w) * x.reshape(acc.shape)
        return acc
    _lib.axpy_f32(_ptr(acc, ctypes.c_float), _ptr(x, ctypes.c_float), w, acc.size)
    return acc


def scale(x: np.ndarray, s: float) -> np.ndarray:
    """x *= s in place (contiguous fp32). Returns x."""
    assert x.dtype == np.float32 and x.flags["C_CONTIGUOUS"]
    if _lib is None:
        x *= np.float32(s)
        return x
    _lib.scale_f32(_ptr(x, ctypes.c_float), s, x.size)
    return x


_CRC32C_TABLE: Optional[list] = None


def _crc32c_py(data: bytes) -> int:
    # Vectorized pure-python/numpy fallback; same polynomial as the native
    # path so mixed fleets (with/without a toolchain) agree on checksums.
    # Strategy: process in fixed-size blocks — within a block, fold each
    # byte's table value shifted by its position. A simple per-byte loop in
    # Python costs ~1 µs/byte (seconds per multi-MB chunk), so instead use
    # the crc32 "combine by zero-extension" trick via 8 per-position tables.
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        base = [0] * 256
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if (c & 1) else (c >> 1)
            base[i] = c
        # slice-by-8 tables: table[k][b] = crc of byte b followed by k zeros
        tables = [base]
        for _ in range(7):
            prev = tables[-1]
            tables.append([base[v & 0xFF] ^ (v >> 8) for v in prev])
        _CRC32C_TABLE = [np.array(t, dtype=np.uint32) for t in tables]
    t = _CRC32C_TABLE
    crc = 0xFFFFFFFF
    buf = np.frombuffer(data, dtype=np.uint8)
    n8 = (len(buf) // 8) * 8
    if n8:
        blocks = buf[:n8].reshape(-1, 8)
        # crc feedback only touches the first 4 bytes of each 8-byte block;
        # the last 4 bytes' contribution is crc-independent — vectorize it
        f4 = (
            t[3][blocks[:, 4]] ^ t[2][blocks[:, 5]]
            ^ t[1][blocks[:, 6]] ^ t[0][blocks[:, 7]]
        ).tolist()
        t7, t6, t5, t4 = t[7].tolist(), t[6].tolist(), t[5].tolist(), t[4].tolist()
        b0, b1, b2, b3 = (blocks[:, k].tolist() for k in range(4))
        for i in range(len(f4)):
            crc = (
                t7[(crc ^ b0[i]) & 0xFF]
                ^ t6[((crc >> 8) ^ b1[i]) & 0xFF]
                ^ t5[((crc >> 16) ^ b2[i]) & 0xFF]
                ^ t4[((crc >> 24) ^ b3[i]) & 0xFF]
                ^ f4[i]
            )
    base = t[0].tolist()
    for b in buf[n8:].tolist():
        crc = base[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    """CRC32C (Castagnoli) of a byte string — chunk-frame integrity check."""
    if _lib is None:
        return _crc32c_py(data)
    buf = np.frombuffer(data, dtype=np.uint8)
    if buf.size == 0:
        buf = np.zeros(1, dtype=np.uint8)
        return int(_lib.crc32c(_ptr(buf, ctypes.c_uint8), 0))
    return int(_lib.crc32c(_ptr(buf, ctypes.c_uint8), buf.size))
