"""Tensor wire (de)serialization with lossy compression.

Capability parity with the reference's ``CompressionType.Value("FLOAT16")``
wire format for averaging rounds (albert/arguments.py:75-77) plus a
uint8 per-chunk affine quantizer for lower-bandwidth links. The framing is
msgpack (self-describing, protobuf-free — see SURVEY.md §2.7).

All encoders take/return numpy arrays: device arrays are fetched to host by
the caller at the jit↔asyncio seam (SURVEY.md §7 hard-part b).
"""
from __future__ import annotations

import enum
from typing import Any, Dict

import msgpack
import numpy as np

from dedloc_tpu_torch import native


class CompressionType(enum.Enum):
    NONE = "none"
    FLOAT16 = "float16"
    UINT8 = "uint8"  # per-tensor affine quantization with fp32 scale/zero-point


def serialize_array(
    x: np.ndarray,
    compression: CompressionType = CompressionType.NONE,
    checksum: bool = False,
) -> bytes:
    x = np.asarray(x)
    header: Dict[str, Any] = {
        "shape": list(x.shape),
        "dtype": x.dtype.str,
        "compression": compression.value,
    }
    if compression is CompressionType.NONE:
        payload = np.ascontiguousarray(x).tobytes()
    elif compression is CompressionType.FLOAT16:
        if x.dtype == np.float16:
            payload = np.ascontiguousarray(x).tobytes()
        else:
            payload = native.f32_to_f16(x.astype(np.float32, copy=False)).tobytes()
    elif compression is CompressionType.UINT8:
        q, lo, scale = native.quantize_uint8(x.astype(np.float32, copy=False))
        header["lo"], header["scale"] = lo, scale
        payload = q.tobytes()
    else:  # pragma: no cover
        raise ValueError(f"unknown compression {compression}")
    if checksum:
        header["crc"] = native.crc32c(payload)
    return msgpack.packb({"h": header, "p": payload}, use_bin_type=True)


def deserialize_array(data: bytes) -> np.ndarray:
    obj = msgpack.unpackb(data, raw=False)
    header, payload = obj["h"], obj["p"]
    if "crc" in header and native.crc32c(payload) != header["crc"]:
        raise ValueError("wire chunk checksum mismatch (corrupt frame)")
    shape = tuple(header["shape"])
    dtype = np.dtype(header["dtype"])
    compression = CompressionType(header["compression"])
    if compression is CompressionType.NONE:
        return np.frombuffer(payload, dtype=dtype).reshape(shape).copy()
    if compression is CompressionType.FLOAT16:
        h = np.frombuffer(payload, dtype=np.float16).reshape(shape)
        if dtype == np.float16:
            return h.copy()
        return native.f16_to_f32(h).astype(dtype, copy=False)
    if compression is CompressionType.UINT8:
        q = np.frombuffer(payload, dtype=np.uint8).reshape(shape)
        x = native.dequantize_uint8(q, header["lo"], header["scale"])
        return x.astype(dtype, copy=False)
    raise ValueError(f"unknown compression {compression}")  # pragma: no cover


def wire_roundtrip(
    x: np.ndarray, compression: CompressionType
) -> np.ndarray:
    """What the receiving side of the wire reconstructs for ``x`` — encode
    then decode, skipping the msgpack framing. Used by the optimizer's
    error-feedback residual to measure this round's quantization error
    without touching the network."""
    x = np.asarray(x, dtype=np.float32)
    if compression is CompressionType.NONE:
        return x
    if compression is CompressionType.FLOAT16:
        return native.f16_to_f32(native.f32_to_f16(x))
    if compression is CompressionType.UINT8:
        q, lo, scale = native.quantize_uint8(x)
        return native.dequantize_uint8(q, lo, scale).reshape(x.shape)
    raise ValueError(f"unknown compression {compression}")  # pragma: no cover


def serialize_tree(
    tree: Dict[str, np.ndarray],
    compression: CompressionType = CompressionType.NONE,
) -> bytes:
    """Serialize a flat {name: array} mapping (e.g. flattened params/grads)."""
    return msgpack.packb(
        {k: serialize_array(v, compression) for k, v in tree.items()},
        use_bin_type=True,
    )


def deserialize_tree(data: bytes) -> Dict[str, np.ndarray]:
    obj = msgpack.unpackb(data, raw=False)
    return {k: deserialize_array(v) for k, v in obj.items()}


def pack_obj(obj: Any) -> bytes:
    """msgpack helper for small control-plane objects (DHT values, metadata)."""
    return msgpack.packb(obj, use_bin_type=True)


def unpack_obj(data: bytes) -> Any:
    return msgpack.unpackb(data, raw=False)
