"""Checkpoint manifests: a signed, content-addressed description of one
collaboration state snapshot.

A checkpoint is no longer one opaque ``state.bin``: the state tree is
flattened through the SAME ``TreeLayout`` the averaging wire path uses (one
fp32 vector, name-sorted spec) and cut into fixed-size **shards**. The
manifest records the step, the tree layout, the shard geometry and one
sha256 per shard — so any single shard can be fetched from any peer that
holds it and verified in isolation, and the assembled tree is bit-identical
to the source by construction (fp32 roundtrips exactly through the NONE
wire codec; non-fp32 leaves are checked for exact representability at
build time and refused otherwise).

The manifest itself is small (KBs) and content-addressed by its own sha256
(``digest()``); the DHT catalog record (checkpointing/catalog.py) carries
that digest on the existing signed-record machinery, so a fetcher can pull
the manifest from ANY provider and verify it against the signed digest.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dedloc_tpu_torch.core.serialization import pack_obj, unpack_obj

# NOTE: dedloc_tpu_torch.averaging.partition (TreeLayout) is imported lazily
# inside the functions below — the averager imports this package at module
# scope, and averaging/__init__ imports the averager, so a top-level import
# here would close an import cycle.

DEFAULT_SHARD_SIZE = 1 << 20  # fp32 elements per shard = 4 MiB raw

_MANIFEST_VERSION = 1


@dataclass(frozen=True)
class CheckpointManifest:
    """Immutable description of one sharded checkpoint.

    ``spec`` is the TreeLayout spec with dtypes as strings (msgpack-safe);
    ``shard_digests[i]`` is sha256 over shard i's raw little-endian fp32
    bytes. ``metadata`` is the same small control dict the full-blob state
    path ships ({"step", "local_step", ...}).
    """

    step: int
    shard_size: int  # fp32 elements per shard (last shard may be smaller)
    total_size: int  # fp32 elements overall
    spec: Tuple[Tuple[str, Tuple[int, ...], str], ...]
    shard_digests: Tuple[bytes, ...]
    metadata: Dict[str, Any] = field(default_factory=dict)

    @property
    def num_shards(self) -> int:
        return len(self.shard_digests)

    @property
    def total_bytes(self) -> int:
        return self.total_size * 4

    def shard_span(self, index: int) -> Tuple[int, int]:
        """[start, end) element range of shard ``index`` in the flat vector."""
        if not 0 <= index < self.num_shards:
            raise IndexError(f"shard {index} not in [0, {self.num_shards})")
        start = index * self.shard_size
        return start, min(start + self.shard_size, self.total_size)

    def shard_nbytes(self, index: int) -> int:
        start, end = self.shard_span(index)
        return (end - start) * 4

    def layout_spec(self) -> List[Tuple[str, Tuple[int, ...], np.dtype]]:
        """The spec with real np.dtype objects (unflatten_tree's shape)."""
        return [
            (name, tuple(shape), np.dtype(dtype))
            for name, shape, dtype in self.spec
        ]

    def to_bytes(self) -> bytes:
        return pack_obj(
            {
                "v": _MANIFEST_VERSION,
                "step": int(self.step),
                "shard_size": int(self.shard_size),
                "total_size": int(self.total_size),
                "spec": [
                    [name, list(shape), dtype] for name, shape, dtype in self.spec
                ],
                "digests": list(self.shard_digests),
                "metadata": self.metadata,
            }
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "CheckpointManifest":
        obj = unpack_obj(data)
        if obj.get("v") != _MANIFEST_VERSION:
            raise ValueError(f"unknown manifest version {obj.get('v')!r}")
        manifest = cls(
            step=int(obj["step"]),
            shard_size=int(obj["shard_size"]),
            total_size=int(obj["total_size"]),
            spec=tuple(
                (name, tuple(shape), dtype) for name, shape, dtype in obj["spec"]
            ),
            shard_digests=tuple(obj["digests"]),
            metadata=obj.get("metadata") or {},
        )
        manifest.validate()
        return manifest

    def validate(self) -> None:
        """Structural sanity independent of any shard data — run on every
        manifest received off the wire before trusting its geometry."""
        if self.shard_size <= 0:
            raise ValueError(f"shard_size must be positive: {self.shard_size}")
        if self.total_size < 0:
            raise ValueError(f"negative total_size: {self.total_size}")
        expected = -(-self.total_size // self.shard_size)
        if self.num_shards != expected:
            raise ValueError(
                f"manifest claims {self.num_shards} shards; geometry implies "
                f"{expected}"
            )
        spec_size = sum(
            int(np.prod(shape)) if shape else 1 for _n, shape, _d in self.spec
        )
        if spec_size != self.total_size:
            raise ValueError(
                f"layout spec covers {spec_size} elements, manifest says "
                f"{self.total_size}"
            )
        for d in self.shard_digests:
            if not isinstance(d, (bytes, bytearray)) or len(d) != 32:
                raise ValueError("shard digests must be 32-byte sha256")

    def digest(self) -> bytes:
        """sha256 of the serialized manifest — what the signed DHT catalog
        record carries, and what a fetched manifest is verified against."""
        return hashlib.sha256(self.to_bytes()).digest()


def build_manifest(
    tree: Dict[str, np.ndarray],
    step: int,
    shard_size: int = DEFAULT_SHARD_SIZE,
    metadata: Optional[Dict[str, Any]] = None,
) -> Tuple[CheckpointManifest, np.ndarray]:
    """Flatten ``tree`` (TreeLayout — the averaging path's layout) and cut it
    into content-addressed shards. Returns (manifest, flat) where ``flat``
    is a FRESH fp32 vector the caller owns (checkpoint shards outlive
    averaging rounds, so the averager's reused round buffer is never used).

    Raises ValueError when a non-fp32 leaf does not roundtrip exactly
    through the fp32 flat vector (e.g. int64 counters past 2**24) — such a
    tree must ship over the full-blob path, which preserves dtypes natively.
    """
    from dedloc_tpu_torch.averaging.partition import TreeLayout

    if shard_size <= 0:
        raise ValueError(f"shard_size must be positive, got {shard_size}")
    layout = TreeLayout.for_tree(tree)
    flat = layout.flatten_into(tree, np.empty((layout.total_size,), np.float32))
    for (name, shape, dtype), offset in zip(layout.spec, layout.offsets):
        if dtype == np.float32:
            continue
        size = int(np.prod(shape)) if shape else 1
        restored = flat[offset : offset + size].astype(dtype).reshape(shape)
        if not np.array_equal(restored, np.asarray(tree[name])):
            raise ValueError(
                f"leaf {name!r} ({dtype}) does not roundtrip exactly through "
                "the fp32 flat layout; use the full-blob state path"
            )
    digests = []
    for start in range(0, layout.total_size, shard_size):
        chunk = flat[start : start + shard_size]
        digests.append(hashlib.sha256(np.ascontiguousarray(chunk).tobytes()).digest())
    manifest = CheckpointManifest(
        step=int(step),
        shard_size=int(shard_size),
        total_size=layout.total_size,
        spec=tuple(
            (name, tuple(shape), np.dtype(dtype).str)
            for name, shape, dtype in layout.spec
        ),
        shard_digests=tuple(digests),
        metadata=dict(metadata or {}),
    )
    return manifest, flat


def shard_bytes(flat: np.ndarray, manifest: CheckpointManifest, index: int) -> bytes:
    """Raw little-endian fp32 bytes of shard ``index`` (the content the
    per-shard digest covers)."""
    start, end = manifest.shard_span(index)
    return np.ascontiguousarray(flat[start:end]).tobytes()


def verify_shard(
    manifest: CheckpointManifest, index: int, raw: bytes
) -> np.ndarray:
    """Validate shard ``index``'s raw bytes against the manifest (size AND
    sha256) and return it as an fp32 vector. Raises ValueError on mismatch —
    the fetcher's signal to retry the shard from another provider."""
    if len(raw) != manifest.shard_nbytes(index):
        raise ValueError(
            f"shard {index}: got {len(raw)} bytes, manifest says "
            f"{manifest.shard_nbytes(index)}"
        )
    if hashlib.sha256(raw).digest() != manifest.shard_digests[index]:
        raise ValueError(f"shard {index} failed sha256 verification")
    return np.frombuffer(raw, dtype=np.float32)


def assemble_tree(
    manifest: CheckpointManifest, shards: Dict[int, np.ndarray]
) -> Dict[str, np.ndarray]:
    """Reassemble the state tree from a complete set of verified shards."""
    from dedloc_tpu_torch.averaging.partition import unflatten_tree

    missing = [i for i in range(manifest.num_shards) if i not in shards]
    if missing:
        raise ValueError(f"cannot assemble: missing shards {missing[:8]}")
    flat = np.empty((manifest.total_size,), np.float32)
    for i in range(manifest.num_shards):
        start, end = manifest.shard_span(i)
        flat[start:end] = shards[i]
    return unflatten_tree(flat, manifest.layout_spec())
