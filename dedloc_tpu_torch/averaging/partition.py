"""Tensor flattening and bandwidth-weighted partitioning for group all-reduce.

Capability parity with hivemind's load-balanced butterfly partitioning
(``throughput=bandwidth`` at albert/run_trainer.py:258, SURVEY.md §2.6):
peers with more bandwidth reduce proportionally larger chunks, so the round
finishes in min-max-optimal time. Client-mode/zero-bandwidth peers get zero-
size parts — they contribute data but never host a reduction.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class TreeLayout:
    """Precomputed flat layout for a stable {name: array} schema.

    The averaging hot path flattens the identical tree schema every round;
    re-deriving the spec and allocating ``astype`` + ``concatenate``
    intermediates per round costs one full extra copy of the gradient
    vector. A TreeLayout is built once from the first round's tree and then
    ``flatten_into`` writes each tensor straight into ONE preallocated flat
    buffer (the dtype cast happens during the strided copy, no temporary).
    """

    __slots__ = ("spec", "offsets", "total_size", "_buffer")

    def __init__(self, spec: Sequence[Tuple[str, Tuple[int, ...], np.dtype]]):
        self.spec = list(spec)
        self.offsets: List[int] = []
        offset = 0
        for _name, shape, _dtype in self.spec:
            self.offsets.append(offset)
            offset += int(np.prod(shape)) if shape else 1
        self.total_size = offset
        self._buffer: Optional[np.ndarray] = None

    @classmethod
    def for_tree(cls, tree: Dict[str, np.ndarray]) -> "TreeLayout":
        spec = []
        for name in sorted(tree):
            arr = np.asarray(tree[name])
            spec.append((name, arr.shape, arr.dtype))
        return cls(spec)

    def matches(self, tree: Dict[str, np.ndarray]) -> bool:
        if len(tree) != len(self.spec):
            return False
        for name, shape, dtype in self.spec:
            arr = tree.get(name)
            if arr is None:
                return False
            arr = np.asarray(arr)
            if arr.shape != shape or arr.dtype != dtype:
                return False
        return True

    def flatten_into(
        self, tree: Dict[str, np.ndarray], out: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """Write ``tree`` into a flat fp32 vector. ``out=None`` reuses (and
        lazily allocates) the layout's own buffer — callers that hold the
        layout across rounds get a zero-allocation flatten. The returned
        vector is only valid until the next ``flatten_into`` on the same
        buffer."""
        if out is None:
            if self._buffer is None:
                self._buffer = np.empty((self.total_size,), np.float32)
            out = self._buffer
        assert out.size == self.total_size, "buffer does not match layout"
        for (name, shape, _dtype), offset in zip(self.spec, self.offsets):
            arr = np.asarray(tree[name])
            size = int(np.prod(shape)) if shape else 1
            # the cast (if any) happens inside the copy — no astype temp
            np.copyto(
                out[offset : offset + size],
                arr.reshape(-1),
                casting="unsafe",
            )
        return out

    def unflatten(self, flat: np.ndarray) -> Dict[str, np.ndarray]:
        return unflatten_tree(flat, self.spec)

    def tree_view(self, flat: np.ndarray) -> "FlatTree":
        """A ``FlatTree`` over ``flat``: the named-dict view of the buffer
        that ALSO carries the buffer itself, so flat-aware consumers (the
        averager's wire path, the fused flat apply) skip the re-flatten."""
        assert flat.size == self.total_size, "buffer does not match layout"
        return FlatTree(self.unflatten(flat), flat=flat, spec=self.spec)


class FlatTree(dict):
    """A {name: array} gradient tree whose values are VIEWS of one flat
    fp32 buffer in TreeLayout (sorted-name) order.

    Behaves exactly like the plain dict the averaging stack has always
    consumed — ``schema_fingerprint``, serialization, and stubbed tests
    all see a normal mapping — but carries ``.flat`` (the backing buffer)
    and ``.spec`` so flat-native consumers avoid re-flattening what is
    already flat. The buffer may be reused by its producer (double-buffered
    device fetches): treat it as valid only until the producing pipeline's
    next-but-one fetch, the same lifetime contract as
    ``TreeLayout.flatten_into``.
    """

    def __init__(self, mapping, flat: np.ndarray, spec):
        super().__init__(mapping)
        self.flat = flat
        self.spec = list(spec)


def flatten_tree(tree: Dict[str, np.ndarray]) -> Tuple[np.ndarray, List[Tuple[str, Tuple[int, ...], np.dtype]]]:
    """Flatten {name: array} into one fp32 vector + layout spec (sorted by name
    so every peer produces the identical layout). One-shot convenience over
    ``TreeLayout`` — round-loop callers should hold a TreeLayout instead and
    reuse its buffer."""
    layout = TreeLayout.for_tree(tree)
    return layout.flatten_into(tree, np.empty((layout.total_size,), np.float32)), layout.spec


def unflatten_tree(
    flat: np.ndarray, spec: Sequence[Tuple[str, Tuple[int, ...], np.dtype]]
) -> Dict[str, np.ndarray]:
    """Inverse of ``flatten_tree``. When a tensor's target dtype is already
    the vector's dtype the returned array is a reshaped VIEW of ``flat``
    (the old unconditional ``astype`` copied every fp32 tensor twice per
    round); callers that mutate the result in place must copy first."""
    out = {}
    offset = 0
    for name, shape, dtype in spec:
        size = int(np.prod(shape)) if shape else 1
        chunk = flat[offset : offset + size].reshape(shape)
        out[name] = chunk if chunk.dtype == dtype else chunk.astype(dtype)
        offset += size
    assert offset == flat.size, "layout spec does not match vector length"
    return out


def partition_weighted(
    total_size: int,
    bandwidths: Sequence[float],
    can_host: Optional[Sequence[bool]] = None,
) -> List[Tuple[int, int]]:
    """Split [0, total_size) into len(bandwidths) contiguous spans with sizes
    proportional to bandwidth (largest-remainder rounding; exact cover).

    ``can_host[i] == False`` forces span i empty regardless of bandwidth —
    used for client-mode members that cannot accept inbound connections. The
    all-zero-bandwidth fallback distributes only among hosting-capable
    members for the same reason."""
    n = len(bandwidths)
    assert n > 0
    hostable = (
        np.ones(n, dtype=bool)
        if can_host is None
        else np.asarray(list(can_host), dtype=bool)
    )
    assert hostable.any(), "at least one member must be able to host"
    bw = np.asarray(bandwidths, dtype=np.float64)
    bw = np.where(np.isfinite(bw) & (bw > 0) & hostable, bw, 0.0)
    if bw.sum() <= 0:
        bw = hostable.astype(np.float64)
    ideal = bw / bw.sum() * total_size
    sizes = np.floor(ideal).astype(np.int64)
    remainder = int(total_size - sizes.sum())
    # distribute leftover to the largest fractional parts
    order = np.argsort(-(ideal - sizes))
    for i in range(remainder):
        sizes[order[i % n]] += 1
    spans = []
    offset = 0
    for s in sizes:
        spans.append((offset, offset + int(s)))
        offset += int(s)
    assert offset == total_size
    return spans
