"""Kademlia-style node IDs and k-bucket routing table.

The reference delegates this to hivemind.DHT (SURVEY.md §2.6). Here it is
re-implemented in-tree: 256-bit IDs (sha256), XOR metric, k-buckets with
least-recently-seen eviction preference for live nodes.
"""
from __future__ import annotations

import hashlib
import os
from bisect import bisect_right, insort
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from dedloc_tpu_torch.core import timeutils

ID_BITS = 256


class DHTID(int):
    """256-bit Kademlia identifier with the XOR distance metric."""

    MIN, MAX = 0, 2**ID_BITS - 1

    @classmethod
    def generate(cls, seed: Optional[bytes] = None) -> "DHTID":
        seed = seed if seed is not None else os.urandom(32)
        return cls(int.from_bytes(hashlib.sha256(seed).digest(), "big"))

    @classmethod
    def of_key(cls, key: str | bytes) -> "DHTID":
        if isinstance(key, str):
            key = key.encode()
        return cls(int.from_bytes(hashlib.sha256(key).digest(), "big"))

    def xor_distance(self, other: int) -> int:
        return int(self) ^ int(other)

    def to_bytes(self) -> bytes:  # type: ignore[override]
        return int(self).to_bytes(32, "big")

    # bytes -> DHTID memo: every RPC carries sender/node ids as 32-byte
    # blobs, and a busy simulation decodes the same few thousand identities
    # millions of times. DHTID is an immutable int, so interning is safe.
    _intern: Dict[bytes, "DHTID"] = {}

    @classmethod
    def from_bytes(cls, data: bytes) -> "DHTID":  # type: ignore[override]
        out = cls._intern.get(data)
        if out is None:
            if len(cls._intern) >= 65536:  # bounded: arbitrary wipe is fine
                cls._intern.clear()
            out = cls._intern[data] = cls(int.from_bytes(data, "big"))
        return out


Endpoint = Tuple[str, int]  # (host, port)


@dataclass
class NodeInfo:
    node_id: DHTID
    endpoint: Endpoint
    last_seen: float = field(default_factory=timeutils.monotonic)


class KBucket:
    def __init__(self, lower: int, upper: int, k: int):
        self.lower, self.upper, self.k = lower, upper, k
        self.nodes: Dict[DHTID, NodeInfo] = {}  # insertion-ordered
        self.replacement_cache: Dict[DHTID, NodeInfo] = {}
        # when this bucket's range last saw lookup/refresh activity — the
        # Kademlia bucket-refresh trigger (DHTNode.run_maintenance)
        self.last_refreshed: float = timeutils.monotonic()

    def covers(self, node_id: int) -> bool:
        return self.lower <= node_id < self.upper

    def add_or_update(self, info: NodeInfo) -> bool:
        """Returns False if the bucket is full (candidate goes to cache)."""
        if info.node_id in self.nodes:
            self.nodes.pop(info.node_id)
            self.nodes[info.node_id] = info
            return True
        if len(self.nodes) < self.k:
            self.nodes[info.node_id] = info
            return True
        self.replacement_cache.pop(info.node_id, None)
        self.replacement_cache[info.node_id] = info
        while len(self.replacement_cache) > self.k:  # bounded: drop oldest
            self.replacement_cache.pop(next(iter(self.replacement_cache)))
        return False

    def remove(self, node_id: DHTID) -> None:
        self.nodes.pop(node_id, None)
        if self.replacement_cache:
            rid, rinfo = self.replacement_cache.popitem()
            self.nodes[rid] = rinfo

    def oldest(self) -> Optional[NodeInfo]:
        return next(iter(self.nodes.values()), None)


class RoutingTable:
    def __init__(self, node_id: DHTID, bucket_size: int = 20):
        self.node_id = node_id
        self.bucket_size = bucket_size
        self.buckets: List[KBucket] = [KBucket(0, 2**ID_BITS, bucket_size)]
        # bucket lower bounds, kept sorted in lockstep with ``buckets``:
        # bucket membership is a bisect, not a linear scan (the table is
        # consulted on every RPC send AND receive — at simulator scale the
        # scan was a top-ten profile line)
        self._lowers: List[int] = [0]

    def _bucket_for(self, node_id: int) -> KBucket:
        return self.buckets[bisect_right(self._lowers, node_id) - 1]

    def add_or_update_node(self, info: NodeInfo) -> None:
        if info.node_id == self.node_id:
            return
        bucket = self._bucket_for(info.node_id)
        if bucket.add_or_update(info):
            return
        # split only the bucket containing our own ID (standard Kademlia)
        if bucket.covers(self.node_id):
            self._split(bucket)
            self.add_or_update_node(info)

    def _split(self, bucket: KBucket) -> None:
        mid = (bucket.lower + bucket.upper) // 2
        left = KBucket(bucket.lower, mid, self.bucket_size)
        right = KBucket(mid, bucket.upper, self.bucket_size)
        left.last_refreshed = right.last_refreshed = bucket.last_refreshed
        for info in bucket.nodes.values():
            (left if left.covers(info.node_id) else right).add_or_update(info)
        idx = self.buckets.index(bucket)
        self.buckets[idx : idx + 1] = [left, right]
        insort(self._lowers, mid)

    def random_id_in(self, bucket: KBucket) -> DHTID:
        """A uniform ID inside the bucket's range (bucket-refresh target)."""
        import random

        return DHTID(random.randrange(bucket.lower, bucket.upper))

    def mark_range_refreshed(self, target: int) -> None:
        """Record lookup activity for the bucket covering ``target``."""
        self._bucket_for(target).last_refreshed = timeutils.monotonic()

    def remove_node(self, node_id: DHTID) -> None:
        self._bucket_for(node_id).remove(node_id)

    def nearest_neighbors(
        self, target: int, k: Optional[int] = None
    ) -> List[NodeInfo]:
        k = k or self.bucket_size
        target = int(target)
        # (distance, info) rows sorted WITHOUT a key function: XOR with a
        # fixed target is a bijection, so distances are unique and the sort
        # never compares the (unorderable) NodeInfo second element. At
        # 256-bit int compares this is several times cheaper than a
        # per-element lambda, and this is the hottest DHT code path.
        ranked = [
            (node_id ^ target, info)
            for b in self.buckets
            for node_id, info in b.nodes.items()
        ]
        ranked.sort()
        return [info for _dist, info in ranked[:k]]

    def __len__(self) -> int:
        return sum(len(b.nodes) for b in self.buckets)
