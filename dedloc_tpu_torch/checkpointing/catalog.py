"""The DHT checkpoint catalog: who holds which shards of which checkpoint.

One dictionary record per collaboration at ``{prefix}_checkpoint_catalog``,
one subkey per announcing peer (the same signed-record machinery as the
metrics bus: when the subkey is a peer's RSA owner tag, the record is
signature-bound to that peer; the ``CheckpointAnnouncement`` schema below is
validated at every storing node either way, so a malformed or out-of-range
announcement is rejected at the DHT boundary, not discovered mid-restore).

An announcement says: "at ``endpoint`` I serve shards of the checkpoint at
``step`` whose manifest hashes to ``manifest_digest``; I hold ``shards``
(None = all ``num_shards``)". The multi-peer fetcher groups announcements by
(step, manifest_digest), pulls the manifest from any of them, verifies it
against the digest, and spreads the shard downloads across the providers.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from pydantic import BaseModel, StrictBytes, StrictInt, model_validator

from dedloc_tpu_torch.core.timeutils import get_dht_time
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def catalog_key(prefix: str) -> str:
    return f"{prefix}_checkpoint_catalog"


class CheckpointAnnouncement(BaseModel):
    """Schema for one peer's catalog subkey (validated by the DHT's
    SchemaValidator chain — see collaborative/metrics.py make_validators)."""

    step: StrictInt
    manifest_digest: StrictBytes  # sha256 of the serialized manifest
    num_shards: StrictInt
    endpoint: List  # [host, port] — the peer's averager RPC endpoint
    shards: Optional[List[StrictInt]] = None  # held shard indices; None = all

    @model_validator(mode="after")
    def _check(self) -> "CheckpointAnnouncement":
        if self.step < 0:
            raise ValueError(f"negative step {self.step}")
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {self.num_shards}")
        if len(self.manifest_digest) != 32:
            raise ValueError("manifest_digest must be a 32-byte sha256")
        if (
            len(self.endpoint) != 2
            or not isinstance(self.endpoint[0], str)
            or not isinstance(self.endpoint[1], int)
        ):
            raise ValueError(f"endpoint must be [host, port]: {self.endpoint}")
        if self.shards is not None:
            if not self.shards:
                raise ValueError("shards list must not be empty (use None)")
            if min(self.shards) < 0 or max(self.shards) >= self.num_shards:
                raise ValueError(
                    f"shard indices out of range [0, {self.num_shards})"
                )
        return self

    def held_indices(self) -> Optional[frozenset]:
        """Shard indices this provider holds (None = all of them)."""
        return None if self.shards is None else frozenset(self.shards)


def publish_announcement(
    dht,
    prefix: str,
    subkey: bytes,
    announcement: CheckpointAnnouncement,
    expiration: float = 60.0,
) -> None:
    """Store this peer's catalog record (non-blocking, like the provider
    record it rides next to)."""
    dht.store(
        catalog_key(prefix),
        announcement.model_dump(),
        get_dht_time() + expiration,
        subkey=subkey,
        return_future=True,
    )


def parse_announcements(
    entry_items, own_subkeys: Tuple[bytes, ...] = ()
) -> List[CheckpointAnnouncement]:
    """THE one parsing path for catalog records: skip our own subkeys, drop
    anything that fails the schema (defense in depth — a storing node that
    predates the schema may have accepted garbage). ``entry_items`` is an
    iterable of (subkey, unpacked announcement dict)."""
    out: List[CheckpointAnnouncement] = []
    for sk, value in entry_items:
        if sk in own_subkeys:
            continue
        try:
            out.append(CheckpointAnnouncement.model_validate(value))
        except Exception as e:  # noqa: BLE001 — malformed announcement
            logger.debug(f"dropping malformed catalog record: {e!r}")
            continue
    return out


def select_target(
    announcements: List[CheckpointAnnouncement],
) -> Optional[Tuple[int, bytes, List[CheckpointAnnouncement]]]:
    """Pick the restore target: the deepest advertised step, and among
    digests at that step the one with the MOST providers (a lone peer
    announcing a divergent manifest at the same step must not outvote the
    swarm). Returns (step, manifest_digest, providers) or None."""
    if not announcements:
        return None
    best_step = max(a.step for a in announcements)
    at_step = [a for a in announcements if a.step == best_step]
    by_digest: Dict[bytes, List[CheckpointAnnouncement]] = {}
    for a in at_step:
        by_digest.setdefault(a.manifest_digest, []).append(a)
    digest, providers = max(
        by_digest.items(), key=lambda kv: (len(kv[1]), kv[0])
    )
    return best_step, digest, providers
