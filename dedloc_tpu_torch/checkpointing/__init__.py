"""Swarm checkpointing: sharded, content-addressed checkpoints with a DHT
catalog and multi-peer restore.

A checkpoint is a signed **manifest** (step, tree layout, per-shard sha256)
plus fixed-size content-addressed **shards** cut from the TreeLayout flat
buffer (``manifest``), persisted locally in a dedup'ing ``ShardStore``
(``store``), announced on the DHT via schema-validated, signature-capable
catalog records (``catalog``), and restored by pulling distinct shards from
distinct providers in parallel with per-shard verification and the standard
retry/backoff ladder (``fetcher``).

Operator view: docs/fleet.md "Restart & bootstrap runbook"; counters in
docs/observability.md.
"""
from dedloc_tpu_torch.checkpointing.catalog import (
    CheckpointAnnouncement,
    catalog_key,
    parse_announcements,
    publish_announcement,
    select_target,
)
from dedloc_tpu_torch.checkpointing.fetcher import (
    RestoreFailed,
    fetch_manifest,
    fetch_shards,
    sharded_restore,
)
from dedloc_tpu_torch.checkpointing.manifest import (
    DEFAULT_SHARD_SIZE,
    CheckpointManifest,
    assemble_tree,
    build_manifest,
    shard_bytes,
    verify_shard,
)
from dedloc_tpu_torch.checkpointing.store import (
    ShardStore,
    load_sharded_checkpoint,
    save_sharded_checkpoint,
)

__all__ = [
    "CheckpointAnnouncement",
    "CheckpointManifest",
    "DEFAULT_SHARD_SIZE",
    "RestoreFailed",
    "ShardStore",
    "assemble_tree",
    "build_manifest",
    "catalog_key",
    "fetch_manifest",
    "fetch_shards",
    "load_sharded_checkpoint",
    "parse_announcements",
    "publish_announcement",
    "save_sharded_checkpoint",
    "select_target",
    "shard_bytes",
    "sharded_restore",
    "verify_shard",
]
