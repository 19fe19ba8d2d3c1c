"""Multi-peer checkpoint restore: pull distinct shards from distinct
providers in parallel, verify each against the manifest, retry on the
existing backoff ladder, resume partial downloads from a local ShardStore.

This is the joiner/restart half of the swarm checkpoint subsystem: where the
full-blob path downloads hundreds of MB from ONE provider's uplink, the
sharded path spreads the same bytes across every peer announcing the target
manifest in the DHT catalog — restore bandwidth scales with the provider
count, and any single provider dying or serving a corrupt shard costs one
per-shard retry, not the restore.

Runs entirely on the caller's event loop (the averager invokes it on the
DHT loop with its pooled RPCClient).
"""
from __future__ import annotations

import asyncio
import time
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from dedloc_tpu_torch.checkpointing.catalog import (
    CheckpointAnnouncement,
    select_target,
)
from dedloc_tpu_torch.checkpointing.manifest import (
    CheckpointManifest,
    assemble_tree,
    verify_shard,
)
from dedloc_tpu_torch.checkpointing.store import ShardStore
from dedloc_tpu_torch.core.serialization import deserialize_array
from dedloc_tpu_torch.telemetry import registry as telemetry
from dedloc_tpu_torch.telemetry.links import endpoint_key
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

Endpoint = Tuple[str, int]
# one provider: (endpoint, shard indices it holds; None = all)
Provider = Tuple[Endpoint, Optional[FrozenSet[int]]]


class RestoreFailed(RuntimeError):
    """A sharded restore could not complete (no providers, manifest
    unobtainable, or some shard exhausted its retry ladder). The caller
    falls back to the full-blob path."""


async def fetch_manifest(
    client,
    endpoints: Sequence[Endpoint],
    digest: bytes,
    timeout: float = 30.0,
) -> CheckpointManifest:
    """Pull the manifest from any provider and verify it against the
    catalog's (signed) digest — the manifest can come from ANYONE once the
    digest is pinned."""
    last: Optional[Exception] = None
    for ep in endpoints:
        try:
            reply = await client.call(ep, "ckpt.manifest", {}, timeout=timeout)
            blob = reply["manifest"]
            manifest = CheckpointManifest.from_bytes(blob)
            if manifest.digest() != digest:
                raise ValueError(
                    f"manifest from {ep} does not match the announced digest"
                )
            return manifest
        except Exception as e:  # noqa: BLE001 — next provider
            last = e
            logger.debug(f"manifest fetch from {ep} failed: {e!r}")
    raise RestoreFailed(f"no provider served a valid manifest: {last!r}")


def _candidates_for(
    index: int, providers: Sequence[Provider]
) -> List[Endpoint]:
    """Providers holding shard ``index``, rotated by the index so a full
    restore spreads shards round-robin across the provider set (distinct
    shards land on distinct uplinks instead of all hammering provider 0)."""
    holders = [ep for ep, held in providers if held is None or index in held]
    if not holders:
        return []
    rot = index % len(holders)
    return holders[rot:] + holders[:rot]


async def _fetch_one_shard(
    client,
    manifest: CheckpointManifest,
    index: int,
    providers: Sequence[Provider],
    *,
    retries: int,
    backoff: float,
    timeout: float,
    store: Optional[ShardStore],
    failed_providers: set,
    tele,
    provider_bytes: Optional[Dict[str, int]] = None,
) -> np.ndarray:
    candidates = _candidates_for(index, providers)
    if not candidates:
        raise RestoreFailed(f"no provider announces shard {index}")
    last: Optional[Exception] = None
    for attempt in range(retries + 1):
        if attempt:
            delay = backoff * (2 ** (attempt - 1))
            if tele is not None:
                tele.counter("ckpt.fetch_retries").inc()
            await asyncio.sleep(delay)
        # prefer providers that have not failed yet; when everyone has,
        # retry them all anyway (a transient fault on the only provider
        # must not fail the restore) — same ladder as the blob state sync
        pool = [ep for ep in candidates if ep not in failed_providers]
        pool = pool or candidates
        ep = pool[attempt % len(pool)]
        try:
            # monotonic_clock (not perf_counter): advances with the
            # fake-clock offset, so a simulated transfer's goodput reflects
            # the MODELED link, not host execution noise; production
            # (offset 0) reads identically to a raw monotonic clock
            t0 = telemetry.monotonic_clock()
            reply = await client.call(
                ep, "ckpt.shard", {"index": index}, timeout=timeout
            )
            fetch_s = max(0.0, telemetry.monotonic_clock() - t0)
            raw = np.ascontiguousarray(
                deserialize_array(reply["data"]), dtype=np.float32
            ).tobytes()
            try:
                vec = verify_shard(manifest, index, raw)
            except ValueError as ve:
                if tele is not None:
                    tele.counter("ckpt.verify_failures").inc()
                    tele.event(
                        "ckpt.shard_verify_failure", shard=index, provider=ep,
                        attempt=attempt + 1,
                    )
                # counted as a VERIFY failure above; flag it so the outer
                # handler does not double-count it as a transport failure
                ve._ckpt_verify_counted = True
                raise
            if store is not None:
                # persist as we go: a restore killed mid-flight resumes
                # from here instead of refetching everything
                store.put_shard(manifest.shard_digests[index], raw)
            if tele is not None:
                tele.counter("ckpt.shards_fetched").inc()
                tele.counter("ckpt.shard_bytes_fetched").inc(len(raw))
                # per-provider goodput: what restore provider selection will
                # later prefer fast providers by — and the same observation
                # feeds the per-link estimator (telemetry/links.py), so a
                # provider that is ALSO an averaging partner shares one
                # link record across both subsystems
                tele.histogram("ckpt.provider_goodput").observe(
                    len(raw) / max(fetch_s, 1e-6)
                )
                tele.links().observe_transfer(ep, len(raw), fetch_s)
            if provider_bytes is not None:
                key = endpoint_key(ep)
                provider_bytes[key] = provider_bytes.get(key, 0) + len(raw)
            return vec
        except Exception as e:  # noqa: BLE001 — retry ladder
            failed_providers.add(ep)
            last = e
            # verify failures were counted at the verification site;
            # ckpt.fetch_failures is TRANSPORT failures only (the
            # docs/observability.md contract keeps the two disjoint)
            if tele is not None and not getattr(
                e, "_ckpt_verify_counted", False
            ):
                tele.counter("ckpt.fetch_failures").inc()
                tele.event(
                    "ckpt.shard_fetch_failed", shard=index, provider=ep,
                    attempt=attempt + 1, error=type(e).__name__,
                )
            logger.debug(
                f"shard {index} from {ep} failed "
                f"(attempt {attempt + 1}/{retries + 1}): {e!r}"
            )
    raise RestoreFailed(
        f"shard {index} exhausted {retries + 1} attempts: {last!r}"
    )


async def fetch_shards(
    client,
    manifest: CheckpointManifest,
    providers: Sequence[Provider],
    *,
    parallelism: int = 4,
    retries: int = 2,
    backoff: float = 0.5,
    timeout: float = 30.0,
    store: Optional[ShardStore] = None,
    telemetry_registry=None,
    provider_bytes: Optional[Dict[str, int]] = None,
) -> Dict[int, np.ndarray]:
    """Fetch (and verify) every shard of ``manifest``, resuming from
    ``store`` when given. Raises RestoreFailed if any shard cannot be
    obtained. ``provider_bytes`` (when given) accumulates verified bytes
    per provider endpoint — the restore span's attribution."""
    tele = telemetry.resolve(telemetry_registry)
    shards: Dict[int, np.ndarray] = {}
    needed: List[int] = []
    for i, digest in enumerate(manifest.shard_digests):
        raw = store.get_shard(digest) if store is not None else None
        if raw is not None and len(raw) == manifest.shard_nbytes(i):
            shards[i] = np.frombuffer(raw, dtype=np.float32)
        else:
            needed.append(i)
    if tele is not None and shards:
        # counted even when nothing is left to fetch — a fully-cached
        # restore is the best-case resume, not zero resumed shards
        tele.counter("ckpt.shards_resumed").inc(len(shards))
    sem = asyncio.Semaphore(max(1, parallelism))
    failed_providers: set = set()

    async def one(i: int) -> Tuple[int, np.ndarray]:
        async with sem:
            return i, await _fetch_one_shard(
                client, manifest, i, providers,
                retries=retries, backoff=backoff, timeout=timeout,
                store=store, failed_providers=failed_providers, tele=tele,
                provider_bytes=provider_bytes,
            )

    for i, vec in await asyncio.gather(*(one(i) for i in needed)):
        shards[i] = vec
    return shards


async def sharded_restore(
    client,
    announcements: List[CheckpointAnnouncement],
    *,
    parallelism: int = 4,
    retries: int = 2,
    backoff: float = 0.5,
    timeout: float = 30.0,
    store: Optional[ShardStore] = None,
    max_providers: int = 0,
    telemetry_registry=None,
    stats: Optional[Dict[str, Any]] = None,
) -> Tuple[Dict[str, Any], Dict[str, np.ndarray], CheckpointManifest]:
    """The full restore pipeline: pick the deepest announced (step, digest),
    pull + verify the manifest, fan the shard fetches out across providers,
    assemble. Returns (metadata, tree, manifest); raises RestoreFailed when
    the swarm cannot serve a complete checkpoint (callers fall back to the
    single-provider full-blob path). When ``stats`` is given, the providers
    ACTUALLY used (selected step/digest, after the max_providers cap) are
    recorded there — len(announcements) includes stale/outvoted peers."""
    target = select_target(announcements)
    if target is None:
        raise RestoreFailed("no checkpoint catalog announcements")
    step, digest, anns = target
    if max_providers > 0:
        anns = anns[:max_providers]
    providers: List[Provider] = [
        (tuple(a.endpoint), a.held_indices()) for a in anns
    ]
    if stats is not None:
        stats["providers"] = len(providers)
    manifest = await fetch_manifest(
        client, [ep for ep, _held in providers], digest, timeout=timeout
    )
    provider_bytes: Dict[str, int] = {}
    shards = await fetch_shards(
        client, manifest, providers,
        parallelism=parallelism, retries=retries, backoff=backoff,
        timeout=timeout, store=store, telemetry_registry=telemetry_registry,
        provider_bytes=provider_bytes,
    )
    if stats is not None and provider_bytes:
        # verified bytes actually pulled per provider — the restore span's
        # per-provider attribution (fast/slow providers become visible)
        stats["provider_bytes"] = provider_bytes
    tree = assemble_tree(manifest, shards)
    if store is not None:
        # the resume cache has now served its purpose for this manifest:
        # record the manifest so rotation can key off it, then drop shards
        # only older manifests reference — without this, every restart at a
        # new step grows the cache by a full state's worth of shards forever
        store.put_manifest(manifest)
        store.gc(keep=2)
    logger.info(
        f"sharded restore complete: step {manifest.step}, "
        f"{manifest.num_shards} shards ({manifest.total_bytes / 2**20:.1f} "
        f"MiB) from {len(providers)} provider(s)"
    )
    return manifest.metadata, tree, manifest
