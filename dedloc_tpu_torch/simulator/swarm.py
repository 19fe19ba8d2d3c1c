"""Spawn N full peers — DHT node, matchmaker, optional checkpoint-catalog
announcer — in ONE process on the simulated transport.

Each peer gets:

- its own simulated host (``peer-0042``) and ``SimTransport`` bound to it,
  so the network can charge its serialized uplink and stamp peernames;
- a deterministic node id derived from (swarm seed, peer index) — two
  same-seed runs build the identical Kademlia topology;
- a component-scoped ``Telemetry`` registry (the PR 2 machinery for
  in-process multi-peer attribution), held in memory and dumped to
  per-peer JSONL by ``dump_event_logs`` so ``runlog_summary
  --health/--trace/--topology`` work on simulator output unchanged.

Everything the peer runs — ``DHTNode`` iterative lookups, ``Matchmaking``
leader election, ``checkpointing.fetcher`` restores — is the PRODUCTION
code, untouched, running above the transport seam.
"""
from __future__ import annotations

import hashlib
import json
import os
from bisect import bisect_left
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from dedloc_tpu_torch.averaging.matchmaking import Matchmaking
from dedloc_tpu_torch.checkpointing.catalog import (
    CheckpointAnnouncement,
    catalog_key,
)
from dedloc_tpu_torch.checkpointing.manifest import CheckpointManifest, shard_bytes
from dedloc_tpu_torch.core.serialization import CompressionType, serialize_array
from dedloc_tpu_torch.core.timeutils import get_dht_time
from dedloc_tpu_torch.dht.node import DHTNode
from dedloc_tpu_torch.dht.routing import DHTID, ID_BITS, NodeInfo
from dedloc_tpu_torch.simulator.network import SimNetwork
from dedloc_tpu_torch.telemetry.registry import Telemetry
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _synthetic_checkpoint(
    step: int, total_size: int, shard_size: int, variant: int = 0
):
    """A tiny deterministic (manifest, flat) pair for catalog scenarios:
    real manifests, real digests, real shard bytes — no model needed.
    ``variant`` perturbs the content, producing a DIVERGENT manifest at the
    same step (the catalog's majority-digest selection must reject it)."""
    flat = (
        np.arange(total_size, dtype=np.float32) + np.float32(variant * 1000)
    )
    digests = []
    for start in range(0, total_size, shard_size):
        chunk = np.ascontiguousarray(flat[start : start + shard_size])
        digests.append(hashlib.sha256(chunk.tobytes()).digest())
    manifest = CheckpointManifest(
        step=int(step),
        shard_size=int(shard_size),
        total_size=int(total_size),
        spec=(("sim_state", (total_size,), "<f4"),),
        shard_digests=tuple(digests),
        metadata={"sim": True, "variant": int(variant)},
    )
    return manifest, flat


class SimPeer:
    """One simulated peer. Built by ``SimSwarm.spawn`` — use the swarm."""

    # in-memory event bound per simulated peer: the scenario's telemetry is
    # read from MEMORY after the run (no per-peer JSONL sink while 1,000
    # peers share one process), so a busy leader must not evict its early
    # rounds before the dump
    MAX_EVENTS = 32768

    def __init__(self, index: int, label: str, host: str):
        self.index = index
        self.label = label
        self.host = host
        # telemetry is LAZY: a shell peer (spawn_shells) that never comes
        # online must cost ~nothing, and a 10k-peer diurnal swarm keeps
        # most of its roster offline at any instant. The registry is
        # created on first touch — which for a full peer is node
        # hydration, i.e. the moment it can first emit an event.
        self._telemetry: Optional[Telemetry] = None
        self.node: Optional[DHTNode] = None
        self.matchmaking: Optional[Matchmaking] = None
        self.alive = False
        # catalog-provider state (when announcing): (manifest, flat)
        self._checkpoint = None

    @property
    def telemetry(self) -> Telemetry:
        t = self._telemetry
        if t is None:
            # link_top_k raised to the LinkTable's own bound: the 8-link
            # cap protects the signed metrics-bus SNAPSHOT, but a simulated
            # peer dumps to JSONL post-run, and a twin fitted from that
            # dump needs every link's RTT, not just the 8 busiest.
            # clock: the VIRTUAL clock, not the fake-clock-aware monotonic
            # — span durations then measure only MODELED time, not the
            # real Python seconds the host happened to spend executing
            # the scenario. That noise was ±5-15% of a sub-second round
            # wall and varied run to run, which both blurred the
            # determinism story and put a floor under digital-twin
            # fidelity. (Outside the engine get_dht_time is the wall
            # clock — the interactive-debug case keeps real timings.)
            t = self._telemetry = Telemetry(
                peer=self.label, max_events=self.MAX_EVENTS, link_top_k=64,
                clock=get_dht_time,
            )
        return t

    @property
    def endpoint(self):
        return self.node.endpoint if self.node is not None else None

    # ------------------------------------------------------------ averaging

    def attach_matchmaking(self, prefix: str, bandwidth: float = 100.0,
                           target_group_size: int = 16,
                           averaging_expiration: float = 5.0) -> Matchmaking:
        """Attach the production matchmaker on the peer's existing RPC
        server/client (the averager's group-formation surface — the part of
        averaging that has to scale with the swarm)."""
        self.matchmaking = Matchmaking(
            node=self.node,
            client=self.node.client,
            server=self.node.server,
            prefix=prefix,
            peer_id=self.node.node_id.to_bytes(),
            endpoint=self.endpoint,
            bandwidth=bandwidth,
            target_group_size=target_group_size,
            averaging_expiration=averaging_expiration,
            telemetry_registry=self.telemetry,
        )
        return self.matchmaking

    # ---------------------------------------------------------- checkpoints

    def serve_checkpoint(self, step: int, total_size: int = 4096,
                         shard_size: int = 1024, variant: int = 0) -> bytes:
        """Become a checkpoint provider: serve ``ckpt.manifest`` /
        ``ckpt.shard`` (the averager's wire contract, byte-compatible with
        ``checkpointing/fetcher.py``) for a synthetic checkpoint. Returns
        the manifest digest for the announcement."""
        manifest, flat = _synthetic_checkpoint(
            step, total_size, shard_size, variant
        )
        self._checkpoint = (manifest, flat)

        async def _manifest(_peer, _args):
            return {"manifest": manifest.to_bytes()}

        async def _shard(_peer, args):
            index = int(args["index"])
            raw = shard_bytes(flat, manifest, index)
            return {
                "index": index,
                "data": serialize_array(
                    np.frombuffer(raw, dtype=np.float32),
                    CompressionType.NONE,
                ),
            }

        self.node.server.register("ckpt.manifest", _manifest)
        self.node.server.register("ckpt.shard", _shard)
        return manifest.digest()

    async def announce_checkpoint(self, prefix: str,
                                  expiration: float = 120.0) -> bool:
        """Publish this provider's catalog record (schema-checked by any
        validating node, same as production announcements)."""
        manifest, _flat = self._checkpoint
        ann = CheckpointAnnouncement(
            step=manifest.step,
            manifest_digest=manifest.digest(),
            num_shards=manifest.num_shards,
            endpoint=list(self.endpoint),
            shards=None,
        )
        return await self.node.store(
            catalog_key(prefix).encode(),
            ann.model_dump(),
            get_dht_time() + expiration,
            subkey=self.label.encode(),
        )


class SimSwarm:
    """A population of SimPeers over one SimNetwork. All coroutines must run
    inside the simulator engine (or any asyncio loop — then in real time).

    ``bucket_size``/``num_replicas``/``parallel_rpc`` default smaller than
    production: a 1,000-node scenario's wall cost is dominated by lookup
    fan-out, and the sizing report measures how these knobs trade off.
    """

    def __init__(
        self,
        network: SimNetwork,
        seed: int = 0,
        bucket_size: int = 8,
        num_replicas: int = 5,
        parallel_rpc: int = 3,
        request_timeout: float = 5.0,
        record_validators=(),
        warm_spawn: bool = False,
    ):
        self.network = network
        self.seed = int(seed)
        self.bucket_size = bucket_size
        self.num_replicas = num_replicas
        self.parallel_rpc = parallel_rpc
        self.request_timeout = request_timeout
        self.record_validators = record_validators
        # warm_spawn: hydrate new peers by INJECTING routing-table contacts
        # from the swarm's known deterministic topology instead of paying
        # per-peer bootstrap RPCs (ping fanout + self-lookup). The injected
        # table approximates a CONVERGED Kademlia network — k sorted-order
        # neighbors (the deep buckets) plus one contact per XOR-distance
        # level (the shallow ones) — which is what bootstrap-plus-
        # maintenance converges to anyway. Scenario campaigns opt in; unit
        # tests keep the eager RPC path so the bootstrap protocol itself
        # stays covered.
        self.warm_spawn = bool(warm_spawn)
        self.peers: List[SimPeer] = []
        # peers that are alive AND listening, in spawn order — maintained
        # incrementally so bootstrap-seed selection is O(fanout), not a
        # rescan of the whole roster per joining peer (O(n^2) at 1k peers)
        self._live_listening: List[SimPeer] = []

    # -------------------------------------------------------------- spawn

    def _node_id(self, index: int) -> DHTID:
        # deterministic ids: same seed => same Kademlia topology
        return DHTID.of_key(f"sim-swarm-{self.seed}-peer-{index}")

    async def spawn(
        self,
        n: int,
        bootstrap_fanout: int = 2,
        client_mode: bool = False,
        maintenance_interval: float = 0.0,
        warm: Optional[bool] = None,
    ) -> List[SimPeer]:
        """Create ``n`` peers. On the eager path each bootstraps off up to
        ``bootstrap_fanout`` already-live peers (deterministically chosen)
        with real ping + self-lookup RPCs; on the warm path (``warm=True``
        or the swarm's ``warm_spawn`` default) routing tables are injected
        directly from the known topology and no bootstrap traffic happens.
        Background maintenance defaults OFF — scenarios drive
        ``run_maintenance`` explicitly so every run replays identically."""
        warm = self.warm_spawn if warm is None else bool(warm)
        created: List[SimPeer] = []
        for i in range(n):
            index = len(self.peers)
            label = f"peer-{index:04d}"
            peer = SimPeer(index, label, host=label)
            seeds = () if warm else self._bootstrap_endpoints(
                index, bootstrap_fanout
            )
            await self._create_node(
                peer, seeds, client_mode, maintenance_interval
            )
            self.peers.append(peer)
            created.append(peer)
        if warm:
            # fill AFTER the whole batch is listening so the batch is
            # mutually visible (like a settled network), not a join chain
            self._warm_fill(created)
        return created

    async def _create_node(
        self, peer: SimPeer, seeds, client_mode: bool,
        maintenance_interval: float,
    ) -> None:
        peer.node = await DHTNode.create(
            listen_host=peer.host,
            initial_peers=seeds,
            node_id=self._node_id(peer.index),
            bucket_size=self.bucket_size,
            num_replicas=self.num_replicas,
            parallel_rpc=self.parallel_rpc,
            request_timeout=self.request_timeout,
            record_validators=[v() if callable(v) else v
                               for v in self.record_validators],
            client_mode=client_mode,
            advertised_host=peer.host,
            maintenance_interval=maintenance_interval,
            transport=self.network.transport(peer.host),
            telemetry_registry=peer.telemetry,
        )
        peer.alive = True
        if peer.endpoint is not None:
            self._live_listening.append(peer)

    # ------------------------------------------------------ lazy hydration

    def spawn_shells(self, n: int) -> List[SimPeer]:
        """Reserve ``n`` roster slots as cheap OFFLINE shells: deterministic
        index/label/host, no DHT node, no telemetry, no sockets. A shell
        costs a few object headers; ``hydrate`` brings one online when it
        is first touched. This is how the 10k-peer diurnal scenario affords
        a planet-size roster of which only a time-of-day wave is live."""
        created: List[SimPeer] = []
        for _ in range(n):
            index = len(self.peers)
            label = f"peer-{index:04d}"
            peer = SimPeer(index, label, host=label)
            self.peers.append(peer)
            created.append(peer)
        return created

    async def hydrate(
        self,
        peer: SimPeer,
        maintenance_interval: float = 0.0,
        warm: Optional[bool] = None,
    ) -> SimPeer:
        """Bring a shell — or a previously killed peer rejoining under the
        same identity — online. Idempotent for live peers. The node id is
        the peer's deterministic identity, so a rejoin reclaims its old
        place in the keyspace (its stored records died with it; its id did
        not)."""
        await self.hydrate_batch([peer], maintenance_interval, warm)
        return peer

    async def hydrate_batch(
        self,
        peers: Sequence[SimPeer],
        maintenance_interval: float = 0.0,
        warm: Optional[bool] = None,
    ) -> List[SimPeer]:
        """Hydrate a whole wave at once: the warm fill then sorts the live
        roster ONCE for the batch instead of once per peer — the diurnal
        scenario brings thousands online per virtual hour through this."""
        warm = self.warm_spawn if warm is None else bool(warm)
        fresh: List[SimPeer] = []
        for peer in peers:
            if peer.alive and peer.node is not None:
                continue
            seeds = () if warm else self._bootstrap_endpoints(peer.index, 2)
            await self._create_node(
                peer, seeds, client_mode=False,
                maintenance_interval=maintenance_interval,
            )
            fresh.append(peer)
        if warm and fresh:
            self._warm_fill(fresh)
        return fresh

    def _warm_fill(self, created: Sequence[SimPeer]) -> None:
        """Inject each created peer's routing table directly instead of
        bootstrapping over RPC. Contacts chosen to match what a CONVERGED
        table looks like: one peer per populated XOR-distance level (the
        shallow buckets — each halves the remaining lookup distance) plus
        ``bucket_size`` sorted-order neighbors on each side (adjacent ids
        share the longest prefixes, i.e. they are the deep buckets).
        Everything is derived from (seed, peer index), so two same-seed
        runs inject identical tables. Existing peers do NOT learn the
        newcomers here — exactly like a real join, they discover them when
        the newcomers first send traffic (``_register_sender``)."""
        roster = sorted(
            (int(p.node.node_id), p) for p in self._live_listening
        )
        ids = [node_id for node_id, _ in roster]
        if len(ids) <= 1:
            return
        k = self.bucket_size
        for peer in created:
            table = peer.node.routing_table
            own = int(peer.node.node_id)
            pos = bisect_left(ids, own)
            h = int.from_bytes(
                hashlib.sha256(
                    f"{self.seed}:warm:{peer.index}".encode()
                ).digest()[:8],
                "big",
            )
            # far-to-near: one contact from each non-empty sibling subtree
            # along our id's prefix path. The sibling subtree at depth L is
            # a CONTIGUOUS range of the sorted id list, so each level is
            # two bisects; levels go empty for good once subtrees shrink
            # below the roster's resolution, so bail after a run of them.
            empty_streak = 0
            for level in range(ID_BITS):
                shift = ID_BITS - 1 - level
                lo = (own ^ (1 << shift)) >> shift << shift
                i0 = bisect_left(ids, lo)
                i1 = bisect_left(ids, lo + (1 << shift))
                if i1 <= i0:
                    empty_streak += 1
                    if empty_streak >= 8:
                        break
                    continue
                empty_streak = 0
                _nid, contact = roster[i0 + (h + level * 7919) % (i1 - i0)]
                if contact is not peer:
                    table.add_or_update_node(
                        NodeInfo(contact.node.node_id, contact.endpoint)
                    )
            for j in range(max(0, pos - k), min(len(ids), pos + k + 1)):
                _nid, contact = roster[j]
                if contact is not peer:
                    table.add_or_update_node(
                        NodeInfo(contact.node.node_id, contact.endpoint)
                    )

    def _bootstrap_endpoints(self, index: int, fanout: int) -> List:
        alive = self._live_listening
        if not alive or fanout <= 0:
            return []
        # deterministic spread WITHOUT consuming shared RNG state: stride
        # through the live set by a hash of the joiner's index
        picks = []
        h = int.from_bytes(
            hashlib.sha256(f"{self.seed}:{index}".encode()).digest()[:8],
            "big",
        )
        for k in range(min(fanout, len(alive))):
            picks.append(alive[(h + k * 7919) % len(alive)].endpoint)
        return list(dict.fromkeys(picks))

    # -------------------------------------------------------------- churn

    async def kill(self, peer: SimPeer) -> None:
        """Process-death: sockets reset, listeners vanish, nothing graceful
        (the FaultSchedule ``drop`` contract, swarm-scale)."""
        if not peer.alive:
            return
        peer.alive = False
        try:
            self._live_listening.remove(peer)
        except ValueError:
            pass  # client-mode peer — was never listening
        self.network.kill_host(peer.host)
        if peer.node is not None:
            await peer.node.shutdown()

    def alive_peers(self) -> List[SimPeer]:
        return [p for p in self.peers if p.alive]

    async def shutdown(self) -> None:
        for peer in self.alive_peers():
            peer.alive = False
            self.network.kill_host(peer.host)
            await peer.node.shutdown()
        self._live_listening.clear()

    # ---------------------------------------------------------- telemetry

    def dump_event_logs(self, out_dir: str) -> List[str]:
        """Write each peer's in-memory event trace to
        ``<out_dir>/<label>.jsonl`` — the exact per-peer JSONL schema the
        observability tools consume (``runlog_summary --health/--trace/
        --topology``). Sequential open/write/close: a 1,000-peer swarm
        must not hold 1,000 descriptors."""
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for peer in self.peers:
            if peer._telemetry is None:
                continue  # never hydrated — nothing was ever recorded
            links = peer.telemetry._links
            if links is not None:
                # the link.stats flush production peers do on snapshot /
                # close — without it ``--topology`` has nothing to read
                links.emit_events(peer.telemetry)
                peer.telemetry._links = None  # flush once, even if re-dumped
            if not peer.telemetry.events:
                continue
            if len(peer.telemetry.events) == peer.telemetry.events.maxlen:
                # full deque = almost certainly evicted its head: the
                # dumped log is a TAIL, and --trace on early rounds will
                # report orphans — say so instead of degrading silently
                logger.warning(
                    f"{peer.label}: event trace hit its in-memory bound "
                    f"({peer.telemetry.events.maxlen}); dumped log is "
                    "truncated at the front (raise SimPeer.MAX_EVENTS)"
                )
            path = os.path.join(out_dir, f"{peer.label}.jsonl")
            with open(path, "w", encoding="utf-8") as f:
                for record in peer.telemetry.events:
                    f.write(json.dumps(record) + "\n")
            paths.append(path)
        return paths

    def event_sequence(
        self, drop_keys: Sequence[str] = ("t", "dur_s", "span", "parent"),
    ) -> List[Dict[str, Any]]:
        """The swarm's telemetry events, per peer in spawn order, with the
        wall-dependent / randomly-identified fields stripped — the
        determinism fingerprint two same-seed runs must agree on."""
        out: List[Dict[str, Any]] = []
        for peer in self.peers:
            if peer._telemetry is None:
                continue  # unhydrated shell — no events by construction
            for record in peer.telemetry.events:
                out.append(
                    {k: v for k, v in record.items() if k not in drop_keys}
                )
        return out

    def counters_total(self, name: str) -> float:
        return sum(
            p._telemetry.counters[name].value
            for p in self.peers
            if p._telemetry is not None and name in p._telemetry.counters
        )
