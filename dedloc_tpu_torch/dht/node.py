"""Asyncio Kademlia DHT node: iterative routing, replicated records,
validator-gated stores.

In-tree replacement for hivemind.DHT's node (SURVEY.md §2.6). One node = one
asyncio endpoint; N nodes can share one process and event loop, which is how
multi-peer behavior is tested without a cluster (closing the reference's
biggest test gap, SURVEY.md §4).
"""
from __future__ import annotations

import asyncio
from typing import Any, Dict, List, Optional, Sequence, Tuple

from dedloc_tpu_torch.core import timeutils
from dedloc_tpu_torch.core.timeutils import DHTExpiration, ValueWithExpiration, get_dht_time
from dedloc_tpu_torch.dht.protocol import Endpoint, RPCClient, RPCServer
from dedloc_tpu_torch.dht.routing import DHTID, NodeInfo, RoutingTable
from dedloc_tpu_torch.dht.storage import DHTLocalStorage, DictionaryDHTValue
from dedloc_tpu_torch.dht.validation import CompositeValidator, DHTRecord, RecordValidatorBase
from dedloc_tpu_torch.telemetry import registry as telemetry
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _pack_nodes(nodes: Sequence[NodeInfo]) -> List[List[Any]]:
    return [[n.node_id.to_bytes(), n.endpoint[0], n.endpoint[1]] for n in nodes]


def _unpack_nodes(raw: Sequence[Sequence[Any]]) -> List[NodeInfo]:
    # one clock read for the whole batch: the per-NodeInfo default_factory
    # is a visible cost when a lookup-heavy simulation unpacks millions
    now = timeutils.monotonic()
    return [
        NodeInfo(DHTID.from_bytes(r[0]), (r[1], int(r[2])), now) for r in raw
    ]


class DHTNode:
    """A single DHT peer. Use ``await DHTNode.create(...)``."""

    def __init__(self):
        raise RuntimeError("use DHTNode.create(...)")

    @classmethod
    async def create(
        cls,
        listen_host: str = "0.0.0.0",
        listen_port: int = 0,
        initial_peers: Sequence[Endpoint] = (),
        node_id: Optional[DHTID] = None,
        bucket_size: int = 20,
        num_replicas: int = 5,
        parallel_rpc: int = 3,
        request_timeout: float = 5.0,
        record_validators: Sequence[RecordValidatorBase] = (),
        client_mode: bool = False,
        advertised_host: Optional[str] = None,
        maintenance_interval: float = 30.0,  # 0 disables the background loop
        stale_peer_timeout: float = 75.0,
        bucket_refresh_interval: float = 120.0,
        lookup_cache_ttl: float = 15.0,  # nearest-set cache: 0 disables
        replication_interval: float = 600.0,  # Kademlia-style, much slower
        # than eviction/refresh: a full lookup+store fan-out per held record
        # every 30s would be orders of magnitude more traffic than needed
        transport=None,  # dht/transport.py seam: None = real TCP; the
        # simulator passes its in-process network so 1000 nodes share a loop
        telemetry_registry=None,  # per-peer scope for in-process multi-peer
        # runs (telemetry/registry.py); None falls back to the global
        store_admission=None,  # serving/admission.Admission: per-sender
        # token bucket on the store RPC (public-run rate control); None =
        # open (the default — store volume is already bounded by validators)
    ) -> "DHTNode":
        self = object.__new__(cls)
        self.node_id = node_id or DHTID.generate()
        self.store_admission = store_admission
        self.telemetry = telemetry_registry
        self.bucket_size = bucket_size
        self.num_replicas = num_replicas
        self.parallel_rpc = parallel_rpc
        self.request_timeout = request_timeout
        self.client_mode = client_mode
        self.stale_peer_timeout = stale_peer_timeout
        self.bucket_refresh_interval = bucket_refresh_interval
        self.replication_interval = replication_interval
        # None => replicate on the first pass (a 0.0 monotonic sentinel
        # would silently delay it on recently-booted hosts, where
        # monotonic() < replication_interval)
        self._last_replication: Optional[float] = None
        # nearest-set lookup cache (classic Kademlia lookup caching): an
        # iterative lookup's converged result for a target is stable for
        # as long as the keyspace neighborhood is — repeated gets/stores
        # on a hot key (matchmaking leader boards, catalog records) pay
        # the iterative fan-out once per TTL instead of once per call.
        # Entries are dropped early whenever a query against the cached
        # set errors (a holder died — re-converge), so churn degrades to
        # exactly the old behavior instead of serving a stale set.
        self.lookup_cache_ttl = lookup_cache_ttl
        self._nearest_cache: Dict[Tuple[int, int], Tuple[float, List[NodeInfo]]] = {}
        self._sender_args_cache: Optional[Dict[str, Any]] = None
        self.routing_table = RoutingTable(self.node_id, bucket_size)
        self.storage = DHTLocalStorage()
        self.cache = DHTLocalStorage(maxsize=2000)
        self.validator = CompositeValidator(record_validators)
        self.client = RPCClient(
            request_timeout=request_timeout, transport=transport,
            telemetry_registry=telemetry_registry,
        )
        self.server: Optional[RPCServer] = None
        self.port: Optional[int] = None
        self.advertised_host = advertised_host or "127.0.0.1"
        self._maintenance_task: Optional[asyncio.Task] = None
        if not client_mode:
            self.server = RPCServer(listen_host, listen_port,
                                    transport=transport,
                                    telemetry_registry=telemetry_registry)
            for method in ("dht.ping", "dht.find", "dht.store"):
                self.server.register(method, getattr(self, "_rpc_" + method.split(".")[1]))
            await self.server.start()
            self.port = self.server.port
        if initial_peers:
            await self.bootstrap(initial_peers)
        if maintenance_interval > 0:
            self._maintenance_task = asyncio.ensure_future(
                self._maintenance_loop(maintenance_interval)
            )
        return self

    @property
    def endpoint(self) -> Endpoint:
        return (self.advertised_host, self.port or 0)

    # ------------------------------------------------------------------ RPCs

    def _sender_args(self) -> Dict[str, Any]:
        # node_id and port are fixed after create(); one RPC is issued per
        # dict, so build it once (callers copy via ``{**...}`` or hand it
        # straight to msgpack — nobody mutates it)
        cached = self._sender_args_cache
        if cached is None:
            cached = self._sender_args_cache = {
                "sender_id": self.node_id.to_bytes(),
                "sender_port": self.port,  # None in client mode
            }
        return cached

    def _register_sender(self, peer: Endpoint, args: Dict[str, Any]) -> None:
        port = args.get("sender_port")
        sid = args.get("sender_id")
        if port and sid:
            self.routing_table.add_or_update_node(
                NodeInfo(DHTID.from_bytes(sid), (peer[0], int(port)))
            )

    async def _rpc_ping(self, peer: Endpoint, args: Dict[str, Any]) -> Dict[str, Any]:
        self._register_sender(peer, args)
        return {"node_id": self.node_id.to_bytes(), "dht_time": get_dht_time()}

    async def _rpc_find(self, peer: Endpoint, args: Dict[str, Any]) -> Dict[str, Any]:
        """find_node + find_value in one RPC (hivemind-style)."""
        self._register_sender(peer, args)
        target = DHTID.from_bytes(args["target"])
        nearest = _pack_nodes(
            self.routing_table.nearest_neighbors(target, self.bucket_size)
        )
        result: Dict[str, Any] = {"nodes": nearest}
        if args.get("return_value"):
            key = args["key"]
            entry = self.storage.get(key) or self.cache.get(key)
            if entry is not None:
                value, expiration = entry
                if isinstance(value, DictionaryDHTValue):
                    result["dict_value"] = [
                        [sk, v.value, v.expiration_time] for sk, v in value.items()
                    ]
                else:
                    result["value"] = value
                result["expiration"] = expiration
        return result

    _rpc_ping.rpc_inline = True
    _rpc_find.rpc_inline = True

    async def _rpc_store(self, peer: Endpoint, args: Dict[str, Any]) -> Dict[str, Any]:
        self._register_sender(peer, args)
        if self.store_admission is not None:
            # rate admission BEFORE validation: the point is bounding how
            # much validator work one sender can demand. Identity = the
            # claimed sender node id (self-chosen in open swarms, but the
            # bucket table is LRU-bounded so identity churn buys rate, not
            # memory), else the source host.
            sid = args.get("sender_id")
            identity = sid.hex() if isinstance(sid, bytes) else str(peer[0])
            reason = self.store_admission.check(
                identity, cost=float(len(args["records"]))
            )
            if reason is not None:
                tele = telemetry.resolve(self.telemetry)
                if tele is not None:
                    tele.counter("serve.rejected").inc()
                    tele.event(
                        "serve.reject", reason=reason, rpc="dht.store",
                        sender=identity[:32],
                    )
                return {
                    "stored": [False] * len(args["records"]),
                    "refused": reason,
                }
        outcomes = []
        for rec in args["records"]:
            key, subkey, value, expiration = rec
            record = DHTRecord(key, subkey, value, expiration)
            if not self.validator.validate(record):
                outcomes.append(False)
                continue
            if subkey is not None:
                outcomes.append(self.storage.store(key, value, expiration, subkey=subkey))
            else:
                outcomes.append(self.storage.store(key, value, expiration))
        return {"stored": outcomes}

    # the core DHT handlers never await I/O (validation and storage are
    # synchronous): the RPC server may run them inline instead of paying a
    # Task per request (protocol.py ``rpc_inline``)
    _rpc_store.rpc_inline = True

    # ----------------------------------------------------------- client side

    async def bootstrap(self, initial_peers: Sequence[Endpoint]) -> None:
        pings = await asyncio.gather(
            *(self._ping(tuple(p)) for p in initial_peers), return_exceptions=True
        )
        if not any(p is True for p in pings):
            logger.warning(f"bootstrap: no initial peer of {len(list(initial_peers))} responded")
        await self.find_nearest_nodes(self.node_id)

    async def _ping(self, endpoint: Endpoint) -> bool:
        try:
            result = await self.client.call(
                endpoint, "dht.ping", self._sender_args()
            )
            self.routing_table.add_or_update_node(
                NodeInfo(DHTID.from_bytes(result["node_id"]), tuple(endpoint))
            )
            return True
        except Exception:  # noqa: BLE001 — peer unreachable
            return False

    async def find_nearest_nodes(
        self, target: DHTID, k: Optional[int] = None
    ) -> List[NodeInfo]:
        """Iterative Kademlia lookup over the `dht.find` RPC. Results are
        cached per (target, k) for ``lookup_cache_ttl`` virtual seconds;
        callers that then observe a dead holder must ``_uncache_nearest``
        so the next call re-converges."""
        k = k or self.bucket_size
        cache_key = (int(target), k)
        if self.lookup_cache_ttl > 0:
            hit = self._nearest_cache.get(cache_key)
            if hit is not None:
                if hit[0] > get_dht_time():
                    return list(hit[1])
                del self._nearest_cache[cache_key]
        # a lookup IS refresh activity for the target's bucket
        self.routing_table.mark_range_refreshed(target)
        candidates: Dict[int, NodeInfo] = {
            n.node_id: n for n in self.routing_table.nearest_neighbors(target, k)
        }
        queried: set = set()
        # nodes that failed a probe THIS lookup: a later reply must not
        # re-admit one via setdefault — it is already in ``queried``, so the
        # termination check would accept it into the final top-k and every
        # subsequent get/store against the cached set would fail on it,
        # evicting the cache and re-learning the same dead peer forever
        failed: set = set()
        while True:
            frontier = sorted(
                (n for nid, n in candidates.items() if nid not in queried),
                key=lambda n: n.node_id ^ target,
            )[: self.parallel_rpc]
            if not frontier:
                break
            best_known = sorted(candidates, key=lambda nid: nid ^ target)[:k]
            if best_known and all(nid in queried for nid in best_known):
                break
            replies = await asyncio.gather(
                *(
                    self.client.call(
                        n.endpoint,
                        "dht.find",
                        {**self._sender_args(), "target": target.to_bytes()},
                    )
                    for n in frontier
                ),
                return_exceptions=True,
            )
            for node, reply in zip(frontier, replies):
                queried.add(node.node_id)
                if isinstance(reply, Exception):
                    self.routing_table.remove_node(node.node_id)
                    candidates.pop(node.node_id, None)
                    failed.add(node.node_id)
                    continue
                for info in _unpack_nodes(reply["nodes"]):
                    if info.node_id != self.node_id and info.node_id not in failed:
                        candidates.setdefault(info.node_id, info)
                        self.routing_table.add_or_update_node(info)
        out = sorted(candidates.values(), key=lambda n: n.node_id ^ target)
        out = out[:k]
        if self.lookup_cache_ttl > 0:
            while len(self._nearest_cache) >= 256:  # bounded: drop oldest
                self._nearest_cache.pop(next(iter(self._nearest_cache)))
            self._nearest_cache[cache_key] = (
                get_dht_time() + self.lookup_cache_ttl, list(out)
            )
        return out

    def _uncache_nearest(self, target: DHTID, k: Optional[int] = None) -> None:
        """Drop the cached nearest set for ``target`` — called when a query
        against it failed, i.e. the cached neighborhood no longer matches
        the live network."""
        self._nearest_cache.pop((int(target), k or self.bucket_size), None)

    async def store(
        self,
        key: bytes,
        value: bytes,
        expiration_time: DHTExpiration,
        subkey: Optional[bytes] = None,
    ) -> bool:
        """Sign, validate locally, then replicate onto the nearest peers."""
        key_id = DHTID.of_key(key)
        record = DHTRecord(key, subkey, value, expiration_time)
        signed = self.validator.sign_value(record)
        record = DHTRecord(key, subkey, signed, expiration_time)
        if not self.validator.validate(record):
            # e.g. relaying a record owned (signed) by a key we don't hold
            logger.debug(f"record for key {key!r} failed local validation")
            return False

        # look up WIDER than the replica set (classic Kademlia: k-wide
        # lookup, then pick the replicas): with small buckets the iterative
        # search needs the extra frontier to converge on the true global
        # nearest set — a k=num_replicas lookup from a sparse table can
        # settle on a locally-nearest set that misses the real one, and
        # store/get would then disagree about where the record lives
        k_wide = max(self.bucket_size, self.num_replicas)
        nearest = (await self.find_nearest_nodes(key_id, k=k_wide))[
            : self.num_replicas
        ]
        stored_anywhere = False
        # self-store if we are closer than the furthest replica (or low pop.)
        if not self.client_mode and (
            len(nearest) < self.num_replicas
            or (self.node_id ^ key_id) < (nearest[-1].node_id ^ key_id)
        ):
            if subkey is not None:
                stored_anywhere |= self.storage.store(
                    key, signed, expiration_time, subkey=subkey
                )
            else:
                stored_anywhere |= self.storage.store(key, signed, expiration_time)
        wire_record = [key, subkey, signed, expiration_time]
        replies = await asyncio.gather(
            *(
                self.client.call(
                    n.endpoint,
                    "dht.store",
                    {**self._sender_args(), "records": [wire_record]},
                )
                for n in nearest
            ),
            return_exceptions=True,
        )
        for node, reply in zip(nearest, replies):
            if isinstance(reply, Exception):
                # a replica died since the set was (possibly) cached —
                # evict it everywhere so the next lookup re-converges
                self.routing_table.remove_node(node.node_id)
                self._uncache_nearest(key_id, k_wide)
            elif any(reply.get("stored", [])):
                stored_anywhere = True
        return stored_anywhere

    async def get(
        self, key: bytes, latest: bool = False
    ) -> Optional[ValueWithExpiration]:
        """Fetch a record; ``latest=True`` always queries the network and
        merges dictionary subkeys across replicas."""
        key_id = DHTID.of_key(key)
        local = (None if self.client_mode else self.storage.get(key)) or self.cache.get(key)
        if local is not None and not latest:
            return self._strip(key, local)

        merged_dict = DictionaryDHTValue()
        best_value: Optional[ValueWithExpiration] = None
        if local is not None:
            if isinstance(local.value, DictionaryDHTValue):
                for sk, v in local.value.items():
                    merged_dict.store(sk, v.value, v.expiration_time)
            else:
                best_value = local

        # wide lookup for the same reason as in store(); query a couple of
        # nodes beyond the replica count so one stale/missed replica does
        # not turn into a lost record
        k_wide = max(self.bucket_size, self.num_replicas)
        nearest = (await self.find_nearest_nodes(key_id, k=k_wide))[
            : self.num_replicas + 2
        ]
        replies = await asyncio.gather(
            *(
                self.client.call(
                    n.endpoint,
                    "dht.find",
                    {
                        **self._sender_args(),
                        "target": key_id.to_bytes(),
                        "key": key,
                        "return_value": True,
                    },
                )
                for n in nearest
            ),
            return_exceptions=True,
        )
        for node, reply in zip(nearest, replies):
            if isinstance(reply, Exception):
                self.routing_table.remove_node(node.node_id)
                self._uncache_nearest(key_id, k_wide)
                continue
            # validate on the READ path too: a malicious replica could serve
            # forged records it never accepted through _rpc_store
            if "dict_value" in reply:
                for sk, v, exp in reply["dict_value"]:
                    if self.validator.validate(DHTRecord(key, sk, v, exp)):
                        merged_dict.store(sk, v, exp)
            elif "value" in reply:
                candidate = ValueWithExpiration(reply["value"], reply["expiration"])
                if not self.validator.validate(
                    DHTRecord(key, None, candidate.value, candidate.expiration_time)
                ):
                    continue
                if best_value is None or candidate.expiration_time > best_value.expiration_time:
                    best_value = candidate

        now = get_dht_time()
        if len(merged_dict):
            result = ValueWithExpiration(
                merged_dict, merged_dict.latest_expiration_time
            )
            if result.expiration_time > now:
                for sk, v in merged_dict.items():
                    self.cache.store(key, v.value, v.expiration_time, subkey=sk)
                return self._strip(key, result)
        if best_value is not None and best_value.expiration_time > now:
            self.cache.store(key, best_value.value, best_value.expiration_time)
            return self._strip(key, best_value)
        return None

    def _strip(self, key: bytes, entry: ValueWithExpiration) -> ValueWithExpiration:
        """Remove signature wrapping for the reader."""
        if isinstance(entry.value, DictionaryDHTValue):
            out = DictionaryDHTValue()
            for sk, v in entry.value.items():
                stripped = self.validator.strip_value(
                    DHTRecord(key, sk, v.value, v.expiration_time)
                )
                out.store(sk, stripped, v.expiration_time)
            return ValueWithExpiration(out, entry.expiration_time)
        stripped = self.validator.strip_value(
            DHTRecord(key, None, entry.value, entry.expiration_time)
        )
        return ValueWithExpiration(stripped, entry.expiration_time)

    # ----------------------------------------------------------- maintenance

    async def _maintenance_loop(self, interval: float) -> None:
        while True:
            await asyncio.sleep(interval)
            try:
                await self.run_maintenance()
            except Exception as e:  # noqa: BLE001 — keep the loop alive
                logger.debug(f"dht maintenance pass failed: {e!r}")

    async def run_maintenance(self) -> Dict[str, int]:
        """One self-maintenance pass — the Kademlia housekeeping a
        multi-hour churning run depends on (the capability hivemind's DHT
        provides under albert/run_trainer.py:236-243):

        1. **stale-peer eviction** — ping routing-table entries not heard
           from within ``stale_peer_timeout``; unresponsive nodes are
           evicted (replacement-cache candidates promote), so lookups stop
           spraying RPCs at long-dead peers.
        2. **bucket refresh** — a random-target lookup in every bucket
           whose range saw no activity for ``bucket_refresh_interval``,
           (re)discovering live peers for sparse regions of the ID space.
        3. **record re-replication** — every unexpired locally-held record
           is re-offered to the CURRENT ``num_replicas`` nearest nodes;
           as membership churns, replicas migrate onto newer nodes, so a
           record outlives every node that originally stored it (receivers
           keep the newest expiration — idempotent).

        Returns counters (tests and soak harnesses call this directly with
        a fake clock instead of waiting out ``maintenance_interval``).
        """
        stats = {"evicted": 0, "refreshed_buckets": 0, "republished": 0}
        now = timeutils.monotonic()
        # 1. stale-peer eviction, pings in parallel (a mass disconnect must
        # not serialize N x request_timeout inside one pass); ping success
        # re-registers with a fresh last_seen via _ping's add_or_update
        stale = [
            info
            for bucket in list(self.routing_table.buckets)
            for info in list(bucket.nodes.values())
            if now - info.last_seen >= self.stale_peer_timeout
        ]
        if stale:
            alive = await asyncio.gather(
                *(self._ping(info.endpoint) for info in stale)
            )
            for info, ok in zip(stale, alive):
                if not ok:
                    self.routing_table.remove_node(info.node_id)
                    stats["evicted"] += 1
        # 2. bucket refresh
        for bucket in list(self.routing_table.buckets):
            if (timeutils.monotonic() - bucket.last_refreshed
                    < self.bucket_refresh_interval):
                continue
            target = self.routing_table.random_id_in(bucket)
            await self.find_nearest_nodes(target)
            bucket.last_refreshed = timeutils.monotonic()
            stats["refreshed_buckets"] += 1
        # 3. record re-replication — on its own (much longer) cadence
        due = (
            self._last_replication is None
            or timeutils.monotonic() - self._last_replication
            >= self.replication_interval
        )
        if not self.client_mode and due:
            self._last_replication = timeutils.monotonic()
            dht_now = get_dht_time()
            for key in self.storage.keys():
                entry = self.storage.get(key)  # prunes expired subkeys
                if entry is None or entry.expiration_time <= dht_now:
                    continue
                if isinstance(entry.value, DictionaryDHTValue):
                    records = [
                        [key, sk, v.value, v.expiration_time]
                        for sk, v in entry.value.items()
                        if v.expiration_time > dht_now
                    ]
                else:
                    records = [[key, None, entry.value, entry.expiration_time]]
                if not records:
                    continue
                key_id = DHTID.of_key(key)
                nearest = await self.find_nearest_nodes(
                    key_id, k=self.num_replicas
                )
                targets = [n for n in nearest if n.node_id != self.node_id]
                if not targets:
                    continue
                await asyncio.gather(
                    *(
                        self.client.call(
                            n.endpoint,
                            "dht.store",
                            {**self._sender_args(), "records": records},
                        )
                        for n in targets
                    ),
                    return_exceptions=True,
                )
                stats["republished"] += 1
        return stats

    async def shutdown(self) -> None:
        if self._maintenance_task is not None:
            self._maintenance_task.cancel()
        await self.client.close()
        if self.server is not None:
            await self.server.stop()
