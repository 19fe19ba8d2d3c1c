"""DecentralizedAverager: matchmaking + group all-reduce + state sharing.

The TPU-native counterpart of hivemind.DecentralizedAverager as consumed via
CollaborativeOptimizer (SURVEY.md §2.6). Runs entirely on the DHT facade's
event loop; exposes a synchronous ``step`` for the trainer thread.

In the TPU design the entity calling ``step`` is one pod SLICE (gradients
already psum-reduced over ICI by the jitted step); this class only moves
bytes across slices over DCN/TCP.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import hashlib
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from dedloc_tpu_torch.averaging.allreduce import (
    DEFAULT_CHUNK_SIZE,
    AllreduceFailed,
    GroupAllReduce,
)
from dedloc_tpu_torch.averaging.matchmaking import (
    GroupInfo,
    Matchmaking,
    MatchmakingFailed,
)
from dedloc_tpu_torch.averaging.partition import FlatTree, TreeLayout
from dedloc_tpu_torch.averaging.planwire import MAX_PLAN_FETCH_FAILURES, fetch_plan
from dedloc_tpu_torch.averaging.topology import TopologyPlan
from dedloc_tpu_torch.checkpointing import (
    CheckpointAnnouncement,
    CheckpointManifest,
    ShardStore,
    build_manifest,
    catalog_key,
    parse_announcements,
    publish_announcement,
    shard_bytes,
    sharded_restore,
)
from dedloc_tpu_torch.core.serialization import (
    CompressionType,
    deserialize_array,
    deserialize_tree,
    pack_obj,
    serialize_array,
    serialize_tree,
    unpack_obj,
)
from dedloc_tpu_torch.core.timeutils import get_dht_time
from dedloc_tpu_torch.dht.dht import DHT
from dedloc_tpu_torch.dht.protocol import RPCClient, RPCError, RPCServer
from dedloc_tpu_torch.telemetry import registry as telemetry
from dedloc_tpu_torch.telemetry.ledger import (
    ContributionClaim,
    parse_round_step,
    publish_claim,
    publish_receipt,
    receipt_from_group,
)
from dedloc_tpu_torch.telemetry.links import endpoint_key
from dedloc_tpu_torch.testing import faults
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def schema_fingerprint(tree: Dict[str, np.ndarray]) -> bytes:
    """Order-independent hash of (name, shape, dtype) — the join-time
    compatibility handshake: peers whose trees cannot all-reduce together
    are refused by leaders instead of failing a span assert mid-round."""
    h = hashlib.sha256()
    for name in sorted(tree):
        arr = tree[name]
        h.update(name.encode())
        h.update(str(tuple(arr.shape)).encode())
        h.update(str(arr.dtype).encode())
    return h.digest()[:16]


def spec_fingerprint(spec) -> bytes:
    """``schema_fingerprint`` computed from a TreeLayout spec alone — the
    same digest a named-dict view of the buffer would produce, so a peer
    contributing through the device-flat pipeline (``FlatFetch``) can join
    matchmaking BEFORE its device->host transfer has resolved."""
    h = hashlib.sha256()
    for name, shape, dtype in sorted(spec, key=lambda entry: entry[0]):
        h.update(name.encode())
        h.update(str(tuple(shape)).encode())
        h.update(str(np.dtype(dtype)).encode())
    return h.digest()[:16]


class DecentralizedAverager:
    def __init__(
        self,
        dht: DHT,
        prefix: str,
        bandwidth: float = 1000.0,
        client_mode: bool = False,
        auxiliary: bool = False,
        allow_state_sharing: bool = True,
        compression: str | CompressionType = CompressionType.FLOAT16,
        chunk_size: int = DEFAULT_CHUNK_SIZE,  # elements per wire chunk in
        # the pipelined all-reduce; <= 0 restores monolithic spans
        averaging_expiration: float = 5.0,
        averaging_timeout: float = 30.0,
        target_group_size: int = 256,
        listen_host: str = "0.0.0.0",
        listen_port: int = 0,
        advertised_host: Optional[str] = None,
        authorizer=None,  # TokenAuthorizerBase for gated runs (joiner side)
        authority_public_key: Optional[bytes] = None,  # leader-side gate
        relay: Optional[str] = None,  # "host:port[,host2:port2,…]" public
        # peers whose RelayService makes this client-mode peer reachable
        # (circuit relay, p2p/circuit-relay.md); registration is
        # k-redundant and the advertised endpoint fails over when the
        # primary relay dies. Listening peers all serve as relays.
        relay_keepalive_period: float = 5.0,
        # state-sync retry budget: a dead or corrupt provider costs one
        # exponential backoff instead of a failed join (see
        # load_state_from_peers)
        state_sync_retries: int = 2,
        state_sync_backoff: float = 0.5,
        # swarm checkpointing (dedloc_tpu/checkpointing, --checkpoint.*):
        # fp32 elements per content-addressed shard of the shared state.
        # <= 0 (the component default) disables sharded serving, catalog
        # announcements AND the sharded restore path — everything stays on
        # the full blob. The CollaborativeOptimizer / role configs default
        # it ON (DEFAULT_SHARD_SIZE); bare averagers opt in explicitly.
        checkpoint_shard_size: int = 0,
        # concurrent shard downloads during a sharded restore
        checkpoint_fetch_parallelism: int = 4,
        # cap on distinct providers one restore spreads across (0 = all)
        checkpoint_max_providers: int = 0,
        # local shard store for RESUMABLE restores (and as a by-product a
        # durable shard cache); None = in-memory only
        checkpoint_dir: Optional[str] = None,
        # the peer's signed metrics subkey (rsa: owner tag): when given,
        # catalog announcements ride it and are signature-bound to this
        # peer by the existing record-validator chain
        signed_subkey: Optional[bytes] = None,
        # per-peer telemetry scope (telemetry/registry.py): in-process
        # multi-peer tests pass one registry per simulated peer; production
        # (one peer per process) leaves None and the process-global
        # registry — if installed — is used at each instrumented site
        telemetry_registry=None,
        # hierarchical (two-level) averaging plan (averaging/topology.py;
        # --averager.topology_plan): a TopologyPlan, or a path to its JSON.
        # None / mode="flat" keeps today's flat butterfly. Installable
        # later via set_topology_plan (e.g. replanned from live telemetry).
        topology_plan=None,
        # live re-planning (averaging/planwire.py): when True, ``step``
        # polls the coordinator's epoch-versioned plan record between
        # rounds and adopts the newest valid plan — the closed adaptation
        # loop. Defaults OFF for bare averagers; the roles enable it unless
        # the operator pinned a manual --averager.topology_plan (the
        # opt-out, docs/fleet.md). Repeated fetch failures degrade to the
        # held plan and ultimately to flat (MAX_PLAN_FETCH_FAILURES).
        plan_follow: bool = False,
        plan_refresh_period: float = 30.0,  # dht-time seconds between polls
        # contribution-ledger receipts (telemetry/ledger.py): countersign
        # each finalized round's member set + declared weights into this
        # peer's signed RoundReceipt DHT record. ON by default — receipts
        # are what makes any peer's contribution claim checkable; a receipt
        # failure only ever logs, it can never cost a round.
        ledger_receipts: bool = True,
        # dht/transport.py seam for this peer's averaging RPC server and
        # client: None = real TCP (production); the swarm simulator injects
        # its in-process network here
        transport=None,
    ):
        if relay and not client_mode:
            # a listening peer IS a relay; accepting (and dropping) the flag
            # would leave a NAT-ed operator who forgot client_mode with an
            # unreachable advertised address and no signal why
            raise ValueError(
                "relay= is for client-mode peers (set client_mode=True); "
                "listening peers serve as relays themselves"
            )
        self.dht = dht
        self.prefix = prefix
        self.client_mode = client_mode
        self.auxiliary = auxiliary
        self.allow_state_sharing = allow_state_sharing and not client_mode
        self.compression = (
            CompressionType(compression)
            if isinstance(compression, str)
            else compression
        )
        self.chunk_size = int(chunk_size)
        # zero-copy flatten: the tree schema is stable across rounds, so ONE
        # TreeLayout (with its preallocated flat buffer) serves every round;
        # rebuilt only if the schema ever changes
        self._layout: Optional[TreeLayout] = None
        self.averaging_expiration = averaging_expiration
        self.averaging_timeout = averaging_timeout
        self.target_group_size = target_group_size
        self.relay_keepalive_period = relay_keepalive_period
        self.state_sync_retries = int(state_sync_retries)
        self.state_sync_backoff = float(state_sync_backoff)
        self.telemetry = telemetry_registry
        self._listen = (listen_host, listen_port)
        self._advertised_host = advertised_host or "127.0.0.1"
        self._shared_state: Optional[Tuple[Dict[str, np.ndarray], Dict[str, Any]]] = None
        # serialized snapshot cache: (blob, sha256 digest) — the digest rides
        # every state.get reply so downloaders detect truncation/corruption
        self._shared_state_blob: Optional[Tuple[bytes, bytes]] = None
        self._state_lock = threading.Lock()
        self._serialize_task: Optional[asyncio.Task] = None
        # sharded snapshot cache: (manifest, flat fp32 vector) cut from the
        # SAME shared-state snapshot — built lazily (first ckpt RPC or
        # catalog publish), invalidated with the snapshot
        self.checkpoint_shard_size = int(checkpoint_shard_size)
        self.checkpoint_fetch_parallelism = int(checkpoint_fetch_parallelism)
        self.checkpoint_max_providers = int(checkpoint_max_providers)
        self.signed_subkey = signed_subkey
        self._ckpt_store = (
            ShardStore(checkpoint_dir) if checkpoint_dir else None
        )
        self._sharded_state: Optional[Tuple[CheckpointManifest, np.ndarray]] = None
        # (snapshot, message) when the snapshot cannot roundtrip the fp32
        # flat layout — cached so the full-state flatten is not retried
        # (and the warning not repeated) on every publish cadence / ckpt RPC
        self._sharded_state_error: Optional[Tuple[Any, str]] = None
        self._shard_task: Optional[asyncio.Task] = None
        self.server: Optional[RPCServer] = None
        self.endpoint = None
        self.last_group_size: int = 1
        self.last_contributors: int = 1
        # hierarchical averaging state: the installed plan, and the fan-out
        # futures a delegate publishes each round's final result through
        # (clique members pull them via the avg.final RPC)
        self._topology_plan: Optional[TopologyPlan] = None
        self._hier_results: Dict[str, asyncio.Future] = {}
        if topology_plan is not None:
            self.set_topology_plan(topology_plan)
        # live re-planning state: what we last adopted — (epoch, issued)
        # orders records so a same-epoch republish with newer tuning is
        # adopted without a scope reshuffle, and consecutive fetch failures
        # are counted toward the degrade-to-flat threshold
        self.plan_follow = bool(plan_follow)
        self.plan_refresh_period = float(plan_refresh_period)
        self.plan_tuning: Dict[str, Any] = {}
        self._plan_epoch = 0
        self._plan_issued = float("-inf")
        self._plan_fetch_failures = 0
        self._plan_next_refresh = 0.0
        # contribution ledger (telemetry/ledger.py): this peer's cumulative
        # witness table over group-mates' declared weights — refreshed into
        # a signed RoundReceipt DHT record at every round finalization
        self._ledger_witness: Dict[str, Dict[str, float]] = {}
        self.ledger_receipts = bool(ledger_receipts)

        # build server+matchmaking+allreduce on the DHT loop
        def _setup(node):
            async def setup():
                from dedloc_tpu_torch.dht.protocol import RelayService

                self.client = RPCClient(
                    request_timeout=averaging_timeout,
                    telemetry_registry=self.telemetry,
                    transport=transport,
                )
                if not client_mode:
                    self.server = RPCServer(
                        *self._listen, telemetry_registry=self.telemetry,
                        transport=transport,
                    )
                    self.server.register("state.get", self._rpc_state_get)
                    # swarm checkpointing: serve the sharded form of the
                    # same snapshot (full-blob state.get stays the fallback)
                    self.server.register(
                        "ckpt.manifest", self._rpc_ckpt_manifest
                    )
                    self.server.register("ckpt.shard", self._rpc_ckpt_shard)
                    # hierarchical averaging fan-out: clique members pull
                    # the WAN round's final result from their delegate
                    self.server.register("avg.final", self._rpc_hier_final)
                    await self.server.start()
                    self.endpoint = (self._advertised_host, self.server.port)
                    tele_setup = telemetry.resolve(self.telemetry)
                    if tele_setup is not None:
                        # self-identification for the topology views: maps
                        # this peer's label to the endpoint other peers'
                        # link estimates name as their dst
                        tele_setup.event(
                            "peer.endpoint",
                            endpoint=endpoint_key(self.endpoint),
                        )
                    # every public peer doubles as a circuit relay for
                    # private peers (p2p/circuit-relay.md relay_enabled)
                    self.relay_service = RelayService(self.server)
                if authorizer is not None:
                    # gated runs bind peer identity to the token key so
                    # leaders/joiners can verify who signed what (see
                    # matchmaking identity binding)
                    from dedloc_tpu_torch.core.auth import peer_id_from_public_key

                    self.peer_id = peer_id_from_public_key(
                        authorizer.local_public_key
                    )
                elif self.signed_subkey and bytes(
                    self.signed_subkey
                ).startswith(b"rsa:"):
                    # open runs with a record-signing key: derive the peer
                    # id from the SAME key digest gated runs use, so this
                    # peer's signed ledger records bind to its identity
                    # (telemetry/ledger.subkey_owner_id)
                    from dedloc_tpu_torch.core.auth import peer_id_from_public_key
                    from dedloc_tpu_torch.dht.validation import OWNER_PREFIX

                    self.peer_id = peer_id_from_public_key(
                        bytes(self.signed_subkey)[len(OWNER_PREFIX):]
                    )
                else:
                    self.peer_id = node.node_id.to_bytes()
                if client_mode and relay:
                    # circuit relay: park an outbound connection at EVERY
                    # listed public peer (comma-separated "host:port,…" —
                    # the reference's private peers bootstrap off several
                    # public nodes, p2p/NAT-traversal.md:20-23, so one
                    # relay dying must not strand the peer); our RPC
                    # methods (mm.join, allreduce; state.get is withheld —
                    # no state sharing in client mode) become reachable at
                    # the PRIMARY relay's virtual endpoint, and the
                    # keepalive fails the advertisement over to a live
                    # backup when the primary dies.
                    relay_eps = []
                    for spec in str(relay).split(","):
                        spec = spec.strip()
                        if spec:
                            host, _, port = spec.rpartition(":")
                            relay_eps.append((host, int(port)))
                    registry = RPCServer()  # handler registry; never listens
                    self.server = registry
                    self.client.reverse_handlers = registry._handlers
                    self._relay_endpoints = relay_eps
                    # relays we COMPLETED a registration with — failover must
                    # never advertise a relay that merely has a TCP
                    # connection (e.g. a non-relay RPC server would answer
                    # pings yet route nothing)
                    self._registered_relays: set = set()
                    self.endpoint = None
                    for ep in relay_eps:
                        try:
                            vep = await self.client.register_with_relay(
                                ep, self.peer_id
                            )
                            self._registered_relays.add(ep)
                            logger.info(f"registered with relay {ep}")
                            if self.endpoint is None:
                                self.endpoint = vep  # primary = first live
                        except Exception as e:  # noqa: BLE001
                            logger.warning(
                                f"relay {ep} registration failed: {e!r}"
                            )
                    if self.endpoint is None:
                        raise ConnectionError(
                            f"could not register with any relay of "
                            f"{relay_eps}"
                        )

                    async def keep_registered() -> None:
                        # ACTIVE liveness probe per relay: a dropped relay
                        # connection silently unregisters us, and a
                        # half-open one (relay power loss, NAT mapping
                        # expiry with no FIN) never raises EOF — so ping
                        # each relay over its parked connection every
                        # period. The ping shares the ordered byte stream
                        # with multi-MB relayed tensor frames, so a single
                        # slow pong is NOT evidence of death: generous
                        # timeout, an RPC-level error reply counts as alive
                        # (the connection answered), and a connection is
                        # only dropped after two consecutive silent
                        # failures. When the PRIMARY relay is gone, the
                        # advertised endpoint fails over to a live backup —
                        # fresh matchmaking/state records then carry the
                        # new virtual endpoint.
                        from dedloc_tpu_torch.dht.protocol import (
                            parse_relay_endpoint,
                            relay_endpoint,
                        )

                        period = self.relay_keepalive_period
                        ping_failures = {ep: 0 for ep in relay_eps}

                        async def check_relay(ep) -> None:
                            if ep in self.client._conns:
                                try:
                                    await self.client.call(
                                        ep, "relay.ping", {},
                                        timeout=max(10.0, 2 * period),
                                    )
                                    ping_failures[ep] = 0
                                except RPCError:
                                    ping_failures[ep] = 0  # answered
                                except Exception:  # noqa: BLE001
                                    ping_failures[ep] += 1
                                    if ping_failures[ep] >= 2:
                                        self.client._drop(
                                            ep,
                                            ConnectionResetError(
                                                "relay ping timed out twice"
                                            ),
                                        )
                                        self._registered_relays.discard(ep)
                                        ping_failures[ep] = 0
                            if (ep not in self.client._conns
                                    or ep not in self._registered_relays):
                                try:
                                    await self.client.register_with_relay(
                                        ep, self.peer_id
                                    )
                                    self._registered_relays.add(ep)
                                    logger.info(
                                        f"re-registered with relay {ep}"
                                    )
                                except Exception as e:  # noqa: BLE001
                                    self._registered_relays.discard(ep)
                                    logger.debug(
                                        f"relay re-register {ep}: {e!r}"
                                    )

                        while True:
                            await asyncio.sleep(period)
                            # in parallel: one half-open relay must not
                            # stall liveness detection for the others
                            await asyncio.gather(
                                *(check_relay(ep) for ep in relay_eps)
                            )
                            parsed = parse_relay_endpoint(self.endpoint)
                            primary = parsed[0] if parsed else None
                            healthy = [
                                ep for ep in relay_eps
                                if ep in self.client._conns
                                and ep in self._registered_relays
                            ]
                            if primary not in healthy and healthy:
                                ep = healthy[0]
                                self.endpoint = relay_endpoint(
                                    ep, self.peer_id
                                )
                                if hasattr(self, "matchmaking"):
                                    self.matchmaking.endpoint = self.endpoint
                                logger.warning(
                                    f"relay failover: advertising via {ep}"
                                )

                    self._relay_keepalive = asyncio.ensure_future(
                        keep_registered()
                    )
                # NAT traversal (dht/nat.py): calls to relay: endpoints
                # upgrade to direct paths — connection reversal when we are
                # public, hole punch when both sides are private — so the
                # relay carries only handshakes, never tensor bytes
                from dedloc_tpu_torch.dht.nat import NatTraversal

                if self.endpoint is not None and self.server.port is not None:
                    self.nat = NatTraversal(
                        self.client, self.server, self.peer_id,
                        advertised=self.endpoint,
                    )
                elif client_mode and relay:
                    conn = next(
                        (self.client._conns[ep]
                         for ep in self._relay_endpoints
                         if ep in self.client._conns),
                        None,
                    )
                    bind_host = "127.0.0.1"
                    if conn is not None:
                        sockname = conn[1].get_extra_info("sockname")
                        if sockname:
                            bind_host = sockname[0]
                    self.nat = NatTraversal(
                        self.client, self.server, self.peer_id,
                        advertised=None, bind_host=bind_host,
                    )
                else:
                    self.nat = None

                self.allreduce = GroupAllReduce(
                    self.client,
                    self.server,
                    compression=self.compression,
                    timeout=averaging_timeout,
                    straggler_timeout=averaging_expiration,
                    chunk_size=self.chunk_size,
                    telemetry_registry=self.telemetry,
                )
                self.matchmaking = Matchmaking(
                    node,
                    self.client,
                    self.server,
                    prefix,
                    self.peer_id,
                    self.endpoint,
                    bandwidth,
                    target_group_size=target_group_size,
                    averaging_expiration=averaging_expiration,
                    authorizer=authorizer,
                    authority_public_key=authority_public_key,
                    aux=auxiliary,
                    chunk_size=self.chunk_size,
                    telemetry_registry=self.telemetry,
                )

            return setup()

        dht.run_coroutine(_setup)

    # ------------------------------------------------------------ averaging

    def step(
        self,
        tree: Dict[str, np.ndarray],
        weight: float,
        round_id: str,
        return_future: bool = False,
        expected_size: Optional[int] = None,
        window: Optional[float] = None,
    ):
        """Average ``tree`` with whatever group forms for ``round_id``.

        ``tree`` is a {name: array} mapping — or a ``FlatFetch`` from the
        device-flat pipeline (``averaging/device_flat.py``), whose D2H
        transfer is then resolved on an executor thread CONCURRENTLY with
        matchmaking. Successful rounds return a ``FlatTree`` (a dict whose
        values view one flat buffer), so flat-native callers skip the
        re-flatten.

        Returns (averaged_tree | None, group_size); None means the round
        failed and the caller should proceed with its local values
        (reference semantics: a failed group costs one round, nothing else).

        ``weight`` is this peer's averaging weight — normally its accumulated
        sample count. The contribution ramp / trunk-health gate
        (collaborative optimizer) scale it down for freshly-joined or
        diverged peers: a reduced weight mixes proportionally less into the
        group mean, and ``weight == 0.0`` contributes NOTHING while still
        receiving the group's averaged result (a receive-only join; in a
        singleton group a zero-weight round returns None — there is nothing
        to receive).

        ``expected_size``: the collaboration's live peer count, if known —
        lets the leader assemble the moment the group is full instead of
        idling out the straggler window (matchmaking.form_group).

        ``window``: per-round override of ``averaging_expiration`` — the
        collaborative optimizer shortens the leader wait when the partners
        it is waiting on are only NEAR the current step (they may never
        arrive; see CollaborationState.num_peers_near_step).
        """
        if self.plan_follow:
            try:
                self.maybe_refresh_plan()
            except Exception as e:  # noqa: BLE001 — a plan-refresh bug
                # must never cost a training round
                logger.warning(f"plan refresh failed: {e!r}")

        def _run(node):
            return self._step_async(
                tree, weight, round_id, expected_size, window
            )

        fut = self.dht.run_coroutine(_run, return_future=True)
        return fut if return_future else fut.result()

    async def _step_async(
        self, tree: Dict[str, np.ndarray], weight: float, round_id: str,
        expected_size: Optional[int] = None,
        window: Optional[float] = None,
    ) -> Tuple[Optional[Dict[str, np.ndarray]], int]:
        tele = telemetry.resolve(self.telemetry)
        if tele is None:  # telemetry off: the bare path, zero overhead
            return await self._step_inner(
                tree, weight, round_id, expected_size, window
            )
        # one span per averaging round: matchmaking + allreduce + weight,
        # the unit the operator asks "why was step N slow" about. The trace
        # id derives from the swarm-unique round_id, so every member's spans
        # (and, via the RPC framing's trace context, every serve span they
        # cause on other peers) stitch into ONE cross-peer trace
        with tele.span(
            "avg.round", trace_seed=round_id, round_id=round_id,
            weight=weight,
        ) as ctx:
            averaged, group_size = await self._step_inner(
                tree, weight, round_id, expected_size, window
            )
            ctx["ok"] = averaged is not None
            ctx["group_size"] = group_size
            return averaged, group_size

    async def _step_inner(
        self, tree, weight: float, round_id: str,
        expected_size: Optional[int] = None,
        window: Optional[float] = None,
    ) -> Tuple[Optional[Dict[str, np.ndarray]], int]:
        # the round's declared sample weight rides the member record (and
        # its signed join envelope in gated runs): what group-mates
        # countersign in their contribution-ledger RoundReceipts
        self.matchmaking.declared_weight = max(0.0, float(weight))
        plan = self._topology_plan
        if plan is not None and plan.mode == "hierarchical":
            return await self._step_hier(
                tree, weight, round_id, expected_size, window, plan
            )
        if plan is not None and plan.mode == "gossip":
            return await self._step_gossip(
                tree, weight, round_id, expected_size, window, plan
            )
        return await self._step_flat(
            tree, weight, round_id, expected_size, window
        )

    def _flatten(self, tree) -> np.ndarray:
        """Flat fp32 view of ``tree`` in stable layout order, through the
        reused TreeLayout buffer (valid until the next flatten — the
        all-reduce reads it only within run())."""
        if isinstance(tree, FlatTree):
            # already flat in layout order: skip the host re-flatten pass
            if self._layout is None or self._layout.spec != tree.spec:
                self._layout = TreeLayout(tree.spec)
            return tree.flat
        if self._layout is None or not self._layout.matches(tree):
            self._layout = TreeLayout.for_tree(tree)
        # flatten into the layout's reused buffer: no astype/concatenate
        # temporaries on the hot path
        return self._layout.flatten_into(tree)

    async def _step_flat(
        self, tree, weight: float, round_id: str,
        expected_size: Optional[int] = None,
        window: Optional[float] = None,
    ) -> Tuple[Optional[Dict[str, np.ndarray]], int]:
        # device-flat contribution (averaging/device_flat.py FlatFetch):
        # the flat buffer is still streaming off the accelerator — resolve
        # it on an executor thread CONCURRENTLY with matchmaking, so the
        # D2H transfer hides behind group formation instead of preceding it
        from dedloc_tpu_torch.averaging.device_flat import FlatFetch

        fetch = None
        if isinstance(tree, FlatFetch):
            fetch = tree
            tree = None
            loop = asyncio.get_running_loop()
            resolve_task = loop.run_in_executor(None, fetch.result)
        try:
            group = await self.matchmaking.form_group(
                round_id,
                schema=(
                    spec_fingerprint(fetch.spec) if fetch is not None
                    else schema_fingerprint(tree)
                ),
                expected_size=expected_size, window=window,
            )
        except MatchmakingFailed as e:
            logger.debug(f"matchmaking failed for {round_id}: {e}")
            self.last_contributors = 0
            if fetch is not None:
                # settle the in-flight transfer even on failure: the
                # pipeline's double buffer rotates on the NEXT fetch, so an
                # unresolved transfer must not be left dangling
                await resolve_task
            return None, 1
        if fetch is not None:
            try:
                tree = await resolve_task
            except Exception as e:  # noqa: BLE001 — a failed D2H/decode
                # costs one round, never the training process
                logger.warning(f"{round_id}: device-flat fetch failed: {e!r}")
                self.last_contributors = 0
                return None, 1
        self.last_group_size = len(group.members)
        # gradient-bearing member count for the caller's divergence guard:
        # a {trainer, aux} group averages nothing for the trainer
        self.last_contributors = group.contributors
        if len(group.members) == 1:
            return (tree if weight > 0 else None), 1
        flat = self._flatten(tree)
        try:
            # the nonce is fresh per group assembly, so a retried round never
            # collides with _RoundState left over from a failed attempt
            averaged = await self.allreduce.run(
                f"{self.prefix}:{round_id}:{group.nonce}",
                group.my_index,
                flat,
                weight,
                group.endpoints,
                group.bandwidths,
                # chunk geometry must be identical on every member: use the
                # group-negotiated size (min of advertised; 0 = monolithic
                # if any member can't chunk), never the local config alone
                chunk_size=group.chunk_size,
            )
        except AllreduceFailed as e:
            logger.warning(f"allreduce failed for {round_id}: {e}")
            return None, len(group.members)
        self._emit_receipt(group, round_id, "flat")
        # a FlatTree result: the named views every existing consumer reads,
        # plus the flat buffer itself so a flat-native caller (the fused
        # flat apply) device_puts ONE array instead of per-leaf pieces
        return self._layout.tree_view(averaged), len(group.members)

    # -------------------------------------------------- gossip averaging

    async def _step_gossip(
        self, tree, weight: float, round_id: str,
        expected_size: Optional[int],
        window: Optional[float],
        plan: TopologyPlan,
    ) -> Tuple[Optional[Dict[str, np.ndarray]], int]:
        """One gossip round (the planner's third interpolation point, for
        very-unreliable swarms): average with a small deterministic
        neighbor group instead of the whole swarm. Every same-plan peer
        derives the identical per-round pairing from the plan roster
        (``TopologyPlan.gossip_groups`` — seeded by epoch + round_id, so
        pairs rotate every round and the swarm mixes over time), then runs
        a plain flat all-reduce inside its pair's scope. A missing partner
        is NOT a failure — the peer keeps its local values and mixes on a
        future pairing (that locality is the point: one flaky peer costs
        its pair a round, never the swarm). Matchmaking/allreduce errors
        fall back to ONE flat round, the same ladder as hierarchical."""
        from dedloc_tpu_torch.averaging.device_flat import FlatFetch

        tele = telemetry.resolve(self.telemetry)
        my_key = endpoint_key(self.endpoint) if self.endpoint else None

        async def fallback(reason: str, fetched_tree):
            if tele is not None:
                tele.counter("avg.topology.fallbacks").inc()
                tele.event(
                    "avg.topology.fallback", round_id=round_id,
                    reason=reason,
                )
            return await self._step_flat(
                fetched_tree, weight, round_id, expected_size, window
            )

        members = plan.gossip_group_of(
            [my_key] if my_key else [], round_id
        )
        if members is None:
            # not in the roster (late joiner since the plan was derived):
            # ride a flat round until the next re-plan includes us
            return await fallback("no identity in gossip roster", tree)

        # device-flat contribution: resolve the D2H transfer concurrently
        # with matchmaking, same as the flat path
        fetch = None
        if isinstance(tree, FlatFetch):
            fetch = tree
            tree = None
            resolve_task = asyncio.get_running_loop().run_in_executor(
                None, fetch.result
            )
        schema = (
            spec_fingerprint(fetch.spec) if fetch is not None
            else schema_fingerprint(tree)
        )

        async def settle() -> bool:
            nonlocal tree
            if fetch is not None and tree is None:
                try:
                    tree = await resolve_task
                except Exception as e:  # noqa: BLE001 — one round lost,
                    # never the training process
                    logger.warning(
                        f"{round_id}: device-flat fetch failed: {e!r}"
                    )
                    return False
            return True

        try:
            group = await self.matchmaking.form_group(
                round_id, schema=schema, expected_size=len(members),
                window=window, scope=plan.gossip_scope(members),
            )
        except MatchmakingFailed as e:
            logger.debug(f"gossip matchmaking failed for {round_id}: {e}")
            if not await settle():
                self.last_contributors = 0
                return None, 1
            return await fallback("gossip matchmaking failed", tree)
        if not await settle():
            self.last_contributors = 0
            return None, 1
        self.last_group_size = len(group.members)
        self.last_contributors = group.contributors
        if len(group.members) == 1:
            # partner absent this round: local values carry forward and mix
            # on a future pairing — by design, not a fallback
            return (tree if weight > 0 else None), 1
        flat = self._flatten(tree)
        try:
            averaged = await self.allreduce.run(
                f"{self.prefix}:{round_id}:{group.nonce}",
                group.my_index, flat, weight,
                group.endpoints, group.bandwidths,
                chunk_size=group.chunk_size,
            )
        except AllreduceFailed as e:
            logger.warning(f"gossip round failed for {round_id}: {e}")
            return await fallback("gossip round failed", tree)
        if tele is not None:
            tele.counter("avg.topology.rounds").inc()
            tele.event(
                "avg.topology.round", round_id=round_id, role="gossip",
                group_size=len(group.members), ok=True,
            )
        self._emit_receipt(group, round_id, "gossip")
        return self._layout.tree_view(averaged), len(group.members)

    # ---------------------------------------------- hierarchical averaging

    def set_topology_plan(self, plan) -> None:
        """Install (or clear, with None) the two-level averaging plan
        (averaging/topology.py). Accepts a ``TopologyPlan`` or a path to
        its JSON serialization. Takes effect on the next ``step``; the
        plan is stamped onto the event trace so operators can see WHICH
        hierarchy a round ran under."""
        if isinstance(plan, str):
            plan = TopologyPlan.load(plan)
        self._topology_plan = plan
        tele = telemetry.resolve(self.telemetry)
        if tele is not None and plan is not None:
            tele.event(
                "avg.topology.plan", mode=plan.mode, reason=plan.reason,
                cliques=len(plan.cliques),
                planned_peers=sum(len(c.members) for c in plan.cliques),
            )

    # ------------------------------------------------- live plan following

    def maybe_refresh_plan(self) -> None:
        """Poll the coordinator's plan record (averaging/planwire.py) and
        adopt the newest valid plan — called from ``step`` between rounds
        when ``plan_follow`` is on, rate-limited to ``plan_refresh_period``
        dht-time seconds. Adoption needs no barrier: the plan epoch is
        embedded in every matchmaking scope, so peers mid-rollout form
        disjoint (still valid) groups. The failure ladder: a transient
        fetch failure keeps the current plan; ``MAX_PLAN_FETCH_FAILURES``
        CONSECUTIVE failures degrade to flat with the reason named on the
        ``avg.topology.fallback`` event — a dead coordinator demotes the
        swarm, it never strands it."""
        now = get_dht_time()
        if now < self._plan_next_refresh:
            return
        self._plan_next_refresh = now + self.plan_refresh_period
        record, reason = fetch_plan(self.dht, self.prefix)
        if record is not None:
            self._plan_fetch_failures = 0
            self._adopt_plan_record(record)
            return
        if reason == "no plan record published":
            # definitive absence, not a failure: the coordinator simply has
            # not published (or its record expired intentionally) — a bare
            # swarm stays on whatever plan it holds
            self._plan_fetch_failures = 0
            return
        self._plan_fetch_failures += 1
        if self._plan_fetch_failures < MAX_PLAN_FETCH_FAILURES:
            logger.warning(
                f"plan refresh failed ({self._plan_fetch_failures}/"
                f"{MAX_PLAN_FETCH_FAILURES}): {reason} — keeping current plan"
            )
            return
        if self._topology_plan is not None:
            tele = telemetry.resolve(self.telemetry)
            if tele is not None:
                tele.counter("avg.topology.fallbacks").inc()
                tele.event(
                    "avg.topology.fallback", round_id="",
                    reason=(
                        f"plan refresh failed {self._plan_fetch_failures}x"
                        f" consecutively ({reason}) — degrading to flat"
                    ),
                )
            logger.warning(
                f"degrading to flat topology: {self._plan_fetch_failures} "
                f"consecutive plan fetch failures (last: {reason})"
            )
            self._topology_plan = None
        # forget the held (epoch, issued) watermark so a recovered
        # coordinator's republish of the SAME record is re-adoptable
        self._plan_epoch = 0
        self._plan_issued = float("-inf")

    def _adopt_plan_record(self, record) -> None:
        """Adopt ``record`` iff it is newer than what we hold: a higher
        epoch (structural re-plan — new matchmaking scopes), or the same
        epoch with a newer ``issued`` stamp (a tuning-only republish: the
        actuated retune's distribution channel, no scope reshuffle)."""
        newer = record.epoch > self._plan_epoch or (
            record.epoch == self._plan_epoch
            and record.issued > self._plan_issued
        )
        if not newer:
            return
        structural = record.epoch != self._plan_epoch
        self._plan_epoch = int(record.epoch)
        self._plan_issued = float(record.issued)
        self.plan_tuning = dict(record.tuning or {})
        chunk = self.plan_tuning.get("chunk_size")
        if isinstance(chunk, (int, float)) and not isinstance(chunk, bool) \
                and int(chunk) > 0:
            # groups negotiate min-of-advertised chunk geometry, so a
            # staggered rollout of a new size stays wire-compatible
            self.chunk_size = int(chunk)
        if structural:
            self.set_topology_plan(record.topology_plan())

    def _hier_future(self, key: str) -> asyncio.Future:
        """The fan-out future for one round's final result — created by
        whichever side (delegate publish, member pull) gets there first,
        and bounded like _RoundState entries so a key whose delegate never
        publishes cannot leak."""
        fut = self._hier_results.get(key)
        if fut is None:
            fut = asyncio.get_running_loop().create_future()
            self._hier_results[key] = fut
            asyncio.get_running_loop().call_later(
                self.averaging_timeout * 2, self._hier_results.pop, key, None
            )
        return fut

    async def _rpc_hier_final(self, peer, args) -> dict:
        """A clique member pulls the round's final averaged vector from its
        delegate (awaits until the delegate's WAN round lands). The reply
        serves the delegate's cached wire encoding — one encode serves the
        whole clique. A failed WAN leg parks an exception here, so members
        fail FAST into the flat retry ladder instead of idling out their
        timeout."""
        fut = self._hier_future(str(args["round_id"]))
        wire, group_size, contributors = await asyncio.wait_for(
            asyncio.shield(fut), timeout=self.averaging_timeout
        )
        return {
            "data": wire,
            "group_size": group_size,
            "contributors": contributors,
        }

    async def _step_hier(
        self, tree, weight: float, round_id: str,
        expected_size: Optional[int],
        window: Optional[float],
        plan: TopologyPlan,
    ) -> Tuple[Optional[Dict[str, np.ndarray]], int]:
        """One two-level round (averaging/topology.py): clique members
        reduce over cheap local links first (SUM mode — the raw weighted
        sum and its total weight), the clique's delegate carries that
        weight-summed contribution into the WAN butterfly round with
        ``weight=1, norm_weight=W_clique`` (the WAN mean divides by every
        gradient the sum carries without re-scaling it — delegation does
        not change the math), and the result fans back out through the
        delegate's ``avg.final``. Any failure at any rung — clique
        matchmaking, the sum round, the WAN leg, a dead delegate — falls
        back to ONE flat round of the same round_id (the PR 3 overlap
        failure-ladder contract: the flat buffer still holds this peer's
        grads, so the retry re-contributes them unchanged)."""
        from dedloc_tpu_torch.averaging.device_flat import FlatFetch

        tele = telemetry.resolve(self.telemetry)
        my_key = endpoint_key(self.endpoint) if self.endpoint else None
        assignment = plan.assignment([my_key] if my_key else [])

        async def fallback(reason: str, fetched_tree):
            if tele is not None:
                tele.counter("avg.topology.fallbacks").inc()
                tele.event(
                    "avg.topology.fallback", round_id=round_id,
                    reason=reason,
                )
            return await self._step_flat(
                fetched_tree, weight, round_id, expected_size, window
            )

        if assignment is None:
            # a peer with no routable identity cannot be placed in a clique
            return await fallback("no identity in plan", tree)
        clique = assignment.clique
        # fan-out key embeds the (epoch-qualified) clique scope: a member
        # and its delegate only exchange it when they formed the same
        # epoch's clique group, so mixed-epoch rollouts can never cross
        fan_key = f"{self.prefix}:{round_id}:fan:{plan.clique_scope(clique)}"

        # device-flat contribution: resolve the D2H transfer concurrently
        # with the clique matchmaking, same as the flat path
        fetch = None
        if isinstance(tree, FlatFetch):
            fetch = tree
            tree = None
            resolve_task = asyncio.get_running_loop().run_in_executor(
                None, fetch.result
            )
        schema = (
            spec_fingerprint(fetch.spec) if fetch is not None
            else schema_fingerprint(tree)
        )

        async def settle() -> bool:
            """Resolve the in-flight device fetch (idempotent); False when
            the D2H failed — that loses the round on every path."""
            nonlocal tree
            if fetch is not None and tree is None:
                try:
                    tree = await resolve_task
                except Exception as e:  # noqa: BLE001 — one round lost,
                    # never the training process
                    logger.warning(
                        f"{round_id}: device-flat fetch failed: {e!r}"
                    )
                    return False
            return True

        # ---- level 1: the clique-local SUM round over cheap links
        group = None
        if assignment.clique_size > 1:
            try:
                group = await self.matchmaking.form_group(
                    round_id, schema=schema,
                    expected_size=assignment.clique_size,
                    # epoch-qualified scope: peers on different plan epochs
                    # form disjoint groups during a re-plan rollout
                    window=window, scope=plan.clique_scope(clique),
                )
            except MatchmakingFailed as e:
                logger.debug(f"clique matchmaking failed for {round_id}: {e}")
                if not await settle():
                    self.last_contributors = 0
                    return None, 1
                return await fallback("clique matchmaking failed", tree)
        if not await settle():
            self.last_contributors = 0
            return None, 1
        flat = self._flatten(tree)

        sum_vec: Optional[np.ndarray] = None
        w_sum = weight
        delegate_ep = None
        clique_members = 1
        clique_contributors = 0 if (self.auxiliary or weight <= 0) else 1
        if group is not None and len(group.members) > 1:
            delegate_idx = next(
                (
                    i for i, m in enumerate(group.members)
                    if m.endpoint is not None
                    and endpoint_key(m.endpoint) == clique.delegate
                ),
                None,
            )
            if delegate_idx is None and not assignment.is_delegate:
                # the peer that must carry our sum up never joined: there
                # is nobody to pull the WAN result from
                return await fallback("delegate absent from clique", tree)
            if delegate_idx is not None:
                delegate_ep = group.endpoints[delegate_idx]
            clique_members = len(group.members)
            clique_contributors = group.contributors
            try:
                sum_vec, w_sum = await self.allreduce.run(
                    f"{self.prefix}:{round_id}:{group.nonce}",
                    group.my_index, flat, weight,
                    group.endpoints, group.bandwidths,
                    chunk_size=group.chunk_size,
                    normalize=False,
                )
            except AllreduceFailed as e:
                logger.warning(f"clique sum failed for {round_id}: {e}")
                return await fallback("clique sum round failed", tree)
            # the clique SUM leg is the receipt-bearing leg: every member
            # (the delegate included) countersigns the declared weights it
            # just reduced — the WAN leg carries pre-summed vectors whose
            # weights are the norm_weight artifice, not peer declarations
            self._emit_receipt(group, round_id, "clique")
        # else: singleton clique (or nobody joined a delegate's round) —
        # this peer IS its whole contribution and rides the WAN directly

        # ---- level 2, member side: the delegate carries our sum up; pull
        # the final result back from it
        if not assignment.is_delegate:
            if delegate_ep is None:
                return await fallback("no delegate to pull from", tree)
            try:
                reply = await self.client.call(
                    delegate_ep, "avg.final", {"round_id": fan_key},
                    timeout=self.averaging_timeout,
                )
                averaged = deserialize_array(reply["data"])
                if averaged.size != flat.size:
                    raise ValueError(
                        f"fan-out size mismatch: got {averaged.size}, "
                        f"want {flat.size}"
                    )
            except (RPCError, ConnectionError, OSError, ValueError,
                    asyncio.TimeoutError) as e:
                logger.warning(f"{round_id}: delegate fan-out failed: {e!r}")
                return await fallback("delegate died mid-round", tree)
            group_size = int(reply.get("group_size", clique_members))
            self.last_group_size = group_size
            self.last_contributors = int(
                reply.get("contributors", clique_contributors)
            )
            if tele is not None:
                tele.counter("avg.topology.rounds").inc()
                tele.event(
                    "avg.topology.round", round_id=round_id, role="member",
                    clique_size=clique_members, group_size=group_size,
                    ok=True,
                )
            return self._layout.tree_view(averaged), group_size

        # ---- level 2, delegate side: the WAN butterfly among delegates
        fut = self._hier_future(fan_key)
        wan_members = 1
        wan_contributors = 0
        try:
            if faults._active is not None:  # fault injection (testing/faults.py)
                fault = faults.fire(
                    "averager.hier_wan", round_id=round_id,
                    delegate=my_key or "",
                )
                if fault is not None:
                    await faults.apply_transport_fault(fault, "hier WAN leg")
            wan_group = await self.matchmaking.form_group(
                round_id, schema=schema,
                expected_size=assignment.wan_size, window=window,
                scope=plan.wan_scope(),
            )
            wan_members = len(wan_group.members)
            wan_contributors = wan_group.contributors
            if wan_members == 1:
                if sum_vec is not None and w_sum > 0:
                    # alone on the WAN: the clique mean IS the global mean
                    # (scale by the reciprocal — the identical arithmetic
                    # the flat host's finalize applies)
                    averaged = sum_vec * np.float32(1.0 / w_sum)
                elif clique_members == 1:
                    # overall singleton round: flat singleton semantics
                    if not fut.done():
                        fut.set_exception(
                            AllreduceFailed("singleton hierarchical round")
                        )
                    self.last_group_size = 1
                    self.last_contributors = clique_contributors
                    return (tree if weight > 0 else None), 1
                else:
                    averaged = None  # all-zero-weight clique, alone on WAN
            elif sum_vec is not None:
                averaged = await self.allreduce.run(
                    f"{self.prefix}:{round_id}:{wan_group.nonce}",
                    wan_group.my_index, sum_vec,
                    1.0 if w_sum > 0 else 0.0,
                    wan_group.endpoints, wan_group.bandwidths,
                    chunk_size=wan_group.chunk_size,
                    norm_weight=w_sum,
                )
            else:
                # singleton clique: plain (flat-semantics) contribution
                averaged = await self.allreduce.run(
                    f"{self.prefix}:{round_id}:{wan_group.nonce}",
                    wan_group.my_index, flat, weight,
                    wan_group.endpoints, wan_group.bandwidths,
                    chunk_size=wan_group.chunk_size,
                )
        except (MatchmakingFailed, AllreduceFailed, ConnectionError,
                OSError) as e:
            logger.warning(f"{round_id}: WAN leg failed: {e!r}")
            if not fut.done():
                # park the failure for the clique: members fail fast into
                # their own flat retry instead of idling out a timeout
                fut.set_exception(
                    AllreduceFailed(f"delegate WAN leg failed: {e!r}")
                )
            return await fallback("wan leg failed", tree)
        if averaged is None:
            if not fut.done():
                fut.set_exception(AllreduceFailed("nothing to average"))
            self.last_group_size = clique_members
            self.last_contributors = clique_contributors
            return None, clique_members
        # every replica must adopt bit-identical values: the clique decodes
        # the fan-out WIRE bytes, so the delegate adopts its own result
        # through the same codec (the flat path's wire_roundtrip contract)
        wire = serialize_array(averaged, self.compression, checksum=True)
        averaged = deserialize_array(wire)
        group_size = clique_members + wan_members - 1
        contributors = clique_contributors + max(
            0, wan_contributors - (0 if self.auxiliary else 1)
        )
        if not fut.done():
            fut.set_result((wire, group_size, contributors))
        self.last_group_size = group_size
        self.last_contributors = contributors
        if tele is not None:
            tele.counter("avg.topology.rounds").inc()
            tele.event(
                "avg.topology.round", round_id=round_id, role="delegate",
                clique_size=clique_members, wan_size=wan_members,
                group_size=group_size, ok=True,
            )
        return self._layout.tree_view(averaged), group_size

    # --------------------------------------------------------- state sharing

    def set_shared_state(
        self, tree: Dict[str, np.ndarray], metadata: Dict[str, Any]
    ) -> None:
        """Snapshot current training state for late joiners
        (load_state_from_peers counterpart, albert/run_trainer.py:124-128).
        Stores references only — serialization is deferred to the moment a
        peer actually requests the state (off the training thread)."""
        with self._state_lock:
            self._shared_state = (tree, metadata)
            self._shared_state_blob = None  # invalidate serialized cache
            self._sharded_state = None  # and the sharded form
            self._sharded_state_error = None

    def _serve_span(self, name: str, **attrs):
        """Server-side serve span for a state/checkpoint RPC handler: under
        the trace context the dispatch adopted off the request frame, its
        remote parent is the calling peer's span (state_sync attempt,
        ckpt.restore), so --trace shows the provider-side half of every
        download hop. Null span when telemetry is off."""
        tele = telemetry.resolve(self.telemetry)
        return (
            tele.span(name, **attrs)  # dedlint: emits=span:state.serve,span:ckpt.manifest.serve,span:ckpt.shard.serve
            if tele is not None
            else telemetry.null_span()
        )

    async def _rpc_state_get(self, peer, args) -> dict:
        with self._serve_span(
            "state.serve", schema_only=bool(args.get("schema_only"))
        ) as ctx:
            try:
                reply = await self._rpc_state_get_inner(peer, args)
            except Exception as e:
                ctx["ok"] = False
                ctx["error"] = type(e).__name__
                raise
            ctx["ok"] = True
            if "state" in reply:
                ctx["bytes"] = len(reply["state"])
            return reply

    async def _rpc_state_get_inner(self, peer, args) -> dict:
        if not self.allow_state_sharing:
            raise PermissionError("state sharing disabled on this peer")
        with self._state_lock:
            snapshot = self._shared_state
            blob = self._shared_state_blob
        if snapshot is None:
            raise FileNotFoundError("no state snapshot available yet")
        if args.get("schema_only"):
            # tensor names+shapes only (a few KB): what an aux peer needs to
            # bootstrap its gradient template without downloading the full
            # params+optimizer blob (hundreds of MB for real models)
            tree, _metadata = snapshot
            return {
                "schema": {k: list(v.shape) for k, v in tree.items()}
            }
        if blob is None:
            tree, metadata = snapshot

            def _serialize() -> Tuple[bytes, bytes]:
                data = pack_obj(
                    {
                        "metadata": pack_obj(metadata),
                        "tree": serialize_tree(tree, CompressionType.NONE),
                    }
                )
                # digest computed once at serialization time (the blob can be
                # hundreds of MB; rehashing per request would be pure waste)
                return data, hashlib.sha256(data).digest()

            # off the event loop (serializing the full model+optimizer state
            # can take seconds and must not stall live matchmaking/allreduce),
            # and deduplicated: concurrent late joiners await ONE serialization
            if self._serialize_task is None or self._serialize_task.done():
                loop = asyncio.get_running_loop()
                self._serialize_task = asyncio.ensure_future(
                    loop.run_in_executor(None, _serialize)
                )
            blob = await asyncio.shield(self._serialize_task)
            with self._state_lock:
                if self._shared_state is snapshot:  # not replaced meanwhile
                    self._shared_state_blob = blob
        data, digest = blob
        tele = telemetry.resolve(self.telemetry)
        if tele is not None:
            tele.counter("state.served").inc()
            tele.counter("state.served_bytes").inc(len(data))
        if faults._active is not None:  # fault injection (testing/faults.py)
            fault = faults.fire("averager.state_get", size=len(data))
            if fault is not None and fault.action == "truncate":
                # truncated download: the digest stays that of the FULL blob,
                # so the receiver's checksum validation catches the cut
                data = data[: int(len(data) * fault.fraction)]
                if tele is not None:
                    # attribute the APPLIED fault to the SERVING peer — the
                    # downloader sees only a checksum failure
                    tele.counter("faults.applied").inc()
                    tele.event(
                        "fault.applied", point="averager.state_get",
                        action="truncate", fraction=fault.fraction,
                    )
        return {"state": data, "checksum": digest}

    # ---------------------------------------------------- sharded state serving

    def _sharded_state_sync(
        self,
    ) -> Optional[Tuple[CheckpointManifest, np.ndarray]]:
        """Build (or return the cached) sharded form of the current shared
        state: manifest + fresh flat fp32 vector. Thread-safe and idempotent
        — callable from the backup thread (catalog publish) and from the
        DHT loop's executor (first ckpt RPC); a rare concurrent double
        build computes the identical result. Returns None when there is no
        snapshot; raises ValueError when the tree cannot roundtrip through
        the fp32 layout (callers then stay blob-only)."""
        if self.checkpoint_shard_size <= 0:
            return None
        with self._state_lock:
            snapshot = self._shared_state
            cached = self._sharded_state
            failed = self._sharded_state_error
        if snapshot is None:
            return None
        if cached is not None:
            return cached
        if failed is not None and failed[0] is snapshot:
            # this exact snapshot already failed the roundtrip check —
            # re-raise without paying the full-state flatten again
            raise ValueError(failed[1])
        tree, metadata = snapshot
        step = int(metadata.get("local_step", metadata.get("step", 0)) or 0)
        try:
            built = build_manifest(
                tree, step, shard_size=self.checkpoint_shard_size,
                metadata=metadata,
            )
        except ValueError as e:
            # warn ONCE per snapshot (here, at build time); cached retries
            # and the publish cadence stay silent
            logger.warning(f"sharded checkpoint serving unavailable: {e}")
            with self._state_lock:
                if self._shared_state is snapshot:
                    self._sharded_state_error = (snapshot, str(e))
            raise
        with self._state_lock:
            if self._shared_state is snapshot:  # not replaced meanwhile
                self._sharded_state = built
        return built

    async def _sharded_snapshot(self) -> Tuple[CheckpointManifest, np.ndarray]:
        """Sharded snapshot for the RPC handlers: built off the event loop
        (flatten + sha256 over the full state takes seconds at real model
        sizes) and deduplicated like the blob serialization."""
        if not self.allow_state_sharing:
            raise PermissionError("state sharing disabled on this peer")
        if self.checkpoint_shard_size <= 0:
            raise FileNotFoundError("sharded checkpoints disabled on this peer")
        with self._state_lock:
            cached = self._sharded_state
        if cached is not None:
            return cached
        if self._shard_task is None or self._shard_task.done():
            loop = asyncio.get_running_loop()
            self._shard_task = asyncio.ensure_future(
                loop.run_in_executor(None, self._sharded_state_sync)
            )
        built = await asyncio.shield(self._shard_task)
        if built is None:
            raise FileNotFoundError("no state snapshot available yet")
        return built

    async def _rpc_ckpt_manifest(self, peer, args) -> dict:
        with self._serve_span("ckpt.manifest.serve") as ctx:
            try:
                manifest, _flat = await self._sharded_snapshot()
            except Exception as e:
                ctx["ok"] = False
                ctx["error"] = type(e).__name__
                raise
            ctx["ok"] = True
            ctx["step"] = manifest.step
            return {"manifest": manifest.to_bytes()}

    async def _rpc_ckpt_shard(self, peer, args) -> dict:
        with self._serve_span(
            "ckpt.shard.serve", shard=int(args.get("index", -1))
        ) as ctx:
            try:
                reply = await self._rpc_ckpt_shard_inner(peer, args)
            except Exception as e:
                ctx["ok"] = False
                ctx["error"] = type(e).__name__
                raise
            ctx["ok"] = True
            ctx["bytes"] = len(reply["data"])
            return reply

    async def _rpc_ckpt_shard_inner(self, peer, args) -> dict:
        manifest, flat = await self._sharded_snapshot()
        index = int(args["index"])
        raw = shard_bytes(flat, manifest, index)
        if faults._active is not None:  # fault injection (testing/faults.py)
            fault = faults.fire("checkpoint.shard_get", index=index,
                                size=len(raw))
            if fault is not None and fault.action == "truncate":
                # the manifest digest stays that of the FULL shard, so the
                # fetcher's per-shard verification catches the cut; keep the
                # cut fp32-aligned so frombuffer below still parses and the
                # failure surfaces as a VERIFY failure, not a server crash
                cut = int(len(raw) * fault.fraction)
                raw = raw[: cut - cut % 4]
                tele_f = telemetry.resolve(self.telemetry)
                if tele_f is not None:
                    tele_f.counter("faults.applied").inc()
                    tele_f.event(
                        "fault.applied", point="checkpoint.shard_get",
                        action="truncate", shard=index,
                    )
        tele = telemetry.resolve(self.telemetry)
        if tele is not None:
            tele.counter("ckpt.shards_served").inc()
            tele.counter("ckpt.shard_bytes_served").inc(len(raw))
        return {
            "index": index,
            "data": serialize_array(
                np.frombuffer(raw, dtype=np.float32), CompressionType.NONE
            ),
        }

    # ------------------------------------------------ contribution ledger

    def _ledger_subkey(self) -> bytes:
        """The slot this peer's ledger records ride: the signed owner tag
        when it speaks for this peer's id (subkey_owner_id — always true
        for roles-built peers, whose validator key IS the identity key),
        else the raw peer id, which binds structurally. Either way the
        coordinator's parse path can verify the record speaks for exactly
        this peer; a subkey that binds to somebody else would get every
        record silently dropped at the fold."""
        from dedloc_tpu_torch.telemetry.ledger import subkey_owner_id

        sk = self.signed_subkey
        if sk is not None and subkey_owner_id(sk) == self.peer_id.hex():
            return sk
        return self.peer_id

    def _emit_receipt(self, group: GroupInfo, round_id: str,
                      leg: str) -> None:
        """Countersign a finalized round: fold the group's declared weights
        into this peer's cumulative witness table and republish its signed
        ``RoundReceipt`` DHT record (telemetry/ledger.py). Runs on the DHT
        loop right after the leg's all-reduce lands. Best-effort by
        contract: accounting must never cost the round that just
        succeeded."""
        if not self.ledger_receipts or len(group.members) < 2:
            return
        try:
            member_weights = [
                (m.peer_id.hex(), float(m.weight)) for m in group.members
            ]
            receipt = receipt_from_group(
                self.peer_id.hex(), round_id,
                parse_round_step(round_id), leg,
                member_weights, self._ledger_witness,
            )
            publish_receipt(
                self.dht, self.prefix, self._ledger_subkey(), receipt,
            )
            tele = telemetry.resolve(self.telemetry)
            if tele is not None:
                tele.counter("ledger.receipts").inc()
                # the full receipt rides the event (hex ids, cumulative
                # witness included), so an event-log-only fold reconstructs
                # the same supported totals the DHT fold would
                tele.event(
                    "ledger.receipt", round_id=round_id, leg=leg,
                    signer=receipt.signer, step=receipt.step,
                    members=receipt.members, weights=receipt.weights,
                    witness={
                        p: {"samples": e.samples, "rounds": e.rounds}
                        for p, e in receipt.witness.items()
                    },
                )
        except Exception as e:  # noqa: BLE001 — see docstring
            logger.warning(f"{round_id}: receipt publish failed: {e!r}")

    def publish_contribution_claim(
        self, samples: int, rounds: int, train_seconds: float,
        expiration: float = 300.0,
    ) -> None:
        """Publish this peer's cumulative ``ContributionClaim`` DHT record
        (schema-validated at every storing node; signature-bound when a
        signed subkey was given). ``samples``/``rounds`` come from the
        collaborative optimizer's cumulative counters; serve bytes read
        straight off the existing ckpt/state counters, so a provider's
        serving contribution needs no second bookkeeping."""
        bytes_served = 0
        tele = telemetry.resolve(self.telemetry)
        if tele is not None:
            bytes_served = int(
                tele.counter("ckpt.shard_bytes_served").value
                + tele.counter("state.served_bytes").value
            )
        try:
            claim = ContributionClaim(
                peer=self.peer_id.hex(),
                samples=int(samples),
                rounds=int(rounds),
                train_seconds=float(max(0.0, train_seconds)),
                bytes_served=bytes_served,
                time=get_dht_time(),
            )
            publish_claim(
                self.dht, self.prefix, self._ledger_subkey(), claim,
                expiration=expiration,
            )
        except Exception as e:  # noqa: BLE001 — accounting must never
            # cost a training step
            logger.warning(f"contribution claim publish failed: {e!r}")
            return
        if tele is not None:
            tele.counter("ledger.claims").inc()
            tele.event(
                "ledger.claim", peer=claim.peer, samples=claim.samples,
                rounds=claim.rounds,
                train_seconds=round(claim.train_seconds, 3),
                bytes_served=claim.bytes_served,
            )

    def publish_checkpoint_announcement(
        self, expiration: float = 60.0
    ) -> None:
        """Announce this peer's sharded checkpoint on the DHT catalog
        (schema-validated; signature-bound when a signed subkey was given).
        A full-state provider holds ALL shards, so ``shards`` is None."""
        if (
            self.checkpoint_shard_size <= 0
            or not self.allow_state_sharing
            or self.endpoint is None
        ):
            return
        try:
            built = self._sharded_state_sync()
        except ValueError as e:
            # tree not representable in the fp32 flat layout: blob-only peer
            # (_sharded_state_sync warned once at build time)
            logger.debug(f"sharded checkpoint serving unavailable: {e}")
            return
        if built is None:
            return
        manifest, _flat = built
        announcement = CheckpointAnnouncement(
            step=manifest.step,
            manifest_digest=manifest.digest(),
            num_shards=manifest.num_shards,
            endpoint=list(self.endpoint),
            shards=None,
        )
        publish_announcement(
            self.dht,
            self.prefix,
            self.signed_subkey or self.peer_id,
            announcement,
            expiration=expiration,
        )

    def publish_state_provider(
        self, expiration: float = 60.0, step: int = 0
    ) -> None:
        """Advertise this peer as a state provider, with its global step so
        joiners can prefer the NEWEST snapshot."""
        if not self.allow_state_sharing or self.endpoint is None:
            return
        self.dht.store(
            f"{self.prefix}_state_providers",
            {"endpoint": list(self.endpoint), "step": int(step)},
            get_dht_time() + expiration,
            subkey=self.peer_id,
        )
        # sharded serving rides the same publish cadence: the catalog
        # record carries the manifest digest, so building the sharded form
        # here (on the caller's backup thread, off the training path) also
        # pre-warms what the ckpt RPCs will serve
        self.publish_checkpoint_announcement(expiration=expiration)

    def fetch_state_schema(
        self, timeout: float = 15.0
    ) -> Optional[Dict[str, tuple]]:
        """{tensor name: shape} from any live state provider — the cheap
        (KB-sized) sibling of ``load_state_from_peers`` for peers that need
        only the tree's structure (aux template bootstrap)."""
        providers = self._live_state_providers()

        def _fetch(node):
            async def fetch():
                for ep in providers:
                    try:
                        reply = await self.client.call(
                            ep, "state.get", {"schema_only": True},
                            timeout=timeout,
                        )
                        return {
                            k: tuple(v) for k, v in reply["schema"].items()
                        }
                    except Exception as e:  # noqa: BLE001 — next provider
                        logger.debug(f"schema fetch from {ep} failed: {e!r}")
                return None

            return fetch()

        return self.dht.run_coroutine(_fetch)

    def _provider_records(self, entry_items) -> List[Tuple[int, tuple]]:
        """THE one parsing path for state-provider advertisements: skip our
        own record, extract (step, endpoint), drop malformed entries.
        ``_live_state_providers``, ``best_advertised_state_step`` and the
        in-loop retry refresh all derive from it, so the views cannot drift
        apart on a future record-format change (advisor r5). ``entry_items``
        is an iterable of (subkey, unpacked advertisement dict)."""
        records: List[Tuple[int, tuple]] = []
        for sk, value in entry_items:
            if sk == getattr(self, "peer_id", None):
                continue
            try:
                records.append(
                    (int(value.get("step", 0)), tuple(value["endpoint"]))
                )
            except Exception:  # noqa: BLE001 — malformed advertisement
                continue
        return records

    def _advertised_state_records(self) -> List[Tuple[int, tuple]]:
        """(step, endpoint) of every OTHER live provider, from the caller
        thread (blocking DHT lookup)."""
        entry = self.dht.get(f"{self.prefix}_state_providers", latest=True)
        if entry is None or not hasattr(entry.value, "items"):
            return []
        return self._provider_records(
            (sk, v.value) for sk, v in entry.value.items()
        )

    async def _advertised_state_records_async(
        self, node
    ) -> List[Tuple[int, tuple]]:
        """Same view, from ON the DHT loop (retry attempts refresh the
        provider list without a cross-thread round trip)."""
        entry = await node.get(
            f"{self.prefix}_state_providers".encode(), latest=True
        )
        items = []
        if entry is not None and hasattr(entry.value, "items"):
            for sk, v in entry.value.items():
                try:
                    items.append((sk, unpack_obj(v.value)))
                except Exception:  # noqa: BLE001 — undecodable entry
                    continue
        return self._provider_records(items)

    def _live_state_providers(self):
        candidates = self._advertised_state_records()
        # newest snapshot first — a stale provider must not win the race
        candidates.sort(key=lambda c: -c[0])
        return [ep for _step, ep in candidates]

    def _own_catalog_subkeys(self) -> tuple:
        return tuple(
            sk
            for sk in (getattr(self, "peer_id", None), self.signed_subkey)
            if sk is not None
        )

    def _catalog_records(self) -> List[CheckpointAnnouncement]:
        """Every OTHER peer's checkpoint-catalog announcement, from the
        caller thread (blocking DHT lookup)."""
        entry = self.dht.get(catalog_key(self.prefix), latest=True)
        if entry is None or not hasattr(entry.value, "items"):
            return []
        return parse_announcements(
            ((sk, v.value) for sk, v in entry.value.items()),
            own_subkeys=self._own_catalog_subkeys(),
        )

    async def _catalog_records_async(
        self, node
    ) -> List[CheckpointAnnouncement]:
        """Same view, from ON the DHT loop (the restore path runs there)."""
        entry = await node.get(catalog_key(self.prefix).encode(), latest=True)
        items = []
        if entry is not None and hasattr(entry.value, "items"):
            for sk, v in entry.value.items():
                try:
                    items.append((sk, unpack_obj(v.value)))
                except Exception:  # noqa: BLE001 — undecodable entry
                    continue
        return parse_announcements(
            items, own_subkeys=self._own_catalog_subkeys()
        )

    def best_advertised_state_step(self) -> Optional[int]:
        """Deepest global step any live provider ADVERTISES in its KB-sized
        DHT record (full-blob provider records AND checkpoint-catalog
        announcements) — lets a resumed peer decide whether a download
        could possibly be newer than its checkpoint without pulling the
        full multi-hundred-MB state. None when nobody shares."""
        steps = [step for step, _ep in self._advertised_state_records()]
        if self.checkpoint_shard_size > 0:
            steps += [a.step for a in self._catalog_records()]
        return max(steps) if steps else None

    async def _try_sharded_restore(
        self, node, tele, timeout: float, retries: int, backoff: float
    ) -> Optional[Tuple[Dict[str, Any], Dict[str, np.ndarray]]]:
        """Multi-peer sharded restore attempt (runs on the DHT loop). Any
        failure — no catalog, unobtainable manifest, a shard exhausting its
        ladder — returns None and the caller falls back to the full-blob
        path; the ``ckpt.restore`` span records the outcome either way."""
        announcements = await self._catalog_records_async(node)
        if not announcements:
            return None
        with telemetry.span(
            "ckpt.restore", self.telemetry, mode="sharded"
        ) as ctx:
            stats: Dict[str, Any] = {}
            try:
                metadata, tree, manifest = await sharded_restore(
                    self.client,
                    announcements,
                    parallelism=self.checkpoint_fetch_parallelism,
                    retries=retries,
                    backoff=backoff,
                    timeout=timeout,
                    store=self._ckpt_store,
                    max_providers=self.checkpoint_max_providers,
                    telemetry_registry=self.telemetry,
                    stats=stats,
                )
            except Exception as e:  # noqa: BLE001 — RestoreFailed et al.
                ctx["ok"] = False
                ctx["error"] = type(e).__name__
                if tele is not None:
                    tele.counter("ckpt.restore_failures").inc()
                logger.warning(
                    f"sharded restore failed ({e!r}); falling back to the "
                    "full-blob state path"
                )
                return None
            ctx["ok"] = True
            ctx["step"] = manifest.step
            ctx["shards"] = manifest.num_shards
            ctx["bytes"] = manifest.total_bytes
            # providers ACTUALLY pulled from (selected step/digest, capped),
            # not the raw announcement count with stale/outvoted peers in it
            ctx["providers"] = stats.get("providers", 0)
            if stats.get("provider_bytes"):
                # verified bytes per provider endpoint: which uplinks this
                # restore actually rode (fast-provider preference input)
                ctx["provider_bytes"] = stats["provider_bytes"]
            if tele is not None:
                tele.counter("ckpt.restores").inc()
            return metadata, tree

    def load_state_from_peers(
        self,
        timeout: float = 60.0,
        retries: Optional[int] = None,
        backoff: Optional[float] = None,
    ) -> Optional[Tuple[Dict[str, Any], Dict[str, np.ndarray]]]:
        """Download (metadata, tree) from a live state provider.

        Restore preference order (docs/fleet.md restart runbook): the
        SHARDED path first — when the checkpoint catalog announces a
        manifest, distinct shards are pulled from distinct providers in
        parallel with per-shard sha256 verification (checkpointing/fetcher)
        — then the single-provider full-blob ladder below as fallback.

        Peer-lifecycle robustness contract (``state_sync_retries`` /
        ``state_sync_backoff``): the download is retried with exponential
        backoff, each attempt re-reads the DHT provider list (a provider
        that registered between attempts is picked up) and prefers providers
        that have not already failed — so a dead or corrupt provider costs
        one backoff, not the whole join. When EVERY known provider has
        failed once, they are all retried anyway: a transient fault on the
        only provider must not permanently fail the sync. Each received
        snapshot is checksum-validated before deserialization, so a
        truncated or corrupt download is detected and retried instead of
        exploding mid-unpack (or silently adopting garbage)."""
        retries = self.state_sync_retries if retries is None else retries
        backoff = self.state_sync_backoff if backoff is None else backoff

        def _fetch(node):
            async def fetch():
                tele = telemetry.resolve(self.telemetry)
                if self.checkpoint_shard_size > 0:
                    result = await self._try_sharded_restore(
                        node, tele, timeout, retries, backoff
                    )
                    if result is not None:
                        return result
                failed: set = set()
                for attempt in range(retries + 1):
                    if attempt:
                        delay = backoff * (2 ** (attempt - 1))
                        if tele is not None:
                            # retry/backoff trace: the coordinator's retry-
                            # rate view is built from these counters
                            tele.counter("state_sync.retries").inc()
                            tele.event(
                                "state_sync.retry", attempt=attempt,
                                backoff_s=delay,
                            )
                        await asyncio.sleep(delay)
                    records = await self._advertised_state_records_async(node)
                    records.sort(key=lambda c: -c[0])  # newest first
                    providers = [ep for _step, ep in records]
                    untried = [ep for ep in providers if ep not in failed]
                    for ep in untried or providers:
                        try:
                            if tele is not None:
                                tele.counter("state_sync.attempts").inc()
                            reply = await self.client.call(
                                ep, "state.get", {}, timeout=timeout
                            )
                            blob = reply["state"]
                            digest = reply.get("checksum")
                            if (
                                digest is not None
                                and hashlib.sha256(blob).digest() != digest
                            ):
                                if tele is not None:
                                    tele.counter(
                                        "state_sync.checksum_failures"
                                    ).inc()
                                    tele.event(
                                        "state_sync.checksum_failure",
                                        provider=ep, attempt=attempt + 1,
                                        bytes=len(blob),
                                    )
                                raise ValueError(
                                    "state snapshot failed checksum "
                                    "(truncated or corrupt download)"
                                )
                            obj = unpack_obj(blob)
                            if tele is not None:
                                tele.counter("state_sync.ok").inc()
                                tele.event(
                                    "state_sync.ok", provider=ep,
                                    bytes=len(blob), attempt=attempt + 1,
                                )
                            return (
                                unpack_obj(obj["metadata"]),
                                deserialize_tree(obj["tree"]),
                            )
                        except Exception as e:  # noqa: BLE001 — next provider
                            failed.add(ep)
                            if tele is not None:
                                tele.counter("state_sync.failures").inc()
                                tele.event(
                                    "state_sync.failed", provider=ep,
                                    attempt=attempt + 1,
                                    error=type(e).__name__,
                                )
                            logger.debug(
                                f"state fetch from {ep} failed "
                                f"(attempt {attempt + 1}/{retries + 1}): {e!r}"
                            )
                return None

            return fetch()

        return self.dht.run_coroutine(_fetch)

    def shutdown(self) -> None:
        def _stop(node):
            async def stop():
                keepalive = getattr(self, "_relay_keepalive", None)
                if keepalive is not None:
                    keepalive.cancel()
                await self.client.close()
                if self.server is not None:
                    await self.server.stop()

            return stop()

        try:
            self.dht.run_coroutine(_stop)
        except Exception:  # noqa: BLE001 — best effort
            pass
