"""Named simulator scenarios + the sizing report.

A scenario is a JSON-able spec dict run to a REPORT dict — the numbers an
operator (or a test) needs before renting a fleet: how wide DHT records
actually replicate at N peers, how contended matchmaking leadership gets at
J concurrent joiners, how round-formation latency distributes, how big the
checkpoint catalog record grows per announcer. ``tools/swarm_sim.py`` is
the CLI face; ``tests/test_simulator.py`` asserts the report numbers
against scenario-level bounds.

Spec schema (docs/simulator.md):

    {
      "scenario": "mixed",          # dht_churn | matchmaking | catalog | mixed
      "seed": 0,                     # engine + network + churn seed
      "peers": 1000,                 # swarm size
      "link": {"latency_s": 0.02, "bandwidth_bps": 12500000.0,
               "loss": 0.0, "jitter_s": 0.0},
      "bucket_size": 8, "num_replicas": 5, "parallel_rpc": 3,
      ...scenario-specific keys (each runner documents its own)
    }

Every runner is deterministic for a fixed spec: scenario randomness comes
from ``random.Random(seed)``, peer ids/bootstrap choices hash off the same
seed, and the engine freezes scenario time.
"""
from __future__ import annotations

import asyncio
import hashlib
import json
import os
import random
import time
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional

from dedloc_tpu_torch.core.timeutils import get_dht_time
from dedloc_tpu_torch.simulator.engine import SIM_EPOCH, SimEngine
from dedloc_tpu_torch.simulator.network import LinkSpec, SimNetwork
from dedloc_tpu_torch.simulator.swarm import SimSwarm
from dedloc_tpu_torch.telemetry.links import endpoint_key
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


# the one shared nearest-rank percentile (utils/stats.py) — the twin
# fitter computes the identical statistic from dumped logs, and the two
# must never drift
from dedloc_tpu_torch.utils.stats import percentile  # noqa: F401 (re-export)


def _span_durations(swarm: SimSwarm, name: str,
                    ok_only: bool = True) -> List[float]:
    out = []
    for peer in swarm.peers:
        for record in peer.telemetry.events:
            if record.get("event") != name:
                continue
            if ok_only and record.get("ok") is not True:
                continue
            out.append(float(record.get("dur_s", 0.0)))
    return out


def record_fanout(swarm: SimSwarm, key: bytes) -> int:
    """How many live peers hold ``key`` in primary storage — the measured
    replica fan-out a sizing decision needs vs the configured
    ``num_replicas`` bound."""
    count = 0
    for peer in swarm.alive_peers():
        if peer.node.storage.get(key) is not None:
            count += 1
    return count


# --------------------------------------------------------------- harness


# scenarios whose subject is swarm-scale behavior (lookup fan-out, group
# contention, catalog load) — these spawn warm by default. Everything else
# (averaging fidelity, closed-loop adaptation, twin fitting, watchdog) is
# measuring signals the eager join protocol itself produces.
_WARM_BY_DEFAULT = frozenset(
    {"dht_churn", "matchmaking", "catalog", "mixed", "diurnal", "serving"}
)


class ScenarioRun:
    """Everything a scenario phase needs in one handle."""

    def __init__(self, spec: Dict[str, Any]):
        self.spec = dict(spec)
        self.seed = int(spec.get("seed", 0))
        self.rng = random.Random(self.seed ^ 0xC0FFEE)
        self.engine = SimEngine(seed=self.seed)
        self.network = SimNetwork(
            seed=self.seed, default_link=LinkSpec.from_dict(spec.get("link"))
        )
        self.swarm = SimSwarm(
            self.network,
            seed=self.seed,
            bucket_size=int(spec.get("bucket_size", 8)),
            num_replicas=int(spec.get("num_replicas", 5)),
            parallel_rpc=int(spec.get("parallel_rpc", 3)),
            request_timeout=float(spec.get("request_timeout", 5.0)),
            # swarm-scale scenarios hydrate warm by default: routing
            # tables are injected from the known topology instead of
            # paying per-peer bootstrap RPC storms. Fidelity/adaptation
            # scenarios keep the eager join protocol — their link tables
            # and re-plan triggers are FED by bootstrap-era traffic, so
            # skipping it would change the very signal they measure.
            # Spec {"warm_spawn": ...} overrides either default.
            warm_spawn=bool(spec.get(
                "warm_spawn", spec.get("scenario") in _WARM_BY_DEFAULT
            )),
        )
        self.report: Dict[str, Any] = {
            "scenario": spec.get("scenario"),
            "seed": self.seed,
            "peers": int(spec.get("peers", 100)),
        }


# --------------------------------------------------------------- phases
#
# Phases are composable coroutine builders: each takes (run, spec) and
# fills a section of run.report. The mixed scenario chains them over ONE
# swarm — churn from the DHT phase is still in effect when matchmaking
# starts, which is the point.


async def phase_spawn(run: ScenarioRun) -> None:
    n = int(run.spec.get("peers", 100))
    # real wall on purpose (the sizing report contrasts wall vs virtual)
    t0 = time.perf_counter()  # dedlint: disable=clock-monotonic
    v0 = run.engine.clock.offset
    await run.swarm.spawn(n, bootstrap_fanout=int(
        run.spec.get("bootstrap_fanout", 2)
    ))
    run.report["spawn"] = {
        "peers": n,
        "wall_s": round(  # real wall on purpose (wall vs virtual)
            time.perf_counter() - t0, 3  # dedlint: disable=clock-monotonic
        ),
        "virtual_s": round(run.engine.clock.offset - v0, 3),
    }


async def phase_dht(run: ScenarioRun) -> None:
    """Puts from scattered writers, churn a fraction of the swarm, then
    reads — measuring replica fan-out vs the ``num_replicas`` bound and
    get success under churn."""
    spec = run.spec
    puts = int(spec.get("puts", 40))
    churn_fraction = float(spec.get("churn_fraction", 0.2))
    swarm, rng = run.swarm, run.rng
    keys = [f"sim-record-{i:03d}".encode() for i in range(puts)]
    now = get_dht_time()
    stored = 0
    for i, key in enumerate(keys):
        writer = swarm.alive_peers()[
            rng.randrange(len(swarm.alive_peers()))
        ]
        if await writer.node.store(key, b"v-%d" % i, now + 3600.0):
            stored += 1
    fanout = [record_fanout(swarm, key) for key in keys]
    # churn: kill a seeded sample, all at once (mass-disconnect shape)
    victims = rng.sample(
        swarm.alive_peers(), int(len(swarm.alive_peers()) * churn_fraction)
    )
    for victim in victims:
        await swarm.kill(victim)
    await asyncio.sleep(1.0)  # virtual settling time
    hits = 0
    for i, key in enumerate(keys):
        reader = swarm.alive_peers()[
            rng.randrange(len(swarm.alive_peers()))
        ]
        entry = await reader.node.get(key, latest=True)
        if entry is not None and entry.value == b"v-%d" % i:
            hits += 1
    run.report["dht"] = {
        "puts": puts,
        "stored": stored,
        "replica_bound": swarm.num_replicas + 1,  # nearest set + self-store
        "fanout_mean": round(sum(fanout) / max(1, len(fanout)), 2),
        "fanout_max": max(fanout) if fanout else 0,
        "churned": len(victims),
        "get_hits": hits,
        "get_success": round(hits / max(1, puts), 3),
    }


async def phase_matchmaking(run: ScenarioRun) -> None:
    """R rounds of J concurrent joiners targeting ``group_size`` — the
    leader-contention measurement: do groups form without livelock, how
    many leaders fight per round, and the round-formation latency
    distribution."""
    spec = run.spec
    joiners = int(spec.get("joiners", 50))
    rounds = int(spec.get("rounds", 5))
    group_size = int(spec.get("group_size", 16))
    window = float(spec.get("window_s", 5.0))
    prefix = str(spec.get("prefix", "simexp"))
    swarm, rng = run.swarm, run.rng
    pool = [p for p in swarm.alive_peers()]
    participants = (
        pool if joiners >= len(pool) else rng.sample(pool, joiners)
    )
    for peer in participants:
        if peer.matchmaking is None:
            peer.attach_matchmaking(
                prefix, bandwidth=50.0 + (peer.index % 7) * 25.0,
                target_group_size=group_size,
                averaging_expiration=window,
            )
    formed: Dict[str, List[int]] = {}
    failures = 0
    for r in range(rounds):
        round_id = f"round-{r:04d}"
        active = [p for p in participants if p.alive]

        async def one(peer):
            try:
                return await peer.matchmaking.form_group(round_id)
            except Exception:  # noqa: BLE001 — counted, scenario continues
                return None

        groups = await asyncio.gather(*(one(p) for p in active))
        sizes = []
        seen_nonces = set()
        for g in groups:
            if g is None:
                failures += 1
            elif g.nonce not in seen_nonces:
                seen_nonces.add(g.nonce)
                sizes.append(len(g.members))
        formed[round_id] = sizes
        # advance past the leader-entry expirations so rounds stay disjoint
        await asyncio.sleep(window + 1.0)
    durs = _span_durations(swarm, "mm.form_group")
    all_sizes = [s for sizes in formed.values() for s in sizes]
    run.report["matchmaking"] = {
        "joiners": len(participants),
        "rounds": rounds,
        "groups_formed": len(all_sizes),
        "mean_group_size": round(
            sum(all_sizes) / max(1, len(all_sizes)), 2
        ),
        "full_groups": sum(1 for s in all_sizes if s >= group_size),
        "singletons": sum(1 for s in all_sizes if s == 1),
        "join_failures": int(swarm.counters_total("mm.join_failures")),
        "leader_changes": int(swarm.counters_total("mm.leader_changes")),
        "form_failures": failures,
        "formation_p50_s": round(percentile(durs, 0.50), 3),
        "formation_p95_s": round(percentile(durs, 0.95), 3),
    }


async def phase_catalog(run: ScenarioRun) -> None:
    """Announcers publish (some divergent) checkpoint manifests; a restorer
    must select the majority digest and complete a sharded multi-provider
    restore over the simulated links."""
    spec = run.spec
    announcers = int(spec.get("announcers", 8))
    divergent = int(spec.get("divergent", 2))
    step = int(spec.get("ckpt_step", 100))
    total_size = int(spec.get("ckpt_total_size", 4096))
    shard_size = int(spec.get("ckpt_shard_size", 512))
    prefix = str(spec.get("prefix", "simexp"))
    swarm, rng = run.swarm, run.rng
    alive = swarm.alive_peers()
    if len(alive) < 2:
        raise ValueError(
            f"catalog phase needs >= 2 live peers (an announcer and a "
            f"restorer); {len(alive)} alive — raise 'peers' or lower churn"
        )
    # clamp: at least one non-provider must remain to play the restorer
    # (reachable from the CLI with e.g. peers=8, announcers=8)
    announcers = min(announcers, len(alive) - 1)
    providers = rng.sample(alive, announcers)
    majority_digest = None
    for i, peer in enumerate(providers):
        variant = 1 if i < divergent else 0  # minority forks first
        digest = peer.serve_checkpoint(
            step, total_size=total_size, shard_size=shard_size,
            variant=variant,
        )
        if variant == 0:
            majority_digest = digest
        ok = await peer.announce_checkpoint(prefix)
        if not ok:
            logger.warning(f"catalog announce failed for {peer.label}")
    from dedloc_tpu_torch.checkpointing.catalog import (
        catalog_key,
        parse_announcements,
        select_target,
    )
    from dedloc_tpu_torch.checkpointing.fetcher import sharded_restore

    reader = rng.choice(
        [p for p in swarm.alive_peers() if p not in providers]
    )
    entry = await reader.node.get(catalog_key(prefix).encode(), latest=True)
    items = (
        [(sk, v.value) for sk, v in entry.value.items()]
        if entry is not None and hasattr(entry.value, "items")
        else []
    )
    announcements = parse_announcements(items)
    # sizing: the ACTUAL stored/wire size — the same msgpack codec the DHT
    # store path uses, not a Python repr approximation
    from dedloc_tpu_torch.core.serialization import pack_obj

    catalog_bytes = sum(
        len(pack_obj(a.model_dump())) for a in announcements
    )
    target = select_target(announcements)
    restored_ok = False
    providers_used = 0
    if target is not None:
        stats: Dict[str, Any] = {}
        try:
            _meta, tree, manifest = await sharded_restore(
                reader.node.client,
                announcements,
                parallelism=int(spec.get("fetch_parallelism", 4)),
                telemetry_registry=reader.telemetry,
                stats=stats,
            )
            restored_ok = (
                manifest.digest() == majority_digest
                and "sim_state" in tree
            )
            providers_used = int(stats.get("providers", 0))
        except Exception as e:  # noqa: BLE001 — reported, not raised
            logger.warning(f"sim restore failed: {e!r}")
    run.report["catalog"] = {
        "announcers": announcers,
        "divergent": divergent,
        "parsed_announcements": len(announcements),
        "selected_majority": bool(
            target is not None and target[1] == majority_digest
        ),
        "restore_ok": restored_ok,
        "providers_used": providers_used,
        "catalog_record_bytes": catalog_bytes,
        "bytes_per_announcer": (
            round(catalog_bytes / max(1, len(announcements)))
        ),
    }


# --------------------------------------------------- averaging workload
#
# The synthetic averaging-round traffic generator: real matchmaking over
# the simulated transport, then real chunked wire exchanges between group
# members — scatter chunks serialized per destination, reduced-chunk
# gather replies pipelined behind them (the PR 3 wire shape) — emitting
# the PRODUCTION telemetry schema (mm.form_group / avg.round /
# allreduce.link / link.stats / step.record / opt.overlap_ledger). It is
# both a sizing scenario in its own right (round-wall numbers for a
# hypothetical network) and the workload the telemetry-fitted digital
# twin (dedloc_tpu/twin) replays: the same driver runs the SOURCE
# scenario and the twin's prediction, so twin fidelity measures the
# quality of the telemetry -> model fit, not a modeling shortcut.


def apply_link_overrides(network: SimNetwork, hosts: List[str],
                         overrides) -> int:
    """Apply spec-level per-directed-link overrides (the ``links`` spec
    key): ``[{"src": host|"*", "dst": host|"*", latency_s?, bandwidth_bps?,
    loss?, jitter_s?}, ...]``. ``"*"`` spans every host; omitted fields
    inherit the network DEFAULT link (not the LinkSpec defaults). Returns
    how many directed links were configured."""
    count = 0
    base = network.default_link
    for raw in overrides or []:
        raw = dict(raw)
        src = str(raw.pop("src", "*"))
        dst = str(raw.pop("dst", "*"))
        spec = LinkSpec(
            latency_s=float(raw.get("latency_s", base.latency_s)),
            bandwidth_bps=float(raw.get("bandwidth_bps", base.bandwidth_bps)),
            loss=float(raw.get("loss", base.loss)),
            jitter_s=float(raw.get("jitter_s", base.jitter_s)),
        )
        for s in (hosts if src == "*" else [src]):
            for d in (hosts if dst == "*" else [dst]):
                if s != d:
                    network.set_link(s, d, spec)
                    count += 1
    return count


def _compute_for(spec: Dict[str, Any], peer) -> float:
    """Per-peer fwd+bwd seconds per boundary. ``compute_s`` is a float (a
    homogeneous swarm, optionally skewed deterministically per peer via
    ``compute_skew``) or a ``{label: seconds}`` map (a twin replay's fitted
    per-peer compute)."""
    compute = spec.get("compute_s", 0.05)
    if isinstance(compute, dict):
        values = [float(v) for v in compute.values()] or [0.05]
        return float(compute.get(peer.label, sum(values) / len(values)))
    return float(compute) * (
        1.0 + float(spec.get("compute_skew", 0.0)) * (peer.index % 4)
    )


async def run_averaging_workload(swarm: SimSwarm,
                                 spec: Dict[str, Any],
                                 on_round: Optional[Callable] = None,
                                 control: Optional[Dict[str, Any]] = None,
                                 ) -> Dict[str, Any]:
    """Drive ``avg_rounds`` averaging rounds over ``swarm`` and return the
    measured report section. Spec keys (all optional)::

        avg_rounds: 4          # rounds to run
        group_size: 8          # matchmaking target
        span_bytes: 98304      # wire payload per DIRECTED link per round
        chunk_bytes: 24576     # scatter/gather chunk size
        boundaries: 2          # accumulation boundaries per round
        samples_per_boundary: 16
        compute_s: 0.05        # float (+compute_skew) or {label: seconds}
        overlap: false         # accumulate DURING the round vs before it
        window_s: 5.0          # averaging_expiration for matchmaking
        rpc_timeout_s: 120.0
        restore_bytes: 0       # >0: one sharded catalog restore at the end
        restore_providers: 4
        fetch_parallelism: 4
        faults: []             # scripted mid-run faults, each fired at the
                               # START of its round:
                               #   {"kind": "link", "at_round": r,
                               #    "src": host, "dst": host,
                               #    bandwidth_bps/latency_s/loss/jitter_s}
                               #     (omitted fields inherit the network
                               #      default; a second fault with healthy
                               #      numbers restores the link;
                               #      "reset_connections": true also kills
                               #      the pair's pooled flows — the
                               #      route-flap shape whose reconnects
                               #      re-sample the link RTT)
                               #   {"kind": "straggler", "at_round": r,
                               #    "peer": label, "factor": 8.0}
                               #   {"kind": "churn", "at_round": r,
                               #    "peers": [labels] | "count": n}

    Every member's exchange opens an ``avg.round`` span, feeds the link
    estimator per scatter chunk, and emits one ``allreduce.link`` event
    per remote hop — the event-log schema production peers write, so the
    twin fitter (and --topology/--steps) consume the dump unchanged.
    ``on_round(r)`` (optional coroutine) runs after each round completes —
    the watchdog scenario's coordinator-fold hook.

    ``control`` (optional) is the LIVE control surface for the closed-loop
    scenario: a mutable dict the ``on_round`` hook may update between
    rounds — ``plan`` (a label-keyed ``TopologyPlan`` or None), ``enabled``
    (run the plan vs account-only), ``chunk_bytes``. Each round re-reads it
    before forming groups, mirroring the runtime averager's between-rounds
    plan adoption (``maybe_refresh_plan``): a plan swap is just a new
    matchmaking scope on the next round, no barrier. The initial values
    seed from the spec, so a plain workload behaves exactly as before."""
    rounds = int(spec.get("avg_rounds", 4))
    group_size = int(spec.get("group_size", 8))
    span_bytes = max(1024, int(spec.get("span_bytes", 98304)))
    chunk_bytes = max(1024, int(spec.get("chunk_bytes", 24576)))
    boundaries = max(1, int(spec.get("boundaries", 2)))
    samples_per_boundary = int(spec.get("samples_per_boundary", 16))
    overlap = bool(spec.get("overlap", False))
    window = float(spec.get("window_s", 5.0))
    rpc_timeout = float(spec.get("rpc_timeout_s", 120.0))
    prefix = str(spec.get("prefix", "twinexp"))
    participants = swarm.alive_peers()
    if len(participants) < 2:
        raise ValueError("averaging workload needs >= 2 live peers")

    # two-level (hierarchical) topology — the ``topology`` spec key::
    #
    #     topology:
    #       cliques: [[label, ...], ...]   # explicit member groups, or
    #       clique_size: 16                # auto-chunk the roster
    #       enabled: true                  # false = run FLAT but keep the
    #                                      #   plan for WAN-byte accounting
    #
    # The plan comes from the SAME planner the runtime averager installs
    # (averaging/topology.plan_from_groups), so the simulator sizes exactly
    # the hierarchy production would run. With ``enabled`` the round shape
    # becomes: clique members exchange over their (cheap) local links under
    # a clique-scoped matchmaking group, delegates carry one span over the
    # WAN among themselves, then members pull the fanned-out result from
    # their delegate. ``enabled: false`` classifies the flat run's bytes
    # against the same partition — the WAN-savings baseline.
    from dedloc_tpu_torch.averaging.topology import plan_from_groups

    topo_spec = spec.get("topology") or None
    plan = None
    hier_enabled = False
    if topo_spec:
        labels = [p.label for p in participants]
        if topo_spec.get("cliques"):
            groups = [list(g) for g in topo_spec["cliques"]]
        else:
            size = max(1, int(topo_spec.get("clique_size", 16)))
            groups = [labels[i:i + size] for i in range(0, len(labels), size)]
        plan = plan_from_groups(groups, reason="simulator spec")
        hier_enabled = (
            bool(topo_spec.get("enabled", True))
            and plan.mode == "hierarchical"
        )
    peer_by_label = {p.label: p for p in participants}

    # live control surface (see docstring): one_round re-reads this dict,
    # so the closed-loop controller can swap the plan / retune chunk_bytes
    # between rounds exactly like runtime peers adopting a new plan record
    live = control if control is not None else {}
    live.setdefault("plan", plan)
    live.setdefault(
        "enabled",
        bool(topo_spec.get("enabled", True)) if topo_spec else True,
    )
    live.setdefault("chunk_bytes", chunk_bytes)
    live.setdefault("overlap", overlap)

    # scripted mid-run faults (the watchdog scenario's levers): applied at
    # the START of their round, so detection-latency assertions can count
    # folds from a known onset
    faults = [dict(f) for f in (spec.get("faults") or [])]
    compute_scale: Dict[str, float] = {}

    def _scaled_compute(peer) -> float:
        return _compute_for(spec, peer) * compute_scale.get(
            peer.label, 1.0
        )

    async def apply_faults(r: int) -> None:
        base = swarm.network.default_link
        for f in faults:
            if int(f.get("at_round", -1)) != r:
                continue
            kind = str(f.get("kind", ""))
            if kind == "link":
                swarm.network.set_link(
                    str(f["src"]), str(f["dst"]),
                    LinkSpec(
                        latency_s=float(
                            f.get("latency_s", base.latency_s)
                        ),
                        bandwidth_bps=float(
                            f.get("bandwidth_bps", base.bandwidth_bps)
                        ),
                        loss=float(f.get("loss", base.loss)),
                        jitter_s=float(f.get("jitter_s", base.jitter_s)),
                    ),
                )
                if f.get("reset_connections"):
                    # route-flap flavor: the latency change also kills the
                    # pooled flows on the pair, so reconnects RE-SAMPLE the
                    # link RTT — without this, connect-time RTT estimates
                    # (and the re-planner's clique detection reading them)
                    # stay blind to the change, exactly as in production
                    swarm.network.reset_links(str(f["src"]), str(f["dst"]))
            elif kind == "straggler":
                compute_scale[str(f["peer"])] = float(
                    f.get("factor", 4.0)
                )
            elif kind == "churn":
                named = set(f.get("peers") or [])
                victims = [
                    p for p in participants if p.alive and p.label in named
                ]
                if not victims and f.get("count"):
                    # deterministic: the highest-indexed alive peers die
                    victims = [p for p in participants if p.alive][
                        -int(f["count"]):
                    ]
                for victim in victims:
                    await swarm.kill(victim)
            else:
                raise ValueError(f"unknown fault kind {kind!r}")

    async def _part(_peer, _args):
        return {"ok": True}

    async def _reduced(_peer, args):
        # the reduced-chunk gather reply: a chunk-sized payload riding the
        # server's uplink back to the requester (the pipelined gather leg)
        return {"data": b"\x00" * int(args["size"])}

    async def _final(_peer, args):
        # hierarchical fan-out: a clique member pulls the round's final
        # vector from its delegate (the averager's avg.final contract)
        return {"data": b"\x00" * int(args["size"])}

    for peer in participants:
        if peer.matchmaking is None or (
            peer.matchmaking.target_group_size != group_size
        ):
            peer.attach_matchmaking(
                prefix, bandwidth=100.0, target_group_size=group_size,
                averaging_expiration=window,
            )
        peer.node.server.register("avg.part", _part)
        peer.node.server.register("avg.get_reduced", _reduced)
        peer.node.server.register("avg.final", _final)
        # endpoint self-identification, same as production logs: lets any
        # consumer (twin fitter, --topology) resolve link dst -> label
        peer.telemetry.event(
            "peer.endpoint", endpoint=endpoint_key(peer.endpoint)
        )
        # the run's CONFIG, recorded like a production role logs its
        # flags: a twin fitted from these logs reads the workload shape
        # exactly instead of inferring it (every peer carries a copy so
        # any log subset suffices)
        peer.telemetry.event(
            "run.config", window_s=window, group_size=group_size,
            span_bytes=span_bytes, chunk_bytes=chunk_bytes,
            boundaries=boundaries,
            samples_per_boundary=samples_per_boundary, overlap=overlap,
            # the wire payloads above are raw bytes: a twin fitted from
            # this run knows its compression baseline instead of assuming
            compression=str(spec.get("compression", "none")),
        )

    loop = asyncio.get_event_loop()
    link_acc: Dict[Any, Dict[str, float]] = {}  # (src, dst_host) -> sums
    member_walls: List[float] = []  # every member's wall, every round
    round_walls: List[float] = []  # per-round slowest member (the ledger)
    per_peer_walls: Dict[str, List[float]] = {}
    ledger = {"hidden": 0.0, "exposed": 0.0}
    groups_formed = 0
    formed_sizes: List[int] = []  # every formed group's size (unique nonce)
    exchange_failures = 0
    round_modes: List[str] = []  # per-round topology mode actually run

    async def one_link(peer, endpoint, round_id) -> None:
        """One directed link's chunked scatter + pipelined gather — the
        flat member exchange and both hierarchical legs all ride this."""
        tele = peer.telemetry
        # chunk geometry re-read per link so a mid-run retune (the
        # closed-loop controller's chunk_bytes actuation) takes effect on
        # the next round, like the averager re-reading self.chunk_size
        cb = max(1024, int(live["chunk_bytes"]))
        acc = {"sent_bytes": 0.0, "recv_bytes": 0.0, "chunks_sent": 0.0,
               "chunks_recv": 0.0, "send_s": 0.0, "wait_s": 0.0,
               "max_chunk_s": 0.0}
        gathers = []

        async def gather_chunk(c: int, size: int) -> None:
            g0 = loop.time()
            reply = await peer.node.client.call(
                endpoint, "avg.get_reduced",
                {"round_id": round_id, "chunk": c, "size": size},
                timeout=rpc_timeout,
            )
            dt = loop.time() - g0
            acc["recv_bytes"] += len(reply["data"])
            acc["chunks_recv"] += 1
            acc["wait_s"] += dt
            acc["max_chunk_s"] = max(acc["max_chunk_s"], dt)

        try:
            for c, off in enumerate(range(0, span_bytes, cb)):
                size = min(cb, span_bytes - off)
                s0 = loop.time()
                await peer.node.client.call(
                    endpoint, "avg.part",
                    {"round_id": round_id, "sender": peer.label,
                     "chunk": c, "data": b"\x00" * size},
                    timeout=rpc_timeout,
                )
                dt = max(loop.time() - s0, 1e-9)
                # the persistent estimator eats the scatter timing, the
                # same seam production allreduce feeds
                tele.links().observe_transfer(endpoint, size, dt)
                acc["sent_bytes"] += size
                acc["chunks_sent"] += 1
                acc["send_s"] += dt
                acc["max_chunk_s"] = max(acc["max_chunk_s"], dt)
                # the reduced chunk streams back while later chunks are
                # still being scattered — the pipelined gather
                gathers.append(
                    asyncio.ensure_future(gather_chunk(c, size))
                )
            await asyncio.gather(*gathers)
        finally:
            # a scatter failure leaves gather tasks in flight: cancel
            # and DRAIN them, or their connection-reset exceptions land
            # as "never retrieved" warnings on the loop
            for g in gathers:
                g.cancel()
            if gathers:
                await asyncio.gather(*gathers, return_exceptions=True)
            key = (peer.label, str(endpoint[0]))
            swarm_acc = link_acc.setdefault(
                key, {"bytes": 0.0, "send_s": 0.0}
            )
            swarm_acc["bytes"] += acc["sent_bytes"]
            swarm_acc["send_s"] += acc["send_s"]
            tele.event(
                "allreduce.link", round_id=round_id,
                dst=endpoint_key(endpoint),
                sent_bytes=int(acc["sent_bytes"]),
                recv_bytes=int(acc["recv_bytes"]),
                chunks_sent=int(acc["chunks_sent"]),
                chunks_recv=int(acc["chunks_recv"]),
                send_s=round(acc["send_s"], 6),
                wait_s=round(acc["wait_s"], 6),
                max_chunk_s=round(acc["max_chunk_s"], 6),
            )

    def _record_wall(peer, wall: float) -> None:
        member_walls.append(wall)
        per_peer_walls.setdefault(peer.label, []).append(wall)
        # the member's wire wall IS its avg_wire step phase: the snapshot
        # then carries step.phase.avg_wire.mean/count next to fwd_bwd, so
        # a health fold over sim peers attributes wire-bound vs
        # compute-bound exactly like a production flight-recorder peer
        peer.telemetry.histogram("step.phase.avg_wire").observe(wall)

    async def member_exchange(peer, others, round_id) -> Optional[float]:
        """One member's wire work for one flat round. Returns the member's
        exchange wall in virtual seconds, or None when a link failed."""
        nonlocal exchange_failures
        tele = peer.telemetry
        # walls on the peer telemetry's own clock (virtual under the sim
        # engine) — the report's round walls and the dumped avg.round
        # spans a fitter reads must agree
        t0 = tele.clock()
        with tele.span(
            "avg.round", trace_seed=round_id, round_id=round_id,
            group_size=len(others) + 1,
        ) as ctx:
            results = await asyncio.gather(
                *(one_link(peer, ep, round_id) for _label, ep in others),
                return_exceptions=True,
            )
            failures = [r for r in results if isinstance(r, Exception)]
            ctx["ok"] = not failures
            if failures:
                ctx["error"] = type(failures[0]).__name__
                exchange_failures += len(failures)
                return None
        wall = tele.clock() - t0
        _record_wall(peer, wall)
        return wall

    async def hier_exchange(peer, asn, cg, wg, clique_done,
                            round_id) -> Optional[float]:
        """One peer's TWO-LEVEL wire work: the clique leg over (cheap)
        local links, then either the WAN leg among delegates (delegate
        role) or the fan-out pull from the delegate (member role — waits
        for its clique's WAN leg to land first, the real serialization).
        Emits the same avg.round / allreduce.link telemetry schema as the
        flat exchange, plus avg.topology.round, so --topology and the twin
        fitter consume the dump unchanged."""
        nonlocal exchange_failures
        tele = peer.telemetry
        clique = asn.clique
        is_delegate = peer.label == clique.delegate
        my_ep = tuple(peer.endpoint)
        done = clique_done.setdefault(clique.key(), asyncio.Event())
        t0 = tele.clock()
        with tele.span(
            "avg.round", trace_seed=round_id, round_id=round_id,
            group_size=len(cg.members) if cg is not None else 1,
        ) as ctx:
            try:
                if cg is not None and len(cg.members) > 1:
                    others = [
                        tuple(m.endpoint) for m in cg.members
                        if m.endpoint is not None
                        and tuple(m.endpoint) != my_ep
                    ]
                    await asyncio.gather(
                        *(one_link(peer, ep, round_id) for ep in others)
                    )
                if is_delegate:
                    if wg is not None and len(wg.members) > 1:
                        others = [
                            tuple(m.endpoint) for m in wg.members
                            if m.endpoint is not None
                            and tuple(m.endpoint) != my_ep
                        ]
                        await asyncio.gather(
                            *(one_link(peer, ep, round_id) for ep in others)
                        )
                    done.set()
                else:
                    # the fan-out is data-dependent on the WAN leg: wait
                    # for the delegate to land, then pull the final vector
                    await asyncio.wait_for(done.wait(), timeout=rpc_timeout)
                    delegate_peer = peer_by_label.get(clique.delegate)
                    if delegate_peer is None or not delegate_peer.alive:
                        raise ConnectionResetError("delegate dead")
                    g0 = loop.time()
                    reply = await peer.node.client.call(
                        tuple(delegate_peer.endpoint), "avg.final",
                        {"round_id": round_id, "size": span_bytes},
                        timeout=rpc_timeout,
                    )
                    # the fan-out payload rides the delegate->member link
                    acc = link_acc.setdefault(
                        (clique.delegate, str(peer.host)),
                        {"bytes": 0.0, "send_s": 0.0},
                    )
                    acc["bytes"] += len(reply["data"])
                    acc["send_s"] += max(loop.time() - g0, 1e-9)
                ctx["ok"] = True
                tele.event(
                    "avg.topology.round", round_id=round_id,
                    role="delegate" if is_delegate else "member",
                    clique_size=len(cg.members) if cg is not None else 1,
                    wan_size=len(wg.members) if wg is not None else 0,
                    ok=True,
                )
            except Exception as e:  # noqa: BLE001 — counted, round goes on
                ctx["ok"] = False
                ctx["error"] = type(e).__name__
                exchange_failures += 1
                if is_delegate:
                    done.set()  # a dead WAN leg must not park the clique
                return None
        wall = tele.clock() - t0
        _record_wall(peer, wall)
        return wall

    # first/last boundary stamps: the samples/sec window. Defined over the
    # boundary RECORDS (not the phase's whole duration) so a fitter reading
    # only the dumped step.record events computes the identical rate.
    stamps = {"first": None, "last": None, "samples": 0.0}

    async def accumulate(peer, r: int) -> None:
        tele = peer.telemetry
        compute = _scaled_compute(peer)
        for b in range(boundaries):
            await asyncio.sleep(compute)
            tele.histogram("step.phase.fwd_bwd").observe(compute)
            tele.event(
                "step.record", step=r * boundaries + b,
                dur_s=round(compute, 6), samples=samples_per_boundary,
                phases={"fwd_bwd": round(compute, 6)}, untimed_s=0.0,
            )
            now = get_dht_time()
            if stamps["first"] is None:
                stamps["first"] = now
            stamps["last"] = now
            stamps["samples"] += samples_per_boundary

    async def one_round(r: int) -> None:
        round_id = f"avground-{r:04d}"
        await apply_faults(r)
        alive = [p for p in participants if p.alive]
        # the round's topology comes from the LIVE control dict: the
        # closed-loop controller may have re-planned since last round
        plan_r = live.get("plan")
        mode_r = "flat"
        if plan_r is not None and live.get("enabled", True):
            if plan_r.mode in ("hierarchical", "gossip"):
                mode_r = plan_r.mode
        round_modes.append(mode_r)
        # overlap is an actuation knob (ACTUATION_KEYS): a retune may flip
        # it mid-run, so the round reads the live value, not the spec's
        ov_r = bool(live.get("overlap", overlap))
        acc_task = asyncio.gather(*(accumulate(p, r) for p in alive))
        if not ov_r:
            # synchronous boundary: accumulate, THEN average on the
            # critical path
            await acc_task

        exchanges = []
        seen_nonces = set()

        def _count_group(group) -> None:
            nonlocal groups_formed
            if group is not None and group.nonce not in seen_nonces:
                seen_nonces.add(group.nonce)
                formed_sizes.append(len(group.members))
                if len(group.members) >= 2:
                    groups_formed += 1

        if mode_r == "hierarchical":
            # two-level round: clique-scoped groups assemble concurrently
            # with (and invisible to) the delegates' WAN group, so 200
            # concurrent joiners contend inside bounded cliques instead of
            # one flat all-pairs melee. Scopes are epoch-qualified via the
            # plan (TopologyPlan.clique_scope/wan_scope), mirroring the
            # runtime averager's mixed-version rollout isolation.
            alive_labels = {p.label for p in alive}
            n_cliques = len(plan_r.cliques)
            clique_done: Dict[str, asyncio.Event] = {}

            async def form_hier(peer):
                asn = plan_r.assignment(peer.label)
                clique = asn.clique
                cg = wg = None
                local = sum(
                    1 for label in clique.members if label in alive_labels
                )
                try:
                    # both rosters are known from the PLAN (not from each
                    # other), so a delegate rendezvouses in its clique
                    # scope and the WAN scope concurrently — the leader
                    # handshake latency is paid once, not twice
                    joins = []
                    if local > 1:
                        joins.append(peer.matchmaking.form_group(
                            round_id, expected_size=local,
                            scope=plan_r.clique_scope(clique),
                        ))
                    if peer.label == clique.delegate:
                        joins.append(peer.matchmaking.form_group(
                            round_id, expected_size=n_cliques,
                            scope=plan_r.wan_scope(),
                        ))
                    groups = await asyncio.gather(*joins)
                    if local > 1:
                        cg = groups[0]
                    if peer.label == clique.delegate:
                        wg = groups[-1]
                except Exception:  # noqa: BLE001 — skipped this round
                    return peer, asn, None, None, True
                return peer, asn, cg, wg, False

            formed = await asyncio.gather(*(form_hier(p) for p in alive))
            for peer, asn, cg, wg, failed in formed:
                _count_group(cg)
                _count_group(wg)
                if failed:
                    continue
                exchanges.append(
                    hier_exchange(peer, asn, cg, wg, clique_done, round_id)
                )
        elif mode_r == "gossip":
            # gossip round: every peer averages inside its deterministic
            # neighbor group (TopologyPlan.gossip_groups — derived from
            # the shared round id, no coordination message), under the
            # group's own matchmaking scope. A group whose partner died is
            # skipped — that locality is gossip's whole point: one flaky
            # peer costs its pair a round, never the swarm's round.
            alive_labels = {p.label for p in alive}

            async def form_gossip(peer, expected, scope):
                try:
                    return peer, await peer.matchmaking.form_group(
                        round_id, expected_size=expected, scope=scope,
                    )
                except Exception:  # noqa: BLE001 — skipped this round
                    return peer, None

            joins = []
            for members in plan_r.gossip_groups(round_id):
                present = [m for m in members if m in alive_labels]
                if len(present) < 2:
                    continue
                scope = plan_r.gossip_scope(members)
                joins.extend(
                    form_gossip(peer_by_label[m], len(present), scope)
                    for m in present
                )
            formed = await asyncio.gather(*joins)
            for peer, group in formed:
                if group is None:
                    continue
                _count_group(group)
                if len(group.members) < 2 or peer.endpoint is None:
                    continue
                my_ep = tuple(peer.endpoint)
                others = [
                    (m.peer_id, tuple(m.endpoint)) for m in group.members
                    if m.endpoint is not None and tuple(m.endpoint) != my_ep
                ]
                if others:
                    exchanges.append(
                        member_exchange(peer, others, round_id)
                    )
        else:
            async def form(peer):
                try:
                    return peer, await peer.matchmaking.form_group(round_id)
                except Exception:  # noqa: BLE001 — counted via group=None
                    return peer, None

            formed = await asyncio.gather(*(form(p) for p in alive))
            for peer, group in formed:
                if group is None:
                    continue
                _count_group(group)
                if len(group.members) < 2 or peer.endpoint is None:
                    continue
                my_ep = tuple(peer.endpoint)
                others = [
                    (m.peer_id, tuple(m.endpoint)) for m in group.members
                    if m.endpoint is not None and tuple(m.endpoint) != my_ep
                ]
                if not others:
                    continue
                exchanges.append(member_exchange(peer, others, round_id))
        walls = [w for w in await asyncio.gather(*exchanges)
                 if w is not None]
        if ov_r:
            await acc_task
        if walls:
            round_wall = max(walls)
            round_walls.append(round_wall)
            accum_wall = max(
                _scaled_compute(p) * boundaries for p in alive
            )
            hidden = min(round_wall, accum_wall) if ov_r else 0.0
            exposed = round_wall - hidden
            ledger["hidden"] += hidden
            ledger["exposed"] += exposed
            alive[0].telemetry.event(
                "opt.overlap_ledger", round_id=round_id,
                mode="overlap" if ov_r else "sync",
                hidden_s=round(hidden, 6), exposed_s=round(exposed, 6),
                efficiency=round(hidden / max(round_wall, 1e-9), 4),
            )
        if on_round is not None:
            # the coordinator-fold hook (watchdog scenario): runs while
            # the round's telemetry is fresh, before the window idles
            await on_round(r)
        # let leader-entry expirations clear so rounds stay disjoint
        await asyncio.sleep(window + 1.0)

    t_start = get_dht_time()
    for r in range(rounds):
        await one_round(r)
    report: Dict[str, Any] = {
        "rounds": rounds,
        "group_size": group_size,
        "span_bytes": span_bytes,
        "chunk_bytes": chunk_bytes,
        "boundaries": boundaries,
        "samples_per_boundary": samples_per_boundary,
        "overlap": overlap,
        "groups_formed": groups_formed,
        "exchange_failures": exchange_failures,
        # per-round topology mode actually run (the closed-loop scenario's
        # re-plan timeline evidence; constant for plain workloads)
        "round_modes": round_modes,
        # every formed group's size (unique nonce, singletons INCLUDED —
        # the flat-collapse signal is exactly the singleton flood)
        "groups_total": len(formed_sizes),
        "singleton_groups": sum(1 for s in formed_sizes if s == 1),
        "group_size_median": (
            percentile([float(s) for s in formed_sizes], 0.50)
            if formed_sizes else 0.0
        ),
    }
    duration = max(get_dht_time() - t_start, 1e-9)
    report["duration_s"] = round(duration, 3)
    # percentiles over every MEMBER's wall of every round (not per-round
    # maxima): ~group_size more samples, so the estimate does not swing on
    # which group happened to draw the slowest peer in a short run — and
    # the twin fitter computes the identical statistic from avg.round spans
    report["round_wall_p50_s"] = round(percentile(member_walls, 0.50), 4)
    report["round_wall_p95_s"] = round(percentile(member_walls, 0.95), 4)
    report["per_peer_round_wall_s"] = {
        label: round(sum(walls) / len(walls), 4)
        for label, walls in sorted(per_peer_walls.items())
    }
    durs = _span_durations(swarm, "mm.form_group")
    report["formation_p50_s"] = round(percentile(durs, 0.50), 4)
    report["formation_p95_s"] = round(percentile(durs, 0.95), 4)
    # swarm-wide samples/sec over the first->last boundary-record window —
    # the SAME definition the twin fitter computes from dumped step.record
    # events, so observed and predicted rates are like-for-like. A window
    # under 1 ms (a 1-round x 1-boundary workload whose stamps differ only
    # by engine tie-break epsilons) is below the stamp resolution: report
    # None, not a ~1e8 garbage rate a sweep would happily rank by.
    if (
        stamps["first"] is not None
        and stamps["last"] - stamps["first"] > 1e-3
    ):
        report["samples_per_sec"] = round(
            stamps["samples"] / (stamps["last"] - stamps["first"]), 3
        )
    else:
        report["samples_per_sec"] = None
    total_ledger = ledger["hidden"] + ledger["exposed"]
    report["overlap_efficiency"] = (
        round(ledger["hidden"] / total_ledger, 4) if total_ledger else None
    )
    # observed per-link wire rate, worst first — the ranking a fitted twin
    # must reproduce (src/dst are host labels)
    worst = sorted(
        (
            (src, dst, acc["bytes"] / max(acc["send_s"], 1e-9))
            for (src, dst), acc in link_acc.items()
            if acc["bytes"] > 0
        ),
        key=lambda item: item[2],
    )
    report["worst_links"] = [
        [src, dst, round(bps, 1)] for src, dst, bps in worst[:10]
    ]
    if plan is not None:
        # WAN-vs-local byte split against the plan's partition — computed
        # for the hierarchical run AND (enabled: false) the flat baseline
        # of the same spec, so the savings ratio compares like for like
        wan = local = 0.0
        wan_by_src: Dict[str, float] = {}
        for (src, dst), acc in link_acc.items():
            b = float(acc["bytes"])
            if plan.same_clique(str(src), str(dst)):
                local += b
            else:
                wan += b
                wan_by_src[str(src)] = wan_by_src.get(str(src), 0.0) + b
        delegates = set(plan.delegates)
        nondelegates = [
            p.label for p in participants if p.label not in delegates
        ]
        report["topology"] = {
            "mode": "hierarchical" if hier_enabled else "flat",
            "cliques": len(plan.cliques),
            "delegates": sorted(delegates),
            "wan_bytes_total": int(wan),
            "local_bytes_total": int(local),
            "wan_bytes_per_nondelegate": round(
                sum(wan_by_src.get(label, 0.0) for label in nondelegates)
                / max(1, len(nondelegates)),
                1,
            ),
            "wan_bytes_per_delegate": round(
                sum(wan_by_src.get(label, 0.0) for label in delegates)
                / max(1, len(delegates)),
                1,
            ),
        }
    if int(spec.get("restore_bytes", 0)) > 0:
        report["restore"] = await _workload_restore(swarm, spec, prefix)
    return report


async def _workload_restore(swarm: SimSwarm, spec: Dict[str, Any],
                            prefix: str) -> Dict[str, Any]:
    """One sharded catalog restore over the workload's links: providers
    serve a synthetic checkpoint of ``restore_bytes``, a non-provider
    restores it with ``fetch_parallelism`` — the fetch-sizing leg of a
    twin replay (and the source of ``ckpt.provider_goodput`` telemetry)."""
    from dedloc_tpu_torch.checkpointing.catalog import parse_announcements
    from dedloc_tpu_torch.checkpointing.fetcher import sharded_restore
    from dedloc_tpu_torch.checkpointing.catalog import catalog_key

    restore_bytes = int(spec.get("restore_bytes", 0))
    total_size = max(256, restore_bytes // 4)  # fp32 elements
    shard_size = max(64, total_size // 8)
    alive = swarm.alive_peers()
    n_providers = max(1, min(int(spec.get("restore_providers", 4)),
                             len(alive) - 1))
    providers = alive[:n_providers]
    loop = asyncio.get_event_loop()
    for peer in providers:
        peer.serve_checkpoint(
            step=1, total_size=total_size, shard_size=shard_size
        )
        await peer.announce_checkpoint(f"{prefix}-restore")
    reader = alive[n_providers]
    entry = await reader.node.get(
        catalog_key(f"{prefix}-restore").encode(), latest=True
    )
    items = (
        [(sk, v.value) for sk, v in entry.value.items()]
        if entry is not None and hasattr(entry.value, "items")
        else []
    )
    announcements = parse_announcements(items)
    t0 = loop.time()
    ok = False
    stats: Dict[str, Any] = {}
    # the ckpt.restore span production's load_state_from_peers opens
    # around its sharded path — the fitter reads restore shape from it
    with reader.telemetry.span(
        "ckpt.restore", mode="sharded", bytes=total_size * 4
    ) as ctx:
        try:
            await sharded_restore(
                reader.node.client, announcements,
                parallelism=int(spec.get("fetch_parallelism", 4)),
                telemetry_registry=reader.telemetry, stats=stats,
            )
            ok = True
        except Exception as e:  # noqa: BLE001 — reported, not raised
            logger.warning(f"workload restore failed: {e!r}")
        ctx["ok"] = ok
        ctx["providers"] = int(stats.get("providers", 0))
    return {
        "ok": ok,
        "restore_s": round(loop.time() - t0, 4),
        "bytes": total_size * 4,
        "providers": n_providers,
        "providers_used": int(stats.get("providers", 0)),
        "fetch_parallelism": int(spec.get("fetch_parallelism", 4)),
    }


async def phase_averaging(run: ScenarioRun) -> None:
    run.report["averaging"] = await run_averaging_workload(
        run.swarm, run.spec
    )


# ----------------------------------------------------- watchdog scenario
#
# The live-watchdog proving ground: the averaging workload runs with
# scripted mid-run faults while a simulated coordinator FOLDS swarm-health
# records after every round (the production fold shape, built by the same
# telemetry/health.build_swarm_health) and streams them through a
# SwarmWatch inline — exactly the coordinator's live loop, in virtual
# time. The folds dump to a coordinator-style JSONL so a post-hoc replay
# (tools/swarm_watch.py) must reproduce the identical incident timeline.


def fold_swarm_health(swarm: SimSwarm, step: int,
                      state: Dict[str, Any]) -> Dict[str, Any]:
    """One coordinator fold over the sim swarm: per-peer LocalMetrics-shaped
    records built from each alive peer's telemetry snapshot (cumulative
    counters + link table, exactly what the signed metrics bus carries),
    plus the recent ``avg.round`` summaries a production bus cannot carry
    (flat floats only) but the in-process fold can — the watchdog's
    representative-trace attribution reads them. ``state`` is the fold's
    mutable memory ({} on the first call)."""
    now = get_dht_time()
    last_t = state.get("t")
    dt = (now - last_t) if last_t is not None else None
    records = []
    rounds: List[Dict[str, Any]] = []
    for peer in swarm.alive_peers():
        samples = 0.0
        for r in peer.telemetry.events:
            if last_t is not None and float(r.get("t", 0.0)) <= last_t:
                continue
            name = r.get("event")
            if name == "step.record":
                samples += float(r.get("samples", 0.0))
            elif name == "avg.round":
                rounds.append({
                    "round_id": r.get("round_id"), "peer": peer.label,
                    "dur_s": r.get("dur_s"), "ok": r.get("ok"),
                    "group_size": r.get("group_size"),
                    "trace": r.get("trace"),
                })
        records.append(SimpleNamespace(
            peer=peer.label,
            step=int(step),
            samples_per_second=(
                round(samples / dt, 3) if dt and dt > 0 else 0.0
            ),
            step_time_ms=None,
            telemetry=peer.telemetry.snapshot(),
            endpoint=endpoint_key(peer.endpoint),
        ))
    from dedloc_tpu_torch.telemetry.health import build_swarm_health

    health = build_swarm_health(
        records, rounds=rounds, prev=state.get("health"), dt_s=dt
    )
    state["t"] = now
    state["health"] = health
    return {"step": int(step), "time": now, "swarm_health": health}


def _watch_config(spec: Dict[str, Any]):
    from dedloc_tpu_torch.telemetry.watch import WatchConfig

    cfg = WatchConfig()
    for key, value in (spec.get("watch") or {}).items():
        if not hasattr(cfg, key):
            raise ValueError(f"unknown watch config key {key!r}")
        setattr(cfg, key, type(getattr(cfg, key))(value))
    return cfg


async def _scenario_watchdog(run: ScenarioRun) -> None:
    from dedloc_tpu_torch.telemetry.watch import SwarmWatch

    await phase_spawn(run)
    run.report["link_overrides"] = apply_link_overrides(
        run.network,
        [p.host for p in run.swarm.peers],
        run.spec.get("links"),
    )
    watch = SwarmWatch(_watch_config(run.spec))
    fold_state: Dict[str, Any] = {}
    folds: List[Dict[str, Any]] = []
    transitions: List[Dict[str, Any]] = []

    async def on_round(r: int) -> None:
        row = fold_swarm_health(run.swarm, r, fold_state)
        folds.append(row)
        if row["swarm_health"] is None:
            # a scripted churn wave can wipe out EVERY peer: the fold is
            # kept as evidence in the dump, but there is nothing to
            # observe — watch_rows skips null health rows the same way,
            # so live and replay stay identical
            return
        for tr in watch.observe_health(
            row["swarm_health"], t=row["time"], step=r
        ):
            transitions.append({
                "fold": watch.fold,
                "transition": tr["transition"],
                "incident": tr["incident"]["id"],
                "kind": tr["incident"]["kind"],
                "subject": tr["incident"]["subject"],
            })

    run.report["averaging"] = await run_averaging_workload(
        run.swarm, run.spec, on_round=on_round
    )
    run.report["watch"] = watch.summary()
    run.report["transitions"] = transitions
    run.report["health_folds"] = folds


# --------------------------------------------------- closed-loop scenario
#
# The ISSUE 16 acceptance scenario: detect -> re-plan -> retune -> recover,
# with zero operator input, entirely in virtual time. The averaging
# workload runs with scripted mid-run faults while a coordinator-shaped
# controller runs after every round: health fold -> SwarmWatch -> the REAL
# ``_Replanner`` (roles/coordinator.py) deriving epoch-versioned topology
# plans from the fold's live link table -> the REAL ``ActuationGuard``
# (telemetry/watch.py) applying scripted retune recommendations under the
# guard rail and rolling harmful ones back. The workload re-reads its live
# control dict each round, so an adopted plan (or chunk retune) reshapes
# the NEXT round with no barrier — the runtime adoption contract. The DHT
# wire machinery itself (publish/fetch backoff, fault ladder, mixed-epoch
# scope isolation) is proven separately by the loopback tests in
# tests/test_closed_loop.py against real DHT nodes.


async def _scenario_closed_loop(run: ScenarioRun) -> None:
    """Spec section ``control`` (all keys optional)::

        control:
          replan: true                # run the live replanner
          replan_min_interval_s: 0.0  # epoch-bump hysteresis (virtual s)
          adopt_delay_rounds: 0       # publish -> peer-adoption lag
          settle_folds: 1             # ActuationConfig knobs...
          observe_folds: 3
          rollback_margin: 0.1
          cooldown_folds: 1
          max_actuations_per_epoch: 4
          max_change_factor: 4.0
          recommendations:            # scripted twin recommendations,
            - at_fold: 8              # attached to the newest open
              config: {chunk_size: 2048}   # incident from this fold on

    Report adds ``replans`` (the epoch timeline), ``actuations`` (the
    guard's full history incl. verdicts), ``sps_by_fold``, ``final_config``
    and ``incident_rows`` — the coordinator-style incident JSONL rows,
    dumped to ``incidents.jsonl`` for ``runlog_summary --incidents``."""
    from dedloc_tpu_torch.averaging.topology import TopologyPlan
    from dedloc_tpu_torch.roles.coordinator import _Replanner
    from dedloc_tpu_torch.telemetry.watch import (
        ActuationConfig,
        ActuationGuard,
        SwarmWatch,
        rollback_effect,
    )

    await phase_spawn(run)
    run.report["link_overrides"] = apply_link_overrides(
        run.network,
        [p.host for p in run.swarm.peers],
        run.spec.get("links"),
    )
    spec = run.spec
    ctl = dict(spec.get("control") or {})

    watch = SwarmWatch(_watch_config(spec))
    fold_state: Dict[str, Any] = {}
    folds: List[Dict[str, Any]] = []
    transitions: List[Dict[str, Any]] = []
    incident_rows: List[Dict[str, Any]] = []

    def record_incident(t, step, transition, incident) -> None:
        # the coordinator's incident-JSONL row shape (_append_incident):
        # deep JSON copy, because the live dict keeps mutating
        incident_rows.append({
            "t": t, "step": step, "watch": "incident",
            "transition": transition,
            "incident": json.loads(json.dumps(incident, default=str)),
        })

    class _MemDHT:
        """In-memory plan-record store: the replanner's publish target.
        The wire itself (real DHT store/fetch, retries, fault points) is
        proven by the loopback tests; here the records are evidence."""

        def __init__(self):
            self.stored: List[Any] = []

        def store(self, key, value, expiration_time, subkey=None, **_kw):
            self.stored.append({"key": key, "subkey": subkey,
                                "value": value})
            return True

    replanner = None
    if bool(ctl.get("replan", True)):
        replanner = _Replanner(
            _MemDHT(), str(spec.get("prefix", "twinexp")),
            SimpleNamespace(replan_min_interval_s=float(
                ctl.get("replan_min_interval_s", 0.0)
            )),
        )
    guard = ActuationGuard(ActuationConfig(
        max_change_factor=float(ctl.get("max_change_factor", 4.0)),
        settle_folds=int(ctl.get("settle_folds", 1)),
        observe_folds=int(ctl.get("observe_folds", 3)),
        rollback_margin=float(ctl.get("rollback_margin", 0.1)),
        cooldown_folds=int(ctl.get("cooldown_folds", 1)),
        max_actuations_per_epoch=int(
            ctl.get("max_actuations_per_epoch", 4)
        ),
    ))
    # the actuated config in averager terms: chunk_size is ELEMENTS (fp32,
    # 4 bytes each) exactly like --averager.chunk_size, mapped onto the
    # workload's chunk_bytes on apply
    current_config: Dict[str, Any] = {
        "chunk_size": max(1024, int(spec.get("chunk_bytes", 24576))) // 4,
        "overlap": bool(spec.get("overlap", False)),
    }
    scripted = [dict(rec) for rec in (ctl.get("recommendations") or [])]
    adopt_delay = int(ctl.get("adopt_delay_rounds", 0))
    pending_plans: List[Any] = []  # (adopt_at_round, label-keyed plan)
    control: Dict[str, Any] = {}
    label_by_endpoint = {
        endpoint_key(p.endpoint): p.label for p in run.swarm.peers
    }
    replans: List[Dict[str, Any]] = []
    actuation_events: List[Dict[str, Any]] = []
    sps_by_fold: List[Optional[float]] = []

    def _label_plan(plan: TopologyPlan) -> TopologyPlan:
        """The replanner's plans key members by ENDPOINT (what runtime
        matchmaking advertises); the sim workload matches by label —
        re-key through the fold's own peers map."""
        lp = TopologyPlan.from_dict(plan.to_dict())
        lp.peers = sorted(
            label_by_endpoint.get(p, p) for p in lp.peers
        )
        for c in lp.cliques:
            c.members = sorted(
                label_by_endpoint.get(m, m) for m in c.members
            )
            c.delegate = label_by_endpoint.get(c.delegate, c.delegate)
        return lp

    def _apply_config(delta: Dict[str, Any]) -> None:
        current_config.update(delta)
        control["chunk_bytes"] = max(
            1024, int(current_config["chunk_size"]) * 4
        )
        control["overlap"] = bool(current_config.get("overlap", False))

    async def on_round(r: int) -> None:
        row = fold_swarm_health(run.swarm, r, fold_state)
        folds.append(row)
        health = row["swarm_health"]
        if health is None:
            return
        t = row["time"]
        # this fold's swarm throughput — the same sum the watch derives,
        # and what the guard judges an in-flight actuation by
        reported = [
            float(p["samples_per_second"])
            for p in health.get("peers", [])
            if isinstance(p, dict)
            and p.get("samples_per_second") is not None
        ]
        sps = sum(reported) if reported else None
        sps_by_fold.append(sps)
        for tr in watch.observe_health(
            health, t=t, step=r, samples_per_sec=sps
        ):
            transitions.append({
                "fold": watch.fold,
                "transition": tr["transition"],
                "incident": tr["incident"]["id"],
                "kind": tr["incident"]["kind"],
                "subject": tr["incident"]["subject"],
            })
            record_incident(t, r, tr["transition"], tr["incident"])

        # ---- live re-planning off the fold (the production code path)
        if replanner is not None:
            published = replanner.fold(health, t)
            if published is not None:
                replans.append({
                    "fold": watch.fold, "round": r,
                    "epoch": int(published.epoch),
                    "mode": published.mode,
                    "reason": published.reason,
                    "cliques": [sorted(c.members)
                                for c in published.cliques],
                })
                pending_plans.append(
                    (r + 1 + adopt_delay, _label_plan(published))
                )
        epoch = replanner.epoch if replanner is not None else 0

        # ---- judge the in-flight actuation against this fold first
        verdict = guard.observe(sps, fold=watch.fold)
        if verdict is not None:
            incident = next(
                (i for i in watch.incidents
                 if i["id"] == verdict.get("incident")), None,
            )
            if verdict["verdict"] == "rollback":
                _apply_config(verdict["revert"])
                if incident is not None:
                    rollback_effect(incident, verdict)
                    record_incident(t, r, "rollback", incident)
            elif incident is not None:
                for effect in incident.get("effects", []):
                    if (
                        effect.get("metric") == "actuation"
                        and effect.get("applied") == verdict["applied"]
                    ):
                        effect["verdict"] = "kept"
                record_incident(t, r, "actuation", incident)
            actuation_events.append({
                "fold": watch.fold, "round": r,
                "verdict": verdict["verdict"],
                "applied": dict(verdict["applied"]),
            })

        # ---- scripted recommendations: the twin fit, pre-computed by the
        # spec (twin_recommendation itself is proven by twin_replay tests)
        open_inc = watch.open_incidents()
        for rec in scripted:
            if rec.get("_attached") or watch.fold < int(
                rec.get("at_fold", 0)
            ):
                continue
            if not open_inc:
                continue
            target = open_inc[-1]
            target["recommendation"] = {
                "config": dict(rec.get("config") or {}),
                "predicted_samples_per_sec": rec.get(
                    "predicted_samples_per_sec"
                ),
            }
            rec["_attached"] = True
            record_incident(t, r, "recommendation", target)

        # ---- apply at most one eligible recommendation under the rail
        for incident in open_inc:
            recommendation = incident.get("recommendation")
            if not recommendation or incident.get("actuated"):
                continue
            result = guard.consider(
                recommendation, current_config,
                fold=watch.fold, epoch=epoch,
            )
            if "refused" in result:
                incident["actuation_refused"] = result["refused"]
                continue
            incident.pop("actuation_refused", None)
            _apply_config(result["apply"])
            incident["actuated"] = True
            guard.actuate(
                incident, result["apply"], result["revert"],
                fold=watch.fold, baseline_samples_per_sec=sps,
                epoch=epoch, clamped=tuple(result["clamped"]),
            )
            actuation_events.append({
                "fold": watch.fold, "round": r,
                "verdict": "applied", "applied": dict(result["apply"]),
            })
            record_incident(t, r, "actuation", incident)
            break  # one actuation per fold; the guard serializes the rest

        # ---- adoption: plans whose publish->fetch lag expired reshape
        # the NEXT round (peers poll between rounds; no barrier)
        while pending_plans and pending_plans[0][0] <= r + 1:
            _at, label_plan = pending_plans.pop(0)
            control["plan"] = label_plan
            control["enabled"] = True

    run.report["averaging"] = await run_averaging_workload(
        run.swarm, spec, on_round=on_round, control=control
    )
    run.report["watch"] = watch.summary()
    run.report["transitions"] = transitions
    run.report["health_folds"] = folds
    run.report["replans"] = replans
    run.report["plan_epoch"] = (
        replanner.epoch if replanner is not None else 0
    )
    run.report["actuations"] = guard.history
    run.report["actuation_events"] = actuation_events
    run.report["sps_by_fold"] = sps_by_fold
    run.report["final_config"] = dict(current_config)
    run.report["incident_rows"] = incident_rows


# -------------------------------------------------------------- scenarios


async def _scenario_dht_churn(run: ScenarioRun) -> None:
    await phase_spawn(run)
    await phase_dht(run)


async def _scenario_matchmaking(run: ScenarioRun) -> None:
    await phase_spawn(run)
    await phase_matchmaking(run)


async def _scenario_catalog(run: ScenarioRun) -> None:
    await phase_spawn(run)
    await phase_catalog(run)


async def _scenario_mixed(run: ScenarioRun) -> None:
    """The acceptance scenario: DHT churn + matchmaking rounds + catalog
    announcements over ONE swarm, in that order, so each phase inherits
    the previous one's damage."""
    await phase_spawn(run)
    await phase_dht(run)
    await phase_matchmaking(run)
    await phase_catalog(run)


async def _scenario_averaging(run: ScenarioRun) -> None:
    """The digital-twin source scenario: spawn, apply the spec's per-link
    overrides (the known asymmetric network a twin must rediscover from
    telemetry alone), then run averaging rounds to a round-wall report."""
    await phase_spawn(run)
    run.report["link_overrides"] = apply_link_overrides(
        run.network,
        [p.host for p in run.swarm.peers],
        run.spec.get("links"),
    )
    await phase_averaging(run)


async def _scenario_hierarchical(run: ScenarioRun) -> None:
    """Two-level adaptive averaging, sized against its own flat baseline
    (docs/simulator.md): ONE swarm, the spec's ``topology`` partition and
    per-link overrides (the 2-clique asymmetric-WAN shape), and the
    averaging workload run TWICE — flat first (``topology.enabled: false``
    keeps the plan for WAN-byte accounting), then hierarchical. The
    ``comparison`` section is what the acceptance bounds read: WAN bytes
    per non-delegate peer, round-wall p50, and the formed-group-size
    medians the 200-joiner collapse case is judged on."""
    await phase_spawn(run)
    run.report["link_overrides"] = apply_link_overrides(
        run.network,
        [p.host for p in run.swarm.peers],
        run.spec.get("links"),
    )
    topo = dict(run.spec.get("topology") or {})
    flat_spec = {**run.spec, "topology": {**topo, "enabled": False}}
    hier_spec = {**run.spec, "topology": {**topo, "enabled": True}}
    run.report["flat"] = await run_averaging_workload(run.swarm, flat_spec)
    run.report["hierarchical"] = await run_averaging_workload(
        run.swarm, hier_spec
    )
    flat, hier = run.report["flat"], run.report["hierarchical"]

    def _ratio(a: float, b: float) -> Optional[float]:
        return round(a / b, 3) if b else None

    flat_topo = flat.get("topology") or {}
    hier_topo = hier.get("topology") or {}
    run.report["comparison"] = {
        "wan_bytes_total_ratio": _ratio(
            flat_topo.get("wan_bytes_total", 0.0),
            hier_topo.get("wan_bytes_total", 0.0),
        ),
        # the acceptance bar reads nondelegate_wan_bytes: two-level
        # reduction must at least halve what a non-delegate pays WAN-side
        # (it typically zeroes it — only delegates cross the WAN)
        "nondelegate_wan_bytes": {
            "flat": flat_topo.get("wan_bytes_per_nondelegate"),
            "hierarchical": hier_topo.get("wan_bytes_per_nondelegate"),
        },
        "round_wall_p50_ratio": _ratio(
            flat.get("round_wall_p50_s", 0.0),
            hier.get("round_wall_p50_s", 0.0),
        ),
        "group_size_median": {
            "flat": flat.get("group_size_median"),
            "hierarchical": hier.get("group_size_median"),
        },
    }


# ----------------------------------------------------- ledger scenario
#
# The contribution-ledger acceptance scenario: receipt-backed swarm
# accounting, entirely in virtual time. Peers form REAL matchmaking groups
# each round with their declared per-round weight riding the signed join
# envelope (Member.weight over the sim DHT wire), countersign receipts
# with the REAL receipt_from_group, and publish schema-checked claims as
# DHT records — one peer INFLATES its cumulative claim, one serves most
# checkpoint bytes. A coordinator-shaped fold runs the REAL fold_ledger
# after every round; the dumped ledger JSONL must replay bit-identically
# (tests/test_ledger.py), honest peers land within 5% of scripted ground
# truth, and the inflator is capped at its receipt-supported total with a
# named discrepancy.


async def _scenario_ledger(run: ScenarioRun) -> None:
    """Spec section ``ledger`` (all keys optional)::

        ledger:
          inflate_peer: peer-0001   # claims inflate_factor x its true work
          inflate_factor: 10.0
          serve_peer: peer-0002     # scripted checkpoint-serving bytes
          serve_bytes: 67108864
          slack: 1.25
    """
    from dedloc_tpu_torch.telemetry.ledger import (
        ContributionClaim,
        fold_ledger,
        leaderboard,
        ledger_key,
        parse_claims,
        parse_receipts,
        receipt_from_group,
        receipts_key,
    )

    await phase_spawn(run)
    spec = run.spec
    lspec = dict(spec.get("ledger") or {})
    rounds = int(spec.get("avg_rounds", 6))
    window = float(spec.get("window_s", 5.0))
    samples_per_round = (
        int(spec.get("boundaries", 2)) * int(spec.get("samples_per_boundary", 16))
    )
    prefix = str(spec.get("prefix", "simexp"))
    slack = float(lspec.get("slack", 1.25))
    inflate_factor = float(lspec.get("inflate_factor", 10.0))
    participants = run.swarm.alive_peers()
    if len(participants) < 3:
        raise ValueError("ledger scenario needs >= 3 live peers")
    # one group spanning the whole swarm per round: every mate's witness
    # table then covers every round, so HONEST credit is exact and the 5%
    # acceptance bar measures only the fold, not matchmaking splits
    group_size = int(spec.get("group_size", len(participants)))
    labels = [p.label for p in participants]
    inflate_peer = str(lspec.get("inflate_peer", labels[1]))
    serve_peer = str(lspec.get("serve_peer", labels[2]))
    serve_bytes = int(lspec.get("serve_bytes", 64 * 1024 * 1024))

    for peer in participants:
        peer.attach_matchmaking(
            prefix, bandwidth=100.0, target_group_size=group_size,
            averaging_expiration=window,
        )
        # the declared per-round weight rides the signed join envelope
        peer.matchmaking.declared_weight = float(samples_per_round)

    hex_by_label = {
        p.label: p.node.node_id.to_bytes().hex() for p in participants
    }
    truth = {p.label: {"samples": 0, "rounds": 0} for p in participants}
    witnesses: Dict[str, Dict[str, Dict[str, float]]] = {
        p.label: {} for p in participants
    }
    ledger_rows: List[Dict[str, Any]] = []
    prev_fold = None
    t0 = get_dht_time()

    def _items(entry) -> list:
        return (
            [(sk, v.value) for sk, v in entry.value.items()]
            if entry is not None and hasattr(entry.value, "items")
            else []
        )

    for r in range(rounds):
        round_id = f"ledround-{r:04d}"
        alive = [p for p in participants if p.alive]

        async def one(peer):
            try:
                return peer, await peer.matchmaking.form_group(round_id)
            except Exception:  # noqa: BLE001 — skipped this round
                return peer, None

        formed = await asyncio.gather(*(one(p) for p in alive))
        for peer, group in formed:
            if group is None or len(group.members) < 2:
                continue
            # the receipt covers the envelope identities + declared
            # weights the signer verified at join — built by the SAME
            # helper the runtime averager calls at round finalization
            member_weights = [
                (m.peer_id.hex(), float(m.weight)) for m in group.members
            ]
            receipt = receipt_from_group(
                hex_by_label[peer.label], round_id, -1, "flat",
                member_weights, witnesses[peer.label],
            )
            truth[peer.label]["samples"] += samples_per_round
            truth[peer.label]["rounds"] += 1
            peer.telemetry.counter("ledger.receipts").inc()
            peer.telemetry.event(
                "ledger.receipt",
                signer=receipt.signer, round_id=receipt.round_id,
                step=receipt.step, leg=receipt.leg,
                members=list(receipt.members),
                weights=list(receipt.weights),
                witness={
                    p: {"samples": e.samples, "rounds": e.rounds}
                    for p, e in receipt.witness.items()
                },
            )
            # subkey = the peer id itself: the structural binding
            # parse_receipts enforces (a record's signer must be the
            # identity its slot speaks for, telemetry/ledger.py)
            await peer.node.store(
                receipts_key(prefix).encode(), receipt.model_dump(),
                get_dht_time() + 3600.0,
                subkey=peer.node.node_id.to_bytes(),
            )
        # cumulative claims (last-write-wins per peer, like the one signed
        # subkey slot production enforces); the inflator multiplies its
        # TRUE total — its per-round declared weights stayed honest, which
        # is exactly the attack receipts catch
        for peer in alive:
            tr = truth[peer.label]
            claimed = tr["samples"]
            if peer.label == inflate_peer:
                claimed = int(claimed * inflate_factor)
            bytes_served = (
                serve_bytes if peer.label == serve_peer
                else 1024 * (r + 1)
            )
            claim = ContributionClaim(
                peer=hex_by_label[peer.label],
                samples=int(claimed),
                rounds=int(tr["rounds"]),
                train_seconds=round(get_dht_time() - t0, 3),
                bytes_served=int(bytes_served),
                time=get_dht_time(),
            )
            peer.telemetry.counter("ledger.claims").inc()
            peer.telemetry.event(
                "ledger.claim", peer=claim.peer, samples=claim.samples,
                rounds=claim.rounds, train_seconds=claim.train_seconds,
                bytes_served=claim.bytes_served,
            )
            await peer.node.store(
                ledger_key(prefix).encode(), claim.model_dump(),
                get_dht_time() + 3600.0,
                subkey=peer.node.node_id.to_bytes(),
            )
        # coordinator-shaped fold off the live DHT view, through the SAME
        # parse + fold path roles/coordinator.py runs
        reader = alive[0]
        centry = await reader.node.get(ledger_key(prefix).encode(), latest=True)
        rentry = await reader.node.get(
            receipts_key(prefix).encode(), latest=True
        )
        folded = fold_ledger(
            prev_fold, parse_claims(_items(centry)),
            parse_receipts(_items(rentry)), slack=slack, now=get_dht_time(),
        )
        prev_fold = folded
        ledger_rows.append({"t": folded["t"], "step": r, "ledger": folded})
        # let leader-entry expirations clear so rounds stay disjoint
        await asyncio.sleep(window + 1.0)

    run.report["ledger_rows"] = ledger_rows
    run.report["ledger"] = prev_fold
    run.report["leaderboard"] = leaderboard(prev_fold) if prev_fold else []
    run.report["truth"] = {
        label: {**tr, "peer": hex_by_label[label]}
        for label, tr in truth.items()
    }
    run.report["samples_per_round"] = samples_per_round
    run.report["inflate"] = {
        "label": inflate_peer, "peer": hex_by_label.get(inflate_peer),
        "factor": inflate_factor,
    }
    run.report["serve"] = {
        "label": serve_peer, "peer": hex_by_label.get(serve_peer),
        "bytes": serve_bytes,
    }


async def _scenario_diurnal(run: ScenarioRun) -> None:
    """Planet-scale volunteer waves: a 10k-peer roster of which only each
    timezone's duty window is ever online. The whole roster starts as
    unhydrated SHELLS (no node, no telemetry, no sockets); each virtual
    hour the arriving wave is warm-hydrated in one batch and the departing
    wave is process-killed. Online volunteers heartbeat presence records
    into the DHT and read each other's — the workload that proves the
    swarm stays routable while most of its roster is asleep.

    This is the engine's scale acceptance: the wall cost must track the
    ACTIVE wave (hydrations + live traffic), not the roster size."""
    spec = run.spec
    roster_n = int(spec.get("peers", 10000))
    hours = int(spec.get("hours", 24))
    hour_s = float(spec.get("hour_s", 60.0))
    duty = int(spec.get("duty_hours", 8))
    ops = int(spec.get("ops_per_hour", 48))
    swarm, rng = run.swarm, run.rng
    shells = swarm.spawn_shells(roster_n)
    # each volunteer's home-timezone start hour, hash-derived (stable
    # across runs and independent of the shared rng stream)
    start_hour = [
        int.from_bytes(
            hashlib.sha256(
                f"{run.seed}:diurnal:{i}".encode()
            ).digest()[:2], "big"
        ) % 24
        for i in range(roster_n)
    ]

    def online_at(index: int, hour: int) -> bool:
        return (hour - start_hour[index]) % 24 < duty

    hydrations = departures = peak_online = 0
    put_attempts = puts_ok = get_attempts = get_hits = 0
    for hour in range(hours):
        h = hour % 24
        leaving = [p for p in shells if p.alive and not online_at(p.index, h)]
        for p in leaving:
            await swarm.kill(p)
        departures += len(leaving)
        arriving = [
            p for p in shells if not p.alive and online_at(p.index, h)
        ]
        await swarm.hydrate_batch(arriving)
        hydrations += len(arriving)
        online = swarm.alive_peers()
        peak_online = max(peak_online, len(online))
        if online:
            key = f"presence-{hour:04d}".encode()
            expiry = get_dht_time() + 2.0 * hour_s
            writers = rng.sample(online, min(ops, len(online)))
            stored = await asyncio.gather(*(
                w.node.store(key, w.label.encode(), expiry,
                             subkey=w.label.encode())
                for w in writers
            ))
            put_attempts += len(writers)
            puts_ok += sum(1 for s in stored if s)
            readers = rng.sample(online, min(ops, len(online)))
            entries = await asyncio.gather(*(
                r.node.get(key) for r in readers
            ))
            get_attempts += len(readers)
            get_hits += sum(1 for e in entries if e is not None)
        await asyncio.sleep(hour_s)
    run.report["diurnal"] = {
        "roster": roster_n,
        "hours": hours,
        "duty_hours": duty,
        "peak_online": peak_online,
        "hydrations": hydrations,
        "departures": departures,
        "puts": put_attempts,
        "puts_ok": puts_ok,
        "gets": get_attempts,
        "get_hits": get_hits,
        "get_success": round(get_hits / max(1, get_attempts), 3),
        "shells_never_online": sum(
            1 for p in shells if p.node is None
        ),
    }


def _zipf_weights(n: int, skew: float) -> List[float]:
    raw = [1.0 / (i + 1) ** skew for i in range(n)]
    total = sum(raw)
    return [w / total for w in raw]


def _weighted_index(rng: random.Random, weights: List[float]) -> int:
    x = rng.random()
    acc = 0.0
    for i, w in enumerate(weights):
        acc += w
        if x < acc:
            return i
    return len(weights) - 1


async def _scenario_serving(run: ScenarioRun) -> None:
    """The swarm-as-serving-fleet rehearsal (ROADMAP item 1): expert hosts
    announce signed ExpertRecords on the sim DHT wire, gateways route a
    bursty scripted request trace latency/load-aware over SimNetwork
    links, expert peers die mid-trace, and the ledger credits the serving
    work. Spec section (all keys optional)::

        scenario: serving
        peers: 1000
        experts: 16             # expert ids 0..E-1
        hosts_per_expert: 3
        gateways: 8
        requests: 400           # scripted request trace length
        burst: 8                # concurrent requests per burst
        burst_gap_s: 0.25       # virtual gap between bursts
        tokens: 16              # tokens per request
        hidden: 8               # token feature width
        skew: 1.1               # zipf exponent on expert popularity
        capacity: 512           # per-host tokens-per-window bound
        kill_hosts: 0           # expert hosts killed mid-trace
        kill_at_frac: 0.5       # kill point, fraction of the trace
        refresh_period_s: 2.0   # gateway discovery refresh
        announce_period_s: 2.0  # host record refresh (TTL = 2x this)
        deadline_s: 2.0         # per-request budget
        hedge_after_s: 0.3
        dispatch_rate: 0.0      # per-caller admission on hosts (0 = open)
        ledger_slack: 1.25
    """
    import numpy as np

    from dedloc_tpu_torch.serving.admission import Admission
    from dedloc_tpu_torch.serving.host import ExpertHost
    from dedloc_tpu_torch.serving.router import ExpertRouter, RouterPolicy
    from dedloc_tpu_torch.telemetry.ledger import (
        ContributionClaim,
        fold_ledger,
        leaderboard,
        ledger_key,
        parse_claims,
    )

    await phase_spawn(run)
    spec = run.spec
    prefix = str(spec.get("prefix", "simexp"))
    E = int(spec.get("experts", 16))
    H = int(spec.get("hosts_per_expert", 3))
    G = int(spec.get("gateways", 8))
    R = int(spec.get("requests", 400))
    burst = max(1, int(spec.get("burst", 8)))
    burst_gap = float(spec.get("burst_gap_s", 0.25))
    tokens = int(spec.get("tokens", 16))
    hidden = int(spec.get("hidden", 8))
    skew = float(spec.get("skew", 1.1))
    capacity = int(spec.get("capacity", 512))
    kill_hosts = int(spec.get("kill_hosts", 0))
    kill_at = int(R * float(spec.get("kill_at_frac", 0.5)))
    refresh_s = float(spec.get("refresh_period_s", 2.0))
    announce_s = float(spec.get("announce_period_s", 2.0))
    version = int(spec.get("version", 100))

    peers = run.swarm.alive_peers()
    if len(peers) < E * H + G:
        raise ValueError(
            f"serving scenario needs >= {E * H + G} peers, have {len(peers)}"
        )
    host_peers = peers[: E * H]
    gateway_peers = peers[E * H : E * H + G]

    # --- expert hosts: host i serves expert i % E (H replicas per expert)
    def _compute(expert_id: int, x):
        # deterministic synthetic expert: distinct affine map per expert,
        # so a reply proves WHICH expert computed it
        return (x * np.float32(1.0 + expert_id) + np.float32(expert_id))

    dispatch_rate = float(spec.get("dispatch_rate", 0.0))
    hosts: List = []
    for i, peer in enumerate(host_peers):
        admission = (
            Admission(rate=dispatch_rate, burst=dispatch_rate * 2.0)
            if dispatch_rate > 0 else None
        )
        hosts.append(ExpertHost(
            peer.node, prefix, [i % E], version,
            compute_fn=_compute, capacity=capacity, admission=admission,
            telemetry_registry=peer.telemetry,
        ))
    last_announce = [None] * len(hosts)

    async def announce_due() -> None:
        """Drive host record refreshes from the trace loop (no background
        tasks — deterministic, and a killed host simply stops refreshing
        so its record ages out within one TTL)."""
        now = get_dht_time()
        due = [
            k for k, peer in enumerate(host_peers)
            if peer.alive and (
                last_announce[k] is None
                or now - last_announce[k] >= announce_s
            )
        ]
        await asyncio.gather(
            *(hosts[k].announce(expiration=announce_s * 2.0) for k in due)
        )
        for k in due:
            last_announce[k] = now

    await announce_due()

    # --- gateways
    policy = RouterPolicy(
        deadline_s=float(spec.get("deadline_s", 2.0)),
        attempt_timeout_s=float(spec.get("attempt_timeout_s", 0.6)),
        retries=int(spec.get("retries", 2)),
        backoff_s=float(spec.get("backoff_s", 0.05)),
        hedge_after_s=float(spec.get("hedge_after_s", 0.3)),
        refresh_period_s=refresh_s,
    )
    routers = [
        ExpertRouter(
            peer.node, prefix, policy=policy,
            telemetry_registry=peer.telemetry, caller=peer.label,
        )
        for peer in gateway_peers
    ]
    for router in routers:
        await router.refresh(force=True)

    # --- the scripted bursty trace, fully precomputed (determinism)
    zipf = _zipf_weights(E, skew)
    trace = [
        (i, i % G, _weighted_index(run.rng, zipf)) for i in range(R)
    ]
    base_tokens = np.arange(tokens * hidden, dtype=np.float32).reshape(
        tokens, hidden
    ) / np.float32(tokens * hidden)

    killed_labels: List[str] = []
    killed_experts: List[int] = []
    kill_t: Optional[float] = None
    results: List[Dict[str, Any]] = []
    wedged = 0
    health_state: Dict[str, Any] = {}
    health_folds: List[Dict[str, Any]] = []
    fold_every = max(1, R // max(1, int(spec.get("health_folds", 3))))

    async def one_request(i: int, gw: int, expert: int) -> Dict[str, Any]:
        t0 = get_dht_time()
        x = base_tokens + np.float32(i % 7)
        y = await routers[gw].dispatch(expert, x, f"req-{i:04d}")
        ok = y is not None
        if ok:
            # the affine map proves the right expert answered
            expected = _compute(expert, x)
            if not np.allclose(y, expected, rtol=1e-5, atol=1e-5):
                raise AssertionError(
                    f"request {i}: expert {expert} returned wrong payload"
                )
        return {
            "i": i, "gateway": gw, "expert": expert, "ok": ok,
            "t0": round(t0 - SIM_EPOCH, 6),
            "dur_s": round(get_dht_time() - t0, 6),
        }

    for b0 in range(0, R, burst):
        if kill_hosts > 0 and kill_t is None and b0 >= kill_at:
            victims = host_peers[:kill_hosts]
            kill_t = get_dht_time()
            for victim in victims:
                killed_labels.append(victim.label)
                await run.swarm.kill(victim)
            killed_experts = sorted(
                {i % E for i in range(kill_hosts)}
            )
        await announce_due()
        batch = trace[b0 : b0 + burst]
        outs = await asyncio.gather(
            *(one_request(*req) for req in batch), return_exceptions=True
        )
        for out in outs:
            if isinstance(out, AssertionError):
                raise out
            if isinstance(out, BaseException):
                wedged += 1  # a request neither served nor fell through
            else:
                results.append(out)
        if (b0 // burst) % max(1, fold_every // burst) == 0:
            health_folds.append(
                fold_swarm_health(run.swarm, b0 // burst, health_state)
            )
        await asyncio.sleep(burst_gap)

    health_folds.append(
        fold_swarm_health(run.swarm, R // burst, health_state)
    )

    # --- the serving ledger: hosts claim their served bytes/requests and
    # the coordinator-shaped fold credits them on the leaderboard
    slack = float(spec.get("ledger_slack", 1.25))
    t_claim = get_dht_time()
    for k, peer in enumerate(host_peers):
        if not peer.alive:
            continue
        host = hosts[k]
        claim = ContributionClaim(
            peer=peer.node.node_id.to_bytes().hex(),
            samples=0, rounds=0, train_seconds=0.0,
            bytes_served=int(host.bytes_served),
            requests_served=int(host.requests_served),
            time=t_claim,
        )
        peer.telemetry.counter("ledger.claims").inc()
        peer.telemetry.event(
            "ledger.claim", peer=claim.peer, samples=0, rounds=0,
            train_seconds=0.0, bytes_served=claim.bytes_served,
            requests_served=claim.requests_served,
        )
        await peer.node.store(
            ledger_key(prefix).encode(), claim.model_dump(),
            get_dht_time() + 3600.0,
            subkey=peer.node.node_id.to_bytes(),
        )
    reader = gateway_peers[0]
    centry = await reader.node.get(ledger_key(prefix).encode(), latest=True)
    citems = (
        [(sk, v.value) for sk, v in centry.value.items()]
        if centry is not None and hasattr(centry.value, "items")
        else []
    )
    folded = fold_ledger(
        None, parse_claims(citems), [], slack=slack, now=get_dht_time()
    )
    run.report["ledger_rows"] = [
        {"t": folded["t"], "step": 0, "ledger": folded}
    ]
    run.report["ledger"] = folded
    run.report["leaderboard"] = leaderboard(folded)
    run.report["health_folds"] = health_folds

    # --- the sizing report
    durs_ok = [r["dur_s"] for r in results if r["ok"]]
    fall = [r for r in results if not r["ok"]]
    by_expert: Dict[int, int] = {}
    for r in results:
        by_expert[r["expert"]] = by_expert.get(r["expert"], 0) + 1
    loads = [by_expert.get(e, 0) for e in range(E)]
    mean_load = sum(loads) / max(1, len(loads))
    # fall-through AFTER the re-route bound: a request that STARTED one
    # full discovery refresh past the kill, on an expert that still has a
    # live replica, must be servable — this is the scenario's re-route
    # assertion surface
    fall_post_refresh = 0
    if kill_t is not None:
        rel_kill = kill_t - SIM_EPOCH
        survivors = {
            i % E for i in range(kill_hosts, E * H)
        }
        fall_post_refresh = sum(
            1 for r in fall
            if r["t0"] > rel_kill + refresh_s + announce_s * 2.0
            and r["expert"] in survivors
        )
    run.report["serving"] = {
        "experts": E,
        "hosts": len(host_peers),
        "gateways": G,
        "requests": R,
        "completed": len(results),
        "wedged": wedged,
        "served": len(durs_ok),
        "fall_through": len(fall),
        "fall_through_rate": round(len(fall) / max(1, R), 4),
        "fall_through_post_refresh": fall_post_refresh,
        "latency_p50_s": round(percentile(durs_ok, 0.50), 4),
        "latency_p99_s": round(percentile(durs_ok, 0.99), 4),
        "load_by_expert": loads,
        "load_skew": round(max(loads) / mean_load, 3) if mean_load else 0.0,
        "killed": killed_labels,
        "killed_experts": killed_experts,
        "kill_t": (
            round(kill_t - SIM_EPOCH, 3) if kill_t is not None else None
        ),
        "rejected": int(run.swarm.counters_total("serve.rejected")),
        "rerouted": int(run.swarm.counters_total("serve.rerouted")),
        "retries": int(run.swarm.counters_total("serve.retries")),
        "hedges": int(run.swarm.counters_total("serve.hedges")),
        "refreshes": int(run.swarm.counters_total("serve.refreshes")),
    }


SCENARIOS: Dict[str, Callable] = {
    "dht_churn": _scenario_dht_churn,
    "matchmaking": _scenario_matchmaking,
    "catalog": _scenario_catalog,
    "mixed": _scenario_mixed,
    "averaging": _scenario_averaging,
    "hierarchical": _scenario_hierarchical,
    "watchdog": _scenario_watchdog,
    "closed_loop": _scenario_closed_loop,
    "ledger": _scenario_ledger,
    "diurnal": _scenario_diurnal,
    "serving": _scenario_serving,
    # resolved specially by run_scenario: replays a fitted TwinModel
    # (dedloc_tpu/twin) instead of building a swarm from spec numbers
    "twin_replay": None,
}


def _run_twin_replay(spec: Dict[str, Any],
                     out_dir: Optional[str] = None) -> Dict[str, Any]:
    """The ``twin_replay`` scenario: spec carries a fitted TwinModel
    (``twin`` inline, or ``twin_path`` pointing at its JSON) plus optional
    workload ``overrides`` — the swarm, links and workload all come from
    the MODEL, not from scenario numbers."""
    from dedloc_tpu_torch.twin.fit import TwinModel
    from dedloc_tpu_torch.twin.replay import replay_twin

    if spec.get("twin") is not None:
        model = TwinModel.from_dict(spec["twin"])
    elif spec.get("twin_path"):
        model = TwinModel.load(str(spec["twin_path"]))
    else:
        raise ValueError(
            "twin_replay needs 'twin' (inline model dict) or 'twin_path'"
        )
    report = replay_twin(
        model,
        overrides=spec.get("overrides"),
        seed=int(spec.get("seed", 0)),
        out_dir=out_dir,
    )
    report["scenario"] = "twin_replay"
    return report


def run_scenario(
    spec: Dict[str, Any], out_dir: Optional[str] = None
) -> Dict[str, Any]:
    """Run one scenario spec to its sizing report (wall-clock bounded only
    by the Python it executes — scenario time is fake). When ``out_dir``
    is given, per-peer telemetry JSONL lands there for ``runlog_summary``.
    """
    name = str(spec.get("scenario", "mixed"))
    if name not in SCENARIOS:
        raise ValueError(
            f"unknown scenario {name!r}; pick one of {sorted(SCENARIOS)}"
        )
    if name == "twin_replay":
        return _run_twin_replay(spec, out_dir=out_dir)
    run = ScenarioRun(spec)
    # real wall on purpose: the report's wall_s vs virtual_s contrast
    t0 = time.perf_counter()  # dedlint: disable=clock-monotonic
    try:
        with run.engine:
            run.engine.run(
                SCENARIOS[name](run),
                timeout=float(spec.get("virtual_timeout_s", 36000.0)),
            )
            run.engine.run(run.swarm.shutdown())
            run.report["virtual_s"] = round(
                run.engine.clock.offset - SIM_EPOCH, 3
            )
            run.report["wall_s"] = round(
                time.perf_counter() - t0,  # dedlint: disable=clock-monotonic
                3,
            )
            run.report["net"] = {
                "total_bytes": sum(run.network.stats["bytes"].values()),
                "total_flushes": sum(run.network.stats["flushes"].values()),
                "resets": run.network.stats["resets"],
                "loss_drops": run.network.stats["loss_drops"],
            }
            if out_dir is not None:
                run.report["event_logs"] = run.swarm.dump_event_logs(out_dir)
                if run.report.get("health_folds"):
                    # the coordinator-style JSONL (one row per fold, the
                    # production metrics-log shape): the post-hoc replay
                    # surface for tools/swarm_watch.py and
                    # runlog_summary --incidents
                    path = os.path.join(out_dir, "coordinator.jsonl")
                    with open(path, "w", encoding="utf-8") as f:
                        for row in run.report["health_folds"]:
                            f.write(json.dumps(row) + "\n")
                    run.report["coordinator_log"] = path
                if run.report.get("ledger_rows"):
                    # the coordinator's ledger-JSONL shape (one row per
                    # fold, last state wins) — what runlog_summary
                    # --contributions reads and replays bit-identically
                    path = os.path.join(out_dir, "ledger.jsonl")
                    with open(path, "w", encoding="utf-8") as f:
                        for row in run.report["ledger_rows"]:
                            f.write(json.dumps(row) + "\n")
                    run.report["ledger_log"] = path
                if run.report.get("incident_rows"):
                    # the coordinator's incident-JSONL shape (one row per
                    # transition, last state per id wins) — what
                    # runlog_summary --incidents and swarm_watch read
                    path = os.path.join(out_dir, "incidents.jsonl")
                    with open(path, "w", encoding="utf-8") as f:
                        for row in run.report["incident_rows"]:
                            f.write(json.dumps(row) + "\n")
                    run.report["incident_log"] = path
    finally:
        run.engine.close()
    return run.report
