"""Coordinator ("first peer"): DHT root + metrics aggregation + checkpoints.

Capability parity with albert/run_first_peer.py:24-218: starts the DHT other
peers bootstrap from, never trains; every ``refresh_period`` seconds it
aggregates the signed per-peer metrics from the DHT (alive peers, summed
throughput, loss = Σloss/Σmini_steps) and logs them (wandb when available,
always JSONL — the TPU build's durable equivalent of the wandb dashboard);
periodically pulls the newest collaboration state from peers and writes a
local checkpoint (the reference pushes to the HF hub via git,
run_first_peer.py:123-147 — the upload seam is ``upload_fn``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from dedloc_tpu_torch.averaging.averager import DecentralizedAverager
from dedloc_tpu_torch.averaging.topology import TopologyPlan, plan_topology
from dedloc_tpu_torch.collaborative.metrics import aggregate_metrics, fetch_metrics
from dedloc_tpu_torch.core.config import CollaborationArguments, parse_config
from dedloc_tpu_torch.core.timeutils import get_dht_time
from dedloc_tpu_torch.roles.common import build_dht
from dedloc_tpu_torch.telemetry import build_swarm_health
from dedloc_tpu_torch.telemetry import registry as telemetry
from dedloc_tpu_torch.utils.checkpoint import save_checkpoint
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class CoordinatorExtraArguments:
    """Reference: CoordinatorArguments (run_first_peer.py:24-57)."""

    refresh_period: float = 30.0
    save_checkpoint_step_interval: int = 5
    upload_interval: float = 0.0  # seconds; 0 disables state pulls
    metrics_log_path: str = "coordinator_metrics.jsonl"
    # live swarm watchdog (telemetry/watch.py): streams every health fold
    # through the anomaly detectors; incident open/close transitions land
    # in their own JSONL (next to the metrics log) and as watch.incident
    # telemetry events
    watchdog_enabled: bool = True
    incident_log_path: str = "coordinator_incidents.jsonl"
    # ROADMAP item 4's closed loop: on a sustained throughput-regression
    # incident, fit a TwinModel from this coordinator's own metrics JSONL
    # and attach a bounded-sweep retuning recommendation to the incident.
    # Costs a few seconds of virtual-time replay; at most once per incident
    # — but a TRANSIENTLY failed fit (jammed JSONL mid-write, thread still
    # busy) retries on a later fold instead of permanently attaching
    # no_recommendation (retune_max_attempts bounds the retries).
    retune_on_regression: bool = True
    retune_max_attempts: int = 3
    # live topology re-planning (ISSUE 16 closed loop): derive a
    # TopologyPlan from each health fold's link topology with the SAME
    # plan_topology detector the --topology view uses, and publish it as an
    # epoch-versioned signed DHT record (averaging/planwire.py) whenever
    # the structure materially changes. Peers with plan-following enabled
    # adopt it between rounds; peers pinned to --averager.topology_plan
    # ignore it (the manual opt-out, docs/fleet.md).
    replan: bool = True
    # min seconds between epoch bumps — re-planning hysteresis so one noisy
    # fold cannot thrash the swarm through plan epochs
    replan_min_interval_s: float = 60.0
    # guard-railed actuation (telemetry/watch.ActuationGuard): APPLY an
    # eligible incident's twin recommendation, bounded per actuation and
    # per plan epoch, auto-rolled-back when the post-change throughput
    # regresses past the pre-change level. The applied config delta rides
    # the plan record's tuning field to the peers. False = PR 12 behavior
    # (recommendation only).
    actuate_retune: bool = True
    actuation_max_change_factor: float = 4.0
    actuation_observe_folds: int = 3
    actuation_rollback_margin: float = 0.1
    actuation_max_per_epoch: int = 2
    # contribution ledger (telemetry/ledger.py): each fold reads the signed
    # claim + receipt records off the DHT, folds them into per-peer credit
    # (credited = min(claimed, receipt-supported x slack)) and appends the
    # cumulative state to its own JSONL — durable and restart-safe (the last
    # row re-seeds the fold), gitignored like the other coordinator logs.
    # Newly-flagged over-claims surface as watch.ledger events.
    ledger_enabled: bool = True
    ledger_log_path: str = "coordinator_ledger.jsonl"
    ledger_slack: float = 1.25  # telemetry/ledger.DEFAULT_SLACK
    # hub publication (run_first_peer.py:123-147 capability): a git working
    # tree (optionally pushing to hub_git_remote) or a directory mirror
    hub_git_dir: str = ""
    hub_git_remote: str = ""
    hub_mirror_dir: str = ""
    # gated runs: "user:credential,user2:credential2" — hosts the token
    # AuthService on this coordinator's DHT server (the reference's hosted
    # auth endpoint, huggingface_auth.py:46-143); volunteers then join with
    # --auth.username/--auth.credential pointed at this coordinator
    auth_allowlist: str = ""


def run_coordinator(
    args: CollaborationArguments,
    extra: Optional[CoordinatorExtraArguments] = None,
    upload_fn: Optional[Callable[[str, int], None]] = None,
    max_iterations: int = 0,
) -> None:
    """``upload_fn(checkpoint_path, step)`` is the hub-publish seam
    (run_first_peer.py:123-147's git push); ``max_iterations`` bounds the
    loop for tests (0 = run forever)."""
    extra = extra or CoordinatorExtraArguments()
    if upload_fn is None:
        from dedloc_tpu_torch.utils.hub import build_upload_fn

        upload_fn = build_upload_fn(
            extra.hub_git_dir, extra.hub_git_remote, extra.hub_mirror_dir
        )
    dht, _public_key = build_dht(args)
    logger.info(f"coordinator DHT root listening on {dht.port}")
    # swarm telemetry (--telemetry.*): the coordinator's own counters —
    # notably metrics.malformed_records from fetch_metrics — need a registry
    # too, or they are silently discarded
    from dedloc_tpu_torch.roles.common import configure_role_telemetry

    _tele, tele_close = configure_role_telemetry(args, _public_key)

    if extra.auth_allowlist:
        from dedloc_tpu_torch.core.auth import AllowlistAuthServer, AuthService

        allow = dict(
            pair.split(":", 1) for pair in extra.auth_allowlist.split(",")
        )
        auth_server = AllowlistAuthServer(
            allow, coordinator_endpoint=dht.get_visible_address()
        )

        async def _attach(node):
            AuthService(node.server, auth_server)

        dht.run_coroutine(_attach)
        logger.info(
            f"auth service up ({len(allow)} allowlisted users); run is gated"
        )

    averager: Optional[DecentralizedAverager] = None
    if extra.upload_interval > 0:
        # listens for state only; contributes no gradients and no bandwidth
        averager = DecentralizedAverager(
            dht,
            args.dht.experiment_prefix,
            client_mode=True,
            allow_state_sharing=False,
            # state pulls prefer the multi-peer sharded path (and fall
            # back to the single-provider blob) like any joiner
            checkpoint_shard_size=args.checkpoint.shard_size,
            checkpoint_fetch_parallelism=args.checkpoint.fetch_parallelism,
            checkpoint_max_providers=args.checkpoint.providers,
        )

    wandb_run = _maybe_wandb(args)
    uploads = {"thread": None}  # per-coordinator upload state (NOT global:
    # tests run several coordinators in one process)
    import threading

    watch = None
    # one twin retune in flight at a time; the lock serializes every
    # incident-dict mutation/serialization between the fold loop and the
    # retune thread
    retunes = {"thread": None, "lock": threading.Lock()}
    if extra.watchdog_enabled:
        from dedloc_tpu_torch.telemetry.watch import SwarmWatch

        watch = SwarmWatch()
    # live re-planning (ISSUE 16): epoch-versioned plan records derived
    # from the health folds' link topology
    replanner = (
        _Replanner(dht, args.dht.experiment_prefix, extra)
        if extra.replan else None
    )
    # guard-railed retune actuation: the applied config delta rides the
    # plan record's tuning field; the launch config is the starting point
    actuation = None
    if extra.watchdog_enabled and extra.actuate_retune:
        from dedloc_tpu_torch.telemetry.watch import ActuationConfig, ActuationGuard

        actuation = {
            "guard": ActuationGuard(ActuationConfig(
                max_change_factor=extra.actuation_max_change_factor,
                observe_folds=extra.actuation_observe_folds,
                rollback_margin=extra.actuation_rollback_margin,
                max_actuations_per_epoch=extra.actuation_max_per_epoch,
            )),
            "config": {
                "chunk_size": args.averager.chunk_size,
                "overlap": args.optimizer.overlap_averaging,
            },
        }
    # contribution-ledger fold state: prev re-seeds from the last row of
    # the durable JSONL, so a restarted coordinator keeps crediting peers
    # whose records expired while it was down (flagged "stale")
    ledger_state = None
    if extra.ledger_enabled:
        ledger_state = {
            "prev": _prev_ledger(extra.ledger_log_path),
            "flagged": {},
        }
    prev_health = None
    prev_fold_t = None
    current_step = -1
    last_upload = get_dht_time()
    iterations = 0
    try:
        while True:
            metrics = fetch_metrics(dht, args.dht.experiment_prefix)
            agg = aggregate_metrics(metrics)
            if agg is not None and agg["step"] > current_step:
                current_step = agg["step"]
                agg["time"] = get_dht_time()
                # swarm health (telemetry/health.py): per-peer retry/fault
                # counters off the signed metrics bus folded into straggler
                # attribution + retry rates — the durable "why was step N
                # slow" record next to the throughput aggregate. prev/dt
                # window the derived rule rates between consecutive folds.
                health = build_swarm_health(
                    metrics,
                    prev=prev_health,
                    dt_s=(
                        agg["time"] - prev_fold_t
                        if prev_fold_t is not None else None
                    ),
                )
                if health is not None:
                    agg["swarm_health"] = health
                    prev_health, prev_fold_t = health, agg["time"]
                    if health["straggler"] is not None:
                        logger.warning(
                            f"step {agg['step']}: straggler "
                            f"{health['straggler']} is stalling the swarm"
                        )
                logger.info(
                    f"step {agg['step']}: {agg['alive_peers']} peers, "
                    f"{agg['samples_per_second']:.1f} samples/s, "
                    f"loss {agg['loss']:.4f}"
                )
                with open(extra.metrics_log_path, "a") as f:
                    f.write(json.dumps(agg) + "\n")
                if wandb_run is not None:
                    wandb_run.log(agg, step=agg["step"])
                if replanner is not None and health is not None:
                    replanner.fold(health, agg["time"])
                if watch is not None and health is not None:
                    _watch_fold(
                        watch, health, agg, extra, retunes,
                        actuation=actuation, replanner=replanner,
                    )

                if (
                    averager is not None
                    and extra.upload_interval > 0
                    and get_dht_time() - last_upload >= extra.upload_interval
                ):
                    _pull_and_save(
                        args, averager, current_step, upload_fn, uploads
                    )
                    last_upload = get_dht_time()

            if ledger_state is not None:
                # every refresh, NOT gated on metrics progress: claims and
                # receipts live even in a swarm too young (or too wedged)
                # to aggregate a metrics step yet
                _ledger_fold(
                    dht, args.dht.experiment_prefix, extra, ledger_state,
                    t=get_dht_time(), step=current_step,
                )

            iterations += 1
            if max_iterations and iterations >= max_iterations:
                break
            time.sleep(extra.refresh_period)
    finally:
        # let an in-flight hub push finish (it is bounded by the git
        # subprocess timeout): a push killed mid-flight can leave a stale
        # lock in the work tree, and the FINAL checkpoint of a run has no
        # next attempt to cover it
        t = uploads.get("thread")
        if t is not None and t.is_alive():
            logger.info("waiting for the in-flight hub upload to finish")
            t.join(timeout=330.0)
        if averager is not None:
            averager.shutdown()
        tele_close()
        dht.shutdown()


class _Replanner:
    """Live topology re-planning off the coordinator's health folds
    (ISSUE 16 tentpole 1). Each fold's link topology — the SAME fold the
    ``--topology`` view renders — runs through ``plan_topology`` with the
    member ids mapped to ENDPOINT KEYS (what averager matchmaking members
    advertise); on a material structure change the epoch bumps and the plan
    publishes as a signed DHT record (``averaging/planwire.py``). Recent
    per-fold roster loss feeds the planner's ``instability`` signal, so a
    very-unreliable swarm re-plans into gossip mode. Tuning-only updates
    (the actuation guard's applied deltas) re-publish under the SAME epoch
    with a newer ``issued`` stamp — scopes unchanged, no group reshuffle."""

    def __init__(self, dht, prefix: str, extra) -> None:
        self.dht = dht
        self.prefix = prefix
        self.extra = extra
        self.epoch = 0
        self.plan: Optional[TopologyPlan] = None
        self.tuning: dict = {}
        self._structure = None
        self._loss_window = deque(maxlen=4)
        self._prev_labels: set = set()
        self._last_bump_t: Optional[float] = None

    @staticmethod
    def _endpoint_links(topology: dict) -> list:
        """Fold links re-keyed by endpoint ("host:port") — plan member ids
        must match what matchmaking members advertise, not the telemetry
        labels the fold uses. Links whose endpoints the fold does not know
        (client-mode peers) drop out; such peers ride any hierarchical
        plan as direct-WAN singletons (TopologyPlan.assignment)."""
        peers = topology.get("peers") or {}
        out = []
        for link in topology.get("links") or []:
            if not isinstance(link, dict):
                continue
            src_ep = peers.get(link.get("src"))
            dst_ep = link.get("dst_endpoint") or peers.get(link.get("dst"))
            if not src_ep or not dst_ep:
                continue
            rec = dict(link)
            rec["src"], rec["dst"] = str(src_ep), str(dst_ep)
            out.append(rec)
        return out

    @staticmethod
    def _shape(plan: TopologyPlan) -> tuple:
        """The plan's material structure: what has to differ before an
        epoch bump (reason strings and RTT medians churn every fold)."""
        return (
            plan.mode,
            tuple((tuple(c.members), c.delegate) for c in plan.cliques),
            tuple(sorted(plan.peers)),
        )

    def instability(self) -> Optional[float]:
        if not self._loss_window:
            return None
        return sum(self._loss_window) / len(self._loss_window)

    def fold(self, health: dict, t: float) -> Optional[TopologyPlan]:
        """One health fold: update the churn window, derive a plan, and
        publish on material change. Returns the newly published plan (or
        None when nothing changed)."""
        peers_rec = [
            p for p in health.get("peers", []) if isinstance(p, dict)
        ]
        labels = {str(p.get("peer")) for p in peers_rec if p.get("peer")}
        if self._prev_labels:
            lost = self._prev_labels - labels
            self._loss_window.append(
                len(lost) / max(1, len(self._prev_labels))
            )
        self._prev_labels = labels
        topology = health.get("topology")
        if not isinstance(topology, dict):
            return None
        plan = plan_topology(
            self._endpoint_links(topology), instability=self.instability()
        )
        if self._shape(plan) == self._structure:
            return None
        if self.plan is None and plan.mode == "flat":
            # nothing published yet and the planner says "keep today's
            # flat butterfly": publishing epoch 1 of the status quo would
            # only reshuffle scopes for nothing
            self._structure = self._shape(plan)
            return None
        if (
            self._last_bump_t is not None
            and t - self._last_bump_t < self.extra.replan_min_interval_s
        ):
            return None  # re-planning hysteresis: re-derived next fold
        self.epoch += 1
        plan.epoch = self.epoch
        self.plan = plan
        self._structure = self._shape(plan)
        self._last_bump_t = t
        self._publish(plan, t)
        return plan

    def push_tuning(self, tuning: dict, t: float) -> None:
        """Distribute an actuated (or rolled-back) config delta: re-publish
        the current record with the new tuning payload, same epoch."""
        self.tuning = {
            k: v for k, v in dict(tuning).items()
            if isinstance(v, (int, float, bool))
        }
        plan = self.plan
        if plan is None:
            # no topology plan derived yet: a flat epoch-0 carrier record
            # still distributes the tuning delta
            plan = TopologyPlan(
                "flat", "tuning-only record (no topology re-plan yet)"
            )
        self._publish(plan, t)

    def _publish(self, plan: TopologyPlan, t: float) -> bool:
        from dedloc_tpu_torch.averaging.planwire import PlanRecord, publish_plan

        record = PlanRecord(
            epoch=int(plan.epoch),
            plan=plan.to_dict(),
            issued=float(t),
            tuning=dict(self.tuning) if self.tuning else None,
        )
        ok = publish_plan(self.dht, self.prefix, record)
        telemetry.inc("avg.topology.replans")
        telemetry.event(
            "avg.topology.replan",
            epoch=int(plan.epoch),
            mode=plan.mode,
            reason=plan.reason,
            cliques=len(plan.cliques),
            published=bool(ok),
        )
        if ok:
            logger.info(
                f"published topology plan epoch {plan.epoch}: {plan.mode} "
                f"({plan.reason})"
            )
        else:
            logger.warning(
                f"topology plan epoch {plan.epoch} publish failed after "
                "retries; the swarm stays on the previous record"
            )
        return ok


def _load_own_rows(path: str) -> list:
    """Rows of the coordinator's own metrics JSONL, through the SAME
    hardened loader every post-hoc tool uses (utils/jsonl.py): a torn or
    writer-jammed line salvages its complete objects here exactly as it
    would under swarm_watch --recommend, so the self-retune twin fits
    from the same rows. A not-yet-created log reads as empty."""
    from dedloc_tpu_torch.utils.jsonl import load_jsonl_rows

    return load_jsonl_rows([path], warn=logger.warning, missing_ok=True)


def _prev_ledger(path: str) -> Optional[dict]:
    """Last folded ledger state in the durable JSONL (restart-safe seed
    for the next fold); None on a fresh log. Reads through the hardened
    loader, so a torn final line yields the last COMPLETE state."""
    for row in reversed(_load_own_rows(path)):
        if isinstance(row, dict) and isinstance(row.get("ledger"), dict):
            return row["ledger"]
    return None


def _fetch_ledger_records(dht, prefix: str) -> tuple:
    """(claims, receipts) currently live on the DHT, unpacked through the
    same msgpack path the metrics bus uses and re-validated through the
    pydantic schemas (defense in depth over the storing nodes' checks)."""
    from dedloc_tpu_torch.core.serialization import unpack_obj
    from dedloc_tpu_torch.telemetry.ledger import (
        ledger_key,
        parse_claims,
        parse_receipts,
        receipts_key,
    )

    def _items(key: str) -> list:
        entry = dht.get(key, latest=True)
        if entry is None or not hasattr(entry.value, "items"):
            return []
        out = []
        for subkey, v in entry.value.items():
            payload = v.value
            if isinstance(payload, (bytes, bytearray)):
                try:
                    payload = unpack_obj(payload)
                except Exception:  # noqa: BLE001 — undecodable record
                    continue
            out.append((subkey, payload))
        return out

    return (
        parse_claims(_items(ledger_key(prefix))),
        parse_receipts(_items(receipts_key(prefix))),
    )


def _ledger_substance(folded: dict) -> tuple:
    """The fold minus its ever-ticking fields, for change detection: each
    ~30s claim refresh bumps ``last_claim_t``/``train_seconds`` even in a
    live-but-idle swarm, so comparing full per-peer entries would append a
    cumulative ledger row on nearly every tick. Credited/claimed totals,
    rounds, serve bytes, coverage and discrepancies are what a new row is
    FOR — timestamps alone are not."""
    peers = {
        p: {
            k: v
            for k, v in e.items()
            if k not in ("last_claim_t", "train_seconds")
        }
        for p, e in (folded.get("peers") or {}).items()
        if isinstance(e, dict)
    }
    return (peers, folded.get("claims"), folded.get("receipt_signers"))


def _ledger_fold(dht, prefix: str, extra, ledger_state, t, step) -> None:
    """One contribution-ledger fold inline in the coordinator loop: fetch
    the live claim/receipt records, fold them against the previous state
    (telemetry/ledger.fold_ledger), append the cumulative result to the
    durable ledger JSONL, and surface each NEWLY-flagged per-peer
    discrepancy as a ``watch.ledger`` telemetry event + warning. A fold
    that changes nothing of substance (``_ledger_substance`` — fold
    timestamps and per-claim refresh stamps excluded) is not re-appended,
    so neither an idle swarm nor a live-but-idle one grows the log."""
    from dedloc_tpu_torch.telemetry.ledger import fold_ledger

    try:
        claims, receipts = _fetch_ledger_records(dht, prefix)
    except Exception as e:  # noqa: BLE001 — a ledger fetch failure must
        # never take the coordinator loop down; next refresh retries
        logger.warning(f"ledger fetch failed: {e!r}")
        return
    prev = ledger_state.get("prev")
    if not claims and not receipts and prev is None:
        return  # pre-ledger swarm: nothing to fold, nothing to persist
    folded = fold_ledger(
        prev, claims, receipts, slack=extra.ledger_slack, now=t
    )
    changed = prev is None or (
        _ledger_substance(folded) != _ledger_substance(prev)
    )
    ledger_state["prev"] = folded
    if changed:
        try:
            with open(extra.ledger_log_path, "a") as f:
                f.write(
                    json.dumps({
                        "t": folded["t"], "step": step, "ledger": folded,
                    })
                    + "\n"
                )
        except OSError as e:
            logger.warning(f"cannot append ledger log: {e}")
    for peer, entry in folded["peers"].items():
        disc = entry.get("discrepancy")
        if not disc:
            ledger_state["flagged"].pop(peer, None)
            continue
        if ledger_state["flagged"].get(peer) == disc.get("kind"):
            continue  # already surfaced; only a kind change re-fires
        ledger_state["flagged"][peer] = disc.get("kind")
        telemetry.inc("ledger.discrepancies")
        telemetry.event(
            "watch.ledger",
            peer=peer,
            kind=disc.get("kind"),
            claimed_samples=disc.get("claimed_samples"),
            supported_samples=disc.get("supported_samples"),
            ratio=disc.get("ratio"),
            step=step,
        )
        logger.warning(
            f"ledger discrepancy [{disc.get('kind')}] peer {peer}: "
            f"claimed {disc.get('claimed_samples')} vs receipt-supported "
            f"{disc.get('supported_samples')}"
        )


def _append_incident(extra, t, step, transition, incident) -> None:
    """One transition record onto the incident JSONL (replayable by
    ``runlog_summary --incidents``; for recorded logs the view keeps the
    LAST state per incident id, so a later ``recommendation`` record
    supersedes the bare ``retune_eligible`` one)."""
    record = {
        "t": t,
        "step": step,
        "watch": "incident",
        "transition": transition,
        # deep JSON copy: the live incident dict keeps mutating (effects,
        # severity escalation) after this transition
        "incident": json.loads(json.dumps(incident, default=str)),
    }
    try:
        with open(extra.incident_log_path, "a") as f:
            f.write(json.dumps(record) + "\n")
    except OSError as e:
        logger.warning(f"cannot append incident log: {e}")


def _spawn_retune(incident, agg, extra, retunes) -> None:
    """Fit-and-recommend OFF the fold loop (same shape as the hub-upload
    thread): the twin fit plus its bounded sweep costs seconds of replay,
    and it must not stall metrics folding on exactly the fleet that is
    already regressing. One retune in flight at a time; the follow-up
    ``recommendation`` record lands when it finishes. The slow fit runs
    into a LOCAL result; the live incident dict is only touched (and
    serialized) under ``retunes["lock"]`` — the fold loop keeps appending
    effects to the same dict while this thread runs."""
    prev = retunes.get("thread")
    if prev is not None and prev.is_alive():
        # busy is TRANSIENT: attach nothing — the per-fold eligibility
        # re-check in _watch_fold dispatches this incident again once the
        # in-flight fit finishes (the old permanent "retune skipped"
        # reason froze the incident without a recommendation forever)
        logger.debug(
            f"retune for {incident['id']} deferred: a previous twin fit "
            "is still running"
        )
        return

    def _do(incident=incident, t=agg["time"], step=agg["step"]):
        try:
            from dedloc_tpu_torch.telemetry.watch import twin_recommendation

            # fit from the coordinator's OWN durable log: on a bus-only
            # fleet (health records carry no round summaries) this reports
            # "no recommendation: <reason>" instead of guessing — point
            # collected per-peer event logs at tools/swarm_watch.py
            # --recommend for the full-fidelity fit
            result = twin_recommendation(
                _load_own_rows(extra.metrics_log_path)
            )
        except Exception as e:  # noqa: BLE001 — a retune failure must
            # never take the watchdog (or the coordinator) down with it.
            # It is also usually TRANSIENT (the metrics JSONL jammed
            # mid-write, a briefly-full disk): count the attempt and let
            # the next fold retry; only a repeatedly-failing fit attaches
            # a permanent reason.
            logger.warning(f"watchdog retune failed: {e!r}")
            with retunes["lock"]:
                attempts = int(incident.get("retune_attempts", 0)) + 1
                incident["retune_attempts"] = attempts
                if attempts >= max(1, extra.retune_max_attempts):
                    incident["recommendation_reason"] = (
                        f"retune failed after {attempts} attempts "
                        f"(last: {e!r})"
                    )
                    _append_incident(
                        extra, t, step, "recommendation", incident
                    )
            return
        with retunes["lock"]:
            if "no_recommendation" in result:
                # a DEFINITIVE reason from the fit itself (insufficient
                # coverage, unvalidated twin): attaching it is final
                incident["recommendation_reason"] = (
                    result["no_recommendation"]
                )
            else:
                incident["recommendation"] = result
            _append_incident(extra, t, step, "recommendation", incident)

    import threading

    retunes["thread"] = threading.Thread(target=_do, daemon=True)
    retunes["thread"].start()


def _watch_fold(watch, health, agg, extra, retunes,
                actuation=None, replanner=None) -> None:
    """One watchdog fold inline in the coordinator loop: stream the fresh
    health record through the detectors, persist every incident transition
    to the incident JSONL (same directory as the metrics log), surface it
    as a ``watch.incident`` telemetry event, kick off the background twin
    retune for eligible incidents (re-dispatched on later folds while a
    transient failure left no recommendation attached), and drive the
    actuation guard (apply → observe → keep-or-rollback).

    The WHOLE fold holds ``retunes["lock"]``: observe_health mutates live
    incident dicts (effects, severity, representative round) that the
    retune thread also mutates and serializes when its fit completes —
    the fold is pure in-memory computation, so the retune thread waits at
    most microseconds, never the other way around (the slow twin fit runs
    OUTSIDE the lock)."""
    with retunes["lock"]:
        transitions = watch.observe_health(
            health,
            t=agg["time"],
            step=agg["step"],
            samples_per_sec=agg.get("samples_per_second"),
        )
        for tr in transitions:
            incident = tr["incident"]
            _append_incident(
                extra, agg["time"], agg["step"], tr["transition"], incident
            )
            telemetry.event(
                "watch.incident",
                transition=tr["transition"],
                incident_id=incident["id"],
                kind=incident["kind"],
                metric=incident["metric"],
                subject=incident["subject"],
                severity=incident["severity"],
                peer=incident.get("peer"),
            )
            log = (
                logger.warning if tr["transition"] == "open"
                else logger.info
            )
            log(
                f"watchdog {tr['transition']}: [{incident['id']}] "
                f"{incident['severity']} {incident['kind']} "
                f"{incident['subject']} ({incident['metric']})"
            )
        if extra.retune_on_regression:
            # per-fold re-check, not just the one-shot retune_eligible
            # transition: an incident whose fit failed transiently (or was
            # deferred behind an in-flight fit) carries neither a
            # recommendation nor a reason yet and is dispatched again
            for incident in watch.open_incidents():
                if (
                    incident.get("retune_eligible")
                    and "recommendation" not in incident
                    and "recommendation_reason" not in incident
                ):
                    _spawn_retune(incident, agg, extra, retunes)
        if actuation is not None:
            _actuation_fold(watch, agg, extra, actuation, replanner)


def _incident_by_id(watch, incident_id):
    for incident in watch.incidents:
        if incident["id"] == incident_id:
            return incident
    return None


def _actuation_fold(watch, agg, extra, actuation, replanner) -> None:
    """Drive the actuation guard for one fold (caller holds the retune
    lock): judge the in-flight actuation against this fold's throughput
    (rolling it back when it regressed past the pre-change level), then
    apply at most one new eligible recommendation under the guard rail.
    Every actuation/rollback lands as an incident effect, an incident-JSONL
    transition and a ``watch.actuation``/``watch.rollback`` event; the
    resulting config delta rides the plan record's tuning field out to the
    peers (``_Replanner.push_tuning``)."""
    from dedloc_tpu_torch.telemetry.watch import rollback_effect

    guard = actuation["guard"]
    epoch = replanner.epoch if replanner is not None else 0
    t, step = agg["time"], agg["step"]
    sps = agg.get("samples_per_second")

    verdict = guard.observe(sps, fold=watch.fold)
    if verdict is not None:
        incident = _incident_by_id(watch, verdict.get("incident"))
        if verdict["verdict"] == "rollback":
            actuation["config"].update(verdict["revert"])
            telemetry.inc("watch.rollbacks")
            telemetry.event(
                "watch.rollback",
                incident_id=verdict.get("incident"),
                applied=json.dumps(verdict["revert"]),
                observed_samples_per_sec=(
                    verdict["observed"][-1] if verdict["observed"] else None
                ),
                baseline_samples_per_sec=(
                    verdict.get("baseline_samples_per_sec")
                ),
            )
            logger.warning(
                f"actuation rolled back for {verdict.get('incident')}: "
                f"reverting {verdict['revert']} (post-change throughput "
                "regressed past the pre-change level)"
            )
            if incident is not None:
                rollback_effect(incident, verdict)
                _append_incident(extra, t, step, "rollback", incident)
            if replanner is not None:
                replanner.push_tuning(actuation["config"], t)
        else:  # kept
            telemetry.event(
                "watch.actuation",
                incident_id=verdict.get("incident"),
                applied=json.dumps(verdict["applied"]),
                verdict="kept",
            )
            logger.info(
                f"actuation kept for {verdict.get('incident')}: "
                f"{verdict['applied']} held through "
                f"{len(verdict['observed'])} fold(s)"
            )
            if incident is not None:
                for effect in incident.get("effects", []):
                    if (
                        effect.get("metric") == "actuation"
                        and effect.get("applied") == verdict["applied"]
                    ):
                        effect["verdict"] = "kept"
                _append_incident(extra, t, step, "actuation", incident)

    for incident in watch.open_incidents():
        recommendation = incident.get("recommendation")
        if not recommendation or incident.get("actuated"):
            continue
        result = guard.consider(
            recommendation, actuation["config"],
            fold=watch.fold, epoch=epoch,
        )
        if "refused" in result:
            # NOT final — cooldowns expire and budgets reset with the next
            # plan epoch, so the guard is re-consulted every fold
            incident["actuation_refused"] = result["refused"]
            continue
        incident.pop("actuation_refused", None)
        actuation["config"].update(result["apply"])
        incident["actuated"] = True
        guard.actuate(
            incident, result["apply"], result["revert"],
            fold=watch.fold, baseline_samples_per_sec=sps,
            epoch=epoch, clamped=tuple(result["clamped"]),
        )
        telemetry.inc("watch.actuations")
        telemetry.event(
            "watch.actuation",
            incident_id=incident["id"],
            applied=json.dumps(result["apply"]),
            verdict="applied",
        )
        logger.warning(
            f"actuating twin recommendation for {incident['id']}: "
            f"applying {result['apply']}"
            + (f" (clamped: {result['clamped']})" if result["clamped"]
               else "")
        )
        _append_incident(extra, t, step, "actuation", incident)
        if replanner is not None:
            replanner.push_tuning(actuation["config"], t)
        break  # one actuation per fold; the guard serializes the rest


def _pull_and_save(args, averager, step, upload_fn, uploads) -> None:
    result = averager.load_state_from_peers()
    if result is None:
        logger.warning("no state providers yet; skipping checkpoint")
        return
    metadata, tree = result
    path = save_checkpoint(
        args.training.output_dir,
        step,
        tree,
        metadata=metadata,
        save_total_limit=args.training.save_total_limit,
    )
    logger.info(f"saved collaboration checkpoint {path}")
    # swarm checkpointing (--checkpoint.*): write the durable manifest +
    # content-addressed shards next to the legacy blob (shards unchanged
    # between steps are stored once), and drop the manifest into the
    # checkpoint dir so the hub upload below publishes it — a mirror
    # consumer can then verify shard integrity against the signed digest
    if getattr(args, "checkpoint", None) and args.checkpoint.shard_size > 0:
        from dedloc_tpu_torch.checkpointing import save_sharded_checkpoint

        try:
            manifest = save_sharded_checkpoint(
                os.path.join(args.training.output_dir, "sharded"),
                tree,
                step,
                shard_size=args.checkpoint.shard_size,
                metadata=metadata,
                keep=args.training.save_total_limit,
            )
            with open(os.path.join(path, "manifest.bin"), "wb") as f:
                f.write(manifest.to_bytes())
            telemetry.inc("ckpt.manifests_written")
            telemetry.event(
                "ckpt.manifest_written", step=step,
                shards=manifest.num_shards, bytes=manifest.total_bytes,
            )
            logger.info(
                f"wrote sharded checkpoint manifest at step {step} "
                f"({manifest.num_shards} shards)"
            )
        except ValueError as e:
            # a tree that cannot roundtrip the fp32 layout stays blob-only
            logger.warning(f"sharded checkpoint skipped: {e}")
    if upload_fn is not None:
        # background thread (reference behavior, run_first_peer.py:139): a
        # slow push must not block metrics aggregation or checkpointing.
        # One upload in flight at a time — a new checkpoint while the
        # previous push still runs skips its upload (the next interval
        # covers it; the shutdown path joins the last one so the final
        # checkpoint is never abandoned).
        prev = uploads.get("thread")
        if prev is not None and prev.is_alive():
            logger.warning(
                f"previous hub upload still in flight; skipping step {step}"
            )
            return

        def _do_upload(path=path, step=step):
            try:
                upload_fn(path, step)
            except Exception as e:  # noqa: BLE001 — a hub blip must not
                # kill the coordinator; the git helper is also bounded by a
                # subprocess timeout so a stalled remote cannot wedge this
                # thread forever
                logger.warning(f"hub upload failed for step {step}: {e}")

        import threading

        uploads["thread"] = threading.Thread(target=_do_upload)
        uploads["thread"].start()


def _maybe_wandb(args: CollaborationArguments):
    if not args.wandb_project:
        return None
    try:
        import wandb  # type: ignore

        return wandb.init(project=args.wandb_project)
    except Exception as e:  # noqa: BLE001 — wandb genuinely optional
        logger.warning(f"wandb unavailable ({e!r}); JSONL logging only")
        return None


@dataclass
class CoordinatorCLIArguments(CollaborationArguments):
    coordinator: CoordinatorExtraArguments = field(
        default_factory=CoordinatorExtraArguments
    )


def main(argv=None) -> None:
    args = parse_config(CoordinatorCLIArguments, argv)
    run_coordinator(args, args.coordinator)


if __name__ == "__main__":
    main()
