"""CollaborativeOptimizer: DeDLOC's global-step averaging, on the card.

Port of ``dedloc_tpu/collaborative/optimizer.py``: the same protocol,
bookkeeping, fallbacks and public surface, with each tensor seam on
PyTorch. Gradients are dicts of fp32 tensors keyed by the port's parameter
names; on the wire (the device-flat pipeline, the legacy host path, the
shared state) every tensor carries the JAX package's name, shape and
element order (``models/convert.py``), so a torch peer and a JAX peer
average in the same rounds and serve each other's state. Off a mesh every
global step applies through the flat step (``make_flat_apply_step`` over
the flat twin of the peer's optimizer, ``optim.flat.flat_twin``): alone or
averaged, before or after the grace period, and on the local-apply
fallback. The apply is sync-free; the NaN verdict is read at the next
boundary.

Semantics parity with hivemind.CollaborativeOptimizer as consumed by all
three reference trainers (SURVEY.md §2.6, §3.1): accumulate gradients
locally until the COLLABORATION-wide sample count reaches
``target_batch_size``, then form a group, average gradients (weighted by
each peer's accumulated samples) and apply one optimizer step keyed by the
GLOBAL step counter. Exposes ``local_step``, ``collaboration_state``,
``is_synchronized``, ``performance_ema``, ``local_samples_accumulated``,
``load_state_from_peers`` and ``step_aux`` — the exact attribute surface the
reference trainers consume.

Split (SURVEY.md §7 hard-parts b,c):
- callers run ``make_accumulate_step`` per micro-batch with a
  device-resident fp32 grad accumulator;
- ``step`` crosses the device↔asyncio seam exactly once per GLOBAL step
  (the flat copy of the mean grads), not per micro-batch.

With a slice ``mesh`` (``mesh_devices > 1``) this optimizer runs on the
slice's rank 0 and drives the other ranks through ``collaborative/slice.py``:
the boundary's gradients are summed and gathered to full tensors here, the
averaged result goes back to every rank, which applies on its own blocks
(the guarded per-leaf apply, the only apply on a slice, as in the JAX
package), and shared state and adopted state cross as full tensors.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from dedloc_tpu_torch.averaging.allreduce import DEFAULT_CHUNK_SIZE
from dedloc_tpu_torch.averaging.averager import DecentralizedAverager
from dedloc_tpu_torch.averaging.device_flat import DeviceFlatPipeline
from dedloc_tpu_torch.averaging.partition import FlatTree
from dedloc_tpu_torch.collaborative.error_feedback import ErrorFeedback
from dedloc_tpu_torch.collaborative.progress import (
    CollaborationState,
    LocalProgress,
    ProgressTracker,
)
from dedloc_tpu_torch.core.timeutils import PerformanceEMA, get_dht_time
from dedloc_tpu_torch.dht.dht import DHT
from dedloc_tpu_torch.telemetry import registry as telemetry
from dedloc_tpu_torch.telemetry import steps
from dedloc_tpu_torch.telemetry.registry import monotonic_clock
from dedloc_tpu_torch.models.convert import from_jax_layout, grad_name, to_jax_layout
from dedloc_tpu_torch.ops import multi_tensor
from dedloc_tpu_torch.optim.flat import flat_twin
from dedloc_tpu_torch.parallel.train_step import (
    TrainState,
    make_flat_apply_step,
    make_guarded_apply_step,
    zeros_like_grads,
)
from dedloc_tpu_torch.telemetry.steps import block_on_device
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _grads_to_named(grads: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Gradients -> {JAX wire name: host array in the JAX element order}."""
    out = {}
    for name, g in grads.items():
        jname, perm = grad_name(name, g.ndim)
        out[jname] = to_jax_layout(g, perm).contiguous().cpu().numpy()
    return out


def _named_to_grads(named: Dict[str, np.ndarray],
                    like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of ``_grads_to_named`` onto the device of ``like`` (the
    params). Raises ``KeyError``/``ValueError`` when a name or shape does
    not match."""
    out = {}
    for name, p in like.items():
        jname, perm = grad_name(name, p.ndim)
        arr = np.asarray(named[jname], dtype=np.float32)
        t = torch.from_numpy(from_jax_layout(arr, perm))
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{jname}: shape {tuple(arr.shape)} does not "
                             f"match the local {tuple(p.shape)}")
        out[name] = t.to(p.device, copy=True)
    return out


def _state_views(state: TrainState, tx) -> Dict[str, torch.Tensor]:
    """(params, opt_state) under the JAX peer's shared-state names, as views
    in the JAX element order: the optimizer (``Lamb`` or ``Lars``) names
    its own state (``state_views``)."""
    return tx.state_views(state.params, state.opt_state)


@steps.in_region("mean_clip")
def _fused_mean_clip(grad_acc: Dict[str, torch.Tensor], n, cap: float):
    """The accumulator mean plus the contribution clip: ``grad_acc / n``
    per leaf, one global-norm reduce (a fixed-order sum of per-leaf sums,
    deterministic), one scale; multi-tensor passes over the leaves
    (``ops/multi_tensor.py`` ``mean_clip``), the result fp32 views of one
    buffer. ``cap <= 0`` disables the clip (the JAX package multiplies by
    exactly 1.0 there, a bitwise no-op)."""
    return multi_tensor.mean_clip(grad_acc, n, cap)


def adopt_state(state: TrainState, named: Dict[str, np.ndarray], step: int,
                tx) -> TrainState:
    """Copy a shared state (JAX names, from a JAX or a torch peer, or a
    checkpoint) into ``state``'s tensors in place; ``step`` is the train
    state's step. The optimizer's state is a NamedTuple of tensor dicts
    (moments, momentum) and counts; ``tx.state_from_named`` reads it.
    Every name and shape is checked before anything is written: a mismatch
    raises ``KeyError``/``ValueError`` and leaves ``state`` as it was."""
    expected = _state_views(state, tx)
    if set(named) != set(expected):
        diff = sorted(set(named) ^ set(expected))
        raise KeyError(f"state names differ: {diff[:4]}")
    params, remote_opt = tx.state_from_named(named)
    opt = state.opt_state
    tensor_fields = [f for f in opt._fields if isinstance(getattr(opt, f), dict)]
    pairs = []
    for local, remote in [(state.params, params)] + [
            (getattr(opt, f), getattr(remote_opt, f)) for f in tensor_fields]:
        for name, t in local.items():
            if tuple(remote[name].shape) != tuple(t.shape):
                raise ValueError(
                    f"{name}: shape {tuple(remote[name].shape)} does not "
                    f"match the local {tuple(t.shape)}")
            pairs.append((t, remote[name]))
    with torch.no_grad():
        for t, new in pairs:
            t.copy_(new)
    device = next(iter(state.params.values())).device
    as_count = lambda c, like: (
        torch.tensor(c, dtype=torch.int32, device=device)
        if isinstance(like, torch.Tensor) else c)
    return TrainState(
        step=as_count(step, state.step),
        params=state.params,
        opt_state=opt._replace(**{
            f: as_count(getattr(remote_opt, f), getattr(opt, f))
            for f in opt._fields if f not in tensor_fields}),
    )


class CollaborativeOptimizer:
    def __init__(
        self,
        tx,  # optim.lamb.Lamb or optim.lars.Lars
        dht: DHT,
        prefix: str,
        target_batch_size: int = 4096,
        batch_size_per_step: Optional[int] = None,
        batch_size_lead: int = 0,
        bandwidth: float = 1000.0,
        compression: str = "float16",
        target_group_size: int = 256,
        averaging_expiration: float = 5.0,
        averaging_timeout: float = 30.0,
        metadata_expiration: float = 30.0,
        statistics_expiration: float = 600.0,
        min_refresh_period: float = 0.5,
        max_refresh_period: float = 30.0,
        default_refresh_period: float = 3.0,
        expected_drift_peers: float = 3.0,
        expected_drift_rate: float = 0.2,
        performance_ema_alpha: float = 0.1,
        client_mode: bool = False,
        relay: Optional[str] = None,  # circuit relay for client-mode peers
        auxiliary: bool = False,
        allow_state_sharing: bool = True,
        mesh=None,  # the slice mesh (parallel/mesh.py); this is its rank 0
        opt_state_sharding=None,  # ZeRO-1 moment layout (parallel.zero)
        param_sharding=None,  # tensor/expert-parallel layout (parallel.sharding)
        verbose: bool = False,
        listen_host: str = "0.0.0.0",
        listen_port: int = 0,  # fixed averager port (0 = ephemeral); a
        # listening averager doubles as a circuit relay, so public peers in
        # relayed deployments want this pinned (--averager.listen_port)
        advertised_host: Optional[str] = None,
        post_apply: Optional[Callable[[TrainState], TrainState]] = None,
        authorizer=None,  # token authorizer for gated public runs
        authority_public_key: Optional[bytes] = None,
        contrib_clip_per_sample: float = 0.0,  # cap the contributed
        # per-MICRO-batch mean grad at clip*(samples/micro-batch) before
        # averaging — tiny-batch peers inject high-per-sample-energy noise
        # otherwise (core/config.py CollaborativeOptimizerArguments)
        ramp_rounds: int = 0,  # contribution ramp (0 = off): scale this
        # peer's averaging weight from near-zero to its full sample count
        # over its first ramp_rounds completed global steps — a fresh
        # joiner receives the group's direction while barely perturbing it
        # during basin formation (the enforced form of docs/fleet.md's
        # "onboard onto a formed trunk" guidance)
        health_gate_loss_ratio: float = 0.0,  # trunk-health gate (0 = off):
        # while this peer's advertised loss exceeds ratio x the median
        # advertised loss of the OTHER trainers, it defers mixing entirely
        # (contributes weight 0, still receives the group average)
        state_sync_retries: int = 2,  # bounded state-download retry with
        state_sync_backoff: float = 0.5,  # exponential backoff (averager)
        checkpoint_shard_size: int = 1 << 20,  # swarm checkpointing
        # (--checkpoint.*, dedloc_tpu/checkpointing): fp32 elements per
        # content-addressed shard of the shared state; <= 0 disables the
        # sharded serve/catalog/restore path (full blob only). Defaults ON
        # here (deployment surface) while the bare averager defaults OFF.
        checkpoint_fetch_parallelism: int = 4,
        checkpoint_max_providers: int = 0,
        checkpoint_dir: Optional[str] = None,  # local shard cache for
        # resumable restores (None = in-memory only)
        signed_subkey: Optional[bytes] = None,  # the peer's signed metrics
        # subkey: catalog announcements ride it so they are signature-bound
        chunk_size: int = DEFAULT_CHUNK_SIZE,  # elements per wire chunk in
        # the pipelined all-reduce; <= 0 restores monolithic spans (the
        # pre-pipeline wire format) — same contract as --averager.chunk_size
        topology_plan=None,  # hierarchical two-level averaging plan
        # (averaging/topology.py; --averager.topology_plan): a TopologyPlan
        # or a path to its JSON. None / mode="flat" keeps the flat
        # butterfly; failures inside a hierarchical round fall back to a
        # flat retry of the same round automatically.
        plan_follow: bool = False,  # live re-planning (planwire.py):
        # poll the coordinator's epoch-versioned plan record and adopt the
        # newest valid plan between rounds; the roles enable this unless a
        # manual topology_plan is pinned (the opt-out, docs/fleet.md)
        plan_refresh_period: float = 30.0,
        error_feedback: bool = True,  # residual error feedback for lossy
        # wire compression: the previous round's quantization error is added
        # back into the next round's contribution, so float16/uint8 wire
        # formats don't bias the trunk (collaborative/error_feedback.py).
        # No-op under compression="none".
        overlap_averaging: bool = False,  # opt-in background averaging: at
        # a round boundary the averaging round is launched on the executor
        # and the trainer KEEPS ACCUMULATING the next microbatches; the
        # averaged update is applied when the round lands — one boundary
        # late (bounded staleness). Auto-disabled during the contribution
        # ramp, while health-gated, and around state sync; a failed
        # overlapped round restores its gradients into the accumulator and
        # falls back to the synchronous path (docs/fleet.md).
        telemetry_registry=None,  # per-peer telemetry scope, forwarded to
        # the averager/matchmaking/RPC stack (telemetry/registry.py); None
        # falls back to the process-global registry at each site
        device_flat: bool = True,  # device-resident flat gradient pipeline
        # (averaging/device_flat.py): the boundary's mean/clip/error-
        # feedback/quantize all run on the card and
        # the compressed representation streams to the host in async chunks
        # — the grad_flatten phase transfers 2-4x fewer PCIe bytes under a
        # lossy wire format and the host codec becomes decode-only. Falls
        # back to the legacy per-leaf host path automatically when the
        # gradient tree is refused (non-float leaves).
        ledger_claims: bool = True,  # contribution ledger
        # (telemetry/ledger.py): periodically publish this peer's signed
        # cumulative ContributionClaim DHT record off the progress-report
        # cadence; group-mates' RoundReceipts make it checkable
        claim_period: float = 30.0,  # dht-time seconds between claims
        ledger_receipts: bool = True,  # countersign averaging rounds into
        # RoundReceipt records (forwarded to the averager, which owns the
        # group envelope the receipt is built from)
    ):
        assert not (client_mode and auxiliary), "an auxiliary peer must listen"
        self._slice = None
        if mesh is not None and mesh.size > 1:
            from dedloc_tpu_torch.collaborative.slice import Slice

            self._slice = Slice(mesh, tx, param_sharding, opt_state_sharding)
        self.tx = tx
        self.dht = dht
        self.prefix = prefix
        self.target_batch_size = target_batch_size
        self.batch_size_per_step = batch_size_per_step
        self.client_mode = client_mode
        self.auxiliary = auxiliary
        self.verbose = verbose
        self.statistics_expiration = statistics_expiration
        self.contrib_clip_per_sample = float(contrib_clip_per_sample)
        self.ramp_rounds = int(ramp_rounds)
        self.health_gate_loss_ratio = float(health_gate_loss_ratio)
        # completed global steps since THIS optimizer joined — drives the
        # contribution ramp. Deliberately reset on restart: a rejoining
        # peer's params may have drifted while it was away, so it re-ramps.
        self._rounds_since_join = 0
        self._last_loss: Optional[float] = None
        self.telemetry = telemetry_registry
        self.overlap_averaging = bool(overlap_averaging)
        # in-flight overlapped round: {future, named, commit, collab,
        # samples, n_micro, partners_certain} — at most ONE at a time
        self._overlap_inflight: Optional[Dict[str, Any]] = None
        # after a failed overlapped round the next boundary runs the
        # synchronous path (and its retry/resync ladder); a successful
        # global step re-arms overlap
        self._overlap_cooldown = False
        # samples committed to the in-flight round: still advertised in
        # progress reports until the round lands — zeroing the advertised
        # count at an unchanged step would deflate the collaboration-wide
        # sum and flip partners' ready_for_step back off (the sync path
        # keeps its full count published throughout averaging and resets
        # only together with the step advance)
        self._overlap_committed_samples = 0
        # overlap ledger (docs/observability.md "overlap ledger"): per
        # boundary, how much of the averaging round's launch→finish wall was
        # HIDDEN behind concurrent accumulation vs EXPOSED as stall. Clocked
        # on the FakeClock-aware monotonic clock; only maintained when
        # overlap_averaging is configured (it measures that feature).
        self._overlap_launched_at = 0.0
        self._overlap_resumed_at: Optional[float] = None
        self._overlap_done_at: Optional[float] = None
        self._overlap_hidden_s = 0.0
        self.error_feedback = ErrorFeedback(
            compression if error_feedback else "none"
        )

        self.averager = DecentralizedAverager(
            dht,
            prefix,
            bandwidth=bandwidth,
            client_mode=client_mode,
            auxiliary=auxiliary,
            allow_state_sharing=allow_state_sharing and not auxiliary,
            compression=compression,
            chunk_size=chunk_size,
            averaging_expiration=averaging_expiration,
            averaging_timeout=averaging_timeout,
            target_group_size=target_group_size,
            listen_host=listen_host,
            listen_port=listen_port,
            advertised_host=advertised_host,
            authorizer=authorizer,
            authority_public_key=authority_public_key,
            relay=relay,
            state_sync_retries=state_sync_retries,
            state_sync_backoff=state_sync_backoff,
            checkpoint_shard_size=checkpoint_shard_size,
            checkpoint_fetch_parallelism=checkpoint_fetch_parallelism,
            checkpoint_max_providers=checkpoint_max_providers,
            checkpoint_dir=checkpoint_dir,
            signed_subkey=signed_subkey,
            telemetry_registry=telemetry_registry,
            topology_plan=topology_plan,
            plan_follow=plan_follow,
            plan_refresh_period=plan_refresh_period,
            ledger_receipts=ledger_receipts,
        )
        self.tracker = ProgressTracker(
            dht,
            prefix,
            peer_subkey=self.averager.peer_id,
            target_batch_size=target_batch_size,
            min_refresh_period=min_refresh_period,
            max_refresh_period=max_refresh_period,
            default_refresh_period=default_refresh_period,
            metadata_expiration=metadata_expiration,
            expected_drift_peers=expected_drift_peers,
            expected_drift_rate=expected_drift_rate,
            batch_size_lead=batch_size_lead,
        )
        self.performance_ema = PerformanceEMA(alpha=performance_ema_alpha)
        self._ema_started = False
        self._created_at = get_dht_time()
        self.local_step = 0
        self.local_samples_accumulated = 0
        # post-update transform on the new state (e.g. SwAV prototype
        # re-normalization — NormalizePrototypesHook.on_update capability,
        # swav_hooks.py:55-92), applied to the new params before the
        # all-finite check of either apply
        self.post_apply = post_apply
        # both applies fold the NaN guard in (an all-finite reduce +
        # torch.where rollback): no pre-apply copy of (step, params,
        # opt_state), no host-synced finite check; the ok flag is read one
        # boundary later (_check_apply_ok). On a slice every rank applies
        # the per-leaf guarded apply to its own blocks; off a mesh every
        # global step takes the flat apply (_ensure_flat_apply)
        self._apply_fn = None
        if self._slice is not None:
            self._apply_fn = make_guarded_apply_step(
                tx, mesh=mesh, opt_state_sharding=opt_state_sharding,
                param_sharding=param_sharding, post_apply=post_apply,
            )
        # (spec key, flat optimizer, {from_tree: flat apply}) of the last
        # gradient spec
        self._flat_apply: Optional[Tuple[Any, Any, Dict[bool, Callable]]] = None
        # device-resident flat gradient pipeline (built lazily from the
        # first boundary's gradient tree; see the constructor docstring)
        self.device_flat = bool(device_flat)
        self._pipeline: Optional[DeviceFlatPipeline] = None
        # the apply the last global step took: "flat" off a mesh, "leaf"
        # (the per-leaf guarded apply) on a slice
        self.last_apply: Optional[str] = None
        self.last_group_size: Optional[int] = None
        # (round_id, device ok scalar) of the most recent apply:
        # fetched lazily at the NEXT boundary so the NaN verdict never
        # stalls the dispatch stream (the legacy host-synced check cost a
        # full device round-trip per global step)
        self._pending_apply_ok: Optional[Tuple[str, Any]] = None
        self._lock = threading.Lock()
        # the state backup (the copy of params+opt_state) runs on this
        # thread, OFF the critical path: it is read-only w.r.t. the next
        # round's gradients, so the next accumulation phase overlaps it
        # (SURVEY.md §7 hard-part b; seam cost published in BASELINE.md)
        self._backup_thread: Optional[threading.Thread] = None
        # the backup transfer may use at most this fraction of wall time, so
        # a slow device↔host link (e.g. a tunneled device: ~10 MB/s vs
        # PCIe's GB/s) degrades to periodic backups instead of serializing
        # every global step behind a full state download
        self.backup_duty_cycle = 0.5
        self._backup_done_at = 0.0
        self._backup_took = 0.0
        # device↔host seam telemetry (ms, last global step)
        self.seam_ms: Dict[str, float] = {}
        self._desynced = False
        self._round_failures = 0
        self.max_round_retries = 2
        # staleness tolerance: a peer that slipped at most this many steps
        # behind ADOPTS the global counter and keeps contributing gradients
        # (computed on slightly-stale params — the bias is bounded and its
        # averaging weight is its sample count); only a larger gap, or an
        # explicit desync, triggers the full state download. Without this a
        # slow volunteer in a fast collaboration lives in a resync loop: the
        # download takes longer than the fast peer's round period, so it
        # re-enters catch-up forever and never computes (round-5 sweep).
        self.resync_step_gap = 8
        self._aux_misses = 0
        self._aux_withheld_at = 0.0
        # contribution-ledger counters (telemetry/ledger.py): cumulative over
        # this peer's lifetime, NOT zeroed at global steps (claim records are
        # last-write-wins per signed subkey, so they must be monotone)
        self.ledger_claims = bool(ledger_claims)
        self.claim_period = float(claim_period)
        self.contrib_samples_total = 0
        self.contrib_rounds_total = 0
        self._last_claim_t = 0.0

    # ------------------------------------------------------------ properties

    @property
    def collaboration_state(self) -> CollaborationState:
        return self.tracker.fetch_collaboration_state()

    @property
    def is_synchronized(self) -> bool:
        return self.local_step >= self.collaboration_state.optimizer_step

    # ------------------------------------------------------------------ step

    def step(
        self,
        state: TrainState,
        grad_acc,
        n_acc,
        samples: int,
    ) -> Tuple[TrainState, Any, Any, bool]:
        """Per-accumulation-boundary call. Returns (state, grad_acc, n_acc,
        performed_global_step). All heavy work happens only when the global
        target batch is reached. On a slice mesh the other ranks follow
        the boundary (``Slice.follow``) until its ``end``."""
        assert not self.auxiliary, "auxiliary peers must use step_aux()"
        if self._slice is None:
            return self._step(state, grad_acc, n_acc, samples)
        state, out_acc, out_n, stepped = self._step(state, grad_acc, n_acc, samples)
        if out_acc is self._slice.gathered:
            # a round to retry keeps the accumulation: the ranks' own parts
            out_acc, out_n = self._slice.live
        # an overlapped launch commits every rank's parts (Slice.commit);
        # a restore added them back into grad_acc in place
        out_acc, out_n = self._slice.end(stepped, out_acc is not grad_acc,
                                         self.local_step, out_acc, out_n)
        return state, out_acc, out_n, stepped

    def _step(self, state: TrainState, grad_acc, n_acc, samples: int):
        with self._lock:
            tele = telemetry.resolve(self.telemetry)
            if tele is not None and samples > 0:
                # accumulation-boundary trace; samples == 0 is a retry poll
                # while a round assembles, not a boundary
                tele.counter("opt.boundaries").inc()
            self.local_samples_accumulated += samples
            self.contrib_samples_total += samples
            if self._ema_started:
                # samples == 0 is a retry poll while a round assembles —
                # neither progress nor throughput signal (and it must not
                # touch the EMA clock: a resume() here would discard the
                # elapsed interval and inflate samples/sec)
                if samples > 0:
                    self.performance_ema.update(samples)
            else:
                # first call: start the clock only — measuring from resume()
                # to now would seed the EMA with a near-zero interval and
                # publish absurd samples/sec to the DHT (and this also keeps
                # compile time out of throughput stats)
                self.performance_ema.resume()
                self._ema_started = True

            if self._overlap_inflight is not None:
                # overlap ledger: the wall since this peer resumed
                # accumulating was HIDDEN behind the in-flight round — but
                # only up to the moment the round actually finished
                # (accumulation past that point hides nothing)
                now = monotonic_clock()
                if self._overlap_resumed_at is not None:
                    done_at = self._overlap_done_at
                    covered = (min(now, done_at) if done_at is not None
                               else now)
                    self._overlap_hidden_s += max(
                        0.0, covered - self._overlap_resumed_at
                    )
                    self._overlap_resumed_at = None
                if not self._overlap_inflight["future"].done():
                    # a background round is in flight: keep accumulating —
                    # its result applies one boundary late (the overlap
                    # staleness contract, docs/fleet.md). Catch-up/ramp
                    # decisions wait until the round lands.
                    with steps.phase("collab"):
                        self._report(synced=True)
                    self._overlap_resumed_at = monotonic_clock()
                    return state, grad_acc, n_acc, False
                state, grad_acc, n_acc, stepped, applied = (
                    self._harvest_overlap(state, grad_acc, n_acc)
                )
                if applied:
                    return state, grad_acc, n_acc, stepped
                # failed overlapped round: its gradients were restored into
                # the accumulator — fall through to the synchronous path

            with steps.phase("collab"):
                collab = self.tracker.fetch_collaboration_state()
            gap = collab.optimizer_step - self.local_step
            if (
                gap > self.resync_step_gap
                or self._desynced
                # never been synced at all (fresh init joining a live run):
                # stale-tolerance is for peers that HAVE the collaboration's
                # state modulo a few applies, not for random-init params
                or (gap > 0 and self.local_step == 0)
            ):
                # we fell FAR behind (or our last round failed while others
                # averaged) — catch up from peers: full state download
                if tele is not None:
                    tele.counter("opt.catch_ups").inc()
                    tele.event(
                        "opt.catch_up", gap=gap, desynced=self._desynced,
                        local_step=self.local_step,
                    )
                state = self._catch_up(state, collab)
                self._desynced = False
                grad_acc = zeros_like_grads(state.params)
                n_acc = 0
                self.local_samples_accumulated = 0
                self._report(synced=True)
                return state, grad_acc, n_acc, False
            if gap > 0:
                # mildly stale: adopt the counter and KEEP the accumulated
                # gradients — contribute them to the current round instead
                # of burning a state download that outlasts the fast peer's
                # round period (the resync-loop failure mode; see
                # resync_step_gap above). Our params lag by <= gap applies;
                # the gradient bias is bounded and weighted by our samples.
                self.local_step = collab.optimizer_step

            with steps.phase("collab"):
                self._report(synced=True)
            if not collab.ready_for_step:
                return state, grad_acc, n_acc, False

            # decide the round shape on a FORCED-fresh view: the cached view
            # can lag a just-joined peer, and the solo fast path below must
            # not fire while a partner is mid-round
            with steps.phase("collab"):
                collab = self.tracker.fetch_collaboration_state(force=True)
            if collab.optimizer_step > self.local_step:
                self.local_step = collab.optimizer_step  # raced again: rejoin
            if not collab.ready_for_step:
                return state, grad_acc, n_acc, False
            return self._global_step(state, grad_acc, n_acc, collab)

    def _report(self, synced: bool) -> None:
        self.tracker.report_local_progress(
            LocalProgress(
                step=self.local_step,
                # flight-committed samples stay advertised at this step:
                # they are real contribution to the round in progress
                samples_accumulated=(
                    self.local_samples_accumulated
                    + self._overlap_committed_samples
                ),
                samples_per_second=self.performance_ema.samples_per_second,
                time=get_dht_time(),
                client_mode=self.client_mode,
                loss=self._last_loss,
            )
        )
        if self.ledger_claims:
            now = get_dht_time()
            if now - self._last_claim_t >= self.claim_period:
                self._last_claim_t = now
                # claim expiry spans many claim periods so a peer that goes
                # quiet stays creditable until the next coordinator fold
                self.averager.publish_contribution_claim(
                    self.contrib_samples_total,
                    self.contrib_rounds_total,
                    max(0.0, now - self._created_at),
                    expiration=self.claim_period * 10.0,
                )

    # --------------------------------------------- contribution ramp / gate

    def report_loss(self, loss: float) -> None:
        """Advertise this peer's recent training loss on its next progress
        report. Free for callers that already sync a loss scalar per global
        step (both roles do, for logging); feeds the trunk-health gate —
        without a reported loss the gate never engages for this peer."""
        self._last_loss = float(loss)

    @staticmethod
    def ramp_fraction(rounds_since_join: int, ramp_rounds: int) -> float:
        """Contribution-ramp schedule: the fraction of its full sample-count
        weight a peer mixes in on its (rounds_since_join+1)-th round. Linear
        from 1/(ramp_rounds+1) (near-zero for long ramps) to 1.0."""
        if ramp_rounds <= 0:
            return 1.0
        return min(1.0, (rounds_since_join + 1) / (ramp_rounds + 1))

    def mixing_weight_scale(self, collab) -> float:
        """Scale applied to the sample-count weight this peer CONTRIBUTES to
        the group average (it always receives the full group result):

        - contribution ramp: fresh joiners mix at ``ramp_fraction`` of their
          weight until ``ramp_rounds`` global steps have completed;
        - trunk-health gate: a peer whose advertised loss exceeds
          ``health_gate_loss_ratio`` x the median of the OTHER trainers'
          advertised losses defers mixing entirely (weight 0) — its params
          are suspect and must not steer the trunk; it keeps adopting the
          group's averaged direction until its loss rejoins the pack. The
          multiplicative ratio is only meaningful for POSITIVE losses
          (MLM/SwAV); with a zero/negative median the comparison would
          invert (every at-median peer would gate itself and the whole
          collaboration could stall at total weight 0), so the gate
          disengages there.
        """
        scale = self.ramp_fraction(self._rounds_since_join, self.ramp_rounds)
        if (
            self.health_gate_loss_ratio > 0
            and self._last_loss is not None
            and np.isfinite(collab.median_other_loss)
            and collab.median_other_loss > 0
            and self._last_loss
            > self.health_gate_loss_ratio * collab.median_other_loss
        ):
            if self.verbose:
                logger.warning(
                    f"trunk-health gate: local loss {self._last_loss:.4f} > "
                    f"{self.health_gate_loss_ratio:g} x median "
                    f"{collab.median_other_loss:.4f} — deferring mixing "
                    "(contributing zero weight this round)"
                )
            scale = 0.0
        return scale

    def _drop_gated_grads(self, state: TrainState, round_id: str):
        """The trunk-health gate judged this round's gradients unsafe to MIX
        — they are equally unsafe to apply locally (and a lagging partner
        would then resync FROM our diverged post-apply state): drop them and
        schedule a state resync instead of forcing progress."""
        if self.verbose:
            logger.warning(
                f"{round_id}: health-gated and no group average received — "
                "dropping local grads, will resync"
            )
        self._desynced = True
        self._round_failures = 0
        tele = telemetry.resolve(self.telemetry)
        if tele is not None:
            # applied-vs-dropped ledger: the swarm-health view surfaces a
            # peer whose gradients keep getting discarded
            tele.counter("opt.grads_dropped").inc()
            tele.event(
                "opt.grads_dropped", round_id=round_id,
                samples=self.local_samples_accumulated, reason="health_gate",
            )
        self.local_samples_accumulated = 0
        return state, zeros_like_grads(state.params), 0, False

    def _global_step(self, state: TrainState, grad_acc, n_acc, collab):
        """Average gradients with the group and apply one optimizer update."""
        round_id = f"step{collab.optimizer_step}"
        if self._slice is not None:
            # the slice's whole gradient sums, under the single-device
            # names and shapes
            grad_acc = self._slice.collect_grads(grad_acc, n_acc)
        n = max(int(n_acc), 1)
        # contribution cap: sample-weighted averaging assumes equal
        # per-sample gradient quality, so the cap scales with OUR samples
        # per MICRO-batch (the contribution is grad_acc/n_acc, a
        # per-micro-batch mean) — it self-calibrates across peer batch
        # sizes, never binds a healthy peer, and suppresses the tiny-batch
        # sinkhorn-noise outlier (measured 19x per-sample energy at B=2;
        # see core/config.py). The mean division, the global-norm reduce
        # and the scale all run on the card — either inside the flat
        # pipeline's prepare or via _fused_mean_clip.
        cap = 0.0
        if self.contrib_clip_per_sample > 0:
            cap = self.contrib_clip_per_sample * max(
                float(self.local_samples_accumulated) / n, 1.0
            )

        alone_grace = (
            get_dht_time() - self._created_at
            >= self.tracker.metadata_expiration
        )
        # contribution ramp + trunk-health gate: scale the weight this peer
        # MIXES IN (it still receives the full group average) — a fresh or
        # diverged joiner must not steer a formed trunk (docs/fleet.md)
        weight_scale = self.mixing_weight_scale(collab)
        tele = telemetry.resolve(self.telemetry)
        if tele is not None:
            # every ramp/gate decision is a trace event: the operator can
            # replay exactly when a joiner reached full weight or a diverged
            # peer was gated out of the mix
            gated = weight_scale == 0.0
            tele.gauge("opt.weight_scale").set(weight_scale)
            if gated:
                tele.counter("opt.gate_engaged").inc()
            tele.event(
                "opt.weight_decision", round_id=round_id,
                scale=weight_scale, gated=gated,
                rounds_since_join=self._rounds_since_join,
                loss=self._last_loss,
            )
        if (
            collab.num_peers_near_step <= 1
            and not self.client_mode
            and alone_grace
        ):
            if weight_scale == 0.0:
                # health-gated with no joinable group: the solo apply would
                # commit the very gradients the gate judged unsafe — and
                # the lagging partners would then resync FROM our diverged
                # post-apply state
                return self._drop_gated_grads(state, round_id)
            # alone AT THIS STEP: the group all-reduce is the identity, so
            # the gradients never leave the device — no host copy, no wire
            # codec, no matchmaking window. A peer that joins later (or
            # catches back up) shows up in the tracker at our step and the
            # next boundary takes the full averaging path. Keying off
            # num_peers_at_step (not num_peers) matters in fast
            # collaborations: a partner that fell behind and is mid-resync
            # CANNOT join this round — waiting a straggler window + burning
            # averaging timeouts on it stalls the whole collaboration
            # (round-5 window sweep, docs/fleet.md), and solo-applying is
            # safe since the lagging peer pulls OUR post-apply state anyway.
            # (The reference pays hivemind's full round machinery even solo;
            # keeping the apply on the device skips it.)
            #
            # The grace period guards the cold-start race: any peer that was
            # alive recently still has an unexpired progress record (so
            # num_peers > 1), but a peer started in the last few seconds may
            # not have a visible record yet — until one full record lifetime
            # has passed, take the networked path, whose straggler window
            # lets a concurrent starter pair with us.
            self.seam_ms.pop("grads_device_get", None)
            return self._apply_and_advance(
                state, _fused_mean_clip(grad_acc, n, cap), collab,
                group_size=1,
            )

        pipeline = self._ensure_pipeline(grad_acc)
        lossy_d2h = False
        fetch = None
        if pipeline is not None:
            # device-resident seam: the card computes the mean, the clip
            # reduce, the error-feedback fold and (under a lossy wire
            # format) the quantization, then streams the compressed buffer
            # to the host in async chunks. The boundary only pays the
            # LAUNCHES here — the transfer itself resolves
            # inside the averaging round, overlapped with matchmaking (and
            # with the next micro-batches' accumulation in overlap mode).
            use_ef = weight_scale > 0 and self.error_feedback.enabled
            t0 = time.perf_counter()
            with steps.phase("grad_flatten"):
                fetch = pipeline.fetch(
                    grad_acc, n=n, clip_cap=cap if cap > 0 else None,
                    use_ef=use_ef,
                )
            self.seam_ms["grads_device_get"] = (
                (time.perf_counter() - t0) * 1e3
            )
            contrib = fetch
            ef_commit = (
                (lambda: pipeline.commit(fetch)) if use_ef else None
            )
            lossy_d2h = pipeline.ef_enabled
            if use_ef and tele is not None:
                tele.gauge("opt.ef_residual_norm").set(
                    pipeline.residual_norm()
                )
        else:
            # legacy host seam (non-float leaves refused the pipeline):
            # per-leaf copy to the host + host flatten + host error feedback
            mean_grads = _fused_mean_clip(grad_acc, n, cap)
            t0 = time.perf_counter()
            with steps.phase("grad_flatten"):
                # the full grad dict to the host (the device↔host seam)
                named = _grads_to_named(mean_grads)
            self.seam_ms["grads_device_get"] = (
                (time.perf_counter() - t0) * 1e3
            )
            # error feedback (collaborative/error_feedback.py): fold the
            # last round's quantization residual into this round's
            # contribution so a lossy wire format doesn't bias the trunk.
            # Committed only when the round actually lands — a retried
            # round re-derives the same contribution instead of
            # compounding the residual.
            if weight_scale > 0 and self.error_feedback.enabled:
                contrib, ef_commit = self.error_feedback.prepare(named)
                if tele is not None:
                    tele.gauge("opt.ef_residual_norm").set(
                        self.error_feedback.residual_norm()
                    )
            else:
                contrib, ef_commit = named, None

        # partners CERTAIN to be joinable (reported exactly our step) get
        # the full straggler window; partners merely NEAR (one behind —
        # usually a just-applied record that hasn't refreshed, possibly a
        # peer stuck retrying the previous round) get a short grace only:
        # a genuinely-arriving partner shows up within ~2 refresh periods,
        # and a stuck one must not hold the collaboration hostage for a
        # window + averaging timeout per step (round-5 sweep, docs/fleet.md)
        partners_certain = collab.num_peers_at_step > 1
        near_grace = min(
            self.averager.averaging_expiration,
            max(2.0, 2.0 * self.tracker.default_refresh_period),
        )
        expected_size = (
            collab.num_peers_near_step + collab.num_aux
            if collab.num_peers_near_step >= 2 else None
        )
        window = None if partners_certain else near_grace

        if self._overlap_allowed(weight_scale):
            # restore material for a failed overlapped round: with the
            # device pipeline the RAW accumulator tree stays on device (the
            # restore is then a device-side add, no host round-trip); the
            # legacy path keeps the host named copy as before. On a slice
            # every rank keeps its own parts (Slice.commit): the gathered
            # full sums would count the other ranks' parts again
            if self._slice is not None:
                self._slice.commit()
                restore = ("slice",)
            elif pipeline is not None:
                restore = ("acc", grad_acc, n_acc)
            else:
                restore = ("named", named, n)
            return self._launch_overlap(
                state, restore, contrib, ef_commit, collab,
                weight_scale, expected_size, window, partners_certain,
                n_micro=n, lossy_d2h=lossy_d2h,
            )

        self.performance_ema.pause()
        try:
            wire_start = monotonic_clock()
            averaged, group_size = self._sync_averager_step(
                contrib, weight_scale, round_id, expected_size, window,
            )
            if averaged is not None and not isinstance(averaged, dict):
                # an averager (or test stub) that echoed the FlatFetch
                # contribution back unresolved: resolve it here
                averaged = averaged.result()
            wire_wall = max(0.0, monotonic_clock() - wire_start)
            # phase attribution stays DISJOINT: the averaging round's wall
            # splits into the exposed remainder of the D2H stream (the
            # transfer resolves inside the round, overlapped with
            # matchmaking — only what matchmaking did NOT cover is a real
            # stall, ~0 on the loopback harness) and the wire round proper
            exposed_d2h = (
                min(fetch.exposed_wait_s, wire_wall)
                if fetch is not None else 0.0
            )
            steps.add("avg_wire", wire_wall - exposed_d2h)
            if fetch is not None:
                steps.add("d2h_stream", exposed_d2h)
            if self.overlap_averaging and tele is not None:
                # overlap ledger, synchronous-fallback form: this round ran
                # on the trainer's critical path (cooldown after a failed
                # overlapped round, ramp, gate, desync) — its entire wall is
                # EXPOSED stall, efficiency 0 (docs/observability.md)
                tele.counter("opt.overlap_exposed_s").inc(wire_wall)
                tele.gauge("opt.overlap_efficiency").set(0.0)
                tele.event(
                    "opt.overlap_ledger", round_id=round_id, mode="sync",
                    hidden_s=0.0, exposed_s=wire_wall, efficiency=0.0,
                )
            contributors = getattr(
                self.averager, "last_contributors", group_size
            )
            if (averaged is not None and contributors <= 1
                    and partners_certain):
                # nobody else CONTRIBUTED gradients while partner trainers
                # exist AT OUR STEP — a singleton group, or a group of just
                # us + aux donors (zero weight): the partners may be
                # averaging without us this round, and applying our local
                # grads now would diverge the replicas. Treat it as a failed
                # round — the retry keeps the grads; repeated misses fall
                # back to local-apply + resync below. (Near-step-only rounds
                # skip this: a peer one behind is on the PREVIOUS round id,
                # so nobody can be averaging round N without us.)
                averaged = None
            if averaged is not None:
                self._round_failures = 0
                if ef_commit is not None:
                    self._settle_error_feedback(
                        ef_commit, group_size, lossy_d2h
                    )
                if not isinstance(averaged, FlatTree):
                    # a plain named dict (legacy/stubbed averager): rebuild
                    # the params-keyed dict here so _apply_and_advance can
                    # tell it apart from a flat result
                    averaged = _named_to_grads(averaged, self._grad_like(state))
                return self._apply_and_advance(
                    state, averaged, collab, group_size
                )
            elif partners_certain:
                self._round_failures += 1
                if self._round_failures <= self.max_round_retries:
                    # better than the reference's local-apply: KEEP the
                    # accumulated gradients and retry the round — no
                    # divergence, no wasted samples (one straggler window
                    # lost instead)
                    if self.verbose:
                        logger.warning(
                            f"{round_id}: averaging failed "
                            f"({self._round_failures}/{self.max_round_retries})"
                            " — keeping grads, will retry"
                        )
                    return state, grad_acc, n_acc, False
                # repeated failures: apply local grads to make progress, and
                # schedule a state pull since our params will diverge
                self._desynced = True
                self._round_failures = 0
                if self.verbose and weight_scale > 0.0:
                    logger.warning(
                        f"{round_id}: averaging failed repeatedly — applying "
                        "local grads, will resync"
                    )
            if weight_scale == 0.0:
                # no group average received this round (retry budget spent,
                # or a near-step-only round that came back empty): a
                # health-gated peer has nothing safe to apply locally
                return self._drop_gated_grads(state, round_id)
            # local-apply fallback: OUR mean gradients (clip applied, no
            # residual fold, never quantized) — exactly what the legacy
            # path applied here; the device dict never left the card
            return self._apply_and_advance(
                state, _fused_mean_clip(grad_acc, n, cap), collab,
                group_size,
            )
        finally:
            self.performance_ema.resume()

    def _sync_averager_step(
        self, contrib, weight_scale, round_id, expected_size, window,
    ):
        """The synchronous averaging round (the ``avg_wire`` step phase).

        ``expected_size`` is the tracker's live peer count: full group =>
        assemble the moment the last partner joins; the straggler window
        then only pays off when peers are genuinely late. Aux peers publish
        presence records and are counted — without them a full group
        assembles the instant the last TRAINER joins and aux donors
        systematically lose the race. During cold start (num_peers <= 1:
        our own record may be the only visible one) the full window is kept
        so a concurrent starter can still pair with us — the design the
        solo-grace path depends on. Only near-step trainers are counted —
        lagging peers are resyncing and must not size the group."""
        return self.averager.step(
            contrib,
            weight=float(self.local_samples_accumulated) * weight_scale,
            round_id=round_id,
            expected_size=expected_size,
            window=window,
        )

    def _settle_error_feedback(
        self, ef_commit, group_size: int, lossy_d2h: bool = False
    ) -> None:
        """A round whose result we adopted settles the pending residual.

        ``group_size > 1``: the contribution crossed the lossy wire — adopt
        this round's quantization error as the next residual.

        ``lossy_d2h`` (device-flat pipeline under a lossy wire format): the
        contribution was quantized ON DEVICE, so even a SINGLETON round has
        crossed the lossy leg — the value we adopted is the dequantized
        form, and its residual must be committed regardless of group size.

        A legacy singleton round never touches any codec: the averager
        hands the contribution tree back verbatim, so grad + residual was
        applied at FULL precision — the carried residual is consumed, and
        committing the phantom wire error there would re-inject it next
        round (the exact bias error feedback exists to remove)."""
        if lossy_d2h or group_size > 1:
            ef_commit()
        else:
            self.error_feedback.reset()

    # ------------------------------------------- device-resident flat seam

    def _ensure_pipeline(self, grad_acc) -> Optional[DeviceFlatPipeline]:
        """The device-flat pipeline for this gradient schema, or None when
        disabled / refused (non-float leaves) — the boundary then takes the
        legacy per-leaf host path."""
        if not self.device_flat:
            return None
        if self._pipeline is not None and self._pipeline.matches_tree(
            grad_acc
        ):
            return self._pipeline
        try:
            self._pipeline = DeviceFlatPipeline.for_tree(
                grad_acc,
                compression=self.averager.compression.value,
                telemetry_registry=self.telemetry,
            )
        except ValueError as e:
            logger.warning(
                f"device-flat pipeline refused this gradient tree ({e}); "
                "falling back to the host flatten path"
            )
            self.device_flat = False
            self._pipeline = None
        return self._pipeline

    def _ensure_flat_apply(self, state: TrainState, spec, from_tree: bool):
        """The flat apply for the gradient ``spec``, taking a flat wire
        buffer or (``from_tree``) a dict keyed by parameter name: over the
        flat twin of this peer's own optimizer (``optim.flat.flat_twin``),
        built once per spec. A spec that does not match the params raises
        here."""
        key = [(name, tuple(shape)) for name, shape, _dtype in spec]
        if self._flat_apply is None or self._flat_apply[0] != key:
            self._flat_apply = (key, flat_twin(self.tx, spec, state.params), {})
        _key, flat_tx, applies = self._flat_apply
        if from_tree not in applies:
            applies[from_tree] = make_flat_apply_step(
                flat_tx, spec, post_apply=self.post_apply, from_tree=from_tree)
        return applies[from_tree]

    def _check_apply_ok(self, final: bool = False) -> None:
        """Read the PREVIOUS apply's NaN verdict. Called at the
        next boundary (the flag has long settled — reading it then costs
        nothing) and once at shutdown (``final=True``); a rolled-back
        update is logged and counted one boundary late instead of paying a
        host sync on every global step."""
        pending, self._pending_apply_ok = self._pending_apply_ok, None
        if pending is None:
            return
        round_id, ok = pending
        try:
            # the apply ran a boundary ago: this read finds it finished
            rolled_back = not bool(ok)
        except Exception:  # noqa: BLE001 — a dead device at shutdown must
            # not mask the real failure
            return
        if rolled_back:
            # NaN guard (CollaborativeCallback.on_step_end semantics,
            # albert/run_trainer.py:134-137): the update was discarded
            # inside the apply
            logger.warning(
                f"{round_id}: non-finite params; update was rolled back"
            )
            tele = telemetry.resolve(self.telemetry)
            if tele is not None:
                tele.counter("opt.nan_rollbacks").inc()
                tele.event("opt.nan_rollback", round_id=round_id)

    # ------------------------------------------------- background averaging

    def _overlap_allowed(self, weight_scale: float) -> bool:
        """Overlap mode launches a background round only when the peer is a
        full-standing contributor: never during the contribution ramp (a
        joiner's weight schedule must advance one observed round at a time),
        never while health-gated (a gated round's result decides whether the
        local grads are even safe to keep), never while desynced or cooling
        down from a failed overlapped round — those boundaries take the
        synchronous path with its retry/resync ladder."""
        return (
            self.overlap_averaging
            and not self._overlap_cooldown
            and not self.auxiliary
            and not self._desynced
            and weight_scale > 0.0  # trunk-health gate engaged => sync path
            and self._rounds_since_join >= self.ramp_rounds  # ramp finished
        )

    def _launch_overlap(
        self, state: TrainState, restore, contrib, ef_commit, collab,
        weight_scale, expected_size, window, partners_certain, n_micro,
        lossy_d2h=False,
    ):
        """Start the averaging round on the DHT executor and hand control
        straight back to the trainer: the next accumulation phase overlaps
        matchmaking + the full wire round — and, with the device pipeline,
        the gradient D2H stream itself (the transfer resolves inside the
        round while the trainer accumulates). The contributed samples are
        committed to the in-flight round (accumulators reset); the averaged
        update lands at a later boundary — one boundary of staleness, by
        contract. ``restore`` is either ("acc", grad_acc, n_acc) — the raw
        device accumulators, restored by a device-side add on failure —,
        ("slice",) — each rank of a slice keeps and restores its own
        committed parts — or the legacy ("named", host_mean_tree,
        n_micro)."""
        round_id = f"step{collab.optimizer_step}"
        fut = self.averager.step(
            contrib,
            weight=float(self.local_samples_accumulated) * weight_scale,
            round_id=round_id,
            return_future=True,
            expected_size=expected_size,
            window=window,
        )
        # overlap ledger: round wall runs launch → future completion; the
        # done-callback stamps completion on the resolving thread so a round
        # that lands BETWEEN boundaries is not credited with hiding the
        # accumulation that ran after it finished
        self._overlap_launched_at = monotonic_clock()
        self._overlap_hidden_s = 0.0
        self._overlap_done_at = None

        def _stamp_done(_f) -> None:
            self._overlap_done_at = monotonic_clock()

        add_done = getattr(fut, "add_done_callback", None)
        if add_done is not None:
            add_done(_stamp_done)
        self._overlap_inflight = {
            "future": fut,
            "restore": restore,  # pre-error-feedback material for failure
            "commit": ef_commit,
            "collab": collab,
            "samples": self.local_samples_accumulated,
            "n_micro": int(n_micro),
            "partners_certain": partners_certain,
            "lossy_d2h": lossy_d2h,
        }
        tele = telemetry.resolve(self.telemetry)
        if tele is not None:
            tele.counter("opt.overlap_launched").inc()
            tele.event(
                "opt.overlap_launched", round_id=round_id,
                samples=self.local_samples_accumulated,
            )
        if self.verbose:
            logger.info(
                f"{round_id}: averaging launched in background "
                f"({self.local_samples_accumulated} samples committed)"
            )
        self._overlap_committed_samples = self.local_samples_accumulated
        self.local_samples_accumulated = 0
        # from here the trainer accumulates concurrently with the round —
        # the ledger credits launch→next-boundary wall as hidden time
        self._overlap_resumed_at = monotonic_clock()
        return state, zeros_like_grads(state.params), 0, False

    def _harvest_overlap(self, state: TrainState, grad_acc, n_acc):
        """The in-flight round resolved. On success, apply its averaged
        update (one boundary late) while PRESERVING the microbatches
        accumulated during the flight. On failure, restore the committed
        gradients into the live accumulator and let this boundary take the
        synchronous path. Returns (state, grad_acc, n_acc, stepped,
        applied)."""
        inflight, self._overlap_inflight = self._overlap_inflight, None
        # the flight resolved either way: on success the step advances (the
        # committed samples were consumed by the applied round), on failure
        # they are restored into the live accumulator below — keeping the
        # committed count advertised past this point would double-count
        self._overlap_committed_samples = 0
        collab = inflight["collab"]
        round_id = f"step{collab.optimizer_step}"
        tele = telemetry.resolve(self.telemetry)
        # overlap ledger: hidden = concurrent-accumulation wall credited at
        # each boundary while the round flew (capped at the round wall);
        # exposed = the remainder of launch→finish the compute did NOT
        # cover. A round that landed within one boundary reports
        # efficiency ~1; a round the trainer outpaced reports the stall.
        done_at = self._overlap_done_at
        if done_at is None:
            done_at = monotonic_clock()
        round_wall = max(0.0, done_at - self._overlap_launched_at)
        hidden = min(self._overlap_hidden_s, round_wall)
        exposed = max(0.0, round_wall - hidden)
        self._overlap_hidden_s = 0.0
        self._overlap_done_at = None
        if tele is not None:
            efficiency = hidden / round_wall if round_wall > 0 else 1.0
            tele.counter("opt.overlap_hidden_s").inc(hidden)
            tele.counter("opt.overlap_exposed_s").inc(exposed)
            tele.gauge("opt.overlap_efficiency").set(efficiency)
            tele.event(
                "opt.overlap_ledger", round_id=round_id, mode="overlap",
                hidden_s=hidden, exposed_s=exposed, efficiency=efficiency,
                round_wall_s=round_wall,
            )
        try:
            averaged, group_size = inflight["future"].result()
        except Exception as e:  # noqa: BLE001 — a failed round costs one
            # round, never the training process (AllreduceFailed is already
            # folded into None by the averager; this guards executor deaths)
            logger.warning(f"{round_id}: overlapped round raised {e!r}")
            averaged, group_size = None, 1
        contributors = getattr(self.averager, "last_contributors", group_size)
        if averaged is not None and not isinstance(averaged, dict):
            # an echoed, unresolved FlatFetch contribution (stubs): resolve
            averaged = averaged.result()
        if (averaged is not None and contributors <= 1
                and inflight["partners_certain"]):
            # same replica-divergence guard as the synchronous path: known
            # partners may have averaged without us — do not apply solo
            averaged = None
        if averaged is not None and not isinstance(averaged, FlatTree):
            # legacy named-dict result: validate against the param schema
            # before adopting (a FlatTree from our own averager is already
            # layout-checked)
            try:
                averaged = _named_to_grads(averaged, state.params)
            except (KeyError, ValueError) as e:
                logger.warning(f"{round_id}: overlap result rejected: {e!r}")
                averaged = None
        if averaged is not None:
            # a landed round clears the retry ladder, same as the
            # synchronous success path — otherwise stale failure counts
            # survive overlap successes and a later transient failure
            # skips straight to local-apply + resync
            self._round_failures = 0
            if inflight["commit"] is not None:
                self._settle_error_feedback(
                    inflight["commit"], group_size,
                    inflight.get("lossy_d2h", False),
                )
            if self._slice is not None:
                self._slice.consumed()
            if tele is not None:
                tele.counter("opt.overlap_applied").inc()
                tele.event(
                    "opt.overlap_applied", round_id=round_id,
                    group_size=group_size,
                    accumulated_during_flight=self.local_samples_accumulated,
                )
            result = self._apply_and_advance(
                state, averaged, collab, group_size,
                keep_acc=(grad_acc, n_acc),
            )
            return (*result, True)
        # failure: fold the committed gradients back into the accumulator
        # and fall back to the synchronous path — cooldown until a global
        # step succeeds
        self._overlap_cooldown = True
        if tele is not None:
            tele.counter("opt.overlap_failed").inc()
            tele.event("opt.overlap_failed", round_id=round_id)
        if self.verbose:
            logger.warning(
                f"{round_id}: overlapped round failed — restoring grads, "
                "falling back to synchronous averaging"
            )
        restore = inflight["restore"]
        if restore[0] == "slice":
            # every rank adds its own committed parts back, in place
            n_acc = self._slice.restore(grad_acc, n_acc)
        elif restore[0] == "acc":
            # device pipeline: the raw accumulators never left the card —
            # merge them back with one device-side add, no host round-trip
            _tag, old_acc, old_n = restore
            grad_acc = {k: a + old_acc[k] for k, a in grad_acc.items()}
            n_acc = n_acc + old_n
        else:
            # legacy: mean * n_micro reconstructs the committed sum
            _tag, named, n_micro = restore
            restored = _named_to_grads(named, state.params)
            grad_acc = {k: a + restored[k] * n_micro
                        for k, a in grad_acc.items()}
            n_acc = n_acc + n_micro
        self.local_samples_accumulated += inflight["samples"]
        return state, grad_acc, n_acc, False, False

    def _apply_and_advance(self, state: TrainState, mean_grads, collab,
                           group_size: int, keep_acc=None):
        """Optimizer apply + NaN guard + backup + progress bookkeeping —
        the tail of a global step, shared by the solo, networked and
        overlap-harvest paths. ``keep_acc=(grad_acc, n_acc)`` preserves the
        accumulation that ran while an overlapped round was in flight
        (those microbatches belong to the NEXT round)."""
        round_id = f"step{collab.optimizer_step}"
        t0 = time.perf_counter()
        with steps.phase("opt_apply"):
            # previous boundary's NaN verdict has settled by now — read it
            # without stalling this boundary's dispatch
            self._check_apply_ok()
            # NaN guard lives INSIDE the apply: no pre-apply copy of
            # (step, params, opt_state), no host-synced finite check per
            # global step
            if self._slice is not None:
                if isinstance(mean_grads, FlatTree):
                    mean_grads = _named_to_grads(mean_grads, self._grad_like(state))
                # every rank applies its blocks of the full result
                new_state, ok = self._slice.apply(self._apply_fn, state,
                                                  mean_grads)
                self.last_apply = "leaf"
            else:
                # FLAT apply: multi-tensor passes over the leaves in the
                # wire's order (optim/flat.py). An averaged result comes as
                # one flat buffer in the wire's layout; a dict (the solo
                # path, the local-apply fallback, a named result) is read
                # where it lies
                if isinstance(mean_grads, FlatTree):
                    flat_fn = self._ensure_flat_apply(
                        state, mean_grads.spec, from_tree=False)
                    mean_grads = torch.from_numpy(mean_grads.flat).to(
                        self._device(state), copy=True)
                else:
                    flat_fn = self._ensure_flat_apply(
                        state, DeviceFlatPipeline.for_tree(mean_grads).spec,
                        from_tree=True)
                new_state, ok = flat_fn(state, mean_grads)
                self.last_apply = "flat"
            self._pending_apply_ok = (round_id, ok)
            if steps.current() is not None:
                # recording only: the phase measures the apply's execution,
                # not its launches (the fwd_bwd phase does the same)
                block_on_device(ok)
        self.seam_ms["apply"] = (time.perf_counter() - t0) * 1e3
        self.last_group_size = group_size
        tele = telemetry.resolve(self.telemetry)
        if tele is not None:
            tele.counter("opt.grads_applied").inc()
            tele.event(
                "opt.global_step", step=collab.optimizer_step + 1,
                group_size=group_size,
                samples=self.local_samples_accumulated,
            )
        self.local_step = collab.optimizer_step + 1
        self._rounds_since_join += 1  # advances the contribution ramp
        self.contrib_rounds_total += 1  # cumulative, for the signed claim
        self._overlap_cooldown = False  # a landed step re-arms overlap
        if keep_acc is None:
            self.local_samples_accumulated = 0
        self._backup_and_share(new_state)
        with steps.phase("collab"):
            self._report(synced=True)
            self.tracker.fetch_collaboration_state(force=True)
        if self.verbose:
            logger.info(
                f"global step {self.local_step} applied "
                f"(group={group_size}, samples~{collab.samples_accumulated})"
            )
        if keep_acc is not None:
            # overlap harvest: the microbatches accumulated during the
            # flight stay live — they are the next round's contribution
            return new_state, keep_acc[0], keep_acc[1], True
        return new_state, zeros_like_grads(new_state.params), 0, True

    # -------------------------------------------------------- state recovery

    def seed_state_sharing(self, state: TrainState) -> None:
        """Publish a state snapshot BEFORE the first global step: a slow
        partner that misses round 0 resyncs immediately instead of finding
        no provider (the first post-apply backup takes tens of seconds on
        slow device→host links) and silently diverging until one appears."""
        self._backup_and_share(state)

    def _backup_and_share(self, state: TrainState) -> None:
        """Host snapshot of (params, opt_state) for late joiners
        (load_state_from_peers counterpart, run_trainer.py:124-128). The
        NaN-rollback backup is NOT here — it lives on device
        (see ``_apply_and_advance``) — so this transfer is pure state
        sharing and can be skipped entirely when sharing is off.

        Runs on a background thread: the transfer is read-only w.r.t. the
        next round (a fresh grad accumulator), so the next accumulation phase
        overlaps the hundreds of MB of device→host traffic instead of
        stalling behind it.

        Duty-cycle cap: when the transfer takes longer than
        ``backup_duty_cycle`` of the time between global steps, skip this
        step's snapshot instead of queueing behind it — late joiners get a
        slightly older state, training throughput stays intact. (On PCIe the
        transfer is ~ms and effectively every step is shared; the cap only
        bites on slow links.)
        """
        if not self.averager.allow_state_sharing:
            return
        if self._backup_thread is not None and self._backup_thread.is_alive():
            return  # previous snapshot still draining; don't stall the step
        now = time.perf_counter()
        idle_needed = self._backup_took * (1.0 / self.backup_duty_cycle - 1.0)
        if now < self._backup_done_at + idle_needed:
            return
        self._join_backup()
        step, local_step = int(state.step), self.local_step
        # snapshot ON DEVICE first (a device copy, ~ms, in the JAX element
        # order): the next global step's apply writes the live params and
        # moments in place, so the thread must never read them
        snapshot = {k: v.clone(memory_format=torch.contiguous_format)
                    for k, v in self.state_views(state).items()}
        ready = None
        if self._device(state).type == "cuda":
            ready = torch.cuda.Event()
            ready.record()

        def backup() -> None:
            t0 = time.perf_counter()
            self.averager.set_shared_state(
                self._snapshot_to_host(snapshot, ready),
                {"step": step, "local_step": local_step},
            )
            self.averager.publish_state_provider(
                expiration=self.tracker.metadata_expiration * 4,
                step=local_step,
            )
            end = time.perf_counter()
            self._backup_done_at, self._backup_took = end, end - t0
            self.seam_ms["backup"] = (end - t0) * 1e3

        self._backup_thread = threading.Thread(target=backup, daemon=True)
        self._backup_thread.start()

    def _join_backup(self) -> None:
        if self._backup_thread is not None:
            self._backup_thread.join()
            self._backup_thread = None

    @staticmethod
    def _device(state: TrainState) -> torch.device:
        return next(iter(state.params.values())).device

    def state_views(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """The state under the JAX shared-state names; on a slice, gathered
        from every rank to full tensors."""
        if self._slice is not None:
            return self._slice.views(state)
        return _state_views(state, self.tx)

    def _grad_like(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """What averaged gradients are shaped like: the params, or on a
        slice their full shapes."""
        if self._slice is not None:
            return self._slice.full_like(state.params)
        return state.params

    def adopt(self, state: TrainState, named, step: int) -> TrainState:
        """``adopt_state``; on a slice every rank keeps its blocks."""
        if self._slice is not None:
            return self._slice.adopt(state, named, step)
        return adopt_state(state, named, step, self.tx)

    @staticmethod
    def _snapshot_to_host(snapshot: Dict[str, torch.Tensor],
                          ready) -> Dict[str, np.ndarray]:
        """The device snapshot -> host arrays. On the card the copies run on
        a side stream after ``ready`` (so they never queue behind or stall
        the trainer's kernels), and this thread waits on that stream only."""
        if ready is None:
            return {k: v.numpy() for k, v in snapshot.items()}
        side = torch.cuda.Stream(device=next(iter(snapshot.values())).device)
        with torch.cuda.stream(side):
            side.wait_event(ready)
            host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    for k, v in snapshot.items()}
            for k, v in snapshot.items():
                host[k].copy_(v, non_blocking=True)
        side.synchronize()
        return {k: v.numpy() for k, v in host.items()}

    def load_state_from_peers(
        self, state: TrainState, only_if_newer: bool = False
    ) -> TrainState:
        """Download the newest collaboration state (params+opt) from a peer
        (albert/run_trainer.py:124-128 on_train_begin semantics). Returns the
        local state unchanged if nobody shares yet.

        ``only_if_newer`` — adopt the remote state only when its step is
        STRICTLY deeper than ``self.local_step``. Role startup after a disk
        resume must pass True: a fresh-init partner that raced a few counter
        steps ahead while this peer was still compiling must not beat a
        770-step checkpoint (measured: the resumed peer silently demoted
        itself to the fresh peer's near-random params and the run collapsed).
        Catch-up/resync paths keep the unconditional adopt — a desynced peer
        wants the collaboration's canonical state even at the same step."""
        self._join_backup()
        if only_if_newer:
            # KB-cheap pre-check against the advertised provider steps: a
            # resumed peer usually HAS the deepest state, and downloading a
            # full params+opt blob only to discard it wastes the provider's
            # uplink (advisor r5). The post-download check below still
            # guards the race where the advertisement was newer than the
            # state actually served. An advertisement can itself lag the
            # duty-cycled backup by several applies — so when the TRACKER
            # says the collaboration's counter is already past us, a
            # tied-but-stale advertisement must not skip the download
            # (advisor r5 low #2; the tracker view is equally KB-cheap).
            best = self.averager.best_advertised_state_step()
            tracker_step = self.tracker.fetch_collaboration_state().optimizer_step
            if (
                best is not None
                and best <= self.local_step
                and tracker_step <= self.local_step
            ):
                logger.info(
                    f"best advertised peer state (step {best}) is not newer "
                    f"than local {self.local_step}; keeping local state"
                )
                return state
        result = self.averager.load_state_from_peers()
        if result is None:
            logger.info("no state providers found; starting from local state")
            return state
        metadata, named = result
        remote_step = int(metadata.get("local_step", metadata.get("step", 0)))
        if only_if_newer and remote_step <= self.local_step:
            logger.info(
                f"peer state at global step {remote_step} is not newer than "
                f"local {self.local_step}; keeping local state"
            )
            return state
        try:
            new_state = self.adopt(state, named, int(metadata.get("step", 0)))
        except (KeyError, ValueError) as e:
            logger.warning(f"peer state incompatible ({e!r}); keeping local")
            return state
        # dedlint: disable=lock-unguarded-mutation — entered either from
        # step() -> _catch_up() with self._lock held, or from the role's
        # join/bootstrap path before the training loop (and its threads)
        # exists; taking the non-reentrant lock here would deadlock the
        # _catch_up path
        self.local_step = remote_step  # dedlint: disable=lock-unguarded-mutation
        logger.info(f"loaded state from peers at global step {self.local_step}")
        return new_state

    def _catch_up(self, state: TrainState, collab) -> TrainState:
        # the carried quantization residual belongs to gradients computed on
        # params we are about to replace — feeding it forward would inject
        # stale signal into the first post-resync round
        self.error_feedback.reset()
        if self._pipeline is not None:
            self._pipeline.reset_residual()
        new_state = self.load_state_from_peers(state)
        # even if nobody shares state, adopt the global step counter so we
        # rejoin the current round instead of contesting old ones
        self.local_step = max(self.local_step, collab.optimizer_step)
        return new_state

    # -------------------------------------------------------------- aux role

    def bootstrap_aux_template(
        self, timeout: float = 60.0
    ) -> Optional[Dict[str, np.ndarray]]:
        """Fetch the GRADIENT tensor shapes from a live state provider, so
        an aux peer can join a collaboration knowing only the DHT peers —
        the reference's aux bootstraps from the collaboration the same way
        (run_aux.py:243-263). Uses the KB-sized schema-only reply, never the
        full state blob. Returns None while nobody shares state yet."""
        schema = self.averager.fetch_state_schema(timeout=timeout)
        if schema is None:
            return None
        # shared state is the flattened (params, opt_state) tuple, so param
        # leaves carry the "[0]" tuple-index prefix (_tree_to_named keystr
        # naming); gradients are params-shaped => strip that prefix. A wrong
        # template still fails cleanly at join time (schema handshake).
        template = {
            k[len("[0]"):]: np.zeros(shape, np.float32)
            for k, shape in schema.items()
            if k.startswith("[0]")
        }
        return template or None

    # consecutive missed rounds after which an aux stops advertising
    # presence: a tracker-visible aux that can never actually reach the
    # averaging groups (e.g. NAT-blocked from every leader) must not make
    # trainers hold the straggler window open for it on every round
    aux_presence_miss_limit = 2

    def _report_aux_presence(self) -> None:
        """Publish a zero-progress presence record so trainers' group
        sizing counts this aux as an expected averaging participant.

        Withheld after ``aux_presence_miss_limit`` consecutive missed
        rounds — but only for a cooldown: once presence is withheld,
        trainers assemble the instant the last trainer joins, which makes
        winning a round (the other re-advertise trigger) a pure race — a
        healthy aux that hit a transient blip must not starve forever.
        After the cooldown it re-advertises and re-probes; a genuinely
        unreachable aux re-withholds two rounds later.

        The record's ``step`` is 0, not ``local_step``: no current consumer
        reads an aux record's step (the tracker filters aux records out of
        the optimizer_step max), and publishing a step that can briefly
        LEAD the trainers' would send any legacy tracker without the aux
        filter into a spurious catch-up loop."""
        if self._aux_misses >= self.aux_presence_miss_limit:
            cooldown = 4.0 * self.tracker.metadata_expiration
            if get_dht_time() - self._aux_withheld_at < cooldown:
                return
            self._aux_misses = 0
        self.tracker.report_local_progress(
            LocalProgress(
                step=0,
                samples_accumulated=0,
                samples_per_second=0.0,
                time=get_dht_time(),
                client_mode=False,
                aux=True,
            )
        )

    def step_aux(self, template: Dict[str, np.ndarray]) -> bool:
        """Auxiliary peer (run_aux.py:260-263): join the current round with
        zero weight, donating bandwidth. ``template`` gives tensor shapes."""
        assert self.auxiliary
        self._report_aux_presence()
        collab = self.tracker.fetch_collaboration_state()
        if not collab.ready_for_step:
            return False
        round_id = f"step{collab.optimizer_step}"
        zeros = {k: np.zeros_like(v) for k, v in template.items()}
        averaged, group_size = self.averager.step(
            zeros, weight=0.0, round_id=round_id
        )
        ok = averaged is not None
        if ok:
            # only a round we actually completed advances our step — a
            # failed round must leave local_step put so the aux retries the
            # SAME round (and its presence record doesn't claim progress
            # it never made)
            # dedlint: disable=lock-unguarded-mutation — auxiliary peers
            # never run step(): local_step is only ever touched by the one
            # aux loop thread, there is no trainer thread to race
            self.local_step = collab.optimizer_step + 1  # dedlint: disable=lock-unguarded-mutation
            self._aux_misses = 0
        else:
            self._aux_misses += 1
            if self._aux_misses == self.aux_presence_miss_limit:
                self._aux_withheld_at = get_dht_time()
        self.tracker.fetch_collaboration_state(force=True)
        return ok

    def shutdown(self) -> None:
        inflight = self._overlap_inflight
        if inflight is not None:
            inflight["future"].cancel()
            self._overlap_inflight = None
        self._check_apply_ok(final=True)
        self._join_backup()
        self.averager.shutdown()
