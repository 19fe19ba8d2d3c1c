"""Typed configuration tree + component registry.

The reference uses two config idioms — layered HfArgumentParser dataclasses
(albert/arguments.py:7-128) and Hydra AttrDict composition (vissl) with
string-keyed registries (register_optimizer / register_loss / ...). Per
SURVEY.md §5 the TPU build unifies both into ONE idiom: plain dataclass trees
(parseable from CLI) + a generic Registry.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Callable, Dict, List, Optional, Type, TypeVar, get_args, get_origin

T = TypeVar("T")


class Registry:
    """String-keyed component registry (models, optimizers, losses, datasets).

    Replaces vissl/ClassyVision's per-kind ``register_*`` decorators
    (reference: classy_vision/optim/__init__.py:114-124 et al.).
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, name: str) -> Callable[[T], T]:
        def deco(obj: T) -> T:
            if name in self._entries:
                raise KeyError(f"{self.kind} {name!r} already registered")
            self._entries[name] = obj
            return obj

        return deco

    def get(self, name: str) -> Any:
        if name not in self._entries:
            raise KeyError(
                f"unknown {self.kind} {name!r}; known: {sorted(self._entries)}"
            )
        return self._entries[name]

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def names(self) -> List[str]:
        return sorted(self._entries)


MODELS = Registry("model")
OPTIMIZERS = Registry("optimizer")
LOSSES = Registry("loss")
DATASETS = Registry("dataset")
SCHEDULES = Registry("schedule")


def _add_dataclass_args(
    parser: argparse.ArgumentParser, cls: Type, prefix: str = "", defaults: Any = None
):
    import typing

    # Defaults come from an INSTANCE of cls so that a parent's
    # default_factory override (e.g. SwAVCollaborationArguments setting
    # target_batch_size=32768 on its optimizer field) survives into the CLI
    # defaults instead of being shadowed by the nested class's own field
    # defaults.
    if defaults is None:
        defaults = cls()
    hints = typing.get_type_hints(cls)
    for f in fields(cls):
        ftype = hints.get(f.name, f.type)
        if is_dataclass(ftype):
            _add_dataclass_args(
                parser,
                ftype,
                prefix=f"{prefix}{f.name}.",
                defaults=getattr(defaults, f.name),
            )
            continue
        name = f"--{prefix}{f.name}"
        origin = get_origin(ftype)
        if origin is Optional or (origin is type(None)):
            ftype = get_args(ftype)[0]
        elif origin is not None and type(None) in get_args(ftype):
            ftype = next(a for a in get_args(ftype) if a is not type(None))
        default = getattr(defaults, f.name)
        if ftype is bool:
            parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=default)
        elif get_origin(ftype) in (list, List):
            parser.add_argument(name, nargs="*", type=get_args(ftype)[0] if get_args(ftype) else str,
                                default=default)
        elif ftype in (int, float, str):
            parser.add_argument(name, type=ftype, default=default)
        else:
            parser.add_argument(name, type=str, default=default)


def parse_config(cls: Type[T], argv: Optional[List[str]] = None) -> T:
    """Parse a (possibly nested) dataclass config from CLI flags.

    Nested fields use dotted flags: ``--dht.initial_peers host:port``.
    Replaces the reference's HfArgumentParser multi-dataclass pattern
    (albert/run_trainer.py:211-212).
    """
    parser = argparse.ArgumentParser()
    _add_dataclass_args(parser, cls)
    ns = vars(parser.parse_args(argv))

    import typing

    def build(c: Type, prefix: str = ""):
        hints = typing.get_type_hints(c)
        kwargs = {}
        for f in fields(c):
            ftype = hints.get(f.name, f.type)
            if is_dataclass(ftype):
                kwargs[f.name] = build(ftype, prefix=f"{prefix}{f.name}.")
            else:
                kwargs[f.name] = ns[f"{prefix}{f.name}"]
        return c(**kwargs)

    return build(cls)


# ---------------------------------------------------------------------------
# The canonical argument tree, mirroring the reference's 3-layer flag system
# (albert/arguments.py:7-101) with TPU-native additions.
# ---------------------------------------------------------------------------


@dataclass
class DHTArguments:
    """Reference: BaseTrainingArguments (albert/arguments.py:7-20)."""

    experiment_prefix: str = "dedloc_tpu"
    initial_peers: List[str] = field(default_factory=list)  # "host:port" strings
    listen_host: str = "0.0.0.0"
    listen_port: int = 0  # 0 = ephemeral
    # public address other peers should dial (the reference coordinator
    # resolves its public IP the same way, run_first_peer.py:153-155);
    # empty = loopback (single-host runs)
    advertised_host: str = ""
    client_mode: bool = False  # outbound-only peer (albert/arguments.py:63-65)
    # "host:port[,host2:port2,…]" of public peers: a client-mode peer
    # registers with every listed circuit relay (k-redundant, like the
    # reference's several bootstrap nodes) and becomes able to lead groups
    # / host spans through them; if the advertised relay dies, the peer
    # fails over to a live backup automatically
    relay: str = ""


@dataclass
class AveragerArguments:
    """Reference: AveragerArguments (albert/arguments.py:22-54)."""

    averaging_expiration: float = 5.0  # wait-for-stragglers window
    averaging_timeout: float = 30.0  # hard abort for a round
    min_refresh_period: float = 0.5
    max_refresh_period: float = 30.0
    default_refresh_period: float = 3.0
    expected_drift_peers: float = 3.0
    expected_drift_rate: float = 0.2
    performance_ema_alpha: float = 0.1
    target_group_size: int = 256
    metadata_expiration: float = 30.0
    compression: str = "float16"  # none | float16 | uint8 — wire format for
    # averaging rounds (core/serialization.py; the native F16C codec when
    # loaded). Lossy formats pair with the optimizer's error feedback so the
    # quantization residual never biases the trunk (docs/fleet.md).
    # elements per wire chunk in the pipelined all-reduce: spans are split
    # into fixed-size chunks so hosts reduce (and the all-gather streams
    # back) each chunk as it arrives instead of stalling on monolithic
    # spans. <= 0 restores the monolithic-span wire format. Default 128Ki
    # fp32 elements = 512 KiB raw per message.
    chunk_size: int = 131072
    bandwidth: float = 1000.0  # advertised Mbps, for weighted partitioning
    # fixed port for the averager's own RPC server (0 = ephemeral). A
    # listening averager doubles as a circuit relay, so give PUBLIC peers a
    # fixed port here and point client-mode volunteers' --dht.relay at it.
    listen_port: int = 0
    # retrying state sync (peer-lifecycle robustness): a state download is
    # retried up to state_sync_retries times with exponential backoff
    # starting at state_sync_backoff seconds; each attempt refreshes the
    # provider list and prefers providers that have not failed yet, and
    # every snapshot is checksum-validated — so a dead or corrupt provider
    # costs one backoff instead of a failed join
    state_sync_retries: int = 2
    state_sync_backoff: float = 0.5
    # hierarchical (two-level) adaptive averaging (averaging/topology.py;
    # docs/fleet.md "when to enable hierarchical averaging"): path to a
    # TopologyPlan JSON partitioning the swarm into low-RTT cliques with
    # one delegate each — clique members reduce over cheap local links,
    # delegates carry the weight-summed contribution into the WAN round.
    # Generate with ``runlog_summary --topology`` (plan section) from a
    # run's link telemetry. Empty = today's flat butterfly; a plan whose
    # mode is "flat" is also a no-op, and any mid-round failure falls
    # back to a flat retry of the same round automatically.
    topology_plan: str = ""
    # live re-planning (averaging/planwire.py): follow the coordinator's
    # epoch-versioned plan record on the DHT and adopt the newest valid
    # plan between rounds — the closed adaptation loop (docs/fleet.md
    # "closed-loop operations"). Pinning --averager.topology_plan above
    # DISABLES following (the manual opt-out); plan_follow=false disables
    # it outright even without a pin.
    plan_follow: bool = True
    plan_refresh_period: float = 30.0  # seconds between plan-record polls
    # contribution-ledger receipts (telemetry/ledger.py): countersign each
    # averaging round's group envelope into a signed RoundReceipt DHT
    # record, making group-mates' cumulative claims checkable by the
    # coordinator fold (docs/observability.md "signed contribution ledger")
    ledger_receipts: bool = True


@dataclass
class CollaborativeOptimizerArguments:
    """Reference: CollaborativeOptimizerArguments (albert/arguments.py:56-77)."""

    target_batch_size: int = 4096
    batch_size_lead: int = 0
    statistics_expiration: float = 600.0
    # serve model+opt state to late joiners (p2p state transfer); turn off on
    # solo/benchmark runs to keep the device↔host link free for dispatch
    allow_state_sharing: bool = True
    # cap each peer's CONTRIBUTED per-micro-batch mean gradient at
    # clip * (samples per micro-batch) before averaging (0 = off) — the
    # contributed tree is grad_acc / n_acc where n_acc counts MICRO-batches,
    # so with gradient accumulation the cap pairs with the micro-batch
    # sample count, not the boundary total. Sample-
    # weighted averaging assumes equal per-sample gradient quality; a
    # tiny-batch peer violates that hard (measured on SwAV ResNet-50 at
    # init: a B=2 boundary mean has global norm 56.7 = 28.4/sample vs a
    # B=16 one at 23.6 = 1.47/sample — 19x the per-sample energy, nearly
    # all sinkhorn noise) and its noise steers the group's averaged
    # direction. The cap is linear in the peer's own samples, so it
    # self-calibrates across batch sizes: at 2.0/sample it never binds a
    # healthy B=16 peer (1.47 at init, 0.31 trained) and suppresses the
    # B=2 outlier 14x. SwAV runs default it on (roles/swav.py).
    contrib_clip_per_sample: float = 0.0
    # contribution ramp (0 = off): a joining peer's averaging weight scales
    # linearly from 1/(ramp_rounds+1) of its sample count to its full
    # sample count over its first ramp_rounds completed global steps. The
    # joiner RECEIVES the group's averaged direction from round one but
    # barely perturbs it while its params settle into the group's basin —
    # the enforced form of "onboard volunteers onto a formed trunk"
    # (docs/fleet.md; measured: unramped from-scratch SwAV fleets probe
    # 13.0% vs the 22.4% solo bar). SwAV runs default it on.
    ramp_rounds: int = 0
    # trunk-health gate (0 = off): while this peer's advertised loss
    # exceeds ratio x the median advertised loss of the OTHER trainers, it
    # defers mixing entirely — contributing zero weight but still adopting
    # the group average — until its loss rejoins the pack. Engages only
    # for peers that report a loss (roles do, once per global step), and
    # only while the swarm median is POSITIVE (a multiplicative ratio
    # inverts on zero/negative losses). A gated peer never applies its
    # suspect gradients locally either: with no group average received it
    # drops them and resyncs state.
    health_gate_loss_ratio: float = 0.0
    # residual error feedback for lossy wire compression (on by default;
    # no-op under --averager.compression none): each round's quantization
    # error is added back into the next round's contribution, keeping the
    # averaged trunk unbiased under float16/uint8 wire formats
    # (collaborative/error_feedback.py, docs/fleet.md)
    error_feedback: bool = True
    # opt-in background averaging: launch the averaging round at the
    # boundary and keep accumulating the next microbatches; the averaged
    # update applies when the round lands — ONE boundary late (bounded
    # staleness). Auto-disables during the contribution ramp, while
    # health-gated, and around state sync; a failed overlapped round falls
    # back to synchronous averaging (docs/fleet.md staleness contract).
    overlap_averaging: bool = False
    # contribution-ledger claims (telemetry/ledger.py): periodically
    # publish this peer's signed cumulative ContributionClaim DHT record
    # (samples, rounds, wall-seconds, bytes served) so the coordinator can
    # fold it against group-mates' receipts into the volunteer leaderboard
    # (docs/observability.md "signed contribution ledger")
    ledger_claims: bool = True
    claim_period: float = 30.0  # dht-time seconds between claim refreshes
    # device-resident flat gradient pipeline (averaging/device_flat.py):
    # the boundary's mean/clip/error-feedback/quantize run in ONE fused jit
    # on the accelerator, and the (compressed, under fp16/uint8 wire
    # formats) flat buffer streams to the host in async chunks overlapped
    # with matchmaking / accumulation. Off restores the legacy per-leaf
    # device_get + host flatten + host codec path.
    device_flat: bool = True
    # fused flat optimizer apply (optim/flat.py + make_flat_apply_step):
    # the averaged result crosses host->device as ONE buffer and the whole
    # LAMB update runs as segment reductions over it, with the NaN guard
    # fused in. Per-leaf guarded apply otherwise. Fleet-wide choice, like
    # --averager.compression: peers should agree so replica params evolve
    # identically (the flat math agrees with the per-leaf chain to float32
    # reduction-order, ~1e-7 relative — see docs/perf.md round 6).
    flat_apply: bool = True


@dataclass
class TrainingArguments:
    """Local-step recipe, mirroring AlbertTrainingArguments
    (albert/arguments.py:104-128)."""

    model_size: str = "large"  # tiny (CI fixture) | large
    # override model remat: nothing|dots|dots_no_batch|dots_no_batch_attn|
    # fused_ln|fused_ln_gelu (fused_ln — saved Pallas outputs + named
    # matmuls, pairs the fused add+LN kernel on automatically — is the
    # fastest measured policy for the seq-512 recipe on v5e; the policy
    # table lives in models/albert.py, measurements in docs/perf.md)
    remat_policy: str = ""
    attention_impl: str = ""  # override: dense|blockwise|flash|ring
    vocab_size: int = 0  # override model vocab (0 = size default); must cover
    # the dataset tokenizer's vocab (checked against the shard dir's meta.json)
    dataset_path: str = ""  # tokenized dataset dir; empty = synthetic fixture
    # streaming mode (sahajbert capability): one-document-per-line text
    # files mixed by weight, tokenized on the fly (needs tokenizer_path)
    streaming_files: List[str] = field(default_factory=list)
    streaming_weights: List[float] = field(default_factory=list)
    streaming_buffer_size: int = 10_000
    tokenizer_path: str = ""  # trained tokenizer.json for streaming mode
    max_local_steps: int = 0  # stop after N accumulation boundaries (0 = run forever)
    seq_length: int = 512
    per_device_batch_size: int = 4
    # >1: this peer is a whole slice — a data-parallel mesh over N local
    # devices; the per-micro-batch grad mean rides ICI psums and the slice
    # acts as ONE collaboration member (SURVEY.md §2.6 TPU-native mapping)
    mesh_devices: int = 1
    mesh_device_offset: int = 0  # carve disjoint device ranges (tests)
    # sequence parallelism: factor of mesh_devices assigned to a "seq" mesh
    # axis; with attention_impl="ring" the attention KV shards rotate around
    # that axis (ring attention) so no device ever holds the full S×S scores
    mesh_seq_devices: int = 1
    # tensor parallelism: factor of mesh_devices assigned to a "model" mesh
    # axis — params/grads/moments shard by the Megatron-style ALBERT rules
    # (parallel/sharding.py) and XLA inserts the ICI collectives. Composes
    # with data/seq axes and zero_sharding (ZeRO then shards only the
    # moments TP left replicated).
    mesh_model_devices: int = 1
    # pipeline parallelism: factor of mesh_devices assigned to a "pipe" mesh
    # axis — ALBERT's shared block staged across it (GPipe microbatch
    # schedule under shard_map, parallel/pipeline.py). Composes with the
    # data axis; "seq"/"model" axes need collectives inside the stage and
    # are rejected. Checkpoints/grad schemas match the non-pipelined model.
    mesh_pipe_devices: int = 1
    # microbatches per boundary on the pipe (0 = 2 x stages); bubble
    # fraction = (stages-1)/(microbatches+stages-1)
    pipe_microbatches: int = 0
    # expert parallelism: factor of mesh_devices assigned to an "expert"
    # mesh axis — the MoE FFN's experts shard over it (requires
    # moe_experts % mesh_expert_devices == 0); the Switch dispatch einsums
    # lower to XLA all-to-alls (parallel/moe.py)
    mesh_expert_devices: int = 1
    # >0: replace the dense FFN with a Switch-routed mixture of this many
    # experts (shared across ALBERT's layer iterations). The load-balancing
    # aux loss is added at moe_aux_weight.
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # ZeRO-1: shard optimizer moments over the slice mesh's data axis
    # (state memory / n_devices; params+grads stay replicated for the
    # cross-slice averager). Requires mesh_devices > 1.
    zero_sharding: bool = False
    gradient_accumulation_steps: int = 2
    learning_rate: float = 0.00176
    warmup_steps: int = 5000
    total_steps: int = 125_000
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    clamp_value: float = 10000.0
    seed: int = 0
    output_dir: str = "outputs"
    save_steps: int = 500
    save_total_limit: int = 2
    # telemetry (vissl PerfStats capability on the flagship path):
    train_log_path: str = ""  # per-global-step JSONL: wall/step/loss/phases
    log_perf_steps: int = 0  # log a PerfStats phase report every N global steps


@dataclass
class CheckpointArguments:
    """Swarm checkpointing (dedloc_tpu/checkpointing, docs/fleet.md restart
    runbook): the shared state is also served as a signed manifest + fixed-
    size content-addressed shards announced on the DHT catalog, and a
    joiner/restarted swarm restores by pulling distinct shards from
    distinct providers in parallel (full-blob download stays the
    fallback)."""

    # fp32 elements per shard of the flattened state (4 bytes each; the
    # default 1Mi elements = 4 MiB per shard). <= 0 disables the sharded
    # path entirely — serving, catalog announcements and sharded restore
    # all degrade to the single-provider full blob.
    shard_size: int = 1 << 20
    # concurrent shard downloads during a restore
    fetch_parallelism: int = 4
    # cap on distinct providers one restore spreads across (0 = all
    # announcing providers)
    providers: int = 0
    # local shard cache dir ("" = <output_dir>/shard_cache): fetched shards
    # persist here so a restore killed mid-flight RESUMES instead of
    # refetching; "none" disables the cache
    cache_dir: str = ""


@dataclass
class TelemetryArguments:
    """Swarm telemetry (dedloc_tpu/telemetry, docs/observability.md): a
    process-local registry of counters/histograms + span tracing across the
    DHT/averaging/optimizer seams. One flag: disabled (the default) costs
    one attribute load per instrumented site and emits nothing."""

    enabled: bool = False
    # per-peer JSONL event log ("" = in-memory trace only); rendered by
    # ``python tools/runlog_summary.py --health <events.jsonl> ...``
    event_log_path: str = ""
    # seconds between snapshots of this peer's counters onto the signed DHT
    # metrics bus (LocalMetrics.telemetry) — the coordinator aggregates them
    # into its swarm-health JSONL record
    snapshot_period: float = 30.0
    # how many per-link estimates (telemetry/links.py: RTT + goodput EWMAs
    # per destination, busiest first) ride each metrics-bus snapshot and
    # each link.stats event-log flush — bounds the signed record's size on
    # large swarms; the coordinator folds these into the swarm topology
    # record rendered by ``runlog_summary --topology``
    link_top_k: int = 8


@dataclass
class ServingArguments:
    """Swarm-sharded MoE serving (dedloc_tpu/serving, docs/serving.md):
    expert shards hosted across peers, discovered via the signed
    ``{prefix}_experts`` DHT namespace, routed latency/load-aware by the
    gateway with deadline/retry/hedge and a residual fall-through."""

    enabled: bool = False
    # gateway routing policy (serving/router.py RouterPolicy)
    refresh_period: float = 5.0  # expert-directory staleness bound, s
    request_deadline: float = 2.0  # total per-request budget, s
    attempt_timeout: float = 0.6  # per-attempt RPC timeout, s
    retries: int = 2  # extra attempts after the first
    backoff: float = 0.05  # base transport-failure backoff, doubled
    hedge_after: float = 0.3  # fire the runner-up after this wait, s
    # expert-host knobs (serving/host.py)
    capacity: int = 4096  # max tokens admitted per dispatch window
    announce_period: float = 10.0  # expert-record refresh cadence, s
    # per-peer token-bucket admission on the dispatch RPC (0 rate = open)
    admission_rate: float = 50.0
    admission_burst: float = 100.0
    # per-peer token-bucket admission on the DHT store RPC (0 = open; the
    # public-run hardening knob — over-rate stores are refused with a
    # named reason and counted under serve.rejected)
    store_rate: float = 0.0
    store_burst: float = 0.0


@dataclass
class AuthArguments:
    """Gated-run credentials (sahajbert/huggingface_auth.py capability):
    when ``username`` is set, the role fetches a signed access token from
    ``endpoint`` (default: the first initial peer, where the coordinator
    hosts the AuthService) and every matchmaking message rides signed
    envelopes."""

    username: str = ""
    credential: str = ""
    endpoint: str = ""  # "host:port"; empty = first initial peer


@dataclass
class CollaborationArguments:
    dht: DHTArguments = field(default_factory=DHTArguments)
    averager: AveragerArguments = field(default_factory=AveragerArguments)
    optimizer: CollaborativeOptimizerArguments = field(
        default_factory=CollaborativeOptimizerArguments
    )
    training: TrainingArguments = field(default_factory=TrainingArguments)
    auth: AuthArguments = field(default_factory=AuthArguments)
    telemetry: TelemetryArguments = field(default_factory=TelemetryArguments)
    checkpoint: CheckpointArguments = field(default_factory=CheckpointArguments)
    serving: ServingArguments = field(default_factory=ServingArguments)
    wandb_project: Optional[str] = None
    bandwidth: float = 1000.0


@dataclass
class SwAVTrainingArguments:
    """SwAV local-step recipe, mirroring swav_1node_resnet_submit.yaml
    (:33-37,68,93-104) + sgd_collaborative.py:145-157."""

    model_size: str = "resnet50"  # tiny (CI fixture) | resnet50
    image_folder: str = ""  # real images (flat or class-subdir layout);
    # empty = synthetic fixture. Decoded+augmented via the SwAV SimCLR stack.
    max_local_steps: int = 0  # accumulation boundaries to run (0 = forever)
    per_device_batch_size: int = 8
    gradient_accumulation_steps: int = 1
    learning_rate: float = 0.3  # LARC-SGD base lr (defaults.yaml SwAV recipe)
    momentum: float = 0.9
    weight_decay: float = 1e-6
    trust_coefficient: float = 0.001
    warmup_steps: int = 500
    total_steps: int = 100_000
    queue_length: int = 0  # per-peer embedding queue (0 = off)
    queue_start_step: int = 0  # global step gating use_queue (yaml :95)
    mesh_devices: int = 1  # >1: this peer is a whole slice (see trainer)
    mesh_device_offset: int = 0
    seed: int = 0
    output_dir: str = "outputs_swav"
    save_steps: int = 0
    save_total_limit: int = 2
    log_every: int = 10
    device_stats_every: int = 100  # HBM stats cadence (0 = off)


@dataclass
class SwAVCollaborationArguments:
    """Argument tree for the SwAV collaborative driver (the fork's
    SGDCollaborative defaults: target_batch_size 32768,
    sgd_collaborative.py:153)."""

    dht: DHTArguments = field(default_factory=DHTArguments)
    averager: AveragerArguments = field(default_factory=AveragerArguments)
    optimizer: CollaborativeOptimizerArguments = field(
        default_factory=lambda: CollaborativeOptimizerArguments(
            target_batch_size=32768,
            # sinkhorn gradients from tiny-batch volunteers are high-energy
            # noise (see contrib_clip_per_sample) — SwAV defaults the
            # contribution clip ON; ALBERT keeps it off (LAMB's apply-side
            # max_grad_norm already bounds that path and the converged
            # recipe predates the knob)
            contrib_clip_per_sample=2.0,
            # SwAV also defaults the contribution ramp ON: basin formation
            # is exactly where multi-peer gradient noise cost ~40% of the
            # probe (13.0% vs 22.4% solo, BASELINE.md round 5) — a fresh
            # joiner spends its first 10 rounds adopting the trunk's
            # direction before mixing at full weight
            ramp_rounds=10,
        )
    )
    training: SwAVTrainingArguments = field(
        default_factory=SwAVTrainingArguments
    )
    telemetry: TelemetryArguments = field(default_factory=TelemetryArguments)
    checkpoint: CheckpointArguments = field(default_factory=CheckpointArguments)
