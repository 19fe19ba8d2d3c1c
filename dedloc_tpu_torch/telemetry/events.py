"""Telemetry name catalog — GENERATED, do not edit by hand.

Regenerate after adding/renaming any emitted counter/gauge/
histogram/span/event name::

    python -m tools.dedlint --write-events

The dedlint schema checker (tools/dedlint) extracts every name
emitted through telemetry/registry.py call sites (plus declared
dynamic prefixes) and fails tier-1 when this file is stale or when
a consumer reads a key nothing emits (docs/contributor.md).
"""

ALLREDUCE_BYTES_RECEIVED = "allreduce.bytes_received"
ALLREDUCE_BYTES_SENT = "allreduce.bytes_sent"
ALLREDUCE_CHUNK_LATENCY_S = "allreduce.chunk_latency_s"
ALLREDUCE_CHUNKS_RECEIVED = "allreduce.chunks_received"
ALLREDUCE_CHUNKS_SENT = "allreduce.chunks_sent"
ALLREDUCE_FAILURES = "allreduce.failures"
ALLREDUCE_LINK = "allreduce.link"
ALLREDUCE_ROUND = "allreduce.round"
ALLREDUCE_ROUNDS = "allreduce.rounds"
ALLREDUCE_STRAGGLERS = "allreduce.stragglers"
AVG_BYTES_SAVED = "avg.bytes_saved"
AVG_ROUND = "avg.round"
AVG_TOPOLOGY_FALLBACK = "avg.topology.fallback"
AVG_TOPOLOGY_FALLBACKS = "avg.topology.fallbacks"
AVG_TOPOLOGY_PLAN = "avg.topology.plan"
AVG_TOPOLOGY_REPLAN = "avg.topology.replan"
AVG_TOPOLOGY_REPLANS = "avg.topology.replans"
AVG_TOPOLOGY_ROUND = "avg.topology.round"
AVG_TOPOLOGY_ROUNDS = "avg.topology.rounds"
CKPT_FETCH_FAILURES = "ckpt.fetch_failures"
CKPT_FETCH_RETRIES = "ckpt.fetch_retries"
CKPT_MANIFEST_SERVE = "ckpt.manifest.serve"
CKPT_MANIFEST_WRITTEN = "ckpt.manifest_written"
CKPT_MANIFESTS_WRITTEN = "ckpt.manifests_written"
CKPT_PROVIDER_GOODPUT = "ckpt.provider_goodput"
CKPT_RESTORE = "ckpt.restore"
CKPT_RESTORE_FAILURES = "ckpt.restore_failures"
CKPT_RESTORES = "ckpt.restores"
CKPT_SHARD_SERVE = "ckpt.shard.serve"
CKPT_SHARD_BYTES_FETCHED = "ckpt.shard_bytes_fetched"
CKPT_SHARD_BYTES_SERVED = "ckpt.shard_bytes_served"
CKPT_SHARD_FETCH_FAILED = "ckpt.shard_fetch_failed"
CKPT_SHARD_VERIFY_FAILURE = "ckpt.shard_verify_failure"
CKPT_SHARDS_FETCHED = "ckpt.shards_fetched"
CKPT_SHARDS_RESUMED = "ckpt.shards_resumed"
CKPT_SHARDS_SERVED = "ckpt.shards_served"
CKPT_VERIFY_FAILURES = "ckpt.verify_failures"
EXPERT_ANNOUNCES = "expert.announces"
EXPERT_BYTES_SERVED = "expert.bytes_served"
EXPERT_COMPUTE = "expert.compute"
EXPERT_LOAD_EWMA = "expert.load_ewma"
EXPERT_REQUESTS = "expert.requests"
EXPERT_TOKENS = "expert.tokens"
FAULT_APPLIED = "fault.applied"
FAULT_INJECTED = "fault.injected"
FAULTS_APPLIED = "faults.applied"
FAULTS_INJECTED = "faults.injected"
LEDGER_CLAIM = "ledger.claim"
LEDGER_CLAIMS = "ledger.claims"
LEDGER_DISCREPANCIES = "ledger.discrepancies"
LEDGER_RECEIPT = "ledger.receipt"
LEDGER_RECEIPTS = "ledger.receipts"
LINK_STATS = "link.stats"
METRICS_MALFORMED_RECORDS = "metrics.malformed_records"
MM_FORM_GROUP = "mm.form_group"
MM_JOIN_SERVE = "mm.join.serve"
MM_JOIN_FAILED = "mm.join_failed"
MM_JOIN_FAILURES = "mm.join_failures"
MM_LEADER_ABANDONED = "mm.leader_abandoned"
MM_LEADER_CHANGES = "mm.leader_changes"
MM_LEADER_DISSOLVED = "mm.leader_dissolved"
MM_ROUNDS_ABORTED = "mm.rounds_aborted"
MM_ROUNDS_ATTEMPTED = "mm.rounds_attempted"
MM_ROUNDS_FORMED = "mm.rounds_formed"
NET_BYTES_IN = "net.bytes_in"
NET_BYTES_OUT = "net.bytes_out"
OPT_BOUNDARIES = "opt.boundaries"
OPT_CATCH_UP = "opt.catch_up"
OPT_CATCH_UPS = "opt.catch_ups"
OPT_D2H_BYTES = "opt.d2h_bytes"
OPT_D2H_EXPOSED_S = "opt.d2h_exposed_s"
OPT_D2H_STREAM = "opt.d2h_stream"
OPT_D2H_WAIT_S = "opt.d2h_wait_s"
OPT_EF_RESIDUAL_NORM = "opt.ef_residual_norm"
OPT_GATE_ENGAGED = "opt.gate_engaged"
OPT_GLOBAL_STEP = "opt.global_step"
OPT_GRADS_APPLIED = "opt.grads_applied"
OPT_GRADS_DROPPED = "opt.grads_dropped"
OPT_NAN_ROLLBACK = "opt.nan_rollback"
OPT_NAN_ROLLBACKS = "opt.nan_rollbacks"
OPT_OVERLAP_APPLIED = "opt.overlap_applied"
OPT_OVERLAP_EFFICIENCY = "opt.overlap_efficiency"
OPT_OVERLAP_EXPOSED_S = "opt.overlap_exposed_s"
OPT_OVERLAP_FAILED = "opt.overlap_failed"
OPT_OVERLAP_HIDDEN_S = "opt.overlap_hidden_s"
OPT_OVERLAP_LAUNCHED = "opt.overlap_launched"
OPT_OVERLAP_LEDGER = "opt.overlap_ledger"
OPT_WEIGHT_DECISION = "opt.weight_decision"
OPT_WEIGHT_SCALE = "opt.weight_scale"
PEER_ENDPOINT = "peer.endpoint"
PLAN_SYNC_RETRIES = "plan_sync.retries"
PLAN_SYNC_RETRY = "plan_sync.retry"
RPC_CLIENT_CALLS = "rpc.client.calls"
RPC_CLIENT_FAILURE = "rpc.client.failure"
RPC_CLIENT_FAILURES = "rpc.client.failures"
RPC_CLIENT_REMOTE_ERRORS = "rpc.client.remote_errors"
RPC_CONN_LOST = "rpc.conn_lost"
RPC_CONNS_LOST = "rpc.conns_lost"
RPC_SERVER_ERRORS = "rpc.server.errors"
RPC_SERVER_REQUESTS = "rpc.server.requests"
RUN_CONFIG = "run.config"
SERVE_FALL_THROUGH = "serve.fall_through"
SERVE_HEDGES = "serve.hedges"
SERVE_HOST_FAILURE = "serve.host_failure"
SERVE_KNOWN_EXPERTS = "serve.known_experts"
SERVE_OK = "serve.ok"
SERVE_REFRESHES = "serve.refreshes"
SERVE_REJECT = "serve.reject"
SERVE_REJECTED = "serve.rejected"
SERVE_REQUEST = "serve.request"
SERVE_REQUESTS = "serve.requests"
SERVE_REROUTE = "serve.reroute"
SERVE_REROUTED = "serve.rerouted"
SERVE_RETRIES = "serve.retries"
SERVE_TOKENS = "serve.tokens"
STATE_SERVE = "state.serve"
STATE_SERVED = "state.served"
STATE_SERVED_BYTES = "state.served_bytes"
STATE_SYNC_ATTEMPTS = "state_sync.attempts"
STATE_SYNC_CHECKSUM_FAILURE = "state_sync.checksum_failure"
STATE_SYNC_CHECKSUM_FAILURES = "state_sync.checksum_failures"
STATE_SYNC_FAILED = "state_sync.failed"
STATE_SYNC_FAILURES = "state_sync.failures"
STATE_SYNC_OK = "state_sync.ok"
STATE_SYNC_RETRIES = "state_sync.retries"
STATE_SYNC_RETRY = "state_sync.retry"
STEP_MFU = "step.mfu"
STEP_PHASE = "step.phase"
STEP_PHASE_AVG_WIRE = "step.phase.avg_wire"
STEP_PHASE_FWD_BWD = "step.phase.fwd_bwd"
STEP_RECORD = "step.record"
STEP_SAMPLES_PER_SEC = "step.samples_per_sec"
STEP_WALL = "step.wall"
WATCH_ACTUATION = "watch.actuation"
WATCH_ACTUATIONS = "watch.actuations"
WATCH_INCIDENT = "watch.incident"
WATCH_LEDGER = "watch.ledger"
WATCH_ROLLBACK = "watch.rollback"
WATCH_ROLLBACKS = "watch.rollbacks"

COUNTERS = frozenset({
    "allreduce.bytes_received",
    "allreduce.bytes_sent",
    "allreduce.chunks_received",
    "allreduce.chunks_sent",
    "allreduce.failures",
    "allreduce.rounds",
    "allreduce.stragglers",
    "avg.bytes_saved",
    "avg.topology.fallbacks",
    "avg.topology.replans",
    "avg.topology.rounds",
    "ckpt.fetch_failures",
    "ckpt.fetch_retries",
    "ckpt.manifests_written",
    "ckpt.restore_failures",
    "ckpt.restores",
    "ckpt.shard_bytes_fetched",
    "ckpt.shard_bytes_served",
    "ckpt.shards_fetched",
    "ckpt.shards_resumed",
    "ckpt.shards_served",
    "ckpt.verify_failures",
    "expert.announces",
    "expert.bytes_served",
    "expert.requests",
    "expert.tokens",
    "faults.applied",
    "faults.injected",
    "ledger.claims",
    "ledger.discrepancies",
    "ledger.receipts",
    "metrics.malformed_records",
    "mm.join_failures",
    "mm.leader_changes",
    "mm.rounds_aborted",
    "mm.rounds_attempted",
    "mm.rounds_formed",
    "net.bytes_in",
    "net.bytes_out",
    "opt.boundaries",
    "opt.catch_ups",
    "opt.d2h_bytes",
    "opt.d2h_exposed_s",
    "opt.gate_engaged",
    "opt.grads_applied",
    "opt.grads_dropped",
    "opt.nan_rollbacks",
    "opt.overlap_applied",
    "opt.overlap_exposed_s",
    "opt.overlap_failed",
    "opt.overlap_hidden_s",
    "opt.overlap_launched",
    "plan_sync.retries",
    "rpc.client.calls",
    "rpc.client.failures",
    "rpc.client.remote_errors",
    "rpc.conns_lost",
    "rpc.server.errors",
    "rpc.server.requests",
    "serve.fall_through",
    "serve.hedges",
    "serve.ok",
    "serve.refreshes",
    "serve.rejected",
    "serve.requests",
    "serve.rerouted",
    "serve.retries",
    "serve.tokens",
    "state.served",
    "state.served_bytes",
    "state_sync.attempts",
    "state_sync.checksum_failures",
    "state_sync.failures",
    "state_sync.ok",
    "state_sync.retries",
    "watch.actuations",
    "watch.rollbacks",
})
GAUGES = frozenset({
    "expert.load_ewma",
    "opt.ef_residual_norm",
    "opt.overlap_efficiency",
    "opt.weight_scale",
    "serve.known_experts",
    "step.mfu",
    "step.samples_per_sec",
})
HISTOGRAMS = frozenset({
    "allreduce.chunk_latency_s",
    "allreduce.round",
    "avg.round",
    "ckpt.manifest.serve",
    "ckpt.provider_goodput",
    "ckpt.restore",
    "ckpt.shard.serve",
    "expert.compute",
    "mm.form_group",
    "mm.join.serve",
    "opt.d2h_wait_s",
    "serve.request",
    "state.serve",
    "step.phase.avg_wire",
    "step.phase.fwd_bwd",
    "step.wall",
})
EVENTS = frozenset({
    "allreduce.link",
    "allreduce.round",
    "allreduce.stragglers",
    "avg.round",
    "avg.topology.fallback",
    "avg.topology.plan",
    "avg.topology.replan",
    "avg.topology.round",
    "ckpt.manifest.serve",
    "ckpt.manifest_written",
    "ckpt.restore",
    "ckpt.shard.serve",
    "ckpt.shard_fetch_failed",
    "ckpt.shard_verify_failure",
    "expert.compute",
    "fault.applied",
    "fault.injected",
    "ledger.claim",
    "ledger.receipt",
    "link.stats",
    "mm.form_group",
    "mm.join.serve",
    "mm.join_failed",
    "mm.leader_abandoned",
    "mm.leader_dissolved",
    "opt.catch_up",
    "opt.d2h_stream",
    "opt.global_step",
    "opt.grads_dropped",
    "opt.nan_rollback",
    "opt.overlap_applied",
    "opt.overlap_failed",
    "opt.overlap_launched",
    "opt.overlap_ledger",
    "opt.weight_decision",
    "peer.endpoint",
    "plan_sync.retry",
    "rpc.client.failure",
    "rpc.conn_lost",
    "run.config",
    "serve.fall_through",
    "serve.host_failure",
    "serve.reject",
    "serve.request",
    "serve.reroute",
    "state.serve",
    "state_sync.checksum_failure",
    "state_sync.failed",
    "state_sync.ok",
    "state_sync.retry",
    "step.phase",
    "step.record",
    "watch.actuation",
    "watch.incident",
    "watch.ledger",
    "watch.rollback",
})
SPANS = frozenset({
    "allreduce.round",
    "avg.round",
    "ckpt.manifest.serve",
    "ckpt.restore",
    "ckpt.shard.serve",
    "expert.compute",
    "mm.form_group",
    "mm.join.serve",
    "serve.request",
    "state.serve",
})
EMITTED = COUNTERS | GAUGES | HISTOGRAMS | EVENTS

# declared dynamic-name families (emit-site pragmas)
EMITTED_PREFIXES = (
    "link.",
    "perf.",
    "step.phase.",
)

# how histograms flatten onto the metrics-bus snapshot
SNAPSHOT_SUFFIXES = (".count", ".mean", ".max", ".min")

def known_key(key: str) -> bool:
    """True when ``key`` is a name some instrumented site emits: exact,
    under a declared dynamic prefix, or a snapshot-flattened histogram
    field (``<histogram>.mean`` etc)."""
    if key in EMITTED:
        return True
    if key.startswith(EMITTED_PREFIXES):
        return True
    for suffix in SNAPSHOT_SUFFIXES:
        if key.endswith(suffix):
            base = key[: -len(suffix)]
            if base in HISTOGRAMS or base.startswith(EMITTED_PREFIXES):
                return True
    return False

