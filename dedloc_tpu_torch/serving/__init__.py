"""Swarm-sharded MoE serving: the training swarm doubling as an
inference fleet (ROADMAP item 1, the million-user workload).

Three layers, each riding machinery that already exists:

- ``records``  — signed ``ExpertRecord`` discovery under the
  ``{prefix}_experts`` DHT namespace (the checkpoint-catalog /
  contribution-ledger record pattern: one schema-validated, identity-bound
  subkey slot per hosting peer, last-write-wins refresh).
- ``host``     — the expert side: registers the ``expert.dispatch`` RPC on
  a peer's existing server, computes the Switch FFN for its hosted expert
  shards, tracks a load EWMA, and re-announces.
- ``router``   — the gateway side: resolves a gating network's top-1
  choice to a live hosting peer (link-table RTT + fat/thin uplink
  classification + load), dispatches token batches with per-request
  deadlines, bounded retries with backoff and a hedged fallback, and
  degrades to the Switch residual path when every candidate is dead or
  over capacity — a request can fall through, never wedge.
- ``admission``— per-peer token buckets shared by the DHT store path and
  the expert-dispatch path (public-run rate control, ROADMAP item 3).
"""
from dedloc_tpu_torch.serving.admission import Admission, TokenBucket
from dedloc_tpu_torch.serving.host import ExpertHost, ffn_compute_fn
from dedloc_tpu_torch.serving.records import (
    ExpertEntry,
    ExpertRecord,
    expert_directory,
    experts_key,
    parse_expert_records,
    publish_expert_record,
)
from dedloc_tpu_torch.serving.router import ExpertRouter, RouterPolicy

__all__ = [
    "Admission",
    "TokenBucket",
    "ExpertHost",
    "ffn_compute_fn",
    "ExpertEntry",
    "ExpertRecord",
    "expert_directory",
    "experts_key",
    "parse_expert_records",
    "publish_expert_record",
    "ExpertRouter",
    "RouterPolicy",
]
