"""The expert side of the serving plane: host shards, serve dispatches.

An ``ExpertHost`` rides a peer's EXISTING RPC server (the same
``server.register`` seam the checkpoint provider uses), so a training peer
becomes a serving peer by attaching one object — no second listener, no
second port. It:

- registers the ``expert.dispatch`` RPC: admission-check, capacity-check,
  compute the expert FFN on the shipped token batch, return the outputs
  gate-weighting happens at the gateway (``router.py``), mirroring
  ``parallel/moe.py`` where ``combine`` applies the gate after expert_out;
- tracks a per-expert load EWMA and cumulative served counters — the load
  number is republished on every announce, so discovery and load reporting
  are one DHT write;
- accounts bytes/requests served for the contribution ledger
  (``ContributionClaim.bytes_served`` / ``requests_served``).

Expert weights arrive through the content-addressed checkpoint catalog
(the host is handed the already-restored per-expert ``wi``/``wo`` blocks,
or any ``compute_fn`` — the simulator uses a deterministic synthetic one).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from dedloc_tpu_torch.core.serialization import (
    CompressionType,
    deserialize_array,
    serialize_array,
)
from dedloc_tpu_torch.core.timeutils import get_dht_time, monotonic
from dedloc_tpu_torch.serving.admission import (
    Admission,
    REASON_OVER_CAPACITY,
    REASON_UNKNOWN_EXPERT,
    REASON_WRONG_VERSION,
)
from dedloc_tpu_torch.serving.records import (
    DEFAULT_EXPERT_TTL,
    ExpertEntry,
    ExpertRecord,
    LoadEWMA,
    publish_expert_record,
)
from dedloc_tpu_torch.telemetry import registry as telemetry
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

DISPATCH_METHOD = "expert.dispatch"


def ffn_compute_fn(params: Dict[str, np.ndarray]) -> Callable:
    """The real Switch expert computation for restored weights:
    ``gelu(x @ wi[e]) @ wo[e]`` (parallel/moe.py's per-expert math, NumPy
    so a CPU-only serving peer needs no accelerator)."""
    wi, wo = np.asarray(params["wi"]), np.asarray(params["wo"])

    def compute(expert_id: int, x: np.ndarray) -> np.ndarray:
        h = x.astype(np.float32) @ wi[expert_id]
        # tanh-approx GELU matches jax.nn.gelu's default closely enough
        # for serving parity tests (exact equivalence is locked where the
        # weights are, tests/test_moe.py)
        g = 0.5 * h * (1.0 + np.tanh(
            0.7978845608028654 * (h + 0.044715 * h ** 3)
        ))
        return (g @ wo[expert_id]).astype(np.float32)

    return compute


class ExpertHost:
    """Serve a set of expert shards from one peer's RPC server."""

    def __init__(
        self,
        node,  # DHTNode (or any object with .server, .client, .endpoint)
        prefix: str,
        expert_ids: List[int],
        version: int,
        compute_fn: Callable[[int, np.ndarray], np.ndarray],
        capacity: int = 4096,
        admission: Optional[Admission] = None,
        telemetry_registry=None,
        clock: Callable[[], float] = monotonic,
    ):
        self.node = node
        self.prefix = prefix
        self.expert_ids = sorted(int(e) for e in expert_ids)
        self.version = int(version)
        self.compute_fn = compute_fn
        self.capacity = int(capacity)
        self.admission = admission
        self.telemetry = telemetry_registry
        self._clock = clock
        self._load = {e: LoadEWMA(clock) for e in self.expert_ids}
        # cumulative ledger-claim inputs
        self.requests_served = 0
        self.tokens_served = 0
        self.bytes_served = 0
        node.server.register(DISPATCH_METHOD, self._rpc_dispatch)

    # ------------------------------------------------------------ serving

    def _refuse(self, reason: str, expert_id: Any) -> Dict[str, Any]:
        tele = telemetry.resolve(self.telemetry)
        if tele is not None:
            tele.counter("serve.rejected").inc()
            tele.event("serve.reject", reason=reason, expert_id=expert_id)
        return {"accepted": False, "reason": reason}

    async def _rpc_dispatch(self, peer, args: Dict[str, Any]) -> Dict[str, Any]:
        """One token-batch dispatch. Refusals are STRUCTURED (not raised):
        the router must tell "this replica said no" (reroute, don't retry
        it) apart from "the transport failed" (maybe retry)."""
        expert_id = int(args["expert_id"])
        caller = str(args.get("caller") or peer[0])
        if self.admission is not None:
            reason = self.admission.check(caller)
            if reason is not None:
                return self._refuse(reason, expert_id)
        if expert_id not in self._load:
            return self._refuse(REASON_UNKNOWN_EXPERT, expert_id)
        version = args.get("version")
        if version is not None and int(version) != self.version:
            return self._refuse(REASON_WRONG_VERSION, expert_id)
        x = deserialize_array(args["tokens"])
        if x.ndim != 2:
            raise ValueError(f"tokens must be [T, H], got shape {x.shape}")
        if x.shape[0] > self.capacity:
            # over the per-window token capacity: structured refusal — the
            # gateway falls through to the residual path or another host
            return self._refuse(REASON_OVER_CAPACITY, expert_id)
        tele = telemetry.resolve(self.telemetry)
        if tele is not None:
            # the span adopts the gateway's trace context off the RPC
            # framing, so one inference request stitches across peers in
            # ``runlog_summary --trace``
            with tele.span(
                "expert.compute", expert_id=expert_id, tokens=int(x.shape[0])
            ):
                y = self.compute_fn(expert_id, x)
        else:
            y = self.compute_fn(expert_id, x)
        load = self._load[expert_id].observe(float(x.shape[0]))
        payload = serialize_array(
            np.ascontiguousarray(y, dtype=np.float32), CompressionType.NONE
        )
        self.requests_served += 1
        self.tokens_served += int(x.shape[0])
        self.bytes_served += len(payload) + len(args["tokens"])
        if tele is not None:
            tele.counter("expert.requests").inc()
            tele.counter("expert.tokens").inc(int(x.shape[0]))
            tele.counter("expert.bytes_served").inc(
                len(payload) + len(args["tokens"])
            )
            tele.gauge("expert.load_ewma").set(round(load, 3))
        return {
            "accepted": True,
            "expert_id": expert_id,
            "data": payload,
            "load_ewma": round(load, 6),
        }

    # ---------------------------------------------------------- discovery

    def record(self) -> ExpertRecord:
        """This host's current ``ExpertRecord`` (live load numbers)."""
        return ExpertRecord(
            peer=self.node.node_id.to_bytes().hex(),
            endpoint=list(self.node.endpoint),
            experts=[
                ExpertEntry(
                    expert_id=e,
                    version=self.version,
                    capacity=self.capacity,
                    load_ewma=round(self._load[e].value(), 6),
                )
                for e in self.expert_ids
            ],
            time=get_dht_time(),
        )

    async def announce(
        self, expiration: float = DEFAULT_EXPERT_TTL
    ) -> bool:
        """Refresh this peer's expert slot in the DHT. Subkey = the node
        id (open-swarm binding); gated runs announce under the RSA owner
        tag via the same helper by passing the signer's subkey through
        ``publish_expert_record`` directly."""
        ok = await publish_expert_record(
            self.node, self.prefix, self.record(),
            subkey=self.node.node_id.to_bytes(), expiration=expiration,
        )
        tele = telemetry.resolve(self.telemetry)
        if tele is not None:
            tele.counter("expert.announces").inc()
        return ok
