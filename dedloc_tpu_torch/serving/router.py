"""Latency/load-aware expert routing: top-1 choice -> a live hosting peer.

The ``ExpertRouter`` is the embeddable gateway core (``roles/gateway.py``
wraps it in a role). Per dispatch:

1. **Resolve** — the expert directory is a cached parse of the
   ``{prefix}_experts`` DHT entry, refreshed every ``refresh_period_s`` of
   virtual/monotonic time (one discovery refresh is the re-route bound the
   serving scenario asserts).
2. **Rank** — candidates are scored ``effective_rtt * (1 + load/capacity)``
   from the peer's OWN link table (PR 6: RTT EWMAs observed on every RPC
   connect) plus the record's published load EWMA; candidates whose
   observed ``peak_bps`` clears ``FAT_UPLINK_FACTOR`` x the candidate
   median get the fat-peer discount (PR 15's fat/thin classification,
   reused as a serving prior: a fat uplink absorbs a token burst a thin
   one chokes on). Unknown links fall back to a flat RTT prior, so ranking
   is deterministic for a fixed DHT view.
3. **Dispatch** — per-request deadline, bounded retries with exponential
   backoff ACROSS candidates (a structured refusal — over-rate,
   over-capacity, wrong-version — reroutes immediately without backoff;
   only transport failures back off), plus a hedged fallback: when the
   best candidate has not answered after ``hedge_after_s`` the runner-up
   is fired concurrently and the first acceptance wins.
4. **Degrade** — when every candidate is dead or refusing, the dispatch
   returns ``None`` and the caller takes the Switch residual path
   (parallel/moe.py's over-capacity fall-through semantics: the token
   rides the residual connection, the request NEVER wedges).

``serve.*`` spans ride the PR 6 trace propagation: the gateway seeds the
trace from the request id and the host's ``expert.compute`` span adopts it
off the RPC framing, so ``runlog_summary --trace <request-id>`` stitches
one inference request across peers.
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from dedloc_tpu_torch.averaging.topology import FAT_UPLINK_FACTOR
from dedloc_tpu_torch.core.serialization import (
    CompressionType,
    deserialize_array,
    serialize_array,
)
from dedloc_tpu_torch.core.timeutils import monotonic
from dedloc_tpu_torch.serving.records import (
    ExpertEntry,
    ExpertRecord,
    expert_directory,
    experts_key,
    parse_expert_records,
)
from dedloc_tpu_torch.telemetry import registry as telemetry
from dedloc_tpu_torch.telemetry.links import endpoint_key
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

DISPATCH_METHOD = "expert.dispatch"  # host.py registers this handler


@dataclasses.dataclass
class RouterPolicy:
    """Gateway dispatch knobs (--serving.* flags, core/config.py)."""

    deadline_s: float = 2.0  # total per-request budget
    attempt_timeout_s: float = 0.6  # per-attempt RPC timeout
    retries: int = 2  # extra attempts after the first
    backoff_s: float = 0.05  # base backoff, doubled per retry
    hedge_after_s: float = 0.3  # fire the runner-up after this wait
    refresh_period_s: float = 5.0  # expert-directory staleness bound
    default_rtt_s: float = 0.15  # prior for never-observed links
    load_penalty: float = 1.0  # weight of load/capacity in the score
    fat_discount: float = 0.5  # score multiplier for fat-uplink hosts


class ExpertRouter:
    """Resolve expert ids to live hosting peers and dispatch token batches.

    Built over a peer's existing ``DHTNode`` (its RPC client is the
    transport seam, its get path is discovery); embeddable in any role or
    simulator peer."""

    def __init__(
        self,
        node,  # DHTNode
        prefix: str,
        policy: Optional[RouterPolicy] = None,
        telemetry_registry=None,
        caller: str = "",
    ):
        self.node = node
        self.prefix = prefix
        self.policy = policy or RouterPolicy()
        self.telemetry = telemetry_registry
        self.caller = caller or node.node_id.to_bytes().hex()[:16]
        self._directory: Dict[int, List[Tuple[ExpertRecord, ExpertEntry]]] = {}
        self._refreshed_at: Optional[float] = None
        # endpoints that failed a transport attempt THIS directory
        # generation: skipped until the next refresh re-admits whatever
        # the DHT still advertises (re-route within one discovery refresh)
        self._dead: set = set()
        # latest load numbers piggybacked on dispatch replies — fresher
        # than the records' announce-time EWMAs
        self._live_load: Dict[str, float] = {}

    # ---------------------------------------------------------- discovery

    async def refresh(self, force: bool = False) -> None:
        """Re-read the expert directory when stale (or on ``force``)."""
        now = monotonic()
        if (
            not force
            and self._refreshed_at is not None
            and now - self._refreshed_at < self.policy.refresh_period_s
        ):
            return
        entry = await self.node.get(
            experts_key(self.prefix).encode(), latest=True
        )
        items = (
            [(sk, v.value) for sk, v in entry.value.items()]
            if entry is not None and hasattr(entry.value, "items")
            else []
        )
        records = parse_expert_records(items)
        self._directory = expert_directory(records)
        self._refreshed_at = now
        self._dead.clear()
        tele = telemetry.resolve(self.telemetry)
        if tele is not None:
            tele.counter("serve.refreshes").inc()
            tele.gauge("serve.known_experts").set(float(len(self._directory)))

    def known_experts(self) -> List[int]:
        return sorted(self._directory)

    # ------------------------------------------------------------- ranking

    def _link_stats(self) -> Dict[str, Dict[str, float]]:
        tele = telemetry.resolve(self.telemetry)
        if tele is None or tele._links is None:
            return {}
        return {rec["dst"]: rec for rec in tele.links().records()}

    def candidates(
        self, expert_id: int
    ) -> List[Tuple[Any, ExpertRecord, ExpertEntry, float]]:
        """Live candidates for ``expert_id``, best-scored first:
        ``(endpoint, record, entry, score)``. Deterministic for a fixed
        directory + link table (ties break on peer id)."""
        hosted = self._directory.get(int(expert_id), [])
        links = self._link_stats()
        peaks = []
        for record, _entry in hosted:
            rec = links.get(endpoint_key(record.endpoint))
            if rec and rec.get("peak_bps"):
                peaks.append(float(rec["peak_bps"]))
        median_peak = sorted(peaks)[len(peaks) // 2] if peaks else 0.0
        scored = []
        for record, entry in hosted:
            key = endpoint_key(record.endpoint)
            if key in self._dead:
                continue
            rec = links.get(key, {})
            rtt = float(rec.get("rtt_s") or self.policy.default_rtt_s)
            load = self._live_load.get(record.peer, float(entry.load_ewma))
            score = rtt * (
                1.0
                + self.policy.load_penalty * load / max(1.0, float(entry.capacity))
            )
            peak = float(rec.get("peak_bps") or 0.0)
            if median_peak > 0 and peak >= FAT_UPLINK_FACTOR * median_peak:
                score *= self.policy.fat_discount  # fat-uplink preference
            scored.append((tuple(record.endpoint), record, entry, score))
        scored.sort(key=lambda c: (c[3], c[1].peer))
        return scored

    # ------------------------------------------------------------ dispatch

    async def _attempt(
        self, endpoint, args: Dict[str, Any], timeout: float
    ) -> Dict[str, Any]:
        """One wire attempt; raises on transport error, returns the reply
        dict (which may be a structured refusal) otherwise."""
        return await self.node.client.call(
            tuple(endpoint), DISPATCH_METHOD, args, timeout=timeout
        )

    async def dispatch(
        self,
        expert_id: int,
        tokens: np.ndarray,
        request_id: str,
        version: Optional[int] = None,
    ) -> Optional[np.ndarray]:
        """Route one token batch to a live host of ``expert_id``.

        Returns the expert outputs ``[T, H]`` (gate-weighting is the
        caller's job, as in parallel/moe.py's combine), or ``None`` when
        the request fell through to the residual path. Never raises on
        peer failure and never blocks past the deadline."""
        tele = telemetry.resolve(self.telemetry)
        pol = self.policy
        with telemetry.span(
            "serve.request",
            telemetry=self.telemetry,
            trace_seed=str(request_id),
            round_id=str(request_id),
            expert_id=int(expert_id),
            tokens=int(tokens.shape[0]),
        ) as ctx:
            if tele is not None:
                tele.counter("serve.requests").inc()
            await self.refresh()
            args = {
                "expert_id": int(expert_id),
                "tokens": serialize_array(
                    np.ascontiguousarray(tokens, dtype=np.float32),
                    CompressionType.NONE,
                ),
                "request_id": str(request_id),
                "caller": self.caller,
            }
            if version is not None:
                args["version"] = int(version)
            deadline = monotonic() + pol.deadline_s
            attempts = 0
            refreshed_midflight = False
            while attempts <= pol.retries:
                ranked = self.candidates(expert_id)
                if not ranked and not refreshed_midflight:
                    # maybe the directory is stale (host died with its
                    # record; record expired) — one forced re-resolve
                    refreshed_midflight = True
                    await self.refresh(force=True)
                    ranked = self.candidates(expert_id)
                if not ranked:
                    break
                remaining = deadline - monotonic()
                if remaining <= 0:
                    break
                timeout = min(pol.attempt_timeout_s, remaining)
                primary = ranked[0]
                hedge_target = ranked[1] if len(ranked) > 1 else None
                reply, endpoint = await self._attempt_with_hedge(
                    primary, hedge_target, args, timeout, tele
                )
                attempts += 1
                if reply is None:
                    # transport failure on every path tried this attempt:
                    # back off (unless the deadline says otherwise), then
                    # re-rank — the dead-set now excludes the failed hosts
                    if tele is not None:
                        tele.counter("serve.retries").inc()
                    backoff = pol.backoff_s * (2 ** (attempts - 1))
                    if monotonic() + backoff >= deadline:
                        break
                    await asyncio.sleep(backoff)
                    continue
                if not reply.get("accepted"):
                    # structured refusal: this replica said no (over-rate /
                    # over-capacity / wrong-version) — reroute immediately,
                    # no backoff, and do not blame the transport
                    if tele is not None:
                        tele.counter("serve.rerouted").inc()
                        tele.event(
                            "serve.reroute",
                            expert_id=int(expert_id),
                            reason=str(reply.get("reason")),
                            endpoint=endpoint_key(endpoint),
                        )
                    self._dead.add(endpoint_key(endpoint))
                    continue
                record_peer = next(
                    (r.peer for _ep, r, _e, _s in ranked
                     if endpoint_key(_ep) == endpoint_key(endpoint)),
                    None,
                )
                if record_peer and reply.get("load_ewma") is not None:
                    self._live_load[record_peer] = float(reply["load_ewma"])
                if tele is not None:
                    tele.counter("serve.ok").inc()
                    tele.counter("serve.tokens").inc(int(tokens.shape[0]))
                ctx["ok"] = True
                ctx["endpoint"] = endpoint_key(endpoint)
                return deserialize_array(reply["data"])
            # every path exhausted: Switch residual fall-through
            if tele is not None:
                tele.counter("serve.fall_through").inc()
                tele.event(
                    "serve.fall_through",
                    expert_id=int(expert_id),
                    request_id=str(request_id),
                    attempts=attempts,
                )
            ctx["ok"] = False
            return None

    async def _attempt_with_hedge(
        self, primary, hedge_target, args, timeout: float, tele
    ) -> Tuple[Optional[Dict[str, Any]], Any]:
        """Fire the best candidate; if it has not answered after
        ``hedge_after_s`` and a runner-up exists, fire that too and take
        the first acceptance. Returns ``(reply, endpoint)`` — reply is
        None when every fired attempt failed at the transport.

        Completion checks are by explicit task identity (never set
        iteration over tasks), keeping the path bit-deterministic under
        the simulator engine."""
        p_ep = primary[0]
        p_task = asyncio.ensure_future(self._attempt(p_ep, args, timeout))
        hedge_wait = min(self.policy.hedge_after_s, timeout)
        p_failed = False
        try:
            reply = await asyncio.wait_for(asyncio.shield(p_task), hedge_wait)
            return reply, p_ep
        except asyncio.TimeoutError as e:
            # ambiguous: either the hedge window elapsed (primary still in
            # flight behind the shield) or the RPC's own deadline fired —
            # the task's done flag tells them apart
            if p_task.done():
                self._note_transport_failure(p_ep, e, tele)
                p_failed = True
        except Exception as e:  # noqa: BLE001 — transport failure
            self._note_transport_failure(p_ep, e, tele)
            p_failed = True
        if hedge_target is None:
            if p_failed:
                return None, p_ep
            try:
                return await p_task, p_ep
            except Exception as e:  # noqa: BLE001 — transport failure
                self._note_transport_failure(p_ep, e, tele)
                return None, p_ep
        h_ep = hedge_target[0]
        if tele is not None:
            tele.counter("serve.hedges").inc()
        h_task = asyncio.ensure_future(self._attempt(h_ep, args, timeout))
        if p_failed:
            try:
                return await h_task, h_ep
            except Exception as e:  # noqa: BLE001 — transport failure
                self._note_transport_failure(h_ep, e, tele)
                return None, h_ep
        await asyncio.wait(
            {p_task, h_task}, return_when=asyncio.FIRST_COMPLETED
        )
        # fixed-priority harvest (primary first) — a simultaneous finish
        # resolves the same way every run; never iterate the task set
        for task, ep, other, oep in (
            (p_task, p_ep, h_task, h_ep),
            (h_task, h_ep, p_task, p_ep),
        ):
            if task.done():
                try:
                    reply = task.result()
                except Exception as e:  # noqa: BLE001 — transport failure
                    self._note_transport_failure(ep, e, tele)
                    continue
                other.cancel()
                return reply, ep
        # no completed success yet: one of the two may still be in flight
        # (the other failed) — drain it, bounded by its own RPC deadline
        for task, ep in ((p_task, p_ep), (h_task, h_ep)):
            if not task.done():
                try:
                    return await task, ep
                except Exception as e:  # noqa: BLE001 — transport failure
                    self._note_transport_failure(ep, e, tele)
        return None, p_ep

    def _note_transport_failure(self, endpoint, error, tele) -> None:
        key = endpoint_key(endpoint)
        self._dead.add(key)
        if tele is not None:
            tele.event(
                "serve.host_failure",
                endpoint=key,
                error=type(error).__name__,
            )

    # -------------------------------------------------- collaborative MoE

    def gate_top1(
        self, router_params: np.ndarray, x: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The gating network's top-1 choice, NumPy mirror of
        parallel/moe.py: softmax over ``x @ router`` -> (expert_idx [T],
        gate [T])."""
        logits = x.astype(np.float32) @ np.asarray(router_params, np.float32)
        z = logits - logits.max(axis=-1, keepdims=True)
        ez = np.exp(z)
        gates = ez / ez.sum(axis=-1, keepdims=True)
        idx = gates.argmax(axis=-1)
        gate = np.take_along_axis(gates, idx[:, None], axis=-1)[:, 0]
        return idx, gate

    async def infer(
        self,
        router_params: np.ndarray,
        x: np.ndarray,
        request_id: str,
        version: Optional[int] = None,
    ) -> Tuple[np.ndarray, Dict[str, int]]:
        """One collaborative MoE layer over the swarm: gate locally, group
        tokens per chosen expert, dispatch the groups concurrently, combine
        gate-weighted — tokens whose expert fell through contribute zeros
        (the Switch residual path, added by the caller exactly as with the
        in-mesh ``moe_ffn``). Returns ``(y [T, H], stats)``."""
        idx, gate = self.gate_top1(router_params, x)
        y = np.zeros_like(x, dtype=np.float32)
        groups: Dict[int, np.ndarray] = {}
        for e in sorted(set(int(v) for v in idx)):
            groups[e] = np.nonzero(idx == e)[0]

        async def one(e: int, rows: np.ndarray):
            return e, rows, await self.dispatch(
                e, x[rows], f"{request_id}/e{e}", version=version
            )

        results = await asyncio.gather(
            *(one(e, rows) for e, rows in groups.items())
        )
        served = fell_through = 0
        for e, rows, out in results:
            if out is None:
                fell_through += len(rows)
                continue
            served += len(rows)
            y[rows] = gate[rows, None].astype(np.float32) * out
        return y, {
            "tokens": int(x.shape[0]),
            "served": served,
            "fall_through": fell_through,
            "experts": len(groups),
        }
