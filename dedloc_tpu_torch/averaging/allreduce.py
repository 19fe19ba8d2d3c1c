"""Fault-tolerant group all-reduce over TCP: pipelined reduce-scatter +
all-gather with per-chunk streaming.

The cross-slice replacement for hivemind's butterfly all-reduce
(SURVEY.md §2.6): each group member hosts one bandwidth-weighted span of the
flat vector; senders scatter their spans to the hosts, each host computes the
weighted average of its span, then everyone gathers the reduced spans back.
Weighted by per-peer sample counts so the result is the exact weighted mean
of member vectors.

Wire-path pipelining (the hivemind part-streaming capability, TPU-native):
each span is split into fixed-size chunks (``chunk_size`` elements;
``chunk_size <= 0`` restores the monolithic-span wire format). Three things
overlap within one round instead of running back-to-back:

- hosts REDUCE each chunk eagerly, the moment the last expected sender's
  copy of that chunk arrives — reduction overlaps the remaining transfers;
- the all-gather STREAMS: every member requests all chunks up front and each
  request completes the instant that chunk finishes reducing, so reduced
  chunks ride back over the wire while later chunks are still inbound;
- a sender's scatter is per-chunk, so a host never waits for a full
  monolithic span before starting work.

Roles inside a group (capability parity with the reference):
- normal peer: weight > 0, bandwidth > 0 — sends data AND hosts a span
- auxiliary peer (run_aux.py): weight == 0, bandwidth > 0 — hosts a span,
  contributes bandwidth, sends no data (ONE zero-weight marker per host
  covers every chunk)
- client-mode peer (arguments.py:63-65): bandwidth == 0 — sends data and
  pulls results, hosts nothing (outbound connections only)

Weights are arbitrary non-negative floats, not just sample counts: the
collaborative optimizer's contribution ramp scales a freshly-joined peer's
weight from near-zero to its full sample count over its first ramp_rounds
rounds, and its trunk-health gate sends weight 0.0 for a diverged peer —
such a peer rides the aux wire path (zero-weight marker, no data) but still
gathers the group's reduced spans, i.e. it RECEIVES the average it did not
perturb.

Failure contract (mirrors the reference's straggler SLA,
albert/arguments.py:23-28): a SENDER that misses the ``straggler_timeout``
window is simply left out — hosts finalize whatever chunks arrived by then,
and all members still gather identical spans (consistent result, minus the
straggler's contribution; each chunk is served from exactly one host, so
every member sees the same bytes). A dead HOST is unrecoverable without
redundancy: its span cannot be gathered, the round raises AllreduceFailed
for everyone, and the group re-forms next round (the reference's 'group
failure costs one round' semantics, contributor notebook cell 3).
"""
from __future__ import annotations

import asyncio
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from dedloc_tpu_torch import native
from dedloc_tpu_torch.core.serialization import (
    CompressionType,
    deserialize_array,
    serialize_array,
    wire_roundtrip,
)
from dedloc_tpu_torch.averaging.partition import partition_weighted
from dedloc_tpu_torch.dht.protocol import Endpoint, RPCClient, RPCError, RPCServer
from dedloc_tpu_torch.telemetry import registry as telemetry
from dedloc_tpu_torch.telemetry.links import endpoint_key
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# default chunk: 128Ki fp32 elements = 512 KiB raw per message — small enough
# that several chunks are in flight per span on real models, large enough
# that framing/syscall overhead stays negligible
DEFAULT_CHUNK_SIZE = 131072


class AllreduceFailed(Exception):
    pass


def span_chunks(
    lo: int, hi: int, chunk_size: int
) -> List[Tuple[int, int]]:
    """Absolute [lo, hi) bounds of each chunk of one span. ``chunk_size <= 0``
    means no chunking (one chunk per span — the monolithic wire format).
    Every member derives the identical chunking from the identical spans."""
    if hi <= lo:
        return []
    if chunk_size <= 0:
        return [(lo, hi)]
    return [
        (c, min(c + chunk_size, hi)) for c in range(lo, hi, chunk_size)
    ]


class _ChunkState:
    """One chunk of MY span: eagerly-accumulated weighted sum + the set of
    senders whose copy arrived. ``done`` resolves to the reduced fp32 chunk
    the moment the last expected sender delivers (or the straggler window
    closes); ``wire`` caches the serialized reply so n-1 gatherers cost one
    encode."""

    __slots__ = ("acc", "weight", "arrived", "done", "wire")

    def __init__(self):
        self.acc: Optional[np.ndarray] = None
        self.weight = 0.0
        self.arrived: Set[int] = set()
        self.done: asyncio.Future = (
            asyncio.get_running_loop().create_future()
        )
        self.wire: Optional[bytes] = None


class _RoundState:
    def __init__(self):
        self.chunks: Dict[int, _ChunkState] = {}
        # set by run() on the hosting member; handlers may buffer parts that
        # arrive first, but no chunk finalizes until these exist
        self.expected_senders: Optional[Set[int]] = None
        self.chunk_bounds: Optional[List[Tuple[int, int]]] = None
        self.local_span: Optional[np.ndarray] = None  # my fp32 span slice
        self.span_lo = 0
        self.reduce_s = 0.0  # CPU seconds spent in axpy/scale on this host
        # hierarchical averaging (averaging/topology.py): a clique-level
        # round runs in SUM mode — finalize serves the raw weighted sum
        # (and its total weight) instead of the mean, so the clique's
        # delegate can carry the weight-summed contribution into the WAN
        # round without a divide/re-multiply that would change the math.
        # Set by run() before expected_senders, so no chunk can finalize
        # under the wrong mode.
        self.normalize = True

    def chunk(self, c: int) -> _ChunkState:
        if c not in self.chunks:
            self.chunks[c] = _ChunkState()
        return self.chunks[c]

    @property
    def dataless(self) -> Set[int]:
        """Senders whose zero-weight marker (chunk == -1) covers all chunks."""
        marker = self.chunks.get(-1)
        return marker.arrived if marker is not None else set()

    def accumulate(
        self, c: int, part: np.ndarray, weight: float, own: bool = False,
        norm: Optional[float] = None,
    ) -> None:
        """Fold one sender's copy of chunk ``c`` into the eager accumulator.
        ``own=True`` marks a freshly-deserialized array the state may mutate
        in place; local slices (possibly views of the caller's reused flat
        buffer) are copied first. ``norm`` is the sender's NORMALIZATION
        weight when it differs from its axpy scale: a hierarchical delegate
        delivers its clique's pre-summed vector with ``weight=1`` (the sum
        must not be re-scaled) but ``norm=W_clique`` (the denominator must
        count every clique member it already folded in)."""
        st = self.chunk(c)
        t0 = telemetry.monotonic_clock()
        if st.acc is None:
            if own and part.dtype == np.float32 and part.flags["C_CONTIGUOUS"]:
                st.acc = part
            else:
                st.acc = np.array(part, dtype=np.float32)
            native.scale(st.acc, weight)
        else:
            native.axpy(st.acc, part, weight)
        self.reduce_s += telemetry.monotonic_clock() - t0
        st.weight += weight if norm is None else norm

    def maybe_finalize(self, c: int) -> None:
        """Resolve chunk ``c`` if every expected sender delivered it (data,
        or the round-wide zero-weight marker)."""
        if self.expected_senders is None or c < 0:
            return
        st = self.chunks.get(c)
        if st is None or st.done.done():
            return
        if self.expected_senders <= (st.arrived | self.dataless):
            self.finalize(c)

    def finalize(self, c: int) -> None:
        """Resolve chunk ``c`` with whatever arrived (straggler finalize
        path included). Requires run() to have initialized the round."""
        st = self.chunk(c)
        if st.done.done():
            return
        if not self.normalize:
            # SUM mode (hierarchical clique round): serve the raw weighted
            # sum — an empty accumulator is a legitimate zero sum (an
            # all-aux/all-gated clique), not a fallback to local data
            if st.acc is None:
                lo, hi = self.chunk_bounds[c]
                st.acc = np.zeros(hi - lo, dtype=np.float32)
            st.done.set_result(st.acc)
            return
        if st.weight > 0:
            t0 = telemetry.monotonic_clock()
            reduced = native.scale(st.acc, 1.0 / st.weight)
            self.reduce_s += telemetry.monotonic_clock() - t0
        else:
            # all-aux group: nothing to average; serve my own slice (copied —
            # local_span may view a flat buffer the caller reuses next round,
            # and slow members pull chunks after this round returns)
            lo, hi = self.chunk_bounds[c]
            reduced = np.array(
                self.local_span[lo - self.span_lo : hi - self.span_lo],
                dtype=np.float32,
            )
        st.done.set_result(reduced)

    def maybe_finalize_all(self) -> None:
        if self.expected_senders is None or self.chunk_bounds is None:
            return
        for c in range(len(self.chunk_bounds)):
            self.maybe_finalize(c)

    def finalize_all(self) -> None:
        for c in range(len(self.chunk_bounds)):
            self.finalize(c)

    def missing_senders(self) -> Set[int]:
        """Expected senders that did not deliver every chunk of my span."""
        if self.expected_senders is None or self.chunk_bounds is None:
            return set()
        missing: Set[int] = set()
        covered = self.dataless
        for c in range(len(self.chunk_bounds)):
            st = self.chunks.get(c)
            arrived = st.arrived if st is not None else set()
            missing |= self.expected_senders - (arrived | covered)
        return missing


class GroupAllReduce:
    """Hosts the RPC handlers and runs rounds. One instance per peer process;
    multiple concurrent rounds are keyed by round_id."""

    def __init__(
        self,
        client: RPCClient,
        server: Optional[RPCServer] = None,
        compression: CompressionType = CompressionType.FLOAT16,
        timeout: float = 30.0,
        straggler_timeout: float = 5.0,
        chunk_size: int = DEFAULT_CHUNK_SIZE,  # elements per wire chunk;
        # <= 0 disables chunking (one monolithic message per span)
        telemetry_registry=None,  # per-peer scope (telemetry/registry.py)
    ):
        self.client = client
        self.telemetry = telemetry_registry
        self.compression = compression
        self.timeout = timeout
        self.straggler_timeout = straggler_timeout
        self.chunk_size = int(chunk_size)
        self._rounds: Dict[str, _RoundState] = {}
        if server is not None:
            server.register("avg.part", self._rpc_part)
            server.register("avg.get_reduced", self._rpc_get_reduced)

    def _round(self, round_id: str) -> _RoundState:
        if round_id not in self._rounds:
            self._rounds[round_id] = _RoundState()
            # bound handler-created entries too: without this, parts arriving
            # after run()'s cleanup would accumulate forever
            asyncio.get_running_loop().call_later(
                self.timeout * 2, self._rounds.pop, round_id, None
            )
        return self._rounds[round_id]

    # ------------------------------------------------------------- handlers

    async def _rpc_part(self, peer: Endpoint, args) -> dict:
        """A sender delivers one chunk of MY span (``chunk == -1``: a
        zero-weight marker from an auxiliary peer with no data, covering
        every chunk of the round)."""
        state = self._round(args["round_id"])
        sender = int(args["sender"])
        weight = float(args["weight"])
        # a hierarchical delegate's normalization weight (its clique's
        # summed weight) rides next to its axpy scale; plain senders omit
        # the field and the two coincide
        norm = float(args.get("norm", weight))
        c = int(args.get("chunk", 0))
        data = args.get("data")
        if data is None or c < 0:
            # round-wide marker: this sender contributes nothing, ever
            state.chunk(-1).arrived.add(sender)
            state.maybe_finalize_all()
            return {}
        st = state.chunk(c)
        if sender in st.arrived or sender in state.dataless:
            return {}  # duplicate delivery must not double-accumulate
        if st.done.done():
            # a straggler's part landing AFTER the window finalized this
            # chunk: the finalized mean (scaled in place, possibly already
            # served to gatherers) must never be mutated again — the late
            # sender simply missed this round, per the straggler SLA
            return {}
        part = deserialize_array(data)
        if weight > 0:
            state.accumulate(c, part, weight, own=True, norm=norm)
        st.arrived.add(sender)
        state.maybe_finalize(c)
        return {}

    async def _rpc_get_reduced(self, peer: Endpoint, args) -> dict:
        """A member pulls one reduced chunk of my span (awaits until that
        chunk finishes reducing — the streaming all-gather). The reply
        carries the chunk's accumulated weight: sum-mode gatherers (the
        hierarchical clique round) need the denominator their delegate
        will advertise in the WAN round; mean-mode callers ignore it."""
        state = self._round(args["round_id"])
        st = state.chunk(int(args.get("chunk", 0)))
        data = await asyncio.wait_for(
            asyncio.shield(st.done), timeout=self.timeout
        )
        if st.wire is None:  # encode once, serve n-1 gatherers from cache
            st.wire = serialize_array(data, self.compression, checksum=True)
        return {"data": st.wire, "weight": st.weight}

    # ------------------------------------------------------------------ run

    async def run(
        self,
        round_id: str,
        my_index: int,
        vector: np.ndarray,
        weight: float,
        endpoints: Sequence[Optional[Endpoint]],
        bandwidths: Sequence[float],
        chunk_size: Optional[int] = None,
        norm_weight: Optional[float] = None,
        normalize: bool = True,
    ):
        """Run one round. ``endpoints[i] is None`` marks a client-mode member
        (it hosts nothing); my own endpoint entry is ignored. Returns the
        weighted average vector (same shape as input) in a freshly allocated
        buffer — the result ESCAPES the round (callers hold it across rounds,
        e.g. an overlapped optimizer boundary), so it cannot alias a reused
        scratch buffer.

        ``chunk_size`` overrides this instance's default for ONE round —
        the averager passes the group-negotiated value here, since chunk
        indices only mean the same thing when every member splits the
        identical spans with the identical chunk size.

        Hierarchical (two-level) averaging hooks (averaging/topology.py):

        - ``norm_weight`` decouples this member's NORMALIZATION weight from
          its axpy scale ``weight`` — a clique delegate contributes its
          clique's pre-summed vector with ``weight=1.0`` and
          ``norm_weight=W_clique``, so the WAN mean divides by every
          gradient the sum already carries without re-scaling the sum.
        - ``normalize=False`` runs the round in SUM mode: hosts serve the
          raw weighted sum and the return value becomes the tuple
          ``(summed_vector, total_weight)`` — the contribution a delegate
          carries up. The round FAILS (AllreduceFailed) when chunks
          finalized with different total weights (a straggler was dropped
          from part of the span): a delegate must never advertise a
          denominator its sum does not actually carry.
        """
        n = len(endpoints)
        assert 0 <= my_index < n
        chunk_size = (
            self.chunk_size if chunk_size is None else int(chunk_size)
        )
        can_host = [ep is not None for ep in endpoints]
        if not any(can_host):
            raise AllreduceFailed(f"round {round_id}: no member can host a span")
        spans = partition_weighted(len(vector), list(bandwidths), can_host)
        # every member announces itself to every host — auxiliary peers send a
        # zero-weight marker instead of data, so hosts know not to wait
        senders = set(range(n))

        my_state = None
        lo, hi = spans[my_index]
        hosts_span = hi > lo
        if hosts_span:
            my_state = self._round(round_id)
            my_state.normalize = normalize  # before expected_senders: no
            # chunk may finalize under the wrong mode
            my_state.expected_senders = set(senders)
            my_state.chunk_bounds = span_chunks(lo, hi, chunk_size)
            my_state.span_lo = lo
            my_state.local_span = np.ascontiguousarray(
                vector[lo:hi], dtype=np.float32
            )
            for c in range(len(my_state.chunk_bounds)):
                # pre-create every chunk state: maybe_finalize skips chunks
                # it has never seen, so an all-dataless round whose markers
                # all landed BEFORE run() would otherwise finalize nothing
                # eagerly and idle out the full straggler window
                my_state.chunk(c)
            my_state.maybe_finalize_all()

        tele = telemetry.resolve(self.telemetry)
        span_cm = (
            # trace_seed: every member derives the round's trace id from the
            # shared round_id, so per-peer traces stitch even without an
            # enclosing avg.round span (bare GroupAllReduce harnesses)
            tele.span(
                "allreduce.round", trace_seed=round_id, round_id=round_id,
                group_size=n,
            )
            if tele is not None
            else telemetry.null_span()
        )
        try:
            with span_cm as ctx:
                try:
                    result = await asyncio.wait_for(
                        self._run_inner(
                            round_id, my_index, vector, weight, endpoints,
                            spans, my_state, senders, ctx, chunk_size,
                            norm_weight, normalize,
                        ),
                        timeout=self.timeout,
                    )
                except (
                    asyncio.TimeoutError, ConnectionError, OSError, RPCError,
                    ValueError,
                ) as e:
                    # RPCError covers remote-side failures (a host whose
                    # handler timed out or crashed replies ok=False);
                    # ValueError covers corrupt frames (checksum/shape
                    # mismatch) — a failed round must cost one round, not the
                    # training process
                    if tele is not None:
                        tele.counter("allreduce.failures").inc()
                        ctx["ok"] = False
                        ctx["error"] = type(e).__name__
                    raise AllreduceFailed(f"round {round_id}: {e!r}") from e
                if tele is not None:
                    tele.counter("allreduce.rounds").inc()
                    ctx["ok"] = True
                    ctx["bytes"] = int(vector.nbytes)
                    if my_state is not None:
                        ctx["reduce_s"] = round(my_state.reduce_s, 6)
                return result
        finally:
            # deferred cleanup: slower members may still pull our reduced span
            asyncio.get_running_loop().call_later(
                self.timeout, self._rounds.pop, round_id, None
            )

    async def _run_inner(
        self, round_id, my_index, vector, weight, endpoints, spans, my_state,
        senders, ctx, chunk_size, norm_weight=None, normalize=True,
    ):
        n = len(endpoints)
        norm = weight if norm_weight is None else float(norm_weight)
        # sum-mode bookkeeping: every gathered chunk's total weight — the
        # delegate's denominator, and the uniformity check's evidence
        chunk_weights: List[float] = []
        tele = telemetry.resolve(self.telemetry)
        # per-destination wire accounting for THIS round: folded into the
        # link estimator (telemetry/links.py) per chunk, and emitted as one
        # allreduce.link event per remote host at round end — the per-hop
        # rows the --trace timeline and the --topology matrix are built from
        link_acc: Dict[int, Dict[str, float]] = {}

        def _acc(j: int) -> Dict[str, float]:
            if j not in link_acc:
                link_acc[j] = {
                    "sent_bytes": 0.0, "recv_bytes": 0.0, "chunks_sent": 0.0,
                    "chunks_recv": 0.0, "send_s": 0.0, "wait_s": 0.0,
                    "max_chunk_s": 0.0,
                }
            return link_acc[j]

        out = np.empty(len(vector), np.float32)
        # one chunk-bounds derivation per host, shared by the gather loop,
        # the scatter build and the telemetry count below — these MUST agree
        # (chunk indices are protocol state)
        chunks_by_host = [
            span_chunks(jlo, jhi, chunk_size) if jhi > jlo else []
            for jlo, jhi in spans
        ]

        # the streaming all-gather is launched FIRST: every chunk request
        # parks at its host and completes the moment that chunk reduces, so
        # reduced chunks flow back while later chunks are still being
        # scattered/reduced — this is where the pipeline wins its wall-clock
        gather_start = telemetry.monotonic_clock()

        async def fetch_chunk(j: int, c: int, clo: int, chi: int) -> None:
            t0 = telemetry.monotonic_clock()
            reply = await self.client.call(
                endpoints[j],
                "avg.get_reduced",
                {"round_id": round_id, "chunk": c},
                timeout=self.timeout,
            )
            data = deserialize_array(reply["data"])
            if data.size != chi - clo:
                raise ValueError(
                    f"chunk size mismatch: got {data.size}, want {chi - clo}"
                )
            np.copyto(out[clo:chi], data.reshape(-1), casting="unsafe")
            if not normalize:
                chunk_weights.append(float(reply.get("weight", 0.0)))
            if tele is not None:
                raw = (chi - clo) * 4
                dt = telemetry.monotonic_clock() - t0
                wire = len(reply["data"])
                tele.counter("allreduce.bytes_received").inc(raw)
                tele.counter("allreduce.chunks_received").inc()
                tele.counter("avg.bytes_saved").inc(max(0, raw - wire))
                tele.histogram("allreduce.chunk_latency_s").observe(dt)
                # NOT fed into the LinkTable: this wall includes the host's
                # reduce/straggler park (the request waits for the chunk to
                # finalize), which would blame a stalled SENDER's delay on
                # the innocent host's link — the persistent per-link
                # estimator only eats pure wire timings (the scatter path);
                # the round-scoped wait still lands on the allreduce.link
                # event below, where --trace reads it WITH the straggler
                # events that explain it
                acc = _acc(j)
                acc["recv_bytes"] += wire
                acc["chunks_recv"] += 1
                acc["wait_s"] += dt
                acc["max_chunk_s"] = max(acc["max_chunk_s"], dt)

        async def fetch_own(c: int, clo: int, chi: int) -> None:
            data = await asyncio.shield(my_state.chunk(c).done)
            if not normalize:
                chunk_weights.append(float(my_state.chunk(c).weight))
            if self.compression is not CompressionType.NONE:
                # adopt my own span THROUGH the wire codec: every other
                # member decodes the lossy wire bytes, and synchronous-SGD
                # emulation wants all replicas to apply bit-identical
                # values — a host keeping its fp32 low bits would drift
                # its params from the rest of the group every round
                data = wire_roundtrip(data, self.compression)
            np.copyto(out[clo:chi], data, casting="unsafe")

        gathers = []
        for j in range(n):
            chunks = chunks_by_host[j]
            if not chunks:
                continue
            if j == my_index:
                gathers.extend(
                    fetch_own(c, clo, chi)
                    for c, (clo, chi) in enumerate(chunks)
                )
            else:
                gathers.extend(
                    fetch_chunk(j, c, clo, chi)
                    for c, (clo, chi) in enumerate(chunks)
                )
        gather_task = asyncio.ensure_future(
            asyncio.gather(*gathers)
        )

        try:
            # scatter: send my slice of each host's span, chunk by chunk
            # (zero-weight marker when I have no data, so hosts never wait
            # on an aux peer). Remote sends are interleaved CHUNK-MAJOR —
            # every host's chunk 0 before any host's chunk 1 — so each host
            # can start reducing (and serving) its first chunks while the
            # rest of the scatter is still on the wire; host-major order
            # would starve the last host until the whole span drained.
            per_host: List[List[Tuple[int, int, int, int]]] = []  # (j, c, lo, hi)
            sends = []
            for j in range(n):
                jlo, jhi = spans[j]
                if jhi <= jlo:
                    continue  # client-mode host: nothing to send
                if j == my_index:
                    # self-delivery skips the RPC but NOT the codec: my own
                    # contribution must suffer the identical quantization as
                    # the copies other hosts receive, or (a) my hosted span
                    # would mix full-precision self bits that no other
                    # replica path models, and (b) the optimizer's error
                    # feedback — which assumes EVERY contributed element was
                    # wire-compressed — would re-inject a residual that was
                    # never actually lost for my own span, a same-sign
                    # drift added every round
                    if weight > 0:
                        for c, (clo, chi) in enumerate(my_state.chunk_bounds):
                            part = my_state.local_span[clo - jlo : chi - jlo]
                            lossy = (
                                self.compression is not CompressionType.NONE
                            )
                            if lossy:
                                part = wire_roundtrip(part, self.compression)
                            # the roundtripped array is fresh (never a view
                            # of local_span), so the accumulator may adopt
                            # and scale it in place instead of copying again
                            my_state.accumulate(
                                c, part, weight, own=lossy, norm=norm
                            )
                            my_state.chunk(c).arrived.add(my_index)
                    else:
                        my_state.chunk(-1).arrived.add(my_index)
                    my_state.maybe_finalize_all()
                    continue
                if weight <= 0:
                    sends.append(
                        self.client.call(
                            endpoints[j], "avg.part",
                            {
                                "round_id": round_id, "sender": my_index,
                                "weight": 0.0, "chunk": -1, "data": None,
                            },
                            timeout=self.timeout,
                        )
                    )
                    continue
                per_host.append([
                    (j, c, clo, chi)
                    for c, (clo, chi) in enumerate(chunks_by_host[j])
                ])
            async def send_chunk(j: int, c: int, clo: int, chi: int) -> None:
                # encode INSIDE the send coroutine: each chunk's codec work
                # is followed by a yield into the RPC await, so inbound
                # parts keep reducing and the gather keeps draining between
                # encodes — serializing the whole vector up front would
                # block the loop for the full codec latency and hold every
                # compressed payload in memory at once
                payload = serialize_array(
                    vector[clo:chi], self.compression, checksum=True
                )
                if tele is not None:
                    raw = (chi - clo) * 4
                    # logical tensor bytes moved (pre-compression fp32);
                    # the frame-level wire view lives in net.bytes_*
                    tele.counter("allreduce.bytes_sent").inc(raw)
                    tele.counter("allreduce.chunks_sent").inc()
                    tele.counter("avg.bytes_saved").inc(
                        max(0, raw - len(payload))
                    )
                part_args = {
                    "round_id": round_id, "sender": my_index,
                    "weight": weight, "chunk": c, "data": payload,
                }
                if norm != weight:
                    # hierarchical delegate: axpy scale 1.0, denominator
                    # W_clique — plain senders keep the smaller frame
                    part_args["norm"] = norm
                t0 = telemetry.monotonic_clock()
                await self.client.call(
                    endpoints[j], "avg.part", part_args,
                    timeout=self.timeout,
                )
                if tele is not None:
                    dt = telemetry.monotonic_clock() - t0
                    tele.links().observe_transfer(
                        endpoints[j], len(payload), dt
                    )
                    acc = _acc(j)
                    acc["sent_bytes"] += len(payload)
                    acc["chunks_sent"] += 1
                    acc["send_s"] += dt
                    acc["max_chunk_s"] = max(acc["max_chunk_s"], dt)

            for row in range(max((len(h) for h in per_host), default=0)):
                for host_chunks in per_host:
                    if row >= len(host_chunks):
                        continue
                    j, c, clo, chi = host_chunks[row]
                    sends.append(send_chunk(j, c, clo, chi))
            await asyncio.gather(*sends)

            # straggler window (arguments.py:23-28 semantics): once my own
            # sends are out, give the remaining senders ``straggler_timeout``
            # to deliver my span's chunks, then finalize with what arrived —
            # a missing sender simply doesn't contribute this round
            if my_state is not None:
                pending = [
                    my_state.chunk(c).done
                    for c in range(len(my_state.chunk_bounds))
                ]
                try:
                    if pending:
                        await asyncio.wait_for(
                            asyncio.shield(asyncio.gather(*pending)),
                            timeout=self.straggler_timeout,
                        )
                except asyncio.TimeoutError:
                    missing = my_state.missing_senders()
                    logger.warning(
                        f"{round_id}: proceeding without stragglers "
                        f"{sorted(missing)}"
                    )
                    if tele is not None:
                        tele.counter("allreduce.stragglers").inc(len(missing))
                        tele.event(
                            "allreduce.stragglers", round_id=round_id,
                            missing=sorted(missing),
                        )
                    my_state.finalize_all()

            await gather_task
        except BaseException:
            gather_task.cancel()
            raise
        if ctx is not None and isinstance(ctx, dict):
            ctx["gather_wait_s"] = round(
                telemetry.monotonic_clock() - gather_start, 6
            )
            ctx["chunks"] = sum(len(c) for c in chunks_by_host)
        if tele is not None:
            # one allreduce.link event per remote hop of this round: which
            # link each byte crossed, how long this member waited on it —
            # the rows --trace attributes a stall with, and (with link.stats)
            # the per-link input --topology ranks links by
            for j in sorted(link_acc):
                acc = link_acc[j]
                tele.event(
                    "allreduce.link", round_id=round_id,
                    dst=endpoint_key(endpoints[j]),
                    sent_bytes=int(acc["sent_bytes"]),
                    recv_bytes=int(acc["recv_bytes"]),
                    chunks_sent=int(acc["chunks_sent"]),
                    chunks_recv=int(acc["chunks_recv"]),
                    send_s=round(acc["send_s"], 6),
                    wait_s=round(acc["wait_s"], 6),
                    max_chunk_s=round(acc["max_chunk_s"], 6),
                )
        if not normalize:
            # SUM mode: the vector is only a valid clique contribution if
            # every chunk's sum carries the SAME set of members — a chunk
            # finalized short (straggler dropped mid-span) would make the
            # delegate advertise a denominator its sum does not carry
            if not chunk_weights:
                raise AllreduceFailed(
                    f"round {round_id}: sum mode gathered no chunks"
                )
            w0 = chunk_weights[0]
            if any(abs(w - w0) > 1e-6 * max(1.0, abs(w0))
                   for w in chunk_weights):
                raise AllreduceFailed(
                    f"round {round_id}: non-uniform chunk weights "
                    f"{sorted(set(round(w, 9) for w in chunk_weights))} — "
                    f"a straggler was dropped from part of the span"
                )
            return out, w0
        return out
