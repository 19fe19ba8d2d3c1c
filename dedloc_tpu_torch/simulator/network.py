"""In-process simulated network behind the ``dht/transport.py`` seam.

Models, per DIRECTED (src_host, dst_host) link:

- **latency**: fixed one-way delay per delivery (plus seeded jitter)
- **bandwidth**: bytes/second, charged against the SENDER's serialized
  uplink — one transmission at a time per source host, the same
  volunteer-link shape as bench.py's ``LinkSim`` (a 1 MB state blob parks
  the uplink for its full transmission time; everything else queues behind)
- **loss**: per-flush probability that the CONNECTION dies (streams are
  reliable — TCP loss past the retry budget surfaces as a reset, not a
  silently missing frame), drawn from the network's seeded RNG

Composability with ``testing/faults.py``: the RPC-level fault points
(``rpc.client.call``, ``rpc.server.dispatch``) sit ABOVE the seam and fire
unchanged on this transport; additionally every scheduled delivery consults
the ``sim.network.deliver`` fault point (context: ``src``, ``dst``,
``nbytes``) so a schedule can drop or delay one specific directed link —
that is how scenario tests build asymmetric partitions and slow links
without touching peer code.

Everything is scheduled on the current (virtual-time) event loop via
``call_at``; under ``simulator/engine.py`` a 10-second straggler window
costs zero wall time. The classes also work on a REAL event loop (then the
latencies are real waits) — handy for debugging a scenario interactively.
"""
from __future__ import annotations

import asyncio
import inspect
import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from dedloc_tpu_torch.dht.transport import Endpoint, Listener, Transport
from dedloc_tpu_torch.testing import faults
from dedloc_tpu_torch.utils.aio import keep_task
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# minimum spacing between consecutive deliveries on one stream direction:
# larger than any engine tie-break epsilon (~2e-6 max), far below any
# modeled latency
_STREAM_STEP_S = 1e-5

# frames at or below this ride PAST the uplink queue (they still pay their
# own transmit time and latency): a real network packetizes, so a 30-byte
# RPC ack interleaves after at most one MTU of a bulk transfer instead of
# waiting behind megabytes of queued frames. Strict whole-frame FIFO is
# not how TCP behaves across connections, and it would poison every
# RTT/goodput estimate measured over request/ack round trips (the
# telemetry a digital twin is fitted from). Their skipped queue time is
# bandwidth noise by construction (<= one MTU-ish frame).
_SMALL_FRAME_BYTES = 1024


@dataclass
class LinkSpec:
    """One directed link's behavior. ``bandwidth_bps`` is BYTES per second
    (0 or negative = infinite); ``loss`` is the per-flush connection-death
    probability; ``jitter_s`` adds seeded uniform [0, jitter_s) to each
    delivery's latency."""

    latency_s: float = 0.001
    bandwidth_bps: float = 0.0
    loss: float = 0.0
    jitter_s: float = 0.0

    @classmethod
    def from_dict(cls, raw: Optional[dict]) -> "LinkSpec":
        raw = dict(raw or {})
        return cls(
            latency_s=float(raw.get("latency_s", 0.001)),
            bandwidth_bps=float(raw.get("bandwidth_bps", 0.0)),
            loss=float(raw.get("loss", 0.0)),
            jitter_s=float(raw.get("jitter_s", 0.0)),
        )

    @classmethod
    def from_estimate(
        cls,
        rtt_s: Optional[float] = None,
        rtt_jitter_s: Optional[float] = None,
        goodput_bps: Optional[float] = None,
        loss: Optional[float] = None,
        default: Optional["LinkSpec"] = None,
    ) -> "LinkSpec":
        """A link spec from TELEMETRY estimates (telemetry/links.py fields,
        or a fitted TwinModel link) rather than hand-written scenario
        numbers: one-way latency is half the measured RTT and one-way
        jitter half the RTT-deviation EWMA (both inputs are ROUND-TRIP
        measurements), the serialized uplink rate is the measured goodput,
        and any missing estimate falls back to ``default``'s field (an
        unmeasured dimension keeps the fleet-default behavior instead of
        silently becoming ideal)."""
        default = default or cls()
        return cls(
            latency_s=(
                max(1e-6, float(rtt_s) / 2.0)
                if rtt_s is not None else default.latency_s
            ),
            bandwidth_bps=(
                max(1.0, float(goodput_bps))
                if goodput_bps is not None else default.bandwidth_bps
            ),
            loss=(
                min(0.5, max(0.0, float(loss)))
                if loss is not None else default.loss
            ),
            jitter_s=(
                max(0.0, float(rtt_jitter_s) / 2.0)
                if rtt_jitter_s is not None else default.jitter_s
            ),
        )


class SimStreamWriter:
    """Duck-typed ``asyncio.StreamWriter`` for one direction of a simulated
    connection. Implements exactly the surface the RPC layer touches:
    write / drain / close / is_closing / wait_closed / get_extra_info."""

    def __init__(self, conn: "_SimConnection", side: int):
        self._conn = conn
        self._side = side  # 0 = the connecting client, 1 = the acceptor
        self._buffer: List[bytes] = []
        self._closed = False

    def write(self, data: bytes) -> None:
        if self._closed or self._conn.dead:
            return  # writes on a dying socket vanish, like a real half-close
        self._buffer.append(bytes(data))

    async def drain(self) -> None:
        if self._closed or self._conn.dead:
            raise ConnectionResetError("simulated connection lost")
        if not self._buffer:
            return
        payload = b"".join(self._buffer)
        self._buffer.clear()
        self._conn.network._transmit(self._conn, self._side, payload)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._conn.close_from(self._side)

    def is_closing(self) -> bool:
        return self._closed or self._conn.dead

    async def wait_closed(self) -> None:
        return None

    def get_extra_info(self, name: str, default: Any = None) -> Any:
        if name == "peername":
            return self._conn.peername(self._side)
        if name == "sockname":
            return self._conn.sockname(self._side)
        return default  # "socket" -> None: _set_nodelay no-ops


class _SimConnection:
    """A bidirectional stream pair between two simulated hosts."""

    def __init__(
        self,
        network: "SimNetwork",
        client_addr: Endpoint,
        server_addr: Endpoint,
    ):
        self.network = network
        self.addrs = (client_addr, server_addr)
        self.readers = (asyncio.StreamReader(), asyncio.StreamReader())
        self.writers = (SimStreamWriter(self, 0), SimStreamWriter(self, 1))
        # per-direction last-arrival cursor: jitter must never reorder a
        # stream's bytes (TCP delivers in order or not at all)
        self.arrival_cursor = [0.0, 0.0]
        self.dead = False

    def host(self, side: int) -> str:
        return self.addrs[side][0]

    def peername(self, side: int) -> Endpoint:
        return self.addrs[1 - side]

    def sockname(self, side: int) -> Endpoint:
        return self.addrs[side]

    def close_from(self, side: int) -> None:
        """Graceful close by one side: the other side's reader sees EOF
        after the link latency (FIN in flight). Once BOTH sides have
        closed, the connection is forgotten quietly (not a reset) — a
        long sim must not accumulate every connection it ever opened."""
        if self.dead:
            return
        self.network._schedule_eof(self, 1 - side)
        if all(w._closed for w in self.writers):
            self.network._forget(self, reset=False)

    def reset(self) -> None:
        """Connection death (loss, peer kill): both readers fail NOW with
        ConnectionResetError — in-flight deliveries are discarded."""
        if self.dead:
            return
        self.dead = True
        for reader in self.readers:
            if reader.exception() is None and not reader.at_eof():
                reader.set_exception(
                    ConnectionResetError("simulated connection reset")
                )
        self.network._forget(self)


class _SimListener(Listener):
    def __init__(self, network: "SimNetwork", host: str, port: int,
                 on_connection):
        self.network = network
        self.host, self.port = host, port
        self.on_connection = on_connection
        self.closed = False

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self.network._listeners.pop((self.host, self.port), None)

    async def wait_closed(self) -> None:
        return None


class SimNetwork:
    """The one shared network of a simulated swarm: listeners, links, and
    the seeded randomness for loss/jitter. ``stats`` accumulates wire-level
    totals for the sizing report (bytes/frames per directed host pair,
    drops)."""

    def __init__(
        self,
        seed: int = 0,
        default_link: Optional[LinkSpec] = None,
        links: Optional[Dict[Tuple[str, str], LinkSpec]] = None,
    ):
        self.rng = random.Random(seed ^ 0x5EED_0DE)
        self.default_link = default_link or LinkSpec()
        # per-directed-link overrides, e.g. a whole fitted TwinModel link
        # table ({(src_host, dst_host): LinkSpec}); set_link adds more
        self._links: Dict[Tuple[str, str], LinkSpec] = dict(links or {})
        self._listeners: Dict[Endpoint, _SimListener] = {}
        # live connections indexed by BOTH endpoints' hosts: kill_host at
        # 1,000 peers must not scan every connection ever opened
        self._conns_by_host: Dict[str, set] = {}
        self._uplink_busy_until: Dict[str, float] = {}
        self._next_port: Dict[str, int] = {}
        self._next_ephemeral = 30000
        self.stats: Dict[str, Any] = {
            "bytes": {},  # (src, dst) -> payload bytes delivered
            "flushes": {},  # (src, dst) -> flush count
            "resets": 0,
            "loss_drops": 0,
            "fault_drops": 0,
        }

    # ------------------------------------------------------------- topology

    def set_link(self, src_host: str, dst_host: str, spec: LinkSpec) -> None:
        """Configure one DIRECTED link (src -> dst). Unset pairs use the
        network default."""
        self._links[(src_host, dst_host)] = spec

    def link(self, src_host: str, dst_host: str) -> LinkSpec:
        return self._links.get((src_host, dst_host), self.default_link)

    def transport(self, host: str) -> "SimTransport":
        """The per-peer transport bound to ``host`` (the network needs the
        sender's identity for uplink contention and peername)."""
        return SimTransport(self, host)

    # ---------------------------------------------------------- connections

    def listen(self, host: str, port: int, on_connection) -> _SimListener:
        if port == 0:
            port = self._next_port.get(host, 40000)
            self._next_port[host] = port + 1
        key = (host, port)
        if key in self._listeners:
            raise OSError(f"simulated address already in use: {key}")
        listener = _SimListener(self, host, port, on_connection)
        self._listeners[key] = listener
        return listener

    async def connect(
        self, src_host: str, endpoint: Endpoint
    ) -> Tuple[asyncio.StreamReader, SimStreamWriter]:
        endpoint = (endpoint[0], int(endpoint[1]))
        listener = self._listeners.get(endpoint)
        if listener is None or listener.closed:
            raise ConnectionRefusedError(
                f"no simulated listener at {endpoint}"
            )
        spec = self.link(src_host, endpoint[0])
        # connection setup charges the full handshake in virtual time: the
        # SYN leg (src->dst latency) plus the SYN-ACK leg (dst->src) —
        # ``open_connection`` returning before the SYN-ACK would make the
        # RPC client's connect timing (the free RTT probe telemetry/links.py
        # feeds on) read HALF the real round trip, and a simulator model
        # fitted from that telemetry would come out twice as fast as the
        # network it mimics. The accept fires once the handshake wait
        # completes; the first data frame pays the src->dst latency again
        # on delivery.
        reverse = self.link(endpoint[0], src_host)
        await asyncio.sleep(spec.latency_s + reverse.latency_s)
        if listener.closed:  # raced a shutdown during the handshake
            raise ConnectionRefusedError(
                f"simulated listener at {endpoint} closed during connect"
            )
        client_addr = (src_host, self._next_ephemeral)
        self._next_ephemeral += 1
        conn = _SimConnection(self, client_addr, endpoint)
        self._conns_by_host.setdefault(src_host, set()).add(conn)
        self._conns_by_host.setdefault(endpoint[0], set()).add(conn)
        # the acceptor's callback runs as its own task, like
        # asyncio.start_server's protocol factory (retained +
        # exception-logged so a dead acceptor is visible, utils/aio)
        keep_task(
            listener.on_connection(conn.readers[1], conn.writers[1]),
            name="sim acceptor", log=logger,
        )
        return conn.readers[0], conn.writers[0]

    # ------------------------------------------------------------- delivery

    def _transmit(self, conn: _SimConnection, side: int, payload: bytes) -> None:
        # hot path: called once per flushed frame — a large scenario pushes
        # hundreds of thousands through here. get_running_loop (we are
        # always under a coroutine's drain) beats get_event_loop, and the
        # link-override dict is only consulted when overrides exist.
        loop = asyncio.get_running_loop()
        now = loop.time()
        src = conn.addrs[side][0]
        dst = conn.addrs[1 - side][0]
        spec = (
            self._links.get((src, dst), self.default_link)
            if self._links else self.default_link
        )
        # composable fault point: scenario schedules can drop, delay, error
        # or kill one directed link's deliveries without touching peer
        # code. Same action contract as apply_transport_fault: ``drop`` /
        # ``kill`` reset the connection (kill runs its callback first),
        # ``error`` raises an OSError into the SENDER's drain, ``delay``
        # holds the delivery.
        delay_extra = 0.0
        if faults._active is not None:
            fault = faults.fire(
                "sim.network.deliver", src=src, dst=dst, nbytes=len(payload)
            )
            if fault is not None:
                if fault.action == "error":
                    raise OSError(
                        f"fault injected: error delivering {src}->{dst}"
                    )
                if fault.action in ("drop", "kill"):
                    if fault.action == "kill" and fault.callback is not None:
                        result = fault.callback()
                        if inspect.isawaitable(result):
                            keep_task(result, name="kill-fault callback",
                                      log=logger)
                    self.stats["fault_drops"] += 1
                    loop.call_soon(conn.reset)
                    return
                if fault.action == "delay":
                    delay_extra = fault.delay
        if spec.loss > 0.0 and self.rng.random() < spec.loss:
            # reliable stream semantics: loss kills the connection after
            # the latency (the peer sees a reset, not a hole in the stream)
            self.stats["loss_drops"] += 1
            loop.call_at(now + spec.latency_s, conn.reset)
            return
        # serialized uplink: one transmission at a time per source host —
        # except sub-MTU control frames, which interleave (see
        # _SMALL_FRAME_BYTES above) and do not extend the busy window.
        # Uncontended fast path: the busy map is allocated lazily per host
        # (first rate-limited frame), and while NO host has ever contended
        # — the common pure-latency scenario — the math is branch-only.
        nbytes = len(payload)
        small = nbytes <= _SMALL_FRAME_BYTES
        if small:
            start = now
        else:
            prior = (
                self._uplink_busy_until.get(src, 0.0)
                if self._uplink_busy_until else 0.0
            )
            start = prior if prior > now else now
        if spec.bandwidth_bps > 0.0:
            done = start + nbytes / spec.bandwidth_bps
            if not small:
                self._uplink_busy_until[src] = done
        else:
            # infinite rate: the busy window is a point at ``start`` — an
            # entry would never delay anyone, so none is written
            done = start
        arrival = done + spec.latency_s + delay_extra
        if spec.jitter_s > 0.0:
            arrival += self.rng.uniform(0.0, spec.jitter_s)
        # FIFO per direction: jitter may not reorder stream bytes. Strictly
        # increasing (not merely non-decreasing): two same-instant arrivals
        # would each get an INDEPENDENT engine tie-break epsilon on their
        # timers and could fire in either order — a microsecond step keeps
        # the stream sequenced above any epsilon (engine scale: 1e-9).
        arrival = max(arrival, conn.arrival_cursor[side] + _STREAM_STEP_S)
        conn.arrival_cursor[side] = arrival
        key = (src, dst)
        stats = self.stats
        stats["bytes"][key] = stats["bytes"].get(key, 0) + nbytes
        stats["flushes"][key] = stats["flushes"].get(key, 0) + 1
        loop.call_at(arrival, self._deliver, conn, 1 - side, payload)

    def _deliver(self, conn: _SimConnection, to_side: int, payload: bytes) -> None:
        if conn.dead:
            return
        reader = conn.readers[to_side]
        if reader.exception() is None and not reader.at_eof():
            reader.feed_data(payload)

    def _schedule_eof(self, conn: _SimConnection, to_side: int) -> None:
        loop = asyncio.get_event_loop()
        spec = self.link(conn.host(1 - to_side), conn.host(to_side))
        # strictly after the direction's last data delivery: EOF overtaking
        # the final payload would drop it (a graceful close must never read
        # as a truncated stream)
        arrival = max(
            loop.time() + spec.latency_s,
            conn.arrival_cursor[1 - to_side] + _STREAM_STEP_S,
        )
        conn.arrival_cursor[1 - to_side] = arrival
        loop.call_at(arrival, self._feed_eof, conn, to_side)

    def _feed_eof(self, conn: _SimConnection, to_side: int) -> None:
        if conn.dead:
            return
        reader = conn.readers[to_side]
        if reader.exception() is None and not reader.at_eof():
            reader.feed_eof()

    def _forget(self, conn: _SimConnection, reset: bool = True) -> None:
        if reset:
            self.stats["resets"] += 1
        for side in (0, 1):
            bucket = self._conns_by_host.get(conn.host(side))
            if bucket is not None:
                bucket.discard(conn)

    # ---------------------------------------------------------------- churn

    def kill_host(self, host: str) -> int:
        """Process-death semantics for ``host``: every listener vanishes and
        every live connection touching the host resets (a killed peer's OS
        resets its sockets — same contract as the ``drop`` transport fault).
        Returns how many connections were reset."""
        for key in [k for k in self._listeners if k[0] == host]:
            self._listeners[key].close()
        victims = list(self._conns_by_host.get(host, ()))
        for conn in victims:
            conn.reset()
        self._conns_by_host.pop(host, None)
        self._uplink_busy_until.pop(host, None)
        return len(victims)

    def reset_links(self, src_host: str, dst_host: str) -> int:
        """Route-flap semantics for one host PAIR: every live connection
        between the two hosts resets (both directions — a rerouted path
        kills the TCP flows riding it), while both hosts stay alive and
        reconnect lazily. The reconnect matters beyond realism: the link
        RTT estimate samples on CONNECT (dht/protocol.py piggybacked
        ping), so a latency change on a pooled connection is invisible to
        telemetry until the flow re-opens — exactly as in production.
        Returns how many connections were reset."""
        victims = [
            conn for conn in self._conns_by_host.get(src_host, ())
            if dst_host in (conn.host(0), conn.host(1))
        ]
        for conn in victims:
            conn.reset()
        return len(victims)


class SimTransport(Transport):
    """The per-peer face of a SimNetwork behind the ``dht/transport.py``
    seam: same interface as TcpTransport, so RPCServer/RPCClient (and
    everything above them) cannot tell the difference."""

    def __init__(self, network: SimNetwork, host: str):
        self.network = network
        self.host = host

    async def start_server(
        self, host: str, port: int, on_connection
    ) -> Listener:
        # the peer's simulated identity wins over the bind-all host string
        return self.network.listen(self.host, port, on_connection)

    async def open_connection(
        self, endpoint: Endpoint, timeout: float
    ) -> Tuple[asyncio.StreamReader, Any]:
        return await asyncio.wait_for(
            self.network.connect(self.host, endpoint), timeout=timeout
        )
