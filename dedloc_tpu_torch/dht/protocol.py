"""asyncio TCP transport + msgpack RPC framing for the DHT and averager.

This is the in-tree replacement for the reference's transport dependencies
(libp2p daemon + gRPC, SURVEY.md §2.7): length-prefixed msgpack frames over
TCP with a small request/response RPC layer.

Circuit relay (the libp2p relay capability, p2p/circuit-relay.md:15-68): a
peer that cannot listen publicly opens an OUTBOUND connection to a public
peer's ``RelayService`` and registers; the connection then becomes
bidirectional — relayed requests arrive on it as frames with a ``method``
field and are dispatched against the client's ``reverse_handlers``. Anyone
can then reach the private peer at the virtual endpoint
``("relay:<host>:<port>:<peer_hex>", 0)``: ``RPCClient.call`` resolves the
form by preferring a DIRECT path — an adopted hole-punched connection or a
reversal route (dht/nat.py NatTraversal) — and only falls back to wrapping
the call in ``relay.call`` to the public peer, which pipes it down the
registered connection and relays the reply back. At steady state the relay
carries handshakes, not tensor bytes.
"""
from __future__ import annotations

import asyncio
import contextlib
import socket
import struct
import time
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple

from dedloc_tpu_torch.core.serialization import pack_obj, unpack_obj
from dedloc_tpu_torch.dht import transport as transport_mod
from dedloc_tpu_torch.telemetry import registry as telemetry
from dedloc_tpu_torch.testing import faults
from dedloc_tpu_torch.utils.aio import keep_task
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

Endpoint = Tuple[str, int]
MAX_FRAME = 512 * 1024 * 1024  # tensors ride this transport too
_LEN = struct.Struct("!I")


async def read_frame(reader: asyncio.StreamReader) -> Any:
    header = await reader.readexactly(_LEN.size)
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    payload = await reader.readexactly(length)
    if telemetry._active is not None:  # process-wide wire accounting
        telemetry._active.counter("net.bytes_in").inc(_LEN.size + length)
    return unpack_obj(payload)


def write_frame(writer: asyncio.StreamWriter, obj: Any) -> None:
    payload = pack_obj(obj)
    writer.write(_LEN.pack(len(payload)))
    writer.write(payload)
    if telemetry._active is not None:  # process-wide wire accounting
        telemetry._active.counter("net.bytes_out").inc(
            _LEN.size + len(payload)
        )


def _expire_response(fut: "asyncio.Future") -> None:
    """Deadline callback for an in-flight RPC's response future."""
    if not fut.done():
        fut.set_exception(asyncio.TimeoutError("rpc response timed out"))


Handler = Callable[[Endpoint, Dict[str, Any]], Awaitable[Any]]


def trace_field(tele) -> Optional[list]:
    """The compact trace context a request frame carries: ``[trace_id,
    parent_span_id, caller_peer]``, or None when it must carry NOTHING.

    None — and therefore zero extra bytes on the wire framing — whenever
    telemetry is disabled (``tele is None``) or no trace is live on this
    task. The receiving ``_dispatch`` adopts the context around the handler
    so server-side spans record their remote parent; a peer with telemetry
    off simply ignores the field."""
    if tele is None:
        return None
    tc = telemetry.current_trace()
    if tc is None:
        return None
    return [tc[0], tc[1], tele.peer]


# shared no-op: nullcontext is stateless and re-entrant, so the disabled
# path allocates nothing per dispatch
_NULL_CM = contextlib.nullcontext()


def _adopt_cm(tele, msg):
    """Context manager adopting a request frame's trace context (no-op when
    telemetry is off or the frame carries none)."""
    tc = msg.get("tc")
    if tele is None or tc is None:
        return _NULL_CM
    return telemetry.adopt_trace(tc)


def _set_nodelay(writer: asyncio.StreamWriter) -> None:
    """Disable Nagle on an RPC connection. The averaging wire path streams
    many mid-sized chunk frames in a request/reply pattern; with Nagle on,
    each frame can sit in the kernel waiting for the previous frame's ACK
    (up to a delayed-ACK period), which serializes the pipelined all-reduce
    on exactly the latency it exists to hide."""
    sock = writer.get_extra_info("socket")
    if sock is not None:
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:  # pragma: no cover — non-TCP transports
            pass


def relay_endpoint(relay: Endpoint, peer_id: bytes) -> Endpoint:
    """Virtual endpoint for a peer reachable only via ``relay``."""
    return (f"relay:{relay[0]}:{relay[1]}:{peer_id.hex()}", 0)


def parse_relay_endpoint(endpoint) -> Optional[Tuple[Endpoint, str]]:
    """((relay_host, relay_port), peer_hex) if ``endpoint`` is relayed."""
    host = endpoint[0]
    if not (isinstance(host, str) and host.startswith("relay:")):
        return None
    _, rh, rp, peer_hex = host.split(":", 3)
    return (rh, int(rp)), peer_hex


class RPCServer:
    """Serves named RPC methods; one task per connection, many requests per
    connection (pipelined)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0,
                 telemetry_registry=None, transport=None):
        self.host, self.requested_port = host, port
        # per-peer scope for in-process multi-peer tests; None falls back to
        # the process-global registry (production: one peer per process)
        self.telemetry = telemetry_registry
        # the transport seam (dht/transport.py): None = real asyncio TCP,
        # exactly the pre-seam wire; the simulator injects its in-process
        # network here and everything above this line runs unmodified
        self.transport = transport_mod.resolve(transport)
        self._handlers: Dict[str, Handler] = {}
        self._server: Optional[transport_mod.Listener] = None
        self._writers: set = set()
        self.port: Optional[int] = None
        # server-initiated calls piped DOWN an inbound connection (circuit
        # relay forwarding, NAT reverse-connection routes): reply frames (no
        # "method") are matched by id and VALIDATED against the writer the
        # request went down — a reply arriving on any other connection
        # (i.e. from a different peer) is discarded, so a stranger cannot
        # forge results into someone else's call
        self._pending_calls: Dict[
            int, Tuple[asyncio.Future, asyncio.StreamWriter]
        ] = {}
        self._next_call_id = 0

    def register(self, method: str, handler: Handler) -> None:
        self._handlers[method] = handler

    async def call_over(
        self,
        writer: asyncio.StreamWriter,
        method: str,
        args: Optional[Dict[str, Any]] = None,
        timeout: float = 60.0,
    ) -> Any:
        """Invoke a method on the peer at the OTHER end of an inbound
        connection (the peer serves it via ``RPCClient.reverse_handlers``).
        This is how otherwise-unreachable peers are called back over the
        connections they parked with us."""
        self._next_call_id += 1
        rid = self._next_call_id
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._pending_calls[rid] = (fut, writer)
        request = {"id": rid, "method": method, "args": args or {}}
        # trace propagation survives the relay: the relay's _rpc_call runs
        # inside the ORIGINAL caller's adopted context, so the piped frame
        # re-carries it (absent — zero bytes — when telemetry is off)
        tc = trace_field(telemetry.resolve(self.telemetry))
        if tc is not None:
            request["tc"] = tc
        try:
            write_frame(writer, request)
            await writer.drain()
            reply = await asyncio.wait_for(fut, timeout=timeout)
        finally:
            self._pending_calls.pop(rid, None)
        if not reply.get("ok"):
            raise RPCError(reply.get("error", "unknown remote error"))
        return reply.get("result")

    def _route_reply(self, msg, writer) -> None:
        entry = self._pending_calls.get(msg.get("id"))
        if entry is None:
            return
        fut, expected_writer = entry
        if writer is not expected_writer:
            logger.warning(
                "discarding reply arriving on the wrong connection"
            )
            return
        self._pending_calls.pop(msg.get("id"), None)
        if not fut.done():
            fut.set_result(msg)

    async def start(self) -> None:
        self._server = await self.transport.start_server(
            self.host, self.requested_port, self._on_connection
        )
        self.port = self._server.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # force-close live connections: in py3.12 wait_closed() waits for
            # all handlers, which would otherwise hang on idle peers
            for writer in list(self._writers):
                writer.close()
            await self._server.wait_closed()

    async def _on_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        peer = writer.get_extra_info("peername") or ("?", 0)
        _set_nodelay(writer)
        self._writers.add(writer)
        try:
            while True:
                try:
                    msg = await read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError, OSError):
                    return
                if msg.get("method") is None:
                    # reply to a call_over we piped down this connection
                    self._route_reply(msg, writer)
                    continue
                handler = self._handlers.get(msg.get("method"))
                if (
                    handler is not None
                    and getattr(handler, "rpc_inline", False)
                    and faults._active is None
                ):
                    # non-blocking handlers (marked ``rpc_inline``: they
                    # never await I/O) run inline — task-per-request costs
                    # a Task allocation and two context switches per RPC,
                    # which dominates a lookup-heavy simulation. With a
                    # fault schedule installed every request takes the
                    # task path so ``delay`` faults cannot head-of-line
                    # block an entire connection.
                    await self._dispatch(peer, msg, writer)
                    continue
                # retained + exception-logged (utils/aio): a handler
                # task dying silently would swallow the request forever
                keep_task(self._dispatch(peer, msg, writer),
                          name="rpc dispatch", log=logger)
        finally:
            self._writers.discard(writer)
            writer.close()

    async def _dispatch(self, peer, msg, writer) -> None:
        req_id = msg.get("id")
        method = msg.get("method")
        tele = telemetry.resolve(self.telemetry)
        if tele is not None:
            tele.counter("rpc.server.requests").inc()
        if faults._active is not None:  # fault injection (testing/faults.py)
            fault = faults.fire(
                "rpc.server.dispatch", method=method, peer=peer, server=self,
                port=self.port,
            )
            if fault is not None:
                if tele is not None:
                    # attribute the APPLIED fault to this peer's registry
                    # (faults.fire also logs a process-global trace event)
                    tele.counter("faults.applied").inc()
                    tele.event(
                        "fault.applied", point="rpc.server.dispatch",
                        action=fault.action, method=method,
                    )
                try:
                    await faults.apply_transport_fault(fault, f"rpc {method}")
                except (ConnectionResetError, OSError):
                    # process-death semantics: reset the connection, no reply
                    writer.close()
                    return
        handler = self._handlers.get(method)
        try:
            if handler is None:
                raise KeyError(f"unknown method {method!r}")
            # adopt the caller's trace context (frame field "tc") around the
            # handler: spans opened inside record their REMOTE parent, which
            # is what lets the coordinator stitch per-peer event logs into
            # one causal cross-peer round trace
            with _adopt_cm(tele, msg):
                if getattr(handler, "rpc_wants_writer", False):
                    result = await handler(
                        tuple(peer[:2]), msg.get("args") or {}, writer
                    )
                else:
                    result = await handler(
                        tuple(peer[:2]), msg.get("args") or {}
                    )
            reply = {"id": req_id, "ok": True, "result": result}
        except Exception as e:  # noqa: BLE001 — RPC boundary
            logger.debug(f"rpc {method} failed: {e!r}")
            if tele is not None:
                tele.counter("rpc.server.errors").inc()
            reply = {"id": req_id, "ok": False, "error": repr(e)}
        try:
            write_frame(writer, reply)
            await writer.drain()
        except (OSError, RuntimeError):
            # best-effort reply: any transport-level failure (reset, broken
            # pipe, a simulated-link 'error' fault from drain) means the
            # caller is unreachable — drop the reply, never kill the task
            pass


class RPCClient:
    """Pooled msgpack-RPC client: one persistent connection per endpoint."""

    def __init__(self, request_timeout: float = 5.0, telemetry_registry=None,
                 transport=None):
        self.request_timeout = request_timeout
        # per-peer scope for in-process multi-peer tests; None falls back to
        # the process-global registry (production: one peer per process)
        self.telemetry = telemetry_registry
        # the transport seam (dht/transport.py): None = real asyncio TCP
        self.transport = transport_mod.resolve(transport)
        self._conns: Dict[Endpoint, Tuple[asyncio.StreamReader, asyncio.StreamWriter]] = {}
        self._pending: Dict[Endpoint, Dict[int, asyncio.Future]] = {}
        self._readers: Dict[Endpoint, asyncio.Task] = {}
        self._next_id = 0
        self._conn_locks: Dict[Endpoint, asyncio.Lock] = {}
        # circuit relay: requests relayed to THIS (otherwise unreachable)
        # peer arrive on its outbound relay connection and dispatch here —
        # point this at an RPCServer's handler dict to expose its methods
        self.reverse_handlers: Dict[str, Handler] = {}
        # NAT traversal policy (dht/nat.py NatTraversal attaches itself):
        # consulted before falling back to the relay for relay: endpoints
        self.nat = None

    async def _connect(self, endpoint: Endpoint):
        # fast path first: a pooled connection needs no lock (entries are
        # installed fully-formed), and ``setdefault`` with an eagerly-built
        # Lock() would allocate one per CALL, not one per endpoint
        conn = self._conns.get(endpoint)
        if conn is not None:
            return conn
        lock = self._conn_locks.get(endpoint)
        if lock is None:
            lock = self._conn_locks.setdefault(endpoint, asyncio.Lock())
        async with lock:
            if endpoint in self._conns:
                return self._conns[endpoint]
            # the LOOP's clock, not perf_counter: under the simulator
            # engine loop.time() IS the virtual clock, so the sampled RTT
            # reflects the MODELED link latency exactly — with none of the
            # event-loop scheduling churn a real-clock read would add on a
            # busy loop (noise that a twin fitted from this estimate would
            # then pay a second time on replay). In production loop.time()
            # is the ordinary monotonic clock.
            loop = asyncio.get_event_loop()
            t0 = loop.time()
            reader, writer = await self.transport.open_connection(
                endpoint, timeout=self.request_timeout
            )
            tele = telemetry.resolve(self.telemetry)
            if tele is not None:
                # the TCP handshake is a free SYN/SYN-ACK round trip: the
                # per-link RTT estimate's "piggybacked ping" (one sample per
                # pooled connection, zero traffic added to the hot path)
                tele.links().observe_rtt(
                    endpoint, max(0.0, loop.time() - t0)
                )
            _set_nodelay(writer)
            self._conns[endpoint] = (reader, writer)
            self._pending[endpoint] = {}
            self._readers[endpoint] = asyncio.ensure_future(
                self._read_loop(endpoint, reader)
            )
            return reader, writer

    async def _read_loop(self, endpoint: Endpoint, reader: asyncio.StreamReader):
        try:
            while True:
                msg = await read_frame(reader)
                if msg.get("method") is not None:
                    # relayed request piped to us down our own outbound
                    # connection (circuit relay): serve it and reply in-band
                    keep_task(self._dispatch_reverse(endpoint, msg),
                              name="reverse dispatch", log=logger)
                    continue
                fut = self._pending.get(endpoint, {}).pop(msg.get("id"), None)
                if fut is not None and not fut.done():
                    fut.set_result(msg)
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError):
            pass
        finally:
            self._drop(endpoint, ConnectionResetError("connection lost"))

    async def _dispatch_reverse(self, endpoint: Endpoint, msg) -> None:
        handler = self.reverse_handlers.get(msg.get("method"))
        try:
            if handler is None:
                raise KeyError(f"unknown relayed method {msg.get('method')!r}")
            with _adopt_cm(telemetry.resolve(self.telemetry), msg):
                result = await handler(endpoint, msg.get("args") or {})
            reply = {"id": msg.get("id"), "ok": True, "result": result}
        except Exception as e:  # noqa: BLE001 — RPC boundary
            logger.debug(f"relayed rpc {msg.get('method')} failed: {e!r}")
            reply = {"id": msg.get("id"), "ok": False, "error": repr(e)}
        conn = self._conns.get(endpoint)
        if conn is None:
            return
        try:
            write_frame(conn[1], reply)
            await conn[1].drain()
        except (OSError, RuntimeError):
            # best-effort reply: any transport-level failure (reset, broken
            # pipe, a simulated-link 'error' fault from drain) means the
            # caller is unreachable — drop the reply, never kill the task
            pass

    async def register_with_relay(
        self, relay: Endpoint, peer_id: bytes
    ) -> Endpoint:
        """Park this client's connection at a public peer's RelayService and
        return the virtual endpoint others can reach us at. The pooled
        connection stays open; ``reverse_handlers`` serve what arrives."""

        async def _probe(_peer, _args):
            # answered over the parked connection: proves to the relay that
            # this registration's path is still alive when a newcomer tries
            # to (re-)register the same peer id
            return {"alive": True}

        self.reverse_handlers.setdefault("relay.probe", _probe)
        await self.call(relay, "relay.register", {"peer_id": peer_id.hex()})
        return relay_endpoint(relay, peer_id)

    def adopt_connection(
        self,
        endpoint: Endpoint,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
    ) -> None:
        """Install an externally-established connection (NAT punch) into the
        pool under ``endpoint`` — calls to that endpoint then ride it like
        any dialed connection, and inbound requests on it dispatch via
        ``reverse_handlers``."""
        self._conns[endpoint] = (reader, writer)
        self._pending[endpoint] = {}
        self._readers[endpoint] = asyncio.ensure_future(
            self._read_loop(endpoint, reader)
        )

    def _drop(self, endpoint: Endpoint, exc: Exception) -> None:
        conn = self._conns.pop(endpoint, None)
        if conn is not None:
            conn[1].close()
            tele = telemetry.resolve(self.telemetry)
            if tele is not None:
                tele.counter("rpc.conns_lost").inc()
                tele.event(
                    "rpc.conn_lost", endpoint=endpoint,
                    error=type(exc).__name__,
                )
        task = self._readers.pop(endpoint, None)
        if task is not None:
            task.cancel()
        for fut in self._pending.pop(endpoint, {}).values():
            if not fut.done():
                fut.set_exception(exc)

    async def call(
        self,
        endpoint: Endpoint,
        method: str,
        args: Optional[Dict[str, Any]] = None,
        timeout: Optional[float] = None,
    ) -> Any:
        """Invoke a remote method; raises on transport error / remote error.

        A ``relay:`` endpoint is resolved in preference order: an adopted
        direct connection (NAT punch), a NAT upgrade attempt (connection
        reversal / hole punch, dht/nat.py), and finally a ``relay.call``
        wrapped to the public peer hosting the registration (circuit
        relay)."""
        tele = telemetry.resolve(self.telemetry)
        if faults._active is not None:  # fault injection (testing/faults.py)
            fault = faults.fire(
                "rpc.client.call", method=method, endpoint=endpoint,
                client=self,
            )
            if fault is not None:
                if tele is not None:
                    tele.counter("faults.applied").inc()
                    tele.event(
                        "fault.applied", point="rpc.client.call",
                        action=fault.action, method=method,
                        endpoint=endpoint,
                    )
                try:
                    await faults.apply_transport_fault(fault, f"rpc {method}")
                except Exception:
                    if tele is not None:
                        tele.counter("rpc.client.calls").inc()
                        tele.counter("rpc.client.failures").inc()
                    raise
        relayed = parse_relay_endpoint(endpoint)
        if relayed is not None:
            relay, peer_hex = relayed
            vep = (endpoint[0], int(endpoint[1]))
            route = None
            if vep in self._conns:
                route = "conn"  # adopted punched connection: direct path
            elif self.nat is not None and method not in _NAT_CONTROL:
                route = await self.nat.upgrade(relay, peer_hex)
                if route == "writer":
                    writer = self.nat.direct_writer(peer_hex)
                    if writer is not None and self.nat.server is not None:
                        # reversal route: the target dialed us back; call it
                        # over the parked inbound connection. Counted like
                        # the dialed leaf below — a half-open reversal route
                        # timing out must show up in rpc.client.failures or
                        # the swarm-health view misses the stalling peer.
                        if tele is not None:
                            tele.counter("rpc.client.calls").inc()
                        try:
                            return await self.nat.server.call_over(
                                writer, method, args or {},
                                timeout=timeout or self.request_timeout,
                            )
                        except RPCError:
                            if tele is not None:
                                tele.counter("rpc.client.remote_errors").inc()
                            raise  # remote answered — the route is alive
                        except asyncio.TimeoutError:
                            # half-open reversal route (NAT mapping expiry,
                            # silent TCP death — is_closing() never fires):
                            # evict it so the NEXT call rides the relay and
                            # re-solicits a dial-back. The timeout budget is
                            # already spent, so retrying inline would make a
                            # timeout=T call take ~2T — callers' straggler
                            # deadlines must stay honest.
                            if tele is not None:
                                tele.counter("rpc.client.failures").inc()
                                tele.event(
                                    "rpc.client.failure", method=method,
                                    endpoint=endpoint, error="TimeoutError",
                                    route="reversal",
                                )
                            self.nat.drop_route(peer_hex)
                            raise
                        except (ConnectionError, OSError) as e:
                            # instant transport failure (no budget burned):
                            # evict and fall back to the relay inline
                            if tele is not None:
                                tele.counter("rpc.client.failures").inc()
                                tele.event(
                                    "rpc.client.failure", method=method,
                                    endpoint=endpoint,
                                    error=type(e).__name__, route="reversal",
                                )
                            self.nat.drop_route(peer_hex)
                            route = None
                    else:
                        route = None
            if route != "conn":
                inner_timeout = timeout or self.request_timeout
                return await self.call(
                    relay,
                    "relay.call",
                    {
                        "to": peer_hex,
                        "method": method,
                        "args": args or {},
                        "timeout": inner_timeout,
                    },
                    timeout=inner_timeout + 5.0,
                )
        endpoint = (endpoint[0], int(endpoint[1]))
        # counted at the LEAF (after relay/NAT resolution): one count per
        # wire RPC, never double-counted through the relay recursion
        if tele is not None:
            tele.counter("rpc.client.calls").inc()
        try:
            _, writer = await self._connect(endpoint)
            self._next_id += 1
            req_id = self._next_id
            fut: asyncio.Future = asyncio.get_event_loop().create_future()
            self._pending[endpoint][req_id] = fut
        except (asyncio.TimeoutError, ConnectionError, OSError) as e:
            if tele is not None:
                tele.counter("rpc.client.failures").inc()
                tele.event(
                    "rpc.client.failure", method=method, endpoint=endpoint,
                    error=type(e).__name__,
                )
            raise
        request = {"id": req_id, "method": method, "args": args or {}}
        # cross-peer trace context: [trace_id, parent_span_id, caller peer]
        # — attached ONLY when telemetry is enabled AND a span is live on
        # this task, so disabled telemetry adds zero bytes to the framing
        tc = trace_field(tele)
        if tc is not None:
            request["tc"] = tc
        write_frame(writer, request)
        # hand-rolled deadline instead of asyncio.wait_for: the response
        # future is a bare Future (no task wrapping needed), so the whole
        # timeout is one timer that fails the future — wait_for's
        # ensure_future / release-waiter / cancellation-shield machinery
        # is pure overhead on this, and this is the hottest await in a
        # large simulation
        deadline = asyncio.get_event_loop().call_later(
            timeout or self.request_timeout, _expire_response, fut
        )
        try:
            await writer.drain()
            reply = await fut
        except (asyncio.TimeoutError, ConnectionError, OSError) as e:
            self._pending.get(endpoint, {}).pop(req_id, None)
            if tele is not None:
                tele.counter("rpc.client.failures").inc()
                tele.event(
                    "rpc.client.failure", method=method, endpoint=endpoint,
                    error=type(e).__name__,
                )
            raise
        finally:
            deadline.cancel()
        if not reply.get("ok"):
            if tele is not None:
                # the transport worked; the remote handler refused/crashed
                tele.counter("rpc.client.remote_errors").inc()
            raise RPCError(reply.get("error", "unknown remote error"))
        return reply.get("result")

    async def close(self) -> None:
        for endpoint in list(self._conns):
            self._drop(endpoint, ConnectionResetError("client closed"))


class RPCError(Exception):
    pass


async def probe_route_alive(
    server: RPCServer,
    writer: asyncio.StreamWriter,
    method: str,
    timeout: float = 2.0,
) -> bool:
    """End-to-end liveness probe of a parked inbound connection. A half-open
    TCP path (peer power loss, NAT mapping expiry with no FIN — is_closing()
    stays False forever) only reveals itself by not answering; True means
    the peer at the other end actually replied. Shared by the relay's and
    the NAT layer's re-registration checks so their hijack-protection
    semantics cannot drift apart."""
    try:
        await server.call_over(writer, method, {}, timeout=timeout)
        return True
    except Exception:  # noqa: BLE001 — no answer == dead path
        return False


# NAT-coordination methods must not themselves trigger an upgrade attempt
# (dht/nat.py defines them; duplicated here to avoid a circular import)
_NAT_CONTROL = frozenset(
    {"nat.reverse_connect", "nat.register", "nat.punch", "nat.hello"}
)


class RelayService:
    """Attachable circuit-relay for a public RPCServer
    (p2p/circuit-relay.md:15-68 capability: ``relay_enabled`` public node).

    Private peers park an outbound connection via ``relay.register``;
    ``relay.call`` pipes a request down that connection and relays the reply
    back. The relay is transport-only: it never inspects payloads and takes
    no part in the rounds it carries.
    """

    def __init__(self, server: RPCServer, call_timeout: float = 60.0):
        self.server = server
        self.call_timeout = call_timeout
        self._registered: Dict[str, asyncio.StreamWriter] = {}
        # observability + test hook: recent methods piped through this relay
        # (bounded — a long-lived relay must not grow without limit)
        from collections import deque

        self.piped_methods: "deque[str]" = deque(maxlen=512)
        self._rpc_register.__func__.rpc_wants_writer = True
        server.register("relay.register", self._rpc_register)
        server.register("relay.call", self._rpc_call)
        server.register("relay.ping", self._rpc_ping)
        server.register("relay.observed", self._rpc_observed)

    async def _rpc_register(self, peer: Endpoint, args, writer) -> dict:
        peer_id = args["peer_id"]
        current = self._registered.get(peer_id)
        if (current is not None and current is not writer
                and not current.is_closing()):
            # Never silently overwrite a registration whose connection still
            # ANSWERS: otherwise any host that can reach the relay could
            # hijack another peer's virtual endpoint and receive its
            # matchmaking/allreduce traffic. A half-open old connection must
            # not block the legitimate re-registration the keepalive
            # performs, so the OLD path is probed: alive => the newcomer is
            # refused; dead/unresponsive => replaced.
            if await probe_route_alive(self.server, current, "relay.probe"):
                raise PermissionError(
                    f"peer {peer_id!r} already has a live registration"
                )
        self._registered[peer_id] = writer
        return {"registered": True}

    async def _rpc_observed(self, peer: Endpoint, args) -> dict:
        """Reflexive-address observation (the STUN-ish primitive real NAT
        traversal needs): the address the relay sees for a registrant."""
        writer = self._registered.get(args["to"])
        if writer is None or writer.is_closing():
            raise KeyError(f"no relayed peer {args['to']!r} registered here")
        peername = writer.get_extra_info("peername") or (None, None)
        return {"host": peername[0], "port": peername[1]}

    async def _rpc_ping(self, peer: Endpoint, args) -> dict:
        """Cheap liveness probe: registrants call this periodically over
        their parked connection — a half-open TCP connection (relay power
        loss, NAT mapping expiry with no FIN) times out here, and the
        registrant reconnects + re-registers."""
        return {"pong": True}

    async def _rpc_call(self, peer: Endpoint, args) -> Any:
        writer = self._registered.get(args["to"])
        if writer is None or writer.is_closing():
            self._registered.pop(args["to"], None)
            raise KeyError(f"no relayed peer {args['to']!r} registered here")
        self.piped_methods.append(args["method"])
        call_args = args.get("args") or {}
        if args["method"] == "nat.punch":
            # inject the caller's relay-observed (reflexive) address: behind
            # a real NAT the self-reported bind host is an RFC1918 address
            # the target could never dial
            call_args = dict(call_args, observed_host=peer[0])
        return await self.server.call_over(
            writer,
            args["method"],
            call_args,
            timeout=float(args.get("timeout") or self.call_timeout),
        )
