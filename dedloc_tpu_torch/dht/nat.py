"""NAT traversal beyond the circuit relay: connection reversal and
hole-punched direct connect (dcutr-style), with the relay as fallback.

Reference capability: p2p/NAT-traversal.md:86-94 — private nodes obtain
punched addresses and call each other DIRECTLY; the coordination rides the
public node. Without this, every private↔private byte rides the relay
(dht/protocol.py RelayService), making relay hosts bandwidth bottlenecks at
volunteer scale. With it, the relay carries only the few hundred bytes of
handshake per peer pair.

Two upgrade paths, tried transparently by ``RPCClient.call`` on first use of
a ``relay:`` virtual endpoint and cached afterwards:

reversal (we are public, target is private)
    One small relayed control message (``nat.reverse_connect``) asks the
    target to dial our real endpoint and park that connection
    (``nat.register``); subsequent calls ride it directly via
    ``RPCServer.call_over``. Registrations are only accepted for peers we
    solicited, and a live registration is never overwritten — a stranger
    cannot claim someone else's route.

punch (both private)
    A relayed rendezvous (``nat.punch``) exchanges each side's
    (host, bound-port); both sides then connect simultaneously from/to
    those ports (TCP simultaneous open — the crossing SYNs are what punch
    real NAT mappings). Because crossing SYNs cannot be timed reliably on
    loopback/datacenter networks, each side also accepts on its punched
    port for the duration of the handshake: the accept stands in for the
    mapping a real NAT would hold open, and the protocol layer (rendezvous,
    simultaneous dial, tie-break, verification, adoption) is identical.
    Double-establishes are tie-broken deterministically (the connection
    initiated by the smaller peer id wins) and the surviving connection is
    verified end-to-end with ``nat.hello`` before adoption.

Failures fall back to the relay and are cached for ``failure_ttl`` so a dead
path does not re-handshake on every call.
"""
from __future__ import annotations

import asyncio
import socket
from typing import Dict, Optional, Tuple

from dedloc_tpu_torch.core import timeutils
from dedloc_tpu_torch.utils.aio import keep_task

from dedloc_tpu_torch.dht.protocol import (
    Endpoint,
    RPCClient,
    RPCServer,
    probe_route_alive,
    relay_endpoint,
)
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _punch_socket(bind_host: str, port: int = 0) -> socket.socket:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    if hasattr(socket, "SO_REUSEPORT"):
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    s.setblocking(False)
    s.bind((bind_host, port))
    return s


class NatTraversal:
    """Attach to an (RPCClient, RPCServer) pair; ``RPCClient.call`` consults
    it before falling back to the circuit relay for ``relay:`` endpoints."""

    def __init__(
        self,
        client: RPCClient,
        server: Optional[RPCServer],
        peer_id: bytes,
        advertised: Optional[Endpoint] = None,
        bind_host: str = "127.0.0.1",
        handshake_timeout: float = 4.0,
        failure_ttl: float = 30.0,
    ):
        self.client = client
        self.server = server
        self.peer_id = peer_id
        self.advertised = advertised  # our real endpoint; None => private
        self.bind_host = bind_host
        self.handshake_timeout = handshake_timeout
        self.failure_ttl = failure_ttl
        # reversal routes: peer_hex -> parked inbound connection writer
        self._routes: Dict[str, asyncio.StreamWriter] = {}
        # reversal registrations we solicited (peer_hex -> solicited-at)
        self._expected: Dict[str, float] = {}
        self._failed: Dict[str, float] = {}
        self._locks: Dict[str, asyncio.Lock] = {}
        self._register_locks: Dict[str, asyncio.Lock] = {}

        if server is not None and server.port is not None:
            # listening (public) side: accept solicited dial-backs
            self._rpc_register.__func__.rpc_wants_writer = True
            server.register("nat.register", self._rpc_register)
        # private side: serve coordination arriving over our parked relay
        # connection (reverse dispatch) — and over adopted punch connections
        client.reverse_handlers["nat.reverse_connect"] = self._rpc_reverse_connect
        client.reverse_handlers["nat.punch"] = self._rpc_punch
        client.reverse_handlers["nat.hello"] = self._rpc_hello
        client.nat = self

    # ------------------------------------------------------------ public API

    def direct_writer(self, peer_hex: str) -> Optional[asyncio.StreamWriter]:
        w = self._routes.get(peer_hex)
        if w is not None and w.is_closing():
            self._routes.pop(peer_hex, None)
            return None
        return w

    def drop_route(self, peer_hex: str) -> None:
        """Evict a reversal route whose connection failed in use (timeout on
        ``call_over``): is_closing() never fires on a half-open TCP path, so
        the caller's failure signal is the only eviction trigger. The next
        call to this peer rides the relay and re-solicits a dial-back."""
        w = self._routes.pop(peer_hex, None)
        if w is not None:
            try:
                w.close()
            except OSError:
                pass

    async def upgrade(
        self, relay: Endpoint, peer_hex: str
    ) -> Optional[str]:
        """Try to obtain a direct path to ``peer_hex`` (registered at
        ``relay``). Returns "writer" when a reversal route is parked on our
        server, "conn" when a punched connection was adopted into the
        client pool under the virtual endpoint, or None (use the relay)."""
        if self.direct_writer(peer_hex) is not None:
            return "writer"
        vep = relay_endpoint(relay, bytes.fromhex(peer_hex))
        if vep in self.client._conns:
            return "conn"
        now = timeutils.monotonic()
        if now - self._failed.get(peer_hex, -1e9) < self.failure_ttl:
            return None
        lock = self._locks.setdefault(peer_hex, asyncio.Lock())
        async with lock:
            if self.direct_writer(peer_hex) is not None:
                return "writer"
            if vep in self.client._conns:
                return "conn"
            try:
                if self.advertised is not None:
                    return await self._reverse(relay, peer_hex)
                return await self._punch_initiate(relay, peer_hex)
            except Exception as e:  # noqa: BLE001 — any failure => relay
                logger.debug(f"nat upgrade to {peer_hex[:12]} failed: {e!r}")
                self._failed[peer_hex] = timeutils.monotonic()
                return None

    # ------------------------------------------------------------- reversal

    async def _reverse(self, relay: Endpoint, peer_hex: str) -> Optional[str]:
        self._expected[peer_hex] = timeutils.monotonic()
        await self.client.call(
            relay,
            "relay.call",
            {
                "to": peer_hex,
                "method": "nat.reverse_connect",
                "args": {
                    "dial": list(self.advertised),
                    "peer_id": self.peer_id.hex(),
                },
                "timeout": self.handshake_timeout,
            },
            timeout=self.handshake_timeout + 2.0,
        )
        # the target dialed us back DURING the call (nat.register completes
        # before reverse_connect returns), so the route is parked now
        if self.direct_writer(peer_hex) is not None:
            logger.info(f"nat: reversal route to {peer_hex[:12]} established")
            return "writer"
        raise ConnectionError("target reported dialing but no route parked")

    async def _rpc_register(self, peer: Endpoint, args, writer) -> dict:
        peer_hex = args["peer_id"]
        solicited_at = self._expected.get(peer_hex)
        if (solicited_at is None
                or timeutils.monotonic() - solicited_at
                > 2 * self.handshake_timeout):
            raise PermissionError(
                f"unsolicited nat registration for {peer_hex[:12]!r}"
            )
        # per-peer REGISTRATION lock (distinct from the upgrade locks:
        # _reverse holds those while awaiting the very dial-back served
        # here, so sharing them would deadlock): the liveness probe below
        # awaits, and two dial-backs from overlapping solicitations must not
        # interleave their check-then-replace (the slower one would clobber
        # the fresh route with an abandoned writer)
        lock = self._register_locks.setdefault(peer_hex, asyncio.Lock())
        async with lock:
            current = self._routes.get(peer_hex)
            if (current is not None and current is not writer
                    and not current.is_closing()):
                # a half-open old route (peer power loss, NAT mapping expiry
                # — no FIN, is_closing() stays False forever) must not block
                # the peer's legitimate re-dial: probe the old path
                # end-to-end and only refuse the newcomer when it still
                # answers (same contract as the relay's check)
                if await probe_route_alive(self.server, current, "nat.hello"):
                    raise PermissionError(
                        f"peer {peer_hex[:12]!r} already has a live route"
                    )
                self.drop_route(peer_hex)
            self._routes[peer_hex] = writer
        return {"registered": True}

    async def _rpc_reverse_connect(self, arrived_on: Endpoint, args) -> dict:
        # dialing back parks OUR pooled connection at the public peer; its
        # calls then arrive on it and dispatch via reverse_handlers
        dial = (args["dial"][0], int(args["dial"][1]))
        reg = {"peer_id": self.peer_id.hex()}
        if dial in self.client._conns:
            # an existing pooled connection to the solicitor may be the
            # dead half of the very path being re-solicited (symmetric
            # half-open death never EOFs) — but it may also be a healthy
            # shared connection (our relay registration, when the solicitor
            # IS our relay), so never evict blindly: try the register over
            # it with a bounded budget, and only on silence evict and dial
            # fresh
            try:
                await self.client.call(
                    dial, "nat.register", reg,
                    timeout=max(1.0, self.handshake_timeout / 2),
                )
                logger.info(
                    f"nat: dialed back to {dial} (connection reversal)"
                )
                return {"dialed": True}
            except (asyncio.TimeoutError, ConnectionError, OSError):
                if dial == arrived_on:
                    # THIS solicitation was just delivered over that very
                    # connection, so the path is alive — merely slow under
                    # load (e.g. queued behind a bulk relay transfer).
                    # Evicting would kill every in-flight RPC on it and
                    # unregister us from our own relay; surface the
                    # timeout instead and let the solicitor retry.
                    raise
                self.client._drop(
                    dial, ConnectionResetError("re-dial solicited")
                )
        await self.client.call(dial, "nat.register", reg)
        logger.info(f"nat: dialed back to {dial} (connection reversal)")
        return {"dialed": True}

    async def _rpc_hello(self, _ep: Endpoint, args) -> dict:
        return {"peer_id": self.peer_id.hex()}

    # ---------------------------------------------------------------- punch

    async def _punch_initiate(
        self, relay: Endpoint, peer_hex: str
    ) -> Optional[str]:
        lsock = _punch_socket(self.bind_host)
        port = lsock.getsockname()[1]
        reply = await self.client.call(
            relay,
            "relay.call",
            {
                "to": peer_hex,
                "method": "nat.punch",
                "args": {
                    "host": self.bind_host,
                    "port": port,
                    "peer_id": self.peer_id.hex(),
                    "relay": list(relay),
                },
                "timeout": self.handshake_timeout,
            },
            timeout=self.handshake_timeout + 2.0,
        )
        # prefer the target's relay-observed (reflexive) host: behind a real
        # NAT the self-reported bind host is an RFC1918 address we could
        # never dial; the bound port rides on the classic port-preserving-
        # NAT assumption of TCP hole punching
        dial_host = reply["host"]
        try:
            observed = await self.client.call(
                relay, "relay.observed", {"to": peer_hex}, timeout=3.0
            )
            if observed.get("host"):
                dial_host = observed["host"]
        except Exception:  # noqa: BLE001 — fall back to self-reported
            pass
        remote = (dial_host, int(reply["port"]))
        vep = relay_endpoint(relay, bytes.fromhex(peer_hex))
        ok = await self._punch_run(lsock, remote, peer_hex, vep)
        if ok:
            return "conn"
        raise ConnectionError("punch failed")

    async def _rpc_punch(self, _ep: Endpoint, args) -> dict:
        their_hex = args["peer_id"]
        relay = (args["relay"][0], int(args["relay"][1]))
        lsock = _punch_socket(self.bind_host)
        port = lsock.getsockname()[1]
        vep = relay_endpoint(relay, bytes.fromhex(their_hex))
        # the relay injects the initiator's reflexive address into the
        # relayed args (RelayService._rpc_call); prefer it over the
        # initiator's self-reported private bind host
        remote = (args.get("observed_host") or args["host"], int(args["port"]))
        # reply first (the initiator needs our port), punch in background
        # (retained + exception-logged: a failed punch must be visible)
        keep_task(
            self._punch_run(lsock, remote, their_hex, vep),
            name="nat punch", log=logger,
        )
        return {"host": self.bind_host, "port": port}

    async def _punch_run(
        self,
        lsock: socket.socket,
        remote: Endpoint,
        their_hex: str,
        vep: Endpoint,
    ) -> bool:
        """Simultaneous dial + accept on the punched port; tie-break, verify
        with nat.hello, adopt into the client pool under ``vep``."""
        loop = asyncio.get_event_loop()
        local = lsock.getsockname()
        deadline = timeutils.monotonic() + self.handshake_timeout
        accepted: Optional[socket.socket] = None
        connected: Optional[socket.socket] = None

        async def _accept():
            nonlocal accepted
            lsock.listen(1)
            while timeutils.monotonic() < deadline and accepted is None:
                try:
                    conn, _ = await asyncio.wait_for(
                        loop.sock_accept(lsock),
                        timeout=max(0.05, deadline - timeutils.monotonic()),
                    )
                    conn.setblocking(False)
                    accepted = conn
                    return
                except asyncio.TimeoutError:
                    return
                except OSError:
                    await asyncio.sleep(0.05)

        async def _dial():
            nonlocal connected
            while timeutils.monotonic() < deadline and connected is None:
                s = _punch_socket(local[0], local[1])
                try:
                    await asyncio.wait_for(
                        loop.sock_connect(s, remote), timeout=0.5
                    )
                    connected = s
                    return
                except (OSError, asyncio.TimeoutError):
                    s.close()
                    await asyncio.sleep(0.08)
                except asyncio.CancelledError:
                    # cancelled mid sock_connect: the in-flight socket is
                    # ours to close — repeated punches on a long-lived peer
                    # must not accumulate leaked FDs
                    s.close()
                    raise

        tasks = [asyncio.ensure_future(_accept()),
                 asyncio.ensure_future(_dial())]
        # wait until SOME path established, then a short grace for the other
        # so both sides can apply the same tie-break
        while (timeutils.monotonic() < deadline and accepted is None
               and connected is None):
            await asyncio.sleep(0.03)
        await asyncio.sleep(0.25)
        for t in tasks:
            t.cancel()
        try:
            my_id = self.peer_id.hex()
            # the connection initiated by the SMALLER peer id wins: that is
            # our dial if we are smaller, else the one we accepted
            prefer_mine = my_id < their_hex
            first = connected if prefer_mine else accepted
            second = accepted if prefer_mine else connected
            for sock_choice, other in ((first, second), (second, first)):
                if sock_choice is None:
                    continue
                if await self._verify_adopt(sock_choice, their_hex, vep):
                    if other is not None:
                        try:
                            other.close()
                        except OSError:
                            pass
                    return True
            return False
        finally:
            lsock.close()

    async def _verify_adopt(
        self, sock: socket.socket, their_hex: str, vep: Endpoint
    ) -> bool:
        try:
            reader, writer = await asyncio.open_connection(sock=sock)
        except OSError:
            sock.close()
            return False
        existing = self.client._conns.get(vep)
        if existing is not None and not existing[1].is_closing():
            writer.close()
            return True  # a concurrent handshake already adopted a conn
        self.client.adopt_connection(vep, reader, writer)
        try:
            hello = await self.client.call(
                vep, "nat.hello", {}, timeout=self.handshake_timeout
            )
            if hello.get("peer_id") != their_hex:
                raise ConnectionError("hello identity mismatch")
            logger.info(
                f"nat: punched direct connection to {their_hex[:12]} "
                f"({vep[0].split(':', 1)[0]} route upgraded)"
            )
            return True
        except Exception:  # noqa: BLE001 — dead/mismatched path
            self.client._drop(vep, ConnectionResetError("punch verify failed"))
            return False
