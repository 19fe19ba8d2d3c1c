"""The transport seam: what RPCServer/RPCClient actually need from a wire.

``dht/protocol.py`` used to call ``asyncio.start_server`` /
``asyncio.open_connection`` directly, which welded every subsystem above it
(DHT routing, matchmaking, averaging, checkpoint fetching, relay/NAT paths)
to real TCP sockets — and therefore welded every scaling claim to however
many real processes a test box can run. This module names the five-capability
surface the RPC layer really uses:

- **connect** to an endpoint -> a (reader, writer) stream pair
- **accept**: listen on (host, port) and invoke a callback per inbound pair
- **framed send/recv**: ``StreamReader.readexactly`` + ``writer.write/drain``
  (the framing itself — length prefix + msgpack — lives in ``protocol.py``
  and is shared by every transport, so frames are byte-identical on all of
  them BY CONSTRUCTION; ``tests/test_simulator.py`` asserts it anyway with a
  ``RecordingTransport``)
- **close**: writer close / listener close
- **peer endpoint identity**: ``writer.get_extra_info("peername")``

``TcpTransport`` is the production implementation — the exact asyncio calls
``protocol.py`` made before the seam existed, so the real wire path is
unchanged. ``simulator/network.py`` provides the in-process simulated
implementation (latency/bandwidth/loss models on a virtual clock). Anything
above the seam runs unmodified on either.
"""
from __future__ import annotations

import asyncio
from typing import Any, Awaitable, Callable, List, Optional, Tuple

Endpoint = Tuple[str, int]
ConnectionCallback = Callable[
    [asyncio.StreamReader, Any], Awaitable[None]
]


class Listener:
    """A bound, accepting endpoint. ``port`` is the REAL bound port (the
    requested one, or the OS/network-assigned one when 0 was requested)."""

    port: int

    def close(self) -> None:  # pragma: no cover — interface
        raise NotImplementedError

    async def wait_closed(self) -> None:  # pragma: no cover — interface
        raise NotImplementedError


class Transport:
    """Factory for connections and listeners. One instance may serve many
    RPCServer/RPCClient objects (TCP does); simulated transports are
    per-peer so the network knows who is sending (uplink contention,
    peername identity)."""

    async def start_server(
        self, host: str, port: int, on_connection: ConnectionCallback
    ) -> Listener:  # pragma: no cover — interface
        raise NotImplementedError

    async def open_connection(
        self, endpoint: Endpoint, timeout: float
    ) -> Tuple[asyncio.StreamReader, Any]:  # pragma: no cover — interface
        raise NotImplementedError


class _TcpListener(Listener):
    def __init__(self, server: asyncio.AbstractServer):
        self._server = server
        self.port = server.sockets[0].getsockname()[1]

    def close(self) -> None:
        self._server.close()

    async def wait_closed(self) -> None:
        await self._server.wait_closed()


class TcpTransport(Transport):
    """Real asyncio TCP — byte-for-byte the pre-seam behavior."""

    async def start_server(
        self, host: str, port: int, on_connection: ConnectionCallback
    ) -> Listener:
        server = await asyncio.start_server(on_connection, host, port)
        return _TcpListener(server)

    async def open_connection(
        self, endpoint: Endpoint, timeout: float
    ) -> Tuple[asyncio.StreamReader, Any]:
        return await asyncio.wait_for(
            asyncio.open_connection(*endpoint), timeout=timeout
        )


# the process default: production code that never mentions transports keeps
# getting real TCP (one stateless instance is safe to share — it holds no
# connection state; RPCServer/RPCClient own their sockets)
TCP = TcpTransport()


def resolve(transport: Optional[Transport]) -> Transport:
    return transport if transport is not None else TCP


class _RecordingWriter:
    """Write-through proxy that mirrors every byte into a capture list.
    Proxies the handful of writer attributes the RPC layer touches."""

    def __init__(self, inner: Any, sink: List[bytes]):
        self._inner = inner
        self.sent = sink

    def write(self, data: bytes) -> None:
        self.sent.append(bytes(data))
        self._inner.write(data)

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)


class RecordingTransport(Transport):
    """Wrap any transport and capture the exact bytes written on every
    connection it opens or accepts — the framing-parity harness
    (docs/simulator.md): run the same RPC exchange over real TCP and over
    the simulated network and assert the captured frames are identical,
    byte for byte, including the trace-context field and the
    telemetry-disabled framing."""

    def __init__(self, inner: Transport):
        self.inner = inner
        self.client_frames: List[bytes] = []  # bytes written by connectors
        self.server_frames: List[bytes] = []  # bytes written by acceptors

    async def start_server(
        self, host: str, port: int, on_connection: ConnectionCallback
    ) -> Listener:
        async def wrapped(reader, writer):
            await on_connection(
                reader, _RecordingWriter(writer, self.server_frames)
            )

        return await self.inner.start_server(host, port, wrapped)

    async def open_connection(
        self, endpoint: Endpoint, timeout: float
    ) -> Tuple[asyncio.StreamReader, Any]:
        reader, writer = await self.inner.open_connection(endpoint, timeout)
        return reader, _RecordingWriter(writer, self.client_frames)
