"""Synchronous DHT facade: background event loop + future-based API.

Mirrors the hivemind.DHT surface the reference consumes (SURVEY.md §2.6):
``DHT(start=True, initial_peers=..., record_validators=...)``,
``dht.store(key, value, expiration_time, subkey=..., return_future=...)``,
``dht.get(key, latest=True)``, ``dht.port``, ``dht.shutdown()``.

The reference runs its DHT in a forked *process*; here a daemon *thread*
suffices — the node is pure asyncio IO which releases the GIL, and the
trainer's hot loop is on the TPU anyway.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

from dedloc_tpu_torch.core.serialization import pack_obj, unpack_obj
from dedloc_tpu_torch.core.timeutils import DHTExpiration, ValueWithExpiration
from dedloc_tpu_torch.dht.node import DHTNode
from dedloc_tpu_torch.dht.protocol import Endpoint
from dedloc_tpu_torch.dht.storage import DictionaryDHTValue
from dedloc_tpu_torch.dht.validation import RecordValidatorBase
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

DHTKey = Union[str, bytes]


def _to_bytes(key: DHTKey) -> bytes:
    return key.encode() if isinstance(key, str) else key


def _parse_endpoint(ep: Union[str, Endpoint]) -> Endpoint:
    if isinstance(ep, str):
        host, _, port = ep.rpartition(":")
        return (host or "127.0.0.1", int(port))
    return (ep[0], int(ep[1]))


class DHT:
    """Thread-backed DHT peer with a blocking/future API."""

    def __init__(
        self,
        initial_peers: Sequence[Union[str, Endpoint]] = (),
        start: bool = False,
        listen_host: str = "0.0.0.0",
        listen_port: int = 0,
        client_mode: bool = False,
        record_validators: Sequence[RecordValidatorBase] = (),
        advertised_host: Optional[str] = None,
        num_replicas: int = 5,
        daemon: bool = True,
        maintenance_interval: float = 30.0,  # 0 disables self-maintenance
    ):
        self._initial_peers = [_parse_endpoint(p) for p in initial_peers]
        self._listen = (listen_host, listen_port)
        self._client_mode = client_mode
        self._validators = list(record_validators)
        self._advertised_host = advertised_host
        self._num_replicas = num_replicas
        self._maintenance_interval = maintenance_interval
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._node: Optional[DHTNode] = None
        self._thread = threading.Thread(
            target=self._run_loop, daemon=daemon, name="dedloc-dht"
        )
        self._ready = threading.Event()
        self._startup_error: Optional[BaseException] = None
        self._shut_down = False
        if start:
            self.run_in_background()

    # ------------------------------------------------------------ lifecycle

    def run_in_background(self, await_ready: bool = True, timeout: float = 15.0):
        self._thread.start()
        if await_ready:
            if not self._ready.wait(timeout):
                raise TimeoutError("DHT failed to start in time")
            if self._startup_error is not None:
                raise RuntimeError("DHT failed to start") from self._startup_error
        return self

    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        async def boot():
            try:
                self._node = await DHTNode.create(
                    listen_host=self._listen[0],
                    listen_port=self._listen[1],
                    initial_peers=self._initial_peers,
                    record_validators=self._validators,
                    client_mode=self._client_mode,
                    advertised_host=self._advertised_host,
                    num_replicas=self._num_replicas,
                    maintenance_interval=self._maintenance_interval,
                )
            except BaseException as e:  # noqa: BLE001 — surfaced to caller
                self._startup_error = e
            finally:
                self._ready.set()

        loop.run_until_complete(boot())
        if self._startup_error is None:
            loop.run_forever()
        loop.close()

    def shutdown(self) -> None:
        if self._loop is None or self._node is None or self._shut_down:
            return
        self._shut_down = True
        try:
            fut = asyncio.run_coroutine_threadsafe(self._node.shutdown(), self._loop)
            fut.result(timeout=5)
        except Exception:  # noqa: BLE001 — best-effort shutdown
            pass
        try:
            self._loop.call_soon_threadsafe(self._loop.stop)
        except RuntimeError:
            pass  # loop already closed
        self._thread.join(timeout=5)

    # ------------------------------------------------------------ properties

    @property
    def port(self) -> Optional[int]:
        return self._node.port if self._node else None

    @property
    def endpoint(self) -> Endpoint:
        assert self._node is not None
        return self._node.endpoint

    def get_visible_address(self) -> str:
        host, port = self.endpoint
        return f"{host}:{port}"

    # ------------------------------------------------------------ operations

    def _submit(self, coro) -> concurrent.futures.Future:
        assert self._loop is not None and self._node is not None, "DHT not started"
        return asyncio.run_coroutine_threadsafe(coro, self._loop)

    def store(
        self,
        key: DHTKey,
        value: Any,
        expiration_time: DHTExpiration,
        subkey: Optional[bytes] = None,
        return_future: bool = False,
    ):
        """Store a msgpack-able value. Blocks unless return_future."""
        assert self._node is not None, "DHT not started"
        coro = self._node.store(
            _to_bytes(key), pack_obj(value), expiration_time, subkey=subkey
        )
        fut = self._submit(coro)
        return fut if return_future else fut.result()

    def get(
        self,
        key: DHTKey,
        latest: bool = False,
        return_future: bool = False,
    ):
        """Returns ValueWithExpiration of (unpacked value | dict of subkey ->
        ValueWithExpiration(unpacked)) or None."""
        assert self._node is not None, "DHT not started"
        inner = self._node.get(_to_bytes(key), latest=latest)

        async def convert():
            entry = await inner
            if entry is None:
                return None
            if isinstance(entry.value, DictionaryDHTValue):
                out: Dict[Any, ValueWithExpiration] = {}
                for sk, v in entry.value.items():
                    try:
                        out[sk] = ValueWithExpiration(
                            unpack_obj(v.value), v.expiration_time
                        )
                    except Exception:  # noqa: BLE001 — skip undecodable entry
                        continue
                return ValueWithExpiration(out, entry.expiration_time)
            try:
                return ValueWithExpiration(
                    unpack_obj(entry.value), entry.expiration_time
                )
            except Exception:  # noqa: BLE001
                return None

        fut = self._submit(convert())
        return fut if return_future else fut.result()

    def run_coroutine(self, coro_fn, return_future: bool = False):
        """Run ``coro_fn(node)`` on the DHT loop (averager integration hook)."""
        fut = self._submit(coro_fn(self._node))
        return fut if return_future else fut.result()
