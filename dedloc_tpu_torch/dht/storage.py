"""Local DHT record store: expiration times + dictionary subkeys.

Reproduces the record semantics the reference depends on (SURVEY.md §2.6,
§5 failure-detection): every record carries an absolute ``expiration_time``
(liveness via expiration, not heartbeats); a key may hold either a plain
value or a dictionary of subkeys (per-peer metrics under
``{prefix}_metrics``/public-key subkeys, albert/run_trainer.py:160-166);
newer expiration wins on conflict.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple, Union

from dedloc_tpu_torch.core.timeutils import DHTExpiration, ValueWithExpiration, get_dht_time

Subkey = Union[str, bytes]
BinaryValue = bytes

_NO_SUBKEY = object()


class DictionaryDHTValue:
    """A value made of independently-expiring subkey entries."""

    def __init__(self):
        self.data: Dict[Subkey, ValueWithExpiration[BinaryValue]] = {}

    @property
    def latest_expiration_time(self) -> DHTExpiration:
        return max(
            (e.expiration_time for e in self.data.values()), default=-float("inf")
        )

    def store(
        self, subkey: Subkey, value: BinaryValue, expiration_time: DHTExpiration
    ) -> bool:
        prev = self.data.get(subkey)
        if prev is not None and prev.expiration_time >= expiration_time:
            return False
        self.data[subkey] = ValueWithExpiration(value, expiration_time)
        return True

    def items(self) -> Iterator[Tuple[Subkey, ValueWithExpiration[BinaryValue]]]:
        return iter(self.data.items())

    def __len__(self):
        return len(self.data)


StoredValue = Union[BinaryValue, DictionaryDHTValue]


class DHTLocalStorage:
    def __init__(self, maxsize: int = 10000):
        self.maxsize = maxsize
        self._data: Dict[bytes, ValueWithExpiration[StoredValue]] = {}

    def store(
        self,
        key: bytes,
        value: BinaryValue,
        expiration_time: DHTExpiration,
        subkey=_NO_SUBKEY,
    ) -> bool:
        """Store a record; newer expiration wins. Returns True if stored."""
        if expiration_time <= get_dht_time():
            return False
        self._evict_expired()
        existing = self._data.get(key)
        if subkey is not _NO_SUBKEY:
            if existing is None or not isinstance(existing.value, DictionaryDHTValue):
                # an existing plain value is superseded only by a newer record
                if existing is not None and existing.expiration_time >= expiration_time:
                    return False
                self._data[key] = ValueWithExpiration(
                    DictionaryDHTValue(), expiration_time
                )
                existing = self._data[key]
            dictval = existing.value
            ok = dictval.store(subkey, value, expiration_time)
            if ok:
                self._data[key] = ValueWithExpiration(
                    dictval, dictval.latest_expiration_time
                )
            return ok
        if existing is not None and existing.expiration_time >= expiration_time:
            return False
        self._data[key] = ValueWithExpiration(value, expiration_time)
        return True

    def get(self, key: bytes) -> Optional[ValueWithExpiration[StoredValue]]:
        entry = self._data.get(key)
        if entry is None:
            return None
        if entry.expired():
            if isinstance(entry.value, DictionaryDHTValue):
                # drop only expired subkeys; the dict may still be alive
                entry.value.data = {
                    sk: v for sk, v in entry.value.data.items() if not v.expired()
                }
                if entry.value.data:
                    return ValueWithExpiration(
                        entry.value, entry.value.latest_expiration_time
                    )
            del self._data[key]
            return None
        if isinstance(entry.value, DictionaryDHTValue):
            entry.value.data = {
                sk: v for sk, v in entry.value.data.items() if not v.expired()
            }
        return entry

    def _evict_expired(self) -> None:
        if len(self._data) < self.maxsize:
            return
        now = get_dht_time()
        self._data = {
            k: v for k, v in self._data.items() if v.expiration_time > now
        }
        while len(self._data) >= self.maxsize:
            # drop the soonest-to-expire record
            victim = min(self._data, key=lambda k: self._data[k].expiration_time)
            del self._data[victim]

    def items(self):
        return self._data.items()

    def keys(self):
        return list(self._data.keys())

    def __len__(self):
        return len(self._data)
