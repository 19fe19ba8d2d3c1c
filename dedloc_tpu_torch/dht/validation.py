"""DHT record validators: RSA signatures + schema validation.

Capability parity with the reference's spoof-resistant metrics bus
(albert/metrics_utils.py:21-24: make_validators returns
[SchemaValidator(MetricSchema, prefix), RSASignatureValidator()] and the
signed public-key subkeys of BytesWithPublicKey). A validator chain runs at
every storing node; records failing any validator are rejected.

Ownership scheme: a record whose SUBKEY is an owner tag
``b"rsa:" + DER(public_key)`` must carry a signature by exactly that key over
the canonical (key, subkey, value, expiration) tuple. This gives per-peer
write isolation inside shared dictionary keys like ``{prefix}_metrics``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Type

from dedloc_tpu_torch.core.serialization import pack_obj, unpack_obj
from dedloc_tpu_torch.dht.crypto import RSAPrivateKey, verify_signature

OWNER_PREFIX = b"rsa:"


@dataclass(frozen=True)
class DHTRecord:
    key: bytes
    subkey: Optional[bytes]
    value: bytes
    expiration_time: float

    def canonical(self) -> bytes:
        return pack_obj(
            [self.key, self.subkey, self.value, round(self.expiration_time, 3)]
        )


class RecordValidatorBase:
    def validate(self, record: DHTRecord) -> bool:
        raise NotImplementedError

    def sign_value(self, record: DHTRecord) -> bytes:
        """Transform the outgoing value (e.g. append a signature)."""
        return record.value

    def strip_value(self, record: DHTRecord) -> bytes:
        """Inverse of sign_value for readers."""
        return record.value

    def merge_with(self, other: "RecordValidatorBase") -> "CompositeValidator":
        return CompositeValidator([self, other])


class RSASignatureValidator(RecordValidatorBase):
    def __init__(self, private_key: Optional[RSAPrivateKey] = None):
        self.private_key = private_key or RSAPrivateKey()
        self.local_public_key: bytes = OWNER_PREFIX + self.private_key.public_bytes()

    def _wrap(self, value: bytes, signature: bytes) -> bytes:
        return pack_obj({"_v": value, "_sig": signature})

    @staticmethod
    def _unwrap(value: bytes):
        try:
            obj = unpack_obj(value)
            if isinstance(obj, dict) and "_v" in obj and "_sig" in obj:
                return obj["_v"], obj["_sig"]
        except Exception:  # noqa: BLE001 — not a wrapped value
            pass
        return None

    def sign_value(self, record: DHTRecord) -> bytes:
        if record.subkey is None or not record.subkey.startswith(OWNER_PREFIX):
            return record.value
        if record.subkey != self.local_public_key:
            return record.value  # not ours to sign; will fail remote validation
        base = DHTRecord(record.key, record.subkey, record.value,
                         record.expiration_time)
        return self._wrap(record.value, self.private_key.sign(base.canonical()))

    def strip_value(self, record: DHTRecord) -> bytes:
        unwrapped = self._unwrap(record.value)
        return unwrapped[0] if unwrapped is not None else record.value

    def validate(self, record: DHTRecord) -> bool:
        if record.subkey is None or not record.subkey.startswith(OWNER_PREFIX):
            return True  # unowned record: nothing to verify
        unwrapped = self._unwrap(record.value)
        if unwrapped is None:
            return False
        value, signature = unwrapped
        base = DHTRecord(record.key, record.subkey, value, record.expiration_time)
        return verify_signature(
            record.subkey[len(OWNER_PREFIX):], base.canonical(), signature
        )


class SchemaValidator(RecordValidatorBase):
    """Validates (stripped) values for configured keys against pydantic models.

    ``schema`` maps a DHT key (str) -> pydantic model class; the record's
    unpacked value must validate against the model. Unknown keys pass when
    ``allow_extra_keys`` (hivemind-compatible default).
    """

    def __init__(
        self,
        schema: Dict[str, Type],
        prefix: Optional[str] = None,
        allow_extra_keys: bool = True,
        inner_validators: Sequence[RecordValidatorBase] = (),
    ):
        self.schema = {
            (f"{prefix}_{k}" if prefix else k): model for k, model in schema.items()
        }
        self.allow_extra_keys = allow_extra_keys
        self.inner = list(inner_validators)

    def validate(self, record: DHTRecord) -> bool:
        key = record.key.decode(errors="replace")
        model = self.schema.get(key)
        if model is None:
            return self.allow_extra_keys
        value = record.value
        for v in self.inner:
            value = v.strip_value(
                DHTRecord(record.key, record.subkey, value, record.expiration_time)
            )
        try:
            payload = unpack_obj(value)
            model.model_validate(payload)
            return True
        except Exception:  # noqa: BLE001 — validation boundary
            return False


class CompositeValidator(RecordValidatorBase):
    def __init__(self, validators: Sequence[RecordValidatorBase] = ()):
        # Schema validators need signature validators to strip wrapping:
        # run signature validators LAST on write (sign) and make them
        # available as inner strip for schema checks.
        self.validators: List[RecordValidatorBase] = []
        for v in validators:
            self.extend([v])

    def extend(self, validators: Sequence[RecordValidatorBase]) -> None:
        for v in validators:
            if isinstance(v, CompositeValidator):
                self.extend(v.validators)
            else:
                self.validators.append(v)
        sig = [v for v in self.validators if isinstance(v, RSASignatureValidator)]
        for v in self.validators:
            if isinstance(v, SchemaValidator):
                # make signature validators available for unwrapping, keeping
                # any user-supplied inner validators
                for s in sig:
                    if s not in v.inner:
                        v.inner.append(s)

    def validate(self, record: DHTRecord) -> bool:
        return all(v.validate(record) for v in self.validators)

    def sign_value(self, record: DHTRecord) -> bytes:
        value = record.value
        for v in self.validators:
            value = v.sign_value(
                DHTRecord(record.key, record.subkey, value, record.expiration_time)
            )
        return value

    def strip_value(self, record: DHTRecord) -> bytes:
        value = record.value
        for v in reversed(self.validators):
            value = v.strip_value(
                DHTRecord(record.key, record.subkey, value, record.expiration_time)
            )
        return value
