"""RSA keys for signed DHT records.

Capability parity with hivemind.dht.crypto's RSASignatureValidator keys used
at albert/metrics_utils.py:21-24 and the local_public_key the trainers seed
their shuffling with (albert/run_trainer.py:266-270).

Dependency gate: ``cryptography`` is the load-bearing implementation
(RSA-PSS). Some CI/dev containers ship without the wheel and have no
network to fetch it; rather than taking the whole DHT stack down with an
ImportError, this module degrades to a clearly-labelled, structurally
faithful stand-in (key identity, sign/verify pairing, tamper and
wrong-key rejection) that is NOT cryptographically secure — a signature
reveals the signing seed, so anyone who has SEEN one can forge. A loud
warning is emitted once at import; production deployments must install
``cryptography``.
"""
from __future__ import annotations

try:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding, rsa

    HAVE_CRYPTOGRAPHY = True
except ImportError:  # gated: see module docstring
    HAVE_CRYPTOGRAPHY = False

if HAVE_CRYPTOGRAPHY:
    _PADDING = padding.PSS(
        mgf=padding.MGF1(hashes.SHA256()),
        salt_length=padding.PSS.DIGEST_LENGTH,
    )

    class RSAPrivateKey:
        def __init__(self, key: rsa.RSAPrivateKey | None = None):
            self._key = key or rsa.generate_private_key(
                public_exponent=65537, key_size=2048
            )

        def sign(self, data: bytes) -> bytes:
            return self._key.sign(data, _PADDING, hashes.SHA256())

        def public_bytes(self) -> bytes:
            return self._key.public_key().public_bytes(
                serialization.Encoding.DER,
                serialization.PublicFormat.SubjectPublicKeyInfo,
            )

        def to_bytes(self) -> bytes:
            return self._key.private_bytes(
                serialization.Encoding.DER,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption(),
            )

        @classmethod
        def from_bytes(cls, data: bytes) -> "RSAPrivateKey":
            return cls(serialization.load_der_private_key(data, password=None))

    def verify_signature(
        public_key_bytes: bytes, data: bytes, signature: bytes
    ) -> bool:
        try:
            pub = serialization.load_der_public_key(public_key_bytes)
            pub.verify(signature, data, _PADDING, hashes.SHA256())
            return True
        except (InvalidSignature, ValueError, TypeError):
            return False

else:
    import hashlib
    import hmac as _hmac
    import os

    from dedloc_tpu_torch.utils.logging import get_logger

    get_logger(__name__).warning(
        "the 'cryptography' package is unavailable — DHT record signing is "
        "running on an INSECURE structural stub (signatures reveal the "
        "signing seed). Fine for offline tests; install 'cryptography' for "
        "any real deployment."
    )

    _STUB_MAGIC = b"DEDLOC-STUB-KEY:"

    class RSAPrivateKey:  # type: ignore[no-redef]
        """Structural stand-in: a 32-byte seed is the private key, its
        sha256 is the public identity, a signature is (seed, mac) so
        verification needs only the public bytes. Preserves the semantics
        tests rely on (wrong key / tampered payload => verify fails), NOT
        unforgeability."""

        def __init__(self, key: bytes | None = None):
            self._seed = key if key is not None else os.urandom(32)

        def sign(self, data: bytes) -> bytes:
            mac = hashlib.sha256(self._seed + data).digest()
            return _STUB_MAGIC + self._seed + mac

        def public_bytes(self) -> bytes:
            return _STUB_MAGIC + hashlib.sha256(self._seed).digest()

        def to_bytes(self) -> bytes:
            return self._seed

        @classmethod
        def from_bytes(cls, data: bytes) -> "RSAPrivateKey":
            return cls(data)

    def verify_signature(  # type: ignore[no-redef]
        public_key_bytes: bytes, data: bytes, signature: bytes
    ) -> bool:
        if not (
            isinstance(signature, bytes)
            and isinstance(public_key_bytes, bytes)
            and signature.startswith(_STUB_MAGIC)
            and public_key_bytes.startswith(_STUB_MAGIC)
        ):
            return False
        body = signature[len(_STUB_MAGIC):]
        seed, mac = body[:32], body[32:]
        if hashlib.sha256(seed).digest() != public_key_bytes[len(_STUB_MAGIC):]:
            return False  # signed by a different key than claimed
        return _hmac.compare_digest(
            hashlib.sha256(seed + data).digest(), mac
        )
