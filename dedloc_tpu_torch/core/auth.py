"""Token authorization for gated public collaborations.

Capability parity with the reference's auth stack
(sahajbert/huggingface_auth.py:46-171): a peer authenticates to an authority
with its credentials, submits its local RSA public key, and receives a
signed ``AccessToken`` (username + peer public key + expiration, signed by
the authority) plus the coordinator endpoint; the token then rides on every
peer-to-peer request, letting any peer verify that its counterparty was
admitted to the run without talking to the authority again. The client
implements the reference's ``TokenAuthorizerBase`` protocol surface:
``get_token`` / ``is_token_valid`` / ``does_token_need_refreshing``.

TPU-native descope: the reference's authority is an HTTPS service
(collaborative-training-auth.huggingface.co) reached through huggingface_hub
login; here the authority is an in-process/object seam
(``AllowlistAuthServer``) a deployment can put behind any transport. The
cryptography (RSA-PSS over a canonical token encoding) is the load-bearing
part and is identical in capability.
"""
from __future__ import annotations

import asyncio
import dataclasses
import hmac
import os
import random
from collections import deque
from typing import Awaitable, Callable, Deque, Dict, Optional, Tuple, TypeVar

from dedloc_tpu_torch.core.timeutils import get_dht_time
from dedloc_tpu_torch.dht.crypto import RSAPrivateKey, verify_signature
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

T = TypeVar("T")


@dataclasses.dataclass
class AccessToken:
    """Signed admission ticket (reference: the AccessToken the auth endpoint
    returns, huggingface_auth.py:46-76 consumption sites)."""

    username: str
    peer_public_key: bytes  # DER SubjectPublicKeyInfo of the admitted peer
    expiration_time: float  # DHT time
    signature: bytes = b""

    def signing_bytes(self) -> bytes:
        """Canonical byte encoding covered by the authority's signature."""
        return b" ".join(
            [
                self.username.encode(),
                self.peer_public_key.hex().encode(),
                repr(float(self.expiration_time)).encode(),
            ]
        )

    def to_wire(self) -> Dict:
        return {
            "username": self.username,
            "peer_public_key": self.peer_public_key,
            "expiration_time": self.expiration_time,
            "signature": self.signature,
        }

    @classmethod
    def from_wire(cls, raw: Dict) -> "AccessToken":
        return cls(
            username=str(raw["username"]),
            peer_public_key=bytes(raw["peer_public_key"]),
            expiration_time=float(raw["expiration_time"]),
            signature=bytes(raw["signature"]),
        )


class AuthorizationError(Exception):
    """Raised when the authority rejects a peer or a token fails checks."""


def peer_id_from_public_key(public_key: bytes) -> bytes:
    """Canonical peer identity for gated runs: a digest of the token-bound
    RSA public key. Binding peer ids to keys is what lets receivers check
    that a signed envelope's token actually belongs to the peer identity
    claimed in the payload (no impersonation of other members/leaders)."""
    import hashlib

    return hashlib.sha256(public_key).digest()[:20]


class AllowlistAuthServer:
    """In-process authority: allowlist + credential check -> signed tokens.

    Stand-in for the reference's moderated auth service (the sahajbert run
    gated contributors through an HF-account allowlist). Holds the authority
    keypair; deployments expose ``issue_token`` over any transport.
    """

    def __init__(
        self,
        allowlist: Dict[str, str],  # username -> credential (password/API key)
        token_lifetime: float = 600.0,
        coordinator_endpoint: Optional[str] = None,
        authority_key: Optional[RSAPrivateKey] = None,
    ):
        self._allowlist = dict(allowlist)
        self.token_lifetime = token_lifetime
        self.coordinator_endpoint = coordinator_endpoint
        self._key = authority_key or RSAPrivateKey()

    @property
    def authority_public_key(self) -> bytes:
        return self._key.public_bytes()

    def add_user(self, username: str, credential: str) -> None:
        self._allowlist[username] = credential

    def revoke_user(self, username: str) -> None:
        self._allowlist.pop(username, None)

    def issue_token(
        self, username: str, credential: str, peer_public_key: bytes
    ) -> Dict:
        """Returns {"token": wire-token, "coordinator_endpoint": ...} or
        raises AuthorizationError (non-allowlisted / bad credential)."""
        expected = self._allowlist.get(username)
        if (
            credential is None
            or expected is None
            # bytes comparison: compare_digest on str raises for non-ASCII
            or not hmac.compare_digest(
                expected.encode("utf-8"), credential.encode("utf-8")
            )
        ):
            raise AuthorizationError(f"user {username!r} is not authorized")
        token = AccessToken(
            username=username,
            peer_public_key=peer_public_key,
            expiration_time=get_dht_time() + self.token_lifetime,
        )
        token.signature = self._key.sign(token.signing_bytes())
        return {
            "token": token.to_wire(),
            "coordinator_endpoint": self.coordinator_endpoint,
        }


class TokenAuthorizerBase:
    """The reference's authorizer protocol (hivemind TokenAuthorizerBase as
    implemented by HuggingFaceAuthorizer, huggingface_auth.py:46-143):
    subclasses fetch tokens; this base owns validity/refresh logic and the
    local keypair."""

    def __init__(self, local_key: Optional[RSAPrivateKey] = None):
        self.local_private_key = local_key or RSAPrivateKey()
        self.local_public_key = self.local_private_key.public_bytes()
        self._token: Optional[AccessToken] = None

    async def get_token(self) -> AccessToken:
        raise NotImplementedError

    def is_token_valid(self, token: AccessToken) -> bool:
        raise NotImplementedError

    def does_token_need_refreshing(
        self, token: AccessToken, refresh_margin: float = 30.0
    ) -> bool:
        return get_dht_time() + refresh_margin >= token.expiration_time

    async def refresh_token_if_needed(self) -> AccessToken:
        if self._token is None or self.does_token_need_refreshing(self._token):
            self._token = await self.get_token()
            if not self.is_token_valid(self._token):
                raise AuthorizationError("authority returned an invalid token")
        return self._token


class AllowlistAuthorizer(TokenAuthorizerBase):
    """Client against an ``AllowlistAuthServer``-shaped authority.

    ``issue_fn(username, credential, peer_public_key)`` is the transport
    seam: the in-process server's ``issue_token`` in tests, an HTTPS call in
    a deployment.
    """

    def __init__(
        self,
        username: str,
        credential: str,
        issue_fn: Callable[[str, str, bytes], Dict],
        authority_public_key: bytes,
        local_key: Optional[RSAPrivateKey] = None,
    ):
        super().__init__(local_key)
        self.username = username
        self._credential = credential
        self._issue_fn = issue_fn
        self.authority_public_key = authority_public_key
        self.coordinator_endpoint: Optional[str] = None

    async def get_token(self) -> AccessToken:
        response = await call_with_retries(
            lambda: _maybe_async(
                self._issue_fn, self.username, self._credential,
                self.local_public_key,
            ),
            retryable=(OSError, TimeoutError),
        )
        self.coordinator_endpoint = response.get("coordinator_endpoint")
        return AccessToken.from_wire(response["token"])

    def is_token_valid(self, token: AccessToken) -> bool:
        if token.expiration_time < get_dht_time():
            return False
        # the token must be bound to THIS peer — a validly-signed token for
        # another peer's key would pass signature checks but every envelope
        # we sign would then be rejected by counterparties
        if token.username != self.username:
            return False
        if token.peer_public_key != self.local_public_key:
            return False
        if not verify_signature(
            self.authority_public_key, token.signing_bytes(), token.signature
        ):
            return False
        return True


# ------------------------------------------------------- request envelopes


def _envelope_signing_bytes(
    payload: bytes, nonce: bytes, timestamp: float, context: bytes = b""
) -> bytes:
    # Length-prefix every variable-length field so the signed encoding is
    # unambiguous: payload and nonce are unconstrained bytes, and a
    # delimiter-joined encoding would let an attacker shift the
    # payload/nonce boundary whenever the nonce happened to contain the
    # delimiter, defeating the replay guard's nonce memory.
    ts_bytes = repr(float(timestamp)).encode()
    return b"".join(
        len(field).to_bytes(8, "big") + field
        for field in (context, payload, nonce, ts_bytes)
    )


def wrap_request(
    token: AccessToken,
    payload: bytes,
    sender_key: RSAPrivateKey,
    context: bytes = b"",
) -> Dict:
    """Signed request envelope: the token proves admission (authority
    signature); the sender signature covers payload + a fresh nonce + a
    timestamp + the caller-chosen ``context`` (e.g. round id + recipient
    identity), so a captured envelope can be replayed neither later NOR at a
    different recipient/round (hivemind's AuthRPCWrapper includes
    per-request nonces for the same reason)."""
    nonce = os.urandom(16)
    timestamp = get_dht_time()
    return {
        "token": token.to_wire(),
        "payload": payload,
        "nonce": nonce,
        "timestamp": timestamp,
        "payload_signature": sender_key.sign(
            _envelope_signing_bytes(payload, nonce, timestamp, context)
        ),
    }


class ReplayGuard:
    """Remembers recently-seen nonces within the freshness window.

    Nonces are kept both in a set (O(1) membership) and in an
    insertion-ordered deque of ``(first_seen, nonce)``; because ``now`` is
    monotone across calls the deque stays time-sorted, so each call only
    pops the aged prefix — O(1) amortized instead of a full-dict rebuild
    per request on the leader's admission path."""

    def __init__(self, max_age: float = 60.0):
        self.max_age = max_age
        self._seen: set = set()
        self._order: Deque[Tuple[float, bytes]] = deque()

    def check_and_remember(self, nonce: bytes, now: float) -> bool:
        """False if the nonce was already seen (replay). Expires old ones."""
        while self._order and now - self._order[0][0] > self.max_age:
            _, old = self._order.popleft()
            self._seen.discard(old)
        if nonce in self._seen:
            return False
        self._seen.add(nonce)
        self._order.append((now, nonce))
        return True


def unwrap_request(
    envelope: Dict,
    authority_public_key: bytes,
    now: Optional[float] = None,
    replay_guard: Optional[ReplayGuard] = None,
    max_age: float = 60.0,
    context: bytes = b"",
    return_token: bool = False,
):
    """Validate an envelope and return its payload (or ``(payload, token)``
    with ``return_token`` — callers use the token to bind the sender's key
    to the identity claimed in the payload), or raise AuthorizationError.
    Checks: token signature (authority), token expiry, sender signature over
    context+payload+nonce+timestamp (``context`` must match what the sender
    bound), freshness (``max_age``), and — when a ``replay_guard`` is
    supplied — nonce uniqueness."""
    token = AccessToken.from_wire(envelope["token"])
    if not verify_signature(
        authority_public_key, token.signing_bytes(), token.signature
    ):
        raise AuthorizationError("token signature invalid")
    t_now = now if now is not None else get_dht_time()
    if token.expiration_time < t_now:
        raise AuthorizationError("token expired")
    payload = bytes(envelope["payload"])
    nonce = bytes(envelope["nonce"])
    timestamp = float(envelope["timestamp"])
    if abs(t_now - timestamp) > max_age:
        raise AuthorizationError("request envelope is stale")
    if not verify_signature(
        token.peer_public_key,
        _envelope_signing_bytes(payload, nonce, timestamp, context),
        bytes(envelope["payload_signature"]),
    ):
        raise AuthorizationError("payload signature invalid")
    if replay_guard is not None and not replay_guard.check_and_remember(
        nonce, t_now
    ):
        raise AuthorizationError("replayed request envelope")
    return (payload, token) if return_token else payload


# ---------------------------------------------------------------- retries


async def call_with_retries(
    fn: Callable[[], Awaitable[T]],
    n_retries: int = 3,
    base_delay: float = 0.5,
    retryable: tuple = (Exception,),
) -> T:
    """Exponential backoff with jitter (the reference's retry helper around
    the auth endpoint, huggingface_auth.py:23-35)."""
    for attempt in range(n_retries + 1):
        try:
            return await fn()
        except retryable as e:
            if attempt == n_retries:
                raise
            delay = base_delay * (2 ** attempt) * (0.5 + random.random())
            logger.warning(
                f"auth call failed ({e!r}); retry {attempt + 1}/{n_retries} "
                f"in {delay:.1f}s"
            )
            await asyncio.sleep(delay)
    raise AssertionError("unreachable")


async def _maybe_async(fn, *args):
    result = fn(*args)
    if asyncio.iscoroutine(result):
        return await result
    return result


# ------------------------------------------------- network token service


class AuthService:
    """Network face of ``AllowlistAuthServer``: attaches ``auth.issue`` to
    an ``RPCServer`` (typically the coordinator's DHT node server) so
    volunteers obtain signed access tokens with one RPC — the capability of
    the reference's hosted auth endpoint (sahajbert/huggingface_auth.py:
    46-143 PUTs the peer's public key and receives a signed AccessToken +
    coordinator address)."""

    def __init__(self, server, auth_server: AllowlistAuthServer):
        self.auth = auth_server
        server.register("auth.issue", self._rpc_issue)

    async def _rpc_issue(self, peer, args) -> Dict:
        response = self.auth.issue_token(
            args["username"],
            args["credential"],
            bytes.fromhex(args["public_key"]),
        )
        response["authority_public_key"] = (
            self.auth.authority_public_key.hex()
        )
        return response


def remote_token_issuer(endpoint) -> Callable:
    """``issue_fn`` for ``AllowlistAuthorizer`` that calls a remote
    ``AuthService`` (async — runs inside the DHT event loop on refresh)."""

    async def issue(username: str, credential: str, public_key: bytes) -> Dict:
        from dedloc_tpu_torch.dht.protocol import RPCClient

        client = RPCClient(request_timeout=10.0)
        try:
            return await client.call(
                endpoint,
                "auth.issue",
                {
                    "username": username,
                    "credential": credential,
                    "public_key": public_key.hex(),
                },
            )
        finally:
            await client.close()

    return issue


def remote_auth_handshake(
    endpoint, username: str, credential: str,
    local_key: Optional[RSAPrivateKey] = None,
) -> "AllowlistAuthorizer":
    """Join-time auth (contributor notebook cell 2 capability): fetch the
    first token synchronously — failing fast on bad credentials — and build
    an authorizer that refreshes over the same endpoint. The authority
    public key is taken from the endpoint's reply (trust-on-first-use;
    organizers can distribute it out of band and compare)."""
    import asyncio

    key = local_key or RSAPrivateKey()
    issue = remote_token_issuer(endpoint)

    async def first():
        return await issue(username, credential, key.public_bytes())

    response = asyncio.run(first())
    authority = bytes.fromhex(response["authority_public_key"])
    authorizer = AllowlistAuthorizer(
        username, credential, issue, authority, local_key=key
    )
    # seed the freshly-issued token so the first round needs no second RPC
    token = AccessToken.from_wire(response["token"])
    authorizer._token = token  # noqa: SLF001 — warm the cache
    authorizer.coordinator_endpoint = response.get("coordinator_endpoint")
    return authorizer
