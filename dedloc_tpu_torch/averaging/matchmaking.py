"""DHT-driven matchmaking: assemble bounded peer groups for each round.

Capability parity with hivemind's DecentralizedAverager matchmaking
(SURVEY.md §2.6: ``target_group_size``, ``averaging_expiration`` straggler
window): peers that decide to average for round R either JOIN an already
declared leader (blocking RPC that returns the assembled group) or DECLARE
themselves leader in the DHT and accept joins until their deadline.

Concurrent leaders are not an error: each assembles its own group, groups
average independently, and group composition rotates across rounds (leader
choice is ranked by hash(round_id, leader_id)) — the same gossip-style
mixing DeDLOC relies on (contributor notebook cell 3: group failure only
costs that group one round).

Gated collaborations (the sahajbert public-run capability,
sahajbert/huggingface_auth.py): when an ``authority_public_key`` is set,
admission is mutual. Leaders only admit joiners whose member record arrives
inside a signed request envelope — an authority-signed access token plus a
payload signature by the token-bound key, context-bound to (round_id,
leader_id) so a captured envelope cannot be re-submitted to another leader
or round. Joiners, in turn, only accept group replies wrapped in the
LEADER's envelope (bound to the same context), so an unadmitted peer can
neither join a group nor successfully lead one: authorized peers refuse its
unsigned replies and fall back to other leaders. Peers with an
``authorizer`` attach/refresh their tokens automatically.
"""
from __future__ import annotations

import asyncio
import hashlib
import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from dedloc_tpu_torch.core.serialization import pack_obj, unpack_obj
from dedloc_tpu_torch.core.timeutils import get_dht_time
from dedloc_tpu_torch.dht.node import DHTNode
from dedloc_tpu_torch.dht.protocol import Endpoint, RPCClient, RPCServer
from dedloc_tpu_torch.telemetry import registry as telemetry
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class Member:
    peer_id: bytes
    endpoint: Optional[Endpoint]  # None for client-mode members
    bandwidth: float
    # tensor-schema fingerprint (names+shapes+dtypes hash): members whose
    # trees cannot all-reduce together are rejected AT JOIN TIME with the
    # cause, instead of tripping a span-size assert mid-round
    schema: bytes = b""
    # zero-weight bandwidth donor (run_aux.py role): counts for spans, NOT
    # for the "did anyone else contribute gradients?" divergence guard — a
    # group of {trainer, aux} must read as one contributor to the trainer
    aux: bool = False
    # advertised wire chunk size (elements) for the pipelined all-reduce.
    # Chunk geometry must be IDENTICAL on every member (senders address
    # chunks by index, hosts key their accumulators the same way), so the
    # round uses the group-negotiated value (GroupInfo.chunk_size), never a
    # peer's local config directly. 0 = monolithic / legacy member.
    chunk_size: int = 0
    # declared averaging weight (samples accumulated this round): what the
    # contribution ledger's RoundReceipts countersign. Rides the SAME signed
    # join envelope as the rest of the member record in gated runs, so a
    # group-mate witnessing this weight witnessed a claim the peer cannot
    # later inflate. 0.0 = legacy member / weight not declared.
    weight: float = 0.0

    def pack(self) -> list:
        ep = list(self.endpoint) if self.endpoint else None
        return [self.peer_id, ep, self.bandwidth, self.schema, self.aux,
                self.chunk_size, self.weight]

    @classmethod
    def unpack(cls, raw) -> "Member":
        ep = tuple(raw[1]) if raw[1] else None
        schema = raw[3] if len(raw) > 3 else b""
        aux = bool(raw[4]) if len(raw) > 4 else False
        chunk_size = int(raw[5]) if len(raw) > 5 else 0
        weight = float(raw[6]) if len(raw) > 6 else 0.0
        return cls(raw[0], ep, float(raw[2]), schema, aux, chunk_size,
                   weight)


@dataclass
class GroupInfo:
    round_id: str
    members: List[Member]  # sorted by peer_id — identical on every member
    my_index: int
    # fresh per group assembly (generated by the leader): keys the allreduce
    # round so a retry of the same optimizer step never collides with state
    # left over from a previous failed attempt
    nonce: str = ""

    @property
    def endpoints(self) -> List[Optional[Endpoint]]:
        return [m.endpoint for m in self.members]

    @property
    def bandwidths(self) -> List[float]:
        # client-mode members host nothing
        return [m.bandwidth if m.endpoint else 0.0 for m in self.members]

    @property
    def contributors(self) -> int:
        """Members that bring gradients (non-aux) — the count the replica-
        divergence guard must use: a {trainer, aux} pair is ONE
        contributor."""
        return sum(1 for m in self.members if not m.aux)

    @property
    def chunk_size(self) -> int:
        """The round's negotiated wire chunk size: every member derives it
        from the identical sorted member list, so chunk indices agree
        without a second handshake. The smallest advertised size wins (the
        most bandwidth-starved peer sets the streaming granularity); any
        member advertising <= 0 — explicit monolithic config, or a legacy
        peer whose record predates the field — drops the whole group to
        monolithic spans, because a member with different chunk geometry
        would address chunks that don't exist on the others."""
        sizes = [m.chunk_size for m in self.members]
        if any(s <= 0 for s in sizes):
            return 0
        return min(sizes)


class MatchmakingFailed(Exception):
    pass


class Matchmaking:
    """One per peer. Needs the peer's RPC server (None in client mode) and
    its DHTNode (all calls run on the node's event loop)."""

    def __init__(
        self,
        node: DHTNode,
        client: RPCClient,
        server: Optional[RPCServer],
        prefix: str,
        peer_id: bytes,
        endpoint: Optional[Endpoint],
        bandwidth: float,
        target_group_size: int = 256,
        averaging_expiration: float = 5.0,
        authorizer=None,  # TokenAuthorizerBase: attach tokens when joining
        authority_public_key: Optional[bytes] = None,  # set => gate joins
        aux: bool = False,  # zero-weight bandwidth donor (run_aux.py role)
        chunk_size: int = 0,  # advertised wire chunk size (elements); the
        # round uses the group minimum (GroupInfo.chunk_size)
        telemetry_registry=None,  # per-peer scope (telemetry/registry.py)
    ):
        self.node = node
        self.client = client
        self.telemetry = telemetry_registry
        self.prefix = prefix
        self.peer_id = peer_id
        self.endpoint = endpoint  # None => client mode
        self.bandwidth = bandwidth if endpoint is not None else 0.0
        self.aux = aux
        self.chunk_size = int(chunk_size)
        # mutable: the averager sets this to the round's declared sample
        # weight right before forming groups, so the member record (and the
        # signed join envelope wrapping it) carries what group-mates
        # countersign in their RoundReceipts (telemetry/ledger.py)
        self.declared_weight = 0.0
        self.target_group_size = target_group_size
        self.averaging_expiration = averaging_expiration
        self.authorizer = authorizer
        self.authority_public_key = authority_public_key
        if authority_public_key is not None:
            from dedloc_tpu_torch.core.auth import ReplayGuard

            if authorizer is None:
                # EVERY gated peer needs an authorizer: listeners to sign
                # leader replies, client-mode peers to wrap their joins —
                # fail at startup rather than stalling/looping at runtime
                raise ValueError(
                    "gated matchmaking requires an authorizer (to wrap "
                    "joins and sign leader replies)"
                )
            # nonce memory must cover the widest freshness window any
            # envelope is accepted under (the assembly-scaled reply window)
            # or replays slip through after the guard forgets the nonce
            self._replay_guard = ReplayGuard(
                max_age=60.0 + 4.0 * averaging_expiration
            )
        else:
            self._replay_guard = None
        # leader state: round_id -> (members dict, member join-envelopes
        # dict, assembled event, full event, full_size, nonce, dissolved
        # flag-holder). ``full`` is set by the join handler the moment the
        # group reaches ``full_size`` so the leader assembles immediately
        # instead of idling out the whole straggler window; ``dissolved``
        # flips when the leader yields to a better-ranked concurrent leader
        # (pending joiners then fail fast and re-join that one).
        self._leading: Dict[
            str, Tuple[Dict[bytes, Member], Dict[bytes, Optional[dict]],
                       asyncio.Event, asyncio.Event, int, str, list]
        ] = {}
        if server is not None:
            server.register("mm.join", self._rpc_join)

    def _leaders_key(self, round_id: str, scope: str = "") -> bytes:
        """DHT advertisement key for a round's leaders. ``scope`` namespaces
        the advertisement (hierarchical averaging: ``clique:<key>`` for the
        local level, ``wan`` for the delegate level) so clique-scoped groups
        assemble independently of — and invisible to — the flat round and
        every other clique. Empty scope is byte-identical to the pre-scope
        key, so mixed-version swarms keep forming flat groups together."""
        if scope:
            return f"{self.prefix}_leaders_{round_id}@{scope}".encode()
        return f"{self.prefix}_leaders_{round_id}".encode()

    def _lkey(self, round_id: str, scope: str) -> str:
        """Key of the local ``_leading`` entry: a delegate leads its clique
        round and the WAN round for the SAME round_id concurrently."""
        return f"{round_id}#{scope}" if scope else round_id

    # ------------------------------------------------------------- leader

    def _context(self, round_id: str, leader_id: bytes,
                 scope: str = "") -> bytes:
        """Envelope context binding: round (+ scope) + leader identity — a
        captured clique-round envelope cannot be replayed into the WAN
        round of the same round_id."""
        tag = f"{round_id}#{scope}" if scope else round_id
        return tag.encode() + b"@" + leader_id

    async def _rpc_join(self, peer: Endpoint, args) -> dict:
        tele = telemetry.resolve(self.telemetry)
        if tele is None:  # telemetry off: the bare path, zero overhead
            return await self._rpc_join_inner(peer, args)
        # server-side serve span: its duration is how long THIS joiner hung
        # on the leader (admission + the wait for assembly), and — via the
        # trace context the dispatch adopted off the request frame — its
        # remote parent is the joiner's mm.form_group span, which is what
        # lets --trace show who waited on whom across the RPC boundary
        with tele.span(
            "mm.join.serve",
            trace_seed=str(args.get("round_id", "")),
            round_id=args.get("round_id"),
        ) as ctx:
            try:
                reply = await self._rpc_join_inner(peer, args)
            except Exception as e:
                ctx["ok"] = False
                ctx["error"] = (
                    str(e) if isinstance(e, MatchmakingFailed)
                    else f"{type(e).__name__}: {e}"
                )
                raise
            ctx["ok"] = True
            return reply

    async def _rpc_join_inner(self, peer: Endpoint, args) -> dict:
        round_id = args["round_id"]
        scope = str(args.get("scope", ""))
        # Fail fast BEFORE envelope cryptography: _admit does full RSA
        # verification and consumes a replay nonce, so rejecting joins for
        # rounds we never led (or that are already assembled/full) first
        # keeps unauthenticated traffic off the leader's crypto budget and
        # out of the replay guard.
        entry = self._leading.get(self._lkey(round_id, scope))
        if entry is None:
            # scope honored, not just advertised: a peer whose plan put it
            # in a different clique is REFUSED with the scope named, so a
            # plan mismatch surfaces as a diagnosable join failure instead
            # of a silently mixed group
            raise MatchmakingFailed(
                f"not leading round {round_id}"
                + (f" in scope {scope!r}" if scope else "")
            )
        members, envelopes, assembled, full, full_size, nonce, dissolved = entry
        if assembled.is_set():
            raise MatchmakingFailed(f"round {round_id} already assembled")
        if len(members) >= self.target_group_size:
            raise MatchmakingFailed(f"round {round_id} is full")
        # _admit is synchronous (no await between the pre-checks above and
        # the insertion below), so the checks cannot go stale here
        member = self._admit(round_id, args, scope)
        my_schema = members[self.peer_id].schema
        if member.schema != my_schema:
            # incompatible tensor trees cannot all-reduce: refuse now, with
            # the cause — the joiner falls back to other leaders or leads
            # its own (compatible) group
            raise MatchmakingFailed(
                f"tensor schema mismatch: joiner {member.schema.hex()[:12]} "
                f"vs group {my_schema.hex()[:12]}"
            )
        members[member.peer_id] = member
        envelopes[member.peer_id] = args.get("auth")
        if len(members) >= full_size:
            full.set()  # wakes the leader: assemble now, don't idle out
        await assembled.wait()
        if dissolved[0]:
            # the leader yielded to a better-ranked concurrent leader —
            # fail fast so this joiner immediately re-joins that leader
            # (its entry is live in the DHT) instead of receiving a
            # doomed partial group
            raise MatchmakingFailed(
                f"leader dissolved round {round_id} into a better-ranked "
                "concurrent leader; re-join"
            )
        group = sorted(members.values(), key=lambda m: m.peer_id)
        if self.authority_public_key is not None:
            # mutual auth: joiners only accept replies signed by an ADMITTED
            # leader (context-bound) — an unadmitted peer cannot lead. The
            # reply forwards every member's OWN join envelope so joiners can
            # verify each identity end-to-end: a malicious admitted leader
            # cannot fabricate or impersonate members it never admitted.
            from dedloc_tpu_torch.core.auth import wrap_request

            token = await self.authorizer.refresh_token_if_needed()
            reply = {
                "envelopes": [envelopes[m.peer_id] for m in group],
                "nonce": nonce,
            }
            return {
                "auth": wrap_request(
                    token,
                    pack_obj(reply),
                    self.authorizer.local_private_key,
                    context=self._context(round_id, self.peer_id, scope),
                )
            }
        return {"members": [m.pack() for m in group], "nonce": nonce}

    def _admit(self, round_id: str, args, scope: str = "") -> Member:
        """Decode (and, for gated runs, authenticate) a join request.

        With gating on, the member record must be the payload of a valid
        signed envelope — authority-signed token, fresh, unreplayed, payload
        signed by the token-bound key, context-bound to (round_id, MY
        leader id) — so only the admitted key holder can submit this
        membership, and only to this leader for this round."""
        if self.authority_public_key is None:
            member = args.get("member")
            if member is None:
                # a gated joiner talking to an ungated leader (config
                # mismatch): reject cleanly instead of KeyError-ing
                raise MatchmakingFailed(
                    "join carried only an auth envelope but this "
                    "collaboration is not gated"
                )
            return Member.unpack(member)
        from dedloc_tpu_torch.core.auth import AuthorizationError, unwrap_request

        envelope = args.get("auth")
        if envelope is None:
            raise MatchmakingFailed(
                "this collaboration is gated: an access token is required"
            )
        try:
            payload, token = unwrap_request(
                envelope, self.authority_public_key,
                replay_guard=self._replay_guard,
                context=self._context(round_id, self.peer_id, scope),
                return_token=True,
            )
        except AuthorizationError as e:
            raise MatchmakingFailed(f"join rejected: {e}") from e
        member = Member.unpack(unpack_obj(payload))
        # identity binding: the member may only claim the peer id derived
        # from ITS token-bound key — an admitted-but-malicious peer cannot
        # impersonate another member (or the leader) in the group list
        from dedloc_tpu_torch.core.auth import peer_id_from_public_key

        if member.peer_id != peer_id_from_public_key(token.peer_public_key):
            raise MatchmakingFailed(
                "join rejected: member peer_id does not match its token key"
            )
        return member

    async def _lead(
        self, round_id: str, deadline: float, allow_abandon: bool,
        schema: bytes = b"",
        expected_size: Optional[int] = None,
        rejected: frozenset = frozenset(),
        scope: str = "",
    ) -> Optional[GroupInfo]:
        """Lead a group until ``deadline`` — or until ``expected_size``
        members joined, whichever is first (the straggler window is an upper
        bound, not a mandatory wait: with the collaboration's peer count
        known from the progress tracker, a full group assembles the moment
        the last partner arrives). Returns None if leadership was abandoned
        in favour of a better-ranked concurrent leader (only ever done while
        we still have zero followers — atomic w.r.t. the loop)."""
        full_size = min(
            self.target_group_size,
            max(1, expected_size) if expected_size else self.target_group_size,
        )
        me = Member(self.peer_id, self.endpoint, self.bandwidth, schema,
                    self.aux, self.chunk_size, float(self.declared_weight))
        members: Dict[bytes, Member] = {self.peer_id: me}
        envelopes: Dict[bytes, Optional[dict]] = {self.peer_id: None}
        if self.authority_public_key is not None:
            # self-envelope: the leader's own member record rides the same
            # verification path as everyone else's in the signed reply
            from dedloc_tpu_torch.core.auth import wrap_request

            token = await self.authorizer.refresh_token_if_needed()
            envelopes[self.peer_id] = wrap_request(
                token, pack_obj(me.pack()),
                self.authorizer.local_private_key,
                context=self._context(round_id, self.peer_id, scope),
            )
        assembled = asyncio.Event()
        full = asyncio.Event()
        nonce = uuid.uuid4().hex[:16]
        dissolved: list = [False]
        entry = (members, envelopes, assembled, full, full_size, nonce,
                 dissolved)
        lkey = self._lkey(round_id, scope)
        self._leading[lkey] = entry
        my_rank = self._rank(round_id, self.peer_id)
        try:
            await self.node.store(
                self._leaders_key(round_id, scope),
                pack_obj({"endpoint": list(self.endpoint)}),
                deadline,
                subkey=self.peer_id,
            )
            # capped so concurrent-leader resolution stays responsive even
            # under long straggler windows (expiration/5 at 120s would poll
            # every 24s — two near-simultaneous leaders would sit in a
            # partial-group deadlock for most of the window)
            check_period = max(0.05, min(2.0, self.averaging_expiration / 5))
            while True:
                if len(members) >= full_size:
                    break  # expected group assembled — no idle wait
                remaining = deadline - get_dht_time()
                if remaining <= 0:
                    break
                try:
                    await asyncio.wait_for(
                        full.wait(), timeout=min(check_period, remaining)
                    )
                except asyncio.TimeoutError:
                    pass
                # two peers may have declared simultaneously (each missed
                # the other's entry): the worse-ranked one yields — rank is
                # a strict total order per round, so exactly one side of
                # any pair ever yields and no dissolve cycle can form.
                # ``rejected`` holds leaders we already failed to join this
                # round; yielding to those would ping-pong.
                if len(members) < full_size:
                    dht_entry = await self.node.get(
                        self._leaders_key(round_id, scope), latest=True
                    )
                    better = []
                    if dht_entry is not None and hasattr(dht_entry.value, "items"):
                        better = [
                            sk
                            for sk, v in dht_entry.value.items()
                            if sk != self.peer_id
                            and sk not in rejected
                            and v.expiration_time > get_dht_time()
                            and self._rank(round_id, sk) < my_rank
                        ]
                    tele = telemetry.resolve(self.telemetry)
                    if better and len(members) == 1 and allow_abandon:
                        # no followers: defect silently and re-join
                        if tele is not None:
                            tele.counter("mm.leader_changes").inc()
                            tele.event(
                                "mm.leader_abandoned", round_id=round_id,
                                yielded_to=better[0],
                            )
                        if self._leading.get(lkey) is entry:
                            self._leading.pop(lkey, None)
                        return None
                    if better and len(members) > 1:
                        # followers already attached (the deadlock case:
                        # both concurrent leaders picked up a follower and
                        # neither group can reach full size) — DISSOLVE:
                        # fail the pending joiners fast so they, and we,
                        # re-join the better-ranked leader within seconds
                        # instead of idling out the whole window in two
                        # partial groups
                        dissolved[0] = True
                        if tele is not None:
                            tele.counter("mm.leader_changes").inc()
                            tele.event(
                                "mm.leader_dissolved", round_id=round_id,
                                followers=len(members) - 1,
                                yielded_to=better[0],
                            )
                        if self._leading.get(lkey) is entry:
                            self._leading.pop(lkey, None)
                        return None
        finally:
            assembled.set()  # joiners get their reply even if store failed
        group = sorted(members.values(), key=lambda m: m.peer_id)

        # let pending join handlers finish serializing before cleanup; only
        # remove OUR entry — by the time this fires, a retry of the same
        # round_id may have installed a fresh one that must stay live
        def _cleanup() -> None:
            if self._leading.get(lkey) is entry:
                self._leading.pop(lkey, None)

        asyncio.get_running_loop().call_later(self.averaging_expiration, _cleanup)
        return GroupInfo(round_id, group, group.index(me), nonce)

    # ------------------------------------------------------------ follower

    async def _try_join(
        self, round_id: str, leader_id: bytes, leader_ep: Endpoint,
        schema: bytes = b"",
        scope: str = "",
    ) -> GroupInfo:
        me = Member(self.peer_id, self.endpoint, self.bandwidth, schema,
                    self.aux, self.chunk_size, float(self.declared_weight))
        args: Dict = {"round_id": round_id}
        if scope:
            args["scope"] = scope
        if self.authorizer is not None:
            from dedloc_tpu_torch.core.auth import wrap_request

            token = await self.authorizer.refresh_token_if_needed()
            args["auth"] = wrap_request(
                token, pack_obj(me.pack()),
                self.authorizer.local_private_key,
                context=self._context(round_id, leader_id, scope),
            )
        else:
            args["member"] = me.pack()
        reply = await self.client.call(
            leader_ep,
            "mm.join",
            args,
            timeout=self.averaging_expiration * 3 + 5.0,
        )
        if self.authority_public_key is not None:
            # mutual auth: refuse groups whose reply is not signed by an
            # admitted leader bound to this (round, leader) context
            from dedloc_tpu_torch.core.auth import (
                AuthorizationError,
                peer_id_from_public_key,
                unwrap_request,
            )

            envelope = reply.get("auth")
            if envelope is None:
                raise MatchmakingFailed(
                    f"leader {leader_ep} is not admitted to this gated run"
                )
            # envelopes age for the whole assembly window (members join at
            # the start, the reply lands at the deadline) — scale freshness
            # to the averaging window (matching the ReplayGuard's memory);
            # admit-time already enforced tightness
            envelope_max_age = 60.0 + 4.0 * self.averaging_expiration
            try:
                payload, token = unwrap_request(
                    envelope, self.authority_public_key,
                    context=self._context(round_id, leader_id, scope),
                    replay_guard=self._replay_guard,
                    max_age=envelope_max_age,
                    return_token=True,
                )
            except AuthorizationError as e:
                raise MatchmakingFailed(
                    f"leader reply rejected: {e}"
                ) from e
            # identity binding: the reply must be signed by the key the
            # claimed leader id derives from — an admitted peer cannot
            # impersonate another leader's DHT declaration
            if leader_id != peer_id_from_public_key(token.peer_public_key):
                raise MatchmakingFailed(
                    "leader reply signed by a key that does not match the "
                    "declared leader identity"
                )
            reply = unpack_obj(payload)
            # verify EVERY member's own join envelope — the leader only
            # relays them; it cannot fabricate or impersonate identities it
            # never admitted (each record is signed by the member's
            # token-bound key, context-bound to this round+leader)
            members = []
            for member_env in reply["envelopes"]:
                try:
                    m_payload, m_token = unwrap_request(
                        member_env, self.authority_public_key,
                        context=self._context(round_id, leader_id, scope),
                        max_age=envelope_max_age,
                        return_token=True,
                    )
                except AuthorizationError as e:
                    raise MatchmakingFailed(
                        f"group member envelope rejected: {e}"
                    ) from e
                m = Member.unpack(unpack_obj(m_payload))
                if m.peer_id != peer_id_from_public_key(
                    m_token.peer_public_key
                ):
                    raise MatchmakingFailed(
                        "group member identity does not match its token key"
                    )
                members.append(m)
            ids = [m.peer_id for m in members]
            # canonical order: honest leaders sort by peer_id, so joiners
            # require strictly-increasing ids — a malicious leader cannot
            # duplicate a member or hand different joiners different index
            # assignments
            if any(a >= b for a, b in zip(ids, ids[1:])):
                raise MatchmakingFailed(
                    "group member list is not strictly sorted by peer id"
                )
            if self.peer_id not in ids:
                raise MatchmakingFailed("leader did not include us")
            return GroupInfo(
                round_id, members, ids.index(self.peer_id),
                reply.get("nonce", ""),
            )
        members = [Member.unpack(r) for r in reply["members"]]
        ids = [m.peer_id for m in members]
        if self.peer_id not in ids:
            raise MatchmakingFailed("leader did not include us")
        return GroupInfo(
            round_id, members, ids.index(self.peer_id), reply.get("nonce", "")
        )

    def _rank(self, round_id: str, leader_id: bytes) -> bytes:
        return hashlib.sha256(round_id.encode() + leader_id).digest()

    # ----------------------------------------------------------------- main

    async def _live_leaders(
        self, round_id: str, scope: str = ""
    ) -> List[Tuple[bytes, Endpoint]]:
        entry = await self.node.get(
            self._leaders_key(round_id, scope), latest=True
        )
        now = get_dht_time()
        leaders: List[Tuple[bytes, Endpoint]] = []
        if entry is not None and hasattr(entry.value, "items"):
            for sk, v in entry.value.items():
                if v.expiration_time <= now:
                    continue
                try:
                    info = unpack_obj(v.value)
                    leaders.append((sk, tuple(info["endpoint"])))
                except Exception:  # noqa: BLE001 — malformed entry
                    continue
        leaders.sort(key=lambda kv: self._rank(round_id, kv[0]))
        return leaders

    async def form_group(
        self, round_id: str, schema: bytes = b"",
        expected_size: Optional[int] = None,
        window: Optional[float] = None,
        scope: str = "",
    ) -> GroupInfo:
        """Join an existing leader or lead; returns the assembled group
        (possibly a singleton if nobody else showed up). Client-mode peers
        cannot lead, so they keep polling for a leader within the straggler
        window instead of failing instantly on a startup race.

        ``schema`` is the caller's tensor-schema fingerprint; leaders admit
        only matching joiners (shape/dtype handshake at join time).

        ``expected_size`` (usually the tracker's live peer count) lets a
        leader assemble as soon as that many members joined instead of
        idling out ``averaging_expiration`` — the window then only matters
        when peers are genuinely late or dead.

        ``scope`` namespaces the whole formation (hierarchical averaging:
        ``clique:<key>`` local rounds, ``wan`` delegate rounds) — leaders
        advertise under the scoped DHT key and admit only same-scope
        joiners, so a round's clique groups and its WAN group assemble
        concurrently without ever mixing."""
        tele = telemetry.resolve(self.telemetry)
        if tele is None:  # telemetry off: the bare path, zero overhead
            return await self._form_group(
                round_id, schema, expected_size, window, scope
            )
        tele.counter("mm.rounds_attempted").inc()
        # trace_seed: with no enclosing avg.round span, every peer of the
        # round still derives the SAME trace id from the shared round_id,
        # so standalone matchmaking traces stitch across peers
        span_attrs = {"round_id": round_id}
        if scope:
            span_attrs["scope"] = scope
        with tele.span(
            "mm.form_group", trace_seed=round_id, **span_attrs
        ) as ctx:
            try:
                group = await self._form_group(
                    round_id, schema, expected_size, window, scope
                )
            except Exception as e:
                # every non-formed attempt counts as aborted — not just
                # MatchmakingFailed — so attempted always reconciles with
                # formed + aborted in the swarm-health view (an unexpected
                # DHT error must not read as a phantom in-flight round)
                tele.counter("mm.rounds_aborted").inc()
                ctx["ok"] = False
                ctx["error"] = (
                    str(e) if isinstance(e, MatchmakingFailed)
                    else f"{type(e).__name__}: {e}"
                )
                raise
            tele.counter("mm.rounds_formed").inc()
            ctx["ok"] = True
            ctx["group_size"] = len(group.members)
            return group

    async def _form_group(
        self, round_id: str, schema: bytes = b"",
        expected_size: Optional[int] = None,
        window: Optional[float] = None,
        scope: str = "",
    ) -> GroupInfo:
        allow_abandon = True
        window = self.averaging_expiration if window is None else window
        deadline = get_dht_time() + window * 2
        attempt = 0
        # leaders that REFUSED us this round (full, schema mismatch, dead):
        # a later _lead must not dissolve toward them, or two leaders that
        # cannot merge would ping-pong dissolve/lead until attempts run out
        rejected: set = set()
        while True:
            attempt += 1
            for leader_id, leader_ep in await self._live_leaders(
                round_id, scope
            ):
                if leader_id == self.peer_id:
                    continue
                try:
                    return await self._try_join(
                        round_id, leader_id, leader_ep, schema, scope
                    )
                except Exception as e:  # noqa: BLE001 — try next leader
                    logger.debug(f"join {leader_ep} failed: {e!r}")
                    tele = telemetry.resolve(self.telemetry)
                    if tele is not None:
                        tele.counter("mm.join_failures").inc()
                        tele.event(
                            "mm.join_failed", round_id=round_id,
                            leader=leader_id, error=type(e).__name__,
                        )
                    if "dissolved round" not in str(e):
                        # a dissolve tells us to retry OTHER leaders — it is
                        # not a refusal by this one's successor
                        rejected.add(leader_id)
                    continue
            if self.endpoint is None:
                if get_dht_time() >= deadline:
                    raise MatchmakingFailed(
                        "client-mode peer found no joinable leader for this round"
                    )
                await asyncio.sleep(
                    min(0.3, max(0.05, self.averaging_expiration / 10))
                )
                continue
            if attempt > 3:
                raise MatchmakingFailed(f"could not form a group for {round_id}")
            lead_deadline = get_dht_time() + window
            group = await self._lead(
                round_id, lead_deadline, allow_abandon, schema, expected_size,
                rejected=frozenset(rejected), scope=scope,
            )
            if group is not None:
                return group
            allow_abandon = False  # abandoned once; never defect again
