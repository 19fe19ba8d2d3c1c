"""Two-level averaging topology planner: low-RTT cliques + elected delegates.

DeDLOC's core contribution (PAPER.md §0) is an averaging algorithm that
ADAPTS between all-reduce, parameter-server and gossip depending on peer
bandwidth and reliability. This module is the decision half of that
adaptation for the TPU build: given the per-directed-link RTT/goodput table
the telemetry layer already measures (``telemetry/links.py``, folded
swarm-wide by ``telemetry/health.build_topology``), it partitions a round's
roster into datacenter-local cliques and elects one delegate per clique by
uplink capacity. The execution half — clique members reduce over cheap
local links first, delegates carry the clique's weight-summed contribution
into the WAN butterfly round, then fan the result back out — lives in
``averaging/averager.py`` (``--averager.hierarchical``).

The paper's degenerate strategies fall out of the same planner instead of
being separate code paths:

- one giant clique covering every peer  ⇒ ``mode="flat"`` (plain all-reduce
  — a second level would only add a hop);
- a sparse or empty link table           ⇒ ``mode="flat"`` (no evidence to
  group by; the runtime keeps today's flat butterfly);
- a few fat listening peers + a crowd of thin client-mode volunteers ⇒ the
  volunteers are attached to the fattest listeners' cliques, which makes
  those delegates de-facto parameter servers.

``clique_groups`` is the shared clique detector — promoted out of
``tools/runlog_summary.py`` (PR 6's ``--topology`` view) so the operator
preview (``--topology`` ``plan`` section) and the runtime planner can never
disagree about what counts as a clique.

Plan identity: member ids are opaque strings. The runtime averager installs
plans whose ids are ENDPOINT KEYS (``"host:port"`` — what matchmaking
members advertise, so a formed group can be matched against the plan); the
operator views built from folded telemetry use peer labels. ``assignment``
accepts any of the caller's known identities.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# a clique is "same-datacenter material": pairwise RTT well under the swarm
# median (the PR 6 --topology heuristic, unchanged by the promotion)
CLIQUE_RTT_FACTOR = 0.5
# a fat peer serves >= this multiple of the median uplink capacity — the
# parameter-server degenerate case attaches thin volunteers to these
FAT_UPLINK_FACTOR = 2.0
# when at least this fraction of the roster churns per health fold the
# swarm is "very unreliable": full-swarm rounds keep dying mid-exchange, so
# the planner selects gossip-style neighbor averaging (small deterministic
# groups — a dead partner costs one pair's round, not the swarm's)
GOSSIP_INSTABILITY_THRESHOLD = 0.25
# gossip neighbor-group size: pairs, with one group of 3 on an odd roster
GOSSIP_GROUP_SIZE = 2


def clique_groups(links, dst_key: str = "dst"):
    """(median rtt, clique candidate groups) from directed link records.

    Peers whose pairwise RTT sits well under the swarm median are
    same-datacenter material — the hierarchical planner's local-reduction
    groups (ROADMAP item 1). ``links`` are dicts with ``src``/``dst_key``
    peer ids and an optional ``rtt_s``; groups are the connected components
    of the low-RTT pair graph (union-find), smallest-first sorted for
    determinism. Shared by the runtime planner and ``runlog_summary
    --topology`` (which passes ``dst_key="dst_label"``)."""
    rtts = sorted(
        l["rtt_s"] for l in links if l.get("rtt_s") is not None
    )
    if len(rtts) < 2:
        return None, []
    median_rtt = rtts[len(rtts) // 2]
    fast_pairs = [
        (l["src"], l[dst_key]) for l in links
        if l.get("rtt_s") is not None
        and l["rtt_s"] <= CLIQUE_RTT_FACTOR * median_rtt
    ]
    if not fast_pairs:
        return median_rtt, []
    # union-find over low-RTT pairs
    parent = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in fast_pairs:
        parent[find(a)] = find(b)
    cliques = {}
    for node in parent:
        cliques.setdefault(find(node), set()).add(node)
    return median_rtt, sorted(
        sorted(c) for c in cliques.values() if len(c) >= 2
    )


def uplink_capacity(links, dst_key: str = "dst") -> Dict[str, float]:
    """Per-peer uplink capacity estimate from the link table: the best
    observed outbound rate (``peak_bps`` — the least-contended sample —
    falling back to the ``goodput_bps`` EWMA). The delegate-election
    ranking: the delegate pays the clique's whole WAN exchange over its
    serialized uplink, so the fattest uplink carries it."""
    out: Dict[str, float] = {}
    for l in links:
        src = l.get("src")
        if src is None:
            continue
        rate = l.get("peak_bps", l.get("goodput_bps"))
        if rate is None:
            continue
        out[src] = max(out.get(src, 0.0), float(rate))
    return out


@dataclass
class CliquePlan:
    """One clique: sorted member ids + the elected delegate."""

    members: List[str]
    delegate: str

    def key(self) -> str:
        """Stable 12-hex identity of this clique — the matchmaking scope
        its local rounds form under. Derived from the sorted member set,
        so every peer holding the same plan derives the same scope with no
        extra handshake."""
        return hashlib.sha256(
            "\x00".join(sorted(self.members)).encode()
        ).hexdigest()[:12]


@dataclass
class Assignment:
    """One peer's view of the plan: its clique, its delegate, its role."""

    member_id: str
    clique: CliquePlan
    wan_size: int  # how many parties join the WAN round (cliques + directs)

    @property
    def is_delegate(self) -> bool:
        return self.member_id == self.clique.delegate

    @property
    def clique_size(self) -> int:
        return len(self.clique.members)


@dataclass
class TopologyPlan:
    """The planner's output: ``mode="flat"`` (keep today's butterfly — with
    ``reason`` saying why), ``mode="hierarchical"`` with the clique list, or
    ``mode="gossip"`` with the ``peers`` roster (very-unreliable swarms:
    deterministic neighbor pairs per round instead of full-swarm rounds).
    Serializable (``--averager.topology_plan`` file), and the SAME object
    the ``runlog_summary --topology`` plan section renders.

    ``epoch`` versions live re-planning (roles/coordinator.py publishes an
    epoch-bumped plan record on material topology change; averager peers
    adopt the newest between rounds). Matchmaking scopes embed the epoch —
    see ``clique_scope``/``wan_scope``/``gossip_scope`` — so peers holding
    epoch k and k+1 concurrently form DISJOINT groups during rollout: no
    barrier, no handshake, a stale-plan peer just keeps averaging with its
    own cohort until it fetches the new record. Epoch 0 (operator-pinned
    files, pre-epoch plans) keeps the historical scope strings byte-for-
    byte, so old plan files and old peers interoperate unchanged."""

    mode: str  # "flat" | "hierarchical" | "gossip"
    reason: str
    cliques: List[CliquePlan] = field(default_factory=list)
    median_rtt_s: Optional[float] = None
    epoch: int = 0
    peers: List[str] = field(default_factory=list)  # gossip roster

    @property
    def delegates(self) -> List[str]:
        return [c.delegate for c in self.cliques]

    # ------------------------------------------------------ matchmaking scopes

    def clique_scope(self, clique: CliquePlan) -> str:
        """The matchmaking scope a clique's local rounds form under.
        Epoch-qualified so mixed-version rollouts never cross-join."""
        if self.epoch:
            return f"clique:e{self.epoch}:{clique.key()}"
        return f"clique:{clique.key()}"

    def wan_scope(self) -> str:
        """The matchmaking scope the delegates' WAN round forms under."""
        return f"wan:e{self.epoch}" if self.epoch else "wan"

    def gossip_scope(self, members: Sequence[str]) -> str:
        """The matchmaking scope one gossip neighbor group forms under."""
        key = hashlib.sha256(
            "\x00".join(sorted(members)).encode()
        ).hexdigest()[:12]
        return f"gossip:e{self.epoch}:{key}"

    # ------------------------------------------------------- gossip pairing

    def gossip_groups(self, round_id: str) -> List[List[str]]:
        """Deterministic neighbor groups for one gossip round: the roster is
        permuted by a hash of (epoch, round_id) and chunked into pairs (the
        last group absorbs the odd peer). Every peer holding the same plan
        derives the SAME pairing from the shared round id — no coordination
        message, same trick as ``CliquePlan.key``. Pairings rotate every
        round, so repeated gossip rounds mix the whole swarm."""
        roster = sorted(set(self.peers))
        if len(roster) < 2:
            return [roster] if roster else []
        digest = hashlib.sha256(
            f"{self.epoch}\x00{round_id}".encode()
        ).digest()
        keyed = sorted(
            roster,
            key=lambda p: hashlib.sha256(digest + p.encode()).digest(),
        )
        groups = [
            keyed[i:i + GOSSIP_GROUP_SIZE]
            for i in range(0, len(keyed), GOSSIP_GROUP_SIZE)
        ]
        if len(groups) > 1 and len(groups[-1]) < GOSSIP_GROUP_SIZE:
            groups[-2].extend(groups.pop())
        return [sorted(g) for g in groups]

    def gossip_group_of(self, member_ids, round_id: str) -> Optional[List[str]]:
        """The neighbor group containing this peer (matched by any known
        identity), or None when the peer is not in the gossip roster — the
        runtime then falls back to a flat round with the reason named."""
        ids = [member_ids] if isinstance(member_ids, str) else list(member_ids)
        ids = {str(i) for i in ids if i}
        for group in self.gossip_groups(round_id):
            if ids & set(group):
                return group
        return None

    def assignment(self, member_ids) -> Optional[Assignment]:
        """This peer's assignment, matched by ANY of its known identities
        (a single string or an iterable — endpoint key, telemetry label).
        None for flat plans. A hierarchical plan assigns peers it has
        never seen a direct-WAN singleton, so an unplanned late joiner
        still participates (it rides the WAN round as its own delegate)
        instead of being orphaned."""
        if self.mode != "hierarchical":
            return None
        ids = [member_ids] if isinstance(member_ids, str) else list(member_ids)
        ids = [str(i) for i in ids if i]
        wan_size = len(self.cliques)
        for clique in self.cliques:
            for mid in ids:
                if mid in clique.members:
                    return Assignment(mid, clique, wan_size)
        if not ids:
            return None
        # unplanned peer: direct WAN participant (its own singleton clique)
        me = ids[0]
        return Assignment(
            me, CliquePlan(members=[me], delegate=me), wan_size + 1
        )

    def clique_of(self, member_id: str) -> Optional[int]:
        for i, clique in enumerate(self.cliques):
            if member_id in clique.members:
                return i
        return None

    def same_clique(self, a: str, b: str) -> bool:
        """Whether two peers share a clique — the WAN-vs-local classifier
        the simulator's wire accounting uses."""
        ca, cb = self.clique_of(a), self.clique_of(b)
        return ca is not None and ca == cb

    # ------------------------------------------------------- serialization

    def to_dict(self) -> dict:
        return {
            "mode": self.mode,
            "reason": self.reason,
            "median_rtt_s": self.median_rtt_s,
            "epoch": int(self.epoch),
            "peers": list(self.peers),
            "cliques": [
                {"members": list(c.members), "delegate": c.delegate}
                for c in self.cliques
            ],
        }

    @classmethod
    def from_dict(cls, raw: dict) -> "TopologyPlan":
        cliques = [
            CliquePlan(
                members=[str(m) for m in c.get("members", [])],
                delegate=str(c.get("delegate", "")),
            )
            for c in raw.get("cliques", [])
        ]
        return cls(
            mode=str(raw.get("mode", "flat")),
            reason=str(raw.get("reason", "")),
            cliques=cliques,
            median_rtt_s=raw.get("median_rtt_s"),
            epoch=int(raw.get("epoch", 0) or 0),
            peers=[str(p) for p in raw.get("peers", [])],
        )

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "TopologyPlan":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))


def _fresh_links(links, now: Optional[float],
                 stale_after_s: Optional[float]) -> List[dict]:
    """Drop links whose last observation predates the snapshot window.
    A link record without a timestamp passes (folded topology records are
    already the newest fold; only raw event streams carry ``t``)."""
    if now is None or stale_after_s is None or stale_after_s <= 0:
        return list(links)
    horizon = now - stale_after_s
    return [
        l for l in links
        if l.get("t") is None or float(l["t"]) >= horizon
    ]


def plan_topology(
    links: Iterable[dict],
    *,
    client_peers: Sequence[str] = (),
    min_clique_size: int = 2,
    now: Optional[float] = None,
    stale_after_s: Optional[float] = None,
    dst_key: str = "dst",
    instability: Optional[float] = None,
) -> TopologyPlan:
    """Partition the swarm described by ``links`` into a two-level plan.

    ``links``: directed link records (``src``, ``dst_key``, optional
    ``rtt_s``/``goodput_bps``/``peak_bps``/``t``) — the ``--topology``
    fold, a peer's own ``LinkTable.records()``, or the simulator's network
    model. ``client_peers`` are ids that cannot accept inbound connections:
    they are never elected delegate, and with no RTT clique of their own
    they are attached to the fattest listeners (the parameter-server
    degenerate case). ``stale_after_s`` (with ``now``) drops observations
    older than the snapshot window before planning.

    ``instability`` is the caller's churn signal — the fraction of the
    roster lost per recent health fold (``roles/coordinator.py`` derives it
    from ``alive_peers`` deltas). At or above
    ``GOSSIP_INSTABILITY_THRESHOLD`` the planner selects ``mode="gossip"``
    (the paper's remaining degenerate strategy): full-swarm and delegate
    rounds keep dying mid-exchange in such a swarm, so peers average with
    deterministic per-round neighbor pairs instead.

    Falls back to ``mode="flat"`` — never raises — whenever the table is
    too sparse to justify a hierarchy, or when one clique already covers
    every known peer (plain all-reduce is then optimal)."""
    links = _fresh_links(list(links), now, stale_after_s)
    client_set = {str(p) for p in client_peers}
    peers = sorted(
        {l["src"] for l in links if l.get("src")}
        | {l[dst_key] for l in links if l.get(dst_key)}
        | client_set
    )
    if not peers:
        return TopologyPlan("flat", "empty link table")
    if (
        instability is not None
        and instability >= GOSSIP_INSTABILITY_THRESHOLD
        and len(peers) >= 3
    ):
        return TopologyPlan(
            "gossip",
            f"swarm instability {instability * 100.0:.0f}% >= "
            f"{GOSSIP_INSTABILITY_THRESHOLD * 100.0:.0f}% per fold — "
            "gossip neighbor averaging over deterministic per-round pairs",
            peers=peers,
        )
    median_rtt, groups = clique_groups(links, dst_key=dst_key)
    if median_rtt is None:
        return TopologyPlan(
            "flat", "sparse link table (fewer than 2 RTT observations)"
        )
    capacity = uplink_capacity(links, dst_key=dst_key)

    def elect(members: List[str]) -> Optional[str]:
        """Fattest-uplink listener of the clique; None when every member is
        client-mode (such a clique cannot host the WAN leg)."""
        electable = [m for m in members if m not in client_set]
        if not electable:
            return None
        return max(electable, key=lambda m: (capacity.get(m, 0.0), m))

    cliques: List[CliquePlan] = []
    assigned: set = set()
    for members in groups:
        if len(members) < min_clique_size:
            continue
        delegate = elect(sorted(members))
        if delegate is None:
            continue  # all-client clique: members ride the WAN directly
        cliques.append(CliquePlan(sorted(members), delegate))
        assigned.update(members)

    # parameter-server degenerate case: client-mode volunteers that no RTT
    # clique claimed attach to the fattest listeners, round-robin across
    # the fat set so one delegate's uplink is not the whole swarm's funnel
    stray_clients = sorted(client_set - assigned)
    if stray_clients:
        listeners = sorted(
            (p for p in peers if p not in client_set and p not in assigned),
            key=lambda m: (-capacity.get(m, 0.0), m),
        )
        hosts: List[CliquePlan] = list(cliques)
        if listeners:
            rates = sorted(
                (capacity.get(p, 0.0) for p in peers if p not in client_set)
            )
            median_rate = rates[len(rates) // 2] if rates else 0.0
            fat = [
                p for p in listeners
                if capacity.get(p, 0.0) >= FAT_UPLINK_FACTOR * median_rate
                and capacity.get(p, 0.0) > 0.0
            ] or listeners[:1]
            for p in fat:
                server = CliquePlan([p], p)
                cliques.append(server)
                hosts.append(server)
                assigned.add(p)
        if hosts:
            for i, c in enumerate(stray_clients):
                home = hosts[i % len(hosts)]
                home.members = sorted(home.members + [c])
                assigned.add(c)
            for clique in cliques:
                clique.members = sorted(clique.members)

    if not cliques:
        return TopologyPlan(
            "flat", "no low-RTT cliques detected", median_rtt_s=median_rtt
        )
    if len(cliques) == 1 and len(cliques[0].members) >= len(peers):
        return TopologyPlan(
            "flat",
            "single clique covers every peer — plain all-reduce is optimal",
            median_rtt_s=median_rtt,
        )
    covered = sum(len(c.members) for c in cliques)
    return TopologyPlan(
        "hierarchical",
        f"{len(cliques)} cliques cover {covered}/{len(peers)} peers "
        f"(median rtt {median_rtt * 1e3:.1f}ms)",
        cliques=cliques,
        median_rtt_s=median_rtt,
    )


def plan_from_groups(groups: Sequence[Sequence[str]],
                     capacity: Optional[Dict[str, float]] = None,
                     client_peers: Sequence[str] = (),
                     reason: str = "operator-specified cliques",
                     ) -> TopologyPlan:
    """A plan from explicit member groups (operator/spec-driven — e.g. the
    simulator's ``topology.cliques`` key): same election rule, no link
    table needed."""
    capacity = capacity or {}
    client_set = {str(p) for p in client_peers}
    cliques = []
    for members in groups:
        members = sorted(str(m) for m in members)
        if not members:
            continue
        electable = [m for m in members if m not in client_set] or members
        delegate = max(electable, key=lambda m: (capacity.get(m, 0.0), m))
        cliques.append(CliquePlan(members, delegate))
    if len(cliques) < 2:
        return TopologyPlan(
            "flat", "fewer than 2 cliques specified", cliques=[]
        )
    return TopologyPlan("hierarchical", reason, cliques=cliques)
