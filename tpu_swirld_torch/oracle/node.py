"""The pure-Python ``Node``, the consensus oracle (copy of the reference's
``tpu_swirld/oracle/node.py``, with the same names, state and wire
behaviour, ``state_digest`` included).

It serves two roles:

1. The ``backend='python'`` consensus engine.
2. A live gossip member whose ``backend='tpu'`` passes run on the card
   through :class:`~tpu_swirld_torch.backend.TorchEngine`, the one change
   from the reference (:meth:`Node.consensus_pass`).

Precise rule choices (shared with :mod:`tpu_swirld_torch.gpu.pipeline`, so
both engines agree):

- *ancestor*: reflexive-transitive parent closure (an event is its own
  ancestor).
- *fork*: two events by the same creator, neither an ancestor of the other.
  Minimal fork pairs always share (creator, seq); detection keys on that.
- *see*: ``x sees y`` iff ``y`` is an ancestor of ``x`` and ``x`` does NOT
  have a fork pair by ``y``'s creator among its ancestors.
- *strongly see*: ``x`` strongly sees ``y`` iff members holding a strict
  2/3-supermajority of stake each have an event ``z`` (ANY event by that
  member, not just a maximal tip) with ``x sees z`` and ``z sees y``.
  This is the normative ∃-z rule, implemented exactly on both backends
  (see :meth:`Node.strongly_sees`; pinned by a hand-built fork DAG test in
  ``tests/test_fork.py``).  All supermajorities are exact integer tests
  ``3*amount > 2*total``.
- *round*: ``r = max(parent rounds)``; promoted to ``r+1`` iff the event
  strongly sees round-``r`` witnesses whose creators hold a supermajority
  of stake (distinct creators counted once).  Genesis events are round 0.
- *witness*: first event of a creator in its round (genesis, or
  ``round > round(self_parent)``).
- *fame votes*: a round-``ry`` witness ``y`` votes on a round-``rx``
  witness ``x`` (``d = ry - rx``): at ``d == 1`` the vote is ``y sees x``;
  at ``d > 1`` tally over distinct creators of the round-``(ry-1)``
  witnesses ``y`` strongly sees — a creator contributes its stake to "yes"
  if any of its strongly-seen witnesses voted yes, and to "no" likewise.
  Majority value is ``yes >= no``.  In a non-coin round (``d % C != 0``) a
  supermajority tally decides fame; in a coin round a supermajority sets
  the vote, otherwise the vote is the middle bit of ``y``'s signature.
  Fame is the value of the chronologically first deciding round.
- *round received* of event ``x``: the first fame-complete round ``r``
  whose unique famous witnesses (famous witnesses whose creator has
  exactly one famous witness in ``r``) ALL have ``x`` as ancestor.  Rounds
  with zero unique famous witnesses receive nothing.
- *consensus timestamp*: lower-median (index ``(n-1)//2`` of the sorted
  list) of, per unique famous witness ``w``, the timestamp of the earliest
  self-ancestor of ``w`` that has ``x`` as an ancestor.
- *final order*: sort by (round received, consensus timestamp,
  ``BLAKE2b(whiten || id)``) where ``whiten`` is the XOR of the unique
  famous witnesses' signatures.
- *expiry horizon* (the deterministic ancient-event rule): an event is
  expired iff its round is at or below the fame-complete frontier of **its
  own ancestry** — a pure function of the DAG, so every node and every
  engine (oracle, batch pipeline, incremental driver) applies the identical
  cut.  Because ``round`` is monotone along ancestry (``r = max(parent
  rounds)`` plus promotion), the frontier of ``ancestry(x)`` is at most
  ``round(x) - 2`` (fame of round ``r`` needs a round-``r+2`` witness), so
  the deterministic cut **provably never fires** on a valid event.  The
  operational consequence: a witness is ALWAYS registered, no matter how
  late it arrives relative to this node's local commit progress.  Late
  arrivals into already-ordered rounds are tracked in
  :attr:`Node.late_witnesses` (observability only — they are full DAG
  citizens, ride sync replies like any event, and are decided not-famous
  by the existing vote structure whenever fewer than 1/3 of stake is
  equivocating; a late witness decided *famous* is flagged in
  :attr:`Node.horizon_violations` as an outside-BFT-model event).  This
  replaces the old node-local quarantine, whose cut depended on arrival
  timing and could make honest nodes permanently disagree on a round's
  unique-famous-witness set.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from tpu_swirld_torch import crypto
from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.crypto import xor_bytes
from tpu_swirld_torch.event import (
    MAX_KEY, MAX_PAYLOAD, Event, decode_event, encode_event,
)
from tpu_swirld_torch.obs import phase_scope
from tpu_swirld_torch.oracle.graph import toposort
from tpu_swirld_torch.transport import (
    CHANNEL_SYNC,
    CHANNEL_WANT,
    CircuitBreaker,
    RetryPolicy,
    Transport,
    TransportError,
)


def _bit_count(x: int) -> int:
    return x.bit_count()


class Node:
    """One hashgraph member: event store, gossip endpoint, consensus state."""

    def __init__(
        self,
        sk: bytes,
        pk: bytes,
        network: Dict[bytes, Callable],
        members: Sequence[bytes],
        config: Optional[SwirldConfig] = None,
        clock: Optional[Callable[[], int]] = None,
        create_genesis: bool = True,
        network_want: Optional[Dict[bytes, Callable]] = None,
        transport: Optional[Transport] = None,
    ):
        self.config = config or SwirldConfig(n_members=len(members))
        if len(members) != self.config.n_members:
            raise ValueError("members length != config.n_members")
        self.sk = sk
        self.pk = pk
        self.network = network
        self.network_want = network_want if network_want is not None else {}
        self._orphans: Dict[bytes, Event] = {}
        self._orphan_bytes = 0   # tracked against config.max_orphan_bytes
        self.bad_replies = 0   # malformed/mis-signed replies tolerated so far
        self.bad_requests = 0  # malformed requests served an empty reply
        self.retries = 0       # transport retry attempts issued
        self.backoff_total = 0.0  # cumulative backoff (logical ticks)
        # --- adversary detection counters (the reference's node gauges
        # read them as adversary_*) ---
        self.equivocations_detected = 0   # fork groups seen (one per
                                          # detected (creator, seq) pair)
        self.withholding_suspected = 0    # pulls where a peer provably
                                          # held a parent it refused to
                                          # serve (see pull's want loop)
        self.budget_exhausted = 0         # forked creators beyond the
                                          # f = (n-1)//3 admission budget
        self.sync_branches_capped = 0     # ask_sync replies whose branch
                                          # walk hit max_fork_branches
        # observability hooks (tpu_swirld_torch.metrics / obs; wired by
        # sim.attach_obs), duck-typed
        self.metrics = None   # counters: .count(name, n) / .phase(name)
        self.tracer = None    # phase spans: .span(name)
        self.finality = None  # per-event lifecycle tracking
        self.flightrec = None       # ingest ring of a flight recorder
        self.flightrec_label = None  # ring key for this node's entries
        self._tpu_engine = None   # lazily built when config.backend == "tpu"
        self.members: List[bytes] = list(members)
        self.member_index: Dict[bytes, int] = {m: i for i, m in enumerate(members)}
        stakes = self.config.stakes()
        self.stake: Dict[bytes, int] = {m: stakes[i] for i, m in enumerate(members)}
        self.tot_stake = sum(stakes)
        self._clock = clock or self._lamport_clock

        # --- gossip resilience: transport seam, retry policy, breaker ---
        # The default Transport routes over the same network dicts as the
        # pre-transport code (reliable, in-process); pass a FaultyTransport
        # to exercise the failure surface.
        self.transport = (
            transport
            if transport is not None
            else Transport(self.network, self.network_want)
        )
        cfg = self.config
        self.retry_policy = RetryPolicy(
            attempts=cfg.retry_attempts,
            backoff_base=cfg.retry_backoff,
            backoff_cap=cfg.retry_backoff_cap,
            jitter=cfg.retry_jitter,
            deadline=cfg.retry_deadline,
        )
        self.breaker = CircuitBreaker(
            clock=self._clock,
            failure_threshold=cfg.breaker_failures,
            misbehavior_threshold=cfg.breaker_misbehavior,
            cooldown=cfg.breaker_cooldown,
        )
        # deterministic per-node jitter stream (reproducible chaos runs)
        self._retry_rng = random.Random(
            int.from_bytes(crypto.hash_bytes(b"retry" + pk)[:8], "little")
            ^ cfg.seed
        )
        self._sleep: Optional[Callable[[float], None]] = None  # real
        # deployments may install time.sleep; sims keep time logical

        # --- event store / DAG ---
        self.hg: Dict[bytes, Event] = {}          # id -> Event
        self.idx: Dict[bytes, int] = {}           # id -> topo insertion index
        self.order_added: List[bytes] = []        # insertion (topo) order
        self.anc: Dict[bytes, int] = {}           # id -> ancestor bitmask (incl. self)
        self.seq: Dict[bytes, int] = {}           # id -> self-chain height
        self.member_mask: Dict[bytes, int] = {m: 0 for m in members}
        self.member_events: Dict[bytes, List[bytes]] = {m: [] for m in members}
        self.member_chain: Dict[bytes, List[bytes]] = {m: [] for m in members}
        self.by_seq: Dict[bytes, Dict[int, List[bytes]]] = {m: {} for m in members}
        self.branch_tips: Dict[bytes, set] = {m: set() for m in members}
        self.fork_groups: Dict[bytes, Dict[int, List[bytes]]] = {m: {} for m in members}
        self.has_fork: Dict[bytes, bool] = {m: False for m in members}
        self._forkseen_memo: Dict[Tuple[bytes, bytes], bool] = {}
        self.head: Optional[bytes] = None

        # --- consensus state ---
        self.round: Dict[bytes, int] = {}
        self.is_witness: Dict[bytes, bool] = {}
        self.witnesses: Dict[int, Dict[bytes, List[bytes]]] = {}  # r -> creator -> ids
        self.wit_list: Dict[int, List[bytes]] = {}                # r -> slot-ordered ids
        self.wit_slot: Dict[bytes, int] = {}                      # witness id -> slot
        self._ss_memo: Dict[Tuple[bytes, bytes], bool] = {}
        self.late_witnesses: List[bytes] = []  # witnesses that landed below
        #   the committed frontier (registered anyway — see the module
        #   docstring's expiry-horizon rule; metadata only)
        self.horizon_violations = 0  # late witnesses later decided FAMOUS
        #   (impossible under the n > 3f model; counted, never hidden)
        self.max_round = 0
        self.famous: Dict[bytes, Optional[bool]] = {}
        self.votes: Dict[Tuple[bytes, bytes], bool] = {}
        self._next_vote_round: Dict[bytes, int] = {}   # witness id -> next ry to process
        self._frozen_round = -1                        # rounds <= this are fame-complete

        # --- ordering state ---
        self.tbd: List[bytes] = []                 # insertion-ordered, not yet received
        self.round_received: Dict[bytes, int] = {}
        self.consensus_ts: Dict[bytes, int] = {}
        self.consensus: List[bytes] = []           # final total order (event ids)
        self.transactions: List[bytes] = []        # payloads in consensus order
        self.consensus_round = 0                   # next round to try ordering with

        # genesis event for self (skipped for pure observers replaying a
        # pre-built DAG that already contains this member's genesis)
        if create_genesis:
            genesis = Event(d=b"", p=(), t=self._now(), c=pk).signed(sk)
            self.add_event(genesis)
            self.divide_rounds([genesis.id])

    # ------------------------------------------------------------------ utils

    def _lamport_clock(self) -> int:
        return len(self.order_added)

    @property
    def orphans_parked(self) -> int:
        """Events parked awaiting missing parents (public gauge surface)."""
        return len(self._orphans)

    @property
    def forks_detected(self) -> int:
        """Members this node has seen fork (public gauge surface)."""
        return sum(1 for v in self.has_fork.values() if v)

    @property
    def quarantined_peers(self) -> int:
        """Peers with an open circuit breaker (public gauge surface)."""
        return len(self.breaker.quarantined()) if self.breaker else 0

    @property
    def circuit_opens(self) -> int:
        """Lifetime circuit-breaker open transitions (gauge surface)."""
        return self.breaker.opens if self.breaker else 0

    @property
    def undecided_window(self) -> int:
        """Events in store not yet in the decided order — how far
        consensus trails ingest.  The admission-control gauge: the tx
        ingestion layer sheds client submissions while this exceeds its
        threshold, so an overloaded node backpressures instead of growing
        an unbounded queue."""
        return len(self.hg) - len(self.consensus)

    def _now(self) -> int:
        t = int(self._clock())
        if self.head is not None:
            t = max(t, self.hg[self.head].t + 1)
        return t

    # ------------------------------------------------- event creation / store

    def new_event(self, payload: bytes, other_parent: Optional[bytes]) -> Event:
        """Create and sign a new head event (genesis if no head yet)."""
        if self.head is None:
            parents: Tuple[bytes, ...] = ()
        else:
            if other_parent is None:
                raise ValueError("non-genesis event needs an other-parent")
            parents = (self.head, other_parent)
        return Event(d=payload, p=parents, t=self._now(), c=self.pk).signed(self.sk)

    def is_valid_event(self, ev: Event) -> bool:
        """Structural + cryptographic validation (reference: hash/signature/
        parent checks incl. fork-relevant creator constraints).

        Enforces the same size caps as the wire decoder — an event a peer
        could never decode must not enter the store (it would poison every
        future sync reply containing it).
        """
        if len(ev.d) > MAX_PAYLOAD or len(ev.c) > MAX_KEY:
            return False
        if ev.c not in self.member_index:
            return False
        if not ev.verify():
            return False
        if len(ev.p) not in (0, 2):
            return False
        if ev.p:
            sp, op = ev.p
            if sp not in self.hg or op not in self.hg:
                return False
            if self.hg[sp].c != ev.c:          # self-parent must share creator
                return False
            if self.hg[op].c == ev.c:          # other-parent must not
                return False
        return True

    def add_event(self, ev: Event) -> bool:
        """Insert a validated event; idempotent.  Returns True if new."""
        eid = ev.id
        if eid in self.hg:
            return False
        if not self.is_valid_event(ev):
            raise ValueError("invalid event")
        i = len(self.order_added)
        self.hg[eid] = ev
        self.idx[eid] = i
        self.order_added.append(eid)
        bit = 1 << i
        if ev.p:
            sp, op = ev.p
            self.anc[eid] = bit | self.anc[sp] | self.anc[op]
            self.seq[eid] = self.seq[sp] + 1
        else:
            self.anc[eid] = bit
            self.seq[eid] = 0
        c = ev.c
        s = self.seq[eid]
        self.member_mask[c] |= bit
        self.member_events[c].append(eid)
        # branch tips: events by c that are not (yet) anyone's self-parent.
        # Honest members keep a singleton; forked creators keep one tip per
        # live branch (ask_sync ships them so peers can want-list gaps).
        if ev.p:
            self.branch_tips[c].discard(ev.p[0])
        self.branch_tips[c].add(eid)
        group = self.by_seq[c].setdefault(s, [])
        group.append(eid)
        if len(group) == 2:
            # first fork at this (creator, seq)
            self._on_fork_group(c, s, group)
        if not self.has_fork[c]:
            self.member_chain[c].append(eid)   # index == seq while honest
        if c == self.pk:
            self.head = eid
        self.tbd.append(eid)
        if c != self.pk and self.finality is not None:
            # first remote arrival: creation stamp -> local tick is the
            # gossip-propagation latency (deduped inside the tracker)
            self.finality.record_gossip_arrival(eid, ev.t, now=self._clock())
        if self.flightrec is not None:
            self.flightrec.record_ingest(self.flightrec_label, eid)
        return True

    def _on_fork_group(self, c: bytes, s: int, group: List[bytes]) -> None:
        """Fork bookkeeping for the first pair at ``(creator, seq)``:
        ledger entry, detection counters, breaker strikes, and the n > 3f
        admission budget.  A dedicated seam (the reference's model checker
        seeds a fork-blind bug here)."""
        newly_forked = not self.has_fork[c]
        self.fork_groups[c][s] = group
        self.has_fork[c] = True
        self.equivocations_detected += 1
        if self.metrics is not None:
            self.metrics.count("gossip_fork_pairs_detected")
            self.metrics.count("adversary_equivocations_detected")
        if (
            self.config.quarantine_forkers
            and self.breaker is not None
            and c != self.pk
        ):
            # fork detection feeds the breaker: a proven equivocator
            # is quarantined outright (its events still arrive via
            # honest relays; we just stop gossiping with it directly)
            self.breaker.record_misbehavior(
                c, weight=self.breaker.misbehavior_threshold
            )
        if newly_forked:
            self._check_fork_budget(c)

    def _check_fork_budget(self, c: bytes) -> None:
        """Explicit n > 3f admission check: the vote structure only
        tolerates f = (n-1)//3 equivocating creators.  Events beyond the
        budget are still admitted (fork PROOFS must keep flowing so every
        engine's fork ledger agrees), but the violation is surfaced —
        never silently absorbed — and the over-budget creator is cut off
        at the breaker even when quarantine_forkers is off."""
        f_budget = (len(self.members) - 1) // 3
        if self.forks_detected > f_budget:
            self.budget_exhausted += 1
            if self.metrics is not None:
                self.metrics.count("adversary_budget_exhausted")
            if self.breaker is not None and c != self.pk:
                self.breaker.record_misbehavior(
                    c, weight=self.breaker.misbehavior_threshold
                )

    def state_digest(self) -> bytes:
        """Canonical BLAKE2b digest of the consensus-relevant node state.

        Covers the store (event ids), per-event round / witness / fame /
        ordering assignments, the decided order, and the adversary
        counters.  The same state gives the same digest in both packages,
        so a port node and a reference node are compared through it."""
        parts: List[bytes] = [len(self.hg).to_bytes(4, "little")]
        for eid in sorted(self.hg):
            parts.append(eid)
            parts.append(
                self.round.get(eid, -1).to_bytes(4, "little", signed=True)
            )
            parts.append(b"\x01" if self.is_witness.get(eid) else b"\x00")
            fam = self.famous.get(eid)
            parts.append(
                b"\x02" if fam is None else (b"\x01" if fam else b"\x00")
            )
            parts.append(
                self.round_received.get(eid, -1).to_bytes(
                    4, "little", signed=True
                )
            )
            parts.append(
                self.consensus_ts.get(eid, -1).to_bytes(8, "little", signed=True)
            )
        parts.append(len(self.consensus).to_bytes(4, "little"))
        parts.extend(self.consensus)
        for ctr in (
            self.forks_detected,
            self.equivocations_detected,
            self.budget_exhausted,
            len(self.late_witnesses),
            self.horizon_violations,
            self.bad_replies,
            self.bad_requests,
            self.withholding_suspected,
        ):
            parts.append(int(ctr).to_bytes(4, "little"))
        return crypto.hash_bytes(b"".join(parts))

    # ------------------------------------------------------------ visibility

    def in_anc(self, container: bytes, member_of: bytes) -> bool:
        """Is event ``member_of`` an ancestor of ``container``?"""
        return (self.anc[container] >> self.idx[member_of]) & 1 == 1

    def forkseen(self, eid: bytes, m: bytes) -> bool:
        """Does ``eid`` have a fork pair by member ``m`` among its ancestors?"""
        if not self.has_fork[m]:
            return False
        key = (eid, m)
        memo = self._forkseen_memo.get(key)
        if memo is not None:
            return memo
        a = self.anc[eid]
        result = False
        for _s, ids in self.fork_groups[m].items():
            hits = 0
            for fid in ids:
                if (a >> self.idx[fid]) & 1:
                    hits += 1
                    if hits >= 2:
                        result = True
                        break
            if result:
                break
        self._forkseen_memo[key] = result
        return result

    def sees(self, x: bytes, y: bytes) -> bool:
        """Fork-aware visibility: y ancestor of x, no fork by y's creator."""
        return self.in_anc(x, y) and not self.forkseen(x, self.hg[y].c)

    def _sees_through(self, x: bytes, w: bytes, m: bytes) -> bool:
        """∃ event z by member m with (x sees z) and (z sees w).

        For an honest (fork-free) m, z ranges over the prefix of m's
        self-chain that is in x's ancestry; ``anc(z, w)`` and
        ``forkseen(z, c(w))`` are both monotone along that chain, so the
        earliest chain event with ``anc(z, w)`` is the least likely to be
        fork-poisoned — a binary search decides ∃-z exactly.  For forked
        m, the few events are enumerated directly.
        """
        if self.forkseen(x, m):
            return False  # x sees no event by m at all
        cw = self.hg[w].c
        a = self.anc[x]
        if not self.has_fork[m]:
            cnt = _bit_count(a & self.member_mask[m])
            if not cnt:
                return False
            chain = self.member_chain[m]
            if not self.in_anc(chain[cnt - 1], w):
                return False
            lo, hi = 0, cnt - 1
            while lo < hi:
                mid = (lo + hi) // 2
                if self.in_anc(chain[mid], w):
                    hi = mid
                else:
                    lo = mid + 1
            return not self.forkseen(chain[lo], cw)
        for z in self.member_events[m]:
            if (
                (a >> self.idx[z]) & 1
                and self.in_anc(z, w)
                and not self.forkseen(z, cw)
            ):
                return True
        return False

    def strongly_sees(self, x: bytes, w: bytes) -> bool:
        """x strongly sees w: members holding a stake supermajority each
        have an event z with (x sees z) and (z sees w) — the ∃-z rule,
        exactly as documented in the module spec.  The batched device
        pipeline computes the same relation as a per-member visibility
        matmul (:mod:`tpu_swirld_torch.gpu.pipeline`); parity tests pin
        the two."""
        if not self.in_anc(x, w):
            return False  # any valid z implies w is an ancestor of x
        key = (x, w)
        memo = self._ss_memo.get(key)
        if memo is not None:
            return memo
        amount = 0
        for m in self.members:
            if self._sees_through(x, w, m):
                amount += self.stake[m]
        result = 3 * amount > 2 * self.tot_stake
        self._ss_memo[key] = result
        return result

    # ---------------------------------------------------------------- gossip

    def heights(self) -> Dict[bytes, int]:
        """Per-member count of known events (the sync height vector)."""
        return {m: len(self.member_events[m]) for m in self.members}

    def ask_sync(self, from_pk: bytes, signed_heights: bytes) -> bytes:
        """Serve a sync: reply with the topo-sorted events the asker lacks.

        The asker's height vector is signed; the reply (concatenated encoded
        events) is signed by us (the reference prototype's contract).

        The count vector is only a *hint*: per-creator counts identify a
        chain prefix only while that creator is honest.  For creators we
        know to have forked, we send the delta above the count hint plus a
        bounded fork digest — the earliest fork group's siblings (the
        minimal equivocation proof, so an asker pinned to one branch
        always learns the fork exists) and the current branch tips (so its
        want-list can walk any branch it is missing).  Remaining gaps
        surface on the asker's side as orphans, which it recovers via
        :meth:`ask_events`; reply bytes per sync stay O(delta) even under
        a persistent equivocator (the old rule re-sent a forker's entire
        history on every sync forever).
        """
        if from_pk not in self.member_index:
            raise ValueError("unknown sync peer")
        if (
            len(signed_heights) < crypto.SIG_BYTES
            or len(signed_heights) > self.config.max_reply_bytes
        ):
            self.bad_requests += 1
            raise ValueError("truncated or oversized sync request")
        payload = signed_heights[: -crypto.SIG_BYTES]
        sig = signed_heights[-crypto.SIG_BYTES:]
        if not crypto.verify(payload, sig, from_pk, crypto.DOMAIN_SYNC_REQ):
            self.bad_requests += 1
            raise ValueError("bad sync-request signature")
        if len(payload) != 4 * len(self.members):
            self.bad_requests += 1
            raise ValueError("malformed sync-request height vector")
        heights: Dict[bytes, int] = {}
        off = 0
        for m in self.members:
            heights[m] = int.from_bytes(payload[off : off + 4], "little")
            off += 4
        missing: List[bytes] = []
        for m in self.members:
            known = self.member_events[m]
            if not self.has_fork[m]:
                missing.extend(known[heights[m]:])
                continue
            # Forked creator: the count hint cannot identify WHICH events
            # the asker holds (branches interleave differently per node),
            # so ship the recent tail of EVERY branch, at least as deep as
            # the count difference, plus the earliest fork group (the
            # minimal equivocation proof: an asker pinned to one branch
            # always learns the fork exists) and the branch tips.  The
            # count difference UNDER-estimates the true gap when the asker
            # holds branch events we lack (its surplus cancels our delta);
            # the tips close that residue — they orphan on the asker and
            # its want-list round-trips recover whole chain segments via
            # ask_events' self-ancestor expansion.  O(branches * delta)
            # per reply instead of the old O(full history).
            miss = max(len(known) - heights[m], 0)
            extra: set = set()
            # amplification bound: an equivocation storm can mint one
            # live branch per fork pair, making the tail walk — and the
            # reply — O(branches * delta) with unbounded branches.  Cap
            # the branches walked per reply (deterministic sorted
            # selection so every peer sees the same digest); the earliest
            # fork-group proof below always ships, and events on skipped
            # branches surface as orphan want-lists over later syncs.
            tips = sorted(self.branch_tips[m])
            cap = max(1, self.config.max_fork_branches)
            if len(tips) > cap:
                self.sync_branches_capped += 1
                if self.metrics is not None:
                    self.metrics.count("gossip_sync_branches_capped")
                tips = tips[:cap]
            for tip in tips:
                cur: Optional[bytes] = tip
                for _ in range(miss + 1):
                    if cur is None or cur in extra:
                        break
                    extra.add(cur)
                    cur = self.hg[cur].self_parent
            first_seq = min(self.fork_groups[m])
            extra.update(self.fork_groups[m][first_seq])
            missing.extend(sorted(extra))
        return self._sign_event_blob(missing)

    def _sign_event_blob(self, ids: List[bytes]) -> bytes:
        ordered = toposort(
            sorted(ids, key=lambda e: self.idx[e]),
            lambda e: [p for p in self.hg[e].p],
        )
        # reply-size caps, by count AND bytes: a topo *prefix* stays valid
        # to ingest, and the asker recovers the remainder through later
        # syncs / want-lists.  The byte cap must mirror the asker's
        # _decode_signed_blob budget — an over-budget reply would read as
        # misbehavior there, livelocking two honest peers forever.
        cap = self.config.max_reply_events
        if len(ordered) > cap:
            ordered = ordered[:cap]
        budget = self.config.max_reply_bytes - crypto.SIG_BYTES
        parts: List[bytes] = []
        size = 0
        for e in ordered:
            enc = encode_event(self.hg[e])
            if size + len(enc) > budget:
                break
            parts.append(enc)
            size += len(enc)
        blob = b"".join(parts)
        return blob + crypto.sign(blob, self.sk, crypto.DOMAIN_SYNC_REPLY)

    def ask_events(self, from_pk: bytes, signed_want: bytes) -> bytes:
        """Serve a want-list: the asker requests specific event ids (orphan
        parents it is missing); reply with those we have — each expanded
        into its self-ancestor chain, up to ``config.want_ancestor_depth``
        events per want (the wanted event included), so a single
        successful round-trip closes a whole chain gap instead of one
        parent level (events the asker already holds are idempotently
        skipped on its side; the reply caps still bound the blob) —
        topo-sorted and signed.  Unknown ids are silently skipped.

        Truncated / garbage / oversized requests (an attacker, or a lossy
        transport mangling bytes in flight) are answered with a signed
        EMPTY reply and counted in ``bad_requests`` — a byzantine asker
        must not be able to crash the serving side.
        """
        if from_pk not in self.member_index:
            raise ValueError("unknown sync peer")
        if (
            len(signed_want) < crypto.SIG_BYTES
            or len(signed_want) > self.config.max_reply_bytes
        ):
            return self._reject_request()
        payload = signed_want[: -crypto.SIG_BYTES]
        sig = signed_want[-crypto.SIG_BYTES:]
        if not crypto.verify(payload, sig, from_pk, crypto.DOMAIN_WANT):
            return self._reject_request()
        if len(payload) % crypto.HASH_BYTES:
            return self._reject_request()
        want = [
            payload[i : i + crypto.HASH_BYTES]
            for i in range(0, len(payload), crypto.HASH_BYTES)
        ]
        del want[self.config.max_reply_events:]   # cap the work we do
        # Ancestor expansion is breadth-first — level 0 serves every
        # requested id before any chain is walked deeper, so one want's
        # deep ancestry cannot starve the others — and respects the reply
        # cap: the blob is truncated to max_reply_events anyway, so
        # walking further is pure attacker-amplifiable waste.
        have: List[bytes] = []
        seen: set = set()
        cap = self.config.max_reply_events
        frontier = [h for h in want if h in self.hg]
        for _level in range(max(1, self.config.want_ancestor_depth)):
            if not frontier or len(have) >= cap:
                break
            nxt: List[bytes] = []
            for h in frontier:
                if len(have) >= cap:
                    break
                if h in seen:
                    continue
                seen.add(h)
                have.append(h)
                sp = self.hg[h].self_parent
                if sp is not None:
                    nxt.append(sp)
            frontier = nxt
        return self._sign_event_blob(have)

    def _reject_request(self) -> bytes:
        """Counted rejection of a malformed inbound request: a signed
        empty reply (decodes cleanly on an honest asker's side)."""
        self.bad_requests += 1
        if self.metrics is not None:
            self.metrics.count("gossip_bad_requests")
        return self._sign_event_blob([])

    def _decode_signed_blob(
        self, reply: bytes, peer_pk: bytes
    ) -> Optional[List[Event]]:
        """Decode a signed event blob; ``None`` on any malformation.

        Truncated, garbage, mis-signed, or oversized replies degrade to a
        *counted rejection* (``bad_replies`` + a misbehavior strike on the
        peer's circuit breaker) — never an uncaught exception.  The size
        cap bounds decode work before the signature is even checked.
        """
        if (
            len(reply) < crypto.SIG_BYTES
            or len(reply) > self.config.max_reply_bytes
        ):
            return self._reject_reply(peer_pk)
        blob = reply[: -crypto.SIG_BYTES]
        sig = reply[-crypto.SIG_BYTES:]
        if not crypto.verify(blob, sig, peer_pk, crypto.DOMAIN_SYNC_REPLY):
            return self._reject_reply(peer_pk)
        events: List[Event] = []
        off = 0
        try:
            while off < len(blob):
                ev, off = decode_event(blob, off)   # raises MalformedEvent
                events.append(ev)
        except ValueError:
            return self._reject_reply(peer_pk)
        return events

    def _reject_reply(self, peer_pk: bytes) -> None:
        self.bad_replies += 1
        if self.metrics is not None:
            self.metrics.count("gossip_bad_replies")
        if self.breaker is not None:
            self.breaker.record_misbehavior(peer_pk)
        return None

    def _ingest(self, events: Iterable[Event], new_ids: List[bytes]) -> None:
        """Insert events whose parents are known; park the rest as orphans,
        then drain the orphan buffer to a fixpoint."""
        for ev in events:
            eid = ev.id
            if eid in self.hg:
                continue
            if ev.p and any(p not in self.hg for p in ev.p):
                # park only events that are at least self-consistent (known
                # creator, size caps, valid signature, parent arity) — junk
                # must not be able to occupy the buffer; and evict FIFO when
                # over the count OR byte budget so poisoning can neither
                # disable recovery nor balloon memory (one valid signer
                # could otherwise park max_orphans * MAX_PAYLOAD bytes)
                if (
                    eid not in self._orphans   # re-sent: already parked
                    and self.config.max_orphans > 0
                    and len(ev.p) == 2
                    and self._plausible(ev)
                ):
                    cost = self._orphan_cost(ev)
                    if cost <= self.config.max_orphan_bytes:
                        while self._orphans and (
                            len(self._orphans) >= self.config.max_orphans
                            or self._orphan_bytes + cost
                            > self.config.max_orphan_bytes
                        ):
                            self._evict_orphan(next(iter(self._orphans)))
                        self._orphans[eid] = ev
                        self._orphan_bytes += cost
                continue
            try:
                if self.add_event(ev):
                    new_ids.append(eid)
            except ValueError:
                pass   # invalid event in a signed reply: drop, don't crash
        # fixpoint drain: an inserted orphan may unblock other orphans
        progress = True
        while progress and self._orphans:
            progress = False
            for eid, ev in list(self._orphans.items()):
                if not ev.p or all(p in self.hg for p in ev.p):
                    self._evict_orphan(eid)
                    try:
                        if self.add_event(ev):
                            new_ids.append(eid)
                            progress = True
                    except ValueError:
                        pass   # invalid orphan: drop it

    @staticmethod
    def _orphan_cost(ev: Event) -> int:
        """Approximate resident bytes of a parked event (wire size)."""
        return len(ev.d) + len(ev.c) + len(ev.s) + 2 * crypto.HASH_BYTES + 24

    def _evict_orphan(self, eid: bytes) -> None:
        ev = self._orphans.pop(eid)
        self._orphan_bytes -= self._orphan_cost(ev)

    def _plausible(self, ev: Event) -> bool:
        """Parent-independent validity: creator, size caps, signature."""
        return (
            len(ev.d) <= MAX_PAYLOAD
            and len(ev.c) <= MAX_KEY
            and ev.c in self.member_index
            and ev.verify()
        )

    def _missing_parents(self) -> List[bytes]:
        return sorted(
            {
                p
                for ev in self._orphans.values()
                for p in ev.p
                if p not in self.hg and p not in self._orphans
            }
        )

    def _transport_call(
        self, peer_pk: bytes, channel: str, payload: bytes
    ) -> Optional[bytes]:
        """One logical request over the transport with bounded retry.

        Transport failures (drops, partitions, timeouts, crashed peers)
        are retried up to ``retry_policy.attempts`` times with exponential
        backoff + per-node deterministic jitter, stopping early when the
        per-peer deadline is exhausted or the circuit breaker opens.
        Backoff is *logical*: delays are recorded (``backoff_total``,
        ``gossip_backoff_time``) and handed to ``self._sleep`` if one is
        installed — simulations never block on wall-clock sleeps.

        Returns the raw reply, or ``None`` when the call ultimately
        failed (always counted, never raised).
        """
        met = self.metrics
        pol = self.retry_policy
        br = self.breaker
        attempts = max(1, pol.attempts)
        spent = 0.0
        result: Optional[bytes] = None
        for attempt in range(attempts):
            try:
                result = self.transport.call(
                    self.pk, peer_pk, channel, payload
                )
                if not isinstance(result, (bytes, bytearray)):
                    # a non-bytes reply is peer garbage, not a reply
                    raise ValueError("non-bytes reply")
                break
            except TransportError:
                if met is not None:
                    met.count("gossip_transport_errors")
                if br is not None:
                    before = br.opens
                    br.record_failure(peer_pk)
                    if br.opens > before:
                        if met is not None:
                            met.count("gossip_circuit_opens")
                        break   # breaker just opened: stop hammering
                if attempt + 1 >= attempts:
                    break
                delay = pol.backoff(attempt, self._retry_rng)
                if spent + delay > pol.deadline:
                    if met is not None:
                        met.count("gossip_deadline_exceeded")
                    break
                spent += delay
                self.retries += 1
                if met is not None:
                    met.count("gossip_retries")
                    met.count("gossip_backoff_time", delay)
                if self._sleep is not None:
                    self._sleep(delay)
            except ValueError:
                # legacy direct-dict path: the peer rejected our request —
                # attributable misbehavior (or our bug), not retryable
                self.bad_replies += 1
                if met is not None:
                    met.count("gossip_bad_replies")
                if br is not None:
                    br.record_misbehavior(peer_pk)
                self.backoff_total += spent
                return None
        self.backoff_total += spent
        return result

    def pull(self, peer_pk: bytes) -> List[bytes]:
        """Receive the peer's delta (no own-event creation).

        Resilient by construction: transport failures retry with backoff
        (:meth:`_transport_call`), malformed replies degrade to counted
        rejections, unknown-parent events park in the orphan buffer with
        want-list recovery, and peers that keep failing or misbehaving are
        quarantined by the circuit breaker (calls fail fast until a
        cooldown elapses).  ``pull`` never raises on peer behavior.
        """
        new_ids: List[bytes] = []
        met = self.metrics
        br = self.breaker
        if br is not None and not br.allow(peer_pk):
            if met is not None:
                met.count("gossip_circuit_fastfail")
            return new_ids
        hv = b"".join(
            len(self.member_events[m]).to_bytes(4, "little") for m in self.members
        )
        req = hv + crypto.sign(hv, self.sk, crypto.DOMAIN_SYNC_REQ)
        if met is not None:
            met.count("gossip_syncs")
            met.count("gossip_bytes_out", len(req))
        reply = self._transport_call(peer_pk, CHANNEL_SYNC, req)
        if reply is None:
            return new_ids
        events = self._decode_signed_blob(reply, peer_pk)
        if events is None:
            return new_ids
        if br is not None:
            br.record_success(peer_pk)
        if met is not None:
            met.count("gossip_bytes_in", len(reply))
        # parents referenced by events THIS peer served us this pull: the
        # peer's own store admitted those events, so it provably held the
        # parents too (add_event requires both parents present) — the
        # evidence base for the withholding heuristic below
        served_parents: set = set()
        for ev in events:
            served_parents.update(ev.p)
        self._ingest(events, new_ids)
        # want-list recovery: bounded by DAG depth, capped defensively
        has_want = self.transport.endpoint(peer_pk, CHANNEL_WANT) is not None
        for _ in range(self.config.max_want_rounds):
            want = self._missing_parents()
            if not want or not has_want:
                break
            wv = b"".join(want)
            wreq = wv + crypto.sign(wv, self.sk, crypto.DOMAIN_WANT)
            if met is not None:
                met.count("gossip_want_roundtrips")
                met.count("gossip_bytes_out", len(wreq))
            wreply = self._transport_call(peer_pk, CHANNEL_WANT, wreq)
            if wreply is None:
                break
            got = self._decode_signed_blob(wreply, peer_pk)
            if got is None:
                break
            if met is not None:
                met.count("gossip_bytes_in", len(wreply))
            # withholding detection: a validly-signed want reply that
            # omits a parent of an event the SAME peer served us this
            # pull is (near-)proof of selective censorship — the peer
            # demonstrably held that parent when it admitted the child.
            # "Suspected", not proven: an in-flight-corrupted want
            # request is answered with a signed empty reply, which looks
            # identical here — hence a mild breaker strike, not the full
            # equivocation escalation.
            got_ids = {ev.id for ev in got}
            withheld = [
                w for w in want
                if w not in got_ids and w in served_parents
            ]
            if withheld:
                self.withholding_suspected += 1
                if met is not None:
                    met.count("adversary_withholding_suspected")
                if br is not None:
                    br.record_misbehavior(peer_pk)
            if not got:
                break
            for ev in got:
                served_parents.update(ev.p)
            before = len(new_ids) + len(self._orphans)
            self._ingest(got, new_ids)
            if len(new_ids) + len(self._orphans) == before:
                break   # no progress: stop asking this peer
        if met is not None:
            met.count("gossip_events_received", len(new_ids))
        return new_ids

    def sync(self, peer_pk: bytes, payload: bytes) -> List[bytes]:
        """Gossip with ``peer_pk``; returns new event ids in topo order
        (received sub-DAG first, then our freshly created event)."""
        new_ids = self.pull(peer_pk)
        peer_events = self.member_events[peer_pk]
        if not peer_events:
            return new_ids
        peer_head = peer_events[-1]
        mine = self.new_event(payload, peer_head)
        self.add_event(mine)
        new_ids.append(mine.id)
        return new_ids

    # ------------------------------------------------------------- consensus

    def _register_witness(self, eid: bytes, r: int) -> None:
        # Deterministic expiry horizon (module docstring): the only sound
        # node-agreed cut — "expired iff below the fame-complete frontier
        # of the event's own ancestry" — provably never fires, so EVERY
        # witness registers, however late it lands relative to this node's
        # commit progress.  A late registration (round at or below the
        # already-ordered frontier) cannot change committed state: votes
        # are memoized pure functions of fixed ancestries, no existing
        # witness strongly sees the newcomer, and a committed round's UFW
        # set only changes if the newcomer is decided famous — which the
        # vote-unanimity lemma rules out below 1/3 equivocating stake
        # (tracked in horizon_violations otherwise).  This is what keeps
        # the live oracle, a batch replay, and every peer bit-identical
        # regardless of arrival order.
        if r <= self._frozen_round:
            self.late_witnesses.append(eid)
            if self.metrics is not None:
                self.metrics.count("consensus_late_witnesses")
        self.is_witness[eid] = True
        slots = self.wit_list.setdefault(r, [])
        # slot order (insertion order) is load-bearing: decide_fame scans
        # wit_list in slot order and the device pipeline mirrors it.
        self.wit_slot[eid] = len(slots)
        slots.append(eid)
        self.witnesses.setdefault(r, {}).setdefault(self.hg[eid].c, []).append(eid)
        self.famous[eid] = None
        self._next_vote_round[eid] = r + 1

    def _parent_round(self, sp: bytes, op: bytes) -> int:
        """Base round of a new event before witness promotion: the max of
        its parents' rounds (a seam of the reference's model checker)."""
        return max(self.round[sp], self.round[op])

    def divide_rounds(self, new_ids: Iterable[bytes]) -> None:
        """Assign round numbers and witness flags to ``new_ids`` (topo order).

        The reference prototype's ``divide_rounds``, hot loop 1.
        """
        for eid in new_ids:
            ev = self.hg[eid]
            if not ev.p:
                self.round[eid] = 0
                self._register_witness(eid, 0)
                continue
            sp, op = ev.p
            r = self._parent_round(sp, op)
            # promotion: strongly-seen round-r witnesses, distinct creators
            amount = 0
            for c, wids in self.witnesses.get(r, {}).items():
                if any(self.strongly_sees(eid, w) for w in wids):
                    amount += self.stake[c]
            if 3 * amount > 2 * self.tot_stake:
                r += 1
            self.round[eid] = r
            self.max_round = max(self.max_round, r)
            if self.round[sp] < r:
                self._register_witness(eid, r)
            else:
                self.is_witness[eid] = False

    def _vote_tally(self, y: bytes, x: bytes, ry: int) -> Tuple[int, int]:
        """Stake tallies (yes, no) over distinct creators of the round-(ry-1)
        witnesses y strongly sees, using their (lazily computed) votes on x."""
        yes = no = 0
        for c, wids in self.witnesses.get(ry - 1, {}).items():
            c_yes = c_no = False
            for w in wids:
                if self.strongly_sees(y, w):
                    if self._vote(w, x):
                        c_yes = True
                    else:
                        c_no = True
            if c_yes:
                yes += self.stake[c]
            if c_no:
                no += self.stake[c]
        return yes, no

    def _vote(self, y: bytes, x: bytes) -> bool:
        """The vote of witness y on witness x — a memoized pure function of
        the DAG (strongly-seen witnesses are ancestors of y, so every vote a
        tally references exists whenever y exists; arrival order cannot
        change any value)."""
        key = (y, x)
        memo = self.votes.get(key)
        if memo is not None:
            return memo
        d = self.round[y] - self.round[x]
        if d <= 1:
            v = self.sees(y, x)
        else:
            yes, no = self._vote_tally(y, x, self.round[y])
            v = yes >= no
            if d % self.config.coin_period == 0 and not (
                3 * max(yes, no) > 2 * self.tot_stake
            ):
                v = bool(self.hg[y].coin_bit())  # coin flip from signature
        self.votes[key] = v
        return v

    def decide_fame(self) -> None:
        """Virtual fame voting (reference ``Node.decide_fame``, hot loop 2).

        Fame of x is the majority value at the chronologically first
        non-coin round where some witness's tally reaches a stake
        supermajority.  Vote values are pure functions of the DAG
        (see :meth:`_vote`), so incremental processing converges to the
        same fame assignment as a batch pass over the final DAG.
        """
        C = self.config.coin_period
        for rx in sorted(self.wit_list):
            for x in self.wit_list[rx]:
                if self.famous[x] is not None:
                    continue
                for ry in range(max(self._next_vote_round[x], rx + 2), self.max_round + 1):
                    d = ry - rx
                    decided = False
                    if d % C != 0:
                        for y in self.wit_list.get(ry, []):
                            yes, no = self._vote_tally(y, x, ry)
                            if 3 * max(yes, no) > 2 * self.tot_stake:
                                self.famous[x] = yes >= no
                                decided = True
                                if self.famous[x] and rx <= self._frozen_round:
                                    # a late witness decided FAMOUS would
                                    # retroactively change a committed
                                    # round's UFW set — impossible below
                                    # 1/3 equivocating stake; surfaced,
                                    # never silently absorbed
                                    self.horizon_violations += 1
                                    if self.metrics is not None:
                                        self.metrics.count(
                                            "consensus_horizon_violations"
                                        )
                                break
                    self._next_vote_round[x] = ry + 1
                    if decided:
                        break

    def _fame_complete(self, r: int) -> bool:
        if self.max_round < r + 2:
            return False
        return all(self.famous[w] is not None for w in self.wit_list.get(r, []))

    def _self_chain(self, w: bytes) -> List[bytes]:
        """w's self-ancestor chain, genesis first (explicit pointer walk so
        forked creators are handled)."""
        chain = []
        cur: Optional[bytes] = w
        while cur is not None:
            chain.append(cur)
            cur = self.hg[cur].self_parent
        chain.reverse()
        return chain

    def _earliest_seeing_ts(self, w: bytes, x: bytes) -> int:
        """Timestamp of the earliest self-ancestor of w that has x as an
        ancestor (binary search: ancestry is monotone along the self-chain)."""
        chain = self._self_chain(w)
        lo, hi = 0, len(chain) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if self.in_anc(chain[mid], x):
                hi = mid
            else:
                lo = mid + 1
        return self.hg[chain[lo]].t

    def find_order(self) -> None:
        """Extract the consensus order (reference ``Node.find_order``, hot
        loop 3).  Processes fame-complete rounds in ascending order."""
        while self._fame_complete(self.consensus_round):
            r = self.consensus_round
            # unique famous witnesses: creators with exactly one famous witness
            ufw: List[bytes] = []
            for c, wids in self.witnesses.get(r, {}).items():
                fam = [w for w in wids if self.famous[w]]
                if len(fam) == 1:
                    ufw.append(fam[0])
            ufw.sort(key=lambda w: self.idx[w])
            self._frozen_round = r
            self.consensus_round += 1
            if not ufw:
                continue
            whiten = bytes(crypto.SIG_BYTES)
            for w in ufw:
                whiten = xor_bytes(whiten, self.hg[w].s)
            received: List[Tuple[int, bytes, bytes]] = []
            remaining: List[bytes] = []
            for x in self.tbd:
                if all(self.in_anc(w, x) for w in ufw):
                    ts = sorted(self._earliest_seeing_ts(w, x) for w in ufw)
                    med = ts[(len(ts) - 1) // 2]
                    self.round_received[x] = r
                    self.consensus_ts[x] = med
                    tie = crypto.hash_bytes(whiten + x)
                    received.append((med, tie, x))
                else:
                    remaining.append(x)
            self.tbd = remaining
            received.sort(key=lambda item: (item[0], item[1]))
            fin = self.finality
            now = self._clock() if fin is not None else None
            for med, _tie, x in received:
                self.consensus.append(x)
                self.transactions.append(self.hg[x].d)
                if fin is not None:
                    # rounds_to_decision = round_received - round is a pure
                    # DAG function; birth is the event's creation stamp, so
                    # time_to_finality is logical ticks under a sim clock
                    fin.record_decided(
                        x, self.round[x], r, birth=self.hg[x].t, now=now,
                    )
            if fin is not None and received:
                fin.set_watermark(
                    self.flightrec_label
                    if self.flightrec_label is not None
                    else self.pk[:4].hex(),
                    len(self.consensus), r,
                )

    # ------------------------------------------------------------- main loop

    def consensus_pass(self, new_ids: List[bytes]) -> None:
        """The three consensus calls in reference order — the pluggable
        seam.  ``config.backend == "tpu"`` routes the pass through the
        batched pipeline on the card (:class:`~tpu_swirld_torch.backend.
        TorchEngine`, built here on its default device ``"cuda"`` unless
        ``_tpu_engine`` was set beforehand), producing bit-identical state.
        Without a card that build raises: a ``"tpu"`` node never falls back
        to the oracle."""
        if self.config.backend == "tpu":
            if self._tpu_engine is None:
                from tpu_swirld_torch.backend import TorchEngine

                self._tpu_engine = TorchEngine(self)
            if self.metrics is None and self.tracer is None:
                self._tpu_engine.consensus_pass(new_ids)
            else:
                before = len(self.consensus) if self.metrics is not None else 0
                with phase_scope(self.metrics, self.tracer, "tpu_pipeline"):
                    self._tpu_engine.consensus_pass(new_ids)
                if self.metrics is not None:
                    self.metrics.count("events_processed", len(new_ids))
                    self.metrics.count(
                        "events_ordered", len(self.consensus) - before
                    )
            return
        if self.metrics is None and self.tracer is None:
            self.divide_rounds(new_ids)
            self.decide_fame()
            self.find_order()
            return
        before = len(self.consensus) if self.metrics is not None else 0
        with phase_scope(self.metrics, self.tracer, "divide_rounds"):
            self.divide_rounds(new_ids)
        with phase_scope(self.metrics, self.tracer, "decide_fame"):
            self.decide_fame()
        with phase_scope(self.metrics, self.tracer, "find_order"):
            self.find_order()
        if self.metrics is not None:
            self.metrics.count("events_processed", len(new_ids))
            self.metrics.count("events_ordered", len(self.consensus) - before)

    def main(self, pick_peer: Callable[[], bytes], payload_fn=None):
        """Coroutine: each resume gossips with one random peer and runs a
        consensus pass (reference ``Node.main``)."""
        while True:
            payload = payload_fn() if payload_fn else b""
            peer = pick_peer()
            new_ids = self.sync(peer, payload)
            self.consensus_pass(new_ids)
            yield new_ids
