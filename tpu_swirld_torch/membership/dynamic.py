"""Dynamic-membership oracle engine: :class:`DynamicNode` (a copy of the
reference's ``tpu_swirld/membership/dynamic.py`` over the port's
:class:`~tpu_swirld_torch.oracle.node.Node`; the same states give the same
``state_digest`` in both packages).  Its strongly-sees tally and its
self-chain walk take shortcuts that give the reference's answers about 8x
faster (:meth:`DynamicNode.strongly_sees`): the observer replay of
``membership.engine`` runs it over whole DAGs.

A :class:`~tpu_swirld_torch.oracle.node.Node` whose member set is the
consensus-decided, epoch-versioned quantity of
:mod:`tpu_swirld_torch.membership.epoch`.  Single-epoch behaviour (no decided
membership transactions) is bit-identical to the base node with the same
stake vector; everything below only engages once a ``MTX1`` payload
decides.

Semantics (the spec every engine follows):

- **Per-round stake.**  Every supermajority in rounds/fame/ordering is
  taken against the stake of the epoch governing the relevant round:
  witness promotion *into* round ``r+1`` and ``strongly_sees(x, w)`` for
  a round-``r`` witness ``w`` use ``epoch_at(r)``; a fame tally at voting
  round ``ry`` counts the round-``ry-1`` witnesses' creators at
  ``epoch_at(ry-1)``.  No tally ever mixes two epochs.
- **Witness gating.**  A creator with zero stake in ``epoch_at(r)`` is
  never a round-``r`` witness.  Joiners' pre-activation events (and
  leavers' post-departure events) still enter the DAG and still get
  ordered — they just carry no voting power, which is exactly how the
  whitepaper's stake weighting generalizes the count quorum.
- **Activation.**  A tx decided in round ``rd`` (the ``round_received``
  of its carrier event) activates at ``rd + membership_delay``.  With
  the default delay, honest gossip decides fame well before events reach
  the activation round, so the incremental path simply adopts the epoch.
- **Restatement.**  If a decided tx's activation round is at or below a
  round this node has *already assigned* (possible under extreme lag or
  an adversarial schedule), incremental adoption would be order-
  dependent.  The node instead restates: a full deterministic recompute
  of rounds/fame/order from its own DAG, iterated to a ledger fixpoint
  from the genesis epoch.  The final state is thereby a pure function of
  the DAG — nodes with different arrival orders (and nodes that never
  needed to restate) converge on identical state.
- **Gossip admission.**  Seeing a JOIN payload (decided or not)
  pre-admits the subject key for *gossip only*: its events validate,
  park, and relay, but it holds no stake until its epoch activates.  The
  sync height vector covers the decided registry prefix (consensus-
  ordered, so positionally consistent across nodes — parsed prefix-
  tolerantly); pending members' events ship wholesale until the join
  decides.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from tpu_swirld_torch import crypto
from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.event import MAX_KEY, MAX_PAYLOAD, Event
from tpu_swirld_torch.membership.epoch import (
    DEFAULT_DELAY,
    EpochLedger,
    activation_round,
)
from tpu_swirld_torch.membership.txs import JOIN, decode_tx
from tpu_swirld_torch.oracle.node import Node

#: restatement fixpoint cap: each iteration is a full recompute, and the
#: ledger grows monotonically per iteration, so honest runs converge in
#: two.  Past the cap the last iterate is kept — still a pure function
#: of the DAG, so every node lands on the same state.
MAX_RESTATES = 8


class DynamicNode(Node):
    """Oracle node with a consensus-decided, epoch-versioned member set."""

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
        transport=None,
    ):
        config = config or SwirldConfig(n_members=len(members))
        if config.backend != "python":
            raise ValueError(
                "DynamicNode drives the oracle engine; device engines go "
                "through tpu_swirld_torch.membership.engine"
            )
        # membership state must exist before super().__init__ runs: the
        # base constructor mints + rounds the genesis event through the
        # overridden consensus methods below
        self.membership_delay = int(
            getattr(config, "membership_delay", DEFAULT_DELAY)
        )
        self._genesis_members: Tuple[bytes, ...] = tuple(members)
        self._genesis_stake: Tuple[int, ...] = tuple(config.stakes())
        self.ledger: EpochLedger = EpochLedger.genesis(
            self._genesis_members, self._genesis_stake
        )
        self._next_ledger: Optional[EpochLedger] = None
        self._restating = False
        self.restatements = 0              # bench/obs: full recomputes
        self.repacks = 0                   # bench/obs: member-axis extensions
        self._seen_joins: Dict[bytes, int] = {}   # pk -> requested stake
        self.pending_members: Dict[bytes, int] = {}  # pk -> first-seen order
        self.fame_epoch_log: List[Tuple[bytes, int, int]] = []
        #   (witness id, voting round ry, epoch id whose stake was tallied)
        self._tips_memo: Dict[bytes, Dict[bytes, int]] = {}
        self._bounds: Dict[bytes, Tuple[Dict[bytes, int], Dict[bytes, int]]] = {}
        self._chain_memo: Dict[bytes, List[bytes]] = {}
        super().__init__(
            sk=sk, pk=pk, network=network, members=members, config=config,
            clock=clock, create_genesis=False, network_want=network_want,
            transport=transport,
        )
        if pk not in self.member_index:
            # a joining node: not yet in the decided registry; self-admit
            # for gossip so our own events (starting with genesis) exist
            self._note_pending(pk, 0)
        if create_genesis:
            genesis = Event(d=b"", p=(), t=self._now(), c=pk).signed(sk)
            self.add_event(genesis)
            self.divide_rounds([genesis.id])

    # --------------------------------------------------- stake addressing

    def _stake_at(self, pk: bytes, r: int) -> int:
        return self.ledger.stake_at(pk, r)

    def _tot_at(self, r: int) -> int:
        return self.ledger.total_at(r)

    def _activation_round(self, round_received: int) -> int:
        """The activation seam; the ledger it builds is held against the
        canonical :func:`~tpu_swirld_torch.membership.epoch.activation_round`
        by :func:`~tpu_swirld_torch.membership.epoch.ledger_from_decided`."""
        return activation_round(round_received, self.membership_delay)

    # ---------------------------------------------------- gossip admission

    def _admit_gossip(self, pk: bytes) -> None:
        if pk in self.member_mask:
            return
        self.member_mask[pk] = 0
        self.member_events[pk] = []
        self.member_chain[pk] = []
        self.by_seq[pk] = {}
        self.branch_tips[pk] = set()
        self.fork_groups[pk] = {}
        self.has_fork[pk] = False

    def _note_pending(self, pk: bytes, stake: int) -> None:
        self._seen_joins.setdefault(pk, int(stake))
        if pk not in self.member_index and pk not in self.pending_members:
            self.pending_members[pk] = len(self.pending_members)
            self._admit_gossip(pk)

    def _known_creator(self, pk: bytes) -> bool:
        return pk in self.member_index or pk in self.pending_members

    def is_valid_event(self, ev: Event) -> bool:
        if len(ev.d) > MAX_PAYLOAD or len(ev.c) > MAX_KEY:
            return False
        if not self._known_creator(ev.c):
            return False
        if not ev.verify():
            return False
        if len(ev.p) not in (0, 2):
            return False
        if ev.p:
            sp, op = ev.p
            if sp not in self.hg or op not in self.hg:
                return False
            if self.hg[sp].c != ev.c:
                return False
            if self.hg[op].c == ev.c:
                return False
        return True

    def _plausible(self, ev: Event) -> bool:
        return (
            len(ev.d) <= MAX_PAYLOAD
            and len(ev.c) <= MAX_KEY
            and self._known_creator(ev.c)
            and ev.verify()
        )

    def add_event(self, ev: Event) -> bool:
        # a JOIN payload pre-admits its subject for gossip the moment any
        # carrier event lands (decided or not) — ingest before admission
        # would reject the joiner's events as unknown-creator
        tx = decode_tx(ev.d)
        if tx is not None and tx.kind == JOIN:
            self._note_pending(tx.pk, tx.stake)
        added = super().add_event(ev)
        return added

    def heights(self) -> Dict[bytes, int]:
        return {m: len(self.member_events[m]) for m in self.members}

    def ask_sync(self, from_pk: bytes, signed_heights: bytes) -> bytes:
        """Prefix-tolerant sync serve (see the base method for the fork
        digest rationale).  The height vector covers the asker's decided
        registry prefix — ours may be longer or shorter, so the vector is
        matched positionally against our registry: missing entries read
        as 0, surplus entries (members the asker decided before us) are
        ignored.  Events by gossip-pending creators ship wholesale."""
        if not self._known_creator(from_pk):
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
        if len(payload) % 4 != 0:
            self.bad_requests += 1
            raise ValueError("malformed sync-request height vector")
        heights: Dict[bytes, int] = {}
        off = 0
        for m in self.members:
            if off + 4 <= len(payload):
                heights[m] = int.from_bytes(payload[off : off + 4], "little")
            else:
                heights[m] = 0
            off += 4
        missing: List[bytes] = []
        for m in self.members:
            known = self.member_events[m]
            if not self.has_fork[m]:
                missing.extend(known[heights[m]:])
                continue
            miss = max(len(known) - heights[m], 0)
            extra: set = set()
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
        for pk in sorted(self.pending_members, key=self.pending_members.get):
            missing.extend(self.member_events.get(pk, []))
        return self._sign_event_blob(missing)

    def sync(self, peer_pk: bytes, payload: bytes) -> List[bytes]:
        new_ids = self.pull(peer_pk)
        peer_events = self.member_events.get(peer_pk, [])
        if not peer_events:
            return new_ids
        mine = self.new_event(payload, peer_events[-1])
        self.add_event(mine)
        new_ids.append(mine.id)
        return new_ids

    # -------------------------------------------------- consensus (epochal)

    def strongly_sees(self, x: bytes, w: bytes) -> bool:
        """The reference's epochal tally, computed faster with the same
        answer.  The loop stops once the answer is settled (a
        supermajority reached, or out of reach).  A member m that has not
        forked, with a witness w whose creator has not forked, is tested
        without :meth:`_sees_through`'s search: x sees w through m iff m's
        last event in x's ancestry, at seq t (:meth:`_tips`), has w as an
        ancestor; along m's chain that holds from some seq on, so each
        (w, m) keeps the highest seq known not to and the lowest known to,
        and a bit of the ancestry is read only between the two."""
        anc = self.anc
        iw = self.idx[w]
        if not (anc[x] >> iw) & 1:
            return False
        key = (x, w)
        memo = self._ss_memo.get(key)
        if memo is not None:
            return memo
        epoch = self.ledger.epoch_at(self.round[w])
        need = 2 * epoch.total_stake
        left = epoch.total_stake       # stake not yet looked at
        amount = 0
        has_fork = self.has_fork
        w_forked = has_fork[self.hg[w].c]
        tips = self._tips(x)
        bounds = self._bounds.get(w)
        if bounds is None:
            bounds = self._bounds[w] = ({}, {})
        below, above = bounds          # m -> seq not seeing w / seeing w
        chains = self.member_chain
        for m, s in zip(epoch.members, epoch.stake):
            if s <= 0:
                continue
            left -= s
            if w_forked or has_fork[m]:
                seen = self._sees_through(x, w, m)
            else:
                t = tips.get(m)
                if t is None:
                    seen = False
                elif t >= above.get(m, t + 1):
                    seen = True
                elif t <= below.get(m, -1):
                    seen = False
                else:
                    seen = (anc[chains[m][t]] >> iw) & 1 == 1
                    (above if seen else below)[m] = t
            if seen:
                amount += s
                if 3 * amount > need:
                    break
            elif 3 * (amount + left) <= need:
                break
        result = 3 * amount > need
        self._ss_memo[key] = result
        return result

    def _tips(self, x: bytes) -> Dict[bytes, int]:
        """Member -> the seq of its last event in x's ancestry, for every
        member with one that had not forked when first asked (the event
        :meth:`_sees_through` searches from).  A function of the DAG alone
        (x's ancestors are all stored before x, and an unforked member's
        chain only grows at its end), so it is kept for good; a member that
        forks later is never read from it again."""
        tips = self._tips_memo.get(x)
        if tips is None:
            a = self.anc[x]
            has_fork = self.has_fork
            tips = {}
            for m, mask in self.member_mask.items():
                if not has_fork[m]:
                    cnt = (a & mask).bit_count()
                    if cnt:
                        tips[m] = cnt - 1
            self._tips_memo[x] = tips
        return tips

    def _self_chain(self, w: bytes) -> List[bytes]:
        """The base walk, kept per witness: a self-ancestor chain is a
        function of the DAG alone, and order extraction asks for the same
        witnesses' chains once per event it receives."""
        chain = self._chain_memo.get(w)
        if chain is None:
            chain = self._chain_memo[w] = super()._self_chain(w)
        return chain

    def divide_rounds(self, new_ids: Iterable[bytes]) -> None:
        for eid in new_ids:
            ev = self.hg[eid]
            if not ev.p:
                self.round[eid] = 0
                if self._stake_at(ev.c, 0) > 0:
                    self._register_witness(eid, 0)
                else:
                    self.is_witness[eid] = False
                continue
            sp, op = ev.p
            r = self._parent_round(sp, op)
            amount = 0
            for c, wids in self.witnesses.get(r, {}).items():
                if any(self.strongly_sees(eid, w) for w in wids):
                    amount += self._stake_at(c, r)
            if 3 * amount > 2 * self._tot_at(r):
                r += 1
            self.round[eid] = r
            self.max_round = max(self.max_round, r)
            if self.round[sp] < r and self._stake_at(ev.c, r) > 0:
                self._register_witness(eid, r)
            else:
                self.is_witness[eid] = False

    def _vote_tally(self, y: bytes, x: bytes, ry: int) -> Tuple[int, int]:
        yes = no = 0
        for c, wids in self.witnesses.get(ry - 1, {}).items():
            c_yes = c_no = False
            for w in wids:
                if self.strongly_sees(y, w):
                    if self._vote(w, x):
                        c_yes = True
                    else:
                        c_no = True
            s = self._stake_at(c, ry - 1)
            if c_yes:
                yes += s
            if c_no:
                no += s
        return yes, no

    def _vote(self, y: bytes, x: bytes) -> bool:
        key = (y, x)
        memo = self.votes.get(key)
        if memo is not None:
            return memo
        d = self.round[y] - self.round[x]
        if d <= 1:
            v = self.sees(y, x)
        else:
            ry = self.round[y]
            yes, no = self._vote_tally(y, x, ry)
            v = yes >= no
            if d % self.config.coin_period == 0 and not (
                3 * max(yes, no) > 2 * self._tot_at(ry - 1)
            ):
                v = bool(self.hg[y].coin_bit())
        self.votes[key] = v
        return v

    def decide_fame(self) -> None:
        C = self.config.coin_period
        for rx in sorted(self.wit_list):
            for x in self.wit_list[rx]:
                if self.famous[x] is not None:
                    continue
                for ry in range(
                    max(self._next_vote_round[x], rx + 2), self.max_round + 1
                ):
                    d = ry - rx
                    decided = False
                    if d % C != 0:
                        epoch = self.ledger.epoch_at(ry - 1)
                        for y in self.wit_list.get(ry, []):
                            yes, no = self._vote_tally(y, x, ry)
                            if 3 * max(yes, no) > 2 * epoch.total_stake:
                                self.famous[x] = yes >= no
                                self.fame_epoch_log.append(
                                    (x, ry, epoch.epoch_id)
                                )
                                decided = True
                                if self.famous[x] and rx <= self._frozen_round:
                                    self.horizon_violations += 1
                                    if self.metrics is not None:
                                        self.metrics.count(
                                            "consensus_horizon_violations"
                                        )
                                break
                    self._next_vote_round[x] = ry + 1
                    if decided:
                        break

    # --------------------------------------------- decided-tx application

    def find_order(self) -> None:
        before = len(self.consensus)
        super().find_order()
        self._process_decided_txs(before)
        if not self._restating:
            self._refresh_current_epoch()

    def _process_decided_txs(self, start: int) -> None:
        need_restate = False
        for x in self.consensus[start:]:
            tx = decode_tx(self.hg[x].d)
            if tx is None:
                continue
            act = self._activation_round(self.round_received[x])
            if self._restating:
                self._next_ledger = self._next_ledger.apply(tx, act, x)
                continue
            new = self.ledger.apply(tx, act, x)
            grew = not new.same_epochs(self.ledger)
            self.ledger = new
            if grew:
                self._sync_registry_with_ledger()
                if new.head.activation_round <= self.max_round:
                    # an already-assigned round falls under the new
                    # epoch: incremental adoption would be arrival-order
                    # dependent — restate from scratch instead
                    need_restate = True
        if need_restate:
            self._restate()

    def _sync_registry_with_ledger(self) -> None:
        """Adopt the ledger's union registry as the decided member list
        (gossip surface + fork budget); newly decided members leave the
        pending set.  One member-axis extension == one repack."""
        registry = self.ledger.registry
        if len(registry) > len(self.members):
            self.repacks += 1
        for pk in registry:
            if pk not in self.member_index:
                self.member_index[pk] = len(self.members)
                self.members.append(pk)
                self._admit_gossip(pk)
                self.pending_members.pop(pk, None)

    def _refresh_current_epoch(self) -> None:
        epoch = self.ledger.epoch_at(self.max_round)
        self.stake = {m: epoch.stake_of(m) for m in self.members}
        self.tot_stake = epoch.total_stake

    # --------------------------------------------------------- restatement

    def _restate(self) -> None:
        """Deterministic full recompute to a ledger fixpoint.

        Iterates: freeze the candidate ledger, replay the whole DAG
        (rounds/fame/order) under it, collect the ledger its decided
        prefix implies; repeat until the epochs stabilize.  The result is
        a pure function of the DAG — independent of arrival order and of
        whether a peer got here incrementally."""
        if self._restating:
            return
        self._restating = True
        fin, self.finality = self.finality, None
        met, self.metrics = self.metrics, None
        rec, self.flightrec = self.flightrec, None
        try:
            current = self.ledger
            for _ in range(MAX_RESTATES):
                self._reset_consensus_state(current)
                self._next_ledger = EpochLedger.genesis(
                    self._genesis_members, self._genesis_stake
                )
                self.divide_rounds(list(self.order_added))
                self.decide_fame()
                self.find_order()
                new = self._next_ledger
                self._next_ledger = None
                stable = new.same_epochs(current)
                current = new
                self.ledger = new
                if stable:
                    break
            self.restatements += 1
        finally:
            self._restating = False
            self.finality = fin
            self.metrics = met
            self.flightrec = rec
        self._sync_registry_with_ledger()
        self._refresh_current_epoch()

    def _reset_consensus_state(self, ledger: EpochLedger) -> None:
        self.ledger = ledger
        self._sync_registry_with_ledger()
        self.round = {}
        self.is_witness = {}
        self.witnesses = {}
        self.wit_list = {}
        self.wit_slot = {}
        self._ss_memo = {}
        self.votes = {}
        self._next_vote_round = {}
        self.famous = {}
        self.fame_epoch_log = []
        self.max_round = 0
        self._frozen_round = -1
        self.late_witnesses = []
        self.horizon_violations = 0
        self.tbd = list(self.order_added)
        self.round_received = {}
        self.consensus_ts = {}
        self.consensus = []
        self.transactions = []
        self.consensus_round = 0

    # --------------------------------------------------------------- obs

    @property
    def membership_epoch(self) -> int:
        """Epoch id governing the node's current round frontier."""
        return self.ledger.epoch_at(self.max_round).epoch_id

    @property
    def members_active(self) -> int:
        return self.ledger.epoch_at(self.max_round).members_active

    @property
    def stake_total(self) -> int:
        return self.ledger.epoch_at(self.max_round).total_stake

    def state_digest(self) -> bytes:
        return crypto.hash_bytes(
            super().state_digest() + self.ledger.digest()
        )


def joining_node(
    sk: bytes,
    pk: bytes,
    network: Dict[bytes, Callable],
    registry: Sequence[bytes],
    config: Optional[SwirldConfig] = None,
    **kwargs,
) -> DynamicNode:
    """Bootstrap a node that is *not yet* in the decided registry: it
    self-admits for gossip, mints its genesis, and gains stake only once
    some registry member's JOIN transaction for it decides and
    activates."""
    config = config or SwirldConfig(n_members=len(registry))
    return DynamicNode(
        sk=sk, pk=pk, network=network, members=registry, config=config,
        **kwargs,
    )
