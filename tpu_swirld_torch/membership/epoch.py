"""Epoch-versioned member sets: :class:`MemberEpoch` + :class:`EpochLedger`
(a copy of the reference's ``tpu_swirld/membership/epoch.py``: the same
digests and the same ``to_meta`` documents for the same ``apply`` calls).

The member set is a consensus-decided quantity.  The ledger is an
append-only sequence of epochs derived purely from the decided prefix:
every decided membership transaction (``membership.txs``) schedules a
new epoch at a deterministic *activation round*, so every honest node
reconstructs bit-identical epochs from the same decided order.

Design invariants (load-bearing for the engines):

- **Union registry.**  ``epochs[k].members`` is always a *prefix* of
  ``epochs[k+1].members``: joins append, leaves zero the member's stake
  but never remove the row.  Member indices are therefore stable forever,
  which is what lets the device engines keep their member-indexed slabs
  (anc/sees, ssm columns, witness tables, fork-pair ledgers) across an
  epoch boundary — the repack pass only ever *appends* member rows and
  swaps the stake vector (``membership.repack``).
- **Functional updates.**  Ledgers are immutable; ``apply`` returns a new
  ledger, so a ledger may be shared between a node and a copy of it: no
  ledger is ever mutated in place.
- **Round-addressed.**  ``epoch_at(r)`` is the single source of truth for
  "whose stake governs round r".  Rounds below the first activation are
  governed by the genesis epoch; activation rounds are strictly
  increasing; transactions deciding in the same round merge into one
  epoch.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence, Tuple

from tpu_swirld_torch import crypto
from tpu_swirld_torch.membership.txs import (
    JOIN, LEAVE, RESTAKE, MembershipTx, decode_tx,
)

#: default number of rounds between a membership tx's decision
#: (round_received of its carrier event) and the first round the new
#: epoch's stake governs.  Honest gossip decides fame 2-3 rounds behind
#: round assignment, so 4 keeps activations ahead of every assigned
#: round in the common case — the incremental engines then adopt the new
#: epoch without a restatement.
DEFAULT_DELAY = 4


def activation_round(round_received: int, delay: int) -> int:
    """Canonical activation rule: a tx decided in round ``r`` governs
    from round ``r + delay``.  A free function, so a node's activation
    seam can be held against this canonical form."""
    return round_received + delay


@dataclasses.dataclass(frozen=True)
class MemberEpoch:
    """One epoch: an ordered member list + stake vector, governing all
    rounds in ``[activation_round, next epoch's activation)``."""

    epoch_id: int
    activation_round: int
    members: Tuple[bytes, ...]
    stake: Tuple[int, ...]

    def __post_init__(self):
        if len(self.members) != len(self.stake):
            raise ValueError("epoch members/stake length mismatch")

    @property
    def total_stake(self) -> int:
        return sum(self.stake)

    @property
    def members_active(self) -> int:
        return sum(1 for s in self.stake if s > 0)

    def stake_of(self, pk: bytes) -> int:
        try:
            return self.stake[self.members.index(pk)]
        except ValueError:
            return 0

    def digest(self) -> bytes:
        parts: List[bytes] = [
            b"EPOCH",
            self.epoch_id.to_bytes(4, "little"),
            self.activation_round.to_bytes(4, "little", signed=True),
            len(self.members).to_bytes(4, "little"),
        ]
        for m, s in zip(self.members, self.stake):
            parts.append(len(m).to_bytes(1, "little"))
            parts.append(m)
            parts.append(int(s).to_bytes(8, "little"))
        return crypto.hash_bytes(b"".join(parts))


@dataclasses.dataclass(frozen=True)
class EpochLedger:
    """Append-only epoch sequence (ascending, distinct activations)."""

    epochs: Tuple[MemberEpoch, ...]
    applied: frozenset = frozenset()   # carrier event ids already applied

    # ------------------------------------------------------------ build

    @classmethod
    def genesis(
        cls, members: Sequence[bytes], stake: Sequence[int]
    ) -> "EpochLedger":
        return cls(
            epochs=(
                MemberEpoch(
                    epoch_id=0,
                    activation_round=0,
                    members=tuple(members),
                    stake=tuple(int(s) for s in stake),
                ),
            ),
        )

    # ----------------------------------------------------------- lookup

    @property
    def head(self) -> MemberEpoch:
        """The newest (possibly not-yet-active) epoch."""
        return self.epochs[-1]

    @property
    def registry(self) -> Tuple[bytes, ...]:
        """The union member registry (the newest epoch's member list —
        a superset of every older epoch's by the prefix invariant)."""
        return self.epochs[-1].members

    def epoch_at(self, r: int) -> MemberEpoch:
        """The epoch governing round ``r``."""
        cur = self.epochs[0]
        for e in self.epochs[1:]:
            if e.activation_round > r:
                break
            cur = e
        return cur

    def stake_at(self, pk: bytes, r: int) -> int:
        return self.epoch_at(r).stake_of(pk)

    def total_at(self, r: int) -> int:
        return self.epoch_at(r).total_stake

    # ------------------------------------------------------------ apply

    def apply(
        self,
        tx: MembershipTx,
        activation: int,
        carrier: bytes,
    ) -> "EpochLedger":
        """Apply one decided membership tx, scheduling (or merging into)
        the epoch at ``max(activation, head activation)``.  Idempotent
        per carrier event; no-op transactions (re-join of a known key,
        leave/restake of an inactive one) return ``self`` unchanged —
        first-decided-wins."""
        if carrier in self.applied:
            return self
        head = self.epochs[-1]
        members = list(head.members)
        stake = list(head.stake)
        if tx.kind == JOIN:
            if tx.pk in head.members:
                return self._mark(carrier)
            members.append(tx.pk)
            stake.append(int(tx.stake))
        elif tx.kind == LEAVE:
            try:
                i = members.index(tx.pk)
            except ValueError:
                return self._mark(carrier)
            if stake[i] == 0:
                return self._mark(carrier)
            stake[i] = 0
        elif tx.kind == RESTAKE:
            try:
                i = members.index(tx.pk)
            except ValueError:
                return self._mark(carrier)
            if stake[i] == 0 or stake[i] == int(tx.stake):
                return self._mark(carrier)
            stake[i] = int(tx.stake)
        else:
            return self._mark(carrier)
        act = max(int(activation), head.activation_round)
        if act == head.activation_round and len(self.epochs) > 1:
            # same-round decisions merge into the pending epoch
            new_epoch = MemberEpoch(
                epoch_id=head.epoch_id,
                activation_round=act,
                members=tuple(members),
                stake=tuple(stake),
            )
            epochs = self.epochs[:-1] + (new_epoch,)
        else:
            if act <= head.activation_round:
                act = head.activation_round + 1
            new_epoch = MemberEpoch(
                epoch_id=head.epoch_id + 1,
                activation_round=act,
                members=tuple(members),
                stake=tuple(stake),
            )
            epochs = self.epochs + (new_epoch,)
        return EpochLedger(epochs=epochs, applied=self.applied | {carrier})

    def _mark(self, carrier: bytes) -> "EpochLedger":
        return EpochLedger(
            epochs=self.epochs, applied=self.applied | {carrier}
        )

    # ------------------------------------------------------- comparison

    def digest(self) -> bytes:
        """Canonical digest over all epochs (checkpoint integrity: a
        restored node re-derives the ledger from the decided prefix and
        refuses a checkpoint whose epoch digest disagrees)."""
        return crypto.hash_bytes(b"LEDGER" + b"".join(
            e.digest() for e in self.epochs
        ))

    def same_epochs(self, other: "EpochLedger") -> bool:
        return self.epochs == other.epochs

    # ------------------------------------------------------ persistence

    def to_meta(self) -> dict:
        return {
            "epochs": [
                {
                    "epoch_id": e.epoch_id,
                    "activation_round": e.activation_round,
                    "members": [m.hex() for m in e.members],
                    "stake": list(e.stake),
                }
                for e in self.epochs
            ],
            "digest": self.digest().hex(),
        }

    @classmethod
    def from_meta(cls, meta: dict) -> "EpochLedger":
        epochs = tuple(
            MemberEpoch(
                epoch_id=int(d["epoch_id"]),
                activation_round=int(d["activation_round"]),
                members=tuple(bytes.fromhex(m) for m in d["members"]),
                stake=tuple(int(s) for s in d["stake"]),
            )
            for d in meta["epochs"]
        )
        ledger = cls(epochs=epochs)
        if meta.get("digest") and ledger.digest().hex() != meta["digest"]:
            raise ValueError("epoch ledger digest mismatch")
        return ledger


def ledger_from_decided(
    decided: Iterable[Tuple[bytes, bytes, int]],
    genesis_members: Sequence[bytes],
    genesis_stake: Sequence[int],
    delay: int = DEFAULT_DELAY,
) -> EpochLedger:
    """Canonical ledger reconstruction from a decided prefix.

    ``decided`` yields ``(event_id, payload, round_received)`` in
    consensus order.  This is the independent reconstruction path a live
    node's ledger is checked against — it uses only the canonical
    :func:`activation_round` rule, so any activation skew in the live
    node's incremental path is a detectable divergence.
    """
    ledger = EpochLedger.genesis(genesis_members, genesis_stake)
    for eid, payload, r_received in decided:
        tx = decode_tx(payload)
        if tx is None:
            continue
        ledger = ledger.apply(
            tx, activation_round(r_received, delay), eid
        )
    return ledger
