"""Dynamic membership: consensus-agreed, epoch-versioned member sets (the
port's copy of the reference's ``tpu_swirld/membership`` package, with its
exports).

Submodules:

- ``txs``      — the ``MTX1`` membership-transaction wire format
                 (join / leave / restake payloads riding ordinary events);
- ``epoch``    — :class:`MemberEpoch` / :class:`EpochLedger`: the
                 append-only, consensus-derived epoch sequence;
- ``dynamic``  — :class:`DynamicNode`, the oracle engine with per-round
                 epoch stake, gossip pre-admission, and deterministic
                 restatement;
- ``repack``   — the member-axis repack pass at epoch activation, on the
                 device;
- ``engine``   — :func:`run_dynamic` drivers for all five engines, the
                 device ones on ``device`` (default ``"cuda"``);
- ``sim``      — dynamic-population gossip simulations + churn schedules.
"""

from tpu_swirld_torch.membership.epoch import (
    DEFAULT_DELAY,
    EpochLedger,
    MemberEpoch,
    activation_round,
    ledger_from_decided,
)
from tpu_swirld_torch.membership.txs import (
    JOIN,
    LEAVE,
    RESTAKE,
    MembershipTx,
    decode_tx,
    encode_tx,
    join_payload,
    leave_payload,
    restake_payload,
)

__all__ = [
    "DEFAULT_DELAY",
    "EpochLedger",
    "MemberEpoch",
    "MembershipTx",
    "JOIN",
    "LEAVE",
    "RESTAKE",
    "activation_round",
    "decode_tx",
    "encode_tx",
    "join_payload",
    "leave_payload",
    "ledger_from_decided",
    "restake_payload",
]
