"""Membership transaction wire format (``MTX1``): a copy of the
reference's ``tpu_swirld/membership/txs.py``, byte for byte the same
encoding.

Join/leave/restake requests ride ordinary event payloads, so they flow
through gossip, ordering, and the decided log exactly like application
transactions — a membership change is "decided" precisely when the round
containing its carrier event is fame-complete and the event is assigned
a ``round_received``.  The format is deliberately tiny and fixed-layout
(no pickle, no varints beyond the one length byte for the key):

    ``b"MTX1" + kind(1) + keylen(1) + pk(keylen) + stake(u32 LE)``

``stake`` is meaningful for JOIN (initial stake) and RESTAKE (new
stake); LEAVE carries 0.  A payload either parses as exactly one
membership transaction or is treated as opaque application data —
:func:`decode_tx` never raises on foreign payloads.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

MAGIC = b"MTX1"
JOIN = 1
LEAVE = 2
RESTAKE = 3

_KINDS = {JOIN: "join", LEAVE: "leave", RESTAKE: "restake"}

MAX_TX_STAKE = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class MembershipTx:
    """One decoded membership transaction."""

    kind: int          # JOIN | LEAVE | RESTAKE
    pk: bytes          # subject member public key
    stake: int         # JOIN: initial stake; RESTAKE: new stake; LEAVE: 0

    @property
    def kind_name(self) -> str:
        return _KINDS.get(self.kind, f"?{self.kind}")


def encode_tx(tx: MembershipTx) -> bytes:
    if tx.kind not in _KINDS:
        raise ValueError(f"unknown membership tx kind {tx.kind}")
    if not 0 <= tx.stake <= MAX_TX_STAKE:
        raise ValueError(f"stake {tx.stake} out of u32 range")
    if not 0 < len(tx.pk) <= 255:
        raise ValueError("bad member key length")
    return (
        MAGIC
        + bytes([tx.kind, len(tx.pk)])
        + tx.pk
        + struct.pack("<I", tx.stake)
    )


def decode_tx(payload: bytes) -> Optional[MembershipTx]:
    """Parse ``payload`` as a membership tx; ``None`` for foreign data.

    Tolerant by design (gossip payloads are arbitrary bytes), but strict
    once the magic matches: a payload that *claims* to be an MTX and is
    malformed is still ``None`` — a half-parsed membership change must
    never take effect.
    """
    if len(payload) < len(MAGIC) + 2 or not payload.startswith(MAGIC):
        return None
    kind = payload[4]
    klen = payload[5]
    if kind not in _KINDS or klen == 0:
        return None
    end = 6 + klen + 4
    if len(payload) != end:
        return None
    pk = payload[6 : 6 + klen]
    (stake,) = struct.unpack_from("<I", payload, 6 + klen)
    if kind == JOIN and stake == 0:
        return None           # a zero-stake join is a no-op by definition
    if kind == LEAVE and stake != 0:
        return None
    return MembershipTx(kind=kind, pk=pk, stake=int(stake))


def join_payload(pk: bytes, stake: int) -> bytes:
    return encode_tx(MembershipTx(JOIN, pk, stake))


def leave_payload(pk: bytes) -> bytes:
    return encode_tx(MembershipTx(LEAVE, pk, 0))


def restake_payload(pk: bytes, stake: int) -> bytes:
    return encode_tx(MembershipTx(RESTAKE, pk, stake))
