"""The immutable hashgraph event record and its wire codec (copy of the
reference's ``oracle/event.py``: the same byte layout and domain tag, so the
same event has the same id in both packages, and an event encoded by either
package decodes in the other to the same bytes)."""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Tuple

from tpu_swirld_torch import crypto


@dataclasses.dataclass(frozen=True)
class Event:
    d: bytes                       # payload (opaque transaction bytes)
    p: Tuple[bytes, ...]           # () for genesis, else (self_parent, other_parent)
    t: int                         # creation timestamp (integer; never float)
    c: bytes                       # creator public key
    s: bytes = b""                 # detached signature over body()

    def body(self) -> bytes:
        """Deterministic serialization of everything except the signature."""
        parts = [struct.pack("<B", len(self.p))]
        parts.extend(self.p)
        parts.append(struct.pack("<q", self.t))
        parts.append(struct.pack("<I", len(self.c)))
        parts.append(self.c)
        parts.append(struct.pack("<I", len(self.d)))
        parts.append(self.d)
        return b"".join(parts)

    @property
    def id(self) -> bytes:
        return crypto.hash_bytes(self.body())

    @property
    def self_parent(self) -> Optional[bytes]:
        return self.p[0] if self.p else None

    @property
    def other_parent(self) -> Optional[bytes]:
        return self.p[1] if self.p else None

    def signed(self, sk: bytes) -> "Event":
        return dataclasses.replace(
            self, s=crypto.sign(self.body(), sk, crypto.DOMAIN_EVENT)
        )

    def verify(self) -> bool:
        return crypto.verify(self.body(), self.s, self.c, crypto.DOMAIN_EVENT)

    def coin_bit(self) -> int:
        return crypto.coin_bit(self.s)


def encode_event(ev: Event) -> bytes:
    """Wire encoding: body || sig (lengths are implicit in the body layout)."""
    body = ev.body()
    return struct.pack("<I", len(body)) + body + struct.pack("<I", len(ev.s)) + ev.s


class MalformedEvent(ValueError):
    """Raised when a wire blob cannot be decoded as an event."""


MAX_PAYLOAD = 1 << 20          # 1 MiB payload cap on the wire
MAX_KEY = 1 << 10


def _take(data: bytes, pos: int, n: int, what: str) -> Tuple[bytes, int]:
    if n < 0 or pos + n > len(data):
        raise MalformedEvent(f"truncated {what} (need {n} bytes at {pos})")
    return data[pos : pos + n], pos + n


def decode_event(data: bytes, offset: int = 0) -> Tuple[Event, int]:
    """Inverse of :func:`encode_event`; returns (event, next_offset).

    Bounds-checked: malformed or truncated bytes raise
    :class:`MalformedEvent` (a ``ValueError``) instead of crashing with
    ``struct.error`` or producing garbage slices.
    """
    raw, offset = _take(data, offset, 4, "body length")
    (blen,) = struct.unpack("<I", raw)
    if blen > 8 + MAX_PAYLOAD + MAX_KEY + 2 * crypto.HASH_BYTES + 16:
        raise MalformedEvent(f"oversized body ({blen} bytes)")
    body, offset = _take(data, offset, blen, "body")
    raw, offset = _take(data, offset, 4, "signature length")
    (slen,) = struct.unpack("<I", raw)
    if slen > 4 * crypto.SIG_BYTES:
        raise MalformedEvent(f"oversized signature ({slen} bytes)")
    sig, offset = _take(data, offset, slen, "signature")

    # the body layout written by Event.body()
    raw, pos = _take(body, 0, 1, "parent count")
    np_ = raw[0]
    if np_ not in (0, 2):
        raise MalformedEvent(f"bad parent count {np_}")
    parents = []
    for _ in range(np_):
        ph, pos = _take(body, pos, crypto.HASH_BYTES, "parent hash")
        parents.append(ph)
    raw, pos = _take(body, pos, 8, "timestamp")
    (t,) = struct.unpack("<q", raw)
    raw, pos = _take(body, pos, 4, "creator length")
    (clen,) = struct.unpack("<I", raw)
    if clen > MAX_KEY:
        raise MalformedEvent(f"oversized creator key ({clen} bytes)")
    c, pos = _take(body, pos, clen, "creator")
    raw, pos = _take(body, pos, 4, "payload length")
    (dlen,) = struct.unpack("<I", raw)
    if dlen > MAX_PAYLOAD:
        raise MalformedEvent(f"oversized payload ({dlen} bytes)")
    d, pos = _take(body, pos, dlen, "payload")
    if pos != len(body):
        raise MalformedEvent(f"{len(body) - pos} trailing bytes in body")
    return Event(d=d, p=tuple(parents), t=t, c=c, s=sig), offset
