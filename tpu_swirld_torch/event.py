"""The immutable hashgraph event record (copy of the reference's
``oracle/event.py`` record: same byte layout, same domain tag, so the same
event has the same id in both packages)."""

from __future__ import annotations

import dataclasses
import struct
from typing import Tuple

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

    def signed(self, sk: bytes) -> "Event":
        return dataclasses.replace(
            self, s=crypto.SIGNER.sign(crypto.DOMAIN_EVENT + self.body(), sk)
        )

    def coin_bit(self) -> int:
        return crypto.coin_bit(self.s)
