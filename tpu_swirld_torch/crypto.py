"""Event hashing and the simulation signer (copy of the reference's
``tpu_swirld/crypto.py`` hash and sim-signer primitives, and of
``oracle/node.py::xor_bytes``).

Only the *simulation* signature scheme is carried over: ``sig =
BLAKE2b(pk || body)``, deterministic and publicly recomputable, with no
unforgeability.  It needs nothing beyond ``hashlib``, so DAGs generated by
:mod:`tpu_swirld_torch.sim` have the same event ids as the reference's under
``tpu_swirld.crypto.set_backend("sim")``.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

HASH_BYTES = 32
SIG_BYTES = 64

DOMAIN_EVENT = b"EVNT:"


def hash_bytes(data: bytes) -> bytes:
    """BLAKE2b-256 generic hash (event ids, whitening)."""
    return hashlib.blake2b(data, digest_size=HASH_BYTES).digest()


class SimSigner:
    """Deterministic, NON-SECURE simulation signatures (publicly
    recomputable: sig = BLAKE2b(pk || body))."""

    def keypair(self, seed: bytes) -> Tuple[bytes, bytes]:
        sk = hashlib.blake2b(b"sk" + seed, digest_size=32).digest()
        pk = hashlib.blake2b(b"pk" + sk, digest_size=32).digest()
        return pk, sk

    def sign(self, body: bytes, sk: bytes) -> bytes:
        pk = hashlib.blake2b(b"pk" + sk, digest_size=32).digest()
        return hashlib.blake2b(pk + body, digest_size=SIG_BYTES).digest()


SIGNER = SimSigner()


def coin_bit(sig: bytes) -> int:
    """Pseudo-random coin-round bit: low bit of the signature's middle byte."""
    return sig[len(sig) // 2] & 1


def xor_bytes(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))
