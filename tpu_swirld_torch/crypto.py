"""Crypto backend: event hashing, keypairs, detached signatures (copy of
the reference's ``tpu_swirld/crypto.py``, and of ``oracle/node.py::
xor_bytes``).

- Hashing is BLAKE2b-256 from ``hashlib``.
- Signatures use real Ed25519 through the ``cryptography`` package when it
  imports, else the *simulation* scheme ``sig = BLAKE2b(pk || body)``:
  deterministic, 64 bytes wide and verifiable, but publicly recomputable,
  so it offers no unforgeability.  :func:`set_backend` picks one for the
  process, as in the reference.

The same seed gives the same keys, events and event ids in both packages
when both run the same backend: tests and ``chip_smoke.py`` call
``set_backend("sim")`` in each.  Coin-round bits are the low bit of the
signature's middle byte on both backends.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

HASH_BYTES = 32
SIG_BYTES = 64


def hash_bytes(data: bytes) -> bytes:
    """BLAKE2b-256 generic hash (event ids, whitening)."""
    return hashlib.blake2b(data, digest_size=HASH_BYTES).digest()


class SimSigner:
    """Deterministic, verifiable, NON-SECURE simulation signatures."""

    name = "sim"

    def keypair(self, seed: bytes) -> Tuple[bytes, bytes]:
        sk = hashlib.blake2b(b"sk" + seed, digest_size=32).digest()
        pk = hashlib.blake2b(b"pk" + sk, digest_size=32).digest()
        return pk, sk

    def sign(self, body: bytes, sk: bytes) -> bytes:
        pk = hashlib.blake2b(b"pk" + sk, digest_size=32).digest()
        return hashlib.blake2b(pk + body, digest_size=SIG_BYTES).digest()

    def verify(self, body: bytes, sig: bytes, pk: bytes) -> bool:
        return sig == hashlib.blake2b(pk + body, digest_size=SIG_BYTES).digest()


class Ed25519Signer:
    """Real Ed25519 through the ``cryptography`` package (where it imports)."""

    name = "ed25519"

    def __init__(self):
        from cryptography.hazmat.primitives.asymmetric import ed25519 as _ed

        self._ed = _ed
        self._pub_cache = {}

    def keypair(self, seed: bytes) -> Tuple[bytes, bytes]:
        sk_seed = hashlib.blake2b(b"sk" + seed, digest_size=32).digest()
        priv = self._ed.Ed25519PrivateKey.from_private_bytes(sk_seed)
        from cryptography.hazmat.primitives import serialization as ser

        pk = priv.public_key().public_bytes(
            ser.Encoding.Raw, ser.PublicFormat.Raw
        )
        return pk, sk_seed

    def sign(self, body: bytes, sk: bytes) -> bytes:
        priv = self._ed.Ed25519PrivateKey.from_private_bytes(sk)
        return priv.sign(body)

    def verify(self, body: bytes, sig: bytes, pk: bytes) -> bool:
        key = self._pub_cache.get(pk)
        if key is None:
            key = self._ed.Ed25519PublicKey.from_public_bytes(pk)
            self._pub_cache[pk] = key
        try:
            key.verify(sig, body)
            return True
        except Exception:
            return False


def _default_backend():
    try:
        return Ed25519Signer()
    except Exception:
        return SimSigner()


_BACKEND = _default_backend()


def set_backend(name: str) -> None:
    """Select the signature backend: ``"ed25519"`` or ``"sim"``."""
    global _BACKEND
    if name == "ed25519":
        _BACKEND = Ed25519Signer()
    elif name == "sim":
        _BACKEND = SimSigner()
    else:
        raise ValueError(f"unknown crypto backend {name!r}")


def backend_name() -> str:
    return _BACKEND.name


def keypair(seed: bytes) -> Tuple[bytes, bytes]:
    """Deterministic (pub, priv) keypair from a seed."""
    return _BACKEND.keypair(seed)


# Domain-separation tags: one key signs event bodies, sync requests, sync
# replies and want-list requests, each with its own prefix, so a signature
# can never be replayed across contexts.
DOMAIN_EVENT = b"EVNT:"
DOMAIN_SYNC_REQ = b"SYNQ:"
DOMAIN_SYNC_REPLY = b"SYNR:"
DOMAIN_WANT = b"WANT:"


def sign(body: bytes, sk: bytes, domain: bytes = b"") -> bytes:
    return _BACKEND.sign(domain + body, sk)


def verify(body: bytes, sig: bytes, pk: bytes, domain: bytes = b"") -> bool:
    return _BACKEND.verify(domain + body, sig, pk)


def coin_bit(sig: bytes) -> int:
    """Pseudo-random coin-round bit: low bit of the signature's middle byte."""
    return sig[len(sig) // 2] & 1


def randrange(n: int) -> int:
    """Uniform int in [0, n) from the OS CSPRNG (peer selection outside
    deterministic simulations)."""
    import secrets

    if n <= 0:
        raise ValueError("randrange needs n > 0")
    return secrets.randbelow(n)


def xor_bytes(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))
