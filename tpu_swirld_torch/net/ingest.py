"""Transaction ingestion: submission pool, dedup, batches, backpressure.

The whitepaper's events carry opaque transaction payloads; until now the
sim invented them (``b"tx:%d:%d"``).  This module is the client front
door: :class:`TxPool` admits raw transaction bytes, deduplicates them by
BLAKE2b id, queues them FIFO, and drains them into size-capped *batches*
that ride event payloads through the ordinary gossip path — so a
transaction is decided exactly when the event carrying it reaches its
consensus slot, and submission→decided latency is measurable with the
existing :class:`~tpu_swirld_torch.obs.finality.FinalityTracker`.

Admission control is *backpressure, not buffering*: a node whose
undecided window (events in store minus events decided — the gauge
``node_undecided_window``) exceeds ``max_undecided`` is behind on
consensus, and accepting more transactions only grows an unbounded
queue.  It sheds instead: the submitter gets an explicit ``SHED:window``
reply and retries elsewhere/later.  A full pool (``SHED:pool``) and an
oversized tx (``SHED:oversize``) shed the same way.  Every outcome is a
counted reply the client can parse:

- ``ACK:<txid hex>`` — admitted; will ride the next batch.
- ``DUP:<txid hex>`` — already pending or already batched; idempotent.
- ``SHED:window`` / ``SHED:pool`` / ``SHED:oversize`` — not admitted;
  nothing retained; safe to retry against another node.

Batch wire format (an event payload)::

    b"TXB1" <H count> (<I len> tx)*

``decode_batch`` is total: payloads that are not batches (the sim's
legacy ``b"tx:..."`` strings, a byzantine member's garbage) decode to
``[]`` rather than raising — batch decoding sits on the gossip ingest
path where every byte is adversary-controlled.
"""

from __future__ import annotations

import collections
import struct
from typing import Callable, Dict, List, Optional, Tuple

from tpu_swirld_torch import crypto

BATCH_MAGIC = b"TXB1"
_BHEAD = struct.Struct("<H")
_BLEN = struct.Struct("<I")

#: counter names exported by :attr:`TxPool.counters`
COUNTERS = (
    "tx_submitted", "tx_accepted", "tx_duplicate",
    "tx_shed_window", "tx_shed_pool", "tx_shed_oversize",
    "tx_batches", "tx_batched",
)


def encode_batch(txs: List[bytes]) -> bytes:
    return BATCH_MAGIC + _BHEAD.pack(len(txs)) + b"".join(
        _BLEN.pack(len(tx)) + tx for tx in txs
    )


def decode_batch(payload: bytes) -> List[bytes]:
    """Inverse of :func:`encode_batch`; total (garbage → ``[]``)."""
    if not payload.startswith(BATCH_MAGIC):
        return []
    off = len(BATCH_MAGIC)
    if off + _BHEAD.size > len(payload):
        return []
    (count,) = _BHEAD.unpack_from(payload, off)
    off += _BHEAD.size
    out: List[bytes] = []
    for _ in range(count):
        if off + _BLEN.size > len(payload):
            return []
        (n,) = _BLEN.unpack_from(payload, off)
        off += _BLEN.size
        if off + n > len(payload):
            return []
        out.append(payload[off:off + n])
        off += n
    return out


class TxPool:
    """FIFO submission pool with dedup, size caps, and window shedding.

    Args:
      max_pool: pending-transaction cap (``SHED:pool`` beyond it).
      batch_bytes: max encoded-payload bytes per batch drain.
      max_tx_bytes: per-transaction size cap (``SHED:oversize``).
      max_undecided: undecided-window threshold (``SHED:window``).
      window_fn: zero-arg gauge read (``node.undecided_window``);
        ``None`` disables window shedding (unit tests).
      dedup_cap: decided/batched tx ids remembered for dedup (FIFO
        forgetting — an old id resubmitted after 2^17 successors is
        re-admitted, which is idempotent downstream anyway).
    """

    def __init__(
        self,
        max_pool: int = 4096,
        batch_bytes: int = 64 << 10,
        max_tx_bytes: int = 16 << 10,
        max_undecided: int = 2048,
        window_fn: Optional[Callable[[], int]] = None,
        dedup_cap: int = 1 << 17,
    ):
        self.max_pool = int(max_pool)
        self.batch_bytes = int(batch_bytes)
        self.max_tx_bytes = int(max_tx_bytes)
        self.max_undecided = int(max_undecided)
        self.window_fn = window_fn
        self.pending: "collections.OrderedDict[bytes, bytes]" = (
            collections.OrderedDict()
        )
        self._seen: "collections.OrderedDict[bytes, None]" = (
            collections.OrderedDict()
        )
        self._dedup_cap = int(dedup_cap)
        self.counters: Dict[str, int] = {name: 0 for name in COUNTERS}

    def _remember(self, txid: bytes) -> None:
        self._seen[txid] = None
        while len(self._seen) > self._dedup_cap:
            self._seen.popitem(last=False)

    def submit(self, tx: bytes) -> Tuple[bool, bytes]:
        """Admit one raw transaction; returns ``(accepted, reply)``
        where ``reply`` is the wire answer the submitter sees."""
        self.counters["tx_submitted"] += 1
        if len(tx) > self.max_tx_bytes or not tx:
            self.counters["tx_shed_oversize"] += 1
            return False, b"SHED:oversize"
        txid = crypto.hash_bytes(tx)
        if txid in self.pending or txid in self._seen:
            self.counters["tx_duplicate"] += 1
            return False, b"DUP:" + txid.hex().encode()
        if self.window_fn is not None and (
            self.window_fn() > self.max_undecided
        ):
            self.counters["tx_shed_window"] += 1
            return False, b"SHED:window"
        if len(self.pending) >= self.max_pool:
            self.counters["tx_shed_pool"] += 1
            return False, b"SHED:pool"
        self.pending[txid] = tx
        self.counters["tx_accepted"] += 1
        return True, b"ACK:" + txid.hex().encode()

    def next_batch(self) -> bytes:
        """Drain up to ``batch_bytes`` of pending txs into one encoded
        batch payload (``b""`` when nothing is pending — the caller
        gossips an empty payload exactly like the legacy sim)."""
        if not self.pending:
            return b""
        txs: List[bytes] = []
        size = len(BATCH_MAGIC) + _BHEAD.size
        while self.pending:
            txid, tx = next(iter(self.pending.items()))
            need = _BLEN.size + len(tx)
            if txs and size + need > self.batch_bytes:
                break
            self.pending.popitem(last=False)
            self._remember(txid)
            txs.append(tx)
            size += need
        self.counters["tx_batches"] += 1
        self.counters["tx_batched"] += len(txs)
        return encode_batch(txs)
