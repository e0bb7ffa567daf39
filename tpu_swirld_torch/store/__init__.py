"""Tiled slab store: memory-bounded visibility state for streaming consensus
(counterpart of the reference's ``tpu_swirld/store``).

- :class:`~tpu_swirld_torch.store.archive.SlabArchive`: an append-only,
  checkpointable host archive of decided ancestry rows (zlib-packed
  bitmaps; sees rows are derived on fetch from the global fork-pair ledger).
- :class:`~tpu_swirld_torch.store.slab.SlabStore`: the tile-budget API
  (``resident_tiles`` / ``spill`` / ``fetch``) over the card's window slabs.
- :class:`~tpu_swirld_torch.store.streaming.StreamingConsensus`: the
  streaming driver, the incremental driver with bounded-chunk ingest,
  spill on prune and rebase, and an archive-backed widening rebase.
"""

from tpu_swirld_torch.store.archive import SlabArchive  # noqa: F401
from tpu_swirld_torch.store.slab import SlabStore, TileBudgetExceeded  # noqa: F401
from tpu_swirld_torch.store.streaming import StreamingConsensus  # noqa: F401

__all__ = [
    "SlabArchive",
    "SlabStore",
    "TileBudgetExceeded",
    "StreamingConsensus",
]
