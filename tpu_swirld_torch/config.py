"""Protocol parameters the port reads (the subset of the reference's
``tpu_swirld/config.py::SwirldConfig`` that the batch pipeline and the
incremental driver use, with the same defaults)."""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple


def resolve_stream_settings(config: Optional["SwirldConfig"] = None) -> Dict:
    """Concrete streaming-dispatch settings, ``{"fuse_chunks": int}``: the
    config field, else ``SWIRLD_FUSE_CHUNKS``, else 8.  ``fuse_chunks <= 1``
    keeps the incremental driver's per-chunk rounds loop.  A driver's own
    ``fuse_chunks=`` keyword wins over all three."""
    fuse = getattr(config, "fuse_chunks", None)
    if fuse is None:
        fuse = int(os.environ.get("SWIRLD_FUSE_CHUNKS", 8))
    return {"fuse_chunks": fuse}


@dataclasses.dataclass(frozen=True)
class SwirldConfig:
    """Attributes:
      n_members: number of members in the population.
      coin_period: every ``coin_period``-th fame-voting round is a coin round.
      max_rounds: capacity of the witness table's round window (the
        overflow self-heal grows up to it, never past it).
      stake: per-member stake; ``None`` means one unit each.
      seed: base RNG seed for simulations.
      fuse_chunks: rounds-scan chunks per fused span of the incremental
        driver (``None``: see :func:`resolve_stream_settings`).  Outputs
        are bit-identical at every value.
    """

    n_members: int = 4
    coin_period: int = 6
    max_rounds: int = 256
    stake: Optional[Tuple[int, ...]] = None
    seed: int = 0
    fuse_chunks: Optional[int] = None
