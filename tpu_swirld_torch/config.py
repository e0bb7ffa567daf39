"""Protocol parameters the port reads (the subset of the reference's
``tpu_swirld/config.py::SwirldConfig`` that the batch pipeline and the
incremental and streaming drivers use, with the same defaults).

The streaming and archive knobs resolve as the reference's do: an explicit
``SwirldConfig`` field wins, then the ``SWIRLD_*`` environment variable,
then the built-in default (:func:`resolve_stream_settings`,
:func:`resolve_archive_settings`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple


def _env_flag(v: str) -> bool:
    return v.strip().lower() not in ("0", "", "no", "false", "off")


#: built-in archive defaults (field -> (env var, default, parser))
_ARCHIVE_ENV = {
    "archive_compress_level": ("SWIRLD_ARCHIVE_COMPRESS_LEVEL", 1, int),
    "archive_queue_depth": ("SWIRLD_ARCHIVE_QUEUE_DEPTH", 8, int),
    "archive_async": ("SWIRLD_ARCHIVE_ASYNC", True, _env_flag),
}

#: built-in streaming-dispatch defaults (field -> (env var, default, parser))
_STREAM_ENV = {
    "fuse_chunks": ("SWIRLD_FUSE_CHUNKS", 8, int),
    "decode_overlap": ("SWIRLD_DECODE_OVERLAP", True, _env_flag),
    "decode_queue_depth": ("SWIRLD_DECODE_QUEUE_DEPTH", 2, int),
}


def _resolve(config, table: Dict, names: Dict) -> Dict:
    out = {}
    for field, (env, default, parse) in table.items():
        v = getattr(config, field, None) if config is not None else None
        if v is None:
            raw = os.environ.get(env)
            v = parse(raw) if raw is not None else default
        out[names.get(field, field)] = v
    return out


def resolve_stream_settings(config: Optional["SwirldConfig"] = None) -> Dict:
    """Concrete streaming-dispatch settings, ``{"fuse_chunks",
    "decode_overlap", "decode_queue_depth"}`` (plain values, never
    ``None``).  ``fuse_chunks <= 1`` keeps the incremental driver's
    per-chunk rounds loop (a driver's own ``fuse_chunks=`` keyword wins);
    ``decode_overlap`` toggles the streaming driver's decode worker
    (results are identical either way)."""
    return _resolve(config, _STREAM_ENV, {})


def resolve_archive_settings(config: Optional["SwirldConfig"] = None) -> Dict:
    """Concrete archive settings, ``{"compress_level", "queue_depth",
    "async_spill"}`` (plain values, never ``None``)."""
    return _resolve(config, _ARCHIVE_ENV, {
        "archive_compress_level": "compress_level",
        "archive_queue_depth": "queue_depth",
        "archive_async": "async_spill",
    })


@dataclasses.dataclass(frozen=True)
class SwirldConfig:
    """Attributes:
      n_members: number of members in the population.
      coin_period: every ``coin_period``-th fame-voting round is a coin round.
      max_rounds: capacity of the witness table's round window (the
        overflow self-heal grows up to it, never past it).
      stake: per-member stake; ``None`` means one unit each.
      seed: base RNG seed for simulations.
      archive_compress_level: zlib level of spilled archive rows.
      archive_queue_depth: bounded spill-queue depth (a full queue
        backpressures the spiller).
      archive_async: the archive's background packing worker on or off
        (results are identical either way).
      fuse_chunks: rounds-scan chunks per fused span of the incremental
        driver.  Outputs are bit-identical at every value.
      decode_overlap: the streaming driver's gossip-decode worker on or off
        (results are identical either way).
      decode_queue_depth: chunks the decode worker runs ahead.

    Every ``None`` field resolves as :func:`resolve_archive_settings` /
    :func:`resolve_stream_settings` say.
    """

    n_members: int = 4
    coin_period: int = 6
    max_rounds: int = 256
    stake: Optional[Tuple[int, ...]] = None
    seed: int = 0
    archive_compress_level: Optional[int] = None
    archive_queue_depth: Optional[int] = None
    archive_async: Optional[bool] = None
    fuse_chunks: Optional[int] = None
    decode_overlap: Optional[bool] = None
    decode_queue_depth: Optional[int] = None
