"""Protocol parameters: the reference's ``tpu_swirld/config.py::
SwirldConfig``, every field with the same name and default.

The streaming and archive knobs resolve as the reference's do: an explicit
``SwirldConfig`` field wins, then the ``SWIRLD_*`` environment variable,
then the built-in default (:func:`resolve_stream_settings`,
:func:`resolve_archive_settings`, :func:`resolve_flightrec_settings`,
:func:`resolve_net_settings`, :func:`resolve_soak_settings`).
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

#: built-in flight-recorder defaults (field -> (env var, default, parser))
_FLIGHTREC_ENV = {
    "flightrec_capacity": ("SWIRLD_FLIGHTREC_CAPACITY", 256, int),
    "flightrec_max_dumps": ("SWIRLD_FLIGHTREC_MAX_DUMPS", 16, int),
    "flightrec_dir": ("SWIRLD_FLIGHTREC_DIR", None, str),
}

#: built-in streaming-dispatch defaults (field -> (env var, default, parser))
_STREAM_ENV = {
    "fuse_chunks": ("SWIRLD_FUSE_CHUNKS", 8, int),
    "decode_overlap": ("SWIRLD_DECODE_OVERLAP", True, _env_flag),
    "decode_queue_depth": ("SWIRLD_DECODE_QUEUE_DEPTH", 2, int),
}


#: built-in socket/cluster defaults (field -> (env var, default, parser)),
#: in wall seconds except the byte and count caps
_NET_ENV = {
    "net_connect_timeout_s": ("SWIRLD_NET_CONNECT_TIMEOUT", 5.0, float),
    "net_call_timeout_s": ("SWIRLD_NET_CALL_TIMEOUT", 10.0, float),
    "net_max_frame_bytes": ("SWIRLD_NET_MAX_FRAME", (1 << 24) + (1 << 16), int),
    "net_tx_batch_bytes": ("SWIRLD_NET_TX_BATCH_BYTES", 64 << 10, int),
    "net_tx_max_bytes": ("SWIRLD_NET_TX_MAX_BYTES", 16 << 10, int),
    "net_tx_pool_txs": ("SWIRLD_NET_TX_POOL", 4096, int),
    "net_max_undecided": ("SWIRLD_NET_MAX_UNDECIDED", 2048, int),
    "net_gossip_interval_s": ("SWIRLD_NET_GOSSIP_INTERVAL", 0.01, float),
    "net_checkpoint_every_s": ("SWIRLD_NET_CHECKPOINT_EVERY", 1.0, float),
    "net_retry_tick_s": ("SWIRLD_NET_RETRY_TICK", 0.02, float),
    "net_redial_probe_s": ("SWIRLD_NET_REDIAL_PROBE", 0.05, float),
}

#: built-in production-day-soak defaults (field -> (env var, default,
#: parser)), in wall seconds like the net knobs.  ``SwirldConfig`` has no
#: ``soak_*`` field (neither has the reference's), so a config passed in
#: only wins where a caller's object carries one.
_SOAK_ENV = {
    "soak_horizon_s": ("SWIRLD_SOAK_HORIZON", 8.0, float),
    "soak_nodes": ("SWIRLD_SOAK_NODES", 4, int),
    "soak_tx_rate": ("SWIRLD_SOAK_TX_RATE", 150.0, float),
    "soak_clients": ("SWIRLD_SOAK_CLIENTS", 3, int),
    "soak_tx_bytes": ("SWIRLD_SOAK_TX_BYTES", 64, int),
    "soak_pareto_alpha": ("SWIRLD_SOAK_PARETO_ALPHA", 1.5, float),
    "soak_finality_budget_s": ("SWIRLD_SOAK_FINALITY_BUDGET", 6.0, float),
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


def resolve_flightrec_settings(config: Optional["SwirldConfig"] = None) -> Dict:
    """Concrete flight-recorder settings, ``{"capacity", "max_dumps",
    "dump_dir"}`` (``dump_dir`` may be ``None``: record in memory, never
    dump)."""
    return _resolve(config, _FLIGHTREC_ENV, {
        "flightrec_capacity": "capacity",
        "flightrec_max_dumps": "max_dumps",
        "flightrec_dir": "dump_dir",
    })


def resolve_net_settings(config: Optional["SwirldConfig"] = None) -> Dict:
    """Concrete socket/cluster settings (:mod:`tpu_swirld_torch.net`),
    ``{"connect_timeout_s", "call_timeout_s", "max_frame_bytes",
    "tx_batch_bytes", "tx_max_bytes", "tx_pool_txs", "max_undecided",
    "gossip_interval_s", "checkpoint_every_s", "retry_tick_s",
    "redial_probe_s"}`` (plain values, never ``None``).  ``retry_tick_s``
    turns the retry policy's logical backoff ticks into real sleep seconds;
    ``redial_probe_s`` bounds the one re-probe after a failed transparent
    redial (a peer mid-restart whose new listener is not bound yet)."""
    return _resolve(config, _NET_ENV, {f: f[len("net_"):] for f in _NET_ENV})


def resolve_soak_settings(config: Optional["SwirldConfig"] = None) -> Dict:
    """Concrete production-day-soak settings (:mod:`tpu_swirld_torch.soak`),
    ``{"horizon_s", "nodes", "tx_rate", "clients", "tx_bytes",
    "pareto_alpha", "finality_budget_s"}`` (plain values, never ``None``).
    ``finality_budget_s`` is the composite verdict's p99 submission to
    decided latency ceiling; ``pareto_alpha`` shapes the traffic
    generator's heavy-tailed inter-arrival draw."""
    return _resolve(config, _SOAK_ENV, {f: f[len("soak_"):] for f in _SOAK_ENV})


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
      backend: the ``Node``'s consensus engine: ``"python"`` (the oracle) or
        ``"tpu"``, the reference's name for the device engine, which in this
        package is :class:`~tpu_swirld_torch.backend.TorchEngine` on the
        card.  Keeping the name makes one config mean the same in both
        packages.
      mesh_shape: ``{axis_name: size}``; for a ``"tpu"`` node, the product
        of the sizes is the number of member shards of its strongly-sees
        matrix, all on the engine's one device; ``None``: no mesh.
      block_size: event-block tile of the ancestry closure of a node pass.
      tpu_min_batch: least new events a ``"tpu"`` node's engine waits for
        before a pass (the output is the same, computed later).
      max_orphans, max_orphan_bytes: the orphan buffer's count and byte
        budgets (events parked for a missing parent).
      max_want_rounds: want-list round trips per sync.
      want_ancestor_depth: self-ancestors shipped per wanted event.
      retry_attempts, retry_backoff, retry_backoff_cap, retry_jitter,
        retry_deadline: the gossip retry policy, in logical ticks.
      breaker_failures, breaker_misbehavior, breaker_cooldown: the
        per-peer circuit breaker's thresholds and cooldown.
      max_reply_bytes, max_reply_events: caps on a sync or want reply.
      quarantine_forkers: a detected equivocator opens its breaker at once.
      max_fork_branches: branch tails walked per forked creator per reply.
      flightrec_capacity, flightrec_max_dumps, flightrec_dir: the flight
        recorder's settings (:func:`resolve_flightrec_settings`).
      net_*: the socket transport's and the cluster's settings
        (:func:`resolve_net_settings`, :mod:`tpu_swirld_torch.net`).
      membership_delay: rounds between a membership transaction's decision
        (the round received of its carrier event) and the first round its
        epoch governs (:mod:`tpu_swirld_torch.membership`).

    The fields are declared in the reference's order, so the two packages'
    ``dataclasses.asdict`` list the same keys in the same order.  Every
    ``None`` archive or streaming field resolves as
    :func:`resolve_archive_settings` / :func:`resolve_stream_settings` say.
    """

    n_members: int = 4
    stake: Optional[Tuple[int, ...]] = None
    coin_period: int = 6
    backend: str = "python"
    seed: int = 0
    mesh_shape: Optional[Dict[str, int]] = None
    block_size: int = 256
    max_rounds: int = 256
    max_orphans: int = 4096
    max_orphan_bytes: int = 8 << 20
    max_want_rounds: int = 32
    want_ancestor_depth: int = 64
    tpu_min_batch: int = 1
    retry_attempts: int = 3
    retry_backoff: float = 1.0
    retry_backoff_cap: float = 8.0
    retry_jitter: float = 0.5
    retry_deadline: float = 16.0
    breaker_failures: int = 4
    breaker_misbehavior: int = 12
    breaker_cooldown: float = 24.0
    max_reply_bytes: int = 1 << 24
    max_reply_events: int = 65536
    quarantine_forkers: bool = False
    max_fork_branches: int = 8
    archive_compress_level: Optional[int] = None
    archive_queue_depth: Optional[int] = None
    archive_async: Optional[bool] = None
    fuse_chunks: Optional[int] = None
    decode_overlap: Optional[bool] = None
    decode_queue_depth: Optional[int] = None
    flightrec_capacity: Optional[int] = None
    flightrec_max_dumps: Optional[int] = None
    flightrec_dir: Optional[str] = None
    net_connect_timeout_s: Optional[float] = None
    net_call_timeout_s: Optional[float] = None
    net_max_frame_bytes: Optional[int] = None
    net_tx_batch_bytes: Optional[int] = None
    net_tx_max_bytes: Optional[int] = None
    net_tx_pool_txs: Optional[int] = None
    net_max_undecided: Optional[int] = None
    net_gossip_interval_s: Optional[float] = None
    net_checkpoint_every_s: Optional[float] = None
    net_retry_tick_s: Optional[float] = None
    membership_delay: int = 4

    def stakes(self) -> Tuple[int, ...]:
        if self.stake is not None:
            if len(self.stake) != self.n_members:
                raise ValueError(
                    f"stake has {len(self.stake)} entries for "
                    f"{self.n_members} members"
                )
            return tuple(int(s) for s in self.stake)
        return tuple(1 for _ in range(self.n_members))
