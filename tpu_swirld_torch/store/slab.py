"""The fixed tile-budget API over the resident visibility slabs (copy of the
reference's ``tpu_swirld/store/slab.py``).

The streaming driver's device state is three window slabs: ancestry
``bool[W, W]``, sees ``bool[W, W]`` (the ancestry slab itself until the
first fork pair) and the strongly-sees column store ``bool[W, C]``.
:class:`SlabStore` accounts them in ``tile x tile`` tiles, exposes the
``resident_tiles`` / ``spill`` / ``fetch`` surface the driver uses and, with
``strict=True``, refuses window growth past ``budget_tiles``: row capacity,
column capacity, sees materialization and widening rebases are checked
before they commit.  The full-batch rebase fallback is exempt (it allocates
batch-scale slabs by design); its footprint still lands in the peaks.

Under a row-sharded mesh (``n_shards`` > 1) the store also accounts the
widest row shard, which ``device_budget_tiles`` bounds like the global
budget.  The reference's ``obs`` hooks sit at the same sites: the
``store_resident_tiles`` / ``store_resident_bytes`` (and, sharded,
``store_device_resident_tiles``) gauges and the
``store_budget_overruns_total`` / ``store_spilled_rows_total`` counters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from tpu_swirld_torch import obs
from tpu_swirld_torch.store.archive import SlabArchive


class TileBudgetExceeded(RuntimeError):
    """Raised (``strict`` mode) when a window growth or widening rebase
    would push the resident slab tiles past the configured budget."""


def _tiles(shape: Tuple[int, ...], tile: int) -> int:
    """Tile count of one slab: product of per-axis ceil(dim / tile) over
    the last two axes, times any leading (member) axes."""
    if not shape:
        return 0
    lead = 1
    for d in shape[:-2]:
        lead *= d
    grid = 1
    for d in shape[-2:]:
        grid *= -(-d // tile)
    return lead * grid


@dataclasses.dataclass
class _Slab:
    shape: Tuple[int, ...]
    itemsize: int

    @property
    def nbytes(self) -> int:
        n = self.itemsize
        for d in self.shape:
            n *= d
        return n


class SlabStore:
    """Tile accounting, budget and archive orchestration (see module doc).

    ``budget_tiles``: total resident visibility tiles allowed (``None`` =
    account only).  ``strict``: raise :class:`TileBudgetExceeded` on a
    growth past the budget; otherwise the overflow is counted
    (``budget_overruns``) and the run continues.
    """

    def __init__(
        self,
        budget_tiles: Optional[int] = None,
        *,
        tile: int = 256,
        strict: bool = False,
        archive: Optional[SlabArchive] = None,
        config=None,
        n_shards: int = 1,
        device_budget_tiles: Optional[int] = None,
    ):
        self.tile = int(tile)
        self.budget_tiles = budget_tiles
        self.strict = strict
        self.archive = (
            archive if archive is not None else SlabArchive(config=config)
        )
        self._slabs: Dict[str, _Slab] = {}
        self.budget_overruns = 0
        self.peak_resident_tiles = 0
        self.peak_resident_bytes = 0
        # mesh placement: the window (row) axis of every slab splits evenly
        # over n_shards, so per-shard residency is one row shard's tiles
        self.n_shards = max(1, int(n_shards))
        self.device_budget_tiles = device_budget_tiles
        self.peak_device_tiles = 0

    def close(self) -> None:
        """Flush and stop the archive's background packing worker."""
        self.archive.close()

    # --------------------------------------------------------- accounting

    def account(self, name: str, shape: Tuple[int, ...], itemsize: int = 1):
        """Register or refresh one resident slab's shape."""
        self._slabs[name] = _Slab(tuple(int(d) for d in shape), itemsize)
        self._touch()

    def drop(self, name: str) -> None:
        """Forget a slab that no longer exists (``sees`` while it is the
        ancestry slab)."""
        self._slabs.pop(name, None)
        self._touch()

    @property
    def resident_tiles(self) -> int:
        return sum(_tiles(s.shape, self.tile) for s in self._slabs.values())

    @property
    def resident_bytes(self) -> int:
        return sum(s.nbytes for s in self._slabs.values())

    def _shard_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """One row shard of a slab: the leading axis split over
        ``n_shards`` (ceil: the budget is written for the widest one)."""
        if not shape or self.n_shards == 1:
            return shape
        return (-(-shape[0] // self.n_shards),) + tuple(shape[1:])

    @property
    def device_resident_tiles(self) -> int:
        """Resident tiles of the widest row shard."""
        return sum(
            _tiles(self._shard_shape(s.shape), self.tile)
            for s in self._slabs.values()
        )

    def check(self, prospective: Dict[str, Tuple[int, ...]]) -> bool:
        """Would the slabs, with ``prospective`` shape overrides, fit the
        budget?  In ``strict`` mode an overflow raises; otherwise it is
        counted and ``False`` returned."""
        if self.budget_tiles is None and self.device_budget_tiles is None:
            return True
        total = 0
        dev_total = 0
        for name, slab in self._slabs.items():
            shape = prospective.get(name, slab.shape)
            total += _tiles(shape, self.tile)
            dev_total += _tiles(self._shard_shape(shape), self.tile)
        for name, shape in prospective.items():
            if name not in self._slabs:
                total += _tiles(shape, self.tile)
                dev_total += _tiles(self._shard_shape(shape), self.tile)
        over = []
        if self.budget_tiles is not None and total > self.budget_tiles:
            over.append(
                f"resident slabs would need {total} tiles "
                f"(budget {self.budget_tiles}, tile {self.tile})"
            )
        if (
            self.device_budget_tiles is not None
            and dev_total > self.device_budget_tiles
        ):
            over.append(
                f"per-shard slabs would need {dev_total} tiles "
                f"(shard budget {self.device_budget_tiles}, "
                f"{self.n_shards} shards, tile {self.tile})"
            )
        if not over:
            return True
        self.budget_overruns += 1
        o = obs.current()
        if o is not None:
            o.registry.counter("store_budget_overruns_total").inc()
        if self.strict:
            raise TileBudgetExceeded(
                "; ".join(over) + "; raise the budget or lower the ingest "
                "chunk / prune threshold"
            )
        return False

    def _touch(self) -> None:
        rt, rb = self.resident_tiles, self.resident_bytes
        dt = self.device_resident_tiles
        self.peak_resident_tiles = max(self.peak_resident_tiles, rt)
        self.peak_resident_bytes = max(self.peak_resident_bytes, rb)
        self.peak_device_tiles = max(self.peak_device_tiles, dt)
        o = obs.current()
        if o is not None:
            g = o.registry
            g.gauge("store_resident_tiles").set(rt)
            g.gauge("store_resident_bytes").set(rb)
            if self.n_shards > 1:
                g.gauge("store_device_resident_tiles").set(dt)

    # ------------------------------------------------------ spill / fetch

    def spill(self, lo: int, parents: np.ndarray, rows) -> int:
        """Retire decided window rows ``[lo, lo + d)`` into the archive
        (see :meth:`SlabArchive.spill`)."""
        return self._spilled(self.archive.spill(lo, parents, rows))

    def spill_full(self, start: int, rows) -> int:
        return self._spilled(self.archive.spill_full(start, rows))

    @staticmethod
    def _spilled(added: int) -> int:
        o = obs.current()
        if o is not None and added:
            o.registry.counter("store_spilled_rows_total").inc(added)
        return added

    def fetch(
        self,
        lo: int,
        hi: int,
        col_lo: int,
        col_hi: int,
        *,
        creator: Optional[np.ndarray] = None,
        fork_pairs: Optional[np.ndarray] = None,
        n_members: int = 0,
        out: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Re-admit archived rows ``[lo, hi)`` over columns ``[col_lo,
        col_hi)``.  Returns ``(anc_rows, sees_rows)``; sees is derived when
        ``creator`` (global creator index per column) is given, else
        ``None``.  ``out`` as in :meth:`SlabArchive.fetch`."""
        anc = self.archive.fetch(lo, hi, col_lo, col_hi, out=out)
        sees = None
        if creator is not None:
            fp = (
                fork_pairs
                if fork_pairs is not None
                else np.zeros((0, 3), np.int32)
            )
            sees = SlabArchive.derive_sees(
                anc, col_lo, creator, fp, n_members
            )
        return anc, sees

    # ------------------------------------------------------------- report

    def stats(self) -> Dict:
        a = self.archive
        return {
            "tile": self.tile,
            "budget_tiles": self.budget_tiles,
            "resident_tiles": self.resident_tiles,
            "resident_bytes": self.resident_bytes,
            "peak_resident_tiles": self.peak_resident_tiles,
            "peak_resident_bytes": self.peak_resident_bytes,
            "n_shards": self.n_shards,
            "device_budget_tiles": self.device_budget_tiles,
            "device_resident_tiles": self.device_resident_tiles,
            "peak_device_tiles": self.peak_device_tiles,
            "budget_overruns": self.budget_overruns,
            "archived_rows": a.n_rows,
            "archive_bytes": a.archive_bytes,
            "spills": a.spills,
            "fetches": a.fetches,
            "spilled_rows": a.spilled_rows,
            "fetched_rows": a.fetched_rows,
            "spill_pack_seconds": round(a.busy_seconds, 4),
            "spill_stall_seconds": round(a.stall_seconds, 4),
            "spill_queue_depth_peak": a.max_queue_depth,
        }
