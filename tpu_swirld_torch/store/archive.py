"""Append-only host-side archive of decided ancestry rows (copy of the
reference's ``tpu_swirld/store/archive.py``, same format and digest).

The streaming driver retires (spills) every event below the decided
frontier here; the device keeps only the undecided window resident.  Each
archived row ``e`` is the event's **full global ancestry bitmap** over
columns ``[0, e]`` (reflexive; topo order means nothing newer is an
ancestor), stored as a zlib-compressed ``np.packbits`` blob.

Rows arrive in two shapes:

- :meth:`SlabArchive.spill`: *window rows* from the live driver, covering
  only the retained columns ``[lo, hi)``.  The prefix ``[0, lo)`` is
  reconstructed exactly from the parents' archived rows (``anc(e) ∩ [0, lo)
  = (anc(p1) ∪ anc(p2)) ∩ [0, lo)`` since ``e >= lo``); rows are appended
  in topo order, so parents are always archived already or earlier in the
  same batch.
- :meth:`SlabArchive.spill_full`: full-width rows straight from a batch
  rebase's ``bool[N, N]`` slab.

Sees rows are not archived: :meth:`SlabArchive.derive_sees` recomputes them
on fetch from the ancestry row and the global fork-pair ledger (a pair found
after ``e`` was archived cannot poison ``e``: its second member is newer).

**Background packing.**  Packing (device pull, prefix reconstruction,
``packbits``, zlib) runs on one worker thread behind a bounded queue, so
the driver's critical path pays an enqueue.  Every read of archived bytes
(:meth:`~SlabArchive.fetch`, :meth:`~SlabArchive.digest`,
:meth:`~SlabArchive.save`) first drains the queue, so what a reader sees is
what a synchronous spiller would have built, to the byte.  ``n_rows`` counts
accepted rows (committed + queued).  A full queue blocks the spiller
(``stall_seconds``); a worker failure is re-raised at the next drain.
``async_spill=False`` (or ``SWIRLD_ARCHIVE_ASYNC=0``) packs on the caller.
The worker pulls device rows with a blocking ``.cpu()`` on the default
stream (:func:`~tpu_swirld_torch.device.to_host`), so it reads them after
every kernel the caller queued before the spill; the caller hands it owned
copies, never views of a slab it goes on writing in place.  Shared with the
worker: the queue, the blob list, the byte counter, the row cache, the
failure slot and ``busy_seconds``, all behind the drain barrier.

Decompressed rows are kept in a bounded LRU cache, which
:meth:`~SlabArchive.prefetch` warms in the background before a widening
rebase.  The archive checkpoints to one ``.npz`` (no pickle) carrying a
running BLAKE2b digest that :meth:`~SlabArchive.load` verifies; a file
saved by either package loads in the other.  The reference's
schedule-fuzz seams are ported at its sites: :func:`set_injector` installs
the yield injector of :mod:`tpu_swirld_torch.analysis.races` at the five
tagged points (``archive.cache.miss``, ``archive.append``,
``archive.worker.item``, ``archive.drain``, ``archive.enqueue``), and
``_make_queue`` lets its sanitized subclass track the spill queue's lock.
Its ``obs`` hooks are, at the same sites: the ``store_spill_queue_depth`` /
``store_archived_rows`` gauges, the ``store_spills_total`` /
``store_prefetches_total`` / ``store_fetches_total`` /
``store_fetched_rows_total`` counters and the ``store.archive_fetch``
span, all on the calling thread.
"""

from __future__ import annotations

import collections
import contextlib
import queue
import struct
import threading
import time
import zlib
from typing import List, Optional

import numpy as np
import torch

from tpu_swirld_torch import crypto, obs
from tpu_swirld_torch.config import resolve_archive_settings
from tpu_swirld_torch.device import to_host

#: LRU capacity (decompressed rows) for the reconstruction/fetch cache
_ROW_CACHE_ENTRIES = 1024

# Schedule-fuzz seam: tpu_swirld_torch.analysis.races installs a yield
# injector here to perturb client/worker interleavings at the tagged points
# below.  None in production: each point costs one global read and a check.
_injector = None


def set_injector(inj) -> None:
    global _injector
    _injector = inj


def _yp(tag: str) -> None:
    inj = _injector
    if inj is not None:
        inj.point(tag)


def _host_rows(rows) -> np.ndarray:
    """Rows as a host array: a tensor is pulled (blocking, default stream),
    anything else taken as it is."""
    if isinstance(rows, torch.Tensor):
        return to_host(rows)
    return np.asarray(rows)


class SlabArchive:
    """Append-only archive of decided ancestry rows (see module doc)."""

    #: archive format version (bump on layout changes)
    FORMAT_VERSION = 1

    #: every mutable attribute the pack worker shares with the client
    #: thread (SW006 lock-discipline): the spill queue itself, the blob
    #: list, byte counter and row cache it packs into behind the drain
    #: barrier, the failure slot and the busy-time counter.  Audit any
    #: addition here against the queue/barrier protocol in the module doc.
    GUARDED_ATTRS = frozenset({
        "_q", "_rows", "_cache", "_committed_bytes", "_worker_err",
        "busy_seconds",
    })

    def __init__(
        self,
        compress_level: Optional[int] = None,
        *,
        queue_depth: Optional[int] = None,
        async_spill: Optional[bool] = None,
        config=None,
    ):
        s = resolve_archive_settings(config)
        self._rows: List[bytes] = []       # zlib(packbits(row over [0, e]))
        self._rounds: List[tuple] = []     # retired-round ledger
        self._level = (
            compress_level if compress_level is not None
            else s["compress_level"]
        )
        self.queue_depth = (
            queue_depth if queue_depth is not None else s["queue_depth"]
        )
        self._async = (
            async_spill if async_spill is not None else s["async_spill"]
        )
        self.spills = 0                    # spill batches accepted
        self.fetches = 0                   # fetch calls served
        self.spilled_rows = 0              # rows newly archived (accepted)
        self.fetched_rows = 0              # rows decompressed for callers
        self.skipped_rows = 0              # re-spills of already-archived rows
        self._n_accepted = 0               # committed + queued rows
        self._committed_bytes = 0
        self._cache: "collections.OrderedDict[int, np.ndarray]" = (
            collections.OrderedDict()
        )
        # background packing worker (started on the first async spill)
        self._q: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._worker_err: Optional[BaseException] = None
        self.busy_seconds = 0.0            # worker time spent packing
        self.stall_seconds = 0.0           # caller time blocked on the queue
        self.max_queue_depth = 0           # high-water mark of queued batches

    # ------------------------------------------------------------- basics

    @property
    def n_rows(self) -> int:
        """Archived prefix length: rows ``[0, n_rows)`` are archived or
        accepted into the spill queue (the drain barrier hides which)."""
        return self._n_accepted

    @property
    def committed_rows(self) -> int:
        """Rows physically packed (``n_rows`` minus the queue backlog)."""
        return len(self._rows)

    @property
    def archive_bytes(self) -> int:
        """Compressed payload bytes committed so far."""
        return self._committed_bytes

    @property
    def pending_batches(self) -> int:
        return self._q.qsize() if self._q is not None else 0

    def _row_bool(self, e: int) -> np.ndarray:
        """Decompress row ``e`` to a bool[e + 1] ancestry bitmap (LRU
        cached)."""
        cached = self._cache.get(e)
        if cached is not None:
            self._cache.move_to_end(e)
            return cached
        _yp("archive.cache.miss")
        raw = np.frombuffer(zlib.decompress(self._rows[e]), dtype=np.uint8)
        row = np.unpackbits(raw, count=e + 1).astype(bool)
        row.flags.writeable = False
        self._cache[e] = row
        if len(self._cache) > _ROW_CACHE_ENTRIES:
            self._cache.popitem(last=False)
        return row

    def _append_bool(self, row: np.ndarray) -> None:
        _yp("archive.append")
        blob = zlib.compress(np.packbits(row).tobytes(), self._level)
        self._rows.append(blob)
        self._committed_bytes += len(blob)

    # ------------------------------------------------- background worker

    def _make_queue(self, maxsize: int) -> queue.Queue:
        """Seam for analysis.races: the sanitized subclass returns a queue
        whose internal lock takes part in the lock-order graph."""
        return queue.Queue(maxsize=maxsize)

    def _ensure_worker(self) -> queue.Queue:
        if self._q is None:
            self._q = self._make_queue(max(1, int(self.queue_depth)))
            self._worker = threading.Thread(
                target=self._worker_loop, name="slab-archive-pack",
                daemon=True,
            )
            self._worker.start()
        return self._q

    def _worker_loop(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                _yp("archive.worker.item")
                t0 = time.perf_counter()
                kind, args = item
                if kind == "spill":
                    self._pack_window_rows(*args)
                elif kind == "spill_full":
                    self._pack_full_rows(*args)
                elif kind == "prefetch":
                    lo, hi = args
                    for e in range(max(0, lo), min(hi, len(self._rows))):
                        self._row_bool(e)
                self.busy_seconds += time.perf_counter() - t0
            except BaseException as exc:  # re-raised at the next barrier
                if self._worker_err is None:
                    self._worker_err = exc
            finally:
                self._q.task_done()

    def _drain(self) -> None:
        """Barrier: wait until every queued batch is packed, then re-raise
        any worker failure."""
        _yp("archive.drain")
        if self._q is not None and (
            self._q.unfinished_tasks or not self._q.empty()
        ):
            t0 = time.perf_counter()
            self._q.join()
            self.stall_seconds += time.perf_counter() - t0
        if self._worker_err is not None:
            err, self._worker_err = self._worker_err, None
            raise RuntimeError("archive pack worker failed") from err

    def _enqueue(self, item) -> None:
        q = self._ensure_worker()
        _yp("archive.enqueue")
        self.max_queue_depth = max(self.max_queue_depth, q.qsize() + 1)
        o = obs.current()
        if o is not None:
            o.registry.gauge("store_spill_queue_depth").set(q.qsize() + 1)
        if q.full():
            t0 = time.perf_counter()
            q.put(item)
            self.stall_seconds += time.perf_counter() - t0
        else:
            q.put(item)

    def close(self) -> None:
        """Stop the worker after packing everything queued (idempotent)."""
        if self._q is not None:
            self._drain()
            self._q.put(None)
            self._worker.join()
            self._q = None
            self._worker = None

    # -------------------------------------------------------------- spill

    def spill(self, lo: int, parents, rows) -> int:
        """Archive window rows for global events ``[lo, lo + d)``.

        ``rows`` is bool[d, w] over retained columns ``[lo, lo + w)``, a
        numpy array or an owned tensor (async mode pulls it on the worker);
        ``parents`` the int32[d, 2] global parent indices (-1 genesis).
        Rows already archived (re-admitted by a widening rebase) are
        skipped: the archived copy is the exact value.  Returns the number
        of rows newly accepted."""
        d = int(rows.shape[0])
        if lo + d <= self.n_rows or d == 0:
            self.skipped_rows += d
            return 0
        if lo > self.n_rows:
            raise ValueError(
                f"non-contiguous spill: rows [{lo}, {lo + d}) after "
                f"{self.n_rows}"
            )
        added = lo + d - self.n_rows
        self.skipped_rows += d - added
        self._n_accepted = lo + d
        if self._async:
            self._enqueue(("spill", (lo, np.asarray(parents), rows)))
        else:
            self._pack_window_rows(lo, np.asarray(parents), rows)
        self.spills += 1
        self.spilled_rows += added
        self._record_gauges()
        return added

    def _pack_window_rows(self, lo: int, parents: np.ndarray, rows) -> None:
        rows = _host_rows(rows)
        for i in range(rows.shape[0]):
            e = lo + i
            if e < len(self._rows):
                continue
            if e != len(self._rows):
                raise ValueError(
                    f"non-contiguous spill: row {e} after {len(self._rows)}"
                )
            full = np.zeros(e + 1, dtype=bool)
            # pruned-prefix columns [0, lo) come from the parents' rows;
            # retained columns [lo, e] straight from the device slab
            for p in parents[i]:
                p = int(p)
                if p < 0:
                    continue
                cut = min(p + 1, lo)
                if cut > 0:
                    full[:cut] |= self._row_bool(p)[:cut]
            full[lo : e + 1] = rows[i, : e - lo + 1]
            self._append_bool(full)

    def spill_full(self, start: int, rows, *, continues: bool = False) -> int:
        """Archive full-width rows for global events ``[start, start + d)``
        from a batch slab (bool[d, n] over global columns ``[0, n)``).
        ``continues``: the rows go on the previous call's spill (a spill
        handed over in pieces counts once in ``spills``)."""
        d = int(rows.shape[0])
        if start + d <= self.n_rows or d == 0:
            self.skipped_rows += d
            return 0
        if start > self.n_rows:
            raise ValueError(
                f"non-contiguous spill: rows [{start}, {start + d}) after "
                f"{self.n_rows}"
            )
        added = start + d - self.n_rows
        self.skipped_rows += d - added
        self._n_accepted = start + d
        if self._async:
            self._enqueue(("spill_full", (start, rows)))
        else:
            self._pack_full_rows(start, rows)
        self.spills += not continues
        self.spilled_rows += added
        self._record_gauges(new_spill=not continues)
        return added

    def _pack_full_rows(self, start: int, rows) -> None:
        rows = _host_rows(rows)
        for i in range(rows.shape[0]):
            e = start + i
            if e < len(self._rows):
                continue
            if e != len(self._rows):
                raise ValueError(
                    f"non-contiguous spill: row {e} after {len(self._rows)}"
                )
            self._append_bool(rows[i, : e + 1])

    # -------------------------------------------------------------- fetch

    def prefetch(self, lo: int, hi: int) -> None:
        """Warm the decompressed-row cache for rows ``[lo, hi)`` in the
        background (a no-op in sync mode)."""
        if not self._async or hi <= lo:
            return
        lo = max(lo, hi - _ROW_CACHE_ENTRIES)   # cache-bounded window
        self._enqueue(("prefetch", (lo, hi)))
        o = obs.current()
        if o is not None:
            o.registry.counter("store_prefetches_total").inc()

    def fetch(
        self, lo: int, hi: int, col_lo: int, col_hi: int,
        out: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Re-admit archived ancestry rows ``[lo, hi)`` over columns
        ``[col_lo, col_hi)`` as a dense bool matrix (zero beyond each row's
        own index), counted as one fetch.  Drains the spill queue first.
        ``out`` decompresses straight into a caller buffer: bool, ``(hi -
        lo, col_hi - col_lo)``, zero-filled."""
        if hi > self.n_rows:
            raise ValueError(
                f"fetch [{lo}, {hi}) exceeds archived prefix {self.n_rows}"
            )
        out = self.read(range(lo, hi), col_lo, col_hi, out)
        self.count_fetch(hi - lo)
        return out

    def read(
        self, rows, col_lo: int, col_hi: int,
        out: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Archived ancestry rows ``rows`` (ints below ``n_rows``) over
        columns ``[col_lo, col_hi)``, as :meth:`fetch` decompresses them,
        counted as no fetch.  Drains the spill queue first."""
        rows = list(rows)
        if rows and max(rows) >= self.n_rows:
            raise ValueError(
                f"read of row {max(rows)} past archived prefix {self.n_rows}"
            )
        self._drain()
        o = obs.current()
        with (o.tracer.span("store.archive_fetch") if o is not None
              else contextlib.nullcontext()):
            if out is None:
                out = np.zeros((len(rows), col_hi - col_lo), dtype=bool)
            elif out.shape != (len(rows), col_hi - col_lo):
                raise ValueError(
                    f"out shape {out.shape} != {(len(rows), col_hi - col_lo)}"
                )
            for i, e in enumerate(rows):
                row = self._row_bool(e)
                a = min(col_hi, e + 1)
                if a > col_lo:
                    out[i, : a - col_lo] = row[col_lo:a]
        return out

    def count_fetch(self, rows: int) -> None:
        """Count one fetch of ``rows`` rows (a group rank's share of a
        widening counts as the whole window's one fetch)."""
        self.fetches += 1
        self.fetched_rows += rows
        o = obs.current()
        if o is not None:
            o.registry.counter("store_fetches_total").inc()
            o.registry.counter("store_fetched_rows_total").inc(rows)

    @staticmethod
    def derive_sees(
        anc_rows: np.ndarray,
        col_lo: int,
        creator: np.ndarray,
        fork_pairs: np.ndarray,
        n_members: int,
    ) -> np.ndarray:
        """Fork-aware visibility of fetched rows: ``sees = anc &
        ~forkseen[:, creator(col)]``.  ``anc_rows`` is bool[d, c] over
        global columns ``[col_lo, col_lo + c)``, ``creator`` their global
        creator indices, ``fork_pairs`` the global int32[G, 3] ledger.
        Pairs with a member outside the column span cannot poison these
        rows."""
        d, c = anc_rows.shape
        fseen = np.zeros((d, n_members), dtype=bool)
        for m, a, b in fork_pairs:
            a, b = int(a) - col_lo, int(b) - col_lo
            if 0 <= a < c and 0 <= b < c:
                fseen[:, int(m)] |= anc_rows[:, a] & anc_rows[:, b]
        return anc_rows & ~fseen[:, creator]

    # ------------------------------------------------------- round ledger

    def retire_round(self, rnd: int, events, famous, decided_at) -> None:
        """Ledger one fame-complete round rolled out of the driver's window:
        global round, witness indices in registration order, famous flags,
        decided-at rounds.  Report and checkpoint metadata only."""
        self._rounds.append(
            (int(rnd), list(map(int, events)), list(map(int, famous)),
             list(map(int, decided_at)))
        )

    @property
    def retired_rounds(self) -> int:
        return len(self._rounds)

    # --------------------------------------------------------- checkpoint

    def digest(self) -> str:
        """BLAKE2b over the blob stream (order-sensitive), after a drain."""
        self._drain()
        h = b""
        for b in self._rows:
            h = crypto.hash_bytes(h + crypto.hash_bytes(b))
        return h.hex()

    def save(self, path: str) -> None:
        """One ``.npz``, no pickle: length-prefixed blob stream, round
        ledger and digest.  Drains the spill queue first."""
        self._drain()
        blob = b"".join(struct.pack("<I", len(b)) + b for b in self._rows)
        rmeta = []
        rflat: List[int] = []
        for rnd, evs, fam, dec in self._rounds:
            rmeta.append((rnd, len(evs)))
            for e, f, dc in zip(evs, fam, dec):
                rflat.extend((e, f, dc))
        # through a file object: np.savez_compressed appends ".npz" to a
        # bare string path
        with open(path, "wb") as f:
            np.savez_compressed(
                f,
                format_version=self.FORMAT_VERSION,
                n_rows=len(self._rows),
                blobs=np.frombuffer(blob, dtype=np.uint8),
                round_meta=np.asarray(rmeta, dtype=np.int64).reshape(-1, 2),
                round_flat=np.asarray(rflat, dtype=np.int64),
                digest=np.frombuffer(self.digest().encode(), dtype=np.uint8),
            )

    @classmethod
    def load(cls, path: str) -> "SlabArchive":
        """Restore and verify: a digest mismatch (tampered or corrupt file)
        raises ``ValueError``."""
        z = np.load(path)
        if int(z["format_version"]) != cls.FORMAT_VERSION:
            raise ValueError(
                f"unsupported archive version {int(z['format_version'])}"
            )
        arch = cls()
        blob = z["blobs"].tobytes()
        off = 0
        while off < len(blob):
            (ln,) = struct.unpack_from("<I", blob, off)
            off += 4
            arch._rows.append(blob[off : off + ln])
            off += ln
        arch._n_accepted = len(arch._rows)
        arch._committed_bytes = sum(len(b) for b in arch._rows)
        if arch.n_rows != int(z["n_rows"]):
            raise ValueError(
                f"archive truncated: {arch.n_rows} rows, header says "
                f"{int(z['n_rows'])}"
            )
        if arch.digest() != z["digest"].tobytes().decode():
            raise ValueError(
                "archive digest mismatch (corrupt or tampered checkpoint)"
            )
        pos = 0
        rflat = z["round_flat"]
        for rnd, cnt in z["round_meta"]:
            evs, fam, dec = [], [], []
            for _ in range(int(cnt)):
                e, f, dc = rflat[pos : pos + 3]
                evs.append(int(e))
                fam.append(int(f))
                dec.append(int(dc))
                pos += 3
            arch.retire_round(int(rnd), evs, fam, dec)
        return arch

    # ---------------------------------------------------------------- obs

    def _record_gauges(self, new_spill: bool = True) -> None:
        o = obs.current()
        if o is None:
            return
        g = o.registry
        g.gauge("store_archived_rows").set(self.n_rows)
        if new_spill:
            g.counter("store_spills_total").inc()
