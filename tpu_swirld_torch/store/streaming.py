"""Streaming consensus driver: bounded-chunk ingest over the slab store
(counterpart of the reference's ``tpu_swirld/store/streaming.py``, same
names, bit-identical results).

:class:`StreamingConsensus` extends the port's
:class:`~tpu_swirld_torch.gpu.incremental.IncrementalConsensus` with a
memory model: device state is bounded by the undecided window, decided rows
retire into the :class:`~tpu_swirld_torch.store.archive.SlabArchive`, and a
delta that references pruned history re-fetches archived rows instead of
recomputing the whole DAG.

- **Bounded ingest**: a delta is split into ``ingest_chunk``-sized pieces
  (:func:`~tpu_swirld_torch.packing.chunk_slices`), so a cold start over a
  long history rebases at chunk scale and the rest streams.
- **Spill on retire**: the ``_on_prune`` / ``_on_roll`` / ``_on_rebase``
  hooks archive every decided ancestry row and every retired witness round
  before the parent driver drops them.
- **Widening rebase**: when a delta references pruned history (a parent
  below the prune boundary, a fork pair naming an archived event), the
  window widens back down to the referenced index: archived rows are
  fetched, fork-aware sees is re-derived from the global fork-pair ledger,
  the retained rows' prefix columns are rebuilt from their parents' rows,
  and the ordinary extension pass resumes.  Cost O(widened window^2).
- **Full-rebase fallback**: round stragglers below the frozen vote horizon
  (and late genesis) still take the parent's full batch rebase.

The parent writes its slabs in place where JAX donated them, so every row
handed to the archive's worker is an owned device copy (``clone``), never a
view.  The reference's ``obs`` hooks sit at the same sites: the
``stream_overlap_ratio`` / ``store_spill_queue_depth`` gauges a pass, the
``store_widen_rebases_total`` counter, and the finality phase of each
pass's decided events (``window``, ``widened`` or ``full``); the flight
recorder keys its ring ``"streaming"``.
"""

from __future__ import annotations

import collections
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from tpu_swirld_torch import obs
from tpu_swirld_torch.config import resolve_stream_settings
from tpu_swirld_torch.device import to_host
from tpu_swirld_torch.gpu.incremental import IncrementalConsensus
from tpu_swirld_torch.gpu.pipeline import _bucket
from tpu_swirld_torch.packing import chunk_slices, prepare_events
from tpu_swirld_torch.store.archive import SlabArchive
from tpu_swirld_torch.store.slab import SlabStore


class StreamingConsensus(IncrementalConsensus):
    """Memory-bounded streaming driver (see module doc).

    Keyword arguments beyond :class:`IncrementalConsensus`'s:

    - ``store``: a :class:`~tpu_swirld_torch.store.slab.SlabStore`; default
      a fresh one from ``tile_budget`` / ``tile`` / ``strict_budget``.
    - ``tile_budget``: resident visibility tile budget (None = account
      only); ``strict_budget=True`` raises ``TileBudgetExceeded`` instead
      of counting an overrun.
    - ``ingest_chunk``: most events per internal pass (rounded up to the
      scan chunk).

    ``device`` defaults to ``"cuda"`` and raises without a GPU; pass
    ``device="cpu"`` for the plain PyTorch versions.
    """

    def __init__(
        self,
        members,
        stake=None,
        config=None,
        *,
        store: Optional[SlabStore] = None,
        tile_budget: Optional[int] = None,
        tile: int = 256,
        strict_budget: bool = False,
        ingest_chunk: int = 1024,
        **kw,
    ):
        super().__init__(members, stake, config, **kw)
        self.store = (
            store
            if store is not None
            else SlabStore(
                tile_budget, tile=tile, strict=strict_budget,
                config=self.config,
            )
        )
        self._ingest_chunk = _bucket(max(ingest_chunk, 1), self._chunk)
        # decode overlap: hash the next ingest chunks' event ids on a worker
        # thread while the device runs the current one; the worker computes
        # a pure function and every handoff drains its future
        ss = resolve_stream_settings(self.config)
        self._decode_overlap = bool(ss["decode_overlap"])
        self._decode_depth = max(1, int(ss["decode_queue_depth"]))
        self._staged: Optional[List] = None  # pre-decoded next chunk
        self.decoded_off_thread = 0          # events decoded on the worker
        self._round_hi = 0          # next global round to ledger-retire
        self._widen_answered = False
        self.flightrec_label = "streaming"
        # latency attribution: a pass's decided events are stamped with how
        # the pass decided them: window residency ("window"), an archive
        # widening ("widened") or the full batch fallback ("full")
        self._latency_phase = "window"
        self._latency_phase_default = "window"
        self.widen_rebases = 0      # rebases answered by window widening
        self.full_rebases = 0       # rebases that paid the batch pass

    # ---------------------------------------------------- bounded ingest

    def ingest(self, events=()) -> Dict:
        """Split the delta into bounded chunks and stream them through the
        parent pass.  Commit boundaries never influence outputs, so the
        split only bounds memory and per-pass work."""
        arch = self.store.archive
        t0 = time.perf_counter()
        stall0 = arch.stall_seconds
        events = list(events)
        if len(events) <= self._ingest_chunk:
            st, n_chunks = super().ingest(events), 1
        else:
            merged: Optional[Dict] = None
            n_chunks = 0
            for chunk_ev in self._chunked_deltas(events):
                st = super().ingest(chunk_ev)
                n_chunks += 1
                if merged is None:
                    merged = st
                else:
                    merged["new_events"] += st["new_events"]
                    merged["ordered"] = merged["ordered"] + st["ordered"]
                    merged["rebased"] = merged["rebased"] or st["rebased"]
                    merged["storm_mode"] = (
                        merged["storm_mode"] or st["storm_mode"]
                    )
                    merged["seconds"] += st["seconds"]
                    for k in ("window_size", "pruned_prefix"):
                        merged[k] = st[k]
            st = merged
        wall = max(time.perf_counter() - t0, 1e-9)
        stall = arch.stall_seconds - stall0
        # the share of the ingest wall the driver computed rather than
        # waited behind the spill queue (1.0 = archival off the critical path)
        overlap = max(0.0, min(1.0, (wall - stall) / wall))
        return self._finish_stats(st, n_chunks, overlap)

    def _finish_stats(self, st: Dict, n_chunks: int, overlap: float) -> Dict:
        self._account()
        arch = self.store.archive
        st["ingest_chunks"] = n_chunks
        st["fuse_chunks"] = self._fuse
        st["decode_overlap"] = self._decode_overlap
        st["resident_bytes"] = self.resident_visibility_bytes
        st["archived_rows"] = arch.n_rows
        st["overlap_ratio"] = round(overlap, 4)
        st["spill_queue_depth"] = arch.pending_batches
        o = obs.current()
        if o is not None:
            g = o.registry
            g.gauge("stream_overlap_ratio").set(st["overlap_ratio"])
            g.gauge("store_spill_queue_depth").set(st["spill_queue_depth"])
        return st

    # ----------------------------------------------------- decode overlap

    def _chunked_deltas(self, events: List):
        """Yield the delta's ingest chunks in order.  With decode overlap
        on, one worker thread runs :func:`~tpu_swirld_torch.packing.
        prepare_events` up to ``decode_queue_depth`` chunks ahead.  Each
        yield first drains that chunk's future (which re-raises a worker
        failure here) and stages the pairs for :meth:`_pack_delta`; the
        worker touches no driver state, so overlapped and serial ingest are
        bit-identical."""
        slices = chunk_slices(len(events), self._ingest_chunk)
        if not (self._decode_overlap and len(slices) > 1):
            for s, e in slices:
                yield events[s:e]
            return
        with ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="swirld-decode"
        ) as ex:
            futs = collections.deque()
            it = iter(slices)

            def submit_next():
                nxt = next(it, None)
                if nxt is not None:
                    futs.append(
                        ex.submit(prepare_events, events[nxt[0]:nxt[1]])
                    )

            for _ in range(min(self._decode_depth, len(slices))):
                submit_next()
            while futs:
                pairs = futs.popleft().result()   # drain barrier
                submit_next()                     # keep the queue full
                self._staged = pairs
                self.decoded_off_thread += len(pairs)
                try:
                    yield [ev for ev, _ in pairs]
                finally:
                    self._staged = None

    def _pack_delta(self, events) -> None:
        # take the staged pre-decode when it matches this delta; any other
        # path packs (and hashes) on this thread
        staged, self._staged = self._staged, None
        if staged is not None and len(staged) == len(events):
            self.packer.extend_prepared(staged)
        else:
            super()._pack_delta(events)

    # ------------------------------------------------------------ budget

    def _account(self) -> None:
        if not self._initialized:
            return
        s = self.store
        s.account("anc", self._anc_d.shape)
        if self._sees_d is not self._anc_d:
            s.account("sees", self._sees_d.shape)
        else:
            s.drop("sees")
        s.account("ssm", self._ssm_d.shape)

    def _ensure_row_capacity(self, need: int) -> None:
        if need > self._w_pad:
            self._check_budget(self._next_row_pad(need, self._window_bucket))
        super()._ensure_row_capacity(need)

    def _check_budget(self, w_pad: int) -> bool:
        shapes = {
            "anc": (w_pad, w_pad),
            "ssm": (w_pad, self._wcol_cap),
        }
        if self._initialized and self._sees_d is not self._anc_d:
            shapes["sees"] = (w_pad, w_pad)
        return self.store.check(shapes)

    def _materialize_sees(self) -> None:
        # budget the sees slab coming into existence (first fork pair)
        self.store.check({"sees": (self._w_pad, self._w_pad)})
        super()._materialize_sees()
        self._account()

    def _add_columns(self, events) -> None:
        # budget the column-store growth before the parent commits it.  The
        # bucket of 16 is the reference's (its parent grows by a bucket of
        # 64, as this parent does); kept so budget counts stay identical
        if events:
            batch = _bucket(len(events), 16)
            if self._n_cols + batch > self._wcol_cap:
                new_cap = self._next_col_cap(
                    self._n_cols, batch, self._wcol_cap
                )
                self.store.check({"ssm": (self._w_pad, new_cap)})
        super()._add_columns(events)

    def _stats(self, n_new, ordered, t0, *, rebased,
               count_storm=True, storm=False):
        # a widening-answered rebase is the designed cheap success, not a
        # failed incremental attempt: it must not feed the rebase-storm
        # guard (which would switch to full O(N^2) batch passes)
        if rebased and self._widen_answered:
            count_storm = False
        self._widen_answered = False
        return super()._stats(
            n_new, ordered, t0, rebased=rebased, count_storm=count_storm,
            storm=storm,
        )

    # -------------------------------------------------- retirement hooks

    def _on_prune(self, d: int, w_used: int) -> None:
        lo = self._lo
        if lo + d <= self.store.archive.n_rows:
            return      # re-prune of rows re-admitted by a widening
        # an owned copy: the prune that follows rolls the slab in place
        rows = self._rows(self._anc_d)[:d][:, :w_used].clone()
        parents = self.packer.window_view(lo, lo + d)[0]
        self.store.spill(lo, parents, rows)

    def _on_roll(self, dr: int) -> None:
        lo, base = self._lo, self._r_base
        for k in range(dr):
            r = base + k
            if r < self._round_hi:
                continue
            evs, fam, dec = [], [], []
            for s in range(self._s_cap):
                e = int(self._tab_np[k, s])
                if e < 0:
                    continue
                evs.append(lo + e)
                fam.append(int(self._famous_np[k, s]))
                dl = int(self._dec_np[k, s])
                dec.append(base + dl if dl >= 0 else -1)
            self.store.archive.retire_round(r, evs, fam, dec)
        self._round_hi = max(self._round_hi, base + dr)

    def _on_rebase(self, packed, out, aux) -> None:
        """Reconcile the archive with a batch rebase: the batch slab holds
        full global ancestry rows, so newly pruned rows archive without
        reconstruction, and newly committed rounds land in the ledger."""
        arch = self.store.archive
        lo = self._lo
        if lo > arch.n_rows:
            # only the newly decided rows leave the card, as an owned copy
            rows = aux["anc"][arch.n_rows : lo].clone()
            self.store.spill_full(arch.n_rows, rows)
        tabf = out["wit_table"]
        famf = out["famous"].reshape(tabf.shape)
        decf = out["fame_decided_at"].reshape(tabf.shape)
        for r in range(self._round_hi, min(self._r_base, tabf.shape[0])):
            evs, fam, dec = [], [], []
            for s in range(tabf.shape[1]):
                e = int(tabf[r, s])
                if e < 0:
                    continue
                evs.append(e)
                fam.append(int(famf[r, s]))
                dec.append(int(decf[r, s]))
            arch.retire_round(r, evs, fam, dec)
        self._round_hi = max(self._round_hi, self._r_base)

    # ---------------------------------------------------- rebase routing

    def _rebase(self) -> List[int]:
        """Widen-or-full: re-fetch archived rows when the trigger is a
        pruned-history reference; pay the batch pass only for round
        stragglers below the committed horizon (and cold starts)."""
        if self._initialized and self._storm_left == 0:
            target = self._widen_target()
            if target is not None and self._try_widen(target):
                if not self._needs_rebase_pre():
                    n_new = len(self.packer) - self._n_done
                    ordered, need = self._extend_pass(n_new)
                    if not need:
                        self.widen_rebases += 1
                        self._widen_answered = True
                        self._latency_phase = "widened"
                        o = obs.current()
                        if o is not None:
                            o.registry.counter(
                                "store_widen_rebases_total"
                            ).inc()
                        return ordered
        self.full_rebases += 1
        self._latency_phase = "full"
        return super()._rebase()

    def _widen_target(self) -> Optional[int]:
        """The prune boundary a widening must reach to answer the pending
        delta, or None when only a full batch rebase is exact (late
        genesis, parent rounds below the committed round window)."""
        p = self.packer
        lo, n0, n1 = self._lo, self._n_done, len(p)
        if n1 <= n0:
            return None
        new_par = p.window_view(n0, n1)[0]
        live = new_par >= 0
        if self._r_base > 0 and (~live[:, 0]).any():
            return None                      # late genesis straggler
        lo2 = lo
        if live.any():
            lo2 = min(lo2, int(new_par[live].min()))
        # parent-round horizon from the global round mirror, valid for every
        # processed parent, pruned or resident
        both_old = live[:, 0] & (new_par < n0).all(axis=1)
        if both_old.any():
            pg = np.where(both_old[:, None], new_par, 0)
            r0 = np.maximum(
                self._round_g[pg[:, 0]], self._round_g[pg[:, 1]]
            )
            if int(r0[both_old].min()) < self._r_base:
                return None                  # committed-round straggler
        if p.n_fork_pairs > self._g_done:
            pairs = p.fork_pairs_view(self._g_done)
            lo2 = min(lo2, int(pairs[:, 1:].min()))
        if lo2 >= lo or lo2 < 0:
            return None       # nothing pruned is referenced -> full path
        return lo2

    def _host_window(self, has_forks: bool):
        """Owned host copies of the carried ``anc``, ``sees`` (``anc``'s
        while fork-free) and ``ssm`` slabs, as a widening rebuilds them."""
        anc_cur = to_host(self._anc_d, copy=True)
        sees_cur = to_host(self._sees_d, copy=True) if has_forks else anc_cur
        return anc_cur, sees_cur, to_host(self._ssm_d, copy=True)

    def _try_widen(self, lo2: int) -> bool:
        """Rebuild the carried window at the lower boundary ``lo2``:
        re-fetch archived ancestry / sees rows and rebuild the retained
        rows' pruned-prefix columns.  Exact: every value is a pure DAG
        function of the history the card first computed it from."""
        lo, hi = self._lo, self._n_done
        delta = lo - lo2
        arch = self.store.archive
        if lo > arch.n_rows:
            return False                     # archive gap: full rebase
        w_used = hi - lo
        w2 = w_used + delta
        new_pad = max(
            self._w_pad,
            _bucket(w2 + 2 * self._chunk, self._window_bucket),
        )
        self._check_budget(new_pad)          # strict mode raises here
        has_forks = self._fork_np.shape[0] > 0
        # warm the archive's row cache while the pulls below run
        arch.prefetch(lo2, lo)
        # ---- owned host copies of the live window
        anc_cur, sees_cur, ssm_cur = self._host_window(has_forks)
        # ---- archived rows over global columns [lo2, hi), decompressed
        # straight into the widened slab (anc_pre is a view of anc_w)
        creators_g = self.packer.window_view(0, hi)[1]
        fp_g = self.packer.fork_pairs_view(0)
        anc_w = np.zeros((new_pad, new_pad), dtype=bool)
        anc_pre, sees_pre = self.store.fetch(
            lo2, lo, lo2, hi,
            creator=creators_g[lo2:hi] if has_forks else None,
            fork_pairs=fp_g,
            n_members=self._m,
            out=anc_w[:delta, :w2],
        )
        # ---- the retained rows' prefix columns [lo2, lo):
        # anc(e) ∩ [lo2, lo) = ∪_parents anc(p) ∩ [lo2, lo) for e >= lo
        # (parents below lo2 contribute nothing there: topo order)
        par_g = self.packer.window_view(lo, hi)[0]
        pb = np.zeros((w_used, delta), dtype=bool)
        for i in range(w_used):
            for p in par_g[i]:
                p = int(p)
                if p < lo2:
                    continue
                if p < lo:
                    pb[i] |= anc_pre[p - lo2, :delta]
                else:
                    pb[i] |= pb[p - lo]
        # ---- assemble the widened slabs (prefix rows already in place)
        anc_w[delta : delta + w_used, :delta] = pb
        anc_w[delta : delta + w_used, delta : delta + w_used] = (
            anc_cur[:w_used, :w_used]
        )
        if has_forks:
            sees_w = np.zeros((new_pad, new_pad), dtype=bool)
            sees_w[:delta, :w2] = sees_pre
            sees_w[delta : delta + w_used, delta : delta + w_used] = (
                sees_cur[:w_used, :w_used]
            )
            # fork poisoning of the rebuilt prefix columns only; the
            # retained columns keep the card's values
            derived = SlabArchive.derive_sees(
                anc_w[delta : delta + w_used, :w2], lo2,
                creators_g[lo2:hi], fp_g, self._m,
            )
            sees_w[delta : delta + w_used, :delta] = derived[:, :delta]
        # ---- column store: rows shift down; re-admitted rows are never
        # queried (scans read only scanned rows and witness rows)
        ssm_w = np.zeros((new_pad, self._wcol_cap), dtype=bool)
        ssm_w[delta : delta + w_used] = ssm_cur[:w_used]
        # ---- host mirrors at the widened boundary
        self._w_pad = new_pad
        self._alloc_mirrors(new_pad)
        pg2, cre2, coin2, t2 = self.packer.window_view(lo2, hi)
        pg2 = np.asarray(pg2, dtype=np.int64)
        self._parents_w[:w2] = np.where(pg2 >= lo2, pg2 - lo2, -1)
        self._creator_w[:w2] = cre2
        self._coin_w[:w2] = coin2
        self._t_w[:w2] = t2
        self._rnd_w[:w2] = self._round_g[lo2:hi]
        self._wits_w[:w2] = self._wits_g[lo2:hi]
        self._recv_w[:w2] = self._rr_g[lo2:hi] >= 0
        self._recompute_depth(w2)
        self._rebuild_member_table(w2)
        # vetted fork pairs remapped to lo2 (the pending delta's pairs are
        # admitted by the extension pass)
        if self._g_done > 0:
            fp = np.asarray(fp_g[: self._g_done], dtype=np.int64)
            self._fork_np = np.stack(
                [fp[:, 0], fp[:, 1] - lo2, fp[:, 2] - lo2], axis=1
            ).astype(np.int32)
        else:
            self._fork_np = np.zeros((0, 3), np.int32)
        # witness-table entries and the column store shift by delta
        self._tab_np = np.where(
            self._tab_np >= 0, self._tab_np + delta, -1
        ).astype(np.int32)
        ce = np.where(
            self._col_events >= 0, self._col_events + delta, -1
        ).astype(np.int32)
        self._col_events = ce
        for pos in range(self._n_cols):
            if ce[pos] >= 0:
                self._colpos_w[ce[pos]] = pos
        # ---- push to the card (sees stays the ancestry slab while
        # fork-free) through the slab_put seam
        self._anc_d = self._put(anc_w)
        self._sees_d = self._put(sees_w) if has_forks else self._anc_d
        self._ssm_d = self._put(ssm_w)
        self._lo = lo2
        self._rows_hi = w2
        self._account()
        return True
