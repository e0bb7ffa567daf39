"""The incremental (windowed) consensus driver (PyTorch): carried device
state between passes.

Counterpart of the incremental half of ``tpu_swirld/tpu/pipeline.py``
(``ExtensionKernels`` onward), with the same names and bit-identical
results: after every :meth:`IncrementalConsensus.ingest` the cumulative
:meth:`~IncrementalConsensus.result` equals a cold
:func:`~tpu_swirld_torch.gpu.pipeline.run_consensus` over the same packed
DAG.  The driver carries the ancestry / sees slabs and the strongly-sees
column store on the device and the witness table, rounds and per-round
decisions in host mirrors, extends them with the new events' rows and
columns only, and prunes the decided prefix, so matrix work scales with the
undecided window, not with history.  What window locality cannot answer
(a pruned parent, a straggler below the round window or the frozen vote
horizon, a fork pair naming a pruned event, table overflow) is detected and
answered by a full recompute through the batch ``_columns_pass`` (a
"rebase").

The extension's boolean hops and strongly-sees blocks go through an
:class:`ExtensionKernels` bundle; the default is
:func:`tpu_swirld_torch.gpu.kernels.make_extension_kernels`, so on a CUDA
device every hop launches the hand-written ``bmm_or`` / ``ssm_block``
kernels.  JAX donated the carried slabs; here they are updated in place or
replaced, and every rounds-scan probe runs on a copy of a carry uploaded
from the host mirrors, so a discarded probe never leaves a trace.  The
reference's XLA a-side gather cache is not ported: every block goes
through the kernel seam, the branch the reference runs under its own
Pallas bundle.  Stage seconds and calls go to a
:class:`~tpu_swirld_torch.device.StageClock`, and through it to the
ambient ``obs``; the reference's other ``obs`` hooks sit at the same sites
(a profiler chunk a pass, the ``incremental_*`` gauges, the finality
tracker's births and decisions, the ``rebase_storm`` / ``overflow_heal``
flight-recorder triggers).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_swirld_torch import crypto, obs
from tpu_swirld_torch.config import SwirldConfig, resolve_stream_settings
from tpu_swirld_torch.device import StageClock, resolve_device, to_host
from tpu_swirld_torch.gpu import kernels
from tpu_swirld_torch.gpu.pipeline import (
    ConsensusResult,
    _bucket,
    _columns_pass,
    _pad_slots,
    _suffix_rows,
    _unique_famous,
    _whiten_sigs,
    fame_scan,
    finalize_order,
    order_scan,
    prepare_inputs,
    rounds_chunk_stage,
)
from tpu_swirld_torch.packing import Packer


@dataclasses.dataclass(frozen=True)
class ExtensionKernels:
    """Kernel bundle for the window-extension hot path.

    ``bmm`` is the boolean-matmul hop ``(a, b) -> bool`` of the ancestry
    extension and the forkseen rows; ``ssm_block_fn`` has the signature of
    :func:`~tpu_swirld_torch.gpu.kernels.ssm_block`.  ``None`` means the
    wrapper of :mod:`~tpu_swirld_torch.gpu.kernels` that the batch path
    calls.  The port's kernels are exact, so the seam carries no dtype.
    """

    name: str
    bmm: Optional[object] = None
    ssm_block_fn: Optional[object] = None


#: the reference's default bundle, kept for its name only: its ``None``
#: hops resolve to the same ``bmm_or`` / ``ssm_block`` wrappers that
#: :func:`~tpu_swirld_torch.gpu.kernels.make_extension_kernels` names, so
#: the two bundles behave the same (the port has no XLA hop)
XLA_EXTENSION_KERNELS = ExtensionKernels(name="xla")


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """An owned device copy of a host mirror (``torch.tensor`` always
    copies, so a CPU tensor never shares a mirror's memory)."""
    return torch.tensor(np.ascontiguousarray(a), device=device)


# ------------------------------------------------------------- visibility


def ancestry_extend(anc, parents, b0: int, b1: int, *, block: int, bmm):
    """Extend the carried ancestry slab with rows for blocks [b0, b1), in
    place: :func:`~tpu_swirld_torch.gpu.pipeline.ancestry` resumed over an
    existing slab.  Rows below ``b0 * block`` are read, not recomputed; a
    partly filled boundary block is recomputed idempotently.  Parents of
    pruned events are -1 (exact: a pruned parent's ancestry over the
    retained columns is all-zero).  Slice starts clamp as the reference's
    ``lax.dynamic_slice`` does."""
    n = parents.shape[0]
    dev = parents.device
    n_sq = max(1, math.ceil(math.log2(block)))
    eye = torch.eye(block, dtype=torch.bool, device=dev)
    jj = torch.arange(block, dtype=torch.int64, device=dev)
    for k in range(b0, b1):
        s = k * block
        sc = kernels.slice_start(s, block, n)      # every slice of this block
        pb = parents[sc : sc + block]                           # B,2
        local = pb - s
        lc = (local[:, 0:1] == jj[None, :]) | (local[:, 1:2] == jj[None, :]) | eye
        for _ in range(n_sq):
            lc = lc | bmm(lc, lc)
        pc = pb.clamp(0, n - 1)
        ext = (pb >= 0) & (pb < s)
        g = (anc[pc[:, 0]] & ext[:, 0:1]) | (anc[pc[:, 1]] & ext[:, 1:2])
        rows = bmm(lc, g)                                       # B,N
        rows[:, sc : sc + block] |= lc
        anc[sc : sc + block] = rows
    return anc


def extend_visibility_stage(anc, parents, b0, b1, *, block, bmm):
    """Fork-free extension: ancestry blocks only (``sees`` aliases
    ``anc``)."""
    return ancestry_extend(anc, parents, b0, b1, block=block, bmm=bmm)


def extend_visibility_forked_stage(anc, sees, parents, fork_pairs, creator,
                                   b0, b1, row0, *, block, rows, n_members,
                                   bmm):
    """Forked extension: ancestry blocks, then fork-aware sees rows ``[row0,
    row0 + rows)``, both slabs in place.  Only new sees rows are written: an
    event present already never changes its visibility, and old rows over
    new columns are zero (topo order).  ``fork_pairs`` are window-remapped,
    padded with -1 rows."""
    anc = ancestry_extend(anc, parents, b0, b1, block=block, bmm=bmm)
    n = anc.shape[0]
    r0 = kernels.slice_start(row0, rows, n)
    anc_rows = anc[r0 : r0 + rows]
    mcol = fork_pairs[:, 0]
    a = fork_pairs[:, 1].clamp(0, n - 1)
    b = fork_pairs[:, 2].clamp(0, n - 1)
    hit = anc_rows[:, a] & anc_rows[:, b] & (mcol >= 0)[None, :]   # rows,G
    members = torch.arange(n_members, dtype=torch.int64, device=anc.device)
    onehot = mcol[:, None] == members[None, :]
    fseen = bmm(hit, onehot.contiguous())                           # rows,M
    sees[r0 : r0 + rows] = anc_rows & ~fseen[:, creator]
    return anc, sees


# ----------------------------------------------------------- column store


def update_block_stage(ssm_c, part, row0, col0):
    """Write one computed block into the column store, in place, at a start
    clamped as ``lax.dynamic_update_slice`` clamps it."""
    rows, cols = part.shape
    r0 = kernels.slice_start(row0, rows, ssm_c.shape[0])
    c0 = kernels.slice_start(col0, cols, ssm_c.shape[1])
    ssm_c[r0 : r0 + rows, c0 : c0 + cols] = part
    return ssm_c


def _gather_cols(ssm_c, keep_cols):
    """The columns ``keep_cols`` of ``ssm_c`` (-1 = vacate), clipped as the
    reference clips them."""
    kv = keep_cols >= 0
    kc = keep_cols.clamp(0, ssm_c.shape[1] - 1)
    return ssm_c[:, kc] & kv[None, :]


def _roll2(slab, d: int, live):
    return torch.roll(slab, shifts=(-d, -d), dims=(0, 1)) & live[:, None] & live[None, :]


def prune_stage(anc, sees, ssm_c, d, n_used, keep_cols):
    """Shift the carried slabs down/left by ``d`` pruned events, zero the
    vacated tail, and gather the surviving witness columns (``keep_cols``
    indexes the old column slots, -1 = vacate).  Capacities are kept."""
    n = anc.shape[0]
    live = torch.arange(n, dtype=torch.int64, device=anc.device) < (n_used - d)
    ssm_c = _gather_cols(torch.roll(ssm_c, -d, dims=0), keep_cols) & live[:, None]
    return _roll2(anc, d, live), _roll2(sees, d, live), ssm_c


def prune_noforks_stage(anc, ssm_c, d, n_used, keep_cols):
    """:func:`prune_stage` for the fork-free path: ``sees`` aliases
    ``anc``, so only two slabs roll."""
    n = anc.shape[0]
    live = torch.arange(n, dtype=torch.int64, device=anc.device) < (n_used - d)
    ssm_c = _gather_cols(torch.roll(ssm_c, -d, dims=0), keep_cols) & live[:, None]
    return _roll2(anc, d, live), ssm_c


def _copy_slab_stage(anc):
    """A distinct sees slab from the ancestry slab (the fork-free alias ends
    when the first fork pair arrives)."""
    return anc.clone()


def compact_cols_stage(ssm_c, keep_cols):
    """Gather the surviving witness columns without a row shift (the
    roll-time compaction)."""
    return _gather_cols(ssm_c, keep_cols)


# ------------------------------------------------------------ rounds scan


def rounds_span_stage(parents_np, ssm_c, col_pos, creator, stake, n_valid,
                      rnd, wits, tab, cnt, overflow, start, r_base, *,
                      tot_stake, r_max, s_max, has_forks, chunk, k_chunks):
    """``k_chunks`` chunks of the rounds scan in one call (events [start,
    start + chunk * k_chunks)): one
    :func:`~tpu_swirld_torch.gpu.pipeline.rounds_chunk_stage` of that
    length.  The carry is copied first, as there, so a probe can be re-run
    from the same carry."""
    return rounds_chunk_stage(
        parents_np, ssm_c, col_pos, creator, stake, n_valid,
        rnd, wits, tab, cnt, overflow, start, r_base, tot_stake=tot_stake,
        r_max=r_max, s_max=s_max, has_forks=has_forks, chunk=chunk * k_chunks,
    )


# ------------------------------------------------------------ fame, order


def _used_slots(wit_table) -> int:
    """One past the last slot column holding a witness in any row (at
    least 1): every slot from there on is empty in every row."""
    used = torch.nonzero((wit_table >= 0).any(0))
    return int(used.max()) + 1 if used.numel() else 1


def fame_window_stage(sees, ssm_c, col_pos, wit_table, creator, coin, stake,
                      *, tot_stake, coin_period, r_max, s_max, has_forks):
    """Fame voting over the retained round window (rows [0, r_max)) only,
    on the used slots (exact, :func:`~tpu_swirld_torch.gpu.pipeline.
    _pad_slots`).  Returns ``(famous, decided_at)`` over ``r_max * s_max``
    slots."""
    tab = wit_table[:r_max]
    s_used = _used_slots(tab)
    famous, dec = fame_scan(
        tab[:, :s_used].contiguous(), sees, ssm_c, creator, coin, stake,
        tot_stake, coin_period, has_forks=has_forks, col_pos=col_pos,
    )
    return (_pad_slots(famous, r_max, s_used, s_max),
            _pad_slots(dec, r_max, s_used, s_max))


def order_window_stage(anc, wit_table, wit_count, famous, creator,
                       self_parent, t_rank, max_round_local, n_valid,
                       received0, *, r_max, s_max, chain):
    """Order extraction over the first ``r_max`` retained rounds, resuming
    from the carried received flags, on the used slots."""
    tab = wit_table[:r_max]
    s_used = _used_slots(tab)
    fam = famous.reshape(-1)[: r_max * s_max].reshape(r_max, s_max)
    return order_scan(
        anc, tab[:, :s_used].contiguous(), wit_count[:r_max],
        fam[:, :s_used].reshape(-1), creator, self_parent, t_rank,
        max_round_local, n_valid, chain=chain, received0=received0,
    )


# ---------------------------------------------------- incremental driver


class IncrementalConsensus:
    """Steady-state consensus driver with carried device state.

    - :meth:`ingest` appends a gossip delta to the internal
      :class:`~tpu_swirld_torch.packing.Packer`, extends the carried slabs
      with the new rows and columns only, resumes the rounds scan from its
      carried state, re-votes fame over the retained round window and
      extracts the order of newly fame-complete rounds;
    - the decided prefix is pruned: once an event is received (and every
      fork-pair member stays above the cut) its row and column leave every
      slab;
    - every capacity is a session-monotone bucket.

    Exactness: after every pass the committed outputs equal a cold
    :func:`~tpu_swirld_torch.gpu.pipeline.run_consensus` over the full DAG.
    Where window locality is not exact the driver rebases (a full batch
    pass): a parent already pruned or below the round window, a witness at
    or below the frozen vote horizon, a fork pair naming a pruned event,
    witness-table overflow.  After ``storm_threshold`` detected rebases in a
    row it rebases outright for ``storm_cooldown`` passes.

    ``fuse_chunks`` (this keyword, else ``config.fuse_chunks``, else
    ``SWIRLD_FUSE_CHUNKS``, else 8) is how many rounds-scan chunks one probe
    covers; 1 keeps the per-chunk loop.  Outputs are identical at every
    value.  ``device`` defaults to ``"cuda"`` and raises without a GPU; pass
    ``device="cpu"`` for the plain PyTorch versions.

    Observability: set ``finality`` (a :class:`~tpu_swirld_torch.obs.
    FinalityTracker`) and ``flightrec`` (a :class:`~tpu_swirld_torch.obs.
    FlightRecorder`, its ring key ``flightrec_label``); the registry gauges
    and profiler chunks follow the ambient ``obs``.
    """

    #: the stage name of a strongly-sees block (the mesh driver's differs)
    _block_stage = "pipeline.ssm_block_stage"

    def __init__(
        self,
        members,
        stake=None,
        config: Optional[SwirldConfig] = None,
        *,
        block: int = 128,
        chunk: int = 256,
        window_bucket: int = 1024,
        prune_min: Optional[int] = None,
        ssm_block_fn=None,
        extension_kernels: Optional[ExtensionKernels] = None,
        storm_threshold: int = 3,
        storm_cooldown: int = 8,
        slab_put=None,
        fuse_chunks: Optional[int] = None,
        device="cuda",
    ):
        if stake is None:
            stake = [1] * len(members)
        self.device = resolve_device(device)
        self.packer = Packer(members, stake)
        self.config = config or SwirldConfig(n_members=len(members))
        self._block = block
        self._chunk = max(32, chunk)
        if fuse_chunks is None:
            fuse_chunks = resolve_stream_settings(self.config)["fuse_chunks"]
        self._fuse = max(1, int(fuse_chunks))
        self._window_bucket = max(256, window_bucket)
        self._prune_min = (
            prune_min if prune_min is not None else self._window_bucket // 4
        )
        self._kern = (
            extension_kernels if extension_kernels is not None
            else kernels.make_extension_kernels()
        )
        self._bmm = self._kern.bmm or kernels.bmm_or
        self._ssm_block_fn = (
            ssm_block_fn or self._kern.ssm_block_fn or kernels.ssm_block
        )
        # slab placement seam: every from-scratch slab push (rebase) goes
        # through it; host arrays and device tensors both come back as
        # tensors on the driver's device
        self._put = (
            slab_put if slab_put is not None
            else (lambda a: torch.as_tensor(a, device=self.device))
        )
        self.stages = StageClock(self.device)
        self._stake = np.asarray(stake, dtype=np.int32)
        self._tot = kernels.check_stake_envelope(self._stake.sum())
        self._m = len(members)

        # global committed outputs (amortized-growth buffers)
        self._round_g = np.zeros((0,), np.int32)
        self._wits_g = np.zeros((0,), bool)
        self._rr_g = np.zeros((0,), np.int32)
        self._cts_g = np.zeros((0,), np.int64)
        self._order: List[int] = []
        self._famous_committed: Dict[int, bool] = {}

        # consensus cursors (global rounds / indices)
        self._initialized = False
        self._n_done = 0            # events consumed from the packer
        self._lo = 0                # pruned prefix length (global index)
        self._r_base = 0            # global round of witness-table row 0
        self._consensus_round = 0   # next round to order (== r_base at rest)
        self._frozen_vote_hi = 0    # votes at rounds < this are committed
        self._max_round = 0
        self._g_done = 0            # fork pairs already vetted

        # session-monotone capacity buckets
        self._w_pad = 0             # window row capacity
        self._rows_hi = 0           # high-water of materialized window rows
        self._wcol_cap = 256        # ssm column capacity
        self._r_cap = 32            # witness-table rows
        self._r_fame = 8            # fame round window
        self._r_ord = 4             # order round window
        self._chain_cap = 32        # self-chain walk depth
        self._k_cap = 8             # member-table columns
        self._g_cap = 0             # fork-pair rows
        self._s_cap = self._m + 1   # witness slots per round

        # telemetry
        self.passes = 0
        self.rebases = 0
        self.overflow_heals = 0     # capacity growths absorbed by rebases
        self.scan_steps = 0         # per-event rounds steps of extension passes
        self.finality = None        # obs.FinalityTracker: births at ingest,
                                    # decided at commit (_stats)
        self.flightrec = None       # obs.FlightRecorder: storm / overflow
                                    # triggers dump post-mortems
        self.flightrec_label = "incremental"
        # latency-phase attribution: the streaming driver stamps each pass's
        # decided events "window" / "widened" / "full"; None here
        self._latency_phase = None
        self._latency_phase_default = None

        # rebase-storm guard: after `storm_threshold` consecutive detected
        # rebases the driver rebases outright for `storm_cooldown` passes,
        # then re-admits the incremental path with a fresh slate
        # (hysteresis); storm_threshold <= 0 disables the guard
        self.storm_threshold = storm_threshold
        self.storm_cooldown = max(1, storm_cooldown)
        self.storm_entries = 0            # times the guard engaged
        self.storm_rebases = 0            # rebases run in storm mode
        self.max_consecutive_rebases = 0  # worst detect-rebase streak
        self._consec_rebases = 0
        self._storm_left = 0

    # ------------------------------------------- capacity growth policy

    @staticmethod
    def _next_row_pad(need: int, window_bucket: int) -> int:
        return _bucket(need + window_bucket // 2, window_bucket)

    @staticmethod
    def _next_col_cap(n_cols: int, batch: int, cap: int) -> int:
        return _bucket(max(n_cols + batch, cap * 2), 256)

    @staticmethod
    def _next_k_cap(need: int) -> int:
        return _bucket(need + need // 4 + 8, 32)

    # -------------------------------------------------------- public API

    def __len__(self) -> int:
        return self._n_done

    @property
    def window_size(self) -> int:
        return self._n_done - self._lo

    @property
    def pruned_prefix(self) -> int:
        return self._lo

    @property
    def storm_mode(self) -> bool:
        """True while the rebase-storm guard holds the driver in
        full-recompute mode."""
        return self._storm_left > 0

    @property
    def resident_visibility_bytes(self) -> int:
        """Bytes of the device-resident window slabs (anc, sees unless it
        aliases anc, the column store).  Zero before the first pass."""
        if not self._initialized:
            return 0
        n = int(self._anc_d.nbytes + self._ssm_d.nbytes)
        if self._sees_d is not self._anc_d:
            n += int(self._sees_d.nbytes)
        return n

    # Retirement hooks: no-ops here, for a streaming driver to override.
    # Called with the PRE-mutation state.

    def _on_prune(self, d: int, w_used: int) -> None:
        """About to drop window rows [0, d) of [0, w_used)."""

    def _on_roll(self, dr: int) -> None:
        """About to roll witness-table rows [0, dr) out of the window."""

    def _on_rebase(self, packed, out, aux) -> None:
        """A batch rebase decided everything up to the new ``self._lo``;
        ``aux`` still holds the full-DAG device slabs."""

    def _pack_delta(self, events) -> None:
        """Append a gossip delta to the packer."""
        self.packer.extend(events)

    def ingest(self, events=()) -> Dict:
        """Feed a topo-ordered gossip delta; run one incremental pass.

        Returns a per-pass stats dict: ``new_events``, ``ordered`` (the
        packed indices newly committed to the total order, in order),
        ``window_size``, ``pruned_prefix``, ``rebased``, ``storm_mode``,
        ``seconds``.
        """
        t0 = time.perf_counter()
        o = obs.current()
        if o is not None and o.profiler is not None:
            # one profiler chunk a pass: _stats closes it on every path
            o.profiler.begin_chunk()
        n_before = len(self.packer)
        self._pack_delta(events)
        n_total = len(self.packer)
        if self.finality is not None and n_total > n_before:
            # birth = the tick this delta entered the driver, in the
            # tracker's clock's unit
            self.finality.mark_births(n_before, n_total)
        n_new = n_total - self._n_done
        if n_total == 0 or (n_new == 0 and self._initialized):
            return self._stats(n_new, [], t0, rebased=False)
        if not self._initialized:
            # the cold start is a rebase mechanically, not a failed
            # incremental attempt: it never feeds the guard
            ordered = self._rebase()
            return self._stats(n_new, ordered, t0, rebased=True,
                               count_storm=False)
        if self._storm_left > 0:
            self._storm_left -= 1
            self.storm_rebases += 1
            if self._storm_left == 0:
                self._consec_rebases = 0   # hysteresis exit: fresh slate
            ordered = self._rebase()
            return self._stats(n_new, ordered, t0, rebased=True,
                               count_storm=False, storm=True)
        if self._needs_rebase_pre():
            ordered = self._rebase()
            return self._stats(n_new, ordered, t0, rebased=True)
        ordered, need_rebase = self._extend_pass(n_new)
        if need_rebase:
            ordered = self._rebase()
            return self._stats(n_new, ordered, t0, rebased=True)
        return self._stats(n_new, ordered, t0, rebased=False)

    def result(self) -> ConsensusResult:
        """Cumulative consensus state, bit-identical to a cold
        :func:`~tpu_swirld_torch.gpu.pipeline.run_consensus` over the same
        packed DAG."""
        n = self._n_done
        famous: Dict[int, Optional[bool]] = dict(self._famous_committed)
        if self._initialized:
            for k in range(self._r_cap):
                for s in range(self._s_cap):
                    e = int(self._tab_np[k, s])
                    if e < 0:
                        continue
                    f = int(self._famous_np[k, s])
                    famous[self._lo + e] = None if f < 0 else bool(f)
        return ConsensusResult(
            n=n,
            round=self._round_g[:n].copy(),
            is_witness=self._wits_g[:n].copy(),
            famous=famous,
            round_received=self._rr_g[:n].copy(),
            consensus_ts=self._cts_g[:n].copy(),
            order=list(self._order),
            max_round=self._max_round,
            timings={
                "passes": self.passes,
                "rebases": self.rebases,
                "window_size": self.window_size,
                "pruned_prefix": self.pruned_prefix,
                "storm_entries": self.storm_entries,
                "storm_rebases": self.storm_rebases,
                "max_consecutive_rebases": self.max_consecutive_rebases,
                "overflow_heals": self.overflow_heals,
                "scan_steps": self.scan_steps,
                "stage_seconds": dict(self.stages.seconds),
                "stage_calls": dict(self.stages.calls),
            },
        )

    # ------------------------------------------------------ pass plumbing

    def _stats(self, n_new, ordered, t0, *, rebased,
               count_storm=True, storm=False):
        self.passes += 1
        if rebased:
            self.rebases += 1
            if count_storm:
                # a detected rebase: an incremental attempt that failed
                self._consec_rebases += 1
                self.max_consecutive_rebases = max(
                    self.max_consecutive_rebases, self._consec_rebases
                )
                if (
                    self.storm_threshold > 0
                    and self._consec_rebases >= self.storm_threshold
                ):
                    self.storm_entries += 1
                    self._storm_left = self.storm_cooldown
                    self._trigger(
                        "rebase_storm",
                        {"consecutive": self._consec_rebases,
                         "cooldown": self.storm_cooldown},
                        len(self._order),
                    )
        elif n_new > 0:
            self._consec_rebases = 0   # a clean incremental pass
        # a storm-mode pass reports as such even when it was the last one
        # of the cooldown (_storm_left was decremented before _stats)
        in_storm = storm or self._storm_left > 0
        o = obs.current()
        if o is not None:
            g = o.registry
            g.gauge("incremental_window_size").set(self.window_size)
            g.gauge("incremental_pruned_prefix").set(self.pruned_prefix)
            g.gauge("incremental_r_base").set(self._r_base)
            g.gauge("incremental_storm_mode").set(1.0 if in_storm else 0.0)
            g.gauge("incremental_consecutive_rebases").set(
                self._consec_rebases
            )
            g.counter("incremental_passes_total").inc()
            if rebased:
                g.counter("incremental_rebases_total").inc()
            if storm:
                g.counter("incremental_storm_rebases_total").inc()
        fin = self.finality
        if fin is not None and ordered:
            phase = self._latency_phase
            now = fin.now()
            for gi in ordered:
                gi = int(gi)
                fin.record_decided(
                    gi, int(self._round_g[gi]), int(self._rr_g[gi]),
                    now=now, phase=phase,
                )
            fin.set_watermark(
                self.flightrec_label, len(self._order),
                self._consensus_round - 1,
            )
        self._latency_phase = self._latency_phase_default
        if o is not None and o.profiler is not None:
            o.profiler.end_chunk(n_events=int(n_new))
        return {
            "new_events": int(n_new),
            "ordered": ordered,
            "window_size": self.window_size,
            "pruned_prefix": self.pruned_prefix,
            "rebased": bool(rebased),
            "storm_mode": in_storm,
            "seconds": round(time.perf_counter() - t0, 6),
        }

    def _trigger(self, reason: str, detail: Dict, decided: int) -> None:
        """A flight-recorder trigger with this driver's decided frontier
        (a no-op without a recorder)."""
        if self.flightrec is None:
            return
        o = obs.current()
        self.flightrec.trigger(
            reason, node=self.flightrec_label, detail=detail,
            decided_frontier={
                self.flightrec_label: {
                    "decided": decided, "round": self._consensus_round,
                },
            },
            registry=o.registry if o is not None else None,
        )

    def _grow_global(self, n: int) -> None:
        if self._round_g.shape[0] >= n:
            return
        cap = max(n, 2 * max(1, self._round_g.shape[0]))

        def regrow(a, fill, dtype):
            out = np.full((cap,), fill, dtype)
            out[: a.shape[0]] = a
            return out

        self._round_g = regrow(self._round_g, 0, np.int32)
        self._wits_g = regrow(self._wits_g, False, bool)
        self._rr_g = regrow(self._rr_g, -1, np.int32)
        self._cts_g = regrow(self._cts_g, 0, np.int64)

    def _needs_rebase_pre(self) -> bool:
        """Host-side guards that run before touching device state."""
        p = self.packer
        lo, n0, n1 = self._lo, self._n_done, len(p)
        new_par, _, _, _ = p.window_view(n0, n1)
        live = new_par >= 0
        if live.any() and int(new_par[live].min()) < lo:
            return True          # parent already pruned
        if self._r_base > 0 and (~live[:, 0]).any():
            return True          # late genesis: a round-0 straggler
        # parent rounds must stay inside the retained round window; events
        # whose parents are both already processed are checked against the
        # round mirror, the rest by induction through this delta
        both_old = live[:, 0] & (new_par < n0).all(axis=1)
        if both_old.any():
            pw = np.where(both_old[:, None], new_par - lo, 0)
            r0 = self._rnd_w[pw].max(axis=1)
            if int(r0[both_old].min()) < self._r_base:
                return True
        # new fork pairs must not name pruned events
        if p.n_fork_pairs > self._g_done:
            pairs = p.fork_pairs_view(self._g_done)
            if int(pairs[:, 1:].min()) < lo:
                return True
        return False

    # --------------------------------------------------- capacity buckets

    def _ensure_row_capacity(self, need: int) -> None:
        if need <= self._w_pad:
            return
        new_pad = self._next_row_pad(need, self._window_bucket)
        self._grow_slabs(new_pad)
        self._grow_mirrors(new_pad)
        self._w_pad = new_pad

    def _grow_slabs(self, new_pad: int) -> None:
        """Zero-extend the carried slabs to ``new_pad`` rows (and ``anc`` /
        ``sees`` to as many columns)."""
        aliased = self._sees_d is self._anc_d

        def grow(slab, cols):
            out = torch.zeros((new_pad, cols), dtype=torch.bool, device=self.device)
            out[: slab.shape[0], : slab.shape[1]] = slab
            return out

        self._anc_d = grow(self._anc_d, new_pad)
        self._sees_d = self._anc_d if aliased else grow(self._sees_d, new_pad)
        self._ssm_d = grow(self._ssm_d, self._ssm_d.shape[1])

    def _grow_mirrors(self, new_pad: int) -> None:
        def regrow(a, fill):
            out = np.full((new_pad,) + a.shape[1:], fill, a.dtype)
            out[: a.shape[0]] = a
            return out

        self._parents_w = regrow(self._parents_w, -1)
        self._creator_w = regrow(self._creator_w, 0)
        self._coin_w = regrow(self._coin_w, 0)
        self._t_w = regrow(self._t_w, 0)
        self._rnd_w = regrow(self._rnd_w, 0)
        self._wits_w = regrow(self._wits_w, False)
        self._recv_w = regrow(self._recv_w, False)
        self._depth_w = regrow(self._depth_w, 0)
        self._colpos_w = regrow(self._colpos_w, -1)

    def _alloc_mirrors(self, w_pad: int) -> None:
        self._parents_w = np.full((w_pad, 2), -1, np.int32)
        self._creator_w = np.zeros((w_pad,), np.int32)
        self._coin_w = np.zeros((w_pad,), np.uint8)
        self._t_w = np.zeros((w_pad,), np.int64)
        self._rnd_w = np.zeros((w_pad,), np.int32)
        self._wits_w = np.zeros((w_pad,), bool)
        self._recv_w = np.zeros((w_pad,), bool)
        self._depth_w = np.zeros((w_pad,), np.int32)
        self._colpos_w = np.full((w_pad,), -1, np.int32)

    def _grow_k(self, need: int) -> None:
        new_k = self._next_k_cap(need)
        out = np.full((self._m, new_k), -1, np.int32)
        out[:, : self._k_cap] = self._mt_np
        self._mt_np = out
        self._k_cap = new_k

    def _rebuild_member_table(self, w_used: int) -> None:
        """Member-table rebuild over window rows [0, w_used): per member,
        its window events in window (topo) order."""
        cre = self._creator_w[:w_used].astype(np.int64)
        counts = np.bincount(cre, minlength=self._m)
        kmax = int(counts.max(initial=0))
        if kmax > self._k_cap:
            self._k_cap = self._next_k_cap(kmax)
        self._mt_np = np.full((self._m, self._k_cap), -1, np.int32)
        self._mcount = counts.astype(np.int32)
        if w_used:
            order = np.argsort(cre, kind="stable")
            starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
            kpos = np.arange(w_used, dtype=np.int64) - np.repeat(starts, counts)
            self._mt_np[cre[order], kpos] = order.astype(np.int32)

    def _materialize_sees(self) -> None:
        """Fork-free -> forked transition: give sees its own slab.  Exact
        without recomputation: the first fork pair's second member is in the
        pending delta, so every existing row's sees row equals its ancestry
        row; the extension then writes the new rows on the copy."""
        if self._initialized and self._sees_d is self._anc_d:
            self._sees_d = self.stages.stage_call(
                "pipeline.sees_materialize", _copy_slab_stage, self._anc_d
            )

    def _recompute_depth(self, w_used: int) -> None:
        d = self._depth_w
        par = self._parents_w
        for i in range(w_used):
            sp = par[i, 0]
            d[i] = 1 + (d[sp] if sp >= 0 else 0)
        if int(d[:w_used].max(initial=0)) > self._chain_cap:
            self._chain_cap = _bucket(int(d[:w_used].max()), 32)

    def _fork_pairs_padded(self) -> np.ndarray:
        g = self._fork_np.shape[0]
        if g > self._g_cap:
            self._g_cap = _bucket(g, 8)
        out = np.full((self._g_cap, 3), -1, np.int32)
        out[:g] = self._fork_np
        return out

    # ----------------------------------------------------- column store

    def _ssm_block(self, cols: np.ndarray, row0: int, rows: int):
        """One strongly-sees block of window rows [row0, row0 + rows) x the
        column events ``cols`` through the kernel seam."""
        return self.stages.stage_call(
            self._block_stage, self._ssm_block_fn,
            self._sees_d, _upload(self._mt_np, self.device),
            _upload(self._stake, self.device), _upload(cols, self.device),
            row0, rows=rows, tot_stake=self._tot,
        )

    def _add_columns(self, events: List[int]) -> None:
        if not events:
            return
        # coarse grain, as on the batch path (padded cols are -1 -> masked)
        batch = _bucket(len(events), 64)
        if self._n_cols + batch > self._wcol_cap:
            new_cap = self._next_col_cap(self._n_cols, batch, self._wcol_cap)
            grown = torch.zeros(
                (self._ssm_d.shape[0], new_cap), dtype=torch.bool, device=self.device
            )
            grown[:, : self._wcol_cap] = self._ssm_d
            self._ssm_d = grown
            ce = np.full((new_cap,), -1, np.int32)
            ce[: self._wcol_cap] = self._col_events
            self._col_events = ce
            self._wcol_cap = new_cap
        cols_arr = np.full((batch,), -1, np.int32)
        cols_arr[: len(events)] = events
        # suffix cut: rows below the earliest new witness can never
        # strongly-see it (the slab already holds their exact value, zero)
        row0, rows_eff = _suffix_rows(self._rows_hi, min(events), self._w_pad)
        part = self._ssm_block(cols_arr, row0, rows_eff)
        for j, e in enumerate(events):
            self._colpos_w[e] = self._n_cols + j
            self._col_events[self._n_cols + j] = e
        # written in place (through a row view over a group)
        self.stages.stage_call(
            "pipeline.inc_ssm_update", update_block_stage,
            self._rows(self._ssm_d), part, row0, self._n_cols,
        )
        self._n_cols += len(events)

    # ------------------------------------------------------- extend pass

    def _missing_columns(self, tab: torch.Tensor) -> np.ndarray:
        """Witnesses registered in ``tab`` that have no column yet."""
        tab_h = to_host(tab)
        registered = np.unique(tab_h[tab_h >= 0])
        return registered[self._colpos_w[registered] < 0]

    def _rounds_span_fixpoint(self, creator_d, stake_d, n_valid, has_forks,
                              w0, n_pad_new):
        """Fused rounds scan: spans of up to ``self._fuse`` chunks per call
        (:func:`rounds_span_stage`), each run to a witness-column fixpoint.
        Returns the accepted final carry or ``None`` on round/slot overflow
        (the caller rebases; the per-chunk loop also commits nothing once
        its sticky overflow bit is set).

        Every probe re-runs the span from the same carry, uploaded from the
        host mirrors once per span and never written (the stage copies
        it), and is accepted only when every witness registered
        in its table already had a column for the whole run.  A missing
        column reads as not-strongly-seen (under-promotion only), so an
        accepted probe consumed nothing a fully informed run would not: its
        outputs equal the per-chunk loop's.  Each failed probe adds >= 1
        column, so the loop ends within span_len probes."""
        chunk = self._chunk
        n_chunks = n_pad_new // chunk
        carry_h = (self._rnd_w, self._wits_w, self._tab_np, self._cnt_np)
        state = None
        ci = 0
        while ci < n_chunks:
            k = min(self._fuse, n_chunks - ci)
            start = w0 + ci * chunk
            span_len = k * chunk
            fresh = tuple(_upload(a, self.device) for a in carry_h)
            overflow0 = torch.zeros((1,), dtype=torch.int32, device=self.device)
            for _attempt in range(span_len + 1):
                out = self.stages.stage_call_fused(
                    "pipeline.rounds_span_stage", k, rounds_span_stage,
                    self._parents_w, self._rows(self._ssm_d, (start, start + span_len)),
                    _upload(self._colpos_w, self.device), creator_d, stake_d,
                    n_valid, *fresh, overflow0,
                    start, self._r_base, tot_stake=self._tot,
                    r_max=self._r_cap, s_max=self._s_cap, has_forks=has_forks,
                    chunk=chunk, k_chunks=k,
                )
                self.scan_steps += span_len
                missing = self._missing_columns(out[2])
                if missing.size == 0:
                    state = out
                    break
                self._add_columns([int(e) for e in missing])
            else:
                raise RuntimeError("witness-column span did not converge")
            if int(to_host(state[4])[0]):
                return None
            ci += k
            if ci < n_chunks:
                # the next span resumes from this span's accepted carry,
                # pulled to owned host arrays once per span
                carry_h = tuple(to_host(x, copy=True) for x in state[:4])
        return state

    def _rounds_chunk_loop(self, creator_d, stake_d, n_valid, has_forks, w0,
                           n_pad_new):
        """The per-chunk rounds loop (``fuse_chunks <= 1``): each chunk re-runs
        only when a witness it registered without a column was queried by a
        later event of the same chunk."""
        chunk = self._chunk
        dev = self.device
        state = (
            _upload(self._rnd_w, dev), _upload(self._wits_w, dev),
            _upload(self._tab_np, dev), _upload(self._cnt_np, dev),
            torch.zeros((1,), dtype=torch.int32, device=dev),
        )
        for start in range(w0, w0 + n_pad_new, chunk):
            for _attempt in range(chunk + 1):
                out = self.stages.stage_call(
                    "pipeline.rounds_chunk_stage", rounds_chunk_stage,
                    self._parents_w, self._rows(self._ssm_d, (start, start + chunk)),
                    _upload(self._colpos_w, dev), creator_d, stake_d,
                    n_valid, *state, start, self._r_base,
                    tot_stake=self._tot, r_max=self._r_cap,
                    s_max=self._s_cap, has_forks=has_forks, chunk=chunk,
                )
                self.scan_steps += chunk
                missing = self._missing_columns(out[2])
                if missing.size == 0:
                    state = out
                    break
                rnd_np = to_host(out[0])
                ce = np.arange(start, start + chunk, dtype=np.int64)
                pc = self._parents_w[ce]
                r0 = np.where(
                    pc[:, 0] < 0,
                    -1,
                    np.maximum(rnd_np[np.maximum(pc[:, 0], 0)],
                               rnd_np[np.maximum(pc[:, 1], 0)]),
                )
                affected = False
                for w in missing:
                    if w < start or np.any((ce > w) & (r0 == rnd_np[w])):
                        affected = True
                        break
                self._add_columns([int(e) for e in missing])
                if not affected:
                    state = out
                    break
            else:
                raise RuntimeError("witness-column chunk did not converge")
        return state

    def _rows(self, slab, prefetch=None):
        """A carried slab as a stage reads and writes it by global row: the
        slab itself (a group rank's row view, ``parallel.RowGather``, over
        its own rows; ``prefetch`` = ``(start, stop)``, the rows a scan
        reads one by one)."""
        return slab

    def _extend_pass(self, n_new: int) -> Tuple[List[int], bool]:
        """One incremental pass over the ``n_new`` freshly packed events.
        Returns ``(newly_ordered, need_rebase)``."""
        p = self.packer
        dev = self.device
        lo = self._lo
        w0 = self._n_done - lo
        n1 = len(p)
        chunk = self._chunk
        n_pad_new = _bucket(n_new, chunk)
        self._ensure_row_capacity(w0 + n_pad_new)
        sl = slice(w0, w0 + n_new)
        gsl = slice(self._n_done, n1)
        par, creator_new, coin_new, t_new = p.window_view(self._n_done, n1)
        parw = np.where(par >= 0, par - lo, -1).astype(np.int32)
        self._parents_w[sl] = parw
        self._creator_w[sl] = creator_new
        self._coin_w[sl] = coin_new
        self._t_w[sl] = t_new
        for j in range(n_new):
            sp = parw[j, 0]
            self._depth_w[w0 + j] = 1 + (self._depth_w[sp] if sp >= 0 else 0)
        dmax = int(self._depth_w[: w0 + n_new].max(initial=1))
        if dmax > self._chain_cap:
            self._chain_cap = _bucket(dmax, 32)
        # member-table slots for the new events (host bookkeeping; the
        # block kernel gathers straight from the sees slab)
        for j in range(n_new):
            m = int(creator_new[j])
            slot = int(self._mcount[m])
            if slot >= self._k_cap:
                self._grow_k(slot + 1)
            self._mt_np[m, slot] = w0 + j
            self._mcount[m] = slot + 1
        # fork pairs arriving with this delta (window-remapped)
        if p.n_fork_pairs > self._g_done:
            fp = p.fork_pairs_view(self._g_done)
            new_pairs = np.stack(
                [fp[:, 0], fp[:, 1] - lo, fp[:, 2] - lo], axis=1,
            ).astype(np.int32)
            was_forkless = self._fork_np.shape[0] == 0
            self._fork_np = np.concatenate([self._fork_np, new_pairs])
            self._g_done = p.n_fork_pairs
            if was_forkless:
                self._materialize_sees()
        has_forks = self._fork_np.shape[0] > 0

        parents_d = _upload(self._parents_w, dev)
        creator_d = _upload(self._creator_w, dev)
        stake_d = _upload(self._stake, dev)
        n_valid = w0 + n_new

        # ---- visibility extension, then one strongly-sees block covering
        # every new row x every live column
        b0 = w0 // self._block
        b1 = -(-(w0 + n_new) // self._block)
        # the new rows are written in place (through row views over a group)
        if has_forks:
            self.stages.stage_call(
                "pipeline.inc_extend_vis", extend_visibility_forked_stage,
                self._rows(self._anc_d), self._rows(self._sees_d), parents_d,
                _upload(self._fork_pairs_padded(), dev), creator_d, b0, b1,
                w0, block=self._block, rows=n_pad_new, n_members=self._m,
                bmm=self._bmm,
            )
        else:
            self.stages.stage_call(
                "pipeline.inc_extend_vis", extend_visibility_stage,
                self._rows(self._anc_d), parents_d, b0, b1, block=self._block,
                bmm=self._bmm,
            )
            self._sees_d = self._anc_d
        # round-restricted column suffix: a new row i is only ever queried
        # against witness columns of round >= r0(i) - 1, so columns whose
        # witness round sits below min_i r0(i) - 1 skip the block; their
        # entries keep the slab value (zero), which no reader queries
        col_lo = 0
        if self._n_cols and n_new:
            lb = np.zeros((n_new,), np.int32)
            rw = self._rnd_w
            for j in range(n_new):
                p0, p1 = int(parw[j, 0]), int(parw[j, 1])
                b = 0
                if p0 >= 0:
                    b = int(rw[p0]) if p0 < w0 else int(lb[p0 - w0])
                if p1 >= 0:
                    b2 = int(rw[p1]) if p1 < w0 else int(lb[p1 - w0])
                    if b2 > b:
                        b = b2
                lb[j] = b
            min_lb = int(lb.min())
            if min_lb > 1:
                ce = self._col_events[: self._n_cols]
                qm = rw[np.clip(ce, 0, self._w_pad - 1)] >= min_lb - 1
                first = int(np.argmax(qm)) if qm.any() else self._n_cols
                col_lo = (first // 256) * 256
        c_eff = min(
            self._wcol_cap - col_lo,
            _bucket(max(self._n_cols - col_lo, 1), 256),
        )
        if c_eff > 0:   # a zero-width block writes nothing
            part = self._ssm_block(
                self._col_events[col_lo : col_lo + c_eff], w0, n_pad_new
            )
            self.stages.stage_call(
                "pipeline.inc_ssm_update", update_block_stage,
                self._rows(self._ssm_d), part, w0, col_lo,
            )
        self._rows_hi = w0 + n_pad_new

        # ---- resumed rounds scan over the new events only
        if self._fuse > 1:
            state = self._rounds_span_fixpoint(
                creator_d, stake_d, n_valid, has_forks, w0, n_pad_new,
            )
            if state is None:
                return [], True
        else:
            state = self._rounds_chunk_loop(
                creator_d, stake_d, n_valid, has_forks, w0, n_pad_new,
            )

        # owned copies: roll and prune mutate these mirrors in place
        rnd_w, wits_w, tab_np, cnt_np = (
            to_host(x, copy=True) for x in state[:4]
        )
        if int(to_host(state[4])[0]):
            # round/slot overflow -> rebase, which self-heals the capacity
            return [], True
        # straggler guard: a witness below the frozen vote horizon could
        # change a committed tally -> recompute from scratch instead
        wit_mask = wits_w[sl]
        if wit_mask.any():
            wr = rnd_w[sl][wit_mask]
            if int(wr.min()) < max(self._frozen_vote_hi,
                                   self._consensus_round):
                return [], True
        self._rnd_w = rnd_w
        self._wits_w = wits_w
        self._tab_np = tab_np
        self._cnt_np = cnt_np
        self._max_round = max(
            self._max_round, int(rnd_w[: w0 + n_new].max(initial=0))
        )
        self._grow_global(n1)
        self._round_g[gsl] = rnd_w[sl]
        self._wits_g[gsl] = wit_mask
        self._n_done = n1

        # ---- fame over the retained round window
        need = self._max_round - self._r_base + 3
        if need > self._r_fame:
            self._r_fame = min(self._r_cap, _bucket(need, 8))
        colpos_d = _upload(self._colpos_w, dev)
        famous_d, dec_d = self.stages.stage_call(
            "pipeline.inc_fame", fame_window_stage,
            self._rows(self._sees_d), self._rows(self._ssm_d), colpos_d, state[2],
            creator_d, _upload(self._coin_w, dev), stake_d, tot_stake=self._tot,
            coin_period=self.config.coin_period, r_max=self._r_fame,
            s_max=self._s_cap, has_forks=has_forks,
        )
        fam = np.full((self._r_cap, self._s_cap), -1, np.int8)
        fam[: self._r_fame] = to_host(famous_d).reshape(self._r_fame, self._s_cap)
        dec = np.full((self._r_cap, self._s_cap), -1, np.int32)
        dec[: self._r_fame] = to_host(dec_d).reshape(self._r_fame, self._s_cap)
        self._famous_np = fam
        self._dec_np = dec

        # ---- order extraction for newly fame-complete rounds
        k_done = self._consensus_round - self._r_base
        ncomp = 0
        for k in range(self._r_cap):
            valid = self._tab_np[k] >= 0
            if self._cnt_np[k] <= 0:
                break
            if self._max_round < self._r_base + k + 2:
                break
            if (fam[k][valid] < 0).any():
                break
            ncomp = k + 1
        ordered_new: List[int] = []
        if ncomp > k_done:
            if ncomp > self._r_ord:
                self._r_ord = min(self._r_cap, _bucket(ncomp, 2))
            # the scan skips rounds past the fame-complete prefix, so its
            # window only needs to reach ncomp
            r_ord_eff = min(self._r_ord, max(2, _bucket(ncomp, 2)))
            ts_unique, t_rank = np.unique(self._t_w, return_inverse=True)
            t_rank = t_rank.astype(np.int32).reshape(self._t_w.shape)
            rr_d, ts_d, recv_d = self.stages.stage_call(
                "pipeline.inc_order", order_window_stage,
                self._rows(self._anc_d), state[2], state[3],
                _upload(fam.reshape(-1), dev), creator_d, parents_d[:, 0],
                _upload(t_rank, dev), self._max_round - self._r_base,
                n_valid, _upload(self._recv_w, dev),
                r_max=r_ord_eff, s_max=self._s_cap, chain=self._chain_cap,
            )
            rr_np = to_host(rr_d)
            tsr_np = to_host(ts_d)
            recv_np = to_host(recv_d, copy=True)
            max_dec = self._frozen_vote_hi
            for k in range(k_done, ncomp):
                slots = self._tab_np[k]
                fam_events: List[int] = []
                for s in range(self._s_cap):
                    e = int(slots[s])
                    if e < 0:
                        continue
                    is_f = int(fam[k, s]) == 1
                    self._famous_committed[lo + e] = is_f
                    if is_f:
                        fam_events.append(e)
                    max_dec = max(max_dec, self._r_base + int(dec[k, s]))
                ufw = _unique_famous(fam_events, self._creator_w)
                whiten = _whiten_sigs(p.sig(lo + e) for e in ufw)
                entries = []
                for w in np.where(rr_np == k)[0]:
                    gi = lo + int(w)
                    cts = int(ts_unique[tsr_np[w]])
                    tie = crypto.hash_bytes(whiten + p.event_id(gi))
                    entries.append((cts, tie, gi))
                entries.sort(key=lambda x: (x[0], x[1]))
                for cts, _tie, gi in entries:
                    self._rr_g[gi] = self._r_base + k
                    self._cts_g[gi] = cts
                    self._order.append(gi)
                    ordered_new.append(gi)
            self._frozen_vote_hi = max_dec
            self._consensus_round = self._r_base + ncomp
            self._recv_w = recv_np

        # ---- advance the round window and prune the decided prefix
        dr = self._consensus_round - self._r_base
        if dr > 0:
            self._roll_rounds(dr)
        self._maybe_prune()
        return ordered_new, False

    def _roll_rounds(self, dr: int) -> None:
        self._on_roll(dr)

        def roll(a, fill):
            out = np.full_like(a, fill)
            out[:-dr] = a[dr:]
            return out

        self._tab_np = roll(self._tab_np, -1)
        self._cnt_np = roll(self._cnt_np, 0)
        self._famous_np = roll(self._famous_np, -1)
        self._dec_np = roll(self._dec_np, -1)
        self._r_base += dr
        self._maybe_compact_columns()

    def _live_col_mask(self) -> np.ndarray:
        """Which occupied column slots can still be queried: witness rounds
        at or above the committed round window."""
        ce = self._col_events[: self._n_cols]
        valid = ce >= 0
        return valid & (
            self._rnd_w[np.clip(ce, 0, self._w_pad - 1)] >= self._r_base
        )

    def _set_columns(self, kept_events: np.ndarray) -> None:
        """Host column bookkeeping after a gather: ``kept_events`` (window
        indices) now occupy column slots [0, len)."""
        self._colpos_w[:] = -1
        ce = np.full((self._wcol_cap,), -1, np.int32)
        ce[: len(kept_events)] = kept_events
        self._colpos_w[kept_events] = np.arange(len(kept_events), dtype=np.int32)
        self._col_events = ce
        self._n_cols = len(kept_events)

    def _keep_cols(self, pos_live: np.ndarray) -> torch.Tensor:
        keep = np.full((self._wcol_cap,), -1, np.int32)
        keep[: len(pos_live)] = pos_live
        return _upload(keep, self.device)

    def _maybe_compact_columns(self) -> None:
        """Roll-time column compaction: once retired-round columns outnumber
        a quarter of the store, gather the live columns left."""
        live = self._live_col_mask()
        n_live = int(live.sum())
        stale = self._n_cols - n_live
        if stale < 256 or stale * 4 < self._n_cols:
            return
        pos_live = np.where(live)[0]
        kept_events = self._col_events[pos_live]
        self._ssm_d = self.stages.stage_call(
            "pipeline.inc_compact_cols", compact_cols_stage,
            self._ssm_d, self._keep_cols(pos_live),
        )
        self._set_columns(kept_events)

    # ------------------------------------------------------------- prune

    def _maybe_prune(self) -> None:
        w_used = self._n_done - self._lo
        if w_used == 0:
            return
        nr = ~self._recv_w[:w_used]
        d = int(np.argmax(nr)) if nr.any() else w_used
        if self._fork_np.shape[0]:
            d = min(d, int(self._fork_np[:, 1:].min()))
        if d < self._prune_min:
            return
        self._on_prune(d, w_used)
        ce = self._col_events[: self._n_cols]
        live = (
            (ce >= d)
            & (self._rnd_w[np.clip(ce, 0, self._w_pad - 1)] >= self._r_base)
        )
        pos_live = np.where(live)[0]
        kept_events = self._col_events[pos_live] - d
        self._prune_slabs(d, w_used, self._keep_cols(pos_live))
        # host mirrors
        w2 = w_used - d
        pw = self._parents_w[d:w_used]
        self._parents_w[:w2] = np.where(pw >= d, pw - d, -1)
        self._parents_w[w2:] = -1

        def roll1(a, fill):
            a[:w2] = a[d:w_used]
            a[w2:] = fill

        roll1(self._creator_w, 0)
        roll1(self._coin_w, 0)
        roll1(self._t_w, 0)
        roll1(self._rnd_w, 0)
        roll1(self._wits_w, False)
        roll1(self._recv_w, False)
        self._recompute_depth(w2)
        # member table, fork pairs and witness-table entries shift by d
        self._rebuild_member_table(w2)
        if self._fork_np.shape[0]:
            self._fork_np = np.stack(
                [self._fork_np[:, 0], self._fork_np[:, 1] - d,
                 self._fork_np[:, 2] - d], axis=1,
            )
        tv = self._tab_np >= 0
        self._tab_np = np.where(tv, self._tab_np - d, -1)
        self._set_columns(kept_events)
        self._lo += d
        self._rows_hi = w2

    # ------------------------------------------------------------ rebase

    def _prune_slabs(self, d: int, w_used: int, keep) -> None:
        """Shift the carried slabs by ``d`` pruned rows and columns and
        gather the surviving witness columns ``keep``."""
        if self._fork_np.shape[0]:
            self._anc_d, self._sees_d, self._ssm_d = self.stages.stage_call(
                "pipeline.inc_prune", prune_stage,
                self._anc_d, self._sees_d, self._ssm_d, d, w_used, keep,
            )
        else:
            self._anc_d, self._ssm_d = self.stages.stage_call(
                "pipeline.inc_prune", prune_noforks_stage,
                self._anc_d, self._ssm_d, d, w_used, keep,
            )
            self._sees_d = self._anc_d

    def _rebase_block_fn(self):
        """The strongly-sees block a batch rebase runs over the whole DAG's
        slab."""
        return self._ssm_block_fn

    def _rebase(self) -> List[int]:
        """Full-recompute fallback: run the batch columns pipeline over the
        whole packed DAG, commit its outputs, and slice its device slabs into
        fresh carried-window state."""
        packed = self.packer.pack()
        n = packed.n
        prev_ordered = len(self._order)
        dev = self.device
        # witness-slot capacity must match the window table (monotone)
        extras = (
            len(set(packed.fork_pairs[:, 2].tolist()))
            if len(packed.fork_pairs)
            else 0
        )
        self._s_cap = max(self._s_cap, self._m + extras + 1)
        arrays, statics, ts_unique = prepare_inputs(
            packed, self.config, block=self._block, s_max=self._s_cap,
        )
        chain = statics["chain"]
        r_rounds = min(statics["r_max"], _bucket(chain + 1, 32))
        out, aux = _columns_pass(
            packed, self.config, arrays["parents"], arrays["creator"],
            arrays["t_rank"], arrays["coin"], arrays["stake"],
            arrays["member_table"],
            n=n, tot=self._tot, block=self._block, r_rounds=r_rounds,
            s_max=self._s_cap, chain=chain, device=dev, stages=self.stages,
            ssm_block_fn=self._rebase_block_fn(), block_stage=self._block_stage,
        )
        # adopt any self-healed capacities (the carried window table must
        # match the batch table's slot shape)
        self._s_cap = max(self._s_cap, aux["s_max"])
        heals = int(aux["overflow_retries"])
        self.overflow_heals += heals
        if heals:
            self._trigger(
                "overflow_heal", {"retries": heals, "s_cap": self._s_cap},
                prev_ordered,
            )
        result = finalize_order(packed, out, ts_unique)

        # ---- commit everything the batch pass decided
        self._grow_global(n)
        self._round_g[:n] = out["round"][:n]
        self._wits_g[:n] = out["is_witness"][:n]
        self._rr_g[:n] = result.round_received
        self._cts_g[:n] = result.consensus_ts
        self._order = list(result.order)
        self._max_round = int(out["max_round"])
        self._n_done = n
        self._g_done = packed.fork_pairs.shape[0]
        tabf = out["wit_table"]
        r_tight = tabf.shape[0]
        fam = out["famous"].reshape(r_tight, self._s_cap)
        dec = out["fame_decided_at"].reshape(r_tight, self._s_cap)
        cntf = out["wit_count"]
        cr = 0
        while cr < r_tight:
            valid = tabf[cr] >= 0
            if cntf[cr] <= 0 or self._max_round < cr + 2:
                break
            if (fam[cr][valid] < 0).any():
                break
            cr += 1
        self._consensus_round = cr
        self._famous_committed = {}
        fv = 0
        for r in range(cr):
            for s in range(self._s_cap):
                e = int(tabf[r, s])
                if e < 0:
                    continue
                self._famous_committed[e] = bool(fam[r, s] == 1)
                fv = max(fv, int(dec[r, s]))
        self._frozen_vote_hi = fv

        # ---- choose the pruned boundary and lift the window
        received = result.round_received >= 0
        nr = ~received
        lo = int(np.argmax(nr)) if nr.any() else n
        if packed.fork_pairs.shape[0]:
            lo = min(lo, int(packed.fork_pairs[:, 1:].min()))
        self._lo = lo
        self._r_base = cr
        self._on_rebase(packed, out, aux)
        w_used = n - lo
        self._w_pad = max(
            self._w_pad,
            _bucket(w_used + 2 * self._chunk, self._window_bucket),
        )
        r_need = self._max_round - cr + 16
        if r_need > self._r_cap:
            self._r_cap = _bucket(r_need, 16)
        w_pad = self._w_pad
        self._alloc_mirrors(w_pad)
        pg = packed.parents[lo:n].astype(np.int32)
        self._parents_w[:w_used] = np.where(pg >= lo, pg - lo, -1)
        self._creator_w[:w_used] = packed.creator[lo:n]
        self._coin_w[:w_used] = packed.coin[lo:n]
        self._t_w[:w_used] = packed.t[lo:n]
        self._rnd_w[:w_used] = out["round"][lo:n]
        self._wits_w[:w_used] = out["is_witness"][lo:n]
        self._recv_w[:w_used] = received[lo:]
        self._recompute_depth(w_used)
        self._rebuild_member_table(w_used)
        # fork pairs, window-remapped (all members >= lo by the cap above)
        if packed.fork_pairs.shape[0]:
            fp = packed.fork_pairs.astype(np.int32)
            self._fork_np = np.stack(
                [fp[:, 0], fp[:, 1] - lo, fp[:, 2] - lo], axis=1
            )
        else:
            self._fork_np = np.zeros((0, 3), np.int32)
        # witness table rows [cr, cr + r_cap), entries window-remapped
        self._tab_np = np.full((self._r_cap, self._s_cap), -1, np.int32)
        self._cnt_np = np.zeros((self._r_cap,), np.int32)
        self._famous_np = np.full((self._r_cap, self._s_cap), -1, np.int8)
        self._dec_np = np.full((self._r_cap, self._s_cap), -1, np.int32)
        hi = min(r_tight, cr + self._r_cap)
        rows = hi - cr
        if rows > 0:
            tw = tabf[cr:hi].astype(np.int32)
            self._tab_np[:rows] = np.where(tw >= 0, tw - lo, -1)
            self._cnt_np[:rows] = cntf[cr:hi]
            self._famous_np[:rows] = fam[cr:hi]
            self._dec_np[:rows] = dec[cr:hi]
        # column store: keep the retained-round witness columns
        bat_pos = aux["col_pos"]
        kept = [
            (e, int(bat_pos[e]))
            for e in range(lo, n)
            if bat_pos[e] >= 0 and int(out["round"][e]) >= cr
            and bool(out["is_witness"][e])
        ]
        n_cols = len(kept)
        self._wcol_cap = max(self._wcol_cap, _bucket(n_cols + 128, 256))
        self._col_events = np.full((self._wcol_cap,), -1, np.int32)
        ssm_w = torch.zeros((w_pad, self._wcol_cap), dtype=torch.bool, device=dev)
        if kept:
            pos = torch.as_tensor([p_ for _e, p_ in kept], device=dev)
            ssm_w[:w_used, :n_cols] = aux["ssm_c"][lo:n][:, pos]
            for j, (e, _pos) in enumerate(kept):
                self._col_events[j] = e - lo
                self._colpos_w[e - lo] = j
        self._n_cols = n_cols
        # visibility slabs, window-sliced on the device (sees aliases anc
        # while fork-free)
        anc_w = torch.zeros((w_pad, w_pad), dtype=torch.bool, device=dev)
        anc_w[:w_used, :w_used] = aux["anc"][lo:n, lo:n]
        self._anc_d = self._put(anc_w)
        if packed.fork_pairs.shape[0]:
            sees_w = torch.zeros((w_pad, w_pad), dtype=torch.bool, device=dev)
            sees_w[:w_used, :w_used] = aux["sees"][lo:n, lo:n]
            self._sees_d = self._put(sees_w)
        else:
            self._sees_d = self._anc_d
        self._ssm_d = self._put(ssm_w)
        self._rows_hi = w_used
        self._initialized = True
        return self._order[prev_ordered:]
