"""The batch consensus pipeline (PyTorch): column-restricted and full-matrix.

Counterpart of ``tpu_swirld/tpu/pipeline.py``'s single-host paths, with the
same function names and bit-identical ``round`` / ``is_witness`` /
``famous`` / ``round_received`` / ``consensus_ts`` / order outputs on the
same packed DAG.  :func:`run_consensus` picks the path as the reference
does:

- **columns** (the default): ``_run_consensus_columns`` ->
  ``_columns_pass``.  Visibility, then strongly-sees blocks for witness
  columns only, as the chunked rounds scan discovers them (``add_columns``
  in :func:`_columns_pass`), through
  :func:`~tpu_swirld_torch.gpu.kernels.ssm_block`; then fame and order.
- **full** (``ssm_mode="full"``, or ``use_pallas_ssm=True``, whose
  reference runs the Pallas ``ssm_matrix_pallas``): ``_run_consensus_full``
  runs stage A, :func:`rounds_body` (visibility, the full N x N
  strongly-sees matrix through :func:`~tpu_swirld_torch.gpu.kernels.
  ssm_matrix`, :func:`rounds_scan`), inside the overflow self-heal loop,
  then stage B, :func:`fame_order_body`, over a tight round window.
  :func:`consensus_body` is the two fused, the counterpart of
  ``consensus_arrays``.

Both share host prep (:func:`prepare_inputs`), the blockwise ancestry
closure (:func:`ancestry`) and with forks the forkseen hop and fork-aware
sees (:func:`visibility_stage`), every boolean hop through
:func:`~tpu_swirld_torch.gpu.kernels.bmm_or`, :func:`fame_scan`,
:func:`order_scan` and host :func:`finalize_order`.

JAX's scans become Python loops over tensor ops on the device, except the
rounds scan, fame voting and the order scan, which the reference jits as
one device program a call and the port runs as one
:func:`~tpu_swirld_torch.gpu.kernels.rounds_scan` /
:func:`~tpu_swirld_torch.gpu.kernels.fame_scan` /
:func:`~tpu_swirld_torch.gpu.kernels.order_scan` launch a stage call.  The
buffers JAX donated (the ancestry slab, the column store, the rounds carry)
are updated in place.  Every gather index is clipped exactly where the
reference clips it.  All supermajorities are exact integer tests
``3*amount > 2*total``; timestamps are dense-ranked on the host so the
device stays int32-pure.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_swirld_torch import crypto, obs
from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.device import StageClock, resolve_device, to_host
from tpu_swirld_torch.gpu import kernels
from tpu_swirld_torch.packing import PackedDAG

# Witness-table overflow bitmask (kernels.OVF_ROUND / OVF_SLOT): the host
# heals the flagged capacity and retries.
OVF_ROUND = kernels.OVF_ROUND
OVF_SLOT = kernels.OVF_SLOT


def _maybe_span(o, name: str, **args):
    """A tracer span under the ambient Obs ``o``, or a no-op when it is
    None.  Stage-granular only, never per event."""
    if o is None:
        return contextlib.nullcontext()
    return o.tracer.span(name, **args)


def _record_shapes(o, *, n: int, n_pad: int, statics: Dict) -> None:
    """Pad-waste and static-shape gauges for one pipeline invocation
    (``pipeline_r_max`` is set once the chain-trimmed bound is known)."""
    g = o.registry
    g.gauge("pipeline_events").set(n)
    g.gauge("pipeline_pad_events").set(n_pad - n)
    g.gauge("pipeline_pad_waste_frac").set(
        round((n_pad - n) / max(n_pad, 1), 6)
    )
    g.gauge("pipeline_s_max").set(statics["s_max"])
    g.gauge("pipeline_block").set(statics["block"])


def _bucket(v: int, m: int) -> int:
    """Round up to a multiple of m."""
    return ((max(v, 1) + m - 1) // m) * m


class ShapeContractError(ValueError):
    """A device-kernel shape precondition was violated by the caller (the
    reference's class of the same name).  Raised explicitly, never by
    ``assert``, and counted in :data:`shape_guard_trips`."""


#: lifetime count of ShapeContractError raises in this process
shape_guard_trips = 0


def _shape_guard(ok: bool, message: str) -> None:
    if not ok:
        global shape_guard_trips
        shape_guard_trips += 1
        raise ShapeContractError(message)


def _to_device(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


# --------------------------------------------------------------- phase 1


def ancestry(parents: torch.Tensor, *, block: int) -> torch.Tensor:
    """Reflexive-transitive closure of the parent relation: bool[N, N] with
    ``anc[i, j]`` = "j is an ancestor of i".  ``parents`` int32[N, 2] (-1 for
    genesis) in topological order, N a multiple of ``block``.  Per block:
    log2(B) in-block squarings, then one (B, B) @ (B, N) hop propagating the
    external parents' rows; the slab is written in place."""
    n = parents.shape[0]
    _shape_guard(
        n % block == 0,
        f"ancestry: N={n} must be padded to a multiple of block={block}",
    )
    closure = BlockClosure(block, parents.device)
    anc = torch.zeros((n, n), dtype=torch.bool, device=parents.device)
    for s in range(0, n, block):
        anc[s : s + block] = closure.rows(parents[s : s + block], s, n,
                                          lambda idx: anc[idx])
    return anc


class BlockClosure:
    """The per-block step of :func:`ancestry`: the ancestry rows of the
    ``block`` events from row ``s``, given the rows of their external
    parents (every parent below ``s``)."""

    def __init__(self, block: int, device):
        self.block = block
        self.n_sq = max(1, math.ceil(math.log2(block)))
        self.eye = torch.eye(block, dtype=torch.bool, device=device)
        self.jj = torch.arange(block, dtype=torch.int64, device=device)

    def rows(self, pb, s: int, n: int, read) -> torch.Tensor:
        """bool ``(block, n)``: the rows of events ``[s, s + block)``, whose
        parents are ``pb`` (int32 ``(block, 2)``); ``read(idx)`` gives the
        ancestry rows ``idx`` (parent indices clipped to ``[0, n)``; only the rows
        of parents below ``s`` are used)."""
        jj = self.jj
        local = pb - s                                           # in-block offset
        lc = (local[:, 0:1] == jj[None, :]) | (local[:, 1:2] == jj[None, :]) | self.eye
        for _ in range(self.n_sq):
            lc = lc | kernels.bmm_or(lc, lc)
        pc = pb.clamp(0, n - 1)
        ext = (pb >= 0) & (pb < s)                               # external iff < s
        g = (read(pc[:, 0]) & ext[:, 0:1]) | (read(pc[:, 1]) & ext[:, 1:2])  # B,N
        rows = kernels.bmm_or(lc, g)                             # B,N
        rows[:, s : s + self.block] |= lc
        return rows


# --------------------------------------------------------------- phase 2


def forkseen_matrix(anc: torch.Tensor, fork_pairs: torch.Tensor,
                    n_members: int) -> torch.Tensor:
    """bool[N, M]: does x have a fork pair by member m among its ancestors?
    ``fork_pairs`` int32[G, 3] rows (member, idx_a, idx_b).  ``anc`` may be
    some rows of the slab, every column (a group rank's row shard)."""
    rows, n = anc.shape
    if fork_pairs.shape[0] == 0:
        return torch.zeros((rows, n_members), dtype=torch.bool, device=anc.device)
    mcol = fork_pairs[:, 0]
    a = fork_pairs[:, 1].clamp(0, n - 1)
    b = fork_pairs[:, 2].clamp(0, n - 1)
    hit = anc[:, a] & anc[:, b] & (mcol >= 0)[None, :]           # N,G
    members = torch.arange(n_members, dtype=torch.int64, device=anc.device)
    onehot = mcol[:, None] == members[None, :]
    return kernels.bmm_or(hit, onehot.contiguous())


def sees_matrix(anc: torch.Tensor, forkseen: torch.Tensor,
                creator: torch.Tensor) -> torch.Tensor:
    """Fork-aware visibility: sees(x, y) = anc(x, y) & ~forkseen(x, c(y))."""
    return anc & ~forkseen[:, creator]


def visibility_stage(parents, creator, fork_pairs, *, n_members, block):
    anc = ancestry(parents, block=block)
    fseen = forkseen_matrix(anc, fork_pairs, n_members)
    return anc, sees_matrix(anc, fseen, creator)


def _visibility(stages, parents, creator, fork_pairs, *, n_members, block):
    """``(anc, sees)`` as the ``pipeline.visibility_stage`` stage.  With no
    fork pair packed, forkseen is all-false and ``sees`` is ``anc`` itself
    (an alias, not a copy)."""
    if fork_pairs.shape[0]:
        return stages.stage_call(
            "pipeline.visibility_stage", visibility_stage,
            parents, creator, fork_pairs, n_members=n_members, block=block,
        )
    anc = stages.stage_call(
        "pipeline.visibility_stage", ancestry, parents, block=block,
    )
    return anc, anc


# --------------------------------------------------------------- phase 3


def ssm_matrix(sees, member_table, stake, tot_stake):
    """Strongly-sees matrix (the exists-z rule): bool[N, N], through the
    ``ssm_matrix`` kernel (its plain version for CPU tensors).  The default
    ``ssm_fn`` of :func:`rounds_body`."""
    return kernels.ssm_matrix(sees, member_table, stake, tot_stake=tot_stake)


# --------------------------------------------------------------- phase 4


def _suffix_rows(row_hi: int, row_lo: int, cap: int):
    """The suffix-row cut of an ssm block: the smallest power of two >= 256
    covering ``[row_lo, row_hi)``, clamped to ``cap``.  Returns
    ``(row0, rows)`` with ``row0 <= row_lo``."""
    need = max(row_hi - row_lo, 1)
    rows = 256
    while rows < need:
        rows *= 2
    rows = min(rows, cap)
    return max(0, row_hi - rows), rows


def rounds_scan(parents, ssm, creator, stake, tot_stake, n_valid, *, r_max,
                s_max, has_forks):
    """Round assignment + witness registration over the full strongly-sees
    matrix, every event in topological order.  Returns ``(round int32[N],
    is_witness bool[N], wit_table int32[r_max, s_max], wit_count
    int32[r_max], overflow int32[1])``, ``overflow`` an OVF_ROUND |
    OVF_SLOT bitmask.  Slot order within a round is registration order.
    Pulls ``parents`` and ``n_valid`` to the host, then runs
    :func:`rounds_scan_stage`."""
    return rounds_scan_stage(
        to_host(parents), ssm, creator, stake, tot_stake, int(n_valid),
        r_max=r_max, s_max=s_max, has_forks=has_forks,
    )


def rounds_scan_stage(parents_np, ssm, creator, stake, tot_stake, n_valid, *,
                      r_max, s_max, has_forks):
    """:func:`rounds_scan` with its parents already on the host (int32[N,
    2]) and ``n_valid`` an int, as :func:`rounds_chunk_stage` takes them:
    the full path's rounds stage.  The whole scan is one
    :func:`~tpu_swirld_torch.gpu.kernels.rounds_scan` call (one launch on
    the card, which copies the parents over without waiting for it)."""
    n = ssm.shape[0]
    dev = ssm.device
    carry = (
        torch.zeros((n,), dtype=torch.int32, device=dev),
        torch.zeros((n,), dtype=torch.bool, device=dev),
        torch.full((r_max, s_max), -1, dtype=torch.int32, device=dev),
        torch.zeros((r_max,), dtype=torch.int32, device=dev),
        torch.zeros((1,), dtype=torch.int32, device=dev),
    )
    kernels.rounds_scan(
        parents_np, ssm, None, creator, stake, *carry, start=0,
        n_valid=n_valid, r_base=0, tot_stake=tot_stake, has_forks=has_forks,
    )
    return carry


def rounds_chunk_stage(parents_np, ssm_c, col_pos, creator, stake, n_valid,
                       rnd, wits, tab, cnt, overflow, start, r_base=0, *,
                       tot_stake, r_max, s_max, has_forks, chunk, check=None):
    """One chunk of the rounds scan: events [start, start+chunk) resume from
    the carried (rnd, wits, tab, cnt, overflow) state, as one
    :func:`~tpu_swirld_torch.gpu.kernels.rounds_scan` call over the chunk's
    rows of ``ssm_c`` (one launch on the card).  ``r_base`` maps global
    rounds to witness-table rows (0 on the batch path).  The carry is
    copied first and the copy updated in place, so the caller can re-run
    the chunk from the same state.  ``check`` (``kernels.new_check``), if
    given, gets the call's witness-column check: the one buffer the
    drivers read back."""
    _shape_guard(
        tuple(tab.shape) == (r_max, s_max) and ssm_c.shape[0] == rnd.shape[0],
        f"rounds_chunk_stage: table {tuple(tab.shape)} is not ({r_max}, {s_max}) "
        f"or the store's {ssm_c.shape[0]} rows are not the carry's {rnd.shape[0]}",
    )
    carry = tuple(x.clone() for x in (rnd, wits, tab, cnt, overflow))
    kernels.rounds_scan(
        parents_np, ssm_c[start : start + chunk], col_pos, creator, stake,
        *carry, start=start, n_valid=n_valid, r_base=r_base,
        tot_stake=tot_stake, has_forks=has_forks, check=check,
    )
    return carry


def scan_check(check, out, col_pos: np.ndarray, parents: np.ndarray,
               start: int, length: int):
    """``(overflow, missing, affected)`` of a rounds chunk or span call over
    events ``[start, start + length)``, from its check buffer (one pull):
    the overflow word, the table's witnesses without a column, ascending,
    and whether a later event of the call queried one.  When more
    witnesses lack a column than the buffer lists, :func:`table_check`
    reads the table and the rounds (``out``, the call's carry) instead."""
    chk = to_host(check)
    count = int(chk[1])
    if count < 0:
        return (int(chk[0]),
                *table_check(out[0], out[2], col_pos, parents, start, length))
    head = kernels.CHECK_HEAD
    return int(chk[0]), chk[head : head + count].astype(np.int64), bool(chk[2])


def table_check(rnd, tab, col_pos: np.ndarray, parents: np.ndarray,
                start: int, length: int):
    """``(missing, affected)`` of a rounds call read from its table and
    rounds themselves, for a call whose check list overflowed
    (:func:`scan_check`).  ``table_check.calls`` counts them."""
    table_check.calls += 1
    tab_h = to_host(tab)
    registered = np.unique(tab_h[tab_h >= 0])
    missing = registered[col_pos[registered] < 0]
    if missing.size == 0:
        return missing, False
    rnd_np = to_host(rnd)
    # was a missing witness's round queried later in this span?
    ce = np.arange(start, start + length, dtype=np.int64)
    p = parents[ce]
    r0 = np.where(
        p[:, 0] < 0,
        -1,
        np.maximum(rnd_np[np.maximum(p[:, 0], 0)], rnd_np[np.maximum(p[:, 1], 0)]),
    )
    affected = any(w < start or np.any((ce > w) & (r0 == rnd_np[w])) for w in missing)
    return missing, affected


table_check.calls = 0


# --------------------------------------------------------------- phase 5


def fame_scan(wit_table, sees, ssm, creator, coin, stake, tot_stake,
              coin_period, *, has_forks, col_pos=None):
    """Virtual fame voting.  Returns ``(famous, decided_at)``: famous
    int8[r_max*s_max] over witness slots (1 famous, 0 not, -1 undecided) and
    the round whose tally first decided each slot (-1 undecided).  With
    ``col_pos``, ``ssm`` is the column-restricted store and ``col_pos`` maps
    each witness to its column; without, ``ssm`` is the full matrix.

    One :func:`~tpu_swirld_torch.gpu.kernels.fame_scan` call: on the card
    one kernel launch and no host pull, as the reference's jitted scan is
    one device program.  A group rank's row views (``parallel.RowGather``)
    gather only the cells the kernel reads, once a call."""
    return kernels.fame_scan(
        wit_table.contiguous(), sees, ssm, creator, coin, stake, tot_stake,
        coin_period, has_forks=has_forks, col_pos=col_pos,
    )


# --------------------------------------------------------------- phase 6


def order_scan(anc, wit_table, wit_count, famous, creator, self_parent,
               t_rank, max_round, n_valid: int, *, chain: int,
               received0: Optional[torch.Tensor] = None):
    """Round-received + consensus timestamp ranks over the maximal
    fame-complete prefix of rounds.  Returns (round_received int32[N] (-1 =
    not received), ts_rank int32[N], received bool[N]).

    ``received0`` carries already-received flags from earlier incremental
    passes (those events are skipped; round indices are then relative to
    the carried window's ``r_base``); ``max_round`` is in the witness
    table's round frame.

    One :func:`~tpu_swirld_torch.gpu.kernels.order_scan` call: on the card
    one kernel launch and no host pull, as the reference's jitted scan is
    one device program.  On a group rank's row view (``parallel.RowGather``)
    the call covers the rank's own events, over their columns of every row
    (``own_columns``: one all-to-all), and the ranks' outputs are then
    joined (``join_columns``: one sum of ``8 W`` bytes); no rank gathers
    the window."""
    args = (wit_table, wit_count, famous, creator, self_parent.contiguous(),
            t_rank.contiguous(), max_round, n_valid)
    if isinstance(anc, torch.Tensor):
        return kernels.order_scan(anc, *args, chain=chain, received0=received0)
    slab, cols = anc.own_columns()
    rr, ts, _received = kernels.order_scan(slab, *args, chain=chain,
                                           received0=received0, cols=cols)
    rr, ts = anc.join_columns(torch.stack([rr, ts]))
    # an event is received where it was, or where it is received now
    received = rr >= 0 if received0 is None else received0 | (rr >= 0)
    return rr, ts, received


def fame_order_cols_stage(anc, sees, ssm_c, col_pos, wit_table, wit_count,
                          creator, coin, stake, self_parent, t_rank,
                          max_round, n_valid, *, tot_stake, coin_period,
                          r_max, s_max, chain, has_forks):
    tab = wit_table[:r_max]
    cnt = wit_count[:r_max]
    famous, decided_at = fame_scan(
        tab, sees, ssm_c, creator, coin, stake, tot_stake, coin_period,
        has_forks=has_forks, col_pos=col_pos,
    )
    rr, cts_rank, _received = order_scan(
        anc, tab, cnt, famous, creator, self_parent, t_rank, max_round,
        n_valid, chain=chain,
    )
    return {
        "famous": famous, "fame_decided_at": decided_at,
        "round_received": rr, "consensus_ts_rank": cts_rank,
    }


# ------------------------------------------------------ full-matrix stages


# the flat (round, slot) grids of fame_order_cols_stage's outputs
_SLOT_GRIDS = ("famous", "fame_decided_at")


def _pad_slots(flat: torch.Tensor, r_max: int, s_used: int,
               s_max: int) -> torch.Tensor:
    """A flat (r_max * s_used) slot grid, computed on the used slots only,
    padded back to (r_max * s_max) with -1, what an empty slot holds.

    Slots fill in order, so every slot at or past the fullest round's count
    is empty in every round; fame and order ignore empty slots, so running
    them on the used slots is exact.  It keeps the (slots x members x slots)
    fame tally small where forks make the slot capacity large (BASELINE
    config 4: 2019 slots)."""
    grid = torch.full((r_max, s_max), -1, dtype=flat.dtype, device=flat.device)
    grid[:, :s_used] = flat.reshape(r_max, s_used)
    return grid.reshape(-1)


def rounds_body(parents, creator, stake, fork_pairs, member_table, n_valid, *,
                tot_stake, block, r_max, s_max, has_forks, ssm_fn=None,
                stages=None):
    """Stage A: ancestry -> sees -> strongly-sees -> rounds/witness scan.

    ``n_valid`` is the number of real (unpadded) events.  ``ssm_fn``
    overrides the strongly-sees stage (signature of :func:`ssm_matrix`; the
    mesh path passes a sharded version).  Each phase runs as one stage of
    ``stages`` (a :class:`StageClock`; a fresh one when None)."""
    stages = stages or StageClock(parents.device)
    ssm_fn = ssm_fn or ssm_matrix
    anc, sees = _visibility(
        stages, parents, creator, fork_pairs, n_members=stake.shape[0],
        block=block,
    )
    ssm = stages.stage_call(
        "pipeline.ssm_matrix_stage", ssm_fn, sees, member_table, stake,
        tot_stake,
    )
    rnd, wits, tab, cnt, overflow = stages.stage_call(
        "pipeline.rounds_scan_stage", rounds_scan_stage, to_host(parents),
        ssm, creator, stake, tot_stake, int(n_valid), r_max=r_max,
        s_max=s_max, has_forks=has_forks,
    )
    ev_valid = (
        torch.arange(rnd.shape[0], dtype=torch.int64, device=rnd.device)
        < int(n_valid)
    )
    return {
        "anc": anc, "sees": sees, "ssm": ssm, "round": rnd,
        "is_witness": wits, "wit_table": tab, "wit_count": cnt,
        "overflow": overflow, "max_round": torch.where(ev_valid, rnd, 0).max(),
    }


def fame_order_body(anc, sees, ssm, wit_table, wit_count, creator, coin,
                    stake, self_parent, t_rank, max_round, n_valid, *,
                    tot_stake, coin_period, r_max, s_max, chain, has_forks):
    """Stage B: fame fixed point + order extraction over rounds [0, r_max),
    on the witness slots ``wit_table`` holds, its outputs padded back to
    ``s_max`` slots (:func:`_pad_slots`).  Callers pass the table cut to its
    used slots (:func:`_used_slots`, pulled before the stage), so the body
    waits for no host value."""
    cnt = wit_count[:r_max]
    s_used = wit_table.shape[1]
    out = fame_order_cols_stage(
        anc, sees, ssm, None, wit_table[:r_max].contiguous(), cnt,
        creator, coin, stake, self_parent, t_rank, max_round, n_valid,
        tot_stake=tot_stake, coin_period=coin_period, r_max=r_max,
        s_max=s_used, chain=chain, has_forks=has_forks,
    )
    for key in _SLOT_GRIDS:
        out[key] = _pad_slots(out[key], r_max, s_used, s_max)
    return out


def _used_slots(wit_table, wit_count, r_max):
    """``wit_table`` cut to the witness slots used in rounds [0, r_max) (at
    least one): one host pull of the counts, made between stage calls."""
    s_used = max(int(to_host(wit_count[:r_max]).max(initial=0)), 1)
    return wit_table[:, :s_used]


def consensus_body(parents, creator, t_rank, coin, stake, fork_pairs,
                   member_table, n_valid, *, tot_stake, coin_period, block,
                   r_max, s_max, chain, has_forks, ssm_fn=None, stages=None):
    """End-to-end device consensus: packed arrays -> all consensus outputs.
    :func:`rounds_body` + :func:`fame_order_body` over one round window, the
    counterpart of the reference's fused ``consensus_arrays``; the mesh
    path runs it with a member-sharded ``ssm_fn``
    (:func:`~tpu_swirld_torch.parallel.consensus_fn_for_mesh`), the
    single-device full path runs the two stages apart so the second can
    take a tight ``r_max``.  Each phase runs as one stage of ``stages`` (a
    :class:`StageClock`; a fresh one when None)."""
    stages = stages or StageClock(parents.device)
    a = rounds_body(
        parents, creator, stake, fork_pairs, member_table, n_valid,
        tot_stake=tot_stake, block=block, r_max=r_max, s_max=s_max,
        has_forks=has_forks, ssm_fn=ssm_fn, stages=stages,
    )
    b = stages.stage_call(
        "pipeline.fame_order_stage", fame_order_body,
        a["anc"], a["sees"], a["ssm"],
        _used_slots(a["wit_table"], a["wit_count"], r_max), a["wit_count"],
        creator, coin, stake, parents[:, 0], t_rank, a["max_round"], n_valid,
        tot_stake=tot_stake, coin_period=coin_period, r_max=r_max,
        s_max=s_max, chain=chain, has_forks=has_forks,
    )
    keys = ("round", "is_witness", "wit_table", "wit_count", "overflow",
            "max_round")
    return {**{k: a[k] for k in keys}, **b}


# ------------------------------------------------------- host orchestration


@dataclasses.dataclass
class ConsensusResult:
    """Host-side view of the device outputs (indices into the PackedDAG)."""

    n: int
    round: np.ndarray            # int32[n]
    is_witness: np.ndarray       # bool[n]
    famous: Dict[int, Optional[bool]]   # witness idx -> fame (None undecided)
    round_received: np.ndarray   # int32[n] (-1 not received)
    consensus_ts: np.ndarray     # int64[n]
    order: List[int]             # final total order (packed indices)
    max_round: int
    timings: Dict[str, object] = dataclasses.field(default_factory=dict)


def _pad_packed(packed: PackedDAG, block: int):
    n = packed.n
    n_pad = ((n + block - 1) // block) * block
    pad = n_pad - n

    def padi(a, fill):
        if pad == 0:
            return a
        shape = (pad,) + a.shape[1:]
        return np.concatenate([a, np.full(shape, fill, a.dtype)], axis=0)

    parents = padi(packed.parents, -1)
    creator = padi(packed.creator, 0)
    seq = padi(packed.seq, 0)
    t = padi(packed.t, 0)
    coin = padi(packed.coin, 0)
    return n_pad, parents, creator, seq, t, coin


def prepare_inputs(
    packed: PackedDAG,
    config: Optional[SwirldConfig] = None,
    *,
    block: int = 128,
    r_max: Optional[int] = None,
    s_max: Optional[int] = None,
):
    """Host prep: block padding, dense timestamp ranks, and the static
    shape parameters.  Returns ``(arrays, statics, ts_unique)``."""
    config = config or SwirldConfig(n_members=packed.n_members)
    n = packed.n
    _n_pad, parents, creator, _seq, t, coin = _pad_packed(packed, block)
    extras = (
        len(set(packed.fork_pairs[:, 2].tolist()))
        if len(packed.fork_pairs)
        else 0
    )
    if s_max is None:
        s_max = packed.n_members + extras + 1
    if r_max is None:
        r_max = int(config.max_rounds)
    chain = int(packed.seq.max()) + 1 if n else 1
    # dense-rank timestamps so the device stays int32-pure
    ts_unique, t_rank = np.unique(t, return_inverse=True)
    t_rank = t_rank.astype(np.int32).reshape(t.shape)
    arrays = {
        "parents": parents,
        "creator": creator,
        "t_rank": t_rank,
        "coin": coin,
        "stake": packed.stake,
        "fork_pairs": packed.fork_pairs,
        "member_table": packed.member_table,
        "n_valid": np.int32(n),
    }
    statics = {
        "tot_stake": kernels.check_stake_envelope(packed.stake.sum()),
        "coin_period": config.coin_period,
        "block": block,
        "r_max": r_max,
        "s_max": s_max,
        "chain": chain,
        "has_forks": bool(len(packed.fork_pairs)),
    }
    return arrays, statics, ts_unique


def _healed_capacities(ovf: int, *, r_eff: int, r_cap: int, s_eff: int,
                       s_cap: int) -> Tuple[int, int]:
    """Translate a rounds-scan overflow bitmask into grown capacities:
    OVF_ROUND unclamps the round window straight to ``r_cap``, OVF_SLOT
    doubles the per-round slot capacity.  Raises only when the flagged
    capacity is already at its hard bound."""
    r_new, s_new = r_eff, s_eff
    if ovf & OVF_ROUND:
        if r_eff >= r_cap:
            raise RuntimeError(
                f"consensus rounds exceed the round-window capacity "
                f"{r_cap} (the larger of config.max_rounds and any "
                f"explicit r_max); raise SwirldConfig.max_rounds beyond "
                f"{r_cap}"
            )
        r_new = r_cap
    if ovf & OVF_SLOT:
        if s_eff >= s_cap:
            raise RuntimeError(
                f"witness slots per round exceed the padded event count "
                f"({s_cap}) — impossible for a valid DAG; this indicates "
                "packing corruption"
            )
        s_new = min(max(2 * s_eff, 1), s_cap)
    if (r_new, s_new) == (r_eff, s_eff):
        raise RuntimeError(f"unhealable overflow mask {ovf}")
    o = obs.current()
    if o is not None:
        o.registry.counter("pipeline_overflow_retries_total").inc()
        o.registry.gauge("pipeline_r_max").set(r_new)
        o.registry.gauge("pipeline_s_max").set(s_new)
    return r_new, s_new


def run_consensus(
    packed: PackedDAG,
    config: Optional[SwirldConfig] = None,
    *,
    block: int = 128,
    r_max: Optional[int] = None,
    s_max: Optional[int] = None,
    mesh=None,
    use_pallas_ssm: bool = False,
    ssm_mode: Optional[str] = None,
    device="cuda",
) -> ConsensusResult:
    """Run the pipeline on a packed DAG and extract the final order.  The
    device computes everything except the tiebreak hash; the host applies
    the oracle's sort key (round received, consensus ts, BLAKE2b(whiten ||
    id)).

    ``ssm_mode`` picks the strongly-sees form: ``"columns"`` (witness
    columns only, the default) or ``"full"`` (the N x N matrix).
    ``use_pallas_ssm=True`` is the reference's switch to its Pallas
    full-matrix kernel: it implies ``"full"``, and on a CUDA device both
    full forms launch the hand-written ``ssm_matrix`` kernel.  ``device``
    defaults to ``"cuda"`` and raises when no GPU is present; pass
    ``device="cpu"`` for the plain PyTorch versions on the CPU.

    ``mesh`` (:func:`~tpu_swirld_torch.parallel.make_mesh`, its shards on
    ``device``) runs the full-matrix path with the strongly-sees matrix
    member-sharded over it (:func:`_run_consensus_mesh`); it does not combine
    with ``use_pallas_ssm`` or ``ssm_mode="columns"`` (as in the reference,
    ``NotImplementedError``), and a mesh that is not the port's ``Mesh`` or
    ``GroupMesh``, or whose device is not ``device``, raises ``ValueError``.
    A :class:`~tpu_swirld_torch.parallel.GroupMesh` runs the pass on every
    rank of its group, ``device`` the rank's own: each rank tallies its
    member shard and all-reduces, and every rank returns the same result.
    """
    if ssm_mode not in (None, "columns", "full"):
        raise ValueError(f"unknown ssm_mode {ssm_mode!r}")
    if mesh is not None and use_pallas_ssm:
        raise NotImplementedError(
            "use_pallas_ssm is not routed through the mesh path; run one or "
            "the other"
        )
    if ssm_mode == "columns" and (mesh is not None or use_pallas_ssm):
        raise NotImplementedError(
            "ssm_mode='columns' is not routed through the mesh / pallas "
            "paths; those run the full-matrix kernel"
        )
    if ssm_mode is None:
        ssm_mode = "full" if (mesh is not None or use_pallas_ssm) else "columns"
    dev = resolve_device(device)
    if mesh is not None:
        from tpu_swirld_torch.parallel import GroupMesh, Mesh, _canonical

        if not isinstance(mesh, (Mesh, GroupMesh)):
            raise ValueError(
                f"mesh must be a tpu_swirld_torch.parallel.Mesh or GroupMesh, "
                f"got {type(mesh).__name__}"
            )
        if mesh.device != _canonical(dev):
            raise ValueError(
                f"the pass runs on {dev}, the mesh's shards on {mesh.device}"
            )
    arrays, statics, ts_unique = prepare_inputs(
        packed, config, block=block, r_max=r_max, s_max=s_max,
    )
    o = obs.current()
    if o is not None:
        _record_shapes(
            o, n=packed.n, n_pad=arrays["parents"].shape[0], statics=statics
        )
    config = config or SwirldConfig(n_members=packed.n_members)
    r_max, s_max = statics["r_max"], statics["s_max"]
    chain = statics["chain"]
    # the longest self-chain bounds max_round for honest-shaped DAGs; the
    # clamp is backed by the self-healing retry, so an under-provisioned
    # r_max or s_max grows instead of fail-stopping
    r_rounds = min(r_max, _bucket(chain + 1, 32))
    r_cap = max(int(config.max_rounds), r_max)
    if o is not None:
        o.registry.gauge("pipeline_r_max").set(r_rounds)
    kw = {}
    if mesh is not None:
        run, kw = _run_consensus_mesh, {"mesh": mesh}
    elif ssm_mode == "columns":
        run = _run_consensus_columns
    else:
        run = _run_consensus_full
    return run(
        packed, config, arrays["parents"], arrays["creator"],
        arrays["t_rank"], arrays["coin"], arrays["stake"],
        arrays["member_table"], ts_unique, n=packed.n,
        tot=statics["tot_stake"], block=block, r_rounds=r_rounds,
        r_cap=r_cap, s_max=s_max, chain=chain, device=dev, **kw,
    )


def _run_consensus_columns(
    packed, config, parents, creator, t_rank, coin, stake, member_table,
    ts_unique, *, n, tot, block, r_rounds, r_cap, s_max, chain, device,
):
    """:func:`_columns_pass` plus host order extraction and timings."""
    stages = StageClock(device)
    t_dev0 = time.perf_counter()
    out, aux = _columns_pass(
        packed, config, parents, creator, t_rank, coin, stake, member_table,
        n=n, tot=tot, block=block, r_rounds=r_rounds, r_cap=r_cap,
        s_max=s_max, chain=chain, device=device, stages=stages,
    )
    result = _finalize_timed(
        packed, out, ts_unique, stages, t_dev0, ssm_columns=aux["n_cols"],
        ssm_col_iterations=aux["n_scans"],
        overflow_retries=aux["overflow_retries"],
    )
    o = obs.current()
    if o is not None:
        o.registry.counter("pipeline_ssm_columns_total").inc(aux["n_cols"])
        o.registry.counter("pipeline_chunk_scans_total").inc(aux["n_scans"])
    return result


def _finalize_timed(packed, out, ts_unique, stages, t_dev0, **counters):
    """:func:`finalize_order` plus the run's timings: seconds on the device
    and in dispatch since ``t_dev0``, seconds in finalize, the pass's
    counters, and the per-stage seconds and calls of ``stages``."""
    t_device = time.perf_counter() - t_dev0
    t_fin0 = time.perf_counter()
    with _maybe_span(obs.current(), "pipeline.finalize"):
        result = finalize_order(packed, out, ts_unique)
    result.timings = {
        "device_and_dispatch": t_device,
        "finalize_host": time.perf_counter() - t_fin0,
        **counters,
        "stage_seconds": dict(stages.seconds),
        "stage_calls": dict(stages.calls),
    }
    return result


def _run_consensus_full(
    packed, config, parents, creator, t_rank, coin, stake, member_table,
    ts_unique, *, n, tot, block, r_rounds, r_cap, s_max, chain, device,
):
    """Full-matrix execution: stage A (:func:`rounds_body`) inside the
    overflow self-heal loop (a retry re-runs stage A whole with the flagged
    capacity grown), then stage B (:func:`fame_order_body`) over the tight
    round window, then host order extraction and timings."""
    stages = StageClock(device)
    t_dev0 = time.perf_counter()
    has_forks = bool(len(packed.fork_pairs))
    parents_d = _to_device(parents, device)
    creator_d = _to_device(creator, device)
    stake_d = _to_device(stake, device, torch.int32)
    mt_d = _to_device(member_table, device, torch.int32)
    fork_pairs_d = _to_device(packed.fork_pairs, device)
    retries = 0
    while True:
        stage_a = rounds_body(
            parents_d, creator_d, stake_d, fork_pairs_d, mt_d, n,
            tot_stake=tot, block=block, r_max=r_rounds, s_max=s_max,
            has_forks=has_forks, stages=stages,
        )
        ovf = int(stage_a["overflow"])
        if not ovf:
            break
        r_rounds, s_max = _healed_capacities(
            ovf, r_eff=r_rounds, r_cap=r_cap, s_eff=s_max,
            s_cap=parents.shape[0],
        )
        retries += 1
    max_round = int(stage_a["max_round"])
    r_tight = min(r_rounds, _bucket(max_round + 3, 8))
    stage_b = stages.stage_call(
        "pipeline.fame_order_stage", fame_order_body,
        stage_a["anc"], stage_a["sees"], stage_a["ssm"],
        _used_slots(stage_a["wit_table"], stage_a["wit_count"], r_tight),
        stage_a["wit_count"], creator_d, _to_device(coin, device), stake_d,
        _to_device(parents[:, 0], device), _to_device(t_rank, device),
        max_round, n, tot_stake=tot, coin_period=config.coin_period,
        r_max=r_tight, s_max=s_max, chain=chain, has_forks=has_forks,
    )
    out = {
        "round": to_host(stage_a["round"]),
        "is_witness": to_host(stage_a["is_witness"]),
        "wit_table": to_host(stage_a["wit_table"][:r_tight]),
        "wit_count": to_host(stage_a["wit_count"][:r_tight]),
        "max_round": max_round,
        **{k: to_host(v) for k, v in stage_b.items()},
    }
    return _finalize_timed(
        packed, out, ts_unique, stages, t_dev0, overflow_retries=retries
    )


def _run_consensus_mesh(
    packed, config, parents, creator, t_rank, coin, stake, member_table,
    ts_unique, *, n, tot, block, r_rounds, r_cap, s_max, chain, device, mesh,
):
    """The mesh path (the reference's ``run_consensus`` mesh branch): the
    member axis padded to a mesh multiple, then the fused
    :func:`consensus_body` with the member-sharded strongly-sees matrix
    (:func:`~tpu_swirld_torch.parallel.consensus_fn_for_mesh`), one
    ``pipeline.mesh_consensus`` stage an attempt, inside the overflow
    self-heal loop over one round window (``r_rounds``: the longest
    self-chain's bucket, grown to ``r_cap`` on overflow)."""
    from tpu_swirld_torch.parallel import consensus_fn_for_mesh, pad_members

    member_table, stake = pad_members(member_table, stake, mesh.size)
    kernel = consensus_fn_for_mesh(mesh)
    o = obs.current()
    if o is not None:
        o.registry.gauge("mesh_devices").set(int(mesh.size))
    stages = StageClock(device)
    t_dev0 = time.perf_counter()
    has_forks = bool(len(packed.fork_pairs))
    args = (
        _to_device(parents, device), _to_device(creator, device),
        _to_device(t_rank, device), _to_device(coin, device),
        _to_device(stake, device, torch.int32),
        _to_device(packed.fork_pairs, device),
        _to_device(member_table, device, torch.int32), n,
    )
    retries = 0
    while True:
        out = stages.stage_call(
            "pipeline.mesh_consensus", kernel, *args, tot_stake=tot,
            coin_period=config.coin_period, block=block, r_max=r_rounds,
            s_max=s_max, chain=chain, has_forks=has_forks, stages=stages,
        )
        ovf = int(out["overflow"])
        if not ovf:
            break
        r_rounds, s_max = _healed_capacities(
            ovf, r_eff=r_rounds, r_cap=r_cap, s_eff=s_max,
            s_cap=parents.shape[0],
        )
        retries += 1
    out = {k: to_host(v) for k, v in out.items()}
    return _finalize_timed(
        packed, out, ts_unique, stages, t_dev0, overflow_retries=retries
    )


def _columns_pass(
    packed, config, parents, creator, t_rank, coin, stake, member_table,
    *, n, tot, block, r_rounds, s_max, chain, device, stages,
    r_cap=None, ssm_block_fn=None, block_stage="pipeline.ssm_block_stage",
    shards=None,
):
    """Column-restricted strongly-sees execution core.

    Strongly-see columns are pure DAG functions (round-independent), and
    the rounds scan only queries *witness* columns, so columns are computed
    only as witnesses are discovered: the scan runs in chunks carrying its
    state; when a chunk registers a witness that has no column yet, the
    column is computed and just that chunk re-runs (exact, because columns
    do not depend on rounds).  Columns are computed only over their suffix
    rows (a row below a witness can never strongly-see it, and the
    untouched store region is already zero, the exact value).

    ``ssm_block_fn`` is the strongly-sees block seam (signature of
    :func:`~tpu_swirld_torch.gpu.kernels.ssm_block`, the default and the
    counterpart of the reference's ``ssm_block_stage``), run as the stage
    ``block_stage`` (the mesh driver's is ``pipeline.ssm_block_mesh``, as
    in the reference).  ``r_cap`` bounds
    the round-window heal (default: the larger of ``config.max_rounds`` and
    ``r_rounds``).  Returns ``(out, aux)`` in the reference's shapes:
    ``out`` the numpy outputs for :func:`finalize_order` (witness table and
    fame grids ``r_tight`` x ``s_max``), ``aux`` the device slabs ``anc``,
    ``sees`` (``anc`` itself when fork-free) and ``ssm_c``, the host
    ``col_pos`` and the pass's capacities and counters, which
    :class:`~tpu_swirld_torch.gpu.incremental.IncrementalConsensus` lifts
    into its window on a rebase.

    ``shards`` (``parallel.BatchShards``) runs the pass on a group rank
    over its own rows: the events are padded to its multiple (parentless
    rows), visibility is its sharded stage, ``anc``, ``sees`` and ``ssm_c``
    are the rank's row shards (``aux`` holds them), ``ssm_block_fn`` takes
    the rank's ``sees`` shard, and every stage reads and writes rows by
    global index through its row views (``parallel.RowGather``).
    """
    if shards is not None:
        parents, creator, t_rank, coin = shards.pad(block, parents, creator, t_rank, coin)
        alloc, view = shards.zeros, shards.view
    else:
        alloc, view = _whole_zeros(device), _whole
    n_pad = parents.shape[0]
    has_forks = bool(len(packed.fork_pairs))
    if ssm_block_fn is None:
        ssm_block_fn = kernels.ssm_block
    if r_cap is None:
        r_cap = max(int(config.max_rounds), r_rounds)

    parents_d = _to_device(parents, device)
    creator_d = _to_device(creator, device)
    stake_d = _to_device(stake, device, torch.int32)
    mt_d = _to_device(member_table, device, torch.int32)
    fork_pairs_d = _to_device(packed.fork_pairs, device)
    if shards is None:
        anc, sees = _visibility(
            stages, parents_d, creator_d, fork_pairs_d,
            n_members=int(stake.shape[0]), block=block,
        )
    else:
        anc, sees = shards.visibility(
            stages, parents, parents_d, creator_d, fork_pairs_d,
            n_members=int(stake.shape[0]), block=block,
        )

    # incremental column store: a preallocated (N, W_CAP) buffer written in
    # place (JAX donated it), positions tracked host-side.  Every column is
    # exact regardless of round state.
    col_pos = np.full((n_pad,), -1, dtype=np.int32)
    col_pos_d = _to_device(col_pos, device)
    n_cols = 0
    w_cap = min(_bucket(max(s_max * 8, 256), 256), n_pad)
    ssm_c = alloc(n_pad, w_cap)
    n_scans = 0

    def add_columns(events):
        nonlocal n_cols, ssm_c, w_cap, col_pos_d
        batch = _bucket(len(events), 64)
        if n_cols + batch > w_cap:
            w_cap = _bucket(max(n_cols + batch, min(w_cap * 2, n_pad)), 256)
            grown = alloc(n_pad, w_cap)
            grown[:, : ssm_c.shape[1]] = ssm_c
            ssm_c = grown
        cols_arr = np.full((batch,), -1, dtype=np.int32)
        cols_arr[: len(events)] = events
        row0, rows_eff = _suffix_rows(n_pad, min(events), n_pad)
        part = stages.stage_call(
            block_stage, ssm_block_fn,
            sees, mt_d, stake_d, _to_device(cols_arr, device), row0,
            rows=rows_eff, tot_stake=tot,
        )
        for j, e in enumerate(events):
            col_pos[e] = n_cols + j
        col_pos_d = _to_device(col_pos, device)
        view(ssm_c)[row0 : row0 + rows_eff, n_cols : n_cols + batch] = part
        n_cols += len(events)

    add_columns([int(i) for i in np.where(packed.parents[:, 0] < 0)[0]])

    # chunked scan: resume from the carried state; when a chunk registers
    # a witness whose column is missing AND a later event in the chunk
    # queried that witness's round, compute the column and re-run just
    # that chunk; otherwise the chunk's outputs are already exact and the
    # new columns only serve future chunks.  The kernel's check buffer
    # says both (one pull a call).  Witness-table overflow self-heals: the
    # scan restarts with the flagged capacity grown (the column store
    # survives retries).
    chunk_size = min(128, n_pad)
    while n_pad % chunk_size:
        chunk_size //= 2
    overflow_retries = 0
    check_d = kernels.new_check(device)
    while True:
        state = (
            torch.zeros((n_pad,), dtype=torch.int32, device=device),
            torch.zeros((n_pad,), dtype=torch.bool, device=device),
            torch.full((r_rounds, s_max), -1, dtype=torch.int32, device=device),
            torch.zeros((r_rounds,), dtype=torch.int32, device=device),
            torch.zeros((1,), dtype=torch.int32, device=device),
        )
        ovf = 0
        for start in range(0, n_pad, chunk_size):
            # each failed attempt adds at least one column, and a chunk can
            # register at most chunk_size witnesses, so this bound is safe
            for _attempt in range(chunk_size + 1):
                out = stages.stage_call(
                    "pipeline.rounds_chunk_stage", rounds_chunk_stage,
                    parents, view(ssm_c, (start, start + chunk_size)), col_pos_d,
                    creator_d, stake_d, n, *state, start, tot_stake=tot, r_max=r_rounds, s_max=s_max,
                    has_forks=has_forks, chunk=chunk_size, check=check_d,
                )
                n_scans += 1
                ovf, missing, affected = scan_check(
                    check_d, out, col_pos, parents, start, chunk_size)
                if missing.size == 0:
                    state = out
                    break
                add_columns([int(e) for e in missing])
                if not affected:
                    state = out
                    break
            else:
                raise RuntimeError("witness-column chunk did not converge")
            if ovf:
                break               # overflow: stop scanning, grow, retry
        if not ovf:
            break
        r_rounds, s_max = _healed_capacities(
            ovf, r_eff=r_rounds, r_cap=r_cap, s_eff=s_max, s_cap=n_pad,
        )
        overflow_retries += 1
    rnd_a, wits_a, tab_a, cnt_a, _overflow_a = state
    rnd_h = to_host(rnd_a)
    max_round = int(rnd_h[:n].max(initial=0))
    r_tight = min(r_rounds, _bucket(max_round + 3, 8))
    # fame and order on the used slots only (_pad_slots)
    s_used = max(int(to_host(cnt_a[:r_tight]).max(initial=0)), 1)
    tab_b = tab_a[:r_tight, :s_used].contiguous()
    stage_b = stages.stage_call(
        "pipeline.fame_order_cols_stage", fame_order_cols_stage,
        view(anc), view(sees), view(ssm_c), col_pos_d, tab_b, cnt_a, creator_d,
        _to_device(coin, device), stake_d, _to_device(parents[:, 0], device),
        _to_device(t_rank, device), max_round, n,
        tot_stake=tot, coin_period=config.coin_period, r_max=r_tight,
        s_max=s_used, chain=chain, has_forks=has_forks,
    )
    for key in _SLOT_GRIDS:
        stage_b[key] = _pad_slots(stage_b[key], r_tight, s_used, s_max)
    out = {
        "round": rnd_h,
        "is_witness": to_host(wits_a),
        "wit_table": to_host(tab_a[:r_tight]),
        "wit_count": to_host(cnt_a[:r_tight]),
        "max_round": max_round,
        **{k: to_host(v) for k, v in stage_b.items()},
    }
    aux = {
        "anc": anc, "sees": sees, "ssm_c": ssm_c,
        "col_pos": col_pos, "n_cols": n_cols, "w_cap": w_cap,
        "n_scans": n_scans, "r_rounds": r_rounds, "s_max": s_max,
        "overflow_retries": overflow_retries,
    }
    return out, aux


def _whole(slab, prefetch=None):
    """A one-process slab as the columns pass reads it by row: itself."""
    return slab


def _whole_zeros(device):
    """The columns pass's slab allocation in one process: every row."""
    return lambda rows, cols: torch.zeros((rows, cols), dtype=torch.bool, device=device)


def _unique_famous(fam_events, creators) -> List[int]:
    """Unique famous witnesses of one round: famous witnesses whose creator
    has exactly one famous witness there."""
    by_creator: Dict[int, List[int]] = {}
    for e in fam_events:
        by_creator.setdefault(int(creators[e]), []).append(e)
    return sorted(e for v in by_creator.values() if len(v) == 1 for e in v)


def _whiten_sigs(sigs) -> bytes:
    """XOR-fold the UFW signatures into the round's tiebreak whitener."""
    w = bytes(crypto.SIG_BYTES)
    for s in sigs:
        w = crypto.xor_bytes(w, s)
    return w


def finalize_order(
    packed: PackedDAG, out: Dict[str, np.ndarray], ts_unique: np.ndarray
) -> ConsensusResult:
    """Host post-pass: fame dict, whitened tiebreak, final total order."""
    n = packed.n
    tab = out["wit_table"]
    famous_grid = out["famous"].reshape(tab.shape)
    famous: Dict[int, Optional[bool]] = {}
    r_max, s_max = tab.shape
    ufw_by_round: Dict[int, List[int]] = {}
    for r in range(r_max):
        fam_slots = []
        for s in range(s_max):
            e = int(tab[r, s])
            if e < 0:
                continue
            f = int(famous_grid[r, s])
            famous[e] = None if f < 0 else bool(f)
            if f == 1:
                fam_slots.append(e)
        if fam_slots:
            ufw_by_round[r] = _unique_famous(fam_slots, packed.creator)

    rr = out["round_received"][:n]
    # map timestamp ranks back to the int64 values
    rank = np.clip(out["consensus_ts_rank"][:n], 0, len(ts_unique) - 1)
    cts = np.where(rr >= 0, ts_unique[rank], 0).astype(np.int64)
    whiten_cache: Dict[int, bytes] = {}

    def whiten(r: int) -> bytes:
        w = whiten_cache.get(r)
        if w is None:
            w = _whiten_sigs(packed.sigs[e] for e in ufw_by_round.get(r, []))
            whiten_cache[r] = w
        return w

    received = [
        (int(rr[i]), int(cts[i]), crypto.hash_bytes(whiten(int(rr[i])) + packed.ids[i]), i)
        for i in range(n)
        if rr[i] >= 0
    ]
    received.sort(key=lambda item: (item[0], item[1], item[2]))
    return ConsensusResult(
        n=n,
        round=out["round"][:n],
        is_witness=out["is_witness"][:n],
        famous=famous,
        round_received=rr,
        consensus_ts=cts,
        order=[i for (_r, _t, _h, i) in received],
        max_round=int(out["max_round"]),
    )
