"""The batch consensus pipeline, column-restricted form (PyTorch).

Counterpart of ``tpu_swirld/tpu/pipeline.py``'s default single-host path:
``run_consensus`` -> ``_run_consensus_columns`` -> ``_columns_pass``, with
the same function names and bit-identical ``round`` / ``is_witness`` /
``famous`` / ``round_received`` / ``consensus_ts`` / order outputs on the
same packed DAG.  The pass:

1. host prep (:func:`prepare_inputs`);
2. blockwise ancestry closure (:func:`ancestry`), and with forks the
   forkseen hop and fork-aware sees (:func:`visibility_stage`); every
   boolean hop runs through :func:`~tpu_swirld_torch.gpu.kernels.bmm_or`;
3. strongly-sees blocks for witness columns only, as the chunked rounds
   scan discovers them (``add_columns`` in :func:`_columns_pass`), through
   :func:`~tpu_swirld_torch.gpu.kernels.ssm_block`;
4. :func:`fame_scan` and :func:`order_scan`;
5. host :func:`finalize_order`.

JAX's scans become Python loops over tensor ops on the device, and the
buffers JAX donated (the ancestry slab, the column store, the rounds carry)
are updated in place.  Every gather index is clipped exactly where the
reference clips it.  All supermajorities are exact integer tests
``3*amount > 2*total``; timestamps are dense-ranked on the host so the
device stays int32-pure.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_swirld_torch import crypto
from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.device import StageClock, resolve_device, to_host
from tpu_swirld_torch.gpu import kernels
from tpu_swirld_torch.packing import PackedDAG

INT32_MAX = int(np.iinfo(np.int32).max)

# Witness-table overflow bitmask: a witness landed outside the retained
# round window (OVF_ROUND) / a round's witness slots were exhausted
# (OVF_SLOT).  The host heals the flagged capacity and retries.
OVF_ROUND = 1
OVF_SLOT = 2


def _bucket(v: int, m: int) -> int:
    """Round up to a multiple of m."""
    return ((max(v, 1) + m - 1) // m) * m


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain boolean matmul (0/1 float32 products, exact; TF32 is off) for
    the fame tally, which the reference also leaves to a plain matmul."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)) > 0.5


# --------------------------------------------------------------- phase 1


def ancestry(parents: torch.Tensor, *, block: int) -> torch.Tensor:
    """Reflexive-transitive closure of the parent relation: bool[N, N] with
    ``anc[i, j]`` = "j is an ancestor of i".  ``parents`` int32[N, 2] (-1 for
    genesis) in topological order, N a multiple of ``block``.  Per block:
    log2(B) in-block squarings, then one (B, B) @ (B, N) hop propagating the
    external parents' rows; the slab is written in place."""
    n = parents.shape[0]
    if n % block:
        raise ValueError(f"ancestry: N={n} must be padded to a multiple of block={block}")
    dev = parents.device
    n_sq = max(1, math.ceil(math.log2(block)))
    eye = torch.eye(block, dtype=torch.bool, device=dev)
    jj = torch.arange(block, device=dev)
    anc = torch.zeros((n, n), dtype=torch.bool, device=dev)
    for s in range(0, n, block):
        pb = parents[s : s + block]                              # B,2
        local = pb - s                                           # in-block offset
        lc = (local[:, 0:1] == jj[None, :]) | (local[:, 1:2] == jj[None, :]) | eye
        for _ in range(n_sq):
            lc = lc | kernels.bmm_or(lc, lc)
        pc = pb.clamp(0, n - 1)
        ext = (pb >= 0) & (pb < s)                               # external iff < s
        g = (anc[pc[:, 0]] & ext[:, 0:1]) | (anc[pc[:, 1]] & ext[:, 1:2])   # B,N
        rows = kernels.bmm_or(lc, g)                             # B,N
        rows[:, s : s + block] |= lc
        anc[s : s + block] = rows
    return anc


# --------------------------------------------------------------- phase 2


def forkseen_matrix(anc: torch.Tensor, fork_pairs: torch.Tensor,
                    n_members: int) -> torch.Tensor:
    """bool[N, M]: does x have a fork pair by member m among its ancestors?
    ``fork_pairs`` int32[G, 3] rows (member, idx_a, idx_b)."""
    n = anc.shape[0]
    if fork_pairs.shape[0] == 0:
        return torch.zeros((n, n_members), dtype=torch.bool, device=anc.device)
    mcol = fork_pairs[:, 0]
    a = fork_pairs[:, 1].clamp(0, n - 1)
    b = fork_pairs[:, 2].clamp(0, n - 1)
    hit = anc[:, a] & anc[:, b] & (mcol >= 0)[None, :]           # N,G
    onehot = mcol[:, None] == torch.arange(n_members, device=anc.device)[None, :]
    return kernels.bmm_or(hit, onehot.contiguous())


def sees_matrix(anc: torch.Tensor, forkseen: torch.Tensor,
                creator: torch.Tensor) -> torch.Tensor:
    """Fork-aware visibility: sees(x, y) = anc(x, y) & ~forkseen(x, c(y))."""
    return anc & ~forkseen[:, creator]


def visibility_stage(parents, creator, fork_pairs, *, n_members, block):
    anc = ancestry(parents, block=block)
    fseen = forkseen_matrix(anc, fork_pairs, n_members)
    return anc, sees_matrix(anc, fseen, creator)


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


def _make_rounds_step(parents_np, ssm_c, col_pos, creator, stake, tot_stake,
                      n_valid, *, r_max, s_max, has_forks):
    """The per-event body of the rounds scan over the carry
    ``(rnd[N], wits[N], wit_table, wit_count, overflow[1])``, updated in
    place.  Parents are host data, so genesis and padding are decided on
    the host; everything that depends on earlier rounds stays on the device.

    The batch path's window starts at round 0 and rounds are never
    negative, so the reference's ``r - r_base < 0`` tests are always false
    and are dropped here.
    """
    n = ssm_c.shape[0]
    n_cols = ssm_c.shape[1]
    dev = ssm_c.device
    marange = torch.arange(stake.shape[0], device=dev)
    round0 = torch.zeros((1,), dtype=torch.int32, device=dev)
    witness = torch.ones((1,), dtype=torch.bool, device=dev)

    def step(carry, i: int):
        rnd, wits, tab, cnt, overflow = carry
        if i >= n_valid:
            return          # padding: round 0, not a witness (the carry's init)
        p1, p2 = int(parents_np[i, 0]), max(int(parents_np[i, 1]), 0)
        if p1 < 0:          # genesis: round 0 and a witness
            r, is_wit = round0, witness
        else:
            r0 = torch.maximum(rnd[p1 : p1 + 1], rnd[p2 : p2 + 1])
            widx = tab.index_select(0, r0.clamp(max=r_max - 1))[0]   # S
            wvalid = (widx >= 0) & (r0 < r_max)
            widxc = widx.clamp(0, n - 1)
            wpos = col_pos.index_select(0, widxc)                    # S (-1 = absent)
            ss = (
                ssm_c[i].index_select(0, wpos.clamp(0, n_cols - 1))
                & (wpos >= 0)
                & wvalid
            )
            wcre = creator.index_select(0, widxc)
            if has_forks:
                contrib = ((wcre[:, None] == marange[None, :]) & ss[:, None]).any(0)
                amount = (stake * contrib).sum()
            else:
                # no forks packed -> at most one witness per (creator, round)
                amount = (stake.index_select(0, wcre) * ss).sum()
            r = r0 + (3 * amount > 2 * tot_stake)
            is_wit = r > rnd[p1 : p1 + 1]
        rc = r.clamp(max=r_max - 1)
        slot = cnt.index_select(0, rc)
        overflow |= torch.where(is_wit & (r >= r_max), OVF_ROUND, 0).to(torch.int32)
        overflow |= torch.where(is_wit & (slot >= s_max), OVF_SLOT, 0).to(torch.int32)
        do = is_wit & (slot < s_max) & (r < r_max)
        flat = rc * s_max + slot.clamp(0, s_max - 1)
        tab_flat = tab.view(-1)
        tab_flat.index_put_((flat,), torch.where(do, i, tab_flat.index_select(0, flat)))
        cnt.index_add_(0, rc, do.to(torch.int32))
        rnd[i : i + 1] = r
        wits[i : i + 1] = is_wit

    return step


def rounds_chunk_stage(parents_np, ssm_c, col_pos, creator, stake, n_valid,
                       rnd, wits, tab, cnt, overflow, start, *, tot_stake,
                       r_max, s_max, has_forks, chunk):
    """One chunk of the rounds scan: events [start, start+chunk) resume from
    the carried (rnd, wits, tab, cnt, overflow) state.  The carry is copied
    first and the copy updated in place, so the caller can re-run the chunk
    from the same state."""
    carry = tuple(x.clone() for x in (rnd, wits, tab, cnt, overflow))
    step = _make_rounds_step(
        parents_np, ssm_c, col_pos, creator, stake, tot_stake, n_valid,
        r_max=r_max, s_max=s_max, has_forks=has_forks,
    )
    for i in range(start, start + chunk):
        step(carry, i)
    return carry


# --------------------------------------------------------------- phase 5


def fame_scan(wit_table, sees, ssm, creator, coin, stake, tot_stake,
              coin_period, *, has_forks, col_pos):
    """Virtual fame voting over the column-restricted strongly-sees store.
    Returns ``(famous, decided_at)``: famous int8[r_max*s_max] over witness
    slots (1 famous, 0 not, -1 undecided) and the round whose tally first
    decided each slot (-1 undecided)."""
    r_max, s_max = wit_table.shape
    n = sees.shape[0]
    n_members = stake.shape[0]
    w_max = r_max * s_max
    dev = sees.device
    # The fast tally multiplies stake values into a float32 matmul, exact
    # only while every sum stays below 2^24 (TF32 is off).  Forks need the
    # per-creator OR.  Otherwise take the int32 per-creator path.
    exact_tally = has_forks or tot_stake >= (1 << 24)

    x_event = wit_table.reshape(-1)                     # W
    x_valid = x_event >= 0
    xe = x_event.clamp(0, n - 1)
    x_round = torch.arange(w_max, dtype=torch.int32, device=dev) // s_max
    marange = torch.arange(n_members, device=dev)
    w_range = torch.arange(w_max, device=dev)

    v_prev = torch.zeros((s_max, w_max), dtype=torch.bool, device=dev)
    famous = torch.full((w_max,), -1, dtype=torch.int8, device=dev)
    dec_at = torch.full((w_max,), -1, dtype=torch.int32, device=dev)
    for ry in range(1, r_max):
        y_idx = wit_table[ry]
        y_valid = y_idx >= 0
        ye = y_idx.clamp(0, n - 1)
        d = ry - x_round                                # W
        sees_yx = sees[ye][:, xe] & y_valid[:, None] & x_valid[None, :]
        p_idx = wit_table[ry - 1]
        p_valid = p_idx >= 0
        pe = p_idx.clamp(0, n - 1)
        ppos = col_pos[pe]
        ssy = ssm[ye][:, ppos.clamp(0, ssm.shape[1] - 1)] & (ppos >= 0)[None, :]
        ssy = ssy & y_valid[:, None] & p_valid[None, :]
        pcre = creator[pe]                              # S
        pstake = torch.where(p_valid, stake[pcre], 0)
        not_v = ~v_prev & p_valid[:, None]
        if exact_tally:
            # per-creator OR before stake-weighting (forked creators may
            # have several witnesses in round ry-1)
            onehot = (pcre[:, None] == marange[None, :]) & p_valid[:, None]
            w1 = (ssy[:, None, :] & onehot.T[None, :, :]).reshape(
                s_max * n_members, s_max
            )                                           # (S*M),S
            yes_c = _bmm(w1, v_prev).reshape(s_max, n_members, w_max)
            no_c = _bmm(w1, not_v).reshape(s_max, n_members, w_max)
            st = stake[None, :, None]
            yes = (yes_c.to(torch.int32) * st).sum(1, dtype=torch.int32)
            no = (no_c.to(torch.int32) * st).sum(1, dtype=torch.int32)
        else:
            sw = (ssy.to(torch.int32) * pstake[None, :]).to(torch.float32)
            yes = torch.matmul(sw, v_prev.to(torch.float32)).to(torch.int32)
            no = torch.matmul(sw, not_v.to(torch.float32)).to(torch.int32)
        v_tally = yes >= no                             # S,W
        super_ = 3 * torch.maximum(yes, no) > 2 * tot_stake
        is_coin = (d % coin_period) == 0                # W
        coin_y = (coin[ye] > 0)[:, None]                # S,1
        vote = torch.where(
            (d == 1)[None, :],
            sees_yx,
            torch.where(
                is_coin[None, :], torch.where(super_, v_tally, coin_y), v_tally
            ),
        )
        vote = vote & y_valid[:, None] & x_valid[None, :] & (d >= 1)[None, :]
        eligible = (
            super_ & y_valid[:, None] & (x_valid & (d >= 2) & ~is_coin)[None, :]
        )
        any_dec = eligible.any(0)                       # W
        # argmax over ints returns the first maximal index ("first True")
        first_y = torch.argmax(eligible.to(torch.int32), dim=0)
        val = v_tally[first_y, w_range]
        newly = (famous < 0) & any_dec
        famous = torch.where(newly, val.to(torch.int8), famous)
        dec_at = torch.where(newly, ry, dec_at)
        v_prev = vote
    return famous, dec_at


# --------------------------------------------------------------- phase 6


def order_scan(anc, wit_table, wit_count, famous, creator, self_parent,
               t_rank, max_round: int, n_valid: int, *, chain: int):
    """Round-received + consensus timestamp ranks over the maximal
    fame-complete prefix of rounds.  Returns (round_received int32[N] (-1 =
    not received), ts_rank int32[N], received bool[N]).

    Which rounds can receive anything (inside the prefix, with a unique
    famous witness) is computed for all rounds at once and pulled to the
    host: the reference's ``lax.cond`` becomes a host ``if``, and the
    skipped rounds contribute nothing, exactly as there."""
    r_max, s_max = wit_table.shape
    n = anc.shape[0]
    dev = anc.device
    famous_grid = famous.reshape(r_max, s_max)
    wvalid = wit_table >= 0
    decided = (famous_grid >= 0) | ~wvalid
    complete = (
        decided.all(dim=1)
        & (max_round >= torch.arange(r_max, device=dev) + 2)
        & (wit_count > 0)
    )
    # maximal prefix of fame-complete rounds (cumulative AND)
    prefix = torch.cumprod(complete.to(torch.int32), dim=0) > 0
    we_all = wit_table.clamp(0, n - 1)
    fam = (famous_grid == 1) & wvalid                   # R,S
    wcre = creator[we_all]
    # count famous witnesses per creator via pairwise same-creator sum
    same = (wcre[:, :, None] == wcre[:, None, :]) & wvalid[:, :, None] & wvalid[:, None, :]
    cnt_same = (same & fam[:, None, :]).sum(dim=2)
    ufw = fam & (cnt_same == 1)
    go = to_host(prefix & ufw.any(dim=1))
    nv_all = to_host(ufw.sum(dim=1))

    ev_valid = torch.arange(n, device=dev) < n_valid
    received = torch.zeros((n,), dtype=torch.bool, device=dev)
    rr_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    ts_out = torch.zeros((n,), dtype=torch.int32, device=dev)
    for r in range(r_max):
        if not go[r]:
            continue
        we = we_all[r]
        u = ufw[r]
        all_see = (anc[we] | ~u[:, None]).all(dim=0)   # N
        newly = all_see & ~received & ev_valid
        # earliest-seeing timestamps via self-chain walk (w -> genesis)
        cur = we
        tsw = torch.full((s_max, n), INT32_MAX, dtype=torch.int32, device=dev)
        for _ in range(chain):
            tsw = torch.where(anc[cur], t_rank[cur][:, None], tsw)
            nxt = self_parent[cur]
            cur = torch.where(nxt >= 0, nxt, cur)
        # non-UFW rows become the sort sentinel: they sort last, and the
        # median index stays below them
        tsw = torch.where(u[:, None], tsw, INT32_MAX)
        ts_sorted = torch.sort(tsw, dim=0).values       # S,N ascending
        med_i = min(max((int(nv_all[r]) - 1) // 2, 0), s_max - 1)
        med = ts_sorted[med_i]                           # N
        received |= newly
        rr_out = torch.where(newly, r, rr_out)
        ts_out = torch.where(newly, med, ts_out)
    return rr_out, ts_out, received


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
        "tot_stake": int(packed.stake.sum()),
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
    """Run the column-restricted pipeline on a packed DAG and extract the
    final order.  The device computes everything except the tiebreak hash;
    the host applies the oracle's sort key (round received, consensus ts,
    BLAKE2b(whiten || id)).

    ``device`` defaults to ``"cuda"`` and raises when no GPU is present;
    pass ``device="cpu"`` for the plain PyTorch versions on the CPU.  The
    full-matrix mode, the Pallas full-matrix kernel and the mesh path are
    not ported yet and raise ``NotImplementedError``.
    """
    if ssm_mode not in (None, "columns", "full"):
        raise ValueError(f"unknown ssm_mode {ssm_mode!r}")
    if mesh is not None:
        raise NotImplementedError(
            "the mesh path is not ported yet (ROADMAP A8, mesh drivers)"
        )
    if ssm_mode == "full" or use_pallas_ssm:
        raise NotImplementedError(
            "the full-matrix strongly-sees mode and ssm_matrix_pallas are "
            "not ported yet (ROADMAP A2 and B3); the port runs "
            "ssm_mode='columns'"
        )
    dev = resolve_device(device)
    arrays, statics, ts_unique = prepare_inputs(
        packed, config, block=block, r_max=r_max, s_max=s_max,
    )
    config = config or SwirldConfig(n_members=packed.n_members)
    r_max, s_max = statics["r_max"], statics["s_max"]
    chain = statics["chain"]
    # the longest self-chain bounds max_round for honest-shaped DAGs; the
    # clamp is backed by the self-healing retry, so an under-provisioned
    # r_max or s_max grows instead of fail-stopping
    r_rounds = min(r_max, _bucket(chain + 1, 32))
    r_cap = max(int(config.max_rounds), r_max)
    return _run_consensus_columns(
        packed, config, arrays["parents"], arrays["creator"],
        arrays["t_rank"], arrays["coin"], arrays["stake"],
        arrays["member_table"], ts_unique, n=packed.n,
        tot=statics["tot_stake"], block=block, r_rounds=r_rounds,
        r_cap=r_cap, s_max=s_max, chain=chain, device=dev,
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
    t_device = time.perf_counter() - t_dev0
    t_fin0 = time.perf_counter()
    result = finalize_order(packed, out, ts_unique)
    result.timings = {
        "device_and_dispatch": t_device,
        "finalize_host": time.perf_counter() - t_fin0,
        "ssm_columns": aux["n_cols"],
        "ssm_col_iterations": aux["n_scans"],
        "overflow_retries": aux["overflow_retries"],
        "stage_seconds": dict(stages.seconds),
        "stage_calls": dict(stages.calls),
    }
    return result


def _columns_pass(
    packed, config, parents, creator, t_rank, coin, stake, member_table,
    *, n, tot, block, r_rounds, r_cap, s_max, chain, device, stages,
    ssm_block_fn=None,
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
    counterpart of the reference's ``ssm_block_stage``).  Returns
    ``(out, aux)``: the numpy outputs for :func:`finalize_order` and the
    pass's counters.
    """
    n_pad = parents.shape[0]
    has_forks = bool(len(packed.fork_pairs))
    if ssm_block_fn is None:
        ssm_block_fn = kernels.ssm_block

    def dev_tensor(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    parents_d = dev_tensor(parents)
    creator_d = dev_tensor(creator)
    stake_d = dev_tensor(stake, torch.int32)
    mt_d = dev_tensor(member_table, torch.int32)
    if has_forks:
        anc, sees = stages.stage_call(
            "pipeline.visibility_stage", visibility_stage,
            parents_d, creator_d, dev_tensor(packed.fork_pairs),
            n_members=int(stake.shape[0]), block=block,
        )
    else:
        anc = stages.stage_call(
            "pipeline.visibility_stage", ancestry, parents_d, block=block,
        )
        sees = anc          # alias: no fork pair packed -> sees == anc

    # incremental column store: a preallocated (N, W_CAP) buffer written in
    # place (JAX donated it), positions tracked host-side.  Every column is
    # exact regardless of round state.
    col_pos = np.full((n_pad,), -1, dtype=np.int32)
    col_pos_d = dev_tensor(col_pos)
    n_cols = 0
    w_cap = min(_bucket(max(s_max * 8, 256), 256), n_pad)
    ssm_c = torch.zeros((n_pad, w_cap), dtype=torch.bool, device=device)
    n_scans = 0

    def add_columns(events):
        nonlocal n_cols, ssm_c, w_cap, col_pos_d
        batch = _bucket(len(events), 64)
        if n_cols + batch > w_cap:
            w_cap = _bucket(max(n_cols + batch, min(w_cap * 2, n_pad)), 256)
            grown = torch.zeros((n_pad, w_cap), dtype=torch.bool, device=device)
            grown[:, : ssm_c.shape[1]] = ssm_c
            ssm_c = grown
        cols_arr = np.full((batch,), -1, dtype=np.int32)
        cols_arr[: len(events)] = events
        row0, rows_eff = _suffix_rows(n_pad, min(events), n_pad)
        part = stages.stage_call(
            "pipeline.ssm_block_stage", ssm_block_fn,
            sees, mt_d, stake_d, dev_tensor(cols_arr), row0,
            rows=rows_eff, tot_stake=tot,
        )
        for j, e in enumerate(events):
            col_pos[e] = n_cols + j
        col_pos_d = dev_tensor(col_pos)
        ssm_c[row0 : row0 + rows_eff, n_cols : n_cols + batch] = part
        n_cols += len(events)

    add_columns([int(i) for i in np.where(packed.parents[:, 0] < 0)[0]])

    # chunked scan: resume from the carried state; when a chunk registers
    # a witness whose column is missing AND a later event in the chunk
    # queried that witness's round, compute the column and re-run just
    # that chunk; otherwise the chunk's outputs are already exact and the
    # new columns only serve future chunks.  Witness-table overflow
    # self-heals: the scan restarts with the flagged capacity grown (the
    # column store survives retries).
    chunk_size = min(128, n_pad)
    while n_pad % chunk_size:
        chunk_size //= 2
    overflow_retries = 0
    while True:
        state = (
            torch.zeros((n_pad,), dtype=torch.int32, device=device),
            torch.zeros((n_pad,), dtype=torch.bool, device=device),
            torch.full((r_rounds, s_max), -1, dtype=torch.int32, device=device),
            torch.zeros((r_rounds,), dtype=torch.int32, device=device),
            torch.zeros((1,), dtype=torch.int32, device=device),
        )
        for start in range(0, n_pad, chunk_size):
            # each failed attempt adds at least one column, and a chunk can
            # register at most chunk_size witnesses, so this bound is safe
            for _attempt in range(chunk_size + 1):
                out = stages.stage_call(
                    "pipeline.rounds_chunk_stage", rounds_chunk_stage,
                    parents, ssm_c, col_pos_d, creator_d, stake_d, n, *state,
                    start, tot_stake=tot, r_max=r_rounds, s_max=s_max,
                    has_forks=has_forks, chunk=chunk_size,
                )
                n_scans += 1
                tab = to_host(out[2])
                registered = np.unique(tab[tab >= 0])
                missing = registered[col_pos[registered] < 0]
                if missing.size == 0:
                    state = out
                    break
                rnd_np = to_host(out[0])
                # was a missing witness's round queried later in this chunk?
                ce = np.arange(start, start + chunk_size, dtype=np.int64)
                p = parents[ce]
                r0 = np.where(
                    p[:, 0] < 0,
                    -1,
                    np.maximum(rnd_np[np.maximum(p[:, 0], 0)],
                               rnd_np[np.maximum(p[:, 1], 0)]),
                )
                affected = False
                for w in missing:
                    if w < start:   # registered in an earlier chunk state?
                        affected = True  # (shouldn't happen; be safe)
                        break
                    if np.any((ce > w) & (r0 == rnd_np[w])):
                        affected = True
                        break
                add_columns([int(e) for e in missing])
                if not affected:
                    state = out
                    break
            else:
                raise RuntimeError("witness-column chunk did not converge")
            if int(state[4]):
                break               # overflow: stop scanning, grow, retry
        ovf = int(state[4])
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
    # Slots fill in order, so every slot at or past the fullest round's
    # count is empty in every round; fame and order ignore empty slots, so
    # cutting them is exact.  It keeps the (slots x members x slots) fame
    # tally small where forks make the default capacity large (BASELINE
    # config 4: 2019 slots, of which a few hundred are ever used).
    s_used = max(int(to_host(cnt_a[:r_tight]).max(initial=0)), 1)
    tab_b = tab_a[:r_tight, :s_used].contiguous()
    stage_b = stages.stage_call(
        "pipeline.fame_order_cols_stage", fame_order_cols_stage,
        anc, sees, ssm_c, col_pos_d, tab_b, cnt_a, creator_d,
        dev_tensor(coin), stake_d, dev_tensor(parents[:, 0]),
        dev_tensor(t_rank), max_round, n,
        tot_stake=tot, coin_period=config.coin_period, r_max=r_tight,
        s_max=s_used, chain=chain, has_forks=has_forks,
    )
    out = {
        "round": rnd_h,
        "is_witness": to_host(wits_a),
        "wit_table": to_host(tab_b),
        "wit_count": to_host(cnt_a[:r_tight]),
        "max_round": max_round,
        **{k: to_host(v) for k, v in stage_b.items()},
    }
    aux = {
        "n_cols": n_cols, "n_scans": n_scans,
        "overflow_retries": overflow_retries,
    }
    return out, aux


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
