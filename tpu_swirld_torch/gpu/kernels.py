"""The port's hand-written CUDA kernels, their wrappers and plain versions.

- :func:`bmm_or` (``csrc/bmm_or.cu``) replaces ``tpu_swirld/tpu/
  pallas_kernels.py:bmm_or_pallas``: the boolean OR-matmul hop of the
  ancestry closure and of forkseen.
- :func:`ssm_block` (``csrc/ssm_block.cu``) replaces ``pallas_kernels.py:
  ssm_block_pallas``: the member-hop strongly-sees block with an int32 stake
  tally and a strict-2/3 epilogue.
- :func:`ssm_matrix` (``csrc/ssm_matrix.cu``) replaces ``pallas_kernels.py:
  ssm_matrix_pallas``: the same rule over the full N x N matrix (every row
  and every column an event).
- :func:`ssm_tally` (``csrc/ssm_tally.cu``) replaces the member hops of
  ``pallas_kernels.py:make_mesh_row_block_fn``: one row shard's int32 stake
  tally of the row-sharded block, not thresholded.
- :func:`rounds_scan` (``csrc/rounds_scan.cu``) replaces no Pallas kernel:
  it is the reference's jitted ``lax.scan`` over ``tpu_swirld/tpu/
  pipeline.py:_make_rounds_step`` (round assignment and witness
  registration), one launch a span of events, as XLA runs that scan as one
  device program a call.
- :func:`fame_scan` (``csrc/fame_scan.cu``) replaces no Pallas kernel: it
  is the reference's jitted ``lax.scan`` of ``tpu_swirld/tpu/pipeline.py:
  fame_scan`` (virtual fame voting), one launch a stage call, as XLA runs
  that scan as one device program.
- :func:`order_scan` (``csrc/order_scan.cu``) replaces no Pallas kernel:
  it is the reference's jitted ``lax.scan`` of ``tpu_swirld/tpu/
  pipeline.py:order_scan`` (round received and consensus timestamp ranks),
  one launch a stage call, as XLA runs that scan as one device program.

:func:`make_extension_kernels` bundles ``bmm_or`` and ``ssm_block`` for the
incremental driver, as ``pallas_kernels.py:make_extension_kernels`` does;
:func:`make_mesh_row_block_fn` puts ``ssm_tally`` into the row-sharded
strongly-sees block, where ``pallas_kernels.py:make_mesh_row_block_fn`` puts
``bmm_or_pallas``.

Each wrapper takes its plain PyTorch version (``bmm_or_reference``,
``ssm_block_reference``, ``ssm_matrix_reference``, ``ssm_tally_reference``,
``rounds_scan_reference``, ``fame_scan_reference``,
``order_scan_reference``) only for tensors on
the CPU.  For CUDA tensors it launches the kernel or raises; there is no
fallback.  ``<wrapper>.launches`` counts the kernel launches (plain-version
calls do not count), so a run can show that it went through the kernel.  The wrappers that take ``tot_stake``
raise ``ValueError`` outside the int32 stake envelope
(:func:`check_stake_envelope`), on either device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from tpu_swirld_torch.device import to_host
from tpu_swirld_torch.gpu import build

INT32_MAX = int(torch.iinfo(torch.int32).max)

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_ARGTYPES = {
    "bmm_or_launch": [_VP, _VP, _VP, _INT, _INT, _INT, _VP],
    "ssm_tally_launch": [
        _VP, _INT, _INT, _VP, _INT, _INT, _VP, _VP, _INT, _INT, _INT,
        _VP, _VP, _VP, _VP,
    ],
    "ssm_block_launch": [
        _VP, _INT, _VP, _INT, _INT, _VP, _VP, _INT, _INT, _INT, _INT, _VP,
        _VP, _VP,
    ],
    "ssm_matrix_launch": [_VP, _INT, _VP, _INT, _INT, _VP, _INT, _VP, _VP, _VP, _VP],
    "rounds_scan_launch": [
        _VP, _VP, _INT, _VP, _VP, _VP, _INT, _VP, _VP, _VP, _VP, _VP, _VP,
        _VP, _INT, _VP, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT,
        _INT, _INT, _VP,
    ],
    "fame_scan_launch": [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT, _INT,
        _INT, _INT, _INT, _VP, _VP, _INT, _INT, _INT, _VP,
    ],
    "order_scan_launch": [
        _VP, _INT, _INT, _INT, _INT, _VP, _VP, _VP, _VP, _INT, _INT, _VP, _VP,
        _VP, _VP, _INT, _INT, _INT, _INT, _VP, _VP, _VP, _INT, _VP,
    ],
}


@functools.lru_cache(maxsize=None)
def _c_function(lib_name: str, fn_name: str):
    fn = getattr(build.load(lib_name), fn_name)
    fn.argtypes = _ARGTYPES[fn_name]
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")


def _on_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version runs);
    False when every one lies on one CUDA device (the kernel runs)."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors only")
    return False


def check_stake_envelope(tot_stake) -> int:
    """``tot_stake`` as an int, once it lies inside the int32 envelope
    ``3 * tot_stake <= INT32_MAX`` of the reference's scale audit.  Every
    stake tally is at most the total, so inside it no int32 tally wraps and
    ``3 * acc > 2 * tot`` is exact in int32, as the reference computes it.
    Raises ``ValueError`` outside it."""
    tot = int(tot_stake)
    if 3 * tot > INT32_MAX:
        raise ValueError(
            f"total stake {tot} is outside the int32 stake envelope "
            f"3 * tot_stake <= {INT32_MAX} (tot_stake <= {INT32_MAX // 3})"
        )
    return tot


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def _launch(dev: torch.device, launch, *args) -> int:
    """``launch(*args, stream)`` on ``dev``'s current stream; a device
    context is entered only when ``dev`` is not the current device."""
    if dev.index == torch.cuda.current_device():
        return launch(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(dev):
        return launch(*args, torch.cuda.current_stream(dev).cuda_stream)


# ------------------------------------------------------------------ bmm_or


def bmm_or_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: 0/1 float32 matmul (TF32 off), thresholded at 0.5."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)) > 0.5


def bmm_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``out[p, r] = OR_q a[p, q] & b[q, r]`` for bool ``a[P, Q]``,
    ``b[Q, R]``, any ``P, Q, R >= 1``.  On the card: one kernel launch and
    one allocation (the output)."""
    _check(a, "a", torch.bool, 2)
    _check(b, "b", torch.bool, 2)
    p, q = a.shape
    q2, r = b.shape
    if q != q2:
        raise ValueError(f"bmm_or: contraction mismatch {tuple(a.shape)} @ {tuple(b.shape)}")
    if min(p, q, r) < 1:
        raise ValueError(f"bmm_or: empty shape {tuple(a.shape)} @ {tuple(b.shape)}")
    if _on_cpu(a, b):
        return bmm_or_reference(a, b)
    out = torch.empty((p, r), dtype=torch.bool, device=a.device)
    err = _launch(
        a.device, _c_function("bmm_or", "bmm_or_launch"),
        a.data_ptr(), b.data_ptr(), out.data_ptr(), p, q, r,
    )
    _raise_on(err, "bmm_or")
    bmm_or.launches += 1
    return out


bmm_or.launches = 0


# --------------------------------------------------------------- ssm_block


def _packed_words(n_members: int, k: int) -> int:
    """Packed words of one row or column of the strongly-sees kernels: each
    member's K slots padded to whole 256-bit k-steps of the binary MMA,
    ``M * 8 * ceil(K / 256)``."""
    return n_members * 8 * ((k + 255) // 256)


def slice_start(start: int, size: int, n: int) -> int:
    """The start of a ``size``-long slice of an ``n``-long axis as
    ``lax.dynamic_slice`` / ``dynamic_update_slice`` take it: a negative
    start counts from the end, then the start is clamped so the slice
    fits."""
    if not 1 <= size <= n:
        raise ValueError(f"a slice of {size} outside [1, {n}]")
    start = int(start)
    if start < 0:
        start += n
    return min(max(start, 0), n - size)


def ssm_block_reference(sees, member_table, stake, cols, row0, *, rows,
                        tot_stake):
    """Plain version: per member one (rows, K) @ (K, C) float32 hop (TF32
    off) thresholded at 0.5, an int32 stake tally, the strict-2/3 test."""
    n = sees.shape[0]
    n_members, k = member_table.shape
    row0 = slice_start(row0, rows, n)
    idx = member_table.reshape(-1)
    valid = idx >= 0
    idxc = idx.clamp(0, n - 1)
    colsc = cols.clamp(0, n - 1)
    col_valid = cols >= 0
    a = (sees[row0 : row0 + rows][:, idxc] & valid[None, :]).reshape(
        rows, n_members, k
    )
    b = (
        sees[idxc[:, None], colsc[None, :]] & valid[:, None] & col_valid[None, :]
    ).reshape(n_members, k, cols.shape[0])
    acc = torch.zeros((rows, cols.shape[0]), dtype=torch.int32, device=sees.device)
    for m in range(n_members):
        hit = torch.matmul(a[:, m].to(torch.float32), b[m].to(torch.float32)) > 0.5
        acc += hit.to(torch.int32) * stake[m]
    return (3 * acc.to(torch.int64) > 2 * int(tot_stake)) & col_valid[None, :]


def ssm_block(sees, member_table, stake, cols, row0, *, rows, tot_stake):
    """Strongly-sees block for rows ``[row0, row0 + rows)`` x columns
    ``cols`` (the ``ssm_block_fn`` seam of ``_columns_pass``).  ``sees`` is
    bool ``(n, n)``, ``member_table`` int32 ``(M, K)`` and ``cols`` int32
    ``(C,)`` with -1 meaning invalid, ``stake`` int32 ``(M,)`` summing to
    ``tot_stake``.  Returns bool ``(rows, C)``; on the card two launches and
    one scratch allocation besides the output."""
    _check(sees, "sees", torch.bool, 2)
    _check(member_table, "member_table", torch.int32, 2)
    _check(stake, "stake", torch.int32, 1)
    _check(cols, "cols", torch.int32, 1)
    n = sees.shape[0]
    n_members, k = member_table.shape
    c = cols.shape[0]
    if sees.shape[1] != n:
        raise ValueError(f"ssm_block: sees must be square, got {tuple(sees.shape)}")
    if stake.shape[0] != n_members:
        raise ValueError("ssm_block: stake and member_table disagree on M")
    if min(n_members, k, c) < 1:
        raise ValueError("ssm_block: empty member table or column batch")
    row0 = slice_start(row0, rows, n)
    tot_stake = check_stake_envelope(tot_stake)
    if _on_cpu(sees, member_table, stake, cols):
        return ssm_block_reference(
            sees, member_table, stake, cols, row0, rows=rows,
            tot_stake=tot_stake,
        )
    dev = sees.device
    # the one scratch buffer: the packed b words, one row a column
    b_bits = torch.empty((c, _packed_words(n_members, k)), dtype=torch.int32, device=dev)
    out = torch.empty((rows, c), dtype=torch.bool, device=dev)
    err = _launch(
        dev, _c_function("ssm_block", "ssm_block_launch"),
        sees.data_ptr(), n, member_table.data_ptr(), n_members, k,
        stake.data_ptr(), cols.data_ptr(), c, row0, rows, tot_stake,
        b_bits.data_ptr(), out.data_ptr(),
    )
    _raise_on(err, "ssm_block")
    ssm_block.launches += 1
    return out


ssm_block.launches = 0


# -------------------------------------------------------------- ssm_matrix


def ssm_matrix_reference(sees, member_table, stake, *, tot_stake):
    """Plain version, as the reference's XLA ``pipeline.ssm_matrix``: per
    member one (N, K) @ (K, N) float32 hop (TF32 off) thresholded at 0.5,
    an int32 stake tally, the strict-2/3 test."""
    n = sees.shape[0]
    acc = torch.zeros((n, n), dtype=torch.int32, device=sees.device)
    for m in range(member_table.shape[0]):
        idx = member_table[m]
        valid = idx >= 0
        idxc = idx.clamp(0, n - 1)
        a = (sees[:, idxc] & valid[None, :]).to(torch.float32)     # N,K
        b = (sees[idxc, :] & valid[:, None]).to(torch.float32)     # K,N
        acc += (torch.matmul(a, b) > 0.5).to(torch.int32) * stake[m]
    return 3 * acc.to(torch.int64) > 2 * int(tot_stake)


def ssm_matrix(sees, member_table, stake, *, tot_stake):
    """Full strongly-sees matrix (the ``ssm_fn`` seam of ``rounds_body``):
    ``out[x, y]`` is True when members holding a strict 2/3 of the stake
    each have an event z with sees(x, z) and sees(z, y).  ``sees`` is bool
    ``(n, n)``, ``member_table`` int32 ``(M, K)`` with -1 meaning empty,
    ``stake`` int32 ``(M,)`` summing to ``tot_stake``.  Returns bool ``(n,
    n)``; on the card two launches (the pack, then a binary tensor-core
    product) and one scratch allocation besides the output."""
    _check(sees, "sees", torch.bool, 2)
    _check(member_table, "member_table", torch.int32, 2)
    _check(stake, "stake", torch.int32, 1)
    n = sees.shape[0]
    n_members, k = member_table.shape
    if sees.shape[1] != n:
        raise ValueError(f"ssm_matrix: sees must be square, got {tuple(sees.shape)}")
    if stake.shape[0] != n_members:
        raise ValueError("ssm_matrix: stake and member_table disagree on M")
    if min(n, n_members, k) < 1:
        raise ValueError("ssm_matrix: empty sees or member table")
    tot_stake = check_stake_envelope(tot_stake)
    if _on_cpu(sees, member_table, stake):
        return ssm_matrix_reference(sees, member_table, stake, tot_stake=tot_stake)
    # the one scratch buffer: a_bits then b_bits, one row an event each
    dev = sees.device
    bits = torch.empty((2, n, _packed_words(n_members, k)), dtype=torch.int32, device=dev)
    out = torch.empty((n, n), dtype=torch.bool, device=dev)
    err = _launch(
        dev, _c_function("ssm_matrix", "ssm_matrix_launch"),
        sees.data_ptr(), n, member_table.data_ptr(), n_members, k,
        stake.data_ptr(), tot_stake, bits[0].data_ptr(), bits[1].data_ptr(),
        out.data_ptr(),
    )
    _raise_on(err, "ssm_matrix")
    ssm_matrix.launches += 1
    return out


ssm_matrix.launches = 0


# --------------------------------------------------------------- ssm_tally


def ssm_tally_reference(sees_shard, member_table, stake, b, row_lo, *, rows,
                        bmm=bmm_or_reference):
    """Plain version: per member one (rows, K) @ (K, C) hop through ``bmm``
    (the row-sharded block's member loop), times ``stake[m]``, summed into
    an int32 tally.  Block rows outside the shard gather zeros."""
    n_loc, n = sees_shard.shape
    n_members, k = member_table.shape
    idx = member_table.reshape(-1)
    valid = idx >= 0
    ridx = int(row_lo) + torch.arange(rows, dtype=torch.int64, device=sees_shard.device)
    rown = (ridx >= 0) & (ridx < n_loc)
    a = (
        sees_shard[ridx.clamp(0, n_loc - 1)[:, None], idx.clamp(0, n - 1)[None, :]]
        & valid[None, :] & rown[:, None]
    )
    # (M, rows, K), contiguous once a shard: the kernels take contiguous
    # operands only
    a_r3 = a.reshape(rows, n_members, k).transpose(0, 1).contiguous()
    b_r3 = b.reshape(n_members, k, b.shape[1])
    acc = torch.zeros((rows, b.shape[1]), dtype=torch.int32, device=sees_shard.device)
    for m in range(n_members):
        acc += bmm(a_r3[m], b_r3[m]).to(torch.int32) * stake[m]
    return acc


def ssm_tally(sees_shard, member_table, stake, b, row_lo, *, rows):
    """One row shard's int32 stake tally of the row-sharded strongly-sees
    block, before the sum over shards and the threshold::

        out[i, j] = sum_m stake[m] * OR_k (mt[m, k] >= 0
                    and 0 <= row_lo + i < n_loc
                    and sees_shard[row_lo + i, clip(mt[m, k], 0, n - 1)]
                    and b[m * K + k, j])

    ``sees_shard`` is bool ``(n_loc, n)`` (the shard's rows of the slab),
    ``member_table`` int32 ``(M, K)`` with -1 meaning empty, ``stake`` int32
    ``(M,)``, ``b`` bool ``(M * K, C)`` (the halo-assembled operand).
    Returns int32 ``(rows, C)``; on the card two launches whatever ``M``
    is."""
    _check(sees_shard, "sees_shard", torch.bool, 2)
    _check(member_table, "member_table", torch.int32, 2)
    _check(stake, "stake", torch.int32, 1)
    _check(b, "b", torch.bool, 2)
    n_loc, n = sees_shard.shape
    n_members, k = member_table.shape
    c = b.shape[1]
    if stake.shape[0] != n_members:
        raise ValueError("ssm_tally: stake and member_table disagree on M")
    if b.shape[0] != n_members * k:
        raise ValueError(f"ssm_tally: b has {b.shape[0]} rows, not M * K = {n_members * k}")
    if min(n_loc, n_members, k, c, rows) < 1:
        raise ValueError("ssm_tally: empty shard, member table, columns or rows")
    row_lo = int(row_lo)
    if _on_cpu(sees_shard, member_table, stake, b):
        return ssm_tally_reference(sees_shard, member_table, stake, b, row_lo, rows=rows)
    owned = max(0, min(rows, n_loc - row_lo) - max(0, -row_lo))
    nq = n_members * ((k + 31) // 32)
    dev = sees_shard.device
    # one scratch buffer: the packed a words (owned, nq), then b's (nq, C)
    bits = torch.empty((owned + c) * nq, dtype=torch.int32, device=dev)
    out = torch.empty((rows, c), dtype=torch.int32, device=dev)
    err = _launch(
        dev, _c_function("ssm_tally", "ssm_tally_launch"),
        sees_shard.data_ptr(), n_loc, n, member_table.data_ptr(), n_members,
        k, stake.data_ptr(), b.data_ptr(), c, row_lo, rows,
        bits.data_ptr(), bits.data_ptr() + 4 * owned * nq, out.data_ptr(),
    )
    _raise_on(err, "ssm_tally")
    ssm_tally.launches += 1
    return out


ssm_tally.launches = 0


# ------------------------------------------------------------- rounds_scan

# Witness-table overflow bitmask: a witness landed outside the retained
# round window (OVF_ROUND) / a round's witness slots were exhausted
# (OVF_SLOT).  The host heals the flagged capacity and retries.
OVF_ROUND = 1
OVF_SLOT = 2

# The witness-column check a rounds_scan call writes (``check=``), int32
# ``[CHECK_HEAD + cap]``: the overflow word; the number of table witnesses
# whose ``col_pos`` is -1, or -1 when more table entries lack a column
# than the list holds (the caller then reads the table itself); the
# "affected" flag; then those witnesses ascending, -1 after.
CHECK_HEAD = 3
CHECK_CAP = 256

# the H100's opt-in shared memory a block, less the kernel's static words
# (its step results)
_RS_SMEM_LIMIT = 232448 - 3072
_RS_PAR_WIN = 512           # span events whose inputs the kernel stages at once
RS_WARPS = 32               # warps of a rounds_scan block: the most events a step


class ScanPlan(NamedTuple):
    route: str              # "shared" or "global": where the table lives
    smem: int               # dynamic shared memory of the launch, bytes


@functools.lru_cache(maxsize=None)
def rounds_scan_plan(r_max: int, s_max: int, n_members: int, has_forks: bool,
                     check_cap: int = 0) -> ScanPlan:
    """How :func:`rounds_scan`'s kernel lays out its shared memory for a
    launch with a check list of ``check_cap`` entries (0: no check): the
    staged span inputs (``_RS_PAR_WIN`` x 20 bytes), the counts and row
    bounds (8 bytes a row), the stake (4 a member), with forks each warp's
    member bitmask, and the check list (12 bytes an entry) always; the
    witness table with each slot's column and stake (12 bytes a slot) when
    it fits (``"shared"``), else in device memory (``"global"``)."""
    fixed = (20 * _RS_PAR_WIN + 8 * r_max + 4 * n_members + 12 * check_cap
             + (4 * RS_WARPS * ((n_members + 31) // 32) if has_forks else 0))
    table = 12 * r_max * s_max
    if fixed + table <= _RS_SMEM_LIMIT:
        return ScanPlan("shared", fixed + table)
    if fixed <= _RS_SMEM_LIMIT:
        return ScanPlan("global", fixed)
    raise ValueError(f"rounds_scan: {r_max} rows and {n_members} members exceed a "
                     "block's shared memory")


def new_check(device, cap: int = CHECK_CAP) -> torch.Tensor:
    """A check buffer for :func:`rounds_scan`'s ``check=``."""
    return torch.empty((CHECK_HEAD + cap,), dtype=torch.int32, device=device)


def rounds_scan_reference(parents, ssm_rows, col_pos, creator, stake, rnd,
                          wits, tab, cnt, overflow, *, start, n_valid, r_base,
                          tot_stake, has_forks, check=None):
    """Plain version: the reference's per-event step
    (``tpu_swirld/tpu/pipeline.py:_make_rounds_step``), one event after
    another, the carry updated in place, then the check
    (:func:`rounds_check_reference`).  Parents are host data, so genesis
    and padding are decided on the host; everything that depends on earlier
    rounds stays in tensors."""
    parents_np = parents if isinstance(parents, np.ndarray) else parents.numpy()
    n = rnd.shape[0]
    n_cols = ssm_rows.shape[1]
    r_max, s_max = tab.shape
    dev = rnd.device
    marange = torch.arange(stake.shape[0], dtype=torch.int64, device=dev)
    round0 = torch.zeros((1,), dtype=torch.int32, device=dev)
    witness = torch.ones((1,), dtype=torch.bool, device=dev)
    for i in range(start, start + ssm_rows.shape[0]):
        if i >= n_valid:    # padding: round 0, never a witness
            rnd[i] = 0
            wits[i] = False
            continue
        p1, p2 = int(parents_np[i, 0]), max(int(parents_np[i, 1]), 0)
        if p1 < 0:          # genesis: round 0 and a witness
            r, is_wit = round0, witness
        else:
            r0 = torch.maximum(rnd[p1 : p1 + 1], rnd[p2 : p2 + 1])
            r0w = r0 - r_base if r_base else r0                    # window row
            r0c = r0w.clamp(0, r_max - 1)
            widx = tab.index_select(0, r0c)[0]                     # S
            wvalid = (widx >= 0) & (r0c == r0w)                    # row in window
            widxc = widx.clamp(0, n - 1)
            if col_pos is None:
                ss = ssm_rows[i - start].index_select(0, widxc) & wvalid   # S
            else:
                wpos = col_pos.index_select(0, widxc)                # S (-1 = absent)
                ss = (
                    ssm_rows[i - start].index_select(0, wpos.clamp(0, n_cols - 1))
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
        rw = r - r_base if r_base else r
        rc = rw.clamp(0, r_max - 1)
        in_window = rc == rw                                       # 0 <= rw < r_max
        slot = cnt.index_select(0, rc)
        overflow |= torch.where(is_wit & ~in_window, OVF_ROUND, 0).to(torch.int32)
        overflow |= torch.where(is_wit & (slot >= s_max), OVF_SLOT, 0).to(torch.int32)
        do = is_wit & (slot < s_max) & in_window
        flat = rc * s_max + slot.clamp(0, s_max - 1)
        tab_flat = tab.view(-1)
        tab_flat.index_put_((flat,), torch.where(do, i, tab_flat.index_select(0, flat)))
        cnt.index_add_(0, rc, do.to(torch.int32))
        rnd[i : i + 1] = r
        wits[i : i + 1] = is_wit
    if check is not None:
        rounds_check_reference(parents_np, col_pos, rnd, tab, overflow, check,
                               start=start, length=ssm_rows.shape[0])


def rounds_check_reference(parents_np, col_pos, rnd, tab, overflow, check, *,
                           start, length):
    """Plain version of the kernel's check epilogue, in tensors: ``check``
    (int32 ``[CHECK_HEAD + cap]``) gets the overflow word, the number of
    distinct table witnesses whose ``col_pos`` is -1 (``np.unique(tab[tab
    >= 0])`` filtered by ``col_pos < 0``, the order ``add_columns`` gives
    them columns in), or -1 when more than ``cap`` table entries lack a
    column, whether a missing witness is affected (below ``start``, or a
    later event of ``[start, start + length)`` whose ``max(rnd[p1],
    rnd[p2])``, -1 for a genesis, is its round), and the witnesses
    ascending, -1 after.  Without ``col_pos`` no witness lacks a column."""
    cap = check.shape[0] - CHECK_HEAD
    n = rnd.shape[0]
    dev = rnd.device
    check[0:1] = overflow
    check[1:] = -1
    if col_pos is None:
        check[1:3] = 0
        return
    # sort keys: a missing witness's id; every other entry, and then each
    # repeat, pushed past every id (no sentinel value)
    w = tab.reshape(-1).to(torch.int64)
    missing = (w >= 0) & (col_pos.index_select(0, w.clamp(0, n - 1)) < 0)
    n_raw = missing.to(torch.int32).sum()
    past = 1 << 32
    key = (w.clamp(min=0) + past * (~missing).to(torch.int64)).sort().values
    first = torch.cat([key[:1] < past, ~(key[1:] == key[:-1])]) & (key < past)
    listed = (key + 2 * past * (~first).to(torch.int64)).sort().values[:cap]
    listed = torch.where(listed < past, listed, -1).clamp(max=INT32_MAX)  # int32 ids
    k = listed.shape[0]
    # affected: below start, or queried by a later event of the span
    p = parents_np[start : start + length].astype(np.int64)
    q1 = torch.as_tensor(p[:, 0], device=dev).clamp(0, n - 1)
    q2 = torch.as_tensor(p[:, 1], device=dev).clamp(0, n - 1)
    r0 = torch.maximum(rnd.index_select(0, q1), rnd.index_select(0, q2))
    r0 = torch.where(torch.as_tensor(p[:, 0] < 0, device=dev), -1, r0)
    ev = torch.arange(length, dtype=torch.int64, device=dev) + start
    listed_ok = listed >= 0
    w_rnd = rnd.index_select(0, listed.clamp(0, n - 1))
    below = (listed_ok & (listed < start)).to(torch.int32).sum()
    queried = (listed_ok[:, None] & (ev[None, :] > listed[:, None])
               & (r0[None, :] == w_rnd[:, None])).to(torch.int32).sum()
    complete = n_raw <= cap
    count = first.to(torch.int32).sum()
    affected = (below + queried) > 0
    check[1:2] = torch.where(complete, count, -1)
    check[2:3] = (affected & complete).to(torch.int32)
    check[CHECK_HEAD : CHECK_HEAD + k] = torch.where(complete, listed, -1)


def _span_parents(parents, start: int, length: int, dev: torch.device):
    """The span's parent rows as a contiguous int32 ``(length, 2)`` tensor
    on ``dev``: a view of a tensor already there, else host rows staged in
    pinned memory and copied without waiting for the card."""
    if isinstance(parents, torch.Tensor) and parents.device == dev:
        _check(parents, "parents", torch.int32, 2)
        return parents[start : start + length].contiguous()
    rows = torch.from_numpy(np.ascontiguousarray(
        np.asarray(parents)[start : start + length], dtype=np.int32))
    return rows.pin_memory().to(dev, non_blocking=True)


def rounds_scan(parents, ssm_rows, col_pos, creator, stake, rnd, wits, tab,
                cnt, overflow, *, start, n_valid, r_base, tot_stake,
                has_forks, check=None, stats=None):
    """The rounds scan over events ``[start, start + L)``, ``L =
    ssm_rows.shape[0]``, resumed from the carry ``(rnd, wits, tab, cnt,
    overflow)`` and updated in place, exactly as the reference's scan over
    ``_make_rounds_step``: genesis events get round 0 and are witnesses,
    events at or past ``n_valid`` round 0 and are not; otherwise ``r0 =
    max(rnd[p1], rnd[p2])``, the witnesses of table row ``r0 - r_base`` that
    the event strongly sees add their stake (per member with forks), and a
    strict 2/3 promotes it; witnesses land in slot ``cnt[row]`` in event
    order, ``OVF_ROUND`` / ``OVF_SLOT`` ORed into ``overflow``.

    ``parents`` int32 ``(>= start + L, 2)`` rows by event, on the host (a
    numpy array or CPU tensor) or on the tensors' device; ``ssm_rows`` bool
    ``(L, C)``, the span's rows of the strongly-sees store, whose columns
    are events when ``col_pos`` is None (``C == n``) and otherwise the
    column store's, ``col_pos`` int32 ``(n,)`` mapping an event to its
    column (-1 = absent); ``creator`` int32 ``(n,)``; ``stake`` int32
    ``(M,)`` summing to ``tot_stake``; ``rnd`` int32 ``(n,)`` (global
    rounds), ``wits`` bool ``(n,)``, ``tab`` int32 ``(r_max, s_max)`` (row
    ``k`` is round ``r_base + k``), ``cnt`` int32 ``(r_max,)``, ``overflow``
    int32 ``(1,)``.  ``check``, int32 ``(CHECK_HEAD + cap,)``, gets the
    witness-column check (:func:`rounds_check_reference`): the one buffer
    a caller reads back in place of the table and the rounds.  ``stats``,
    int32 ``(2,)`` on the card, gets the kernel's steps (runs of events)
    and the runs it cut short added to it; the plain version leaves it.
    On the card one launch and no allocation but the span's parents when
    they come from the host and, when the table lives in device memory,
    its slot info."""
    _check(ssm_rows, "ssm_rows", torch.bool, 2)
    _check(creator, "creator", torch.int32, 1)
    _check(stake, "stake", torch.int32, 1)
    _check(rnd, "rnd", torch.int32, 1)
    _check(wits, "wits", torch.bool, 1)
    _check(tab, "tab", torch.int32, 2)
    _check(cnt, "cnt", torch.int32, 1)
    _check(overflow, "overflow", torch.int32, 1)
    length, n_cols = ssm_rows.shape
    n = rnd.shape[0]
    r_max, s_max = tab.shape
    n_members = stake.shape[0]
    start, n_valid, r_base = int(start), int(n_valid), int(r_base)
    if col_pos is not None:
        _check(col_pos, "col_pos", torch.int32, 1)
        if col_pos.shape[0] != n:
            raise ValueError(f"rounds_scan: col_pos has {col_pos.shape[0]} events, not n = {n}")
    elif n_cols != n:
        raise ValueError(f"rounds_scan: the full matrix's rows have {n_cols} columns, not n = {n}")
    if wits.shape[0] != n or creator.shape[0] != n:
        raise ValueError("rounds_scan: rnd, wits and creator disagree on n")
    if cnt.shape[0] != r_max or overflow.shape[0] != 1:
        raise ValueError("rounds_scan: cnt must be (r_max,) and overflow (1,)")
    if min(n_cols, r_max, s_max, n_members) < 1:
        raise ValueError("rounds_scan: empty columns, witness table or stake")
    if start < 0 or start + length > n:
        raise ValueError(f"rounds_scan: events [{start}, {start + length}) outside [0, {n})")
    if tuple(parents.shape[1:]) != (2,) or parents.shape[0] < start + length:
        raise ValueError(f"rounds_scan: parents of shape {tuple(parents.shape)} do not "
                         f"cover events [{start}, {start + length})")
    tot_stake = check_stake_envelope(tot_stake)
    tensors = [ssm_rows, creator, stake, rnd, wits, tab, cnt, overflow]
    if col_pos is not None:
        tensors.append(col_pos)
    if check is not None:
        _check(check, "check", torch.int32, 1)
        if check.shape[0] <= CHECK_HEAD:
            raise ValueError(f"rounds_scan: a check buffer holds more than {CHECK_HEAD} words")
        tensors.append(check)
    if stats is not None:
        _check(stats, "stats", torch.int32, 1)
        if stats.shape[0] != 2:
            raise ValueError("rounds_scan: stats must be (2,)")
    if _on_cpu(*tensors):
        rounds_scan_reference(
            parents, ssm_rows, col_pos, creator, stake, rnd, wits, tab, cnt,
            overflow, start=start, n_valid=n_valid, r_base=r_base,
            tot_stake=tot_stake, has_forks=has_forks, check=check,
        )
        return
    if length == 0 and check is None:
        return
    if stats is not None:
        _on_cpu(rnd, stats)
    dev = rnd.device
    cap = 0 if check is None else check.shape[0] - CHECK_HEAD
    plan = rounds_scan_plan(r_max, s_max, n_members, bool(has_forks), cap)
    info = (torch.empty((r_max * s_max, 2), dtype=torch.int32, device=dev)
            if plan.route == "global" else None)
    par = _span_parents(parents, start, length, dev)
    err = _launch(
        dev, _c_function("rounds_scan", "rounds_scan_launch"),
        par.data_ptr(), ssm_rows.data_ptr(), n_cols,
        None if col_pos is None else col_pos.data_ptr(), creator.data_ptr(),
        stake.data_ptr(), n_members, rnd.data_ptr(), wits.data_ptr(),
        tab.data_ptr(), cnt.data_ptr(), overflow.data_ptr(),
        None if info is None else info.data_ptr(),
        None if check is None else check.data_ptr(), cap,
        None if stats is None else stats.data_ptr(), n, r_max, s_max,
        start, length, n_valid, r_base, tot_stake, int(bool(has_forks)),
        int(plan.route == "shared"), plan.smem,
    )
    _raise_on(err, "rounds_scan")
    rounds_scan.launches += 1


rounds_scan.launches = 0


# --------------------------------------------------------------- fame_scan

# the H100's opt-in shared memory a block, less the kernel's static words
_FS_SMEM_LIMIT = 232448 - 64
_FS_WARPS = 16              # warps of a fame block, a witness slot each
_FS_SS_WORDS = 12288        # the staged strongly-sees rows a block aims for (48 KB)
# where the kernel reads its cells: the slabs by witness index (the full
# matrix, or the column store through col_pos), or gathered cells
_FS_SLAB, _FS_COLUMNS, _FS_CELLS = 0, 1, 2


def _fame_smem_words(s_max: int, warps: int, ss_words: int, exact: bool) -> int:
    """The fame kernel's dynamic shared memory in 32-bit words, as
    ``csrc/fame_scan.cu:smem_words`` carves it: two vote masks a slot, 32
    stake planes and the staged strongly-sees rows; with ``exact`` four
    masks (the forked slots, those not their creator's last, the runs'
    other and last positions) and the slot at each position of the plan's
    order (16 bits)."""
    sw = (s_max + 31) // 32
    words = 2 * warps * sw + 32 * sw + ss_words
    if exact:
        words += 4 * sw + (s_max + 1) // 2
    return words


def fame_launch_shape(s_max: int, exact: bool):
    """``(warps, ss_words, smem_bytes)`` of a fame launch over
    ``s_max`` slots a round, from the shape alone: 16 warps and a tile of
    strongly-sees rows up to 48 KB (a whole round's voters where they fit);
    where that exceeds a block's shared memory the least tile (32 voters),
    then 8 warps.  Raises ``ValueError`` past that: past 18 584 slots with
    ``exact``, 23 200 without."""
    sw = (s_max + 31) // 32
    ss_min = 32 * (sw | 1)
    ss_full = max(ss_min, min(_FS_SS_WORDS, 32 * sw * (sw | 1)))
    for warps, ss_words in ((_FS_WARPS, ss_full), (_FS_WARPS, ss_min), (8, ss_min)):
        smem = 4 * _fame_smem_words(s_max, warps, ss_words, exact)
        if smem <= _FS_SMEM_LIMIT:
            return warps, ss_words, smem
    raise ValueError(f"fame_scan: {s_max} slots a round exceed a block's shared memory")


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain boolean matmul (0/1 float32 products, exact; TF32 is off) for
    the fame tally, which the reference also leaves to a plain matmul."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)) > 0.5


def fame_scan_reference(wit_table, sees, ssm, creator, coin, stake, tot_stake,
                        coin_period, *, has_forks, col_pos=None):
    """Plain version, as the port ran fame voting before its kernel: the
    reference's scan step a round, as about 60 tensor ops over every (y,
    x) slot pair of the round at once (a float32 matmul tally, or with
    forks a per-creator boolean matmul).  ``sees`` and ``ssm`` may be a
    group rank's row views (``parallel.RowGather``): each round then
    gathers its witness rows of both."""
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
    marange = torch.arange(n_members, dtype=torch.int64, device=dev)
    w_range = torch.arange(w_max, dtype=torch.int64, device=dev)

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
        if col_pos is None:
            ssy = ssm[ye][:, pe]                        # S,S
        else:
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


def _slab_tensor(slab) -> torch.Tensor:
    """A slab's own tensor: the slab, or a group rank's row view's
    (``parallel.RowGather``) shard."""
    return slab if isinstance(slab, torch.Tensor) else slab.shard


def _cells(slab, rows, cols):
    """bool ``(R', S, S)`` with ``out[r, p, y] = slab[rows[r, y], cols[r,
    p]]``: one gather, of the cells alone on a group rank's row view."""
    if isinstance(slab, torch.Tensor):
        return slab[rows[:, None, :], cols[:, :, None]]
    return slab.cells(rows, cols)


def _fame_cells(wit_table, sees, ssm, col_pos):
    """The cells the fame kernel reads, gathered on the device with no host
    pull: bool ``(R - 1, S, S)`` ``sp`` and ``ss``, ``[r - 1, p, y]``
    whether slot ``y`` of round ``r`` sees and strongly sees slot ``p`` of
    round ``r - 1`` (an empty slot's event clipped to ``[0, n)``, as the
    reference clips it; the kernel masks empty slots).  With ``col_pos``,
    ``ssm`` is the column store and a witness without a column (-1) is
    strongly seen by none.  The kernel's input on a group rank's row views
    (one gather of the cells a slab); on plain slabs the kernel reads the
    same cells itself, and ``chip_smoke.py`` times this as their plain
    gather."""
    n = sees.shape[0]
    we = wit_table.clamp(0, n - 1).to(torch.int64)
    y, p = we[1:], we[:-1]
    sp = _cells(sees, y, p)
    if col_pos is None:
        return sp, _cells(ssm, y, p)
    ppos = col_pos.index_select(0, p.reshape(-1)).reshape(p.shape)
    ss = _cells(ssm, y, ppos.clamp(0, ssm.shape[1] - 1).to(torch.int64))
    return sp, ss & (ppos >= 0)[:, :, None]


def _fame_plan(wit_table, creator, stake, n: int):
    """Plain version of the plan that each block of the fame kernel builds
    in shared memory as it reaches a round (``csrc/fame_scan.cu``):
    ``(width, planes, head)``, int32 ``(R,)`` one past each round's last
    witness slot (0 for none); bool ``(R, 32, S)``, bit ``b`` of the stake
    (as uint32) of each slot's creator, False for an empty slot or a creator
    outside the stake; int32 ``(R, S)``, for a slot whose creator has
    another slot in the round that creator's first slot, else -1 (the runs
    of the kernel's list: a forked creator's mask is the slots naming its
    first slot).  The card's route does not call it; the tests and
    ``chip_smoke.py`` do."""
    r_max, s_max = wit_table.shape
    dev = wit_table.device
    m = stake.shape[0]
    valid = wit_table >= 0
    slots = torch.arange(s_max, dtype=torch.int32, device=dev)
    width = torch.where(valid, slots + 1, 0).amax(dim=1).to(torch.int32)
    cre = creator[wit_table.clamp(0, n - 1).to(torch.int64)]
    known = valid & (cre >= 0) & (cre < m)
    cre = torch.where(known, cre, -1)
    st = torch.where(known, stake[cre.clamp(0, m - 1).to(torch.int64)], 0)
    bits = torch.arange(32, dtype=torch.int64, device=dev)
    planes = ((st.to(torch.int64) & 0xFFFFFFFF)[:, None, :] >> bits[None, :, None]) & 1 == 1
    same = (cre[:, :, None] == cre[:, None, :]) & known[:, :, None] & known[:, None, :]
    first = torch.argmax(same.to(torch.int32), dim=2)   # the first slot of the creator
    head = torch.where(same.sum(dim=2) > 1, first, -1).to(torch.int32)
    return width, planes, head


def fame_scan(wit_table, sees, ssm, creator, coin, stake, tot_stake,
              coin_period, *, has_forks, col_pos=None):
    """Virtual fame voting, exactly as the reference's ``fame_scan``.
    Returns ``(famous int8 (R * S,), decided_at int32 (R * S,))`` over the
    witness slots, row-major (round, slot): 1 famous, 0 not, -1 undecided,
    and the table-local round whose tally first decided the slot (-1
    undecided).

    ``wit_table`` int32 ``(R, S)`` (-1 an empty slot; any slot capacity:
    the kernel's cost follows each round's own width); ``sees`` bool ``(n,
    n)``; ``ssm`` bool, the full ``(n, n)`` strongly-sees matrix, or with
    ``col_pos`` (int32 ``(n,)``, -1 no column) the column store ``(n,
    C)``; either slab may be a group rank's row view
    (``parallel.RowGather``); ``creator`` int32 and ``coin`` uint8 (the
    packer's coin bits) ``(n,)``, ``stake`` int32 ``(M,)`` summing to
    ``tot_stake``; ``coin_period`` >= 1.
    On the card one C call and one kernel launch, which reads its cells
    from the slabs itself: no other device op, no host pull, no scratch; it
    allocates the outputs alone.  On a group rank's row views the cells are
    gathered first (:func:`_fame_cells`, one gather a slab).  Raises
    ``ValueError`` where ``S`` slots a round need more shared memory than
    a block has (:func:`fame_launch_shape`)."""
    _check(wit_table, "wit_table", torch.int32, 2)
    _check(_slab_tensor(sees), "sees", torch.bool, 2)
    _check(_slab_tensor(ssm), "ssm", torch.bool, 2)
    _check(creator, "creator", torch.int32, 1)
    _check(coin, "coin", torch.uint8, 1)
    _check(stake, "stake", torch.int32, 1)
    r_max, s_max = wit_table.shape
    n = sees.shape[0]
    n_members = stake.shape[0]
    if sees.shape[1] != n:
        raise ValueError(f"fame_scan: sees must be square, got {tuple(sees.shape)}")
    if min(n, r_max, s_max, n_members) < 1:
        raise ValueError("fame_scan: empty slabs, witness table or stake")
    if creator.shape[0] != n or coin.shape[0] != n:
        raise ValueError(f"fame_scan: creator and coin must be ({n},)")
    tensors = [wit_table, creator, coin, stake]
    if col_pos is not None:
        _check(col_pos, "col_pos", torch.int32, 1)
        if col_pos.shape[0] != n or ssm.shape[0] != n or ssm.shape[1] < 1:
            raise ValueError(f"fame_scan: col_pos must be ({n},) and the column "
                             f"store ({n}, C), got {tuple(col_pos.shape)} and "
                             f"{tuple(ssm.shape)}")
        tensors.append(col_pos)
    elif tuple(ssm.shape) != (n, n):
        raise ValueError(f"fame_scan: the full matrix must be ({n}, {n}), got "
                         f"{tuple(ssm.shape)}")
    coin_period = int(coin_period)
    if coin_period < 1:
        raise ValueError(f"fame_scan: a coin period of {coin_period}")
    tot_stake = check_stake_envelope(tot_stake)
    views = not (isinstance(sees, torch.Tensor) and isinstance(ssm, torch.Tensor))
    on_cpu = _on_cpu(*tensors, *(() if views else (sees, ssm)))
    if {_slab_tensor(x).device for x in (sees, ssm)} != {wit_table.device}:
        raise ValueError("fame_scan: the slabs lie on another device than the table")
    if on_cpu:
        return fame_scan_reference(
            wit_table, sees, ssm, creator, coin, stake, tot_stake, coin_period,
            has_forks=has_forks, col_pos=col_pos,
        )
    exact = bool(has_forks or tot_stake >= (1 << 24))
    warps, ss_words, smem = fame_launch_shape(s_max, exact)
    if views:
        src, ld = _FS_CELLS, s_max
        sees, ssm = _fame_cells(wit_table, sees, ssm, col_pos)
    else:
        src, ld = (_FS_SLAB if col_pos is None else _FS_COLUMNS), ssm.shape[1]
    dev = wit_table.device
    famous = torch.empty((r_max * s_max,), dtype=torch.int8, device=dev)
    dec = torch.empty((r_max * s_max,), dtype=torch.int32, device=dev)
    err = _launch(
        dev, _c_function("fame_scan", "fame_scan_launch"),
        wit_table.data_ptr(), sees.data_ptr(), ssm.data_ptr(),
        None if col_pos is None else col_pos.data_ptr(), creator.data_ptr(),
        coin.data_ptr(), stake.data_ptr(), n, ld, n_members, r_max, s_max,
        tot_stake, coin_period, int(exact), src, famous.data_ptr(),
        dec.data_ptr(), warps, ss_words, smem,
    )
    _raise_on(err, "fame_scan")
    fame_scan.launches += 1
    return famous, dec


fame_scan.launches = 0


# -------------------------------------------------------------- order_scan

# the H100's opt-in shared memory a block, less the kernel's static bytes;
# the order kernel keeps 73 int32 words a slot there (csrc/order_scan.cu,
# Smem: the round's slots, its packed witnesses, their chain windows of 16
# rows and the 32 lanes' values)
_OS_SMEM_LIMIT = 232448 - 512
_OS_SMEM_PER_SLOT = 73 * 4


def _order_rounds(wit_table, wit_count, famous, creator, max_round, n: int):
    """The order scan's facts of every round at once, on the tensors'
    device: ``(we_all, ufw, prefix)``, the witness events clipped to ``[0,
    n)``, bool ``(R, S)`` marking the unique famous witnesses (famous, and
    the only famous witness of their creator in the round) and bool ``(R,)``
    marking the maximal prefix of fame-complete rounds."""
    r_max, s_max = wit_table.shape
    dev = wit_table.device
    famous_grid = famous.reshape(r_max, s_max)
    wvalid = wit_table >= 0
    decided = (famous_grid >= 0) | ~wvalid
    complete = (
        decided.all(dim=1)
        & (max_round >= torch.arange(r_max, dtype=torch.int64, device=dev) + 2)
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
    return we_all, fam & (cnt_same == 1), prefix


def _order_plan(wit_table, wit_count, famous, creator, max_round, n: int):
    """Plain version of the plan that each block of the order kernel builds
    in shared memory as it reaches a round (``csrc/order_scan.cu``,
    ``round_plan``): int32 ``(R, S)`` holding each round's unique famous
    witnesses' events first, in slot order, and int32 ``(R,)`` their count,
    0 for a round outside the fame-complete prefix (a round that receives
    nothing).  The card's route does not call it; the tests and
    ``chip_smoke.OrderCase.nbytes`` do."""
    we_all, ufw, prefix = _order_rounds(wit_table, wit_count, famous, creator,
                                        max_round, n)
    first = torch.argsort((~ufw).to(torch.int32), dim=1, stable=True)
    ufw_ev = torch.gather(we_all, 1, first).to(torch.int32).contiguous()
    nv = torch.where(prefix, ufw.sum(dim=1), 0).to(torch.int32)
    return ufw_ev, nv


def order_scan_reference(anc, wit_table, wit_count, famous, creator,
                         self_parent, t_rank, max_round, n_valid: int, *,
                         chain: int, received0=None, cols=None):
    """Plain version, as the port ran the order scan before its kernel:
    which rounds can receive anything (inside the prefix, with a unique
    famous witness) is computed for all rounds at once and pulled to the
    host, the reference's ``lax.cond`` a host ``if``; each receiving round
    walks the self-chains ``chain`` steps as tensor ops and sorts for the
    median.  With ``cols = (x0, x1)``, ``anc`` is the ``(n, x1 - x0)``
    slab of those columns and the outputs are the window's events'."""
    r_max, s_max = wit_table.shape
    n = anc.shape[0]
    x0, x1 = (0, n) if cols is None else cols
    dev = anc.device
    we_all, ufw, prefix = _order_rounds(wit_table, wit_count, famous, creator,
                                        max_round, n)
    go = to_host(prefix & ufw.any(dim=1))
    nv_all = to_host(ufw.sum(dim=1))

    ev_valid = torch.arange(n, dtype=torch.int64, device=dev)[x0:x1] < n_valid
    received = (
        received0[x0:x1].clone() if received0 is not None
        else torch.zeros((x1 - x0,), dtype=torch.bool, device=dev)
    )
    rr_out = torch.full((x1 - x0,), -1, dtype=torch.int32, device=dev)
    ts_out = torch.zeros((x1 - x0,), dtype=torch.int32, device=dev)
    for r in range(r_max):
        if not go[r]:
            continue
        we = we_all[r]
        u = ufw[r]
        all_see = (anc[we] | ~u[:, None]).all(dim=0)   # N
        newly = all_see & ~received & ev_valid
        # earliest-seeing timestamps via self-chain walk (w -> genesis)
        cur = we
        tsw = torch.full((s_max, x1 - x0), INT32_MAX, dtype=torch.int32, device=dev)
        for _ in range(chain):
            tsw = torch.where(anc[cur], t_rank[cur][:, None], tsw)
            nxt = self_parent[cur]
            cur = torch.where(nxt >= 0, nxt, cur)
        # non-UFW rows become the sort sentinel: they sort last, and the
        # median index stays below them
        tsw = torch.where(u[:, None], tsw, INT32_MAX)  # swirld-lint: disable=SW011 -- masking non-UFW rows TO the sort sentinel is the point, as in the reference's order scan: they sort last, and med_i < nv keeps the median strictly below any masked row (the packer bounds live timestamps under INT32_MAX)
        ts_sorted = torch.sort(tsw, dim=0).values       # S,N ascending
        med_i = min(max((int(nv_all[r]) - 1) // 2, 0), s_max - 1)
        med = ts_sorted[med_i]                           # N
        received |= newly
        rr_out = torch.where(newly, r, rr_out)
        ts_out = torch.where(newly, med, ts_out)
    return rr_out, ts_out, received


def order_scan(anc, wit_table, wit_count, famous, creator, self_parent,
               t_rank, max_round, n_valid, *, chain, received0=None, cols=None):
    """Round received and consensus timestamp ranks over the maximal
    fame-complete prefix of rounds, exactly as the reference's
    ``order_scan``: an event below ``n_valid`` not yet received is received
    in the first round of the prefix whose unique famous witnesses all have
    it as an ancestor, its timestamp rank the lower median of their
    deepest self-ancestors' (within ``chain`` steps) that still see it.

    ``anc`` bool ``(n, n)`` (row ``i``'s ancestors), ``wit_table`` int32
    ``(R, S)`` (-1 an empty slot), ``wit_count`` int32 ``(R,)``, ``famous``
    int8 ``(R * S,)`` (1 famous, 0 not, -1 undecided), ``creator``,
    ``self_parent`` (-1 at genesis) and ``t_rank`` int32 ``(n,)``,
    ``max_round`` (an int, or an int32 or int64 device scalar) in the
    table's round frame, ``received0`` bool ``(n,)`` or None.  Returns
    ``(round_received int32 (n,) (-1 = not received), ts_rank int32 (n,)
    (0 where not newly received), received bool (n,))``.

    ``cols = (x0, x1)`` restricts the call to the events of that column
    window: ``anc`` is then the ``(n, x1 - x0)`` slab of those columns of
    every row (a view of the whole slab's columns, or a group rank's
    column slab: its rows need only be contiguous), and the three outputs
    are the window's, ``(x1 - x0,)``, equal to that slice of the whole
    call's.  ``None`` is the whole window ``(0, n)``, ``anc`` square.

    On the card one C call and one kernel launch, which builds the round
    plan itself: no other device op, no host pull, no scratch; it
    allocates the three outputs alone.  Raises ``ValueError`` where ``S``
    slots a round need more shared memory than a block has (about
    790)."""
    _check(anc, "anc", torch.bool, 2)
    _check(wit_table, "wit_table", torch.int32, 2)
    _check(wit_count, "wit_count", torch.int32, 1)
    _check(famous, "famous", torch.int8, 1)
    for name, x in (("creator", creator), ("self_parent", self_parent),
                    ("t_rank", t_rank)):
        _check(x, name, torch.int32, 1)
    n = anc.shape[0]
    r_max, s_max = wit_table.shape
    chain, n_valid = int(chain), int(n_valid)
    if cols is None:
        if anc.shape[1] != n:
            raise ValueError(f"order_scan: anc must be square, got {tuple(anc.shape)}")
        x0, x1 = 0, n
    else:
        x0, x1 = (int(c) for c in cols)
        if not 0 <= x0 < x1 <= n or anc.shape[1] != x1 - x0:
            raise ValueError(f"order_scan: a column window {cols} of {n} events "
                             f"over an anc slab of shape {tuple(anc.shape)}")
    if anc.stride(1) != 1 and anc.shape[1] > 1:
        raise ValueError("order_scan: anc's rows must be contiguous")
    if min(n, r_max, s_max) < 1:
        raise ValueError("order_scan: empty ancestry or witness table")
    if wit_count.shape[0] != r_max or famous.shape[0] != r_max * s_max:
        raise ValueError(f"order_scan: wit_count must be ({r_max},) and famous "
                         f"({r_max * s_max},) for a ({r_max}, {s_max}) table")
    if any(x.shape[0] != n for x in (creator, self_parent, t_rank)):
        raise ValueError(f"order_scan: creator, self_parent and t_rank must be ({n},)")
    if chain < 0:
        raise ValueError(f"order_scan: a chain of {chain} steps")
    tensors = [wit_table, wit_count, famous, creator, self_parent, t_rank]
    if received0 is not None:
        _check(received0, "received0", torch.bool, 1)
        if received0.shape[0] != n:
            raise ValueError(f"order_scan: received0 must be ({n},)")
        tensors.append(received0)
    if isinstance(max_round, torch.Tensor):
        tensors.append(max_round.reshape(1))
    # anc may be a view of some columns (the kernel takes its rows' stride)
    if anc.device != wit_table.device:
        raise ValueError(f"order_scan: anc on {anc.device}, the table on {wit_table.device}")
    if _on_cpu(*tensors):
        return order_scan_reference(
            anc, wit_table, wit_count, famous, creator, self_parent, t_rank,
            max_round, n_valid, chain=chain, received0=received0, cols=cols,
        )
    smem = _OS_SMEM_PER_SLOT * s_max
    if smem > _OS_SMEM_LIMIT:
        raise ValueError(f"order_scan: {s_max} slots a round exceed a block's shared memory")
    mr_ptr, mr_64, mr_value = None, 0, 0
    if isinstance(max_round, torch.Tensor):
        if max_round.dtype not in (torch.int32, torch.int64) or max_round.numel() != 1:
            raise TypeError(f"order_scan: max_round on the card must be one int32 or "
                            f"int64 value, got {max_round.dtype} {tuple(max_round.shape)}")
        mr_ptr, mr_64 = max_round.data_ptr(), int(max_round.dtype == torch.int64)
    else:
        # the kernel compares it with r + 2 <= r_max + 1: clamped, exact
        mr_value = max(min(int(max_round), INT32_MAX), -INT32_MAX)
    dev = anc.device
    rr = torch.empty((x1 - x0,), dtype=torch.int32, device=dev)
    ts = torch.empty((x1 - x0,), dtype=torch.int32, device=dev)
    received = torch.empty((x1 - x0,), dtype=torch.bool, device=dev)
    err = _launch(
        dev, _c_function("order_scan", "order_scan_launch"),
        anc.data_ptr(), n, x0, x1, anc.stride(0), wit_table.data_ptr(),
        wit_count.data_ptr(), famous.data_ptr(), creator.data_ptr(), r_max, s_max,
        self_parent.data_ptr(), t_rank.data_ptr(),
        None if received0 is None else received0.data_ptr(), mr_ptr, mr_64,
        mr_value, max(0, min(n_valid, n)), min(chain, INT32_MAX),
        received.data_ptr(), rr.data_ptr(), ts.data_ptr(), smem,
    )
    _raise_on(err, "order_scan")
    order_scan.launches += 1
    return rr, ts, received


order_scan.launches = 0


# ------------------------------------------------------- extension bundle


def make_extension_kernels():
    """The :class:`~tpu_swirld_torch.gpu.incremental.ExtensionKernels`
    bundle of the window-extension hot path (``pallas_kernels.py:
    make_extension_kernels``): :func:`bmm_or` as the ancestry and forkseen
    hop and :func:`ssm_block` as the strongly-sees block, so on a CUDA
    device every extension hop launches the hand-written kernels.  The
    reference's adapters drop a matmul dtype; these kernels are exact and
    take none, so the wrappers are the seam as they are.  The
    incremental driver's default."""
    from tpu_swirld_torch.gpu.incremental import ExtensionKernels

    return ExtensionKernels(name="cuda", bmm=bmm_or, ssm_block_fn=ssm_block)


def make_mesh_row_block_fn(mesh):
    """The row-sharded strongly-sees block of
    :func:`tpu_swirld_torch.parallel.make_row_sharded_block_fn` with
    :func:`ssm_tally` as the shard-local step (the route of
    ``pallas_kernels.py:make_mesh_row_block_fn``): on the card each shard
    that owns a row of the block launches the CUDA tally once, whatever
    ``M`` is, and no ``bmm_or``.  The int32 tallies are summed over the
    shards before the threshold, which is why ``ssm_block``, whose epilogue
    thresholds inside the kernel, cannot stand in.
    ``MeshStreamingConsensus(pallas=True)`` builds it.
    ``make_mesh_row_block_fn.launches`` counts the blocks run on a CUDA
    device (each one at most ``D`` ``ssm_tally`` launches)."""
    from tpu_swirld_torch.parallel import _row_sharded_block_fn

    block = _row_sharded_block_fn(mesh, ssm_tally, every_shard=False)

    def mesh_row_block(sees, member_table, stake, cols, row0, *, rows,
                       tot_stake):
        out = block(sees, member_table, stake, cols, row0, rows=rows,
                    tot_stake=tot_stake)
        if sees.device.type == "cuda":
            make_mesh_row_block_fn.launches += 1
        return out

    return mesh_row_block


make_mesh_row_block_fn.launches = 0
