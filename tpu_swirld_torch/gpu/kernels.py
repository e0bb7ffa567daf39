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

:func:`make_extension_kernels` bundles ``bmm_or`` and ``ssm_block`` for the
incremental driver, as ``pallas_kernels.py:make_extension_kernels`` does;
:func:`make_mesh_row_block_fn` puts ``ssm_tally`` into the row-sharded
strongly-sees block, where ``pallas_kernels.py:make_mesh_row_block_fn`` puts
``bmm_or_pallas``.

Each wrapper takes its plain PyTorch version (``bmm_or_reference``,
``ssm_block_reference``, ``ssm_matrix_reference``, ``ssm_tally_reference``)
only for tensors on the CPU.  For CUDA tensors it
launches the kernel or raises; there is no fallback.  ``<wrapper>.launches``
counts the kernel launches (plain-version calls do not count), so a run can
show that it went through the kernel.  The wrappers that take ``tot_stake``
raise ``ValueError`` outside the int32 stake envelope
(:func:`check_stake_envelope`), on either device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

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
