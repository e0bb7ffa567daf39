"""The port's hand-written CUDA kernels, their wrappers and plain versions.

- :func:`bmm_or` (``csrc/bmm_or.cu``) replaces ``tpu_swirld/tpu/
  pallas_kernels.py:bmm_or_pallas``: the boolean OR-matmul hop of the
  ancestry closure and of forkseen.
- :func:`ssm_block` (``csrc/ssm_block.cu``) replaces ``pallas_kernels.py:
  ssm_block_pallas``: the member-hop strongly-sees block with an int32 stake
  tally and a strict-2/3 epilogue.

Each wrapper takes its plain PyTorch version (``bmm_or_reference``,
``ssm_block_reference``) only for tensors on the CPU.  For CUDA tensors it
launches the kernel or raises; there is no fallback.  ``<wrapper>.launches``
counts the kernel launches (plain-version calls do not count), so a run can
show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_swirld_torch.gpu import build

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_ARGTYPES = {
    "bmm_or_launch": [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP],
    "ssm_block_launch": [
        _VP, _INT, _VP, _INT, _INT, _VP, _VP, _INT, _INT, _INT,
        ctypes.c_longlong, _VP, _VP, _VP, _VP,
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


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


# ------------------------------------------------------------------ bmm_or


def bmm_or_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: 0/1 float32 matmul (TF32 off), thresholded at 0.5."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)) > 0.5


def bmm_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``out[p, r] = OR_q a[p, q] & b[q, r]`` for bool ``a[P, Q]``,
    ``b[Q, R]``, any ``P, Q, R >= 1``."""
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
    launch = _c_function("bmm_or", "bmm_or_launch")
    nw = (q + 31) // 32
    with torch.cuda.device(a.device):
        a_bits = torch.empty((p, nw), dtype=torch.int32, device=a.device)
        b_bits = torch.empty((r, nw), dtype=torch.int32, device=a.device)
        out = torch.empty((p, r), dtype=torch.bool, device=a.device)
        err = launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), a_bits.data_ptr(),
            b_bits.data_ptr(), p, q, r,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    _raise_on(err, "bmm_or")
    bmm_or.launches += 1
    return out


bmm_or.launches = 0


# --------------------------------------------------------------- ssm_block


def _block_row0(row0: int, rows: int, n: int) -> int:
    """The block's first row as ``lax.dynamic_slice`` takes a start: a
    negative start counts from the end, then the start is clamped so the
    slice fits."""
    if not 1 <= rows <= n:
        raise ValueError(f"ssm_block: rows={rows} outside [1, {n}]")
    row0 = int(row0)
    if row0 < 0:
        row0 += n
    return min(max(row0, 0), n - rows)


def ssm_block_reference(sees, member_table, stake, cols, row0, *, rows,
                        tot_stake):
    """Plain version: per member one (rows, K) @ (K, C) float32 hop (TF32
    off) thresholded at 0.5, an int32 stake tally, the strict-2/3 test."""
    n = sees.shape[0]
    n_members, k = member_table.shape
    row0 = _block_row0(row0, rows, n)
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
    ``(C,)`` with -1 meaning invalid, ``stake`` int32 ``(M,)``.  Returns bool
    ``(rows, C)``."""
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
    row0 = _block_row0(row0, rows, n)
    if _on_cpu(sees, member_table, stake, cols):
        return ssm_block_reference(
            sees, member_table, stake, cols, row0, rows=rows,
            tot_stake=tot_stake,
        )
    launch = _c_function("ssm_block", "ssm_block_launch")
    nw = (k + 31) // 32
    dev = sees.device
    with torch.cuda.device(dev):
        a_bits = torch.empty((rows, n_members, nw), dtype=torch.int32, device=dev)
        b_bits = torch.empty((c, n_members, nw), dtype=torch.int32, device=dev)
        out = torch.empty((rows, c), dtype=torch.bool, device=dev)
        err = launch(
            sees.data_ptr(), n, member_table.data_ptr(), n_members, k,
            stake.data_ptr(), cols.data_ptr(), c, row0, rows, int(tot_stake),
            a_bits.data_ptr(), b_bits.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "ssm_block")
    ssm_block.launches += 1
    return out


ssm_block.launches = 0
