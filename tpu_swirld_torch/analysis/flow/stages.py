"""Stage catalog: every stage body of the port run at envelope shapes (the
port's counterpart of the reference's ``tpu_swirld/analysis/flow/
stages.py``).

Each :class:`StageSpec` names one stage of the consensus core (the
``obs.stage_call`` name the drivers dispatch it under) and knows how to
build the call the interpreter runs at a :class:`~tpu_swirld_torch.
analysis.flow.envelope.ScaleEnvelope`'s shapes: the port's real stage
function, its tensor arguments as :class:`~tpu_swirld_torch.analysis.flow.
interpret.ArgDecl` (shape, dtype and the *declared input interval*, the
driver-guaranteed bound the interpreter starts from), its host arguments
(parents, starts, counts) and the host pulls its body may make:

======================  ====================================================
input                   declared interval (driver invariant)
======================  ====================================================
``parents``             ``[-1, N-1]`` — packed parent ids, -1 = genesis
``creator``             ``[0, M-1]`` — packer-validated member index
``stake``               ``[0, stake_max]`` — config-declared per-member cap
``member_table``        ``[-1, N-1]`` — -1 pads unused fork-tip slots
``fork_pairs``          ``[-1, N-1]`` — padded accusation rows
``coin``                ``[0, 1]`` — signature coin *bit* (uint8)
``t_rank``              ``[0, N-1]`` — dense rank of the int64 timestamps
``wit_table``           ``[-1, N-1]`` — -1 = empty witness slot
``wit_count``           ``[0, s_cap]``
``famous``              ``[-1, 1]`` — int8 tri-state
``col_pos`` / ``cols``  ``[-1, C-1]`` / ``[-1, N-1]`` — -1 = no column
``rnd`` / ``max_round`` ``[0, N-1]`` — a round index never exceeds the
                        event count (each round needs a fresh witness)
======================  ====================================================

Host arguments take the values that reach the most code: the rounds
stages' host parents are a self-chain with a genesis first (the
non-genesis branch at every interior index, the padding branch past
``n_valid``), block starts are the window's last, a block loop covers
the whole window.

Window-engine specs use the window extent ``W = env.rows`` in place of
``N`` for window-local ids while *round numbers stay absolute* (bounded
by ``N``).  Mesh specs build ``make_mesh(env.mesh_devices)``: the port's
shards all live on one device, so the envelope's mesh is the mesh run.

**The kernel seams.**  The stage bodies reach the hand-written CUDA
kernels only through the wrappers of :mod:`tpu_swirld_torch.gpu.kernels`
(``bmm_or``, ``ssm_block``, ``ssm_matrix``, ``ssm_tally``).  On the CPU
fake tensors the interpreter runs on, each wrapper takes its plain
version (``_on_cpu``), so the audit proves the plain version's arithmetic:
the kernel's contract, an int32 stake tally under
``check_stake_envelope``.  This is not a fallback: ``chip_smoke.py``'s
phase 18 holds the card's kernels to the same contract, their outputs
inside the intervals this audit computes and their tallies inside
``[0, tot_stake]``.

The catalog is keyed twice: by unique ``spec_id`` for the audit report,
and by ``stage_name`` for the engine-coverage check — a small observed
run of each engine (:func:`observed_stage_names`, the same
``obs.set_stage_observer`` seam as ``jit_audit.runtime_audit``) must find
every dispatched stage name covered by at least one spec, so a new stage
cannot silently escape the audit.  Two stage names differ from the
reference's catalog, by design: the reference's a-side gather pair
(``pipeline.ssm_gather_rows``, ``pipeline.ssm_block_from_rows``) has no
counterpart in the port, and the reference's full-path
``pipeline.rounds_stage`` is the port's ``pipeline.ssm_matrix_stage`` +
``pipeline.rounds_scan_stage`` (:data:`REFERENCE_DIFFERENCES`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_swirld_torch.analysis.flow.envelope import (
    INT32_MAX,
    ScaleEnvelope,
    get_envelope,
)
from tpu_swirld_torch.analysis.flow.interpret import (
    ArgDecl,
    FlowResult,
    PullDecl,
    interpret_stage,
)

_BOOL = torch.bool
_I32 = torch.int32
_I8 = torch.int8
_U8 = torch.uint8


def _arr(shape, dtype=_I32, lo=None, hi=None):
    return ArgDecl(tuple(shape), dtype, lo, hi)


def _mask(shape):
    return ArgDecl(tuple(shape), _BOOL, 0, 1)


def host_parents(n: int) -> np.ndarray:
    """Host parents of ``n`` events for the rounds stages: a self-chain
    with a genesis first, so every interior event takes the non-genesis
    branch (the only one with device arithmetic of its own)."""
    i = np.arange(n, dtype=np.int64)
    par = np.stack([i - 1, np.maximum(i - 2, 0)], axis=1).astype(np.int32)
    par[0] = -1
    return par


# --------------------------------------------------------------- pulls

#: every host pull a stage body makes, with the value the audit assumes
PULLS: Dict[str, PullDecl] = {
    d.site: d for d in (
        PullDecl(
            "gpu/pipeline.py:order_scan:go",
            "every round receives (the arm with the most device work)",
            lambda t, dims: np.ones(tuple(t.shape), dtype=bool),
        ),
        PullDecl(
            "gpu/pipeline.py:order_scan:nv_all",
            "one unique famous witness a round (the median row is a host "
            "index clamped to the slots: its value moves no interval)",
            lambda t, dims: np.ones(tuple(t.shape), dtype=np.int64),
        ),
        PullDecl(
            "gpu/pipeline.py:rounds_body:parents",
            "the host parents: a self-chain, genesis first",
            lambda t, dims: host_parents(int(t.shape[0])),
        ),
        PullDecl(
            "gpu/pipeline.py:_used_slots:wit_count[:r_max]",
            "every witness slot used (the widest fame and order)",
            lambda t, dims: np.full(tuple(t.shape), dims["S"], dtype=np.int32),
        ),
        PullDecl(
            "gpu/incremental.py:_used_slots",
            "every witness slot used (the widest fame and order)",
            lambda t, dims: int(t.shape[1]),
        ),
    )
}

_ORDER_PULLS = ("gpu/pipeline.py:order_scan:go", "gpu/pipeline.py:order_scan:nv_all")


@dataclasses.dataclass(frozen=True)
class StageCall:
    """What one spec runs: ``fn(*args, **kwargs)`` with its declared pulls
    and the dimensions their values read."""

    fn: Callable
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    pulls: Tuple[str, ...] = ()
    dims: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One auditable stage."""

    spec_id: str                 # unique catalog key ("batch.rounds_chunk")
    stage_name: str              # obs.stage_call name this spec covers
    engines: Tuple[str, ...]     # engines that dispatch it
    build: Callable              # env -> StageCall


def run_spec(spec: StageSpec, env: ScaleEnvelope, *, findings=None,
             exercised=None) -> FlowResult:
    """Interpret one spec at the envelope."""
    call = spec.build(env)
    return interpret_stage(
        call.fn, call.args, call.kwargs, stage=spec.spec_id,
        sentinels=env.sentinels,
        pulls={k: PULLS[k] for k in call.pulls},
        dims=call.dims, findings=findings, exercised=exercised,
    )


# --------------------------------------------------------------------------
# shared shape/interval vocabulary


def _dims(env: ScaleEnvelope):
    """Envelope dimensions as used by the specs (window extents never
    exceed the event count)."""
    N = env.events
    W = min(env.rows, N)
    C = min(env.wcols, N)
    return dict(
        N=N, W=W, C=C,
        M=env.members, K=env.k_cap, G=env.fork_groups,
        R=env.r_cap, S=env.s_cap,
        block=min(env.block, W), chunk=min(env.chunk, W),
        chain=env.chain_cap,
        tot=env.tot_stake, smax=env.stake_max,
    )


def _rows(n: int) -> int:
    return max(256, n // 2) if n >= 256 else n


# --------------------------------------------------------------------------
# batch engine (full-N shapes)


def _b_visibility(env):
    from tpu_swirld_torch.gpu import pipeline as P

    d = _dims(env)
    N, M, G = d["N"], d["M"], d["G"]
    return StageCall(
        P.visibility_stage,
        (_arr((N, 2), _I32, -1, N - 1),          # parents
         _arr((N,), _I32, 0, M - 1),             # creator
         _arr((G, 3), _I32, -1, N - 1)),         # fork_pairs
        dict(n_members=M, block=d["block"]),
    )


def _b_ancestry(env):
    from tpu_swirld_torch.gpu import pipeline as P

    d = _dims(env)
    N = d["N"]
    return StageCall(
        P.ancestry, (_arr((N, 2), _I32, -1, N - 1),), dict(block=d["block"]),
    )


def _ssm_block_call(fn, n, rows, c, m, k, d):
    return StageCall(
        fn,
        (_mask((n, n)),                          # sees
         _arr((m, k), _I32, -1, n - 1),          # member_table
         _arr((m,), _I32, 0, d["smax"]),         # stake
         _arr((c,), _I32, -1, n - 1),            # cols
         n - rows),                              # row0 (host: the last block)
        dict(rows=rows, tot_stake=d["tot"]),
    )


def _b_ssm_block(env, k=None):
    from tpu_swirld_torch.gpu import kernels

    d = _dims(env)
    N = d["N"]
    return _ssm_block_call(kernels.ssm_block, N, _rows(N), d["C"], d["M"],
                           d["K"] if k is None else k, d)


def _b_ssm_matrix(env):
    from tpu_swirld_torch.gpu import pipeline as P

    d = _dims(env)
    N, M = d["N"], d["M"]
    return StageCall(
        P.ssm_matrix,
        (_mask((N, N)), _arr((M, d["K"]), _I32, -1, N - 1),
         _arr((M,), _I32, 0, d["smax"]), d["tot"]),
        {},
    )


def _rounds_chunk_args(parents_np, n, c, m, r, s, smax, n_valid, start,
                       r_hi):
    return (
        parents_np,                               # parents (host)
        _mask((n, c)),                            # ssm_c
        _arr((n,), _I32, -1, c - 1),              # col_pos
        _arr((n,), _I32, 0, m - 1),               # creator
        _arr((m,), _I32, 0, smax),                # stake
        n_valid,                                  # n_valid (host)
        _arr((n,), _I32, 0, r_hi),                # rnd (absolute rounds)
        _mask((n,)),                              # wits
        _arr((r, s), _I32, -1, n - 1),            # tab
        _arr((r,), _I32, 0, s),                   # cnt
        _arr((1,), _I32, 0, 3),                   # overflow bits
        start,                                    # start (host)
    )


def _b_rounds_chunk(env):
    from tpu_swirld_torch.gpu import pipeline as P

    d = _dims(env)
    N, C, M, R, S = d["N"], d["C"], d["M"], d["R"], d["S"]
    chunk = d["chunk"]
    return StageCall(
        P.rounds_chunk_stage,
        _rounds_chunk_args(host_parents(N), N, C, M, R, S, d["smax"], N - 1,
                           N - chunk, N - 1) + (0,),
        dict(tot_stake=d["tot"], r_max=R, s_max=S, has_forks=True,
             chunk=chunk),
    )


def _b_rounds_scan(env):
    from tpu_swirld_torch.gpu import pipeline as P

    d = _dims(env)
    N, M = d["N"], d["M"]
    return StageCall(
        P.rounds_scan_stage,
        (host_parents(N), _mask((N, N)), _arr((N,), _I32, 0, M - 1),
         _arr((M,), _I32, 0, d["smax"]), d["tot"], N - 1),
        dict(r_max=d["R"], s_max=d["S"], has_forks=True),
    )


def _b_fame_order_cols(env, has_forks=True):
    from tpu_swirld_torch.gpu import pipeline as P

    d = _dims(env)
    N, C, M, R, S = d["N"], d["C"], d["M"], d["R"], d["S"]
    return StageCall(
        P.fame_order_cols_stage,
        (_mask((N, N)),                           # anc
         _mask((N, N)),                           # sees
         _mask((N, C)),                           # ssm_c
         _arr((N,), _I32, -1, C - 1),             # col_pos
         _arr((R, S), _I32, -1, N - 1),           # wit_table
         _arr((R,), _I32, 0, S),                  # wit_count
         _arr((N,), _I32, 0, M - 1),              # creator
         _arr((N,), _U8, 0, 1),                   # coin
         _arr((M,), _I32, 0, d["smax"]),          # stake
         _arr((N,), _I32, -1, N - 1),             # self_parent
         _arr((N,), _I32, 0, N - 1),              # t_rank
         N - 1,                                   # max_round (host)
         N),                                      # n_valid (host)
        dict(tot_stake=d["tot"], coin_period=env.coin_period, r_max=R,
             s_max=S, chain=d["chain"], has_forks=has_forks),
        pulls=_ORDER_PULLS,
    )


def _b_fame_order(env):
    from tpu_swirld_torch.gpu import pipeline as P

    d = _dims(env)
    N, M, R, S = d["N"], d["M"], d["R"], d["S"]
    return StageCall(
        P.fame_order_body,
        (_mask((N, N)),                           # anc
         _mask((N, N)),                           # sees
         _mask((N, N)),                           # ssm (full matrix path)
         _arr((R, S), _I32, -1, N - 1),           # wit_table (used slots)
         _arr((R,), _I32, 0, S),                  # wit_count
         _arr((N,), _I32, 0, M - 1),              # creator
         _arr((N,), _U8, 0, 1),                   # coin
         _arr((M,), _I32, 0, d["smax"]),          # stake
         _arr((N,), _I32, -1, N - 1),             # self_parent
         _arr((N,), _I32, 0, N - 1),              # t_rank
         _arr((), _I32, 0, N - 1),                # max_round (a device scalar)
         N),                                      # n_valid (host)
        dict(tot_stake=d["tot"], coin_period=env.coin_period, r_max=R,
             s_max=S, chain=d["chain"], has_forks=True),
        pulls=_ORDER_PULLS,
    )


# --------------------------------------------------------------------------
# incremental / streaming engines (window shapes)


def _i_extend_vis(env):
    from tpu_swirld_torch.gpu import incremental as I
    from tpu_swirld_torch.gpu import kernels

    d = _dims(env)
    W = d["W"]
    return StageCall(
        I.extend_visibility_stage,
        (_mask((W, W)),                           # anc (updated in place)
         _arr((W, 2), _I32, -1, W - 1),           # parents (window-remapped)
         0, W // d["block"]),                     # b0, b1 (host: every block)
        dict(block=d["block"], bmm=kernels.bmm_or),
    )


def _i_extend_vis_forked(env):
    from tpu_swirld_torch.gpu import incremental as I
    from tpu_swirld_torch.gpu import kernels

    d = _dims(env)
    W, G, M = d["W"], d["G"], d["M"]
    rows = _rows(W)
    return StageCall(
        I.extend_visibility_forked_stage,
        (_mask((W, W)),                           # anc
         _mask((W, W)),                           # sees
         _arr((W, 2), _I32, -1, W - 1),           # parents
         _arr((G, 3), _I32, -1, W - 1),           # fork_pairs (remapped)
         _arr((W,), _I32, 0, M - 1),              # creator
         0, W // d["block"],                      # b0, b1
         W - rows),                               # row0
        dict(block=d["block"], rows=rows, n_members=M, bmm=kernels.bmm_or),
    )


def _i_sees_materialize(env):
    from tpu_swirld_torch.gpu import incremental as I

    W = _dims(env)["W"]
    return StageCall(I._copy_slab_stage, (_mask((W, W)),), {})


def _i_ssm_block(env, k=None):
    from tpu_swirld_torch.gpu import kernels

    d = _dims(env)
    W = d["W"]
    return _ssm_block_call(kernels.ssm_block, W, _rows(W), d["C"], d["M"],
                           d["K"] if k is None else k, d)


def _i_ssm_update(env):
    from tpu_swirld_torch.gpu import incremental as I

    d = _dims(env)
    W, C = d["W"], d["C"]
    rows, cb = _rows(W), min(256, C)
    return StageCall(
        I.update_block_stage,
        (_mask((W, C)),                           # ssm_c (updated in place)
         _mask((rows, cb)),                       # part
         W - rows, C - cb),                       # row0, col0 (host)
        {},
    )


def _i_rounds_chunk(env):
    from tpu_swirld_torch.gpu import pipeline as P

    d = _dims(env)
    W, C, M, R, S, N = d["W"], d["C"], d["M"], d["R"], d["S"], d["N"]
    chunk = d["chunk"]
    return StageCall(
        P.rounds_chunk_stage,
        _rounds_chunk_args(host_parents(W), W, C, M, R, S, d["smax"], W - 1,
                           W - chunk, N - 1) + (max(N - 1 - R, 0),),
        dict(tot_stake=d["tot"], r_max=R, s_max=S, has_forks=True,
             chunk=chunk),
    )


def _i_rounds_span(env):
    """Fused K-chunk rounds span: the ``rounds_chunk_stage`` contract over
    ``chunk * k_chunks`` events a call, at the widest fused trip count the
    default config runs (k = 8)."""
    from tpu_swirld_torch.gpu import incremental as I

    d = _dims(env)
    W, C, M, R, S, N = d["W"], d["C"], d["M"], d["R"], d["S"], d["N"]
    chunk = d["chunk"]
    k_chunks = min(8, max(1, W // chunk))
    return StageCall(
        I.rounds_span_stage,
        _rounds_chunk_args(host_parents(W), W, C, M, R, S, d["smax"], W - 1,
                           W - chunk * k_chunks, N - 1) + (max(N - 1 - R, 0),),
        dict(tot_stake=d["tot"], r_max=R, s_max=S, has_forks=True,
             chunk=chunk, k_chunks=k_chunks),
    )


def _i_fame(env):
    from tpu_swirld_torch.gpu import incremental as I

    d = _dims(env)
    W, C, M, R, S = d["W"], d["C"], d["M"], d["R"], d["S"]
    return StageCall(
        I.fame_window_stage,
        (_mask((W, W)),                           # sees
         _mask((W, C)),                           # ssm_c
         _arr((W,), _I32, -1, C - 1),             # col_pos
         _arr((R, S), _I32, -1, W - 1),           # wit_table
         _arr((W,), _I32, 0, M - 1),              # creator
         _arr((W,), _U8, 0, 1),                   # coin
         _arr((M,), _I32, 0, d["smax"])),         # stake
        dict(tot_stake=d["tot"], coin_period=env.coin_period, r_max=R,
             s_max=S, has_forks=True),
        pulls=("gpu/incremental.py:_used_slots",),
    )


def _i_order(env):
    from tpu_swirld_torch.gpu import incremental as I

    d = _dims(env)
    W, M, R, S, N = d["W"], d["M"], d["R"], d["S"], d["N"]
    return StageCall(
        I.order_window_stage,
        (_mask((W, W)),                           # anc
         _arr((R, S), _I32, -1, W - 1),           # wit_table
         _arr((R,), _I32, 0, S),                  # wit_count
         _arr((R * S,), _I8, -1, 1),              # famous
         _arr((W,), _I32, 0, M - 1),              # creator
         _arr((W,), _I32, -1, W - 1),             # self_parent
         _arr((W,), _I32, 0, N - 1),              # t_rank
         R,                                       # max_round_local (host)
         W,                                       # n_valid (host)
         _mask((W,))),                            # received0
        dict(r_max=R, s_max=S, chain=d["chain"]),
        pulls=("gpu/incremental.py:_used_slots",) + _ORDER_PULLS,
    )


def _i_compact_cols(env):
    from tpu_swirld_torch.gpu import incremental as I

    d = _dims(env)
    W, C = d["W"], d["C"]
    return StageCall(
        I.compact_cols_stage,
        (_mask((W, C)), _arr((C,), _I32, -1, C - 1)), {},
    )


def _i_prune(env):
    from tpu_swirld_torch.gpu import incremental as I

    d = _dims(env)
    W, C = d["W"], d["C"]
    return StageCall(
        I.prune_stage,
        (_mask((W, W)),                           # anc
         _mask((W, W)),                           # sees
         _mask((W, C)),                           # ssm_c
         W // 2,                                  # d (host: pruned count)
         W,                                       # n_used (host)
         _arr((C,), _I32, -1, C - 1)),            # keep_cols
        {},
    )


def _i_prune_noforks(env):
    from tpu_swirld_torch.gpu import incremental as I

    d = _dims(env)
    W, C = d["W"], d["C"]
    return StageCall(
        I.prune_noforks_stage,
        (_mask((W, W)), _mask((W, C)), W // 2, W,
         _arr((C,), _I32, -1, C - 1)),
        {},
    )


# --------------------------------------------------------------------------
# mesh engine (the port's row and member shards, all on one device)


def _mesh(env):
    from tpu_swirld_torch.parallel import make_mesh

    return make_mesh(env.mesh_devices, "cpu")


def _m_ssm_block_row(env, pallas=True):
    from tpu_swirld_torch.gpu import kernels
    from tpu_swirld_torch.parallel import make_row_sharded_block_fn

    d = _dims(env)
    mesh = _mesh(env)
    dev = mesh.size
    w = (d["W"] // dev) * dev or dev              # rows must split evenly
    fn = (kernels.make_mesh_row_block_fn(mesh) if pallas
          else make_row_sharded_block_fn(mesh))
    return _ssm_block_call(fn, w, _rows(w), d["C"], d["M"], d["K"], d)


def _m_ssm_block_member(env):
    from tpu_swirld_torch.parallel import make_ssm_block_fn_for_mesh

    d = _dims(env)
    W = d["W"]
    return _ssm_block_call(make_ssm_block_fn_for_mesh(_mesh(env)), W, _rows(W),
                           d["C"], d["M"], d["K"], d)


def _m_consensus(env):
    from tpu_swirld_torch.parallel import consensus_fn_for_mesh

    d = _dims(env)
    N, M, G = d["N"], d["M"], d["G"]
    mesh = _mesh(env)
    dev = mesh.size
    m = ((M + dev - 1) // dev) * dev              # pad_members contract
    return StageCall(
        consensus_fn_for_mesh(mesh),
        (_arr((N, 2), _I32, -1, N - 1),           # parents
         _arr((N,), _I32, 0, M - 1),              # creator
         _arr((N,), _I32, 0, N - 1),              # t_rank
         _arr((N,), _U8, 0, 1),                   # coin
         _arr((m,), _I32, 0, d["smax"]),          # stake (padded)
         _arr((G, 3), _I32, -1, N - 1),           # fork_pairs
         _arr((m, d["K"]), _I32, -1, N - 1),      # member_table (padded)
         N - 1),                                  # n_valid (host)
        dict(tot_stake=d["tot"], coin_period=env.coin_period,
             block=d["block"], r_max=d["R"], s_max=d["S"],
             chain=d["chain"], has_forks=True),
        pulls=("gpu/pipeline.py:rounds_body:parents",
               "gpu/pipeline.py:_used_slots:wit_count[:r_max]") + _ORDER_PULLS,
        dims=d,
    )


# --------------------------------------------------------------------------
# dynamic membership (epoch-boundary member-axis repack)


def _mb_repack(env):
    """The :func:`tpu_swirld_torch.membership.repack.repack_stage` boundary
    at its worst case: one joiner extends the member axis M -> M+1, and the
    member table is as tall as a single creator could make it (K = N — one
    member authored every event)."""
    from tpu_swirld_torch.membership import repack as MR

    d = _dims(env)
    N, M = d["N"], d["M"]
    return StageCall(
        MR.repack_stage,
        (_arr((M, N), _I32, -1, N - 1),           # member_table
         _arr((M + 1,), _I32, 0, d["smax"])),     # stake_new
        dict(n_members_new=M + 1),
    )


# --------------------------------------------------------------------------
# catalog


_INC = ("incremental", "streaming", "mesh")

CATALOG: List[StageSpec] = [
    # batch: the columns path
    StageSpec("batch.visibility", "pipeline.visibility_stage",
              ("batch",), _b_visibility),
    StageSpec("batch.ancestry", "pipeline.visibility_stage",
              ("batch",), _b_ancestry),
    StageSpec("batch.ssm_block", "pipeline.ssm_block_stage",
              ("batch",), _b_ssm_block),
    StageSpec("batch.ssm_block_gemm", "pipeline.ssm_block_stage",
              ("batch",), functools.partial(_b_ssm_block, k=1)),
    StageSpec("batch.rounds_chunk", "pipeline.rounds_chunk_stage",
              ("batch",), _b_rounds_chunk),
    StageSpec("batch.fame_order_cols", "pipeline.fame_order_cols_stage",
              ("batch",), _b_fame_order_cols),
    StageSpec("batch.fame_order_cols_noforks", "pipeline.fame_order_cols_stage",
              ("batch",), functools.partial(_b_fame_order_cols, has_forks=False)),
    # batch: the full-matrix path
    StageSpec("batch.ssm_matrix", "pipeline.ssm_matrix_stage",
              ("batch",), _b_ssm_matrix),
    StageSpec("batch.rounds", "pipeline.rounds_scan_stage",
              ("batch",), _b_rounds_scan),
    StageSpec("batch.fame_order", "pipeline.fame_order_stage",
              ("batch",), _b_fame_order),
    # incremental / streaming windows
    StageSpec("inc.extend_vis", "pipeline.inc_extend_vis",
              _INC, _i_extend_vis),
    StageSpec("inc.extend_vis_forked", "pipeline.inc_extend_vis",
              _INC, _i_extend_vis_forked),
    StageSpec("inc.sees_materialize", "pipeline.sees_materialize",
              _INC, _i_sees_materialize),
    StageSpec("inc.ssm_block", "pipeline.ssm_block_stage",
              _INC, _i_ssm_block),
    StageSpec("inc.ssm_block_gemm", "pipeline.ssm_block_stage",
              _INC, functools.partial(_i_ssm_block, k=1)),
    StageSpec("inc.ssm_update", "pipeline.inc_ssm_update",
              _INC, _i_ssm_update),
    StageSpec("inc.rounds_chunk", "pipeline.rounds_chunk_stage",
              _INC, _i_rounds_chunk),
    StageSpec("inc.rounds_span", "pipeline.rounds_span_stage",
              _INC, _i_rounds_span),
    StageSpec("inc.fame", "pipeline.inc_fame", _INC, _i_fame),
    StageSpec("inc.order", "pipeline.inc_order", _INC, _i_order),
    StageSpec("inc.compact_cols", "pipeline.inc_compact_cols",
              _INC, _i_compact_cols),
    StageSpec("inc.prune", "pipeline.inc_prune", _INC, _i_prune),
    StageSpec("inc.prune_noforks", "pipeline.inc_prune",
              _INC, _i_prune_noforks),
    # dynamic membership: every device engine repacks at epoch boundaries
    StageSpec("membership.repack", "membership.repack_stage",
              ("batch",) + _INC, _mb_repack),
    # mesh blocks and the member-sharded batch pass
    StageSpec("mesh.ssm_block_row", "pipeline.ssm_block_mesh",
              ("mesh",), _m_ssm_block_row),
    StageSpec("mesh.ssm_block_row_hop", "pipeline.ssm_block_mesh",
              ("mesh",), functools.partial(_m_ssm_block_row, pallas=False)),
    StageSpec("mesh.ssm_block_member", "pipeline.ssm_block_stage",
              ("mesh",), _m_ssm_block_member),
    StageSpec("mesh.consensus", "pipeline.mesh_consensus",
              ("batch", "mesh"), _m_consensus),
]

ENGINES = ("batch", "incremental", "streaming", "mesh")

#: the reference catalog's stage names the port lacks -> the port's names
#: that stand for them (the only differences between the two catalogs)
REFERENCE_DIFFERENCES = {
    ("pipeline.ssm_gather_rows", "pipeline.ssm_block_from_rows"): (),
    ("pipeline.rounds_stage",): ("pipeline.ssm_matrix_stage",
                                 "pipeline.rounds_scan_stage"),
}


def specs_for_engines(engines: Sequence[str]) -> List[StageSpec]:
    eng = set(engines)
    return [s for s in CATALOG if eng & set(s.engines)]


def coverage_map() -> Dict[str, List[str]]:
    """stage_call name -> spec ids that audit it."""
    out: Dict[str, List[str]] = {}
    for s in CATALOG:
        out.setdefault(s.stage_name, []).append(s.spec_id)
    return out


def declared_pulls(stage_name: str) -> Dict[str, PullDecl]:
    """The pulls the catalog's specs of one stage declare."""
    out: Dict[str, PullDecl] = {}
    for s in CATALOG:
        if s.stage_name == stage_name:
            for k in s.build(get_envelope("baseline")).pulls:
                out[k] = PULLS[k]
    return out


# --------------------------------------------------------------------------
# engine observation (the jit_audit seam): which stage names does each
# engine actually dispatch?  Every observed name must be in the catalog.


def observed_stage_names(
    engine: str,
    *,
    device="cuda",
    n_members: int = 6,
    n_events: int = 420,
    seed: int = 3,
    collect: Optional[Callable] = None,
) -> List[str]:
    """Run a small real workload of ``engine`` on ``device`` with the stage
    observer installed and return the sorted stage names it dispatched.

    The reference's workload: one forker, the windowed drivers at chunk
    64, window bucket 256, prune_min 64, fed 140 events an ingest.
    ``batch`` runs both batch paths (the columns default and
    ``ssm_mode="full"``, so ``ssm_matrix`` is held too); ``mesh`` is
    ``MeshStreamingConsensus(make_mesh(8, device), pallas=True)``, so its
    blocks run ``ssm_tally``.  ``collect(name, fn, args, kw)``, when given,
    additionally receives every observed call (the soundness property
    replays them through the interpreter)."""
    from tpu_swirld_torch import obs as obslib
    from tpu_swirld_torch.config import SwirldConfig
    from tpu_swirld_torch.sim import generate_gossip_dag

    members, stake, events, _ = generate_gossip_dag(
        n_members, n_events, seed=seed, n_forkers=1
    )
    cfg = SwirldConfig(n_members=n_members)
    names: set = set()

    def observer(name, fn, args, kw):
        names.add(name)
        if collect is not None:
            collect(name, fn, args, kw)

    kw = dict(chunk=64, window_bucket=256, prune_min=64, device=device)
    obslib.set_stage_observer(observer)
    drv = None
    try:
        if engine == "batch":
            from tpu_swirld_torch.gpu.pipeline import run_consensus
            from tpu_swirld_torch.packing import Packer

            pk = Packer(members, stake)
            pk.extend(events)
            packed = pk.pack()
            for mode in ("columns", "full"):
                run_consensus(packed, cfg, block=64, ssm_mode=mode, device=device)
        else:
            if engine == "incremental":
                from tpu_swirld_torch.gpu.incremental import IncrementalConsensus

                drv = IncrementalConsensus(members, stake, cfg, **kw)
            elif engine == "streaming":
                from tpu_swirld_torch.store.streaming import StreamingConsensus

                drv = StreamingConsensus(members, stake, cfg, **kw)
            elif engine == "mesh":
                from tpu_swirld_torch.parallel import (
                    MeshStreamingConsensus, make_mesh,
                )

                drv = MeshStreamingConsensus(
                    make_mesh(8, device), members, stake, cfg,
                    pallas=True, **kw,
                )
            else:
                raise ValueError(f"unknown engine {engine!r}")
            for i in range(0, len(events), 140):
                drv.ingest(events[i:i + 140])
    finally:
        obslib.set_stage_observer(None)
        store = getattr(drv, "store", None)
        if store is not None:
            store.close()
    return sorted(names)


def concrete_decl(a):
    """A concrete stage argument as the interpreter takes it: a tensor
    becomes an :class:`ArgDecl` at its own shape, dtype and value range
    (a CPU fake: the wrappers take their plain versions); anything else
    is passed as it is."""
    if not isinstance(a, torch.Tensor):
        return a
    if a.numel() == 0:
        return ArgDecl(tuple(a.shape), a.dtype)
    x = a.detach()
    if x.dtype.is_floating_point:
        return ArgDecl(tuple(a.shape), a.dtype, float(x.min()), float(x.max()))
    x = x.to(torch.int64)
    return ArgDecl(tuple(a.shape), a.dtype, int(x.min()), int(x.max()))


def _closure_mesh(fn):
    """The ``Mesh`` a mesh stage function is bound to (None for any other
    function)."""
    from tpu_swirld_torch.parallel import Mesh

    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if isinstance(f, Mesh):
            return f
        if id(f) in seen:
            continue
        seen.add(id(f))
        if isinstance(f, functools.partial):
            todo += [f.func, *f.args, *f.keywords.values()]
            continue
        for cell in getattr(f, "__closure__", None) or ():
            v = cell.cell_contents
            if isinstance(v, Mesh) or callable(v):
                todo.append(v)
    return None


def cpu_twin(fn):
    """``fn`` itself, or, for a stage function bound to a mesh on the card,
    the same factory's function over a CPU mesh of as many shards: the
    interpreter runs stage bodies on CPU fake tensors, where a card mesh
    refuses them."""
    mesh = _closure_mesh(fn)
    if mesh is None or mesh.device.type == "cpu":
        return fn
    from tpu_swirld_torch import parallel
    from tpu_swirld_torch.gpu import kernels

    cpu = parallel.make_mesh(mesh.size, "cpu")
    name = getattr(fn, "__qualname__", "")
    for prefix, factory in (
        ("make_mesh_row_block_fn.", kernels.make_mesh_row_block_fn),
        ("_row_sharded_block_fn.", parallel.make_row_sharded_block_fn),
        ("make_ssm_block_fn_for_mesh.", parallel.make_ssm_block_fn_for_mesh),
    ):
        if name.startswith(prefix):
            return factory(cpu)
    if isinstance(fn, functools.partial) and fn.func.__name__ == "consensus_body":
        return parallel.consensus_fn_for_mesh(cpu)
    raise ValueError(f"no CPU twin for the mesh stage function {name or fn!r}")


def trace_concrete_call(fn, args, kw, *, stage: str = "<stage>",
                        sentinels=(INT32_MAX,)) -> FlowResult:
    """Interpret one *observed* stage call at its concrete arguments'
    intervals (the soundness property's abstract side), with the pulls its
    stage's specs declare.  A mesh stage runs as its :func:`cpu_twin`."""
    return interpret_stage(
        cpu_twin(fn), [concrete_decl(a) for a in args],
        {k: concrete_decl(v) for k, v in kw.items()},
        stage=stage, sentinels=sentinels, pulls=declared_pulls(stage),
    )
