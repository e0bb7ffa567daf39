#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

1. Environment: the card's name and power limit, torch and CUDA versions.
2. Build: compiles every CUDA kernel of the main path from ``tpu_swirld_torch/
   gpu/csrc`` (one ``nvcc`` per source, all started together) and times it.
3. Kernel vs plain version on the card, exact equality: ``bmm_or`` at the
   ancestry and forkseen shapes, the incremental forked-extension hop (1024 x
   G_cap @ G_cap x 64) and a ragged one, ``ssm_block`` (non-uniform stake)
   on the sees slabs of the BASELINE config-4 and config-3 DAGs at the
   column-add shapes and the incremental extension block (1024 rows
   mid-window x 256 and 1024 columns), ``ssm_matrix`` on the full config-4
   slab (non-uniform stake), the full config-3 slab and a ragged N; both
   strongly-sees kernels also at stakes summing to ``INT32_MAX // 3`` (the
   envelope's edge) and on small random shapes (K past 256 and past the
   k-steps a member that shared memory holds at once, member tables too
   long for shared memory, ragged rows and columns, -1 slots, cols and
   indices past n, clamped starts).  A compared
   output that is all False or all True fails (a one-output case excepted):
   it could not tell a wrong kernel.  Each fixed shape is timed (median of
   CUDA-event timings after a warm-up) beside its plain version, its least
   time on the card (bound) and, for ``bmm_or``, one library call, with
   ``host_us`` (the host microseconds a call over 200 calls enqueued with no
   synchronize: the wrapper's cost) and ``card_ms`` (a CUDA-graph replay of
   one call: the card's time alone; ``ms`` brackets one call and holds
   both).  A bound counts the work this run's data needs (member-table
   slots that are -1 and padded columns need none): the larger of its
   bytes over the memory rate and its AND-products over the card's peak for
   1-bit products, the binary tensor cores' ``.b1`` AND-popc rate (an
   AND-product two operations, ``B1_OPS_PER_S``); ``ssm_block`` and
   ``ssm_matrix`` also print the operations bound at the data sheet's int8
   rate (``ops_bound_int8_ms``).
4. Both batch paths on BASELINE configs 3 and 4 (64 members, 10 000 events,
   0 and 21 forkers): the port's gossip DAG through ``run_consensus(
   device="cuda")`` with the default column-restricted strongly-sees
   (a warm-up run, then a measured one), with ``ssm_mode="full"`` (a warm-up,
   then a measured one) and with ``use_pallas_ssm=True`` (measured).  For
   each measured run: events/s, per-stage seconds and calls, and the kernel
   launch counts of that run (every kernel of the path > 0, the other
   strongly-sees kernel 0); the SHA-256 digests of its order, rounds, fame
   and round-received are held against golden digests computed from the JAX
   reference on the same DAG.
5. The incremental driver on configs 3 and 4: ``IncrementalConsensus(device=
   "cuda")`` with the reference defaults (block 128, chunk 256, window bucket
   1024, ``fuse_chunks`` 8) ingests the DAG in 10 chunks of 1000 events, and
   config 3 once more with ``fuse_chunks=1`` (the per-chunk rounds loop).
   Per pass: seconds, rebased, window, pruned prefix, rounds-scan probes and
   steps, stage seconds and calls, kernel launches.  Each run's ``result()``
   digests must be golden, its per-pass ``ordered`` lists must concatenate to
   its order, at least one pass must not rebase, and over the non-rebase
   passes ``bmm_or`` and ``ssm_block`` must launch and ``ssm_matrix`` not.
   Steady events/s over the back half of the passes (as ``bench.py``
   computes it) beside the same call's warm columns pass.
6. The streaming driver on configs 3 and 4: ``StreamingConsensus(device=
   "cuda")`` with the reference defaults (``ingest_chunk`` 1024, tile 256, no
   budget) over the same 10 chunks.  Per pass as in 5, plus the archived
   rows, resident bytes, overlap ratio and widen / full rebases.  Digests
   golden, per-pass ``ordered`` lists concatenating to the order, ``bmm_or``
   and ``ssm_block`` launched on the non-rebase passes, ``ssm_matrix`` not.
7. Widening on config 3: after 6, the stale-view event of
   ``tests/test_store.py`` (member 3's head with other-parent
   ``events[100]``, long pruned) must be answered by a widening rebase
   (``widen_rebases`` + 1, ``full_rebases`` unchanged, archived rows
   fetched), with ``result()`` digests equal to ``run_consensus(device=
   "cuda")`` over the same history.  Prints the widen's seconds.
8. The row-sharded mesh driver on configs 3 and 4:
   ``MeshStreamingConsensus(make_mesh(2), pallas=True, device="cuda")`` (2
   row shards on one card) over the same chunks.  Digests golden; the
   archive's digest equal to the streaming driver's (6 and 8 print the
   store's stats after draining its pack worker); ``ssm_block`` and
   ``ssm_matrix`` 0 launches; ``bmm_or``, the mesh block and ``ssm_tally``
   launched on the non-rebase passes; ``bmm_or`` launched exactly as often
   as in the streaming run of 6 (the blocks run no member hop), and
   ``ssm_tally`` at most ``MESH_SHARDS`` times a mesh block.
9. ``make_mesh_row_block_fn`` at 2 and 4 shards on the config-3 slab, at the
   extension shape (1024 rows at row 4096 x 256 columns) and the column-add
   shape (full height x 64), exact against ``ssm_block`` and its plain
   version and non-degenerate, timed beside ``ssm_block``; ``ssm_tally``
   alone at one shard's extension shape (shard 0 of 2, which owns 960 of
   the 1024 rows), exact against ``ssm_tally_reference``, the two shards'
   summed threshold non-degenerate and equal to ``ssm_block``'s, with
   ``host_us`` and ``card_ms`` as for ``bmm_or``; a member
   hop ``bmm_or`` at (1024 x K) @ (K x 256) timed beside ``torch.matmul``.
10. A ``{"kernels": [...]}`` line (all five routes, every kernel's launches
   by path: batch paths, incremental, streaming, widen, mesh), the card's
   name and power limit, then ``{"ok": true, ...}`` as the last line.

Exits nonzero, printing no result, when no CUDA device is present or any
phase fails.
"""

from __future__ import annotations

import hashlib
import json
import struct
import subprocess
import sys
import time

import numpy as np
import torch

from tpu_swirld_torch import (
    IncrementalConsensus, MeshStreamingConsensus, StreamingConsensus, make_mesh,
)
from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.event import Event
from tpu_swirld_torch.gpu import build, kernels
from tpu_swirld_torch.gpu.pipeline import run_consensus, visibility_stage
from tpu_swirld_torch.packing import pack_events
from tpu_swirld_torch.sim import generate_gossip_dag

N_MEMBERS = 64
N_EVENTS = 10_000
SEED = 1
CONFIGS = {"config3": 0, "config4": 21}      # name -> forkers
INC_CHUNK = 1000                             # bench.py's BENCH_INC_CHUNK
# incremental run label -> (config, fuse_chunks; None = the default, 8)
INC_RUNS = {
    "config3": ("config3", None),
    "config4": ("config4", None),
    "config3 fuse_chunks=1": ("config3", 1),
}
# path -> (run_consensus kwargs, warm-up run first, kernels it must launch,
#          kernels it must not launch)
PATHS = {
    "columns": ({}, True, ("bmm_or", "ssm_block"), ("ssm_matrix",)),
    "full": ({"ssm_mode": "full"}, True, ("bmm_or", "ssm_matrix"), ("ssm_block",)),
    "pallas": ({"use_pallas_ssm": True}, False, ("bmm_or", "ssm_matrix"), ("ssm_block",)),
}

# Digests of the JAX reference (tpu_swirld.tpu.pipeline.run_consensus on the
# CPU, sim signer, s_max=65 grown by its overflow self-heal) on
# generate_gossip_dag(64, 10000, seed=1[, n_forkers=21]); recomputed by
# tests/test_torch_host.py::test_golden_digests_match_reference.
GOLDEN = {
    "config3": {
        "order": "f2606b6e80cf299344a0a7cee2c94fcee2810edcc24cb41a03cc5c9cfc3aad51",
        "round": "2091ec224244a9b85e075e760a1b5442ae1994eab06b915afaf6f8c61ce959f1",
        "famous": "71f52581595ad71a23f15dc477da8293cdca6e1abea9f3cf8b3f326836c80393",
        "round_received": "2d310e6633cbfc3f6b7c2493d8864f6e40237e053ccb4d17a0032f37cc439c63",
    },
    "config4": {
        "order": "3a1be7bb7e96824591f6f4f106e65a13b76ad578fb04d3afec36291612c8df8e",
        "round": "11d03570edf1614c1e19f73e82f451ac7a3a29e077b9f2211353daf81b39efd6",
        "famous": "a34b6d93e65b3443eeb07539e5d86b5c2d355ac9e370701eb17b0b645f237911",
        "round_received": "60bf6c63a442090204892fdbb12851c63d265171a98d47032f95b3924ef56019",
    },
}

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
# dense int8 tensor-core peak, same source; it counts a multiply-add as two
# operations, so one AND-product (a 0/1 multiply-add) costs two
INT8_OPS_PER_S = 1979e12
OPS_PER_AND = 2
# The card's peak for 1-bit AND-products, which the data sheet does not
# give: mma.sync m16n8k256 .b1 AND-popc from registers on every SM, two
# operations an AND-product, measured by tpu_swirld_torch/dev/mma_rate.py
# (the highest reading, NVIDIA H100 80GB HBM3 at a 700 W power limit; see
# PERF.md).  The strongly-sees kernels run their products at this rate.
B1_OPS_PER_S = 1.0035e16
KERNEL_INFO = {
    "bmm_or": {
        "source": "tpu_swirld_torch/gpu/csrc/bmm_or.cu",
        "replaces": "tpu_swirld/tpu/pallas_kernels.py:313",
    },
    "ssm_block": {
        "source": "tpu_swirld_torch/gpu/csrc/ssm_block.cu",
        "replaces": "tpu_swirld/tpu/pallas_kernels.py:206",
    },
    "ssm_matrix": {
        "source": "tpu_swirld_torch/gpu/csrc/ssm_matrix.cu",
        "replaces": "tpu_swirld/tpu/pallas_kernels.py:106",
    },
    # the row-sharded block over the ssm_tally kernel; its launches count
    # blocks, each at most D ssm_tally launches
    "make_mesh_row_block_fn": {
        "source": "tpu_swirld_torch/gpu/kernels.py",
        "replaces": "tpu_swirld/tpu/pallas_kernels.py:368",
    },
    # one shard's tally: the member hops (bmm_or_pallas) of the route above
    "ssm_tally": {
        "source": "tpu_swirld_torch/gpu/csrc/ssm_tally.cu",
        "replaces": "tpu_swirld/tpu/pallas_kernels.py:380",
    },
}
MESH_SHARDS = 2
STALE_OTHER_PARENT = 100        # tests/test_store.py's long-pruned events[100]
KERNELS = {name: getattr(kernels, name) for name in KERNEL_INFO}


def result_digests(packed, result) -> dict:
    """SHA-256 digests of a consensus result: the order (concatenated event
    ids), ``round`` and ``round_received`` (little-endian int32) and
    ``famous`` (sorted (event index, fame) items, fame -1 when undecided)."""
    def h(b: bytes) -> str:
        return hashlib.sha256(b).hexdigest()

    fam = b"".join(
        struct.pack("<ib", k, -1 if v is None else int(v))
        for k, v in sorted(result.famous.items())
    )
    return {
        "order": h(b"".join(packed.ids[i] for i in result.order)),
        "round": h(np.asarray(result.round, "<i4").tobytes()),
        "famous": h(fam),
        "round_received": h(np.asarray(result.round_received, "<i4").tobytes()),
    }


def make_dag(n_forkers: int):
    """``(members, stake, events, packed, keys)`` of one configuration."""
    members, stake, events, keys = generate_gossip_dag(
        N_MEMBERS, N_EVENTS, seed=SEED, n_forkers=n_forkers
    )
    return members, stake, events, pack_events(events, members, stake), keys


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn`` over ``calls`` calls enqueued with
    no synchronize between them (then one synchronize, not timed)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def card_ms(fn, reps: int = 50) -> float:
    """Milliseconds of ``fn`` on the card alone: one call captured into a
    CUDA graph, the graph replayed ``reps`` times between two events, so no
    host work lies between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, and_products: float):
    """The least time of a kernel that moves ``nbytes`` and does
    ``and_products`` AND-products: bytes over the memory rate or operations
    over the card's 1-bit peak, whichever is larger, and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ms(and_products)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ops_ms(and_products: float, ops_per_s: float = B1_OPS_PER_S) -> float:
    return OPS_PER_AND * and_products / ops_per_s * 1e3


def random_bool(shape, density, gen):
    return torch.rand(shape, generator=gen, device="cuda") < density


def check_bmm_or(gen, g_cap, failures):
    """``g_cap``: config 4's fork pairs padded to the incremental driver's
    bucket of 8, the contraction of its forked-extension hop."""
    rows = []
    shapes = [(128, 128, 128), (128, 128, 10112), (10112, 4517, 64),
              (1024, g_cap, 64), (100, 37, 70)]
    for p, q, r in shapes:
        # densities that leave about half of the outputs set
        dens = float(np.sqrt(0.69 / q))
        a = random_bool((p, q), dens, gen)
        b = random_bool((q, r), dens, gen)
        got = kernels.bmm_or(a, b)
        want = kernels.bmm_or_reference(a, b)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        if not torch.equal(got, want):
            failures.append(f"bmm_or {p}x{q}x{r}: kernel != plain version")
        reps = 10 if p * q * r > 1e9 else 50
        ms = time_ms(lambda: kernels.bmm_or(a, b), reps)
        us = host_us(lambda: kernels.bmm_or(a, b))
        card = card_ms(lambda: kernels.bmm_or(a, b), reps)
        plain_ms = time_ms(lambda: kernels.bmm_or_reference(a, b), reps)
        lib_ms = time_ms(
            lambda: torch.matmul(a.to(torch.bfloat16), b.to(torch.bfloat16)) > 0.5,
            reps,
        )
        bnd, by = bound_ms(p * q + q * r + p * r, p * q * r)
        row = {"shape": [p, q, r], "max_abs_err": err, "ms": ms, "host_us": us,
               "card_ms": card,
               "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bnd,
               "bound_by": by, "set_frac": float(want.float().mean())}
        print("bmm_or", json.dumps(row), flush=True)
        check_degenerate("bmm_or", f"{p}x{q}x{r}", row["set_frac"], failures)
        rows.append(row)
    return rows


def sees_slab(packed):
    """The sees slab of a packed DAG on the card, padded to the main path's
    block of 128 events."""
    n = packed.n
    n_pad = ((n + 127) // 128) * 128
    parents = np.full((n_pad, 2), -1, np.int32)
    parents[:n] = packed.parents
    creator = np.zeros((n_pad,), np.int32)
    creator[:n] = packed.creator
    dev = torch.device("cuda")
    _anc, sees = visibility_stage(
        torch.as_tensor(parents, device=dev), torch.as_tensor(creator, device=dev),
        torch.as_tensor(packed.fork_pairs, device=dev),
        n_members=N_MEMBERS, block=128,
    )
    return sees


def check_degenerate(kernel, label, set_frac, failures):
    """A compared output that is all False or all True cannot tell a wrong
    kernel (one that writes zeros, say) from a right one."""
    if set_frac in (0.0, 1.0):
        failures.append(f"{kernel} {label}: set fraction {set_frac}, the check cannot fail")


def check_ssm_block(packs, slabs, failures):
    """``ssm_block`` against its plain version with non-uniform stake.
    Config 4's forkseen slab gives few strongly-seen pairs outside its
    early rounds, so the cases in the late window run on config 3's."""
    rng = np.random.default_rng(SEED)
    stake_np = rng.integers(1, 6, N_MEMBERS).astype(np.int32)   # non-uniform
    tot = int(stake_np.sum())
    n = N_EVENTS
    n_pad = slabs["config3"].shape[0]

    def pick(lo, hi, c=64):     # c column events drawn from [lo, hi)
        return np.sort(rng.choice(np.arange(lo, hi), c, replace=False)).astype(np.int32)

    one = np.full(64, -1, np.int32)
    one[0] = n - 2000
    cases = [
        ("rows=10112,C=64", "config4", 0, n_pad, pick(0, n)),
        ("rows=256,C=64", "config3", n_pad - 256, 256, pick(n - 2000, n - 1000)),
        ("row0=4033,rows=96", "config4", 4033, 96, pick(2000, 3000)),
        ("one column padded to 64", "config3", n_pad - 512, 512, one),
        # the incremental extension block: one pass's 1024 new rows in the
        # middle of a window x the live witness columns, from the rounds
        # below the rows up into them
        ("extension rows=1024,C=256", "config3", 4096, 1024, pick(2048, 5120, 256)),
        ("extension rows=1024,C=1024", "config3", 4096, 1024, pick(1024, 5120, 1024)),
    ]
    rows_out = []
    for label, name, row0, rows, cols_np in cases:
        packed, sees = packs[name], slabs[name]
        dev = sees.device
        mt = torch.as_tensor(packed.member_table, device=dev)
        stake = torch.as_tensor(stake_np, device=dev)
        valid = int((packed.member_table >= 0).sum())
        n_members, k = packed.member_table.shape
        cols = torch.as_tensor(cols_np, device=dev)
        kw = dict(rows=rows, tot_stake=tot)
        got = kernels.ssm_block(sees, mt, stake, cols, row0, **kw)
        want = kernels.ssm_block_reference(sees, mt, stake, cols, row0, **kw)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        if not torch.equal(got, want):
            failures.append(f"ssm_block {label}: kernel != plain version")
        call = lambda: kernels.ssm_block(sees, mt, stake, cols, row0, **kw)  # noqa: E731
        ms = time_ms(call, 20)
        plain_ms = time_ms(
            lambda: kernels.ssm_block_reference(sees, mt, stake, cols, row0, **kw), 5
        )
        c = len(cols_np)
        c_valid = int((cols_np >= 0).sum())
        # each needed sees byte read once (a side: rows x valid member slots,
        # b side: valid slots x valid columns), the indices, the bool output
        nbytes = rows * valid + valid * c_valid + 4 * (n_members * k + c + n_members) + rows * c
        ands = rows * c_valid * valid
        bnd, by = bound_ms(nbytes, ands)
        row = {"case": label, "slab": name, "row0": row0, "rows": rows, "C": c,
               "max_abs_err": err, "ms": ms, "host_us": host_us(call),
               "card_ms": card_ms(call), "plain_ms": plain_ms,
               "bound_ms": bnd, "bound_by": by,
               "ops_bound_int8_ms": ops_ms(ands, INT8_OPS_PER_S),
               "set_frac": float(want.float().mean())}
        print("ssm_block", json.dumps(row), flush=True)
        check_degenerate("ssm_block", label, row["set_frac"], failures)
        rows_out.append(row)

    # the envelope's edge: stakes summing to INT32_MAX // 3, so 3 * acc
    # reaches 2^31 - 2 in the card's int32 tally
    edge = edge_stake(rng, N_MEMBERS)
    packed, sees = packs["config3"], slabs["config3"]
    mt = torch.as_tensor(packed.member_table, device=sees.device)
    cols = torch.as_tensor(pick(2048, 5120, 256), device=sees.device)
    kw = dict(rows=1024, tot_stake=int(edge.sum()))
    got = kernels.ssm_block(sees, mt, edge, cols, 4096, **kw)
    want = kernels.ssm_block_reference(sees, mt, edge, cols, 4096, **kw)
    compare("ssm_block", "envelope edge rows=1024,C=256", got, want, failures)

    return rows_out


def sweep_ssm_block(failures):
    """``ssm_block`` on small random shapes: K not a multiple of 32 and K >
    256, rows below one tile, C not a multiple of 64, -1 slots and cols,
    indices past n, clamped and negative row0, 8-row tiles (rows 1100 x C
    40), a member table whose packed rows are too long to stage (256
    members, K 300: the a side is gathered from device memory) and one too
    long for even 4 rows of it in shared memory (64 members, K 7000: the
    members in chunks).  Exact equality only, not timed."""
    for n, m, k, rows, c, row0 in [(1, 1, 1, 1, 1, 0), (70, 3, 33, 5, 7, 68),
                                   (200, 5, 100, 37, 65, -40), (300, 4, 300, 130, 100, 50),
                                   (520, 64, 182, 17, 130, 400), (1000, 2, 600, 300, 1, 10**6),
                                   (2000, 64, 178, 1000, 1024, 500), (1200, 64, 182, 1100, 40, 50),
                                   (600, 256, 300, 40, 70, 100), (4000, 64, 7000, 40, 70, 100)]:
        def case(seed):
            g = np.random.default_rng(seed)
            sees = torch.as_tensor(g.random((n, n)) < np.sqrt(1.1 / k), device="cuda")
            mt = torch.as_tensor(g.integers(-1, n + 3, (m, k)).astype(np.int32), device="cuda")
            stake = torch.as_tensor(g.integers(1, 6, m).astype(np.int32), device="cuda")
            cols = torch.as_tensor(g.integers(-1, n + 3, c).astype(np.int32), device="cuda")
            return sees, mt, stake, cols, row0

        def plain(*args):
            return kernels.ssm_block_reference(*args, rows=rows, tot_stake=int(args[2].sum()))

        args = mixed_case(case, plain, rows * c)
        tot = int(args[2].sum())
        compare("ssm_block", f"random n={n} M={m} K={k} rows={rows} C={c} row0={row0}",
                kernels.ssm_block(*args, rows=rows, tot_stake=tot), plain(*args), failures,
                degenerate_ok=rows * c == 1)


def sweep_ssm_matrix(failures):
    """``ssm_matrix`` on small ragged shapes with random member tables: -1
    slots and indices past N (clipped), K past 256 (several k-steps a
    member) and past 1536 (a member staged in parts, its hits carried
    across them: 2, 2 and 4 parts).  Exact equality only, not timed."""
    for n, m, k in [(1, 1, 1), (5, 3, 33), (65, 4, 64), (129, 7, 100), (300, 64, 182),
                    (200, 3, 300), (150, 2, 700), (200, 2, 1600), (3000, 2, 2600),
                    (2500, 3, 5000)]:
        def case(seed):
            g = np.random.default_rng(seed)
            sees = torch.as_tensor(g.random((n, n)) < np.sqrt(1.1 / k), device="cuda")
            mt = torch.as_tensor(g.integers(-1, n + 3, (m, k)).astype(np.int32), device="cuda")
            stake = torch.as_tensor(g.integers(1, 6, m).astype(np.int32), device="cuda")
            return sees, mt, stake

        def plain(*args):
            return kernels.ssm_matrix_reference(*args, tot_stake=int(args[2].sum()))

        args = mixed_case(case, plain, n * n)
        compare("ssm_matrix", f"random N={n} M={m} K={k}",
                kernels.ssm_matrix(*args, tot_stake=int(args[2].sum())), plain(*args),
                failures, degenerate_ok=n == 1)


def edge_stake(rng, m):
    """``m`` positive int32 stakes on the card summing to ``INT32_MAX // 3``,
    the largest total inside the envelope."""
    tot = kernels.INT32_MAX // 3
    w = rng.random(m) + 0.5
    stake = np.floor(w / w.sum() * tot).astype(np.int64)
    stake[0] += tot - stake.sum()
    return torch.as_tensor(stake.astype(np.int32), device="cuda")


def mixed_case(case, plain, outputs, tries=20):
    """The first of ``case(seed)``'s argument tuples whose plain output is
    neither all False nor all True (the first, when it has one output)."""
    for seed in range(tries):
        args = case(seed)
        frac = float(plain(*args).float().mean())
        if outputs == 1 or 0.0 < frac < 1.0:
            break
    return args


def compare(kernel, label, got, want, failures, degenerate_ok=False):
    """Exact equality of a kernel's output with its plain version's, and a
    set fraction strictly between 0 and 1 unless ``degenerate_ok``."""
    same = torch.equal(got, want)
    frac = float(want.float().mean())
    print(f"{kernel} {label}: equal {same}, set_frac {frac}", flush=True)
    if not same:
        failures.append(f"{kernel} {label}: kernel != plain version")
    if not degenerate_ok:
        check_degenerate(kernel, label, frac, failures)


def check_ssm_matrix(packs, slabs, failures):
    """``ssm_matrix`` against its plain version on the full config-4 slab
    with non-uniform stake, the full config-3 slab with its own (uniform)
    stake, and the first 1000 rows and columns of the config-3 slab (a
    ragged N; member-table indices past it are clipped, as the reference
    clips them)."""
    rng = np.random.default_rng(SEED)
    stake4 = rng.integers(1, 6, N_MEMBERS).astype(np.int32)
    cases = [
        ("config4 N=10112, stake 1-5", slabs["config4"], packs["config4"], stake4),
        ("config3 N=10112", slabs["config3"], packs["config3"], packs["config3"].stake),
        ("config3 ragged N=1000", slabs["config3"][:1000, :1000].contiguous(),
         packs["config3"], packs["config3"].stake),
    ]
    rows_out = []
    for label, sees, packed, stake_np in cases:
        dev = sees.device
        mt = torch.as_tensor(packed.member_table, device=dev)
        stake = torch.as_tensor(stake_np, dtype=torch.int32, device=dev)
        tot = int(stake_np.sum())
        got = kernels.ssm_matrix(sees, mt, stake, tot_stake=tot)
        want = kernels.ssm_matrix_reference(sees, mt, stake, tot_stake=tot)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        if not torch.equal(got, want):
            failures.append(f"ssm_matrix {label}: kernel != plain version")
        call = lambda: kernels.ssm_matrix(sees, mt, stake, tot_stake=tot)  # noqa: E731
        ms = time_ms(call, 10)
        plain_ms = time_ms(
            lambda: kernels.ssm_matrix_reference(sees, mt, stake, tot_stake=tot), 3, 1
        )
        n = sees.shape[0]
        n_members, k = packed.member_table.shape
        valid = int((packed.member_table >= 0).sum())
        # each needed sees byte read once (a side: n x valid member slots, b
        # side: valid slots x n), the indices and stake, the bool output;
        # one AND-product per (row, column, valid slot)
        nbytes = 2 * n * valid + 4 * (n_members * k + n_members) + n * n
        bnd, by = bound_ms(nbytes, n * n * valid)
        row = {"case": label, "N": n, "M": n_members, "K": k,
               "max_abs_err": err, "ms": ms, "host_us": host_us(call, 20),
               "card_ms": card_ms(call, 10), "plain_ms": plain_ms,
               "bound_ms": bnd, "bound_by": by,
               "ops_bound_int8_ms": ops_ms(n * n * valid, INT8_OPS_PER_S),
               "set_frac": float(want.float().mean())}
        print("ssm_matrix", json.dumps(row), flush=True)
        check_degenerate("ssm_matrix", label, row["set_frac"], failures)
        rows_out.append(row)

    # the envelope's edge on the ragged slab: stakes summing to
    # INT32_MAX // 3
    edge = edge_stake(rng, N_MEMBERS)
    sees = slabs["config3"][:1000, :1000].contiguous()
    mt = torch.as_tensor(packs["config3"].member_table, device=sees.device)
    tot = int(edge.sum())
    compare("ssm_matrix", "envelope edge N=1000",
            kernels.ssm_matrix(sees, mt, edge, tot_stake=tot),
            kernels.ssm_matrix_reference(sees, mt, edge, tot_stake=tot), failures)

    return rows_out


def run_main_path(name, packed, path, failures):
    """One measured ``run_consensus`` on the card through ``path`` (after a
    warm-up where the path asks for one).  Returns the kernel launches and
    the events/s of the measured run."""
    kw, warm, needs, never = PATHS[path]
    label = f"{name} {path}"
    cfg = SwirldConfig(n_members=N_MEMBERS)
    if warm:
        run_consensus(packed, cfg, device="cuda", **kw)
    for fn in KERNELS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = run_consensus(packed, cfg, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    timings = dict(result.timings)
    stage_seconds = timings.pop("stage_seconds")
    stage_calls = timings.pop("stage_calls")
    print(f"{label}: {packed.n / wall} events/s ({wall} s), ordered "
          f"{len(result.order)}, max_round {result.max_round}", flush=True)
    print(f"{label}: timings {json.dumps(timings)}", flush=True)
    print(f"{label}: stage seconds {json.dumps(stage_seconds)}", flush=True)
    print(f"{label}: stage calls {json.dumps(stage_calls)}", flush=True)
    print(f"{label}: launches {json.dumps(launches)}", flush=True)
    for kname in needs:
        if launches[kname] <= 0:
            failures.append(f"{label}: kernel {kname} was not launched")
    for kname in never:
        if launches[kname] != 0:
            failures.append(f"{label}: kernel {kname} launched {launches[kname]} times")
    digests = result_digests(packed, result)
    print(f"{label}: digests {json.dumps(digests)}", flush=True)
    for key, want in GOLDEN[name].items():
        if digests[key] != want:
            failures.append(f"{label}: {key} digest {digests[key]} != golden {want}")
    if len(result.order) == 0:
        failures.append(f"{label}: empty consensus order")
    return launches, packed.n / wall


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def drive_passes(kind, label, inc, dag, columns_evps, failures, needs=("bmm_or", "ssm_block"),
                 never=("ssm_matrix",)):
    """One driver (``inc``) over one configuration in chunks of ``INC_CHUNK``
    events, with the checks of the module docstring: golden digests, the
    per-pass ``ordered`` lists concatenating to the order, a non-rebase
    pass, every kernel of ``needs`` launched on the non-rebase passes and
    none of ``never`` launched at all.  Returns the run's kernel launches."""
    _members, _stake, events, packed, _keys = dag
    name = label.split()[0]
    tag = f"{kind} {label}"
    for fn in KERNELS.values():
        fn.launches = 0
    ordered, passes = [], []
    for i in range(0, len(events), INC_CHUNK):
        launches0 = {k: fn.launches for k, fn in KERNELS.items()}
        seconds0, calls0 = dict(inc.stages.seconds), dict(inc.stages.calls)
        steps0 = inc.scan_steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = inc.ingest(events[i : i + INC_CHUNK])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        calls = _delta(inc.stages.calls, calls0)
        row = {
            "pass": len(passes), "new_events": st["new_events"], "seconds": dt,
            "rebased": st["rebased"], "storm_mode": st["storm_mode"],
            "window_size": st["window_size"], "pruned_prefix": st["pruned_prefix"],
            "ordered": len(st["ordered"]),
            "probes": calls.get("pipeline.rounds_span_stage", 0),
            "chunk_scans": calls.get("pipeline.rounds_chunk_stage", 0),
            "scan_steps": inc.scan_steps - steps0,
        }
        if isinstance(inc, StreamingConsensus):
            row.update({k: st[k] for k in ("archived_rows", "resident_bytes", "overlap_ratio")})
            row.update(widen_rebases=inc.widen_rebases, full_rebases=inc.full_rebases)
        row.update(
            launches=_delta({k: fn.launches for k, fn in KERNELS.items()}, launches0),
            stage_seconds=_delta(inc.stages.seconds, seconds0), stage_calls=calls,
        )
        print(f"{tag}: {json.dumps(row)}", flush=True)
        passes.append(row)
        ordered.extend(st["ordered"])
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    result = inc.result()
    timings = {k: v for k, v in result.timings.items() if not k.startswith("stage_")}
    print(f"{tag}: counters {json.dumps(timings)}", flush=True)
    if isinstance(inc, StreamingConsensus):
        # the digest drains the pack worker first, so the byte counts are final
        archive = inc.store.archive.digest()
        print(f"{tag}: store {json.dumps(inc.store.stats())}, archive digest {archive}",
              flush=True)
    print(f"{tag}: launches {json.dumps(launches)}", flush=True)
    # steady = the back half of the passes, as bench.py computes it
    steady = passes[len(passes) // 2 :]
    warmed_up = len(steady) >= 2 and not any(r["rebased"] for r in steady)
    t_steady = sum(r["seconds"] for r in steady)
    steady_evps = sum(r["new_events"] for r in steady) / t_steady if warmed_up else 0.0
    print(f"{tag}: steady {steady_evps} events/s over passes "
          f"{steady[0]['pass']}-{steady[-1]['pass']} (warmed up: {warmed_up}); "
          f"the same call's warm columns pass {columns_evps} events/s, ratio "
          f"{steady_evps / columns_evps}", flush=True)
    digests = result_digests(packed, result)
    print(f"{tag}: digests {json.dumps(digests)}", flush=True)
    for key, want in GOLDEN[name].items():
        if digests[key] != want:
            failures.append(f"{tag}: {key} digest {digests[key]} != golden {want}")
    if ordered != result.order:
        failures.append(f"{tag}: per-pass ordered lists != result().order")
    clean = [r for r in passes if not r["rebased"]]
    if not clean:
        failures.append(f"{tag}: every pass rebased")
    for kname in needs:
        if sum(r["launches"].get(kname, 0) for r in clean) <= 0:
            failures.append(f"{tag}: no non-rebase pass launched {kname}")
    for kname in never:
        if launches[kname] != 0:
            failures.append(f"{tag}: {kname} launched {launches[kname]} times")
    return launches


def run_incremental(label, dag, fuse, columns_evps, failures):
    """Phase 5: the incremental driver at ``fuse_chunks`` ``fuse``."""
    members, stake = dag[:2]
    kw = {} if fuse is None else {"fuse_chunks": fuse}
    inc = IncrementalConsensus(
        members, stake, SwirldConfig(n_members=N_MEMBERS), device="cuda", **kw
    )
    return drive_passes("incremental", label, inc, dag, columns_evps, failures)


def run_streaming(name, dag, columns_evps, failures):
    """Phase 6: the streaming driver with the reference defaults.  Returns
    its launches, the driver (phase 7 continues it) and its archive digest
    (phase 8 holds the mesh driver's archive to it)."""
    members, stake = dag[:2]
    inc = StreamingConsensus(
        members, stake, SwirldConfig(n_members=N_MEMBERS), device="cuda"
    )
    launches = drive_passes("streaming", name, inc, dag, columns_evps, failures)
    return launches, inc, inc.store.archive.digest()


def run_widen(inc, dag, failures):
    """Phase 7: the stale-view sync of tests/test_store.py through the
    streaming driver that phase 6 left at the end of ``dag``.  Returns the
    widening pass's kernel launches."""
    members, stake, events, _packed, keys = dag
    tag = "widen config3"
    if inc.pruned_prefix <= STALE_OTHER_PARENT:
        failures.append(f"{tag}: events[{STALE_OTHER_PARENT}] was never pruned")
    pk, sk = keys[3]
    head = [ev for ev in events if ev.c == pk][-1]
    strag = Event(
        d=b"stale-sync", p=(head.id, events[STALE_OTHER_PARENT].id),
        t=events[-1].t + 1, c=pk,
    ).signed(sk)
    widen0, full0 = inc.widen_rebases, inc.full_rebases
    fetched0 = inc.store.archive.fetched_rows
    lo0 = inc.pruned_prefix
    seconds0 = dict(inc.stages.seconds)
    for fn in KERNELS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = inc.ingest([strag])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    row = {
        "seconds": dt, "rebased": st["rebased"], "pruned_prefix_before": lo0,
        "pruned_prefix": st["pruned_prefix"], "window_size": st["window_size"],
        "widen_rebases": inc.widen_rebases - widen0,
        "full_rebases": inc.full_rebases - full0,
        "fetched_rows": inc.store.archive.fetched_rows - fetched0,
        "ordered": len(st["ordered"]), "launches": launches,
        "stage_seconds": _delta(inc.stages.seconds, seconds0),
    }
    print(f"{tag}: {json.dumps(row)}", flush=True)
    if row["widen_rebases"] != 1 or row["full_rebases"] != 0:
        failures.append(f"{tag}: widen {row['widen_rebases']}, full {row['full_rebases']}")
    if row["fetched_rows"] <= 0:
        failures.append(f"{tag}: no archived row was fetched")
    packed = pack_events(events + [strag], members, stake)
    batch = run_consensus(packed, SwirldConfig(n_members=N_MEMBERS), device="cuda")
    got, want = result_digests(packed, inc.result()), result_digests(packed, batch)
    print(f"{tag}: digests {json.dumps(got)}, batch run_consensus {json.dumps(want)}",
          flush=True)
    if got != want:
        failures.append(f"{tag}: result digests != run_consensus over the same history")
    return launches


def run_mesh(name, dag, columns_evps, streaming, failures):
    """Phase 8: the row-sharded mesh driver, ``MESH_SHARDS`` shards on one
    card, the ``pallas=True`` route.  ``streaming`` is phase 6's ``(launches,
    archive digest)`` on the same configuration: the mesh run's archive must
    equal it row for row and its ``bmm_or`` launches must equal it (the
    blocks run no member hop)."""
    members, stake = dag[:2]
    mesh = make_mesh(MESH_SHARDS)
    print(f"mesh {name}: {mesh.size} shards on one card ({mesh.device})", flush=True)
    inc = MeshStreamingConsensus(
        mesh, members, stake, SwirldConfig(n_members=N_MEMBERS), pallas=True,
        device="cuda",
    )
    launches = drive_passes(
        "mesh", name, inc, dag, columns_evps, failures,
        needs=("bmm_or", "make_mesh_row_block_fn", "ssm_tally"),
        never=("ssm_matrix", "ssm_block"),
    )
    streaming_launches, streaming_archive = streaming
    if inc.store.archive.digest() != streaming_archive:
        failures.append(f"mesh {name}: archive digest != the streaming driver's")
    if launches["bmm_or"] != streaming_launches["bmm_or"]:
        failures.append(f"mesh {name}: {launches['bmm_or']} bmm_or launches, the "
                        f"streaming run {streaming_launches['bmm_or']}")
    blocks, tallies = launches["make_mesh_row_block_fn"], launches["ssm_tally"]
    if not 0 < tallies <= MESH_SHARDS * blocks:
        failures.append(f"mesh {name}: {tallies} ssm_tally launches for {blocks} blocks "
                        f"of {MESH_SHARDS} shards")
    inc.store.close()
    return launches


def check_mesh_block(packed, failures):
    """Phase 9: ``make_mesh_row_block_fn`` against ``ssm_block`` and
    ``ssm_block_reference`` on the config-3 slab, non-uniform stake;
    ``ssm_tally`` alone against ``ssm_tally_reference``; a member hop
    ``bmm_or`` beside ``torch.matmul``."""
    sees = sees_slab(packed)
    dev = sees.device
    rng = np.random.default_rng(SEED)
    stake_np = rng.integers(1, 6, N_MEMBERS).astype(np.int32)
    tot = int(stake_np.sum())
    mt = torch.as_tensor(packed.member_table, device=dev)
    stake = torch.as_tensor(stake_np, device=dev)
    n_pad = sees.shape[0]
    n_members, k = packed.member_table.shape
    valid = int((packed.member_table >= 0).sum())

    def pick(lo, hi, c):
        return np.sort(rng.choice(np.arange(lo, hi), c, replace=False)).astype(np.int32)

    cases = [("extension rows=1024,C=256", 4096, 1024, pick(2048, 5120, 256)),
             ("column add rows=10112,C=64", 0, n_pad, pick(0, N_EVENTS, 64))]
    rows_out = []
    for d in (2, 4):
        fn = kernels.make_mesh_row_block_fn(make_mesh(d))
        for label, row0, rows, cols_np in cases:
            cols = torch.as_tensor(cols_np, device=dev)
            kw = dict(rows=rows, tot_stake=tot)
            tally0, bmm0 = kernels.ssm_tally.launches, kernels.bmm_or.launches
            got = fn(sees, mt, stake, cols, row0, **kw)
            per_block = {"ssm_tally": kernels.ssm_tally.launches - tally0,
                         "bmm_or": kernels.bmm_or.launches - bmm0}
            single = kernels.ssm_block(sees, mt, stake, cols, row0, **kw)
            want = kernels.ssm_block_reference(sees, mt, stake, cols, row0, **kw)
            torch.cuda.synchronize()
            err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
            if not torch.equal(got, want) or not torch.equal(got, single):
                failures.append(f"make_mesh_row_block_fn D={d} {label}: "
                                "!= ssm_block / plain version")
            if per_block["bmm_or"] != 0 or not 0 < per_block["ssm_tally"] <= d:
                failures.append(f"make_mesh_row_block_fn D={d} {label}: launches "
                                f"{per_block} a block")
            ms = time_ms(lambda: fn(sees, mt, stake, cols, row0, **kw), 10)
            single_ms = time_ms(lambda: kernels.ssm_block(sees, mt, stake, cols, row0, **kw), 20)
            plain_ms = time_ms(
                lambda: kernels.ssm_block_reference(sees, mt, stake, cols, row0, **kw), 3, 1
            )
            c = len(cols_np)
            # as ssm_block's bound: the work of one block, without the D-fold
            # b side that the halo sum adds
            nbytes = rows * valid + valid * c + 4 * (n_members * k + c + n_members) + rows * c
            bnd, by = bound_ms(nbytes, rows * c * valid)
            row = {"case": label, "shards": d, "row0": row0, "rows": rows, "C": c,
                   "max_abs_err": err, "ms": ms, "host_us": host_us(
                       lambda: fn(sees, mt, stake, cols, row0, **kw), 50),
                   "ssm_block_ms": single_ms, "plain_ms": plain_ms,
                   "bound_ms": bnd, "bound_by": by, "launches_per_block": per_block,
                   "set_frac": float(want.float().mean())}
            print("make_mesh_row_block_fn", json.dumps(row), flush=True)
            check_degenerate("make_mesh_row_block_fn", f"D={d} {label}", row["set_frac"],
                             failures)
            rows_out.append(row)

    # ssm_tally alone: the extension block's shard 0 of 2 (rows 4096-5055
    # of the 1024 from 4096), on the halo-assembled b the block builds
    _label, row0, rows, cols_np = cases[0]
    cols = torch.as_tensor(cols_np, device=dev)
    idx = mt.reshape(-1)
    ok = idx >= 0
    b = sees[idx.clamp(0, n_pad - 1)[:, None], cols.clamp(0, n_pad - 1)[None, :]]
    b = (b & ok[:, None] & (cols >= 0)[None, :]).contiguous()
    n_loc = n_pad // 2
    shards = [sees[:n_loc], sees[n_loc:]]
    args = (shards[0], mt, stake, b, row0)
    got = kernels.ssm_tally(*args, rows=rows)
    want = kernels.ssm_tally_reference(*args, rows=rows)
    summed = got + kernels.ssm_tally(shards[1], mt, stake, b, row0 - n_loc, rows=rows)
    hit = (3 * summed.to(torch.int64) > 2 * tot) & (cols >= 0)[None, :]
    single = kernels.ssm_block(sees, mt, stake, cols, row0, rows=rows, tot_stake=tot)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        failures.append("ssm_tally extension shard 0: kernel != plain version")
    if not torch.equal(hit, single):
        failures.append("ssm_tally extension: summed threshold != ssm_block")
    owned = n_loc - row0
    c = len(cols_np)
    # as ssm_block's bound: the owned rows' gathered sees bytes, the valid
    # rows of b, the indices and stake, the int32 output
    nbytes = owned * valid + valid * c + 4 * (n_members * k + n_members) + 4 * rows * c
    bnd, by = bound_ms(nbytes, owned * c * valid)
    tally_row = {
        "case": "extension shard 0 of 2: rows=1024 (960 owned),C=256",
        "max_abs_err": int((got - want).abs().max()),
        "ms": time_ms(lambda: kernels.ssm_tally(*args, rows=rows), 50),
        "host_us": host_us(lambda: kernels.ssm_tally(*args, rows=rows)),
        "card_ms": card_ms(lambda: kernels.ssm_tally(*args, rows=rows)),
        "plain_ms": time_ms(lambda: kernels.ssm_tally_reference(*args, rows=rows), 5),
        "bound_ms": bnd, "bound_by": by, "set_frac": float(hit.float().mean()),
    }
    print("ssm_tally", json.dumps(tally_row), flush=True)
    check_degenerate("ssm_tally", "extension summed threshold", tally_row["set_frac"],
                     failures)

    # a member hop of the extension block, member 0, as the bmm route runs it
    a = (sees[4096:5120][:, idx[:k].clamp(0, n_pad - 1)] & ok[None, :k]).contiguous()
    b0 = b[:k].contiguous()
    got, want = kernels.bmm_or(a, b0), kernels.bmm_or_reference(a, b0)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        failures.append(f"bmm_or mesh hop 1024x{k}x256: kernel != plain version")
    p, q, r = a.shape[0], k, b0.shape[1]
    bnd, by = bound_ms(p * q + q * r + p * r, p * q * r)
    hop = {"shape": [p, q, r], "case": "mesh member hop (config-3 slab, member 0)",
           "max_abs_err": int((got.to(torch.int32) - want.to(torch.int32)).abs().max()),
           "ms": time_ms(lambda: kernels.bmm_or(a, b0), 50),
           "host_us": host_us(lambda: kernels.bmm_or(a, b0)),
           "card_ms": card_ms(lambda: kernels.bmm_or(a, b0)),
           "plain_ms": time_ms(lambda: kernels.bmm_or_reference(a, b0), 50),
           "library_ms": time_ms(
               lambda: torch.matmul(a.to(torch.bfloat16), b0.to(torch.bfloat16)) > 0.5, 50),
           "bound_ms": bnd, "bound_by": by, "set_frac": float(want.float().mean())}
    print("bmm_or", json.dumps(hop), flush=True)
    check_degenerate("bmm_or", "mesh hop", hop["set_frac"], failures)
    return rows_out, tally_row, hop


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    failures = []
    t_script = time.perf_counter()

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {time.perf_counter() - t0:.3f} s for {built}", flush=True)

    dags, packs = {}, {}
    for name, n_forkers in CONFIGS.items():
        t0 = time.perf_counter()
        dags[name] = make_dag(n_forkers)
        packs[name] = packed = dags[name][3]
        print(f"{name}: generated and packed {packed.n} events, "
              f"{len(packed.fork_pairs)} fork pairs, member table "
              f"{packed.member_table.shape} in {time.perf_counter() - t0:.3f} s",
              flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    g_cap = ((len(packs["config4"].fork_pairs) + 7) // 8) * 8
    bmm_rows = check_bmm_or(gen, g_cap, failures)
    slabs = {name: sees_slab(packed) for name, packed in packs.items()}
    ssm_rows = check_ssm_block(packs, slabs, failures)
    sweep_ssm_block(failures)
    matrix_rows = check_ssm_matrix(packs, slabs, failures)
    sweep_ssm_matrix(failures)
    del slabs
    torch.cuda.empty_cache()

    # launches[path][config][kernel], from the measured runs
    launches = {path: {} for path in PATHS}
    columns_evps = {}
    for name, packed in packs.items():
        for path in PATHS:
            launches[path][name], evps = run_main_path(name, packed, path, failures)
            if path == "columns":
                columns_evps[name] = evps
    launches["incremental"] = {}
    for label, (name, fuse) in INC_RUNS.items():
        launches["incremental"][label] = run_incremental(
            label, dags[name], fuse, columns_evps[name], failures
        )
    launches["streaming"], archives = {}, {}
    for name in CONFIGS:
        launches["streaming"][name], inc, archives[name] = run_streaming(
            name, dags[name], columns_evps[name], failures
        )
        if name == "config3":
            launches["widen"] = {name: run_widen(inc, dags[name], failures)}
        inc.store.close()
        del inc
    launches["mesh"] = {}
    for name in CONFIGS:
        launches["mesh"][name] = run_mesh(
            name, dags[name], columns_evps[name],
            (launches["streaming"][name], archives[name]), failures,
        )
    torch.cuda.empty_cache()
    mesh_rows, tally_row, hop_row = check_mesh_block(packs["config3"], failures)

    # one row per kernel at its hottest main-path shape: the ancestry
    # propagation hop for bmm_or, the full-height column add for ssm_block,
    # the config-4 matrix for ssm_matrix, the 2-shard extension block for
    # make_mesh_row_block_fn and one of its shards for ssm_tally (no single
    # PyTorch call computes either)
    def entry(name, row, rows, library_ms):
        by_path = {path: {cfg: counts[name] for cfg, counts in per.items()}
                   for path, per in launches.items()}
        return {
            "name": name, "route": "cuda", **KERNEL_INFO[name],
            "launches": sum(sum(per.values()) for per in by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            **({"ops_bound_int8_ms": row["ops_bound_int8_ms"]}
               if "ops_bound_int8_ms" in row else {}),
            "library_ms": library_ms, "shapes": rows,
        }

    line = {"kernels": [
        entry("bmm_or", bmm_rows[1], bmm_rows + [hop_row], bmm_rows[1]["library_ms"]),
        entry("ssm_block", ssm_rows[0], ssm_rows, None),
        entry("ssm_matrix", matrix_rows[0], matrix_rows, None),
        entry("make_mesh_row_block_fn", mesh_rows[0], mesh_rows, None),
        entry("ssm_tally", tally_row, [tally_row], None),
    ]}
    if failures:
        for f in failures:
            print("FAIL:", f, file=sys.stderr)
        return 1
    print(f"chip_smoke: {time.perf_counter() - t_script} s from the build to "
          "the last check", flush=True)
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
