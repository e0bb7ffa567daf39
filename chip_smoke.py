#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

1. Environment: the card's name and power limit, torch and CUDA versions.
2. Build: compiles every CUDA kernel of the main path from ``tpu_swirld_torch/
   gpu/csrc`` (one ``nvcc`` per source, all started together) and times it.
3. Kernel vs plain version on the card, exact equality: ``bmm_or`` at the
   ancestry and forkseen shapes plus a ragged one, ``ssm_block`` on the sees
   slab of the BASELINE config-4 DAG at the column-add shapes.  Each is timed
   (median of CUDA-event timings after a warm-up) beside its plain version,
   its least time on the card (bound) and, for ``bmm_or``, one library call.
4. Main path, BASELINE config 3 (64 members, 10 000 events, uniform stake):
   the port's gossip DAG + ``run_consensus(device="cuda")`` twice (the first
   warms up); events/s and per-stage seconds of the second run, kernel launch
   counts of that run (each must be > 0), and SHA-256 digests of the order,
   rounds, fame and round-received held against golden digests computed from
   the JAX reference on the same DAG.
5. Main path, BASELINE config 4: the same with 21 forkers.
6. A ``{"kernels": [...]}`` line, then ``{"ok": true, ...}`` as the last line.

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

from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.gpu import build, kernels
from tpu_swirld_torch.gpu.pipeline import run_consensus, visibility_stage
from tpu_swirld_torch.packing import pack_events
from tpu_swirld_torch.sim import generate_gossip_dag

N_MEMBERS = 64
N_EVENTS = 10_000
SEED = 1
CONFIGS = {"config3": 0, "config4": 21}      # name -> forkers

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
INT8_OPS_PER_S = 1979e12        # dense int8 tensor-core peak, same source
KERNEL_INFO = {
    "bmm_or": {
        "source": "tpu_swirld_torch/gpu/csrc/bmm_or.cu",
        "replaces": "tpu_swirld/tpu/pallas_kernels.py:313",
    },
    "ssm_block": {
        "source": "tpu_swirld_torch/gpu/csrc/ssm_block.cu",
        "replaces": "tpu_swirld/tpu/pallas_kernels.py:206",
    },
}


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


def make_packed(n_forkers: int):
    members, stake, events, _keys = generate_gossip_dag(
        N_MEMBERS, N_EVENTS, seed=SEED, n_forkers=n_forkers
    )
    return pack_events(events, members, stake)


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


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def random_bool(shape, density, gen):
    return torch.rand(shape, generator=gen, device="cuda") < density


def check_bmm_or(gen, failures):
    rows = []
    shapes = [(128, 128, 128), (128, 128, 10112), (10112, 4517, 64), (100, 37, 70)]
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
        plain_ms = time_ms(lambda: kernels.bmm_or_reference(a, b), reps)
        lib_ms = time_ms(
            lambda: torch.matmul(a.to(torch.bfloat16), b.to(torch.bfloat16)) > 0.5,
            reps,
        )
        bnd, by = bound_ms(p * q + q * r + p * r, p * q * r)
        row = {"shape": [p, q, r], "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bnd,
               "bound_by": by, "set_frac": float(want.float().mean())}
        print("bmm_or", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def check_ssm_block(failures):
    packed = make_packed(CONFIGS["config4"])
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
    rng = np.random.default_rng(SEED)
    mt = torch.as_tensor(packed.member_table, device=dev)
    stake_np = rng.integers(1, 6, N_MEMBERS).astype(np.int32)   # non-uniform
    stake = torch.as_tensor(stake_np, device=dev)
    tot = int(stake_np.sum())

    def pick(lo, hi):       # 64 column events, a few rounds below the rows
        return np.sort(rng.choice(np.arange(lo, hi), 64, replace=False)).astype(np.int32)

    one = np.full(64, -1, np.int32)
    one[0] = n - 2000
    cases = [
        ("rows=10112,C=64", 0, n_pad, pick(0, n)),
        ("rows=256,C=64", n_pad - 256, 256, pick(n - 2000, n - 1000)),
        ("row0=4033,rows=96", 4033, 96, pick(2000, 3000)),
        ("one column padded to 64", n_pad - 512, 512, one),
    ]
    valid = int((packed.member_table >= 0).sum())
    n_members, k = packed.member_table.shape
    rows_out = []
    for label, row0, rows, cols_np in cases:
        cols = torch.as_tensor(cols_np, device=dev)
        kw = dict(rows=rows, tot_stake=tot)
        got = kernels.ssm_block(sees, mt, stake, cols, row0, **kw)
        want = kernels.ssm_block_reference(sees, mt, stake, cols, row0, **kw)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        if not torch.equal(got, want):
            failures.append(f"ssm_block {label}: kernel != plain version")
        ms = time_ms(lambda: kernels.ssm_block(sees, mt, stake, cols, row0, **kw), 20)
        plain_ms = time_ms(
            lambda: kernels.ssm_block_reference(sees, mt, stake, cols, row0, **kw), 5
        )
        c = len(cols_np)
        c_valid = int((cols_np >= 0).sum())
        # each needed sees byte read once (a side: rows x valid member slots,
        # b side: valid slots x valid columns), the indices, the bool output
        nbytes = rows * valid + valid * c_valid + 4 * (n_members * k + c + n_members) + rows * c
        bnd, by = bound_ms(nbytes, rows * c * n_members * k)
        row = {"case": label, "row0": row0, "rows": rows, "C": c,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bnd, "bound_by": by,
               "ops_bound_ms": rows * c * n_members * k / INT8_OPS_PER_S * 1e3,
               "set_frac": float(want.float().mean())}
        print("ssm_block", json.dumps(row), flush=True)
        rows_out.append(row)
    return rows_out


def run_main_path(name: str, n_forkers: int, failures):
    t0 = time.perf_counter()
    packed = make_packed(n_forkers)
    print(f"{name}: generated and packed {packed.n} events, "
          f"{len(packed.fork_pairs)} fork pairs, member table "
          f"{packed.member_table.shape} in {time.perf_counter() - t0:.3f} s",
          flush=True)
    cfg = SwirldConfig(n_members=N_MEMBERS)
    run_consensus(packed, cfg, device="cuda")           # warm-up
    kernels.bmm_or.launches = 0
    kernels.ssm_block.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = run_consensus(packed, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"bmm_or": kernels.bmm_or.launches,
                "ssm_block": kernels.ssm_block.launches}
    timings = dict(result.timings)
    stage_seconds = timings.pop("stage_seconds")
    stage_calls = timings.pop("stage_calls")
    print(f"{name}: {packed.n / wall} events/s ({wall} s), ordered "
          f"{len(result.order)}, max_round {result.max_round}", flush=True)
    print(f"{name}: timings {json.dumps(timings)}", flush=True)
    print(f"{name}: stage seconds {json.dumps(stage_seconds)}", flush=True)
    print(f"{name}: stage calls {json.dumps(stage_calls)}", flush=True)
    print(f"{name}: launches {json.dumps(launches)}", flush=True)
    for kname, count in launches.items():
        if count <= 0:
            failures.append(f"{name}: kernel {kname} was not launched on the main path")
    digests = result_digests(packed, result)
    print(f"{name}: digests {json.dumps(digests)}", flush=True)
    for key, want in GOLDEN[name].items():
        if digests[key] != want:
            failures.append(f"{name}: {key} digest {digests[key]} != golden {want}")
    if len(result.order) == 0:
        failures.append(f"{name}: empty consensus order")
    return launches, packed.n / wall


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

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {time.perf_counter() - t0:.3f} s for {built}", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    bmm_rows = check_bmm_or(gen, failures)
    ssm_rows = check_ssm_block(failures)

    main_launches = {}
    for name, n_forkers in CONFIGS.items():
        main_launches[name], _rate = run_main_path(name, n_forkers, failures)

    # one row per kernel at its hottest main-path shape: the ancestry
    # propagation hop for bmm_or, the full-height column add for ssm_block
    def entry(name, row, rows, library_ms):
        return {
            "name": name, "route": "cuda", **KERNEL_INFO[name],
            "launches": main_launches["config3"][name],
            "launches_config4": main_launches["config4"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": library_ms, "shapes": rows,
        }

    line = {"kernels": [
        entry("bmm_or", bmm_rows[1], bmm_rows, bmm_rows[1]["library_ms"]),
        entry("ssm_block", ssm_rows[0], ssm_rows, None),
    ]}
    if failures:
        for f in failures:
            print("FAIL:", f, file=sys.stderr)
        return 1
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
