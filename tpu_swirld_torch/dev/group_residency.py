"""A card's share of the streaming window when the window is row-sharded
over a process group, at config 3's size, on one CUDA card:

    python3 -m tpu_swirld_torch.dev.group_residency [--ranks 2] [--straggler K]

Config 3 is BASELINE.json's ``configs[2]``, ``generate_gossip_dag(64,
10000, seed=1)`` (fork-free), fed in ingests of 1000 with the streaming
driver's defaults, as ``chip_smoke.py`` feeds it.  Three drivers run it
on the card: the one-process ``StreamingConsensus``, the one-process
``MeshStreamingConsensus`` over ``--ranks`` shards of the one card, and
``GroupStreamingConsensus`` over ``--ranks`` gloo ranks sharing the card
(both meshes on the ``ssm_tally`` route, ``pallas=True``).  For each it
prints the peak device bytes above what was held, in all and by stage
(``multichip.stage_peaks``), the slab bytes after each ingest (a rank's
own beside the window's), the collectives a pass and the bytes handed to
them, in all and (for a rank) summed by stage over the passes, with the
order stage's bytes a pass and the window's rows, and the ingests' wall
seconds, then one JSON line with all of it, the card's name and power
limit.  Exits 1 unless every driver's digest
(result and archive) is the one process's.

``--straggler K`` feeds the first ``K`` ingests, then a straggler
witness of member 7 forged at round 1 (its self-parent the member's first
event, its other parent the first round-1 event of another member, as
``tests/test_torch_store.py`` forges it; it forks the member's chain),
so that one full rebase runs over the ``K x 1000`` events and their
straggler; it then prints, for each driver, the peaks of the rebase's
stages (``REBASE_STAGES``) and, for each rank, its visibility stage's
bytes and each full rebase's record (``rebase_slabs``: shapes, the most
rows of a slab, the crossing rows).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from tpu_swirld_torch import crypto, multichip
from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.event import Event
from tpu_swirld_torch.gpu.pipeline import run_consensus
from tpu_swirld_torch.packing import pack_events
from tpu_swirld_torch.parallel import MeshStreamingConsensus, make_mesh, stage_totals
from tpu_swirld_torch.sim import generate_gossip_dag
from tpu_swirld_torch.store import StreamingConsensus

MEMBERS, EVENTS, SEED, INGEST = 64, 10_000, 1, 1000
#: a full rebase's own stages
REBASE_STAGES = ("pipeline.visibility_stage", "pipeline.rounds_chunk_stage",
                 "pipeline.fame_order_cols_stage")
STRAGGLER_MEMBER = 7


def straggler(events, keys, members, stake, cfg):
    """A witness of member ``STRAGGLER_MEMBER`` forged at round 1 over
    ``events`` (their rounds from one batch pass on the card)."""
    rnd = run_consensus(pack_events(events, members, stake), cfg, device="cuda").round
    pk, sk = keys[STRAGGLER_MEMBER]
    sp = next(e for e in events if e.c == pk)
    op = next(e for i, e in enumerate(events) if e.c != pk and rnd[i] == 1)
    return Event(d=b"straggler", p=(sp.id, op.id), t=max(sp.t, op.t) + 1, c=pk).signed(sk)


def one_process(make, chunks, packed) -> dict:
    """Drive the driver ``make()`` builds through ``chunks`` in this
    process and measure it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    inc = make()
    monitor = multichip.watch_stage_peaks(inc)
    try:
        t0 = time.perf_counter()
        passes = [inc.ingest(chunk) for chunk in chunks]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        digest = (multichip.result_digest(packed, inc.result())
                  + inc.store.archive.digest())
        peaks = multichip.stage_peaks(monitor, base)
    finally:
        inc.store.close()
    return {"digest": digest, "wall": wall, "peak_bytes": max(peaks.values()),
            "stage_peaks": peaks, "resident_bytes": [st["resident_bytes"] for st in passes]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2, help="row shards (gloo ranks)")
    ap.add_argument("--straggler", type=int, default=None, metavar="K",
                    help="a straggler witness after ingest K, then stop")
    args = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    crypto.set_backend("sim")
    members, stake, events, keys = generate_gossip_dag(MEMBERS, EVENTS, seed=SEED)
    chunks = [events[i : i + INGEST] for i in range(0, len(events), INGEST)]
    cfg = SwirldConfig(n_members=MEMBERS)
    if args.straggler is not None:
        chunks = chunks[: args.straggler]
        events = [e for c in chunks for e in c]
        chunks.append([straggler(events, keys, members, stake, cfg)])
        events = events + chunks[-1]
    packed = pack_events(events, members, stake)
    out = {"card": smi, "ranks": args.ranks, "straggler": args.straggler}
    out["one_process"] = one_process(
        lambda: StreamingConsensus(members, stake, cfg, device="cuda"), chunks, packed)
    out["one_process_mesh"] = one_process(
        lambda: MeshStreamingConsensus(make_mesh(args.ranks), members, stake, cfg,
                                       pallas=True, device="cuda"), chunks, packed)
    t0 = time.perf_counter()
    reports = multichip.launch(multichip.streaming_rank, args.ranks,
                               args=(members, stake, cfg, chunks, {"pallas": True}),
                               device="cuda", backend="gloo", timeout=1200)
    out["group_seconds"] = time.perf_counter() - t0
    out["group"] = [{
        "digest": rep["result"]["digest"], "wall": rep["result"]["wall"],
        "peak_bytes": rep["result"]["peak_bytes"],
        "stage_peaks": rep["result"]["stage_peaks"],
        "rank_resident_bytes": [st["rank_resident_bytes"] for st in rep["result"]["passes"]],
        "resident_bytes": [st["resident_bytes"] for st in rep["result"]["passes"]],
        "group_calls": [st["group_calls"] for st in rep["result"]["passes"]],
        "group_bytes": [st["group_bytes"] for st in rep["result"]["passes"]],
        "group_stages": stage_totals(st["group_stages"] for st in rep["result"]["passes"]),
        "order_bytes": [st["group_stages"].get("pipeline.inc_order", {}).get("bytes", 0)
                        for st in rep["result"]["passes"]],
        "window_rows": [st["group_window_rows"] for st in rep["result"]["passes"]],
        "visibility_bytes": [st["group_stages"].get("pipeline.visibility_stage", {})
                             .get("bytes", 0) for st in rep["result"]["passes"]],
        "rebase_slabs": rep["result"].get("rebase_slabs"),
        "launches": rep["launches"],
    } for rep in reports]
    for name in ("one_process", "one_process_mesh"):
        r = out[name]
        print(f"{name}: {r['wall']} s, peak {r['peak_bytes']} bytes, by stage "
              f"{json.dumps(r['stage_peaks'])}; slab bytes {r['resident_bytes']}", flush=True)
    if args.straggler is not None:
        for name in ("one_process", "one_process_mesh"):
            print(f"{name} rebase stages: " + json.dumps(
                {s: out[name]["stage_peaks"].get(s) for s in REBASE_STAGES}), flush=True)
        for rank, r in enumerate(out["group"]):
            print(f"group rank {rank} rebase stages: " + json.dumps(
                {s: r["stage_peaks"].get(s) for s in REBASE_STAGES})
                + f"; visibility bytes a pass {r['visibility_bytes']}; full rebases "
                + json.dumps(r["rebase_slabs"]), flush=True)
    for rank, r in enumerate(out["group"]):
        print(f"group rank {rank}: {r['wall']} s, peak {r['peak_bytes']} bytes, by stage "
              f"{json.dumps(r['stage_peaks'])}; own slab bytes {r['rank_resident_bytes']} "
              f"of {r['resident_bytes']}; collectives {r['group_calls']}, bytes "
              f"{r['group_bytes']}; order stage bytes {r['order_bytes']} of windows "
              f"{r['window_rows']} rows; by stage {json.dumps(r['group_stages'])}",
              flush=True)
    want = out["one_process"]["digest"]
    same = [out["one_process_mesh"]["digest"] == want] + [
        r["digest"] == want for r in out["group"]]
    out["same_digests"] = same
    print(json.dumps(out), flush=True)
    return 0 if all(same) else 1


if __name__ == "__main__":
    sys.exit(main())
