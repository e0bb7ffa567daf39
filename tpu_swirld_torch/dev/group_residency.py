"""A card's share of the streaming window when the window is row-sharded
over a process group, at config 3's size, on one CUDA card:

    python3 -m tpu_swirld_torch.dev.group_residency [--ranks 2] [--straggler K | --widen K]

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

``--widen K`` feeds the first ``K`` ingests, then the stale-view sync of
``chip_smoke.py``'s phase 7 (member 3's head, its other parent the
long-pruned ``events[100]``, ``chip_smoke.STALE_OTHER_PARENT``), which
each driver answers with a widening rebase, and measures that one
ingest: for the one-process ``StreamingConsensus``, the one-process
``MeshStreamingConsensus`` and each rank of the group, the widening's
seconds, host peak (``tracemalloc``, allocations made during it) and
device peak above what was held before the ingest, both over the
widening alone (``_try_widen``) and over the whole ingest, the bytes the
rank handed its collectives in both, the window's rows before and after,
``delta``, and each rank's ``widen_slabs`` record where the driver keeps
one.  It reads only the drivers' ``_try_widen``, counters and result,
so the same script measures an older tree of the port put on
``PYTHONPATH``.  Its functions also run on the CPU at a small size, with
the device peaks ``None`` (``tests/test_torch_group_residency.py``).
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
#: the stale-view sync: (member, the long-pruned event its other parent
#: names), as chip_smoke.py's phase 7 sends it
STALE_MEMBER, STALE_OTHER_PARENT = 3, 100


def straggler(events, keys, members, stake, cfg):
    """A witness of member ``STRAGGLER_MEMBER`` forged at round 1 over
    ``events`` (their rounds from one batch pass on the card)."""
    rnd = run_consensus(pack_events(events, members, stake), cfg, device="cuda").round
    pk, sk = keys[STRAGGLER_MEMBER]
    sp = next(e for e in events if e.c == pk)
    op = next(e for i, e in enumerate(events) if e.c != pk and rnd[i] == 1)
    return Event(d=b"straggler", p=(sp.id, op.id), t=max(sp.t, op.t) + 1, c=pk).signed(sk)


def stale_sync(events, keys):
    """Member ``STALE_MEMBER``'s sync whose other parent is the long-pruned
    ``events[STALE_OTHER_PARENT]``."""
    pk, sk = keys[STALE_MEMBER]
    head = [ev for ev in events if ev.c == pk][-1]
    return Event(d=b"stale-sync", p=(head.id, events[STALE_OTHER_PARENT].id),
                 t=events[-1].t + 1, c=pk).signed(sk)


def measure_widening(inc, chunks, stale, traffic=None) -> dict:
    """Feed ``chunks``, then ``stale`` alone, measured: over the widening
    (``_try_widen``) and over the whole ingest, the seconds, the host
    peak (tracemalloc, allocations made during it), the device peak above
    what was allocated before the ingest and, with a group's ``traffic``,
    the bytes handed to collectives."""
    import tracemalloc

    for chunk in chunks:
        inc.ingest(chunk)
    dev = torch.device(inc.device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def device_peak():
        return torch.cuda.max_memory_allocated(dev) - base if cuda else None

    rec = {}
    widen = inc._try_widen

    def measured(lo2):
        sync()
        tracemalloc.reset_peak()
        host0, sent = tracemalloc.get_traced_memory()[0], _sent(traffic)
        rec.update(lo_before=inc.pruned_prefix, w_pad_before=inc._w_pad)
        t0 = time.perf_counter()
        ok = widen(lo2)
        sync()
        rec.update(widen_seconds=time.perf_counter() - t0, widened=ok,
                   widen_host_peak=tracemalloc.get_traced_memory()[1] - host0,
                   widen_device_peak=device_peak(), widen_bytes=_sent(traffic) - sent)
        return ok

    inc._try_widen = measured
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) if cuda else 0
    sent = _sent(traffic)
    tracemalloc.start()
    try:
        t0 = time.perf_counter()
        st = inc.ingest([stale])
        sync()
        rec["ingest_seconds"] = time.perf_counter() - t0
        rec["ingest_host_peak"] = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
        inc._try_widen = widen
    rec.update(ingest_device_peak=device_peak(),
               ingest_bytes=_sent(traffic) - sent, w_pad=inc._w_pad,
               pruned_prefix=inc.pruned_prefix, widen_rebases=inc.widen_rebases,
               full_rebases=inc.full_rebases, rebased=st["rebased"],
               widen_slabs=getattr(inc, "widen_slabs", None))
    return rec


def _sent(traffic) -> int:
    return 0 if traffic is None else traffic.bytes


def widen_rank(mesh, members, stake, cfg, chunks, stale, driver=None) -> dict:
    """A group rank's :func:`measure_widening` over the stream and its
    digest (result and archive); ``driver`` adds settings to the driver's
    (``pallas=True`` and the defaults)."""
    events = [e for c in chunks for e in c] + [stale]
    inc = MeshStreamingConsensus(mesh, members, stake, cfg, device=mesh.device,
                                 **{"pallas": True, **(driver or {})})
    try:
        rec = measure_widening(inc, chunks, stale, mesh.traffic)
        rec["digest"] = (multichip.result_digest(pack_events(events, members, stake),
                                                 inc.result())
                         + inc.store.archive.digest())
    finally:
        inc.store.close()
    return rec


def widen_one(make, chunks, stale, packed) -> dict:
    """:func:`measure_widening` of the driver ``make()`` builds, in this
    process, and its digest."""
    inc = make()
    try:
        rec = measure_widening(inc, chunks, stale)
        rec["digest"] = (multichip.result_digest(packed, inc.result())
                         + inc.store.archive.digest())
    finally:
        inc.store.close()
    return rec


def run_widen(args, smi, members, stake, events, keys, chunks, cfg) -> int:
    """``--widen K``: every driver's widening of the stale sync after ``K``
    ingests, measured (module doc); exit 1 unless every digest is the one
    process's and every driver widened once."""
    chunks = chunks[: args.widen]
    events = [e for c in chunks for e in c]
    stale = stale_sync(events, keys)
    packed = pack_events(events + [stale], members, stake)
    out = {"card": smi, "ranks": args.ranks, "widen": args.widen}
    out["one_process"] = widen_one(
        lambda: StreamingConsensus(members, stake, cfg, device="cuda"), chunks, stale,
        packed)
    out["one_process_mesh"] = widen_one(
        lambda: MeshStreamingConsensus(make_mesh(args.ranks), members, stake, cfg,
                                       pallas=True, device="cuda"), chunks, stale, packed)
    reports = multichip.launch(widen_rank, args.ranks,
                               args=(members, stake, cfg, chunks, stale),
                               device="cuda", backend="gloo", timeout=1200)
    out["group"] = [rep["result"] for rep in reports]
    for name, r in [("one_process", out["one_process"]),
                    ("one_process_mesh", out["one_process_mesh"])] + [
            (f"group rank {i}", r) for i, r in enumerate(out["group"])]:
        print(f"{name}: " + json.dumps({k: v for k, v in r.items() if k != "digest"}),
              flush=True)
    want = out["one_process"]["digest"]
    runs = [out["one_process"], out["one_process_mesh"]] + out["group"]
    out["same_digests"] = [r["digest"] == want for r in runs]
    ok = all(out["same_digests"]) and all(
        r["widened"] and r["widen_rebases"] == 1 for r in runs)
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


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
    ap.add_argument("--widen", type=int, default=None, metavar="K",
                    help="a stale-view sync after ingest K, its widening measured")
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
    if args.widen is not None:
        return run_widen(args, smi, members, stake, events, keys, chunks, cfg)
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
