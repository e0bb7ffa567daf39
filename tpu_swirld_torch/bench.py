"""Benchmark: events/sec to consensus order, the port on the card against
the pure-Python oracle (the port's counterpart of the reference's
``bench.py``: the same modes, JSON keys, knobs and exit codes).

    python -m tpu_swirld_torch.bench [--device cuda|cpu]
    python -m tpu_swirld_torch.bench --stream [--tile-budget N] [--tile T]
                                     [--mesh D [--device-tile-budget N]]
    python -m tpu_swirld_torch.bench --chaos-overhead | --churn | --cluster | --soak

Prints ONE JSON line on stdout; every detail goes to stderr.  The default
mode's line is ``{"metric", "value", "unit", "vs_baseline", "phases",
"peak_host_bytes", "peak_device_bytes", "incremental", "stream",
"finality", "lint", "mc", "scale_audit"}``: ``value`` is the warm batch
``run_consensus`` throughput on BASELINE config 3 (64 members, 10 000
events), ``vs_baseline`` its ratio to the oracle over the same machine's
host, ``phases`` the seconds and per-phase memory peaks
(``mem_<phase>_host_peak_bytes`` from tracemalloc,
``mem_<phase>_device_peak_bytes`` from the card's caching allocator).
``--stream`` runs BASELINE config 5 (256 members, 100 000 events) through
the slab-store streaming driver under a tile budget, ``--mesh D`` with the
window row-sharded over a ``D``-rank process group.  The other modes stamp
the adversary overhead, dynamic-membership churn, the real-process cluster
and the production-day soak.  ``python -m tpu_swirld_torch.bench_compare
OLD NEW`` gates two such lines.

No probe and no fallback: ``--device`` defaults to ``cuda``, and without a
card the run exits 2 with a message.  ``--device cpu`` runs the plain
PyTorch versions on the CPU (what the tests do); nothing runs there unless
asked for.

Environment knobs (read when a mode starts; defaults as the reference's):
    BENCH_MEMBERS (64)  BENCH_EVENTS (10000)  BENCH_ORACLE_EVENTS (10000)
    BENCH_MEM (1) -- 0 turns off the host (tracemalloc) monitor.
    BENCH_INC_CHUNK (1000) -- incremental ingest chunk; 0 drops that section.
    BENCH_STREAM_MEMBERS (256)  BENCH_STREAM_EVENTS (100000)
    BENCH_STREAM_CHUNK (2048)  BENCH_STREAM_ORACLE (12000)
    BENCH_STREAM_PROFILE (3 x chunk) -- the profiled passes' events; 0 drops them.
    BENCH_DEFAULT_STREAM_MEMBERS (48)  BENCH_DEFAULT_STREAM_EVENTS (6000)
    BENCH_DEFAULT_STREAM_CHUNK (1024) -- the default run's streaming leg
      (0 events drops it); fusion and decode overlap via SWIRLD_FUSE_CHUNKS /
      SWIRLD_DECODE_OVERLAP / SWIRLD_DECODE_QUEUE_DEPTH.
    BENCH_STREAM_REF (20000) -- with --mesh: the one-process run's first
      events (whole chunks) that give its events/s; BENCH_STREAM_SINGLE_EVPS
      supplies that number instead.
    BENCH_TRACE (unset) -- write the default run's span trace (JSONL; render
      with ``python -m tpu_swirld_torch.obs report``).
    BENCH_CHAOS_MEMBERS (32)  BENCH_CHAOS_EVENTS (4000)  BENCH_CHAOS_FORK_PROB (0.4)
    BENCH_CHURN_NODES (4)  BENCH_CHURN_TURNS (700)  BENCH_CHURN_SEED (0)
    BENCH_CHURN_REPACKS (30)
    BENCH_CLUSTER_NODES (5)  BENCH_CLUSTER_DURATION (6.0)  BENCH_CLUSTER_RATE (300)
    BENCH_CLUSTER_TX_BYTES (64)  BENCH_CLUSTER_SEED (9)
    BENCH_SOAK_NODES (4)  BENCH_SOAK_HORIZON (8.0)  BENCH_SOAK_RATE (150)
    BENCH_SOAK_CLIENTS (3)  BENCH_SOAK_SEED (3)
The reference's TPU probe knobs (``BENCH_TPU_PROBE_*``, ``BENCH_FORCE_CPU``)
have no counterpart, and ``BENCH_COMPILE_CACHE`` (a jit cache) none either:
the port compiles no graph, and ``stream.compile_cache`` says whether every
kernel library was built before the run.

In-process callers (``chip_smoke.py``) set knobs with :func:`knobs` and
call a ``run_*`` function, which returns ``(out, rc, detail)``: the JSON
object, the exit code and what the caller may check beyond the line
(the decided output's digests, the cluster verdicts); ``stamps=`` hands
in the ``lint`` / ``mc`` / ``scale_audit`` stamps already computed.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import struct
import sys
import time

STAMP_KEYS = ("lint", "mc", "scale_audit")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _float(name: str, default: float) -> float:
    return float(os.environ.get(name, str(default)))


@contextlib.contextmanager
def knobs(**values):
    """Set ``BENCH_*`` knobs for an in-process run, restored after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ----------------------------------------------------------------- stamps

_PKG = os.path.dirname(os.path.abspath(__file__))


def lint_stamp():
    """The invariant linter's summary over the port's package:
    ``bench_compare`` refuses an artifact whose tree had findings."""
    try:
        from tpu_swirld_torch.analysis.lint import lint_paths, lint_summary

        return lint_summary(lint_paths([_PKG]))
    except Exception as exc:   # the stamp must never sink a bench run
        return {"error": repr(exc)}


def mc_stamp():
    """The model checker's smoke verdict (the small world explored
    exhaustively under the invariant catalog)."""
    try:
        from tpu_swirld_torch.analysis.mc.cli import mc_smoke

        return mc_smoke()
    except Exception as exc:   # the stamp must never sink a bench run
        return {"error": repr(exc)}


def scale_audit_stamp():
    """The scale-envelope audit's verdict at the ``baseline`` envelope
    (no wrap, no out-of-bounds read, no lossy cast, no sentinel collision
    in the stage bodies); ``bench_compare`` refuses one dirty or missing."""
    try:
        from tpu_swirld_torch.analysis.flow.audit import scale_audit_stamp as stamp

        return stamp("baseline")
    except Exception as exc:   # the stamp must never sink a bench run
        return {"error": repr(exc)}


def collect_stamps() -> dict:
    return {"lint": lint_stamp(), "mc": mc_stamp(), "scale_audit": scale_audit_stamp()}


def _stamp(out: dict, stamps) -> dict:
    out.update(stamps if stamps is not None else collect_stamps())
    return out


# ---------------------------------------------------------------- helpers


def _device(device):
    """The resolved torch device (its type is the metric's platform word),
    the kernels built first on a card, and whether every kernel library was
    built before this run."""
    from tpu_swirld_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        import torch

        from tpu_swirld_torch.gpu import build

        t0 = time.time()
        built = build.build_all()
        log(f"[env] platform=cuda devices={torch.cuda.device_count()} "
            f"({torch.cuda.get_device_name(dev)}); built {built or 'nothing'} "
            f"in {time.time() - t0:.1f}s")
        return dev, not built
    log("[env] platform=cpu (the plain PyTorch versions)")
    return dev, True


def _mem_monitor(dev):
    from tpu_swirld_torch.obs import MemoryMonitor

    return MemoryMonitor(enable_host=os.environ.get("BENCH_MEM", "1") != "0",
                         device=dev)


def result_digests(event_id, result) -> dict:
    """SHA-256 digests of a decided output: the order (concatenated event
    ids), ``round`` and ``round_received`` (little-endian int32) and
    ``famous`` (sorted (event index, fame) items, fame -1 when undecided)."""
    import numpy as np

    def h(b: bytes) -> str:
        return hashlib.sha256(b).hexdigest()

    fam = b"".join(
        struct.pack("<ib", k, -1 if v is None else int(v))
        for k, v in sorted(result.famous.items())
    )
    return {
        "order": h(b"".join(event_id(i) for i in result.order)),
        "round": h(np.asarray(result.round, "<i4").tobytes()),
        "famous": h(fam),
        "round_received": h(np.asarray(result.round_received, "<i4").tobytes()),
    }


def _oracle(members, keys):
    from tpu_swirld_torch.oracle.node import Node

    return Node(sk=keys[0][1], pk=members[0], network={}, members=members,
                clock=lambda: 0, create_genesis=False)


# ------------------------------------------------------------ default mode


def run_default(device="cuda", stamps=None):
    """Config 3 through the oracle prefix, the batch ``run_consensus``, the
    incremental driver and the scaled-down streaming leg."""
    dev, _warm = _device(device)

    from tpu_swirld_torch import obs as obslib
    from tpu_swirld_torch.gpu.pipeline import run_consensus
    from tpu_swirld_torch.metrics import Metrics
    from tpu_swirld_torch.obs.finality import FinalityTracker, record_batch_result
    from tpu_swirld_torch.packing import pack_events
    from tpu_swirld_torch.sim import generate_gossip_dag

    members_n = _int("BENCH_MEMBERS", 64)
    n_events = _int("BENCH_EVENTS", 10000)
    oracle_events = _int("BENCH_ORACLE_EVENTS", 10000)
    inc_chunk = _int("BENCH_INC_CHUNK", 1000)
    ds_members = _int("BENCH_DEFAULT_STREAM_MEMBERS", 48)
    ds_events = _int("BENCH_DEFAULT_STREAM_EVENTS", 6000)
    ds_chunk = _int("BENCH_DEFAULT_STREAM_CHUNK", 1024)

    # one Obs for the whole bench: depth-0 spans are the published phases;
    # the first pipeline run executes under it (stage attribution), the
    # steady run is spanned but not ambient, so no stage sync perturbs it
    o = obslib.Obs()
    mon = _mem_monitor(dev)

    t0 = time.time()
    with o.tracer.span("gossip_gen"), mon.phase("gossip_gen"):
        members, stake, events, keys = generate_gossip_dag(members_n, n_events, seed=1)
    log(f"[gen] {members_n} members / {n_events} events in {time.time()-t0:.1f}s")

    # ---- the oracle's batch pass over a prefix: the denominator ----
    n_oracle = min(oracle_events, n_events)
    node = _oracle(members, keys)
    new_ids = [ev.id for ev in events[:n_oracle] if node.add_event(ev)]
    node.metrics = Metrics(registry=o.registry)
    t0 = time.time()
    with o.tracer.span("oracle"), mon.phase("oracle"):
        node.consensus_pass(new_ids)
    t_oracle = time.time() - t0
    oracle_evps = n_oracle / t_oracle
    log(f"[oracle] {n_oracle} events in {t_oracle:.2f}s = {oracle_evps:.0f} ev/s "
        f"(ordered {len(node.consensus)}, max_round {node.max_round})")
    fin_oracle = FinalityTracker("oracle", registry=o.registry)
    for eid in node.consensus:
        fin_oracle.record_decided(eid, node.round[eid], node.round_received[eid],
                                  birth=0.0, now=t_oracle)
    finality = {"oracle": fin_oracle.summary()}

    # ---- the batch pipeline on the card, parity on the oracle prefix ----
    t0 = time.time()
    with o.tracer.span("pack"), mon.phase("pack"):
        packed_prefix = pack_events(events[:n_oracle], members, stake)
        packed_full = pack_events(events, members, stake)
    log(f"[pack] {time.time()-t0:.2f}s")
    if n_oracle == n_events:
        packed_prefix = packed_full
    res_prefix = run_consensus(packed_prefix, node.config, device=dev)
    parity = (
        [packed_prefix.ids[i] for i in res_prefix.order] == node.consensus
        and all(res_prefix.round[i] == node.round[e]
                for i, e in enumerate(node.order_added))
    )
    log(f"[parity] prefix ({n_oracle} ev) order+rounds identical: {parity}")

    t0 = time.time()
    with obslib.enabled(o):
        with o.tracer.span("pipeline_first"), mon.phase("pipeline_first"):
            res = run_consensus(packed_full, node.config, device=dev)
    t_first = time.time() - t0
    t0 = time.time()
    with o.tracer.span("pipeline"), mon.phase("pipeline"):
        res = run_consensus(packed_full, node.config, device=dev)
    t_steady = time.time() - t0
    pipe_evps = n_events / t_steady
    log(f"[pipeline] first {t_first:.2f}s, steady {t_steady:.2f}s = "
        f"{pipe_evps:.0f} ev/s (ordered {len(res.order)}, max_round {res.max_round})")
    fin_batch = FinalityTracker("batch", registry=o.registry)
    record_batch_result(fin_batch, res, now=t_steady, birth=0.0)
    finality["batch"] = fin_batch.summary()
    detail = {"digests": result_digests(lambda i: packed_full.ids[i], res)}

    inc_out = None
    if inc_chunk > 0:
        inc_out, finality["incremental"] = _incremental_leg(
            members, stake, node.config, events, inc_chunk, res, pipe_evps,
            dev, o, mon)
    stream_out = None
    if ds_events > 0:
        stream_out = _default_stream_leg(ds_members, ds_events, ds_chunk, dev, o, mon)

    phases = {k: round(v, 4) for k, v in o.tracer.phase_seconds().items()}
    if inc_out is not None:
        phases["incremental_window_size"] = inc_out["window_size"]
        phases["incremental_pruned_prefix"] = inc_out["pruned_prefix"]
    phases.update(mon.flat())
    log(f"[phases] {json.dumps(phases)}")
    trace_path = os.environ.get("BENCH_TRACE")
    if trace_path:
        o.save(trace_path)
        log(f"[trace] wrote {trace_path} "
            f"(render: python -m tpu_swirld_torch.obs report {trace_path})")

    out = {
        "metric": (f"events/sec to consensus-order @{n_events} events x {members_n} "
                   f"members ({dev.type}); order parity={parity}"),
        "value": round(pipe_evps, 1),
        "unit": "events/s",
        "vs_baseline": round(pipe_evps / oracle_evps, 2),
        "phases": phases,
        "peak_host_bytes": mon.peak_host_bytes,
        "peak_device_bytes": mon.peak_device_bytes,
    }
    if inc_out is not None:
        out["incremental"] = inc_out
    if stream_out is not None:
        out["stream"] = stream_out
    out["finality"] = {
        eng: {k: (round(v, 6) if isinstance(v, float) else v) for k, v in s.items()}
        for eng, s in finality.items()
    }
    log(f"[finality] {json.dumps(out['finality'])}")
    mon.close()         # before the stamps: no tracemalloc under the audits
    _stamp(out, stamps)
    ok = parity and (inc_out is None or inc_out["parity"]) \
        and (stream_out is None or stream_out["parity"])
    return out, 0 if ok else 1, detail


def _incremental_leg(members, stake, config, events, chunk, res, pipe_evps, dev, o, mon):
    """The incremental driver over the same events in ``chunk``-event
    ingests; steady events/s over the back half of the passes."""
    from tpu_swirld_torch.gpu.incremental import IncrementalConsensus
    from tpu_swirld_torch.obs.finality import FinalityTracker

    inc = IncrementalConsensus(members, stake, config, device=dev)
    inc.finality = FinalityTracker("incremental", clock=time.perf_counter,
                                   registry=o.registry)
    pass_stats = []
    with o.tracer.span("pipeline_incremental"), mon.phase("pipeline_incremental"):
        for i in range(0, len(events), chunk):
            t0 = time.time()
            st = inc.ingest(events[i : i + chunk])
            dt = time.time() - t0
            pass_stats.append((dt, st))
            mon.sample("pipeline_incremental")
            log(f"[inc] pass {len(pass_stats)-1}: {st['new_events']} ev in {dt:.3f}s = "
                f"{st['new_events']/dt:.0f} ev/s window={st['window_size']} "
                f"pruned={st['pruned_prefix']}{' REBASE' if st['rebased'] else ''}")
    inc_res = inc.result()
    inc_parity = inc_res.order == res.order and list(inc_res.round) == list(res.round)
    steady_half = pass_stats[len(pass_stats) // 2 :]
    warmed_up = len(steady_half) >= 2 and not any(s["rebased"] for _dt, s in steady_half)
    if not warmed_up:
        log(f"[inc] too few passes to reach steady state ({len(pass_stats)} total) -- "
            "ratio not meaningful; lower BENCH_INC_CHUNK or raise BENCH_EVENTS")
    ev_steady = sum(s["new_events"] for _dt, s in steady_half)
    t_inc = sum(dt for dt, _s in steady_half)
    inc_evps = ev_steady / t_inc if (t_inc and warmed_up) else 0.0
    ratio = inc_evps / pipe_evps if pipe_evps else 0.0
    log(f"[inc] steady {inc_evps:.0f} ev/s vs warm full-recompute pass "
        f"{pipe_evps:.0f} ev/s -> first-vs-steady ratio {ratio:.2f}x "
        f"(parity={inc_parity}, rebases={inc.rebases})")
    return {
        "chunk": chunk,
        "passes": inc.passes,
        "rebases": inc.rebases,
        "full_pass_evps": round(pipe_evps, 1),
        "steady_evps": round(inc_evps, 1),
        "first_vs_steady": round(ratio, 2),
        "window_size": inc.window_size,
        "pruned_prefix": inc.pruned_prefix,
        "parity": bool(inc_parity),
    }, inc.finality.summary()


def _default_stream_leg(n_members, n_events, chunk, dev, o, mon):
    """The default run's streaming leg: gossip in batches of 4 ingest
    chunks, one timed untraced pass, one pass under the dispatch profiler
    on the warm caches, parity against the batch pipeline."""
    from tpu_swirld_torch import obs as obslib
    from tpu_swirld_torch.config import SwirldConfig, resolve_stream_settings
    from tpu_swirld_torch.gpu.pipeline import run_consensus
    from tpu_swirld_torch.obs.profile import DispatchProfiler
    from tpu_swirld_torch.packing import pack_events
    from tpu_swirld_torch.sim import stream_gossip_dag
    from tpu_swirld_torch.store import StreamingConsensus

    cfg = SwirldConfig(n_members=n_members)
    members, stake, _keys, chunks = stream_gossip_dag(n_members, n_events, 4 * chunk,
                                                      seed=1)
    chunks = list(chunks)
    events = [ev for ch in chunks for ev in ch]
    packed = pack_events(events, members, stake)
    with o.tracer.span("stream_default_ref"), mon.phase("stream_default_ref"):
        ref = run_consensus(packed, cfg, device=dev)
    settings = resolve_stream_settings(cfg)

    def one_pass(profiler):
        eng = StreamingConsensus(members, stake, cfg, ingest_chunk=chunk,
                                 window_bucket=2048, prune_min=1024, device=dev)
        t0 = time.time()
        with (obslib.enabled(obslib.Obs(profiler=profiler)) if profiler is not None
              else contextlib.nullcontext()):
            for ch in chunks:
                eng.ingest(ch)
        dt = time.time() - t0
        eng.store.close()
        return eng, dt

    with o.tracer.span("stream_default"), mon.phase("stream_default"):
        eng, t_s = one_pass(None)
    prof = DispatchProfiler()
    with o.tracer.span("stream_default_profile"), mon.phase("stream_default_profile"):
        one_pass(prof)
    res = eng.result()
    got = [eng.packer.event_id(i) for i in res.order]
    want = [packed.ids[i] for i in ref.order]
    ref_round = {packed.ids[i]: int(ref.round[i]) for i in range(len(events))}
    parity = got == want and all(
        int(res.round[i]) == ref_round[eng.packer.event_id(i)] for i in range(len(events))
    )
    dispatch = prof.summary()
    evps = n_events / t_s
    log(f"[stream-default] {n_events} ev x {n_members} members in {t_s:.2f}s = "
        f"{evps:.0f} ev/s fuse={settings['fuse_chunks']} "
        f"decode_overlap={settings['decode_overlap']} "
        f"dispatch_overhead={dispatch['dispatch_overhead_s']:.3f}s "
        f"fused_dispatches={dispatch['fused_dispatches']} parity={parity}")
    return {
        "evps": round(evps, 1),
        "dispatch_overhead_s": dispatch["dispatch_overhead_s"],
        "members": n_members,
        "events": n_events,
        "chunk": chunk,
        "fuse_chunks": settings["fuse_chunks"],
        "decode_overlap": settings["decode_overlap"],
        "decoded_off_thread": eng.decoded_off_thread,
        "ordered": len(res.order),
        "parity": bool(parity),
        "profile": dispatch,
    }


# ------------------------------------------------------------- stream mode


def _stream_settings(tile_budget, tile, device_tile_budget) -> dict:
    from tpu_swirld_torch import crypto

    return {
        "members": _int("BENCH_STREAM_MEMBERS", 256),
        "events": _int("BENCH_STREAM_EVENTS", 100000),
        "chunk": _int("BENCH_STREAM_CHUNK", 2048),
        "tile_budget": tile_budget, "tile": tile,
        "device_tile_budget": device_tile_budget,
        "signer": crypto.backend_name(),
    }


def _stream_pass(s, dev, *, mesh=None, on_chunk=None, mon=None, quiet=False) -> dict:
    """One streaming driver over the config-5 stream, the generator consumed
    inside the timed loop (the reference's rule): ``mesh`` a group mesh
    row-shards the window over its ranks.  Returns the driver, its result,
    the events and seconds (and each chunk's), its digests, store stats,
    counters, overlap ratio and finality summary."""
    from tpu_swirld_torch.config import SwirldConfig
    from tpu_swirld_torch.obs.finality import FinalityTracker
    from tpu_swirld_torch.sim import stream_gossip_dag

    cfg = SwirldConfig(n_members=s["members"])
    members, stake, keys, chunks = stream_gossip_dag(s["members"], s["events"], s["chunk"],
                                                     seed=1)
    kw = dict(tile_budget=s["tile_budget"], tile=s["tile"], ingest_chunk=s["chunk"],
              window_bucket=2048, prune_min=1024, device=dev)
    if mesh is not None:
        from tpu_swirld_torch.parallel import MeshStreamingConsensus

        inc = MeshStreamingConsensus(mesh, members, stake, cfg,
                                     device_tile_budget=s["device_tile_budget"], **kw)
    else:
        from tpu_swirld_torch.store import StreamingConsensus

        inc = StreamingConsensus(members, stake, cfg, **kw)
    # births at chunk ingest, decided at the ordering pass
    inc.finality = FinalityTracker("streaming", clock=time.perf_counter)
    n_done, times = 0, []
    t_all = time.time()
    for chunk in chunks:
        if on_chunk is not None:
            on_chunk(n_done, chunk)
        t0 = time.time()
        st = inc.ingest(chunk)
        dt = time.time() - t0
        times.append((len(chunk), dt))
        n_done += len(chunk)
        if mon is not None:
            mon.sample("stream")
        if not quiet:
            log(f"[stream] {n_done}/{s['events']}: {len(chunk)} ev in {dt:.2f}s = "
                f"{len(chunk)/dt:.0f} ev/s window={st['window_size']} "
                f"pruned={st['pruned_prefix']} resident={st['resident_bytes']/1e6:.0f}MB "
                f"archived={st['archived_rows']}{' REBASE' if st['rebased'] else ''}")
    seconds = time.time() - t_all
    # the share of the stream's wall not blocked behind the archive's
    # spill queue (read before close(): the final flush is off the clock)
    stall = inc.store.archive.stall_seconds
    res = inc.result()
    inc.store.close()
    return {
        "cfg": cfg, "members": members, "stake": stake, "keys": keys, "result": res,
        "events": n_done, "seconds": seconds, "times": times,
        "overlap": max(0.0, min(1.0, (seconds - stall) / seconds)),
        "order": [inc.packer.event_id(i) for i in res.order],
        "digests": result_digests(inc.packer.event_id, res),
        "stats": inc.store.stats(),
        "counters": {k: getattr(inc, k) for k in (
            "window_size", "pruned_prefix", "widen_rebases", "full_rebases", "repins")
            if hasattr(inc, k)},
        "finality": inc.finality.summary(),
    }


def stream_group_rank(mesh, s: dict) -> dict:
    """A rank of ``--stream --mesh D``: the stream (made on every rank from
    its seed) through the streaming driver row-sharded over the group.
    Its ``digest`` must be equal on every rank."""
    import torch

    from tpu_swirld_torch import crypto

    crypto.set_backend(s["signer"])
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    run = _stream_pass(s, mesh.device, mesh=mesh, quiet=True)
    res = run.pop("result")
    for k in ("cfg", "members", "stake", "keys"):
        run.pop(k)
    run["round"] = [int(r) for r in res.round]
    run["ordered"], run["max_round"] = len(res.order), int(res.max_round)
    run["peak_device_bytes"] = (int(torch.cuda.max_memory_allocated(mesh.device))
                                if cuda else 0)
    run["digest"] = json.dumps(run["digests"], sort_keys=True)
    return run


def _group_peak(out: dict, ranks) -> None:
    """``--stream --mesh D``: the line's device peak, and the ``stream``
    phase's, are the largest rank's.  The ranks run in their own processes,
    so this process's allocator saw only the one-process pass (its own
    ``stream_single_ref`` phase) and the oracle's."""
    peak = max(rep["result"]["peak_device_bytes"] for rep in ranks)
    out["peak_device_bytes"] = peak
    out["phases"]["mem_stream_device_peak_bytes"] = peak


def run_stream(tile_budget=65536, tile=256, mesh_n=0, device_tile_budget=None, *,
               device="cuda", stamps=None):
    """BASELINE config 5 under a resident tile budget (``None`` = account
    only), its decided prefix held to the oracle's over the first
    ``BENCH_STREAM_ORACLE`` events.  ``mesh_n > 0`` row-shards the window
    over a group of ``mesh_n`` ranks (:mod:`tpu_swirld_torch.multichip`: a
    card a rank over nccl when the host has that many, else gloo ranks
    sharing the card), then runs the one-process driver, whose digests
    every rank's must equal and whose first ``BENCH_STREAM_REF`` events give
    ``single_evps``."""
    import torch

    from tpu_swirld_torch import obs as obs_mod
    from tpu_swirld_torch.obs.profile import DispatchProfiler
    from tpu_swirld_torch.sim import stream_gossip_dag
    from tpu_swirld_torch.store import StreamingConsensus

    dev, warm = _device(device)
    s = _stream_settings(tile_budget, tile, device_tile_budget)
    n_oracle = min(_int("BENCH_STREAM_ORACLE", 12000), s["events"])
    log(f"[env] stream {s['members']}x{s['events']} chunk={s['chunk']} "
        f"tile_budget={tile_budget} tile={tile}"
        + (f" mesh={mesh_n} device_tile_budget={device_tile_budget}" if mesh_n else ""))
    mon = _mem_monitor(dev)
    oracle_buf = []

    def keep_prefix(n_done, chunk):
        if n_done < n_oracle:
            oracle_buf.extend(chunk[: n_oracle - n_done])

    if mesh_n:
        from tpu_swirld_torch import multichip

        backend = ("nccl" if dev.type == "cuda" and torch.cuda.device_count() >= mesh_n
                   else "gloo")
        with mon.phase("stream"):
            ranks = multichip.launch(stream_group_rank, mesh_n, args=(s,), device=dev.type,
                                     backend=backend, timeout=3600.0)
        run = ranks[0]["result"]
        for r, rep in enumerate(ranks):
            rr = rep["result"]
            log(f"[mesh] rank {r} on {rep['device']} ({backend}): {rr['events']} ev in "
                f"{rr['seconds']:.1f}s, ordered {rr['ordered']}, peak device bytes "
                f"{rr['peak_device_bytes']}, counters {json.dumps(rr['counters'])}, "
                f"launches {json.dumps(rep['launches'])}")
        with mon.phase("stream_single_ref"):
            single = _stream_pass(s, dev, on_chunk=keep_prefix, quiet=True)
        same = all(rep["result"]["digests"] == single["digests"] for rep in ranks)
        log(f"[mesh] one process: {single['events']} ev in {single['seconds']:.1f}s; "
            f"every rank's digests equal to its: {same}")
        rounds = run["round"]
    else:
        with mon.phase("stream"):
            run = single = _stream_pass(s, dev, on_chunk=keep_prefix, mon=mon)
        rounds = [int(r) for r in run["result"].round]
        run["ordered"], run["max_round"] = len(run["order"]), int(run["result"].max_round)
    n_done, t_stream = run["events"], run["seconds"]
    stream_evps = n_done / t_stream
    stats, counters = run["stats"], run["counters"]
    log(f"[stream] {n_done} ev in {t_stream:.1f}s = {stream_evps:.0f} ev/s; ordered "
        f"{run['ordered']}, max_round {run['max_round']}, pruned "
        f"{counters['pruned_prefix']}, window {counters['window_size']}, overlap "
        f"{run['overlap']:.3f}")
    log(f"[digests] {json.dumps(run['digests'], sort_keys=True)}")

    oracle = _oracle(single["members"], single["keys"])
    with mon.phase("oracle_subsample"):
        new_ids = [ev.id for ev in oracle_buf if oracle.add_event(ev)]
        oracle.consensus_pass(new_ids)
    order_parity = run["order"][: len(oracle.consensus)] == oracle.consensus
    round_parity = all(rounds[i] == oracle.round[eid]
                       for i, eid in enumerate(oracle.order_added))
    parity = order_parity and round_parity
    log(f"[parity] oracle prefix {n_oracle} ev, decided {len(oracle.consensus)}: "
        f"order={order_parity} rounds={round_parity}")

    budget_ok = tile_budget is None or stats["peak_resident_tiles"] <= tile_budget
    dev_budget_ok = (device_tile_budget is None
                     or stats["peak_device_tiles"] <= device_tile_budget)
    log(f"[store] {json.dumps(stats)} budget_ok={budget_ok}"
        + (f" dev_budget_ok={dev_budget_ok}" if mesh_n else ""))

    # the dispatch profile: two one-process passes over the stream's first
    # events on the warm caches, untraced then under the profiler; their
    # difference is the tracing's own cost
    profile_events = _int("BENCH_STREAM_PROFILE", 3 * s["chunk"])
    dispatch_out = None
    if profile_events:
        profile_events = min(profile_events, s["events"])

        def profile_pass(enabled_obs):
            _m3, _s3, _k3, prof_chunks = stream_gossip_dag(s["members"], profile_events,
                                                           s["chunk"], seed=1)
            eng = StreamingConsensus(single["members"], single["stake"], single["cfg"],
                                     tile_budget=tile_budget, tile=tile,
                                     ingest_chunk=s["chunk"], window_bucket=2048,
                                     prune_min=1024, device=dev)
            t0 = time.time()
            with (obs_mod.enabled(enabled_obs) if enabled_obs is not None
                  else contextlib.nullcontext()):
                for chunk in prof_chunks:
                    eng.ingest(chunk)
            dt = time.time() - t0
            eng.store.close()
            return dt

        with mon.phase("stream_profile"):
            t_plain = profile_pass(None)
            prof = DispatchProfiler()
            t_prof = profile_pass(obs_mod.Obs(profiler=prof))
        overhead_ratio = max(0.0, (t_prof - t_plain) / t_plain)
        dispatch_out = prof.summary()
        dispatch_out["profiled_events"] = profile_events
        dispatch_out["plain_s"] = round(t_plain, 6)
        dispatch_out["profiled_s"] = round(t_prof, 6)
        dispatch_out["trace_overhead_ratio"] = round(overhead_ratio, 4)
        top = ", ".join(f"{t['stage']}={t['seconds']:.3f}s/{t['calls']}x"
                        for t in dispatch_out["top_stages"])
        log(f"[dispatch] {profile_events} ev profiled: wall={dispatch_out['wall_s']:.3f}s "
            f"stage={dispatch_out['stage_s']:.3f}s "
            f"overhead={dispatch_out['dispatch_overhead_s']:.3f}s "
            f"h2d={dispatch_out['transfers_bytes']['h2d']} "
            f"d2h={dispatch_out['transfers_bytes']['d2h']} top[{top}] "
            f"trace_overhead={overhead_ratio:.1%}")

    mesh_out = None
    if mesh_n:
        single_evps = float(os.environ.get("BENCH_STREAM_SINGLE_EVPS", "0") or 0)
        ref_events, ref_used = _int("BENCH_STREAM_REF", 20000), 0
        if not single_evps and ref_events:
            n, t = 0, 0.0
            for k, dt in single["times"]:
                if n >= ref_events:
                    break
                n, t = n + k, t + dt
            single_evps, ref_used = n / t, n
        speedup = stream_evps / single_evps if single_evps else 0.0
        log(f"[mesh] {mesh_n} ranks: {stream_evps:.0f} ev/s against one process's "
            f"{single_evps:.0f} ev/s over its first {ref_used} events (no speed is claimed "
            f"for a group: ranks that share a card)")
        mesh_out = {
            "devices": mesh_n,
            "evps": round(stream_evps, 1),
            "single_evps": round(single_evps, 1),
            "single_ref_events": ref_used,
            "speedup_vs_single": round(speedup, 3),
            "scaling_efficiency": round(speedup / mesh_n, 4),
            "peak_device_tiles": stats["peak_device_tiles"],
            "device_tile_budget": device_tile_budget,
            "device_budget_ok": bool(dev_budget_ok),
            "device_resident_tiles": stats["device_resident_tiles"],
            "peak_resident_tiles": stats["peak_resident_tiles"],
            "budget_overruns": stats["budget_overruns"],
            "repins": counters["repins"],
            "parity": bool(parity and same),
        }

    out = {
        "metric": (f"streaming events/sec to consensus-order @{n_done} events x "
                   f"{s['members']} members ({dev.type}, config-5 shape, tile budget "
                   f"{tile_budget}); oracle-prefix parity={parity}"),
        "value": round(stream_evps, 1),
        "unit": "events/s",
        "vs_baseline": 0.0,
        "phases": mon.flat(),
        "peak_host_bytes": mon.peak_host_bytes,
        "peak_device_bytes": mon.peak_device_bytes,
        "stream": {
            "evps": round(stream_evps, 1),
            "overlap_ratio": round(run["overlap"], 4),
            "spill_pack_seconds": stats["spill_pack_seconds"],
            "spill_stall_seconds": stats["spill_stall_seconds"],
            "spill_queue_depth_peak": stats["spill_queue_depth_peak"],
            "members": s["members"],
            "events": n_done,
            "chunk": s["chunk"],
            "tile": tile,
            "tile_budget": tile_budget,
            "budget_ok": bool(budget_ok),
            "ordered": run["ordered"],
            "max_round": run["max_round"],
            "window_size": counters["window_size"],
            "pruned_prefix": counters["pruned_prefix"],
            "peak_resident_visibility_bytes": stats["peak_resident_bytes"],
            "peak_resident_tiles": stats["peak_resident_tiles"],
            "archived_rows": stats["archived_rows"],
            "archive_bytes": stats["archive_bytes"],
            "widen_rebases": counters["widen_rebases"],
            "full_rebases": counters["full_rebases"],
            "oracle_prefix": n_oracle,
            "oracle_decided": len(oracle.consensus),
            "compile_cache": bool(warm),
            "parity": bool(parity),
            "dispatch_overhead_s": (dispatch_out["dispatch_overhead_s"]
                                    if dispatch_out is not None else None),
            "trace_overhead_ratio": (dispatch_out["trace_overhead_ratio"]
                                     if dispatch_out is not None else None),
            "dispatch": dispatch_out,
        },
        "finality": {
            "streaming": {k: (round(v, 6) if isinstance(v, float) else v)
                          for k, v in run["finality"].items()},
        },
    }
    log(f"[finality] {json.dumps(out['finality'])}")
    if mesh_out is not None:
        _group_peak(out, ranks)
        out["stream_mesh"] = mesh_out
        out["metric"] = out["metric"].replace(
            "streaming events/sec", f"mesh-streaming ({mesh_n} dev) events/sec")
    mon.close()
    _stamp(out, stamps)
    ok = parity and budget_ok and dev_budget_ok and (mesh_out is None or mesh_out["parity"])
    return out, 0 if ok else 1, {"digests": run["digests"], "stats": stats}


# ------------------------------------------------------- the other modes


def run_chaos_overhead(device="cuda", stamps=None):
    """Batch throughput under an equivocation storm at the full f budget
    against the same shape fault-free: ``chaos_overhead.{clean_evps,
    attack_evps, ratio}`` (ratio = attack / clean)."""
    dev, _warm = _device(device)

    from tpu_swirld_torch.config import SwirldConfig
    from tpu_swirld_torch.gpu.pipeline import run_consensus
    from tpu_swirld_torch.packing import pack_events
    from tpu_swirld_torch.sim import generate_gossip_dag

    n_members = _int("BENCH_CHAOS_MEMBERS", 32)
    n_events = _int("BENCH_CHAOS_EVENTS", 4000)
    fork_prob = _float("BENCH_CHAOS_FORK_PROB", 0.4)
    f_budget = (n_members - 1) // 3
    config = SwirldConfig(n_members=n_members)
    legs, detail = {}, {}
    for leg, n_forkers in (("clean", 0), ("attack", f_budget)):
        t0 = time.time()
        members, stake, events, _keys = generate_gossip_dag(
            n_members, n_events, seed=2, n_forkers=n_forkers,
            fork_prob=fork_prob if n_forkers else 0.0,
        )
        packed = pack_events(events, members, stake)
        log(f"[{leg}] {n_members} members / {len(events)} events, "
            f"{int(packed.fork_pairs.shape[0])} fork pairs ({time.time()-t0:.1f}s gen+pack)")
        run_consensus(packed, config, device=dev)          # warm
        t0 = time.time()
        res = run_consensus(packed, config, device=dev)
        dt = time.time() - t0
        legs[leg] = {
            "evps": round(len(events) / dt, 1),
            "fork_pairs": int(packed.fork_pairs.shape[0]),
            "overflow_retries": int(res.timings.get("overflow_retries", 0)),
        }
        detail[leg] = result_digests(lambda i: packed.ids[i], res)
        log(f"[{leg}] {legs[leg]['evps']:.0f} ev/s")
    out = {
        "metric": "chaos_overhead_evps",
        "value": legs["attack"]["evps"],
        "unit": "events/sec",
        "platform": dev.type,
        "chaos_overhead": {
            "clean_evps": legs["clean"]["evps"],
            "attack_evps": legs["attack"]["evps"],
            "ratio": round(legs["attack"]["evps"] / legs["clean"]["evps"], 4),
            "n_members": n_members,
            "n_events": n_events,
            "n_forkers": f_budget,
            "fork_prob": fork_prob,
            "fork_pairs": legs["attack"]["fork_pairs"],
            "overflow_retries": legs["attack"]["overflow_retries"],
        },
    }
    return _stamp(out, stamps), 0, {"digests": detail}


def run_churn(device="cuda", stamps=None):
    """A decided leave then a decided join through the epoch-aware
    incremental driver, timed end to end, and the member-axis repack's p99
    over fresh packers; exit 1 below 3 epochs."""
    dev, _warm = _device(device)

    from tpu_swirld_torch.membership.engine import run_dynamic
    from tpu_swirld_torch.membership.repack import repack_packer
    from tpu_swirld_torch.membership.sim import churn_schedule
    from tpu_swirld_torch.packing import Packer

    n_nodes = _int("BENCH_CHURN_NODES", 4)
    turns = _int("BENCH_CHURN_TURNS", 700)
    seed = _int("BENCH_CHURN_SEED", 0)
    n_repacks = _int("BENCH_CHURN_REPACKS", 30)
    t0 = time.time()
    events, members, stake, _sim = churn_schedule(n_nodes, seed=seed, turns=turns)
    log(f"[churn] {n_nodes} members / {len(events)} events ({time.time()-t0:.1f}s gossip gen)")
    run_dynamic(events, members, stake, engine="incremental", chunk=64, device=dev)
    t0 = time.time()
    res = run_dynamic(events, members, stake, engine="incremental", chunk=64, device=dev)
    dt = time.time() - t0
    evps = len(events) / dt
    log(f"[churn] {evps:.0f} ev/s, {res.epochs} epochs, {res.restatements} restatements, "
        f"{len(res.order)} decided")
    samples, outputs = [], []
    for _ in range(max(1, n_repacks)):
        packer = Packer(list(members), list(stake))
        for epoch in res.ledger.epochs[1:]:
            samples.append(repack_packer(packer, epoch, device=dev,
                                         outputs=outputs).seconds)
    samples.sort()
    p99 = samples[min(len(samples) - 1, int(len(samples) * 0.99))]
    log(f"[churn] repack p99 {p99*1e3:.2f} ms over {len(samples)} samples")
    out = {
        "metric": "churn_evps",
        "value": round(evps, 1),
        "unit": "events/sec through the epoch-aware driver",
        "platform": dev.type,
        "churn": {
            "evps": round(evps, 1),
            "repack_p99_s": round(p99, 6),
            "epochs": res.epochs,
            "decided": len(res.order),
            "restatements": res.restatements,
            "repack_samples": len(samples),
            "n_nodes": n_nodes,
            "turns": turns,
            "events": len(events),
        },
    }
    if res.epochs < 3:
        log(f"[churn] FAIL: schedule decided only {res.epochs} epochs (< 3)")
    devices = sorted({str(t.device) for pair in outputs for t in pair})
    return _stamp(out, stamps), 0 if res.epochs >= 3 else 1, {"result": res,
                                                                "repack_devices": devices}


def run_cluster(stamps=None, workdir=None):
    """The real-process loopback cluster: the chaos leg (a SIGKILL at 30%
    of the window, a restart at 50%) and the overload leg (admission
    window 0: every node must shed).  Host processes, as the reference's;
    exit 1 on a red verdict or zero sheds."""
    import tempfile

    from tpu_swirld_torch.net.cluster import ClusterSpec, run_cluster as _run

    n_nodes = _int("BENCH_CLUSTER_NODES", 5)
    duration = _float("BENCH_CLUSTER_DURATION", 6.0)
    rate = _float("BENCH_CLUSTER_RATE", 300)
    tx_bytes = _int("BENCH_CLUSTER_TX_BYTES", 64)
    seed = _int("BENCH_CLUSTER_SEED", 9)
    net = {"gossip_interval_s": 0.005, "checkpoint_every_s": 0.5}
    workdir = workdir or tempfile.mkdtemp(prefix="swirld-bench-cluster-")
    log(f"[cluster] {n_nodes} processes, {duration}s @ {rate} tx/s, kill -9 node 1 at "
        f"{duration * 0.3:.1f}s, restart at {duration * 0.5:.1f}s ({workdir})")
    spec = ClusterSpec(
        workdir=os.path.join(workdir, "chaos"), n_nodes=n_nodes, seed=seed,
        duration_s=duration, tx_rate=rate, tx_bytes=tx_bytes,
        kill_index=1, kill_at_s=duration * 0.3, restart_at_s=duration * 0.5,
        flightrec_dir=os.path.join(workdir, "chaos", "flightrec"), net=net,
    )
    t0 = time.perf_counter()
    verdict = _run(spec)
    walls = [time.perf_counter() - t0]
    tx = verdict["tx"]
    log(f"[cluster] ok={verdict['ok']} decided_tx={tx['decided']} "
        f"({tx['tx_per_s']:.0f} tx/s) p99={tx.get('submit_p99', float('nan')):.3f}s")
    log("[overload] 3 processes, admission window forced to 0 "
        "(every submission must shed, none may queue)")
    overload_spec = ClusterSpec(
        workdir=os.path.join(workdir, "overload"), n_nodes=3, seed=seed + 1,
        duration_s=min(duration, 3.0), tx_rate=rate, tx_bytes=tx_bytes,
        net=dict(net, max_undecided=0),
    )
    t0 = time.perf_counter()
    overload = _run(overload_spec)
    walls.append(time.perf_counter() - t0)
    shed = overload["tx"]["shed"]
    log(f"[overload] ok={overload['ok']} shed={shed} acked={overload['tx']['acked']}")
    trace = verdict.get("trace") or {}
    metrics = verdict.get("metrics") or {}
    out = {
        "metric": "cluster_tx_per_s",
        "value": tx["tx_per_s"],
        "unit": "decided tx/sec",
        "platform": "cpu-processes",
        "cluster": {
            "tx_per_s": tx["tx_per_s"],
            "submit_p50_s": tx.get("submit_p50"),
            "submit_p99_s": tx.get("submit_p99"),
            "tx_submitted": tx["submitted"],
            "tx_acked": tx["acked"],
            "tx_failed": tx["failed"],
            "tx_decided": tx["decided"],
            "n_nodes": n_nodes,
            "duration_s": duration,
            "rate": rate,
            "verdict_ok": verdict["ok"],
            "safety": verdict["safety"],
            "liveness": verdict["liveness"],
            "overload_ok": overload["ok"],
            "overload_shed": shed,
            "wal_torn_tail_recovered": verdict["counters"]["wal_torn_tail_recovered"],
            "merged_trace": trace.get("merged"),
            "cross_process_traces": trace.get("cross_process_traces"),
            "metrics_rollup": metrics.get("json"),
            "metrics_prom": metrics.get("prom"),
            "metrics_nodes_covered": metrics.get("nodes_covered"),
        },
    }
    rc = 0
    if not verdict["ok"] or not overload["ok"]:
        log("[cluster] FAIL: verdict not green")
        rc = 1
    elif shed == 0:
        log("[overload] FAIL: zero submissions shed -- backpressure is not engaging")
        rc = 1
    return _stamp(out, stamps), rc, {"verdict": verdict, "spec": spec,
                                     "overload": overload, "overload_spec": overload_spec,
                                     "seconds": walls}


def run_soak(stamps=None, workdir=None):
    """The composed production-day soak (per-link TCP fault proxies,
    heavy-tailed traffic, a crash, a partition and an equivocation storm):
    host processes, as the reference's; exit 1 on a red verdict."""
    import dataclasses
    import tempfile

    from tpu_swirld_torch import soak as _soak

    n_nodes = _int("BENCH_SOAK_NODES", 4)
    horizon = _float("BENCH_SOAK_HORIZON", 8.0)
    rate = _float("BENCH_SOAK_RATE", 150)
    clients = _int("BENCH_SOAK_CLIENTS", 3)
    seed = _int("BENCH_SOAK_SEED", 3)
    workdir = workdir or tempfile.mkdtemp(prefix="swirld-bench-soak-")
    log(f"[soak] {n_nodes} processes through per-link fault proxies, {horizon}s @ "
        f"{rate} tx/s from {clients} clients; crash + partition + equivocation storm "
        f"({workdir})")
    spec = _soak.default_spec(
        workdir, n_nodes=n_nodes, seed=seed, horizon_s=horizon, tx_rate=rate,
        n_clients=clients, net={"gossip_interval_s": 0.005, "checkpoint_every_s": 0.5},
    )
    spec = dataclasses.replace(spec, schedule=_soak.smoke_schedule(spec))
    verdict = _soak.run_soak(spec)
    log(f"[soak] ok={verdict['ok']} survived={verdict['disruptions_survived']}"
        f"/{verdict['disruptions_total']} tx/s={verdict['tx_per_s']:.0f} "
        f"submit_p99={verdict['submit_p99_s']:.3f}s "
        f"equivocations={verdict['adversary']['equivocations_detected']}")
    out = {
        "metric": "soak_tx_per_s",
        "value": verdict["tx_per_s"],
        "unit": "acked tx/sec under composed faults",
        "platform": "cpu-processes",
        "soak": {
            "tx_per_s": verdict["tx_per_s"],
            "submit_p99_s": verdict["submit_p99_s"],
            "disruptions_survived": verdict["disruptions_survived"],
            "disruptions_total": verdict["disruptions_total"],
            "verdict_ok": verdict["ok"],
            "safety": verdict["safety"],
            "finality": verdict["finality"],
            "accounting_balance_ok": verdict["accounting"].get("balance_ok"),
            "shed_rate": verdict["accounting"].get("shed_rate"),
            "net_redials": verdict["counters"]["net_redials"],
            "equivocations_detected": verdict["adversary"]["equivocations_detected"],
            "proxy_relayed": verdict["proxy"].get("relayed", 0),
            "proxy_partition_blocked": verdict["proxy"].get("partition_blocked", 0),
            "n_nodes": n_nodes,
            "horizon_s": horizon,
            "rate": rate,
        },
    }
    if not verdict["ok"]:
        log("[soak] FAIL: composite verdict not green")
    return _stamp(out, stamps), 0 if verdict["ok"] else 1, {"verdict": verdict,
                                                            "spec": spec}


# ------------------------------------------------------------ command line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; exits 2 without a card) or cpu (the "
                    "plain PyTorch versions)")
    ap.add_argument("--stream", action="store_true",
                    help="BASELINE config 5 (256 members / 100k events; "
                    "BENCH_STREAM_* overrides) through the slab-store streaming "
                    "driver under --tile-budget")
    ap.add_argument("--tile-budget", type=int, default=65536,
                    help="resident visibility tile budget for --stream (tiles of "
                    "--tile x --tile bools; default 65536 = a 4 GB bool ceiling at "
                    "tile 256); 0 = unbounded (account only)")
    ap.add_argument("--tile", type=int, default=256, help="tile side")
    ap.add_argument("--mesh", type=int, default=0, metavar="D",
                    help="with --stream: row-shard the window over a D-rank process "
                    "group (a card a rank over nccl when the host has D, else gloo "
                    "ranks sharing the card) into a stream_mesh JSON object")
    ap.add_argument("--device-tile-budget", type=int, default=0,
                    help="with --mesh: per-rank resident tile bound; 0 = unbounded")
    ap.add_argument("--chaos-overhead", action="store_true",
                    help="batch events/s with an equivocation storm at the full "
                    "f=(n-1)//3 budget against fault-free (BENCH_CHAOS_*)")
    ap.add_argument("--cluster", action="store_true",
                    help="a real-process loopback cluster (kill -9 + WAL recovery) "
                    "and an overload leg that must shed (BENCH_CLUSTER_*)")
    ap.add_argument("--churn", action="store_true",
                    help="a decided leave + join through the epoch-aware driver, "
                    "and the repack p99 (BENCH_CHURN_*); exit 1 below 3 epochs")
    ap.add_argument("--soak", action="store_true",
                    help="the composed production-day soak (BENCH_SOAK_*); exit 1 "
                    "on a red verdict")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cpu":
        torch.set_num_threads(1)       # small CPU ops are far slower threaded
    elif not torch.cuda.is_available():
        print(f"tpu_swirld_torch.bench: no CUDA device is available for "
              f"--device {args.device}; pass --device cpu to run the plain "
              "PyTorch versions on the CPU", file=sys.stderr)
        return 2
    if args.soak:
        out, rc, _ = run_soak()
    elif args.churn:
        out, rc, _ = run_churn(args.device)
    elif args.cluster:
        out, rc, _ = run_cluster()
    elif args.chaos_overhead:
        out, rc, _ = run_chaos_overhead(args.device)
    elif args.stream:
        out, rc, _ = run_stream(args.tile_budget or None, args.tile, mesh_n=args.mesh,
                                device_tile_budget=args.device_tile_budget or None,
                                device=args.device)
    else:
        out, rc, _ = run_default(args.device)
    print(json.dumps(out), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
