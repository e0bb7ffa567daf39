"""Meshes over several processes: the launcher, its rank tasks, and the
port's ``dryrun_multichip`` (the counterpart of ``__graft_entry__.py:
dryrun_multichip``).

    python -m tpu_swirld_torch.multichip N [--device cpu|cuda]
        [--backend gloo|nccl] [--timeout SECONDS]

spawns ``N`` rank processes joined in one ``torch.distributed`` group
through a file store (:func:`~tpu_swirld_torch.parallel.init_group`), and
each rank runs what the reference's dryrun runs in its one process: a
``max(4, N)``-member simulation of ``60 * members`` turns (seed 21), its
first node packed, ``run_consensus(block=64, mesh=<the group mesh>)``, and
order, rounds, witnesses and fame held against that oracle node.  It
prints the reference's one ``dryrun_multichip ok: ...`` line and exits 0,
or exits 1 when a rank fails, hangs or disagrees with the others.

``--device cuda`` (the default) puts rank ``r`` on card ``r`` modulo the
host's cards, so ranks share a card when there are fewer cards than
ranks; ``--backend`` is the caller's: ``nccl`` needs a card a rank,
``gloo`` (the default) runs anywhere, its ``all_reduce`` taking CUDA
tensors.  Kernels are built once, before the ranks start.

:func:`launch` is the launcher the tests and ``chip_smoke.py`` use
(:func:`start` and :meth:`RankGroup.wait` when several groups run side
by side): a rank task is a function ``task(mesh, *args)`` importable by
name (it is pickled for the spawned ranks by reference), which returns
a dict with a ``"digest"`` that must be equal on every rank.  Each rank
sends back its result and its kernel launches.
"""

from __future__ import annotations

import argparse
import hashlib
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import struct
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from tpu_swirld_torch.device import resolve_device

KERNEL_NAMES = ("bmm_or", "ssm_block", "ssm_matrix", "ssm_tally", "make_mesh_row_block_fn",
                "rounds_scan", "fame_scan", "order_scan")


class RankFailure(RuntimeError):
    """A rank raised, died, hung past the launcher's timeout, or returned
    a digest other ranks did not."""


def rank_device(rank: int, device: str) -> str:
    """The device of rank ``rank``: ``"cpu"``; ``"cuda:i"`` as given; or,
    for ``"cuda"``, card ``rank`` modulo the host's cards."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return f"cuda:{rank % torch.cuda.device_count()}"
    return str(dev)


def _launches() -> dict:
    from tpu_swirld_torch.gpu import kernels

    return {name: getattr(kernels, name).launches for name in KERNEL_NAMES}


def _rank_main(rank, world, store, backend, device, timeout, work, out):
    """One rank: join the group, build its mesh, run the ``task(mesh,
    *args)`` pickled at ``work`` with every kernel's launch count at 0, and
    put ``(rank, "ok", payload)`` or ``(rank, "error", traceback)`` on
    ``out``."""
    import torch.distributed as dist

    from tpu_swirld_torch import parallel
    from tpu_swirld_torch.gpu import kernels

    try:
        if device == "cpu":
            torch.set_num_threads(1)
        with open(work, "rb") as f:
            task, args = pickle.load(f)
        mesh = parallel.init_group(rank, world, store, backend=backend, device=device,
                                   timeout=timeout)
        for name in KERNEL_NAMES:
            getattr(kernels, name).launches = 0
        result = task(mesh, *args)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        out.put((rank, "ok", {"result": result, "launches": _launches(),
                              "device": str(mesh.device), "backend": mesh.backend}))
    except BaseException:   # reported to the launcher, which fails the run
        out.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(task, n_shards: int, *, args=(), device="cuda", backend: str,
           timeout: float = 600.0) -> list:
    """Run ``task(mesh, *args)`` on every rank of an ``n_shards``-rank group
    and return each rank's ``{"result", "launches", "device", "backend"}``,
    rank by rank: :func:`start`, then :meth:`RankGroup.wait`."""
    return start(task, n_shards, args=args, device=device, backend=backend,
                 timeout=timeout).wait()


def start(task, n_shards: int, *, args=(), device="cuda", backend: str,
          timeout: float = 600.0) -> "RankGroup":
    """Spawn the ``n_shards`` ranks of a group that runs ``task(mesh,
    *args)`` and return at once; :meth:`RankGroup.wait` collects them.
    Several groups may run side by side (each has its own file store).

    ``timeout`` counts from here: ranks not all done by then are killed
    (each collective also times out after ``timeout``).  ``device="cuda"``
    raises at once without a GPU, and ``backend="nccl"`` unless each rank
    has a card of its own."""
    world = int(n_shards)
    if world < 1:
        raise ValueError(f"a group needs at least one rank, got {world}")
    if resolve_device(device).type == "cuda":
        if backend == "nccl" and world > torch.cuda.device_count():
            raise ValueError(
                f"nccl needs a card a rank: {world} ranks, "
                f"{torch.cuda.device_count()} card(s); ranks that share a card use gloo"
            )
        from tpu_swirld_torch.gpu import build

        build.build_all()       # here, before the ranks: they load what it built
    elif backend == "nccl":
        raise ValueError("nccl needs a card a rank, not the CPU")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="swirld-group-")
    store = os.path.join(tmp, "store")
    # the task and its inputs go through a file: a spawned child reads its
    # start-up pipe only once it is up, and a payload past the pipe's
    # buffer would block this process for ever on a child that died first
    work = os.path.join(tmp, "task.pkl")
    with open(work, "wb") as f:
        pickle.dump((task, tuple(args)), f)
    procs = [
        ctx.Process(
            target=_rank_main, name=f"swirld-rank-{r}", daemon=True,
            args=(r, world, store, backend, rank_device(r, device), timeout, work, out),
        )
        for r in range(world)
    ]
    try:
        for p in procs:
            p.start()
    except BaseException:
        _stop([p for p in procs if p.pid is not None], grace=0.0)
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return RankGroup(procs, out, tmp, time.monotonic() + timeout)


class RankGroup:
    """The running ranks of one group (:func:`start`)."""

    def __init__(self, procs, out, tmp: str, deadline: float):
        self.procs, self._out, self._tmp, self._deadline = procs, out, tmp, deadline

    def wait(self) -> list:
        """Each rank's ``{"result", "launches", "device", "backend"}``, rank
        by rank, once every rank reported.  Raises :class:`RankFailure`
        when a rank raises or dies, when the ranks are not all done by the
        deadline (the others are then killed), or when their results'
        ``"digest"`` differ."""
        done, errors = {}, {"launcher": "interrupted"}
        try:
            done, errors = _collect(self.procs, self._out, self._deadline)
        finally:
            # ranks that reported all exit on their own; after a failure the
            # others may wait in a collective for ever
            _stop(self.procs, grace=0.0 if errors else 30.0)
            shutil.rmtree(self._tmp, ignore_errors=True)
        if not errors:
            errors = {r: f"reported, then exited with code {p.exitcode}"
                      for r, p in enumerate(self.procs) if p.exitcode != 0}
        if errors:
            raise RankFailure("\n".join(f"rank {r}: {e}"
                                        for r, e in sorted(errors.items())))
        results = [done[r] for r in range(len(self.procs))]
        digests = [r["result"].get("digest") for r in results]
        if len(set(digests)) != 1:
            raise RankFailure(f"the ranks disagree: digests {digests}")
        return results


def _collect(procs, out, deadline):
    """Read the ranks' reports until every rank reported, one failed, a
    rank died without a report, or ``deadline`` passed."""
    done, errors = {}, {}
    while len(done) < len(procs) and not errors:
        left = deadline - time.monotonic()
        if left <= 0:
            errors.update({r: "did not finish before the launcher's timeout"
                           for r in range(len(procs)) if r not in done})
            break
        try:
            rank, status, payload = out.get(timeout=min(left, 1.0))
        except queue.Empty:
            dead = [r for r, p in enumerate(procs)
                    if p.exitcode is not None and r not in done]
            if dead:
                # a report sent just before the exit is in the pipe already
                try:
                    rank, status, payload = out.get(timeout=1.0)
                except queue.Empty:
                    errors.update({r: f"exited with code {procs[r].exitcode} and "
                                      "no report" for r in dead})
                    break
            else:
                continue
        if status == "ok":
            done[rank] = payload
        else:
            errors[rank] = payload
    return done, errors


def _stop(procs, grace: float):
    """Join every rank; terminate, then kill, those still running."""
    deadline = time.monotonic() + grace
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(timeout=2.0)
        if p.is_alive():
            p.kill()
            p.join()


# ------------------------------------------------------------- rank tasks


def result_digest(packed, result) -> str:
    """SHA-256 over a consensus result: the order's event ids, ``round``,
    ``is_witness``, ``round_received`` and ``consensus_ts`` (little-endian)
    and the fame of every witness (sorted, -1 undecided)."""
    h = hashlib.sha256()
    h.update(b"".join(packed.ids[i] for i in result.order))
    h.update(np.asarray(result.round, "<i4").tobytes())
    h.update(np.asarray(result.is_witness, "?").tobytes())
    h.update(np.asarray(result.round_received, "<i4").tobytes())
    h.update(np.asarray(result.consensus_ts, "<i8").tobytes())
    h.update(b"".join(struct.pack("<ib", k, -1 if v is None else int(v))
                      for k, v in sorted(result.famous.items())))
    return h.hexdigest()


def _strip(result):
    """A consensus result without its timings (kept apart, per rank)."""
    timings = result.timings
    result.timings = {}
    return result, timings


def _check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"parity with the oracle failed: {what}")


def dryrun_rank(mesh) -> dict:
    """The rank task of ``dryrun_multichip``: the reference's dryrun on
    this rank's group mesh."""
    from tpu_swirld_torch.gpu.pipeline import run_consensus
    from tpu_swirld_torch.packing import pack_node
    from tpu_swirld_torch.sim import make_simulation

    n_members = max(4, mesh.size)
    sim = make_simulation(n_members, seed=21)
    sim.run(60 * n_members)
    node = sim.nodes[0]
    packed = pack_node(node)
    result = run_consensus(packed, node.config, block=64, mesh=mesh, device=mesh.device)
    _check([packed.ids[i] for i in result.order] == node.consensus, "order")
    for i, eid in enumerate(node.order_added):
        _check(result.round[i] == node.round[eid], f"round of event {i}")
        _check(bool(result.is_witness[i]) == bool(node.is_witness[eid]),
               f"witness flag of event {i}")
    famous = {node.idx[w]: node.famous[w] for ws in node.wit_list.values() for w in ws}
    _check(result.famous == famous, "fame")
    return {"digest": result_digest(packed, result), "events": packed.n,
            "ordered": len(result.order), "max_round": int(result.max_round),
            "timings": result.timings}


def batch_rank(mesh, packed_path: str, config, block: int = 128, s_max=None) -> dict:
    """``run_consensus`` of the ``PackedDAG`` saved at ``packed_path``
    (:func:`~tpu_swirld_torch.checkpoint.save_packed`) under ``config`` (a
    ``SwirldConfig``), member-sharded over the group.  Returns the result
    (timings apart), its digest and the pass's wall seconds."""
    from tpu_swirld_torch.checkpoint import load_packed
    from tpu_swirld_torch.gpu.pipeline import run_consensus

    packed = load_packed(packed_path)
    t0 = time.perf_counter()
    result = run_consensus(packed, config, block=block, s_max=s_max,
                           mesh=mesh, device=mesh.device)
    wall = time.perf_counter() - t0
    result, timings = _strip(result)
    return {"digest": result_digest(packed, result), "result": result,
            "timings": timings, "wall": wall}


def incremental_rank(mesh, members, stake, config, events, ingest: int,
                     driver: dict) -> dict:
    """The incremental driver with the member-sharded block of
    :func:`~tpu_swirld_torch.parallel.make_ssm_block_fn_for_mesh` over the
    group (everything else replicated on each rank), fed ``events`` in
    ingests of ``ingest``.  Returns its result and digest."""
    from tpu_swirld_torch.gpu.incremental import IncrementalConsensus
    from tpu_swirld_torch.packing import pack_events
    from tpu_swirld_torch.parallel import make_ssm_block_fn_for_mesh

    inc = IncrementalConsensus(
        members, stake, config, device=mesh.device,
        ssm_block_fn=make_ssm_block_fn_for_mesh(mesh), **driver,
    )
    for i in range(0, len(events), ingest):
        inc.ingest(events[i : i + ingest])
    result, _timings = _strip(inc.result())
    packed = pack_events(events, members, stake)
    return {"digest": result_digest(packed, result), "result": result}


def row_block_rank(mesh, inputs_path: str, row0s, rows: int) -> dict:
    """The row-sharded strongly-sees block over the group: the ``.npz`` at
    ``inputs_path`` holds ``sees`` ``(n, n)``, ``member_table``, ``stake``
    and ``cols``; this rank puts only its own ``n / D`` rows of ``sees`` on
    its device, and runs both block routes
    (:func:`~tpu_swirld_torch.parallel.make_row_sharded_block_fn`, the
    ``bmm`` hops, and :func:`~tpu_swirld_torch.gpu.kernels.
    make_mesh_row_block_fn`, one ``ssm_tally``) at each start of
    ``row0s``.  Returns the blocks (bool ``(rows, C)`` numpy) and their
    digest."""
    from tpu_swirld_torch.gpu import kernels
    from tpu_swirld_torch.parallel import make_row_sharded_block_fn

    dev = mesh.device
    with np.load(inputs_path) as z:
        sees = z["sees"]
        n_loc = sees.shape[0] // mesh.size
        shard = torch.as_tensor(
            np.ascontiguousarray(sees[mesh.rank * n_loc : (mesh.rank + 1) * n_loc])
        ).to(dev)
        mt, stake, cols = (torch.as_tensor(z[k]).to(dev)
                           for k in ("member_table", "stake", "cols"))
    tot = int(stake.sum())
    fns = {"row_sharded": make_row_sharded_block_fn(mesh),
           "mesh_row_block": kernels.make_mesh_row_block_fn(mesh)}
    blocks, h = {}, hashlib.sha256()
    for row0 in row0s:
        for name, fn in fns.items():
            out = fn(shard, mt, stake, cols, row0, rows=rows, tot_stake=tot).cpu().numpy()
            blocks[(name, int(row0))] = out
            h.update(np.packbits(out).tobytes())
    return {"digest": h.hexdigest(), "blocks": blocks,
            "shard_rows": (mesh.rank * n_loc, (mesh.rank + 1) * n_loc)}


def visibility_rank(mesh, parents, creator, fork_pairs, n_members: int, block: int) -> dict:
    """The sharded visibility of a batch rebase
    (:func:`~tpu_swirld_torch.parallel.group_visibility_stage`) over
    ``parents`` (int32 ``(N, 2)``, ``N`` a multiple of ``D * block``),
    ``creator`` and ``fork_pairs`` (host arrays): this rank's rows of
    ``anc`` and ``sees`` (bool numpy), the bytes and collectives it handed,
    and the most rows of any slab it allocated."""
    from tpu_swirld_torch.parallel import CrossingPlan, group_visibility_stage

    dev = mesh.device
    rows = []
    calls, sent = mesh.traffic.calls, mesh.traffic.bytes
    anc, sees = group_visibility_stage(
        mesh, CrossingPlan.of(parents, mesh.size, mesh.rank),
        torch.as_tensor(parents).to(dev), torch.as_tensor(creator).to(dev),
        torch.as_tensor(fork_pairs).to(dev), n_members=n_members, block=block,
        record=rows.append)
    calls, sent = mesh.traffic.calls - calls, mesh.traffic.bytes - sent
    # the rows differ by rank; what every rank handed does not
    return {"digest": f"{calls} collectives, {sent} bytes", "anc": anc.cpu().numpy(),
            "sees": sees.cpu().numpy(), "aliased": sees is anc, "calls": calls,
            "bytes": sent, "slab_rows": max(rows)}


def assert_row_sharded(inc, mesh) -> None:
    """Every carried slab of a group streaming driver is this rank's ``W /
    D`` rows of the window, on its device (the reference's
    ``tests/test_mesh_stream.py:assert_row_sharded``)."""
    w = inc._w_pad
    slabs = {"anc": (inc._anc_d, w), "ssm": (inc._ssm_d, inc._ssm_d.shape[1])}
    if inc._sees_d is not inc._anc_d:
        slabs["sees"] = (inc._sees_d, w)
    for name, (t, cols) in slabs.items():
        if w % mesh.size or tuple(t.shape) != (w // mesh.size, cols) or t.device != mesh.device:
            raise RuntimeError(f"{name}: shape {tuple(t.shape)} on {t.device}, not rank "
                               f"{mesh.rank}'s {w // mesh.size} of {w} rows on {mesh.device}")


def watch_stage_peaks(driver):
    """Break a driver's device peak down by stage: each stage it runs
    through its ``StageClock`` is a phase of a
    :class:`~tpu_swirld_torch.obs.MemoryMonitor` on the card, a streaming
    driver's widening (``_widen_slabs``) is the phase ``"widening"``, and
    the peak reached between two stages otherwise (growth, prune moves,
    spills, a rebase's host steps) is kept as ``"between stages"``.
    Returns the monitor; :func:`stage_peaks` reads it.  CUDA only."""
    from tpu_swirld_torch.obs import MemoryMonitor

    clock = driver.stages
    dev = clock.device
    monitor = MemoryMonitor(enable_host=False, device=dev)
    call = clock._call

    def between():
        rec = monitor.phases.setdefault(
            "between stages", {"host_peak_bytes": 0, "device_peak_bytes": 0})
        rec["device_peak_bytes"] = max(rec["device_peak_bytes"],
                                       int(torch.cuda.max_memory_allocated(dev)))

    def watched(name, fused_chunks, fn, args, kw):
        between()
        with monitor.phase(name):
            out = call(name, fused_chunks, fn, args, kw)
        torch.cuda.reset_peak_memory_stats(dev)
        return out

    clock._call = watched
    monitor.between = between
    widen = getattr(driver, "_widen_slabs", None)
    if widen is not None:
        def widening(*args):
            between()
            with monitor.phase("widening"):
                widen(*args)
            torch.cuda.reset_peak_memory_stats(dev)

        driver._widen_slabs = widening
    return monitor


def stage_peaks(monitor, base: int) -> dict:
    """``{stage: peak device bytes above base}`` of a
    :func:`watch_stage_peaks` monitor, the time since its last stage
    included."""
    monitor.between()
    return {name: rec["device_peak_bytes"] - base
            for name, rec in sorted(monitor.phases.items())}


def host_peak(fn, *args):
    """``(fn(*args), the peak host bytes tracemalloc saw during the call
    above what it held at the start)``."""
    import tracemalloc

    started = not tracemalloc.is_tracing()
    if started:
        tracemalloc.start()
    tracemalloc.reset_peak()
    base = tracemalloc.get_traced_memory()[0]
    try:
        out = fn(*args)
        return out, tracemalloc.get_traced_memory()[1] - base
    finally:
        if started:
            tracemalloc.stop()


def streaming_rank(mesh, members, stake, config, chunks, driver: dict,
                   traced=()) -> dict:
    """The streaming driver with its window row-sharded over the group
    (:class:`~tpu_swirld_torch.parallel.GroupStreamingConsensus`), fed the
    event lists ``chunks`` one ingest each; every slab held to this rank's
    rows after each ingest (:func:`assert_row_sharded`).  Returns the
    result, each pass's stats, the driver's counters, the store's stats,
    the archive's digest and counters, the ingests' wall seconds (the
    row checks included), the driver's stage calls, each full rebase's
    shapes and most rows of a slab (``rebase_slabs``), each widening's
    record (``widen_slabs``), this rank's peak device bytes above what it
    held before, in all and by stage (:func:`stage_peaks`; ``None`` on the
    CPU), and ``host_peaks``: for each ingest of ``traced`` (indices into
    ``chunks``), the peak host bytes ``tracemalloc`` saw during it."""
    from tpu_swirld_torch.packing import pack_events
    from tpu_swirld_torch.parallel import MeshStreamingConsensus

    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
        base = torch.cuda.memory_allocated(mesh.device)
    inc = MeshStreamingConsensus(mesh, members, stake, config, device=mesh.device,
                                 **driver)
    monitor = watch_stage_peaks(inc) if cuda else None
    passes, host_peaks = [], {}
    t0 = time.perf_counter()
    try:
        for i, chunk in enumerate(chunks):
            if i in traced:
                st, host_peaks[i] = host_peak(inc.ingest, chunk)
            else:
                st = inc.ingest(chunk)
            passes.append(st)
            assert_row_sharded(inc, mesh)
        wall = time.perf_counter() - t0
        result, _timings = _strip(inc.result())
        arch = inc.store.archive
        archive = {"digest": arch.digest(), "n_rows": arch.n_rows, "rounds": arch._rounds,
                   **{k: getattr(arch, k) for k in (
                       "spills", "fetches", "spilled_rows", "fetched_rows",
                       "skipped_rows", "archive_bytes")}}
        store = inc.store.stats()
        counters = {k: getattr(inc, k) for k in (
            "widen_rebases", "full_rebases", "rebases", "repins", "pruned_prefix",
            "_round_hi")}
        counters["forked"] = inc._sees_d is not inc._anc_d
        stage_calls = dict(inc.stages.calls)
    finally:
        inc.store.close()
    events = [e for chunk in chunks for e in chunk]
    packed = pack_events(events, members, stake)
    peaks = stage_peaks(monitor, base) if cuda else None
    return {"digest": result_digest(packed, result) + archive["digest"],
            "result": result, "passes": passes, "counters": counters, "store": store,
            "archive": archive, "wall": wall, "stage_calls": stage_calls,
            "stage_peaks": peaks, "rebase_slabs": inc.rebase_slabs,
            "widen_slabs": inc.widen_slabs, "host_peaks": host_peaks,
            "peak_bytes": max(peaks.values()) if cuda else None}


def tasks_rank(mesh, tasks) -> dict:
    """Several rank tasks in one group session: ``tasks`` is a list of
    ``(task, args)``; returns their results in order under ``"results"``,
    each task's kernel launches under ``"launches"``, and one digest over
    theirs."""
    results, launches = [], []
    for task, args in tasks:
        before = _launches()
        results.append(task(mesh, *args))
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        launches.append({k: v - before[k] for k, v in _launches().items()})
    digest = hashlib.sha256("".join(r["digest"] for r in results).encode()).hexdigest()
    return {"digest": digest, "results": results, "launches": launches}


# -------------------------------------------------------------- command line


def dryrun_multichip(n_devices: int, *, device="cuda", backend="gloo",
                     timeout: float = 600.0) -> list:
    """The reference's ``dryrun_multichip`` on an ``n_devices``-rank group:
    prints its one line and returns each rank's report; raises
    :class:`RankFailure` when a rank fails, hangs or disagrees."""
    reports = launch(dryrun_rank, n_devices, device=device,
                     backend=backend, timeout=timeout)
    r = reports[0]["result"]
    print(
        f"dryrun_multichip ok: {n_devices}-device mesh, {r['events']} events, "
        f"{r['ordered']} ordered, max_round {r['max_round']}, "
        f"bit-parity with oracle", flush=True,
    )
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=8, help="ranks (mesh shards)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before the launcher gives up on the ranks")
    args = ap.parse_args(argv)
    try:
        reports = dryrun_multichip(args.n, device=args.device, backend=args.backend,
                                   timeout=args.timeout)
    except RankFailure as e:
        print(f"dryrun_multichip failed: {e}", file=sys.stderr)
        return 1
    for rank, rep in enumerate(reports):
        print(f"rank {rank} ({rep['backend']}, {rep['device']}): launches "
              f"{rep['launches']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
