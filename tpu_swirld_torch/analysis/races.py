"""Schedule-fuzzing race sanitizer for the archive's worker protocol (the
port's copy of the reference's ``tpu_swirld/analysis/races.py``).

The background pack worker (:mod:`tpu_swirld_torch.store.archive`) shares a
bounded spill queue, a blob list, a byte counter and an LRU row cache with
the client thread; correctness rests on the drain-barrier protocol, not on
per-attribute locks.  A protocol bug would surface as a schedule-dependent
blob stream, so the sanitizer *quantifies* the async==sync pin over
randomized schedules:

- **Yield injection**: :class:`Injector` sleeps a few microseconds with
  seeded probability at the tagged points compiled into the archive
  (``archive.enqueue``, ``archive.worker.item``, ``archive.drain``,
  ``archive.append``, ``archive.cache.miss``), perturbing the
  client/worker interleaving differently per seed.
- **Lock-order graph**: :class:`SanitizedArchive` swaps the spill queue's
  internal mutex for a :class:`TrackedLock`; every acquire records
  held->acquired edges, and a cycle in the graph is a potential deadlock
  (freedom = acyclicity).
- **Digest equality**: :func:`run_archive_schedules` runs a seeded
  spill/fetch/checkpoint workload under N schedules and checks that the
  BLAKE2b blob-stream digest is bit-identical across all of them *and*
  equal to a fully synchronous (``async_spill=False``) run.  Each spill
  batch's window rows reach ``spill`` as an owned tensor on ``device``, as
  :meth:`StreamingConsensus._on_prune` hands them over, so on a card the
  worker's blocking pull of device rows runs under every schedule.  A
  schedule whose fetch or mid-run checkpoint disagrees with the closure is
  reported (``errors``), not raised.

:func:`run_schedules` is the generic harness: any callable that returns a
comparable result is run under N schedules and reported as deterministic
or not; the tests use it to show that the sanitizer catches a
deliberately seeded lost update.

CLI: ``python -m tpu_swirld_torch.analysis races --schedules 32``
(``--device cpu`` on a host without a GPU).
"""

from __future__ import annotations

import contextlib
import os
import queue
import random
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_swirld_torch.device import resolve_device
from tpu_swirld_torch.store.archive import SlabArchive

# ------------------------------------------------------------- injection


class Injector:
    """Seeded yield injector: ``point(tag)`` sleeps up to ``max_sleep``
    seconds with probability ``p``.  One instance = one schedule; the
    same seed replays the same injection decisions (modulo OS
    scheduling, which the sleeps are there to perturb)."""

    def __init__(self, seed: int, p: float = 0.25,
                 max_sleep: float = 5e-5):
        self._rng = random.Random(seed)
        self._mu = threading.Lock()
        self.p = p
        self.max_sleep = max_sleep
        self.fired = 0
        self.points = 0

    def point(self, tag: str) -> None:
        with self._mu:
            self.points += 1
            r = self._rng.random()
            fire = r < self.p
            if fire:
                self.fired += 1
                delay = r / self.p * self.max_sleep
        if fire:
            time.sleep(delay)


#: ambient injector for fixture code (see :func:`yield_point`)
_active: Optional[Injector] = None


def yield_point(tag: str) -> None:
    """Fixture-side injection point: racy test classes call this where a
    real implementation would have a preemption window."""
    a = _active
    if a is not None:
        a.point(tag)


@contextlib.contextmanager
def injection(inj: Injector):
    """Install ``inj`` as the ambient injector for both fixture
    ``yield_point`` calls and the archive's compiled-in points."""
    global _active
    from tpu_swirld_torch.store import archive as archive_mod

    prev = _active
    _active = inj
    archive_mod.set_injector(inj)
    try:
        yield inj
    finally:
        _active = prev
        archive_mod.set_injector(prev)


# ------------------------------------------------------- lock-order graph


class LockOrderGraph:
    """Held->acquired edges recorded at every tracked acquire; a cycle is
    a potential deadlock (two threads can reach the opposite-order
    acquires concurrently)."""

    def __init__(self):
        self.edges: set = set()
        self._tl = threading.local()
        self._mu = threading.Lock()

    def _held(self) -> List[str]:
        stack = getattr(self._tl, "stack", None)
        if stack is None:
            stack = self._tl.stack = []
        return stack

    def on_acquire(self, name: str) -> None:
        held = self._held()
        if held:
            with self._mu:
                for h in held:
                    if h != name:
                        self.edges.add((h, name))
        held.append(name)

    def on_release(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                break

    def cycle(self) -> Optional[List[str]]:
        """A lock-name cycle if one exists, else None (acyclic)."""
        with self._mu:
            adj: Dict[str, List[str]] = {}
            for a, b in sorted(self.edges):
                adj.setdefault(a, []).append(b)
        state: Dict[str, int] = {}   # 1 = on stack, 2 = done
        path: List[str] = []

        def dfs(v: str) -> Optional[List[str]]:
            state[v] = 1
            path.append(v)
            for w in adj.get(v, ()):
                if state.get(w) == 1:
                    return path[path.index(w):] + [w]
                if state.get(w) is None:
                    c = dfs(w)
                    if c:
                        return c
            path.pop()
            state[v] = 2
            return None

        for v in sorted(adj):
            if state.get(v) is None:
                c = dfs(v)
                if c:
                    return c
        return None


class TrackedLock:
    """``threading.Lock`` wrapper feeding a :class:`LockOrderGraph`;
    usable as the lock of a ``threading.Condition`` (the default
    release/re-acquire path goes through :meth:`acquire` /
    :meth:`release`, so condition waits are tracked too)."""

    def __init__(self, name: str, graph: LockOrderGraph):
        self.name = name
        self.graph = graph
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self.graph.on_acquire(self.name)
        return ok

    def release(self) -> None:
        self.graph.on_release(self.name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


class _TrackedQueue(queue.Queue):
    """``queue.Queue`` whose internal mutex is a :class:`TrackedLock`;
    the three condition variables are rebuilt on it so waiter wakeups
    keep working."""

    def __init__(self, maxsize: int, graph: LockOrderGraph,
                 name: str = "archive.q"):
        super().__init__(maxsize)
        self.mutex = TrackedLock(name + ".mutex", graph)
        self.not_empty = threading.Condition(self.mutex)
        self.not_full = threading.Condition(self.mutex)
        self.all_tasks_done = threading.Condition(self.mutex)


class SanitizedArchive(SlabArchive):
    """SlabArchive whose spill queue participates in the lock-order
    graph (via the ``_make_queue`` seam)."""

    def __init__(self, *args, graph: Optional[LockOrderGraph] = None,
                 **kwargs):
        self._graph = graph if graph is not None else LockOrderGraph()
        super().__init__(*args, **kwargs)

    def _make_queue(self, maxsize: int) -> queue.Queue:
        return _TrackedQueue(maxsize, self._graph)


# --------------------------------------------------------------- harness


def run_schedules(
    fn: Callable[[int], Any],
    n_schedules: int = 8,
    seed: int = 0,
) -> Dict[str, Any]:
    """Run ``fn(schedule_index)`` under ``n_schedules`` seeded injection
    schedules; report whether every schedule produced the same result.
    A schedule-dependent result is a race made visible."""
    results: List[Any] = []
    for i in range(n_schedules):
        inj = Injector(seed=seed * 1009 + i)
        with injection(inj):
            results.append(fn(i))
    distinct = sorted({repr(r) for r in results})
    return {
        "schedules": n_schedules,
        "results": results,
        "distinct": len(distinct),
        "deterministic": len(distinct) == 1,
    }


def _closure_matrix(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """A chain-valid ancestry closure: row ``e`` = self | anc(e-1) |
    anc(p2) for a seeded random ``p2 < e``.  Shaped exactly like the
    rows the streaming driver retires, so the archive's parent-prefix
    reconstruction is exercised for real."""
    rng = np.random.default_rng(seed)
    F = np.zeros((n, n), dtype=bool)
    parents = np.full((n, 2), -1, dtype=np.int32)
    for e in range(n):
        F[e, e] = True
        if e:
            F[e] |= F[e - 1]
            parents[e, 0] = e - 1
            p2 = int(rng.integers(0, e))
            F[e] |= F[p2]
            parents[e, 1] = p2
    return F, parents


def _archive_workload(
    arch: SlabArchive, F: np.ndarray, parents: np.ndarray,
    ws: int, tmpdir: str, slab: torch.Tensor, batch: int = 8,
) -> str:
    """One seeded client sequence of spill / fetch / prefetch / digest /
    checkpoint against ``arch`` (the concurrency comes from the archive's
    own pack worker; the injector perturbs the interleaving).  ``slab`` is
    ``F`` as a tensor; each batch's window rows are spilled as an owned
    copy of its block.  Returns the final blob-stream digest and closes
    ``arch``; raises ``AssertionError`` when a fetch or the mid-run
    checkpoint disagrees with ``F``."""
    rng = random.Random(ws)
    n = F.shape[0]
    mid_path = os.path.join(tmpdir, f"mid-{ws}.npz")
    try:
        for lo in range(0, n, batch):
            d = min(batch, n - lo)
            rows = slab[lo : lo + d, lo : lo + d].clone()
            arch.spill(lo, parents[lo : lo + d], rows)
            r = rng.random()
            if r < 0.35 and arch.n_rows > 1:
                f_lo = rng.randrange(0, arch.n_rows - 1)
                f_hi = rng.randrange(f_lo + 1, arch.n_rows + 1)
                c_hi = rng.randrange(1, f_hi + 1)
                got = arch.fetch(f_lo, f_hi, 0, c_hi)
                want = F[f_lo:f_hi, :c_hi]
                if not np.array_equal(got, want):
                    raise AssertionError(
                        f"schedule {ws}: fetch [{f_lo},{f_hi})x[0,{c_hi}) "
                        "diverged from the reference closure"
                    )
            elif r < 0.5:
                arch.prefetch(max(0, arch.n_rows - 16), arch.n_rows)
            elif r < 0.6:
                arch.digest()
            if lo == (n // batch // 2) * batch:
                arch.save(mid_path)
                if SlabArchive.load(mid_path).digest() != arch.digest():
                    raise AssertionError(
                        f"schedule {ws}: mid-run checkpoint digest mismatch"
                    )
        return arch.digest()
    finally:
        arch.close()


def run_archive_schedules(
    n_schedules: int = 32,
    seed: int = 0,
    rows: int = 96,
    queue_depth: int = 2,
    *,
    device="cuda",
    archive_cls: Optional[type] = None,
) -> Dict[str, Any]:
    """The acceptance fuzz: ``n_schedules`` seeded schedules of concurrent
    ingest/spill/fetch/checkpoint must produce bit-identical archive
    digests, match a fully synchronous run (the async==sync archive pin),
    and leave the lock-order graph acyclic.  Rows reach the archive as
    owned tensors on ``device``; ``archive_cls`` (default
    :class:`SanitizedArchive`, or a subclass of it) is the archive under
    fuzz."""
    dev = resolve_device(device)
    archive_cls = archive_cls or SanitizedArchive
    F, parents = _closure_matrix(rows, seed=seed + 7)
    slab = torch.from_numpy(F).to(dev)
    graph = LockOrderGraph()
    digests: List[str] = []
    errors: List[str] = []
    with tempfile.TemporaryDirectory() as tmpdir:
        # synchronous reference: no worker, no injection
        sync_digest = _archive_workload(
            SlabArchive(async_spill=False), F, parents, ws=seed,
            tmpdir=tmpdir, slab=slab,
        )
        for i in range(n_schedules):
            inj = Injector(seed=seed * 1009 + i)
            arch = archive_cls(
                async_spill=True, queue_depth=queue_depth, graph=graph,
            )
            with injection(inj):
                try:
                    digests.append(_archive_workload(
                        arch, F, parents, ws=seed, tmpdir=tmpdir, slab=slab,
                    ))
                except AssertionError as exc:
                    errors.append(f"run {i}: {exc}")
                    digests.append(f"diverged: {exc}")
    cyc = graph.cycle()
    identical = len(set(digests)) == 1
    matches_sync = identical and digests and digests[0] == sync_digest
    return {
        "schedules": n_schedules,
        "device": dev.type,
        "digest": digests[0] if digests else None,
        "digests_identical": identical,
        "sync_digest": sync_digest,
        "matches_sync": bool(matches_sync),
        "errors": errors,
        "lock_edges": sorted(graph.edges),
        "acyclic": cyc is None,
        "cycle": cyc,
        "ok": bool(identical and matches_sync and cyc is None),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="python -m tpu_swirld_torch.analysis races",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--schedules", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=96)
    ap.add_argument(
        "--device", default="cuda",
        help="torch device the spilled rows live on (default cuda, which "
        "fails without a GPU)",
    )
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    report = run_archive_schedules(
        n_schedules=args.schedules, seed=args.seed, rows=args.rows,
        device=args.device,
    )
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(
            f"{report['schedules']} schedules on {report['device']}: digests "
            f"{'identical' if report['digests_identical'] else 'DIVERGED'}, "
            f"sync match {report['matches_sync']}, "
            f"lock graph {'acyclic' if report['acyclic'] else 'CYCLIC'}"
        )
        for e in report["errors"]:
            print(e)
        print("OK" if report["ok"] else "FAIL")
    return 0 if report["ok"] else 1
