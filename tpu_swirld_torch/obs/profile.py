"""Dispatch-level hot-path profiler over the ``obs.stage_call`` seam (the
port's copy of the reference's ``tpu_swirld/obs/profile.py``).

Attach a :class:`DispatchProfiler` to the ambient
:class:`~tpu_swirld_torch.obs.Obs` and every stage dispatch feeds it:

- *per-dispatch wall time*: the stage seam synchronizes the card after
  the stage, so a dispatch's time is its enqueue plus its completion;
- *the gap between dispatches*: host work between one stage ending and
  the next starting (Python driver overhead, host pulls);
- *host-to-device bytes*: numpy arrays, and CPU tensors handed to a stage
  that runs on a CUDA device, count as H2D uploads; pulls through
  :func:`tpu_swirld_torch.obs.to_host` of a device tensor count as D2H.

Chunk accounting: the drivers bracket each ingest with
:meth:`~DispatchProfiler.begin_chunk` / :meth:`~DispatchProfiler.end_chunk`;
a chunk's wall time less the sum of its stage times is its dispatch
overhead.  :meth:`~DispatchProfiler.summary` gives the per-chunk rows and a
ranked top-k stage list.

Clock discipline: this module reads wall time at one callsite
(:func:`_wall`); tests may inject a fake clock.  ``record_dispatch``
timestamps arrive from the caller and are only subtracted.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np


def _wall() -> float:
    """The profiler's single wall read (monotonic seconds)."""
    return time.perf_counter()   # swirld-lint: disable=SW003 -- the dispatch profiler's one timing callsite: measuring real host/device wall cost is its entire purpose; it observes, never steers, consensus

#: ranked stage list length in summaries
DEFAULT_TOP_K = 3


def _host_arg_bytes(args, device=None) -> int:
    """Bytes of host arguments, the H2D upload a dispatch implies: numpy
    arrays, and CPU tensors when the stage runs on a CUDA ``device``.
    Tensors already on the stage's device do not count."""
    total = 0
    on_card = device is not None and device.type == "cuda"
    for a in args:
        if isinstance(a, np.ndarray):
            total += a.nbytes
        elif on_card and getattr(a, "device", None) is not None:
            if a.device.type == "cpu" and hasattr(a, "element_size"):
                total += a.numel() * a.element_size()
    return total


class DispatchProfiler:
    """Accumulates per-dispatch and per-chunk cost for one run.

    Args:
      top_k: length of the ranked stage list in :meth:`summary`.
      clock: zero-arg monotonic-seconds callable for chunk walls
        (injectable for tests); defaults to the module's single wall
        read.  Must share a timebase with the timestamps handed to
        :meth:`record_dispatch` (``stage_call`` uses ``perf_counter``).
    """

    def __init__(self, top_k: int = DEFAULT_TOP_K,
                 clock: Optional[Callable[[], float]] = None):
        self.top_k = int(top_k)
        self._clock = clock if clock is not None else _wall
        self._stage_s: Dict[str, float] = {}
        self._stage_calls: Dict[str, int] = {}
        self.dispatches = 0
        self.fused_dispatches = 0     # dispatches covering >1 scan chunk
        self.fused_chunks_total = 0   # scan chunks covered by those
        self.stage_s_total = 0.0
        self.gap_s_total = 0.0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.chunks: List[Dict] = []
        # per-chunk *effective* gap samples: a K-chunk megadispatch's one
        # inter-dispatch gap amortizes over K chunk boundaries, so it
        # contributes K samples of gap/K — without this, fusing makes the
        # gap distribution look artificially clean (one giant dispatch
        # instead of K per-chunk ones)
        self._gap_samples: List[float] = []
        self._last_end: Optional[float] = None
        self._chunk: Optional[Dict] = None

    # --------------------------------------------------------- chunk marks

    def begin_chunk(self, label: Optional[str] = None) -> None:
        """Open a chunk scope (one streaming/incremental ingest)."""
        self._chunk = {
            "label": label if label is not None else len(self.chunks),
            "t0": self._clock(),
            "stage_s": 0.0, "dispatches": 0, "gap_s": 0.0,
            "fused_chunks": 0, "h2d_bytes": 0, "d2h_bytes": 0,
        }
        # gaps never span a chunk boundary: the wait between chunks is
        # the caller's (data generation), not dispatch overhead
        self._last_end = None

    def end_chunk(self, n_events: int = 0) -> Optional[Dict]:
        """Close the open chunk; returns its breakdown row."""
        c = self._chunk
        if c is None:
            return None
        self._chunk = None
        wall = self._clock() - c.pop("t0")
        c["wall_s"] = round(wall, 6)
        c["overhead_s"] = round(max(0.0, wall - c["stage_s"]), 6)
        c["stage_s"] = round(c["stage_s"], 6)
        c["gap_s"] = round(c["gap_s"], 6)
        c["n_events"] = int(n_events)
        self.chunks.append(c)
        self._last_end = None
        return c

    # ----------------------------------------------------------- recording

    def record_dispatch(self, stage: str, t0: float, t1: float,
                        args=(), fused_chunks: int = 1,
                        device=None) -> None:
        """One ``stage_call`` completed: ``t0``/``t1`` are its start/end
        on the caller's monotonic clock; ``args`` are the stage's
        positional arguments (scanned for host arrays, the H2D bytes, on
        the stage's ``device``).
        ``fused_chunks > 1`` marks a megadispatch whose single
        inter-dispatch gap amortizes over that many scan chunks: the gap
        contributes ``fused_chunks`` effective samples of ``gap / K`` so
        per-chunk gap statistics stay comparable across fusion levels."""
        dt = max(0.0, t1 - t0)
        k = max(1, int(fused_chunks))
        self.dispatches += 1
        if k > 1:
            self.fused_dispatches += 1
            self.fused_chunks_total += k
        self.stage_s_total += dt
        self._stage_s[stage] = self._stage_s.get(stage, 0.0) + dt
        self._stage_calls[stage] = self._stage_calls.get(stage, 0) + 1
        gap = 0.0
        if self._last_end is not None:
            gap = max(0.0, t0 - self._last_end)
            self.gap_s_total += gap
            self._gap_samples.extend([gap / k] * k)
        self._last_end = t1
        h2d = _host_arg_bytes(args, device)
        self.h2d_bytes += h2d
        c = self._chunk
        if c is not None:
            c["stage_s"] += dt
            c["dispatches"] += 1
            c["gap_s"] += gap
            c["h2d_bytes"] += h2d
            if k > 1:
                c["fused_chunks"] += k

    def record_transfer(self, direction: str, nbytes: int) -> None:
        """An explicit host↔device copy outside dispatch args
        (``direction`` is ``"d2h"`` or ``"h2d"``)."""
        nbytes = int(nbytes)
        if direction == "d2h":
            self.d2h_bytes += nbytes
            if self._chunk is not None:
                self._chunk["d2h_bytes"] += nbytes
        else:
            self.h2d_bytes += nbytes
            if self._chunk is not None:
                self._chunk["h2d_bytes"] += nbytes

    # ------------------------------------------------------------- queries

    def top_stages(self, k: Optional[int] = None) -> List[Dict]:
        """Stages ranked by total seconds (descending; name breaks
        ties deterministically)."""
        k = self.top_k if k is None else int(k)
        ranked = sorted(
            self._stage_s, key=lambda s: (-self._stage_s[s], s),
        )
        return [
            {
                "stage": s,
                "seconds": round(self._stage_s[s], 6),
                "calls": self._stage_calls.get(s, 0),
            }
            for s in ranked[:k]
        ]

    def gap_quantiles(self) -> Dict:
        """Per-chunk *effective* inter-dispatch gap distribution (p50 /
        p99 / max, seconds).  Fused dispatches contribute K samples of
        ``gap / K`` each, so the quantiles compare across fusion levels."""
        g = self._gap_samples
        if not g:
            return {"p50": 0.0, "p99": 0.0, "max": 0.0}
        s = sorted(g)
        q = lambda p: s[min(len(s) - 1, int(p * (len(s) - 1) + 0.5))]  # noqa: E731
        return {
            "p50": round(q(0.50), 6),
            "p99": round(q(0.99), 6),
            "max": round(s[-1], 6),
        }

    def summary(self) -> Dict:
        """The dispatch-breakdown object: totals, gap quantiles,
        transfer bytes, the ranked stages and the per-chunk rows."""
        wall = sum(c["wall_s"] for c in self.chunks)
        overhead = sum(c["overhead_s"] for c in self.chunks)
        return {
            "chunks": len(self.chunks),
            "dispatches": self.dispatches,
            "fused_dispatches": self.fused_dispatches,
            "fused_chunks": self.fused_chunks_total,
            "wall_s": round(wall, 6),
            "stage_s": round(self.stage_s_total, 6),
            "dispatch_overhead_s": round(overhead, 6),
            "gap_s": round(self.gap_s_total, 6),
            "gap_per_chunk": self.gap_quantiles(),
            "transfers_bytes": {
                "h2d": self.h2d_bytes, "d2h": self.d2h_bytes,
            },
            "top_stages": self.top_stages(),
            "per_chunk": list(self.chunks),
        }
