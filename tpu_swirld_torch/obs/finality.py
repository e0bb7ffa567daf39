"""Per-event finality lifecycle tracking: rounds-to-decision and
time-to-finality (the port's copy of the reference's
``tpu_swirld/obs/finality.py``).

The whitepaper's virtual-voting pipeline decides fame over multiple
rounds; throughput alone does not show how *long* an event waits between
creation and its consensus slot.  This module tracks the full lifecycle:

- **birth**: the logical tick an event was created (oracle: the event's
  own ``t`` stamp) or the tick its ingest chunk entered the driver
  (batch/incremental/streaming — creation stamps are not wall-aligned
  with the driver's clock there);
- **rounds_to_decision**: ``round_received - round`` — a pure function
  of the DAG, so it is *engine-independent*: oracle, batch,
  ``IncrementalConsensus``, ``StreamingConsensus`` and the mesh driver
  must report bit-identical sequences for the same history, in either
  package (pinned by tests);
- **time_to_finality**: decided tick minus birth tick — logical ticks in
  simulations, wall-clock seconds in a timed run (whatever the injected
  ``clock`` measures);
- **gossip propagation**: creation tick → first *remote* arrival, via
  the oracle ingest seam;
- **decided watermarks**: per-node gauges of the decided frontier.

Clock discipline: this module never reads wall time itself.  A clock is
an injected zero-arg callable: the simulation's logical tick counter or
``time.perf_counter`` from a timed driver.

One tracker per engine; trackers mirror observations into the ambient
:class:`~tpu_swirld_torch.obs.registry.Registry` (when given one) as
``finality_*`` histograms/gauges and keep exact sample lists for
:meth:`FinalityTracker.summary`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

#: buckets for rounds-to-decision (small integers; ``le`` semantics)
ROUNDS_BUCKETS = (
    0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0, 15.0, 20.0, 30.0,
    50.0, 100.0,
)

#: buckets for time-to-finality / gossip propagation: spans sub-second
#: wall-clock latencies (bench) and integer logical-tick counts (sim)
TICKS_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 25.0,
    50.0, 100.0, 250.0, 500.0, 1000.0,
)


def percentile(sorted_samples: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an ascending-sorted sample list."""
    if not sorted_samples:
        raise ValueError("no samples")
    n = len(sorted_samples)
    rank = max(1, min(n, math.ceil(q * n)))
    return sorted_samples[rank - 1]


def _dist(samples: List[float], prefix: str, out: Dict) -> None:
    s = sorted(samples)
    out[f"{prefix}_mean"] = sum(s) / len(s)
    out[f"{prefix}_p50"] = percentile(s, 0.50)
    out[f"{prefix}_p99"] = percentile(s, 0.99)
    out[f"{prefix}_max"] = s[-1]


def merged_dist(sample_lists: Sequence[Sequence[float]], prefix: str) -> Dict:
    """Mean/p50/p99/max over the *union* of several trackers' raw
    samples.  The cluster harness runs one tracker per OS process;
    cluster-level submission→decided percentiles must rank the merged
    samples, not average per-node percentiles (averaging percentiles is
    statistically meaningless).  ``{}`` when no samples exist."""
    merged = [float(x) for samples in sample_lists for x in samples]
    out: Dict = {}
    if merged:
        _dist(merged, prefix, out)
        out[f"{prefix}_count"] = len(merged)
    return out


class FinalityTracker:
    """Lifecycle tracker for one engine's decided events.

    Args:
      engine: label for the registry ``engine=`` dimension
        (``"oracle"``, ``"batch"``, ``"incremental"``, ``"streaming"``).
      clock: zero-arg callable giving the current tick; logical in sims,
        wall-clock in the bench.  ``None`` disables time-to-finality
        (rounds-to-decision still records — it needs no clock).
      registry: optional :class:`~tpu_swirld_torch.obs.registry.Registry` to
        mirror observations into (``finality_*`` metric families).
    """

    def __init__(
        self,
        engine: str,
        clock: Optional[Callable[[], float]] = None,
        registry=None,
    ):
        self.engine = str(engine)
        self._clock = clock
        self._registry = registry
        self._births: Dict = {}          # key -> birth tick (undecided)
        self.rtd: List[int] = []         # rounds-to-decision, decided order
        self.ttf: List[float] = []       # time-to-finality, decided order
        self.gossip: List[float] = []    # creation -> first remote arrival
        self.phases: Dict[str, int] = {}  # streaming latency attribution
        self.watermarks: Dict[str, Dict] = {}
        self._gossip_seen = set()
        self._h_rtd = None               # cached registry handles
        self._h_ttf: Dict[Optional[str], object] = {}
        self._h_gossip = None

    # ------------------------------------------------------------- clock

    def now(self, now=None):
        if now is not None:
            return now
        return self._clock() if self._clock is not None else None

    # ------------------------------------------------------------- births

    def mark_birth(self, key, tick=None) -> None:
        """Stamp ``key``'s birth tick once (idempotent on re-offer)."""
        if key not in self._births:
            t = self.now(tick)
            if t is not None:
                self._births[key] = t

    def mark_births(self, lo: int, hi: int, tick=None) -> None:
        """Stamp integer-index keys ``lo..hi-1`` (driver ingest chunks)."""
        t = self.now(tick)
        if t is None:
            return
        births = self._births
        for k in range(int(lo), int(hi)):
            if k not in births:
                births[k] = t

    # ------------------------------------------------------------ decided

    def record_decided(
        self, key, round_, round_received, birth=None, now=None,
        phase: Optional[str] = None,
    ) -> None:
        """One event reached its consensus slot.

        ``rounds_to_decision = round_received - round`` is recorded
        always; ``time_to_finality`` only when a birth tick is known
        (explicit ``birth`` wins, else the stamp from
        :meth:`mark_birth`) *and* a current tick is available.
        """
        rtd = int(round_received) - int(round_)
        self.rtd.append(rtd)
        if birth is None:
            birth = self._births.pop(key, None)
        else:
            self._births.pop(key, None)
        ttf = None
        if birth is not None:
            t = self.now(now)
            if t is not None:
                ttf = float(t) - float(birth)
                if ttf < 0:
                    # decided-before-born can only mean the birth stamp
                    # and the clock live in different domains (logical
                    # tick vs wall seconds) — drop rather than poison
                    ttf = None
                else:
                    self.ttf.append(ttf)
        if phase is not None:
            self.phases[phase] = self.phases.get(phase, 0) + 1
        reg = self._registry
        if reg is not None:
            if self._h_rtd is None:
                self._h_rtd = reg.histogram(
                    "finality_rounds_to_decision",
                    {"engine": self.engine}, buckets=ROUNDS_BUCKETS,
                )
            self._h_rtd.observe(rtd)
            if ttf is not None:
                h = self._h_ttf.get(phase)
                if h is None:
                    labels = {"engine": self.engine}
                    if phase is not None:
                        labels["phase"] = phase
                    h = self._h_ttf[phase] = reg.histogram(
                        "finality_time_to_finality", labels,
                        buckets=TICKS_BUCKETS,
                    )
                h.observe(ttf)

    # ------------------------------------------------------------- gossip

    def record_gossip_arrival(self, eid, created_tick, now=None) -> None:
        """First *remote* arrival of ``eid``: creation -> here latency.

        Deduplicated per event id — later duplicate deliveries (gossip
        fans out) do not re-observe.
        """
        if eid in self._gossip_seen:
            return
        self._gossip_seen.add(eid)
        t = self.now(now)
        if t is None or created_tick is None:
            return
        d = float(t) - float(created_tick)
        self.gossip.append(d)
        reg = self._registry
        if reg is not None:
            if self._h_gossip is None:
                self._h_gossip = reg.histogram(
                    "finality_gossip_propagation", buckets=TICKS_BUCKETS,
                )
            self._h_gossip.observe(d)

    # ---------------------------------------------------------- watermark

    def set_watermark(self, label: str, decided: int, round_=None) -> None:
        """Per-node decided frontier: events ordered (+ last decided
        round when known)."""
        wm = {"decided": int(decided)}
        if round_ is not None:
            wm["round"] = int(round_)
        self.watermarks[str(label)] = wm
        reg = self._registry
        if reg is not None:
            reg.gauge(
                "finality_decided_watermark", {"node": str(label)}
            ).set(decided)
            if round_ is not None:
                reg.gauge(
                    "finality_decided_round", {"node": str(label)}
                ).set(round_)

    # ------------------------------------------------------------ summary

    def summary(self) -> Dict:
        """Bench-ready digest: decided count, rounds-to-decision
        mean/p50/p99/max, time-to-finality mean/p50/p99/max (same unit
        as the injected clock), phase attribution and gossip stats."""
        out: Dict = {"engine": self.engine, "decided": len(self.rtd)}
        if self.rtd:
            _dist([float(r) for r in self.rtd], "rtd", out)
        if self.ttf:
            _dist(self.ttf, "ttf", out)
        if self.phases:
            out["phases"] = dict(sorted(self.phases.items()))
        if self.gossip:
            _dist(self.gossip, "gossip", out)
            out["gossip_samples"] = len(self.gossip)
        out["undecided"] = len(self._births)
        return out


def record_batch_result(
    tracker: FinalityTracker, result, now=None, birth=None
) -> None:
    """Record every decided event of a batch
    :class:`~tpu_swirld_torch.gpu.pipeline.ConsensusResult` into ``tracker``
    in consensus order.

    The batch engine decides a whole history in one pass, so its
    time-to-finality is degenerate: every event shares the pass-end
    tick; pass ``birth`` (the pass-start tick) to record the uniform
    pass latency, or leave both ``None`` for rounds-only recording.
    """
    rd = result.round
    rr = result.round_received
    t = tracker.now(now)
    for gi in result.order:
        gi = int(gi)
        tracker.record_decided(
            gi, int(rd[gi]), int(rr[gi]), birth=birth, now=t,
        )
