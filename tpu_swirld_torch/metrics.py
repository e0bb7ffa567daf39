"""Metrics shim over :mod:`tpu_swirld_torch.obs` (the port's copy of the
reference's ``tpu_swirld/metrics.py``).

``Metrics`` (``phase`` / ``count`` / ``snapshot``) records into an
:class:`~tpu_swirld_torch.obs.registry.Registry`, its own or a shared one,
so per-node counters and the ambient pipeline metrics export through one
Prometheus/JSON pipe.  :func:`node_gauges` reads a node's protocol gauges.
:func:`trace_consensus` runs the device pipeline under a
``torch.profiler`` trace (the reference's is a ``jax.profiler`` trace),
viewable in Perfetto / ``chrome://tracing``.

Off by default: enable per node with ``node.metrics = Metrics()`` or pass
``metrics=`` / ``tracer=`` to :func:`tpu_swirld_torch.sim.make_simulation`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

from tpu_swirld_torch.obs.registry import Counter, Registry

PHASE_METRIC = "phase_seconds"


class Metrics:
    """Cumulative phase timers + counters (registry-backed shim).

    ``seconds`` / ``counts`` remain available as dict views derived from
    the registry, so pre-obs consumers (and ``tests/test_aux.py``) see the
    original shape.
    """

    def __init__(self, registry: Optional[Registry] = None) -> None:
        self.registry = registry if registry is not None else Registry()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.registry.counter(PHASE_METRIC, {"phase": name}).inc(
                time.perf_counter() - t0
            )

    def count(self, name: str, delta: int = 1) -> None:
        # the pre-obs surface accepted any delta (plain dict addition);
        # keep that contract — bypass Counter.inc's monotonic guard
        self.registry.counter(name).value += delta

    @property
    def seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for labels, m in self.registry.collect(PHASE_METRIC).items():
            d = dict(labels)
            if "phase" in d:            # ignore non-phase variants
                out[d["phase"]] = m.value
        return out

    @property
    def counts(self) -> Dict[str, int]:
        return {
            m.name: int(m.value)
            for m in self.registry.metrics()
            if isinstance(m, Counter)
            and not m.labels
            and m.name != PHASE_METRIC
        }

    def snapshot(self) -> Dict[str, float]:
        seconds = self.seconds
        counts = self.counts
        out: Dict[str, float] = {}
        out.update({f"s_{k}": round(v, 6) for k, v in seconds.items()})
        out.update({f"n_{k}": v for k, v in counts.items()})
        total = sum(
            seconds.get(k, 0.0)
            for k in ("divide_rounds", "decide_fame", "find_order")
        )
        ordered = counts.get("events_ordered", 0)
        if total > 0 and ordered:
            out["events_per_sec_to_consensus"] = round(ordered / total, 2)
        return out


def node_gauges(
    node,
    registry: Optional[Registry] = None,
    node_label: Optional[str] = None,
) -> Dict[str, int]:
    """Protocol-level gauges for one oracle node.

    Robust to partially-shaped nodes (checkpoint-restored or backend-engine
    nodes may lack optional attributes): every read goes through the public
    surface (``node.orphans_parked`` / ``node.forks_detected``) or a
    ``getattr`` default.  With ``registry=``, each gauge is also recorded
    as ``node_<name>{node=...}`` — labelled by ``node_label`` (default: the
    node's pk prefix) so exporting a whole population into one shared
    registry keeps every node distinct.
    """
    famous = getattr(node, "famous", {})
    undecided = sum(1 for f in famous.values() if f is None)
    max_round = getattr(node, "max_round", 0)
    gauges = {
        "events": len(getattr(node, "hg", ())),
        "events_ordered": len(getattr(node, "consensus", ())),
        "max_round": max_round,
        "decided_round_lag": max_round - getattr(node, "consensus_round", 0),
        "undecided_witnesses": undecided,
        "orphans_parked": getattr(node, "orphans_parked", 0),
        # admission-control gauge: the tx ingestion layer sheds client
        # submissions while this exceeds its configured threshold
        "undecided_window": getattr(node, "undecided_window", 0),
        "late_witnesses": len(getattr(node, "late_witnesses", ())),
        "horizon_violations": getattr(node, "horizon_violations", 0),
        "forks_detected": getattr(node, "forks_detected", 0),
        "equivocations_detected": getattr(node, "equivocations_detected", 0),
        "withholding_suspected": getattr(node, "withholding_suspected", 0),
        "budget_exhausted": getattr(node, "budget_exhausted", 0),
        "sync_branches_capped": getattr(node, "sync_branches_capped", 0),
        "bad_replies": getattr(node, "bad_replies", 0),
        "bad_requests": getattr(node, "bad_requests", 0),
        "retries": getattr(node, "retries", 0),
        "backoff_total": getattr(node, "backoff_total", 0.0),
        "quarantined_peers": getattr(node, "quarantined_peers", 0),
        "circuit_opens": getattr(node, "circuit_opens", 0),
        # finality surface: the decided frontier (consensus length) and
        # the last round whose order is committed
        "decided_watermark": len(getattr(node, "consensus", ())),
        "decided_round": getattr(node, "consensus_round", 0) - 1,
        # dynamic-membership surface (membership/): a static node reports
        # the trivial single-epoch values, so dashboards read one schema
        "membership_epoch": getattr(node, "membership_epoch", 0),
        "members_active": getattr(
            node, "members_active", len(getattr(node, "members", ()))
        ),
        "stake_total": getattr(
            node, "stake_total", getattr(node, "tot_stake", 0)
        ),
    }
    if registry is not None:
        if node_label is None:
            pk = getattr(node, "pk", None)
            node_label = pk[:4].hex() if isinstance(pk, bytes) else None
        labels = {"node": node_label} if node_label is not None else None
        for k, v in gauges.items():
            registry.gauge(f"node_{k}", labels).set(v)
        # also published under the finality_* family so the report CLI's
        # finality section shows per-node watermarks without node_ noise
        registry.gauge("finality_decided_watermark", labels).set(
            gauges["decided_watermark"]
        )
        registry.gauge("finality_decided_round", labels).set(
            gauges["decided_round"]
        )
    return gauges


def trace_consensus(packed, config=None, outdir: str = "swirld-trace",
                    device="cuda", **kw):
    """Run :func:`~tpu_swirld_torch.gpu.pipeline.run_consensus` under a
    ``torch.profiler`` trace of the host and, on a CUDA device, the card;
    write it as a Chrome trace (``outdir/trace.json``) and return the
    result, its ``timings`` holding ``trace_export_seconds`` (the
    profiler's stop and the export).  ``device="cuda"`` raises without a
    GPU.  Each pipeline stage is a ``record_function`` range named after
    it in the trace."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_swirld_torch.device import resolve_device
    from tpu_swirld_torch.gpu.pipeline import run_consensus

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        result = run_consensus(packed, config, device=dev, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
    os.makedirs(outdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(outdir, "trace.json"))
    # the profiler's stop, its event parsing and the export
    result.timings["trace_export_seconds"] = time.perf_counter() - t0
    return result
