"""Observability: structured spans, protocol gauges, finality tracking and
the flight recorder (the port's copy of the reference's
``tpu_swirld/obs/``, same names, same metric families, same file formats).

- :mod:`~tpu_swirld_torch.obs.tracer`: a nested-span tracer with JSONL
  export in Chrome trace-event form.
- :mod:`~tpu_swirld_torch.obs.registry`: counters / gauges / histograms
  with Prometheus-text and JSON exporters.
- :mod:`~tpu_swirld_torch.obs.report`: ``python -m tpu_swirld_torch.obs
  report <trace.jsonl>`` renders the phase table and the gauges.
- :mod:`~tpu_swirld_torch.obs.finality`: per-event lifecycle
  (rounds-to-decision, time-to-finality, decided watermarks).
- :mod:`~tpu_swirld_torch.obs.flightrec`: bounded rings of recent
  activity, dumped as post-mortem JSON on a trigger (schema
  ``"tpu-swirld-flightrec/1"``: a dump of either package loads in the
  other).
- :mod:`~tpu_swirld_torch.obs.profile` / :mod:`~tpu_swirld_torch.obs.
  memory`: the dispatch profiler and the per-phase memory census.

Instrumented layers: the node's oracle phases and gossip, the device
pipeline's stages (every :class:`~tpu_swirld_torch.device.StageClock`
stage routes through :func:`stage_call`), the drivers' window gauges and
flight-recorder triggers, the slab store and the mesh driver.  For the
card's own timeline use :func:`tpu_swirld_torch.metrics.trace_consensus`
(a ``torch.profiler`` trace).

Everything is **off by default**: the hot paths read one module global
(``obs.current() is None``) and touch nothing else.  Enable around a
region::

    from tpu_swirld_torch import obs

    with obs.enabled() as o:
        run_consensus(packed, config, device="cuda")
    o.save("swirld.trace.jsonl")
    print(o.registry.to_prometheus_text())
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

from tpu_swirld_torch.obs.finality import (  # noqa: F401
    FinalityTracker, record_batch_result,
)
from tpu_swirld_torch.obs.flightrec import (  # noqa: F401
    FlightRecorder, load_dump,
)
from tpu_swirld_torch.obs.memory import (  # noqa: F401
    MemoryMonitor, device_live_bytes,
)
from tpu_swirld_torch.obs.profile import DispatchProfiler  # noqa: F401
from tpu_swirld_torch.obs.registry import (  # noqa: F401
    Counter, Gauge, Histogram, Registry,
)
from tpu_swirld_torch.obs.tracer import (  # noqa: F401
    NULL_TRACER, NullTracer, Tracer, load_trace,
)


class Obs:
    """A tracer + registry bundle, the unit :func:`enable` installs.  An
    optional :class:`DispatchProfiler` rides along; when present, every
    :func:`stage_call` feeds it."""

    def __init__(
        self,
        tracer: Optional[Tracer] = None,
        registry: Optional[Registry] = None,
        profiler: Optional[DispatchProfiler] = None,
    ):
        self.tracer = tracer if tracer is not None else Tracer()
        self.registry = registry if registry is not None else Registry()
        self.profiler = profiler

    def save(self, path: str) -> None:
        """Write the trace plus the registry snapshot (as Chrome counter
        samples) so one file carries both timing and gauges.  The tracer
        itself is not mutated."""
        import json as _json

        from tpu_swirld_torch.obs.registry import Histogram as _H, _num

        events = list(self.tracer.events)
        for m in self.registry.metrics():
            labels = {k: v for k, v in m.labels}
            if isinstance(m, _H):
                events.append(
                    self.tracer.counter_event(
                        m.name + "_count", m.count, labels
                    )
                )
                events.append(
                    self.tracer.counter_event(
                        m.name + "_sum", round(m.sum, 9), labels
                    )
                )
            else:
                events.append(
                    self.tracer.counter_event(m.name, _num(m.value), labels)
                )
        with open(path, "w") as f:
            for e in events:
                f.write(_json.dumps(e) + "\n")


_current: Optional[Obs] = None


def current() -> Optional[Obs]:
    """The ambient Obs, or None when observability is disabled (default).
    Hot paths gate on this: one global read on the disabled path."""
    return _current


def enable(obs: Optional[Obs] = None) -> Obs:
    """Install (and return) the ambient Obs."""
    global _current
    _current = obs if obs is not None else Obs()
    return _current


def disable() -> Optional[Obs]:
    """Clear the ambient Obs; returns the one that was active."""
    global _current
    prev, _current = _current, None
    return prev


@contextlib.contextmanager
def enabled(obs: Optional[Obs] = None):
    """Scoped enable: ``with obs.enabled() as o: ...`` (restores the
    previous ambient Obs on exit, so scopes nest)."""
    global _current
    prev = _current
    o = obs if obs is not None else Obs()
    _current = o
    try:
        yield o
    finally:
        _current = prev


@contextlib.contextmanager
def phase_scope(metrics, tracer, name: str):
    """Combined per-phase scope: times into ``metrics`` (a
    :class:`tpu_swirld_torch.metrics.Metrics`) and/or spans into
    ``tracer``, either of which may be None."""
    if tracer is not None and metrics is not None:
        with tracer.span(name), metrics.phase(name):
            yield
    elif tracer is not None:
        with tracer.span(name):
            yield
    elif metrics is not None:
        with metrics.phase(name):
            yield
    else:
        yield


# Audit seam: a callback recording every stage call's name and arguments
# (the reference's jit audit installs one).  None in production.
_stage_observer = None


def set_stage_observer(cb) -> None:
    """Install (or clear, with None) the stage-call observer: called as
    ``cb(name, fn, args, kw)`` before every observed stage dispatch."""
    global _stage_observer
    _stage_observer = cb


def stage_call(name: str, fn, *args, **kw):
    """Run a stage under the ambient Obs (a pass-through when disabled):
    spans the call, synchronizes the CUDA device the stage ran on so the
    span measures its completion on the card, and classifies the call as
    ``compile`` (a kernel library was built or loaded during it,
    :data:`tpu_swirld_torch.gpu.build.load_count`) or ``execute``.

    Enabling observability therefore synchronizes stage boundaries, as
    :class:`~tpu_swirld_torch.device.StageClock` always does."""
    return _stage_call(name, 1, fn, args, kw, None)


def stage_call_fused(name: str, fused_chunks: int, fn, *args, **kw):
    """:func:`stage_call` for a dispatch covering ``fused_chunks`` scan
    chunks (the fused rounds span): the dispatch profiler attributes its
    one inter-dispatch gap per chunk (gap / K)."""
    return _stage_call(name, max(1, int(fused_chunks)), fn, args, kw, None)


def _stage_call(name: str, fused_chunks: int, fn, args, kw, device):
    """The stage seam.  ``device`` is the stage's torch device (None:
    the first tensor argument's, else the CPU)."""
    so = _stage_observer
    if so is not None:
        so(name, fn, args, kw)
    o = _current
    if o is None:
        return fn(*args, **kw)
    import torch

    from tpu_swirld_torch.gpu import build

    if device is None:
        device = _device_of(args)
    c0 = build.load_count
    t0 = time.perf_counter()
    with o.tracer.span(name) as sp:
        out = fn(*args, **kw)
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        dt = t1 - t0
        kind = "compile" if build.load_count > c0 else "execute"
        sp.args["kind"] = kind   # inside the span: lands in the event
    reg = o.registry
    reg.counter("pipeline_stage_seconds", {"stage": name, "kind": kind}).inc(dt)
    reg.counter("pipeline_stage_calls", {"stage": name, "kind": kind}).inc()
    if o.profiler is not None and kind == "execute":
        # a build is a one-time cost, not steady-state dispatch overhead
        o.profiler.record_dispatch(
            name, t0, t1, args=args, fused_chunks=fused_chunks,
            device=device,
        )
    return out


def _device_of(args):
    import torch

    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return None


def to_host(x, copy: bool = False):
    """Pull a tensor (or array) to host numpy, counting the D2H bytes of
    a device tensor into the ambient dispatch profiler.  A CPU tensor's
    array shares its memory; ``copy=True`` returns an owned array."""
    import numpy as _np
    import torch

    if isinstance(x, torch.Tensor):
        on_device = x.device.type != "cpu"
        arr = x.cpu().numpy()
    else:
        on_device = False
        arr = _np.asarray(x)
    if copy:
        arr = arr.copy()
    o = _current
    if o is not None and o.profiler is not None and on_device:
        o.profiler.record_transfer("d2h", arr.nbytes)
    return arr


def compile_counts(registry) -> dict:
    """Per-stage count of ``kind == "compile"`` calls recorded by
    :func:`stage_call` in ``registry``.  A warm loop under a fresh Obs
    must come back empty: it built and loaded no kernel library."""
    out: dict = {}
    for m in registry.metrics():
        if m.name != "pipeline_stage_calls":
            continue
        labels = dict(m.labels)
        if labels.get("kind") == "compile":
            stage = labels.get("stage", "?")
            out[stage] = out.get(stage, 0) + int(m.value)
    return out
