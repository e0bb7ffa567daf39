"""Per-phase peak-memory high-water marks, host and device (the port's
counterpart of the reference's ``tpu_swirld/obs/memory.py``).

Wrap each phase in :meth:`MemoryMonitor.phase`:

- **host**: ``tracemalloc``, the phase's *peak* traced allocation
  (``reset_peak`` at entry, ``get_traced_memory()[1]`` at exit), so a
  transient spike freed before the phase ends is still caught.  Tracing
  slows allocation-heavy host code; pass ``enable_host=False`` around a
  timed region.
- **device**: on a CUDA device, the caching allocator's own high-water
  mark: ``torch.cuda.reset_peak_memory_stats`` at entry,
  ``torch.cuda.max_memory_allocated`` at exit (the reference, which has no
  allocator mark, samples a census of live buffers instead).  On the CPU
  there is no device memory to census: the device peak stays 0.  An
  explicit :meth:`sample` adds :func:`device_live_bytes` as a sample.

Results land in ``self.phases`` and, under an ambient Obs, in
``mem_host_peak_bytes{phase=...}`` / ``mem_device_peak_bytes{phase=...}``
gauges.  :meth:`flat` renders a flat ``mem_<phase>_*`` dict.
"""

from __future__ import annotations

import contextlib
import tracemalloc
from typing import Dict


def device_live_bytes(device="cuda") -> int:
    """Bytes of live tensors the caching allocator holds on ``device``
    (``torch.cuda.memory_allocated``); 0 for the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return 0
    return int(torch.cuda.memory_allocated(dev))


class MemoryMonitor:
    """Collect per-phase host/device peaks (see module doc).

    ``device`` is the torch device whose memory is censused (default
    ``"cuda"``, which raises without a GPU, as every entry point does;
    ``"cpu"`` records host peaks only)."""

    def __init__(self, enable_host: bool = True, device="cuda"):
        from tpu_swirld_torch.device import resolve_device

        self.device = resolve_device(device)
        self.enable_host = enable_host
        self.phases: Dict[str, Dict[str, int]] = {}
        self._started_tracing = False
        if enable_host and not tracemalloc.is_tracing():
            tracemalloc.start()
            self._started_tracing = True

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.enable_host and tracemalloc.is_tracing():
            tracemalloc.reset_peak()
        rec = self.phases.setdefault(
            name, {"host_peak_bytes": 0, "device_peak_bytes": 0}
        )
        on_card = self.device.type == "cuda"
        if on_card:
            import torch

            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        try:
            yield self
        finally:
            if self.enable_host and tracemalloc.is_tracing():
                _cur, peak = tracemalloc.get_traced_memory()
                rec["host_peak_bytes"] = max(
                    rec["host_peak_bytes"], int(peak)
                )
            if on_card:
                import torch

                torch.cuda.synchronize(self.device)
                rec["device_peak_bytes"] = max(
                    rec["device_peak_bytes"],
                    int(torch.cuda.max_memory_allocated(self.device)),
                )
            self._export(name, rec)

    def sample(self, name: str) -> None:
        """An extra device sample: the live bytes now."""
        rec = self.phases.setdefault(
            name, {"host_peak_bytes": 0, "device_peak_bytes": 0}
        )
        rec["device_peak_bytes"] = max(
            rec["device_peak_bytes"], device_live_bytes(self.device)
        )

    def _export(self, name: str, rec: Dict[str, int]) -> None:
        from tpu_swirld_torch import obs

        o = obs.current()
        if o is None:
            return
        g = o.registry
        g.gauge("mem_host_peak_bytes", {"phase": name}).set(
            rec["host_peak_bytes"]
        )
        g.gauge("mem_device_peak_bytes", {"phase": name}).set(
            rec["device_peak_bytes"]
        )

    # ------------------------------------------------------------ report

    @property
    def peak_host_bytes(self) -> int:
        return max(
            (r["host_peak_bytes"] for r in self.phases.values()), default=0
        )

    @property
    def peak_device_bytes(self) -> int:
        return max(
            (r["device_peak_bytes"] for r in self.phases.values()), default=0
        )

    def flat(self) -> Dict[str, int]:
        """``{"mem_<phase>_host_peak_bytes": ..., ...}`` for a flat merge."""
        out: Dict[str, int] = {}
        for name, rec in self.phases.items():
            out[f"mem_{name}_host_peak_bytes"] = rec["host_peak_bytes"]
            out[f"mem_{name}_device_peak_bytes"] = rec["device_peak_bytes"]
        return out

    def close(self) -> None:
        if self._started_tracing and tracemalloc.is_tracing():
            tracemalloc.stop()
            self._started_tracing = False
