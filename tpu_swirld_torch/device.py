"""Device resolution, the per-stage clock, and host pulls.

Counterparts: ``pallas_kernels.accel_compiled``/``resolve_interpret``
(here the kernel or its plain version is chosen by where the tensors live),
``pipeline.default_matmul_dtype`` (the port has no dtype choice: its CUDA
kernels use bit operations, and its plain matmuls run in float32 with TF32
off, pinned below).  :func:`to_host` is :func:`tpu_swirld_torch.obs.
to_host`, the pull seam that counts D2H bytes into the ambient profiler.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch

from tpu_swirld_torch import obs
from tpu_swirld_torch.obs import to_host  # noqa: F401  (the pull seam)

# The fame stake tallies multiply stake values into float32 matmuls, exact
# only while inputs and sums stay exact in f32 (below 2^24).  TF32 rounds the
# inputs to 10 mantissa bits and would break that, so it is pinned off here,
# once, for every matmul the port runs.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.  ``"cuda"`` (the default of
    every entry point) raises when no GPU is present: the port never falls
    back to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class StageClock:
    """Per-stage wall seconds and call counts of one pipeline run.

    ``stage_call`` synchronizes the CUDA device after the stage, so a
    stage's seconds measure its completion on the card, not its enqueue.
    Every stage also routes through :func:`tpu_swirld_torch.obs.
    stage_call`'s seam, which records it under the ambient ``Obs`` (a span,
    ``pipeline_stage_seconds`` / ``pipeline_stage_calls``, the dispatch
    profiler) and passes it through when observability is off.  Under a
    running ``torch.profiler`` each stage is also a ``record_function``
    range named after it, so a trace shows which stage a kernel ran in.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}

    def stage_call(self, name: str, fn, *args, **kw):
        return self._call(name, 1, fn, args, kw)

    def stage_call_fused(self, name: str, fused_chunks: int, fn, *args, **kw):
        """:meth:`stage_call` for a dispatch covering ``fused_chunks`` scan
        chunks (``obs.stage_call_fused``)."""
        return self._call(name, max(1, int(fused_chunks)), fn, args, kw)

    def _call(self, name, fused_chunks, fn, args, kw):
        t0 = time.perf_counter()
        with (torch.profiler.record_function(name)
              if torch.autograd._profiler_enabled() else contextlib.nullcontext()):
            out = obs._stage_call(name, fused_chunks, fn, args, kw, self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.seconds[name] = self.seconds.get(name, 0.0) + dt
        self.calls[name] = self.calls.get(name, 0) + 1
        return out
