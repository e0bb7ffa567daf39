"""Device resolution, the per-stage clock, and host pulls.

Counterparts: ``pallas_kernels.accel_compiled``/``resolve_interpret``
(here the kernel or its plain version is chosen by where the tensors live),
``pipeline.default_matmul_dtype`` (the port has no dtype choice: its CUDA
kernels use bit operations, and its plain matmuls run in float32 with TF32
off, pinned below) and ``obs.stage_call`` / ``obs.to_host``.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

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
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}

    def stage_call(self, name: str, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.seconds[name] = self.seconds.get(name, 0.0) + dt
        self.calls[name] = self.calls.get(name, 0) + 1
        return out


def to_host(x: torch.Tensor) -> np.ndarray:
    """Pull a tensor to host numpy (blocks on the device)."""
    return x.cpu().numpy()
