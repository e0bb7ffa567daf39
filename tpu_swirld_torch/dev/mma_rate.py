"""The operations a second of two warp-level tensor-core products on one CUDA
card (an H100), run back to back from registers on every SM:

    python3 -m tpu_swirld_torch.dev.mma_rate

``b1_and_popc`` is ``mma.sync`` m16n8k256 ``.b1`` AND-popc, ``s8`` is
m16n8k32 ``.s8``; both count two operations a multiply-add, as the data
sheet counts its int8 rate (an AND-product of two bits is one multiply-add).
Builds ``mma_rate.cu`` beside this file with ``nvcc`` into ``gpu/_build/``
and prints one JSON line with the card's name.  The ``.b1`` figure is the
peak behind ``chip_smoke.py``'s ``B1_OPS_PER_S``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from pathlib import Path

import torch

from tpu_swirld_torch.gpu import build

SOURCE = Path(__file__).resolve().parent / "mma_rate.cu"
CHAINS = 8                      # mma_rate.cu's independent accumulators a warp


def _library() -> ctypes.CDLL:
    out = build.BUILD_DIR / "mma_rate.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(out), str(SOURCE)],
        check=True,
    )
    return ctypes.CDLL(str(out))


def rates(iters: int = 2048, reps: int = 5) -> dict:
    """Operations a second of each product: the median of ``reps`` timed
    launches of 4 blocks of 256 threads an SM, after one warm-up."""
    fn = _library().mma_rate_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    threads = 256
    inp = torch.randint(0, 2**31 - 1, (160,), dtype=torch.int32, device="cuda")
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    result = {}
    for route, name, k in ((0, "b1_and_popc", 256), (1, "s8", 32)):
        def launch():
            err = fn(route, inp.data_ptr(), iters, blocks, threads, out.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"mma_rate {name}: cudaError_t {err}")
        launch()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = sorted(times)[len(times) // 2]
        mmas = blocks * threads // 32 * CHAINS * iters
        result[name] = 2 * mmas * 16 * 8 * k / (ms * 1e-3)
    return result


if __name__ == "__main__":
    print(json.dumps({"card": torch.cuda.get_device_name(0), **rates()}))
