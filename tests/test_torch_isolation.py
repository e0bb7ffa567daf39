"""The port stands alone: it imports neither jax nor the JAX package, its
entry points refuse to fall back to the CPU, and chip_smoke.py prints no
result without a CUDA device or without the rest of the repo."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_swirld_torch import (
    IncrementalConsensus, MeshStreamingConsensus, StreamingConsensus, make_mesh,
)
from tpu_swirld_torch.gpu import pipeline
from tpu_swirld_torch.packing import pack_events
from tpu_swirld_torch.sim import generate_gossip_dag

ROOT = Path(__file__).resolve().parents[1]


def _port_files():
    files = sorted((ROOT / "tpu_swirld_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "tpu_swirld")


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_files()
    assert len(files) > 5
    bad = [
        (str(f.relative_to(ROOT)), m)
        for f in files for m in _imported_modules(f) if _forbidden(m)
    ]
    assert bad == []


def test_import_leaves_jax_unloaded():
    code = "import tpu_swirld_torch.gpu.pipeline, sys; assert 'jax' not in sys.modules"
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_run_consensus_without_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    members, stake, events, _keys = generate_gossip_dag(4, 40, seed=1)
    packed = pack_events(events, members, stake)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.run_consensus(packed)


def test_incremental_without_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    members, _stake, _events, _keys = generate_gossip_dag(4, 40, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IncrementalConsensus(members)


def test_streaming_without_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    members, _stake, _events, _keys = generate_gossip_dag(4, 40, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingConsensus(members)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshStreamingConsensus(make_mesh(2, device="cpu"), members)


def _chip_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_a_gpu():
    proc = _chip_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _chip_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
