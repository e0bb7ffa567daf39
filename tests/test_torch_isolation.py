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
OBS_MODULES = ("__init__", "__main__", "registry", "tracer", "profile",
               "memory", "finality", "flightrec", "report", "cluster_trace")
NET_MODULES = ("__init__", "frame", "wal", "ingest", "transport", "traffic",
               "proxy", "node_proc", "cluster")
MC_MODULES = ("__init__", "world", "encode", "invariants", "explore",
              "mutations", "counterexample", "cli")
ANALYSIS_MODULES = ("lint", "races", "jit_audit", "rules/__init__",
                    "rules/determinism", "rules/asserts", "rules/locks",
                    "rules/dtype", "rules/donation", "flow/__init__",
                    "flow/lattice", "flow/envelope", "flow/transfer",
                    "flow/interpret", "flow/stages", "flow/audit")


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
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {
        "tpu_swirld_torch/backend.py", "tpu_swirld_torch/oracle/node.py",
        "tpu_swirld_torch/oracle/graph.py", "tpu_swirld_torch/transport.py",
        "tpu_swirld_torch/sim.py", "tpu_swirld_torch/metrics.py",
        "tpu_swirld_torch/checkpoint.py",
        "tpu_swirld_torch/chaos.py", "tpu_swirld_torch/adversary.py",
        "tpu_swirld_torch/chaos_run.py",
        "tpu_swirld_torch/membership/__init__.py",
        "tpu_swirld_torch/membership/dynamic.py",
        "tpu_swirld_torch/membership/engine.py",
        "tpu_swirld_torch/membership/epoch.py",
        "tpu_swirld_torch/membership/repack.py",
        "tpu_swirld_torch/membership/sim.py",
        "tpu_swirld_torch/membership/txs.py",
        *(f"tpu_swirld_torch/obs/{m}.py" for m in OBS_MODULES),
        *(f"tpu_swirld_torch/net/{m}.py" for m in NET_MODULES),
        "tpu_swirld_torch/cluster_run.py",
        "tpu_swirld_torch/analysis/__init__.py",
        "tpu_swirld_torch/analysis/__main__.py",
        *(f"tpu_swirld_torch/analysis/mc/{m}.py" for m in MC_MODULES),
        *(f"tpu_swirld_torch/analysis/{m}.py" for m in ANALYSIS_MODULES),
        "tpu_swirld_torch/soak.py", "tpu_swirld_torch/soak_run.py",
        "tpu_swirld_torch/viz.py", "tpu_swirld_torch/parallel.py",
        "tpu_swirld_torch/multichip.py",
    } <= names
    bad = [
        (str(f.relative_to(ROOT)), m)
        for f in files for m in _imported_modules(f) if _forbidden(m)
    ]
    assert bad == []


def test_import_leaves_jax_unloaded():
    obs = ", ".join(f"tpu_swirld_torch.obs.{m}" for m in OBS_MODULES[2:])
    net = ", ".join(f"tpu_swirld_torch.net.{m}" for m in NET_MODULES[1:])
    mc = ", ".join(f"tpu_swirld_torch.analysis.mc.{m}" for m in MC_MODULES[1:])
    analysis = ", ".join(f"tpu_swirld_torch.analysis.{m.replace('/', '.')}"
                         for m in ANALYSIS_MODULES)
    code = ("import tpu_swirld_torch, tpu_swirld_torch.gpu.pipeline, "
            "tpu_swirld_torch.checkpoint, tpu_swirld_torch.membership.sim, "
            "tpu_swirld_torch.chaos, tpu_swirld_torch.adversary, "
            "tpu_swirld_torch.chaos_run, tpu_swirld_torch.cluster_run, "
            "tpu_swirld_torch.analysis.__main__, tpu_swirld_torch.soak_run, "
            "tpu_swirld_torch.viz, tpu_swirld_torch.multichip, "
            f"tpu_swirld_torch.metrics, {obs}, {net}, {mc}, {analysis}, sys; "
            "assert 'jax' not in sys.modules and 'tpu_swirld' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


@pytest.mark.parametrize("module", ["tpu_swirld_torch.net.node_proc",
                                    "tpu_swirld_torch.net.cluster",
                                    "tpu_swirld_torch.soak",
                                    "tpu_swirld_torch.analysis.mc",
                                    "tpu_swirld_torch.analysis.lint",
                                    "tpu_swirld_torch.analysis.jit_audit",
                                    "tpu_swirld_torch.viz"])
def test_cluster_processes_leave_torch_unloaded(module):
    """A node process, the cluster supervisor, the soak orchestrator, the
    model checker, the linter, the stage audit's static pass and viz run on
    the host: their import chains load no torch (a node process restarts inside a kill/restart schedule of a few
    seconds)."""
    code = f"import {module}, sys; assert 'torch' not in sys.modules"
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_python_checkpoint_restores_without_torch(tmp_path):
    """A restarted node process's ``load_node`` of its oracle node's
    checkpoint, with no ``device=``: no torch, no GPU needed."""
    code = (
        "import sys\n"
        "from tpu_swirld_torch.checkpoint import load_node, save_node\n"
        "from tpu_swirld_torch.sim import make_simulation\n"
        "sim = make_simulation(4, seed=2)\n"
        "sim.run(120)\n"
        "node = sim.nodes[1]\n"
        f"save_node({str(tmp_path / 'n.swck')!r}, node)\n"
        f"back = load_node({str(tmp_path / 'n.swck')!r}, sk=node.sk, pk=node.pk, network={{}})\n"
        "assert back.state_digest() == node.state_digest() and node.consensus\n"
        "assert 'torch' not in sys.modules\n"
    )
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


def test_memory_monitor_and_trace_without_device_raise_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from tpu_swirld_torch.metrics import trace_consensus
    from tpu_swirld_torch.obs import MemoryMonitor

    members, stake, events, _keys = generate_gossip_dag(4, 40, seed=1)
    packed = pack_events(events, members, stake)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MemoryMonitor(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MemoryMonitor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trace_consensus(packed, outdir=str(tmp_path / "t"), device="cuda")
    assert not (tmp_path / "t").exists()


def test_chaos_without_device_raises_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from tpu_swirld_torch import SCENARIOS, chaos
    from tpu_swirld_torch.sim import make_simulation

    scenario = chaos.ChaosScenario(n_nodes=4, n_turns=40, tpu_node_index=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos.ChaosSimulation(scenario, str(tmp_path / "a"))
    sim = chaos.ChaosSimulation(scenario, str(tmp_path / "b"), device="cpu")
    assert sim.nodes[3]._tpu_engine.device.type == "cpu"
    node = make_simulation(4, seed=1).nodes[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos._engines_agree(node)
    assert chaos._engines_agree(node, device="cpu")["batch_oracle_parity"]
    for name in ("overflow_storm", "membership_churn", "censorship"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SCENARIOS[name](str(tmp_path / name))


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
