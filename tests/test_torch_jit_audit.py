"""The port's stage-call auditor (``tpu_swirld_torch.analysis.jit_audit``):
the static pass over the kernel modules' stage bodies, the drift finder,
and the runtime audit of the windowed drivers on the CPU, held against the
reference's jit audit where the two observe the same thing."""

import json
from pathlib import Path

import pytest
import torch

import chip_smoke
from tpu_swirld.analysis import jit_audit as ref_jit_audit
from tpu_swirld_torch.analysis import jit_audit

pytestmark = pytest.mark.analysis

ROOT = Path(__file__).resolve().parents[1]

#: the reference's incremental audit observes its a-side gather cache as two
#: stages; the port runs one block stage (ROADMAP C)
REF_ONLY_STAGES = {"pipeline.ssm_block_from_rows", "pipeline.ssm_gather_rows"}
PORT_ONLY_STAGES = {"pipeline.ssm_block_stage"}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _triples(findings):
    return [(f["path"], f["stage"], f["message"]) for f in findings]


# ---------------------------------------------------------------- static


def test_static_audit_on_the_tree_is_the_recorded_list():
    """The findings PERF.md records and phase 17(d) holds: none, since the
    full path's rounds stage takes its parents on the host
    (``rounds_scan_stage``) and stage B its used slots
    (``_used_slots``)."""
    assert _triples(jit_audit.static_audit(str(ROOT))) == chip_smoke.STATIC_AUDIT_FINDINGS
    assert chip_smoke.STATIC_AUDIT_FINDINGS == []


def _tree(tmp_path, body):
    mod = tmp_path / "tpu_swirld_torch" / "gpu" / "pipeline.py"
    mod.parent.mkdir(parents=True)
    mod.write_text(body)
    return str(tmp_path)


def test_rounds_loops_pull_only_the_check_buffer(tmp_path):
    """Each driver loop around the rounds stages pulls one check buffer a
    call; the table and the rounds only through ``table_check``, when a
    check list overflowed.  A loop that pulls the table again is seen."""
    want_fallback = ["tab", "rnd"]
    assert jit_audit.rounds_loop_pulls(str(ROOT)) == {
        "_columns_pass": {"per_call": ["check"], "fallback": want_fallback},
        "_rounds_span_fixpoint": {"per_call": ["check"], "fallback": want_fallback},
        "_rounds_chunk_loop": {"per_call": ["check"], "fallback": want_fallback},
    }
    root = _tree(tmp_path, (
        "def _columns_pass(stages, out, chk):\n"
        "    for start in range(4):\n"
        "        out = stages.stage_call('pipeline.rounds_chunk_stage', f, out)\n"
        "        tab = to_host(out[2])\n"
        "        c = to_host(chk)\n"
    ))
    assert jit_audit.rounds_loop_pulls(root) == {
        "_columns_pass": {"per_call": ["out[2]", "chk"], "fallback": []}}
    assert jit_audit.main(["--root", root, "--static-only"]) == 1


def test_static_audit_catches_item_in_a_stage_body(tmp_path):
    root = _tree(tmp_path, (
        "def stage(x):\n"
        "    return x.sum().item()\n"
        "\n"
        "def driver(stages, x):\n"
        "    y = stages.stage_call('pipeline.s', stage, x)\n"
        "    return y\n"
    ))
    findings = jit_audit.static_audit(root)
    assert [(f["stage"], f["line"]) for f in findings] == [("stage", 2)]
    assert ".item()" in findings[0]["message"]


@pytest.mark.parametrize("expr", [
    "x.item()", "x.tolist()", "x.cpu()", "x.numpy()", "to_host(x)",
    "torch.cuda.synchronize()", "np.asarray(x)", "np.array(x)",
    "numpy.asarray(x)", "int(x)", "float(x)", "bool(x)",
])
def test_static_audit_sync_kinds(tmp_path, expr):
    root = _tree(tmp_path, (
        f"def body(x):\n    return {expr}\n\n"
        "def fused(stages, x):\n"
        "    return stages.stage_call_fused('pipeline.f', 2, body, x)\n"
    ))
    assert [f["stage"] for f in jit_audit.static_audit(root)] == ["body"]


def test_static_audit_skips_pulls_between_stage_calls(tmp_path):
    """A pull in the dispatching code, or in a function no stage call
    names, is not inside a stage body."""
    root = _tree(tmp_path, (
        "def stage(x):\n"
        "    return x + 1\n"
        "\n"
        "def helper(x):\n"
        "    return x.item()\n"
        "\n"
        "def driver(stages, x, seam):\n"
        "    y = stages.stage_call('pipeline.s', stage, x)\n"
        "    n = int(to_host(y).max())\n"
        "    return stages.stage_call('pipeline.t', seam, y, n)\n"
    ))
    assert jit_audit.static_audit(root) == []


def test_static_audit_kernel_modules_match_the_issue():
    assert jit_audit._KERNEL_MODULES == (
        "tpu_swirld_torch/gpu/pipeline.py", "tpu_swirld_torch/gpu/incremental.py",
        "tpu_swirld_torch/gpu/kernels.py", "tpu_swirld_torch/parallel.py",
        "tpu_swirld_torch/store/streaming.py",
    )


# ----------------------------------------------------------------- drift


def test_abstract_values():
    t = torch.zeros((4, 4), dtype=torch.int32)
    assert jit_audit._abstract(t) == ("arr", (4, 4), "torch.int32", "cpu")
    assert jit_audit._abstract(7) == ("static", "7")
    assert jit_audit._signature((t, 3), {"r_max": 8}) == (
        ("arr", (4, 4), "torch.int32", "cpu"), ("static", "3"),
        ("r_max", ("static", "8")),
    )


def test_find_drift_unit():
    same = ("arr", (4, 4), "torch.int32", "cuda")
    wide = ("arr", (4, 4), "torch.int64", "cuda")
    host = ("arr", (4, 4), "torch.int32", "cpu")
    other = ("arr", (8, 4), "torch.int32", "cuda")
    assert jit_audit._find_drift({"s": [(same,), (same,)]}) == []
    # same shape, dtype flip -> drift
    drift = jit_audit._find_drift({"s": [(same,), (wide,)]})
    assert len(drift) == 1 and drift[0]["stage"] == "s"
    assert len(drift[0]["variants"]) == 2
    # same shape, device flip -> drift
    assert len(jit_audit._find_drift({"s": [(same,), (host,)]})) == 1
    # different shapes are separate keys, not drift
    assert jit_audit._find_drift({"s": [(same,), (other,)]}) == []
    # a static difference is a separate key too
    assert jit_audit._find_drift(
        {"s": [(same, ("static", "1")), (wide, ("static", "2"))]}) == []


def test_find_drift_matches_reference_on_shapes_and_statics():
    """Where both packages' signatures agree in form (shapes, statics), the
    two drift finders agree."""
    a = ("arr", (4, 4), "int32", False)
    b = ("arr", (4, 4), "int16", False)
    c = ("arr", (8, 4), "int32", False)
    for records in ({"s": [(a,), (a,)]}, {"s": [(a,), (b,)]}, {"s": [(a,), (c,)]},
                    {"s": [(a, ("static", "1")), (b, ("static", "2"))]}):
        assert jit_audit._find_drift(records) == ref_jit_audit._find_drift(records)


# --------------------------------------------------------------- runtime


def test_runtime_audit_incremental_on_the_cpu():
    """Zero steady kernel builds, no drift, the fused span audited, and the
    stages the reference's incremental audit observes, its gather-cache
    pair read as the port's one block stage."""
    r = jit_audit.runtime_audit(device="cpu")
    assert r["engine"] == "incremental" and r["device"] == "cpu"
    assert r["steady_compiles"] == {}, r
    assert r["signature_drift"] == [], r
    assert r["ok"] and r["fused_span_audited"] and r["fuse_chunks"] == 8
    assert r["stages_observed"] == chip_smoke.AUDIT_STAGES
    want = ref_jit_audit.runtime_audit()
    assert want["ok"]
    assert set(r["stages_observed"]) == (
        set(want["stages_observed"]) - REF_ONLY_STAGES | PORT_ONLY_STAGES)
    assert r["fuse_chunks"] == want["fuse_chunks"]


def test_jit_audit_rejects_unknown_engine():
    with pytest.raises(ValueError, match="unknown engine"):
        jit_audit.runtime_audit(engine="warp")


def test_runtime_audit_without_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jit_audit.runtime_audit()


def test_jit_audit_cli(tmp_path, capsys):
    """The CLI exits 0 on this tree (static pass and runtime pass clean on
    the CPU) and 1 on a tree with a host sync in a stage body."""
    assert jit_audit.main(["--root", str(ROOT), "--device", "cpu", "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] and rep["runtime"]["ok"] and rep["static"] == []
    assert rep["rounds_pulls"] == jit_audit.rounds_loop_pulls(str(ROOT))
    root = _tree(tmp_path, (
        "def stage(x):\n    return int(x.max())\n\n"
        "def driver(stages, x):\n    return stages.stage_call('s', stage, x)\n"
    ))
    assert jit_audit.main(["--root", root, "--static-only"]) == 1
    assert "int(...) on a value inside stage stage()" in capsys.readouterr().out


@pytest.mark.slow
def test_runtime_audit_streaming_engine():
    """The engine phase 17(c) audits on the card: its stage set on the CPU
    is chip_smoke.AUDIT_STAGES."""
    r = jit_audit.runtime_audit(engine="streaming", device="cpu")
    assert r["engine"] == "streaming"
    assert r["ok"], r
    assert r["stages_observed"] == chip_smoke.AUDIT_STAGES


@pytest.mark.slow
def test_runtime_audit_mesh_engine():
    r = jit_audit.runtime_audit(engine="mesh", device="cpu")
    assert r["engine"] == "mesh"
    assert r["ok"], r
    want = ref_jit_audit.runtime_audit(engine="mesh")
    assert r["stages_observed"] == want["stages_observed"]
