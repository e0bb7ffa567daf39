"""The port's ``bench_compare`` against the reference's
``scripts/bench_compare.py``, and ``scripts/lint.sh``'s gates 3 and 4 over
the port (``python -m tpu_swirld_torch.analysis lint-gates``).

The artifact pairs are the reference's contract tests
(``tests/test_aux.py:90``, ``tests/test_finality.py:285``,
``tests/test_analysis.py:428`` and ``:471``, ``tests/test_flow_audit.py:
462``) plus the trace-overhead and soak gates and a wrapped artifact: each
goes through both tools, which must agree on the exit code, the report
lines, every gate's verdict and the regression list.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

from tpu_swirld_torch import bench_compare as port
from tpu_swirld_torch.analysis import lint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tpu_swirld_torch")


def _reference():
    spec = importlib.util.spec_from_file_location(
        "ref_bench_compare", os.path.join(ROOT, "scripts", "bench_compare.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()
SA = {"envelope": "baseline", "clean": True, "findings": 0}
OLD = {"value": 1000.0, "phases": {"pipeline": 1.0}, "incremental": {"steady_evps": 2000.0}}
FIN_OLD = {"value": 100.0, "finality": {"incremental": {"ttf_p99": 1.0, "rtd_mean": 2.0}}}

#: name -> (old, new, extra args, expected exit code)
CASES = {
    # tests/test_aux.py:90
    "aux good": (OLD, {"value": 950.0, "phases": {"pipeline": 1.1},
                       "incremental": {"steady_evps": 2100.0}, "scale_audit": SA}, [], 0),
    "aux headline regression": (OLD, {"value": 800.0, "phases": {},
                                      "incremental": {"steady_evps": 2100.0},
                                      "scale_audit": SA}, [], 1),
    "aux incremental regression": (OLD, {"value": 1000.0, "phases": {},
                                         "incremental": {"steady_evps": 1500.0},
                                         "scale_audit": SA}, [], 1),
    # tests/test_finality.py:285 (lower is better), gated through main
    "finality p99 worse": (FIN_OLD, {"value": 100.0, "scale_audit": SA, "finality": {
        "incremental": {"ttf_p99": 1.25, "rtd_mean": 2.0}}}, [], 1),
    "finality same": (FIN_OLD, dict(FIN_OLD, scale_audit=SA), [], 0),
    # tests/test_analysis.py:428
    "lint dirty": ({"value": 100.0}, {"value": 120.0, "scale_audit": SA, "lint": {
        "findings": 2, "clean": False, "by_rule": {"SW002": 2}}}, [], 1),
    "lint clean": ({"value": 100.0}, {"value": 101.0, "scale_audit": SA, "lint": {
        "findings": 0, "clean": True, "by_rule": {}}}, [], 0),
    "lint missing": ({"value": 100.0}, {"value": 100.0, "scale_audit": SA}, [], 0),
    # tests/test_analysis.py:471
    "mc dirty": ({"value": 100.0}, {"value": 120.0, "scale_audit": SA, "mc": {
        "ok": False, "violations": 1, "exhaustive": True}}, [], 1),
    "mc clean": ({"value": 100.0}, {"value": 101.0, "scale_audit": SA, "mc": {
        "ok": True, "violations": 0, "exhaustive": True}}, [], 0),
    # tests/test_flow_audit.py:462
    "scale_audit dirty": ({"value": 100.0}, {"value": 100.0, "scale_audit": {
        "envelope": "baseline", "clean": False, "findings": 2}}, [], 1),
    "scale_audit missing": ({"value": 100.0}, {"value": 100.0}, [], 1),
    # the other two gates, the lower-is-better peaks, a wrapped artifact,
    # the threshold and key flags
    "trace overhead": ({"value": 100.0}, {"value": 100.0, "scale_audit": SA, "stream": {
        "trace_overhead_ratio": 0.08}}, [], 1),
    "soak red": ({"value": 100.0}, {"value": 100.0, "scale_audit": SA, "soak": {
        "verdict_ok": False, "tx_per_s": 90.0}}, [], 1),
    "soak green, p99 up": ({"value": 100.0, "soak": {"submit_p99_s": 0.5}},
                           {"value": 100.0, "scale_audit": SA, "soak": {
                               "verdict_ok": True, "submit_p99_s": 0.7}}, [], 1),
    "device peak up": ({"value": 100.0, "peak_device_bytes": 1000},
                       {"value": 100.0, "peak_device_bytes": 1200, "scale_audit": SA}, [], 1),
    "wrapped, within threshold": ({"cmd": "bench", "parsed": {"value": 100.0}},
                                  {"cmd": "bench", "parsed": {"value": 85.0,
                                                              "scale_audit": SA}},
                                  ["--threshold", "0.2"], 0),
    "other key": ({"value": 100.0, "stream": {"evps": 50.0}},
                  {"value": 100.0, "stream": {"evps": 40.0}, "scale_audit": SA},
                  ["--key", "stream.evps"], 1),
}

GATES = ("lint_gate", "mc_gate", "scale_audit_gate", "trace_overhead_gate", "soak_gate")


@pytest.mark.parametrize("case", sorted(CASES))
def test_bench_compare_matches_reference(case, tmp_path, capsys):
    old, new, extra, rc = CASES[case]
    po, pn = tmp_path / "old.json", tmp_path / "new.json"
    po.write_text(json.dumps(old))
    pn.write_text(json.dumps(new))
    got = {}
    for who, mod in (("port", port), ("ref", REF)):
        code = mod.main([str(po), str(pn), *extra])
        out, err = capsys.readouterr()
        unwrapped = mod.unwrap(new)
        got[who] = {
            "rc": code, "stdout": out, "fail": "FAIL" in err,
            "gates": {g: getattr(mod, g)(unwrapped) is None for g in GATES},
            "failures": mod.compare(mod.unwrap(old), unwrapped, "value", 0.10)[0],
        }
    assert got["port"] == got["ref"]
    assert got["port"]["rc"] == rc
    if case == "aux headline regression":
        assert "REGRESSION" in got["port"]["stdout"]
    if case == "finality p99 worse":
        assert any("finality.incremental.ttf_p99" in f for f in got["port"]["failures"])


def test_gate_messages_and_key_table():
    """The gates' verdict phrases and the gated keys are the reference's."""
    assert port.EXTRA_KEYS == REF.EXTRA_KEYS
    assert port.MAX_TRACE_OVERHEAD_RATIO == REF.MAX_TRACE_OVERHEAD_RATIO
    dirty = {"scale_audit": {"envelope": "baseline", "clean": False, "findings": 2}}
    assert "failed the scale audit" in port.scale_audit_gate(dirty)
    assert "no scale_audit stamp" in port.scale_audit_gate({})
    assert port.scale_audit_gate({"scale_audit": SA}) is None


def test_cli_module(tmp_path):
    po, pn = tmp_path / "o.json", tmp_path / "n.json"
    po.write_text(json.dumps({"value": 100.0}))
    pn.write_text(json.dumps({"value": 80.0, "scale_audit": SA}))
    r = subprocess.run([sys.executable, "-m", "tpu_swirld_torch.bench_compare",
                        str(po), str(pn)], cwd=ROOT, capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 1 and "REGRESSION" in r.stdout


# ------------------------------------------------------ lint.sh gates 3, 4


@pytest.mark.parametrize("gate", sorted(lint.SUPPRESSION_GATES))
def test_suppression_gate_clean_on_this_tree(gate):
    assert lint.suppression_gate(gate) == []


def test_lint_gates_cli():
    r = subprocess.run([sys.executable, "-m", "tpu_swirld_torch.analysis", "lint-gates"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "fused-kernel SW003/SW004 gate: 0 findings" in r.stdout
    assert "soak-plane SW002/SW003 gate: 0 findings" in r.stdout


@pytest.mark.parametrize("gate,module,comment", [
    ("fused-dispatch", "gpu/pipeline.py", "# swirld-lint: disable=SW003"),
    ("fused-dispatch", "store/streaming.py", "# swirld-lint: disable=dtype-discipline"),
    ("soak-plane", "net/traffic.py", "# swirld-lint: disable=SW002"),
])
def test_suppression_gate_catches_a_bare_disable(tmp_path, gate, module, comment):
    """A bare disable of a guarded rule planted in a copy of a gated module
    is a finding; the same disable with a ``-- why`` note is not."""
    copy = tmp_path / "tpu_swirld_torch"
    shutil.copytree(PKG, copy, ignore=shutil.ignore_patterns("__pycache__", "_build"))
    target = copy / module
    clean = target.read_text()
    target.write_text(clean + f"\nx = 1  {comment}\n")
    bad = lint.suppression_gate(gate, str(copy))
    assert len(bad) == 1 and "unjustified suppression" in bad[0]
    assert str(target) in bad[0]
    target.write_text(clean + f"\nx = 1  {comment} -- the reason it holds here\n")
    assert lint.suppression_gate(gate, str(copy)) == []
