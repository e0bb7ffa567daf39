"""The port's scale-envelope audit (``tpu_swirld_torch.analysis.flow``)
against the reference's contract, on the CPU.

The reference's flow interpreter reads ``jax.core.Literal``, which the
installed JAX no longer has, so the port is held against the reference's
*contract* — its lattice arithmetic case for case, its envelope presets
and host checks, its rule ids and names, its mutations, its CLI exit
codes and its stamp's keys — and against its own soundness property:

- **soundness**: every stage a real small run of each engine dispatches
  is replayed through the interpreter at its concrete arguments'
  intervals, and every concrete output must lie inside its abstract
  interval (``chip_smoke.py`` phase 18 runs the same property with the
  outputs computed by the CUDA kernels);
- **teeth**: both seeded mutations are caught with their rule, file,
  line and op;
- **coverage**: every registered transfer is exercised by the catalog
  and a micro-trace battery, and every stage name the engines dispatch
  maps to an audited spec, the catalog differing from the reference's
  only where :data:`stages.REFERENCE_DIFFERENCES` names it;
- **the gates**: ``baseline`` and ``1m`` proven clean with every
  suppression justified, the CLI's exit codes 0 / 1 / 2.
"""

import ast
import dataclasses
import functools
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_swirld_torch.analysis.flow import audit, stages
from tpu_swirld_torch.analysis.flow import envelope as E
from tpu_swirld_torch.analysis.flow import interpret as I
from tpu_swirld_torch.analysis.flow import lattice as L
from tpu_swirld_torch.analysis.flow.interpret import ArgDecl, interpret_stage
from tpu_swirld_torch.analysis.flow.transfer import (
    TRANSFERS,
    UnknownPrimitiveError,
    registered_primitives,
)
from tpu_swirld_torch.analysis.lint import Finding, suppression_notes

from tpu_swirld.analysis.flow import envelope as ref_envelope
from tpu_swirld.analysis.flow import lattice as ref_lattice

import chip_smoke

ROOT = os.path.join(os.path.dirname(__file__), "..")
AUDIT_PY = os.path.join(ROOT, "tpu_swirld_torch", "analysis", "flow", "audit.py")

_AUDIT_1M = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_the_1m_audit():
    """One torch thread for the module; the 1m audit runs through the CLI
    in a process of its own from the module's first test on, beside the
    rest (``test_envelope_1m_proven_clean`` reads it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    _AUDIT_1M["proc"] = subprocess.Popen(
        [sys.executable, "-m", "tpu_swirld_torch.analysis", "scale-audit",
         "--envelope", "1m", "--no-coverage", "--json"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    yield
    proc = _AUDIT_1M.pop("proc")
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    torch.set_num_threads(n)


def _audit_1m():
    """The 1m audit's exit code and JSON report."""
    if "doc" not in _AUDIT_1M:
        out, err = _AUDIT_1M["proc"].communicate(timeout=300)
        assert out, err[-3000:]
        _AUDIT_1M["doc"] = (_AUDIT_1M["proc"].returncode, json.loads(out))
    return _AUDIT_1M["doc"]


def _audit(envelope, mutate=None):
    """One shared audit run per (envelope, mutation) for the module."""
    return audit.cached_audit(envelope, stages.ENGINES, mutate)


@functools.lru_cache(maxsize=None)
def _soundness(engine, seed=3):
    return audit.soundness_check(engine, device="cpu", seed=seed)


# ----------------------------------------------------- lattice vs reference

_ENDS = [float("-inf"), -2**40, -7, -3, -1, 0, 1, 2, 5, 9, 2**31, float("inf")]


def _intervals(rng, n):
    out = [L.Interval.bottom()]
    for _ in range(n):
        a, b = sorted((rng.choice(_ENDS), rng.choice(_ENDS)))
        out.append(L.Interval(a, b))
    return out


def _key(v):
    return "nan" if isinstance(v, float) and v != v else v


def _same(got, want):
    """Equal endpoints (inf - inf is NaN on both sides alike)."""
    assert (_key(got.lo), _key(got.hi)) == (_key(want.lo), _key(want.hi))


def test_lattice_matches_reference_case_for_case():
    rng = random.Random(7)
    ivs = _intervals(rng, 40)
    R = ref_lattice
    binary = ("iv_add", "iv_sub", "iv_mul", "iv_min", "iv_max",
              "iv_div_int", "iv_div_float", "iv_rem")
    for a in ivs:
        ra = R.Interval(a.lo, a.hi)
        for fn in ("iv_neg", "iv_abs"):
            _same(getattr(L, fn)(a), getattr(R, fn)(ra))
        assert a.is_bottom == ra.is_bottom and repr(a) == repr(ra)
        assert a.is_point == ra.is_point
        _same(a.shift(3), ra.shift(3))
        for b in ivs:
            rb = R.Interval(b.lo, b.hi)
            for fn in binary:
                _same(getattr(L, fn)(a, b), getattr(R, fn)(ra, rb))
            _same(a.join(b), ra.join(rb))
            _same(a.meet(b), ra.meet(rb))
            assert a.covers(b) == ra.covers(rb)
        for v in (-3, 0, 4, 2**31):
            assert a.contains(v) == ra.contains(v)


@pytest.mark.parametrize("name", ["bool", "uint8", "int8", "int16", "int32",
                                  "int64", "float16", "float32", "float64"])
def test_dtype_helpers_take_numpy_and_torch_dtypes(name):
    want = ref_lattice.dtype_range(np.dtype(name))
    assert L.dtype_range(np.dtype(name)) == want
    assert L.dtype_range(getattr(torch, name)) == want
    for fn in ("is_int_dtype", "is_bool_dtype", "is_float_dtype"):
        assert getattr(L, fn)(getattr(torch, name)) == getattr(ref_lattice, fn)(np.dtype(name))


def test_absval_matches_reference():
    for val in (np.int32(7), np.array([3, -2, 9], np.int16),
                np.array([0.5, 2.0], np.float32), np.array([2.0, 4.0])):
        got, want = L.AbsVal.from_literal(val), ref_lattice.AbsVal.from_literal(val)
        assert (got.shape, got.dtype, got.integral) == (want.shape, want.dtype, want.integral)
        _same(got.iv, want.iv)
        assert repr(got) == repr(want)
        _same(got.top_like().iv, want.top_like().iv)
        _same(got.clamp_to_dtype().iv, want.clamp_to_dtype().iv)
    a = L.AbsVal((4,), torch.int32, L.Interval(0, 3))
    assert L.join_or(None, a) is a
    assert L.join_or(a, a.with_iv(L.Interval(-1, 1))).iv == L.Interval(-1, 3)
    assert repr(a) == "int32[4][0, 3]"


# ----------------------------------------------------- envelopes vs reference


def _host(findings):
    return [(f.rule, f.name, f.message, f.path) for f in findings]


def _mapped(findings):
    return [(f.rule, f.name, f.message,
             f.path.replace("tpu_swirld/tpu/", "tpu_swirld_torch/gpu/")
             .replace("tpu_swirld/", "tpu_swirld_torch/")) for f in findings]


_BAD = [{"t_max": E.INT32_MAX}, {"stake_max": 1 << 24},
        {"events": 1 << 32, "rows": 1 << 32}, {"members": 1 << 20}]


def test_envelope_presets_match_reference():
    assert E.preset_names() == ref_envelope.preset_names()
    for name in ("baseline", "1m"):
        assert E.get_envelope(name).to_dict() == ref_envelope.get_envelope(name).to_dict()
    for over in _BAD:
        assert (E.get_envelope("custom", over).to_dict()
                == ref_envelope.get_envelope("custom", over).to_dict())
    with pytest.raises(ValueError, match="unknown envelope fields"):
        E.get_envelope("custom", {"eventz": 1})
    with pytest.raises(ValueError, match="unknown envelope"):
        E.get_envelope("2g")


def test_host_checks_match_reference():
    assert not E.host_envelope_findings(E.get_envelope("baseline"))
    assert not E.host_envelope_findings(E.get_envelope("1m"))
    for over in _BAD:
        got = E.host_envelope_findings(E.get_envelope("custom", over))
        want = ref_envelope.host_envelope_findings(
            ref_envelope.get_envelope("custom", over))
        assert got and _host(got) == _mapped(want), over
    # the f32-exact gate points at fame_scan's exact_tally in the port
    (gate,) = [f for f in E.host_envelope_findings(
        E.get_envelope("custom", {"stake_max": 1 << 17}))]
    with open(os.path.join(ROOT, gate.path)) as f:
        assert "exact_tally = " in f.read().splitlines()[gate.line - 1]


def test_rule_names_and_mutations_match_reference():
    from tpu_swirld.analysis.flow.audit import MUTATIONS as ref_mutations
    from tpu_swirld.analysis.flow.interpret import RULE_NAMES as ref_rules

    assert I.RULE_NAMES == ref_rules
    assert {k: v[0] for k, v in audit.MUTATIONS.items()} == \
        {k: v[0] for k, v in ref_mutations.items()}


# ----------------------------------------------------- interpreter regressions


def _interp(fn, args, **kw):
    findings = []
    res = interpret_stage(fn, args, kw, sentinels=(E.INT32_MAX,), findings=findings)
    return res, findings


def test_where_path_refinement_keeps_a_chain_walk_in_bounds():
    # cur = where(nxt >= 0, nxt, cur) walks a self-parent chain with a
    # proven-non-negative index: without the refinement the next gather's
    # index would read [-1, n-1]
    def walk(self_parent, cur):
        for _ in range(4):
            nxt = self_parent[cur]
            cur = torch.where(nxt >= 0, nxt, cur)
        return cur

    res, findings = _interp(walk, [ArgDecl((16,), torch.int32, -1, 15),
                                   ArgDecl((3,), torch.int64, 0, 15)])
    assert not findings and res.outs[0].iv == L.Interval(0, 15)


def test_write_through_a_view_widens_its_base():
    def write(tab, v):
        tab.view(-1).index_put_((torch.tensor([3]),), v)
        tab[1:2] = 40
        return tab

    res, findings = _interp(write, [ArgDecl((4, 2), torch.int32, -1, 5),
                                    ArgDecl((1,), torch.int32, 7, 9)])
    assert not findings and res.outs[0].iv == L.Interval(-1, 40)


def test_long_loop_extrapolates_a_counter_by_its_trip_count():
    # a round counter bumped at most once an event, over 10 000 events:
    # the summary proves rounds <= events instead of widening to int32
    # (the audited modules' own ``range`` is the summary's during a run)
    def scan(rnd, grow):
        for i in I._SummaryRange(10_000):
            rnd[i : i + 1] = rnd.max() + grow[i % 4]
        return rnd

    res, findings = _interp(scan, [ArgDecl((10_000,), torch.int32, 0, 0),
                                   ArgDecl((4,), torch.int32, 0, 1)])
    assert not findings
    assert 10_000 <= res.outs[0].iv.hi <= 10_100


def test_unknown_op_hard_fails():
    with pytest.raises(UnknownPrimitiveError) as ei:
        interpret_stage(torch.sin, [ArgDecl((4,), torch.float32)])
    assert ei.value.primitive == "aten.sin.default"


def test_undeclared_pull_hard_fails():
    with pytest.raises(I.UndeclaredPullError):
        interpret_stage(lambda x: int(x.sum()), [ArgDecl((4,), torch.int32, 0, 1)])
    # order_scan's host pulls are declared by the fame specs; without the
    # declaration the same stage refuses to pick a branch
    call = stages._b_fame_order_cols(E.get_envelope("baseline"))
    with pytest.raises(I.UndeclaredPullError, match="order_scan:go"):
        interpret_stage(call.fn, call.args, call.kwargs)


# ----------------------------------------------------- soundness property


@pytest.mark.parametrize("engine", stages.ENGINES)
def test_lattice_soundness(engine):
    rep = _soundness(engine)
    assert rep["replayed"], f"engine {engine!r} dispatched no stages"
    assert not rep["violations"], "\n".join(rep["violations"])
    if engine == "batch":
        # both batch paths: the full path's ssm_matrix stage is held too
        assert {"pipeline.ssm_block_stage", "pipeline.ssm_matrix_stage"} <= set(rep["replayed"])
    if engine == "mesh":
        assert "pipeline.ssm_block_mesh" in rep["replayed"]


@pytest.mark.slow
@pytest.mark.parametrize("engine", stages.ENGINES)
def test_lattice_soundness_seed_sweep(engine):
    for seed in (5, 11, 23):
        rep = _soundness(engine, seed)
        assert not rep["violations"], "\n".join(rep["violations"])


# ----------------------------------------------------- the shipped tree


def test_baseline_proven_clean():
    rep = _audit("baseline")
    assert rep.exit_code == 0 and rep.clean, rep.render()
    assert not rep.findings and not rep.unjustified and not rep.errors
    # the order scan's intentional sentinel masking rides on justified
    # suppressions — each must carry its why-safe text
    assert rep.suppressed
    for f, note in rep.suppressed:
        assert note.strip(), f.render()
        assert f.rule == "SW011" and f.path == "tpu_swirld_torch/gpu/pipeline.py"
    assert len(rep.specs) == len(stages.CATALOG)
    # every pull site is listed with the value assumed
    assert set(rep.pulls) == set(stages.PULLS)


def test_stage_coverage_with_the_named_differences():
    from tpu_swirld.analysis.flow import stages as ref_stages

    cmap = stages.coverage_map()
    for engine in stages.ENGINES:
        observed = _soundness(engine)["stages"]
        # phase 18 of chip_smoke.py holds the card's runs to these names
        assert observed == chip_smoke.FLOW_STAGES[engine], engine
        gaps = [s for s in observed if s not in cmap]
        assert not gaps, f"{engine}: uncovered stages {gaps}"
    ref_names = {s.stage_name for s in ref_stages.CATALOG}
    port_names = {s.stage_name for s in stages.CATALOG}
    dropped = {n for k in stages.REFERENCE_DIFFERENCES for n in k}
    added = {n for v in stages.REFERENCE_DIFFERENCES.values() for n in v}
    assert ref_names - port_names == dropped
    assert port_names - ref_names == added
    ref_ids = {s.spec_id for s in ref_stages.CATALOG if s.stage_name not in dropped}
    assert ref_ids <= {s.spec_id for s in stages.CATALOG} | {"batch.rounds"}
    assert stages.ENGINES == ref_stages.ENGINES


# ----------------------------------------------------- transfer coverage

#: micro-traces for ops the consensus stages don't emit; each probe must
#: exercise its named transfer
_BATTERY = [
    ("aten.neg.default", lambda x: -x),
    ("aten.abs.default", lambda x: x.abs()),
    ("aten.div.Tensor", lambda x: x / 2),
    ("aten.minimum.default", lambda x: torch.minimum(x, x - 1)),
    ("aten.clamp_min.default", lambda x: torch.clamp_min(x, 2)),
    ("aten.clamp_max.default", lambda x: torch.clamp_max(x, 3)),
    ("aten.bitwise_xor.Scalar", lambda x: x ^ 3),
    ("aten.masked_fill.Scalar", lambda x: x.masked_fill(x > 3, 9)),
    ("aten.fill_.Scalar", lambda x: torch.empty_like(x).fill_(2)),
    ("aten.zero_.default", lambda x: x.clone().zero_()),
    ("aten.cumsum.default", lambda x: x.cumsum(0)),
    ("aten.gather.default", lambda x: x.gather(0, x.clamp(0, 7).long())),
]


def _battery_exercised():
    ex = set()
    for name, fn in _BATTERY:
        got = set()
        interpret_stage(fn, [ArgDecl((8,), torch.int32, 0, 7)], exercised=got)
        assert name in got, f"battery probe {name!r} exercised {sorted(got)}"
        ex |= got
    return ex


def test_transfer_registry_fully_exercised():
    # every registered transfer is exercised by tests; names registered
    # for other spellings of one op share their transfer function, so
    # coverage is counted per transfer *function*, not per name
    exercised = set(_audit("baseline").exercised)
    exercised |= set(_audit_1m()[1]["exercised"])
    for m in sorted(audit.MUTATIONS):
        exercised |= _audit("baseline", m).exercised
    exercised |= _battery_exercised()
    groups = {}
    for name, fn in TRANSFERS.items():
        groups.setdefault(id(fn), []).append(name)
    missed = [sorted(names) for names in groups.values()
              if not exercised & set(names)]
    assert not missed, f"transfers never exercised: {missed}"


def test_registered_primitives_listing():
    names = registered_primitives()
    assert names == sorted(names) and len(names) == len(set(names))
    assert {"aten.index.Tensor", "aten.index_select.default",
            "aten.index_put_.default", "aten.add.Tensor", "aten.mul.Tensor",
            "aten._to_copy.default", "aten.where.self"} <= set(names)


# ----------------------------------------------------- mutation teeth


def _seeded_line(marker):
    with open(AUDIT_PY) as f:
        (line,) = [i for i, t in enumerate(f, 1) if marker in t]
    return line


def test_mutation_ssm_int16_accumulator_caught():
    rep = _audit("baseline", "ssm-acc-int16")
    assert rep.exit_code == 1 and not rep.clean and not rep.errors
    assert {f.rule for f in rep.findings} == {"SW010", "SW008"}
    for f in rep.findings:
        assert f.path == "tpu_swirld_torch/analysis/flow/audit.py"
    # both findings land on the seeded line, not somewhere nearby
    assert {f.line for f in rep.findings} == {_seeded_line("# seeded defect\n")}
    msgs = " ".join(f.message for f in rep.findings)
    assert "_to_copy" in msgs and "add" in msgs and "int16" in msgs


def test_mutation_dropped_clip_caught():
    rep = _audit("baseline", "dropped-clip")
    assert rep.exit_code == 1 and not rep.clean and not rep.errors
    (f,) = rep.findings
    assert f.rule == "SW009"
    assert f.path == "tpu_swirld_torch/analysis/flow/audit.py"
    assert f.line == _seeded_line("# seeded defect: no clamp")
    assert f.message.split("] ", 1)[1].startswith("index_select:")
    assert rep.mutation == "dropped-clip"


def test_mutations_are_never_suppressible():
    # the seeded defects live in audit.py, which must carry no
    # swirld-lint disables — otherwise the self-test could be silenced
    with open(AUDIT_PY) as fh:
        assert suppression_notes(fh.read()) == {}


def test_unknown_mutation_rejected():
    with pytest.raises(ValueError, match="unknown mutation"):
        audit.scale_audit("baseline", mutate="nope")
    with pytest.raises(ValueError, match="unknown engines"):
        audit.scale_audit("baseline", engines=["gpuzzz"])


# ----------------------------------------------------- suppressions


def test_suppression_requires_justification(tmp_path):
    src = (
        "a = t[i]  # swirld-lint: disable=SW009\n"
        "b = t[j]  # swirld-lint: disable=SW009 -- j is packer-clamped\n"
        "c = t[k]\n"
    )
    p = tmp_path / "frag.py"
    p.write_text(src)

    def fd(line):
        return Finding("SW009", I.RULE_NAMES["SW009"], str(p), line, 0,
                       "index not provably in bounds")

    kept, suppressed, unjustified = audit._apply_suppressions(
        [fd(1), fd(2), fd(3)])
    assert [f.line for f in kept] == [3]
    assert [(f.line, note) for f, note in suppressed] == \
        [(2, "j is packer-clamped")]
    assert [f.line for f in unjustified] == [1]
    assert "without justification" in unjustified[0].message


def test_suppression_wrong_rule_does_not_apply(tmp_path):
    p = tmp_path / "frag.py"
    p.write_text("a = t[i]  # swirld-lint: disable=SW008 -- wraps are ok\n")
    f = Finding("SW009", I.RULE_NAMES["SW009"], str(p), 1, 0, "oob")
    kept, suppressed, unjustified = audit._apply_suppressions([f])
    assert kept == [f] and not suppressed and not unjustified


# ----------------------------------------------------- CLI + stamp


def test_cli_list_rules(capsys):
    assert audit.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in ("SW008", "SW009", "SW010", "SW011"):
        assert rid in out


def test_cli_clean_with_coverage(capsys):
    # the full CLI path: catalog + host checks + the runtime coverage
    # probe (one engine keeps the probe's load small; the coverage test
    # sweeps all four)
    assert audit.main(["--envelope", "baseline", "--engine", "streaming",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "proven clean" in out and "pull gpu/pipeline.py:order_scan:go" in out


def test_cli_mutation_exits_one(capsys):
    rc = audit.main(["--mutate", "dropped-clip", "--json"])
    assert rc == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["clean"] is False and doc["mutation"] == "dropped-clip"
    assert doc["findings"] and doc["findings"][0]["rule"] == "SW009"


def _synthetic(monkeypatch, fn):
    spec = stages.StageSpec("synthetic.stage", "synthetic.stage", ("batch",),
                            lambda env: stages.StageCall(
                                fn, (ArgDecl((4,), torch.float32, 0.0, 1.0),), {}))
    monkeypatch.setattr(stages, "specs_for_engines", lambda e: [spec])


def test_cli_unknown_primitive_exits_two(monkeypatch, capsys):
    _synthetic(monkeypatch, torch.sin)
    assert audit.main(["--envelope", "baseline", "--no-coverage"]) == 2
    assert "unknown primitive 'aten.sin.default'" in capsys.readouterr().out


def test_cli_undeclared_pull_exits_two(monkeypatch, capsys):
    _synthetic(monkeypatch, lambda x: x * float(x.sum()))
    assert audit.main(["--envelope", "baseline", "--no-coverage"]) == 2
    assert "undeclared host pull" in capsys.readouterr().out


def test_analysis_dispatcher_runs_scale_audit(capsys):
    from tpu_swirld_torch.analysis.__main__ import NOT_PORTED, main

    assert NOT_PORTED == {}
    assert main(["scale-audit", "--list-rules"]) == 0
    assert "SW011 sentinel-collision" in capsys.readouterr().out


def _reference_stamp_keys():
    src = open(os.path.join(ROOT, "tpu_swirld", "analysis", "flow", "audit.py")).read()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == "scale_audit_stamp")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    return [k.value for k in ret.value.keys]


def test_scale_audit_stamp_shape():
    d = audit.scale_audit_stamp("baseline")
    assert list(d) == _reference_stamp_keys()
    assert d["clean"] is True and d["envelope"] == "baseline"
    assert d["findings"] == 0 and d["errors"] == 0
    assert d["suppressed"] > 0
    assert d["engines"] == list(stages.ENGINES)
    # cached per process
    assert audit.scale_audit_stamp("baseline") == d
    import tpu_swirld_torch.analysis as analysis

    assert analysis.scale_audit_stamp is audit.scale_audit_stamp


def test_audit_report_render_and_dict():
    rep = _audit("baseline", "ssm-acc-int16")
    txt = rep.render()
    assert "mutate=ssm-acc-int16" in txt and "finding(s)" in txt
    doc = rep.to_dict()
    assert doc["exit_code"] == 1
    assert doc["specs"] == ["mutation.ssm-acc-int16"]
    assert doc["exercised"] == sorted(rep.exercised)
    assert dataclasses.replace(rep, errors=["x"]).exit_code == 2


def test_envelope_1m_proven_clean():
    # the headline guarantee: the full catalog at 2**20 events /
    # 256 members, all engines, exits 0 (through the CLI)
    rc, doc = _audit_1m()
    assert rc == 0 and doc["clean"], json.dumps(doc["findings"] + doc["errors"])
    assert doc["envelope"] == "1m" and len(doc["specs"]) == len(stages.CATALOG)
    assert doc["suppressed"] and all(f["justification"] for f in doc["suppressed"])
    assert set(doc["pulls"]) == set(stages.PULLS)


def test_cpu_twin_rebuilds_each_mesh_stage_on_a_cpu_mesh():
    """A mesh stage observed on the card is interpreted as the same
    factory's function over a CPU mesh of as many shards."""
    from tpu_swirld_torch import parallel
    from tpu_swirld_torch.gpu import kernels

    card = parallel.Mesh((torch.device("cuda", 0),) * 4)   # built, never run
    fns = {
        "pallas": kernels.make_mesh_row_block_fn(card),
        "hop": parallel.make_row_sharded_block_fn(card, bmm=kernels.bmm_or),
        "member": parallel.make_ssm_block_fn_for_mesh(card),
        "consensus": parallel.consensus_fn_for_mesh(card),
    }
    for label, fn in fns.items():
        assert stages._closure_mesh(fn) is card, label
        twin = stages.cpu_twin(fn)
        mesh = stages._closure_mesh(twin)
        assert twin is not fn and mesh.device.type == "cpu" and mesh.size == 4, label
        assert stages.cpu_twin(twin) is twin
    assert stages.cpu_twin(kernels.ssm_block) is kernels.ssm_block
