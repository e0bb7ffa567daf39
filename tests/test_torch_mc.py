"""The port's model checker (``tpu_swirld_torch.analysis.mc``) and
``chaos.replay_counterexample``: the reference's ``tests/test_mc.py`` run on
the port, then the two packages held to each other on the same worlds.

The comparisons are exact: state and transition counts, verdicts, the
witnesses a hunt finds, counterexample documents and state digests.  A
document written by either package replays in the other.  The parity probe
replays through ``_engines_agree`` on ``device="cpu"`` (the kernels' plain
versions); ``chip_smoke.py`` phase 16 runs it on the card.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from tpu_swirld import crypto as ref_crypto
from tpu_swirld.analysis import mc as ref_mc
from tpu_swirld.analysis.mc import counterexample as ref_ce
from tpu_swirld.chaos import replay_counterexample as ref_replay_counterexample
from tpu_swirld_torch import chaos_run, crypto
from tpu_swirld_torch.analysis.__main__ import main as analysis_main
from tpu_swirld_torch.analysis.mc import (
    INVARIANTS, MUTATIONS, explore, hunt, make_world, mc_smoke, run_mc,
)
from tpu_swirld_torch.analysis.mc import counterexample as ce
from tpu_swirld_torch.analysis.mc.cli import main as mc_main
from tpu_swirld_torch.chaos import replay_counterexample

pytestmark = pytest.mark.mc

ROOT = Path(__file__).resolve().parents[1]
CLEAN_SCHEDULE = [
    ("sync", 1, 0), ("sync", 0, 1), ("sync", 2, 0),
    ("pull", 0, 2), ("pull", 1, 2),
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tiny ops: torch's CPU thread pool costs far more than it saves here
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def sim_backend():
    """Both packages on the deterministic sim signer, for tests that drive
    ``World`` / ``explore`` directly (``run_mc`` scopes it itself)."""
    prev = crypto.backend_name(), ref_crypto.backend_name()
    crypto.set_backend("sim")
    ref_crypto.set_backend("sim")
    yield
    crypto.set_backend(prev[0])
    ref_crypto.set_backend(prev[1])


# ------------------------------------------ the reference's tests, on the port


def test_smoke_world_explores_clean_with_reduction():
    rep = mc_smoke()           # n=3, events=2, with the naive baseline
    assert rep["ok"]
    assert rep["exhaustive"]
    assert rep["violations"] == 0
    assert rep["states"] > 1000
    assert rep["state_ratio"] > 2
    assert rep["transition_ratio"] > 2


def test_exploration_is_deterministic(sim_backend):
    runs = [
        explore(make_world(None, n_honest=3, n_forkers=0, events=2))
        for _ in range(2)
    ]
    assert runs[0].to_dict() == runs[1].to_dict()
    assert runs[0].exhaustive and runs[0].violation is None


def test_por_preserves_state_coverage(sim_backend):
    """Sleep-set POR prunes transitions, never states; symmetry shrinks the
    state set."""
    kw = dict(n_honest=3, n_forkers=0, events=2)
    naive = explore(make_world(None, **kw), por=False, symmetry=False,
                    check_invariants=False)
    por_only = explore(make_world(None, **kw), por=True, symmetry=False,
                       check_invariants=False)
    reduced = explore(make_world(None, **kw), por=True, symmetry=True,
                      check_invariants=False)
    assert naive.exhaustive and por_only.exhaustive and reduced.exhaustive
    assert por_only.states == naive.states
    assert por_only.transitions < naive.transitions
    assert reduced.states < por_only.states


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutation_caught_with_minimized_replayable_witness(name):
    rep = run_mc(mutate=name, compare=False)
    cex = rep.get("counterexample")
    assert cex is not None, f"mutation {name} produced no violation"
    assert cex["caught_expected"], (
        f"{name}: expected {MUTATIONS[name].expected_invariant}, "
        f"got {cex['violation']['invariant']}"
    )
    assert cex["minimized_len"] <= cex["schedule_len"]
    assert cex["replay_reproduced"]
    assert cex["replay_digests_match"]
    assert cex["replay_trace_match"]


def test_counterexample_doc_roundtrip(tmp_path):
    out = tmp_path / "ce.json"
    rep = run_mc(mutate="fork-blind", compare=False, out=str(out))
    doc = json.loads(out.read_text())
    assert doc["kind"] == "mc-counterexample"
    assert doc["world"]["mutate"] == "fork-blind"
    assert doc["violation"]["invariant"] == "fork-budget"
    assert doc["schedule"] == [
        list(a) for a in rep["counterexample"]["document"]["schedule"]
    ]
    # a mutated document gates on replay fidelity alone: no device row
    chaos_rep = replay_counterexample(str(out), device="cpu")
    assert chaos_rep["kind"] == "mc-replay"
    assert chaos_rep["reproduced"] and chaos_rep["digests_match"]
    assert chaos_rep["ok"]
    assert "engines" not in chaos_rep


def test_clean_schedule_doc_parity_probe(sim_backend):
    world = make_world(None, n_honest=3, n_forkers=0, events=3)
    report = ce.run_checked(world, CLEAN_SCHEDULE)
    assert report["violation"] is None
    doc = ce.emit(world, CLEAN_SCHEDULE, report)
    assert doc["violation"] is None
    rep = replay_counterexample(doc, device="cpu")
    assert rep["violation"] is None
    assert rep["reproduced"] and rep["digests_match"] and rep["trace_match"]
    assert rep["engines"]["batch_oracle_parity"]
    assert rep["engines"]["incremental_batch_parity"]
    assert rep["ok"]


def test_cli_exit_codes(tmp_path):
    assert mc_main(["--events", "1", "--no-compare"]) == 0
    out = tmp_path / "cli_ce.json"
    assert mc_main(["--mutate", "fork-blind", "--out", str(out)]) == 1
    assert json.loads(out.read_text())["violation"]["invariant"] == "fork-budget"
    assert mc_main(["--events", "2", "--max-states", "50", "--no-compare"]) == 2
    with pytest.raises(SystemExit):
        mc_main(["--mutate", "no-such-bug"])


def test_catalog_is_well_formed():
    ids = [inv.id for inv in INVARIANTS]
    assert len(ids) == len(set(ids))
    assert {m.expected_invariant for m in MUTATIONS.values()} <= set(ids)
    assert all(inv.kind in ("state", "edge") for inv in INVARIANTS)
    assert ids == [inv.id for inv in ref_mc.INVARIANTS]
    assert {n: (m.expected_invariant, m.world_kwargs.get("n_honest"),
                m.world_kwargs.get("n_forkers"), m.world_kwargs.get("events"))
            for n, m in MUTATIONS.items()} == {
        n: (m.expected_invariant, m.world_kwargs.get("n_honest"),
            m.world_kwargs.get("n_forkers"), m.world_kwargs.get("events"))
        for n, m in ref_mc.MUTATIONS.items()}


def test_analysis_dispatcher(capsys):
    """``python -m tpu_swirld_torch.analysis``: ``mc``, ``lint``, ``races``,
    ``jit-audit`` and ``scale-audit`` run; an unknown subcommand exits
    2."""
    assert analysis_main(["mc", "--events", "1", "--no-compare"]) == 0
    assert analysis_main(["lint", "--list-rules"]) == 0
    assert analysis_main(["races", "--schedules", "2", "--rows", "16",
                          "--device", "cpu"]) == 0
    assert analysis_main(["jit-audit", "--static-only", "--root",
                          str(ROOT / "tests" / "data")]) == 0
    capsys.readouterr()
    assert analysis_main(["scale-audit", "--list-rules"]) == 0
    assert "SW009 unproven-bounds" in capsys.readouterr().out
    assert analysis_main(["no-such"]) == 2
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_swirld_torch.analysis", "mc", "--events", "1",
         "--no-compare"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "all invariants hold" in proc.stdout


# ------------------------------------------------- the two packages, compared


@pytest.mark.parametrize("shape", [
    dict(n_honest=3, n_forkers=0, events=2),
    dict(n_honest=2, n_forkers=1, events=2),
    dict(n_honest=2, n_forkers=1, events=2, withhold=True),
])
def test_explore_matches_reference(shape, sim_backend):
    """Both checkers explore the same world to the same counts: the state
    keys and transitions are the same bytes in both packages."""
    for kw in (dict(), dict(por=False, symmetry=False, check_invariants=False)):
        got = explore(make_world(None, **shape), **kw).to_dict()
        want = ref_mc.explore(ref_mc.make_world(None, **shape), **kw).to_dict()
        assert got == want


def test_dynamic_forker_world_matches_reference(sim_backend):
    """Honest ``DynamicNode`` roles beside a forker: the port's node keeps
    per-witness seq bounds of its members' chains, and two clones of one
    cached node may hold different branches of the forker's chain, so each
    clone must own its bounds.  Sharing them finds a false ``union-replay``
    violation within 1 608 states of this world; the reference finds none."""
    from tpu_swirld.membership.dynamic import DynamicNode as RefDynamicNode
    from tpu_swirld_torch.analysis.mc import World
    from tpu_swirld_torch.membership.dynamic import DynamicNode

    shape = dict(n_honest=2, n_forkers=1, events=4)
    got = explore(World(node_cls=DynamicNode, observer_cls=DynamicNode, **shape),
                  max_states=2000).to_dict()
    want = ref_mc.explore(
        ref_mc.World(node_cls=RefDynamicNode, observer_cls=RefDynamicNode, **shape),
        max_states=2000).to_dict()
    assert got == want
    assert got["states"] == 2000 and got["violations_found"] == 0


def test_run_mc_report_matches_reference():
    got, want = run_mc(n=3, forkers=0, events=2), ref_mc.run_mc(n=3, forkers=0, events=2)
    for rep in (got, want):
        rep.pop("elapsed_s")
        rep.pop("states_per_sec")
    assert got == want
    assert got["reduction"]["state_ratio"] > 2


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_hunt_finds_the_reference_witness(name, sim_backend):
    """A seeded hunt walks the same schedule to the same violation."""
    world, ref_world = make_world(name), ref_mc.make_world(name)
    got = hunt(world, seed=world.seed)
    want = ref_mc.hunt(ref_world, seed=ref_world.seed)
    assert got.to_dict() == want.to_dict()
    assert got.schedule == want.schedule and got.schedule
    assert got.violation.to_dict() == want.violation.to_dict()


@pytest.mark.parametrize("name", ["fork-blind", "round-skew", "epoch-skew"])
def test_counterexample_documents_cross_replay(name, tmp_path):
    """A document saved by either package replays in the other with every
    flag true, and both packages emit the same document."""
    mine = run_mc(mutate=name, compare=False, out=str(tmp_path / "port.json"))
    theirs = ref_mc.run_mc(mutate=name, compare=False, out=str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert mine["counterexample"]["document"] == theirs["counterexample"]["document"]
    for replay, path in ((ref_ce.replay, "port.json"), (ce.replay, "ref.json")):
        rep = replay(ce.load(str(tmp_path / path)))
        assert rep["reproduced"] and rep["digests_match"] and rep["trace_match"]
        assert rep["violation"]["invariant"] == MUTATIONS[name].expected_invariant


def test_parity_document_replays_as_the_reference(sim_backend):
    """``chaos_run --mc``'s parity document: the port's and the reference's
    are the same document, and the port's ``replay_counterexample(device=
    "cpu")`` gives the reference's row, engine row included (times
    aside)."""
    doc = chaos_run.parity_document(0)
    world = ref_mc.World(n_honest=3, n_forkers=0, events=3, seed=0)
    ref_doc = ref_ce.emit(world, CLEAN_SCHEDULE, ref_ce.run_checked(world, CLEAN_SCHEDULE))
    assert doc == ref_doc
    for engine in ("incremental", "streaming"):
        got = replay_counterexample(doc, engine=engine, device="cpu")
        want = ref_replay_counterexample(ref_doc, engine=engine)
        assert got["ok"] and want["ok"]
        assert set(got["engines"]) == set(want["engines"]) | {"seconds"}
        assert chip_smoke.chaos_fields(got) == chip_smoke.chaos_fields(want)


def test_replay_counterexample_refuses_the_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replay_counterexample(chaos_run.parity_document(0))


# ------------------------------------------------------------------ slow tier


@pytest.mark.slow
def test_exhaustive_events3_vanilla():
    rep = run_mc(events=3, compare=False)
    assert rep["explore"]["exhaustive"]
    assert rep["explore"]["violations_found"] == 0
    assert rep["explore"]["states"] > 20_000


@pytest.mark.slow
def test_exhaustive_events3_forker():
    rep = run_mc(n=2, forkers=1, events=3, compare=False)
    assert rep["explore"]["exhaustive"]
    assert rep["explore"]["violations_found"] == 0
