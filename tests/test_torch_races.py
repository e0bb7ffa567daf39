"""The port's race sanitizer (``tpu_swirld_torch.analysis.races``) and the
archive seams it drives, held against the reference's: the 32-schedule
archive fuzz on CPU tensors gives the reference's digest, the sanitizer
catches a seeded lost update, a lock-order cycle and a spilled view of a
slab overwritten in place, the injector and the archive's yield points
match the reference's, and ``chaos_run --sanitize`` reproduces the
reference's safety fingerprint."""

import importlib.util
import json
import threading
from pathlib import Path

import pytest
import torch

import chip_smoke
from tpu_swirld import crypto as ref_crypto
from tpu_swirld.analysis import races as ref_races
from tpu_swirld.store import archive as ref_archive
from tpu_swirld_torch import chaos_run, crypto
from tpu_swirld_torch.analysis import races
from tpu_swirld_torch.analysis.races import (
    Injector, LockOrderGraph, TrackedLock, injection, run_archive_schedules,
    run_schedules,
)
from tpu_swirld_torch.store import archive

pytestmark = pytest.mark.analysis

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


@pytest.fixture
def sim_signer():
    prev = (ref_crypto.backend_name(), crypto.backend_name())
    ref_crypto.set_backend("sim")
    crypto.set_backend("sim")
    try:
        yield
    finally:
        ref_crypto.set_backend(prev[0])
        crypto.set_backend(prev[1])


# ------------------------------------------------------------- the fuzz


def test_archive_schedule_fuzz_32_matches_reference():
    """32 seeded schedules on CPU tensors: identical digests, equal to the
    synchronous run and to the reference's fuzz, an acyclic lock graph."""
    rep = run_archive_schedules(n_schedules=32, device="cpu")
    assert rep["schedules"] == 32 and rep["device"] == "cpu"
    assert rep["digests_identical"] and rep["matches_sync"], rep
    assert rep["acyclic"], rep["cycle"]
    assert rep["errors"] == [] and rep["ok"]
    want = ref_races.run_archive_schedules(n_schedules=32)
    assert want["ok"]
    assert rep["digest"] == rep["sync_digest"] == want["digest"]


@pytest.mark.parametrize("seed,rows", [(3, 64), (11, 40)])
def test_archive_fuzz_digest_matches_reference_at_other_seeds(seed, rows):
    rep = run_archive_schedules(n_schedules=4, seed=seed, rows=rows, device="cpu")
    want = ref_races.run_archive_schedules(n_schedules=4, seed=seed, rows=rows)
    assert rep["ok"] and want["ok"]
    assert rep["digest"] == want["digest"]


def test_archive_fuzz_golden_matches_reference():
    """``chip_smoke.ARCHIVE_FUZZ_DIGEST``, which phase 17(a) holds the
    card's fuzz to, is the reference's digest for seed 0, 96 rows."""
    want = ref_races.run_archive_schedules(
        n_schedules=1, seed=chip_smoke.ARCHIVE_FUZZ["seed"],
        rows=chip_smoke.ARCHIVE_FUZZ["rows"],
    )
    assert want["ok"]
    assert want["digest"] == chip_smoke.ARCHIVE_FUZZ_DIGEST


def test_archive_fuzz_without_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_archive_schedules(n_schedules=1)


def test_races_cli(capsys):
    assert races.main(["--schedules", "4", "--rows", "32", "--device", "cpu",
                       "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] and rep["schedules"] == 4


# ------------------------------------------------ what the sanitizer catches


class RacyCounter:
    """Deliberate lost-update fixture: the read and the write of ``value``
    are separated by a sanitizer yield point, exactly where an unlocked real
    implementation would have its preemption window."""

    def __init__(self):
        self.value = 0

    def incr(self):
        v = self.value
        races.yield_point("racy.read")
        self.value = v + 1


def test_race_sanitizer_detects_seeded_lost_update():
    def run(i):
        c = RacyCounter()
        gate = threading.Barrier(2)

        def worker():
            gate.wait()
            for _ in range(200):
                c.incr()

        ts = [threading.Thread(target=worker) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
        return c.value

    rep = run_schedules(run, n_schedules=8, seed=1)
    lost = any(v != 400 for v in rep["results"])
    assert lost or not rep["deterministic"], (
        f"sanitizer failed to expose the seeded race: {rep}"
    )


def test_lock_order_graph_detects_cycle():
    g = LockOrderGraph()
    a, b = TrackedLock("A", g), TrackedLock("B", g)
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    cyc = g.cycle()
    assert cyc is not None and set(cyc) >= {"A", "B"}
    g2 = LockOrderGraph()
    a2, b2 = TrackedLock("A", g2), TrackedLock("B", g2)
    for _ in range(2):
        with a2:
            with b2:
                pass
    assert g2.cycle() is None


def test_view_race_is_caught_on_cpu_tensors():
    """chip_smoke's fixture spills a view of a slab and then overwrites the
    slab in place (what ``StreamingConsensus._on_prune`` clones to avoid):
    the worker packs the overwritten rows, so the fuzz is not ok and its
    digest is not the synchronous one."""
    rep = run_archive_schedules(
        n_schedules=8, device="cpu", archive_cls=chip_smoke.ViewSpillArchive,
    )
    assert not rep["ok"]
    assert not rep["matches_sync"]
    assert rep["digest"] != rep["sync_digest"]
    assert rep["sync_digest"] == chip_smoke.ARCHIVE_FUZZ_DIGEST
    assert rep["acyclic"]


# -------------------------------------------------- injector, yield points


def test_injector_is_seeded_as_the_reference():
    """Same seed -> the same injection decisions, in both packages."""
    fired = []
    for mod in (races, ref_races):
        inj = mod.Injector(seed=42)
        with mod.injection(inj):
            for i in range(100):
                mod.yield_point(f"t{i}")
        fired.append((inj.fired, inj.points))
    again = Injector(seed=42)
    with injection(again):
        for i in range(100):
            races.yield_point(f"t{i}")
    assert fired[0] == fired[1] == (again.fired, again.points)
    assert fired[0][1] == 100 and 0 < fired[0][0] < 100


class _Recorder:
    """An injector that never sleeps and records every tag."""

    def __init__(self):
        self.tags = []
        self._mu = threading.Lock()

    def point(self, tag):
        with self._mu:
            self.tags.append(tag)


def test_archive_yield_points_match_reference(tmp_path):
    """Over the same workload, the port's archive yields at the reference's
    tagged points, and the seam is cleared after."""
    tags = []
    for mod in (races, ref_races):
        rec = _Recorder()
        F, parents = mod._closure_matrix(48, seed=7)
        arch = mod.SanitizedArchive(async_spill=True, queue_depth=2)
        rows = {"slab": torch.from_numpy(F)} if mod is races else {}
        with mod.injection(rec):
            mod._archive_workload(arch, F, parents, ws=0, tmpdir=str(tmp_path), **rows)
        tags.append(set(rec.tags))
    assert tags[0] == tags[1] == {
        "archive.cache.miss", "archive.append", "archive.worker.item",
        "archive.drain", "archive.enqueue",
    }
    assert archive._injector is None and ref_archive._injector is None


def test_guarded_attrs_cover_the_reference():
    assert archive.SlabArchive.GUARDED_ATTRS >= ref_archive.SlabArchive.GUARDED_ATTRS


# ------------------------------------------------------- chaos_run --sanitize


_SANITIZE_ARGS = [
    "--seed", "3", "--plan-seed", "3", "--nodes", "4", "--turns", "120",
    "--forkers", "0", "--checkpoint-every", "40", "--sanitize", "2",
]


def _load_reference_chaos_run():
    spec = importlib.util.spec_from_file_location(
        "ref_chaos_run", ROOT / "scripts" / "chaos_run.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.smoke
def test_chaos_run_sanitize_matches_reference(tmp_path, sim_signer):
    """``chaos_run --sanitize 2 --device cpu``: every schedule reproduced
    the base verdict, the archive fuzz held, and the safety fingerprint is
    the reference script's on the same arguments."""
    out = tmp_path / "verdict.json"
    assert chaos_run.main([*_SANITIZE_ARGS, "--device", "cpu", "--out", str(out)]) == 0
    v = json.loads(out.read_text())
    san = v["sanitizer"]
    assert san["schedules"] == 2
    assert san["verdicts_stable"] and san["all_ok"]
    assert san["archive"] == {"schedules": 8, "digests_identical": True,
                              "matches_sync": True, "acyclic": True}
    assert san["ok"] and v["ok"]
    ref_out = tmp_path / "ref.json"
    assert _load_reference_chaos_run().main([*_SANITIZE_ARGS, "--out", str(ref_out)]) == 0
    ref_v = json.loads(ref_out.read_text())
    assert chaos_run._verdict_fingerprint(v) == chaos_run._verdict_fingerprint(ref_v)
    assert ref_v["safety"] == chip_smoke.SANITIZE_SAFETY
    assert san == ref_v["sanitizer"]


def test_chaos_run_sanitize_and_all_are_exclusive(tmp_path):
    with pytest.raises(SystemExit):
        chaos_run.main(["--all", "--sanitize", "2", "--device", "cpu",
                        "--out", str(tmp_path / "v.json")])
