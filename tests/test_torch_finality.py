"""Finality parity across the port's engines and the reference's oracle, and
the drivers' flight-recorder triggers against the reference's drivers.

``rounds_to_decision = round_received - round`` is a pure function of the
DAG, so the port's oracle ``Node``, its batch ``run_consensus`` (through
``record_batch_result``), ``IncrementalConsensus``, ``StreamingConsensus``
and ``MeshStreamingConsensus`` must each give the reference oracle's exact
sample list on the shapes of ``tests/test_finality.py``.  The incremental
driver's ``rebase_storm`` and ``overflow_heal`` triggers fire where the
reference's do, with the same detail and decided frontier, and their dumps
are equal after ``json.loads``.  Tolerance: exact equality."""

import json
from pathlib import Path

import pytest
import torch

from tpu_swirld.config import SwirldConfig as RefConfig
from tpu_swirld.obs.finality import FinalityTracker as RefTracker
from tpu_swirld.obs.flightrec import FlightRecorder as RefRecorder
from tpu_swirld.oracle.node import Node as RefNode
from tpu_swirld.packing import pack_events
from tpu_swirld.sim import generate_gossip_dag
from tpu_swirld.tpu import pipeline as ref
from tpu_swirld_torch import (
    IncrementalConsensus, MeshStreamingConsensus, Node, StreamingConsensus,
    make_mesh,
)
from tpu_swirld_torch.gpu import incremental
from tpu_swirld_torch.gpu.pipeline import run_consensus
from tpu_swirld_torch.obs import (
    FinalityTracker, FlightRecorder, load_dump, record_batch_result,
)
from tests.test_torch_incremental import _straggler_flood, fixed_chunks, port_events
from tests.test_torch_pipeline import carry_across
from tests.test_torch_store import port_config

SHAPES = {"8m-400ev-2forkers": (8, 400, 3, 2), "6m-300ev-honest": (6, 300, 5, 0)}
#: tests/test_finality.py's driver settings
DRIVER_KW = dict(block=64, chunk=64, window_bucket=512, prune_min=128)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _oracle(node_cls, tracker_cls, events, members, keys, cfg):
    """An observer node fed the whole DAG in one pass, its tracker on a
    logical clock pinned at 0 (so only the rounds-to-decision samples
    record; every time-to-finality sample is dropped as negative)."""
    node = node_cls(
        sk=keys[0][1], pk=members[0], network={}, members=members,
        clock=lambda: 0, create_genesis=False, config=cfg,
    )
    node.finality = tracker_cls("oracle", clock=lambda: 0)
    new_ids = [ev.id for ev in events if node.add_event(ev)]
    node.consensus_pass(new_ids)
    return node.finality


def _driven(driver, events):
    driver.finality = FinalityTracker(driver.flightrec_label)
    for chunk in fixed_chunks(events, 100):
        driver.ingest(chunk)
    if hasattr(driver, "store"):
        driver.store.close()
    return driver.finality


@pytest.mark.parametrize("shape", list(SHAPES))
def test_rounds_to_decision_matches_reference_oracle(shape):
    n_members, n_events, seed, forkers = SHAPES[shape]
    members, stake, events, keys = generate_gossip_dag(
        n_members, n_events, seed=seed, n_forkers=forkers
    )
    ref_cfg = RefConfig(n_members=n_members)
    cfg = port_config(ref_cfg)
    mine = port_events(events)
    want = _oracle(RefNode, RefTracker, events, members, keys, ref_cfg)
    assert len(want.rtd) > 0, "the DAG must decide events"

    batch = FinalityTracker("batch")
    packed = carry_across(pack_events(events, members, stake))
    record_batch_result(batch, run_consensus(packed, cfg, block=64, device="cpu"))
    got = {
        "oracle": _oracle(Node, FinalityTracker, mine, members, keys, cfg),
        "batch": batch,
        "incremental": _driven(IncrementalConsensus(
            members, stake, cfg, device="cpu", **DRIVER_KW), mine),
        "streaming": _driven(StreamingConsensus(
            members, stake, cfg, device="cpu", ingest_chunk=128, **DRIVER_KW),
            mine),
        "mesh": _driven(MeshStreamingConsensus(
            make_mesh(2, device="cpu"), members, stake, cfg, pallas=True,
            device="cpu", ingest_chunk=128, **DRIVER_KW), mine),
    }
    s_ref = want.summary()
    for engine, tracker in got.items():
        assert tracker.rtd == want.rtd, engine
        s = tracker.summary()
        for k in ("decided", "rtd_mean", "rtd_p50", "rtd_p99", "rtd_max"):
            assert s[k] == s_ref[k], (engine, k)
    # the streaming drivers stamp each decision with how it was decided
    # ("window" / "widened" / "full"): the same on one shard and on two
    by_phase = [{k: v for k, v in got[e].summary().items() if k != "engine"}
                for e in ("streaming", "mesh")]
    assert by_phase[0] == by_phase[1]


def _trigger_pair(tmp_path, ref_driver, driver, chunks):
    """Both drivers with a flight recorder dumping into ``tmp_path``,
    driven over ``chunks`` (reference events); returns the two
    recorders."""
    recs = []
    for name, d in (("ref", ref_driver), ("port", driver)):
        d.flightrec = (RefRecorder if name == "ref" else FlightRecorder)(
            dump_dir=str(tmp_path / name), clock=lambda: 0
        )
        recs.append(d.flightrec)
    for chunk in chunks:
        ref_driver.ingest(chunk)
        driver.ingest(port_events(chunk))
    return recs


def _assert_same_dumps(want, got):
    assert got.trigger_counts == want.trigger_counts
    assert [Path(p).name for p in got.dumps] == [Path(p).name for p in want.dumps]
    for a, b in zip(want.dumps, got.dumps):
        da, db = json.loads(Path(a).read_text()), json.loads(Path(b).read_text())
        assert db == da
        assert load_dump(a) == da          # a reference dump loads here
    return [json.loads(Path(p).read_text()) for p in got.dumps]


def test_rebase_storm_trigger_matches_reference(tmp_path):
    """``tests/test_torch_incremental.py::test_storm_guard_engages``'s
    schedule: the guard engages in both drivers, with the same trigger."""
    members, stake, events, floods = _straggler_flood()
    ref_cfg = RefConfig(n_members=8)
    kw = dict(block=64, chunk=64, window_bucket=256, prune_min=64,
              storm_threshold=3, storm_cooldown=4)
    want_d = ref.IncrementalConsensus(members, stake, ref_cfg, **kw)
    got_d = IncrementalConsensus(
        members, stake, port_config(ref_cfg), device="cpu", **kw
    )
    chunks = fixed_chunks(events, 100) + [[f] for f in floods]
    want, got = _trigger_pair(tmp_path, want_d, got_d, chunks)
    dumps = _assert_same_dumps(want, got)
    assert got.trigger_counts.get("rebase_storm", 0) >= 1
    storm = next(d for d in dumps if d["reason"] == "rebase_storm")
    assert storm["detail"] == {"consecutive": 3, "cooldown": 4}
    assert set(storm["decided_frontier"]) == {"incremental"}


def test_overflow_heal_trigger_matches_reference(tmp_path, monkeypatch):
    """The fork-storm DAG of ``tests/test_torch_pipeline.py::
    test_fork_storm_slot_heal`` ingested whole: the cold-start rebase's
    batch pass, given that test's under-provisioned witness-slot capacity
    (``members + 1``; a driver provisions every fork's extra slot, so
    only an under-provisioned pass can overflow), heals in both drivers
    and fires the same ``overflow_heal``."""
    members, stake, events, _keys = generate_gossip_dag(
        8, 500, seed=4, n_forkers=3, fork_prob=0.4
    )

    ref_cfg = RefConfig(n_members=8)
    kw = dict(block=64, chunk=64, window_bucket=256, prune_min=64)
    want_d = ref.IncrementalConsensus(members, stake, ref_cfg, **kw)
    got_d = IncrementalConsensus(
        members, stake, port_config(ref_cfg), device="cpu", **kw
    )

    def short_slots(columns_pass, driver):
        # the rebase's slot capacity cut to members + 1, the driver's too,
        # so the healed capacity it adopts is the pass's
        def run(*args, s_max, **kw):
            driver._s_cap = len(members) + 1
            return columns_pass(*args, s_max=driver._s_cap, **kw)
        return run

    monkeypatch.setattr(ref, "_columns_pass", short_slots(ref._columns_pass, want_d))
    monkeypatch.setattr(incremental, "_columns_pass",
                        short_slots(incremental._columns_pass, got_d))
    want, got = _trigger_pair(tmp_path, want_d, got_d, [events])
    dumps = _assert_same_dumps(want, got)
    assert got_d.overflow_heals == want_d.overflow_heals >= 1
    heal = next(d for d in dumps if d["reason"] == "overflow_heal")
    assert heal["detail"]["retries"] == got_d.overflow_heals
    assert heal["decided_frontier"] == {"incremental": {"decided": 0, "round": 0}}


@pytest.mark.slow
def test_live_obs_golden_matches_reference():
    """Recompute ``chip_smoke.LIVE_OBS_GOLDEN``: the reference's
    ``make_simulation(64, seed=LIVE_SEED, metrics=True, finality=True,
    flightrec=...)`` under the simulation signer gossips as
    ``chip_smoke.gossip_until`` drives the port's until node 0 holds
    ``LIVE_OBS_EVENTS`` events; node 0 runs its oracle passes (its tracker
    records every decision), the peers none (a pass changes no gossip).
    Then the JAX reference's ``run_consensus`` on node 0's DAG, with its
    rounds-to-decision list (``record_batch_result``).  The live oracle
    node has decided a prefix of that order (it decides rounds as they
    settle on its own passes), with the same samples."""
    import chip_smoke
    from tpu_swirld import crypto as ref_crypto
    from tpu_swirld.obs.finality import record_batch_result as ref_record
    from tpu_swirld.packing import pack_node
    from tpu_swirld.sim import make_simulation as ref_make_simulation

    prev = ref_crypto.backend_name()
    ref_crypto.set_backend("sim")
    try:
        sim = ref_make_simulation(
            chip_smoke.N_MEMBERS, seed=chip_smoke.LIVE_SEED, metrics=True,
            finality=True, flightrec=RefRecorder(),
        )
        for node in sim.nodes[1:]:
            node.consensus_pass = lambda new_ids: None
        turns = chip_smoke.gossip_until(sim, chip_smoke.LIVE_OBS_EVENTS)
        node = sim.nodes[0]
        packed = pack_node(node)
        res = ref.run_consensus(packed, node.config)
        batch = RefTracker("batch")
        ref_record(batch, res)
        got = {
            "turns": turns, "events": packed.n,
            **chip_smoke.result_digests(packed, res),
            "rtd": chip_smoke.rtd_digest(batch.rtd),
            "oracle_rtd": chip_smoke.rtd_digest(node.finality.rtd),
            "gossip": chip_smoke.gossip_totals(sim.nodes),
        }
    finally:
        ref_crypto.set_backend(prev)
    n = len(node.consensus)
    assert 0 < n and node.consensus == [packed.ids[i] for i in res.order[:n]]
    assert node.finality.rtd == batch.rtd[:n]
    assert got == chip_smoke.LIVE_OBS_GOLDEN
