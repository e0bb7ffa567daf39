"""The port's ``IncrementalConsensus`` (``device="cpu"``, plain kernel
versions) driven in lockstep with the JAX reference's over the schedules of
``tests/test_incremental.py`` and ``tests/test_fused.py``.  Tolerance: exact
equality everywhere.  After every ``ingest`` the stats dicts (apart from
``seconds``), the counters and the carried state (host mirrors, cursors and
the anc / sees / ssm slabs) are equal; at the end ``result()`` equals the
reference driver's and the reference ``run_consensus``'s over the same
delivery order."""

import random

import numpy as np
import pytest
import torch

from tpu_swirld.config import SwirldConfig as RefConfig
from tpu_swirld.packing import pack_events as ref_pack_events
from tpu_swirld.packing import pack_node
from tpu_swirld.sim import (
    chunked_ingest_schedule, generate_gossip_dag, make_simulation,
    run_with_forkers,
)
from tpu_swirld.tpu import pipeline as ref
from tpu_swirld_torch.event import Event
from tpu_swirld_torch.gpu.incremental import IncrementalConsensus
from tpu_swirld_torch.device import to_host
from tests.test_torch_pipeline import assert_same, port_config

STATE = ("_rnd_w", "_wits_w", "_tab_np", "_cnt_np", "_famous_np", "_recv_w",
         "_col_events", "_parents_w", "_colpos_w")
CURSORS = ("_n_done", "_lo", "_r_base", "_n_cols", "_consensus_round",
           "_frozen_vote_hi", "_max_round", "_w_pad", "_wcol_cap", "_r_cap",
           "_s_cap")
COUNTERS = ("passes", "rebases", "overflow_heals", "storm_entries",
            "storm_rebases", "max_consecutive_rebases")
SLABS = ("_anc_d", "_sees_d", "_ssm_d")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def port_events(events):
    """Reference events carried field by field into the port's record (the
    same body layout, so the same ids)."""
    return [Event(d=e.d, p=tuple(e.p), t=e.t, c=e.c, s=e.s) for e in events]


def assert_same_state(want, got):
    for k in CURSORS + COUNTERS:
        assert getattr(got, k) == getattr(want, k), k
    assert got._initialized == want._initialized
    if not want._initialized:
        return
    for k in STATE:
        a, b = getattr(got, k), getattr(want, k)
        assert a.shape == b.shape and np.array_equal(a, b), k
    for k in SLABS:
        assert np.array_equal(to_host(getattr(got, k)), np.asarray(getattr(want, k))), k
    assert (got._sees_d is got._anc_d) == (want._sees_d is want._anc_d)
    assert got.window_size == want.window_size
    assert got.pruned_prefix == want.pruned_prefix
    assert got.storm_mode == want.storm_mode


def drive_both(members, stake, cfg, chunks, *, ref_kw=None, port_kw=None, **kw):
    """Ingest ``chunks`` (reference events) into both drivers, comparing
    after every pass.  Returns the two drivers and the port's per-pass
    ``ordered`` lists concatenated."""
    want = ref.IncrementalConsensus(members, stake, cfg, **kw, **(ref_kw or {}))
    got = IncrementalConsensus(
        members, stake, port_config(cfg), device="cpu", **kw, **(port_kw or {})
    )
    ordered = []
    for chunk in chunks:
        sw = want.ingest(chunk)
        sg = got.ingest(port_events(chunk))
        sw.pop("seconds")
        sg.pop("seconds")
        assert sg == sw
        ordered.extend(sg["ordered"])
        assert_same_state(want, got)
    assert_same(want.result(), got.result())
    return want, got, ordered


def assert_batch_parity(got, delivery, members, stake, cfg, **kw):
    packed = ref_pack_events(delivery, members, stake)
    assert_same(ref.run_consensus(packed, cfg, **kw), got.result())


def fixed_chunks(events, size):
    return [events[i : i + size] for i in range(0, len(events), size)]


def sim_node(n, seed, turns):
    sim = make_simulation(n, seed=seed)
    sim.run(turns)
    node = sim.nodes[0]
    events = [node.hg[e] for e in node.order_added]
    return node, events, [node.stake[m] for m in node.members]


def test_small_sim_60_event_chunks():
    node, events, stake = sim_node(5, 11, 250)
    _want, got, ordered = drive_both(
        node.members, stake, node.config, fixed_chunks(events, 60),
        block=64, chunk=32, window_bucket=256, prune_min=64,
    )
    res = got.result()
    assert_same(ref.run_consensus(pack_node(node), node.config, block=64), res)
    assert ordered == res.order and len(res.order) > 0
    assert got.pruned_prefix > 0


def test_random_chunk_sizes():
    node, events, stake = sim_node(4, 7, 220)
    rng = random.Random(3)
    chunks, i = [], 0
    while i < len(events):
        c = rng.choice([1, 2, 7, 25, 80])
        chunks.append(events[i : i + c])
        i += c
    _want, got, _ = drive_both(
        node.members, stake, node.config, chunks,
        block=64, chunk=32, window_bucket=256, prune_min=32,
    )
    assert_same(ref.run_consensus(pack_node(node), node.config, block=64), got.result())


def test_forked_sim():
    sim = run_with_forkers(n_nodes=7, n_forkers=2, n_turns=300, seed=9)
    node = next(n for n in sim.nodes if any(n.has_fork[m] for m in sim.members))
    events = [node.hg[e] for e in node.order_added]
    stake = [node.stake[m] for m in node.members]
    packed = pack_node(node)
    assert len(packed.fork_pairs) > 0
    _want, got, _ = drive_both(
        node.members, stake, node.config, fixed_chunks(events, 50),
        block=64, chunk=64, window_bucket=256, prune_min=64,
    )
    assert got._sees_d is not got._anc_d
    assert_same(ref.run_consensus(packed, node.config, block=64), got.result())


def test_fork_heavy_generated_dag():
    members, stake, events, _keys = generate_gossip_dag(12, 1200, seed=4, n_forkers=4)
    cfg = RefConfig(n_members=12)
    _want, got, _ = drive_both(
        members, stake, cfg, fixed_chunks(events, 150),
        chunk=128, window_bucket=512, prune_min=128,
    )
    assert_batch_parity(got, events, members, stake, cfg)


def test_straggler_schedule():
    members, stake, events, _keys = generate_gossip_dag(8, 900, seed=6)
    cfg = RefConfig(n_members=8)
    chunks = chunked_ingest_schedule(events, 90, delay_prob=0.2, max_delay=4, seed=1)
    flat = [ev for chunk in chunks for ev in chunk]
    assert [ev.id for ev in flat] != [ev.id for ev in events]
    _want, got, _ = drive_both(
        members, stake, cfg, chunks,
        block=64, chunk=64, window_bucket=256, prune_min=64,
    )
    assert_batch_parity(got, flat, members, stake, cfg)


def _straggler_flood(n_events=600, n_floods=8, seed=6):
    """tests/test_chaos.py's flood: a pruned main stream, then events whose
    parents were pruned long ago, each a detected rebase."""
    from tpu_swirld.oracle.event import Event as RefEvent

    members, stake, events, keys = generate_gossip_dag(8, n_events, seed=seed)
    by_creator = {}
    for ev in events:
        by_creator.setdefault(ev.c, []).append(ev)
    floods = []
    for k in range(n_floods):
        ci = k % 8
        pk, sk = keys[ci]
        old_self = by_creator[pk][2 + (k % 3)]
        old_other = by_creator[members[(ci + 1) % 8]][2]
        floods.append(RefEvent(
            d=b"straggler:%d" % k, p=(old_self.id, old_other.id),
            t=old_self.t + 1, c=pk,
        ).signed(sk))
    return members, stake, events, floods


def test_storm_guard_engages():
    members, stake, events, floods = _straggler_flood()
    cfg = RefConfig(n_members=8)
    chunks = fixed_chunks(events, 100) + [[f] for f in floods]
    _want, got, _ = drive_both(
        members, stake, cfg, chunks, block=64, chunk=64, window_bucket=256,
        prune_min=64, storm_threshold=3, storm_cooldown=4,
    )
    assert got.storm_entries >= 1 and got.storm_rebases >= 1
    assert got.max_consecutive_rebases <= 3
    assert_batch_parity(got, events + floods, members, stake, cfg, block=64)


@pytest.mark.parametrize("fuse", [1, 4])
def test_fused_and_per_chunk_loop_with_forks(fuse):
    """tests/test_fused.py's random chunking over forked history: the port
    equals the reference at the same fuse_chunks, and fuse 1 and 4 agree."""
    members, stake, events, _keys = generate_gossip_dag(12, 1400, seed=4, n_forkers=4)
    cfg = RefConfig(n_members=12)
    rng = random.Random(7)
    chunks, i = [], 0
    while i < len(events):
        c = rng.choice((2, 30, 90, 200))
        chunks.append(events[i : i + c])
        i += c
    _want, got, _ = drive_both(
        members, stake, cfg, chunks, chunk=64, window_bucket=512,
        prune_min=128, fuse_chunks=fuse,
    )
    assert got._fuse == fuse
    assert_batch_parity(got, events, members, stake, cfg)


def test_fused_ragged_span_tail():
    """Deltas of 320 events = 5 scan chunks of 64 with fuse_chunks=4: a full
    span (k=4) and a ragged tail (k=1) every pass."""
    members, stake, events, _keys = generate_gossip_dag(8, 1000, seed=9)
    cfg = RefConfig(n_members=8)
    _want, got, _ = drive_both(
        members, stake, cfg, fixed_chunks(events, 320),
        chunk=64, window_bucket=512, prune_min=128, fuse_chunks=4,
    )
    calls = got.stages.calls["pipeline.rounds_span_stage"]
    assert calls >= 2 * (got.passes - got.rebases)
    assert_batch_parity(got, events, members, stake, cfg)


def test_pallas_bundle_parity():
    """tests/test_pallas.py:135's schedule: the reference under its
    interpret-mode Pallas bundle, the port under make_extension_kernels()."""
    from tpu_swirld.tpu.pallas_kernels import make_extension_kernels as ref_bundle
    from tpu_swirld_torch.gpu.kernels import make_extension_kernels

    sim = run_with_forkers(5, 1, 220, seed=17)
    node = sim.nodes[0]
    packed = pack_node(node)
    assert len(packed.fork_pairs) > 0
    events = [node.hg[e] for e in node.order_added]
    stake = [node.stake[m] for m in node.members]
    _want, got, _ = drive_both(
        node.members, stake, node.config, fixed_chunks(events, 80),
        block=64, chunk=64, window_bucket=256, prune_min=64,
        ref_kw={"extension_kernels": ref_bundle(interpret=True, tile_m=128, tile_n=128)},
        port_kw={"extension_kernels": make_extension_kernels()},
    )
    assert got._kern.name == "cuda"
    assert_same(ref.run_consensus(packed, node.config, block=64), got.result())


def test_empty_and_noop_ingests():
    got = IncrementalConsensus([b"m0", b"m1", b"m2"], [1, 1, 1], device="cpu")
    st = got.ingest([])
    assert st["new_events"] == 0 and st["ordered"] == []
    assert got.resident_visibility_bytes == 0
    members, stake, events, _keys = generate_gossip_dag(3, 30, seed=0)
    want, got, _ = drive_both(
        members, stake, RefConfig(n_members=3), [events, []],
        chunk=32, window_bucket=256,
    )
    assert got.resident_visibility_bytes == want.resident_visibility_bytes > 0
