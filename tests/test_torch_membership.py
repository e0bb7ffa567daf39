"""The port's dynamic membership (``tpu_swirld_torch.membership``) against the
reference's, on the CPU at 4-5 members, every comparison exact: the ``MTX1``
bytes and the total decoder, the epoch ledger's digest and meta document
(and its tamper check), ``Packer.add_member`` / ``set_stake``, the repack
stage, the single-epoch pin of every device engine, cross-engine parity over
two epoch transitions with a fork pair, restatement determinism, and the
port's dynamic simulations gossiping the reference's events and node
states."""

import collections
import json
import struct

import numpy as np
import pytest
import torch

from tpu_swirld import crypto as ref_crypto
from tpu_swirld import membership as ref_mem
from tpu_swirld.membership.engine import run_dynamic as ref_run_dynamic
from tpu_swirld.membership.repack import repack_stage as ref_repack_stage
from tpu_swirld.membership.sim import (
    churn_schedule as ref_churn_schedule,
    make_dynamic_simulation as ref_make_dynamic_simulation,
)
from tpu_swirld.oracle.event import Event as RefEvent
from tpu_swirld.packing import Packer as RefPacker
from tpu_swirld.sim import generate_gossip_dag as ref_generate_gossip_dag
from tpu_swirld.sim import make_simulation as ref_make_simulation
from tpu_swirld_torch import crypto, make_mesh, membership
from tpu_swirld_torch.event import Event
from tpu_swirld_torch.membership.dynamic import DynamicNode
from tpu_swirld_torch.membership.engine import (
    ENGINES, run_all_engines, run_dynamic,
)
from tpu_swirld_torch.membership.repack import repack_packer, repack_stage
from tpu_swirld_torch.membership.sim import (
    churn_schedule, make_dynamic_simulation, sim_member,
)
from tpu_swirld_torch.packing import Packer
from tpu_swirld_torch.sim import generate_gossip_dag, make_simulation

DEVICE_ENGINES = [e for e in ENGINES if e != "oracle"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tiny ops: torch's CPU thread pool costs far more than it saves here
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def sim_signer():
    """Both packages' crypto backends set to the simulation signer,
    restored afterwards."""
    prev = ref_crypto.backend_name(), crypto.backend_name()
    ref_crypto.set_backend("sim")
    crypto.set_backend("sim")
    try:
        yield
    finally:
        ref_crypto.set_backend(prev[0])
        crypto.set_backend(prev[1])


def _mesh_kw(engine):
    return {"mesh": make_mesh(2, "cpu")} if engine == "mesh" else {}


# ------------------------------------------------------------ wire format


@pytest.mark.parametrize("kind", ["join", "leave", "restake"])
def test_mtx_bytes_equal_reference(kind):
    pk = b"\x05" * 32
    args = (pk,) if kind == "leave" else (pk, 7)
    got = getattr(membership, f"{kind}_payload")(*args)
    want = getattr(ref_mem, f"{kind}_payload")(*args)
    assert got == want
    tx = membership.decode_tx(got)
    assert (tx.kind, tx.pk, tx.stake, tx.kind_name) == (
        ref_mem.decode_tx(want).kind, pk, 0 if kind == "leave" else 7, kind
    )
    assert membership.encode_tx(tx) == got


def test_mtx_decode_is_total_as_reference():
    pk = b"\x02" * 32
    good = ref_mem.join_payload(pk, 1)
    payloads = [
        b"", b"client-tx-bytes", b"MTX1", b"MTX1\x01", b"TXB1" + good[4:],
        good[:-1], good + b"\x00", good,
        b"MTX1" + bytes([9, 32]) + pk + struct.pack("<I", 1),
        b"MTX1" + bytes([ref_mem.JOIN, 32]) + pk + struct.pack("<I", 0),
        b"MTX1" + bytes([ref_mem.LEAVE, 32]) + pk + struct.pack("<I", 5),
        b"MTX1" + bytes([ref_mem.RESTAKE, 0]) + struct.pack("<I", 5),
        ref_mem.restake_payload(pk, 2**32 - 1), ref_mem.leave_payload(b"k"),
    ]
    for p in payloads:
        got, want = membership.decode_tx(p), ref_mem.decode_tx(p)
        if want is None:
            assert got is None, p
        else:
            assert (got.kind, got.pk, got.stake) == (want.kind, want.pk, want.stake)
    for bad in [(9, pk, 1), (membership.JOIN, pk, 1 << 32), (membership.JOIN, b"", 1)]:
        with pytest.raises(ValueError):
            membership.encode_tx(membership.MembershipTx(*bad))


# ------------------------------------------------------------ epoch ledger


def _ledger_ops(mod, members, joiner):
    """One apply sequence, as both packages build it: a join, a leave, a
    merge into the pending epoch, a restake, no-ops and a duplicate
    carrier."""
    return [
        (mod.join_payload(joiner, 2), 9, b"c1"),
        (mod.leave_payload(members[1]), 24, b"c2"),
        (mod.restake_payload(members[0], 5), 24, b"c3"),
        (mod.leave_payload(members[1]), 34, b"c2"),
        (mod.join_payload(joiner, 3), 40, b"c4"),
        (mod.restake_payload(members[2], 1), 41, b"c5"),
        (mod.restake_payload(members[2], 4), 3, b"c6"),
    ]


def _ledger(mod, members, joiner):
    led = mod.EpochLedger.genesis(members, [1, 1, 1])
    for payload, act, carrier in _ledger_ops(mod, members, joiner):
        led = led.apply(mod.decode_tx(payload), act, carrier)
    return led


def test_epoch_ledger_digest_and_meta_equal_reference():
    members = [crypto.keypair(b"ledger-%d" % i)[0] for i in range(3)]
    joiner = crypto.keypair(b"ledger-join")[0]
    got = _ledger(membership, members, joiner)
    want = _ledger(ref_mem, members, joiner)
    assert len(got.epochs) == len(want.epochs) == 3
    assert got.digest() == want.digest()
    assert got.to_meta() == want.to_meta()
    assert got.applied == want.applied
    assert [e.digest() for e in got.epochs] == [e.digest() for e in want.epochs]
    for r in range(0, 50, 3):
        assert got.epoch_at(r).epoch_id == want.epoch_at(r).epoch_id
        assert got.total_at(r) == want.total_at(r)
    # a document of either package loads in the other
    back = membership.EpochLedger.from_meta(json.loads(json.dumps(want.to_meta())))
    assert back.digest() == want.digest()
    assert ref_mem.EpochLedger.from_meta(got.to_meta()).digest() == got.digest()
    # the canonical reconstruction from a decided prefix
    decided = [(c, p, a - membership.DEFAULT_DELAY)
               for p, a, c in _ledger_ops(membership, members, joiner)
               if a >= membership.DEFAULT_DELAY]
    assert membership.ledger_from_decided(decided, members, [1, 1, 1]).digest() == (
        ref_mem.ledger_from_decided(decided, members, [1, 1, 1]).digest()
    )


def test_epoch_ledger_from_meta_refuses_tamper():
    members = [crypto.keypair(b"ledger-%d" % i)[0] for i in range(2)]
    led = membership.EpochLedger.genesis(members, [2, 2]).apply(
        membership.decode_tx(membership.restake_payload(members[0], 5)),
        activation=7, carrier=b"c",
    )
    meta = led.to_meta()
    assert membership.EpochLedger.from_meta(json.loads(json.dumps(meta))).same_epochs(led)
    bad = json.loads(json.dumps(meta))
    bad["epochs"][1]["stake"][0] = 99
    with pytest.raises(ValueError, match="digest mismatch"):
        membership.EpochLedger.from_meta(bad)
    with pytest.raises(ValueError):
        ref_mem.EpochLedger.from_meta(bad)


# ---------------------------------------------------- packer and repack


def test_packer_add_member_and_set_stake_pack_as_reference(sim_signer):
    sim = ref_make_simulation(4, seed=6)
    sim.run(60)
    node = sim.nodes[0]
    events = [node.hg[e] for e in node.order_added]
    joiner = crypto.keypair(b"packer-join")[0]
    got, want = Packer(node.members, [1, 2, 3, 4]), RefPacker(node.members, [1, 2, 3, 4])
    for p in (got, want):
        p.extend(events[:30])
        assert p.add_member(joiner) == 4
        assert p.add_member(node.members[2]) == 2
        p.extend(events[30:])
        with pytest.raises(ValueError, match="stake length"):
            p.set_stake([1, 1, 1, 1])
    a, b = got.pack(), want.pack()
    assert a.n_members == b.n_members == 5
    for field in ("parents", "creator", "seq", "t", "coin", "stake",
                  "fork_pairs", "member_table"):
        assert np.array_equal(getattr(a, field), getattr(b, field)), field
    assert list(a.stake) == [1, 2, 3, 4, 0]
    for p in (got, want):
        p.set_stake([0, 2, 3, 4, 6])
    assert np.array_equal(got.pack().stake, want.pack().stake)
    assert got.member_table_view(4).shape == (4, b.member_table.shape[1])
    assert np.array_equal(got.member_table_view(4), b.member_table[:4])


@pytest.mark.parametrize("m,k,m_new", [(4, 1, 5), (3, 7, 3), (6, 12, 9)])
def test_repack_stage_matches_reference(m, k, m_new):
    rng = np.random.default_rng(m * 100 + k)
    table = rng.integers(-1, 50, (m, k)).astype(np.int32)
    stake = rng.integers(0, 9, m_new).astype(np.int32)
    got_t, got_s = repack_stage(torch.as_tensor(table), stake, n_members_new=m_new)
    want_t, want_s = ref_repack_stage(table, stake, n_members_new=m_new)
    assert got_t.dtype == torch.int32 and got_s.dtype == torch.int32
    assert np.array_equal(got_t.numpy(), np.asarray(want_t))
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))


def test_repack_packer_on_the_cpu_and_raises_without_a_card():
    members = [crypto.keypair(b"rp-%d" % i)[0] for i in range(3)]
    joiner = crypto.keypair(b"rp-join")[0]
    led = membership.EpochLedger.genesis(members, [1, 1, 1]).apply(
        membership.decode_tx(membership.join_payload(joiner, 2)), 5, b"c"
    )
    packer, outputs = Packer(members, [1, 1, 1]), []
    stats = repack_packer(packer, led.head, "cpu", outputs=outputs)
    assert (stats.members_before, stats.members_after, stats.rows_added) == (3, 4, 1)
    assert stats.to_dict()["epoch_id"] == 1
    (table, stake), = outputs
    assert table.device.type == "cpu" and tuple(table.shape) == (4, 1)
    assert stake.tolist() == [1, 1, 1, 2]
    assert packer.members[-1] == joiner and packer.stake.tolist() == [1, 1, 1, 2]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            repack_packer(Packer(members, [1, 1, 1]), led.head)


# ------------------------------------------------------ single-epoch pin


@pytest.mark.parametrize("engine", DEVICE_ENGINES)
def test_single_epoch_pin(sim_signer, engine):
    """No decided membership tx: every engine's dynamic driver on the CPU
    equals its native engine (run_dynamic raises on a divergence) and the
    reference's oracle driver over the same events."""
    sim = make_simulation(4, seed=2)
    sim.run(100)
    node = sim.nodes[0]
    events = [node.hg[e] for e in node.order_added]
    res = run_dynamic(
        events, list(node.members), list(node.config.stakes()), node.config,
        engine=engine, chunk=32, cross_check=True, device="cpu",
        **_mesh_kw(engine),
    )
    assert res.single_epoch and res.epochs == 1
    assert res.restatements == 0 and res.repacks == [] and res.repack_outputs == []
    assert res.native_order == res.order and len(res.order) > 0
    assert res.order == node.consensus
    ref = ref_run_dynamic(
        events, list(node.members), list(node.config.stakes()), engine="oracle"
    )
    assert res.order == ref.order
    assert res.rounds == ref.rounds
    assert res.witnesses == ref.witnesses


@pytest.mark.parametrize("n,n_events,seed,forkers,fork_prob,stake", [
    (5, 500, 8, 1, 0.05, None),
    (7, 700, 3, 2, 0.1, [1, 2, 3, 4, 5, 6, 7]),
    (10, 800, 2, 3, 0.15, [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]),
])
def test_observer_matches_reference_on_forked_dags(sim_signer, n, n_events, seed,
                                                   forkers, fork_prob, stake):
    """The port's observer (whose strongly-sees tally takes shortcuts the
    reference's does not) against the reference's, per event and in
    chunks, on forked DAGs with uneven stake: the same order, rounds and
    witness flags."""
    args = dict(seed=seed, stake=stake, n_forkers=forkers, fork_prob=fork_prob)
    members, stake_v, events, _k = generate_gossip_dag(n, n_events, **args)
    _m, _s, want_events, _k = ref_generate_gossip_dag(n, n_events, **args)
    assert [e.id for e in events] == [e.id for e in want_events]
    for engine in ("oracle", "incremental"):
        got = run_dynamic(events, members, stake_v, engine=engine, chunk=64,
                          cross_check=False, device="cpu")
        want = ref_run_dynamic(want_events, members, stake_v, engine=engine,
                               chunk=64, cross_check=False)
        assert len(got.order) > 0
        assert got.order == want.order, engine
        assert got.rounds == want.rounds, engine
        assert got.witnesses == want.witnesses, engine


def test_run_dynamic_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    sim = make_simulation(4, seed=2)
    sim.run(20)
    node = sim.nodes[0]
    events = [node.hg[e] for e in node.order_added]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_dynamic(events, node.members, node.config.stakes(), engine="batch")
    with pytest.raises(ValueError, match="unknown engine"):
        run_dynamic(events, node.members, node.config.stakes(), engine="tpu")
    with pytest.raises(ValueError, match="DynamicNode drives the oracle"):
        DynamicNode(sk=node.sk, pk=node.pk, network={}, members=node.members,
                    config=node.config.__class__(n_members=4, backend="tpu"))


# ------------------------------------------- multi-epoch engine parity


def _fork_pair(sim, victim, event_cls):
    """Mint a sibling of ``victim``'s newest event and feed it to every
    node holding both parents (the reference test's helper, for either
    package's simulation)."""
    probe = max(sim.nodes, key=lambda x: len(x.hg))
    chain = probe.member_events.get(victim.pk, [])
    if len(chain) < 2:
        return 0
    newest = probe.hg[chain[-1]]
    if not newest.p:
        return 0
    sp, op = newest.p
    sib = event_cls(
        d=b"fork:%d" % len(chain), p=(sp, op), t=newest.t + 1, c=victim.pk
    ).signed(victim.sk)
    fed = 0
    for node in sim.nodes:
        if sib.id in node.hg or sp not in node.hg or op not in node.hg:
            continue
        if node.add_event(sib):
            node.consensus_pass([sib.id])
            fed += 1
    return fed


def _two_transitions(make, mod, event_cls):
    """The reference test's schedule: a restake, a fork pair, a vote-out
    leave on a direct honest sync, another fork pair."""
    sim = make(4, seed=5)
    victim = sim.nodes[3]
    sim.tx_schedule[12] = mod.restake_payload(sim_member(4, 5, 2), 5)
    sim.run(90)
    fed = _fork_pair(sim, victim, event_cls)
    sim.clock[0] += 1
    new_ids = sim.nodes[0].sync(sim.nodes[1].pk, mod.leave_payload(victim.pk))
    sim.nodes[0].consensus_pass(new_ids)
    sim.run(40)
    fed += _fork_pair(sim, victim, event_cls)
    sim.run(160)
    return sim, fed


def test_cross_engine_parity_two_transitions_with_fork(sim_signer):
    got_sim, fed = _two_transitions(make_dynamic_simulation, membership, Event)
    want_sim, want_fed = _two_transitions(ref_make_dynamic_simulation, ref_mem, RefEvent)
    assert fed == want_fed > 0
    for a, b in zip(got_sim.nodes, want_sim.nodes):
        assert a.order_added == b.order_added
        assert a.state_digest() == b.state_digest()
    node0 = max(got_sim.nodes, key=lambda x: len(x.consensus))
    assert len(node0.ledger.epochs) >= 3 and node0.forks_detected > 0
    assert node0.ledger.head.stake_of(got_sim.nodes[3].pk) == 0

    events = [node0.hg[e] for e in node0.order_added]
    args = (events, node0._genesis_members, node0._genesis_stake, got_sim.config)
    results = run_all_engines(
        *args, chunk=32, engines=tuple(DEVICE_ENGINES), device="cpu",
        mesh=make_mesh(2, "cpu"),
    )
    ref = ref_run_dynamic(*args, engine="oracle")
    ref_stream = ref_run_dynamic(*args, engine="streaming", chunk=32)
    ref_mesh = ref_run_dynamic(*args, engine="mesh", chunk=32)
    assert len(ref.ledger.epochs) >= 3
    for engine, res in results.items():
        assert res.order == ref.order, engine
        assert res.rounds == ref.rounds, engine
        assert res.witnesses == ref.witnesses, engine
        assert res.ledger.to_meta() == ref.ledger.to_meta(), engine
        assert res.ledger.same_epochs(results["batch"].ledger), engine
        assert len(res.repacks) == len(ref.ledger.epochs) - 1, engine
        assert [(s.members_before, s.members_after) for s in res.repacks] == [
            (s.members_before, s.members_after) for s in ref_stream.repacks
        ]
        assert not res.single_epoch and res.native_order is None
    stamped = results["streaming"].archive_epochs
    assert stamped == ref_stream.archive_epochs
    assert len({epoch for _, epoch in stamped}) >= 2
    assert results["mesh"].shard_pins == ref_mesh.shard_pins
    assert len(results["mesh"].shard_pins) == len(ref.ledger.epochs)


def _alt_topo(events):
    """Kahn's algorithm draining the ready set in reversed (creator,
    timestamp) order: the same DAG in another arrival order."""
    by_id = {e.id: e for e in events}
    children = collections.defaultdict(list)
    indeg = {}
    for ev in events:
        indeg[ev.id] = sum(1 for p in (ev.p or ()) if p in by_id)
        for p in ev.p or ():
            if p in by_id:
                children[p].append(ev.id)
    ready = [e.id for e in events if indeg[e.id] == 0]
    alt = []
    while ready:
        ready.sort(key=lambda i: (by_id[i].c, by_id[i].t), reverse=True)
        x = ready.pop(0)
        alt.append(by_id[x])
        for ch in children[x]:
            indeg[ch] -= 1
            if indeg[ch] == 0:
                ready.append(ch)
    return alt


def test_restatement_determinism(sim_signer):
    events, members, stake, sim = churn_schedule(4, seed=3, turns=420)
    want_events, _m, _s, want_sim = ref_churn_schedule(4, seed=3, turns=420)
    assert [e.id for e in events] == [e.id for e in want_events]
    for a, b in zip(sim.nodes, want_sim.nodes):
        assert a.state_digest() == b.state_digest()
    oracle = run_dynamic(events, members, stake, sim.config, engine="oracle", device="cpu")
    batch = run_dynamic(events, members, stake, sim.config, engine="batch",
                        cross_check=False, device="cpu")
    ref = ref_run_dynamic(want_events, members, stake, engine="oracle")
    assert len(oracle.ledger.epochs) >= 3
    assert batch.restatements >= 1
    for res in (oracle, batch):
        assert res.order == ref.order
        assert res.rounds == ref.rounds
        assert res.ledger.to_meta() == ref.ledger.to_meta()
    alt = _alt_topo(events)
    assert [e.id for e in alt] != [e.id for e in events]
    again = run_dynamic(alt, members, stake, sim.config, engine="oracle", device="cpu")
    assert again.order == oracle.order
    assert again.rounds == oracle.rounds
    assert again.ledger.same_epochs(oracle.ledger)


def test_dynamic_simulation_with_a_joiner_matches_reference(sim_signer):
    """A joining node online before its JOIN decides: gossip pre-admission,
    the registry's growth and the joiner's stake after activation, state
    digest equal to the reference's on every node."""
    sims = []
    for make, mod in ((make_dynamic_simulation, membership),
                      (ref_make_dynamic_simulation, ref_mem)):
        sim = make(4, seed=9)
        jpk, jsk = crypto.keypair(b"joiner-9")
        sim.tx_schedule[20] = mod.join_payload(jpk, 2)
        sim.run(30)
        sim.add_joiner(jsk, jpk)
        sim.run(330)
        sims.append(sim)
    got, want = sims
    assert len(got.nodes) == 5
    for a, b in zip(got.nodes, want.nodes):
        assert a.order_added == b.order_added
        assert a.state_digest() == b.state_digest()
        assert a.members == b.members
        assert a.fame_epoch_log == b.fame_epoch_log
        assert (a.membership_epoch, a.members_active, a.stake_total) == (
            b.membership_epoch, b.members_active, b.stake_total)
    joiner = got.nodes[4]
    node0 = got.nodes[0]
    assert joiner.pk in node0.members and node0.ledger.head.stake_of(joiner.pk) == 2
    assert len(joiner.consensus) > 0


@pytest.mark.slow
def test_churn_golden_digests_match_reference(sim_signer):
    """Recompute chip_smoke.CHURN_GOLDEN: the JAX reference's oracle driver
    on the reference's churn_schedule(**chip_smoke.CHURN); the port's
    schedule gossips the same events, and its oracle driver gives the same
    digests."""
    import chip_smoke

    want_events, members, stake, want_sim = ref_churn_schedule(**chip_smoke.CHURN)
    ref = ref_run_dynamic(want_events, members, stake, want_sim.config, engine="oracle")
    assert chip_smoke.dynamic_digests(ref) == chip_smoke.CHURN_GOLDEN
    events, members, stake, sim = churn_schedule(**chip_smoke.CHURN)
    assert [e.id for e in events] == [e.id for e in want_events]
    got = run_dynamic(events, members, stake, sim.config, engine="oracle", device="cpu")
    assert chip_smoke.dynamic_digests(got) == chip_smoke.CHURN_GOLDEN
