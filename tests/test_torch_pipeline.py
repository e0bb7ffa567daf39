"""The port's column-restricted ``run_consensus`` (on the CPU, plain kernel
versions) against the JAX reference on the same DAG, carried across with
``packed_from_arrays``: exact equality of every consensus output, no
tolerance.  The visibility module (the bmm_or hops) is also held against the
reference's functions on its own."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_swirld.config import SwirldConfig as RefConfig
from tpu_swirld.packing import pack_events, pack_node
from tpu_swirld.sim import generate_gossip_dag, make_simulation, run_with_forkers
from tpu_swirld.tpu import pipeline as ref
from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.gpu import pipeline
from tpu_swirld_torch.packing import packed_from_arrays
from tests.test_pipeline import assert_parity


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tiny ops: torch's CPU thread pool costs far more than it saves here
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def carry_across(p):
    return packed_from_arrays(
        p.n_members, p.parents, p.creator, p.seq, p.t, p.coin, p.stake,
        p.fork_pairs, p.member_table, p.ids, p.sigs,
    )


def port_config(cfg: RefConfig) -> SwirldConfig:
    return SwirldConfig(
        n_members=cfg.n_members, coin_period=cfg.coin_period,
        max_rounds=cfg.max_rounds, stake=cfg.stake, seed=cfg.seed,
        fuse_chunks=cfg.fuse_chunks,
    )


def assert_same(want, got):
    assert np.array_equal(got.round, want.round)
    assert np.array_equal(got.is_witness, want.is_witness)
    assert got.famous == want.famous
    assert np.array_equal(got.round_received, want.round_received)
    assert np.array_equal(got.consensus_ts, want.consensus_ts)
    assert got.order == want.order
    assert got.max_round == want.max_round


def run_both(packed, cfg, **kw):
    want = ref.run_consensus(packed, cfg, **kw)
    got = pipeline.run_consensus(
        carry_across(packed), port_config(cfg), device="cpu", **kw
    )
    assert_same(want, got)
    return want, got


def test_sim_parity_with_reference_and_oracle():
    sim = make_simulation(5, seed=17)
    sim.run(250)
    node = sim.nodes[0]
    packed = pack_node(node)
    _want, got = run_both(packed, node.config, block=64)
    assert_parity(node, carry_across(packed), got)
    assert len(got.order) > 0


def test_forkers_parity():
    sim = run_with_forkers(7, 2, 260, seed=9)
    node = sim.nodes[0]
    packed = pack_node(node)
    assert len(packed.fork_pairs) > 0
    _want, got = run_both(packed, node.config, block=64)
    assert_parity(node, carry_across(packed), got)


def test_gossip_dag_config2_scaled_down():
    members, stake, events, _keys = generate_gossip_dag(16, 1000, seed=2)
    packed = pack_events(events, members, stake)
    _want, got = run_both(packed, RefConfig(n_members=16))
    assert len(got.order) > 0
    assert got.timings["ssm_columns"] > 0


def test_round_clamp_heal_with_unequal_stake():
    """chaos.run_overflow_storm's clamp leg: stake (3,2,2,1,1) under an
    explicit r_max=8 overflows the round window and heals."""
    cfg = RefConfig(n_members=5, stake=(3, 2, 2, 1, 1), seed=4)
    sim = make_simulation(5, seed=4, config=cfg)
    sim.run(320)
    node = sim.nodes[0]
    packed = pack_node(node)
    want, got = run_both(packed, node.config, block=64, r_max=8)
    assert got.timings["overflow_retries"] == want.timings["overflow_retries"]
    assert got.timings["overflow_retries"] >= 1
    assert_parity(node, carry_across(packed), got)


def test_fork_storm_slot_heal():
    """chaos.run_overflow_storm's fork leg: three forkers at fork_prob 0.4
    with s_max = members + 1 exhaust the witness slots and heal."""
    members, stake, events, _keys = generate_gossip_dag(
        8, 500, seed=4, n_forkers=3, fork_prob=0.4
    )
    packed = pack_events(events, members, stake)
    want, got = run_both(
        packed, RefConfig(n_members=8), block=64, s_max=len(members) + 1
    )
    assert got.timings["overflow_retries"] == want.timings["overflow_retries"]
    assert got.timings["overflow_retries"] >= 1


def test_visibility_matches_reference():
    members, stake, events, _keys = generate_gossip_dag(
        6, 400, seed=5, n_forkers=2, fork_prob=0.3
    )
    packed = pack_events(events, members, stake)
    assert len(packed.fork_pairs) > 0
    n_pad = ((packed.n + 63) // 64) * 64
    parents = np.full((n_pad, 2), -1, np.int32)
    parents[: packed.n] = packed.parents
    creator = np.zeros((n_pad,), np.int32)
    creator[: packed.n] = packed.creator
    fork_pairs = np.ascontiguousarray(packed.fork_pairs)
    want_anc, want_sees = ref.visibility_stage(
        jnp.asarray(parents), jnp.asarray(creator), jnp.asarray(fork_pairs),
        n_members=6, block=64, matmul_dtype_name="float32",
    )
    got_anc, got_sees = pipeline.visibility_stage(
        torch.from_numpy(parents), torch.from_numpy(creator),
        torch.from_numpy(fork_pairs), n_members=6, block=64,
    )
    assert np.array_equal(got_anc.numpy(), np.asarray(want_anc))
    assert np.array_equal(got_sees.numpy(), np.asarray(want_sees))


def test_mesh_still_raises():
    members, stake, events, _keys = generate_gossip_dag(4, 40, seed=1)
    packed = carry_across(pack_events(events, members, stake))
    with pytest.raises(NotImplementedError):
        pipeline.run_consensus(packed, device="cpu", mesh=object())
