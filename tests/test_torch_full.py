"""The port's full-matrix batch path against the JAX reference: the
``ssm_matrix`` plain version against the XLA ``ssm_matrix`` and the Pallas
``ssm_matrix_pallas`` (interpret mode), the full ``rounds_scan`` and the
identity ``fame_scan`` branch, the fused ``consensus_body``, and
``run_consensus(ssm_mode="full")`` / ``(use_pallas_ssm=True)`` end to end
against the reference with the same kwargs and against the oracle.  Exact
equality everywhere, no tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_swirld.config import SwirldConfig as RefConfig
from tpu_swirld.oracle.node import Node
from tpu_swirld.packing import pack_events, pack_node
from tpu_swirld.sim import generate_gossip_dag, make_simulation, run_with_forkers
from tpu_swirld.tpu import pipeline as ref
from tpu_swirld.tpu.pallas_kernels import ssm_matrix_pallas
from tpu_swirld_torch.gpu import kernels, pipeline
from tests.test_pipeline import assert_parity
from tests.test_torch_kernels import _sees
from tests.test_torch_pipeline import assert_same, carry_across, port_config, run_both


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tiny ops: torch's CPU thread pool costs far more than it saves here
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stakes(packed):
    """The packed stake and one non-uniform stake over the same members."""
    rng = np.random.default_rng(7)
    return [packed.stake, rng.integers(1, 6, packed.n_members).astype(np.int32)]


# ------------------------------------------------------------- ssm_matrix


@pytest.mark.parametrize("kind", ["plain", "forked"])
def test_ssm_matrix_reference_matches_xla_and_pallas(kind):
    packed, sees = _sees(kind)
    mt = packed.member_table
    for stake in _stakes(packed):
        tot = int(stake.sum())
        args = (jnp.asarray(sees), jnp.asarray(mt), jnp.asarray(stake), tot, jnp.float32)
        want_xla = np.asarray(ref.ssm_matrix(*args))
        want_pallas = np.asarray(
            ssm_matrix_pallas(*args, tile_m=128, tile_n=128, interpret=True)
        )
        got = kernels.ssm_matrix_reference(
            torch.from_numpy(sees), torch.from_numpy(mt),
            torch.from_numpy(stake), tot_stake=tot,
        ).numpy()
        assert np.array_equal(got, want_xla)
        assert np.array_equal(got, want_pallas)
        assert 0 < got.sum() < got.size           # the rule is exercised


def test_ssm_matrix_wrapper_on_cpu_is_its_plain_version():
    packed, sees = _sees("forked")
    mt = packed.member_table.copy()
    mt[0, 0] = sees.shape[0] + 40                # clipped to n - 1, still valid
    stake = np.arange(1, packed.n_members + 1, dtype=np.int32)
    args = (torch.from_numpy(sees), torch.from_numpy(mt), torch.from_numpy(stake))
    before = kernels.ssm_matrix.launches
    got = kernels.ssm_matrix(*args, tot_stake=int(stake.sum()))
    want = kernels.ssm_matrix_reference(*args, tot_stake=int(stake.sum()))
    assert torch.equal(got, want)
    # CPU tensors take the plain version, which launches nothing
    assert kernels.ssm_matrix.launches == before


def test_ssm_matrix_rejects_bad_inputs():
    sees = torch.zeros((8, 8), dtype=torch.bool)
    mt = torch.zeros((2, 3), dtype=torch.int32)
    stake = torch.ones((2,), dtype=torch.int32)
    with pytest.raises(TypeError):
        kernels.ssm_matrix(sees.to(torch.uint8), mt, stake, tot_stake=2)
    with pytest.raises(TypeError):
        kernels.ssm_matrix(sees, mt.long(), stake, tot_stake=2)
    with pytest.raises(ValueError):
        kernels.ssm_matrix(sees[:, :7], mt, stake, tot_stake=2)
    with pytest.raises(ValueError):
        kernels.ssm_matrix(sees, mt, stake[:1], tot_stake=2)
    with pytest.raises(ValueError):
        kernels.ssm_matrix(sees, mt[:, :0], stake, tot_stake=2)


# ------------------------------------------------------ rounds and fame


def _slab_inputs(kind):
    """Padded per-event arrays and the reference's full ssm on a sees slab."""
    packed, sees = _sees(kind)
    n_pad = sees.shape[0]
    pad = n_pad - packed.n
    parents = np.concatenate([packed.parents, np.full((pad, 2), -1, np.int32)])
    creator = np.concatenate([packed.creator, np.zeros((pad,), np.int32)])
    coin = np.concatenate([packed.coin, np.zeros((pad,), packed.coin.dtype)])
    tot = int(packed.stake.sum())
    ssm = np.array(ref.ssm_matrix(
        jnp.asarray(sees), jnp.asarray(packed.member_table),
        jnp.asarray(packed.stake), tot, jnp.float32,
    ))
    return packed, sees, ssm, parents, creator, coin, tot


@pytest.mark.parametrize("kind,r_max,s_max,overflow", [
    ("plain", 32, None, 0), ("forked", 32, None, 0),
    ("plain", 2, None, pipeline.OVF_ROUND), ("forked", 32, 2, pipeline.OVF_SLOT),
])
def test_rounds_scan_matches_reference(kind, r_max, s_max, overflow):
    packed, _sees_np, ssm, parents, creator, _coin, tot = _slab_inputs(kind)
    s_max = s_max or packed.n_members + 1
    has_forks = bool(len(packed.fork_pairs))
    want = ref.rounds_scan(
        jnp.asarray(parents), jnp.asarray(ssm), jnp.asarray(creator),
        jnp.asarray(packed.stake), tot, jnp.asarray(packed.n, dtype=jnp.int32),
        r_max=r_max, s_max=s_max, has_forks=has_forks,
    )
    got = pipeline.rounds_scan(
        torch.from_numpy(parents), torch.from_numpy(ssm),
        torch.from_numpy(creator), torch.from_numpy(packed.stake), tot,
        packed.n, r_max=r_max, s_max=s_max, has_forks=has_forks,
    )
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy().reshape(np.shape(w)), np.asarray(w))
    assert int(got[4]) == overflow


@pytest.mark.parametrize("kind", ["plain", "forked"])
def test_fame_scan_full_matrix_matches_reference(kind):
    packed, sees, ssm, parents, creator, coin, tot = _slab_inputs(kind)
    has_forks = bool(len(packed.fork_pairs))
    s_max = packed.n_members + 3
    rnd, _w, tab, _c, ovf = ref.rounds_scan(
        jnp.asarray(parents), jnp.asarray(ssm), jnp.asarray(creator),
        jnp.asarray(packed.stake), tot, jnp.asarray(packed.n, dtype=jnp.int32),
        r_max=32, s_max=s_max, has_forks=has_forks,
    )
    assert int(ovf) == 0
    tab = np.array(tab)[: int(np.max(rnd)) + 3]
    cfg = RefConfig(n_members=packed.n_members)
    want = ref.fame_scan(
        jnp.asarray(tab), jnp.asarray(sees), jnp.asarray(ssm),
        jnp.asarray(creator), jnp.asarray(coin), jnp.asarray(packed.stake),
        tot, cfg.coin_period, jnp.float32, has_forks=has_forks,
    )
    got = pipeline.fame_scan(
        torch.from_numpy(tab), torch.from_numpy(sees), torch.from_numpy(ssm),
        torch.from_numpy(creator), torch.from_numpy(coin),
        torch.from_numpy(packed.stake), tot, cfg.coin_period,
        has_forks=has_forks,
    )
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert (got[0] == 1).any()                   # fame is decided somewhere


@pytest.mark.parametrize("forkers", [0, 2])
def test_consensus_body_matches_consensus_arrays(forkers):
    if forkers:
        sim = run_with_forkers(7, 2, 260, seed=9)
    else:
        sim = make_simulation(5, seed=17)
        sim.run(250)
    node = sim.nodes[0]
    packed = pack_node(node)
    arrays, statics, _ts = ref.prepare_inputs(
        packed, node.config, block=64, matmul_dtype_name="float32"
    )
    statics["r_max"] = ref._bucket(statics["chain"] + 1, 32)
    want = ref.consensus_arrays(
        *(jnp.asarray(arrays[k]) for k in (
            "parents", "creator", "t_rank", "coin", "stake", "fork_pairs",
            "member_table", "n_valid",
        )),
        **statics,
    )
    kw = {k: v for k, v in statics.items() if k != "matmul_dtype_name"}
    got = pipeline.consensus_body(
        *(torch.from_numpy(np.ascontiguousarray(arrays[k])) for k in (
            "parents", "creator", "t_rank", "coin", "stake", "fork_pairs",
            "member_table",
        )),
        int(arrays["n_valid"]), **kw,
    )
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key].numpy()
        assert np.array_equal(g.reshape(np.shape(w)), np.asarray(w)), key
    assert (got["round_received"] >= 0).any()


# ------------------------------------------------------ run_consensus


def _sim_case(n_nodes, turns, seed, config=None):
    sim = make_simulation(n_nodes, seed=seed, config=config)
    sim.run(turns)
    node = sim.nodes[0]
    return node, pack_node(node)


def _gossip_case(n_members, n_events, seed, **kw):
    members, stake, events, keys = generate_gossip_dag(n_members, n_events, seed=seed, **kw)
    node = Node(
        sk=keys[0][1], pk=members[0], network={}, members=members,
        clock=lambda: 0, create_genesis=False,
    )
    node.consensus_pass([ev.id for ev in events if node.add_event(ev)])
    return node, pack_events(events, members, stake)


def _forkers_case():
    node = run_with_forkers(7, 2, 260, seed=9).nodes[0]
    return node, pack_node(node)


def _dense_two_member_case():
    sim = make_simulation(2, seed=0)
    for t in range(400):
        sim.step(t % 2)
    node = sim.nodes[0]
    return node, pack_node(node)


def _huge_stake_case():
    big = 1 << 23
    cfg = RefConfig(n_members=4, stake=(big, big, big, big), seed=2)
    return _sim_case(4, 200, 2, config=cfg)


# name -> (builder, run_consensus kwargs, heals expected)
CASES = {
    "sim": (lambda: _sim_case(5, 250, 17), {"block": 64}, False),
    "forkers": (_forkers_case, {"block": 64}, False),
    "round_clamp_heal": (
        lambda: _sim_case(5, 320, 4, RefConfig(n_members=5, stake=(3, 2, 2, 1, 1), seed=4)),
        {"block": 64, "r_max": 4}, True,
    ),
    "fork_storm_slot_heal": (
        lambda: _gossip_case(8, 500, 4, n_forkers=3, fork_prob=0.4),
        {"block": 64, "s_max": 9}, True,
    ),
    "huge_stake": (_huge_stake_case, {"block": 64}, False),
    "dense_two_member": (_dense_two_member_case, {}, False),
}
_CASE_CACHE = {}


def _case(name):
    if name not in _CASE_CACHE:
        _CASE_CACHE[name] = CASES[name][0]()
    return _CASE_CACHE[name]


@pytest.mark.parametrize("mode", [{"ssm_mode": "full"}, {"use_pallas_ssm": True}],
                         ids=["full", "pallas"])
@pytest.mark.parametrize("name", list(CASES))
def test_run_consensus_full_parity(name, mode):
    node, packed = _case(name)
    _build, kw, heals = CASES[name]
    want, got = run_both(packed, node.config, **kw, **mode)
    assert got.timings["overflow_retries"] == want.timings["overflow_retries"]
    assert (got.timings["overflow_retries"] >= 1) == heals
    assert_parity(node, carry_across(packed), got)
    # three forkers of eight exceed the 3f bound: that order halts, rightly
    assert (len(got.order) > 0) == (name != "fork_storm_slot_heal")
    calls = got.timings["stage_calls"]
    assert calls["pipeline.ssm_matrix_stage"] == got.timings["overflow_retries"] + 1
    assert calls["pipeline.fame_order_stage"] == 1
    assert "pipeline.ssm_block_stage" not in calls
    if name == "huge_stake":
        assert int(packed.stake.sum()) >= (1 << 24)   # the exact fame tally


def test_full_mode_equals_columns_mode():
    node, packed = _sim_case(6, 300, 19)
    carried = carry_across(packed)
    cfg = port_config(node.config)
    full = pipeline.run_consensus(carried, cfg, block=64, ssm_mode="full", device="cpu")
    cols = pipeline.run_consensus(carried, cfg, block=64, ssm_mode="columns", device="cpu")
    assert_same(full, cols)
    assert_parity(node, carried, full)


def test_mode_validation():
    members, stake, events, _keys = generate_gossip_dag(4, 40, seed=1)
    packed = carry_across(pack_events(events, members, stake))
    with pytest.raises(ValueError):
        pipeline.run_consensus(packed, ssm_mode="colums", device="cpu")
    with pytest.raises(NotImplementedError):
        pipeline.run_consensus(
            packed, ssm_mode="columns", use_pallas_ssm=True, device="cpu"
        )
    with pytest.raises(NotImplementedError):
        pipeline.run_consensus(packed, mesh=object(), ssm_mode="full", device="cpu")
