"""The port's member-sharded batch path (``tpu_swirld_torch.parallel``:
``ssm_matrix_sharded``, ``make_ssm_block_fn_for_mesh``,
``consensus_fn_for_mesh`` and ``run_consensus(mesh=)``, meshes of 1-8
shards on the CPU) against the JAX reference's ``tpu_swirld.parallel`` on
the 8-device host platform of ``tests/conftest.py``, padding included.
Tolerance: exact equality everywhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_swirld import parallel as ref_parallel
from tpu_swirld.packing import pack_events, pack_node
from tpu_swirld.sim import generate_gossip_dag, make_simulation
from tpu_swirld.tpu import pipeline as ref
from tpu_swirld_torch import parallel
from tpu_swirld_torch.gpu import kernels, pipeline
from tpu_swirld_torch.gpu.incremental import IncrementalConsensus
from tests.test_pipeline import assert_parity
from tests.test_torch_incremental import port_events
from tests.test_torch_mesh import _block_inputs
from tests.test_torch_pipeline import assert_same, carry_across, port_config


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tiny ops: torch's CPU thread pool costs far more than it saves here
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sees_of(n_members, n_events, seed):
    """The fork-aware sees slab of a forked gossip DAG (the reference's
    visibility stage) and its member table."""
    members, stake, events, _keys = generate_gossip_dag(
        n_members, n_events, seed=seed, n_forkers=1, fork_prob=0.2
    )
    packed = pack_events(events, members, stake)
    _anc, sees = ref.visibility_stage(
        jnp.asarray(packed.parents), jnp.asarray(packed.creator),
        jnp.asarray(packed.fork_pairs), n_members=n_members, block=packed.n,
        matmul_dtype_name="float32",
    )
    return np.array(sees), packed.member_table


@pytest.mark.parametrize("n_members,d", [(8, 1), (8, 2), (8, 4), (8, 8), (6, 4), (6, 8)])
def test_ssm_matrix_sharded_matches_reference(n_members, d):
    sees, mt = _sees_of(n_members, 160, seed=n_members + d)
    stake = np.random.default_rng(d).integers(1, 6, n_members).astype(np.int32)
    tot = int(stake.sum())
    want = np.asarray(ref.ssm_matrix(
        jnp.asarray(sees), jnp.asarray(mt), jnp.asarray(stake), tot, jnp.float32
    ))
    assert want.any() and not want.all()
    got = parallel.ssm_matrix_sharded(
        torch.as_tensor(sees), torch.as_tensor(mt), torch.as_tensor(stake), tot,
        mesh=parallel.make_mesh(d, device="cpu"),
    )
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    # the member-sharded tally of a padded mesh equals the one-device kernel
    single = kernels.ssm_matrix(
        torch.as_tensor(sees), torch.as_tensor(mt), torch.as_tensor(stake), tot_stake=tot
    )
    assert torch.equal(got, single)


@pytest.mark.parametrize("n_nodes,seed,turns,node_i,d", [
    (8, 21, 400, 0, 8),     # tests/test_parallel.py:14
    (6, 13, 300, 2, 4),     # :26, 6 members padded to 8
    (5, 31, 250, 1, 8),     # :39, sharded == unsharded
    (5, 31, 250, 1, 2),
    (6, 13, 300, 2, 1),
])
def test_run_consensus_mesh_matches_reference(n_nodes, seed, turns, node_i, d):
    sim = make_simulation(n_nodes, seed=seed)
    sim.run(turns)
    node = sim.nodes[node_i]
    packed = pack_node(node)
    want = ref.run_consensus(
        packed, node.config, block=64, mesh=ref_parallel.make_mesh(d)
    )
    carried = carry_across(packed)
    got = pipeline.run_consensus(
        carried, port_config(node.config), block=64,
        mesh=parallel.make_mesh(d, device="cpu"), device="cpu",
    )
    assert_same(want, got)
    assert_parity(node, carried, got)
    assert len(got.order) > 0
    assert got.timings["overflow_retries"] == 0
    assert "pipeline.mesh_consensus" in got.timings["stage_seconds"]
    unsharded = pipeline.run_consensus(carried, port_config(node.config), block=64,
                                       device="cpu")
    assert_same(unsharded, got)


def test_run_consensus_mesh_self_heals_like_reference():
    """An under-provisioned slot capacity grows inside the mesh path's
    overflow loop, as in the reference."""
    sim = make_simulation(5, seed=31)
    sim.run(250)
    packed = pack_node(sim.nodes[1])
    want = ref.run_consensus(packed, block=64, s_max=2, mesh=ref_parallel.make_mesh(2))
    got = pipeline.run_consensus(
        carry_across(packed), block=64, s_max=2,
        mesh=parallel.make_mesh(2, device="cpu"), device="cpu",
    )
    assert_same(want, got)
    assert got.timings["overflow_retries"] == want.timings["overflow_retries"] > 0


def test_incremental_with_mesh_block_fn_matches_batch():
    """tests/test_parallel.py:71: the incremental driver over the
    member-sharded block (6 members on 4 shards, padded) equals a batch
    pass."""
    sim = make_simulation(6, seed=19)
    sim.run(300)
    node = sim.nodes[0]
    packed = pack_node(node)
    events = port_events([node.hg[e] for e in node.order_added])
    stake = [node.stake[m] for m in node.members]
    inc = IncrementalConsensus(
        node.members, stake, port_config(node.config), block=64, chunk=64,
        window_bucket=256, prune_min=64, device="cpu",
        ssm_block_fn=parallel.make_ssm_block_fn_for_mesh(
            parallel.make_mesh(4, device="cpu")
        ),
    )
    for i in range(0, len(events), 80):
        inc.ingest(events[i : i + 80])
    res = inc.result()
    want = ref.run_consensus(packed, node.config, block=64)
    assert res.order == want.order and len(res.order) > 0
    assert res.famous == want.famous
    assert np.array_equal(res.round, want.round)
    assert np.array_equal(res.round_received, want.round_received)


@pytest.mark.parametrize("d", [2, 4])
def test_mesh_block_fn_matches_reference_with_late_and_negative_starts(d):
    """The late ``row0`` clamp, and a negative ``row0`` counting from the
    end, as ``lax.dynamic_slice`` takes it in the reference."""
    n, m, k, c, rows = 256, 6, 8, 64, 64
    sees, mt, stake, cols = _block_inputs(d, n, m, k, c)
    tot = int(stake.sum())
    mesh = parallel.make_mesh(d, device="cpu")
    fn = parallel.make_ssm_block_fn_for_mesh(mesh)
    assert parallel.make_ssm_block_fn_for_mesh(parallel.make_mesh(d, device="cpu")) is fn
    ref_fn = ref_parallel.make_ssm_block_fn_for_mesh(ref_parallel.make_mesh(d))
    t = [torch.as_tensor(x) for x in (sees, mt, stake, cols)]
    for row0 in (0, 96, n - rows, n - rows + 1, n - 10, 10**6, -5):
        want = np.asarray(ref_fn(
            jnp.asarray(sees), jnp.asarray(mt), jnp.asarray(stake),
            jnp.asarray(cols), np.int32(row0), rows=rows, tot_stake=tot,
            matmul_dtype_name="float32",
        ))
        assert want.any() and not want.all()
        got = fn(*t, row0, rows=rows, tot_stake=tot)
        assert np.array_equal(got.numpy(), want), row0
        # a negative start counts from the end, as in lax.dynamic_slice
        single = kernels.ssm_block(*t, row0, rows=rows, tot_stake=tot)
        assert torch.equal(got, single), row0


def test_mesh_block_fn_refuses_what_it_cannot_run():
    sees, mt, stake, cols = (torch.as_tensor(x) for x in _block_inputs(0, 64, 4, 4, 8))
    fn = parallel.make_ssm_block_fn_for_mesh(parallel.make_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="outside"):
        fn(sees, mt, stake, cols, 0, rows=65, tot_stake=int(stake.sum()))
    with pytest.raises(ValueError, match="envelope"):
        fn(sees, mt, stake, cols, 0, rows=8, tot_stake=2**30)
    with pytest.raises(ValueError, match="mesh's shards"):
        parallel.ssm_matrix_sharded(
            sees, mt, stake, int(stake.sum()),
            mesh=parallel.Mesh((torch.device("meta"),) * 2),
        )
