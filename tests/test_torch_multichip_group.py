"""The port's member-sharded batch path and row-sharded block over gloo
groups of 2 and 4 CPU ranks (``tpu_swirld_torch.parallel.GroupMesh``,
spawned by ``tpu_swirld_torch.multichip.launch``), against the JAX
reference's mesh on the 8-device host platform of ``tests/conftest.py`` and
against the oracle.  Tolerance: exact equality everywhere.

Each group runs the settings of ``tests/test_parallel.py`` (8 members,
member padding, sharded equal to unsharded, the overflow self-heal, the
incremental driver over the member-sharded block) and the row-sharded block
at ``tests/test_mesh_stream.py:227``'s inputs, each rank holding only its
own rows, all in one group session.  The packed DAGs and the block's inputs
reach the ranks as ``.npz`` files; every rank must return the same digest
(the launcher checks it) and the same result."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_swirld import parallel as ref_parallel
from tpu_swirld.packing import pack_node
from tpu_swirld.tpu import pipeline as ref
from tpu_swirld_torch import multichip
from tpu_swirld_torch.checkpoint import save_packed
from tpu_swirld_torch.gpu import kernels
from tests.test_pipeline import assert_parity
from tests.test_torch_incremental import port_events
from tests.test_torch_mesh import _block_inputs
from tests.test_torch_multichip import _node
from tests.test_torch_pipeline import assert_same, carry_across, port_config

# tests/test_parallel.py's batch settings: (members, seed, turns, node)
BATCH = {
    "8 members": (8, 21, 400, 0),              # :15
    "member padding": (6, 13, 300, 2),         # :27, 6 members on 4 ranks
    "sharded == unsharded": (5, 31, 250, 1),   # :39
}
HEAL = "sharded == unsharded"                  # run again with s_max=2
INC = (6, 19, 300, 0)                          # :71, ingests of 80
BLOCK = dict(n=512, m=6, k=8, c=64, rows=128)  # tests/test_mesh_stream.py:227
ROW0S = (0, 96, 512 - 128, 512 - 10, -5)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The reference's DAGs and block inputs, saved for the ranks."""
    tmp = tmp_path_factory.mktemp("group-inputs")
    batch = {}
    for name, (members, seed, turns, node_i) in BATCH.items():
        node = _node(members, seed, turns, node_i)
        packed = pack_node(node)
        path = str(tmp / f"{name.replace(' ', '_')}.npz")
        save_packed(path, carry_across(packed))
        batch[name] = (node, packed, path)
    inc_node = _node(*INC)
    sees, mt, stake, cols = _block_inputs(0, BLOCK["n"], BLOCK["m"], BLOCK["k"], BLOCK["c"])
    block_path = str(tmp / "block.npz")
    np.savez(block_path, sees=sees, member_table=mt, stake=stake, cols=cols)
    return {"batch": batch, "inc": inc_node, "block": (sees, mt, stake, cols),
            "block_path": block_path}


def _tasks(inputs):
    tasks = [
        (multichip.batch_rank, (path, port_config(node.config), 64))
        for node, _packed, path in inputs["batch"].values()
    ]
    node, _packed, path = inputs["batch"][HEAL]
    tasks.append((multichip.batch_rank, (path, port_config(node.config), 64, 2)))
    node = inputs["inc"]
    tasks.append((multichip.incremental_rank, (
        list(node.members), [node.stake[m] for m in node.members],
        port_config(node.config), port_events([node.hg[e] for e in node.order_added]),
        80, dict(block=64, chunk=64, window_bucket=256, prune_min=64),
    )))
    tasks.append((multichip.row_block_rank, (inputs["block_path"], ROW0S, BLOCK["rows"])))
    return tasks


@pytest.fixture(scope="module", params=[2, 4], ids=lambda d: f"{d} ranks")
def group(request, inputs):
    """Every task of :func:`_tasks` in one gloo group of ``d`` CPU ranks:
    ``(d, per-rank reports)``."""
    d = request.param
    reports = multichip.launch(multichip.tasks_rank, d, args=(_tasks(inputs),),
                               device="cpu", backend="gloo", timeout=300)
    assert len(reports) == d
    for rep in reports:
        assert rep["backend"] == "gloo" and rep["device"] == "cpu"
        # on the CPU the wrappers take their plain versions: nothing launched
        assert set(rep["launches"].values()) == {0}
    return d, reports


def _results(reports, i):
    """Task ``i``'s result on every rank, all equal (beyond the digest the
    launcher compared)."""
    outs = [rep["result"]["results"][i] for rep in reports]
    for out in outs[1:]:
        assert out["digest"] == outs[0]["digest"]
    return outs


@pytest.mark.parametrize("name", list(BATCH))
def test_group_batch_matches_reference_and_oracle(group, inputs, name):
    d, reports = group
    node, packed, _path = inputs["batch"][name]
    want = ref.run_consensus(packed, node.config, block=64, mesh=ref_parallel.make_mesh(d))
    for out in _results(reports, list(BATCH).index(name)):
        got = out["result"]
        assert_same(want, got)
        assert_parity(node, carry_across(packed), got)
        assert len(got.order) > 0
        assert out["timings"]["overflow_retries"] == 0
        assert "pipeline.mesh_consensus" in out["timings"]["stage_seconds"]
    if name == "sharded == unsharded":
        assert_same(ref.run_consensus(packed, node.config, block=64), got)


def test_group_batch_self_heals_like_reference(group, inputs):
    d, reports = group
    _node_, packed, _path = inputs["batch"][HEAL]
    want = ref.run_consensus(packed, block=64, s_max=2, mesh=ref_parallel.make_mesh(d))
    retries = want.timings["overflow_retries"]
    assert retries > 0
    for out in _results(reports, len(BATCH)):
        assert_same(want, out["result"])
        # every rank healed in the same steps: each overflow flag is reduced
        assert out["timings"]["overflow_retries"] == retries


def test_group_incremental_block_matches_batch(group, inputs):
    _d, reports = group
    node = inputs["inc"]
    want = ref.run_consensus(pack_node(node), node.config, block=64)
    for out in _results(reports, len(BATCH) + 1):
        res = out["result"]
        assert res.order == want.order and len(res.order) > 0
        assert res.famous == want.famous
        assert np.array_equal(res.round, want.round)
        assert np.array_equal(res.round_received, want.round_received)


def test_group_row_block_matches_reference_and_ssm_block(group, inputs):
    d, reports = group
    sees, mt, stake, cols = inputs["block"]
    tot = int(stake.sum())
    rows = BLOCK["rows"]
    ref_fn = ref_parallel.make_row_sharded_block_fn(ref_parallel.make_mesh(d))
    t = [torch.as_tensor(x) for x in (sees, mt, stake, cols)]
    outs = _results(reports, len(BATCH) + 2)
    n_loc = BLOCK["n"] // d
    assert [out["shard_rows"] for out in outs] == [(r * n_loc, (r + 1) * n_loc)
                                                    for r in range(d)]
    for row0 in ROW0S:
        want = np.asarray(ref_fn(
            jnp.asarray(sees), jnp.asarray(mt), jnp.asarray(stake), jnp.asarray(cols),
            np.int32(row0), rows=rows, tot_stake=tot, matmul_dtype_name="float32",
        ))
        assert want.any() and not want.all()
        for out in outs:
            for route in ("row_sharded", "mesh_row_block"):
                assert np.array_equal(out["blocks"][(route, row0)], want), (route, row0)
        if row0 >= 0:   # a negative start clips to 0 here, counts from the end there
            single = kernels.ssm_block(*t, row0, rows=rows, tot_stake=tot)
            assert np.array_equal(single.numpy(), want), row0
