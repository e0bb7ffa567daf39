"""The port's meshes over several processes (``tpu_swirld_torch.parallel``'s
``GroupMesh`` / ``init_group``, ``tpu_swirld_torch.multichip``): the
launcher and its command line on gloo groups of CPU ranks, what they refuse,
groups side by side, and a one-rank group in the test process.  The batch path and the
row-sharded block over 2 and 4 ranks are in
``tests/test_torch_multichip_group.py``.  The command line prints the
reference's ``dryrun_multichip`` line, exactly."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import __graft_entry__
from tpu_swirld.packing import pack_node
from tpu_swirld.sim import make_simulation
from tpu_swirld.tpu import pipeline as ref
from tpu_swirld_torch import multichip, parallel
from tpu_swirld_torch.checkpoint import save_packed
from tpu_swirld_torch.gpu.pipeline import run_consensus
from tests.test_torch_pipeline import assert_same, carry_across, port_config

ROOT = Path(__file__).resolve().parents[1]


def _node(members, seed, turns, node_i):
    sim = make_simulation(members, seed=seed)
    sim.run(turns)
    return sim.nodes[node_i]


def test_cli_dryrun_matches_reference_line(capsys):
    __graft_entry__.dryrun_multichip(2)
    want = capsys.readouterr().out.strip()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_swirld_torch.multichip", "2", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == want
    assert want.startswith("dryrun_multichip ok: 2-device mesh")


def raise_on_rank_one(mesh) -> dict:
    """A rank task (importable by name, as the launcher sends tasks): rank
    1 raises while the others wait in an all-reduce for its part."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails before its all-reduce")
    parallel._psum(mesh, [torch.ones(4, dtype=torch.int32)])
    return {"digest": "unreachable"}


def test_cli_exits_nonzero_when_ranks_outlast_its_timeout():
    """The ranks cannot finish the dryrun in half a second: the launcher
    stops them and the command exits 1 with no result line."""
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_swirld_torch.multichip", "2", "--device", "cpu",
         "--timeout", "0.5"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1
    assert "dryrun_multichip failed" in proc.stderr and "did not finish" in proc.stderr
    assert "dryrun_multichip ok" not in proc.stdout


def test_launcher_fails_a_group_when_one_rank_raises():
    """Rank 1 raises while rank 0 waits in a collective: the launcher stops
    rank 0 and raises with rank 1's error."""
    with pytest.raises(multichip.RankFailure, match="rank 1 fails before its all-reduce"):
        multichip.launch(raise_on_rank_one, 2, device="cpu", backend="gloo", timeout=120)


def test_launcher_fails_ranks_that_outlast_its_timeout():
    with pytest.raises(multichip.RankFailure, match="did not finish"):
        multichip.launch(multichip.dryrun_rank, 2, device="cpu", backend="gloo",
                         timeout=0.5)


def test_group_mesh_refusals(tmp_path):
    store = str(tmp_path / "store")
    with pytest.raises(ValueError, match="backend"):
        parallel.init_group(0, 1, store, backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        parallel.init_group(0, 1, store, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="outside"):
        parallel.init_group(2, 2, store, backend="gloo", device="cpu")
    if not torch.cuda.is_available():
        # resolved before the group is joined: no GPU, no group
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.init_group(0, 1, store, backend="gloo")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multichip.launch(multichip.dryrun_rank, 2, backend="gloo")
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_group"):
        parallel.make_group_mesh(1, device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        multichip.launch(multichip.dryrun_rank, 2, device="cpu", backend="nccl")
    mesh = parallel.GroupMesh(0, 2, torch.device("cpu"), "gloo")
    assert mesh.local_shards == (0,) and mesh.axis_names == (parallel.MEMBER_AXIS,)
    # the streaming driver over a group is the group driver (no collective
    # runs before the first ingest)
    inc = parallel.MeshStreamingConsensus(mesh, [b"a", b"b"], device="cpu")
    try:
        assert type(inc) is parallel.GroupStreamingConsensus
        assert inc.store.n_shards == 2 and inc._window_bucket % 2 == 0
    finally:
        inc.store.close()
    # the one-process mesh is unchanged: every shard local, a plain sum
    one = parallel.make_mesh(2, device="cpu")
    assert one.local_shards == (0, 1)
    parts = [torch.ones(3, dtype=torch.int32), torch.full((3,), 2, dtype=torch.int32)]
    assert torch.equal(parallel._psum(one, parts), torch.full((3,), 3, dtype=torch.int32))


def test_group_of_one_rank_in_process(tmp_path):
    """A one-rank gloo group in this process: ``_psum`` is an all-reduce of
    the rank's own part (the identity), in its dtype; the batch path over
    it equals the one-process mesh's."""
    mesh = parallel.init_group(0, 1, str(tmp_path / "store"), backend="gloo",
                               device="cpu", timeout=60)
    try:
        assert str(mesh) == "rank 0 of a 1-rank gloo group on cpu"
        for dtype in (torch.int8, torch.int32):
            part = torch.arange(6, dtype=dtype)
            got = parallel._psum(mesh, [part.clone()])
            assert got.dtype == dtype and torch.equal(got, part)
        assert (mesh.traffic.calls, mesh.traffic.bytes) == (2, 6 + 6 * 4)
        with pytest.raises(ValueError, match="a mesh of 2 shards over a group of 1"):
            parallel.make_group_mesh(2, device="cpu")
        node = _node(5, 31, 250, 1)
        packed = carry_across(pack_node(node))
        path = str(tmp_path / "packed.npz")
        save_packed(path, packed)
        got = multichip.batch_rank(mesh, path, port_config(node.config), 64)
        assert_same(ref.run_consensus(pack_node(node), node.config, block=64), got["result"])
        one = run_consensus(packed, port_config(node.config), block=64,
                            mesh=parallel.make_mesh(1, "cpu"), device="cpu")
        assert_same(one, got["result"])
    finally:
        torch.distributed.destroy_process_group()


def test_groups_side_by_side():
    """Two groups started at once, each with its own file store, both
    reach the reference's dryrun (``start`` / ``RankGroup.wait``, as
    ``chip_smoke.py`` runs its groups)."""
    groups = [multichip.start(multichip.dryrun_rank, world, device="cpu", backend="gloo",
                              timeout=120) for world in (2, 1)]
    reports = [g.wait() for g in groups]
    assert [len(r) for r in reports] == [2, 1]
    # both dryruns run the reference's 4-member simulation
    a, b = ({k: v for k, v in r[0]["result"].items() if k != "timings"} for r in reports)
    assert a == b and a["ordered"] > 0


@pytest.mark.slow
def test_group_of_eight_ranks_matches_reference():
    """The reference's ``dryrun_multichip(8)`` on eight ranks (slow: eight
    spawned processes): 8 members, parity with the oracle on every rank."""
    reports = multichip.launch(multichip.dryrun_rank, 8, device="cpu", backend="gloo",
                               timeout=600)
    assert len({rep["result"]["digest"] for rep in reports}) == 1
