"""The shard-tally step of the row-sharded strongly-sees block on the CPU:
``kernels.ssm_tally`` (whose CPU tensors take ``ssm_tally_reference``)
against a member-by-member ``bmm_or_reference`` loop written out here, and
the ``pallas=True`` block route ``kernels.make_mesh_row_block_fn`` against
the JAX reference's ``tpu_swirld.parallel.make_row_sharded_block_fn`` on the
8-device host platform of ``tests/conftest.py``.  Tolerance: exact equality
(int32 tallies and bool outputs).

The reference's own Pallas route, ``tpu_swirld.tpu.pallas_kernels.
make_mesh_row_block_fn(mesh, interpret=True)``, does not run on that
platform: inside its ``shard_map`` the interpret-mode ``bmm_or_pallas``
raises ``ValueError`` (``check_vma`` wants a ``vma`` on the kernel's output
shape), and the reference's tests never run it.  The block route is
therefore compared with the reference's XLA route, which its contract makes
bit-identical to the Pallas one."""

import numpy as np
import pytest
import torch

from tpu_swirld import parallel as ref_parallel
from tpu_swirld_torch import parallel
from tpu_swirld_torch.gpu import kernels
from tests.test_torch_mesh import _block_inputs
from tests.test_torch_store import torch_threads

N_LOC, N, M, K, C, ROWS = 24, 48, 5, 40, 9, 12     # K > 32: two words a member


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with torch_threads(1):
        yield


def _shard_inputs(seed):
    rng = np.random.default_rng(seed)
    sees = rng.random((N_LOC, N)) < 0.35
    mt = rng.integers(-1, N + 3, size=(M, K)).astype(np.int32)   # -1 and clipped slots
    mt[1] = -1                                                   # an empty member
    stake = rng.integers(1, 6, size=(M,)).astype(np.int32)      # non-uniform
    b = rng.random((M * K, C)) < 0.08
    return [torch.as_tensor(x) for x in (sees, mt, stake, b)]


def _member_loop(sees, mt, stake, b, row_lo, rows):
    """The shard's tally as the block's member loop computes it: per member
    one ``bmm_or_reference`` hop of the owned rows, times its stake."""
    n_loc, n = sees.shape
    acc = torch.zeros((rows, b.shape[1]), dtype=torch.int32)
    for m in range(mt.shape[0]):
        a = torch.zeros((rows, mt.shape[1]), dtype=torch.bool)
        for i in range(rows):
            if 0 <= row_lo + i < n_loc:
                a[i] = sees[row_lo + i, mt[m].clamp(0, n - 1)] & (mt[m] >= 0)
        hit = kernels.bmm_or_reference(a, b[m * mt.shape[1] : (m + 1) * mt.shape[1]])
        acc += hit.to(torch.int32) * stake[m]
    return acc


@pytest.mark.parametrize(
    "row_lo",
    [-ROWS - 4, -ROWS, -5, 0, 7, N_LOC - ROWS, N_LOC - 3, N_LOC, N_LOC + 4],
)
def test_ssm_tally_matches_member_loop(row_lo):
    sees, mt, stake, b = _shard_inputs(3)
    want = _member_loop(sees, mt, stake, b, row_lo, ROWS)
    got_ref = kernels.ssm_tally_reference(sees, mt, stake, b, row_lo, rows=ROWS)
    before = kernels.ssm_tally.launches
    got = kernels.ssm_tally(sees, mt, stake, b, row_lo, rows=ROWS)
    assert torch.equal(got_ref, want) and torch.equal(got, want)
    assert got.dtype == torch.int32 and got.shape == (ROWS, C)
    # CPU tensors take the plain version, which launches nothing
    assert kernels.ssm_tally.launches == before
    owned = [i for i in range(ROWS) if 0 <= row_lo + i < N_LOC]
    assert not got[[i for i in range(ROWS) if i not in owned]].any()
    if owned:
        assert got[owned].any()


def test_ssm_tally_rejects_bad_inputs():
    sees, mt, stake, b = _shard_inputs(4)
    with pytest.raises(TypeError):
        kernels.ssm_tally(sees, mt.long(), stake, b, 0, rows=4)
    with pytest.raises(TypeError):
        kernels.ssm_tally(sees, mt, stake, b.to(torch.int8), 0, rows=4)
    with pytest.raises(ValueError, match="M \\* K"):
        kernels.ssm_tally(sees, mt, stake, b[:-1], 0, rows=4)
    with pytest.raises(ValueError, match="disagree on M"):
        kernels.ssm_tally(sees, mt, stake[:-1], b, 0, rows=4)
    with pytest.raises(ValueError, match="empty"):
        kernels.ssm_tally(sees, mt, stake, b, 0, rows=0)


@pytest.mark.parametrize("d", [2, 4])
def test_mesh_row_block_route_matches_reference(d):
    import jax.numpy as jnp

    n, m, k, c, rows = 256, 6, 8, 64, 64
    sees, mt, stake, cols = _block_inputs(10 + d, n, m, k, c)
    tot = int(stake.sum())
    fn = kernels.make_mesh_row_block_fn(parallel.make_mesh(d, device="cpu"))
    ref_fn = ref_parallel.make_row_sharded_block_fn(ref_parallel.make_mesh(d))
    t = [torch.as_tensor(x) for x in (sees, mt, stake, cols)]
    for row0 in (0, 96, n - rows - 1, n - rows, n - 10, -5):
        want = np.asarray(ref_fn(
            jnp.asarray(sees), jnp.asarray(mt), jnp.asarray(stake),
            jnp.asarray(cols), np.int32(row0), rows=rows, tot_stake=tot,
            matmul_dtype_name="float32",
        ))
        assert want.any() and not want.all()
        got = fn(*t, row0, rows=rows, tot_stake=tot)
        assert np.array_equal(got.numpy(), want), row0


@pytest.mark.parametrize(
    "row0, rows, owners",
    [(40, 32, 2), (0, 32, 1), (96, 32, 1), (30, 4, 2), (0, 128, 4)],
)
def test_mesh_row_block_route_calls_one_tally_per_owning_shard(
    monkeypatch, row0, rows, owners
):
    """The ``pallas=True`` route runs one shard-tally step for each shard
    that owns a row of the block (at most D a block) and no ``bmm_or``;
    the ``bmm`` route keeps the reference's M x D hops."""
    n, m, k, c, d = 128, 5, 4, 16, 4
    sees, mt, stake, cols = _block_inputs(1, n, m, k, c)
    t = [torch.as_tensor(x) for x in (sees, mt, stake, cols)]
    tot = int(stake.sum())
    calls = {"ssm_tally": [], "bmm_or": 0}
    tally, bmm_or = kernels.ssm_tally, kernels.bmm_or

    def tally_spy(sees_shard, *args, rows):
        calls["ssm_tally"].append(args[-1])
        return tally(sees_shard, *args, rows=rows)

    def bmm_spy(a, b):
        calls["bmm_or"] += 1
        return bmm_or(a, b)

    monkeypatch.setattr(kernels, "ssm_tally", tally_spy)
    monkeypatch.setattr(kernels, "bmm_or", bmm_spy)
    launches = (tally.launches, bmm_or.launches)
    mesh = parallel.make_mesh(d, device="cpu")
    got = kernels.make_mesh_row_block_fn(mesh)(*t, row0, rows=rows, tot_stake=tot)
    assert len(calls["ssm_tally"]) == owners <= d
    # each call's row_lo leaves at least one of its rows inside the shard
    assert all(-rows < lo < n // d for lo in calls["ssm_tally"])
    assert calls["bmm_or"] == 0
    assert (tally.launches, bmm_or.launches) == launches    # the CPU launches nothing
    single = kernels.ssm_block(*t, row0, rows=rows, tot_stake=tot)
    assert torch.equal(got, single)
    hops = []
    via_bmm = parallel.make_row_sharded_block_fn(
        mesh, bmm=lambda a, b: hops.append(1) or kernels.bmm_or_reference(a, b)
    )(*t, row0, rows=rows, tot_stake=tot)
    assert len(hops) == m * d and torch.equal(via_bmm, single)
