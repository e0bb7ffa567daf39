"""The port's row-sharded mesh streaming (``tpu_swirld_torch.parallel``,
meshes of 2 and 4 shards on the CPU) against the JAX reference's
``tpu_swirld.parallel`` on the 8-device host platform of
``tests/conftest.py``.  Tolerance: exact equality everywhere.

The block function alone equals the single-device ``ssm_block`` and the
reference's ``make_row_sharded_block_fn``.  ``MeshStreamingConsensus(
pallas=True, device="cpu")`` (the CUDA ``bmm_or`` route; on the CPU its plain
version) runs in lockstep with the reference's ``MeshStreamingConsensus`` at
``pallas=False`` (bit-identical to its Pallas route by the reference's own
contract): stats, carried state, archive and ``store.stats()`` after every
ingest, the schedules of ``tests/test_mesh_stream.py``."""

import numpy as np
import pytest
import torch

from tpu_swirld import parallel as ref_parallel
from tpu_swirld.config import SwirldConfig as RefConfig
from tpu_swirld.sim import generate_gossip_dag
from tpu_swirld.store.slab import TileBudgetExceeded as RefBudgetExceeded
from tpu_swirld_torch import parallel
from tpu_swirld_torch.gpu import kernels
from tpu_swirld_torch.store import TileBudgetExceeded
from tests.test_torch_incremental import port_events
from tests.test_torch_store import (
    assert_batch_parity, fixed_chunks, lockstep, port_config, stale_event,
    torch_threads,
)

KW = dict(chunk=64, window_bucket=256, prune_min=64, ingest_chunk=256)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with torch_threads(1):
        yield


def mesh_drivers(d, members, stake, cfg, *, hop=None, **kw):
    """The reference's mesh driver over its first ``d`` devices and the
    port's over ``d`` CPU shards with the ``pallas=True`` route (or the
    member hop ``hop``)."""
    kw = {**KW, **kw}
    want = ref_parallel.MeshStreamingConsensus(
        ref_parallel.make_mesh(d), members, stake, cfg, **kw
    )
    port_kw = {"bmm": hop} if hop is not None else {"pallas": True}
    got = parallel.MeshStreamingConsensus(
        parallel.make_mesh(d, device="cpu"), members, stake, port_config(cfg),
        device="cpu", **port_kw, **kw,
    )
    return want, got


def assert_same_mesh_stats(want, got, d):
    assert got.store.stats()["n_shards"] == d
    for k in ("n_shards", "device_resident_tiles", "peak_device_tiles",
              "resident_tiles", "peak_resident_tiles"):
        assert got.store.stats()[k] == want.store.stats()[k], k
    assert got._window_bucket == want._window_bucket
    assert got._w_pad % d == 0
    assert got.repins == 0


# ------------------------------------------------------------ block alone


def _block_inputs(seed, n, m, k, c):
    rng = np.random.default_rng(seed)
    sees = rng.random((n, n)) < 0.3
    mt = rng.integers(-1, n, size=(m, k)).astype(np.int32)
    stake = rng.integers(1, 6, size=(m,)).astype(np.int32)     # non-uniform
    cols = rng.integers(-1, n, size=(c,)).astype(np.int32)
    cols[:3] = -1                                               # pad columns
    return sees, mt, stake, cols


@pytest.mark.parametrize("d", [2, 4])
def test_row_sharded_block_matches_single_device_and_reference(d):
    import jax.numpy as jnp

    n, m, k, c, rows = 256, 6, 8, 64, 64
    sees, mt, stake, cols = _block_inputs(d, n, m, k, c)
    tot = int(stake.sum())
    mesh = parallel.make_mesh(d, device="cpu")
    fns = {
        "row_sharded": parallel.make_row_sharded_block_fn(mesh),
        "mesh_row_block": kernels.make_mesh_row_block_fn(mesh),
    }
    assert parallel.make_row_sharded_block_fn(mesh) is fns["row_sharded"]
    ref_fn = ref_parallel.make_row_sharded_block_fn(ref_parallel.make_mesh(d))
    t = [torch.as_tensor(x) for x in (sees, mt, stake, cols)]
    for row0 in (0, 96, n - rows - 1, n - rows, n - 10, -5):
        want = np.asarray(ref_fn(
            jnp.asarray(sees), jnp.asarray(mt), jnp.asarray(stake),
            jnp.asarray(cols), np.int32(row0), rows=rows, tot_stake=tot,
            matmul_dtype_name="float32",
        ))
        assert want.any() and not want.all()
        for name, fn in fns.items():
            got = fn(*t, row0, rows=rows, tot_stake=tot)
            assert np.array_equal(got.numpy(), want), (name, row0)
        if row0 >= 0:   # a negative start clips to 0 here, counts from the end there
            single = kernels.ssm_block(*t, row0, rows=rows, tot_stake=tot)
            assert np.array_equal(single.numpy(), want), row0


def test_row_sharded_block_hop_calls_and_refusals():
    n, m, k, c, rows = 128, 5, 4, 16, 32
    sees, mt, stake, cols = _block_inputs(0, n, m, k, c)
    t = [torch.as_tensor(x) for x in (sees, mt, stake, cols)]
    calls = []

    def hop(a, b):
        assert a.is_contiguous() and b.is_contiguous()
        calls.append((tuple(a.shape), tuple(b.shape)))
        return kernels.bmm_or(a, b)

    fn = parallel.make_row_sharded_block_fn(parallel.make_mesh(4, device="cpu"), bmm=hop)
    out = fn(*t, 40, rows=rows, tot_stake=int(stake.sum()))
    assert calls == [((rows, k), (k, c))] * (m * 4)            # M x D hops
    assert np.array_equal(
        out.numpy(), kernels.ssm_block(*t, 40, rows=rows, tot_stake=int(stake.sum())).numpy()
    )
    with pytest.raises(ValueError, match="does not split"):
        parallel.make_row_sharded_block_fn(parallel.make_mesh(3, device="cpu"))(
            *t, 0, rows=rows, tot_stake=1
        )


def test_mesh_over_several_devices_raises():
    with pytest.raises(ValueError, match="ROADMAP A8"):
        parallel.Mesh((torch.device("cuda", 0), torch.device("cuda", 1)))
    with pytest.raises(ValueError):
        parallel.make_mesh(0, device="cpu")
    mesh = parallel.make_mesh(2, device="cpu")
    assert mesh.size == 2 and mesh.device == torch.device("cpu")
    assert str(mesh) == "2 shards on one device (cpu)"
    mt, st = parallel.pad_members(np.zeros((3, 2), np.int32), np.ones(3, np.int32), 4)
    rmt, rst = ref_parallel.pad_members(np.zeros((3, 2), np.int32), np.ones(3, np.int32), 4)
    assert np.array_equal(mt, rmt) and np.array_equal(st, rst)


# ------------------------------------------------------- driver lockstep


@pytest.mark.parametrize("d", [2, 4])
def test_mesh_smoke_row_sharded(d):
    members, stake, events, _keys = generate_gossip_dag(6, 300, seed=9)
    cfg = RefConfig(n_members=6)
    hop_calls = []

    def hop(a, b):
        hop_calls.append(1)
        return kernels.bmm_or(a, b)

    want, got = mesh_drivers(d, members, stake, cfg, hop=hop, ingest_chunk=128)
    for chunk in fixed_chunks(events, 100):
        lockstep(want, got, [chunk])
        assert_same_mesh_stats(want, got, d)
    st = got.ingest([])
    assert st["mesh_devices"] == d and st["mesh_repins"] == 0
    # every strongly-sees block (rebase column adds included) ran M x D hops
    assert len(hop_calls) == 6 * d * got.stages.calls["pipeline.ssm_block_stage"] > 0
    assert_batch_parity(got, events, members, stake, cfg)


def test_mesh_streaming_widening_rebase():
    members, stake, events, keys = generate_gossip_dag(8, 1000, seed=11)
    cfg = RefConfig(n_members=8)
    want, got = mesh_drivers(2, members, stake, cfg)
    lockstep(want, got, fixed_chunks(events, 200))
    assert got.pruned_prefix > 400
    strag = stale_event(events, keys, 3, 100, b"stale-sync")
    full_before = got.full_rebases
    lockstep(want, got, [[strag]])
    assert got.widen_rebases == 1 and got.full_rebases == full_before
    assert got.store.archive.fetched_rows > 0
    assert_same_mesh_stats(want, got, 2)
    assert_batch_parity(got, events + [strag], members, stake, cfg)


def test_mesh_streaming_forks_materialize_sees():
    members, stake, events, _keys = generate_gossip_dag(8, 700, seed=4, n_forkers=2)
    cfg = RefConfig(n_members=8)
    want, got = mesh_drivers(4, members, stake, cfg, window_bucket=512,
                             prune_min=128)
    lockstep(want, got, fixed_chunks(events, 250))
    assert got._sees_d is not got._anc_d
    assert_same_mesh_stats(want, got, 4)
    assert_batch_parity(got, events, members, stake, cfg)


def test_mesh_window_bucket_rounds_to_mesh_multiple():
    members, stake, events, _keys = generate_gossip_dag(6, 200, seed=2)
    cfg = RefConfig(n_members=6)
    want, got = mesh_drivers(4, members, stake, cfg, chunk=32, window_bucket=258,
                             ingest_chunk=128)
    assert got._window_bucket == want._window_bucket == 260
    lockstep(want, got, [events])
    assert got._w_pad % 4 == 0
    assert_same_mesh_stats(want, got, 4)


def test_mesh_device_tile_budget_strict_raises():
    members, stake, events, _keys = generate_gossip_dag(8, 600, seed=7)
    cfg = RefConfig(n_members=8)
    want, got = mesh_drivers(2, members, stake, cfg, ingest_chunk=128,
                             device_tile_budget=1, strict_budget=True)
    for chunk in fixed_chunks(events, 100):
        try:
            want.ingest(chunk)
        except RefBudgetExceeded:
            with pytest.raises(TileBudgetExceeded, match="2 shards"):
                got.ingest(port_events(chunk))
            assert got.store.budget_overruns == want.store.budget_overruns == 1
            return
        got.ingest(port_events(chunk))
    pytest.fail("the reference never exceeded its shard budget")


def test_mesh_driver_must_run_on_the_mesh_device():
    mesh = parallel.Mesh((torch.device("meta"),) * 2)
    with pytest.raises(ValueError, match="mesh's shards"):
        parallel.MeshStreamingConsensus(mesh, [b"a", b"b"], device="cpu")
