"""The port's int32 stake envelope, ``3 * tot_stake <= INT32_MAX``, on the
CPU.  Inside it every stake tally fits int32 and the port equals the JAX
reference and the oracle exactly; outside it (where the reference's int32
``3 * acc`` wraps, or its total overflows) the port raises ``ValueError``
wherever a total is formed: ``run_consensus`` on both strongly-sees modes,
the three drivers' constructors, and the kernel wrappers that take
``tot_stake``.

The DAG: four members, ``make_simulation(4, seed=2)`` run for 200 turns at
the largest stake inside the envelope (one oracle run, cached); the cases
outside it carry the same DAG across with the stake replaced."""

import functools

import numpy as np
import pytest
import torch

from tpu_swirld.config import SwirldConfig as RefConfig
from tpu_swirld.packing import pack_node
from tpu_swirld.sim import make_simulation
from tpu_swirld.tpu import pipeline as ref
from tpu_swirld_torch import (
    IncrementalConsensus, MeshStreamingConsensus, StreamingConsensus, make_mesh,
)
from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.gpu import kernels, pipeline
from tpu_swirld_torch.packing import packed_from_arrays
from tpu_swirld_torch.parallel import make_row_sharded_block_fn
from tests.test_pipeline import assert_parity
from tests.test_torch_pipeline import assert_same

EDGE = 178_956_970              # 4 * 3 * EDGE = 2_147_483_640 <= INT32_MAX
OUTSIDE = (178_956_971, 200_000_000, 1 << 29)
MODES = {"columns": {}, "full": {"ssm_mode": "full"}}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def edge_node():
    """The oracle node of the four-member simulation at stake ``EDGE``."""
    cfg = RefConfig(n_members=4, stake=(EDGE,) * 4, seed=2)
    sim = make_simulation(4, seed=2, config=cfg)
    sim.run(200)
    return sim.nodes[0]


def port_packed(packed, stake):
    return packed_from_arrays(
        packed.n_members, packed.parents, packed.creator, packed.seq, packed.t,
        packed.coin, np.full(packed.n_members, stake, np.int32),
        packed.fork_pairs, packed.member_table, packed.ids, packed.sigs,
    )


def port_config(stake):
    return SwirldConfig(n_members=4, stake=(stake,) * 4, seed=2)


def test_envelope_bound():
    assert 3 * 4 * EDGE <= kernels.INT32_MAX < 3 * 4 * OUTSIDE[0]
    assert kernels.check_stake_envelope(kernels.INT32_MAX // 3) == kernels.INT32_MAX // 3
    with pytest.raises(ValueError, match="int32 stake envelope"):
        kernels.check_stake_envelope(kernels.INT32_MAX // 3 + 1)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_edge_of_envelope_equals_reference_and_oracle(mode):
    node = edge_node()
    packed = pack_node(node)
    want = ref.run_consensus(packed, node.config, block=64, **MODES[mode])
    got = pipeline.run_consensus(
        port_packed(packed, EDGE), port_config(EDGE), block=64, device="cpu",
        **MODES[mode],
    )
    assert_same(want, got)
    assert_parity(node, port_packed(packed, EDGE), got)
    assert len(got.order) > 0


def _run_consensus(mode, stake):
    pipeline.run_consensus(
        port_packed(pack_node(edge_node()), stake), port_config(stake),
        block=64, device="cpu", **MODES[mode],
    )


def _driver(cls, stake):
    args = ([b"m0", b"m1", b"m2", b"m3"], [stake] * 4, port_config(stake))
    if cls is MeshStreamingConsensus:
        cls(make_mesh(2, device="cpu"), *args, device="cpu")
    else:
        cls(*args, device="cpu")


def _kernel_args(stake):
    gen = np.random.default_rng(0)
    sees = torch.as_tensor(gen.random((16, 16)) < 0.5)
    mt = torch.as_tensor(gen.integers(-1, 16, (4, 5)).astype(np.int32))
    return sees, mt, torch.full((4,), stake, dtype=torch.int32)


def _ssm_block(stake):
    sees, mt, st = _kernel_args(stake)
    cols = torch.arange(8, dtype=torch.int32)
    kernels.ssm_block(sees, mt, st, cols, 0, rows=8, tot_stake=4 * stake)


def _ssm_matrix(stake):
    sees, mt, st = _kernel_args(stake)
    kernels.ssm_matrix(sees, mt, st, tot_stake=4 * stake)


def _row_sharded_block(stake):
    sees, mt, st = _kernel_args(stake)
    cols = torch.arange(8, dtype=torch.int32)
    block = make_row_sharded_block_fn(make_mesh(2, device="cpu"))
    block(sees, mt, st, cols, 0, rows=8, tot_stake=4 * stake)


ENTRY_POINTS = {
    "run_consensus columns": functools.partial(_run_consensus, "columns"),
    "run_consensus full": functools.partial(_run_consensus, "full"),
    "IncrementalConsensus": functools.partial(_driver, IncrementalConsensus),
    "StreamingConsensus": functools.partial(_driver, StreamingConsensus),
    "MeshStreamingConsensus": functools.partial(_driver, MeshStreamingConsensus),
    "ssm_block": _ssm_block,
    "ssm_matrix": _ssm_matrix,
    "row-sharded block": _row_sharded_block,
}


@pytest.mark.parametrize("stake", OUTSIDE)
@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_outside_envelope_raises(entry, stake):
    with pytest.raises(ValueError, match="int32 stake envelope"):
        ENTRY_POINTS[entry](stake)


@pytest.mark.parametrize("entry", ["ssm_block", "ssm_matrix", "row-sharded block",
                                   "IncrementalConsensus"])
def test_edge_of_envelope_is_accepted(entry):
    ENTRY_POINTS[entry](EDGE)
