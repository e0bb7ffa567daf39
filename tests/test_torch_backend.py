"""``TorchEngine``, the ``backend="tpu"`` engine of a live node (on the CPU,
plain kernel versions): bound to a reference node or inside the port's own
simulation, a node's state equals an oracle replay of its DAG exactly, with
and without ``mesh_shape``; lazy batching and ``flush()``; and a ``"tpu"``
node never falls back to the oracle when there is no card."""

import dataclasses

import pytest
import torch

from tpu_swirld import crypto as ref_crypto
from tpu_swirld.oracle.node import Node as RefNode
from tpu_swirld.sim import make_simulation as ref_make_simulation
from tpu_swirld_torch import Mesh, Node, TorchEngine, crypto
from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.sim import make_simulation

STATE = ("consensus", "round", "is_witness", "famous", "round_received",
         "consensus_ts", "wit_list", "consensus_round", "transactions")


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


def _torch_node(sim, i, **cfg):
    """Node ``i`` of ``sim`` on the ``"tpu"`` backend with a CPU engine."""
    node = sim.nodes[i]
    node.config = dataclasses.replace(
        node.config, backend="tpu", block_size=128, **cfg
    )
    node._tpu_engine = TorchEngine(node, device="cpu")
    return node


def _replay(node, node_cls):
    """A fresh oracle node of ``node_cls`` fed ``node``'s whole DAG in one
    consensus pass."""
    replay = node_cls(
        sk=node.sk, pk=node.pk, network={}, members=node.members,
        clock=lambda: 0, create_genesis=False,
    )
    new_ids = [e for e in node.order_added if replay.add_event(node.hg[e])]
    replay.consensus_pass(new_ids)
    return replay


def _assert_state(got, want):
    for key in STATE:
        assert getattr(got, key) == getattr(want, key), key


def _assert_prefix(a, b):
    m = min(len(a.consensus), len(b.consensus))
    assert m > 0
    assert a.consensus[:m] == b.consensus[:m]


def test_engine_on_a_reference_node_matches_oracle_replay():
    sim = ref_make_simulation(4, seed=3)
    node = _torch_node(sim, 1)
    sim.run(150)
    assert isinstance(node._tpu_engine, TorchEngine)
    assert node._tpu_engine.last_result is not None
    assert len(node.consensus) > 0
    _assert_prefix(node, sim.nodes[0])
    for eid in node.order_added:
        assert eid in node.round and eid in node.is_witness
    _assert_state(node, _replay(node, RefNode))


def test_engine_in_the_port_simulation_matches_reference_simulation(sim_signer):
    got = make_simulation(4, seed=3)
    node = _torch_node(got, 1)
    want = ref_make_simulation(4, seed=3)
    got.run(150)
    want.run(150)
    # the same DAG at every node; the torch node's state is the oracle's
    for a, b in zip(got.nodes, want.nodes):
        assert a.order_added == b.order_added
        assert a.state_digest() == b.state_digest()
    _assert_state(node, want.nodes[1])
    _assert_state(node, _replay(node, Node))


def test_lazy_batching_and_flush(sim_signer):
    sim = make_simulation(4, seed=9)
    node = _torch_node(sim, 1, tpu_min_batch=40)
    sim.run(120)
    eng = node._tpu_engine
    # the engine genuinely lags the store
    assert eng._n_consumed < len(node.order_added)
    eng.flush()
    assert eng._n_consumed == len(node.order_added)
    eng.flush()          # up to date: a no-op
    _assert_prefix(node, sim.nodes[0])
    _assert_state(node, _replay(node, Node))


def test_mesh_shape_node(sim_signer):
    sim = make_simulation(4, seed=5)
    node = _torch_node(sim, 2, mesh_shape={"members": 4})
    mesh = node._tpu_engine.mesh
    assert isinstance(mesh, Mesh) and mesh.size == 4
    assert mesh.device == torch.device("cpu")
    sim.run(100)
    assert "pipeline.mesh_consensus" in node._tpu_engine.last_result.timings["stage_seconds"]
    _assert_prefix(node, sim.nodes[3])
    _assert_state(node, _replay(node, Node))


def test_tpu_node_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    sim = make_simulation(4, seed=1, config=SwirldConfig(n_members=4, backend="tpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.step(0)
    assert sim.nodes[0]._tpu_engine is None
    assert sim.nodes[0].consensus == []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchEngine(sim.nodes[1])


@pytest.mark.slow
@pytest.mark.parametrize("label", ["columns node", "mesh_shape node"])
def test_live_golden_digests_match_reference(sim_signer, label):
    """Recompute chip_smoke.LIVE_GOLDEN: the reference's simulation gossips
    as chip_smoke.gossip_until drives the port's, with every pass switched
    off (a pass changes no gossip), then the JAX reference's
    ``run_consensus`` on node 0's DAG.  The port's simulation, as
    chip_smoke.live_simulation sets it up (engines on the CPU here, never
    reaching their batch), gossips the same DAG in the same turns."""
    import chip_smoke
    from tpu_swirld.packing import pack_node
    from tpu_swirld.tpu.pipeline import run_consensus

    n_events, _min_batch, mesh_shape = chip_smoke.LIVE_NODES[label]
    want = ref_make_simulation(chip_smoke.N_MEMBERS, seed=chip_smoke.LIVE_SEED)
    for node in want.nodes:
        node.consensus_pass = lambda new_ids: None
    turns = chip_smoke.gossip_until(want, n_events)
    node = want.nodes[0]
    packed = pack_node(node)
    digests = chip_smoke.result_digests(packed, run_consensus(packed, node.config))
    golden = chip_smoke.LIVE_GOLDEN[label]
    assert {"turns": turns, "events": packed.n, **digests} == golden

    got = chip_smoke.live_simulation(chip_smoke.N_MEMBERS, 2**62, mesh_shape)
    for peer in got.nodes:
        peer._tpu_engine = TorchEngine(peer, device="cpu")
    assert chip_smoke.gossip_until(got, n_events) == turns
    assert got.nodes[0].order_added == node.order_added
