"""The port's checkpoints (``tpu_swirld_torch.checkpoint``) on the CPU: the
packed and node round trips, the packed handoff into the incremental
driver, the horizon digest and the epoch ledger refusing a tampered
header, and the format shared with the reference's ``tpu_swirld.checkpoint``
(a checkpoint written by either package loads in the other, with equal
headers, byte-equal event logs and equal state digests).  A restored
``backend="tpu"`` node replays through ``TorchEngine`` on the device it is
given, equal to the oracle, and raises without a card."""

import dataclasses
import json
import struct

import numpy as np
import pytest
import torch

from tpu_swirld import checkpoint as ref_ckpt
from tpu_swirld import crypto as ref_crypto
from tpu_swirld.membership.sim import churn_schedule as ref_churn_schedule
from tpu_swirld.packing import pack_node as ref_pack_node
from tpu_swirld.sim import make_simulation as ref_make_simulation
from tpu_swirld_torch import (
    DynamicNode, IncrementalConsensus, Node, TorchEngine, crypto,
    load_node, load_packed, save_node, save_packed,
)
from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.gpu.pipeline import run_consensus
from tpu_swirld_torch.membership import EpochLedger, MemberEpoch
from tpu_swirld_torch.membership.sim import churn_schedule
from tpu_swirld_torch.packing import pack_node
from tpu_swirld_torch.sim import generate_gossip_dag, make_simulation

STATE = ("consensus", "round", "is_witness", "famous", "round_received",
         "consensus_ts", "wit_list", "consensus_round", "transactions",
         "_frozen_round")
PACKED_FIELDS = ("parents", "creator", "seq", "t", "coin", "stake",
                 "fork_pairs", "member_table")


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


def _split(path):
    """``(parsed header, event log bytes)`` of a node checkpoint."""
    with open(path, "rb") as f:
        data = f.read()
    (hlen,) = struct.unpack_from("<I", data, 4)
    return json.loads(data[8 : 8 + hlen].decode()), data[8 + hlen:]


def _rewrite(path, meta, log):
    header = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(b"SWCK" + struct.pack("<I", len(header)) + header + log)


def _assert_state(got, want):
    for key in STATE:
        assert getattr(got, key) == getattr(want, key), key


def _assert_same_result(want, got):
    assert np.array_equal(got.round, want.round)
    assert np.array_equal(got.is_witness, want.is_witness)
    assert got.famous == want.famous
    assert np.array_equal(got.round_received, want.round_received)
    assert np.array_equal(got.consensus_ts, want.consensus_ts)
    assert got.order == want.order
    assert got.max_round == want.max_round


def test_packed_checkpoint_roundtrip(tmp_path):
    sim = make_simulation(4, seed=3)
    sim.run(100)
    packed = pack_node(sim.nodes[0])
    p = str(tmp_path / "dag.npz")
    save_packed(p, packed)
    got = load_packed(p)
    for field in PACKED_FIELDS:
        assert np.array_equal(getattr(got, field), getattr(packed, field)), field
    assert (got.n, got.n_members) == (packed.n, packed.n_members)
    assert got.ids == packed.ids
    assert got.sigs == packed.sigs


def test_node_checkpoint_resume_and_continue(tmp_path):
    sim = make_simulation(4, seed=8)
    sim.run(150)
    node = sim.nodes[1]
    p = str(tmp_path / "node.swck")
    save_node(p, node)
    restored = load_node(
        p, sk=node.sk, pk=node.pk, network=sim.network,
        network_want={m: n.ask_events for m, n in zip(sim.members, sim.nodes)},
        device="cpu",
    )
    assert type(restored) is Node
    _assert_state(restored, node)
    assert restored.state_digest() == node.state_digest()
    assert set(restored.restore_seconds) == {"replay", "pass"}
    # the restored node keeps working: gossip + consensus continue
    peer = next(m for m in sim.members if m != node.pk)
    new_ids = restored.sync(peer, b"resumed")
    restored.consensus_pass(new_ids)
    assert restored.head in restored.hg


def test_checkpoint_packed_roundtrip_into_incremental_pipeline(tmp_path):
    members, stake, events, _keys = generate_gossip_dag(6, 400, seed=9)
    cfg = SwirldConfig(n_members=6)
    inc = IncrementalConsensus(
        members, stake, cfg, block=64, chunk=64, window_bucket=256,
        prune_min=64, device="cpu",
    )
    for i in range(0, len(events), 80):
        inc.ingest(events[i : i + 80])
    path = str(tmp_path / "inc.npz")
    save_packed(path, inc.packer.pack())
    restored = load_packed(path)
    _assert_same_result(inc.result(), run_consensus(restored, cfg, block=64, device="cpu"))


def test_checkpoint_horizon_digest_verified_on_restore(tmp_path):
    sim = make_simulation(3, seed=21)
    sim.run(80)
    node = sim.nodes[0]
    assert len(node.consensus) > 0
    path = str(tmp_path / "n.swck")
    save_node(path, node)
    restored = load_node(path, sk=node.sk, pk=node.pk, network={}, device="cpu")
    assert restored.consensus == node.consensus
    assert restored._frozen_round == node._frozen_round
    meta, log = _split(path)
    meta["order_digest"] = "00" * 32
    _rewrite(path, meta, log)
    with pytest.raises(ValueError, match="diverged"):
        load_node(path, sk=node.sk, pk=node.pk, network={}, device="cpu")
    meta["decided"] = len(node.consensus) + 1
    _rewrite(path, meta, log)
    with pytest.raises(ValueError, match="regressed the horizon"):
        load_node(path, sk=node.sk, pk=node.pk, network={}, device="cpu")
    with open(path, "r+b") as f:
        f.write(b"XXXX")
    with pytest.raises(ValueError, match="not a tpu_swirld checkpoint"):
        load_node(path, sk=node.sk, pk=node.pk, network={}, device="cpu")


def test_checkpoint_epoch_ledger_roundtrip_and_tamper(tmp_path):
    _events, _members, _stake, sim = churn_schedule(4, seed=1, turns=420)
    node = sim.nodes[0]
    assert len(node.ledger.epochs) >= 2
    path = str(tmp_path / "dyn.ckpt")
    save_node(path, node)
    restored = load_node(path, sk=node.sk, pk=node.pk, network={}, device="cpu")
    assert isinstance(restored, DynamicNode)
    assert restored.ledger.same_epochs(node.ledger)
    assert restored.consensus == node.consensus
    assert restored.membership_epoch == node.membership_epoch
    assert restored.state_digest() == node.state_digest()

    # a consistent but wrong ledger re-stamped into the header
    meta, log = _split(path)
    head = node.ledger.head
    forged = EpochLedger(epochs=node.ledger.epochs[:-1] + (MemberEpoch(
        epoch_id=head.epoch_id, activation_round=head.activation_round,
        members=head.members, stake=(99,) + head.stake[1:],
    ),))
    meta["membership"].update(forged.to_meta())
    bad = str(tmp_path / "tampered.ckpt")
    _rewrite(bad, meta, log)
    with pytest.raises(ValueError, match="epoch ledger"):
        load_node(bad, sk=node.sk, pk=node.pk, network={}, device="cpu")
    # an epoch edited without re-stamping the digest
    meta, log = _split(path)
    meta["membership"]["epochs"][-1]["stake"][0] = 99
    _rewrite(bad, meta, log)
    with pytest.raises(ValueError, match="digest mismatch"):
        load_node(bad, sk=node.sk, pk=node.pk, network={}, device="cpu")


# ------------------------------------------------ across the two packages


def _node_pair(kind):
    """The same node (node 0) of a port and a reference simulation at one
    seed: a static ``Node`` or a ``DynamicNode`` past two epoch
    transitions."""
    if kind == "node":
        got, want = make_simulation(4, seed=8), ref_make_simulation(4, seed=8)
        got.run(150)
        want.run(150)
    else:
        got = churn_schedule(4, seed=1, turns=420)[3]
        want = ref_churn_schedule(4, seed=1, turns=420)[3]
    return got.nodes[0], want.nodes[0]


@pytest.mark.parametrize("kind", ["node", "dynamic"])
def test_node_checkpoint_loads_in_either_package(sim_signer, tmp_path, kind):
    got, want = _node_pair(kind)
    assert got.state_digest() == want.state_digest()
    port_path, ref_path = str(tmp_path / "port.swck"), str(tmp_path / "ref.swck")
    save_node(port_path, got)
    ref_ckpt.save_node(ref_path, want)
    (port_meta, port_log), (ref_meta, ref_log) = _split(port_path), _split(ref_path)
    assert port_meta == ref_meta
    assert port_log == ref_log
    if kind == "dynamic":
        assert len(port_meta["membership"]["epochs"]) >= 3
    # a reference checkpoint restored by the port, and the other way round
    mine = load_node(ref_path, sk=got.sk, pk=got.pk, network={}, device="cpu")
    theirs = ref_ckpt.load_node(port_path, sk=want.sk, pk=want.pk, network={})
    assert type(mine) is type(got)
    assert type(theirs) is type(want)
    for node in (mine, theirs):
        assert node.state_digest() == want.state_digest()
        assert node.consensus == want.consensus
    # the header spells the stake out
    assert mine.config == dataclasses.replace(got.config, stake=got.config.stakes())


@pytest.mark.parametrize("direction", ["port to reference", "reference to port"])
def test_packed_checkpoint_loads_in_either_package(sim_signer, tmp_path, direction):
    sim = ref_make_simulation(4, seed=3)
    sim.run(100)
    want = ref_pack_node(sim.nodes[0])
    got = pack_node(sim.nodes[0])
    p = str(tmp_path / "dag.npz")
    if direction == "port to reference":
        save_packed(p, got)
        back = ref_ckpt.load_packed(p)
    else:
        ref_ckpt.save_packed(p, want)
        back = load_packed(p)
    for field in PACKED_FIELDS:
        assert np.array_equal(getattr(back, field), getattr(want, field)), field
    assert back.ids == want.ids and back.sigs == want.sigs


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_python_checkpoint_loads_without_a_device(sim_signer, tmp_path, writer):
    """A ``backend="python"`` checkpoint, written by either package, loads
    through the port's ``load_node`` with no ``device=`` on a host without
    a GPU, to the state the reference's ``load_node`` restores."""
    got, want = _node_pair("node")
    p = str(tmp_path / "python.swck")
    (save_node if writer == "port" else ref_ckpt.save_node)(
        p, got if writer == "port" else want)
    mine = load_node(p, sk=got.sk, pk=got.pk, network={})
    theirs = ref_ckpt.load_node(p, sk=want.sk, pk=want.pk, network={})
    assert mine.config.backend == "python" and mine._tpu_engine is None
    assert mine.state_digest() == theirs.state_digest() == want.state_digest()
    assert mine.consensus == theirs.consensus


def test_tpu_node_restores_on_the_given_device(sim_signer, tmp_path):
    sim = make_simulation(4, seed=5)
    sim.run(160)
    node = sim.nodes[2]
    p = str(tmp_path / "tpu.swck")
    save_node(p, node)
    meta, log = _split(p)
    meta["config"]["backend"] = "tpu"
    meta["config"]["tpu_min_batch"] = 10**6     # the flush still computes
    _rewrite(p, meta, log)
    restored = load_node(p, sk=node.sk, pk=node.pk, network={}, device="cpu")
    assert restored.config.backend == "tpu"
    eng = restored._tpu_engine
    assert isinstance(eng, TorchEngine) and eng.device == torch.device("cpu")
    assert eng.last_result is not None and eng.last_result.n == len(node.order_added)
    _assert_state(restored, node)
    assert restored.state_digest() == node.state_digest()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_node(p, sk=node.sk, pk=node.pk, network={})
