"""The port's ``viz`` (``tpu_swirld_torch.viz``): the reference's viz tests
(``tests/test_aux.py``'s backend agreement, ``tests/test_obs.py``'s fame
gauges) run on the port, then every rendering held to the reference's on
the same simulation.  The comparisons are exact (rows, strings, gauge
values); the batch result comes from the port's ``run_consensus`` on
``device="cpu"``, and ``chip_smoke.py`` phase 16(c) makes it on the card.
"""

import json

import pytest
import torch

from tpu_swirld import crypto as ref_crypto
from tpu_swirld import viz as ref_viz
from tpu_swirld.obs.registry import Registry as RefRegistry
from tpu_swirld.sim import make_simulation as ref_make_simulation
from tpu_swirld_torch import crypto, viz
from tpu_swirld_torch.gpu.pipeline import run_consensus
from tpu_swirld_torch.obs.registry import Registry
from tpu_swirld_torch.packing import pack_node
from tpu_swirld_torch.sim import make_simulation


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tiny ops: torch's CPU thread pool costs far more than it saves here
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def sim_signer():
    """Both packages on the simulation signer, restored afterwards."""
    prev = ref_crypto.backend_name(), crypto.backend_name()
    ref_crypto.set_backend("sim")
    crypto.set_backend("sim")
    yield
    ref_crypto.set_backend(prev[0])
    crypto.set_backend(prev[1])


def _node(mod_make_simulation, turns):
    sim = mod_make_simulation(4, seed=5)
    sim.run(turns)
    return sim.nodes[0]


def test_viz_exports_agree_across_backends():
    node = _node(make_simulation, 150)
    packed = pack_node(node)
    result = run_consensus(packed, node.config, block=64, device="cpu")
    a = viz.export_state(node=node)
    b = viz.export_state(packed=packed, result=result)
    assert a == b
    assert any(r["order"] is not None for r in a)
    s = viz.to_json(node=node)
    assert json.loads(s)[0]["creator"] == 0
    assert json.loads(viz.to_json(packed=packed, result=result)) == a
    dot = viz.to_dot(node=node)
    assert dot.startswith("digraph") and "->" in dot
    lanes = viz.ascii_lanes(node=node)
    assert "m0" in lanes and "height" in lanes
    with pytest.raises(ValueError):
        viz.export_state(packed=packed)


def test_viz_fame_gauges_annotate_and_register():
    node = _node(make_simulation, 100)
    reg = Registry()
    lanes = viz.ascii_lanes(node=node, registry=reg)
    assert "fame decided/witnesses per round:" in lanes
    dot = viz.to_dot(node=node)
    assert dot.startswith("digraph")
    assert "fame per round:" in dot
    rows = viz.export_state(node=node)
    gauges = viz.fame_gauges(rows)
    wit_rounds = {r["round"] for r in rows if r["witness"]}
    assert set(gauges) == wit_rounds
    r0_decided = sum(
        1 for r in rows
        if r["witness"] and r["round"] == 0 and r["famous"] is not None
    )
    assert gauges[0][0] == r0_decided
    assert reg.value("round_fame_decided", {"round": "0"}) == r0_decided


def test_viz_outputs_match_reference(tmp_path, sim_signer):
    """``make_simulation(4, seed=5)``, 150 turns, in both packages: the same
    rows, the same JSON, DOT and lanes strings, the same fame gauges and
    registry values (Prometheus text byte-equal), and the port's card-path
    export (its batch result) equal to the reference's node export."""
    node, ref_node = _node(make_simulation, 150), _node(ref_make_simulation, 150)
    assert node.state_digest() == ref_node.state_digest()
    rows = viz.export_state(node=node)
    assert rows == ref_viz.export_state(node=ref_node)
    packed = pack_node(node)
    result = run_consensus(packed, node.config, block=64, device="cpu")
    assert viz.export_state(packed=packed, result=result) == rows
    got_path, want_path = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    assert viz.to_json(path=got_path, node=node) == ref_viz.to_json(path=want_path, node=ref_node)
    assert open(got_path, "rb").read() == open(want_path, "rb").read()
    reg, ref_reg = Registry(), RefRegistry()
    assert viz.to_dot(registry=reg, node=node) == ref_viz.to_dot(registry=ref_reg, node=ref_node)
    for max_height in (24, 6):
        assert viz.ascii_lanes(max_height=max_height, node=node) == \
            ref_viz.ascii_lanes(max_height=max_height, node=ref_node)
    assert viz.fame_gauges(rows) == ref_viz.fame_gauges(rows)
    assert reg.to_prometheus_text() == ref_reg.to_prometheus_text()
    assert reg.to_dict() == ref_reg.to_dict()
    assert len(reg.collect("round_fame_decided")) == len(viz.fame_gauges(rows)) > 1
