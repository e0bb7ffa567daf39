"""The port's oracle ``Node``, gossip simulation and wire codec against the
reference's: the same seed under the simulation signer in both packages
gives the same events in the same order and the same node state, digests
included; an event encoded by either package decodes in the other to the
same bytes; forged and malformed gossip is refused exactly as the
reference refuses it."""

import struct

import pytest

from tpu_swirld import crypto as ref_crypto
from tpu_swirld.oracle import event as ref_event
from tpu_swirld.oracle import graph as ref_graph
from tpu_swirld.sim import make_simulation as ref_make_simulation
from tpu_swirld_torch import crypto
from tpu_swirld_torch import event
from tpu_swirld_torch.oracle.graph import bfs, dfs, toposort
from tpu_swirld_torch.sim import make_simulation


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


@pytest.mark.parametrize("n_nodes,turns,seed", [(5, 250, 7), (4, 300, 11)])
def test_simulation_matches_reference(sim_signer, n_nodes, turns, seed):
    want = ref_make_simulation(n_nodes, seed=seed)
    got = make_simulation(n_nodes, seed=seed)
    want.run(turns)
    got.run(turns)
    assert got.members == want.members
    for a, b in zip(got.nodes, want.nodes):
        assert a.order_added == b.order_added
        assert a.state_digest() == b.state_digest()
        assert a.consensus == b.consensus
        assert a.round == b.round
        assert a.famous == b.famous
        assert a.wit_list == b.wit_list
        assert a.consensus_ts == b.consensus_ts
        assert a.transactions == b.transactions
    assert min(len(n.consensus) for n in got.nodes) > 0


def test_wire_codec_round_trips_across_packages(sim_signer):
    sim = ref_make_simulation(4, seed=5)
    sim.run(40)
    node = sim.nodes[0]
    for eid in node.order_added:
        ev = node.hg[eid]
        blob = ref_event.encode_event(ev)
        got, off = event.decode_event(blob + b"tail")
        assert off == len(blob)
        assert got.id == eid and got.verify()
        assert event.encode_event(got) == blob
        back, _ = ref_event.decode_event(event.encode_event(got))
        assert back == ev
    assert (event.MAX_PAYLOAD, event.MAX_KEY) == (ref_event.MAX_PAYLOAD, ref_event.MAX_KEY)
    blob = ref_event.encode_event(node.hg[node.order_added[-1]])
    for bad in [blob[:-1], blob[:3], struct.pack("<I", 2**31) + blob[4:],
                struct.pack("<I", 10) + b"\x07" + b"x" * 9, blob[:4] + b"\xff" + blob[5:]]:
        with pytest.raises(event.MalformedEvent):
            event.decode_event(bad)
        with pytest.raises(ref_event.MalformedEvent):
            ref_event.decode_event(bad)


def test_ask_sync_rejects_a_blob_signed_by_another_key(sim_signer):
    sim = make_simulation(4, seed=2)
    sim.run(20)
    a, b, c = sim.nodes[:3]
    hv = b"".join(len(b.member_events[m]).to_bytes(4, "little") for m in b.members)
    forged = hv + crypto.sign(hv, c.sk, crypto.DOMAIN_SYNC_REQ)
    before = a.bad_requests
    with pytest.raises(ValueError):
        a.ask_sync(b.pk, forged)
    assert a.bad_requests == before + 1
    # the same request signed by the claimed key is served
    honest = hv + crypto.sign(hv, b.sk, crypto.DOMAIN_SYNC_REQ)
    assert len(a.ask_sync(b.pk, honest)) >= crypto.SIG_BYTES


def test_malformed_signed_reply_is_counted_not_raised(sim_signer):
    sim = make_simulation(4, seed=2)
    sim.run(20)
    a, b = sim.nodes[:2]
    blob = event.encode_event(b.hg[b.head])[:-1]     # truncated signature
    reply = blob + crypto.sign(blob, b.sk, crypto.DOMAIN_SYNC_REPLY)
    sim.network[b.pk] = lambda src, req: reply
    before, n_events = a.bad_replies, len(a.hg)
    assert a.pull(b.pk) == []
    assert a.bad_replies == before + 1
    assert len(a.hg) == n_events
    # a reply signed by another key is refused the same way
    good = event.encode_event(b.hg[b.head])
    sim.network[b.pk] = lambda src, req: good + crypto.sign(
        good, a.sk, crypto.DOMAIN_SYNC_REPLY)
    assert a.pull(b.pk) == []
    assert a.bad_replies == before + 2


def test_graph_utilities_match_reference():
    succ = {1: [2, 3], 2: [4], 3: [4, 5], 4: [], 5: [2]}
    parents = {1: [], 2: [1, 5], 3: [1], 4: [2, 3], 5: [3]}
    for nodes in ([4, 3, 2, 1, 5], [1, 2, 3, 4, 5], [5, 4]):
        assert list(bfs(nodes, succ.__getitem__)) == list(ref_graph.bfs(nodes, succ.__getitem__))
        assert list(dfs(nodes, succ.__getitem__)) == list(ref_graph.dfs(nodes, succ.__getitem__))
        got = toposort(nodes, parents.__getitem__)
        assert got == ref_graph.toposort(nodes, parents.__getitem__)
        assert all(got.index(p) < got.index(x) for x in got for p in parents[x] if p in got)
    with pytest.raises(ValueError):
        toposort([1, 2], {1: [2], 2: [1]}.__getitem__)
