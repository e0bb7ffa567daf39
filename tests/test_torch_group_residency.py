"""``dev/group_residency.py --widen``'s measurement on the CPU at a small
size (8 members, 1 000 events, ``tests/test_torch_store.py``'s driver
sizes): the stale sync of ``events[100]`` after five ingests of 200,
through the one-process driver, the one-process mesh and a gloo group of
2 ranks.  Each widens once, with the one process's digest; a rank hands
its collectives the widening's bytes and keeps its ``widen_slabs``
record; the host peaks are counted and the device peaks are ``None``.
Imports no JAX."""

from tpu_swirld_torch import crypto, multichip
from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.dev import group_residency as gr
from tpu_swirld_torch.packing import pack_events
from tpu_swirld_torch.parallel import MeshStreamingConsensus, make_mesh
from tpu_swirld_torch.sim import generate_gossip_dag
from tpu_swirld_torch.store import StreamingConsensus

KW = dict(chunk=64, window_bucket=256, prune_min=64, ingest_chunk=256)


def test_widen_measurement_on_cpu():
    prev = crypto.backend_name()
    crypto.set_backend("sim")       # as the script signs
    try:
        members, stake, events, keys = generate_gossip_dag(8, 1000, seed=11)
        stale = gr.stale_sync(events, keys)
    finally:
        crypto.set_backend(prev)
    chunks = [events[i : i + 200] for i in range(0, len(events), 200)]
    cfg = SwirldConfig(n_members=8)
    packed = pack_events(events + [stale], members, stake)
    one = gr.widen_one(lambda: StreamingConsensus(members, stake, cfg, device="cpu", **KW),
                       chunks, stale, packed)
    mesh = gr.widen_one(lambda: MeshStreamingConsensus(make_mesh(2, "cpu"), members, stake,
                                                       cfg, device="cpu", **KW),
                        chunks, stale, packed)
    reports = multichip.launch(gr.widen_rank, 2,
                               args=(members, stake, cfg, chunks, stale, KW),
                               device="cpu", backend="gloo", timeout=300)
    ranks = [rep["result"] for rep in reports]
    for r in [one, mesh] + ranks:
        assert r["digest"] == one["digest"]
        assert r["widened"] and r["widen_rebases"] == 1 and r["full_rebases"] == 1
        assert (r["lo_before"], r["w_pad_before"], r["w_pad"]) == (878, 512, 1280)
        assert 0 < r["widen_host_peak"] <= r["ingest_host_peak"]
        assert r["widen_device_peak"] is None and r["ingest_device_peak"] is None
    assert one["widen_slabs"] is None and one["widen_bytes"] == 0
    for r in ranks:
        (rec,) = r["widen_slabs"]
        assert rec["delta"] == 778 and r["widen_bytes"] == rec["bytes"] > 0
        assert r["widen_host_peak"] < one["widen_host_peak"]
