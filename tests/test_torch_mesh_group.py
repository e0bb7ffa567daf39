"""The port's streaming driver with its window row-sharded over gloo groups
of 2 and 4 CPU ranks (``tpu_swirld_torch.parallel.GroupStreamingConsensus``,
spawned by ``tpu_swirld_torch.multichip.launch``), in lockstep with the JAX
reference's ``MeshStreamingConsensus`` over as many devices of the 8-device
host platform of ``tests/conftest.py``.  Tolerance: exact equality.

The schedules are ``tests/test_mesh_stream.py``'s: the smoke (:61), the
forked window (:170) and the widening rebase (as ``tests/test_torch_mesh.py``
runs it).  Every rank holds only its ``W / D`` rows of each slab after every
ingest (``multichip.assert_row_sharded``, checked in the rank); every pass's
stats, the result, the archive and the store's accounting equal the
reference's on every rank."""

import pytest

from tpu_swirld import parallel as ref_parallel
from tpu_swirld.config import SwirldConfig as RefConfig
from tpu_swirld.sim import generate_gossip_dag
from tpu_swirld_torch import multichip
from tests.test_torch_incremental import port_events
from tests.test_torch_pipeline import assert_same
from tests.test_torch_store import (
    STORE_VOLATILE, VOLATILE, assert_batch_parity, fixed_chunks, port_config, stale_event,
)

# name -> (generate_gossip_dag args, driver settings, ingest size, pallas)
SCHEDULES = {
    "smoke": ((6, 300, 9, 0), dict(chunk=64, window_bucket=256, prune_min=64,
                                   ingest_chunk=128), 100, False),
    "forks": ((12, 1000, 4, 4), dict(chunk=64, window_bucket=512, prune_min=128,
                                     ingest_chunk=256), 250, True),
    "widening": ((8, 1000, 11, 0), dict(chunk=64, window_bucket=256, prune_min=64,
                                        ingest_chunk=256), 200, True),
}
RANKS = {2: ("smoke", "forks", "widening"), 4: ("smoke", "forks")}


def _schedule(name):
    """``(members, stake, reference chunks, config, driver settings,
    pallas)``; the widening schedule ends with a stale-view sync naming
    long-pruned history."""
    (m, n, seed, forkers), kw, size, pallas = SCHEDULES[name]
    members, stake, events, keys = generate_gossip_dag(m, n, seed=seed, n_forkers=forkers)
    chunks = fixed_chunks(events, size)
    if name == "widening":
        chunks.append([stale_event(events, keys, 3, 100, b"stale-sync")])
    return members, stake, chunks, RefConfig(n_members=m), kw, pallas


@pytest.fixture(scope="module")
def groups():
    """``groups(d)``: every schedule of ``RANKS[d]`` run in one gloo group
    of ``d`` CPU ranks (once a module), ``{name: per-rank results}``."""
    runs = {}

    def run(d):
        if d not in runs:
            tasks = []
            for name in RANKS[d]:
                members, stake, chunks, cfg, kw, pallas = _schedule(name)
                tasks.append((multichip.streaming_rank, (
                    members, stake, port_config(cfg), [port_events(c) for c in chunks],
                    {**kw, "pallas": pallas},
                )))
            reports = multichip.launch(multichip.tasks_rank, d, args=(tasks,),
                                       device="cpu", backend="gloo", timeout=300)
            runs[d] = {name: [rep["result"]["results"][i] for rep in reports]
                       for i, name in enumerate(RANKS[d])}
        return runs[d]

    return run


def _lockstep(d, outs, name):
    """The reference's mesh driver over ``d`` devices through the same
    schedule, every pass's stats compared with every rank's."""
    members, stake, chunks, cfg, kw, _pallas = _schedule(name)
    want = ref_parallel.MeshStreamingConsensus(ref_parallel.make_mesh(d), members,
                                               stake, cfg, **kw)
    try:
        for i, chunk in enumerate(chunks):
            sw = want.ingest(chunk)
            for k in VOLATILE:
                sw.pop(k, None)
            for out in outs:
                sg = dict(out["passes"][i])
                assert sg.pop("group_calls") > 0 and sg.pop("group_bytes") > 0
                assert sg.pop("rank_resident_bytes") * d == sg["resident_bytes"]
                for k in VOLATILE:
                    sg.pop(k, None)
                assert sg == sw, (name, i)
        for out in outs:
            assert_same(want.result(), out["result"])
            arch = want.store.archive
            assert out["archive"] == {
                "digest": arch.digest(), "n_rows": arch.n_rows, "rounds": arch._rounds,
                **{k: getattr(arch, k) for k in (
                    "spills", "fetches", "spilled_rows", "fetched_rows",
                    "skipped_rows", "archive_bytes")}}
            sw_store, sg_store = want.store.stats(), dict(out["store"])
            for k in STORE_VOLATILE:
                sw_store.pop(k)
                sg_store.pop(k)
            assert sg_store == sw_store and sg_store["n_shards"] == d
            for k in ("widen_rebases", "full_rebases", "pruned_prefix", "_round_hi"):
                assert out["counters"][k] == getattr(want, k), k
            assert out["counters"]["repins"] == 0
            assert out["counters"]["forked"] == (want._sees_d is not want._anc_d)
    finally:
        want.store.close()
    return members, stake, chunks, cfg


@pytest.mark.parametrize("d,name", [(d, n) for d in sorted(RANKS) for n in RANKS[d]
                                    if n != "widening"])
def test_group_streaming_lockstep_with_reference(groups, d, name):
    outs = groups(d)[name]
    members, stake, chunks, cfg = _lockstep(d, outs, name)
    events = [e for c in chunks for e in c]
    for out in outs:
        assert out["passes"][-1]["mesh_devices"] == d
        assert_batch_parity(_Result(out["result"]), events, members, stake, cfg)
    if name == "smoke":
        assert outs[0]["counters"]["pruned_prefix"] > 0
    else:
        assert outs[0]["counters"]["forked"]


def test_group_streaming_widening_rebase(groups):
    outs = groups(2)["widening"]
    _lockstep(2, outs, "widening")
    for out in outs:
        assert out["counters"]["widen_rebases"] == 1
        assert out["counters"]["full_rebases"] == 1          # the cold start
        assert out["archive"]["fetched_rows"] > 0
        assert (out["result"].round_received >= 0).any()


class _Result:
    """A port result as ``assert_batch_parity`` reads a driver."""

    def __init__(self, result):
        self._result = result

    def result(self):
        return self._result
