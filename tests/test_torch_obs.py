"""The port's observability (``tpu_swirld_torch.obs`` and ``metrics``)
against the reference's ``tpu_swirld.obs`` and ``metrics``: exporters and
spans byte-equal, the same run under each package's ambient ``Obs`` leaving
registries with the same metric names, labels and protocol values, the
disabled path touching nothing, the dispatch profiler's accounting, the
simulation wiring, the report CLI and cross-package flight-recorder dumps.
Tolerance: exact equality, apart from values that measure time."""

import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_swirld import crypto as ref_crypto
from tpu_swirld import obs as ref_obs
from tpu_swirld.config import SwirldConfig as RefConfig
from tpu_swirld.metrics import Metrics as RefMetrics
from tpu_swirld.metrics import node_gauges as ref_node_gauges
from tpu_swirld.obs import flightrec as ref_flightrec
from tpu_swirld.obs import tracer as ref_tracer
from tpu_swirld.packing import pack_events
from tpu_swirld.sim import generate_gossip_dag
from tpu_swirld.sim import make_simulation as ref_make_simulation
from tpu_swirld.store import StreamingConsensus as RefStreaming
from tpu_swirld.tpu import pipeline as ref
from tpu_swirld_torch import crypto, obs
from tpu_swirld_torch.gpu import build
from tpu_swirld_torch.gpu import pipeline
from tpu_swirld_torch.metrics import Metrics, node_gauges, trace_consensus
from tpu_swirld_torch.obs import flightrec, tracer
from tpu_swirld_torch.obs.profile import DispatchProfiler
from tpu_swirld_torch.sim import make_simulation
from tpu_swirld_torch.store import StreamingConsensus
from tests.test_torch_incremental import port_events
from tests.test_torch_pipeline import carry_across, port_config
from tests.test_torch_store import port_config as stream_port_config

ROOT = Path(__file__).resolve().parents[1]

#: the DAG shapes of tests/test_finality.py: (members, events, seed, forkers)
SHAPES = {"8m-400ev-2forkers": (8, 400, 3, 2), "6m-300ev-honest": (6, 300, 5, 0)}

#: Stages the port splits differently from the reference, each as
#: (reference stages, port stages): where the reference ran the first, the
#: sum of their calls equals each of the second's calls.
#: - The columns pass and the drivers' column adds: the reference gathers
#:   the a-side member rows once a pass (``ssm_gather_rows``, its XLA
#:   cache, with no port counterpart) and runs the adds from them
#:   (``ssm_block_from_rows``), or through its kernel seam
#:   (``ssm_block_stage``); the port's ``ssm_block`` kernel gathers the
#:   rows itself, so every add is one ``ssm_block_stage``.
#: - The full path: the reference's stage A is one jitted function
#:   (``rounds_stage``); the port runs its three phases as stages of their
#:   own, each synchronized, whose seconds chip_smoke.py reports apart.
SPLIT_STAGES = (
    (("pipeline.ssm_block_from_rows", "pipeline.ssm_block_stage"),
     ("pipeline.ssm_block_stage",)),
    (("pipeline.rounds_stage",),
     ("pipeline.visibility_stage", "pipeline.ssm_matrix_stage",
      "pipeline.rounds_scan_stage")),
)
REF_ONLY_STAGES = ("pipeline.ssm_gather_rows",)
#: metrics whose values measure wall time or a momentary queue length
TIMED = ("pipeline_stage_seconds", "stream_overlap_ratio",
         "store_spill_queue_depth")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def sim_signer():
    prev = ref_crypto.backend_name(), crypto.backend_name()
    ref_crypto.set_backend("sim")
    crypto.set_backend("sim")
    try:
        yield
    finally:
        ref_crypto.set_backend(prev[0])
        crypto.set_backend(prev[1])


def _samples(registry, merge_kind=False):
    """``{(name, labels): value}`` of a registry (a histogram as its count
    and sum); ``merge_kind`` sums a stage's ``compile`` and ``execute``
    samples under ``kind="any"``."""
    out = {}
    for m in registry.metrics():
        value = (m.count, m.sum) if hasattr(m, "count") else m.value
        labels = m.labels
        if merge_kind and "kind" in dict(labels):
            labels = tuple(sorted({**dict(labels), "kind": "any"}.items()))
            value = out.get((m.name, labels), 0) + value
        out[(m.name, labels)] = value
    return out


def _calls(samples, stage):
    return sum(v for (name, labels), v in samples.items()
               if name == "pipeline_stage_calls"
               and dict(labels)["stage"] == stage)


def assert_same_registry(want, got, merge_kind=False):
    """Equal metric names and labels, and equal values apart from times;
    the stages of ``SPLIT_STAGES`` agree by call count.  Returns the
    port's samples."""
    w, g = _samples(want, merge_kind), _samples(got, merge_kind)
    drop_w, drop_g = set(REF_ONLY_STAGES), set()
    for ref_stages, port_stages in SPLIT_STAGES:
        if not _calls(w, ref_stages[0]):
            continue
        total = sum(_calls(w, s) for s in ref_stages)
        assert [_calls(g, s) for s in port_stages] == [total] * len(port_stages)
        drop_w |= set(ref_stages)
        drop_g |= set(port_stages)

    def keep(samples, drop):
        return {k: v for k, v in samples.items()
                if dict(k[1]).get("stage") not in drop}

    w, g_kept = keep(w, drop_w), keep(g, drop_g)
    assert set(g_kept) == set(w)
    for key in w:
        if key[0] not in TIMED:
            assert g_kept[key] == w[key], key
    return g


# ------------------------------------------------------------- exporters


def _registry_calls(reg):
    reg.counter("gossip_syncs").inc(3)
    reg.counter("pipeline_stage_calls", {"stage": "a", "kind": "execute"}).inc()
    reg.counter("pipeline_stage_calls", {"stage": "a", "kind": "execute"}).inc(2)
    reg.gauge("pipeline_r_max").set(64)
    reg.gauge("weird name-1", {"node": 'n"0\\'}).set(-1.5)
    reg.gauge("store_resident_bytes").inc(1 << 40)
    h = reg.histogram("finality_rounds_to_decision", {"engine": "batch"})
    for v in (1, 2, 2, 3, 7, 40):
        h.observe(v)
    reg.histogram("finality_time_to_finality_seconds").observe(0.25)


def test_registry_exports_byte_equal():
    want, got = ref_obs.Registry(), obs.Registry()
    _registry_calls(want)
    _registry_calls(got)
    assert got.to_prometheus_text() == want.to_prometheus_text()
    assert got.to_json() == want.to_json()
    assert got.to_json(indent=2) == want.to_json(indent=2)
    assert got.to_samples() == want.to_samples()


def _fake_clock():
    ticks = iter(range(10_000))
    return types.SimpleNamespace(
        perf_counter=lambda: 0.25 * next(ticks), time=lambda: 1.7e9
    )


def _spans(tr):
    with tr.span("outer", kind="x"):
        with tr.span("inner") as sp:
            sp.args["n"] = 3
        tr.instant("mark", k=1)
        with tr.span("inner"):
            pass
    tr.counter("c", 2, {"node": "n0"})


def test_tracer_chrome_events_equal(monkeypatch, tmp_path):
    monkeypatch.setattr(ref_tracer, "time", _fake_clock())
    monkeypatch.setattr(tracer, "time", _fake_clock())
    want, got = ref_tracer.Tracer(pid=3), tracer.Tracer(pid=3)
    _spans(want)
    _spans(got)
    assert got.events == want.events
    assert got.phase_seconds() == want.phase_seconds()
    want.save_chrome(str(tmp_path / "a.json"))
    got.save_chrome(str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()
    ctx = tracer.pack_context(b"8bytes!!", 7)
    assert ctx == ref_tracer.pack_context(b"8bytes!!", 7)
    assert tracer.unpack_context(ctx) == (b"8bytes!!", 7)


# ------------------------------------------- cross-package registry parity


def _dag(shape):
    m, n, seed, forkers = SHAPES[shape]
    members, stake, events, _keys = generate_gossip_dag(
        m, n, seed=seed, n_forkers=forkers
    )
    return members, stake, events, RefConfig(n_members=m)


@pytest.mark.parametrize("mode", ["columns", "full"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_pipeline_registry_matches_reference(shape, mode):
    """The same pass under each package's ambient Obs, both warm (the
    reference's jit caches and the port's kernels loaded, so every call is
    ``execute`` in both)."""
    members, stake, events, cfg = _dag(shape)
    packed = pack_events(events, members, stake)
    mine = carry_across(packed)
    kw = {"block": 64, "ssm_mode": mode}
    ref.run_consensus(packed, cfg, **kw)
    with ref_obs.enabled() as want:
        ref.run_consensus(packed, cfg, **kw)
    with obs.enabled() as got:
        pipeline.run_consensus(mine, port_config(cfg), device="cpu", **kw)
    samples = assert_same_registry(want.registry, got.registry)
    assert samples[("pipeline_events", ())] == packed.n
    assert obs.compile_counts(got.registry) == {}
    spans = {e["name"] for e in got.tracer.spans()}
    assert "pipeline.finalize" in spans and "pipeline.visibility_stage" in spans


@pytest.mark.parametrize("shape", list(SHAPES))
def test_streaming_registry_matches_reference(shape):
    """The driver hooks: the ``incremental_*`` and ``store_*`` gauges and
    counters of the streaming driver (the incremental driver's included)
    equal the reference's and read the driver's own counters."""
    members, stake, events, cfg = _dag(shape)
    kw = dict(block=64, chunk=64, window_bucket=256, prune_min=64,
              ingest_chunk=128)
    want_d = RefStreaming(members, stake, cfg, **kw)
    got_d = StreamingConsensus(
        members, stake, stream_port_config(cfg), device="cpu", **kw
    )
    with ref_obs.enabled() as want:
        for i in range(0, len(events), 100):
            want_d.ingest(events[i : i + 100])
        want_d.store.archive.digest()
    with obs.enabled() as got:
        for i in range(0, len(events), 100):
            got_d.ingest(port_events(events[i : i + 100]))
        got_d.store.archive.digest()
    want_d.store.close()
    got_d.store.close()
    # the reference's first calls of each shape compile: kinds merged
    samples = assert_same_registry(want.registry, got.registry, merge_kind=True)
    assert samples[("incremental_passes_total", ())] == got_d.passes
    assert samples[("incremental_window_size", ())] == got_d.window_size
    assert samples[("incremental_pruned_prefix", ())] == got_d.pruned_prefix
    stats = got_d.store.stats()
    assert samples[("store_resident_bytes", ())] == stats["resident_bytes"]
    n_rows = got_d.store.archive.n_rows
    assert samples.get(("store_archived_rows", ()), 0) == n_rows
    assert samples.get(("store_spilled_rows_total", ()), 0) == n_rows
    if not SHAPES[shape][3]:
        assert n_rows > 0          # fork-free: the window prunes and spills


def test_disabled_mode_pipeline_touches_nothing():
    members, stake, events, cfg = _dag("6m-300ev-honest")
    mine = carry_across(pack_events(events, members, stake))
    bystander = obs.Obs()              # exists but is never enabled
    assert obs.current() is None
    res = pipeline.run_consensus(mine, port_config(cfg), block=64, device="cpu")
    assert len(res.order) > 0
    assert obs.current() is None
    assert len(bystander.registry) == 0
    assert bystander.tracer.events == []


def test_obs_enabled_scope_nests_and_restores():
    assert obs.current() is None
    with obs.enabled() as outer:
        assert obs.current() is outer
        with obs.enabled() as inner:
            assert obs.current() is inner
        assert obs.current() is outer
    assert obs.current() is None
    o = obs.enable()
    assert obs.current() is o and obs.disable() is o and obs.current() is None


# ------------------------------------------------------ dispatch profiler


def test_dispatch_profiler_chunk_accounting_with_injected_clock():
    ticks = iter([100.0, 110.0])   # begin_chunk, end_chunk
    prof = DispatchProfiler(top_k=2, clock=lambda: next(ticks))
    prof.begin_chunk(label="c0")
    # a numpy argument always counts as an upload; a CPU tensor counts
    # only for a stage on a CUDA device; a tensor on the stage's device not
    cuda = torch.device("cuda")
    prof.record_dispatch("A", 100.0, 103.0, args=(np.zeros(4, dtype=np.uint8),))
    prof.record_dispatch("B", 104.0, 106.0,
                         args=(torch.zeros(2, dtype=torch.int32),), device=cuda)
    prof.record_dispatch("A", 106.0, 107.0,
                         args=(torch.zeros(8),), device=torch.device("cpu"))
    prof.record_transfer("d2h", 32)
    row = prof.end_chunk(n_events=7)
    assert row["label"] == "c0" and row["n_events"] == 7
    assert row["dispatches"] == 3
    assert row["stage_s"] == pytest.approx(6.0)
    assert row["wall_s"] == pytest.approx(10.0)
    assert row["overhead_s"] == pytest.approx(4.0)
    assert row["gap_s"] == pytest.approx(1.0)
    assert row["h2d_bytes"] == 4 + 8 and row["d2h_bytes"] == 32
    s = prof.summary()
    assert s["chunks"] == 1 and s["dispatches"] == 3
    assert s["transfers_bytes"] == {"h2d": 12, "d2h": 32}
    assert [r["stage"] for r in s["top_stages"]] == ["A", "B"]
    assert s["top_stages"][0]["calls"] == 2


def test_stage_call_feeds_profiler_and_classifies_builds(monkeypatch):
    """A call during which a kernel library was built or loaded is a
    ``compile`` call and stays out of the profiler; the others are
    ``execute``.  ``to_host`` counts D2H only for a device tensor."""

    def loads_a_library(x):
        monkeypatch.setattr(build, "load_count", build.load_count + 1)
        return x + 1

    prof = DispatchProfiler()
    with obs.enabled(obs.Obs(profiler=prof)) as o:
        prof.begin_chunk()
        obs.stage_call("stage.f", loads_a_library, torch.arange(8))
        obs.stage_call_fused("stage.f", 4, lambda x: x + 1, torch.arange(8))
        host = obs.to_host(torch.arange(8), copy=True)
        prof.end_chunk(n_events=8)
    assert obs.compile_counts(o.registry) == {"stage.f": 1}
    assert o.registry.value(
        "pipeline_stage_calls", {"stage": "stage.f", "kind": "execute"}) == 1
    assert prof.dispatches == 1 and prof.fused_dispatches == 1
    assert prof.d2h_bytes == 0 and host.tolist() == list(range(8))
    assert [e["args"]["kind"] for e in o.tracer.spans()] == ["compile", "execute"]


# ---------------------------------------------------------- simulations


def _gossip(counts):
    return {k: v for k, v in counts.items() if k.startswith("gossip_")}


def test_make_simulation_wiring_matches_reference(sim_signer):
    """Per-node ``Metrics``, finality trackers on the logical clock and
    one shared flight recorder, as the reference wires them; at the same
    seed and turns every node's gauges, gossip counters, rounds-to-decision
    samples and ring contents are equal."""
    want_rec = ref_flightrec.FlightRecorder(capacity=64)
    got_rec = flightrec.FlightRecorder(capacity=64)
    want = ref_make_simulation(5, seed=13, metrics=True, finality=True,
                               flightrec=want_rec)
    got = make_simulation(5, seed=13, metrics=True, finality=True,
                          flightrec=got_rec)
    assert len({id(n.metrics) for n in got.nodes}) == 5
    assert [n.flightrec_label for n in got.nodes] == [f"n{i}" for i in range(5)]
    want.run(300)
    got.run(300)
    for a, b in zip(want.nodes, got.nodes):
        assert node_gauges(b) == ref_node_gauges(a)
        assert _gossip(b.metrics.counts) == _gossip(a.metrics.counts)
        assert _gossip(b.metrics.counts)["gossip_syncs"] > 0
        assert b.finality.rtd == a.finality.rtd and b.finality.rtd
        assert b.finality.summary() == a.finality.summary()
        ra, rb = a.metrics.registry, b.metrics.registry
        node_gauges(b, registry=rb, node_label="x")
        ref_node_gauges(a, registry=ra, node_label="x")
        assert ({k: v for k, v in _samples(rb).items() if k[0] != "phase_seconds"}
                == {k: v for k, v in _samples(ra).items() if k[0] != "phase_seconds"})
    assert got_rec.records_total == want_rec.records_total > 0
    assert got_rec.snapshot("x") == want_rec.snapshot("x")


def test_shared_metrics_and_tracer_plumb(sim_signer):
    shared, tr = Metrics(), obs.Tracer()
    sim = make_simulation(4, seed=11, metrics=shared, tracer=tr)
    assert all(n.metrics is shared and n.tracer is tr for n in sim.nodes)
    sim.run(60)
    counts = shared.counts
    assert counts["gossip_syncs"] == 60
    assert len(tr.spans()) == 3 * 60
    want = ref_make_simulation(4, seed=11, metrics=RefMetrics())
    want.run(60)
    assert _gossip(counts) == _gossip(want.nodes[0].metrics.counts)
    assert "s_divide_rounds" in shared.snapshot()


# ------------------------------------------------- report, trace, dumps


@pytest.mark.smoke
def test_report_cli_smoke(tmp_path):
    members, stake, events, cfg = _dag("6m-300ev-honest")
    mine = carry_across(pack_events(events, members, stake))
    with obs.enabled() as o:
        pipeline.run_consensus(mine, port_config(cfg), block=64, device="cpu")
    path = tmp_path / "t.jsonl"
    o.save(str(path))
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_swirld_torch.obs", "report", str(path)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "pipeline.rounds_chunk_stage" in proc.stdout
    assert "pipeline_events" in proc.stdout


def test_trace_consensus_on_cpu(tmp_path):
    """``trace_consensus`` writes a Chrome trace whose ranges name the
    stages, and returns ``run_consensus``'s result."""
    members, stake, events, cfg = _dag("6m-300ev-honest")
    mine = carry_across(pack_events(events, members, stake))
    res = trace_consensus(mine, port_config(cfg), outdir=str(tmp_path / "tr"),
                          device="cpu", block=64)
    want = pipeline.run_consensus(mine, port_config(cfg), block=64, device="cpu")
    assert res.order == want.order
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "pipeline.rounds_chunk_stage" in names


def test_memory_monitor_on_cpu():
    mon = obs.MemoryMonitor(device="cpu")
    try:
        with obs.enabled() as o:
            with mon.phase("alloc"):
                blob = bytearray(1 << 20)
        assert mon.phases["alloc"]["host_peak_bytes"] >= len(blob)
        assert mon.phases["alloc"]["device_peak_bytes"] == 0
        assert o.registry.value("mem_host_peak_bytes", {"phase": "alloc"}) > 0
        assert set(mon.flat()) == {"mem_alloc_host_peak_bytes",
                                   "mem_alloc_device_peak_bytes"}
    finally:
        mon.close()


def _dump(mod, tmp_path, name):
    rec = mod.FlightRecorder(capacity=4, dump_dir=str(tmp_path / name),
                             clock=lambda: 7)
    for i in range(6):
        rec.record_ingest("n0", bytes([i]) * 32)
    rec.record_counter("n1", "gossip_syncs", 2)
    reg = (ref_obs if mod is ref_flightrec else obs).Registry()
    reg.counter("x").inc()
    return rec.trigger("overflow_heal", node="n0", detail={"retries": 1},
                       decided_frontier={"n0": {"decided": 3, "round": 2}},
                       registry=reg)


def test_flightrec_dumps_load_across_packages(tmp_path):
    want = _dump(ref_flightrec, tmp_path, "ref")
    got = _dump(flightrec, tmp_path, "port")
    assert json.loads(Path(got).read_text()) == json.loads(Path(want).read_text())
    assert flightrec.load_dump(want) == ref_flightrec.load_dump(got)
    foreign = tmp_path / "foreign.json"
    foreign.write_text(json.dumps({"schema": "other"}))
    with pytest.raises(ValueError):
        flightrec.load_dump(str(foreign))


@pytest.mark.slow
def test_obs_golden_matches_reference(sim_signer):
    """Recompute ``chip_smoke.OBS_GOLDEN``: the JAX reference's registry
    after ``run_consensus`` on config 3 (``chip_smoke.make_dag(0)``'s DAG)
    under its ambient Obs, and the SHA-256 of the pass's rounds-to-decision
    list (``record_batch_result``)."""
    import chip_smoke
    from tpu_swirld.obs.finality import FinalityTracker as RefTracker
    from tpu_swirld.obs.finality import record_batch_result as ref_record

    members, stake, events, _keys = generate_gossip_dag(
        chip_smoke.N_MEMBERS, chip_smoke.N_EVENTS, seed=chip_smoke.SEED
    )
    packed = pack_events(events, members, stake)
    with ref_obs.enabled() as o:
        res = ref.run_consensus(packed, RefConfig(n_members=chip_smoke.N_MEMBERS))
    fin = RefTracker("batch")
    ref_record(fin, res)
    got = {k: o.registry.value(k) for k in chip_smoke.OBS_GAUGES}
    got["rtd"] = chip_smoke.rtd_digest(fin.rtd)
    assert got == chip_smoke.OBS_GOLDEN
