"""The port's real-process cluster (``tpu_swirld_torch.net``): the
reference's ``tests/test_cluster.py`` run on the port, the port cluster's
own event logs judged by the reference, and a saved cluster union replayed
through both packages' windowed engines.

The process tests launch genuine OS processes (``python -m
tpu_swirld_torch.net.node_proc``) gossiping over loopback TCP and hold
them to the chaos harness's standard: decided prefixes bit-identical to a
fault-free oracle replay of the union DAG (safety) and a decided frontier
that advances past any crash window (liveness).  The 3-process smoke and
the overload leg ride tier-1; the 5-process SIGKILL soak rides ``-m slow``,
as the reference's does.  The node processes use the machine's default
signer, so the supervisor side of each process test does too.  The saved
union's replays come first: they spawn nothing, and under ``--dist
loadfile`` they keep this file's node processes from running beside the
reference's ``tests/test_cluster.py``, whose nodes wedge on a loaded host
(ROADMAP C4).
"""

import contextlib
import gzip
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from tpu_swirld import chaos as ref_chaos
from tpu_swirld import crypto as ref_crypto
from tpu_swirld.config import SwirldConfig as RefConfig
from tpu_swirld.net import cluster as ref_cluster
from tpu_swirld.oracle.graph import toposort as ref_toposort
from tpu_swirld.oracle.node import Node as RefNode
from tpu_swirld.sim import member_keys as ref_member_keys
from tpu_swirld_torch import chaos, crypto
from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.net import cluster
from tpu_swirld_torch.net.cluster import ClusterSpec, run_cluster
from tpu_swirld_torch.sim import member_keys

ROOT = Path(__file__).resolve().parents[1]
_FAST_NET = {"gossip_interval_s": 0.005, "checkpoint_every_s": 0.5}
#: the signer a fresh process picks, as every node process does (read
#: before any test switches it)
DEFAULT_SIGNER = crypto.backend_name()
#: the union event log of one run of chip_smoke.py's CLUSTER_SPEC (bench.py
#: --cluster's chaos leg: 5 nodes, seed 9, node 1 killed at 1.8 s and
#: restarted at 3.0 s) through the port's run_cluster on the CPU, ed25519
#: signer: its oracle observer's events in order_added, each encode_event'd
#: as a node's events.bin holds them, gzip-compressed.  2 447 events, 2 388
#: decided; the restarted node's events drive the windowed drivers into a
#: run of rebases (the rebase-storm guard's included).
UNION_LOG = ROOT / "tests" / "data" / "cluster_union.bin.gz"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tiny ops: torch's CPU thread pool costs far more than it saves here
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def default_signer():
    """Both packages on the node processes' signer, restored afterwards."""
    with _signer(DEFAULT_SIGNER):
        yield


@contextlib.contextmanager
def _signer(name):
    """Both packages on ``name`` inside the block."""
    prev = ref_crypto.backend_name(), crypto.backend_name()
    ref_crypto.set_backend(name)
    crypto.set_backend(name)
    try:
        yield
    finally:
        ref_crypto.set_backend(prev[0])
        crypto.set_backend(prev[1])


@pytest.mark.parametrize("engine", ["incremental", "streaming"])
def test_cluster_union_replay_matches_reference(engine, tmp_path):
    """``UNION_LOG`` through both packages, as chip_smoke.py phase 15(c)
    replays a cluster's union on the card: each package's
    ``read_event_log`` decodes it, an observer ingests it in
    ``oracle_replay``'s order, and ``_engines_agree`` (a batch pass at block
    64, then the windowed driver in 64-event chunks) gives the reference's
    row, rebase counts and store counters included.  The union needs no
    node process: it is a saved run's log."""
    n, seed = chip_smoke.CLUSTER_SPEC["n_nodes"], chip_smoke.CLUSTER_SPEC["seed"]
    path = tmp_path / "union.events.bin"
    path.write_bytes(gzip.decompress(UNION_LOG.read_bytes()))
    with _signer("ed25519"):
        union = {ev.id: ev for ev in cluster.read_event_log(str(path))}
        ref_union = {ev.id: ev for ev in ref_cluster.read_event_log(str(path))}
        observer = chaos.oracle_observer(
            union, [pk for pk, _ in member_keys(n, seed)],
            SwirldConfig(n_members=n, seed=seed), cluster.observer_keypair(seed),
        )
        ref_observer = _ref_oracle_observer(ref_union, n, seed)
        assert ref_observer.consensus == ref_chaos.oracle_replay(
            ref_union, [pk for pk, _ in ref_member_keys(n, seed)],
            RefConfig(n_members=n, seed=seed), ref_cluster.observer_keypair(seed),
        )
        assert len(observer.order_added) == len(union) == 2447
        assert observer.order_added == ref_observer.order_added
        assert observer.consensus == ref_observer.consensus
        row = chaos._engines_agree(observer, engine=engine, device="cpu")
        want = ref_chaos._engines_agree(ref_observer, engine=engine)
    assert row["batch_oracle_parity"] and row["incremental_batch_parity"], row
    assert set(row) == set(want) | {"seconds"}
    assert chip_smoke.chaos_fields(row) == chip_smoke.chaos_fields(want)
    assert row["incremental_rebases"] > 3     # past the rebase-storm guard's threshold


def _ref_oracle_observer(union, n_nodes, seed):
    """The reference's ``oracle_replay`` observer (its function returns only
    the order): the union ingested in topological order, one consensus
    pass."""
    ordered = ref_toposort(
        sorted(union, key=lambda e: (union[e].t, e)), lambda e: list(union[e].p),
    )
    pk, sk = ref_cluster.observer_keypair(seed)
    observer = RefNode(
        sk=sk, pk=pk, network={}, members=[p for p, _ in ref_member_keys(n_nodes, seed)],
        config=RefConfig(n_members=n_nodes, seed=seed), create_genesis=False,
    )
    observer.consensus_pass([e for e in ordered if observer.add_event(union[e])])
    return observer


@pytest.mark.cluster
@pytest.mark.usefixtures("default_signer")
def test_cluster_smoke_three_processes_via_cli(tmp_path):
    """The acceptance path end to end through ``python -m
    tpu_swirld_torch.cluster_run``: 3 node processes, client traffic, green
    verdict, exit status 0; then the reference's ``read_event_log`` and
    ``oracle_replay`` over the port cluster's own logs give the order the
    port's verdict was judged against."""
    workdir = str(tmp_path / "cluster")
    out = str(tmp_path / "verdict.json")
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_swirld_torch.cluster_run",
         "--nodes", "3", "--seed", "3", "--duration", "2.5",
         "--rate", "120", "--workdir", workdir,
         "--gossip-interval", "0.005", "--checkpoint-every", "0.5",
         "--out", out],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(out) as f:
        v = json.load(f)
    assert json.loads(proc.stdout) == v
    assert v["ok"]
    assert v["safety"]["prefix_agree"] and v["safety"]["oracle_agree"]
    assert v["safety"]["common_prefix_len"] > 0
    assert v["liveness"]["decided_final"] > 0
    # real client traffic was admitted and decided, with latency samples
    assert v["tx"]["acked"] > 0
    assert v["tx"]["decided"] > 0
    assert v["tx"]["submit_count"] > 0
    assert 0 < v["tx"]["submit_p50"] <= v["tx"]["submit_p99"]
    # fault-free run: every node started clean and exited gracefully
    assert v["reports"] == 3
    for row in v["nodes"]:
        assert row["exit_code"] == 0
        assert row["unclean_start"] is False
        assert row["flightrec_dump"] is None
    for i in range(3):
        assert os.path.exists(os.path.join(workdir, f"node-{i}.report.json"))
        assert os.path.exists(os.path.join(workdir, f"node-{i}.events.bin"))
    _assert_telemetry_plane(workdir, v, n_nodes=3)
    _assert_reference_judges_the_same(workdir, v, n_nodes=3, seed=3)


def _assert_reference_judges_the_same(workdir, v, n_nodes, seed):
    """The reference's reading of the port cluster's files: the same union,
    the same oracle order, every node's decided order a prefix of it.
    Returns the port's oracle observer of the union."""
    indices = list(range(n_nodes))
    reports, union, _rows = cluster.collect_node_state(workdir, indices, {}, {})
    ref_reports, ref_union, _ = ref_cluster.collect_node_state(workdir, indices, {}, {})
    assert sorted(union) == sorted(ref_union) and len(union) > 0
    assert reports == ref_reports
    observer = chaos.oracle_observer(
        union, [pk for pk, _ in member_keys(n_nodes, seed)],
        SwirldConfig(n_members=n_nodes, seed=seed), cluster.observer_keypair(seed),
    )
    order = observer.consensus
    ref_order = ref_chaos.oracle_replay(
        ref_union, [pk for pk, _ in ref_member_keys(n_nodes, seed)],
        RefConfig(n_members=n_nodes, seed=seed), ref_cluster.observer_keypair(seed),
    )
    assert order == ref_order
    assert len(ref_order) == v["safety"]["oracle_len"]
    for rep in reports.values():
        decided = [bytes.fromhex(e) for e in rep["decided"]]
        assert decided == ref_order[:len(decided)]


def _assert_telemetry_plane(workdir, v, n_nodes):
    """One merged cross-process trace where at least one submission's spans
    cross two node processes with correct parent/child linkage, plus a
    supervisor metrics rollup covering every node."""
    from tpu_swirld_torch.obs import cluster_trace
    from tpu_swirld_torch.obs.registry import Registry

    assert v["trace"]["merged"] == os.path.join(workdir, "merged.trace.json")
    assert os.path.exists(v["trace"]["merged"])
    assert v["trace"]["shards"] == n_nodes + 1     # every node + client
    assert v["trace"]["cross_process_traces"] >= 1
    summary = cluster_trace.merge_dir(workdir)
    shard_labels = [cluster_trace.shard_label(p) for p in summary["shards"]]
    client_pid = shard_labels.index("client")
    with open(v["trace"]["merged"]) as f:
        merged = json.load(f)["traceEvents"]
    spans = {
        (e["args"]["trace"], e["args"]["span_id"]): e
        for e in merged
        if e.get("ph") == "X" and "trace" in (e.get("args") or {})
    }
    deep = None   # a trace whose spans touch >= 2 distinct node processes
    for trace_id, info in summary["per_trace"].items():
        node_pids = [p for p in info["pids"] if p != client_pid]
        if len(node_pids) >= 2 and "node.serve_sync" in info["names"]:
            deep = trace_id
            break
    assert deep is not None, summary["per_trace"]
    by_name = {}
    for (t, _sid), e in spans.items():
        if t == deep:
            by_name.setdefault(e["name"], []).append(e)
    root = by_name["client.submit"][0]
    assert root["pid"] == client_pid
    assert "parent_span_id" not in root["args"]
    submit = by_name["node.submit"][0]
    assert submit["args"]["parent_span_id"] == root["args"]["span_id"]
    assert submit["pid"] != client_pid
    serve = by_name["node.serve_sync"][0]
    sync_parent = spans[(deep, serve["args"]["parent_span_id"])]
    assert sync_parent["name"] == "gossip.sync"
    assert sync_parent["pid"] != serve["pid"]      # a real gossip hop
    assert sync_parent["pid"] != client_pid and serve["pid"] != client_pid
    assert v["metrics"]["nodes_covered"] == n_nodes
    assert v["metrics"]["polls"] >= 1
    with open(v["metrics"]["json"]) as f:
        doc = json.load(f)
    assert sorted(doc["nodes"]) == [f"n{i}" for i in range(n_nodes)]
    assert doc["rollup"]["tx_accepted"] > 0
    assert doc["rollup"]["hg_events"] > 0
    with open(v["metrics"]["prom"]) as f:
        prom = f.read()
    for i in range(n_nodes):
        assert f'node="n{i}"' in prom
    assert "# TYPE" in prom
    r = Registry()
    for node, samples in doc["nodes"].items():
        r.load_samples(samples, extra_labels={"node": node})
    assert r.value("tx_accepted", {"node": "n0"}) is not None


@pytest.mark.cluster
@pytest.mark.usefixtures("default_signer")
def test_cluster_overload_sheds_instead_of_buffering(tmp_path):
    """Admission control under a zero undecided-window budget: every
    submission is shed with an explicit reply, nothing is buffered, and
    the consensus core stays green underneath."""
    spec = ClusterSpec(
        workdir=str(tmp_path / "overload"),
        n_nodes=3, seed=5, duration_s=1.5, tx_rate=200.0,
        net=dict(_FAST_NET, max_undecided=0),
    )
    v = run_cluster(spec)
    assert v["ok"], v["safety"]
    assert v["tx"]["acked"] == 0
    assert v["tx"]["shed"] > 0
    assert v["counters"]["tx_shed_window"] == v["tx"]["shed"]
    assert v["counters"]["tx_accepted"] == 0


@pytest.mark.slow
@pytest.mark.cluster
@pytest.mark.usefixtures("default_signer")
def test_cluster_kill9_soak_recovers_from_checkpoint_and_wal(tmp_path):
    """A 5-process cluster survives a mid-run SIGKILL: the victim restarts
    from checkpoint + own-event WAL, dumps a startup post-mortem, re-joins
    via pull-only recovery, and the decided prefixes stay bit-identical to
    the oracle while the frontier advances past the crash window."""
    kill_index = 2
    spec = ClusterSpec(
        workdir=str(tmp_path / "soak"),
        n_nodes=5, seed=7, duration_s=6.0, tx_rate=200.0,
        kill_index=kill_index, kill_at_s=2.0, restart_at_s=3.5,
        flightrec_dir=str(tmp_path / "flightrec"),
        net=_FAST_NET,
    )
    v = run_cluster(spec)
    assert v["ok"], (v["safety"], v["liveness"], v["nodes"])
    assert v["faults"]["killed"] and v["faults"]["restarted"]
    assert v["safety"]["prefix_agree"] and v["safety"]["oracle_agree"]
    assert v["liveness"]["decided_final"] > v["liveness"]["decided_at_heal"]
    victim = v["nodes"][kill_index]
    assert victim["restarts"] == 1
    assert victim["unclean_start"] is True
    assert victim["flightrec_dump"] is not None
    assert os.path.exists(victim["flightrec_dump"])
    assert victim["exit_code"] == 0        # the restart exited cleanly
    for row in v["nodes"]:
        if row["index"] != kill_index:
            assert row["unclean_start"] is False
            assert row["flightrec_dump"] is None
    assert v["tx"]["acked"] > 0 and v["tx"]["decided"] > 0
    _assert_reference_judges_the_same(spec.workdir, v, n_nodes=5, seed=7)
