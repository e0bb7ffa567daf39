"""The port's production-day soak (``tpu_swirld_torch.soak``): the
reference's ``tests/test_soak_run.py`` and ``tests/test_soak.py`` run on the
port, the schedule documents and settings held to the reference's, and a
saved soak's forked union event log replayed through both packages.

The smoke composition runs genuine node processes (``python -m
tpu_swirld_torch.net.node_proc``) behind per-link TCP fault proxies, under
the machine's default signer, as the node processes use it.  The saved
union's replays come before it: under ``--dist loadfile`` they keep this
file's node processes from starting beside the reference's soak and cluster
smokes (ROADMAP C4).  The mutation, shrink and replay loop and the two
in-process soaks ride ``-m slow``, as the reference's do.
"""

import contextlib
import dataclasses
import functools
import gzip
import json
import os

import pytest
import torch

import chip_smoke
from tpu_swirld import chaos as ref_chaos
from tpu_swirld import config as ref_config
from tpu_swirld import crypto as ref_crypto
from tpu_swirld import soak as ref_soak
from tpu_swirld.config import SwirldConfig as RefConfig
from tpu_swirld.net import cluster as ref_cluster
from tpu_swirld.oracle.graph import toposort as ref_toposort
from tpu_swirld.oracle.node import Node as RefNode
from tpu_swirld.sim import member_keys as ref_member_keys
from tpu_swirld_torch import backend, chaos, config, crypto, soak
from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.net import cluster
from tpu_swirld_torch.net.traffic import OUTCOMES, TrafficPlan, classify_reply
from tpu_swirld_torch.sim import member_keys
from tpu_swirld_torch.soak import (
    AttackWindow, CrashWindow, MembershipWindow, PartitionWindow,
    load_doc, make_doc, replay_doc, save_doc,
    smoke_schedule, spec_from_dict, spec_to_dict,
    window_from_dict, window_to_dict,
)

pytestmark = pytest.mark.soak

_FAST_NET = {"gossip_interval_s": 0.005, "checkpoint_every_s": 0.5}
#: the signer a fresh process picks, as every node process does (read
#: before any test switches it)
DEFAULT_SIGNER = crypto.backend_name()
#: the union event log of one run of the smoke composition below
#: (test_soak_smoke_composition_survives_every_disruption's spec: 4 nodes,
#: seed 3, 6.5 s at 120 tx/s, member 3 the equivocation storm, member 1
#: killed at 25% and restarted at 45% of the horizon, member 0 partitioned
#: at 55-75%) through the port's run_soak on the CPU, ed25519 signer: its
#: oracle observer's events in order_added, each encode_event'd as a node's
#: events.bin holds them, gzip-compressed.  1 842 events, 1 804 decided, 15
#: fork pairs of the storm's member.
UNION_LOG = os.path.join(os.path.dirname(__file__), "data", "soak_union.bin.gz")
UNION_SPEC = {"n_nodes": 4, "seed": 3}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tiny ops: torch's CPU thread pool costs far more than it saves here
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


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


@pytest.fixture
def default_signer():
    """Both packages on the node processes' signer, restored afterwards."""
    with _signer(DEFAULT_SIGNER):
        yield


# ----------------------------------------------------------------- units


def test_window_dict_roundtrip_all_kinds():
    windows = [
        CrashWindow(index=1, at_s=2.0, restart_at_s=3.5),
        PartitionWindow(start_s=1.0, end_s=4.0, group=(0, 2)),
        AttackWindow(start_s=0.5, end_s=6.0, index=3, n_branches=3,
                     step_every_s=0.5),
        MembershipWindow(at_s=2.0, action="leave", member=2, stake=0),
    ]
    for w in windows:
        d = window_to_dict(w)
        assert window_from_dict(json.loads(json.dumps(d))) == w
        # the reference reads the port's dict to the same window, and back
        ref_w = ref_soak.window_from_dict(json.loads(json.dumps(d)))
        assert ref_soak.window_to_dict(ref_w) == d
    with pytest.raises(KeyError):
        window_from_dict({"kind": "meteor-strike"})


def test_schedule_doc_roundtrip(tmp_path):
    spec = soak.default_spec(str(tmp_path), n_nodes=4, seed=9)
    schedule = list(smoke_schedule(spec))
    assert len(schedule) == 3   # attack + crash + partition
    doc = make_doc(spec, schedule, {"accounting_leaked": 7})
    path = save_doc(doc, str(tmp_path / "repro.json"))
    back = load_doc(path)
    assert back["kind"] == soak.DOC_KIND
    assert back["violation"] == {"accounting_leaked": 7}
    spec2 = spec_from_dict(back["spec"], workdir=str(tmp_path / "w2"))
    assert spec2.schedule == tuple(schedule)
    assert spec2.seed == spec.seed and spec2.n_nodes == spec.n_nodes
    alien = tmp_path / "alien.json"
    alien.write_text('{"kind": "bench"}')
    with pytest.raises(ValueError, match="soak-schedule"):
        load_doc(str(alien))
    assert spec_from_dict(
        json.loads(json.dumps(spec_to_dict(spec2))),
    ) == spec2


def test_schedule_docs_cross_load(tmp_path):
    """A schedule document saved by either package loads in the other to an
    equal spec, and both packages write the same bytes."""
    kw = dict(n_nodes=5, seed=9, horizon_s=12.0, mutate="shed-leak",
              net=dict(_FAST_NET), dynamic=True)
    spec = soak.default_spec(str(tmp_path / "w"), **kw)
    ref_spec = ref_soak.default_spec(str(tmp_path / "w"), **kw)
    sched = smoke_schedule(spec) + (MembershipWindow(at_s=3.6, member=1, stake=3),)
    ref_sched = ref_soak.smoke_schedule(ref_spec) + (
        ref_soak.MembershipWindow(at_s=3.6, member=1, stake=3),)
    mine = save_doc(make_doc(spec, list(sched), {"accounting_leaked": 3}),
                    str(tmp_path / "port.json"))
    theirs = ref_soak.save_doc(
        ref_soak.make_doc(ref_spec, list(ref_sched), {"accounting_leaked": 3}),
        str(tmp_path / "ref.json"))
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    got = spec_from_dict(load_doc(theirs)["spec"], workdir=str(tmp_path / "a"))
    want = ref_soak.spec_from_dict(ref_soak.load_doc(mine)["spec"],
                                   workdir=str(tmp_path / "a"))
    assert spec_to_dict(got) == ref_soak.spec_to_dict(want)
    assert got == spec_from_dict(load_doc(mine)["spec"], workdir=str(tmp_path / "a"))
    assert got.schedule == sched


def test_soak_settings_match_reference(monkeypatch):
    assert config.resolve_soak_settings() == ref_config.resolve_soak_settings()
    for env, value in (("SWIRLD_SOAK_HORIZON", "42.5"), ("SWIRLD_SOAK_NODES", "7"),
                       ("SWIRLD_SOAK_TX_RATE", "300"), ("SWIRLD_SOAK_CLIENTS", "5"),
                       ("SWIRLD_SOAK_TX_BYTES", "128"),
                       ("SWIRLD_SOAK_PARETO_ALPHA", "2.5"),
                       ("SWIRLD_SOAK_FINALITY_BUDGET", "9")):
        monkeypatch.setenv(env, value)
        got = config.resolve_soak_settings(SwirldConfig(n_members=4))
        assert got == ref_config.resolve_soak_settings(RefConfig(n_members=4))
    assert got["horizon_s"] == 42.5 and got["nodes"] == 7
    assert spec_to_dict(soak.default_spec("w")) == \
        ref_soak.spec_to_dict(ref_soak.default_spec("w"))


def test_classify_reply_covers_the_txpool_grammar():
    assert classify_reply(b"ACK:deadbeef") == "acked"
    assert classify_reply(b"DUP:deadbeef") == "duplicate"
    assert classify_reply(b"SHED:window") == "shed_window"
    assert classify_reply(b"SHED:pool") == "shed_pool"
    assert classify_reply(b"SHED:oversize") == "shed_oversize"
    assert classify_reply(b"garbage") == "unclassified"
    for bucket in ("acked", "duplicate", "shed_window", "shed_pool",
                   "shed_oversize"):
        assert bucket in OUTCOMES


def test_traffic_plan_rejects_undefined_pareto_mean():
    with pytest.raises(ValueError, match="pareto_alpha"):
        TrafficPlan(pareto_alpha=1.0)
    TrafficPlan(pareto_alpha=1.5)


def test_shed_leak_mutation_drops_exactly_the_window_bucket():
    net = {}
    leaky, net = soak.MUTATIONS["shed-leak"](net)
    assert leaky(b"SHED:window") is None
    assert leaky(b"SHED:pool") == "shed_pool"
    assert leaky(b"ACK:00ff") == "acked"
    assert "max_undecided" in net
    assert sorted(soak.MUTATIONS) == sorted(ref_soak.MUTATIONS)


def test_shrink_ddmin_minimizes_schedule(tmp_path, monkeypatch):
    """ddmin over windows with stubbed probes (the port's ``ddmin``):
    failure iff a partition window is present -> the doc reduces to exactly
    that window, and each probe ran in its own probe-<n> workdir."""
    spec = soak.default_spec(str(tmp_path), n_nodes=4, seed=5)
    spec = dataclasses.replace(spec, schedule=smoke_schedule(spec))
    probe_dirs = []

    def fake_run_soak(probe):
        probe_dirs.append(os.path.basename(probe.workdir))
        bad = any(isinstance(w, PartitionWindow) for w in probe.schedule)
        return {
            "ok": not bad,
            "safety": {"oracle_agree": True},
            "liveness": {"advanced_after_heal": not bad},
            "disruptions_survived": 0 if bad else len(probe.schedule),
            "finality": {"ok": True},
            "accounting": {"leaked": 42 if bad else 0,
                           "balance_ok": not bad},
        }

    monkeypatch.setattr(soak, "run_soak", fake_run_soak)
    doc = soak.shrink(spec)
    assert [w["kind"] for w in doc["schedule"]] == ["partition"]
    assert doc["probes"] == len(probe_dirs) >= 2
    assert all(d.startswith("probe-") for d in probe_dirs)
    assert doc["violation"]["accounting_leaked"] == 42
    assert doc["violation"]["liveness_advanced"] is False
    verdict = replay_doc(doc, str(tmp_path / "replay"))
    assert verdict["ok"] is False


def test_shrink_refuses_a_green_schedule(tmp_path, monkeypatch):
    spec = soak.default_spec(str(tmp_path), n_nodes=4, seed=5)
    spec = dataclasses.replace(spec, schedule=smoke_schedule(spec))
    monkeypatch.setattr(
        soak, "run_soak",
        lambda probe: {"ok": True, "safety": {}, "liveness": {},
                       "disruptions_survived": 3, "finality": {},
                       "accounting": {}},
    )
    with pytest.raises(ValueError):
        soak.shrink(spec)


# ------------------------------------------------ the saved soak union


def _ref_oracle_observer(union, n_nodes, seed):
    """The reference's ``oracle_replay`` observer (its function returns only
    the order): the union ingested in topological order, one pass."""
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


def test_soak_union_replay_matches_reference(tmp_path):
    """``UNION_LOG`` through both packages, as chip_smoke.py phase 16(b)
    replays a soak's union on the card: each package's ``read_event_log``
    decodes it, an observer ingests it in ``oracle_replay``'s order, and
    ``_engines_agree(engine="streaming")`` (a batch pass at block 64, then
    the streaming driver in 64-event chunks) gives the reference's row, field
    for field: rebase and widen counts and the store's counters.  The
    union carries the storm's fork pairs from a real cluster, so the
    forkseen hop and the fork-pinned window replay a process log."""
    n, seed = UNION_SPEC["n_nodes"], UNION_SPEC["seed"]
    path = tmp_path / "union.events.bin"
    path.write_bytes(gzip.decompress(open(UNION_LOG, "rb").read()))
    with _signer("ed25519"):
        union = {ev.id: ev for ev in cluster.read_event_log(str(path))}
        ref_union = {ev.id: ev for ev in ref_cluster.read_event_log(str(path))}
        observer = chaos.oracle_observer(
            union, [pk for pk, _ in member_keys(n, seed)],
            SwirldConfig(n_members=n, seed=seed), cluster.observer_keypair(seed),
        )
        ref_observer = _ref_oracle_observer(ref_union, n, seed)
        assert len(observer.order_added) == len(union) == 1842
        assert observer.order_added == ref_observer.order_added
        assert observer.consensus == ref_observer.consensus
        assert len(observer.consensus) == 1804
        assert observer.state_digest() == ref_observer.state_digest()
        assert observer.equivocations_detected == 15
        row = chaos._engines_agree(observer, engine="streaming", device="cpu")
        want = ref_chaos._engines_agree(ref_observer, engine="streaming")
    assert row["batch_oracle_parity"] and row["incremental_batch_parity"], row
    assert set(row) == set(want) | {"seconds"}
    assert chip_smoke.chaos_fields(row) == chip_smoke.chaos_fields(want)
    assert row["incremental_rebases"] == want["incremental_rebases"] > 0
    assert row["widen_rebases"] == want["widen_rebases"]


# ------------------------------------------------ the smoke composition


def _smoke_spec(workdir, **kw):
    spec = soak.default_spec(
        workdir, n_nodes=4, seed=3, horizon_s=6.5,
        tx_rate=120.0, n_clients=3, net=dict(_FAST_NET), **kw,
    )
    return dataclasses.replace(spec, schedule=smoke_schedule(spec))


@pytest.mark.usefixtures("default_signer")
def test_soak_smoke_composition_survives_every_disruption(tmp_path):
    """The production-day smoke through the port's node processes: every
    disruption kind at least once (equivocation storm through the proxy
    seam, kill -9 + WAL recovery, partition/heal), under heavy-tailed
    traffic — composite verdict green, liveness past every window, books
    balanced; then the reference's oracle replay of the port's logs gives
    the order the port's verdict was judged against."""
    spec = _smoke_spec(str(tmp_path))
    kinds = {type(w) for w in spec.schedule}
    assert kinds == {AttackWindow, CrashWindow, PartitionWindow}

    v = soak.run_soak(spec)
    assert v["ok"], json.dumps(
        {k: v[k] for k in ("safety", "liveness", "finality",
                           "accounting", "disruptions_survived")},
        default=str,
    )
    assert v["safety"]["oracle_agree"] and v["safety"]["prefix_agree"]
    assert v["disruptions_survived"] == v["disruptions_total"] == 3
    assert v["proxy"]["relayed"] > 0
    assert v["proxy"]["partition_blocked"] > 0
    assert v["adversary"]["attack_steps"] > 0
    assert v["adversary"]["equivocations_detected"] > 0
    victims = [row for row in v["nodes"] if row["restarts"] >= 1]
    assert victims and all(row["unclean_start"] for row in victims)
    assert v["accounting"]["balance_ok"]
    assert v["accounting"]["leaked"] == 0
    assert v["accounting"]["submitted"] > 0
    honest = [0, 1, 2]
    _r, ref_union, _ = ref_cluster.collect_node_state(spec.workdir, honest, {}, {})
    order = ref_chaos.oracle_replay(
        ref_union, [pk for pk, _ in ref_member_keys(4, 3)],
        RefConfig(n_members=4, seed=3), ref_cluster.observer_keypair(3),
    )
    assert len(order) == v["safety"]["oracle_len"] > 0


# ------------------------------------------------------- the full loop


@pytest.mark.slow
@pytest.mark.usefixtures("default_signer")
def test_soak_mutation_goes_red_shrinks_and_replays(tmp_path):
    spec = _smoke_spec(str(tmp_path), mutate="shed-leak")
    v = soak.run_soak(spec)
    assert not v["ok"]
    assert v["accounting"]["leaked"] > 0
    assert not v["accounting"]["balance_ok"]
    assert v["flightrec_dump"]

    doc = soak.shrink(spec)
    assert doc["schedule"]
    assert doc["probes"] >= 1
    path = save_doc(doc, str(tmp_path / "minimized.schedule.json"))
    replay = replay_doc(load_doc(path), str(tmp_path / "replay"))
    assert not replay["ok"]
    assert replay["accounting"]["leaked"] > 0
    # the reference replays the port's minimized document the same way
    ref_replay = ref_soak.replay_doc(ref_soak.load_doc(path), str(tmp_path / "ref"))
    assert not ref_replay["ok"]


@pytest.mark.slow
def test_soak_membership_window_decides_an_epoch(tmp_path):
    """``soak_run --smoke --membership`` on the port: a DynamicNode cluster
    whose restake window (``KIND_MTX`` to a node) decides and activates a
    second epoch on every honest node, with the smoke's three windows."""
    out = tmp_path / "verdict.json"
    with _signer(DEFAULT_SIGNER):
        from tpu_swirld_torch import soak_run

        rc = soak_run.main(["--smoke", "--membership", "--no-shrink",
                            "--workdir", str(tmp_path / "w"), "--out", str(out)])
    v = json.loads(out.read_text())
    assert rc == 0 and v["ok"], v["membership"]
    assert v["membership"]["dynamic"] and v["membership"]["mtx_sent"] == 1
    assert v["membership"]["epochs_min"] == v["membership"]["epochs_expected"] == 2
    assert v["disruptions_survived"] == v["disruptions_total"] == 4


# ------------------------------------------- the in-process soaks


def _lazy_cpu_engines(monkeypatch):
    """A ``"tpu"`` node that builds its engine at its first pass builds it
    on the CPU (the default device is the card)."""
    monkeypatch.setattr(
        backend, "TorchEngine",
        functools.partial(backend.TorchEngine, device="cpu"),
    )


@pytest.mark.slow
def test_mixed_backend_byzantine_soak(tmp_path, monkeypatch):
    """``tests/test_soak.py``'s first soak on the port: python members, a
    ``backend="tpu"`` member (its engine on the CPU), two divergent
    forkers and a mid-run checkpoint restored."""
    from tpu_swirld_torch.checkpoint import load_node, save_node
    from tpu_swirld_torch.sim import run_with_divergent_forkers

    _lazy_cpu_engines(monkeypatch)
    n_turns = 420
    ckpt = str(tmp_path / "mid.swck")
    saved = {}

    def node_config(i, base):
        if i == 2:
            return dataclasses.replace(base, backend="tpu", block_size=128)
        return base

    def on_turn(turn, honest):
        if turn == n_turns // 2 and not saved:
            save_node(ckpt, honest[0])
            saved["done"] = True

    sim = run_with_divergent_forkers(
        7, 2, n_turns, seed=77, fork_every=3,
        node_config=node_config, on_turn=on_turn,
    )
    honest = sim.nodes
    tpu_node = honest[0]
    assert tpu_node._tpu_engine is not None, "device engine must have run"
    assert tpu_node._tpu_engine.device.type == "cpu"
    orders = [n.consensus for n in honest]
    m = min(len(o) for o in orders)
    assert m > 0
    assert all(o[:m] == orders[0][:m] for o in orders)
    assert len(tpu_node.consensus) > 0
    forker_pks = {f.pk for f in sim.forkers}
    assert any(n.has_fork[p] for n in honest for p in forker_pks)
    assert saved
    restored = load_node(
        ckpt, sk=tpu_node.sk, pk=tpu_node.pk, network=sim.network, device="cpu",
    )
    k = len(restored.consensus)
    assert restored.consensus == tpu_node.consensus[:k]
    got = restored.sync(honest[1].pk, b"resume")
    restored.consensus_pass(got)
    mm = min(len(restored.consensus), len(honest[1].consensus))
    assert restored.consensus[:mm] == honest[1].consensus[:mm]


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_soak_mixed_backend_heavy_faults(tmp_path):
    """``tests/test_soak.py``'s long chaos soak on the port, member 7 on
    ``backend="tpu"`` with its engine and restores on the CPU."""
    from tpu_swirld_torch.transport import FaultPlan, LinkFaults, Partition

    plan = FaultPlan(
        seed=11,
        default=LinkFaults(
            drop=0.25, corrupt=0.08, duplicate=0.08, reorder=0.15, delay=0.08,
        ),
        partitions=[
            Partition(start=200, end=320, group=(2, 3)),
            Partition(start=460, end=540, group=(4, 5)),
        ],
        crashes={5: [(150, 260)], 6: [(400, 520)]},
    )
    scenario = chaos.ChaosScenario(
        n_nodes=8, n_turns=700, seed=11, n_forkers=2, plan=plan,
        checkpoint_every=60, tpu_node_index=7,
    )
    sim = chaos.ChaosSimulation(scenario, str(tmp_path), device="cpu")
    v = sim.run()
    assert v["ok"], v
    assert v["resilience"]["crashes"] == 2
    assert v["resilience"]["restarts"] == 2
    assert v["resilience"]["forks_detected"] >= 1
    assert v["faults"]["drops"] > 0 and v["faults"]["partition_blocked"] > 0
    tpu_node = sim.nodes[7]
    assert tpu_node._tpu_engine is not None, "device engine must have run"
    assert tpu_node._tpu_engine.device.type == "cpu"
    assert len(tpu_node.consensus) > 0
