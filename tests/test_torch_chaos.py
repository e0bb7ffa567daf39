"""The port's fault injection, byzantine simulations and chaos harness on the
CPU (``device="cpu"``: the kernels' plain versions), each held against the
JAX reference run from the same literals and seeds under both packages'
simulation signer.  The tolerance is exact throughout: fault draws, replies,
``stats``, node state digests (turn by turn in the acceptance scenario) and
the chaos verdicts' protocol fields (``chip_smoke.chaos_fields``: wall times
and the flight recorder's path left out, the oracle replay's order digest
added) must be equal.

The reference verdicts here are also ``chip_smoke.CHAOS_GOLDEN``'s recompute
for the acceptance scenario and the storms (the adversary strategies' legs
are in ``tests/test_torch_adversary.py``)."""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from tpu_swirld import chaos as ref_chaos
from tpu_swirld import checkpoint as ref_checkpoint
from tpu_swirld import crypto as ref_crypto
from tpu_swirld import sim as ref_sim
from tpu_swirld import transport as ref_transport
from tpu_swirld_torch import (
    TorchEngine, backend, chaos, crypto, load_node, sim, transport,
)

pytestmark = pytest.mark.chaos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORMS = ("horizon_storm", "overflow_storm", "membership_churn")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tiny ops: torch's CPU thread pool costs far more than it saves here
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", autouse=True)
def sim_signer():
    """Both packages' crypto backends set to the simulation signer (event
    ids depend on the signer), restored afterwards."""
    prev = ref_crypto.backend_name(), crypto.backend_name()
    ref_crypto.set_backend("sim")
    crypto.set_backend("sim")
    try:
        yield
    finally:
        ref_crypto.set_backend(prev[0])
        crypto.set_backend(prev[1])


def _lazy_cpu_engines(monkeypatch):
    """A ``"tpu"`` node that builds its engine at its first pass builds it
    on the CPU (the default device is the card)."""
    monkeypatch.setattr(
        backend, "TorchEngine",
        functools.partial(backend.TorchEngine, device="cpu"),
    )


# ------------------------------------------------------------ transport


def _echo_network(n):
    members = [bytes([i + 1]) * 32 for i in range(n)]
    network = {
        m: (lambda src, req, m=m: b"reply:" + m[:1] + req) for m in members
    }
    return members, network


def _outcomes(mod, plan, members, network, calls, down=(), clock=0):
    ft = mod.FaultyTransport(network, {}, plan, members, lambda: clock)
    for i in down:
        ft.set_down(members[i])
    out = []
    for s, d, payload in calls:
        try:
            out.append(ft.call(members[s], members[d], "sync", payload))
        except mod.TransportError as e:
            out.append(type(e).__name__)
    return out, dict(ft.stats)


@pytest.mark.parametrize("seed", [0, 9])
def test_faulty_transport_matches_reference(seed):
    members, network = _echo_network(4)
    rng = np.random.default_rng(seed)
    calls = [
        (int(s), int(d), bytes(rng.integers(0, 256, int(rng.integers(0, 40)),
                                            dtype=np.uint8)))
        for s, d in rng.integers(0, 4, (400, 2)) if s != d
    ]

    def plan(mod):
        return mod.FaultPlan(
            seed=seed,
            default=mod.LinkFaults(
                drop=0.2, corrupt=0.3, duplicate=0.2, reorder=0.2, delay=0.1
            ),
            links={(0, 1): mod.LinkFaults(drop=0.6, corrupt=0.6)},
            partitions=[mod.Partition(start=5, end=9, group=(2,))],
        )

    for clock, down in ((0, ()), (6, ()), (0, (3,))):
        want = _outcomes(ref_transport, plan(ref_transport), members, network,
                         calls, down, clock)
        got = _outcomes(transport, plan(transport), members, network, calls,
                        down, clock)
        assert got == want
    assert want[1]["crash_blocked"] > 0


def test_fault_plan_and_corrupt_match_reference():
    for mod in (ref_transport, transport):
        lf = mod.LinkFaults()
        # proxy-only knobs, never applied in process
        assert (lf.reset, lf.delay_s, lf.throttle_bps) == (0.0, 0.0, 0.0)
    plans = [
        mod.FaultPlan(
            partitions=[mod.Partition(3, 7, (0, 1)), mod.Partition(5, 12, (2,))],
            crashes={3: [(2, 4), (8, 15)]},
        )
        for mod in (ref_transport, transport)
    ]
    for t in range(16):
        for s in range(4):
            for d in range(4):
                assert plans[1].partitioned(s, d, t) == plans[0].partitioned(s, d, t)
    assert plans[1].heal_time() == plans[0].heal_time() == 15
    datas = [b"", b"x", bytes(range(200))]
    for seed in range(20):
        want = [ref_transport.FaultyTransport._corrupt(
            d, np.random.default_rng(seed)) for d in datas]
        got = [transport.FaultyTransport._corrupt(
            d, np.random.default_rng(seed)) for d in datas]
        assert got == want


def test_fault_streams_order_independent():
    """A link's faults are a function of (plan seed, src, dst, call number):
    another interleaving of the same per-link calls gives the same per-link
    outcomes."""
    members, network = _echo_network(3)
    plan = transport.FaultPlan(
        seed=9, default=transport.LinkFaults(
            drop=0.3, corrupt=0.3, duplicate=0.2, reorder=0.2, delay=0.1
        ),
    )
    links = [(0, 1), (1, 0), (0, 2), (2, 1)]

    def per_link(order):
        out, _ = _outcomes(transport, plan, members, network,
                           [(s, d, b"p") for s, d in order])
        res = {link: [] for link in links}
        for link, r in zip(order, out):
            res[link].append(r)
        return res

    grouped = [link for link in links for _ in range(16)]
    interleaved = [link for _ in range(16) for link in links]
    assert per_link(grouped) == per_link(interleaved)


# ------------------------------------------------- byzantine simulations


def _faulty_factory(mod):
    def factory(network, network_want, members, clock):
        return mod.FaultyTransport(
            network, network_want,
            mod.FaultPlan(seed=5, default=mod.LinkFaults(drop=0.15, reorder=0.1)),
            members, clock,
        )
    return factory


def _digests(nodes):
    return [n.state_digest() for n in nodes]


def test_run_with_forkers_matches_reference():
    want = ref_sim.run_with_forkers(
        5, 1, 220, seed=5, fork_every=6,
        transport_factory=_faulty_factory(ref_transport),
    )
    got = sim.run_with_forkers(
        5, 1, 220, seed=5, fork_every=6,
        transport_factory=_faulty_factory(transport),
    )
    assert _digests(got.nodes) == _digests(want.nodes)
    assert dict(got.transport.stats) == dict(want.transport.stats)
    assert got.transport.stats["drops"] > 0
    assert any(n.has_fork[got.nodes[0].pk] for n in got.nodes)


def test_run_with_divergent_forkers_matches_reference(monkeypatch):
    """One honest member on ``backend="tpu"`` (its engine on the CPU), the
    rest oracle nodes, with a faulty transport: every honest node's state and
    the forkers' branch stores equal the reference's, on every turn."""
    _lazy_cpu_engines(monkeypatch)

    def node_config(i, base):
        # lazy batching (a pass per 24 new events) keeps the reference's
        # per-shape compiles few; both engines batch alike
        return dataclasses.replace(
            base, backend="tpu", block_size=128, tpu_min_batch=24
        ) if i == 3 else base

    def run(mod, tmod):
        states = []
        out = mod.run_with_divergent_forkers(
            5, 1, 160, seed=2, node_config=node_config,
            on_turn=lambda turn, honest: states.append(_digests(honest)),
            transport_factory=_faulty_factory(tmod),
        )
        return out, states

    want, want_states = run(ref_sim, ref_transport)
    got, got_states = run(sim, transport)
    assert got_states == want_states
    assert [[sorted(b.hg) for b in f.branches] for f in got.forkers] == \
        [[sorted(b.hg) for b in f.branches] for f in want.forkers]
    tpu = got.nodes[2]
    assert isinstance(tpu._tpu_engine, TorchEngine)
    assert tpu._tpu_engine.device.type == "cpu" and tpu._tpu_engine.n_passes > 0
    assert len(tpu.consensus) > 0


def test_make_straggler_event_matches_reference():
    want_sim = ref_sim.make_simulation(4, seed=6)
    want_sim.run(200)
    got_sim = sim.make_simulation(4, seed=6)
    got_sim.run(200)
    keys = ref_sim.member_keys(4, 6)
    for at_round in (1, 2):
        pk, sk = keys[3]
        want = ref_sim.make_straggler_event(want_sim.nodes[0], pk, sk, at_round=at_round)
        got = sim.make_straggler_event(got_sim.nodes[0], pk, sk, at_round=at_round)
        assert (got.id, got.p, got.t, got.d) == (want.id, want.p, want.t, want.d)
    for mod, s in ((ref_sim, want_sim), (sim, got_sim)):
        with pytest.raises(ValueError):
            mod.make_straggler_event(s.nodes[0], keys[3][0], keys[3][1], at_round=0)


@pytest.mark.parametrize("delay_prob", [0.0, 0.2])
def test_stream_schedules_match_reference(delay_prob):
    kw = dict(n_forkers=2, fork_prob=0.2)
    members, stake, events, _keys = sim.generate_gossip_dag(6, 700, seed=4, **kw)
    ref_events = ref_sim.generate_gossip_dag(6, 700, seed=4, **kw)[2]
    assert [e.id for e in events] == [e.id for e in ref_events]
    got = sim.chunked_ingest_schedule(events, 64, delay_prob=delay_prob, seed=7)
    want = ref_sim.chunked_ingest_schedule(ref_events, 64, delay_prob=delay_prob,
                                           seed=7)
    assert [[e.id for e in c] for c in got] == [[e.id for e in c] for c in want]
    assert sorted(e.id for c in got for e in c) == sorted(e.id for e in events)
    s_members, s_stake, s_keys, chunks = sim.stream_gossip_dag(6, 700, 64, seed=4, **kw)
    chunks = list(chunks)
    assert (s_members, s_stake) == (members, stake)
    assert [e.id for c in chunks for e in c] == [e.id for e in events]
    want_chunks = list(ref_sim.stream_gossip_dag(6, 700, 64, seed=4, **kw)[3])
    assert [[e.id for e in c] for c in chunks] == [[e.id for e in c] for c in want_chunks]


def test_straggler_reindex_matches_batch():
    """``chip_smoke.reindex`` moves a driver's arrival-order result back to
    creation order: a driver fed the straggler schedule then equals the
    batch pass over the creation-order DAG (what phase 14(c) holds to the
    golden digests)."""
    from tpu_swirld_torch import IncrementalConsensus
    from tpu_swirld_torch.gpu.pipeline import run_consensus
    from tpu_swirld_torch.packing import pack_events

    members, stake, events, _keys = sim.generate_gossip_dag(8, 900, seed=3,
                                                           n_forkers=2)
    chunks = sim.chunked_ingest_schedule(events, 150, delay_prob=0.05,
                                         max_delay=3, seed=1)
    inc = IncrementalConsensus(members, stake, block=64, chunk=64,
                               window_bucket=256, prune_min=64, device="cpu")
    for chunk in chunks:
        inc.ingest(chunk)
    packed = pack_events(events, members, stake)
    arrival = [e.id for c in chunks for e in c]
    assert arrival != list(packed.ids)
    got = chip_smoke.result_digests(
        packed, chip_smoke.reindex(inc.result(), arrival, packed.ids))
    want = chip_smoke.result_digests(packed, run_consensus(packed, device="cpu"))
    assert got == want


# ------------------------------------------------ the acceptance scenario


@pytest.fixture(scope="module")
def acceptance(tmp_path_factory):
    """The acceptance scenario in both packages, with and without member 4
    on ``backend="tpu"``: ``{tpu: (ref sim, ref verdict fields, ref states,
    port sim, port fields, port states, checkpoint dirs)}``, states being
    every live honest node's digest after every turn."""
    out = {}
    for tpu in (None, chip_smoke.CHAOS_TPU_NODE):
        runs = []
        for cmod, tmod, kw in ((ref_chaos, ref_transport, {}),
                               (chaos, transport, {"device": "cpu"})):
            states = []
            d = str(tmp_path_factory.mktemp("acceptance"))
            with chip_smoke.oracle_orders(cmod) as orders:
                s = cmod.ChaosSimulation(
                    chip_smoke.acceptance_scenario(cmod, tmod, tpu), d,
                    on_turn=lambda turn, s: states.append(
                        {i: n.state_digest() for i, n in s.nodes.items()
                         if n is not None}),
                    **kw,
                )
                v = s.run()
            runs += [s, chip_smoke.chaos_fields(v, orders), states, d]
        out[tpu] = runs
    return out


@pytest.mark.parametrize("tpu", [None, 4])
def test_acceptance_scenario_matches_reference(acceptance, tpu):
    ref, want, want_states, _d, port, got, got_states, _pd = acceptance[tpu]
    assert got_states == want_states
    assert got == want
    assert got["ok"] and got["resilience"]["restarts"] == 1
    assert got["faults"]["drops"] > 0 and got["faults"]["partition_blocked"] > 0
    assert got["faults"]["crash_blocked"] > 0 and got["faults"]["reorders"] > 0
    for i, node in port.nodes.items():
        assert node.state_digest() == ref.nodes[i].state_digest()
    node = port.nodes[4]
    if tpu is None:
        assert node.config.backend == "python" and node._tpu_engine is None
    else:
        # the restored node's engine (built by load_node) ran on the device
        # it was given, past the restore's own pass
        eng = node._tpu_engine
        assert node.config.backend == "tpu"
        assert isinstance(eng, TorchEngine) and eng.device.type == "cpu"
        assert eng.n_passes >= 2 and eng.last_result.n == len(node.hg)
        assert set(node.restore_seconds) == {"replay", "pass"}


def test_acceptance_golden_matches_reference(acceptance):
    """Recompute ``chip_smoke.CHAOS_GOLDEN["acceptance"]``: the reference's
    verdict with member 4 on ``backend="tpu"``, the same as without it."""
    assert acceptance[4][1] == chip_smoke.CHAOS_GOLDEN["acceptance"]
    assert acceptance[None][1] == chip_smoke.CHAOS_GOLDEN["acceptance"]


@pytest.mark.parametrize("i", [2, 4])
def test_reference_checkpoint_restores_in_port(acceptance, i):
    """A checkpoint the reference's chaos run wrote (node 4's a ``"tpu"``
    node's, header and all) restores in the port's ``load_node(device=
    "cpu")`` to the reference's own restore of it."""
    ref_sim_, _f, _s, ckpt_dir = acceptance[4][:4]
    path = os.path.join(ckpt_dir, f"node-{i}.swck")
    pk, sk = ref_sim_.keys[i]
    want = ref_checkpoint.load_node(path, sk=sk, pk=pk, network={})
    got = load_node(path, sk=sk, pk=pk, network={}, device="cpu")
    assert got.state_digest() == want.state_digest()
    assert got.config.backend == want.config.backend
    if i == 4:
        assert got.config.backend == "tpu"
        assert got._tpu_engine.device.type == "cpu"


def test_chaos_run_reproducible_and_validated(tmp_path):
    sc = chip_smoke.acceptance_scenario(chaos, transport, None)
    v1 = chaos.ChaosSimulation(sc, str(tmp_path / "a"), device="cpu").run()
    v2 = chaos.run_chaos(sc, str(tmp_path / "b"), device="cpu")
    assert v1 == v2
    bad = chaos.ChaosScenario(
        n_nodes=4, n_turns=50, plan=transport.FaultPlan(
            partitions=[transport.Partition(start=10, end=60, group=(0,))]),
    )
    with pytest.raises(ValueError):
        chaos.ChaosSimulation(bad, str(tmp_path / "c"), device="cpu")
    bad = chaos.ChaosScenario(
        n_nodes=4, n_turns=50, plan=transport.FaultPlan(crashes={1: [(0, 10)]}))
    with pytest.raises(ValueError):
        chaos.ChaosSimulation(bad, str(tmp_path / "d"), device="cpu")
    # a whole-cluster outage plays out as dead air
    sc = chaos.ChaosScenario(
        n_nodes=2, n_turns=80, seed=1,
        plan=transport.FaultPlan(crashes={0: [(5, 20)], 1: [(5, 20)]}),
        checkpoint_every=4,
    )
    v = chaos.ChaosSimulation(sc, str(tmp_path / "e"), device="cpu").run()
    assert v["resilience"]["crashes"] == v["resilience"]["restarts"] == 2


# ----------------------------------------------------------- the storms


def _horizon_rows_spy(monkeypatch, rows):
    """The reference's horizon storm replays one engine; record its probe
    node's rows for every ``chip_smoke.CHAOS_ENGINES`` driver, as the port's
    ``run_horizon_storm(engine=tuple)`` reports them."""
    agree = ref_chaos._engines_agree

    def spy(node, engine="incremental"):
        rows.extend(agree(node, engine=e) for e in chip_smoke.CHAOS_ENGINES)
        return rows[0]

    monkeypatch.setattr(ref_chaos, "_engines_agree", spy)


def reference_storm_fields(name, ckpt_dir, monkeypatch):
    """The reference's verdict fields of the storm ``name`` as phase 14(b)
    runs it (``horizon_storm`` through ``CHAOS_ENGINES``)."""
    from tpu_swirld.adversary import SCENARIOS as REF_SCENARIOS

    rows = []
    if name == "horizon_storm":
        _horizon_rows_spy(monkeypatch, rows)
    with chip_smoke.oracle_orders(ref_chaos) as orders:
        v = REF_SCENARIOS[name](ckpt_dir)
    if rows:
        v["engines"] = rows
        v["ok"] = bool(v["ok"] and all(
            r["batch_oracle_parity"] and r["incremental_batch_parity"] for r in rows))
    return chip_smoke.chaos_fields(v, orders)


@pytest.mark.parametrize("name", STORMS)
def test_storm_matches_reference_and_golden(name, tmp_path, monkeypatch):
    from tpu_swirld_torch.adversary import SCENARIOS

    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    want = reference_storm_fields(name, str(tmp_path / "r"), monkeypatch)
    engine = (chip_smoke.CHAOS_ENGINES if name in chip_smoke.CHAOS_MULTI
              else "incremental")
    with chip_smoke.oracle_orders(chaos) as orders:
        v = SCENARIOS[name](str(tmp_path / "p"), engine=engine, device="cpu")
    got = chip_smoke.chaos_fields(v, orders)
    assert got == want
    assert want == chip_smoke.CHAOS_GOLDEN[name]
    assert v["ok"]
    if name == "horizon_storm":
        assert [r["engine"] for r in v["engines"]] == list(chip_smoke.CHAOS_ENGINES)
        assert v["horizon"]["late_witnesses"] > 0
        assert v["engines"][2]["mesh_devices"] == chaos.MESH_SHARDS
    if name == "overflow_storm":
        assert v["fork_storm"]["overflow_retries"] >= 1
        assert v["round_clamp"]["overflow_retries"] >= 1
    assert chip_smoke.device_seconds(v) > 0


def test_engines_agree_row_matches_reference(tmp_path):
    """``_engines_agree``'s streaming row on the acceptance scenario's
    densest node: the reference's keys (plus ``seconds``) and values; an
    unknown engine raises."""
    s = chaos.ChaosSimulation(
        chip_smoke.acceptance_scenario(chaos, transport, None), str(tmp_path),
        device="cpu",
    )
    s.run()
    probe = max(s._live_honest(), key=lambda n: len(n.hg))
    row = chaos._engines_agree(probe, "streaming", device="cpu")
    ref = ref_chaos.ChaosSimulation(
        chip_smoke.acceptance_scenario(ref_chaos, ref_transport, None),
        str(tmp_path / "r"),
    )
    ref.run()
    want = ref_chaos._engines_agree(
        max(ref._live_honest(), key=lambda n: len(n.hg)), "streaming")
    assert set(row) == set(want) | {"seconds"}
    assert chip_smoke.chaos_fields(row) == chip_smoke.chaos_fields(want)
    with pytest.raises(ValueError, match="unknown engine"):
        chaos._engines_agree(probe, "batch", device="cpu")


# ------------------------------------------------------ the command line


def _cli(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "tpu_swirld_torch.chaos_run", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, **(env or {})),
    )


def test_chaos_run_cli(tmp_path):
    r = _cli("--scenario", "list")
    assert r.returncode == 0, r.stderr
    names = [line.split()[0] for line in r.stdout.splitlines()]
    from tpu_swirld_torch.adversary import SCENARIOS

    assert names == ["acceptance", *SCENARIOS]
    out = tmp_path / "verdict.json"
    r = _cli("--scenario", "overflow_storm", "--device", "cpu", "--out", str(out))
    assert r.returncode == 0, r.stdout + r.stderr
    v = json.loads(out.read_text())
    assert v["ok"] and v["fork_storm"]["parity"] and v["round_clamp"]["parity"]
    assert (tmp_path / "verdict.trace.jsonl").exists()
    # the default device is the card: without one the run fails, never
    # falling back to the CPU
    r = _cli("--scenario", "overflow_storm", "--out", str(tmp_path / "x.json"),
             env={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not (tmp_path / "x.json").exists()
