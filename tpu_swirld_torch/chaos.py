"""Chaos harness: end-to-end fault-injection scenarios with verdicts (copy of
the reference's ``tpu_swirld/chaos.py``).

:class:`ChaosSimulation` composes every resilience mechanism in one run:

- gossip routed through a :class:`~tpu_swirld_torch.transport.FaultyTransport`
  (seeded drops, corruption, duplication, reordering and delays; scheduled
  partitions);
- node-side retry and backoff, counted rejections and circuit-breaker
  quarantine (``config.quarantine_forkers`` is on: detected equivocators are
  cut off directly and reach honest nodes only through relays);
- peer crashes: a crashed member loses its in-memory state (its endpoints
  are torn down), then restarts from its last
  :mod:`tpu_swirld_torch.checkpoint` file plus its own-event WAL, the BFT
  rule that a signer never lose its own signing history (without it a
  restart re-signs at an old sequence number and equivocates against its
  own lost tip).  Restore replays forward through gossip, with pull-only
  recovery sweeps before the node creates new events;
- optional byzantine members (:class:`~tpu_swirld_torch.sim.DivergentForker`
  and the drivers of :mod:`tpu_swirld_torch.adversary`) on the same faulty
  transport, so network and byzantine faults compose.

The run's verdict asserts the two protocol claims:

- *safety*: every honest node's decided order is a prefix of a fault-free
  oracle replay (a fresh observer that ingests the union of the honest
  stores and recomputes consensus from scratch), and the honest decided
  prefixes agree pairwise;
- *liveness*: decided rounds advance after partitions heal and crashed
  nodes restart.

The card enters at four points, each on the ``device`` a simulation or
runner is given (default ``"cuda"``, which raises without a GPU; pass
``device="cpu"`` for the kernels' plain versions): the
``ChaosScenario.tpu_node_index`` member's
:class:`~tpu_swirld_torch.backend.TorchEngine`, its restore through
:func:`~tpu_swirld_torch.checkpoint.load_node`, the cross-engine replays of
:func:`_engines_agree` and the device runs of :func:`run_overflow_storm` and
:func:`run_membership_churn`.

Scenarios are reproducible from ``(scenario.seed, plan.seed)``;
``python -m tpu_swirld_torch.chaos_run`` is the command line.  Three named
scenarios ride the same machinery: :func:`run_horizon_storm` (straggler
witnesses across a healing partition, with a cross-engine parity verdict),
:func:`run_overflow_storm` (witness-table self-healing: fork-storm slot
doubling and the unclamped round-window retry) and
:func:`run_membership_churn` (an adversary joins, equivocates and is voted
out).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Callable, Dict, List, Optional

from tpu_swirld_torch.checkpoint import load_node, save_node
from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.oracle.graph import toposort
from tpu_swirld_torch.oracle.node import Node
from tpu_swirld_torch.sim import DivergentForker, attach_obs, build_population
from tpu_swirld_torch.transport import FaultPlan, FaultyTransport, Partition


def resolve_device(device):
    """:func:`tpu_swirld_torch.device.resolve_device`, imported at its first
    call: the verdict helpers below load no ``torch`` (the cluster
    supervisor of :mod:`tpu_swirld_torch.net.cluster` runs them)."""
    from tpu_swirld_torch.device import resolve_device as _resolve

    return _resolve(device)


def oracle_replay(
    union: Dict[bytes, "object"],
    members: List[bytes],
    config: SwirldConfig,
    observer_key,
    node_cls: type = None,
) -> List[bytes]:
    """Fault-free ground truth for a union event store: a fresh observer
    ingests ``union`` (id -> Event) in deterministic topo order and
    recomputes consensus from scratch.  Consensus is a pure function of
    the DAG, so this is the order every honest participant must have
    decided a prefix of."""
    return oracle_observer(union, members, config, observer_key, node_cls).consensus


def oracle_observer(
    union: Dict[bytes, "object"],
    members: List[bytes],
    config: SwirldConfig,
    observer_key,
    node_cls: type = None,
) -> Node:
    """The observer node of :func:`oracle_replay`, after its one pass (the
    DAG that :func:`_engines_agree` replays on the card)."""
    ordered = toposort(
        sorted(union, key=lambda e: (union[e].t, e)),
        lambda e: [p for p in union[e].p],
    )
    pk, sk = observer_key
    # node_cls: a dynamic-membership population must be replayed by a
    # DynamicNode observer — a static observer would keep genesis stake
    # past decided epoch boundaries and diverge from every honest node
    observer = (node_cls or Node)(
        sk=sk, pk=pk, network={}, members=members,
        config=config, create_genesis=False,
    )
    new_ids = []
    for eid in ordered:
        if observer.add_event(union[eid]):
            new_ids.append(eid)
    observer.consensus_pass(new_ids)
    return observer


def safety_section(
    orders: List[List[bytes]], oracle: List[bytes],
) -> Dict:
    """The verdict's safety block: all honest decided orders agree on
    their common prefix AND each is bit-identical to a prefix of the
    fault-free oracle replay."""
    m = min(len(o) for o in orders) if orders else 0
    return {
        "prefix_agree": all(o[:m] == orders[0][:m] for o in orders),
        "oracle_agree": all(o == oracle[:len(o)] for o in orders),
        "common_prefix_len": m,
        "oracle_len": len(oracle),
    }


def liveness_section(
    decided_final: int,
    decided_at_heal: Optional[int],
    heal_turn,
) -> Dict:
    """The verdict's liveness block: the decided frontier advanced past
    the last fault window (``heal_turn == 0`` means a fault-free run —
    any progress counts)."""
    heal_base = decided_at_heal if decided_at_heal is not None else 0
    return {
        "decided_at_heal": heal_base,
        "decided_final": decided_final,
        "advanced_after_heal": decided_final > heal_base or heal_turn == 0,
        "heal_turn": heal_turn,
    }


def verdict_ok(safety: Dict, liveness: Dict) -> bool:
    """The one-bit summary both harnesses gate on."""
    return bool(
        safety["prefix_agree"] and safety["oracle_agree"]
        and liveness["decided_final"] > 0
        and liveness["advanced_after_heal"]
    )


@dataclasses.dataclass
class ChaosScenario:
    """One seeded chaos run: population shape + fault schedule.

    ``plan.crashes`` / ``plan.partitions`` use member indices; crash
    windows must name honest members (indices >= ``n_forkers`` and not in
    ``adversaries``) and close before ``n_turns`` so the liveness claim
    is testable.

    ``adversaries`` installs active byzantine drivers from
    :mod:`tpu_swirld_torch.adversary`: member index -> ``factory(sim, index)``
    returning an object with ``ask_sync`` / ``ask_events`` endpoints and
    an optional ``step(turn, honest_pks)`` called every turn.  These
    compose with the legacy ``n_forkers`` divergent forkers and with the
    fault plan — byzantine and network faults share one transport.
    ``attack_end`` extends the liveness horizon: decided progress is
    measured after ``max(plan.heal_time(), attack_end)``, so a timed
    attack window counts as a fault the run must recover from.
    """

    n_nodes: int = 5
    n_turns: int = 300
    seed: int = 0
    n_forkers: int = 0
    fork_every: int = 3
    plan: FaultPlan = dataclasses.field(default_factory=FaultPlan)
    checkpoint_every: int = 50
    recovery_pull_rounds: int = 3   # max pull-only sweeps after a restart
    tpu_node_index: Optional[int] = None  # honest member on backend="tpu"
    adversaries: Optional[Dict[int, Callable]] = None  # index -> factory
    attack_end: int = 0             # last turn of the attack window

    def byzantine_indices(self) -> set:
        byz = set(range(self.n_forkers))
        if self.adversaries:
            byz.update(self.adversaries)
        return byz

    def config(self) -> SwirldConfig:
        return SwirldConfig(
            n_members=self.n_nodes, seed=self.seed, quarantine_forkers=True
        )


class ChaosSimulation:
    """Drive one :class:`ChaosScenario` and produce a verdict.

    ``device`` (default ``"cuda"``, which raises without a GPU) is where the
    ``tpu_node_index`` member's :class:`~tpu_swirld_torch.backend.
    TorchEngine` runs its passes, before and after a restore."""

    def __init__(
        self,
        scenario: ChaosScenario,
        ckpt_dir: str,
        metrics=None,
        tracer=None,
        on_turn: Optional[Callable[[int, "ChaosSimulation"], None]] = None,
        flightrec=None,
        finality: Optional[bool] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        sc = scenario
        byz = sc.byzantine_indices()
        heal = max(sc.plan.heal_time(), sc.attack_end)
        if heal >= sc.n_turns:
            raise ValueError(
                f"fault schedule ends at t={heal} but the run is only "
                f"{sc.n_turns} turns; liveness-after-heal is untestable"
            )
        for idx, windows in sc.plan.crashes.items():
            if idx in byz:
                raise ValueError("crash windows must name honest members")
            for down, up in windows:
                # down >= 1 so the turn-0 checkpoint exists to restore from
                if not 1 <= down < up:
                    raise ValueError(f"bad crash window {(down, up)}")
        self.scenario = sc
        self.ckpt_dir = ckpt_dir
        os.makedirs(ckpt_dir, exist_ok=True)
        self.metrics = metrics
        self.tracer = tracer
        self.flightrec = flightrec
        # per-node finality trackers default on whenever metrics flow (the
        # histograms land in the same registry the verdict exports from)
        self.finality = bool(metrics) if finality is None else bool(finality)
        self.config = sc.config()
        pop = build_population(
            sc.n_nodes, sc.seed,
            transport_factory=lambda network, want, members, clock:
                FaultyTransport(network, want, sc.plan, members, clock),
        )
        self.rng = pop.rng
        self.keys = pop.keys
        self.members = pop.members
        self.network: Dict[bytes, Callable] = pop.network
        self.network_want: Dict[bytes, Callable] = pop.network_want
        self.clock = pop.clock
        self.transport: FaultyTransport = pop.transport
        self.forkers: List[DivergentForker] = []
        self.adversary_drivers: List = []   # active drivers (adversary.py)
        # honest nodes indexed by MEMBER index (None while crashed)
        self.nodes: Dict[int, Optional[Node]] = {}
        adversaries = sc.adversaries or {}
        for i, (pk, sk) in enumerate(self.keys):
            if i < sc.n_forkers:
                f = DivergentForker(
                    sk, pk, self.members, self.network, self.network_want,
                    self.config, lambda: self.clock[0], self.rng,
                    transport=self.transport,
                )
                self.network[pk] = f.ask_sync
                self.network_want[pk] = f.ask_events
                self.forkers.append(f)
            elif i in adversaries:
                drv = adversaries[i](self, i)
                self.network[pk] = drv.ask_sync
                self.network_want[pk] = drv.ask_events
                self.adversary_drivers.append(drv)
            else:
                self.nodes[i] = self._make_node(i)
        self.on_turn = on_turn
        self.crashes = 0
        self.restarts = 0
        # own-event WAL: the durable log of each member's self-signed
        # events since its last checkpoint (see the module docstring)
        self._wal: Dict[int, List] = {i: [] for i in self.nodes}
        self._decided_at_heal: Optional[int] = None
        self._heal_t = heal

    # ----------------------------------------------------------- plumbing

    def _node_config(self, i: int) -> SwirldConfig:
        if self.scenario.tpu_node_index == i:
            return dataclasses.replace(
                self.config, backend="tpu", block_size=128
            )
        return self.config

    def _make_node(self, i: int) -> Node:
        pk, sk = self.keys[i]
        node = Node(
            sk=sk, pk=pk, network=self.network, members=self.members,
            config=self._node_config(i), clock=lambda: self.clock[0],
            network_want=self.network_want, transport=self.transport,
        )
        if node.config.backend == "tpu":
            from tpu_swirld_torch.backend import TorchEngine

            node._tpu_engine = TorchEngine(node, device=self.device)
        attach_obs(
            node, self.metrics, self.tracer, finality=self.finality,
            flightrec=self.flightrec, label=f"n{i}",
        )
        self.network[pk] = node.ask_sync
        self.network_want[pk] = node.ask_events
        return node

    def _ckpt_path(self, i: int) -> str:
        return os.path.join(self.ckpt_dir, f"node-{i}.swck")

    def _crash(self, i: int) -> None:
        """Kill member i: all in-memory state is lost, endpoints torn
        down, and the transport refuses routes until restart."""
        pk = self.members[i]
        self.nodes[i] = None
        self.network.pop(pk, None)
        self.network_want.pop(pk, None)
        self.transport.set_down(pk)
        self.crashes += 1

    def _restore(self, i: int) -> None:
        """Restart member i from its last checkpoint + own-event WAL and
        replay forward: WAL events whose other-parents are not in the
        checkpoint park as orphans; the recovery sweeps' want-list
        round-trips fetch those parents, draining the orphans and moving
        the node's head back to its true pre-crash tip — so new events
        extend the chain instead of equivocating against it."""
        pk, sk = self.keys[i]
        node = load_node(
            self._ckpt_path(i), sk=sk, pk=pk, network=self.network,
            network_want=self.network_want, clock=lambda: self.clock[0],
            transport=self.transport, device=self.device,
        )
        attach_obs(
            node, self.metrics, self.tracer, finality=self.finality,
            flightrec=self.flightrec, label=f"n{i}",
        )
        self.transport.set_up(pk)
        self.network[pk] = node.ask_sync
        self.network_want[pk] = node.ask_events
        self.nodes[i] = node
        self.restarts += 1
        wal_ids: List[bytes] = []
        node._ingest(self._wal[i], wal_ids)
        if wal_ids:
            node.consensus_pass(wal_ids)
        for _ in range(max(0, self.scenario.recovery_pull_rounds)):
            progress = False
            for peer in self.members:
                if peer == pk or peer in self.transport.down:
                    continue
                got = node.pull(peer)
                if got:
                    node.consensus_pass(got)
                    progress = True
            if not progress and not node._orphans:
                break

    def _checkpoint_all(self) -> None:
        for i, node in self.nodes.items():
            if node is not None:
                save_node(self._ckpt_path(i), node)
                # the checkpoint covers everything it ingested; entries a
                # restored node has not re-learned yet stay durable
                self._wal[i] = [
                    ev for ev in self._wal[i] if ev.id not in node.hg
                ]

    def _live_honest(self) -> List[Node]:
        return [n for n in self.nodes.values() if n is not None]

    def _min_decided(self) -> int:
        live = self._live_honest()
        return min(len(n.consensus) for n in live) if live else 0

    # ---------------------------------------------------------------- run

    def run(self) -> Dict:
        sc = self.scenario
        honest_pks = [self.members[i] for i in self.nodes]
        for turn in range(sc.n_turns):
            self.clock[0] = turn
            for idx, windows in sc.plan.crashes.items():
                for down, up in windows:
                    if turn == down and self.nodes.get(idx) is not None:
                        self._crash(idx)
                    elif turn == up and self.nodes.get(idx) is None:
                        self._restore(idx)
            if turn % max(1, sc.checkpoint_every) == 0:
                self._checkpoint_all()
            live = [i for i, n in self.nodes.items() if n is not None]
            if not live:
                continue   # whole-cluster outage window: dead air
            ni = live[self.rng.randrange(len(live))]
            node = self.nodes[ni]
            peers = [pk for pk in self.members if pk != node.pk]
            peer = peers[self.rng.randrange(len(peers))]
            wal = self._wal[ni]
            if wal and node.head != wal[-1].id:
                # restored but its own signing tail is still orphaned
                # (e.g. restarted inside a partition): pull-only turns —
                # signing now would equivocate against the lost tip
                got = node.pull(peer)
                if got:
                    node.consensus_pass(got)
            else:
                prev_head = node.head
                new_ids = node.sync(peer, b"tx:%d:%d" % (ni, turn))
                node.consensus_pass(new_ids)
                if node.head != prev_head:
                    wal.append(node.hg[node.head])
                if self.flightrec is not None:
                    self.flightrec.record_turn(
                        f"n{ni}", turn, decided=len(node.consensus),
                        new=len(new_ids),
                    )
            if sc.n_forkers and turn % max(1, sc.fork_every) == 0:
                for f in self.forkers:
                    f.step(honest_pks)
            for drv in self.adversary_drivers:
                step = getattr(drv, "step", None)
                if step is not None:
                    step(turn, honest_pks)
            if turn == self._heal_t:
                self._decided_at_heal = self._min_decided()
            if self.on_turn is not None:
                self.on_turn(turn, self)
        # any member still down at the end comes back for the verdict
        for idx, node in list(self.nodes.items()):
            if node is None:
                self._restore(idx)
        v = self.verdict()
        v["flightrec_dump"] = self.flightrec_postmortem(v)
        return v

    # ------------------------------------------------------------ verdict

    def decided_frontier(self) -> Dict[str, Dict[str, int]]:
        """Per-node decided state (what a post-mortem must pin: the
        consensus watermark, last committed round, and store size of
        every live honest member at dump time)."""
        out: Dict[str, Dict[str, int]] = {}
        for i, n in sorted(self.nodes.items()):
            if n is None:
                continue
            out[f"n{i}"] = {
                "decided": len(n.consensus),
                "consensus_round": n.consensus_round,
                "events": len(n.hg),
            }
        return out

    def flightrec_postmortem(self, verdict: Dict) -> Optional[str]:
        """Fire the black-box on a red verdict.  Returns the dump path
        (``None`` when the verdict is green, no recorder is attached, or
        the recorder has no ``dump_dir``)."""
        if self.flightrec is None or verdict.get("ok"):
            return None
        return self.flightrec.trigger(
            "verdict_failed",
            detail={
                "safety": verdict.get("safety"),
                "liveness": verdict.get("liveness"),
            },
            decided_frontier=self.decided_frontier(),
            registry=(
                self.metrics.registry if self.metrics is not None else None
            ),
        )

    def oracle_order(self) -> List[bytes]:
        """Fault-free ground truth: a fresh observer replays the union of
        every honest store over a reliable path and recomputes consensus
        from scratch.  By purity of the consensus functions this is the
        order every honest node must have decided a prefix of."""
        union = {}
        for n in self._live_honest():
            union.update(n.hg)
        return oracle_replay(union, self.members, self.config, self.keys[-1])

    def verdict(self) -> Dict:
        nodes = self._live_honest()
        orders = [n.consensus for n in nodes]
        safety = safety_section(orders, self.oracle_order())
        liveness = liveness_section(
            self._min_decided(), self._decided_at_heal, self._heal_t,
        )
        quarantined = sorted(
            {
                self.transport.member_index.get(p, -1)
                for n in nodes
                for p in n.breaker.quarantined()
            }
        )
        return {
            "ok": verdict_ok(safety, liveness),
            "safety": safety,
            "liveness": liveness,
            "faults": dict(self.transport.stats),
            "resilience": {
                "crashes": self.crashes,
                "restarts": self.restarts,
                "retries": sum(n.retries for n in nodes),
                "backoff_total": round(
                    sum(n.backoff_total for n in nodes), 3
                ),
                "bad_replies": sum(n.bad_replies for n in nodes),
                "bad_requests": sum(n.bad_requests for n in nodes),
                "circuit_opens": sum(n.circuit_opens for n in nodes),
                "quarantined_member_indices": quarantined,
                "forks_detected": max(n.forks_detected for n in nodes),
                "equivocations_detected": max(
                    n.equivocations_detected for n in nodes
                ),
                "withholding_suspected": sum(
                    n.withholding_suspected for n in nodes
                ),
                "budget_exhausted": max(n.budget_exhausted for n in nodes),
                "sync_branches_capped": sum(
                    n.sync_branches_capped for n in nodes
                ),
                "orphans_parked": sum(n.orphans_parked for n in nodes),
                "late_witnesses": sum(
                    len(n.late_witnesses) for n in nodes
                ),
                "horizon_violations": sum(
                    n.horizon_violations for n in nodes
                ),
            },
            "scenario": {
                "seed": self.scenario.seed,
                "plan_seed": self.scenario.plan.seed,
                "n_nodes": self.scenario.n_nodes,
                "n_turns": self.scenario.n_turns,
                "n_forkers": self.scenario.n_forkers,
                "adversary_indices": sorted(self.scenario.adversaries or ()),
                "attack_end": self.scenario.attack_end,
            },
        }


def run_chaos(
    scenario: ChaosScenario, ckpt_dir: str, metrics=None, tracer=None,
    flightrec=None, device="cuda",
) -> Dict:
    """Build + run one scenario; returns the verdict dict."""
    return ChaosSimulation(
        scenario, ckpt_dir, metrics=metrics, tracer=tracer,
        flightrec=flightrec, device=device,
    ).run()


# ------------------------------------------------- named storm scenarios
#
# The storm scenarios below pin the robustness obligations as reproducible
# verdicts (``python -m tpu_swirld_torch.chaos_run --scenario ...``):
#
# - horizon_storm: straggler witnesses fired mid-protocol across a healing
#   partition must land below the committed frontier on the majority side
#   and still leave every engine (live oracle, batch replay on the card,
#   windowed driver) bit-identical (the deterministic expiry horizon).
# - overflow_storm: witness-table capacity misses (fork-storm slot
#   exhaustion, round-window under-provisioning) must self-heal through the
#   retry instead of failing, with parity kept.

#: the row shards of ``engine="streaming-mesh"``, all on one device (the
#: reference shards over ``min(8, len(jax.devices()))`` devices, 8 under
#: its tests' virtual CPU devices)
MESH_SHARDS = 8


def _engines_agree(node, engine: str = "incremental", device="cuda") -> Dict:
    """Cross-engine agreement for one node's full DAG: live oracle state
    vs a cold batch ``run_consensus`` vs a windowed driver replaying the
    same chunked ingest, both on ``device`` (default ``"cuda"``, which
    raises without a GPU).  ``engine`` picks the windowed driver:
    ``"incremental"`` (:class:`~tpu_swirld_torch.gpu.incremental.
    IncrementalConsensus`), ``"streaming"`` (:class:`~tpu_swirld_torch.
    store.StreamingConsensus`: decided rows retire into the slab archive
    and pruned-history references take the widening rebase, so chaos
    traffic exercises spill and fetch too) or ``"streaming-mesh"``
    (:class:`~tpu_swirld_torch.parallel.MeshStreamingConsensus` over
    ``make_mesh(MESH_SHARDS, device)``: the same streaming replay with the
    resident window row-sharded, every block through the ``ssm_tally``
    route, ``pallas=True``).  Returns comparison booleans (all pure-function
    replays of the same DAG, so anything but bit-equality is a bug) and,
    beyond the reference's row, ``seconds``: the wall time of the batch
    pass and the windowed replay."""
    from tpu_swirld_torch.gpu.incremental import IncrementalConsensus
    from tpu_swirld_torch.gpu.pipeline import run_consensus
    from tpu_swirld_torch.packing import pack_node

    dev = resolve_device(device)
    if engine == "streaming":
        from tpu_swirld_torch.store import StreamingConsensus as _Driver
    elif engine == "streaming-mesh":
        from tpu_swirld_torch.parallel import MeshStreamingConsensus, make_mesh

        _Driver = functools.partial(
            MeshStreamingConsensus, make_mesh(MESH_SHARDS, dev), pallas=True,
        )
    elif engine == "incremental":
        _Driver = IncrementalConsensus
    else:
        raise ValueError(f"unknown engine {engine!r}")

    t0 = time.perf_counter()
    packed = pack_node(node)
    batch = run_consensus(packed, node.config, block=64, device=dev)
    oracle_famous = {
        node.idx[w]: node.famous[w]
        for r, ws in node.wit_list.items()
        for w in ws
    }
    batch_oracle = (
        all(
            int(batch.round[i]) == node.round[eid]
            and bool(batch.is_witness[i]) == bool(node.is_witness[eid])
            for i, eid in enumerate(node.order_added)
        )
        and batch.famous == oracle_famous
        and [packed.ids[i] for i in batch.order] == node.consensus
    )
    events = [node.hg[e] for e in node.order_added]
    stake = [node.stake[m] for m in node.members]
    inc = _Driver(
        node.members, stake, node.config, block=64, chunk=64,
        window_bucket=256, prune_min=64, device=dev,
    )
    for i in range(0, len(events), 64):
        inc.ingest(events[i : i + 64])
    res = inc.result()
    seconds = time.perf_counter() - t0
    inc_batch = (
        (res.round == batch.round).all()
        and (res.is_witness == batch.is_witness).all()
        and res.famous == batch.famous
        and res.order == batch.order
        and (res.round_received == batch.round_received).all()
        and (res.consensus_ts == batch.consensus_ts).all()
    )
    out = {
        "engine": engine,
        "batch_oracle_parity": bool(batch_oracle),
        "incremental_batch_parity": bool(inc_batch),
        "incremental_rebases": inc.rebases,
        "seconds": seconds,
    }
    if engine.startswith("streaming"):
        out["store"] = inc.store.stats()
        out["widen_rebases"] = inc.widen_rebases
    if engine == "streaming-mesh":
        out["mesh_devices"] = inc.mesh.size
        out["mesh_repins"] = inc.repins
    return out


def horizon_storm_scenario(seed: int = 1, n_turns: int = 260) -> ChaosScenario:
    """Partition one member into a minority for the middle of the run: it
    keeps signing against its stale view (rounds frozen — a minority can
    never promote), the majority supermajority keeps ordering rounds, and
    at heal the straggler tail floods in below the committed frontier."""
    plan = FaultPlan(
        seed=seed,
        partitions=[
            Partition(start=n_turns // 4, end=(2 * n_turns) // 3, group=(4,))
        ],
    )
    return ChaosScenario(
        n_nodes=5, n_turns=n_turns, seed=seed, n_forkers=0, plan=plan,
        checkpoint_every=50,
    )


def run_horizon_storm(ckpt_dir: str, seed: int = 1, metrics=None,
                      tracer=None, engine="incremental",
                      flightrec=None, device="cuda") -> Dict:
    """Run the straggler-witness scenario and extend the verdict with the
    horizon section: late-witness counts and cross-engine agreement.  The
    old node-local quarantine made exactly this history a documented
    divergence corner (parity suites excluded it with ``assert not
    node.ancient``); the deterministic horizon must decide it
    bit-identically on every node and engine.

    Two straggler sources compose: the partitioned member's own stale
    tail (natural), and a deterministic post-heal injection of forged
    straggler witnesses deep below the majority frontier (the shape an
    amnesiac or equivocating laggard produces) — so the corner fires on
    every run, not just lucky seeds.

    ``engine`` is one windowed driver's name or a tuple of them: the
    horizon section carries the first one's row, as the reference's does,
    and a tuple adds an ``engines`` list with a row a driver, all replaying
    the one run's probe DAG on ``device``."""
    from tpu_swirld_torch.sim import make_straggler_event

    dev = resolve_device(device)

    scenario = horizon_storm_scenario(seed)
    inject_t = scenario.plan.heal_time() + 10
    iso = scenario.plan.partitions[0].group[0]
    injected: List[bytes] = []

    def _fire_stragglers(turn: int, sim: "ChaosSimulation") -> None:
        if turn != inject_t or injected:
            return
        pk, sk = sim.keys[iso]
        target = next(
            n for i, n in sim.nodes.items() if n is not None and i != iso
        )
        try:
            ev = make_straggler_event(target, pk, sk, at_round=1)
        except ValueError:
            return
        new_ids: List[bytes] = []
        target._ingest([ev], new_ids)
        if new_ids:
            target.consensus_pass(new_ids)
            injected.extend(new_ids)

    sim = ChaosSimulation(
        scenario, ckpt_dir, metrics=metrics, tracer=tracer,
        on_turn=_fire_stragglers, flightrec=flightrec, device=dev,
    )
    verdict = sim.run()
    nodes = sim._live_honest()
    late = sum(len(n.late_witnesses) for n in nodes)
    violations = sum(n.horizon_violations for n in nodes)
    probe = max(nodes, key=lambda n: len(n.hg))
    names = (engine,) if isinstance(engine, str) else tuple(engine)
    rows = [_engines_agree(probe, engine=e, device=dev) for e in names]
    verdict["horizon"] = {
        "late_witnesses": late,
        "horizon_violations": violations,
        **rows[0],
    }
    if len(rows) > 1:
        verdict["engines"] = rows
    verdict["ok"] = bool(
        verdict["ok"]
        and late > 0                       # the corner actually fired
        and violations == 0
        and all(
            r["batch_oracle_parity"] and r["incremental_batch_parity"]
            for r in rows
        )
    )
    # the horizon fold can flip a green run() verdict red — make sure a
    # red verdict still ships its forensic bundle
    if not verdict["ok"] and not verdict.get("flightrec_dump"):
        verdict["flightrec_dump"] = sim.flightrec_postmortem(verdict)
    return verdict


def run_overflow_storm(seed: int = 4, flightrec=None, device="cuda") -> Dict:
    """Device-engine self-healing verdict, two legs, both
    ``run_consensus`` on ``device`` (each leg's ``seconds``, beyond the
    reference's verdict, is that call's wall time):

    - *fork storm*: a heavily equivocating DAG run with a deliberately
      under-provisioned witness-slot capacity (``s_max``) — previously a
      fail-stop ``RuntimeError("witness table overflow")``, now a doubled-
      ``s_max`` auto-retry that must finish with oracle parity;
    - *round clamp*: a deep DAG run with an under-provisioned round window
      (``r_max``) — the chain-derived clamp's failure shape — which must
      retry unclamped at ``config.max_rounds`` and finish with parity.
    """
    from tpu_swirld_torch.gpu.pipeline import run_consensus
    from tpu_swirld_torch.packing import pack_events, pack_node
    from tpu_swirld_torch.sim import generate_gossip_dag, make_simulation

    dev = resolve_device(device)

    def _oracle_parity(packed_dag, result, oracle_node) -> bool:
        """Shared parity predicate for both storm legs (keep in lock-step:
        order AND per-event rounds must match the oracle exactly)."""
        return bool(
            [packed_dag.ids[i] for i in result.order] == oracle_node.consensus
            and all(
                int(result.round[i]) == oracle_node.round[eid]
                for i, eid in enumerate(oracle_node.order_added)
            )
        )

    members, stake, events, keys = generate_gossip_dag(
        8, 500, seed=seed, n_forkers=3, fork_prob=0.4
    )
    packed = pack_events(events, members, stake)
    oracle = Node(
        sk=keys[0][1], pk=members[0], network={}, members=members,
        clock=lambda: 0, create_genesis=False,
        config=SwirldConfig(n_members=8),
    )
    new_ids = [ev.id for ev in events if oracle.add_event(ev)]
    oracle.consensus_pass(new_ids)
    t0 = time.perf_counter()
    res_a = run_consensus(
        packed, oracle.config, block=64, s_max=len(members) + 1, device=dev
    )
    fork_leg = {
        "seconds": time.perf_counter() - t0,
        "fork_pairs": int(packed.fork_pairs.shape[0]),
        "overflow_retries": int(res_a.timings.get("overflow_retries", 0)),
        "parity": _oracle_parity(packed, res_a, oracle),
    }

    # rotating-stake population: unequal stakes make the >2/3 witness
    # quorum rotate among weighted subsets round to round.  (A DAG whose
    # max_round NATURALLY exceeds the chain clamp is provably impossible:
    # every promoted round needs witnesses from >2/3 of stake, so some
    # member witnesses — and therefore chains — at least ~2/3 of all
    # rounds, and the visibility echo each promotion needs pushes the
    # longest chain past max_round.  The clamp's failure shape is an
    # under-provisioned explicit r_max, which is what this leg drives.)
    cfg_b = SwirldConfig(n_members=5, stake=(3, 2, 2, 1, 1), seed=seed)
    sim = make_simulation(5, seed=seed, config=cfg_b)
    sim.run(320)
    node = sim.nodes[0]
    packed_b = pack_node(node)
    t0 = time.perf_counter()
    res_b = run_consensus(
        packed_b, node.config, block=64, r_max=8, device=dev
    )
    clamp_leg = {
        "seconds": time.perf_counter() - t0,
        "max_round": int(res_b.max_round),
        "overflow_retries": int(res_b.timings.get("overflow_retries", 0)),
        "parity": _oracle_parity(packed_b, res_b, node),
    }
    ok = bool(
        fork_leg["parity"] and fork_leg["overflow_retries"] >= 1
        and clamp_leg["parity"] and clamp_leg["overflow_retries"] >= 1
        and clamp_leg["max_round"] >= 8
    )
    dump = None
    if flightrec is not None and not ok:
        # no live simulation here — the frontier is the two legs' replay
        # endpoints (oracle watermark and batch order length per leg)
        dump = flightrec.trigger(
            "verdict_failed",
            detail={"fork_storm": fork_leg, "round_clamp": clamp_leg},
            decided_frontier={
                "fork_storm": {"decided": len(oracle.consensus)},
                "round_clamp": {"decided": len(node.consensus)},
            },
        )
    return {
        "ok": ok,
        "fork_storm": fork_leg,
        "round_clamp": clamp_leg,
        "scenario": {"seed": seed, "name": "overflow_storm"},
        "flightrec_dump": dump,
    }


def run_membership_churn(
    ckpt_dir: str, seed: int = 11, flightrec=None, device="cuda",
) -> Dict:
    """Dynamic-membership acceptance storm: an adversary JOINS mid-run,
    mounts an equivocation storm spanning the vote-out epoch boundary,
    and is removed by a decided LEAVE transaction — the "voted out"
    path.  Three phases over one dynamic-membership gossip population:

    1. *admit*: a JOIN tx for a fresh key rides honest gossip, decides,
       and activates; the joiner node comes online mid-run
       (:func:`~tpu_swirld_torch.membership.dynamic.joining_node`), bootstraps
       from gossip, and gains stake at its epoch's activation round.
    2. *attack*: the admitted member mints fork pairs (divergent events
       at equal seq fed to different honest nodes) through the window in
       which the honest members issue the LEAVE tx — so fork pairs
       straddle the vote-out epoch's activation boundary.
    3. *vote-out*: the LEAVE decides, the leaver's stake zeroes at the
       activation round, and the storm loses all voting power: no event
       it creates at or past activation is ever a witness.

    Verdict gates: the join and leave epochs both decided (≥ 3 epochs);
    forks detected by every honest node with the 3f budget silent (one
    forked creator, f = 1); zero-stake witness gating post-activation;
    honest prefix agreement; liveness THROUGH the churn (decisions
    advance after vote-out); all five dynamic engine drivers
    bit-identical on the surviving DAG; and a checkpoint of the densest
    honest node round-trips with its epoch ledger verified.  The device
    engines and the restore run on ``device``; ``engines["seconds"]``,
    beyond the reference's verdict, is the engines' wall time.
    """
    from tpu_swirld_torch import crypto as _crypto
    from tpu_swirld_torch.event import Event as _Event
    from tpu_swirld_torch.membership.engine import run_all_engines
    from tpu_swirld_torch.membership.sim import make_dynamic_simulation
    from tpu_swirld_torch.membership.txs import join_payload, leave_payload

    dev = resolve_device(device)
    n = 4
    apk, ask = _crypto.keypair(b"churn-adversary-%d" % seed)
    sim = make_dynamic_simulation(n, seed=seed)
    honest = list(sim.nodes)

    # phase 1: a JOIN for the adversary key rides honest gossip
    sim.tx_schedule[15] = join_payload(apk, 1)
    sim.run(220)
    adv = sim.add_joiner(ask, apk)
    sim.run(120)
    join_epochs = len(honest[0].ledger.epochs)
    joined = apk in honest[0].member_index

    def _mint_fork_pair() -> int:
        """Equivocate: a sibling of the adversary's newest chain event
        (same self-parent, same seq, different payload) is fed straight
        to every honest node — the by_seq fork group forms wherever both
        siblings land."""
        probe = max(honest, key=lambda x: len(x.hg))
        chain = probe.member_events.get(apk, [])
        if len(chain) < 2:
            return 0
        newest = probe.hg[chain[-1]]
        sp, op = newest.p if newest.p else (None, None)
        if sp is None:
            return 0
        sib = _Event(
            d=b"equivocate:%d" % len(chain),
            p=(sp, op),
            t=newest.t + 1,
            c=apk,
        ).signed(ask)
        fed = 0
        for node in honest:
            if sib.id in node.hg or sp not in node.hg or op not in node.hg:
                continue
            if node.add_event(sib):
                node.consensus_pass([sib.id])
                fed += 1
        return fed

    # phase 2+3: the storm runs through the vote-out window — the LEAVE
    # tx decides mid-storm, so fork-pair events land on both sides of
    # the removal epoch's activation round.  The LEAVE is injected by a
    # direct honest sync (not tx_schedule, whose random turn owner could
    # be the adversary itself): honest member 0 votes the attacker out.
    pairs_fed = 0
    for i in range(30):
        sim.run(12)
        pairs_fed += _mint_fork_pair()
        if i == 8:
            sim.clock[0] += 1
            new_ids = honest[0].sync(honest[1].pk, leave_payload(apk))
            honest[0].consensus_pass(new_ids)
    sim.run(150)

    node0 = max(honest, key=lambda x: len(x.consensus))
    epochs = node0.ledger.epochs
    voted_out = (
        len(epochs) > join_epochs
        and node0.ledger.head.stake_of(apk) == 0
    )
    act = epochs[-1].activation_round if voted_out else None

    # witness gating: no adversary event at/past the removal activation
    # round is a witness on any honest node
    gated = True
    post_act_events = 0
    if voted_out:
        for node in honest:
            for eid, w in node.is_witness.items():
                if node.hg[eid].c != apk:
                    continue
                if node.round.get(eid, 0) >= act:
                    post_act_events += 1
                    if w:
                        gated = False

    forks = {
        "pairs_fed": pairs_fed,
        "forks_detected": min(x.forks_detected for x in honest),
        "equivocations_detected": min(
            x.equivocations_detected for x in honest
        ),
        "budget_exhausted": max(x.budget_exhausted for x in honest),
    }

    # safety: honest prefix agreement; liveness: decisions advanced past
    # the vote-out activation
    orders = [x.consensus for x in honest]
    m = min(len(o) for o in orders)
    prefix_agree = all(o[:m] == orders[0][:m] for o in orders)
    decided_at_act = sum(
        1 for x in node0.consensus if node0.round_received[x] < act
    ) if voted_out else 0
    liveness_ok = voted_out and len(node0.consensus) > decided_at_act

    # cross-engine parity on the surviving DAG (fork pairs + 3 epochs)
    events = [node0.hg[e] for e in node0.order_added]
    t0 = time.perf_counter()
    try:
        results = run_all_engines(
            events, list(node0._genesis_members),
            list(node0._genesis_stake), node0.config, chunk=64,
            device=dev,
        )
        engines = {
            "parity": True,
            "decided": len(results["batch"].order),
            "epochs": results["batch"].epochs,
            "restatements": results["batch"].restatements,
            "repacks": [s.to_dict() for s in results["batch"].repacks],
            "archive_epochs_spanned": len({
                e for _, e in results["streaming"].archive_epochs
            }),
            "mesh_repins": [len(p) for p in results["mesh"].shard_pins],
            "seconds": time.perf_counter() - t0,
        }
    except AssertionError as exc:
        engines = {"parity": False, "error": str(exc)}

    # checkpoint: the epoch ledger must survive a save/load round trip
    ckpt_path = os.path.join(ckpt_dir, "membership_churn.ckpt")
    save_node(ckpt_path, node0)
    try:
        restored = load_node(
            ckpt_path, node0.sk, node0.pk, {}, {}, device=dev
        )
        ckpt = {
            "ok": bool(
                restored.ledger.same_epochs(node0.ledger)
                and restored.consensus == node0.consensus
            ),
            "epochs": len(restored.ledger.epochs),
        }
    except ValueError as exc:
        ckpt = {"ok": False, "error": str(exc)}

    ok = bool(
        joined and voted_out and gated and post_act_events > 0
        and forks["equivocations_detected"] > 0
        and forks["budget_exhausted"] == 0
        and prefix_agree and liveness_ok
        and engines.get("parity") and engines.get("epochs", 0) >= 3
        and ckpt["ok"]
    )
    dump = None
    if flightrec is not None and not ok:
        dump = flightrec.trigger(
            "verdict_failed",
            detail={"membership_churn": {
                "joined": joined, "voted_out": voted_out, "gated": gated,
            }},
            decided_frontier={"decided": len(node0.consensus)},
        )
    return {
        "ok": ok,
        "scenario": {"seed": seed, "name": "membership_churn"},
        "membership": {
            "joined": joined,
            "voted_out": voted_out,
            "epochs": len(epochs),
            "activation_round": act,
            "witness_gating_ok": gated,
            "adversary_events_post_activation": post_act_events,
            "joiner_decided": len(adv.consensus),
        },
        "adversary": {"strategy": "membership_churn", **forks},
        "safety": {"prefix_agree": prefix_agree},
        "liveness": {
            "decided": len(node0.consensus),
            "decided_at_vote_out": decided_at_act,
            "advanced_after_vote_out": liveness_ok,
        },
        "engines": engines,
        "checkpoint": ckpt,
        "flightrec_dump": dump,
    }


def replay_counterexample(doc_or_path, engine: str = "incremental",
                          device="cuda") -> Dict:
    """Ingest a model-checker counterexample document (the JSON that
    ``python -m tpu_swirld_torch.analysis mc --out ...`` writes, or the
    reference's: the format is shared) into the chaos harness: replay the
    minimized schedule bit-deterministically through the real node and
    transport seam, confirm the recorded violation and per-node state
    digests reproduce exactly, and, for UNMUTATED documents, where the
    consensus core is the shipping code, fold in a cross-engine parity row
    (:func:`_engines_agree` on ``device``, default ``"cuda"``) for the
    densest honest node of the final state.  Mutated documents skip the
    parity probe (a seeded bug is EXPECTED to diverge) and gate only on
    replay fidelity.  ``device`` is resolved first, so without a GPU the
    default raises for any document unless the caller passes
    ``device="cpu"``; an exception inside the parity probe is reported in
    the row and fails the replay."""
    from tpu_swirld_torch.analysis.mc import counterexample as _ce

    dev = resolve_device(device)
    doc = (
        _ce.load(doc_or_path) if isinstance(doc_or_path, (str, os.PathLike))
        else doc_or_path
    )
    rep = _ce.replay(doc)
    out: Dict = {
        "kind": "mc-replay",
        "mutate": doc["world"].get("mutate"),
        "schedule_len": len(doc["schedule"]),
        "violation": doc.get("violation"),
        "reproduced": rep["reproduced"],
        "digests_match": rep["digests_match"],
        "trace_match": rep["trace_match"],
    }
    ok = bool(rep["reproduced"] and rep["digests_match"] and rep["trace_match"])
    if out["mutate"] is None:
        world, nodes = rep["_world"], rep["_nodes"]
        probe = max(
            (nodes[r] for r in world.honest_roles), key=lambda n: len(n.hg)
        )
        try:
            engines = _engines_agree(probe, engine=engine, device=dev)
        except Exception as exc:  # the device path failed: report, fail
            engines = {"engine": engine, "error": repr(exc)}
            ok = False
        else:
            ok = ok and bool(
                engines["batch_oracle_parity"]
                and engines["incremental_batch_parity"]
            )
        out["engines"] = engines
    out["ok"] = ok
    return out
