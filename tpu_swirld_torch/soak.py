"""Production-day soak: every fault class at once, one composite verdict
(the port's copy of the reference's ``tpu_swirld/soak.py``, over the port's
``net/``, ``adversary``, ``chaos`` and ``obs``).

Each robustness subsystem has its own harness — chaos (in-process
crash/partition), the adversary suite (byzantine strategies), the
real-process cluster (kill -9 + WAL recovery), the flight recorder.
This module composes them into one scenario: an N-process cluster
gossiping through the socket-level fault injector
(:mod:`tpu_swirld_torch.net.proxy`), under heavy-tailed client traffic
(:mod:`tpu_swirld_torch.net.traffic`), while a declarative *schedule* of
windows interleaves

- **crashes** — :class:`CrashWindow`: SIGKILL at ``at_s``, restart from
  checkpoint + own-event WAL at ``restart_at_s``;
- **partitions** — :class:`PartitionWindow`: every proxied link crossing
  ``group``'s boundary blocked for the window, then healed;
- **byzantine attacks** — :class:`AttackWindow`: an adversary
  strategy (:class:`~tpu_swirld_torch.adversary.EquivocationStorm`) run by the
  orchestrator in a reserved member slot, gossiping with honest nodes
  *through the proxy seam* like any other member.

The composite verdict is the union of every harness's bar, judged from
the evidence the processes leave on disk:

- **safety** — every honest decided order is bit-identical to a prefix
  of a fault-free oracle replay of the union event log;
- **liveness** — the decided frontier advanced past EVERY disruption
  window (per-window marks, not just the last heal);
- **finality** — merged submission→decided p99 within
  ``finality_budget_s``;
- **accounting** — zero shed-accounting leaks: every submitted tx lands
  in exactly one ledger bucket and no reply goes unclassified;
- **reports** — every honest node wrote its final report and exited 0.

A red verdict triggers the flight recorder (black box post-mortem) and
— via :func:`shrink` — auto-reduces through the model checker's ddmin
(:func:`tpu_swirld_torch.analysis.mc.counterexample.ddmin`) to
a 1-minimal *replayable schedule document* (``save_doc`` /
``load_doc`` / :func:`replay_doc`), so the failure ships as a small
deterministic repro instead of a 10-minute log pile.

``MUTATIONS`` holds seeded defect injections that must flip the verdict
red (the soak's own regression test): ``shed-leak`` reintroduces the
classifier bug where ``SHED:window`` replies silently vanish from the
per-client ledger.

Knobs resolve field > ``SWIRLD_SOAK_*`` env > default via
:func:`tpu_swirld_torch.config.resolve_soak_settings`.  Wall time flows
through :func:`tpu_swirld_torch.net.frame.now` / :func:`~tpu_swirld_torch.net.
frame.sleep` only — the supervisor of real OS processes lives at the
deployment edge, same as the rest of ``net/``.

The soak is host code: the node processes run the oracle, and this module's
import chain loads no ``torch``.  Its union event log
(:func:`~tpu_swirld_torch.net.cluster.collect_node_state`) replays on a
device through :func:`tpu_swirld_torch.chaos._engines_agree`.

In a soak every peer address a node dials is a proxy of the fleet, which
listens from the supervisor's construction, and the adversary's slot is
served by :class:`_AdversaryHost` before any honest process starts, so the
port's start barrier (``NodeRuntime._await_peers``) passes at once.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
from typing import Dict, List, Optional, Tuple

from tpu_swirld_torch.adversary import EquivocationStorm
from tpu_swirld_torch.analysis.mc.counterexample import ddmin
from tpu_swirld_torch.chaos import (
    liveness_section, oracle_replay, safety_section, verdict_ok,
)
from tpu_swirld_torch.config import (
    SwirldConfig, resolve_net_settings, resolve_soak_settings,
)
from tpu_swirld_torch.net import frame
from tpu_swirld_torch.net.cluster import (
    ClusterSpec, ClusterSupervisor, collect_node_state, observer_keypair,
)
from tpu_swirld_torch.net.node_proc import NodeServer
from tpu_swirld_torch.net.traffic import (
    TrafficGenerator, TrafficPlan, classify_reply,
)
from tpu_swirld_torch.net.transport import SocketTransport
from tpu_swirld_torch.obs.finality import merged_dist
from tpu_swirld_torch.obs.flightrec import FlightRecorder
from tpu_swirld_torch.obs.registry import Registry
from tpu_swirld_torch.sim import member_keys
from tpu_swirld_torch.transport import FaultPlan, Partition, TransportError

DOC_KIND = "soak-schedule"
DOC_VERSION = 1


# --------------------------------------------------------------- schedule

@dataclasses.dataclass(frozen=True)
class CrashWindow:
    """SIGKILL node ``index`` at ``at_s``; restart at ``restart_at_s``."""

    index: int
    at_s: float
    restart_at_s: float


@dataclasses.dataclass(frozen=True)
class PartitionWindow:
    """Block every proxied link crossing ``group`` for the window."""

    start_s: float
    end_s: float
    group: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class AttackWindow:
    """Run a byzantine strategy in member slot ``index`` for the window.

    The slot is reserved (never launched as an honest process); the
    orchestrator serves the adversary's gossip endpoints on the slot's
    port and steps the strategy every ``step_every_s`` inside the
    window.  ``strategy`` names the driver (currently
    ``equivocation-storm``)."""

    start_s: float
    end_s: float
    index: int
    strategy: str = "equivocation-storm"
    n_branches: int = 2
    step_every_s: float = 0.25


@dataclasses.dataclass(frozen=True)
class MembershipWindow:
    """Inject one membership transaction at ``at_s``: the orchestrator
    sends an ``MTX1`` blob (``KIND_MTX``) to the first reachable honest
    node, which rides it on its next gossip event; the change decides
    and activates through ordinary consensus.

    Scheduling any membership window flips the cluster to
    :class:`~tpu_swirld_torch.membership.dynamic.DynamicNode` processes.
    ``action`` is ``restake`` (member's stake becomes ``stake``) or
    ``leave`` (stake zeroed; the slot's process keeps gossiping as a
    zero-stake participant — its events order but carry no vote).
    ``join`` is not a soak action: a fresh member would need a fresh
    process slot, which the fixed-fleet supervisor cannot mint."""

    at_s: float
    action: str = "restake"
    member: int = 1
    stake: int = 3


_WINDOW_KINDS = {
    "crash": CrashWindow,
    "partition": PartitionWindow,
    "attack": AttackWindow,
    "membership": MembershipWindow,
}


def window_to_dict(w) -> Dict:
    """JSON-serializable window (tagged with its ``kind``)."""
    for kind, cls in _WINDOW_KINDS.items():
        if isinstance(w, cls):
            d = dataclasses.asdict(w)
            d["kind"] = kind
            return d
    raise ValueError(f"unknown window type {type(w).__name__}")


def window_from_dict(d: Dict):
    d = dict(d)
    cls = _WINDOW_KINDS[d.pop("kind")]
    if "group" in d:
        d["group"] = tuple(d["group"])
    return cls(**d)


def window_end_s(w) -> float:
    """When the disruption is over (the liveness mark's anchor)."""
    if isinstance(w, CrashWindow):
        return w.restart_at_s
    if isinstance(w, MembershipWindow):
        return w.at_s
    return w.end_s


# -------------------------------------------------------------------- spec

@dataclasses.dataclass
class SoakSpec:
    """One soak run: cluster shape + traffic shape + window schedule."""

    workdir: str
    n_nodes: int = 4
    seed: int = 0
    horizon_s: float = 8.0
    tx_rate: float = 150.0
    n_clients: int = 3
    tx_bytes: int = 64
    pareto_alpha: float = 1.5
    burst_every_s: float = 1.5
    burst_len: int = 20
    reconnect_every_s: float = 2.0
    finality_budget_s: float = 6.0
    schedule: Tuple = ()
    mutate: Optional[str] = None
    net: Dict = dataclasses.field(default_factory=dict)
    flightrec_dir: Optional[str] = None
    #: DynamicNode cluster; auto-set when the schedule holds any
    #: MembershipWindow (kept explicit so ddmin removing the last
    #: membership window still replays the same node class)
    dynamic: bool = False


def default_spec(workdir: str, config=None, **overrides) -> SoakSpec:
    """A :class:`SoakSpec` from the resolved ``SWIRLD_SOAK_*`` knobs
    (field > env > default), ``overrides`` winning over everything."""
    s = resolve_soak_settings(config)
    spec = SoakSpec(
        workdir=workdir,
        n_nodes=s["nodes"],
        horizon_s=s["horizon_s"],
        tx_rate=s["tx_rate"],
        n_clients=s["clients"],
        tx_bytes=s["tx_bytes"],
        pareto_alpha=s["pareto_alpha"],
        finality_budget_s=s["finality_budget_s"],
    )
    return dataclasses.replace(spec, **overrides) if overrides else spec


def smoke_schedule(spec: SoakSpec) -> Tuple:
    """The deterministic tier-1 composition: one SIGKILL crash, one
    partition/heal through the socket proxy, one byzantine attack window
    — each closing with >=20% of the horizon left so the liveness marks
    have room to advance."""
    h = spec.horizon_s
    return (
        AttackWindow(
            start_s=0.5, end_s=h * 0.8, index=spec.n_nodes - 1,
        ),
        CrashWindow(index=1, at_s=h * 0.25, restart_at_s=h * 0.45),
        PartitionWindow(start_s=h * 0.55, end_s=h * 0.75, group=(0,)),
    )


# --------------------------------------------------------------- mutations

def _mutate_shed_leak(net: Dict):
    """Reintroduce the shed-accounting bug: ``SHED:window`` replies fall
    out of the per-client ledger.  The admission window is pinned tight
    so window sheds actually occur while consensus still advances — the
    verdict must go red via the accounting leak alone."""
    def leaky(reply: bytes) -> Optional[str]:
        if reply == b"SHED:window":
            return None
        return classify_reply(reply)
    net = dict(net)
    net.setdefault("max_undecided", 48)
    return leaky, net


#: name -> mutator(net) -> (classify, net); each must flip the composite
#: verdict red on the smoke schedule (exercised by the acceptance test)
MUTATIONS = {"shed-leak": _mutate_shed_leak}


# ---------------------------------------------------------- adversary host

class _AdversaryHost:
    """One :class:`AttackWindow`'s byzantine member, run in-orchestrator.

    Duck-types the :class:`~tpu_swirld_torch.chaos.ChaosSimulation` surface
    the adversary drivers read (``keys`` / ``clock`` / ``rng`` / ``network``
    / ``network_want`` / ``members`` / ``config`` / ``transport``), but
    the transport is a real :class:`SocketTransport` registered to every
    honest peer *through the proxy fleet* — the adversary's forks cross
    the same interposed links as honest gossip.  A :class:`NodeServer`
    on the slot's real port serves the strategy's branch views to honest
    askers (the per-link proxies upstream to it).

    Deadlock-free by the same argument as honest nodes: the host lock is
    held across the strategy's outbound pulls, but honest gossip loops
    release their runtime lock around socket I/O, so an honest server
    can always answer us while its own loop waits on our server.
    """

    def __init__(
        self,
        spec: SoakSpec,
        window: AttackWindow,
        sup: ClusterSupervisor,
        settings: Dict,
        byz_indices: Tuple[int, ...],
    ):
        if window.strategy != "equivocation-storm":
            raise ValueError(f"unknown attack strategy {window.strategy!r}")
        self.window = window
        self.keys = member_keys(spec.n_nodes, spec.seed)
        self.members = [pk for pk, _ in self.keys]
        self.config = SwirldConfig(n_members=spec.n_nodes, seed=spec.seed)
        self.clock = [0]
        self.rng = random.Random((spec.seed << 8) ^ 0x50AC ^ window.index)
        self.network: Dict = {}
        self.network_want: Dict = {}
        st = SocketTransport(
            settings=settings, src=self.members[window.index],
        )
        for j, pk in enumerate(self.members):
            if j != window.index:
                h, p = sup.fleet.addr_for(window.index, j)
                st.register(pk, h, p)
        self.transport = st
        self.lock = threading.Lock()
        self.honest_pks = [
            pk for j, pk in enumerate(self.members) if j not in byz_indices
        ]
        self.storm = EquivocationStorm(
            self, window.index, n_branches=window.n_branches,
        )
        self.steps = 0
        self._next_step = window.start_s
        self.server = NodeServer(
            sup.spec.host, sup.ports[window.index], self._dispatch,
            frame.MAX_FRAME_BYTES,
        )

    def _dispatch(self, kind, src, payload, trace):
        if kind == frame.KIND_PING:
            return frame.STATUS_OK, b"pong"
        if kind == frame.KIND_SYNC:
            with self.lock:
                return frame.STATUS_OK, self.storm.ask_sync(src, payload)
        if kind == frame.KIND_WANT:
            with self.lock:
                return frame.STATUS_OK, self.storm.ask_events(src, payload)
        raise ValueError(f"byzantine slot rejects request kind {kind}")

    def maybe_step(self, elapsed_s: float) -> None:
        w = self.window
        if (
            elapsed_s < w.start_s or elapsed_s >= w.end_s
            or elapsed_s < self._next_step
        ):
            return
        self._next_step = elapsed_s + w.step_every_s
        with self.lock:
            self.clock[0] += 1
            try:
                # the storm only swallows ValueError internally; proxied
                # links can also surface transport/socket errors (e.g.
                # a partition window covering the byzantine slot)
                self.storm.step(self.clock[0], self.honest_pks)
                self.steps += 1
            except (TransportError, ValueError, OSError):
                pass

    def close(self) -> None:
        self.server.close()
        self.transport.close()


# --------------------------------------------------------------- orchestra

def _mtx_payload(w: MembershipWindow, members: List[bytes]) -> bytes:
    from tpu_swirld_torch.membership.txs import leave_payload, restake_payload

    if w.action == "restake":
        return restake_payload(members[w.member], w.stake)
    if w.action == "leave":
        return leave_payload(members[w.member])
    raise ValueError(f"unknown membership action {w.action!r}")


def _decided_min(sup: ClusterSupervisor, indices: List[int]) -> int:
    """The lagging decided frontier over the reachable honest nodes."""
    decided = []
    for i in indices:
        try:
            decided.append(sup.client.status(i)["decided"])
        except (OSError, ValueError, KeyError):
            pass
    return min(decided) if decided else 0


def run_soak(spec: SoakSpec) -> Dict:
    """Drive one soak run end to end; returns the composite verdict.

    Never raises on node/verdict behavior — setup failures (ports,
    spawn, readiness) do raise.
    """
    os.makedirs(spec.workdir, exist_ok=True)
    schedule = list(spec.schedule)
    attacks = [w for w in schedule if isinstance(w, AttackWindow)]
    crashes = [w for w in schedule if isinstance(w, CrashWindow)]
    partitions = [w for w in schedule if isinstance(w, PartitionWindow)]
    memberships = [w for w in schedule if isinstance(w, MembershipWindow)]
    dynamic = spec.dynamic or bool(memberships)
    byz = tuple(sorted({w.index for w in attacks}))
    plan = FaultPlan(
        seed=spec.seed,
        partitions=[
            Partition(start=w.start_s, end=w.end_s, group=tuple(w.group))
            for w in partitions
        ],
    )
    classify = classify_reply
    net = dict(spec.net)
    if spec.mutate:
        classify, net = MUTATIONS[spec.mutate](net)
    flightrec_dir = spec.flightrec_dir or os.path.join(
        spec.workdir, "flightrec",
    )
    cspec = ClusterSpec(
        workdir=spec.workdir,
        n_nodes=spec.n_nodes,
        seed=spec.seed,
        duration_s=spec.horizon_s,
        tx_rate=0.0,   # the traffic generator drives load, not run_cluster
        tx_bytes=spec.tx_bytes,
        flightrec_dir=flightrec_dir,
        net=net,
        proxy_plan=plan,
        external_indices=byz,
        dynamic=dynamic,
    )
    honest = cspec.managed_indices()
    sup = ClusterSupervisor(cspec)
    hosts: List[_AdversaryHost] = []
    marks = [
        {
            "window": window_to_dict(w),
            "end_s": window_end_s(w),
            "decided_at_end": None,
        }
        for w in schedule
    ]
    traffic: Optional[TrafficGenerator] = None
    try:
        # adversary slots serve from the start (honest nodes gossip to
        # every member from boot; a refused byzantine port would just
        # feed their circuit breakers noise)
        node_settings = resolve_net_settings()
        node_settings.update(net)
        for w in attacks:
            hosts.append(_AdversaryHost(spec, w, sup, node_settings, byz))
        for i in honest:
            sup._write_node_spec(i)
            sup.launch(i)
        sup.wait_ready(honest)
        sup.fleet.start_clock()   # window clocks count from here
        t0 = frame.now()
        traffic = TrafficGenerator(
            TrafficPlan(
                seed=spec.seed,
                duration_s=spec.horizon_s,
                n_clients=spec.n_clients,
                rate=spec.tx_rate,
                tx_bytes=spec.tx_bytes,
                pareto_alpha=spec.pareto_alpha,
                burst_every_s=spec.burst_every_s,
                burst_len=spec.burst_len,
                reconnect_every_s=spec.reconnect_every_s,
            ),
            cspec.host, sup.ports, targets=list(honest),
            classify=classify,
        )
        traffic.start()
        pending_kills = sorted(crashes, key=lambda w: w.at_s)
        pending_restarts: List[CrashWindow] = []
        pending_mtx = sorted(memberships, key=lambda w: w.at_s)
        member_pks = [pk for pk, _ in member_keys(spec.n_nodes, spec.seed)]
        mtx_sent = 0
        down: set = set()
        poll_gap = cspec.metrics_poll_s if cspec.metrics_poll_s > 0 else None
        next_poll = t0 + (poll_gap or 0.0)
        while frame.now() - t0 < spec.horizon_s:
            el = frame.now() - t0
            while pending_kills and el >= pending_kills[0].at_s:
                w = pending_kills.pop(0)
                proc = sup.procs.get(w.index)
                if proc is not None and proc.poll() is None:
                    sup.kill(w.index)
                down.add(w.index)
                traffic.retarget([i for i in honest if i not in down])
                pending_restarts.append(w)
                pending_restarts.sort(key=lambda c: c.restart_at_s)
            while pending_restarts and el >= pending_restarts[0].restart_at_s:
                w = pending_restarts.pop(0)
                if w.index in down:
                    sup.restart(w.index)
                    down.discard(w.index)
                traffic.retarget([i for i in honest if i not in down])
            # membership injection: one KIND_MTX to the first reachable
            # honest node; an all-unreachable tick just retries — the
            # window fires late rather than silently dropping the tx
            while pending_mtx and el >= pending_mtx[0].at_s:
                w = pending_mtx[0]
                sent = False
                for i in honest:
                    if i in down:
                        continue
                    try:
                        st, _ = sup.client.call(
                            i, frame.KIND_MTX, _mtx_payload(w, member_pks),
                        )
                    except (OSError, ValueError):
                        continue
                    if st == frame.STATUS_OK:
                        sent = True
                        break
                if not sent:
                    break
                pending_mtx.pop(0)
                mtx_sent += 1
            for h in hosts:
                h.maybe_step(el)
            for m in marks:
                if m["decided_at_end"] is None and el >= m["end_s"]:
                    m["decided_at_end"] = _decided_min(
                        sup, [i for i in honest if i not in down],
                    )
            if poll_gap is not None and frame.now() >= next_poll:
                next_poll += poll_gap
                sup.poll_metrics()
            frame.sleep(0.02)
        traffic.stop()
        traffic.join(timeout_s=10.0)
        for w in pending_restarts:   # crash window ran past the horizon
            if w.index in down:
                sup.restart(w.index)
                down.discard(w.index)
        for m in marks:
            if m["decided_at_end"] is None:
                m["decided_at_end"] = _decided_min(
                    sup, [i for i in honest if i not in down],
                )
        if poll_gap is not None:
            sup.poll_metrics()
    finally:
        for h in hosts:
            h.close()
        sup.stop_all()
        if traffic is not None:
            traffic.stop()
    return _soak_verdict(
        spec, cspec, sup, traffic, marks, flightrec_dir, hosts,
        mtx_sent=mtx_sent,
    )


def _soak_verdict(
    spec: SoakSpec,
    cspec: ClusterSpec,
    sup: ClusterSupervisor,
    traffic: Optional[TrafficGenerator],
    marks: List[Dict],
    flightrec_dir: str,
    hosts: Optional[List[_AdversaryHost]] = None,
    mtx_sent: int = 0,
) -> Dict:
    honest = cspec.managed_indices()
    members = [pk for pk, _ in member_keys(spec.n_nodes, spec.seed)]
    config = SwirldConfig(n_members=spec.n_nodes, seed=spec.seed)
    reports, union, nodes = collect_node_state(
        spec.workdir, honest, sup.exit_codes, sup.restarts,
    )
    orders = [
        [bytes.fromhex(e) for e in rep["decided"]]
        for _, rep in sorted(reports.items())
    ]
    oracle_cls = None
    if cspec.dynamic:
        from tpu_swirld_torch.membership.dynamic import DynamicNode

        oracle_cls = DynamicNode
    if union and orders:
        oracle = oracle_replay(
            union, members, config, observer_keypair(spec.seed),
            node_cls=oracle_cls,
        )
        safety = safety_section(orders, oracle)
    else:
        safety = {
            "prefix_agree": False, "oracle_agree": False,
            "common_prefix_len": 0, "oracle_len": 0,
        }
    decided_final = min((len(o) for o in orders), default=0)
    # per-window liveness: the frontier must move past EVERY disruption,
    # not just the last heal
    for m in marks:
        m["advanced"] = decided_final > (m["decided_at_end"] or 0)
    last_end = max((m["end_s"] for m in marks), default=0.0)
    last_mark = max(marks, key=lambda m: m["end_s"], default=None) \
        if marks else None
    liveness = liveness_section(
        decided_final,
        last_mark["decided_at_end"] if last_mark else None,
        heal_turn=min(last_end, spec.horizon_s),
    )
    liveness["windows"] = marks
    disruptions_survived = sum(1 for m in marks if m["advanced"])
    latency = merged_dist(
        [rep.get("ttf_samples", []) for rep in reports.values()], "submit",
    )
    finality = {
        "submit_p99_s": latency.get("submit_p99", 0.0),
        "budget_s": spec.finality_budget_s,
        "samples": latency.get("submit_count", 0),
        "ok": latency.get("submit_p99", 0.0) <= spec.finality_budget_s,
    }
    accounting = traffic.report() if traffic is not None else {
        "balance_ok": False, "submitted": 0, "leaked": 0,
    }
    reports_ok = (
        len(reports) == len(honest)
        and all(c == 0 for c in sup.exit_codes.values())
    )
    counters: Dict[str, float] = {}
    for name in ("tx_shed_window", "tx_shed_pool", "tx_shed_oversize",
                 "tx_duplicate", "tx_accepted", "tx_submitted",
                 "wal_torn_tail_recovered",
                 "net_redials", "net_redial_probes",
                 "node_equivocations_detected", "node_budget_exhausted"):
        counters[name] = sum(
            rep["counters"].get(name, 0) for rep in reports.values()
        )
    # membership: every injected tx must have decided and activated on
    # every surviving honest node — epochs = genesis + one per sent tx.
    # (A dynamic cluster with no windows pins the single-epoch case.)
    epochs_min = min(
        (rep.get("membership_epochs", 1) for rep in reports.values()),
        default=0,
    )
    membership = {
        "dynamic": bool(cspec.dynamic),
        "mtx_sent": mtx_sent,
        "epochs_min": epochs_min,
        "epochs_expected": 1 + mtx_sent,
        "active_epoch_min": min(
            (rep.get("membership_epoch", 1) for rep in reports.values()),
            default=0,
        ),
        "ok": (not cspec.dynamic) or epochs_min >= 1 + mtx_sent,
    }
    ok = (
        verdict_ok(safety, liveness)
        and disruptions_survived == len(marks)
        and finality["ok"]
        and bool(accounting.get("balance_ok"))
        and reports_ok
        and membership["ok"]
    )
    # soak gauges + the black box: a red verdict dumps its own forensics
    registry = Registry()
    registry.gauge("soak_tx_per_s").set(accounting.get("tx_per_s", 0.0))
    registry.gauge("soak_submit_p99_s").set(
        accounting.get("submit_p99_s", 0.0))
    registry.gauge("soak_disruptions_survived").set(disruptions_survived)
    registry.gauge("soak_decided_final").set(decided_final)
    registry.gauge("soak_verdict_ok").set(1 if ok else 0)
    flightrec_dump = None
    if not ok:
        rec = FlightRecorder(
            dump_dir=flightrec_dir, wall_clock=frame.now,
            node_name="soak-orchestrator",
        )
        flightrec_dump = rec.trigger(
            "soak_verdict_failed",
            detail={
                "safety_ok": bool(
                    safety["prefix_agree"] and safety["oracle_agree"]),
                "liveness_ok": bool(liveness["advanced_after_heal"]),
                "disruptions_survived": disruptions_survived,
                "disruptions_total": len(marks),
                "finality_ok": finality["ok"],
                "accounting_ok": bool(accounting.get("balance_ok")),
                "reports_ok": reports_ok,
                "membership_ok": membership["ok"],
            },
            decided_frontier=decided_final,
            registry=registry,
        )
    return {
        "ok": ok,
        "spec": spec_to_dict(spec),
        "safety": safety,
        "liveness": liveness,
        "finality": finality,
        "accounting": accounting,
        "disruptions_survived": disruptions_survived,
        "disruptions_total": len(marks),
        "membership": membership,
        "tx_per_s": accounting.get("tx_per_s", 0.0),
        "submit_p99_s": accounting.get("submit_p99_s", 0.0),
        "counters": counters,
        "proxy": dict(sup.fleet.stats) if sup.fleet is not None else {},
        "adversary": {
            "byzantine_indices": sorted(
                {w["window"]["index"] for w in marks
                 if w["window"]["kind"] == "attack"}
            ),
            "attack_steps": sum(h.steps for h in (hosts or [])),
            "equivocations_detected": counters[
                "node_equivocations_detected"],
        },
        "nodes": nodes,
        "reports": len(reports),
        "flightrec_dump": flightrec_dump,
        "mutate": spec.mutate,
    }


# ----------------------------------------------------- shrink + replay doc

def spec_to_dict(spec: SoakSpec) -> Dict:
    d = dataclasses.asdict(spec)
    d["schedule"] = [window_to_dict(w) for w in spec.schedule]
    return d


def spec_from_dict(d: Dict, workdir: Optional[str] = None) -> SoakSpec:
    d = dict(d)
    d["schedule"] = tuple(
        window_from_dict(w) for w in d.get("schedule", ())
    )
    if workdir is not None:
        d["workdir"] = workdir
    return SoakSpec(**d)


def make_doc(
    spec: SoakSpec, schedule: List, violation: Optional[Dict],
) -> Dict:
    """The minimized replayable failure document."""
    return {
        "kind": DOC_KIND,
        "version": DOC_VERSION,
        "spec": spec_to_dict(
            dataclasses.replace(spec, schedule=tuple(schedule)),
        ),
        "schedule": [window_to_dict(w) for w in schedule],
        "violation": violation,
    }


def save_doc(doc: Dict, path: str) -> str:
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return path


def load_doc(path: str) -> Dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("kind") != DOC_KIND:
        raise ValueError(f"not a {DOC_KIND} doc: {path}")
    return doc


def replay_doc(doc: Dict, workdir: str) -> Dict:
    """Re-run a (minimized) schedule doc in a fresh workdir."""
    spec = spec_from_dict(doc["spec"], workdir=workdir)
    return run_soak(spec)


def shrink(spec: SoakSpec) -> Dict:
    """ddmin the red run's window schedule to a 1-minimal failure.

    Each probe re-runs the soak in its own ``probe-<n>`` workdir with a
    candidate sub-schedule; the reduced doc records the last observed
    violation summary.  Raises ``ValueError`` (from :func:`ddmin`) if
    the full schedule does not actually fail — callers should only
    shrink after a red verdict.
    """
    probes = [0]
    last_violation: Dict = {}

    def red(cand: List) -> bool:
        probes[0] += 1
        probe = dataclasses.replace(
            spec,
            workdir=os.path.join(spec.workdir, f"probe-{probes[0]:02d}"),
            schedule=tuple(cand),
        )
        v = run_soak(probe)
        if not v["ok"]:
            last_violation.clear()
            last_violation.update({
                "safety": v["safety"],
                "liveness_advanced": v["liveness"]["advanced_after_heal"],
                "disruptions_survived": v["disruptions_survived"],
                "finality_ok": v["finality"]["ok"],
                "accounting_leaked": v["accounting"].get("leaked", 0),
                "accounting_ok": bool(
                    v["accounting"].get("balance_ok")),
            })
        return not v["ok"]

    minimal = ddmin(list(spec.schedule), red)
    doc = make_doc(spec, minimal, dict(last_violation) or None)
    doc["probes"] = probes[0]
    return doc
