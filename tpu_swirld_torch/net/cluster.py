"""Cluster supervisor: N node processes, client traffic, kill -9 chaos.

The in-process chaos harness (:mod:`tpu_swirld_torch.chaos`) controls both
sides of every fault; this module gives up that control.  It launches N
:mod:`~tpu_swirld_torch.net.node_proc` runtimes as *separate OS processes*
gossiping over loopback TCP, drives real client transaction submissions
against them, SIGKILLs one mid-run (the kernel, not the harness, picks
the torn byte), restarts it from its checkpoint + own-event WAL, and
then holds the survivors to the exact standard the in-process harness
pins:

- **safety** — every node's decided order is bit-identical to a prefix
  of a fault-free oracle replay of the union DAG
  (:func:`tpu_swirld_torch.chaos.oracle_replay` over the per-process event
  logs — the same function, the same verdict sections);
- **liveness** — the decided frontier advances past the crash window
  (:func:`tpu_swirld_torch.chaos.liveness_section`).

The verdict also carries the tx ledger (submitted / acked / shed /
duplicate / decided, cluster tx/s-to-finality, merged p50/p99
submission→decided latency via
:func:`tpu_swirld_torch.obs.finality.merged_dist`) and each node's startup
post-mortem path (``flightrec_dump``, ``None`` for clean starts) — a
red verdict ships its own forensics.

Telemetry plane: the supervisor is also the cluster's
observability hub.  Every client submission opens a root span whose
16-byte trace context (:func:`tpu_swirld_torch.obs.tracer.pack_context`) rides
the SUBMIT frame header, so one transaction's journey — client → TxPool
→ gossip hops → decided — reassembles into a single causally-linked
timeline via :func:`tpu_swirld_torch.obs.cluster_trace.merge_dir` (written to
``merged.trace.json`` in the workdir).  On an injected-clock cadence
(``metrics_poll_s``) the supervisor polls every node's registry snapshot
over ``KIND_METRICS`` frames and, post-run, writes ``metrics.json``
(per-node samples + cluster rollup) and ``metrics.prom`` (merged
Prometheus exposition).  The verdict carries both under ``trace`` /
``metrics``; ``python -m tpu_swirld_torch.obs report --cluster-dir`` renders
the fleet view.

``python -m tpu_swirld_torch.cluster_run`` is the CLI wrapper.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

from tpu_swirld_torch import crypto
from tpu_swirld_torch.chaos import (
    liveness_section, oracle_replay, safety_section, verdict_ok,
)
from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.event import Event, MalformedEvent, decode_event
from tpu_swirld_torch.net import frame
from tpu_swirld_torch.net.frame import reserve_ports
from tpu_swirld_torch.net.node_proc import derive_paths
from tpu_swirld_torch.net.proxy import ProxyFleet
from tpu_swirld_torch.net.traffic import classify_reply
from tpu_swirld_torch.obs import cluster_trace
from tpu_swirld_torch.obs.finality import merged_dist
from tpu_swirld_torch.obs.registry import merge_node_samples, rollup_node_samples
from tpu_swirld_torch.obs.tracer import Tracer, pack_context
from tpu_swirld_torch.sim import member_keys


@dataclasses.dataclass
class ClusterSpec:
    """One supervised cluster run: topology + traffic + fault schedule.

    ``kill_index``/``kill_at_s`` SIGKILL one node mid-run;
    ``restart_at_s`` relaunches it from the same spec (checkpoint + WAL
    recovery).  ``net`` overrides land in every node's
    :func:`~tpu_swirld_torch.config.resolve_net_settings` dict (stripped key
    names, e.g. ``{"gossip_interval_s": 0.005}``).

    ``proxy_plan`` (a :class:`~tpu_swirld_torch.transport.FaultPlan`) routes
    every node-to-node gossip link through a per-link
    :class:`~tpu_swirld_torch.net.proxy.FaultyProxy` interposer; the
    supervisor's own control plane stays direct.  ``external_indices``
    reserves member slots the supervisor must NOT launch, probe, or
    count toward reports — the soak harness runs byzantine adversaries
    in those slots itself.
    """

    workdir: str
    n_nodes: int = 5
    seed: int = 0
    duration_s: float = 4.0
    tx_rate: float = 200.0          # client submissions per second
    tx_bytes: int = 64
    kill_index: Optional[int] = None
    kill_at_s: Optional[float] = None
    restart_at_s: Optional[float] = None
    flightrec_dir: Optional[str] = None
    metrics_poll_s: float = 1.0     # KIND_METRICS snapshot cadence (<=0 off)
    host: str = "127.0.0.1"
    ready_timeout_s: float = 30.0
    stop_timeout_s: float = 60.0
    net: Dict = dataclasses.field(default_factory=dict)
    proxy_plan: Optional[object] = None
    external_indices: Tuple[int, ...] = ()
    #: launch DynamicNode processes (consensus-decided membership); the
    #: soak harness sets this whenever a MembershipWindow is scheduled
    dynamic: bool = False

    def managed_indices(self) -> List[int]:
        """Member slots this supervisor launches and holds to account."""
        return [
            i for i in range(self.n_nodes)
            if i not in self.external_indices
        ]


class ClusterClient:
    """Cached per-node client connections for the supervisor's control
    plane (submit / status / ping / stop).  One transparent redial per
    call — a restarted node invalidates its cached connection exactly
    once."""

    def __init__(self, host: str, ports: List[int], timeout: float = 5.0):
        self.host = host
        self.ports = ports
        self.timeout = timeout
        self._conns: Dict[int, socket.socket] = {}

    def _drop(self, i: int) -> None:
        sock = self._conns.pop(i, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def call(
        self, i: int, kind: int, payload: bytes = b"",
        trace: bytes = b"",
    ) -> Tuple[int, bytes]:
        """One request/reply exchange with node ``i``; raises ``OSError``
        when the node is unreachable (e.g. inside the crash window).
        ``trace`` (16 bytes or empty) rides the frame header so the node
        can parent its handling span under the client's."""
        for attempt in (0, 1):
            sock = self._conns.get(i)
            reused = sock is not None
            if sock is None:
                sock = socket.create_connection(
                    (self.host, self.ports[i]), timeout=self.timeout,
                )
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock.settimeout(self.timeout)
                self._conns[i] = sock
            try:
                frame.send_request(sock, kind, b"", payload, trace=trace)
                return frame.recv_reply(sock)
            except (ConnectionError, OSError):
                self._drop(i)
                if reused and attempt == 0:
                    continue
                raise
        raise OSError("unreachable")   # pragma: no cover

    def status(self, i: int) -> Dict:
        _status, reply = self.call(i, frame.KIND_STATUS)
        return json.loads(reply.decode())

    def close(self) -> None:
        for i in list(self._conns):
            self._drop(i)


def observer_keypair(seed: int) -> Tuple[bytes, bytes]:
    """The oracle-replay observer's keypair: derived off the member
    namespace (``member-<seed>-<i>``) so it can never collide with a
    real member identity."""
    return crypto.keypair(b"cluster-observer-%d" % seed)


def collect_node_state(
    workdir: str,
    indices: List[int],
    exit_codes: Dict[int, Optional[int]],
    restarts: Dict[int, int],
) -> Tuple[Dict[int, Dict], Dict[bytes, "Event"], List[Dict]]:
    """Gather what each node left on disk: ``(reports, union, rows)``.

    ``reports`` maps index -> the node's final report JSON, ``union`` is
    the union DAG over every node's ``events.bin`` (oracle-replay
    input), ``rows`` are the per-node verdict rows.  Shared by the
    cluster verdict and the soak orchestrator so both judge runs from
    the identical evidence."""
    reports: Dict[int, Dict] = {}
    union: Dict[bytes, Event] = {}
    rows: List[Dict] = []
    for i in indices:
        paths = derive_paths(workdir, i)
        row: Dict = {
            "index": i,
            "exit_code": exit_codes.get(i),
            "restarts": restarts.get(i, 0),
            "flightrec_dump": None,
        }
        if os.path.exists(paths["report"]):
            with open(paths["report"]) as f:
                rep = json.load(f)
            reports[i] = rep
            row.update({
                "decided": len(rep["decided"]),
                "decided_tx": rep["decided_tx"],
                "events": rep["events"],
                "unclean_start": rep["unclean_start"],
                "flightrec_dump": rep["flightrec_dump"],
                "counters": rep["counters"],
            })
        else:
            row["missing_report"] = True
        if os.path.exists(paths["events"]):
            for ev in read_event_log(paths["events"]):
                union.setdefault(ev.id, ev)
        rows.append(row)
    return reports, union, rows


def read_event_log(path: str) -> List[Event]:
    """Decode a node's ``events.bin`` dump (``encode_event`` blobs,
    concatenated in topo order); stops at the first malformed byte."""
    with open(path, "rb") as f:
        data = f.read()
    out: List[Event] = []
    off = 0
    while off < len(data):
        try:
            ev, off = decode_event(data, off)
        except MalformedEvent:
            break
        out.append(ev)
    return out


class ClusterSupervisor:
    """Owns the process fleet for one :class:`ClusterSpec` run."""

    def __init__(self, spec: ClusterSpec):
        self.spec = spec
        os.makedirs(spec.workdir, exist_ok=True)
        if spec.flightrec_dir:
            os.makedirs(spec.flightrec_dir, exist_ok=True)
        # held until stop_all, so no other process takes a node's port
        # between its launches (a restart binds it again)
        self._reserved = reserve_ports(spec.n_nodes, spec.host)
        self.ports = self._reserved.ports
        # socket-level fault injection: one TCP interposer per directed
        # gossip link, sharing the in-process FaultPlan vocabulary
        self.fleet: Optional[ProxyFleet] = None
        if spec.proxy_plan is not None:
            self.fleet = ProxyFleet(
                spec.proxy_plan, spec.n_nodes, self.ports, host=spec.host,
            )
        self.procs: Dict[int, subprocess.Popen] = {}
        self.exit_codes: Dict[int, Optional[int]] = {}
        self.restarts: Dict[int, int] = {}
        self.client = ClusterClient(spec.host, self.ports)
        self._logs: List = []
        # the supervisor's own trace shard: pid 1000 keeps its span ids
        # (pid folded into the upper bits) clear of any node index
        self.tracer = Tracer(pid=1000)
        self.metrics_samples: Dict[str, List[Dict]] = {}
        self.metrics_polls = 0

    # ----------------------------------------------------------- processes

    def _spec_path(self, i: int) -> str:
        return os.path.join(self.spec.workdir, f"node-{i}.spec.json")

    def _write_node_spec(self, i: int) -> str:
        spec = self.spec
        path = self._spec_path(i)
        doc = {
            "index": i,
            "n_nodes": spec.n_nodes,
            "seed": spec.seed,
            "host": spec.host,
            "ports": self.ports,
            "workdir": spec.workdir,
            "flightrec_dir": spec.flightrec_dir,
            # orphan safety net: a node outliving its supervisor
            # (supervisor crash, wedged stop) self-terminates
            "duration_s": spec.duration_s * 3 + 60.0,
            "net": spec.net,
            "dynamic": spec.dynamic,
        }
        if self.fleet is not None:
            doc["peer_addrs"] = {
                str(j): list(self.fleet.addr_for(i, j))
                for j in range(spec.n_nodes) if j != i
            }
        with open(path, "w") as f:
            json.dump(doc, f)
        return path

    def launch(self, i: int) -> None:
        paths = derive_paths(self.spec.workdir, i)
        if os.path.exists(paths["ready"]):
            os.remove(paths["ready"])
        env = dict(os.environ)
        # the child runs with cwd=workdir; make the package importable
        # regardless of how the supervisor itself found it
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))
        ))
        env["PYTHONPATH"] = (
            pkg_root + os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else pkg_root
        )
        log = open(os.path.join(self.spec.workdir, f"node-{i}.log"), "ab")
        self._logs.append(log)
        self.procs[i] = subprocess.Popen(
            [sys.executable, "-m", "tpu_swirld_torch.net.node_proc",
             self._spec_path(i)],
            stdout=log, stderr=log, env=env, cwd=self.spec.workdir,
        )

    def wait_ready(self, indices: List[int]) -> None:
        deadline = frame.now() + self.spec.ready_timeout_s
        pending = list(indices)
        while pending:
            i = pending[0]
            paths = derive_paths(self.spec.workdir, i)
            ready = False
            if os.path.exists(paths["ready"]):
                try:
                    self.client.call(i, frame.KIND_PING)
                    ready = True
                except OSError:
                    ready = False
            if ready:
                pending.pop(0)
                continue
            proc = self.procs.get(i)
            if proc is not None and proc.poll() is not None:
                raise RuntimeError(
                    f"node {i} exited with {proc.returncode} before ready"
                    f" (see node-{i}.log)"
                )
            if frame.now() > deadline:
                raise RuntimeError(f"node {i} not ready in time")
            frame.sleep(0.05)

    def kill(self, i: int) -> None:
        """The real thing: SIGKILL, no cleanup, torn state on disk."""
        os.kill(self.procs[i].pid, signal.SIGKILL)
        self.procs[i].wait()
        self.exit_codes[i] = self.procs[i].returncode
        self.client._drop(i)

    def restart(self, i: int) -> None:
        self.launch(i)
        self.wait_ready([i])
        self.restarts[i] = self.restarts.get(i, 0) + 1

    # ----------------------------------------------------------- telemetry

    def poll_metrics(self) -> int:
        """One metrics sweep: ask every live node for its registry
        snapshot (``KIND_METRICS``).  Unreachable nodes (crash window)
        are skipped — the latest snapshot per node label wins, so a
        restarted node overwrites its pre-crash sample set.  Returns the
        number of nodes that answered."""
        answered = 0
        for i in range(self.spec.n_nodes):
            proc = self.procs.get(i)
            if proc is None or proc.poll() is not None:
                continue
            try:
                _status, reply = self.client.call(i, frame.KIND_METRICS)
                snap = json.loads(reply.decode())
            except (OSError, ValueError):
                continue
            self.metrics_samples[snap.get("node", f"n{i}")] = \
                snap.get("samples", [])
            answered += 1
        if answered:
            self.metrics_polls += 1
        return answered

    def write_telemetry(self) -> Tuple[Dict, Dict]:
        """Post-run telemetry artifacts in the workdir:

        - ``client.trace.jsonl`` — the supervisor's trace shard;
        - ``merged.trace.json`` — all shards merged onto one timebase
          with cross-process flow arrows (Perfetto-openable);
        - ``metrics.json`` — per-node registry samples + cluster rollup;
        - ``metrics.prom`` — merged Prometheus exposition (``node``
          label per sample).

        Returns the verdict's ``(trace, metrics)`` sections."""
        wd = self.spec.workdir
        self.tracer.save(os.path.join(wd, "client.trace.jsonl"))
        merged_path = os.path.join(wd, "merged.trace.json")
        merged = cluster_trace.merge_dir(wd, out_path=merged_path)
        trace_section = {
            "merged": merged_path,
            "shards": len(merged["shards"]),
            "events": merged["events"],
            "traces": merged["traces"],
            "cross_process_traces": merged["cross_process_traces"],
            "cross_process_trace_ids": merged["cross_process_trace_ids"],
        }
        metrics_json = os.path.join(wd, "metrics.json")
        metrics_prom = os.path.join(wd, "metrics.prom")
        rollup = rollup_node_samples(self.metrics_samples)
        with open(metrics_json, "w") as f:
            json.dump({
                "polls": self.metrics_polls,
                "nodes": self.metrics_samples,
                "rollup": rollup,
            }, f, indent=2, sort_keys=True)
        with open(metrics_prom, "w") as f:
            f.write(merge_node_samples(self.metrics_samples)
                    .to_prometheus_text())
        metrics_section = {
            "json": metrics_json,
            "prom": metrics_prom,
            "polls": self.metrics_polls,
            "nodes_covered": len(self.metrics_samples),
        }
        return trace_section, metrics_section

    def stop_all(self) -> None:
        for i, proc in self.procs.items():
            if proc.poll() is None:
                try:
                    self.client.call(i, frame.KIND_STOP)
                except OSError:
                    pass
        for i, proc in self.procs.items():
            if proc.poll() is None:
                try:
                    proc.wait(timeout=self.spec.stop_timeout_s)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
            self.exit_codes[i] = proc.returncode
        self.client.close()
        if self.fleet is not None:
            self.fleet.close()
        self._reserved.close()
        for log in self._logs:
            try:
                log.close()
            except OSError:
                pass


def run_cluster(spec: ClusterSpec) -> Dict:
    """Launch, drive, fault, recover, verdict.  Returns the verdict doc
    (see module docstring); never raises on node behavior — setup
    failures (ports, spawn, readiness) do raise."""
    sup = ClusterSupervisor(spec)
    managed = spec.managed_indices()
    for i in managed:
        sup._write_node_spec(i)
        sup.launch(i)
    tx = {
        "submitted": 0, "acked": 0, "shed": 0, "duplicate": 0,
        "failed": 0, "shed_window": 0, "shed_pool": 0,
        "shed_oversize": 0, "unclassified": 0,
    }
    killed = False
    restarted = False
    decided_at_heal: Optional[int] = None
    heal_wall_s: Optional[float] = None
    try:
        sup.wait_ready(managed)
        if sup.fleet is not None:
            sup.fleet.start_clock()   # partition windows count from here
        t0 = frame.now()
        t_end = t0 + spec.duration_s
        gap = 1.0 / spec.tx_rate if spec.tx_rate > 0 else None
        poll_gap = spec.metrics_poll_s if spec.metrics_poll_s > 0 else None
        next_submit = t0
        next_poll = t0 + (poll_gap or 0.0)
        k = 0
        while frame.now() < t_end:
            now = frame.now()
            if poll_gap is not None and now >= next_poll:
                next_poll += poll_gap
                sup.poll_metrics()
            if (
                not killed
                and spec.kill_index is not None
                and spec.kill_at_s is not None
                and now - t0 >= spec.kill_at_s
            ):
                sup.kill(spec.kill_index)
                killed = True
            if (
                killed and not restarted
                and spec.restart_at_s is not None
                and now - t0 >= spec.restart_at_s
            ):
                sup.restart(spec.kill_index)
                restarted = True
                heal_wall_s = frame.now() - t0
                decided = []
                for i in managed:
                    try:
                        decided.append(sup.client.status(i)["decided"])
                    except OSError:
                        pass
                decided_at_heal = min(decided) if decided else 0
            if gap is not None and now >= next_submit:
                next_submit += gap
                target = managed[k % len(managed)]
                payload = (b"tx-%08d:" % k).ljust(spec.tx_bytes, b"x")
                k += 1
                tx["submitted"] += 1
                # root of the transaction's trace: trace id = first 8
                # bytes of the tx id, parent 0 — the node's handling
                # span (and every gossip hop after it) parents under
                # this via the frame header's 16-byte context
                ctx = pack_context(crypto.hash_bytes(payload)[:8], 0)
                with sup.tracer.span_under(
                    "client.submit", ctx, node=target,
                ) as sp:
                    try:
                        _status, reply = sup.client.call(
                            target, frame.KIND_SUBMIT, payload,
                            trace=sup.tracer.active_context() or b"",
                        )
                    except OSError:
                        tx["failed"] += 1   # crash window: expected
                        sp.args["outcome"] = "failed"
                        continue
                    # uniform per-kind accounting: all three shed kinds
                    # land in their own bucket AND the aggregate, so the
                    # overload leg's shed rate is exact even when the
                    # sheds are SHED:window during a partition
                    bucket = classify_reply(reply) or "unclassified"
                    tx[bucket] = tx.get(bucket, 0) + 1
                    if bucket.startswith("shed_"):
                        tx["shed"] += 1
                    sp.args["outcome"] = bucket
            frame.sleep(min(0.002, gap or 0.002))
        # closing sweep with every node up: the rollup covers the fleet
        if poll_gap is not None:
            sup.poll_metrics()
    finally:
        sup.stop_all()
    # node trace shards land on clean shutdown — merge after stop_all
    try:
        trace_section, metrics_section = sup.write_telemetry()
    except (OSError, ValueError) as e:   # torn shard from a crash window
        trace_section = {"error": str(e)}
        metrics_section = {"error": str(e), "polls": sup.metrics_polls,
                           "nodes_covered": len(sup.metrics_samples)}
    return _verdict(
        spec, sup, tx,
        killed=killed, restarted=restarted,
        decided_at_heal=decided_at_heal, heal_wall_s=heal_wall_s,
        trace_section=trace_section, metrics_section=metrics_section,
    )


def _verdict(
    spec: ClusterSpec,
    sup: ClusterSupervisor,
    tx: Dict,
    killed: bool,
    restarted: bool,
    decided_at_heal: Optional[int],
    heal_wall_s: Optional[float],
    trace_section: Optional[Dict] = None,
    metrics_section: Optional[Dict] = None,
) -> Dict:
    """Assemble the safety/liveness verdict from the per-node reports
    and event logs left on disk."""
    members = [pk for pk, _ in member_keys(spec.n_nodes, spec.seed)]
    config = SwirldConfig(n_members=spec.n_nodes, seed=spec.seed)
    reports, union, nodes = collect_node_state(
        spec.workdir, spec.managed_indices(),
        sup.exit_codes, sup.restarts,
    )
    orders = [
        [bytes.fromhex(e) for e in rep["decided"]]
        for _, rep in sorted(reports.items())
    ]
    if union and orders:
        oracle = oracle_replay(
            union, members, config, observer_keypair(spec.seed),
        )
        safety = safety_section(orders, oracle)
    else:
        safety = {
            "prefix_agree": False, "oracle_agree": False,
            "common_prefix_len": 0, "oracle_len": 0,
        }
    decided_final = min((len(o) for o in orders), default=0)
    liveness = liveness_section(
        decided_final, decided_at_heal, heal_turn=heal_wall_s or 0,
    )
    n_managed = len(spec.managed_indices())
    expected_reports = n_managed if (restarted or not killed) \
        else n_managed - 1
    clean_exits = all(
        c == 0 for i, c in sup.exit_codes.items()
        if not (killed and not restarted and i == spec.kill_index)
    )
    ok = (
        verdict_ok(safety, liveness)
        and len(reports) >= expected_reports
        and clean_exits
    )
    ttf_lists = [rep.get("ttf_samples", []) for rep in reports.values()]
    latency = merged_dist(ttf_lists, "submit")
    tx_decided = max(
        (rep["decided_tx"] for rep in reports.values()), default=0,
    )
    out_tx = dict(tx)
    out_tx["decided"] = tx_decided
    out_tx["tx_per_s"] = (
        tx_decided / spec.duration_s if spec.duration_s > 0 else 0.0
    )
    out_tx.update(latency)
    shed_counters = {}
    for name in ("tx_shed_window", "tx_shed_pool", "tx_shed_oversize",
                 "tx_duplicate", "tx_accepted", "tx_submitted",
                 "wal_torn_tail_recovered",
                 "net_redials", "net_redial_probes"):
        shed_counters[name] = sum(
            rep["counters"].get(name, 0) for rep in reports.values()
        )
    return {
        "spec": {
            "n_nodes": spec.n_nodes, "seed": spec.seed,
            "duration_s": spec.duration_s, "tx_rate": spec.tx_rate,
            "kill_index": spec.kill_index, "kill_at_s": spec.kill_at_s,
            "restart_at_s": spec.restart_at_s,
        },
        "ok": ok,
        "safety": safety,
        "liveness": liveness,
        "faults": {
            "killed": killed,
            "restarted": restarted,
            "heal_wall_s": heal_wall_s,
        },
        "tx": out_tx,
        "counters": shed_counters,
        "proxy": dict(sup.fleet.stats) if sup.fleet is not None else {},
        "nodes": nodes,
        "reports": len(reports),
        "trace": trace_section or {},
        "metrics": metrics_section or {},
    }
