"""One cluster node as an OS process: server, gossip loop, durability.

``python -m tpu_swirld_torch.net.node_proc spec.json`` runs a single member of
a real-process cluster (:mod:`tpu_swirld_torch.net.cluster` writes the spec
and supervises N of these).  The runtime wires the unchanged
:class:`~tpu_swirld_torch.oracle.node.Node` to the real world:

- a :class:`NodeServer` accepts framed TCP requests and dispatches them
  — gossip (``ask_sync`` / ``ask_events``), client tx submission into a
  :class:`~tpu_swirld_torch.net.ingest.TxPool`, status probes, graceful stop;
- a gossip loop picks seeded-random peers, drains tx batches into event
  payloads via :class:`~tpu_swirld_torch.net.transport.SocketTransport`, runs
  consensus, and records each decided transaction into a
  :class:`~tpu_swirld_torch.obs.finality.FinalityTracker` (submission →
  decided wall latency);
- every own event is fsync'd into an :class:`~tpu_swirld_torch.net.wal.
  OwnEventWal` *before* it can be gossiped, and the node checkpoints
  periodically (atomic :func:`~tpu_swirld_torch.checkpoint.save_node`), so a
  ``kill -9`` at any instant restarts into checkpoint + WAL replay +
  pull-only recovery without ever equivocating against its own past;
- a WAL that exists but lacks the clean-shutdown marker means the
  previous incarnation died: :func:`startup_postmortem` dumps a flight-
  recorder post-mortem before the node rejoins.

Locking: ONE lock guards all node/pool/tracker state.  The gossip loop
holds it for a whole turn, but :class:`_YieldingTransport` releases it
around every blocking socket call (and the installed ``node._sleep``
releases it around real backoff sleeps), so server threads serve
incoming gossip while this node waits on the wire — two nodes syncing
into each other cannot deadlock.

The import chain stays free of ``torch`` (oracle node + checkpoint + obs),
so a node process starts in a fraction of a second and never touches the
card: the node runs the oracle, ``backend="python"``, as the reference's
node process does.
"""

from __future__ import annotations

import collections
import json
import os
import random
import socket
import threading
from typing import Dict, List, Optional, Tuple

from tpu_swirld_torch import crypto
from tpu_swirld_torch.checkpoint import load_node, save_node
from tpu_swirld_torch.config import SwirldConfig, resolve_net_settings
from tpu_swirld_torch.event import encode_event
from tpu_swirld_torch.net import frame
from tpu_swirld_torch.net.ingest import TxPool, decode_batch
from tpu_swirld_torch.net.transport import SocketTransport
from tpu_swirld_torch.net.wal import OwnEventWal
from tpu_swirld_torch.obs.finality import FinalityTracker
from tpu_swirld_torch.obs.flightrec import FlightRecorder
from tpu_swirld_torch.obs.registry import Registry
from tpu_swirld_torch.obs.tracer import Tracer
from tpu_swirld_torch.oracle.node import Node
from tpu_swirld_torch.sim import member_keys

REPORT_VERSION = 2

#: trace-shard memory bounds: spans kept per node process, and how many
#: submitted-tx trace contexts are remembered for decided correlation
TRACE_MAX_EVENTS = 200_000
TX_TRACE_CAP = 4096


def derive_paths(workdir: str, index: int) -> Dict[str, str]:
    """Per-node file layout inside the cluster workdir — shared
    vocabulary between this runtime and the supervisor."""
    stem = os.path.join(workdir, f"node-{index}")
    return {
        "ckpt": stem + ".swck",
        "wal": stem + ".wal",
        "report": stem + ".report.json",
        "events": stem + ".events.bin",
        "ready": stem + ".ready",
        "trace": stem + ".trace.jsonl",
    }


def startup_postmortem(
    wal: OwnEventWal, rec: FlightRecorder, label: str,
) -> Optional[str]:
    """Dump a post-mortem when the WAL shows an unclean shutdown.

    The previous incarnation died without writing the clean marker — the
    one moment a black box earns its keep.  Returns the dump path, or
    ``None`` when the shutdown was clean (or no dump dir / budget).
    """
    if not wal.unclean:
        return None
    return rec.trigger(
        "unclean_shutdown",
        node=label,
        detail={
            "wal_path": wal.path,
            "wal_events": len(wal.events),
            "torn_tail_recovered": wal.torn_tail_recovered,
        },
    )


class _YieldingTransport:
    """Transport wrapper that releases the runtime lock around blocking
    socket I/O.  The gossip loop owns the lock for a whole turn; without
    this, a server thread handling a peer's sync would wait on the lock
    while our own outbound call waits on that peer's equally-blocked
    loop — a distributed deadlock.  ``call`` is only ever invoked with
    the lock held (by the gossip loop's turn)."""

    def __init__(self, inner: SocketTransport, lock: threading.Lock):
        self.inner = inner
        self.lock = lock

    def endpoint(self, dst: bytes, channel: str):
        return self.inner.endpoint(dst, channel)

    def call(self, src: bytes, dst: bytes, channel: str, payload: bytes):
        self.lock.release()
        try:
            return self.inner.call(src, dst, channel, payload)
        finally:
            self.lock.acquire()

    def close(self) -> None:
        self.inner.close()


class NodeServer:
    """Framed-TCP server: one accept loop, one daemon thread per
    connection, every request answered through one ``dispatch``
    callable.  All mutable runtime state lives behind the dispatch
    closure's lock — worker threads store nothing on ``self``, so the
    SW006 audit surface is empty by construction."""

    def __init__(self, host: str, port: int, dispatch, max_frame: int):
        self._dispatch = dispatch
        self._max_frame = max_frame
        self._stopping = threading.Event()
        # the port may be held by the supervisor's reservation
        self._sock = frame.listen_socket(host, port, 32)
        self._accept_thread = threading.Thread(
            target=self._serve, daemon=True,
        )
        self._accept_thread.start()

    def _serve(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return   # listener closed: shutdown
            threading.Thread(
                target=self._handle, args=(conn,), daemon=True,
            ).start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while True:
                kind, src, payload, trace = frame.recv_request(
                    conn, self._max_frame,
                )
                try:
                    status, reply = self._dispatch(kind, src, payload, trace)
                except ValueError as e:
                    # the endpoints' documented rejection plane: counted
                    # by the caller as a bad reply, never retried
                    status, reply = frame.STATUS_REJECT, str(e).encode()
                except Exception as e:   # server bug: retryable plane
                    status, reply = (
                        frame.STATUS_ERROR,
                        f"{type(e).__name__}: {e}".encode()[:512],
                    )
                frame.send_reply(conn, status, reply)
        except (ConnectionError, OSError):
            pass   # client went away (incl. frame garbage): drop conn
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._stopping.set()
        try:
            self._sock.close()
        except OSError:
            pass


class NodeRuntime:
    """The per-process composition: durable node + pool + server + loop.

    Built from a *spec* dict (see :func:`main`): the member index, the
    shared ``(n_nodes, seed)`` identity rule, the full host/port
    topology, and the workdir holding this node's checkpoint/WAL/report
    files.  The constructor performs the whole crash-recovery sequence —
    WAL scan (+ startup post-mortem), checkpoint restore, WAL replay —
    and :meth:`run` serves until a STOP request or the optional duration
    elapses, then checkpoints, writes the report, and marks the WAL
    clean.
    """

    def __init__(self, spec: Dict):
        self.spec = spec
        self.index = int(spec["index"])
        self.n_nodes = int(spec["n_nodes"])
        self.seed = int(spec.get("seed", 0))
        self.host = spec.get("host", "127.0.0.1")
        self.ports: List[int] = [int(p) for p in spec["ports"]]
        self.workdir = spec["workdir"]
        self.paths = derive_paths(self.workdir, self.index)
        self.settings = resolve_net_settings()
        self.settings.update(spec.get("net") or {})
        self.duration_s = spec.get("duration_s")
        self.label = f"n{self.index}"

        keys = member_keys(self.n_nodes, self.seed)
        self.pk, self.sk = keys[self.index]
        self.members = [pk for pk, _ in keys]
        self.config = SwirldConfig(n_members=self.n_nodes, seed=self.seed)

        self.lock = threading.Lock()
        self.stop = threading.Event()

        # --- telemetry: per-process trace shard + metrics registry --------
        # All tracer/registry mutation happens under self.lock (dispatch
        # and the gossip turn both hold it), so server threads and the
        # loop interleave spans without torn state.
        self.tracer = Tracer(pid=self.index, max_events=TRACE_MAX_EVENTS)
        self.registry = Registry()
        #: txid -> wire trace context for txs submitted to THIS node,
        #: so the decided marker closes the trace where it began
        self._tx_traces: "collections.OrderedDict[bytes, bytes]" = (
            collections.OrderedDict()
        )
        #: context stamped onto outgoing gossip frames for the *current*
        #: traced turn (read lock-free by the transport while the lock is
        #: yielded around socket I/O — a bytes snapshot, not stack state)
        self._gossip_ctx = b""

        # --- durability: WAL scan + startup post-mortem -------------------
        self.wal = OwnEventWal(self.paths["wal"], pk=self.pk)
        self.unclean_start = self.wal.unclean
        self.flightrec = FlightRecorder(
            dump_dir=spec.get("flightrec_dir"),
            wall_clock=frame.now,
            config=self.config,
            node_name=self.label,
            trace_provider=self.tracer.active_trace_hex,
        )
        self.flightrec_dump = startup_postmortem(
            self.wal, self.flightrec, self.label,
        )

        # --- transport + node (checkpoint restore when one exists) -------
        sock_transport = SocketTransport(settings=self.settings, src=self.pk)
        sock_transport.trace_provider = lambda: self._gossip_ctx
        # optional per-peer address overrides: the soak supervisor routes
        # node-to-node links through its FaultyProxy fleet by pointing
        # each peer at the matching link proxy instead of the real port
        peer_addrs = {
            int(k): (v[0], int(v[1]))
            for k, v in (spec.get("peer_addrs") or {}).items()
        }
        for j, pk_j in enumerate(self.members):
            if j != self.index:
                h, p = peer_addrs.get(j, (self.host, self.ports[j]))
                sock_transport.register(pk_j, h, p)
        self.transport = sock_transport
        yielding = _YieldingTransport(sock_transport, self.lock)
        self.dynamic = bool(spec.get("dynamic"))
        #: queued MTX1 blobs (KIND_MTX): each rides one gossip event's
        #: payload whole — membership txs are never batched with client
        #: txs, because decode_tx reads the full event payload
        self._pending_mtx: List[bytes] = []
        self.restored = os.path.exists(self.paths["ckpt"])
        if self.restored:
            # a dynamic node's checkpoint carries its membership header,
            # so load_node restores the right class on its own
            self.node = load_node(
                self.paths["ckpt"], sk=self.sk, pk=self.pk, network={},
                transport=yielding,
            )
        elif self.dynamic:
            from tpu_swirld_torch.membership.dynamic import DynamicNode

            self.node = DynamicNode(
                sk=self.sk, pk=self.pk, network={}, members=self.members,
                config=self.config, transport=yielding,
            )
        else:
            self.node = Node(
                sk=self.sk, pk=self.pk, network={}, members=self.members,
                config=self.config, transport=yielding,
            )
            # the genesis is durable before anything can be gossiped.
            # On a crash *before the first checkpoint* the WAL already
            # starts with this exact genesis (the lamport-clock genesis
            # is bit-deterministic) — appending again would put it after
            # the real tail and defeat the pull-only recovery guard.
            if not self.wal.events:
                self.wal.append(self.node.hg[self.node.head])
        # real backoff: Node records logical delays; scale them onto the
        # wall clock, capped so a long breaker cooldown cannot stall a
        # whole gossip turn.  Runs with the lock held — yield it.
        tick_s = float(self.settings["retry_tick_s"])

        def _net_sleep(ticks: float) -> None:
            self.lock.release()
            try:
                frame.sleep(min(ticks * tick_s, 0.5))
            finally:
                self.lock.acquire()

        self.node._sleep = _net_sleep

        # --- WAL replay: events since the last checkpoint -----------------
        wal_ids: List[bytes] = []
        self.node._ingest(self.wal.events, wal_ids)
        if wal_ids:
            self.node.consensus_pass(wal_ids)

        # --- tx ingestion + finality tracking -----------------------------
        self.pool = TxPool(
            max_pool=self.settings["tx_pool_txs"],
            batch_bytes=self.settings["tx_batch_bytes"],
            max_tx_bytes=self.settings["tx_max_bytes"],
            max_undecided=self.settings["max_undecided"],
            window_fn=lambda: self.node.undecided_window,
        )
        self.tracker = FinalityTracker(
            "cluster", clock=frame.now, registry=self.registry,
        )
        self.decided_txids: set = set()
        self.decided_tx = 0
        self._decided_watermark = 0
        self._rng = random.Random(
            int.from_bytes(
                crypto.hash_bytes(b"netproc" + self.pk)[:8], "little",
            )
            ^ self.seed
        )
        self.server: Optional[NodeServer] = None

    # ------------------------------------------------------------ dispatch

    def dispatch(self, kind: int, src: bytes, payload: bytes,
                 trace: bytes = b"") -> Tuple[int, bytes]:
        """Serve one framed request (called from server threads); a
        non-empty ``trace`` is the sender's 16-byte span context — the
        handler's span becomes its cross-process child."""
        if kind == frame.KIND_PING:
            return frame.STATUS_OK, b"pong"
        if kind == frame.KIND_STOP:
            self.stop.set()
            return frame.STATUS_OK, b"stopping"
        if kind == frame.KIND_SUBMIT:
            with self.lock:
                with self.tracer.span_under("node.submit", trace) as sp:
                    accepted, reply = self.pool.submit(payload)
                    sp.args["outcome"] = (
                        reply.split(b":", 1)[0].decode("ascii", "replace")
                    )
                    # remember THIS span's context: the gossip turn that
                    # drains the tx parents under it, extending the trace
                    own_ctx = self.tracer.active_context()
                if accepted:
                    txid = crypto.hash_bytes(payload)
                    self.tracker.mark_birth(txid)
                    if own_ctx:
                        self._remember_trace(txid, own_ctx)
            return frame.STATUS_OK, reply
        if kind == frame.KIND_MTX:
            # a refused membership tx is a server-side error reply
            if not hasattr(self.node, "ledger"):
                return frame.STATUS_ERROR, b"MTX:static-cluster"
            from tpu_swirld_torch.membership.txs import decode_tx
            if decode_tx(payload) is None:
                return frame.STATUS_ERROR, b"MTX:malformed"
            with self.lock:
                self._pending_mtx.append(payload)
            return frame.STATUS_OK, b"MTX:queued"
        if kind == frame.KIND_STATUS:
            with self.lock:
                body = json.dumps(self.status()).encode()
            return frame.STATUS_OK, body
        if kind == frame.KIND_METRICS:
            with self.lock:
                body = json.dumps(self.metrics_snapshot()).encode()
            return frame.STATUS_OK, body
        if kind == frame.KIND_SYNC:
            with self.lock:
                if trace:
                    with self.tracer.span_under(
                        "node.serve_sync", trace,
                    ) as sp:
                        reply = self.node.ask_sync(src, payload)
                        sp.args["reply_bytes"] = len(reply)
                    return frame.STATUS_OK, reply
                return frame.STATUS_OK, self.node.ask_sync(src, payload)
        if kind == frame.KIND_WANT:
            with self.lock:
                if trace:
                    with self.tracer.span_under(
                        "node.serve_want", trace,
                    ) as sp:
                        reply = self.node.ask_events(src, payload)
                        sp.args["reply_bytes"] = len(reply)
                    return frame.STATUS_OK, reply
                return frame.STATUS_OK, self.node.ask_events(src, payload)
        raise ValueError(f"unknown request kind {kind}")

    def _remember_trace(self, txid: bytes, trace: bytes) -> None:
        """Bounded txid -> submit-context map (oldest evicted first)."""
        self._tx_traces[txid] = trace
        while len(self._tx_traces) > TX_TRACE_CAP:
            self._tx_traces.popitem(last=False)

    # -------------------------------------------------------------- status

    def status(self) -> Dict:
        """Supervisor probe body (caller holds the lock)."""
        node = self.node
        return {
            "index": self.index,
            "pk": self.pk.hex(),
            "events": len(node.hg),
            "decided": len(node.consensus),
            "decided_tx": self.decided_tx,
            "undecided_window": node.undecided_window,
            "pending_txs": len(self.pool.pending),
            "recovering": self._recovering(),
            "unclean_start": self.unclean_start,
            "flightrec_dump": self.flightrec_dump,
            "membership_epoch": getattr(node, "membership_epoch", 0),
            "pending_mtx": len(self._pending_mtx),
        }

    def metrics_snapshot(self) -> Dict:
        """Registry snapshot body for :data:`frame.KIND_METRICS` (caller
        holds the lock): the live counters from pool / transport / node
        are synced into the registry as gauges first, so the supervisor
        sees one structured sample stream per node."""
        reg = self.registry
        node = self.node
        for k in sorted(self.pool.counters):
            reg.gauge(k).set(self.pool.counters[k])
        for k in sorted(self.transport.stats):
            reg.gauge(f"net_{k}").set(self.transport.stats[k])
        reg.gauge("node_retries").set(node.retries)
        reg.gauge("node_bad_replies").set(node.bad_replies)
        reg.gauge("node_bad_requests").set(node.bad_requests)
        reg.gauge("node_circuit_opens").set(node.circuit_opens)
        reg.gauge("hg_events").set(len(node.hg))
        reg.gauge("decided_events").set(len(node.consensus))
        reg.gauge("decided_tx").set(self.decided_tx)
        reg.gauge("pending_txs").set(len(self.pool.pending))
        reg.gauge("undecided_window").set(node.undecided_window)
        reg.gauge("wal_torn_tail_recovered").set(
            self.wal.torn_tail_recovered
        )
        reg.gauge("trace_events").set(len(self.tracer.events))
        reg.gauge("membership_epoch").set(
            getattr(node, "membership_epoch", 0))
        reg.gauge("members_active").set(
            getattr(node, "members_active", len(node.members)))
        reg.gauge("stake_total").set(
            getattr(node, "stake_total", node.tot_stake))
        return {
            "node": self.label,
            "index": self.index,
            "samples": reg.to_samples(),
        }

    def _recovering(self) -> bool:
        """Pre-crash tip not yet re-reached: pull-only until it is, so
        this node never signs below its own durable history (the
        amnesia-fork guard the chaos harness pins in-process)."""
        return bool(
            self.wal.events
            and self.node.head != self.wal.events[-1].id
        )

    # ----------------------------------------------------------- main loop

    def _turn(self) -> None:
        """One gossip turn (caller holds the lock)."""
        node = self.node
        peers = [m for m in self.members if m != self.pk]
        peer = self._rng.choice(peers)
        if self._recovering():
            got = node.pull(peer)
            if got:
                node.consensus_pass(got)
        else:
            # a batch is only drained when the sync will actually create
            # an event (sync is a no-op until the peer is known) — a
            # batch fed to a no-op sync would be silently dropped.  A
            # queued membership tx takes the turn's payload slot whole
            # (client batches wait one turn): decode_tx reads the full
            # event payload, so an MTX1 blob can never share an event
            # with a client batch.
            mtx = None
            if not node.member_events[peer]:
                batch = b""
            elif self._pending_mtx:
                mtx = batch = self._pending_mtx.pop(0)
            else:
                batch = self.pool.next_batch()
            prev_head = node.head
            ctx = self._batch_trace(batch)
            if ctx:
                with self.tracer.span_under("gossip.sync", ctx) as sp:
                    sp.args["peer"] = peer[:4].hex()
                    sp.args["batch_bytes"] = len(batch)
                    # snapshot for the transport to stamp onto the
                    # outgoing frames of this turn (read without lock)
                    self._gossip_ctx = self.tracer.active_context() or b""
                    try:
                        self._sync_step(peer, batch)
                    finally:
                        self._gossip_ctx = b""
            else:
                self._sync_step(peer, batch)
            if mtx is not None and node.head == prev_head:
                # the sync minted no event (transport failure, circuit
                # breaker): the membership tx must not vanish — requeue
                # it for the next turn
                self._pending_mtx.insert(0, mtx)
        self._record_decided()

    def _sync_step(self, peer: bytes, batch: bytes) -> None:
        """The durable sync body (caller holds the lock)."""
        node = self.node
        prev_head = node.head
        new_ids = node.sync(peer, batch)
        if node.head != prev_head:
            # durable BEFORE any peer can observe it: the lock is
            # held until after this fsync completes
            self.wal.append(node.hg[node.head])
        if new_ids:
            node.consensus_pass(new_ids)

    def _batch_trace(self, batch: bytes) -> bytes:
        """Submit-span context of the first traced tx in ``batch`` (the
        turn that first gossips a traced submission joins its trace)."""
        if not batch or not self._tx_traces:
            return b""
        for tx in decode_batch(batch):
            ctx = self._tx_traces.get(crypto.hash_bytes(tx))
            if ctx:
                return ctx
        return b""

    def _record_decided(self) -> None:
        """Walk newly decided events; record each decided transaction's
        submission→decided latency (birth known only for txs submitted
        to this node)."""
        node = self.node
        t = frame.now()
        while self._decided_watermark < len(node.consensus):
            eid = node.consensus[self._decided_watermark]
            self._decided_watermark += 1
            for tx in decode_batch(node.hg[eid].d):
                txid = crypto.hash_bytes(tx)
                if txid in self.decided_txids:
                    continue
                self.decided_txids.add(txid)
                self.decided_tx += 1
                self.tracker.record_decided(
                    txid,
                    node.round.get(eid, 0),
                    node.round_received.get(eid, 0),
                    now=t,
                )
                ctx = self._tx_traces.pop(txid, None)
                if ctx is not None:
                    # zero-length marker span closing the trace on the
                    # node that accepted the submission
                    with self.tracer.span_under("tx.decided", ctx) as sp:
                        sp.args["round_received"] = (
                            node.round_received.get(eid, 0)
                        )

    def _checkpoint(self) -> None:
        """Atomic checkpoint + WAL prune (caller holds the lock): after
        ``save_node`` covers everything in the store, only own events
        the store does *not* hold (none, for a live node) stay in the
        WAL — so the WAL is always exactly the tail since the last
        checkpoint."""
        save_node(self.paths["ckpt"], self.node)
        self.wal.rewrite(
            [ev for ev in self.wal.events if ev.id not in self.node.hg]
        )

    def _await_peers(self, deadline_s: float) -> None:
        """Hold the first gossip turn until every peer's listener accepts a
        connection, or ``deadline_s`` passes (the port's addition to the
        reference's runtime).  A node that gossips before its peers listen
        fails its syncs, opens every peer's circuit breaker, and keeps them
        open: a breaker's cooldown runs on the node's lamport clock, the
        events in its store, which only its own syncs advance.  A restarted
        node finds its peers up and passes at once."""
        pending = dict(self.transport.addrs)
        end = frame.now() + deadline_s
        while pending and not self.stop.is_set() and frame.now() < end:
            for pk, addr in list(pending.items()):
                try:
                    socket.create_connection(addr, timeout=0.2).close()
                except OSError:
                    continue
                del pending[pk]
            if pending:
                frame.sleep(0.01)

    def run(self) -> int:
        self.server = NodeServer(
            self.host, self.ports[self.index], self.dispatch,
            int(self.settings["max_frame_bytes"]),
        )
        # readiness marker: the server socket is accepting
        with open(self.paths["ready"], "w") as f:
            json.dump({"index": self.index, "pid": os.getpid()}, f)
        self._await_peers(float(self.settings["connect_timeout_s"]))
        t0 = frame.now()
        interval = float(self.settings["gossip_interval_s"])
        ckpt_every = float(self.settings["checkpoint_every_s"])
        next_ckpt = t0 + ckpt_every
        try:
            while not self.stop.is_set():
                if (
                    self.duration_s is not None
                    and frame.now() - t0 >= float(self.duration_s)
                ):
                    break
                with self.lock:
                    self._turn()
                    if frame.now() >= next_ckpt:
                        self._checkpoint()
                        next_ckpt = frame.now() + ckpt_every
                frame.sleep(interval)
        finally:
            self.server.close()
        with self.lock:
            self._record_decided()
            self._checkpoint()
            self._write_report()
            self._write_trace()
            self.wal.mark_clean()
        self.transport.close()
        return 0

    def _write_trace(self) -> None:
        """Per-process Chrome-trace JSONL shard (caller holds the lock);
        ``obs/cluster_trace.py`` merges one per node + the supervisor's
        client shard into the cluster timeline."""
        self.tracer.save(self.paths["trace"])

    # -------------------------------------------------------------- report

    def _write_report(self) -> None:
        node = self.node
        counters: Dict[str, float] = dict(self.pool.counters)
        counters["wal_torn_tail_recovered"] = self.wal.torn_tail_recovered
        counters.update(
            {f"net_{k}": v for k, v in sorted(self.transport.stats.items())}
        )
        counters["node_retries"] = node.retries
        counters["node_bad_replies"] = node.bad_replies
        counters["node_bad_requests"] = node.bad_requests
        counters["node_circuit_opens"] = node.circuit_opens
        counters["node_equivocations_detected"] = \
            node.equivocations_detected
        counters["node_budget_exhausted"] = node.budget_exhausted
        report = {
            "report_version": REPORT_VERSION,
            "node": self.label,
            "index": self.index,
            "pk": self.pk.hex(),
            "seed": self.seed,
            "trace": self.paths["trace"],
            "trace_events": len(self.tracer.events),
            "trace_dropped": self.tracer.dropped,
            "restored": self.restored,
            "unclean_start": self.unclean_start,
            "flightrec_dump": self.flightrec_dump,
            "decided": [e.hex() for e in node.consensus],
            "decided_tx": self.decided_tx,
            "events": len(node.hg),
            "membership_epoch": getattr(node, "membership_epoch", 0),
            "membership_epochs": (
                len(node.ledger.epochs)
                if hasattr(node, "ledger") else 1
            ),
            "members_active": getattr(
                node, "members_active", len(node.members)),
            "stake_total": getattr(node, "stake_total", node.tot_stake),
            "counters": counters,
            "finality": self.tracker.summary(),
            "ttf_samples": list(self.tracker.ttf),
        }
        with open(self.paths["events"], "wb") as f:
            f.write(
                b"".join(encode_event(node.hg[e]) for e in node.order_added)
            )
        tmp = self.paths["report"] + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        os.replace(tmp, self.paths["report"])


def main(argv: List[str]) -> int:
    if len(argv) != 1:
        raise SystemExit(
            "usage: python -m tpu_swirld_torch.net.node_proc spec.json"
        )
    with open(argv[0]) as f:
        spec = json.load(f)
    return NodeRuntime(spec).run()


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv[1:]))
