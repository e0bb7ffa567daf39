"""Socket-level fault injection: a per-link TCP interposer fleet.

The in-process :class:`~tpu_swirld_torch.transport.FaultyTransport` applies a
seeded :class:`~tpu_swirld_torch.transport.FaultPlan` around a function call;
this module applies the SAME plan vocabulary to real TCP connections, so
the in-process fault schedule — per-link drop / corrupt / duplicate / reorder
/ delay probabilities and scheduled :class:`~tpu_swirld_torch.transport.
Partition` windows — now exercises the genuine network machinery:
:class:`~tpu_swirld_torch.net.transport.SocketTransport` redials, the node's
``RetryPolicy`` backoff, circuit breakers, and WAL/crash recovery under
actual connection loss.

Topology: one :class:`FaultyProxy` per *directed* link ``src -> dst``
listens on its own ephemeral port and relays length-prefixed frames to
the destination node's real port.  The cluster supervisor hands node
``src`` a ``peer_addrs`` map pointing every peer at the matching link
proxy, so all node-to-node gossip crosses an interposer while the
supervisor's own control plane (submit / status / stop) stays direct.

Fault semantics on a stream (vs the in-process call):

- **partition** — a frame arriving while ``plan.partitioned(src, dst,
  clock())`` holds closes the connection; the caller sees a connection
  error (its retryable plane) until the window heals.
- **drop** — a TCP stream cannot lose one message and stay framed, so a
  dropped request or reply tears the connection down; the caller redials.
- **corrupt** — the frame body is mangled with the exact
  :meth:`FaultyTransport._corrupt` modes (truncate / bit-flip / empty)
  and re-length-prefixed, surfacing as the receiver's documented
  bad-frame or counted-rejection path.
- **duplicate / reorder / delay(prob)** — stale-reply semantics matching
  the in-process transport: replies are stashed per link and swapped in
  for fresh ones, preserving one-reply-per-request framing (the caller's
  idempotent-ingest path absorbs staleness).
- **reset** — hard teardown AFTER the destination processed the request:
  the redial-after-success hazard only a real socket can produce.
- **delay_s / throttle_bps** — real held/paced bytes via the net layer's
  clock seam (:func:`tpu_swirld_torch.net.frame.sleep`).

Every draw comes from a per-directed-link RNG stream keyed
``SeedSequence(plan.seed, spawn_key=(src_i + 1, dst_i + 1))`` — the same
hash-stable construction as the in-process injector, so a link's fault
sequence is a pure function of ``(plan.seed, src, dst, frame#)``.  The
clock is injected (the fleet's default counts wall seconds from
:meth:`ProxyFleet.start_clock` via :func:`frame.now`), so this module
never reads wall time directly and stays SW003-clean.
"""

from __future__ import annotations

import collections
import socket
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from tpu_swirld_torch.net import frame
from tpu_swirld_torch.transport import FaultPlan, FaultyTransport

#: reply hold when a ``delay`` fault fires and the plan gives no delay_s
DEFAULT_DELAY_S = 0.05

#: stale replies stashed per link (mirrors FaultyTransport._pending)
STASH_DEPTH = 8

#: upstream connect/read deadline: a wedged destination must not pin a
#: relay thread forever (the caller's own call timeout is shorter)
UPSTREAM_TIMEOUT_S = 30.0


def _recv_raw(sock: socket.socket, max_frame: int) -> bytes:
    """One whole length-prefixed frame body (without the prefix)."""
    (nbytes,) = frame._LEN.unpack(frame.recv_exact(sock, 4))
    if nbytes < 1 or nbytes > max_frame:
        raise frame.FrameError(f"bad relayed frame length {nbytes}")
    return frame.recv_exact(sock, nbytes)


def _send_raw(sock: socket.socket, body: bytes) -> None:
    sock.sendall(frame._LEN.pack(len(body)) + body)


class FaultyProxy:
    """One directed link's TCP interposer.

    Accepts connections on its own listener, relays request frames to
    ``upstream`` and reply frames back, applying the link's
    :class:`LinkFaults` and the plan's partition windows per frame.  All
    connections on the link share one seeded RNG stream and one
    stale-reply stash (lock-guarded), so the fault sequence follows
    frame-arrival order on the link, not per-connection history.
    """

    #: mutable state the accept/relay threads share under ``_lock``
    #: (SW006 lock-discipline): the open-connection roster close() must
    #: sweep, and the stale-reply stash the duplicate/swap faults
    #: exchange across connections.
    GUARDED_ATTRS = frozenset({"_conns", "_stash"})

    def __init__(
        self,
        src_i: int,
        dst_i: int,
        upstream: Tuple[str, int],
        plan: FaultPlan,
        clock: Callable[[], float],
        count: Callable[[str], None],
        host: str = "127.0.0.1",
        port: int = 0,
        max_frame: int = frame.MAX_FRAME_BYTES,
    ):
        self.src_i = src_i
        self.dst_i = dst_i
        self.upstream = upstream
        self.plan = plan
        self.clock = clock
        self._count = count
        self.max_frame = max_frame
        self._rng = np.random.default_rng(
            np.random.SeedSequence(
                plan.seed, spawn_key=(src_i + 1, dst_i + 1),
            )
        )
        self._lock = threading.Lock()
        self._stash: collections.deque = collections.deque(
            maxlen=STASH_DEPTH,
        )
        self._stopping = threading.Event()
        self._conns: List[socket.socket] = []
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.addr: Tuple[str, int] = self._sock.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._serve, daemon=True,
        )
        self._accept_thread.start()

    # ----------------------------------------------------------- threads

    def _serve(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return   # listener closed: shutdown
            with self._lock:
                self._conns.append(conn)
            threading.Thread(
                target=self._relay, args=(conn,), daemon=True,
            ).start()

    def _verdict(self, body_len: int) -> Dict:
        """Sample this frame's fate (lock-held: the RNG and stash are
        shared across every connection the link carries)."""
        lf = self.plan.faults_for(self.src_i, self.dst_i)
        r = self._rng
        return {
            "partitioned": self.plan.partitioned(
                self.src_i, self.dst_i, self.clock(),
            ),
            "drop_req": r.random() < lf.drop,
            "corrupt_req": r.random() < lf.corrupt,
            "drop_rep": r.random() < lf.drop,
            "corrupt_rep": r.random() < lf.corrupt,
            "duplicate": r.random() < lf.duplicate,
            "swap": r.random() < max(lf.reorder, lf.duplicate, lf.delay),
            "delay": r.random() < lf.delay,
            "reset": r.random() < lf.reset,
            "hold_s": lf.delay_s or DEFAULT_DELAY_S,
            "throttle_s": (
                body_len / lf.throttle_bps if lf.throttle_bps > 0 else 0.0
            ),
        }

    def _relay(self, client: socket.socket) -> None:
        upstream: Optional[socket.socket] = None
        try:
            client.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while not self._stopping.is_set():
                req = _recv_raw(client, self.max_frame)
                with self._lock:
                    v = self._verdict(len(req))
                    if v["corrupt_req"]:
                        req = FaultyTransport._corrupt(req, self._rng)
                if v["partitioned"]:
                    self._count("partition_blocked")
                    return
                if v["drop_req"]:
                    self._count("drops")
                    return
                if v["corrupt_req"]:
                    self._count("corruptions")
                if v["delay"]:
                    self._count("delays")
                    frame.sleep(v["hold_s"])
                if v["throttle_s"] > 0:
                    self._count("throttled")
                    frame.sleep(v["throttle_s"])
                if not req:
                    return   # corruption emptied the frame: dead link
                if upstream is None:
                    upstream = socket.create_connection(
                        self.upstream, timeout=UPSTREAM_TIMEOUT_S,
                    )
                    upstream.setsockopt(
                        socket.IPPROTO_TCP, socket.TCP_NODELAY, 1,
                    )
                    upstream.settimeout(UPSTREAM_TIMEOUT_S)
                _send_raw(upstream, req)
                rep = _recv_raw(upstream, self.max_frame)
                if v["reset"]:
                    # the destination DID process the request; the caller
                    # sees a torn connection — redial-after-success
                    self._count("resets")
                    return
                if v["drop_rep"]:
                    self._count("drops")
                    return
                with self._lock:
                    if v["corrupt_rep"]:
                        self._count("corruptions")
                        rep = FaultyTransport._corrupt(rep, self._rng)
                    if v["duplicate"]:
                        self._count("duplicates")
                        self._stash.append(rep)
                    if self._stash and v["swap"]:
                        # a previously stashed reply surfaces stale; the
                        # fresh one is stashed in exchange, never lost
                        self._count("reorders")
                        self._stash.append(rep)
                        rep = self._stash.popleft()
                if not rep:
                    return
                # count BEFORE the send: once the caller holds the reply
                # the counter is already visible (stats never lag an
                # observed response)
                self._count("relayed")
                _send_raw(client, rep)
        except (ConnectionError, OSError):
            pass   # either side went away: drop the pair
        finally:
            for s in (client, upstream):
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass

    def close(self) -> None:
        self._stopping.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass


class ProxyFleet:
    """Every directed link of an ``n_nodes`` cluster, interposed.

    ``upstream_ports[j]`` is node ``j``'s real listener; the fleet
    allocates one proxy port per ordered pair and the supervisor routes
    node ``i``'s view of peer ``j`` through :meth:`addr_for(i, j)
    <addr_for>`.  Partition windows are evaluated against the injected
    ``clock`` (or the fleet's own run-relative seconds clock, armed by
    :meth:`start_clock` — before arming it reads ``-1.0`` so no window
    with a non-negative start can fire during node boot).

    Counters aggregate fleet-wide in :attr:`stats` (``relayed``,
    ``drops``, ``corruptions``, ``delays``, ``duplicates``, ``reorders``,
    ``resets``, ``throttled``, ``partition_blocked``).
    """

    def __init__(
        self,
        plan: FaultPlan,
        n_nodes: int,
        upstream_ports: List[int],
        host: str = "127.0.0.1",
        clock: Optional[Callable[[], float]] = None,
        max_frame: int = frame.MAX_FRAME_BYTES,
    ):
        self.plan = plan
        self.host = host
        self._t0: Optional[float] = None
        self.clock = clock if clock is not None else self._elapsed
        self.stats: Dict[str, int] = collections.defaultdict(int)
        self._stats_lock = threading.Lock()
        self.proxies: Dict[Tuple[int, int], FaultyProxy] = {}
        for i in range(n_nodes):
            for j in range(n_nodes):
                if i == j:
                    continue
                self.proxies[(i, j)] = FaultyProxy(
                    i, j, (host, upstream_ports[j]), plan,
                    clock=self.clock, count=self._count, host=host,
                    max_frame=max_frame,
                )

    def _count(self, name: str) -> None:
        with self._stats_lock:
            self.stats[name] += 1

    def _elapsed(self) -> float:
        return -1.0 if self._t0 is None else frame.now() - self._t0

    def start_clock(self) -> None:
        """Arm the partition clock: window times are seconds from now."""
        self._t0 = frame.now()

    def addr_for(self, src_i: int, dst_i: int) -> Tuple[str, int]:
        """Where node ``src_i`` should dial to reach peer ``dst_i``."""
        return self.proxies[(src_i, dst_i)].addr

    def close(self) -> None:
        for key in sorted(self.proxies):
            self.proxies[key].close()
