"""Heavy-tailed client traffic against a live cluster.

The supervisor's built-in driver submits on a fixed metronome; real
production load is nothing like that.  This module models the three
shapes that actually break ingestion paths:

- **Pareto inter-arrival** — heavy-tailed gaps (seeded, per client):
  long quiet stretches punctuated by clumps, so the TxPool's admission
  window sees feast-and-famine instead of a steady drip.  Gaps are drawn
  as ``base_gap * (alpha - 1) * pareto(alpha)`` so the mean stays at
  ``base_gap`` (= ``n_clients / rate``) while the tail index is
  ``alpha`` — ``alpha <= 1`` would have infinite mean and is rejected.
- **burst trains** — every ``burst_every_s`` a client fires
  ``burst_len`` back-to-back submissions with no pacing, the overload
  leg that exercises ``SHED:window`` / ``SHED:pool`` shedding.
- **reconnect storms** — every ``reconnect_every_s`` a client tears
  down ALL its cached connections and redials, the thundering-herd
  pattern after an LB failover; counted in the ledger as
  ``reconnects``.

Every client thread owns a seeded RNG stream
(``SeedSequence(plan.seed, spawn_key=(client_i + 1,))``), so the
submission *schedule* is deterministic per seed; only wall-clock
interleaving with the cluster varies.

The ledger is the accounting half of the soak verdict: every submitted
transaction must land in exactly one outcome bucket (acked / duplicate /
shed_window / shed_pool / shed_oversize / failed / unclassified), and
the soak's "zero shed-accounting leaks" section asserts both that the
buckets sum back to ``submitted`` and that ``unclassified`` is zero.
The classifier is injectable precisely so the seeded red-verdict
mutation can silently un-count one shed kind and the leak detector must
catch it.

Time flows through injectable ``clock``/``sleep`` seams (defaulting to
the net layer's :func:`frame.now`/:func:`frame.sleep`), so this module
itself is SW003-clean and tests can drive it on a fake clock.
"""

from __future__ import annotations

import dataclasses
import socket
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from tpu_swirld_torch.net import frame

#: ledger buckets every submission must land in exactly one of
OUTCOMES = (
    "acked", "duplicate", "shed_window", "shed_pool", "shed_oversize",
    "failed", "unclassified",
)


def classify_reply(reply: bytes) -> Optional[str]:
    """Map a TxPool submit reply onto its ledger bucket.

    The pool's documented reply grammar is ``ACK:<hex>`` / ``DUP:<hex>``
    / ``SHED:window`` / ``SHED:pool`` / ``SHED:oversize``; anything else
    is ``unclassified`` (a leak the verdict refuses).  All three shed
    kinds are counted uniformly, each in its own bucket (never one
    bucket for every non-ACK).
    """
    if reply.startswith(b"ACK:"):
        return "acked"
    if reply.startswith(b"DUP:"):
        return "duplicate"
    if reply == b"SHED:window":
        return "shed_window"
    if reply == b"SHED:pool":
        return "shed_pool"
    if reply == b"SHED:oversize":
        return "shed_oversize"
    return "unclassified"


@dataclasses.dataclass
class TrafficPlan:
    """One seeded traffic shape: who submits, how fast, how bursty."""

    seed: int = 0
    duration_s: float = 4.0
    n_clients: int = 3
    rate: float = 150.0             # aggregate target submissions/s
    tx_bytes: int = 64
    pareto_alpha: float = 1.5       # tail index; <=1 rejected (inf mean)
    burst_every_s: float = 1.5      # 0 disables burst trains
    burst_len: int = 20
    reconnect_every_s: float = 2.0  # 0 disables reconnect storms
    max_latency_samples: int = 4096

    def __post_init__(self):
        if self.pareto_alpha <= 1.0:
            raise ValueError(
                f"pareto_alpha must be > 1 for a finite mean gap, "
                f"got {self.pareto_alpha}"
            )
        if self.n_clients < 1:
            raise ValueError("n_clients must be >= 1")


class _Client:
    """One client thread's connection cache + seeded schedule."""

    def __init__(self, gen: "TrafficGenerator", ci: int):
        self.gen = gen
        self.ci = ci
        self.rng = np.random.default_rng(
            np.random.SeedSequence(gen.plan.seed, spawn_key=(ci + 1,))
        )
        self._conns: Dict[int, socket.socket] = {}

    def _drop(self, i: int) -> None:
        sock = self._conns.pop(i, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _conn(self, i: int) -> socket.socket:
        sock = self._conns.get(i)
        if sock is None:
            sock = socket.create_connection(
                (self.gen.host, self.gen.ports[i]),
                timeout=self.gen.timeout_s,
            )
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(self.gen.timeout_s)
            self._conns[i] = sock
        return sock

    def storm(self) -> None:
        """Reconnect storm: tear down every cached connection; the next
        submission per target redials cold."""
        for i in list(self._conns):
            self._drop(i)
        self.gen._bump("reconnects")

    def submit_one(self, k: int) -> None:
        """One submission to the round-robin target; one transparent
        redial on a torn cached connection."""
        gen = self.gen
        target = gen.targets[(self.ci + k) % len(gen.targets)]
        payload = (
            b"soak-%02d-%08d:" % (self.ci, k)
        ).ljust(gen.plan.tx_bytes, b"s")
        t_sent = gen.clock()
        gen._bump("submitted")
        for attempt in (0, 1):
            sock = self._conns.get(target)
            reused = sock is not None
            try:
                if sock is None:
                    sock = self._conn(target)
                frame.send_request(sock, frame.KIND_SUBMIT, b"", payload)
                _status, reply = frame.recv_reply(sock)
            except (ConnectionError, OSError):
                self._drop(target)
                if reused and attempt == 0:
                    continue
                gen._bump("failed")
                return
            break
        else:   # pragma: no cover
            gen._bump("failed")
            return
        bucket = gen.classify(reply)
        if bucket in OUTCOMES and bucket != "unclassified":
            gen._bump(bucket)
            if bucket == "acked":
                gen._latency(gen.clock() - t_sent)
        elif bucket is not None:
            gen._bump("unclassified")
        # bucket is None: the tx silently falls out of the ledger — the
        # shed-accounting leak the soak verdict's balance check exists
        # to catch (exercised by the seeded red-verdict mutation)

    def run(self) -> None:
        gen = self.gen
        plan = gen.plan
        base_gap = plan.n_clients / plan.rate if plan.rate > 0 else None
        t0 = gen.clock()
        t_end = t0 + plan.duration_s
        next_burst = (
            t0 + plan.burst_every_s if plan.burst_every_s > 0 else None
        )
        next_storm = (
            t0 + plan.reconnect_every_s
            if plan.reconnect_every_s > 0 else None
        )
        k = 0
        while gen.clock() < t_end and not gen._stopping.is_set():
            now = gen.clock()
            if next_storm is not None and now >= next_storm:
                next_storm += plan.reconnect_every_s
                self.storm()
            if next_burst is not None and now >= next_burst:
                next_burst += plan.burst_every_s
                for _ in range(plan.burst_len):
                    self.submit_one(k)
                    k += 1
                continue   # no pacing inside a burst train
            self.submit_one(k)
            k += 1
            if base_gap is None:
                break   # rate 0: bursts/storms only
            # heavy-tailed gap with mean base_gap: pareto(a) has mean
            # 1/(a-1), so scale by (a-1)
            gap = (
                base_gap * (plan.pareto_alpha - 1.0)
                * float(self.rng.pareto(plan.pareto_alpha))
            )
            gen.sleep(min(gap, plan.duration_s))
        for i in list(self._conns):
            self._drop(i)


class TrafficGenerator:
    """Drive a :class:`TrafficPlan` against live node submit ports.

    Args:
      plan: the seeded traffic shape.
      host / ports: node submit listeners (index-aligned with the
        cluster spec).
      targets: node indices to submit to — the soak passes only honest,
        currently-live indices.
      classify: reply -> ledger bucket (injectable for the red-verdict
        mutation); ``None`` return = the tx leaks from the ledger.
      clock / sleep: time seams, default :func:`frame.now` /
        :func:`frame.sleep`.

    :meth:`start` launches one thread per client; :meth:`join` waits for
    the horizon; :meth:`report` returns the ledger + rates at any point
    (thread-safe snapshot).
    """

    def __init__(
        self,
        plan: TrafficPlan,
        host: str,
        ports: Sequence[int],
        targets: Sequence[int],
        classify: Callable[[bytes], Optional[str]] = classify_reply,
        clock: Callable[[], float] = frame.now,
        sleep: Callable[[float], None] = frame.sleep,
        timeout_s: float = 5.0,
    ):
        if not targets:
            raise ValueError("traffic needs at least one target node")
        self.plan = plan
        self.host = host
        self.ports = list(ports)
        self.targets = list(targets)
        self.classify = classify
        self.clock = clock
        self.sleep = sleep
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._ledger: Dict[str, int] = {
            "submitted": 0, "reconnects": 0,
            **{k: 0 for k in OUTCOMES},
        }
        self._ack_latencies: List[float] = []
        self._stopping = threading.Event()
        self._threads: List[threading.Thread] = []
        self._t0: Optional[float] = None
        self._t1: Optional[float] = None

    # ------------------------------------------------------------- ledger

    def _bump(self, key: str, delta: int = 1) -> None:
        with self._lock:
            self._ledger[key] = self._ledger.get(key, 0) + delta

    def _latency(self, dt: float) -> None:
        with self._lock:
            if len(self._ack_latencies) < self.plan.max_latency_samples:
                self._ack_latencies.append(dt)

    def retarget(self, targets: Sequence[int]) -> None:
        """Swap the live target set (e.g. exclude a crashed node)."""
        if targets:
            self.targets = list(targets)

    # ------------------------------------------------------------ driving

    def start(self) -> None:
        self._t0 = self.clock()
        for ci in range(self.plan.n_clients):
            t = threading.Thread(
                target=_Client(self, ci).run,
                name=f"traffic-client-{ci}", daemon=True,
            )
            self._threads.append(t)
            t.start()

    def join(self, timeout_s: Optional[float] = None) -> None:
        deadline = (
            self.clock() + timeout_s if timeout_s is not None else None
        )
        for t in self._threads:
            left = (
                None if deadline is None
                else max(0.0, deadline - self.clock())
            )
            t.join(left)
        self._stopping.set()
        self._t1 = self.clock()

    def stop(self) -> None:
        self._stopping.set()

    # ------------------------------------------------------------- report

    def report(self) -> Dict:
        """Ledger snapshot + derived rates.

        ``balance_ok`` is the leak detector: the outcome buckets must
        sum back to ``submitted``.  ``leaked`` is how many transactions
        fell out of the ledger (always 0 unless the classifier is
        broken — exactly what the soak mutation arranges).
        """
        with self._lock:
            ledger = dict(self._ledger)
            lat = sorted(self._ack_latencies)
        t1 = self._t1 if self._t1 is not None else self.clock()
        elapsed = max(1e-9, (t1 - self._t0) if self._t0 else 0.0)
        accounted = sum(ledger[k] for k in OUTCOMES)
        shed = (
            ledger["shed_window"] + ledger["shed_pool"]
            + ledger["shed_oversize"]
        )

        def pct(p: float) -> float:
            if not lat:
                return 0.0
            return lat[min(len(lat) - 1, int(p * len(lat)))]

        return {
            **ledger,
            "shed": shed,
            "accounted": accounted,
            "leaked": ledger["submitted"] - accounted,
            "balance_ok": (
                ledger["submitted"] == accounted
                and ledger["unclassified"] == 0
            ),
            "elapsed_s": elapsed,
            "tx_per_s": ledger["acked"] / elapsed,
            "shed_rate": shed / max(1, ledger["submitted"]),
            "submit_p50_s": pct(0.50),
            "submit_p99_s": pct(0.99),
            "latency_samples": len(lat),
        }
