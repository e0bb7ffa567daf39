"""Gossip transport: the delivery seam between the simulation and the
``Node``, its seeded fault injection, bounded retry and a per-peer circuit
breaker (copy of the reference's ``tpu_swirld/transport.py``).

- :class:`Transport`: the delivery interface and its reliable in-process
  implementation, ``call(src, dst, channel, payload) -> reply``, over the
  simulation's ``network`` / ``network_want`` endpoint dicts.
- :class:`FaultPlan` / :class:`LinkFaults` / :class:`Partition`: a seeded,
  declarative fault schedule: per-link drop / corrupt / duplicate / reorder /
  delay probabilities, partitions that cut the links crossing a group's
  boundary over a window of logical time, and crash windows that the chaos
  driver (:mod:`tpu_swirld_torch.chaos`) interprets.
- :class:`FaultyTransport`: applies a :class:`FaultPlan` around the reliable
  call.  Requests and replies are dropped (a :class:`TransportError`: the
  caller's retry path), corrupted (truncation, a bit flip or emptying: the
  caller's counted rejection), duplicated or held back and delivered stale
  later (idempotent ingest); partitions and crashed peers cut links.
- :class:`RetryPolicy`: bounded retry with exponential backoff, jitter and a
  per-peer deadline, in logical ticks (nothing sleeps).
- :class:`CircuitBreaker`: per-peer failure and misbehavior strikes with
  open, cooldown, half-open probe and close transitions.

Every fault is drawn from a per-directed-link numpy ``Generator`` seeded
``SeedSequence(plan.seed, spawn_key=(src + 1, dst + 1))``, the reference's
construction, so a link's fault history is a function of ``(plan.seed, src,
dst, call number)`` alone and the port draws the reference's faults call for
call.
"""

from __future__ import annotations

import collections
import dataclasses
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpu_swirld_torch import obs

CHANNEL_SYNC = "sync"
CHANNEL_WANT = "want"


class TransportError(Exception):
    """Base of every delivery failure (the retryable class of errors)."""


class PeerUnreachable(TransportError):
    """No route to the peer: unregistered, crashed, or it rejected us."""


class PeerPartitioned(TransportError):
    """The link is cut by a scheduled partition window."""


class MessageDropped(TransportError):
    """The request or reply was lost in flight."""


class DeliveryTimeout(TransportError):
    """The reply was delayed past the caller's patience (it may still be
    delivered stale on a later call over the same link)."""


class Transport:
    """Reliable delivery over the sim's endpoint dicts (the legacy path).

    ``network`` maps pk -> ``ask_sync`` endpoint, ``network_want`` maps
    pk -> ``ask_events`` endpoint; both dicts are shared with the sim and
    may gain endpoints after construction (registration order is
    unchanged from the pre-transport code).
    """

    def __init__(
        self,
        network: Dict[bytes, Callable],
        network_want: Optional[Dict[bytes, Callable]] = None,
    ):
        self.network = network
        self.network_want = network_want if network_want is not None else {}
        # Deterministic step hook: invoked as ``on_call(src, dst, channel)``
        # for every delivery attempt that reaches an endpoint lookup.  The
        # model checker (analysis.mc) installs a recorder here so a
        # counterexample replay can prove, byte-for-byte, that the same
        # schedule produces the same wire activity.  Must be a pure
        # observer — raising or mutating node state here is undefined.
        self.on_call: Optional[Callable[[bytes, bytes, str], None]] = None

    def endpoint(self, dst: bytes, channel: str) -> Optional[Callable]:
        table = self.network if channel == CHANNEL_SYNC else self.network_want
        return table.get(dst)

    def call(self, src: bytes, dst: bytes, channel: str, payload: bytes) -> bytes:
        if self.on_call is not None:
            self.on_call(src, dst, channel)
        fn = self.endpoint(dst, channel)
        if fn is None:
            raise PeerUnreachable(f"no {channel} endpoint for peer")
        try:
            return fn(src, payload)
        except (TransportError, ValueError):
            # ValueError is the endpoints' documented rejection signal
            # (counted as a bad reply by the caller); transport errors
            # pass through untouched
            raise
        except Exception as e:
            # anything else a (byzantine or buggy) endpoint throws is a
            # failed RPC, never a traceback in the caller's gossip loop
            raise PeerUnreachable(
                f"peer endpoint error: {type(e).__name__}"
            ) from e

    def close(self) -> None:
        """Release delivery resources.  A no-op in process; a socket
        transport overrides it to drop its per-peer connections, so
        callers tear any transport down uniformly."""


# --------------------------------------------------------------- fault plan


@dataclasses.dataclass
class LinkFaults:
    """Per-link fault probabilities (each sampled independently per call).

    ``drop`` is sampled twice — once for the request, once for the reply —
    so the end-to-end loss rate of a link with ``drop=p`` is ``1-(1-p)^2``.
    ``corrupt`` mangles bytes (truncation, bit flips, or emptying) without
    losing the call; ``duplicate`` re-delivers a copy of the reply stale on
    a later call; ``reorder`` swaps the fresh reply with a previously
    stashed one; ``delay`` holds the fresh reply back entirely (the caller
    times out; the reply arrives stale later).

    The last three knobs only have meaning on a real wire and are applied
    by the socket interposer (:mod:`tpu_swirld_torch.net.proxy`), never by
    the in-process :class:`FaultyTransport`: ``reset`` is the
    probability of a hard connection teardown after the server already
    processed the request (the redial-after-success hazard), ``delay_s`` is
    the hold applied when a ``delay`` fault fires on a stream (an
    in-process delay is a stashed stale reply instead), and
    ``throttle_bps`` > 0 paces relayed bytes to that budget.  All default
    off, so every in-process plan is byte-identical.
    """

    drop: float = 0.0
    corrupt: float = 0.0
    duplicate: float = 0.0
    reorder: float = 0.0
    delay: float = 0.0
    reset: float = 0.0
    delay_s: float = 0.0
    throttle_bps: float = 0.0


@dataclasses.dataclass(frozen=True)
class Partition:
    """Cut every link crossing ``group``'s boundary while
    ``start <= clock < end``.  ``group`` holds member *indices* (resolved
    against the transport's member list, so plans can be written before
    keys exist)."""

    start: int
    end: int
    group: Tuple[int, ...]


@dataclasses.dataclass
class FaultPlan:
    """A seeded, declarative fault schedule for one chaos scenario.

    ``default`` applies to every link; ``links`` overrides per
    ``(src_index, dst_index)`` directed pair.  ``crashes`` maps a member
    index to ``[(down_turn, up_turn), ...]`` windows — interpreted by the
    chaos driver (which owns checkpoint/restore), while the transport
    exposes the resulting downtime via :attr:`FaultyTransport.down`.
    """

    seed: int = 0
    default: LinkFaults = dataclasses.field(default_factory=LinkFaults)
    links: Dict[Tuple[int, int], LinkFaults] = dataclasses.field(
        default_factory=dict
    )
    partitions: List[Partition] = dataclasses.field(default_factory=list)
    crashes: Dict[int, List[Tuple[int, int]]] = dataclasses.field(
        default_factory=dict
    )

    def faults_for(self, src_i: int, dst_i: int) -> LinkFaults:
        return self.links.get((src_i, dst_i), self.default)

    def partitioned(self, src_i: int, dst_i: int, t: int) -> bool:
        for p in self.partitions:
            if p.start <= t < p.end:
                if (src_i in p.group) != (dst_i in p.group):
                    return True
        return False

    def heal_time(self) -> int:
        """The first tick with no scheduled partition or crash window."""
        ends = [p.end for p in self.partitions]
        ends += [up for ws in self.crashes.values() for _, up in ws]
        return max(ends, default=0)


class FaultyTransport(Transport):
    """A :class:`Transport` that applies a :class:`FaultPlan`.

    ``clock`` supplies logical time (the sim's turn counter) for
    partition windows; ``members`` resolves pk -> index for the plan's
    index-keyed knobs.  Each directed link draws from its own RNG stream,
    keyed ``SeedSequence(plan.seed, spawn_key=(src_i+1, dst_i+1))`` — the
    hash-stable spawn construction, so a link's fault sequence never
    depends on which other links happened to carry traffic first (the old
    single shared ``Random(plan.seed)`` made every link's draws a
    function of global call interleaving).

    Fault counters accumulate in :attr:`stats` and, when an ambient
    :func:`tpu_swirld_torch.obs.current` registry is enabled, as
    ``transport_<name>_total`` counters (rendered by the report CLI's
    resilience section).
    """

    def __init__(
        self,
        network: Dict[bytes, Callable],
        network_want: Optional[Dict[bytes, Callable]],
        plan: FaultPlan,
        members: Sequence[bytes],
        clock: Callable[[], int],
    ):
        super().__init__(network, network_want)
        self.plan = plan
        self.clock = clock
        self.member_index = {m: i for i, m in enumerate(members)}
        self.down: set = set()          # crashed pks (driver-maintained)
        self._link_rngs: Dict[Tuple[int, int], np.random.Generator] = {}
        self._pending: Dict[Tuple[bytes, bytes, str], collections.deque] = {}
        self.stats: Dict[str, int] = collections.defaultdict(int)

    # ------------------------------------------------------------- helpers

    def _link_rng(self, src_i: int, dst_i: int) -> np.random.Generator:
        """The directed link's private fault stream.  Spawn keys are
        offset by 1 so unknown members (index -1) get a valid stream."""
        key = (src_i, dst_i)
        rng = self._link_rngs.get(key)
        if rng is None:
            rng = np.random.default_rng(
                np.random.SeedSequence(
                    self.plan.seed, spawn_key=(src_i + 1, dst_i + 1)
                )
            )
            self._link_rngs[key] = rng
        return rng

    def _count(self, name: str, delta: int = 1) -> None:
        self.stats[name] += delta
        o = obs.current()
        if o is not None:
            o.registry.counter(f"transport_{name}_total").inc(delta)

    @staticmethod
    def _corrupt(data: bytes, r: np.random.Generator) -> bytes:
        """Truncate, bit-flip, or empty the message — never crash."""
        mode = int(r.integers(3))
        if not data or mode == 0:
            return data[: int(r.integers(len(data) + 1))]  # truncation
        if mode == 1:
            i = int(r.integers(len(data)))
            return data[:i] + bytes([data[i] ^ (1 << int(r.integers(8)))]) + data[i + 1:]
        return b""                                         # total garbage

    def set_down(self, pk: bytes) -> None:
        self.down.add(pk)

    def set_up(self, pk: bytes) -> None:
        self.down.discard(pk)

    # ---------------------------------------------------------------- call

    def call(self, src: bytes, dst: bytes, channel: str, payload: bytes) -> bytes:
        t = int(self.clock())
        if src in self.down or dst in self.down:
            self._count("crash_blocked")
            raise PeerUnreachable("peer is down")
        si = self.member_index.get(src, -1)
        di = self.member_index.get(dst, -1)
        if self.plan.partitioned(si, di, t):
            self._count("partition_blocked")
            raise PeerPartitioned(f"link cut at t={t}")
        lf = self.plan.faults_for(si, di)
        r = self._link_rng(si, di)
        if r.random() < lf.drop:
            self._count("drops")
            raise MessageDropped("request lost")
        req = payload
        if r.random() < lf.corrupt:
            self._count("corruptions")
            req = self._corrupt(req, r)
        try:
            reply = super().call(src, dst, channel, req)
        except TransportError:
            raise
        except Exception:
            # the peer rejected the (possibly mangled) request; a real
            # network shows the caller a failed RPC, not a traceback
            self._count("peer_errors")
            raise PeerUnreachable("peer rejected the request")
        if r.random() < lf.drop:
            self._count("drops")
            raise MessageDropped("reply lost")
        if r.random() < lf.corrupt:
            self._count("corruptions")
            reply = self._corrupt(reply, r)
        key = (src, dst, channel)
        queue = self._pending.setdefault(key, collections.deque(maxlen=8))
        if r.random() < lf.duplicate:
            self._count("duplicates")
            queue.append(reply)
        if r.random() < lf.delay:
            self._count("delays")
            queue.append(reply)
            raise DeliveryTimeout("reply delayed past deadline")
        # stashed stale replies (duplicates / delayed deliveries) surface
        # on later calls at a rate matching whichever fault stashed them —
        # so duplicate/delay are not inert when reorder is 0; the fresh
        # reply is stashed in exchange, never lost
        drain_p = max(lf.reorder, lf.duplicate, lf.delay)
        if queue and r.random() < drain_p:
            self._count("reorders")
            queue.append(reply)
            return queue.popleft()
        return reply


# ------------------------------------------------------------ retry policy


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff + jitter and a deadline.

    All quantities are *logical* time (the sim's tick unit); nothing here
    sleeps — the caller decides what to do with each computed delay
    (record it, advance a fake clock, or actually sleep in a real
    deployment).
    """

    attempts: int = 3          # total call attempts (1 = no retry)
    backoff_base: float = 1.0  # first retry delay
    backoff_cap: float = 8.0   # per-retry delay ceiling
    jitter: float = 0.5        # uniform extra in [0, jitter * delay]
    deadline: float = 16.0     # total backoff budget per peer per pull

    def backoff(self, attempt: int, rng: random.Random) -> float:
        """Delay before retry number ``attempt`` (0-based)."""
        d = min(self.backoff_cap, self.backoff_base * (2.0 ** attempt))
        if self.jitter > 0:
            d += d * self.jitter * rng.random()
        return d


# ---------------------------------------------------------- circuit breaker

_CLOSED, _OPEN, _HALF_OPEN = "closed", "open", "half-open"


class CircuitBreaker:
    """Per-peer quarantine for persistently failing or misbehaving peers.

    Two strike counters per peer: *failures* (transport errors — retried,
    possibly transient; reset on any success) and *misbehavior* (garbage
    at the decode layer: bad reply signatures, validly-signed malformed
    blobs, or detected equivocation fed in by the node's fork
    bookkeeping; decays one strike per clean reply, since in-flight
    corruption is indistinguishable from peer garbage).  Either crossing
    its threshold opens the circuit: calls to the peer fail fast until
    ``cooldown`` logical ticks pass, after which ONE probe call is
    allowed (half-open); success closes the circuit, failure re-opens it
    for another cooldown.
    """

    def __init__(
        self,
        clock: Callable[[], int],
        failure_threshold: int = 4,
        misbehavior_threshold: int = 12,
        cooldown: float = 24.0,
    ):
        self._clock = clock
        self.failure_threshold = max(1, failure_threshold)
        self.misbehavior_threshold = max(1, misbehavior_threshold)
        self.cooldown = cooldown
        self._failures: Dict[bytes, int] = {}
        self._misbehavior: Dict[bytes, int] = {}
        self._opened_at: Dict[bytes, float] = {}
        self._probing: set = set()
        self.opens = 0             # lifetime count of open transitions
        self.on_open: Optional[Callable[[bytes], None]] = None
        # ^ observer seam: called with the peer on every open transition
        # (the flight recorder hooks this to dump a post-mortem)

    def state(self, peer: bytes) -> str:
        t0 = self._opened_at.get(peer)
        if t0 is None:
            return _CLOSED
        if self._clock() - t0 >= self.cooldown:
            return _HALF_OPEN
        return _OPEN

    def allow(self, peer: bytes) -> bool:
        """May we call this peer now?  (Half-open admits one probe.)"""
        s = self.state(peer)
        if s == _CLOSED:
            return True
        if s == _HALF_OPEN:
            self._probing.add(peer)
            return True
        return False

    def _open(self, peer: bytes) -> None:
        self._opened_at[peer] = self._clock()
        self._failures[peer] = 0
        self._misbehavior[peer] = 0
        self._probing.discard(peer)
        self.opens += 1
        if self.on_open is not None:
            self.on_open(peer)

    def record_failure(self, peer: bytes) -> None:
        if peer in self._opened_at:
            if peer in self._probing:       # failed half-open probe
                self._open(peer)
            return
        n = self._failures.get(peer, 0) + 1
        self._failures[peer] = n
        if n >= self.failure_threshold:
            self._open(peer)

    def record_misbehavior(self, peer: bytes, weight: int = 1) -> None:
        if peer in self._opened_at:
            if peer in self._probing:
                self._open(peer)
            return
        n = self._misbehavior.get(peer, 0) + weight
        self._misbehavior[peer] = n
        if n >= self.misbehavior_threshold:
            self._open(peer)

    def record_success(self, peer: bytes) -> None:
        self._failures[peer] = 0
        # misbehavior decays one strike per clean reply: in-flight
        # corruption on a lossy link is indistinguishable from peer
        # garbage at the decode layer, and without decay those strikes
        # would slowly quarantine an honest peer.  A real byzantine peer
        # serving mostly garbage still out-runs the decay (and detected
        # equivocation strikes with the full threshold at once).
        m = self._misbehavior.get(peer, 0)
        if m > 0:
            self._misbehavior[peer] = m - 1
        if peer in self._opened_at and peer in self._probing:
            del self._opened_at[peer]       # probe succeeded: close
            self._probing.discard(peer)

    def quarantined(self) -> List[bytes]:
        """Peers whose circuit is currently open (incl. half-open)."""
        return [p for p in self._opened_at]
