"""Gossip transport: the delivery seam between the simulation and the
``Node``, with bounded retry and a per-peer circuit breaker (copy of the
reliable half of the reference's ``tpu_swirld/transport.py``).

- :class:`Transport`: the delivery interface and its reliable in-process
  implementation, ``call(src, dst, channel, payload) -> reply``, over the
  simulation's ``network`` / ``network_want`` endpoint dicts.
- :class:`RetryPolicy`: bounded retry with exponential backoff, jitter and a
  per-peer deadline, in logical ticks (nothing sleeps).
- :class:`CircuitBreaker`: per-peer failure and misbehavior strikes with
  open, cooldown, half-open probe and close transitions.

The reference's seeded fault injection (``LinkFaults``, ``Partition``,
``FaultPlan``, ``FaultyTransport``) is not ported (ROADMAP A10, chaos).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List, Optional

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
