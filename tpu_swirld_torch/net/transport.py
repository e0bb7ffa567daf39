"""The :class:`~tpu_swirld_torch.transport.Transport` seam over real TCP.

:class:`SocketTransport` speaks the length-prefixed frame protocol of
:mod:`tpu_swirld_torch.net.frame` to per-peer addresses, mapping socket
reality back onto the exact error planes the node's gossip loop already
handles — so :meth:`Node._transport_call`'s retry/backoff, the
:class:`~tpu_swirld_torch.transport.CircuitBreaker`, and the counted-rejection
path all work unchanged over a real network:

- connect failure / reset / EOF / bad frame → :class:`PeerUnreachable`
  (retryable; the cached connection is dropped and the first retry
  reconnects);
- reply deadline exceeded → :class:`DeliveryTimeout` (retryable — the
  reply may arrive stale; the connection is dropped so a late reply can
  never be mis-paired with the next request);
- ``STATUS_REJECT`` reply → ``ValueError`` (the endpoints' documented
  rejection signal: counted as a bad reply, breaker misbehavior strike,
  never retried);
- ``STATUS_ERROR`` reply → :class:`PeerUnreachable` (the server failed
  internally; retryable).

Reply *bytes* are untrusted either way: the caller's hardened
``_decode_signed_blob`` path verifies signatures and bounds exactly as
it does against the in-process fault injector, which is what the
parity suite (same schedule, both transports, bit-identical decided
prefixes) certifies.

Connections are cached per destination and re-dialed lazily.  One
request/reply exchange is in flight per connection — the node's gossip
loop is single-threaded, so no framing interleave is possible.  Real
deadlines come from the ``SWIRLD_NET_*`` knobs
(:func:`~tpu_swirld_torch.config.resolve_net_settings`).

Peer restarts are a two-step race: the dead cached connection triggers
one transparent redial (counted in ``stats["redials"]``), and when that
redial's *connect* also fails — the restarting peer's new listener is
not bound yet — one bounded re-probe (``redial_probe_s``, counted in
``stats["redial_probes"]``) runs before the call surfaces as
:class:`PeerUnreachable`.  The cluster verdict mirrors the totals as
``net_redials`` so a soak run can assert reconnect behavior.
"""

from __future__ import annotations

import collections
import socket
from typing import Dict, Optional, Tuple

from tpu_swirld_torch import obs
from tpu_swirld_torch.config import resolve_net_settings
from tpu_swirld_torch.net import frame
from tpu_swirld_torch.transport import (
    CHANNEL_SYNC, DeliveryTimeout, PeerUnreachable, Transport,
)

_CHANNEL_KIND = {
    CHANNEL_SYNC: frame.KIND_SYNC,
}


class SocketTransport(Transport):
    """Per-peer TCP delivery for one node process.

    Args:
      addrs: pk -> ``(host, port)`` for every reachable peer (grow via
        :meth:`register`).
      settings: a :func:`~tpu_swirld_torch.config.resolve_net_settings` dict;
        ``None`` resolves from the environment.
      src: this node's pk, stamped into request frames (the server uses
        it for the gossip endpoints' ``src`` argument).
    """

    def __init__(
        self,
        addrs: Optional[Dict[bytes, Tuple[str, int]]] = None,
        settings: Optional[Dict] = None,
        src: bytes = b"",
    ):
        super().__init__({}, {})
        self.addrs: Dict[bytes, Tuple[str, int]] = dict(addrs or {})
        self.settings = dict(settings) if settings else resolve_net_settings()
        self.src = src
        self._conns: Dict[bytes, socket.socket] = {}
        self.stats: Dict[str, int] = collections.defaultdict(int)
        #: zero-arg callable -> 16-byte trace context (or None/b"") used
        #: to stamp outgoing frames.  Defaults to the ambient obs
        #: tracer's innermost traced span; node_proc overrides it with a
        #: lock-safe snapshot because its server threads share the
        #: tracer with the gossip loop.
        self.trace_provider = None

    def _trace_ctx(self) -> bytes:
        if self.trace_provider is not None:
            return self.trace_provider() or b""
        o = obs.current()
        if o is not None:
            ctx = o.tracer.active_context()
            if ctx:
                return ctx
        return b""

    # ------------------------------------------------------------ plumbing

    def register(self, pk: bytes, host: str, port: int) -> None:
        self.addrs[pk] = (host, port)

    def _count(self, name: str, delta: int = 1) -> None:
        self.stats[name] += delta
        o = obs.current()
        if o is not None:
            o.registry.counter(f"transport_{name}_total").inc(delta)

    def endpoint(self, dst: bytes, channel: str):
        """A peer's address doubles as its endpoint handle: the node's
        want-availability probe (``transport.endpoint(peer, WANT) is not
        None``) answers "reachable" for any registered peer — the socket
        server serves both channels on one port."""
        return self.addrs.get(dst)

    def close(self) -> None:
        for sock in self._conns.values():
            try:
                sock.close()
            except OSError:
                pass
        self._conns.clear()

    def _drop(self, dst: bytes) -> None:
        sock = self._conns.pop(dst, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _connect(self, dst: bytes, addr: Tuple[str, int]) -> socket.socket:
        try:
            sock = socket.create_connection(
                addr, timeout=self.settings["connect_timeout_s"],
            )
        except OSError as e:
            self._count("connect_failures")
            raise PeerUnreachable(
                f"connect to {addr[0]}:{addr[1]} failed: "
                f"{type(e).__name__}"
            ) from e
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(self.settings["call_timeout_s"])
        self._conns[dst] = sock
        return sock

    # ---------------------------------------------------------------- call

    def call(
        self, src: bytes, dst: bytes, channel: str, payload: bytes,
    ) -> bytes:
        if self.on_call is not None:
            self.on_call(src, dst, channel)
        addr = self.addrs.get(dst)
        if addr is None:
            raise PeerUnreachable(f"no address for peer on {channel}")
        kind = _CHANNEL_KIND.get(channel, frame.KIND_WANT)
        max_frame = self.settings["max_frame_bytes"]
        trace = self._trace_ctx()
        # one transparent redial: a cached connection may have died
        # (server restart, idle reset) — that is not a peer failure yet
        for attempt in (0, 1):
            sock = self._conns.get(dst)
            reused = sock is not None
            if sock is None:
                try:
                    sock = self._connect(dst, addr)
                except PeerUnreachable:
                    if attempt == 0:
                        raise   # cold connect failed: peer genuinely away
                    # redial window: the peer that just closed our cached
                    # connection is likely mid-restart (its old listener
                    # is down, the new one not yet bound).  One bounded
                    # re-probe turns that race into a deterministic
                    # reconnect instead of a spurious PeerUnreachable.
                    self._count("redial_probes")
                    frame.sleep(self.settings["redial_probe_s"])
                    sock = self._connect(dst, addr)
            try:
                frame.send_request(
                    sock, kind, src or self.src, payload, trace=trace,
                )
                status, reply = frame.recv_reply(sock, max_frame)
            except socket.timeout as e:
                # drop the connection: a stale reply surfacing on the
                # next request would be mis-paired
                self._drop(dst)
                self._count("timeouts")
                raise DeliveryTimeout(
                    f"no reply within "
                    f"{self.settings['call_timeout_s']}s"
                ) from e
            except (ConnectionError, OSError) as e:
                self._drop(dst)
                if reused and attempt == 0:
                    self._count("redials")
                    continue   # stale cached conn: redial once
                self._count("conn_errors")
                raise PeerUnreachable(
                    f"connection to peer failed: {type(e).__name__}"
                ) from e
            self._count("calls")
            self._count("bytes_out", len(payload))
            self._count("bytes_in", len(reply))
            if status == frame.STATUS_OK:
                return reply
            if status == frame.STATUS_REJECT:
                # the endpoints' documented rejection signal crosses the
                # wire as a status byte and resurfaces as the same
                # ValueError the in-process path raises
                self._count("rejects")
                raise ValueError(
                    reply[:256].decode("utf-8", "replace")
                    or "peer rejected request"
                )
            self._count("peer_errors")
            raise PeerUnreachable(
                f"peer reported server error: "
                f"{reply[:256].decode('utf-8', 'replace')}"
            )
        raise PeerUnreachable("unreachable")   # pragma: no cover
