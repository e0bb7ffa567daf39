"""Length-prefixed TCP framing + the net layer's wall-clock seam.

Wire format (all integers little-endian):

- request:  ``<I nbytes> <B kind> <H len(src_pk)> src_pk [trace] payload``
- reply:    ``<I nbytes> <B status> payload``

``nbytes`` counts everything after the length prefix, so one
``recv_exact(4)`` + ``recv_exact(nbytes)`` pair reads a whole frame.

Trace context (version-gated): when the high bit of the kind byte
(:data:`TRACE_FLAG`) is set, a fixed 16-byte trace context (8-byte trace
id + u64 parent span id, see :mod:`tpu_swirld_torch.obs.tracer`) sits between
``src_pk`` and the payload.  Untraced frames are byte-identical to the
pre-trace wire format, so an old sender interoperates with a new
receiver unchanged; a traced frame hitting an *old* receiver decodes to
an unknown kind (e.g. ``0x81``) and is rejected by the dispatch layer's
documented unknown-kind path — a clean REJECT, never a misparse.
Both directions are bounds-checked against a max-frame knob before any
allocation, so a garbage length prefix from a byzantine peer cannot make
the receiver allocate gigabytes (:class:`FrameError` — an ``OSError``
subclass, i.e. a connection-level failure, never a traceback).

Request *kinds* cover the gossip seam (sync / want — the two
:mod:`tpu_swirld_torch.transport` channels) plus the cluster control plane
(client tx submission, status probes, graceful stop).  Reply *status*
separates the three error planes the in-process :class:`~tpu_swirld_torch.
transport.Transport` already distinguishes: ``STATUS_OK`` carries the
endpoint's reply bytes, ``STATUS_REJECT`` is the endpoint's documented
``ValueError`` rejection (counted as a bad reply by the caller, never
retried), and ``STATUS_ERROR`` is a server-side failure (mapped to
:class:`~tpu_swirld_torch.transport.PeerUnreachable`, retryable).

Wall time: this module also owns the net layer's ONLY direct wall-clock
reads (:func:`now` / :func:`sleep`).  Everything else under ``net/``
calls these, so the SW003 justified-suppression surface stays two lines
wide and the justification is stated where the clock is read.
"""

from __future__ import annotations

import socket
import struct
import time
from typing import List, Tuple

#: request kinds
KIND_SYNC = 1       # gossip sync channel (Transport CHANNEL_SYNC)
KIND_WANT = 2       # gossip want channel (Transport CHANNEL_WANT)
KIND_SUBMIT = 3     # client transaction submission (payload = raw tx)
KIND_STATUS = 4     # JSON status probe (supervisor liveness/watermarks)
KIND_STOP = 5       # graceful shutdown request
KIND_PING = 6       # readiness probe
KIND_METRICS = 7    # registry snapshot poll (supervisor metrics plane)
KIND_MTX = 8        # membership transaction (payload = MTX1 blob; the
                    # node rides it on its next gossip event — dynamic-
                    # membership clusters only)

#: kind-byte high bit: a 16-byte trace context follows src_pk
TRACE_FLAG = 0x80
KIND_MASK = 0x7F

#: wire size of the optional trace context (mirrors obs.tracer)
TRACE_CTX_LEN = 16

#: reply status
STATUS_OK = 0       # payload = endpoint reply bytes
STATUS_REJECT = 1   # endpoint ValueError: counted bad reply, not retried
STATUS_ERROR = 2    # server-side failure: retryable (PeerUnreachable)

#: default ceiling on one frame's body; must admit a max sync reply
#: (config.max_reply_bytes = 16 MiB) plus framing overhead
MAX_FRAME_BYTES = (1 << 24) + (1 << 16)

_REQ_HEAD = struct.Struct("<BH")
_LEN = struct.Struct("<I")


class FrameError(OSError):
    """A malformed or oversized frame: connection-level garbage, torn
    down like any other socket failure (the peer may be byzantine)."""


def now() -> float:
    """Monotonic wall seconds — the net layer's single clock read."""
    return time.monotonic()   # swirld-lint: disable=SW003 -- real socket deadlines and tx latency need wall time; net/ is the deployment edge, outside the logical-time consensus core


def sleep(seconds: float) -> None:
    """Real sleep for gossip pacing and scaled retry backoff."""
    if seconds > 0:
        time.sleep(seconds)   # swirld-lint: disable=SW003 -- real gossip pacing/backoff must block wall time; net/ is the deployment edge, outside the logical-time consensus core


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise ``ConnectionError`` on EOF."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 16))
        if not chunk:
            raise ConnectionError(f"peer closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_request(
    sock: socket.socket, kind: int, src: bytes, payload: bytes,
    trace: bytes = b"",
) -> None:
    """Send one request frame; a non-empty ``trace`` (exactly
    :data:`TRACE_CTX_LEN` bytes) sets :data:`TRACE_FLAG` on the kind
    byte and rides between ``src`` and ``payload``."""
    if trace:
        if len(trace) != TRACE_CTX_LEN:
            raise ValueError(
                f"trace context must be {TRACE_CTX_LEN} bytes, "
                f"got {len(trace)}"
            )
        body = (_REQ_HEAD.pack(kind | TRACE_FLAG, len(src))
                + src + trace + payload)
    else:
        body = _REQ_HEAD.pack(kind, len(src)) + src + payload
    sock.sendall(_LEN.pack(len(body)) + body)


def recv_request(
    sock: socket.socket, max_frame: int = MAX_FRAME_BYTES,
) -> Tuple[int, bytes, bytes, bytes]:
    """Returns ``(kind, src_pk, payload, trace)`` where ``trace`` is the
    16-byte context for flagged frames, else ``b""``; raises on EOF /
    bad frame."""
    (nbytes,) = _LEN.unpack(recv_exact(sock, 4))
    if nbytes < _REQ_HEAD.size or nbytes > max_frame:
        raise FrameError(f"bad request frame length {nbytes}")
    body = recv_exact(sock, nbytes)
    kind_raw, src_len = _REQ_HEAD.unpack_from(body)
    kind = kind_raw & KIND_MASK
    off = _REQ_HEAD.size + src_len
    if off > len(body):
        raise FrameError(f"request src overruns frame ({src_len} bytes)")
    src = body[_REQ_HEAD.size:off]
    trace = b""
    if kind_raw & TRACE_FLAG:
        if off + TRACE_CTX_LEN > len(body):
            raise FrameError("traced request missing its 16-byte context")
        trace = body[off:off + TRACE_CTX_LEN]
        off += TRACE_CTX_LEN
    payload = body[off:]
    return kind, src, payload, trace


def send_reply(sock: socket.socket, status: int, payload: bytes) -> None:
    body = struct.pack("<B", status) + payload
    sock.sendall(_LEN.pack(len(body)) + body)


def recv_reply(
    sock: socket.socket, max_frame: int = MAX_FRAME_BYTES,
) -> Tuple[int, bytes]:
    """Returns ``(status, payload)``; raises on EOF / bad frame."""
    (nbytes,) = _LEN.unpack(recv_exact(sock, 4))
    if nbytes < 1 or nbytes > max_frame:
        raise FrameError(f"bad reply frame length {nbytes}")
    body = recv_exact(sock, nbytes)
    return body[0], body[1:]


def allocate_ports(n: int, host: str = "127.0.0.1") -> List[int]:
    """``n`` distinct ephemeral ports: bind port 0, read the kernel's
    pick back, release.  All sockets stay open until every port is
    chosen so the kernel cannot hand the same port out twice; parallel
    CI runs each get their own ports and never collide on a hardcoded
    base.  (The usual bind-0 race — another process grabbing the port
    between release and re-bind — is closed by SO_REUSEADDR plus the
    supervisor re-binding immediately.)"""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((host, 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class PortReservation:
    """Ports held for a run: :func:`reserve_ports`.  ``ports`` lists them;
    :meth:`close` releases them."""

    def __init__(self, socks: List[socket.socket]):
        self._socks = socks
        self.ports: List[int] = [s.getsockname()[1] for s in socks]

    def close(self) -> None:
        for s in self._socks:
            s.close()
        self._socks = []


def reserve_ports(n: int, host: str = "127.0.0.1") -> PortReservation:
    """``n`` distinct ports held until :meth:`PortReservation.close`: each is
    bound (never listening) by a socket that stays open, with
    ``SO_REUSEPORT`` set, so a node process binds it again with the same
    option (:func:`listen_socket`) as often as it restarts, while no other
    process takes it meanwhile: a bind of port 0 and an outgoing
    connection both pass over a bound port.  (:func:`allocate_ports`
    releases its ports at once, and any process may take one before the
    node binds it.)  A connection to a port whose node is down is refused,
    as the reservation does not listen."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            s.bind((host, 0))
            socks.append(s)
    except BaseException:
        for s in socks:
            s.close()
        raise
    return PortReservation(socks)


def listen_socket(host: str, port: int, backlog: int) -> socket.socket:
    """A listening TCP socket on ``(host, port)``; ``SO_REUSEPORT`` lets it
    bind a port that :func:`reserve_ports` holds."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    sock.bind((host, port))
    sock.listen(backlog)
    return sock
