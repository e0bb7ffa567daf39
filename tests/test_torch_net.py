"""The port's net layer (``tpu_swirld_torch.net``) on its own and against
the reference's ``tpu_swirld.net``.

The first part is the reference's ``tests/test_net.py`` run on the port:
framing, WAL durability, tx ingestion, the socket transport's error planes,
redial and re-probe, the startup post-mortem, the fault proxy, and the
socket-transport parity suite (the same schedule over the in-process
``Transport`` and a loopback ``SocketTransport`` decides bit-identical
prefixes).  Its three SW003 lint tests wait for the port's
``analysis/lint``.  The second part holds the two packages against each
other: frame bytes, WAL bytes and scans (torn tails included), ``TxPool``
replies and batches, a port transport against a reference server and the
reverse, and the port's socket nodes against the reference's in-process
nodes.  Everything runs in-process or over loopback sockets owned by the
test; the real-process cluster is in ``tests/test_torch_cluster.py``.
"""

import collections
import dataclasses
import errno
import os
import random
import socket
import struct
import threading

import pytest

from tpu_swirld import crypto as ref_crypto
from tpu_swirld.config import SwirldConfig as RefConfig
from tpu_swirld.net import frame as ref_frame
from tpu_swirld.net import ingest as ref_ingest
from tpu_swirld.net import wal as ref_wal
from tpu_swirld.net.node_proc import NodeServer as RefNodeServer
from tpu_swirld.net.transport import SocketTransport as RefSocketTransport
from tpu_swirld.oracle.event import Event as RefEvent
from tpu_swirld.oracle.event import encode_event as ref_encode_event
from tpu_swirld.oracle.node import Node as RefNode
from tpu_swirld.transport import Transport as RefTransport
from tpu_swirld_torch import crypto
from tpu_swirld_torch.config import SwirldConfig, resolve_net_settings
from tpu_swirld_torch.net import frame
from tpu_swirld_torch.net.frame import (FrameError, allocate_ports, listen_socket,
                                        reserve_ports)
from tpu_swirld_torch.net.ingest import TxPool, decode_batch, encode_batch
from tpu_swirld_torch.net.transport import SocketTransport
from tpu_swirld_torch.net.wal import MAGIC, TAG_EVENT, OwnEventWal
from tpu_swirld_torch.net.node_proc import NodeRuntime, NodeServer, startup_postmortem
from tpu_swirld_torch.obs.flightrec import FlightRecorder, load_dump
from tpu_swirld_torch.obs.tracer import pack_context
from tpu_swirld_torch.event import Event, encode_event
from tpu_swirld_torch.oracle.node import Node
from tpu_swirld_torch.net.proxy import FaultyProxy, ProxyFleet
from tpu_swirld_torch.transport import (
    CHANNEL_SYNC, DeliveryTimeout, FaultPlan, LinkFaults, Partition,
    PeerUnreachable, Transport,
)

# ------------------------------------------------------------- framing


def _pair():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    return a, b


def test_frame_request_reply_roundtrip():
    a, b = _pair()
    try:
        frame.send_request(a, frame.KIND_SYNC, b"S" * 32, b"payload-bytes")
        kind, src, payload, trace = frame.recv_request(b)
        assert (kind, src, payload, trace) == (
            frame.KIND_SYNC, b"S" * 32, b"payload-bytes", b"",
        )
        frame.send_reply(b, frame.STATUS_OK, b"reply-bytes")
        assert frame.recv_reply(a) == (frame.STATUS_OK, b"reply-bytes")
        # empty src and empty payload are legal frames
        frame.send_request(a, frame.KIND_PING, b"", b"")
        assert frame.recv_request(b) == (frame.KIND_PING, b"", b"", b"")
    finally:
        a.close()
        b.close()


def _expect_frame_error(raw, recv_fn, **kw):
    """Feed raw bytes to a receiver on a fresh pair (a FrameError can
    fire before the body is drained, so cases never share a stream)."""
    a, b = _pair()
    try:
        a.sendall(raw)
        with pytest.raises(FrameError):
            recv_fn(b, **kw)
    finally:
        a.close()
        b.close()


def test_frame_rejects_oversized_and_garbage_lengths():
    # a garbage length prefix must raise BEFORE any allocation
    _expect_frame_error(
        struct.pack("<I", frame.MAX_FRAME_BYTES + 1), frame.recv_request,
    )
    # a request frame too short to hold its own header
    _expect_frame_error(struct.pack("<I", 1) + b"\x00", frame.recv_request)
    # src length overrunning the frame body
    body = frame._REQ_HEAD.pack(frame.KIND_SYNC, 500) + b"short"
    _expect_frame_error(
        struct.pack("<I", len(body)) + body, frame.recv_request,
    )
    # zero-length reply frame cannot hold a status byte
    _expect_frame_error(struct.pack("<I", 0), frame.recv_reply)
    # per-call max_frame tightens the ceiling below the default
    a, b = _pair()
    try:
        frame.send_request(a, frame.KIND_SYNC, b"", b"x" * 100)
        with pytest.raises(FrameError):
            frame.recv_request(b, max_frame=50)
    finally:
        a.close()
        b.close()


def test_frame_eof_mid_frame_is_connection_error():
    a, b = _pair()
    a.sendall(struct.pack("<I", 10) + b"abc")   # promises 10, sends 3
    a.close()
    try:
        with pytest.raises(ConnectionError):
            frame.recv_request(b)
    finally:
        b.close()


def test_frame_trace_context_roundtrip():
    """A traced frame carries its 16-byte context between src and
    payload; the receiver masks the flag off the kind byte."""
    ctx = pack_context(b"trace-id", 0x1234)
    a, b = _pair()
    try:
        frame.send_request(a, frame.KIND_SUBMIT, b"S" * 8, b"tx", trace=ctx)
        assert frame.recv_request(b) == (frame.KIND_SUBMIT, b"S" * 8,
                                         b"tx", ctx)
        # empty src / empty payload still frame correctly with a trace
        frame.send_request(a, frame.KIND_SYNC, b"", b"", trace=ctx)
        assert frame.recv_request(b) == (frame.KIND_SYNC, b"", b"", ctx)
    finally:
        a.close()
        b.close()
    # a wrong-sized context is the sender's bug, refused before the wire
    a, b = _pair()
    try:
        with pytest.raises(ValueError):
            frame.send_request(a, frame.KIND_SYNC, b"", b"x", trace=b"short")
    finally:
        a.close()
        b.close()
    # a flagged frame too short for its context is connection garbage
    body = frame._REQ_HEAD.pack(frame.KIND_SYNC | frame.TRACE_FLAG, 0) + b"123"
    _expect_frame_error(
        struct.pack("<I", len(body)) + body, frame.recv_request,
    )


def test_frame_old_header_parses_under_new_decoder():
    """Wire compat, old sender -> new receiver: a hand-built pre-trace
    frame (no flag, no context) decodes exactly as before with an empty
    trace — untraced frames are byte-identical to the old format."""
    src, payload = b"oldpk", b"old-payload"
    body = frame._REQ_HEAD.pack(frame.KIND_SYNC, len(src)) + src + payload
    a, b = _pair()
    try:
        a.sendall(struct.pack("<I", len(body)) + body)
        assert frame.recv_request(b) == (frame.KIND_SYNC, src, payload, b"")
        # and the new sender's untraced output IS that old byte layout
        frame.send_request(a, frame.KIND_SYNC, src, payload)
    finally:
        a.close()
    try:
        raw = frame.recv_exact(b, 4 + len(body))
        assert raw == struct.pack("<I", len(body)) + body
    finally:
        b.close()


def _pre_trace_recv_request(sock, max_frame=frame.MAX_FRAME_BYTES):
    """The decoder as it shipped BEFORE the trace-context header: no
    flag masking — a flagged kind byte surfaces verbatim.  Kept as a
    test stub to pin how an old node reacts to a new traced frame."""
    (nbytes,) = struct.unpack("<I", frame.recv_exact(sock, 4))
    if nbytes < frame._REQ_HEAD.size or nbytes > max_frame:
        raise FrameError(f"bad request frame length {nbytes}")
    body = frame.recv_exact(sock, nbytes)
    kind, src_len = frame._REQ_HEAD.unpack_from(body)
    off = frame._REQ_HEAD.size + src_len
    if off > len(body):
        raise FrameError(f"request src overruns frame ({src_len} bytes)")
    return kind, body[frame._REQ_HEAD.size:off], body[off:]


def test_frame_new_header_rejected_cleanly_by_pre_trace_decoder():
    """Wire compat, new sender -> old receiver: the flagged kind byte
    decodes to an *unknown* kind (0x80 | kind), which every dispatch
    layer rejects via its documented unknown-kind ``ValueError`` path —
    a clean REJECT, never a misparse into a real request."""
    ctx = pack_context(b"trace-id", 7)
    a, b = _pair()
    try:
        frame.send_request(a, frame.KIND_SUBMIT, b"pk", b"tx-bytes",
                           trace=ctx)
        kind, src, payload = _pre_trace_recv_request(b)
        assert kind == (frame.KIND_SUBMIT | frame.TRACE_FLAG)
        known = {frame.KIND_SYNC, frame.KIND_WANT, frame.KIND_SUBMIT,
                 frame.KIND_STATUS, frame.KIND_STOP, frame.KIND_PING,
                 frame.KIND_METRICS}
        assert kind not in known   # -> the unknown-kind REJECT path
        # framing itself stays sound: src parses, the context rides
        # inside what the old decoder sees as payload, nothing misaligns
        assert src == b"pk"
        assert payload == ctx + b"tx-bytes"
        with pytest.raises(ValueError):
            raise ValueError("unknown kind %d" % kind)
    finally:
        a.close()
        b.close()


def test_wal_records_carry_no_trace_bytes(tmp_path):
    """Trace ids are transport-only: the WAL byte stream is a pure
    function of the events — appending under an active traced span
    writes byte-identical records, and torn-tail recovery of such a file
    hands back events with nothing trace-related attached."""
    from tpu_swirld_torch.obs.tracer import Tracer

    pk, sk = crypto.keypair(b"wal-trace-free")
    evs = _own_events(pk, sk, 3)
    plain, traced = str(tmp_path / "plain.wal"), str(tmp_path / "traced.wal")
    w = OwnEventWal(plain, pk=pk)
    for ev in evs:
        w.append(ev)
    w.close()
    tr = Tracer(pid=9)
    ctx = pack_context(b"\xabtrace!!", 0)
    with tr.span_under("gossip.sync", ctx):
        w2 = OwnEventWal(traced, pk=pk)
        for ev in evs:
            w2.append(ev)
        w2.close()
    with open(plain, "rb") as f:
        plain_bytes = f.read()
    with open(traced, "rb") as f:
        traced_bytes = f.read()
    assert plain_bytes == traced_bytes
    assert ctx not in traced_bytes and b"\xabtrace!!" not in traced_bytes
    # torn-tail recovery of the traced-context file: same durable prefix,
    # and recovered events expose exactly the Event surface — no trace
    with open(traced, "wb") as f:
        f.write(traced_bytes[:-3])
    t = OwnEventWal(traced, pk=pk)
    assert t.torn_tail_recovered == 1
    assert [e.id for e in t.events] == [e.id for e in evs[:-1]]
    assert not any(hasattr(e, "trace") for e in t.events)
    t.close()


def test_allocate_ports_distinct_and_bindable():
    ports = allocate_ports(8)
    assert len(set(ports)) == 8
    for p in ports:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", p))
        s.close()


def test_reserved_ports_are_held_for_their_nodes():
    """A reserved port (what a cluster supervisor holds for its nodes): no
    plain bind takes it, a node's listener binds it and binds it again
    after a restart, a connection while no node listens is refused, and
    it is free once released."""
    res = reserve_ports(2)
    port = res.ports[0]
    try:
        assert len(set(res.ports)) == 2
        plain = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        with pytest.raises(OSError) as err:
            plain.bind(("127.0.0.1", port))
        plain.close()
        assert err.value.errno == errno.EADDRINUSE
        for _launch in range(2):
            ls = listen_socket("127.0.0.1", port, 4)
            socket.create_connection(("127.0.0.1", port), timeout=2).close()
            ls.close()
        with pytest.raises(ConnectionRefusedError):
            socket.create_connection(("127.0.0.1", port), timeout=2)
    finally:
        res.close()
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", port))
    s.close()


# ------------------------------------------------------- own-event WAL


def _own_events(pk, sk, n, tag=b"w"):
    return [
        Event(
            d=tag + b"-%d" % i,
            p=(crypto.hash_bytes(tag + b"p%d" % i),
               crypto.hash_bytes(tag + b"q%d" % i)),
            t=i, c=pk,
        ).signed(sk)
        for i in range(n)
    ]


def test_wal_roundtrip_and_clean_marker_semantics(tmp_path):
    pk, sk = crypto.keypair(b"wal-owner")
    path = str(tmp_path / "own.wal")
    w = OwnEventWal(path, pk=pk)
    assert not w.existed and not w.unclean
    evs = _own_events(pk, sk, 3)
    for ev in evs:
        w.append(ev)
    w.mark_clean()
    # reopen: clean shutdown observed, events intact, marker consumed
    w2 = OwnEventWal(path, pk=pk)
    assert w2.existed and w2.clean_shutdown and not w2.unclean
    assert [e.id for e in w2.events] == [e.id for e in evs]
    assert w2.torn_tail_recovered == 0
    w2.close()
    # the reopen truncated the marker away: a third open without a new
    # mark_clean sees an unclean shutdown — "clean" only ever holds
    # between a graceful stop and the next start
    w3 = OwnEventWal(path, pk=pk)
    assert w3.unclean and not w3.clean_shutdown
    assert [e.id for e in w3.events] == [e.id for e in evs]
    w3.close()


def test_wal_torn_tail_truncation_at_every_offset(tmp_path):
    """kill -9 tears the last append at an arbitrary byte: recovery must
    keep exactly the durable prefix at EVERY possible cut point, count
    the torn tail, and let appending resume from the cut."""
    pk, sk = crypto.keypair(b"wal-torn")
    path = str(tmp_path / "torn.wal")
    w = OwnEventWal(path, pk=pk)
    evs = _own_events(pk, sk, 3)
    for ev in evs:
        w.append(ev)
    w.close()
    with open(path, "rb") as f:
        data = f.read()
    last_rec = bytes([TAG_EVENT]) + encode_event(evs[-1])
    last_start = len(data) - len(last_rec)
    assert data[last_start:] == last_rec
    prefix_ids = [e.id for e in evs[:-1]]
    for cut in range(last_start, len(data)):
        torn_path = str(tmp_path / ("cut-%d.wal" % cut))
        with open(torn_path, "wb") as f:
            f.write(data[:cut])
        t = OwnEventWal(torn_path, pk=pk)
        assert [e.id for e in t.events] == prefix_ids, cut
        # a cut exactly on the record boundary is a whole-record loss,
        # not torn bytes; every other offset is a detected torn tail
        assert t.torn_tail_recovered == (0 if cut == last_start else 1), cut
        assert t.unclean
        # appending resumes cleanly from the truncated prefix
        extra = _own_events(pk, sk, 1, tag=b"extra")[0]
        t.append(extra)
        t.close()
        t2 = OwnEventWal(torn_path, pk=pk)
        assert [e.id for e in t2.events] == prefix_ids + [extra.id], cut
        assert t2.torn_tail_recovered == 0
        t2.close()


def test_wal_corrupt_tail_and_foreign_creator_recovered(tmp_path):
    pk, sk = crypto.keypair(b"wal-corrupt")
    path = str(tmp_path / "c.wal")
    w = OwnEventWal(path, pk=pk)
    evs = _own_events(pk, sk, 2)
    for ev in evs:
        w.append(ev)
    w.close()
    with open(path, "rb") as f:
        data = f.read()
    # bit-rot inside the last record body: decodes-but-unverifiable (or
    # undecodable) — either way the valid prefix is events[:-1]
    last_rec = bytes([TAG_EVENT]) + encode_event(evs[-1])
    flip_at = len(data) - len(last_rec) // 2
    flipped = bytearray(data)
    flipped[flip_at] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(flipped))
    t = OwnEventWal(path, pk=pk)
    assert [e.id for e in t.events] == [evs[0].id]
    assert t.torn_tail_recovered == 1
    t.close()
    # a record naming a foreign creator can only mean corruption: an own-
    # event WAL never holds another member's history
    other_pk, other_sk = crypto.keypair(b"other-member")
    foreign = _own_events(other_pk, other_sk, 1, tag=b"f")[0]
    path2 = str(tmp_path / "f.wal")
    w2 = OwnEventWal(path2, pk=pk)
    w2.append(evs[0])
    w2.close()
    with open(path2, "ab") as f:
        f.write(bytes([TAG_EVENT]) + encode_event(foreign))
    t2 = OwnEventWal(path2, pk=pk)
    assert [e.id for e in t2.events] == [evs[0].id]
    assert t2.torn_tail_recovered == 1
    t2.close()
    # a whole-file mangle (bad magic) recovers to an empty WAL
    path3 = str(tmp_path / "m.wal")
    with open(path3, "wb") as f:
        f.write(b"NOTAWAL" + b"\x00" * 40)
    t3 = OwnEventWal(path3, pk=pk)
    assert t3.events == [] and t3.torn_tail_recovered == 1
    t3.append(evs[0])
    t3.close()
    t4 = OwnEventWal(path3, pk=pk)
    assert [e.id for e in t4.events] == [evs[0].id]
    t4.close()


def test_wal_clean_marker_mid_file_is_torn_state(tmp_path):
    pk, sk = crypto.keypair(b"wal-mid")
    path = str(tmp_path / "mid.wal")
    w = OwnEventWal(path, pk=pk)
    evs = _own_events(pk, sk, 2)
    w.append(evs[0])
    w.mark_clean()
    # bytes after a "clean" marker mean the file kept growing after a
    # supposedly-final close: torn state, recover the prefix
    with open(path, "ab") as f:
        f.write(bytes([TAG_EVENT]) + encode_event(evs[1]))
    t = OwnEventWal(path, pk=pk)
    assert [e.id for e in t.events] == [evs[0].id]
    assert t.torn_tail_recovered == 1 and not t.clean_shutdown
    t.close()


def test_wal_rewrite_prunes_atomically(tmp_path):
    pk, sk = crypto.keypair(b"wal-prune")
    path = str(tmp_path / "p.wal")
    w = OwnEventWal(path, pk=pk)
    evs = _own_events(pk, sk, 4)
    for ev in evs:
        w.append(ev)
    w.rewrite(evs[2:])          # checkpoint covered the first two
    assert [e.id for e in w.events] == [e.id for e in evs[2:]]
    tail = _own_events(pk, sk, 1, tag=b"t")[0]
    w.append(tail)              # appending still works post-rewrite
    w.close()
    t = OwnEventWal(path, pk=pk)
    assert [e.id for e in t.events] == [evs[2].id, evs[3].id, tail.id]
    assert t.torn_tail_recovered == 0
    t.close()
    assert not os.path.exists(path + ".tmp")


# ------------------------------------------------------- tx ingestion


def test_txpool_ack_dup_and_batch_roundtrip():
    pool = TxPool(max_pool=100, batch_bytes=1 << 16, max_tx_bytes=1024)
    ok, reply = pool.submit(b"hello")
    txid = crypto.hash_bytes(b"hello")
    assert ok and reply == b"ACK:" + txid.hex().encode()
    ok2, reply2 = pool.submit(b"hello")
    assert not ok2 and reply2 == b"DUP:" + txid.hex().encode()
    pool.submit(b"world")
    batch = pool.next_batch()
    assert decode_batch(batch) == [b"hello", b"world"]
    assert pool.next_batch() == b""        # drained
    # batched txs stay deduplicated after the drain
    ok3, reply3 = pool.submit(b"hello")
    assert not ok3 and reply3.startswith(b"DUP:")
    c = pool.counters
    assert c["tx_submitted"] == 4 and c["tx_accepted"] == 2
    assert c["tx_duplicate"] == 2 and c["tx_batched"] == 2


def test_txpool_shed_oversize_pool_and_window():
    window = [0]
    pool = TxPool(
        max_pool=2, batch_bytes=1 << 16, max_tx_bytes=8,
        max_undecided=10, window_fn=lambda: window[0],
    )
    assert pool.submit(b"x" * 9) == (False, b"SHED:oversize")
    assert pool.submit(b"") == (False, b"SHED:oversize")
    window[0] = 11                          # behind on consensus: shed
    assert pool.submit(b"a") == (False, b"SHED:window")
    window[0] = 10                          # at the threshold: admit
    assert pool.submit(b"a")[0]
    assert pool.submit(b"b")[0]
    assert pool.submit(b"c") == (False, b"SHED:pool")
    c = pool.counters
    assert c["tx_shed_oversize"] == 2
    assert c["tx_shed_window"] == 1
    assert c["tx_shed_pool"] == 1
    assert len(pool.pending) == 2


def test_txpool_batch_size_cap_and_fifo_order():
    pool = TxPool(max_pool=100, batch_bytes=64, max_tx_bytes=1024)
    txs = [b"tx-%02d" % i + b"y" * 10 for i in range(10)]
    for tx in txs:
        assert pool.submit(tx)[0]
    drained = []
    while pool.pending:
        batch = pool.next_batch()
        assert len(batch) <= 64
        drained.extend(decode_batch(batch))
    assert drained == txs                   # FIFO across batches
    assert pool.counters["tx_batches"] >= 2


def test_txpool_oversized_single_tx_still_ships():
    """One tx bigger than batch_bytes must still drain (a batch always
    ships >= 1 tx) — otherwise it wedges the FIFO head forever."""
    pool = TxPool(max_pool=10, batch_bytes=16, max_tx_bytes=1024)
    big = b"B" * 100
    assert pool.submit(big)[0]
    assert decode_batch(pool.next_batch()) == [big]


def test_decode_batch_total_on_garbage():
    assert decode_batch(b"") == []
    assert decode_batch(b"tx:0:1") == []           # legacy sim payload
    assert decode_batch(b"TXB1") == []             # truncated header
    assert decode_batch(b"TXB1\x02\x00\x04\x00\x00\x00abcd") == []
    good = encode_batch([b"a", b"bb"])
    assert decode_batch(good) == [b"a", b"bb"]
    assert decode_batch(good[:-1]) == []           # torn tail
    assert decode_batch(encode_batch([])) == []


# -------------------------------------------------- socket transport


def _serve_node(node, port):
    def dispatch(kind, src, payload, trace=b""):
        if kind == frame.KIND_SYNC:
            return frame.STATUS_OK, node.ask_sync(src, payload)
        if kind == frame.KIND_WANT:
            return frame.STATUS_OK, node.ask_events(src, payload)
        raise ValueError("unknown kind %d" % kind)

    return NodeServer("127.0.0.1", port, dispatch, frame.MAX_FRAME_BYTES)


def test_socket_transport_parity_with_in_process_transport():
    """Same members, same seed, same schedule — the in-process Transport
    and a loopback SocketTransport must decide bit-identical prefixes
    (the wire is a delivery detail, never a consensus input)."""
    n, turns, seed = 3, 60, 11
    config = SwirldConfig(n_members=n, seed=seed)
    keys = [crypto.keypair(b"parity-%d" % i) for i in range(n)]
    members = [pk for pk, _ in keys]

    # reference: the in-process dict-of-endpoints transport
    clock = [0]
    network, network_want = {}, {}
    ref_transport = Transport(network, network_want)
    ref_nodes = []
    for pk, sk in keys:
        node = Node(
            sk=sk, pk=pk, network=network, members=members, config=config,
            clock=lambda: clock[0], network_want=network_want,
            transport=ref_transport,
        )
        network[pk] = node.ask_sync
        network_want[pk] = node.ask_events
        ref_nodes.append(node)

    # candidate: the same nodes behind loopback TCP
    ports = allocate_ports(n)
    clock2 = [0]
    settings = resolve_net_settings()
    sock_nodes, servers, transports = [], [], []
    try:
        for i, (pk, sk) in enumerate(keys):
            st = SocketTransport(settings=settings, src=pk)
            for j, pk_j in enumerate(members):
                if j != i:
                    st.register(pk_j, "127.0.0.1", ports[j])
            node = Node(
                sk=sk, pk=pk, network={}, members=members, config=config,
                clock=lambda: clock2[0], transport=st,
            )
            transports.append(st)
            sock_nodes.append(node)
        for i, node in enumerate(sock_nodes):
            servers.append(_serve_node(node, ports[i]))

        # one seeded schedule, two delivery layers: identical draws
        rng_a, rng_b = random.Random(seed), random.Random(seed)
        for t in range(turns):
            clock[0] = t + 1
            i = rng_a.randrange(n)
            node = ref_nodes[i]
            peer = rng_a.choice([m for m in members if m != node.pk])
            new = node.sync(peer, b"tx:%d" % t)
            if new:
                node.consensus_pass(new)
        for t in range(turns):
            clock2[0] = t + 1
            i = rng_b.randrange(n)
            node = sock_nodes[i]
            peer = rng_b.choice([m for m in members if m != node.pk])
            new = node.sync(peer, b"tx:%d" % t)
            if new:
                node.consensus_pass(new)
    finally:
        for s in servers:
            s.close()
        for st in transports:
            st.close()

    ref_orders = [list(nd.consensus) for nd in ref_nodes]
    sock_orders = [list(nd.consensus) for nd in sock_nodes]
    assert min(len(o) for o in ref_orders) > 0
    assert sock_orders == ref_orders
    # the decided EVENTS (not just ids) are bit-identical too
    for ref, cand in zip(ref_nodes, sock_nodes):
        for eid in ref.consensus:
            assert encode_event(ref.hg[eid]) == encode_event(cand.hg[eid])
    # real traffic flowed over the wire
    assert all(st.stats["calls"] > 0 for st in transports)


def test_socket_transport_error_plane_mapping():
    pk_self, _ = crypto.keypair(b"err-self")
    pk_peer, _ = crypto.keypair(b"err-peer")
    settings = resolve_net_settings()
    settings["connect_timeout_s"] = 0.5
    settings["call_timeout_s"] = 0.3

    # no address registered at all
    st = SocketTransport(settings=settings, src=pk_self)
    with pytest.raises(PeerUnreachable):
        st.call(pk_self, pk_peer, CHANNEL_SYNC, b"x")
    assert st.endpoint(pk_peer, CHANNEL_SYNC) is None

    # nothing listening on the port: connect refused -> PeerUnreachable
    (port,) = allocate_ports(1)
    st.register(pk_peer, "127.0.0.1", port)
    assert st.endpoint(pk_peer, CHANNEL_SYNC) == ("127.0.0.1", port)
    with pytest.raises(PeerUnreachable):
        st.call(pk_self, pk_peer, CHANNEL_SYNC, b"x")
    assert st.stats["connect_failures"] >= 1

    # a listener that never replies: deadline -> DeliveryTimeout
    silent = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    silent.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    silent.bind(("127.0.0.1", 0))
    silent.listen(1)
    st.register(pk_peer, "127.0.0.1", silent.getsockname()[1])
    try:
        with pytest.raises(DeliveryTimeout):
            st.call(pk_self, pk_peer, CHANNEL_SYNC, b"x")
        assert st.stats["timeouts"] == 1
    finally:
        silent.close()
        st.close()


def test_socket_transport_status_reject_and_error_planes():
    """STATUS_REJECT resurfaces as the endpoints' documented ValueError
    (counted bad reply, never retried); STATUS_ERROR is retryable."""
    (port,) = allocate_ports(1)
    mode = {"raise": ValueError("bad request payload")}

    def dispatch(kind, src, payload, trace=b""):
        raise mode["raise"]

    server = NodeServer("127.0.0.1", port, dispatch, frame.MAX_FRAME_BYTES)
    pk_self, _ = crypto.keypair(b"rej-self")
    pk_peer, _ = crypto.keypair(b"rej-peer")
    st = SocketTransport(settings=resolve_net_settings(), src=pk_self)
    st.register(pk_peer, "127.0.0.1", port)
    try:
        with pytest.raises(ValueError, match="bad request payload"):
            st.call(pk_self, pk_peer, CHANNEL_SYNC, b"x")
        assert st.stats["rejects"] == 1
        mode["raise"] = RuntimeError("server bug")
        with pytest.raises(PeerUnreachable, match="server error"):
            st.call(pk_self, pk_peer, CHANNEL_SYNC, b"x")
        assert st.stats["peer_errors"] == 1
    finally:
        server.close()
        st.close()


def test_socket_transport_redials_stale_cached_connection():
    """A cached connection killed server-side is redialed once,
    transparently — a restarted peer costs one redial, not a failure."""
    (port,) = allocate_ports(1)

    # a one-shot first incarnation: serves one request, closes the conn
    # AND the listener (so the "restarted" server can re-bind the port)
    ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    ls.bind(("127.0.0.1", port))
    ls.listen(1)

    def one_shot():
        conn, _addr = ls.accept()
        _kind, _src, payload, _trace = frame.recv_request(conn)
        frame.send_reply(conn, frame.STATUS_OK, b"pong:" + payload)
        conn.close()
        ls.close()

    t = threading.Thread(target=one_shot, daemon=True)
    t.start()

    pk_self, _ = crypto.keypair(b"redial-self")
    pk_peer, _ = crypto.keypair(b"redial-peer")
    st = SocketTransport(settings=resolve_net_settings(), src=pk_self)
    st.register(pk_peer, "127.0.0.1", port)
    server = None
    try:
        assert st.call(pk_self, pk_peer, CHANNEL_SYNC, b"a") == b"pong:a"
        t.join(5)
        assert not t.is_alive()

        def dispatch(kind, src, payload, trace=b""):
            return frame.STATUS_OK, b"pong:" + payload

        server = NodeServer(
            "127.0.0.1", port, dispatch, frame.MAX_FRAME_BYTES,
        )
        # the cached conn is dead; the call must redial, not fail
        assert st.call(pk_self, pk_peer, CHANNEL_SYNC, b"b") == b"pong:b"
    finally:
        if server is not None:
            server.close()
        st.close()
        ls.close()


# ------------------------------------------------ startup post-mortem


def test_startup_postmortem_dumps_only_on_unclean_wal(tmp_path):
    pk, sk = crypto.keypair(b"pm-owner")
    path = str(tmp_path / "pm.wal")
    w = OwnEventWal(path, pk=pk)
    for ev in _own_events(pk, sk, 2):
        w.append(ev)
    w.mark_clean()
    dump_dir = str(tmp_path / "dumps")
    os.makedirs(dump_dir)
    # clean shutdown: no dump
    clean = OwnEventWal(path, pk=pk)
    rec = FlightRecorder(dump_dir=dump_dir, wall_clock=lambda: 0.0)
    assert startup_postmortem(clean, rec, "n0") is None
    clean.close()
    # that reopen consumed the marker; the next open is unclean — the
    # previous incarnation "died" without a graceful stop
    unclean = OwnEventWal(path, pk=pk)
    assert unclean.unclean
    dump = startup_postmortem(unclean, rec, "n0")
    assert dump is not None and os.path.exists(dump)
    doc = load_dump(dump)
    assert doc["reason"] == "unclean_shutdown"
    assert rec.trigger_counts["unclean_shutdown"] == 1
    unclean.close()
    # no dump dir: the trigger is recorded but returns no path
    rec2 = FlightRecorder(dump_dir=None)
    unclean2 = OwnEventWal(path, pk=pk)
    assert startup_postmortem(unclean2, rec2, "n1") is None
    assert rec2.trigger_counts["unclean_shutdown"] == 1
    unclean2.close()


def test_node_runtime_holds_first_turn_until_peers_listen(tmp_path):
    """The port's start barrier (``NodeRuntime._await_peers``): the first
    gossip turn waits until every peer's listener accepts, gives up at the
    deadline, and returns at once once the node is told to stop."""
    ports = allocate_ports(3)
    rt = NodeRuntime({
        "index": 0, "n_nodes": 3, "seed": 3, "ports": ports,
        "workdir": str(tmp_path),
    })
    listeners = []

    def listen_late():
        frame.sleep(0.4)
        for port in ports[1:]:
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", port))
            s.listen(8)
            listeners.append(s)

    try:
        t = threading.Thread(target=listen_late)
        t0 = frame.now()
        t.start()
        rt._await_peers(10.0)
        waited = frame.now() - t0
        t.join()
        assert len(listeners) == 2 and 0.4 <= waited < 10.0
        for s in listeners:
            s.close()
        t0 = frame.now()
        rt._await_peers(0.3)              # nobody listens: the deadline
        assert 0.3 <= frame.now() - t0 < 5.0
        rt.stop.set()
        t0 = frame.now()
        rt._await_peers(10.0)
        assert frame.now() - t0 < 1.0
    finally:
        for s in listeners:
            s.close()
        rt.transport.close()
        rt.wal.close()


def test_node_server_worker_threads_keep_no_state():
    """SW006 surface check: NodeServer's worker threads must not store
    mutable state on self — everything flows through the dispatch
    closure (the lock discipline the analysis suite audits)."""
    (port,) = allocate_ports(1)
    seen = []
    done = threading.Event()

    def dispatch(kind, src, payload, trace=b""):
        seen.append((kind, src, payload, trace))
        done.set()
        return frame.STATUS_OK, b"ok"

    server = NodeServer("127.0.0.1", port, dispatch, frame.MAX_FRAME_BYTES)
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
            s.settimeout(5.0)
            frame.send_request(s, frame.KIND_PING, b"me", b"probe")
            assert frame.recv_reply(s) == (frame.STATUS_OK, b"ok")
        assert done.wait(5)
        assert seen == [(frame.KIND_PING, b"me", b"probe", b"")]
    finally:
        server.close()

# ------------------------------------------------- socket fault proxy


def _echo_node(port):
    def dispatch(kind, src, payload, trace=b""):
        return frame.STATUS_OK, b"pong:" + payload

    return NodeServer("127.0.0.1", port, dispatch, frame.MAX_FRAME_BYTES)


def _proxy_call(addr, payload, timeout=5.0):
    with socket.create_connection(tuple(addr), timeout=timeout) as s:
        s.settimeout(timeout)
        frame.send_request(s, frame.KIND_SYNC, b"tester", payload)
        return frame.recv_reply(s)


def test_faulty_proxy_clean_relay():
    """A fault-free plan relays frames bit-intact in both directions."""
    (up_port,) = allocate_ports(1)
    server = _echo_node(up_port)
    stats = collections.Counter()
    proxy = FaultyProxy(
        0, 1, ("127.0.0.1", up_port), FaultPlan(seed=5),
        clock=lambda: 0.0, count=lambda k: stats.update([k]),
    )
    try:
        for i in range(3):
            status, reply = _proxy_call(proxy.addr, b"hello-%d" % i)
            assert (status, reply) == (frame.STATUS_OK, b"pong:hello-%d" % i)
        assert stats["relayed"] == 3
        assert stats["drops"] == 0 and stats["partition_blocked"] == 0
    finally:
        proxy.close()
        server.close()


def test_faulty_proxy_partition_blocks_then_heals():
    """Inside a scheduled partition window the proxy eats the frame and
    tears the connection; once the injected clock passes the window the
    same link relays again — no proxy restart, no reconfiguration."""
    (up_port,) = allocate_ports(1)
    server = _echo_node(up_port)
    stats = collections.Counter()
    now = [5.0]
    plan = FaultPlan(
        seed=5, partitions=[Partition(start=0.0, end=10.0, group=(0,))],
    )
    proxy = FaultyProxy(
        0, 1, ("127.0.0.1", up_port), plan,
        clock=lambda: now[0], count=lambda k: stats.update([k]),
    )
    try:
        with socket.create_connection(tuple(proxy.addr), timeout=5) as s:
            s.settimeout(5.0)
            frame.send_request(s, frame.KIND_SYNC, b"t", b"blocked")
            with pytest.raises((ConnectionError, FrameError)):
                frame.recv_reply(s)
        assert stats["partition_blocked"] == 1
        assert stats["relayed"] == 0
        now[0] = 10.0   # heal: start <= t < end no longer holds
        status, reply = _proxy_call(proxy.addr, b"after")
        assert (status, reply) == (frame.STATUS_OK, b"pong:after")
        assert stats["relayed"] == 1
    finally:
        proxy.close()
        server.close()


def test_faulty_proxy_drop_and_reset_semantics():
    """drop=1.0 loses the request BEFORE the upstream sees it; reset=1.0
    tears the client connection AFTER the upstream processed the request
    (the redial-after-success hazard the transport must absorb)."""
    (up_port,) = allocate_ports(1)
    seen = []

    def dispatch(kind, src, payload, trace=b""):
        seen.append(payload)
        return frame.STATUS_OK, b"ok"

    server = NodeServer("127.0.0.1", up_port, dispatch, frame.MAX_FRAME_BYTES)
    stats = collections.Counter()

    def mk(lf):
        return FaultyProxy(
            0, 1, ("127.0.0.1", up_port), FaultPlan(seed=7, default=lf),
            clock=lambda: 0.0, count=lambda k: stats.update([k]),
        )

    dropper = mk(LinkFaults(drop=1.0))
    try:
        with socket.create_connection(tuple(dropper.addr), timeout=5) as s:
            s.settimeout(5.0)
            frame.send_request(s, frame.KIND_SYNC, b"t", b"lost")
            with pytest.raises((ConnectionError, FrameError)):
                frame.recv_reply(s)
        assert stats["drops"] >= 1 and seen == []
    finally:
        dropper.close()

    resetter = mk(LinkFaults(reset=1.0))
    try:
        with socket.create_connection(tuple(resetter.addr), timeout=5) as s:
            s.settimeout(5.0)
            frame.send_request(s, frame.KIND_SYNC, b"t", b"processed")
            with pytest.raises((ConnectionError, FrameError)):
                frame.recv_reply(s)
        assert stats["resets"] >= 1
        assert seen == [b"processed"]   # the destination DID apply it
    finally:
        resetter.close()
        server.close()


def test_proxy_fleet_routes_every_directed_link():
    """One proxy per directed pair, each with its own port; frames sent
    to addr_for(i, j) land on upstream j; shared stats aggregate."""
    ports = allocate_ports(2)
    servers = [_echo_node(p) for p in ports]
    fleet = ProxyFleet(FaultPlan(seed=3), 2, ports)
    try:
        addrs = {
            (i, j): fleet.addr_for(i, j)
            for i in range(2) for j in range(2) if i != j
        }
        assert len(set(addrs.values())) == 2   # distinct listeners
        assert set(addrs.values()).isdisjoint(
            {("127.0.0.1", p) for p in ports}
        )
        for (i, j), addr in sorted(addrs.items()):
            status, reply = _proxy_call(addr, b"link-%d-%d" % (i, j))
            assert (status, reply) == (
                frame.STATUS_OK, b"pong:link-%d-%d" % (i, j),
            )
        assert fleet.stats["relayed"] == 2
    finally:
        fleet.close()
        for s in servers:
            s.close()


def test_socket_transport_reprobe_bridges_restart_gap():
    """satellite: a peer mid-restart kills the cached connection AND has
    no listener bound yet.  The transparent redial's cold connect fails;
    the bounded re-probe (redial_probe_s) must bridge the gap so the
    call succeeds with one redial + one probe instead of surfacing a
    spurious PeerUnreachable."""
    (port,) = allocate_ports(1)
    ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    ls.bind(("127.0.0.1", port))
    ls.listen(1)

    def one_shot():
        conn, _addr = ls.accept()
        _kind, _src, payload, _trace = frame.recv_request(conn)
        frame.send_reply(conn, frame.STATUS_OK, b"pong:" + payload)
        conn.close()
        ls.close()   # the dying incarnation's listener goes away too

    threading.Thread(target=one_shot, daemon=True).start()

    pk_self, _ = crypto.keypair(b"probe-self")
    pk_peer, _ = crypto.keypair(b"probe-peer")
    settings = resolve_net_settings()
    settings["redial_probe_s"] = 1.0
    st = SocketTransport(settings=settings, src=pk_self)
    st.register(pk_peer, "127.0.0.1", port)

    reborn = {}

    def rebind_later():
        frame.sleep(0.35)   # the restart gap: no listener during it

        def dispatch(kind, src, payload, trace=b""):
            return frame.STATUS_OK, b"pong2:" + payload

        reborn["server"] = NodeServer(
            "127.0.0.1", port, dispatch, frame.MAX_FRAME_BYTES,
        )

    try:
        assert st.call(pk_self, pk_peer, CHANNEL_SYNC, b"a") == b"pong:a"
        t = threading.Thread(target=rebind_later, daemon=True)
        t.start()
        # cached conn is dead, listener absent: redial fails its cold
        # connect, the probe waits out the gap, the retry lands
        assert st.call(pk_self, pk_peer, CHANNEL_SYNC, b"b") == b"pong2:b"
        t.join(5)
        assert st.stats["redials"] >= 1
        assert st.stats["redial_probes"] == 1
    finally:
        st.close()
        if "server" in reborn:
            reborn["server"].close()


def test_wal_torn_tail_recovery_under_active_partition():
    """satellite: kill -9 tears the WAL tail while the survivor's only
    link is partitioned.  Recovery of the durable prefix is purely local
    (needs no network); gossip through the healed link then backfills
    the missing other-parents so every recovered event rejoins the DAG."""
    n, seed = 2, 23
    config = SwirldConfig(n_members=n, seed=seed)
    keys = [crypto.keypair(b"walpart-%d" % i) for i in range(n)]
    members = [pk for pk, _ in keys]

    # ---- phase A: a genuine own-event chain, appended like node_proc
    clock = [0]
    network, network_want = {}, {}
    transport = Transport(network, network_want)
    nodes = []
    for pk, sk in keys:
        node = Node(
            sk=sk, pk=pk, network=network, members=members, config=config,
            clock=lambda: clock[0], network_want=network_want,
            transport=transport,
        )
        network[pk] = node.ask_sync
        network_want[pk] = node.ask_events
        nodes.append(node)
    import tempfile
    wal_path = os.path.join(
        tempfile.mkdtemp(prefix="swirld-walpart-"), "n0.wal",
    )
    wal = OwnEventWal(wal_path, pk=members[0])
    wal.append(nodes[0].hg[nodes[0].head])   # durable genesis
    for t in range(4):
        clock[0] = t + 1
        new = nodes[0].sync(members[1], b"tx:%d" % t)
        if new:
            nodes[0].consensus_pass(new)
        wal.append(nodes[0].hg[nodes[0].head])
    n_appended = len(wal.events)
    wal.close()   # no mark_clean: this incarnation "dies"
    with open(wal_path, "r+b") as f:
        f.truncate(os.path.getsize(wal_path) - 3)   # torn mid-record

    # ---- phase B: restart behind a partitioned proxy link
    (peer_port,) = allocate_ports(1)
    server = _serve_node(nodes[1], peer_port)
    now = [0.0]
    plan = FaultPlan(
        seed=seed, partitions=[Partition(start=0.0, end=100.0, group=(0,))],
    )
    pstats = collections.Counter()
    proxy = FaultyProxy(
        0, 1, ("127.0.0.1", peer_port), plan,
        clock=lambda: now[0], count=lambda k: pstats.update([k]),
    )
    st = SocketTransport(settings=resolve_net_settings(), src=members[0])
    st.register(members[1], proxy.addr[0], proxy.addr[1])
    try:
        # torn-tail recovery is local: durable prefix, counted tear —
        # with the only peer link dead
        wal2 = OwnEventWal(wal_path, pk=members[0])
        assert wal2.unclean
        assert wal2.torn_tail_recovered == 1
        assert len(wal2.events) == n_appended - 1
        clock2 = [100]
        node0b = Node(
            sk=keys[0][1], pk=members[0], network={}, members=members,
            config=config, clock=lambda: clock2[0], transport=st,
        )
        wal_ids = []
        node0b._ingest(wal2.events, wal_ids)   # node_proc's boot replay
        if wal_ids:
            node0b.consensus_pass(wal_ids)
        # the link is down: pull degrades to an empty delta (it never
        # raises on peer behavior) — recovery above already held
        assert node0b.sync(members[1], b"during-partition") == []
        assert pstats["partition_blocked"] >= 1
        assert st.stats["conn_errors"] >= 1
        # the WAL keeps accepting appends during the partition
        wal2.append(node0b.hg[node0b.head])
        # heal: the same link carries gossip again; node1's events
        # backfill the recovered chain's other-parents.  The clock jump
        # also clears any breaker cooldown the dead link accrued.
        now[0] = 100.0
        clock2[0] = 1000
        new = node0b.sync(members[1], b"post-heal")
        assert new
        missing = [e.id for e in wal2.events if e.id not in node0b.hg]
        assert missing == []   # every recovered event rejoined the DAG
        wal2.close()
    finally:
        st.close()
        proxy.close()
        server.close()


# ------------------------------------------------- against the reference


@pytest.fixture
def sim_signer():
    """Both packages' crypto backends set to the simulation signer,
    restored afterwards."""
    prev = ref_crypto.backend_name(), crypto.backend_name()
    ref_crypto.set_backend("sim")
    crypto.set_backend("sim")
    try:
        yield
    finally:
        ref_crypto.set_backend(prev[0])
        crypto.set_backend(prev[1])


def _wire(mod, send, *args, **kw):
    """The bytes ``mod.<send>(sock, *args, **kw)`` puts on the wire."""
    a, b = _pair()
    try:
        getattr(mod, send)(a, *args, **kw)
        a.close()
        out = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return out
            out += chunk
    finally:
        b.close()


@pytest.mark.parametrize("traced", [False, True])
def test_frames_byte_equal_to_reference(traced):
    names = [n for n in dir(ref_frame)
             if n.startswith(("KIND_", "STATUS_", "TRACE_", "MAX_"))]
    assert {n: getattr(frame, n) for n in names} == {
        n: getattr(ref_frame, n) for n in names}
    trace = pack_context(b"trace-id", 0x1234) if traced else b""
    kinds = [getattr(frame, n) for n in names if n.startswith("KIND_")]
    cases = [(b"", b""), (b"S" * 32, b"payload-bytes"), (b"pk", bytes(range(256)) * 16)]
    for kind in kinds:
        for src, payload in cases:
            got = _wire(frame, "send_request", kind, src, payload, trace=trace)
            want = _wire(ref_frame, "send_request", kind, src, payload, trace=trace)
            assert got == want, (kind, src)
            # each package decodes the other's frame
            a, b = _pair()
            try:
                a.sendall(want)
                assert frame.recv_request(b) == (kind, src, payload, trace)
                a.sendall(got)
                assert ref_frame.recv_request(b) == (kind, src, payload, trace)
            finally:
                a.close()
                b.close()
    for status in (frame.STATUS_OK, frame.STATUS_REJECT, frame.STATUS_ERROR):
        assert (_wire(frame, "send_reply", status, b"reply")
                == _wire(ref_frame, "send_reply", status, b"reply"))


def _ref_own_events(pk, sk, n, tag=b"w"):
    return [
        RefEvent(
            d=tag + b"-%d" % i,
            p=(crypto.hash_bytes(tag + b"p%d" % i),
               crypto.hash_bytes(tag + b"q%d" % i)),
            t=i, c=pk,
        ).signed(sk)
        for i in range(n)
    ]


def _scan(wal_cls, path, pk):
    w = wal_cls(path, pk=pk)
    try:
        return ([e.id for e in w.events], w.existed, w.clean_shutdown,
                w.unclean, w.torn_tail_recovered)
    finally:
        w.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_wal_bytes_and_scans_equal_across_packages(sim_signer, tmp_path, writer):
    """A WAL written by either package is byte-equal to the other's and
    scans equal in both, at every cut of its tail (torn records, the
    clean marker) and after a ``rewrite``."""
    pk, sk = crypto.keypair(b"wal-cross")
    assert ref_crypto.keypair(b"wal-cross") == (pk, sk)
    files = {}
    for name, wal_cls, evs in (
        ("port", OwnEventWal, _own_events(pk, sk, 3)),
        ("reference", ref_wal.OwnEventWal, _ref_own_events(pk, sk, 3)),
    ):
        path = str(tmp_path / f"{name}.wal")
        w = wal_cls(path, pk=pk)
        for ev in evs:
            w.append(ev)
        w.mark_clean()
        with open(path, "rb") as f:
            files[name] = f.read()
    assert files["port"] == files["reference"]
    data = files[writer]
    assert ref_wal.MAGIC == MAGIC
    for cut in range(len(MAGIC), len(data) + 1):
        scans, after = [], []
        for name, wal_cls in (("port", OwnEventWal), ("ref", ref_wal.OwnEventWal)):
            path = str(tmp_path / f"cut-{cut}-{name}.wal")
            with open(path, "wb") as f:
                f.write(data[:cut])
            scans.append(_scan(wal_cls, path, pk))
            with open(path, "rb") as f:
                after.append(f.read())     # the open truncated the same bytes
        assert scans[0] == scans[1], cut
        assert after[0] == after[1], cut
    # rewrite (checkpoint pruning) leaves the same bytes in both
    pruned = []
    for name, wal_cls, evs in (
        ("port", OwnEventWal, _own_events(pk, sk, 4)),
        ("ref", ref_wal.OwnEventWal, _ref_own_events(pk, sk, 4)),
    ):
        path = str(tmp_path / f"prune-{name}.wal")
        w = wal_cls(path, pk=pk)
        for ev in evs:
            w.append(ev)
        w.rewrite(evs[2:])
        w.close()
        with open(path, "rb") as f:
            pruned.append(f.read())
    assert pruned[0] == pruned[1]


def test_txpool_replies_and_batches_equal_reference():
    rng = random.Random(5)
    window = [0]
    kw = dict(max_pool=16, batch_bytes=200, max_tx_bytes=48,
              max_undecided=10, window_fn=lambda: window[0], dedup_cap=32)
    port, ref = TxPool(**kw), ref_ingest.TxPool(**kw)
    txs = [b"", b"o" * 49] + [b"tx-%03d" % i + b"p" * (i % 40) for i in range(200)]
    batches = 0
    for _ in range(1500):
        window[0] = rng.choice([0, 5, 10, 11, 30])
        if rng.random() < 0.05:
            got = port.next_batch()
            assert got == ref.next_batch()
            batches += bool(got)
        else:
            tx = rng.choice(txs)
            assert port.submit(tx) == ref.submit(tx)
    assert batches > 10
    assert port.counters == ref.counters
    assert list(port.pending.items()) == list(ref.pending.items())
    assert list(port._seen) == list(ref._seen)
    assert all(port.counters[k] > 0 for k in port.counters)
    # the batch codec, garbage included
    for txs_ in ([], [b"a"], [b"a", b"bb", b"c" * 300]):
        enc = encode_batch(txs_)
        assert enc == ref_ingest.encode_batch(txs_)
        for cut in range(len(enc) + 1):
            assert decode_batch(enc[:cut]) == ref_ingest.decode_batch(enc[:cut])


def _ref_serve_node(node, port):
    def dispatch(kind, src, payload, trace=b""):
        if kind == ref_frame.KIND_SYNC:
            return ref_frame.STATUS_OK, node.ask_sync(src, payload)
        if kind == ref_frame.KIND_WANT:
            return ref_frame.STATUS_OK, node.ask_events(src, payload)
        raise ValueError("unknown kind %d" % kind)

    return RefNodeServer("127.0.0.1", port, dispatch, ref_frame.MAX_FRAME_BYTES)


def _in_process_reference(keys, config, schedule):
    """The reference's nodes over its in-process transport, driven by
    ``schedule`` (``[(node index, peer index)]``)."""
    members = [pk for pk, _ in keys]
    clock = [0]
    network, network_want = {}, {}
    transport = RefTransport(network, network_want)
    nodes = []
    for pk, sk in keys:
        node = RefNode(
            sk=sk, pk=pk, network=network, members=members,
            config=RefConfig(**dataclasses.asdict(config)),
            clock=lambda: clock[0], network_want=network_want,
            transport=transport,
        )
        network[pk] = node.ask_sync
        network_want[pk] = node.ask_events
        nodes.append(node)
    for t, (i, j) in enumerate(schedule):
        clock[0] = t + 1
        new = nodes[i].sync(members[j], b"tx:%d" % t)
        if new:
            nodes[i].consensus_pass(new)
    return nodes


def _schedule(n, turns, seed):
    rng = random.Random(seed)
    out = []
    for _ in range(turns):
        i = rng.randrange(n)
        out.append((i, rng.choice([j for j in range(n) if j != i])))
    return out


@pytest.mark.parametrize("port_index", [0, 2])
def test_mixed_population_over_sockets_matches_reference(sim_signer, port_index):
    """Member ``port_index`` is a port ``Node`` behind a port
    ``NodeServer``, calling out over a port ``SocketTransport``; the others
    are the reference's nodes, servers and transports.  Every call crosses
    between the packages in one direction or the other, and every node ends
    in the state (digest) of the reference's in-process run of the same
    schedule."""
    n, turns, seed = 3, 60, 11
    config = SwirldConfig(n_members=n, seed=seed)
    keys = [crypto.keypair(b"mixed-%d" % i) for i in range(n)]
    members = [pk for pk, _ in keys]
    schedule = _schedule(n, turns, seed)
    want = _in_process_reference(keys, config, schedule)
    ports = allocate_ports(n)
    clock = [0]
    nodes, servers, transports = [], [], []
    try:
        for i, (pk, sk) in enumerate(keys):
            port_side = i == port_index
            st = (SocketTransport if port_side else RefSocketTransport)(
                settings=resolve_net_settings(), src=pk)
            for j, pk_j in enumerate(members):
                if j != i:
                    st.register(pk_j, "127.0.0.1", ports[j])
            node_cls, cfg = (Node, config) if port_side else (
                RefNode, RefConfig(**dataclasses.asdict(config)))
            nodes.append(node_cls(
                sk=sk, pk=pk, network={}, members=members, config=cfg,
                clock=lambda: clock[0], transport=st,
            ))
            transports.append(st)
        for i, node in enumerate(nodes):
            servers.append((_serve_node if i == port_index else _ref_serve_node)(
                node, ports[i]))
        for t, (i, j) in enumerate(schedule):
            clock[0] = t + 1
            new = nodes[i].sync(members[j], b"tx:%d" % t)
            if new:
                nodes[i].consensus_pass(new)
    finally:
        for s in servers:
            s.close()
        for st in transports:
            st.close()
    assert min(len(nd.consensus) for nd in want) > 0
    for got, ref in zip(nodes, want):
        assert got.state_digest() == ref.state_digest()
    assert transports[port_index].stats["calls"] > 0
    assert all(st.stats["calls"] > 0 for st in transports)


def test_socket_transport_parity_with_reference_in_process_transport(sim_signer):
    """The port's nodes over loopback ``SocketTransport`` decide the same
    prefixes, byte for byte, as the reference's nodes over its in-process
    ``Transport`` on the same seed and schedule."""
    n, turns, seed = 3, 60, 11
    config = SwirldConfig(n_members=n, seed=seed)
    keys = [crypto.keypair(b"parity-%d" % i) for i in range(n)]
    members = [pk for pk, _ in keys]
    schedule = _schedule(n, turns, seed)
    ref_nodes = _in_process_reference(keys, config, schedule)

    ports = allocate_ports(n)
    clock = [0]
    sock_nodes, servers, transports = [], [], []
    try:
        for i, (pk, sk) in enumerate(keys):
            st = SocketTransport(settings=resolve_net_settings(), src=pk)
            for j, pk_j in enumerate(members):
                if j != i:
                    st.register(pk_j, "127.0.0.1", ports[j])
            sock_nodes.append(Node(
                sk=sk, pk=pk, network={}, members=members, config=config,
                clock=lambda: clock[0], transport=st,
            ))
            transports.append(st)
        for i, node in enumerate(sock_nodes):
            servers.append(_serve_node(node, ports[i]))
        for t, (i, j) in enumerate(schedule):
            clock[0] = t + 1
            new = sock_nodes[i].sync(members[j], b"tx:%d" % t)
            if new:
                sock_nodes[i].consensus_pass(new)
    finally:
        for s in servers:
            s.close()
        for st in transports:
            st.close()
    ref_orders = [list(nd.consensus) for nd in ref_nodes]
    assert min(len(o) for o in ref_orders) > 0
    assert [list(nd.consensus) for nd in sock_nodes] == ref_orders
    for ref, cand in zip(ref_nodes, sock_nodes):
        for eid in ref.consensus:
            assert encode_event(cand.hg[eid]) == ref_encode_event(ref.hg[eid])
    assert all(st.stats["calls"] > 0 for st in transports)
