"""Dense packing: hash-addressed event DAG -> index arrays for the device
(copy of the reference's ``tpu_swirld/packing.py`` batch, streaming,
live-node and membership surface).

Events are packed in topological (insertion) order into a ``(N, 2)`` int32
parent-index array plus creator / seq / timestamp / coin-bit vectors.  Every
unordered pair of distinct events by one creator at one seq becomes a
``fork_pairs`` row ``(member, idx_a, idx_b)``.  Everything here is host
numpy; hashes and signatures never reach the device.

:func:`packed_from_arrays` carries a reference ``PackedDAG``'s fields across
into the port's: the DAG and the stake are this system's state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpu_swirld_torch.event import Event


@dataclasses.dataclass
class PackedDAG:
    """Snapshot of a packed event DAG (topo order, genesis parents = -1)."""

    n: int                     # number of events
    n_members: int
    parents: np.ndarray        # int32[N, 2]; -1 for genesis
    creator: np.ndarray        # int32[N]; member index
    seq: np.ndarray            # int32[N]; self-chain height
    t: np.ndarray              # int64[N]; creation timestamps
    coin: np.ndarray           # uint8[N]; signature middle bit (coin rounds)
    stake: np.ndarray          # int32[M]
    fork_pairs: np.ndarray     # int32[G, 3]: (member, idx_a, idx_b)
    member_table: np.ndarray   # int32[M, K]: event idx per member, -1 pad
    ids: List[bytes]           # event id per index (host only)
    sigs: List[bytes]          # signature per index (host only)


class Packer:
    """Append-only packer: :meth:`append` events in topo order, then
    :meth:`pack` a snapshot, or read a delta through the read-only views
    (:meth:`window_view`, :meth:`fork_pairs_view`)."""

    def __init__(self, members: Sequence[bytes], stake: Sequence[int]):
        if len(members) != len(stake):
            raise ValueError("members and stake length mismatch")
        self.members: List[bytes] = list(members)
        self.member_index: Dict[bytes, int] = {m: i for i, m in enumerate(members)}
        self.stake = np.asarray(stake, dtype=np.int32)
        self.idx: Dict[bytes, int] = {}         # event id -> index
        self._parents: List[tuple] = []
        self._creator: List[int] = []
        self._seq: List[int] = []
        self._t: List[int] = []
        self._coin: List[int] = []
        self._ids: List[bytes] = []
        self._sigs: List[bytes] = []
        self._by_member: List[List[int]] = [[] for _ in members]
        self._by_seq: List[Dict[int, List[int]]] = [{} for _ in members]
        self._fork_pairs: List[tuple] = []

    # ---- dynamic membership (the epoch repack seam: membership.repack)

    def add_member(self, pk: bytes) -> int:
        """Append one member row (a decided JOIN) with no events and stake
        0: the member axis only ever extends, so existing event indices,
        fork pairs and every snapshot stay valid.  Returns the member's
        index (its existing one if ``pk`` is a member already)."""
        if pk in self.member_index:
            return self.member_index[pk]
        i = len(self.members)
        self.members.append(pk)
        self.member_index[pk] = i
        self._by_member.append([])
        self._by_seq.append({})
        self.stake = np.concatenate([self.stake, np.zeros((1,), np.int32)])
        return i

    def set_stake(self, stake: Sequence[int]) -> None:
        """Swap the stake vector (an epoch activation).  Its length must be
        the member count."""
        if len(stake) != len(self.members):
            raise ValueError("stake length != member count")
        self.stake = np.asarray(stake, dtype=np.int32)

    def member_table_view(self, n_members: int) -> np.ndarray:
        """The ``(n_members, k)`` int32 member table of the first
        ``n_members`` members (event indices, -1 padded), ``k`` the longest
        member row of the whole packer and at least 1: the table
        :meth:`pack` snapshots, cut to those members' rows."""
        k = max(max((len(v) for v in self._by_member), default=0), 1)
        table = np.full((n_members, k), -1, dtype=np.int32)
        for ci, evs in enumerate(self._by_member[:n_members]):
            table[ci, : len(evs)] = evs
        return table

    def append(self, ev: Event) -> int:
        """Pack one event (parents must already be packed).  Idempotent.
        An event of either package packs alike: only ``p``, ``t``, ``c``,
        ``s``, ``id`` and ``coin_bit()`` are read."""
        return self.append_prepared(ev, ev.id)

    def append_prepared(self, ev: Event, eid: bytes) -> int:
        """:meth:`append` with the event id already computed (the streaming
        driver's decode worker hashes ids off-thread with
        :func:`prepare_events`); all packer mutation stays on the calling
        thread."""
        existing = self.idx.get(eid)
        if existing is not None:
            return existing
        ci = self.member_index.get(ev.c)
        if ci is None:
            raise ValueError("unknown creator")
        i = len(self._ids)
        if ev.p:
            sp = self.idx.get(ev.p[0])
            op = self.idx.get(ev.p[1])
            if sp is None or op is None:
                raise ValueError("parent not packed (append in topo order)")
            seq = self._seq[sp] + 1
            self._parents.append((sp, op))
        else:
            seq = 0
            self._parents.append((-1, -1))
        self.idx[eid] = i
        self._creator.append(ci)
        self._seq.append(seq)
        self._t.append(int(ev.t))
        self._coin.append(ev.coin_bit() & 1)
        self._ids.append(eid)
        self._sigs.append(ev.s)
        self._by_member[ci].append(i)
        group = self._by_seq[ci].setdefault(seq, [])
        for other in group:            # every prior same-(creator, seq) event
            self._fork_pairs.append((ci, other, i))
        group.append(i)
        return i

    def extend(self, events: Sequence[Event]) -> List[int]:
        return [self.append(ev) for ev in events]

    def extend_prepared(self, pairs: Sequence[Tuple[Event, bytes]]) -> List[int]:
        """Pack a pre-decoded delta: ``pairs`` as :func:`prepare_events`
        returns them."""
        return [self.append_prepared(ev, eid) for ev, eid in pairs]

    def __len__(self) -> int:
        return len(self._ids)

    # ---- bounded read-only views (the incremental driver's surface)

    def window_view(self, start: int, stop: Optional[int] = None):
        """Read-only ``(parents, creator, coin, t)`` arrays for the packed
        events [start, stop): an ingest delta."""
        stop = len(self._ids) if stop is None else stop
        return (
            _ro(np.asarray(self._parents[start:stop], dtype=np.int32).reshape(-1, 2)),
            _ro(np.asarray(self._creator[start:stop], dtype=np.int32)),
            _ro(np.asarray(self._coin[start:stop], dtype=np.uint8)),
            _ro(np.asarray(self._t[start:stop], dtype=np.int64)),
        )

    @property
    def n_fork_pairs(self) -> int:
        return len(self._fork_pairs)

    def fork_pairs_view(self, start: int = 0) -> np.ndarray:
        """Read-only fork-pair rows [start, n_fork_pairs)."""
        return _ro(np.asarray(self._fork_pairs[start:], dtype=np.int32).reshape(-1, 3))

    def sig(self, i: int) -> bytes:
        return self._sigs[i]

    def event_id(self, i: int) -> bytes:
        return self._ids[i]

    def pack(self) -> PackedDAG:
        n = len(self._ids)
        m = len(self.members)
        member_table = self.member_table_view(m)
        return PackedDAG(
            n=n,
            n_members=m,
            parents=np.asarray(self._parents, dtype=np.int32).reshape(n, 2),
            creator=np.asarray(self._creator, dtype=np.int32),
            seq=np.asarray(self._seq, dtype=np.int32),
            t=np.asarray(self._t, dtype=np.int64),
            coin=np.asarray(self._coin, dtype=np.uint8),
            stake=self.stake.copy(),
            fork_pairs=np.asarray(self._fork_pairs, dtype=np.int32).reshape(-1, 3),
            member_table=member_table,
            ids=list(self._ids),
            sigs=list(self._sigs),
        )


def _ro(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False
    return a


def chunk_slices(n: int, chunk: int) -> List[Tuple[int, int]]:
    """Chunk-aligned ``[start, stop)`` slices covering ``[0, n)``: every
    piece but the last is exactly ``chunk`` long.  Any split of a
    topologically ordered stream is itself topologically valid, so the
    slices can be ingested independently."""
    if chunk <= 0:
        raise ValueError("chunk must be positive")
    return [(s, min(n, s + chunk)) for s in range(0, n, chunk)]


def prepare_events(events: Sequence[Event]) -> List[Tuple[Event, bytes]]:
    """Gossip decode of a delta: each event with its id (a content hash,
    the dominant host cost of packing), touching no shared state, so it can
    run on a worker thread; :meth:`Packer.extend_prepared` packs the
    result."""
    return [(ev, ev.id) for ev in events]


def pack_events(
    events: Sequence[Event],
    members: Sequence[bytes],
    stake: Optional[Sequence[int]] = None,
) -> PackedDAG:
    """Pack a topologically ordered event sequence in one shot."""
    if stake is None:
        stake = [1] * len(members)
    p = Packer(members, stake)
    p.extend(events)
    return p.pack()


def pack_node(node) -> PackedDAG:
    """Pack a ``Node``'s full DAG in its insertion (topo) order, the order
    its own consensus state was built in.  Takes a node of either package
    (only its ``hg`` / ``order_added`` / ``members`` / ``stake`` are read)."""
    events = [node.hg[eid] for eid in node.order_added]
    stake = [node.stake[m] for m in node.members]
    return pack_events(events, node.members, stake)


def packed_from_arrays(n_members, parents, creator, seq, t, coin, stake,
                       fork_pairs, member_table, ids, sigs) -> PackedDAG:
    """A port ``PackedDAG`` from another packer's fields (numpy arrays and
    byte lists), with the dtypes and shapes this package's pipeline reads."""
    parents = np.ascontiguousarray(parents, dtype=np.int32).reshape(-1, 2)
    n = parents.shape[0]
    return PackedDAG(
        n=n,
        n_members=int(n_members),
        parents=parents,
        creator=np.ascontiguousarray(creator, dtype=np.int32),
        seq=np.ascontiguousarray(seq, dtype=np.int32),
        t=np.ascontiguousarray(t, dtype=np.int64),
        coin=np.ascontiguousarray(coin, dtype=np.uint8),
        stake=np.ascontiguousarray(stake, dtype=np.int32),
        fork_pairs=np.ascontiguousarray(fork_pairs, dtype=np.int32).reshape(-1, 3),
        member_table=np.ascontiguousarray(member_table, dtype=np.int32),
        ids=[bytes(x) for x in ids],
        sigs=[bytes(x) for x in sigs],
    )
