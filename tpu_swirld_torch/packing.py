"""Dense packing: hash-addressed event DAG -> index arrays for the device
(copy of the reference's ``tpu_swirld/packing.py`` batch surface).

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
from typing import Dict, List, Optional, Sequence

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
    :meth:`pack` a snapshot."""

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

    def append(self, ev: Event) -> int:
        """Pack one event (parents must already be packed).  Idempotent."""
        eid = ev.id
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

    def pack(self) -> PackedDAG:
        n = len(self._ids)
        m = len(self.members)
        k = max(max((len(v) for v in self._by_member), default=0), 1)
        member_table = np.full((m, k), -1, dtype=np.int32)
        for ci, evs in enumerate(self._by_member):
            member_table[ci, : len(evs)] = evs
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
