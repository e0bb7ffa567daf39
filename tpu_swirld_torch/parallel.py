"""Sharding over a mesh (counterpart of the reference's
``tpu_swirld/parallel.py``), both halves, on meshes whose shards share one
device.

**Batch path (member axis).**  :func:`ssm_matrix_sharded` splits the
strongly-sees matrix over the member axis: shard ``s`` owns the member-table
rows ``[s M / D, (s + 1) M / D)`` (padded to a mesh multiple by
:func:`pad_members`: -1 rows, 0 stake) and computes its members' int32 stake
tally over every pair of events in one
:func:`~tpu_swirld_torch.gpu.kernels.ssm_tally` launch; the tallies are
summed over the shards and the strict-2/3 test runs once.
:func:`make_ssm_block_fn_for_mesh` is the same split on the ``ssm_block_fn``
seam, :func:`consensus_fn_for_mesh` the fused ``consensus_body`` over the
sharded matrix, which ``run_consensus(mesh=)`` and a ``mesh_shape`` node
run.

**Streaming path (window axis).**  :class:`MeshStreamingConsensus`
row-shards the resident window: the ``anc`` / ``sees`` / ``ssm`` slabs are
read as ``D`` contiguous ranges of ``W / D`` rows, and
:func:`make_row_sharded_block_fn` runs every strongly-sees block with one
halo exchange, exactly as the reference's ``shard_map`` body does:

- b side (the halo): of the ``M * K`` gathered member rows each lies in one
  shard; every shard gathers the rows it owns (others zero) and one int8
  sum over the shards assembles the full ``(M * K, C)`` operand;
- a side: each shard gathers the extension rows it owns, unowned rows zero,
  and its shard-tally step sums ``stake[m]`` times each member's boolean hop
  into an int32 partial tally (``M`` hops through ``bmm``, or one
  :func:`~tpu_swirld_torch.gpu.kernels.ssm_tally` launch on the
  ``pallas=True`` route); the tallies are summed over the shards and the
  strict-2/3 test runs once.

JAX's mesh is single-controller (one driver, arrays carrying a sharding).
The port has two meshes.  :class:`Mesh` keeps that shape in one process:
its shards all live on **one** device, the slabs stay one tensor there, so
their placement cannot drift, and every sum over the shards is a plain sum.
:class:`GroupMesh` is one process per shard, joined in a
``torch.distributed`` group (:func:`init_group`): shard ``s`` is rank
``s``, on that rank's own device, and holds only its own member rows (the
batch path) or its own ``W / D`` window rows (the row-sharded block).
Every sum over the shards goes through :func:`_psum`, a plain sum of the
local parts on a :class:`Mesh` and one ``all_reduce`` on a
:class:`GroupMesh` (int8 for the halo, int32 for the tallies, as the
reference's ``lax.psum``).  The batch paths, the row-sharded block and
:class:`MeshStreamingConsensus` run on either mesh; over a group the
streaming driver is :class:`GroupStreamingConsensus`, whose stages read
and write the rows another rank owns through a :class:`RowGather` view
(:func:`gather_rows`, :func:`owner_write`) and move rows across shards
with :func:`reshard_rows`; its full rebase runs the batch pass over the
rank's own rows of the DAG's slabs (:class:`BatchShards`,
:func:`group_visibility_stage`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from datetime import timedelta
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpu_swirld_torch import obs
from tpu_swirld_torch.device import resolve_device, to_host
from tpu_swirld_torch.gpu import kernels
from tpu_swirld_torch.store.archive import SlabArchive
from tpu_swirld_torch.store.slab import SlabStore
from tpu_swirld_torch.store.streaming import StreamingConsensus

MEMBER_AXIS = "members"


def _canonical(dev) -> torch.device:
    """A device with its index filled in (``cuda`` means the current card),
    so that two names of one device compare equal."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices[s]`` holds shard ``s`` along ``axis_name`` (a
    member shard on the batch path, a row shard of the streaming window).

    Every shard must live on one device (see the module doc); a mesh over
    several devices raises ``ValueError``: shards on several cards are a
    :class:`GroupMesh`, one process a card."""

    devices: Tuple[torch.device, ...]
    axis_name: str = MEMBER_AXIS

    def __post_init__(self):
        devs = tuple(_canonical(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one shard")
        if len(set(devs)) > 1:
            raise ValueError(
                f"a mesh over several devices ({sorted(map(str, set(devs)))}) "
                "in one process is not ported: shards on several cards are a "
                "GroupMesh, one process a card (init_group; ROADMAP A8)"
            )
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis_name,)

    @property
    def device(self) -> torch.device:
        """The one device every shard lives on."""
        return self.devices[0]

    @property
    def local_shards(self) -> Tuple[int, ...]:
        """The shards this process computes: all of them."""
        return tuple(range(self.size))

    def __str__(self) -> str:
        return f"{self.size} shards on one device ({self.device})"


def make_mesh(n_shards: int = 1, device="cuda") -> Mesh:
    """A 1-D mesh of ``n_shards`` shards, all on ``device`` (default
    ``"cuda"``, which raises without a GPU)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return Mesh((resolve_device(device),) * int(n_shards))


BACKENDS = ("gloo", "nccl")


#: the stage of a collective run outside every driver stage (a growth's
#: or a prune's row moves between stages, a rebase, a widening)
BETWEEN_STAGES = "between stages"


def _stage_record() -> Dict[str, int]:
    return {"calls": 0, "bytes": 0, "stage_calls": 0, "peak_call_bytes": 0}


@dataclasses.dataclass
class Traffic:
    """What a rank handed to its group's collectives: calls and payload
    bytes (each call's tensor once; of an all-to-all, the blocks it sends
    the other ranks), in all and by the driver stage that ran them.

    ``by_stage[stage]`` counts the collectives (``calls``, ``bytes``), the
    stage's calls (``stage_calls``) and the most bytes one of them handed
    (``peak_call_bytes``).  A driver runs each stage inside
    :meth:`during` (``StageClock.scope``); a collective outside every
    stage counts under :data:`BETWEEN_STAGES`."""

    calls: int = 0
    bytes: int = 0
    by_stage: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)
    stage: str = BETWEEN_STAGES

    def add(self, t: torch.Tensor, nbytes: Optional[int] = None) -> None:
        """One collective handed ``t`` (``nbytes`` of it, when given)."""
        nbytes = t.numel() * t.element_size() if nbytes is None else int(nbytes)
        self.calls += 1
        self.bytes += nbytes
        rec = self.by_stage.setdefault(self.stage, _stage_record())
        rec["calls"] += 1
        rec["bytes"] += nbytes

    @contextlib.contextmanager
    def during(self, stage: str):
        """Count the collectives run inside as ``stage``'s, one call of it."""
        prev, sent = self.stage, self.bytes
        self.stage = stage
        try:
            yield
        finally:
            self.stage = prev
            rec = self.by_stage.setdefault(stage, _stage_record())
            rec["stage_calls"] += 1
            rec["peak_call_bytes"] = max(rec["peak_call_bytes"], self.bytes - sent)

    def take_stages(self) -> Dict[str, Dict[str, int]]:
        """``by_stage`` since the last take; counting starts afresh."""
        out, self.by_stage = self.by_stage, {}
        return out


def stage_totals(records) -> Dict[str, Dict[str, int]]:
    """Several :attr:`Traffic.by_stage` records (a pass's ``group_stages``
    each) as one: counts summed, ``peak_call_bytes`` the most of any."""
    out: Dict[str, Dict[str, int]] = {}
    for by_stage in records:
        for stage, rec in by_stage.items():
            tot = out.setdefault(stage, _stage_record())
            for k, v in rec.items():
                tot[k] = max(tot[k], v) if k == "peak_call_bytes" else tot[k] + v
    return out


@dataclasses.dataclass(frozen=True)
class GroupMesh:
    """A 1-D mesh of one shard a process: this process is rank ``rank`` of
    a ``torch.distributed`` group of ``size`` ranks (``group``, ``None``
    for the default group) and computes shard ``rank`` on ``device``, its
    own card (or the CPU).  The same collectives on every rank: a rank
    that stops calling them stalls the others.  Built by
    :func:`init_group` or :func:`make_group_mesh`."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: Optional[object] = None
    axis_name: str = MEMBER_AXIS
    traffic: Traffic = dataclasses.field(default_factory=Traffic, compare=False)

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis_name,)

    @property
    def local_shards(self) -> Tuple[int, ...]:
        """The shards this process computes: its own."""
        return (self.rank,)

    def __str__(self) -> str:
        return (f"rank {self.rank} of a {self.size}-rank {self.backend} group "
                f"on {self.device}")


def _group_device(rank: int, device) -> torch.device:
    """``device``, or the rank's own card ``cuda:{rank}`` when ``None``;
    raises without a GPU, or when the card does not exist."""
    dev = _canonical(resolve_device(f"cuda:{rank}" if device is None else device))
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise ValueError(
            f"rank {rank} asks for {dev}, and this host has "
            f"{torch.cuda.device_count()} card(s)"
        )
    return dev


def make_group_mesh(n_shards: int, *, device=None, group=None) -> GroupMesh:
    """The :class:`GroupMesh` of this process in an initialized process
    group (``group``, default the default group) of exactly ``n_shards``
    ranks (another world size raises ``ValueError``).  ``device`` defaults
    to the rank's own card ``cuda:{rank}`` (ranks on one host: the rank
    is the local rank); ``"cpu"`` only when the caller asks for it."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group is initialized: call init_group first")
    world = dist.get_world_size(group)
    if world != n_shards:
        raise ValueError(
            f"a mesh of {n_shards} shards over a group of {world} ranks: "
            "one rank a shard"
        )
    rank = dist.get_rank(group)
    backend = str(dist.get_backend(group))
    dev = _group_device(rank, device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an nccl group needs a card a rank, rank {rank} is on {dev}")
    return GroupMesh(rank, world, dev, backend, group)


def init_group(rank: int, world: int, store_path, *, backend: str, device=None,
               timeout: Optional[float] = None) -> GroupMesh:
    """Join rank ``rank`` of a ``world``-rank default process group through
    the file store ``store_path`` (a file no other group uses; no TCP port,
    so groups started side by side cannot collide), and return its
    :class:`GroupMesh` of ``world`` shards.

    ``backend`` is the caller's: ``"nccl"`` when each rank has a card of
    its own, ``"gloo"`` on the CPU or when ranks share a card (gloo's
    ``all_reduce`` takes CUDA tensors).  ``device`` as in
    :func:`make_group_mesh`; it is resolved before the group is joined, so
    ``"cuda"`` without a GPU raises at once.  ``timeout`` (seconds) bounds
    each collective."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a group of {world}")
    dev = _group_device(rank, device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an nccl group needs a card a rank, rank {rank} is on {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=Path(store_path).resolve().as_uri(), rank=rank,
        world_size=world,
        **({"timeout": timedelta(seconds=timeout)} if timeout is not None else {}),
    )
    return make_group_mesh(world, device=dev)


# Kernel caches keyed on the mesh's physical identity (devices, shape, axis
# name), never on the Mesh object; bounded FIFO.
_MESH_CACHE_MAX = 8


def _mesh_key(mesh: Mesh):
    return (
        tuple(str(d) for d in mesh.devices),
        (mesh.size,),
        tuple(mesh.axis_names),
    )


def _mesh_cache_get(cache: dict, mesh, build):
    if isinstance(mesh, GroupMesh):
        return build()      # its collectives count into this mesh's traffic
    key = _mesh_key(mesh)
    fn = cache.get(key)
    if fn is None:
        fn = build()
        cache[key] = fn
        while len(cache) > _MESH_CACHE_MAX:
            cache.pop(next(iter(cache)))
    return fn


_mesh_block_fns = {}
_mesh_row_block_fns = {}
_mesh_fns = {}


def _psum(mesh, parts):
    """The sum over the mesh's shards of each shard's partial tensor (the
    reference's ``lax.psum``), ``parts`` being this process's shards' (its
    ``local_shards``, in order).  On a :class:`Mesh` every shard is local,
    so it is a plain sum; on a :class:`GroupMesh` the rank's one part is
    summed over the group by one ``all_reduce``, in its dtype."""
    total = functools.reduce(torch.add, parts)
    if isinstance(mesh, GroupMesh):
        mesh.traffic.add(total)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.group)
    return total


# ---------------------------------------------- row-sharded slabs in a group
#
# On a GroupMesh each rank holds rows [rank * n_loc, (rank + 1) * n_loc) of
# a (W, cols) bool slab.  A read of rows another rank owns is one gather
# (every rank puts the rows it owns, others zero, and one int8 sum assembles
# them everywhere); a write of a block every rank computed keeps the rows
# the rank owns; a move of rows across shard boundaries (a prune's shift, a
# growth's new shard size) is one sum of the rows that change owner.


def gather_rows(mesh: GroupMesh, shard, idx):
    """Rows ``idx`` (int64, every index in ``[0, W)``) of a row-sharded
    bool slab, bool ``(len(idx), cols)`` on every rank."""
    n_loc = shard.shape[0]
    loc = idx - mesh.rank * n_loc
    own = (loc >= 0) & (loc < n_loc)
    part = (shard[loc.clamp(0, n_loc - 1)] & own[:, None]).to(torch.int8)
    return _psum(mesh, [part]) > 0


def gather_cells(mesh: GroupMesh, shard, rows, cols):
    """Cells of a row-sharded bool slab, bool ``(R, S, S)`` on every rank:
    ``out[r, p, y] = slab[rows[r, y], cols[r, p]]`` for int64 ``rows`` and
    ``cols`` of shape ``(R, S)`` (every row in ``[0, W)``, every column in
    the slab).  One gather of the cells alone, not of their rows."""
    n_loc = shard.shape[0]
    loc = rows - mesh.rank * n_loc
    own = (loc >= 0) & (loc < n_loc)
    part = shard[loc.clamp(0, n_loc - 1)[:, None, :], cols[:, :, None]] & own[:, None, :]
    return _psum(mesh, [part.to(torch.int8)]) > 0


def exchange_columns(mesh: GroupMesh, shard, pieces: int = 1):
    """This rank's columns of every row of a row-sharded square bool slab
    of ``W = D n_loc`` rows, bool ``(W, n_loc)``: rank ``r`` gets columns
    ``[r n_loc, (r + 1) n_loc)``, the events it owns.  One all-to-all of
    ``(n_loc, n_loc)`` blocks: each rank sends every other rank that
    rank's columns of its own rows, ``(D - 1) n_loc^2`` bytes, and keeps
    its own block.  ``pieces > 1`` sends the blocks' columns in that many
    all-to-alls (the same bytes), so that the buffers beside the output
    are ``2 W n_loc / pieces`` bytes, not ``2 W n_loc``."""
    n_loc, w = shard.shape
    d = mesh.size
    if w != d * n_loc:
        raise ValueError(f"a column exchange of a ({n_loc}, {w}) row shard over "
                         f"{d} ranks: the slab must be square")
    blocks = shard.reshape(n_loc, d, n_loc)
    step = -(-n_loc // max(1, pieces))
    out = None
    for c in range(0, n_loc, step):
        send = blocks[:, :, c : c + step].transpose(0, 1).contiguous()
        recv = torch.empty_like(send)
        mesh.traffic.add(send, nbytes=(d - 1) * n_loc * send.shape[2])
        dist.all_to_all_single(recv.view(torch.uint8), send.view(torch.uint8),
                               group=mesh.group)
        if step == n_loc:           # one piece: it is the output
            return recv.reshape(w, n_loc)
        if out is None:
            out = torch.empty((d, n_loc, n_loc), dtype=torch.bool, device=shard.device)
        out[:, :, c : c + step] = recv
        del send, recv
    return out.reshape(w, n_loc)


def join_columns(mesh: GroupMesh, part):
    """Every rank's int32 ``(k, n_loc)`` part, its own columns of a ``(k,
    D n_loc)`` table, joined on every rank: one sum of the rank's part in
    its columns, zeros elsewhere."""
    k, n_loc = part.shape
    whole = part.new_zeros((k, mesh.size * n_loc))
    whole[:, mesh.rank * n_loc : (mesh.rank + 1) * n_loc] = part
    return _psum(mesh, [whole])


def owner_write(mesh: GroupMesh, shard, row0: int, block, col0: int = 0):
    """Write ``block`` (every rank's same values) at global rows ``[row0,
    row0 + len(block))`` and columns from ``col0``: the rows this rank
    owns, in place.  Returns ``shard``."""
    n_loc = shard.shape[0]
    lo = mesh.rank * n_loc
    a, b = max(row0, lo), min(row0 + block.shape[0], lo + n_loc)
    if a < b:
        shard[a - lo : b - lo, col0 : col0 + block.shape[1]] = block[a - row0 : b - row0]
    return shard


def row_crossings(d: int, n_loc: int, n_rows: int, n_loc_new: int, shift: int = 0):
    """The rows that change owner when the ``n_rows``-row slab sharded in
    ``n_loc`` rows a rank over ``d`` ranks is resharded in ``n_loc_new``
    rows a rank, new row ``i`` being old row ``i + shift``
    (:func:`reshard_rows`): ``[(t, a, b)]``, old rows ``[a, b)`` that rank
    ``t`` takes from another rank.  Only rows of the old slab, ``[0,
    n_rows)``, are listed; every rank lists the same from the shapes."""
    out = []
    for t in range(d):
        g0 = t * n_loc_new + shift
        g1 = max(g0, min(g0 + n_loc_new, n_rows))
        g0 = max(g0, 0)
        for a, b in ((g0, min(g1, t * n_loc)), (max(g0, (t + 1) * n_loc), g1)):
            if a < b:
                out.append((t, a, b))
    return out


def reshard_rows(mesh: GroupMesh, shard, n_rows: int, n_loc_new: int, shift: int = 0,
                 *, cols: Optional[int] = None, col0: int = 0,
                 piece_rows: Optional[int] = None, record=None):
    """This rank's ``n_loc_new`` rows of the slab whose global row ``i`` is
    row ``i + shift`` of the ``n_rows``-row slab sharded as ``shard`` (zero
    past its end, and before its start): a prune's shift, a growth's new
    shard size, a rebase's lift of a batch shard into the window, a
    widening's move of the retained rows ``-shift`` rows down (a negative
    shift: the first ``-shift`` rows come out zero, and no sum carries
    them).  A rank keeps the rows it already owns; only the rows that
    change owner cross (:func:`row_crossings`), all in one sum (every rank
    lists the same crossings, from the shapes alone), so a prune of ``d``
    rows moves about ``d`` rows a shard boundary.  The shard's columns
    land at ``[col0, col0 + width)`` of ``cols`` columns (default ``col0 +
    width``; the rest zeros); ``piece_rows`` splits the sum so that none
    carries more rows; ``record``, if given, is called with the row count
    of every slab allocated here.  ``shard`` may be a view (some columns
    of a shard)."""
    n_loc, width = shard.shape
    cols = col0 + width if cols is None else cols
    c1 = col0 + width
    lo = mesh.rank * n_loc
    record = record or (lambda rows: None)
    crossing = row_crossings(mesh.size, n_loc, n_rows, n_loc_new, shift)
    g0 = mesh.rank * n_loc_new + shift      # this rank's first row, in old rows
    g1 = max(g0, min(g0 + n_loc_new, n_rows))
    mine = torch.zeros((n_loc_new, cols), dtype=torch.bool, device=shard.device)
    record(n_loc_new)
    a, b = max(g0, lo), min(g1, lo + n_loc)
    if a < b:
        mine[a - g0 : b - g0, col0:c1] = shard[a - lo : b - lo]
    if piece_rows is not None:      # no crossing longer than a piece
        crossing = [(t, x, min(x + piece_rows, b)) for t, a, b in crossing
                    for x in range(a, b, piece_rows)]
    sums, rows = [[]], 0
    for c in crossing:
        if sums[-1] and piece_rows is not None and rows + c[2] - c[1] > piece_rows:
            sums.append([])
            rows = 0
        sums[-1].append(c)
        rows += c[2] - c[1]
    for part in sums:
        if not part:
            continue
        buf = torch.zeros((sum(b - a for _, a, b in part), width), dtype=torch.int8,
                          device=shard.device)
        record(buf.shape[0])
        off = 0
        for _t, a, b in part:
            x, y = max(a, lo), min(b, lo + n_loc)
            if x < y:       # rows of this crossing that this rank owns
                buf[off + x - a : off + y - a] = shard[x - lo : y - lo]
            off += b - a
        _psum(mesh, [buf])
        off = 0
        for t, a, b in part:
            if t == mesh.rank:
                mine[a - g0 : b - g0, col0:c1] = buf[off : off + b - a] > 0
            off += b - a
        del buf
    return mine


class RowGather:
    """A row-sharded slab seen by global row, so that a stage written
    against the whole slab (the visibility extension, the column store's
    block writes, ``rounds_chunk_stage``, ``fame_scan``, ``order_scan``)
    runs over a rank's shard unchanged: ``shape`` and ``device`` are the
    whole slab's.  A read gathers its rows on every rank
    (:func:`gather_rows`): ``g[idx]`` (an index tensor), and ``g[a:b]`` or
    ``g[i]`` (an int) from the rows ``prefetch`` (``(start, stop)``)
    gathered at once when they hold them, else one gather;
    ``g.cells(rows, cols)`` gathers single cells (:func:`gather_cells`);
    ``g.own_columns()`` exchanges columns, so that a rank holds its own
    events' columns of every row (:func:`exchange_columns`, in ``pieces``
    all-to-alls), and
    ``g.join_columns(part)`` puts every rank's values of its events
    together (:func:`join_columns`).  A write ``g[a:b] = block`` or
    ``g[a:b, c:d] = block`` (every rank's same values) lands in the rows
    this rank owns, in place
    (:func:`owner_write`).  Every rank must read and write the same rows in
    the same order, as every rank runs the same stage."""

    def __init__(self, mesh: GroupMesh, shard, n_rows: int, prefetch=None,
                 pieces: int = 1):
        self.mesh, self.shard, self.pieces = mesh, shard, pieces
        self.shape = (n_rows, shard.shape[1])
        self.device = shard.device
        self._lo, self._rows = 0, None
        if prefetch is not None:
            start, stop = prefetch
            self._lo = start
            self._rows = gather_rows(mesh, shard, torch.arange(
                start, min(stop, n_rows), dtype=torch.int64, device=shard.device))

    def _span(self, rows: slice) -> Tuple[int, int]:
        start, stop, step = rows.indices(self.shape[0])
        if step != 1:
            raise TypeError(f"a row view takes unit-step slices, not {rows}")
        return start, max(start, stop)

    def __getitem__(self, idx):
        if isinstance(idx, int):
            if self._rows is not None and 0 <= idx - self._lo < self._rows.shape[0]:
                return self._rows[idx - self._lo]
            idx = torch.tensor([idx], dtype=torch.int64, device=self.device)
            return gather_rows(self.mesh, self.shard, idx)[0]
        if isinstance(idx, slice):
            start, stop = self._span(idx)
            lo = start - self._lo
            if self._rows is not None and 0 <= lo and stop - self._lo <= self._rows.shape[0]:
                return self._rows[lo : stop - self._lo]
            idx = torch.arange(start, stop, dtype=torch.int64, device=self.device)
        if not isinstance(idx, torch.Tensor):
            raise TypeError(f"a row view reads rows by int, slice or tensor, not {idx!r}")
        got = gather_rows(self.mesh, self.shard, idx.reshape(-1).to(torch.int64))
        return got.reshape(*idx.shape, self.shape[1])

    def cells(self, rows, cols):
        """``out[r, p, y] = slab[rows[r, y], cols[r, p]]``, bool ``(R, S,
        S)``: one gather of the cells alone (:func:`gather_cells`)."""
        return gather_cells(self.mesh, self.shard, rows, cols)

    def own_columns(self):
        """``(slab, (x0, x1))``: the columns of this rank's own events
        ``[x0, x1)`` of every row, bool ``(W, x1 - x0)``
        (:func:`exchange_columns` in the view's ``pieces``; the slab must be
        square)."""
        n_loc = self.shard.shape[0]
        x0 = self.mesh.rank * n_loc
        return (exchange_columns(self.mesh, self.shard, self.pieces),
                (x0, x0 + n_loc))

    def join_columns(self, part):
        """The int32 ``(k, x1 - x0)`` values of every rank's own events,
        ``(k, W)`` on every rank (:func:`join_columns`)."""
        return join_columns(self.mesh, part)

    def __setitem__(self, idx, block):
        rows, cols = idx if isinstance(idx, tuple) else (idx, slice(None))
        if not isinstance(rows, slice) or not isinstance(cols, slice):
            raise TypeError(f"a row view writes a block of slices, not {idx!r}")
        r0, r1 = self._span(rows)
        c0, c1, step = cols.indices(self.shape[1])
        if step != 1 or tuple(block.shape) != (r1 - r0, max(c0, c1) - c0):
            raise ValueError(f"a block of shape {tuple(block.shape)} for {idx!r}")
        owner_write(self.mesh, self.shard, r0, block, c0)


def group_prune_stage(mesh, anc, sees, ssm_c, d, n_used, keep_cols, *, n, has_forks):
    """:func:`~tpu_swirld_torch.gpu.incremental.prune_stage` (or
    ``prune_noforks_stage``) on row shards of an ``n``-row window: columns
    shift (and the witness columns gather) on each rank, then rows move
    ``d`` down across the shards."""
    n_loc = anc.shape[0]
    dev = anc.device
    live_cols = torch.arange(n, dtype=torch.int64, device=dev) < (n_used - d)
    live_rows = (torch.arange(n_loc, dtype=torch.int64, device=dev)
                 + mesh.rank * n_loc) < (n_used - d)

    def shift(slab):
        rolled = torch.roll(slab, -d, dims=1) & live_cols[None, :]
        return reshard_rows(mesh, rolled, n, n_loc, shift=d) & live_rows[:, None]

    kc = keep_cols.clamp(0, ssm_c.shape[1] - 1)
    ssm_c = reshard_rows(mesh, ssm_c[:, kc] & (keep_cols >= 0)[None, :], n, n_loc,
                         shift=d) & live_rows[:, None]
    anc = shift(anc)
    return anc, (shift(sees) if has_forks else anc), ssm_c


# ------------------------------------------- a group rank's batch rebase
#
# A full rebase runs the batch columns pass over the whole DAG.  On a group
# rank it computes only its own rows of the DAG's slabs (its N / D rows of
# ancestry and sees, of the column store), the stages reading other ranks'
# rows through RowGather views, and the lift and the spill move rows by
# owner: no rank allocates a slab of the DAG's N rows or the window's W.


def crossing_rows(parents: np.ndarray, d: int):
    """``[X_0, ..., X_{d-1}]``: ``X_t`` the rows (ascending int64) of rank
    ``t``'s range, of ``N / d`` rows each, that are parents of events of
    later ranks, for the ``(N, 2)`` host ``parents`` (-1 none) in
    topological order.  Every rank lists the same rows from ``parents``."""
    n = parents.shape[0]
    n_loc = n // d
    par = np.asarray(parents, dtype=np.int64)
    child = (np.arange(n, dtype=np.int64) // n_loc)[:, None]
    cross = (par >= 0) & (par // n_loc < child)
    rows = np.unique(par[cross])
    return [rows[(rows >= t * n_loc) & (rows < (t + 1) * n_loc)] for t in range(d)]


def _global_rank(mesh: GroupMesh, t: int) -> int:
    return t if mesh.group is None else dist.get_global_rank(mesh.group, t)


@dataclasses.dataclass(frozen=True)
class CrossingPlan:
    """What a group rank's sharded visibility hands and reads, listed on
    the host from ``parents`` alone (every rank lists the same):
    ``sizes[t]`` is ``|X_t|`` (:func:`crossing_rows`); ``send`` this
    rank's crossing rows as local rows (int64); ``keep[t]``, for each
    earlier rank ``t``, the rows of ``X_t`` that this rank's events name as
    parents, ``(positions in X_t, rows of ext)``, and ``ext_pos`` each
    global row's row of ``ext`` (0, a zero row, for none)."""

    sizes: Tuple[int, ...]
    send: np.ndarray
    keep: Dict[int, Tuple[np.ndarray, np.ndarray]]
    ext_pos: np.ndarray
    n_ext: int

    @classmethod
    def of(cls, parents: np.ndarray, d: int, rank: int) -> "CrossingPlan":
        n = parents.shape[0]
        n_loc = n // d
        lo = rank * n_loc
        xs = crossing_rows(parents, d)
        own = np.asarray(parents[lo : lo + n_loc], dtype=np.int64)
        need = np.unique(own[(own >= 0) & (own < lo)])
        ext_pos = np.zeros((n,), np.int64)
        ext_pos[need] = np.arange(1, need.shape[0] + 1, dtype=np.int64)
        keep = {}
        for t in range(rank):
            hit = np.flatnonzero(np.isin(xs[t], need))
            if hit.size:
                keep[t] = (hit, ext_pos[xs[t][hit]])
        return cls(tuple(int(x.shape[0]) for x in xs), xs[rank] - lo, keep, ext_pos,
                   int(need.shape[0]))

    @property
    def crossing(self) -> int:
        """``sum_t |X_t|``."""
        return sum(self.sizes)


def group_visibility_stage(mesh: GroupMesh, plan: CrossingPlan, parents, creator,
                           fork_pairs, *, n_members: int, block: int, record=None):
    """This rank's rows of ``(anc, sees)`` over the whole packed DAG, bool
    ``(N / D, N)`` each (``sees`` is ``anc`` itself with no fork pair): the
    rows of :func:`~tpu_swirld_torch.gpu.pipeline.visibility_stage`.

    ``N`` is a multiple of ``D * block``.  Rows are in topological order,
    so a rank's events have parents in its own range or in earlier ranks'.
    In rank order, rank ``t`` computes its blocks with ``ancestry``'s
    per-block closure (:class:`~tpu_swirld_torch.gpu.pipeline.
    BlockClosure`), reading external parents from its own rows or from the
    crossing rows it was handed, then one broadcast hands its crossing rows
    ``X_t`` to the other ranks (``plan``, :class:`CrossingPlan`): a rank
    hands the stage ``sum_t |X_t| N`` bytes.  The fork hop and the
    fork-aware sees run on the rank's rows alone.  ``record``, if given, is
    called with the row count of every slab allocated here."""
    from tpu_swirld_torch.gpu.pipeline import BlockClosure, forkseen_matrix

    record = record or (lambda rows: None)
    n = parents.shape[0]
    d = mesh.size
    n_loc = n // d
    if n_loc * d != n or n_loc % block:
        raise ValueError(f"{n} events do not split into {d} shards of whole "
                         f"{block}-event blocks")
    dev = parents.device
    lo = mesh.rank * n_loc
    # the crossing rows this rank reads, at 1..; row 0 of ext is zeros
    ext_pos = torch.as_tensor(plan.ext_pos, device=dev)
    ext = torch.zeros((plan.n_ext + 1, n), dtype=torch.bool, device=dev)
    anc = torch.zeros((n_loc, n), dtype=torch.bool, device=dev)
    record(ext.shape[0])
    record(n_loc)
    closure = BlockClosure(block, dev)

    def read(idx):
        own = (idx >= lo)[:, None]
        return torch.where(own, anc[(idx - lo).clamp(0, n_loc - 1)], ext[ext_pos[idx]])

    for t in range(d):
        if t == mesh.rank:
            for s in range(lo, lo + n_loc, block):
                anc[s - lo : s - lo + block] = closure.rows(parents[s : s + block], s, n, read)
        if not plan.sizes[t]:
            continue
        if t == mesh.rank:
            rows = anc[torch.as_tensor(plan.send, device=dev)]
        else:
            rows = torch.empty((plan.sizes[t], n), dtype=torch.bool, device=dev)
        record(rows.shape[0])
        mesh.traffic.add(rows)
        dist.broadcast(rows.view(torch.uint8), src=_global_rank(mesh, t), group=mesh.group)
        if t in plan.keep:
            at, to = (torch.as_tensor(a, device=dev) for a in plan.keep[t])
            ext[to] = rows[at]
        del rows
    del ext
    if fork_pairs.shape[0] == 0:
        return anc, anc
    # sees = anc & ~forkseen[:, creator], in place on the rank's rows
    sees = forkseen_matrix(anc, fork_pairs, n_members)[:, creator]
    record(sees.shape[0])
    torch.logical_not(sees, out=sees)
    sees &= anc
    return anc, sees


class BatchShards:
    """A group rank's seam of the batch columns pass
    (:func:`~tpu_swirld_torch.gpu.pipeline._columns_pass`'s ``shards``):
    the events padded to a multiple of ``D * block`` (parentless rows, which
    change no output), the rank's ``N / D`` rows of each slab
    (:meth:`zeros`), the sharded visibility stage (:meth:`visibility`, as
    ``pipeline.visibility_stage``) and row views of the shards
    (:meth:`view`; order's column exchange in :attr:`EXCHANGE_PIECES`
    all-to-alls).  :attr:`record` keeps the pass's ``n_pad``, the sum of
    its crossing rows ``crossing_rows``, ``batch_rows``, the most rows of
    any slab the pass allocates, and ``ssm_cols``, the column store's
    widest capacity, beside ``resident_bytes`` (given: the rank's slab
    bytes when the pass began); the driver's lift adds ``w_pad``,
    ``window_rows`` and ``forked``."""

    #: the order stage's column exchange, in this many all-to-alls
    EXCHANGE_PIECES = 8

    def __init__(self, mesh: GroupMesh, resident_bytes: int = 0):
        self.mesh = mesh
        self.record = {"n_pad": 0, "crossing_rows": 0, "batch_rows": 0, "ssm_cols": 0,
                       "w_pad": 0, "window_rows": 0, "forked": False,
                       "resident_bytes": int(resident_bytes)}

    def seen(self, rows: int) -> None:
        """A slab of ``rows`` rows was allocated."""
        self.record["batch_rows"] = max(self.record["batch_rows"], int(rows))

    def pad(self, block: int, parents, *rest):
        """``parents`` (-1) and ``rest`` (0) padded to a multiple of ``D *
        block`` rows."""
        m = block * self.mesh.size
        n = parents.shape[0]
        extra = -n % m
        self.record["n_pad"] = n + extra
        if not extra:
            return (parents, *rest)

        def padded(a, fill):
            return np.concatenate([a, np.full((extra,) + a.shape[1:], fill, a.dtype)])

        return (padded(parents, -1), *(padded(a, 0) for a in rest))

    def zeros(self, n_rows: int, cols: int):
        """This rank's rows of an ``(n_rows, cols)`` bool slab (the column
        store), zeros."""
        rows = n_rows // self.mesh.size
        self.seen(rows)
        self.record["ssm_cols"] = max(self.record["ssm_cols"], int(cols))
        return torch.zeros((rows, cols), dtype=torch.bool, device=self.mesh.device)

    def view(self, shard, prefetch=None):
        """A row view of this rank's shard (:class:`RowGather`)."""
        return RowGather(self.mesh, shard, shard.shape[0] * self.mesh.size,
                         prefetch=prefetch, pieces=self.EXCHANGE_PIECES)

    def visibility(self, stages, parents_np, parents, creator, fork_pairs, *,
                   n_members: int, block: int):
        """:func:`group_visibility_stage` as the ``pipeline.visibility_stage``
        stage."""
        plan = CrossingPlan.of(parents_np, self.mesh.size, self.mesh.rank)
        self.record["crossing_rows"] = plan.crossing
        return stages.stage_call(
            "pipeline.visibility_stage", group_visibility_stage, self.mesh, plan,
            parents, creator, fork_pairs, n_members=n_members, block=block,
            record=self.seen,
        )


def _member_shards(member_table, stake, d: int):
    """The ``d`` member shards ``(member_table rows, stake)`` of a member
    table padded to a multiple of ``d`` (-1 rows, 0 stake: they add
    nothing), shard ``s`` owning rows ``[s M / d, (s + 1) M / d)``."""
    m = member_table.shape[0]
    pad = -m % d
    if pad:
        member_table = torch.cat([
            member_table,
            member_table.new_full((pad, member_table.shape[1]), -1),
        ])
        stake = torch.cat([stake, stake.new_zeros(pad)])
    m_loc = (m + pad) // d
    return [
        (member_table[s * m_loc : (s + 1) * m_loc],
         stake[s * m_loc : (s + 1) * m_loc])
        for s in range(d)
    ]


def _check_on_mesh(mesh, sees):
    if _canonical(sees.device) != mesh.device:
        raise ValueError(
            f"sees on {sees.device}, the mesh's shards on {mesh.device}"
        )


def _member_sharded_tally(sees, member_table, stake, mesh, gather_b, row0, rows):
    """The int32 stake tally of rows ``[row0, row0 + rows)`` over the
    mesh's member shards: one :func:`~tpu_swirld_torch.gpu.kernels.ssm_tally`
    a local shard, with ``b = gather_b(slots) & valid`` its members'
    gathered rows of ``sees`` (``slots`` clipped to ``[0, n)``), summed by
    :func:`_psum`.  A :class:`GroupMesh` rank keeps its own shard's member
    rows and stake as tensors of its own."""
    n = sees.shape[0]
    shards = _member_shards(member_table, stake, mesh.size)
    tallies = []
    for s in mesh.local_shards:
        mt_s, stake_s = (t.contiguous() for t in shards[s])
        idx = mt_s.reshape(-1)
        b = gather_b(idx.clamp(0, n - 1)) & (idx >= 0)[:, None]
        tallies.append(kernels.ssm_tally(sees, mt_s, stake_s, b, row0, rows=rows))
    return _psum(mesh, tallies)


def ssm_matrix_sharded(sees, member_table, stake, tot_stake, *, mesh):
    """Member-sharded strongly-sees matrix, bool ``(N, N)``: the ``ssm_fn``
    of :func:`consensus_fn_for_mesh`.

    Each member shard's partial int32 tally is one
    :func:`~tpu_swirld_torch.gpu.kernels.ssm_tally` call over every row of
    ``sees`` (``row_lo = 0``, ``rows = N``) with the shard's member rows and
    stake, and ``b = sees[members] & valid``, the shard's ``(M / D * K,
    N)`` gathered member rows; :func:`_psum` sums the tallies and
    ``3 * acc > 2 * tot_stake`` runs once, in int32 as in the reference
    (``tot_stake`` inside the int32 envelope, else ``ValueError``).  The
    member table is padded to a mesh multiple here when it is not.  On a
    :class:`GroupMesh` ``sees`` is replicated (every rank passes the whole
    slab) and each rank launches its own shard's tally."""
    tot = kernels.check_stake_envelope(tot_stake)
    _check_on_mesh(mesh, sees)
    n = sees.shape[0]
    acc = _member_sharded_tally(
        sees, member_table, stake, mesh, lambda slots: sees[slots], 0, n
    )
    return 3 * acc > 2 * tot


def make_ssm_block_fn_for_mesh(mesh):
    """Member-sharded strongly-sees *block* with the ``ssm_block_fn``
    seam's signature (:func:`~tpu_swirld_torch.gpu.kernels.ssm_block`):
    ``fn(sees, member_table, stake, cols, row0, *, rows, tot_stake)`` ->
    bool ``(rows, C)``, the windowed counterpart of
    :func:`ssm_matrix_sharded`.

    Each member shard runs one
    :func:`~tpu_swirld_torch.gpu.kernels.ssm_tally` over the block's rows of
    the whole (replicated) ``sees`` with its members' gathered column tiles
    as ``b``; :func:`_psum` sums the int32 tallies before the threshold.
    The start is taken as the reference's ``lax.dynamic_slice`` takes it
    (:func:`~tpu_swirld_torch.gpu.kernels.slice_start`: a negative start
    counts from the end, then it is clamped to ``[0, n - rows]``; the
    row-sharded block instead clips a negative start to 0, as its
    reference does), and columns ``< 0`` come out False.  Cached per
    mesh."""

    def build():
        def block(sees, member_table, stake, cols, row0, *, rows, tot_stake):
            tot = kernels.check_stake_envelope(tot_stake)
            _check_on_mesh(mesh, sees)
            n = sees.shape[0]
            row0c = kernels.slice_start(row0, rows, n)
            cv = cols >= 0
            colsc = cols.clamp(0, n - 1)[None, :]
            acc = _member_sharded_tally(
                sees, member_table, stake, mesh,
                lambda slots: sees[slots[:, None], colsc] & cv[None, :],
                row0c, rows,
            )
            return (3 * acc > 2 * tot) & cv[None, :]

        return block

    return _mesh_cache_get(_mesh_block_fns, mesh, build)


def consensus_fn_for_mesh(mesh):
    """End-to-end consensus (:func:`~tpu_swirld_torch.gpu.pipeline.
    consensus_body`) with the strongly-sees phase member-sharded over
    ``mesh`` (:func:`ssm_matrix_sharded`).  Cached per mesh."""
    from tpu_swirld_torch.gpu.pipeline import consensus_body

    def build():
        return functools.partial(
            consensus_body,
            ssm_fn=functools.partial(ssm_matrix_sharded, mesh=mesh),
        )

    return _mesh_cache_get(_mesh_fns, mesh, build)


def _row_shards(mesh, sees):
    """``(n, n_loc, [(s, rows of shard s)])`` for the local shards of a
    row-sharded slab of ``n`` columns: on a :class:`Mesh` ``sees`` is the
    whole ``(n, n)`` slab, cut here; on a :class:`GroupMesh` it is the
    rank's own ``(n / D, n)`` shard.  Raises when the rows do not split."""
    d = mesh.size
    if isinstance(mesh, GroupMesh):
        n_loc, n = sees.shape
        if n_loc * d != n:
            raise ValueError(
                f"a row shard of {n_loc} rows is not 1/{d} of a {n}-column slab"
            )
        return n, n_loc, [(mesh.rank, sees)]
    n = sees.shape[0]
    if n % d:
        raise ValueError(f"a slab of {n} rows does not split into {d} row shards")
    n_loc = n // d
    return n, n_loc, [(s, sees[s * n_loc : (s + 1) * n_loc]) for s in range(d)]


def _row_sharded_block_fn(mesh, shard_tally, *, every_shard: bool):
    """The row-sharded block over ``shard_tally(sees_shard, member_table,
    stake, b, row_lo, *, rows) -> int32 (rows, C)``, one shard's partial
    tally (:func:`~tpu_swirld_torch.gpu.kernels.ssm_tally` and its plain
    version).  The int8 halo sum, the sum of the tallies and the strict-2/3
    test run here, through :func:`_psum`.  ``every_shard=False`` skips the
    shards that own no row of the block (their tally is zero; a
    :class:`GroupMesh` rank that owns none still joins the sum)."""

    def block(sees, member_table, stake, cols, row0, *, rows, tot_stake):
        tot_stake = kernels.check_stake_envelope(tot_stake)
        _check_on_mesh(mesh, sees)
        n, n_loc, shards = _row_shards(mesh, sees)
        if not 1 <= rows <= n:
            raise ValueError(f"a block of {rows} rows outside [1, {n}]")
        idx = member_table.reshape(-1)
        valid = idx >= 0
        idxc = idx.clamp(0, n - 1)
        cv = cols >= 0
        row0c = min(max(int(row0), 0), n - rows)
        # ---- b-side halo: each gathered member row lies in one shard, which
        # contributes it; the others contribute zeros
        owner, loc_b = idxc // n_loc, (idxc % n_loc)[:, None]
        colsc = cols.clamp(0, n - 1)[None, :]
        b_parts = [
            (s_loc[loc_b, colsc] & (valid & (owner == s))[:, None]).to(torch.int8)
            for s, s_loc in shards
        ]
        b = (_psum(mesh, b_parts) > 0) & cv[None, :]
        # ---- a side: each shard's tally of the block rows it owns
        parts = [
            shard_tally(s_loc, member_table, stake, b, row0c - s * n_loc, rows=rows)
            for s, s_loc in shards
            if every_shard or -rows < row0c - s * n_loc < n_loc
        ] or [torch.zeros((rows, cols.shape[0]), dtype=torch.int32, device=sees.device)]
        acc = _psum(mesh, parts)
        return (3 * acc > 2 * tot_stake) & cv[None, :]

    return block


def make_row_sharded_block_fn(mesh, *, bmm=None):
    """Window-row-sharded strongly-sees block with the ``ssm_block_fn``
    seam's signature (:func:`~tpu_swirld_torch.gpu.kernels.ssm_block`):
    ``fn(sees, member_table, stake, cols, row0, *, rows, tot_stake)`` ->
    bool ``(rows, C)``.

    On a :class:`Mesh` ``sees`` is the whole slab, split into ``mesh.size``
    row shards of ``n / D`` rows; ``n`` must divide (raises otherwise:
    nothing is padded).  On a :class:`GroupMesh` ``sees`` is the rank's own
    row shard ``(n / D, n)``, as the reference's ``shard_map`` body takes
    it, and every rank gets the whole block back.  The start clamps
    as the reference's ``clip(row0, 0, n - rows)``: a negative start goes
    to 0 (unlike :func:`~tpu_swirld_torch.gpu.kernels.slice_start`).
    ``bmm`` is the shard-local member hop ``(a, b) -> bool``, called ``M``
    times by every shard, as in the reference; ``None`` is
    :func:`~tpu_swirld_torch.gpu.kernels.bmm_or` (the port has no XLA hop).
    Functions with the default hop are cached per mesh."""
    local_bmm = bmm if bmm is not None else kernels.bmm_or

    def build():
        return _row_sharded_block_fn(
            mesh, functools.partial(kernels.ssm_tally_reference, bmm=local_bmm),
            every_shard=True,
        )

    if bmm is not None:
        return build()
    return _mesh_cache_get(_mesh_row_block_fns, mesh, build)


class MeshStreamingConsensus(StreamingConsensus):
    """Streaming consensus with the resident window row-sharded over
    ``mesh``:

    - every strongly-sees block (extension, column adds and the batch
      rebase's ``_columns_pass``) goes through
      :func:`make_row_sharded_block_fn` (the CUDA ``bmm_or`` as the member
      hop on the card) or, with ``pallas=True``,
      :func:`~tpu_swirld_torch.gpu.kernels.make_mesh_row_block_fn` (one CUDA
      ``ssm_tally`` launch a shard);
    - the :class:`~tpu_swirld_torch.store.slab.SlabStore` accounts per-shard
      residency (``n_shards=D``) and ``device_tile_budget`` bounds the
      widest shard like the global budget;
    - ``window_bucket`` rounds up to a mesh multiple so every row capacity
      splits evenly.  A batch rebase's slab must split too (its padded event
      count, a multiple of ``block``); the block function raises otherwise.

    The archive stays host-global, as in the reference.  ``device`` must be
    the mesh's device; it defaults to ``"cuda"`` and raises without a GPU.
    Over a :class:`GroupMesh` the driver is a
    :class:`GroupStreamingConsensus`: each rank holds its own rows.
    """

    def __new__(cls, mesh, *args, **kw):
        if cls is MeshStreamingConsensus and isinstance(mesh, GroupMesh):
            cls = GroupStreamingConsensus
        return super().__new__(cls)

    def __init__(
        self,
        mesh: Mesh,
        members,
        stake=None,
        config=None,
        *,
        tile_budget: Optional[int] = None,
        tile: int = 256,
        device_tile_budget: Optional[int] = None,
        strict_budget: bool = False,
        store: Optional[SlabStore] = None,
        bmm=None,
        pallas: bool = False,
        **kw,
    ):
        device = _canonical(resolve_device(kw.get("device", "cuda")))
        if device != mesh.device:
            raise ValueError(
                f"the driver runs on {device}, the mesh's shards on {mesh.device}"
            )
        self.mesh = mesh
        d = mesh.size
        self._n_devices = d
        # the slabs are one tensor on the mesh's one device, so their
        # placement cannot drift and nothing is ever re-pinned: repins
        # stays 0 (kept for the reference's mesh_repins stats key; its
        # gauge is set where a repin happens, so never here)
        self.repins = 0
        wb = max(256, int(kw.pop("window_bucket", 1024)))
        wb = -(-wb // d) * d
        kw["window_bucket"] = wb
        if pallas and bmm is None:
            kernel = kernels.make_mesh_row_block_fn(mesh)
        else:
            kernel = make_row_sharded_block_fn(mesh, bmm=bmm)
        kw.setdefault("ssm_block_fn", kernel)
        if store is None:
            store = SlabStore(
                tile_budget, tile=tile, strict=strict_budget,
                config=config, n_shards=d,
                device_budget_tiles=device_tile_budget,
            )
        super().__init__(members, stake, config, store=store, **kw)
        self.flightrec_label = "streaming-mesh"

    #: every block runs as this stage, as in the reference
    _block_stage = "pipeline.ssm_block_mesh"

    def ingest(self, events=()) -> dict:
        st = super().ingest(events)
        st["mesh_devices"] = self._n_devices
        st["mesh_repins"] = self.repins
        return st


class GroupStreamingConsensus(MeshStreamingConsensus):
    """:class:`MeshStreamingConsensus` over a :class:`GroupMesh`: one
    process a shard, each rank of the group running the same driver on its
    own device, every rank's result the same.

    Between ingests a rank's ``anc``, ``sees`` and ``ssm`` slabs are its own
    ``W / D`` rows of the window (``assert_row_sharded``), as the reference's
    ``P(axis, None)`` shards.  The stages that read or write rows another
    rank owns exchange them explicitly, where the reference's GSPMD inserts
    the collectives: the one-process stage bodies (the visibility
    extension, the column store's block writes, the rounds scan, fame
    voting, order extraction) run over a :class:`RowGather` view of each
    slab, which gathers the rows they read and writes the rows they write
    by owner; fame gathers the cells it reads, of the table's used slots
    alone; order extraction runs each rank's own events over their columns
    of every row (one all-to-all, ``(D - 1) W^2 / D^2`` bytes), then joins
    the outputs (``8 W`` bytes); every strongly-sees block is the
    row-sharded block over the rank's shard; a prune or a growth moves the
    rows that change owner (:func:`reshard_rows`).  A full rebase runs the
    batch pass over the rank's own ``N / D`` rows of the DAG's slabs
    (:class:`BatchShards`, the visibility handing each rank's crossing rows
    on), lifts them into its window rows (:func:`reshard_rows`) and spills
    the decided rows in gathered pieces; ``rebase_slabs`` records each
    one's shapes and the most rows of any slab it allocated.  A widening
    builds the rank's own rows of the widened window: the retained rows
    move by owner, the rank decompresses its own archived rows and the
    archived parents of retained events, and one ``bmm_or`` rebuilds its
    retained rows' prefix columns (:meth:`_widen_slabs`; ``widen_slabs``
    records each).  One step stays whole: a growth moves most rows, every
    shard's range changing.  In a pass's stats
    ``group_calls`` and ``group_bytes`` are the collectives this rank
    joined during it and the bytes it handed them (``GroupMesh.traffic``),
    ``group_stages`` the same by stage (``Traffic.by_stage``) and
    ``group_window_rows`` the window's rows ``W`` at the pass's end."""

    #: fame votes over the table's used slots: its cells are gathered
    _fame_on_used_slots = True
    #: a rebase spills a batch shard's worth of rows in this many gathers,
    #: and lifts a window shard's worth of crossing rows in this many sums
    REBASE_PIECES = 4

    def __init__(self, mesh: GroupMesh, members, stake=None, config=None, **kw):
        self.mesh = mesh
        #: each full rebase's shapes and the most rows of any slab it
        #: allocated: ``n_pad``, ``batch_rows`` (at most ``n_pad / D``),
        #: ``w_pad``, ``window_rows`` (at most ``w_pad / D``), the
        #: visibility stage's ``crossing_rows`` (``sum_t |X_t|``), the
        #: column store's ``ssm_cols``, ``forked``, and the rank's slab
        #: bytes when it began (``resident_bytes``)
        self.rebase_slabs = []
        #: each widening's shapes and what it allocated, read and moved:
        #: ``w_pad`` before and ``new_pad`` after, ``delta``, the retained
        #: rows ``w_used``, the column store's ``ssm_cols``, ``forked``,
        #: ``window_rows`` (the most rows of any slab it allocated, on the
        #: card or the host: at most ``new_pad / D``), ``parent_rows``
        #: (``|P|``, the archived parents of retained events),
        #: ``decompressed_rows`` (its own archived rows and ``P``),
        #: ``moved_rows`` (retained rows that changed owner) and ``bytes``
        #: (handed to its collectives)
        self.widen_slabs = []
        super().__init__(mesh, members, stake, config, **kw)
        self.stages.scope = mesh.traffic.during
        self.flightrec_label = "streaming-group"

    # ---------------------------------------------------------- placement

    def _own_rows(self, a):
        """This rank's rows of a whole slab (a host array or a tensor), as
        an owned tensor on the rank's device."""
        t = torch.as_tensor(a)
        n_loc = t.shape[0] // self.mesh.size
        lo = self.mesh.rank * n_loc
        return t[lo : lo + n_loc].to(self.device, copy=True)

    def _repin(self) -> int:
        """Keep this rank's rows of any slab that left its row shard (a
        whole ``W``-row slab; any other shape raises), counted in
        ``repins``.  No stage leaves one: steady state is zero."""
        if not self._initialized:
            return 0
        n = 0
        aliased = self._sees_d is self._anc_d
        for name in ("_anc_d", "_ssm_d") + (() if aliased else ("_sees_d",)):
            t = getattr(self, name)
            if t.shape[0] == self._w_pad // self.mesh.size and t.device == self.device:
                continue
            if t.shape[0] != self._w_pad:
                raise RuntimeError(f"{name} has {t.shape[0]} rows: neither the "
                                   f"window's {self._w_pad} nor a shard of it")
            setattr(self, name, self._own_rows(t))
            n += 1
        if aliased:
            self._sees_d = self._anc_d
        if n:
            self.repins += n
            o = obs.current()
            if o is not None:
                o.registry.gauge("mesh_repins").set(self.repins)
        return n

    def _account(self) -> None:
        # the store budgets the whole window's shapes, split over the shards
        if not self._initialized:
            return
        w, s = self._w_pad, self.store
        s.account("anc", (w, w))
        if self._sees_d is not self._anc_d:
            s.account("sees", (w, w))
        else:
            s.drop("sees")
        s.account("ssm", (w, self._ssm_d.shape[1]))

    @property
    def resident_visibility_bytes(self) -> int:
        """The whole window's slab bytes, as the one-process mesh driver
        reports them: ``D`` times this rank's (``rank_resident_bytes``)."""
        return self.mesh.size * self.rank_resident_bytes

    @property
    def rank_resident_bytes(self) -> int:
        """Bytes of this rank's row shards of the window slabs."""
        return super().resident_visibility_bytes

    def ingest(self, events=()) -> dict:
        traffic = self.mesh.traffic
        calls, sent = traffic.calls, traffic.bytes
        traffic.take_stages()
        st = super().ingest(events)
        self._repin()
        st["mesh_repins"] = self.repins
        st["group_calls"] = traffic.calls - calls
        st["group_bytes"] = traffic.bytes - sent
        st["group_stages"] = traffic.take_stages()
        st["group_window_rows"] = self._w_pad
        st["rank_resident_bytes"] = self.rank_resident_bytes
        return st

    # ------------------------------------------------------- the seams

    def _grow_slabs(self, new_pad: int) -> None:
        aliased = self._sees_d is self._anc_d
        old, n_loc = self._w_pad, new_pad // self.mesh.size

        def grow(shard, cols):
            wide = torch.zeros((shard.shape[0], cols), dtype=torch.bool, device=self.device)
            wide[:, : shard.shape[1]] = shard
            return reshard_rows(self.mesh, wide, old, n_loc)

        self._anc_d = grow(self._anc_d, new_pad)
        self._sees_d = self._anc_d if aliased else grow(self._sees_d, new_pad)
        self._ssm_d = grow(self._ssm_d, self._ssm_d.shape[1])

    def _rows(self, slab, prefetch=None):
        return RowGather(self.mesh, slab, self._w_pad, prefetch=prefetch)

    def _prune_slabs(self, d: int, w_used: int, keep) -> None:
        has_forks = bool(self._fork_np.shape[0])
        self._anc_d, self._sees_d, self._ssm_d = self.stages.stage_call(
            "pipeline.inc_prune", group_prune_stage, self.mesh,
            self._anc_d, self._sees_d, self._ssm_d, d, w_used, keep,
            n=self._w_pad, has_forks=has_forks,
        )

    def _batch_shards(self):
        shards = BatchShards(self.mesh, self.rank_resident_bytes)
        self.rebase_slabs.append(shards.record)
        return shards

    def _lift_slabs(self, aux, lo, n, w_pad, pos, forked):
        """The window's row shards from the batch pass's: of each slab the
        rank's batch rows over columns ``[lo, n)`` (a view), or the column
        store's kept columns ``pos``, move to their window owners
        (:func:`reshard_rows` with ``shift=lo``, rows past ``n`` zero) in
        sums of at most ``W / D`` rows (:attr:`REBASE_PIECES` to a window
        shard); each batch shard is let go once lifted."""
        rec = self.rebase_slabs[-1]
        rec["w_pad"], rec["forked"] = w_pad, forked
        w_loc = w_pad // self.mesh.size

        def window_seen(rows):
            rec["window_rows"] = max(rec["window_rows"], int(rows))

        def lift(local, cols):
            return reshard_rows(self.mesh, local, n, w_loc, shift=lo, cols=cols,
                                piece_rows=-(-w_loc // self.REBASE_PIECES),
                                record=window_seen)

        anc = aux.pop("anc")
        sees = aux.pop("sees")
        self._anc_d = lift(anc[:, lo:n], w_pad)
        del anc
        self._sees_d = lift(sees[:, lo:n], w_pad) if forked else self._anc_d
        del sees
        ssm = aux.pop("ssm_c")
        if pos is None:
            window_seen(w_loc)
            self._ssm_d = torch.zeros((w_loc, self._wcol_cap), dtype=torch.bool,
                                      device=self.device)
        else:
            kept = ssm[:, pos]
            del ssm
            self._ssm_d = lift(kept, self._wcol_cap)

    def _spill_batch_rows(self, start, stop, anc):
        """The decided rows ``[start, stop)`` of the batch pass's ancestry
        shards, gathered (:func:`gather_rows`) in pieces of at most ``N /
        D`` rows (:attr:`REBASE_PIECES` to a shard), each pulled to the
        host and archived as it arrives, as one spill."""
        rec = self.rebase_slabs[-1]
        step = -(-anc.shape[0] // self.REBASE_PIECES)
        for a in range(start, stop, step):
            rows = gather_rows(self.mesh, anc, torch.arange(
                a, min(a + step, stop), dtype=torch.int64, device=self.device))
            rec["batch_rows"] = max(rec["batch_rows"], rows.shape[0])
            self.store.spill_full(a, to_host(rows), continues=a > start)
            del rows

    def _widen_slabs(self, lo2, delta, w_used, new_pad, has_forks):
        """A widening over the rank's own rows: of the widened window's
        ``new_pad / D`` rows a rank, the retained rows move by owner
        (:func:`reshard_rows`, ``shift=-delta``, in sums of at most a
        quarter shard), their columns placed at ``[delta, delta +
        w_used)``; the archived rows ``[0, delta)`` this rank owns are
        decompressed into a host buffer of its rows and put in place (with
        their derived sees when ``has_forks``); the retained rows' prefix
        columns are ``anc[:, delta + A] (x) B`` (``kernels.bmm_or``), ``A``
        the retained events with a parent in ``[lo2, lo)`` and ``B[a]`` the
        OR of those parents' archived rows, the archived rows read beyond
        the rank's own; their sees prefix comes from the rank's rows alone
        (``forkseen_matrix``).  The archive counts the reference's one
        fetch of ``delta`` rows.  ``widen_slabs`` records it."""
        from tpu_swirld_torch.gpu.pipeline import forkseen_matrix

        mesh, dev = self.mesh, self.device
        lo, hi = self._lo, self._n_done
        w2 = w_used + delta
        n_loc = new_pad // mesh.size
        r0 = mesh.rank * n_loc              # the rank's first widened row
        arch = self.store.archive
        sent = mesh.traffic.bytes
        rec = {"w_pad": self._w_pad, "new_pad": new_pad, "delta": delta,
               "w_used": w_used, "ssm_cols": self._wcol_cap, "forked": has_forks,
               "window_rows": 0, "parent_rows": 0, "decompressed_rows": 0,
               "moved_rows": 0, "bytes": 0}
        self.widen_slabs.append(rec)

        def seen(rows):
            rec["window_rows"] = max(rec["window_rows"], int(rows))

        a, b = min(r0, delta), min(r0 + n_loc, delta)   # its archived rows
        arch.prefetch(lo2 + a, lo2 + b)
        piece = -(-n_loc // self.REBASE_PIECES)
        # ---- the retained rows, moved by owner: old row i is row i + delta
        rec["moved_rows"] = sum(y - x for _t, x, y in row_crossings(
            mesh.size, self._w_pad // mesh.size, w_used, n_loc, -delta))

        def move(shard, cols, col0):
            return reshard_rows(mesh, shard, w_used, n_loc, shift=-delta, cols=cols,
                                col0=col0, piece_rows=piece, record=seen)

        def put(slab, rows):
            # host rows [a, b) into columns [0, w2), a piece at a time: each
            # piece crosses to the card through a buffer of its own size
            for x in range(0, b - a, piece):
                seen(min(piece, b - a - x))
                slab[a - r0 + x : min(b, a + x + piece) - r0, :w2] = (
                    torch.from_numpy(rows[x : x + piece]))

        # each old shard is let go once moved
        old_sees, self._sees_d = self._sees_d, None
        anc, self._anc_d = move(self._anc_d[:, :w_used], new_pad, delta), None
        sees = move(old_sees[:, :w_used], new_pad, delta) if has_forks else anc
        del old_sees
        self._ssm_d = move(self._ssm_d, self._wcol_cap, 0)
        # ---- the archived rows this rank owns, over columns [lo2, hi)
        creators_g = self.packer.window_view(0, hi)[1]
        fp_g = self.packer.fork_pairs_view(0)
        if a < b:
            seen(b - a)
            anc_pre = arch.read(range(lo2 + a, lo2 + b), lo2, hi)
            put(anc, anc_pre)
            if has_forks:
                put(sees, SlabArchive.derive_sees(anc_pre, lo2, creators_g[lo2:hi],
                                                  fp_g, self._m))
            rec["decompressed_rows"] += b - a
            del anc_pre
        arch.count_fetch(delta)             # the reference's one fetch
        # ---- the retained rows' prefix columns [0, delta): a path from a
        # retained event down to y in [lo2, lo) leaves the retained rows at
        # some x in A, through a parent p of x in [lo2, lo), and y is in
        # anc(p)
        par = np.asarray(self.packer.window_view(lo, hi)[0], dtype=np.int64)
        pre = (par >= lo2) & (par < lo)
        a_ev = np.flatnonzero(pre.any(axis=1))          # A, as retained rows
        x0, x1 = max(delta, r0), min(w2, r0 + n_loc)    # its retained rows
        if a_ev.size:
            p_ev = np.unique(par[pre])                  # P, global
            rec["parent_rows"] = int(p_ev.shape[0])
            seen(p_ev.shape[0])
            seen(a_ev.shape[0])
            p_rows = arch.read(p_ev, lo2, lo)
            rec["decompressed_rows"] += int(p_ev.shape[0])
            at = np.searchsorted(p_ev, np.where(pre, par, p_ev[0]))
            b_or = np.zeros((a_ev.shape[0], delta), dtype=bool)
            for j, i in enumerate(a_ev):
                for k in (0, 1):
                    if pre[i, k]:
                        b_or[j] |= p_rows[at[i, k]]
            del p_rows
            if x0 < x1:
                hop = anc[x0 - r0 : x1 - r0, delta + torch.as_tensor(a_ev, device=dev)]
                anc[x0 - r0 : x1 - r0, :delta] = kernels.bmm_or(
                    hop, torch.from_numpy(b_or).to(dev))
                del hop
            del b_or
        if has_forks and x0 < x1:
            # fork poisoning of the rebuilt prefix columns, from the rank's
            # own rows; the retained columns keep the card's values
            fp = np.asarray(fp_g, dtype=np.int64).reshape(-1, 3)
            span = ((fp[:, 1:] >= lo2) & (fp[:, 1:] < hi)).all(axis=1)
            pairs = torch.as_tensor(np.stack(
                [fp[span, 0], fp[span, 1] - lo2, fp[span, 2] - lo2], axis=1,
            ).astype(np.int32), device=dev)
            rows = anc[x0 - r0 : x1 - r0]
            fseen = forkseen_matrix(rows, pairs, self._m)
            creator = torch.as_tensor(np.asarray(creators_g[lo2:lo], dtype=np.int64),
                                      device=dev)
            sees[x0 - r0 : x1 - r0, :delta] = rows[:, :delta] & ~fseen[:, creator]
            del rows, fseen
        self._anc_d = anc
        self._sees_d = sees
        rec["bytes"] = mesh.traffic.bytes - sent


def streaming_consensus_for_mesh(mesh: Mesh, members, stake=None, config=None, **kw):
    """A :class:`MeshStreamingConsensus` over ``mesh``."""
    return MeshStreamingConsensus(mesh, members, stake, config, **kw)


def pad_members(member_table: np.ndarray, stake: np.ndarray, n_devices: int):
    """Pad the member axis to a multiple of the mesh size (-1 rows, 0
    stake)."""
    m = member_table.shape[0]
    m_pad = ((m + n_devices - 1) // n_devices) * n_devices
    o = obs.current()
    if o is not None:
        o.registry.gauge("mesh_member_pad").set(m_pad - m)
    if m_pad == m:
        return member_table, stake
    extra = m_pad - m
    member_table = np.concatenate(
        [member_table, np.full((extra, member_table.shape[1]), -1, np.int32)]
    )
    stake = np.concatenate([stake, np.zeros((extra,), stake.dtype)])
    return member_table, stake
