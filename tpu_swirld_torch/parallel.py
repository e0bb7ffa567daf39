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
with :func:`reshard_rows`.
"""

from __future__ import annotations

import dataclasses
import functools
from datetime import timedelta
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpu_swirld_torch import obs
from tpu_swirld_torch.device import resolve_device
from tpu_swirld_torch.gpu import kernels
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


@dataclasses.dataclass
class Traffic:
    """What a rank handed to its group's collectives: calls and payload
    bytes (each call's tensor, once)."""

    calls: int = 0
    bytes: int = 0

    def add(self, t: torch.Tensor) -> None:
        self.calls += 1
        self.bytes += t.numel() * t.element_size()


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


def reshard_rows(mesh: GroupMesh, shard, n_rows: int, n_loc_new: int, shift: int = 0):
    """This rank's ``n_loc_new`` rows of the slab whose global row ``i`` is
    row ``i + shift`` of the ``n_rows``-row slab sharded as ``shard`` (zero
    past its end): a prune's shift, a growth's new shard size.  A rank keeps
    the rows it already owns; only the rows that change owner cross, all in
    one sum (every rank lists the same crossings, from the shapes alone),
    so a prune of ``d`` rows moves about ``d`` rows a shard boundary."""
    n_loc, cols = shard.shape
    lo = mesh.rank * n_loc

    def span(t):
        # destination t's rows, as rows of the old slab
        g0 = t * n_loc_new + shift
        return g0, max(g0, min(g0 + n_loc_new, n_rows))

    crossing = []       # (destination, first, last + 1), old slab rows
    for t in range(mesh.size):
        g0, g1 = span(t)
        for a, b in ((g0, min(g1, t * n_loc)), (max(g0, (t + 1) * n_loc), g1)):
            if a < b:
                crossing.append((t, a, b))
    g0, g1 = span(mesh.rank)
    mine = torch.zeros((n_loc_new, cols), dtype=torch.bool, device=shard.device)
    a, b = max(g0, lo), min(g1, lo + n_loc)
    if a < b:
        mine[a - g0 : b - g0] = shard[a - lo : b - lo]
    if not crossing:
        return mine
    buf = torch.zeros((sum(b - a for _, a, b in crossing), cols), dtype=torch.int8,
                      device=shard.device)
    off = 0
    for _t, a, b in crossing:
        x, y = max(a, lo), min(b, lo + n_loc)
        if x < y:       # rows of this crossing that this rank owns
            buf[off + x - a : off + y - a] = shard[x - lo : y - lo]
        off += b - a
    got = _psum(mesh, [buf]) > 0
    off = 0
    for t, a, b in crossing:
        if t == mesh.rank:
            mine[a - g0 : b - g0] = got[off : off + b - a]
        off += b - a
    return mine


class RowGather:
    """A row-sharded slab seen by global row, so that a stage written
    against the whole slab (the visibility extension, the column store's
    block writes, ``rounds_chunk_stage``, ``fame_scan``, ``order_scan``)
    runs over a rank's shard unchanged: ``shape`` and ``device`` are the
    whole slab's.  A read gathers its rows on every rank
    (:func:`gather_rows`): ``g[idx]`` (an index tensor), ``g[a:b]``, and
    ``g[i]`` (an int) from the rows ``prefetch`` (``(start, stop)``)
    gathered at once, else one gather.  A write ``g[a:b] = block`` or
    ``g[a:b, c:d] = block`` (every rank's same values) lands in the rows
    this rank owns, in place (:func:`owner_write`).  Every rank must read
    and write the same rows in the same order, as every rank runs the same
    stage."""

    def __init__(self, mesh: GroupMesh, shard, n_rows: int, prefetch=None):
        self.mesh, self.shard = mesh, shard
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
            idx = torch.arange(start, stop, dtype=torch.int64, device=self.device)
        if not isinstance(idx, torch.Tensor):
            raise TypeError(f"a row view reads rows by int, slice or tensor, not {idx!r}")
        got = gather_rows(self.mesh, self.shard, idx.reshape(-1).to(torch.int64))
        return got.reshape(*idx.shape, self.shape[1])

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
    by owner; every strongly-sees block is the row-sharded block over the
    rank's shard; a prune or a growth moves the rows that change owner
    (:func:`reshard_rows`).  Three steps assemble whole slabs: a batch
    rebase computes the whole DAG's slabs on every rank (then keeps its
    rows, through ``slab_put``), a widening pulls the whole window to the
    host, as the one-process driver does, and the rebase spill reads its
    rows from the batch slab.  ``group_calls`` and ``group_bytes`` in a
    pass's stats are the collectives this rank joined during it and the
    bytes it handed them (``GroupMesh.traffic``)."""

    def __init__(self, mesh: GroupMesh, members, stake=None, config=None, **kw):
        self.mesh = mesh
        kw.setdefault("slab_put", self._own_rows)
        super().__init__(mesh, members, stake, config, **kw)
        self.flightrec_label = "streaming-group"

    # ---------------------------------------------------------- placement

    def _own_rows(self, a):
        """``slab_put``: this rank's rows of a whole slab (a host array or a
        tensor), as an owned tensor on the rank's device."""
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
        calls, sent = self.mesh.traffic.calls, self.mesh.traffic.bytes
        st = super().ingest(events)
        self._repin()
        st["mesh_repins"] = self.repins
        st["group_calls"] = self.mesh.traffic.calls - calls
        st["group_bytes"] = self.mesh.traffic.bytes - sent
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

    def _rebase_block_fn(self):
        fn, mesh = self._ssm_block_fn, self.mesh

        def own_block(sees, *args, **kw):
            # the batch pass's whole slab: this rank's rows go to the block
            n_loc = sees.shape[0] // mesh.size
            return fn(sees[mesh.rank * n_loc : (mesh.rank + 1) * n_loc], *args, **kw)

        return own_block

    def _host_window(self, has_forks: bool):
        n_loc = self._w_pad // self.mesh.size

        def whole(shard):
            # a shard at a time through the card, the whole window on the host
            return np.concatenate([
                gather_rows(self.mesh, shard, torch.arange(
                    t * n_loc, (t + 1) * n_loc, dtype=torch.int64, device=self.device,
                )).cpu().numpy()
                for t in range(self.mesh.size)
            ])

        anc = whole(self._anc_d)
        return anc, (whole(self._sees_d) if has_forks else anc), whole(self._ssm_d)


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
