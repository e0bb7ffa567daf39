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
The port keeps that shape in one process and builds meshes whose shards
all live on **one** device: the slabs stay one tensor there, so their
placement cannot drift.  Every sum over the shards goes through
:func:`_psum`, the one function a mesh over several cards replaces.  A mesh
over several devices raises (ROADMAP A8: per-card shard tensors and
collectives are not ported, and not approximated).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

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
    several devices raises ``ValueError``."""

    devices: Tuple[torch.device, ...]
    axis_name: str = MEMBER_AXIS

    def __post_init__(self):
        devs = tuple(_canonical(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one shard")
        if len(set(devs)) > 1:
            raise ValueError(
                f"a mesh over several devices ({sorted(map(str, set(devs)))}) "
                "is not ported: shards on several cards need per-card shard "
                "tensors and collectives (ROADMAP A8)"
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

    def __str__(self) -> str:
        return f"{self.size} shards on one device ({self.device})"


def make_mesh(n_shards: int = 1, device="cuda") -> Mesh:
    """A 1-D mesh of ``n_shards`` shards, all on ``device`` (default
    ``"cuda"``, which raises without a GPU)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return Mesh((resolve_device(device),) * int(n_shards))


# Kernel caches keyed on the mesh's physical identity (devices, shape, axis
# name), never on the Mesh object; bounded FIFO.
_MESH_CACHE_MAX = 8


def _mesh_key(mesh: Mesh):
    return (
        tuple(str(d) for d in mesh.devices),
        (mesh.size,),
        tuple(mesh.axis_names),
    )


def _mesh_cache_get(cache: dict, mesh: Mesh, build):
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


def _psum(parts):
    """The sum over the mesh's shards of each shard's partial tensor (the
    reference's ``lax.psum``).  Every shard lives on one device here, so it
    is a plain sum; a mesh over several cards replaces this function with
    an all-reduce."""
    return functools.reduce(torch.add, parts)


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


def _check_on_mesh(mesh: Mesh, sees):
    if _canonical(sees.device) != mesh.device:
        raise ValueError(
            f"sees on {sees.device}, the mesh's shards on {mesh.device}"
        )


def _member_sharded_tally(sees, member_table, stake, d, gather_b, row0, rows):
    """The int32 stake tally of rows ``[row0, row0 + rows)`` over ``d``
    member shards: one :func:`~tpu_swirld_torch.gpu.kernels.ssm_tally` a
    shard, with ``b = gather_b(slots) & valid`` its members' gathered rows
    of ``sees`` (``slots`` clipped to ``[0, n)``), summed by
    :func:`_psum`."""
    n = sees.shape[0]
    tallies = []
    for mt_s, stake_s in _member_shards(member_table, stake, d):
        idx = mt_s.reshape(-1)
        b = gather_b(idx.clamp(0, n - 1)) & (idx >= 0)[:, None]
        tallies.append(kernels.ssm_tally(sees, mt_s, stake_s, b, row0, rows=rows))
    return _psum(tallies)


def ssm_matrix_sharded(sees, member_table, stake, tot_stake, *, mesh: Mesh):
    """Member-sharded strongly-sees matrix, bool ``(N, N)``: the ``ssm_fn``
    of :func:`consensus_fn_for_mesh`.

    Each member shard's partial int32 tally is one
    :func:`~tpu_swirld_torch.gpu.kernels.ssm_tally` call over every row of
    ``sees`` (``row_lo = 0``, ``rows = N``) with the shard's member rows and
    stake, and ``b = sees[members] & valid``, the shard's ``(M / D * K,
    N)`` gathered member rows; :func:`_psum` sums the tallies and
    ``3 * acc > 2 * tot_stake`` runs once, in int32 as in the reference
    (``tot_stake`` inside the int32 envelope, else ``ValueError``).  The
    member table is padded to a mesh multiple here when it is not."""
    tot = kernels.check_stake_envelope(tot_stake)
    _check_on_mesh(mesh, sees)
    n = sees.shape[0]
    acc = _member_sharded_tally(
        sees, member_table, stake, mesh.size, lambda slots: sees[slots], 0, n
    )
    return 3 * acc > 2 * tot


def make_ssm_block_fn_for_mesh(mesh: Mesh):
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
    d = mesh.size

    def build():
        def block(sees, member_table, stake, cols, row0, *, rows, tot_stake):
            tot = kernels.check_stake_envelope(tot_stake)
            _check_on_mesh(mesh, sees)
            n = sees.shape[0]
            row0c = kernels.slice_start(row0, rows, n)
            cv = cols >= 0
            colsc = cols.clamp(0, n - 1)[None, :]
            acc = _member_sharded_tally(
                sees, member_table, stake, d,
                lambda slots: sees[slots[:, None], colsc] & cv[None, :],
                row0c, rows,
            )
            return (3 * acc > 2 * tot) & cv[None, :]

        return block

    return _mesh_cache_get(_mesh_block_fns, mesh, build)


def consensus_fn_for_mesh(mesh: Mesh):
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


def _row_sharded_block_fn(mesh: Mesh, shard_tally, *, every_shard: bool):
    """The row-sharded block over ``shard_tally(sees_shard, member_table,
    stake, b, row_lo, *, rows) -> int32 (rows, C)``, one shard's partial
    tally (:func:`~tpu_swirld_torch.gpu.kernels.ssm_tally` and its plain
    version).  The int8 halo sum, the sum of the tallies and the strict-2/3
    test run here, through :func:`_psum`.  ``every_shard=False`` skips the
    shards that own no row of the block (their tally is zero)."""
    d = mesh.size

    def block(sees, member_table, stake, cols, row0, *, rows, tot_stake):
        tot_stake = kernels.check_stake_envelope(tot_stake)
        n = sees.shape[0]
        _check_on_mesh(mesh, sees)
        if n % d:
            raise ValueError(
                f"a slab of {n} rows does not split into {d} row shards"
            )
        if not 1 <= rows <= n:
            raise ValueError(f"a block of {rows} rows outside [1, {n}]")
        n_loc = n // d
        idx = member_table.reshape(-1)
        valid = idx >= 0
        idxc = idx.clamp(0, n - 1)
        cv = cols >= 0
        row0c = min(max(int(row0), 0), n - rows)
        shards = [sees[s * n_loc : (s + 1) * n_loc] for s in range(d)]
        # ---- b-side halo: each gathered member row lies in one shard, which
        # contributes it; the others contribute zeros
        owner, loc_b = idxc // n_loc, (idxc % n_loc)[:, None]
        colsc = cols.clamp(0, n - 1)[None, :]
        b_parts = [
            (s_loc[loc_b, colsc] & (valid & (owner == s))[:, None]).to(torch.int8)
            for s, s_loc in enumerate(shards)
        ]
        b = (_psum(b_parts) > 0) & cv[None, :]
        # ---- a side: each shard's tally of the block rows it owns
        acc = _psum([
            shard_tally(s_loc, member_table, stake, b, row0c - s * n_loc, rows=rows)
            for s, s_loc in enumerate(shards)
            if every_shard or -rows < row0c - s * n_loc < n_loc
        ])
        return (3 * acc > 2 * tot_stake) & cv[None, :]

    return block


def make_row_sharded_block_fn(mesh: Mesh, *, bmm=None):
    """Window-row-sharded strongly-sees block with the ``ssm_block_fn``
    seam's signature (:func:`~tpu_swirld_torch.gpu.kernels.ssm_block`):
    ``fn(sees, member_table, stake, cols, row0, *, rows, tot_stake)`` ->
    bool ``(rows, C)``.

    ``sees`` is split into ``mesh.size`` row shards of ``n / D`` rows; ``n``
    must divide (raises otherwise: nothing is padded).  The start clamps
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
    """

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
