"""Row-sharded streaming over a mesh (counterpart of the streaming half of
the reference's ``tpu_swirld/parallel.py``).

:class:`MeshStreamingConsensus` row-shards the resident window: the
``anc`` / ``sees`` / ``ssm`` slabs are read as ``D`` contiguous ranges of
``W / D`` rows, and :func:`make_row_sharded_block_fn` runs every
strongly-sees block with one halo exchange, exactly as the reference's
``shard_map`` body does:

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
The port keeps that shape in one process, and this slice builds meshes
whose shards all live on **one** device: the slabs stay one tensor there,
so their placement cannot drift.  Both sums over the shards go through
:func:`_psum`, the one function a mesh over several cards replaces.  A mesh
over several devices raises (ROADMAP A8: per-card shard tensors and
collectives are not ported, and not approximated).

The member-sharded batch half of the reference (``ssm_matrix_sharded``,
``make_ssm_block_fn_for_mesh``, ``consensus_fn_for_mesh``,
``run_consensus(mesh=)``) runs no TPU kernel and is not ported yet
(ROADMAP A8); :func:`pad_members` is its host helper.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

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
    """A 1-D mesh: ``devices[s]`` holds row shard ``s`` along ``axis_name``.

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
    """A 1-D mesh of ``n_shards`` row shards, all on ``device`` (default
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


_mesh_row_block_fns = {}


def _psum(parts):
    """The sum over the mesh's shards of each shard's partial tensor (the
    reference's ``lax.psum``).  Every shard lives on one device here, so it
    is a plain sum; a mesh over several cards replaces this function with
    an all-reduce."""
    return functools.reduce(torch.add, parts)


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
        if _canonical(sees.device) != mesh.device:
            raise ValueError(
                f"sees on {sees.device}, the mesh's shards on {mesh.device}"
            )
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
        # stays 0 (kept for the reference's mesh_repins stats key)
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
    if m_pad == m:
        return member_table, stake
    extra = m_pad - m
    member_table = np.concatenate(
        [member_table, np.full((extra, member_table.shape[1]), -1, np.int32)]
    )
    stake = np.concatenate([stake, np.zeros((extra,), stake.dtype)])
    return member_table, stake
