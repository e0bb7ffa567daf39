"""Dynamic-membership drivers for the five consensus engines (the
counterpart of the reference's ``tpu_swirld/membership/engine.py``; the
device engines are the port's, on ``device``).

One entry point — :func:`run_dynamic` — replays a topologically ordered
event schedule under consensus-decided membership, in the ingest
granularity of each engine:

- ``oracle``       one consensus pass per event (the live-gossip shape);
- ``batch``        a single pass over the full DAG;
- ``incremental``  chunked passes with carried state;
- ``streaming``    chunked passes + decided rows stamped with their
                   epoch id (the archive schema);
- ``mesh``         chunked passes + row-shard re-pin bookkeeping across
                   the member-axis change.

Decisions come from the epoch-aware restatement core — a
:class:`~tpu_swirld_torch.membership.dynamic.DynamicNode` observer replay —
which is *the* semantics every engine follows.  The per-engine value is
twofold: the different pass granularities exercise the incremental /
batch determinism of the dynamic semantics (a memoization or adoption
bug shows up as a granularity-dependent order), and each driver performs
its engine's structural work at every epoch boundary: the member-axis
repack of the live packer (``membership.repack``), the epoch stamp on
archived decided rows, and the shard re-pin map for the mesh window.

When the schedule decides **no** membership transaction (a single-epoch
run), each device driver additionally runs its real engine —
``run_consensus`` / ``IncrementalConsensus`` / ``StreamingConsensus`` /
``MeshStreamingConsensus`` — on ``device`` over the same DAG and
cross-checks the native order bit-for-bit against the observer's.  That is
the regression pin: equal-stake single-epoch dynamic runs are
byte-identical to the pre-membership engines.  The mesh engine runs the
row-sharded driver's ``pallas=True`` route (one ``ssm_tally`` kernel a
shard on the card), the port's counterpart of the reference's mesh block;
with ``mesh=None`` it falls back to ``StreamingConsensus``, as the
reference's does.

The observer replay is pure Python on the host; only the repack stage and
the native engines run on ``device``, which defaults to ``"cuda"`` and
raises without a GPU, as every entry point of the port does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.device import resolve_device
from tpu_swirld_torch.membership.dynamic import DynamicNode
from tpu_swirld_torch.membership.epoch import EpochLedger
from tpu_swirld_torch.membership.repack import RepackStats, repack_packer
from tpu_swirld_torch.packing import Packer, pack_events

ENGINES = ("oracle", "batch", "incremental", "streaming", "mesh")


@dataclasses.dataclass
class DynamicResult:
    """Engine-independent view of a dynamic-membership run."""

    engine: str
    order: List[bytes]                  # decided event ids, consensus order
    rounds: Dict[bytes, int]            # event id -> round
    witnesses: Dict[bytes, bool]        # event id -> witness flag
    ledger: EpochLedger
    restatements: int
    repacks: List[RepackStats]
    single_epoch: bool
    #: engine-native cross-check result (single-epoch runs only)
    native_order: Optional[List[bytes]] = None
    #: streaming: decided rows stamped (event id, epoch id of the round
    #: that received them); mesh: member -> shard re-pin map per epoch
    archive_epochs: Optional[List[Tuple[bytes, int]]] = None
    shard_pins: Optional[List[Dict[bytes, int]]] = None
    #: each repack's ``(member table, stake)`` tensors from the device
    repack_outputs: Optional[list] = None
    #: wall seconds of the observer replay and of the native engine run
    #: (0.0 when it did not run)
    observer_seconds: float = 0.0
    native_seconds: float = 0.0

    @property
    def epochs(self) -> int:
        return len(self.ledger.epochs)


def _observer(
    members: Sequence[bytes], stake: Sequence[int], config: SwirldConfig
) -> DynamicNode:
    pk, sk = members[0], b"\x00" * 32
    return DynamicNode(
        sk=sk, pk=pk, network={}, members=list(members), config=config,
        create_genesis=False, network_want={},
    )


def _chunks(n: int, size: int) -> List[Tuple[int, int]]:
    size = max(1, size)
    return [(s, min(n, s + size)) for s in range(0, n, size)]


def run_dynamic(
    events,
    members: Sequence[bytes],
    stake: Sequence[int],
    config: Optional[SwirldConfig] = None,
    *,
    engine: str = "batch",
    chunk: int = 256,
    mesh=None,
    n_shards: int = 2,
    cross_check: bool = True,
    device="cuda",
) -> DynamicResult:
    """Run one engine's dynamic-membership driver over ``events``
    (topologically ordered, genesis events included); the repacks and the
    native engine run on ``device``."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    dev = resolve_device(device)
    config = config or SwirldConfig(
        n_members=len(members), stake=tuple(stake)
    )
    events = list(events)

    # --- decisions: the epoch-aware restatement core, in this engine's
    # ingest granularity
    t0 = time.perf_counter()
    node = _observer(members, stake, config)
    if engine == "oracle":
        spans = _chunks(len(events), 1)
    elif engine == "batch":
        spans = _chunks(len(events), max(1, len(events)))
    else:
        spans = _chunks(len(events), chunk)
    for lo, hi in spans:
        new_ids = []
        for ev in events[lo:hi]:
            if node.add_event(ev):
                new_ids.append(ev.id)
        node.consensus_pass(new_ids)
    observer_seconds = time.perf_counter() - t0

    single_epoch = len(node.ledger.epochs) == 1

    # --- structural work per epoch boundary: live-packer member-axis
    # repack (all device engines), epoch-stamped archive rows
    # (streaming), shard re-pin maps (mesh)
    repacks: List[RepackStats] = []
    repack_outputs: Optional[list] = None
    archive_epochs: Optional[List[Tuple[bytes, int]]] = None
    shard_pins: Optional[List[Dict[bytes, int]]] = None
    if engine != "oracle":
        packer = Packer(list(members), list(stake))
        repack_outputs = []
        for epoch in node.ledger.epochs[1:]:
            repacks.append(
                repack_packer(packer, epoch, dev, outputs=repack_outputs)
            )
        for ev in events:
            if ev.c in packer.member_index:
                packer.append(ev)
    if engine == "streaming":
        archive_epochs = [
            (x, node.ledger.epoch_at(node.round_received[x]).epoch_id)
            for x in node.consensus
        ]
    if engine == "mesh":
        shard_pins = []
        for epoch in node.ledger.epochs:
            shard_pins.append({
                m: i % max(1, n_shards)
                for i, m in enumerate(epoch.members)
            })

    # --- single-epoch cross-check against the real engine
    native_order: Optional[List[bytes]] = None
    native_seconds = 0.0
    if single_epoch and engine != "oracle" and cross_check:
        t0 = time.perf_counter()
        native_order = _native_order(
            events, members, stake, config,
            engine=engine, chunk=chunk, mesh=mesh, device=dev,
        )
        native_seconds = time.perf_counter() - t0
        if native_order != node.consensus:
            raise AssertionError(
                f"single-epoch {engine} engine diverged from the "
                f"dynamic core: {len(native_order)} vs "
                f"{len(node.consensus)} decided"
            )

    return DynamicResult(
        engine=engine,
        order=list(node.consensus),
        rounds={e: node.round[e] for e in node.order_added},
        witnesses={e: bool(node.is_witness[e]) for e in node.order_added},
        ledger=node.ledger,
        restatements=node.restatements,
        repacks=repacks,
        single_epoch=single_epoch,
        native_order=native_order,
        archive_epochs=archive_epochs,
        shard_pins=shard_pins,
        repack_outputs=repack_outputs,
        observer_seconds=observer_seconds,
        native_seconds=native_seconds,
    )


def _native_order(
    events, members, stake, config, *, engine, chunk, mesh, device
) -> List[bytes]:
    """The unmodified engine's decided order (ids) for a single-epoch
    schedule on ``device`` — the byte-identical regression pin."""
    packed = pack_events(events, list(members), list(stake))
    if engine == "batch":
        from tpu_swirld_torch.gpu.pipeline import run_consensus

        res = run_consensus(packed, config, device=device)
        return [packed.ids[i] for i in res.order]
    if engine == "incremental":
        from tpu_swirld_torch.gpu.incremental import IncrementalConsensus

        inc = IncrementalConsensus(
            list(members), list(stake), config, chunk=max(32, chunk),
            device=device,
        )
    elif engine == "mesh" and mesh is not None:
        from tpu_swirld_torch.parallel import MeshStreamingConsensus

        inc = MeshStreamingConsensus(
            mesh, list(members), list(stake), config,
            chunk=max(32, chunk), pallas=True, device=device,
        )
    elif engine in ("streaming", "mesh"):
        from tpu_swirld_torch.store.streaming import StreamingConsensus

        inc = StreamingConsensus(
            list(members), list(stake), config, chunk=max(32, chunk),
            device=device,
        )
    else:
        raise ValueError(engine)
    try:
        for lo, hi in _chunks(len(events), chunk):
            inc.ingest(events[lo:hi])
        res = inc.result()
    finally:
        store = getattr(inc, "store", None)
        if store is not None:
            store.close()
    return [packed.ids[i] for i in res.order]


def run_all_engines(
    events,
    members: Sequence[bytes],
    stake: Sequence[int],
    config: Optional[SwirldConfig] = None,
    *,
    chunk: int = 64,
    engines: Sequence[str] = ENGINES,
    **kw,
) -> Dict[str, DynamicResult]:
    """Cross-engine parity harness: run every engine's dynamic driver
    over one schedule and verify bit-identical order + rounds."""
    results = {
        e: run_dynamic(
            events, members, stake, config, engine=e, chunk=chunk, **kw
        )
        for e in engines
    }
    ref = results[list(engines)[0]]
    for e, res in results.items():
        if res.order != ref.order:
            raise AssertionError(
                f"engine {e} order diverges from {ref.engine}: "
                f"{len(res.order)} vs {len(ref.order)} decided"
            )
        if res.rounds != ref.rounds:
            raise AssertionError(
                f"engine {e} rounds diverge from {ref.engine}"
            )
        if not res.ledger.same_epochs(ref.ledger):
            raise AssertionError(
                f"engine {e} ledger diverges from {ref.engine}"
            )
    return results
