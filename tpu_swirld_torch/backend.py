"""The ``backend='tpu'`` consensus engine of a live ``Node``, on the card
(counterpart of the reference's ``tpu_swirld/backend.py::TpuEngine``).

- :class:`TorchEngine` owns a :class:`~tpu_swirld_torch.packing.Packer`
  that mirrors the node's event store (``node.order_added``);
- each ``consensus_pass`` appends the sync delta and, once at least
  ``config.tpu_min_batch`` events wait, re-runs the batch
  :func:`~tpu_swirld_torch.gpu.pipeline.run_consensus` over the whole
  packed DAG on the engine's device (consensus outputs are pure functions of
  the DAG, so a batch pass equals the oracle's incremental state);
- the outputs are written back into the node's oracle-shaped state
  (``round`` / ``is_witness`` / ``wit_list`` / ``famous`` /
  ``round_received`` / ``consensus_ts`` / ``consensus`` / ``transactions``),
  so everything downstream, other members gossiping with this node
  included, does not see which engine ran.

``config.mesh_shape`` (e.g. ``{"members": 2}``) runs the strongly-sees
phase as that many member shards, all on the engine's one device
(:func:`~tpu_swirld_torch.parallel.make_mesh`); ``config.block_size`` sets
the ancestry tile.

The engine reads the node's config fields by name and packs its events as
they are, so it binds to a reference ``Node`` as well as to the port's (a
test sets ``node._tpu_engine = TorchEngine(node, device="cpu")`` first,
which the node's ``consensus_pass`` honours).

Each pass recomputes from the whole DAG, so its cost grows with history;
``tpu_min_batch`` amortizes it.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional

from tpu_swirld_torch.device import resolve_device
from tpu_swirld_torch.gpu.pipeline import ConsensusResult, run_consensus
from tpu_swirld_torch.packing import Packer
from tpu_swirld_torch.parallel import make_mesh


class TorchEngine:
    """Batch-pipeline consensus engine bound to one node.  ``device``
    defaults to ``"cuda"`` and raises without a GPU."""

    def __init__(self, node, device="cuda"):
        self.node = node
        self.device = resolve_device(device)
        stake = [node.stake[m] for m in node.members]
        self.packer = Packer(node.members, stake)
        self.mesh = None
        if node.config.mesh_shape:
            n_shards = math.prod(int(v) for v in node.config.mesh_shape.values())
            self.mesh = make_mesh(n_shards, self.device)
        self.last_result: Optional[ConsensusResult] = None
        self.n_passes = 0           # batch passes run, and their wall seconds
        self.pass_seconds = 0.0
        self._n_consumed = 0
        self._violations_seen: set = set()  # famous late witnesses already
        #   counted into node.horizon_violations (fame may decide on a
        #   LATER pass than the one that registered the witness)

    def consensus_pass(self, new_ids: List[bytes], force: bool = False) -> None:
        node = self.node
        for eid in node.order_added[len(self.packer):]:
            self.packer.append(node.hg[eid])
        # lazy batching: amortize the batch replay over >= tpu_min_batch
        # new events (the same eventual output, computed later)
        pending = len(self.packer) - self._n_consumed
        if pending == 0 or len(self.packer) == 0:
            return    # up to date: nothing a replay could change
        if not force and pending < max(1, node.config.tpu_min_batch):
            return
        self._n_consumed = len(self.packer)
        t0 = time.perf_counter()
        packed = self.packer.pack()
        result = run_consensus(
            packed,
            node.config,
            block=node.config.block_size,
            mesh=self.mesh,
            device=self.device,
        )
        self.last_result = result
        self._write_back(packed, result)
        self.n_passes += 1
        self.pass_seconds += time.perf_counter() - t0

    def flush(self) -> None:
        """Run any pending events through a pass now, ignoring the
        lazy-batch threshold (a no-op when already up to date)."""
        self.consensus_pass([], force=True)

    def _write_back(self, packed, result: ConsensusResult) -> None:
        """Mirror the pass's outputs into the node's oracle-shaped state.

        Every witness registers on both engines (the oracle module's
        expiry-horizon rule), so the write-back is a plain overwrite;
        witnesses that landed at or below the previously committed frontier
        are recorded in ``node.late_witnesses``, as the oracle records them.
        """
        node = self.node
        ids = packed.ids
        prev_frozen = node._frozen_round
        prev_wits = set(node.wit_slot)
        node.round = {ids[i]: int(result.round[i]) for i in range(packed.n)}
        node.is_witness = {
            ids[i]: bool(result.is_witness[i]) for i in range(packed.n)
        }
        node.max_round = result.max_round
        node.famous = {ids[i]: v for i, v in result.famous.items()}
        # witness tables in slot order (the pipeline's slot order is topo)
        node.wit_list = {}
        node.wit_slot = {}
        node.witnesses = {}
        for i in sorted(result.famous):
            eid = ids[i]
            r = int(result.round[i])
            slots = node.wit_list.setdefault(r, [])
            node.wit_slot[eid] = len(slots)
            slots.append(eid)
            node.witnesses.setdefault(r, {}).setdefault(
                node.hg[eid].c, []
            ).append(eid)
            if r <= prev_frozen and eid not in prev_wits:
                node.late_witnesses.append(eid)
                if node.metrics is not None:
                    node.metrics.count("consensus_late_witnesses")
        # as on the oracle path, a FAMOUS late witness (impossible under
        # n > 3f) is counted, over every known late witness each pass:
        # fame may decide on a later pass than the one that registered it
        for eid in node.late_witnesses:
            if node.famous.get(eid) and eid not in self._violations_seen:
                self._violations_seen.add(eid)
                node.horizon_violations += 1
                if node.metrics is not None:
                    node.metrics.count("consensus_horizon_violations")
        # ordering state
        node.round_received = {}
        node.consensus_ts = {}
        consensus: List[bytes] = []
        for i in result.order:
            eid = ids[i]
            node.round_received[eid] = int(result.round_received[i])
            node.consensus_ts[eid] = int(result.consensus_ts[i])
            consensus.append(eid)
        node.consensus = consensus
        node.transactions = [node.hg[e].d for e in consensus]
        node.tbd = [e for e in node.order_added if e not in node.round_received]
        # fame-complete prefix (the rounds order extraction consumed)
        r = 0
        while True:
            ws = node.wit_list.get(r)
            if not ws or node.max_round < r + 2:
                break
            if any(node.famous[w] is None for w in ws):
                break
            r += 1
        node.consensus_round = r
        node._frozen_round = r - 1
