"""PyTorch / CUDA port of the tpu_swirld consensus pipeline.

The JAX package :mod:`tpu_swirld` is the reference: this package keeps its
module and function names (``tpu_swirld_torch/gpu/pipeline.py::_columns_pass``
is the counterpart of ``tpu_swirld/tpu/pipeline.py::_columns_pass``) and
produces bit-identical consensus outputs on the same packed DAG.  It imports
``torch`` and numpy only, never ``jax`` and never a module of
:mod:`tpu_swirld`; the host layers it needs (crypto, event, config, packing,
sim, transport, the oracle node) are its own copies.

:func:`tpu_swirld_torch.gpu.pipeline.run_consensus` runs both batch paths
of the reference: the column-restricted default (strongly-sees columns for
witnesses only) and the full-matrix path (``ssm_mode="full"``, or
``use_pallas_ssm=True``), whose stages ``rounds_body`` /
``fame_order_body`` fuse into ``consensus_body``, the counterpart of the
reference's ``consensus_arrays``.

:class:`IncrementalConsensus` (``tpu_swirld_torch.gpu.incremental``) is the
steady-state driver: it ingests gossip deltas, carries the visibility slabs
and the strongly-sees column store on the device between passes, prunes the
decided prefix, and keeps its cumulative result bit-identical to a batch
``run_consensus`` over the same DAG.

:class:`StreamingConsensus` (``tpu_swirld_torch.store``) bounds that
driver's device memory by the undecided window: decided rows retire into a
compressed host archive, and a delta naming pruned history widens the
window back by re-fetching archived rows.  :class:`MeshStreamingConsensus`
(``tpu_swirld_torch.parallel``) row-shards that window over a mesh of
shards on one device, or over a :class:`GroupMesh` of processes, one a
card (:func:`init_group`; ``python -m tpu_swirld_torch.multichip``);
``run_consensus(mesh=)`` splits the strongly-sees matrix over the member
axis instead (:func:`ssm_matrix_sharded`, :func:`make_ssm_block_fn_for_mesh`,
:func:`consensus_fn_for_mesh`).

:class:`Node` (``tpu_swirld_torch.oracle``) is a live gossip member, the
pure-Python consensus oracle with the reference's wire format, and
:func:`make_simulation` (``tpu_swirld_torch.sim``) a population of them in
one process.  A node whose ``config.backend`` is ``"tpu"`` runs its
consensus passes on the card through :class:`TorchEngine`
(``tpu_swirld_torch.backend``).

:class:`DynamicNode` (``tpu_swirld_torch.membership``) is a node whose
member set is consensus-decided and epoch-versioned; :func:`run_dynamic`
drives a schedule under it through any engine, the device ones with their
member-axis repack on the card.  :func:`save_node` / :func:`load_node`
(``tpu_swirld_torch.checkpoint``) write and restore a node in the
reference's checkpoint format; a restored ``"tpu"`` node replays on the
card.

:class:`ChaosSimulation` (``tpu_swirld_torch.chaos``) runs a population
under a :class:`FaultPlan` (drops, corruption, duplicates, reordering,
delays, partitions, crashes and restores from checkpoints) through
:class:`FaultyTransport`, with byzantine members from
``tpu_swirld_torch.sim`` and ``tpu_swirld_torch.adversary`` (whose
``SCENARIOS`` registry names the reference's eight scenarios), and judges
the run against an oracle replay; a ``"tpu"`` member and the cross-engine
replays run on the card.  ``python -m tpu_swirld_torch.chaos_run`` is its
command line.

:mod:`tpu_swirld_torch.obs` and :mod:`tpu_swirld_torch.metrics` are the
observability layer (spans, protocol gauges, finality tracking, the flight
recorder, the dispatch profiler and ``trace_consensus``, a
``torch.profiler`` trace of a pass), off unless enabled.

Entry points take ``device=`` (default ``"cuda"``) and raise when no GPU is
present unless the caller asks for ``device="cpu"``.  On a CUDA device the
boolean hops run through the hand-written kernels of
:mod:`tpu_swirld_torch.gpu.kernels`; on the CPU the same wrappers take their
plain PyTorch versions.

:mod:`tpu_swirld_torch.net` is the real-process cluster: node processes
gossiping over TCP, client transactions, ``kill -9`` and restart from a
checkpoint and an own-event WAL, judged against an oracle replay of the
union event log (``python -m tpu_swirld_torch.cluster_run``).  A node
process runs the oracle and never imports ``torch``; so every name below is
exported lazily (PEP 562), and importing this package loads nothing heavy
until a name is first used.
"""

import importlib

#: exported name -> the module that defines it
_EXPORTS = {
    "SCENARIOS": "adversary",
    "TorchEngine": "backend",
    "ChaosScenario": "chaos",
    "ChaosSimulation": "chaos",
    "run_chaos": "chaos",
    "load_archive": "checkpoint",
    "load_node": "checkpoint",
    "load_packed": "checkpoint",
    "save_archive": "checkpoint",
    "save_node": "checkpoint",
    "save_packed": "checkpoint",
    "IncrementalConsensus": "gpu.incremental",
    "DynamicNode": "membership.dynamic",
    "run_all_engines": "membership.engine",
    "run_dynamic": "membership.engine",
    "repack_packer": "membership.repack",
    "Node": "oracle",
    "GroupMesh": "parallel",
    "GroupStreamingConsensus": "parallel",
    "Mesh": "parallel",
    "MeshStreamingConsensus": "parallel",
    "consensus_fn_for_mesh": "parallel",
    "init_group": "parallel",
    "make_group_mesh": "parallel",
    "make_mesh": "parallel",
    "make_ssm_block_fn_for_mesh": "parallel",
    "ssm_matrix_sharded": "parallel",
    "streaming_consensus_for_mesh": "parallel",
    "make_simulation": "sim",
    "run_with_divergent_forkers": "sim",
    "run_with_forkers": "sim",
    "SlabArchive": "store",
    "SlabStore": "store",
    "StreamingConsensus": "store",
    "TileBudgetExceeded": "store",
    "FaultPlan": "transport",
    "FaultyTransport": "transport",
    "LinkFaults": "transport",
    "Partition": "transport",
}


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


__all__ = sorted(_EXPORTS)
