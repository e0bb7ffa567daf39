"""PyTorch / CUDA port of the tpu_swirld consensus pipeline.

The JAX package :mod:`tpu_swirld` is the reference: this package keeps its
module and function names (``tpu_swirld_torch/gpu/pipeline.py::_columns_pass``
is the counterpart of ``tpu_swirld/tpu/pipeline.py::_columns_pass``) and
produces bit-identical consensus outputs on the same packed DAG.  It imports
``torch`` and numpy only, never ``jax`` and never a module of
:mod:`tpu_swirld`; the host layers it needs (crypto, event, config, packing,
sim) are its own copies.

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
shards on one device.

Entry points take ``device=`` (default ``"cuda"``) and raise when no GPU is
present unless the caller asks for ``device="cpu"``.  On a CUDA device the
boolean hops run through the hand-written kernels of
:mod:`tpu_swirld_torch.gpu.kernels`; on the CPU the same wrappers take their
plain PyTorch versions.
"""

from tpu_swirld_torch.gpu.incremental import IncrementalConsensus  # noqa: E402
from tpu_swirld_torch.parallel import (  # noqa: E402
    Mesh,
    MeshStreamingConsensus,
    make_mesh,
    streaming_consensus_for_mesh,
)
from tpu_swirld_torch.store import (  # noqa: E402
    SlabArchive,
    SlabStore,
    StreamingConsensus,
    TileBudgetExceeded,
)

__all__ = [
    "IncrementalConsensus",
    "Mesh",
    "MeshStreamingConsensus",
    "SlabArchive",
    "SlabStore",
    "StreamingConsensus",
    "TileBudgetExceeded",
    "make_mesh",
    "streaming_consensus_for_mesh",
]
