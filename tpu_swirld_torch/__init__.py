"""PyTorch / CUDA port of the tpu_swirld consensus pipeline.

The JAX package :mod:`tpu_swirld` is the reference: this package keeps its
module and function names (``tpu_swirld_torch/gpu/pipeline.py::_columns_pass``
is the counterpart of ``tpu_swirld/tpu/pipeline.py::_columns_pass``) and
produces bit-identical consensus outputs on the same packed DAG.  It imports
``torch`` and numpy only, never ``jax`` and never a module of
:mod:`tpu_swirld`; the host layers it needs (crypto, event, config, packing,
sim) are its own copies.

Entry points take ``device=`` (default ``"cuda"``) and raise when no GPU is
present unless the caller asks for ``device="cpu"``.  On a CUDA device the
boolean hops run through the hand-written kernels of
:mod:`tpu_swirld_torch.gpu.kernels`; on the CPU the same wrappers take their
plain PyTorch versions.
"""
