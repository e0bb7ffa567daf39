"""The pure-Python consensus oracle (copy of the reference's
``tpu_swirld/oracle``): the ``Node`` and its graph utilities."""

from tpu_swirld_torch.oracle.node import Node

__all__ = ["Node"]
