"""Real-process cluster: sockets, tx ingestion, crash-recovery chaos (the
port's copy of the reference's ``tpu_swirld/net``, with its module, class
and function names).

Everything before this package runs the protocol *in one process*: the
sim's "network" is a dict of bound methods, the chaos harness injects
faults by editing that dict, and kill -9 is simulated by dropping a node
object.  This package is the deployment edge — the same
:class:`~tpu_swirld_torch.oracle.node.Node`, unchanged, over real TCP between
real OS processes that really die:

- :mod:`~tpu_swirld_torch.net.frame` — length-prefixed framing, ephemeral-port
  allocation, and the net layer's only wall-clock reads;
- :mod:`~tpu_swirld_torch.net.transport` — :class:`SocketTransport`, the
  :class:`~tpu_swirld_torch.transport.Transport` seam over per-peer TCP with
  the in-process error planes preserved (certified bit-identical by the
  parity suite);
- :mod:`~tpu_swirld_torch.net.ingest` — :class:`TxPool` client submission with
  dedup, size caps, and undecided-window backpressure;
- :mod:`~tpu_swirld_torch.net.wal` — :class:`OwnEventWal`, the fsync'd
  own-event log with torn-tail recovery and the clean-shutdown marker;
- :mod:`~tpu_swirld_torch.net.node_proc` — the per-process runtime (server +
  gossip loop + checkpointing + startup post-mortem), run as
  ``python -m tpu_swirld_torch.net.node_proc spec.json``;
- :mod:`~tpu_swirld_torch.net.cluster` — the supervisor: launches N node
  processes, drives client traffic, injects SIGKILL, restarts, and
  renders the same safety/liveness verdict as :mod:`tpu_swirld_torch.chaos`.

A node process runs the oracle node, as the reference's does, and its
import chain loads no ``torch``: it starts in well under a second, so a
restart fits a kill/restart schedule of a few seconds.  The card's part is
the replay of a run's union event log through the port's engines
(``chip_smoke.py``).
"""

from tpu_swirld_torch.net.frame import allocate_ports
from tpu_swirld_torch.net.ingest import TxPool, decode_batch, encode_batch
from tpu_swirld_torch.net.transport import SocketTransport
from tpu_swirld_torch.net.wal import OwnEventWal

__all__ = [
    "OwnEventWal",
    "SocketTransport",
    "TxPool",
    "allocate_ports",
    "decode_batch",
    "encode_batch",
]
