"""Checkpoint / resume of the packed DAG and consensus state (a copy of the
reference's ``tpu_swirld/checkpoint.py`` format: the same ``SWCK`` magic,
``FORMAT_VERSION``, header and event log, so a checkpoint written by either
package loads in the other).

Two granularities:

- :func:`save_packed` / :func:`load_packed` — the dense device-input arrays
  (plus host-side ids/sigs) as a single ``.npz``.  No pickle anywhere:
  hashes and signatures are fixed-width, so they serialize as uint8
  matrices; payload bytes are length-prefix packed.
- :func:`save_node` / :func:`load_node` — full engine state via the wire
  format: the event log in topo order (``encode_event`` blobs).  Restore
  replays the log through validation + one batch consensus pass, which by
  the purity of the consensus functions reconstructs bit-identical
  ``round`` / ``witness`` / ``famous`` / order state; the node then
  resumes gossiping.  A ``backend="tpu"`` node's pass runs
  :class:`~tpu_swirld_torch.backend.TorchEngine` on ``device``; restoring
  any other node imports no ``torch`` and needs no device (a cluster's node
  process restores its oracle node this way).

The replay-purity contract is only sound because the expiry horizon is
deterministic (the :mod:`tpu_swirld_torch.oracle.node` module docstring).
The checkpoint carries the decided-order length, the fame-complete
frontier and a digest of the decided prefix, and :func:`load_node` verifies
that the replay re-decides that exact prefix — so checkpoint corruption or
consensus-rule drift fails loudly at restore time instead of diverging
silently later.  A :class:`~tpu_swirld_torch.membership.dynamic.DynamicNode`
also carries its epoch ledger, which the replay must re-derive.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from tpu_swirld_torch import crypto
from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.event import decode_event, encode_event
from tpu_swirld_torch.oracle.node import Node
from tpu_swirld_torch.packing import PackedDAG

FORMAT_VERSION = 1
MAGIC = b"SWCK"


def _pack_bytes_list(items: List[bytes]) -> np.ndarray:
    """Length-prefixed flat uint8 array (no pickle)."""
    blob = b"".join(struct.pack("<I", len(b)) + b for b in items)
    return np.frombuffer(blob, dtype=np.uint8)


def _unpack_bytes_list(arr: np.ndarray) -> List[bytes]:
    blob = arr.tobytes()
    out, off = [], 0
    while off < len(blob):
        (n,) = struct.unpack_from("<I", blob, off)
        off += 4
        out.append(blob[off : off + n])
        off += n
    return out


def save_packed(path: str, packed: PackedDAG) -> None:
    """One compressed ``.npz`` of a packed DAG (``np.savez_compressed``
    appends ``.npz`` to a path without it)."""
    np.savez_compressed(
        path,
        format_version=FORMAT_VERSION,
        n=packed.n,
        n_members=packed.n_members,
        parents=packed.parents,
        creator=packed.creator,
        seq=packed.seq,
        t=packed.t,
        coin=packed.coin,
        stake=packed.stake,
        fork_pairs=packed.fork_pairs,
        member_table=packed.member_table,
        ids=np.frombuffer(b"".join(packed.ids), dtype=np.uint8),
        sigs=_pack_bytes_list(packed.sigs),
    )


def load_packed(path: str) -> PackedDAG:
    with np.load(path) as z:
        if int(z["format_version"]) != FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {z['format_version']}"
            )
        ids_flat = z["ids"].tobytes()
        h = crypto.HASH_BYTES
        return PackedDAG(
            n=int(z["n"]),
            n_members=int(z["n_members"]),
            parents=z["parents"],
            creator=z["creator"],
            seq=z["seq"],
            t=z["t"],
            coin=z["coin"],
            stake=z["stake"],
            fork_pairs=z["fork_pairs"],
            member_table=z["member_table"],
            ids=[ids_flat[i : i + h] for i in range(0, len(ids_flat), h)],
            sigs=_unpack_bytes_list(z["sigs"]),
        )


def save_archive(path: str, archive) -> None:
    """Persist a :class:`~tpu_swirld_torch.store.archive.SlabArchive` (the
    streaming driver's decided-row store) as one ``.npz``: compressed row
    blobs, the retired-round ledger, and a BLAKE2b digest of the blob
    stream.  No pickle."""
    archive.save(path)


def load_archive(path: str):
    """Restore an archive and **verify its digest** — corruption or
    tampering raises ``ValueError`` at restore time rather than feeding
    wrong ancestry into a later widening rebase."""
    from tpu_swirld_torch.store.archive import SlabArchive

    return SlabArchive.load(path)


def save_node(path: str, node: Node) -> None:
    """Write the node's full event log (wire format) + config + members,
    atomically: the file at ``path`` is the previous checkpoint or the new
    one, never a torn half.  Takes a node of either package."""
    log = b"".join(encode_event(node.hg[e]) for e in node.order_added)
    cfg = dataclasses.asdict(node.config)
    cfg["stake"] = list(node.config.stakes())
    meta = {
        "format_version": FORMAT_VERSION,
        "config": cfg,
        "members": [m.hex() for m in node.members],
        "n_events": len(node.order_added),
        # horizon integrity: the committed frontier at save time and a
        # digest of the decided prefix; load_node verifies the replay
        # re-decides this exact prefix
        "decided": len(node.consensus),
        "frontier": node._frozen_round,
        "order_digest": crypto.hash_bytes(b"".join(node.consensus)).hex(),
    }
    ledger = getattr(node, "ledger", None)
    if ledger is not None:
        # dynamic membership: the epoch ledger rides the header so a
        # restore can verify the replay re-derives the identical epoch
        # sequence.  The node is rebuilt from the GENESIS member set —
        # the registry (meta["members"] above) regrows from decided
        # joins during replay, exactly as it grew live.
        meta["membership"] = {
            **ledger.to_meta(),
            "genesis_members": [m.hex() for m in node._genesis_members],
            "delay": node.membership_delay,
        }
    header = json.dumps(meta).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC + struct.pack("<I", len(header)) + header + log)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_node(
    path: str,
    sk: bytes,
    pk: bytes,
    network: Dict[bytes, Callable],
    network_want: Optional[Dict[bytes, Callable]] = None,
    clock: Optional[Callable[[], int]] = None,
    transport=None,
    device="cuda",
) -> Node:
    """Rebuild a node from a checkpoint: replay the validated event log and
    run one batch consensus pass (bit-identical by purity).

    ``device`` (default ``"cuda"``, which raises without a GPU) is where a
    ``backend="tpu"`` node's :class:`~tpu_swirld_torch.backend.TorchEngine`
    runs the replay's pass and every later one; there is no CPU fallback
    unless the caller passes ``device="cpu"``.  It is resolved only for
    such a node: any other checkpoint restores on a host without a GPU.
    ``transport`` re-attaches the restored node to a shared delivery
    layer.  The node's
    ``restore_seconds`` holds the wall seconds of the log's replay into the
    store (``"replay"``) and of the consensus pass (``"pass"``, which waits
    for the device).
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != MAGIC:
        raise ValueError("not a tpu_swirld checkpoint")
    (hlen,) = struct.unpack_from("<I", data, 4)
    meta = json.loads(data[8 : 8 + hlen].decode())
    if meta["format_version"] != FORMAT_VERSION:
        raise ValueError(
            f"unsupported checkpoint version {meta['format_version']}"
        )
    cfg_dict = dict(meta["config"])
    cfg_dict["stake"] = tuple(cfg_dict["stake"])
    cfg = SwirldConfig(**cfg_dict)
    members = [bytes.fromhex(m) for m in meta["members"]]
    membership = meta.get("membership")
    node_cls = Node
    if membership is not None:
        from tpu_swirld_torch.membership.dynamic import DynamicNode

        node_cls = DynamicNode
        # rebuild from the genesis member set; decided joins regrow the
        # registry during replay
        members = [bytes.fromhex(m) for m in membership["genesis_members"]]
    node = node_cls(
        sk=sk, pk=pk, network=network, members=members, config=cfg,
        clock=clock, create_genesis=False, network_want=network_want,
        transport=transport,
    )
    dev = None
    if cfg.backend == "tpu":
        from tpu_swirld_torch.backend import TorchEngine
        from tpu_swirld_torch.device import resolve_device

        dev = resolve_device(device)
        node._tpu_engine = TorchEngine(node, device=dev)
    t0 = time.perf_counter()
    off = 8 + hlen
    new_ids = []
    while off < len(data):
        ev, off = decode_event(data, off)
        if node.add_event(ev):
            new_ids.append(ev.id)
    t1 = time.perf_counter()
    node.consensus_pass(new_ids)
    if node._tpu_engine is not None:
        # a backend='tpu' node with a lazy-batch threshold must still come
        # back fully computed — the restore contract is bit-identical state
        node._tpu_engine.flush()
        if dev is not None and dev.type == "cuda":
            import torch

            torch.cuda.synchronize(dev)
    node.restore_seconds = {"replay": t1 - t0, "pass": time.perf_counter() - t1}
    # horizon integrity (older checkpoints without the fields skip this):
    # the replay must re-decide at least the checkpointed frontier, and
    # the decided prefix must be byte-identical to what was saved
    decided = int(meta.get("decided", 0))
    digest = meta.get("order_digest")
    if digest is not None:
        if len(node.consensus) < decided:
            raise ValueError(
                f"checkpoint replay regressed the horizon: re-decided "
                f"{len(node.consensus)} < checkpointed {decided}"
            )
        frontier = int(meta.get("frontier", node._frozen_round))
        if node._frozen_round < frontier:
            raise ValueError(
                f"checkpoint replay regressed the frontier: re-froze "
                f"round {node._frozen_round} < checkpointed {frontier}"
            )
        got = crypto.hash_bytes(b"".join(node.consensus[:decided])).hex()
        if got != digest:
            raise ValueError(
                "checkpoint replay diverged from the saved decided prefix "
                "(corrupt checkpoint or consensus-rule drift)"
            )
    if membership is not None:
        from tpu_swirld_torch.membership.epoch import EpochLedger

        # from_meta itself refuses an internally inconsistent document
        # (epochs edited without re-stamping the digest); the comparison
        # refuses a consistent-but-wrong ledger — either way the
        # replay-derived epoch sequence is the only accepted truth
        saved_ledger = EpochLedger.from_meta(membership)
        if not saved_ledger.same_epochs(node.ledger):
            raise ValueError(
                "checkpoint epoch ledger does not match the replay-"
                "derived ledger (tampered membership header or "
                "activation-rule drift)"
            )
    return node
