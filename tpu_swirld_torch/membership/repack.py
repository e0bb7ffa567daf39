"""MemberEpoch repack: remap the member axis at an epoch boundary (the
counterpart of the reference's ``tpu_swirld/membership/repack.py``).

The union-registry invariant (``membership.epoch``) makes this pass
cheap by construction: member indices never change, joins *append* rows,
leaves keep their rows with stake zeroed.  So an epoch repack is

- **host side**: extend the live :class:`~tpu_swirld_torch.packing.Packer`
  with the new member rows (``add_member``) and swap its stake vector
  (``set_stake``) — the anc/sees slabs, ssm column store, witness
  tables, and fork-pair ledgers are event- or (round, slot)-indexed and
  survive untouched;
- **device side**: one stage (:func:`repack_stage`) that pads the ``(M, K)``
  member table with fresh ``-1`` rows and emplaces the new epoch's stake
  vector on the device.  The reference's stage is a jitted XLA function,
  not a Pallas kernel, so its port is PyTorch ops on the device.

Cost model: O(M' · K) int32 for the member table copy plus O(M') for the
stake swap — independent of the event count.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from tpu_swirld_torch.device import resolve_device
from tpu_swirld_torch.membership.epoch import MemberEpoch
from tpu_swirld_torch.packing import Packer


def repack_stage(member_table: torch.Tensor, stake_new, *, n_members_new: int):
    """Device member-axis extension: pad ``member_table`` from ``(M, K)``
    to ``(n_members_new, K)`` with ``-1`` rows (new members own no packed
    events yet) and return it alongside the new epoch's stake vector as
    int32, both on ``member_table``'s device."""
    m, k = member_table.shape
    pad = n_members_new - m
    if pad > 0:
        member_table = torch.cat([
            member_table,
            torch.full((pad, k), -1, dtype=member_table.dtype,
                       device=member_table.device),
        ])
    stake = torch.as_tensor(stake_new, dtype=torch.int32,
                            device=member_table.device)
    return member_table, stake


@dataclasses.dataclass(frozen=True)
class RepackStats:
    """One epoch boundary's member-axis repack, for bench/obs."""

    epoch_id: int
    activation_round: int
    members_before: int
    members_after: int
    rows_added: int
    seconds: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def repack_packer(packer: Packer, epoch: MemberEpoch, device="cuda",
                  outputs=None) -> RepackStats:
    """Apply ``epoch`` to a live packer: append the joined members'
    rows, swap the stake vector, and run :func:`repack_stage` on
    ``device`` (default ``"cuda"``, which raises without a GPU) so the
    padded member table and the stake land there the way the pipeline
    ships them.  ``outputs``, a list, receives the stage's ``(table,
    stake)`` tensors.  ``seconds`` includes waiting for the device."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    before = len(packer.members)
    for pk in epoch.members:
        if pk not in packer.member_index:
            packer.add_member(pk)
    after = len(packer.members)
    if after != len(epoch.members):
        raise ValueError(
            "epoch registry is not an extension of the packer's members "
            "(union-registry invariant violated)"
        )
    packer.set_stake(epoch.stake)
    table = packer.member_table_view(before)
    k = table.shape[1]
    new_table, new_stake = repack_stage(
        torch.as_tensor(table, device=dev),
        np.asarray(epoch.stake, dtype=np.int32),
        n_members_new=after,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if tuple(new_table.shape) != (after, k) or tuple(new_stake.shape) != (after,):
        raise AssertionError("repack stage shape mismatch")
    if outputs is not None:
        outputs.append((new_table, new_stake))
    return RepackStats(
        epoch_id=epoch.epoch_id,
        activation_round=epoch.activation_round,
        members_before=before,
        members_after=after,
        rows_added=after - before,
        seconds=time.perf_counter() - t0,
    )
