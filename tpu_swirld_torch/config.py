"""Protocol parameters the port reads (the subset of the reference's
``tpu_swirld/config.py::SwirldConfig`` that the batch pipeline uses, with
the same defaults)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SwirldConfig:
    """Attributes:
      n_members: number of members in the population.
      coin_period: every ``coin_period``-th fame-voting round is a coin round.
      max_rounds: capacity of the witness table's round window (the
        overflow self-heal grows up to it, never past it).
      stake: per-member stake; ``None`` means one unit each.
      seed: base RNG seed for simulations.
    """

    n_members: int = 4
    coin_period: int = 6
    max_rounds: int = 256
    stake: Optional[Tuple[int, ...]] = None
    seed: int = 0
