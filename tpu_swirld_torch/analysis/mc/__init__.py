"""Exhaustive-schedule model checker for the consensus core (the port's copy
of the reference's ``tpu_swirld/analysis/mc`` package).

Explicit-state exploration of ALL reachable gossip/delivery
interleavings of a small world (n <= 4 honest members plus attacker
fork branches, depth-bounded by an event budget), driving the port's
real :class:`~tpu_swirld_torch.oracle.node.Node` + ``Transport`` seam
rather than a re-model.  Both packages explore the same states and
transitions, and a counterexample document written by either replays in
the other.  See the module docstrings for the moving parts:

- :mod:`world` — states as per-role ingest histories; actions over the
  real pull/sync path; deterministic branch extensions; live schedule
  replay.
- :mod:`encode` — canonical state keys: hashed dedup plus honest-member
  symmetry reduction.
- :mod:`explore` — exhaustive BFS proof with sleep-set partial-order
  reduction, the naive baseline for reduction ratios, and the seeded
  random-walk violation hunt used by mutation runs.
- :mod:`invariants` — the first-class invariant catalog.
- :mod:`mutations` — seeded bugs proving each invariant bites.
- :mod:`counterexample` — ddmin minimization and bit-deterministic
  replayable JSON documents.
- :mod:`cli` — the ``python -m tpu_swirld_torch.analysis mc`` front end.

The checker is host code and loads no ``torch``; the card enters only
through :func:`tpu_swirld_torch.chaos.replay_counterexample`, whose
cross-engine row replays a clean document's final state on a device.
"""

from tpu_swirld_torch.analysis.mc.cli import main, mc_smoke, run_mc
from tpu_swirld_torch.analysis.mc.counterexample import replay, run_checked
from tpu_swirld_torch.analysis.mc.explore import ExploreResult, explore, hunt
from tpu_swirld_torch.analysis.mc.invariants import INVARIANTS, Violation, catalog
from tpu_swirld_torch.analysis.mc.mutations import MUTATIONS, make_world
from tpu_swirld_torch.analysis.mc.world import MCState, World

__all__ = [
    "ExploreResult", "INVARIANTS", "MCState", "MUTATIONS", "Violation",
    "World", "catalog", "explore", "hunt", "main", "make_world",
    "mc_smoke", "replay", "run_checked", "run_mc",
]
