"""Seeded-bug mutations: prove each invariant catches its regression.

The port's copy of the reference's
``tpu_swirld/analysis/mc/mutations.py``, over the port's ``Node`` seams and
its :class:`~tpu_swirld_torch.membership.dynamic.DynamicNode`.

A mutation is a small :class:`~tpu_swirld_torch.oracle.node.Node` subclass
that re-introduces a realistic consensus bug through one of the seams
the production node exposes (``_parent_round``, ``_on_fork_group``,
``_check_fork_budget``, ``_register_witness``).  Mutations apply to the
HONEST nodes only — attacker branches stay vanilla, so the checker is
demonstrating that a buggy implementation is caught, not that a buggy
adversary misbehaves.

Each mutation names the invariant expected to fire and ships a default
world sized so the hunt finds a witness in seconds; the CLI
(``--mutate <name>``) then minimizes the witness and proves the
minimized counterexample still reproduces the same violation through a
deterministic replay.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.oracle.node import Node

from tpu_swirld_torch.analysis.mc.world import World


@dataclasses.dataclass(frozen=True)
class Mutation:
    name: str
    expected_invariant: str
    describe: str
    #: default world shape where the bug is reachable quickly
    world_kwargs: dict
    make_node_cls: Callable[[], type]


def _round_skew_cls() -> type:
    class RoundSkewNode(Node):
        """Base round = MIN of parent rounds — the classic copy-paste
        regression; rounds stop being monotone along parent edges.

        Witness promotion masks a one-round skew (an event whose
        ancestry contains a round-r parent strongly sees that round's
        witnesses, so the +1 promotion heals ``min`` back to ``max``
        whenever parents differ by one round), which is exactly why
        this bug survives casual testing: it only bites when a laggard
        with a round-0 self-parent ingests a round-2+ other-parent.
        The default world makes that reachable in 5 events by weighting
        stakes (2,2,1) — the two heavy members ladder to round 2 in a
        4-event gossip ladder while the light member lags at its
        genesis, and the light member's first sync trips the skew."""

        def _parent_round(self, sp: bytes, op: bytes) -> int:
            return min(self.round[sp], self.round[op])

    return RoundSkewNode


def _fork_blind_cls() -> type:
    class ForkBlindNode(Node):
        """Never records fork groups: the equivocation ledger stays
        empty while ``by_seq`` plainly shows the fork pair."""

        def _on_fork_group(self, c: bytes, s: int, group: List[bytes]) -> None:
            pass

    return ForkBlindNode


def _disable_fork_budget_cls() -> type:
    class NoBudgetNode(Node):
        """Fork ledger intact but the 3f budget check is compiled out —
        more than f forked creators never trips ``budget_exhausted``."""

        def _check_fork_budget(self, c: bytes) -> None:
            pass

    return NoBudgetNode


def _dynamic_node_cls() -> type:
    from tpu_swirld_torch.membership.dynamic import DynamicNode

    return DynamicNode


def _epoch_skew_cls() -> type:
    from tpu_swirld_torch.membership.dynamic import DynamicNode

    class EpochSkewNode(DynamicNode):
        """Epoch activation off by one round: a decided membership tx
        takes effect one round later than the canonical rule — every
        honest node still *agrees* (the bug is deterministic), which is
        exactly why prefix-agreement can't catch it; only the epoch-
        purity invariant's canonical reconstruction does."""

        def _activation_round(self, round_received: int) -> int:
            return super()._activation_round(round_received) + 1

    return EpochSkewNode


def _skip_horizon_cls() -> type:
    class SkipHorizonNode(Node):
        """Quarantines witnesses that land below the node's current
        progress (the pre-horizon-rule bug shape): a straggler genesis
        arriving after this node reached round 1 is silently dropped
        from the witness registry, so peers with different arrival
        orders disagree."""

        def _register_witness(self, eid: bytes, r: int) -> None:
            if r < self.max_round:
                self.is_witness[eid] = False
                return
            super()._register_witness(eid, r)

    return SkipHorizonNode


MUTATIONS: Dict[str, Mutation] = {
    m.name: m
    for m in [
        Mutation(
            name="round-skew",
            expected_invariant="round-sanity",
            describe="base round = min(parent rounds) instead of max",
            world_kwargs=dict(
                n_honest=3, n_forkers=0, events=5,
                config=SwirldConfig(n_members=3, stake=(2, 2, 1)),
            ),
            make_node_cls=_round_skew_cls,
        ),
        Mutation(
            name="fork-blind",
            expected_invariant="fork-budget",
            describe="fork groups never recorded in the ledger",
            world_kwargs=dict(n_honest=2, n_forkers=1, events=3),
            make_node_cls=_fork_blind_cls,
        ),
        Mutation(
            name="disable-fork-budget",
            expected_invariant="fork-budget",
            describe="3f fork-budget check compiled out",
            # budget 6: exceeding f=1 forked creators needs BOTH forkers'
            # fork pairs visible at one honest node, and the sync height
            # hint only ships a sibling branch when branch lengths are
            # asymmetric (equal counts cancel the delta) — so each fork
            # costs three events: two on one branch, one on the other
            world_kwargs=dict(n_honest=2, n_forkers=2, events=6),
            make_node_cls=_disable_fork_budget_cls,
        ),
        Mutation(
            name="epoch-skew",
            expected_invariant="epoch-purity",
            describe="membership-tx activation round off by one",
            # a restake tx rides member 0's genesis; the ledger diverges
            # from the canonical reconstruction the moment the genesis
            # decides (~23 events in a 3-member gossip ladder) — budget
            # 30 leaves the weighted hunt slack for non-ladder detours
            world_kwargs=dict(
                n_honest=3, n_forkers=0, events=30,
                genesis_mtx={0: ("restake", 1, 3)},
                observer_cls=_dynamic_node_cls(),
            ),
            make_node_cls=_epoch_skew_cls,
        ),
        Mutation(
            name="skip-horizon",
            expected_invariant="horizon",
            describe="witnesses below current max_round quarantined "
                     "instead of registered",
            world_kwargs=dict(n_honest=4, n_forkers=0, events=4),
            make_node_cls=_skip_horizon_cls,
        ),
    ]
}


def make_world(mutate: str = None, **overrides) -> World:
    """World factory: vanilla when ``mutate`` is None, else the
    mutation's default shape (overridable) with its node class."""
    if mutate is None:
        return World(**overrides)
    mut = MUTATIONS[mutate]
    kw = dict(mut.world_kwargs)
    kw.update(overrides)
    return World(node_cls=mut.make_node_cls(), **kw)
