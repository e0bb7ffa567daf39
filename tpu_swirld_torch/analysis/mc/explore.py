"""Explicit-state exploration with partial-order and symmetry reduction.

The port's copy of the reference's ``tpu_swirld/analysis/mc/explore.py``.

The search enumerates every reachable interleaving of the world's
actions up to the event budget, deduplicating on the canonical state key
(see :mod:`encode`) and evaluating the full invariant catalog at every
state and transition.

Partial-order reduction (sleep-set style, adjacent-rule):
from a state reached by last action ``b``, an enabled action ``a`` is
skipped iff ``a`` is independent of ``b`` (disjoint read/write role
footprints — see ``World.independent``) and ``a < b`` in the fixed total
order on actions.  The words that survive are exactly those with no
descending adjacent independent pair, i.e. the lexicographically
normal forms of Mazurkiewicz traces; the set of normal forms is
prefix-closed and contains one representative per trace, so every
reachable STATE is still visited — only redundant commuting orders are
pruned.  (Independence here is exact, not approximate: independent
actions touch disjoint node states and the budget decrement commutes.)

Bookkeeping makes the pruning sound under dedup: each visited canonical
key remembers which actions it has expanded; when a state is re-reached
through a different last action, only the newly-allowed actions run, and
when it is reached as a symmetry-equivalent twin (same canonical key,
different concrete digest), the full enabled set is re-offered
(conservative — the permutation need not respect the last-action
order).

``symmetry=False, por=False`` gives the naive baseline used for the
reduction-ratio report; both modes explore the same reachable state
space, which the smoke test asserts.
"""

from __future__ import annotations

import dataclasses
import random
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

from tpu_swirld_torch.analysis.mc.encode import StateEncoder
from tpu_swirld_torch.analysis.mc.invariants import (
    Violation, check_edge, check_state,
)
from tpu_swirld_torch.analysis.mc.world import MCState, World


@dataclasses.dataclass
class ExploreResult:
    states: int = 0
    transitions: int = 0
    noops: int = 0
    dedup_hits: int = 0
    symmetry_hits: int = 0
    por_skips: int = 0
    max_depth: int = 0
    exhaustive: bool = True
    violation: Optional[Violation] = None
    #: schedule (list of actions) reaching the violating state
    schedule: Optional[List[tuple]] = None
    violation_step: Optional[int] = None

    def to_dict(self) -> dict:
        d = {
            "states": self.states,
            "transitions": self.transitions,
            "noops": self.noops,
            "dedup_hits": self.dedup_hits,
            "symmetry_hits": self.symmetry_hits,
            "por_skips": self.por_skips,
            "max_depth": self.max_depth,
            "exhaustive": self.exhaustive,
            "violations_found": 0 if self.violation is None else 1,
        }
        if self.violation is not None:
            d["violation"] = self.violation.to_dict()
            d["schedule_len"] = len(self.schedule or [])
        return d


class _Record:
    __slots__ = ("concrete", "expanded")

    def __init__(self, concrete: bytes):
        self.concrete = concrete
        self.expanded: Set[tuple] = set()


def _act_key(action: tuple) -> tuple:
    return (action[0],) + tuple(action[1:])


def explore(
    world: World,
    *,
    por: bool = True,
    symmetry: bool = True,
    mode: str = "bfs",
    max_states: int = 200_000,
    check_invariants: bool = True,
) -> ExploreResult:
    """Explore ``world`` from its initial state.

    ``mode="bfs"`` is the exhaustive proof search (shortest
    counterexamples); ``mode="dfs"`` is the hunt mode used for mutation
    runs — creations first, stops at the first violation.  Exceeding
    ``max_states`` clears ``exhaustive`` and returns what was proven.
    """
    enc = StateEncoder(world, symmetry=symmetry)
    res = ExploreResult()
    visited: Dict[bytes, _Record] = {}
    edge_checked: Set[tuple] = set()

    init = world.initial_state()
    init_concrete, init_key = enc.state_keys(init)
    visited[init_key] = _Record(init_concrete)
    res.states = 1
    if check_invariants:
        vs = check_state(world, init)
        if vs:
            res.violation, res.schedule, res.violation_step = vs[0], [], -1
            return res

    # queue entries: (state, key, path, last_action or None)
    Item = Tuple[MCState, bytes, Tuple[tuple, ...], Optional[tuple]]
    queue: deque = deque()
    queue.append((init, init_key, (), None))
    pop = queue.popleft if mode == "bfs" else queue.pop

    while queue:
        state, key, path, last = pop()
        rec = visited[key]
        enabled = world.enabled_actions(state)
        if por and last is not None:
            kept = []
            for a in enabled:
                if (
                    World.independent(a, last)
                    and _act_key(a) < _act_key(last)
                ):
                    res.por_skips += 1
                else:
                    kept.append(a)
            enabled = kept
        if mode == "dfs":
            # hunt heuristic: expand event-creating actions last so the
            # DFS stack pops them first
            enabled.sort(key=lambda a: a[0] in ("sync", "ext", "wext"))
        for action in enabled:
            if action in rec.expanded:
                res.dedup_hits += 1
                continue
            rec.expanded.add(action)
            result = world.apply(state, action)
            if result.noop:
                res.noops += 1
                continue
            res.transitions += 1
            child, child_path = result.state, path + (action,)
            res.max_depth = max(res.max_depth, len(child_path))
            if check_invariants:
                actor_role = action[1]
                tkey = world.transition_key(state, action)
                if (
                    world.roles[actor_role].kind == "honest"
                    and tkey not in edge_checked
                ):
                    edge_checked.add(tkey)
                    parent_node = world.node_for(
                        actor_role, state.histories[actor_role])
                    child_node = world.node_for(
                        actor_role, child.histories[actor_role])
                    evs = check_edge(world, action, parent_node, child_node)
                    if evs:
                        res.violation = evs[0]
                        res.schedule = list(child_path)
                        res.violation_step = len(child_path) - 1
                        return res
            child_concrete, child_key = enc.state_keys(child)
            crec = visited.get(child_key)
            if crec is None:
                visited[child_key] = _Record(child_concrete)
                res.states += 1
                if check_invariants:
                    vs = check_state(world, child)
                    if vs:
                        res.violation = vs[0]
                        res.schedule = list(child_path)
                        res.violation_step = len(child_path) - 1
                        return res
                if res.states >= max_states:
                    res.exhaustive = False
                    return res
                queue.append((child, child_key, child_path, action))
            else:
                res.dedup_hits += 1
                if crec.concrete != child_concrete:
                    # symmetry-equivalent twin: the recorded expansions
                    # were made under a different labeling, so re-offer
                    # everything not yet expanded, with POR disabled for
                    # this arrival (conservative)
                    res.symmetry_hits += 1
                    queue.append((child, child_key, child_path, None))
                else:
                    # same state via a different last action: its sleep
                    # set differs, so re-offer — the expanded set on the
                    # record keeps this from re-running transitions, and
                    # every enqueue is paid for by one executed
                    # transition, so the loop terminates
                    queue.append((child, child_key, child_path, action))
    return res


def hunt(
    world: World,
    *,
    walks: int = 4000,
    max_steps: Optional[int] = None,
    seed: int = 0,
) -> ExploreResult:
    """Violation hunt by seeded weighted random walks (the mutation
    mode).  Each walk samples actions with ``World.hunt_weight`` bias
    (creation-heavy, gossip-ladder-friendly) and evaluates the full
    invariant catalog after every step; distinct states and transitions
    are only checked once across all walks (the transition memo makes
    revisits near-free).  Deterministic for a fixed ``(world, seed)``.
    Returns on the first violation with the reaching schedule;
    ``exhaustive`` is always False — this is a search, not a proof."""
    rng = random.Random(seed ^ 0x5EED)
    cap = max_steps if max_steps is not None else world.events_budget + 10
    res = ExploreResult(exhaustive=False)
    edge_checked: Set[tuple] = set()
    state_checked: Set[MCState] = set()

    init = world.initial_state()
    state_checked.add(init)
    res.states = 1
    vs = check_state(world, init)
    if vs:
        res.violation, res.schedule, res.violation_step = vs[0], [], -1
        return res

    for _ in range(walks):
        state = init
        path: List[tuple] = []
        for _step in range(cap):
            enabled = world.enabled_actions(state)
            if not enabled:
                break
            weights = [world.hunt_weight(state, a) for a in enabled]
            action = rng.choices(enabled, weights=weights)[0]
            result = world.apply(state, action)
            if result.noop:
                res.noops += 1
                continue
            path.append(action)
            child = result.state
            res.max_depth = max(res.max_depth, len(path))
            tkey = world.transition_key(state, action)
            if tkey not in edge_checked:
                edge_checked.add(tkey)
                res.transitions += 1
                if world.roles[action[1]].kind == "honest":
                    evs = check_edge(
                        world, action,
                        world.node_for(action[1], state.histories[action[1]]),
                        world.node_for(action[1], child.histories[action[1]]),
                    )
                    if evs:
                        res.violation = evs[0]
                        res.schedule = list(path)
                        res.violation_step = len(path) - 1
                        return res
            if child not in state_checked:
                state_checked.add(child)
                res.states += 1
                vs = check_state(world, child)
                if vs:
                    res.violation = vs[0]
                    res.schedule = list(path)
                    res.violation_step = len(path) - 1
                    return res
            else:
                res.dedup_hits += 1
            state = child
    return res


def compare_reductions(world_factory, **kw) -> dict:
    """Run reduced vs naive exploration on twin worlds and report the
    state/transition reduction ratios.  ``world_factory`` must build a
    fresh, identically-parameterized world per call."""
    reduced = explore(world_factory(), por=True, symmetry=True, **kw)
    naive = explore(world_factory(), por=False, symmetry=False, **kw)
    out = {
        "reduced": reduced.to_dict(),
        "naive": naive.to_dict(),
        "state_ratio": (
            naive.states / reduced.states if reduced.states else 0.0
        ),
        "transition_ratio": (
            naive.transitions / reduced.transitions
            if reduced.transitions else 0.0
        ),
        "same_coverage": (
            reduced.exhaustive and naive.exhaustive
            and reduced.violation is None and naive.violation is None
        ),
    }
    return out
