"""First-class invariant catalog for the model checker.

The port's copy of the reference's
``tpu_swirld/analysis/mc/invariants.py``: the same catalog, in the same
order.

Every invariant is a named predicate over either a *state* (evaluated on
the honest nodes materialized at that state, plus a fresh-observer union
replay) or an *edge* (the acting node before vs. after one transition —
monotonicity properties live here, because "decided fame never flips" is
a statement about consecutive views of ONE node, not about a single
snapshot).  The checker evaluates the full catalog at every explored
state/transition; a violation carries the invariant id, the offending
role, and a human-readable message, and becomes the seed of the
counterexample pipeline.

Catalog
-------
- ``prefix-agreement`` (state): any two honest nodes' decided orders
  agree on their common prefix — THE safety property.
- ``union-replay`` (state): each honest node's decided order is a
  prefix of a fresh observer's single-pass replay of the union of all
  honest views, and round/witness/fame metadata agree per event with
  that observer (purity of the consensus functions in the DAG).
- ``fame-once`` (edge): along every transition the acting node's
  per-event round, witness flag, witness slot, decided fame, receive
  round, and consensus timestamp never change once set, and the decided
  order only appends.
- ``round-sanity`` (state): rounds are monotone along parent edges,
  genesis rounds are 0, and no round exceeds ``max_round``.
- ``horizon`` (state): the expiry-horizon rule is sound — zero
  ``horizon_violations``, EVERY event satisfying the witness predicate
  is flagged and registered (``wit_slot`` / ``wit_list`` / ``witnesses``
  all agree), however late it arrived, and late registrations are a
  subset of registered witnesses.
- ``fork-budget`` (state): the fork ledger matches ground truth
  recomputed from ``by_seq`` (flagged creators are exactly those with a
  multi-event seq group, and only attacker members), the equivocation
  counter counts fork groups, and the 3f budget trips iff the number of
  forked creators exceeds ``f = (n-1)//3``.
- ``epoch-purity`` (state, dynamic membership): each honest node's epoch
  ledger equals the canonical reconstruction from its own decided prefix
  (canonical activation rule), and no recorded fame tally counted stake
  from any epoch other than the one governing its voting round.
- ``counter-consistency`` (state): over a reliable transport every
  pathology counter (bad replies/requests, retries, circuit opens,
  withholding, capped branches, quarantines) is zero and the orphan
  buffer is fully drained — nonzero means a protocol/codec bug, and a
  drained buffer is also what licenses the checker's state abstraction
  (ingest histories capture everything a node holds).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional

from tpu_swirld_torch.oracle.node import Node

from tpu_swirld_torch.analysis.mc.world import MCState, World


@dataclasses.dataclass(frozen=True)
class Violation:
    invariant: str
    role: Optional[int]
    message: str

    def to_dict(self) -> dict:
        return {
            "invariant": self.invariant,
            "role": self.role,
            "message": self.message,
        }


def _short(eid: bytes) -> str:
    return eid.hex()[:12]


# --------------------------------------------------------------- state


def _honest_nodes(world: World, state: MCState) -> Dict[int, Node]:
    return {
        i: world.node_for(i, state.histories[i])
        for i in world.honest_roles
    }


def check_prefix_agreement(world: World, state: MCState,
                           nodes: Dict[int, Node]) -> List[Violation]:
    out: List[Violation] = []
    roles = sorted(nodes)
    for a in roles:
        for b in roles:
            if b <= a:
                continue
            ca, cb = nodes[a].consensus, nodes[b].consensus
            m = min(len(ca), len(cb))
            for k in range(m):
                if ca[k] != cb[k]:
                    out.append(Violation(
                        "prefix-agreement", a,
                        f"honest {a} and {b} diverge at decided index {k}: "
                        f"{_short(ca[k])} vs {_short(cb[k])}",
                    ))
                    break
    return out


def check_union_replay(world: World, state: MCState,
                       nodes: Dict[int, Node]) -> List[Violation]:
    out: List[Violation] = []
    obs = world.union_observer(state)
    for i, node in nodes.items():
        co, cn = obs.consensus, node.consensus
        if cn != co[: len(cn)]:
            out.append(Violation(
                "union-replay", i,
                f"honest {i}'s decided order is not a prefix of the "
                f"union replay ({len(cn)} vs {len(co)} decided)",
            ))
            continue
        for eid in node.hg:
            if node.round.get(eid) != obs.round.get(eid):
                out.append(Violation(
                    "union-replay", i,
                    f"round disagrees with union replay on "
                    f"{_short(eid)}: {node.round.get(eid)} vs "
                    f"{obs.round.get(eid)}",
                ))
                break
            if node.is_witness.get(eid) != obs.is_witness.get(eid):
                out.append(Violation(
                    "union-replay", i,
                    f"witness flag disagrees with union replay on "
                    f"{_short(eid)}",
                ))
                break
            fn, fo = node.famous.get(eid), obs.famous.get(eid)
            if fn is not None and fo is not None and fn != fo:
                out.append(Violation(
                    "union-replay", i,
                    f"fame decided both ways on {_short(eid)}: "
                    f"{fn} here vs {fo} in union replay",
                ))
                break
    return out


def check_round_sanity(world: World, state: MCState,
                       nodes: Dict[int, Node]) -> List[Violation]:
    out: List[Violation] = []
    for i, node in nodes.items():
        for eid, ev in node.hg.items():
            r = node.round.get(eid)
            if not ev.p:
                if r != 0:
                    out.append(Violation(
                        "round-sanity", i,
                        f"genesis {_short(eid)} has round {r} != 0",
                    ))
                continue
            pr = max(node.round[p] for p in ev.p)
            if r is None or r < pr:
                out.append(Violation(
                    "round-sanity", i,
                    f"round not monotone at {_short(eid)}: round {r} < "
                    f"max parent round {pr}",
                ))
            if r is not None and r > node.max_round:
                out.append(Violation(
                    "round-sanity", i,
                    f"round {r} of {_short(eid)} exceeds max_round "
                    f"{node.max_round}",
                ))
    return out


def _witness_predicate(node: Node, eid: bytes) -> bool:
    ev = node.hg[eid]
    if not ev.p:
        return True
    return node.round[ev.p[0]] < node.round[eid]


def check_horizon(world: World, state: MCState,
                  nodes: Dict[int, Node]) -> List[Violation]:
    out: List[Violation] = []
    for i, node in nodes.items():
        if node.horizon_violations:
            out.append(Violation(
                "horizon", i,
                f"{node.horizon_violations} late witness(es) decided "
                f"famous — expiry horizon unsound",
            ))
        for eid in node.hg:
            pred = _witness_predicate(node, eid)
            flag = node.is_witness.get(eid, False)
            if pred != flag:
                out.append(Violation(
                    "horizon", i,
                    f"witness flag wrong on {_short(eid)}: predicate "
                    f"{pred} but flagged {flag} (late/low-round events "
                    f"must still register)",
                ))
                continue
            if pred:
                r = node.round[eid]
                slot = node.wit_slot.get(eid)
                lst = node.wit_list.get(r, [])
                if (
                    slot is None
                    or slot >= len(lst)
                    or lst[slot] != eid
                    or eid not in node.witnesses.get(r, {}).get(
                        node.hg[eid].c, [])
                ):
                    out.append(Violation(
                        "horizon", i,
                        f"witness {_short(eid)} (round {r}) not "
                        f"registered in wit_slot/wit_list/witnesses — "
                        f"a quarantined witness breaks node agreement",
                    ))
        for eid in node.late_witnesses:
            if eid not in node.wit_slot:
                out.append(Violation(
                    "horizon", i,
                    f"late witness {_short(eid)} missing from wit_slot",
                ))
    return out


def check_fork_budget(world: World, state: MCState,
                      nodes: Dict[int, Node]) -> List[Violation]:
    out: List[Violation] = []
    f_budget = (len(world.members) - 1) // 3
    for i, node in nodes.items():
        truth_groups = 0
        truth_forked = set()
        for m in world.members:
            groups = [
                g for g in node.by_seq[m].values() if len(g) >= 2
            ]
            truth_groups += len(groups)
            if groups:
                truth_forked.add(m)
            if node.has_fork[m] != bool(groups):
                out.append(Violation(
                    "fork-budget", i,
                    f"fork ledger wrong for member "
                    f"{world.members.index(m)}: by_seq shows "
                    f"{len(groups)} fork group(s) but has_fork is "
                    f"{node.has_fork[m]}",
                ))
        bad = truth_forked - set(world.byz_members)
        if bad:
            out.append(Violation(
                "fork-budget", i,
                f"honest member(s) {sorted(world.members.index(m) for m in bad)} "
                f"appear forked — honest chains must be linear",
            ))
        if node.forks_detected != len(truth_forked):
            out.append(Violation(
                "fork-budget", i,
                f"forks_detected={node.forks_detected} but "
                f"{len(truth_forked)} creator(s) actually forked",
            ))
        if node.equivocations_detected != truth_groups:
            out.append(Violation(
                "fork-budget", i,
                f"equivocations_detected={node.equivocations_detected} "
                f"but {truth_groups} fork group(s) exist",
            ))
        tripped = node.budget_exhausted > 0
        should = len(truth_forked) > f_budget
        if tripped != should:
            out.append(Violation(
                "fork-budget", i,
                f"3f budget accounting wrong: {len(truth_forked)} forked "
                f"creator(s) vs f={f_budget}, but budget_exhausted="
                f"{node.budget_exhausted}",
            ))
    return out


def check_epoch_purity(world: World, state: MCState,
                       nodes: Dict[int, Node]) -> List[Violation]:
    """Dynamic membership: (1) each honest node's epoch ledger equals the
    canonical reconstruction from its own decided prefix through the
    canonical activation rule — any skew in the node's incremental
    adoption path (e.g. an off-by-one activation round) is a detectable
    divergence; (2) every recorded fame tally counted stake from exactly
    the epoch governing its voting round — no decision mixes stake from
    two epochs.  Vacuous for static-membership worlds."""
    from tpu_swirld_torch.membership.epoch import (
        DEFAULT_DELAY, ledger_from_decided,
    )

    out: List[Violation] = []
    for i, node in nodes.items():
        ledger = getattr(node, "ledger", None)
        if ledger is None:
            return []
        delay = getattr(node, "membership_delay", DEFAULT_DELAY)
        canon = ledger_from_decided(
            (
                (x, node.hg[x].d, node.round_received[x])
                for x in node.consensus
            ),
            node._genesis_members, node._genesis_stake, delay,
        )
        if not canon.same_epochs(ledger):
            got = [
                (e.epoch_id, e.activation_round, e.stake)
                for e in ledger.epochs
            ]
            want = [
                (e.epoch_id, e.activation_round, e.stake)
                for e in canon.epochs
            ]
            out.append(Violation(
                "epoch-purity", i,
                f"honest {i}'s epoch ledger diverges from the canonical "
                f"reconstruction of its decided prefix: {got} vs "
                f"canonical {want}",
            ))
            continue
        for x, ry, tallied in getattr(node, "fame_epoch_log", []):
            governing = ledger.epoch_at(ry - 1).epoch_id
            if tallied != governing:
                out.append(Violation(
                    "epoch-purity", i,
                    f"fame of {_short(x)} tallied at voting round {ry} "
                    f"with epoch {tallied} stake but epoch {governing} "
                    f"governs round {ry - 1} — decision mixes epochs",
                ))
                break
    return out


def check_counters(world: World, state: MCState,
                   nodes: Dict[int, Node]) -> List[Violation]:
    out: List[Violation] = []
    for i, node in nodes.items():
        for name in (
            "bad_replies", "bad_requests", "retries",
            "withholding_suspected", "sync_branches_capped",
            "orphans_parked",
        ):
            v = getattr(node, name)
            if v:
                out.append(Violation(
                    "counter-consistency", i,
                    f"{name}={v} on honest {i} over a reliable "
                    f"transport — protocol/codec bug (and a parked "
                    f"orphan would break the history abstraction)",
                ))
        # breaker activity is legitimate EXACTLY when the fork machinery
        # drove it: a proven (or over-budget) equivocator is cut off by
        # design even with quarantine_forkers off.  Every quarantined
        # peer must therefore be a detected-forked byzantine creator,
        # and with no forks detected the breaker must be silent.
        justified = {
            c for c, forked in node.has_fork.items()
            if forked and c in world.byz_members and c != node.pk
        }
        quarantined = (
            set(node.breaker.quarantined()) if node.breaker else set()
        )
        if not quarantined <= justified:
            out.append(Violation(
                "counter-consistency", i,
                f"honest {i} quarantined {len(quarantined - justified)} "
                f"peer(s) with no detected fork to justify the cut",
            ))
        open_budget = node.equivocations_detected + node.forks_detected
        if node.circuit_opens > open_budget:
            out.append(Violation(
                "counter-consistency", i,
                f"circuit_opens={node.circuit_opens} on honest {i} "
                f"exceeds the fork-machinery budget {open_budget} — the "
                f"breaker fired on honest traffic",
            ))
    return out


# ---------------------------------------------------------------- edge


def check_fame_once(world: World, action: tuple,
                    parent: Node, child: Node) -> List[Violation]:
    """Monotonicity of the acting node across one transition."""
    out: List[Violation] = []
    role = action[1]

    def bad(msg: str) -> None:
        out.append(Violation("fame-once", role, msg))

    if child.consensus[: len(parent.consensus)] != parent.consensus:
        bad(
            f"decided order rewrote itself across {action!r}: "
            f"{len(parent.consensus)} decided before, prefix differs after"
        )
    for eid, f in parent.famous.items():
        if f is not None and child.famous.get(eid) != f:
            bad(
                f"fame of {_short(eid)} decided twice: {f} then "
                f"{child.famous.get(eid)} across {action!r}"
            )
    for attr in ("round", "is_witness", "wit_slot",
                 "round_received", "consensus_ts"):
        pa, ch = getattr(parent, attr), getattr(child, attr)
        for eid, v in pa.items():
            if eid in ch and ch[eid] != v:
                bad(
                    f"{attr}[{_short(eid)}] changed {v} -> {ch[eid]} "
                    f"across {action!r}"
                )
                break
    return out


# ------------------------------------------------------------- catalog


class Invariant(NamedTuple):
    id: str
    kind: str          # "state" | "edge"
    fn: Callable
    describe: str


# Catalog order matters for reporting: ``check_state`` returns
# violations in this order, and the explorer surfaces the FIRST one —
# so local, single-node diagnoses (a wrong round, a missing witness
# flag, a fork-ledger mismatch) come before the global agreement
# invariants, which almost any local bug eventually also trips.
INVARIANTS: List[Invariant] = [
    Invariant("round-sanity", "state", check_round_sanity,
              "rounds are parent-monotone, geneses are round 0, nothing "
              "exceeds max_round"),
    Invariant("horizon", "state", check_horizon,
              "expiry horizon sound: every witness-predicate event is "
              "flagged and registered however late it arrives"),
    Invariant("fork-budget", "state", check_fork_budget,
              "fork ledger == ground truth from by_seq; 3f budget trips "
              "iff forked creators exceed f"),
    Invariant("epoch-purity", "state", check_epoch_purity,
              "epoch ledger equals the canonical reconstruction from the "
              "decided prefix; no fame tally mixes stake from two epochs"),
    Invariant("counter-consistency", "state", check_counters,
              "all pathology counters zero and orphans drained over a "
              "reliable transport"),
    Invariant("fame-once", "edge", check_fame_once,
              "per-event consensus metadata is write-once and the decided "
              "order append-only along every transition"),
    Invariant("prefix-agreement", "state", check_prefix_agreement,
              "honest decided orders agree on their common prefix"),
    Invariant("union-replay", "state", check_union_replay,
              "each honest order is a prefix of the fresh-observer union "
              "replay; round/witness/fame metadata agree per event"),
]


def catalog() -> List[Invariant]:
    return list(INVARIANTS)


def check_state(world: World, state: MCState) -> List[Violation]:
    nodes = _honest_nodes(world, state)
    out: List[Violation] = []
    for inv in INVARIANTS:
        if inv.kind == "state":
            out.extend(inv.fn(world, state, nodes))
    return out


def check_edge(world: World, action: tuple,
               parent: Node, child: Node) -> List[Violation]:
    out: List[Violation] = []
    if world.roles[action[1]].kind != "honest":
        return out
    for inv in INVARIANTS:
        if inv.kind == "edge":
            out.extend(inv.fn(world, action, parent, child))
    return out
