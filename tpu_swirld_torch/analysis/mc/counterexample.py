"""Counterexample pipeline: confirm, delta-debug, emit, replay.

The port's copy of the reference's
``tpu_swirld/analysis/mc/counterexample.py``.  It writes the reference's
document format, byte for byte: a document emitted by either package
replays in the other with the same violation, state digests and wire-trace
digest.

A violation found by the explorer comes with the schedule (action list)
that reached it.  This module (1) re-confirms the violation through the
live ``World.run_schedule`` path, (2) ddmin-minimizes the schedule to a
locally-irreducible witness that still triggers the SAME invariant,
(3) emits it as a self-contained JSON document (world parameters,
schedule, violation, per-node state digests, wire-trace digest, crypto
backend), and (4) replays such a document deterministically —
re-building the world from the recorded parameters and asserting the
replay reproduces the identical violation and identical
``Node.state_digest()`` bytes.  The chaos harness's
``replay_counterexample`` builds on :func:`replay` and adds the
cross-engine parity rows.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Tuple

from tpu_swirld_torch import crypto

from tpu_swirld_torch.analysis.mc.invariants import (
    Violation, check_edge, check_state,
)
from tpu_swirld_torch.analysis.mc.world import World


def _trace_digest(traces: List[tuple]) -> str:
    parts = [
        b"%d:%d:%s" % (s, d, c.encode()) for tr in traces for (s, d, c) in tr
    ]
    return crypto.hash_bytes(b"|".join(parts)).hex()[:32]


def run_checked(world: World, schedule: List[tuple]) -> Dict:
    """Live replay of ``schedule`` with the full invariant catalog
    evaluated after every step; stops at the first violation.

    Returns ``{"violation", "step", "digests", "trace_digest"}`` —
    digests are the honest roles' ``Node.state_digest()`` at the point
    the run stopped (violation or schedule end)."""
    found: List[Tuple[int, Violation]] = []
    traces: List[tuple] = []

    class _Stop(Exception):
        pass

    def on_step(step, state_after, result, parent_actor, actor):
        traces.append(result.trace)
        if world.roles[result.actor_role].kind == "honest":
            evs = check_edge(world, schedule[step], parent_actor, actor)
            if evs:
                found.append((step, evs[0]))
                raise _Stop
        vs = check_state(world, state_after)
        if vs:
            found.append((step, vs[0]))
            raise _Stop

    try:
        nodes = world.run_schedule(schedule, on_step=on_step)
    except _Stop:
        nodes = None
    if nodes is None:
        # re-run without checks to recover the node map at the stop
        # point (cheap: materialization caches are hot)
        stop = found[0][0] + 1
        nodes = world.run_schedule(schedule[:stop])
    digests = {
        str(i): nodes[i].state_digest().hex() for i in world.honest_roles
    }
    violation = found[0][1] if found else None
    return {
        "violation": violation,
        "step": found[0][0] if found else None,
        "digests": digests,
        "trace_digest": _trace_digest(traces),
        "_nodes": nodes,   # live role -> Node map; not JSON-serializable
    }


def ddmin(
    schedule: List[tuple],
    test: Callable[[List[tuple]], bool],
) -> List[tuple]:
    """Zeller/Hildebrandt ddmin over the action list: returns a
    1-minimal subsequence for which ``test`` still holds."""
    if not test(schedule):
        raise ValueError("ddmin: full schedule does not satisfy the test")
    n = 2
    while len(schedule) >= 2:
        size = len(schedule) // n
        reduced = False
        for i in range(n):
            lo, hi = i * size, (i + 1) * size if i < n - 1 else len(schedule)
            cand = schedule[:lo] + schedule[hi:]
            if cand and test(cand):
                schedule = cand
                n = max(n - 1, 2)
                reduced = True
                break
        if not reduced:
            if n >= len(schedule):
                break
            n = min(len(schedule), n * 2)
    return schedule


def minimize(world: World, schedule: List[tuple],
             invariant_id: str) -> List[tuple]:
    """ddmin the schedule down to a witness that still fires
    ``invariant_id``.  Reuses ``world`` across probes — the event table
    is append-only and the materialization caches stay hot, and actions
    whose prerequisites were removed degrade to no-ops, so every
    subsequence is a valid schedule."""

    def still_fails(cand: List[tuple]) -> bool:
        r = run_checked(world, list(cand))
        return r["violation"] is not None and (
            r["violation"].invariant == invariant_id
        )

    return list(ddmin(list(schedule), still_fails))


# ----------------------------------------------------------------- JSON


def emit(world: World, schedule: List[tuple], report: Dict,
         mutate: Optional[str] = None) -> Dict:
    """Self-contained replayable scenario document (the
    ``ChaosSimulation``-style JSON the chaos harness ingests).  With a
    violation in ``report`` this is a counterexample; with none it is a
    clean replayable schedule (the chaos ``--mc`` parity probe uses
    those), and replaying asserts it STAYS clean and bit-identical."""
    v: Optional[Violation] = report["violation"]
    return {
        "kind": "mc-counterexample",
        "version": 1,
        "world": {
            "n_honest": world.n_honest,
            "n_forkers": world.n_forkers,
            "events": world.events_budget,
            "seed": world.seed,
            "withhold": world.withhold,
            "stake": list(world.config.stakes()),
            "mutate": mutate,
            "crypto_backend": crypto.backend_name(),
        },
        "schedule": [list(a) for a in schedule],
        "violation": None if v is None else {
            **v.to_dict(),
            "step": report["step"],
        },
        "digests": report["digests"],
        "trace_digest": report["trace_digest"],
    }


def load_schedule(doc: Dict) -> List[tuple]:
    return [tuple(a) for a in doc["schedule"]]


def world_from_doc(doc: Dict) -> World:
    from tpu_swirld_torch.config import SwirldConfig

    from tpu_swirld_torch.analysis.mc.mutations import MUTATIONS, make_world

    w = doc["world"]
    kw = dict(
        n_honest=w["n_honest"],
        n_forkers=w["n_forkers"],
        events=w["events"],
        seed=w["seed"],
        withhold=w.get("withhold", False),
    )
    mutate = w.get("mutate")
    if w.get("stake") is not None:
        # a recorded stake distribution overrides even the mutation's
        # default config — the doc must replay in ITS world, not the
        # current default for that mutation
        default = None
        if mutate is not None:
            default = MUTATIONS[mutate].world_kwargs.get("config")
        stake = tuple(w["stake"])
        if default is None or default.stakes() != stake:
            kw["config"] = SwirldConfig(
                n_members=kw["n_honest"] + kw["n_forkers"],
                stake=stake, seed=w["seed"],
            )
    return make_world(mutate=mutate, **kw)


def replay(doc: Dict) -> Dict:
    """Replay a counterexample document from scratch and compare against
    its recorded violation and state digests, bit for bit.

    Returns a report with ``reproduced`` (violation id/role/message all
    match), ``digests_match`` and ``trace_match`` (exact determinism of
    the rebuilt world), and the fresh observations."""
    if doc.get("kind") != "mc-counterexample":
        raise ValueError("not an mc-counterexample document")
    want_backend = doc["world"].get("crypto_backend", "sim")
    prev = crypto.backend_name()
    crypto.set_backend(want_backend)
    try:
        world = world_from_doc(doc)
        report = run_checked(world, load_schedule(doc))
    finally:
        crypto.set_backend(prev)
    got_v = report["violation"]
    want_v = doc["violation"]
    if want_v is None:
        reproduced = got_v is None
    else:
        reproduced = (
            got_v is not None
            and got_v.invariant == want_v["invariant"]
            and got_v.role == want_v["role"]
            and got_v.message == want_v["message"]
            and report["step"] == want_v["step"]
        )
    return {
        "reproduced": reproduced,
        "digests_match": report["digests"] == doc["digests"],
        "trace_match": report["trace_digest"] == doc["trace_digest"],
        "violation": None if got_v is None else {
            **got_v.to_dict(), "step": report["step"],
        },
        "digests": report["digests"],
        "_world": world,           # not JSON-serializable
        "_nodes": report["_nodes"],
    }


def save(doc: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


def load(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)
