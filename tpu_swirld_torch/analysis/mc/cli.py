"""``python -m tpu_swirld_torch.analysis mc`` — the model-checker front end.

The port's copy of the reference's ``tpu_swirld/analysis/mc/cli.py``:
the same flags, report and exit status.

Vanilla runs are exhaustive proofs: explore every schedule of a small
world under the event budget, evaluate the invariant catalog everywhere,
and report the partial-order/symmetry reduction ratio against a naive
twin run.  ``--mutate <name>`` seeds a known bug and hunts (seeded
weighted random walks) for a witness, then minimizes it with ddmin and
proves the minimized counterexample replays to the identical violation
and state digests; ``--out`` saves the replayable JSON document.

Exit status: 0 = explored clean, 1 = violation found (including the
expected violation of a mutation run), 2 = state cap hit before the
space was exhausted (nothing proven either way).

The checker always runs on the ``sim`` crypto backend (deterministic
blake2b signatures — exploration mints thousands of events); the prior
backend is restored on exit and the counterexample document records the
backend so replays stay bit-identical.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

from tpu_swirld_torch import crypto

from tpu_swirld_torch.analysis.mc import counterexample as ce
from tpu_swirld_torch.analysis.mc.explore import explore, hunt as hunt_walks
from tpu_swirld_torch.analysis.mc.mutations import MUTATIONS, make_world

_DEFAULTS = dict(n_honest=3, n_forkers=0, events=3)


def run_mc(
    n: Optional[int] = None,
    forkers: Optional[int] = None,
    events: Optional[int] = None,
    mutate: Optional[str] = None,
    hunt: Optional[bool] = None,
    max_states: int = 200_000,
    withhold: bool = False,
    compare: bool = True,
    out: Optional[str] = None,
) -> dict:
    """Run one checker invocation; returns the JSON-ready report."""
    if mutate is not None and mutate not in MUTATIONS:
        raise SystemExit(
            f"unknown mutation {mutate!r}; have: {sorted(MUTATIONS)}"
        )
    base = dict(MUTATIONS[mutate].world_kwargs) if mutate else dict(_DEFAULTS)
    kw = dict(
        n_honest=n if n is not None else base["n_honest"],
        n_forkers=forkers if forkers is not None else base["n_forkers"],
        events=events if events is not None else base["events"],
        withhold=withhold,
    )
    if hunt is None:
        hunt = mutate is not None
    mode = "hunt" if hunt else "bfs"
    prev_backend = crypto.backend_name()
    crypto.set_backend("sim")
    try:
        world = make_world(mutate, **kw)
        t0 = time.perf_counter()
        if hunt:
            res = hunt_walks(world, seed=world.seed)
        else:
            res = explore(world, mode="bfs", max_states=max_states)
        elapsed = time.perf_counter() - t0
        report = {
            "mode": mode,
            "mutate": mutate,
            "world": {**kw, "seed": world.seed},
            "explore": res.to_dict(),
            "elapsed_s": round(elapsed, 3),
            "states_per_sec": round(res.states / elapsed) if elapsed else 0,
        }
        if res.violation is not None:
            confirm = ce.run_checked(world, res.schedule)
            if confirm["violation"] is None:
                raise RuntimeError(
                    "explorer violation did not reproduce through the "
                    "live schedule replay — checker bug"
                )
            minimized = ce.minimize(
                world, res.schedule, confirm["violation"].invariant
            )
            min_report = ce.run_checked(world, minimized)
            doc = ce.emit(world, minimized, min_report, mutate=mutate)
            replayed = ce.replay(doc)
            report["counterexample"] = {
                "schedule_len": len(res.schedule),
                "minimized_len": len(minimized),
                "violation": doc["violation"],
                "replay_reproduced": replayed["reproduced"],
                "replay_digests_match": replayed["digests_match"],
                "replay_trace_match": replayed["trace_match"],
                "document": doc,
            }
            if mutate is not None:
                report["counterexample"]["expected_invariant"] = (
                    MUTATIONS[mutate].expected_invariant
                )
                report["counterexample"]["caught_expected"] = (
                    doc["violation"]["invariant"]
                    == MUTATIONS[mutate].expected_invariant
                )
            if out:
                ce.save(doc, out)
                report["counterexample"]["saved_to"] = out
        elif compare and res.exhaustive and mutate is None:
            naive = explore(
                make_world(None, **kw), por=False, symmetry=False,
                mode=mode, max_states=max_states, check_invariants=False,
            )
            report["reduction"] = {
                "naive_states": naive.states,
                "naive_transitions": naive.transitions,
                "state_ratio": round(naive.states / max(res.states, 1), 2),
                "transition_ratio": round(
                    naive.transitions / max(res.transitions, 1), 2
                ),
            }
        return report
    finally:
        crypto.set_backend(prev_backend)


def mc_smoke(n: int = 3, events: int = 2, compare: bool = True) -> dict:
    """Small exhaustive run stamped into verdicts: explored
    states, states/sec, reduction ratio, and a clean/dirty flag."""
    rep = run_mc(n=n, forkers=0, events=events, compare=compare)
    red = rep.get("reduction", {})
    return {
        "n": n,
        "events": events,
        "states": rep["explore"]["states"],
        "transitions": rep["explore"]["transitions"],
        "states_per_sec": rep["states_per_sec"],
        "exhaustive": rep["explore"]["exhaustive"],
        "violations": rep["explore"]["violations_found"],
        "state_ratio": red.get("state_ratio"),
        "transition_ratio": red.get("transition_ratio"),
        "ok": (
            rep["explore"]["exhaustive"]
            and rep["explore"]["violations_found"] == 0
        ),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_swirld_torch.analysis mc",
        description="explicit-state model checker for the consensus core",
    )
    ap.add_argument("--n", type=int, default=None,
                    help="honest members (default 3, or the mutation's)")
    ap.add_argument("--forkers", type=int, default=None,
                    help="attacker members, two branches each")
    ap.add_argument("--events", type=int, default=None,
                    help="non-genesis event budget")
    ap.add_argument("--mutate", choices=sorted(MUTATIONS), default=None,
                    help="seed a known bug and hunt for its witness")
    ap.add_argument("--hunt", action="store_true",
                    help="random-walk hunt (default for --mutate; "
                         "exhaustive BFS otherwise)")
    ap.add_argument("--withhold", action="store_true",
                    help="enable the stale-parent withhold-extend action")
    ap.add_argument("--max-states", type=int, default=200_000)
    ap.add_argument("--no-compare", action="store_true",
                    help="skip the naive baseline / reduction report")
    ap.add_argument("--out", default=None,
                    help="write the minimized counterexample JSON here")
    ap.add_argument("--json", action="store_true",
                    help="print the full report as JSON")
    args = ap.parse_args(argv)

    report = run_mc(
        n=args.n, forkers=args.forkers, events=args.events,
        mutate=args.mutate, hunt=args.hunt or None,
        max_states=args.max_states, withhold=args.withhold,
        compare=not args.no_compare, out=args.out,
    )
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        ex = report["explore"]
        print(
            f"mc: {report['mode']} n={report['world']['n_honest']} "
            f"forkers={report['world']['n_forkers']} "
            f"events={report['world']['events']} -> "
            f"{ex['states']} states, {ex['transitions']} transitions "
            f"({report['states_per_sec']}/s), "
            f"exhaustive={ex['exhaustive']}"
        )
        if "reduction" in report:
            r = report["reduction"]
            print(
                f"mc: reduction vs naive: {r['state_ratio']}x states "
                f"({r['naive_states']}), {r['transition_ratio']}x "
                f"transitions ({r['naive_transitions']})"
            )
        cex = report.get("counterexample")
        if cex:
            v = cex["violation"]
            print(
                f"mc: VIOLATION {v['invariant']} at role {v['role']} "
                f"(step {v['step']}): {v['message']}"
            )
            print(
                f"mc: counterexample minimized {cex['schedule_len']} -> "
                f"{cex['minimized_len']} actions; replay reproduced="
                f"{cex['replay_reproduced']} digests_match="
                f"{cex['replay_digests_match']}"
            )
            if "caught_expected" in cex:
                print(
                    f"mc: mutation {report['mutate']} expected "
                    f"{cex['expected_invariant']}: caught="
                    f"{cex['caught_expected']}"
                )
        elif ex["violations_found"] == 0 and ex["exhaustive"]:
            print("mc: all invariants hold over the explored space")
    if report["explore"]["violations_found"]:
        return 1
    if not report["explore"]["exhaustive"]:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
