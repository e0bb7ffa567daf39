"""Seeded chaos scenario runner emitting a JSON verdict (the port's copy of
the reference's ``scripts/chaos_run.py``).

Runs one :class:`tpu_swirld_torch.chaos.ChaosSimulation` (a lossy,
reordering transport, one scheduled partition and heal, one crash and
checkpoint restart, optional equivocating forkers) and writes the verdict
(safety, liveness, fault counters, the cross-engine parity row) as JSON.
The exit status is 0 iff the verdict is ok.

Reproduce any run from its seeds:

    python -m tpu_swirld_torch.chaos_run --seed 7 --plan-seed 7 --out verdict.json

``--device`` (default ``cuda``, which fails without a GPU) is where the
engine replays and the storms' device runs go; ``--device cpu`` runs the
kernels' plain versions.  Named scenarios (``--scenario``) come from
:data:`tpu_swirld_torch.adversary.SCENARIOS`: the active-byzantine suite
(``equivocation_storm``, ``censorship``, ``delayed_release``,
``fork_bomb``, ``fork_bomb_overbudget``) and the storms (``horizon_storm``,
``overflow_storm``, ``membership_churn``).  ``--scenario list`` prints the
registry; ``--all`` runs every scenario and writes one verdict gated on
all of them.  ``--mc`` folds in a model-checker section
(:mod:`tpu_swirld_torch.analysis.mc`): the exhaustive smoke world, one
seeded mutation with its minimized counterexample, and a clean schedule
document replayed through
:func:`~tpu_swirld_torch.chaos.replay_counterexample`, whose cross-engine
row runs on ``--device``.  ``--sanitize [N]`` re-runs the scenario under N
seeded yield-injection schedules (:mod:`tpu_swirld_torch.analysis.races`),
each of which must reproduce the base verdict's safety fingerprint, and
fuzzes the archive's pack worker with rows on ``--device``.

The default schedule scales with ``--turns``: a partition cuts the first
two members off during the middle third; the last member crashes at 1/4
and restarts at 1/2.  An obs trace with the resilience counters is written
next to the verdict (render it with ``python -m tpu_swirld_torch.obs
report``).
"""

import argparse
import json
import os
import sys
import tempfile

from tpu_swirld_torch import obs
from tpu_swirld_torch.adversary import SCENARIOS
from tpu_swirld_torch.chaos import ChaosScenario, ChaosSimulation, _engines_agree
from tpu_swirld_torch.metrics import Metrics
from tpu_swirld_torch.transport import FaultPlan, LinkFaults, Partition


def build_scenario(args) -> ChaosScenario:
    t = args.turns
    plan = FaultPlan(
        seed=args.plan_seed,
        default=LinkFaults(
            drop=args.drop,
            corrupt=args.corrupt,
            duplicate=args.duplicate,
            reorder=args.reorder,
            delay=args.delay,
        ),
        partitions=[Partition(start=t // 3, end=2 * t // 3, group=(0, 1))],
        crashes={args.nodes - 1: [(t // 4, t // 2)]},
    )
    return ChaosScenario(
        n_nodes=args.nodes,
        n_turns=t,
        seed=args.seed,
        n_forkers=args.forkers,
        plan=plan,
        checkpoint_every=args.checkpoint_every,
    )


def _flightrec(args):
    """--flightrec-dir: one black-box recorder per scenario run.  Red
    verdicts (and in-run anomalies: breaker opens, overflow heals, rebase
    storms) auto-dump self-contained post-mortem JSONs into the
    directory; ``None`` when the flag is off keeps recording disabled."""
    if not getattr(args, "flightrec_dir", None):
        return None
    from tpu_swirld_torch.obs.flightrec import FlightRecorder

    return FlightRecorder(dump_dir=args.flightrec_dir)


def flightrec_dumps_by_trace(dump_dir) -> dict:
    """Group the post-mortem dumps in ``dump_dir`` by the trace id each
    one embedded at dump time (snapshots carry ``trace_id`` /
    ``node_name``), so a red verdict's forensics index to the trace that
    was in flight.  Dumps outside any traced span group under
    ``"untraced"``."""
    from tpu_swirld_torch.obs.flightrec import load_dump

    out: dict = {}
    if not dump_dir or not os.path.isdir(dump_dir):
        return out
    for name in sorted(os.listdir(dump_dir)):
        if not (name.startswith("flightrec_") and name.endswith(".json")):
            continue
        path = os.path.join(dump_dir, name)
        try:
            body = load_dump(path)
        except (OSError, ValueError):
            continue
        trace = body.get("trace_id") or "untraced"
        out.setdefault(trace, []).append({
            "path": path,
            "node_name": body.get("node_name"),
            "reason": body.get("reason"),
        })
    return out


def _run_acceptance(args, ckpt_dir, o) -> dict:
    """The composed fault scenario: lossy/reordering transport, one
    scheduled partition + heal, one crash + checkpoint-restart, optional
    equivocating forkers; cross-engine parity over the surviving DAG."""
    sim = ChaosSimulation(
        build_scenario(args), ckpt_dir, metrics=Metrics(o.registry),
        flightrec=_flightrec(args), device=args.device,
    )
    verdict = sim.run()
    # cross-engine parity over the chaos-shaped DAG: the most complete
    # honest node's history replayed through the chosen windowed driver
    # must match batch and oracle
    probe = max(sim._live_honest(), key=lambda n: len(n.hg))
    engines = _engines_agree(probe, engine=args.engine, device=args.device)
    verdict["engines"] = engines
    verdict["ok"] = bool(
        verdict["ok"]
        and engines["batch_oracle_parity"]
        and engines["incremental_batch_parity"]
    )
    if not verdict["ok"] and not verdict.get("flightrec_dump"):
        verdict["flightrec_dump"] = sim.flightrec_postmortem(verdict)
    return verdict


def _adapt(fn):
    """Registry runner -> CLI runner: scenarios registered in
    :data:`tpu_swirld_torch.adversary.SCENARIOS` share the uniform signature
    ``fn(ckpt_dir, seed=, engine=, metrics=, flightrec=, device=)``;
    ``--seed`` left at its default passes ``None`` so each scenario keeps
    its pinned seed."""
    def run(args, ckpt_dir, o) -> dict:
        return fn(
            ckpt_dir, seed=args.seed, engine=args.engine,
            metrics=Metrics(o.registry), flightrec=_flightrec(args),
            device=args.device,
        )
    return run


#: CLI scenario registry: name -> runner(args, ckpt_dir, o).  Everything
#: registered in tpu_swirld_torch.adversary.SCENARIOS (the byzantine strategy
#: suite plus the named storms) auto-appears in --scenario and --all;
#: only the composed acceptance scenario needs the full argparse surface.
RUNNERS = {"acceptance": _run_acceptance}
RUNNERS.update({name: _adapt(fn) for name, fn in SCENARIOS.items()})


def run_scenario(args, ckpt_dir, o) -> dict:
    """One full scenario run under the ambient Obs ``o``; returns the
    verdict dict (shared by the main run, --all, and --sanitize re-runs).
    Every verdict carries a ``flightrec_dump`` key: the post-mortem path
    when a recorder was active and the verdict failed, else ``None``."""
    verdict = RUNNERS[args.scenario](args, ckpt_dir, o)
    verdict.setdefault("flightrec_dump", None)
    return verdict


def _verdict_fingerprint(verdict: dict) -> tuple:
    """The schedule-stable view of a verdict: the ok bit plus the safety
    section (fault counters and timings vary run to run and are not
    determinism claims)."""
    return (
        bool(verdict.get("ok")),
        json.dumps(verdict.get("safety"), sort_keys=True),
    )


def run_sanitized(args, base_verdict: dict) -> dict:
    """--sanitize: re-run the scenario under N seeded yield-injection
    schedules (every run must reproduce the base verdict's safety
    fingerprint) and fuzz the archive worker protocol with rows on
    ``--device``; the returned section folds into the verdict and its
    ``ok`` gates the exit code."""
    from tpu_swirld_torch.analysis import races

    def rerun(i: int) -> tuple:
        with tempfile.TemporaryDirectory(prefix="chaos-san-") as d:
            with obs.enabled() as o:
                return _verdict_fingerprint(run_scenario(args, d, o))

    rep = races.run_schedules(
        rerun, n_schedules=args.sanitize, seed=args.seed
    )
    base = _verdict_fingerprint(base_verdict)
    stable = bool(
        rep["deterministic"]
        and rep["results"]
        and rep["results"][0] == base
    )
    arch = races.run_archive_schedules(
        n_schedules=max(8, args.sanitize), rows=64, seed=args.seed,
        device=args.device,
    )
    return {
        "schedules": rep["schedules"],
        "verdicts_stable": stable,
        "all_ok": all(r[0] for r in rep["results"]),
        "archive": {
            k: arch[k]
            for k in (
                "schedules", "digests_identical", "matches_sync", "acyclic",
            )
        },
        "ok": bool(stable and all(r[0] for r in rep["results"])
                   and arch["ok"]),
    }


def run_mc_section(args) -> dict:
    """--mc: fold a model-checker section into the verdict, three legs:

    - *smoke*: exhaustive BFS of the small vanilla world (every invariant
      must hold over the whole space, the POR+symmetry reduction must
      beat the naive baseline);
    - *mutation*: one seeded bug (``fork-blind``) must be caught by its
      expected invariant with a minimized, bit-deterministically
      replaying counterexample;
    - *parity*: a clean replayable schedule document round-trips through
      :func:`tpu_swirld_torch.chaos.replay_counterexample`, which gates the
      final state on a cross-engine ``_engines_agree`` row under the same
      ``--engine`` and ``--device`` the acceptance scenario used.
    """
    from tpu_swirld_torch.analysis.mc.cli import mc_smoke, run_mc
    from tpu_swirld_torch.chaos import replay_counterexample

    smoke = mc_smoke()
    mut = run_mc(mutate="fork-blind")
    cex = mut.get("counterexample") or {}
    mutation = {
        "name": "fork-blind",
        "caught_expected": bool(cex.get("caught_expected")),
        "minimized_len": cex.get("minimized_len"),
        "replay_ok": bool(
            cex.get("replay_reproduced")
            and cex.get("replay_digests_match")
            and cex.get("replay_trace_match")
        ),
    }
    doc = parity_document(args.seed or 0)
    parity = replay_counterexample(doc, engine=args.engine, device=args.device)
    parity.pop("violation", None)
    return {
        "smoke": smoke,
        "mutation": mutation,
        "parity": parity,
        "ok": bool(
            smoke["ok"] and mutation["caught_expected"]
            and mutation["replay_ok"] and parity["ok"]
        ),
    }


def parity_document(seed: int = 0) -> dict:
    """The ``--mc`` parity probe's clean schedule document: a 3-member world
    (budget 3 events, ``seed``) after three syncs and two pulls, emitted
    under the simulation signer (restored after)."""
    from tpu_swirld_torch import crypto
    from tpu_swirld_torch.analysis.mc import counterexample as ce
    from tpu_swirld_torch.analysis.mc.world import World

    prev = crypto.backend_name()
    crypto.set_backend("sim")
    try:
        w = World(n_honest=3, n_forkers=0, events=3, seed=seed)
        sched = [
            ("sync", 1, 0), ("sync", 0, 1), ("sync", 2, 0),
            ("pull", 0, 2), ("pull", 1, 2),
        ]
        return ce.emit(w, sched, ce.run_checked(w, sched))
    finally:
        crypto.set_backend(prev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--scenario",
        choices=("list",) + tuple(RUNNERS),
        default="acceptance",
        help="named scenario to run (default: acceptance, the composed "
        "fault scenario).  'list' prints every registered scenario with "
        "its one-line description and exits; every scenario registered in "
        "tpu_swirld_torch.adversary.SCENARIOS appears here",
    )
    ap.add_argument(
        "--all", action="store_true",
        help="run every registered scenario and write one aggregate "
        "verdict JSON ({scenarios: {name: verdict}, ok: AND of all}); "
        "exit 0 iff every scenario verdict is ok",
    )
    ap.add_argument(
        "--engine",
        choices=("incremental", "streaming", "streaming-mesh"),
        default="incremental",
        help="windowed device driver for the cross-engine parity section: "
        "incremental (IncrementalConsensus, default), streaming "
        "(StreamingConsensus over the slab store: decided rows retire to "
        "the host archive and pruned-history references exercise the "
        "widening rebase), or streaming-mesh (MeshStreamingConsensus: "
        "the same replay with the resident window in 8 row shards on the "
        "one device).  The acceptance scenario gains an 'engines' verdict "
        "section; the storm scenarios replay with the chosen driver.",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="torch device of the engine replays, the 'tpu' node and the "
        "storms' device runs (default cuda, which fails without a GPU; "
        "cpu runs the kernels' plain versions)",
    )
    ap.add_argument(
        "--seed", type=int, default=None,
        help="population seed (default: 0 for acceptance; registered "
        "scenarios keep their pinned per-scenario seed)",
    )
    ap.add_argument("--plan-seed", type=int, default=0, help="fault stream seed")
    ap.add_argument("--nodes", type=int, default=6)
    ap.add_argument("--turns", type=int, default=360)
    ap.add_argument("--forkers", type=int, default=1)
    ap.add_argument("--drop", type=float, default=0.2)
    ap.add_argument("--corrupt", type=float, default=0.05)
    ap.add_argument("--duplicate", type=float, default=0.05)
    ap.add_argument("--reorder", type=float, default=0.1)
    ap.add_argument("--delay", type=float, default=0.05)
    ap.add_argument("--checkpoint-every", type=int, default=40)
    ap.add_argument(
        "--sanitize", type=int, nargs="?", const=4, default=0,
        metavar="N",
        help="re-run the scenario under N seeded yield-injection "
        "schedules (race sanitizer) and fuzz the archive worker with rows "
        "on --device; folds a 'sanitizer' section into the verdict and "
        "fails it on any schedule-dependent outcome (default N=4; "
        "multiplies runtime)",
    )
    ap.add_argument(
        "--mc", action="store_true",
        help="fold a model-checker section into the verdict: exhaustive "
        "smoke world (all invariants over every interleaving, reduction "
        "ratio vs naive), one seeded-bug mutation with a minimized "
        "replaying counterexample, and a clean replayable schedule "
        "document gated on cross-engine parity under --engine and --device",
    )
    ap.add_argument(
        "--flightrec-dir", default=None, metavar="DIR",
        help="enable the black-box flight recorder: every node keeps a "
        "bounded ring of recent activity and a failing verdict (or an "
        "in-run anomaly: circuit-breaker open, overflow heal, rebase "
        "storm) writes a self-contained post-mortem JSON into DIR; the "
        "verdict's 'flightrec_dump' field records the dump path (null "
        "when the run is green or the flag is off).  Ring sizing via "
        "SWIRLD_FLIGHTREC_CAPACITY / SWIRLD_FLIGHTREC_MAX_DUMPS.",
    )
    ap.add_argument("--out", default="chaos_verdict.json")
    args = ap.parse_args(argv)

    if args.scenario == "list":
        for name, fn in RUNNERS.items():
            doc = (
                SCENARIOS[name].__doc__ if name in SCENARIOS else fn.__doc__
            ) or ""
            first = next(
                (ln.strip() for ln in doc.splitlines() if ln.strip()), ""
            )
            print(f"{name:24s} {first}")
        return 0
    if args.seed is None and not args.all and args.scenario == "acceptance":
        args.seed = 0

    if args.all:
        if args.sanitize:
            ap.error("--all and --sanitize are mutually exclusive")
        if args.mc:
            ap.error("--all and --mc are mutually exclusive")
        results = {}
        for name in RUNNERS:
            sub = argparse.Namespace(**{**vars(args), "scenario": name})
            if name == "acceptance" and sub.seed is None:
                sub.seed = 0
            with tempfile.TemporaryDirectory(prefix="chaos-ckpt-") as d:
                with obs.enabled() as o:
                    results[name] = run_scenario(sub, d, o)
            print(f"{name:24s} {'OK' if results[name]['ok'] else 'FAIL'}")
        verdict = {
            "ok": all(v["ok"] for v in results.values()),
            "scenarios": results,
        }
        if args.flightrec_dir:
            verdict["flightrec_dumps_by_trace"] = \
                flightrec_dumps_by_trace(args.flightrec_dir)
        with open(args.out, "w") as f:
            json.dump(verdict, f, indent=2, sort_keys=True)
        print(f"verdict: {'OK' if verdict['ok'] else 'FAIL'} -> {args.out}")
        return 0 if verdict["ok"] else 1

    if args.scenario != "acceptance":
        # the registered scenarios carry their own built-in population /
        # fault schedule; only --seed/--engine/--device parameterize them
        # — say so instead of silently attributing the verdict to knobs
        # that never applied
        print(
            f"note: --scenario {args.scenario} uses its built-in schedule; "
            "only --seed, --engine and --device apply (other knobs ignored)",
            file=sys.stderr,
        )
    with tempfile.TemporaryDirectory(prefix="chaos-ckpt-") as ckpt_dir:
        with obs.enabled() as o:
            # one shared registry: gossip counters, transport fault
            # counters, and pipeline gauges all land in the same trace
            verdict = run_scenario(args, ckpt_dir, o)
        trace_path = os.path.splitext(args.out)[0] + ".trace.jsonl"
        o.save(trace_path)
    if args.sanitize:
        verdict["sanitizer"] = run_sanitized(args, verdict)
        verdict["ok"] = bool(verdict["ok"] and verdict["sanitizer"]["ok"])
    if args.mc:
        verdict["mc"] = run_mc_section(args)
        verdict["ok"] = bool(verdict["ok"] and verdict["mc"]["ok"])
    if args.flightrec_dir:
        verdict["flightrec_dumps_by_trace"] = \
            flightrec_dumps_by_trace(args.flightrec_dir)
    with open(args.out, "w") as f:
        json.dump(verdict, f, indent=2, sort_keys=True)
    for key in ("safety", "liveness", "horizon", "fork_storm", "round_clamp",
                "adversary", "engines", "sanitizer", "mc", "flightrec_dump",
                "flightrec_dumps_by_trace"):
        if key in verdict:
            print(json.dumps({key: verdict[key]}, sort_keys=True))
    print(f"verdict: {'OK' if verdict['ok'] else 'FAIL'} -> {args.out}")
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
