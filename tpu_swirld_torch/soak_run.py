"""Production-day soak runner with shrink-on-failure (the port's copy of the
reference's ``scripts/soak_run.py``: the same flags, verdict and exit
status).

Runs the composed chaos scenario from :mod:`tpu_swirld_torch.soak`: an
N-process cluster gossiping through per-link TCP fault proxies, under
heavy-tailed client traffic, while the window schedule interleaves
SIGKILL crashes (+ WAL recovery), partition/heal windows, and a
byzantine equivocation storm served through the proxy seam.  Emits the
composite verdict as JSON; exit status 0 iff green.

    python -m tpu_swirld_torch.soak_run --smoke              # the smoke composition
    python -m tpu_swirld_torch.soak_run --horizon 60 --nodes 5   # a long soak
    python -m tpu_swirld_torch.soak_run --smoke --mutate shed-leak
                                                        # must go red + shrink
    python -m tpu_swirld_torch.soak_run --replay minimized.schedule.json

On a red verdict the runner ddmin-reduces the schedule to a 1-minimal
replayable failure document (``minimized.schedule.json`` in the
workdir) unless ``--no-shrink`` is given.  Defaults for the unset knobs
come from ``SWIRLD_SOAK_*`` (field > env > default, see
``resolve_soak_settings``).  The node processes run the oracle on the
host, so no flag names a device; ``chip_smoke.py`` replays a soak's union
event log on the card.
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile

from tpu_swirld_torch import soak


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="deterministic tier-1 composition: 1 crash + "
                         "1 partition + 1 attack window, short horizon")
    ap.add_argument("--nodes", type=int, default=None)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--horizon", type=float, default=None,
                    help="soak horizon in seconds")
    ap.add_argument("--rate", type=float, default=None,
                    help="aggregate client submissions per second")
    ap.add_argument("--clients", type=int, default=None)
    ap.add_argument("--mutate", choices=sorted(soak.MUTATIONS),
                    default=None,
                    help="inject a seeded defect; the verdict must go red")
    ap.add_argument("--membership", action="store_true",
                    help="DynamicNode cluster + a MembershipWindow "
                         "(restake tx) at 30%% of the horizon — the "
                         "verdict gains an epochs-decided gate")
    ap.add_argument("--no-shrink", action="store_true",
                    help="skip ddmin schedule reduction on a red verdict")
    ap.add_argument("--replay", default=None, metavar="DOC",
                    help="re-run a saved (minimized) schedule doc")
    ap.add_argument("--workdir", default=None,
                    help="soak state dir (default: fresh tempdir)")
    ap.add_argument("--gossip-interval", type=float, default=0.005)
    ap.add_argument("--checkpoint-every", type=float, default=0.5)
    ap.add_argument("--out", default=None, help="verdict JSON path")
    args = ap.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="swirld-soak-")

    if args.replay:
        verdict = soak.replay_doc(soak.load_doc(args.replay), workdir)
    else:
        overrides = {
            "seed": args.seed,
            "mutate": args.mutate,
            "net": {
                "gossip_interval_s": args.gossip_interval,
                "checkpoint_every_s": args.checkpoint_every,
            },
        }
        if args.nodes is not None:
            overrides["n_nodes"] = args.nodes
        if args.rate is not None:
            overrides["tx_rate"] = args.rate
        if args.clients is not None:
            overrides["n_clients"] = args.clients
        if args.horizon is not None:
            overrides["horizon_s"] = args.horizon
        elif args.smoke:
            overrides["horizon_s"] = 7.0
        spec = soak.default_spec(workdir, **overrides)
        schedule = soak.smoke_schedule(spec)
        if args.membership:
            schedule = schedule + (
                soak.MembershipWindow(
                    at_s=spec.horizon_s * 0.3, action="restake",
                    member=1, stake=3,
                ),
            )
        spec = dataclasses.replace(
            spec, schedule=schedule, dynamic=args.membership,
        )
        verdict = soak.run_soak(spec)
        if not verdict["ok"] and not args.no_shrink:
            doc = soak.shrink(spec)
            verdict["minimized_doc"] = soak.save_doc(
                doc, os.path.join(workdir, "minimized.schedule.json"),
            )
            verdict["minimized_schedule"] = doc["schedule"]

    verdict["workdir"] = workdir
    text = json.dumps(verdict, indent=1, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
