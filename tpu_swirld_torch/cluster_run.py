"""Real-process cluster runner emitting a JSON verdict artifact.

The port's counterpart of the reference's ``scripts/cluster_run.py``: the
same flags, the same verdict, the same exit status.  Launches N :mod:`tpu_swirld_torch.net.node_proc` OS processes gossiping over
loopback TCP, drives client transaction submissions against them,
optionally SIGKILLs one node mid-run and restarts it from checkpoint +
own-event WAL, and writes the supervisor's verdict (safety vs the
fault-free oracle replay of the union DAG, liveness past the crash
window, tx ledger, per-node startup post-mortems) as JSON.  Exit status
0 iff the verdict is ok, so CI can gate on it directly.

Reproduce any run from its seed (wall-clock scheduling varies; the
safety claim — decided prefixes bit-identical to the oracle — must hold
on every run regardless):

    python -m tpu_swirld_torch.cluster_run --nodes 5 --seed 7 \
        --kill 2 --kill-at 2.0 --restart-at 3.5 --out verdict.json

Per-node flight-recorder dumps (written when a restarted node's WAL
shows the previous incarnation died uncleanly) are collected into the
verdict's ``nodes`` section — ``flightrec_dump`` is the dump path, or
``null`` for clean starts.
"""

import argparse
import json
import os
import sys
import tempfile

from tpu_swirld_torch.net.cluster import ClusterSpec, run_cluster


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--duration", type=float, default=5.0,
                    help="traffic window in seconds")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="client submissions per second")
    ap.add_argument("--tx-bytes", type=int, default=64)
    ap.add_argument("--kill", type=int, default=None,
                    help="node index to SIGKILL mid-run")
    ap.add_argument("--kill-at", type=float, default=None,
                    help="seconds into the run to kill")
    ap.add_argument("--restart-at", type=float, default=None,
                    help="seconds into the run to restart the killed node")
    ap.add_argument("--workdir", default=None,
                    help="cluster state dir (default: fresh tempdir)")
    ap.add_argument("--flightrec-dir", default=None,
                    help="post-mortem dump dir (default: workdir/flightrec)")
    ap.add_argument("--gossip-interval", type=float, default=0.005)
    ap.add_argument("--checkpoint-every", type=float, default=0.5)
    ap.add_argument("--max-undecided", type=int, default=None,
                    help="admission-control window override (small values "
                         "force load shedding)")
    ap.add_argument("--out", default=None, help="verdict JSON path")
    args = ap.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="swirld-cluster-")
    net = {
        "gossip_interval_s": args.gossip_interval,
        "checkpoint_every_s": args.checkpoint_every,
    }
    if args.max_undecided is not None:
        net["max_undecided"] = args.max_undecided
    spec = ClusterSpec(
        workdir=workdir,
        n_nodes=args.nodes,
        seed=args.seed,
        duration_s=args.duration,
        tx_rate=args.rate,
        tx_bytes=args.tx_bytes,
        kill_index=args.kill,
        kill_at_s=args.kill_at,
        restart_at_s=args.restart_at,
        flightrec_dir=args.flightrec_dir
        or os.path.join(workdir, "flightrec"),
        net=net,
    )
    verdict = run_cluster(spec)
    verdict["workdir"] = workdir
    text = json.dumps(verdict, indent=1, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
