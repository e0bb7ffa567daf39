"""How deep the order scan's self-chain walks go, on a seeded gossip DAG:

    python3 -m tpu_swirld_torch.dev.order_walks [--members 64] [--events 10000]
        [--seed 1] [--device cpu]

The defaults are config 3 (BASELINE.json's ``configs[2]``,
``generate_gossip_dag(64, 10000, seed=1)``, fork-free).  The batch pass
(``run_consensus``) runs on ``--device``, and its order scan's inputs are
kept.  For every event the scan receives and each unique famous witness
of its round, the walk's depth is the number of self-chain rows, from the
witness down, that have the event as an ancestor, within ``chain`` steps:
the rows that ``csrc/order_scan.cu`` tabulates and searches, a window of
16 at a time.  Prints the table's shape, each round's count of unique
famous witnesses, and the depths' mean, median, 99th percentile and
largest, then one JSON line with them.  The depths are counts of the
data, not a time: any device gives the same.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np


@contextlib.contextmanager
def _kept_order_call(pipeline, kept):
    """The pipeline's ``order_scan`` seam records its arguments and its
    round-received output in ``kept`` while the block runs (the kernel's
    wrapper and its launch count are left as they are)."""
    real = pipeline.order_scan

    def keep(*args, **kw):
        out = real(*args, **kw)
        kept.append((args, kw, out[0]))
        return out

    pipeline.order_scan = keep
    try:
        yield
    finally:
        pipeline.order_scan = real


def walk_depths(members: int, events: int, seed: int, device: str):
    """``(table shape, unique famous witnesses a round, depths)`` of the
    batch pass's order scan on ``generate_gossip_dag(members, events,
    seed)``."""
    from tpu_swirld_torch.gpu import kernels, pipeline
    from tpu_swirld_torch.packing import pack_events
    from tpu_swirld_torch.sim import generate_gossip_dag

    dag_members, stake, dag_events, _keys = generate_gossip_dag(
        members, events, seed=seed, n_forkers=0)
    packed = pack_events(dag_events, dag_members, stake)
    kept = []
    with _kept_order_call(pipeline, kept):
        pipeline.run_consensus(packed, device=device)
    args, kw, rr = kept[-1]
    anc, tab, cnt, famous, creator, self_parent, _t_rank, max_round, _n_valid = args
    ufw, nv = kernels._order_plan(tab, cnt, famous, creator, max_round, anc.shape[0])
    anc, sp = anc.cpu().numpy(), self_parent.cpu().numpy()
    rr, ufw, nv = rr.cpu().numpy(), ufw.cpu().numpy(), nv.cpu().numpy()
    depths = []
    for e in np.flatnonzero(rr >= 0):
        for w in ufw[rr[e], : nv[rr[e]]]:
            cur, d = int(w), 0
            for _ in range(kw["chain"]):
                if not anc[cur, e]:
                    break
                d += 1
                if sp[cur] < 0:
                    break
                cur = int(sp[cur])
            depths.append(d)
    return tuple(tab.shape), nv.tolist(), np.array(depths)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--members", type=int, default=64)
    ap.add_argument("--events", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cpu")
    a = ap.parse_args(argv)
    shape, nv, depths = walk_depths(a.members, a.events, a.seed, a.device)
    row = {"members": a.members, "events": a.events, "seed": a.seed,
           "table": shape, "ufw_a_round": nv, "walks": int(depths.size),
           "mean": float(depths.mean()), "median": float(np.median(depths)),
           "p99": float(np.percentile(depths, 99)), "max": int(depths.max())}
    print(f"table {shape}, unique famous witnesses a round {nv}")
    print(f"{depths.size} walks: mean {row['mean']}, median {row['median']}, "
          f"99th percentile {row['p99']}, largest {row['max']}")
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
