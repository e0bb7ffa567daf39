"""Diff two benchmark artifacts of the port and fail on a throughput or
memory regression (the port's copy of the reference's
``scripts/bench_compare.py``: the same gates, thresholds, directions and
exit codes).

    python -m tpu_swirld_torch.bench_compare OLD.json NEW.json [--threshold 0.10]
                                             [--key value]

Compares ``NEW[key]`` against ``OLD[key]`` (default ``value``, the headline
events/s) and exits 1 when the new number is more than ``threshold``
(default 10%) below the old one.  Also compared, where both files carry
them (:data:`EXTRA_KEYS`): events/s and tx/s higher-is-better; peak bytes,
finality p99 / mean rounds-to-decision, tail latencies, dispatch overhead
and repack p99 lower-is-better.  Before any metric, a candidate is refused
(exit 1) when its ``lint`` stamp has findings, its ``mc`` stamp is not ok,
its ``scale_audit`` stamp is dirty *or missing*, its tracing overhead
exceeds :data:`MAX_TRACE_OVERHEAD_RATIO`, or its soak verdict is red.

Artifacts that wrap the line under ``parsed`` (``{"cmd": ..., "parsed":
{...}}``) are unwrapped.  Phases print as an informational diff.  Run it by
hand after two runs of ``python -m tpu_swirld_torch.bench``::

    python -m tpu_swirld_torch.bench > new.json
    python -m tpu_swirld_torch.bench_compare old.json new.json
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Optional

#: (dotted key, higher_is_better)
EXTRA_KEYS = [
    ("incremental.steady_evps", True),
    ("stream.evps", True),
    ("peak_host_bytes", False),
    ("peak_device_bytes", False),
    ("stream.peak_resident_visibility_bytes", False),
    # --stream --mesh D
    ("stream_mesh.evps", True),
    ("stream_mesh.scaling_efficiency", True),
    ("stream_mesh.peak_device_tiles", False),
    ("stream_mesh.repins", False),
    # --chaos-overhead (ratio = attack / clean)
    ("chaos_overhead.clean_evps", True),
    ("chaos_overhead.attack_evps", True),
    ("chaos_overhead.ratio", True),
    # the finality section: deciding the same history later is a regression
    ("finality.incremental.ttf_p99", False),
    ("finality.incremental.rtd_mean", False),
    ("finality.batch.rtd_mean", False),
    ("finality.streaming.ttf_p99", False),
    ("finality.streaming.rtd_mean", False),
    # --cluster
    ("cluster.tx_per_s", True),
    ("cluster.submit_p99_s", False),
    # --soak
    ("soak.tx_per_s", True),
    ("soak.submit_p99_s", False),
    ("soak.disruptions_survived", True),
    # --stream's dispatch profiler: host work a chunk beside the stages
    ("stream.dispatch_overhead_s", False),
    # --churn (fewer epochs would mean an undecided membership tx)
    ("churn.evps", True),
    ("churn.repack_p99_s", False),
    ("churn.epochs", True),
]

#: a candidate whose profiled sample slowed its streaming run by more
#: than this is refused
MAX_TRACE_OVERHEAD_RATIO = 0.05


def unwrap(doc: Dict) -> Dict:
    """An artifact that wraps the bench line under ``parsed``."""
    if "value" not in doc and isinstance(doc.get("parsed"), dict):
        return doc["parsed"]
    return doc


def _get(d: Dict[str, Any], dotted: str) -> Optional[float]:
    cur: Any = d
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    try:
        return float(cur)
    except (TypeError, ValueError):
        return None


def lint_gate(new: Dict) -> Optional[str]:
    """Refuse a candidate whose tree had lint findings; one without the
    stamp passes this gate."""
    lint = new.get("lint")
    if lint is None:
        return None
    if isinstance(lint, dict) and lint.get("clean"):
        return None
    return (
        f"candidate tree had lint findings ({lint!r}); run "
        "python -m tpu_swirld_torch.analysis lint, fix, and re-bench before gating"
    )


def mc_gate(new: Dict) -> Optional[str]:
    """Refuse a candidate whose model-checker smoke stamp is not ok; one
    without the stamp passes this gate."""
    mc = new.get("mc")
    if mc is None:
        return None
    if isinstance(mc, dict) and mc.get("ok"):
        return None
    return (
        f"candidate tree failed the model-checker smoke ({mc!r}); run "
        "python -m tpu_swirld_torch.analysis mc, fix, and re-bench before gating"
    )


def scale_audit_gate(new: Dict) -> Optional[str]:
    """Refuse a candidate without a *clean* scale-audit stamp: a missing
    stamp refuses too (the bench always stamps one)."""
    sa = new.get("scale_audit")
    if isinstance(sa, dict) and sa.get("clean"):
        return None
    if sa is None:
        return (
            "candidate carries no scale_audit stamp; re-bench with the "
            "current bench (python -m tpu_swirld_torch.analysis scale-audit "
            "proves the stage bodies wrap- and bounds-safe) before gating"
        )
    return (
        f"candidate tree failed the scale audit ({sa!r}); run "
        "python -m tpu_swirld_torch.analysis scale-audit, fix or justify each "
        "finding, and re-bench before gating"
    )


def soak_gate(new: Dict) -> Optional[str]:
    """Refuse a candidate whose soak verdict is red; artifacts without
    ``soak.verdict_ok`` pass."""
    soak = new.get("soak")
    if not isinstance(soak, dict) or "verdict_ok" not in soak:
        return None
    if soak.get("verdict_ok"):
        return None
    return (
        "candidate's soak verdict is red (soak.verdict_ok false): the "
        "cluster lost safety, liveness, finality budget, or shed "
        "accounting under the composed schedule; replay the minimized "
        "schedule doc with python -m tpu_swirld_torch.soak_run, fix, and re-bench"
    )


def trace_overhead_gate(new: Dict) -> Optional[str]:
    """Refuse a candidate whose own profiled sample shows tracing slowing
    the streaming run by more than :data:`MAX_TRACE_OVERHEAD_RATIO`."""
    ratio = _get(new, "stream.trace_overhead_ratio")
    if ratio is None or ratio <= MAX_TRACE_OVERHEAD_RATIO:
        return None
    return (
        f"candidate's tracing overhead ratio {ratio:.1%} exceeds "
        f"{MAX_TRACE_OVERHEAD_RATIO:.0%}: the profiled sample perturbed "
        "the run; shrink BENCH_STREAM_PROFILE or fix the profiler cost "
        "and re-bench before gating"
    )


def compare(old: Dict, new: Dict, key: str, threshold: float):
    """Returns (failures, report_lines)."""
    lines = []
    failures = []
    for k, higher_better in [(key, True)] + EXTRA_KEYS:
        ov, nv = _get(old, k), _get(new, k)
        if ov is None or nv is None:
            if k == key:
                failures.append(f"missing key {k!r} in one of the inputs")
            continue
        delta = (nv - ov) / ov if ov else 0.0
        bad = delta < -threshold if higher_better else delta > threshold
        verdict = "ok"
        if bad:
            direction = "below" if higher_better else "above"
            verdict = f"REGRESSION (>{threshold:.0%} {direction} old)"
            failures.append(f"{k}: {ov:.1f} -> {nv:.1f} ({delta:+.1%})")
        lines.append(
            f"{k:<40} {ov:>14.1f} -> {nv:>14.1f}  {delta:+7.1%}  {verdict}"
        )
    op, np_ = old.get("phases") or {}, new.get("phases") or {}
    for k in sorted(set(op) | set(np_)):
        ov, nv = op.get(k), np_.get(k)
        if isinstance(ov, (int, float)) and isinstance(nv, (int, float)):
            lines.append(f"  phase {k:<40} {ov:>12} -> {nv:>12}")
    return failures, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", help="baseline artifact (a bench JSON line)")
    ap.add_argument("new", help="candidate artifact")
    ap.add_argument("--threshold", type=float, default=0.10,
                    help="allowed fractional drop in throughput / rise in "
                         "peak memory (default 0.10 = 10%%)")
    ap.add_argument("--key", default="value",
                    help="headline metric key (default: value)")
    args = ap.parse_args(argv)
    with open(args.old) as f:
        old = unwrap(json.load(f))
    with open(args.new) as f:
        new = unwrap(json.load(f))
    for gate in (lint_gate(new), mc_gate(new), scale_audit_gate(new),
                 trace_overhead_gate(new), soak_gate(new)):
        if gate is not None:
            print(f"\nFAIL: {gate}", file=sys.stderr)
            return 1
    if new.get("lint") is None:
        print("note: candidate carries no lint stamp; gating on metrics only",
              file=sys.stderr)
    if new.get("mc") is None:
        print("note: candidate carries no model-checker stamp; gating on "
              "metrics only", file=sys.stderr)
    failures, lines = compare(old, new, args.key, args.threshold)
    for ln in lines:
        print(ln)
    if failures:
        print("\nFAIL:", "; ".join(failures), file=sys.stderr)
        return 1
    print("\nOK: no throughput or peak-memory regression beyond "
          f"{args.threshold:.0%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
