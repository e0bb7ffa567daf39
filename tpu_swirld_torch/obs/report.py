"""``python -m tpu_swirld_torch.obs report`` — render a trace file as tables
(the port's copy of the reference's ``tpu_swirld/obs/report.py``).

Consumes the JSONL (or Chrome-wrapped) trace written by
:meth:`tpu_swirld_torch.obs.Obs.save` / :meth:`tpu_swirld_torch.obs.tracer.Tracer.save`
and prints:

1. a *phase breakdown* — per span name: calls, total/mean/max milliseconds,
   and percent of the total traced depth-0 time, nested names indented by
   their recorded depth;
2. the *protocol gauges* — every counter sample (``ph: "C"``) embedded in
   the trace, i.e. the registry snapshot at save time — split into
   protocol / store / cluster-traffic (tx ingestion, WAL recovery) /
   finality (rounds-to-decision, time-to-finality, decided watermarks) /
   flight-recorder (trigger + dump counters) / membership (epoch, active
   members, total stake) / resilience sections.

Two additional modes:

- pointing the CLI at an old ``BENCH_*.json`` *bench artifact* (a plain
  JSON result doc, not a trace) renders every section as ``n/a`` with
  the artifact's own metric line, and exits 0 — it must never traceback
  on the repo's own historical outputs;
- ``--cluster-dir <workdir>`` renders the *fleet view* from a cluster
  run's on-disk leavings (``node-*.report.json``, ``metrics.json``,
  ``merged.trace.json``): per-node fleet table, finality, shed /
  backpressure, WAL recovery, circuit-breaker sections, and the
  supervisor metrics rollup.  Missing keys render ``n/a`` — old report
  versions stay readable.

Pure stdlib + pure functions over the event list, so the CLI can be smoke-
tested cheaply (``tests/test_torch_obs.py``) and never rots silently.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from tpu_swirld_torch.obs.tracer import load_trace


def aggregate_spans(events: List[Dict]) -> List[Dict]:
    """Group ``ph == "X"`` events by (depth, name) preserving first-seen
    order within a depth; returns rows with calls/total/mean/max ms."""
    rows: Dict[Tuple[int, str], Dict] = {}
    order: List[Tuple[int, str]] = []
    for e in events:
        if e.get("ph") != "X":
            continue
        depth = int(e.get("args", {}).get("depth", 0))
        key = (depth, e["name"])
        row = rows.get(key)
        if row is None:
            row = {
                "name": e["name"], "depth": depth, "calls": 0,
                "total_ms": 0.0, "max_ms": 0.0,
            }
            rows[key] = row
            order.append(key)
        dur_ms = float(e.get("dur", 0.0)) / 1000.0
        row["calls"] += 1
        row["total_ms"] += dur_ms
        row["max_ms"] = max(row["max_ms"], dur_ms)
    # sort: depth-0 rows by total desc, children right after their depth
    # cannot be reconstructed without parent links — keep stable order
    # within depth, depth-0 first-seen order preserved.
    out = [rows[k] for k in order]
    for row in out:
        row["mean_ms"] = row["total_ms"] / row["calls"]
    return out


def gauge_rows(events: List[Dict]) -> List[Dict]:
    """Counter samples (``ph == "C"``): the registry snapshot lines."""
    rows = []
    for e in events:
        if e.get("ph") != "C":
            continue
        args = dict(e.get("args", {}))
        value = args.pop("value", None)
        rows.append({"name": e["name"], "value": value, "labels": args})
    return rows


# The chaos/resilience failure surface gets its own report section so a
# fault-injected run's health reads at a glance: transport fault counters
# (FaultyTransport), retry/backoff/circuit-breaker counters (Node), the
# adversary-detection counters (equivocation / withholding / 3f budget),
# and the incremental driver's storm-guard decision gauges.
_RESILIENCE_PREFIXES = (
    "transport_",
    "adversary_",
    "node_equivocations",
    "node_withholding",
    "node_budget_exhausted",
    "node_sync_branches_capped",
    "gossip_transport_errors",
    "gossip_retries",
    "gossip_backoff",
    "gossip_deadline",
    "gossip_circuit",
    "gossip_bad_",
    "gossip_sync_branches_capped",
    "incremental_storm",
    "incremental_consecutive_rebases",
    "consensus_late_witnesses",
    "consensus_horizon_violations",
    "pipeline_overflow_retries",
    "node_bad_",
    "node_retries",
    "node_backoff",
    "node_quarantined",
    "node_circuit",
    "node_late_witnesses",
    "node_horizon_violations",
)


def is_resilience_row(g: Dict) -> bool:
    return any(g["name"].startswith(p) for p in _RESILIENCE_PREFIXES)


# The slab store / streaming-overlap surface gets its own section: tile
# budget pressure, archive spill/fetch traffic, the background packing
# queue, and the compute-vs-wall overlap ratio of the streaming driver.
_STORE_PREFIXES = (
    "store_",
    "stream_overlap",
)


def is_store_row(g: Dict) -> bool:
    return any(g["name"].startswith(p) for p in _STORE_PREFIXES)


# The real-cluster traffic surface: tx ingestion/backpressure counters
# (TxPool), durable-WAL recovery counters, and the socket transport's
# byte/timeout counters already covered by transport_ above.
_NET_PREFIXES = (
    "tx_",
    "wal_",
    "net_",
)


def is_net_row(g: Dict) -> bool:
    return any(g["name"].startswith(p) for p in _NET_PREFIXES)


# The dynamic-membership surface (membership/): the epoch governing the
# round frontier, the live member count, and the epoch's total stake —
# published by metrics.node_gauges for static and dynamic nodes alike
# (static nodes report the trivial single-epoch values).
_MEMBERSHIP_PREFIXES = (
    "node_membership_",
    "node_members_active",
    "node_stake_total",
    "membership_",
)


def is_membership_row(g: Dict) -> bool:
    return any(g["name"].startswith(p) for p in _MEMBERSHIP_PREFIXES)


# The finality lifecycle surface: rounds-to-decision / time-to-finality
# histogram rows (per engine, with the streaming phase dimension),
# gossip-propagation latency, and per-node decided-watermark gauges.
_FINALITY_PREFIXES = ("finality_",)

# The black-box flight recorder: trigger counters by reason and the
# dump/record totals stamped at dump time.
_FLIGHTREC_PREFIXES = ("flightrec_",)


def is_finality_row(g: Dict) -> bool:
    return any(g["name"].startswith(p) for p in _FINALITY_PREFIXES)


def is_flightrec_row(g: Dict) -> bool:
    return any(g["name"].startswith(p) for p in _FLIGHTREC_PREFIXES)


def render_report(events: List[Dict]) -> str:
    spans = aggregate_spans(events)
    gauges = gauge_rows(events)
    lines: List[str] = []
    total_top = sum(r["total_ms"] for r in spans if r["depth"] == 0)
    lines.append("== phase breakdown ==")
    if spans:
        lines.append(
            f"{'span':<44} {'calls':>6} {'total_ms':>10} {'mean_ms':>9} "
            f"{'max_ms':>9} {'%top':>6}"
        )
        for r in spans:
            name = "  " * r["depth"] + r["name"]
            pct = (
                f"{100.0 * r['total_ms'] / total_top:5.1f}%"
                if r["depth"] == 0 and total_top > 0
                else ""
            )
            lines.append(
                f"{name:<44} {r['calls']:>6} {r['total_ms']:>10.3f} "
                f"{r['mean_ms']:>9.3f} {r['max_ms']:>9.3f} {pct:>6}"
            )
    else:
        lines.append("(no spans in trace)")
    resilience = [g for g in gauges if is_resilience_row(g)]
    store = [
        g for g in gauges
        if is_store_row(g) and not is_resilience_row(g)
    ]
    net = [
        g for g in gauges
        if is_net_row(g)
        and not is_resilience_row(g) and not is_store_row(g)
    ]
    finality = [
        g for g in gauges
        if is_finality_row(g)
        and not is_resilience_row(g) and not is_store_row(g)
        and not is_net_row(g)
    ]
    flightrec = [
        g for g in gauges
        if is_flightrec_row(g)
        and not is_resilience_row(g) and not is_store_row(g)
        and not is_net_row(g)
    ]
    membership = [
        g for g in gauges
        if is_membership_row(g)
        and not is_resilience_row(g) and not is_store_row(g)
        and not is_net_row(g)
        and not is_finality_row(g) and not is_flightrec_row(g)
    ]
    protocol = [
        g for g in gauges
        if not is_resilience_row(g) and not is_store_row(g)
        and not is_net_row(g)
        and not is_finality_row(g) and not is_flightrec_row(g)
        and not is_membership_row(g)
    ]
    lines.append("")
    lines.append("== protocol gauges ==")
    if protocol:
        width = max(len(_gauge_name(g)) for g in protocol)
        for g in protocol:
            lines.append(f"{_gauge_name(g):<{width}}  {g['value']}")
    else:
        lines.append("(no counter samples in trace)")
    if store:
        lines.append("")
        lines.append("== store (tile budget / archive / spill overlap) ==")
        width = max(len(_gauge_name(g)) for g in store)
        for g in store:
            lines.append(f"{_gauge_name(g):<{width}}  {g['value']}")
    if net:
        lines.append("")
        lines.append("== cluster traffic (tx ingestion / WAL recovery) ==")
        width = max(len(_gauge_name(g)) for g in net)
        for g in net:
            lines.append(f"{_gauge_name(g):<{width}}  {g['value']}")
    if finality:
        lines.append("")
        lines.append("== finality (rounds-to-decision / time-to-finality"
                     " / watermarks) ==")
        width = max(len(_gauge_name(g)) for g in finality)
        for g in finality:
            lines.append(f"{_gauge_name(g):<{width}}  {g['value']}")
    if flightrec:
        lines.append("")
        lines.append("== flight recorder (triggers / dumps) ==")
        width = max(len(_gauge_name(g)) for g in flightrec)
        for g in flightrec:
            lines.append(f"{_gauge_name(g):<{width}}  {g['value']}")
    if membership:
        lines.append("")
        lines.append("== membership (epoch / active members / stake) ==")
        width = max(len(_gauge_name(g)) for g in membership)
        for g in membership:
            lines.append(f"{_gauge_name(g):<{width}}  {g['value']}")
    if resilience:
        lines.append("")
        lines.append("== resilience (faults / retries / quarantine) ==")
        width = max(len(_gauge_name(g)) for g in resilience)
        for g in resilience:
            lines.append(f"{_gauge_name(g):<{width}}  {g['value']}")
    return "\n".join(lines)


def _gauge_name(g: Dict) -> str:
    if g["labels"]:
        lab = ",".join(f"{k}={v}" for k, v in sorted(g["labels"].items()))
        return f"{g['name']}{{{lab}}}"
    return g["name"]


# ------------------------------------------------------- artifact detection

def classify_artifact(path: str) -> Tuple[str, object]:
    """``("trace", events)`` for a trace file, ``("bench", obj)`` for a
    bench result artifact (any plain JSON document that isn't trace
    events — the old ``BENCH_*.json`` files the CLI must not crash on)."""
    with open(path) as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped.startswith("{") and '"traceEvents"' not in stripped[:200]:
        try:
            obj = json.loads(stripped)
        except json.JSONDecodeError:
            obj = None
        # a lone single-line trace event is still a trace ("ph" marks it)
        if isinstance(obj, dict) and "ph" not in obj:
            return "bench", obj
    return "trace", load_trace(path)


def render_bench_stub(path: str, obj: Dict) -> str:
    """The graceful non-trace rendering: every trace section present but
    ``n/a``, plus whatever headline metric the artifact itself carries."""
    lines = [
        f"(not a trace: bench artifact {os.path.basename(path)})",
        "",
        "== phase breakdown ==",
        "n/a",
        "",
        "== protocol gauges ==",
        "n/a",
    ]
    parsed = obj.get("parsed")
    if isinstance(parsed, dict):
        parsed = [parsed]
    if isinstance(parsed, list):
        lines.append("")
        lines.append("== bench artifact metrics ==")
        for row in parsed:
            if not isinstance(row, dict):
                continue
            metric = row.get("metric", "n/a")
            value = row.get("value", "n/a")
            unit = row.get("unit", "")
            lines.append(f"{metric}: {value} {unit}".rstrip())
    return "\n".join(lines)


# ------------------------------------------------------------ cluster view

def _fmt(v, nd: int = 3) -> str:
    if v is None:
        return "n/a"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def _counter_section(lines: List[str], title: str, reports: List[Dict],
                     names: Tuple[str, ...]) -> None:
    """One fleet counter table: per-counter per-node values + total,
    ``n/a`` where a node's report predates the counter."""
    lines.append("")
    lines.append(f"== {title} ==")
    for name in names:
        vals = [
            (r.get("counters") or {}).get(name) for r in reports
        ]
        known = [v for v in vals if v is not None]
        total = sum(known) if known else None
        per_node = " ".join(
            f"{r.get('node', '?')}={_fmt(v, 0)}"
            for r, v in zip(reports, vals)
        )
        lines.append(f"{name:<28} total={_fmt(total, 0):<8} {per_node}")


def render_cluster_report(dirpath: str) -> str:
    """The fleet view over a cluster workdir's on-disk artifacts."""
    reports: List[Dict] = []
    for name in sorted(os.listdir(dirpath)):
        if name.startswith("node-") and name.endswith(".report.json"):
            try:
                with open(os.path.join(dirpath, name)) as f:
                    reports.append(json.load(f))
            except (OSError, json.JSONDecodeError):
                continue
    lines: List[str] = [f"== cluster fleet ({len(reports)} node reports) =="]
    if not reports:
        lines.append("n/a (no node-*.report.json found)")
    else:
        lines.append(
            f"{'node':<6} {'events':>7} {'decided':>8} {'decided_tx':>10} "
            f"{'unclean':>8} {'trace_ev':>9} {'dropped':>8}"
        )
        for r in reports:
            lines.append(
                f"{_fmt(r.get('node')):<6} {_fmt(r.get('events')):>7} "
                f"{_fmt(len(r['decided']) if 'decided' in r else None):>8} "
                f"{_fmt(r.get('decided_tx')):>10} "
                f"{_fmt(r.get('unclean_start')):>8} "
                f"{_fmt(r.get('trace_events')):>9} "
                f"{_fmt(r.get('trace_dropped')):>8}"
            )
        lines.append("")
        lines.append("== finality (per node) ==")
        for r in reports:
            fin = r.get("finality") or {}
            lines.append(
                f"{_fmt(r.get('node')):<6} decided={_fmt(fin.get('decided'))}"
                f" rtd_p50={_fmt(fin.get('rtd_p50'))}"
                f" rtd_p99={_fmt(fin.get('rtd_p99'))}"
                f" ttf_p50={_fmt(fin.get('ttf_p50'))}"
                f" ttf_p99={_fmt(fin.get('ttf_p99'))}"
                f" undecided={_fmt(fin.get('undecided'))}"
            )
        lines.append("")
        lines.append("== membership (per node) ==")
        for r in reports:
            lines.append(
                f"{_fmt(r.get('node')):<6}"
                f" epoch={_fmt(r.get('membership_epoch'))}"
                f" epochs_decided={_fmt(r.get('membership_epochs'))}"
                f" members_active={_fmt(r.get('members_active'))}"
                f" stake_total={_fmt(r.get('stake_total'))}"
            )
        _counter_section(
            lines, "shed / backpressure", reports,
            ("tx_submitted", "tx_accepted", "tx_duplicate",
             "tx_shed_pool", "tx_shed_window", "tx_shed_oversize"),
        )
        _counter_section(
            lines, "WAL recovery", reports,
            ("wal_torn_tail_recovered",),
        )
        _counter_section(
            lines, "circuit breaker / retries", reports,
            ("node_circuit_opens", "node_retries",
             "node_bad_replies", "node_bad_requests"),
        )
    metrics_path = os.path.join(dirpath, "metrics.json")
    lines.append("")
    lines.append("== supervisor metrics rollup ==")
    if os.path.exists(metrics_path):
        try:
            with open(metrics_path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            doc = {}
        lines.append(
            f"polls={_fmt(doc.get('polls'))} "
            f"nodes={_fmt(len(doc.get('nodes', {})) or None, 0)}"
        )
        rollup = doc.get("rollup") or {}
        for key in sorted(rollup):
            lines.append(f"{key:<44} {_fmt(rollup[key])}")
        if not rollup:
            lines.append("n/a (empty rollup)")
    else:
        lines.append("n/a (no metrics.json — supervisor polling off?)")
    merged = os.path.join(dirpath, "merged.trace.json")
    lines.append("")
    lines.append("== merged cross-process trace ==")
    if os.path.exists(merged):
        lines.append(merged)
        lines.append(
            "(open in Perfetto; re-summarize with "
            "python -m tpu_swirld_torch.obs.cluster_trace "
            f"{dirpath})"
        )
    else:
        lines.append("n/a (no merged.trace.json — run "
                     f"python -m tpu_swirld_torch.obs.cluster_trace {dirpath})")
    return "\n".join(lines)


def main(argv: List[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m tpu_swirld_torch.obs",
        description="tpu_swirld_torch observability tooling",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser("report", help="render a trace file as tables")
    rep.add_argument("trace", nargs="?", default=None,
                     help="JSONL (or Chrome-wrapped) trace file")
    rep.add_argument("--cluster-dir", default=None,
                     help="render the fleet view of a cluster workdir "
                          "instead of a single trace")
    args = ap.parse_args(argv)
    if args.cmd == "report":
        if args.cluster_dir is not None:
            print(render_cluster_report(args.cluster_dir))
            return 0
        if args.trace is None:
            ap.error("a trace file (or --cluster-dir) is required")
        kind, payload = classify_artifact(args.trace)
        if kind == "bench":
            print(render_bench_stub(args.trace, payload))
            return 0
        print(render_report(payload))
        return 0
    return 2
