"""Cluster trace merger: per-process JSONL shards -> one Chrome timeline
(the port's copy of the reference's ``tpu_swirld/obs/cluster_trace.py``).

Every cluster process (each ``node_proc`` runtime plus the supervisor's
client tracer) writes its own Chrome-trace JSONL shard.  Span ``ts``
values are *per-process* monotonic microseconds — meaningless across
processes — but every span also records its wall-clock start in
``args.wall_s``.  The merger rebases each shard onto the shared wall
clock (per-shard offset = median of ``wall_s*1e6 - ts`` over its spans,
robust to a few clock-step outliers), renumbers ``pid`` so Perfetto
shows one lane per process, and emits Chrome *flow* events (``ph: "s"``
/ ``ph: "f"``) for every parent/child span edge that crosses a process
boundary — the visual arrows that turn N shards into one causal story:
client submit → node submit → gossip sync → remote serve → decided.

Span identity: ``args.span_id`` is process-unique (the tracer folds its
pid into the id's upper bits), ``args.parent_span_id`` points at the
parent span — possibly in another shard — and ``args.trace`` is the hex
trace id carried across the wire by the frame header's 16-byte context
(the reference's ``tpu_swirld/net/frame.py``).  Nothing here reads a clock: the merger
is a pure function of the shard files, so merging is reproducible.

CLI::

    python -m tpu_swirld_torch.obs.cluster_trace <cluster-workdir> \
        [-o merged.trace.json]

writes the wrapped ``{"traceEvents": [...]}`` form Perfetto opens
directly and prints a per-trace summary (span count, processes touched,
cross-process edges).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Tuple

from tpu_swirld_torch.obs.tracer import load_trace

#: shard filename suffix every cluster process uses
SHARD_SUFFIX = ".trace.jsonl"


def shard_label(path: str) -> str:
    """Process label from a shard filename: ``node-3.trace.jsonl`` ->
    ``n3``, ``client.trace.jsonl`` -> ``client``."""
    base = os.path.basename(path)
    stem = base[:-len(SHARD_SUFFIX)] if base.endswith(SHARD_SUFFIX) else base
    if stem.startswith("node-"):
        return "n" + stem[len("node-"):]
    return stem


def find_shards(dirpath: str) -> List[Tuple[str, str]]:
    """Sorted ``(label, path)`` shard list in a cluster workdir."""
    out = []
    for name in sorted(os.listdir(dirpath)):
        if name.endswith(SHARD_SUFFIX):
            path = os.path.join(dirpath, name)
            out.append((shard_label(path), path))
    return out


def _shard_offset_us(events: List[Dict]) -> Optional[float]:
    """Per-shard rebase offset: median of ``wall_s*1e6 - ts`` over spans
    (median, not mean — a wall-clock step mid-run must not skew every
    other span)."""
    deltas = []
    for e in events:
        if e.get("ph") in ("X", "i"):
            wall = (e.get("args") or {}).get("wall_s")
            if wall is not None:
                deltas.append(wall * 1e6 - e.get("ts", 0.0))
    if not deltas:
        return None
    deltas.sort()
    return deltas[len(deltas) // 2]


def merge_events(shards: List[Tuple[str, List[Dict]]]) -> List[Dict]:
    """Merge labeled shards into one event list on a shared timebase.

    Returns Chrome trace events: per-process metadata, every shard event
    rebased with ``pid`` = shard index, plus flow ``s``/``f`` pairs for
    cross-process parent/child span edges.
    """
    merged: List[Dict] = []
    offsets: List[Optional[float]] = []
    for _label, events in shards:
        offsets.append(_shard_offset_us(events))
    known = [o for o in offsets if o is not None]
    base = min(known) if known else 0.0

    # pass 1: rebase + index spans by (trace, span_id)
    span_at: Dict[Tuple[str, int], Dict] = {}
    for pid, (label, events) in enumerate(shards):
        merged.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": label},
        })
        off = offsets[pid]
        shift = (off - base) if off is not None else 0.0
        for e in events:
            e2 = dict(e, pid=pid, ts=round(e.get("ts", 0.0) + shift, 3))
            merged.append(e2)
            args = e2.get("args") or {}
            if e2.get("ph") == "X" and "span_id" in args and "trace" in args:
                span_at[(args["trace"], args["span_id"])] = e2

    # pass 2: flow arrows for edges whose parent lives in another shard
    flow_id = 0
    flows: List[Dict] = []
    for key in sorted(span_at):
        child = span_at[key]
        cargs = child["args"]
        parent_id = cargs.get("parent_span_id")
        if parent_id is None:
            continue
        parent = span_at.get((cargs["trace"], parent_id))
        if parent is None or parent["pid"] == child["pid"]:
            continue
        flow_id += 1
        common = {"name": "trace", "cat": "trace", "id": flow_id}
        flows.append(dict(
            common, ph="s", pid=parent["pid"], tid=parent.get("tid", 0),
            ts=parent["ts"],
        ))
        flows.append(dict(
            common, ph="f", bp="e", pid=child["pid"],
            tid=child.get("tid", 0), ts=child["ts"],
        ))
    merged.extend(flows)
    merged.sort(key=lambda e: (e.get("ts", 0.0), e.get("pid", 0)))
    return merged


def trace_summaries(merged: List[Dict]) -> Dict[str, Dict]:
    """Per-trace digest of a merged timeline: span count, processes
    touched, and the resolved parent/child edges (cross-process edges
    separately — the acceptance signal that propagation worked)."""
    spans: Dict[Tuple[str, int], Dict] = {}
    for e in merged:
        args = e.get("args") or {}
        if e.get("ph") == "X" and "trace" in args and "span_id" in args:
            spans[(args["trace"], args["span_id"])] = e
    out: Dict[str, Dict] = {}
    for key in sorted(spans):
        trace, _sid = key
        e = spans[key]
        t = out.setdefault(trace, {
            "spans": 0, "pids": [], "names": [],
            "edges": 0, "cross_process_edges": 0,
        })
        t["spans"] += 1
        if e["pid"] not in t["pids"]:
            t["pids"].append(e["pid"])
        if e["name"] not in t["names"]:
            t["names"].append(e["name"])
        parent_id = (e.get("args") or {}).get("parent_span_id")
        if parent_id is not None:
            parent = spans.get((trace, parent_id))
            if parent is not None:
                t["edges"] += 1
                if parent["pid"] != e["pid"]:
                    t["cross_process_edges"] += 1
    for t in out.values():
        t["pids"].sort()
    return out


def merge_dir(dirpath: str, out_path: Optional[str] = None) -> Dict:
    """Merge every shard in ``dirpath``; write the wrapped Chrome form
    when ``out_path`` is given.  Returns a JSON-ready summary."""
    shard_files = find_shards(dirpath)
    shards = [(label, load_trace(path)) for label, path in shard_files]
    merged = merge_events(shards)
    traces = trace_summaries(merged)
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump({"traceEvents": merged}, f)
    cross = sorted(
        t for t, info in traces.items() if len(info["pids"]) >= 2
    )
    return {
        "shards": [path for _label, path in shard_files],
        "events": len(merged),
        "out": out_path,
        "traces": len(traces),
        "cross_process_traces": len(cross),
        "cross_process_trace_ids": cross[:32],
        "per_trace": traces,
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_swirld_torch.obs.cluster_trace",
        description="Merge per-process trace shards into one timeline.",
    )
    p.add_argument("workdir", help="cluster workdir holding *.trace.jsonl")
    p.add_argument("-o", "--out", default=None,
                   help="write merged {'traceEvents': ...} JSON here")
    args = p.parse_args(argv)
    summary = merge_dir(args.workdir, out_path=args.out)
    brief = {k: v for k, v in summary.items() if k != "per_trace"}
    print(json.dumps(brief, indent=2, sort_keys=True))
    for trace in sorted(summary["per_trace"]):
        info = summary["per_trace"][trace]
        print(
            f"trace {trace}: {info['spans']} spans over "
            f"{len(info['pids'])} process(es), "
            f"{info['cross_process_edges']} cross-process edge(s)"
        )
    return 0


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv[1:]))
