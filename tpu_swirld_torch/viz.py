"""Visualization seam: state export + lightweight renderers (the port's
copy of the reference's ``tpu_swirld/viz.py``: the same rows and strings
for the same state).

The original prototype shipped a Bokeh app plotting the hashgraph (x =
member, y = height, color = round/fame) as its de-facto debugging oracle.
This module provides the same information dependency-free:

- :func:`export_state` — one dict per event: (creator, height, round,
  witness, famous, round received, consensus position).  Works for both
  an oracle :class:`Node` and a :class:`PackedDAG` + ``ConsensusResult``
  pair (a ``ConsensusResult`` holds host arrays whatever device computed
  it), so a result from the card is inspected with identical tooling.
- :func:`to_json` — the export, serialized.
- :func:`to_dot` — a Graphviz rendering (color = round, doubled border =
  witness, filled = famous) for quick ``dot -Tsvg`` inspection.
- :func:`ascii_lanes` — a terminal sketch: one lane per member, one row
  per height, round numbers in the cells.
- :func:`fame_gauges` — per-round decided/undecided witness-fame counts,
  recordable into an :class:`~tpu_swirld_torch.obs.registry.Registry` so one
  trace file carries both the timing spans and the DAG-shape gauges.
  ``to_dot`` / ``ascii_lanes`` annotate their output with these gauges.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple


def fame_gauges(rows: List[Dict], registry=None) -> Dict[int, Tuple[int, int]]:
    """Per-round ``(decided, undecided)`` witness-fame counts.

    ``rows`` is an :func:`export_state` export.  With ``registry=`` (an
    ``obs.Registry``), each round also lands as gauges
    ``round_fame_decided{round=r}`` / ``round_fame_undecided{round=r}``,
    joining the protocol gauges the report CLI renders.
    """
    acc: Dict[int, List[int]] = {}
    for r in rows:
        if not r["witness"] or r["round"] is None:
            continue
        cell = acc.setdefault(r["round"], [0, 0])
        cell[0 if r["famous"] is not None else 1] += 1
    gauges = {rnd: (d, u) for rnd, (d, u) in sorted(acc.items())}
    if registry is not None:
        for rnd, (d, u) in gauges.items():
            registry.gauge("round_fame_decided", {"round": str(rnd)}).set(d)
            registry.gauge("round_fame_undecided", {"round": str(rnd)}).set(u)
    return gauges


def _fame_summary(gauges: Dict[int, Tuple[int, int]], empty: str) -> str:
    return (
        " ".join(f"r{rnd}={d}/{d + u}" for rnd, (d, u) in gauges.items())
        or empty
    )


def export_state(node=None, packed=None, result=None) -> List[Dict]:
    """Per-event visualization records, in topo order."""
    if node is not None:
        rows = []
        order_pos = {e: i for i, e in enumerate(node.consensus)}
        for eid in node.order_added:
            ev = node.hg[eid]
            rows.append(
                {
                    "id": eid.hex()[:16],
                    "creator": node.member_index[ev.c],
                    "height": node.seq[eid],
                    "t": ev.t,
                    "round": node.round.get(eid),
                    "witness": bool(node.is_witness.get(eid, False)),
                    "famous": node.famous.get(eid),
                    "round_received": node.round_received.get(eid),
                    "order": order_pos.get(eid),
                    "parents": [p.hex()[:16] for p in ev.p],
                }
            )
        return rows
    if packed is None or result is None:
        raise ValueError("pass either node= or (packed=, result=)")
    order_pos = {i: k for k, i in enumerate(result.order)}
    rows = []
    for i in range(packed.n):
        rr = int(result.round_received[i])
        rows.append(
            {
                "id": packed.ids[i].hex()[:16],
                "creator": int(packed.creator[i]),
                "height": int(packed.seq[i]),
                "t": int(packed.t[i]),
                "round": int(result.round[i]),
                "witness": bool(result.is_witness[i]),
                "famous": result.famous.get(i),
                "round_received": rr if rr >= 0 else None,
                "order": order_pos.get(i),
                "parents": [
                    packed.ids[int(p)].hex()[:16]
                    for p in packed.parents[i]
                    if p >= 0
                ],
            }
        )
    return rows


def to_json(path: Optional[str] = None, **kw) -> str:
    s = json.dumps(export_state(**kw), indent=1)
    if path:
        with open(path, "w") as f:
            f.write(s)
    return s


_PALETTE = [
    "#8dd3c7", "#ffffb3", "#bebada", "#fb8072", "#80b1d3",
    "#fdb462", "#b3de69", "#fccde5", "#d9d9d9", "#bc80bd",
]


def to_dot(registry=None, **kw) -> str:
    """Graphviz: color = round, peripheries = witness, bold = famous.
    The graph label summarizes per-round fame progress (decided/undecided
    witnesses); ``registry=`` also records those gauges."""
    rows = export_state(**kw)
    gauges = fame_gauges(rows, registry=registry)
    label = "fame per round: " + _fame_summary(gauges, "(no witnesses)")
    lines = [
        "digraph hashgraph {",
        "  rankdir=BT; node [style=filled, shape=box, fontsize=9];",
        f'  labelloc="t"; label="{label}";',
    ]
    for r in rows:
        color = _PALETTE[(r["round"] or 0) % len(_PALETTE)]
        attrs = [f'fillcolor="{color}"']
        attrs.append(f'label="m{r["creator"]}h{r["height"]}\\nr{r["round"]}"')
        if r["witness"]:
            attrs.append("peripheries=2")
        if r["famous"]:
            attrs.append("penwidth=3")
        lines.append(f'  "{r["id"]}" [{", ".join(attrs)}];')
        for p in r["parents"]:
            lines.append(f'  "{r["id"]}" -> "{p}";')
    lines.append("}")
    return "\n".join(lines)


def ascii_lanes(max_height: int = 24, registry=None, **kw) -> str:
    """Terminal sketch: members as columns, heights as rows, cells show the
    round number (* witness, ! famous).  A footer summarizes per-round
    fame progress; ``registry=`` also records the gauges."""
    rows = export_state(**kw)
    n_members = max(r["creator"] for r in rows) + 1
    grid: Dict[int, Dict[int, str]] = {}
    top = 0
    for r in rows:
        h = r["height"]
        top = max(top, h)
        mark = str(r["round"] if r["round"] is not None else "?")
        if r["famous"]:
            mark += "!"
        elif r["witness"]:
            mark += "*"
        grid.setdefault(h, {})[r["creator"]] = mark
    lines = [
        "height | " + " ".join(f"m{i:<3}" for i in range(n_members)),
        "-" * (9 + 5 * n_members),
    ]
    lo = max(0, top - max_height + 1)
    for h in range(top, lo - 1, -1):
        cells = [f"{grid.get(h, {}).get(m, ''):<4}" for m in range(n_members)]
        lines.append(f"{h:6} | " + " ".join(cells))
    gauges = fame_gauges(rows, registry=registry)
    lines.append("-" * (9 + 5 * n_members))
    lines.append(
        "fame decided/witnesses per round: "
        + _fame_summary(gauges, "(none)")
    )
    return "\n".join(lines)
