"""Black-box flight recorder: bounded per-node rings + post-mortem dumps
(the port's copy of the reference's ``tpu_swirld/obs/flightrec.py``; the
dump schema is the same, so a dump of either package loads in the other).

Aviation-style observability for the consensus core: every node keeps a
bounded ring of its most recent activity (spans, counter deltas,
ingested-event digests, turn marks), and whenever something goes wrong —
a chaos/adversary verdict fails, an overflow heal fires, a circuit
breaker opens, a rebase storm triggers — the recorder writes one
*self-contained* post-mortem JSON: ring contents, the ambient registry
snapshot, the active config, and the decided frontier of every node.  A
red verdict thereby ships its own forensic bundle; no re-run needed.

Design constraints:

- *near-zero steady-state overhead*: recording is one dict append onto a
  ``deque(maxlen=capacity)``; nothing is serialized, hashed beyond an
  8-byte event-id prefix, or written to disk until a trigger fires;
- *bounded*: rings hold the last ``capacity`` entries per node and at
  most ``max_dumps`` dump files are ever written per recorder, so a
  trigger storm cannot fill the disk;
- *deterministic*: the recorder never reads wall time itself — the
  logical clock is an injected callable (the sim's turn counter), and
  the optional ``wall_clock`` stays ``None`` in simulations, so the same
  seed and trigger produce a byte-identical dump.

Sizing knobs resolve field > ``SWIRLD_FLIGHTREC_*`` env var > default
via :func:`tpu_swirld_torch.config.resolve_flightrec_settings`
(``SWIRLD_FLIGHTREC_CAPACITY``, ``SWIRLD_FLIGHTREC_MAX_DUMPS``,
``SWIRLD_FLIGHTREC_DIR``).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional

from tpu_swirld_torch.config import resolve_flightrec_settings

#: dump-file schema tag; bump on incompatible layout changes
SCHEMA = "tpu-swirld-flightrec/1"

#: trigger reasons wired in-tree (callers may add their own)
REASONS = (
    "verdict_failed", "overflow_heal", "breaker_open", "rebase_storm",
    "unclean_shutdown",
)


def _digest(eid) -> str:
    """Short stable digest of an event id (already a hash — 8-byte
    prefix is plenty for ring forensics)."""
    if isinstance(eid, (bytes, bytearray)):
        return bytes(eid[:8]).hex()
    return str(eid)[:16]


class FlightRecorder:
    """Bounded multi-node ring recorder with trigger-driven dumps.

    Args:
      capacity: ring entries kept per node (field>env>default: 256).
      dump_dir: where post-mortems land; ``None`` (the resolved default)
        records in memory only — :meth:`trigger` then returns ``None``.
      max_dumps: dump files written before further triggers only mark
        the ring (field>env>default: 16).
      clock: zero-arg logical-tick callable (sim turn counter); stamps
        every ring entry.  ``None`` → entries carry ``tick: None``.
      wall_clock: optional zero-arg wall-time callable for bench-side
        dumps; **leave None in simulations** so dumps stay byte-stable.
      config: optional :class:`~tpu_swirld_torch.config.SwirldConfig` — both
        the knob source and the config echoed into dumps.
      node_name: process identity stamped into every dump so shards
        from different node processes correlate against the merged
        cluster timeline.
      trace_provider: optional zero-arg callable returning the hex id of
        the currently active trace (e.g. ``Tracer.active_trace_hex``) —
        dumps record which cross-process trace was in flight when the
        trigger fired.  Stays ``None`` in simulations (byte-stable
        dumps).
    """

    def __init__(
        self,
        capacity: Optional[int] = None,
        dump_dir: Optional[str] = None,
        max_dumps: Optional[int] = None,
        clock: Optional[Callable[[], float]] = None,
        wall_clock: Optional[Callable[[], float]] = None,
        config=None,
        node_name: Optional[str] = None,
        trace_provider: Optional[Callable[[], Optional[str]]] = None,
    ):
        s = resolve_flightrec_settings(config)
        self.capacity = int(capacity if capacity is not None
                            else s["capacity"])
        self.max_dumps = int(max_dumps if max_dumps is not None
                             else s["max_dumps"])
        self.dump_dir = dump_dir if dump_dir is not None else s["dump_dir"]
        self._clock = clock
        self._wall = wall_clock
        self._config = config
        self.node_name = node_name
        self._trace_provider = trace_provider
        self._rings: Dict[str, collections.deque] = {}
        self.records_total = 0
        self.trigger_counts: Dict[str, int] = {}
        self.dumps: List[str] = []
        self._seq = 0

    # ------------------------------------------------------------ record

    def _ring(self, node) -> collections.deque:
        key = str(node)
        r = self._rings.get(key)
        if r is None:
            r = self._rings[key] = collections.deque(maxlen=self.capacity)
        return r

    def _tick(self):
        return self._clock() if self._clock is not None else None

    def record(self, node, kind: str, **fields) -> None:
        """Append one ring entry for ``node`` (the steady-state hot
        path: one dict build + deque append, no I/O)."""
        self.records_total += 1
        entry = {"kind": kind, "tick": self._tick()}
        entry.update(fields)
        self._ring(node).append(entry)

    def record_ingest(self, node, eid) -> None:
        """Digest of an event accepted into ``node``'s hashgraph."""
        self.record(node, "ingest", eid=_digest(eid))

    def record_counter(self, node, name: str, delta) -> None:
        """A counter moved (record the delta, not the absolute — rings
        replay as increments)."""
        self.record(node, "counter", name=str(name), delta=delta)

    def record_span(self, node, name: str, dur) -> None:
        """A completed span's duration (same unit as the clock)."""
        self.record(node, "span", name=str(name), dur=dur)

    def record_turn(self, node, turn: int, **fields) -> None:
        """Per-turn mark (decided watermark, new-event count, ...)."""
        self.record(node, "turn", turn=int(turn), **fields)

    # ----------------------------------------------------------- trigger

    def trigger(
        self,
        reason: str,
        node=None,
        detail=None,
        decided_frontier=None,
        registry=None,
    ) -> Optional[str]:
        """An anomaly fired: mark the ring and, when a ``dump_dir`` is
        configured and the ``max_dumps`` budget allows, write a
        post-mortem.  Returns the dump path or ``None``."""
        self.trigger_counts[reason] = self.trigger_counts.get(reason, 0) + 1
        self.record(node if node is not None else "_global", "trigger",
                    reason=str(reason), detail=detail)
        if registry is not None:
            registry.counter(
                "flightrec_triggers_total", {"reason": str(reason)}
            ).inc()
        path = None
        if self.dump_dir is not None:
            path = self.dump(
                reason, detail=detail, decided_frontier=decided_frontier,
                registry=registry,
            )
        return path

    # -------------------------------------------------------------- dump

    def snapshot(
        self, reason: str, detail=None, decided_frontier=None,
        registry=None,
    ) -> Dict:
        """The self-contained post-mortem body (also what :meth:`dump`
        writes).  Key order is canonical via ``sort_keys`` at write
        time; ``wall_time_s`` is ``None`` unless a wall clock was
        injected, so sim dumps are byte-stable."""
        cfg = None
        if self._config is not None:
            if dataclasses.is_dataclass(self._config):
                cfg = dataclasses.asdict(self._config)
            else:
                cfg = dict(getattr(self._config, "__dict__", {}) or {})
            if isinstance(cfg, dict):
                cfg = {
                    k: (list(v) if isinstance(v, tuple) else v)
                    for k, v in cfg.items()
                    if isinstance(v, (int, float, str, bool, tuple,
                                      list, type(None)))
                }
        return {
            "schema": SCHEMA,
            "reason": str(reason),
            "seq": self._seq,
            "node_name": self.node_name,
            "trace_id": (
                self._trace_provider()
                if self._trace_provider is not None else None
            ),
            "logical_tick": self._tick(),
            "wall_time_s": self._wall() if self._wall is not None else None,
            "capacity": self.capacity,
            "records_total": self.records_total,
            "trigger_counts": dict(sorted(self.trigger_counts.items())),
            "detail": detail,
            "config": cfg,
            "decided_frontier": decided_frontier,
            "registry": registry.to_dict() if registry is not None else None,
            "rings": {
                node: list(ring)
                for node, ring in sorted(self._rings.items())
            },
        }

    def dump(
        self, reason: str, detail=None, decided_frontier=None,
        registry=None,
    ) -> Optional[str]:
        """Write one post-mortem JSON; respects ``max_dumps``."""
        if self.dump_dir is None or len(self.dumps) >= self.max_dumps:
            return None
        self._seq += 1
        body = self.snapshot(
            reason, detail=detail, decided_frontier=decided_frontier,
            registry=registry,
        )
        os.makedirs(self.dump_dir, exist_ok=True)
        path = os.path.join(
            self.dump_dir, f"flightrec_{self._seq:03d}_{reason}.json"
        )
        with open(path, "w") as f:
            json.dump(body, f, indent=2, sort_keys=True)
            f.write("\n")
        self.dumps.append(path)
        if registry is not None:
            registry.counter("flightrec_dumps_total").inc()
            registry.gauge("flightrec_records_total").set(self.records_total)
        return path

    def summary(self) -> Dict:
        """Verdict-ready digest (dump paths, trigger counts, ring sizes)."""
        return {
            "records_total": self.records_total,
            "nodes": len(self._rings),
            "trigger_counts": dict(sorted(self.trigger_counts.items())),
            "dumps": list(self.dumps),
        }


def load_dump(path: str) -> Dict:
    """Load and schema-check a post-mortem written by :meth:`dump`."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != SCHEMA:
        raise ValueError(
            f"{path}: not a flight-recorder dump "
            f"(schema={doc.get('schema')!r}, want {SCHEMA!r})"
        )
    return doc


def wire_node(node, rec: FlightRecorder, label: str) -> None:
    """Attach ``rec`` to an oracle node: ingest digests flow into the
    ring and the node's circuit breaker reports open transitions as
    ``breaker_open`` triggers."""
    node.flightrec = rec
    node.flightrec_label = str(label)
    breaker = getattr(node, "breaker", None)
    if breaker is not None:
        def _on_open(peer, _rec=rec, _label=str(label)):
            _rec.trigger(
                "breaker_open", node=_label,
                detail={"peer": _digest(peer)},
            )
        breaker.on_open = _on_open
