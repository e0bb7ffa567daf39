"""Nested-span tracer with JSONL export (Chrome trace-event compatible; the
port's copy of the reference's ``tpu_swirld/obs/tracer.py``).

Each finished span becomes one JSON object — one per line in the exported
file — using the Chrome trace-event "complete" form (``ph: "X"``)::

    {"name": "oracle.divide_rounds", "ph": "X", "pid": 0, "tid": 0,
     "ts": 12.5, "dur": 834.2, "args": {"depth": 1, "wall_s": 1754...}}

``ts``/``dur`` are microseconds on the tracer's *monotonic* clock
(``time.perf_counter`` relative to the tracer epoch — immune to wall-clock
steps); the wall-clock start time rides in ``args.wall_s`` so traces can be
correlated with external logs.  ``args.depth`` records the nesting level at
emit time (Chrome infers nesting from ts/dur overlap; the report CLI uses
the explicit depth).  A file of these lines loads directly into
``chrome://tracing`` / Perfetto after wrapping in ``[...]`` —
:func:`save_chrome` writes that wrapped form, :meth:`Tracer.save` the JSONL.

Disabled mode: :data:`NULL_TRACER` answers every ``span()`` call with one
shared no-op context manager — no allocation, no timestamps, nothing
recorded — so instrumentation can unconditionally ``with tracer.span(...)``
once it holds *a* tracer.  Call sites that may hold ``None`` instead should
branch (``if tracer is not None``), which is the pattern the hot paths use.

Trace identity (cluster mode): every enabled span gets a process-unique
``span_id`` (upper bits derived from the tracer ``pid`` so ids from
different node processes never collide in a merged timeline).  A span may
additionally belong to a *trace* — an 8-byte id carried across process
boundaries inside the 16-byte wire context built by :func:`pack_context`
(trace id + parent span id).  :meth:`Tracer.span_under` opens a span whose
parent lives in another process; :meth:`Tracer.active_context` exports the
innermost traced span as wire bytes for the transport to stamp onto
outgoing frames.  ``obs/cluster_trace.py`` reassembles the shards.
"""

from __future__ import annotations

import json
import struct
import time
from typing import Dict, List, Optional, Tuple

#: wire size of a packed trace context (8-byte trace id + u64 span id)
TRACE_CTX_LEN = 16

_CTX = struct.Struct("<8sQ")


def pack_context(trace_id: bytes, span_id: int) -> bytes:
    """Pack an (8-byte trace id, span id) pair into wire bytes."""
    if len(trace_id) != 8:
        raise ValueError(f"trace id must be 8 bytes, got {len(trace_id)}")
    return _CTX.pack(trace_id, span_id)


def unpack_context(ctx: bytes) -> Tuple[bytes, int]:
    """Inverse of :func:`pack_context`; raises ``ValueError`` on bad size."""
    if len(ctx) != TRACE_CTX_LEN:
        raise ValueError(
            f"trace context must be {TRACE_CTX_LEN} bytes, got {len(ctx)}"
        )
    return _CTX.unpack(ctx)


class _SpanHandle:
    """Mutable args bag yielded by ``Tracer.span`` — mutate ``args`` inside
    the ``with`` block to attach data to the emitted event."""

    __slots__ = (
        "name", "args", "_t0_mono", "_wall_s",
        "span_id", "trace_id", "parent_id",
    )

    def __init__(self, name: str, args: Dict, t0_mono: float, wall_s: float,
                 trace_id: Optional[bytes] = None,
                 parent_id: Optional[int] = None):
        self.name = name
        self.args = args
        self._t0_mono = t0_mono
        self._wall_s = wall_s
        self.span_id = 0
        self.trace_id = trace_id
        self.parent_id = parent_id


class _NullSpan:
    """Shared no-op context manager (also serves as a null span handle)."""

    __slots__ = ()

    @property
    def args(self) -> Dict:
        # a fresh throwaway dict per access: annotation writes vanish
        # instead of accumulating in (or leaking through) shared state
        return {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every call returns the one shared no-op span."""

    __slots__ = ()
    enabled = False
    events: List[Dict] = []

    def span(self, name: str, **args):
        return _NULL_SPAN

    def span_under(self, name: str, ctx=None, **args):
        return _NULL_SPAN

    def instant(self, name: str, **args) -> None:
        pass

    def active_context(self):
        return None

    def active_trace_hex(self):
        return None

    def save(self, path: str) -> None:
        raise RuntimeError("NullTracer records nothing; nothing to save")


NULL_TRACER = NullTracer()


class _SpanCtx:
    """The live span context manager (one allocation per enabled span)."""

    __slots__ = ("_tracer", "_handle")

    def __init__(self, tracer: "Tracer", handle: _SpanHandle):
        self._tracer = tracer
        self._handle = handle

    def __enter__(self) -> _SpanHandle:
        h = self._handle
        t = self._tracer
        h.span_id = t._new_span_id()
        if t._stack:
            top = t._stack[-1]
            # inherit trace identity / local parent from the enclosing span
            # unless a remote parent context was given explicitly
            if h.trace_id is None:
                h.trace_id = top.trace_id
            if h.parent_id is None:
                h.parent_id = top.span_id
        h._wall_s = time.time()
        h._t0_mono = time.perf_counter()   # re-stamped at entry, not creation
        t._stack.append(h)
        return h

    def __exit__(self, *exc):
        t = self._tracer
        h = t._stack.pop()
        end = time.perf_counter()
        args = dict(
            h.args, depth=len(t._stack), wall_s=round(h._wall_s, 6),
            span_id=h.span_id,
        )
        if h.parent_id is not None:
            args["parent_span_id"] = h.parent_id
        if h.trace_id is not None:
            args["trace"] = h.trace_id.hex()
        t._append(
            {
                "name": h.name,
                "ph": "X",
                "pid": t.pid,
                "tid": t.tid,
                "ts": round((h._t0_mono - t._epoch_mono) * 1e6, 3),
                "dur": round((end - h._t0_mono) * 1e6, 3),
                "args": args,
            }
        )
        return False


class Tracer:
    """Collects spans + instant events; exports JSONL / Chrome traces."""

    enabled = True

    def __init__(self, pid: int = 0, tid: int = 0,
                 max_events: Optional[int] = None):
        self.pid = pid
        self.tid = tid
        self.events: List[Dict] = []
        self.dropped = 0
        self.max_events = max_events
        self._stack: List[_SpanHandle] = []
        self._epoch_mono = time.perf_counter()
        self._epoch_wall = time.time()
        self._span_seq = 0

    # ------------------------------------------------------------ recording

    def _new_span_id(self) -> int:
        """Process-unique span id: pid in the upper bits, a sequence number
        below, so shards from different node processes never collide."""
        self._span_seq += 1
        return (((self.pid & 0xFFFF) + 1) << 32) | self._span_seq

    def _append(self, event: Dict) -> None:
        """Record one event, honoring the optional ``max_events`` cap
        (long soaks keep bounded memory; drops are counted, not silent)."""
        if self.max_events is not None and len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(event)

    def span(self, name: str, **args) -> _SpanCtx:
        """Context manager timing a nested span.  Yields a handle whose
        ``.args`` dict can be mutated to annotate the emitted event."""
        return _SpanCtx(
            self, _SpanHandle(name, args, time.perf_counter(), time.time())
        )

    def span_under(self, name: str, ctx: Optional[bytes] = None,
                   **args) -> _SpanCtx:
        """Like :meth:`span`, but parented under a *wire* trace context
        (16 bytes from :func:`pack_context`, e.g. received in a frame
        header).  ``None``/empty ctx degrades to a plain :meth:`span`; a
        zero parent span id means "root of the trace"."""
        if not ctx:
            return self.span(name, **args)
        trace_id, parent = unpack_context(ctx)
        return _SpanCtx(
            self,
            _SpanHandle(
                name, args, time.perf_counter(), time.time(),
                trace_id=trace_id, parent_id=parent if parent else None,
            ),
        )

    def active_context(self) -> Optional[bytes]:
        """Wire context of the innermost *traced* open span (16 bytes), or
        ``None`` when no open span carries a trace id.  This is what the
        socket transport stamps onto outgoing frames."""
        for h in reversed(self._stack):
            if h.trace_id is not None:
                return pack_context(h.trace_id, h.span_id)
        return None

    def active_trace_hex(self) -> Optional[str]:
        """Hex trace id of the innermost traced open span, or ``None``
        (flight-recorder dumps embed this for cross-shard correlation)."""
        for h in reversed(self._stack):
            if h.trace_id is not None:
                return h.trace_id.hex()
        return None

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker event (Chrome ``ph: "i"``)."""
        args = dict(args, depth=len(self._stack))
        args.setdefault("wall_s", round(time.time(), 6))
        trace = self.active_trace_hex()
        if trace is not None:
            args.setdefault("trace", trace)
        self._append(
            {
                "name": name,
                "ph": "i",
                "pid": self.pid,
                "tid": self.tid,
                "ts": round((time.perf_counter() - self._epoch_mono) * 1e6, 3),
                "s": "t",
                "args": args,
            }
        )

    def counter_event(
        self, name: str, value: float, labels: Optional[Dict] = None
    ) -> Dict:
        """Build (without recording) a Chrome counter sample (``ph: "C"``)
        — ``Obs.save`` uses these to embed the registry snapshot in the
        trace file without mutating the tracer."""
        args: Dict = {}
        for k, v in (labels or {}).items():
            # "value" is reserved for the sample itself; don't conflate
            args["label_value" if k == "value" else k] = v
        args["value"] = value
        return {
            "name": name,
            "ph": "C",
            "pid": self.pid,
            "ts": round((time.perf_counter() - self._epoch_mono) * 1e6, 3),
            "args": args,
        }

    def counter(
        self, name: str, value: float, labels: Optional[Dict] = None
    ) -> None:
        """Record a Chrome counter sample."""
        self._append(self.counter_event(name, value, labels))

    @property
    def depth(self) -> int:
        return len(self._stack)

    # -------------------------------------------------------------- queries

    def spans(self) -> List[Dict]:
        return [e for e in self.events if e.get("ph") == "X"]

    def phase_seconds(self, depth: int = 0) -> Dict[str, float]:
        """Total seconds per span name at one nesting depth — the
        phase-breakdown aggregation bench.py publishes."""
        out: Dict[str, float] = {}
        for e in self.spans():
            if e["args"].get("depth") == depth:
                out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e6
        return out

    # ------------------------------------------------------------ export/io

    def save(self, path: str) -> None:
        """JSONL: one Chrome trace event per line."""
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e) + "\n")

    def save_chrome(self, path: str) -> None:
        """The ``{"traceEvents": [...]}`` wrapped form chrome://tracing and
        Perfetto open directly."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def load_trace(path: str) -> List[Dict]:
    """Read a trace written by :meth:`Tracer.save` (JSONL) or
    :meth:`Tracer.save_chrome` (wrapped JSON) back into an event list."""
    with open(path) as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped.startswith("{") and '"traceEvents"' in stripped[:200]:
        return json.loads(stripped)["traceEvents"]
    if stripped.startswith("["):
        return json.loads(stripped)
    events = []
    for line in text.splitlines():
        line = line.strip()
        if line:
            events.append(json.loads(line))
    return events
