"""Counter / gauge / histogram registry with Prometheus-text and JSON export
(the port's copy of the reference's ``tpu_swirld/obs/registry.py``: the
same calls give byte-equal exports in both packages).

The protocol-gauge half of the observability subsystem (the span half lives
in :mod:`tpu_swirld_torch.obs.tracer`).  Design constraints, in order:

1. *Zero cost when nobody holds a registry* — metric objects are created
   lazily by the instrumented call sites only when an enabled registry is
   in scope; the disabled path never allocates (see ``obs.current()``).
2. *Exact* — counters and gauges are plain Python ints/floats, no sampling.
3. *Exportable* — ``to_prometheus_text()`` renders the standard text
   exposition format (``# TYPE`` headers, ``name{label="v"} value`` lines);
   ``to_json()`` renders a stable dict for BENCH-style JSON artifacts.

Metric identity is ``(name, sorted(labels))``; the same call site with the
same labels always returns the same object, so hot loops may cache the
metric handle themselves if they want to skip the dict lookup.
"""

from __future__ import annotations

import json
import math
import re
from typing import Dict, List, Optional, Tuple

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

# default histogram buckets: exponential, suited to seconds-scale latencies
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

LabelDict = Optional[Dict[str, str]]


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _label_key(labels: LabelDict) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(items: Tuple[Tuple[str, str], ...]) -> str:
    if not items:
        return ""
    # Prometheus text exposition: label values escape backslash, quote,
    # AND newline (a raw newline would split the sample line and break
    # the scrape)
    body = ",".join(
        '%s="%s"' % (
            k,
            v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n"),
        )
        for k, v in items
    )
    return "{%s}" % body


class Counter:
    """Monotonically increasing value (float to allow seconds totals)."""

    kind = "counter"

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, delta: float = 1.0) -> None:
        if delta < 0:
            raise ValueError("counters only go up; use a Gauge")
        self.value += delta


class Gauge:
    """Point-in-time value; settable in any direction."""

    kind = "gauge"

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, delta: float = 1.0) -> None:
        self.value += delta

    def dec(self, delta: float = 1.0) -> None:
        self.value -= delta


class Histogram:
    """Fixed-bucket histogram tracking count / sum / min / max.

    Buckets are cumulative upper bounds (Prometheus ``le`` semantics); the
    implicit ``+Inf`` bucket is always present.
    """

    kind = "histogram"

    __slots__ = ("name", "labels", "buckets", "bucket_counts", "count",
                 "sum", "min", "max")

    def __init__(
        self,
        name: str,
        labels: Tuple[Tuple[str, str], ...] = (),
        buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
    ):
        self.name = name
        self.labels = labels
        self.buckets = tuple(sorted(buckets))
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class Registry:
    """Get-or-create store of metrics, keyed by (name, labels)."""

    def __init__(self) -> None:
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object] = {}
        self._kinds: Dict[str, type] = {}   # one kind per name, all labels

    def __len__(self) -> int:
        return len(self._metrics)

    def _get(self, cls, name: str, labels: LabelDict, **kw):
        name = _sanitize(name)
        kind = self._kinds.get(name)
        if kind is None:
            self._kinds[name] = cls
        elif kind is not cls:
            # a name must have ONE kind across every label set, or the
            # Prometheus exposition (one # TYPE header per name) is invalid
            raise TypeError(
                f"metric {name!r} already registered as {kind.__name__}"
            )
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, key[1], **kw)
            self._metrics[key] = m
        return m

    def counter(self, name: str, labels: LabelDict = None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels: LabelDict = None) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(
        self,
        name: str,
        labels: LabelDict = None,
        buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
    ) -> Histogram:
        h = self._get(Histogram, name, labels, buckets=buckets)
        if h.buckets != tuple(sorted(buckets)):
            # _get only applies buckets on first creation; a silent
            # mismatch would scatter observations across wrong buckets
            raise ValueError(
                f"histogram {name!r} already registered with different "
                f"buckets"
            )
        return h

    # ------------------------------------------------------------- queries

    def metrics(self) -> List[object]:
        """All metrics, sorted by (name, labels) for stable export order."""
        return [self._metrics[k] for k in sorted(self._metrics)]

    def collect(self, name: str) -> Dict[Tuple[Tuple[str, str], ...], object]:
        """All label-variants of one metric name."""
        name = _sanitize(name)
        return {
            k[1]: m for k, m in self._metrics.items() if k[0] == name
        }

    def value(self, name: str, labels: LabelDict = None, default=None):
        """Read a metric's value without creating it."""
        m = self._metrics.get((_sanitize(name), _label_key(labels)))
        if m is None:
            return default
        return m.count if isinstance(m, Histogram) else m.value

    # ------------------------------------------------------------ exporters

    def to_prometheus_text(self, prefix: str = "") -> str:
        """Standard Prometheus text exposition format."""
        prefix = _sanitize(prefix) if prefix else ""
        lines: List[str] = []
        seen_type: set = set()
        for m in self.metrics():
            full = prefix + m.name
            if full not in seen_type:
                lines.append(f"# TYPE {full} {m.kind}")
                seen_type.add(full)
            lab = m.labels
            if isinstance(m, Histogram):
                cum = 0
                for ub, c in zip(m.buckets, m.bucket_counts):
                    cum += c
                    items = lab + (("le", repr(float(ub))),)
                    lines.append(f"{full}_bucket{_render_labels(items)} {cum}")
                cum += m.bucket_counts[-1]
                items = lab + (("le", "+Inf"),)
                lines.append(f"{full}_bucket{_render_labels(items)} {cum}")
                lines.append(f"{full}_sum{_render_labels(lab)} {_fmt(m.sum)}")
                lines.append(f"{full}_count{_render_labels(lab)} {m.count}")
            else:
                lines.append(f"{full}{_render_labels(lab)} {_fmt(m.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_dict(self) -> Dict[str, Dict]:
        """JSON-ready snapshot: one entry per (name, labels) variant."""
        out: Dict[str, Dict] = {}
        for m in self.metrics():
            key = m.name + _render_labels(m.labels)
            if isinstance(m, Histogram):
                out[key] = {
                    "kind": m.kind,
                    "count": m.count,
                    "sum": round(m.sum, 9),
                    "mean": round(m.mean, 9),
                    "min": None if m.count == 0 else round(m.min, 9),
                    "max": None if m.count == 0 else round(m.max, 9),
                }
            else:
                out[key] = {"kind": m.kind, "value": _num(m.value)}
        return out

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    # ------------------------------------------------- structured samples

    def to_samples(self) -> List[Dict]:
        """Structured, JSON-ready sample list that survives a wire hop
        and reloads losslessly via :meth:`load_samples` — the body of a
        cluster ``KIND_METRICS`` reply.  Unlike :meth:`to_dict` (whose
        keys are rendered label strings), labels stay a dict so a
        receiver can re-label (e.g. add ``node=...``) before merging."""
        out: List[Dict] = []
        for m in self.metrics():
            s: Dict = {
                "name": m.name, "kind": m.kind, "labels": dict(m.labels),
            }
            if isinstance(m, Histogram):
                s["buckets"] = [float(b) for b in m.buckets]
                s["bucket_counts"] = list(m.bucket_counts)
                s["count"] = m.count
                s["sum"] = m.sum
                s["min"] = None if m.count == 0 else m.min
                s["max"] = None if m.count == 0 else m.max
            else:
                s["value"] = m.value
            out.append(s)
        return out

    def load_samples(
        self, samples: List[Dict], extra_labels: LabelDict = None,
    ) -> None:
        """Merge :meth:`to_samples` output into this registry, optionally
        re-labeled (``extra_labels``).  Counters and histograms *add*
        (so loading N node snapshots yields cluster totals when the
        extra labels are omitted); gauges overwrite."""
        for s in samples:
            labels = dict(s.get("labels") or {})
            labels.update(extra_labels or {})
            kind = s.get("kind")
            if kind == "counter":
                self.counter(s["name"], labels).inc(float(s["value"]))
            elif kind == "gauge":
                self.gauge(s["name"], labels).set(float(s["value"]))
            elif kind == "histogram":
                h = self.histogram(
                    s["name"], labels, buckets=tuple(s["buckets"]),
                )
                counts = [int(c) for c in s["bucket_counts"]]
                if len(counts) != len(h.bucket_counts):
                    raise ValueError(
                        f"histogram {s['name']!r}: bucket count mismatch"
                    )
                for i, c in enumerate(counts):
                    h.bucket_counts[i] += c
                h.count += int(s["count"])
                h.sum += float(s["sum"])
                if s.get("min") is not None and s["min"] < h.min:
                    h.min = float(s["min"])
                if s.get("max") is not None and s["max"] > h.max:
                    h.max = float(s["max"])
            else:
                raise ValueError(f"unknown sample kind {kind!r}")


def merge_node_samples(per_node: Dict[str, List[Dict]]) -> "Registry":
    """One merged registry from per-node sample lists: every sample is
    re-labeled with its ``node``, so the Prometheus exposition carries
    the whole fleet without name collisions."""
    merged = Registry()
    for node in sorted(per_node):
        merged.load_samples(per_node[node], extra_labels={"node": node})
    return merged


def rollup_node_samples(per_node: Dict[str, List[Dict]]) -> Dict[str, float]:
    """Cluster-wide scalar rollup: counters and gauges summed across
    nodes per (name, labels) — the at-a-glance fleet totals the verdict
    and the report CLI render."""
    totals: Dict[str, float] = {}
    for node in sorted(per_node):
        for s in per_node[node]:
            if s.get("kind") == "histogram":
                key = s["name"] + _render_labels(
                    _label_key(s.get("labels") or {})
                ) + "_count"
                totals[key] = totals.get(key, 0.0) + float(s["count"])
            else:
                key = s["name"] + _render_labels(
                    _label_key(s.get("labels") or {})
                )
                totals[key] = totals.get(key, 0.0) + float(s["value"])
    return {k: _num(v) for k, v in sorted(totals.items())}


def _num(v: float):
    """Render integral floats as ints (counters are usually counts)."""
    return int(v) if float(v).is_integer() else round(v, 9)


def _fmt(v: float) -> str:
    return str(_num(v))
