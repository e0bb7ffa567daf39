"""Scale envelopes: the declared operating points the audit proves safe
(the port's copy of the reference's ``tpu_swirld/analysis/flow/
envelope.py``: the same presets and host checks, paths in the port).

An envelope is a *claim about inputs*: how many events, members, window
columns, rounds-in-flight, fork groups, how large a stake or timestamp
can get.  The auditor runs every stage body on fake tensors at the
envelope's shapes and seeds the interpreter with the envelope's value
intervals; everything
downstream is then *derived*, so "no int32 wraps at 1M events" is a
theorem about the envelope, not a hope about test data.

Presets:

``baseline``
    the tier-1 / bench operating point — 8 members, 4k events, default
    window buckets.  Fast to interpret.

``1m``
    ROADMAP item 4's target — 2**20 events, 256 members, grown window
    buckets, per-member stake up to 2**15 (so total stake stays under
    the 2**24 exact-f32 tally limit the pipeline's GEMM path is gated
    on), timestamps strictly below ``INT32_MAX`` (the order-stage
    sentinel — the packer enforces this bound on ingest).

``custom``
    ``1m`` with ``--set field=value`` overrides from the CLI.

Envelope invariants that are *checked here* (host-side closed-form,
because the store/packing layers are numpy, not stage bodies) live in
:func:`host_envelope_findings`: packed-dtype headroom for event counts,
timestamp-vs-sentinel headroom, stake totals vs the exact-f32 limit,
and archive block-offset arithmetic.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpu_swirld_torch.analysis.lint import Finding

INT32_MAX = int(np.iinfo(np.int32).max)

#: exact-integer limit of float32 (the gate of ``fame_scan``'s float32
#: tally, ``exact_tally`` in ``gpu/pipeline.py``)
F32_EXACT = 1 << 24

_PIPELINE = "tpu_swirld_torch/gpu/pipeline.py"


@dataclasses.dataclass(frozen=True)
class ScaleEnvelope:
    """Declared operating point for the scale audit."""

    name: str
    events: int          # total events ingested (N)
    members: int         # member count (M)
    rows: int            # resident window rows after bucket growth
    wcols: int           # witness/window column cap (_wcol_cap growth)
    chunk: int           # ingest chunk
    block: int           # ssm block tile
    r_cap: int           # rounds-in-flight cap in the window tables
    s_cap: int           # slots per round (forks: members + 1)
    k_cap: int           # fork-tips per member cap
    chain_cap: int       # self-parent chain walk cap
    fork_groups: int     # fork accusation table rows (G)
    stake_max: int       # per-member stake bound
    t_max: int           # timestamp bound (strictly below the sentinel)
    coin_period: int = 6
    mesh_devices: int = 8
    sentinels: Tuple[int, ...] = (INT32_MAX,)

    @property
    def tot_stake(self) -> int:
        return self.members * self.stake_max

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["tot_stake"] = self.tot_stake
        return d


_PRESETS: Dict[str, ScaleEnvelope] = {
    "baseline": ScaleEnvelope(
        name="baseline",
        events=4096,
        members=8,
        rows=2048,
        wcols=256,
        chunk=128,
        block=128,
        r_cap=32,
        s_cap=9,
        k_cap=8,
        chain_cap=32,
        fork_groups=64,
        stake_max=64,
        t_max=1 << 24,
    ),
    "1m": ScaleEnvelope(
        name="1m",
        events=1 << 20,
        members=256,
        rows=16384,
        wcols=1024,
        chunk=256,
        block=128,
        r_cap=64,
        s_cap=257,
        k_cap=8,
        chain_cap=64,
        fork_groups=256,
        stake_max=1 << 15,
        t_max=INT32_MAX - 1,
    ),
}


def get_envelope(name: str,
                 overrides: Optional[Dict[str, int]] = None) -> ScaleEnvelope:
    """Resolve a preset (``baseline``/``1m``) or ``custom`` (= ``1m`` plus
    ``overrides``)."""
    if name == "custom":
        base = _PRESETS["1m"]
        fields = {f.name for f in dataclasses.fields(ScaleEnvelope)}
        bad = set(overrides or ()) - fields
        if bad:
            raise ValueError(f"unknown envelope fields: {sorted(bad)}")
        return dataclasses.replace(base, name="custom", **(overrides or {}))
    if name not in _PRESETS:
        raise ValueError(
            f"unknown envelope {name!r} (baseline | 1m | custom)")
    if overrides:
        return dataclasses.replace(_PRESETS[name], **overrides)
    return _PRESETS[name]


def preset_names() -> List[str]:
    return sorted(_PRESETS) + ["custom"]


# --------------------------------------------------------------------------
# host-side closed-form checks (store/ and packing are numpy, not stage
# bodies)


def _finding(rule, path, msg, line=0):
    from tpu_swirld_torch.analysis.flow.interpret import RULE_NAMES

    return Finding(rule, RULE_NAMES.get(rule, rule), path, line, 0, msg)


def _gate_line() -> int:
    """The line of ``fame_scan``'s ``exact_tally`` gate in the port's
    pipeline (0 when the file is not beside this package)."""
    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "..", "gpu", "pipeline.py"
    )
    try:
        with open(path, encoding="utf-8") as f:
            for i, text in enumerate(f, 1):
                if "exact_tally = " in text:
                    return i
    except OSError:
        pass
    return 0


def host_envelope_findings(env: ScaleEnvelope) -> List[Finding]:
    """Closed-form envelope checks for the host-side (numpy) layers.

    These mirror what the interpreter proves for the stage bodies:
    every packed int32 field, archive offset product, and sentinel
    comparison is evaluated symbolically at the envelope bounds.
    """
    out: List[Finding] = []
    N, M = env.events, env.members

    # packing.py: event ids, parent ids, creator, seq are int32.
    for what, hi in (
        ("event index / parent id", N - 1),
        ("creator index", M - 1),
        ("per-creator seq", N - 1),
    ):
        if hi > INT32_MAX:
            out.append(_finding(
                "SW008", "tpu_swirld_torch/packing.py",
                f"envelope {env.name}: {what} can reach {hi}, outside "
                f"int32 — packed columns wrap"))

    # packing.py: timestamps are compared against the INT32_MAX order
    # sentinel on device; the packer must keep them strictly below it.
    if env.t_max >= min(env.sentinels, default=INT32_MAX):
        out.append(_finding(
            "SW011", "tpu_swirld_torch/packing.py",
            f"envelope {env.name}: timestamp bound {env.t_max} reaches the "
            f"order-stage sentinel {min(env.sentinels)} — a live timestamp "
            f"becomes indistinguishable from padding"))

    # fame_scan's f32 tally gate: integer tallies carried in f32 stay
    # exact only below 2**24 (``exact_tally`` switches to the int32 path
    # at runtime; the envelope must satisfy the bound statically too).
    if env.tot_stake >= F32_EXACT:
        out.append(_finding(
            "SW008", _PIPELINE,
            f"envelope {env.name}: total stake {env.tot_stake} reaches the "
            f"exact-f32 limit 2**24 — fused GEMM tally path loses votes",
            _gate_line()))

    # supermajority arithmetic 3*acc vs 2*tot in int32
    if 3 * env.tot_stake > INT32_MAX:
        out.append(_finding(
            "SW008", _PIPELINE,
            f"envelope {env.name}: 3*tot_stake = {3 * env.tot_stake} wraps "
            f"int32 in the supermajority comparison"))

    # store/slab + archive: byte offsets of the largest slab (rows x
    # wcols int32 plus bool planes) must fit in int64 (numpy indexing)
    # and element counts in int32 where stored as int32 columns.
    slab_elems = env.rows * max(env.wcols, M)
    if slab_elems > INT32_MAX:
        out.append(_finding(
            "SW008", "tpu_swirld_torch/store/slab.py",
            f"envelope {env.name}: slab element count {slab_elems} exceeds "
            f"int32 — int32 column indexing wraps"))
    archive_bytes = N * (2 + 1 + 1 + 1) * 4 + N * 8  # packed cols + t int64
    if archive_bytes > (1 << 62):
        out.append(_finding(
            "SW008", "tpu_swirld_torch/store/archive.py",
            f"envelope {env.name}: archive byte extent {archive_bytes} "
            f"overflows int64 offsets"))

    # window bookkeeping: rows grow in buckets; a full window of wcols
    # witness columns indexed by int32 column ids.
    if env.rows > INT32_MAX or env.wcols > INT32_MAX:
        out.append(_finding(
            "SW008", _PIPELINE,
            f"envelope {env.name}: window extents ({env.rows} x {env.wcols}) "
            f"exceed int32 indexing"))
    return out
