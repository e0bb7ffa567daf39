"""Scale-audit driver: prove every consensus stage safe at an envelope (the
port's counterpart of the reference's ``tpu_swirld/analysis/flow/
audit.py``).

``scale_audit`` runs each catalog stage (:mod:`.stages`) on fake tensors
at the envelope's shapes through the abstract interpreter, applies the
``# swirld-lint: disable=SW00x -- <why>`` suppressions from the flagged
source lines (the justification text after ``--`` is *required*; a bare
disable is itself a failure), folds in the host-side closed-form checks
(:func:`~.envelope.host_envelope_findings`), and verifies stage coverage:
every ``obs.stage_call`` name a real small run of each engine emits must
map to at least one audited spec.

Teeth are proven, not assumed: ``--mutate`` re-runs the audit against a
seeded defect (an int16-narrowed tally accumulator, a dropped index
clamp) mirroring the real stage code; the auditor must pinpoint it.  The
tier-1 tests assert the exact rule, file, line and op for each mutation,
so a silently weakened transfer function fails CI.

:func:`soundness_check` is the audit's soundness property: every stage a
real small run of an engine dispatches is replayed through the
interpreter at its concrete arguments' intervals, and every output the
stage really computed (on the card, when ``device="cuda"``: the hand
kernels' outputs) must lie inside its abstract interval.

Exit codes (``python -m tpu_swirld_torch.analysis scale-audit``):

* ``0`` — proven clean at the envelope (all findings suppressed with
  justification, no coverage gaps),
* ``1`` — findings, unjustified suppressions, or coverage gaps,
* ``2`` — the transfer registry met an op it does not model, or a stage
  body made a host pull no spec declares (it refuses to guess).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from tpu_swirld_torch.analysis.lint import Finding, suppression_notes
from tpu_swirld_torch.analysis.flow import stages
from tpu_swirld_torch.analysis.flow.envelope import (
    ScaleEnvelope,
    get_envelope,
    host_envelope_findings,
    preset_names,
)
from tpu_swirld_torch.analysis.flow.interpret import (
    RULE_NAMES,
    LoopSummaryError,
    UndeclaredPullError,
)
from tpu_swirld_torch.analysis.flow.transfer import UnknownPrimitiveError

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


# --------------------------------------------------------------------------
# seeded mutations (the auditor's self-test)


def _mut_ssm_acc_int16(env: ScaleEnvelope):
    """The member tally of ``kernels.ssm_block_reference`` with the
    accumulator seeded to int16: a member's stake-weighted sightings over
    a block row reach ``events * stake_max``, so the narrowing cast must be
    flagged (SW010) and the int16 accumulation wraps (SW008)."""
    d = stages._dims(env)
    n, m = d["N"], d["M"]
    rows = stages._rows(n)

    def mut_ssm_block_tally(sees, creator, stake):
        acc = torch.zeros((rows,), dtype=torch.int16, device=sees.device)
        for mm in range(m):
            votes = ((sees & (creator[None, :] == mm)) * stake[mm]).sum(1)
            acc = acc + votes.to(torch.int16)  # seeded defect
        return acc

    return stages.StageCall(
        mut_ssm_block_tally,
        (stages._mask((rows, n)),
         stages._arr((n,), lo=0, hi=m - 1),
         stages._arr((m,), lo=0, hi=env.stake_max)),
        {},
    )


def _mut_dropped_clip(env: ScaleEnvelope):
    """The rounds step's witness-table lookup (``gpu/pipeline.py``,
    ``_make_rounds_step``) with the window-row clamp dropped: the parent
    round reaches ``events - 1``, far past the ``r_cap``-row table — the
    unclamped ``index_select`` must be flagged (SW009)."""
    d = stages._dims(env)
    n, r, s = d["N"], d["R"], d["S"]

    def mut_rounds_widx(rnd, tab, p1, p2):
        r0 = torch.maximum(rnd[p1 : p1 + 1], rnd[p2 : p2 + 1])
        widx = tab.index_select(0, r0)[0]  # seeded defect: no clamp to [0, r_max - 1]
        return widx

    return stages.StageCall(
        mut_rounds_widx,
        (stages._arr((n,), lo=0, hi=n - 1),
         stages._arr((r, s), lo=-1, hi=n - 1),
         n - 2, n - 3),
        {},
    )


#: mutation name -> (description, build)
MUTATIONS = {
    "ssm-acc-int16": (
        "narrow the ssm block tally accumulator to int16",
        _mut_ssm_acc_int16,
    ),
    "dropped-clip": (
        "drop the round-window clip before the witness-table gather",
        _mut_dropped_clip,
    ),
}


# --------------------------------------------------------------------------
# report


@dataclasses.dataclass
class AuditReport:
    """Everything one ``scale_audit`` run established."""

    envelope: str
    engines: Tuple[str, ...]
    findings: List[Finding]                    # unsuppressed
    suppressed: List[Tuple[Finding, str]]      # (finding, justification)
    unjustified: List[Finding]                 # bare disables — still fail
    errors: List[str]                          # unknown-op / pull reports
    coverage_gaps: Dict[str, List[str]]        # engine -> unaudited stages
    specs: List[str]
    exercised: Set[str]
    mutation: Optional[str] = None
    pulls: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def clean(self) -> bool:
        return not (
            self.findings
            or self.unjustified
            or self.errors
            or any(self.coverage_gaps.values())
        )

    @property
    def exit_code(self) -> int:
        if self.errors:
            return 2
        return 0 if self.clean else 1

    def to_dict(self) -> Dict:
        return {
            "envelope": self.envelope,
            "engines": list(self.engines),
            "mutation": self.mutation,
            "clean": self.clean,
            "exit_code": self.exit_code,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [
                {**f.to_dict(), "justification": note}
                for f, note in self.suppressed
            ],
            "unjustified": [f.to_dict() for f in self.unjustified],
            "errors": list(self.errors),
            "coverage_gaps": {k: v for k, v in self.coverage_gaps.items() if v},
            "specs": list(self.specs),
            "exercised": sorted(self.exercised),
            "pulls": dict(sorted(self.pulls.items())),
        }

    def render(self) -> str:
        lines: List[str] = []
        for f in self.findings:
            lines.append(f.render())
        for f in self.unjustified:
            lines.append(f.render())
        for eng, gaps in sorted(self.coverage_gaps.items()):
            for g in gaps:
                lines.append(
                    f"coverage[{eng}]: stage {g!r} observed at runtime but "
                    f"not covered by any audited spec")
        for e in self.errors:
            lines.append(f"error: {e}")
        for site, value in sorted(self.pulls.items()):
            lines.append(f"pull {site}: {value}")
        n_sites = len({(f.path, f.line, f.rule) for f in self.findings})
        lines.append(
            f"scale-audit[{self.envelope}"
            + (f", mutate={self.mutation}" if self.mutation else "")
            + f"]: {len(self.specs)} stage specs over "
            f"{'/'.join(self.engines)} — "
            + (
                "proven clean"
                if self.clean
                else f"{len(self.findings)} finding(s) at {n_sites} site(s), "
                     f"{len(self.unjustified)} unjustified suppression(s), "
                     f"{sum(len(v) for v in self.coverage_gaps.values())} "
                     f"coverage gap(s), {len(self.errors)} error(s)"
            )
            + f"; {len(self.suppressed)} justified suppression(s)"
        )
        return "\n".join(lines)


# --------------------------------------------------------------------------
# suppression application


def _source_path(path: str) -> str:
    return path if os.path.isabs(path) else os.path.join(_REPO_ROOT, path)


def _apply_suppressions(
    findings: Sequence[Finding],
) -> Tuple[List[Finding], List[Tuple[Finding, str]], List[Finding]]:
    """Split findings into (kept, suppressed-with-note, unjustified)."""
    cache: Dict[str, Dict[int, Tuple[set, str]]] = {}
    kept: List[Finding] = []
    suppressed: List[Tuple[Finding, str]] = []
    unjustified: List[Finding] = []
    for f in findings:
        notes = cache.get(f.path)
        if notes is None:
            try:
                with open(_source_path(f.path), "r", encoding="utf-8") as fh:
                    notes = suppression_notes(fh.read())
            except OSError:
                notes = {}
            cache[f.path] = notes
        ids, note = notes.get(f.line, (set(), ""))
        if ids and (f.rule in ids or f.name in ids or "all" in ids):
            if note:
                suppressed.append((f, note))
            else:
                unjustified.append(dataclasses.replace(
                    f,
                    message=f.message + " [suppressed without justification "
                    "— the audit requires `-- <why it is safe>` after the "
                    "id list]",
                ))
        else:
            kept.append(f)
    return kept, suppressed, unjustified


# --------------------------------------------------------------------------
# driver


def _run_specs(env, specs, errors, exercised, pulls):
    findings: List[Finding] = []
    for spec in specs:
        try:
            res = stages.run_spec(spec, env, findings=findings,
                                  exercised=exercised)
        except UnknownPrimitiveError as exc:
            errors.append(
                f"{spec.spec_id}: unknown primitive {exc.primitive!r} at "
                f"{exc.where} — no transfer function registered")
            continue
        except UndeclaredPullError as exc:
            errors.append(f"{spec.spec_id}: undeclared host pull at {exc.site}")
            continue
        except LoopSummaryError as exc:
            errors.append(f"{spec.spec_id}: {exc}")
            continue
        pulls.update(res.pulls)
    return findings


def scale_audit(
    envelope: str = "baseline",
    engines: Optional[Sequence[str]] = None,
    *,
    overrides: Optional[Dict[str, int]] = None,
    check_coverage: bool = True,
    mutate: Optional[str] = None,
    device="cuda",
) -> AuditReport:
    """Run the full scale audit; see the module docstring.

    ``mutate`` replaces the catalog with the named seeded defect (the
    self-test: the report is *expected* dirty; exit code 1 proves the
    auditor catches it).  ``device`` is where the coverage probe's small
    real runs go (the interpretation itself always runs on fake CPU
    tensors)."""
    engines = tuple(engines) if engines else stages.ENGINES
    bad = set(engines) - set(stages.ENGINES)
    if bad:
        raise ValueError(f"unknown engines: {sorted(bad)}")
    env = get_envelope(envelope, overrides)

    errors: List[str] = []
    exercised: Set[str] = set()
    pulls: Dict[str, str] = {}

    if mutate is not None:
        if mutate not in MUTATIONS:
            raise ValueError(
                f"unknown mutation {mutate!r} (have {sorted(MUTATIONS)})")
        desc, build = MUTATIONS[mutate]
        spec = stages.StageSpec(
            spec_id=f"mutation.{mutate}",
            stage_name=f"mutation.{mutate}",
            engines=engines,
            build=build,
        )
        raw = _run_specs(env, [spec], errors, exercised, pulls)
        # mutations are never suppressible: they live in this file, which
        # carries no swirld-lint comments
        kept, suppressed, unjustified = _apply_suppressions(raw)
        return AuditReport(
            envelope=env.name, engines=engines, findings=kept,
            suppressed=suppressed, unjustified=unjustified, errors=errors,
            coverage_gaps={}, specs=[spec.spec_id], exercised=exercised,
            mutation=mutate, pulls=pulls,
        )

    specs = stages.specs_for_engines(engines)
    raw = _run_specs(env, specs, errors, exercised, pulls)
    raw.extend(host_envelope_findings(env))
    kept, suppressed, unjustified = _apply_suppressions(raw)

    coverage_gaps: Dict[str, List[str]] = {}
    if check_coverage:
        cmap = stages.coverage_map()
        for eng in engines:
            try:
                observed = stages.observed_stage_names(eng, device=device)
            except Exception as exc:
                errors.append(f"coverage[{eng}]: runtime probe failed: "
                              f"{exc!r}")
                continue
            coverage_gaps[eng] = [s for s in observed if s not in cmap]

    return AuditReport(
        envelope=env.name, engines=engines, findings=kept,
        suppressed=suppressed, unjustified=unjustified, errors=errors,
        coverage_gaps=coverage_gaps,
        specs=[s.spec_id for s in specs], exercised=exercised, pulls=pulls,
    )


@functools.lru_cache(maxsize=8)
def cached_audit(envelope: str, engines: Tuple[str, ...] = stages.ENGINES,
                 mutate: Optional[str] = None) -> AuditReport:
    """:func:`scale_audit` without the coverage probe, once per process
    for each (envelope, engines, mutation)."""
    return scale_audit(envelope, engines, check_coverage=False, mutate=mutate)


def _cached_stamp(envelope: str, engines: Tuple[str, ...]) -> Tuple:
    rep = cached_audit(envelope, engines, None)
    return (
        rep.clean,
        len(rep.findings) + len(rep.unjustified),
        len(rep.suppressed),
        len(rep.errors),
    )


def scale_audit_stamp(
    envelope: str = "baseline",
    engines: Optional[Sequence[str]] = None,
) -> Dict:
    """The shape the reference's ``bench.py`` stamps into JSON artifacts:
    whether the tree a benchmark ran from is proven scale-safe.

    Coverage probing is skipped here (it runs real consensus workloads;
    the analyzer's own tests cover it) — the stamp is about *this tree's
    stage bodies*, cached per process."""
    engines = tuple(engines) if engines else stages.ENGINES
    clean, n_findings, n_suppressed, n_errors = _cached_stamp(
        envelope, engines)
    return {
        "envelope": envelope,
        "engines": list(engines),
        "clean": clean,
        "findings": n_findings,
        "suppressed": n_suppressed,
        "errors": n_errors,
    }


# --------------------------------------------------------------------------
# the soundness property


def _snapshot(args):
    """Owned copies of a call's tensors and arrays (several stages update
    their inputs in place)."""
    import numpy as np

    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a.detach().clone())
        elif isinstance(a, np.ndarray):
            out.append(a.copy())
        else:
            out.append(a)
    return tuple(out)


def soundness_check(engine: str, *, device="cuda", seed: int = 3,
                    launches=None) -> Dict:
    """The lattice-soundness property for one engine: the first call of
    every stage a real small run of ``engine`` on ``device`` dispatches is
    snapshotted, re-run on ``device`` (the card's kernels compute its
    outputs there) and replayed through the interpreter at its concrete
    arguments' intervals; every concrete output must lie inside its
    abstract interval.

    ``launches()``, when given, is read just after the observed run and
    before the re-runs (the kernels' launch counts of the engine's own
    run).  Returns ``{"stages", "replayed", "violations", "pulls",
    "launches", "calls"}``, ``calls`` the snapshotted first call of each
    stage (``name -> (args, kwargs)``)."""
    calls, seen = [], set()

    def collect(name, fn, args, kw):
        if name in seen:
            return
        seen.add(name)
        calls.append((name, fn, _snapshot(args), dict(kw)))

    names = stages.observed_stage_names(engine, device=device, seed=seed,
                                        collect=collect)
    counted = launches() if launches is not None else None
    bad: List[str] = []
    pulls: Dict[str, str] = {}
    for name, fn, args, kw in calls:
        res = stages.trace_concrete_call(fn, args, kw, stage=name)
        pulls.update(res.pulls)
        out = fn(*_snapshot(args), **kw)
        leaves = [x for x in torch.utils._pytree.tree_leaves(out)
                  if isinstance(x, torch.Tensor)]
        if len(leaves) != len(res.outs):
            bad.append(f"{name}: {len(leaves)} outputs, {len(res.outs)} abstract")
            continue
        for j, (av, leaf) in enumerate(zip(res.outs, leaves)):
            if leaf.numel() == 0:
                continue
            x = leaf.detach()
            x = x.double() if x.dtype.is_floating_point else x.to(torch.int64)
            lo, hi = float(x.min()), float(x.max())
            if not (float(av.iv.lo) <= lo and hi <= float(av.iv.hi)):
                bad.append(f"{name} out[{j}]: abstract {av.iv} misses "
                           f"concrete [{lo}, {hi}] ({leaf.dtype})")
    return {"stages": names, "replayed": [c[0] for c in calls],
            "violations": bad, "pulls": pulls, "launches": counted,
            "calls": {c[0]: (c[2], c[3]) for c in calls}}


# --------------------------------------------------------------------------
# CLI


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="python -m tpu_swirld_torch.analysis scale-audit",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument(
        "--envelope", default="baseline", choices=preset_names(),
        help="declared operating point to prove (default baseline)")
    ap.add_argument(
        "--engine", action="append", choices=list(stages.ENGINES),
        help="engine(s) to audit; repeatable (default all)")
    ap.add_argument(
        "--set", action="append", default=[], metavar="FIELD=VALUE",
        dest="overrides", help="override an envelope field (with "
        "--envelope custom); repeatable")
    ap.add_argument(
        "--mutate", choices=sorted(MUTATIONS),
        help="audit a seeded defect instead of the real stages (self-"
        "test: exit 1 proves the defect is caught)")
    ap.add_argument(
        "--no-coverage", action="store_true",
        help="skip the runtime stage-coverage probe")
    ap.add_argument(
        "--device", default="cuda",
        help="torch device of the coverage probe's small real runs "
        "(default cuda, which fails without a GPU)")
    ap.add_argument("--json", action="store_true", help="machine output")
    ap.add_argument(
        "--list-rules", action="store_true",
        help="print the flow rule catalog")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, name in sorted(RULE_NAMES.items()):
            print(f"{rid} {name}")
        return 0

    overrides: Dict[str, int] = {}
    for kv in args.overrides:
        k, sep, v = kv.partition("=")
        if not sep:
            ap.error(f"--set expects FIELD=VALUE, got {kv!r}")
        overrides[k.strip()] = int(v)

    rep = scale_audit(
        args.envelope,
        args.engine,
        overrides=overrides or None,
        check_coverage=not args.no_coverage and args.mutate is None,
        mutate=args.mutate,
        device=args.device,
    )
    if args.json:
        print(json.dumps(rep.to_dict(), indent=2))
    else:
        print(rep.render())
    return rep.exit_code


if __name__ == "__main__":
    import sys

    sys.exit(main())
