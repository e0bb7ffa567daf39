"""Rule catalog for the invariant linter (the port's copy of the
reference's ``tpu_swirld/analysis/rules``, its scopes mapped to the port's
layout: ``tpu/`` is ``gpu/`` here, every other path keeps its name).

Each rule is a small AST pass with a fixed id (``SWNNN``), a slug, a
module scope (empty = whole package), and a fix-it message baked into
every finding.  Suppress a finding with ``# swirld-lint: disable=<id>``
on the flagged line (see :mod:`tpu_swirld_torch.analysis.lint`).

Catalog:

- **SW001 unseeded-rng**: no global-state RNG (``random.*``,
  ``np.random.*``) anywhere in the package; randomness must flow from a
  seeded ``random.Random`` / ``np.random.default_rng(seed)`` instance.
- **SW002 unordered-iter**: no hash-order ``set`` iteration in the
  consensus-critical modules (``oracle/``, ``store/streaming.py``,
  ``gpu/pipeline.py``, ``chaos.py``, ``membership/``, ...) without an
  explicit ``sorted()``.
- **SW003 wall-clock**: no ``time.time`` / ``time.sleep`` /
  ``datetime.now`` in the logical-time transport/retry layer.  Inside
  ``net/`` (the socket deployment edge, which legitimately needs real
  deadlines), ``obs/profile.py`` and ``soak.py`` the rule still applies
  but accepts *justified* line suppressions only (``disable=SW003 --
  <why>`` with a non-empty note); bare disables and ``disable-file`` do
  not count.
- **SW004 dtype-discipline**: kernel/slab allocations (``gpu/``,
  ``store/``, ``parallel.py``) must pin an explicit dtype: NumPy's
  implicit int64/float64, torch's implicit int64/float32 and
  builtin-``int`` dtypes are forbidden.
- **SW005 donation-discipline**: a buffer passed at a ``donate_argnums``
  position (directly, through ``obs.stage_call``, or through a ``make_*``
  stage factory) must not be read afterwards in the same scope until
  rebound.  The port donates nothing, so over the port it finds nothing.
- **SW006 lock-discipline**: every ``self`` attribute a background
  worker thread touches must appear in the owning class's declared
  ``GUARDED_ATTRS`` frozenset.
- **SW007 load-bearing-assert**: no ``assert`` statements in the
  production modules (``oracle/``, ``store/``, ``gpu/``,
  ``transport.py``, ``parallel.py``, ``packing.py``, ``membership/``):
  asserts vanish under ``python -O``; safety checks must be explicit
  raises (with a counter where useful).

The SW008-SW011 ids belong to the reference's scale-envelope flow audit
(``tpu_swirld/analysis/flow``), which is not in the port yet (ROADMAP
A5); they share this id space, finding format and suppression syntax.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

from tpu_swirld_torch.analysis.lint import FileContext, Finding


class Rule:
    """Base class: subclasses set ``id``/``name``/``scope``/``describe``
    and implement :meth:`check`."""

    id: str = "SW000"
    name: str = "base"
    describe: str = ""
    #: module-path prefixes this rule applies to; empty = every module
    scope: Tuple[str, ...] = ()
    #: module-path prefixes where only a *justified* line suppression
    #: (``# swirld-lint: disable=<id> -- <why>``) silences a finding —
    #: bare disables and ``disable-file`` do not (the SW008 flow-audit
    #: semantics, opt-in per rule/scope)
    note_scope: Tuple[str, ...] = ()

    def applies(self, module_path: str) -> bool:
        if not self.scope:
            return True
        return any(
            module_path == s or module_path.startswith(s)
            for s in self.scope
        )

    def requires_note(self, module_path: str) -> bool:
        return any(
            module_path == s or module_path.startswith(s)
            for s in self.note_scope
        )

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, ctx: FileContext, node, message: str) -> Finding:
        return Finding(
            self.id, self.name, ctx.path,
            getattr(node, "lineno", 0), getattr(node, "col_offset", 0),
            message,
        )


def all_rules() -> List[Rule]:
    from tpu_swirld_torch.analysis.rules.determinism import (
        UnorderedIterRule, UnseededRngRule, WallClockRule,
    )
    from tpu_swirld_torch.analysis.rules.asserts import LoadBearingAssertRule
    from tpu_swirld_torch.analysis.rules.donation import DonationRule
    from tpu_swirld_torch.analysis.rules.dtype import DtypeRule
    from tpu_swirld_torch.analysis.rules.locks import LockDisciplineRule

    return [
        UnseededRngRule(),
        UnorderedIterRule(),
        WallClockRule(),
        DtypeRule(),
        DonationRule(),
        LockDisciplineRule(),
        LoadBearingAssertRule(),
    ]
