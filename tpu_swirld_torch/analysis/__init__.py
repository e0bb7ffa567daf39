"""Static analysis and sanitizers for the consensus core (the port's
counterpart of the reference's ``tpu_swirld/analysis`` package).

Three invariant classes hold in this codebase only by convention, and a
single unnoticed violation of any of them is a latent consensus-safety or
performance bug:

- **Determinism**: consensus safety is "decided prefixes bit-identical
  across nodes".  Unseeded RNG, hash-randomized ``set`` iteration
  (PYTHONHASHSEED), or a wall-clock read on a consensus path silently
  breaks it.
- **Stage discipline**: the drivers' throughput depends on stage bodies
  that do not wait for the card, a steady loop that builds no kernel
  library, and stable stage signatures.
- **Thread safety**: the background archive pack worker (store.archive)
  shares the spill queue, row cache and drain barriers with the ingest
  thread; every shared attribute must be declared and audited.

What the port has:

- :mod:`tpu_swirld_torch.analysis.lint`: the AST invariant linter with the
  reference's rules (:mod:`tpu_swirld_torch.analysis.rules`), scoped to the
  port's layout.  The package lints clean.
- :mod:`tpu_swirld_torch.analysis.jit_audit`: the stage-call auditor, the
  torch-level counterpart of the reference's jit audit: host syncs inside
  stage bodies, steady kernel builds, signature drift.
- :mod:`tpu_swirld_torch.analysis.races`: the schedule-fuzzing race
  sanitizer of the archive's worker protocol, rows on a device.
- :mod:`tpu_swirld_torch.analysis.mc`: the explicit-state model checker.
- :mod:`tpu_swirld_torch.analysis.flow`: the scale-envelope abstract
  interpreter over the stage bodies (SW008-SW011 at a declared envelope).

CLI::

    python -m tpu_swirld_torch.analysis lint tpu_swirld_torch/
    python -m tpu_swirld_torch.analysis lint-gates   # scripts/lint.sh's gates 3, 4
    python -m tpu_swirld_torch.analysis jit-audit [--device cpu]
    python -m tpu_swirld_torch.analysis races --schedules 32 [--device cpu]
    python -m tpu_swirld_torch.analysis mc
    python -m tpu_swirld_torch.analysis scale-audit --envelope 1m [--device cpu]

The flow package imports ``torch``; it loads on first use of
``scale_audit`` / ``scale_audit_stamp`` here, so the linter stays
torch-free.
"""

from tpu_swirld_torch.analysis.lint import (  # noqa: F401
    Finding,
    check_source,
    lint_paths,
    lint_summary,
)

__all__ = [
    "Finding",
    "check_source",
    "lint_paths",
    "lint_summary",
    "scale_audit",
    "scale_audit_stamp",
]


def __getattr__(name):
    if name in ("scale_audit", "scale_audit_stamp"):
        from tpu_swirld_torch.analysis.flow import audit

        return getattr(audit, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
