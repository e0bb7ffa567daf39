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

CLI::

    python -m tpu_swirld_torch.analysis lint tpu_swirld_torch/
    python -m tpu_swirld_torch.analysis jit-audit [--device cpu]
    python -m tpu_swirld_torch.analysis races --schedules 32 [--device cpu]
    python -m tpu_swirld_torch.analysis mc

The reference's scale-envelope audit (``scale-audit``, its ``flow``
package) is not in the port yet (ROADMAP A5).
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
]


def __getattr__(name):
    if name in ("scale_audit", "scale_audit_stamp"):
        raise AttributeError(
            f"{name} is the reference's flow audit, not in the port yet "
            "(ROADMAP A5)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
