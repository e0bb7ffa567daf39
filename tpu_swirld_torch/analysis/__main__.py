"""CLI dispatcher: ``python -m tpu_swirld_torch.analysis <subcommand>``.

Subcommands::

    lint        [paths...] [--json] [--rules ...] [--list-rules]
    lint-gates  [--gate fused-dispatch|soak-plane]
    jit-audit   [--static-only] [--members N] [--events N] [--engine E] [--device D] [--json]
    races       [--schedules N] [--seed S] [--rows N] [--device D] [--json]
    mc          [--n N] [--events N] [--forkers N] [--mutate NAME] [--json]
    scale-audit [--envelope E] [--engine E] [--mutate NAME] [--device D] [--json] [--list-rules]

Each exits non-zero on findings / audit failures / schedule divergence /
invariant violations / unproven envelopes, so all six slot directly
into CI.
"""

from __future__ import annotations

import sys

#: the reference's subcommands the port lacks -> the ROADMAP item for each
NOT_PORTED: dict = {}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__.strip())
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "lint":
        from tpu_swirld_torch.analysis.lint import main as m
    elif cmd == "lint-gates":
        from tpu_swirld_torch.analysis.lint import gates_main as m
    elif cmd == "jit-audit":
        from tpu_swirld_torch.analysis.jit_audit import main as m
    elif cmd == "races":
        from tpu_swirld_torch.analysis.races import main as m
    elif cmd == "mc":
        from tpu_swirld_torch.analysis.mc.cli import main as m
    elif cmd == "scale-audit":
        from tpu_swirld_torch.analysis.flow.audit import main as m
    elif cmd in NOT_PORTED:
        print(f"subcommand {cmd!r} is not in the port yet: {NOT_PORTED[cmd]}")
        return 2
    else:
        print(f"unknown subcommand {cmd!r} (lint | lint-gates | jit-audit | races | mc | scale-audit)")
        return 2
    return m(rest)


if __name__ == "__main__":
    sys.exit(main())
