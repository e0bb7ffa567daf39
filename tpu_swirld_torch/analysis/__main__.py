"""CLI dispatcher: ``python -m tpu_swirld_torch.analysis <subcommand>``.

Subcommands::

    mc          [--n N] [--events N] [--forkers N] [--mutate NAME] [--json]

The reference's other subcommands are not in the port yet: each prints
the ROADMAP item that brings it and exits 2, as an unknown subcommand
does.  ``mc`` exits non-zero on invariant violations, so it slots
directly into CI.
"""

from __future__ import annotations

import sys

#: the reference's subcommands the port lacks -> the ROADMAP item for each
NOT_PORTED = {
    "lint": "ROADMAP A4 (analysis/lint.py and rules/)",
    "races": "ROADMAP A4 (analysis/races.py)",
    "jit-audit": "ROADMAP A5 (analysis/jit_audit.py)",
    "scale-audit": "ROADMAP A5 (analysis/flow/)",
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__.strip())
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "mc":
        from tpu_swirld_torch.analysis.mc.cli import main as m
    elif cmd in NOT_PORTED:
        print(f"subcommand {cmd!r} is not in the port yet: {NOT_PORTED[cmd]}")
        return 2
    else:
        print(f"unknown subcommand {cmd!r} (mc)")
        return 2
    return m(rest)


if __name__ == "__main__":
    sys.exit(main())
