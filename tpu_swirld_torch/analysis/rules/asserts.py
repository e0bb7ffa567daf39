"""SW007: load-bearing ``assert`` statements in production modules.

``assert`` statements are compiled out under ``python -O`` — a safety
check written as an assert silently vanishes in optimized deployments,
turning a loud shape/invariant failure into corrupt downstream state.
In the production consensus, store, kernel, and transport modules every
assert IS load-bearing (there is no "debug-only" tier there), so the
rule flags them all: guards belong in explicit ``if not cond: raise``
form, with a counter where observability helps (the pattern lives in
``tpu_swirld_torch.gpu.pipeline.ShapeContractError`` /
``shape_guard_trips``).

Tests and benches keep their asserts (pytest rewrites them; benches are
never run under ``-O``); the scope below covers the modules that ship.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from tpu_swirld_torch.analysis.lint import FileContext, Finding
from tpu_swirld_torch.analysis.rules import Rule


class LoadBearingAssertRule(Rule):
    id = "SW007"
    name = "load-bearing-assert"
    describe = (
        "assert statements vanish under python -O; production safety "
        "checks must be explicit raises (with a counter where useful — "
        "see gpu.pipeline.ShapeContractError) that survive optimization"
    )
    scope = (
        "oracle/", "store/", "gpu/", "transport.py", "parallel.py",
        "packing.py", "membership/",
    )

    _FIX = (
        "is compiled out under python -O, so this guard silently "
        "disappears in optimized deployments; fix: explicit "
        "`if not <cond>: raise <Error>(...)` (count the trips where "
        "observability helps, like gpu.pipeline.shape_guard_trips)"
    )

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assert):
                out.append(self.finding(
                    ctx, node, "assert statement " + self._FIX,
                ))
        return out
