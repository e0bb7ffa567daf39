"""SW005 donation-discipline: never read a buffer after donating it.

``donate_argnums`` hands the buffer's memory to XLA; the Python-side
array is left pointing at deleted device memory, and the next read
raises (or, under some backends, silently aliases).  The package's
convention is to rebind the result to the same name in the same
statement (``self._anc_d = obs.stage_call("x", stage, self._anc_d,
...)``), which this rule verifies mechanically.

The rule tracks three call shapes against the cross-file donation index
built by :class:`tpu_swirld_torch.analysis.lint.PackageIndex`:

- direct: ``update_block_stage(buf, ...)`` where the stage was defined
  with ``donate_argnums``;
- wrapped: ``obs.stage_call("name", stage, buf, ...)`` — donated
  positions shift by +2 for the label and function arguments; the fused
  variant ``obs.stage_call_fused("name", k, stage, buf, ...)`` shifts
  by +3 (label, fused-chunk count, function);
- factory: ``make_extend_visibility_stage(kern)(buf, ...)`` — the
  factory's inner jitted def declares the donation.

Within each function scope, statements are walked linearly: a load of a
donated name (or dotted ``self.attr`` chain) after the donating call and
before a rebinding store is a finding.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Tuple

from tpu_swirld_torch.analysis.lint import FileContext, Finding
from tpu_swirld_torch.analysis.rules import Rule


def _key(expr) -> Optional[str]:
    """Flatten ``Name`` / dotted ``Attribute`` chains to a tracking key
    (``buf``, ``self._anc_d``); anything else is untrackable."""
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        base = _key(expr.value)
        if base is not None:
            return base + "." + expr.attr
    return None


class DonationRule(Rule):
    id = "SW005"
    name = "donation-discipline"
    describe = (
        "a buffer passed at a donate_argnums position is dead after the "
        "call; rebind the result to the same name in the same statement "
        "and never read the old binding"
    )
    scope = ()

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_fn(ctx, node, out)
        return out

    # -- call-site resolution -------------------------------------------

    def _donated_arg_keys(self, call: ast.Call) -> List[Tuple[str, str]]:
        """``(key, stage_name)`` for each trackable donated argument of
        a call, or [] if the call donates nothing we can resolve."""
        idx = ctx_index = self._index
        fn = call.func
        positions: Tuple[int, ...] = ()
        stage = ""
        args = call.args
        if isinstance(fn, ast.Name) and fn.id in idx.donations:
            positions, stage = idx.donations[fn.id], fn.id
        elif (
            isinstance(fn, ast.Call)
            and isinstance(fn.func, ast.Name)
            and fn.func.id in idx.donation_factories
        ):
            positions = idx.donation_factories[fn.func.id]
            stage = fn.func.id
        elif (
            (isinstance(fn, ast.Attribute) and fn.attr == "stage_call")
            or (isinstance(fn, ast.Name) and fn.id == "stage_call")
        ) and len(args) >= 2:
            inner = args[1]
            if isinstance(inner, ast.Name):
                if inner.id in idx.donations:
                    positions = tuple(
                        p + 2 for p in idx.donations[inner.id]
                    )
                    stage = inner.id
            elif (
                isinstance(inner, ast.Call)
                and isinstance(inner.func, ast.Name)
                and inner.func.id in ctx_index.donation_factories
            ):
                positions = tuple(
                    p + 2 for p in idx.donation_factories[inner.func.id]
                )
                stage = inner.func.id
        elif (
            (isinstance(fn, ast.Attribute) and fn.attr == "stage_call_fused")
            or (isinstance(fn, ast.Name) and fn.id == "stage_call_fused")
        ) and len(args) >= 3:
            # fused wrapper: (label, fused_chunks, fn, *args) — donated
            # positions shift by +3.  This covers the scan-carry donation
            # shape: rounds_span_stage donates its carry slabs, and the
            # fixpoint caller must re-upload rather than reuse them.
            inner = args[2]
            if isinstance(inner, ast.Name):
                if inner.id in idx.donations:
                    positions = tuple(
                        p + 3 for p in idx.donations[inner.id]
                    )
                    stage = inner.id
            elif (
                isinstance(inner, ast.Call)
                and isinstance(inner.func, ast.Name)
                and inner.func.id in ctx_index.donation_factories
            ):
                positions = tuple(
                    p + 3 for p in idx.donation_factories[inner.func.id]
                )
                stage = inner.func.id
        keys = []
        for p in positions:
            if p < len(args):
                k = _key(args[p])
                if k is not None:
                    keys.append((k, stage))
        return keys

    # -- linear scope walk ----------------------------------------------

    def _check_fn(self, ctx, fn, out) -> None:
        self._index = ctx.index
        donated: Dict[str, str] = {}   # key -> donating stage name
        self._stmts(ctx, fn.body, donated, out)

    def _stmts(self, ctx, body, donated, out) -> None:
        for st in body:
            self._stmt(ctx, st, donated, out)

    def _stmt(self, ctx, st, donated, out) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return   # walked as its own scope by check()
        if isinstance(st, ast.Assign):
            self._expr(ctx, st.value, donated, out)
            for t in st.targets:
                self._clear_target(t, donated)
        elif isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self._expr(ctx, st.value, donated, out)
            self._clear_target(st.target, donated)
        elif isinstance(st, ast.AugAssign):
            self._expr(ctx, st.value, donated, out)
            k = _key(st.target)
            if k is not None and k in donated:
                out.append(self.finding(
                    ctx, st.target,
                    f"'{k}' was donated to {donated[k]}() and is "
                    "augmented here — the buffer is already dead; fix: "
                    "rebind the stage's return value instead",
                ))
                donated.pop(k, None)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            self._expr(ctx, st.iter, donated, out)
            self._clear_target(st.target, donated)
            self._stmts(ctx, st.body, donated, out)
            self._stmts(ctx, st.orelse, donated, out)
        elif isinstance(st, (ast.If, ast.While)):
            self._expr(ctx, st.test, donated, out)
            self._stmts(ctx, st.body, donated, out)
            self._stmts(ctx, st.orelse, donated, out)
        elif isinstance(st, ast.Try):
            self._stmts(ctx, st.body, donated, out)
            for h in st.handlers:
                self._stmts(ctx, h.body, donated, out)
            self._stmts(ctx, st.orelse, donated, out)
            self._stmts(ctx, st.finalbody, donated, out)
        elif isinstance(st, ast.With):
            for item in st.items:
                self._expr(ctx, item.context_expr, donated, out)
            self._stmts(ctx, st.body, donated, out)
        elif isinstance(st, ast.Return):
            if st.value is not None:
                self._expr(ctx, st.value, donated, out)
        elif isinstance(st, ast.Expr):
            self._expr(ctx, st.value, donated, out)
        elif isinstance(st, ast.Delete):
            for t in st.targets:
                k = _key(t)
                if k is not None:
                    donated.pop(k, None)

    def _clear_target(self, target, donated) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._clear_target(e, donated)
            return
        k = _key(target)
        if k is not None:
            # a store to self.x also revives self.x.anything
            for d in [d for d in donated if d == k or d.startswith(k + ".")]:
                donated.pop(d, None)

    def _expr(self, ctx, expr, donated, out) -> None:
        # 1) every trackable load checked against the donated set
        for node in ast.walk(expr):
            if isinstance(node, (ast.Name, ast.Attribute)) and isinstance(
                getattr(node, "ctx", None), ast.Load
            ):
                k = _key(node)
                if k is not None and k in donated:
                    out.append(self.finding(
                        ctx, node,
                        f"'{k}' is read after being donated to "
                        f"{donated[k]}() — donate_argnums freed that "
                        "buffer; fix: use the stage's return value, or "
                        "copy before the donating call",
                    ))
        # 2) then record fresh donations made by calls in this expression
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                for k, stage in self._donated_arg_keys(node):
                    donated[k] = stage
