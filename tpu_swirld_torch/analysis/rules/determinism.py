"""Determinism rules: unseeded RNG, unordered-set iteration, wall-clock.

Consensus safety here is "decided prefixes bit-identical across every
node, engine, and replay".  These three rules pin the ways plain Python
quietly breaks that:

- module-level RNG draws from interpreter-global state no replay controls;
- ``set`` iteration order is hash-randomized per process
  (PYTHONHASHSEED) for ``bytes``/``str`` elements — two nodes walking the
  same set can diverge;
- wall-clock reads differ across nodes and replays, so nothing in the
  logical-time transport/retry layer may consult them.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from tpu_swirld_torch.analysis.lint import FileContext, Finding
from tpu_swirld_torch.analysis.rules import Rule

# ---------------------------------------------------------------- SW001

#: np.random attributes that are seeded-constructor entry points (fine
#: when called WITH a seed argument)
_NP_SEEDED = {"default_rng", "SeedSequence", "Generator", "RandomState"}


class UnseededRngRule(Rule):
    id = "SW001"
    name = "unseeded-rng"
    describe = (
        "global-state RNG (random.*, np.random.*) is unseeded shared "
        "state; thread a seeded random.Random(seed) / "
        "np.random.default_rng(seed) instance through instead"
    )
    scope = ()   # whole package

    _FIX = (
        "draws from interpreter-global RNG state — any consensus or sim "
        "path using it is unreplayable; fix: accept a seeded "
        "random.Random / np.random.default_rng(seed) instance"
    )

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            # random.X(...) for module-level X (not the Random class)
            if (
                isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Name)
                and fn.value.id == "random"
            ):
                if fn.attr in ("Random", "SystemRandom"):
                    if fn.attr == "Random" and not node.args:
                        out.append(self.finding(
                            ctx, node,
                            "random.Random() without a seed; " + self._FIX,
                        ))
                    continue
                out.append(self.finding(
                    ctx, node, f"random.{fn.attr}() " + self._FIX,
                ))
            # np.random.X(...) / numpy.random.X(...)
            elif (
                isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Attribute)
                and fn.value.attr == "random"
                and isinstance(fn.value.value, ast.Name)
                and fn.value.value.id in ("np", "numpy")
            ):
                if fn.attr in _NP_SEEDED:
                    if not node.args and not node.keywords:
                        out.append(self.finding(
                            ctx, node,
                            f"np.random.{fn.attr}() without a seed; "
                            + self._FIX,
                        ))
                    continue
                out.append(self.finding(
                    ctx, node, f"np.random.{fn.attr}() " + self._FIX,
                ))
        return out


# ---------------------------------------------------------------- SW002

#: set-returning methods (attribute calls)
_SET_METHODS = {
    "union", "intersection", "difference", "symmetric_difference",
}
#: order-insensitive consumers a set may flow into un-sorted
_ORDER_FREE = {
    "sorted", "len", "min", "max", "sum", "any", "all", "set",
    "frozenset", "bool",
}
#: order-sensitive consumers of an iterable argument
_ORDER_SENSITIVE = {"list", "tuple", "enumerate", "iter", "next"}


class _SetNames(ast.NodeVisitor):
    """Names/attributes inferred set-typed within one scope (conservative:
    any assignment from a set-producing expression marks the name)."""

    def __init__(self):
        self.names: Set[str] = set()
        self.attr_sets: Set[str] = set()        # self.X is a set
        self.attr_dict_of_set: Set[str] = set() # self.X[...] is a set

    def visit_Assign(self, node):
        if _is_set_producing(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.names.add(t.id)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        ann_kind = _annotation_kind(node.annotation)
        if isinstance(node.target, ast.Name):
            if ann_kind == "set" or (
                node.value is not None and _is_set_producing(node.value)
            ):
                self.names.add(node.target.id)
        elif (
            isinstance(node.target, ast.Attribute)
            and isinstance(node.target.value, ast.Name)
            and node.target.value.id == "self"
        ):
            if ann_kind == "set":
                self.attr_sets.add(node.target.attr)
            elif ann_kind == "dict_of_set":
                self.attr_dict_of_set.add(node.target.attr)
        self.generic_visit(node)


def _annotation_kind(ann) -> Optional[str]:
    """'set', 'dict_of_set', or None for a type annotation node."""
    if isinstance(ann, ast.Name) and ann.id in ("set", "frozenset"):
        return "set"
    if isinstance(ann, ast.Subscript):
        base = ann.value
        if isinstance(base, ast.Name):
            if base.id in ("Set", "FrozenSet"):
                return "set"
            if base.id in ("Dict", "dict"):
                sl = ann.slice
                if isinstance(sl, ast.Tuple) and len(sl.elts) == 2:
                    if _annotation_kind(sl.elts[1]) == "set":
                        return "dict_of_set"
    return None


def _is_set_producing(expr) -> bool:
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return True
    if isinstance(expr, ast.Call):
        fn = expr.func
        if isinstance(fn, ast.Name) and fn.id in ("set", "frozenset"):
            return True
        if isinstance(fn, ast.Attribute) and fn.attr in _SET_METHODS:
            return True
    return False


class UnorderedIterRule(Rule):
    id = "SW002"
    name = "unordered-iter"
    describe = (
        "set iteration order is hash-randomized (PYTHONHASHSEED); in "
        "consensus-critical modules iterate sorted(the_set) or an "
        "ordered container"
    )
    scope = (
        "oracle/", "store/streaming.py", "gpu/pipeline.py", "chaos.py",
        "adversary.py", "obs/finality.py", "obs/flightrec.py",
        "obs/cluster_trace.py", "obs/profile.py",
        "net/proxy.py", "net/traffic.py", "soak.py",
        "membership/",
    )

    _FIX = (
        "iterates a set — order is hash-randomized per process, so two "
        "nodes (or a node and its replay) can walk it differently; fix: "
        "sorted(...) with a deterministic key, or keep an ordered "
        "container alongside the set"
    )

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        # class-attribute annotations are file-global facts
        ann = _SetNames()
        ann.visit(ctx.tree)
        scopes = [ctx.tree] + [
            n for n in ast.walk(ctx.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        for scope in scopes:
            names = _SetNames()
            for st in scope.body:
                names.visit(st)
            names.attr_sets |= ann.attr_sets
            names.attr_dict_of_set |= ann.attr_dict_of_set
            names.names |= {
                a.arg for a in getattr(
                    getattr(scope, "args", None), "args", []
                )
                if a.annotation is not None
                and _annotation_kind(a.annotation) == "set"
            }
            self._check_scope(ctx, scope, names, out)
        # dedupe (module scope nests function bodies)
        seen = set()
        uniq = []
        for f in out:
            key = (f.line, f.col, f.message)
            if key not in seen:
                seen.add(key)
                uniq.append(f)
        return uniq

    def _is_set(self, expr, names: _SetNames) -> bool:
        if _is_set_producing(expr):
            return True
        if isinstance(expr, ast.Name) and expr.id in names.names:
            return True
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and expr.attr in names.attr_sets
        ):
            return True
        if isinstance(expr, ast.Subscript):
            b = expr.value
            if (
                isinstance(b, ast.Attribute)
                and isinstance(b.value, ast.Name)
                and b.value.id == "self"
                and b.attr in names.attr_dict_of_set
            ):
                return True
        return False

    def _check_scope(self, ctx, scope, names, out) -> None:
        own_stmts = scope.body
        for node in [
            n for st in own_stmts for n in ast.walk(st)
        ]:
            if isinstance(node, (ast.For, ast.AsyncFor)):
                if self._is_set(node.iter, names):
                    out.append(self.finding(
                        ctx, node.iter, "for-loop " + self._FIX
                    ))
            elif isinstance(node, (
                ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp
            )):
                for gen in node.generators:
                    if self._is_set(gen.iter, names):
                        out.append(self.finding(
                            ctx, gen.iter, "comprehension " + self._FIX
                        ))
            elif isinstance(node, ast.Call):
                fn = node.func
                if (
                    isinstance(fn, ast.Name)
                    and fn.id in _ORDER_SENSITIVE
                    and node.args
                    and self._is_set(node.args[0], names)
                ):
                    out.append(self.finding(
                        ctx, node, f"{fn.id}(...) " + self._FIX
                    ))
                elif (
                    isinstance(fn, ast.Attribute)
                    and fn.attr in ("extend", "join")
                    and node.args
                    and self._is_set(node.args[0], names)
                ):
                    out.append(self.finding(
                        ctx, node, f".{fn.attr}(...) " + self._FIX
                    ))
                elif (
                    isinstance(fn, ast.Attribute)
                    and fn.attr == "pop"
                    and not node.args
                    and self._is_set(fn.value, names)
                ):
                    out.append(self.finding(
                        ctx, node,
                        ".pop() takes a hash-order-arbitrary element "
                        "from a set; fix: pop from a sorted list or use "
                        "an explicit deterministic choice",
                    ))


# ---------------------------------------------------------------- SW003

_WALL_TIME_FNS = {"time", "sleep", "monotonic", "perf_counter",
                  "process_time", "time_ns", "monotonic_ns"}


class WallClockRule(Rule):
    id = "SW003"
    name = "wall-clock"
    describe = (
        "the transport/retry layer is logical-time (RetryPolicy ticks); "
        "wall-clock reads and sleeps diverge across nodes and replays"
    )
    # finality.py / flightrec.py take injected-clock callables and must
    # never read wall time themselves (byte-stable sim dumps depend on it)
    scope = (
        "transport.py", "oracle/node.py", "obs/finality.py",
        "obs/flightrec.py", "net/", "obs/cluster_trace.py",
        "obs/profile.py", "soak.py",
    )
    # net/ is the socket deployment edge: real deadlines, pacing, and tx
    # latency genuinely need wall time — but each read must say *why* at
    # the call site.  Only a justified line suppression
    # (``disable=SW003 -- <why>``) counts there; a bare disable or a
    # disable-file is still a finding, so the wall-clock surface of the
    # net layer stays enumerable and every entry self-documents.
    # obs/profile.py: the dispatch profiler's single timing callsite is
    # its one legitimate wall read — justified there, nowhere else.
    # soak.py drives real processes on a wall-clock schedule; same rule:
    # every wall read routes through frame.now()/frame.sleep() or a
    # justified line suppression.
    note_scope = ("net/", "obs/profile.py", "soak.py")

    _FIX = (
        "in the logical-time transport/retry layer; fix: advance the "
        "logical clock (RetryPolicy backoff ticks) or move timing to "
        "the obs layer outside these modules"
    )

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if (
                isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Name)
                and fn.value.id == "time"
                and fn.attr in _WALL_TIME_FNS
            ):
                out.append(self.finding(
                    ctx, node, f"time.{fn.attr}() " + self._FIX
                ))
            elif (
                isinstance(fn, ast.Attribute)
                and fn.attr in ("now", "utcnow", "today")
                and isinstance(fn.value, (ast.Name, ast.Attribute))
                and (
                    getattr(fn.value, "id", None) == "datetime"
                    or getattr(fn.value, "attr", None) == "datetime"
                )
            ):
                out.append(self.finding(
                    ctx, node, f"datetime.{fn.attr}() " + self._FIX
                ))
        return out
