"""SW006 lock-discipline: declared guarded-attribute sets for workers.

A class that starts a ``threading.Thread(target=self.X)`` shares every
attribute the worker closure touches with the client thread.  The
package's convention (``SlabArchive.GUARDED_ATTRS``) is an explicit
class-level ``frozenset`` naming that shared mutable state, so a review
of the queue/barrier protocol has a definitive list to audit and a new
attribute cannot silently join the shared set.

The rule computes the worker's transitive closure over self-method
calls, collects the ``self.attr`` accesses inside it, and requires every
*mutable* one (stored by the worker, or stored anywhere outside
``__init__``) to appear in ``GUARDED_ATTRS``.  Attributes only ever
assigned in ``__init__`` are immutable-after-start and exempt.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set

from tpu_swirld_torch.analysis.lint import FileContext, Finding
from tpu_swirld_torch.analysis.rules import Rule


def _is_thread_ctor(call: ast.Call) -> bool:
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr == "Thread":
        return True
    if isinstance(fn, ast.Name) and fn.id == "Thread":
        return True
    return False


def _thread_target_method(call: ast.Call) -> Optional[str]:
    for kw in call.keywords:
        if kw.arg == "target":
            v = kw.value
            if (
                isinstance(v, ast.Attribute)
                and isinstance(v.value, ast.Name)
                and v.value.id == "self"
            ):
                return v.attr
    return None


def _declared_guarded(cls: ast.ClassDef) -> Optional[Set[str]]:
    """The class-level ``GUARDED_ATTRS`` declaration, or None."""
    for st in cls.body:
        targets = []
        value = None
        if isinstance(st, ast.Assign):
            targets, value = st.targets, st.value
        elif isinstance(st, ast.AnnAssign) and st.value is not None:
            targets, value = [st.target], st.value
        if not any(
            isinstance(t, ast.Name) and t.id == "GUARDED_ATTRS"
            for t in targets
        ):
            continue
        names: Set[str] = set()
        for node in ast.walk(value):
            if isinstance(node, ast.Constant) and isinstance(
                node.value, str
            ):
                names.add(node.value)
        return names
    return None


#: method calls that mutate their receiver — ``self.X.append(...)``
#: counts as a store of ``X``
_MUTATORS = {
    "append", "extend", "insert", "pop", "popitem", "clear", "update",
    "add", "remove", "discard", "setdefault", "move_to_end",
    "put", "put_nowait", "get", "get_nowait", "task_done",
}


def _self_attr(node) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


class _AttrUse(ast.NodeVisitor):
    """self.attr loads/stores and self-method references in one method.
    Stores include plain/aug assignment, ``self.X[...] = ...`` subscript
    stores, and mutator method calls (``self.X.append(...)``)."""

    def __init__(self):
        self.loads: Dict[str, ast.AST] = {}
        self.stores: Set[str] = set()
        self.method_refs: Set[str] = set()

    def visit_Attribute(self, node):
        if _self_attr(node) is not None:
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                self.stores.add(node.attr)
            else:
                self.loads.setdefault(node.attr, node)
                self.method_refs.add(node.attr)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        a = _self_attr(node.target)
        if a is not None:
            self.stores.add(a)
            self.loads.setdefault(a, node.target)
        self.generic_visit(node)

    def visit_Subscript(self, node):
        a = _self_attr(node.value)
        if a is not None and isinstance(node.ctx, (ast.Store, ast.Del)):
            self.stores.add(a)
            self.loads.setdefault(a, node)
        self.generic_visit(node)

    def visit_Call(self, node):
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS:
            a = _self_attr(fn.value)
            if a is not None:
                self.stores.add(a)
                self.loads.setdefault(a, node)
        self.generic_visit(node)


class LockDisciplineRule(Rule):
    id = "SW006"
    name = "lock-discipline"
    describe = (
        "every mutable attribute a background worker thread touches must "
        "appear in the owning class's GUARDED_ATTRS frozenset"
    )
    scope = ()

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for cls in ast.walk(ctx.tree):
            if isinstance(cls, ast.ClassDef):
                self._check_class(ctx, cls, out)
        return out

    def _check_class(self, ctx, cls, out) -> None:
        methods: Dict[str, ast.FunctionDef] = {
            st.name: st
            for st in cls.body
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        # worker entry points + the Thread() calls that start them
        targets: List = []
        for m in methods.values():
            for node in ast.walk(m):
                if isinstance(node, ast.Call) and _is_thread_ctor(node):
                    t = _thread_target_method(node)
                    if t is not None and t in methods:
                        targets.append((t, node))
        if not targets:
            return
        uses = {name: self._uses(m) for name, m in methods.items()}
        mutated_outside_init: Set[str] = set()
        for name, u in uses.items():
            if name != "__init__":
                mutated_outside_init |= u.stores
        # transitive closure of self-calls from the worker entry points
        closure: Set[str] = set()
        frontier = [t for t, _ in targets]
        while frontier:
            m = frontier.pop()
            if m in closure:
                continue
            closure.add(m)
            frontier.extend(
                r for r in uses[m].method_refs
                if r in methods and r not in closure
            )
        worker_loads: Dict[str, ast.AST] = {}
        worker_stores: Set[str] = set()
        for m in closure:
            for a, node in uses[m].loads.items():
                if a not in methods:
                    worker_loads.setdefault(a, node)
            worker_stores |= {a for a in uses[m].stores if a not in methods}
        required = sorted(
            set(worker_loads) & (worker_stores | mutated_outside_init)
            | worker_stores
        )
        if not required:
            return
        declared = _declared_guarded(cls)
        if declared is None:
            _, thread_call = targets[0]
            out.append(self.finding(
                ctx, thread_call,
                f"class {cls.name} starts a worker thread but declares "
                "no GUARDED_ATTRS; fix: add a class-level frozenset "
                "naming the shared mutable attributes "
                f"({', '.join(required)})",
            ))
            return
        for a in required:
            if a not in declared:
                node = worker_loads.get(a) or targets[0][1]
                out.append(self.finding(
                    ctx, node,
                    f"worker thread of {cls.name} touches mutable "
                    f"attribute '{a}' which is missing from "
                    "GUARDED_ATTRS; fix: add it to the declaration and "
                    "audit its synchronization",
                ))

    @staticmethod
    def _uses(m) -> _AttrUse:
        u = _AttrUse()
        for st in m.body:
            u.visit(st)
        return u
