"""AST-based invariant linter for the consensus core (the port's copy of
the reference's ``tpu_swirld/analysis/lint.py``, over ``tpu_swirld_torch/``).

The linter walks every ``.py`` file under the given paths, parses it once,
and runs each registered rule (:mod:`tpu_swirld_torch.analysis.rules`) whose
scope covers the module.  Rules are *project-specific invariants*, not
style: every finding names a concrete consensus-safety, dispatch-discipline
or thread-safety hazard and carries a fix-it message.  Scopes are module
paths inside ``tpu_swirld_torch/`` (``oracle/node.py``, ``gpu/pipeline.py``).

Suppression syntax
------------------

A finding is suppressed by a comment on the flagged line::

    for tip in self.branch_tips[m]:   # swirld-lint: disable=SW002

Multiple ids separate with commas (``disable=SW002,SW005``); rule *names*
work too (``disable=unordered-iter``); ``disable=all`` silences the line.
Anything after the id list is a free-form justification
(``# swirld-lint: disable=SW003 -- <why>``), which a rule's ``note_scope``
requires.  A file-level escape hatch, ``# swirld-lint: disable-file=SW004``
within the first ten lines, exists for generated or vendored code; the
package itself must not need it.

Programmatic use::

    from tpu_swirld_torch.analysis import lint_paths
    findings = lint_paths(["tpu_swirld_torch"])      # [] == clean tree

``check_source(source, module_path=...)`` lints a string against a
virtual module path (the per-rule fixture tests use this to place bad
snippets inside consensus-critical scopes).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import tokenize
from typing import Dict, List, Optional, Sequence, Tuple

#: the package directory name that anchors rule scopes
_PKG = "tpu_swirld_torch"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str          # rule id, e.g. "SW002"
    name: str          # rule slug, e.g. "unordered-iter"
    path: str          # file path as given to the linter
    line: int
    col: int
    message: str       # what is wrong + the fix-it

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"{self.rule}[{self.name}] {self.message}"
        )

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


class FileContext:
    """Everything a rule needs about one file: parsed tree, source lines,
    the module path used for scoping, and the cross-file package index."""

    def __init__(
        self,
        path: str,
        source: str,
        module_path: str,
        index: "PackageIndex",
    ):
        self.path = path
        self.source = source
        self.module_path = module_path
        self.index = index
        self.tree = ast.parse(source, filename=path)
        self.lines = source.splitlines()


class PackageIndex:
    """Cross-file facts collected before per-file rule checks.

    ``donations`` maps a function name to the tuple of its
    ``donate_argnums`` positions; ``donation_factories`` maps a factory
    function name (``make_*`` returning a jitted inner def) to the inner
    def's donated positions.  The donation-discipline rule resolves call
    sites against both, so a buffer donated through a factory-produced
    stage is tracked exactly like a module-level one.
    """

    def __init__(self):
        self.donations: Dict[str, Tuple[int, ...]] = {}
        self.donation_factories: Dict[str, Tuple[int, ...]] = {}

    def scan(self, tree: ast.AST) -> None:
        for node in ast.walk(tree):
            if not isinstance(node, ast.FunctionDef):
                continue
            pos = _donated_positions(node)
            if pos:
                self.donations[node.name] = pos
            else:
                inner = [
                    n for n in node.body
                    if isinstance(n, ast.FunctionDef)
                    and _donated_positions(n)
                ]
                if inner:
                    self.donation_factories[node.name] = (
                        _donated_positions(inner[0])
                    )


def _donated_positions(fn: ast.FunctionDef) -> Tuple[int, ...]:
    """``donate_argnums`` positions from a ``@jax.jit`` /
    ``@functools.partial(jax.jit, donate_argnums=...)`` decorator."""
    for dec in fn.decorator_list:
        if not isinstance(dec, ast.Call):
            continue
        is_partial = (
            isinstance(dec.func, ast.Attribute)
            and dec.func.attr == "partial"
        ) or (isinstance(dec.func, ast.Name) and dec.func.id == "partial")
        is_jit = (
            isinstance(dec.func, ast.Attribute) and dec.func.attr == "jit"
        )
        if not (is_partial or is_jit):
            continue
        for kw in dec.keywords:
            if kw.arg != "donate_argnums":
                continue
            v = kw.value
            if isinstance(v, ast.Tuple):
                out = []
                for e in v.elts:
                    if isinstance(e, ast.Constant) and isinstance(
                        e.value, int
                    ):
                        out.append(e.value)
                return tuple(out)
            if isinstance(v, ast.Constant) and isinstance(v.value, int):
                return (v.value,)
    return ()


# ----------------------------------------------------------- suppression


def _suppressions(source: str) -> Tuple[Dict[int, set], set]:
    """``(per_line, per_file)`` suppression sets parsed from
    ``# swirld-lint:`` comments (rule ids, rule names, or ``all``).

    The id list is the first whitespace-delimited token after
    ``disable=``; anything after it is a free-form justification
    (``# swirld-lint: disable=SW003 -- the deadline is wall time``).
    A rule's ``note_scope`` *requires* that justification text
    (:func:`suppression_notes`); elsewhere lint ignores it."""
    per_line: Dict[int, set] = {}
    per_file: set = set()
    for lineno, kind, ids, _note in _suppression_comments(source):
        if kind == "file":
            if lineno <= 10:
                per_file.update(ids)
        else:
            per_line.setdefault(lineno, set()).update(ids)
    return per_line, per_file


def _suppression_comments(source: str):
    """Yields ``(lineno, kind, ids, note)`` for every ``# swirld-lint:``
    comment; ``kind`` is ``"line"`` or ``"file"``, ``note`` the
    justification text following the id list (leading ``--`` stripped)."""
    try:
        toks = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except tokenize.TokenError:
        return
    for tok in toks:
        if tok.type != tokenize.COMMENT:
            continue
        text = tok.string.lstrip("#").strip()
        if not text.startswith("swirld-lint:"):
            continue
        body = text[len("swirld-lint:"):].strip()
        for prefix, kind in (("disable-file=", "file"), ("disable=", "line")):
            if body.startswith(prefix):
                spec = body[len(prefix):]
                ids_part, _, note = spec.partition(" ")
                ids = {x.strip() for x in ids_part.split(",") if x.strip()}
                note = note.strip()
                if note.startswith("--"):
                    note = note[2:].strip()
                yield tok.start[0], kind, ids, note
                break


def suppression_notes(source: str) -> Dict[int, Tuple[set, str]]:
    """Per-line suppressions *with* their justification text, for
    auditors that refuse an unjustified suppression."""
    out: Dict[int, Tuple[set, str]] = {}
    for lineno, kind, ids, note in _suppression_comments(source):
        if kind != "line":
            continue
        prev_ids, prev_note = out.get(lineno, (set(), ""))
        out[lineno] = (prev_ids | ids, note or prev_note)
    return out


def _suppressed(
    f: Finding,
    per_line: Dict[int, set],
    per_file: set,
    notes: Optional[Dict[int, Tuple[set, str]]] = None,
    require_note: bool = False,
) -> bool:
    if require_note:
        # justified-suppression scope (Rule.note_scope): only a line
        # suppression carrying a non-empty ``-- why`` note counts; bare
        # disables and file-wide disables stay findings
        ids, note = (notes or {}).get(f.line, (set(), ""))
        return bool(
            note and (f.rule in ids or f.name in ids or "all" in ids)
        )
    for ids in (per_file, per_line.get(f.line, ())):
        if ids and (f.rule in ids or f.name in ids or "all" in ids):
            return True
    return False


# ---------------------------------------------------------------- driver


def module_path(path: str) -> str:
    """Scope key for a file: its posix path relative to the
    ``tpu_swirld_torch`` package root (``oracle/node.py``), or the bare
    filename for files outside the package (scripts, tests)."""
    parts = path.replace(os.sep, "/").split("/")
    if _PKG in parts:
        i = len(parts) - 1 - parts[::-1].index(_PKG)
        rel = "/".join(parts[i + 1:])
        if rel:
            return rel
    return parts[-1]


def collect_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in ("__pycache__", ".git")
                )
                for f in sorted(files):
                    if f.endswith(".py"):
                        out.append(os.path.join(root, f))
        elif p.endswith(".py"):
            out.append(p)
    return out


def _load_rules(only: Optional[Sequence[str]] = None):
    from tpu_swirld_torch.analysis.rules import all_rules

    rules = all_rules()
    if only:
        sel = set(only)
        rules = [r for r in rules if r.id in sel or r.name in sel]
    return rules


def lint_paths(
    paths: Sequence[str],
    *,
    rules: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Lint every ``.py`` file under ``paths``; returns all unsuppressed
    findings sorted by location."""
    files = collect_files(paths)
    index = PackageIndex()
    parsed: List[Tuple[str, str, ast.AST]] = []
    findings: List[Finding] = []
    for path in files:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as exc:
            findings.append(
                Finding(
                    "SW000", "syntax", path, exc.lineno or 0, 0,
                    f"file does not parse: {exc.msg}",
                )
            )
            continue
        index.scan(tree)
        parsed.append((path, source, tree))
    rule_objs = _load_rules(rules)
    for path, source, tree in parsed:
        ctx = FileContext(path, source, module_path(path), index)
        per_line, per_file = _suppressions(source)
        notes = suppression_notes(source)
        for rule in rule_objs:
            if not rule.applies(ctx.module_path):
                continue
            require_note = rule.requires_note(ctx.module_path)
            for f in rule.check(ctx):
                if not _suppressed(f, per_line, per_file, notes=notes,
                                   require_note=require_note):
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def check_source(
    source: str,
    *,
    module_path: str = "module.py",
    path: str = "<string>",
    rules: Optional[Sequence[str]] = None,
    index: Optional[PackageIndex] = None,
) -> List[Finding]:
    """Lint a source string against a virtual module path (fixture
    helper: place a snippet "inside" ``oracle/node.py`` to hit scoped
    rules).  The donation index is built from the snippet itself unless
    an explicit ``index`` is passed."""
    if index is None:
        index = PackageIndex()
        index.scan(ast.parse(source))
    ctx = FileContext(path, source, module_path, index)
    per_line, per_file = _suppressions(source)
    notes = suppression_notes(source)
    out = []
    for rule in _load_rules(rules):
        if not rule.applies(ctx.module_path):
            continue
        require_note = rule.requires_note(ctx.module_path)
        for f in rule.check(ctx):
            if not _suppressed(f, per_line, per_file, notes=notes,
                               require_note=require_note):
                out.append(f)
    out.sort(key=lambda f: (f.line, f.col, f.rule))
    return out


def lint_summary(findings: Sequence[Finding]) -> Dict:
    """The findings summary: their count, ``clean``, and the count by
    rule id."""
    by_rule: Dict[str, int] = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    return {
        "findings": len(findings),
        "clean": not findings,
        "by_rule": dict(sorted(by_rule.items())),
    }


# ------------------------------------------------- suppression gates

#: ``scripts/lint.sh``'s gates 3 and 4 over the port: in these modules the
#: rules must hold, and every suppression of a guarded rule must be a line
#: disable with a ``-- why`` note (a bare or file-wide one is a finding).
#: The fused-dispatch modules carry the rounds span and its feeders (a
#: wall-clock read or an unpinned dtype there breaks the fused == per-chunk
#: parity and the carry's dtypes); the soak plane's fault draws, schedules
#: and verdicts must replay from the seed (an unordered walk or an
#: unjustified wall read breaks the shrinker).
SUPPRESSION_GATES = {
    "fused-dispatch": {
        "modules": ("gpu/pipeline.py", "gpu/kernels.py", "store/streaming.py",
                    "parallel.py"),
        "rules": ("SW003", "SW004"),
        "guarded": {"SW003", "wall-clock", "SW004", "dtype-discipline", "all"},
        "title": "fused-kernel SW003/SW004 gate",
        "where": "a fused-dispatch module",
    },
    "soak-plane": {
        "modules": ("net/proxy.py", "net/traffic.py", "soak.py"),
        "rules": ("SW002", "SW003"),
        "guarded": {"SW002", "unordered-iter", "SW003", "wall-clock", "all"},
        "title": "soak-plane SW002/SW003 gate",
        "where": "a soak-plane module",
    },
}


def suppression_gate(name: str, root: Optional[str] = None) -> List[str]:
    """The findings of gate ``name`` (:data:`SUPPRESSION_GATES`) over the
    package at ``root`` (default: this package), rendered one a line:
    the gate's rules' unsuppressed findings, then every bare or file-wide
    suppression of a guarded rule."""
    gate = SUPPRESSION_GATES[name]
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [os.path.join(root, m) for m in gate["modules"]]
    bad = [f.render() for f in lint_paths(paths, rules=list(gate["rules"]))]
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        for lineno, kind, ids, note in _suppression_comments(src):
            hit = ids & gate["guarded"]
            if hit and (kind == "file" or not note):
                bad.append(
                    f"{path}:{lineno}: unjustified suppression of "
                    f"{','.join(sorted(hit))} in {gate['where']} "
                    f"(needs a line disable with a '-- why' note)"
                )
    return bad


def gates_main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m tpu_swirld_torch.analysis lint-gates [--gate NAME]``: run
    the suppression gates over this package, print each finding and one
    count line a gate, exit 1 on any finding."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m tpu_swirld_torch.analysis lint-gates",
        description="lint.sh's gates 3 and 4: justified suppressions only",
    )
    ap.add_argument("--gate", action="append", choices=sorted(SUPPRESSION_GATES),
                    help="one gate (repeatable; default both)")
    args = ap.parse_args(argv)
    total = 0
    for name in args.gate or list(SUPPRESSION_GATES):
        bad = suppression_gate(name)
        for line in bad:
            print(line)
        print(f"{SUPPRESSION_GATES[name]['title']}: "
              f"{len(bad)} finding{'s' if len(bad) != 1 else ''}")
        total += len(bad)
    return 1 if total else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="python -m tpu_swirld_torch.analysis lint",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("paths", nargs="*", default=[_PKG])
    ap.add_argument("--json", action="store_true", help="machine output")
    ap.add_argument(
        "--rules", help="comma-separated rule ids/names to run (default all)"
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog"
    )
    args = ap.parse_args(argv)
    if args.list_rules:
        for r in _load_rules():
            print(f"{r.id} {r.name:<22} scope={','.join(r.scope) or '*'}")
            print(f"      {r.describe}")
        return 0
    only = args.rules.split(",") if args.rules else None
    findings = lint_paths(args.paths or [_PKG], rules=only)
    if args.json:
        print(
            json.dumps(
                {
                    **lint_summary(findings),
                    "items": [f.to_dict() for f in findings],
                },
                indent=2,
            )
        )
    else:
        for f in findings:
            print(f.render())
        n = len(findings)
        print(f"{n} finding{'s' if n != 1 else ''}")
    return 1 if findings else 0
