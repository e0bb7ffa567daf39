"""SW004 dtype-discipline: explicit dtypes in kernel/slab code (the port's
copy of the reference's rule, with a ``torch`` table in place of its
``jnp`` one).

NumPy allocation defaults are platform-flavored (``np.arange`` without a
dtype is int64 on linux); torch defaults to int64 for ``arange`` over
integers and to float32 otherwise.  A slab or index tensor that silently
lands in int64 or float32 doubles or quadruples card traffic against the
int32 / bool layouts the kernels take, and makes a stage's signature
depend on an argument's Python type.  The rule forbids implicit dtypes on
array and tensor allocations in ``gpu/``, ``store/`` and ``parallel.py``,
plus builtin-``int``/``float`` as dtype arguments (their width is
platform-defined).
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from tpu_swirld_torch.analysis.lint import FileContext, Finding
from tpu_swirld_torch.analysis.rules import Rule

#: allocator -> number of positional args at which dtype is covered
#: (np.zeros(shape, dtype) -> 2 positionals mean dtype was passed)
_NP_ALLOCATORS = {
    "zeros": 2, "ones": 2, "empty": 2, "arange": 4, "full": 3,
}
#: torch allocators: ``dtype`` is keyword-only there, so no positional
#: count covers it (None)
_TORCH_ALLOCATORS = {
    "zeros": None, "ones": None, "empty": None, "full": None, "arange": None,
}

#: builtin ``bool`` is exempt: as a dtype it IS np.bool_ (1 byte
#: everywhere); int/float are C-long/double and platform-flavored
_BUILTIN_DTYPES = {"int", "float"}


class DtypeRule(Rule):
    id = "SW004"
    name = "dtype-discipline"
    describe = (
        "kernel/slab allocations must pin an explicit dtype "
        "(np defaults promote to int64/float64, torch's to int64/float32, "
        "against the int32 / bool slabs); builtin int/float dtypes are "
        "platform-width"
    )
    scope = ("gpu/", "store/", "parallel.py")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Attribute) and isinstance(
                fn.value, ast.Name
            ):
                mod, attr = fn.value.id, fn.attr
                table = None
                if mod in ("np", "numpy"):
                    table = _NP_ALLOCATORS
                elif mod == "torch":
                    table = _TORCH_ALLOCATORS
                if table is not None and attr in table:
                    has_dtype_kw = any(
                        kw.arg == "dtype" for kw in node.keywords
                    )
                    covered_at = table[attr]
                    if not has_dtype_kw and (
                        covered_at is None or len(node.args) < covered_at
                    ):
                        default = (
                            "int64" if attr == "arange" else
                            "float32" if mod == "torch" else "float64"
                        )
                        fix = (
                            "torch.int32 / torch.int64 / torch.bool"
                            if mod == "torch" else "np.int32 / np.bool_"
                        )
                        out.append(self.finding(
                            ctx, node,
                            f"{mod}.{attr}(...) without an explicit dtype "
                            f"defaults to {default}, which widens slab "
                            "bytes and makes the dtype depend on the "
                            f"arguments' types; fix: pass dtype={fix} "
                            "explicitly",
                        ))
                # .astype(int) and friends
                if attr == "astype" and node.args:
                    a = node.args[0]
                    if isinstance(a, ast.Name) and a.id in _BUILTIN_DTYPES:
                        out.append(self.finding(
                            ctx, node,
                            f".astype({a.id}) uses the platform-width "
                            "builtin; fix: name the width "
                            "(np.int32 / np.float32 / np.bool_)",
                        ))
            # dtype=int / dtype=float keyword on any call
            for kw in node.keywords:
                if (
                    kw.arg == "dtype"
                    and isinstance(kw.value, ast.Name)
                    and kw.value.id in _BUILTIN_DTYPES
                ):
                    out.append(self.finding(
                        ctx, kw.value,
                        f"dtype={kw.value.id} is the platform-width "
                        "builtin; fix: name the width "
                        "(np.int32 / np.float32 / np.bool_)",
                    ))
        return out
