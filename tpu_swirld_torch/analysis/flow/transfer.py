"""Per-op transfer functions over the interval×dtype lattice (the port's
counterpart of the reference's ``tpu_swirld/analysis/flow/transfer.py``,
keyed by aten overload instead of jaxpr primitive).

Every aten overload the port's stage bodies dispatch has an entry in
``TRANSFERS``; :func:`apply_transfer` runs one through it and then the
centralized safety checks:

- **SW008** (overflow-reachable): the transfer computes the
  *mathematical* result interval in unbounded Python arithmetic; if an
  integer output's interval escapes its dtype range the site is
  reported, then the interval is clamped to the dtype range so one
  overflow doesn't cascade into a wall of downstream findings.  The
  same check covers the f32-tally exactness argument: an
  integer-valued float accumulation whose bound reaches 2**(mantissa+1)
  can no longer be exact, which is reported as SW008 and the
  ``integral`` flag dropped.
- **SW009** (unproven bounds): every gather and scatter index
  (``index``, ``index_select``, ``gather``, ``index_put_``,
  ``index_add_``) must be provably inside ``[0, dim - 1]``.  PyTorch has
  no clip mode: an index past the end raises on the CPU and traps on the
  card, and a negative one silently reads from the end, so each one must
  be proven statically.
- **SW010** (lossy narrowing): ``_to_copy`` (``.to(dtype)``) and every
  write into a narrower storage (``copy_``, ``index_put_``) where the
  operand interval is not provably representable in the target dtype
  (including int→float casts past the float's exact-integer range).
- **SW011** (sentinel collision): ``where`` where one arm is a constant
  equal to a declared padding sentinel and another arm's interval
  contains that value — the sentinel becomes indistinguishable from
  live data.

Output dtypes are never derived here: the interpreter reads them from
the fake tensor each op produced, so PyTorch's own promotion (``sum`` of
int32 giving int64, ``stake * bool_mask``, ``where(c, x, INT32_MAX)``
keeping ``x``'s dtype) is what the checks see.

Unknown ops raise :class:`UnknownPrimitiveError` (the reference's name)
— the registry never guesses (exit code 2 at the CLI; there is no
"assume top" path).

``where`` performs pattern-based path refinement: when the predicate is
itself ``lt/le/gt/ge/eq(v, k)`` and an arm is ``v`` or ``v ± c`` of the
*same* tensor, the arm's interval is first met with the branch
condition (``cur = where(nxt >= 0, nxt, cur)`` walks a self-parent chain
with a proven-non-negative index).
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

from tpu_swirld_torch.analysis.flow.lattice import (
    AbsVal,
    Interval,
    NEG_INF,
    POS_INF,
    dtype_name,
    dtype_range,
    float_mantissa_bits,
    is_bool_dtype,
    is_float_dtype,
    is_int_dtype,
    iv_abs,
    iv_add,
    iv_div_float,
    iv_max,
    iv_min,
    iv_mul,
    iv_neg,
    iv_sub,
)


class UnknownPrimitiveError(Exception):
    """An op without a registered transfer function was reached."""

    def __init__(self, primitive: str, stage: str = "?", where: str = "?"):
        self.primitive = primitive
        self.stage = stage
        self.where = where
        super().__init__(
            f"no transfer function for op {primitive!r} "
            f"(stage {stage}, at {where}); the registry hard-fails rather "
            f"than guess — add a sound transfer to analysis/flow/transfer.py"
        )


TRANSFERS = {}

#: overloads whose int results are accumulations — these also get the
#: integral-float exactness check (f32 tallies must stay < 2**24).
ACCUMULATING = frozenset({
    "aten.add.Tensor", "aten.add_.Tensor", "aten.sub.Tensor",
    "aten.rsub.Scalar", "aten.mul.Tensor", "aten.mm.default",
    "aten.sum.default", "aten.sum.dim_IntList", "aten.cumsum.default",
    "aten.cumprod.default", "aten.index_add_.default",
})

#: overloads that run their own representability check (skip SW008 there).
SELF_CHECKED = frozenset({"aten._to_copy.default", "aten.copy_.default"})



def register(*names):
    def deco(fn):
        for n in names:
            TRANSFERS[n] = fn
        return fn
    return deco


def registered_primitives():
    """Sorted names of all aten overloads with transfers."""
    return sorted(TRANSFERS)


def _exact_float_limit(dtype) -> int:
    return 1 << (float_mantissa_bits(dtype) + 1)


def _iv(x) -> Interval:
    """Interval of a bound argument: an AbsVal's, a Python number's point."""
    if isinstance(x, AbsVal):
        return x.iv
    if isinstance(x, bool):
        return Interval.point(int(x))
    if isinstance(x, int):
        return Interval.point(x)
    if isinstance(x, float):
        return Interval.point(x)
    raise TypeError(f"no interval for argument {x!r}")


def _integral(x) -> bool:
    if isinstance(x, AbsVal):
        return x.integral
    if isinstance(x, float):
        return math.isfinite(x) and x == int(x)
    return True


def apply_transfer(ctx, name: str, args: Sequence[Any], outs: Sequence[Any]):
    """Run one overload's transfer; returns ``[(Interval, integral)]`` per
    tensor output (``outs`` are the fake outputs, dtype and shape read
    from them), after the SW008 / exactness checks."""
    fn = TRANSFERS.get(name)
    if fn is None:
        raise UnknownPrimitiveError(name, getattr(ctx, "stage", "?"), ctx.where())
    ctx.exercised.add(name)
    res = fn(ctx, name, args, outs)
    checked = []
    for o, (iv, integral) in zip(outs, res):
        dt = o.dtype
        if iv.is_bottom:
            checked.append((iv, integral))
            continue
        if is_bool_dtype(dt):
            iv = iv.meet(Interval(0, 1))
            if iv.is_bottom:
                iv = Interval(0, 1)
        elif is_int_dtype(dt) and name not in SELF_CHECKED:
            lo, hi = dtype_range(dt)
            if iv.lo < lo or iv.hi > hi:
                ctx.report(
                    "SW008", name,
                    f"{_short(name)}: {dtype_name(dt)} result can reach "
                    f"{iv}, outside [{lo}, {hi}] — integer wraparound "
                    f"reachable at this envelope",
                )
                iv = iv.meet(Interval(lo, hi))
        elif is_float_dtype(dt) and integral and name in ACCUMULATING:
            lim = _exact_float_limit(dt)
            m = max(abs(iv.lo), abs(iv.hi))
            if m >= lim:
                ctx.report(
                    "SW008", name,
                    f"{_short(name)}: integer-valued {dtype_name(dt)} "
                    f"accumulation can reach {iv}, at or past the exact-"
                    f"integer limit 2**{lim.bit_length() - 1} — tally no "
                    f"longer exact",
                )
                integral = False
        checked.append((iv, bool(integral)))
    return checked


def _short(name: str) -> str:
    """``index_select`` for ``aten.index_select.default``."""
    return name.split(".")[1] if name.count(".") >= 2 else name


# --------------------------------------------------------------------------
# elementwise arithmetic


def _alpha(args, i=2) -> Interval:
    return _iv(args[i]) if len(args) > i and args[i] is not None else Interval.point(1)


@register("aten.add.Tensor", "aten.add_.Tensor")
def _t_add(ctx, name, args, outs):
    a, b = args[0], args[1]
    return [(iv_add(_iv(a), iv_mul(_iv(b), _alpha(args))),
             _integral(a) and _integral(b))]


@register("aten.sub.Tensor")
def _t_sub(ctx, name, args, outs):
    a, b = args[0], args[1]
    return [(iv_sub(_iv(a), iv_mul(_iv(b), _alpha(args))),
             _integral(a) and _integral(b))]


@register("aten.rsub.Scalar")
def _t_rsub(ctx, name, args, outs):
    a, b = args[0], args[1]
    return [(iv_sub(_iv(b), iv_mul(_iv(a), _alpha(args))),
             _integral(a) and _integral(b))]


@register("aten.mul.Tensor")
def _t_mul(ctx, name, args, outs):
    a, b = args[0], args[1]
    return [(iv_mul(_iv(a), _iv(b)), _integral(a) and _integral(b))]


@register("aten.neg.default")
def _t_neg(ctx, name, args, outs):
    return [(iv_neg(_iv(args[0])), _integral(args[0]))]


@register("aten.abs.default")
def _t_abs(ctx, name, args, outs):
    return [(iv_abs(_iv(args[0])), _integral(args[0]))]


@register("aten.div.Tensor")
def _t_div(ctx, name, args, outs):
    return [(iv_div_float(_iv(args[0]), _iv(args[1])), False)]


def _iv_floordiv(a: Interval, b: Interval) -> Interval:
    """Python / torch floor division; conservative when b spans 0."""
    if a.is_bottom or b.is_bottom:
        return Interval.bottom()
    if b.lo <= 0 <= b.hi:
        # |floor(a / b)| <= |a| once |b| >= 1 on the int lattice
        m = max(abs(a.lo), abs(a.hi))
        return Interval(-m, m)
    cands = []
    for x in (a.lo, a.hi):
        for y in (b.lo, b.hi):
            if x in (POS_INF, NEG_INF) or y in (POS_INF, NEG_INF):
                cands.append(0 if x == 0 else (POS_INF if (x > 0) == (y > 0) else NEG_INF))
            elif isinstance(x, int) and isinstance(y, int):
                cands.append(x // y)
            else:
                cands.append(math.floor(x / y))
    return Interval(min(cands), max(cands))


@register("aten.floor_divide.default")
def _t_floor_divide(ctx, name, args, outs):
    return [(_iv_floordiv(_iv(args[0]), _iv(args[1])), True)]


def remainder_summary(a: Interval, b: Interval) -> Optional[Interval]:
    """Closed-form interval of ``torch.remainder(a, b)`` (floored mod: the
    result's sign follows the divisor) when the divisor interval has a
    definite sign; None when it spans zero."""
    if a.is_bottom or b.is_bottom:
        return None
    if b.lo > 0:
        if a.lo >= 0 and a.hi < b.lo:
            return a          # already reduced
        return Interval(0, b.hi - 1 if isinstance(b.hi, int) else b.hi)
    if b.hi < 0:
        return Interval(b.lo + 1 if isinstance(b.lo, int) else b.lo, 0)
    return None


@register("aten.remainder.Scalar")
def _t_remainder(ctx, name, args, outs):
    a, b = _iv(args[0]), _iv(args[1])
    s = remainder_summary(a, b)
    if s is None:
        m = max(abs(b.lo), abs(b.hi))
        s = Interval(-m, m)
    return [(s, _integral(args[0]) and _integral(args[1]))]


@register("aten.maximum.default")
def _t_maximum(ctx, name, args, outs):
    a, b = args[0], args[1]
    return [(iv_max(_iv(a), _iv(b)), _integral(a) and _integral(b))]


@register("aten.minimum.default")
def _t_minimum(ctx, name, args, outs):
    a, b = args[0], args[1]
    return [(iv_min(_iv(a), _iv(b)), _integral(a) and _integral(b))]


@register("aten.clamp.default")
def _t_clamp(ctx, name, args, outs):
    x = args[0]
    iv = _iv(x)
    integral = _integral(x)
    lo_v = args[1] if len(args) > 1 else None
    hi_v = args[2] if len(args) > 2 else None
    if lo_v is not None:
        iv = iv_max(iv, _iv(lo_v))
        integral = integral and _integral(lo_v)
    if hi_v is not None:
        iv = iv_min(iv, _iv(hi_v))
        integral = integral and _integral(hi_v)
    return [(iv, integral)]


@register("aten.clamp_min.default")
def _t_clamp_min(ctx, name, args, outs):
    return [(iv_max(_iv(args[0]), _iv(args[1])),
             _integral(args[0]) and _integral(args[1]))]


@register("aten.clamp_max.default")
def _t_clamp_max(ctx, name, args, outs):
    return [(iv_min(_iv(args[0]), _iv(args[1])),
             _integral(args[0]) and _integral(args[1]))]


# --------------------------------------------------------------------------
# boolean / bitwise


def _bitlen(v):
    if v in (POS_INF, NEG_INF):
        return None
    return int(v).bit_length()


def _top(out) -> Interval:
    return Interval(*dtype_range(out.dtype))


@register("aten.bitwise_and.Tensor")
def _t_and(ctx, name, args, outs):
    a, b = _iv(args[0]), _iv(args[1])
    if is_bool_dtype(outs[0].dtype):
        return [(iv_min(a, b).meet(Interval(0, 1)), True)]
    if a.lo >= 0 and b.lo >= 0:
        return [(Interval(0, min(a.hi, b.hi)), True)]
    return [(_top(outs[0]), True)]


@register("aten.bitwise_or.Tensor", "aten.bitwise_or_.Tensor")
def _t_or(ctx, name, args, outs):
    a, b = _iv(args[0]), _iv(args[1])
    if is_bool_dtype(outs[0].dtype):
        return [(iv_max(a, b).meet(Interval(0, 1)), True)]
    if a.lo >= 0 and b.lo >= 0:
        ba, bb = _bitlen(a.hi), _bitlen(b.hi)
        if ba is None or bb is None:
            return [(_top(outs[0]), True)]
        hi = (1 << max(ba, bb)) - 1
        return [(Interval(max(a.lo, b.lo), max(hi, 0)), True)]
    return [(_top(outs[0]), True)]


@register("aten.bitwise_xor.Scalar")
def _t_xor(ctx, name, args, outs):
    a, b = _iv(args[0]), _iv(args[1])
    if is_bool_dtype(outs[0].dtype):
        return [(Interval(0, 1), True)]
    if a.lo >= 0 and b.lo >= 0:
        ba, bb = _bitlen(a.hi), _bitlen(b.hi)
        if ba is not None and bb is not None:
            return [(Interval(0, (1 << max(ba, bb)) - 1), True)]
    return [(_top(outs[0]), True)]


@register("aten.bitwise_not.default")
def _t_not(ctx, name, args, outs):
    a = _iv(args[0])
    if is_bool_dtype(outs[0].dtype):
        if a.is_point and a.lo in (0, 1):
            return [(Interval.point(1 - a.lo), True)]
        return [(Interval(0, 1), True)]
    return [(Interval(-a.hi - 1, -a.lo - 1), True)]


def _cmp_decide(op: str, a: Interval, b: Interval) -> Interval:
    """Fold a comparison to a point when the operand intervals decide it
    for every element (whole-array abstraction: a decided interval
    comparison is decided element-wise)."""
    if a.is_bottom or b.is_bottom:
        return Interval(0, 1)
    if op == "lt":
        if a.hi < b.lo:
            return Interval.point(1)
        if a.lo >= b.hi:
            return Interval.point(0)
    elif op == "le":
        if a.hi <= b.lo:
            return Interval.point(1)
        if a.lo > b.hi:
            return Interval.point(0)
    elif op == "gt":
        if a.lo > b.hi:
            return Interval.point(1)
        if a.hi <= b.lo:
            return Interval.point(0)
    elif op == "ge":
        if a.lo >= b.hi:
            return Interval.point(1)
        if a.hi < b.lo:
            return Interval.point(0)
    elif op == "eq":
        if a.is_point and b.is_point and a.lo == b.lo:
            return Interval.point(1)
        if a.hi < b.lo or b.hi < a.lo:
            return Interval.point(0)
    elif op == "ne":
        if a.is_point and b.is_point and a.lo == b.lo:
            return Interval.point(0)
        if a.hi < b.lo or b.hi < a.lo:
            return Interval.point(1)
    return Interval(0, 1)


def _cmp_op(name: str) -> str:
    return name.split(".")[1]


def _t_cmp(ctx, name, args, outs):
    return [(_cmp_decide(_cmp_op(name), _iv(args[0]), _iv(args[1])), True)]


register("aten.eq.Tensor", "aten.eq.Scalar", "aten.ge.Tensor", "aten.ge.Scalar",
         "aten.gt.Tensor", "aten.gt.Scalar", "aten.le.Scalar",
         "aten.lt.Scalar")(_t_cmp)


# --------------------------------------------------------------------------
# where with path refinement + sentinel-collision check (SW011)

_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}


def _refine_by_pred(v_iv: Interval, op: str, k_iv: Interval, branch: bool) -> Interval:
    """Interval of v inside the branch where ``op(v, k)`` is `branch`."""
    if op == "lt":
        cond_true = Interval(NEG_INF, k_iv.hi - 1 if isinstance(k_iv.hi, int) else k_iv.hi)
        cond_false = Interval(k_iv.lo, POS_INF)
    elif op == "le":
        cond_true = Interval(NEG_INF, k_iv.hi)
        cond_false = Interval(k_iv.lo + 1 if isinstance(k_iv.lo, int) else k_iv.lo, POS_INF)
    elif op == "gt":
        cond_true = Interval(k_iv.lo + 1 if isinstance(k_iv.lo, int) else k_iv.lo, POS_INF)
        cond_false = Interval(NEG_INF, k_iv.hi)
    elif op == "ge":
        cond_true = Interval(k_iv.lo, POS_INF)
        cond_false = Interval(NEG_INF, k_iv.hi - 1 if isinstance(k_iv.hi, int) else k_iv.hi)
    elif op == "eq":
        cond_true = k_iv
        cond_false = Interval(NEG_INF, POS_INF)
    else:
        return v_iv
    return v_iv.meet(cond_true if branch else cond_false)


def _path_refined(ctx, raw, vals) -> Optional[Interval]:
    """The joined arms of ``where(pred, x, y)`` with each arm that is the
    predicate's compared tensor (or it plus a constant) met with its
    branch's condition; None when the predicate is not such a
    comparison."""
    pd = ctx.producer(raw[0])
    if pd is None:
        return None
    op_name, p_args = pd
    parts = op_name.split(".")
    op = parts[1] if len(parts) == 3 and parts[0] == "aten" else None
    if op not in _FLIP or len(p_args) < 2:
        return None
    lhs, rhs = p_args[0], p_args[1]
    k_iv = ctx.const_interval(rhs)
    base = ctx.peel(lhs)
    if k_iv is None:
        k_iv = ctx.const_interval(lhs)
        base = ctx.peel(rhs)
        op = _FLIP[op]
    if k_iv is None or not ctx.is_tensor(base):
        return None
    base_iv = ctx.value_of(base).iv
    out = Interval.bottom()
    for branch, arm_raw, arm_val in ((True, raw[1], vals[1]), (False, raw[2], vals[2])):
        off = ctx.offset_of(arm_raw, base)
        if off is None:
            out = out.join(_iv(arm_val))
        else:
            br = _refine_by_pred(base_iv, op, k_iv, branch)
            if not br.is_bottom:
                out = out.join(iv_add(br, off))
    return out


@register("aten.where.self")
def _t_where(ctx, name, args, outs):
    cond, x, y = args[0], args[1], args[2]
    out_dt = outs[0].dtype
    c_iv = _iv(cond)
    cases = (y, x)   # select_n order: index 0 picks the False arm
    if c_iv.is_point and c_iv.lo in (0, 1):
        sel = cases[int(c_iv.lo)]
        return [(_iv(sel), _integral(sel))]
    iv = _path_refined(ctx, ctx.raw_args(), args)
    if iv is None:
        iv = _iv(x).join(_iv(y))

    # SW011: one arm a constant sentinel, another arm's live range
    # containing that very value.
    if is_int_dtype(out_dt):
        arms = [_iv(x), _iv(y)]
        for sval in ctx.sentinels:
            if not any(a.is_point and a.lo == sval for a in arms):
                continue
            for a in arms:
                if a.is_point and a.lo == sval:
                    continue
                if a.contains(sval):
                    ctx.report(
                        "SW011", name,
                        f"where: one arm is the padding sentinel {sval} "
                        f"and another arm's range {a} contains it — "
                        f"sentinel can collide with live data",
                    )
                    break
    return [(iv, _integral(x) and _integral(y))]


@register("aten.masked_fill.Scalar")
def _t_masked_fill(ctx, name, args, outs):
    x, mask, v = args[0], args[1], args[2]
    m = _iv(mask)
    if m.is_point and m.lo == 0:
        return [(_iv(x), _integral(x))]
    return [(_iv(x).join(_iv(v)), _integral(x) and _integral(v))]


# --------------------------------------------------------------------------
# dtype conversion (SW010)


def convert(ctx, name, a: AbsVal, new_dt) -> Tuple[Interval, bool]:
    """``a`` represented in ``new_dt``: reports SW010 when a value is lost
    (a narrowing cast, or an int→float cast past the float's exact-integer
    range), then clamps."""
    iv = a.iv
    integral = a.integral
    if iv.is_bottom:
        return iv, integral
    if is_bool_dtype(new_dt):
        if iv.is_point and iv.lo == 0:
            return Interval(0, 0), True
        if not iv.contains(0):
            return Interval(1, 1), True
        return Interval(0, 1), True
    if is_int_dtype(new_dt):
        lo, hi = dtype_range(new_dt)
        src_lo = iv.lo if a.integral or iv.lo == NEG_INF else math.floor(iv.lo)
        src_hi = iv.hi if a.integral or iv.hi == POS_INF else math.ceil(iv.hi)
        if src_lo < lo or src_hi > hi:
            ctx.report(
                "SW010", name,
                f"{_short(name)}: narrowing to {dtype_name(new_dt)} loses "
                f"values — operand range {iv} exceeds [{lo}, {hi}]",
            )
        out = Interval(
            max(lo, int(src_lo) if src_lo not in (NEG_INF, POS_INF) else lo),
            min(hi, int(src_hi) if src_hi not in (NEG_INF, POS_INF) else hi),
        )
        if out.is_bottom:
            out = Interval(lo, hi)
        return out, True
    if is_float_dtype(new_dt):
        if a.integral and (is_int_dtype(a.dtype) or is_bool_dtype(a.dtype)):
            lim = _exact_float_limit(new_dt)
            m = max(abs(iv.lo), abs(iv.hi))
            if m >= lim:
                ctx.report(
                    "SW010", name,
                    f"{_short(name)}: int→{dtype_name(new_dt)} cast of range "
                    f"{iv} passes the exact-integer limit 2**"
                    f"{lim.bit_length() - 1} — values rounded",
                )
                integral = False
        return Interval(float(iv.lo), float(iv.hi)), integral
    return iv, integral


@register("aten._to_copy.default")
def _t_to_copy(ctx, name, args, outs):
    a = args[0]
    return [convert(ctx, name, a, outs[0].dtype)]


@register("aten.copy_.default")
def _t_copy_(ctx, name, args, outs):
    return [convert(ctx, name, _as_absval(args[1]), outs[0].dtype)]


def _as_absval(x) -> AbsVal:
    if isinstance(x, AbsVal):
        return x
    iv = _iv(x)
    return AbsVal((), "int64" if isinstance(x, (int, bool)) else "float64",
                  iv, _integral(x))


# --------------------------------------------------------------------------
# shape-only / structural


def _passthrough(ctx, name, args, outs):
    a = args[0]
    return [(_iv(a), _integral(a)) for _ in outs]


# views (the output shares its input's storage, so the interpreter stores
# nothing for them), copies, rolls and a whole-tensor max
register(
    "aten.view.default", "aten._unsafe_view.default", "aten.unsqueeze.default",
    "aten.permute.default", "aten.transpose.int", "aten.slice.Tensor",
    "aten.select.int", "aten.alias.default", "aten.detach.default",
    "aten.clone.default", "aten.lift_fresh.default", "aten.roll.default",
    "aten.max.default",
)(_passthrough)


@register("aten.cat.default")
def _t_cat(ctx, name, args, outs):
    iv = Interval.bottom()
    integral = True
    for a in args[0]:
        if a.size:
            iv = iv.join(a.iv)
            integral = integral and a.integral
    return [(iv, integral)]


@register("aten.full.default")
def _t_full(ctx, name, args, outs):
    return [(_iv(args[1]), _integral(args[1]))]


@register("aten.scalar_tensor.default")
def _t_scalar_tensor(ctx, name, args, outs):
    return [(_iv(args[0]), _integral(args[0]))]


@register("aten.zeros.default")
def _t_zeros(ctx, name, args, outs):
    return [(Interval.point(0), True)]


@register("aten.ones.default")
def _t_ones(ctx, name, args, outs):
    return [(Interval.point(1), True)]


@register("aten.empty_like.default")
def _t_empty(ctx, name, args, outs):
    # nothing written yet: bottom, joined by the writes that follow
    return [(Interval.bottom(), True)]


@register("aten.fill_.Scalar", "aten.fill_.Tensor")
def _t_fill(ctx, name, args, outs):
    return [(_iv(args[1]), _integral(args[1]))]


@register("aten.zero_.default")
def _t_zero_(ctx, name, args, outs):
    return [(Interval.point(0), True)]


@register("aten.eye.default")
def _t_eye(ctx, name, args, outs):
    return [(Interval(0, 1), True)]


@register("aten.arange.default")
def _t_arange(ctx, name, args, outs):
    n = outs[0].shape[0]
    return [(Interval(0, n - 1) if n else Interval.bottom(), True)]


# --------------------------------------------------------------------------
# reductions


def _reduced_count(shape, dims) -> int:
    if dims is None or (isinstance(dims, (list, tuple)) and len(dims) == 0):
        dims = range(len(shape))
    elif isinstance(dims, int):
        dims = [dims]
    n = 1
    for d in dims:
        n *= shape[d] if shape else 1
    return max(n, 1)


@register("aten.sum.default", "aten.sum.dim_IntList")
def _t_sum(ctx, name, args, outs):
    a = args[0]
    dims = args[1] if name == "aten.sum.dim_IntList" and len(args) > 1 else None
    n = _reduced_count(a.shape, dims)
    # a sum of exactly n elements, each in [lo, hi], is [n*lo, n*hi]
    return [(Interval(a.iv.lo * n, a.iv.hi * n), a.integral)]


@register("aten.any.dim", "aten.all.dim")
def _t_any_all(ctx, name, args, outs):
    iv = _iv(args[0])
    if iv.is_point and iv.lo in (0, 1):
        return [(Interval.point(int(iv.lo)), True)]
    if not iv.is_bottom and not iv.contains(0):
        return [(Interval.point(1), True)]
    return [(Interval(0, 1), True)]


@register("aten.sort.default")
def _t_sort(ctx, name, args, outs):
    a, dim = args[0], args[1]
    n = a.shape[dim] if a.shape else 1
    return [(a.iv, a.integral), (Interval(0, max(n - 1, 0)), True)]


@register("aten.argmax.default")
def _t_argmax(ctx, name, args, outs):
    a = args[0]
    dim = args[1] if len(args) > 1 else None
    n = _reduced_count(a.shape, dim)
    return [(Interval(0, max(n - 1, 0)), True)]


@register("aten.cumsum.default")
def _t_cumsum(ctx, name, args, outs):
    a = args[0]
    n = a.shape[args[1]] if a.shape else 1
    lo = min(a.iv.lo, a.iv.lo * n)
    hi = max(a.iv.hi, a.iv.hi * n)
    return [(Interval(lo, hi), a.integral)]


@register("aten.cumprod.default")
def _t_cumprod(ctx, name, args, outs):
    a = args[0]
    n = a.shape[args[1]] if a.shape else 1
    lo, hi = a.iv.lo, a.iv.hi
    if lo >= 0 and hi <= 1:
        iv = Interval(0 if lo < 1 else 1, hi)
    elif lo >= -1 and hi <= 1:
        m = max(abs(lo), abs(hi))
        iv = Interval(-m, m)
    else:
        m = max(abs(lo), abs(hi))
        try:
            big = m ** n if m not in (POS_INF,) else POS_INF
        except OverflowError:
            big = POS_INF
        iv = Interval(0 if lo >= 0 else -big, big)
    return [(iv, a.integral)]


@register("aten.mm.default")
def _t_matmul(ctx, name, args, outs):
    a, b = args[0], args[1]
    k = max(a.shape[-1], 1)
    p = iv_mul(a.iv, b.iv)
    # a sum of exactly k products, each in [p.lo, p.hi]
    return [(Interval(p.lo * k, p.hi * k), a.integral and b.integral)]


# --------------------------------------------------------------------------
# indexing (SW009)


def check_index(ctx, name, idx, extent: int, what: str) -> None:
    """SW009 unless every value of ``idx`` lies in ``[0, extent - 1]``."""
    iv = _iv(idx)
    if iv.is_bottom:
        return
    if iv.lo < 0 or iv.hi > extent - 1:
        ctx.report(
            "SW009", name,
            f"{_short(name)}: index range {iv} ({what}, extent {extent}) "
            f"not provably within [0, {extent - 1}] — out-of-bounds access "
            f"unproven at this envelope",
        )


def _index_list(ctx, name, x: AbsVal, indices) -> None:
    for d, idx in enumerate(indices):
        if idx is None:
            continue
        if is_bool_dtype(idx.dtype):
            continue   # a mask: its shape is checked by PyTorch
        check_index(ctx, name, idx, x.shape[d], f"dim {d}")


@register("aten.index.Tensor")
def _t_index(ctx, name, args, outs):
    x, indices = args[0], args[1]
    _index_list(ctx, name, x, indices)
    return [(x.iv, x.integral)]


@register("aten.index_select.default")
def _t_index_select(ctx, name, args, outs):
    x, dim, idx = args[0], args[1], args[2]
    check_index(ctx, name, idx, x.shape[dim], f"dim {dim}")
    return [(x.iv, x.integral)]


@register("aten.gather.default")
def _t_gather(ctx, name, args, outs):
    x, dim, idx = args[0], args[1], args[2]
    check_index(ctx, name, idx, x.shape[dim], f"dim {dim}")
    return [(x.iv, x.integral)]


def _n_positions(indices) -> int:
    """Index positions of an advanced-indexing write (its broadcast index
    shape's size, bounded by the largest index tensor's)."""
    n = 1
    for idx in indices:
        if idx is not None:
            n = max(n, idx.size)
    return n


@register("aten.index_put_.default")
def _t_index_put(ctx, name, args, outs):
    x, indices, v = args[0], args[1], args[2]
    accumulate = bool(args[3]) if len(args) > 3 else False
    _index_list(ctx, name, x, indices)
    val = convert(ctx, name, _as_absval(v), x.dtype) if v.dtype != x.dtype else (v.iv, v.integral)
    if accumulate:
        # worst case every update lands on one slot
        n = _n_positions(indices)
        delta = Interval(min(0, val[0].lo) * n, max(0, val[0].hi) * n)
        return [(iv_add(x.iv, delta), x.integral and val[1])]
    return [(x.iv.join(val[0]), x.integral and val[1])]


@register("aten.index_add_.default")
def _t_index_add(ctx, name, args, outs):
    x, dim, idx, src = args[0], args[1], args[2], args[3]
    alpha = _iv(args[4]) if len(args) > 4 and args[4] is not None else Interval.point(1)
    check_index(ctx, name, idx, x.shape[dim], f"dim {dim}")
    # worst case every source slice lands on one slot
    n = max(idx.size, 1)
    u = iv_mul(src.iv, alpha)
    delta = Interval(min(0, u.lo) * n, max(0, u.hi) * n)
    return [(iv_add(x.iv, delta), x.integral and src.integral)]
