"""Interval × dtype lattice for the scale-envelope flow analysis (the
port's copy of the reference's ``tpu_swirld/analysis/flow/lattice.py``).

The abstract domain is deliberately *whole-array*: one interval per
tensor storage, covering every element the storage can hold (a view
shares its base's interval).  Shapes and dtypes ride along exactly (they
come for free from the fake tensors the interpreter runs on), so the
only thing this module approximates is the **value range**.
That is enough to prove the properties the audit cares about — "no
int32 in this kernel can exceed 2**31-1 at the 1M envelope" is a
statement about the max over all elements, which is exactly what a
whole-array interval bounds.

Two refinements beyond a plain interval:

- ``integral``: True when every element is known to be integer-valued
  *even if the dtype is floating*.  The pipeline's f32 GEMM tally path
  is sound only because integer-valued f32 sums stay exact below 2**24;
  the flag lets :mod:`.transfer` check that argument instead of
  drowning the float path in false positives.
- interval endpoints are plain Python ints/floats (arbitrary precision
  for ints), so overflow detection compares the *mathematical* result
  against the dtype range — the analysis itself cannot wrap.

Dtypes may be numpy dtypes or ``torch.dtype`` objects (read by name:
this module imports no torch).  The interval arithmetic is the
reference's, case for case.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np

NEG_INF = float("-inf")
POS_INF = float("inf")


#: torch dtypes by name -> the numpy dtype with the same value set
_TORCH_AS_NUMPY = {
    "bool": "bool", "uint8": "uint8", "int8": "int8", "int16": "int16",
    "int32": "int32", "int64": "int64", "float16": "float16",
    "float32": "float32", "float64": "float64",
}
#: bfloat16 has no numpy dtype: its finite max and its mantissa bits
_BF16_MAX = float.fromhex("0x1.fep127")
_BF16_NMANT = 7


def _torch_name(dtype) -> Optional[str]:
    """``"int32"`` for ``torch.int32``; None for anything not a torch
    dtype."""
    t = type(dtype)
    if t.__module__ == "torch" and t.__name__ == "dtype":
        return str(dtype).split(".", 1)[1]
    return None


def as_numpy_dtype(dtype):
    """The numpy dtype of a numpy or torch dtype (``None`` for bfloat16,
    which numpy lacks)."""
    name = _torch_name(dtype)
    if name is None:
        return np.dtype(dtype)
    if name == "bfloat16":
        return None
    if name not in _TORCH_AS_NUMPY:
        raise ValueError(f"unsupported dtype for interval analysis: {dtype!r}")
    return np.dtype(_TORCH_AS_NUMPY[name])


_KINDS: dict = {}


def dtype_kind(dtype) -> str:
    """numpy's kind letter (``"b"``, ``"i"``, ``"u"``, ``"f"``)."""
    kind = _KINDS.get(dtype)
    if kind is None:
        dt = as_numpy_dtype(dtype)
        kind = _KINDS[dtype] = "f" if dt is None else dt.kind
    return kind


def dtype_name(dtype) -> str:
    dt = as_numpy_dtype(dtype)
    return "bfloat16" if dt is None else dt.name


def dtype_range(dtype) -> Tuple[Any, Any]:
    """Representable [lo, hi] for a dtype (inf for floats' finite range)."""
    dt = as_numpy_dtype(dtype)
    if dt is None:
        return -_BF16_MAX, _BF16_MAX
    if dt.kind in "iu":
        info = np.iinfo(dt)
        return int(info.min), int(info.max)
    if dt.kind == "b":
        return 0, 1
    if dt.kind == "f":
        info = np.finfo(dt)
        return float(info.min), float(info.max)
    raise ValueError(f"unsupported dtype for interval analysis: {dt!r}")


def float_mantissa_bits(dtype) -> int:
    dt = as_numpy_dtype(dtype)
    return _BF16_NMANT if dt is None else int(np.finfo(dt).nmant)


def is_int_dtype(dtype) -> bool:
    return dtype_kind(dtype) in "iu"


def is_bool_dtype(dtype) -> bool:
    return dtype_kind(dtype) == "b"


def is_float_dtype(dtype) -> bool:
    return dtype_kind(dtype) == "f"


@dataclasses.dataclass(frozen=True)
class Interval:
    """Closed interval [lo, hi] over exact Python numbers.

    ``lo``/``hi`` are ints when the producing dtype is integral (exact,
    unbounded) and floats otherwise; ±inf endpoints mean "unbounded".
    An empty interval is represented by lo > hi and normally only
    appears transiently (e.g. a branch proven dead); joins treat it as
    bottom.
    """

    lo: Any
    hi: Any

    @staticmethod
    def bottom() -> "Interval":
        return Interval(POS_INF, NEG_INF)

    @staticmethod
    def point(v) -> "Interval":
        return Interval(v, v)

    @property
    def is_bottom(self) -> bool:
        return self.lo > self.hi

    @property
    def is_point(self) -> bool:
        return self.lo == self.hi

    def join(self, other: "Interval") -> "Interval":
        if self.is_bottom:
            return other
        if other.is_bottom:
            return self
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))

    def meet(self, other: "Interval") -> "Interval":
        return Interval(max(self.lo, other.lo), min(self.hi, other.hi))

    def contains(self, v) -> bool:
        return (not self.is_bottom) and self.lo <= v <= self.hi

    def covers(self, other: "Interval") -> bool:
        if other.is_bottom:
            return True
        if self.is_bottom:
            return False
        return self.lo <= other.lo and self.hi >= other.hi

    def shift(self, k) -> "Interval":
        if self.is_bottom:
            return self
        return Interval(self.lo + k, self.hi + k)

    def __repr__(self) -> str:  # compact in findings
        if self.is_bottom:
            return "[⊥]"

        def f(v):
            if v == POS_INF:
                return "+inf"
            if v == NEG_INF:
                return "-inf"
            if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
                return str(int(v))
            return str(v)

        return f"[{f(self.lo)}, {f(self.hi)}]"


# Arithmetic on intervals.  All helpers are total: ±inf endpoints are
# legal, and 0 * inf is resolved to 0 (the convention that keeps
# multiplication monotone for our use: a zero factor bounds the product
# at zero no matter how wild the other side is).


def _mul(a, b):
    if (a == 0 or b == 0) and (
        a in (POS_INF, NEG_INF) or b in (POS_INF, NEG_INF)
    ):
        return 0
    return a * b


def iv_add(a: Interval, b: Interval) -> Interval:
    if a.is_bottom or b.is_bottom:
        return Interval.bottom()
    return Interval(a.lo + b.lo, a.hi + b.hi)


def iv_sub(a: Interval, b: Interval) -> Interval:
    if a.is_bottom or b.is_bottom:
        return Interval.bottom()
    return Interval(a.lo - b.hi, a.hi - b.lo)


def iv_neg(a: Interval) -> Interval:
    if a.is_bottom:
        return a
    return Interval(-a.hi, -a.lo)


def iv_mul(a: Interval, b: Interval) -> Interval:
    if a.is_bottom or b.is_bottom:
        return Interval.bottom()
    cands = [_mul(a.lo, b.lo), _mul(a.lo, b.hi), _mul(a.hi, b.lo), _mul(a.hi, b.hi)]
    return Interval(min(cands), max(cands))


def iv_min(a: Interval, b: Interval) -> Interval:
    if a.is_bottom or b.is_bottom:
        return Interval.bottom()
    return Interval(min(a.lo, b.lo), min(a.hi, b.hi))


def iv_max(a: Interval, b: Interval) -> Interval:
    if a.is_bottom or b.is_bottom:
        return Interval.bottom()
    return Interval(max(a.lo, b.lo), max(a.hi, b.hi))


def iv_abs(a: Interval) -> Interval:
    if a.is_bottom:
        return a
    if a.lo >= 0:
        return a
    if a.hi <= 0:
        return iv_neg(a)
    return Interval(0, max(-a.lo, a.hi))


def iv_div_int(a: Interval, b: Interval) -> Interval:
    """Integer (truncating) division; conservative when b spans 0."""
    if a.is_bottom or b.is_bottom:
        return Interval.bottom()
    if b.lo <= 0 <= b.hi:
        # A divisor interval containing 0: the quotient magnitude is
        # bounded by |a| (|b| >= 1 on the int lattice away from 0), so
        # fall back to the symmetric hull of a.
        m = max(abs(a.lo), abs(a.hi))
        return Interval(-m, m)
    cands = []
    for x in (a.lo, a.hi):
        for y in (b.lo, b.hi):
            if x in (POS_INF, NEG_INF) or y in (POS_INF, NEG_INF):
                cands.append(0 if x == 0 else (POS_INF if (x > 0) == (y > 0) else NEG_INF))
            else:
                cands.append(int(math.trunc(x / y)) if y != 0 else 0)
    return Interval(min(cands), max(cands))


def iv_div_float(a: Interval, b: Interval) -> Interval:
    if a.is_bottom or b.is_bottom:
        return Interval.bottom()
    if b.lo <= 0 <= b.hi:
        return Interval(NEG_INF, POS_INF)
    cands = []
    for x in (a.lo, a.hi):
        for y in (b.lo, b.hi):
            try:
                cands.append(x / y)
            except (ZeroDivisionError, OverflowError):
                return Interval(NEG_INF, POS_INF)
    return Interval(min(cands), max(cands))


def iv_rem(a: Interval, b: Interval) -> Interval:
    """lax.rem: sign follows the dividend (C semantics)."""
    if a.is_bottom or b.is_bottom:
        return Interval.bottom()
    m = max(abs(b.lo), abs(b.hi))
    if m in (POS_INF,):
        hi = a.hi if a.hi > 0 else 0
        lo = a.lo if a.lo < 0 else 0
        return Interval(lo, hi)
    m = int(m) if not isinstance(m, float) or m == int(m) else m
    bound = m - 1 if m >= 1 else 0
    lo = -bound if a.lo < 0 else 0
    hi = bound if a.hi > 0 else 0
    # |a % b| <= |a| as well
    lo = max(lo, a.lo if a.lo > NEG_INF else lo)
    hi = min(hi, a.hi if a.hi < POS_INF else hi)
    if lo > hi:
        lo, hi = min(0, lo), max(0, hi)
    return Interval(lo, hi)


@dataclasses.dataclass(frozen=True)
class AbsVal:
    """Abstract value: shape/dtype (exact, from the aval) + interval.

    ``integral`` tracks "every element is integer-valued", which stays
    meaningful for float dtypes (the f32 tally exactness argument).
    For int/bool dtypes it is True by construction.
    """

    shape: Tuple[int, ...]
    dtype: Any
    iv: Interval
    integral: bool = True

    @staticmethod
    def from_aval(aval, iv: Optional[Interval] = None, integral: Optional[bool] = None) -> "AbsVal":
        """From anything with ``shape`` and ``dtype`` (a fake tensor, an
        array); the dtype is kept as given (numpy or torch)."""
        dt = aval.dtype
        if iv is None:
            lo, hi = dtype_range(dt)
            iv = Interval(lo, hi)
        if integral is None:
            integral = dtype_kind(dt) in "iub"
        return AbsVal(tuple(aval.shape), dt, iv, bool(integral))

    @staticmethod
    def from_literal(val) -> "AbsVal":
        arr = np.asarray(val)
        if arr.size == 0:
            return AbsVal(tuple(arr.shape), arr.dtype, Interval.bottom(), True)
        lo = arr.min()
        hi = arr.max()
        if arr.dtype.kind in "iub":
            lo, hi = int(lo), int(hi)
            integral = True
        else:
            lo, hi = float(lo), float(hi)
            integral = bool(np.all(arr == np.trunc(arr)))
        return AbsVal(tuple(arr.shape), arr.dtype, Interval(lo, hi), integral)

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def with_iv(self, iv: Interval, integral: Optional[bool] = None) -> "AbsVal":
        return AbsVal(self.shape, self.dtype, iv,
                      self.integral if integral is None else bool(integral))

    def top_like(self) -> "AbsVal":
        lo, hi = dtype_range(self.dtype)
        return AbsVal(self.shape, self.dtype, Interval(lo, hi),
                      dtype_kind(self.dtype) in "iub")

    def join(self, other: "AbsVal") -> "AbsVal":
        assert self.shape == other.shape and self.dtype == other.dtype, (
            f"join across shapes/dtypes: {self} vs {other}")
        return AbsVal(self.shape, self.dtype, self.iv.join(other.iv),
                      self.integral and other.integral)

    def covers(self, other: "AbsVal") -> bool:
        # self ⊒ other: the interval must contain other's, and if self
        # still claims integrality (the stronger fact) other must too.
        return self.iv.covers(other.iv) and (not self.integral or other.integral)

    def clamp_to_dtype(self) -> "AbsVal":
        lo, hi = dtype_range(self.dtype)
        return self.with_iv(self.iv.meet(Interval(lo, hi)))

    def __repr__(self) -> str:
        integ = "i" if self.integral and dtype_kind(self.dtype) == "f" else ""
        return f"{dtype_name(self.dtype)}{list(self.shape)}{integ}{self.iv}"


def join_or(a: Optional[AbsVal], b: AbsVal) -> AbsVal:
    return b if a is None else a.join(b)
