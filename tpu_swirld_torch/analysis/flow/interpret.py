"""The stage-body interpreter over the interval×dtype lattice (the port's
counterpart of the reference's jaxpr interpreter,
``tpu_swirld/analysis/flow/interpret.py``).

The port has no jaxpr: its counterpart of a jitted body is a *stage
function*, run here as it is, on ``FakeTensor``s at the envelope's
shapes (they allocate nothing, so a 2**20 x 2**20 slab costs nothing).
A ``TorchDispatchMode`` stacked on the ``FakeTensorMode`` sees every
aten op the body dispatches and propagates an :class:`AbsVal` through
it by :mod:`.transfer`, which hard-fails on an op it does not model.

The abstract state is **one interval per tensor storage**: a view shares
its base's interval, and every write through a view (``tab.view(-1).
index_put_``, ``rnd[i : i + 1] = r``, ``overflow |= ...``) widens its
base's (a weak update: the join of the old and the written values).

Host control flow runs as Python runs it:

- **Host loops** (``for ... in range``): the modules under audit see a
  ``range`` of this module's while an interpretation runs.  Up to
  ``UNROLL_LIMIT`` iterations run exactly.  A longer loop is summarized,
  as the reference summarizes a long ``scan``: its body runs at a few
  representative indices (the first two, the last two and two between,
  and where two of them take different host paths — the rounds step's
  genesis and padding tests — the two sides of the boundary, found by
  bisection, so every path shows at its extreme indices) pass after pass,
  each op
  site's outputs joined over the passes (so a value that depends on the
  loop index covers every index between), until no site and no storage
  moves (join to a fixpoint).  Storages that keep growing get
  **length-aware extrapolation**: per-iteration growth ``g`` is measured,
  the candidate ``entry + (L-1)·g`` is installed and probed, and accepted
  only if the body grows no faster there (a translation-style step: a
  round grows by at most one a step, over at most ``events`` steps, is
  the whole int32 argument).  A candidate past its dtype is the overflow
  proof (SW008 at the loop).  A loop that still moves raises
  :class:`LoopSummaryError`.  Exploration passes run quiet; one loud
  pass over the converged state reports.
- **Host pulls** (``to_host``): a fake tensor has no value, so a pull
  returns the value its stage spec declares (:class:`PullDecl`), and the
  report lists every pull site with the value assumed.  A pull no spec declares, or a
  ``.item()`` / ``int(tensor)`` (``aten._local_scalar_dense``) anywhere,
  raises :class:`UndeclaredPullError` (exit 2, as an unknown op).

A finding points at the innermost frame under ``tpu_swirld_torch/`` that
is not ``analysis/`` (else the innermost frame outside PyTorch and this
interpreter: a seeded mutation in ``audit.py``, a test's micro-trace).
Findings are deduplicated by (rule, site, op).
"""

from __future__ import annotations

import builtins
import contextlib
import dataclasses
import linecache
import os
import re
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

from tpu_swirld_torch.analysis.lint import Finding
from tpu_swirld_torch.analysis.flow.lattice import AbsVal, Interval, dtype_range, is_int_dtype
from tpu_swirld_torch.analysis.flow import transfer as T
from tpu_swirld_torch.analysis.flow.transfer import UnknownPrimitiveError

UNROLL_LIMIT = 64
FIXPOINT_PASSES = 4
SETTLE_PASSES = 4

RULE_NAMES = {
    "SW008": "overflow-reachable",
    "SW009": "unproven-bounds",
    "SW010": "lossy-narrowing",
    "SW011": "sentinel-collision",
}

#: ops that read metadata only (no tensor value flows)
_META = frozenset({
    "prim.device.default", "aten.sym_size.int", "aten.sym_stride.int",
    "aten.sym_numel.default", "aten.sym_storage_offset.default",
    "aten.is_same_size.default", "aten.dim.default",
    "aten.is_contiguous.default", "aten.is_contiguous.memory_format",
})
#: ops whose result is a device value the host reads (or a shape that
#: depends on one): pulls, never silently modelled
_PULL_OPS = frozenset({
    "aten._local_scalar_dense.default", "aten.nonzero.default",
    "aten.is_nonzero.default", "aten.equal.default", "aten.item.default",
    "aten.masked_select.default", "aten._unique2.default",
    "aten.unique_dim.default", "aten.unique_consecutive.default",
})

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)
_HERE = os.path.dirname(os.path.abspath(__file__))
_SKIP_FILES = frozenset(
    os.path.join(_HERE, f) for f in ("interpret.py", "transfer.py", "lattice.py")
)
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
_STDLIB_DIR = os.path.dirname(os.path.abspath(os.__file__))


class UndeclaredPullError(Exception):
    """A stage body read a device value on the host at a site no stage
    spec declares (exit 2 at the CLI, as an unknown op)."""

    def __init__(self, site: str, stage: str = "?"):
        self.site = site
        self.stage = stage
        super().__init__(
            f"undeclared host pull at {site} (stage {stage}): a fake tensor "
            f"has no value, and the interpreter refuses to pick a branch "
            f"silently — declare the value in the stage spec's pulls"
        )


class LoopSummaryError(Exception):
    """A summarized host loop did not settle after extrapolation."""


@dataclasses.dataclass(frozen=True)
class PullDecl:
    """The value a stage body's host pull returns under the audit.
    ``value(tensor, dims)`` builds it from the pulled fake tensor (its
    shape) and the spec's dimensions."""

    site: str                    # "gpu/kernels.py:order_scan_reference:go"
    note: str                    # why this value (shown in the report)
    value: Callable


@dataclasses.dataclass
class FlowResult:
    outs: List[AbsVal]
    findings: List[Finding]
    exercised: set
    pulls: Dict[str, str]        # site -> the value assumed


# --------------------------------------------------------------- frames


def _rel(path: str) -> str:
    p = os.path.abspath(path)
    if p.startswith(_REPO_ROOT + os.sep):
        return os.path.relpath(p, _REPO_ROOT).replace(os.sep, "/")
    return p


def _user_frames(frame):
    """Frames outside PyTorch, the standard library and this
    interpreter, innermost first."""
    f = frame
    while f is not None:
        fn = f.f_code.co_filename
        if (
            fn not in _SKIP_FILES
            and not fn.startswith(_TORCH_DIR)
            and not fn.startswith(_STDLIB_DIR)
            and not fn.startswith("<")
        ):
            yield f
        f = f.f_back


def _best_frame(frame):
    fallback = None
    for f in _user_frames(frame):
        posix = f.f_code.co_filename.replace(os.sep, "/")
        if "/tpu_swirld_torch/" in posix and "/tpu_swirld_torch/analysis/" not in posix:
            return f
        if fallback is None:
            fallback = f
    return fallback


# ------------------------------------------------------------ the state


class _Rec:
    """One storage's abstract value."""

    __slots__ = ("iv", "integral", "serial", "dtype")

    def __init__(self, iv, integral, serial, dtype):
        self.iv = iv
        self.integral = integral
        self.serial = serial
        self.dtype = dtype


class _Level:
    """Bookkeeping of one summarized loop in progress: the values storages
    held before their first write in the loop, the pass and the current
    body run, and whether a site moved in the pass."""

    def __init__(self, serial):
        self.serial = serial
        self.loop: Dict[int, Tuple[Interval, bool]] = {}
        self.pass_j: Dict[int, Tuple[Interval, bool]] = {}
        self.rep: Dict[int, Tuple[Interval, bool]] = {}
        self.site_moved = False

    def note(self, key, rec):
        old = (rec.iv, rec.integral)
        self.loop.setdefault(key, old)
        self.pass_j.setdefault(key, old)
        self.rep.setdefault(key, old)

    def begin_pass(self):
        self.pass_j = {}
        self.site_moved = False


def _reps(r) -> List[int]:
    """Representative indices of a summarized range: the first two, the
    last two and two between."""
    n = len(r)
    picks = {0, 1, n // 3, (2 * n) // 3, n - 2, n - 1}
    return [r[j] for j in sorted(p for p in picks if 0 <= p < n)]


_ACTIVE: Optional["_Interp"] = None
_FOR_BLANK = re.compile(r"^\s*for\s+_\s+in\s+range\(")


class _SummaryRange:
    """``range`` as the audited modules see it during an interpretation:
    a plain range, except that iterating more than ``UNROLL_LIMIT``
    indices inside a stage body runs the loop summary."""

    __slots__ = ("r",)

    def __init__(self, *args):
        self.r = builtins.range(*args)

    def __iter__(self):
        st = _ACTIVE
        if st is None:
            return iter(self.r)
        frame = sys._getframe(1)
        if len(self.r) > UNROLL_LIMIT:
            return st.summarize(self.r, frame)
        if _FOR_BLANK.match(linecache.getline(frame.f_code.co_filename, frame.f_lineno)):
            return st.unroll(self.r)
        return iter(self.r)

    def __len__(self):
        return len(self.r)

    def __getitem__(self, i):
        return self.r[i]

    def __contains__(self, v):
        return v in self.r

    def __reversed__(self):
        return reversed(self.r)

    def __repr__(self):
        return repr(self.r)


class _Mode(TorchDispatchMode):
    def __init__(self, interp: "_Interp"):
        super().__init__()
        self.interp = interp

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return self.interp.dispatch(func, args, kwargs or {})


class _Interp:
    """One interpretation: the storages' intervals, the findings, the loop
    summaries in progress, the pulls."""

    def __init__(self, stage, sentinels, pulls, dims, findings, exercised):
        self.stage = stage
        self.sentinels = tuple(sentinels)
        self.pulls = dict(pulls or {})
        self.dims = dict(dims or {})
        self.findings = findings if findings is not None else []
        self.exercised = exercised if exercised is not None else set()
        self.pulls_seen: Dict[str, str] = {}
        self.storages: Dict[int, _Rec] = {}
        self.keep: List[Any] = []
        self.producers: Dict[int, Tuple[Any, str, List[Any]]] = {}
        self.sites: Dict[Tuple, Tuple[Interval, bool]] = {}
        self.levels: List[_Level] = []
        self.serial = 0
        self.quiet = 0
        self._seen = set()
        self._raw: List[Any] = []
        self._op = ""
        self._out_j = 0
        self.traces: List[List[Any]] = []
        self._writes = 0

    # ------------------------------------------------------- storages

    @staticmethod
    def _key(t) -> int:
        return t.untyped_storage()._cdata

    def bind(self, t, iv: Interval, integral: bool = True) -> None:
        self.serial += 1
        self.storages[self._key(t)] = _Rec(iv, integral, self.serial, t.dtype)
        self.keep.append(t)

    def value_of(self, t) -> AbsVal:
        rec = self.storages.get(self._key(t))
        if rec is None:
            const = getattr(t, "constant", None)     # a fake's wrapped constant
            if isinstance(t, FakeTensor) and const is None:
                lo, hi = dtype_range(t.dtype)
                iv, integral = Interval(lo, hi), not t.dtype.is_floating_point
            else:       # a real constant: its own values
                iv, integral = _data_interval(t if const is None else const)
            self.bind(t, iv, integral)
            rec = self.storages[self._key(t)]
        return AbsVal(tuple(t.shape), t.dtype, rec.iv, rec.integral)

    def _write(self, t, iv, integral) -> None:
        """Weak update of ``t``'s storage (an in-place op, a write through
        a view)."""
        key = self._key(t)
        rec = self.storages.get(key)
        if rec is None:
            self.value_of(t)
            rec = self.storages[key]
        for lvl in self.levels:
            lvl.note(key, rec)
        new_iv = rec.iv.join(iv)
        new_integral = rec.integral and integral
        if new_iv != rec.iv or new_integral != rec.integral:
            self._writes += 1
        rec.iv = new_iv
        rec.integral = new_integral

    def _fresh(self, t, iv, integral) -> None:
        if self.levels:
            site = self._site_key()
            prev = self.sites.get(site)
            if prev is not None:
                j = prev[0].join(iv)
                ji = prev[1] and integral
                if j != prev[0] or ji != prev[1]:
                    for lvl in self.levels:
                        lvl.site_moved = True
                iv, integral = j, ji
            else:
                for lvl in self.levels:
                    lvl.site_moved = True
            self.sites[site] = (iv, integral)
        self.bind(t, iv, integral)

    def _site_key(self):
        return tuple(
            (f.f_code.co_filename, f.f_lineno)
            for f in _user_frames(sys._getframe(2))
        ) + (self._op, self._out_j)

    # ------------------------------------------------ transfer context

    def where(self) -> str:
        return "%s:%d" % self._loc()

    def _loc(self) -> Tuple[str, int]:
        f = _best_frame(sys._getframe(1))
        if f is None:
            return "<stage>", 0
        return _rel(f.f_code.co_filename), int(f.f_lineno)

    def report(self, rule, op, msg, *, loc=None, force=False):
        if self.quiet and not force:
            return
        path, line = loc or self._loc()
        key = (rule, path, line, op, msg.split(":")[0])
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(Finding(
            rule, RULE_NAMES.get(rule, rule), path, line, 0,
            f"[{self.stage}] {msg}",
        ))

    def raw_args(self):
        return self._raw

    def producer(self, t):
        if not isinstance(t, torch.Tensor):
            return None
        p = self.producers.get(id(t))
        if p is None or p[0] is not t:
            return None
        return p[1], p[2]

    @staticmethod
    def is_tensor(x) -> bool:
        return isinstance(x, torch.Tensor)

    def const_interval(self, x) -> Optional[Interval]:
        if isinstance(x, torch.Tensor):
            return self.value_of(x).iv
        if isinstance(x, (bool, int, float)):
            return T._iv(x)
        return None

    def peel(self, x):
        """Follow value-preserving conversions back to the tensor they
        copy."""
        for _ in range(8):
            p = self.producer(x)
            if p is None or p[0] not in (
                "aten._to_copy.default", "aten.clone.default",
                "aten.alias.default", "aten.lift_fresh.default",
            ):
                break
            src = p[1][0]
            if not isinstance(src, torch.Tensor) or not (
                is_int_dtype(src.dtype) or src.dtype == torch.bool
            ):
                break
            x = src
        return x

    def offset_of(self, arm, base) -> Optional[Interval]:
        """``arm`` as ``base + k``: the interval of ``k``, or None."""
        arm = self.peel(arm)
        if arm is base:
            return Interval.point(0)
        p = self.producer(arm)
        if p is None or p[0] not in (
            "aten.add.Tensor", "aten.add.Scalar", "aten.sub.Tensor",
            "aten.sub.Scalar",
        ):
            return None
        x, y = p[1][0], p[1][1]
        if self.peel(x) is base:
            k = self.const_interval(y)
            if k is None:
                return None
            return k if p[0].startswith("aten.add") else T.iv_neg(k)
        if p[0].startswith("aten.add") and self.peel(y) is base:
            return self.const_interval(x)
        return None

    # ---------------------------------------------------------- dispatch

    def dispatch(self, func, args, kwargs):
        name = str(func)
        if name in _META:
            return func(*args, **kwargs)
        if name in _PULL_OPS:
            raise UndeclaredPullError(f"{self.where()} ({name})", self.stage)
        if name not in T.TRANSFERS:
            raise UnknownPrimitiveError(name, self.stage, self.where())
        bound = _bind(func, args, kwargs)
        out = func(*args, **kwargs)
        outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,))
                if isinstance(o, torch.Tensor)]
        vals = [self._abs(a) for a in bound]
        if self.traces:
            self.traces[-1].append((name, _trace_key(vals)))
        self._raw = bound
        self._op = name
        res = T.apply_transfer(self, name, vals, outs)
        returns = func._schema.returns
        for j, (o, (iv, integral)) in enumerate(zip(outs, res)):
            alias = returns[j].alias_info if j < len(returns) else None
            if alias is not None and alias.is_write:
                self._write(o, iv, integral)
            elif alias is not None:
                continue        # a view: its base's storage already holds it
            else:
                self._out_j = j
                self._fresh(o, iv, integral)
                self.producers[id(o)] = (o, name, bound)
        return out

    def _abs(self, a):
        if isinstance(a, torch.Tensor):
            return self.value_of(a)
        if isinstance(a, (list, tuple)) and any(isinstance(x, torch.Tensor) for x in a):
            return [self.value_of(x) if isinstance(x, torch.Tensor) else x for x in a]
        return a

    # ------------------------------------------------------------- pulls

    def pull(self, site: str, x):
        decl = self.pulls.get(site)
        if decl is None:
            raise UndeclaredPullError(site, self.stage)
        v = decl.value(x, self.dims)
        arr = np.asarray(v)
        if arr.size:
            shown = f"{decl.note} ({arr.dtype.name}{list(arr.shape)} in [{arr.min()}, {arr.max()}])"
        else:
            shown = f"{decl.note} (empty)"
        self.pulls_seen[site] = shown
        return v

    def to_host(self, x, copy: bool = False):
        if not isinstance(x, torch.Tensor):
            return np.array(x, copy=True) if copy else np.asarray(x)
        f = sys._getframe(1)
        return self.pull(_pull_site(f), x)

    # ---------------------------------------------------- loop summaries

    def summarize(self, r, frame):
        L = len(r)
        reps = _reps(r)
        loc = (_rel(frame.f_code.co_filename), int(frame.f_lineno))
        lvl = _Level(self.serial)
        self.levels.append(lvl)
        self.quiet += 1
        frozen: Dict[int, Interval] = {}
        steps: Dict[int, Tuple[Any, Any]] = {}
        try:
            # path discovery: where two representative indices take
            # different host paths (the rounds step's genesis / non-genesis
            # / padding tests), bisect to the boundary and run both sides
            # too, so every path shows at its extreme indices
            sig = {}
            for i in reps:
                sig[i] = yield from self._traced(lvl, i)
            extra = []
            for a, b in zip(reps, reps[1:]):
                lo, hi = r.index(a), r.index(b)
                if sig[a] == sig[b]:
                    continue
                sa, sb = sig[a], sig[b]
                while hi - lo > 1:
                    mid = (lo + hi) // 2
                    sm = yield from self._traced(lvl, r[mid])
                    if sm == sa:
                        lo = mid
                    else:
                        hi, sb = mid, sm
                extra += [r[lo], r[hi]]
            reps = sorted(set(reps) | set(extra))
            growth: Dict[int, Tuple[Any, Any]] = {}
            converged = False
            for _ in range(FIXPOINT_PASSES):
                lvl.begin_pass()
                growth = {}
                for i in reps:
                    lvl.rep = {}
                    yield i
                    self._measure(lvl, growth)
                if not self._moved(lvl, ()):
                    converged = True
                    break
            if not converged:
                for key, (g_lo, g_hi) in growth.items():
                    rec = self.storages[key]
                    if (g_lo, g_hi) == (0, 0) or rec.serial > lvl.serial:
                        continue
                    ent = lvl.loop[key][0]
                    base = rec.iv if ent.is_bottom else ent
                    cand = Interval(base.lo + (L - 1) * g_lo,
                                    base.hi + (L - 1) * g_hi).join(rec.iv)
                    ok = True
                    dt = rec.dtype
                    if is_int_dtype(dt):
                        lo_d, hi_d = dtype_range(dt)
                        if cand.lo < lo_d or cand.hi > hi_d:
                            self.report(
                                "SW008", "loop",
                                f"loop: a storage grows ~[{g_lo}, {g_hi}] per "
                                f"iteration over {L} iterations, reaching {cand} "
                                f"— outside [{lo_d}, {hi_d}]",
                                loc=loc, force=True,
                            )
                            cand = cand.meet(Interval(lo_d, hi_d))
                            ok = False
                    rec.iv = cand
                    if ok:
                        frozen[key] = cand
                        steps[key] = (g_lo, g_hi)
                # probe: a translation-style step grows no faster at the
                # candidate; a faster one voids the extrapolation
                probe: Dict[int, Tuple[Any, Any]] = {}
                lvl.begin_pass()
                for i in reps:
                    lvl.rep = {}
                    yield i
                    self._measure(lvl, probe)
                for key in list(frozen):
                    g_lo, g_hi = growth[key]
                    p_lo, p_hi = probe.get(key, (0, 0))
                    if p_lo < 2 * g_lo or p_hi > 2 * g_hi:
                        rec = self.storages[key]
                        rec.iv = Interval(*dtype_range(rec.dtype))
                        del frozen[key]
                # settle the rest against the extrapolated storages, each
                # body run reading them at their candidate (an input no
                # real iteration exceeds)
                for _ in range(SETTLE_PASSES):
                    lvl.begin_pass()
                    for i in reps:
                        self._reset(frozen)
                        lvl.rep = {}
                        yield i
                    if not self._moved(lvl, frozen):
                        converged = True
                        break
                if not converged:
                    raise LoopSummaryError(
                        f"the host loop at {loc[0]}:{loc[1]} ({L} iterations) did "
                        f"not settle after extrapolation (stage {self.stage})"
                    )
        finally:
            self.quiet -= 1
        try:
            for i in reps:                  # the loud pass
                self._reset(frozen)
                lvl.rep = {}
                yield i
            # the loop's last iteration leaves an extrapolated storage at
            # most one step past its candidate
            for key, cand in frozen.items():
                g_lo, g_hi = steps[key]
                rec = self.storages[key]
                rec.iv = rec.iv.join(cand).join(
                    Interval(cand.lo + g_lo, cand.hi + g_hi))
        finally:
            self.levels.remove(lvl)

    def unroll(self, r):
        """An exact unroll of a loop whose index is not read (``for _ in
        range(k)``), stopped once an iteration gives every op the inputs
        the one before gave it and moves no storage: every later
        iteration would repeat it exactly."""
        prev = None
        for i in r:
            self.traces.append([])
            self._writes = 0
            try:
                yield i
            finally:
                trace = self.traces.pop()
            if trace == prev and self._writes == 0:
                return
            prev = trace

    def _traced(self, lvl, i):
        """One body run at ``i`` (a generator step of a summary); returns
        the op names it dispatched, its host path."""
        self.traces.append([])
        lvl.rep = {}
        try:
            yield i
        finally:
            trace = self.traces.pop()
        return tuple(name for name, _ in trace)

    def _reset(self, frozen) -> None:
        for key, cand in frozen.items():
            self.storages[key].iv = cand

    def _measure(self, lvl, growth) -> None:
        """Fold the last body run's growth of every storage it wrote into
        ``growth`` (per-run maxima)."""
        for key, (old, _integ) in lvl.rep.items():
            new = self.storages[key].iv
            if old.is_bottom or new.is_bottom:
                continue
            g_lo = min(0, new.lo - old.lo)
            g_hi = max(0, new.hi - old.hi)
            p_lo, p_hi = growth.get(key, (0, 0))
            growth[key] = (min(p_lo, g_lo), max(p_hi, g_hi))

    def _moved(self, lvl, frozen) -> bool:
        if lvl.site_moved:
            return True
        for key, (old, integ) in lvl.pass_j.items():
            if key in frozen:
                continue
            rec = self.storages[key]
            if rec.iv != old or rec.integral != integ:
                return True
        return False


def _trace_key(vals) -> Tuple:
    """What one op saw: its inputs' shapes, dtypes and intervals, its
    other arguments' values."""
    out = []
    for v in vals:
        if isinstance(v, AbsVal):
            out.append((v.shape, v.dtype, v.iv, v.integral))
        elif isinstance(v, list):
            out.append(tuple(
                (x.shape, x.dtype, x.iv, x.integral) if isinstance(x, AbsVal) else repr(x)
                for x in v))
        else:
            out.append(repr(v))
    return tuple(out)


def _data_interval(t) -> Tuple[Interval, bool]:
    """A real tensor's own value range (read with the modes off)."""
    if t.numel() == 0:
        return Interval.bottom(), True
    with _disable_current_modes():
        if t.dtype.is_floating_point:
            x = t.detach().double()
            integral = bool(torch.all(x == torch.trunc(x)))
            return Interval(float(x.min()), float(x.max())), integral
        x = t.detach().to(torch.int64)
        return Interval(int(x.min()), int(x.max())), True


_SCHEMAS: Dict[Any, Tuple] = {}


def _bind(func, args, kwargs) -> List[Any]:
    """The op's arguments in schema order (defaults filled in)."""
    schema = _SCHEMAS.get(func)
    if schema is None:
        schema = _SCHEMAS[func] = tuple(
            (a.name, a.default_value if a.has_default_value() else None)
            for a in func._schema.arguments
        )
    out = list(args[: len(schema)])
    for name, default in schema[len(out):]:
        out.append(kwargs.get(name, default))
    return out


_ASSIGN = re.compile(r"^\s*([A-Za-z_]\w*)\s*=\s*to_host\(")
_CALL = re.compile(r"to_host\((.*?)\)(?:\.|\)|,|\s|$)")


def _pull_site(frame) -> str:
    """``gpu/kernels.py:order_scan_reference:go``: the module (relative to the
    package), the function and the assigned name (else the pulled
    expression) of a ``to_host`` call."""
    fn = frame.f_code.co_filename
    rel = os.path.relpath(os.path.abspath(fn), _PKG_ROOT).replace(os.sep, "/")
    text = linecache.getline(fn, frame.f_lineno)
    m = _ASSIGN.match(text)
    what = m.group(1) if m else None
    if what is None:
        m = _CALL.search(text)
        what = m.group(1).strip() if m else "?"
    return f"{rel}:{frame.f_code.co_name}:{what}"


# ------------------------------------------------------------ patching


def _audited_modules():
    from tpu_swirld_torch import parallel
    from tpu_swirld_torch.gpu import incremental, kernels, pipeline
    from tpu_swirld_torch.membership import repack

    return (pipeline, incremental, kernels, parallel, repack)


@contextlib.contextmanager
def _patched(interp: _Interp):
    """Install the summary ``range`` and the pull seams in the modules
    under audit for one interpretation."""
    global _ACTIVE
    from tpu_swirld_torch.gpu import incremental, kernels, pipeline

    mods = _audited_modules()
    saved_host = {m: m.__dict__.get("to_host") for m in (pipeline, incremental, kernels)}
    _ACTIVE = interp
    try:
        for m in mods:
            m.range = _SummaryRange
        for m in saved_host:
            m.to_host = interp.to_host
        yield
    finally:
        _ACTIVE = None
        for m in mods:
            m.__dict__.pop("range", None)
        for m, fn in saved_host.items():
            m.to_host = fn


# ----------------------------------------------------------- arguments


@dataclasses.dataclass(frozen=True)
class ArgDecl:
    """One stage argument under audit: a tensor of this shape and dtype
    whose every element lies in ``[lo, hi]`` (``None``: the dtype's
    range)."""

    shape: Tuple[int, ...]
    dtype: Any
    lo: Optional[Any] = None
    hi: Optional[Any] = None

    @property
    def iv(self) -> Interval:
        if self.lo is None:
            return Interval(*dtype_range(self.dtype))
        return Interval(self.lo, self.hi)


def interpret_stage(
    fn,
    args: Sequence[Any] = (),
    kwargs: Optional[Dict[str, Any]] = None,
    *,
    stage: str = "<fn>",
    sentinels: Sequence[int] = (),
    pulls: Optional[Dict[str, PullDecl]] = None,
    dims: Optional[Dict[str, int]] = None,
    findings: Optional[List[Finding]] = None,
    exercised: Optional[set] = None,
) -> FlowResult:
    """Run ``fn(*args, **kwargs)`` abstractly.

    Each :class:`ArgDecl` in ``args`` / ``kwargs`` becomes a CPU fake
    tensor carrying its interval; anything else (host arrays, ints, kernel
    seams) is passed as it is.  Returns the abstract value of every tensor
    leaf of the result, the findings, the ops exercised and the pulls
    assumed."""
    interp = _Interp(stage, sentinels, pulls, dims, findings, exercised)
    fake = FakeTensorMode(allow_non_fake_inputs=True)

    def make(a):
        if not isinstance(a, ArgDecl):
            return a
        with fake:
            t = torch.empty(a.shape, dtype=a.dtype, device="cpu")
        iv = a.iv
        if a.dtype == torch.bool:
            iv = iv.meet(Interval(0, 1))
        interp.bind(t, iv, True)
        return t

    f_args = [make(a) for a in args]
    f_kwargs = {k: make(v) for k, v in (kwargs or {}).items()}
    with _patched(interp), fake, _Mode(interp):
        out = fn(*f_args, **f_kwargs)
    leaves = [x for x in pytree.tree_leaves(out) if isinstance(x, torch.Tensor)]
    outs = [interp.value_of(x) for x in leaves]
    return FlowResult(outs=outs, findings=interp.findings,
                      exercised=interp.exercised, pulls=interp.pulls_seen)
