"""Stage-call auditor: host syncs, steady kernel builds and signature drift
(the port's counterpart of the reference's ``tpu_swirld/analysis/
jit_audit.py``).

The port has no jit.  Its counterpart of a jitted body is a **stage
function**: a function that the kernel modules dispatch through
``obs.stage_call`` / ``stage_call_fused`` (by way of
:class:`~tpu_swirld_torch.device.StageClock`).  The drivers' throughput
rests on three facts at that boundary: a stage body does not wait for the
card, the steady loop builds and loads no kernel library, and every stage
is called with a stable abstract signature (one shape at two dtypes or
devices is a second code path in every kernel the stage reaches).  This
module audits all three:

- :func:`static_audit`: an AST pass over the kernel modules flagging
  host-sync calls *inside stage bodies*: ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``to_host(...)``, ``torch.cuda.synchronize``,
  ``np.asarray`` / ``np.array`` and ``int`` / ``float`` / ``bool(...)``.
  A stage body is the module-level ``def`` whose name a kernel module
  passes as the function argument of a stage call; pulls *between* stage
  calls are not inside a body and are not findings.
- :func:`rounds_loop_pulls`: the host pulls of the drivers' loops around
  the rounds stages (``_columns_pass``, ``_rounds_span_fixpoint``,
  ``_rounds_chunk_loop``).  Each call writes one check buffer
  (``kernels.new_check``), and each loop must pull only that, once a call
  (``pipeline.scan_check``); the table and the rounds are pulled only by
  ``pipeline.table_check``, the fallback for a call whose check list
  overflowed.
- :func:`runtime_audit`: drives a windowed driver (``engine``:
  :class:`~tpu_swirld_torch.gpu.incremental.IncrementalConsensus`,
  :class:`~tpu_swirld_torch.store.streaming.StreamingConsensus`, or
  :class:`~tpu_swirld_torch.parallel.MeshStreamingConsensus` over
  ``make_mesh`` on one device) over a generated gossip DAG with a
  signature observer installed through ``obs.set_stage_observer``, then
  reports the steady window's kernel builds (:func:`tpu_swirld_torch.obs.
  compile_counts`: a library built or loaded during a stage) and drift:
  a stage called at one shape key with differing dtypes or devices.

CLI: ``python -m tpu_swirld_torch.analysis jit-audit`` (exit 1 on any host
sync, steady build or drift; ``--device cpu`` on a host without a GPU).
"""

from __future__ import annotations

import ast
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: kernel modules the static pass covers (relative to the repo root)
_KERNEL_MODULES = (
    "tpu_swirld_torch/gpu/pipeline.py",
    "tpu_swirld_torch/gpu/incremental.py",
    "tpu_swirld_torch/gpu/kernels.py",
    "tpu_swirld_torch/parallel.py",
    "tpu_swirld_torch/store/streaming.py",
)

#: stage-call wrappers -> position of the stage function argument
_STAGE_CALLS = {"stage_call": 1, "stage_call_fused": 2}
#: attribute calls that synchronize device -> host
_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy"}
#: ``mod.fn`` calls that synchronize (or silently pull) device values
_SYNC_MODULE_FNS = {
    ("np", "asarray"), ("np", "array"),
    ("numpy", "asarray"), ("numpy", "array"),
}


def _stage_fn_name(call: ast.Call) -> Optional[str]:
    """The name of the stage function a stage call dispatches, if it is a
    plain name (a seam held in an attribute or a parameter is not
    resolved)."""
    fn = call.func
    name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", None)
    pos = _STAGE_CALLS.get(name)
    if pos is None or len(call.args) <= pos:
        return None
    arg = call.args[pos]
    return arg.id if isinstance(arg, ast.Name) else None


def _sync_message(node: ast.Call, stage: str) -> Optional[str]:
    c = node.func
    if isinstance(c, ast.Attribute) and c.attr in _SYNC_ATTRS:
        return f".{c.attr}() inside stage {stage}()"
    if (
        isinstance(c, ast.Attribute)
        and isinstance(c.value, ast.Name)
        and (c.value.id, c.attr) in _SYNC_MODULE_FNS
    ):
        return (
            f"{c.value.id}.{c.attr}(...) inside stage {stage}() pulls the "
            "tensor to the host"
        )
    if (
        isinstance(c, ast.Attribute)
        and c.attr == "synchronize"
        and isinstance(c.value, ast.Attribute)
        and c.value.attr == "cuda"
    ):
        return f"torch.cuda.synchronize() inside stage {stage}()"
    if isinstance(c, ast.Name) and c.id == "to_host" and node.args:
        return f"to_host(...) inside stage {stage}() pulls the tensor to the host"
    if isinstance(c, ast.Name) and c.id in ("float", "int", "bool") and node.args:
        return (
            f"{c.id}(...) on a value inside stage {stage}() forces a host "
            "sync"
        )
    return None


def static_audit(root: str = ".") -> List[Dict]:
    """Host-sync calls inside stage bodies in the kernel modules.  Returns
    ``[]`` on a clean tree; each finding is ``{path, line, stage,
    message}``."""
    trees = {}
    for rel in _KERNEL_MODULES:
        path = os.path.join(root, rel)
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as f:
                trees[rel] = ast.parse(f.read(), filename=path)
    staged = set()
    for tree in trees.values():
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                name = _stage_fn_name(node)
                if name is not None:
                    staged.add(name)
    findings: List[Dict] = []
    for rel, tree in trees.items():
        for fn in tree.body:
            if not isinstance(fn, ast.FunctionDef) or fn.name not in staged:
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    msg = _sync_message(node, fn.name)
                    if msg:
                        findings.append({
                            "path": rel, "line": node.lineno,
                            "stage": fn.name, "message": msg,
                        })
    return findings


# ------------------------------------------------------- rounds loop pulls

#: the drivers' loops around the rounds stages: (module, function)
_ROUNDS_LOOPS = (
    ("tpu_swirld_torch/gpu/pipeline.py", "_columns_pass"),
    ("tpu_swirld_torch/gpu/incremental.py", "_rounds_span_fixpoint"),
    ("tpu_swirld_torch/gpu/incremental.py", "_rounds_chunk_loop"),
)
_ROUNDS_STAGES = {"pipeline.rounds_chunk_stage", "pipeline.rounds_span_stage"}
#: the function that reads the table and the rounds when a check list
#: overflowed
_CHECK_FALLBACK = "table_check"


def _defs(trees) -> Dict[str, ast.FunctionDef]:
    """Every module-level function and class method of the kernel modules,
    by name."""
    out: Dict[str, ast.FunctionDef] = {}
    for tree in trees.values():
        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                out.setdefault(node.name, node)
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, ast.FunctionDef):
                        out.setdefault(item.name, item)
    return out


def _dispatches_rounds(loop: ast.AST) -> bool:
    for node in ast.walk(loop):
        if (isinstance(node, ast.Call) and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value in _ROUNDS_STAGES):
            return True
    return False


def _pulls(body: List[ast.AST], defs, seen, fallback: bool, out) -> None:
    """``to_host`` arguments in ``body`` and in the kernel-module functions
    it calls (by name, each once), into ``out["per_call"]`` or, under
    :data:`_CHECK_FALLBACK`, ``out["fallback"]``."""
    for stmt in body:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", None)
            if name == "to_host" and node.args:
                out["fallback" if fallback else "per_call"].append(ast.unparse(node.args[0]))
            elif name in defs and name not in seen:
                seen.add(name)
                _pulls(defs[name].body, defs, seen, fallback or name == _CHECK_FALLBACK, out)


def rounds_loop_pulls(root: str = ".") -> Dict[str, Dict[str, List[str]]]:
    """For each loop function of :data:`_ROUNDS_LOOPS`, the host pulls made
    in its innermost loop that dispatches a rounds stage (``{"per_call":
    [...], "fallback": [...]}``, each pull its argument's source)."""
    trees = {}
    for rel in _KERNEL_MODULES:
        path = os.path.join(root, rel)
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as f:
                trees[rel] = ast.parse(f.read(), filename=path)
    defs = _defs(trees)
    report: Dict[str, Dict[str, List[str]]] = {}
    for _rel, fname in _ROUNDS_LOOPS:
        if fname not in defs:
            continue
        loops = [node for node in ast.walk(defs[fname])
                 if isinstance(node, (ast.For, ast.While)) and _dispatches_rounds(node)]
        inner = [lp for lp in loops
                 if not any(o is not lp and _dispatches_rounds(o)
                            for child in lp.body for o in ast.walk(child)
                            if isinstance(o, (ast.For, ast.While)))]
        out: Dict[str, List[str]] = {"per_call": [], "fallback": []}
        for lp in inner:
            _pulls(lp.body, defs, {fname}, False, out)
        report[fname] = out
    return report


# ------------------------------------------------------------ signatures


def _abstract(v) -> Tuple:
    """Hashable abstract value of one stage argument: a tensor becomes
    ``("arr", shape, dtype, device type)``, anything else its static
    repr."""
    import torch

    if isinstance(v, torch.Tensor):
        return ("arr", tuple(v.shape), str(v.dtype), v.device.type)
    return ("static", repr(v))


def _signature(args, kw) -> Tuple[Tuple, ...]:
    sig = tuple(_abstract(a) for a in args)
    if kw:
        sig += tuple(
            (k, _abstract(v)) for k, v in sorted(kw.items())
        )
    return sig


def _shape_key(sig: Tuple[Tuple, ...]) -> Tuple:
    """Signature with dtype and device erased: two signatures sharing a
    shape key but differing overall are drift."""
    out = []
    for part in sig:
        if part and part[0] == "arr":
            out.append(("arr", part[1]))
        else:
            out.append(part)
    return tuple(out)


def _find_drift(records: Dict[str, List[Tuple]]) -> List[Dict]:
    """Stages called with identical shapes and statics but differing
    dtype or device: each such cluster is a second code path."""
    drift: List[Dict] = []
    for stage, sigs in sorted(records.items()):
        by_shape: Dict[Tuple, set] = {}
        for sig in sigs:
            by_shape.setdefault(_shape_key(sig), set()).add(sig)
        for _key, variants in sorted(by_shape.items()):
            if len(variants) > 1:
                drift.append({
                    "stage": stage,
                    "variants": sorted(str(v) for v in variants),
                })
    return drift


def runtime_audit(
    *,
    n_members: int = 8,
    n_events: int = 1200,
    seed: int = 5,
    chunk: int = 128,
    window_bucket: int = 512,
    prune_min: int = 128,
    engine: str = "incremental",
    device="cuda",
) -> Dict[str, Any]:
    """Drive a windowed-consensus run with the stage observer installed;
    report the steady window's kernel builds and signature drift.

    ``engine`` picks the driver under audit: ``"incremental"``,
    ``"streaming"`` (the slab store's retire/fetch stages join the
    observed set) or ``"mesh"`` (``MeshStreamingConsensus`` over
    ``make_mesh(8)`` on ``device``: 8 row shards on one device).

    Warm-up covers the first two thirds of the chunks (capacities and
    kernel libraries settle there); the audit window is the remainder
    under a fresh ``Obs``, so ``compile_counts`` isolates steady builds.
    ``steady_seconds`` is the window's wall time."""
    import functools

    from tpu_swirld_torch import obs as obslib
    from tpu_swirld_torch.config import SwirldConfig
    from tpu_swirld_torch.device import resolve_device
    from tpu_swirld_torch.gpu.incremental import IncrementalConsensus
    from tpu_swirld_torch.sim import generate_gossip_dag

    if engine == "streaming":
        from tpu_swirld_torch.store.streaming import (
            StreamingConsensus as _Driver,
        )
    elif engine == "mesh":
        from tpu_swirld_torch.parallel import MeshStreamingConsensus, make_mesh

        _Driver = functools.partial(
            MeshStreamingConsensus, make_mesh(8, device)
        )
    elif engine == "incremental":
        _Driver = IncrementalConsensus
    else:
        raise ValueError(f"unknown engine {engine!r}")
    dev = resolve_device(device)

    members, stake, events, _keys = generate_gossip_dag(
        n_members, n_events, seed=seed
    )
    cfg = SwirldConfig(n_members=n_members)
    inc = _Driver(
        members, stake, cfg, chunk=chunk,
        window_bucket=window_bucket, prune_min=prune_min, device=dev,
    )
    chunks = [events[i : i + 250] for i in range(0, len(events), 250)]
    warmup = (2 * len(chunks)) // 3
    for c in chunks[:warmup]:
        inc.ingest(c)

    records: Dict[str, List[Tuple]] = {}

    def observer(name, fn, args, kw):
        records.setdefault(name, []).append(_signature(args, kw))

    o = obslib.Obs()
    obslib.set_stage_observer(observer)
    t0 = time.perf_counter()
    try:
        with obslib.enabled(o):
            for c in chunks[warmup:]:
                inc.ingest(c)
    finally:
        obslib.set_stage_observer(None)
    steady_seconds = time.perf_counter() - t0
    store = getattr(inc, "store", None)
    if store is not None:
        store.close()

    steady = obslib.compile_counts(o.registry)
    drift = _find_drift(records)
    # the fused rounds span feeds the same observer seam as stage_call, so
    # with fuse_chunks > 1 (the resolved default) the verdict covers the
    # K-chunk scan path; a run that fell back to per-chunk dispatch shows
    fused_audited = "pipeline.rounds_span_stage" in records
    return {
        "engine": engine,
        "device": dev.type,
        "stages_observed": sorted(records),
        "steady_calls": {k: len(v) for k, v in sorted(records.items())},
        "steady_compiles": steady,
        "signature_drift": drift,
        "fused_span_audited": fused_audited,
        "fuse_chunks": inc._fuse,
        "steady_seconds": steady_seconds,
        "ok": not steady and not drift,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="python -m tpu_swirld_torch.analysis jit-audit",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--root", default=".", help="repo root for the static pass")
    ap.add_argument("--static-only", action="store_true")
    ap.add_argument("--members", type=int, default=8)
    ap.add_argument("--events", type=int, default=1200)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument(
        "--engine", choices=("incremental", "streaming", "mesh"),
        default="incremental",
        help="windowed driver for the runtime pass: incremental "
        "(default), streaming (slab store), or mesh (row-sharded "
        "MeshStreamingConsensus, 8 shards on one device)",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="torch device of the runtime pass (default cuda, which fails "
        "without a GPU)",
    )
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    report: Dict[str, Any] = {"static": static_audit(args.root),
                              "rounds_pulls": rounds_loop_pulls(args.root)}
    ok = not report["static"] and all(
        len(p["per_call"]) == 1 for p in report["rounds_pulls"].values())
    if not args.static_only:
        rt = runtime_audit(
            n_members=args.members, n_events=args.events, seed=args.seed,
            engine=args.engine, device=args.device,
        )
        report["runtime"] = rt
        ok = ok and rt["ok"]
    report["ok"] = ok
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        for f in report["static"]:
            print(f"{f['path']}:{f['line']}: {f['message']}")
        for fname, p in report["rounds_pulls"].items():
            print(f"rounds loop {fname}: pulls a call {p['per_call']}, "
                  f"on a full check list {p['fallback']}")
        if "runtime" in report:
            rt = report["runtime"]
            print(f"stages observed: {len(rt['stages_observed'])}")
            print(f"fused span audited: {rt['fused_span_audited']} "
                  f"(fuse_chunks={rt['fuse_chunks']})")
            print(f"steady kernel builds: {rt['steady_compiles'] or 'none'}")
            for d in rt["signature_drift"]:
                print(f"drift in {d['stage']}: {d['variants']}")
        print("OK" if ok else "FAIL")
    return 0 if ok else 1
