"""The port's benchmark entry point (``python -m tpu_swirld_torch.bench``)
against the reference's ``bench.py``, both on the CPU at small sizes.

Each mode runs in both packages with the same ``BENCH_*`` knobs (a module
fixture): the reference's ``bench.py`` as subprocesses with
``BENCH_FORCE_CPU=1``, all at once; meanwhile the port's ``run_*`` with
``device="cpu"`` in this process, as ``--device cpu`` calls them, except
``--churn``, which runs through the port's CLI beside the reference's and
whose ``lint`` / ``mc`` / ``scale_audit`` stamps every port line then
carries (the stamps are of the tree, not of the mode).  The JSON lines must
carry the same keys (recursively, apart from the stamps' internals), true
parity flags and equal counts: what each driver decided, its window,
prune, passes, rebases, archive and tiles, the chaos-overhead fork pairs
and the churn epochs.  ``--stream --mesh 2`` is two gloo ranks of the port
against the reference's two simulated devices.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMPS = ("lint", "mc", "scale_audit")

_STREAM_ENV = {"BENCH_STREAM_MEMBERS": "16", "BENCH_STREAM_EVENTS": "3000",
               "BENCH_STREAM_CHUNK": "256", "BENCH_STREAM_ORACLE": "3000"}
_STREAM_ARGS = ["--stream", "--tile-budget", "2048", "--tile", "64"]
#: mode -> (flags, knobs, the port's run as its CLI calls it for these flags;
#: None: the port's CLI)
MODES = {
    "default": ([], {
        "BENCH_MEMBERS": "8", "BENCH_EVENTS": "600", "BENCH_ORACLE_EVENTS": "600",
        "BENCH_INC_CHUNK": "100", "BENCH_DEFAULT_STREAM_MEMBERS": "8",
        "BENCH_DEFAULT_STREAM_EVENTS": "600", "BENCH_DEFAULT_STREAM_CHUNK": "64"},
        lambda b: b.run_default("cpu", stamps={})),
    "stream": (_STREAM_ARGS, _STREAM_ENV,
               lambda b: b.run_stream(2048, 64, device="cpu", stamps={})),
    "mesh": (_STREAM_ARGS + ["--mesh", "2"],
             dict(_STREAM_ENV, BENCH_STREAM_PROFILE="0", BENCH_STREAM_REF="1024"),
             lambda b: b.run_stream(2048, 64, mesh_n=2, device="cpu", stamps={})),
    "chaos": (["--chaos-overhead"], {"BENCH_CHAOS_MEMBERS": "8", "BENCH_CHAOS_EVENTS": "400"},
              lambda b: b.run_chaos_overhead("cpu", stamps={})),
    "churn": (["--churn"], {"BENCH_CHURN_REPACKS": "3"}, None),
}
TIMEOUT = 900


def _env(knobs: dict) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(knobs, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    return env


def _start(cmd, knobs):
    return subprocess.Popen(cmd, cwd=ROOT, env=_env(knobs), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _in_process(run, knobs):
    """``(rc, line, stderr)`` of a port run in this process under ``knobs``
    (one torch thread, as the CLI sets for the CPU)."""
    from tpu_swirld_torch import bench

    threads = torch.get_num_threads()
    err = io.StringIO()
    torch.set_num_threads(1)
    try:
        with bench.knobs(**knobs), contextlib.redirect_stderr(err):
            out, rc, _detail = run(bench)
    finally:
        torch.set_num_threads(threads)
    return rc, json.loads(json.dumps(out)), err.getvalue()


@pytest.fixture(scope="module")
def runs():
    """``{mode: {"port": (rc, line, stderr), "ref": (...)}}``: the
    subprocesses started at once, the port's in-process runs meanwhile."""
    procs = {}
    for mode, (flags, knobs, run) in MODES.items():
        procs[mode, "ref"] = _start(
            [sys.executable, "bench.py", *flags], dict(knobs, BENCH_FORCE_CPU="1"))
        if run is None:
            procs[mode, "port"] = _start(
                [sys.executable, "-m", "tpu_swirld_torch.bench", "--device", "cpu", *flags],
                knobs)
    out = {}
    try:
        for mode, (_flags, knobs, run) in MODES.items():
            if run is not None:
                out.setdefault(mode, {})["port"] = _in_process(run, knobs)
        for (mode, who), p in procs.items():
            stdout, stderr = p.communicate(timeout=TIMEOUT)
            lines = stdout.strip().splitlines()
            out.setdefault(mode, {})[who] = (
                p.returncode, json.loads(lines[-1]) if lines else None, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    cli = out["churn"]["port"][1]
    if cli is not None:
        for mode, (_flags, _knobs, run) in MODES.items():
            if run is not None:
                out[mode]["port"][1].update({k: cli[k] for k in STAMPS if k in cli})
    return out


def _keys(d, prefix=""):
    out = set()
    if isinstance(d, dict):
        for k, v in d.items():
            if prefix == "" and k in STAMPS:
                out.add(k)
                continue
            out.add(prefix + k)
            out |= _keys(v, prefix + k + ".")
    return out


def _pair(runs, mode):
    (p_rc, port, p_err), (r_rc, ref, r_err) = runs[mode]["port"], runs[mode]["ref"]
    assert p_rc == 0 and port is not None, p_err[-3000:]
    assert r_rc == 0 and ref is not None, r_err[-3000:]
    return port, ref


def _pick(d, paths):
    out = {}
    for path in paths:
        cur = d
        for part in path.split("."):
            cur = cur[part]
        out[path] = cur
    return out


STREAM_FIELDS = [f"stream.{k}" for k in (
    "ordered", "max_round", "window_size", "pruned_prefix", "archived_rows",
    "widen_rebases", "full_rebases", "peak_resident_tiles",
    "peak_resident_visibility_bytes", "oracle_prefix", "oracle_decided", "events",
    "members", "chunk", "tile", "tile_budget", "budget_ok", "parity")]
FIELDS = {
    "default": ["incremental.passes", "incremental.rebases", "incremental.window_size",
                "incremental.pruned_prefix", "incremental.chunk", "incremental.parity",
                "phases.incremental_window_size", "phases.incremental_pruned_prefix",
                "stream.ordered", "stream.members", "stream.events", "stream.chunk",
                "stream.fuse_chunks", "stream.decode_overlap", "stream.parity"]
    + [f"finality.{e}.{k}" for e in ("oracle", "batch", "incremental")
       for k in ("decided", "rtd_mean", "rtd_max")],
    "stream": STREAM_FIELDS + ["finality.streaming.decided", "finality.streaming.rtd_mean"],
    "mesh": STREAM_FIELDS + [f"stream_mesh.{k}" for k in (
        "devices", "peak_device_tiles", "device_resident_tiles", "peak_resident_tiles",
        "budget_overruns", "device_tile_budget", "device_budget_ok", "single_ref_events",
        "parity")],
    "chaos": [f"chaos_overhead.{k}" for k in (
        "n_members", "n_events", "n_forkers", "fork_prob", "fork_pairs", "overflow_retries")],
    "churn": [f"churn.{k}" for k in (
        "epochs", "decided", "restatements", "repack_samples", "n_nodes", "turns", "events")],
}
PARITY = {
    "default": ["incremental.parity", "stream.parity"],
    "stream": ["stream.parity", "stream.budget_ok"],
    "mesh": ["stream.parity", "stream.budget_ok", "stream_mesh.parity"],
    "chaos": [],
    "churn": [],
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_bench_line_matches_reference(runs, mode):
    port, ref = _pair(runs, mode)
    assert _keys(port) == _keys(ref)
    assert _pick(port, FIELDS[mode]) == _pick(ref, FIELDS[mode])
    for path in PARITY[mode]:
        assert _pick(port, [path])[path] is True, path
    if mode == "default":
        assert port["metric"].endswith("order parity=True")
        assert port["peak_device_bytes"] == 0          # nothing on a device: the CPU
    assert port["lint"]["clean"] and port["mc"]["ok"] and port["scale_audit"]["clean"]


def test_stream_digests_logged_and_mesh_ranks_agree(runs):
    """The stream mode logs the decided output's digests; the mesh mode's
    ranks and its one process decide the same output."""
    digests = {}
    for mode in ("stream", "mesh"):
        _rc, _line, err = runs[mode]["port"]
        line = [ln for ln in err.splitlines() if ln.startswith("[digests] ")]
        assert len(line) == 1
        digests[mode] = json.loads(line[0][len("[digests] "):])
    assert digests["stream"] == digests["mesh"]
    _rc, _line, err = runs["mesh"]["port"]
    assert "every rank's digests equal to its: True" in err


def test_mesh_device_peak_is_the_largest_ranks(runs):
    """``--stream --mesh D``: the ranks run in their own processes, so the
    line's ``peak_device_bytes`` and the ``stream`` phase's device peak are
    the largest rank's, and the one-process pass keeps its own phase key."""
    from tpu_swirld_torch import bench

    port = runs["mesh"]["port"][1]
    assert "mem_stream_single_ref_device_peak_bytes" in port["phases"]
    out = {"peak_device_bytes": 9, "phases": {"mem_stream_device_peak_bytes": 0,
                                              "mem_stream_single_ref_device_peak_bytes": 9}}
    ranks = [{"result": {"peak_device_bytes": 5}}, {"result": {"peak_device_bytes": 7}}]
    bench._group_peak(out, ranks)
    assert out == {"peak_device_bytes": 7, "phases": {
        "mem_stream_device_peak_bytes": 7, "mem_stream_single_ref_device_peak_bytes": 9}}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_bench_without_a_card_exits_nonzero():
    """No probe, no fallback: ``--device cuda`` (the default) on a machine
    without a card exits 2 with a message and prints no line."""
    for flags in ([], ["--stream"], ["--churn"]):
        r = subprocess.run([sys.executable, "-m", "tpu_swirld_torch.bench", *flags],
                           cwd=ROOT, env=_env({}), capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 2, r.stderr
        assert r.stdout == ""
        assert "no CUDA device" in r.stderr and "--device cpu" in r.stderr
    from tpu_swirld_torch import bench

    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_default("cuda", stamps={})


def test_knobs_are_restored():
    from tpu_swirld_torch import bench

    os.environ.pop("BENCH_STREAM_EVENTS", None)
    os.environ["BENCH_STREAM_CHUNK"] = "7"
    try:
        with bench.knobs(BENCH_STREAM_EVENTS=18432, BENCH_STREAM_CHUNK=2048):
            assert bench._int("BENCH_STREAM_EVENTS", 0) == 18432
            assert bench._int("BENCH_STREAM_CHUNK", 0) == 2048
        assert "BENCH_STREAM_EVENTS" not in os.environ
        assert os.environ["BENCH_STREAM_CHUNK"] == "7"
    finally:
        os.environ.pop("BENCH_STREAM_CHUNK", None)


@pytest.mark.slow
def test_bench_stream_golden_matches_reference():
    """Recompute ``chip_smoke.BENCH_STREAM_GOLDEN``: the JAX reference's
    ``StreamingConsensus`` over the config-5 stream at phase 20(a)'s depth,
    with ``bench.py --stream``'s driver settings, under the simulation
    signer."""
    import chip_smoke
    from tpu_swirld import crypto as ref_crypto
    from tpu_swirld.config import SwirldConfig
    from tpu_swirld.sim import stream_gossip_dag
    from tpu_swirld.store import StreamingConsensus

    from tpu_swirld_torch import bench

    knobs = chip_smoke.BENCH_STREAM
    old = ref_crypto.backend_name()
    ref_crypto.set_backend("sim")
    try:
        members, stake, _keys, chunks = stream_gossip_dag(
            256, knobs["BENCH_STREAM_EVENTS"], 2048, seed=1)
        inc = StreamingConsensus(members, stake, SwirldConfig(n_members=256),
                                 tile_budget=65536, tile=256, ingest_chunk=2048,
                                 window_bucket=2048, prune_min=1024)
        for chunk in chunks:
            inc.ingest(chunk)
        res = inc.result()
        inc.store.close()
    finally:
        ref_crypto.set_backend(old)
    want = dict(bench.result_digests(inc.packer.event_id, res), ordered=len(res.order))
    assert want == chip_smoke.BENCH_STREAM_GOLDEN


@pytest.mark.slow
def test_prefix_golden_matches_reference():
    """Recompute ``chip_smoke.PREFIX_GOLDEN`` and ``BENCH_DEFAULT_GOLDEN``:
    the JAX reference's ``run_consensus`` over configs 3 and 4's first
    ``PREFIX_EVENTS`` events (the cut runs of phases 5, 10 and 14(c)) and
    over config 3's first ``BENCH_DEFAULT["BENCH_EVENTS"]`` (phase 20(b)'s
    default mode), sim signer."""
    import chip_smoke
    from tpu_swirld import crypto as ref_crypto
    from tpu_swirld.config import SwirldConfig
    from tpu_swirld.packing import pack_events
    from tpu_swirld.sim import generate_gossip_dag
    from tpu_swirld.tpu.pipeline import run_consensus

    old = ref_crypto.backend_name()
    ref_crypto.set_backend("sim")
    try:
        got = {}
        for name, n_forkers in chip_smoke.CONFIGS.items():
            members, stake, events, _keys = generate_gossip_dag(
                chip_smoke.N_MEMBERS, chip_smoke.PREFIX_EVENTS, seed=chip_smoke.SEED,
                n_forkers=n_forkers)
            packed = pack_events(events, members, stake)
            result = run_consensus(packed, SwirldConfig(n_members=chip_smoke.N_MEMBERS),
                                   s_max=chip_smoke.N_MEMBERS + 1)
            got[name] = chip_smoke.result_digests(packed, result)
        members, stake, events, _keys = generate_gossip_dag(
            chip_smoke.N_MEMBERS, chip_smoke.BENCH_DEFAULT["BENCH_EVENTS"],
            seed=chip_smoke.SEED)
        packed = pack_events(events, members, stake)
        result = run_consensus(packed, SwirldConfig(n_members=chip_smoke.N_MEMBERS))
        default = chip_smoke.result_digests(packed, result)
    finally:
        ref_crypto.set_backend(old)
    assert default == chip_smoke.BENCH_DEFAULT_GOLDEN
    assert len(result.order) > 0
    assert got == chip_smoke.PREFIX_GOLDEN
    assert got["config3"]["order"] == chip_smoke.PIN_GOLDEN["order"]


@pytest.mark.slow
def test_bench_counts_match_reference():
    """Recompute ``chip_smoke.BENCH_CHAOS_COUNTS`` and ``BENCH_CHURN_COUNTS``:
    the reference's ``--chaos-overhead`` attack leg and ``--churn`` at their
    defaults, under the simulation signer (~4 min: the attack leg's 10 388
    fork pairs)."""
    import chip_smoke
    from tpu_swirld import crypto as ref_crypto
    from tpu_swirld.config import SwirldConfig
    from tpu_swirld.membership.engine import run_dynamic
    from tpu_swirld.membership.sim import churn_schedule
    from tpu_swirld.packing import pack_events
    from tpu_swirld.sim import generate_gossip_dag
    from tpu_swirld.tpu.pipeline import run_consensus

    old = ref_crypto.backend_name()
    ref_crypto.set_backend("sim")
    try:
        members, stake, events, _keys = generate_gossip_dag(32, 4000, seed=2, n_forkers=10,
                                                            fork_prob=0.4)
        packed = pack_events(events, members, stake)
        res = run_consensus(packed, SwirldConfig(n_members=32))
        chaos = {"n_forkers": 10, "fork_pairs": int(packed.fork_pairs.shape[0]),
                 "overflow_retries": int(res.timings.get("overflow_retries", 0))}
        c_events, c_members, c_stake, _sim = churn_schedule(4, seed=0, turns=700)
        dyn = run_dynamic(c_events, c_members, c_stake, engine="incremental", chunk=64)
        churn = {"epochs": dyn.epochs, "decided": len(dyn.order),
                 "restatements": dyn.restatements,
                 "repack_samples": 30 * (len(dyn.ledger.epochs) - 1),
                 "events": len(c_events)}
    finally:
        ref_crypto.set_backend(old)
    assert chaos == chip_smoke.BENCH_CHAOS_COUNTS
    assert churn == chip_smoke.BENCH_CHURN_COUNTS


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["cluster", "soak"])
def test_host_modes_keys_match_reference(mode):
    """``--cluster`` and ``--soak`` (node processes on the host): the same
    keys as the reference's, a green verdict."""
    lines = {}
    for who, cmd in (("port", [sys.executable, "-m", "tpu_swirld_torch.bench",
                               "--device", "cpu", f"--{mode}"]),
                     ("ref", [sys.executable, "bench.py", f"--{mode}"])):
        r = subprocess.run(cmd, cwd=ROOT, env=_env({"BENCH_FORCE_CPU": "1"}),
                           capture_output=True, text=True, timeout=TIMEOUT)
        assert r.returncode == 0, r.stderr[-3000:]
        lines[who] = json.loads(r.stdout.strip().splitlines()[-1])
    assert _keys(lines["port"]) == _keys(lines["ref"])
    assert lines["port"][mode]["verdict_ok"] is True
