"""The port's streaming driver with its window row-sharded over gloo groups
of 2 and 4 CPU ranks (``tpu_swirld_torch.parallel.GroupStreamingConsensus``,
spawned by ``tpu_swirld_torch.multichip.launch``), in lockstep with the JAX
reference's ``MeshStreamingConsensus`` over as many devices of the 8-device
host platform of ``tests/conftest.py``.  Tolerance: exact equality.

The schedules are ``tests/test_mesh_stream.py``'s: the smoke (:61), the
forked window (:170), the straggler witness below the frozen vote horizon
(:141, a full rebase on every rank) and the widening rebase (as
``tests/test_torch_mesh.py`` runs it), and a forked widening (the forked
history of ``tests/test_torch_store.py`` and a stale sync naming its
``events[80]``: the window shifts and its shard size changes).  Every rank
holds only its ``W / D`` rows of each slab after every ingest
(``multichip.assert_row_sharded``, checked in the rank), no full rebase
allocates a slab of more than ``N / D`` rows of the DAG's ``N`` or ``W /
D`` of the window's, and no widening one of more than the widened
window's ``new_pad / D``, on the card or the host, nor hands more than the
retained rows that change owner; every pass's
stats, the result, the archive and the store's accounting equal the
reference's on every rank.  A pass's collectives by stage
(``group_stages``) add up to its ``group_calls`` and ``group_bytes``; each
order-stage call runs two collectives, the column exchange and the join,
and hands at most ``(D - 1) W^2 / D^2 + 8 W`` bytes (no rank gathers the
window's ``W`` rows).  The driver's fame and order window stages over a
group's row views equal the reference's window stages, fame's cell
gathers covering ``(R - 1) x s_used^2`` cells of the used slots."""

import numpy as np
import pytest

from tpu_swirld import parallel as ref_parallel
from tpu_swirld.config import SwirldConfig as RefConfig
from tpu_swirld.sim import generate_gossip_dag, make_simulation, make_straggler_event
from tpu_swirld.tpu import pipeline as ref_pipeline
from tpu_swirld_torch import multichip
from tpu_swirld_torch.gpu import incremental as inc
from tpu_swirld_torch.parallel import BETWEEN_STAGES
from tpu_swirld_torch.store import StreamingConsensus
from tests.test_torch_group_columns import widened_slabs, widening_rank, window_stages_rank
from tests.test_torch_incremental import port_events
from tests.test_torch_pipeline import assert_same
from tests.test_torch_store import (
    KW, STORE_VOLATILE, VOLATILE, assert_batch_parity, fixed_chunks, port_config,
    stale_event,
)

# name -> (generate_gossip_dag args, or the straggler's (simulation members,
# seed, turns), driver settings, ingest size, pallas)
SCHEDULES = {
    "smoke": ((6, 300, 9, 0), dict(chunk=64, window_bucket=256, prune_min=64,
                                   ingest_chunk=128), 100, False),
    "forks": ((12, 1000, 4, 4), dict(chunk=64, window_bucket=512, prune_min=128,
                                     ingest_chunk=256), 250, True),
    "widening": ((8, 1000, 11, 0), dict(chunk=64, window_bucket=256, prune_min=64,
                                        ingest_chunk=256), 200, True),
    "widening_forks": ((8, 900, 5, 1), dict(KW), 150, False),
    "straggler": ((5, 23, 260), dict(block=64, chunk=32, window_bucket=256,
                                     prune_min=64), 50, False),
}
RANKS = {2: ("smoke", "forks", "widening", "widening_forks", "straggler"),
         4: ("smoke", "forks", "widening", "widening_forks", "straggler")}
#: each widening schedule's stale sync: (member, the pruned event its
#: other parent names, payload), and the widening the port's one-process
#: driver makes of it: (w_pad before, after, delta)
WIDENINGS = {"widening": ((3, 100, b"stale-sync"), (512, 1280, 778)),
             "widening_forks": ((0, 80, b"stale-forks"), (768, 1024, 197))}


def _schedule(name):
    """``(members, stake, reference chunks, config, driver settings,
    pallas)``; the widening schedule ends with a stale-view sync naming
    long-pruned history, the straggler schedule with a witness forged at
    round 1 by the simulation's last node (``make_straggler_event``)."""
    args, kw, size, pallas = SCHEDULES[name]
    if name == "straggler":
        n_nodes, seed, turns = args
        sim = make_simulation(n_nodes, seed=seed)
        sim.run(turns)
        node, lag = sim.nodes[0], sim.nodes[-1]
        events = [node.hg[e] for e in node.order_added]
        chunks = fixed_chunks(events, size)
        chunks.append([make_straggler_event(node, lag.pk, lag.sk, at_round=1)])
        return (node.members, [node.stake[m] for m in node.members], chunks,
                node.config, kw, pallas)
    m, n, seed, forkers = args
    members, stake, events, keys = generate_gossip_dag(m, n, seed=seed, n_forkers=forkers)
    chunks = fixed_chunks(events, size)
    if name in WIDENINGS:
        chunks.append([stale_event(events, keys, *WIDENINGS[name][0])])
    return members, stake, chunks, RefConfig(n_members=m), kw, pallas


@pytest.fixture(scope="module")
def groups():
    """``groups(d)``: every schedule of ``RANKS[d]`` run in one gloo group
    of ``d`` CPU ranks (once a module), ``{name: per-rank results}``."""
    runs = {}

    def run(d):
        if d not in runs:
            tasks = []
            for name in RANKS[d]:
                members, stake, chunks, cfg, kw, pallas = _schedule(name)
                task = widening_rank if name in WIDENINGS else multichip.streaming_rank
                tasks.append((task, (
                    members, stake, port_config(cfg), [port_events(c) for c in chunks],
                    {**kw, "pallas": pallas},
                )))
            reports = multichip.launch(multichip.tasks_rank, d, args=(tasks,),
                                       device="cpu", backend="gloo", timeout=300)
            runs[d] = {name: [rep["result"]["results"][i] for rep in reports]
                       for i, name in enumerate(RANKS[d])}
        return runs[d]

    return run


def order_bytes_bound(w, d):
    """The most bytes a group rank may hand the order stage a call: its
    column exchange's blocks for the other ranks and the joined outputs
    (two int32 of each of the ``w`` events)."""
    return (d - 1) * w * w // (d * d) + 8 * w


def _check_stages(stages, calls, sent, w, d):
    """A pass's collectives by stage: they add up, and each order-stage
    call runs the column exchange and the join, within its bound.  Returns
    the pass's order-stage calls."""
    assert sum(r["calls"] for r in stages.values()) == calls
    assert sum(r["bytes"] for r in stages.values()) == sent
    assert stages.get(BETWEEN_STAGES, {"stage_calls": 0})["stage_calls"] == 0
    order = stages.get("pipeline.inc_order", {"calls": 0, "stage_calls": 0,
                                              "peak_call_bytes": 0})
    assert order["calls"] == 2 * order["stage_calls"]
    assert order["peak_call_bytes"] <= order_bytes_bound(w, d)
    return order["stage_calls"]


def _lockstep(d, outs, name):
    """The reference's mesh driver over ``d`` devices through the same
    schedule, every pass's stats compared with every rank's."""
    members, stake, chunks, cfg, kw, _pallas = _schedule(name)
    want = ref_parallel.MeshStreamingConsensus(ref_parallel.make_mesh(d), members,
                                               stake, cfg, **kw)
    try:
        order_calls = [0] * len(outs)
        for i, chunk in enumerate(chunks):
            sw = want.ingest(chunk)
            for k in VOLATILE:
                sw.pop(k, None)
            for j, out in enumerate(outs):
                sg = dict(out["passes"][i])
                calls, sent = sg.pop("group_calls"), sg.pop("group_bytes")
                assert calls > 0 and sent > 0
                order_calls[j] += _check_stages(sg.pop("group_stages"), calls, sent,
                                                sg.pop("group_window_rows"), d)
                assert sg.pop("rank_resident_bytes") * d == sg["resident_bytes"]
                for k in VOLATILE:
                    sg.pop(k, None)
                assert sg == sw, (name, i)
        assert min(order_calls) > 0 and len(set(order_calls)) == 1, order_calls
        for out in outs:
            assert_same(want.result(), out["result"])
            arch = want.store.archive
            assert out["archive"] == {
                "digest": arch.digest(), "n_rows": arch.n_rows, "rounds": arch._rounds,
                **{k: getattr(arch, k) for k in (
                    "spills", "fetches", "spilled_rows", "fetched_rows",
                    "skipped_rows", "archive_bytes")}}
            sw_store, sg_store = want.store.stats(), dict(out["store"])
            for k in STORE_VOLATILE:
                sw_store.pop(k)
                sg_store.pop(k)
            assert sg_store == sw_store and sg_store["n_shards"] == d
            for k in ("widen_rebases", "full_rebases", "pruned_prefix", "_round_hi"):
                assert out["counters"][k] == getattr(want, k), k
            assert out["counters"]["repins"] == 0
            assert out["counters"]["forked"] == (want._sees_d is not want._anc_d)
    finally:
        want.store.close()
    return members, stake, chunks, cfg


@pytest.mark.parametrize("d,name", [(d, n) for d in sorted(RANKS) for n in RANKS[d]
                                    if (d, n) != (2, "widening")])
def test_group_streaming_lockstep_with_reference(groups, d, name):
    outs = groups(d)[name]
    members, stake, chunks, cfg = _lockstep(d, outs, name)
    events = [e for c in chunks for e in c]
    for out in outs:
        assert out["passes"][-1]["mesh_devices"] == d
        assert_batch_parity(_Result(out["result"]), events, members, stake, cfg)
    if name == "smoke":
        assert outs[0]["counters"]["pruned_prefix"] > 0
    elif name != "widening":
        assert outs[0]["counters"]["forked"]


@pytest.mark.parametrize("d", [2, 4])
def test_group_straggler_rebase_rank_rows(groups, d):
    """The straggler's full rebases on a group rank: the cold start and the
    straggler, each over the rank's own rows of the DAG's slabs.  No slab
    it allocated had more than ``N / D`` rows (``N`` the pass's events,
    padded to whole blocks a rank) or, in the lift, ``W / D``; its
    visibility stage handed exactly ``sum_t |X_t| N`` bytes, ``X_t`` rank
    ``t``'s rows that are parents of later ranks' events."""
    block = SCHEDULES["straggler"][1]["block"]
    for out in groups(d)["straggler"]:
        recs = out["rebase_slabs"]
        assert out["counters"]["full_rebases"] == len(recs) >= 2
        for rec in recs:
            assert rec["n_pad"] % (d * block) == 0 and rec["w_pad"] % d == 0
            assert 0 < rec["batch_rows"] <= rec["n_pad"] // d
            assert 0 < rec["window_rows"] <= rec["w_pad"] // d
        assert recs[-1]["crossing_rows"] > 0
        vis = [st["group_stages"].get("pipeline.visibility_stage", {"bytes": 0})["bytes"]
               for st in out["passes"]]
        assert sum(vis) == sum(r["crossing_rows"] * r["n_pad"] for r in recs)
        assert vis[-1] == recs[-1]["crossing_rows"] * recs[-1]["n_pad"] > 0


def test_group_streaming_widening_rebase(groups):
    outs = groups(2)["widening"]
    _lockstep(2, outs, "widening")
    for out in outs:
        assert out["counters"]["widen_rebases"] == 1
        assert out["counters"]["full_rebases"] == 1          # the cold start
        assert out["archive"]["fetched_rows"] > 0
        assert (out["result"].round_received >= 0).any()


def moved_rows(w_pad, new_pad, w_used, delta, d):
    """The retained rows whose owner changes when old row ``i`` becomes row
    ``i + delta`` and a shard goes from ``w_pad / d`` to ``new_pad / d``
    rows: the whole-slab arithmetic."""
    i = np.arange(w_used)
    return int(((i // (w_pad // d)) != ((i + delta) // (new_pad // d))).sum())


@pytest.mark.parametrize("d,name", [(d, n) for d in sorted(RANKS) for n in WIDENINGS])
def test_group_widening_rank_rows(groups, d, name):
    """A group rank's widening builds only its own ``new_pad / D`` rows: no
    slab it allocated, on the card or the host, had more rows; it read its
    own archived rows of ``[0, delta)`` and the archived parents of
    retained events alone; it handed only the retained rows that change
    owner, ``moved_rows x (s w_used + cap)`` bytes (``s`` square slabs,
    2 when forked; ``cap`` the column store's width), and the widening
    pass's bytes between stages are at most ``moved_rows x (s W + cap)``,
    itself at most the ``s W^2 + W cap`` of pulling the whole window.  The
    archive counts the reference's one fetch of ``delta`` rows (held in
    lockstep by the tests above)."""
    w_before, w_after, delta = WIDENINGS[name][1]
    for rank, out in enumerate(groups(d)[name]):
        c = out["counters"]
        assert c["widen_rebases"] == 1 and c["repins"] == 0
        assert c["forked"] == (name == "widening_forks")
        assert c["full_rebases"] == (3 if name == "widening_forks" else 1)
        (rec,) = out["widen_slabs"]
        assert (rec["w_pad"], rec["new_pad"], rec["delta"]) == (w_before, w_after, delta)
        assert rec["forked"] == c["forked"]
        n_loc = w_after // d
        own = max(0, min(delta, (rank + 1) * n_loc) - min(delta, rank * n_loc))
        assert 0 < rec["window_rows"] <= n_loc
        assert 0 < rec["parent_rows"]
        assert own <= rec["decompressed_rows"] <= own + rec["parent_rows"]
        moved = moved_rows(w_before, w_after, rec["w_used"], delta, d)
        assert rec["moved_rows"] == moved > 0
        s = 2 if rec["forked"] else 1
        assert rec["bytes"] == moved * (s * rec["w_used"] + rec["ssm_cols"])
        between = out["passes"][-1]["group_stages"][BETWEEN_STAGES]["bytes"]
        assert rec["bytes"] <= between <= moved * (s * w_before + rec["ssm_cols"])
        assert moved * (s * w_before + rec["ssm_cols"]) <= (
            s * w_before ** 2 + w_before * rec["ssm_cols"])


def one_process_widening(name):
    """The port's one-process driver through schedule ``name`` on the CPU:
    its slabs just after its one widening (:func:`widened_slabs`), and the
    packed events."""
    members, stake, chunks, cfg, kw, _pallas = _schedule(name)
    single = StreamingConsensus(members, stake, port_config(cfg), device="cpu", **kw)
    try:
        with widened_slabs(StreamingConsensus) as shots:
            for chunk in chunks:
                single.ingest(port_events(chunk))
    finally:
        single.store.close()
    (slabs,) = shots
    return slabs, single.packer


@pytest.mark.parametrize("d,name", [(d, n) for d in sorted(RANKS) for n in WIDENINGS])
def test_group_widening_builds_the_one_process_rows(groups, d, name):
    """Just after its widening each rank holds exactly its ``new_pad / D``
    rows of the one-process driver's widened ``anc``, ``sees`` and ``ssm``
    (re-admitted rows, their sees, the retained rows' rebuilt prefix
    columns and the moved column store), and that ``anc`` is the DAG's
    ancestry over the widened window, by a host closure of the parents."""
    (anc, sees, ssm), packer = one_process_widening(name)
    _before, w_after, delta = WIDENINGS[name][1]
    assert anc.shape == (w_after, w_after) and (sees is None) == (name == "widening")
    n_loc = w_after // d
    for rank, out in enumerate(groups(d)[name]):
        (got,) = out["widened"]
        rows = slice(rank * n_loc, (rank + 1) * n_loc)
        for g, want in zip(got, (anc, sees, ssm)):
            assert (g is None) == (want is None)
            if want is not None:
                assert np.array_equal(g, want[rows])
    par = np.asarray(packer.window_view(0, len(packer))[0], dtype=np.int64)
    hi = len(packer) - 1                # the stale sync is the widening's pending delta
    lo2 = WIDENINGS[name][0][1]         # the pruned event it names
    closure = np.zeros((hi, hi), bool)
    for e in range(hi):
        closure[e, e] = True
        for p in par[e]:
            if p >= 0:
                closure[e] |= closure[p]
    w2 = hi - lo2
    assert np.array_equal(anc[:w2, :w2], closure[lo2:, lo2:])
    assert not anc[w2:].any() and anc[delta:w2, :delta].any()


class _Result:
    """A port result as ``assert_batch_parity`` reads a driver."""

    def __init__(self, result):
        self._result = result

    def result(self):
        return self._result


@pytest.mark.parametrize("d", [2, 4])
def test_group_window_stages_match_reference(d, tmp_path):
    """The driver's fame and order window stages over a gloo group's row
    views (``tests/test_torch_group_columns.py:window_stages_rank``) on a
    forked window, fame's table at a slot capacity above its used width:
    every rank's outputs equal the reference's window stages; fame's two
    cell gathers cover ``(R - 1) x s_used^2`` cells each, not the
    capacity's; order hands its column exchange and the join alone,
    ``(D - 1) W^2 / D^2 + 8 W`` bytes."""
    import jax.numpy as jnp

    from tests.test_torch_fame_scan import _batch as fame_batch, _columns
    from tests.test_torch_order_scan import _batch as order_batch, _window

    f = _columns(fame_batch("forked"))
    o = _window(order_batch("forked"))
    assert np.array_equal(f["creator"], o["creator"])
    r_max, s_used = f["tab"].shape
    s_cap, r_fame = s_used + 5, r_max - 2
    fame_tab = np.full((r_max, s_cap), -1, np.int32)
    fame_tab[:, :s_used] = f["tab"]
    assert inc._used_slots(fame_tab[:r_fame]) == s_used
    r_ord = o["tab"].shape[0] - 1
    path = tmp_path / "window.npz"
    np.savez(path, sees=f["sees"], ssm=f["ssm"], col_pos=f["col_pos"], fame_tab=fame_tab,
             creator=f["creator"], coin=f["coin"], stake=f["stake"], tot_stake=f["tot"],
             coin_period=f["coin_period"], r_max=r_fame, s_max=s_cap, s_used=s_used,
             has_forks=f["has_forks"], anc=o["anc"], tab=o["tab"], cnt=o["cnt"],
             famous=o["famous"], self_parent=o["self_parent"], t_rank=o["t_rank"],
             max_round=o["max_round"], n_valid=o["n_valid"], received0=o["received0"],
             r_ord=r_ord, chain=o["chain"])
    reports = multichip.launch(window_stages_rank, d, args=(str(path),), device="cpu",
                               backend="gloo", timeout=300)
    want_fame = ref_pipeline.fame_window_stage(
        *(jnp.asarray(x) for x in (f["sees"], f["ssm"], f["col_pos"], fame_tab,
                                   f["creator"], f["coin"], f["stake"])),
        tot_stake=f["tot"], coin_period=f["coin_period"], r_max=r_fame, s_max=s_cap,
        has_forks=f["has_forks"], matmul_dtype_name="float32")
    want_order = ref_pipeline.order_window_stage(
        *(jnp.asarray(o[k]) for k in ("anc", "tab", "cnt", "famous", "creator",
                                      "self_parent", "t_rank")),
        np.int32(o["max_round"]), np.int32(o["n_valid"]), jnp.asarray(o["received0"]),
        r_max=r_ord, s_max=o["tab"].shape[1], chain=o["chain"])
    w = o["anc"].shape[0]
    for rep in reports:
        out = rep["result"]
        for g, x in zip(out["fame"], want_fame):
            assert np.array_equal(g, np.asarray(x))
        for g, x in zip(out["order"], want_order):
            assert np.array_equal(g, np.asarray(x))
        # fame is handed the used slots; the card's route gathers their cells
        assert out["fame_handed"] == [(r_fame, s_used)]
        cells = 2 * (r_fame - 1) * s_used ** 2
        assert out["stages"]["fame cells"] == {"calls": 2, "bytes": cells, "stage_calls": 1,
                                               "peak_call_bytes": cells}
        order = out["stages"]["pipeline.inc_order"]
        sent = (d - 1) * (w // d) ** 2 + 8 * w
        assert sent <= order_bytes_bound(w, d)
        assert order == {"calls": 2, "bytes": sent, "stage_calls": 1, "peak_call_bytes": sent}
    assert (np.asarray(want_order[0]) >= 0).any() and (np.asarray(want_fame[0]) == 1).any()
