"""A group rank's column exchange (``parallel.exchange_columns``) and the
join of its events' outputs (``parallel.join_columns``), over gloo groups
of 2, 3 and 4 CPU ranks: each rank holds its ``W / D`` rows of a seeded
square slab and ends with its own events' columns of every row, equal to
that slice of the whole slab, having handed the collective only the
``(D - 1)`` blocks of ``(W / D)^2`` bytes that the other ranks take;
and ``reshard_rows`` with a negative shift (a widening's move of the
retained rows down a new shard size) against the whole-slab arithmetic,
its sums carrying exactly the rows that change owner.  Tolerance: exact
equality.

The module imports no JAX: its rank tasks run in spawned processes, which
import the module that holds them.  ``tests/test_torch_mesh_group.py``
runs :func:`window_stages_rank` and holds it to the JAX reference."""

import contextlib

import numpy as np
import pytest
import torch

from tpu_swirld_torch import multichip
from tpu_swirld_torch.parallel import (
    GroupMesh, RowGather, Traffic, exchange_columns, join_columns, stage_totals,
)

W = 96          # divides into 2, 3 and 4 row shards


def _slab(w, seed):
    return np.random.default_rng(seed).random((w, w)) < 0.4


def exchange_rank(mesh, w, seed) -> dict:
    """This rank's rows of the seeded ``(w, w)`` slab through
    :func:`exchange_columns`, and a ``(2, w)`` int32 table whose rank's
    columns hold its own values through :func:`join_columns`."""
    whole = _slab(w, seed)
    n_loc = w // mesh.size
    lo = mesh.rank * n_loc
    cols = exchange_columns(mesh, torch.from_numpy(whole[lo : lo + n_loc]).clone())
    exchanged = {"calls": mesh.traffic.calls, "bytes": mesh.traffic.bytes}
    mine = torch.arange(lo, lo + n_loc, dtype=torch.int32)
    joined = join_columns(mesh, torch.stack([mine * 3 - 7, -mine]))
    return {"cols": cols.numpy(), "dtype": str(cols.dtype), "exchanged": exchanged,
            "joined": joined.numpy()}


def pieces_rank(mesh, w, seed, pieces, n_rows, n_loc_new, shift, piece_rows) -> dict:
    """This rank's rows of the seeded ``(w, w)`` slab through
    :func:`exchange_columns` in one all-to-all and in ``pieces``, and
    through ``reshard_rows(n_rows, n_loc_new, shift)`` in one sum and in
    sums of at most ``piece_rows`` rows: the outputs, the collectives and
    bytes each handed, and the most rows of a slab the pieced reshard
    allocated."""
    from tpu_swirld_torch.parallel import reshard_rows

    whole = _slab(w, seed)
    n_loc = w // mesh.size
    shard = torch.from_numpy(whole[mesh.rank * n_loc : (mesh.rank + 1) * n_loc]).clone()
    out, handed, rows = {}, {}, []
    for name, fn in (
        ("exchange", lambda: exchange_columns(mesh, shard)),
        ("exchange pieces", lambda: exchange_columns(mesh, shard, pieces)),
        ("reshard", lambda: reshard_rows(mesh, shard, n_rows, n_loc_new, shift=shift)),
        ("reshard pieces", lambda: reshard_rows(mesh, shard, n_rows, n_loc_new, shift=shift,
                                                piece_rows=piece_rows, record=rows.append)),
    ):
        calls, sent = mesh.traffic.calls, mesh.traffic.bytes
        out[name] = fn().numpy()
        handed[name] = (mesh.traffic.calls - calls, mesh.traffic.bytes - sent)
    return {"digest": repr(handed), "out": out, "handed": handed, "rows": max(rows)}


def shift_down_rank(mesh, w, seed, cases) -> dict:
    """This rank's rows of the seeded ``(w, w)`` slab through
    ``reshard_rows(n_rows, n_loc_new, shift, cols=, col0=, piece_rows=)``
    for each case: the outputs, the bytes each handed and the rows of every
    slab it allocated."""
    from tpu_swirld_torch.parallel import reshard_rows

    whole = _slab(w, seed)
    n_loc = w // mesh.size
    shard = torch.from_numpy(whole[mesh.rank * n_loc : (mesh.rank + 1) * n_loc]).clone()
    outs = []
    for n_rows, n_loc_new, shift, cols, col0, piece_rows in cases:
        rows, sent = [], mesh.traffic.bytes
        got = reshard_rows(mesh, shard, n_rows, n_loc_new, shift=shift, cols=cols,
                           col0=col0, piece_rows=piece_rows, record=rows.append)
        outs.append({"out": got.numpy(), "bytes": mesh.traffic.bytes - sent, "rows": rows})
    return {"digest": repr([o["bytes"] for o in outs]), "outs": outs}


@contextlib.contextmanager
def widened_slabs(cls):
    """Patch ``cls._widen_slabs`` so that each widening appends host copies
    of the driver's slabs just after it, ``(anc, sees or None while
    fork-free, ssm)``, to the list yielded."""
    shots = []
    widen = cls._widen_slabs

    def capture(self, *args):
        widen(self, *args)
        sees = None if self._sees_d is self._anc_d else self._sees_d.cpu().numpy().copy()
        shots.append((self._anc_d.cpu().numpy().copy(), sees,
                      self._ssm_d.cpu().numpy().copy()))

    cls._widen_slabs = capture
    try:
        yield shots
    finally:
        cls._widen_slabs = widen


def widening_rank(mesh, *args) -> dict:
    """``multichip.streaming_rank`` with the rank's rows of the slabs
    after each widening (:func:`widened_slabs`) under ``"widened"``."""
    from tpu_swirld_torch.parallel import GroupStreamingConsensus

    with widened_slabs(GroupStreamingConsensus) as shots:
        out = multichip.streaming_rank(mesh, *args)
    out["widened"] = shots
    return out


def window_stages_rank(mesh, path) -> dict:
    """The driver's fame and order window stages over row views of this
    rank's rows of the slabs saved at ``path`` (fame on the table's used
    slots, as a group rank's driver runs it), each under its stage name in
    ``mesh.traffic``.  On the CPU the fame wrapper runs its plain version,
    which reads whole rows of the views; the cells the card's route gathers
    first from the table it is handed (``kernels._fame_cells``) are
    gathered beside it, under ``"fame cells"``.  Returns both stages'
    outputs, the tables fame was handed and the traffic by stage."""
    from tpu_swirld_torch.gpu import incremental as inc
    from tpu_swirld_torch.gpu import kernels

    handed = []

    def fame_scan(wit_table, sees, ssm, *args, col_pos, **kw):
        handed.append(tuple(wit_table.shape))
        with mesh.traffic.during("fame cells"):
            kernels._fame_cells(wit_table, sees, ssm, col_pos)
        return kernels.fame_scan(wit_table, sees, ssm, *args, col_pos=col_pos, **kw)

    inc.fame_scan = fame_scan

    z = dict(np.load(path))
    n = z["sees"].shape[0]
    n_loc = n // mesh.size
    lo = mesh.rank * n_loc

    def view(a):
        return RowGather(mesh, torch.from_numpy(a[lo : lo + n_loc]).clone(), n)

    def t(a):
        return torch.from_numpy(a)

    fame_kw = {k: int(z[k]) for k in ("tot_stake", "coin_period", "r_max", "s_max",
                                      "s_used")}
    with mesh.traffic.during("pipeline.inc_fame"):
        famous, dec = inc.fame_window_stage(
            view(z["sees"]), view(z["ssm"]), t(z["col_pos"]), t(z["fame_tab"]),
            t(z["creator"]), t(z["coin"]), t(z["stake"]),
            has_forks=bool(z["has_forks"]), **fame_kw)
    with mesh.traffic.during("pipeline.inc_order"):
        order = inc.order_window_stage(
            view(z["anc"]), t(z["tab"]), t(z["cnt"]), t(z["famous"]), t(z["creator"]),
            t(z["self_parent"]), t(z["t_rank"]), int(z["max_round"]), int(z["n_valid"]),
            t(z["received0"]), r_max=int(z["r_ord"]), s_max=int(z["tab"].shape[1]),
            s_used=inc._used_slots(z["tab"][: int(z["r_ord"])]), chain=int(z["chain"]))
    return {"fame": [famous.numpy(), dec.numpy()], "order": [x.numpy() for x in order],
            "fame_handed": handed, "stages": mesh.traffic.take_stages()}


@pytest.mark.parametrize("d", [2, 3, 4])
def test_column_exchange_matches_whole_slab_slice(d):
    reports = multichip.launch(exchange_rank, d, args=(W, d), device="cpu",
                               backend="gloo", timeout=120)
    whole = _slab(W, d)
    n_loc = W // d
    for rank, rep in enumerate(reports):
        out = rep["result"]
        assert out["dtype"] == "torch.bool"
        assert np.array_equal(out["cols"], whole[:, rank * n_loc : (rank + 1) * n_loc])
        # the blocks for the other ranks, once: (D - 1) (W / D)^2 bytes
        assert out["exchanged"] == {"calls": 1, "bytes": (d - 1) * n_loc * n_loc}
        ev = np.arange(W, dtype=np.int32)
        assert np.array_equal(out["joined"], np.stack([ev * 3 - 7, -ev]))


def test_column_exchange_refuses_a_slab_that_is_not_square():
    mesh = GroupMesh(0, 2, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="square"):
        exchange_columns(mesh, torch.zeros((4, 6), dtype=torch.bool))
    view = RowGather(mesh, torch.zeros((4, 6), dtype=torch.bool), 8)
    with pytest.raises(ValueError, match="square"):
        view.own_columns()
    assert mesh.traffic == Traffic()


def test_traffic_by_stage():
    """A collective counts under the stage it ran in, one call of the
    stage, its bytes the most a call of it handed; outside every stage
    under ``BETWEEN_STAGES``; a take starts afresh."""
    from tpu_swirld_torch.parallel import BETWEEN_STAGES

    tr = Traffic()
    tr.add(torch.zeros(10, dtype=torch.int8))
    for size in (3, 5):
        with tr.during("pipeline.inc_order"):
            tr.add(torch.zeros(size, dtype=torch.int32))
            tr.add(torch.zeros(8, dtype=torch.int8), nbytes=2)
    with tr.during("pipeline.inc_fame"):
        pass
    assert (tr.calls, tr.bytes) == (5, 10 + 12 + 2 + 20 + 2)
    taken = tr.take_stages()
    assert taken == {
        BETWEEN_STAGES: {"calls": 1, "bytes": 10, "stage_calls": 0, "peak_call_bytes": 0},
        "pipeline.inc_order": {"calls": 4, "bytes": 36, "stage_calls": 2,
                               "peak_call_bytes": 22},
        "pipeline.inc_fame": {"calls": 0, "bytes": 0, "stage_calls": 1,
                              "peak_call_bytes": 0},
    }
    assert tr.by_stage == {} and tr.stage == BETWEEN_STAGES
    # over passes: counts summed, the peak the most of any pass's
    with tr.during("pipeline.inc_order"):
        tr.add(torch.zeros(30, dtype=torch.int8))
    total = stage_totals([taken, tr.take_stages()])
    assert total["pipeline.inc_order"] == {"calls": 5, "bytes": 66, "stage_calls": 3,
                                           "peak_call_bytes": 30}
    assert total[BETWEEN_STAGES] == taken[BETWEEN_STAGES]


@pytest.mark.parametrize("d", [2, 3, 4])
def test_reshard_rows_shift_down(d):
    """``reshard_rows`` with a negative shift, as a widening moves the
    retained rows down: old row ``i`` of the first ``n_rows`` becomes row
    ``i - shift`` of a slab of ``n_loc_new`` rows a rank (wider, then
    narrower, than the old shard), its columns placed from ``col0``, in
    one sum and in sums of at most 7 rows.  Each rank's rows equal the
    whole-slab arithmetic, and the sums carry exactly the rows that change
    owner: none before the old slab's start, none past ``n_rows``."""
    cases = [(70, 144 // d, -40, 144, 40, None), (70, 144 // d, -40, 144, 40, 7),
             (90, 48 // d, -10, 100, 0, None), (30, 120 // d, -1, W, 0, 7)]
    reports = multichip.launch(shift_down_rank, d, args=(W, d, cases), device="cpu",
                               backend="gloo", timeout=120)
    whole = _slab(W, d)
    n_loc, total = W // d, 0
    for rank, rep in enumerate(reports):
        for (n_rows, n_loc_new, shift, cols, col0, piece_rows), got in zip(
                cases, rep["result"]["outs"]):
            big = np.zeros((d * n_loc_new - shift + W, cols), bool)
            big[-shift : n_rows - shift, col0 : col0 + W] = whole[:n_rows]
            want = big[rank * n_loc_new : (rank + 1) * n_loc_new]
            assert np.array_equal(got["out"], want)
            i = np.arange(n_rows)
            dest = i - shift
            moved = int(((dest < d * n_loc_new) & (i // n_loc != dest // n_loc_new)).sum())
            assert got["bytes"] == moved * W
            assert got["rows"][0] == n_loc_new
            assert sum(got["rows"][1:]) == moved
            if piece_rows is not None:
                assert max(got["rows"][1:], default=0) <= piece_rows
            total += moved
    assert total > 0
