"""Fame voting's wrapper, ``kernels.fame_scan``, on CPU tensors (where it
runs its plain version, ``fame_scan_reference``) against the JAX
reference's ``fame_scan``: ``famous`` and ``decided_at`` exactly equal, on
a fork-free DAG and a forked one (a creator with two witnesses in one
round; and witnesses given shared creators, where a stake counted twice
would decide), the column store with absent columns (``col_pos`` -1), a coin
period short enough that coin rounds decide nothing and coin bits move the
votes, non-uniform stake, a stake total at or past 2**24 without forks (the
reference's int32 path), and empty slots with undecided top rounds.  The
card route's cells (``_fame_cells``) feed a NumPy emulation of the kernel
(each witness column alone, stopped at the round that decides it, the
per-creator rule by a walk over the creator's earlier slots, the first
deciding ``y``), held to the reference on the same cases.  Then the port's
``fame_order_cols_stage`` and ``fame_window_stage`` against the
reference's, a group rank's cell gather, the wrapper's refusals and its
launch count, which stays 0 on the CPU."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_swirld.config import SwirldConfig as RefConfig
from tpu_swirld.packing import pack_events
from tpu_swirld.sim import generate_gossip_dag
from tpu_swirld.tpu import pipeline as ref
from tpu_swirld_torch import parallel
from tpu_swirld_torch.gpu import incremental as inc
from tpu_swirld_torch.gpu import kernels, pipeline


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tiny ops: torch's CPU thread pool costs far more than it saves here
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.array(a))        # a writable copy


#: kind -> generate_gossip_dag(members, events, seed, n_forkers, fork_prob)
DAGS = {"plain": (5, 500, 3, 0, 0.0), "forked": (7, 700, 1, 2, 0.1)}
_BATCH = {}


def _stake(kind, stake, m):
    if kind == "skewed":
        return np.random.default_rng(11).integers(1, 6, m).astype(np.int32)
    if kind == "huge":                  # each member 2**22: the total past 2**24
        return np.full(m, 1 << 22, np.int32)
    return np.asarray(stake, np.int32)


def _batch(kind, stake_kind="uniform"):
    """Fame's batch inputs on a seeded gossip DAG, every piece from the JAX
    reference: fork-aware sees, the strongly-sees matrix and the rounds
    scan's witness table, cut to its rounds and used slots."""
    key = (kind, stake_kind)
    if key in _BATCH:
        return _BATCH[key]
    m, n_events, seed, n_forkers, fork_prob = DAGS[kind]
    members, stake, events, _keys = generate_gossip_dag(
        m, n_events, seed=seed, n_forkers=n_forkers, fork_prob=fork_prob)
    packed = pack_events(events, members, _stake(stake_kind, stake, m))
    n = (packed.n + 127) // 128 * 128

    def pad(a, fill):
        return np.concatenate([a, np.full((n - packed.n, *a.shape[1:]), fill, a.dtype)])

    parents, creator, coin = pad(packed.parents, -1), pad(packed.creator, 0), pad(packed.coin, 0)
    tot = int(packed.stake.sum())
    anc = ref.ancestry(jnp.asarray(parents), block=128, matmul_dtype=jnp.float32)
    fseen = ref.forkseen_matrix(anc, jnp.asarray(packed.fork_pairs), m, jnp.float32)
    sees = ref.sees_matrix(anc, fseen, jnp.asarray(creator))
    ssm = ref.ssm_matrix(sees, jnp.asarray(packed.member_table),
                         jnp.asarray(packed.stake), tot, jnp.float32)
    has_forks = bool(len(packed.fork_pairs))
    assert has_forks == (kind == "forked")
    rnd, _w, tab, cnt, ovf = ref.rounds_scan(
        jnp.asarray(parents), ssm, jnp.asarray(creator), jnp.asarray(packed.stake),
        tot, jnp.asarray(packed.n, dtype=jnp.int32), r_max=32, s_max=3 * m,
        has_forks=has_forks,
    )
    assert int(ovf) == 0
    max_round = int(np.max(np.asarray(rnd)[: packed.n]))
    r_max = max_round + 3
    s_used = int(np.max(np.asarray(cnt)[:r_max]))
    _BATCH[key] = dict(
        packed=packed, sees=np.array(sees), ssm=np.array(ssm), col_pos=None,
        tab=np.array(tab)[:r_max, :s_used], cnt=np.array(cnt)[:r_max],
        creator=creator, coin=coin, stake=packed.stake, tot=tot,
        coin_period=RefConfig(n_members=m).coin_period, has_forks=has_forks,
        anc=np.array(anc), parents=parents, max_round=max_round,
    )
    return _BATCH[key]


def _columns(case, absent=0.15):
    """The column store: a column for each witness of the table but a
    seeded share of them (``col_pos`` -1, strongly seen by none)."""
    wits = np.unique(case["tab"][case["tab"] >= 0])
    rng = np.random.default_rng(3)
    cols = wits[rng.random(wits.shape[0]) >= absent]
    col_pos = np.full(case["sees"].shape[0], -1, np.int32)
    col_pos[cols] = np.arange(cols.shape[0], dtype=np.int32)
    assert (col_pos[wits] < 0).any() and (col_pos[wits] >= 0).any()
    return {**case, "ssm": np.ascontiguousarray(case["ssm"][:, cols]), "col_pos": col_pos}


def _coin_rounds(case):
    """Every second round a coin round, and a seeded third of the
    strongly-sees cells dropped, so that tallies miss the supermajority and
    coin bits become votes."""
    rng = np.random.default_rng(7)
    return {**case, "coin_period": 2,
            "ssm": case["ssm"] & (rng.random(case["ssm"].shape) >= 0.35)}


def _holes(case):
    """A seeded tenth of the table's slots emptied (-1)."""
    tab = case["tab"].copy()
    tab[np.random.default_rng(5).random(tab.shape) < 0.1] = -1
    return {**case, "tab": tab}


def _shared_creators(case):
    """In every second round the witnesses of slots 1 and 3 given the
    creators of slots 0 and 2: a forker's two witnesses of one round, which
    qualify together in most tallies, so a stake counted twice would decide
    where the reference's per-creator rule does not."""
    cre, tab = case["creator"].copy(), case["tab"]
    for r in range(0, tab.shape[0], 2):
        for a, b in ((0, 1), (2, 3)):
            if tab[r, a] >= 0 and tab[r, b] >= 0:
                cre[tab[r, b]] = cre[tab[r, a]]
    return {**case, "creator": cre, "has_forks": True}


CASES = {
    "fork-free": ("plain", "uniform", lambda c: c),
    "forked, a creator's two witnesses in one round": ("forked", "uniform", lambda c: c),
    "a creator's stake counted once": ("plain", "skewed", _shared_creators),
    "column store with absent columns, forked": ("forked", "uniform", _columns),
    "column store with absent columns, fork-free": ("plain", "skewed", _columns),
    "coin rounds that decide nothing and coin votes": ("plain", "uniform", _coin_rounds),
    "non-uniform stake, forked": ("forked", "skewed", lambda c: c),
    "stake total past 2**24 without forks": ("plain", "huge", lambda c: c),
    "empty slots and undecided top rounds": ("forked", "uniform", _holes),
}


def _reference(case, **over):
    c = {**case, **over}
    out = ref.fame_scan(
        jnp.asarray(c["tab"]), jnp.asarray(c["sees"]), jnp.asarray(c["ssm"]),
        jnp.asarray(c["creator"]), jnp.asarray(c["coin"]), jnp.asarray(c["stake"]),
        c["tot"], c["coin_period"], jnp.float32, has_forks=c["has_forks"],
        col_pos=None if c["col_pos"] is None else jnp.asarray(c["col_pos"]),
    )
    return [np.asarray(x) for x in out]


def _port(fn, case):
    cp = case["col_pos"]
    return fn(t(case["tab"]), t(case["sees"]), t(case["ssm"]), t(case["creator"]),
              t(case["coin"]), t(case["stake"]), case["tot"], case["coin_period"],
              has_forks=case["has_forks"], col_pos=None if cp is None else t(cp))


def _emulate_kernel(case):
    """``csrc/fame_scan.cu``'s algorithm in NumPy on the cells of
    ``kernels._fame_cells``: each witness slot ``x`` alone, from round
    ``xr + 1`` to the round that decides it."""
    tab, creator, stake = case["tab"], case["creator"], case["stake"]
    cp = case["col_pos"]
    sp, ss = (c.numpy() for c in kernels._fame_cells(
        t(tab), t(case["sees"]), t(case["ssm"]), None if cp is None else t(cp)))
    r_max, s_max = tab.shape
    n, m = creator.shape[0], stake.shape[0]
    exact = case["has_forks"] or case["tot"] >= (1 << 24)
    famous = np.full(r_max * s_max, -1, np.int8)
    dec = np.full(r_max * s_max, -1, np.int32)
    for x in range(r_max * s_max):
        xr, xs = divmod(x, s_max)
        if tab[xr, xs] < 0:
            continue
        vprev = None
        for ry in range(xr + 1, r_max):
            d = ry - xr
            yv = tab[ry] >= 0
            if d == 1:
                vprev = sp[ry - 1, xs] & yv
                continue
            pe = tab[ry - 1]
            pcre = np.where(pe >= 0, creator[np.clip(pe, 0, n - 1)], -1)
            pst = np.where((pcre >= 0) & (pcre < m), stake[np.clip(pcre, 0, m - 1)], 0)
            # the slot before p of p's creator (-1: none)
            dprev = [max((q for q in range(p) if pcre[q] == pcre[p]), default=-1)
                     if pcre[p] >= 0 else -1 for p in range(s_max)]
            yes = np.zeros(s_max, np.int64)
            no = np.zeros(s_max, np.int64)
            for p in range(s_max):
                if pcre[p] < 0:
                    continue
                count = ss[ry - 1, p].copy()        # over y
                if exact:
                    q = dprev[p]
                    while q >= 0:
                        count &= ~(ss[ry - 1, q] & (vprev[q] == vprev[p]))
                        q = dprev[q]
                (yes if vprev[p] else no)[count] += pst[p]
            vt = yes >= no
            sup = 3 * np.maximum(yes, no) > 2 * case["tot"]
            if d % case["coin_period"] == 0:
                coin_y = case["coin"][np.clip(tab[ry], 0, n - 1)] > 0
                vprev = np.where(sup, vt, coin_y) & yv
                continue
            deciding = np.flatnonzero(sup & yv)
            if deciding.size:
                famous[x], dec[x] = vt[deciding[0]], ry
                break
            vprev = vt & yv
    return famous, dec


@pytest.mark.parametrize("name", list(CASES))
def test_fame_scan_matches_reference(name):
    kind, stake_kind, make = CASES[name]
    case = make(_batch(kind, stake_kind))
    want = _reference(case)
    got = _port(kernels.fame_scan, case)
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.int32
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w), name
    # the pipeline's entry point is the wrapper
    via = _port(pipeline.fame_scan, case)
    assert all(torch.equal(a, b) for a, b in zip(via, got))
    # the kernel's algorithm agrees: each column alone, stopped when decided
    for g, w in zip(_emulate_kernel(case), want):
        assert np.array_equal(g, w), name
    famous, dec = want
    tab = case["tab"]
    valid = tab.reshape(-1) >= 0
    # outputs that could tell a wrong kernel: famous witnesses and others
    # (not famous, or undecided), decided in several rounds, empty slots
    # never decided
    assert (famous == 1).any() and (valid & (famous != 1)).any()
    assert len(set(dec[dec >= 0].tolist())) > 1
    assert (famous[~valid] == -1).all() and (dec[~valid] == -1).all()
    x_round = np.arange(tab.size) // tab.shape[1]
    if "two witnesses" in name:
        assert any(len(set(case["creator"][r[r >= 0]])) < (r >= 0).sum() for r in tab)
    if case["col_pos"] is not None:
        assert (case["col_pos"][tab[tab >= 0]] < 0).any()
    if "coin" in name:
        d = dec[dec >= 0] - x_round[dec >= 0]
        assert (d % case["coin_period"] != 0).all()     # coin rounds decide nothing
        assert (d > case["coin_period"]).any()          # past a coin round
        flipped = _reference(case, coin=1 - case["coin"])
        assert not all(np.array_equal(a, b) for a, b in zip(flipped, want))
    if "counted once" in name:
        # the per-creator rule decides this case: a sum over slots differs
        summed = _reference(case, has_forks=False)
        assert not all(np.array_equal(a, b) for a, b in zip(summed, want))
    if "2**24" in name:
        assert case["tot"] >= (1 << 24) and not case["has_forks"]
    if "undecided" in name:
        assert (~valid).any() and (valid & (famous < 0)).any()
    assert kernels.fame_scan.launches == 0


@pytest.mark.parametrize("name", list(CASES))
def test_fame_cells_are_the_kernels_reads(name):
    """The card route's cells, gathered with no host pull: ``sp[r - 1, p,
    y]`` and ``ss[r - 1, p, y]``, slot ``y`` of round ``r`` over slot ``p``
    of round ``r - 1``, with a witness without a column strongly seen by
    none."""
    kind, stake_kind, make = CASES[name]
    case = make(_batch(kind, stake_kind))
    tab, sees, ssm, cp = case["tab"], case["sees"], case["ssm"], case["col_pos"]
    sp, ss = kernels._fame_cells(t(tab), t(sees), t(ssm), None if cp is None else t(cp))
    r_max, s_max = tab.shape
    assert sp.dtype == ss.dtype == torch.bool
    assert tuple(sp.shape) == tuple(ss.shape) == (r_max - 1, s_max, s_max)
    we = np.clip(tab, 0, sees.shape[0] - 1)
    for r in range(1, r_max):
        y, p = we[r], we[r - 1]
        assert np.array_equal(sp[r - 1].numpy(), sees[y][:, p].T)
        if cp is None:
            assert np.array_equal(ss[r - 1].numpy(), ssm[y][:, p].T)
        else:
            pos = cp[p]
            cells = ssm[y][:, np.clip(pos, 0, None)] & (pos >= 0)[None, :]
            assert np.array_equal(ss[r - 1].numpy(), cells.T)


def test_group_rank_cells_are_one_gather_of_the_cells():
    """A row-sharded slab's cells (``parallel.gather_cells``): each rank
    puts the cells of the rows it owns, and their sum is the slab's."""
    case = _batch("forked")
    sees, tab = case["sees"], case["tab"]
    we = t(np.clip(tab, 0, sees.shape[0] - 1)).to(torch.int64)
    rows, cols = we[1:], we[:-1]
    want = kernels._cells(t(sees), rows, cols)
    half = sees.shape[0] // 2
    parts = [parallel.gather_cells(types.SimpleNamespace(rank=r), t(sees[r * half:(r + 1) * half]),
                                   rows, cols) for r in range(2)]
    assert torch.equal(parts[0] | parts[1], want)
    assert (parts[0] & parts[1]).sum() == 0 and want.any() and not want.all()


@pytest.mark.parametrize("kind", ["plain", "forked"])
def test_fame_order_cols_stage_matches_reference(kind):
    c = _columns(_batch(kind))
    n = c["sees"].shape[0]
    r_max, s_max = c["tab"].shape
    t_rank = np.arange(n, dtype=np.int32)
    self_parent = np.ascontiguousarray(c["parents"][:, 0])
    common = (c["tab"], c["cnt"], c["creator"], c["coin"], c["stake"], self_parent, t_rank)
    kw = dict(tot_stake=c["tot"], coin_period=c["coin_period"], r_max=r_max, s_max=s_max,
              chain=int(c["packed"].seq.max()) + 1, has_forks=c["has_forks"])
    want = ref.fame_order_cols_stage(
        jnp.asarray(c["anc"]), jnp.asarray(c["sees"]), jnp.asarray(c["ssm"]),
        jnp.asarray(c["col_pos"]), *(jnp.asarray(x) for x in common),
        jnp.int32(c["max_round"]), jnp.int32(c["packed"].n),
        matmul_dtype_name="float32", **kw,
    )
    got = pipeline.fame_order_cols_stage(
        t(c["anc"]), t(c["sees"]), t(c["ssm"]), t(c["col_pos"]), *(t(x) for x in common),
        c["max_round"], c["packed"].n, **kw,
    )
    assert set(got) == set(want)
    for key, w in want.items():
        assert np.array_equal(got[key].numpy(), np.asarray(w)), key
    assert (got["famous"] == 1).any() and (got["round_received"] >= 0).any()
    assert kernels.fame_scan.launches == 0


@pytest.mark.parametrize("kind", ["plain", "forked"])
def test_fame_window_stage_matches_reference(kind):
    c = _columns(_batch(kind))
    r_max, s_max = c["tab"].shape
    s_cap = s_max + 3                       # the window's slot capacity
    tab = np.full((r_max, s_cap), -1, np.int32)
    tab[:, :s_max] = c["tab"]
    r_fame = r_max - 2                      # the stage votes over its first rows
    args = (c["sees"], c["ssm"], c["col_pos"], tab, c["creator"], c["coin"], c["stake"])
    kw = dict(tot_stake=c["tot"], coin_period=c["coin_period"], r_max=r_fame,
              s_max=s_cap, has_forks=c["has_forks"])
    want = ref.fame_window_stage(*(jnp.asarray(x) for x in args),
                                 matmul_dtype_name="float32", **kw)
    got = inc.fame_window_stage(*(t(x) for x in args), **kw)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert (got[0] == 1).any() and (got[0][: r_fame * s_cap] < 0).any()
    assert kernels.fame_scan.launches == 0


def _good():
    c = _columns(_batch("forked"))
    args = [t(c["tab"]), t(c["sees"]), t(c["ssm"]), t(c["creator"]), t(c["coin"]),
            t(c["stake"]), c["tot"], c["coin_period"]]
    return args, dict(has_forks=True, col_pos=t(c["col_pos"]))


@pytest.mark.parametrize("fault,exc", [
    ("wit_table as int64", TypeError),
    ("sees as uint8", TypeError),
    ("creator as int64", TypeError),
    ("coin as float32", TypeError),
    ("col_pos as int64", TypeError),
    ("a 1-D witness table", ValueError),
    ("a non-square sees", ValueError),
    ("creator of the wrong length", ValueError),
    ("col_pos of the wrong length", ValueError),
    ("a full matrix of the wrong shape", ValueError),
    ("a coin period of 0", ValueError),
    ("a stake total outside the envelope", ValueError),
    ("tensors on two devices", ValueError),
])
def test_fame_scan_refuses(fault, exc):
    args, kw = _good()
    n = args[1].shape[0]
    if fault == "wit_table as int64":
        args[0] = args[0].to(torch.int64)
    elif fault == "sees as uint8":
        args[1] = args[1].to(torch.uint8)
    elif fault == "creator as int64":
        args[3] = args[3].to(torch.int64)
    elif fault == "coin as float32":
        args[4] = args[4].to(torch.float32)
    elif fault == "col_pos as int64":
        kw["col_pos"] = kw["col_pos"].to(torch.int64)
    elif fault == "a 1-D witness table":
        args[0] = args[0].reshape(-1)
    elif fault == "a non-square sees":
        args[1] = args[1][:, : n - 1].contiguous()
    elif fault == "creator of the wrong length":
        args[3] = args[3][:-1]
    elif fault == "col_pos of the wrong length":
        kw["col_pos"] = kw["col_pos"][:-1]
    elif fault == "a full matrix of the wrong shape":
        kw["col_pos"] = None
    elif fault == "a coin period of 0":
        args[7] = 0
    elif fault == "a stake total outside the envelope":
        args[6] = kernels.INT32_MAX // 3 + 1
    else:
        args[5] = torch.ones(args[5].shape, dtype=torch.int32, device="meta")
    with pytest.raises(exc):
        kernels.fame_scan(*args, **kw)
    assert kernels.fame_scan.launches == 0
