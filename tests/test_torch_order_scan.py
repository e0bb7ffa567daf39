"""The order scan's wrapper, ``kernels.order_scan``, on CPU tensors (where
it runs its plain version, ``order_scan_reference``) against the JAX
reference's ``order_scan``: round received, timestamp rank and received
flags exactly equal, on a fork-free and a forked DAG, a round whose only
famous witnesses are one creator's two (no unique famous witness), rounds
of an even number of unique famous witnesses (the lower median),
``max_round`` cutting the fame-complete prefix, received flags carried in
with the table's rows in a window's round frame, padding past
``n_valid``, a ``chain`` shorter than the longest self-chain, no chain
step (alone and with carried flags), timestamp ranks coarsened so that
medians tie, and rounds of more than 32 unique famous witnesses.  The
plain plan (``_order_plan``), a twin of the kernel's prologue (the plan a
block builds round by round) and a NumPy emulation of the kernel in its
order of work (a block of 32 events, the all-see test split over warps,
the self-chains tabulated a window of rows at a time and searched for the
first row that does not see an event, a radix select for the median) are
held to the same cases.  The scan on column windows (``cols``, as a group
rank runs its own events over their columns): the wrapper on views of the
windows' columns, the plain version and the emulation on each window,
assembled, equal the reference's whole call.  Then the port's
``fame_order_cols_stage`` and ``order_window_stage`` against the
reference's, the wrapper's refusals and its launch count, which stays 0 on
the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_swirld.config import SwirldConfig as RefConfig
from tpu_swirld.packing import pack_events
from tpu_swirld.sim import generate_gossip_dag
from tpu_swirld.tpu import pipeline as ref
from tpu_swirld_torch.gpu import incremental as inc
from tpu_swirld_torch.gpu import kernels, pipeline

INT32_MAX = np.iinfo(np.int32).max


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tiny ops: torch's CPU thread pool costs far more than it saves here
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.array(a))        # a writable copy


_BATCH = {}
#: kind -> generate_gossip_dag(members, events, seed, n_forkers, fork_prob)
DAGS = {"plain": (5, 500, 3, 0, 0.0), "forked": (7, 700, 1, 2, 0.1),
        # 40 unique famous witnesses a receiving round: a select over more
        # than one warp's lanes
        "wide": (40, 1600, 2, 0, 0.0)}


def _batch(kind):
    """The order scan's batch inputs on a seeded gossip DAG, every piece
    from the JAX reference: the ancestry closure, fork-aware sees, the
    strongly-sees matrix, the rounds scan's witness table (cut to its
    rounds) and fame."""
    if kind in _BATCH:
        return _BATCH[kind]
    m, n_events, seed, n_forkers, fork_prob = DAGS[kind]
    members, stake, events, _keys = generate_gossip_dag(
        m, n_events, seed=seed, n_forkers=n_forkers, fork_prob=fork_prob)
    packed = pack_events(events, members, stake)
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
    tab = np.array(tab)[:r_max]
    cnt = np.array(cnt)[:r_max]
    famous, _dec = ref.fame_scan(
        jnp.asarray(tab), sees, ssm, jnp.asarray(creator), jnp.asarray(coin),
        jnp.asarray(packed.stake), tot, RefConfig(n_members=m).coin_period,
        jnp.float32, has_forks=has_forks,
    )
    t_rank = np.unique(pad(packed.t, 0), return_inverse=True)[1].astype(np.int32).reshape(-1)
    _BATCH[kind] = dict(
        packed=packed, sees=np.array(sees), ssm=np.array(ssm), coin=coin, tot=tot,
        anc=np.array(anc), tab=tab, cnt=cnt, famous=np.array(famous),
        creator=creator, self_parent=np.ascontiguousarray(parents[:, 0]),
        t_rank=t_rank, max_round=max_round, n_valid=packed.n,
        chain=int(packed.seq.max()) + 1, received0=None,
    )
    return _BATCH[kind]


def _ufw(case):
    """NumPy: each round's unique famous witness events and whether the
    round lies in the fame-complete prefix (the reference's rules)."""
    tab, fam = case["tab"], case["famous"].reshape(case["tab"].shape)
    n = case["anc"].shape[0]
    rounds, prefix, going = [], [], True
    for r in range(tab.shape[0]):
        valid = tab[r] >= 0
        complete = (bool(((fam[r] >= 0) | ~valid).all())
                    and case["max_round"] >= r + 2 and case["cnt"][r] > 0)
        going = going and complete
        prefix.append(going)
        we = np.clip(tab[r], 0, n - 1)
        famous = valid & (fam[r] == 1)
        cre = case["creator"][we]
        rounds.append([int(we[s]) for s in range(tab.shape[1])
                       if famous[s] and (famous & (cre == cre[s])).sum() == 1])
    return rounds, prefix


# csrc/order_scan.cu's constants
EVENTS, WARPS, DEPTH, UNROLL, THREADS = 32, 16, 16, 8, 512


def _kernel_plan(case, r):
    """Twin of the kernel's prologue (``round_plan``) for round ``r``:
    None where ``r`` is not fame-complete (the block's round loop ends),
    else its unique famous witnesses' events, packed as the kernel packs
    them: a slot is unique when no other valid famous slot of the round has
    its creator, and a chunk of ``THREADS`` slots is compacted by each
    warp's ballot after the counts of the warps and chunks before it."""
    tab, anc = case["tab"], case["anc"]
    n, s_max = anc.shape[0], tab.shape[1]
    t = tab[r]
    f = case["famous"].reshape(tab.shape)[r]
    ev = np.clip(t, 0, n - 1)
    fam = (t >= 0) & (f == 1)
    cre = case["creator"][ev]
    if ((t >= 0) & (f < 0)).any() or not (case["max_round"] >= r + 2 and case["cnt"][r] > 0):
        return None
    packed = []
    for s0 in range(0, s_max, THREADS):
        slots = np.arange(s0, min(s0 + THREADS, s_max))
        unique = np.array([fam[s] and int((fam & (cre == cre[s])).sum()) == 1
                           for s in slots], bool)
        for w in range(0, slots.size, 32):            # warps in order
            ballot = unique[w : w + 32]
            packed.extend(int(ev[s]) for s in slots[w : w + 32][ballot])
    return packed


def _kernel_plans(case):
    """Every round's plan as a block meets it: the rounds up to the first
    one that is not fame-complete."""
    plans = []
    for r in range(case["tab"].shape[0]):
        ufw = _kernel_plan(case, r)
        if ufw is None:
            break
        plans.append(ufw)
    return plans


def _radix_lower_median(vals):
    """The kernel's select: the ``(len - 1) // 2``-th smallest int32 of
    ``vals``, over the values with the sign bit flipped, one bit a pass
    from the highest bit where the least and greatest value differ (the
    bits above it are every value's), each pass counting the candidates
    with the bit clear."""
    u = (vals.astype(np.int64) & 0xFFFFFFFF) ^ 0x80000000
    lo, hi = int(u.min()), int(u.max())
    if lo == hi:
        return int(np.array(lo ^ 0x80000000, np.uint32).view(np.int32))
    top = (lo ^ hi).bit_length() - 1
    want = (len(u) - 1) // 2
    prefix = 0 if top == 31 else lo >> (top + 1) << (top + 1)
    for b in range(top, -1, -1):
        above = 0 if b == 31 else (0xFFFFFFFF << (b + 1)) & 0xFFFFFFFF
        below = int((((u & above) == prefix) & (((u >> b) & 1) == 0)).sum())
        if want >= below:
            want -= below
            prefix |= 1 << b
    return int(np.array(prefix ^ 0x80000000, np.uint32).view(np.int32))


def _emulate_kernel(case, stats=None, cols=None):
    """``csrc/order_scan.cu`` in NumPy, in its order of work, over the
    events of the column window ``cols = (x0, x1)`` (all when None), read
    from the slab of those columns as the kernel reads it (event ``e`` at
    column ``e - x0``): a block of ``EVENTS`` consecutive events from
    ``x0`` meets the rounds of the prefix in turn
    (:func:`_kernel_plans`); its pending events are tested against every
    unique famous witness (each warp ANDs its share, the warps' ballots are
    ANDed); where some are received, each witness's self-chain is
    tabulated ``DEPTH`` rows at a time (ending at genesis or after
    ``chain`` steps), each event's value is the t_rank of its last leading
    row that sees it, a window is added only while some event saw every
    row of the last one, and the median is :func:`_radix_lower_median`.
    ``stats`` (a dict) gets the most windows a walk took and the events
    whose median value was tied."""
    sp, tr = case["self_parent"], case["t_rank"]
    n = case["anc"].shape[0]
    x0, x1 = (0, n) if cols is None else cols
    slab = np.ascontiguousarray(case["anc"][:, x0:x1])
    plans = _kernel_plans(case)
    recv0 = case["received0"]
    rr = np.full(x1 - x0, -1, np.int32)
    ts = np.zeros(x1 - x0, np.int32)
    stats = {} if stats is None else stats
    stats.update(windows=0, ties=0)
    for b0 in range(x0, x1, EVENTS):
        ev = np.arange(b0, min(b0 + EVENTS, x1))
        pending = ev < case["n_valid"]
        if recv0 is not None:
            pending &= ~recv0[ev]
        for r, ufw in enumerate(plans):
            if not pending.any():
                break
            nv = len(ufw)
            if nv == 0:
                continue
            newly = pending.copy()
            for w in range(WARPS):                  # one warp's share, ANDed
                for k in range(w, nv, WARPS):
                    newly &= slab[ufw[k], ev - x0]
            if not newly.any():
                continue
            val = np.full((nv, ev.size), INT32_MAX, np.int64)
            cur, left = list(ufw), [case["chain"]] * nv
            alive = [newly.copy() if case["chain"] > 0 else np.zeros_like(newly)
                     for _ in range(nv)]
            windows = 0
            while any(a.any() for a in alive):
                windows += 1
                for k in range(nv):
                    if not alive[k].any():
                        continue
                    rows = []
                    while len(rows) < DEPTH and left[k] > 0:
                        rows.append(cur[k])
                        left[k] -= 1
                        if sp[cur[k]] < 0:              # genesis
                            left[k] = 0
                            break
                        cur[k] = min(int(sp[cur[k]]), n - 1)
                    sees = slab[np.array(rows)][:, ev - x0]   # (rows, events)
                    seen = np.where(alive[k], np.cumprod(sees, axis=0).sum(axis=0), 0)
                    got = seen > 0
                    val[k, got] = tr[np.array(rows)][seen[got] - 1]
                    alive[k] = alive[k] & (seen == len(rows)) & (left[k] > 0)
            stats["windows"] = max(stats["windows"], windows)
            for lane in np.flatnonzero(newly):
                med = _radix_lower_median(val[:, lane])
                stats["ties"] += int((val[:, lane] == med).sum() > 1)
                rr[ev[lane] - x0], ts[ev[lane] - x0] = r, med
            pending &= ~newly
    received = rr >= 0 if recv0 is None else recv0[x0:x1] | (rr >= 0)
    return rr, ts, received


def _args(case, dev_fn):
    return (dev_fn(case["anc"]), dev_fn(case["tab"]), dev_fn(case["cnt"]),
            dev_fn(case["famous"]), dev_fn(case["creator"]),
            dev_fn(case["self_parent"]), dev_fn(case["t_rank"]))


def _reference(case):
    r0 = case["received0"]
    out = ref.order_scan(
        *_args(case, jnp.asarray), jnp.int32(case["max_round"]),
        jnp.int32(case["n_valid"]), chain=case["chain"],
        received0=None if r0 is None else jnp.asarray(r0),
    )
    return [np.asarray(x) for x in out]


def _no_ufw_round(case):
    """A forker's two witnesses of one prefix round made its only famous
    witnesses: the round has no unique famous witness and receives
    nothing."""
    tab, creator = case["tab"], case["creator"]
    _rounds, prefix = _ufw(case)
    r, pair = next(
        (r, np.flatnonzero((tab[r] >= 0) & (creator[np.clip(tab[r], 0, None)] == c)))
        for r in range(1, tab.shape[0]) if prefix[r]
        for c in np.unique(creator[tab[r][tab[r] >= 0]])
        if ((tab[r] >= 0) & (creator[np.clip(tab[r], 0, None)] == c)).sum() > 1
    )
    fam = case["famous"].reshape(tab.shape).copy()
    fam[r] = np.where(tab[r] >= 0, 0, fam[r])
    fam[r, pair[:2]] = 1
    return {**case, "famous": fam.reshape(-1), "cut_round": r}


def _even_nv(case):
    """Every prefix round with an odd number (3 or more) of unique famous
    witnesses loses one, so the median is a lower median."""
    rounds, prefix = _ufw(case)
    fam = case["famous"].reshape(case["tab"].shape).copy()
    for r, ws in enumerate(rounds):
        if prefix[r] and len(ws) % 2 and len(ws) >= 3:
            fam[r, list(case["tab"][r]).index(ws[-1])] = 0
    return {**case, "famous": fam.reshape(-1)}


def _window(case, r_base=2):
    """The table from round ``r_base`` on (the window's round frame), with
    the events the batch received before it carried in as received."""
    rr_full = _reference(case)[0]
    recv0 = (rr_full >= 0) & (rr_full < r_base + 1)
    rng = np.random.default_rng(5)
    recv0 |= rng.random(recv0.shape[0]) < 0.05
    return {**case, "tab": case["tab"][r_base:], "cnt": case["cnt"][r_base:],
            "famous": case["famous"].reshape(case["tab"].shape)[r_base:].reshape(-1),
            "max_round": case["max_round"] - r_base, "received0": recv0}


def _coarse_t_rank(case):
    """Timestamp ranks divided by 4: neighbouring ranks merge, so a
    median's value is often held by several witnesses."""
    return {**case, "t_rank": case["t_rank"] // 4}


CASES = {
    "fork-free": ("plain", lambda c: c),
    "forked": ("forked", lambda c: c),
    "a round with no unique famous witness": ("forked", _no_ufw_round),
    "even counts of unique famous witnesses": ("plain", _even_nv),
    "max_round cutting the prefix": ("plain", lambda c: {**c, "max_round": c["max_round"] - 3}),
    "received0 in a window's round frame": ("forked", _window),
    "padding past n_valid": ("forked", lambda c: {**c, "n_valid": c["n_valid"] - 7}),
    "chain shorter than the longest self-chain": ("plain", lambda c: {**c, "chain": 3}),
    "no chain step": ("plain", lambda c: {**c, "chain": 0}),
    "tied timestamp ranks": ("plain", _coarse_t_rank),
    "more than 32 unique famous witnesses": ("wide", lambda c: c),
    "no chain step with carried received flags": (
        "forked", lambda c: {**_window(c), "chain": 0}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_order_scan_matches_reference(name):
    kind, make = CASES[name]
    case = make(_batch(kind))
    want = _reference(case)
    r0 = case["received0"]
    got = kernels.order_scan(
        *_args(case, t), case["max_round"], case["n_valid"], chain=case["chain"],
        received0=None if r0 is None else t(r0),
    )
    for g, w in zip(got, want):
        assert g.dtype == {np.dtype(np.int32): torch.int32, np.dtype(bool): torch.bool}[w.dtype]
        assert np.array_equal(g.numpy(), w), name
    # the pipeline's entry point is the wrapper
    via = pipeline.order_scan(
        *_args(case, t), case["max_round"], case["n_valid"], chain=case["chain"],
        received0=None if r0 is None else t(r0),
    )
    assert all(torch.equal(a, b) for a, b in zip(via, got))
    # the kernel's algorithm agrees: the searched windows of tabulated
    # chain rows are exact on an ancestry closure
    stats = {}
    for g, w in zip(_emulate_kernel(case, stats), want):
        assert np.array_equal(g, w), name
    if case["chain"] > DEPTH:
        assert stats["windows"] > 1       # a walk went past its first window
    if name == "tied timestamp ranks":
        assert stats["ties"] > 0
    if name == "more than 32 unique famous witnesses":
        assert max(len(u) for u in _kernel_plans(case)) > 32
    rr, ts, received = want
    newly = rr >= 0
    # outputs that could tell a wrong kernel: received in several rounds,
    # not everything
    assert newly.any() and len(set(rr[newly].tolist())) > 1
    assert not newly[case["n_valid"]:].any() and not ts[~newly].any()
    if r0 is not None:
        assert not newly[r0].any() and received[r0].all()
    if "cut_round" in case:
        assert not (rr == case["cut_round"]).any()
    if case["chain"] == 0:
        assert (ts[newly] == INT32_MAX).all()
    if name == "max_round cutting the prefix":
        full = _reference(_batch(kind))[0]
        assert rr.max() < full.max()
    assert kernels.order_scan.launches == 0


@pytest.mark.parametrize("name", ["fork-free", "forked",
                                  "received0 in a window's round frame",
                                  "padding past n_valid", "no chain step"])
@pytest.mark.parametrize("edges", [(0, 256), (0, 96, 416), (0, 32, 33, 200, 480)])
def test_order_scan_on_column_windows_assembles_the_reference(name, edges):
    """The order scan over column windows, as a group rank runs its own
    events: the wrapper on each window's columns of ``anc`` (a view: its
    rows' stride is the whole slab's), the plain version on a contiguous
    copy and the kernel's NumPy emulation on the window, every window's
    outputs, assembled in order, equal to the JAX reference's whole call.
    The windows split the padded events unevenly: a block of the kernel
    starts at its window's first event."""
    kind, make = CASES[name]
    case = make(_batch(kind))
    want = _reference(case)
    n = case["anc"].shape[0]
    edges = (*edges[:-1], n)
    r0 = case["received0"]
    args = _args(case, t)
    parts = []
    for x0, x1 in zip(edges, edges[1:]):
        view = args[0][:, x0:x1]
        assert view.stride(0) == n
        kw = dict(chain=case["chain"], received0=None if r0 is None else t(r0),
                  cols=(x0, x1))
        got = kernels.order_scan(view, *args[1:], case["max_round"], case["n_valid"], **kw)
        plain = kernels.order_scan_reference(view.contiguous(), *args[1:], case["max_round"],
                                             case["n_valid"], **kw)
        emulated = _emulate_kernel(case, cols=(x0, x1))
        for g, p, e in zip(got, plain, emulated):
            assert g.shape == (x1 - x0,) and torch.equal(g, p)
            assert np.array_equal(g.numpy(), e)
        parts.append(got)
    for k, w in enumerate(want):
        assert np.array_equal(torch.cat([p[k] for p in parts]).numpy(), w), (name, k)
    assert (want[0] >= 0).any()
    assert kernels.order_scan.launches == 0


@pytest.mark.parametrize("name", list(CASES))
def test_order_plan_packs_each_rounds_unique_famous_witnesses(name):
    """The card route's plan, made with no host pull: each round's unique
    famous witnesses first in slot order, and their count where the round
    can receive (0 elsewhere)."""
    kind, make = CASES[name]
    case = make(_batch(kind))
    ufw_ev, nv = kernels._order_plan(
        t(case["tab"]), t(case["cnt"]), t(case["famous"]), t(case["creator"]),
        case["max_round"], case["anc"].shape[0],
    )
    rounds, prefix = _ufw(case)
    assert ufw_ev.dtype == nv.dtype == torch.int32
    assert tuple(ufw_ev.shape) == case["tab"].shape and ufw_ev.is_contiguous()
    for r, ws in enumerate(rounds):
        k = len(ws) if prefix[r] else 0
        assert int(nv[r]) == k
        assert ufw_ev[r, :k].tolist() == ws[:k]
    if name == "even counts of unique famous witnesses":
        assert any(int(v) % 2 == 0 and int(v) > 0 for v in nv)


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_prologue_matches_order_plan(name):
    """The plan each block of the kernel builds (its twin,
    :func:`_kernel_plans`) is the plain ``_order_plan``: the same unique
    famous witnesses in slot order in every round of the prefix, and no
    round past it."""
    kind, make = CASES[name]
    case = make(_batch(kind))
    ufw_ev, nv = kernels._order_plan(
        t(case["tab"]), t(case["cnt"]), t(case["famous"]), t(case["creator"]),
        case["max_round"], case["anc"].shape[0],
    )
    plans = _kernel_plans(case)
    assert plans and any(plans)
    for r in range(case["tab"].shape[0]):
        ufw = plans[r] if r < len(plans) else []
        assert int(nv[r]) == len(ufw), (name, r)
        assert ufw_ev[r, : len(ufw)].tolist() == ufw, (name, r)


@pytest.mark.parametrize("kind", ["plain", "forked"])
def test_fame_order_cols_stage_matches_reference(kind):
    c = _batch(kind)
    cfg = RefConfig(n_members=c["packed"].n_members)
    has_forks = kind == "forked"
    r_max, s_max = c["tab"].shape
    common = (c["tab"], c["cnt"], c["creator"], c["coin"], c["packed"].stake,
              c["self_parent"], c["t_rank"])
    want = ref.fame_order_cols_stage(
        jnp.asarray(c["anc"]), jnp.asarray(c["sees"]), jnp.asarray(c["ssm"]), None,
        *(jnp.asarray(x) for x in common), jnp.int32(c["max_round"]),
        jnp.int32(c["n_valid"]), tot_stake=c["tot"], coin_period=cfg.coin_period,
        r_max=r_max, s_max=s_max, chain=c["chain"], has_forks=has_forks,
        matmul_dtype_name="float32",
    )
    got = pipeline.fame_order_cols_stage(
        t(c["anc"]), t(c["sees"]), t(c["ssm"]), None, *(t(x) for x in common),
        c["max_round"], c["n_valid"], tot_stake=c["tot"], coin_period=cfg.coin_period,
        r_max=r_max, s_max=s_max, chain=c["chain"], has_forks=has_forks,
    )
    assert set(got) == set(want)
    for key, w in want.items():
        assert np.array_equal(got[key].numpy(), np.asarray(w)), key
    assert (got["round_received"] >= 0).any()
    assert kernels.order_scan.launches == 0


@pytest.mark.parametrize("kind", ["plain", "forked"])
def test_order_window_stage_matches_reference(kind):
    c = _window(_batch(kind))
    r_max, s_max = c["tab"].shape
    r_ord = r_max - 1                      # the stage reads its first rows
    args = (c["anc"], c["tab"], c["cnt"], c["famous"], c["creator"],
            c["self_parent"], c["t_rank"])
    want = ref.order_window_stage(
        *(jnp.asarray(x) for x in args), np.int32(c["max_round"]),
        np.int32(c["n_valid"]), jnp.asarray(c["received0"]),
        r_max=r_ord, s_max=s_max, chain=c["chain"],
    )
    got = inc.order_window_stage(
        *(t(x) for x in args), c["max_round"], c["n_valid"], t(c["received0"]),
        r_max=r_ord, s_max=s_max, s_used=inc._used_slots(c["tab"][:r_ord]),
        chain=c["chain"],
    )
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert (got[0] >= 0).any()
    assert kernels.order_scan.launches == 0


def _good():
    c = _batch("plain")
    return list(_args(c, t)), dict(max_round=c["max_round"], n_valid=c["n_valid"],
                                   chain=c["chain"], received0=None)


@pytest.mark.parametrize("fault,exc", [
    ("anc as uint8", TypeError),
    ("famous as int32", TypeError),
    ("t_rank as int64", TypeError),
    ("received0 as int8", TypeError),
    ("a non-square anc", ValueError),
    ("a 1-D witness table", ValueError),
    ("famous of the wrong length", ValueError),
    ("wit_count of the wrong length", ValueError),
    ("self_parent of the wrong length", ValueError),
    ("received0 of the wrong length", ValueError),
    ("a negative chain", ValueError),
    ("tensors on two devices", ValueError),
    ("a column window past the events", ValueError),
    ("anc wider than its column window", ValueError),
    ("an empty column window", ValueError),
    ("anc's columns strided", ValueError),
])
def test_order_scan_refuses(fault, exc):
    args, kw = _good()
    n = args[0].shape[0]
    if fault == "anc as uint8":
        args[0] = args[0].to(torch.uint8)
    elif fault == "famous as int32":
        args[3] = args[3].to(torch.int32)
    elif fault == "t_rank as int64":
        args[6] = args[6].to(torch.int64)
    elif fault == "received0 as int8":
        kw["received0"] = torch.zeros(n, dtype=torch.int8)
    elif fault == "a non-square anc":
        args[0] = args[0][:, : n - 1].contiguous()
    elif fault == "a 1-D witness table":
        args[1] = args[1].reshape(-1)
    elif fault == "famous of the wrong length":
        args[3] = args[3][:-1]
    elif fault == "wit_count of the wrong length":
        args[2] = args[2][:-1]
    elif fault == "self_parent of the wrong length":
        args[5] = args[5][:-1]
    elif fault == "received0 of the wrong length":
        kw["received0"] = torch.zeros(n - 1, dtype=torch.bool)
    elif fault == "a negative chain":
        kw["chain"] = -1
    elif fault == "a column window past the events":
        args[0], kw["cols"] = args[0][:, n - 8 :], (n - 8, n + 1)
    elif fault == "anc wider than its column window":
        args[0], kw["cols"] = args[0][:, :9], (0, 8)
    elif fault == "an empty column window":
        args[0], kw["cols"] = args[0][:, :0], (4, 4)
    elif fault == "anc's columns strided":
        args[0], kw["cols"] = args[0][:, 0:16:2], (0, 8)
    else:
        kw["max_round"] = torch.tensor(kw["max_round"], device="meta")
    with pytest.raises(exc):
        kernels.order_scan(*args, **kw)
    assert kernels.order_scan.launches == 0


def test_order_walks_counts_the_tabulated_rows():
    """``dev/order_walks.py``, which sized the kernel's window of chain
    rows: on a small DAG its walks each hold at least the witness's own
    row, and some walk is longer than one row."""
    from tpu_swirld_torch.dev.order_walks import walk_depths

    shape, nv, depths = walk_depths(5, 300, 3, "cpu")
    assert len(nv) == shape[0] and max(nv) > 0
    assert depths.size > 0 and depths.min() >= 1 and depths.max() > 1
