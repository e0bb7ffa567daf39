"""Fame voting's wrapper, ``kernels.fame_scan``, on CPU tensors (where it
runs its plain version, ``fame_scan_reference``) against the JAX
reference's ``fame_scan``: ``famous`` and ``decided_at`` exactly equal, on
a fork-free DAG and a forked one (a creator with two witnesses in one
round; witnesses given shared creators, two or three a round, where a
stake counted twice would decide), the column store with absent columns
(``col_pos`` -1), a coin period short enough that coin rounds decide
nothing and coin bits move the votes, a coin round where a super tally
overrides the coin bit, non-uniform stake (1-5, and up to 2**20 a member:
many bit-planes), a stake total at or past 2**24 without forks (the
reference's int32 path), empty slots with undecided top rounds, more than
32 and more than 256 witnesses a round, and a slot capacity far above the
used width.  A NumPy emulation of the card's kernel in its order of work
(blocks of a round's slots, a warp a slot, each round's width read from
the table, the plan of stake bit-planes and forked creators' runs, tiles
of staged strongly-sees rows, a ballot for the first decider), reading the
slabs as the kernel does (or a group rank's gathered cells), is held to the
reference on the same cases at two launch shapes, and its plan to the plain
``kernels._fame_plan``.  Then the port's ``fame_order_cols_stage`` and
``fame_window_stage`` against the reference's (the window stage on the
whole table, at config 4's slot capacity through the emulation), a group
rank's cell gather, the launch shape and its slot limit, the wrapper's
refusals and its launch count, which stays 0 on the CPU."""

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
DAGS = {"plain": (5, 500, 3, 0, 0.0), "forked": (7, 700, 1, 2, 0.1),
        "forty": (40, 2400, 5, 2, 0.1)}
_BATCH = {}


def _stake(kind, stake, m):
    rng = np.random.default_rng(11)
    if kind == "skewed":
        return rng.integers(1, 6, m).astype(np.int32)
    if kind == "huge":                  # each member 2**22: the total past 2**24
        return np.full(m, 1 << 22, np.int32)
    if kind == "huge skewed":           # 2**22 to 2**23 each: past 2**24, many planes
        return rng.integers(1 << 22, 1 << 23, m).astype(np.int32)
    if kind == "planes":                # 1 to 2**20 each: twenty bit-planes
        return rng.integers(1, 1 << 20, m).astype(np.int32)
    return np.asarray(stake, np.int32)


def _batch(kind, stake_kind="uniform"):
    """Fame's batch inputs on a seeded gossip DAG, every piece from the JAX
    reference: fork-aware sees, the strongly-sees matrix and the rounds
    scan's witness table, cut to its rounds and used slots."""
    key = (kind, stake_kind)
    if key in _BATCH:
        return _BATCH[key]
    if kind in ("wide", "runs"):
        _BATCH[key] = _wide_batch() if kind == "wide" else _runs_batch()
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
    assert has_forks == (n_forkers > 0)
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


def _wide_batch():
    """A seeded synthetic table of 6 rounds x 300 slots (each slot a
    witness, a thirtieth emptied), 300 members of stake 1-5 (no forks):
    slot ``x`` is seen by a share ``q_x`` of the next round's witnesses,
    ``q_x`` 0.05, 0.5 or 0.97, and strongly seen by 0.85 of every round's
    witnesses, so that slots decide both ways two rounds on and some
    later or never."""
    rng = np.random.default_rng(21)
    r_max, s_max, m = 6, 300, 300
    n = 1920
    tab = (np.arange(r_max)[:, None] * s_max + np.arange(s_max)[None, :]).astype(np.int32)
    tab[rng.random(tab.shape) < 1 / 30] = -1
    creator = (np.arange(n) % m).astype(np.int32)
    q = rng.choice([0.05, 0.5, 0.97], size=n, p=[0.3, 0.2, 0.5])
    stake = rng.integers(1, 6, m).astype(np.int32)
    return dict(
        packed=None, sees=rng.random((n, n)) < q[None, :],
        ssm=rng.random((n, n)) < 0.85, col_pos=None, tab=tab,
        cnt=(tab >= 0).sum(1).astype(np.int32), creator=creator,
        coin=rng.integers(0, 2, n).astype(np.uint8), stake=stake,
        tot=int(stake.sum()), coin_period=10, has_forks=False,
    )


def _runs_batch():
    """A seeded synthetic forked table of 6 rounds x 100 slots whose
    creators make long runs in the kernel's plan: in every round slots
    0-69 belong to member 0 (a run across three mask words, one of them
    whole), slots 70-84 to members 1-5 three each (runs across a word's
    end) and slots 85-99 to members 6-20 one each; stake 1-5; cells as in
    :func:`_wide_batch`."""
    rng = np.random.default_rng(33)
    r_max, s_max, m, n = 6, 100, 21, 640
    tab = (np.arange(r_max)[:, None] * s_max + np.arange(s_max)[None, :]).astype(np.int32)
    slot = np.arange(n) % s_max
    creator = np.where(slot < 70, 0, np.where(slot < 85, 1 + (slot - 70) // 3, slot - 79))
    q = rng.choice([0.05, 0.5, 0.97], size=n, p=[0.3, 0.2, 0.5])
    stake = rng.integers(1, 6, m).astype(np.int32)
    return dict(
        packed=None, sees=rng.random((n, n)) < q[None, :],
        ssm=rng.random((n, n)) < 0.85, col_pos=None, tab=tab,
        cnt=(tab >= 0).sum(1).astype(np.int32), creator=creator.astype(np.int32),
        coin=rng.integers(0, 2, n).astype(np.uint8), stake=stake,
        tot=int(stake.sum()), coin_period=10, has_forks=True,
    )


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


def _three_witnesses(case):
    """In every second round the witnesses of slots 1, 2 and 3 given the
    creator of slot 0: a forker's four witnesses of one round, a stake that
    counted more than once would decide."""
    cre, tab = case["creator"].copy(), case["tab"]
    for r in range(0, tab.shape[0], 2):
        if (tab[r, :4] >= 0).all():
            cre[tab[r, 1:4]] = cre[tab[r, 0]]
    return {**case, "creator": cre, "has_forks": True}


def _coin_super(case):
    """A coin round every third round and a seeded 35% of the
    strongly-sees cells dropped: slots undecided two rounds on meet a coin
    round where some tallies are super and vote against their coin bit,
    and others vote their coin bit."""
    rng = np.random.default_rng(10)
    return {**case, "coin_period": 3,
            "ssm": case["ssm"] & (rng.random(case["ssm"].shape) >= 0.35)}


def _capacity(case, s_cap=128):
    """The table padded with empty slots to ``s_cap`` a round, far above
    the used width, as a window's slot capacity is."""
    tab = np.full((case["tab"].shape[0], s_cap), -1, np.int32)
    tab[:, : case["tab"].shape[1]] = case["tab"]
    return {**case, "tab": tab}


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
    "stakes up to 2**20, forked: many bit-planes": ("forked", "planes", lambda c: c),
    "stake total past 2**24 without forks, many bit-planes": ("plain", "huge skewed",
                                                              lambda c: c),
    "a creator's three witnesses in one round": ("plain", "skewed", _three_witnesses),
    "a coin round where the super tally and the coin bit disagree": ("plain", "uniform",
                                                                     _coin_super),
    "more than 32 witnesses a round, forked": ("forty", "uniform", lambda c: c),
    "more than 256 witnesses a round": ("wide", "uniform", lambda c: c),
    "a slot capacity far above the used width": ("plain", "uniform", _capacity),
    "forked creators' runs across mask words": ("runs", "uniform", lambda c: c),
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


_U32 = 0xFFFFFFFF


def _ballot(bits) -> int:
    """``__ballot_sync`` of up to 32 lanes' bools, lane ``i`` bit ``i``."""
    bits = np.asarray(bits, bool)
    return int((bits.astype(np.uint64) << np.arange(bits.size, dtype=np.uint64)).sum())


def _words(bits, n_words=None):
    """A bit row as uint32 words, word ``k`` the ballot of bits ``[32 k, 32
    k + 32)``."""
    bits = np.asarray(bits, bool)
    k = -(-bits.size // 32) if n_words is None else n_words
    pad = np.zeros(32 * k, bool)
    pad[: bits.size] = bits
    return (pad.reshape(k, 32).astype(np.uint64)
            << np.arange(32, dtype=np.uint64)).sum(1).astype(np.uint32)


def _int32(u):
    """A uint32 sum (as int64) read as int32, the kernel's casts."""
    u = np.asarray(u, np.int64) & _U32
    return np.where(u >= 1 << 31, u - (1 << 32), u)


def _kernel_width(row) -> int:
    """``scan_width``: one past the row's last witness slot, from a ballot
    over each 32 slots (``32 c + 32 - clz``)."""
    best = 0
    for c in range(-(-row.size // 32)):
        b = _ballot(row[32 * c : 32 * c + 32] >= 0)
        if b:
            best = 32 * c + b.bit_length()
    return best


def _kernel_plan(tab, r, P, creator, stake, exact):
    """The plan a fame block builds for round ``r`` (its first ``P``
    slots), in the kernel's passes: the stake planes as words ``(32, PW)``
    over the plan's positions, the OR of the slots' stakes, the slot at
    each position, and the words of M (a run's positions but its last)
    and E (a run's last position).  Without ``exact`` a position is its
    slot (lane ``b`` keeps the ballot of stake bit ``b``) and M and E are
    empty.  With it pass A marks the slots whose creator has another slot
    (and those not their creator's last), pass B places the other slots
    first in slot order and the forked ones after them by (creator,
    slot), and sets the stake bits at the position of a slot of its own
    creator or a run's last."""
    n, m = creator.shape[0], stake.shape[0]
    PW = -(-P // 32)
    pe = np.full(32 * PW, -1, np.int64)
    pe[:P] = tab[r, :P]
    c = np.where(pe >= 0, creator[np.clip(pe, 0, n - 1)], -1)
    c = np.where((c >= 0) & (c < m), c, -1)
    s = np.where(c >= 0, stake[np.clip(c, 0, m - 1)].astype(np.int64) & _U32, 0)
    sor = int(np.bitwise_or.reduce(s)) if s.size else 0
    none = np.zeros(PW, np.uint32)
    if not exact:
        planes = np.stack([_words((s >> b) & 1, PW) for b in range(32)])
        return planes, sor, np.arange(P), none, none
    c, s = c[:P], s[:P]
    q = np.arange(P)
    dup = np.array([x >= 0 and (c == x).sum() > 1 for x in c], bool)
    last = np.array([not (c[p + 1 :] == c[p]).any() for p in range(P)], bool)
    D = int(dup.sum())
    perm = np.zeros(P, np.int64)
    bits = np.zeros(32 * PW, np.int64)
    runm = np.zeros(32 * PW, bool)
    ende = np.zeros(32 * PW, bool)
    for p in range(P):
        below = int((dup & (q < p)).sum())
        rank = int((dup & ((c < c[p]) | ((c == c[p]) & (q < p)))).sum())
        pos = P - D + rank if dup[p] else p - below
        perm[pos] = p
        bits[pos] = s[p] if (not dup[p] or last[p]) else 0
        if dup[p]:
            (ende if last[p] else runm)[pos] = True
    planes = np.stack([_words((bits >> b) & 1, PW) for b in range(32)])
    return planes, sor, perm, _words(runm, PW), _words(ende, PW)


def _tally(rows, vp, planes, sor, runm, ende):
    """32 lanes' ``(yes, no)`` (uint32 values in int64), word by word: a
    lane's yes and no sets (its staged row with and without the slot's
    votes), each word's runs replaced by their last position where the
    run meets the set (``((a & M) + M + carry) | a`` at E, the carry out
    of the word continuing a run), then the plane popcounts."""
    yes = np.zeros(32, np.int64)
    no = np.zeros(32, np.int64)
    carry = [np.zeros(32, np.int64), np.zeros(32, np.int64)]
    for k in range(rows.shape[1]):
        sets = [rows[:, k] & vp[k], rows[:, k] & ~vp[k]]
        m, e = int(runm[k]), int(ende[k])
        if m | e:
            for i in range(2):
                a = sets[i].astype(np.int64)
                t = (a & m) + m + carry[i]
                carry[i] = t >> 32
                sets[i] = ((a & ~(m | e)) | (((t & _U32) | a) & e)).astype(np.uint32)
        for b in range(32):
            if sor >> b & 1:
                yes += np.bitwise_count(sets[0] & planes[b][k]).astype(np.int64) << b
                no += np.bitwise_count(sets[1] & planes[b][k]).astype(np.int64) << b
    return yes & _U32, no & _U32


def _emulate_kernel(case, shape=None, cells=False):
    """``csrc/fame_scan.cu`` in its order of work, in NumPy: for each round
    ``xr`` its blocks of ``warps`` slots (a warp a slot); a block whose
    slots are all empty does nothing; the voters of round ``xr + 1`` vote
    sees as ballots over each 32; then for each later round its width from
    the table, the plan of round ``ry - 1`` (:func:`_kernel_plan`), each
    slot's votes permuted into the plan's order, the strongly-sees rows
    staged in that order (from the slabs by witness index, or with
    ``cells`` from ``kernels._fame_cells``, a group rank's input) and
    tallied a tile of voters at a time, 32 lanes a chunk
    (:func:`_tally`), the first deciding voter the first lane of the first
    chunk whose ballot is set.  A block stops once its slots are decided,
    or at an empty round with none after it.  ``shape`` is ``(warps,
    ss_words, _)`` (default :func:`kernels.fame_launch_shape`).  Returns
    ``(famous, decided_at, stats)``."""
    tab, creator, coin, stake = case["tab"], case["creator"], case["coin"], case["stake"]
    sees, ssm, cp = case["sees"], case["ssm"], case["col_pos"]
    r_max, s_max = tab.shape
    n = sees.shape[0]
    exact = case["has_forks"] or case["tot"] >= (1 << 24)
    warps, ss_words, _smem = shape or kernels.fame_launch_shape(s_max, exact)
    if cells:
        sp, sc = (x.numpy() for x in kernels._fame_cells(
            t(tab), t(sees), t(ssm), None if cp is None else t(cp)))
    famous = np.full(r_max * s_max, -1, np.int8)
    dec = np.full(r_max * s_max, -1, np.int32)
    stats = dict(tiles=0, words=0, runs=0, runs_across_words=0, planes=0,
                 super_against_coin=0)
    for xr in range(r_max - 1):
        for x0 in range(0, s_max, warps):
            live = [xs for xs in range(x0, x0 + warps) if xs < s_max and tab[xr, xs] >= 0]
            if not live:
                continue
            Y = _kernel_width(tab[xr + 1])
            ye = tab[xr + 1, :Y]
            votes = {}
            for xs in live:
                v = np.zeros(Y, bool)
                ok = ye >= 0
                if cells:
                    v[ok] = sp[xr, xs, :Y][ok]
                else:
                    v[ok] = sees[np.minimum(ye[ok], n - 1), min(int(tab[xr, xs]), n - 1)]
                votes[xs] = _words(v)
            P = Y
            for ry in range(xr + 2, r_max):
                planes, sor, perm, runm, ende = _kernel_plan(tab, ry - 1, P, creator, stake,
                                                             exact)
                Y = _kernel_width(tab[ry])
                if Y == 0:
                    if not (tab[ry + 1 :] >= 0).any():
                        break
                    P = 0
                    continue
                PW = -(-P // 32)
                TY = (ss_words // (PW | 1)) & ~31
                ye = tab[ry, :Y]
                yc = np.clip(ye, 0, n - 1)
                pe = tab[ry - 1, perm]              # positions in the plan's order
                if cells:
                    col = np.where(pe >= 0, perm, -1)
                    cellv = sc[ry - 1, perm, :Y].T
                else:
                    col = np.where(pe >= 0, np.minimum(pe, n - 1), -1)
                    if cp is not None:
                        col = np.where(pe >= 0, cp[np.clip(pe, 0, n - 1)], -1)
                    cellv = ssm[yc[:, None], np.maximum(col, 0)[None, :]]
                staged = (ye >= 0)[:, None] & (col >= 0)[None, :] & cellv
                srow = np.stack([_words(b, PW) for b in staged])
                coin_round = (ry - xr) % case["coin_period"] == 0
                new = {xs: np.zeros(-(-Y // 32), np.uint32) for xs in live}
                # each slot's votes (slot order) in the plan's order
                ordered = {xs: _words(((votes[xs][perm >> 5] >> (perm & 31).astype(np.uint32)) & 1)
                                      == 1, PW) for xs in live}
                for t0 in range(0, Y, TY):
                    ty = min(TY, Y - t0)
                    for xs in list(live):
                        for c in range(-(-ty // 32)):
                            y = t0 + c * 32 + np.arange(32)
                            inside = y < t0 + ty
                            rows = np.zeros((32, PW), np.uint32)
                            rows[inside] = srow[y[inside]]
                            yes, no = _tally(rows, ordered[xs], planes, sor, runm, ende)
                            vt = _int32(yes) >= _int32(no)
                            sup = _int32(3 * np.where(vt, yes, no)) > 2 * case["tot"]
                            yv = np.zeros(32, bool)
                            yv[inside] = ye[y[inside]] >= 0
                            if coin_round:
                                cb = np.zeros(32, bool)
                                cb[inside] = coin[yc[y[inside]]] > 0
                                vote, el = np.where(sup, vt, cb) & yv, np.zeros(32, bool)
                                stats["super_against_coin"] += int((sup & yv & (vt != cb)).sum())
                            else:
                                vote, el = vt & yv, sup & yv
                            new[xs][(t0 >> 5) + c] = _ballot(vote)
                            if el.any():
                                f = int(np.argmax(el))
                                famous[xr * s_max + xs] = vt[f]
                                dec[xr * s_max + xs] = ry
                                live.remove(xs)
                                break
                    if not live:
                        break
                stats["tiles"] = max(stats["tiles"], -(-Y // TY))
                stats["words"] = max(stats["words"], PW)
                stats["runs"] = max(stats["runs"], sum(bin(int(x)).count("1") for x in ende))
                stats["runs_across_words"] += sum(int(x) >> 31 for x in runm)
                stats["planes"] = max(stats["planes"], bin(sor).count("1"))
                if not live:
                    break
                votes, P = new, Y
    return famous, dec, stats


def _min_tile_shape(s_max):
    """8 warps and the least tile of staged rows: several tiles a round
    once a round is wider than 32 slots."""
    return 8, 32 * (((s_max + 31) // 32) | 1), None


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
    # the kernel's algorithm agrees, at its launch shape on the slabs, and
    # at 8 warps with the least tile on a group rank's cells
    *emulated, stats = _emulate_kernel(case)
    for g, w in zip(emulated, want):
        assert np.array_equal(g, w), name
    *emulated, small = _emulate_kernel(case, _min_tile_shape(case["tab"].shape[1]), cells=True)
    for g, w in zip(emulated, want):
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
    if "2**20" in name:
        assert stats["planes"] >= 15 and stats["runs"] > 0
    if "many bit-planes" in name:
        assert stats["planes"] >= 5
    if "three witnesses" in name:
        assert any(np.bincount(case["creator"][r[r >= 0]]).max() >= 3 for r in tab)
        summed = _reference(case, has_forks=False)
        assert not all(np.array_equal(a, b) for a, b in zip(summed, want))
    if "disagree" in name:
        assert stats["super_against_coin"] > 0
    if "more than 32" in name:
        assert stats["words"] >= 2 and small["tiles"] >= 2 and stats["runs"] > 0
    if "more than 256" in name:
        assert stats["words"] >= 9 and stats["tiles"] == 1 and small["tiles"] >= 9
    if "across mask words" in name:
        assert stats["runs_across_words"] >= 3 and stats["runs"] >= 6
        summed = _reference(case, has_forks=False)
        assert not all(np.array_equal(a, b) for a, b in zip(summed, want))
    if "capacity" in name:
        used = max(_kernel_width(r) for r in tab)
        assert tab.shape[1] >= 20 * used
    assert kernels.fame_scan.launches == 0


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_prologue_matches_fame_plan(name):
    """The plan a fame block builds as it reaches a round (the twin
    ``_kernel_width`` / ``_kernel_plan``, in the kernel's passes) against
    the plain ``kernels._fame_plan`` from the table: each round's width,
    the stake bit-planes, and each forked creator's slots as one run
    headed by its first slot, the runs in creator order with the
    creator's stake."""
    kind, stake_kind, make = CASES[name]
    case = make(_batch(kind, stake_kind))
    tab, creator, stake = case["tab"], case["creator"], case["stake"]
    n = case["sees"].shape[0]
    width, planes, head = (x.numpy() for x in kernels._fame_plan(
        t(tab), t(creator), t(stake), n))
    assert width.dtype == head.dtype == np.int32 and planes.dtype == bool
    n_runs = 0
    for r in range(tab.shape[0]):
        w = _kernel_width(tab[r])
        assert w == width[r]
        for exact in (False, True):
            pw, sor, perm, runm, ende = _kernel_plan(tab, r, w, creator, stake, exact)
            assert sorted(perm.tolist()) == list(range(w))
            unpack = lambda x: ((x[..., None] >> np.arange(32, dtype=np.uint32)) & 1 == 1
                                ).reshape(*x.shape[:-1], -1)
            bits, m_bits, e_bits = unpack(pw), unpack(runm), unpack(ende)
            assert not bits[:, w:].any() and not planes[r][:, w:].any()
            assert sor == _ballot(planes[r].any(axis=1))
            if not exact:
                assert np.array_equal(perm, np.arange(w)) and not (m_bits.any() or e_bits.any())
                assert np.array_equal(bits[:, :w], planes[r][:, :w])
                continue
            # the runs: each a range ending at an E bit, its other positions M
            runs, lo = [], None
            for pos in range(w):
                if m_bits[pos] or e_bits[pos]:
                    lo = pos if lo is None else lo
                    if e_bits[pos]:
                        runs.append(perm[lo : pos + 1].tolist())
                        lo = None
            assert lo is None
            groups = {p: min(g) for g in runs for p in g}
            assert groups == {int(p): int(head[r, p]) for p in np.flatnonzero(head[r] >= 0)}
            # the other slots first in slot order, the runs after them in
            # creator order, each its slots in order; a position's stake
            # bits are its slot's, but a run's only at its last position
            n_other = w - len(groups)
            assert perm[:n_other].tolist() == sorted(set(range(w)) - set(groups))
            assert not (m_bits[:n_other].any() or e_bits[:n_other].any())
            cre = [int(creator[tab[r, g[0]]]) for g in runs]
            assert cre == sorted(set(cre))
            assert all(g == sorted(g) and len(g) >= 2 for g in runs)
            assert np.array_equal(bits[:, :w][:, ~m_bits[:w]], planes[r][:, perm][:, ~m_bits[:w]])
            assert not bits[:, :w][:, m_bits[:w]].any()
            n_runs += len(runs)
    if not case["has_forks"]:
        assert n_runs == 0
    if "witnesses in one round" in name or "counted once" in name:
        assert n_runs > 0


@pytest.mark.parametrize("name", list(CASES))
def test_fame_cells_are_the_kernels_reads(name):
    """The cells a group rank's route gathers for the kernel (and the
    cells the kernel reads from plain slabs itself), with no host pull:
    ``sp[r - 1, p, y]`` and ``ss[r - 1, p, y]``, slot ``y`` of round ``r``
    over slot ``p`` of round ``r - 1``, with a witness without a column
    strongly seen by none."""
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


def test_fame_window_stage_without_the_cut_at_config4_capacity(monkeypatch):
    """``fame_window_stage`` votes over the whole table at the window's slot
    capacity, config 4's 2 019 slots a round of which a forked window uses
    about 15: no slot cut is pulled (``incremental._used_slots`` is not
    called) and the fame call gets the table whole.  The card's kernel,
    emulated on that call, equals the reference's window fame over the used
    slots, padded with empty slots (the reference ignores them; the plain
    version at 2 019 slots is a slots x members x slots matmul a round, too
    large for a test)."""
    c = _columns(_batch("forked"))
    r_max, s_used = c["tab"].shape
    s_cap = 2019
    tab = np.full((r_max, s_cap), -1, np.int32)
    tab[:, :s_used] = c["tab"]
    r_fame = r_max - 2
    rest = (c["creator"], c["coin"], c["stake"])
    kw = dict(tot_stake=c["tot"], coin_period=c["coin_period"], r_max=r_fame,
              has_forks=c["has_forks"])
    want = ref.fame_window_stage(
        *(jnp.asarray(x) for x in (c["sees"], c["ssm"], c["col_pos"], c["tab"], *rest)),
        s_max=s_used, matmul_dtype_name="float32", **kw)
    calls = []

    def emulated(wit_table, sees, ssm, creator, coin, stake, tot, coin_period, *,
                 has_forks, col_pos):
        calls.append(tuple(wit_table.shape))
        case = dict(tab=wit_table.numpy(), sees=sees.numpy(), ssm=ssm.numpy(),
                    col_pos=col_pos.numpy(), creator=creator.numpy(), coin=coin.numpy(),
                    stake=stake.numpy(), tot=tot, coin_period=coin_period,
                    has_forks=has_forks)
        famous, dec, _stats = _emulate_kernel(case)
        return torch.from_numpy(famous), torch.from_numpy(dec)

    def no_cut(*_args):
        raise AssertionError("fame_window_stage pulled a slot cut")

    monkeypatch.setattr(inc, "fame_scan", emulated)
    monkeypatch.setattr(inc, "_used_slots", no_cut)
    got = inc.fame_window_stage(
        *(t(x) for x in (c["sees"], c["ssm"], c["col_pos"], tab, *rest)), s_max=s_cap, **kw)
    assert calls == [(r_fame, s_cap)]
    for g, w in zip(got, want):
        padded = np.full((r_fame, s_cap), -1, np.asarray(w).dtype)
        padded[:, :s_used] = np.asarray(w).reshape(r_fame, s_used)
        assert g.shape == (r_fame * s_cap,)
        assert np.array_equal(g.numpy(), padded.reshape(-1))
    assert (got[0] == 1).any() and (got[1] >= 0).any()


def test_fame_launch_shape():
    """The launch shape comes from the slot capacity alone: 16 warps and a
    tile that holds a whole round's voters at the shapes the main path
    gives (64, 192, 256 slots), a 48 KB tile at config 4's capacity of
    2 019, then the least tile and 8 warps, and a ``ValueError`` past a
    block's shared memory; the bytes are the kernel's carve."""
    for s_max, exact in [(64, False), (192, True), (256, False), (2019, True),
                         (16000, True), (18000, True), (23000, False)]:
        warps, ss_words, smem = kernels.fame_launch_shape(s_max, exact)
        sw = (s_max + 31) // 32
        assert smem == 4 * kernels._fame_smem_words(s_max, warps, ss_words, exact)
        assert smem <= kernels._FS_SMEM_LIMIT and ss_words >= 32 * (sw | 1)
        assert warps in (8, 16)
        if s_max <= 256:
            assert (warps, ss_words) == (16, 32 * sw * (sw | 1))
    assert kernels.fame_launch_shape(2019, True)[:2] == (16, kernels._FS_SS_WORDS)
    assert kernels.fame_launch_shape(18000, True)[0] == 8
    for s_max, exact in [(18600, True), (23300, False), (40000, False)]:
        with pytest.raises(ValueError, match="shared memory"):
            kernels.fame_launch_shape(s_max, exact)


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
