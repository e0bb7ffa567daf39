"""The order scan's wrapper, ``kernels.order_scan``, on CPU tensors (where
it runs its plain version, ``order_scan_reference``) against the JAX
reference's ``order_scan``: round received, timestamp rank and received
flags exactly equal, on a fork-free and a forked DAG, a round whose only
famous witnesses are one creator's two (no unique famous witness), rounds
of an even number of unique famous witnesses (the lower median),
``max_round`` cutting the fame-complete prefix, received flags carried in
with the table's rows in a window's round frame, padding past
``n_valid``, and a ``chain`` shorter than the longest self-chain.  The
card route's host-side plan (``_order_plan``) and a NumPy emulation of the
kernel (one event at a time, the walk stopped at the first self-ancestor
that does not see the event, a counting select for the median) are held
to the same cases.  Then the port's ``fame_order_cols_stage`` and
``order_window_stage`` against the reference's, the wrapper's refusals
and its launch count, which stays 0 on the CPU."""

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
DAGS = {"plain": (5, 500, 3, 0, 0.0), "forked": (7, 700, 1, 2, 0.1)}


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


def _emulate_kernel(case):
    """``csrc/order_scan.cu``'s algorithm in NumPy, one event at a time."""
    anc, sp, tr = case["anc"], case["self_parent"], case["t_rank"]
    n = anc.shape[0]
    rounds, prefix = _ufw(case)
    recv0 = case["received0"]
    received = np.zeros(n, bool) if recv0 is None else recv0.copy()
    rr = np.full(n, -1, np.int32)
    ts = np.zeros(n, np.int32)
    for e in range(min(case["n_valid"], n)):
        if received[e]:
            continue
        for r, ws in enumerate(rounds):
            if not (prefix[r] and ws) or not all(anc[w, e] for w in ws):
                continue
            vals = []
            for w in ws:
                cur, v = w, INT32_MAX
                for _ in range(case["chain"]):
                    if not anc[cur, e]:
                        break
                    v = tr[cur]
                    if sp[cur] < 0:
                        break
                    cur = sp[cur]
                vals.append(v)
            want = (len(vals) - 1) // 2
            ts[e] = next(v for v in vals if sum(u < v for u in vals) <= want
                         < sum(u <= v for u in vals))
            rr[e], received[e] = r, True
            break
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
    # the kernel's algorithm agrees: the early-stopped walk is exact on an
    # ancestry closure
    for g, w in zip(_emulate_kernel(case), want):
        assert np.array_equal(g, w), name
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
        r_max=r_ord, s_max=s_max, chain=c["chain"],
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
    else:
        kw["max_round"] = torch.tensor(kw["max_round"], device="meta")
    with pytest.raises(exc):
        kernels.order_scan(*args, **kw)
    assert kernels.order_scan.launches == 0
