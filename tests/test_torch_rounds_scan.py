"""The rounds scan's wrapper, ``kernels.rounds_scan``, on CPU tensors (where
it runs its plain version, ``rounds_scan_reference``) against the JAX
reference's ``rounds_scan``, ``rounds_chunk_stage`` and
``rounds_span_stage``: all five carry outputs exactly equal, on fork-free
and forked DAGs, the full and the columns path (``col_pos`` holding -1),
``r_base > 0`` with a straggler below it, a full slot row, padding past
``n_valid`` and a late genesis.  Then the wrapper's refusals, its table
route and its launch count, which stays 0 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_swirld.tpu import pipeline as ref
from tpu_swirld_torch.gpu import kernels
from tests.test_torch_full import _slab_inputs


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tiny ops: torch's CPU thread pool costs far more than it saves here
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.array(a))        # a writable copy


def _inputs(kind):
    packed, _sees, ssm, parents, creator, _coin, tot = _slab_inputs(kind)
    return packed, ssm, parents, creator, tot


def _full_ref(parents, ssm, creator, stake, tot, n_valid, r_max, s_max, has_forks):
    return [np.asarray(x) for x in ref.rounds_scan(
        jnp.asarray(parents), jnp.asarray(ssm), jnp.asarray(creator),
        jnp.asarray(stake), tot, jnp.asarray(n_valid, dtype=jnp.int32),
        r_max=r_max, s_max=s_max, has_forks=has_forks,
    )]


def _window(full, start, r_base, r_max, s_max, rng):
    """The carry at ``start`` of a scan resumed from ``full``'s outputs:
    rounds and registrations of the events before ``start`` only, table
    rows from ``r_base`` on; and a column store holding every witness's
    column but one (``col_pos`` -1), in a seeded order."""
    rnd, wits, tab = full[0], full[1], full[2]
    n = rnd.shape[0]
    before = np.where((tab >= 0) & (tab < start), tab, -1)[r_base : r_base + r_max]
    tab_w = np.full((r_max, s_max), -1, np.int32)
    k = min(s_max, tab.shape[1])
    tab_w[: before.shape[0], :k] = before[:, :k]
    cnt_w = (tab_w >= 0).sum(1).astype(np.int32)
    early = np.arange(n) < start
    witnesses = np.unique(tab[tab >= 0])
    kept = rng.permutation(witnesses)[1:]
    col_pos = np.full((n,), -1, np.int32)
    col_pos[kept] = np.arange(kept.size, dtype=np.int32)
    carry = (np.where(early, rnd, 0).astype(np.int32), np.where(early, wits, False),
             tab_w, cnt_w)
    return carry, col_pos, kept


#: case -> (DAG, reference function, r_base, r_max, s_max, overflow bits expected)
CASES = {
    "full, fork-free": ("plain", "rounds_scan", 0, 32, None, 0),
    "full, forked": ("forked", "rounds_scan", 0, 32, None, 0),
    "full, a full slot row": ("forked", "rounds_scan", 0, 32, 2, kernels.OVF_SLOT),
    "columns chunk, fork-free": ("plain", "rounds_chunk_stage", 0, 32, None, 0),
    "columns chunk, forked": ("forked", "rounds_chunk_stage", 0, 32, None, 0),
    "span of 2 chunks, forked, r_base 1": ("forked", "rounds_span_stage", 1, 16, None, 0),
    "r_base 2 and a straggler below it": ("plain", "straggler", 2, 16, None,
                                          kernels.OVF_ROUND),
    "padding past n_valid and a late genesis": ("forked", "padding", 0, 32, None, 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rounds_scan_matches_reference(case):
    kind, fn, r_base, r_max, s_max, want_ovf = CASES[case]
    packed, ssm, parents, creator, tot = _inputs(kind)
    stake = packed.stake
    n = parents.shape[0]
    s_max = s_max or packed.n_members + 3
    has_forks = bool(len(packed.fork_pairs))
    assert has_forks == (kind == "forked")
    n_valid = packed.n
    rng = np.random.default_rng(17)
    launches0 = kernels.rounds_scan.launches

    if fn == "rounds_scan":
        want = _full_ref(parents, ssm, creator, stake, tot, n_valid, r_max, s_max,
                         has_forks)
        carry = (torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.bool),
                 torch.full((r_max, s_max), -1, dtype=torch.int32),
                 torch.zeros(r_max, dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
        kernels.rounds_scan(parents, t(ssm), None, t(creator), t(stake), *carry,
                            start=0, n_valid=n_valid, r_base=0, tot_stake=tot,
                            has_forks=has_forks)
        start, length = 0, n
    else:
        full = _full_ref(parents, ssm, creator, stake, tot, n_valid, 32,
                         packed.n_members + 3, has_forks)
        assert int(full[4]) == 0 and int(full[0].max()) >= 3
        length = 64
        # the 64 events of the DAG's second half that register the most witnesses
        starts = range((packed.n // 2) // 32 * 32, packed.n - length, 32)
        start = max(starts, key=lambda s: int(full[1][s : s + length].sum()))
        if fn == "padding":
            start = (packed.n - 40) // 32 * 32    # the span crosses n_valid
            n_valid = packed.n - 5                # real events past it pad too
            parents = parents.copy()
            parents[start + 3] = -1               # a late genesis
            assert start < n_valid < packed.n < start + length
        elif fn == "straggler":
            parents = parents.copy()
            low = int(np.where(full[0] == 0)[0][1])
            mid = int(np.where((full[0] == 1) & (np.arange(n) < start))[0][0])
            parents[start + 9] = (low, mid)       # round 1 > round 0: a witness below r_base
        carry_np, col_pos, _kept = _window(full, start, r_base, r_max, s_max, rng)
        assert (col_pos == -1).any() and (col_pos[np.unique(full[2][full[2] >= 0])] == -1).any()
        cols = np.concatenate([_kept, np.zeros((-_kept.size) % 8, _kept.dtype)])
        ssm_c = np.ascontiguousarray(ssm[:, cols])
        jargs = (jnp.asarray(parents), jnp.asarray(ssm_c), jnp.asarray(col_pos),
                 jnp.asarray(creator), jnp.asarray(stake), np.int32(n_valid),
                 *(jnp.asarray(x) for x in carry_np), jnp.zeros((), jnp.int32),
                 np.int32(start), np.int32(r_base))
        statics = dict(tot_stake=tot, r_max=r_max, s_max=s_max, has_forks=has_forks)
        if fn == "rounds_span_stage":
            want = ref.rounds_span_stage(*jargs, **statics, chunk=32, k_chunks=2)
        else:
            want = ref.rounds_chunk_stage(*jargs, **statics, chunk=length)
        want = [np.asarray(x) for x in want]
        carry = (*(t(x) for x in carry_np), torch.zeros(1, dtype=torch.int32))
        kernels.rounds_scan(parents, t(ssm_c[start : start + length]), t(col_pos),
                            t(creator), t(stake), *carry, start=start, n_valid=n_valid,
                            r_base=r_base, tot_stake=tot, has_forks=has_forks)

    for g, w in zip(carry, want):
        assert np.array_equal(g.numpy().reshape(np.shape(w)), w), case
    assert int(carry[4][0]) == want_ovf
    span = slice(start, start + length)
    if want_ovf == 0:
        # the span registers witnesses and promotes: a wrong step shows
        assert carry[1][span].any() and len(set(carry[0][span].tolist())) > 1
    if fn == "padding":
        assert not carry[1][n_valid : start + length].any()
        assert not carry[0][n_valid : start + length].any()
        assert carry[1][start + 3]                # the late genesis is a witness
    assert kernels.rounds_scan.launches == launches0 == 0


def _good_args():
    packed, ssm, parents, creator, tot = _inputs("plain")
    n = parents.shape[0]
    carry = [torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.bool),
             torch.full((8, 9), -1, dtype=torch.int32), torch.zeros(8, dtype=torch.int32),
             torch.zeros(1, dtype=torch.int32)]
    args = [parents, t(ssm), None, t(creator), t(packed.stake), *carry]
    kw = dict(start=0, n_valid=packed.n, r_base=0, tot_stake=tot, has_forks=False)
    return args, kw


@pytest.mark.parametrize("fault,exc", [
    ("ssm as int8", TypeError),
    ("creator as int64", TypeError),
    ("a 1-D witness table", ValueError),
    ("col_pos of the wrong length", ValueError),
    ("a full matrix of the wrong width", ValueError),
    ("parents short of the span", ValueError),
    ("a span past n", ValueError),
    ("stake outside the int32 envelope", ValueError),
])
def test_rounds_scan_refuses(fault, exc):
    args, kw = _good_args()
    n = args[5].shape[0]
    if fault == "ssm as int8":
        args[1] = args[1].to(torch.int8)
    elif fault == "creator as int64":
        args[3] = args[3].to(torch.int64)
    elif fault == "a 1-D witness table":
        args[7] = args[7].reshape(-1)
    elif fault == "col_pos of the wrong length":
        args[2] = torch.full((n - 1,), -1, dtype=torch.int32)
        args[1] = args[1][:, :16].contiguous()
    elif fault == "a full matrix of the wrong width":
        args[1] = args[1][:, : n - 1].contiguous()
    elif fault == "parents short of the span":
        args[0] = args[0][: n - 1]
    elif fault == "a span past n":
        kw["start"] = 1
    else:
        kw["tot_stake"] = kernels.INT32_MAX // 3 + 1
    with pytest.raises(exc):
        kernels.rounds_scan(*args, **kw)
    assert kernels.rounds_scan.launches == 0


@pytest.mark.parametrize("r_max,s_max,members,forks,route,nbytes", [
    (192, 65, 64, False, "shared", 4 * (192 * 65 + 192)),      # config 3 columns pass
    (192, 2019, 64, True, "global", 4 * 64),                   # config 4, forks
    (16, 257, 256, False, "shared", 4 * (16 * 257 + 16)),      # config 5's window
])
def test_rounds_scan_route(r_max, s_max, members, forks, route, nbytes):
    assert kernels.rounds_scan_route(r_max, s_max, members, forks) == (route, nbytes)
