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
from tests.test_torch_kernels import _sees_from_sim


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


def _case(case):
    """The inputs of one ``CASES`` entry and the JAX reference's outputs:
    ``(kw, want)``, ``kw`` the port's ``rounds_scan`` arguments as numpy
    arrays (``carry`` the four carry arrays in)."""
    kind, fn, r_base, r_max, s_max, _want_ovf = CASES[case]
    packed, ssm, parents, creator, tot = _inputs(kind)
    stake = packed.stake
    n = parents.shape[0]
    s_max = s_max or packed.n_members + 3
    has_forks = bool(len(packed.fork_pairs))
    assert has_forks == (kind == "forked")
    n_valid = packed.n
    rng = np.random.default_rng(17)
    if fn == "rounds_scan":
        want = _full_ref(parents, ssm, creator, stake, tot, n_valid, r_max, s_max,
                         has_forks)
        carry = (np.zeros(n, np.int32), np.zeros(n, bool),
                 np.full((r_max, s_max), -1, np.int32), np.zeros(r_max, np.int32))
        return dict(parents=parents, ssm_rows=ssm, col_pos=None, creator=creator,
                    stake=stake, carry=carry, start=0, n_valid=n_valid, r_base=0,
                    tot=tot, has_forks=has_forks), want
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
    return dict(parents=parents, ssm_rows=ssm_c[start : start + length],
                col_pos=col_pos, creator=creator, stake=stake, carry=carry_np,
                start=start, n_valid=n_valid, r_base=r_base, tot=tot,
                has_forks=has_forks), [np.asarray(x) for x in want]


def _port(kw, check_cap=None):
    """The port's ``rounds_scan`` on CPU tensors (its plain version):
    the five carry outputs and, with ``check_cap``, the check buffer."""
    carry = (*(t(x) for x in kw["carry"]), torch.zeros(1, dtype=torch.int32))
    check = None if check_cap is None else torch.full((kernels.CHECK_HEAD + check_cap,), 7,
                                                      dtype=torch.int32)
    kernels.rounds_scan(
        kw["parents"], t(kw["ssm_rows"]), None if kw["col_pos"] is None else t(kw["col_pos"]),
        t(kw["creator"]), t(kw["stake"]), *carry, start=kw["start"],
        n_valid=kw["n_valid"], r_base=kw["r_base"], tot_stake=kw["tot"],
        has_forks=kw["has_forks"], check=check)
    out = [x.numpy() for x in carry]
    return out if check is None else (out, check.numpy())


@pytest.mark.parametrize("case", list(CASES))
def test_rounds_scan_matches_reference(case):
    _kind, fn, _r_base, _r_max, _s_max, want_ovf = CASES[case]
    launches0 = kernels.rounds_scan.launches
    kw, want = _case(case)
    got = _port(kw)
    start, length, n_valid = kw["start"], kw["ssm_rows"].shape[0], kw["n_valid"]
    for g, w in zip(got, want):
        assert np.array_equal(g.reshape(np.shape(w)), w), case
    assert int(got[4][0]) == want_ovf
    span = slice(start, start + length)
    if want_ovf == 0:
        # the span registers witnesses and promotes: a wrong step shows
        assert got[1][span].any() and len(set(got[0][span].tolist())) > 1
    if fn == "padding":
        assert not got[1][n_valid : start + length].any()
        assert not got[0][n_valid : start + length].any()
        assert got[1][start + 3]                  # the late genesis is a witness
    assert kernels.rounds_scan.launches == launches0 == 0


# ------------------------------------------------- the kernel's step order


def host_check(rnd, tab, col_pos, parents, start, length, cap):
    """The check buffer as the drivers' host test computed it before the
    kernel wrote one: ``np.unique`` over the table, ``col_pos < 0``, and
    the "affected" test over the span (the reference's clips on
    out-of-range ids)."""
    n = rnd.shape[0]
    out = np.full(kernels.CHECK_HEAD + cap, -1, np.int32)
    out[1:3] = 0
    if col_pos is None:
        return out
    entries = tab[tab >= 0]
    raw = entries[col_pos[np.minimum(entries, n - 1)] < 0]
    if raw.size > cap:
        out[1], out[2] = -1, 0
        return out
    missing = np.unique(raw)
    ce = np.arange(start, start + length)
    p = parents[ce].astype(np.int64)
    r0 = np.where(p[:, 0] < 0, -1, np.maximum(rnd[np.clip(p[:, 0], 0, n - 1)],
                                              rnd[np.clip(p[:, 1], 0, n - 1)]))
    affected = any(w < start or np.any((ce > w) & (r0 == rnd[min(w, n - 1)]))
                   for w in missing)
    out[1], out[2] = missing.size, int(affected)
    out[kernels.CHECK_HEAD : kernels.CHECK_HEAD + missing.size] = missing
    return out


def emulate_kernel(kw, warps, check_cap=kernels.CHECK_CAP):
    """NumPy emulation of ``csrc/rounds_scan.cu``'s step order: runs by the
    ballot rule (the longest prefix of at most ``warps`` events whose
    clipped parents lie before its first; the first event, genesis and
    padding always join), each run's rounds from the table as it stood at
    the run's start (per slot, or per member with forks, through the
    slot's column), then registration in event order, cut before the first
    event whose row an earlier event of the run wrote where it strongly
    sees that witness or the slot lay below the row's bound at the step's
    start (past the row's last entry and its count).  Returns ``(outputs,
    check, runs)``, ``runs`` the ``(first event, events kept)`` of each
    step."""
    parents, ssm_rows, col_pos = kw["parents"], kw["ssm_rows"], kw["col_pos"]
    creator, stake, tot = kw["creator"], kw["stake"], kw["tot"]
    rnd, wits, tab, cnt = (np.array(x) for x in kw["carry"])
    start, n_valid, r_base = kw["start"], kw["n_valid"], kw["r_base"]
    n, (r_max, s_max), m = rnd.shape[0], tab.shape, stake.shape[0]
    length, n_cols = ssm_rows.shape
    end = start + length
    stop = min(end, max(n_valid, start))
    ovf = 0
    runs = []
    hi = [max([s + 1 for s in range(s_max) if tab[r, s] >= 0] + [min(max(int(cnt[r]), 0), s_max)])
          for r in range(r_max)]

    def pos(w):
        wc = min(w, n - 1)
        return wc if col_pos is None else int(col_pos[wc])

    def sees(i, w):
        p = pos(w)
        return p >= 0 and bool(ssm_rows[i - start, min(p, n_cols - 1)])

    i0 = start
    while i0 < stop:
        run = 1
        while run < warps and i0 + run < stop:
            p1, p2 = parents[i0 + run]
            if p1 >= 0 and not (min(p1, n - 1) < i0 and min(max(p2, 0), n - 1) < i0):
                break
            run += 1
        events = []
        for k in range(run):            # the run's warps, on the table at its start
            i = i0 + k
            p1, p2 = (int(x) for x in parents[i])
            if p1 < 0:
                events.append((0, -1, True, set()))
                continue
            q1, q2 = min(p1, n - 1), min(max(p2, 0), n - 1)
            r0 = max(int(rnd[q1]), int(rnd[q2]))
            row = min(max(r0 - r_base, 0), r_max - 1)
            amount, members = 0, set()
            if row == r0 - r_base:
                for w in tab[row]:
                    if w < 0 or not sees(i, w):
                        continue
                    cre = int(creator[min(w, n - 1)])
                    if kw["has_forks"]:
                        if 0 <= cre < m:
                            members.add(cre)
                    else:
                        amount += int(stake[min(max(cre, 0), m - 1)])
                amount += sum(int(stake[c]) for c in members)
            else:
                row = -1
            r = r0 + int(3 * amount > 2 * tot)
            seen = {kk for kk in range(k) if sees(i, i0 + kk)}
            events.append((r, row, r > int(rnd[q1]), seen))
        writes, keep = [], run          # registration in event order
        h0 = list(hi)
        for k, (r, row, wit, seen) in enumerate(events):
            if row >= 0 and any(wr == row and (ws < h0[wr] or kk in seen)
                                for kk, wr, ws in writes):
                keep = k
                break
            rc = min(max(r - r_base, 0), r_max - 1)
            in_window = rc == r - r_base
            slot = int(cnt[rc])
            if wit and not in_window:
                ovf |= kernels.OVF_ROUND
            if wit and slot >= s_max:
                ovf |= kernels.OVF_SLOT
            if wit and in_window and slot < s_max:
                writes.append((k, rc, slot))
                tab[rc, max(slot, 0)] = i0 + k
                cnt[rc] += 1
                hi[rc] = max(hi[rc], slot + 1)
            rnd[i0 + k], wits[i0 + k] = r, wit
        runs.append((i0, keep))
        i0 += keep
    rnd[stop:end], wits[stop:end] = 0, False
    out = [rnd, wits, tab, cnt, np.array([ovf], np.int32)]
    check = host_check(rnd, tab, col_pos, parents, start, length, check_cap)
    check[0] = ovf
    return out, check, runs


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_step_order_matches_reference(case):
    """The kernel's step order, emulated, equals the JAX reference on every
    case, at the kernel's own warp count and at 2 warps (more runs cut
    short by the block), and takes several events a step."""
    kw, want = _case(case)
    m = kw["stake"].shape[0]
    _got, check = _port(kw, check_cap=kernels.CHECK_CAP)
    for warps in (kernels.RS_WARPS, 2):
        out, emu_check, runs = emulate_kernel(kw, warps)
        for g, w in zip(out, want):
            assert np.array_equal(g.reshape(np.shape(w)), w), (case, warps)
        assert np.array_equal(emu_check, check), (case, warps)
        assert max(k for _i, k in runs) > 1 and len(runs) < kw["ssm_rows"].shape[0]


def _forked_pair_case(see_both):
    """A 5-member DAG with one forker whose fork pair (two consecutive
    events, their parents below both) are both witnesses of one round;
    with ``see_both`` the events after the pair that read its row also
    strongly see both of them (so the member's stake must count once)."""
    packed, sees = _sees_from_sim(5, 300, seed=1, forkers=1)
    n_pad = sees.shape[0]
    pad = n_pad - packed.n
    parents = np.concatenate([packed.parents, np.full((pad, 2), -1, np.int32)])
    creator = np.concatenate([packed.creator, np.zeros((pad,), np.int32)])
    stake = np.array([3, 1, 2, 5, 1], np.int32)
    tot = int(stake.sum())
    ssm = np.array(ref.ssm_matrix(jnp.asarray(sees), jnp.asarray(packed.member_table),
                                  jnp.asarray(stake), tot, jnp.float32))
    first = _full_ref(parents, ssm, creator, stake, tot, packed.n, 32, 8, True)
    rnd, wits = first[0], first[1]
    pairs = [(min(a, b), max(a, b)) for _m, a, b in packed.fork_pairs]
    a, b = next((a, b) for a, b in pairs
                if b == a + 1 and wits[a] and wits[b] and rnd[a] == rnd[b])
    if see_both:
        ssm = ssm.copy()
        readers = [e for e in range(b + 1, packed.n)
                   if parents[e, 0] >= 0 and max(rnd[parents[e, 0]],
                                                 rnd[max(parents[e, 1], 0)]) == rnd[a]]
        ssm[readers, a] = ssm[readers, b] = True
    kw = dict(parents=parents, ssm_rows=ssm, col_pos=None, creator=creator, stake=stake,
              carry=(np.zeros(n_pad, np.int32), np.zeros(n_pad, bool),
                     np.full((32, 8), -1, np.int32), np.zeros(32, np.int32)),
              start=0, n_valid=packed.n, r_base=0, tot=tot, has_forks=True)
    want = _full_ref(parents, ssm, creator, stake, tot, packed.n, 32, 8, True)
    return kw, want, (a, b)


def _chunked(kw, edges):
    """``kw`` cut into calls at ``edges`` (event ids inside the span)."""
    start, length = kw["start"], kw["ssm_rows"].shape[0]
    bounds = [start, *edges, start + length]
    for lo, hi in zip(bounds, bounds[1:]):
        yield dict(kw, start=lo, ssm_rows=kw["ssm_rows"][lo - start : hi - start])


@pytest.mark.parametrize("case", ["fork pair in one run", "fork pair seen by later events",
                                  "a row fills in the middle of a run",
                                  "a run across a chunk edge", "the genesis run"])
def test_kernel_step_order_edge_cases(case):
    if case.startswith("fork pair"):
        kw, want, (a, b) = _forked_pair_case(see_both=case.endswith("later events"))
        out, _check, runs = emulate_kernel(kw, kernels.RS_WARPS)
        for g, w in zip(out, want):
            assert np.array_equal(g.reshape(np.shape(w)), w)
        assert any(i0 <= a and b < i0 + k for i0, k in runs)    # one step takes both
        row = int(out[0][a])
        slots = [int(np.where(out[2][row] == e)[0][0]) for e in (a, b)]
        assert slots[1] == slots[0] + 1                         # in event order
        if case.endswith("later events"):
            rnd = out[0]
            assert any(kw["ssm_rows"][e, a] and kw["ssm_rows"][e, b]
                       and max(rnd[kw["parents"][e, 0]], rnd[max(kw["parents"][e, 1], 0)])
                       == rnd[a] for e in range(b + 1, kw["n_valid"]))
    elif case == "a row fills in the middle of a run":
        # a run that registers two witnesses in one row, resumed with that
        # row one slot short of full: the first takes the last slot, the
        # second sets OVF_SLOT, in the same step
        base, _want = _case("full, fork-free")
        _out, _check, runs = emulate_kernel(base, 8)
        full = _full_ref(base["parents"], base["ssm_rows"], base["creator"], base["stake"],
                         base["tot"], base["n_valid"], 32, 8, False)
        n = base["parents"].shape[0]
        found = None
        for i0, k in runs[1:]:
            rounds = full[0][i0 : i0 + k][full[1][i0 : i0 + k]]
            for row in sorted(set(rounds.tolist())):
                if (rounds == row).sum() < 2:
                    continue
                s_max = int(((full[2][row] >= 0) & (full[2][row] < i0)).sum()) + 1
                carry, _cp, _kept = _window(full, i0, 0, 32, s_max, np.random.default_rng(3))
                kw = dict(base, carry=carry, start=i0, ssm_rows=base["ssm_rows"][i0 : i0 + 32])
                out, _check, runs2 = emulate_kernel(kw, 8)
                mine = [e for e in range(i0, i0 + k) if out[1][e] and out[0][e] == row]
                if (runs2[0] == (i0, k) and len(mine) >= 2
                        and out[2][row, s_max - 1] == mine[0] and out[4][0] & kernels.OVF_SLOT):
                    found = (kw, carry, s_max)
                    break
            if found:
                break
        assert found is not None
        kw, carry, s_max = found
        want = [np.asarray(x) for x in ref.rounds_chunk_stage(
            jnp.asarray(kw["parents"]), jnp.asarray(base["ssm_rows"]),
            jnp.arange(n, dtype=jnp.int32), jnp.asarray(kw["creator"]),
            jnp.asarray(kw["stake"]), np.int32(kw["n_valid"]),
            *(jnp.asarray(x) for x in carry), jnp.zeros((), jnp.int32),
            np.int32(kw["start"]), np.int32(0), tot_stake=kw["tot"], r_max=32,
            s_max=s_max, has_forks=False, chunk=32)]
        for g, w in zip(out, want):
            assert np.array_equal(g.reshape(np.shape(w)), w)
    elif case == "a run across a chunk edge":
        kw, want = _case("columns chunk, forked")
        _out, _check, runs = emulate_kernel(kw, 8)
        i0, k = next((i0, k) for i0, k in runs if k > 1 and i0 > kw["start"])
        parts = list(_chunked(kw, [i0 + 1]))     # the edge cuts the run
        state = [np.array(x) for x in kw["carry"]]
        ovf = 0
        for part in parts:
            out, _check, runs_p = emulate_kernel(dict(part, carry=state), 8)
            got = _port(dict(part, carry=state))
            for g, e in zip(got[:4], out[:4]):
                assert np.array_equal(g, e)
            state, ovf = out[:4], ovf | int(out[4][0])
            assert runs_p[0][0] == part["start"]    # runs restart at the edge
        for g, w in zip(state + [np.array([ovf])], want):
            assert np.array_equal(g.reshape(np.shape(w)), w)
        return
    else:
        for kind in ("plain", "forked"):
            kw, want = _case(f"full, {'fork-free' if kind == 'plain' else 'forked'}")
            m = kw["stake"].shape[0]
            genesis = int(np.argmax(kw["parents"][:, 0] >= 0))
            out, _check, runs = emulate_kernel(kw, 32)
            for g, w in zip(out, want):
                assert np.array_equal(g.reshape(np.shape(w)), w)
            assert runs[0] == (0, genesis) and genesis >= 3
            assert list(out[2][0, :genesis]) == list(range(genesis))   # slot order
            assert all(out[1][:genesis]) and not any(out[0][:genesis])
            assert genesis <= m
        return
    for g, w in zip(_port(kw), want):
        assert np.array_equal(g.reshape(np.shape(w)), w)


@pytest.mark.parametrize("seed", range(6))
def test_check_buffer_matches_host_test(seed):
    """The plain version's check buffer equals the drivers' former host
    test over seeded random carries, tables (duplicates, -1 slots, ids past
    n), ``col_pos`` (-1 and past the store) and parents, at ``r_base`` 0
    and above, with a list that holds every missing witness and one that
    does not."""
    rng = np.random.default_rng(100 + seed)
    n, m = 300, 7
    r_max, s_max = (6, 9) if seed % 2 else (12, 20)
    r_base = (0, 0, 2, 5, 1, 3)[seed]
    start, length = 40 + 17 * seed, 64
    parents = np.stack([rng.integers(-1, np.maximum(np.arange(n), 1)),
                        rng.integers(-1, np.maximum(np.arange(n), 1))], 1).astype(np.int32)
    parents[rng.random(n) < 0.1, 0] = -1
    c = n // 3
    tab = rng.integers(-1, n + 8, (r_max, s_max)).astype(np.int32)
    tab[rng.random((r_max, s_max)) < 0.4] = -1
    col_pos = rng.integers(-1, c + 4, n).astype(np.int32)
    col_pos[rng.random(n) < 0.2] = -1
    kw = dict(parents=parents, ssm_rows=rng.random((length, c)) < 0.6, col_pos=col_pos,
              creator=rng.integers(0, m, n).astype(np.int32),
              stake=rng.integers(1, 50, m).astype(np.int32),
              carry=(rng.integers(r_base, r_base + r_max + 2, n).astype(np.int32),
                     rng.random(n) < 0.3, tab,
                     rng.integers(0, s_max + 1, r_max).astype(np.int32)),
              start=start, n_valid=start + length - 9, r_base=r_base, has_forks=bool(seed % 2))
    kw["tot"] = int(kw["stake"].sum())
    out, _check = _port(kw, check_cap=1)
    raw = int((col_pos[np.minimum(out[2][out[2] >= 0], n - 1)] < 0).sum())
    for cap in (kernels.CHECK_CAP, max(raw - 1, 1)):
        out, check = _port(kw, check_cap=cap)
        want = host_check(out[0], out[2], col_pos, parents, start, length, cap)
        want[0] = out[4][0]
        assert np.array_equal(check, want), cap
        assert (check[1] >= 0) == (raw <= cap)
        emu_out, emu_check, _runs = emulate_kernel(kw, kernels.RS_WARPS, cap)
        for g, e in zip(out, emu_out):
            assert np.array_equal(g, e)
        assert np.array_equal(emu_check, check)
    assert raw > 0 and check[1] == -1
    # the full matrix's columns are events: nothing lacks one
    kw_full = dict(kw, col_pos=None, ssm_rows=rng.random((length, n)) < 0.6)
    _out, check = _port(kw_full, check_cap=8)
    assert list(check[1:]) == [0, 0] + [-1] * 8


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


# bytes: the staged span inputs (512 events x 20), counts and row bounds
# (8 a row), stake (4 a member), each warp's member mask with forks (32
# warps x 2 words at 64 members), and the table with its slot info (12 a
# slot) when it fits
@pytest.mark.parametrize("r_max,s_max,members,forks,route,nbytes", [
    (192, 65, 64, False, "shared",                             # config 3 columns pass
     20 * 512 + 8 * 192 + 4 * 64 + 12 * 192 * 65),
    (192, 2019, 64, True, "global",                            # config 4, forks
     20 * 512 + 8 * 192 + 4 * 64 + 4 * 32 * 2),
    (16, 257, 256, False, "shared",                            # config 5's window
     20 * 512 + 8 * 16 + 4 * 256 + 12 * 16 * 257),
])
def test_rounds_scan_route(r_max, s_max, members, forks, route, nbytes):
    assert kernels.rounds_scan_plan(r_max, s_max, members, forks) == (route, nbytes)


def test_rounds_scan_plan_counts_the_check():
    # a table that fits beside the fixed words alone, but not with a check
    # list of CHECK_CAP entries (12 bytes each): a columns call keeps it in
    # device memory
    fixed = 20 * 512 + 8 * 64 + 4 * 64
    assert kernels.rounds_scan_plan(64, 284, 64, False) == ("shared", fixed + 12 * 64 * 284)
    assert kernels.rounds_scan_plan(64, 284, 64, False, kernels.CHECK_CAP) == (
        "global", fixed + 12 * kernels.CHECK_CAP)


@pytest.mark.parametrize("path,forkers", [("columns pass", 0),
                                          ("incremental, chunk loop", 0),
                                          ("incremental, fused span", 4)])
def test_full_check_list_reads_the_table(path, forkers, monkeypatch):
    """Every check buffer holds one entry, so each chunk or span call whose
    table has two or more witnesses without a column finds its list full
    and reads the table and the rounds instead (``pipeline.table_check``,
    its "affected" test included): the columns pass and both incremental
    loops still equal the JAX reference exactly."""
    from tpu_swirld.config import SwirldConfig as RefConfig
    from tpu_swirld.packing import pack_events
    from tpu_swirld.sim import generate_gossip_dag
    from tpu_swirld_torch.gpu import pipeline
    from tests.test_torch_incremental import drive_both, fixed_chunks
    from tests.test_torch_pipeline import run_both

    new_check = kernels.new_check
    monkeypatch.setattr(kernels, "new_check", lambda device, cap=1: new_check(device, 1))
    members, stake, events, _keys = generate_gossip_dag(16, 1000, seed=2,
                                                        n_forkers=forkers)
    cfg = RefConfig(n_members=16)
    before = pipeline.table_check.calls
    if path == "columns pass":
        run_both(pack_events(events, members, stake), cfg)
    else:
        fuse = 1 if path == "incremental, chunk loop" else 4
        drive_both(members, stake, cfg, fixed_chunks(events, 250), chunk=32,
                   window_bucket=512, prune_min=128, fuse_chunks=fuse)
    assert pipeline.table_check.calls > before
