"""The incremental driver's stages, the repaired batch stages it needs and
the host pieces it reads, each against the JAX reference's on the same
inputs (made from a seed with numpy).  Tolerance: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_swirld.config import SwirldConfig as RefConfig
from tpu_swirld.config import resolve_stream_settings as ref_resolve
from tpu_swirld.packing import Packer as RefPacker
from tpu_swirld.packing import pack_events as ref_pack_events
from tpu_swirld.sim import generate_gossip_dag
from tpu_swirld.tpu import pipeline as ref
from tpu_swirld_torch.config import SwirldConfig, resolve_stream_settings
from tpu_swirld_torch.device import StageClock, to_host
from tpu_swirld_torch.gpu import incremental as inc
from tpu_swirld_torch.gpu import kernels, pipeline
from tpu_swirld_torch.packing import Packer
from tests.test_torch_incremental import port_events
from tests.test_torch_pipeline import carry_across, port_config

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.tensor(np.asarray(a))


def same(got, want):
    want = np.asarray(want)
    got = to_host(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    return got.shape == want.shape and np.array_equal(got, want)


def padded_dag(n_members, n_events, *, seed, n_forkers=0, block=64, fork_prob=0.05):
    members, stake, events, _keys = generate_gossip_dag(
        n_members, n_events, seed=seed, n_forkers=n_forkers, fork_prob=fork_prob
    )
    packed = ref_pack_events(events, members, stake)
    n_pad = ((packed.n + block - 1) // block) * block
    parents = np.full((n_pad, 2), -1, np.int32)
    parents[: packed.n] = packed.parents
    creator = np.zeros((n_pad,), np.int32)
    creator[: packed.n] = packed.creator
    return packed, parents, creator


# ------------------------------------------------------------ visibility


@pytest.mark.parametrize("b0", [0, 2, 3])
def test_ancestry_extend_from_carried_slab(b0):
    packed, parents, _creator = padded_dag(6, 300, seed=3, n_forkers=1)
    n = parents.shape[0]
    b1 = n // 64
    full = np.asarray(ref.ancestry(jnp.asarray(parents), block=64, matmul_dtype=jnp.float32))
    carried = full.copy()
    carried[b0 * 64 :] = False          # rows of blocks >= b0 not built yet
    want = ref._ancestry_extend_body(
        jnp.asarray(carried), jnp.asarray(parents), b0, b1, block=64,
        dt=jnp.float32, bmm=ref._bmm,
    )
    got = inc.ancestry_extend(t(carried), t(parents), b0, b1, block=64,
                              bmm=kernels.bmm_or)
    assert same(got, want) and same(got, full)


@pytest.mark.parametrize("row0", [128, 300])   # 300: the slice start clamps
def test_extend_visibility_forked_stage(row0):
    packed, parents, creator = padded_dag(6, 380, seed=5, n_forkers=2, fork_prob=0.3)
    assert len(packed.fork_pairs) > 0
    n = parents.shape[0]
    rows = 128
    fp = np.full((((len(packed.fork_pairs) + 7) // 8) * 8, 3), -1, np.int32)
    fp[: len(packed.fork_pairs)] = packed.fork_pairs
    anc0, sees0 = ref.visibility_stage(
        jnp.asarray(parents), jnp.asarray(creator), jnp.asarray(packed.fork_pairs),
        n_members=6, block=64, matmul_dtype_name="float32",
    )
    anc0, sees0 = np.asarray(anc0).copy(), np.asarray(sees0).copy()
    anc0[128:] = False
    sees0[128:] = False
    stage = ref.make_extend_visibility_forked_stage(ref.XLA_EXTENSION_KERNELS)
    # the reference stage donates its slabs: hand it copies
    want_anc, want_sees = stage(
        jnp.asarray(anc0.copy()), jnp.asarray(sees0.copy()), jnp.asarray(parents),
        jnp.asarray(fp), jnp.asarray(creator), np.int32(2), np.int32(n // 64),
        np.int32(row0), block=64, rows=rows, n_members=6,
        matmul_dtype_name="float32",
    )
    got_anc, got_sees = inc.extend_visibility_forked_stage(
        t(anc0), t(sees0), t(parents), t(fp), t(creator), 2, n // 64, row0,
        block=64, rows=rows, n_members=6, bmm=kernels.bmm_or,
    )
    assert same(got_anc, want_anc) and same(got_sees, want_sees)


# ----------------------------------------------------- slabs and columns


def random_slabs(seed, n=256, c=96):
    rng = np.random.default_rng(seed)
    anc = rng.random((n, n)) < 0.3
    sees = anc & (rng.random((n, n)) < 0.8)
    ssm = rng.random((n, c)) < 0.2
    keep = np.full((c,), -1, np.int32)
    picks = np.sort(rng.choice(c, 40, replace=False)).astype(np.int32)
    keep[:40] = picks
    keep[5] = c + 7                      # out of range: clipped as the reference clips
    return anc, sees, ssm, keep


@pytest.mark.parametrize("d,n_used", [(37, 200), (1, 256), (100, 100)])
def test_prune_stages(d, n_used):
    anc, sees, ssm, keep = random_slabs(d)
    want = ref.prune_stage(jnp.asarray(anc), jnp.asarray(sees), jnp.asarray(ssm),
                           np.int32(d), np.int32(n_used), jnp.asarray(keep))
    got = inc.prune_stage(t(anc), t(sees), t(ssm), d, n_used, t(keep))
    assert all(same(g, w) for g, w in zip(got, want))
    want = ref.prune_noforks_stage(jnp.asarray(anc), jnp.asarray(ssm), np.int32(d),
                                   np.int32(n_used), jnp.asarray(keep))
    got = inc.prune_noforks_stage(t(anc), t(ssm), d, n_used, t(keep))
    assert all(same(g, w) for g, w in zip(got, want))


def test_compact_cols_and_update_block():
    _anc, _sees, ssm, keep = random_slabs(4)
    assert same(inc.compact_cols_stage(t(ssm), t(keep)),
                ref.compact_cols_stage(jnp.asarray(ssm), jnp.asarray(keep)))
    part = np.random.default_rng(5).random((64, 32)) < 0.5
    for row0, col0 in [(16, 8), (230, 80)]:      # the second clamps both starts
        want = ref.update_block_stage(jnp.asarray(ssm), jnp.asarray(part),
                                      np.int32(row0), np.int32(col0))
        got = inc.update_block_stage(t(ssm), t(part), row0, col0)
        assert same(got, want)


# ------------------------------------------------------------ rounds scan


def test_rounds_chunk_with_window_base_and_stragglers():
    """A chunk resumed from a carried window with r_base = 2: the port's
    step equals the reference's, and a straggler below the window (a
    late genesis and a witness whose parents sit below r_base) sets
    OVF_ROUND exactly as there."""
    packed, parents, creator = padded_dag(5, 400, seed=7, block=64)
    n = parents.shape[0]
    stake = packed.stake
    tot = int(stake.sum())
    sees = ref.ancestry(jnp.asarray(parents), block=64, matmul_dtype=jnp.float32)
    ssm = np.asarray(ref.ssm_matrix(sees, jnp.asarray(packed.member_table),
                                    jnp.asarray(stake), tot, jnp.float32))
    col_pos = np.arange(n, dtype=np.int32)
    r_max, s_max = 16, 8
    rnd, wits, tab, cnt, ovf = (np.asarray(x) for x in ref.rounds_scan(
        jnp.asarray(parents), jnp.asarray(ssm), jnp.asarray(creator),
        jnp.asarray(stake), tot, np.int32(packed.n), r_max=r_max, s_max=s_max,
        has_forks=False,
    ))
    assert int(ovf) == 0 and int(rnd.max()) >= 4
    r_base, start, chunk = 2, 192, 128
    # the carried window: table rows from r_base on, events before start
    tab_w = np.full((r_max, s_max), -1, np.int32)
    cnt_w = np.zeros((r_max,), np.int32)
    before = np.where((tab >= 0) & (tab < start), tab, -1)[r_base:]
    tab_w[: r_max - r_base] = before
    cnt_w[: r_max - r_base] = (before >= 0).sum(1)
    rnd_w = np.where(np.arange(n) < start, rnd, 0).astype(np.int32)
    wits_w = np.where(np.arange(n) < start, wits, False)
    low = [int(i) for i in np.where((rnd == 0) & (np.arange(n) < 40))[0]]
    mid = [int(i) for i in np.where((rnd == 1) & (np.arange(n) < start))[0]]
    cases = {"clean": parents}
    late_genesis = parents.copy()
    late_genesis[start + 5] = -1
    cases["late genesis"] = late_genesis
    straggler = parents.copy()
    straggler[start + 9] = (low[0], mid[0])   # round 1 > round 0: a witness below r_base
    cases["straggler witness"] = straggler
    for label, par in cases.items():
        want = ref.rounds_chunk_stage(
            jnp.asarray(par), jnp.asarray(ssm), jnp.asarray(col_pos),
            jnp.asarray(creator), jnp.asarray(stake), np.int32(packed.n),
            jnp.asarray(rnd_w), jnp.asarray(wits_w), jnp.asarray(tab_w),
            jnp.asarray(cnt_w), jnp.zeros((), jnp.int32), np.int32(start),
            np.int32(r_base), tot_stake=tot, r_max=r_max, s_max=s_max,
            has_forks=False, chunk=chunk,
        )
        got = pipeline.rounds_chunk_stage(
            par, t(ssm), t(col_pos), t(creator), t(stake), packed.n,
            t(rnd_w), t(wits_w), t(tab_w), t(cnt_w),
            torch.zeros((1,), dtype=torch.int32), start, r_base,
            tot_stake=tot, r_max=r_max, s_max=s_max, has_forks=False,
            chunk=chunk,
        )
        for g, w in zip(got[:4], want[:4]):
            assert same(g, w), label
        assert int(got[4][0]) == int(want[4]), label
        expect = 0 if label == "clean" else pipeline.OVF_ROUND
        assert int(got[4][0]) & pipeline.OVF_ROUND == expect, label
    # and the span stage runs the same body over k chunks, on a copy of the
    # carry
    carry = tuple(t(x.copy()) for x in (rnd_w, wits_w, tab_w, cnt_w))
    span = inc.rounds_span_stage(
        parents, t(ssm), t(col_pos), t(creator), t(stake), packed.n, *carry,
        torch.zeros((1,), dtype=torch.int32), start, r_base, tot_stake=tot,
        r_max=r_max, s_max=s_max, has_forks=False, chunk=64, k_chunks=2,
    )
    clean = pipeline.rounds_chunk_stage(
        parents, t(ssm), t(col_pos), t(creator), t(stake), packed.n,
        t(rnd_w), t(wits_w), t(tab_w), t(cnt_w),
        torch.zeros((1,), dtype=torch.int32), start, r_base, tot_stake=tot,
        r_max=r_max, s_max=s_max, has_forks=False, chunk=chunk,
    )
    assert all(torch.equal(a, b) for a, b in zip(span, clean))
    for c, x in zip(carry, (rnd_w, wits_w, tab_w, cnt_w)):
        assert np.array_equal(c.numpy(), x)     # a probe never writes its carry


# ------------------------------------------------ batch pass and window


@pytest.fixture(scope="module")
def forked_columns_pass():
    """The reference's and the port's ``_columns_pass`` on a forked DAG
    whose slot capacity (members + distinct second fork members + 1) is far
    above the slots it uses."""
    members, stake, events, _keys = generate_gossip_dag(
        8, 700, seed=4, n_forkers=2
    )
    packed = ref_pack_events(events, members, [2, 1, 1, 3, 1, 1, 2, 1])
    cfg = RefConfig(n_members=8)
    arrays, statics, _ts = ref.prepare_inputs(packed, cfg, block=64,
                                              matmul_dtype_name="float32")
    r_rounds = min(statics["r_max"], ref._bucket(statics["chain"] + 1, 32))
    kw = dict(n=packed.n, tot=statics["tot_stake"], block=64, r_rounds=r_rounds,
              s_max=statics["s_max"], chain=statics["chain"])
    keys = ("parents", "creator", "t_rank", "coin", "stake", "member_table")
    want = ref._columns_pass(packed, cfg, *(arrays[k] for k in keys),
                             matmul_dtype_name="float32", **kw)
    pcfg = port_config(cfg)
    p_arrays, _s, _t = pipeline.prepare_inputs(carry_across(packed), pcfg, block=64)
    got = pipeline._columns_pass(carry_across(packed), pcfg,
                                 *(p_arrays[k] for k in keys), device=CPU,
                                 stages=StageClock(CPU), **kw)
    return packed, cfg, want, got


def test_columns_pass_out_and_aux(forked_columns_pass):
    _packed, _cfg, (w_out, w_aux), (g_out, g_aux) = forked_columns_pass
    assert set(g_out) == set(w_out) and set(g_aux) == set(w_aux)
    s_used = int(w_out["wit_count"].max())
    assert s_used < w_out["wit_table"].shape[1]
    for k in w_out:
        assert same(g_out[k], w_out[k]), k
    for k in ("anc", "sees", "ssm_c", "col_pos"):
        assert same(g_aux[k], w_aux[k]), k
    for k in ("n_cols", "w_cap", "n_scans", "r_rounds", "s_max", "overflow_retries"):
        assert g_aux[k] == w_aux[k], k
    assert g_aux["sees"] is not g_aux["anc"]


def test_fame_and_order_window_stages(forked_columns_pass):
    packed, cfg, (w_out, w_aux), (g_out, g_aux) = forked_columns_pass
    tab, cnt = w_out["wit_table"], w_out["wit_count"]
    r_max, s_max = tab.shape
    n_pad = w_aux["anc"].shape[0]
    creator = np.zeros((n_pad,), np.int32)
    creator[: packed.n] = packed.creator
    coin = np.zeros((n_pad,), np.uint8)
    coin[: packed.n] = packed.coin
    tot = int(packed.stake.sum())
    want = ref.fame_window_stage(
        w_aux["sees"], w_aux["ssm_c"], jnp.asarray(w_aux["col_pos"]),
        jnp.asarray(tab), jnp.asarray(creator), jnp.asarray(coin),
        jnp.asarray(packed.stake), tot_stake=tot, coin_period=cfg.coin_period,
        r_max=r_max, s_max=s_max, has_forks=True, matmul_dtype_name="float32",
    )
    got = inc.fame_window_stage(
        g_aux["sees"], g_aux["ssm_c"], t(g_aux["col_pos"]), t(tab), t(creator),
        t(coin), t(packed.stake), tot_stake=tot, coin_period=cfg.coin_period,
        r_max=r_max, s_max=s_max, has_forks=True,
    )
    assert same(got[0], want[0]) and same(got[1], want[1])
    assert same(got[0], w_out["famous"])
    # order over the first rounds, resuming from a random received set
    self_parent = np.full((n_pad,), -1, np.int32)
    self_parent[: packed.n] = packed.parents[:, 0]
    _u, t_rank = np.unique(np.concatenate([packed.t, np.zeros(n_pad - packed.n, np.int64)]),
                           return_inverse=True)
    t_rank = t_rank.astype(np.int32)
    recv0 = np.random.default_rng(2).random(n_pad) < 0.2
    fam = np.asarray(want[0])
    r_ord = min(r_max, 8)
    want = ref.order_window_stage(
        w_aux["anc"], jnp.asarray(tab), jnp.asarray(cnt), jnp.asarray(fam),
        jnp.asarray(creator), jnp.asarray(self_parent), jnp.asarray(t_rank),
        np.int32(w_out["max_round"]), np.int32(packed.n), jnp.asarray(recv0),
        r_max=r_ord, s_max=s_max, chain=int(packed.seq.max()) + 1,
    )
    got = inc.order_window_stage(
        g_aux["anc"], t(tab), t(cnt), t(fam), t(creator), t(self_parent),
        t(t_rank), int(w_out["max_round"]), packed.n, t(recv0),
        r_max=r_ord, s_max=s_max, s_used=inc._used_slots(np.asarray(tab)[:r_ord]),
        chain=int(packed.seq.max()) + 1,
    )
    assert all(same(g, w) for g, w in zip(got, want))
    assert (to_host(got[0]) >= 0).any()


def test_order_scan_received0(forked_columns_pass):
    packed, _cfg, (w_out, w_aux), (_g_out, g_aux) = forked_columns_pass
    n_pad = w_aux["anc"].shape[0]
    tab, cnt = w_out["wit_table"], w_out["wit_count"]
    creator = np.zeros((n_pad,), np.int32)
    creator[: packed.n] = packed.creator
    self_parent = np.full((n_pad,), -1, np.int32)
    self_parent[: packed.n] = packed.parents[:, 0]
    t_rank = np.arange(n_pad, dtype=np.int32)
    chain = int(packed.seq.max()) + 1
    for recv0 in (None, np.random.default_rng(9).random(n_pad) < 0.3):
        want = ref.order_scan(
            w_aux["anc"], jnp.asarray(tab), jnp.asarray(cnt),
            jnp.asarray(w_out["famous"]), jnp.asarray(creator),
            jnp.asarray(self_parent), jnp.asarray(t_rank),
            jnp.int32(w_out["max_round"]), jnp.int32(packed.n), chain=chain,
            received0=None if recv0 is None else jnp.asarray(recv0),
        )
        got = pipeline.order_scan(
            g_aux["anc"], t(tab), t(cnt), t(w_out["famous"]), t(creator),
            t(self_parent), t(t_rank), int(w_out["max_round"]), packed.n,
            chain=chain, received0=None if recv0 is None else t(recv0),
        )
        assert all(same(g, w) for g, w in zip(got, want))


# ------------------------------------------------------------ host pieces


def test_packer_views_match_reference():
    members, stake, events, _keys = generate_gossip_dag(
        6, 200, seed=4, n_forkers=2, fork_prob=0.3
    )
    want, got = RefPacker(members, stake), Packer(members, stake)
    for lo_, hi_ in [(0, 50), (50, 130), (130, None)]:
        want.extend(events[lo_:hi_])
        got.extend(port_events(events[lo_:hi_]))
        assert len(got) == len(want)
        for lo, hi in [(0, None), (lo_, len(want)), (len(want), None)]:
            for g, w in zip(got.window_view(lo, hi), want.window_view(lo, hi)):
                assert g.dtype == w.dtype and np.array_equal(g, w)
                assert not g.flags.writeable
        assert got.n_fork_pairs == want.n_fork_pairs
        for lo in (0, got.n_fork_pairs // 2, got.n_fork_pairs):
            g, w = got.fork_pairs_view(lo), want.fork_pairs_view(lo)
            assert g.shape == w.shape and np.array_equal(g, w)
            assert not g.flags.writeable
    assert want.n_fork_pairs > 0
    for i in (0, 77, len(want) - 1):
        assert got.sig(i) == want.sig(i) and got.event_id(i) == want.event_id(i)


def test_resolve_stream_settings_precedence(monkeypatch):
    monkeypatch.delenv("SWIRLD_FUSE_CHUNKS", raising=False)
    monkeypatch.delenv("SWIRLD_DECODE_OVERLAP", raising=False)
    monkeypatch.delenv("SWIRLD_DECODE_QUEUE_DEPTH", raising=False)
    assert resolve_stream_settings(SwirldConfig()) == {
        "fuse_chunks": 8, "decode_overlap": True, "decode_queue_depth": 2,
    }
    assert resolve_stream_settings() == ref_resolve()
    monkeypatch.setenv("SWIRLD_FUSE_CHUNKS", "3")
    assert resolve_stream_settings(SwirldConfig())["fuse_chunks"] == 3
    cfg = SwirldConfig(n_members=4, fuse_chunks=5)
    assert resolve_stream_settings(cfg)["fuse_chunks"] == 5
    assert inc.IncrementalConsensus([b"a", b"b"], config=cfg, device="cpu")._fuse == 5
    drv = inc.IncrementalConsensus([b"a", b"b"], config=cfg, fuse_chunks=2, device="cpu")
    assert drv._fuse == 2


def test_extension_kernel_bundles():
    bundle = kernels.make_extension_kernels()
    assert isinstance(bundle, inc.ExtensionKernels)
    assert bundle.bmm is kernels.bmm_or and bundle.ssm_block_fn is kernels.ssm_block
    drv = inc.IncrementalConsensus([b"a", b"b"], device="cpu")
    assert drv._kern.name == "cuda" and drv._bmm is kernels.bmm_or
    xla = inc.IncrementalConsensus([b"a", b"b"], device="cpu",
                                   extension_kernels=inc.XLA_EXTENSION_KERNELS)
    assert xla._bmm is kernels.bmm_or and xla._ssm_block_fn is kernels.ssm_block
