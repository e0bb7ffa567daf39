"""The port's host copies (sim, event, packing, finalize_order) against the
reference's, and the golden digests that chip_smoke.py holds the card's run
against."""

import numpy as np
import pytest

from tpu_swirld import crypto as ref_crypto
from tpu_swirld.config import SwirldConfig as RefConfig
from tpu_swirld.packing import pack_events as ref_pack_events
from tpu_swirld.sim import generate_gossip_dag as ref_generate
from tpu_swirld.tpu import pipeline as ref
from tpu_swirld_torch import crypto
from tpu_swirld_torch.gpu import pipeline
from tpu_swirld_torch.packing import pack_events, packed_from_arrays
from tpu_swirld_torch.sim import generate_gossip_dag

FIELDS = ("parents", "creator", "seq", "t", "coin", "stake", "fork_pairs",
          "member_table")


@pytest.fixture
def sim_signer():
    """Both packages' crypto backends set to the simulation signer,
    restored afterwards."""
    prev = ref_crypto.backend_name(), crypto.backend_name()
    ref_crypto.set_backend("sim")
    crypto.set_backend("sim")
    try:
        yield
    finally:
        ref_crypto.set_backend(prev[0])
        crypto.set_backend(prev[1])


@pytest.mark.parametrize("n_forkers", [0, 2])
def test_sim_and_packing_match_reference(sim_signer, n_forkers):
    kw = dict(seed=4, n_forkers=n_forkers, fork_prob=0.3, stake=[3, 1, 2, 1, 1, 2])
    m_ref, s_ref, ev_ref, _ = ref_generate(6, 300, **kw)
    m, s, ev, _ = generate_gossip_dag(6, 300, **kw)
    assert m == m_ref and s == s_ref
    assert [e.id for e in ev] == [e.id for e in ev_ref]
    want = ref_pack_events(ev_ref, m_ref, s_ref)
    got = pack_events(ev, m, s)
    assert (got.n, got.n_members) == (want.n, want.n_members)
    assert got.ids == want.ids and got.sigs == want.sigs
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    if n_forkers:
        assert len(got.fork_pairs) > 0
    # the carry-across of the reference's fields gives the same DAG
    carried = packed_from_arrays(
        want.n_members, *(getattr(want, f) for f in FIELDS), want.ids, want.sigs
    )
    for f in FIELDS:
        assert np.array_equal(getattr(carried, f), getattr(got, f)), f


def test_finalize_order_matches_reference():
    members, stake, events, _keys = ref_generate(
        6, 400, seed=6, n_forkers=1, fork_prob=0.2
    )
    packed = ref_pack_events(events, members, [2, 1, 1, 3, 1, 1])
    cfg = RefConfig(n_members=6)
    arrays, statics, ts_unique = ref.prepare_inputs(
        packed, cfg, block=64, matmul_dtype_name="float32"
    )
    out, _aux = ref._columns_pass(
        packed, cfg, arrays["parents"], arrays["creator"], arrays["t_rank"],
        arrays["coin"], arrays["stake"], arrays["member_table"],
        n=packed.n, tot=statics["tot_stake"], block=64,
        r_rounds=statics["r_max"], s_max=statics["s_max"],
        chain=statics["chain"], matmul_dtype_name="float32",
    )
    want = ref.finalize_order(packed, out, ts_unique)
    carried = packed_from_arrays(
        packed.n_members, *(getattr(packed, f) for f in FIELDS), packed.ids,
        packed.sigs,
    )
    got = pipeline.finalize_order(carried, out, ts_unique)
    assert got.order == want.order and len(got.order) > 0
    assert got.famous == want.famous
    assert np.array_equal(got.consensus_ts, want.consensus_ts)
    assert np.array_equal(got.round_received, want.round_received)
    assert got.max_round == want.max_round


@pytest.mark.slow
@pytest.mark.parametrize("name", ["config3", "config4"])
def test_golden_digests_match_reference(sim_signer, name):
    """Recompute chip_smoke.GOLDEN with the JAX reference on the CPU.  The
    reference runs with ``s_max = members + 1`` and self-heals the slot
    capacity: the default capacity of config 4 (2019 slots) makes its fame
    tally take tens of GB of host memory, and the outputs do not depend on
    the capacity."""
    import chip_smoke

    members, stake, events, _keys = ref_generate(
        chip_smoke.N_MEMBERS, chip_smoke.N_EVENTS, seed=chip_smoke.SEED,
        n_forkers=chip_smoke.CONFIGS[name],
    )
    packed = ref_pack_events(events, members, stake)
    result = ref.run_consensus(
        packed, RefConfig(n_members=chip_smoke.N_MEMBERS),
        s_max=chip_smoke.N_MEMBERS + 1,
    )
    assert chip_smoke.result_digests(packed, result) == chip_smoke.GOLDEN[name]


@pytest.mark.slow
def test_pin_golden_matches_reference(sim_signer):
    """Recompute chip_smoke.PIN_GOLDEN: the JAX reference's run_consensus on
    config 3's first ``DYN_PIN_EVENTS`` events, its decided count and order
    digest (what phase 12(a)'s single-epoch pin holds each engine to)."""
    import chip_smoke

    members, stake, events, _keys = ref_generate(
        chip_smoke.N_MEMBERS, chip_smoke.N_EVENTS, seed=chip_smoke.SEED,
    )
    packed = ref_pack_events(events[: chip_smoke.DYN_PIN_EVENTS], members, stake)
    result = ref.run_consensus(
        packed, RefConfig(n_members=chip_smoke.N_MEMBERS),
        s_max=chip_smoke.N_MEMBERS + 1,
    )
    digests = chip_smoke.result_digests(packed, result)
    assert {"decided": len(result.order), "order": digests["order"]} == \
        chip_smoke.PIN_GOLDEN
