"""The port's active byzantine adversaries and its scenario registry
(``tpu_swirld_torch.adversary``) on the CPU (``device="cpu"``), held against
the JAX reference's ``tpu_swirld.adversary`` at the same seeds under both
packages' simulation signer.  Exact tolerance: every strategy's verdict
protocol fields (``chip_smoke.chaos_fields``) equal the reference's, which
are also ``chip_smoke.CHAOS_GOLDEN``'s recompute for these legs (the
acceptance scenario's and the storms' are in ``tests/test_torch_chaos.py``).
``fork_bomb`` replays through the three windowed drivers, as phase 14(b)
runs it."""

import pytest
import torch

import chip_smoke
from tpu_swirld import adversary as ref_adversary
from tpu_swirld import chaos as ref_chaos
from tpu_swirld import crypto as ref_crypto
from tpu_swirld.oracle.event import Event as RefEvent
from tpu_swirld_torch import adversary, chaos, crypto
from tpu_swirld_torch.event import Event

pytestmark = pytest.mark.adversary

STRATEGIES = ("equivocation_storm", "censorship", "delayed_release",
              "fork_bomb", "fork_bomb_overbudget")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tiny ops: torch's CPU thread pool costs far more than it saves here
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", autouse=True)
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


def _engine(name):
    return chip_smoke.CHAOS_ENGINES if name in chip_smoke.CHAOS_MULTI else "incremental"


def reference_fields(name, ckpt_dir):
    """The reference's verdict fields of the strategy ``name`` as phase
    14(b) runs it."""
    with chip_smoke.oracle_orders(ref_chaos) as orders:
        v = ref_adversary.SCENARIOS[name](ckpt_dir, engine=_engine(name))
    return chip_smoke.chaos_fields(v, orders)


def test_registry_names_match_reference():
    assert list(adversary.SCENARIOS) == list(ref_adversary.SCENARIOS) == [
        "equivocation_storm",
        "censorship",
        "delayed_release",
        "fork_bomb",
        "fork_bomb_overbudget",
        "horizon_storm",
        "overflow_storm",
        "membership_churn",
    ]
    assert set(chip_smoke.CHAOS_GOLDEN) == {"acceptance", *adversary.SCENARIOS}


@pytest.mark.parametrize("name", STRATEGIES)
def test_strategy_matches_reference_and_golden(name, tmp_path):
    want = reference_fields(name, str(tmp_path / "r"))
    with chip_smoke.oracle_orders(chaos) as orders:
        v = adversary.SCENARIOS[name](str(tmp_path / "p"), engine=_engine(name),
                                      device="cpu")
    got = chip_smoke.chaos_fields(v, orders)
    assert got == want
    assert want == chip_smoke.CHAOS_GOLDEN[name]
    assert v["ok"], v
    adv = v["adversary"]
    assert adv["strategy"] == name
    if name == "fork_bomb_overbudget":
        assert adv["budget_exhausted"] > 0 and not adv["silent_divergence"]
        assert "engines" not in v
        return
    rows = chip_smoke.engine_rows(v)
    assert [r["engine"] for r in rows] == (
        list(chip_smoke.CHAOS_ENGINES) if name in chip_smoke.CHAOS_MULTI
        else ["incremental"])
    for r in rows:
        assert r["batch_oracle_parity"] and r["incremental_batch_parity"]
    assert {"equivocation_storm": adv["equivocations_detected"],
            "fork_bomb": adv["equivocations_detected"],
            "censorship": adv["withholding_suspected"],
            "delayed_release": adv["late_witnesses"]}[name] > 0


def test_signed_blobs_match_reference():
    """The re-filtered, re-signed reply blobs of the censoring and
    withholding drivers are the reference's bytes."""
    pk, sk = crypto.keypair(b"blob")
    events = [Event(d=b"e%d" % i, p=(), t=i, c=pk).signed(sk) for i in range(3)]
    ref_events = [RefEvent(d=b"e%d" % i, p=(), t=i, c=pk).signed(sk) for i in range(3)]
    blob = adversary._sign_blob(events, sk)
    assert blob == ref_adversary._sign_blob(ref_events, sk)
    assert [e.id for e in adversary._decode_blob(blob)] == [e.id for e in events]
