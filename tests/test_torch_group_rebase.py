"""A group rank's full rebase over its own rows of the DAG's slabs
(``tpu_swirld_torch.parallel.BatchShards``), over gloo groups of CPU ranks
spawned by ``tpu_swirld_torch.multichip.launch``.  Tolerance: exact
equality throughout.

- The sharded visibility (``parallel.group_visibility_stage``) at 2, 3 and
  4 ranks on a fork-free and a forked ``generate_gossip_dag``: each rank's
  rows of ``anc`` and ``sees`` equal the same rows of the JAX reference's
  ``ancestry`` / ``visibility_stage`` (``tpu_swirld/tpu/pipeline.py:160``,
  ``:745``) on the same packed DAG, padded to whole blocks a rank; the
  stage hands exactly ``sum_t |X_t| N`` bytes, ``X_t`` rank ``t``'s rows
  that are parents of later ranks' events, listed here from ``parents``;
  no slab it allocates has more than ``N / D`` rows.
- The collectives in pieces that the rebase's order stage and lift use:
  ``exchange_columns`` in several all-to-alls and ``reshard_rows`` in sums
  of bounded rows equal the one-call versions and hand the same bytes.
- A batch spill in pieces (``SlabArchive.spill_full(continues=True)``)
  leaves the archive the reference's one spill leaves.

The straggler's full rebase in lockstep with the reference's mesh driver,
and each rank's record of its rebase slabs, are in
``tests/test_torch_mesh_group.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_swirld.packing import pack_events
from tpu_swirld.sim import generate_gossip_dag
from tpu_swirld.store import SlabArchive as RefArchive
from tpu_swirld.tpu import pipeline as ref
from tpu_swirld_torch import multichip
from tpu_swirld_torch.parallel import crossing_rows
from tpu_swirld_torch.store import SlabArchive
from tests.test_torch_group_columns import _slab, pieces_rank

# name -> generate_gossip_dag (members, events, seed, forkers)
DAGS = {"fork-free": (6, 300, 9, 0), "forked": (8, 400, 4, 2)}
BLOCK = 32


def _packed(name, d):
    """The DAG ``name`` packed by the reference, padded to a multiple of
    ``d * BLOCK`` rows (parentless padding): ``(parents, creator,
    fork_pairs, members)``."""
    m, n, seed, forkers = DAGS[name]
    members, stake, events, _keys = generate_gossip_dag(m, n, seed=seed, n_forkers=forkers)
    packed = pack_events(events, members, stake)
    n_pad = -(-packed.n // (d * BLOCK)) * d * BLOCK
    parents = np.full((n_pad, 2), -1, np.int32)
    parents[: packed.n] = packed.parents
    creator = np.zeros((n_pad,), np.int32)
    creator[: packed.n] = packed.creator
    return parents, creator, packed.fork_pairs.astype(np.int32), m


@pytest.fixture(scope="module")
def visibility():
    """``visibility(d)``: both DAGs through one gloo group of ``d`` CPU
    ranks, ``{name: per-rank results}``."""
    runs = {}

    def run(d):
        if d not in runs:
            tasks = [(multichip.visibility_rank, (*_packed(name, d), BLOCK)) for name in DAGS]
            reports = multichip.launch(multichip.tasks_rank, d, args=(tasks,),
                                       device="cpu", backend="gloo", timeout=300)
            runs[d] = {name: [rep["result"]["results"][i] for rep in reports]
                       for i, name in enumerate(DAGS)}
        return runs[d]

    return run


def _crossing(parents, d):
    """``X_t`` by brute force: rank ``t``'s rows that some later rank's
    event names as a parent."""
    n_loc = parents.shape[0] // d
    out = []
    for t in range(d):
        later = parents[(t + 1) * n_loc :].reshape(-1)
        out.append(np.array(sorted({int(p) for p in later
                                    if t * n_loc <= p < (t + 1) * n_loc}), np.int64))
    return out


@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(DAGS))
def test_crossing_rows_listed_from_parents(name, d):
    parents = _packed(name, d)[0]
    got, want = crossing_rows(parents, d), _crossing(parents, d)
    assert [x.tolist() for x in got] == [x.tolist() for x in want]
    assert got[-1].size == 0 and sum(x.size for x in got) > 0


@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(DAGS))
def test_sharded_visibility_matches_reference(visibility, name, d):
    parents, creator, fork_pairs, m = _packed(name, d)
    n = parents.shape[0]
    n_loc = n // d
    if fork_pairs.shape[0]:
        anc, sees = ref.visibility_stage(
            jnp.asarray(parents), jnp.asarray(creator), jnp.asarray(fork_pairs),
            n_members=m, block=BLOCK, matmul_dtype_name="float32")
        anc, sees = np.asarray(anc), np.asarray(sees)
        assert not np.array_equal(anc, sees)
    else:
        anc = np.asarray(ref.ancestry_stage(jnp.asarray(parents), block=BLOCK,
                                            matmul_dtype_name="float32"))
        sees = anc
    handed = sum(x.size for x in _crossing(parents, d)) * n
    for rank, out in enumerate(visibility(d)[name]):
        rows = slice(rank * n_loc, (rank + 1) * n_loc)
        assert out["anc"].shape == (n_loc, n)
        assert np.array_equal(out["anc"], anc[rows])
        assert np.array_equal(out["sees"], sees[rows])
        assert out["aliased"] == (fork_pairs.shape[0] == 0)
        # one broadcast a rank with crossing rows, its rows once
        assert out["bytes"] == handed > 0
        assert out["calls"] == sum(x.size > 0 for x in _crossing(parents, d))
        assert out["slab_rows"] == n_loc


@pytest.mark.parametrize("d", [2, 3])
def test_collectives_in_pieces_equal_one_call(d):
    """``exchange_columns`` in 5 all-to-alls and ``reshard_rows`` (a lift's
    shape: rows 30-89 of 96 into ``64 / D`` rows a rank) in sums of at most
    5 rows give the one-call outputs and hand the same bytes."""
    w = 96
    n_loc_new, shift, n_rows = 64 // d, 30, 90
    reports = multichip.launch(pieces_rank, d, args=(w, d, 5, n_rows, n_loc_new, shift, 5),
                               device="cpu", backend="gloo", timeout=120)
    whole = _slab(w, d)
    n_loc = w // d
    for rank, rep in enumerate(reports):
        out, handed = rep["result"]["out"], rep["result"]["handed"]
        assert np.array_equal(out["exchange"], whole[:, rank * n_loc : (rank + 1) * n_loc])
        assert np.array_equal(out["exchange pieces"], out["exchange"])
        assert handed["exchange pieces"] == (5, handed["exchange"][1])
        want = np.zeros((n_loc_new, w), bool)
        g0 = rank * n_loc_new + shift
        have = max(0, min(n_rows, g0 + n_loc_new) - g0)
        want[:have] = whole[g0 : g0 + have]
        assert np.array_equal(out["reshard"], want)
        assert np.array_equal(out["reshard pieces"], want)
        assert handed["reshard pieces"][1] == handed["reshard"][1]
        assert handed["reshard pieces"][0] >= handed["reshard"][0] == 1
        assert rep["result"]["rows"] <= n_loc_new


def test_batch_spill_in_pieces_is_one_spill():
    """A batch slab's rows spilled in three pieces, each after the first
    going on the first's spill, leave the archive (digest, rows, bytes,
    spill counts) the reference's one ``spill_full`` of them leaves."""
    rng = np.random.default_rng(7)
    n = 120
    rows = np.tril(rng.random((n, n)) < 0.3)
    rows[np.arange(n), np.arange(n)] = True
    want, got = RefArchive(), SlabArchive()
    want.spill_full(0, rows[:40])
    got.spill_full(0, torch.as_tensor(rows[:40]))
    want.spill_full(40, rows[40:])
    for a, b in ((40, 70), (70, 100), (100, 120)):
        got.spill_full(a, torch.as_tensor(rows[a:b]), continues=a > 40)
    assert got.digest() == want.digest()
    for k in ("n_rows", "spills", "spilled_rows", "skipped_rows", "archive_bytes"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.spills == 2
    want.close()
    got.close()
