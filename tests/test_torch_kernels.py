"""The port's kernel wrappers and plain versions against the JAX package's
Pallas kernels (interpret mode) and XLA stages: exact equality, no
tolerance (every output is bool; 0/1 products are exact in f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_swirld.packing import pack_node
from tpu_swirld.sim import make_simulation, run_with_forkers
from tpu_swirld.tpu.pallas_kernels import bmm_or_pallas, ssm_block_pallas
from tpu_swirld.tpu.pipeline import (
    _bmm, ancestry, forkseen_matrix, sees_matrix, ssm_block_stage,
)
from tpu_swirld_torch.gpu import kernels


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tiny ops: torch's CPU thread pool costs far more than it saves here
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bools(rng, shape, density):
    return rng.random(shape) < density


@pytest.mark.parametrize("shape", [(128, 128, 256), (64, 96, 128), (128, 64, 512)])
def test_bmm_or_reference_matches_pallas(shape):
    p, q, r = shape
    rng = np.random.default_rng(5)
    a = _bools(rng, (p, q), 0.1)
    b = _bools(rng, (q, r), 0.1)
    want = np.asarray(
        bmm_or_pallas(jnp.asarray(a), jnp.asarray(b), jnp.float32, interpret=True)
    )
    got = kernels.bmm_or_reference(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(100, 37, 70), (1, 1, 1), (65, 33, 129), (3, 200, 5)])
def test_bmm_or_matches_xla_at_ragged_shapes(shape):
    p, q, r = shape
    rng = np.random.default_rng(11)
    dens = float(np.sqrt(0.69 / q))
    a = _bools(rng, (p, q), dens)
    b = _bools(rng, (q, r), dens)
    want = np.asarray(_bmm(jnp.asarray(a), jnp.asarray(b), jnp.float32))
    before = kernels.bmm_or.launches
    got = kernels.bmm_or(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(got.numpy(), want)
    # CPU tensors take the plain version, which launches nothing
    assert kernels.bmm_or.launches == before


def test_bmm_or_rejects_bad_inputs():
    a = torch.zeros((4, 3), dtype=torch.bool)
    with pytest.raises(TypeError):
        kernels.bmm_or(a.to(torch.float32), torch.zeros((3, 2), dtype=torch.bool))
    with pytest.raises(ValueError):
        kernels.bmm_or(a, torch.zeros((4, 2), dtype=torch.bool))
    with pytest.raises(ValueError):
        kernels.bmm_or(a, torch.zeros((3, 0), dtype=torch.bool))


def _sees_from_sim(n_nodes, turns, seed, forkers=0):
    """The sees slab of a seeded oracle sim, as tests/test_pallas.py makes it."""
    if forkers:
        sim = run_with_forkers(n_nodes, forkers, turns, seed=seed)
    else:
        sim = make_simulation(n_nodes, seed=seed)
        sim.run(turns)
    packed = pack_node(sim.nodes[0])
    n = packed.n
    n_pad = ((n + 127) // 128) * 128
    parents = np.concatenate([packed.parents, np.full((n_pad - n, 2), -1, np.int32)])
    creator = np.concatenate([packed.creator, np.zeros((n_pad - n,), np.int32)])
    anc = ancestry(jnp.asarray(parents), block=128, matmul_dtype=jnp.float32)
    fseen = forkseen_matrix(
        anc, jnp.asarray(packed.fork_pairs), packed.n_members, jnp.float32
    )
    sees = sees_matrix(anc, fseen, jnp.asarray(creator))
    return packed, np.array(sees)           # writable, for torch.from_numpy


_SEES_CACHE = {}


def _sees(kind):
    if kind not in _SEES_CACHE:
        if kind == "plain":
            _SEES_CACHE[kind] = _sees_from_sim(5, 220, seed=3)
        else:
            _SEES_CACHE[kind] = _sees_from_sim(7, 260, seed=9, forkers=2)
    return _SEES_CACHE[kind]


def _block_cases(packed, n):
    picks = np.linspace(0, packed.n - 1, 100).astype(np.int32)
    return [
        (0, n, np.concatenate([picks, np.full(28, -1, np.int32)])),
        (n - 128, 128, picks[:16]),            # suffix block
        (n - 64, 64, picks[:16]),              # sub-tile suffix
        # odd offset + one real column padded out (the single-event shape)
        (32, 96, np.concatenate([picks[:1], np.full(15, -1, np.int32)])),
    ]


@pytest.mark.parametrize("kind", ["plain", "forked"])
def test_ssm_block_reference_matches_pallas(kind):
    packed, sees = _sees(kind)
    if kind == "forked":
        assert len(packed.fork_pairs) > 0
    n = sees.shape[0]
    rng = np.random.default_rng(7)
    stake = rng.integers(1, 6, packed.n_members).astype(np.int32)  # non-uniform
    tot = int(stake.sum())
    mt = packed.member_table
    for row0, rows, cols in _block_cases(packed, n):
        want = np.asarray(ssm_block_pallas(
            jnp.asarray(sees), jnp.asarray(mt), jnp.asarray(stake),
            jnp.asarray(cols), np.int32(row0), rows=rows, tot_stake=tot,
            matmul_dtype_name="float32", tile_m=128, tile_n=128,
            interpret=True,
        ))
        got = kernels.ssm_block(
            torch.from_numpy(sees), torch.from_numpy(mt),
            torch.from_numpy(stake), torch.from_numpy(cols), row0,
            rows=rows, tot_stake=tot,
        )
        assert np.array_equal(got.numpy(), want), (row0, rows)


def test_ssm_block_clamps_row0_like_dynamic_slice():
    """A block start past ``n - rows`` is clamped and a negative one counts
    from the end, as ``lax.dynamic_slice`` takes it in the reference's
    ``ssm_block_stage``."""
    packed, sees = _sees("forked")
    n = sees.shape[0]
    stake = np.arange(1, packed.n_members + 1, dtype=np.int32)
    tot = int(stake.sum())
    cols = np.linspace(0, packed.n - 1, 64).astype(np.int32)
    cols[::5] = -1
    cols[3] = n + 40                           # clipped to n - 1, still valid
    mt = packed.member_table.copy()
    for row0, rows in [(n - 10, 64), (-5, 200), (-300, 64)]:
        want = np.asarray(ssm_block_stage(
            jnp.asarray(sees), jnp.asarray(mt), jnp.asarray(stake),
            jnp.asarray(cols), np.int32(row0), rows=rows, tot_stake=tot,
            matmul_dtype_name="float32",
        ))
        got = kernels.ssm_block_reference(
            torch.from_numpy(sees), torch.from_numpy(mt),
            torch.from_numpy(stake), torch.from_numpy(cols), row0,
            rows=rows, tot_stake=tot,
        )
        assert np.array_equal(got.numpy(), want), (row0, rows)


def test_ssm_block_rejects_bad_inputs():
    sees = torch.zeros((8, 8), dtype=torch.bool)
    mt = torch.zeros((2, 3), dtype=torch.int32)
    stake = torch.ones((2,), dtype=torch.int32)
    cols = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(TypeError):
        kernels.ssm_block(sees, mt.long(), stake, cols, 0, rows=8, tot_stake=2)
    with pytest.raises(ValueError):
        kernels.ssm_block(sees, mt, stake[:1], cols, 0, rows=8, tot_stake=2)
    with pytest.raises(ValueError):
        kernels.ssm_block(sees, mt, stake, cols, 0, rows=9, tot_stake=2)


@pytest.mark.parametrize("name", ["ssm_block", "ssm_matrix"])
def test_build_key_covers_shared_headers(tmp_path, monkeypatch, name):
    """An edited shared header (``csrc/*.cuh``) changes every library's
    build key, so no stale library is loaded after it."""
    import shutil

    from tpu_swirld_torch.gpu import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    if not headers:
        headers = [csrc / "probe.cuh"]
        headers[0].write_text("// probe\n")
    before = build.library_path(name)
    assert build.library_path(name) == before
    headers[0].write_bytes(headers[0].read_bytes() + b"\n// edited\n")
    edited = build.library_path(name)
    assert edited != before
    (csrc / "another.cuh").write_text("// a new header\n")
    assert build.library_path(name) not in (before, edited)


def test_launch_argtypes_match_the_sources():
    """Each ctypes signature in ``kernels._ARGTYPES`` matches its
    ``extern "C"`` function in ``gpu/csrc``: a pointer where the source
    takes a pointer, an ``int`` where it takes an ``int``, in order (a
    mismatch shows only on the card, as a refused call or a garbled one)."""
    import ctypes
    import pathlib
    import re

    csrc = pathlib.Path(kernels.__file__).parent / "csrc"
    sources = {p: p.read_text() for p in csrc.glob("*.cu")}
    for name, argtypes in kernels._ARGTYPES.items():
        found = [m for text in sources.values()
                 for m in re.findall(r'extern "C" int ' + name + r"\(([^)]*)\)", text)]
        assert len(found) == 1, name
        params = [p.strip() for p in found[0].split(",")]
        want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
        assert all(p.startswith(("const void*", "void*", "int ")) for p in params), name
        assert argtypes == want, name
