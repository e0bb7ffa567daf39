"""The port's streaming driver and slab store (``device="cpu"``, plain kernel
versions) against the JAX reference's ``tpu_swirld.store`` over the
schedules of ``tests/test_store.py``.  Tolerance: exact equality
everywhere.  After every ``ingest`` the stats dicts (apart from the wall-clock
``seconds`` / ``overlap_ratio`` and the momentary ``spill_queue_depth``),
the driver's counters and carried state, the archive's digest, row count and
retired-round ledger equal the reference driver's; at the end ``result()``
equals the reference driver's and the reference ``run_consensus``'s."""

import contextlib
import random
import struct

import numpy as np
import pytest
import torch

from tpu_swirld.config import SwirldConfig as RefConfig
from tpu_swirld.oracle.event import Event as RefEvent
from tpu_swirld.packing import pack_events as ref_pack_events
from tpu_swirld.sim import (
    chunked_ingest_schedule, generate_gossip_dag, make_simulation,
    make_straggler_event,
)
from tpu_swirld.store import SlabArchive as RefArchive
from tpu_swirld.store import StreamingConsensus as RefStreaming
from tpu_swirld.tpu import pipeline as ref
from tpu_swirld_torch.config import SwirldConfig, resolve_archive_settings
from tpu_swirld_torch.packing import chunk_slices
from tpu_swirld_torch.store import (
    SlabArchive, SlabStore, StreamingConsensus, TileBudgetExceeded,
)
from tpu_swirld_torch.store.slab import _tiles
from tests.test_torch_incremental import assert_same_state, port_events
from tests.test_torch_pipeline import assert_same

#: per-pass stats that measure wall time or a momentary queue length, and
#: the mesh driver's re-pins of drifted shards (the reference's growth paths
#: drift and re-pin; the port's slabs are one tensor, so its count stays 0)
VOLATILE = ("seconds", "overlap_ratio", "spill_queue_depth", "mesh_repins")
#: store stats that measure wall time
STORE_VOLATILE = ("spill_pack_seconds", "spill_stall_seconds",
                  "spill_queue_depth_peak")
STREAM_COUNTERS = ("widen_rebases", "full_rebases", "_round_hi")


@contextlib.contextmanager
def torch_threads(n):
    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with torch_threads(1):
        yield


def port_config(cfg: RefConfig) -> SwirldConfig:
    """The reference config's fields that the port reads."""
    return SwirldConfig(**{
        f: getattr(cfg, f)
        for f in ("n_members", "coin_period", "max_rounds", "stake", "seed",
                  "archive_compress_level", "archive_queue_depth",
                  "archive_async", "fuse_chunks", "decode_overlap",
                  "decode_queue_depth")
    })


def assert_same_archive(want, got):
    assert got.n_rows == want.n_rows
    assert got.digest() == want.digest()
    assert got._rounds == want._rounds
    for k in ("spills", "fetches", "spilled_rows", "fetched_rows",
              "skipped_rows", "archive_bytes"):
        assert getattr(got, k) == getattr(want, k), k


def assert_same_store(want, got):
    # the archive first: its digest drains both spill queues, so the
    # committed byte counts below are final
    assert_same_archive(want.store.archive, got.store.archive)
    sw, sg = want.store.stats(), got.store.stats()
    for k in STORE_VOLATILE:
        sw.pop(k)
        sg.pop(k)
    assert sg == sw


def assert_same_stream(want, got):
    assert_same_state(want, got)
    for k in STREAM_COUNTERS + ("decoded_off_thread",):
        assert getattr(got, k) == getattr(want, k), k
    assert_same_store(want, got)


def lockstep(want, got, chunks):
    """Ingest ``chunks`` (reference events) into both drivers, comparing
    after every pass; returns the port's per-pass ``ordered`` lists
    concatenated."""
    ordered = []
    for chunk in chunks:
        sw = want.ingest(chunk)
        sg = got.ingest(port_events(chunk))
        assert sg.get("mesh_repins", 0) == 0
        for k in VOLATILE:
            assert (k in sg) == (k in sw), k
            sw.pop(k, None)
            sg.pop(k, None)
        assert sg == sw
        ordered.extend(sg["ordered"])
        assert_same_stream(want, got)
    assert_same(want.result(), got.result())
    return ordered


def assert_batch_parity(got, delivery, members, stake, cfg, **kw):
    packed = ref_pack_events(delivery, members, stake)
    assert_same(ref.run_consensus(packed, cfg, **kw), got.result())


def random_chunks(events, seed, sizes=(1, 3, 20, 60, 150)):
    rng = random.Random(seed)
    out, i = [], 0
    while i < len(events):
        c = rng.choice(sizes)
        out.append(events[i : i + c])
        i += c
    return out


def stale_event(events, keys, ci, old_idx, tag):
    """A sync by member ``ci`` whose other-parent is the long-pruned
    ``events[old_idx]`` (the stale-view shape of tests/test_store.py)."""
    pk, sk = keys[ci]
    head = [ev for ev in events if ev.c == pk][-1]
    return RefEvent(
        d=tag, p=(head.id, events[old_idx].id), t=events[-1].t + 1, c=pk
    ).signed(sk)


#: the driver sizes every test shares (one set of reference compilations)
KW = dict(chunk=64, window_bucket=256, prune_min=64, ingest_chunk=256)
CFG = RefConfig(n_members=8)


def drivers(members, stake, cfg=CFG, **kw):
    kw = {**KW, **kw}
    return (RefStreaming(members, stake, cfg, **kw),
            StreamingConsensus(members, stake, port_config(cfg), device="cpu", **kw))


def forked_dag():
    """The forked history two tests share (one set of reference
    compilations): one forker, its first fork pair at event 277."""
    return generate_gossip_dag(8, 900, seed=5, n_forkers=1)


def batch_visibility(packed, n_members):
    """Host ``(anc, sees)`` of a packed DAG from the port's batch
    visibility stage (rows padded to its block of 64, then cut back)."""
    from tpu_swirld_torch.gpu.pipeline import visibility_stage

    n = packed.n
    n_pad = -(-n // 64) * 64
    parents = np.full((n_pad, 2), -1, np.int32)
    parents[:n] = packed.parents
    creator = np.zeros((n_pad,), np.int32)
    creator[:n] = packed.creator
    anc, sees = visibility_stage(
        torch.as_tensor(parents), torch.as_tensor(creator),
        torch.as_tensor(packed.fork_pairs), n_members=n_members, block=64,
    )
    return anc.numpy()[:n, :n], sees.numpy()[:n, :n]


def fixed_chunks(events, size):
    return [events[i : i + size] for i in range(0, len(events), size)]


# ------------------------------------------------------------------ parity


def test_streaming_random_chunks_with_forks():
    members, stake, events, _keys = forked_dag()
    want, got = drivers(members, stake)
    ordered = lockstep(want, got, random_chunks(events, 7, (2, 30, 90, 200)))
    assert got._sees_d is not got._anc_d
    assert ordered == got.result().order and ordered
    assert got.store.archive.n_rows > 0
    assert_batch_parity(got, events, members, stake, CFG)


def test_streaming_straggler_witness_takes_full_rebase():
    """A forged straggler witness at round 1, far below the committed
    frontier (``sim.make_straggler_event``'s shape, parents read from the
    batch rounds): both drivers route it through the full batch rebase."""
    members, stake, events, keys = generate_gossip_dag(8, 900, seed=11)
    want, got = drivers(members, stake)
    lockstep(want, got, fixed_chunks(events, 150))
    rnd = got.result().round
    pk, sk = keys[7]
    sp = next(e for e in events if e.c == pk)                  # round 0
    op = next(e for i, e in enumerate(events) if e.c != pk and rnd[i] == 1)
    strag = RefEvent(d=b"straggler", p=(sp.id, op.id),
                     t=max(sp.t, op.t) + 1, c=pk).signed(sk)
    full_before = got.full_rebases
    lockstep(want, got, [[strag]])
    assert got.full_rebases == full_before + 1 and got.widen_rebases == 0
    assert_batch_parity(got, events + [strag], members, stake, CFG)


def test_streaming_delayed_schedule():
    members, stake, events, _keys = generate_gossip_dag(8, 600, seed=6)
    chunks = chunked_ingest_schedule(events, 90, delay_prob=0.2, max_delay=4, seed=1)
    flat = [ev for c in chunks for ev in c]
    assert [ev.id for ev in flat] != [ev.id for ev in events]
    want, got = drivers(members, stake, ingest_chunk=128)
    lockstep(want, got, chunks)
    assert_batch_parity(got, flat, members, stake, CFG)


# -------------------------------------------------------- widening rebase


def test_streaming_widening_rebase_fetches_archive():
    members, stake, events, keys = generate_gossip_dag(8, 1000, seed=11)
    want, got = drivers(members, stake)
    lockstep(want, got, fixed_chunks(events, 200))
    assert got.pruned_prefix > 500
    strag = stale_event(events, keys, 3, 100, b"stale-sync")
    full_before = got.full_rebases
    lockstep(want, got, [[strag]])
    assert got.widen_rebases == 1
    assert got.full_rebases == full_before
    assert got.store.archive.fetched_rows > 0
    # a widen must not feed the rebase-storm guard
    assert got._consec_rebases == 0 and not got.storm_mode
    assert_batch_parity(got, events + [strag], members, stake, CFG)


def test_streaming_widening_then_continue_and_reprune():
    members, stake, events, keys = generate_gossip_dag(8, 900, seed=3)
    want, got = drivers(members, stake)
    lockstep(want, got, fixed_chunks(events, 150))
    assert 60 < got.pruned_prefix
    strag = stale_event(events, keys, 0, 60, b"stale")
    lockstep(want, got, [[strag]])
    assert got.widen_rebases == 1
    rng = random.Random(2)
    heads = {ev.c: ev for ev in events + [strag]}
    extra, t = [], strag.t
    for j in range(300):
        ci = rng.randrange(8)
        pi = (ci + 1 + rng.randrange(7)) % 8
        pk, sk = keys[ci]
        t += 1
        ev = RefEvent(
            d=b"x%d" % j, p=(heads[members[ci]].id, heads[members[pi]].id),
            t=t, c=pk,
        ).signed(sk)
        heads[members[ci]] = ev
        extra.append(ev)
    lockstep(want, got, fixed_chunks(extra, 150))
    # the window re-pruned past the widened region
    assert got.pruned_prefix >= got.store.archive.n_rows - 300
    assert got.store.archive.n_rows >= got.pruned_prefix
    assert_batch_parity(got, events + [strag] + extra, members, stake, CFG)


def test_overlapped_vs_serial_ingest_bit_identical():
    """Async spilling (in lockstep with the reference) and sync spilling,
    with forks, random chunking and a widening mid-flight: the same archive
    digest and outputs."""
    members, stake, events, keys = forked_dag()
    strag = stale_event(events, keys, 0, 80, b"stale-overlap")
    chunks = random_chunks(events, 13, (5, 40, 120, 250)) + [[strag]]
    want, got = drivers(members, stake, RefConfig(n_members=8, archive_async=True))
    lockstep(want, got, chunks)
    assert got.widen_rebases == 1 and got.store.archive._async
    serial = StreamingConsensus(
        members, stake, SwirldConfig(n_members=8, archive_async=False),
        device="cpu", **KW,
    )
    for chunk in chunks:
        serial.ingest(port_events(chunk))
    assert not serial.store.archive._async and serial.widen_rebases == 1
    got.store.close()
    assert got.store.archive._worker is None
    assert_same(got.result(), serial.result())
    assert_same_archive(got.store.archive, serial.store.archive)


@pytest.mark.parametrize("overlap", [True, False])
def test_decode_overlap_on_and_off(overlap):
    """Chunks hashed on the decode worker or on the ingest thread: the
    same outputs as the reference's at the same setting."""
    members, stake, events, _keys = generate_gossip_dag(8, 700, seed=2)
    want, got = drivers(members, stake,
                        RefConfig(n_members=8, decode_overlap=overlap))
    lockstep(want, got, [events[:600], events[600:]])
    assert got.decoded_off_thread == (600 if overlap else 0)
    assert_batch_parity(got, events, members, stake, CFG)


# ------------------------------------------------------- bounded residency


def test_tile_accounting_and_strict_budget():
    assert _tiles((256, 256), 256) == 1
    assert _tiles((257, 256), 256) == 2
    assert _tiles((8, 256, 8), 256) == 8
    store = SlabStore(budget_tiles=2, tile=256, strict=True)
    store.account("anc", (256, 256))
    assert store.resident_tiles == 1
    assert store.check({"anc": (256, 512)})
    with pytest.raises(TileBudgetExceeded):
        store.check({"anc": (512, 512)})
    soft = SlabStore(budget_tiles=1, tile=256, strict=False)
    soft.account("anc", (512, 512))
    assert not soft.check({})
    assert soft.budget_overruns == 1
    sharded = SlabStore(tile=64, n_shards=4, device_budget_tiles=4, strict=True)
    sharded.account("anc", (512, 512))
    assert sharded.device_resident_tiles == 2 * 8
    with pytest.raises(TileBudgetExceeded, match="4 shards"):
        sharded.check({})


def test_strict_budget_driver_raises_like_reference():
    members, stake, events, _keys = generate_gossip_dag(8, 600, seed=7)
    want, got = drivers(members, stake, tile_budget=2, tile=256,
                        strict_budget=True)
    for chunk in fixed_chunks(events, 100):
        try:
            want.ingest(chunk)
        except Exception as exc:     # the reference's TileBudgetExceeded
            assert type(exc).__name__ == "TileBudgetExceeded"
            with pytest.raises(TileBudgetExceeded):
                got.ingest(port_events(chunk))
            assert got.store.budget_overruns == want.store.budget_overruns == 1
            return
        got.ingest(port_events(chunk))
    pytest.fail("the reference never exceeded its budget")


# ------------------------------------------------------ archive mechanics


@pytest.fixture(scope="module")
def archived():
    """Both drivers over one fork-free history, far enough to archive
    rows and retire rounds; yields ``(want, got, events)``."""
    members, stake, events, _keys = generate_gossip_dag(8, 600, seed=9)
    want, got = drivers(members, stake)
    with torch_threads(1):
        lockstep(want, got, fixed_chunks(events, 100))
    assert got.store.archive.n_rows > 100
    assert got.store.archive.retired_rounds > 0
    yield want, got, events
    want.store.close()
    got.store.close()


def test_archive_spill_fetch_roundtrip_exact(archived):
    """Archived rows equal the batch ancestry rows they were spilled from,
    including the reconstructed pruned-prefix columns."""
    _want, got, _events = archived
    packed = got.packer.pack()
    anc, _sees = batch_visibility(packed, 8)
    hi = got.store.archive.n_rows
    a, s = got.store.fetch(0, hi, 0, hi, creator=packed.creator[:hi],
                           n_members=8)
    assert np.array_equal(a, anc[:hi, :hi])
    assert np.array_equal(s, a)                      # fork-free: sees == anc


def test_derive_sees_matches_batch_sees_with_forks():
    from tpu_swirld_torch.packing import pack_events

    members, stake, events, _keys = generate_gossip_dag(6, 300, seed=9, n_forkers=1)
    packed = pack_events(port_events(events), members, stake)
    assert len(packed.fork_pairs) > 0
    anc, sees = batch_visibility(packed, 6)
    assert not np.array_equal(anc, sees)
    for lo in (0, 40):
        args = (anc[lo:, lo:], lo, packed.creator[lo:], packed.fork_pairs, 6)
        got = SlabArchive.derive_sees(*args)
        assert np.array_equal(got, RefArchive.derive_sees(*args))
    assert np.array_equal(SlabArchive.derive_sees(
        anc, 0, packed.creator, packed.fork_pairs, 6), sees)


def test_archive_checkpoint_loads_in_either_package(archived, tmp_path):
    want, got, _events = archived
    want, got = want.store.archive, got.store.archive
    hi = got.n_rows
    for saver, loader, name in ((got, RefArchive, "port"), (want, SlabArchive, "ref")):
        p = tmp_path / f"{name}.npz"
        saver.save(str(p))
        back = loader.load(str(p))
        assert back.n_rows == hi
        assert back.digest() == want.digest() == got.digest()
        assert back._rounds == want._rounds
        assert np.array_equal(back.fetch(0, hi, 0, hi), got.fetch(0, hi, 0, hi))


def test_archive_tampered_blob_raises(archived, tmp_path):
    got = archived[1].store.archive
    rows = list(got._rows)
    blob = bytearray(rows[0])
    blob[-1] ^= 0xFF
    rows[0] = bytes(blob)
    raw = b"".join(struct.pack("<I", len(b)) + b for b in rows)
    p = tmp_path / "bad.npz"
    with open(p, "wb") as f:
        np.savez_compressed(
            f, format_version=SlabArchive.FORMAT_VERSION, n_rows=len(rows),
            blobs=np.frombuffer(raw, dtype=np.uint8),
            round_meta=np.zeros((0, 2), np.int64),
            round_flat=np.zeros((0,), np.int64),
            digest=np.frombuffer(got.digest().encode(), dtype=np.uint8),
        )
    for loader in (SlabArchive, RefArchive):
        with pytest.raises(ValueError, match="digest"):
            loader.load(str(p))


def test_checkpoint_with_nonempty_spill_queue_drains(tmp_path):
    import threading

    rng = np.random.default_rng(0)
    rows = np.tril(rng.random((64, 64)) < 0.3)
    sync = SlabArchive(async_spill=False)
    sync.spill_full(0, torch.as_tensor(rows))
    arch = SlabArchive(async_spill=True, queue_depth=8)
    gate = threading.Event()
    orig = arch._pack_full_rows

    def gated(start, r):
        gate.wait(10)
        orig(start, r)

    arch._pack_full_rows = gated
    for s in range(0, 64, 16):
        arch.spill_full(s, torch.as_tensor(rows[s : s + 16]).clone())
    assert arch.n_rows == 64 and arch.committed_rows < 64
    timer = threading.Timer(0.2, gate.set)
    timer.start()
    arch.save(str(tmp_path / "arch.npz"))
    timer.join(10)
    assert arch.committed_rows == 64
    back = RefArchive.load(str(tmp_path / "arch.npz"))
    assert back.digest() == sync.digest()
    ref_sync = RefArchive(async_spill=False)
    ref_sync.spill_full(0, rows)
    assert ref_sync.digest() == sync.digest()
    arch.close()
    assert arch._worker is None


def test_archive_worker_failure_reraises():
    """A failure on the pack worker surfaces at the next drain barrier."""
    arch = SlabArchive(async_spill=True)
    arch.spill_full(0, np.ones((1, 1), bool))
    arch.digest()                           # drained: row 0 is packed
    arch._rows.append(b"not zlib")          # a corrupt committed row 1
    arch._n_accepted += 1
    # row 2's prefix is rebuilt from its parent, row 1, on the worker
    arch.spill(2, np.array([[1, -1]], np.int32), np.ones((1, 1), bool))
    with pytest.raises(RuntimeError, match="worker failed"):
        arch.digest()
    arch.close()


def test_archive_settings_config_and_env(monkeypatch):
    from tpu_swirld.config import resolve_archive_settings as ref_resolve

    monkeypatch.setenv("SWIRLD_ARCHIVE_COMPRESS_LEVEL", "9")
    monkeypatch.setenv("SWIRLD_ARCHIVE_QUEUE_DEPTH", "3")
    monkeypatch.setenv("SWIRLD_ARCHIVE_ASYNC", "0")
    assert resolve_archive_settings(None) == {
        "compress_level": 9, "queue_depth": 3, "async_spill": False,
    } == ref_resolve(None)
    for off in ("false", "False", "OFF", "no", ""):
        monkeypatch.setenv("SWIRLD_ARCHIVE_ASYNC", off)
        assert resolve_archive_settings(None)["async_spill"] is False
    monkeypatch.setenv("SWIRLD_ARCHIVE_ASYNC", "1")
    assert resolve_archive_settings(None)["async_spill"] is True
    cfg = SwirldConfig(n_members=4, archive_compress_level=2, archive_async=True)
    s = resolve_archive_settings(cfg)
    assert s == {"compress_level": 2, "queue_depth": 3, "async_spill": True}
    assert s == ref_resolve(RefConfig(n_members=4, archive_compress_level=2,
                                      archive_async=True))
    arch = SlabArchive(config=cfg)
    assert arch._level == 2 and arch._async is True and arch.queue_depth == 3


def test_chunk_slices_and_prepared_packing():
    from tpu_swirld.packing import chunk_slices as ref_chunk_slices
    from tpu_swirld_torch.packing import Packer, prepare_events

    assert chunk_slices(10, 4) == [(0, 4), (4, 8), (8, 10)] == ref_chunk_slices(10, 4)
    assert chunk_slices(0, 4) == []
    with pytest.raises(ValueError):
        chunk_slices(3, 0)
    members, stake, events, _keys = generate_gossip_dag(4, 60, seed=3)
    evs = port_events(events)
    a, b = Packer(members, stake), Packer(members, stake)
    a.extend(evs)
    assert b.extend_prepared(prepare_events(evs)) == list(range(60))
    assert b.extend_prepared(prepare_events(evs[:5])) == list(range(5))
    pa, pb = a.pack(), b.pack()
    assert pa.ids == pb.ids and np.array_equal(pa.parents, pb.parents)
