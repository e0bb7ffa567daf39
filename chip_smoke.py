#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

1. Environment: the card's name and power limit, torch and CUDA versions.
2. Build: compiles every CUDA kernel of the main path from ``tpu_swirld_torch/
   gpu/csrc`` (one ``nvcc`` per source, all started together) and times it.
3. Kernel vs plain version on the card, exact equality: ``bmm_or`` at the
   ancestry and forkseen shapes, the incremental forked-extension hop (1024 x
   G_cap @ G_cap x 64) and a ragged one, ``ssm_block`` (non-uniform stake)
   on the sees slabs of the BASELINE config-4 and config-3 DAGs at the
   column-add shapes and the incremental extension block (1024 rows
   mid-window x 256 and 1024 columns) and on config 5's window at its
   streaming extension block (256 members, ``C5_BLOCK``: 2048 rows at the
   end of a 16 384-event window x 768 columns, 678 live; ``bmm_or`` also at
   config 5's ancestry hop, 128 x 128 @ 128 x 16 384), ``ssm_matrix`` on the full config-4
   slab (non-uniform stake), the full config-3 slab and a ragged N; both
   strongly-sees kernels also at stakes summing to ``INT32_MAX // 3`` (the
   envelope's edge) and on small random shapes (K past 256 and past the
   k-steps a member that shared memory holds at once, member tables too
   long for shared memory, ragged rows and columns, -1 slots, cols and
   indices past n, clamped starts).  A compared
   output that is all False or all True fails (a one-output case excepted):
   it could not tell a wrong kernel.  Each fixed shape is timed (median of
   CUDA-event timings after a warm-up) beside its plain version, its least
   time on the card (bound) and, for ``bmm_or``, one library call, with
   ``host_us`` (the host microseconds a call over 200 calls enqueued with no
   synchronize: the wrapper's cost) and ``card_ms`` (a CUDA-graph replay of
   one call: the card's time alone; ``ms`` brackets one call and holds
   both).  A bound counts the work this run's data needs (member-table
   slots that are -1 and padded columns need none): the larger of its
   bytes over the memory rate and its AND-products over the card's peak for
   1-bit products, the binary tensor cores' ``.b1`` AND-popc rate (an
   AND-product two operations, ``B1_OPS_PER_S``); ``ssm_block`` and
   ``ssm_matrix`` also print the operations bound at the data sheet's int8
   rate (``ops_bound_int8_ms``).
4. Both batch paths on BASELINE configs 3 and 4 (64 members, 10 000 events,
   0 and 21 forkers): the port's gossip DAG through ``run_consensus(
   device="cuda")`` with the default column-restricted strongly-sees
   (a warm-up run, then a measured one), with ``ssm_mode="full"`` (a warm-up,
   then a measured one) and with ``use_pallas_ssm=True`` (measured).  For
   each measured run: events/s, per-stage seconds and calls, and the kernel
   launch counts of that run (every kernel of the path > 0, the other
   strongly-sees kernel 0); the SHA-256 digests of its order, rounds, fame
   and round-received are held against golden digests computed from the JAX
   reference on the same DAG.
5. The incremental driver on configs 3 and 4: ``IncrementalConsensus(device=
   "cuda")`` with the reference defaults (block 128, chunk 256, window bucket
   1024, ``fuse_chunks`` 8) ingests the DAG in chunks of 1000 events, and
   config 3 once more with ``fuse_chunks=1`` (the per-chunk rounds loop)
   over its DAG's first ``PREFIX_EVENTS`` (5 000) events, held to
   ``PREFIX_GOLDEN`` (``PREFIX_RUNS``).
   Per pass: seconds, rebased, window, pruned prefix, rounds-scan probes and
   steps, stage seconds and calls, kernel launches.  Each run's ``result()``
   digests must be golden, its per-pass ``ordered`` lists must concatenate to
   its order, at least one pass must not rebase, and over the non-rebase
   passes ``bmm_or`` and ``ssm_block`` must launch and ``ssm_matrix`` not.
   Steady events/s over the back half of the passes (as ``bench.py``
   computes it) beside the same call's warm columns pass.
6. The streaming driver on configs 3 and 4: ``StreamingConsensus(device=
   "cuda")`` with the reference defaults (``ingest_chunk`` 1024, tile 256, no
   budget) over the same chunks.  Per pass as in 5, plus the archived
   rows, resident bytes, overlap ratio and widen / full rebases.  Digests
   golden, per-pass ``ordered`` lists concatenating to the order, ``bmm_or``
   and ``ssm_block`` launched on the non-rebase passes, ``ssm_matrix`` not.
7. Widening on config 3: after 6, the stale-view event of
   ``tests/test_store.py`` (member 3's head with other-parent
   ``events[100]``, long pruned) must be answered by a widening rebase
   (``widen_rebases`` + 1, ``full_rebases`` unchanged, archived rows
   fetched), with ``result()`` digests equal to ``run_consensus(device=
   "cuda")`` over the same history.  Prints the widen's seconds.
8. The row-sharded mesh driver on configs 3 and 4:
   ``MeshStreamingConsensus(make_mesh(2), pallas=True, device="cuda")`` (2
   row shards on one card) over the same chunks as 6.  Digests golden; the
   archive's digest equal to the streaming driver's (6 and 8 print the
   store's stats after draining its pack worker); ``ssm_block`` and
   ``ssm_matrix`` 0 launches; ``bmm_or``, the mesh block and ``ssm_tally``
   launched on the non-rebase passes; ``bmm_or`` launched exactly as often
   as in the streaming run of 6 (the blocks run no member hop), and
   ``ssm_tally`` at most ``MESH_SHARDS`` times a mesh block.
9. ``make_mesh_row_block_fn`` at 2 and 4 shards on the config-3 slab, at the
   extension shape (1024 rows at row 4096 x 256 columns) and the column-add
   shape (full height x 64), exact against ``ssm_block`` and its plain
   version and non-degenerate, timed beside ``ssm_block``; ``ssm_tally``
   alone at one shard's extension shape (shard 0 of 2, which owns 960 of
   the 1024 rows), exact against ``ssm_tally_reference``, the two shards'
   summed threshold non-degenerate and equal to ``ssm_block``'s, with
   ``host_us`` and ``card_ms`` as for ``bmm_or``; a member
   hop ``bmm_or`` at (1024 x K) @ (K x 256) timed beside ``torch.matmul``.
10. The member-sharded batch path on configs 3 and 4: ``run_consensus(
   mesh=make_mesh(MESH_SHARDS), device="cuda")`` (config 3 over its first
   5 000 events; the strongly-sees matrix
   split over the member axis, one ``ssm_tally`` launch a shard an attempt;
   a warm-up run, then a measured one): digests golden, ``ssm_tally``
   launched exactly ``MESH_SHARDS`` times an attempt, ``ssm_matrix`` and
   ``ssm_block`` not, ``bmm_or`` launched; events/s and stage seconds.  Then
   ``ssm_matrix_sharded`` alone at 2 and 4 shards on the config-4 slab with
   non-uniform stake, exact against ``kernels.ssm_matrix`` and
   ``ssm_matrix_reference`` and non-degenerate, timed beside
   ``ssm_matrix``; ``ssm_tally`` alone at one member shard's N x N shape
   (shard 0 of 2), exact against ``ssm_tally_reference``; and
   ``make_ssm_block_fn_for_mesh(make_mesh(2))`` at the extension shape
   (1024 rows at row 4096 x 256 columns, config-3 slab), exact against
   ``ssm_block``.
11. The live node: the port's ``make_simulation(64, seed=LIVE_SEED)`` under
   the simulation signer.  Node 0 is ``backend="tpu"`` (the reference's
   ``block_size``, ``tpu_min_batch`` ``LIVE_MIN_BATCH``), so its consensus
   passes run ``run_consensus`` on the card through the ``TorchEngine`` its
   first pass builds; the 63 peers gossip and run no pass (see
   :func:`live_simulation`).  Gossip until node 0 holds 4 162 events
   (``LIVE_NODES``), then ``flush()``: node 0's digests must be golden (the JAX
   reference's ``run_consensus`` on the same node's DAG), its state must
   equal the port's own ``run_consensus(pack_node(node), device="cuda")``,
   ``bmm_or`` and ``ssm_block`` launched and ``ssm_matrix`` not.  Prints
   every pass (events, seconds).  Then a ``mesh_shape={"members": 2}`` node
   at 3 000 events: digests golden, ``ssm_tally`` launched.
12. Dynamic membership and restore.  (a) The single-epoch pin at full
   width: ``run_dynamic(engine=e, chunk=INC_CHUNK, cross_check=True,
   device="cuda")`` over config 3's first ``DYN_PIN_EVENTS`` events for the
   batch, incremental, streaming and mesh engines (the mesh on
   ``make_mesh(MESH_SHARDS)``): the observer's order equals the native
   engine's and its digest is golden (``PIN_GOLDEN``); per engine
   the observer's and the native engine's seconds and the launches (``bmm_or``
   and ``ssm_block``, or ``bmm_or`` and ``ssm_tally`` for the mesh; never
   ``ssm_matrix``).  (b) The port's ``churn_schedule(**CHURN)`` (16 members,
   a leave and a join, three epochs) through ``run_all_engines`` on the
   card: order, rounds and ledger equal across the engines and to
   ``CHURN_GOLDEN`` (the JAX reference's oracle driver), one repack a
   post-genesis epoch with its outputs on the card, the streaming rows
   stamped with two epochs or more.  (c) ``save_node`` of phase 11's
   columns node, then ``load_node(device="cuda")``, whose replay pass runs
   ``TorchEngine`` on the card: state digest equal to the saved node's,
   ``LIVE_GOLDEN`` digests, ``bmm_or`` and ``ssm_block`` launched and
   ``ssm_matrix`` not, a copy with one byte of the header's order digest
   changed refused; ``save_packed`` / ``load_packed`` of the node's packed
   DAG through ``run_consensus`` golden too.  Prints the replay's and the
   pass's seconds.
13. Observability on the card.  (a) A warm config-3 columns pass under an
   ambient ``obs.Obs`` with a dispatch profiler: golden digests, the
   launches of phase 4's untraced pass, no ``compile`` call, the protocol
   gauges and counters and the rounds-to-decision list equal to the JAX
   reference's (``OBS_GOLDEN``); the report table, the profiler's summary,
   the pass against an untraced one run just after, and Obs's own host
   cost a stage.  (b) The card's busy and idle share: ``trace_consensus``
   over the first ``INC_CHUNK`` events' columns pass, a window of
   ``TRACE_ACTIVE`` rounds-chunk calls of config 3's whole pass
   (``windowed_trace``), and the incremental driver's steady pass
   ``INC_TRACE_PASS``; per trace the window, busy and idle seconds and
   shares (also busy over the untraced time of the same work), kernel
   launches, the top 5 device operations, the hand-written kernels' share
   of busy time and the 5 longest idle gaps with their stage.  (c) Config
   3 through ``IncrementalConsensus`` (``fuse_chunks`` 8) and
   ``StreamingConsensus``, each with a ``FinalityTracker``, a
   ``FlightRecorder``, an ambient Obs and a ``MemoryMonitor(device=
   "cuda")`` phase: golden digests, phase 5 / 6's launches, the
   rounds-to-decision list equal to (a)'s, the ``incremental_*`` /
   ``store_*`` gauges equal to the driver's own counters; phase 5's
   config-4 run carries a flight recorder and a memory phase too, and its
   triggers and every device peak print here.  (d) The live node with
   ``make_simulation(metrics=True, finality=True, flightrec=...)``, node 0
   on the card until it holds ``LIVE_OBS_EVENTS`` events: digests,
   rounds-to-decision lists and gossip counters equal to the reference's
   (``LIVE_OBS_GOLDEN``); ``node_gauges`` of node 0.
14. Chaos and adversaries on the card, under the simulation signer.  (a)
   The chaos acceptance scenario (:func:`acceptance_scenario`: 5 members,
   240 turns, one divergent forker, lossy links, a partition over turns
   80-140, member 4 down over turns 60-120) with member 4 on
   ``backend="tpu"``: its ``TorchEngine`` runs on the card, and its restore
   through ``load_node(device="cuda")``.  The verdict must be ok and its
   protocol fields (:func:`chaos_fields`) equal to ``CHAOS_GOLDEN`` (the JAX
   reference's), the restored node's engine must run passes on the card,
   ``bmm_or`` and ``ssm_block`` launch and ``ssm_matrix`` not; prints the
   node's passes (events, seconds) and the restore's seconds.  (b) Every
   ``SCENARIOS`` entry with ``device="cuda"``, ``horizon_storm`` and
   ``fork_bomb`` replayed through the incremental, streaming and
   8-shard streaming-mesh drivers (block 64, chunk 64, window bucket 256):
   every verdict ok, every engine row's parities true, protocol fields
   equal to ``CHAOS_GOLDEN``, ``ssm_tally`` launched on the mesh rows,
   ``overflow_storm``'s fork leg retried; prints each scenario's host and
   device seconds.  (c) Config 4 through ``IncrementalConsensus`` and
   config 3 through ``StreamingConsensus``, each over its first
   ``PREFIX_EVENTS`` (5 000) events, fed the port's
   ``chunked_ingest_schedule(events, INC_CHUNK, delay_prob=0.02,
   max_delay=3, seed=SEED)``, with the checks of 5 and 6 (digests equal to
   ``PREFIX_GOLDEN`` once moved back to creation order); the schedule must
   move events.
15. The real-process cluster (``tpu_swirld_torch.net``), under the
   machine's default signer, the one every node process uses, through the
   port's ``bench.run_cluster`` at its defaults.  (a) Its chaos leg, uncut
   (5 node processes, 6 s of 300 tx/s, node 1 killed at 1.8 s and restarted
   at 3.0 s from its checkpoint and WAL): bench exit 0, the verdict ok,
   ``prefix_agree`` and ``oracle_agree``, the decided frontier past the
   heal, the victim restarted once with an unclean start and a post-mortem
   on disk; prints the tx ledger, the union's size and the heal time.  (b)
   Its overload leg (3 nodes, 3 s, ``max_undecided=0``): nothing acked,
   every submission shed by the window.  The node processes run the oracle, as
   the reference's do.  (c) (a)'s union event log,
   replayed into an observer in ``oracle_replay``'s order (its order must be
   the verdict's), through ``chaos._engines_agree(engine=e, device="cuda")``
   for ``e`` in ``CLUSTER_ENGINES`` (the streaming driver; the incremental
   one is cut for time, see ``CLUSTER_ENGINES``): every comparison true,
   ``bmm_or`` and ``ssm_block`` launched, ``ssm_matrix`` not; prints each
   replay's seconds beside the union's event count.
16. The model checker, the production-day soak and viz
   (``tpu_swirld_torch.analysis.mc``, ``soak``, ``viz``).  (a) Under the
   simulation signer: ``mc_smoke()`` ok (exhaustive, clean, reduced), the
   ``fork-blind`` mutation caught by ``fork-budget`` with a minimized
   document that replays with all three flags true, and ``chaos_run --mc``'s
   parity document through ``replay_counterexample(engine="incremental",
   device="cuda")``: reproduced, digests and trace equal, both parities
   true, ``bmm_or`` and ``ssm_block`` launched, ``ssm_matrix`` not.  (b)
   Under the machine's default signer, the port's ``bench.run_soak`` at its
   defaults (4 node processes behind per-link fault proxies, seed 3,
   8 s of 150 tx/s from 3 clients, ``smoke_schedule``: an equivocation
   storm in member 3's slot, member 1 killed at 25% and restarted at 45% of
   the horizon, member 0 partitioned at 55-75%) through ``run_soak``: the
   checks of ``tests/test_soak_run.py``'s smoke (verdict ok, 3 of 3
   disruptions survived, proxies relayed, the partition blocked, the storm
   stepped and was detected, the victim restarted unclean, the books
   balanced with nothing leaked); prints tx/s, the submit p99, the union's
   events and fork pairs and the counters.  Its union event log, replayed
   into an observer in ``oracle_replay``'s order (its order must be the
   verdict's), then through ``chaos._engines_agree(engine="streaming",
   device="cuda")``: both parities true, ``bmm_or`` and ``ssm_block``
   launched, ``ssm_matrix`` not.  (c) ``viz.export_state`` of (b)'s
   observer against the export of ``run_consensus(pack_node(observer),
   device="cuda")``: equal, and ``to_json`` of the card's result loads back
   to the same rows.
17. The analysis gates (``tpu_swirld_torch.analysis``), under the
   simulation signer.  (a) ``races.run_archive_schedules(**ARCHIVE_FUZZ,
   device="cuda")``: 32 seeded yield-injection schedules of the archive's
   spill / fetch / checkpoint workload, every spill's rows an owned tensor
   on the card that the pack worker pulls: digests identical, equal to the
   synchronous run's and to ``ARCHIVE_FUZZ_DIGEST`` (the JAX reference's),
   no fetch or checkpoint error, the lock graph acyclic; then the same fuzz
   over :class:`ViewSpillArchive` (a view of a slab spilled, the slab then
   overwritten in place), which the sanitizer must report as not ok.  (b)
   ``chaos_run --sanitize 2 --device cuda`` with ``SANITIZE_ARGS``: the
   verdict ok, both re-runs stable and ok, the archive fuzz's digests
   identical, equal to the synchronous run's and acyclic, the safety section
   equal to ``SANITIZE_SAFETY``; ``bmm_or`` and ``ssm_block`` launched,
   ``ssm_matrix`` not.  (c) ``jit_audit.runtime_audit(engine=AUDIT_ENGINE,
   device="cuda")`` at the reference's defaults: no kernel library built or
   loaded in the steady window, no signature drift, the stages observed
   equal to ``AUDIT_STAGES`` (the CPU's), ``bmm_or`` and ``ssm_block``
   launched, ``ssm_matrix`` not; prints the steady window's seconds.  (d) On
   the host: ``lint_paths`` over the checkout's ``tpu_swirld_torch`` finds
   nothing, ``scripts/lint.sh``'s gates 3 and 4 (``lint.suppression_gate``)
   find nothing, and ``jit_audit.static_audit`` finds exactly
   ``STATIC_AUDIT_FINDINGS``.  Prints each leg's seconds.
18. The scale-envelope audit (``tpu_swirld_torch.analysis.flow``).  Its
   two host audits start first, each in a process of its own
   (``python -m tpu_swirld_torch.analysis scale-audit --envelope
   baseline|1m --no-coverage --json``), and run beside (a) and (b).  (a)
   The soundness property on the card: for each engine of ``FLOW_ENGINES``,
   ``soundness_check(engine, device="cuda")``: a small real run (6
   members, 420 events, seed 3; ``batch`` through both batch paths, ``mesh``
   on the ``pallas=True`` route), the first call of every stage
   snapshotted, re-run on the card and replayed through the interpreter at
   its concrete arguments' intervals: every card output inside its
   abstract interval, the stages observed equal to ``FLOW_STAGES`` (the
   CPU's), and over the four runs ``bmm_or``, ``ssm_block``, ``ssm_matrix``
   and ``ssm_tally`` each launched.  (b) The tally contract on the card:
   ``ssm_tally`` at (a)'s mesh block shapes and at the stake envelope's
   edge (``FLOW_EDGE``: 4 members x 178 956 970, rows that see every
   member): every tally in ``[0, tot_stake]``, the all-seeing rows'
   exactly ``tot_stake``, equal to its plain version; ``ssm_block`` and
   ``ssm_matrix`` at both shapes equal to their plain versions on the
   card's inputs moved to the CPU.  (c) On the host: both envelopes exit 0
   and proven clean, with (a)'s observed stages all covered by the
   catalog; both mutations caught with their rules.  Prints the stamp,
   each leg's seconds and the pull sites with their assumed values.
19. Meshes over several processes (``tpu_swirld_torch.multichip.start``:
   spawned ranks in one ``torch.distributed`` group through a file store,
   every rank on this one card; gloo when ranks share it, nccl for one
   rank; the three groups start at once, and the references they are
   held against are computed while they run).  (a) ``dryrun_multichip`` (``multichip.dryrun_rank``) over 2 and
   4 gloo ranks and 1 nccl rank: every rank at bit-parity with the oracle,
   ``ssm_tally`` launched on every rank, the ranks' digests equal.  (b) The
   member-sharded batch pass on config 3 over 2 gloo ranks
   (``multichip.batch_rank``): digests golden on every rank, ``ssm_tally``
   launched once a rank an attempt, ``ssm_matrix`` and ``ssm_block`` never;
   each rank's events/s and stage seconds.  (c) The row-sharded block at
   the extension shape of phase 9 (config-3 slab, rows 1024 from 4096, 256
   columns) over 1 nccl and 2 gloo ranks, each rank holding only its own
   rows (``multichip.row_block_rank``, both routes): every rank's block
   equal to ``ssm_block``'s and its plain version's.  (d) The streaming
   driver with its window row-sharded over 2 gloo ranks
   (``multichip.streaming_rank``, ``pallas=True``) through
   ``tests/test_mesh_stream.py:170``'s forked schedule (12 members, 1 000
   events, 4 forkers, ingests of 250) and its smoke (:61, 6 members, 300
   events, ingests of 100, whose prunes move rows across the shards):
   every rank's slabs its own ``W / D``
   rows after every ingest, its digests and archive digest equal to the
   one-process ``StreamingConsensus``'s on the card, no repin; each rank's
   bytes handed to collectives a pass, own slab bytes and peak device
   bytes, in all and by stage (``multichip.watch_stage_peaks``), beside
   the one-process driver's.  Prints when each group was done and the
   seconds of the phase.
20. The port's bench (``tpu_swirld_torch.bench``) in this process, its
   ``lint`` / ``mc`` / ``scale_audit`` stamps those of phases 16(a), 17(d) and
   18(c).  (a) ``--stream`` at config 5's full width (256 members) and a cut
   depth (``BENCH_STREAM``: 18 432 events in 9 chunks of 2048, no oracle
   prefix, no profiled passes): exit 0, ``budget_ok``, the decided output's
   digests and count equal to ``BENCH_STREAM_GOLDEN`` (the JAX reference's
   ``StreamingConsensus`` on the same stream); prints events/s, the window's
   and the card's peaks, the archive and the rebases.  (b) The default mode
   (config 3) cut to its plumbing (``BENCH_DEFAULT``: its first 3 000
   events, a 1 000-event oracle prefix, two incremental ingests, a
   1 536-event streaming leg): exit 0, its batch, incremental and streaming
   parities true, the batch digests ``BENCH_DEFAULT_GOLDEN``'s.  (c) ``--chaos-overhead`` and ``--churn`` at their
   defaults: exit 0, their counts equal to the reference's
   (``BENCH_CHAOS_COUNTS``, ``BENCH_CHURN_COUNTS``), the churn's repacks on
   the card.  Each mode's JSON line is printed; ``bmm_or`` and ``ssm_block``
   must launch in each but ``--churn`` (a host replay and the repacks), and
   ``ssm_matrix`` in none.
21. A ``{"kernels": [...]}`` line (all five routes, every kernel's launches
   by path: batch paths, incremental, streaming, widen, mesh, mesh batch,
   live node, dynamic pin, restore, phase 13's, phase 14's, phase 15's
   ``cluster`` replays, phase 16's ``mc``, ``soak`` and ``viz`` runs,
   phase 17's ``sanitize`` and ``jit_audit`` runs, phase 18's ``flow``
   runs, phase 19's ranks and phase 20's bench modes), the card's name and
   power limit, then
   ``{"ok": true, ...}`` as the last line.

Exits nonzero, printing no result, when no CUDA device is present or any
phase fails.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import re
import shutil
import dataclasses
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from tpu_swirld_torch import (
    IncrementalConsensus, MeshStreamingConsensus, StreamingConsensus, crypto,
    load_node, load_packed, make_mesh, make_simulation,
    make_ssm_block_fn_for_mesh, run_all_engines, run_dynamic, save_node,
    save_packed, ssm_matrix_sharded,
)
from tpu_swirld_torch import (
    bench, chaos, chaos_run, multichip, obs, soak, transport, viz,
)
from tpu_swirld_torch.analysis import jit_audit, lint_paths, lint_summary, races
from tpu_swirld_torch.analysis.lint import SUPPRESSION_GATES, suppression_gate
from tpu_swirld_torch.analysis.flow import audit as flow_audit
from tpu_swirld_torch.analysis.flow import stages as flow_stages
from tpu_swirld_torch.analysis.mc import mc_smoke, run_mc
from tpu_swirld_torch.adversary import SCENARIOS
from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.device import StageClock
from tpu_swirld_torch.event import Event
from tpu_swirld_torch.gpu import build, kernels
from tpu_swirld_torch.gpu.pipeline import run_consensus, visibility_stage
from tpu_swirld_torch.membership.sim import churn_schedule
from tpu_swirld_torch.net import cluster as net_cluster
from tpu_swirld_torch.metrics import node_gauges, trace_consensus
from tpu_swirld_torch.obs import (
    DispatchProfiler, FinalityTracker, FlightRecorder, MemoryMonitor, load_dump,
    load_trace,
    record_batch_result,
)
from tpu_swirld_torch.obs.report import render_report
from tpu_swirld_torch.packing import pack_events, pack_node
from tpu_swirld_torch.sim import (
    chunked_ingest_schedule, generate_gossip_dag, stream_gossip_dag,
)

N_MEMBERS = 64
N_EVENTS = 10_000
SEED = 1
CONFIGS = {"config3": 0, "config4": 21}      # name -> forkers
INC_CHUNK = 1000                             # bench.py's BENCH_INC_CHUNK
# incremental run label -> (config, fuse_chunks; None = the default, 8)
INC_RUNS = {
    "config3": ("config3", None),
    "config4": ("config4", None),
    "config3 fuse_chunks=1": ("config3", 1),
}
# path -> (run_consensus kwargs, warm-up run first, kernels it must launch,
#          kernels it must not launch)
PATHS = {
    "columns": ({}, True, ("bmm_or", "ssm_block"), ("ssm_matrix",)),
    "full": ({"ssm_mode": "full"}, True, ("bmm_or", "ssm_matrix"), ("ssm_block",)),
    "pallas": ({"use_pallas_ssm": True}, False, ("bmm_or", "ssm_matrix"), ("ssm_block",)),
}

# Digests of the JAX reference (tpu_swirld.tpu.pipeline.run_consensus on the
# CPU, sim signer, s_max=65 grown by its overflow self-heal) on
# generate_gossip_dag(64, 10000, seed=1[, n_forkers=21]); recomputed by
# tests/test_torch_host.py::test_golden_digests_match_reference.
GOLDEN = {
    "config3": {
        "order": "f2606b6e80cf299344a0a7cee2c94fcee2810edcc24cb41a03cc5c9cfc3aad51",
        "round": "2091ec224244a9b85e075e760a1b5442ae1994eab06b915afaf6f8c61ce959f1",
        "famous": "71f52581595ad71a23f15dc477da8293cdca6e1abea9f3cf8b3f326836c80393",
        "round_received": "2d310e6633cbfc3f6b7c2493d8864f6e40237e053ccb4d17a0032f37cc439c63",
    },
    "config4": {
        "order": "3a1be7bb7e96824591f6f4f106e65a13b76ad578fb04d3afec36291612c8df8e",
        "round": "11d03570edf1614c1e19f73e82f451ac7a3a29e077b9f2211353daf81b39efd6",
        "famous": "a34b6d93e65b3443eeb07539e5d86b5c2d355ac9e370701eb17b0b645f237911",
        "round_received": "60bf6c63a442090204892fdbb12851c63d265171a98d47032f95b3924ef56019",
    },
}

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
# dense int8 tensor-core peak, same source; it counts a multiply-add as two
# operations, so one AND-product (a 0/1 multiply-add) costs two
INT8_OPS_PER_S = 1979e12
OPS_PER_AND = 2
# The card's peak for 1-bit AND-products, which the data sheet does not
# give: mma.sync m16n8k256 .b1 AND-popc from registers on every SM, two
# operations an AND-product, measured by tpu_swirld_torch/dev/mma_rate.py
# (the highest reading, NVIDIA H100 80GB HBM3 at a 700 W power limit; see
# PERF.md).  The strongly-sees kernels run their products at this rate.
B1_OPS_PER_S = 1.0035e16
KERNEL_INFO = {
    "bmm_or": {
        "source": "tpu_swirld_torch/gpu/csrc/bmm_or.cu",
        "replaces": "tpu_swirld/tpu/pallas_kernels.py:313",
    },
    "ssm_block": {
        "source": "tpu_swirld_torch/gpu/csrc/ssm_block.cu",
        "replaces": "tpu_swirld/tpu/pallas_kernels.py:206",
    },
    "ssm_matrix": {
        "source": "tpu_swirld_torch/gpu/csrc/ssm_matrix.cu",
        "replaces": "tpu_swirld/tpu/pallas_kernels.py:106",
    },
    # the row-sharded block over the ssm_tally kernel; its launches count
    # blocks, each at most D ssm_tally launches
    "make_mesh_row_block_fn": {
        "source": "tpu_swirld_torch/gpu/kernels.py",
        "replaces": "tpu_swirld/tpu/pallas_kernels.py:368",
    },
    # one shard's tally: the member hops (bmm_or_pallas) of the route above
    "ssm_tally": {
        "source": "tpu_swirld_torch/gpu/csrc/ssm_tally.cu",
        "replaces": "tpu_swirld/tpu/pallas_kernels.py:380",
    },
}
MESH_SHARDS = 2
STALE_OTHER_PARENT = 100        # tests/test_store.py's long-pruned events[100]

# The live node (phase 11): node 0 of a 64-member gossip simulation.
LIVE_SEED = 1
LIVE_MIN_BATCH = 2000           # node 0's tpu_min_batch: a pass per ~2000 events
# live node label -> (events node 0 gossips up to, tpu_min_batch, mesh_shape)
LIVE_NODES = {
    # cut from 10 000 events to phase 13(d)'s 4 162 (the same DAG), to keep
    # the whole run, phase 14 included, inside its time limit on a slow host
    "columns node": (4_162, LIVE_MIN_BATCH, None),
    # the mesh node's depth is cut to 3 000 events: its full-matrix passes
    # repeat the whole DAG's rounds scan, and phase 10 holds the same path
    # at 10 000
    "mesh_shape node": (3_000, 1000, {"members": MESH_SHARDS}),
}
# Digests of the JAX reference (tpu_swirld.tpu.pipeline.run_consensus(
# pack_node(node 0)) on the CPU, sim signer) after the reference's
# make_simulation(64, seed=LIVE_SEED) gossips, turn for turn as
# gossip_until does, until node 0 holds the label's events; recomputed by
# tests/test_torch_backend.py::test_live_golden_digests_match_reference.
LIVE_GOLDEN = {
    "columns node": {
        "turns": 4294, "events": 4162,
        "order": "70708fd65bd31af719dc80b0d75a544cc7ae82fdc1c758c1891e39b9c613d80d",
        "round": "a3ed43959e6b4bff9c0956199aa1d81abc2707c2e6ff0b8e73696cbfdefd723e",
        "famous": "19621a5c92e729782b880d3ab01a5ef977c1d64b08cc99bbc2d42cac8b934e11",
        "round_received": "39a8d17fdc8bddb001b57bc7f5deecef4cdc349eb6fe7aa5555cfc72155557c5",
    },
    "mesh_shape node": {
        "turns": 3215, "events": 3039,
        "order": "82c2d6512fea210f35167ee20dbef6454abda8a200318240d5ecd8e052f03299",
        "round": "72bacf3fd77c2acdb168897a19d0999c597903af2ab26755f3e4d928265ece7b",
        "famous": "fa2a0450d345194afccae8cab68b896eebe4f73fd5d3ec1380061db9d8dc9d1e",
        "round_received": "4684e12405d4479e21f2707d544c4c28a7cd8f1b542810e1abc320e23d468900",
    },
}
# Dynamic membership (phase 12).  The single-epoch pin: run_dynamic over
# config 3's first DYN_PIN_EVENTS events (cut from 10 000 to keep the run
# inside its time limit on a slow host) through each device engine,
# ingesting INC_CHUNK events a pass.  PIN_GOLDEN is the JAX reference's
# run_consensus on the same events (sim signer), its decided count and
# order digest; recomputed by
# tests/test_torch_host.py::test_pin_golden_matches_reference.
DYN_PIN_EVENTS = 5000
PIN_GOLDEN = {
    "decided": 3208,
    "order": "fa7ef0adc28f7e2f195e4842764aac8e1a61020c545751df4273ba08877f2a83",
}
DYN_ENGINES = ("batch", "incremental", "streaming", "mesh")
# engine -> (kernels it must launch, kernels it must not launch)
DYN_KERNELS = {
    "batch": (("bmm_or", "ssm_block"), ("ssm_matrix",)),
    "incremental": (("bmm_or", "ssm_block"), ("ssm_matrix",)),
    "streaming": (("bmm_or", "ssm_block"), ("ssm_matrix",)),
    "mesh": (("bmm_or", "ssm_tally"), ("ssm_matrix", "ssm_block")),
}
# The multi-epoch churn schedule: member n-1 leaves at turn leave_at and a
# fresh key joins at join_at (three epochs).  Its width is cut from 64 to 16
# members: churn_schedule runs a DynamicNode pass on every sync of every
# node, which at 64 members would not fit the run's time.
CHURN = {"n_nodes": 16, "seed": SEED, "turns": 2400, "leave_at": 120, "join_at": 1000}
# Digests of the JAX reference's run_dynamic(engine="oracle") on the
# reference's churn_schedule(**CHURN) under the sim signer (see
# dynamic_digests); recomputed by
# tests/test_torch_membership.py::test_churn_golden_digests_match_reference.
CHURN_GOLDEN = {
    "events": 2388, "decided": 2060, "epochs": 3,
    "order": "b909debfc505b85efd7be5f3b1e5761e35bc751938751fdb69aa1ab92987d1cf",
    "round": "5a30eed616b0972619c3d62a7663b454bea18584c953cb26f1ef3ec689e41328",
    "ledger": "9c15e7df1199a3a69753723a636ce6b799fc556e1ed47a3f826cb7edd48dbccc",
}
KERNELS = {name: getattr(kernels, name) for name in KERNEL_INFO}

# Observability on the card (phase 13).  The protocol gauges and counters
# the JAX reference's registry holds after run_consensus on config 3 under
# its ambient Obs, and the SHA-256 of that pass's rounds-to-decision list;
# recomputed by tests/test_torch_obs.py::test_obs_golden_matches_reference.
OBS_GAUGES = (
    "pipeline_events", "pipeline_pad_events", "pipeline_s_max", "pipeline_block",
    "pipeline_r_max", "pipeline_overflow_retries_total",
    "pipeline_ssm_columns_total", "pipeline_chunk_scans_total",
)
OBS_GOLDEN = {
    "pipeline_events": 10000.0, "pipeline_pad_events": 112.0, "pipeline_s_max": 65.0,
    "pipeline_block": 128.0, "pipeline_r_max": 192.0,
    "pipeline_overflow_retries_total": None,      # no retry: the counter never made
    "pipeline_ssm_columns_total": 954.0, "pipeline_chunk_scans_total": 136.0,
    "rtd": {"n": 8051,
            "sha256": "85abdbfc8f83c42f7f0baebfab1e977df5a1a3d3907a711a7babc1237e1ea7af"},
}
# The live node with its observability: make_simulation(64, seed=LIVE_SEED,
# metrics=True, finality=True, flightrec=...) until node 0 holds
# LIVE_OBS_EVENTS events (two passes at LIVE_MIN_BATCH).  From the JAX
# reference's simulation: node 0's digests and rounds-to-decision list
# (run_consensus on its DAG, record_batch_result), the list its live oracle
# node 0 had recorded by then ("oracle_rtd": a prefix of the first, since
# the oracle decides rounds as they settle on its own passes) and the
# population's gossip counters; recomputed by
# tests/test_torch_finality.py::test_live_obs_golden_matches_reference.
LIVE_OBS_EVENTS = 4162
LIVE_OBS_GOLDEN = {
    "turns": 4294, "events": 4162,
    "order": "70708fd65bd31af719dc80b0d75a544cc7ae82fdc1c758c1891e39b9c613d80d",
    "round": "a3ed43959e6b4bff9c0956199aa1d81abc2707c2e6ff0b8e73696cbfdefd723e",
    "famous": "19621a5c92e729782b880d3ab01a5ef977c1d64b08cc99bbc2d42cac8b934e11",
    "round_received": "39a8d17fdc8bddb001b57bc7f5deecef4cdc349eb6fe7aa5555cfc72155557c5",
    "rtd": {"n": 2447,
            "sha256": "269a1ddd3d1a6a2802d5a5944aad0ebc762d751bbd0f759def5e857a91820ef5"},
    "oracle_rtd": {"n": 1759,
                   "sha256": "39de2d9639ecb307bd22c4ff27836729b249662a34d59768a8fab0e1113c0336"},
    "gossip": {"gossip_bytes_in": 50048936, "gossip_bytes_out": 1374080,
               "gossip_events_received": 257335, "gossip_syncs": 4294},
}
# The traced passes' Chrome traces go here (listed in .gitignore), and are
# removed once read.
TRACE_DIR = "swirld-trace"

# Chaos and adversaries (phase 14).  (a) The acceptance scenario with this
# member on the card; (b) every SCENARIOS entry, these replayed through all
# three windowed drivers; (c) configs 3 and 4 under a straggler arrival
# schedule (events held back up to 3 chunks).
CHAOS_TPU_NODE = 4
CHAOS_ENGINES = ("incremental", "streaming", "streaming-mesh")
CHAOS_MULTI = ("horizon_storm", "fork_bomb")
STRAGGLERS = {"delay_prob": 0.02, "max_delay": 3}
STRAGGLER_RUNS = {"config4": "incremental", "config3": "streaming"}
# Both run over their configuration's first PREFIX_EVENTS events (cut from
# 10 000 to pay for phase 20: 46.4 s and 22.9 s of launch-bound replays on
# an H100 at 700 W in full), held to PREFIX_GOLDEN: the JAX reference's
# run_consensus over the same prefix on the CPU, sim signer
# (tests/test_torch_bench.py::test_prefix_golden_matches_reference).  A
# 5 000-event DAG of generate_gossip_dag is the prefix of the 10 000-event
# one; config 3's order digest is PIN_GOLDEN's.
PREFIX_EVENTS = 5000
# Phase 5's per-chunk loop and phase 10's member-sharded batch pass over
# config 3 run over its first PREFIX_EVENTS events too (cut from 10 000 to
# fit phase 20; phases 4, 5, 6 and 8 drive config 3 whole through the same
# stages).  Config 4, the only forked DAG, runs whole everywhere but 14(c).
PREFIX_RUNS = {("incremental", "config3 fuse_chunks=1"), ("mesh_batch", "config3")}
PREFIX_GOLDEN = {
    "config3": {
        "order": "fa7ef0adc28f7e2f195e4842764aac8e1a61020c545751df4273ba08877f2a83",
        "round": "1a44c92f4828b6a604e3cf1daa0b60e95848748e849a53f8a26a0e043b43fd46",
        "famous": "dffdf4bd4adf5db2d7f1a7ae019ddee34a099a0e9b89e3895af1bae88eff0564",
        "round_received": "119eacec65295b664a639354c750cde6718edddeab0098d282bc0038ccdc2260",
    },
    "config4": {
        "order": "97cc4530e07a901163bbc1e41e13bbdaece550d2ec8ffca7078e5aa1d8bdab24",
        "round": "59036ae9da33f9cdf9b0c9c9f912ad3cedda9ec2efe78b19053be1137459a962",
        "famous": "93cb23f84e4dbed3222a83b5e4c78bc6dcbfa5fdbb7482952b16cfce33da1afa",
        "round_received": "495fe298e55b7ddfbee0cf83bc270e422678df35d80f34c35012cfcc3f0cadbf",
    },
}

# The real-process cluster (phase 15).  (a) and (b): the port's bench
# --cluster at its defaults (bench.py:1021-1081), uncut: the chaos leg, 5
# node processes, 6 s of 300 tx/s of 64-byte txs, node 1 killed at 1.8 s and
# restarted at 3.0 s, then the overload leg, 3 nodes with a zero admission
# window for 3 s; (c) (a)'s union event log through these windowed engines
# on the card, as chaos._engines_agree replays it.  The
# incremental engine is cut from (c): on such a union its replay rebases 13
# times (the restarted node's pruned pre-crash head, then the rebase-storm
# guard), each a launch-bound columns pass: 87.7-130.7 s on an H100 (700 W)
# against 19.3-25.2 s for streaming.  The reference's drivers rebase as
# often on the same union: tests/test_torch_cluster.py::
# test_cluster_union_replay_matches_reference replays a saved union of this
# leg through both engines of both packages on the CPU.
CLUSTER_SPEC = {"n_nodes": 5, "seed": 9}     # BENCH_CLUSTER_NODES, BENCH_CLUSTER_SEED
CLUSTER_ENGINES = ("streaming",)

# The model checker, the soak and viz (phase 16).  (b) runs the port's bench
# --soak at its defaults (bench.py:1152-1168) through run_soak: 4 node processes
# behind per-link fault proxies, seed 3, an 8 s horizon of 150 tx/s of
# 64-byte txs from 3 clients, smoke_schedule's three windows, gossip every
# 5 ms and a checkpoint every 0.5 s; its union (forked by the storm's member)
# replays through this windowed engine on the card.
SOAK_SPEC = {"n_nodes": 4, "seed": 3}        # BENCH_SOAK_NODES, BENCH_SOAK_SEED
SOAK_ENGINE = "streaming"
# The analysis gates (phase 17).  (a) The archive fuzz: the reference's
# acceptance setting (tests/test_analysis.py:317), rows as owned tensors on
# the card; its digest is the JAX reference's run_archive_schedules digest
# for the same seed and rows, recomputed by tests/test_torch_races.py.
ARCHIVE_FUZZ = {"n_schedules": 32, "seed": 0, "rows": 96}
ARCHIVE_FUZZ_DIGEST = "31e01c02aabca818517de27c15e3e0dca4720e897834ae91e970aa675ff6cada"
# (b) chaos_run --sanitize with tests/test_analysis.py:408-426's arguments
SANITIZE_ARGS = ["--seed", "3", "--plan-seed", "3", "--nodes", "4", "--turns", "120",
                 "--forkers", "0", "--checkpoint-every", "40", "--sanitize", "2"]
# and the safety section of its verdict: the JAX reference's
# scripts/chaos_run.py on the same arguments under the simulation signer,
# recomputed by tests/test_torch_races.py
SANITIZE_SAFETY = {"common_prefix_len": 12, "oracle_agree": True, "oracle_len": 12,
                   "prefix_agree": True}
# (c) runtime_audit at the reference's defaults through this engine: the
# stages it observes, as the same audit observes them on the CPU
# (tests/test_torch_jit_audit.py recomputes the set)
AUDIT_ENGINE = "streaming"
AUDIT_STAGES = ["pipeline.inc_extend_vis", "pipeline.inc_fame", "pipeline.inc_order",
                "pipeline.inc_prune", "pipeline.inc_ssm_update",
                "pipeline.rounds_span_stage", "pipeline.ssm_block_stage"]
# (d) the static audit's findings on this tree, (path, stage, message), as
# PERF.md records them (tests/test_torch_jit_audit.py holds the list)
STATIC_AUDIT_FINDINGS = []
# The scale-envelope audit (phase 18).  (a) The engines of the soundness
# property and the stages each one's small run observes, as the same run
# observes them on the CPU (tests/test_torch_flow.py recomputes them).
FLOW_ENGINES = ("batch", "incremental", "streaming", "mesh")
_INC_STAGES = ["pipeline.fame_order_cols_stage", "pipeline.inc_extend_vis",
               "pipeline.inc_fame", "pipeline.inc_order", "pipeline.inc_prune",
               "pipeline.inc_ssm_update", "pipeline.rounds_chunk_stage",
               "pipeline.rounds_span_stage", "pipeline.ssm_block_stage",
               "pipeline.visibility_stage"]
FLOW_STAGES = {
    "batch": ["pipeline.fame_order_cols_stage", "pipeline.fame_order_stage",
              "pipeline.rounds_chunk_stage", "pipeline.rounds_scan_stage",
              "pipeline.ssm_block_stage", "pipeline.ssm_matrix_stage",
              "pipeline.visibility_stage"],
    "incremental": _INC_STAGES,
    "streaming": _INC_STAGES,
    "mesh": sorted(s.replace("ssm_block_stage", "ssm_block_mesh") for s in _INC_STAGES),
}
# (b) the stake envelope's edge: 4 members at the stake that
# tests/test_torch_envelope.py pins (3 * tot_stake <= INT32_MAX, one more
# and every entry point raises)
FLOW_EDGE = {"members": 4, "stake": 178_956_970, "n": 256, "k": 64, "cols": 64,
             "seeing_rows": 8, "density": 0.05}
# Meshes over several processes (phase 19): the groups, (backend, ranks),
# and what each runs; every rank on this one card
GROUP_RUNS = {("gloo", 2): ("dryrun", "batch", "block", "forks", "smoke"),
              ("gloo", 4): ("dryrun",), ("nccl", 1): ("dryrun", "block")}
GROUP_BATCH_CONFIG = "config3"
GROUP_BLOCK = {"row0": 4096, "rows": 1024, "cols": 256}   # phase 9's extension block
# (d) tests/test_mesh_stream.py:170's forked window and :61's smoke (its
# prunes move rows across the shards), on the ssm_tally route
GROUP_STREAMS = {
    "forks": {"members": 12, "events": 1000, "seed": 4, "forkers": 4, "ingest": 250,
              "driver": {"chunk": 64, "window_bucket": 512, "prune_min": 128,
                         "ingest_chunk": 256}},
    "smoke": {"members": 6, "events": 300, "seed": 9, "forkers": 0, "ingest": 100,
              "driver": {"chunk": 64, "window_bucket": 256, "prune_min": 64,
                         "ingest_chunk": 128}},
}
GROUP_TIMEOUT = 300
# The port's bench (phase 20), in this process through tpu_swirld_torch.bench.
# (a) --stream at config 5's full width (256 members, BASELINE.json
# configs[4]), its depth cut from 100 000 events to the first multiple of
# the 2048-event chunk at which the stream decides 2048 events or more
# (16 384 decide 1 573, 18 432 decide 8 671); no oracle prefix (at 256
# members the pure-Python oracle decides its first event only past ~12 000
# events, 36 min of host time on the card's host: the goldens below cover
# the whole decided output instead) and no profiled passes.  BENCH_MEM=0
# here and in (b): the host's tracemalloc monitor slows the host-bound
# rounds scan ~1.5-1.8x (config 3's warm columns pass 19.9 s under it in the
# CLI's default mode, 11.0 s in phase 4); the card's peaks are still read.
BENCH_STREAM = {"BENCH_STREAM_EVENTS": 18432, "BENCH_STREAM_ORACLE": 0,
                "BENCH_STREAM_PROFILE": 0, "BENCH_MEM": 0}
# its decided output: the JAX reference's StreamingConsensus over the same
# stream with bench.py --stream's driver settings, on the CPU under the
# simulation signer (tests/test_torch_bench.py::
# test_bench_stream_golden_matches_reference recomputes it)
BENCH_STREAM_GOLDEN = {
    "order": "fbe8519911560cc757ff50b7f80fa9584dc8fb4097943805928cd7529eb84b1c",
    "round": "379e7f604802444d0e28fd27c04f5399b0dd59700a970bd4fb0b37206b372d90",
    "famous": "209f28cb443efad124d36705319c4e2909065344180d0e30806790ef06435ff4",
    "round_received": "eacac681c8dd5d4ddfefa80a46fa90fc7b21f7a7a6a0c1405d8e4ba76da411a4",
    "ordered": 8671,
}
# (b) the default mode (config 3), cut to check the bench's own plumbing
# (its legs, keys and parities; phases 4-6 drive config 3 whole through the
# same batch, incremental and streaming drivers): the DAG to its first 3 000
# events (2 000 and 2 500 decide none, 3 000 decide 1 105), the
# oracle prefix to 1 000 (the pure-Python pass over 10 000 events, 141 s on
# the card's host, is host time phase 4's goldens already cover), the
# incremental leg to two ingests of 1 500 and the streaming leg to one
# gossip batch of four 384-event chunks (1 536 events decide 288; four
# 256-event chunks decide none).  Its batch output is held to
# BENCH_DEFAULT_GOLDEN: the JAX reference's run_consensus over the same DAG
# on the CPU, sim signer (recomputed by tests/test_torch_bench.py::
# test_prefix_golden_matches_reference).
BENCH_DEFAULT = {"BENCH_EVENTS": 3000, "BENCH_ORACLE_EVENTS": 1000,
                 "BENCH_INC_CHUNK": 1500, "BENCH_DEFAULT_STREAM_EVENTS": 1536,
                 "BENCH_DEFAULT_STREAM_CHUNK": 384, "BENCH_MEM": 0}
BENCH_DEFAULT_GOLDEN = {
    "order": "0e300f1526f33f3de2b9d3625ecf0ba69b21cfc854fcf19735d4cc45dbc48f2a",
    "round": "12674d59d59d42f131941cb15015ad6ecfe54b041354707f7d80ad9a40e75bab",
    "famous": "f3781eec682a0de7e94043504485af7b67d035348f826a924e4613108f577052",
    "round_received": "9c6a86dc65d6c5650e86edd0565055dbc0690976277d9df3959f7d31161d6eea",
}
# (c) --chaos-overhead and --churn at their defaults: their counts, as the
# reference's bench.py gives them on the CPU under the simulation signer
# (recomputed by the same test)
BENCH_CHAOS_COUNTS = {"n_forkers": 10, "fork_pairs": 10388, "overflow_retries": 0}
BENCH_CHURN_COUNTS = {"epochs": 3, "decided": 326, "restatements": 2,
                      "repack_samples": 60, "events": 700}
# the stamps of phase 20's lines, as phases 16(a), 17(d) and 18(c) compute
# them (the bench would run each again)
STAMPS = {}
# config 5's kernel shapes (phase 3): the streaming driver at 256 members
# over C5_WINDOW events hops the ancestry as 128 x 128 @ 128 x C5_WINDOW and
# runs its extension block over one ingest's rows at the window's end x the
# live witness columns (C5_BLOCK; 678 live of 768 when the streaming driver
# runs the stream on the CPU, at this window)
C5_MEMBERS = 256
C5_WINDOW = 16384
C5_BLOCK = {"row0": 14336, "rows": 2048, "cols": 768, "live": 678,
            "col_range": (8192, 14336)}
# The JAX reference's verdicts (tpu_swirld.chaos / tpu_swirld.adversary on
# the CPU, sim signer) of phase 14's legs, as chaos_fields gives them: every
# section without wall times or the flight recorder's path, plus the SHA-256
# of the oracle replay's order.  "acceptance" is acceptance_scenario() with
# member 4 on backend="tpu"; the SCENARIOS entries run as phase 14(b) runs
# them.  Recomputed by tests/test_torch_chaos.py and
# tests/test_torch_adversary.py.
CHAOS_GOLDEN = {
    "acceptance": {
        "faults": {"corruptions": 31, "crash_blocked": 18, "delays": 9, "drops": 147,
            "duplicates": 13, "partition_blocked": 39, "peer_errors": 21, "reorders":
            6},
        "liveness": {"advanced_after_heal": True, "decided_at_heal": 0, "decided_final":
            29, "heal_turn": 140},
        "ok": True,
        "oracle_order_sha256":
            "1466a621e489ef52e75ac316567cc11ae070956599f8b9236256024562083372",
        "resilience": {"backoff_total": 136.546, "bad_replies": 5, "bad_requests": 19,
            "budget_exhausted": 0, "circuit_opens": 41, "crashes": 1,
            "equivocations_detected": 63, "forks_detected": 1, "horizon_violations": 0,
            "late_witnesses": 0, "orphans_parked": 0, "quarantined_member_indices": [0,
            2, 4], "restarts": 1, "retries": 82, "sync_branches_capped": 0,
            "withholding_suspected": 0},
        "safety": {"common_prefix_len": 29, "oracle_agree": True, "oracle_len": 109,
            "prefix_agree": True},
        "scenario": {"adversary_indices": [], "attack_end": 0, "n_forkers": 1,
            "n_nodes": 5, "n_turns": 240, "plan_seed": 3, "seed": 3},
    },
    "censorship": {
        "adversary": {"budget_exhausted": 0, "equivocations_detected": 0,
            "horizon_violations": 0, "late_witnesses": 0, "strategy": "censorship",
            "sync_branches_capped": 0, "withholding_suspected": 11},
        "engines": {"batch_oracle_parity": True, "engine": "incremental",
            "incremental_batch_parity": True, "incremental_rebases": 1},
        "faults": {},
        "liveness": {"advanced_after_heal": True, "decided_at_heal": 111,
            "decided_final": 335, "heal_turn": 120},
        "ok": True,
        "oracle_order_sha256":
            "3c4879f3b6113803ed3ddc4dcdf2f0f38eb7eee3ff384199d1fabb426dd69503",
        "resilience": {"backoff_total": 0.0, "bad_replies": 0, "bad_requests": 0,
            "budget_exhausted": 0, "circuit_opens": 0, "crashes": 0,
            "equivocations_detected": 0, "forks_detected": 0, "horizon_violations": 0,
            "late_witnesses": 0, "orphans_parked": 0, "quarantined_member_indices": [],
            "restarts": 0, "retries": 0, "sync_branches_capped": 0,
            "withholding_suspected": 11},
        "safety": {"common_prefix_len": 335, "oracle_agree": True, "oracle_len": 346,
            "prefix_agree": True},
        "scenario": {"adversary_indices": [0], "attack_end": 120, "n_forkers": 0,
            "n_nodes": 5, "n_turns": 200, "plan_seed": 0, "seed": 3},
    },
    "delayed_release": {
        "adversary": {"budget_exhausted": 0, "equivocations_detected": 0,
            "horizon_violations": 0, "late_witnesses": 8, "strategy": "delayed_release",
            "sync_branches_capped": 0, "withholding_suspected": 0},
        "engines": {"batch_oracle_parity": True, "engine": "incremental",
            "incremental_batch_parity": True, "incremental_rebases": 7},
        "faults": {},
        "liveness": {"advanced_after_heal": True, "decided_at_heal": 121,
            "decided_final": 345, "heal_turn": 140},
        "ok": True,
        "oracle_order_sha256":
            "b7116b1a57a734f64c32202009bb78b96a51ab335c523161a4c9335aef627d7e",
        "resilience": {"backoff_total": 0.0, "bad_replies": 0, "bad_requests": 0,
            "budget_exhausted": 0, "circuit_opens": 0, "crashes": 0,
            "equivocations_detected": 0, "forks_detected": 0, "horizon_violations": 0,
            "late_witnesses": 8, "orphans_parked": 0, "quarantined_member_indices": [],
            "restarts": 0, "retries": 0, "sync_branches_capped": 0,
            "withholding_suspected": 0},
        "safety": {"common_prefix_len": 345, "oracle_agree": True, "oracle_len": 384,
            "prefix_agree": True},
        "scenario": {"adversary_indices": [0], "attack_end": 140, "n_forkers": 0,
            "n_nodes": 5, "n_turns": 230, "plan_seed": 0, "seed": 5},
    },
    "equivocation_storm": {
        "adversary": {"budget_exhausted": 0, "equivocations_detected": 55,
            "horizon_violations": 0, "late_witnesses": 0, "strategy":
            "equivocation_storm", "sync_branches_capped": 0, "withholding_suspected":
            0},
        "engines": {"batch_oracle_parity": True, "engine": "incremental",
            "incremental_batch_parity": True, "incremental_rebases": 1},
        "faults": {},
        "liveness": {"advanced_after_heal": True, "decided_at_heal": 65,
            "decided_final": 210, "heal_turn": 120},
        "ok": True,
        "oracle_order_sha256":
            "59cd2daca6edae08e856e6c44baceb93b86a44ea51f0bf1ccea1eadbcbceda9b",
        "resilience": {"backoff_total": 0.0, "bad_replies": 0, "bad_requests": 0,
            "budget_exhausted": 0, "circuit_opens": 15, "crashes": 0,
            "equivocations_detected": 55, "forks_detected": 1, "horizon_violations": 0,
            "late_witnesses": 0, "orphans_parked": 0, "quarantined_member_indices": [],
            "restarts": 0, "retries": 0, "sync_branches_capped": 0,
            "withholding_suspected": 0},
        "safety": {"common_prefix_len": 210, "oracle_agree": True, "oracle_len": 210,
            "prefix_agree": True},
        "scenario": {"adversary_indices": [0], "attack_end": 120, "n_forkers": 0,
            "n_nodes": 5, "n_turns": 200, "plan_seed": 0, "seed": 7},
    },
    "fork_bomb": {
        "adversary": {"budget_exhausted": 0, "equivocations_detected": 250, "f_budget":
            2, "horizon_violations": 0, "late_witnesses": 0, "n_forkers": 2, "strategy":
            "fork_bomb", "sync_branches_capped": 0, "withholding_suspected": 0},
        "engines": [{"batch_oracle_parity": True, "engine": "incremental",
            "incremental_batch_parity": True, "incremental_rebases": 1},
            {"batch_oracle_parity": True, "engine": "streaming",
            "incremental_batch_parity": True, "incremental_rebases": 1, "store":
            {"archived_rows": 0, "budget_overruns": 0, "budget_tiles": None,
            "device_budget_tiles": None, "device_resident_tiles": 21, "fetched_rows": 0,
            "fetches": 0, "n_shards": 1, "peak_device_tiles": 21, "peak_resident_bytes":
            1376256, "peak_resident_tiles": 21, "resident_bytes": 1376256,
            "resident_tiles": 21, "spilled_rows": 0, "spills": 0, "tile": 256},
            "widen_rebases": 0}, {"batch_oracle_parity": True, "engine":
            "streaming-mesh", "incremental_batch_parity": True, "incremental_rebases":
            1, "mesh_devices": 8, "mesh_repins": 0, "store": {"archived_rows": 0,
            "budget_overruns": 0, "budget_tiles": None, "device_budget_tiles": None,
            "device_resident_tiles": 7, "fetched_rows": 0, "fetches": 0, "n_shards": 8,
            "peak_device_tiles": 7, "peak_resident_bytes": 1376256,
            "peak_resident_tiles": 21, "resident_bytes": 1376256, "resident_tiles": 21,
            "spilled_rows": 0, "spills": 0, "tile": 256}, "widen_rebases": 0}],
        "faults": {},
        "liveness": {"advanced_after_heal": True, "decided_at_heal": 21,
            "decided_final": 209, "heal_turn": 130},
        "ok": True,
        "oracle_order_sha256":
            "36b16edf8958a23f8f1520086a0e89fc472cbab8c71e9a270146544f092e8aa2",
        "resilience": {"backoff_total": 0.0, "bad_replies": 0, "bad_requests": 0,
            "budget_exhausted": 0, "circuit_opens": 33, "crashes": 0,
            "equivocations_detected": 250, "forks_detected": 2, "horizon_violations": 0,
            "late_witnesses": 0, "orphans_parked": 0, "quarantined_member_indices": [0,
            1], "restarts": 0, "retries": 0, "sync_branches_capped": 0,
            "withholding_suspected": 0},
        "safety": {"common_prefix_len": 209, "oracle_agree": True, "oracle_len": 350,
            "prefix_agree": True},
        "scenario": {"adversary_indices": [0, 1], "attack_end": 130, "n_forkers": 0,
            "n_nodes": 7, "n_turns": 220, "plan_seed": 0, "seed": 2},
    },
    "fork_bomb_overbudget": {
        "adversary": {"budget_exhausted": 1, "equivocations_detected": 375, "f_budget":
            2, "horizon_violations": 0, "late_witnesses": 0, "n_forkers": 3,
            "silent_divergence": False, "strategy": "fork_bomb_overbudget",
            "sync_branches_capped": 0, "withholding_suspected": 0},
        "faults": {},
        "liveness": {"advanced_after_heal": False, "decided_at_heal": 0,
            "decided_final": 0, "heal_turn": 130},
        "ok": True,
        "oracle_order_sha256":
            "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
        "resilience": {"backoff_total": 0.0, "bad_replies": 0, "bad_requests": 0,
            "budget_exhausted": 1, "circuit_opens": 41, "crashes": 0,
            "equivocations_detected": 375, "forks_detected": 3, "horizon_violations": 0,
            "late_witnesses": 0, "orphans_parked": 0, "quarantined_member_indices": [1,
            2], "restarts": 0, "retries": 0, "sync_branches_capped": 0,
            "withholding_suspected": 0},
        "safety": {"common_prefix_len": 0, "oracle_agree": True, "oracle_len": 0,
            "prefix_agree": True},
        "scenario": {"adversary_indices": [0, 1, 2], "attack_end": 130, "n_forkers": 0,
            "n_nodes": 7, "n_turns": 220, "plan_seed": 0, "seed": 2},
    },
    "horizon_storm": {
        "engines": [{"batch_oracle_parity": True, "engine": "incremental",
            "incremental_batch_parity": True, "incremental_rebases": 3},
            {"batch_oracle_parity": True, "engine": "streaming",
            "incremental_batch_parity": True, "incremental_rebases": 3, "store":
            {"archived_rows": 85, "budget_overruns": 0, "budget_tiles": None,
            "device_budget_tiles": None, "device_resident_tiles": 10, "fetched_rows": 0,
            "fetches": 0, "n_shards": 1, "peak_device_tiles": 10, "peak_resident_bytes":
            655360, "peak_resident_tiles": 10, "resident_bytes": 655360,
            "resident_tiles": 10, "spilled_rows": 85, "spills": 1, "tile": 256},
            "widen_rebases": 0}, {"batch_oracle_parity": True, "engine":
            "streaming-mesh", "incremental_batch_parity": True, "incremental_rebases":
            3, "mesh_devices": 8, "mesh_repins": 0, "store": {"archived_rows": 85,
            "budget_overruns": 0, "budget_tiles": None, "device_budget_tiles": None,
            "device_resident_tiles": 5, "fetched_rows": 0, "fetches": 0, "n_shards": 8,
            "peak_device_tiles": 5, "peak_resident_bytes": 655360,
            "peak_resident_tiles": 10, "resident_bytes": 655360, "resident_tiles": 10,
            "spilled_rows": 85, "spills": 1, "tile": 256}, "widen_rebases": 0}],
        "faults": {"partition_blocked": 42},
        "horizon": {"batch_oracle_parity": True, "engine": "incremental",
            "horizon_violations": 0, "incremental_batch_parity": True,
            "incremental_rebases": 3, "late_witnesses": 8},
        "liveness": {"advanced_after_heal": True, "decided_at_heal": 0, "decided_final":
            154, "heal_turn": 173},
        "ok": True,
        "oracle_order_sha256":
            "d219f651dd530e22d863a9bea1db9b545b55dfd71bbacddf32a0786beb02e45a",
        "resilience": {"backoff_total": 29.488, "bad_replies": 0, "bad_requests": 0,
            "budget_exhausted": 0, "circuit_opens": 27, "crashes": 0,
            "equivocations_detected": 17, "forks_detected": 1, "horizon_violations": 0,
            "late_witnesses": 8, "orphans_parked": 0, "quarantined_member_indices": [4],
            "restarts": 0, "retries": 16, "sync_branches_capped": 0,
            "withholding_suspected": 0},
        "safety": {"common_prefix_len": 154, "oracle_agree": True, "oracle_len": 154,
            "prefix_agree": True},
        "scenario": {"adversary_indices": [], "attack_end": 0, "n_forkers": 0,
            "n_nodes": 5, "n_turns": 260, "plan_seed": 1, "seed": 1},
    },
    "membership_churn": {
        "adversary": {"budget_exhausted": 0, "equivocations_detected": 33,
            "forks_detected": 1, "pairs_fed": 80, "strategy": "membership_churn"},
        "checkpoint": {"epochs": 3, "ok": True},
        "engines": {"archive_epochs_spanned": 3, "decided": 790, "epochs": 3,
            "mesh_repins": [4, 5, 5], "parity": True, "repacks": [{"activation_round":
            6, "epoch_id": 1, "members_after": 5, "members_before": 4, "rows_added": 1},
            {"activation_round": 25, "epoch_id": 2, "members_after": 5,
            "members_before": 5, "rows_added": 0}], "restatements": 1},
        "liveness": {"advanced_after_vote_out": True, "decided": 790,
            "decided_at_vote_out": 606},
        "membership": {"activation_round": 25, "adversary_events_post_activation": 175,
            "epochs": 3, "joined": True, "joiner_decided": 790, "voted_out": True,
            "witness_gating_ok": True},
        "ok": True,
        "safety": {"prefix_agree": True},
        "scenario": {"name": "membership_churn", "seed": 11},
    },
    "overflow_storm": {
        "fork_storm": {"fork_pairs": 767, "overflow_retries": 1, "parity": True},
        "ok": True,
        "round_clamp": {"max_round": 13, "overflow_retries": 1, "parity": True},
        "scenario": {"name": "overflow_storm", "seed": 4},
    },
}


class ViewSpillArchive(races.SanitizedArchive):
    """Phase 17(a)'s sensitivity fixture: each spill hands the archive a
    view of a slab and then overwrites that slab in place, the hazard
    ``StreamingConsensus._on_prune`` clones to avoid.  The pack worker pulls
    the rows after the overwrite, so the sanitizer must report the fuzz as
    not ok."""

    def spill(self, lo, parents, rows):
        slab = rows.clone()
        added = super().spill(lo, parents, slab[:, :])
        slab.zero_()
        return added


def golden_for(name, n_events):
    """The JAX reference's digests of configuration ``name`` over its first
    ``n_events`` events (``GOLDEN`` in full, ``PREFIX_GOLDEN`` at
    ``PREFIX_EVENTS``)."""
    return {N_EVENTS: GOLDEN, PREFIX_EVENTS: PREFIX_GOLDEN}[n_events][name]


def prefix_dag(dag):
    """``dag`` cut to its first ``PREFIX_EVENTS`` events (packed again)."""
    members, stake, events, _packed, keys = dag
    events = events[:PREFIX_EVENTS]
    return members, stake, events, pack_events(events, members, stake), keys


def reset_launches():
    """Set every kernel's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0


def result_digests(packed, result) -> dict:
    """SHA-256 digests of a consensus result over ``packed``'s event ids
    (:func:`tpu_swirld_torch.bench.result_digests`)."""
    return bench.result_digests(lambda i: packed.ids[i], result)


def rtd_digest(rtd) -> dict:
    """The length and SHA-256 (little-endian int32) of a rounds-to-decision
    list."""
    return {"n": len(rtd),
            "sha256": hashlib.sha256(np.asarray(rtd, "<i4").tobytes()).hexdigest()}


def gossip_totals(nodes) -> dict:
    """Every ``gossip_*`` counter summed over the nodes' ``Metrics``."""
    out = {}
    for node in nodes:
        for k, v in node.metrics.counts.items():
            if k.startswith("gossip_"):
                out[k] = out.get(k, 0) + v
    return dict(sorted(out.items()))


def config5_window():
    """``(packed, sees)`` of config 5's first ``C5_WINDOW`` events (BASELINE
    config 5's stream, ``bench --stream``'s generator), the sees slab on the
    card: phase 3's inputs at config 5's shapes."""
    members, stake, _keys, chunks = stream_gossip_dag(C5_MEMBERS, C5_WINDOW, 2048,
                                                      seed=SEED)
    packed = pack_events([ev for chunk in chunks for ev in chunk], members, stake)
    return packed, sees_slab(packed, C5_MEMBERS)


def make_dag(n_forkers: int):
    """``(members, stake, events, packed, keys)`` of one configuration."""
    members, stake, events, keys = generate_gossip_dag(
        N_MEMBERS, N_EVENTS, seed=SEED, n_forkers=n_forkers
    )
    return members, stake, events, pack_events(events, members, stake), keys


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn`` over ``calls`` calls enqueued with
    no synchronize between them (then one synchronize, not timed)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def card_ms(fn, reps: int = 50) -> float:
    """Milliseconds of ``fn`` on the card alone: one call captured into a
    CUDA graph, the graph replayed ``reps`` times between two events, so no
    host work lies between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, and_products: float):
    """The least time of a kernel that moves ``nbytes`` and does
    ``and_products`` AND-products: bytes over the memory rate or operations
    over the card's 1-bit peak, whichever is larger, and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ms(and_products)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ops_ms(and_products: float, ops_per_s: float = B1_OPS_PER_S) -> float:
    return OPS_PER_AND * and_products / ops_per_s * 1e3


def random_bool(shape, density, gen):
    return torch.rand(shape, generator=gen, device="cuda") < density


def check_bmm_or(gen, g_cap, failures):
    """``g_cap``: config 4's fork pairs padded to the incremental driver's
    bucket of 8, the contraction of its forked-extension hop."""
    rows = []
    shapes = [(128, 128, 128), (128, 128, 10112), (10112, 4517, 64),
              (1024, g_cap, 64), (100, 37, 70), (128, 128, C5_WINDOW)]
    for p, q, r in shapes:
        # densities that leave about half of the outputs set
        dens = float(np.sqrt(0.69 / q))
        a = random_bool((p, q), dens, gen)
        b = random_bool((q, r), dens, gen)
        got = kernels.bmm_or(a, b)
        want = kernels.bmm_or_reference(a, b)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        if not torch.equal(got, want):
            failures.append(f"bmm_or {p}x{q}x{r}: kernel != plain version")
        reps = 10 if p * q * r > 1e9 else 50
        ms = time_ms(lambda: kernels.bmm_or(a, b), reps)
        us = host_us(lambda: kernels.bmm_or(a, b))
        card = card_ms(lambda: kernels.bmm_or(a, b), reps)
        plain_ms = time_ms(lambda: kernels.bmm_or_reference(a, b), reps)
        lib_ms = time_ms(
            lambda: torch.matmul(a.to(torch.bfloat16), b.to(torch.bfloat16)) > 0.5,
            reps,
        )
        bnd, by = bound_ms(p * q + q * r + p * r, p * q * r)
        row = {"shape": [p, q, r], "max_abs_err": err, "ms": ms, "host_us": us,
               "card_ms": card,
               "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bnd,
               "bound_by": by, "set_frac": float(want.float().mean())}
        print("bmm_or", json.dumps(row), flush=True)
        check_degenerate("bmm_or", f"{p}x{q}x{r}", row["set_frac"], failures)
        rows.append(row)
    return rows


def sees_slab(packed, n_members=N_MEMBERS):
    """The sees slab of a packed DAG on the card, padded to the main path's
    block of 128 events."""
    n = packed.n
    n_pad = ((n + 127) // 128) * 128
    parents = np.full((n_pad, 2), -1, np.int32)
    parents[:n] = packed.parents
    creator = np.zeros((n_pad,), np.int32)
    creator[:n] = packed.creator
    dev = torch.device("cuda")
    _anc, sees = visibility_stage(
        torch.as_tensor(parents, device=dev), torch.as_tensor(creator, device=dev),
        torch.as_tensor(packed.fork_pairs, device=dev),
        n_members=n_members, block=128,
    )
    return sees


def check_degenerate(kernel, label, set_frac, failures):
    """A compared output that is all False or all True cannot tell a wrong
    kernel (one that writes zeros, say) from a right one."""
    if set_frac in (0.0, 1.0):
        failures.append(f"{kernel} {label}: set fraction {set_frac}, the check cannot fail")


def check_ssm_block(packs, slabs, failures, c5):
    """``ssm_block`` against its plain version with non-uniform stake.
    Config 4's forkseen slab gives few strongly-seen pairs outside its
    early rounds, so the cases in the late window run on config 3's.
    ``c5`` is config 5's window ``(packed, sees)`` (:func:`config5_window`)."""
    rng = np.random.default_rng(SEED)
    stake_np = rng.integers(1, 6, N_MEMBERS).astype(np.int32)   # non-uniform
    n = N_EVENTS
    n_pad = slabs["config3"].shape[0]

    def pick(lo, hi, c=64):     # c column events drawn from [lo, hi)
        return np.sort(rng.choice(np.arange(lo, hi), c, replace=False)).astype(np.int32)

    one = np.full(64, -1, np.int32)
    one[0] = n - 2000
    cases = [
        ("rows=10112,C=64", "config4", 0, n_pad, pick(0, n)),
        ("rows=256,C=64", "config3", n_pad - 256, 256, pick(n - 2000, n - 1000)),
        ("row0=4033,rows=96", "config4", 4033, 96, pick(2000, 3000)),
        ("one column padded to 64", "config3", n_pad - 512, 512, one),
        # the incremental extension block: one pass's 1024 new rows in the
        # middle of a window x the live witness columns, from the rounds
        # below the rows up into them
        ("extension rows=1024,C=256", "config3", 4096, 1024, pick(2048, 5120, 256)),
        ("extension rows=1024,C=1024", "config3", 4096, 1024, pick(1024, 5120, 1024)),
    ]
    # config 5's streaming extension block (C5_BLOCK): one ingest's rows at
    # the end of a C5_WINDOW window x the live witness columns, padded to
    # the streaming driver's bucket with -1
    rng5 = np.random.default_rng(SEED + 5)
    packs, slabs = dict(packs, config5=c5[0]), dict(slabs, config5=c5[1])
    stakes = {"config3": stake_np, "config4": stake_np,
              "config5": rng5.integers(1, 6, C5_MEMBERS).astype(np.int32)}
    b = C5_BLOCK
    c5_cols = np.full(b["cols"], -1, np.int32)
    c5_cols[: b["live"]] = np.sort(rng5.choice(np.arange(*b["col_range"]), b["live"],
                                               replace=False))
    cases.append((f"config5 extension rows={b['rows']},C={b['cols']}", "config5",
                  b["row0"], b["rows"], c5_cols))
    rows_out = []
    for label, name, row0, rows, cols_np in cases:
        packed, sees = packs[name], slabs[name]
        stake_np = stakes[name]
        tot = int(stake_np.sum())
        dev = sees.device
        mt = torch.as_tensor(packed.member_table, device=dev)
        stake = torch.as_tensor(stake_np, device=dev)
        valid = int((packed.member_table >= 0).sum())
        n_members, k = packed.member_table.shape
        cols = torch.as_tensor(cols_np, device=dev)
        kw = dict(rows=rows, tot_stake=tot)
        got = kernels.ssm_block(sees, mt, stake, cols, row0, **kw)
        want = kernels.ssm_block_reference(sees, mt, stake, cols, row0, **kw)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        if not torch.equal(got, want):
            failures.append(f"ssm_block {label}: kernel != plain version")
        call = lambda: kernels.ssm_block(sees, mt, stake, cols, row0, **kw)  # noqa: E731
        ms = time_ms(call, 20)
        plain_ms = time_ms(
            lambda: kernels.ssm_block_reference(sees, mt, stake, cols, row0, **kw), 5
        )
        c = len(cols_np)
        c_valid = int((cols_np >= 0).sum())
        # each needed sees byte read once (a side: rows x valid member slots,
        # b side: valid slots x valid columns), the indices, the bool output
        nbytes = rows * valid + valid * c_valid + 4 * (n_members * k + c + n_members) + rows * c
        ands = rows * c_valid * valid
        bnd, by = bound_ms(nbytes, ands)
        row = {"case": label, "slab": name, "row0": row0, "rows": rows, "C": c,
               "max_abs_err": err, "ms": ms, "host_us": host_us(call),
               "card_ms": card_ms(call), "plain_ms": plain_ms,
               "bound_ms": bnd, "bound_by": by,
               "ops_bound_int8_ms": ops_ms(ands, INT8_OPS_PER_S),
               "set_frac": float(want.float().mean())}
        print("ssm_block", json.dumps(row), flush=True)
        check_degenerate("ssm_block", label, row["set_frac"], failures)
        rows_out.append(row)

    # the envelope's edge: stakes summing to INT32_MAX // 3, so 3 * acc
    # reaches 2^31 - 2 in the card's int32 tally
    edge = edge_stake(rng, N_MEMBERS)
    packed, sees = packs["config3"], slabs["config3"]
    mt = torch.as_tensor(packed.member_table, device=sees.device)
    cols = torch.as_tensor(pick(2048, 5120, 256), device=sees.device)
    kw = dict(rows=1024, tot_stake=int(edge.sum()))
    got = kernels.ssm_block(sees, mt, edge, cols, 4096, **kw)
    want = kernels.ssm_block_reference(sees, mt, edge, cols, 4096, **kw)
    compare("ssm_block", "envelope edge rows=1024,C=256", got, want, failures)

    return rows_out


def sweep_ssm_block(failures):
    """``ssm_block`` on small random shapes: K not a multiple of 32 and K >
    256, rows below one tile, C not a multiple of 64, -1 slots and cols,
    indices past n, clamped and negative row0, 8-row tiles (rows 1100 x C
    40), a member table whose packed rows are too long to stage (256
    members, K 300: the a side is gathered from device memory) and one too
    long for even 4 rows of it in shared memory (64 members, K 7000: the
    members in chunks).  Exact equality only, not timed."""
    for n, m, k, rows, c, row0 in [(1, 1, 1, 1, 1, 0), (70, 3, 33, 5, 7, 68),
                                   (200, 5, 100, 37, 65, -40), (300, 4, 300, 130, 100, 50),
                                   (520, 64, 182, 17, 130, 400), (1000, 2, 600, 300, 1, 10**6),
                                   (2000, 64, 178, 1000, 1024, 500), (1200, 64, 182, 1100, 40, 50),
                                   (600, 256, 300, 40, 70, 100), (4000, 64, 7000, 40, 70, 100)]:
        def case(seed):
            g = np.random.default_rng(seed)
            sees = torch.as_tensor(g.random((n, n)) < np.sqrt(1.1 / k), device="cuda")
            mt = torch.as_tensor(g.integers(-1, n + 3, (m, k)).astype(np.int32), device="cuda")
            stake = torch.as_tensor(g.integers(1, 6, m).astype(np.int32), device="cuda")
            cols = torch.as_tensor(g.integers(-1, n + 3, c).astype(np.int32), device="cuda")
            return sees, mt, stake, cols, row0

        def plain(*args):
            return kernels.ssm_block_reference(*args, rows=rows, tot_stake=int(args[2].sum()))

        args = mixed_case(case, plain, rows * c)
        tot = int(args[2].sum())
        compare("ssm_block", f"random n={n} M={m} K={k} rows={rows} C={c} row0={row0}",
                kernels.ssm_block(*args, rows=rows, tot_stake=tot), plain(*args), failures,
                degenerate_ok=rows * c == 1)


def sweep_ssm_matrix(failures):
    """``ssm_matrix`` on small ragged shapes with random member tables: -1
    slots and indices past N (clipped), K past 256 (several k-steps a
    member) and past 1536 (a member staged in parts, its hits carried
    across them: 2, 2 and 4 parts).  Exact equality only, not timed."""
    for n, m, k in [(1, 1, 1), (5, 3, 33), (65, 4, 64), (129, 7, 100), (300, 64, 182),
                    (200, 3, 300), (150, 2, 700), (200, 2, 1600), (3000, 2, 2600),
                    (2500, 3, 5000)]:
        def case(seed):
            g = np.random.default_rng(seed)
            sees = torch.as_tensor(g.random((n, n)) < np.sqrt(1.1 / k), device="cuda")
            mt = torch.as_tensor(g.integers(-1, n + 3, (m, k)).astype(np.int32), device="cuda")
            stake = torch.as_tensor(g.integers(1, 6, m).astype(np.int32), device="cuda")
            return sees, mt, stake

        def plain(*args):
            return kernels.ssm_matrix_reference(*args, tot_stake=int(args[2].sum()))

        args = mixed_case(case, plain, n * n)
        compare("ssm_matrix", f"random N={n} M={m} K={k}",
                kernels.ssm_matrix(*args, tot_stake=int(args[2].sum())), plain(*args),
                failures, degenerate_ok=n == 1)


def edge_stake(rng, m):
    """``m`` positive int32 stakes on the card summing to ``INT32_MAX // 3``,
    the largest total inside the envelope."""
    tot = kernels.INT32_MAX // 3
    w = rng.random(m) + 0.5
    stake = np.floor(w / w.sum() * tot).astype(np.int64)
    stake[0] += tot - stake.sum()
    return torch.as_tensor(stake.astype(np.int32), device="cuda")


def mixed_case(case, plain, outputs, tries=20):
    """The first of ``case(seed)``'s argument tuples whose plain output is
    neither all False nor all True (the first, when it has one output)."""
    for seed in range(tries):
        args = case(seed)
        frac = float(plain(*args).float().mean())
        if outputs == 1 or 0.0 < frac < 1.0:
            break
    return args


def compare(kernel, label, got, want, failures, degenerate_ok=False):
    """Exact equality of a kernel's output with its plain version's, and a
    set fraction strictly between 0 and 1 unless ``degenerate_ok``."""
    same = torch.equal(got, want)
    frac = float(want.float().mean())
    print(f"{kernel} {label}: equal {same}, set_frac {frac}", flush=True)
    if not same:
        failures.append(f"{kernel} {label}: kernel != plain version")
    if not degenerate_ok:
        check_degenerate(kernel, label, frac, failures)


def check_ssm_matrix(packs, slabs, failures):
    """``ssm_matrix`` against its plain version on the full config-4 slab
    with non-uniform stake, the full config-3 slab with its own (uniform)
    stake, and the first 1000 rows and columns of the config-3 slab (a
    ragged N; member-table indices past it are clipped, as the reference
    clips them)."""
    rng = np.random.default_rng(SEED)
    stake4 = rng.integers(1, 6, N_MEMBERS).astype(np.int32)
    cases = [
        ("config4 N=10112, stake 1-5", slabs["config4"], packs["config4"], stake4),
        ("config3 N=10112", slabs["config3"], packs["config3"], packs["config3"].stake),
        ("config3 ragged N=1000", slabs["config3"][:1000, :1000].contiguous(),
         packs["config3"], packs["config3"].stake),
    ]
    rows_out = []
    for label, sees, packed, stake_np in cases:
        dev = sees.device
        mt = torch.as_tensor(packed.member_table, device=dev)
        stake = torch.as_tensor(stake_np, dtype=torch.int32, device=dev)
        tot = int(stake_np.sum())
        got = kernels.ssm_matrix(sees, mt, stake, tot_stake=tot)
        want = kernels.ssm_matrix_reference(sees, mt, stake, tot_stake=tot)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        if not torch.equal(got, want):
            failures.append(f"ssm_matrix {label}: kernel != plain version")
        call = lambda: kernels.ssm_matrix(sees, mt, stake, tot_stake=tot)  # noqa: E731
        ms = time_ms(call, 10)
        plain_ms = time_ms(
            lambda: kernels.ssm_matrix_reference(sees, mt, stake, tot_stake=tot), 3, 1
        )
        n = sees.shape[0]
        n_members, k = packed.member_table.shape
        valid = int((packed.member_table >= 0).sum())
        # each needed sees byte read once (a side: n x valid member slots, b
        # side: valid slots x n), the indices and stake, the bool output;
        # one AND-product per (row, column, valid slot)
        nbytes = 2 * n * valid + 4 * (n_members * k + n_members) + n * n
        bnd, by = bound_ms(nbytes, n * n * valid)
        row = {"case": label, "N": n, "M": n_members, "K": k,
               "max_abs_err": err, "ms": ms, "host_us": host_us(call, 20),
               "card_ms": card_ms(call, 10), "plain_ms": plain_ms,
               "bound_ms": bnd, "bound_by": by,
               "ops_bound_int8_ms": ops_ms(n * n * valid, INT8_OPS_PER_S),
               "set_frac": float(want.float().mean())}
        print("ssm_matrix", json.dumps(row), flush=True)
        check_degenerate("ssm_matrix", label, row["set_frac"], failures)
        rows_out.append(row)

    # the envelope's edge on the ragged slab: stakes summing to
    # INT32_MAX // 3
    edge = edge_stake(rng, N_MEMBERS)
    sees = slabs["config3"][:1000, :1000].contiguous()
    mt = torch.as_tensor(packs["config3"].member_table, device=sees.device)
    tot = int(edge.sum())
    compare("ssm_matrix", "envelope edge N=1000",
            kernels.ssm_matrix(sees, mt, edge, tot_stake=tot),
            kernels.ssm_matrix_reference(sees, mt, edge, tot_stake=tot), failures)

    return rows_out


def check_launches(tag, launches, needs, never, failures):
    """Every kernel of ``needs`` launched, none of ``never``."""
    for kname in needs:
        if launches[kname] <= 0:
            failures.append(f"{tag}: kernel {kname} was not launched")
    for kname in never:
        if launches[kname] != 0:
            failures.append(f"{tag}: kernel {kname} launched {launches[kname]} times")


def run_main_path(name, packed, path, failures):
    """One measured ``run_consensus`` on the card through ``path`` (after a
    warm-up where the path asks for one).  Returns the kernel launches and
    the events/s of the measured run."""
    kw, warm, needs, never = PATHS[path]
    label = f"{name} {path}"
    cfg = SwirldConfig(n_members=N_MEMBERS)
    if warm:
        run_consensus(packed, cfg, device="cuda", **kw)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = run_consensus(packed, cfg, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    timings = dict(result.timings)
    stage_seconds = timings.pop("stage_seconds")
    stage_calls = timings.pop("stage_calls")
    print(f"{label}: {packed.n / wall} events/s ({wall} s), ordered "
          f"{len(result.order)}, max_round {result.max_round}", flush=True)
    print(f"{label}: timings {json.dumps(timings)}", flush=True)
    print(f"{label}: stage seconds {json.dumps(stage_seconds)}", flush=True)
    print(f"{label}: stage calls {json.dumps(stage_calls)}", flush=True)
    print(f"{label}: launches {json.dumps(launches)}", flush=True)
    check_launches(label, launches, needs, never, failures)
    digests = result_digests(packed, result)
    print(f"{label}: digests {json.dumps(digests)}", flush=True)
    for key, want in GOLDEN[name].items():
        if digests[key] != want:
            failures.append(f"{label}: {key} digest {digests[key]} != golden {want}")
    if len(result.order) == 0:
        failures.append(f"{label}: empty consensus order")
    return launches, packed.n / wall


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def drive_passes(kind, label, inc, dag, columns_evps, failures, needs=("bmm_or", "ssm_block"),
                 never=("ssm_matrix",), chunks=None):
    """One driver (``inc``) over one configuration in chunks of ``INC_CHUNK``
    events (or the ingests ``chunks``), with the checks of the module
    docstring: golden digests (:func:`golden_for` the DAG's depth, of the
    result moved back to creation order),
    the per-pass ``ordered`` lists concatenating to the order, a non-rebase
    pass, every kernel of ``needs`` launched on the non-rebase passes and
    none of ``never`` launched at all.  Returns the run's kernel launches."""
    events, packed = dag[2], dag[3]
    if chunks is None:
        chunks = [events[i : i + INC_CHUNK] for i in range(0, len(events), INC_CHUNK)]
    name = label.split()[0]
    tag = f"{kind} {label}"
    reset_launches()
    ordered, passes = [], []
    for chunk in chunks:
        launches0 = {k: fn.launches for k, fn in KERNELS.items()}
        seconds0, calls0 = dict(inc.stages.seconds), dict(inc.stages.calls)
        steps0 = inc.scan_steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = inc.ingest(chunk)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        calls = _delta(inc.stages.calls, calls0)
        row = {
            "pass": len(passes), "new_events": st["new_events"], "seconds": dt,
            "rebased": st["rebased"], "storm_mode": st["storm_mode"],
            "window_size": st["window_size"], "pruned_prefix": st["pruned_prefix"],
            "ordered": len(st["ordered"]),
            "probes": calls.get("pipeline.rounds_span_stage", 0),
            "chunk_scans": calls.get("pipeline.rounds_chunk_stage", 0),
            "scan_steps": inc.scan_steps - steps0,
        }
        if isinstance(inc, StreamingConsensus):
            row.update({k: st[k] for k in ("archived_rows", "resident_bytes", "overlap_ratio")})
            row.update(widen_rebases=inc.widen_rebases, full_rebases=inc.full_rebases)
        row.update(
            launches=_delta({k: fn.launches for k, fn in KERNELS.items()}, launches0),
            stage_seconds=_delta(inc.stages.seconds, seconds0), stage_calls=calls,
        )
        print(f"{tag}: {json.dumps(row)}", flush=True)
        passes.append(row)
        ordered.extend(st["ordered"])
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    result = inc.result()
    timings = {k: v for k, v in result.timings.items() if not k.startswith("stage_")}
    print(f"{tag}: counters {json.dumps(timings)}", flush=True)
    if isinstance(inc, StreamingConsensus):
        # the digest drains the pack worker first, so the byte counts are final
        archive = inc.store.archive.digest()
        print(f"{tag}: store {json.dumps(inc.store.stats())}, archive digest {archive}",
              flush=True)
    print(f"{tag}: launches {json.dumps(launches)}", flush=True)
    # steady = the back half of the passes, as bench.py computes it
    steady = passes[len(passes) // 2 :]
    warmed_up = len(steady) >= 2 and not any(r["rebased"] for r in steady)
    t_steady = sum(r["seconds"] for r in steady)
    steady_evps = sum(r["new_events"] for r in steady) / t_steady if warmed_up else 0.0
    print(f"{tag}: steady {steady_evps} events/s over passes "
          f"{steady[0]['pass']}-{steady[-1]['pass']} (warmed up: {warmed_up}); "
          f"the same call's warm columns pass {columns_evps} events/s, ratio "
          f"{steady_evps / columns_evps}", flush=True)
    if ordered != result.order:
        failures.append(f"{tag}: per-pass ordered lists != result().order")
    # the driver indexes events in arrival order, the golden in creation order
    arrival = [ev.id for chunk in chunks for ev in chunk]
    if arrival != packed.ids:
        result = reindex(result, arrival, packed.ids)
    digests = result_digests(packed, result)
    print(f"{tag}: digests {json.dumps(digests)}", flush=True)
    for key, want in golden_for(name, len(events)).items():
        if digests[key] != want:
            failures.append(f"{tag}: {key} digest {digests[key]} != golden {want}")
    clean = [r for r in passes if not r["rebased"]]
    if not clean:
        failures.append(f"{tag}: every pass rebased")
    for kname in needs:
        if sum(r["launches"].get(kname, 0) for r in clean) <= 0:
            failures.append(f"{tag}: no non-rebase pass launched {kname}")
    for kname in never:
        if launches[kname] != 0:
            failures.append(f"{tag}: {kname} launched {launches[kname]} times")
    return launches


def run_incremental(label, dag, fuse, columns_evps, failures, c4=None):
    """Phase 5: the incremental driver at ``fuse_chunks`` ``fuse``.  With
    ``c4`` (a flight recorder and a memory monitor, phase 13(c)), the
    driver dumps its triggers there and runs inside a device memory
    phase."""
    members, stake = dag[:2]
    kw = {} if fuse is None else {"fuse_chunks": fuse}
    inc = IncrementalConsensus(
        members, stake, SwirldConfig(n_members=N_MEMBERS), device="cuda", **kw
    )
    if c4 is None:
        return drive_passes("incremental", label, inc, dag, columns_evps, failures)
    inc.flightrec, mon = c4
    with mon.phase(f"incremental {label}"):
        return drive_passes("incremental", label, inc, dag, columns_evps, failures)


def config4_observers():
    """Phase 13(c)'s flight recorder and device memory monitor for phase
    5's config-4 incremental run."""
    return (FlightRecorder(dump_dir=os.path.join(TRACE_DIR, "flightrec config4")),
            MemoryMonitor(device="cuda", enable_host=False))


def run_streaming(name, dag, columns_evps, failures):
    """Phase 6: the streaming driver with the reference defaults.  Returns
    its launches, the driver (phase 7 continues it) and its archive digest
    (phase 8 holds the mesh driver's archive to it)."""
    members, stake = dag[:2]
    inc = StreamingConsensus(
        members, stake, SwirldConfig(n_members=N_MEMBERS), device="cuda"
    )
    launches = drive_passes("streaming", name, inc, dag, columns_evps, failures)
    return launches, inc, inc.store.archive.digest()


def run_widen(inc, dag, failures):
    """Phase 7: the stale-view sync of tests/test_store.py through the
    streaming driver that phase 6 left at the end of ``dag``.  Returns the
    widening pass's kernel launches."""
    members, stake, events, _packed, keys = dag
    tag = "widen config3"
    if inc.pruned_prefix <= STALE_OTHER_PARENT:
        failures.append(f"{tag}: events[{STALE_OTHER_PARENT}] was never pruned")
    pk, sk = keys[3]
    head = [ev for ev in events if ev.c == pk][-1]
    strag = Event(
        d=b"stale-sync", p=(head.id, events[STALE_OTHER_PARENT].id),
        t=events[-1].t + 1, c=pk,
    ).signed(sk)
    widen0, full0 = inc.widen_rebases, inc.full_rebases
    fetched0 = inc.store.archive.fetched_rows
    lo0 = inc.pruned_prefix
    seconds0 = dict(inc.stages.seconds)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = inc.ingest([strag])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    row = {
        "seconds": dt, "rebased": st["rebased"], "pruned_prefix_before": lo0,
        "pruned_prefix": st["pruned_prefix"], "window_size": st["window_size"],
        "widen_rebases": inc.widen_rebases - widen0,
        "full_rebases": inc.full_rebases - full0,
        "fetched_rows": inc.store.archive.fetched_rows - fetched0,
        "ordered": len(st["ordered"]), "launches": launches,
        "stage_seconds": _delta(inc.stages.seconds, seconds0),
    }
    print(f"{tag}: {json.dumps(row)}", flush=True)
    if row["widen_rebases"] != 1 or row["full_rebases"] != 0:
        failures.append(f"{tag}: widen {row['widen_rebases']}, full {row['full_rebases']}")
    if row["fetched_rows"] <= 0:
        failures.append(f"{tag}: no archived row was fetched")
    packed = pack_events(events + [strag], members, stake)
    batch = run_consensus(packed, SwirldConfig(n_members=N_MEMBERS), device="cuda")
    got, want = result_digests(packed, inc.result()), result_digests(packed, batch)
    print(f"{tag}: digests {json.dumps(got)}, batch run_consensus {json.dumps(want)}",
          flush=True)
    if got != want:
        failures.append(f"{tag}: result digests != run_consensus over the same history")
    return launches


def run_mesh(name, dag, columns_evps, streaming, failures):
    """Phase 8: the row-sharded mesh driver, ``MESH_SHARDS`` shards on one
    card, the ``pallas=True`` route.  ``streaming`` is phase 6's ``(launches,
    archive digest)`` on the same configuration: the mesh run's archive must
    equal it row for row and its ``bmm_or`` launches must equal it (the
    blocks run no member hop)."""
    members, stake = dag[:2]
    mesh = make_mesh(MESH_SHARDS)
    print(f"mesh {name}: {mesh.size} shards on one card ({mesh.device})", flush=True)
    inc = MeshStreamingConsensus(
        mesh, members, stake, SwirldConfig(n_members=N_MEMBERS), pallas=True,
        device="cuda",
    )
    launches = drive_passes(
        "mesh", name, inc, dag, columns_evps, failures,
        needs=("bmm_or", "make_mesh_row_block_fn", "ssm_tally"),
        never=("ssm_matrix", "ssm_block"),
    )
    streaming_launches, streaming_archive = streaming
    if inc.store.archive.digest() != streaming_archive:
        failures.append(f"mesh {name}: archive digest != the streaming driver's")
    if launches["bmm_or"] != streaming_launches["bmm_or"]:
        failures.append(f"mesh {name}: {launches['bmm_or']} bmm_or launches, the "
                        f"streaming run {streaming_launches['bmm_or']}")
    blocks, tallies = launches["make_mesh_row_block_fn"], launches["ssm_tally"]
    if not 0 < tallies <= MESH_SHARDS * blocks:
        failures.append(f"mesh {name}: {tallies} ssm_tally launches for {blocks} blocks "
                        f"of {MESH_SHARDS} shards")
    inc.store.close()
    return launches


def check_mesh_block(packed, failures):
    """Phase 9: ``make_mesh_row_block_fn`` against ``ssm_block`` and
    ``ssm_block_reference`` on the config-3 slab, non-uniform stake;
    ``ssm_tally`` alone against ``ssm_tally_reference``; a member hop
    ``bmm_or`` beside ``torch.matmul``."""
    sees = sees_slab(packed)
    dev = sees.device
    rng = np.random.default_rng(SEED)
    stake_np = rng.integers(1, 6, N_MEMBERS).astype(np.int32)
    tot = int(stake_np.sum())
    mt = torch.as_tensor(packed.member_table, device=dev)
    stake = torch.as_tensor(stake_np, device=dev)
    n_pad = sees.shape[0]
    n_members, k = packed.member_table.shape
    valid = int((packed.member_table >= 0).sum())

    def pick(lo, hi, c):
        return np.sort(rng.choice(np.arange(lo, hi), c, replace=False)).astype(np.int32)

    cases = [("extension rows=1024,C=256", 4096, 1024, pick(2048, 5120, 256)),
             ("column add rows=10112,C=64", 0, n_pad, pick(0, N_EVENTS, 64))]
    rows_out = []
    for d in (2, 4):
        fn = kernels.make_mesh_row_block_fn(make_mesh(d))
        for label, row0, rows, cols_np in cases:
            cols = torch.as_tensor(cols_np, device=dev)
            kw = dict(rows=rows, tot_stake=tot)
            tally0, bmm0 = kernels.ssm_tally.launches, kernels.bmm_or.launches
            got = fn(sees, mt, stake, cols, row0, **kw)
            per_block = {"ssm_tally": kernels.ssm_tally.launches - tally0,
                         "bmm_or": kernels.bmm_or.launches - bmm0}
            single = kernels.ssm_block(sees, mt, stake, cols, row0, **kw)
            want = kernels.ssm_block_reference(sees, mt, stake, cols, row0, **kw)
            torch.cuda.synchronize()
            err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
            if not torch.equal(got, want) or not torch.equal(got, single):
                failures.append(f"make_mesh_row_block_fn D={d} {label}: "
                                "!= ssm_block / plain version")
            if per_block["bmm_or"] != 0 or not 0 < per_block["ssm_tally"] <= d:
                failures.append(f"make_mesh_row_block_fn D={d} {label}: launches "
                                f"{per_block} a block")
            ms = time_ms(lambda: fn(sees, mt, stake, cols, row0, **kw), 10)
            single_ms = time_ms(lambda: kernels.ssm_block(sees, mt, stake, cols, row0, **kw), 20)
            plain_ms = time_ms(
                lambda: kernels.ssm_block_reference(sees, mt, stake, cols, row0, **kw), 3, 1
            )
            c = len(cols_np)
            # as ssm_block's bound: the work of one block, without the D-fold
            # b side that the halo sum adds
            nbytes = rows * valid + valid * c + 4 * (n_members * k + c + n_members) + rows * c
            bnd, by = bound_ms(nbytes, rows * c * valid)
            row = {"case": label, "shards": d, "row0": row0, "rows": rows, "C": c,
                   "max_abs_err": err, "ms": ms, "host_us": host_us(
                       lambda: fn(sees, mt, stake, cols, row0, **kw), 50),
                   "ssm_block_ms": single_ms, "plain_ms": plain_ms,
                   "bound_ms": bnd, "bound_by": by, "launches_per_block": per_block,
                   "set_frac": float(want.float().mean())}
            print("make_mesh_row_block_fn", json.dumps(row), flush=True)
            check_degenerate("make_mesh_row_block_fn", f"D={d} {label}", row["set_frac"],
                             failures)
            rows_out.append(row)

    # ssm_tally alone: the extension block's shard 0 of 2 (rows 4096-5055
    # of the 1024 from 4096), on the halo-assembled b the block builds
    _label, row0, rows, cols_np = cases[0]
    cols = torch.as_tensor(cols_np, device=dev)
    idx = mt.reshape(-1)
    ok = idx >= 0
    b = sees[idx.clamp(0, n_pad - 1)[:, None], cols.clamp(0, n_pad - 1)[None, :]]
    b = (b & ok[:, None] & (cols >= 0)[None, :]).contiguous()
    n_loc = n_pad // 2
    shards = [sees[:n_loc], sees[n_loc:]]
    args = (shards[0], mt, stake, b, row0)
    got = kernels.ssm_tally(*args, rows=rows)
    want = kernels.ssm_tally_reference(*args, rows=rows)
    summed = got + kernels.ssm_tally(shards[1], mt, stake, b, row0 - n_loc, rows=rows)
    hit = (3 * summed.to(torch.int64) > 2 * tot) & (cols >= 0)[None, :]
    single = kernels.ssm_block(sees, mt, stake, cols, row0, rows=rows, tot_stake=tot)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        failures.append("ssm_tally extension shard 0: kernel != plain version")
    if not torch.equal(hit, single):
        failures.append("ssm_tally extension: summed threshold != ssm_block")
    owned = n_loc - row0
    c = len(cols_np)
    # as ssm_block's bound: the owned rows' gathered sees bytes, the valid
    # rows of b, the indices and stake, the int32 output
    nbytes = owned * valid + valid * c + 4 * (n_members * k + n_members) + 4 * rows * c
    bnd, by = bound_ms(nbytes, owned * c * valid)
    tally_row = {
        "case": "extension shard 0 of 2: rows=1024 (960 owned),C=256",
        "max_abs_err": int((got - want).abs().max()),
        "ms": time_ms(lambda: kernels.ssm_tally(*args, rows=rows), 50),
        "host_us": host_us(lambda: kernels.ssm_tally(*args, rows=rows)),
        "card_ms": card_ms(lambda: kernels.ssm_tally(*args, rows=rows)),
        "plain_ms": time_ms(lambda: kernels.ssm_tally_reference(*args, rows=rows), 5),
        "bound_ms": bnd, "bound_by": by, "set_frac": float(hit.float().mean()),
    }
    print("ssm_tally", json.dumps(tally_row), flush=True)
    check_degenerate("ssm_tally", "extension summed threshold", tally_row["set_frac"],
                     failures)

    # a member hop of the extension block, member 0, as the bmm route runs it
    a = (sees[4096:5120][:, idx[:k].clamp(0, n_pad - 1)] & ok[None, :k]).contiguous()
    b0 = b[:k].contiguous()
    got, want = kernels.bmm_or(a, b0), kernels.bmm_or_reference(a, b0)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        failures.append(f"bmm_or mesh hop 1024x{k}x256: kernel != plain version")
    p, q, r = a.shape[0], k, b0.shape[1]
    bnd, by = bound_ms(p * q + q * r + p * r, p * q * r)
    hop = {"shape": [p, q, r], "case": "mesh member hop (config-3 slab, member 0)",
           "max_abs_err": int((got.to(torch.int32) - want.to(torch.int32)).abs().max()),
           "ms": time_ms(lambda: kernels.bmm_or(a, b0), 50),
           "host_us": host_us(lambda: kernels.bmm_or(a, b0)),
           "card_ms": card_ms(lambda: kernels.bmm_or(a, b0)),
           "plain_ms": time_ms(lambda: kernels.bmm_or_reference(a, b0), 50),
           "library_ms": time_ms(
               lambda: torch.matmul(a.to(torch.bfloat16), b0.to(torch.bfloat16)) > 0.5, 50),
           "bound_ms": bnd, "bound_by": by, "set_frac": float(want.float().mean())}
    print("bmm_or", json.dumps(hop), flush=True)
    check_degenerate("bmm_or", "mesh hop", hop["set_frac"], failures)
    return rows_out, tally_row, hop


def run_mesh_batch(name, packed, failures):
    """Phase 10: the member-sharded batch path, ``MESH_SHARDS`` member
    shards on one card.  Returns the measured run's kernel launches."""
    label = f"mesh batch {name}"
    cfg = SwirldConfig(n_members=N_MEMBERS)
    mesh = make_mesh(MESH_SHARDS)
    run_consensus(packed, cfg, mesh=mesh, device="cuda")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = run_consensus(packed, cfg, mesh=mesh, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    timings = dict(result.timings)
    stage_seconds = timings.pop("stage_seconds")
    stage_calls = timings.pop("stage_calls")
    print(f"{label}: {packed.n / wall} events/s ({wall} s), ordered "
          f"{len(result.order)}, max_round {result.max_round}", flush=True)
    print(f"{label}: timings {json.dumps(timings)}", flush=True)
    print(f"{label}: stage seconds {json.dumps(stage_seconds)}", flush=True)
    print(f"{label}: stage calls {json.dumps(stage_calls)}", flush=True)
    print(f"{label}: launches {json.dumps(launches)}", flush=True)
    attempts = 1 + timings["overflow_retries"]
    if launches["ssm_tally"] != MESH_SHARDS * attempts:
        failures.append(f"{label}: {launches['ssm_tally']} ssm_tally launches for "
                        f"{attempts} attempts of {MESH_SHARDS} shards")
    if launches["bmm_or"] <= 0:
        failures.append(f"{label}: bmm_or was not launched")
    for kname in ("ssm_matrix", "ssm_block", "make_mesh_row_block_fn"):
        if launches[kname] != 0:
            failures.append(f"{label}: {kname} launched {launches[kname]} times")
    digests = result_digests(packed, result)
    print(f"{label}: digests {json.dumps(digests)}", flush=True)
    for key, want in golden_for(name, packed.n).items():
        if digests[key] != want:
            failures.append(f"{label}: {key} digest {digests[key]} != golden {want}")
    return launches


def check_member_sharded(packs, failures):
    """Phase 10, the kernels alone: ``ssm_matrix_sharded`` at 2 and 4 member
    shards on the config-4 slab (non-uniform stake) against ``ssm_matrix``
    and ``ssm_matrix_reference``; ``ssm_tally`` at one member shard's N x N
    shape; ``make_ssm_block_fn_for_mesh(make_mesh(2))`` at the extension
    shape on the config-3 slab against ``ssm_block``.  Returns the rows."""
    rng = np.random.default_rng(SEED)
    stake_np = rng.integers(1, 6, N_MEMBERS).astype(np.int32)
    tot = int(stake_np.sum())
    packed = packs["config4"]
    sees = sees_slab(packed)
    dev = sees.device
    n = sees.shape[0]
    mt = torch.as_tensor(packed.member_table, device=dev)
    stake = torch.as_tensor(stake_np, device=dev)
    n_members, k = packed.member_table.shape
    valid = int((packed.member_table >= 0).sum())
    want = kernels.ssm_matrix_reference(sees, mt, stake, tot_stake=tot)
    plain_ms = time_ms(lambda: kernels.ssm_matrix_reference(sees, mt, stake, tot_stake=tot), 3, 1)
    matrix = lambda: kernels.ssm_matrix(sees, mt, stake, tot_stake=tot)  # noqa: E731
    single = matrix()
    matrix_ms = time_ms(matrix, 10)
    if not torch.equal(single, want):
        failures.append("ssm_matrix config4 N=10112: kernel != plain version")
    rows = []
    for d in (2, 4):
        mesh = make_mesh(d)
        call = lambda: ssm_matrix_sharded(sees, mt, stake, tot, mesh=mesh)  # noqa: E731
        tally0 = kernels.ssm_tally.launches
        got = call()
        torch.cuda.synchronize()
        per_call = kernels.ssm_tally.launches - tally0
        label = f"ssm_matrix_sharded D={d} config4 N={n}, stake 1-5"
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        if not torch.equal(got, want) or not torch.equal(got, single):
            failures.append(f"{label}: != ssm_matrix / plain version")
        if per_call != d:
            failures.append(f"{label}: {per_call} ssm_tally launches a call")
        # each needed sees byte read once (a side: n x valid slots; b side:
        # the gathered valid slots x n), the indices and stake, D int32
        # tallies written and read back by the sum, the bool output; one
        # AND-product per (row, column, valid slot)
        nbytes = 2 * n * valid + 4 * (n_members * k + n_members) + 2 * d * 4 * n * n + n * n
        bnd, by = bound_ms(nbytes, n * n * valid)
        row = {"case": label, "shards": d, "N": n, "M": n_members, "K": k,
               "max_abs_err": err, "ms": time_ms(call, 5), "host_us": host_us(call, 10),
               "card_ms": card_ms(call, 5), "ssm_matrix_ms": matrix_ms,
               "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by, "launches_per_call": per_call,
               "set_frac": float(want.float().mean())}
        print("ssm_matrix_sharded", json.dumps(row), flush=True)
        check_degenerate("ssm_matrix_sharded", label, row["set_frac"], failures)
        rows.append(row)
    del want, single
    torch.cuda.empty_cache()

    # one member shard's tally alone: shard 0 of 2, all N rows x N columns
    m_loc = n_members // 2
    mt0, stake0 = mt[:m_loc].contiguous(), stake[:m_loc].contiguous()
    idx = mt0.reshape(-1)
    b = (sees[idx.clamp(0, n - 1)] & (idx >= 0)[:, None]).contiguous()
    args = (sees, mt0, stake0, b, 0)
    got = kernels.ssm_tally(*args, rows=n)
    want = kernels.ssm_tally_reference(*args, rows=n)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        failures.append("ssm_tally member shard 0 of 2, N x N: kernel != plain version")
    valid0 = int((packed.member_table[:m_loc] >= 0).sum())
    nbytes = 2 * n * valid0 + 4 * (m_loc * k + m_loc) + 4 * n * n
    bnd, by = bound_ms(nbytes, n * n * valid0)
    tally_row = {
        "case": f"member shard 0 of 2: rows={n},C={n} (config4, {m_loc} members)",
        "max_abs_err": int((got - want).abs().max()),
        "ms": time_ms(lambda: kernels.ssm_tally(*args, rows=n), 5),
        "host_us": host_us(lambda: kernels.ssm_tally(*args, rows=n), 10),
        "card_ms": card_ms(lambda: kernels.ssm_tally(*args, rows=n), 5),
        "plain_ms": time_ms(lambda: kernels.ssm_tally_reference(*args, rows=n), 3, 1),
        "bound_ms": bnd, "bound_by": by,
        "nonzero_frac": float((want != 0).float().mean()),
    }
    print("ssm_tally", json.dumps(tally_row), flush=True)
    check_degenerate("ssm_tally", "member shard N x N", tally_row["nonzero_frac"], failures)
    del got, want, b, sees
    torch.cuda.empty_cache()

    # the member-sharded block at the extension shape, config-3 slab
    packed = packs["config3"]
    sees = sees_slab(packed)
    mt = torch.as_tensor(packed.member_table, device=dev)
    cols_np = np.sort(rng.choice(np.arange(2048, 5120), 256, replace=False)).astype(np.int32)
    cols = torch.as_tensor(cols_np, device=dev)
    fn = make_ssm_block_fn_for_mesh(make_mesh(MESH_SHARDS))
    kw = dict(rows=1024, tot_stake=tot)
    tally0 = kernels.ssm_tally.launches
    got = fn(sees, mt, stake, cols, 4096, **kw)
    per_block = kernels.ssm_tally.launches - tally0
    single = kernels.ssm_block(sees, mt, stake, cols, 4096, **kw)
    torch.cuda.synchronize()
    label = f"make_ssm_block_fn_for_mesh D={MESH_SHARDS} extension rows=1024,C=256"
    if not torch.equal(got, single):
        failures.append(f"{label}: != ssm_block")
    if per_block != MESH_SHARDS:
        failures.append(f"{label}: {per_block} ssm_tally launches a block")
    valid = int((packed.member_table >= 0).sum())
    n_members, k = packed.member_table.shape
    # as ssm_block's bound: the work of one block
    nbytes = 1024 * valid + valid * 256 + 4 * (n_members * k + 256 + n_members) + 1024 * 256
    bnd, by = bound_ms(nbytes, 1024 * 256 * valid)
    call = lambda: fn(sees, mt, stake, cols, 4096, **kw)  # noqa: E731
    block_row = {
        "case": label, "launches_per_block": per_block,
        "max_abs_err": int((got.to(torch.int32) - single.to(torch.int32)).abs().max()),
        "ms": time_ms(call, 20), "host_us": host_us(call, 50),
        "ssm_block_ms": time_ms(lambda: kernels.ssm_block(sees, mt, stake, cols, 4096, **kw), 20),
        "plain_ms": time_ms(
            lambda: kernels.ssm_block_reference(sees, mt, stake, cols, 4096, **kw), 3, 1),
        "bound_ms": bnd, "bound_by": by, "set_frac": float(single.float().mean()),
    }
    print("make_ssm_block_fn_for_mesh", json.dumps(block_row), flush=True)
    check_degenerate("make_ssm_block_fn_for_mesh", label, block_row["set_frac"], failures)
    return rows, tally_row, block_row


def live_simulation(n_members, min_batch, mesh_shape, **obs_kw):
    """The port's gossip simulation of ``n_members`` nodes at ``LIVE_SEED``.
    Node 0 runs ``backend="tpu"`` with ``tpu_min_batch`` ``min_batch`` (and
    ``mesh_shape``), so its passes run on the card through the
    ``TorchEngine`` its first pass builds.  The peers only gossip: they are
    ``"tpu"`` nodes too, with a ``tpu_min_batch`` they never reach, so each
    one's engine mirrors its store and never runs a pass.  The oracle's
    Python passes on 63 peers would take the phase's whole time, and what a
    peer serves depends on its store alone, not on its consensus state, so
    the DAG is the one a population of oracle nodes gossips.  ``obs_kw``
    (``metrics=``, ``finality=``, ``flightrec=``) go to ``make_simulation``."""
    sim = make_simulation(n_members, seed=LIVE_SEED, **obs_kw)
    base = sim.config
    peers = dataclasses.replace(base, backend="tpu", tpu_min_batch=2**62)
    for node in sim.nodes[1:]:
        node.config = peers
    sim.nodes[0].config = dataclasses.replace(
        base, backend="tpu", tpu_min_batch=min_batch, mesh_shape=mesh_shape
    )
    return sim


def gossip_until(sim, n_events, on_step=None):
    """Gossip turns until node 0 holds ``n_events`` events; ``on_step(
    seconds)`` after each turn.  Returns the turns."""
    node, turns = sim.nodes[0], 0
    while len(node.hg) < n_events:
        t0 = time.perf_counter()
        sim.step()
        turns += 1
        if on_step is not None:
            on_step(time.perf_counter() - t0)
    return turns


def node_state_matches(node, packed, result) -> bool:
    """Whether ``node``'s oracle-shaped state is ``result``'s on ``packed``."""
    ids = packed.ids
    return (
        node.consensus == [ids[i] for i in result.order]
        and node.round == {ids[i]: int(result.round[i]) for i in range(packed.n)}
        and node.is_witness == {ids[i]: bool(result.is_witness[i]) for i in range(packed.n)}
        and node.famous == {ids[i]: v for i, v in result.famous.items()}
        and node.round_received == {ids[i]: int(result.round_received[i]) for i in result.order}
        and node.consensus_ts == {ids[i]: int(result.consensus_ts[i]) for i in result.order}
    )


def run_live_node(label, failures):
    """Phase 11: one live node (``LIVE_NODES[label]``).  Returns its kernel
    launches over the gossip and the flush, and the node."""
    n_events, min_batch, mesh_shape = LIVE_NODES[label]
    tag = f"live {label}"
    sim = live_simulation(N_MEMBERS, min_batch, mesh_shape)
    node = sim.nodes[0]
    passes = []

    def on_step(seconds):
        eng = node._tpu_engine
        if eng is not None and eng.last_result is not None and (
                not passes or passes[-1]["events"] != eng.last_result.n):
            passes.append({"pass": len(passes), "events": eng.last_result.n,
                           "new_events": eng.last_result.n - (passes[-1]["events"] if passes else 0),
                           "step_seconds": seconds,
                           "device_and_dispatch": eng.last_result.timings["device_and_dispatch"],
                           "finalize_host": eng.last_result.timings["finalize_host"]})
            print(f"{tag}: pass {json.dumps(passes[-1])}", flush=True)

    reset_launches()
    t0 = time.perf_counter()
    turns = gossip_until(sim, n_events, on_step)
    t_gossip = time.perf_counter() - t0
    eng = node._tpu_engine
    t0 = time.perf_counter()
    eng.flush()
    torch.cuda.synchronize()
    on_step(time.perf_counter() - t0)
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    pass_seconds = sum(p["step_seconds"] for p in passes)
    print(f"{tag}: {turns} turns, node 0 holds {len(node.hg)} events, "
          f"{len(node.consensus)} ordered, {len(passes)} passes "
          f"({pass_seconds} s in the steps that ran one; {t_gossip} s of gossip "
          f"and passes); engine on {eng.device}, mesh {eng.mesh}", flush=True)
    print(f"{tag}: launches {json.dumps(launches)}", flush=True)
    golden = LIVE_GOLDEN[label]
    if (turns, len(node.hg)) != (golden["turns"], golden["events"]):
        failures.append(f"{tag}: {turns} turns / {len(node.hg)} events, golden "
                        f"{golden['turns']} / {golden['events']}")
    packed = eng.packer.pack()
    digests = result_digests(packed, eng.last_result)
    print(f"{tag}: digests {json.dumps(digests)}", flush=True)
    for key, want in digests.items():
        if want != golden[key]:
            failures.append(f"{tag}: {key} digest {want} != golden {golden[key]}")
    if not node_state_matches(node, packed, eng.last_result):
        failures.append(f"{tag}: node state != its engine's last pass")
    if len(node.consensus) == 0 or len(passes) < 2:
        failures.append(f"{tag}: {len(node.consensus)} ordered in {len(passes)} passes")
    if mesh_shape is None:
        needs, never = ("bmm_or", "ssm_block"), ("ssm_matrix", "ssm_tally")
        # the node's state against the port's own batch pass on its DAG
        own = pack_node(node)
        result = run_consensus(own, node.config, device="cuda")
        if not node_state_matches(node, own, result):
            failures.append(f"{tag}: node state != run_consensus(pack_node(node))")
    else:
        needs, never = ("bmm_or", "ssm_tally"), ("ssm_matrix", "ssm_block")
    check_launches(tag, launches, needs, never, failures)
    return launches, node


def dynamic_digests(res) -> dict:
    """SHA-256 digests of a dynamic-membership run (either package's
    ``DynamicResult``): the order (concatenated event ids), the rounds in
    the observer's insertion order (little-endian int32), and the epoch
    ledger's own digest, with the counts."""
    def h(b: bytes) -> str:
        return hashlib.sha256(b).hexdigest()

    return {
        "events": len(res.rounds), "decided": len(res.order), "epochs": res.epochs,
        "order": h(b"".join(res.order)),
        "round": h(np.asarray(list(res.rounds.values()), "<i4").tobytes()),
        "ledger": res.ledger.digest().hex(),
    }


def run_single_epoch_pin(dag, failures):
    """Phase 12(a): ``run_dynamic(engine=e, device="cuda", chunk=INC_CHUNK,
    cross_check=True)`` over config 3's first ``DYN_PIN_EVENTS`` events (no
    membership transaction) for each device engine, the mesh engine on ``make_mesh(MESH_SHARDS)``.  Returns
    each engine's kernel launches."""
    members, stake, events, _packed, _keys = dag
    events = events[:DYN_PIN_EVENTS]
    out = {}
    for engine in DYN_ENGINES:
        tag = f"dynamic pin {engine}"
        mesh = make_mesh(MESH_SHARDS) if engine == "mesh" else None
        reset_launches()
        res = run_dynamic(events, members, stake, engine=engine, chunk=INC_CHUNK,
                          mesh=mesh, cross_check=True, device="cuda")
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in KERNELS.items()}
        order = hashlib.sha256(b"".join(res.order)).hexdigest()
        print(f"{tag}: {len(res.order)} ordered, single_epoch {res.single_epoch}, "
              f"observer {res.observer_seconds} s, native {res.native_seconds} s, "
              f"launches {json.dumps(launches)}", flush=True)
        if not res.single_epoch or res.native_order != res.order:
            failures.append(f"{tag}: single_epoch {res.single_epoch}, native order "
                            f"{'==' if res.native_order == res.order else '!='} order")
        if (len(res.order), order) != (PIN_GOLDEN["decided"], PIN_GOLDEN["order"]):
            failures.append(f"{tag}: {len(res.order)} decided, order digest {order} "
                            f"!= golden {PIN_GOLDEN}")
        check_launches(tag, launches, *DYN_KERNELS[engine], failures)
        out[engine] = launches
    return out


def run_churn(failures):
    """Phase 12(b): the port's ``churn_schedule(**CHURN)`` through
    ``run_all_engines`` on the card: every engine's order, rounds and ledger
    equal to the others' and to ``CHURN_GOLDEN``, a repack on the card per
    epoch boundary, the streaming archive's rows stamped with >= 2 epochs.
    A schedule of several epochs runs no native engine (``run_dynamic``
    cross-checks single-epoch runs only), and neither the observer nor the
    repack stage launches a kernel: the launches are printed, not
    counted."""
    t0 = time.perf_counter()
    events, members, stake, sim = churn_schedule(**CHURN)
    print(f"dynamic churn: {len(events)} events from {CHURN} in "
          f"{time.perf_counter() - t0} s", flush=True)
    reset_launches()
    t0 = time.perf_counter()
    results = run_all_engines(events, members, stake, sim.config, chunk=INC_CHUNK,
                              engines=DYN_ENGINES, mesh=make_mesh(MESH_SHARDS),
                              device="cuda")
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    print(f"dynamic churn: run_all_engines {time.perf_counter() - t0} s, "
          f"launches {json.dumps(launches)}", flush=True)
    for engine, res in results.items():
        tag = f"dynamic churn {engine}"
        digests = dynamic_digests(res)
        shapes = [(str(t.device), tuple(t.shape), tuple(st.shape))
                  for t, st in res.repack_outputs]
        print(f"{tag}: digests {json.dumps(digests)}, restatements "
              f"{res.restatements}, observer {res.observer_seconds} s, repacks "
              f"{json.dumps([r.to_dict() for r in res.repacks])}, outputs {shapes}",
              flush=True)
        for key, want in CHURN_GOLDEN.items():
            if digests[key] != want:
                failures.append(f"{tag}: {key} {digests[key]} != golden {want}")
        if res.epochs < 3 or len(res.repacks) != res.epochs - 1:
            failures.append(f"{tag}: {res.epochs} epochs, {len(res.repacks)} repacks")
        for (table, st), rp in zip(res.repack_outputs, res.repacks):
            if (table.device.type != "cuda" or st.device.type != "cuda"
                    or tuple(table.shape) != (rp.members_after, table.shape[1])
                    or tuple(st.shape) != (rp.members_after,)):
                failures.append(f"{tag}: repack output {table.device} {tuple(table.shape)}")
    stamped = results["streaming"].archive_epochs
    if stamped is None or len({epoch for _, epoch in stamped}) < 2:
        failures.append("dynamic churn: streaming archive rows span < 2 epochs")


def run_restore(node, failures):
    """Phase 12(c): ``save_node`` the columns live node of phase 11, then
    ``load_node(device="cuda")``: the replay's pass runs ``TorchEngine`` on
    the card.  State and digests equal to the saved node's and
    ``LIVE_GOLDEN``'s; a copy with one byte of the header's order digest
    changed raises ``ValueError``; ``save_packed`` / ``load_packed`` of
    ``pack_node(node)`` then ``run_consensus(device="cuda")`` gives the same
    digests.  Returns the restore's kernel launches."""
    tag = "restore"
    golden = {k: v for k, v in LIVE_GOLDEN["columns node"].items()
              if k not in ("turns", "events")}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "node.swck")
        t0 = time.perf_counter()
        save_node(path, node)
        t_save = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        restored = load_node(path, node.sk, node.pk, network={}, device="cuda")
        t_load = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in KERNELS.items()}
        eng = restored._tpu_engine
        print(f"{tag}: save {t_save} s, load {t_load} s ({json.dumps(restored.restore_seconds)}"
              f"), {len(restored.hg)} events, {len(restored.consensus)} ordered, engine on "
              f"{eng.device}, launches {json.dumps(launches)}", flush=True)
        if restored.state_digest() != node.state_digest() or restored.consensus != node.consensus:
            failures.append(f"{tag}: restored state != the saved node's")
        digests = result_digests(eng.packer.pack(), eng.last_result)
        if digests != golden:
            failures.append(f"{tag}: digests {digests} != golden")
        check_launches(tag, launches, ("bmm_or", "ssm_block"), ("ssm_matrix",), failures)

        with open(path, "rb") as f:
            data = bytearray(f.read())
        at = data.index(b'"order_digest": "') + len(b'"order_digest": "')
        data[at] = ord("0") if data[at] != ord("0") else ord("1")
        bad = os.path.join(tmp, "tampered.swck")
        with open(bad, "wb") as f:
            f.write(data)
        try:
            load_node(bad, node.sk, node.pk, network={}, device="cuda")
            failures.append(f"{tag}: a tampered order digest was accepted")
        except ValueError as e:
            print(f"{tag}: tampered copy refused: {e}", flush=True)

        packed = pack_node(node)
        path = os.path.join(tmp, "packed.npz")
        save_packed(path, packed)
        back = load_packed(path)
        digests = result_digests(back, run_consensus(back, node.config, device="cuda"))
        if digests != golden:
            failures.append(f"{tag}: packed round trip digests {digests} != golden")
    return launches


# ------------------------------------------------- phase 13: observability

#: the hand-written kernels' entry points, as the profiler names them
HAND_KERNELS = ("bmm_or_kernel", "pack_b", "tile", "pack", "tally")
INC_TRACE_PASS = 5              # the steady incremental pass phase 13(b) traces
# the columns pass's recorded window: rounds_chunk_stage calls TRACE_SKIP + 2
# onward (136 calls a config-3 pass), TRACE_ACTIVE of them
TRACE_SKIP = 60
TRACE_ACTIVE = 24


def _kernel_fn(name: str) -> str:
    """A CUDA kernel's function name from the profiler's demangled name
    (``void (anonymous namespace)::tile(...)`` -> ``tile``)."""
    n = name[5:] if name.startswith("void ") else name
    n = n.replace("(anonymous namespace)::", "")
    return n.split("(")[0].split("<")[0].split("::")[-1]


def _union(intervals):
    """Merged, sorted ``[start, end)`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


# the trace events card_timeline reads: the card's kernels and copies and
# the pipeline's stage ranges (record_function)
_TRACE_EVENT = re.compile(
    r'"ph": "X",\s*"cat": "(kernel|gpu_memcpy|gpu_memset|user_annotation)",'
    r'\s*"name": "((?:[^"\\\\]|\\\\.)*)",\s*"pid": [^,]*,\s*"tid": [^,]*,'
    r'\s*"ts": ([-0-9.e+]+),\s*"dur": ([-0-9.e+]+)')


def _trace_events(path):
    """``(cat, name, start, end)`` (us) of the ``torch.profiler`` Chrome
    trace's events that :func:`card_timeline` reads, matched in the text
    (the exporter writes an event's keys in this order), so a trace of
    several hundred MB is read without building its JSON tree."""
    with open(path) as f:
        text = f.read()
    for m in _TRACE_EVENT.finditer(text):
        cat, name, ts, dur = m.groups()
        if "\\" in name:
            name = json.loads(f'"{name}"')
        t = float(ts)
        yield cat, name, t, t + float(dur)


def windowed_trace(run, path, skip, active):
    """``run()`` under ``torch.profiler`` (host and card) stepped at every
    ``pipeline.rounds_chunk_stage`` call (the obs stage-observer seam): the
    trace holds the ``active`` calls after the first ``skip`` + 1, each
    with the host work that follows it, written to ``path``.  Returns ``run()``'s value
    and the export seconds."""
    from torch.profiler import ProfilerActivity, profile, schedule

    export = {}

    def ready(prof):
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        export["s"] = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=skip, warmup=1, active=active, repeat=1),
                 on_trace_ready=ready) as prof:
        obs.set_stage_observer(
            lambda name, fn, args, kw:
            prof.step() if name == "pipeline.rounds_chunk_stage" else None)
        try:
            out = run()
            torch.cuda.synchronize()
        finally:
            obs.set_stage_observer(None)
    return out, export.get("s")


def card_timeline(tag, path, smi, extra):
    """Phase 13(b): the card's busy and idle share in one profiler trace
    (a Chrome trace from ``torch.profiler``, times in us).  Busy = the
    union of the CUDA kernel intervals; the window = the first to the last
    kernel or copy (the profiler's own start-up, a second or more of no
    device work, stays out).  Prints
    the window, busy and idle seconds and shares, the kernel launches, the
    top 5 device operations, the hand-written kernels' share of busy time
    and the 5 longest idle gaps with the pipeline stage the host was in.
    Returns the row."""
    kern, copies, stages = [], [], []
    for cat, name, a, b in _trace_events(path):
        if cat == "kernel":
            kern.append((a, b, name))
        elif cat != "user_annotation":
            copies.append((a, b, name))
        elif name.startswith("pipeline."):
            stages.append((a, b, name))
    stages.sort()
    ends = [(a, b) for a, b, _ in kern + copies] or [(a, b) for a, b, _ in stages]
    t0 = min(a for a, _ in ends)
    t1 = max(b for _, b in ends)
    busy = _union((a, b) for a, b, _ in kern)
    busy_us = sum(b - a for a, b in busy)
    copy_us = sum(b - a for a, b in _union((a, b) for a, b, _ in copies))
    by_op = {}
    for a, b, name in kern + copies:
        k = name[:96]
        tot, n = by_op.get(k, (0.0, 0))
        by_op[k] = (tot + b - a, n + 1)
    top = sorted(by_op.items(), key=lambda kv: -kv[1][0])[:5]
    hand_us = sum(b - a for a, b, name in kern if _kernel_fn(name) in HAND_KERNELS)
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:5]

    def stage_at(t):
        inside = [s for s in stages if s[0] <= t <= s[1]]
        return min(inside, key=lambda s: s[1] - s[0])[2] if inside else "host, no stage"

    window_us = t1 - t0
    if "untraced_s" in extra:
        # the profiler slows the host; the card's busy seconds are its own
        extra = {**extra, "busy_share_untraced": busy_us / 1e6 / extra["untraced_s"]}
    row = {
        "trace": tag, **extra, "card": smi,
        "window_s": window_us / 1e6, "busy_s": busy_us / 1e6,
        "busy_share": busy_us / window_us, "idle_share": 1 - busy_us / window_us,
        "copy_s": copy_us / 1e6, "kernel_launches": len(kern),
        "hand_kernel_share_of_busy": hand_us / busy_us if busy_us else 0.0,
        "top_device_ops": [{"name": k, "s": v[0] / 1e6, "calls": v[1]} for k, v in top],
        "longest_idle_gaps": [{"s": (b - a) / 1e6, "stage": stage_at(a)}
                              for a, b in longest],
        "stage_ranges": len(stages),
    }
    print(f"card timeline {tag}: {json.dumps(row)}", flush=True)
    return row


def registry_values(reg, names) -> dict:
    return {k: reg.value(k) for k in names}


def stage_cost_us(calls: int = 2000) -> dict:
    """Host microseconds a stage call costs through ``StageClock`` with no
    ambient Obs and under one with a dispatch profiler (a no-op stage on the
    card's device, so the synchronize is in both)."""
    clock = StageClock(torch.device("cuda"))
    x = torch.zeros(4, device="cuda")

    def per_call():
        t0 = time.perf_counter()
        for _ in range(calls):
            clock.stage_call("pipeline.noop", torch.Tensor.view, x, -1)
        return (time.perf_counter() - t0) / calls * 1e6

    off = per_call()
    with obs.enabled(obs.Obs(profiler=DispatchProfiler())):
        on = per_call()
    return {"off": off, "obs": on}


def run_obs_columns(packed, untraced, failures):
    """Phase 13(a): a warm columns pass on config 3 under an ambient Obs with
    a dispatch profiler: golden digests, the launches of the untraced pass
    (``untraced`` = phase 4's ``(launches, wall)``), no ``compile`` call,
    the protocol gauges equal to the reference's (``OBS_GOLDEN``).  Prints
    the report table and the profiler's summary.  Returns the result, its
    rounds-to-decision list, the launches and a rounds-chunk call's seconds
    (with its column adds)."""
    tag = "obs columns config3"
    cfg = SwirldConfig(n_members=N_MEMBERS)
    prof = DispatchProfiler()
    o = obs.Obs(profiler=prof)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with obs.enabled(o):
        prof.begin_chunk("columns")
        result = run_consensus(packed, cfg, device="cuda")
        prof.end_chunk(n_events=packed.n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    base_launches, base_wall = untraced
    # the same pass untraced once more, right after: the host's speed drifts
    # between phases more than Obs costs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_consensus(packed, cfg, device="cuda")
    torch.cuda.synchronize()
    next_wall = time.perf_counter() - t0
    print(f"{tag}: {wall} s ({packed.n / wall} events/s); untraced {base_wall} s "
          f"(phase 4), {next_wall} s (just after): Obs {100 * (wall / next_wall - 1)} % "
          f"against the latter; launches {json.dumps(launches)}; Obs's own cost a "
          f"stage {stage_cost_us()} us", flush=True)
    if launches != base_launches:
        failures.append(f"{tag}: launches {launches} != untraced {base_launches}")
    digests = result_digests(packed, result)
    if digests != GOLDEN["config3"]:
        failures.append(f"{tag}: digests {digests} != golden")
    compiles = obs.compile_counts(o.registry)
    if compiles:
        failures.append(f"{tag}: compile calls on a warm pass: {compiles}")
    got = registry_values(o.registry, OBS_GAUGES)
    fin = FinalityTracker("batch")
    record_batch_result(fin, result)
    got["rtd"] = rtd_digest(fin.rtd)
    print(f"{tag}: registry {json.dumps(got)}", flush=True)
    if got != OBS_GOLDEN:
        failures.append(f"{tag}: registry {got} != the reference's {OBS_GOLDEN}")
    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, "columns.obs.jsonl")
    o.save(path)
    for line in render_report(load_trace(path)).splitlines():
        print(f"{tag}: report | {line}", flush=True)
    summary = prof.summary()
    summary.pop("per_chunk")
    print(f"{tag}: dispatch profiler {json.dumps(summary)}", flush=True)
    # a rounds-chunk call and the column adds after it, untraced
    call_s = sum(o.registry.value("pipeline_stage_seconds",
                                  {"stage": f"pipeline.{stage}", "kind": "execute"})
                 for stage in ("rounds_chunk_stage", "ssm_block_stage"))
    return result, fin.rtd, launches, call_s / got["pipeline_chunk_scans_total"]


def run_trace_columns(dag, base_launches, chunk_call_s, smi, failures):
    """Phase 13(b), columns.  ``trace_consensus`` over the columns pass of
    config 3's first ``INC_CHUNK`` events, whole (its export timed); then
    config 3's whole pass with a window of ``TRACE_ACTIVE`` rounds-chunk
    calls from the middle of the scan recorded (``windowed_trace``): a
    whole 10 000-event trace is ~2 GB and takes ~150 s to record, stop and
    export and ~40 s to read on an H100's host (PERF.md).  The windowed
    pass's launches equal the untraced pass's (``base_launches``); both
    traced passes' digests are the untraced ones'.  ``chunk_call_s`` is a
    rounds-chunk call's untraced seconds with its column adds (phase
    13(a)).  Returns the windowed pass's launches and the timeline rows."""
    members, stake, events, packed, _keys = dag
    tag = "trace columns config3"
    cfg = SwirldConfig(n_members=N_MEMBERS)
    os.makedirs(TRACE_DIR, exist_ok=True)
    rows = []
    prefix = pack_events(events[:INC_CHUNK], members, stake)
    label = f"trace_consensus columns config3[:{INC_CHUNK}]"
    outdir = os.path.join(TRACE_DIR, "columns")
    t0 = time.perf_counter()
    result = trace_consensus(prefix, cfg, outdir=outdir, device="cuda")
    wall = time.perf_counter() - t0
    if result_digests(prefix, result) != result_digests(
            prefix, run_consensus(prefix, cfg, device="cuda")):
        failures.append(f"{label}: digests != the untraced pass's")
    path = os.path.join(outdir, "trace.json")
    rows.append(card_timeline(label, path, smi, {
        "whole_pass": True, "call_s": wall,
        "export_s": result.timings["trace_export_seconds"],
        "trace_bytes": os.path.getsize(path),
    }))
    os.remove(path)

    label = f"{tag} window"
    path = os.path.join(TRACE_DIR, "columns-window.json")
    reset_launches()
    t0 = time.perf_counter()
    result, export_s = windowed_trace(
        lambda: run_consensus(packed, cfg, device="cuda"), path, TRACE_SKIP, TRACE_ACTIVE)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    if launches != base_launches:
        failures.append(f"{label}: launches {launches} != untraced {base_launches}")
    if result_digests(packed, result) != GOLDEN["config3"]:
        failures.append(f"{label}: digests != golden")
    rows.append(card_timeline(label, path, smi, {
        "whole_pass": False, "call_s": wall, "export_s": export_s,
        "untraced_s": chunk_call_s * TRACE_ACTIVE,
        "window": f"rounds_chunk_stage calls {TRACE_SKIP + 2}-"
                  f"{TRACE_SKIP + 1 + TRACE_ACTIVE} of the pass, each with the host "
                  "work up to the next",
        "trace_bytes": os.path.getsize(path),
    }))
    os.remove(path)
    for row in rows:
        if row["kernel_launches"] <= 0 or row["hand_kernel_share_of_busy"] <= 0:
            failures.append(f"{row['trace']}: the trace holds no hand-written kernel")
    return launches, rows


def traced_ingest(inc, chunk):
    """One ``ingest`` under ``torch.profiler`` (host and card), its trace
    written under ``TRACE_DIR``.  Returns the trace's path and its row's
    fields for :func:`card_timeline`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        st = inc.ingest(chunk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, "incremental.json")
    prof.export_chrome_trace(path)
    export_s = time.perf_counter() - t0
    return path, {
        "whole_pass": True, "pass": INC_TRACE_PASS, "new_events": st["new_events"],
        "rebased": st["rebased"], "export_s": export_s,
        "trace_bytes": os.path.getsize(path),
    }


def run_obs_driver(kind, name, dag, batch_rtd, base_launches, mon, smi, failures):
    """Phase 13(c): one driver (``kind`` incremental at ``fuse_chunks`` 8,
    or streaming) over one configuration in chunks of ``INC_CHUNK``, with a
    finality tracker, a flight recorder and an ambient Obs, inside a device
    memory phase; the incremental config-3 run's pass ``INC_TRACE_PASS``
    traced (phase 13(b)).  Checks: golden digests, launches equal to the
    untraced run's (``base_launches``), the rounds-to-decision list equal to
    the batch pass's (``batch_rtd``), the registry's
    ``incremental_*`` / ``store_*`` gauges equal to the driver's own
    counters.  Prints the triggers and the profiler's summary."""
    members, stake, events, packed, _keys = dag
    tag = f"obs {kind} {name}"
    cls = IncrementalConsensus if kind == "incremental" else StreamingConsensus
    inc = cls(members, stake, SwirldConfig(n_members=N_MEMBERS), device="cuda")
    inc.finality = FinalityTracker(kind)
    rec = inc.flightrec = FlightRecorder(
        dump_dir=os.path.join(TRACE_DIR, f"flightrec {kind} {name}"))
    prof = DispatchProfiler()
    o = obs.Obs(profiler=prof)
    reset_launches()
    traced = None
    t0 = time.perf_counter()
    with obs.enabled(o), mon.phase(f"{kind} {name}"):
        for i in range(0, len(events), INC_CHUNK):
            chunk = events[i : i + INC_CHUNK]
            if kind == "incremental" and i // INC_CHUNK == INC_TRACE_PASS:
                traced = traced_ingest(inc, chunk)
            else:
                inc.ingest(chunk)
        if kind == "streaming":
            inc.store.archive.digest()        # drains the pack worker
    wall = time.perf_counter() - t0
    if traced is not None:
        # the untraced time of a steady pass: the later passes' mean
        later = [c["wall_s"] for c in prof.chunks[INC_TRACE_PASS + 1 :]]
        path, extra = traced
        card_timeline(f"incremental {name} pass {INC_TRACE_PASS}", path, smi,
                      {**extra, "untraced_s": sum(later) / len(later)})
        os.remove(path)
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    reg = o.registry
    print(f"{tag}: {wall} s, {inc.passes} passes, {inc.rebases} rebases, launches "
          f"{json.dumps(launches)}", flush=True)
    if launches != base_launches:
        failures.append(f"{tag}: launches {launches} != untraced {base_launches}")
    digests = result_digests(packed, inc.result())
    if digests != GOLDEN[name]:
        failures.append(f"{tag}: digests {digests} != golden")
    rtd = inc.finality.rtd
    print(f"{tag}: rounds-to-decision {json.dumps(rtd_digest(rtd))}, finality "
          f"{json.dumps(inc.finality.summary())}", flush=True)
    if rtd != batch_rtd:
        failures.append(f"{tag}: rounds-to-decision list != the batch pass's")
    want = {"incremental_window_size": inc.window_size,
            "incremental_pruned_prefix": inc.pruned_prefix,
            "incremental_r_base": inc._r_base,
            "incremental_passes_total": inc.passes,
            "incremental_rebases_total": inc.rebases}
    if kind == "streaming":
        stats = inc.store.stats()
        want.update(store_resident_bytes=stats["resident_bytes"],
                    store_resident_tiles=stats["resident_tiles"],
                    store_archived_rows=inc.store.archive.n_rows,
                    store_spilled_rows_total=inc.store.archive.spilled_rows)
        print(f"{tag}: resident_bytes {stats['resident_bytes']}, device peak "
              f"{mon.phases[f'{kind} {name}']['device_peak_bytes']} bytes", flush=True)
    got = registry_values(reg, want)
    print(f"{tag}: gauges {json.dumps(got)}", flush=True)
    if got != want:
        failures.append(f"{tag}: gauges {got} != the driver's own {want}")
    print(f"{tag}: triggers {json.dumps(rec.trigger_counts)}", flush=True)
    for path in rec.dumps:
        dump = load_dump(path)
        print(f"{tag}: trigger {dump['reason']} detail {json.dumps(dump['detail'])} "
              f"decided_frontier {json.dumps(dump['decided_frontier'])}", flush=True)
    summary = prof.summary()
    summary.pop("per_chunk")
    print(f"{tag}: dispatch profiler {json.dumps(summary)}", flush=True)
    if kind == "streaming":
        inc.store.close()
    return launches, inc


def run_live_obs(smi, failures):
    """Phase 13(d): the live node with its observability wired by
    ``make_simulation(metrics=True, finality=True, flightrec=...)``, node 0
    on the card until it holds ``LIVE_OBS_EVENTS`` events.  Node 0's
    digests, its rounds-to-decision list (its decided order through
    ``record_batch_result``: a ``"tpu"`` node's engine feeds no tracker, in
    either package) and the population's gossip counters equal the
    reference's (``LIVE_OBS_GOLDEN``).  Returns the launches."""
    tag = "obs live node"
    rec = FlightRecorder()
    sim = live_simulation(N_MEMBERS, LIVE_MIN_BATCH, None, metrics=True,
                          finality=True, flightrec=rec)
    reset_launches()
    t0 = time.perf_counter()
    turns = gossip_until(sim, LIVE_OBS_EVENTS)
    node = sim.nodes[0]
    eng = node._tpu_engine
    if eng.last_result is None or eng.last_result.n != len(node.hg):
        eng.flush()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    packed = eng.packer.pack()
    fin = FinalityTracker("oracle")
    record_batch_result(fin, eng.last_result)
    n_oracle = LIVE_OBS_GOLDEN["oracle_rtd"]["n"]
    got = {"turns": turns, "events": packed.n, **result_digests(packed, eng.last_result),
           "rtd": rtd_digest(fin.rtd), "oracle_rtd": rtd_digest(fin.rtd[:n_oracle]),
           "gossip": gossip_totals(sim.nodes)}
    print(f"{tag}: {wall} s, {json.dumps(got)}", flush=True)
    print(f"{tag}: node_gauges {json.dumps(node_gauges(node))}", flush=True)
    print(f"{tag}: node 0 tracker {json.dumps(node.finality.summary())}, flight "
          f"recorder {rec.records_total} records", flush=True)
    if got != LIVE_OBS_GOLDEN:
        failures.append(f"{tag}: {got} != the reference's {LIVE_OBS_GOLDEN}")
    check_launches(tag, launches, ("bmm_or", "ssm_block"), ("ssm_matrix",), failures)
    return launches


def run_observability(dags, packs, untraced, base, c4, smi, failures):
    """Phase 13.  ``untraced`` is phase 4's config-3 columns ``(launches,
    wall)``; ``base`` maps ``(kind, name)`` to phase 5 / 6's launches; ``c4``
    is phase 5's config-4 incremental run's ``(flight recorder, memory
    monitor)``, read here (13(c): its triggers and device peak)."""
    t_phase = time.perf_counter()
    launches = {}
    _result, batch_rtd, columns, chunk_call_s = run_obs_columns(
        packs["config3"], untraced, failures)
    launches["obs_columns"] = {"config3": columns}
    traced, _rows = run_trace_columns(
        dags["config3"], untraced[0], chunk_call_s, smi, failures)
    launches["obs_trace"] = {"config3": traced}
    mon = MemoryMonitor(device="cuda", enable_host=False)
    launches["obs_drivers"] = {}
    for kind in ("incremental", "streaming"):
        launches["obs_drivers"][f"{kind} config3"], inc = run_obs_driver(
            kind, "config3", dags["config3"], batch_rtd, base[(kind, "config3")], mon,
            smi, failures)
        del inc
        torch.cuda.empty_cache()
    rec, c4_mon = c4
    tag = "obs incremental config4 (phase 5's run)"
    print(f"{tag}: triggers {json.dumps(rec.trigger_counts)}", flush=True)
    for path in rec.dumps:
        dump = load_dump(path)
        print(f"{tag}: trigger {dump['reason']} detail {json.dumps(dump['detail'])} "
              f"decided_frontier {json.dumps(dump['decided_frontier'])}", flush=True)
    print(f"obs memory (device peaks, bytes): "
          f"{json.dumps({**mon.phases, **c4_mon.phases})}", flush=True)
    launches["obs_live_node"] = {"columns node": run_live_obs(smi, failures)}
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    print(f"observability: {time.perf_counter() - t_phase} s", flush=True)
    return launches


# ----------------------------------------- phase 14: chaos and adversaries


def acceptance_scenario(chaos_mod, transport_mod, tpu_node_index=CHAOS_TPU_NODE):
    """The chaos acceptance scenario (5 members, 240 turns, seed 3, one
    divergent forker, lossy links, a partition over turns 80-140, member 4
    down over turns 60-120) built from ``chaos_mod`` / ``transport_mod``, the
    port's modules or the reference's, with member ``tpu_node_index`` on
    ``backend="tpu"``."""
    plan = transport_mod.FaultPlan(
        seed=3,
        default=transport_mod.LinkFaults(
            drop=0.2, corrupt=0.05, duplicate=0.05, reorder=0.1, delay=0.05,
        ),
        partitions=[transport_mod.Partition(start=80, end=140, group=(0, 1))],
        crashes={4: [(60, 120)]},
    )
    return chaos_mod.ChaosScenario(
        n_nodes=5, n_turns=240, seed=3, n_forkers=1, plan=plan,
        checkpoint_every=40, tpu_node_index=tpu_node_index,
    )


@contextlib.contextmanager
def oracle_orders(chaos_mod):
    """Record the order of every oracle replay that ``chaos_mod``'s
    verdicts compute (either package's ``chaos`` module)."""
    orders = []
    replay = chaos_mod.oracle_replay

    def recorded(*args, **kw):
        order = replay(*args, **kw)
        orders.append(order)
        return order

    chaos_mod.oracle_replay = recorded
    try:
        yield orders
    finally:
        chaos_mod.oracle_replay = replay


#: verdict keys that hold no protocol field: the flight recorder's dump
#: path, and the slab archive's two counters that its pack worker thread
#: sets on its own time (bytes packed so far, the queue's high-water mark)
UNTIMED_SKIP = ("flightrec_dump", "archive_bytes", "spill_queue_depth_peak")


def _no_times(x):
    if isinstance(x, dict):
        return {k: _no_times(v) for k, v in x.items()
                if k not in UNTIMED_SKIP and "seconds" not in k}
    if isinstance(x, list):
        return [_no_times(v) for v in x]
    return x


def chaos_fields(verdict, orders=()) -> dict:
    """The protocol fields of a chaos verdict (either package's): every
    section without wall times (``*seconds*`` keys) or the keys of
    ``UNTIMED_SKIP``, and the SHA-256 of the last oracle replay's order
    when ``orders`` (from :func:`oracle_orders`) holds one."""
    out = _no_times(verdict)
    if orders:
        out["oracle_order_sha256"] = hashlib.sha256(b"".join(orders[-1])).hexdigest()
    return out


def engine_rows(verdict) -> list:
    """The verdict's cross-engine rows (none for a verdict without any)."""
    rows = verdict.get("engines")
    if rows is None and "horizon" in verdict:
        rows = [verdict["horizon"]]
    if isinstance(rows, dict):
        rows = [rows]
    return rows or []


def device_seconds(verdict) -> float:
    """Wall seconds of a verdict's device runs: its engine replays (or
    ``run_all_engines``) and the overflow storm's two ``run_consensus``."""
    return (sum(r.get("seconds", 0.0) for r in engine_rows(verdict))
            + sum(verdict[k]["seconds"] for k in ("fork_storm", "round_clamp")
                  if k in verdict))


def check_chaos_golden(tag, name, fields, failures):
    want = CHAOS_GOLDEN[name]
    if fields != want:
        keys = sorted(k for k in set(fields) | set(want) if fields.get(k) != want.get(k))
        failures.append(f"{tag}: verdict fields {keys} != CHAOS_GOLDEN: "
                        f"{json.dumps({k: fields.get(k) for k in keys}, sort_keys=True)}")


def run_chaos_node(failures):
    """Phase 14(a): the acceptance scenario with member ``CHAOS_TPU_NODE``
    on the card (``TorchEngine`` on ``"cuda"``), crashed over turns 60-120
    and restored through ``load_node(device="cuda")``.  Returns the run's
    kernel launches."""
    tag = "chaos acceptance"
    engines, passes = [], []

    def on_turn(turn, sim):
        node = sim.nodes.get(CHAOS_TPU_NODE)
        eng = node._tpu_engine if node is not None else None
        if eng is None:
            return
        if not engines or engines[-1][0] is not eng:
            engines.append((eng, 0, 0.0))
        _, n0, s0 = engines[-1]
        if eng.n_passes != n0:
            passes.append({"turn": turn, "engine": len(engines) - 1,
                           "passes": eng.n_passes - n0, "events": eng.last_result.n,
                           "seconds": eng.pass_seconds - s0})
            engines[-1] = (eng, eng.n_passes, eng.pass_seconds)

    reset_launches()
    with tempfile.TemporaryDirectory() as tmp, oracle_orders(chaos) as orders:
        sim = chaos.ChaosSimulation(acceptance_scenario(chaos, transport), tmp,
                                    on_turn=on_turn, device="cuda")
        t0 = time.perf_counter()
        verdict = sim.run()
        wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    node = sim.nodes[CHAOS_TPU_NODE]
    eng = node._tpu_engine
    pass_seconds = sum(p["seconds"] for p in passes)
    print(f"{tag}: {wall} s, ok {verdict['ok']}; node {CHAOS_TPU_NODE} (engine on "
          f"{eng.device}) passes (turn, engine incarnation, passes, events, seconds): "
          f"{json.dumps([[p['turn'], p['engine'], p['passes'], p['events'], round(p['seconds'], 6)] for p in passes])}",
          flush=True)
    print(f"{tag}: {len(passes)} turns with a pass, {pass_seconds} s of passes on the "
          f"card, {wall - pass_seconds} s host; restore {json.dumps(node.restore_seconds)}"
          f"; launches {json.dumps(launches)}", flush=True)
    print(f"{tag}: {json.dumps(chaos_fields(verdict, orders), sort_keys=True)}", flush=True)
    if not verdict["ok"]:
        failures.append(f"{tag}: verdict not ok")
    check_chaos_golden(tag, "acceptance", chaos_fields(verdict, orders), failures)
    if (len(engines) < 2 or eng is not engines[-1][0] or eng.device.type != "cuda"
            or eng.n_passes < 2 or verdict["resilience"]["restarts"] != 1):
        failures.append(f"{tag}: the restored node's engine did not run on the card "
                        f"after its restore ({len(engines)} engines, {eng.n_passes} passes)")
    check_launches(tag, launches, ("bmm_or", "ssm_block"), ("ssm_matrix",), failures)
    return launches


def run_scenarios(failures):
    """Phase 14(b): every ``SCENARIOS`` entry with ``device="cuda"``, the
    ``CHAOS_MULTI`` ones replayed through ``CHAOS_ENGINES``.  Returns each
    scenario's kernel launches."""
    out = {}
    for name, runner in SCENARIOS.items():
        tag = f"chaos {name}"
        engine = CHAOS_ENGINES if name in CHAOS_MULTI else "incremental"
        reset_launches()
        with tempfile.TemporaryDirectory() as tmp, oracle_orders(chaos) as orders:
            t0 = time.perf_counter()
            verdict = runner(tmp, engine=engine, device="cuda")
            wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in KERNELS.items()}
        card = device_seconds(verdict)
        fields = chaos_fields(verdict, orders)
        print(f"{tag}: ok {verdict['ok']}, {wall} s: {wall - card} s host simulation, "
              f"{card} s in the device runs; launches {json.dumps(launches)}", flush=True)
        print(f"{tag}: {json.dumps(fields, sort_keys=True)}", flush=True)
        if not verdict["ok"]:
            failures.append(f"{tag}: verdict not ok")
        rows = engine_rows(verdict)
        for row in rows:
            if "parity" in row:
                bad = not row["parity"]
            else:
                bad = not (row["batch_oracle_parity"] and row["incremental_batch_parity"])
            if bad:
                failures.append(f"{tag}: engines row {json.dumps(_no_times(row))} disagrees")
        check_chaos_golden(tag, name, fields, failures)
        if name == "overflow_storm" and verdict["fork_storm"]["overflow_retries"] < 1:
            failures.append(f"{tag}: the fork leg took no overflow retry on the card")
        if card > 0:
            # membership_churn's device runs are run_all_engines over a
            # multi-epoch schedule: repacks, no native engine, no kernel
            # (phase 12(b))
            needs = () if name == "membership_churn" else ("bmm_or", "ssm_block")
            if name in CHAOS_MULTI:
                needs += ("make_mesh_row_block_fn", "ssm_tally")
            check_launches(tag, launches, needs, ("ssm_matrix",), failures)
        elif any(launches.values()):
            failures.append(f"{tag}: kernels launched outside a device run")
        out[name] = launches
    return out


def reindex(result, from_ids, to_ids):
    """``result`` (indices into ``from_ids``) with its indices moved to
    ``to_ids``' order, the same events in another order."""
    pos = {eid: i for i, eid in enumerate(from_ids)}
    perm = np.array([pos[eid] for eid in to_ids], dtype=np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return dataclasses.replace(
        result,
        round=result.round[perm], is_witness=result.is_witness[perm],
        famous={int(inv[k]): v for k, v in result.famous.items()},
        round_received=result.round_received[perm],
        consensus_ts=result.consensus_ts[perm],
        order=[int(inv[i]) for i in result.order],
    )


def straggler_chunks(events):
    """The straggler arrival schedule of phase 14(c), and how many events
    it moved out of their creation-order chunk."""
    chunks = chunked_ingest_schedule(events, INC_CHUNK, seed=SEED, **STRAGGLERS)
    at = {ev.id: j for j, ev in enumerate(events)}
    moved = sum(at[ev.id] // INC_CHUNK != c for c, chunk in enumerate(chunks) for ev in chunk)
    return chunks, moved


def run_stragglers(dags, columns_evps, failures):
    """Phase 14(c): config 4 through ``IncrementalConsensus`` and config 3
    through ``StreamingConsensus`` on the card, each over its first
    ``PREFIX_EVENTS`` events fed the straggler schedule, with the checks of
    :func:`drive_passes` against ``PREFIX_GOLDEN``.  Returns each run's
    kernel launches."""
    out = {}
    for name, kind in STRAGGLER_RUNS.items():
        dag = prefix_dag(dags[name])
        members, stake, events = dag[:3]
        chunks, moved = straggler_chunks(events)
        print(f"stragglers {name}: {len(chunks)} chunks of {[len(c) for c in chunks]} "
              f"events, {moved} events moved out of their creation-order chunk",
              flush=True)
        if moved == 0:
            failures.append(f"stragglers {name}: the schedule moved no event")
        driver = IncrementalConsensus if kind == "incremental" else StreamingConsensus
        inc = driver(members, stake, SwirldConfig(n_members=N_MEMBERS), device="cuda")
        out[f"{name} {kind}"] = drive_passes(
            kind, f"{name} stragglers", inc, dag, columns_evps[name], failures,
            chunks=chunks,
        )
        if kind == "streaming":
            inc.store.close()
    return out


def run_chaos_phase(dags, columns_evps, failures):
    """Phase 14.  Returns its launches by leg."""
    t_phase = time.perf_counter()
    crypto.set_backend("sim")
    launches = {"chaos_node": {"acceptance": run_chaos_node(failures)}}
    t_a = time.perf_counter()
    launches["chaos_scenarios"] = run_scenarios(failures)
    t_b = time.perf_counter()
    launches["stragglers"] = run_stragglers(dags, columns_evps, failures)
    t_c = time.perf_counter()
    print(f"chaos and adversaries: {t_c - t_phase} s ((a) {t_a - t_phase} s, (b) "
          f"{t_b - t_a} s, (c) {t_c - t_b} s)", flush=True)
    return launches


# ------------------------------------------ phase 15: the real-process cluster

#: the signer a fresh process picks, as every node process of phase 15 does
#: (main() switches this process to the simulation signer for the goldens)
DEFAULT_SIGNER = crypto.backend_name()


def run_cluster_legs(tmp, failures):
    """Phase 15(a) and (b): ``bench.run_cluster`` (the chaos leg, then the
    overload leg) through the port's supervisor and node processes.
    Returns the chaos leg's verdict, its oracle order and its union event
    log, and the seconds of each leg."""
    tag = "cluster chaos leg"
    with oracle_orders(net_cluster) as orders:
        out, rc, d = bench.run_cluster(stamps={}, workdir=tmp)
    walls = d["seconds"]
    print(f"bench --cluster: rc {rc}; {json.dumps(out['cluster'], sort_keys=True)[:3000]}",
          flush=True)
    v, spec = d["verdict"], d["spec"]
    _reports, union, _rows = net_cluster.collect_node_state(
        spec.workdir, spec.managed_indices(), {}, {})
    victim = v["nodes"][spec.kill_index]
    tx = v["tx"]
    print(f"{tag}: {walls[0]} s, ok {v['ok']}; union {len(union)} events, oracle order "
          f"{v['safety']['oracle_len']}, common prefix {v['safety']['common_prefix_len']}; "
          f"heal at {v['faults']['heal_wall_s']} s, decided at heal "
          f"{v['liveness']['decided_at_heal']}, final {v['liveness']['decided_final']}",
          flush=True)
    ledger = {k: tx[k] for k in ("submitted", "acked", "shed", "failed", "decided",
                                 "tx_per_s", "submit_p50", "submit_p99")}
    row = {k: victim.get(k) for k in ("restarts", "unclean_start", "exit_code",
                                      "decided", "events")}
    print(f"{tag}: tx {json.dumps(ledger)}; victim {json.dumps(row)}; "
          f"counters {json.dumps(v['counters'], sort_keys=True)}", flush=True)
    checks = {
        "bench exit 0": rc == 0,
        "verdict ok": v["ok"],
        "prefix_agree": v["safety"]["prefix_agree"],
        "oracle_agree": v["safety"]["oracle_agree"],
        "decided past the heal": v["liveness"]["decided_final"] > v["liveness"]["decided_at_heal"],
        "killed and restarted": v["faults"]["killed"] and v["faults"]["restarted"],
        "victim restarted once": victim["restarts"] == 1,
        "victim started unclean": victim.get("unclean_start") is True,
        "post-mortem on disk": bool(victim.get("flightrec_dump"))
        and os.path.exists(victim["flightrec_dump"]),
        "acked and decided txs": tx["acked"] > 0 and tx["decided"] > 0,
        "one oracle replay a leg": len(orders) == 2,
    }
    for name, ok in checks.items():
        if not ok:
            failures.append(f"{tag}: {name} failed")
    ov = d["overload"]
    tx = ov["tx"]
    print(f"cluster overload leg: {walls[1]} s, ok {ov['ok']}; submitted "
          f"{tx['submitted']}, acked {tx['acked']}, shed {tx['shed']} (tx_shed_window "
          f"{ov['counters']['tx_shed_window']})", flush=True)
    if not (ov["ok"] and tx["acked"] == 0 and tx["shed"] > 0
            and ov["counters"]["tx_shed_window"] == tx["shed"]
            and ov["counters"]["tx_accepted"] == 0):
        failures.append(f"cluster overload leg: not ok or not shed: {json.dumps(tx)} "
                        f"{json.dumps(ov['counters'])}")
    return v, (orders[0] if orders else []), union, walls


def run_union_replays(v, oracle, union, failures):
    """Phase 15(c): the chaos leg's union event log replayed into an observer
    in ``oracle_replay``'s topological order, then ``chaos._engines_agree``
    on the card for each of ``CLUSTER_ENGINES``: a batch ``run_consensus``
    at block 64 and the windowed driver in 64-event chunks.  Returns each
    replay's kernel launches."""
    n, seed = CLUSTER_SPEC["n_nodes"], CLUSTER_SPEC["seed"]
    t0 = time.perf_counter()
    observer = chaos.oracle_observer(
        union, [pk for pk, _ in net_cluster.member_keys(n, seed)],
        SwirldConfig(n_members=n, seed=seed), net_cluster.observer_keypair(seed),
    )
    host_s = time.perf_counter() - t0
    print(f"cluster union replay: observer {len(observer.order_added)} events, "
          f"{len(observer.consensus)} decided, {host_s} s on the host", flush=True)
    if observer.consensus != oracle or len(oracle) != v["safety"]["oracle_len"]:
        failures.append("cluster union replay: the observer's order is not the verdict's")
    out = {}
    for engine in CLUSTER_ENGINES:
        tag = f"cluster union replay {engine}"
        reset_launches()
        row = chaos._engines_agree(observer, engine=engine, device="cuda")
        launches = {k: fn.launches for k, fn in KERNELS.items()}
        print(f"{tag}: {row['seconds']} s for {len(observer.order_added)} events; "
              f"{json.dumps(_no_times(row), sort_keys=True)}; launches {json.dumps(launches)}",
              flush=True)
        if not (row["batch_oracle_parity"] and row["incremental_batch_parity"]):
            failures.append(f"{tag}: engines disagree: {json.dumps(_no_times(row))}")
        check_launches(tag, launches, ("bmm_or", "ssm_block"), ("ssm_matrix",), failures)
        out[engine] = launches
    return out


def run_cluster_phase(failures):
    """Phase 15, under the machine's default signer (the node processes'),
    restored to the simulation signer after.  Returns the replays'
    launches."""
    t_phase = time.perf_counter()
    crypto.set_backend(DEFAULT_SIGNER)
    print(f"cluster: signer {crypto.backend_name()} in the supervisor and every node "
          "process", flush=True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            v, oracle, union, walls = run_cluster_legs(tmp, failures)
        t_b = time.perf_counter()
        t_a = t_phase + walls[0]
        launches = run_union_replays(v, oracle, union, failures) if union else {}
        if not union:
            failures.append("cluster: the chaos leg left no event log")
    finally:
        crypto.set_backend("sim")
    t_c = time.perf_counter()
    print(f"real-process cluster: {t_c - t_phase} s ((a) {t_a - t_phase} s, (b) "
          f"{t_b - t_a} s, (c) {t_c - t_b} s)", flush=True)
    return {"cluster": launches}


# ------------------------ phase 16: the model checker, the soak and viz


def run_checker(failures):
    """Phase 16(a), under the simulation signer.  Returns the parity
    replay's launches."""
    tag = "mc"
    t0 = time.perf_counter()
    smoke = STAMPS["mc"] = mc_smoke()
    t_smoke = time.perf_counter() - t0
    print(f"{tag} smoke: {t_smoke} s; {json.dumps(smoke, sort_keys=True)}", flush=True)
    if not smoke["ok"]:
        failures.append(f"{tag} smoke: not ok: {json.dumps(smoke)}")
    t0 = time.perf_counter()
    cex = run_mc(mutate="fork-blind").get("counterexample") or {}
    print(f"{tag} fork-blind: {time.perf_counter() - t0} s; caught "
          f"{cex.get('violation', {}).get('invariant')} (expected "
          f"{cex.get('expected_invariant')}), minimized {cex.get('schedule_len')} -> "
          f"{cex.get('minimized_len')} actions, replay reproduced "
          f"{cex.get('replay_reproduced')} digests {cex.get('replay_digests_match')} "
          f"trace {cex.get('replay_trace_match')}", flush=True)
    if not (cex.get("caught_expected") and cex.get("replay_reproduced")
            and cex.get("replay_digests_match") and cex.get("replay_trace_match")):
        failures.append(f"{tag} fork-blind: not caught or not replayed")
    doc = chaos_run.parity_document(0)
    reset_launches()
    t0 = time.perf_counter()
    rep = chaos.replay_counterexample(doc, engine="incremental", device="cuda")
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    print(f"{tag} parity replay: {wall} s; {json.dumps(_no_times(rep), sort_keys=True)}; "
          f"launches {json.dumps(launches)}", flush=True)
    if not (rep["ok"] and rep["reproduced"] and rep["digests_match"]
            and rep["trace_match"] and "error" not in rep["engines"]
            and rep["engines"]["batch_oracle_parity"]
            and rep["engines"]["incremental_batch_parity"]):
        failures.append(f"{tag} parity replay: {json.dumps(_no_times(rep))}")
    check_launches(f"{tag} parity replay", launches, ("bmm_or", "ssm_block"),
                   ("ssm_matrix",), failures)
    return launches


def fork_pairs(node) -> int:
    """Seq groups of two or more events by one creator in ``node``'s store."""
    return sum(1 for m in node.members for g in node.by_seq[m].values() if len(g) >= 2)


def run_soak_leg(tmp, failures):
    """Phase 16(b)'s cluster: the port's ``bench --soak`` at its defaults
    (``run_soak`` in the setting above).  Returns the verdict, its
    oracle order and the union event log."""
    tag = "soak"
    with oracle_orders(soak) as orders:
        t0 = time.perf_counter()
        out, rc, d = bench.run_soak(stamps={}, workdir=os.path.join(tmp, "soak"))
        wall = time.perf_counter() - t0
    print(f"bench --soak: rc {rc}; {json.dumps(out['soak'], sort_keys=True)[:3000]}",
          flush=True)
    v, spec = d["verdict"], d["spec"]
    honest = [i for i in range(spec.n_nodes)
              if i not in v["adversary"]["byzantine_indices"]]
    _reports, union, _rows = net_cluster.collect_node_state(spec.workdir, honest, {}, {})
    victims = [row for row in v["nodes"] if row["restarts"] >= 1]
    print(f"{tag}: {wall} s, ok {v['ok']}; {v['disruptions_survived']} of "
          f"{v['disruptions_total']} disruptions survived; tx_per_s {v['tx_per_s']}, "
          f"submit_p99_s {v['submit_p99_s']}; union {len(union)} events, oracle order "
          f"{v['safety']['oracle_len']}; proxy {json.dumps(v['proxy'], sort_keys=True)}; "
          f"adversary {json.dumps(v['adversary'], sort_keys=True)}", flush=True)
    print(f"{tag}: counters {json.dumps(v['counters'], sort_keys=True)}; accounting "
          f"{json.dumps({k: v['accounting'].get(k) for k in ('submitted', 'leaked', 'balance_ok', 'shed_rate')})}; "
          f"victims {json.dumps([{k: r.get(k) for k in ('index', 'restarts', 'unclean_start', 'exit_code')} for r in victims])}",
          flush=True)
    checks = {
        "bench exit 0": rc == 0,
        "verdict ok": v["ok"],
        "oracle_agree and prefix_agree": v["safety"]["oracle_agree"]
        and v["safety"]["prefix_agree"],
        "3 of 3 disruptions survived": v["disruptions_survived"] == v["disruptions_total"] == 3,
        "proxies relayed": v["proxy"].get("relayed", 0) > 0,
        "partition blocked": v["proxy"].get("partition_blocked", 0) > 0,
        "attack stepped": v["adversary"]["attack_steps"] > 0,
        "equivocations detected": v["adversary"]["equivocations_detected"] > 0,
        "victim restarted unclean": bool(victims)
        and all(r["unclean_start"] for r in victims),
        "books balance": bool(v["accounting"]["balance_ok"]),
        "0 leaked": v["accounting"]["leaked"] == 0,
        "txs submitted": v["accounting"]["submitted"] > 0,
        "one oracle replay": len(orders) == 1,
    }
    for name, ok in checks.items():
        if not ok:
            failures.append(f"{tag}: {name} failed")
    return v, (orders[-1] if orders else []), union


def run_soak_replay(v, oracle, union, failures):
    """Phase 16(b)'s card leg: the union into an observer in
    ``oracle_replay``'s order, then ``_engines_agree(engine=SOAK_ENGINE)``.
    Returns the observer and the replay's launches."""
    tag = f"soak union replay {SOAK_ENGINE}"
    n, seed = SOAK_SPEC["n_nodes"], SOAK_SPEC["seed"]
    t0 = time.perf_counter()
    observer = chaos.oracle_observer(
        union, [pk for pk, _ in net_cluster.member_keys(n, seed)],
        SwirldConfig(n_members=n, seed=seed), net_cluster.observer_keypair(seed),
    )
    host_s = time.perf_counter() - t0
    print(f"{tag}: observer {len(observer.order_added)} events, "
          f"{len(observer.consensus)} decided, {fork_pairs(observer)} fork pairs, "
          f"{observer.equivocations_detected} equivocations, {host_s} s on the host",
          flush=True)
    if observer.consensus != oracle or len(oracle) != v["safety"]["oracle_len"]:
        failures.append(f"{tag}: the observer's order is not the verdict's")
    if fork_pairs(observer) == 0:
        failures.append(f"{tag}: the union holds no fork pair")
    reset_launches()
    row = chaos._engines_agree(observer, engine=SOAK_ENGINE, device="cuda")
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    print(f"{tag}: {row['seconds']} s for {len(observer.order_added)} events; "
          f"{json.dumps(_no_times(row), sort_keys=True)}; launches {json.dumps(launches)}",
          flush=True)
    if not (row["batch_oracle_parity"] and row["incremental_batch_parity"]):
        failures.append(f"{tag}: engines disagree: {json.dumps(_no_times(row))}")
    check_launches(tag, launches, ("bmm_or", "ssm_block"), ("ssm_matrix",), failures)
    return observer, launches


def run_viz(observer, failures):
    """Phase 16(c): the observer's export against its DAG's batch result on
    the card.  Returns the batch pass's launches."""
    tag = "viz"
    t0 = time.perf_counter()
    rows = viz.export_state(node=observer)
    reset_launches()
    packed = pack_node(observer)
    result = run_consensus(packed, observer.config, block=64, device="cuda")
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    card_rows = viz.export_state(packed=packed, result=result)
    back = json.loads(viz.to_json(packed=packed, result=result))
    print(f"{tag}: {time.perf_counter() - t0} s; {len(rows)} rows, "
          f"{sum(r['order'] is not None for r in card_rows)} ordered, "
          f"{sum(r['witness'] for r in card_rows)} witnesses; export equal "
          f"{card_rows == rows}, json round trip {back == rows}; launches "
          f"{json.dumps(launches)}", flush=True)
    if card_rows != rows or back != rows:
        failures.append(f"{tag}: the card's export is not the oracle node's")
    check_launches(tag, launches, ("bmm_or", "ssm_block"), ("ssm_matrix",), failures)
    return launches


def run_analysis_phase(failures):
    """Phase 16: (a) under the simulation signer, (b) and (c) under the
    machine's default signer (the node processes'), restored to the
    simulation signer after.  Returns the launches by leg."""
    t_phase = time.perf_counter()
    crypto.set_backend("sim")
    out = {"mc": {"parity": run_checker(failures)}}
    t_a = time.perf_counter()
    crypto.set_backend(DEFAULT_SIGNER)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            v, oracle, union = run_soak_leg(tmp, failures)
        t_cluster = time.perf_counter()
        if union:
            observer, replay_launches = run_soak_replay(v, oracle, union, failures)
            out["soak"] = {SOAK_ENGINE: replay_launches}
            t_b = time.perf_counter()
            out["viz"] = {"columns": run_viz(observer, failures)}
        else:
            failures.append("soak: the run left no event log")
            t_b = time.perf_counter()
    finally:
        crypto.set_backend("sim")
    t_c = time.perf_counter()
    print(f"model checker, soak and viz: {t_c - t_phase} s ((a) {t_a - t_phase} s, "
          f"(b) {t_b - t_a} s: cluster {t_cluster - t_a} s, replay {t_b - t_cluster} s; "
          f"(c) {t_c - t_b} s)", flush=True)
    return out


# ------------------------------------ phase 17: the analysis gates on the card


def run_archive_fuzz(failures):
    """Phase 17(a): the archive fuzz with rows on the card, then the same
    fuzz over :class:`ViewSpillArchive`, which the sanitizer must catch.
    Returns the fuzz's launches (the archive runs no kernel)."""
    tag = "races"
    reset_launches()
    t0 = time.perf_counter()
    rep = races.run_archive_schedules(**ARCHIVE_FUZZ, device="cuda")
    t1 = time.perf_counter()
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    print(f"{tag}: {t1 - t0} s for {rep['schedules']} schedules on {rep['device']}; "
          f"digest {rep['digest']}, identical {rep['digests_identical']}, sync match "
          f"{rep['matches_sync']}, lock edges {rep['lock_edges']}, acyclic "
          f"{rep['acyclic']}, errors {rep['errors']}", flush=True)
    checks = {
        "ok": rep["ok"],
        "digests identical": rep["digests_identical"],
        "matches the synchronous run": rep["matches_sync"],
        "digest golden": rep["digest"] == rep["sync_digest"] == ARCHIVE_FUZZ_DIGEST,
        "lock graph acyclic": rep["acyclic"],
        "no fetch or checkpoint error": rep["errors"] == [],
    }
    bad = races.run_archive_schedules(
        **ARCHIVE_FUZZ, device="cuda", archive_cls=ViewSpillArchive
    )
    print(f"{tag} view-race fixture: {time.perf_counter() - t1} s; ok {bad['ok']}, "
          f"identical {bad['digests_identical']}, sync match {bad['matches_sync']}, "
          f"{len(bad['errors'])} schedules reported", flush=True)
    checks.update({
        "view race reported": not bad["ok"] and not bad["matches_sync"]
        and bad["digest"] != bad["sync_digest"],
        "view race's synchronous run golden": bad["sync_digest"] == ARCHIVE_FUZZ_DIGEST,
    })
    for name, ok in checks.items():
        if not ok:
            failures.append(f"{tag}: {name} failed")
    return launches


def run_sanitize(failures):
    """Phase 17(b): ``chaos_run --sanitize 2 --device cuda``.  Returns its
    launches (the base run and both re-runs)."""
    tag = "chaos_run --sanitize"
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "verdict.json")
        reset_launches()
        t0 = time.perf_counter()
        rc = chaos_run.main([*SANITIZE_ARGS, "--device", "cuda", "--out", out])
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in KERNELS.items()}
        with open(out) as f:
            v = json.load(f)
    san = v.get("sanitizer", {})
    print(f"{tag}: {wall} s, rc {rc}; sanitizer {json.dumps(san, sort_keys=True)}; "
          f"safety {json.dumps(v.get('safety'), sort_keys=True)}; launches "
          f"{json.dumps(launches)}", flush=True)
    checks = {
        "exit 0": rc == 0,
        "verdict ok": v.get("ok") is True,
        "2 schedules": san.get("schedules") == 2,
        "verdicts stable": san.get("verdicts_stable") is True,
        "every re-run ok": san.get("all_ok") is True,
        "archive digests identical": san.get("archive", {}).get("digests_identical") is True,
        "archive matches sync": san.get("archive", {}).get("matches_sync") is True,
        "archive lock graph acyclic": san.get("archive", {}).get("acyclic") is True,
        "safety golden": v.get("safety") == SANITIZE_SAFETY,
    }
    for name, ok in checks.items():
        if not ok:
            failures.append(f"{tag}: {name} failed")
    check_launches(tag, launches, ("bmm_or", "ssm_block"), ("ssm_matrix",), failures)
    return launches


def run_jit_audit(failures):
    """Phase 17(c): ``runtime_audit`` at the reference's defaults through
    ``AUDIT_ENGINE`` on the card.  Returns its launches."""
    tag = f"jit-audit {AUDIT_ENGINE}"
    reset_launches()
    t0 = time.perf_counter()
    rep = jit_audit.runtime_audit(engine=AUDIT_ENGINE, device="cuda")
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    print(f"{tag}: {wall} s, the steady window {rep['steady_seconds']} s; steady "
          f"builds {rep['steady_compiles']}, drift {rep['signature_drift']}, fused span "
          f"{rep['fused_span_audited']} (fuse_chunks {rep['fuse_chunks']}); calls "
          f"{json.dumps(rep['steady_calls'])}; launches {json.dumps(launches)}", flush=True)
    checks = {
        "on the card": rep["device"] == "cuda",
        "no steady kernel build": rep["steady_compiles"] == {},
        "no signature drift": rep["signature_drift"] == [],
        "the CPU's stages": rep["stages_observed"] == AUDIT_STAGES,
        "ok": rep["ok"],
    }
    for name, ok in checks.items():
        if not ok:
            failures.append(f"{tag}: {name} failed")
    check_launches(tag, launches, ("bmm_or", "ssm_block"), ("ssm_matrix",), failures)
    return launches


def run_static_gates(failures):
    """Phase 17(d), on the host: the port lints clean (its summary is phase
    20's ``lint`` stamp), ``lint.sh``'s gates 3 and 4 find nothing, and the
    static stage audit finds exactly ``STATIC_AUDIT_FINDINGS``."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    findings = lint_paths([os.path.join(root, "tpu_swirld_torch")])
    STAMPS["lint"] = lint_summary(findings)
    gates = {name: suppression_gate(name) for name in SUPPRESSION_GATES}
    t1 = time.perf_counter()
    static = [(f["path"], f["stage"], f["message"]) for f in jit_audit.static_audit(root)]
    print(f"lint: {t1 - t0} s, {len(findings)} findings, suppression gates "
          f"{json.dumps({k: len(v) for k, v in gates.items()})}; static stage audit: "
          f"{time.perf_counter() - t1} s, {json.dumps(static)}", flush=True)
    for f in findings + [g for bad in gates.values() for g in bad]:
        failures.append(f"lint: {f if isinstance(f, str) else f.render()}")
    if static != STATIC_AUDIT_FINDINGS:
        failures.append(f"static stage audit: {static} is not the recorded list")


def run_gates_phase(failures):
    """Phase 17, under the simulation signer.  Returns the launches by leg."""
    t_phase = time.perf_counter()
    fuzz = run_archive_fuzz(failures)
    t_a = time.perf_counter()
    sanitize = run_sanitize(failures)
    t_b = time.perf_counter()
    audit = run_jit_audit(failures)
    t_c = time.perf_counter()
    run_static_gates(failures)
    t_d = time.perf_counter()
    print(f"analysis gates: {t_d - t_phase} s ((a) {t_a - t_phase} s, (b) {t_b - t_a} s, "
          f"(c) {t_c - t_b} s, (d) {t_d - t_c} s)", flush=True)
    return {"sanitize": {"archive": fuzz, "chaos_run": sanitize},
            "jit_audit": {AUDIT_ENGINE: audit}}


# -------------------------------- phase 18: the scale-envelope audit on the card


def start_flow_audits():
    """Phase 18(c)'s two host audits, each in a process of its own, started
    before (a) so they run beside it: ``envelope -> (process, t0)``."""
    root = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    for env in ("baseline", "1m"):
        procs[env] = (subprocess.Popen(
            [sys.executable, "-m", "tpu_swirld_torch.analysis", "scale-audit",
             "--envelope", env, "--no-coverage", "--json"],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ), time.perf_counter())
    return procs


def run_flow_soundness(failures):
    """Phase 18(a): the soundness property for every engine on the card.
    Returns the launches of each engine's own run, the snapshotted first
    calls of the mesh run, the pulls assumed and the stages observed."""
    launches, mesh_calls, pulls, observed = {}, {}, {}, {}
    for engine in FLOW_ENGINES:
        tag = f"flow soundness {engine}"
        reset_launches()
        t0 = time.perf_counter()
        rep = flow_audit.soundness_check(
            engine, device="cuda",
            launches=lambda: {k: fn.launches for k, fn in KERNELS.items()},
        )
        launches[engine] = rep["launches"]
        observed[engine] = rep["stages"]
        pulls.update(rep["pulls"])
        if engine == "mesh":
            mesh_calls = rep["calls"]
        print(f"{tag}: {time.perf_counter() - t0} s, {len(rep['replayed'])} stages "
              f"replayed, {len(rep['violations'])} outside their intervals; launches "
              f"{json.dumps(rep['launches'])}", flush=True)
        for v in rep["violations"]:
            failures.append(f"{tag}: {v}")
        if rep["stages"] != FLOW_STAGES[engine]:
            failures.append(f"{tag}: stages {rep['stages']} are not the CPU's")
    total = {k: sum(per[k] for per in launches.values()) for k in KERNELS}
    check_launches("flow soundness", total,
                   ("bmm_or", "ssm_block", "ssm_matrix", "ssm_tally"), (), failures)
    return launches, mesh_calls, pulls, observed


def _edge_inputs():
    """``FLOW_EDGE``'s slab: 4 members of 64 events each at stake
    178 956 970 (the int32 envelope's edge), sparse random sees (so the
    other rows' tallies vary) with its first rows and each member's first
    event seeing every event, every member slot and column valid."""
    e = FLOW_EDGE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    n, m, k = e["n"], e["members"], e["k"]
    sees = random_bool((n, n), e["density"], gen)
    mt = torch.arange(m * k, dtype=torch.int32, device="cuda").reshape(m, k)
    # the first rows see every event, and each member's first event sees
    # every event too: an all-seeing row reaches every column through
    # every member
    sees[: e["seeing_rows"]] = True
    sees[mt[:, 0].long()] = True
    stake = torch.full((m,), e["stake"], dtype=torch.int32, device="cuda")
    cols = torch.arange(n - e["cols"], n, dtype=torch.int32, device="cuda")
    return sees, mt, stake, cols


def _tally_operand(sees, mt, cols):
    """The ``b`` operand of ``ssm_tally``: each member slot's row of
    ``sees`` at the columns, invalid slots and columns zero."""
    n = sees.shape[0]
    idx = mt.reshape(-1)
    b = sees[idx.clamp(0, n - 1)[:, None], cols.clamp(0, n - 1)[None, :]]
    return (b & (idx >= 0)[:, None] & (cols >= 0)[None, :]).contiguous()


def run_tally_contract(mesh_calls, failures):
    """Phase 18(b): ``ssm_tally`` at (a)'s mesh block shapes and at the
    stake envelope's edge, in ``[0, tot_stake]`` and equal to its plain
    version, the edge's all-seeing rows exactly ``tot_stake``; ``ssm_block``
    and ``ssm_matrix`` equal to their plain versions at both shapes on the
    card's own inputs moved to the CPU."""
    tag = "flow tally contract"
    cases = {}
    if "pipeline.ssm_block_mesh" in mesh_calls:
        args, kw = mesh_calls["pipeline.ssm_block_mesh"]
        sees, mt, stake, cols, row0 = args
        cases["mesh block"] = (sees, mt, stake, cols, int(row0), kw["rows"],
                               int(kw["tot_stake"]), 0)
    else:
        failures.append(f"{tag}: the mesh run made no ssm_block_mesh call")
    sees, mt, stake, cols = _edge_inputs()
    tot_edge = kernels.check_stake_envelope(int(stake.sum()))
    cases["envelope edge"] = (sees, mt, stake, cols, 0, sees.shape[0], tot_edge,
                              FLOW_EDGE["seeing_rows"])
    for label, (sees, mt, stake, cols, row0, rows, tot, seeing) in cases.items():
        n = sees.shape[0]
        row0 = min(max(row0, 0), n - rows)
        b = _tally_operand(sees, mt, cols)
        tally = kernels.ssm_tally(sees, mt, stake, b, row0, rows=rows)
        torch.cuda.synchronize()
        cpu = [x.cpu() for x in (sees, mt, stake, b)]
        plain = kernels.ssm_tally_reference(*cpu, row0, rows=rows)
        blk = kernels.ssm_block(sees, mt, stake, cols, row0, rows=rows, tot_stake=tot)
        blk_plain = kernels.ssm_block_reference(sees.cpu(), mt.cpu(), stake.cpu(),
                                                cols.cpu(), row0, rows=rows, tot_stake=tot)
        mat = kernels.ssm_matrix(sees, mt, stake, tot_stake=tot)
        mat_plain = kernels.ssm_matrix_reference(sees.cpu(), mt.cpu(), stake.cpu(),
                                                 tot_stake=tot)
        t = tally.cpu().to(torch.int64)
        checks = {
            "every tally in [0, tot_stake]": int(t.min()) >= 0 and int(t.max()) <= tot,
            "ssm_tally equal to its plain version": torch.equal(tally.cpu(), plain),
            "ssm_block equal to its plain version": torch.equal(blk.cpu(), blk_plain),
            "ssm_matrix equal to its plain version": torch.equal(mat.cpu(), mat_plain),
        }
        if seeing:
            rows_seen = t[: seeing - row0]
            checks["the all-seeing rows' tally is tot_stake, no wrap"] = bool(
                (rows_seen == tot).all())
        print(f"{tag} {label}: sees {tuple(sees.shape)}, member table "
              f"{tuple(mt.shape)}, {cols.shape[0]} columns, rows [{row0}, {row0 + rows}), "
              f"tot_stake {tot}; tally in [{int(t.min())}, {int(t.max())}]; "
              f"{json.dumps(checks)}", flush=True)
        for name, ok in checks.items():
            if not ok:
                failures.append(f"{tag} {label}: {name} failed")


def finish_flow_audits(procs, observed, failures):
    """Phase 18(c): the two host audits' verdicts (exit 0, proven clean,
    every suppression justified), (a)'s observed stages covered by the
    catalog, both mutations caught.  Returns the audits' seconds and
    pulls."""
    cmap = flow_stages.coverage_map()
    gaps = sorted({s for names in observed.values() for s in names if s not in cmap})
    if gaps:
        failures.append(f"flow coverage: stages {gaps} are not in the catalog")
    seconds, pulls = {}, {}
    for env, (proc, t0) in procs.items():
        out, err = proc.communicate(timeout=600)
        seconds[env] = time.perf_counter() - t0
        try:
            doc = json.loads(out)
        except ValueError:
            failures.append(f"scale-audit {env}: rc {proc.returncode}, no report: "
                            f"{err[-2000:]}")
            continue
        stamp = {"envelope": doc["envelope"], "engines": doc["engines"],
                 "clean": doc["clean"],
                 "findings": len(doc["findings"]) + len(doc["unjustified"]),
                 "suppressed": len(doc["suppressed"]), "errors": len(doc["errors"])}
        pulls.update(doc["pulls"])
        if env == "baseline":
            STAMPS["scale_audit"] = stamp
        print(f"scale-audit {env}: rc {proc.returncode}, {seconds[env]} s (its own "
              f"process), {len(doc['specs'])} specs, stamp {json.dumps(stamp)}, "
              f"coverage gaps {gaps}", flush=True)
        if proc.returncode != 0 or not doc["clean"] or stamp["findings"] or stamp["errors"]:
            failures.append(f"scale-audit {env}: rc {proc.returncode}, "
                            f"{json.dumps(doc['findings'] + doc['errors'])[:2000]}")
        if not all(f["justification"] for f in doc["suppressed"]):
            failures.append(f"scale-audit {env}: a suppression lacks its reason")
    want = {"ssm-acc-int16": {"SW010", "SW008"}, "dropped-clip": {"SW009"}}
    for mutation, rules in want.items():
        rep = flow_audit.scale_audit("baseline", mutate=mutation, check_coverage=False)
        got = {f.rule for f in rep.findings}
        print(f"scale-audit --mutate {mutation}: exit {rep.exit_code}, rules "
              f"{sorted(got)} at {sorted({(f.path, f.line) for f in rep.findings})}",
              flush=True)
        if rep.exit_code != 1 or got != rules:
            failures.append(f"scale-audit --mutate {mutation}: exit {rep.exit_code}, "
                            f"rules {sorted(got)}")
    return seconds, pulls


def run_flow_phase(failures):
    """Phase 18.  Returns the launches of each engine's soundness run."""
    t_phase = time.perf_counter()
    procs = start_flow_audits()
    try:
        launches, mesh_calls, pulls, observed = run_flow_soundness(failures)
        t_a = time.perf_counter()
        run_tally_contract(mesh_calls, failures)
        t_b = time.perf_counter()
        seconds, host_pulls = finish_flow_audits(procs, observed, failures)
    finally:
        for proc, _t0 in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    t_c = time.perf_counter()
    pulls.update(host_pulls)
    print(f"flow pulls: {json.dumps(pulls, sort_keys=True)}", flush=True)
    print(f"scale-envelope audit: {t_c - t_phase} s ((a) {t_a - t_phase} s, (b) "
          f"{t_b - t_a} s, (c) {t_c - t_b} s after (a) and (b); the host audits "
          f"{json.dumps(seconds)} s in their own processes)", flush=True)
    return {"flow": launches}


def group_block_inputs(packed, path):
    """Phase 19(c)'s inputs, as phase 9 draws its extension block (stake
    1-5, 256 columns in [2048, 5120)): the config-3 sees slab, member
    table, stake and columns, saved at ``path`` for the ranks.  Returns
    ``(args, kw)`` of the same block on the card, for ``ssm_block`` and its
    plain version."""
    sees = sees_slab(packed)
    rng = np.random.default_rng(SEED)
    stake_np = rng.integers(1, 6, N_MEMBERS).astype(np.int32)
    cols_np = np.sort(rng.choice(np.arange(2048, 5120), GROUP_BLOCK["cols"],
                                 replace=False)).astype(np.int32)
    np.savez(path, sees=sees.cpu().numpy(), member_table=packed.member_table,
             stake=stake_np, cols=cols_np)
    dev = sees.device
    args = (sees, torch.as_tensor(packed.member_table, device=dev),
            torch.as_tensor(stake_np, device=dev), torch.as_tensor(cols_np, device=dev),
            GROUP_BLOCK["row0"])
    return args, dict(rows=GROUP_BLOCK["rows"], tot_stake=int(stake_np.sum()))


def check_group_dryrun(tag, reports, out_i, failures):
    """Phase 19(a) on one group: the dryrun's report on every rank
    (parity was asserted in the rank; the launcher compared digests)."""
    for rank, rep in enumerate(reports):
        out = rep["result"]["results"][out_i]
        used = rep["result"]["launches"][out_i]
        print(f"{tag} rank {rank} ({rep['device']}): dryrun {out['events']} events, "
              f"{out['ordered']} ordered, max_round {out['max_round']}, bit-parity "
              f"with the oracle; launches {json.dumps(used)}", flush=True)
        if used["ssm_tally"] < 1:
            failures.append(f"{tag} rank {rank}: the dryrun launched no ssm_tally")


def check_group_batch(tag, reports, out_i, packed, failures):
    """Phase 19(b): the config-3 member-sharded pass on every rank."""
    for rank, rep in enumerate(reports):
        out = rep["result"]["results"][out_i]
        used = rep["result"]["launches"][out_i]
        timings = out["timings"]
        attempts = 1 + timings["overflow_retries"]
        print(f"{tag} rank {rank} batch {GROUP_BATCH_CONFIG}: {packed.n / out['wall']} "
              f"events/s ({out['wall']} s), {attempts} attempt(s); stage seconds "
              f"{json.dumps(timings['stage_seconds'])}; launches {json.dumps(used)}",
              flush=True)
        digests = result_digests(packed, out["result"])
        for key, want in GOLDEN[GROUP_BATCH_CONFIG].items():
            if digests[key] != want:
                failures.append(f"{tag} rank {rank}: {key} digest {digests[key]} != golden")
        if used["ssm_tally"] != attempts:
            failures.append(f"{tag} rank {rank}: {used['ssm_tally']} ssm_tally launches "
                            f"for {attempts} attempt(s)")
        for kname in ("ssm_matrix", "ssm_block"):
            if used[kname]:
                failures.append(f"{tag} rank {rank}: {kname} launched {used[kname]} times")


def check_group_block(tag, reports, out_i, single, plain, failures):
    """Phase 19(c): every rank's block, both routes, against ``ssm_block``
    and its plain version."""
    if not np.array_equal(single, plain):
        failures.append(f"{tag}: ssm_block != its plain version")
    for rank, rep in enumerate(reports):
        out = rep["result"]["results"][out_i]
        used = rep["result"]["launches"][out_i]
        lo, hi = out["shard_rows"]
        same = {route: bool(np.array_equal(block, single))
                for (route, _row0), block in out["blocks"].items()}
        print(f"{tag} rank {rank}: rows [{lo}, {hi}) of the slab, block rows "
              f"{GROUP_BLOCK['rows']} from {GROUP_BLOCK['row0']} x {GROUP_BLOCK['cols']}; "
              f"equal to ssm_block {json.dumps(same)}; launches {json.dumps(used)}",
              flush=True)
        if not all(same.values()):
            failures.append(f"{tag} rank {rank}: a row-sharded block != ssm_block")
        owns = lo < GROUP_BLOCK["row0"] + GROUP_BLOCK["rows"] and GROUP_BLOCK["row0"] < hi
        if used["ssm_tally"] != int(owns) or used["make_mesh_row_block_fn"] != 1:
            failures.append(f"{tag} rank {rank}: launches {used} for one block a route")


def group_stream_schedule(name):
    """Phase 19(d)'s schedule ``name``: ``(members, stake, chunks)``."""
    g = GROUP_STREAMS[name]
    members, stake, events, _keys = generate_gossip_dag(
        g["members"], g["events"], seed=g["seed"], n_forkers=g["forkers"])
    return members, stake, [events[i : i + g["ingest"]]
                            for i in range(0, len(events), g["ingest"])]


def group_stream_reference(name, schedule):
    """The one-process streaming driver's run of schedule ``name`` on the
    card: its digests, archive digest, and peak device bytes above what
    was held, in all and by stage (``multichip.stage_peaks``)."""
    members, stake, chunks = schedule
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    single = StreamingConsensus(members, stake,
                                SwirldConfig(n_members=GROUP_STREAMS[name]["members"]),
                                device="cuda", **GROUP_STREAMS[name]["driver"])
    monitor = multichip.watch_stage_peaks(single)
    try:
        for chunk in chunks:
            single.ingest(chunk)
        torch.cuda.synchronize()
        events = [e for c in chunks for e in c]
        peaks = multichip.stage_peaks(monitor, base)
        return {"digests": result_digests(pack_events(events, members, stake),
                                          single.result()),
                "archive": single.store.archive.digest(),
                "stage_peaks": peaks, "peak_bytes": max(peaks.values())}
    finally:
        single.store.close()


def check_group_stream(tag, reports, out_i, name, schedule, want, failures):
    """Phase 19(d): every rank's streaming run of schedule ``name`` against
    the one-process driver's (each rank checked its slabs' rows after
    every ingest)."""
    members, stake, chunks = schedule
    packed = pack_events([e for c in chunks for e in c], members, stake)
    for rank, rep in enumerate(reports):
        out = rep["result"]["results"][out_i]
        used = rep["result"]["launches"][out_i]
        digests = result_digests(packed, out["result"])
        print(f"{tag} rank {rank} stream {name}: collectives a pass "
              f"{[st['group_calls'] for st in out['passes']]}, bytes to them "
              f"{[st['group_bytes'] for st in out['passes']]}, own slab bytes "
              f"{[st['rank_resident_bytes'] for st in out['passes']]} of "
              f"{[st['resident_bytes'] for st in out['passes']]}; peak {out['peak_bytes']} "
              f"device bytes (one process: {want['peak_bytes']}); counters "
              f"{json.dumps(out['counters'])}; launches {json.dumps(used)}", flush=True)
        print(f"{tag} rank {rank} stream {name}: peak device bytes by stage "
              f"{json.dumps(out['stage_peaks'])}; one process "
              f"{json.dumps(want['stage_peaks'])}", flush=True)
        if digests != want["digests"] or out["archive"]["digest"] != want["archive"]:
            failures.append(f"{tag} rank {rank}: the streaming run's digests != the "
                            "one-process driver's")
        c = out["counters"]
        if c["repins"] or c["forked"] != (GROUP_STREAMS[name]["forkers"] > 0) or (
                name == "smoke" and not c["pruned_prefix"]):
            failures.append(f"{tag} rank {rank} stream {name}: counters {c}")
        if used["ssm_tally"] < 1 or used["bmm_or"] < 1 or used["ssm_block"]:
            failures.append(f"{tag} rank {rank}: stream launches {used}")


def run_multichip_phase(packs, failures):
    """Phase 19.  Every group starts at once, sharing the card; the
    references they are held against are computed while the ranks run.
    Returns each rank's launches, by group."""
    t_phase = time.perf_counter()
    packed = packs[GROUP_BATCH_CONFIG]
    by_rank = {}
    with tempfile.TemporaryDirectory(prefix="swirld-multichip-") as tmp:
        packed_path = os.path.join(tmp, "packed.npz")
        save_packed(packed_path, packed)
        block_path = os.path.join(tmp, "block.npz")
        block_args, block_kw = group_block_inputs(packed, block_path)
        schedules = {name: group_stream_schedule(name) for name in GROUP_STREAMS}
        cfg = SwirldConfig(n_members=N_MEMBERS)
        tasks = {"dryrun": (multichip.dryrun_rank, ()),
                 "batch": (multichip.batch_rank, (packed_path, cfg)),
                 "block": (multichip.row_block_rank, (block_path, (GROUP_BLOCK["row0"],),
                                                      GROUP_BLOCK["rows"])),
                 **{name: (multichip.streaming_rank, (
                     members, stake, SwirldConfig(n_members=GROUP_STREAMS[name]["members"]),
                     chunks, {**GROUP_STREAMS[name]["driver"], "pallas": True}))
                    for name, (members, stake, chunks) in schedules.items()}}
        groups = {}
        for (backend, world), legs in GROUP_RUNS.items():
            tag = f"multichip {backend} x{world}"
            try:
                groups[tag] = (legs, multichip.start(
                    multichip.tasks_rank, world, args=([tasks[leg] for leg in legs],),
                    device="cuda", backend=backend, timeout=GROUP_TIMEOUT,
                ))
            except (ValueError, RuntimeError) as e:
                failures.append(f"{tag}: did not start: {e}")
        t_started = time.perf_counter()
        single = kernels.ssm_block(*block_args, **block_kw).cpu().numpy()
        plain = kernels.ssm_block_reference(*block_args, **block_kw).cpu().numpy()
        del block_args
        torch.cuda.empty_cache()
        wants = {name: group_stream_reference(name, schedules[name])
                 for name in GROUP_STREAMS}
        print(f"multichip references: {time.perf_counter() - t_started} s, "
              f"while the groups ran", flush=True)
        for tag, (legs, group) in groups.items():
            try:
                reports = group.wait()
            except multichip.RankFailure as e:
                failures.append(f"{tag}: {str(e)[-3000:]}")
                continue
            print(f"{tag}: done by {time.perf_counter() - t_started} s after the "
                  f"groups started, for {list(legs)}", flush=True)
            for i, leg in enumerate(legs):
                if leg == "dryrun":
                    check_group_dryrun(tag, reports, i, failures)
                elif leg == "batch":
                    check_group_batch(tag, reports, i, packed, failures)
                elif leg == "block":
                    check_group_block(tag, reports, i, single, plain, failures)
                else:
                    check_group_stream(tag, reports, i, leg, schedules[leg], wants[leg],
                                       failures)
            for rank, rep in enumerate(reports):
                by_rank[f"{rep['backend']} x{len(reports)} rank {rank}"] = rep["launches"]
    print(f"meshes over several processes: {time.perf_counter() - t_phase} s", flush=True)
    return {"multichip": by_rank}


# -------------------------------------- phase 20: the port's bench on the card


def bench_call(tag, fn, *args, knobs=None, **kw):
    """One ``tpu_swirld_torch.bench`` mode in this process under ``knobs``:
    its JSON line printed, its exit code checked by the caller.  Returns
    ``(out, rc, detail, launches, seconds)``."""
    reset_launches()
    t0 = time.perf_counter()
    with bench.knobs(**(knobs or {})):
        out, rc, detail = fn(*args, stamps=dict(STAMPS), **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in KERNELS.items()}
    print(f"{tag}: rc {rc}, {wall} s; launches {json.dumps(launches)}", flush=True)
    print(f"{tag}: {json.dumps(out)}", flush=True)
    return out, rc, detail, launches, wall


def run_bench_stream(failures):
    """Phase 20(a): ``bench --stream`` at config 5's width and ``BENCH_STREAM``'s
    depth: exit 0, the budget held, the decided output golden, the
    extension kernels launched and the matrix not."""
    tag = "bench --stream (config 5, cut)"
    out, rc, detail, launches, _ = bench_call(tag, bench.run_stream, 65536, 256,
                                               device="cuda", knobs=BENCH_STREAM)
    st = out["stream"]
    got = dict(detail["digests"], ordered=st["ordered"])
    print(f"{tag}: {st['evps']} events/s, window peak {st['peak_resident_visibility_bytes']} "
          f"bytes ({st['peak_resident_tiles']} tiles), device peak "
          f"{out['peak_device_bytes']} bytes, archived {st['archived_rows']} rows / "
          f"{st['archive_bytes']} bytes, widen / full rebases {st['widen_rebases']} / "
          f"{st['full_rebases']}; digests golden {got == BENCH_STREAM_GOLDEN}", flush=True)
    if rc != 0 or not st["budget_ok"] or not st["parity"]:
        failures.append(f"{tag}: rc {rc}, budget_ok {st['budget_ok']}, parity {st['parity']}")
    if got != BENCH_STREAM_GOLDEN:
        failures.append(f"{tag}: decided output {got} is not the reference's")
    check_launches(tag, launches, ("bmm_or", "ssm_block"), ("ssm_matrix",), failures)
    return launches


def run_bench_default(failures):
    """Phase 20(b): the default mode (config 3) with ``BENCH_DEFAULT``: exit 0,
    the batch, incremental and streaming parities, the batch digests
    ``BENCH_DEFAULT_GOLDEN``'s."""
    tag = "bench (default mode, config 3)"
    out, rc, detail, launches, _ = bench_call(tag, bench.run_default, "cuda",
                                               knobs=BENCH_DEFAULT)
    parities = {"batch": out["metric"].endswith("order parity=True"),
                "incremental": out["incremental"]["parity"],
                "stream": out["stream"]["parity"]}
    print(f"{tag}: {out['value']} events/s (vs the oracle {out['vs_baseline']}x), "
          f"incremental steady {out['incremental']['steady_evps']}, stream "
          f"{out['stream']['evps']}; parities {json.dumps(parities)}; device peak "
          f"{out['peak_device_bytes']} bytes", flush=True)
    if rc != 0 or not all(parities.values()):
        failures.append(f"{tag}: rc {rc}, parities {parities}")
    if detail["digests"] != BENCH_DEFAULT_GOLDEN:
        failures.append(f"{tag}: batch digests are not BENCH_DEFAULT_GOLDEN")
    check_launches(tag, launches, ("bmm_or", "ssm_block"), ("ssm_matrix",), failures)
    return launches


def run_bench_others(failures):
    """Phase 20(c): ``--chaos-overhead`` and ``--churn`` at their defaults:
    exit 0, counts equal to the reference's."""
    out, rc, _d, chaos_launches, _ = bench_call("bench --chaos-overhead",
                                                bench.run_chaos_overhead, "cuda")
    got = {k: out["chaos_overhead"][k] for k in BENCH_CHAOS_COUNTS}
    if rc != 0 or got != BENCH_CHAOS_COUNTS:
        failures.append(f"bench --chaos-overhead: rc {rc}, counts {got}")
    check_launches("bench --chaos-overhead", chaos_launches, ("bmm_or", "ssm_block"),
                   ("ssm_matrix",), failures)
    # the epoch-aware driver over a multi-epoch schedule is the observer's
    # host replay, as in the reference: its device leg is the repack
    out, rc, d, churn_launches, _ = bench_call("bench --churn", bench.run_churn, "cuda")
    got = {k: out["churn"][k] for k in BENCH_CHURN_COUNTS}
    print(f"bench --churn: repack outputs on {d['repack_devices']}", flush=True)
    if rc != 0 or got != BENCH_CHURN_COUNTS:
        failures.append(f"bench --churn: rc {rc}, counts {got}")
    if not d["repack_devices"] or any(not x.startswith("cuda") for x in d["repack_devices"]):
        failures.append(f"bench --churn: repack outputs on {d['repack_devices']}")
    check_launches("bench --churn", churn_launches, (), ("ssm_matrix",), failures)
    return chaos_launches, churn_launches


def run_bench_phase(failures):
    """Phase 20, under the simulation signer.  Returns the launches by mode."""
    t_phase = time.perf_counter()
    if set(STAMPS) != set(bench.STAMP_KEYS):
        failures.append(f"bench: stamps {sorted(STAMPS)} missing from phases 16-18")
    stream = run_bench_stream(failures)
    t_a = time.perf_counter()
    default = run_bench_default(failures)
    t_b = time.perf_counter()
    chaos_l, churn_l = run_bench_others(failures)
    t_c = time.perf_counter()
    print(f"bench: {t_c - t_phase} s ((a) {t_a - t_phase} s, (b) {t_b - t_a} s, "
          f"(c) {t_c - t_b} s)", flush=True)
    return {"bench": {"stream": stream, "default": default, "chaos_overhead": chaos_l,
                      "churn": churn_l}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    failures = []
    t_script = time.perf_counter()
    # the golden digests were made under the simulation signer
    crypto.set_backend("sim")

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {time.perf_counter() - t0:.3f} s for {built}", flush=True)

    dags, packs = {}, {}
    for name, n_forkers in CONFIGS.items():
        t0 = time.perf_counter()
        dags[name] = make_dag(n_forkers)
        packs[name] = packed = dags[name][3]
        print(f"{name}: generated and packed {packed.n} events, "
              f"{len(packed.fork_pairs)} fork pairs, member table "
              f"{packed.member_table.shape} in {time.perf_counter() - t0:.3f} s",
              flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    g_cap = ((len(packs["config4"].fork_pairs) + 7) // 8) * 8
    bmm_rows = check_bmm_or(gen, g_cap, failures)
    slabs = {name: sees_slab(packed) for name, packed in packs.items()}
    ssm_rows = check_ssm_block(packs, slabs, failures, config5_window())
    sweep_ssm_block(failures)
    matrix_rows = check_ssm_matrix(packs, slabs, failures)
    sweep_ssm_matrix(failures)
    del slabs
    torch.cuda.empty_cache()

    # launches[path][config][kernel], from the measured runs
    launches = {path: {} for path in PATHS}
    columns_evps = {}
    for name, packed in packs.items():
        for path in PATHS:
            launches[path][name], evps = run_main_path(name, packed, path, failures)
            if path == "columns":
                columns_evps[name] = evps
    launches["incremental"] = {}
    c4 = config4_observers()
    def depth(kind, label, name):
        return prefix_dag(dags[name]) if (kind, label) in PREFIX_RUNS else dags[name]

    for label, (name, fuse) in INC_RUNS.items():
        launches["incremental"][label] = run_incremental(
            label, depth("incremental", label, name), fuse, columns_evps[name], failures,
            c4=c4 if label == "config4" else None,
        )
    launches["streaming"], archives = {}, {}
    for name in CONFIGS:
        launches["streaming"][name], inc, archives[name] = run_streaming(
            name, depth("streaming", name, name), columns_evps[name], failures
        )
        if name == "config3":
            launches["widen"] = {name: run_widen(inc, dags[name], failures)}
        inc.store.close()
        del inc
    launches["mesh"] = {}
    for name in CONFIGS:
        launches["mesh"][name] = run_mesh(
            name, depth("mesh", name, name), columns_evps[name],
            (launches["streaming"][name], archives[name]), failures,
        )
    torch.cuda.empty_cache()
    mesh_rows, tally_row, hop_row = check_mesh_block(packs["config3"], failures)
    torch.cuda.empty_cache()
    launches["mesh_batch"] = {
        name: run_mesh_batch(name, depth("mesh_batch", name, name)[3], failures)
        for name in CONFIGS
    }
    sharded_rows, member_tally_row, mesh_block_row = check_member_sharded(packs, failures)
    torch.cuda.empty_cache()
    launches["live_node"], live_nodes = {}, {}
    for label in LIVE_NODES:
        launches["live_node"][label], live_nodes[label] = run_live_node(label, failures)
    del live_nodes["mesh_shape node"]
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    launches["dynamic_pin"] = run_single_epoch_pin(dags["config3"], failures)
    run_churn(failures)
    launches["restore"] = {"columns node": run_restore(live_nodes.pop("columns node"), failures)}
    print(f"dynamic membership and restore: {time.perf_counter() - t0} s", flush=True)

    untraced = (launches["columns"]["config3"], packs["config3"].n / columns_evps["config3"])
    base = {("incremental", name): launches["incremental"][name] for name in CONFIGS}
    base[("streaming", "config3")] = launches["streaming"]["config3"]
    launches.update(run_observability(dags, packs, untraced, base, c4, smi, failures))
    launches.update(run_chaos_phase(dags, columns_evps, failures))
    launches.update(run_cluster_phase(failures))
    launches.update(run_analysis_phase(failures))
    launches.update(run_gates_phase(failures))
    launches.update(run_flow_phase(failures))
    launches.update(run_multichip_phase(packs, failures))
    launches.update(run_bench_phase(failures))

    # one row per kernel at its hottest main-path shape: the ancestry
    # propagation hop for bmm_or, the full-height column add for ssm_block,
    # the config-4 matrix for ssm_matrix, the 2-shard extension block for
    # make_mesh_row_block_fn and one of its shards for ssm_tally (no single
    # PyTorch call computes either); ssm_tally's shapes add one member
    # shard's N x N tally and the two member-sharded routes over it
    def entry(name, row, rows, library_ms):
        by_path = {path: {cfg: counts[name] for cfg, counts in per.items()}
                   for path, per in launches.items()}
        return {
            "name": name, "route": "cuda", **KERNEL_INFO[name],
            "launches": sum(sum(per.values()) for per in by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            **({"ops_bound_int8_ms": row["ops_bound_int8_ms"]}
               if "ops_bound_int8_ms" in row else {}),
            "library_ms": library_ms, "shapes": rows,
        }

    line = {"kernels": [
        entry("bmm_or", bmm_rows[1], bmm_rows + [hop_row], bmm_rows[1]["library_ms"]),
        entry("ssm_block", ssm_rows[0], ssm_rows, None),
        entry("ssm_matrix", matrix_rows[0], matrix_rows, None),
        entry("make_mesh_row_block_fn", mesh_rows[0], mesh_rows, None),
        entry("ssm_tally", tally_row,
              [tally_row, member_tally_row, *sharded_rows, mesh_block_row], None),
    ]}
    if failures:
        for f in failures:
            print("FAIL:", f, file=sys.stderr)
        return 1
    print(f"chip_smoke: {time.perf_counter() - t_script} s from the build to "
          "the last check", flush=True)
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
