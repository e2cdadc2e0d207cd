#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (volcano_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --profile [OUT.json]  # first a profiler pass
    python3 chip_smoke.py --split    # only K1's shapes, the batched solve's stage split, K13 at cfg9
    python3 chip_smoke.py --victim-split  # only the victim solve's split (K7, K12b)
    python3 chip_smoke.py --storm-split   # only K8-K10 and K15a-c at config 6, timed
    python3 chip_smoke.py --exact-split   # only the exact solve's split (K2, K5 / K6 in it)
    python3 chip_smoke.py --residue  # only the residue cells (phases 24-25)
    python3 chip_smoke.py --fast-cells  # only cfg5-batch, cfg5d, cfg6 (parent comparisons)
    python3 chip_smoke.py --publish-split  # only the publish modes at cfg5-batch, cfg6, cfg9
    python3 chip_smoke.py --restart-cells  # only the snapshot-cache cells and phase 26
    python3 chip_smoke.py --delta-cells  # only cfg10 and config 8 (phases 27-28, 30)
    python3 chip_smoke.py --store-cells  # only cfg5-batch, config 7, cfg9b (phases 3, 29, 31)

Phases, each fatal on failure:

1. build — compile csrc/*.cu with nvcc (one process per source) and print
   the card's name and power limit and ptxas's register/shared-memory
   report;
2. kernels — each kernel on the card at main-path shapes against its plain
   PyTorch version on the same card and inputs, with CUDA-event times:
   water_fill at simargs.WATER_FILL_CASES (k1_split: the config-5 shape,
   128 queues, 2,048 cells, a 21-round fill, and 4,096 and 8,192 queues
   summed in two levels of windows, each bit for bit, beside
   its launch floors with and without a 4-byte blocking read,
   k1_launch_floor) and allocate_solve_batch at build_sim_args(10000,
   100000, 5000), with the packed decision buffer the solve writes and its one
   fetch to the host, and the batched solve's split (batch_split: a
   torch.profiler pass over one solve, device ms by kernel of
   csrc/allocate_batch.cu, the rounds and the host gap); allocate_solve at
   build_sim_args(10000, 4000, 200), with the cluster size it ran on, us a
   step and the timed instantiation's split (_exact_timed; the K5 and K6
   rows of phases 7 and 11 carry the same); then a sweep of small solves over
   seeds and policies (classes, pod caps, releasing capacity, rollbacks,
   build_portsel_args host ports and pod (anti)affinity, and
   build_volsel_args volumes: global and node-pinned pools, bound-PV node
   sets, two claims of one group on a task, jobs contending for one PV);
3. e2e batch — the port's Scheduler(store, full_conf("cuda")).run_once()
   (enqueue, reclaim, allocate, backfill, preempt; the contention
   prechecks find no work here) on the config-5 store (10,000
   nodes, 5,000 gangs x 20 tasks, 2,000 best-effort pods), launch counts
   reset just before and read just after, then one steady cycle (the only
   cell that runs one: cut for the run's time), then ARMED_STEADY_CYCLES
   rounds of three steady cycles, disarmed, vtprof, vtprof and the tracer
   (armed_steady; they launch no kernel): vtprof's attribution of its own
   cycles at least ATTRIBUTION_BAR (0.95), no decision made, vtprof's
   per-kernel dispatch counts equal to LAUNCHES (both empty), no
   steady-state anomaly, one scrape of the
   metrics server's /metrics, /debug/prof and /debug/trace, each mode's
   walls;
4. e2e exact — the same nodes with 200 gangs x 20 tasks (the exact solve);
5. e2e cfg5d — config 5 with 10% dynamic gangs (bench.py config5_dynamic:
   500 gangs with a host port or self-anti-affinity, 10,000 tasks): the
   express solve and the dynamic solve both take K3, the dynamic one with
   the portsel extension (K5); no node may hold a host port twice or two
   pods that anti-affinity forbids together;
6. e2e cfg5d-exact — the same store with 4% dynamic gangs (4,000 dynamic
   tasks): the dynamic solve takes K2 with K5;
7. K5 kernels — K3 and K2 with portsel against their plain versions on the
   dynamic-solve inputs the two cells above captured from their first
   cycle (mirror, snapshot, express solve, build_dyn_solve_inputs);
8. e2e cfg6, cfg6b, cfg6r, cfg6-exact — bench.py's contended store
   (10,000 nodes each exactly full on cpu with ten 800m / 1.2Gi residents
   of q0): cfg6 storms it with 100 urgent gangs x 20 tasks of 1500m / 2Gi
   (the batched preempt rounds, K10), cfg6b adds an empty-request pod to
   the first gang (that gang takes the exact preempt solve, K9), cfg6r has
   10 gangs x 20 of a second queue reclaiming (K8), cfg6-exact is cfg6
   under solveMode: exact (every storm task through K9's walk, the
   preempt phase's wall in the log).  Two cycles each (the storm's
   evictions and pipelines, then its binds; the reference pattern's third,
   quiet cycle is cut for the run's time), the victims deleted
   after each (as the kubelet does): no pod evicted twice, every victim a
   q0 resident (below the preemptor's priority in the storm cells), the
   pipelined requests covered by each node's idle plus releasing capacity
   and pod cap, storm gangs pipelined all or nothing, and the per-cycle
   (evictions, pipelines, binds) of the JAX package's 1/10-scale run;
9. K8-K10 kernels — against their plain versions on the inputs the three
   cells captured from their first cycle, and K9 over the whole cfg6 storm
   as solveMode: exact runs it (2,000 attempts), bit for bit against its
   plain version on the whole storm (on its first 10 gangs only when the
   whole storm's plain version would pass PLAIN_STORM_LIMIT_S, 20 s, cut
   for the run's time: in practice on the first 10 gangs; ``--storm-split``
   holds the whole storm against it);
10. e2e cfg5v-500, cfg5v-2000 — config 5 plus 500 / 2,000 volume-
   constrained tasks in 20-task gangs (bench.py config5_volumes): even
   gangs mount a Bound claim whose PV is pinned to one node, odd ones share
   one pending claim of the static class volb, drawn from a node-pinned PV
   pool.  The volume gangs take the dynamic solve on K2 with K5 and K6
   (volsel).  Every bound-claim gang sits on its PV's node, every static
   gang on one node whose volb PV now holds its claim (the claim Bound), no
   PV is claimed twice and no pod is bound whose volume bind failed; every
   other pod binds, and a volume gang left unbound has no node its claim
   allows with room for it (the express pass and backfill filled them; the
   JAX package leaves such gangs too);
11. K6 kernel — K2 with portsel and volsel against its plain version on the
   dynamic-solve inputs cfg5v-2000 captured, the final claim and capacity
   state included (the sweep of phase 2 holds it on small seeded payloads);
12. e2e cfg6r-be — cfg6r plus one empty-request pod first in gang rec000's
   task order: the fast cycle declines a best-effort reclaimer, so every
   cycle runs the object path (session, plugins, the five actions over the
   tensor backend); the reclaimer's attempt is a host detour with a
   resync, every other preemptor attempt one K7 (victim_step) launch over
   the groups _VictimDriver builds once per snapshot load (victim_groups).
   Two cycles (the pattern's first two, cut for the run's time), victims
   reaped: the cfg6 eviction invariants and the JAX package's per-cycle
   pattern at 1/20 scale; K7 and group-build launches,
   K7 device ms, the resyncs' walls and the object cycle's walls (session
   open, each action, close) per cycle.  Run with the Scheduler's snapshot
   cache and, under ``--restart-cells`` only (cut from the main run for its
   time), again without it (``sched.snapshot_cache = None``; one cycle):
   the same first-cycle evictions, pipelines and binds; each cycle's
   session-open split
   (ObjectCapture.take_split: the object snapshot, the plugins' opens, the
   first tensor snapshot build, the rebuilds after each invalidate, the
   class rows built, the uploads), and with the cache no class row built
   and no cached array copied again from cycle 2 on;
13. K7 kernel — the group build against its plain version at bench config
   4's shape and on the edge pools of simargs.GROUP_EDGE_CASES on 1 and 4
   node blocks in every eviction order (group_edge_sweep), victim_step
   warm (the groups held) and cold (built in the call) against its plain
   version there (16 solves timed each), a chain of 32 solves over one
   grouping with the state fed back against the plain chain, the three
   modes and five flags on small seeded inputs, cold and warm, and the
   first inputs cfg6r-be gave it, warm and cold;
14. e2e cfg5-obj — config 5's nodes and 5,000 gangs x 20 (no best-effort
   pods) with fast_path off: the object cycle's allocate runs K3 and the
   bulk apply; every gang task bound in cycle 1; two cycles (the quiet
   third cut for the run's time) with the snapshot cache and, under
   ``--restart-cells`` only, one without it (the same binds; the split and
   the reuse checks of phase 12);
15. cap lifts — the shapes the card refused before the node-tiled solves,
   each against its plain version: K3 at 65,536- and 131,072-node buckets
   (build_sim_args(40,000 / 100,000, 100,000, 5,000)), K10 at a 65,536-node
   bucket (build_storm_sim), K2 with 128 queues, K1 with 2,048 (queue, dim)
   cells;
16. e2e cfg9 — bench.py's cfg9 store (_build_shard_e2e_store: 100,000
   nodes, 1,000,000 tasks in gangs of 20 over 16 namespaces, two weighted
   queues; here at 1/10 of its nodes and tasks, CFG9_MAIN, cut for the
   run's time limit) under full_conf("cuda") with mesh "4" (solve_mode auto: the
   batched solve runs on four node blocks, K12a): every gang task bound
   within two cycles, no node over capacity, every gang all or nothing;
   the first batched solve's inputs captured;
17. K12a — on cfg9's captured inputs: the one-block tiled K3 against its
   plain version and against the cycle's sharded decisions, the sharded
   solve on local meshes of 1, 2, 4 and 8 blocks and its plain version on
   the cell's 4 (each equal bit for bit to the one-block run), and a one-rank NCCL
   process group (FileStore rendezvous) running four blocks
   over all_gather_into_tensor; the 4-block solve's split (batch_split);
18. e2e cfg6r-be-mesh — the cfg6r-be store under full_conf("cuda") with
   mesh "4" and solve_mode "batch": every preemptor attempt is one K12b
   (victim_step_sharded) launch on four node blocks.  One cycle (the
   pattern's first, cut for the run's time), victims reaped, the cfg6 eviction invariants and the per-cycle pattern;
   the per-cycle (evictions, pipelines, binds), the ordered evictions, the
   pipelines and the binds equal the same store's run under mesh "off"
   with solve_mode "batch" (K7), with as many K12b launches each cycle as
   that run's K7 launches; K12b launches, device ms and the object cycle's
   walls per cycle; under ``--restart-cells`` the mesh "4" run again
   without the snapshot cache, the same decisions, the split and the
   reuse checks of phase 12;
19. K12b kernel — at bench config 4's shape on local meshes of 1, 2, 4 and
   8 blocks (16 solves timed, warm and cold), each bit for bit equal to its
   plain version on the same blocks and to the one-block K7, state
   included; a chain of 16 solves over one grouping with the blocked state
   fed back; the three modes and the
   flags on small seeded inputs on 2, 4 and 8 blocks; a one-rank NCCL group
   running four blocks; the first inputs cfg6r-be-mesh gave it;
20. K13 at cfg9 — run_lockstep at 1, 2 and 4 hosts over four node blocks on
   phase 16's captured inputs, the merged outputs bit for bit equal to
   phase 17's 4-block K12a run, each host's build / dispatch / owned fetch
   walls and the solve_wait; four hosts' owned slices tiling every output;
21. cfg5-2h and the process mode — config 5's store under mesh "4" (no
   reclaim or preempt: mesh_hosts > 1 refuses them) on one host, then as
   the coordinator and the worker of two hosts, each over its own store:
   disjoint binds whose union is the one host's, the worker writing no
   status; ``python -m volcano_tpu_torch.parallel.multihost --mesh-hosts
   2`` at config 5's widths (a coordinator and one worker process sharing
   the card) ok and not degraded, the worker's slice the owned half; a
   worker whose coordinator is dead falls back to a full cycle;
22. e2e cfg6-mesh, cfg6b-mesh, cfg6r-mesh — each config-6 store under
   full_conf("cuda") with mesh "4" and solve_mode "batch": every contention
   pass on four node blocks (K15c preempt_rounds_sharded in cfg6 and cfg6b,
   K15b preempt_solve_sharded in cfg6b, K15a reclaim_solve_sharded in
   cfg6r; the one-block K8-K10 and the object kernels not launched).  Two
   cycles each (as phase 8), victims reaped, the cfg6 invariants and
   CFG6_PATTERN's first two cycles; the
   ordered evictions, pipelines and binds equal the same store's run under
   mesh "off" with solve_mode "batch" (K8-K10), run first; each cycle's
   wall, phases and the solves' CUDA-event ms;
23. K15a-c — on the inputs phase 22 captured from its first cycle, on
   local meshes of 1, 2, 4 and 8 blocks, each bit for bit equal, state
   included, to its plain version on the same blocks and to the one-block
   K8 / K9 / K10; a one-rank NCCL group running four blocks; K15b over the
   whole cfg6 storm (2,000 attempts, phase 9's inputs) on four blocks
   against the one-block K9;
24. e2e cfg5r — config 5 with 10% dynamic gangs and a best-effort pod on
   every fifth of them (100 gangs, build_cfg5_store's
   dynamic_best_effort_every), the other 1,900 best-effort pods on express
   gangs: the express gangs take K3, the other dynamic gangs K3 with K5,
   and the 100 "best-effort" residue gangs (2,100 tasks) the object
   sub-cycle after publish (2,000 through the residue engine in numpy, the
   100 best-effort pods through backfill).
   Every gang task and best-effort pod bound within three cycles, the
   placement invariants after each; the subcycle and residue_vec phases,
   the engine's task count and the sub-cycle's walls in the log;
25. e2e cfg6d — cfg6's store (10,000 full nodes, 100,000 residents)
   stormed by 10 urgent gangs x 20 (cut from 100, so that the object
   preempt over the storm stays within the run's time), gangs 0 and 5 with
   host port 30000 + g: the dynamic gangs send the preempt to the object
   sub-cycle, where a pending dynamic job keeps it on the host preemptor
   walk (K7 not launched, as in the reference).  Three cycles, victims
   reaped: no pod evicted twice, victims q0 residents below the storm's
   priority, pipelines covered, gangs all or nothing, no host port twice,
   the JAX package's per-cycle pattern; K7 launches and device ms;
26. e2e cfg5-restart — config 5 (two twin stores, 100,000 gang tasks and
   2,000 best-effort pods) under ``examples/scheduler-conf.yaml`` loaded by
   the port's ``load_conf`` (backend cuda, applyMode async, a
   mirrorCheckpoint under the checkout's ``build/``): a Scheduler's
   blocking prewarm (the store unchanged, each warmed variant launched
   once: K1, K3 at the live and the next task bucket, the storm solves
   K8-K10 empty, K7 in its three modes with K7g) and its first cycle,
   against a twin Scheduler not prewarmed (the same binds); the mirror
   checkpointed; a wave of 250 gangs x 20; a restarted Scheduler's restore
   timed against the twin's full list, their next cycles binding the same
   5,000 tasks; then two schedulers with leader election on one store: the
   leader's cycle queued behind a held applier entry, the standby binding
   nothing, the takeover after the lease expires binding a second wave as
   the twin's single scheduler does, the deposed leader dropping its queue
   and rebuilding its mirror;
27. e2e cfg10 — incremental scheduling (bench.py config10_delta) at config
   5's widths: 10,000 nodes and 100,000 resident RUNNING tasks as 5,000
   gangs x 20 (build_delta_store), full_conf("cuda") with delta on (sync
   publish, as the JAX bench runs it); an arm cycle and 8 unmeasured
   warm-up cycles, then a trickle of 200 cycles, each with one 2-pod gang
   of 100m / 64 MiB and, past 64 live trickle gangs, a departure wave of 8
   before it.  Micro and full cycle walls (p50 / p99), each mode's
   phases, fallback reasons, K1 / K2 launches a cycle and the (T, N, J, Q,
   C) of every solve; every gang bound within two cycles, at least 40
   micro cycles, full builds only for arm / job-remove, K1 and K2 once a
   micro cycle at one shape, no kernel library built, no new victim
   workspace; the trickle's second half rotating, cycle by cycle, through
   disarmed, vtprof, and vtprof with the tracer (after the warmup
   handshake): no steady-state-recompile anomaly in its armed micro
   cycles, vtprof's attribution of the micro cycles it profiled alone at
   least ATTRIBUTION_BAR, its dispatch counts equal to the armed cycles'
   LAUNCHES, the attribution and the micro walls of each mode;
   then K2 on the first micro cycle's inputs against its plain
   version; then the same trickle on the same store under delta off (the
   default), 40 cycles timed (cut from 200 for the run's time), each a
   full build: its walls beside the micro and delta-on full walls;
28. e2e cfg10/10 — the trickle at 1/10 scale on two stores, delta on with
   the snapshot-incremental oracle (a full build beside every micro build,
   equal bit for bit) and vtprof and the tracer armed, and delta off
   disarmed, the binds equal cycle by cycle, both walls; then one lockstep open-loop run (volcano_tpu_torch.loadgen) at
   250 gangs/s for 4 s of virtual time, which must sustain and bind every
   pod, with its wall time (lockstep waits for each cycle, so "sustained"
   is no rate);
29. e2e cfg7 — config 5 through the port's apiserver (bench.py config7):
   two StoreServer processes spawned (127.0.0.1, port 0), one with the
   WAL armed and a state file, each loaded in turn from one config-5
   build through RemoteStore.bulk in 4,000-op batches;
   then Scheduler(RemoteStore, full_conf("cuda")) under the applier on
   each in turn: prewarm, cycle 1 (K1, K3; its binds equal phase 3's pod
   for pod), the drain (drain_stats), on the WAL-off server 102,000 pods
   bound in its pod list (read off the wire) and two steady cycles, on the WAL
   server its /healthz WAL stats, a SIGKILL and a restart from the state
   directory (the recovery wall; every acknowledged bind there again);
   no server process may map torch or CUDA (/proc/<pid>/maps);
30. e2e cfg8 — config 8 (bench.py config8_open_loop): the open loop of 1-,
   2- and 4-pod gangs at 25 gangs/s for 8 s on the 200-node in-process
   store (full_conf("cuda"), async apply, a blocking prewarm and the warm
   burst first), the best of two runs by p99, each with every arrived pod
   bound by the end of settle, the rate sustained, K1 and K2 launched and
   no node over its caps; then the saturation search from 50 gangs/s,
   doubling up to 3 times on 4 s runs, against the 1,000 ms p99 band;
   first-seen to bind p50 / p99 / p999 and the saturation rate (runs after
   phase 28);
31. e2e cfg9b — bench.py config9_shard's sharded drain against one shard:
   the cfg9 store at 10,000 nodes and 100,000 tasks (16 namespaces, two
   queues) loaded in turn into a spawned 4-shard port apiserver and a
   one-shard one (WAL off), then on each Scheduler(RemoteStore,
   full_conf("cuda"), mesh "off") under the applier: prewarm, cycle 1
   (K1, K3), the drain (the 4-shard applier splits the segment by
   namespace and ships a sub-segment a shard concurrently: shardNN_s,
   split_s, ship_s, wire_s); both runs bind the same pods on the same
   nodes, every task bound and listed as bound, every shard the
   namespaces hash to carries rows, no server maps torch or CUDA; the
   drain ratio is a reading (runs after phase 29).

Every Scheduler's ``prewarm`` runs blocking (``background=False``), and
the launch counts of a phase start after it: the full prewarm launches
each variant the live cluster can reach.
Phases 3-6, 8, 10, 16, 21 (cfg5-2h), 22, 24 and 29 run their Scheduler with
``apply_mode="async"`` and the columnar publish, as the JAX package's
bench.py runs its configs: the applier is flushed after every cycle (a
timeout or a dead applier thread fails the phase) before the cell's checks
read the store, and a ``publish after cycle N`` line gives the cycle's
``publish`` / ``publish_build`` / ``publish_ship``, the flush wall, the
applier's ``drain_stats``, the ``err_log`` counts and the Events by
reason, which must hold one Scheduled Event a bind and one Evict Event (by
count) an eviction.  The object cells (12, 14, 18) and cfg6d keep the
synchronous path, now with its Events, and print the same line.
``--publish-split`` runs the build and phase_publish_split alone:
cfg5-batch and cfg6 under sync per-object (the parent's path) and async
columnar, four rounds in rotated order (cfg5-batch's
cycle 2 alternately with cycle 1's write-back in flight and after a
flush), then cfg9 under sync and async columnar; every run of a cell must
make the same decisions.

With ``--profile``, a torch.profiler pass runs after the build: the
batched solve's split (``--split``: K3 at config 5 and the 4-block solve at
cfg9's shape, each against its plain version, then K13's lockstep at 1, 2
and 4 hosts on the latter's inputs, bit for bit against it: K13's one
check at the full cfg9 shape), then one config-5 cycle and
one cfg9 cycle: device time by kernel and the device's idle share of the
cycles (also written to OUT.json when given).  ``--split`` runs the build
and that split alone.  ``--victim-split`` runs the build and the victim
solve's split alone (phase_victim_split: K7 at config 4 and on cfg6r-be's
first inputs, K12b at config 4 on 4 blocks; device ms and launches by
kernel, the wrapper's host us, the wall and the host gap, warm, cold and
the group build alone), so a parent commit is measured in the same call.
``--storm-split`` runs the build and the storm solves' split alone
(phase_storm_split: K8 on cfg6r and a 100-gang reclaim, K9 on cfg6b and
the whole cfg6 storm, K10 on cfg6 and three synthetic shapes, on one
block, four local blocks and a one-rank NCCL group; device ms by kernel,
digests, and for K8 / K9 the timed walk's stages and each cluster size).
``--residue`` runs the build and phases 24-25 alone; ``--restart-cells``
the build, phases 12, 14 and 18 (without the kernel phases 13 and 19),
cfg6b-mesh (the blocked storm solves' empty prewarm launches) and phase 26;
``--fast-cells`` the
build and cfg5-batch, cfg5d and cfg6 (no sub-cycle), so a parent given
this file is timed beside the change in one call.  These cells run under
the applier with the columnar publish, where a tree without the applier
publishes inline: pair two trees' ``--fast-cells`` only when both have it.
``--delta-cells`` runs the build and phases 27-28 and 30 alone, so a
parent given this file is measured in the same call (a tree without
``conf.delta`` fails there).  ``--store-cells`` runs the build, phase 3
(its binds the reference), phase 29 and phase 31 alone.
``--exact-split`` runs the build and the exact solve's split alone
(phase_exact_split: K2 on cfg5-exact's inputs, on the dynamic solves
cfg5d-exact (K5) and cfg5v-2000 (K5 and K6) capture, at 128 queues and on a
select-heavy and a place-heavy shape: device ms, placements, drops, us a
place step, launches and an output digest; on a tree with the cluster
kernel also each cluster size, equal to the default, and the timed split).

Phase 20 runs right after phase 17, on phase 16's captured inputs; the
cfg9 objects are then released before phases 18, 19, 21, 22 and 23.

Every mode prints the card's uncorrected volatile ECC error count at its
start and its end (``[ecc]`` lines, ecc_line).

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero with no result line
when CUDA is unavailable or any phase fails.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_OPS_PER_S = 67e12         # H100 SXM fp32, outside the tensor cores
D2H_BYTES_PER_S = 64e9         # PCIe Gen5 x16, one direction

# operations per (job, node) pair of the batch solve's score pass, and per
# node of the exact solve's place step, as the function needs them (R = 2):
# idle and releasing fits 8, class and pod-cap predicates 2, used_after 2,
# free 4, least 6, shares 2, balanced 3, weighted sum 3, then (batch only)
# the jitter hash and its fused add 8, the mask 1, and top-K/argmax 1
BATCH_PAIR_OPS = 40
EXACT_NODE_OPS = 31
# per valid job of an exact select step: the active mask and the lex narrowing
EXACT_JOB_OPS = 10
# the cells' bind deadline: every gang task and best-effort pod bound within
# this many cycles (config 5 binds all in its first; the dynamic cells may
# leave gangs whose rounds were cut by a drop for the next cycle)
MAX_CYCLES = 2
MAX_CYCLES_DYNAMIC = 3
# operations per node of a place step with volumes (the mask bit's shift and
# test) and per claim of the task and node (the assumed / capacity test)
VOLSEL_NODE_OPS = 2
VOLSEL_CLAIM_OPS = 2

# the reclaim and preempt walks' main-path kernels (K8 / K9 on a cluster,
# their untimed instantiations; K15a / K15b's block core) by their ptxas
# entry names, which must build without spills: at 32 registers a thread
# K8 / K9 spilled in the node walk and ran 12-21% slower (PERF.md §6)
WALK_KERNEL_NAMES = ("vtt_reclaim_kernelILb0E", "vtt_preempt_kernelILb0E", "vtt_wb_core")

# config 5 (bench.py: N_NODES, N_TASKS, N_JOBS, N_QUEUES, n_best_effort)
CFG5 = dict(nodes=10_000, jobs=5_000, tasks_per_job=20, queues=2, best_effort=2_000)


def log(*a):
    print(*a, flush=True)


def _counters():
    from volcano_tpu_torch.parallel import multihost as MH
    from volcano_tpu_torch.parallel import sharded as S
    from volcano_tpu_torch.scheduler import kernels as K
    from volcano_tpu_torch.scheduler import victim_kernels as VK

    return K, VK, S, MH


def reset_launches():
    for mod in _counters():
        mod.reset_launches()


def read_launches():
    """Every kernel's launches since the last reset_launches()."""
    return {k: v for mod in _counters() for k, v in mod.LAUNCHES.items()}


#: the applier's drain deadline after a cycle (config 5 and 6 drain in
#: seconds); cfg9's 1,000,000 binds and as many Events get their own
FLUSH_TIMEOUT_S = 120.0
CFG9_FLUSH_TIMEOUT_S = 900.0


def async_conf(conf):
    """A copy of ``conf`` under the applier thread, which ships the columnar
    publish (the JAX package's bench.py runs its configs so)."""
    return dataclasses.replace(conf, apply_mode="async")


def flush_applier(label, sched, timeout=FLUSH_TIMEOUT_S):
    """Wait for the applier to land every decision; fails the phase on a
    timeout (and ``flush`` raises on a dead applier thread).  Returns the
    wall, 0 without an applier."""
    applier = sched.cache.applier
    if applier is None:
        return 0.0
    t0 = time.perf_counter()
    if not applier.flush(timeout):
        raise AssertionError(f"{label}: the applier did not drain in {timeout:.0f} s "
                             f"({applier.pending} entries left)")
    return time.perf_counter() - t0


def publish_report(label, sched, flush_s, cycle=1):
    """The last cycle's publish split (``publish``, ``publish_build``,
    ``publish_ship``), the flush wall, the applier's ``drain_stats`` and the
    ``err_log`` counts by op, after a flush.  Fails unless the store holds
    one Scheduled Event a logged bind and one Evict Event (by count) a
    logged eviction, less the writes ``err_log`` records as failed."""
    cache = sched.cache
    ph = sched.fast_cycle.phases if sched.fast_cycle is not None else {}
    reasons = {}
    for ev in cache.store.list("Event"):
        reasons[ev.reason] = reasons.get(ev.reason, 0) + ev.count
    errs = {}
    for op, _, _ in cache.err_log:
        errs[op] = errs.get(op, 0) + 1
    row = {k: round(ph[k], 4) for k in ("publish", "publish_build", "publish_ship") if k in ph}
    row.update(flush_s=round(flush_s, 4), events=reasons, err_log=errs,
               binds=len(cache.bind_log), evictions=len(cache.evict_log))
    if cache.applier is not None:
        row["drain_stats"] = {k: round(v, 4) for k, v in cache.applier.drain_stats.items()}
    log(f"[{label}] publish after cycle {cycle}: {json.dumps(row)}")
    want_s = len(cache.bind_log) - errs.get("bind", 0)
    want_e = len(cache.evict_log) - errs.get("evict", 0)
    if reasons.get("Scheduled", 0) != want_s or reasons.get("Evict", 0) != want_e:
        raise AssertionError(f"{label}: {reasons.get('Scheduled', 0)} Scheduled and "
                             f"{reasons.get('Evict', 0)} Evict Events for {want_s} binds and "
                             f"{want_e} evictions")
    return row


def cuda_ms(fn, reps):
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*arrays):
    return int(sum(a.numel() * a.element_size() for a in arrays))


def ecc_line(when):
    """Log the card's uncorrected volatile ECC error count (nvidia-smi): at
    a run's start and end, so that a count rising within a run points at
    the machine and not the kernels (ROADMAP section 3)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=ecc.errors.uncorrected.volatile.total",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ).stdout.strip()
    log(f"[ecc] {when}: uncorrected volatile ECC errors {out}")


def phase_build():
    from volcano_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, check=True,
    ).stdout.strip()
    t0 = time.perf_counter()
    _build.load()
    log(f"[build] nvcc build+load {time.perf_counter() - t0:.2f} s")
    entry = ""
    for line in _build.ptxas_report():
        log(f"[ptxas] {line}")
        if "Compiling entry" in line:
            entry = line
        elif (" spill stores" in line and any(k in entry for k in WALK_KERNEL_NAMES)
              and " 0 bytes spill stores" not in line):
            raise AssertionError(f"ptxas: a walk kernel spills: {entry}: {line.strip()}")
    return smi


def _water_fill_rounds(a):
    """Round count of the water fill on these inputs (for its op count)."""
    w, req, rem = a["queue_weight"], a["queue_request"], a["total"].copy()
    eps, part = a["eps"], a["queue_participates"]
    des = np.zeros_like(req)
    met = np.zeros(w.shape[0], bool)
    for rounds in range(1, 4097):
        live = part & ~met
        tw = np.float32(w[live].sum())
        frac = np.where(tw > 0, w / max(tw, np.float32(1e-30)), 0).astype(np.float32)
        nd = des + np.where(live[:, None], rem[None, :] * frac[:, None], 0)
        exc = ~(nd < req + eps).all(1) & live
        cap = np.where(exc[:, None], np.minimum(nd, req), nd)
        met |= exc
        rem = rem - (cap - des).sum(0)
        des = cap
        if not (tw > 0 and not (rem < eps).all()):
            break
    return rounds


def _portsel_task_ops(portsel):
    """K5's operations per task, counted from the words the task carries:
    (per node of a score or place step, per proposal of a round, per
    placement).  A node test is an AND and a test per nonzero port word and
    per nonzero required or anti word, plus, for a task with selector bits,
    one count added per set required or anti bit and the fused add of the
    interpod term.  A proposal tests and folds its nonzero port words into
    the node's running ports, tests its nonzero anti words against the
    running labels and folds in its nonzero label words.  A placement ORs
    its nonzero port words into the node and adds one count per label bit."""
    port, aff, anti, self_ = (portsel[i].cpu().numpy() for i in (1, 3, 4, 5))

    def words(w):
        return (w != 0).sum(axis=1)

    def bits(w):
        octets = np.ascontiguousarray(w).view(np.uint8)
        return np.unpackbits(octets, axis=1).sum(axis=1, dtype=np.int64)

    n_sel_bits = bits(aff) + bits(anti)
    node = 2 * (words(port) + words(aff) + words(anti)) + n_sel_bits + (n_sel_bits > 0)
    proposal = 2 * words(port) + words(anti) + words(self_)
    place = words(port) + bits(self_)
    return node, proposal, place


def _job_min(per_task, a):
    """Per job, the least of per_task over its valid tasks (0 for a job
    with none)."""
    job = a["task_job"].cpu().numpy()
    valid = a["task_valid"].cpu().numpy().astype(bool)
    out = np.full(a["job_queue"].shape[0], np.iinfo(np.int64).max, np.int64)
    np.minimum.at(out, job[valid], per_task[valid].astype(np.int64))
    return np.where(out == np.iinfo(np.int64).max, 0, out)


def _batch_solve_ops(out, a, M, P, n_sort_keys, ps_ops=None):
    """Operations the batched solve's data needs, round by round: scoring
    the heads of the selected active jobs over the valid nodes, ordering
    the active jobs (a log2 a comparisons of n_sort_keys keys) and ordering
    their proposals (f log2 f comparisons of a node and a rank).  The
    active count of round r is the number of jobs whose surviving
    placements reach round r or later, a lower bound of the true count.
    ``ps_ops`` (from _portsel_task_ops) adds K5: each round charges the
    ``sel`` active jobs whose least-costly tasks cost least, so that the
    count stays a lower bound whichever jobs were selected, and each
    surviving placement its fold."""
    F = M * P
    seq = out.task_seq.cpu().numpy()
    job = a["task_job"].cpu().numpy()
    placed = seq >= 0
    last = np.full(a["job_queue"].shape[0], -1, np.int64)
    np.maximum.at(last, job[placed], seq[placed] // F)
    n_valid = int(a["node_valid"].sum())
    ops = 0.0
    if ps_ops is not None:
        job_node, job_prop = _job_min(ps_ops[0], a), _job_min(ps_ops[1], a)
        ops += float(ps_ops[2][placed].sum())
    for r in range(int(out.steps)):
        act_jobs = last >= r
        act = int(act_jobs.sum())
        sel = min(M, act)
        f = sel * P
        ops += sel * n_valid * BATCH_PAIR_OPS
        ops += act * np.log2(max(act, 1)) * n_sort_keys + f * np.log2(max(f, 1)) * 2
        if ps_ops is not None:
            ops += float(np.sort(job_node[act_jobs])[:sel].sum()) * n_valid
            ops += float(np.sort(job_prop[act_jobs])[:sel].sum()) * P
    return ops


def _exact_solve_ops(out, a, ps_ops=None):
    """Operations the exact solve's data needs: one place step over the
    valid nodes per placement and per drop, and one select step over the
    valid jobs for each job that placed and each drop (a lower bound: a
    job ready before its last task is selected again for each one).
    ``ps_ops`` (from _portsel_task_ops) adds K5: each placed task's node
    tests over the valid nodes and its fold, and for each dropped job the
    node tests of its least-costly task."""
    n_valid = int(a["node_valid"].sum())
    j_valid = int((a["job_queue"] >= 0).sum())
    steps, drops = int(out.steps), int(out.dropped.sum())
    jobs_placed = int(np.unique(a["task_job"][out.task_kind > 0].cpu().numpy()).size)
    ops = ((steps + drops) * n_valid * EXACT_NODE_OPS
           + (jobs_placed + drops) * j_valid * EXACT_JOB_OPS)
    if ps_ops is not None:
        placed = out.task_kind.cpu().numpy() > 0
        dropped = out.dropped.cpu().numpy().astype(bool)
        ops += (float(ps_ops[0][placed].sum()) * n_valid + float(ps_ops[2][placed].sum())
                + float(_job_min(ps_ops[0], a)[dropped].sum()) * n_valid)
    return ops


def k1_launch_floor(dev):
    """The least time K1's wrapper contract can take, timed as K1 is (CUDA
    events, 50 calls): one launch of a one-CTA kernel (PyTorch's fill of a
    one-element int32 tensor) and the blocking 4-byte read of its result
    (the parent's contract); the same launch alone, no read (this
    wrapper's); and the launch and read with the three torch.empty calls of
    the parent's wrapper.  Returns (with read, without, with allocations)."""
    import torch

    x = torch.zeros(1, dtype=torch.int32, device=dev)

    def launch():
        x.fill_(1)

    def launch_read():
        launch()
        return int(x[0])

    def alloc_launch_read():
        for shape in ((3, 2), (3, 2), (6,)):
            torch.empty(shape, dtype=torch.float32, device=dev)
        return launch_read()

    launch_read()
    return cuda_ms(launch_read, 50), cuda_ms(launch, 50), cuda_ms(alloc_launch_read, 50)


def k1_split(dev, reps=50):
    """K1 (water_fill) at each of simargs.WATER_FILL_CASES (the config-5
    cell's shape, 128 queues, 2,048 cells, 1,024 queues taking 21 rounds),
    each equal bit for bit to its plain version on the same card: CUDA-event
    ms a call over ``reps`` calls with one round-cap check after them
    (``ms``: a consumer checks where it waits anyway) and with a check after
    each call (``checked_ms``: the launch and the wait for its round word),
    the device ms and the wrapper's host us of a call (victim_split), the
    plain version's ms, the rounds and the bound; then the launch floors
    (k1_launch_floor).  On a tree whose wrapper reads its round word itself
    (no ``water_fill_check``) both times hold that read."""
    import torch

    from volcano_tpu_torch.scheduler import kernels as K
    from volcano_tpu_torch.scheduler.simargs import WATER_FILL_CASES, build_water_fill_args

    check = getattr(K, "water_fill_check", lambda: None)
    res = {}
    for case in WATER_FILL_CASES:
        a_np = build_water_fill_args(case)
        wf = tuple(torch.from_numpy(np.ascontiguousarray(a_np[k])).to(dev)
                   for k in ("queue_weight", "queue_request", "total", "eps",
                             "queue_participates"))
        des_k = K.water_fill(*wf)
        check()
        des_p = K.water_fill_plain(*wf)
        torch.cuda.synchronize()
        err = float((des_k - des_p).abs().max())
        if not torch.equal(des_k, des_p):
            raise AssertionError(f"water_fill {case}: kernel != plain (max abs err {err})")

        def queued():
            for _ in range(reps):
                K.water_fill(*wf)
            check()

        def checked():
            K.water_fill(*wf)
            check()

        queued()
        ms = cuda_ms(queued, 1) / reps
        checked_ms = cuda_ms(checked, reps)
        split = victim_split(f"K1 {case}", lambda: K.water_fill(*wf), reps)
        check()
        plain_ms = cuda_ms(lambda: K.water_fill_plain(*wf), 3)
        Q, R = wf[1].shape
        rounds = _water_fill_rounds(a_np)
        b, kind = bound_ms(nbytes(*wf) + Q * R * 4, rounds * Q * R * 12)
        res[case] = dict(Q=Q, R=R, rounds=rounds, ms=ms, checked_ms=checked_ms,
                         device_ms=split["device_ms"], host_us=split["host_us"],
                         plain_ms=plain_ms, bound_ms=b, bound_by=kind, max_abs_err=err)
        log(f"[kernels] water_fill {case} (Q {Q}, R {R}, {rounds} rounds) ok: {ms:.4f} ms a "
            f"call over {reps} ({checked_ms:.4f} ms with the round word read each call; "
            f"device {split['device_ms']:.4f} ms, wrapper host {split['host_us']:.1f} us; "
            f"plain {plain_ms:.3f} ms, bound {b:.2e} ms by {kind})")
    floor_ms, floor_nr_ms, floor_alloc_ms = k1_launch_floor(dev)
    res["launch_floor"] = dict(read_ms=floor_ms, no_read_ms=floor_nr_ms,
                               alloc_read_ms=floor_alloc_ms)
    log(f"[kernels] water_fill's launch floor (a one-CTA launch, 50 calls): {floor_nr_ms:.4f} "
        f"ms; with a 4-byte blocking read {floor_ms:.4f} ms; with the read and three "
        f"allocations {floor_alloc_ms:.4f} ms; K1 at config 5 at "
        f"{res['config5']['ms'] / floor_nr_ms:.2f}x the floor without the read")
    return res


def phase_kernels():
    import torch

    from volcano_tpu_torch.scheduler import kernels as K
    from volcano_tpu_torch.scheduler.simargs import build_sim_args

    dev = torch.device("cuda")
    rows = []

    def to_dev(a):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in a.items()}

    # ---- K1 water_fill + K3 batch + K4 packed at config-5 shapes
    a_np = build_sim_args(10_000, 100_000, 5_000)
    a = to_dev(a_np)
    wf = (a["queue_weight"], a["queue_request"], a["total"], a["eps"], a["queue_participates"])
    K.reset_launches()
    des_k = K.water_fill(*wf)
    k1 = k1_split(dev)
    c5 = k1["config5"]
    rows.append(dict(name="water_fill", route="cuda",
                     source="volcano_tpu_torch/csrc/water_fill.cu",
                     replaces="volcano_tpu/scheduler/kernels.py:73",
                     max_abs_err=c5["max_abs_err"], ms=c5["ms"], plain_ms=c5["plain_ms"],
                     bound_ms=c5["bound_ms"], bound_by=c5["bound_by"], library_ms=None,
                     checked_ms=c5["checked_ms"],
                     launch_floor_ms=k1["launch_floor"]["no_read_ms"],
                     launch_floor_read_ms=k1["launch_floor"]["read_ms"],
                     shapes={k: v for k, v in k1.items() if k != "launch_floor"}))

    solve_in = {k: (des_k if k == "queue_deserved" else a[k]) for k in K._SOLVE_ARGS}
    opts = dict(job_key_order=("priority", "gang", "drf"), use_gang_ready=True,
                use_proportion=True)
    args = [solve_in[k] for k in K._SOLVE_ARGS] + [1.0, 1.0]

    t0 = time.perf_counter()
    out_k = K.allocate_solve_batch(*args, **opts)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_p = K.allocate_solve_batch_plain(**solve_in, w_least=1.0, w_balanced=1.0, **opts)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    err = _compare("allocate_solve_batch", out_k, out_p)
    n_rounds = int(out_k.steps)
    placed = int((out_k.task_kind > 0).sum())
    log(f"[kernels] allocate_solve_batch ok: rounds {n_rounds}, placed {placed}, "
        f"first call {t_k:.3f} s, plain {t_p:.3f} s")
    ms = cuda_ms(lambda: K.allocate_solve_batch(*args, **opts), 3)
    plain_ms = cuda_ms(lambda: K.allocate_solve_batch_plain(
        **solve_in, w_least=1.0, w_balanced=1.0, **opts), 1)
    J = a["job_queue"].shape[0]
    M, P = min(512, J), 16
    io = nbytes(*solve_in.values()) + nbytes(*out_k[:10])
    n_sort_keys = len(opts["job_key_order"]) + 2 + int(opts["use_proportion"])
    b, kind = bound_ms(io, _batch_solve_ops(out_k, a, M, P, n_sort_keys))
    split = batch_split("K3 at config 5", lambda: K.allocate_solve_batch(*args, **opts))
    rows.append(dict(name="allocate_solve_batch", route="cuda",
                     source="volcano_tpu_torch/csrc/allocate_batch.cu",
                     replaces="volcano_tpu/scheduler/kernels.py:491",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                     bound_by=kind, library_ms=None, rounds=n_rounds,
                     ms_per_round=ms / max(n_rounds, 1), split=split))
    log(f"[kernels] allocate_solve_batch: {ms:.3f} ms (plain {plain_ms:.3f} ms, "
        f"bound {b:.4f} ms by {kind}), {ms / max(n_rounds, 1):.4f} ms a round")

    # K4 is no launch of its own: the solves write their decisions straight
    # into one int32 [3T + J] buffer, which the cycle fetches once
    packed = K.pack_outputs(out_k)
    if packed.data_ptr() != out_k.task_node.data_ptr():
        raise AssertionError("packed layout: the solve's decisions are not one buffer")
    if not torch.equal(packed, K.pack_outputs(out_p)):
        raise AssertionError("packed layout: kernel buffer != packed plain outputs")
    fetch_ms = cuda_ms(lambda: packed.cpu(), 20)
    cat_fetch_ms = cuda_ms(lambda: K.pack_outputs(out_p).cpu(), 20)
    log(f"[fetch] packed decisions ok: {nbytes(packed)} bytes to the host in "
        f"{fetch_ms:.4f} ms (the plain outputs' cat + fetch {cat_fetch_ms:.4f} ms; "
        f"bound {nbytes(packed) / D2H_BYTES_PER_S * 1e3:.4f} ms at PCIe Gen5 x16)")

    # ---- K2 exact at the exact path's shapes
    e_np = build_sim_args(10_000, 4_000, 200)
    e = to_dev(e_np)
    des_e = K.water_fill(e["queue_weight"], e["queue_request"], e["total"], e["eps"],
                         e["queue_participates"])
    solve_e = {k: (des_e if k == "queue_deserved" else e[k]) for k in K._SOLVE_ARGS}
    args_e = [solve_e[k] for k in K._SOLVE_ARGS] + [1.0, 1.0]
    out_k = K.allocate_solve(*args_e, **opts)
    t0 = time.perf_counter()
    out_p = K.allocate_solve_plain(**solve_e, w_least=1.0, w_balanced=1.0, **opts)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    err = _compare("allocate_solve", out_k, out_p)
    steps = int(out_k.steps)
    ms = cuda_ms(lambda: K.allocate_solve(*args_e, **opts), 3)
    io = nbytes(*solve_e.values()) + nbytes(*out_k[:10])
    b, kind = bound_ms(io, _exact_solve_ops(out_k, e))
    timed = _exact_timed(_exact_launcher(args_e, opts), ms, _solve_digest(out_k),
                         "allocate_solve")
    rows.append(dict(name="allocate_solve", route="cuda",
                     source="volcano_tpu_torch/csrc/allocate_solve.cu",
                     replaces="volcano_tpu/scheduler/kernels.py:185",
                     max_abs_err=err, ms=ms, plain_ms=t_p * 1e3, bound_ms=b,
                     bound_by=kind, library_ms=None, **timed))
    log(f"[kernels] allocate_solve ok: steps {steps}, {ms:.3f} ms (plain {t_p * 1e3:.1f} ms, "
        f"bound {b:.4f} ms by {kind}), cluster {timed['cluster']}, "
        f"{timed['us_per_step']:.3f} us a step, split {json.dumps(timed['split'])}")
    return {r["name"]: r for r in rows}


def phase_kernel_sweep():
    """Each solve kernel against its plain version on the card at small
    shapes over seeds and policies: predicate classes, pod caps, releasing
    capacity (pipelined placements), gang rollbacks, small batch chunks."""
    import torch

    from volcano_tpu_torch import interop
    from volcano_tpu_torch.scheduler import kernels as K
    from volcano_tpu_torch.scheduler.simargs import (
        PORTSEL_KEYS, add_releasing, build_portsel_args, build_sim_args, build_volsel_args,
    )

    dev = torch.device("cuda")
    policies = [
        dict(job_key_order=("priority", "gang", "drf"), use_gang_ready=True, use_proportion=True),
        dict(job_key_order=("drf", "gang", "priority"), use_gang_ready=False, use_proportion=False),
        dict(job_key_order=("gang", "priority", "drf"), use_gang_ready=True, use_proportion=False),
    ]
    n = n_ps = n_vs = pipelined = 0
    vol_seen = set()
    for seed in range(4):
        for pol in policies:
            a = build_sim_args(12 + seed, 64, 16, n_queues=3, seed=seed,
                               n_classes=1 + 2 * (seed % 2), class_fill=0.6 + 0.1 * seed)
            if seed:
                add_releasing(a, seed)
            a["node_max_tasks"][:] = 3 + seed
            t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in a.items()}
            des = K.water_fill(t["queue_weight"], t["queue_request"], t["total"], t["eps"],
                               t["queue_participates"])
            args = {k: (des if k == "queue_deserved" else t[k]) for k in K._SOLVE_ARGS}
            p = build_portsel_args(12 + seed, 64, seed=seed, n_jobs=16,
                                   w_podaff=(1.0, 0.1)[seed % 2])
            ps = tuple(p[k] if k == "w_podaff" else torch.from_numpy(p[k]).to(dev)
                       for k in PORTSEL_KEYS)
            vpay = build_volsel_args(12 + seed, 64, seed=seed, n_jobs=16)
            vs = interop.volsel_from_payload(vpay, dev)
            for batch, chunks in ((False, {}), (True, {}), (True, dict(m_chunk=4, p_chunk=3))):
                wrap = K.allocate_solve_batch if batch else K.allocate_solve
                plain = K.allocate_solve_batch_plain if batch else K.allocate_solve_plain
                exts = [{}, dict(portsel=ps)]
                if not batch:  # volumes take the exact solve only
                    exts += [dict(volsel=vs), dict(portsel=ps, volsel=vs)]
                for ext in exts:
                    out_k = wrap(*args.values(), 1.0, 1.0, **pol, **chunks, **ext)
                    out_p = plain(**args, w_least=1.0, w_balanced=1.0, **pol, **chunks, **ext)
                    _compare(f"sweep seed={seed} batch={batch} {chunks} {pol} "
                             f"portsel={'portsel' in ext} volsel={'volsel' in ext}", out_k, out_p)
                    pipelined += int((out_p.task_kind == 2).sum())
                    n += 1
                    n_ps += "portsel" in ext
                    if "volsel" in ext:
                        n_vs += 1
                        vol_seen |= _volsel_features(vpay, out_p)
    if not pipelined:
        raise AssertionError("kernel sweep: no pipelined placement exercised")
    want = {"global", "pinned", "two-claims", "bound", "contended", "pipelined-claim"}
    if not want <= vol_seen:
        raise AssertionError(f"kernel sweep: volsel cases missed {sorted(want - vol_seen)}")
    log(f"[kernels] sweep ok: {n} small solves ({n_ps} with portsel, {n_vs} with volsel) equal "
        f"to their plain versions ({pipelined} pipelined placements; volsel cases "
        f"{sorted(vol_seen)})")


def _volsel_features(vpay, out):
    """Which volume cases a solve exercised: a global and a pinned pool
    decremented, a pinned count taken below zero by one task's two claims, a
    placement inside a bound node set, a claim-carrying job dropped with
    its group's PVs gone, and a claim-carrying task placed by releasing fit
    (which assumes nothing)."""
    from volcano_tpu_torch.scheduler.simargs import VOLSEL_KINDS

    cap0, cap = vpay["group_cap"], out.vol_cap.cpu().numpy()
    claims = vpay["task_claims"]
    kind = out.task_kind.cpu().numpy()
    seen = set()
    glob = vpay["group_global"]
    if ((cap < cap0) & glob[:, None]).any():
        seen.add("global")
    if ((cap < cap0) & ~glob[:, None]).any():
        seen.add("pinned")
    if (cap < 0).any():
        seen.add("two-claims")
    job = np.arange(kind.size) // 4  # build_volsel_args(.., 64, n_jobs=16): 4 tasks a job
    kinds = np.array([VOLSEL_KINDS[j % len(VOLSEL_KINDS)] for j in job])
    if ((kind > 0) & np.isin(kinds, ("bound", "bound-pinned"))).any():
        seen.add("bound")
    if ((kind == 2) & claims.any(axis=1)).any():
        seen.add("pipelined-claim")
    dropped = out.dropped.cpu().numpy().astype(bool)
    claim_jobs = np.unique(job[claims.any(axis=1)])
    if dropped[claim_jobs[claim_jobs < dropped.size]].any():
        seen.add("contended")
    return seen


def _compare(name, out_k, out_p):
    """Decision outputs must be equal; float state equal too (exact sums)."""
    import torch

    err = 0.0
    for field in out_k._fields:
        x, y = getattr(out_k, field), getattr(out_p, field)
        if field in ("task_node", "task_kind", "task_seq", "ready", "dropped", "steps",
                     "claim_node", "vol_cap"):
            if not torch.equal(x.to(y.dtype), y):
                diff = (x.to(y.dtype) != y).nonzero()[:5].flatten().tolist()
                raise AssertionError(f"{name}: {field} differs at {diff}")
        else:
            err = max(err, float((x - y).abs().max()))
            if not torch.allclose(x, y, rtol=1e-6, atol=0.0):
                raise AssertionError(f"{name}: {field} differs (max abs err {err})")
    return err


def _no_gc(build):
    """``build`` (a store builder) with the cyclic collector paused, then
    one full collection: the builder makes 10^5-10^6 objects and no
    garbage, and each collection its allocations trigger walks every live
    object again.  The closing collection leaves the store in the oldest
    generation, as the collections during an unpaused build do; without
    it the next prewarm or cycle pays the young objects' passes.  Set-up
    only: no measured wall runs under it."""

    @functools.wraps(build)
    def wrapped(*args, **kwargs):
        was = gc.isenabled()
        gc.disable()
        try:
            return build(*args, **kwargs)
        finally:
            if was:
                gc.enable()
                gc.collect()

    return wrapped


@_no_gc
def build_cfg5_store(n_jobs=CFG5["jobs"], n_best_effort=CFG5["best_effort"], dynamic_frac=0.0,
                     volume_tasks=0, dynamic_best_effort_every=0):
    """bench.py _build_e2e_store with the port's objects: 10k nodes, n_jobs
    gangs x 20 tasks in 2 weighted queues (plus "default"), PodGroups
    Pending (enqueue admits them).  The first ``dynamic_frac`` x 5,000
    gangs are dynamic: even ones give every task host port 20000 + j % 64,
    odd ones label each task grp=g{j % 48} with anti-affinity to that
    label.  One best-effort pod goes on each of the next n_best_effort
    gangs (never on a dynamic one); with ``dynamic_best_effort_every`` = e,
    every e-th dynamic gang (j % e == 0) gets one of them instead (which
    makes it "best-effort" residue) and the rest go on the next express
    gangs.  ``volume_tasks`` / 20 volume gangs
    vol{v} of 100m / 64Mi tasks (bench.py:329-365): even ones mount claim
    vc{v}, Bound to a 50Gi PV of class net pinned to node
    n{(v * 97) % 10000}; odd ones share the pending 5Gi claim vc{v} of the
    static class volb, whose pool gets one 50Gi PV pinned the same way."""
    from volcano_tpu_torch.api import (
        POD_GROUP_KEY, Affinity, Metadata, Node, PersistentVolume, PersistentVolumeClaim,
        Pod, PodGroup, PodGroupPhase, PodSpec, Queue, Resource, StorageClass,
    )
    from volcano_tpu_torch.store import Store

    rng = np.random.default_rng(0)
    n_nodes, tpj, n_q = CFG5["nodes"], CFG5["tasks_per_job"], CFG5["queues"]
    node_cpu = rng.choice([8000, 16000, 32000], n_nodes)
    node_mem = rng.choice([16, 32, 64], n_nodes) * (1 << 30)
    cpus = rng.choice([250, 500, 1000, 2000], CFG5["jobs"] * tpj)
    mems = rng.choice([256, 512, 1024, 2048], CFG5["jobs"] * tpj) * (1 << 20)
    n_dynamic = int(CFG5["jobs"] * dynamic_frac)
    dyn_be = (range(0, n_dynamic, dynamic_best_effort_every) if dynamic_best_effort_every
              else range(0))
    n_express_be = n_best_effort - len(dyn_be)
    store = Store()
    for q in range(n_q):
        store.create("Queue", Queue(meta=Metadata(name=f"q{q}", namespace=""), weight=n_q - q))
    store.create("Queue", Queue(meta=Metadata(name="default", namespace=""), weight=1))
    for i in range(n_nodes):
        store.create("Node", Node(meta=Metadata(name=f"n{i:05d}", namespace=""),
                                  allocatable=Resource(float(node_cpu[i]), float(node_mem[i]),
                                                       max_task_num=110)))
    k = 0
    for j in range(n_jobs):
        pg = PodGroup(meta=Metadata(name=f"pg{j:05d}", namespace="default"),
                      min_member=tpj, queue=f"q{j % n_q}")
        pg.status.phase = PodGroupPhase.PENDING
        store.create("PodGroup", pg)
        ann = {POD_GROUP_KEY: f"pg{j:05d}"}
        dyn_kind = None if j >= n_dynamic else ("ports" if j % 2 == 0 else "anti")
        for t in range(tpj):
            spec = PodSpec(resources=Resource(float(cpus[k]), float(mems[k])))
            labels = {}
            if dyn_kind == "ports":
                spec.host_ports = [20000 + j % 64]
            elif dyn_kind == "anti":
                labels = {"grp": f"g{j % 48}"}
                spec.affinity = Affinity(pod_anti_affinity=[{"grp": f"g{j % 48}"}])
            store.create("Pod", Pod(
                meta=Metadata(name=f"p{j:05d}-{t}", namespace="default", annotations=dict(ann),
                              labels=labels),
                spec=spec))
            k += 1
        if (j in dyn_be) or (dyn_kind is None and j < n_dynamic + n_express_be):
            store.create("Pod", Pod(
                meta=Metadata(name=f"be{j:05d}", namespace="default", annotations=dict(ann)),
                spec=PodSpec(resources=Resource())))
    n_vol = volume_tasks // tpj
    if n_vol:
        store.create("StorageClass", StorageClass(meta=Metadata(name="volb", namespace=""),
                                                  provisioner=""))
    for v in range(n_vol):
        pin = {"kubernetes.io/hostname": f"n{(v * 97) % n_nodes:05d}"}
        bound = v % 2 == 0
        store.create("PV", PersistentVolume(
            meta=Metadata(name=f"vpv{v:04d}", namespace=""), capacity="50Gi",
            storage_class="net" if bound else "volb", node_affinity=pin,
            claim_ref=f"default/vc{v:04d}" if bound else ""))
        store.create("PVC", PersistentVolumeClaim(
            meta=Metadata(name=f"vc{v:04d}", namespace="default"), size="5Gi",
            storage_class="net" if bound else "volb",
            volume_name=f"vpv{v:04d}" if bound else "", phase="Bound" if bound else "Pending"))
        pg = PodGroup(meta=Metadata(name=f"vol{v:04d}", namespace="default"),
                      min_member=tpj, queue=f"q{v % n_q}")
        pg.status.phase = PodGroupPhase.PENDING
        store.create("PodGroup", pg)
        ann = {POD_GROUP_KEY: f"vol{v:04d}"}
        for t in range(tpj):
            store.create("Pod", Pod(
                meta=Metadata(name=f"v{v:04d}-{t}", namespace="default", annotations=dict(ann)),
                spec=PodSpec(resources=Resource(100.0, 64.0 * (1 << 20))),
                volumes=[f"vc{v:04d}"]))
    return store


def check_volumes(label, store, sched, n_vol):
    """The volume invariants after a cycle: every pod of a bound-claim gang
    on its PV's node; every bound static gang on one node, whose volb PV now
    holds the gang's claim, the claim Bound to it; no PV claimed twice; no
    pod bound whose volume bind failed.  Returns (volume gangs bound, the
    unbound ones that could still fit whole on a node their claim allows:
    the pin node of a bound claim, the node of an Available volb PV)."""
    pods = {}
    free = {}
    for n in store.list("Node"):
        a = n.allocatable
        free[n.meta.name] = np.array([a.milli_cpu, a.memory, a.max_task_num], float)
    for p in store.list("Pod"):
        if p.meta.name.startswith("v"):
            pods.setdefault(p.meta.name.split("-")[0], []).append(p)
        if p.node_name:
            free[p.node_name] -= (p.spec.resources.milli_cpu, p.spec.resources.memory, 1)
    pvs = {pv.meta.name: pv for pv in store.list("PV")}
    open_nodes = [pv.node_affinity["kubernetes.io/hostname"] for pv in pvs.values()
                  if pv.storage_class == "volb" and not pv.claim_ref]
    refs = [pv.claim_ref for pv in pvs.values() if pv.claim_ref]
    if len(refs) != len(set(refs)):
        raise AssertionError(f"{label}: a claim holds two PVs")
    bound, placeable, why = 0, [], []
    for v in range(n_vol):
        gang = pods[f"v{v:04d}"]
        nodes = {p.node_name for p in gang}
        if nodes == {""}:
            need = sum(np.array([p.spec.resources.milli_cpu, p.spec.resources.memory, 1.0])
                       for p in gang)
            cand = ([pvs[f"vpv{v:04d}"].node_affinity["kubernetes.io/hostname"]]
                    if v % 2 == 0 else open_nodes)
            if any((free[n] >= need).all() for n in cand):
                placeable.append(v)
            short = np.sum([free[n] < need for n in cand], axis=0) if cand else np.zeros(3)
            why.append(f"v{v:04d} ({'bound claim' if v % 2 == 0 else 'static'}: of "
                       f"{len(cand)} allowed nodes, {short[0]} short of cpu, {short[1]} of "
                       f"memory, {short[2]} of pod slots)")
            continue
        if len(nodes) != 1 or "" in nodes:
            raise AssertionError(f"{label}: volume gang {v} bound partly or on two nodes: {nodes}")
        node = nodes.pop()
        pvc = store.get("PVC", f"default/vc{v:04d}")
        if v % 2 == 0:
            want = pvs[f"vpv{v:04d}"].node_affinity["kubernetes.io/hostname"]
            if node != want:
                raise AssertionError(f"{label}: bound-claim gang {v} on {node}, its PV on {want}")
        else:
            pv = pvs.get(pvc.volume_name)
            if (pvc.phase != "Bound" or pv is None or pv.claim_ref != pvc.meta.key
                    or pv.storage_class != "volb"
                    or pv.node_affinity.get("kubernetes.io/hostname") != node):
                raise AssertionError(f"{label}: static gang {v} on {node}, claim "
                                     f"{pvc.phase} -> {pvc.volume_name!r}")
        bound += 1
    for op, key, _ in sched.cache.err_log:
        if op == "bind_volumes" and store.get("Pod", key).node_name:
            raise AssertionError(f"{label}: {key} bound although its volume bind failed")
    return bound, placeable, why


def check_placement(store):
    """No node over its allocatable or pod cap, none holding a host port
    twice or a pod beside one its anti-affinity refuses, none missing a
    neighbour its required affinity asks for; every gang all-or-nothing.
    Returns (gang tasks bound, best-effort pods bound)."""
    nodes = {n.meta.name: i for i, n in enumerate(store.list("Node"))}
    cap = np.array([[n.allocatable.milli_cpu, n.allocatable.memory,
                     n.allocatable.max_task_num] for n in store.list("Node")])
    used = np.zeros_like(cap)
    per_gang = {}
    be_bound = 0
    on_node = {}
    for p in store.list("Pod"):
        if not p.node_name:
            continue
        i = nodes[p.node_name]
        used[i] += (p.spec.resources.milli_cpu, p.spec.resources.memory, 1)
        on_node.setdefault(i, []).append(p)
        if p.meta.name.startswith("be"):
            be_bound += 1
        else:
            g = p.meta.name.split("-")[0]
            per_gang[g] = per_gang.get(g, 0) + 1
    over = np.nonzero((used > cap).any(axis=1))[0]
    if over.size:
        raise AssertionError(f"{over.size} nodes over capacity, e.g. row {over[0]}")
    check_placement_ports(store)
    for i, pods in on_node.items():
        for p in pods:
            aff = p.spec.affinity
            if aff is None:
                continue
            others = [q.meta.labels for q in pods if q is not p]
            for sel in aff.pod_anti_affinity:
                if any(all(lab.get(k) == v for k, v in sel.items()) for lab in others):
                    raise AssertionError(f"{p.meta.key} on node row {i} beside a pod "
                                         f"its anti-affinity {sel} refuses")
            for sel in aff.pod_affinity:
                if not any(all(lab.get(k) == v for k, v in sel.items()) for lab in others):
                    raise AssertionError(f"{p.meta.key} on node row {i} without the "
                                         f"neighbour its affinity {sel} needs")
    partial = {g: c for g, c in per_gang.items() if c != CFG5["tasks_per_job"]}
    if partial:
        raise AssertionError(f"gangs bound partially: {list(partial.items())[:5]}")
    return sum(per_gang.values()), be_bound


def phase_e2e(label, n_jobs, n_best_effort, want, forbid, dynamic_frac=0.0,
              max_cycles=MAX_CYCLES, capture=None, volume_tasks=0, dynamic_best_effort_every=0,
              steady=False, binds=None):
    """Drive Scheduler.run_once on the card; returns the launch counts of
    the first cycle (reset just before it, read just after).  ``want`` maps
    a kernel to the launches the first cycle must make at least (a name
    alone: at least one); ``forbid`` lists kernels it must not launch.
    ``capture``: a list that receives the first cycle's dynamic-solve
    inputs (backend, snapshot, dyn arrays).  ``volume_tasks``: volume gangs
    as bench.py config5_volumes adds them, held to ``check_volumes`` after
    every cycle.  ``dynamic_best_effort_every``: best-effort pods on every
    such dynamic gang (build_cfg5_store), which become residue: the first
    cycle must then run the object sub-cycle and its residue engine.
    ``steady``: one more cycle once all is bound, its wall and phases (the
    drain of the landed write-back).  ``binds``: a list that receives the
    first cycle's ``bind_log`` (phase 29 holds config 7's to it)."""
    import torch

    from volcano_tpu_torch.scheduler import kernels as K
    from volcano_tpu_torch.scheduler.conf import full_conf
    from volcano_tpu_torch.scheduler.fastpath import cycle as cycle_mod
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    t0 = time.perf_counter()
    store = build_cfg5_store(n_jobs, n_best_effort, dynamic_frac, volume_tasks,
                             dynamic_best_effort_every)
    n_dyn = int(CFG5["jobs"] * dynamic_frac)
    n_vol = volume_tasks // CFG5["tasks_per_job"]
    log(f"[{label}] store built: {CFG5['nodes']} nodes, {n_jobs} gangs x "
        f"{CFG5['tasks_per_job']} ({n_dyn} dynamic), {n_best_effort} best-effort, "
        f"{n_vol} volume gangs ({time.perf_counter() - t0:.1f} s)")
    sched = Scheduler(store, conf=async_conf(full_conf("cuda")))
    log(f"[{label}] prewarm {sched.prewarm(background=False):.2f} s")
    solve_dyn = cycle_mod.torch_dynamic_solve
    solve_walls = []
    if capture is not None:
        def recording(backend, snap, dyn, n_pending=None):
            capture.append((backend, snap, dyn))
            t = time.perf_counter()
            out = solve_dyn(backend, snap, dyn, n_pending)
            solve_walls.append(time.perf_counter() - t)
            return out
        cycle_mod.torch_dynamic_solve = recording
    try:
        reset_launches()
        t0 = time.perf_counter()
        sched.run_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        cycle_mod.torch_dynamic_solve = solve_dyn
    phases = {k: round(v, 4) for k, v in sched.fast_cycle.phases.items()}
    log(f"[{label}] cycle 1 wall {wall:.3f} s phases {json.dumps(phases)} launches {launches}")
    if binds is not None:
        binds.extend(sched.cache.bind_log)
    publish_report(label, sched, flush_applier(label, sched))
    if dynamic_best_effort_every:
        fc = sched.fast_cycle
        reasons = {}
        for why in fc.last_residue_reasons.values():
            reasons[why] = reasons.get(why, 0) + 1
        missing = {"subcycle", "residue_vec"} - set(phases)
        if missing or sched.last_path != "fast":
            raise AssertionError(f"{label}: cycle 1 took the {sched.last_path} path, phases "
                                 f"{sorted(phases)} lack {sorted(missing)}")
        log(f"[{label}] residue: {len(fc.last_residue_reasons)} jobs {reasons}, "
            f"{fc.residue_stats['tasks']} tasks through the engine in "
            f"{fc.residue_stats['seconds']:.4f} s; sub-cycle walls "
            f"{json.dumps(_object_walls(sched))}")
    if solve_walls:
        # the dyn_solve phase = the dynamic inputs built on the host, then
        # the upload, the solve and its one fetch
        log(f"[{label}] dyn_solve split: inputs on the host "
            f"{phases['dyn_solve'] - solve_walls[0]:.4f} s, upload + solve + fetch "
            f"{solve_walls[0]:.4f} s")
    want = {k: 1 for k in want} if not isinstance(want, dict) else want
    forbid = tuple(forbid) + OBJECT_FORBID
    for name, at_least in want.items():
        if launches[name] < at_least:
            raise AssertionError(f"{label}: kernel {name} launched {launches[name]} times on "
                                 f"the main path, expected at least {at_least}")
    for name in forbid:
        if launches[name]:
            raise AssertionError(f"{label}: kernel {name} launched ({launches[name]})")
    want_gang = n_jobs * CFG5["tasks_per_job"]
    vol_bound, placeable, unbound_why = [], [], []

    def check(cycle):
        """Gang tasks bound outside the volume gangs, best-effort pods bound."""
        gang, be = check_placement(store)
        extra = ""
        if n_vol:
            bound, left, why = check_volumes(label, store, sched, n_vol)
            vol_bound.append(bound)
            placeable[:] = left
            unbound_why[:] = why
            gang -= bound * CFG5["tasks_per_job"]
            extra = (f", {bound} of {n_vol} volume gangs ({len(left)} unbound with a node "
                     f"that fits them)")
        log(f"[{label}] bound after cycle {cycle}: {gang} gang tasks, {be} best-effort{extra}")
        return gang, be

    gang, be = check(1)
    cycles = 1
    while (gang < want_gang or be < n_best_effort or placeable) and cycles < max_cycles:
        cycles += 1
        t0 = time.perf_counter()
        sched.run_once()
        log(f"[{label}] cycle {cycles} wall {time.perf_counter() - t0:.3f} s phases "
            f"{json.dumps({k: round(v, 4) for k, v in sched.fast_cycle.phases.items()})}")
        publish_report(label, sched, flush_applier(label, sched), cycles)
        gang, be = check(cycles)
    if gang != want_gang or be != n_best_effort or placeable:
        raise AssertionError(f"{label}: {gang} gang tasks and {be} best-effort bound after "
                             f"{cycles} cycles; volume gangs unbound though a node fits them: "
                             f"{placeable}")
    if n_vol:
        # a volume gang left unbound has no node its claim allows with room
        # for it (its pin node, or every Available volb PV's node, filled by
        # the express pass), so later cycles cannot bind it either
        log(f"[{label}] every other gang bound in {cycles} cycle(s) (deadline {max_cycles}); "
            f"volume gangs {vol_bound[-1]} of {n_vol} bound, the other "
            f"{n_vol - vol_bound[-1]} fit no node their claim allows (a gang needs 2000m "
            f"1.25Gi 20 pods): {'; '.join(unbound_why)}")
    else:
        log(f"[{label}] all bound in {cycles} cycle(s) (deadline {max_cycles})")
    if steady:
        t0 = time.perf_counter()
        sched.run_once()
        torch.cuda.synchronize()
        steady_wall = time.perf_counter() - t0
        log(f"[{label}] steady cycle wall {steady_wall:.4f} s phases "
            f"{json.dumps({k: round(v, 4) for k, v in sched.fast_cycle.phases.items()})}")
        publish_report(label, sched, flush_applier(label, sched), cycles + 1)
        armed_steady(label, sched, steady_wall)
    sched.close()
    if n_vol:
        log(f"[{label}] volume gangs bound per cycle (cumulative): {vol_bound}")
    return launches


def phase_portsel_kernels(captured, n_launches):
    """K5: the dynamic solves the e2e cells ran (K3 or K2 with portsel),
    again on their captured inputs, against their plain versions, with
    CUDA-event times and a bound counted from the work this data needs."""
    import torch

    from volcano_tpu_torch.scheduler import kernels as K
    from volcano_tpu_torch.scheduler.tensor_actions import dyn_solve_args

    rows = {}
    for label, (backend, snap, dyn) in captured.items():
        solve, args, kw = dyn_solve_args(backend, snap, dyn)
        batch = solve is K.allocate_solve_batch
        plain = K.allocate_solve_batch_plain if batch else K.allocate_solve_plain
        names = K._SOLVE_ARGS + ("w_least", "w_balanced")
        pargs = dict(zip(names, args))
        out_k = solve(*args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p = plain(**pargs, **kw)
        torch.cuda.synchronize()
        t_p = time.perf_counter() - t0
        name = "allocate_solve_batch_portsel" if batch else "allocate_solve_portsel"
        err = _compare(f"{label} {name}", out_k, out_p)
        ms = cuda_ms(lambda: solve(*args, **kw), 3)
        if batch:
            plain_ms = cuda_ms(lambda: plain(**pargs, **kw), 1)
        else:
            plain_ms = t_p * 1e3
        a = {k: v for k, v in pargs.items() if torch.is_tensor(v)}
        ps = kw["portsel"]
        io = nbytes(*a.values(), *ps[:6]) + nbytes(*out_k[:10])
        ps_ops = _portsel_task_ops(ps)
        if batch:
            J = a["job_queue"].shape[0]
            M, P = min(512, J), 16
            n_keys = len(kw["job_key_order"]) + 2 + int(kw["use_proportion"])
            ops = _batch_solve_ops(out_k, a, M, P, n_keys, ps_ops=ps_ops)
        else:
            ops = _exact_solve_ops(out_k, a, ps_ops=ps_ops)
        b, kind = bound_ms(io, ops)
        placed = int((out_k.task_kind > 0).sum())
        log(f"[kernels] {label} {name} ok: {int(out_k.steps)} {'rounds' if batch else 'steps'}, "
            f"{placed} placed, {ms:.3f} ms (plain {plain_ms:.1f} ms, bound {b:.4f} ms by {kind})")
        src = "allocate_batch.cu" if batch else "allocate_solve.cu"
        timed = {} if batch else _exact_timed(_exact_launcher(args, kw), ms,
                                              _solve_digest(out_k), f"{label} {name}")
        if timed:
            log(f"[kernels] {label} {name}: cluster {timed['cluster']}, "
                f"{timed['us_per_step']:.3f} us a step, split {json.dumps(timed['split'])}")
        rows[name] = dict(
            name=name, route="cuda", source=f"volcano_tpu_torch/csrc/{src}",
            replaces=("volcano_tpu/scheduler/kernels.py:611-635" if batch
                      else "volcano_tpu/scheduler/kernels.py:308-322"),
            launches=n_launches[name], max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b, bound_by=kind, library_ms=None, check="ok", **timed)
    return rows


def _volsel_ops(out, a, volsel):
    """K6's operations on this data: per place step (each placement and
    each drop, the dropped job's head task) the mask bit of every valid
    node and one test per claim of the task and node; per claim its
    placement assumed, one decrement (pinned) or a row of N (global)."""
    n_valid = int(a["node_valid"].sum())
    claims_w = volsel[1].cpu().numpy()
    n_claims = np.unpackbits(np.ascontiguousarray(claims_w).view(np.uint8), axis=1).sum(axis=1)
    step = n_valid * (VOLSEL_NODE_OPS + VOLSEL_CLAIM_OPS * n_claims.astype(np.int64))
    placed = out.task_kind.cpu().numpy() > 0
    dropped = out.dropped.cpu().numpy().astype(bool)
    # a dropped job's step: counted at its first task's claims
    heads = np.clip(a["job_start"].cpu().numpy()[dropped], 0, step.size - 1)
    ops = float(step[placed].sum()) + float(step[heads].sum())
    claim_node = out.claim_node.cpu().numpy()
    glob = volsel[4].cpu().numpy()[volsel[2].cpu().numpy()]
    N = int(a["node_valid"].shape[0])
    ops += float(np.where(glob, N, 1)[claim_node >= 0].sum())
    return ops


def phase_volsel_kernel(captured, n_launches):
    """K6: the dynamic solve cfg5v-2000 ran (K2 with portsel and volsel),
    again on its captured inputs, against its plain version — decisions
    and the final claim and capacity state — with CUDA-event times and a
    bound counted from the work this data needs."""
    import torch

    from volcano_tpu_torch.scheduler import kernels as K
    from volcano_tpu_torch.scheduler.tensor_actions import dyn_solve_args

    backend, snap, dyn = captured
    solve, args, kw = dyn_solve_args(backend, snap, dyn)
    if solve is not K.allocate_solve or "volsel" not in kw:
        raise AssertionError("cfg5v: the dynamic solve is not the exact solve with volsel")
    pargs = dict(zip(K._SOLVE_ARGS + ("w_least", "w_balanced"), args))
    before = [x.clone() for x in kw["volsel"]]
    out_k = solve(*args, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(kw["volsel"], before)):
        raise AssertionError("cfg5v allocate_solve_volsel: the kernel changed its inputs")
    t0 = time.perf_counter()
    out_p = K.allocate_solve_plain(**pargs, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = _compare("cfg5v-2000 allocate_solve_volsel", out_k, out_p)
    ms = cuda_ms(lambda: solve(*args, **kw), 3)
    a = {k: v for k, v in pargs.items() if torch.is_tensor(v)}
    ps, vs = kw["portsel"], kw["volsel"]
    io = nbytes(*a.values(), *ps[:6], *vs) + nbytes(*out_k[:10], out_k.claim_node, out_k.vol_cap)
    ops = (_exact_solve_ops(out_k, a, ps_ops=_portsel_task_ops(ps))
           + _volsel_ops(out_k, a, vs))
    b, kind = bound_ms(io, ops)
    placed = int((out_k.task_kind > 0).sum())
    assumed = int((out_k.claim_node >= 0).sum())
    timed = _exact_timed(_exact_launcher(args, kw), ms, _solve_digest(out_k),
                         "cfg5v-2000 allocate_solve_volsel")
    log(f"[kernels] cfg5v-2000 allocate_solve_volsel ok: {int(out_k.steps)} steps, {placed} "
        f"placed, {assumed} of {vs[2].shape[0]} claim slots assumed, {ms:.3f} ms (plain "
        f"{plain_ms:.1f} ms, bound {b:.4f} ms by {kind}), cluster {timed['cluster']}, "
        f"{timed['us_per_step']:.3f} us a step, split {json.dumps(timed['split'])}")
    return {"allocate_solve_volsel": dict(
        name="allocate_solve_volsel", route="cuda",
        source="volcano_tpu_torch/csrc/allocate_solve.cu",
        replaces="volcano_tpu/scheduler/kernels.py:323-342",
        launches=n_launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b, bound_by=kind, library_ms=None, check="ok", **timed)}


# config 6 (bench.py _build_contended_store, config6): every node exactly
# full on cpu with ten 800m / 1.2Gi residents of queue q0
CFG6 = dict(nodes=10_000, run_jobs=5_000, tasks_per_job=20, storm_gangs=100,
            reclaim_gangs=10)
CONTENTION_KERNELS = ("reclaim_solve", "preempt_solve", "preempt_rounds")
# K15a-c: the same solves on node blocks (a conf mesh with solve_mode batch)
MESH_CONTENTION_KERNELS = tuple(k + "_sharded" for k in CONTENTION_KERNELS)
CFG6_MESH = "4"
# the whole run's phases 8 and 22 take each pattern's first two cycles: the
# storm's evictions and pipelines, then its binds (the third, quiet cycle
# is cut for the run's time)
CONTENTION_CUT_CYCLES = 2
# per cycle (evictions, pipelines, binds), the victims reaped between
# cycles: the JAX package's pattern at 1/10 scale
# (tests/test_torch_contention.py TENTH_PATTERN), at full width
CFG6_PATTERN = {
    "cfg6": [(4000, 2000, 0), (0, 0, 2000), (0, 0, 0)],
    # cfg6 under solveMode: exact (TENTH_EXACT_PATTERN): every storm task
    # through K9's walk
    "cfg6-exact": [(4000, 2000, 0), (0, 0, 2000), (0, 0, 0)],
    "cfg6b": [(4000, 2000, 0), (0, 0, 2000), (0, 0, 0)],
    "cfg6r": [(20, 10, 0), (20, 10, 0), (20, 10, 0)],
}
# operations per pool row and attempt of the victim core (R = 2): the base
# test (live, queue, job) 3, the gang and conformance vetoes 3, the
# eviction-order prefix (adds, cover test, first-victim flag) 6
VICTIM_ROW_OPS = 12
# per pool row and round of the batched rounds: the candidate analysis 10
# and the victim materialisation 8
ROUND_ROW_OPS = 18
#: in the main run the whole cfg6 storm's plain K9 runs only under this
#: estimate; past it the first 10 gangs hold it (cut from 60 s for the run's
#: time: the whole storm's plain version takes about 33 s on slower hosts;
#: --storm-split holds the whole storm)
PLAIN_STORM_LIMIT_S = 20.0


@_no_gc
def build_contended_store(cell, reclaim_gangs=CFG6["reclaim_gangs"],
                          storm_gangs=CFG6["storm_gangs"], ported=()):
    """bench.py _build_contended_store with the port's objects: 10,000 nodes
    of 8 cpu / 16Gi / 110 pods, each exactly full on cpu with ten 800m /
    1.2Gi residents of queue q0 (5,000 running jobs x 20).  cfg6 (and
    cfg6-exact): 100 urgent gangs (priority 100) x 20 tasks of 1500m / 2Gi in
    q0; cfg6b: the same plus one empty-request pod no node admits on the
    first gang; cfg6r: no storm, but ``reclaim_gangs`` gangs x 20 tasks of
    1500m / 2Gi in a second queue q1 (both weight 1) reclaiming.
    ``storm_gangs``: the storm's gang count; the gangs g in ``ported`` give
    each task host port 30000 + g (cfg6d)."""
    from volcano_tpu_torch.api import (
        POD_GROUP_KEY, Metadata, Node, Pod, PodGroup, PodGroupPhase, PodPhase, PodSpec,
        PriorityClass, Queue, Resource,
    )
    from volcano_tpu_torch.store import Store

    n_nodes, tpj = CFG6["nodes"], CFG6["tasks_per_job"]
    store = Store()
    queues = ["q0", "q1", "default"] if cell == "cfg6r" else ["q0", "default"]
    for q in queues:
        store.create("Queue", Queue(meta=Metadata(name=q, namespace=""), weight=1))
    store.create("PriorityClass", PriorityClass(meta=Metadata(name="urgent", namespace=""),
                                                value=100))
    for i in range(n_nodes):
        store.create("Node", Node(meta=Metadata(name=f"n{i:05d}", namespace=""),
                                  allocatable=Resource(8000.0, 16.0 * (1 << 30),
                                                       max_task_num=110)))
    k = 0
    for j in range(CFG6["run_jobs"]):
        pg = PodGroup(meta=Metadata(name=f"run{j:05d}", namespace="default"), min_member=1,
                      queue="q0")
        pg.status.phase = PodGroupPhase.RUNNING
        store.create("PodGroup", pg)
        ann = {POD_GROUP_KEY: f"run{j:05d}"}
        for t in range(tpj):
            store.create("Pod", Pod(
                meta=Metadata(name=f"r{j:05d}-{t}", namespace="default", annotations=dict(ann)),
                spec=PodSpec(resources=Resource(800.0, 1.2 * (1 << 30))),
                phase=PodPhase.RUNNING, node_name=f"n{k % n_nodes:05d}"))
            k += 1
    gangs = reclaim_gangs if cell == "cfg6r" else storm_gangs
    for j in range(gangs):
        name = f"rec{j:03d}" if cell == "cfg6r" else f"hot{j:03d}"
        pg = PodGroup(meta=Metadata(name=name, namespace="default"), min_member=tpj,
                      queue="q1" if cell == "cfg6r" else "q0",
                      priority_class_name="" if cell == "cfg6r" else "urgent")
        pg.status.phase = PodGroupPhase.INQUEUE
        store.create("PodGroup", pg)
        ann = {POD_GROUP_KEY: name}
        for t in range(tpj):
            store.create("Pod", Pod(
                meta=Metadata(name=f"{name}-{t}", namespace="default", annotations=dict(ann)),
                spec=PodSpec(resources=Resource(1500.0, 2.0 * (1 << 30)),
                             host_ports=[30000 + j] if j in ported else [])))
        if cell == "cfg6b" and j == 0:
            store.create("Pod", Pod(
                meta=Metadata(name=f"hbe{j:03d}", namespace="default", annotations=dict(ann)),
                spec=PodSpec(resources=Resource(), node_selector={"zone": "nowhere"})))
    return store


class ContentionCapture:
    """During a cycle: the inputs of the first call of each contention
    kernel in ``names`` (the wrappers copy the state they update, so the
    inputs stay as the cycle gave them), CUDA events around every such call
    (their time on the stream per cycle), and every pipeline as (pod key,
    node name)."""

    def __init__(self, names=CONTENTION_KERNELS):
        import torch

        from volcano_tpu_torch.scheduler import fast_victims as FV
        from volcano_tpu_torch.scheduler import victim_kernels as VK

        self.inputs, self.pipes, self.events = {}, [], []
        self._saved = [(VK, n, getattr(VK, n)) for n in names]
        self._saved.append((FV.FastContention, "_append_records",
                            FV.FastContention._append_records))
        rec = self

        def recording(name, fn):
            def call(*args, **kwargs):
                rec.inputs.setdefault(name, (args, kwargs))
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                rec.events.append((start, end))
                return out
            return call

        for mod, name, fn in self._saved[:-1]:
            setattr(mod, name, recording(name, fn))
        append = self._saved[-1][2]

        def append_records(cont, evict_att, pipe_node, pipe_att, reason):
            n0 = len(cont.pipelines)
            append(cont, evict_att, pipe_node, pipe_att, reason)
            rec.pipes += [(cont.snap.task_uids[t], cont.snap.node_names[n])
                          for t, n in cont.pipelines[n0:]]

        FV.FastContention._append_records = append_records

    def take_ms(self):
        """CUDA-event ms of the recorded calls since the last take (each
        call's span on the stream, its host round trips included)."""
        ms = sum(a.elapsed_time(b) for a, b in self.events)
        self.events = []
        return ms

    def close(self):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def check_contention_cycle(label, cell, store, victims, pipes):
    """One cycle's contention invariants: every victim a resident of q0 (for
    the storm cells below the preemptor's priority); on every node the
    pipelined requests covered by idle plus releasing capacity and the pod
    cap kept; every storm gang pipelined all or nothing."""
    nodes = {n.meta.name: n for n in store.list("Node")}
    groups = {g.meta.key: g for g in store.list("PodGroup")}
    from volcano_tpu_torch.api import POD_GROUP_KEY

    def group_of(pod):
        return groups[f"{pod.meta.namespace}/{pod.meta.annotations[POD_GROUP_KEY]}"]

    for key in victims:
        pod = store.get("Pod", key)
        g = group_of(pod)
        if g.queue != "q0" or not pod.deleting:
            raise AssertionError(f"{label}: victim {key} in {g.queue}, deleting={pod.deleting}")
        if cell != "cfg6r" and g.priority_class_name == "urgent":
            raise AssertionError(f"{label}: victim {key} has the preemptors' priority")
    used, rel, count = {}, {}, {}
    for pod in store.list("Pod"):
        if not pod.node_name:
            continue
        r = np.array([pod.spec.resources.milli_cpu, pod.spec.resources.memory])
        used[pod.node_name] = used.get(pod.node_name, 0) + r
        count[pod.node_name] = count.get(pod.node_name, 0) + 1
        if pod.deleting:
            rel[pod.node_name] = rel.get(pod.node_name, 0) + r
    piped, per_gang = {}, {}
    for key, node in pipes:
        pod = store.get("Pod", key)
        piped.setdefault(node, []).append(pod)
        if pod.spec.resources.milli_cpu > 0:
            g = group_of(pod).meta.name
            per_gang[g] = per_gang.get(g, 0) + 1
    eps = np.array([10.0, 10.0 * (1 << 20)])
    for node, pods in piped.items():
        a = nodes[node].allocatable
        alloc = np.array([a.milli_cpu, a.memory])
        free = np.maximum(alloc - used.get(node, 0), 0) + rel.get(node, 0)
        need = sum(np.array([p.spec.resources.milli_cpu, p.spec.resources.memory]) for p in pods)
        if not (need < free + eps).all():
            raise AssertionError(f"{label}: node {node} pipelines {need} over {free}")
        if count.get(node, 0) + len(pods) > a.max_task_num:
            raise AssertionError(f"{label}: node {node} over its pod cap")
    if cell != "cfg6r":
        partial = {g: n for g, n in per_gang.items() if n != CFG6["tasks_per_job"]}
        if partial:
            raise AssertionError(f"{label}: gangs pipelined partially: {list(partial.items())[:5]}")


def phase_contention(label, cell, want, forbid, conf=None, names=CONTENTION_KERNELS,
                     cycles=None):
    """Drive Scheduler.run_once on the card over a config-6 store for three
    cycles (or ``cycles``, the reference pattern's first ones) under
    ``conf`` (full_conf("cuda") by default), the victims reaped (deleted,
    as the kubelet does) after each.  Launch counts are reset
    just before the first cycle and read just after it.  Returns
    (first-cycle launches, the first inputs of the kernels in ``names``,
    the run's per-cycle (evictions, pipelines, binds), ordered evictions,
    pipelines and binds)."""
    import torch

    from volcano_tpu_torch.scheduler.conf import full_conf
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    t0 = time.perf_counter()
    store = build_contended_store(cell)
    log(f"[{label}] store built: {CFG6['nodes']} nodes, "
        f"{CFG6['run_jobs'] * CFG6['tasks_per_job']} residents ({time.perf_counter() - t0:.1f} s)")
    sched = Scheduler(store, conf=async_conf(conf or full_conf("cuda")))
    log(f"[{label}] mesh {sched.mesh}, solve_mode {sched.conf.solve_mode}; prewarm "
        f"{sched.prewarm(background=False):.2f} s")
    cap = ContentionCapture(names)
    history, evicted = [], []
    pattern = CFG6_PATTERN[cell][:cycles]
    try:
        for cycle in range(len(pattern)):
            n_ev, n_pipe, n_bind = (len(sched.cache.evict_log), len(cap.pipes),
                                    len(sched.cache.bind_log))
            if cycle == 0:
                reset_launches()
            t0 = time.perf_counter()
            sched.run_once()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if cycle == 0:
                launches = read_launches()
                captured = dict(cap.inputs)
            victims = [k for k, _ in sched.cache.evict_log[n_ev:]]
            pipes = cap.pipes[n_pipe:]
            history.append((len(victims), len(pipes), len(sched.cache.bind_log) - n_bind))
            phases = {k: round(v, 4) for k, v in sched.fast_cycle.phases.items()}
            log(f"[{label}] cycle {cycle + 1} wall {wall:.3f} s phases {json.dumps(phases)} "
                f"(evictions, pipelines, binds) {history[-1]}; {'/'.join(names)} "
                f"{cap.take_ms():.3f} ms on the stream"
                + (f" launches {launches}" if cycle == 0 else ""))
            publish_report(label, sched, flush_applier(label, sched), cycle + 1)
            check_contention_cycle(label, cell, store, victims, pipes)
            evicted += victims
            for key in victims:  # the kubelet reaps the victims
                store.delete("Pod", key)
    finally:
        pipes = list(cap.pipes)
        cap.close()
        sched.close()
    if len(set(evicted)) != len(evicted):
        raise AssertionError(f"{label}: a pod was evicted twice")
    if history != pattern:
        raise AssertionError(f"{label}: per-cycle (evictions, pipelines, binds) {history}, "
                             f"the reference's pattern is {pattern}")
    if cell != "cfg6r":
        unbound = [p.meta.key for p in store.list("Pod")
                   if p.meta.name.startswith("hot") and not p.node_name]
        if unbound:
            raise AssertionError(f"{label}: storm pods unbound: {unbound[:5]}")
    for name, at_least in want.items():
        if launches[name] < at_least:
            raise AssertionError(f"{label}: kernel {name} launched {launches[name]} times on "
                                 f"the main path, expected at least {at_least}")
    for name in tuple(forbid) + OBJECT_FORBID:
        if launches[name]:
            raise AssertionError(f"{label}: kernel {name} launched ({launches[name]})")
    log(f"[{label}] invariants hold; evictions per cycle {[h[0] for h in history]}")
    return launches, captured, dict(history=history, evicts=list(sched.cache.evict_log),
                                    pipes=pipes, binds=list(sched.cache.bind_log))


def _victim_compare(name, out_k, out_p):
    """Every integer and boolean output equal, float state within rtol 1e-6;
    returns the largest float difference."""
    import torch

    err = 0.0
    flat_k, flat_p = {}, {}
    for flat, out in ((flat_k, out_k), (flat_p, out_p)):
        for f in out._fields:
            part = getattr(out, f)
            if hasattr(part, "_fields"):
                flat.update({f"{f}.{g}": getattr(part, g) for g in part._fields})
            else:
                flat[f] = part
    for f, x in flat_k.items():
        y = torch.as_tensor(flat_p[f], device=x.device)
        if x.dtype.is_floating_point:
            err = max(err, float((x - y.to(x.dtype)).abs().max()) if x.numel() else 0.0)
            if not torch.allclose(x, y.to(x.dtype), rtol=1e-6, atol=0.0):
                raise AssertionError(f"{name}: {f} differs (max abs err {err})")
        elif not torch.equal(x, y.to(x.dtype)):
            raise AssertionError(f"{name}: {f} differs")
    return err


def _victim_bytes(args, out):
    import torch

    ins = [a for a in args if torch.is_tensor(a)]
    for a in args:
        if hasattr(a, "_fields"):
            ins += [x for x in a if torch.is_tensor(x)]
    outs = list(out.state) + [out.pipe, *out.rec[:3]]
    return nbytes(*ins) + nbytes(*outs)


def _victim_ops(name, args, out):
    """Operations the solve's data needs: per ok attempt (K8, K9; rollbacks
    included) one pass of the victim core over the live pool rows and the
    valid nodes, and one job selection over the valid jobs; per round (K10)
    the candidate analysis and victim materialisation over the pool, and
    the head-task score of each job that committed over the valid nodes."""
    c = args[0]
    v_live = int(args[1].run_live.sum())
    n_valid = int(c.node_valid.sum())
    j_valid = int((c.job_queue >= 0).sum())
    if name == "preempt_rounds":
        from volcano_tpu_torch.scheduler.victim_kernels import ROUNDS_P_CHUNK

        F = min(128, c.job_queue.shape[0]) * ROUNDS_P_CHUNK  # fast_victims' chunks
        rounds = int(out.rec.att) // (F + 1)
        committed = int((out.pipe - args[9] > 0).sum())
        return rounds * v_live * ROUND_ROW_OPS + committed * n_valid * BATCH_PAIR_OPS
    attempts = int(out.rec.att) if name == "reclaim_solve" else int(out.att_total)
    return attempts * (v_live * VICTIM_ROW_OPS + n_valid * EXACT_NODE_OPS
                       + j_valid * EXACT_JOB_OPS)


def _storm_exact_args(rounds_in, n_gangs=None):
    """preempt_solve's inputs for the storm the rounds took, as the exact
    mode (solveMode: exact) would hand them over: every attemptable row of
    the storm's jobs, in one queue.  Rows of a job are contiguous in the
    snapshot, so job_start is each job's first packed row.  ``n_gangs``
    keeps only the first gangs."""
    import torch

    args, kw = rounds_in
    c, s0, task_req, task_class, rows_packed, pstart, pcount, job_prio, avail, pipe0 = args
    dev = task_req.device
    J, T = c.job_queue.shape[0], task_req.shape[0]
    jobs = torch.nonzero(avail & (pcount > 0)).flatten()
    if n_gangs is not None:
        jobs = jobs[:n_gangs]
    job_start = torch.zeros(J, dtype=torch.int32, device=dev)
    job_ntasks = torch.zeros(J, dtype=torch.int32, device=dev)
    attempt = torch.zeros(T, dtype=torch.bool, device=dev)
    for j in jobs.tolist():
        rows = rows_packed[int(pstart[j]):int(pstart[j]) + int(pcount[j])]
        if not torch.equal(rows, torch.arange(int(rows[0]), int(rows[0]) + rows.numel(),
                                              device=dev, dtype=rows.dtype)):
            raise AssertionError("storm rows are not contiguous per job")
        job_start[j], job_ntasks[j] = rows[0], rows.numel()
        attempt[rows.long()] = True
    is_pre = torch.zeros(J, dtype=torch.bool, device=dev)
    is_pre[jobs] = True
    under = torch.zeros(J, dtype=torch.int32, device=dev)
    under[:jobs.numel()] = jobs.int()
    queues = torch.unique(c.job_queue[jobs])
    qorder = torch.zeros(s0.queue_alloc.shape[0], dtype=torch.int32, device=dev)
    qorder[:queues.numel()] = queues
    ex = (c, s0, task_req, task_class, attempt, job_start, job_ntasks, job_prio, is_pre,
          under, int(jobs.numel()), qorder, int(queues.numel()), pipe0)
    ekw = {k: kw[k] for k in ("use_gang", "use_drf", "use_conformance", "order_by_priority",
                              "job_key_order", "gang_pipelined")}
    return ex, ekw


def phase_victim_kernels(captured, launches):
    """K8 (cfg6r), K9 (cfg6b, and the whole cfg6 storm in exact mode) and
    K10 (cfg6) again on the inputs their cells captured, against their
    plain versions, with CUDA-event times and a bound counted from the work
    this data needs."""
    import torch

    from volcano_tpu_torch.scheduler import victim_kernels as VK

    meta = {
        "reclaim_solve": ("reclaim_solve.cu", "volcano_tpu/scheduler/victim_kernels.py:457"),
        "preempt_solve": ("preempt_solve.cu", "volcano_tpu/scheduler/victim_kernels.py:607"),
        "preempt_rounds": ("preempt_rounds.cu", "volcano_tpu/scheduler/victim_kernels.py:830"),
    }
    plains = {"reclaim_solve": VK.reclaim_solve_plain, "preempt_solve": VK.preempt_solve_plain,
              "preempt_rounds": VK.preempt_rounds_plain}

    def measure(name, args, kw, reps=3):
        wrap, plain = getattr(VK, name), plains[name]
        out_k = wrap(*args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p = plain(*args, **kw)
        torch.cuda.synchronize()
        t_p = time.perf_counter() - t0
        err = _victim_compare(name, out_k, out_p)
        ms = cuda_ms(lambda: wrap(*args, **kw), reps)
        b, kind = bound_ms(_victim_bytes(args, out_k), _victim_ops(name, args, out_k))
        return out_k, err, ms, t_p * 1e3, b, kind

    rows = {}
    for name, cell in (("reclaim_solve", "cfg6r"), ("preempt_solve", "cfg6b"),
                       ("preempt_rounds", "cfg6")):
        args, kw = captured[cell][name]
        out_k, err, ms, plain_ms, b, kind = measure(name, args, kw)
        if name == "preempt_rounds":
            work = (f"{_rounds_of(out_k, args, kw)} rounds, "
                    f"{int(out_k.att_total)} tasks committed")
        else:
            work = f"{int(out_k.rec.att)} ok attempts"
        log(f"[kernels] {cell} {name} ok: {work}, "
            f"{int((out_k.rec.evict_att >= 0).sum())} evictions, {ms:.3f} ms "
            f"(plain {plain_ms:.1f} ms, bound {b:.4f} ms by {kind})")
        src, rep = meta[name]
        rows[name] = dict(name=name, route="cuda", source=f"volcano_tpu_torch/csrc/{src}",
                          replaces=rep, launches=launches[cell][name], max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, bound_ms=b, bound_by=kind, library_ms=None,
                          check="ok", cell=cell)

    # K9 over the whole cfg6 storm, as solveMode: exact runs it; its plain
    # version is held on the first 10 gangs when the whole storm would take
    # it past PLAIN_STORM_LIMIT_S
    ex10, ekw = _storm_exact_args(captured["cfg6"]["preempt_rounds"], n_gangs=10)
    t0 = time.perf_counter()
    out_p10 = VK.preempt_solve_plain(*ex10, **ekw)
    torch.cuda.synchronize()
    plain10_ms = (time.perf_counter() - t0) * 1e3
    est = plain10_ms / 1e3 * CFG6["storm_gangs"] / 10
    ex, ekw = _storm_exact_args(captured["cfg6"]["preempt_rounds"])
    held = est > PLAIN_STORM_LIMIT_S
    out_k = VK.preempt_solve(*ex, **ekw)
    ms = cuda_ms(lambda: VK.preempt_solve(*ex, **ekw), 3)
    b, kind = bound_ms(_victim_bytes(ex, out_k), _victim_ops("preempt_solve", ex, out_k))
    if held:
        out_k10 = VK.preempt_solve(*ex10, **ekw)
        plain_ms = plain10_ms
        err = _victim_compare("preempt_solve storm (first 10 gangs)", out_k10, out_p10)
    else:
        t0 = time.perf_counter()
        out_p = VK.preempt_solve_plain(*ex, **ekw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = _victim_compare("preempt_solve storm", out_k, out_p)
    ok = int(out_k.att_total)
    log(f"[kernels] cfg6 storm preempt_solve (exact) ok: {ok} ok attempts, "
        f"{int((out_k.rec.evict_att >= 0).sum())} evictions, {ms:.3f} ms (plain "
        f"{plain_ms:.1f} ms{' on the first 10 gangs' if held else ''}, estimated whole "
        f"{est:.1f} s; bound {b:.4f} ms by {kind})")
    if ok != CFG6["storm_gangs"] * CFG6["tasks_per_job"]:
        raise AssertionError(f"storm preempt_solve: {ok} ok attempts")
    rows["preempt_solve"].update(storm_exact_ms=ms, storm_exact_plain_ms=plain_ms,
                                 storm_exact_plain_held_on_10_gangs=held,
                                 storm_exact_bound_ms=b, storm_exact_max_abs_err=err)
    return rows


# cfg6r-be: cfg6r plus one empty-request pod, no selector, first in gang
# rec000's task order; per cycle (evictions, pipelines, binds), the victims
# reaped between cycles: the JAX package's pattern at 1/20 scale
# (tests/test_torch_object.py CFG6R_BE_PATTERN), at full width
CFG6R_BE_PATTERN = [(19, 10, 0), (19, 10, 0), (19, 10, 0)]
# cut for the run's time: cfg6r-be's cached run takes the pattern's first
# two cycles, its run without the cache and cfg6r-be-mesh's runs the first
CFG6R_BE_CYCLES = 2
CFG6R_BE_MESH_CYCLES = 1
# the object path's kernels; the fast-path cells must not launch them
OBJECT_KERNELS = ("victim_step", "victim_step_sharded")
#: the object path's group build (once per snapshot load), and with the
#: solves the kernels the fast-path cells must not launch
GROUP_KERNEL = "victim_groups"
OBJECT_FORBID = OBJECT_KERNELS + (GROUP_KERNEL,)


class ObjectCapture:
    """During the object cells: the inputs of the first call of each victim
    solve (K7 victim_step, K12b victim_step_sharded), CUDA events around
    every call (their device time per cycle), the walls of the victim
    driver's resyncs (the snapshot rebuilt after a host detour), every
    pipeline as (pod key, node name), and the session open's split
    (``take_split``): the object snapshot (``SchedulerCache.snapshot``),
    every tensor snapshot build (the first of a cycle and each resync's),
    and the host -> device copies the upload memos made (their count,
    bytes, wall, and how many were of the snapshot cache's arrays)."""

    def __init__(self):
        import torch

        from volcano_tpu_torch.scheduler import cache as C
        from volcano_tpu_torch.scheduler import session as S
        from volcano_tpu_torch.scheduler import statement as ST
        from volcano_tpu_torch.scheduler import tensor_actions as TA
        from volcano_tpu_torch.scheduler import tensor_backend as TB

        self.first, self.events, self.resyncs, self.pipes = {}, [], [], []
        self.snap_walls, self.builds, self.copies = [], [], []
        #: the SnapshotCache whose arrays count as cached uploads, or None
        self.cache = None
        self._saved = [(TA, name, getattr(TA, name)) for name in OBJECT_KERNELS]
        self._saved += [(TA._VictimDriver, "resync", TA._VictimDriver.resync),
                        (S.Session, "pipeline", S.Session.pipeline),
                        (ST.Statement, "pipeline", ST.Statement.pipeline),
                        (C.SchedulerCache, "snapshot", C.SchedulerCache.snapshot),
                        (TB, "build_tensor_snapshot", TB.build_tensor_snapshot),
                        (TB.DeviceUploads, "__call__", TB.DeviceUploads.__call__)]
        resync = TA._VictimDriver.resync
        rec = self
        snapshot, build, upload = (C.SchedulerCache.snapshot, TB.build_tensor_snapshot,
                                   TB.DeviceUploads.__call__)

        def timed_snapshot(cache):
            t = time.perf_counter()
            out = snapshot(cache)
            rec.snap_walls.append(time.perf_counter() - t)
            return out

        def timed_build(ssn, **kw):
            t = time.perf_counter()
            out = build(ssn, **kw)
            cache = kw.get("cache")
            rec.builds.append((time.perf_counter() - t,
                               dict(cache.stats) if cache is not None else None))
            return out

        def timed_upload(memo, arr):
            hit = memo._memo.get(id(arr))
            if hit is not None and hit[0] is arr:
                return upload(memo, arr)
            t = time.perf_counter()
            out = upload(memo, arr)
            rec.copies.append((arr.nbytes, time.perf_counter() - t, rec._cached(arr)))
            return out

        C.SchedulerCache.snapshot = timed_snapshot
        TB.build_tensor_snapshot = timed_build
        TB.DeviceUploads.__call__ = timed_upload

        def timed(name, step):
            def call(*args, **kwargs):
                rec.first.setdefault(name, (args, kwargs))
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = step(*args, **kwargs)
                end.record()
                rec.events.append((start, end))
                return out
            return call

        def timed_resync(driver):
            t = time.perf_counter()
            resync(driver)
            rec.resyncs.append(time.perf_counter() - t)

        for name in OBJECT_KERNELS:
            setattr(TA, name, timed(name, getattr(TA, name)))
        TA._VictimDriver.resync = timed_resync
        for cls in (S.Session, ST.Statement):
            orig = cls.pipeline

            def pipeline(self_, task, hostname, _orig=orig):
                rec.pipes.append((task.key, hostname))
                return _orig(self_, task, hostname)

            cls.pipeline = pipeline

    def take_device_ms(self):
        """Device ms of the victim_step calls since the last take."""
        ms = sum(a.elapsed_time(b) for a, b in self.events)
        self.events = []
        return ms

    def _cached(self, arr):
        """"planes" for the cache's class planes, "statics" for its node
        statics, else None."""
        c = self.cache
        if c is None:
            return None
        if c._assembled and any(arr is a for a in c._assembled[1:]):
            return "planes"
        if c._node_static and any(arr is a for a in c._node_static[1:]):
            return "statics"
        return None

    def take_split(self, walls):
        """The session-open split of the cycle since the last take: the
        object snapshot, the plugins' opens (the rest of ``session_open``),
        the first tensor snapshot build, the resyncs' rebuilds, the class
        rows built, and the uploads (copies, MB, seconds, copies of cached
        arrays)."""
        snap = sum(self.snap_walls)
        builds = self.builds
        out = dict(object_snapshot=round(snap, 4),
                   plugins_open=round(walls.get("session_open", 0.0) - snap, 4),
                   tensor_snapshot=round(builds[0][0], 4) if builds else 0.0,
                   rebuilds=[round(w, 4) for w, _ in builds[1:]],
                   rows_built=[st["rows_built"] for _, st in builds if st is not None],
                   planes_reused=[st["assembled"] for _, st in builds if st is not None],
                   uploads=dict(copies=len(self.copies),
                                mb=round(sum(b for b, _, _ in self.copies) / 2 ** 20, 3),
                                s=round(sum(w for _, w, _ in self.copies), 4),
                                planes=sum(1 for _, _, c in self.copies if c == "planes"),
                                statics=sum(1 for _, _, c in self.copies if c == "statics")))
        self.snap_walls, self.builds, self.copies = [], [], []
        return out

    def close(self):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


@_no_gc
def build_cfg6r_be_store():
    """cfg6r plus one empty-request pod first in gang rec000's task order
    (a best-effort reclaimer: the fast cycle declines it)."""
    from volcano_tpu_torch.api import POD_GROUP_KEY, Metadata, Pod, PodSpec, Resource

    store = build_contended_store("cfg6r")
    store.create("Pod", Pod(
        meta=Metadata(name="hbe000", namespace="default", annotations={POD_GROUP_KEY: "rec000"}),
        spec=PodSpec(resources=Resource())))
    return store


def _object_walls(sched):
    return {k: round(v, 4) for k, v in sched.object_phases.items()}


def _check_cache_reuse(label, splits):
    """With the snapshot cache, from cycle 2 on: no class row is built, the
    node statics are not copied to the card again, and neither are the
    class planes wherever every build of the cycle reused them (a cycle
    whose pending classes changed assembles new planes from cached rows)."""
    for cycle, sp in enumerate(splits[1:], start=2):
        up = sp["uploads"]
        if (any(sp["rows_built"]) or up["statics"]
                or (all(sp["planes_reused"]) and up["planes"])):
            raise AssertionError(f"{label}: cycle {cycle} built class rows {sp['rows_built']}, "
                                 f"copied {up['statics']} node statics and {up['planes']} "
                                 f"class planes (planes reused {sp['planes_reused']})")


def _object_cfg6r_be(label, conf, kernel, cache=True, cycles=len(CFG6R_BE_PATTERN)):
    """Scheduler.run_once on the card over cfg6r-be for ``cycles`` cycles under
    ``conf``, the victims reaped after each: every cycle takes the object
    path (the fast cycle declines a best-effort reclaimer), the best-effort
    reclaimer's attempt is a host detour and every other preemptor attempt
    one launch of the victim solve ``kernel``.  ``cache=False`` runs the
    Scheduler without its snapshot cache; ``cycles`` cuts the run to the
    pattern's first cycles.  Launch counts are reset just
    before each cycle and read just after it.  Returns the per-cycle
    launches, the first call's inputs of ``kernel``, and the run's
    (evictions, pipelines, binds) per cycle, ordered evictions, pipelines,
    binds, and each cycle's walls and session-open split."""
    import torch

    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    t0 = time.perf_counter()
    store = build_cfg6r_be_store()
    log(f"[{label}] store built: {CFG6['nodes']} nodes, "
        f"{CFG6['run_jobs'] * CFG6['tasks_per_job']} residents, "
        f"{CFG6['reclaim_gangs']} reclaiming gangs + 1 best-effort pod "
        f"({time.perf_counter() - t0:.1f} s)")
    sched = Scheduler(store, conf=conf)
    if not cache:
        sched.snapshot_cache = None
    log(f"[{label}] mesh {sched.mesh}, solve_mode {conf.solve_mode}, snapshot cache "
        f"{'on' if cache else 'off'}; prewarm {sched.prewarm(background=False):.2f} s")
    cap = ObjectCapture()
    cap.cache = sched.snapshot_cache
    history, evicted, per_cycle, walls, splits = [], [], [], [], []
    try:
        for cycle in range(cycles):
            n_ev, n_pipe, n_bind = (len(sched.cache.evict_log), len(cap.pipes),
                                    len(sched.cache.bind_log))
            n_resync = len(cap.resyncs)
            reset_launches()
            t0 = time.perf_counter()
            sched.run_once()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            per_cycle.append(launches)
            if sched.last_path != "object":
                raise AssertionError(f"{label}: cycle {cycle + 1} took the {sched.last_path} "
                                     "path, the reference's takes the object path")
            victims = [k for k, _ in sched.cache.evict_log[n_ev:]]
            pipes = cap.pipes[n_pipe:]
            history.append((len(victims), len(pipes), len(sched.cache.bind_log) - n_bind))
            resyncs = cap.resyncs[n_resync:]
            walls.append(dict(_object_walls(sched), wall=round(wall, 4)))
            splits.append(cap.take_split(sched.object_phases))
            log(f"[{label}] cycle {cycle + 1} wall {wall:.3f} s walls "
                f"{json.dumps(_object_walls(sched))} (evictions, pipelines, binds) "
                f"{history[-1]}; {kernel} launches {launches[kernel]}, device "
                f"{cap.take_device_ms():.3f} ms; {len(resyncs)} resyncs "
                f"{[round(r, 4) for r in resyncs]} s; launches {launches}")
            log(f"[{label}] cycle {cycle + 1} session-open split {json.dumps(splits[-1])}")
            for name in (kernel, GROUP_KERNEL):
                if launches[name] < 1:
                    raise AssertionError(f"{label}: {name} not launched in cycle {cycle + 1}")
            for name in CONTENTION_KERNELS + tuple(k for k in OBJECT_KERNELS if k != kernel):
                if launches[name]:
                    raise AssertionError(f"{label}: kernel {name} launched ({launches[name]})")
            publish_report(label, sched, 0.0, cycle + 1)
            check_contention_cycle(label, "cfg6r", store, victims, pipes)
            evicted += victims
            for key in victims:  # the kubelet reaps the victims
                store.delete("Pod", key)
    finally:
        captured = cap.first.get(kernel)
        pipes = list(cap.pipes)
        cap.close()
    if len(set(evicted)) != len(evicted):
        raise AssertionError(f"{label}: a pod was evicted twice")
    if history != CFG6R_BE_PATTERN[:cycles]:
        raise AssertionError(f"{label}: per-cycle (evictions, pipelines, binds) {history}, "
                             f"the reference's pattern is {CFG6R_BE_PATTERN[:cycles]}")
    if cache:
        _check_cache_reuse(label, splits)
    log(f"[{label}] invariants hold; evictions per cycle {[h[0] for h in history]}")
    return per_cycle, captured, dict(history=history, evicts=list(sched.cache.evict_log),
                                     pipes=pipes, binds=list(sched.cache.bind_log),
                                     walls=walls, splits=splits)


def _same_decisions(label, got, want, keys=("history", "evicts", "pipes", "binds")):
    for key in keys:
        if got[key] != want[key]:
            raise AssertionError(f"{label}: {key} differ with and without the snapshot cache")


def _cache_summary(label, on, off):
    """One line: each cycle's wall and split with the cache and without."""
    log(f"[{label}] snapshot cache on / off, per cycle: " + json.dumps([
        {"wall": [a["wall"], b["wall"]], "session_open": [a["session_open"], b["session_open"]],
         "tensor_snapshot": [sa["tensor_snapshot"], sb["tensor_snapshot"]],
         "rebuilds": [sa["rebuilds"], sb["rebuilds"]],
         "uploads_mb": [sa["uploads"]["mb"], sb["uploads"]["mb"]]}
        for a, b, sa, sb in zip(on["walls"], off["walls"], on["splits"], off["splits"])]))


def phase_object_cfg6r_be(no_cache=True):
    """cfg6r-be under full_conf("cuda"): every preemptor attempt one K7
    launch; with the snapshot cache, then (with ``no_cache``) one cycle
    without it, the same decisions as the cached run's first.  Returns
    (first-cycle launches, the first K7 call's inputs)."""
    from volcano_tpu_torch.scheduler.conf import full_conf

    per_cycle, captured, on = _object_cfg6r_be("e2e cfg6r-be", full_conf("cuda"), "victim_step",
                                                cycles=CFG6R_BE_CYCLES)
    if no_cache:
        # one cycle without the cache, held to the cached run's first (cut
        # for the run's time)
        n_ev, n_pipe, n_bind = on["history"][0]
        first = dict(history=on["history"][:1], evicts=on["evicts"][:n_ev],
                     pipes=on["pipes"][:n_pipe], binds=on["binds"][:n_bind])
        _, _, off = _object_cfg6r_be("e2e cfg6r-be, no cache", full_conf("cuda"), "victim_step",
                                     cache=False, cycles=1)
        _same_decisions("cfg6r-be", first, off)
        _cache_summary("e2e cfg6r-be", on, off)
    return per_cycle[0], captured


def phase_object_cfg6r_be_mesh(no_cache=True):
    """cfg6r-be-mesh: the cfg6r-be store under full_conf("cuda") with mesh
    "4" and solve_mode "batch", so that every preemptor attempt is one K12b
    launch on four node blocks, against the same store under mesh "off"
    with solve_mode "batch" (K7), run first: equal per-cycle (evictions,
    pipelines, binds), ordered evictions, pipelines and binds, and as many
    K12b launches each cycle as the oracle's K7 launches.  ``no_cache``:
    the mesh run again without the snapshot cache, the same decisions.
    Returns the mesh run's first-cycle launches and the first K12b call's
    inputs."""
    from volcano_tpu_torch.scheduler.conf import full_conf

    runs = {}
    for mesh, kernel, cache in (("off", "victim_step", True),
                                (CFG6R_BE_MESH, "victim_step_sharded", True),
                                (CFG6R_BE_MESH, "victim_step_sharded", False)):
        if not (cache or no_cache):
            continue
        conf = full_conf("cuda")
        conf.solve_mode, conf.mesh = "batch", mesh
        runs[mesh, cache] = _object_cfg6r_be(
            f"e2e cfg6r-be-mesh, mesh {mesh}" + ("" if cache else ", no cache"), conf, kernel,
            cache=cache, cycles=CFG6R_BE_MESH_CYCLES)
    (oracle, _, want), (per_cycle, captured, got) = runs["off", True], runs[CFG6R_BE_MESH, True]
    if no_cache:
        _same_decisions("cfg6r-be-mesh", got, runs[CFG6R_BE_MESH, False][2])
        _cache_summary("e2e cfg6r-be-mesh", got, runs[CFG6R_BE_MESH, False][2])
    for key in ("history", "evicts", "pipes", "binds"):
        if got[key] != want[key]:
            raise AssertionError(f"cfg6r-be-mesh: {key} differ from the mesh-off oracle")
    k7 = [launches["victim_step"] for launches in oracle]
    k12b = [launches["victim_step_sharded"] for launches in per_cycle]
    if k12b != k7:
        raise AssertionError(f"cfg6r-be-mesh: K12b launches per cycle {k12b}, the oracle's "
                             f"K7 launches {k7}")
    log(f"[e2e cfg6r-be-mesh] equal to the mesh-off oracle: {got['history']}, "
        f"{len(got['evicts'])} evictions, {len(got['pipes'])} pipelines in order; K12b "
        f"launches per cycle {k12b} (oracle's K7 {k7})")
    return per_cycle[0], captured


#: cycles of each cfg5-obj run (the quiet third is cut for the run's time)
CFG5_OBJ_CYCLES = 2


def _object_cfg5(label, cache, cycles=CFG5_OBJ_CYCLES):
    """Config 5's nodes and 5,000 gangs x 20 (no best-effort pods: on the
    object path each would take a Python scan of the 10,000 nodes in
    backfill) under full_conf("cuda") with fast_path "off", ``cycles`` cycles,
    with the Scheduler's snapshot cache or without it: the object cycle's
    allocate runs K3 and applies its 100,000 placements in bulk; every gang
    task binds in cycle 1.  Returns the first cycle's launches and the
    run's binds, walls and splits."""
    import torch

    from volcano_tpu_torch.scheduler.conf import full_conf
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    t0 = time.perf_counter()
    store = build_cfg5_store(CFG5["jobs"], 0)
    log(f"[{label}] store built: {CFG5['nodes']} nodes, {CFG5['jobs']} gangs x "
        f"{CFG5['tasks_per_job']}, no best-effort ({time.perf_counter() - t0:.1f} s)")
    conf = full_conf("cuda")
    conf.fast_path = "off"
    sched = Scheduler(store, conf=conf)
    if not cache:
        sched.snapshot_cache = None
    log(f"[{label}] snapshot cache {'on' if cache else 'off'}; prewarm "
        f"{sched.prewarm(background=False):.2f} s")
    cap = ObjectCapture()
    cap.cache = sched.snapshot_cache
    walls, splits = [], []
    try:
        for cycle in range(cycles):
            reset_launches()
            t0 = time.perf_counter()
            sched.run_once()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            if cycle == 0:
                first = launches
            publish_report(label, sched, 0.0, cycle + 1)
            gang, be = check_placement(store)
            walls.append(dict(_object_walls(sched), wall=round(wall, 4)))
            splits.append(cap.take_split(sched.object_phases))
            log(f"[{label}] cycle {cycle + 1} wall {wall:.3f} s walls "
                f"{json.dumps(_object_walls(sched))}; bound {gang} gang tasks; victim_step "
                f"launches {launches['victim_step']}, device {cap.take_device_ms():.3f} ms; "
                f"launches {launches}")
            log(f"[{label}] cycle {cycle + 1} session-open split {json.dumps(splits[-1])}")
            if cycle == 0 and gang != CFG5["jobs"] * CFG5["tasks_per_job"]:
                raise AssertionError(f"{label}: {gang} gang tasks bound in cycle 1")
    finally:
        cap.close()
    for name in ("water_fill", "allocate_solve_batch", "victim_step"):
        if first[name] < 1:
            raise AssertionError(f"{label}: kernel {name} not launched on the main path")
    for name in ("allocate_solve", "victim_step_sharded") + CONTENTION_KERNELS:
        if first[name]:
            raise AssertionError(f"{label}: kernel {name} launched ({first[name]})")
    if cache:
        _check_cache_reuse(label, splits)
    return first, dict(binds=list(sched.cache.bind_log), evicts=list(sched.cache.evict_log),
                       pipes=list(cap.pipes), walls=walls, splits=splits)


def phase_object_cfg5(no_cache=True):
    """cfg5-obj with the snapshot cache and, with ``no_cache``, without it:
    the same binds, evictions and pipelines.  Returns the cached run's
    first-cycle launches."""
    first, on = _object_cfg5("e2e cfg5-obj", True)
    if no_cache:
        # one cycle without the cache: cycle 2 binds nothing (all bind in
        # cycle 1), so the decisions compare whole; cut for the run's time
        _, off = _object_cfg5("e2e cfg5-obj, no cache", False, cycles=1)
        _same_decisions("cfg5-obj", on, off, keys=("binds", "evicts", "pipes"))
        _cache_summary("e2e cfg5-obj", on, off)
    return first


def _step_bound(c, s, t_req, out):
    """Bytes: every input read once (constants, state, request), the new
    state and the packed decision written once; operations: the victim
    core's per-row work over the live pool and the per-node score over the
    valid nodes."""
    import torch

    ins = [x for x in c if torch.is_tensor(x)] + list(s) + [t_req]
    b = nbytes(*ins) + nbytes(*out.state, out.packed)
    ops = int(s.run_live.sum()) * VICTIM_ROW_OPS + int(c.node_valid.sum()) * EXACT_NODE_OPS
    return bound_ms(b, ops)


#: operations of one comparison in the group build's per-node sorts (two
#: keys' loads, compare, select)
GROUP_CMP_OPS = 4


def _groups_bound(c, live, g):
    """Bytes: the constants the build reads (run_node, run_job, run_prio,
    run_rank, job_queue) and the live mask once, the offsets and the four
    lists written once; operations: each node's four sorts of its grouped
    rows, m log2 m comparisons each."""
    m = np.diff(g.node_off.cpu().numpy()).astype(np.float64)
    cmp = float((m * np.log2(np.maximum(m, 1))).sum()) * 4
    b = nbytes(c.run_node, c.run_job, c.run_prio, c.run_rank, c.job_queue, live, *g[:5])
    return bound_ms(b, cmp * GROUP_CMP_OPS)


def _plain_groups(label, g, c, live, mesh=None):
    """The plain grouping of the rows of ``live``; raises unless the
    groups ``g`` (built on the card) equal it field for field."""
    import torch

    from volcano_tpu_torch.scheduler import victim_kernels as VK

    want = VK.victim_groups_plain(c, live, order_by_priority=g.order_by_priority, mesh=mesh)
    for name, x, y in zip(VK.VictimGroups._fields[:5], g, want):
        if not torch.equal(x, y):
            raise AssertionError(f"{label}: groups {name} differ from the plain version")
    return want


def group_edge_sweep(dev):
    """The one group build (victim_groups_launch, one cluster launch)
    against its plain version (group_build_plain) on each of
    simargs.GROUP_EDGE_CASES (empty nodes, a node of 1,500 rows, 65,536
    node rows, out-of-range nodes, a live mask with holes), on 1 and 4
    node blocks, in every eviction order; returns the builds compared."""
    import itertools

    import torch

    from volcano_tpu_torch import _build, interop
    from volcano_tpu_torch.scheduler import victim_kernels as VK
    from volcano_tpu_torch.scheduler.simargs import GROUP_EDGE_CASES, build_group_edge_args

    lib, stream = _build.load(), VK._stream(dev)
    n = 0
    for case in GROUP_EDGE_CASES:
        c, s = interop.victim_from_arrays(*build_group_edge_args(case), dev)
        N = c.node_alloc.shape[0]
        for blocks, ev_kind in itertools.product((1, 4), VK.EV_KINDS):
            nb = N // blocks
            for b in range(blocks):
                kw = dict(ev_kind=ev_kind, n0=b * nb, nt=N)
                want = VK.group_build_plain(c, s.run_live, True, nb, **kw)
                got = VK.victim_groups_launch(lib, stream, c, s.run_live, True, nb, **kw)
                for name, x, y in zip(VK.VictimGroups._fields[:5], got, want):
                    if not torch.equal(x, y):
                        raise AssertionError(f"group build {case}, block {b} of {blocks}, "
                                             f"{ev_kind}: {name} differs from the plain version")
                n += 1
    log(f"[kernels] group build edge shapes ok: {n} builds over {len(GROUP_EDGE_CASES)} pools "
        f"on 1 and 4 blocks in {len(VK.EV_KINDS)} eviction orders, each equal to its plain "
        f"version")
    return n


def phase_victim_step_kernel(captured, launches):
    """K7 and the group build against their plain versions on the card: at
    bench config 4's shape (build_victim_sim(10000, 100000, 5000, seed=4),
    a [2000, 4Gi] preemptor of the reserved job 0, mode queue with the gang
    and drf vetoes), the groups of the live rows equal to
    victim_groups_plain, K7 warm (the groups held) and cold (built in the
    call), 16 solves timed each, and a chain of 32 solves over one grouping
    with the state fed back, each bit for bit the plain chain's; over the
    three modes and the five flags on small seeded inputs, cold and warm;
    and on the first inputs cfg6r-be gave it, warm and cold.  ``launches``:
    cfg6r-be's first-cycle launches."""
    import torch

    from volcano_tpu_torch import interop
    from volcano_tpu_torch.scheduler import victim_kernels as VK
    from volcano_tpu_torch.scheduler.simargs import build_victim_sim

    dev = torch.device("cuda")

    def plain_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    c_np, s_np = build_victim_sim(10_000, 100_000, 5_000, seed=4)
    c, s = interop.victim_from_arrays(c_np, s_np, dev)
    t_req = torch.tensor([2000.0, 4.0 * (1 << 30)], device=dev)
    kw = dict(mode="queue", use_gang=True, use_drf=True)

    def groups():
        return VK.victim_groups(c, s.run_live, order_by_priority=True)

    g = groups()
    g_p = _plain_groups("victim_groups config 4", g, c, s.run_live)
    _, g_plain_ms = plain_ms(lambda: VK.victim_groups_plain(c, s.run_live))
    g_ms = cuda_ms(groups, 16)
    g_b, g_kind = _groups_bound(c, s.run_live, g)
    log(f"[kernels] victim_groups config 4 ok: {int(g.node_off[-1])} rows on "
        f"{g.node_off.shape[0] - 1} nodes, equal to the plain version; {g_ms:.4f} ms over 16 "
        f"builds (plain {g_plain_ms:.1f} ms, bound {g_b:.5f} ms by {g_kind})")
    n_edge = group_edge_sweep(dev)

    def warm():
        return VK.victim_step(c, s, t_req, 0, 0, 0, groups=g, **kw)

    def cold():
        return VK.victim_step(c, s, t_req, 0, 0, 0, **kw)

    out_k = warm()
    out_p, p_ms = plain_ms(lambda: VK.victim_step_plain(c, s, t_req, 0, 0, 0, groups=g_p,
                                                        **kw))
    _, p_cold_ms = plain_ms(lambda: VK.victim_step_plain(c, s, t_req, 0, 0, 0, **kw))
    err = max(_blocked_compare("victim_step config 4, warm", out_k, out_p),
              _blocked_compare("victim_step config 4, cold", cold(), out_p))
    ms = cuda_ms(warm, 16)
    cold_ms = cuda_ms(cold, 16)
    b, kind = _step_bound(c, s, t_req, out_k)
    head = out_k.packed[:4].tolist()
    if not head[0]:
        raise AssertionError("victim_step config 4: never assigned")
    log(f"[kernels] victim_step config 4 ok: assigned {head[0]}, node {head[1]}, clean "
        f"{head[2]}, {head[3]} victims; warm {ms:.4f} ms, cold {cold_ms:.4f} ms over 16 solves "
        f"(plain {p_ms:.1f} ms given the groups, {p_cold_ms:.1f} ms building them; bound "
        f"{b:.5f} ms by {kind})")

    # a chain of 32 solves over one grouping, the state fed back on each
    # assignment (the decision read each step, as _VictimDriver does)
    rng = np.random.default_rng(4)
    chain = []
    for _ in range(32):
        jt = int(rng.integers(0, 5_000))
        chain.append((torch.tensor([float(rng.choice([1000, 2000, 4000])),
                                    float(rng.choice([1, 2, 4]) * (1 << 30))], device=dev),
                      jt, int(c_np["job_queue"][jt])))

    def run_chain(step):
        st, outs = s, []
        for tr, jt, qt in chain:
            out = step(st, tr, jt, qt)
            outs.append(out)
            if bool(out.packed[0]):
                st = out.state
        return outs

    outs_k, chain_wall = _timed(lambda: run_chain(
        lambda st, tr, jt, qt: VK.victim_step(c, st, tr, 0, jt, qt, groups=g, **kw)))
    outs_p = run_chain(
        lambda st, tr, jt, qt: VK.victim_step_plain(c, st, tr, 0, jt, qt, groups=g_p, **kw))
    for i, (ok, op) in enumerate(zip(outs_k, outs_p)):
        err = max(err, _blocked_compare(f"victim_step chain step {i}", ok, op))
    chain_ms = chain_wall / len(chain)
    n_ev = sum(int(o.packed[3]) for o in outs_p if bool(o.packed[0]))
    log(f"[kernels] victim_step chain of {len(chain)} solves over one grouping ok "
        f"({sum(int(o.packed[0]) for o in outs_p)} assigned, {n_ev} victims): {chain_ms:.4f} ms "
        "a solve (host wall, the decision read each step), equal to the plain chain bit for bit")

    n = n_assigned = 0
    for seed in range(2):
        cs, ss = interop.victim_from_arrays(*build_victim_sim(16, 120, 10, n_queues=3,
                                                              seed=seed), dev)
        gs = {obp: VK.victim_groups(cs, ss.run_live, order_by_priority=obp)
              for obp in (False, True)}
        for obp, gk in gs.items():
            _plain_groups(f"victim_groups sweep {seed} {obp}", gk, cs, ss.run_live)
        rng = np.random.default_rng(seed)
        for mode in ("queue", "job", "reclaim"):
            for flags in range(32):
                fkw = dict(use_gang=bool(flags & 1), use_drf=bool(flags & 2),
                           use_prop=bool(flags & 4), use_conformance=bool(flags & 8),
                           order_by_priority=bool(flags & 16))
                tr = torch.tensor([float(rng.choice([0, 500, 1500, 3000])),
                                   float(rng.choice([0, 512, 2048]) * (1 << 20))], device=dev)
                jt = int(rng.integers(0, 10))
                qt = int(cs.job_queue[jt])
                o_p = VK.victim_step_plain(cs, ss, tr, 0, jt, qt, mode=mode, **fkw)
                tag = f"victim_step sweep {seed} {mode} {fkw}"
                err = max(err, _blocked_compare(
                    tag + " cold", VK.victim_step(cs, ss, tr, 0, jt, qt, mode=mode, **fkw), o_p),
                    _blocked_compare(tag + " warm", VK.victim_step(
                        cs, ss, tr, 0, jt, qt, mode=mode, groups=gs[bool(flags & 16)], **fkw),
                        o_p))
                n += 1
                n_assigned += int(o_p.packed[0])
    log(f"[kernels] victim_step sweep ok: {n} small solves ({n_assigned} assigned), cold and "
        "warm, equal to the plain version")
    # reclaim mode with the drf veto on: the preemptor's share counts in any
    # mode; only cases where drf changes the plain decision are kept
    n_drf = 0
    for seed in range(4):
        cs, ss = interop.victim_from_arrays(*build_victim_sim(16, 120, 10, n_queues=3,
                                                              seed=seed), dev)
        for jt in range(10):
            qt = int(cs.job_queue[jt])
            for cpu in (500.0, 3000.0, 6000.0):
                tr = torch.tensor([cpu, 2048.0 * (1 << 20)], device=dev)
                o_p = VK.victim_step_plain(cs, ss, tr, 0, jt, qt, mode="reclaim", use_drf=True)
                o_off = VK.victim_step_plain(cs, ss, tr, 0, jt, qt, mode="reclaim",
                                             use_drf=False)
                if torch.equal(o_p.packed, o_off.packed):
                    continue
                o_k = VK.victim_step(cs, ss, tr, 0, jt, qt, mode="reclaim", use_drf=True)
                err = max(err, _blocked_compare(f"victim_step reclaim+drf {seed} {jt} {cpu}",
                                                o_k, o_p))
                n_drf += 1
    if not n_drf:
        raise AssertionError("victim_step: no reclaim-mode case where drf decides")
    log(f"[kernels] victim_step reclaim mode with drf ok: {n_drf} solves where the veto "
        f"changes the decision, equal to the plain version")

    args, ckw = captured
    c2, s2, tr2 = args[0], args[1], args[2]
    if "groups" not in ckw:
        raise AssertionError("victim_step cfg6r-be: the object path passed no groups")
    cold_kw = {k: v for k, v in ckw.items() if k != "groups"}
    # _VictimDriver grouped the rows live at its load, the first attempt's
    g2_p = _plain_groups("victim_groups cfg6r-be", ckw["groups"], c2, s2.run_live)
    o_k = VK.victim_step(*args, **ckw)
    o_p, p2_ms = plain_ms(lambda: VK.victim_step_plain(*args, **cold_kw, groups=g2_p))
    err = max(err, _blocked_compare("victim_step cfg6r-be, warm", o_k, o_p),
              _blocked_compare("victim_step cfg6r-be, cold", VK.victim_step(*args, **cold_kw),
                               o_p))
    ms2 = cuda_ms(lambda: VK.victim_step(*args, **ckw), 16)
    cold_ms2 = cuda_ms(lambda: VK.victim_step(*args, **cold_kw), 16)
    b2, kind2 = _step_bound(c2, s2, tr2, o_k)
    log(f"[kernels] victim_step cfg6r-be first inputs ok ({ckw['mode']}, decision "
        f"{o_k.packed[:4].tolist()}): warm {ms2:.4f} ms, cold {cold_ms2:.4f} ms (plain "
        f"{p2_ms:.1f} ms, bound {b2:.5f} ms by {kind2})")
    src = "volcano_tpu_torch/csrc/victim_step.cu"
    return {"victim_groups": dict(
        name="victim_groups", route="cuda", source=src,
        replaces="volcano_tpu/scheduler/victim_kernels.py:131", launches=launches[GROUP_KERNEL],
        max_abs_err=0.0, ms=g_ms, plain_ms=g_plain_ms, bound_ms=g_b, bound_by=g_kind,
        library_ms=None, cell="config 4 shape, the live rows; launches: cfg6r-be cycle 1",
        edge_builds=n_edge),
        "victim_step": dict(
        name="victim_step", route="cuda", source=src,
        replaces="volcano_tpu/scheduler/victim_kernels.py:362", launches=launches["victim_step"],
        max_abs_err=err, ms=ms, plain_ms=p_ms, bound_ms=b, bound_by=kind, library_ms=None,
        cell="config 4 shape, warm; launches: cfg6r-be cycle 1", cold_ms=cold_ms,
        plain_cold_ms=p_cold_ms, chain_ms=chain_ms, cfg6r_be_ms=ms2, cfg6r_be_cold_ms=cold_ms2,
        cfg6r_be_plain_ms=p2_ms, cfg6r_be_bound_ms=b2)}


# ---- the shape caps lifted, and the node-sharded cycle (K12a) at cfg9 -------

# cfg9 (bench.py N_NODES9, N_TASKS9, CFG9_NAMESPACES, _build_shard_e2e_store)
CFG9 = dict(nodes=100_000, tasks=1_000_000, tasks_per_job=20, namespaces=16, queues=2)
#: the main run's cfg9 (phases 16, 17 and 20): 1/10 of the nodes and tasks,
#: cut for the run's time limit when phases 29 (to 3/10) and 30-31 (to
#: 1/10) came (PERF.md section 4); --publish-split runs CFG9
CFG9_MAIN = dict(CFG9, nodes=10_000, tasks=100_000)
#: the conf mesh of the cfg9 cell (bench.py config9_shard sets conf.mesh)
CFG9_MESH = "4"
#: the conf mesh of the cfg6r-be-mesh cell
CFG6R_BE_MESH = "4"
#: local meshes the sharded cycle runs on at cfg9's captured solve inputs
MESH_BLOCKS = (1, 2, 4, 8)


def _solve_inputs_np(a):
    """build_sim_args arrays on the card plus the K1 deserved shares."""
    import torch

    from volcano_tpu_torch.scheduler import kernels as K

    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to("cuda") for k, v in a.items()}
    des = K.water_fill(t["queue_weight"], t["queue_request"], t["total"], t["eps"],
                       t["queue_participates"])
    return {k: (des if k == "queue_deserved" else t[k]) for k in K._SOLVE_ARGS}


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_cap_lifts():
    """The shapes the card refused before the tiled solves, each against its
    plain version on the same inputs: K3 at 65,536- and 131,072-node
    buckets, K10 at 65,536 nodes, K2 with 128 queues, K1 with Q*R = 2,048
    cells."""
    import torch

    from volcano_tpu_torch import interop
    from volcano_tpu_torch.scheduler import kernels as K
    from volcano_tpu_torch.scheduler import victim_kernels as VK
    from volcano_tpu_torch.scheduler.simargs import (
        build_sim_args, build_storm_sim, storm_inputs,
    )

    opts = dict(job_key_order=("priority", "gang", "drf"), use_gang_ready=True,
                use_proportion=True)
    res = {}
    for n_nodes in (40_000, 100_000):
        si = _solve_inputs_np(build_sim_args(n_nodes, 100_000, 5_000, seed=9))
        N = si["idle"].shape[0]
        args = [si[k] for k in K._SOLVE_ARGS] + [1.0, 1.0]
        out_k = K.allocate_solve_batch(*args, **opts)
        out_p, p_ms = _timed(lambda: K.allocate_solve_batch_plain(
            **si, w_least=1.0, w_balanced=1.0, **opts))
        err = _compare(f"allocate_solve_batch N={N}", out_k, out_p)
        ms = cuda_ms(lambda: K.allocate_solve_batch(*args, **opts), 2)
        placed = int((out_k.task_kind > 0).sum())
        res[f"K3@{N}"] = dict(ms=ms, plain_ms=p_ms, rounds=int(out_k.steps), err=err)
        log(f"[caps] allocate_solve_batch at a {N}-node bucket ({n_nodes} valid) ok: "
            f"{int(out_k.steps)} rounds, {placed} placed, {ms:.3f} ms (plain {p_ms:.1f} ms), "
            f"max abs err {err}")

    c_np, s_np, t_np = build_storm_sim(0, n_nodes=40_000, n_victims=120_000, n_jobs=3_000,
                                       n_new=64)
    c, st = interop.victim_from_arrays(c_np, s_np, torch.device("cuda"))
    sargs = [x if isinstance(x, int) else torch.from_numpy(np.asarray(x)).to("cuda")
             for x in storm_inputs("rounds", c_np, s_np, t_np)]
    kw = dict(use_gang=True, use_drf=True, use_conformance=True, order_by_priority=True)
    out_k = VK.preempt_rounds(c, st, *sargs, **kw)
    out_p, p_ms = _timed(lambda: VK.preempt_rounds_plain(c, st, *sargs, **kw))
    err = _victim_compare("preempt_rounds N=65536", out_k, out_p)
    ms = cuda_ms(lambda: VK.preempt_rounds(c, st, *sargs, **kw), 2)
    N = c.node_alloc.shape[0]
    res[f"K10@{N}"] = dict(ms=ms, plain_ms=p_ms, err=err)
    log(f"[caps] preempt_rounds at a {N}-node bucket ok: {ms:.3f} ms (plain {p_ms:.1f} ms), "
        f"max abs err {err}")

    si = _solve_inputs_np(build_sim_args(10_000, 4_000, 200, n_queues=128, seed=5))
    Q = si["queue_alloc_init"].shape[0]
    args = [si[k] for k in K._SOLVE_ARGS] + [1.0, 1.0]
    out_k = K.allocate_solve(*args, **opts)
    out_p, p_ms = _timed(lambda: K.allocate_solve_plain(**si, w_least=1.0, w_balanced=1.0,
                                                        **opts))
    err = _compare(f"allocate_solve Q={Q}", out_k, out_p)
    ms = cuda_ms(lambda: K.allocate_solve(*args, **opts), 2)
    res[f"K2@Q{Q}"] = dict(ms=ms, plain_ms=p_ms, steps=int(out_k.steps), err=err)
    log(f"[caps] allocate_solve with {Q} queues ok: {int(out_k.steps)} steps, {ms:.3f} ms "
        f"(plain {p_ms:.1f} ms)")

    a = build_sim_args(1_000, 4_000, 2_000, n_queues=600, seed=6)
    t = {k: torch.from_numpy(np.ascontiguousarray(a[k])).to("cuda")
         for k in ("queue_weight", "queue_request", "total", "eps", "queue_participates")}
    wf = (t["queue_weight"], t["queue_request"], t["total"], t["eps"], t["queue_participates"])
    des_k = K.water_fill(*wf)
    des_p, p_ms = _timed(lambda: K.water_fill_plain(*wf))
    cells = t["queue_request"].numel()
    if cells <= 1024 or not torch.equal(des_k, des_p):
        raise AssertionError(f"water_fill with {cells} cells: kernel != plain or no lift")
    ms = cuda_ms(lambda: K.water_fill(*wf), 20)
    res[f"K1@{cells}"] = dict(ms=ms, plain_ms=p_ms, err=0.0)
    log(f"[caps] water_fill with Q*R = {cells} cells ok: {ms:.4f} ms (plain {p_ms:.2f} ms)")
    return res


@_no_gc
def build_cfg9_store(n_nodes=CFG9["nodes"], n_tasks=CFG9["tasks"],
                     tasks_per_job=CFG9["tasks_per_job"], n_namespaces=CFG9["namespaces"],
                     n_queues=CFG9["queues"]):
    """bench.py _build_shard_e2e_store with the port's objects: the same
    rng(9) draws, n_queues weighted queues (plus "default"), gangs of 20
    over 16 namespaces, PodGroups Pending (enqueue admits them)."""
    from volcano_tpu_torch.api import (
        POD_GROUP_KEY, Metadata, Node, Pod, PodGroup, PodGroupPhase, PodSpec, Queue, Resource,
    )
    from volcano_tpu_torch.store import Store

    rng = np.random.default_rng(9)
    n_jobs = max(n_tasks // tasks_per_job, 1)
    node_cpu = rng.choice([16000, 32000], n_nodes)
    node_mem = rng.choice([32, 64], n_nodes) * (1 << 30)
    cpus = rng.choice([250, 500, 1000, 2000], n_tasks)
    mems = rng.choice([256, 512, 1024, 2048], n_tasks) * (1 << 20)

    store = Store()
    for q in range(n_queues):
        store.create("Queue", Queue(meta=Metadata(name=f"q{q}", namespace=""),
                                    weight=n_queues - q))
    store.create("Queue", Queue(meta=Metadata(name="default", namespace=""), weight=1))
    for i in range(n_nodes):
        store.create("Node", Node(meta=Metadata(name=f"n{i:06d}", namespace=""),
                                  allocatable=Resource(float(node_cpu[i]), float(node_mem[i]),
                                                       max_task_num=110)))
    k = 0
    for j in range(n_jobs):
        ns = f"team{j % n_namespaces}"
        pg = PodGroup(meta=Metadata(name=f"pg{j:06d}", namespace=ns),
                      min_member=min(tasks_per_job, n_tasks - k), queue=f"q{j % n_queues}")
        pg.status.phase = PodGroupPhase.PENDING
        store.create("PodGroup", pg)
        ann = {POD_GROUP_KEY: f"pg{j:06d}"}
        for _t in range(min(tasks_per_job, n_tasks - k)):
            store.create("Pod", Pod(
                meta=Metadata(name=f"p{k:07d}", namespace=ns, annotations=dict(ann)),
                spec=PodSpec(resources=Resource(float(cpus[k]), float(mems[k])))))
            k += 1
        if k >= n_tasks:
            break
    return store


def check_cfg9_placement(store):
    """No node over its allocatable or pod cap; every gang all or nothing.
    Returns the tasks bound."""
    from volcano_tpu_torch.api import POD_GROUP_KEY

    nodes = [(n.meta.name, n.allocatable.milli_cpu, n.allocatable.memory,
              n.allocatable.max_task_num) for n in store.list("Node")]
    pods = [(p.meta.namespace, p.meta.annotations.get(POD_GROUP_KEY, ""), p.node_name,
             p.spec.resources.milli_cpu, p.spec.resources.memory) for p in store.list("Pod")]
    return check_placement_rows(nodes, pods)


def check_placement_rows(nodes, pods):
    """check_cfg9_placement over rows: ``nodes`` (name, cpu, memory, pod
    cap), ``pods`` (namespace, group, node or "", cpu, memory)."""
    index = {}
    cap = []
    for i, (name, cpu, mem, max_pods) in enumerate(nodes):
        index[name] = i
        cap.append((cpu, mem, max_pods))
    cap = np.array(cap)
    used = np.zeros_like(cap)
    per_gang, size = {}, {}
    for ns, group, node_name, cpu, mem in pods:
        g = (ns, group)
        size[g] = size.get(g, 0) + 1
        if not node_name:
            continue
        used[index[node_name]] += (cpu, mem, 1)
        per_gang[g] = per_gang.get(g, 0) + 1
    over = np.nonzero((used > cap).any(axis=1))[0]
    if over.size:
        raise AssertionError(f"cfg9: {over.size} nodes over capacity, e.g. row {over[0]}")
    partial = [g for g, c in per_gang.items() if c != size[g]]
    if partial:
        raise AssertionError(f"cfg9: gangs bound partially: {partial[:5]}")
    return sum(per_gang.values())


def phase_cfg9(cfg=CFG9_MAIN):
    """cfg9 end to end (``cfg``: its nodes and tasks, CFG9_MAIN in the main
    run): the nodes, the cfg9 tasks in gangs of 20,
    full_conf("cuda") with mesh "4" and solve_mode auto (the batched solve
    runs: the pending tasks are far above the exact threshold).  Launch
    counts reset just before cycle 1 and read just after; every gang task
    bound within two cycles, the placement invariants after each; returns
    the launches and the first solve's captured (backend, snapshot,
    decisions)."""
    import torch

    from volcano_tpu_torch.scheduler.conf import full_conf
    from volcano_tpu_torch.scheduler.fastpath import cycle as cycle_mod
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    t0 = time.perf_counter()
    store = build_cfg9_store(cfg["nodes"], cfg["tasks"])
    log(f"[e2e cfg9] store built: {cfg['nodes']} nodes, {cfg['tasks']} tasks in gangs of "
        f"{cfg['tasks_per_job']} over {cfg['namespaces']} namespaces "
        f"({time.perf_counter() - t0:.1f} s)")
    conf = async_conf(full_conf("cuda"))
    conf.mesh = CFG9_MESH
    sched = Scheduler(store, conf=conf)
    if sched.mesh is None or sched.mesh.size != int(CFG9_MESH):
        raise AssertionError(f"cfg9: mesh {CFG9_MESH} resolved to {sched.mesh}")
    log(f"[e2e cfg9] mesh {sched.mesh}; prewarm {sched.prewarm(background=False):.2f} s")
    solve = cycle_mod.torch_allocate_solve
    captured = []

    def recording(backend, snap, n_pending=None):
        out = solve(backend, snap, n_pending)
        if not captured:
            captured.append((backend, snap, out))
        return out

    cycle_mod.torch_allocate_solve = recording
    try:
        reset_launches()
        t0 = time.perf_counter()
        sched.run_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        cycle_mod.torch_allocate_solve = solve
    phases = {k: round(v, 4) for k, v in sched.fast_cycle.phases.items()}
    log(f"[e2e cfg9] cycle 1 wall {wall:.3f} s phases {json.dumps(phases)} "
        f"launches {launches}")
    for name in ("water_fill", "allocate_solve_batch", "sharded_cycle"):
        if launches[name] < 1:
            raise AssertionError(f"cfg9: kernel {name} launched {launches[name]} times")
    for name in ("allocate_solve",) + CONTENTION_KERNELS + OBJECT_FORBID:
        if launches[name]:
            raise AssertionError(f"cfg9: kernel {name} launched ({launches[name]})")
    if sched.last_path != "fast" or not captured:
        raise AssertionError(f"cfg9: cycle 1 took the {sched.last_path} path")
    publish_report("e2e cfg9", sched, flush_applier("e2e cfg9", sched, CFG9_FLUSH_TIMEOUT_S))
    t0 = time.perf_counter()
    bound = check_cfg9_placement(store)
    log(f"[e2e cfg9] bound after cycle 1: {bound} of {cfg['tasks']} "
        f"(checked in {time.perf_counter() - t0:.1f} s)")
    cycles = 1
    while bound < cfg["tasks"] and cycles < MAX_CYCLES:
        cycles += 1
        t0 = time.perf_counter()
        sched.run_once()
        log(f"[e2e cfg9] cycle {cycles} wall {time.perf_counter() - t0:.3f} s phases "
            f"{json.dumps({k: round(v, 4) for k, v in sched.fast_cycle.phases.items()})}")
        publish_report("e2e cfg9", sched,
                       flush_applier("e2e cfg9", sched, CFG9_FLUSH_TIMEOUT_S), cycles)
        bound = check_cfg9_placement(store)
        log(f"[e2e cfg9] bound after cycle {cycles}: {bound}")
    if bound != cfg["tasks"]:
        raise AssertionError(f"cfg9: {bound} of {cfg['tasks']} gang tasks bound after "
                             f"{cycles} cycles")
    log(f"[e2e cfg9] all bound in {cycles} cycle(s) (deadline {MAX_CYCLES})")
    sched.close()
    return launches, captured[0]


def phase_sharded_kernels(captured, launches):
    """K12a on the card at cfg9's captured solve inputs (the cycle's first
    batched solve): the one-block tiled K3 against its plain version and
    against the cycle's own decisions; the sharded solve on local meshes of
    1, 2, 4 and 8 blocks and its plain version on the cell's four, each bit
    for bit equal to the one-block run; a one-rank NCCL process group
    (FileStore rendezvous) running the cell's mesh over
    all_gather_into_tensor.  CUDA-event times."""
    import torch
    import torch.distributed as dist

    from volcano_tpu_torch import _build
    from volcano_tpu_torch.parallel import sharded as S
    from volcano_tpu_torch.scheduler import kernels as K
    from volcano_tpu_torch.scheduler.tensor_actions import solve_inputs
    from volcano_tpu_torch.scheduler.tensor_backend import TensorBackend

    backend, snap, decisions = captured
    one = TensorBackend(backend.tiers, backend.device, backend.to_device,
                        solve_mode=backend.solve_mode)
    one.snapshot = snap
    one._deserved = backend.deserved()
    inputs = solve_inputs(one, snap, True)
    w_least, w_balanced = one.score_weights()
    policy = dict(job_key_order=one.job_key_order, use_gang_ready=one.gang_job_ready,
                  use_proportion=one.proportion_queue_order)
    args = [inputs[k] for k in K._SOLVE_ARGS] + [w_least, w_balanced]
    N = inputs["idle"].shape[0]
    T, J = inputs["task_req"].shape[0], inputs["job_queue"].shape[0]

    ref = K.allocate_solve_batch(*args, **policy)
    packed = K.pack_outputs(ref).cpu().numpy()
    for name, got, want in zip(("task_node", "task_kind", "task_seq", "ready"), decisions,
                               (packed[:T], packed[T:2 * T], packed[2 * T:3 * T],
                                packed[3 * T:3 * T + J])):
        if not np.array_equal(got, want):
            raise AssertionError(f"cfg9: the cycle's sharded {name} != the one-block K3's")
    k3_ms = cuda_ms(lambda: K.allocate_solve_batch(*args, **policy), 2)
    plain, k3_plain_ms = _timed(lambda: K.allocate_solve_batch_plain(
        **inputs, w_least=w_least, w_balanced=w_balanced, **policy))
    err = _compare("allocate_solve_batch cfg9", ref, plain)
    rounds, placed = int(ref.steps), int((ref.task_kind > 0).sum())
    log(f"[sharded] one-block tiled K3 at cfg9 ({N}-node bucket, {T} task rows, {J} job "
        f"rows) ok: {rounds} rounds, {placed} placed, {k3_ms:.3f} ms (plain "
        f"{k3_plain_ms:.1f} ms); equal to the cycle's mesh-{CFG9_MESH} decisions")

    repl = {k: inputs[k] for k in K._SOLVE_ARGS if k not in K.NODE_PLANES}
    ms, plain_ms = {}, {}
    for n in MESH_BLOCKS:
        mesh = S.LocalMesh(n, torch.device("cuda"))
        planes = {k: S.split_rows(mesh, k, inputs[k]) for k in K.NODE_PLANES}

        def run(mesh=mesh, planes=planes):
            return S.sharded_solve(mesh, planes, repl, w_least, w_balanced, **policy)

        out_n = run()
        err = max(err, _compare(f"sharded_cycle {n} blocks", out_n, ref))
        if n == int(CFG9_MESH):
            # phase 20 holds the multihost cycle to this run's outputs
            outputs = S.fetch_outputs(out_n, mesh)
        del out_n
        ms[n] = cuda_ms(run, 2)
        if n != int(CFG9_MESH):
            # the plain version runs on the cell's blocks only (5-7 s a run at
            # this shape; cut for the run's time)
            log(f"[sharded] local mesh of {n} blocks ok: {ms[n]:.3f} ms, equal to the "
                "one-block K3")
            continue
        plain_s, plain_ms[n] = _timed(lambda: S.batch_blocks_plain(
            repl, S._blocks(mesh, planes), n, mesh.exchange, w_least, w_balanced, **policy))
        err = max(err, _compare(f"sharded_cycle plain {n} blocks", plain_s, ref))
        del plain_s
        log(f"[sharded] local mesh of {n} blocks ok: {ms[n]:.3f} ms (plain version on the "
            f"same blocks {plain_ms[n]:.1f} ms), both equal to the one-block K3")

    # the rendezvous file lives in the checkout's build directory
    store_path = _build.BUILD_DIR / f"nccl_store_{os.getpid()}"
    store_path.parent.mkdir(parents=True, exist_ok=True)
    if store_path.exists():
        store_path.unlink()
    dist.init_process_group("nccl", store=dist.FileStore(str(store_path), 1),
                            rank=0, world_size=1)
    try:
        gmesh = S.make_mesh(int(CFG9_MESH))
        if not isinstance(gmesh, S.GroupMesh) or gmesh.n_local != int(CFG9_MESH):
            raise AssertionError(f"NCCL mesh: {gmesh}")
        gplanes = {k: S.split_rows(gmesh, k, inputs[k]) for k in K.NODE_PLANES}

        def grun():
            return S.sharded_solve(gmesh, gplanes, repl, w_least, w_balanced, **policy)

        gout = grun()
        err = max(err, _compare("sharded_cycle NCCL group", gout, ref))
        gms = cuda_ms(grun, 2)
        out_rows = S.fetch_outputs(gout, gmesh)
        if not np.array_equal(out_rows[6], ref.idle.cpu().numpy()):
            raise AssertionError("NCCL mesh: gathered idle rows != the one-block run's")
        log(f"[sharded] one-rank NCCL group, {gmesh.size} blocks over all_gather_into_tensor "
            f"ok: {gms:.3f} ms")
    finally:
        dist.destroy_process_group()
        if store_path.exists():
            store_path.unlink()

    mesh = S.LocalMesh(int(CFG9_MESH), torch.device("cuda"))
    planes = {k: S.split_rows(mesh, k, inputs[k]) for k in K.NODE_PLANES}
    split = batch_split(f"K12a at cfg9, local mesh of {CFG9_MESH} blocks",
                        lambda: S.sharded_solve(mesh, planes, repl, w_least, w_balanced,
                                                **policy))
    del planes
    io = nbytes(*inputs.values()) + nbytes(*ref[:10])
    n_sort_keys = len(policy["job_key_order"]) + 2 + int(policy["use_proportion"])
    M, P = min(512, J), 16
    b, kind = bound_ms(io, _batch_solve_ops(ref, inputs, M, P, n_sort_keys))
    log(f"[sharded] bound {b:.4f} ms by {kind}; local-mesh ms by blocks "
        f"{json.dumps({k: round(v, 3) for k, v in ms.items()})}")
    return outputs, {"sharded_cycle": dict(
        name="sharded_cycle", route="cuda", source="volcano_tpu_torch/csrc/allocate_batch.cu",
        replaces="volcano_tpu/parallel/sharded.py:152", launches=launches["sharded_cycle"],
        max_abs_err=err, ms=ms[int(CFG9_MESH)], plain_ms=plain_ms[int(CFG9_MESH)], bound_ms=b,
        bound_by=kind, library_ms=None,
        cell=f"cfg9 captured inputs, local mesh of {CFG9_MESH} blocks",
        ms_by_blocks={str(k): v for k, v in ms.items()},
        plain_ms_by_blocks={str(k): v for k, v in plain_ms.items()}, nccl_group_ms=gms,
        one_block_k3_ms=k3_ms, one_block_k3_plain_ms=k3_plain_ms, rounds=rounds,
        ms_per_round=ms[int(CFG9_MESH)] / max(rounds, 1), split=split)}


# ---- the victim solve on node blocks (K12b) and the multi-controller cycle (K13)

def _unblock(tup):
    """A VictimConsts / VictimState with its node-plane blocks joined."""
    import torch

    def join(name, x):
        if not isinstance(x, tuple):
            return x
        return torch.cat(list(x), dim=1 if name in ("class_mask", "class_score") else 0)

    return type(tup)(**{f: join(f, getattr(tup, f)) for f in tup._fields})


def _blocked_compare(name, out_k, out_p):
    """The packed decision and every state field bit for bit (node planes
    as their blocks' rows); returns the largest float difference (0)."""
    import torch

    if not torch.equal(out_k.packed, out_p.packed.to(out_k.packed.device)):
        raise AssertionError(f"{name}: decision {out_k.packed[:4].tolist()} != "
                             f"{out_p.packed[:4].tolist()} or victim masks differ")
    sk, sp = _unblock(out_k.state), _unblock(out_p.state)
    err = 0.0
    for f in sk._fields:
        x, y = getattr(sk, f), getattr(sp, f).to(getattr(sk, f).device)
        if x.dtype.is_floating_point and x.numel():
            err = max(err, float((x - y).abs().max()))
        if not torch.equal(x, y):
            raise AssertionError(f"{name}: state {f} differs")
    return err


def phase_victim_sharded_kernel(captured, launches):
    """K12b on the card: at bench config 4's shape (build_victim_sim(10000,
    100000, 5000, seed=4), the [2000, 4Gi] preemptor of phase 13) on local
    meshes of 1, 2, 4 and 8 blocks, each bit for bit equal to its plain
    version on the same blocks and to the one-block K7, state included (16
    solves timed warm, over one grouping of the pool, and cold); a chain
    of 16 solves over one grouping with the blocked state fed back, timed,
    equal to the one-block K7 chain; the three modes and the veto and
    order flags on small seeded inputs on 2, 4 and 8 blocks; a one-rank
    NCCL group (FileStore rendezvous) running four blocks; the first inputs
    cfg6r-be-mesh gave it."""
    import torch
    import torch.distributed as dist

    from volcano_tpu_torch import _build, interop
    from volcano_tpu_torch.parallel import sharded as S
    from volcano_tpu_torch.scheduler import victim_kernels as VK
    from volcano_tpu_torch.scheduler.simargs import build_victim_sim

    dev = torch.device("cuda")
    c_np, s_np = build_victim_sim(10_000, 100_000, 5_000, seed=4)
    c, s = interop.victim_from_arrays(c_np, s_np, dev)
    N = c.node_alloc.shape[0]
    t_req = torch.tensor([2000.0, 4.0 * (1 << 30)], device=dev)
    kw = dict(mode="queue", use_gang=True, use_drf=True)
    one = VK.victim_step(c, s, t_req, 0, 0, 0, **kw)
    err, ms, plain_ms, cold_ms = 0.0, {}, {}, {}
    for n in MESH_BLOCKS:
        mesh = S.LocalMesh(n, dev)
        _, dc, ds = S.make_sharded_victim_step(mesh, c, s)
        g = VK.victim_groups(dc, ds.run_live, mesh=mesh)
        g_p = _plain_groups(f"K12b groups, {n} blocks", g, dc, ds.run_live, mesh)

        def run(mesh=mesh, dc=dc, ds=ds, **gkw):
            return VK.victim_step_sharded(dc, ds, t_req, 0, 0, 0, mesh, **kw, **gkw)

        out_k = run(groups=g)
        out_p, plain_ms[n] = _timed(lambda: S.victim_blocks_plain(
            dc, ds, t_req, 0, 0, 0, mesh, N // n, groups=g_p, **kw))
        err = max(err, _blocked_compare(f"K12b config 4, {n} blocks vs plain", out_k, out_p),
                  _blocked_compare(f"K12b config 4, {n} blocks vs K7", out_k, one),
                  _blocked_compare(f"K12b config 4, {n} blocks cold", run(), one))
        ms[n] = cuda_ms(lambda: run(groups=g), 16)
        cold_ms[n] = cuda_ms(run, 16)
        log(f"[K12b] config 4 on {n} blocks ok (decision {out_k.packed[:4].tolist()}): warm "
            f"{ms[n]:.4f} ms, cold {cold_ms[n]:.4f} ms over 16 solves (plain on the same blocks "
            f"{plain_ms[n]:.1f} ms), equal to the plain version and to K7 bit for bit")
    b, kind = _step_bound(c, s, t_req, one)

    # a chain of 16 solves, the blocked state fed back on each assignment
    mesh = S.LocalMesh(int(CFG6R_BE_MESH), dev)
    _, dc, ds = S.make_sharded_victim_step(mesh, c, s)
    g = VK.victim_groups(dc, ds.run_live, mesh=mesh)
    g1 = VK.victim_groups(c, s.run_live)
    _plain_groups("K12b chain groups", g, dc, ds.run_live, mesh)
    _plain_groups("K7 chain groups", g1, c, s.run_live)
    rng = np.random.default_rng(4)
    chain = []
    for _ in range(16):
        jt = int(rng.integers(0, 5_000))
        chain.append((torch.tensor([float(rng.choice([1000, 2000, 4000])),
                                    float(rng.choice([1, 2, 4]) * (1 << 30))], device=dev),
                      jt, int(c_np["job_queue"][jt])))

    def run_chain(ds, step):
        outs = []
        for tr, jt, qt in chain:
            out = step(ds, tr, jt, qt)
            outs.append(out)
            if bool(out.packed[0]):
                ds = out.state
        return outs

    outs_k, chain_wall = _timed(lambda: run_chain(
        ds, lambda st, tr, jt, qt: VK.victim_step_sharded(dc, st, tr, 0, jt, qt, mesh,
                                                          groups=g, **kw)))
    outs_1 = run_chain(s, lambda st, tr, jt, qt: VK.victim_step(c, st, tr, 0, jt, qt,
                                                                groups=g1, **kw))
    for i, (ok, o1) in enumerate(zip(outs_k, outs_1)):
        err = max(err, _blocked_compare(f"K12b chain step {i}", ok, o1))
    chain_ms = chain_wall / len(chain)
    log(f"[K12b] chain of {len(chain)} solves on {mesh.size} blocks ok "
        f"({sum(int(o.packed[0]) for o in outs_1)} assigned): {chain_ms:.4f} ms a solve "
        "(host wall, the decision read each step), equal to the K7 chain bit for bit")

    n_small = 0
    for seed in range(2):
        cs, ss = interop.victim_from_arrays(*build_victim_sim(16, 120, 10, n_queues=3,
                                                              seed=seed), dev)
        rng = np.random.default_rng(seed)
        for n in (2, 4, 8):
            smesh = S.LocalMesh(n, dev)
            _, dcs, dss = S.make_sharded_victim_step(smesh, cs, ss)
            for mode in ("queue", "job", "reclaim"):
                for flags in range(0, 32, 3):
                    fkw = dict(mode=mode, use_gang=bool(flags & 1), use_drf=bool(flags & 2),
                               use_prop=bool(flags & 4), use_conformance=bool(flags & 8),
                               order_by_priority=bool(flags & 16))
                    tr = torch.tensor([float(rng.choice([0, 500, 1500, 3000])),
                                       float(rng.choice([0, 512, 2048]) * (1 << 20))],
                                      device=dev)
                    jt = int(rng.integers(0, 10))
                    qt = int(cs.job_queue[jt])
                    o_k = VK.victim_step_sharded(dcs, dss, tr, 0, jt, qt, smesh, **fkw)
                    tag = f"K12b sweep {seed} {n} blocks {fkw}"
                    err = max(err, _blocked_compare(tag, o_k, S.victim_blocks_plain(
                        dcs, dss, tr, 0, jt, qt, smesh, 16 // n, **fkw)),
                        _blocked_compare(tag, o_k, VK.victim_step(cs, ss, tr, 0, jt, qt, **fkw)))
                    n_small += 1
    log(f"[K12b] sweep ok: {n_small} small solves on 2, 4 and 8 blocks equal to the plain "
        "version and to K7")

    store_path = _build.BUILD_DIR / f"nccl_store_k12b_{os.getpid()}"
    store_path.parent.mkdir(parents=True, exist_ok=True)
    if store_path.exists():
        store_path.unlink()
    dist.init_process_group("nccl", store=dist.FileStore(str(store_path), 1),
                            rank=0, world_size=1)
    try:
        gmesh = S.make_mesh(int(CFG6R_BE_MESH))
        if not isinstance(gmesh, S.GroupMesh) or gmesh.n_local != gmesh.size:
            raise AssertionError(f"NCCL mesh: {gmesh}")
        _, gc, gs = S.make_sharded_victim_step(gmesh, c, s)
        gg = VK.victim_groups(gc, gs.run_live, mesh=gmesh)
        _plain_groups("K12b NCCL group groups", gg, gc, gs.run_live, gmesh)

        def grun():
            return VK.victim_step_sharded(gc, gs, t_req, 0, 0, 0, gmesh, groups=gg, **kw)

        err = max(err, _blocked_compare("K12b NCCL group", grun(), one))
        gms = cuda_ms(grun, 16)
        log(f"[K12b] one-rank NCCL group, {gmesh.size} blocks over all_gather_into_tensor ok: "
            f"{gms:.4f} ms")
    finally:
        dist.destroy_process_group()
        if store_path.exists():
            store_path.unlink()

    args, ckw = captured
    cc, cs_, ctr, ct_cls, cjt, cqt, cmesh = args
    cnb = _unblock(cc).node_alloc.shape[0] // cmesh.size
    cold_kw = {k: v for k, v in ckw.items() if k != "groups"}
    cg_p = _plain_groups("K12b cfg6r-be-mesh groups", ckw["groups"], cc, cs_.run_live, cmesh)
    o_k = VK.victim_step_sharded(*args, **ckw)
    o_p, p2_ms = _timed(lambda: S.victim_blocks_plain(cc, cs_, ctr, ct_cls, cjt, cqt, cmesh, cnb,
                                                      groups=cg_p, **cold_kw))
    err = max(err, _blocked_compare("K12b cfg6r-be-mesh vs plain", o_k, o_p),
              _blocked_compare("K12b cfg6r-be-mesh vs K7", o_k, VK.victim_step(
                  _unblock(cc), _unblock(cs_), ctr, ct_cls, cjt, cqt, **ckw)))
    ms2 = cuda_ms(lambda: VK.victim_step_sharded(*args, **ckw), 16)
    b2, kind2 = _step_bound(_unblock(cc), _unblock(cs_), ctr,
                            VK.VictimStepOut(_unblock(o_p.state), o_p.packed))
    log(f"[K12b] cfg6r-be-mesh first inputs ok ({ckw['mode']}, {cmesh}, decision "
        f"{o_k.packed[:4].tolist()}): {ms2:.4f} ms (plain {p2_ms:.1f} ms, bound {b2:.5f} ms by "
        f"{kind2}); config 4 bound {b:.5f} ms by {kind}")
    m = int(CFG6R_BE_MESH)
    return {"victim_step_sharded": dict(
        name="victim_step_sharded", route="cuda", source="volcano_tpu_torch/csrc/victim_step.cu",
        replaces="volcano_tpu/parallel/sharded.py:202", launches=launches, max_abs_err=err,
        ms=ms[m], plain_ms=plain_ms[m], bound_ms=b, bound_by=kind, library_ms=None,
        cell=f"config 4 shape, local mesh of {m} blocks, warm; launches: cfg6r-be-mesh cycle 1",
        ms_by_blocks={str(k): v for k, v in ms.items()},
        cold_ms_by_blocks={str(k): v for k, v in cold_ms.items()},
        plain_ms_by_blocks={str(k): v for k, v in plain_ms.items()}, chain_ms=chain_ms,
        nccl_group_ms=gms, cfg6r_be_mesh_ms=ms2, cfg6r_be_mesh_plain_ms=p2_ms,
        cfg6r_be_mesh_bound_ms=b2)}


def _snapshot_cycle_args(snap):
    """A snapshot's planes as the cycle's named arguments (build_sim_args'
    names)."""
    return dict(
        idle=snap.node_idle, releasing=snap.node_releasing, used=snap.node_used,
        node_alloc=snap.node_alloc, node_max_tasks=snap.node_max_tasks,
        task_count=snap.node_task_count, node_valid=snap.node_valid,
        task_req=snap.task_req, task_job=snap.task_job, task_class=snap.task_class,
        task_valid=snap.task_valid, job_queue=snap.job_queue,
        job_min=snap.job_min_available, job_prio=snap.job_priority,
        job_ready_init=snap.job_ready_init, job_alloc_init=snap.job_alloc_init,
        job_schedulable=snap.job_schedulable, job_start=snap.job_start,
        job_ntasks=snap.job_ntasks, queue_weight=snap.queue_weight,
        queue_request=snap.queue_request, queue_alloc_init=snap.queue_alloc_init,
        queue_participates=snap.queue_participates, total=snap.total, eps=snap.eps,
        class_mask=snap.class_node_mask, class_score=snap.class_node_score)


def phase_multihost_cfg9(captured, want, k12a_row):
    """K13 at cfg9's width on the cycle's captured inputs: run_lockstep at
    1, 2 and 4 hosts over four node blocks (each host's build, dispatch and
    owned fetch timed on its own after a synchronize, the global solve as
    solve_wait_s), the merged outputs bit for bit equal to phase 17's
    4-block K12a run; the owned slices of four hosts cover every row once.
    Launch counts reset just before the lockstep runs and read just after."""
    import torch

    from volcano_tpu_torch.parallel import multihost as MH

    backend, snap, _ = captured
    dev = torch.device("cuda")
    args = _snapshot_cycle_args(snap)
    w_least, w_balanced = backend.score_weights()
    policy = dict(job_key_order=backend.job_key_order, use_gang_ready=backend.gang_job_ready,
                  use_proportion=backend.proportion_queue_order, w_least=w_least,
                  w_balanced=w_balanced)
    n_blocks = int(CFG9_MESH)

    def same(got, tag):
        for name, g, w in zip(MH.OUTPUT_NAMES, got, want):
            if not np.array_equal(g, w):
                raise AssertionError(f"K13 {tag}: {name} differs from the 4-block K12a run")

    reset_launches()
    walls = {}
    for H in (1, 2, 4):
        res = MH.run_lockstep(args, H, n_blocks=n_blocks, device=dev, **policy)
        same(res["outputs"], f"{H} hosts")
        walls[H] = res
        log(f"[K13] cfg9, {H} host(s) x {n_blocks // H} block(s) ok, equal to K12a bit for "
            f"bit: critical path {res['critical_path_s']:.4f} s, solve_wait "
            f"{res['solve_wait_s']:.4f} s, per host "
            f"{json.dumps([{k: round(v, 4) for k, v in r.items()} for r in res['per_host']])}")
    launches = read_launches()
    if launches["multihost_cycle"] != 3 or launches["sharded_cycle"] != 3:
        raise AssertionError(f"K13: launches {launches}")

    mesh = MH.LocalHostMesh(4, n_blocks, dev)
    fn, dargs = MH.make_multihost_cycle(mesh, args, **policy)
    out = fn(dargs)
    slices = [MH.owned_output_slices(out, h, 4, mesh) for h in range(4)]
    T, N = want[0].shape[0], want[6].shape[0]
    if (sum(sl["task_kind"].shape[0] for sl in slices) != T
            or sum(sl["idle"].shape[0] for sl in slices) != N
            or [("ready" in sl) for sl in slices] != [True, False, False, False]):
        raise AssertionError("K13: the owned slices do not tile the outputs")
    same(MH.merge_output_slices(slices), "owned slices of 4 hosts")
    del out
    ms = cuda_ms(lambda: fn(dargs), 1)
    log(f"[K13] owned slices of 4 hosts cover the {T} task rows and {N} node rows once; "
        f"the cycle {ms:.3f} ms (CUDA events)")
    return {"multihost_cycle": dict(
        name="multihost_cycle", route="cuda",
        source="volcano_tpu_torch/parallel/multihost.py (K1, K12a: csrc/water_fill.cu, "
               "csrc/allocate_batch.cu)",
        replaces="volcano_tpu/parallel/multihost.py:168", launches=launches["multihost_cycle"],
        max_abs_err=0.0, ms=ms, plain_ms=k12a_row["plain_ms"], bound_ms=k12a_row["bound_ms"],
        bound_by=k12a_row["bound_by"], library_ms=None,
        cell="cfg9 captured inputs, 4 hosts x 1 block; plain_ms: the same solve's plain "
             "version on 4 blocks (phase 17); launches: the lockstep runs at 1, 2, 4 hosts",
        critical_path_s={str(h): r["critical_path_s"] for h, r in walls.items()},
        solve_wait_s={str(h): r["solve_wait_s"] for h, r in walls.items()})}


def phase_cfg5_two_hosts():
    """cfg5-2h: config 5's store (phase 3) under full_conf("cuda") without
    reclaim and preempt (mesh_hosts > 1 refuses them) and mesh "4", once on
    a single host and once each as the coordinator (mesh_host_id 0) and the
    worker (1) of two hosts, each over its own copy of the store: disjoint
    bind sets whose union binds the single host's pods, every gang task on
    the single host's node, the best-effort pods all the coordinator's, the
    worker writing no PodGroup status and no admission.  The coordinator's
    backfill counts only its own task block's placements (as the JAX
    package's does: ROADMAP section 3), so its best-effort pods may land
    elsewhere than the single host's; how many, and how many nodes the
    merged binds put over their pod cap, is printed."""
    import torch

    from volcano_tpu_torch.api import PodGroupPhase
    from volcano_tpu_torch.scheduler.conf import full_conf
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    binds = {}
    for hosts, host_id in ((1, 0), (2, 0), (2, 1)):
        label = f"e2e cfg5-2h, host {host_id} of {hosts}"
        t0 = time.perf_counter()
        store = build_cfg5_store()
        conf = async_conf(full_conf("cuda"))
        conf.actions = ["enqueue", "allocate", "backfill"]
        conf.mesh, conf.mesh_hosts, conf.mesh_host_id = CFG9_MESH, hosts, host_id
        sched = Scheduler(store, conf=conf)
        log(f"[{label}] store built ({time.perf_counter() - t0:.1f} s); prewarm "
            f"{sched.prewarm(background=False):.2f} s")
        reset_launches()
        t0 = time.perf_counter()
        sched.run_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        if sched.last_path != "fast" or launches["sharded_cycle"] != 1:
            raise AssertionError(f"{label}: path {sched.last_path}, launches {launches}")
        binds[(hosts, host_id)] = dict(sched.cache.bind_log)
        publish_report(label, sched, flush_applier(label, sched))
        sched.close()
        pending = sum(pg.status.phase == PodGroupPhase.PENDING for pg in store.list("PodGroup"))
        log(f"[{label}] cycle 1 wall {wall:.3f} s phases "
            f"{json.dumps({k: round(v, 4) for k, v in sched.fast_cycle.phases.items()})}; "
            f"{len(binds[(hosts, host_id)])} binds, {pending} PodGroups still Pending")
        if host_id == 1 and pending != len(store.list("PodGroup")):
            raise AssertionError(f"{label}: the worker wrote PodGroup phases")
        cap = {n.meta.name: n.allocatable.max_task_num for n in store.list("Node")}
        del sched, store
    single, coord, worker = binds[(1, 0)], binds[(2, 0)], binds[(2, 1)]
    merged = {**coord, **worker}

    def gang(b):
        return {k: v for k, v in b.items() if not k.split("/")[1].startswith("be")}

    gang_single = gang(single)
    if (set(coord) & set(worker) or set(merged) != set(single) or not (coord and worker)
            or gang(merged) != gang_single or gang(worker) != worker):
        raise AssertionError(f"cfg5-2h: coordinator {len(coord)} and worker {len(worker)} "
                             f"binds do not split the single host's {len(single)}")
    be_moved = sum(merged[k] != v for k, v in single.items() if k not in gang_single)
    per_node = {}
    for node in merged.values():
        per_node[node] = per_node.get(node, 0) + 1
    over = sum(c > cap[n] for n, c in per_node.items())
    log(f"[e2e cfg5-2h] the coordinator's {len(coord)} and the worker's {len(worker)} binds "
        f"are disjoint and bind the single host's {len(single)} pods, every gang task on the "
        f"single host's node; {be_moved} of {len(single) - len(gang_single)} best-effort pods "
        f"on another node than the single host's, {over} nodes over their pod cap in the "
        "merged binds (the reference's coordinator backfill)")


def phase_multihost_cli():
    """The process mode on the card: ``python -m
    volcano_tpu_torch.parallel.multihost --mesh-hosts 2`` at config 5's
    widths, a coordinator and one worker process sharing the card: ok, not
    degraded (a degraded run fails), the worker's shipped slice the owned
    half; then a worker whose coordinator's pid is dead: ``fallback`` and
    full planes."""
    import shutil

    import torch

    from volcano_tpu_torch import _build
    from volcano_tpu_torch.parallel.multihost import host_bounds
    from volcano_tpu_torch.scheduler.simargs import build_sim_args

    widths = ["--nodes", str(CFG5["nodes"]), "--tasks", str(CFG5["jobs"] * CFG5["tasks_per_job"]),
              "--jobs", str(CFG5["jobs"])]
    a = build_sim_args(CFG5["nodes"], CFG5["jobs"] * CFG5["tasks_per_job"], CFG5["jobs"],
                       n_queues=2, seed=11)
    T, N = a["task_req"].shape[0], a["idle"].shape[0]
    outdir = _build.BUILD_DIR / f"multihost_{os.getpid()}"
    shutil.rmtree(outdir, ignore_errors=True)
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))

    def cli(extra):
        cmd = [sys.executable, "-m", "volcano_tpu_torch.parallel.multihost", "--mesh-hosts", "2",
               *widths, "--outdir", str(outdir), *extra]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=300)
        if proc.returncode:
            raise AssertionError(f"multihost CLI {extra} exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        return json.loads(lines[-1]), time.perf_counter() - t0

    try:
        summary, wall = cli([])
        if summary["degraded"] or not summary["ok"] or [w["ok"] for w in summary["workers"]] != [True]:
            raise AssertionError(f"multihost CLI: {summary}")
        with np.load(outdir / "host01.npz") as shipped:
            lo, hi = host_bounds(T, 2)[1]
            nlo, nhi = host_bounds(N, 2)[1]
            if shipped["task_node"].shape[0] != hi - lo or shipped["idle"].shape[0] != nhi - nlo:
                raise AssertionError("multihost CLI: the worker's slice is not the owned half")
        log(f"[multihost CLI] 2 hosts on {summary['device']}: ok, not degraded, {summary['binds']} "
            f"binds; critical path {summary['critical_path_s']:.4f} s, solve_wait "
            f"{summary['solve_wait_s']:.4f} s, per host "
            f"{json.dumps([{k: round(v, 4) for k, v in r.items()} for r in summary['per_host']])};"
            f" whole run {wall:.1f} s")
        dead = subprocess.Popen([sys.executable, "-c", "pass"])
        dead.wait(timeout=60)
        payload, wall = cli(["--host-id", "1", "--coordinator-pid", str(dead.pid)])
        with np.load(outdir / "host01.npz") as shipped:
            full = shipped["task_node"].shape[0] == T and shipped["idle"].shape[0] == N
            bound = int((shipped["task_kind"] == 1).sum())
        if not payload["fallback"] or not full or not bound:
            raise AssertionError(f"multihost CLI, dead coordinator: {payload}")
        log(f"[multihost CLI] worker with a dead coordinator: fallback, full planes, {bound} "
            f"binds ({wall:.1f} s)")
    finally:
        shutil.rmtree(outdir, ignore_errors=True)



def _device_ms(events):
    """{name: (calls, device ms)} of profiler key averages, device time only."""
    out = {}
    for e in events:
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t:
            out[e.key] = (e.count, t / 1e3)
    return out


def _batch_stage(name):
    """The stage of csrc/allocate_batch.cu a profiler kernel name belongs
    to (its vtt_batch_* kernel), "ps_init" for K5's, else "other"."""
    import re

    m = re.search(r"vtt_batch_([a-z_]+)", name)
    if m:
        return m.group(1)
    return "ps_init" if "vtt_ps_init" in name else "other"


def batch_split(label, run):
    """torch.profiler over one batched solve (``run()`` returns its
    SolveOut, warmed up first): device ms and launches by kernel of
    csrc/allocate_batch.cu ("other": the wrapper's copies and fills and
    the go flag's fetch), the rounds, and the host gap, the unprofiled
    wall (host clock, synchronized) less the profiled device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        pwall = (time.perf_counter() - t0) * 1e3
    stages = {}
    for name, (calls, ms) in _device_ms(prof.key_averages()).items():
        if name.startswith(("aten::", "cuda")):
            continue  # host rows: their kernels have rows of their own
        st = _batch_stage(name)
        c, m = stages.get(st, (0, 0.0))
        stages[st] = (c + calls, m + ms)
    rounds = max(int(out.steps), 1)
    device = sum(ms for _, ms in stages.values())
    gap = wall - device
    log(f"[split] {label}: {rounds} rounds, wall {wall:.3f} ms ({wall / rounds:.4f} ms a "
        f"round), device {device:.3f} ms, host gap {gap:.3f} ms ({gap / wall:.3f} of the "
        f"wall); wall under the profiler {pwall:.3f} ms")
    for st, (c, ms) in sorted(stages.items(), key=lambda kv: -kv[1][1]):
        log(f"[split]   {st}: {c} launches, {ms:.3f} ms ({ms / max(device, 1e-9):.3f} of the "
            f"device time), {ms / rounds:.4f} ms a round")
    return dict(rounds=rounds, wall_ms=wall, device_ms=device, host_gap_ms=gap,
                profiled_wall_ms=pwall,
                stages={st: dict(launches=c, ms=ms) for st, (c, ms) in stages.items()})


def phase_split():
    """The per-stage split of the batched solve alone (``--split``): K1 at
    its shapes (k1_split, the solve's shares), then K3 at config 5
    (build_sim_args(10,000, 100,000, 5,000)) and the 4-block sharded solve
    at cfg9's shape (build_sim_args(100,000, 1,000,000, 50,000, seed=9)),
    each from batch_split; then K13 at that full cfg9 shape
    (lockstep_cfg9_shape), which the main run holds at CFG9_MAIN only."""
    import torch

    from volcano_tpu_torch.parallel import sharded as S
    from volcano_tpu_torch.scheduler import kernels as K
    from volcano_tpu_torch.scheduler.simargs import build_sim_args

    res = {"K1": k1_split(torch.device("cuda"))}
    for key, label, shape, blocks in (
        ("K3 cfg5", "K3 at config 5", (10_000, 100_000, 5_000, 0), None),
        ("K12a cfg9-shape", f"K12a at cfg9's shape, {CFG9_MESH} blocks",
         (100_000, 1_000_000, 50_000, 9), int(CFG9_MESH)),
    ):
        n, t, j, seed = shape
        a = build_sim_args(n, t, j, seed=seed)
        si = _solve_inputs_np(a)
        if blocks is None:
            args = [si[k] for k in K._SOLVE_ARGS] + [1.0, 1.0]

            def run(args=args):
                return K.allocate_solve_batch(*args)
        else:
            mesh = S.LocalMesh(blocks, torch.device("cuda"))
            planes = {k: S.split_rows(mesh, k, si[k]) for k in K.NODE_PLANES}
            repl = {k: si[k] for k in K._SOLVE_ARGS if k not in K.NODE_PLANES}

            def run(mesh=mesh, planes=planes, repl=repl):
                return S.sharded_solve(mesh, planes, repl, 1.0, 1.0)
        res[key] = batch_split(label, run)
        res[key]["max_abs_err"] = _compare(label, run(), K.allocate_solve_batch_plain(
            **si, w_least=1.0, w_balanced=1.0))
        if blocks is not None:
            res["K13 cfg9-shape"] = lockstep_cfg9_shape(a, S.fetch_outputs(run(), mesh),
                                                        blocks)
        del si, run, a
    return res


def lockstep_cfg9_shape(args, want, n_blocks):
    """K13 at cfg9's full shape (``args``: build_sim_args' numpy planes):
    run_lockstep at 1, 2 and 4 hosts over ``n_blocks`` node blocks, each
    merged output bit for bit equal to ``want``, the K12a run's on the same
    blocks.  Launch counts reset just before the runs and read just after.
    Returns each host count's critical path and solve wait."""
    import torch

    from volcano_tpu_torch.parallel import multihost as MH

    reset_launches()
    out = {}
    for H in (1, 2, 4):
        res = MH.run_lockstep(args, H, n_blocks=n_blocks, device=torch.device("cuda"))
        for name, g, w in zip(MH.OUTPUT_NAMES, res["outputs"], want):
            if not np.array_equal(g, w):
                raise AssertionError(f"K13 at cfg9's shape, {H} hosts: {name} differs from "
                                     f"the {n_blocks}-block K12a run")
        out[str(H)] = {"critical_path_s": res["critical_path_s"],
                       "solve_wait_s": res["solve_wait_s"]}
        log(f"[K13] cfg9's shape, {H} host(s) x {n_blocks // H} block(s) ok, equal to K12a "
            f"bit for bit: critical path {res['critical_path_s']:.4f} s, solve_wait "
            f"{res['solve_wait_s']:.4f} s")
    launches = read_launches()
    if launches["multihost_cycle"] != 3 or launches["sharded_cycle"] != 3:
        raise AssertionError(f"K13 at cfg9's shape: launches {launches}")
    out["launches"] = launches["multihost_cycle"]
    return out


#: calls of each solve the victim split times and profiles
VICTIM_SPLIT_REPS = 10


def _victim_stage(name):
    """A profiler kernel name's vtt_* or NCCL kernel, else "copies and
    fills" (the wrapper's clones, fills and zeroes)."""
    import re

    m = re.search(r"(vtt_[a-z0-9_]+|nccl[A-Za-z]+)", name)
    return m.group(1) if m else "copies and fills"


def victim_split(label, run, reps=VICTIM_SPLIT_REPS):
    """One victim solve (``run()``, warmed up first) split into: device ms
    and launches a call by kernel (torch.profiler over ``reps`` calls), the
    wrapper's host us from entry to return (it returns after its last
    launch, without a sync), the synchronized wall (host clock) and the host
    gap (the wall less the device time); medians over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    host, wall = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) * 1e6)
        wall.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    stages = {}
    for name, (calls, ms) in _device_ms(prof.key_averages()).items():
        if name.startswith(("aten::", "cuda")):
            continue  # host rows
        st = _victim_stage(name)
        c, m = stages.get(st, (0, 0.0))
        stages[st] = (c + calls, m + ms)
    stages = {st: (c / reps, m / reps) for st, (c, m) in stages.items()}
    device = sum(m for _, m in stages.values())
    launches = sum(c for c, _ in stages.values())
    host_us, wall_ms = float(np.median(host)), float(np.median(wall))
    gap = wall_ms - device
    log(f"[victim split] {label}: device {device:.4f} ms in {launches:g} launches, wrapper "
        f"host {host_us:.1f} us, wall {wall_ms:.4f} ms, host gap {gap:.4f} ms "
        f"({gap / wall_ms:.3f} of the wall)")
    for st, (c, ms) in sorted(stages.items(), key=lambda kv: -kv[1][1]):
        log(f"[victim split]   {st}: {c:g} launches, {ms:.4f} ms")
    return dict(device_ms=device, launches=launches, host_us=host_us, wall_ms=wall_ms,
                host_gap_ms=gap,
                stages={st: dict(launches=c, ms=ms) for st, (c, ms) in stages.items()})


def _capture_cfg6r_be_step():
    """The first K7 call's inputs of one cfg6r-be object cycle."""
    from volcano_tpu_torch.scheduler.conf import full_conf
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    sched = Scheduler(build_cfg6r_be_store(), conf=full_conf("cuda"))
    sched.prewarm(background=False)
    cap = ObjectCapture()
    try:
        sched.run_once()
    finally:
        cap.close()
    if sched.last_path != "object" or "victim_step" not in cap.first:
        raise AssertionError("victim split: the cfg6r-be cycle launched no K7")
    return cap.first["victim_step"]


def phase_victim_split():
    """The victim solve's split (``--victim-split``): one K7 call at bench
    config 4's shape (build_victim_sim(10,000, 100,000, 5,000, seed=4), the
    [2000, 4Gi] preemptor of job 0, mode queue, gang and drf vetoes), one
    on the first inputs cfg6r-be gives it, and one K12b call at config 4
    on a local mesh of 4 blocks, each from victim_split: warm (the groups
    built once, as the object path's _VictimDriver holds them), cold
    (built inside the call), and the group build alone; each solve's
    result held against its plain version."""
    import torch

    from volcano_tpu_torch import interop
    from volcano_tpu_torch.parallel import sharded as S
    from volcano_tpu_torch.scheduler import victim_kernels as VK
    from volcano_tpu_torch.scheduler.simargs import build_victim_sim

    dev = torch.device("cuda")
    c, s = interop.victim_from_arrays(*build_victim_sim(10_000, 100_000, 5_000, seed=4), dev)
    t_req = torch.tensor([2000.0, 4.0 * (1 << 30)], device=dev)
    kw = dict(mode="queue", use_gang=True, use_drf=True)
    args, ckw = _capture_cfg6r_be_step()
    ckw = {k: v for k, v in ckw.items() if k != "groups"}
    mesh = S.LocalMesh(4, dev)
    _, dc, ds = S.make_sharded_victim_step(mesh, c, s)
    cases = [
        ("K7 config 4", lambda **g: VK.victim_step(c, s, t_req, 0, 0, 0, **kw, **g),
         lambda: VK.victim_step_plain(c, s, t_req, 0, 0, 0, **kw),
         lambda: VK.victim_groups(c, s.run_live, order_by_priority=True)),
        ("K7 cfg6r-be first inputs", lambda **g: VK.victim_step(*args, **ckw, **g),
         lambda: VK.victim_step_plain(*args, **ckw),
         lambda: VK.victim_groups(args[0], args[1].run_live,
                                  order_by_priority=ckw.get("order_by_priority", True))),
        ("K12b config 4, 4 blocks",
         lambda **g: VK.victim_step_sharded(dc, ds, t_req, 0, 0, 0, mesh, **kw, **g),
         lambda: S.victim_blocks_plain(dc, ds, t_req, 0, 0, 0, mesh,
                                       c.node_alloc.shape[0] // 4, **kw),
         lambda: VK.victim_groups(dc, ds.run_live, order_by_priority=True, mesh=mesh)),
    ]
    res = {}
    for label, step, plain, groups in cases:
        want = plain()
        g = groups()
        res[label + ", warm"] = victim_split(label + ", warm", lambda: step(groups=g))
        res[label + ", cold"] = victim_split(label + ", cold", step)
        res[label + ", groups"] = victim_split(label + ", groups alone", groups)
        _blocked_compare(label + ", warm", step(groups=g), want)
        _blocked_compare(label + ", cold", step(), want)
    return res


#: CUDA-event calls timed per storm solve in the storm split
STORM_SPLIT_REPS = 10


#: the wide-reclaim input of the storm split: cfg6r's store with this many
#: reclaiming gangs, so K8's rate an attempt shows past its setup
WIDE_RECLAIM_GANGS = 100
#: CUDA-event calls timed on the whole cfg6 storm (2,000 attempts)
STORM_EXACT_REPS = 3


def _capture_storms():
    """The first inputs of K8 (cfg6r, and cfg6r-wide: WIDE_RECLAIM_GANGS
    reclaiming gangs), K9 (cfg6b) and K10 (cfg6): one cycle of each
    config-6 cell on the card, as phase 8 drives it."""
    from volcano_tpu_torch.scheduler.conf import full_conf
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    out = {}
    for key, name, cell, gangs in (
            ("reclaim_solve", "reclaim_solve", "cfg6r", CFG6["reclaim_gangs"]),
            ("reclaim_solve wide", "reclaim_solve", "cfg6r", WIDE_RECLAIM_GANGS),
            ("preempt_solve", "preempt_solve", "cfg6b", None),
            ("preempt_rounds", "preempt_rounds", "cfg6", None)):
        store = build_contended_store(cell, **({"reclaim_gangs": gangs} if gangs else {}))
        sched = Scheduler(store, conf=full_conf("cuda"))
        sched.prewarm(background=False)
        cap = ContentionCapture((name,))
        try:
            sched.run_once()
        finally:
            cap.close()
        if name not in cap.inputs:
            raise AssertionError(f"storm split: the {cell} cycle launched no {name}")
        label = f"cfg6r-wide ({gangs} gangs)" if key.endswith("wide") else cell
        out[key] = (name, label, cap.inputs[name])
    return out


#: the walk's setup kernels (the pool grouped by node, once a solve): the
#: one cluster launch, and a parent tree's four launches
WALK_SETUP_KERNELS = ("vtt_group_kernel", "vtt_v_count", "vtt_v_scan", "vtt_v_bucket",
                      "vtt_v_order")


def _walk_launcher(name, args, kw):
    """launch(cluster=None, split=None): K8 or K9 through its launch wrapper
    (``reclaim_launch`` / ``preempt_launch``) on ``args`` / ``kw``;
    ``launch.timed`` / ``launch.clusters`` say whether the tree's wrapper
    takes ``split`` / ``cluster`` (a parent tree may take neither)."""
    import inspect

    from volcano_tpu_torch import _build
    from volcano_tpu_torch.scheduler import victim_kernels as VK

    entry = VK.reclaim_launch if name == "reclaim_solve" else VK.preempt_launch
    lib, dev = _build.load(), args[0].run_req.device
    params = inspect.signature(entry).parameters

    def launch(cluster=None, split=None):
        extra = {k: v for k, v in (("cluster", cluster), ("split", split)) if v is not None}
        return entry(lib, VK._stream(dev), *args, **kw, **extra)

    launch.device = dev
    launch.timed, launch.clusters = "split" in params, "cluster" in params
    return launch


def _walk_timed(launch, ms, digest, label):
    """The timed instantiation's split of one K8 / K9 solve at the default
    cluster size (``launch`` from _walk_launcher; ``ms`` the untimed solve's
    CUDA-event time, ``digest`` its outputs'): the cluster size, attempts,
    job selects, the kernel's wall (%globaltimer, the setup launches
    excluded) and each stage's time (its share of the clock64 cycles of the
    timing thread, scaled by that wall), and us an attempt of the untimed
    solve (setup included)."""
    import torch

    from volcano_tpu_torch.scheduler import victim_kernels as VK

    buf = torch.zeros(32, dtype=torch.int64, device=launch.device)
    o = launch(split=buf)
    torch.cuda.synchronize()
    if _solve_digest_named(o) != digest:
        raise AssertionError(f"{label}: the timed walk differs from the untimed one")
    s = buf.cpu().tolist()
    ns, cyc = s[0], max(s[1], 1)
    stages = {st: s[2 + i] * ns / cyc / 1e6 for i, st in enumerate(VK.WALK_STAGES)}
    # the advance's cycles include its selects': report them apart
    stages["advance"] -= stages["select"]
    return dict(cluster=s[12], threads=s[13], attempts=s[8], selects=s[9], kernel_ms=ns / 1e6,
                stages_ms=stages, us_per_attempt=ms * 1e3 / max(s[8], 1),
                kernel_us_per_attempt=ns / 1e3 / max(s[8], 1))


def walk_split(label, name, args, kw, ms, digest, reps):
    """K8 / K9 on one input, beyond its CUDA-event time ``ms`` and output
    ``digest``: on a tree whose wrapper takes them, the timed split
    (_walk_timed) and each cluster size of VK.WALK_CLUSTERS timed (or the
    error the card refused it with), each equal to the default's outputs."""
    import torch

    from volcano_tpu_torch.scheduler import victim_kernels as VK

    launch = _walk_launcher(name, args, kw)
    row = {}
    if launch.clusters:
        row["clusters"] = {}
        for c in VK.WALK_CLUSTERS:
            try:
                o = launch(cluster=c)
                torch.cuda.synchronize()
            except RuntimeError as e:
                row["clusters"][c] = f"refused: {e}"
                continue
            if _solve_digest_named(o) != digest:
                raise AssertionError(f"walk split {label}: cluster {c} differs from the default")
            row["clusters"][c] = cuda_ms(lambda: launch(cluster=c), reps)
    if launch.timed:
        row.update(_walk_timed(launch, ms, digest, label))
        log(f"[walk split] {label}: cluster {row['cluster']} x {row['threads']} threads, "
            f"{row['attempts']} attempts, {row['selects']} job selects, kernel "
            f"{row['kernel_ms']:.4f} ms ({row['kernel_us_per_attempt']:.2f} us an attempt), "
            f"{row['us_per_attempt']:.2f} us an attempt with the setup; " + ", ".join(
                f"{st} {v:.4f} ms" for st, v in row["stages_ms"].items())
            + (f"; by cluster size {row['clusters']}" if launch.clusters else ""))
    return row


#: the rounds solve's kernels of the within-job count and of the job
#: select, by their names in this design and in the earlier one
#: (vtt_r_cnt_in_job; vtt_r_rank, vtt_r_select), so the storm split sums a
#: parent tree's alike
ROUNDS_COUNT_KERNELS = ("vtt_r_cnt_in_job", "vtt_r_count_items", "vtt_r_count_tiles")
ROUNDS_SELECT_KERNELS = ("vtt_r_rank", "vtt_r_select", "vtt_r_sel_chunk", "vtt_r_sel_merge",
                         "vtt_r_sel_place")
#: big-job: cfg6's captured K10 input with this many live rows in one job
#: (pool-job: with all of them)
BIG_JOB_ROWS = 16_384
#: many-jobs: build_storm_sim's pool (running rows over nodes, pool jobs)
#: and fresh gangs, about 60,000 job rows of 65,536
MANY_JOBS = dict(seed=12, n_nodes=40_000, n_victims=160_000, n_jobs=48_000, n_new=12_000)
#: CUDA-event calls timed per synthetic rounds shape
ROUNDS_SHAPE_REPS = 5


def _big_job_args(rounds_in, rows=BIG_JOB_ROWS):
    """cfg6's captured K10 input with its first ``rows`` live rows of
    non-preemptor jobs (all of them when ``rows`` is None) moved into the
    job of the first of them, their allocation (float64, rounded once) and
    occupancy moved along."""
    import torch

    args, kw = rounds_in
    c, s0, avail = args[0], args[1], args[8]
    take = torch.nonzero(s0.run_live & ~avail[c.run_job.long()]).flatten()[:rows]
    if rows is None:
        log(f"[storm split] pool-job: {take.numel()} live rows in one job")
    elif take.numel() < rows:
        raise AssertionError(f"big-job: {take.numel()} live rows, {rows} wanted")
    old = c.run_job[take].long()
    to = torch.full_like(old, int(c.run_job[take[0]]))
    req = c.run_req[take].double()
    alloc = s0.job_alloc.double().index_add_(0, old, -req).index_add_(0, to, req)
    one = torch.ones_like(take, dtype=torch.int32)
    occ = s0.job_occupied.clone().index_add_(0, old, -one).index_add_(0, to, one)
    run_job = c.run_job.clone()
    run_job[take] = to.int()
    return (c._replace(run_job=run_job), s0._replace(job_alloc=alloc.float(), job_occupied=occ),
            *args[2:]), kw


def _many_jobs_args(kw):
    """build_storm_sim at MANY_JOBS on the card, K10's arguments, the cfg6
    cell's flags."""
    import torch

    from volcano_tpu_torch import interop
    from volcano_tpu_torch.scheduler.simargs import build_storm_sim, storm_inputs

    p = dict(MANY_JOBS)
    c, s, t = build_storm_sim(p.pop("seed"), **p)
    dev = torch.device("cuda")
    tc, ts = interop.victim_from_arrays(c, s, dev)
    rest = [torch.from_numpy(np.asarray(a)).to(dev) for a in storm_inputs("rounds", c, s, t)]
    return (tc, ts, *rest), dict(kw)


def _rounds_of(out, args, kw):
    """A rounds solve's round count: each round adds F + 1 to rec.att."""
    from volcano_tpu_torch.scheduler import victim_kernels as VK

    F = min(kw.get("m_chunk", 128), args[0].job_queue.shape[0]) * kw.get(
        "p_chunk", VK.ROUNDS_P_CHUNK)
    return int(out.rec.att) // (F + 1)


def _solve_digest_named(out):
    """sha256 of every output of a contention solve by name, node planes
    joined: equal on one block, on blocks and over a group."""
    import hashlib

    h = hashlib.sha256()
    for k, x in sorted(_solve_host(out).items()):
        h.update(k.encode())
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _rounds_stages(split, rounds):
    """The count's and the select's device ms in a victim_split result,
    and the select's a round."""
    st = split["stages"]
    count = sum(v["ms"] for k, v in st.items() if k in ROUNDS_COUNT_KERNELS)
    select = sum(v["ms"] for k, v in st.items() if k in ROUNDS_SELECT_KERNELS)
    return dict(count_ms=count, select_ms=select, select_ms_a_round=select / max(rounds, 1))


def phase_storm_split(reps=STORM_SPLIT_REPS):
    """The storm solves (``--storm-split``), which share
    csrc/victim_common.cuh with K7: CUDA-event ms of K8 (cfg6r, and
    cfg6r-wide with WIDE_RECLAIM_GANGS reclaiming gangs), K9 (cfg6b, and the
    whole cfg6 storm as solveMode: exact hands it over) and K10 (cfg6) on
    the first inputs their cells give them, and of K10 on
    three synthetic shapes (big-job: cfg6's input with one running job of
    BIG_JOB_ROWS rows; pool-job: with all its live rows in one job;
    many-jobs: MANY_JOBS from build_storm_sim), on one
    block, on a local mesh of 4 blocks (K15a-c) and over a one-rank NCCL
    group of 4 blocks, each held against the one-block solve (K10 also
    against its plain version); ``reps`` calls timed each (ROUNDS_SHAPE_REPS
    on the synthetic shapes), then each split by victim_split (device ms by
    kernel, host gap; for K10 the count's and the select's ms), with the
    rounds and an output digest of K10, so a parent and a change compare in
    one chip call; K8 and K9 also against their plain versions (K9 over the
    whole storm too, which the main run's phase 9 holds on its first 10
    gangs), with an output digest, their ok attempts, the setup kernels'
    device ms and walk_split (the timed walk's stages, each cluster size)
    where the tree has them."""
    import torch
    import torch.distributed as dist

    from volcano_tpu_torch import _build
    from volcano_tpu_torch.parallel import sharded as S
    from volcano_tpu_torch.scheduler import victim_kernels as VK

    dev = torch.device("cuda")
    captured = _capture_storms()
    cfg6_in = captured["preempt_rounds"][2]
    cases = [(key, name, cell, args, kw, reps)
             for key, (name, cell, (args, kw)) in captured.items()]
    ex, ekw = _storm_exact_args(cfg6_in)
    cases.append(("preempt_solve cfg6 storm", "preempt_solve", "cfg6 storm (exact)", ex, ekw,
                  STORM_EXACT_REPS))
    for shape, (args, kw) in (("big-job", _big_job_args(cfg6_in)),
                              ("pool-job", _big_job_args(cfg6_in, None)),
                              ("many-jobs", _many_jobs_args(cfg6_in[1]))):
        cases.append((f"preempt_rounds {shape}", "preempt_rounds", shape, args, kw,
                      ROUNDS_SHAPE_REPS))
    res = {}
    for key, name, cell, args, kw, n in cases:
        one, sharded = getattr(VK, name), getattr(VK, name + "_sharded")
        mesh = S.LocalMesh(int(CFG6_MESH), dev)
        cb, sb = S._place_victim(mesh, args[0]), S._place_victim(mesh, args[1])
        ref = one(*args, **kw)
        _solve_compare(f"storm split {cell} {name}, {mesh.size} blocks",
                       sharded(cb, sb, *args[2:], mesh, **kw), ref)
        runs = {"one block": lambda: one(*args, **kw),
                f"{mesh.size} blocks": lambda: sharded(cb, sb, *args[2:], mesh, **kw)}
        res[key] = dict(cell=cell, one_block_ms=cuda_ms(runs["one block"], n),
                        blocks4_ms=cuda_ms(runs[f"{mesh.size} blocks"], n))
        res[key]["split"] = {label: victim_split(f"{cell} {name}, {label}", run, n)
                             for label, run in runs.items()}
        if name != "preempt_rounds":
            setup = {label: sum(v["ms"] for k, v in sp["stages"].items()
                                if k in WALK_SETUP_KERNELS)
                     for label, sp in res[key]["split"].items()}
            res[key].update(digest=_solve_digest_named(ref), ok_attempts=int(ref.rec.att),
                            evictions=int((ref.rec.evict_att >= 0).sum()),
                            setup_ms=setup["one block"],
                            setup_ms_blocks=setup[f"{mesh.size} blocks"])
            _solve_compare(f"storm split {cell} {name}, plain", ref,
                           getattr(VK, name + "_plain")(*args, **kw))
            res[key]["walk"] = walk_split(f"{cell} {name}", name, args, kw,
                                          res[key]["one_block_ms"], res[key]["digest"], n)
        if name == "preempt_rounds":
            _solve_compare(f"storm split {cell} {name}, plain", ref,
                           VK.preempt_rounds_plain(*args, **kw))
            rounds = _rounds_of(ref, args, kw)
            res[key].update(rounds=rounds, digest=_solve_digest_named(ref),
                            tasks_committed=int(ref.att_total),
                            evictions=int((ref.rec.evict_att >= 0).sum()),
                            **_rounds_stages(res[key]["split"]["one block"], rounds))
    store_path = _build.BUILD_DIR / f"nccl_store_storms_{os.getpid()}"
    store_path.parent.mkdir(parents=True, exist_ok=True)
    if store_path.exists():
        store_path.unlink()
    dist.init_process_group("nccl", store=dist.FileStore(str(store_path), 1),
                            rank=0, world_size=1)
    try:
        gmesh = S.make_mesh(int(CFG6_MESH))
        for key, name, cell, args, kw, n in cases:
            sharded = getattr(VK, name + "_sharded")
            cg, sg = S._place_victim(gmesh, args[0]), S._place_victim(gmesh, args[1])
            _solve_compare(f"storm split {cell} {name}, NCCL group",
                           sharded(cg, sg, *args[2:], gmesh, **kw),
                           getattr(VK, name)(*args, **kw))
            res[key]["nccl_group_ms"] = cuda_ms(
                lambda: sharded(cg, sg, *args[2:], gmesh, **kw), n)
            res[key]["split"]["NCCL group"] = victim_split(
                f"{cell} {name}, NCCL group", lambda: sharded(cg, sg, *args[2:], gmesh, **kw),
                n)
    finally:
        dist.destroy_process_group()
        if store_path.exists():
            store_path.unlink()
    for key, r in res.items():
        log(f"[storm split] {r['cell']} {key}: one block {r['one_block_ms']:.4f} ms, "
            f"{CFG6_MESH} blocks {r['blocks4_ms']:.4f} ms, NCCL group {r['nccl_group_ms']:.4f} "
            f"ms")
        if "setup_ms" in r:
            log(f"[storm split]   {r['ok_attempts']} ok attempts, {r['evictions']} evictions, "
                f"digest {r['digest']}; setup {r['setup_ms']:.4f} ms of device time on one "
                f"block, {r['setup_ms_blocks']:.4f} ms on {CFG6_MESH} blocks")
        if "rounds" in r:
            log(f"[storm split]   {r['rounds']} rounds, {r['tasks_committed']} tasks "
                f"committed, {r['evictions']} evictions, digest {r['digest']}; one block: "
                f"count {r['count_ms']:.4f} ms, select {r['select_ms']:.4f} ms "
                f"({r['select_ms_a_round']:.5f} ms a round)")
    return res


#: CUDA-event calls timed per input in the exact split
EXACT_SPLIT_REPS = 5
#: the stages of the timed exact solve, in the order of its split buffer
EXACT_STAGES = ("class_row", "scan", "reduce", "cluster_barrier", "apply", "select")
#: a select step's parts in the split: the queue, the job candidates, the
#: reduce to the CTA's record, the cluster barrier, the records' read
EXACT_SELECT_STAGES = ("queue", "job_scan", "job_reduce", "cluster_barrier", "read")


def _capture_dyn(label, dynamic_frac=0.0, volume_tasks=0):
    """The first cycle's dynamic-solve inputs of a config-5 store with
    dynamic or volume gangs (phase_e2e's capture, without its checks)."""
    from volcano_tpu_torch.scheduler.conf import full_conf
    from volcano_tpu_torch.scheduler.fastpath import cycle as cycle_mod
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    store = build_cfg5_store(CFG5["jobs"], CFG5["best_effort"], dynamic_frac, volume_tasks)
    sched = Scheduler(store, conf=full_conf("cuda"))
    sched.prewarm(background=False)
    solve_dyn, cap = cycle_mod.torch_dynamic_solve, []

    def recording(backend, snap, dyn, n_pending=None):
        cap.append((backend, snap, dyn))
        return solve_dyn(backend, snap, dyn, n_pending)

    cycle_mod.torch_dynamic_solve = recording
    try:
        sched.run_once()
    finally:
        cycle_mod.torch_dynamic_solve = solve_dyn
    if not cap:
        raise AssertionError(f"exact split: the {label} cycle ran no dynamic solve")
    return cap[0]


def _exact_cases():
    """(label, positional args, keyword args) of each input the exact split
    times: cfg5-exact, the dynamic solves cfg5d-exact (K5) and cfg5v-2000
    (K5 and K6) capture, 128 queues (phase 15's shape), a select-heavy shape
    (4,000 one-task jobs) and a place-heavy one (one 4,000-task gang whose
    min member is its size, so it stays current)."""
    from volcano_tpu_torch.scheduler import kernels as K
    from volcano_tpu_torch.scheduler.simargs import build_sim_args
    from volcano_tpu_torch.scheduler.tensor_actions import dyn_solve_args

    opts = dict(job_key_order=("priority", "gang", "drf"), use_gang_ready=True,
                use_proportion=True)

    def sim(a):
        si = _solve_inputs_np(a)
        return [si[k] for k in K._SOLVE_ARGS] + [1.0, 1.0], dict(opts)

    yield ("cfg5-exact", *sim(build_sim_args(10_000, 4_000, 200)))
    for label, frac, vol in (("cfg5d-exact", 0.04, 0), ("cfg5v-2000", 0.0, 2000)):
        solve, args, kw = dyn_solve_args(*_capture_dyn(label, frac, vol))
        if solve is not K.allocate_solve:
            raise AssertionError(f"exact split: {label}'s dynamic solve is not the exact one")
        yield label, list(args), kw
    yield ("128 queues", *sim(build_sim_args(10_000, 4_000, 200, n_queues=128, seed=5)))
    yield ("select-heavy", *sim(build_sim_args(10_000, 4_000, 4_000, seed=7)))
    a = build_sim_args(10_000, 4_000, 1, n_queues=1, seed=8)
    a["job_min"][0] = 4_000
    yield ("place-heavy", *sim(a))


def _solve_digest(out):
    """sha256 of every output of a solve, decisions and float state."""
    import hashlib

    h = hashlib.sha256()
    for x in out:
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def exact_split(label, args, kw, reps=EXACT_SPLIT_REPS):
    """K2 on one input: device ms (CUDA events over ``reps`` calls),
    placements, drops, place steps, us a place step, launches a call and a
    digest of the outputs; on a tree whose wrapper takes ``cluster``, also
    the cluster size it chose, each size of K.EXACT_CLUSTERS timed (or the
    error the card refused it with), each equal to the default's outputs,
    and the timed instantiation's split: select and place steps and each
    stage's share of the kernel's clock."""
    import inspect

    import torch

    from volcano_tpu_torch.scheduler import kernels as K

    def run():
        return K.allocate_solve(*args, **kw)

    run()
    torch.cuda.synchronize()
    K.reset_launches()
    out = run()
    torch.cuda.synchronize()
    launches = K.LAUNCHES["allocate_solve"]
    ms = cuda_ms(run, reps)
    placed, drops = int(out.steps), int(out.dropped.sum())
    place_steps = placed + drops
    row = dict(ms=ms, steps=placed, drops=drops, place_steps=place_steps,
               us_per_place_step=ms * 1e3 / max(place_steps, 1), launches=launches,
               digest=_solve_digest(out))
    msg = (f"[exact split] {label}: {ms:.3f} ms, {placed} placements, {drops} drops, "
           f"{row['us_per_place_step']:.3f} us a place step, {launches} launch(es), "
           f"digest {row['digest']}")
    if "cluster" not in inspect.signature(K.solve_launch).parameters:
        log(msg)
        return row
    launch = _exact_launcher(args, kw)
    row["clusters"] = {}
    for c in K.EXACT_CLUSTERS:
        try:
            o = launch(c)
            torch.cuda.synchronize()
        except RuntimeError as e:
            row["clusters"][c] = f"refused: {e}"
            continue
        if _solve_digest(o) != row["digest"]:
            raise AssertionError(f"exact split {label}: cluster {c} differs from the default")
        row["clusters"][c] = cuda_ms(lambda: launch(c), reps)
    row.update(_exact_timed(launch, ms, row["digest"], label))
    sp = row["split"]
    log(msg + f", cluster {row['cluster']} (by size: {row['clusters']}); timed "
        f"{sp['ms']:.3f} ms: {sp['place_steps']} place / {sp['select_steps']} select steps "
        f"({sp['queue_drops']} queue drops), {row['us_per_step']:.3f} us a step; " + ", ".join(
            f"{st} {v:.3f} ms" for st, v in sp["stages_ms"].items()) + "; select: " + ", ".join(
            f"{st} {v:.3f} ms" for st, v in sp["select_stages_ms"].items()))
    return row


def _exact_launcher(args, kw):
    """launch(cluster=None, split=None): K2 through solve_launch on the
    exact solve's positional ``args`` (solve inputs, then the two score
    weights) and keywords ``kw``."""
    from volcano_tpu_torch import _build
    from volcano_tpu_torch.scheduler import kernels as K

    names = K._SOLVE_ARGS + ("w_least", "w_balanced")
    a = dict(zip(names, args))
    wl, wb = a.pop("w_least"), a.pop("w_balanced")
    ext = {k: kw[k] for k in ("portsel", "volsel") if kw.get(k) is not None}
    lib, dev = _build.load(), a["idle"].device

    def launch(cluster=None, split=None):
        return K.solve_launch(lib, K._stream(dev), False, a, wl, wb, kw["job_key_order"],
                              kw["use_gang_ready"], kw["use_proportion"], cluster=cluster,
                              split=split, **ext)

    launch.device = dev
    return launch


def _exact_timed(launch, ms, digest, label):
    """The timed instantiation's split of one K2 solve at the default
    cluster size (``launch`` from _exact_launcher; ``ms`` the untimed
    solve's CUDA-event time, ``digest`` its outputs'): the cluster size
    launched, select and place steps, queue drops,
    each stage's time (its share of the kernel's clock64 cycles, scaled by
    the %globaltimer wall of the solve), the resident rows of a CTA and us a
    step of the untimed solve."""
    import torch

    buf = torch.zeros(32, dtype=torch.int64, device=launch.device)
    o = launch(split=buf)
    torch.cuda.synchronize()
    if _solve_digest(o) != digest:
        raise AssertionError(f"{label}: the timed exact solve differs from the untimed one")
    s = buf.cpu().tolist()
    ns, cyc = s[0], max(s[1], 1)
    stages = {st: s[2 + i] * ns / cyc / 1e6 for i, st in enumerate(EXACT_STAGES)}
    select = {st: s[16 + i] * ns / cyc / 1e6 for i, st in enumerate(EXACT_SELECT_STAGES)}
    split = dict(ms=ns / 1e6, place_steps=s[8], select_steps=s[9], queue_drops=s[10],
                 cluster=s[12], resident_rows=s[13], slice_rows=s[14], stages_ms=stages,
                 select_stages_ms=select)
    return dict(cluster=s[12], split=split, us_per_step=ms * 1e3 / max(s[8] + s[9], 1))


def phase_exact_split():
    """The exact solve's split alone (``--exact-split``): exact_split on
    each of _exact_cases, so a parent commit is measured in the same call."""
    res = {}
    for label, args, kw in _exact_cases():
        res[label] = exact_split(label, args, kw)
        del args, kw
        gc.collect()
    return res


def phase_profile(out_path=None):
    """torch.profiler over the batched solve (phase_split: K3 at config 5,
    the 4-block solve at cfg9's shape), then one config-5 cycle and one
    cfg9 cycle with mesh "4": device time by kernel and the device's idle
    share of the cycle walls; the numbers also go to ``out_path`` as JSON
    when given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from volcano_tpu_torch.scheduler.conf import full_conf
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    res = {"split": phase_split()}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for key, build, mesh in (("cycle", build_cfg5_store, None),
                             ("cfg9_cycle", build_cfg9_store, CFG9_MESH)):
        store = build()
        conf = full_conf("cuda")
        if mesh:
            conf.mesh = mesh
        sched = Scheduler(store, conf=conf)
        sched.prewarm(background=False)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            sched.run_once()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        device = _device_ms(prof.key_averages())
        busy = sum(ms for _, ms in device.values())
        phases = dict(sched.fast_cycle.phases)
        log(f"[profile] {key}: wall {wall:.3f} s, device {busy:.3f} ms, idle share "
            f"{1 - busy / (wall * 1e3):.5f}, phases {json.dumps(phases)}")
        res[key] = {"wall_s": wall, "device": device, "phases": phases}
        del sched, store
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1)


def phase_contention_mesh():
    """cfg6-mesh, cfg6b-mesh, cfg6r-mesh: each config-6 store under
    full_conf("cuda") with mesh "4" and solve_mode "batch", every contention
    pass on four node blocks (K15c in cfg6 and cfg6b, K15b in cfg6b, K15a in
    cfg6r), against the same store's run under mesh "off" with solve_mode
    "batch" (K10, K9, K8): each run holds the cfg6 invariants and the
    per-cycle pattern, and the mesh run's ordered evictions, pipelines and
    binds equal the oracle's.  (solve_mode "auto", phase 8's, allocates the
    storm with the exact solve and so binds otherwise: a separate oracle.)
    Returns the mesh runs' first-cycle launches and the blocked solves'
    first inputs, by cell."""
    from volcano_tpu_torch.scheduler.conf import full_conf

    kernels = {"cfg6": ("preempt_rounds",), "cfg6b": ("preempt_rounds", "preempt_solve"),
               "cfg6r": ("reclaim_solve",)}
    launches, captured = {}, {}
    for cell, names in kernels.items():
        runs = {}
        for mesh in ("off", CFG6_MESH):
            run_names = names if mesh == "off" else tuple(n + "_sharded" for n in names)
            forbid = tuple(k for k in CONTENTION_KERNELS + MESH_CONTENTION_KERNELS
                           if k not in run_names)
            conf = full_conf("cuda")
            conf.solve_mode, conf.mesh = "batch", mesh
            runs[mesh] = phase_contention(f"e2e {cell}-mesh, mesh {mesh}", cell,
                                          {n: 1 for n in run_names}, forbid, conf=conf,
                                          names=run_names, cycles=CONTENTION_CUT_CYCLES)
        (_, _, want), (first, cap, got) = runs["off"], runs[CFG6_MESH]
        for key in ("history", "evicts", "pipes", "binds"):
            if got[key] != want[key]:
                raise AssertionError(f"{cell}-mesh: {key} differ from the mesh-off oracle")
        launches[cell], captured[cell] = first, cap
        log(f"[e2e {cell}-mesh] equal to the mesh-off oracle: {got['history']}, "
            f"{len(got['evicts'])} evictions, {len(got['pipes'])} pipelines, "
            f"{len(got['binds'])} binds in order; launches "
            f"{ {n: first[n] for n in MESH_CONTENTION_KERNELS} }")
    return launches, captured


def _solve_host(out):
    """A contention solve's outputs by name, node planes joined."""
    import torch

    flat = {}
    for f in out._fields:
        part = getattr(out, f)
        items = ({f"{f}.{g}": getattr(part, g) for g in part._fields}
                 if hasattr(part, "_fields") else {f: part})
        for k, x in items.items():
            flat[k] = torch.cat(list(x)) if isinstance(x, tuple) else torch.as_tensor(x)
    return flat


def _solve_compare(name, out_k, out_p):
    """Every output bit for bit, state included (node planes as their
    blocks' rows); returns the largest float difference (0)."""
    import torch

    fk, fp = _solve_host(out_k), _solve_host(out_p)
    err = 0.0
    for f, x in fk.items():
        y = fp[f].to(x.device)
        if x.dtype.is_floating_point and x.numel():
            err = max(err, float((x - y.to(x.dtype)).abs().max()))
        if not torch.equal(x, y.to(x.dtype)):
            raise AssertionError(f"{name}: {f} differs")
    return err


def phase_contention_mesh_kernels(captured, launches, captured8):
    """K15a (cfg6r), K15b (cfg6b) and K15c (cfg6) on the inputs their
    mesh cells captured: on local meshes of 1, 2, 4 and 8 blocks each bit
    for bit equal, state included, to its plain version on the same blocks
    and to the one-block K8 / K9 / K10 on the same inputs; a one-rank NCCL
    group (FileStore rendezvous) running four blocks; K15b over the whole
    cfg6 storm as solveMode: exact runs it (2,000 attempts, phase 9's
    inputs) on four blocks against the one-block K9 (its plain version is
    not run at that size).  CUDA-event ms, and a bound counted from the
    work this data needs (the one-block solve's)."""
    import torch
    import torch.distributed as dist

    from volcano_tpu_torch import _build
    from volcano_tpu_torch.parallel import sharded as S
    from volcano_tpu_torch.scheduler import victim_kernels as VK

    meta = {
        "reclaim_solve": ("cfg6r", "reclaim_solve.cu",
                          "volcano_tpu/scheduler/victim_kernels.py:457", S.reclaim_blocks_plain),
        "preempt_solve": ("cfg6b", "preempt_solve.cu",
                          "volcano_tpu/scheduler/victim_kernels.py:607", S.preempt_blocks_plain),
        "preempt_rounds": ("cfg6", "preempt_rounds.cu",
                           "volcano_tpu/scheduler/victim_kernels.py:830", S.rounds_blocks_plain),
    }
    inputs, rows = {}, {}
    for name, (cell, src, rep, plain) in meta.items():
        sharded = getattr(VK, name + "_sharded")
        args, kw = captured[cell][name + "_sharded"]
        dev = args[0].run_req.device
        c1, s1 = _unblock(args[0]), _unblock(args[1])
        rest = args[2:-1]
        inputs[name] = (c1, s1, rest, kw)
        one = getattr(VK, name)(c1, s1, *rest, **kw)
        n_all = c1.node_alloc.shape[0]
        err, ms, plain_ms = 0.0, {}, {}
        for n in MESH_BLOCKS:
            mesh = S.LocalMesh(n, dev)
            cb, sb = S._place_victim(mesh, c1), S._place_victim(mesh, s1)

            def run(cb=cb, sb=sb, mesh=mesh):
                return sharded(cb, sb, *rest, mesh, **kw)

            out_k = run()
            out_p, plain_ms[n] = _timed(lambda: plain(cb, sb, *rest, mesh, n_all // n, **kw))
            err = max(err, _solve_compare(f"{name}_sharded {cell}, {n} blocks vs plain", out_k,
                                          out_p),
                      _solve_compare(f"{name}_sharded {cell}, {n} blocks vs one block", out_k,
                                     one))
            ms[n] = cuda_ms(run, 3)
        b, kind = bound_ms(_victim_bytes((c1, s1, *rest), one),
                           _victim_ops(name, (c1, s1, *rest), one))
        one_ms = cuda_ms(lambda: getattr(VK, name)(c1, s1, *rest, **kw), 3)
        log(f"[K15] {cell} {name}_sharded ok at 1 / 2 / 4 / 8 blocks: "
            f"{' / '.join(f'{ms[n]:.3f}' for n in MESH_BLOCKS)} ms (plain on the same blocks "
            f"{' / '.join(f'{plain_ms[n]:.1f}' for n in MESH_BLOCKS)} ms; one block "
            f"{one_ms:.3f} ms; bound {b:.4f} ms by {kind}), equal to the plain version and to "
            f"{name} bit for bit")
        m = int(CFG6_MESH)
        rows[name + "_sharded"] = dict(
            name=name + "_sharded", route="cuda", source=f"volcano_tpu_torch/csrc/{src}",
            replaces=rep, launches=launches[cell][name + "_sharded"], max_abs_err=err,
            ms=ms[m], plain_ms=plain_ms[m], bound_ms=b, bound_by=kind, library_ms=None,
            check="ok", cell=f"{cell}-mesh, local mesh of {m} blocks",
            ms_by_blocks={str(k): v for k, v in ms.items()},
            plain_ms_by_blocks={str(k): v for k, v in plain_ms.items()}, one_block_ms=one_ms)

    store_path = _build.BUILD_DIR / f"nccl_store_k15_{os.getpid()}"
    store_path.parent.mkdir(parents=True, exist_ok=True)
    if store_path.exists():
        store_path.unlink()
    dist.init_process_group("nccl", store=dist.FileStore(str(store_path), 1),
                            rank=0, world_size=1)
    try:
        gmesh = S.make_mesh(int(CFG6_MESH))
        if not isinstance(gmesh, S.GroupMesh) or gmesh.n_local != gmesh.size:
            raise AssertionError(f"NCCL mesh: {gmesh}")
        for name in meta:
            c1, s1, rest, kw = inputs[name]
            cg, sg = S._place_victim(gmesh, c1), S._place_victim(gmesh, s1)

            def grun(cg=cg, sg=sg, rest=rest, kw=kw, name=name):
                return getattr(VK, name + "_sharded")(cg, sg, *rest, gmesh, **kw)

            err = _solve_compare(f"{name}_sharded NCCL group", grun(),
                                 getattr(VK, name)(c1, s1, *rest, **kw))
            gms = cuda_ms(grun, 3)
            rows[name + "_sharded"]["nccl_group_ms"] = gms
            rows[name + "_sharded"]["max_abs_err"] = max(rows[name + "_sharded"]["max_abs_err"],
                                                         err)
            log(f"[K15] {name}_sharded on a one-rank NCCL group, {gmesh.size} blocks over "
                f"all_gather_into_tensor ok: {gms:.3f} ms")
    finally:
        dist.destroy_process_group()
        if store_path.exists():
            store_path.unlink()

    # K15b over the whole cfg6 storm, as solveMode: exact runs it
    ex, ekw = _storm_exact_args(captured8["cfg6"]["preempt_rounds"])
    mesh = S.LocalMesh(int(CFG6_MESH), dev)
    cb, sb = S._place_victim(mesh, ex[0]), S._place_victim(mesh, ex[1])

    def storm():
        return VK.preempt_solve_sharded(cb, sb, *ex[2:], mesh, **ekw)

    out_k = storm()
    out_1 = VK.preempt_solve(*ex, **ekw)
    err = _solve_compare("preempt_solve_sharded whole cfg6 storm vs one block", out_k, out_1)
    ms = cuda_ms(storm, 1)
    one_ms = cuda_ms(lambda: VK.preempt_solve(*ex, **ekw), 1)
    b, kind = bound_ms(_victim_bytes(ex, out_1), _victim_ops("preempt_solve", ex, out_1))
    ok = int(out_k.att_total)
    log(f"[K15] cfg6 storm preempt_solve_sharded (exact) on {mesh.size} blocks ok: {ok} ok "
        f"attempts, {int((out_k.rec.evict_att >= 0).sum())} evictions, {ms:.3f} ms (one block "
        f"{one_ms:.3f} ms; bound {b:.4f} ms by {kind}), equal to preempt_solve bit for bit")
    if ok != CFG6["storm_gangs"] * CFG6["tasks_per_job"]:
        raise AssertionError(f"storm preempt_solve_sharded: {ok} ok attempts")
    rows["preempt_solve_sharded"].update(storm_exact_ms=ms, storm_exact_one_block_ms=one_ms,
                                         storm_exact_bound_ms=b,
                                         storm_exact_max_abs_err=err)
    return rows


# the residue cells (phases 24-25).  cfg5r: config 5 with 10% dynamic gangs,
# one best-effort pod on every fifth of them (100 gangs: 2,100 residue tasks,
# 2,000 through the engine, the 100 best-effort pods through backfill), the
# other 1,900 on express gangs.  cfg6d: cfg6's
# store stormed by 10 gangs x 20 (cut from 100, so that the object preempt
# over the storm stays within the run's time), gangs 0 and 5 with a host
# port: the dynamic gangs send the preempt to the object sub-cycle, where a
# session with a pending dynamic job takes the host preemptor walk (the
# reference's tensor_actions._victim_path_usable rule), not K7
CFG5R_DYNAMIC_FRAC = 0.10
CFG5R_BE_EVERY = 5
CFG6D = dict(storm_gangs=10, ported=(0, 5))
# per cycle (evictions, pipelines, binds), the victims reaped between
# cycles: the JAX package's pattern on cfg6d's storm at 1,000 nodes
# (tests/test_torch_residue.py CFG6D_TENTH_PATTERN), two 800m victims a
# 1500m preemptor, the storm bound in the next cycle
CFG6D_PATTERN = [(400, 200, 0), (0, 0, 200), (0, 0, 0)]


def phase_cfg5r():
    """e2e cfg5r: config 5 with 10% dynamic gangs and best-effort pods on
    every fifth of them.  The express gangs take K3, the other dynamic
    gangs K3 with portsel (K5); the residue gangs and their best-effort
    pods go to the object sub-cycle (the residue engine, then backfill).
    Every gang task and best-effort pod bound within three cycles, the
    placement invariants after each.  Returns the first cycle's launches."""
    return phase_e2e("e2e cfg5r", CFG5["jobs"], CFG5["best_effort"],
                     want={"water_fill": 1, "allocate_solve_batch": 2,
                           "allocate_solve_batch_portsel": 1},
                     forbid=("allocate_solve", "allocate_solve_portsel") + CONTENTION_KERNELS,
                     dynamic_frac=CFG5R_DYNAMIC_FRAC, max_cycles=MAX_CYCLES_DYNAMIC,
                     dynamic_best_effort_every=CFG5R_BE_EVERY)


def phase_cfg6d():
    """e2e cfg6d: cfg6's full store (10,000 nodes, 100,000 residents)
    stormed by CFG6D's gangs, two with host ports, under full_conf("cuda").
    The fast cycle's solves (K1, K2, K2 with K5) place nothing (the cluster
    is full); the preempt runs in the object sub-cycle, on the host
    preemptor walk since a dynamic job is pending (K7, K7g and the fast
    contention kernels must not launch).  Three cycles, victims reaped: no
    pod evicted twice, every victim a q0 resident below the storm's
    priority, the pipelines covered by each node's idle plus releasing
    capacity and pod cap, gangs pipelined all or nothing, no host port
    twice on a node, the JAX package's per-cycle pattern; K7 launches and
    device ms from ObjectCapture.  Returns the first cycle's launches."""
    import torch

    from volcano_tpu_torch.scheduler.conf import full_conf
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    label = "e2e cfg6d"
    t0 = time.perf_counter()
    store = build_contended_store("cfg6", **CFG6D)
    log(f"[{label}] store built: {CFG6['nodes']} nodes, "
        f"{CFG6['run_jobs'] * CFG6['tasks_per_job']} residents, {CFG6D['storm_gangs']} storm "
        f"gangs x {CFG6['tasks_per_job']}, gangs {list(CFG6D['ported'])} with a host port "
        f"({time.perf_counter() - t0:.1f} s)")
    sched = Scheduler(store, conf=full_conf("cuda"))
    log(f"[{label}] prewarm {sched.prewarm(background=False):.2f} s")
    cap = ObjectCapture()
    history, evicted = [], []
    try:
        for cycle in range(len(CFG6D_PATTERN)):
            n_ev, n_pipe, n_bind = (len(sched.cache.evict_log), len(cap.pipes),
                                    len(sched.cache.bind_log))
            if cycle == 0:
                reset_launches()
            t0 = time.perf_counter()
            sched.run_once()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if cycle == 0:
                launches = read_launches()
            victims = [k for k, _ in sched.cache.evict_log[n_ev:]]
            pipes = cap.pipes[n_pipe:]
            history.append((len(victims), len(pipes), len(sched.cache.bind_log) - n_bind))
            phases = {k: round(v, 4) for k, v in sched.fast_cycle.phases.items()}
            sub = (f" sub-cycle walls {json.dumps(_object_walls(sched))}"
                   if "subcycle" in phases else "")
            log(f"[{label}] cycle {cycle + 1} wall {wall:.3f} s phases {json.dumps(phases)}{sub} "
                f"(evictions, pipelines, binds) {history[-1]}; victim_step device "
                f"{cap.take_device_ms():.3f} ms" + (f" launches {launches}" if cycle == 0 else ""))
            if cycle == 0 and ("subcycle" not in phases or sched.last_path != "fast"):
                raise AssertionError(f"{label}: cycle 1 took the {sched.last_path} path with "
                                     f"phases {sorted(phases)}: the preempt must run in the "
                                     "object sub-cycle")
            publish_report(label, sched, 0.0, cycle + 1)
            check_contention_cycle(label, "cfg6", store, victims, pipes)
            evicted += victims
            for key in victims:  # the kubelet reaps the victims
                store.delete("Pod", key)
    finally:
        cap.close()
    if len(set(evicted)) != len(evicted):
        raise AssertionError(f"{label}: a pod was evicted twice")
    if history != CFG6D_PATTERN:
        raise AssertionError(f"{label}: per-cycle (evictions, pipelines, binds) {history}, "
                             f"the reference's pattern is {CFG6D_PATTERN}")
    unbound = [p.meta.key for p in store.list("Pod")
               if p.meta.name.startswith("hot") and not p.node_name]
    if unbound:
        raise AssertionError(f"{label}: storm pods unbound: {unbound[:5]}")
    check_placement_ports(store)
    want = {"water_fill": 1, "allocate_solve": 1, "allocate_solve_portsel": 1}
    for name, at_least in want.items():
        if launches[name] < at_least:
            raise AssertionError(f"{label}: kernel {name} launched {launches[name]} times on "
                                 f"the main path, expected at least {at_least}")
    for name in CONTENTION_KERNELS + MESH_CONTENTION_KERNELS + OBJECT_FORBID:
        if launches[name]:
            raise AssertionError(f"{label}: kernel {name} launched ({launches[name]})")
    log(f"[{label}] invariants hold; evictions per cycle {[h[0] for h in history]}")
    return launches


def phase_fast_cells():
    """Cells that never reach the object sub-cycle, alone, so that a parent
    tree (given this file) and a change are timed in one call: cfg5-batch,
    cfg5d and cfg6 (phases 3, 5 and 8's first cell), each with its checks
    and its cycle-1 wall split into phases in the log.  They publish
    through the applier (``async_conf``): a tree whose conf has no
    ``apply_mode`` publishes inline, so its walls do not pair with these."""
    phase_e2e("e2e batch", CFG5["jobs"], CFG5["best_effort"],
              want=("water_fill", "allocate_solve_batch"), steady=True,
              forbid=("allocate_solve",) + CONTENTION_KERNELS)
    phase_e2e("e2e cfg5d", CFG5["jobs"], CFG5["best_effort"],
              want={"water_fill": 1, "allocate_solve_batch": 2,
                    "allocate_solve_batch_portsel": 1},
              forbid=("allocate_solve", "allocate_solve_portsel") + CONTENTION_KERNELS,
              dynamic_frac=0.10, max_cycles=MAX_CYCLES_DYNAMIC)
    phase_contention("e2e cfg6", "cfg6", {"preempt_rounds": 1, "water_fill": 1},
                     ("reclaim_solve",) + MESH_CONTENTION_KERNELS)


#: the publish modes --publish-split compares, by apply_mode: the parent's
#: synchronous per-object path (now with its Events), and the applier with
#: one columnar segment a cycle
PUBLISH_MODES = {"sync": "sync", "async-columnar": "async"}
#: rounds of --publish-split at cfg5-batch and cfg6: each round runs every
#: mode, the order rotated a round; cfg5-batch's even rounds run cycle 2
#: with cycle 1's write-back in flight, its odd rounds after a flush
PUBLISH_SPLIT_ROUNDS = 4


def _publish_run(label, cell, mode, in_flight):
    """One store of ``cell`` ("cfg5-batch" or "cfg6") under ``mode``: cycle
    1, then cycle 2 either at once (with cycle 1's write-back in flight) or
    after a flush, then a flush.  cfg6's cycle 2 always waits for the flush:
    the kubelet reaps the victims once their eviction landed, and only then
    can the storm bind.  The cells' checks hold after the last flush.
    Returns the walls (cycle 1 and its publish split, the flush after cycle
    1 when cycle 2 waits for it, cycle 2's wall and drain phase, the last
    flush), ``drain_stats``, and the decisions (bind and eviction sets)."""
    import torch

    from volcano_tpu_torch.scheduler.conf import full_conf
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    conf = full_conf("cuda")
    conf.apply_mode = PUBLISH_MODES[mode]
    t0 = time.perf_counter()
    store = build_cfg5_store() if cell == "cfg5-batch" else build_contended_store("cfg6")
    sched = Scheduler(store, conf=conf)
    build_s, prewarm_s = time.perf_counter() - t0, sched.prewarm(background=False)
    out = {"cell": cell, "mode": mode, "cycle2": "in flight" if in_flight else "after a flush"}
    walls = []
    for cycle in (1, 2):
        if cycle == 2 and not in_flight:
            out["flush_after_cycle1_s"] = round(flush_applier(label, sched), 4)
            if cell == "cfg6":
                for key, _ in sched.cache.evict_log:  # the kubelet reaps the victims
                    store.delete("Pod", key)
        t0 = time.perf_counter()
        sched.run_once()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        ph = sched.fast_cycle.phases
        if sched.last_path != "fast":
            raise AssertionError(f"{label}: cycle {cycle} took the {sched.last_path} path")
        if cycle == 1:
            out.update({k: round(ph.get(k, 0.0), 4)
                        for k in ("publish", "publish_build", "publish_ship")})
            out["cycle1_s"] = round(walls[0], 4)
        else:
            out["cycle2_s"] = round(walls[1], 4)
            out["cycle2_drain_s"] = round(ph.get("drain", 0.0), 4)
    key = "flush_after_cycle2_s"
    out[key] = round(flush_applier(label, sched), 4)
    report = publish_report(label, sched, out[key], 2)
    out["drain_stats"] = report.get("drain_stats")
    out["err_log"] = report["err_log"]
    out["build_s"], out["prewarm_s"] = round(build_s, 1), round(prewarm_s, 2)
    if cell == "cfg5-batch":
        gang, be = check_placement(store)
        if gang != CFG5["jobs"] * CFG5["tasks_per_job"] or be != CFG5["best_effort"]:
            raise AssertionError(f"{label}: {gang} gang tasks and {be} best-effort bound")
    decisions = (tuple(sorted(sched.cache.bind_log)), tuple(sorted(sched.cache.evict_log)))
    sched.close()
    log(f"[{label}] {json.dumps(out)}")
    return out, decisions


def phase_publish_split():
    """The publish modes side by side in one call: cfg5-batch and cfg6 under
    each of PUBLISH_MODES in PUBLISH_SPLIT_ROUNDS rounds (the order rotated
    a round; cfg5-batch's cycle 2 alternately with the write-back in flight
    and after a flush), then cfg9 once under "sync" and once under "async-columnar"
    (cycle 1, the flush, cycle 2).  Every run of a cell must make the same
    binds and evictions; each holds its cell's checks and one Event a
    decision.  Returns every run's walls."""
    import torch

    rows = []
    modes = list(PUBLISH_MODES)
    for cell in ("cfg5-batch", "cfg6"):
        decided = {}
        for r in range(PUBLISH_SPLIT_ROUNDS):
            for mode in modes[r % len(modes):] + modes[:r % len(modes)]:
                label = f"publish-split {cell} {mode} round {r + 1}"
                row, decisions = _publish_run(label, cell, mode,
                                              in_flight=cell == "cfg5-batch" and r % 2 == 0)
                rows.append(row)
                decided.setdefault(decisions, []).append(label)
                gc.collect()
        if len(decided) != 1:
            raise AssertionError(f"publish-split {cell}: the runs decided differently: "
                                 f"{[v for v in decided.values()]}")
    from volcano_tpu_torch.scheduler.conf import full_conf
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    cfg9 = {}
    for mode in ("sync", "async-columnar"):
        label = f"publish-split cfg9 {mode}"
        conf = full_conf("cuda")
        conf.apply_mode, conf.mesh = PUBLISH_MODES[mode], CFG9_MESH
        t0 = time.perf_counter()
        store = build_cfg9_store()
        sched = Scheduler(store, conf=conf)
        out = {"cell": "cfg9", "mode": mode, "build_s": round(time.perf_counter() - t0, 1),
               "prewarm_s": round(sched.prewarm(background=False), 2)}
        for cycle in (1, 2):
            t0 = time.perf_counter()
            sched.run_once()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ph = sched.fast_cycle.phases
            out[f"cycle{cycle}_s"] = round(wall, 4)
            if cycle == 1:
                out.update({k: round(ph.get(k, 0.0), 4)
                            for k in ("publish", "publish_build", "publish_ship")})
                out["flush_after_cycle1_s"] = round(
                    flush_applier(label, sched, CFG9_FLUSH_TIMEOUT_S), 4)
            else:
                out["cycle2_drain_s"] = round(ph.get("drain", 0.0), 4)
        report = publish_report(label, sched, flush_applier(label, sched, CFG9_FLUSH_TIMEOUT_S), 2)
        out["drain_stats"], out["err_log"] = report.get("drain_stats"), report["err_log"]
        bound = check_cfg9_placement(store)
        if bound != CFG9["tasks"]:
            raise AssertionError(f"{label}: {bound} of {CFG9['tasks']} tasks bound")
        cfg9[mode] = sorted(sched.cache.bind_log)
        sched.close()
        log(f"[{label}] {json.dumps(out)}")
        rows.append(out)
        del sched, store
        gc.collect()
    if cfg9["sync"] != cfg9["async-columnar"]:
        raise AssertionError("publish-split cfg9: the two modes bound differently")
    return rows


RESTART_WAVE_GANGS = 250
#: the conf the restart phase loads: the repo's example, with the card
EXAMPLE_CONF = os.path.join("examples", "scheduler-conf.yaml")


def add_wave(store, tag, n_gangs=RESTART_WAVE_GANGS, seed=1):
    """A wave of ``n_gangs`` gangs x 20 tasks (config 5's request mix, in
    queue q{g % 2}), their PodGroups Pending for enqueue to admit."""
    from volcano_tpu_torch.api import (
        POD_GROUP_KEY, Metadata, Pod, PodGroup, PodGroupPhase, PodSpec, Resource,
    )

    rng = np.random.default_rng(seed)
    tpj = CFG5["tasks_per_job"]
    cpus = rng.choice([250, 500, 1000, 2000], n_gangs * tpj)
    mems = rng.choice([256, 512, 1024, 2048], n_gangs * tpj) * (1 << 20)
    for g in range(n_gangs):
        name = f"{tag}g{g:04d}"
        pg = PodGroup(meta=Metadata(name=name, namespace="default"), min_member=tpj,
                      queue=f"q{g % CFG5['queues']}")
        pg.status.phase = PodGroupPhase.PENDING
        store.create("PodGroup", pg)
        for t in range(tpj):
            k = g * tpj + t
            store.create("Pod", Pod(
                meta=Metadata(name=f"{name}-{t}", namespace="default",
                              annotations={POD_GROUP_KEY: name}),
                spec=PodSpec(resources=Resource(float(cpus[k]), float(mems[k])))))


def _warm_expected(tasks):
    """Kernel -> launches a blocking prewarm makes for its task names."""
    want = {"water_fill": 1}
    for name in tasks["critical"] + tasks["later"]:
        base = name.split("@")[0].split(":")[0]
        if base == "contention":
            continue  # the deferred part: its tasks follow under their names
        want[base] = want.get(base, 0) + 1
        if base.startswith("victim_step"):
            want["victim_groups"] = want.get("victim_groups", 0) + 1
    return want


def _new_binds(sched, since):
    return sorted(sched.cache.bind_log[since:])


def phase_restart_standby():
    """Config 5 under the repo's example conf (examples/scheduler-conf.yaml
    through the port's loader, backend: cuda, applyMode: async,
    mirrorCheckpoint in the checkout's build directory):

    * prewarm: a Scheduler prewarmed (blocking) against a twin that is not,
      each's first cycle timed; the prewarm leaves the store as it was and
      launches each warmed variant once; both cycles make the same binds;
    * restart: the prewarmed scheduler checkpoints its mirror after its
      cycle; a wave of 250 gangs x 20 arrives; a restarted Scheduler
      restores the checkpoint (timed) while the twin's new Scheduler lists
      the cluster (timed); their next cycles make the same binds;
    * standby: two schedulers with leader election on one store
      (``leader.LeaderElector``, one clock), a second wave: the leader's
      decisions stay queued behind a held applier entry, the standby binds
      nothing, the lease expires and the standby takes over and binds the
      wave, the deposed leader drops its queued decisions and rebuilds its
      mirror; the wave lands as the twin's single scheduler binds it."""
    import threading

    import torch

    from volcano_tpu_torch.leader import LeaderElector
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    label = "e2e cfg5-restart"
    here = os.path.dirname(os.path.abspath(__file__))
    build_dir = os.path.join(here, "build")
    os.makedirs(build_dir, exist_ok=True)
    ckpt = os.path.join(build_dir, "chip_smoke_mirror.ckpt")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    with open(os.path.join(here, EXAMPLE_CONF)) as f:
        text = f.read().replace("backend: tpu", "backend: cuda")
    text += f"applyMode: async\nmirrorCheckpoint: {ckpt}\n"
    t0 = time.perf_counter()
    store_a, store_b = (build_cfg5_store(CFG5["jobs"], CFG5["best_effort"]) for _ in range(2))
    log(f"[{label}] two config-5 stores built ({time.perf_counter() - t0:.1f} s)")
    scheds = []
    try:
        a = Scheduler.from_conf_yaml(store_a, text)
        b = Scheduler.from_conf_yaml(store_b, text.replace(f"mirrorCheckpoint: {ckpt}\n", ""))
        scheds += [a, b]
        if (a.conf.apply_mode != "async" or a.conf.mirror_checkpoint != ckpt
                or b.conf.mirror_checkpoint):
            raise AssertionError(f"{label}: the loaded conf is {a.conf}")
        log(f"[{label}] {EXAMPLE_CONF} loaded: backend {a.conf.backend}, actions "
            f"{','.join(a.conf.actions)}, apply_mode {a.conf.apply_mode}")
        rv0 = (store_a.resource_version, len(store_a.list("Event")))
        reset_launches()
        warm_s = a.prewarm(background=False)
        warm = read_launches()
        if (store_a.resource_version, len(store_a.list("Event"))) != rv0:
            raise AssertionError(f"{label}: the prewarm wrote to the store")
        if a.cache.bind_log or a.prewarm_errors or a.prewarm_device_error:
            raise AssertionError(f"{label}: prewarm bound {len(a.cache.bind_log)}, errors "
                                 f"{a.prewarm_errors} {a.prewarm_device_error}")
        want = _warm_expected(a.prewarm_tasks)
        got = {k: v for k, v in warm.items() if v}
        if got != want:
            raise AssertionError(f"{label}: prewarm launches {got}, its tasks "
                                 f"{a.prewarm_tasks} make {want}")
        log(f"[{label}] prewarm {warm_s:.3f} s (blocking, all parts), tasks "
            f"{json.dumps(a.prewarm_tasks)}, launches {got}")
        walls = {}
        for name, sched, store in (("prewarmed", a, store_a), ("cold", b, store_b)):
            t0 = time.perf_counter()
            sched.run_once()
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            flush = flush_applier(label, sched)
            gang, _ = check_placement(store)
            log(f"[{label}] {name} cycle 1 wall {walls[name]:.3f} s phases "
                f"{json.dumps({k: round(v, 4) for k, v in sched.fast_cycle.phases.items()})}, "
                f"flush {flush:.3f} s, {gang} gang tasks bound")
        if sorted(a.cache.bind_log) != sorted(b.cache.bind_log) or not a.cache.bind_log:
            raise AssertionError(f"{label}: the prewarmed and the cold scheduler's binds differ")
        t0 = time.perf_counter()
        if not a.save_mirror_checkpoint():
            raise AssertionError(f"{label}: the checkpoint was skipped after a flush")
        save_s = time.perf_counter() - t0
        log(f"[{label}] checkpoint saved in {save_s:.3f} s, {os.path.getsize(ckpt) / 2**20:.1f} "
            "MB")

        for store in (store_a, store_b):
            add_wave(store, "w1")
        c = Scheduler.from_conf_yaml(store_a, text)
        d = Scheduler.from_conf_yaml(store_b, text.replace(f"mirrorCheckpoint: {ckpt}\n", ""))
        scheds += [c, d]
        sync = {}
        for name, sched in (("restore", c), ("full list", d)):
            t0 = time.perf_counter()
            sched.fast_cycle.sync_mirror()
            sync[name] = time.perf_counter() - t0
        if not c.fast_cycle.restored_from_checkpoint or d.fast_cycle.restored_from_checkpoint:
            raise AssertionError(f"{label}: restored {c.fast_cycle.restored_from_checkpoint} / "
                                 f"{d.fast_cycle.restored_from_checkpoint}")
        cyc = {}
        for name, sched in (("restored", c), ("listed", d)):
            t0 = time.perf_counter()
            sched.run_once()
            torch.cuda.synchronize()
            cyc[name] = time.perf_counter() - t0
            flush_applier(label, sched)
        if sorted(c.cache.bind_log) != sorted(d.cache.bind_log):
            raise AssertionError(f"{label}: the restored scheduler's binds differ from the "
                                 "full-list scheduler's")
        n_wave = RESTART_WAVE_GANGS * CFG5["tasks_per_job"]
        if len(c.cache.bind_log) != n_wave:
            raise AssertionError(f"{label}: {len(c.cache.bind_log)} of the wave's {n_wave} "
                                 "tasks bound")
        log(f"[{label}] restart: mirror restore {sync['restore']:.3f} s against a full list "
            f"{sync['full list']:.3f} s; next cycle {cyc['restored']:.3f} / "
            f"{cyc['listed']:.3f} s, the same {len(c.cache.bind_log)} binds")

        # standby: c leads store_a, e stands by; d alone on store_b is the reference
        clock = [0.0]
        c.elector = LeaderElector(store_a, "vtt-scheduler", "c", clock=lambda: clock[0])
        e = Scheduler.from_conf_yaml(store_a, text.replace(f"mirrorCheckpoint: {ckpt}\n", ""),
                                     elector=LeaderElector(store_a, "vtt-scheduler", "e",
                                                           clock=lambda: clock[0]))
        scheds.append(e)
        e.fast_cycle.sync_mirror()
        for store in (store_a, store_b):
            add_wave(store, "w2", seed=2)
        gate, gate_op = threading.Event(), {"op": "patch", "kind": "PodGroup",
                                            "key": "default/pg00000", "fields": {}}
        bulk = store_a.bulk

        def held_bulk(ops):
            if any(op is gate_op for op in ops):
                gate.wait(300)
            return bulk(ops)

        store_a.bulk = held_bulk
        resets = []
        reset = c.fast_cycle.reset_after_abort
        c.fast_cycle.reset_after_abort = lambda: (resets.append(1), reset())[1]
        applier = c.cache.applier
        n_c = len(c.cache.bind_log)
        try:
            applier.submit_ops([gate_op])
            for _ in range(6000):
                if applier.pending == 1 and not applier._q:
                    break
                time.sleep(0.005)
            else:
                raise AssertionError(f"{label}: the applier did not take the held entry")
            c.run_once()  # leads: the wave's decisions queue behind the held entry
            queued = len(applier._q)
            if not queued:
                raise AssertionError(f"{label}: the leader's decisions did not queue")
            e.run_once()  # the lease is held: stand by
            if e.last_path != "standby" or e.cache.bind_log:
                raise AssertionError(f"{label}: the standby ran {e.last_path} and bound "
                                     f"{len(e.cache.bind_log)}")
            clock[0] = 20.0  # c stopped renewing; its 15 s lease expired
            t0 = time.perf_counter()
            e.run_once()  # takes over and binds the wave
            torch.cuda.synchronize()
            e_wall = time.perf_counter() - t0
            c.run_once()  # deposed: drops its queued decisions, rebuilds its mirror
            if c.last_path != "standby" or applier._q or resets != [1]:
                raise AssertionError(f"{label}: the deposed leader ran {c.last_path}, kept "
                                     f"{len(applier._q)} entries, reset {len(resets)} times")
        finally:
            gate.set()
            store_a.bulk = bulk
        flush_applier(label, c)
        flush_applier(label, e)
        d_since = len(d.cache.bind_log)
        d.run_once()
        flush_applier(label, d)
        want = _new_binds(d, d_since)
        got = sorted(e.cache.bind_log)
        placed = sorted((p.meta.key, p.node_name) for p in store_a.list("Pod")
                        if p.meta.name.startswith("w2"))
        if got != want or placed != want or len(want) != n_wave:
            raise AssertionError(f"{label}: the new leader bound {len(got)}, the store holds "
                                 f"{len(placed)} of the wave, a single scheduler binds "
                                 f"{len(want)}")
        m = c.fast_cycle.mirror
        rows = [m.pods.key_row[k] for k, _ in want]
        if (m.p_node[rows] < 0).any():
            raise AssertionError(f"{label}: the deposed leader's rebuilt mirror misses binds")
        log(f"[{label}] standby: the leader's cycle queued {queued} entries ({len(c.cache.bind_log) - n_c} "
            f"binds) and dropped them when deposed; the standby bound nothing, took over "
            f"and bound the wave's {len(got)} tasks in {e_wall:.3f} s, as the single "
            "scheduler does")
    finally:
        for sched in scheds:
            sched.close()
        if os.path.exists(ckpt):
            os.remove(ckpt)
    return dict(prewarm_s=warm_s, cycle1_prewarmed_s=walls["prewarmed"],
                cycle1_cold_s=walls["cold"], checkpoint_save_s=save_s,
                restore_s=sync["restore"], full_list_s=sync["full list"])


# ---- cfg10: incremental scheduling (delta: on) on a resident config-5 cluster

#: bench.py config10_delta at config 5's widths: 10,000 nodes, 100,000
#: resident RUNNING tasks as 5,000 gangs x 20 (_build_delta_store), a trickle
#: of 2-pod gangs of 100m / 64 MiB, a population of 64 live trickle gangs and
#: departure waves of 8; the trickle keeps bench's 200 cycles, its run under
#: delta off takes ``off_trickle`` (cut for the run's time)
CFG10 = dict(nodes=10_000, tasks=100_000, tasks_per_job=20, gang=2, population=64, wave=8,
             warmup=8, trickle=200, off_trickle=40, scale=10, parity_cycles=40, sat_qps=250.0,
             sat_s=4.0)
#: micro cycles the trickle must take at the least
CFG10_MIN_MICRO = 40
#: the only full-build reasons a trickle may show
CFG10_FALLBACKS = ("arm", "job-remove")


@_no_gc
def build_delta_store(n_nodes, n_tasks, tasks_per_job=CFG10["tasks_per_job"]):
    """bench.py _build_delta_store with the port's objects: RUNNING gangs of
    ``tasks_per_job`` pinned round-robin on nodes of 32 CPUs / 64 GiB with a
    pod cap of 200, every pod 250m / 256 MiB, one queue."""
    from volcano_tpu_torch.api import (
        POD_GROUP_KEY, Metadata, Node, Pod, PodGroup, PodGroupPhase, PodPhase, PodSpec, Queue,
        Resource,
    )
    from volcano_tpu_torch.store import Store

    store = Store()
    store.create("Queue", Queue(meta=Metadata(name="default", namespace=""), weight=1))
    for i in range(n_nodes):
        store.create("Node", Node(meta=Metadata(name=f"n{i:05d}", namespace=""),
                                  allocatable=Resource(32000.0, 64.0 * (1 << 30),
                                                       max_task_num=200)))
    for j in range(max(n_tasks // tasks_per_job, 1)):
        pg = PodGroup(meta=Metadata(name=f"res{j:05d}", namespace="default"),
                      min_member=tasks_per_job, queue="default")
        pg.status.phase = PodGroupPhase.RUNNING
        store.create("PodGroup", pg)
        for t in range(tasks_per_job):
            store.create("Pod", Pod(
                meta=Metadata(name=f"res{j:05d}-{t}", namespace="default",
                              annotations={POD_GROUP_KEY: f"res{j:05d}"}),
                spec=PodSpec(resources=Resource(250.0, 256.0 * (1 << 20))),
                phase=PodPhase.RUNNING, node_name=f"n{(j * tasks_per_job + t) % n_nodes:05d}"))
    return store


def _delta_conf(oracle=False):
    from volcano_tpu_torch.scheduler.conf import full_conf

    conf = full_conf("cuda")
    conf.delta, conf.delta_oracle = "on", oracle
    return conf


class Trickle:
    """bench.py config10_delta's trickle on one store: a 2-pod gang a
    cycle; past the population, the oldest wave of gangs departs first."""

    def __init__(self, store):
        from collections import deque

        self.store = store
        self.live = deque()
        #: gang -> the trickle cycle it arrived before, until seen bound
        self.unbound = {}

    def submit(self, name, cycle):
        from volcano_tpu_torch.api import POD_GROUP_KEY, Metadata, Pod, PodGroup, PodSpec, Resource

        self.store.create("PodGroup", PodGroup(meta=Metadata(name=name, namespace="default"),
                                               min_member=CFG10["gang"], queue="default"))
        for t in range(CFG10["gang"]):
            self.store.create("Pod", Pod(
                meta=Metadata(name=f"{name}-{t}", namespace="default",
                              annotations={POD_GROUP_KEY: name}),
                spec=PodSpec(resources=Resource(100.0, 64.0 * (1 << 20)))))
        self.live.append(name)
        self.unbound[name] = cycle

    def step(self, name, cycle):
        """The next arrival, and a departure wave past the population;
        True when a wave departed."""
        self.submit(name, cycle)
        if len(self.live) <= CFG10["population"]:
            return False
        for _ in range(CFG10["wave"]):
            old = self.live.popleft()
            for t in range(CFG10["gang"]):
                self.store.delete("Pod", f"default/{old}-{t}")
            self.store.delete("PodGroup", f"default/{old}")
            self.unbound.pop(old, None)
        return True

    def check(self, label, cycle, deadline=MAX_CYCLES):
        """Fails if a gang waits for its binds past ``deadline`` cycles."""
        for name, since in list(self.unbound.items()):
            pods = [self.store.get("Pod", f"default/{name}-{t}") for t in range(CFG10["gang"])]
            if all(p is not None and p.node_name for p in pods):
                del self.unbound[name]
            elif cycle - since + 1 >= deadline:
                raise AssertionError(f"{label}: gang {name} unbound {cycle - since + 1} cycles "
                                     f"after it arrived")


def _pct(xs, q):
    return round(float(np.percentile(np.asarray(xs), q)), 3) if xs else None


#: cfg5-batch's steady cycles run with the profiler and the tracer armed
ARMED_STEADY_CYCLES = 3
#: the share of a cycle's wall vtprof must attribute to named segments (the
#: JAX package's test_vtprof bound)
ATTRIBUTION_BAR = 0.95


def _arm_observability():
    """Arm vtprof and the tracer, and hand the profiler its warmup
    handshake at once: the launch shapes, workspaces and builds so far were
    the warmup.  Returns (profiler, tracer)."""
    from volcano_tpu_torch import trace, vtprof

    prof = vtprof.arm()
    tr = trace.arm(trace.Tracer(ring=8192))
    prof.warmup_handshake()
    return prof, tr


def _disarm_observability():
    from volcano_tpu_torch import trace, vtprof

    trace.disarm()
    vtprof.disarm()


def _check_dispatches(label, prof, launches):
    """vtprof's per-kernel dispatch counts equal the wrappers' LAUNCHES
    over the same cycles (the _portsel / _volsel rows count a flag of a
    launch counted under its kernel's own name)."""
    got = {k: int(v["dispatches"]) for k, v in prof.totals.items() if v["dispatches"]}
    want = {k: v for k, v in launches.items() if v and not k.endswith(("_portsel", "_volsel"))}
    if got != want:
        raise AssertionError(f"{label}: vtprof dispatches {got} != LAUNCHES {want}")
    return got


def _scrape(label):
    """One scrape of the metrics server's /metrics, /debug/prof and
    /debug/trace while armed; fails unless each answers with the armed
    profile's series.  Returns the bodies' sizes in bytes."""
    import urllib.request

    from volcano_tpu_torch.scheduler.metrics_server import MetricsServer

    srv = MetricsServer(port=0).start()
    sizes = {}
    try:
        for path in ("/metrics", "/debug/prof", "/debug/trace"):
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}", timeout=30) as r:
                body = r.read()
            sizes[path] = len(body)
            if path == "/metrics":
                text = body.decode()
                for family in ("volcano_e2e_scheduling_latency_milliseconds",
                               "volcano_prof_segment_seconds", "volcano_device_bytes"):
                    if family not in text:
                        raise AssertionError(f"{label}: /metrics lacks {family}")
            else:
                payload = json.loads(body)
                if not payload.get("armed") or not payload.get(
                        "cycles" if path == "/debug/prof" else "spans"):
                    raise AssertionError(f"{label}: {path} answered {str(payload)[:200]}")
    finally:
        srv.stop()
    return sizes


#: the observability modes the armed cycles rotate through: disarmed,
#: vtprof alone, vtprof and the tracer
OBS_MODES = ("off", "prof", "both")


def _set_observability(obs, mode):
    """Arm ``obs`` (a (profiler, tracer) pair) for ``mode`` of OBS_MODES."""
    from volcano_tpu_torch import trace, vtprof

    if mode == "off":
        vtprof.disarm()
    else:
        vtprof.arm(obs[0])
    if mode == "both":
        trace.arm(obs[1])
    else:
        trace.disarm()


def _attribution_by_mode(payload, modes):
    """vtprof's attribution over the profiled cycles of each armed mode
    (``modes``: the armed cycles' modes, in order)."""
    from volcano_tpu_torch import vtprof

    out = {}
    for mode in ("prof", "both"):
        cycles = [c for c, m in zip(payload["cycles"], modes) if m == mode]
        out[mode] = vtprof.attribution(dict(payload, cycles=cycles))
    return out


def armed_steady(label, sched, disarmed_wall):
    """cfg5-batch's steady cycles under the observability modes in turns
    (OBS_MODES, ARMED_STEADY_CYCLES rounds, so that a drift of the cycle
    wall falls on each mode alike), launch counts reset before each: the
    same decisions as the disarmed cycles (none), vtprof's attribution of
    the cycles it profiled alone at least ATTRIBUTION_BAR (the tracer's own
    cost is host time no phase holds), its dispatch counts equal to the
    armed cycles' LAUNCHES, no steady-state anomaly after the warmup
    handshake, and one scrape of the metrics server; each mode's walls.
    These cycles find no pending work and launch no kernel: the bar holds
    the split of host phases, and both dispatch counts are empty.  The
    split of device work (dispatch, wait, transfer) is held to the bar at
    cfg10's micro cycles (phase_cfg10), which launch K1 and K2."""
    import collections

    import torch

    from volcano_tpu_torch import vtprof

    binds, evicts = len(sched.cache.bind_log), len(sched.cache.evict_log)
    obs = _arm_observability()
    walls = {m: [] for m in OBS_MODES}
    armed_launches, armed_modes = collections.Counter(), []
    try:
        for _ in range(ARMED_STEADY_CYCLES):
            for mode in OBS_MODES:
                _set_observability(obs, mode)
                reset_launches()
                t0 = time.perf_counter()
                sched.run_once()
                torch.cuda.synchronize()
                walls[mode].append(time.perf_counter() - t0)
                flush_applier(label, sched)
                if mode != "off":
                    armed_launches.update(read_launches())
                    armed_modes.append(mode)
        _set_observability(obs, "both")
        payload = obs[0].payload()
        att = _attribution_by_mode(payload, armed_modes)
        dispatches = _check_dispatches(label, obs[0], armed_launches)
        anomalies = obs[0].anomalies_snapshot()
        sizes = _scrape(label)
        spans = sorted({r["name"] for r in obs[1].records()})
    finally:
        _disarm_observability()
    if (len(sched.cache.bind_log), len(sched.cache.evict_log)) != (binds, evicts):
        raise AssertionError(f"{label}: steady cycles made decisions")
    if att["prof"]["coverage"] < ATTRIBUTION_BAR:
        raise AssertionError(f"{label}: vtprof attributes {att['prof']['coverage']:.4f} of its "
                             f"cycles' wall (bar {ATTRIBUTION_BAR})")
    if anomalies:
        raise AssertionError(f"{label}: anomalies in armed steady cycles: {anomalies}")
    out = dict(first_steady_wall_s=disarmed_wall, walls_s=walls,
               coverage=att["prof"]["coverage"], coverage_with_tracer=att["both"]["coverage"],
               segments=att["prof"]["segments"], dispatches=dispatches, scrape_bytes=sizes,
               spans=spans)
    log(f"[{label}] armed steady cycles: {json.dumps(out)}")
    log(f"[{label}] steady cycle walls in turns, s: disarmed "
        f"{[round(w, 4) for w in walls['off']]}; vtprof {[round(w, 4) for w in walls['prof']]} "
        f"(attributed {att['prof']['coverage']:.4f}); vtprof and the tracer "
        f"{[round(w, 4) for w in walls['both']]} (attributed "
        f"{att['both']['coverage']:.4f})")
    log(vtprof.report_text(payload))
    return out


def phase_cfg10():
    """cfg10 at config 5's widths under full_conf("cuda") with delta on:
    one arm cycle and 8 unmeasured warm-up cycles, then the trickle, each
    cycle's launch counts reset just before it and read just after.  Micro
    and full cycle walls (p50 / p99), each mode's phases (p50), fallback
    reasons, K1 / K2 launches a cycle, and the (T, N, J, Q, C) of every
    allocate solve.  Fails unless every trickle gang binds within two
    cycles, at least CFG10_MIN_MICRO cycles are micro, every full build's
    reason is arm or job-remove, every micro cycle launches K1 and K2 once
    (no other solve) at one shape, no kernel library is built and the
    victim kernels' per-shape workspaces gain no key.  The trickle's second
    half rotates through OBS_MODES after the warmup handshake: no
    steady-state-recompile anomaly in an armed micro cycle, vtprof's
    attribution of the micro cycles it profiled alone at least
    ATTRIBUTION_BAR, and its dispatch counts equal to LAUNCHES.  K2 is then held to
    its plain version on the first micro cycle's solve inputs, and the
    same trickle runs on under delta off (_cfg10_delta_off).  Returns the
    phase's figures."""
    import collections

    import torch

    from volcano_tpu_torch import _build
    from volcano_tpu_torch.scheduler import kernels as K
    from volcano_tpu_torch.scheduler import victim_kernels as VK
    from volcano_tpu_torch.scheduler.fastpath import cycle as cycle_mod
    from volcano_tpu_torch.scheduler.scheduler import Scheduler
    from volcano_tpu_torch.scheduler.tensor_actions import solve_inputs

    label = "e2e cfg10"
    t0 = time.perf_counter()
    store = build_delta_store(CFG10["nodes"], CFG10["tasks"])
    log(f"[{label}] store built: {CFG10['nodes']} nodes, {CFG10['tasks']} resident running "
        f"tasks in gangs of {CFG10['tasks_per_job']} ({time.perf_counter() - t0:.1f} s)")
    sched = Scheduler(store, conf=_delta_conf())
    fc = sched.fast_cycle
    log(f"[{label}] prewarm {sched.prewarm(background=False):.2f} s")
    trickle = Trickle(store)
    t0 = time.perf_counter()
    sched.run_once()
    log(f"[{label}] arm cycle {time.perf_counter() - t0:.3f} s, mode "
        f"{fc.delta.last['mode']} / {fc.delta.last['fallback_reason']}")
    for i in range(CFG10["warmup"]):
        trickle.submit(f"wm{i:03d}", i)
        sched.run_once()
        trickle.check(label + " warm-up", i)

    solve = cycle_mod.torch_allocate_solve
    calls = []

    def recording(backend, snap, n_pending=None):
        calls.append((backend, snap))
        return solve(backend, snap, n_pending)

    builds = []
    build = _build.build

    def counting_build(*a, **kw):
        builds.append(1)
        return build(*a, **kw)

    ws_before = set(VK._WORKSPACES)
    lat = {"micro": [], "full": []}
    phases = {"micro": collections.defaultdict(list), "full": collections.defaultdict(list)}
    reasons = collections.Counter()
    launches = {"micro": [], "full": []}
    shapes = {"micro": set(), "full": set()}
    first_micro = None
    waves = 0
    # the trickle's second half rotates through the observability modes
    # (OBS_MODES: disarmed, vtprof, vtprof and the tracer), cycle by cycle
    arm_at = CFG10["trickle"] // 2
    obs = None
    armed = {"launches": collections.Counter(), "modes": [], "anomalies": [],
             "micro_ms": {m: [] for m in OBS_MODES}}
    cycle_mod.torch_allocate_solve, _build.build = recording, counting_build
    try:
        for i in range(CFG10["trickle"]):
            if i == arm_at:
                obs = _arm_observability()
            obs_mode = OBS_MODES[(i - arm_at) % len(OBS_MODES)] if obs is not None else None
            if obs is not None:
                _set_observability(obs, obs_mode)
            waves += trickle.step(f"tk{i:04d}", i)
            calls.clear()
            reset_launches()
            t0 = time.perf_counter()
            sched.run_once()
            torch.cuda.synchronize()
            dt_ms = (time.perf_counter() - t0) * 1e3
            got = read_launches()
            mode = fc.delta.last["mode"]
            if sched.last_path != "fast":
                raise AssertionError(f"{label}: trickle cycle {i} took the {sched.last_path} path")
            lat[mode].append(dt_ms)
            launches[mode].append(got)
            for backend, snap in calls:
                shapes[mode].add((snap.task_req.shape[0], snap.node_idle.shape[0],
                                  snap.job_queue.shape[0], snap.queue_weight.shape[0],
                                  snap.class_node_mask.shape[0]))
            for k, v in fc.phases.items():
                phases[mode][k].append(v * 1e3)
            if mode == "micro":
                if first_micro is None and calls:
                    first_micro = calls[0]
            else:
                reasons[fc.delta.last["fallback_reason"]] += 1
            if obs is not None:
                if mode == "micro":
                    armed["micro_ms"][obs_mode].append(dt_ms)
                if obs_mode != "off":
                    armed["launches"].update(got)
                    # the attribution bar holds the micro cycles (a full
                    # cycle's mode is "full", which no bar reads)
                    armed["modes"].append(obs_mode if mode == "micro" else "full")
                    fresh = obs[0].anomalies_snapshot()[len(armed["anomalies"]):]
                    armed["anomalies"] += [dict(a, mode=mode) for a in fresh]
            trickle.check(label, i)
        if obs is not None:
            armed["payload"] = obs[0].payload()
            armed["dispatches"] = _check_dispatches(label, obs[0], armed["launches"])
            armed["spans"] = collections.Counter(r["name"] for r in obs[1].records())
            _disarm_observability()
            obs = None
        sched.run_once()  # the last arrivals' second cycle
        trickle.check(label, CFG10["trickle"])
    finally:
        cycle_mod.torch_allocate_solve, _build.build = solve, build
        if obs is not None:
            _disarm_observability()
    if trickle.unbound:
        raise AssertionError(f"{label}: gangs unbound after the trickle: {trickle.unbound}")
    bound = check_cfg9_placement(store)

    n_micro = len(lat["micro"])
    bad = {r: n for r, n in reasons.items() if r not in CFG10_FALLBACKS}
    if n_micro < CFG10_MIN_MICRO:
        raise AssertionError(f"{label}: {n_micro} micro cycles in {CFG10['trickle']}")
    if bad:
        raise AssertionError(f"{label}: full builds for {bad} in the trickle")
    for got in launches["micro"]:
        if got["water_fill"] != 1 or got["allocate_solve"] != 1:
            raise AssertionError(f"{label}: a micro cycle's launches {got}")
        other = {k: v for k, v in got.items()
                 if v and k not in ("water_fill", "allocate_solve")}
        if other:
            raise AssertionError(f"{label}: a micro cycle launched {other}")
    if len(shapes["micro"]) != 1:
        raise AssertionError(f"{label}: micro cycles passed shapes {sorted(shapes['micro'])}")
    if builds or set(VK._WORKSPACES) != ws_before:
        raise AssertionError(f"{label}: {len(builds)} kernel builds, workspaces "
                             f"{sorted(ws_before)} -> {sorted(VK._WORKSPACES)}")

    def per_cycle(mode, name):
        runs = launches[mode]
        return round(sum(g[name] for g in runs) / max(len(runs), 1), 3)

    out = {
        "nodes": CFG10["nodes"], "resident_tasks": CFG10["tasks"],
        "trickle_cycles": CFG10["trickle"], "micro_cycles": n_micro,
        "full_cycles": len(lat["full"]), "wave_cycles": waves, "bound_tasks": bound,
        "micro_p50_ms": _pct(lat["micro"], 50), "micro_p99_ms": _pct(lat["micro"], 99),
        "full_p50_ms": _pct(lat["full"], 50), "full_p99_ms": _pct(lat["full"], 99),
        "full_reasons": dict(reasons),
        "micro_phases_p50_ms": {k: _pct(v, 50) for k, v in phases["micro"].items()},
        "full_phases_p50_ms": {k: _pct(v, 50) for k, v in phases["full"].items()},
        "k1_per_micro_cycle": per_cycle("micro", "water_fill"),
        "k2_per_micro_cycle": per_cycle("micro", "allocate_solve"),
        "k1_per_full_cycle": per_cycle("full", "water_fill"),
        "k2_per_full_cycle": per_cycle("full", "allocate_solve"),
        "micro_shapes_TNJQC": sorted(shapes["micro"]),
        "full_shapes_TNJQC": sorted(shapes["full"]),
        "kernel_builds": len(builds),
    }
    log(f"[{label}] trickle: {json.dumps(out)}")
    from volcano_tpu_torch import vtprof

    recompiles = [a for a in armed["anomalies"]
                  if a["kind"] == "steady-state-recompile" and a["mode"] == "micro"]
    if recompiles:
        raise AssertionError(f"{label}: steady-state-recompile anomalies in armed micro "
                             f"cycles: {recompiles}")
    att = _attribution_by_mode(armed["payload"], armed["modes"])
    if att["prof"]["coverage"] < ATTRIBUTION_BAR:
        raise AssertionError(f"{label}: vtprof attributes {att['prof']['coverage']:.4f} of its "
                             f"micro cycles' wall (bar {ATTRIBUTION_BAR})")
    micro = armed["micro_ms"]
    out["armed"] = dict(
        from_cycle=arm_at,
        micro_cycles={m: len(v) for m, v in micro.items()},
        full_cycles_armed=armed["modes"].count("full"),
        micro_p50_ms={m: _pct(v, 50) for m, v in micro.items()},
        micro_p99_ms={m: _pct(v, 99) for m, v in micro.items()},
        micro_coverage={m: a["coverage"] for m, a in att.items()},
        segments={m: a["segments"] for m, a in att.items()},
        dispatches=armed["dispatches"], anomalies=armed["anomalies"],
        spans=dict(armed["spans"]))
    log(f"[{label}] observability in turns (cycles {arm_at}-{CFG10['trickle'] - 1}): "
        f"{json.dumps(out['armed'])}")
    log(f"[{label}] micro cycle walls in turns, p50 / p99 ms: disarmed "
        f"{_pct(micro['off'], 50)} / {_pct(micro['off'], 99)}, vtprof "
        f"{_pct(micro['prof'], 50)} / {_pct(micro['prof'], 99)}, vtprof and the tracer "
        f"{_pct(micro['both'], 50)} / {_pct(micro['both'], 99)}; no steady-state-recompile "
        f"anomaly in {len(micro['prof']) + len(micro['both'])} armed micro cycles")
    log(vtprof.report_text(armed["payload"]))

    # K2 (and the K1 inside it) at the micro cycles' shape against the plain version
    backend, snap = first_micro
    inputs = solve_inputs(backend, snap, False)
    w_least, w_balanced = backend.score_weights()
    policy = dict(job_key_order=backend.job_key_order, use_gang_ready=backend.gang_job_ready,
                  use_proportion=backend.proportion_queue_order)
    args = [inputs[k] for k in K._SOLVE_ARGS] + [w_least, w_balanced]
    out_k = K.allocate_solve(*args, **policy)
    plain, plain_ms = _timed(lambda: K.allocate_solve_plain(
        **inputs, w_least=w_least, w_balanced=w_balanced, **policy))
    err = _compare("allocate_solve cfg10", out_k, plain)
    ms = cuda_ms(lambda: K.allocate_solve(*args, **policy), 20)
    b, kind = bound_ms(nbytes(*inputs.values()) + nbytes(*out_k[:10]),
                       _exact_solve_ops(out_k, inputs))
    out["k2_at_micro_shape"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=kind,
                                    max_abs_err=err, steps=int(out_k.steps))
    log(f"[{label}] K2 at the micro shape {sorted(shapes['micro'])[0]} ok: {ms:.4f} ms "
        f"(plain {plain_ms:.1f} ms, bound {b:.5f} ms by {kind}), {int(out_k.steps)} steps")
    sched.close()
    del sched, first_micro, calls
    out["delta_off"] = _cfg10_delta_off(label, store, trickle)
    log(f"[{label}] cycle walls, ms: delta on micro p50 {out['micro_p50_ms']} / p99 "
        f"{out['micro_p99_ms']}, delta on full p50 {out['full_p50_ms']} / p99 "
        f"{out['full_p99_ms']}; delta off p50 {out['delta_off']['p50_ms']} / p99 "
        f"{out['delta_off']['p99_ms']} (with a departure wave p50 "
        f"{out['delta_off']['wave_p50_ms']}, without p50 {out['delta_off']['arrival_p50_ms']})")
    del store
    gc.collect()
    return out


def _cfg10_delta_off(label, store, trickle):
    """The same trickle on the same store (its resident tasks and live
    trickle gangs) under delta off, the default: a new Scheduler with
    full_conf("cuda"), its first cycle and CFG10["warmup"] warm-up cycles
    unmeasured, then CFG10["off_trickle"] cycles timed, each a full build;
    every gang bound within two cycles.  Returns the walls (p50 / p99 of
    all cycles, of those with a departure wave and of those without) and
    the phases (p50)."""
    import collections

    import torch

    from volcano_tpu_torch.scheduler.conf import full_conf
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    label += ", delta off"
    sched = Scheduler(store, conf=full_conf("cuda"))
    log(f"[{label}] prewarm {sched.prewarm(background=False):.2f} s")
    t0 = time.perf_counter()
    sched.run_once()
    log(f"[{label}] first cycle {time.perf_counter() - t0:.3f} s")
    start = CFG10["trickle"] + 1
    for i in range(start, start + CFG10["warmup"]):
        trickle.step(f"tk{i:04d}", i)
        sched.run_once()
        trickle.check(label + " warm-up", i)
    lat = {True: [], False: []}
    phases = collections.defaultdict(list)
    start += CFG10["warmup"]
    for i in range(start, start + CFG10["off_trickle"]):
        wave = trickle.step(f"tk{i:04d}", i)
        t0 = time.perf_counter()
        sched.run_once()
        torch.cuda.synchronize()
        lat[wave].append((time.perf_counter() - t0) * 1e3)
        if sched.last_path != "fast":
            raise AssertionError(f"{label}: trickle cycle {i} took the {sched.last_path} path")
        for k, v in sched.fast_cycle.phases.items():
            phases[k].append(v * 1e3)
        trickle.check(label, i)
    sched.run_once()
    trickle.check(label, start + CFG10["off_trickle"])
    if trickle.unbound:
        raise AssertionError(f"{label}: gangs unbound after the trickle: {trickle.unbound}")
    sched.close()
    walls = lat[True] + lat[False]
    out = {"cycles": len(walls), "wave_cycles": len(lat[True]),
           "p50_ms": _pct(walls, 50), "p99_ms": _pct(walls, 99),
           "wave_p50_ms": _pct(lat[True], 50), "wave_p99_ms": _pct(lat[True], 99),
           "arrival_p50_ms": _pct(lat[False], 50), "arrival_p99_ms": _pct(lat[False], 99),
           "phases_p50_ms": {k: _pct(v, 50) for k, v in phases.items()}}
    log(f"[{label}] trickle: {json.dumps(out)}")
    return out


def phase_cfg10_tenth():
    """cfg10 at 1/10 scale (1,000 nodes, 10,000 resident tasks), on the
    card: the trickle on one store under delta on with the
    snapshot-incremental oracle (a full build beside every micro build,
    equal bit for bit, or the cycle raises) and on a copy under delta off,
    their binds equal cycle by cycle; then one lockstep open-loop run at
    250 gangs/s as config10_delta.run_at runs it (bench.py's saturation
    step, not the doubling search), which must sustain and bind every
    pod.  Returns the figures."""
    from volcano_tpu_torch.loadgen import LoadGen, LoadSpec, run_open_loop
    from volcano_tpu_torch.scheduler.conf import full_conf
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    label = "e2e cfg10/10"
    n_nodes, n_tasks = CFG10["nodes"] // CFG10["scale"], CFG10["tasks"] // CFG10["scale"]
    runs = {}
    for mode, conf in (("delta", _delta_conf(oracle=True)), ("full", full_conf("cuda"))):
        store = build_delta_store(n_nodes, n_tasks)
        sched = Scheduler(store, conf=conf)
        sched.prewarm(background=False)
        runs[mode] = (store, sched, Trickle(store))
    modes = []
    walls = {mode: [] for mode in runs}
    # the delta-on run's cycles run with vtprof and the tracer armed, the
    # delta-off run's disarmed: equal binds make the armed run's decisions
    # the disarmed one's
    obs = _arm_observability()
    try:
        for i in range(CFG10["parity_cycles"]):
            for mode, (store, sched, trickle) in runs.items():
                _set_observability(obs, "both" if mode == "delta" else "off")
                trickle.step(f"tk{i:04d}", i)
                t0 = time.perf_counter()
                sched.run_once()
                walls[mode].append((time.perf_counter() - t0) * 1e3)
                trickle.check(f"{label} {sched.conf.delta}", i)
            if runs["delta"][1].cache.bind_log != runs["full"][1].cache.bind_log:
                raise AssertionError(f"{label}: cycle {i} binds differ with delta on (armed) "
                                     f"and off (disarmed)")
            modes.append(runs["delta"][1].fast_cycle.delta.last["mode"])
    finally:
        _disarm_observability()
    log(f"[{label}] armed (delta on: vtprof and the tracer, "
            f"{len(obs[0].payload()['cycles'])} profiled cycles, {len(obs[1].records())} "
            f"spans) and disarmed (delta off) runs: equal binds in every cycle")
    n_micro = modes.count("micro")
    if n_micro < CFG10["parity_cycles"] // 2:
        raise AssertionError(f"{label}: {n_micro} micro cycles of {len(modes)}")
    binds = len(runs["delta"][1].cache.bind_log)
    log(f"[{label}] delta on (oracle on every micro build) and off: equal binds in each of "
        f"{len(modes)} cycles ({binds} binds, {n_micro} micro cycles); cycle walls p50 / p99 "
        f"ms: delta on with the oracle {_pct(walls['delta'], 50)} / {_pct(walls['delta'], 99)}, "
        f"delta off {_pct(walls['full'], 50)} / {_pct(walls['full'], 99)}")
    del runs

    store = build_delta_store(n_nodes, n_tasks)
    sched = Scheduler(store, conf=_delta_conf())
    sched.prewarm(background=False)
    spec = LoadSpec(qps=CFG10["sat_qps"], duration_s=CFG10["sat_s"], seed=10,
                    gang_sizes=((1, 6.0), (2, 3.0)), cpu_millis=(100,), mem_mb=(64,),
                    namespace="sat")
    gen = LoadGen(store, spec)
    report = run_open_loop(store, spec, sched.run_once, tick_s=0.05, settle_s=60.0, gen=gen)
    # lockstep virtual time waits for every cycle: "sustained" holds at any
    # wall rate, which is the arrivals over the run's wall time
    wall_rate = len(gen.schedule) / report.wall_s
    log(f"[{label}] lockstep open loop at {spec.qps:.0f} gangs/s for {spec.duration_s} s of "
        f"virtual time: {json.dumps(report.as_dict())}; {len(gen.schedule)} gangs in "
        f"{report.wall_s:.3f} s of wall time, {wall_rate:.1f} gangs/s")
    if not report.sustained or report.bound_pods != report.submitted_pods:
        raise AssertionError(f"{label}: the open loop did not sustain: {report.as_dict()}")
    check_cfg9_placement(store)
    return {"parity_cycles": len(modes), "parity_micro_cycles": n_micro,
            "parity_binds": binds,
            "parity_p50_ms": {mode: _pct(w, 50) for mode, w in walls.items()},
            "open_loop": dict(report.as_dict(), wall_s=report.wall_s, gangs=len(gen.schedule),
                              wall_gangs_per_s=wall_rate)}


#: config 8 (bench.py config8_open_loop, :870-957): the open-loop SLO
#: harness on _build_open_loop_store's cluster (nodes of 8,000m, 16 GiB and
#: 110 pods, one weight-1 queue); the base rate's runs, the saturation
#: search's start (twice the base) and doublings, its runs' length and the
#: p99 band
CFG8 = dict(nodes=200, node_cpu_milli=8000.0, node_mem=16.0 * (1 << 30), node_pods=110,
            qps=25.0, duration_s=8.0, base_runs=2, band_p99_ms=1000.0, max_doublings=3,
            settle_s=30.0)
#: the unmeasured warm burst before every run (bench.py's ``warm``)
CFG8_WARM = dict(qps=300.0, duration_s=0.15, seed=1, gang_sizes=((1, 5.0), (2, 3.0), (4, 2.0)),
                 cpu_millis=(250, 500), mem_mb=(256, 512), dwell_s=0.05, namespace="warm",
                 prefix="wm")
#: the measured arrivals, at the run's rate and length (bench.py's ``spec``)
CFG8_LOAD = dict(seed=8, gang_sizes=((1, 5.0), (2, 3.0), (4, 2.0)), cpu_millis=(250, 500),
                 mem_mb=(256, 512), dwell_s=6.0, namespace="load")


def build_open_loop_store(n_nodes=CFG8["nodes"]):
    """bench.py _build_open_loop_store with the port's objects: one weight-1
    queue and ``n_nodes`` nodes of 8,000m / 16 GiB / 110 pods."""
    from volcano_tpu_torch.api import Metadata, Node, Queue, Resource
    from volcano_tpu_torch.store import Store

    store = Store()
    store.create("Queue", Queue(meta=Metadata(name="default", namespace=""), weight=1))
    for i in range(n_nodes):
        store.create("Node", Node(meta=Metadata(name=f"n{i:04d}", namespace=""),
                                  allocatable=Resource(CFG8["node_cpu_milli"], CFG8["node_mem"],
                                                       max_task_num=CFG8["node_pods"])))
    return store


def cfg8_specs(qps, duration_s):
    """(the warm burst's LoadSpec, the measured run's) of one config-8 run."""
    from volcano_tpu_torch.loadgen import LoadSpec

    return LoadSpec(**CFG8_WARM), LoadSpec(qps=qps, duration_s=duration_s, **CFG8_LOAD)


def _cfg8_run(label, qps, duration_s, checks):
    """One config-8 run as bench.py's run_at: a fresh store and
    Scheduler(full_conf("cuda"), async apply), a blocking prewarm, the warm
    burst, then the measured open loop.  Launch counts reset just before
    the measured run and read just after; the placement holds (no node over
    its CPU, memory or pod cap, every gang all or nothing).  With
    ``checks``: every arrived pod bound by the end of settle, the run
    sustained, K1 and K2 launched.  Returns (report, launches)."""
    from volcano_tpu_torch.loadgen import run_open_loop
    from volcano_tpu_torch.scheduler.conf import full_conf
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    store = build_open_loop_store()
    sched = Scheduler(store, conf=async_conf(full_conf("cuda")))
    try:
        sched.prewarm(background=False)
        warm, spec = cfg8_specs(qps, duration_s)
        run_open_loop(store, warm, sched.run_once, settle_s=CFG8["settle_s"])
        reset_launches()
        report = run_open_loop(store, spec, sched.run_once, settle_s=CFG8["settle_s"])
        launches = {k: v for k, v in read_launches().items() if v}
        flush_applier(label, sched)
    finally:
        sched.close()
    check_cfg9_placement(store)
    if checks:
        if report.bound_pods != report.submitted_pods or report.unbound_pods:
            raise AssertionError(f"{label}: {report.bound_pods} of {report.submitted_pods} "
                                 f"arrived pods bound by the end of settle")
        if not report.sustained:
            raise AssertionError(f"{label}: the run did not sustain {qps} gangs/s: "
                                 f"{report.as_dict()}")
        for name in ("water_fill", "allocate_solve"):
            if launches.get(name, 0) < 1:
                raise AssertionError(f"{label}: kernel {name} launched "
                                     f"{launches.get(name, 0)} times on the main path")
    log(f"[{label}] {qps:.0f} gangs/s for {duration_s} s: {json.dumps(report.as_dict())} "
        f"launches {launches}")
    return report, launches


def phase_cfg8():
    """Phase 30, config 8 (bench.py config8_open_loop): the open loop at 25
    gangs/s of 1-, 2- and 4-pod gangs for 8 s against the in-process store,
    the best of two runs by p99 (each checked: every pod bound, the rate
    sustained, K1 and K2 launched, the placement), then the saturation
    search from 50 gangs/s, doubling up to 3 times on runs of 4 s, until
    p99 leaves the 1,000 ms band.  Returns the figures."""
    from volcano_tpu_torch.loadgen import saturation_search

    label = "e2e cfg8"
    runs = [_cfg8_run(f"{label} base {i + 1}", CFG8["qps"], CFG8["duration_s"], checks=True)
            for i in range(CFG8["base_runs"])]
    base, launches = min(runs, key=lambda r: r[0].p99_ms)
    sat = saturation_search(
        lambda q: _cfg8_run(f"{label} saturation", q, max(CFG8["duration_s"] / 2.0, 3.0),
                            checks=False)[0],
        base_qps=CFG8["qps"] * 2, band_p99_ms=CFG8["band_p99_ms"],
        max_doublings=CFG8["max_doublings"])
    out = {"qps": CFG8["qps"], "p50_ms": round(base.p50_ms, 2),
           "p99_ms": round(base.p99_ms, 2), "p999_ms": round(base.p999_ms, 2),
           "report": base.as_dict(), "launches": launches, "band_p99_ms": CFG8["band_p99_ms"],
           "saturation": sat.as_dict()}
    log(f"[{label}] first-seen to bind at {CFG8['qps']:.0f} gangs/s (best of "
        f"{CFG8['base_runs']} by p99): p50 {out['p50_ms']} ms, p99 {out['p99_ms']} ms, p999 "
        f"{out['p999_ms']} ms; saturation: sustained {sat.sustained_qps} gangs/s, breach "
        f"{sat.breach_qps}")
    return out


#: config 7 (bench.py config7): config 5 through the port's apiserver in
#: its own process, loaded with RemoteStore.bulk in batches of this many ops
CFG7_BULK_OPS = 4_000
#: the spawned apiserver's deadline to put its URL (a recovery included)
CFG7_BOOT_TIMEOUT_S = 300.0
#: the WAL-on run's save interval: the WAL alone holds every acknowledged
#: write, so its drain measures the fsync on the ACK path (bench.py's choice)
CFG7_WAL_SAVE_INTERVAL_S = 3600.0


def _cfg7_server(ctx, wal_state="", shards=1):
    """Spawn the port's StoreServer in its own process; (process, URL, the
    wall until it put its URL).  ``wal_state``: the state file of a server
    with the WAL armed beside it (saved every CFG7_WAL_SAVE_INTERVAL_S), or
    "" for a server without durability; ``shards``: its decision-bus shard
    count.  A server that cannot start or bind fails the phase: there is no
    fallback to an in-process store."""
    from volcano_tpu_torch.store.server import serve_in_child

    q = ctx.Queue()
    args = ((q, wal_state, True, CFG7_WAL_SAVE_INTERVAL_S, shards) if wal_state
            else (q, "", False, 0.25, shards))
    proc = ctx.Process(target=serve_in_child, args=args, daemon=True)
    t0 = time.perf_counter()
    proc.start()
    try:
        url = q.get(timeout=CFG7_BOOT_TIMEOUT_S)
    except Exception as e:  # noqa: BLE001 — the phase fails with the cause
        proc.kill()
        proc.join(30)
        raise AssertionError(f"cfg7: the apiserver did not come up ({e!r}; exit code "
                             f"{proc.exitcode})")
    return proc, url, time.perf_counter() - t0


def _get_json(url, path):
    import urllib.request

    with urllib.request.urlopen(url + path, timeout=60) as resp:
        return json.loads(resp.read())


#: shared objects whose mapping in a process means it loaded torch (and
#: could have initialized CUDA): torch's own libraries, the CUDA runtime
#: and the driver
TORCH_LIBS = ("libtorch", "libc10", "libcudart", "libcuda.so")


def _torch_libs_mapped(pid):
    """The TORCH_LIBS shared objects mapped into process ``pid``, read from
    its /proc/<pid>/maps: none for an apiserver, whose process never
    imports torch."""
    with open(f"/proc/{pid}/maps") as f:
        paths = {line.split()[-1] for line in f if "/" in line}
    return sorted(p for p in paths if any(lib in os.path.basename(p) for lib in TORCH_LIBS))


def _cfg7_stop(proc, kill=False):
    """Stop a spawned apiserver: SIGTERM (its graceful flush), or SIGKILL
    where the state it would flush is thrown away with its directory."""
    if proc.is_alive() and not kill:
        proc.terminate()
        proc.join(60)
    if proc.is_alive():
        proc.kill()
        proc.join(30)


def _cfg7_load(remote, ops):
    """Create ``ops`` through ``RemoteStore.bulk`` in CFG7_BULK_OPS batches;
    the wall."""
    t0 = time.perf_counter()
    for i in range(0, len(ops), CFG7_BULK_OPS):
        errs = [e for e in remote.bulk(ops[i:i + CFG7_BULK_OPS]) if e]
        if errs:
            raise AssertionError(f"cfg7: the store load failed: {errs[:3]}")
    return time.perf_counter() - t0


def _cfg7_run(label, server, ref_binds, wal_state=""):
    """One config-7 pass (bench.py config7's one_run) against a loaded
    apiserver process, ``server`` = (ctx, process, URL):
    ``Scheduler(RemoteStore(url), full_conf("cuda"))`` under the applier:
    prewarm, cycle 1 and the drain.  Cycle 1's binds must equal
    ``ref_binds`` (phase 3's in-process cfg5-batch run) pod for pod.
    Without ``wal_state`` (the server has no durability): every pod carries
    a node in the store after the drain, then two steady cycles.  With it
    (the state file of a WAL server): the WAL stats, then a SIGKILL after
    the drain's acknowledgements and a boot from that state: every
    acknowledged bind must be there.  The server process must never map
    torch or CUDA (TORCH_LIBS).  Returns the measurements and the live
    process."""
    import torch

    from volcano_tpu_torch.scheduler.conf import full_conf
    from volcano_tpu_torch.scheduler.scheduler import Scheduler
    from volcano_tpu_torch.store.client import RemoteStore

    ctx, proc, url = server
    want_pods = CFG5["jobs"] * CFG5["tasks_per_job"] + CFG5["best_effort"]
    out = {}
    walls = out["walls"] = {}
    last = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        walls[name] = round(now - last[0], 3)
        last[0] = now

    remote = RemoteStore(url, timeout=900)
    sched = Scheduler(remote, conf=async_conf(full_conf("cuda")))
    out["prewarm_s"] = round(sched.prewarm(background=False), 3)
    lap("prewarm")
    reset_launches()
    t0 = time.perf_counter()
    sched.run_once()
    torch.cuda.synchronize()
    publish = time.perf_counter() - t0
    launches = read_launches()
    out["cycle1_s"] = round(publish, 4)
    out["phases"] = {k: round(v, 4) for k, v in sched.fast_cycle.phases.items()}
    out["path"] = sched.last_path
    out["launches"] = {k: v for k, v in launches.items() if v}
    binds = list(sched.cache.bind_log)
    flush_applier(label, sched)
    out["drain_s"] = round(time.perf_counter() - t0 - publish, 4)
    out["drain_stats"] = {k: round(v, 4) for k, v in sched.cache.applier.drain_stats.items()}
    lap("cycle 1 and the drain")
    log(f"[{label}] prewarm {out['prewarm_s']} s; cycle 1 {out['cycle1_s']} s ({out['path']}) "
        f"phases {json.dumps(out['phases'])} launches {out['launches']}; drain "
        f"{out['drain_s']} s {json.dumps(out['drain_stats'])}")
    if sched.cache.err_log:
        raise AssertionError(f"{label}: err_log {sched.cache.err_log[:3]}")
    for name in ("water_fill", "allocate_solve_batch"):
        if launches[name] < 1:
            raise AssertionError(f"{label}: kernel {name} launched {launches[name]} "
                                 f"times on the main path, expected at least 1")
    for name in ("allocate_solve",) + CONTENTION_KERNELS + OBJECT_FORBID:
        if launches[name]:
            raise AssertionError(f"{label}: kernel {name} launched ({launches[name]})")
    if len(binds) != len(ref_binds) or dict(binds) != dict(ref_binds):
        got, want = dict(binds), dict(ref_binds)
        diff = [(k, got.get(k), want.get(k)) for k in sorted(set(got) | set(want))
                if got.get(k) != want.get(k)]
        raise AssertionError(f"{label}: cycle 1 bound {len(binds)} pods, the in-process "
                             f"run {len(ref_binds)}; {len(diff)} differ, e.g. {diff[:5]}")
    out["binds_equal_in_process"] = len(binds)
    out["bind_order_equal"] = binds == list(ref_binds)
    if not wal_state:
        # read off the wire without decoding
        out["bound"] = sum(1 for p in _get_json(url, "/apis/Pod")["items"] if p["node_name"])
        lap("the pods listed")
        if out["bound"] != want_pods:
            raise AssertionError(f"{label}: {out['bound']} of {want_pods} pods carry a node "
                                 f"after the drain")
        sched.run_once()
        flush_applier(label, sched)
        lap("steady cycle 1 (the write-back's watch drain)")
        t1 = time.perf_counter()
        sched.run_once()
        torch.cuda.synchronize()
        out["steady_s"] = round(time.perf_counter() - t1, 4)
        out["steady_phases"] = {k: round(v, 4) for k, v in sched.fast_cycle.phases.items()}
        flush_applier(label, sched)
        lap("steady cycle 2")
    else:
        out["wal"] = _get_json(url, "/healthz")["wal"]
    mapped = _torch_libs_mapped(proc.pid)
    if mapped:
        raise AssertionError(f"{label}: the apiserver process mapped torch or CUDA: {mapped}")
    sched.close()
    lap("close")
    if wal_state:
        proc.kill()
        proc.join(60)
        proc, url, recovery_s = _cfg7_server(ctx, wal_state)
        out["recovery_s"] = round(recovery_s, 3)
        lap("SIGKILL and recovery")
        # the restarted server's pods, read off the wire without decoding,
        # against the binds the drain acknowledged (the applier's err_log is
        # empty): every pod bound, to its node
        after = {f"{p['meta']['namespace']}/{p['meta']['name']}": p["node_name"]
                 for p in _get_json(url, "/apis/Pod")["items"]}
        out["bound_after_restart"] = sum(1 for n in after.values() if n)
        acked = dict(binds)
        if after != acked or len(after) != want_pods:
            diff = [k for k in set(after) | set(acked) if after.get(k) != acked.get(k)]
            raise AssertionError(f"{label}: {len(diff)} pods differ from the acknowledged binds "
                                 f"across the SIGKILL and restart, e.g. {diff[:5]}")
        out["wal_after_restart"] = _get_json(url, "/healthz")["wal"]
        mapped = _torch_libs_mapped(proc.pid)
        if mapped:
            raise AssertionError(f"{label}: the restarted apiserver mapped torch or CUDA: "
                                 f"{mapped}")
        lap("the recovered pods read")
        log(f"[{label}] SIGKILL and restart: recovered in {out['recovery_s']} s, "
            f"{out['bound_after_restart']} pods bound as acknowledged")
    log(f"[{label}] walls, s: {json.dumps(walls)}")
    return out, proc


def phase_cfg7(ref_binds):
    """Phase 29, config 7 (bench.py:681-790): config 5 through the port's
    apiserver in its own OS process (spawned, 127.0.0.1, port 0) and a
    RemoteStore.  Two servers: one without durability (the run with its
    steady cycles) and one with the WAL armed and a state file (killed
    with SIGKILL after the drain and restarted from its directory).  Each
    is loaded with the same config-5 store in turn, the WAL-off one first,
    so that each load's wall is its own (bench.py loads one server a run),
    then the runs go one after the other."""
    import multiprocessing as mp
    import tempfile

    from volcano_tpu_torch.store.client import RemoteStore

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="cfg7-") as d:
        state = os.path.join(d, "state.json")
        procs = {}
        try:
            procs["off"] = _cfg7_server(ctx)
            procs["on"] = _cfg7_server(ctx, state)
            t0 = time.perf_counter()
            local = build_cfg5_store()
            build_s = time.perf_counter() - t0
            ops = [{"op": "create", "kind": kind, "object": obj}
                   for kind in ("Queue", "PriorityClass", "Node", "PodGroup", "Pod")
                   for obj in local.items(kind)]
            loads = {name: _cfg7_load(RemoteStore(procs[name][1], timeout=900), ops)
                     for name in ("off", "on")}
            n_objects = len(ops)
            del local, ops
            gc.collect()
            log(f"[cfg7] config 5 built in {build_s:.3f} s and loaded into each apiserver in "
                f"turn through RemoteStore.bulk: {n_objects} objects, WAL off "
                f"{loads['off']:.3f} s, WAL on {loads['on']:.3f} s (up in {procs['off'][2]:.3f} "
                f"/ {procs['on'][2]:.3f} s)")
            off, proc = _cfg7_run("e2e cfg7", (ctx,) + procs["off"][:2], ref_binds)
            procs["off"] = (proc,)
            off.update(store_load_s=round(loads["off"], 3), objects=n_objects)
            on, proc = _cfg7_run("e2e cfg7-wal", (ctx,) + procs["on"][:2], ref_binds,
                                 wal_state=state)
            procs["on"] = (proc,)
            on.update(store_load_s=round(loads["on"], 3), objects=n_objects)
        finally:
            # the WAL server's state goes with the directory: no final flush
            for name, entry in procs.items():
                _cfg7_stop(entry[0], kill=name == "on")
    out = {"wal_off": off, "wal_on": on,
           "wal_drain_ratio": round(on["drain_s"] / max(off["drain_s"], 1e-9), 3),
           "wal_load_ratio": round(on["store_load_s"] / max(off["store_load_s"], 1e-9), 3)}
    wal = on.get("wal") or {}
    log(f"[cfg7] store_load_s {off['store_load_s']} (WAL on {on['store_load_s']}, ratio "
        f"{out['wal_load_ratio']}); prewarm {off['prewarm_s']} s; cycle 1 {off['cycle1_s']} s; "
        f"drain {off['drain_s']} s; steady {off.get('steady_s')} s; WAL on: drain "
        f"{on['drain_s']} s (ratio {out['wal_drain_ratio']}), fsync_s {wal.get('fsync_s')}, "
        f"fsync_total {wal.get('fsync_total')}, records {wal.get('records')}; recovery "
        f"{on['recovery_s']} s")
    return out


#: cfg9b (bench.py config9_shard's comparison, :1180-1210, _cfg9_run
#: :1034): the cfg9 store at cfg7's scale (bench.py N_NODES, N_TASKS; its
#: VOLCANO_TPU_CFG9B_SCALE 1.0) through a spawned apiserver of this many
#: shards, against one of a single shard
CFG9B = dict(CFG9, nodes=10_000, tasks=100_000, shards=4)


def _cfg9b_run(label, server, want_shards):
    """One cfg9b pass (bench.py _cfg9_run with mesh "off") against a loaded
    apiserver process, ``server`` = (process, URL): Scheduler(RemoteStore(url),
    full_conf("cuda"), async apply, mesh "off"): a blocking prewarm, cycle 1
    with the launch counts reset just before it and read just after, the
    drain until the applier holds nothing, then cycles until every task is
    bound (at most MAX_CYCLES in all).  Checks: K1 and K3 launched and no
    other solve; the server's pods listed equal to the cycles' binds, every
    gang task bound and no node over its caps (check_cfg9_placement); the
    drain's shardNN_s keys exactly ``want_shards`` (the shards the 16
    namespaces hash to; none for one shard); the process maps no torch or
    CUDA.  Returns the measurements and the binds."""
    import torch

    from volcano_tpu_torch.scheduler.conf import full_conf
    from volcano_tpu_torch.scheduler.scheduler import Scheduler
    from volcano_tpu_torch.store.client import RemoteStore

    proc, url = server
    out = {}
    remote = RemoteStore(url, timeout=900)
    conf = async_conf(full_conf("cuda"))
    conf.mesh = "off"
    sched = Scheduler(remote, conf=conf)
    try:
        out["prewarm_s"] = round(sched.prewarm(background=False), 3)
        out["segment_shards"] = remote.segment_shards
        reset_launches()
        t0 = time.perf_counter()
        sched.run_once()
        torch.cuda.synchronize()
        out["cycle1_s"] = round(time.perf_counter() - t0, 4)
        launches = read_launches()
        out["launches"] = {k: v for k, v in launches.items() if v}
        out["phases"] = {k: round(v, 4) for k, v in sched.fast_cycle.phases.items()}
        t1 = time.perf_counter()
        flush_applier(label, sched, CFG9_FLUSH_TIMEOUT_S)
        out["drain_s"] = round(time.perf_counter() - t1, 4)
        out["drain_stats"] = {k: round(v, 4)
                              for k, v in sorted(sched.cache.applier.drain_stats.items())}
        out["cycle1_binds"] = len(sched.cache.bind_log)
        cycles = 1
        while len(sched.cache.bind_log) < CFG9B["tasks"] and cycles < MAX_CYCLES:
            cycles += 1
            sched.run_once()
            flush_applier(label, sched, CFG9_FLUSH_TIMEOUT_S)
        out["cycles"] = cycles
        if sched.cache.err_log:
            raise AssertionError(f"{label}: err_log {sched.cache.err_log[:3]}")
        binds = list(sched.cache.bind_log)
    finally:
        sched.close()
    log(f"[{label}] prewarm {out['prewarm_s']} s; cycle 1 {out['cycle1_s']} s phases "
        f"{json.dumps(out['phases'])} launches {out['launches']}; drain {out['drain_s']} s "
        f"{json.dumps(out['drain_stats'])}; {len(binds)} binds in {cycles} cycle(s)")
    for name in ("water_fill", "allocate_solve_batch"):
        if launches[name] < 1:
            raise AssertionError(f"{label}: kernel {name} launched {launches[name]} times on "
                                 f"the main path, expected at least 1")
    for name in ("allocate_solve", "sharded_cycle") + CONTENTION_KERNELS + OBJECT_FORBID:
        if launches[name]:
            raise AssertionError(f"{label}: kernel {name} launched ({launches[name]})")
    got_shards = {int(k[5:7]) for k in out["drain_stats"] if k.startswith("shard")}
    if got_shards != want_shards:
        raise AssertionError(f"{label}: the drain shipped to shards {sorted(got_shards)}, the "
                             f"namespaces hash to {sorted(want_shards)}")
    # the server's pods and nodes read off the wire without decoding (a pod
    # list moves about 50 MB of JSON)
    from volcano_tpu_torch.api import POD_GROUP_KEY

    t0 = time.perf_counter()
    pods = _get_json(url, "/apis/Pod")["items"]
    listed = {f"{p['meta']['namespace']}/{p['meta']['name']}": p["node_name"] for p in pods}
    nodes = [(n["meta"]["name"], n["allocatable"]["cpu"], n["allocatable"]["mem"],
              n["allocatable"]["max_task_num"]) for n in _get_json(url, "/apis/Node")["items"]]
    bound = check_placement_rows(nodes, [
        (p["meta"]["namespace"], p["meta"]["annotations"].get(POD_GROUP_KEY, ""),
         p["node_name"], p["spec"]["resources"]["cpu"], p["spec"]["resources"]["mem"])
        for p in pods])
    out["list_check_s"] = round(time.perf_counter() - t0, 3)
    if bound != CFG9B["tasks"] or {k: n for k, n in listed.items() if n} != dict(binds):
        raise AssertionError(f"{label}: {bound} of {CFG9B['tasks']} tasks bound on the server; "
                             f"{len(binds)} binds in the cycles")
    mapped = _torch_libs_mapped(proc.pid)
    if mapped:
        raise AssertionError(f"{label}: the apiserver process mapped torch or CUDA: {mapped}")
    return out, binds


def phase_cfg9b():
    """Phase 31, cfg9b (bench.py config9_shard's cfg9b line): the cfg9 store
    at 10,000 nodes and 100,000 tasks (gangs of 20 over 16 namespaces, two
    queues) through a spawned port apiserver of 4 shards and one of 1 (WAL
    off, save interval 0.25 as bench.py's _apiserver_proc), loaded one after
    the other through RemoteStore.bulk in CFG7_BULK_OPS batches, then driven
    one after the other (_cfg9b_run).  Both runs must bind the same pods on
    the same nodes.  The sharded drain over the single one is a reading, not
    a gate (bench.py gates nothing on it).  Returns the figures."""
    import multiprocessing as mp

    from volcano_tpu_torch.store.client import RemoteStore
    from volcano_tpu_torch.store.partition import shard_of

    ctx = mp.get_context("spawn")
    n = CFG9B["shards"]
    want = {shard_of(f"team{i}", n) for i in range(CFG9B["namespaces"])}
    procs = {}
    runs = {}
    try:
        procs["sharded"] = _cfg7_server(ctx, shards=n)
        procs["single"] = _cfg7_server(ctx)
        t0 = time.perf_counter()
        local = build_cfg9_store(CFG9B["nodes"], CFG9B["tasks"])
        build_s = time.perf_counter() - t0
        ops = [{"op": "create", "kind": kind, "object": obj}
               for kind in ("Queue", "Node", "PodGroup", "Pod") for obj in local.items(kind)]
        loads = {name: _cfg7_load(RemoteStore(procs[name][1], timeout=900), ops)
                 for name in ("sharded", "single")}
        n_objects = len(ops)
        del local, ops
        gc.collect()
        log(f"[cfg9b] store built in {build_s:.3f} s ({CFG9B['nodes']} nodes, {CFG9B['tasks']} "
            f"tasks in gangs of {CFG9B['tasks_per_job']} over {CFG9B['namespaces']} "
            f"namespaces) and loaded into each apiserver in turn: {n_objects} objects, "
            f"{n} shards {loads['sharded']:.3f} s, one shard {loads['single']:.3f} s")
        for name, shards in (("sharded", want), ("single", set())):
            out, binds = _cfg9b_run(f"e2e cfg9b {name}", procs[name][:2], shards)
            out["store_load_s"] = round(loads[name], 3)
            runs[name] = (out, binds)
    finally:
        for entry in procs.values():
            _cfg7_stop(entry[0])
    (sh, sh_binds), (one, one_binds) = runs["sharded"], runs["single"]
    if dict(sh_binds) != dict(one_binds) or len(sh_binds) != len(one_binds):
        got, ref = dict(sh_binds), dict(one_binds)
        diff = [k for k in set(got) | set(ref) if got.get(k) != ref.get(k)]
        raise AssertionError(f"cfg9b: the {n}-shard and one-shard runs bind differently: "
                             f"{len(diff)} pods, e.g. {diff[:5]}")
    out = {"shards": n, "objects": n_objects, "sharded": sh, "single": one,
           "ratio": round(sh["drain_s"] / max(one["drain_s"], 1e-9), 3),
           "drain_shards_s": {k: v for k, v in sh["drain_stats"].items()
                              if k.startswith("shard")}}
    log(f"[cfg9b] drain {n} shards {sh['drain_s']} s, one shard {one['drain_s']} s, ratio "
        f"{out['ratio']}; per shard {json.dumps(out['drain_shards_s'])}; split_s "
        f"{sh['drain_stats']['split_s']}, ship_s {sh['drain_stats']['ship_s']}, wire_s "
        f"{sh['drain_stats']['wire_s']} (one shard {one['drain_stats']['wire_s']}); both runs "
        f"bound the same {len(sh_binds)} pods on the same nodes")
    return out


def check_placement_ports(store):
    """No node holds a host port twice."""
    ports = {}
    for p in store.list("Pod"):
        if p.node_name:
            for port in p.spec.host_ports:
                if (p.node_name, port) in ports:
                    raise AssertionError(f"node {p.node_name} holds host port {port} twice: "
                                         f"{ports[(p.node_name, port)]}, {p.meta.key}")
                ports[(p.node_name, port)] = p.meta.key


def _phase_clock():
    """mark(name): log how far into the run ``name`` ended, and its share."""
    t0 = last = time.perf_counter()

    def mark(name):
        nonlocal last
        now = time.perf_counter()
        log(f"[time] {name} done at {now - t0:.1f} s (+{now - last:.1f} s)")
        last = now

    return mark


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    mark = _phase_clock()
    ecc_line("start")
    smi = phase_build()
    try:
        main_run = _run(argv, mark, smi)
    finally:
        ecc_line("end")
    if main_run:
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _run(argv, mark, smi):
    """The mode argv names, after the build; True for the main run, whose
    result line main prints after the last [ecc] line."""
    import torch

    if "--split" in argv:
        log(smi)
        log(json.dumps({"split": phase_split()}))
        return False
    if "--victim-split" in argv:
        log(smi)
        log(json.dumps({"victim_split": phase_victim_split()}))
        return False
    if "--storm-split" in argv:
        log(smi)
        log(json.dumps({"storm_split": phase_storm_split()}))
        return False
    if "--exact-split" in argv:
        log(smi)
        log(json.dumps({"exact_split": phase_exact_split()}))
        return False
    if "--fast-cells" in argv:
        log(smi)
        phase_fast_cells()
        log(smi)
        return False
    if "--publish-split" in argv:
        log(smi)
        log(json.dumps({"publish_split": phase_publish_split()}))
        log(smi)
        return False
    if "--restart-cells" in argv:
        log(smi)
        phase_object_cfg6r_be()
        phase_object_cfg5()
        phase_object_cfg6r_be_mesh()
        from volcano_tpu_torch.scheduler.conf import full_conf

        mesh_conf = full_conf("cuda")
        mesh_conf.solve_mode, mesh_conf.mesh = "batch", "4"
        run_names = ("preempt_rounds_sharded", "preempt_solve_sharded")
        phase_contention("e2e cfg6b-mesh, prewarm check", "cfg6b", {n: 1 for n in run_names},
                         tuple(k for k in CONTENTION_KERNELS + MESH_CONTENTION_KERNELS
                               if k not in run_names), conf=mesh_conf, names=run_names)
        log(json.dumps({"restart": phase_restart_standby()}))
        log(smi)
        return False
    if "--delta-cells" in argv:
        log(smi)
        log(json.dumps({"cfg10": dict(phase_cfg10(), tenth=phase_cfg10_tenth())}))
        mark("phases 27-28")
        log(json.dumps({"cfg8": phase_cfg8()}))
        mark("phase 30")
        log(smi)
        return False
    if "--store-cells" in argv:
        log(smi)
        ref = []
        phase_e2e("e2e batch", CFG5["jobs"], CFG5["best_effort"],
                  want=("water_fill", "allocate_solve_batch"),
                  forbid=("allocate_solve",) + CONTENTION_KERNELS, binds=ref)
        mark("phase 3")
        log(json.dumps({"cfg7": phase_cfg7(ref)}))
        mark("phase 29")
        log(json.dumps({"cfg9b": phase_cfg9b()}))
        mark("phase 31")
        log(smi)
        return False
    if "--residue" in argv:
        log(smi)
        floor_ms, floor_nr_ms, _ = k1_launch_floor(torch.device("cuda"))
        log(f"[kernels] water_fill's launch floor {floor_nr_ms:.4f} ms, with a blocking read "
            f"{floor_ms:.4f} ms")
        phase_cfg5r()
        mark("phase 24")
        phase_cfg6d()
        mark("phase 25")
        log(smi)
        return False
    if "--profile" in argv:
        i = argv.index("--profile") + 1
        phase_profile(argv[i] if i < len(argv) else None)
    kern = phase_kernels()
    phase_kernel_sweep()
    mark("phases 1-2")
    batch_binds = []
    batch = phase_e2e("e2e batch", CFG5["jobs"], CFG5["best_effort"],
                      want=("water_fill", "allocate_solve_batch"), steady=True,
                      forbid=("allocate_solve",) + CONTENTION_KERNELS, binds=batch_binds)
    exact = phase_e2e("e2e exact", 200, 0,
                      want=("water_fill", "allocate_solve"),
                      forbid=("allocate_solve_batch",) + CONTENTION_KERNELS)
    captured = {}
    cap = []
    dyn = phase_e2e("e2e cfg5d", CFG5["jobs"], CFG5["best_effort"],
                    want={"water_fill": 1, "allocate_solve_batch": 2,
                          "allocate_solve_batch_portsel": 1},
                    forbid=("allocate_solve", "allocate_solve_portsel") + CONTENTION_KERNELS,
                    dynamic_frac=0.10, max_cycles=MAX_CYCLES_DYNAMIC, capture=cap)
    captured["cfg5d"] = cap[0]
    cap = []
    dyn_exact = phase_e2e("e2e cfg5d-exact", CFG5["jobs"], CFG5["best_effort"],
                          want={"water_fill": 1, "allocate_solve_batch": 1,
                                "allocate_solve": 1, "allocate_solve_portsel": 1},
                          forbid=("allocate_solve_batch_portsel",) + CONTENTION_KERNELS,
                          dynamic_frac=0.04, max_cycles=MAX_CYCLES_DYNAMIC, capture=cap)
    captured["cfg5d-exact"] = cap[0]
    kern.update(phase_portsel_kernels(captured, {
        "allocate_solve_batch_portsel": dyn["allocate_solve_batch_portsel"],
        "allocate_solve_portsel": dyn_exact["allocate_solve_portsel"]}))
    mark("phases 3-7")
    from volcano_tpu_torch.scheduler.conf import full_conf

    launches, captured = {}, {}
    exact_conf = full_conf("cuda")
    exact_conf.solve_mode = "exact"
    for cell, want, forbid, conf in (
        ("cfg6", {"preempt_rounds": 1, "water_fill": 1}, ("reclaim_solve",), None),
        ("cfg6b", {"preempt_rounds": 1, "preempt_solve": 1}, ("reclaim_solve",), None),
        ("cfg6r", {"reclaim_solve": 1}, ("preempt_solve", "preempt_rounds"), None),
        ("cfg6-exact", {"preempt_solve": 1, "allocate_solve": 1},
         ("reclaim_solve", "preempt_rounds", "allocate_solve_batch"), exact_conf),
    ):
        launches[cell], captured[cell], _ = phase_contention(
            f"e2e {cell}", cell, want, forbid + MESH_CONTENTION_KERNELS, conf=conf,
            cycles=CONTENTION_CUT_CYCLES)
    kern.update(phase_victim_kernels(captured, launches))
    kern["preempt_solve"]["cfg6_exact_launches"] = launches["cfg6-exact"]["preempt_solve"]
    mark("phases 8-9")
    vol_want = {"water_fill": 1, "allocate_solve_batch": 1, "allocate_solve": 1,
                "allocate_solve_portsel": 1, "allocate_solve_volsel": 1}
    vol_forbid = ("allocate_solve_batch_portsel",) + CONTENTION_KERNELS
    phase_e2e("e2e cfg5v-500", CFG5["jobs"], CFG5["best_effort"], want=vol_want,
              forbid=vol_forbid, max_cycles=MAX_CYCLES_DYNAMIC, volume_tasks=500)
    cap = []
    vol = phase_e2e("e2e cfg5v-2000", CFG5["jobs"], CFG5["best_effort"], want=vol_want,
                    forbid=vol_forbid, max_cycles=MAX_CYCLES_DYNAMIC, capture=cap,
                    volume_tasks=2000)
    kern.update(phase_volsel_kernel(cap[0], vol["allocate_solve_volsel"]))
    mark("phases 10-11")
    # the runs without the snapshot cache are --restart-cells' (cut from the
    # main run for its time)
    be_launches, step_in = phase_object_cfg6r_be(no_cache=False)
    kern.update(phase_victim_step_kernel(step_in, be_launches))
    mark("phases 12-13")
    phase_object_cfg5(no_cache=False)
    caps = phase_cap_lifts()
    mark("phases 14-15")
    cfg9_launches, cfg9_captured = phase_cfg9()
    k12a_out, k12a = phase_sharded_kernels(cfg9_captured, cfg9_launches)
    kern.update(k12a)
    mark("phases 16-17")
    # phase 20 runs on phase 16's captured inputs, then the cfg9 objects go
    kern.update(phase_multihost_cfg9(cfg9_captured, k12a_out, k12a["sharded_cycle"]))
    del cfg9_captured, k12a_out
    gc.collect()
    mark("phase 20")
    mesh_launches, sharded_step_in = phase_object_cfg6r_be_mesh(no_cache=False)
    kern.update(phase_victim_sharded_kernel(sharded_step_in,
                                            mesh_launches["victim_step_sharded"]))
    mark("phases 18-19")
    phase_cfg5_two_hosts()
    phase_multihost_cli()
    mark("phase 21")
    k15_launches, k15_in = phase_contention_mesh()
    mark("phase 22")
    kern.update(phase_contention_mesh_kernels(k15_in, k15_launches, captured))
    mark("phase 23")
    del k15_in, captured
    gc.collect()
    phase_cfg5r()
    mark("phase 24")
    phase_cfg6d()
    mark("phase 25")
    phase_restart_standby()
    mark("phase 26")
    cfg10 = phase_cfg10()
    mark("phase 27")
    cfg10["tenth"] = phase_cfg10_tenth()
    mark("phase 28")
    log(json.dumps({"cfg10": cfg10}))
    log(json.dumps({"cfg8": phase_cfg8()}))
    mark("phase 30")
    log(smi)
    log(json.dumps({"cfg7": phase_cfg7(batch_binds)}))
    mark("phase 29")
    log(json.dumps({"cfg9b": phase_cfg9b()}))
    mark("phase 31")
    kern["water_fill"]["cfg10_launches_per_micro_cycle"] = cfg10["k1_per_micro_cycle"]
    kern["allocate_solve"]["cfg10"] = dict(cfg10["k2_at_micro_shape"],
                                           launches_per_micro_cycle=cfg10["k2_per_micro_cycle"],
                                           shape_TNJQC=cfg10["micro_shapes_TNJQC"][0])
    for name, kid in (("allocate_solve_batch", "K3"), ("preempt_rounds", "K10"),
                      ("allocate_solve", "K2"), ("water_fill", "K1")):
        kern[name]["cap_lifts"] = {k: v for k, v in caps.items() if k.split("@")[0] == kid}
    for name, row in kern.items():
        if name in ("water_fill", "allocate_solve_batch"):
            row["launches"] = batch[name]
        elif name == "allocate_solve":
            row["launches"] = exact[name]
        row["check"] = "ok"
    log(smi)
    log(json.dumps({"kernels": list(kern.values())}))
    return True


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
