#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pydcop_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments, on a machine with one
NVIDIA H100 and the CUDA toolkit::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``pydcop_tpu_torch/csrc`` (one
``nvcc`` per source, started together), then drives the port's main
paths on one device: ``solve -a maxsum``, ``solve -a mgm|dsa``,
``solve -a mgm2`` and ``solve -a dpop`` on binary graphs and trees,
``solve -a maxsum|mgm|dsa|mgm2`` on mixed-arity (SECP) graphs,
``solve -a dba|gdba`` (the generic engine, no kernel) on a CSP, the
sharded engines (``solve -d`` with 8 shards on the card, sharded mgm and
dsa) on a colouring and on a SECP, and ``solve -a amaxsum`` with and
without ``-d``.  Each phase
prints one line; any failure exits non-zero before the result lines are
printed.

1. device: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, kernel build time and the ptxas report;
2. kernel_vs_plain: the MaxSum kernel's binary branch (one cooperative
   launch a call, its cycles split by a grid barrier) against its plain
   PyTorch version, both on the card, on the bench's 10k-variable /
   30k-edge 3-colour coloring, a star with one variable of degree 2,500,
   an instance with unequal domain sizes, a hard-cost colouring (10,000
   on equal colours) and the 100k/300k colouring: q, r, beliefs and
   values equal (``torch.equal``) at damping 0.5 and 0, at the wrapper's
   grid and at forced grids of 1 and 3 blocks, after 1, 2, 3 and 20
   cycles in one call and in two consecutive calls;
   ls_kernel_vs_plain: the three local-search kernels (K2 — one launch
   of tiles of (rank, column) units, ``packed_local_tables``, x and the
   tables in variable order — at the wrapper's grid and at forced grids
   of 1 and 3 blocks; the
   MGM kernel — one cooperative launch a call, each cycle's tables and
   arbitration phases split by a grid barrier — and the DSA kernel — one
   cooperative launch a call, its cycles split by a grid barrier)
   against their plain versions on the same three instances and a
   hard-cost colouring (10,000 on equal colours), from one x and one set
   of uniforms: the tables equal (max abs error 0), x
   equal after 20 MGM cycles and after 20 cycles of DSA A/B/C, mixeddsa
   and adsa (each at the wrapper's grid and at forced grids of 1 and 3
   blocks, and after calls of 1, 2 and 3 cycles); on the near-tie MGM
   instances of ``mgm_tie_case`` (binary, mixed and ternary: the
   arbitration walks a column's slots again, a column has no slot), x
   equal to the plain version's and to the exact rule's at those grids;
   and on the DSA instances of ``dsa_nudge_case`` (binary and mixed,
   integer costs: the 1e-6 prefer-change nudge decides best), x equal
   to the plain version's for every DSA rule at those grids and after 1,
   2, 3 and 20 cycles;
   mgm2_kernel_vs_plain: the MGM-2 kernel (one cooperative launch a
   call, the six rounds of each cycle phases split by grid barriers)
   against its plain version on those four instances and the 100k/300k
   colouring, from one x and one set of coins: x equal after 10 cycles
   (MGM2_CHECK_CYCLES) for each favor at threshold 0.5 and for unilateral at thresholds 0
   and 1, at the wrapper's grid and at forced grids of 1 and 3 blocks;
   and on the near-tie instances of ``mgm2_tie_case`` (binary and mixed
   layouts: the response and winner rounds walk a column's slots again,
   a column has no slot): x equal to the plain version's and to the
   exact rule's for each favor at those grids;
   dpop_kernel_vs_plain: the whole-sweep DPOP kernel (one cooperative
   launch a sweep, a grid barrier between levels) against its plain
   version on the JAX bench's 10,000-node random tree (D=10), the same
   generator at 100,000 nodes, and 3,000-node forest, ragged-domain and
   max-mode trees, at the wrapper's grid and at forced grids of 1 and 3
   blocks: assign equal, msg and cs with max abs error 0, and assign
   equal to the level scan's;
   mixed_kernel_vs_plain: the mixed branches of the MaxSum kernel (one
   cooperative launch a cycle, two phases) and of the three local-search
   kernels against their plain versions (the same rules as above; the
   MaxSum kernel's q, r, beliefs and values also equal, ``torch.equal``,
   after one call of 20 cycles and after two consecutive calls of 10) on
   five mixed-arity graphs: the JAX bench's SECP
   (generate_secp(3000 lights, 900 models, 300 rules, seed 1), arity <= 3
   at max_model_size 2 and <= 4 at 3), the latter at 10x (30,000 lights),
   a star whose hub holds 2,500 unary, binary and ternary factors, and a
   6,000-variable graph of arity 1-4 with domains of 4 and 3 values;
   there also the mixed branch of the MGM-2 kernel against its plain
   version, cycle by cycle for 10 cycles from one x and one set of coins,
   for each favor at threshold 0.5, at the wrapper's grid and at forced
   grids of 1 and 3 blocks (x equal after every cycle; offers, accepted
   pairs and pair moves printed; some graph must make pair moves);
   sharded_kernel_vs_plain: K7 (device_fused_ba), K8 (device_mgm_move,
   MGM's whole arbitration) and K9 (device_tables), each one launch a
   cycle over the card's group of shards, against their plain versions
   on the same inputs, launch by launch inside 20-cycle sharded runs on
   the card (maxsum at damping 0.5 and 0, mgm, dsa), exactly (max abs
   error 0): the 10k/30k and 100k/300k colourings at 8 shards, the
   degree-2,500 star and the unequal-domains graph at 4, the hard
   colouring (K8's ties) at 8, and the 10k/30k colouring with its 8
   shards in two groups on the card (the launches write partials, as on
   two cards: K8 in its "max" and "min" modes); there also amaxsum
   (activation 0.7) through K7's activation branch;
   sharded_mixed_kernel_vs_plain: the mixed branches of K7 (with and
   without activation), K8 and K9 against their plain versions, launch
   by launch, exactly, on SECP-3.9k, SECP4-3.9k, the mixed star and the
   ragged mixed graph at 4 and 8 shards, SECP4-3.9k also in two groups
   (K8-mixed in both modes);
   lane_permute_kernel_vs_plain: K3 against its plain version and
   ``torch.index_select`` at [3, 30,000] and [3, 300,000], exactly;
3. cli / cli_local_search / cli_dpop: ``python -m pydcop_tpu_torch
   solve`` in a subprocess on the tutorial instance: maxsum and dpop
   must finish with cost 12, mgm, dsa, mgm2, dba and gdba with the cost
   of the port's own CPU run;
4. main_path: ``solve_result`` on a 10,000-variable / 30,000-constraint
   soft coloring built with the port's DCOP objects, 200 cycles, for
   maxsum, mgm, dsa and mgm2, and on the 10,000-node tree for dpop; every
   launch counter is zeroed just before each solve, and just after it
   the kernels of that path must have launched once a chunk (maxsum,
   mgm, dsa, dsatuto, mixeddsa, adsa and mgm2: 2 for the harness's two
   chunks of 100 cycles, no ls_tables launch, and for all but maxsum the
   cost and values of the CPU run), or for dpop once a sweep (1 launch,
   engine "wholesweep", cost equal to the CPU run's); then each path piece by
   piece (graph, compile, pack, cycles or sweep, coin draw and copy,
   scoring);
   main_path_mixed: the same on the 3,900-variable SECP for maxsum, mgm,
   dsa, dsatuto, mixeddsa, adsa and mgm2 through the mixed kernels (200
   launches of the mixed MaxSum kernel; 2 of the mixed MGM kernel; 2 of
   the mixed DSA kernel for each of the four DSA rules; 2 of the mixed
   MGM-2 kernel), the cost equal to the CPU run of the same engine
   (``use_packed=True``);
   main_path_breakout: dba and gdba (A/NZ/E), 200 cycles on a
   10,000-variable / 30,000-constraint 3-colouring posed as a CSP (cost 1
   on equal colours), on the generic engine: no kernel launched, cost,
   assignment and stop cycle equal to the CPU run, and the breakdown;
   main_path_sharded: ``solve_result`` with a placement of 8 agents
   (blocks of variables) over the 10k/30k colouring, ``n_shards=8``, 200
   cycles on the card: 200 K7 launches (one a cycle over the 8 shards,
   the shard-order combine inside), assignment, cost and cycle
   equal to the same call on the CPU, and the number of values that
   differ from single-device maxsum (printed, not gated);
   main_path_sharded_local_search: sharded mgm (200 K9 + 200 K8)
   and dsa (200 K9), 200 cycles at 8 shards, values equal to the CPU
   run with the same start and coins;
   main_path_sharded_mixed: ``solve -d`` on SECP-3.9k with 8 agents, 8
   shards, 200 cycles: one K7-mixed launch a cycle and no other
   kernel's, assignment, cost and cycle equal to the
   CPU run; sharded mgm (200 K9-mixed + 200 K8-mixed), dsa and adsa
   (K9-mixed) on it, values equal to the CPU run;
   main_path_amaxsum: ``solve -a amaxsum`` on the 10k/30k colouring, one
   device, the generic engine (no kernel), equal to the CPU run;
   main_path_sharded_amaxsum: ``solve -d -a amaxsum`` on the 10k/30k
   colouring (200 K7-activation launches) and on SECP-3.9k (200 of the
   mixed kernel's activation branch), each equal to the CPU run;
   instances: every test instance solved on the card and on the CPU by
   every algorithm of the port (all 14): assignment, cost and stop cycle
   must be equal (a mixed-arity instance, except by dpop, dba, gdba,
   syncbb and ncbb: against the CPU run with ``use_packed=True``, the
   card's engine; the CPU default, the generic engine, is printed beside
   it);
   search_host: syncbb's and ncbb's host loops for ``device="cuda"``
   against ``device="cpu"`` on the six test instances and the seeded
   integer chain/hub/dense instances, min and max: cost and assignment
   equal;
   search_frontier: the frontier engine (``pydcop_tpu_torch/search``,
   PyTorch tensor code on the card, no kernel of its own) on the JAX
   bench's two anytime-search instances (k10x4: a 10-clique at D=4,
   i_bound 0; k11x3_ib2: two 11-cliques at D=3, i_bound 2), width 256, 8
   steps a chunk: optimal, cost equal to the port's NCBB, per-chunk
   history equal to the CPU frontier's over its first 60 chunks
   (cost, assignment and chunks too where it proves within them), the
   bound sandwich and a monotone incumbent; its first chunks run with
   ``torch.cuda.set_sync_debug_mode("error")`` around the chunk call
   (one host read a chunk, after it); nodes/s, chunks and time to the
   proof beside the CPU run's;
   search_dpop_frontier: ``solve -a dpop -p engine:frontier`` and
   ``solve --anytime-exact`` through the CLI on k10x4: cost equal to the
   sweep's;
   maxsum_dynamic: 100 cycles, 100 seeded factor swaps, 100 cycles on
   the 10k/30k colouring (swapped in place: 2 K1 launches, the layout's
   ``cost_rows`` equal to a fresh pack, K1 on it ``torch.equal`` to its
   plain version) and on SECP-3.9k (re-packed: 200 K1-mixed launches);
   values and cost equal to the CPU run of the same sequence, the swap's
   host ms beside the re-pack's;
   harness: mgm and dsa, 200 cycles with ``collect_cycles`` at chunk 8
   on the 10k/30k colouring and SECP-3.9k: K2 (``packed_local_tables``,
   binary or mixed) launched once a cycle inside the chunk's CUDA graph and no
   other kernel, cost, values and every history cost equal to this
   machine's CPU run, K2 equal to its plain version on the runs' first
   and last assignments, the run without ``collect`` (K4/K5) at the
   same assignment, rates with and without ``collect`` and K2's device
   µs inside the graph, and the K2 step of a collect cycle captured
   alone in a CUDA graph (one kernel node, ``ls_tables_kernel``: no
   gather into column order, no gather or transpose back); mgm at the
   default collect chunk (7: 203 K2 launches, 3 of them in the masked
   tail); dba and gdba on the 10k/30k
   colouring CSP and amaxsum on the 10k/30k colouring, 200 cycles
   through the captured chunk with every replay under
   ``torch.cuda.set_sync_debug_mode("error")``: no kernel of the port,
   equal to the CPU runs of main_path_breakout and main_path_amaxsum,
   one capture (``trace_count``), the replay and eager cycles/s; the
   generic maxsum open-ended on the 10k/30k colouring and SECP-3.9k with
   ``pipeline=True``: the same assignment as without it, at most one
   chunk later (``overshoot_cycles``);
   batch: the batched engine (``pydcop_tpu_torch.batch.BatchEngine``) on
   the JAX bench leg's 500-variable / 1,500-edge 3-colour soft
   colourings: a bucket of 16 for each of maxsum, mgm, dsa, adsa and
   gdba, 50 cycles and to convergence (at most 300), every lane equal to
   its sequential solve on the card (maxsum's generic engine) and no
   kernel of the port launched; then mgm at B = 1, 8, 32 and 1,000 (40
   problems at 25 seeds), three solves of one sweep a size (eager, then
   captured and replayed): wall and chunk-loop seconds, instances/s by
   each, the runner calls and the counters;
   dpop_batched: ``make_batched_sweep_fn`` at B = 100 on the 10k and 100k
   bench trees (each instance the plan's tables plus its own offset): one
   K10 launch for the 100 instances, the batched K10 ``torch.equal`` to
   its plain version at the wrapper's grid and at 1 and 3 blocks, the
   first and last instances equal to their single sweeps, events and
   device µs of the batched call beside one single sweep's, tables/s of
   each;
5. times: each kernel's ms per cycle or sweep (CUDA events around a run
   of launches, after warm-up; MGM-2, MGM and DSA: 200 cycles of one
   call, device time a launch's over its cycles, the grid) at 10k/30k
   and 100k/300k (DPOP: the 10k and 100k trees, 200 back-to-back
   sweeps; the mixed branches, MGM-2's included: the 3.9k SECPs of
   arity <= 3 and <= 4 and the 39k SECP; K7, K8 and K9: ms per cycle (one
   launch; K8 also MGM's whole arbitration through the engine) at 8
   shards of the 10k/30k and 100k/300k colourings, and the sharded
   maxsum/mgm/dsa cycles/s; their mixed branches at SECP-3.9k and
   SECP-39k; K7's activation branch at 10k/30k, 100k/300k and SECP-3.9k
   with the sharded amaxsum cycles/s; single-device amaxsum cycles/s; K3
   at [3, 30,000] and [3, 300,000] beside ``torch.index_select``) beside
   its bytes bound, its plain version's time, and its device time per
   launch from a torch.profiler trace.

6. warm: warm repair (``ops/headroom.py``, ``algorithms/warm.py``,
   ``runtime/repair.py``; the generic engines, no kernel launched) at
   the JAX churn leg's size: maxsum on the 100,000-variable ring lattice
   (200,000 binary factors, D = 4, tables uniform [0, 5) from
   ``default_rng(77)``, headroom 0.1, chunk 10, damping 0.7) through
   a ``WarmRepairController`` and ``solver.run``: 60 base chunks, then
   15 seeded table edits (``edit_factor``, writes in place) each
   followed by a 3-chunk ``run(resume=True)`` window — captures
   unchanged, ms a write and a window, the first chunk and the first
   three windows equal to a CPU controller's (values equal, messages
   within TOL); five factors on one variable run it past its plan
   depth — exactly one repack at this size, one more capture; mgm through ``build_warm_solver`` + ``change_factor_function``
   + ``run(resume=True)`` at 2,000 variables, 15 edits — captures
   unchanged, every window's assignment and cost equal to the CPU run;
   a controller with one free variable slot given two variables —
   exactly one repack and one more capture, equal to the CPU run;
   memo: the solution cache through ``SolveService(memo=True)`` on the
   card: the JAX memo leg's trace (800-variable soft 3-colourings with
   1,598 edges, mgm, seed 1, a cold budget of 2,000 cycles; 4 novel, 4
   duplicates, 4 one-edit variants, 4 duplicates) one request at a
   time — exact hits equal to their cached results with no runner call,
   every served variant no worse than its seed, each variant beside its
   cold ``solve_result`` on the card (costs, times, the speedup of the
   variant hits); a
   ``corrupt_cache_entry`` fault skipped and counted, never served; then
   the serve phase's at-size Poisson stream (512 mgm jobs, 64 problems,
   64 lanes, 25 jobs/s) with the cache, job i at seed i mod 64 — every
   exact hit equal to its first copy, hits by kind, jobs/s, p50/p99;
   fleet: the thread-hosted ``SolveFleet`` (one CUDA context): the JAX
   bench's fleet leg (the serve leg's 24 dsa jobs, Poisson 20 jobs/s)
   at 1, 2 and 4 replicas, every job equal to its standalone solve on
   the card, then a tick-driven ``kill_replica`` of replica-0 of 2 —
   every job equal, the orphans re-seated, the RTO; the 512-job mgm
   burst at 64 lanes at 1 and 2 replicas (a sample of 32 checked); two
   replicas' prewarms at once (captures on two scheduler threads, then
   replays, every job equal); an mgm2 and a dpop job through a
   replica's fallback (K6, K10 counted, equal to the CPU solve);
   procfleet: the ``ProcessFleet`` (children ``serve-replica --device
   cuda``, each its own CUDA context; the kernels built before any
   child starts): the fleet leg at 1, 2 and 4 of four children, an
   mgm2 job in each of two children at once (K6 in two contexts, equal
   to the CPU solve), kill -9 of a child holding jobs (every job
   equal, re-seats, RTO, the relaunch), a ``corrupt_artifact`` fault
   rejected and counted by the relaunched child; then a 256-job burst
   of the at-size jobs (on 8 of the family's problems, whose files every
   child loads first) at 1, 2 and 4 children of a fleet grown by cold
   joins from the artifact store (misses 0, no ``nvcc`` run), with the
   card's free memory and each child's reserve at each size.

Then, last, the phase ``resilience``: on the 10k/30k colouring a
200-cycle maxsum, dsa and mgm ``solve_result`` with a snapshot every 50
cycles (K1, K5, K4: one launch a run between snapshots), a fresh solver
restored from the cycle-100 snapshot and run to 200 (``torch.equal`` to
the straight run: the state, maxsum's beliefs of one more cycle, dsa's
coin generator; the snapshot also restored on the CPU), the ms of a
``save_checkpoint`` and a ``load_checkpoint`` and the snapshot's bytes;
a ``corrupt_checkpoint`` and a ``truncate_checkpoint`` fault on the
newest snapshot (the manager skips it; the resume comes from the one
before and ends at the straight run); ``VirtualOrchestrator`` runs of
maxsum and mgm with 200 agents (adhoc, capacity 5× the even share),
k = 3 replicas and a scenario removing ``a000``, 20 cycles a phase, ==
a CPU twin on copies of the placement and the replicas (the ms of
``start_replication``, of the repair's build and solve, its size,
largest arity and engine — K4's mixed branch or the generic engine —
and of each phase); and an mgm run whose 0.3 s delays convert to cycles
at the card's measured rate, with a ``UiServer`` whose cycle events a
stdlib ws client in this script receives, and ``/state``.

Then the phase ``sharded_compact``: the packed sharded engines at 8
shards in every overlap mode (``off``, ``exact``, ``stale``, and
``exact`` with ``exchange=True`` on a pairwise cut), every shard in one
group and split into two (``split_groups``: the launches write
partials and only the boundary columns cross), on the 10k/30k
colouring and SECP4-3.9k (maxsum, amaxsum, mgm, dsa, adsa) and a
10k-variable ring lattice (maxsum, mgm; pairwise): K7, K8 and K9
launch by launch against their plain versions in each compact mode,
each 200-cycle run's launches (one K7 or K9 a group a cycle; K8 once,
or four times across two groups), exact and the exchange
``torch.equal`` to off (values and the owner-reconciled beliefs),
stale ``torch.equal`` to its CPU run; the cut fraction, the boundary
columns, the plan's bytes a cycle dense and compact, cycles/s, and on
the colouring the device µs a cycle of maxsum and mgm; the generic
sharded engine (maxsum on a D = 10 colouring, mgm, dba and gdba on the
10k/30k CSP with ``use_packed=False``: equal to the CPU run, no kernel
launched, cycles/s beside the packed engine's); and ``solve -d
placement.yaml --shard-overlap exact`` and ``stale`` through the CLI
(its ``metrics()["shard"]`` equal to the library's).  Each phase's
seconds are printed as a ``phase_seconds`` line after it.

``python3 chip_smoke.py --phases fleet,procfleet,resilience,sharded_compact``
runs those phases alone (no kernel check, no result lines).

``python3 chip_smoke.py --ab PARENT_TREE
[k1,k1_mixed,mgm2,mgm,dsa,k2,dpop,sharded,harness]`` runs no phase above: it
times dba, gdba and amaxsum 200-cycle solves (the second solve of a
solver, and the eager ``run_cycles`` rate; section ``harness``),
K1's binary branch on 10k/30k, 100k/300k and the degree-2,500 star
(events and device µs a cycle, blocks, equality with the plain version,
also at 1 and 3 blocks, the maxsum cycles-only rate of a 200-cycle
solve, and in this tree a sweep of its launch shape), K1's mixed branch
on the three SECPs
(events and device µs a cycle, blocks, equality with the plain version,
SECP maxsum cycles/s), K6 on 10k/30k, 100k/300k, SECP-3.9k and SECP-39k
(events and device µs a cycle, blocks, equality with the plain version
after 20 cycles, also at 1 and 3 blocks, the cycles-only rate of a
200-cycle mgm2 solve, its coins' draw and copy a chunk and its rate
with them), K4 on those sizes and SECP4-3.9k (events and device µs a
cycle, blocks, equality with the plain version after 20 cycles, the
cycles-only rate of a 200-cycle mgm solve; K2 and K5 beside it), K5
on those five sizes (events and device µs a cycle, blocks, equality
with the plain version after 20 cycles, the cycles-only and with-coins
rates of a 200-cycle dsa solve), K2 on 10k/30k, 100k/300k, SECP-3.9k,
SECP-39k, the star and the 5k/15k unequal-domain graph (events a
call, the kernels of a call and their device µs, device µs a K2
launch, the parent's column-order launch alone too, equality with the
plain versions, in this tree also at 1 and 3 blocks, the card's wave
and a sweep of tile width × threads a block) with
mgm's K2 step of a collect cycle and its captured collect cycle on
10k/30k and SECP-3.9k (section ``k2``), K10 on the 10k and 100k bench trees
and the deep max and ragged 3k trees (events and device µs a sweep, L,
blocks, equality, tables/s, and in this tree a sweep of its grid cap)
and the sharded kernels with the sharded rates, in turns of the tree at
PARENT_TREE and this one (parent, change, change, parent), into
``ab_sharded.jsonl`` in the output directory.

The last three lines are the card (``nvidia-smi`` name and power limit),
``{"kernels": [...]}`` (one entry per kernel: launches on its main path,
max error against the plain version, times and bound) and
``{"ok": true, "device": {...}}``.
"""
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
#: published H100 SXM peaks (NVIDIA data sheet) used for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TOL = 1e-4
#: SECP-39k is the JAX bench's SECP4 at this many times its size (10: 30k
#: lights; cut to 5 if the run nears its time limit)
SECP_BIG_SCALE = 10


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields,
                      "t": round(time.perf_counter() - SCRIPT_T0, 1)}),
          flush=True)


_PHASE_MARKS = []


def phase_seconds(name):
    """Print the seconds since the previous mark (the script's start for
    the first): the length of the phase ``name`` that just ended."""
    now = time.perf_counter()
    last = _PHASE_MARKS[-1] if _PHASE_MARKS else SCRIPT_T0
    _PHASE_MARKS.append(now)
    say("phase_seconds", name=name, s=round(now - last, 1))


def fail(phase, msg):
    print(json.dumps({"phase": phase, "error": msg}), flush=True)
    sys.exit(1)


def run_all(cmds, timeout):
    """Run the commands (argv lists, from the repository's root) all at
    once; returns ``(returncode, stdout, stderr)`` in their order."""
    procs = [subprocess.Popen(argv, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=ROOT)
             for argv in cmds]
    out = []
    for proc in procs:
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        out.append((proc.returncode, stdout, stderr))
    return out


def coloring_arrays(V, E, C=3, seed=1):
    """The bench's coloring instance (bench.py build_stretch_tensors):
    numpy default_rng(seed), uniform [0, 1) tables plus 10 on the
    diagonal, unary noise in [0, 0.01)."""
    rng = np.random.default_rng(seed)
    edge_i = rng.integers(0, V, E)
    edge_j = (edge_i + 1 + rng.integers(0, V - 1, E)) % V
    mats = rng.uniform(0, 1, (E, C, C)).astype(np.float32)
    mats += np.eye(C, dtype=np.float32) * 10
    unary = rng.uniform(0, 0.01, (V, C)).astype(np.float32)
    return edge_i, edge_j, mats, unary


def star_tensors(leaves, device, seed=7):
    from pydcop_tpu_torch.ops.compile import compile_binary_from_arrays

    rng = np.random.default_rng(seed)
    return compile_binary_from_arrays(
        np.zeros(leaves, dtype=np.int64), np.arange(1, leaves + 1),
        rng.uniform(0, 1, (leaves, 3, 3)).astype(np.float32), leaves + 1,
        unary=rng.uniform(0, 1, (leaves + 1, 3)).astype(np.float32),
        device=device)


def unequal_domains_tensors(V, F, D, device, seed=5):
    """Odd variables take 2 of the D values: padded values carry
    PAD_COST in the tables and the unary costs, as compile does."""
    from pydcop_tpu_torch.ops.compile import PAD_COST, numpy_fields, \
        compile_binary_from_arrays, tensors_from_numpy

    rng = np.random.default_rng(seed)
    ei = rng.integers(0, V, F)
    ej = (ei + 1 + rng.integers(0, V - 1, F)) % V
    mats = rng.uniform(0, 5, (F, D, D)).astype(np.float32)
    sizes = np.where(np.arange(V) % 2 == 1, 2, D)
    valid = np.arange(D)[None, :] < sizes[:, None]  # [V, D]
    ok = valid[ei][:, :, None] & valid[ej][:, None, :]
    mats = np.where(ok, mats, PAD_COST).astype(np.float32)
    unary = np.where(valid, rng.uniform(0, 1, (V, D)), PAD_COST)
    f = numpy_fields(compile_binary_from_arrays(
        ei, ej, mats, V, unary=unary.astype(np.float32), device="cpu"))
    f["domain_mask"] = valid.astype(np.float32)
    f["domain_sizes"] = sizes.astype(np.int32)
    f["domain_values"] = [tuple(range(s)) for s in sizes]
    return tensors_from_numpy(f, device=device)


def kernel_vs_plain(pg, damping, cycles=20, exact=False, blocks=None):
    """Run the kernel and the plain version from the same state; return
    (max abs error, near-tie value mismatches).  Raises on a mismatch.
    ``exact``: q, r and beliefs must also be equal (``torch.equal``), in
    one call of ``cycles`` cycles and, from 2 cycles, in two consecutive
    calls of half as many each.  ``blocks`` forces the binary kernel's
    grid."""
    import torch

    from pydcop_tpu_torch.ops.packed_maxsum import (
        packed_cycles,
        packed_cycles_plain,
        packed_init_state,
    )

    grid = {} if blocks is None else {"blocks": blocks}
    q, r = packed_init_state(pg)
    kq, kr, kb, kv = packed_cycles(pg, q, r, cycles, damping=damping,
                                   **grid)
    pq, pr, pb, pv = packed_cycles_plain(pg, q, r, cycles, damping=damping)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in (("q", kq, pq), ("r", kr, pr), ("beliefs", kb, pb)):
        if not torch.isfinite(a).all():
            raise AssertionError(f"kernel {name} has non-finite values")
        d = (a - b).abs()
        bad = d > TOL * (1 + b.abs())
        if bad.any():
            raise AssertionError(
                f"kernel {name} differs from plain: {int(bad.sum())} "
                f"entries beyond atol {TOL}*(1+|x|), max {float(d.max())}")
        err = max(err, float(d.max()))
    if exact:
        runs = [("one call", (kq, kr, kb, kv))]
        if cycles >= 2:
            hq, hr, _, _ = packed_cycles(pg, q, r, cycles // 2,
                                         damping=damping, **grid)
            runs.append(("two calls", packed_cycles(
                pg, hq, hr, cycles - cycles // 2, damping=damping, **grid)))
        torch.cuda.synchronize()
        for how, out in runs:
            for name, a, b in zip(("q", "r", "beliefs", "values"), out,
                                  (pq, pr, pb, pv)):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"kernel {name} ({how}) is not equal to plain: "
                        f"{int((a != b).sum())} entries differ")
    differ = kv != pv
    ties = 0
    if differ.any():
        big = torch.where(pg.mask_p > 0, pb, float("inf"))
        two = torch.topk(big, 2, dim=0, largest=False).values
        gap = (two[1] - two[0])[pg.var_order]
        if (differ & (gap >= TOL)).any():
            raise AssertionError(
                f"{int((differ & (gap >= TOL)).sum())} values differ "
                f"outside near-ties")
        ties = int(differ.sum())
    return err, ties


#: the cycle counts of the binary MaxSum kernel's exact checks
K1_CHECK_CYCLES = (1, 2, 3, 20)


def k1_binary_vs_plain(pg):
    """The binary MaxSum kernel against its plain version, ``torch.equal``
    on q, r, beliefs and values (:func:`kernel_vs_plain` with ``exact``)
    at damping 0.5 and 0, at the wrapper's grid and at forced grids of 1
    and 3 blocks, after 1, 2, 3 and 20 cycles in one call and, from 2
    cycles, in two.  Raises on any difference; returns the runs
    checked."""
    runs = 0
    for damping in (0.5, 0.0):
        for blocks in (None, 1, 3):
            for cycles in K1_CHECK_CYCLES:
                kernel_vs_plain(pg, damping, cycles, exact=True,
                                blocks=blocks)
                runs += 1
    return runs


def cuda_ms(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_us(run, names, tries=3):
    """Device time per launch of each kernel whose name contains one of
    ``names``, from torch.profiler's CUDA trace of ``run()`` (None for a
    kernel the trace holds no device time for).  A trace that misses a
    kernel is taken again, up to ``tries`` traces in all (the chip
    machine's traces have dropped a kernel's records now and then)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()  # warm-up
    torch.cuda.synchronize()
    out = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = prof.key_averages()
        for name in names:
            total_us, n = 0.0, 0
            for e in events:
                if name in e.key:
                    total_us += getattr(e, "device_time_total",
                                        getattr(e, "cuda_time_total", 0.0))
                    n += e.count
            if out.get(name) is None:
                out[name] = total_us / n if n and total_us else None
        if all(v is not None for v in out.values()):
            break
    return out


def bound_of(nbytes, nops):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations over the FP32 rate."""
    tb, to = nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def packed_bytes(pg):
    """Bytes one cycle must move: every input read once (q, r, each
    factor's cost table once — an arity-a factor's D^a entries give all a
    of its outgoing messages, though the layout stores a rotated copy per
    slot —, vmask, unary, inv_dcount, the slot index arrays — binary:
    mate; mixed: arity, cost_idx, mate, mate2, mate3 —, the three column
    arrays), every output written once (q', r', beliefs)."""
    D, N, Vp = pg.D, pg.N, pg.Vp
    if pg.mixed is None:
        cost, slot_ints = D * D * N // 2, N
    else:
        cost = sum(c.numel() // a for a, c in enumerate(pg.mixed.costs, 1))
        slot_ints = 5 * N
    floats = (D * N * 2 + cost + D * N + D * Vp + N  # inputs
              + D * N * 2 + D * Vp)                  # outputs
    return 4 * (floats + slot_ints + 3 * Vp)


def packed_ops(pg):
    """Float operations of one cycle: per slot and value, the factor side
    (binary: D adds and D-1 mins; a mixed arity-a slot: about 3 D^(a-1) —
    two adds and a min a candidate), the mask, damping (3) and the belief
    add; per slot, the q side (D subtractions, D multiply-adds for the
    mean, 2D to centre)."""
    D, N = pg.D, pg.N
    rest = N * D * (1 + 3 + 1) + N * (D + 2 * D + 1 + 2 * D)
    if pg.mixed is None:
        return N * D * (2 * D - 1) + rest
    return sum(sl.numel() * 3 * D ** a
               for a, sl in enumerate(pg.mixed.slots, 1)) + rest


def time_kernel(pg, reps=200):
    from pydcop_tpu_torch.ops.packed_maxsum import (
        packed_cycles,
        packed_cycles_plain,
        packed_init_state,
    )

    q, r = packed_init_state(pg)
    packed_cycles(pg, q, r, 20, damping=0.5)  # warm-up
    ms = cuda_ms(lambda: packed_cycles(pg, q, r, reps, damping=0.5), 1) / reps
    packed_cycles_plain(pg, q, r, 5, damping=0.5)
    plain = cuda_ms(
        lambda: packed_cycles_plain(pg, q, r, 20, damping=0.5), 1) / 20
    nbytes = packed_bytes(pg)
    bound, by = bound_of(nbytes, packed_ops(pg))
    # "packed_maxsum_mixed" is a part of the mixed kernel's name in this
    # tree and in its parents (the A/B times both); the binary kernel runs
    # a call's 50 cycles in one launch, the mixed one a launch a cycle
    name, per_launch = (("packed_maxsum_coop_kernel", 50) if pg.mixed is None
                        else ("packed_maxsum_mixed", 1))
    us = profile_us(
        lambda: packed_cycles(pg, q, r, 50, damping=0.5), [name])[name]
    device_us = None if us is None else us / per_launch
    return ms, plain, bound, by, nbytes, device_us


#: the design of K1's binary branch (the ``design`` key of its row in the
#: kernels line)
K1_DESIGN = ("one cooperative launch a call: each degree class cut into "
             "tiles of neighbouring columns, blocks take tiles "
             "grid-stride; a tile's r' one thread a (rank, column), a "
             "block barrier, the beliefs one thread a column in rank "
             "order, a block barrier, q' one thread a (rank, column); a "
             "grid barrier between cycles (n - 1 a call)")


def k1_grid(pg):
    """Blocks of one binary MaxSum launch on this card, as the wrapper
    sizes its grid."""
    from pydcop_tpu_torch.ops import packed_maxsum as PM

    return PM.binary_blocks(
        PM._tiles(pg, PM.TILE_COLS).shape[0],
        PM._binary_capacity(pg.D, PM.BINARY_THREADS, PM.TILE_COLS))


def mixed_launch_blocks(pg):
    """Blocks of one launch of the mixed MaxSum kernel on this card, as
    the wrapper sizes its grid."""
    from pydcop_tpu_torch.ops import packed_maxsum as PM

    return PM.mixed_blocks(pg, *PM._capacity(pg.D))


def hard_coloring_tensors(V, E, device, seed=3):
    """An integer-cost 3-colouring with 10,000 on equal colours and costs
    0 or 1 elsewhere: ties are common, so conflicts and DSA-B's lateral
    moves fire."""
    from pydcop_tpu_torch.ops.compile import compile_binary_from_arrays

    rng = np.random.default_rng(seed)
    ei = rng.integers(0, V, E)
    ej = (ei + 1 + rng.integers(0, V - 1, E)) % V
    mats = (rng.integers(0, 2, (E, 3, 3))
            + 10000 * np.eye(3)).astype(np.float32)
    return compile_binary_from_arrays(ei, ej, mats, V, device=device)


def random_x_col(pls, seed):
    """A random valid assignment, int32 in column order (a column's valid
    values are a prefix of the D values)."""
    import torch

    rng = np.random.default_rng(seed)
    sizes = pls.pg.mask_p.sum(0).cpu().numpy()
    x = (rng.uniform(0, 1, pls.Vp) * sizes).astype(np.int32)
    return torch.as_tensor(x, device=pls.device)


#: the DSA family's algorithms, each driven on the main paths
DSA_ALGOS = ("dsa", "dsatuto", "mixeddsa", "adsa")
#: the DSA-family rules held against their plain versions on the card
DSA_RULES = {
    "dsa_A": dict(variant="A", probability=0.7),
    "dsa_B": dict(variant="B", probability=0.7),
    "dsa_C": dict(variant="C", probability=0.7),
    "mixeddsa_B": dict(variant="B", probability=0.5, probability_hard=0.7),
    "adsa_B": dict(variant="B", probability=0.7, activation=0.5),
}


def ls_kernel_vs_plain(pls, cycles=20, seed=0):
    """The three local-search kernels against their plain versions on the
    card, from one x and one set of uniforms: K2 at the wrapper's grid
    and the forced ones (:func:`k2_on`); the MGM kernel,
    and the DSA kernel for every rule of DSA_RULES, after ``cycles``
    cycles at the wrapper's grid and at the forced ones (COOP_GRIDS), and
    after calls of 1, 2 and 3 cycles (the result in either buffer).
    Returns (max abs error over the tables and every x, stats); raises on
    any difference."""
    import torch

    from pydcop_tpu_torch.ops import packed_local_search as P

    x = random_x_col(pls, seed)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    u = torch.rand((cycles, pls.Vp), generator=gen).to(pls.device)
    w = torch.rand((cycles, pls.Vp), generator=gen).to(pls.device)
    err = 0.0

    def same(what, a, b):
        nonlocal err
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"{what}: kernel differs from plain in "
                                 f"{bad} entries")
        err = max(err, float((a.double() - b.double()).abs().max()))

    err = max(err, k2_on(pls, [P.unpack_x(pls, x)]))
    pm = P.packed_mgm_cycles_plain(pls, x, cycles)
    for grid in COOP_GRIDS:
        km = P.packed_mgm_cycles(pls, x, cycles,
                                 blocks=None if grid == "wrapper" else grid)
        same(f"mgm x after {cycles} cycles, grid={grid}", km, pm)
    for n in (1, 2, 3):
        same(f"mgm x after {n} cycles", P.packed_mgm_cycles(pls, x, n),
             P.packed_mgm_cycles_plain(pls, x, n))
    stats = {"mgm_moved": int((pm != x).sum()), "mgm_blocks": mgm_grid(pls),
             "dsa_blocks": dsa_grid(pls)}
    for rule in DSA_RULES:
        p = dsa_vs_plain(pls, x, u, w, rule, same)
        stats[f"{rule}_moved"] = int((p != x).sum())
    _, cur, best, gain = P.ls_tables_plain(pls, x, prefer_change=True)
    stats["conflicted"] = int((cur >= 10000.0).sum())
    stats["lateral"] = int(((gain <= 1e-9) & (best != x)
                            & (cur >= 10000.0)).sum())
    return err, stats


def dsa_vs_plain(pls, x, u, w, rule, same):
    """The DSA kernel against its plain version for ``rule`` of DSA_RULES
    from ``x`` on the coins ``u`` (and the wake coins ``w`` for adsa),
    [n, Vp] each: after n cycles at each grid of COOP_GRIDS, and after 1,
    2 and 3 cycles; ``same(what, kernel, plain)`` checks.  Returns the
    plain version's x after n cycles."""
    from pydcop_tpu_torch.ops import packed_local_search as P

    kw = dict(DSA_RULES[rule])
    act = kw.pop("activation", None)

    def coins(n):
        return dict(uniforms=u[:n], activation=act,
                    awake_uniforms=None if act is None else w[:n], **kw)

    n = u.shape[0]
    p = P.packed_dsa_cycles_plain(pls, x, **coins(n))
    for grid in COOP_GRIDS:
        k = P.packed_dsa_cycles(pls, x, **coins(n),
                                blocks=None if grid == "wrapper" else grid)
        same(f"{rule} x after {n} cycles, grid={grid}", k, p)
    for m in (1, 2, 3):
        same(f"{rule} x after {m} cycles", P.packed_dsa_cycles(
            pls, x, **coins(m)), P.packed_dsa_cycles_plain(pls, x,
                                                           **coins(m)))
    return p


def ls_bytes_ops(pls):
    """Bytes and float operations one call must move and do, per kernel
    entry point, each input read once and each output written once:

    * packed_local_tables (K2): x [V], the D selected cost floats and
      mate_idx of each slot, the unary and mask columns and col_var; out
      the tables [V, D]; the slot sums, the unary add and the mask;
    * packed_mgm_cycles, per cycle: x, the cost floats and mate_col of
      each slot, unary and mask, the three column arrays, plus mate_idx
      and col_var; out x';
    * packed_dsa_cycles, per cycle: the same inputs as MGM's but the
      move coins for mate_idx and col_var; out x'.

    On the mixed layout a slot also reads its arity and cost_idx and up
    to three siblings (columns or variables; MGM also three sibling
    indices)."""
    D, N, Vp = pls.D, pls.N, pls.Vp
    sibs = 1 if pls.pg.mixed is None else 3
    slot_ints = N if pls.pg.mixed is None else 5 * N
    walk = D * N + 2 * D * Vp + Vp + slot_ints
    common = walk + 3 * Vp
    ops = N * D + Vp * 4 * D
    return {
        "packed_local_tables": (4 * (walk + Vp + D * Vp),
                                N * D + Vp * 2 * D),
        "packed_mgm_cycles": (4 * (common + sibs * N + Vp + Vp),
                              ops + 2 * sibs * N + 6 * Vp),
        "packed_dsa_cycles": (4 * (common + Vp + Vp), ops + 8 * Vp),
    }


def time_ls(pls, reps=200):
    """{kernel: (ms per call/cycle, plain ms, bound ms, bound_by, bytes,
    device us per cycle)} for the local-search entry points: K2
    (``packed_local_tables``, x in variable order), events over ``reps``
    calls; MGM and
    DSA, events over one call of ``reps`` cycles, the device time of a
    launch of 50 cycles over its 50 cycles."""
    import torch

    from pydcop_tpu_torch.ops import packed_local_search as P

    x = random_x_col(pls, 1)
    x_var = P.unpack_x(pls, x)
    u = torch.rand((reps, pls.Vp), device=pls.device)
    # (events, plain, profiled run, kernel names, cycles a launch)
    runs = {
        "packed_local_tables": (
            lambda: cuda_ms(lambda: P.packed_local_tables(pls, x_var), reps),
            lambda: cuda_ms(lambda: P.packed_local_tables_plain(pls, x_var),
                            20),
            lambda: [P.packed_local_tables(pls, x_var) for _ in range(20)],
            ["ls_tables_kernel"], 1),
        # four calls of 50 cycles a trace: a trace that drops one
        # launch's record still times the others
        "packed_mgm_cycles": (
            lambda: cuda_ms(lambda: P.packed_mgm_cycles(pls, x, reps),
                            1) / reps,
            lambda: cuda_ms(lambda: P.packed_mgm_cycles_plain(pls, x, 5),
                            1) / 5,
            lambda: [P.packed_mgm_cycles(pls, x, 50) for _ in range(4)],
            [MGM_KERNEL], 50),
        "packed_dsa_cycles": (
            lambda: cuda_ms(lambda: P.packed_dsa_cycles(pls, x, u, 0.7),
                            1) / reps,
            lambda: cuda_ms(lambda: P.packed_dsa_cycles_plain(
                pls, x, u[:5], 0.7), 1) / 5,
            lambda: [P.packed_dsa_cycles(pls, x, u[:50], 0.7)
                     for _ in range(4)],
            [DSA_KERNEL], 50),
    }
    out = {}
    for name, (timed, plain, prof, names, per_launch) in runs.items():
        prof()  # warm-up
        ms, plain_ms = timed(), plain()
        us = profile_us(prof, names)
        device_us = (None if None in us.values()
                     else sum(us.values()) / per_launch)
        nbytes, nops = ls_bytes_ops(pls)[name]
        bound, by = bound_of(nbytes, nops)
        out[name] = (ms, plain_ms, bound, by, nbytes, device_us)
    return out


#: the design of K2 (the ``design`` key of its rows in the kernels line)
K2_DESIGN = ("one launch a call, not cooperative: each degree class cut "
             "into tiles of neighbouring columns, blocks take tiles "
             "grid-stride; a tile's (rank, column) units one thread each "
             "(the slot's siblings' values and D cost floats into shared "
             "memory, 4 units' loads in flight a thread), a block "
             "barrier, one thread a column adds its ranks in order (a "
             "hub's in slabs of 1024 units); x read and the tables [V, D] "
             "written in variable order; the tile width the narrowest of "
             "32/64/128 whose tiles fit one wave of the kernel's resident "
             "blocks")
#: the MGM kernel's name in a profiler trace
MGM_KERNEL = "mgm_coop_kernel"
#: the design of K4 (the ``design`` key of its rows in the kernels line)
MGM_DESIGN = ("one cooperative launch a call: each cycle's tables (best "
              "and gain of every column) and MGM's arbitration two phases "
              "of the grid, one thread a column in grid-stride loops, "
              "split by grid barriers (2n - 1 a call); slot walks 4 "
              "slots' loads at a time, the next 4 slots' layout entries "
              "loaded ahead, the neighbourhood max and tie-break in one "
              "walk")


def mgm_grid(pls):
    """Blocks of one MGM launch on this card, as the wrapper sizes its
    grid."""
    from pydcop_tpu_torch.ops import packed_local_search as P

    return P.grid_blocks(pls.Vp, *P._capacity(pls.D,
                                              pls.pg.mixed is not None))


def k2_grid(pls):
    """Blocks of one K2 launch on this card, as the wrapper sizes its
    grid: one a tile of its tile table."""
    from pydcop_tpu_torch.ops import packed_local_search as P

    return P.tables_shape(pls, pls.device)[2].shape[0]


def coop_grids(pls):
    """Blocks of one launch of each local-search kernel on this card, by
    its entry point."""
    return {"packed_local_tables": k2_grid(pls),
            "packed_mgm_cycles": mgm_grid(pls),
            "packed_dsa_cycles": dsa_grid(pls)}


#: the DSA kernel's name in a profiler trace
DSA_KERNEL = "dsa_coop_kernel"
#: the design of K5 (the ``design`` key of its rows in the kernels line)
DSA_DESIGN = ("one cooperative launch a call: each cycle one phase of "
              "the grid (the column's tables at the previous cycle's x, "
              "its pick with the nudge for variants B and C, the DSA rule "
              "on row i of the coins), one thread a column in grid-stride "
              "loops, grid barriers between cycles (n - 1 a call); the "
              "slot walk of K4, 4 slots' loads at a time, the next 4 "
              "slots' layout entries loaded ahead")


def dsa_grid(pls):
    """Blocks of one DSA launch on this card, as the wrapper sizes its
    grid."""
    from pydcop_tpu_torch.ops import packed_local_search as P

    return P.grid_blocks(pls.Vp, *P._dsa_capacity(
        pls.D, pls.pg.mixed is not None))


#: the instances of :func:`dsa_nudge_case`
DSA_NUDGE_KINDS = ("binary", "mixed")


def dsa_nudge_case(kind, device):
    """A DSA instance with integer costs 0-2, so ties are common and the
    tables stay below 32, where the 1e-6 prefer-change nudge of variants B
    and C survives the add and decides best: binary, a 3-colouring of 400
    variables and 800 edges (columns without slots among them); mixed,
    arity 1-4 on 300 variables at D = 3, every second variable on 2
    values.  Returns (layout, a random x [Vp], the columns whose best the
    nudge changes)."""
    from pydcop_tpu_torch.ops import packed_local_search as P
    from pydcop_tpu_torch.ops.compile import compile_binary_from_arrays, \
        compile_constraint_graph

    rng = np.random.default_rng(4)
    if kind == "binary":
        V, E = 400, 800
        ei = rng.integers(0, V, E)
        ej = (ei + 1 + rng.integers(0, V - 1, E)) % V
        t = compile_binary_from_arrays(
            ei, ej, rng.integers(0, 3, (E, 3, 3)).astype(np.float32), V,
            device=device)
    else:
        t = compile_constraint_graph(mixed_dcop(
            300, 3, {1: 60, 2: 300, 3: 60, 4: 10}, seed=4, ragged=True,
            integer=True), device=device)
    pls = P.pack_local_search(t)
    x = random_x_col(pls, 4)
    plain = P.ls_tables_plain(pls, x)[2]
    nudged = P.ls_tables_plain(pls, x, prefer_change=True)[2]
    return pls, x, (plain != nudged).nonzero().flatten()


def dsa_nudge_vs_plain():
    """The DSA kernel on the instances of :func:`dsa_nudge_case`, for
    every rule of DSA_RULES (:func:`dsa_vs_plain`: 20 cycles at each
    grid, and 1, 2 and 3 cycles).  Raises on any difference or when the
    nudge decides no column's best; returns the runs checked."""
    import torch

    def same(what, a, b):
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: kernel differs from plain in "
                                 f"{int((a != b).sum())} entries")

    checked = 0
    for kind in DSA_NUDGE_KINDS:
        pls, x, nudged = dsa_nudge_case(kind, "cuda")
        if nudged.numel() == 0:
            raise AssertionError(f"{kind}: the nudge decides no best")
        gen = torch.Generator(device="cpu").manual_seed(5)
        u, w = (torch.rand((20, pls.Vp), generator=gen).cuda()
                for _ in range(2))
        for rule in DSA_RULES:
            dsa_vs_plain(pls, x, u, w, rule, lambda *a: same(
                f"{kind} {a[0]}", *a[1:]))
            checked += len(COOP_GRIDS) + 3
    return checked


#: the MGM-2 rules held against the plain version on the card: every
#: favor at threshold 0.5, and thresholds 0 (no offerer) and 1 (every
#: offer meets an offerer) once
MGM2_RULES = [("unilateral", 0.5), ("no", 0.5), ("coordinated", 0.5),
              ("unilateral", 0.0), ("unilateral", 1.0)]
#: the MGM-2 kernel's name in a profiler trace
MGM2_KERNEL = "mgm2_coop_kernel"
#: the grids of every MGM and MGM-2 check: the wrapper's, and 1 and 3
#: blocks forced (the grid-stride loops)
COOP_GRIDS = ("wrapper", 1, 3)
#: the design of K6 (the ``design`` key of its rows in the kernels line)
MGM2_DESIGN = ("one cooperative launch a call: each cycle's six rounds "
               "(tables, offer, response, commit, winner, go) phases of "
               "the grid, one thread a column in grid-stride loops, split "
               "by grid barriers (6n - 1 a call); slot walks 4 slots' "
               "loads at a time, the next 4 slots' layout entries loaded "
               "ahead, response and winner in one walk")


def mgm2_coins(pls, n, seed):
    """(u_off, u_pick, u_fav) [n, Vp] on the card, drawn on the CPU."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.rand((n, pls.Vp), generator=gen).to(pls.device)
            for _ in range(3)]


def mgm2_offers(pm, u_off, u_pick, threshold):
    """Offered slots per cycle of these coins (an offerer's picked slot
    whose mate is no offerer), averaged over the rows."""
    import torch

    pls = pm.pls
    sc = pls.pg.slot_col
    offerer = u_off < threshold
    pick = (u_pick * pm.deg_col.float().clamp_min(1.0)).floor().int()
    mc = pls.mate_col.long()
    mate_offers = torch.where(mc >= 0, offerer[:, mc.clamp_min(0)], True)
    offered = (offerer[:, sc] & (pm.pick_rank == pick[:, sc])
               & ~mate_offers)
    return float(offered.sum()) / u_off.shape[0]


def mgm2_grid(pm):
    """(blocks, threads a block) of one MGM-2 launch on this card, as the
    wrapper sizes its grid."""
    from pydcop_tpu_torch.ops import packed_mgm2 as M

    capacity, threads = M._capacity(pm.pls.D, pm.pls.pg.mixed is not None)
    return M.mgm2_blocks(pm.pls.Vp, capacity, threads), threads


def mgm2_run(pm, x, u, threshold, favor, grid):
    """x after the cycles of coins ``u`` from the kernel, at the wrapper's
    grid (``grid="wrapper"``) or at ``grid`` blocks."""
    from pydcop_tpu_torch.ops import packed_mgm2 as M

    if grid == "wrapper":
        return M.packed_mgm2_cycles(pm, x, *u, threshold, favor)
    return M._launch_cycles(pm, x, *u, threshold, favor, grid)


#: cycles each K6 check (binary and mixed) holds the kernel to its plain
#: version: the plain MGM-2 at the degree-2,500 stars is the script's
#: slowest check (20 before the fleets' phases were added)
MGM2_CHECK_CYCLES = 10


def mgm2_kernel_vs_plain(pm, cycles=MGM2_CHECK_CYCLES, seed=0):
    """The MGM-2 kernel against its plain version on the card, from one
    x and one set of coins, for each rule of MGM2_RULES, at the wrapper's
    grid and at the forced ones.  Returns (max abs error over every x,
    stats); raises on any difference."""
    import torch

    from pydcop_tpu_torch.ops.packed_mgm2 import packed_mgm2_cycles_plain

    x = random_x_col(pm.pls, seed)
    u = mgm2_coins(pm.pls, cycles, seed)
    err, stats = 0.0, {}
    for favor, threshold in MGM2_RULES:
        runs = {grid: mgm2_run(pm, x, u, threshold, favor, grid)
                for grid in COOP_GRIDS}
        p = packed_mgm2_cycles_plain(pm, x, *u, threshold, favor)
        torch.cuda.synchronize()
        for grid, k in runs.items():
            if not torch.equal(k, p):
                raise AssertionError(
                    f"favor={favor} threshold={threshold} grid={grid}: x "
                    f"after {cycles} cycles differs from plain in "
                    f"{int((k != p).sum())} columns")
            err = max(err, float((k.double() - p.double()).abs().max()))
        moved = int((runs["wrapper"] != x).sum())
        stats[f"{favor}_{threshold}_moved"] = moved
    stats["offers_per_cycle_0.5"] = mgm2_offers(pm, u[0], u[1], 0.5)
    stats["blocks"], stats["threads"] = mgm2_grid(pm)
    stats["grids"] = list(COOP_GRIDS)
    return err, stats


def mgm2_mixed_vs_plain(pm, cycles=MGM2_CHECK_CYCLES, seed=0):
    """The mixed branch of the MGM-2 kernel against its plain version on
    the card, cycle by cycle from one x and one set of coins, for each
    favor at threshold 0.5, at the wrapper's grid and at the forced ones
    (each run from its own x): x equal after every cycle.  Returns (max
    abs error, stats with the offers, accepted pairs and pair moves of
    each run, counted by the plain version); raises on any difference."""
    import torch

    from pydcop_tpu_torch.ops.packed_mgm2 import mgm2_cycle_plain

    x0 = random_x_col(pm.pls, seed)
    u = mgm2_coins(pm.pls, cycles, seed)
    err, stats = 0.0, {}
    for favor in ("unilateral", "no", "coordinated"):
        xp = x0
        xk = dict.fromkeys(COOP_GRIDS, x0)
        counts = {}
        for c in range(cycles):
            row = [a[c: c + 1] for a in u]
            xk = {grid: mgm2_run(pm, xg, row, 0.5, favor, grid)
                  for grid, xg in xk.items()}
            xp = mgm2_cycle_plain(pm, xp, *(a[c] for a in u), 0.5, favor,
                                  stats=counts)
            torch.cuda.synchronize()
            for grid, xg in xk.items():
                if not torch.equal(xg, xp):
                    raise AssertionError(
                        f"favor={favor} grid={grid}: x after cycle {c} "
                        f"differs from plain in {int((xg != xp).sum())} "
                        f"columns")
                err = max(err,
                          float((xg.double() - xp.double()).abs().max()))
        stats[favor] = dict(counts, moved=int((xk["wrapper"] != x0).sum()))
    stats["blocks"], stats["threads"] = mgm2_grid(pm)
    stats["grids"] = list(COOP_GRIDS)
    return err, stats


#: the near-tie MGM-2 instances of :func:`mgm2_tie_case`
MGM2_TIE_KINDS = ("response", "winner")


def mgm2_tie_case(kind, mixed, device):
    """A five-variable MGM-2 instance (six on the mixed layout), D = 2,
    x all 0, one cycle, whose gains lie 6e-10 apart: under the 1e-9 tie
    margin, so the kernel's one-walk response round (``kind`` "response")
    or winner round ("winner") meets at column c a new maximum within
    1e-9 of the old one and walks c's slots again.  c's slots run to n1,
    n2, n3 in that order (edge ids 0, 1, 2).

    * response: n1, n2, n3 offer c joint gains 3e-8 + (0, 6e-10, 1.2e-9)
      (each edge costs 1e-8 at (0, 0), n_i's unary cost on value 0 is
      0, 6e-10, 1.2e-9); only n2's and n3's lie within 1e-9 of the best,
      so c accepts n2's offer (the lower edge id), and c and n2 move to 1
      (a rule that kept n1's candidate would pair c with n1);
    * winner: no offer (threshold 0); the gains are n1 1e-8, c 1.12e-8,
      n2 1.06e-8, n3 1.12e-8 (unary costs on value 0, edges cost 0),
      the tie-break ids the variable indices n1 0, c 1, n2 2, n3 3; only
      n2 and n3 lie within 1e-9 of c's neighbourhood max, so c wins and
      moves to 1 (a rule that kept n1's id 0 would stop it).

    Variable 4 has no factor: its column has no slot.  On the binary
    layout its unary cost is 1e-8 on value 0 and it moves to 1; on the
    mixed layout the unary costs are unary factors, variable 4 has none
    and stays, and variable 5 has only one (1e-8 on value 0) and moves
    to 1.  Returns (statics, x [Vp], the three coins [1, Vp], threshold,
    the x the exact rule gives in variable order)."""
    import torch

    from pydcop_tpu_torch.ops import packed_local_search as P
    from pydcop_tpu_torch.ops.compile import compile_binary_from_arrays, \
        compile_factor_graph
    from pydcop_tpu_torch.ops.packed_maxsum import pack_for_gpu
    from pydcop_tpu_torch.ops.packed_mgm2 import pack_mgm2_from_pls

    g, e = 1e-8, 6e-10
    if kind == "response":  # c = 0; n1, n2, n3 = 1, 2, 3
        c, ns, edge_cost = 0, (1, 2, 3), g
        h = {0: 0.0, 1: 0.0, 2: e, 3: 2 * e}
        threshold, want, offerers = 0.5, [1, 0, 1, 0, 0], (1, 2, 3)
    else:  # c = 1; n1, n2, n3 = 0, 2, 3
        c, ns, edge_cost = 1, (0, 2, 3), 0.0
        h = {0: g, 1: g + 2 * e, 2: g + e, 3: g + 2 * e}
        threshold, want, offerers = 0.0, [0, 1, 0, 0, 0], ()
    mat = np.array([[edge_cost, 0.0], [0.0, 0.0]], np.float32)
    V = 6 if mixed else 5
    if mixed:
        from pydcop_tpu_torch.dcop import DCOP, Domain, NAryMatrixRelation, \
            Variable

        dom = Domain("d", "d", [0, 1])
        vs = [Variable(f"v{i}", dom) for i in range(V)]
        dcop = DCOP(f"mgm2_tie_{kind}")
        for v in vs:
            dcop.add_variable(v)
        for k, n in enumerate(ns):
            dcop.add_constraint(NAryMatrixRelation([vs[c], vs[n]], mat,
                                                   name=f"b{k}"))
        for v, cost in sorted({**h, 5: g}.items()):
            dcop.add_constraint(NAryMatrixRelation(
                [vs[v]], np.array([cost, 0.0], np.float32), name=f"u{v}"))
        pg = pack_for_gpu(compile_factor_graph(dcop, device=device))
        want = want + [1]
    else:
        unary = np.zeros((V, 2), np.float32)
        for v, cost in {**h, 4: g}.items():
            unary[v, 0] = cost
        pg = pack_for_gpu(compile_binary_from_arrays(
            np.full(3, c), np.array(ns), np.stack([mat] * 3), V,
            unary=unary, device=device))
        want[4] = 1
    if (pg.mixed is not None) != mixed:
        raise AssertionError(f"{kind}: the {'mixed' if mixed else 'binary'} "
                             f"layout was not taken")
    pm = pack_mgm2_from_pls(P.pack_from_pg(pg))
    u_off = np.full((1, V), 0.9, np.float32)
    u_off[0, list(offerers)] = 0.1
    u = [P.pack_uniforms(pm.pls, a) for a in
         (u_off, np.full((1, V), 0.5), np.full((1, V), 0.9))]
    x = torch.zeros(pm.pls.Vp, dtype=torch.int32, device=device)
    return pm, x, u, threshold, want


def mgm2_tie_vs_plain(mixed):
    """The MGM-2 kernel on the near-tie instances (:func:`mgm2_tie_case`)
    for each favor, at the wrapper's grid and the forced ones: x must
    equal the plain version's and the exact rule's.  Raises on any
    difference; returns the cases checked."""
    import torch

    from pydcop_tpu_torch.ops.packed_local_search import unpack_x
    from pydcop_tpu_torch.ops.packed_mgm2 import packed_mgm2_cycles_plain

    checked = 0
    for kind in MGM2_TIE_KINDS:
        pm, x, u, threshold, want = mgm2_tie_case(kind, mixed, "cuda")
        for favor in ("unilateral", "no", "coordinated"):
            p = packed_mgm2_cycles_plain(pm, x, *u, threshold, favor)
            got = unpack_x(pm.pls, p).tolist()
            if got != want:
                raise AssertionError(f"{kind} favor={favor}: the plain "
                                     f"version gives {got}, not {want}")
            for grid in COOP_GRIDS:
                k = mgm2_run(pm, x, u, threshold, favor, grid)
                torch.cuda.synchronize()
                if not torch.equal(k, p):
                    raise AssertionError(
                        f"{kind} favor={favor} grid={grid}: x "
                        f"{unpack_x(pm.pls, k).tolist()}, the plain "
                        f"version's {got}")
                checked += 1
    return checked


#: the near-tie MGM instances of :func:`mgm_tie_case`
MGM_TIE_KINDS = ("binary", "mixed", "ternary")


def mgm_tie_case(kind, device):
    """A near-tie MGM instance, D = 2, x all 0, one cycle: at column c
    (variable 1) the kernel's one-walk arbitration meets a new maximum
    within 1e-9 of the old one and walks c's slots again.

    * binary, mixed: :func:`mgm2_tie_case`'s "winner" instance (MGM-2
      without an offer is MGM) on either layout: c's neighbours n1, n2,
      n3 (variables 0, 2, 3) in slot order, gains n1 1e-8, c 1.12e-8, n2
      1.06e-8, n3 1.12e-8; only n2 and n3 lie within 1e-9 of the
      neighbourhood max, so the tie-break index is 2 and c moves to 1 (a
      rule that kept n1's 0 would stop it);
    * ternary: the same gains on the mixed layout with c's slots a
      binary factor with n1 and a ternary one with n2 and n3, so the new
      maxima land among one slot's siblings.

    Every factor costs 0; the gains are unary factors' costs on value 0.
    A column has no slot (variable 4; on the mixed layouts variable 5
    has only a unary factor of 1e-8 and moves to 1).  Returns (layout, x
    [Vp], the x the exact rule gives in variable order)."""
    import torch

    from pydcop_tpu_torch.dcop import DCOP, Domain, NAryMatrixRelation, \
        Variable
    from pydcop_tpu_torch.ops import packed_local_search as P
    from pydcop_tpu_torch.ops.compile import compile_factor_graph
    from pydcop_tpu_torch.ops.packed_maxsum import pack_for_gpu

    if kind != "ternary":
        pm, x, _, _, want = mgm2_tie_case("winner", kind == "mixed", device)
        return pm.pls, x, want
    g, e = 1e-8, 6e-10
    dom = Domain("d", "d", [0, 1])
    vs = [Variable(f"v{i}", dom) for i in range(6)]
    dcop = DCOP("mgm_tie_ternary")
    for v in vs:
        dcop.add_variable(v)
    dcop.add_constraint(NAryMatrixRelation(
        [vs[1], vs[0]], np.zeros((2, 2), np.float32), name="b0"))
    dcop.add_constraint(NAryMatrixRelation(
        [vs[1], vs[2], vs[3]], np.zeros((2, 2, 2), np.float32), name="t0"))
    for v, cost in ((0, g), (1, g + 2 * e), (2, g + e), (3, g + 2 * e),
                    (5, g)):
        dcop.add_constraint(NAryMatrixRelation(
            [vs[v]], np.array([cost, 0.0], np.float32), name=f"u{v}"))
    pls = P.pack_from_pg(pack_for_gpu(compile_factor_graph(dcop,
                                                           device=device)))
    if pls.pg.mixed is None:
        raise AssertionError("ternary: the mixed layout was not taken")
    x = torch.zeros(pls.Vp, dtype=torch.int32, device=device)
    return pls, x, [0, 1, 0, 0, 0, 1]


def mgm_tie_vs_plain():
    """The MGM kernel on the near-tie instances (:func:`mgm_tie_case`),
    one cycle at the wrapper's grid and the forced ones: x must equal the
    plain version's and the exact rule's.  Raises on any difference;
    returns the runs checked."""
    import torch

    from pydcop_tpu_torch.ops import packed_local_search as P

    checked = 0
    for kind in MGM_TIE_KINDS:
        pls, x, want = mgm_tie_case(kind, "cuda")
        p = P.packed_mgm_cycles_plain(pls, x, 1)
        got = P.unpack_x(pls, p).tolist()
        if got != want:
            raise AssertionError(f"{kind}: the plain version gives {got}, "
                                 f"not {want}")
        for grid in COOP_GRIDS:
            k = P.packed_mgm_cycles(pls, x, 1,
                                    blocks=None if grid == "wrapper"
                                    else grid)
            torch.cuda.synchronize()
            if not torch.equal(k, p):
                raise AssertionError(
                    f"{kind} grid={grid}: x {P.unpack_x(pls, k).tolist()}, "
                    f"the plain version's {got}")
            checked += 1
    return checked


def mgm2_bytes_ops(pm, offers):
    """Bytes and float operations of one MGM-2 cycle, each input read
    once and each output written once: x and the three coins, the unary
    and mask columns, the four column arrays (col_var, col_deg,
    col_slot0, col_stride), the five slot arrays (mate, mate_col,
    mate_idx, pick_rank, edge_id), the D cost floats a slot the tables
    select and the D*D cost floats of each offered slot (``offers`` a
    cycle, counted from this run's coins); out x'.  Operations: the
    tables' D adds a slot, per column the table, argmin and gain (4D),
    per offered slot the joint table (3 D*D) and argmins (2D), per slot
    the response, commit and winner compares (about 8).  On the mixed
    layout the tables read as K2-mixed's (D floats of each slot's arity
    array, the slot's arity and cost_idx, up to three sibling columns),
    and the pairing adds the pair degree of each column."""
    D, N, Vp = pm.pls.D, pm.pls.N, pm.pls.Vp
    floats = 3 * Vp + 2 * D * Vp + D * N + D * D * offers
    ints = 2 * Vp + 4 * Vp + 5 * N
    if pm.pls.pg.mixed is not None:
        ints += 4 * N + Vp  # arity, cost_idx, mate2/3_col; pair degree
    nops = N * D + Vp * 4 * D + offers * (3 * D * D + 2 * D) + 8 * N
    return 4 * (floats + ints), nops


def time_mgm2(pm, reps=200, threshold=0.5, favor="unilateral"):
    """(ms per cycle by CUDA events over ``reps`` cycles of one call,
    plain ms per cycle, bound ms, bound_by, bytes, device us per cycle
    from the profiler (a launch of a 50-cycle call over its 50 cycles),
    the kernel's us per launch by name, offers per cycle)."""
    from pydcop_tpu_torch.ops.packed_mgm2 import (
        packed_mgm2_cycles,
        packed_mgm2_cycles_plain,
    )

    x = random_x_col(pm.pls, 1)
    u = mgm2_coins(pm.pls, reps, 1)
    few = [a[:5] for a in u]
    packed_mgm2_cycles(pm, x, *(a[:20] for a in u), threshold, favor)
    ms = cuda_ms(lambda: packed_mgm2_cycles(pm, x, *u, threshold, favor),
                 1) / reps
    packed_mgm2_cycles_plain(pm, x, *few, threshold, favor)
    plain = cuda_ms(lambda: packed_mgm2_cycles_plain(
        pm, x, *few, threshold, favor), 1) / 5
    offers = mgm2_offers(pm, u[0], u[1], threshold)
    nbytes, nops = mgm2_bytes_ops(pm, offers)
    bound, by = bound_of(nbytes, nops)
    # four calls of 50 cycles a trace: a trace that drops one launch's
    # record still times the others
    us = profile_us(lambda: [packed_mgm2_cycles(
        pm, x, *(a[:50] for a in u), threshold, favor) for _ in range(4)],
        [MGM2_KERNEL])
    device_us = None if us[MGM2_KERNEL] is None else us[MGM2_KERNEL] / 50
    return ms, plain, bound, by, nbytes, device_us, us, offers


def coloring_dcop(V, E, seed=1):
    """A soft 3-colouring built with the port's own DCOP objects."""
    from pydcop_tpu_torch.dcop import (
        DCOP,
        Domain,
        NAryMatrixRelation,
        Variable,
    )

    edge_i, edge_j, mats, _ = coloring_arrays(V, E, seed=seed)
    d = Domain("colors", "color", [0, 1, 2])
    vs = [Variable(f"v{i:06d}", d) for i in range(V)]
    dcop = DCOP("coloring")
    for v in vs:
        dcop.add_variable(v)
    for k in range(E):
        dcop.add_constraint(NAryMatrixRelation(
            [vs[edge_i[k]], vs[edge_j[k]]], mats[k], name=f"c{k:06d}"))
    return dcop


def coloring_csp_dcop(V, E, seed=1):
    """A 3-colouring posed as a CSP, built with the port's own DCOP
    objects: the edges of :func:`coloring_dcop`, cost 1 on equal colours
    and 0 otherwise (the shape of the reference's DBA test problems)."""
    from pydcop_tpu_torch.dcop import (
        DCOP,
        Domain,
        NAryMatrixRelation,
        Variable,
    )

    edge_i, edge_j, _, _ = coloring_arrays(V, E, seed=seed)
    d = Domain("colors", "color", [0, 1, 2])
    vs = [Variable(f"v{i:06d}", d) for i in range(V)]
    dcop = DCOP("coloring_csp")
    for v in vs:
        dcop.add_variable(v)
    eq = np.eye(3, dtype=np.float32)
    for k in range(E):
        dcop.add_constraint(NAryMatrixRelation(
            [vs[edge_i[k]], vs[edge_j[k]]], eq, name=f"c{k:06d}"))
    return dcop


def bench_tree_dcop(N, D=10, seed=2):
    """The JAX bench's DPOP instance (bench.py bench_dpop), built with the
    port's DCOP objects: numpy default_rng(seed), each node's parent
    uniform among all earlier nodes, uniform [0, 10) tables."""
    from pydcop_tpu_torch.dcop import (
        DCOP,
        AgentDef,
        Domain,
        NAryMatrixRelation,
        Variable,
    )

    rng = np.random.default_rng(seed)
    dcop = DCOP("dpop_bench", objective="min")
    dom = Domain("d", "vals", list(range(D)))
    vs = [Variable(f"v{i}", dom) for i in range(N)]
    for v in vs:
        dcop.add_variable(v)
    parents = [int(rng.integers(0, i)) for i in range(1, N)]
    mats = rng.uniform(0, 10, (N - 1, D, D)).astype(np.float32)
    for i, p in enumerate(parents):
        dcop.add_constraint(
            NAryMatrixRelation([vs[p], vs[i + 1]], mats[i], name=f"c{i}"))
    dcop.add_agents([AgentDef("a0")])
    return dcop


def tree_dcop(N, D=4, seed=0, objective="min", ragged=False, forest=False):
    """The random trees of the JAX package's whole-sweep tests
    (tests/unit/test_pallas_dpop.py): each node's parent among the 8
    before it; ``forest`` makes every 17th node a new root, ``ragged``
    puts every second variable on a domain of D - 2 values."""
    from pydcop_tpu_torch.dcop import (
        DCOP,
        AgentDef,
        Domain,
        NAryMatrixRelation,
        Variable,
    )

    rng = np.random.default_rng(seed)
    dcop = DCOP("t", objective=objective)
    doms = [Domain("d", "vals", list(range(D)))]
    if ragged:
        doms.append(Domain("d2", "vals", list(range(max(2, D - 2)))))
    vs = []
    for i in range(N):
        v = Variable(f"v{i}", doms[i % len(doms)])
        vs.append(v)
        dcop.add_variable(v)
    for i in range(1, N):
        if forest and i % 17 == 0:
            continue
        p = int(rng.integers(max(0, i - 8), i))
        mat = rng.uniform(0, 10, (len(vs[p].domain), len(vs[i].domain)))
        dcop.add_constraint(NAryMatrixRelation(
            [vs[p], vs[i]], mat.astype(np.float32), name=f"c{i}"))
    dcop.add_agents([AgentDef("a0")])
    return dcop


def dpop_pack(dcop, dev):
    """(pseudo-tree, sweep plan on dev, whole-sweep layout or None)."""
    from pydcop_tpu_torch.graph import pseudotree
    from pydcop_tpu_torch.ops.dpop_sweep import compile_sweep
    from pydcop_tpu_torch.ops.packed_dpop import pack_sweep

    tree = pseudotree.build_computation_graph(dcop)
    plan = compile_sweep(tree, dcop, dcop.objective, device=dev)
    return tree, plan, None if plan is None else pack_sweep(plan)


def dpop_kernel_vs_plain(plan, ps):
    """The whole-sweep kernel against its plain version on the card, at
    the wrapper's grid and at forced grids of 1 and 3 blocks, and its
    assignment against the level scan's.  Returns the max abs error over
    assign, msg and cs; raises on any difference."""
    import torch

    from pydcop_tpu_torch.ops.dpop_sweep import run_sweep
    from pydcop_tpu_torch.ops.packed_dpop import (
        whole_sweep,
        whole_sweep_plain,
    )

    p = whole_sweep_plain(ps)
    scan = run_sweep(plan)[0]
    err = 0.0
    for blocks in COOP_GRIDS:
        k = whole_sweep(ps, **({} if blocks == "wrapper"
                               else {"blocks": blocks}))
        torch.cuda.synchronize()
        for name, a, b in zip(("assign", "msg", "cs"), k, p):
            if a.is_floating_point() and not torch.isfinite(a).all():
                raise AssertionError(f"kernel {name} has non-finite values "
                                     f"(grid {blocks})")
            if not torch.equal(a, b):
                raise AssertionError(f"kernel {name} differs from plain in "
                                     f"{int((a != b).sum())} entries (grid "
                                     f"{blocks})")
            err = max(err, float((a.double() - b.double()).abs().max()))
        if not np.array_equal(k[0].cpu().numpy(), scan):
            raise AssertionError(f"kernel assign differs from the level "
                                 f"scan's (grid {blocks})")
    return err


def dpop_bytes_ops(ps):
    """Bytes and float operations of one whole sweep, each input read
    once and each output written once: in the [n, D, D] table, the CSR
    children, parent and level starts; out assign (msg and cs are the
    kernel's intermediates, not the function's outputs).  UTIL adds each
    child's D message values, then per node D*D adds and D*(D-1)
    reductions; VALUE per node D adds and D-1 compares."""
    N, D, L = ps.n_nodes, ps.D, ps.L
    n_child = int(ps.child_idx.numel())
    nbytes = 4 * (N * D * D + (N + 1) + n_child + N + (L + 1) + N)
    nops = N * (D * D + D * (D - 1) + D + (D - 1)) + D * n_child
    return nbytes, nops


def time_dpop(ps, reps=200):
    """(ms per sweep by CUDA events over ``reps`` back-to-back sweeps,
    plain ms, bound ms, bound_by, bytes, device us per sweep from the
    profiler: the one launch's)."""
    from pydcop_tpu_torch.ops.packed_dpop import (
        whole_sweep,
        whole_sweep_plain,
    )

    whole_sweep(ps)  # warm-up
    ms = cuda_ms(lambda: whole_sweep(ps), reps)
    whole_sweep_plain(ps)
    plain = cuda_ms(lambda: whole_sweep_plain(ps), 3)
    nbytes, nops = dpop_bytes_ops(ps)
    bound, by = bound_of(nbytes, nops)
    device_us = profile_us(lambda: [whole_sweep(ps) for _ in range(20)],
                           [DPOP_KERNEL])[DPOP_KERNEL]
    return ms, plain, bound, by, nbytes, device_us


#: the sweep kernel's name in a profiler trace (one launch a sweep)
DPOP_KERNEL = "dpop_sweep_coop_kernel"
#: the design of K10 (the ``design`` key of its row in the kernels line)
DPOP_DESIGN = ("one cooperative launch a sweep: UTIL from the deepest "
               "level up, then VALUE from the roots down, each level a "
               "grid-stride loop over tiles of nodes (UTIL one thread a "
               "(node, value), VALUE one thread a node), grid barriers "
               "between levels (2L - 1 a sweep) over a few blocks")


def dpop_grid(ps):
    """Blocks of one sweep launch on this card, as the wrapper sizes its
    grid."""
    from pydcop_tpu_torch.ops import packed_dpop

    return packed_dpop.sweep_blocks(ps, *packed_dpop._capacity(ps.D,
                                                               ps.mode))


def dpop_breakdown(dcop, dev):
    """Where a dpop solve's time goes (host clock around work that ends
    in a synchronize): pseudo-tree, compile_sweep, pack, the sweep, and
    scoring (assignment, message metrics, solution cost)."""
    import torch

    from pydcop_tpu_torch.algorithms.dpop import DpopSolver
    from pydcop_tpu_torch.graph import pseudotree
    from pydcop_tpu_torch.ops.dpop_sweep import compile_sweep
    from pydcop_tpu_torch.ops.packed_dpop import pack_sweep, \
        whole_sweep_values

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    tree, graph_s = timed(lambda: pseudotree.build_computation_graph(dcop))
    plan, compile_s = timed(lambda: compile_sweep(tree, dcop, "min",
                                                  device=dev))
    ps, pack_s = timed(lambda: pack_sweep(plan))
    assign, sweep_s = timed(lambda: whole_sweep_values(ps))
    t0 = time.perf_counter()
    DpopSolver(dcop, tree, device=dev)._finish_sweep_result(
        assign.cpu().numpy(), plan.gid_to_name, plan.sep_size, t0)
    return dict(graph_s=graph_s, compile_s=compile_s, pack_s=pack_s,
                sweep_s=sweep_s, solution_cost_s=time.perf_counter() - t0,
                n_nodes=plan.n_nodes, L=plan.L,
                tables_per_s=plan.n_nodes / sweep_s)


def reset_counts():
    """Zero the launch counter of every kernel wrapper."""
    from pydcop_tpu_torch.ops import reset_launch_counters

    reset_launch_counters()


def read_counts():
    """Every kernel wrapper's launch counter, by name."""
    from pydcop_tpu_torch.ops import read_launch_counters

    return read_launch_counters()


#: the algorithms :func:`breakdown` takes apart, and their solver classes
BREAKDOWN_SOLVERS = {"maxsum": "MaxSumSolver", "mgm": "MgmSolver",
                     "dsa": "DsaSolver", "mgm2": "Mgm2Solver",
                     "dba": "DbaSolver", "gdba": "GdbaSolver"}


def breakdown(dcop, algo, cycles, dev):
    """Where a solve's time goes, piece by piece (host clock around work
    that ends in a synchronize): the computation graph, compile, pack,
    the cycles, the coin copy (DSA and MGM-2: per chunk of 100 cycles,
    the fixed-cycle chunk; MGM-2 draws three [100, V] tables a chunk) and
    scoring.  dba and gdba run their cycles through the fixed-shape
    runner as the solve does, and add the captured chunk's rate."""
    import torch

    from pydcop_tpu_torch.algorithms import AlgorithmDef, \
        load_algorithm_module
    from pydcop_tpu_torch.graph import load_graph_module
    from pydcop_tpu_torch.ops.compile import compile_constraint_graph, \
        compile_factor_graph

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    mod = load_algorithm_module(algo)
    compile_fn = (compile_factor_graph if algo == "maxsum"
                  else compile_constraint_graph)
    _, graph_s = timed(lambda: load_graph_module(
        mod.GRAPH_TYPE).build_computation_graph(dcop))
    tensors, compile_s = timed(lambda: compile_fn(dcop, device=dev))
    solver_cls = BREAKDOWN_SOLVERS[algo]
    solver, pack_s = timed(lambda: getattr(mod, solver_cls)(
        dcop, tensors, AlgorithmDef.build_with_default_params(algo)))
    state = solver.initial_state()
    out = dict(graph_s=graph_s, compile_s=compile_s, pack_s=pack_s)
    if algo in ("dsa", "mgm2"):
        # the coins of the two 100-cycle chunks: drawn on the CPU alone,
        # then as the solve pays for them (draw, copy, column permute)
        kinds = 3 if algo == "mgm2" else 1
        _, draw_s = timed(lambda: [solver.draw_uniforms(cycles // 2)
                                   for _ in range(2 * kinds)])
        solver.coins.manual_seed(0)
        chunks, coin_s = timed(lambda: [solver.chunk_coins(cycles // 2)
                                        for _ in range(2)])
        out.update(coin_copy_s_per_chunk=coin_s / 2,
                   coin_cpu_draw_s_per_chunk=draw_s / 2,
                   coin_chunk_cycles=cycles // 2)
        from pydcop_tpu_torch.ops.packed_local_search import pack_x, \
            unpack_x

        def run():
            x = pack_x(solver.packed, state[0])
            for coins in chunks:
                x = solver.packed_run(x, cycles // 2, coins)
            return (unpack_x(solver.packed, x),)

        state, cycles_s = timed(run)
    elif algo in ("dba", "gdba"):
        # the solve's own path: the fixed-shape runner at its chunk of
        # 100, whose first two calls run eagerly (a one-shot 200-cycle
        # solve captures nothing); then the capture (with its first
        # replay) and two replays, the path of a longer or repeated run
        chunk = cycles // 2
        runner = solver._fixed_runner(("masked", chunk, False))
        solver._restart_streams(False)

        def chunks(state, k):
            for _ in range(k):
                state = runner(state, solver.draw_chunk_coins(chunk),
                               chunk)[0]
            return state

        state, cycles_s = timed(lambda: chunks(state, 2))
        state, capture_s = timed(lambda: chunks(state, 1))
        state, replay_s = timed(lambda: chunks(state, 2))
        if runner.captures != 1 or runner.replays != 3:
            raise AssertionError(f"{algo}: {runner.captures} captures and "
                                 f"{runner.replays} replays")
        out.update(eager_chunks=2, capture_and_replay_s=capture_s,
                   replayed_cycles_per_s=cycles / replay_s)
    else:
        state, cycles_s = timed(lambda: solver.run_cycles(state, cycles))
    t0 = time.perf_counter()
    assignment = tensors.assignment_from_indices(
        solver.values_of(state).cpu().numpy())
    dcop.solution_cost(assignment, solver.infinity)
    if algo in ("dsa", "mgm2"):
        out["cycles_per_s_with_coins"] = cycles / (cycles_s + coin_s)
    out.update(cycles_s=cycles_s, cycles=cycles,
               cycles_per_s=cycles / cycles_s,
               solution_cost_s=time.perf_counter() - t0)
    return out


def secp_dcop(scale=1, max_model_size=2):
    """The JAX bench's mixed-arity leg (bench.py bench_mixed_arity):
    generate_secp(n_lights=3000, n_models=900, n_rules=300, seed=1), each
    count times ``scale``, with the port's copy of the generator."""
    from pydcop_tpu_torch.generators import generate_secp

    return generate_secp(n_lights=3000 * scale, n_models=900 * scale,
                         n_rules=300 * scale,
                         max_model_size=max_model_size, seed=1)


def mixed_dcop(V, D, counts, seed, ragged=False, hub=False,
               integer=False):
    """A random mixed-arity DCOP of the port's objects: ``counts`` maps
    an arity to its number of factors over random distinct variables
    (``hub``: every factor holds variable 0, the others distinct), costs
    uniform in [0, 5) (``integer``: integers 0-2); ``ragged`` puts every
    second variable on D - 1 values."""
    from pydcop_tpu_torch.dcop import (
        DCOP,
        AgentDef,
        Domain,
        NAryMatrixRelation,
        Variable,
    )

    rng = np.random.default_rng(seed)
    doms = [Domain("d", "vals", list(range(D)))]
    if ragged:
        doms.append(Domain("d2", "vals", list(range(D - 1))))
    vs = [Variable(f"v{i:05d}", doms[i % len(doms)]) for i in range(V)]
    dcop = DCOP("mixed", objective="min")
    for v in vs:
        dcop.add_variable(v)
    k = 0
    for a, n in sorted(counts.items()):
        for _ in range(n):
            if hub:
                idx = [0] + list(1 + rng.choice(V - 1, a - 1, replace=False))
            else:
                idx = rng.choice(V, a, replace=False)
            sc = [vs[i] for i in idx]
            shape = [len(v.domain) for v in sc]
            m = (rng.integers(0, 3, shape) if integer
                 else rng.uniform(0, 5, shape))
            dcop.add_constraint(NAryMatrixRelation(
                sc, m.astype(np.float32), name=f"c{k:06d}"))
            k += 1
    dcop.add_agents([AgentDef("a0")])
    return dcop


def solve_cpu_packed(dcop, algo, params=None, cycles=None):
    """``solve_result(..., device="cpu")`` with the solver built with
    ``use_packed=True``: the packed layout through the plain versions,
    the reference a card run of the packed engine is held to."""
    from pydcop_tpu_torch.algorithms import AlgorithmDef, \
        load_algorithm_module

    algo_def = AlgorithmDef.build_with_default_params(
        algo, params or {}, mode=dcop.objective)
    solver = load_algorithm_module(algo).build_solver(
        dcop, None, algo_def, seed=0, device="cpu", use_packed=True)
    stop = cycles if cycles is not None else (
        algo_def.params.get("stop_cycle") or None)
    return solver.run(cycles=stop)


def is_mixed(dcop):
    from pydcop_tpu_torch.ops.compile import compile_factor_graph

    return any(b.arity != 2 and b.n_factors
               for b in compile_factor_graph(dcop, device="cpu").buckets)


#: shards of the sharded phases: the count of a host of 8 cards, run as
#: 8 shards on the one card (4 on the star and the unequal domains)
SHARDS = 8
#: cycles of each engine run of the sharded kernels' launch-by-launch
#: checks (the script's time limit holds every phase)
SHARDED_CHECK_CYCLES = 10


def checked_kernels(errs):
    """Context manager: while active, the engines' K7/K8/K9 calls run the
    kernel AND its plain version on the same inputs, hold them together
    exactly (max abs error 0: each launches once per device over its
    group of shards) and carry on with the kernel's outputs.  ``errs``
    collects the max abs error per kernel and branch (``_mixed`` for a
    mixed layout, ``_act`` for K7 with an activation row, ``_max`` /
    ``_min`` for K8's modes on a group that holds only some shards)."""
    import contextlib
    import inspect

    import torch

    from pydcop_tpu_torch.ops import packed_sharded as K

    def check(base, kernel, plain):
        sig = inspect.signature(kernel)

        def run(where, *args, **kwargs):
            given = sig.bind(where, *args, **kwargs).arguments
            mode = given.get("mode", "move")
            name = (base + ("_mixed" if getattr(where, "mixed", None)
                            else "")
                    + ("_act" if given.get("active") is not None else "")
                    + ("" if mode == "move" else "_" + mode))
            k = kernel(where, *args, **kwargs)  # counts on the wrapper
            p = plain(where, *args, **kwargs)
            ks = k if isinstance(k, tuple) else (k,)
            ps = p if isinstance(p, tuple) else (p,)
            torch.cuda.synchronize()
            for a, b in zip(ks, ps):
                d = (a.double() - b.double()).abs()
                err = float(d.max()) if d.numel() else 0.0
                errs[name] = max(errs.get(name, 0.0), err)
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"{name}: kernel differs from plain (max abs error "
                        f"{err})")
            return k
        return run

    @contextlib.contextmanager
    def patched():
        real = (K.device_fused_ba, K.device_mgm_move, K.device_tables)
        K.device_fused_ba = check("device_fused_ba", real[0],
                                  K.device_fused_ba_plain)
        K.device_mgm_move = check("device_mgm_move", real[1],
                                  K.device_mgm_move_plain)
        K.device_tables = check("device_tables", real[2],
                                K.device_tables_plain)
        try:
            yield
        finally:
            K.device_fused_ba, K.device_mgm_move, K.device_tables = real
    return patched()


def split_groups(devices):
    """Two groups of shards (even, odd) on one card, as two cards would
    hold them: each K7/K9 launch writes its shards' partials and the
    engine adds them in shard order (the partials branch)."""
    n = len(devices)
    return [list(range(0, n, 2)), list(range(1, n, 2))]


def sharded_kernel_vs_plain(t, n_shards, cycles=20, split=False,
                            overlap=None, exchange=None,
                            dampings=(0.5, 0.0)):
    """K7, K8 and K9 against their plain versions on the card, launch by
    launch inside real sharded runs: maxsum at damping 0.5 and 0 (K7),
    amaxsum at activation 0.7 (K7's activation branch), mgm and dsa (K9,
    K8 in mgm), ``cycles`` cycles each; on a mixed graph the kernels'
    mixed branches.  ``split``: the shards in two groups on the card
    (:func:`split_groups`), so K7 and K9 write partials and K8 runs its
    "max" and "min" modes.  ``overlap`` and ``exchange``: the engines'
    collective path (the compact modes combine the partials at the
    boundary only); ``dampings`` the maxsum runs'.  Returns (errs per
    kernel and branch, stats)."""
    import contextlib
    from unittest import mock

    import torch

    from pydcop_tpu_torch.parallel import ShardedLocalSearch, \
        ShardedMaxSum, build_mesh, packed_mesh

    errs = {}
    mesh = build_mesh(n_shards, "cuda")
    grouping = (mock.patch.object(packed_mesh, "_device_groups",
                                  split_groups) if split
                else contextlib.nullcontext())
    comm = dict(overlap=overlap, exchange=exchange)
    with checked_kernels(errs), grouping:
        for damping in dampings:
            ShardedMaxSum(t, mesh, damping=damping, **comm).run(cycles)
        # amaxsum: K7's activation branch
        ShardedMaxSum(t, mesh, damping=0.5, activation=0.7,
                      **comm).run(cycles)
        moved = {}
        for rule in ("mgm", "dsa"):
            eng = ShardedLocalSearch(t, mesh, rule=rule, **comm)
            x0 = eng.run_chunked(0, seed=1)[1]
            _, x, _ = eng.run_chunked(cycles, x=x0, seed=1)
            moved[rule] = int((eng.state_values(x)
                               != eng.state_values(x0)).sum())
        packs = ShardedMaxSum(t, mesh).packs
    Ns = [sh.N for sh in packs.shards]
    torch.cuda.synchronize()
    extra = {}
    if packs.mixed:
        extra["slots_by_arity"] = [
            sum(len(sh.slot_of.get(a, ())) for sh in packs.shards)
            for a in (1, 2, 3, 4)]
    return errs, dict(
        **extra, groups=[list(g.index) for g in packs.groups],
        S=n_shards, N_min=min(Ns), N_max=max(Ns), Vp=packs.Vp, D=packs.D,
        max_shard_deg=max(int(sh.t_deg.max()) for sh in packs.shards),
        boundary_columns=packs.boundary.n_boundary,
        cut_fraction=round(packs.boundary.cut_fraction, 4), moved=moved)


def block_distribution(dcop, n_agents):
    """Agent k hosts the k-th block of variables (in name order) and every
    constraint whose first variable is in its block."""
    from pydcop_tpu_torch.distribution import Distribution

    names = sorted(dcop.variables)
    agent_of = {n: f"a{k * n_agents // len(names):02d}"
                for k, n in enumerate(names)}
    mapping = {f"a{k:02d}": [] for k in range(n_agents)}
    for n in names:
        mapping[agent_of[n]].append(n)
    for c in sorted(dcop.constraints):
        mapping[agent_of[dcop.constraints[c].dimensions[0].name]].append(c)
    return Distribution(mapping)


def sharded_bytes_ops(packs, act=False):
    """{kernel: (bytes, operations)} of one launch.  K7 and K9 launch once
    a cycle over the card's group of shards; each input is read once: the
    combined beliefs (K7) or the values (K9) at the columns some shard
    touches, once for the group, not once per shard; each factor's table
    once (K7: D^a entries for an arity-a factor, though the layout keeps a
    rotated copy per slot; K9 the D entries its values select); the slot
    arrays (vmask, inv_dcount, and the ints each slot's kernel reads:
    binary the mate and its column (K7) or the column (K9); mixed K7 the
    cost index, the a - 1 siblings' slot and column and the phase-1 item
    (slot, shard), mixed K9 the arity, the cost index and the a - 1
    siblings' columns); the walk as the launch reads it (the threads'
    columns, the column offsets, each slot's entry and shard in its
    column's list, and the shard descriptors); the
    unary row (K9 also the mask).  Out: r_new (K7) and ONE [D, Vp] result,
    where the per-shard launches wrote S partials.  ``act`` adds K7's
    activation operands: q_m, r_m and the active row in (and each slot's
    column on a mixed layout), q1 and r1 out.  Operations: each slot's
    pending sides, factor side, vmask, damping and partial add, and the
    S + 1 adds a (column, value) of the combine.

    K8 launches once a cycle over the group too (the move mask of a whole
    group): it reads the gains [Vp] once, each real sibling's column,
    mask and variable index (12 bytes; one sibling a binary slot, a - 1
    a mixed slot of arity a), the walk as it reads it (corder [Vp], cptr
    [Vp + 1], centry [n_slots]) and idx_row [Vp], and writes one byte a
    column:

        bytes = 4 Vp + 12 siblings + 4 (2 Vp + 1 + n_slots) + 4 Vp + Vp

    operations: a multiply, a max, a compare and a min a sibling, 8 a
    column (the threshold and the decision).  The per-shard design it
    replaced made one launch a shard: ``packed_shard_route_gains_per_shard``
    adds up those launches' rows (each read the gains at the columns it
    touches, its slots' masks and sibling columns, its four walk arrays,
    and wrote nm_part and the routed gains), 8 x the per-launch bound at
    8 shards, with nothing for the plain launches of the arbitration that
    followed them."""
    D, Vp = packs.D, packs.Vp
    g = packs.groups[0]
    S = len(g.shards)
    touched = int(((g.cptr[1:] - g.cptr[:-1]) > 0).sum())
    # corder, cptr, and each slot's entry and shard in the column lists
    walk = Vp + (Vp + 1) + 2 * g.n_slots + 2 * 10 * S
    k7 = D * touched + walk + 2 * D * Vp
    k9 = touched + walk + 3 * D * Vp
    ops7 = S * D * Vp
    ops9 = S * D * Vp
    k8_old, sibs8 = [], 0
    for sh in packs.shards:
        if not sh.N:
            continue
        N = sh.N
        if sh.mixed is None:
            n_a = {2: N}
            sibs = 1
            ints7, ints9 = 2 * N, N
        else:
            n_a = {a: len(sh.slot_of.get(a, ())) for a in (1, 2, 3, 4)}
            sibs = 3
            ints7 = sum(n * (2 * a + 1) for a, n in n_a.items())
            ints9 = sum(n * (a + 1) for a, n in n_a.items())
        table = sum(D ** a * n // a for a, n in n_a.items())
        k7 += D * N + table + D * N + N + ints7 + D * N
        if act:
            k7 += 2 * D * N + N + 2 * D * N
            if sh.mixed is not None:
                k7 += N
        # per slot: the pending side of each sibling (D subtractions, D
        # multiply-adds, D subtract-multiplies, one multiply), the factor
        # side (binary D adds and D-1 mins a value; arity a about
        # 3 D^(a-1) a value), vmask, damping (3) and the partial add
        side = sum(n * (a - 1) * (5 * D + 1) for a, n in n_a.items())
        factor = sum(n * (D * (2 * D - 1) if a == 2 else 3 * D ** a)
                     for a, n in n_a.items() if a > 1)
        ops7 += side + factor + N * 5 * D
        k9 += D * N + ints9
        ops9 += D * N
        touched_s = int((sh.t_deg > 0).sum())
        k8_old.append((4 * (touched_s + sibs * N * 2 + 4 * Vp + Vp
                            + sibs * N), 2 * sibs * N))
        sibs8 += sum(n * (a - 1) for a, n in n_a.items())
    k8 = 4 * Vp + 12 * sibs8 + 4 * (2 * Vp + 1 + g.n_slots) + 4 * Vp + Vp
    return {"packed_shard_fused_ba": (4 * k7, ops7),
            "packed_shard_route_gains": (k8, 4 * sibs8 + 8 * Vp),
            "packed_shard_route_gains_per_shard": (
                sum(r[0] for r in k8_old), sum(r[1] for r in k8_old)),
            "packed_shard_tables": (4 * k9, ops9)}


def time_sharded(t, n_shards, reps=100, amaxsum=False):
    """K7, K8 and K9 per cycle (one launch a cycle over the card's group
    of shards; CUDA events over ``reps`` back-to-back launches), the plain
    versions' ms, device us per launch (profiler), bounds (K8 also the
    per-shard design's, ``per_shard_design_bound_ms``, and MGM's whole
    arbitration through the engine, ``mgm_arbitration_ms``), and the
    sharded cycles/s of maxsum, mgm and dsa (host clock over 200 cycles,
    ending in a synchronize); on a mixed graph the kernels' mixed
    branches.  ``amaxsum``: K7's activation branch at activation 0.7
    instead, and the sharded amaxsum cycles/s."""
    import torch

    from pydcop_tpu_torch.ops import packed_sharded as K
    from pydcop_tpu_torch.parallel import ShardedLocalSearch, \
        ShardedMaxSum, build_mesh

    mesh = build_mesh(n_shards, "cuda")
    # the dense collective (overlap "off"): the path these numbers were
    # measured on before the compact modes came; sharded_compact_phase
    # times those
    ms_eng = ShardedMaxSum(t, mesh, activation=0.7 if amaxsum else None,
                           overlap="off")
    packs = ms_eng.packs
    g = packs.groups[0]
    mixed = "_mixed" if packs.mixed else ""
    _, state, _ = ms_eng.run(5)
    bo = sharded_bytes_ops(packs, act=amaxsum)
    if amaxsum:
        q_m, r_m, r_u, bel, _ = state
        gen = torch.Generator(device="cpu").manual_seed(0)
        act = (torch.rand(g.n_slots, generator=gen) < 0.7).float().to(
            g.device)
        k7 = (g, bel[0], g.slab_of(r_u), 0.5, g.slab_of(q_m),
              g.slab_of(r_m), act)
        calls = {"packed_shard_fused_ba": (
            lambda: K.device_fused_ba(*k7),
            lambda: K.device_fused_ba_plain(*k7),
            "device_fused_ba_kernel", 1)}
    else:
        r_u, bel = state
        r = g.slab_of(r_u)
        ls = ShardedLocalSearch(t, mesh, rule="mgm", overlap="off")
        x = ls.run_chunked(5, seed=0)[1]
        gain = K.cur_best_gain(K.device_tables(g, x), x, False)[2]
        row = packs.common_on(g.device)[2]
        calls = {
            "packed_shard_fused_ba": (
                lambda: K.device_fused_ba(g, bel[0], r, 0.5),
                lambda: K.device_fused_ba_plain(g, bel[0], r, 0.5),
                "device_fused_ba_kernel", 1),
            "packed_shard_route_gains": (
                lambda: K.device_mgm_move(g, gain, row),
                lambda: K.device_mgm_move_plain(g, gain, row),
                "device_mgm_move_kernel", 1),
            "packed_shard_tables": (
                lambda: K.device_tables(g, x),
                lambda: K.device_tables_plain(g, x),
                f"device_tables{mixed}_kernel", 1),
        }
    out = {}
    for name, (kern, plain, kname, per_cycle) in calls.items():
        for _ in range(3):  # warm-up
            kern()
        cycle_ms = cuda_ms(kern, reps)
        plain_ms = cuda_ms(plain, 3)
        device_us = profile_us(lambda: [kern() for _ in range(10)],
                               [kname])[kname]
        bound, by = bound_of(*bo[name])
        out[name + mixed + ("_act" if amaxsum else "")] = dict(
            kernel_ms=cycle_ms / per_cycle, plain_ms=plain_ms / per_cycle,
            bound_ms=bound, bound_by=by, bytes_per_launch=bo[name][0],
            profiler_kernel_us=device_us, launches_per_cycle=per_cycle,
            ms_per_cycle=cycle_ms)
    if not amaxsum:
        k8 = out["packed_shard_route_gains" + mixed]
        k8["per_shard_design_bound_ms"] = bound_of(
            *bo["packed_shard_route_gains_per_shard"])[0]
        k8["mgm_arbitration_ms"] = cuda_ms(lambda: ls._mgm_move([gain]),
                                           reps)
    rates = {}
    if amaxsum:
        runs = (("amaxsum", lambda: ms_eng.run(200)),)
    else:
        dsa = ShardedLocalSearch(t, mesh, rule="dsa", overlap="off")
        runs = (("maxsum", lambda: ms_eng.run(200)),
                ("mgm", lambda: ls.run_chunked(200, seed=0)),
                # dsa: with the draw and copy of its 200 coin rows
                ("dsa", lambda: dsa.run_chunked(200, seed=0)))
    for label, run in runs:
        run()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        rates[label] = 200 / (time.perf_counter() - t0)
    return out, rates


#: one A/B turn (run in a fresh process from the root of a tree, the
#: tree's own chip_smoke.py and kernels): K1-mixed on the SECPs; K6 on
#: the two colourings and two SECPs; K4 (and K2, K5) and K5 with the dsa
#: rates on the two colourings and three SECPs; K7 (maxsum and amaxsum)
#: and the
#: local-search kernels at 8 shards on the four sharded sizes, through the
#: tree's ``time_sharded``, as per-cycle rows; and MGM's whole
#: arbitration a cycle (CUDA events around 100 calls of the engine's
#: ``_mgm_move`` from one cycle's gains)
AB_TURN = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as C
from pydcop_tpu_torch.ops import cuda_build
from pydcop_tpu_torch.ops import packed_maxsum as PM
from pydcop_tpu_torch.ops import packed_sharded as K
from pydcop_tpu_torch.parallel import ShardedLocalSearch, build_mesh
from pydcop_tpu_torch.ops.compile import compile_binary_from_arrays, \
    compile_factor_graph
cuda_build.build_all()
dev = torch.device("cuda")
sections = sys.argv[1].split(",")
# K1-mixed: one call of 200 cycles (events), the profiler's device time,
# the grid, equality with the plain version after 20 cycles, and the
# single-device SECP maxsum cycles/s of a 200-cycle solve; only what both
# trees' packed_maxsum and chip_smoke have in common is used
secps = {"secp_3.9k": (1, 2), "secp4_3.9k": (1, 3),
         "secp4_39k": (C.SECP_BIG_SCALE, 3)}
for name, (scale, mms) in secps.items():
    if "k1_mixed" not in sections:
        break
    dcop = C.secp_dcop(scale, mms)
    pg = PM.pack_for_gpu(compile_factor_graph(dcop, device=dev))
    if hasattr(PM, "mixed_blocks"):
        design = "two phases, cooperative"
        blocks = PM.mixed_blocks(pg, *PM._capacity(pg.D))
    else:
        design = "one thread a column"
        blocks = -(-pg.Vp // 128)
    q, r = PM.packed_init_state(pg)
    kout = PM.packed_cycles(pg, q, r, 20, damping=0.5)
    pout = PM.packed_cycles_plain(pg, q, r, 20, damping=0.5)
    torch.cuda.synchronize()
    ms, plain, bound, by, nbytes, device_us = C.time_kernel(pg)
    row = {"size": name, "kernel": "packed_maxsum_mixed_cycle",
           "design": design, "blocks": blocks, "events_us_per_cycle": ms * 1e3,
           "device_us_per_cycle": device_us, "bound_us": bound * 1e3,
           "plain_ms": plain,
           "max_abs_err": max(float((a - b).abs().max())
                              for a, b in zip(kout[:3], pout[:3])),
           "equal": all(torch.equal(a, b) for a, b in zip(kout, pout))}
    if name != "secp4_3.9k":
        row["maxsum_cycles_per_s"] = C.breakdown(
            dcop, "maxsum", 200, dev)["cycles_per_s"]
    print(json.dumps(row), flush=True)
# K6: one call of 200 cycles (events), the profiler's device time a
# cycle, the grid, equality with the plain version after 20 cycles, and
# a 200-cycle mgm2 solve (the harness's two chunks of 100): its
# cycles-only rate (coins drawn beforehand), its coins' draw and copy a
# chunk, and its rate with them; only what both trees' packed_mgm2 and
# chip_smoke have in common is used
from pydcop_tpu_torch.ops import packed_mgm2 as MG
from pydcop_tpu_torch.ops.packed_local_search import pack_from_pg


def colouring(V, E):
    ei, ej, mats, un = C.coloring_arrays(V, E)
    return (PM.pack_for_gpu(compile_binary_from_arrays(
        ei, ej, mats, V, unary=un, device=dev)),
        lambda: C.coloring_dcop(V, E))


def secp(scale, mms):
    dcop = C.secp_dcop(scale, mms)
    return PM.pack_for_gpu(compile_factor_graph(dcop, device=dev)), \
        lambda: dcop


# K1 binary: one call of 200 cycles (events), the profiler's device time
# a cycle, the grid, equality with the plain version after 20 cycles (here
# also at 1 and 3 blocks), and the maxsum cycles-only rate of a 200-cycle
# solve; where the tree's packed_maxsum has the launch shape as module
# constants, each shape of a sweep (threads, tile width, grid cap) timed
# by events over one 200-cycle call, and its equality
k1_sizes = {"10k_30k": lambda: colouring(10_000, 30_000),
            "100k_300k": lambda: colouring(100_000, 300_000),
            "star_2500": lambda: (PM.pack_for_gpu(C.star_tensors(2500, dev)),
                                  None)}
for name, make in k1_sizes.items():
    if "k1" not in sections:
        break
    pg, make_dcop = make()
    q, r = PM.packed_init_state(pg)
    k = PM.packed_cycles(pg, q, r, 20, damping=0.5)
    p = PM.packed_cycles_plain(pg, q, r, 20, damping=0.5)
    coop = hasattr(PM, "binary_blocks")
    if coop:
        design = "one cooperative launch a call"
        blocks = C.k1_grid(pg)
        grids_equal = all(
            all(torch.equal(a, b) for a, b in zip(PM.packed_cycles(
                pg, q, r, 20, damping=0.5, blocks=g), p)) for g in (1, 3))
    else:
        design = "one launch a cycle"
        blocks = -(-pg.Vp // 128)
        grids_equal = None
    torch.cuda.synchronize()
    ms, plain, bound, by, nbytes, device_us = C.time_kernel(pg)
    row = {"size": name, "kernel": "packed_maxsum_cycle", "design": design,
           "blocks": blocks, "events_us_per_cycle": ms * 1e3,
           "device_us_per_cycle": device_us, "bound_us": bound * 1e3,
           "plain_ms": plain, "equal": all(torch.equal(a, b)
                                           for a, b in zip(k, p)),
           "equal_at_1_and_3_blocks": grids_equal}
    if make_dcop is not None:
        row["maxsum_cycles_per_s"] = C.breakdown(
            make_dcop(), "maxsum", 200, dev)["cycles_per_s"]
    print(json.dumps(row), flush=True)
    if not coop:
        continue
    shape = (PM.BINARY_THREADS, PM.TILE_COLS, PM.BINARY_GRID_CAP)
    for threads in (128, 256, 512):
        for cols in (32, 64, 128, 256):
            for cap in (132, 264, 528, 1056):
                if cols > threads:
                    continue
                PM.BINARY_THREADS, PM.TILE_COLS, PM.BINARY_GRID_CAP = \
                    threads, cols, cap
                out = PM.packed_cycles(pg, q, r, 20, damping=0.5)
                same = all(torch.equal(a, b) for a, b in zip(out, p))
                us = C.cuda_ms(lambda: PM.packed_cycles(
                    pg, q, r, 200, damping=0.5), 1) * 1e3 / 200
                print(json.dumps({
                    "size": name, "kernel": "packed_maxsum_cycle",
                    "sweep": True, "threads": threads, "tile_cols": cols,
                    "grid_cap": cap, "blocks": C.k1_grid(pg),
                    "events_us_per_cycle": us, "equal": same}), flush=True)
    PM.BINARY_THREADS, PM.TILE_COLS, PM.BINARY_GRID_CAP = shape
k6_sizes = {"10k_30k": lambda: colouring(10_000, 30_000),
            "100k_300k": lambda: colouring(100_000, 300_000),
            "secp_3.9k": lambda: secp(1, 2),
            "secp4_39k": lambda: secp(C.SECP_BIG_SCALE, 3)}
for name, make in k6_sizes.items():
    if "mgm2" not in sections:
        break
    pg, make_dcop = make()
    pm = MG.pack_mgm2_from_pls(pack_from_pg(pg))
    if hasattr(MG, "mgm2_blocks"):
        design = "one cooperative launch a call"
        blocks = C.mgm2_grid(pm)[0]
    else:
        design = "six launches a cycle"
        blocks = -(-pg.Vp // 128)
    x = C.random_x_col(pm.pls, 0)
    u = C.mgm2_coins(pm.pls, 20, 0)
    k = MG.packed_mgm2_cycles(pm, x, *u, 0.5, "unilateral")
    p = MG.packed_mgm2_cycles_plain(pm, x, *u, 0.5, "unilateral")
    # and at forced grids of 1 and 3 blocks
    grids_equal = all(torch.equal(MG._launch_cycles(
        pm, x, *u, 0.5, "unilateral", blocks), p) for blocks in (1, 3))
    torch.cuda.synchronize()
    ms, plain, bound, by, nbytes, device_us, us, offers = C.time_mgm2(pm)
    solve = C.breakdown(make_dcop(), "mgm2", 200, dev)
    row = {"size": name, "kernel": "packed_mgm2_cycles"
           + ("_mixed" if pg.mixed is not None else ""),
           "design": design, "blocks": blocks,
           "events_us_per_cycle": ms * 1e3,
           "device_us_per_cycle": device_us, "bound_us": bound * 1e3,
           "plain_ms": plain, "offers_per_cycle": offers,
           "equal": bool(torch.equal(k, p)),
           "equal_at_1_and_3_blocks": grids_equal,
           "mgm2_cycles_per_s": solve["cycles_per_s"],
           "mgm2_cycles_per_s_with_coins": solve["cycles_per_s_with_coins"],
           "coin_copy_s_per_chunk": solve["coin_copy_s_per_chunk"],
           "coin_cpu_draw_s_per_chunk": solve["coin_cpu_draw_s_per_chunk"]}
    print(json.dumps(row), flush=True)
# K4: one call of 200 cycles (events), the profiler's device time a
# cycle, the grid, equality with the plain version after 20 cycles, and
# the mgm cycles/s of a 200-cycle solve; K2 and K5 come with time_ls; only
# what both trees' packed_local_search and chip_smoke have in common is
# used
from pydcop_tpu_torch.ops import packed_local_search as P

k4_sizes = {"10k_30k": lambda: colouring(10_000, 30_000),
            "100k_300k": lambda: colouring(100_000, 300_000),
            "secp_3.9k": lambda: secp(1, 2),
            "secp4_3.9k": lambda: secp(1, 3),
            "secp4_39k": lambda: secp(C.SECP_BIG_SCALE, 3)}
for name, make in k4_sizes.items():
    if "mgm" not in sections:
        break
    pg, make_dcop = make()
    pls = pack_from_pg(pg)
    if hasattr(P, "grid_blocks"):
        design = "one cooperative launch a call"
        blocks = C.mgm_grid(pls)
    else:
        design = "two launches a cycle"
        blocks = -(-pg.Vp // 128)
    x = C.random_x_col(pls, 0)
    k = P.packed_mgm_cycles(pls, x, 20)
    p = P.packed_mgm_cycles_plain(pls, x, 20)
    torch.cuda.synchronize()
    times = C.time_ls(pls)
    solve = C.breakdown(make_dcop(), "mgm", 200, dev)
    mixed = "_mixed" if pg.mixed is not None else ""
    for kname, (ms, plain, bound, by, nbytes, device_us) in times.items():
        row = {"size": name, "kernel": kname + mixed,
               "events_us_per_cycle": ms * 1e3,
               "device_us_per_cycle": device_us, "bound_us": bound * 1e3,
               "plain_ms": plain}
        if kname == "packed_mgm_cycles":
            row.update(design=design, blocks=blocks,
                       equal=bool(torch.equal(k, p)),
                       mgm_cycles_per_s=solve["cycles_per_s"])
        print(json.dumps(row), flush=True)
# K5: one call of 200 cycles (events), the profiler's device time a
# cycle, the grid, equality with the plain version after 20 cycles (the
# tree's own wrapper; here also at 1 and 3 blocks), and a 200-cycle dsa
# solve: its cycles-only rate, its coins' draw and copy a chunk and its
# rate with them; the design from what the tree's packed_local_search has
dsa_sizes = k4_sizes if "dsa" in sections else {}
for name, make in dsa_sizes.items():
    pg, make_dcop = make()
    pls = pack_from_pg(pg)
    x = C.random_x_col(pls, 0)
    u = torch.rand((20, pg.Vp), device=dev)
    k = P.packed_dsa_cycles(pls, x, u, 0.7)
    p = P.packed_dsa_cycles_plain(pls, x, u, 0.7)
    if hasattr(P, "dsa_cycle"):
        design = "one launch a cycle"
        blocks = -(-pg.Vp // 128)
        grids_equal = None
    else:
        design = "one cooperative launch a call"
        blocks = C.dsa_grid(pls)
        grids_equal = all(torch.equal(P.packed_dsa_cycles(
            pls, x, u, 0.7, blocks=b), p) for b in (1, 3))
    torch.cuda.synchronize()
    ms, plain, bound, by, nbytes, device_us = C.time_ls(pls)[
        "packed_dsa_cycles"]
    solve = C.breakdown(make_dcop(), "dsa", 200, dev)
    row = {"size": name, "kernel": "packed_dsa_cycles"
           + ("_mixed" if pg.mixed is not None else ""),
           "design": design, "blocks": blocks,
           "events_us_per_cycle": ms * 1e3,
           "device_us_per_cycle": device_us, "bound_us": bound * 1e3,
           "plain_ms": plain, "equal": bool(torch.equal(k, p)),
           "equal_at_1_and_3_blocks": grids_equal,
           "dsa_cycles_per_s": solve["cycles_per_s"],
           "dsa_cycles_per_s_with_coins": solve["cycles_per_s_with_coins"],
           "coin_copy_s_per_chunk": solve["coin_copy_s_per_chunk"],
           "coin_cpu_draw_s_per_chunk": solve["coin_cpu_draw_s_per_chunk"]}
    print(json.dumps(row), flush=True)
# K2 from one x on six graphs, in each tree: the solve path's
# packed_local_tables from x in variable order (events a call; every
# kernel the profiler puts on the device in 20 calls, and their device µs
# a call: the parent's pack_x gather, its column-order K2 launch, the
# gather back and the transpose's copy; the change's one launch), equal
# to its plain version; where the tree still has the column-order
# ls_tables (the parent), that launch alone too (events a call, device µs
# a launch); where the tree's packed_local_search has K2's launch shape
# as module constants, equality also at 1 and 3 blocks, the wave the card
# reports, and a sweep of tile width (forced) x threads a block, each
# shape's equality, events and device µs a launch.  A trace that holds
# no ls_tables_kernel is taken again, up to three traces, then fails the
# turn.  Then mgm's K2 step of a collect cycle (local_tables at x: events
# a step, its kernels in 20 steps) and its captured collect cycle (events
# over 20 replays of the chunk-8 graph) on 10k/30k and SECP-3.9k
import time
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def device_kernels(run, name="ls_tables_kernel", tries=3):
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                n, us = out.get(e.name, [0, 0.0])
                out[e.name] = [n + 1, us + e.time_range.elapsed_us()]
        if any(name in k for k in out):
            return out
    raise RuntimeError(f"{tries} profiler traces held no {name}: {out}")


def per_launch_us(kernels, name="ls_tables_kernel"):
    n = sum(v[0] for k, v in kernels.items() if name in k)
    return sum(v[1] for k, v in kernels.items() if name in k) / n


def per_call_us(kernels, calls=20):
    # a kernel runs a whole number of times a call (the parent's two
    # index gathers share a name): a trace that drops a launch's record
    # still gives the others' time
    return sum(us / n * max(1, round(n / calls))
               for n, us in kernels.values())


def k2_forms(pls, x_col, x, reps=200):
    var_run = lambda: P.packed_local_tables(pls, x)
    var_run()
    row = {}
    if hasattr(P, "ls_tables"):
        scratch = P.ls_tables(pls, x_col)
        col_run = lambda: P.ls_tables(pls, x_col, out=scratch)
        col_run()
        row.update(column_events_us=C.cuda_ms(col_run, reps) * 1e3,
                   column_device_us_per_launch=per_launch_us(
                       device_kernels(lambda: [col_run()
                                               for _ in range(20)])))
    var_kernels = device_kernels(lambda: [var_run() for _ in range(20)])
    row.update(variable_events_us=C.cuda_ms(var_run, reps) * 1e3,
               variable_kernels_of_20_calls=var_kernels,
               variable_device_us_per_call=per_call_us(var_kernels),
               variable_k2_device_us_per_launch=per_launch_us(var_kernels))
    return row


def k2_equal(pls, x_col, x, want, blocks=None):
    kw = {} if blocks is None else {"blocks": blocks}
    same = torch.equal(P.packed_local_tables(pls, x, **kw), want[0])
    if hasattr(P, "ls_tables"):
        same = same and all(torch.equal(a, b) for a, b in zip(
            P.ls_tables(pls, x_col, **kw), want[1]))
    return same


k2_graphs = {"10k_30k": lambda: colouring(10_000, 30_000)[0],
             "100k_300k": lambda: colouring(100_000, 300_000)[0],
             "secp_3.9k": lambda: secp(1, 2)[0],
             "secp4_39k": lambda: secp(C.SECP_BIG_SCALE, 3)[0],
             "star_2500": lambda: PM.pack_for_gpu(C.star_tensors(2500, dev)),
             "unequal_5k_15k": lambda: PM.pack_for_gpu(
                 C.unequal_domains_tensors(5000, 15_000, 4, dev))}
for name, make in k2_graphs.items():
    if "k2" not in sections:
        break
    pls = pack_from_pg(make())
    x_col = C.random_x_col(pls, 0)
    x = P.unpack_x(pls, x_col)
    plain = P.ls_tables_plain(pls, x_col)
    want = (plain[0][:, pls.pg.var_order].T.contiguous(), plain)
    tuned = hasattr(P, "TABLES_TILE_WIDTHS")
    mixed = pls.pg.mixed is not None
    kname = "ls_tables" + ("_mixed" if mixed else "")
    row = {"size": name, "kernel": kname, "N": pls.N,
           "Vp": pls.Vp, "max_deg": int(pls.pg.col_deg.max()),
           "design": "tiles, one launch" if tuned
           else "one thread a column",
           "equal": k2_equal(pls, x_col, x, want),
           "equal_at_1_and_3_blocks": all(
               k2_equal(pls, x_col, x, want, b) for b in (1, 3))
           if tuned else None, **k2_forms(pls, x_col, x)}
    if tuned:
        threads, cols, tiles = P.tables_shape(pls, pls.device)
        row.update(threads=threads, tile_cols=cols, blocks=tiles.shape[0],
                   wave=P.tables_wave(pls.device, pls.D, mixed, threads))
    print(json.dumps(row), flush=True)
    if not tuned:
        continue
    shape = (P.TABLES_THREADS, P.TABLES_TILE_WIDTHS)
    for threads in (128, 256):
        for cols in (32, 64, 128):
            P.TABLES_THREADS, P.TABLES_TILE_WIDTHS = threads, (cols,)
            print(json.dumps({
                "size": name, "kernel": kname, "sweep": True,
                "threads": threads, "tile_cols": cols,
                "blocks": C.k2_grid(pls),
                "wave": P.tables_wave(pls.device, pls.D, mixed, threads),
                "equal": k2_equal(pls, x_col, x, want),
                **k2_forms(pls, x_col, x)}), flush=True)
    P.TABLES_THREADS, P.TABLES_TILE_WIDTHS = shape
from pydcop_tpu_torch.algorithms import load_algorithm_module

collect = {"10k_30k": lambda: C.coloring_dcop(10_000, 30_000),
           "secp_3.9k": lambda: C.secp_dcop(1, 2)}
for name, make in collect.items():
    if "k2" not in sections:
        break
    solver = load_algorithm_module("mgm").build_solver(make(), device="cuda")
    solver.run(cycles=200, chunk=8, collect_cycles=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.run(cycles=200, chunk=8, collect_cycles=True)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    runner = solver._runners[("masked", 8, True)]
    state = solver.initial_state()
    coins = solver.draw_chunk_coins(8)
    runner(state, coins, 8)
    x0 = state[0]
    step = device_kernels(lambda: [solver.local_tables(x0)
                                   for _ in range(20)])
    print(json.dumps({
        "size": name, "kernel": "collect_cycle_mgm", "cost": res.cost,
        "collect_cycles_per_s": 200 / replay_s,
        "captured_us_per_cycle": C.cuda_ms(
            lambda: runner(state, coins, 8), 20) * 1e3 / 8,
        "k2_step_events_us": C.cuda_ms(
            lambda: solver.local_tables(x0), 200) * 1e3,
        "k2_step_kernels_of_20_steps": step,
        "k2_step_device_us": per_call_us(step)}),
        flush=True)
# K10: the bench's 10k- and 100k-node trees and the deep 3,000-node
# checking trees (max: L = 384, ragged: L = 401): events a sweep over 200
# back-to-back sweeps, the profiler's device time a sweep, L, the grid,
# equality with the plain version (here also at 1 and 3 blocks) and the
# tables/s; where the tree's packed_dpop has the grid cap as a module
# constant, each cap of a sweep timed by events over 50 sweeps
from pydcop_tpu_torch.ops import packed_dpop as PD

dpop_trees = {"bench_tree_10k": lambda: C.bench_tree_dcop(10_000),
              "bench_tree_100k": lambda: C.bench_tree_dcop(100_000),
              "max_3k": lambda: C.tree_dcop(3000, seed=5, objective="max"),
              "ragged_3k": lambda: C.tree_dcop(3000, D=5, seed=4,
                                               ragged=True)}
for name, make in dpop_trees.items():
    if "dpop" not in sections:
        break
    _, plan, ps = C.dpop_pack(make(), dev)
    k = PD.whole_sweep(ps)
    p = PD.whole_sweep_plain(ps)
    coop = hasattr(PD, "sweep_blocks")
    if coop:
        design = "one cooperative launch a sweep"
        blocks = C.dpop_grid(ps)
        grids_equal = all(all(torch.equal(a, b) for a, b in zip(
            PD.whole_sweep(ps, blocks=g), p)) for g in (1, 3))
    else:
        design = "2L launches a sweep"
        blocks = None
        grids_equal = None
    torch.cuda.synchronize()
    ms, plain, bound, by, nbytes, device_us = C.time_dpop(ps)
    print(json.dumps({
        "size": name, "kernel": "dpop_whole_sweep", "design": design,
        "n_nodes": ps.n_nodes, "D": ps.D, "L": ps.L, "blocks": blocks,
        "events_us_per_sweep": ms * 1e3, "device_us_per_sweep": device_us,
        "bound_us": bound * 1e3, "plain_ms": plain,
        "tables_per_s": ps.n_nodes / (ms * 1e-3),
        "equal": all(torch.equal(a, b) for a, b in zip(k, p)),
        "equal_at_1_and_3_blocks": grids_equal}), flush=True)
    if not coop:
        continue
    cap0 = PD.SWEEP_GRID_CAP
    for cap in (1, 4, 16, 32, 64, 132, 264, 528, 1056):
        PD.SWEEP_GRID_CAP = cap
        same = all(torch.equal(a, b) for a, b in zip(PD.whole_sweep(ps), p))
        us = C.cuda_ms(lambda: PD.whole_sweep(ps), 50) * 1e3
        print(json.dumps({"size": name, "kernel": "dpop_whole_sweep",
                          "sweep": True, "grid_cap": cap, "L": ps.L,
                          "blocks": C.dpop_grid(ps),
                          "events_us_per_sweep": us, "equal": same}),
              flush=True)
    PD.SWEEP_GRID_CAP = cap0
# the sharded kernels at 8 shards, MGM's whole arbitration a cycle and
# the sharded rates
graphs = {}
for name, V, E in (("10k_30k", 10_000, 30_000),
                   ("100k_300k", 100_000, 300_000)):
    if "sharded" not in sections:
        break
    ei, ej, mats, un = C.coloring_arrays(V, E)
    graphs[name] = compile_binary_from_arrays(ei, ej, mats, V, unary=un,
                                              device=dev)
if "sharded" in sections:
    graphs["secp_3.9k"] = compile_factor_graph(C.secp_dcop(1, 2), device=dev)
    graphs["secp4_39k"] = compile_factor_graph(
        C.secp_dcop(C.SECP_BIG_SCALE, 3), device=dev)
for name, t in graphs.items():
    eng = ShardedLocalSearch(t, build_mesh(C.SHARDS, "cuda"), rule="mgm",
                             overlap="off")
    x = eng.run_chunked(5, seed=0)[1]
    gain = K.cur_best_gain(K.device_tables(eng.groups[0], x), x, False)[2]
    for _ in range(3):
        eng._mgm_move([gain])
    print(json.dumps({"size": name, "mgm_arbitration_ms_per_cycle":
                      C.cuda_ms(lambda: eng._mgm_move([gain]), 100)}),
          flush=True)
    for amaxsum in (False, True):
        out, rates = C.time_sharded(t, C.SHARDS, amaxsum=amaxsum)
        for k, row in out.items():
            n = row["launches_per_cycle"]
            us = row["profiler_kernel_us"]
            print(json.dumps({
                "size": name, "kernel": k, "launches_per_cycle": n,
                "ms_per_cycle": row["kernel_ms"] * n,
                "device_us_per_cycle": None if us is None else us * n,
                "bound_ms_per_cycle": row["bound_ms"] * n,
                "plain_ms_per_cycle": row["plain_ms"] * n}), flush=True)
        print(json.dumps({"size": name, "amaxsum": amaxsum,
                          "cycles_per_s": rates}), flush=True)
# the generic engines, dba and gdba on the 10k/30k colouring CSP and
# amaxsum on the 10k/30k colouring (PERF.md §5): three 200-cycle solves of
# one solver (in a tree with the captured chunk, the first eager, the
# second with the capture, the third all replays), each one's wall time,
# and the eager run_cycles rate; only what both trees' solvers and
# chip_smoke have in common is used
import time
from pydcop_tpu_torch.algorithms import load_algorithm_module

generic = {"dba": C.coloring_csp_dcop, "gdba": C.coloring_csp_dcop,
           "amaxsum": C.coloring_dcop}
for algo, build in generic.items():
    if "harness" not in sections:
        break
    dcop = build(10_000, 30_000)
    solver = load_algorithm_module(algo).build_solver(dcop, device="cuda")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.run(cycles=200)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    state = solver.initial_state()
    solver.run_cycles(state, 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.run_cycles(state, 200)
    torch.cuda.synchronize()
    eager = 200 / (time.perf_counter() - t0)
    print(json.dumps({
        "size": "10k_30k", "algo": algo, "cost": res.cost,
        "first_run_s": walls[0], "second_run_s": walls[1],
        "third_run_s": walls[2], "one_shot_run_cycles_per_s": 200 / walls[0],
        "run_cycles_per_s": 200 / walls[2], "eager_cycles_per_s": eager,
        "trace_count": (solver.trace_count()
                        if hasattr(solver, "trace_count") else None)}),
        flush=True)
"""


#: the sections of an A/B turn (``--ab PARENT [SECTIONS]``)
AB_SECTIONS = ("k1", "k1_mixed", "mgm2", "mgm", "dsa", "k2", "dpop",
               "sharded", "harness")


def ab_kernels(parent, sections=AB_SECTIONS):
    """The kernels of the tree at ``parent`` against this tree's, on this
    card, in turns: parent, change, change, parent; each turn a fresh
    process in its tree (:data:`AB_TURN`) running ``sections``: K1's
    mixed branch on the SECPs with the single-device SECP maxsum rates
    (``k1_mixed``), K6 with the mgm2 cycles-only rates (``mgm2``), K4
    (with K2 and K5) and the mgm rates (``mgm``), K5 and the dsa rates
    (``dsa``), and the sharded kernels with the sharded rates
    (``sharded``); K1's binary branch with the maxsum rates (``k1``),
    K2 with mgm's collect cycle (``k2``) and K10 with the
    tables/s (``dpop``), each with a sweep of its launch shape in this
    tree; the dba, gdba and amaxsum solve rates (``harness``).  Prints
    one JSON line a row, tagged with the turn and the tree, and writes
    them to ``ab_sharded.jsonl`` in the output directory."""
    rows = []
    for turn, (label, tree) in enumerate((("parent", parent), ("change", ROOT),
                                          ("change", ROOT),
                                          ("parent", parent))):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", AB_TURN, ",".join(sections)], cwd=tree,
            capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            fail("ab_kernels", f"{label} turn {turn}: rc={proc.returncode} "
                 f"{proc.stderr[-3000:]}")
        for ln in proc.stdout.splitlines():
            if ln.startswith("{"):
                row = dict(json.loads(ln), turn=turn, tree=label)
                rows.append(row)
                print(json.dumps(row), flush=True)
        say("ab_kernels", turn=turn, tree=label, sections=list(sections),
            seconds=round(time.perf_counter() - t0, 3))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ab_sharded.jsonl"),
              "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    return rows


def amaxsum_rate(dcop, cycles=200):
    """Single-device amaxsum cycles/s on the card (the generic engine,
    plain PyTorch; host clock around ``run_cycles``, which draws and
    copies the masks, ending in a synchronize)."""
    import torch

    from pydcop_tpu_torch.algorithms import load_algorithm_module

    solver = load_algorithm_module("amaxsum").build_solver(dcop,
                                                           device="cuda")
    state = solver.initial_state()
    solver.run_cycles(state, 5)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.run_cycles(state, cycles)
    torch.cuda.synchronize()
    return cycles / (time.perf_counter() - t0)


def lane_permute_vs_plain_and_times(N, S=3, reps=200):
    """K3 at [S, N]: the kernel against its plain version and against
    ``torch.index_select`` (exactly), then ms per launch (CUDA events
    over ``reps`` raw launches, without the wrapper's permutation
    check), the plain version's and ``index_select``'s ms, device us
    (profiler) and the bytes bound (x and perm read once, out written
    once)."""
    import ctypes

    import torch

    from pydcop_tpu_torch.ops import permute as KP

    g = torch.Generator(device="cpu").manual_seed(N)
    x = torch.rand((S, N), generator=g).cuda()
    perm = torch.randperm(N, generator=g).int().cuda()
    k = KP.lane_permute(x, perm)
    p = KP.lane_permute_plain(x, perm)
    lib = torch.index_select(x, 1, perm)
    torch.cuda.synchronize()
    err = float((k - p).abs().max())
    if not (torch.equal(k, p) and torch.equal(k, lib)):
        raise AssertionError(f"lane_permute N={N}: kernel differs from "
                             f"plain (max abs error {err})")
    out = torch.empty_like(x)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def raw():
        e = KP._kernel()(x.data_ptr(), perm.data_ptr(), out.data_ptr(),
                         S, N, stream)
        if e:
            raise RuntimeError(f"lane_permute launch failed: {e}")

    for _ in range(3):
        raw()
    ms = cuda_ms(raw, reps)
    plain_ms = cuda_ms(lambda: KP.lane_permute_plain(x, perm), 20)
    library_ms = cuda_ms(lambda: torch.index_select(x, 1, perm), 20)
    device_us = profile_us(lambda: [raw() for _ in range(10)],
                           ["lane_permute_kernel"])["lane_permute_kernel"]
    nbytes = 4 * (2 * S * N + N)
    bound, by = bound_of(nbytes, 0)
    return err, dict(kernel_ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                     bound_ms=bound, bound_by=by, bytes_per_launch=nbytes,
                     profiler_kernel_us=device_us)


#: the JAX bench's two anytime-search instances (bench.py
#: build_search_dcop): name -> (K, R, D, seed, i_bound)
SEARCH_CASES = {"k10x4": (10, 1, 4, 3, 0), "k11x3_ib2": (11, 2, 3, 7, 2)}
#: the frontier's shape on them, as the JAX bench runs them
SEARCH_WIDTH, SEARCH_STEPS = 256, 8
#: the CPU frontier the card's is held to runs at most this many chunks
#: (k11x3_ib2 takes ~870, ~45 s on the CPU): the card's first chunks'
#: history equals it, and the card's proof equals NCBB's optimum
SEARCH_CPU_CHUNKS = 60
#: chunks run with torch.cuda.set_sync_debug_mode("error") around the
#: chunk call, the one read after it
SEARCH_SYNC_CHUNKS = 8


def search_dcop(K, R, D, seed):
    """``R`` cliques of ``K`` variables at domain ``D`` with integer
    costs in [0, 10) (bench.py build_search_dcop), built with the port's
    DCOP objects: induced width K - 1."""
    from pydcop_tpu_torch.dcop import (
        DCOP,
        AgentDef,
        Domain,
        NAryMatrixRelation,
        Variable,
    )

    rng = np.random.default_rng(seed)
    dcop = DCOP("search_bench", objective="min")
    dom = Domain("d", "vals", list(range(D)))
    k = 0
    for r in range(R):
        vs = [Variable(f"b{r}v{i:02d}", dom) for i in range(K)]
        for v in vs:
            dcop.add_variable(v)
        for i in range(K):
            for j in range(i + 1, K):
                m = rng.integers(0, 10, (D, D)).astype(float)
                dcop.add_constraint(
                    NAryMatrixRelation([vs[i], vs[j]], m, name=f"c{k}"))
                k += 1
    dcop.add_agents([AgentDef("a0")])
    return dcop


def seeded_search_dcop(shape, seed, n, D=3, objective="min"):
    """The seeded integer chain/hub/dense instances of
    ``tests/unit/test_search.py::make_dcop``, with the port's classes."""
    from pydcop_tpu_torch.dcop import (
        DCOP,
        AgentDef,
        Domain,
        NAryMatrixRelation,
        Variable,
    )

    edges = {"chain": [(i, i + 1) for i in range(n - 1)],
             "hub": [(0, i) for i in range(1, n)],
             "dense": [(i, j) for i in range(n) for j in range(i + 1, n)]}
    rng = np.random.default_rng(seed)
    dcop = DCOP(f"{shape}-{seed}", objective=objective)
    dom = Domain("d", "v", list(range(D)))
    vs = [Variable(f"v{i:02d}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for k, (i, j) in enumerate(edges[shape]):
        m = rng.integers(0, 97, (D, D)).astype(float)
        dcop.add_constraint(NAryMatrixRelation([vs[i], vs[j]], m,
                                               name=f"c{k}"))
    dcop.add_agents([AgentDef("a0")])
    return dcop


def search_host_phase(device="cuda"):
    """syncbb and ncbb's host loops for ``device`` against the same runs
    for device="cpu": the six test instances and the seeded
    chain/hub/dense instances, min and max; cost and assignment equal."""
    from pydcop_tpu_torch.algorithms import ncbb, syncbb
    from pydcop_tpu_torch.dcop import load_dcop_from_file

    inst = os.path.join(ROOT, "tests", "instances")
    cases = {fn[:-5]: (lambda fn=fn: load_dcop_from_file(
        [os.path.join(inst, fn)])) for fn in sorted(os.listdir(inst))}
    for shape in ("chain", "hub", "dense"):
        for seed in (1, 2, 3):
            for objective in ("min", "max"):
                cases[f"{shape}-{seed}-{objective}"] = (
                    lambda s=shape, e=seed, o=objective: seeded_search_dcop(
                        s, e, 7 if s == "dense" else 9, objective=o))
    runs = 0
    for name, build in cases.items():
        for mod in (syncbb, ncbb):
            algo = mod.__name__.rsplit(".", 1)[1]
            card = mod.build_solver(build(), device=device).run()
            cpu = mod.build_solver(build(), device="cpu").run()
            if (card.cost, card.assignment, card.msg_count) != (
                    cpu.cost, cpu.assignment, cpu.msg_count):
                fail("search_host", f"{algo} on {name}: card cost "
                     f"{card.cost} != CPU {cpu.cost} (same assignment: "
                     f"{card.assignment == cpu.assignment})")
            runs += 1
    say("search_host", instances=len(cases), algos=["syncbb", "ncbb"],
        runs=runs, equal_to_cpu=True)


def frontier_profile(eng, state, chunks=5):
    """Where a frontier chunk's time goes on the card: the host clock over
    ``chunks`` chunks (each ending in its one read), and from a
    torch.profiler trace of the same the device kernels a step launches
    and their device time, so the card's busy share is device time over
    wall time.  The annex count is cleared between chunks (the drain's
    bookkeeping, not its rows, which are not needed here)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def run(st):
        for _ in range(chunks):
            st, stats = eng.run_chunk(st)
            stats.cpu()
            st = {**st, "x_count": torch.zeros_like(st["x_count"])}
        return st

    state = run(state)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = run(state)
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(state)
        torch.cuda.synchronize()
    kernels = device_us = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us and getattr(e, "device_type", None) is not None \
                and "CUDA" in str(e.device_type):
            kernels += e.count
            device_us += us
    steps = chunks * eng.shape.steps
    return {"wall_ms_per_chunk": 1e3 * wall_s / chunks,
            "device_kernels_per_step": kernels / steps if kernels else None,
            "device_us_per_chunk": device_us / chunks if device_us
            else None,
            "device_busy_share": (device_us * 1e-6 / wall_s if device_us
                                  else None)}


def search_frontier_phase(smi, device="cuda"):
    """The frontier on the JAX bench's two anytime-search instances, on
    the card: it proves optimality, its cost equals the port's NCBB host
    loop, its per-chunk history equals the CPU frontier's over the CPU's
    first SEARCH_CPU_CHUNKS chunks (and its cost, assignment and chunks
    too where the CPU proves within them), the lower bound never exceeds
    the upper bound and the
    incumbent never rises; a chunk reads the device once (its first
    SEARCH_SYNC_CHUNKS chunks run with the sync debug mode at "error"
    around the chunk call).  Returns the card/CPU rows."""
    import torch

    from pydcop_tpu_torch.algorithms.ncbb import NcbbSolver
    from pydcop_tpu_torch.search.solver import FrontierSearchSolver

    out = {}
    for name, (K, R, D, seed, ib) in SEARCH_CASES.items():
        dcop = search_dcop(K, R, D, seed)
        kw = dict(frontier_width=SEARCH_WIDTH, steps=SEARCH_STEPS,
                  i_bound=ib)
        t0 = time.perf_counter()
        ncbb = NcbbSolver(dcop, device=device).run()
        ncbb_s = time.perf_counter() - t0
        cpu = FrontierSearchSolver(dcop, device="cpu", **kw).run(
            cycles=SEARCH_CPU_CHUNKS, collect_cycles=True)
        solver = FrontierSearchSolver(dcop, device=device, **kw)
        torch.cuda.synchronize()
        res = solver.run(collect_cycles=True)
        s, c = res.search, cpu.search
        if not s["optimal"] or res.cost != ncbb.cost:
            fail("search_frontier", f"{name}: optimal={s['optimal']} cost "
                 f"{res.cost} against NCBB's {ncbb.cost}")
        if c["optimal"] and (res.cost, res.assignment, res.cycle,
                             s["nodes"]) != (cpu.cost, cpu.assignment,
                                             cpu.cycle, c["nodes"]):
            fail("search_frontier", f"{name}: card cost {res.cost} in "
                 f"{res.cycle} chunks, {s['nodes']} nodes != CPU cost "
                 f"{cpu.cost} in {cpu.cycle} chunks, {c['nodes']} nodes "
                 f"(same assignment: {res.assignment == cpu.assignment})")
        keys = ("cycle", "cost", "lower_bound", "upper_bound", "gap")
        if [[h[k] for k in keys] for h in res.history[:len(cpu.history)]] \
                != [[h[k] for k in keys] for h in cpu.history]:
            fail("search_frontier", f"{name}: the card's per-chunk "
                 f"history differs from the CPU's")
        inc = [h["cost"] for h in res.history if h["cost"] is not None]
        if any(b > a for a, b in zip(inc, inc[1:])):
            fail("search_frontier", f"{name}: the incumbent rose")
        if any(h["lower_bound"] > h["upper_bound"] for h in res.history
               if h["lower_bound"] is not None):
            fail("search_frontier", f"{name}: lower bound above the upper")
        if s["scalar_reads"] != 2 * s["chunks"]:
            fail("search_frontier", f"{name}: {s['scalar_reads']} scalars "
                 f"read in {s['chunks']} chunks (one [2] read a chunk)")
        # one host read a chunk: the chunk itself never syncs
        eng = solver.engine
        state = eng.initial_state()
        torch.cuda.synchronize()
        n_sync = min(SEARCH_SYNC_CHUNKS, res.cycle)
        reads = 0
        for _ in range(n_sync):
            torch.cuda.set_sync_debug_mode("error")
            try:
                state, stats = eng.run_chunk(state)
            except RuntimeError as e:
                torch.cuda.set_sync_debug_mode(0)
                fail("search_frontier", f"{name}: a chunk synchronized "
                     f"with the host: {e}")
            torch.cuda.set_sync_debug_mode(0)
            stats.cpu()
            reads += 1
            state = {**state, "x_count": torch.zeros_like(
                state["x_count"])}
        prof = (frontier_profile(eng, state) if device == "cuda"
                and res.cycle > 1 else {})
        out[name] = {"card": res, "cpu": cpu}
        say("search_frontier", case=name, K=K, R=R, D=D, seed=seed,
            n_vars=s["n_vars"], i_bound=s["i_bound"],
            bound_source=s["bound_source"], frontier_width=s[
                "frontier_width"], steps_per_chunk=s["steps_per_chunk"],
            optimal=True, cost=res.cost, ncbb_cost=ncbb.cost,
            cpu_cost=cpu.cost, chunks=s["chunks"], nodes=s["nodes"],
            nodes_per_s=s["nodes_per_s"], cpu_nodes_per_s=c["nodes_per_s"],
            time_to_proof_s=res.time, cpu_chunks=cpu.cycle,
            cpu_optimal=bool(c["optimal"]), cpu_s=cpu.time,
            ms_per_chunk=1e3 * res.time / max(1, s["chunks"]),
            scalar_reads_per_chunk=s["scalar_reads"] / max(1, s["chunks"]),
            host_reads_per_chunk=1, sync_checked_chunks=n_sync,
            spill_drains=s["spill_drains"], ncbb_s=ncbb_s,
            torch_threads=torch.get_num_threads(), **prof, nvidia_smi=smi)
    return out


def search_dpop_frontier_phase(device="cuda"):
    """``solve -a dpop -p engine:frontier`` and ``solve --anytime-exact``
    through the CLI on the card, on k10x4 (written as YAML under
    chiprun_out/): both prove the sweep's optimum."""
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml

    K, R, D, seed, _ = SEARCH_CASES["k10x4"]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    path = os.path.join(ROOT, "chiprun_out", "search_k10x4.yaml")
    with open(path, "w", encoding="utf-8") as f:
        f.write(dcop_yaml(search_dcop(K, R, D, seed)))
    got = {}
    runs = (("sweep", ["-a", "dpop"]),
            ("dpop_frontier", ["-a", "dpop", "-p", "engine:frontier"]),
            ("anytime_exact", ["--anytime-exact"]))
    procs = run_all([[sys.executable, "-m", "pydcop_tpu_torch", "solve",
                      *argv, "--device", device, path]
                     for _tag, argv in runs], timeout=600)
    for (tag, _argv), (rc, stdout, stderr) in zip(runs, procs):
        try:
            got[tag] = json.loads(stdout)
        except ValueError:
            fail("search_dpop_frontier", f"{tag}: rc={rc} no JSON; "
                 f"stderr: {stderr[-2000:]}")
        if rc != 0 or got[tag].get("status") != "FINISHED":
            fail("search_dpop_frontier", f"{tag}: rc={rc} {got[tag]}")
    sweep = got["sweep"]["cost"]
    for tag in ("dpop_frontier", "anytime_exact"):
        r = got[tag]
        if r["cost"] != sweep or not r["search"]["optimal"] \
                or r["config"]["engine"] != "frontier":
            fail("search_dpop_frontier", f"{tag}: cost {r['cost']} against "
                 f"the sweep's {sweep}, search={r.get('search')}")
        say("search_dpop_frontier", case="k10x4", run=tag,
            algo=r["config"]["algo"], cost=r["cost"], sweep_cost=sweep,
            sweep_engine=got["sweep"]["config"]["engine"],
            optimal=True, chunks=r["search"]["chunks"],
            nodes=r["search"]["nodes"], time_s=r["time"])


def _swap_tables(dcop, n, seed):
    """``n`` seeded factors of ``dcop`` with new tables over the same
    scope, in its order: the bench colouring's style on a binary factor
    (uniform [0, 1) plus 10 on the diagonal), uniform [0, 1) on the
    others."""
    from pydcop_tpu_torch.dcop import NAryMatrixRelation

    rng = np.random.default_rng(seed)
    names = sorted(dcop.constraints)
    out = []
    for name in rng.choice(names, n, replace=False):
        dims = list(dcop.constraints[name].dimensions)
        shape = tuple(len(v.domain) for v in dims)
        m = rng.uniform(0, 1, shape).astype(np.float32).astype(float)
        if len(shape) == 2 and shape[0] == shape[1]:
            m += np.eye(shape[0]) * 10
        out.append(NAryMatrixRelation(dims, m, name=str(name)))
    return out


def maxsum_dynamic_run(build, device, swaps, cycles, use_packed=None,
                       check=None):
    """maxsum_dynamic on ``build()``: ``cycles`` cycles, the swaps, then
    ``cycles`` more from the same messages.  Returns (the solver, the
    second result, seconds of the swaps, launch counts of the two runs)."""
    import torch

    from pydcop_tpu_torch.algorithms import maxsum_dynamic

    dcop = build()
    solver = maxsum_dynamic.build_solver(dcop, device=device,
                                         use_packed=use_packed)
    reset_counts()
    solver.run(cycles=cycles)
    counts = read_counts()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in swaps:
        solver.change_factor_function(c)
    if device == "cuda":
        torch.cuda.synchronize()
    swap_s = time.perf_counter() - t0
    if check is not None:
        check(solver)
    reset_counts()
    res = solver.run(cycles=cycles, resume=True)
    counts = {k: v + counts[k] for k, v in read_counts().items()}
    return solver, res, swap_s, counts


def maxsum_dynamic_phase(smi, device="cuda"):
    """maxsum_dynamic on the 10k/30k colouring (K1 binary, swaps in
    place) and on SECP-3.9k (K1-mixed, re-packs): 100 cycles, 100 seeded
    swaps, 100 cycles; the swapped layout equal to a fresh pack, K1 on it
    equal to its plain version, 2 K1 launches (binary) or 200 (mixed) in
    the 200 cycles, values and cost equal to the CPU run of the same
    sequence.  Returns the binary run's K1 launches."""
    import torch

    from pydcop_tpu_torch.ops.compile import compile_factor_graph
    from pydcop_tpu_torch.ops.packed_maxsum import pack_for_gpu

    half, n_swaps = 100, 100
    k1_launches = None
    for name, build, key, want, use_packed in (
            ("coloring_10k_30k", lambda: coloring_dcop(10_000, 30_000),
             "packed_maxsum_cycle", 2, None),
            ("secp_3.9k", lambda: secp_dcop(1, 2), "packed_maxsum_mixed",
             2 * half, True)):
        swaps = _swap_tables(build(), n_swaps, seed=17)
        checked = {}

        def check(solver):
            pg = solver.packed
            if pg is None or (pg.mixed is None) != (key ==
                                                    "packed_maxsum_cycle"):
                fail("maxsum_dynamic", f"{name}: the solver's layout is "
                     f"not the expected one")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fresh = pack_for_gpu(compile_factor_graph(solver.dcop,
                                                      device=device))
            torch.cuda.synchronize()
            checked["compile_pack_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            pack_for_gpu(solver.tensors)
            torch.cuda.synchronize()
            checked["repack_s"] = time.perf_counter() - t0
            if pg.mixed is None:
                equal = torch.equal(pg.cost_rows, fresh.cost_rows)
            else:
                equal = all(torch.equal(a, b) for a, b in
                            zip(pg.mixed.costs, fresh.mixed.costs))
            if not equal:
                fail("maxsum_dynamic", f"{name}: the swapped layout's "
                     f"tables differ from a fresh pack of the changed DCOP")
            if pg.mixed is None and device == "cuda":
                # the first run built K1's tile table; the swaps kept it,
                # and it is still the changed graph's (degrees only)
                from pydcop_tpu_torch.ops.packed_maxsum import (
                    TILE_COLS,
                    tile_table,
                )

                kept = pg.tile_tables.get(TILE_COLS)
                if kept is None or not np.array_equal(
                        kept.cpu().numpy(), tile_table(fresh, TILE_COLS)):
                    fail("maxsum_dynamic", f"{name}: the swap dropped or "
                         f"broke K1's cached tile table")
                checked["tile_tables_kept"] = True
            try:
                err, _ = kernel_vs_plain(pg, 0.5, exact=True)
            except AssertionError as e:
                fail("maxsum_dynamic", f"{name}: K1 on the swapped layout "
                     f"against its plain version: {e}")
            checked["max_abs_err"] = err

        solver, res, swap_s, counts = maxsum_dynamic_run(
            build, device, swaps, half, use_packed=use_packed if
            device == "cpu" else None, check=check)
        expect = {k: 0 for k in counts}
        expect[key] = want if device == "cuda" else 0  # the CPU: plain
        if counts != expect:
            fail("maxsum_dynamic", f"{name}: launches {counts} in "
                 f"{2 * half} cycles, expected {expect}")
        _, cpu, cpu_swap_s, _ = maxsum_dynamic_run(
            build, "cpu", _swap_tables(build(), n_swaps, seed=17), half,
            use_packed=use_packed)
        if (res.cost, res.assignment) != (cpu.cost, cpu.assignment):
            fail("maxsum_dynamic", f"{name}: card cost {res.cost} != CPU "
                 f"cost {cpu.cost} (same assignment: "
                 f"{res.assignment == cpu.assignment})")
        if key == "packed_maxsum_cycle":
            k1_launches = counts[key]
        say("maxsum_dynamic", case=name, cycles=2 * half, swaps=n_swaps,
            launches=counts, layout="mixed" if use_packed else "binary",
            swap_how="re-pack" if use_packed else "in place (swap_factor)",
            cost=res.cost, cpu_cost=cpu.cost, equal_to_cpu=True,
            swap_ms_each=1e3 * swap_s / n_swaps,
            swap_ms_total=1e3 * swap_s,
            repack_ms=1e3 * checked["repack_s"],
            compile_pack_ms=1e3 * checked["compile_pack_s"],
            equal_to_fresh_pack=True,
            k1_max_abs_err_vs_plain=checked["max_abs_err"],
            **({"tile_tables_kept": checked["tile_tables_kept"]}
               if "tile_tables_kept" in checked else {}),
            nvidia_smi=smi)
    return k1_launches


#: the harness phase's collect runs: 200 cycles, through solve_result at
#: the collect default chunk, 7 (28 chunks and a tail of 4 live and 3
#: frozen cycles: 203 K2 launches, the frozen cycles' included), and
#: through solver.run at chunk 8 (25 chunks, so every K2 launch is a live
#: cycle's)
HARNESS_CYCLES = 200
HARNESS_CHUNK = 8
#: the captured engines of the harness phase: algorithm -> (instance
#: built in main, PERF.md §5's)
CAPTURED_ENGINES = {"dba": "coloring_csp_10k_30k",
                    "gdba": "coloring_csp_10k_30k",
                    "amaxsum": "coloring_10k_30k"}


def harness_solver(dcop, algo, device, use_packed=None, params=None):
    from pydcop_tpu_torch.algorithms import AlgorithmDef, \
        load_algorithm_module

    algo_def = AlgorithmDef.build_with_default_params(
        algo, params or {}, mode=dcop.objective)
    kw = {} if use_packed is None else {"use_packed": use_packed}
    return load_algorithm_module(algo).build_solver(
        dcop, None, algo_def, seed=0, device=device, **kw)


def k2_on(pls, xs):
    """K2 (``packed_local_tables``) against its plain version on the card
    at each [V] assignment of ``xs``, exactly, at the wrapper's grid and
    at the forced ones (COOP_GRIDS); returns the max abs error."""
    import torch

    from pydcop_tpu_torch.ops import packed_local_search as P

    err = 0.0

    def same(what, a, b):
        nonlocal err
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: kernel differs from plain in "
                                 f"{int((a != b).sum())} entries")
        err = max(err, float((a.double() - b.double()).abs().max()))

    for x in xs:
        want = P.packed_local_tables_plain(pls, x)
        for grid in COOP_GRIDS:
            blocks = None if grid == "wrapper" else grid
            same(f"packed_local_tables, grid={grid}",
                 P.packed_local_tables(pls, x, blocks=blocks), want)
    return err


def traced_launches(run, name, tries=3):
    """(launches of the kernels whose name contains ``name`` in
    torch.profiler's CUDA trace of ``run()``, the launch counters'
    increase over the same call, device µs a launch).  A trace whose
    count is not the counters' is taken again (the chip machine's traces
    have dropped a kernel's records now and then: 199 of 200 in three
    traces in a row once), up to ``tries`` traces; the last trace's
    numbers are returned either way."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        before = sum(read_counts().values())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        counted = sum(read_counts().values()) - before
        traced, total_us = 0, 0.0
        for e in prof.key_averages():
            if name in e.key and getattr(
                    e, "device_time_total",
                    getattr(e, "cuda_time_total", 0.0)):
                traced += e.count
                total_us += getattr(e, "device_time_total",
                                    getattr(e, "cuda_time_total", 0.0))
        if traced == counted:
            break
    return traced, counted, (total_us / traced if traced else None)


def dot_kernels(graph):
    """The function names of the kernel nodes of a kept CUDA graph, from
    its DOT dump: a kernel node's label opens with ``{KERNEL`` and the
    next line names its function."""
    import warnings

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "graph_kernels.dot")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # torch warns on every dump
        graph.debug_dump(path)
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    os.remove(path)
    return [lines[i + 1] for i, line in enumerate(lines[:-1])
            if 'label="{KERNEL' in line]


def captured_kernels(fn):
    """The kernel nodes of ``fn()`` captured alone in a CUDA graph (after
    one eager call), by :func:`dot_kernels`; the launch counters are left
    as they were."""
    import torch

    from pydcop_tpu_torch.ops import launch_counters

    fn()
    torch.cuda.synchronize()
    saved = {name: getattr(w, attr)
             for name, (w, attr) in launch_counters().items()}
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    # as ChunkRunner captures: no collection inside the capture
    gc_was = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            fn()
    finally:
        if gc_was:
            gc.enable()
        for name, (w, attr) in launch_counters().items():
            setattr(w, attr, saved[name])
    graph.instantiate()
    return dot_kernels(graph)


def graph_kernel_nodes(runner, name):
    """Kernel nodes of ``runner``'s captured CUDA graph whose function
    name contains ``name`` (:func:`dot_kernels`); the runner must have
    been captured with ``ChunkRunner.keep_graph``."""
    return sum(name in k for k in dot_kernels(runner.graph))


def harness_collect_phase(dcops):
    """The slice's path, ``solve -a mgm --run_metrics``, on the 10k/30k
    colouring (K2 binary) and SECP-3.9k (K2 mixed):

    * through ``solve_result(..., collect_cycles=True)`` at the collect
      default chunk (7: 28 chunks and a tail of 4 live and 3 frozen
      cycles), the counters zeroed just before: 203 K2 launches (the
      tail's frozen cycles launch too inside the replayed graph) and no
      other kernel's; the history equals the CPU run's, cycle by cycle;
    * on SECP-3.9k also through the CLI, ``python -m pydcop_tpu_torch
      solve -a mgm --cycles 200 --run_metrics --end_metrics`` in a
      subprocess on the card: JAX's header, 200 RUNNING lines whose
      costs are the entry point's history, the end line;
    * mgm and dsa through ``solver.run`` at chunk 8 with collect: 200 K2
      launches, == the CPU run (cost, values, every history cost), K2 ==
      its plain version on the runs' first and last assignments; the
      captured graph (kept) holds 8 ``ls_tables_kernel`` nodes, the
      launches its capture recorded for each replay to count; a run of
      replays only, traced by torch.profiler: its count of
      ``ls_tables_kernel`` launches equals the counters' increase, 200,
      or falls short by fewer records than the run has replays (a trace
      drops a record now and then; a node missing from the graph would
      miss one launch in every replay); its wall time and K2's device µs
      a launch; and the K2 step of a collect cycle (the solver's
      ``local_tables`` at x, as the captured chunk runs it) captured
      alone in a CUDA graph: ONE kernel node, ``ls_tables_kernel`` (no
      gather into column order, no gather or transpose back); its events
      ms a step; and the kernel nodes a cycle of the captured chunk (its
      DOT dump).

    Returns ({path: K2 launches}, max abs error, rows)."""
    import csv

    import torch

    from pydcop_tpu_torch.algorithms.capture import ChunkRunner
    from pydcop_tpu_torch.commands._utils import CSV_COLUMNS
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml
    from pydcop_tpu_torch.runtime.run import solve_result

    launches, err, rows = {}, 0.0, []
    for inst, cpu_packed in (("coloring_10k_30k", None),
                             ("secp_3.9k", True)):
        dcop = dcops[inst]
        mixed = inst.startswith("secp")
        key = "ls_tables_mixed" if mixed else "ls_tables"
        # the entry point, at the collect default chunk
        reset_counts()
        t0 = time.perf_counter()
        res = solve_result(dcop, "mgm", cycles=HARNESS_CYCLES,
                           collect_cycles=True, device="cuda")
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        counts = read_counts()
        h = res.harness
        want = {k: 0 for k in counts}
        want[key] = HARNESS_CYCLES + h["masked_tail_cycles"]
        if counts != want or res.config["chunk"] != 7 \
                or h["masked_tail_cycles"] != 3 \
                or counts[key] != 7 * h["chunks_dispatched"]:
            fail("harness", f"solve_result mgm on {inst} with collect: "
                 f"launches {counts}, expected {want}; harness {h}, chunk "
                 f"{res.config['chunk']}")
        cpu = harness_solver(dcop, "mgm", "cpu", use_packed=cpu_packed).run(
            cycles=HARNESS_CYCLES, collect_cycles=True)
        hist = [(e["cycle"], e["cost"]) for e in res.history]
        if hist != [(e["cycle"], e["cost"]) for e in cpu.history] \
                or len(hist) != HARNESS_CYCLES \
                or (res.assignment, res.cost) != (cpu.assignment, cpu.cost):
            fail("harness", f"solve_result mgm on {inst}: card cost "
                 f"{res.cost} != CPU {cpu.cost} or the histories differ")
        launches[f"mgm_solve_{inst}"] = counts[key]
        say("harness", entry="solve_result", algo="mgm", instance=inst,
            chunk=res.config["chunk"], engine=res.config.get("engine"),
            k2_launches=counts[key], harness=h, cost=res.cost,
            cpu_cost=cpu.cost, history_len=len(hist),
            solve_s=round(solve_s, 4))
        if mixed:
            # the CLI on the card, in a subprocess (8 s of YAML here)
            out_dir = os.path.join(ROOT, "chiprun_out")
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, "harness_secp.yaml")
            run_csv = os.path.join(out_dir, "harness_run_metrics.csv")
            end_csv = os.path.join(out_dir, "harness_end_metrics.csv")
            for f in (run_csv, end_csv):
                if os.path.exists(f):
                    os.remove(f)
            with open(path, "w", encoding="utf-8") as f:
                f.write(dcop_yaml(dcop))
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "pydcop_tpu_torch", "solve", "-a",
                 "mgm", "--cycles", str(HARNESS_CYCLES), "--run_metrics",
                 run_csv, "--end_metrics", end_csv, path],
                capture_output=True, text=True, timeout=600, cwd=ROOT)
            cli_s = time.perf_counter() - t0
            try:
                out = json.loads(proc.stdout)
                with open(run_csv, encoding="utf-8") as f:
                    run_rows = list(csv.reader(f))
                with open(end_csv, encoding="utf-8") as f:
                    end_rows = list(csv.reader(f))
            except (ValueError, OSError) as e:
                fail("harness", f"CLI solve --run_metrics: rc="
                     f"{proc.returncode} ({e}); stderr: "
                     f"{proc.stderr[-2000:]}")
            body = [dict(zip(CSV_COLUMNS, r)) for r in run_rows[1:]]
            end = dict(zip(CSV_COLUMNS, end_rows[-1]))
            if proc.returncode != 0 or out.get("status") != "FINISHED" \
                    or run_rows[0] != CSV_COLUMNS \
                    or end_rows[0] != CSV_COLUMNS or len(end_rows) != 2 \
                    or [(int(r["cycle"]), float(r["cost"]), r["status"])
                        for r in body] != [(c, v, "RUNNING")
                                           for c, v in hist] \
                    or out["assignment"] != res.assignment \
                    or (int(end["cycle"]), float(end["cost"]),
                        end["status"]) != (HARNESS_CYCLES, out["cost"],
                                           "FINISHED"):
                fail("harness", f"CLI solve -a mgm --run_metrics on {inst}: "
                     f"rc={proc.returncode}, {len(body)} RUNNING lines, end "
                     f"{end}, status {out.get('status')}, same assignment "
                     f"as solve_result: "
                     f"{out.get('assignment') == res.assignment}")
            say("harness", entry="cli solve --run_metrics --end_metrics",
                algo="mgm", instance=inst, running_lines=len(body),
                header=run_rows[0], end_line=end,
                history_equal_to_solve_result=True, cli_s=round(cli_s, 3))
        for algo in ("mgm", "dsa"):
            solver = harness_solver(dcop, algo, "cuda")
            assert (solver.packed.pg.mixed is not None) == mixed
            reset_counts()
            ChunkRunner.keep_graph = True
            try:
                t0 = time.perf_counter()
                res = solver.run(cycles=HARNESS_CYCLES, chunk=HARNESS_CHUNK,
                                 collect_cycles=True)
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
            finally:
                ChunkRunner.keep_graph = False
            counts = read_counts()
            runner = solver._runners[("masked", HARNESS_CHUNK, True)]
            nodes = graph_kernel_nodes(runner, "ls_tables_kernel")
            if not nodes == HARNESS_CHUNK or runner.recorded != {
                    key: HARNESS_CHUNK}:
                fail("harness", f"{algo} on {inst}: the captured chunk of "
                     f"{HARNESS_CHUNK} cycles holds {nodes} ls_tables_kernel "
                     f"nodes, its capture recorded {runner.recorded}")
            want = {k: 0 for k in counts}
            want[key] = HARNESS_CYCLES
            if counts != want:
                fail("harness", f"{algo} on {inst} with collect: launches "
                     f"{counts}, expected {want}")
            launches[f"{algo}_collect_{inst}"] = counts[key]
            cpu = harness_solver(dcop, algo, "cpu", use_packed=cpu_packed)
            ref = cpu.run(cycles=HARNESS_CYCLES, chunk=HARNESS_CHUNK,
                          collect_cycles=True)
            same = (res.assignment == ref.assignment and res.cost == ref.cost
                    and [h["cost"] for h in res.history]
                    == [h["cost"] for h in ref.history])
            if not same or len(res.history) != HARNESS_CYCLES:
                fail("harness", f"{algo} on {inst}: card cost {res.cost} "
                     f"!= CPU {ref.cost} or the histories differ "
                     f"(same assignment: {res.assignment == ref.assignment})")
            try:
                err = max(err, k2_on(solver.packed, [
                    solver.initial_state()[0],
                    solver.values_of(solver._last_state)]))
            except AssertionError as e:
                fail("harness", f"K2 on {inst} ({algo}'s assignments): {e}")
            no_collect = solver.run(cycles=HARNESS_CYCLES,
                                    chunk=HARNESS_CHUNK)
            if no_collect.assignment != res.assignment:
                fail("harness", f"{algo} on {inst}: the run without collect "
                     f"(K4/K5) differs from the collect run (K2)")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = solver.run(cycles=HARNESS_CYCLES, chunk=HARNESS_CHUNK,
                               collect_cycles=True)
            torch.cuda.synchronize()
            replay_s = time.perf_counter() - t0
            if again.assignment != res.assignment \
                    or again.harness["donated_chunks"] \
                    != HARNESS_CYCLES // HARNESS_CHUNK:
                fail("harness", f"{algo} on {inst}: a second collect run "
                     f"differs from the first, or not every chunk was a "
                     f"replay: {again.harness}")
            # the replays' K2 launches, counted by the trace
            traced, counted, k2_us = traced_launches(
                lambda: solver.run(cycles=HARNESS_CYCLES,
                                   chunk=HARNESS_CHUNK, collect_cycles=True),
                "ls_tables_kernel")
            replays = HARNESS_CYCLES // HARNESS_CHUNK
            if counted != HARNESS_CYCLES \
                    or not counted - replays < traced <= counted:
                fail("harness", f"{algo} on {inst}: {traced} ls_tables_kernel "
                     f"launches in the trace of an all-replay collect run "
                     f"({replays} replays), {counted} counted, "
                     f"{HARNESS_CYCLES} expected")
            t0 = time.perf_counter()
            solver.run(cycles=HARNESS_CYCLES, chunk=HARNESS_CHUNK)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            x0 = solver.initial_state()[0]
            step_nodes = captured_kernels(lambda: solver.local_tables(x0))
            if len(step_nodes) != 1 or \
                    "ls_tables_kernel" not in step_nodes[0]:
                fail("harness", f"{algo} on {inst}: the K2 step of a "
                     f"collect cycle, captured alone, holds "
                     f"{len(step_nodes)} kernel nodes ({step_nodes}), "
                     f"expected one ls_tables_kernel")
            step_k2_ms = cuda_ms(lambda: solver.local_tables(x0), 200)
            state = solver.initial_state()
            coins = solver.draw_chunk_coins(HARNESS_CHUNK)
            runner(state, coins, HARNESS_CHUNK)  # warm
            step_ms = cuda_ms(lambda: runner(state, coins, HARNESS_CHUNK),
                              20) / HARNESS_CHUNK
            row = dict(algo=algo, instance=inst, cycles=HARNESS_CYCLES,
                       chunk=HARNESS_CHUNK, launches=counts, cost=res.cost,
                       cpu_cost=ref.cost, harness=res.harness,
                       trace_count=solver.trace_count(),
                       k2_nodes_of_captured_chunk=nodes,
                       traced_k2_launches_of_replayed_run=traced,
                       counted_k2_launches_of_replayed_run=counted,
                       first_run_s=round(first_s, 4),
                       collect_run_s=round(replay_s, 4),
                       no_collect_run_s=round(plain_s, 4),
                       collect_cycles_per_s=HARNESS_CYCLES / replay_s,
                       no_collect_cycles_per_s=HARNESS_CYCLES / plain_s,
                       captured_ms_per_cycle=step_ms,
                       k2_device_us_per_launch=k2_us,
                       k2_step_graph_kernel_nodes=len(step_nodes),
                       k2_step_ms=step_k2_ms,
                       captured_chunk_kernel_nodes_per_cycle=len(
                           dot_kernels(runner.graph)) / HARNESS_CHUNK)
            rows.append(row)
            say("harness", **row)
    return launches, err, rows


def harness_captured_phase(instances, cpu_results, smi):
    """dba, gdba and amaxsum, 200 cycles on PERF.md §5's instances through
    the fixed-shape runner, three runs of one solver: the first two eager
    chunks of 100 (a one-shot solve captures nothing), the second run
    captures at its first chunk and replays, the third is all replays;
    every chunk but the runner's first (its warm-up) under
    ``torch.cuda.set_sync_debug_mode("error")``: no kernel of the port
    launched, results == the CPU run's; each run's wall time, the
    cycles/s of the replays (host clock around two chunk calls ending in
    a synchronize) beside the eager ``run_cycles`` of the same solver,
    and trace_count.  Then an open-ended generic maxsum with
    ``pipeline=True`` against the same run without it.  Returns the
    rows."""
    import torch

    rows = []
    for algo, inst in CAPTURED_ENGINES.items():
        solver = harness_solver(instances[inst], algo, "cuda")
        solver.check_chunk_syncs = True
        reset_counts()
        runs, walls = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            runs.append(solver.run(cycles=HARNESS_CYCLES))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if len(runs) == 1 and solver.trace_count() != 0:
                fail("harness", f"{algo}: a one-shot 200-cycle solve "
                     f"captured {solver.trace_count()} graphs")
        counts = read_counts()
        if any(counts.values()):
            fail("harness", f"{algo}: launches {counts}: the generic engine "
                 f"launches no kernel of the port")
        cpu = cpu_results[algo]
        for r in runs:
            if (r.assignment, r.cost, r.cycle) != (cpu.assignment, cpu.cost,
                                                   cpu.cycle):
                fail("harness", f"{algo} on {inst}: card cost {r.cost} at "
                     f"cycle {r.cycle} != CPU {cpu.cost} at {cpu.cycle}")
        donated = [r.harness["donated_chunks"] for r in runs]
        if solver.trace_count() != 1 or donated != [0, 2, 2]:
            fail("harness", f"{algo}: trace_count {solver.trace_count()}, "
                 f"replays a run {donated} (expected [0, 2, 2])")
        res = runs[0]
        chunk = res.config["chunk"]
        runner = solver._runners[("masked", chunk, False)]
        solver._restart_streams(False)
        state = solver.initial_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HARNESS_CYCLES // chunk):
            state, _, _ = runner(state, solver.draw_chunk_coins(chunk),
                                 chunk)
        torch.cuda.synchronize()
        captured = HARNESS_CYCLES / (time.perf_counter() - t0)
        solver._restart_streams(False)
        state = solver.initial_state()
        solver.run_cycles(state, 5)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.run_cycles(state, HARNESS_CYCLES)
        torch.cuda.synchronize()
        eager = HARNESS_CYCLES / (time.perf_counter() - t0)
        row = dict(algo=algo, instance=inst, cycles=HARNESS_CYCLES,
                   cost=res.cost, cpu_cost=cpu.cost,
                   trace_count=solver.trace_count(),
                   replays_a_run=donated,
                   sync_checked_chunks=1 + sum(donated),
                   first_run_s=round(walls[0], 4),
                   second_run_s=round(walls[1], 4),
                   third_run_s=round(walls[2], 4),
                   one_shot_run_cycles_per_s=HARNESS_CYCLES / walls[0],
                   run_cycles_per_s=HARNESS_CYCLES / walls[2],
                   captured_cycles_per_s=captured,
                   eager_cycles_per_s=eager, nvidia_smi=smi)
        rows.append(row)
        say("harness", **row)
    for inst in ("coloring_10k_30k", "secp_3.9k"):
        runs, wall = {}, {}
        for pipeline in (False, True):
            solver = harness_solver(instances[inst], "maxsum", "cuda",
                                    use_packed=False)
            solver.check_chunk_syncs = True
            t0 = time.perf_counter()
            runs[pipeline] = solver.run(pipeline=pipeline)
            torch.cuda.synchronize()
            wall[pipeline] = time.perf_counter() - t0
        ref, res = runs[False], runs[True]
        over = res.harness["overshoot_cycles"]
        if res.assignment != ref.assignment \
                or not ref.cycle <= res.cycle <= ref.cycle + 7 \
                or over != res.cycle - ref.cycle:
            fail("harness", f"pipelined maxsum on {inst}: cycle {res.cycle} "
                 f"(without {ref.cycle}), overshoot {over}, same "
                 f"assignment {res.assignment == ref.assignment}")
        row = dict(algo="maxsum", engine="generic", instance=inst,
                   pipeline=True, cycle=res.cycle, cycle_without=ref.cycle,
                   overshoot_cycles=over, cost=res.cost,
                   run_s=round(wall[True], 4),
                   run_s_without=round(wall[False], 4),
                   host_sync_count=res.harness["host_sync_count"],
                   chunks=res.harness["chunks_dispatched"])
        rows.append(row)
        say("harness", **row)
    return rows


# ---------------------------------------------------------------------------
# batched solving: the batch engine and K10's instance axis
# ---------------------------------------------------------------------------

#: the batch phase's instances, the JAX bench leg's (bench.py bench_batch):
#: 500-variable / 1,500-edge 3-colour soft colourings, mgm, 50 cycles
BATCH_V, BATCH_E, BATCH_CYCLES = 500, 1500, 50
#: bucket sizes timed (B = 1,000: 500k variables and 1.5M edges)
BATCH_SIZES = (1, 8, 32, 1000)
#: distinct problems of the sweep: B = 1,000 solves each at 25 seeds (a
#: set's ``iterations``), the smaller buckets distinct problems
BATCH_PROBLEMS = 40
#: solves of one sweep a size: the first eager (the runner's warm-up),
#: the second captures and replays, the third replays
BATCH_TURNS = 3
#: the bucket each batched algorithm is held to its sequential solves at,
#: with fixed cycles and to convergence (at most this many cycles); 32
#: before the fleets' phases were added
BATCH_EQ_B, BATCH_EQ_MAX_CYCLES = 16, 300
BATCH_ALGOS = ("maxsum", "mgm", "dsa", "adsa", "gdba")


def batch_items(dcops, algo, B):
    """B items of ``algo``: problem ``i % len(dcops)``, seed ``i``."""
    from pydcop_tpu_torch.batch import BatchItem

    return [BatchItem(dcops[i % len(dcops)], algo, seed=i,
                      label=f"gc{i % len(dcops)}s{i}") for i in range(B)]


def batch_equal_sequential(dcops, device="cuda"):
    """Each of the five batched algorithms on a bucket of BATCH_EQ_B
    colourings on the card, with BATCH_CYCLES cycles and to convergence
    (at most BATCH_EQ_MAX_CYCLES): every lane equal to its sequential
    solve on the card (assignment, cost, stop cycle; maxsum's generic
    engine, ``use_packed=False``, the engine the bucket runs; the others'
    default engines), and no kernel of the port launched by the bucket.
    Returns the rows to print."""
    from pydcop_tpu_torch.algorithms import load_algorithm_module
    from pydcop_tpu_torch.batch import BatchEngine, CompileCache

    rows = []
    for algo in BATCH_ALGOS:
        items = batch_items(dcops, algo, BATCH_EQ_B)
        engine = BatchEngine(cache=CompileCache(), device=device)
        for mode, kw in (("fixed", {"cycles": BATCH_CYCLES}),
                         ("converge", {"max_cycles": BATCH_EQ_MAX_CYCLES})):
            reset_counts()
            t0 = time.perf_counter()
            got = engine.solve(items, **kw)
            batch_s = time.perf_counter() - t0
            counts = read_counts()
            if any(counts.values()):
                fail("batch", f"{algo} {mode}: the bucket launched "
                     f"{ {k: v for k, v in counts.items() if v} }; its "
                     f"generic cycle launches no kernel of the port")
            t0 = time.perf_counter()
            bad = []
            for item, g in zip(items, got):
                extra = {"use_packed": False} if algo == "maxsum" else {}
                solver = load_algorithm_module(algo).build_solver(
                    item.dcop, None, item.algo_def(), seed=item.seed,
                    device=device, **extra)
                w = solver.run(**kw)
                if (g.assignment, g.cost, g.cycle, g.status) != \
                        (w.assignment, w.cost, w.cycle, w.status):
                    bad.append((item.label, g.cost, w.cost, g.cycle,
                                w.cycle))
            seq_s = time.perf_counter() - t0
            if bad:
                fail("batch", f"{algo} {mode}: {len(bad)} of "
                     f"{len(items)} lanes differ from their sequential "
                     f"solves on the card (label, batch cost, sequential "
                     f"cost, cycles): {bad[:4]}")
            rows.append(dict(
                algo=algo, mode=mode, B=len(items), equal=True,
                buckets=engine.counters.counts["buckets_formed"],
                cycles=sorted({g.cycle for g in got}),
                converged=engine.counters.counts["instances_converged"],
                batch_s=round(batch_s, 3), sequential_s=round(seq_s, 3),
                runners=engine.metrics()["runners"]))
    return rows


def batch_rates(dcops, smi, device="cuda"):
    """mgm, BATCH_CYCLES cycles, at each of BATCH_SIZES: BATCH_TURNS
    solves of one sweep by a fresh engine (eager, then captured and
    replayed), each solve's wall time and its parts (the instances'
    compile and solvers, the bucket's load, the chunk loop from the
    runner calls to the values on the host, the scoring), instances/s by
    the wall and by the loop, the runner calls it made and the engine's
    counters; every turn's results equal the
    first's, 50 cycles, FINISHED."""
    from pydcop_tpu_torch.batch import BatchEngine, CompileCache

    out = {}
    for B in BATCH_SIZES:
        items = batch_items(dcops, "mgm", B)
        engine = BatchEngine(cache=CompileCache(), device=device)
        turns, first = [], None
        for turn in range(BATCH_TURNS):
            before = {**engine.runner_calls, **engine.seconds}
            t0 = time.perf_counter()
            res = engine.solve(items, cycles=BATCH_CYCLES)
            wall = time.perf_counter() - t0
            calls = {k: v - before[k] for k, v in
                     {**engine.runner_calls, **engine.seconds}.items()}
            if any(r.status != "FINISHED" or r.cycle != BATCH_CYCLES
                   or not math.isfinite(r.cost) for r in res):
                fail("batch", f"B={B} turn {turn}: a lane did not finish "
                     f"{BATCH_CYCLES} cycles with a finite cost")
            got = [(r.assignment, r.cost) for r in res]
            if first is None:
                first = got
            elif got != first:
                fail("batch", f"B={B} turn {turn}: results differ from "
                     f"the first turn's")
            kind = ("replay" if calls["replays"] and not calls["captures"]
                    else "capture+replay" if calls["captures"]
                    else "eager")
            turns.append(dict(
                turn=turn, runner=kind, wall_s=wall,
                **{k: calls[k] for k in engine.seconds},
                instances_per_s=B / wall,
                loop_instances_per_s=B / calls["loop_s"]))
        m = engine.metrics()
        out[B] = dict(turns=turns, counters={
            k: m[k] for k in ("buckets_formed", "compile_hits",
                              "compile_misses", "padding_waste",
                              "fallback_sequential")},
            cache=m["cache"], runners=m["runners"], seconds=m["seconds"],
            mean_cost=float(np.mean([c for _, c in first])))
        say("batch", kind="rate", algo="mgm", B=B, V=BATCH_V, E=BATCH_E,
            cycles=BATCH_CYCLES, variables=B * BATCH_V,
            edges=B * BATCH_E, problems=min(B, BATCH_PROBLEMS), **out[B],
            nvidia_smi=smi)
    return out


def batch_phase(smi, device="cuda"):
    """The batched engine on the card: its buckets equal the sequential
    solves, then its rates (see :func:`batch_equal_sequential` and
    :func:`batch_rates`)."""
    t0 = time.perf_counter()
    dcops = [coloring_dcop(BATCH_V, BATCH_E, seed=100 + i)
             for i in range(BATCH_PROBLEMS)]
    build_s = time.perf_counter() - t0
    for row in batch_equal_sequential(dcops, device):
        say("batch", kind="equal_sequential", **row)
    rates = batch_rates(dcops, smi, device)
    say("batch", kind="done", build_dcops_s=round(build_s, 3),
        phase_s=round(time.perf_counter() - t0, 3))
    return rates


#: the JAX bench's serve leg (bench.py bench_serve at its defaults): 24
#: jobs, 3-colour soft colourings of 120 and 60 variables with 3x edges,
#: seeds 300 + i, Poisson arrivals at 20 jobs/s from seed 11, 8 lanes,
#: run to convergence, at most 200 cycles
SERVE_JOBS, SERVE_VARS, SERVE_RATE, SERVE_SEED = 24, 120, 20.0, 11
SERVE_LANES, SERVE_MAX_CYCLES = 8, 200
SERVE_ALGOS = ("mgm", "dsa", "maxsum")
#: the service at a size users run: the JAX bench's bench_batch family
#: (500 variables, 1,500 edges) with a 250 / 750 half size that folds
#: into the larger buckets; SERVE_BIG_PROBLEMS problems, job i problem
#: i % SERVE_BIG_PROBLEMS at seed i; mgm, 64 lanes, one burst and one
#: Poisson stream at 25 jobs/s; SERVE_SAMPLE jobs checked
SERVE_BIG_V, SERVE_BIG_JOBS, SERVE_BIG_PROBLEMS = 500, 512, 64
SERVE_BIG_LANES, SERVE_BIG_RATE, SERVE_SAMPLE = 64, 25.0, 32
#: the jobs of the burst traced by torch.profiler for the busy share
SERVE_PROFILE_JOBS = 64
#: seconds into the script after which the big runs take half the jobs
SERVE_CUT_AFTER_S = 300.0
#: the sequential fallback's instances (K6 and K10 through the service)
SERVE_MGM2_V, SERVE_DPOP_NODES = 2_000, 3_000
#: when the script started (the serve phase cuts its job count near the
#: time limit)
SCRIPT_T0 = time.perf_counter()


def serve_family(n, V, seed0=300):
    """The JAX bench serve leg's instances: job i a colouring of V (even
    i) or V // 2 (odd i) variables with three edges a variable, seed
    ``seed0 + i``."""
    return [coloring_dcop(v, 3 * v, seed=seed0 + i)
            for i, v in enumerate(V if i % 2 == 0 else V // 2
                                  for i in range(n))]


def poisson_offsets(n, rate, seed):
    """The JAX serve command's seeded arrival offsets (seconds)."""
    rng = np.random.default_rng(seed)
    inter = rng.exponential(1.0 / rate, n)
    inter[0] = 0.0
    return [float(x) for x in np.cumsum(inter)]


def serve_sequential(dcop, algo, seed, max_cycles, device="cuda",
                     params=None):
    """A job's sequential solve: maxsum's generic engine
    (``use_packed=False``, the engine the buckets run), the others'
    default engines (mgm's K4, dsa's K5 on the card)."""
    from pydcop_tpu_torch.algorithms import load_algorithm_module
    from pydcop_tpu_torch.batch import BatchItem

    extra = {"use_packed": False} if algo == "maxsum" else {}
    solver = load_algorithm_module(algo).build_solver(
        dcop, None, BatchItem(dcop, algo, algo_params=params).algo_def(),
        seed=seed, device=device, **extra)
    return solver.run(max_cycles=max_cycles)


def serve_run(jobs, algo, lanes, max_cycles, offsets, prewarm=(),
              device="cuda", trace=False, **kw):
    """Serve ``jobs`` (job i: ``(dcop, seed)``) through a started
    SolveService, job i submitted at ``offsets[i]`` seconds, after a
    blocking prewarm for the dcops ``prewarm``; every result awaited.
    With ``trace`` the jobs run under torch.profiler (CUDA activity):
    the device's busy share is its kernels' device time over the wall.
    Returns the results and the run's numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pydcop_tpu_torch.batch import CompileCache
    from pydcop_tpu_torch.serve import SolveService

    svc = SolveService(lanes=lanes, cache=CompileCache(),
                       max_cycles=max_cycles, device=device, **kw)
    prof = None
    try:
        svc.start()
        t0 = time.perf_counter()
        if prewarm:
            svc.prewarm([(d, algo) for d in prewarm], block=True)
        prewarm_s = time.perf_counter() - t0
        warm = svc.metrics()["runners"]
        if trace:
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        sub = []
        for i, (d, seed) in enumerate(jobs):
            wait = offsets[i] - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(wait)
            sub.append((svc.submit(d, algo, seed=seed),
                        time.perf_counter() - t0))
        results = [svc.result(jid, timeout=900) for jid, _ in sub]
        wall = max(s + r.time for (_, s), r in zip(sub, results))
        if prof is not None:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
        metrics = svc.metrics()
    finally:
        svc.stop(drain=False)
    busy = None
    if prof is not None:
        device_us = 0.0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if us and "CUDA" in str(getattr(e, "device_type", "")):
                device_us += us
        busy = device_us * 1e-6 / wall if device_us else None
    lat = np.array([r.time for r in results])
    sched = np.array([s + r.time - o for (_, s), r, o in
                      zip(sub, results, offsets)])
    counters = metrics["serve"]
    return results, dict(
        jobs=len(jobs), wall_s=wall, jobs_per_s=len(jobs) / wall,
        p50_ms=float(np.percentile(lat, 50)) * 1e3,
        p99_ms=float(np.percentile(lat, 99)) * 1e3,
        sched_p50_ms=float(np.percentile(sched, 50)) * 1e3,
        sched_p99_ms=float(np.percentile(sched, 99)) * 1e3,
        prewarm_s=prewarm_s, runners=metrics["runners"],
        runners_after_prewarm=warm, cache=metrics["cache"],
        device_busy_share=busy,
        counters={k: counters[k] for k in (
            "jobs_admitted", "midflight_admissions", "lanes_reused",
            "buckets_opened", "buckets_merged", "buckets_closed",
            "prewarmed_runners", "jobs_fallback", "lanes_nan",
            "jobs_quarantined", "buckets_failed", "jobs_resumed")},
        statuses=sorted({r.status for r in results}),
        cycles=[int(np.min([r.cycle for r in results])),
                int(np.max([r.cycle for r in results]))],
        **({"memo": metrics["memo"]} if "memo" in metrics else {}))


def serve_check(phase, results, jobs, algo, max_cycles, which=None,
                device="cuda"):
    """Each checked job's (assignment, cost, cycle, status) equal to its
    sequential solve on the card; ``which`` picks the job indices (all
    by default).  Returns the seconds the sequential solves took."""
    t0 = time.perf_counter()
    bad = []
    for i in (range(len(jobs)) if which is None else which):
        d, seed = jobs[i]
        r = results[i]
        w = serve_sequential(d, algo, seed, max_cycles, device)
        if (r.assignment, r.cost, r.cycle, r.status) != \
                (w.assignment, w.cost, w.cycle, w.status):
            bad.append((i, r.cost, w.cost, r.cycle, w.cycle, r.status))
    if bad:
        fail("serve", f"{phase} {algo}: {len(bad)} served jobs differ "
             f"from their sequential solves on the card (job, served cost, "
             f"sequential cost, cycles, status): {bad[:4]}")
    return time.perf_counter() - t0


def serve_parity(smi, device="cuda"):
    """The JAX bench's serve leg on the card for mgm, dsa and maxsum:
    Poisson arrivals into 8-lane buckets, every job equal to its
    sequential solve on the card, no kernel of the port launched by the
    buckets."""
    dcops = serve_family(SERVE_JOBS, SERVE_VARS)
    jobs = [(d, i) for i, d in enumerate(dcops)]
    offsets = poisson_offsets(SERVE_JOBS, SERVE_RATE, SERVE_SEED)
    for algo in SERVE_ALGOS:
        reset_counts()
        results, row = serve_run(jobs, algo, SERVE_LANES, SERVE_MAX_CYCLES,
                                 offsets, prewarm=dcops, device=device)
        counts = read_counts()
        if any(counts.values()):
            fail("serve", f"parity {algo}: the buckets launched "
                 f"{ {k: v for k, v in counts.items() if v} }; the "
                 f"generic cycles launch no kernel of the port")
        seq_s = serve_check("parity", results, jobs, algo,
                            SERVE_MAX_CYCLES, device=device)
        say("serve", kind="parity", algo=algo, vars=[SERVE_VARS,
            SERVE_VARS // 2], rate=SERVE_RATE, arrival_seed=SERVE_SEED,
            lanes=SERVE_LANES, equal=True, launches=0,
            sequential_s=seq_s, **row, nvidia_smi=smi)


def serve_at_size(smi, device="cuda"):
    """mgm on the bench_batch family at 64 lanes: a burst and a seeded
    Poisson stream (SERVE_BIG_JOBS jobs each, halved when the script is
    past SERVE_CUT_AFTER_S), a sample of SERVE_SAMPLE jobs each equal to
    its sequential solve; then a burst of SERVE_PROFILE_JOBS traced by
    torch.profiler for the device's busy share."""
    n = SERVE_BIG_JOBS
    elapsed = time.perf_counter() - SCRIPT_T0
    cut = elapsed > SERVE_CUT_AFTER_S
    if cut:
        n //= 2
    t0 = time.perf_counter()
    problems = serve_family(SERVE_BIG_PROBLEMS, SERVE_BIG_V, seed0=500)
    build_s = time.perf_counter() - t0
    jobs = [(problems[i % SERVE_BIG_PROBLEMS], i) for i in range(n)]
    sample = list(range(0, n, max(1, n // SERVE_SAMPLE)))[:SERVE_SAMPLE]
    out = {}
    for mode, offsets in (
            ("burst", [0.0] * n),
            ("poisson", poisson_offsets(n, SERVE_BIG_RATE, SERVE_SEED))):
        reset_counts()
        results, row = serve_run(jobs, "mgm", SERVE_BIG_LANES,
                                 SERVE_MAX_CYCLES, offsets,
                                 prewarm=problems[:8], device=device)
        counts = read_counts()
        if any(counts.values()):
            fail("serve", f"{mode}: the buckets launched kernels "
                 f"{ {k: v for k, v in counts.items() if v} }")
        seq_s = serve_check(mode, results, jobs, "mgm", SERVE_MAX_CYCLES,
                            sample, device)
        out[mode] = row
        say("serve", kind="at_size", mode=mode, algo="mgm",
            vars=[SERVE_BIG_V, SERVE_BIG_V // 2], problems=SERVE_BIG_PROBLEMS,
            lanes=SERVE_BIG_LANES,
            rate=SERVE_BIG_RATE if mode == "poisson" else None,
            arrival_seed=SERVE_SEED if mode == "poisson" else None,
            jobs_cut_from=SERVE_BIG_JOBS if cut else None,
            script_s_at_start=round(elapsed, 1), build_dcops_s=build_s,
            checked=len(sample), equal=True, sequential_s=seq_s, **row,
            nvidia_smi=smi)
    m = min(SERVE_PROFILE_JOBS, n)
    _, row = serve_run(jobs[:m], "mgm", SERVE_BIG_LANES, SERVE_MAX_CYCLES,
                       [0.0] * m, prewarm=problems[:8], device=device,
                       trace=device == "cuda")
    say("serve", kind="busy_share", mode="burst", algo="mgm", lanes=
        SERVE_BIG_LANES, **row, nvidia_smi=smi)
    return out


def serve_fallback(smi, device="cuda"):
    """One mgm2 job (a 2,000-variable colouring) and one dpop job (a
    3,000-node tree) through the service on the card: its sequential
    fallback launches K6 and K10, and each result equals
    ``solve_result(..., device="cuda")``."""
    from pydcop_tpu_torch.runtime import solve_result

    mgm2 = coloring_dcop(SERVE_MGM2_V, 3 * SERVE_MGM2_V, seed=21)
    tree = tree_dcop(SERVE_DPOP_NODES, seed=6)
    for algo, dcop, counter in (("mgm2", mgm2, "mgm2"),
                                ("dpop", tree, "dpop_whole_sweep")):
        reset_counts()
        results, row = serve_run([(dcop, 3)], algo, 2, SERVE_MAX_CYCLES,
                                 [0.0], device=device)
        counts = read_counts()
        if device == "cuda" and not counts[counter]:
            fail("serve", f"fallback {algo}: {counter} launched no time "
                 f"({counts})")
        want = solve_result(dcop, algo, seed=3, device=device)
        r = results[0]
        if (r.assignment, r.cost, r.cycle, r.status) != \
                (want.assignment, want.cost, want.cycle, want.status):
            fail("serve", f"fallback {algo}: served {r.cost} / {r.cycle} "
                 f"cycles, solve_result {want.cost} / {want.cycle}")
        say("serve", kind="fallback", algo=algo, launches=counts[counter],
            counter=counter, cost=r.cost, cycle=r.cycle, equal=True,
            jobs_fallback=row["counters"]["jobs_fallback"],
            latency_ms=row["p50_ms"], nvidia_smi=smi)


def serve_chaos(smi, device="cuda"):
    """A persistent ``nan_lane`` on one maxsum job and a persistent
    ``raise_in_step`` on one mgm job, on the card: the poisoned job ends
    ERROR, every healthy job equals its sequential solve, and the
    counters name the quarantine."""
    from pydcop_tpu_torch.runtime.faults import Fault, FaultPlan

    dcops = serve_family(8, SERVE_VARS)
    jobs = [(d, i) for i, d in enumerate(dcops)]
    for algo, kind, counter in (("maxsum", "nan_lane", "lanes_nan"),
                                ("mgm", "raise_in_step",
                                 "jobs_quarantined")):
        plan = FaultPlan(faults=[Fault(kind=kind, jid="job-000003",
                                       cycle=2)], seed=7)
        results, row = serve_run(jobs, algo, 4, SERVE_MAX_CYCLES,
                                 [0.0] * len(jobs), fault_plan=plan,
                                 backoff_base=0.0, device=device)
        if results[2].status != "ERROR":
            fail("serve", f"chaos {kind}: the poisoned job ended "
                 f"{results[2].status}, not ERROR")
        serve_check(f"chaos {kind}", results, jobs, algo, SERVE_MAX_CYCLES,
                    [i for i in range(len(jobs)) if i != 2], device)
        if not row["counters"][counter] or (
                kind == "raise_in_step" and not
                row["counters"]["buckets_failed"]):
            fail("serve", f"chaos {kind}: counters {row['counters']}")
        say("serve", kind="chaos", fault=kind, algo=algo, healthy_equal=True,
            poisoned="ERROR", counters=row["counters"], nvidia_smi=smi)


def serve_resume(smi, device="cuda"):
    """dsa jobs from YAML files through a journaled service on the card,
    ``halt()`` after three ticks (lane checkpoints at every boundary),
    then a new service ``resume()``s them: every job equals the
    uninterrupted run and its sequential solve."""
    import tempfile

    from pydcop_tpu_torch.batch import CompileCache
    from pydcop_tpu_torch.dcop import dcop_yaml, load_dcop_from_file
    from pydcop_tpu_torch.serve import SolveService

    work = tempfile.mkdtemp(prefix="serve_resume_")
    files = []
    for i, d in enumerate(serve_family(8, SERVE_VARS)):
        files.append(os.path.join(work, f"job{i}.yaml"))
        with open(files[-1], "w", encoding="utf-8") as f:
            f.write(dcop_yaml(d))
    dcops = [load_dcop_from_file(fn) for fn in files]

    def service(journal):
        return SolveService(lanes=4, cache=CompileCache(),
                            max_cycles=SERVE_MAX_CYCLES, device=device,
                            journal_dir=journal, checkpoint_every=1)

    def drain(svc):
        for _ in range(2000):
            if not svc.tick() and all(j.done.is_set()
                                      for j in svc._jobs.values()):
                return
        fail("serve", "resume: a service did not drain")

    plain = service(None)
    pj = [plain.submit(d, "dsa", seed=i) for i, d in enumerate(dcops)]
    drain(plain)
    want = [plain.result(j, timeout=60) for j in pj]
    journal = os.path.join(work, "journal")
    first = service(journal)
    jids = [first.submit(d, "dsa", seed=i, source_file=fn)
            for i, (d, fn) in enumerate(zip(dcops, files))]
    for _ in range(3):
        first.tick()
    done_before = sum(first._jobs[j].done.is_set() for j in jids)
    saved = first.counters.counts["checkpoints_saved"]
    first.halt()
    second = service(journal)
    n = second.resume()
    drain(second)
    got = [second.result(j, timeout=60) if second._jobs.get(j)
           else first.result(j, timeout=1) for j in jids]
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if (g.assignment, g.cost, g.cycle, g.status)
           != (w.assignment, w.cost, w.cycle, w.status)]
    if bad or n != len(jids) - done_before:
        fail("serve", f"resume: jobs {bad} differ from the uninterrupted "
             f"run; {n} resumed of {len(jids) - done_before} in flight")
    serve_check("resume", got, [(d, i) for i, d in enumerate(dcops)],
                "dsa", SERVE_MAX_CYCLES, device=device)
    say("serve", kind="resume", algo="dsa", jobs=len(jids), resumed=n,
        done_before_halt=done_before, checkpoints_saved=saved,
        jobs_resumed=second.counters.counts["jobs_resumed"], equal=True,
        nvidia_smi=smi)


def serve_phase(smi, device="cuda"):
    """The solve service on the card (see serve_parity, serve_at_size,
    serve_fallback, serve_chaos and serve_resume)."""
    t0 = time.perf_counter()
    serve_parity(smi, device)
    at_size = serve_at_size(smi, device)
    serve_fallback(smi, device)
    serve_chaos(smi, device)
    serve_resume(smi, device)
    say("serve", kind="done", phase_s=round(time.perf_counter() - t0, 3),
        script_s=round(time.perf_counter() - SCRIPT_T0, 1))
    return at_size


#: the batched sweep's instance count (the JAX bench's, bench.py:496-524)
DPOP_BATCH = 100
#: the batched branch of K10 (the ``design`` key of its kernels-line row)
DPOP_BATCHED_DESIGN = (
    "K10 with an instance axis: ONE cooperative launch for the B "
    "instances of one tree, each level a grid-stride loop over (instance, "
    "node tile) units before its one grid barrier, so the grid and the "
    "2L - 1 barriers do not grow with B; the tree shared, each instance's "
    "table, msg, cs and assign B strides apart")


def dpop_batched_bytes_ops(ps, nb):
    """Bytes and operations of nb sweeps of one tree in one call: each
    instance's table read once and its assign written once, the tree
    read once; nb times one sweep's operations."""
    nbytes, nops = dpop_bytes_ops(ps)
    N, D, L = ps.n_nodes, ps.D, ps.L
    tree = 4 * ((N + 1) + int(ps.child_idx.numel()) + N + (L + 1))
    one = nbytes - tree
    return tree + nb * one, nb * nops


def dpop_batched_phase(smi, trees, device="cuda"):
    """``make_batched_sweep_fn`` on the card at B = DPOP_BATCH on the
    bench trees (``trees``: name -> (dcop, packed sweep, plan)): the
    JAX bench's stacked tables (each instance the plan's plus its own
    uniform [0, 1e-3) offset), one K10 launch for the B instances, every
    other counter 0; the batched K10 ``torch.equal`` to its plain
    version at the wrapper's grid and at 1 and 3 blocks, the first and
    last instances equal to their single sweeps; events and device µs
    of the batched call and of one single sweep, tables/s of each.
    Returns {name: kernels-line numbers}."""
    import dataclasses

    import torch

    from pydcop_tpu_torch.ops.dpop_sweep import make_batched_sweep_fn
    from pydcop_tpu_torch.ops.packed_dpop import (
        pack_tables,
        whole_sweep,
        whole_sweep_batched,
        whole_sweep_plain,
    )

    out = {}
    B = DPOP_BATCH
    for name, (_, ps, plan) in trees.items():
        rng = np.random.default_rng(7)
        off = torch.as_tensor(rng.uniform(0, 1e-3, (B, 1, 1, 1)).astype(
            np.float32), device=device)
        local_b = plan.local[None] + off
        fn, args = make_batched_sweep_fn(plan, batch=B)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        assign = fn(local_b, *args)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        counts = read_counts()
        want = {k: 0 for k in counts}
        want.update(dpop_whole_sweep=1)
        if counts != want:
            fail("dpop_batched", f"{name}: launches {counts} in one "
                 f"batched call of {B}, expected {want}")
        tables = pack_tables(ps, local_b)
        del local_b
        plain = whole_sweep_plain(ps, tables)
        err = 0.0
        for blocks in COOP_GRIDS:
            k = whole_sweep_batched(ps, tables, **(
                {} if blocks == "wrapper" else {"blocks": blocks}))
            for what, a, b in zip(("assign", "msg", "cs"), k, plain):
                if not torch.equal(a, b):
                    fail("dpop_batched", f"{name}: batched K10 {what} "
                         f"differs from plain in {int((a != b).sum())} "
                         f"entries (grid {blocks})")
                err = max(err, float((a.double() - b.double()).abs().max()))
        if not torch.equal(assign, plain[0]):
            fail("dpop_batched", f"{name}: the batched function's assign "
                 f"differs from the plain version's")
        for b in (0, B - 1):
            one = dataclasses.replace(ps, table=tables[b].contiguous(),
                                      _plans=None)
            if not torch.equal(whole_sweep(one)[0], assign[b]):
                fail("dpop_batched", f"{name}: instance {b} differs from "
                     f"its single sweep")
        del plain
        reps = 20 if ps.n_nodes <= 10_000 else 5
        ms = cuda_ms(lambda: whole_sweep_batched(ps, tables), reps)
        single_ms = cuda_ms(lambda: whole_sweep(ps), 20)
        plain_ms = cuda_ms(lambda: whole_sweep_plain(ps, tables), 2)
        dev_single = profile_us(lambda: [whole_sweep(ps)
                                         for _ in range(20)], [DPOP_KERNEL])
        dev = profile_us(lambda: [whole_sweep_batched(ps, tables)
                                  for _ in range(reps)], [DPOP_KERNEL])
        nbytes, nops = dpop_batched_bytes_ops(ps, B)
        bound, by = bound_of(nbytes, nops)
        from pydcop_tpu_torch.ops import packed_dpop

        blocks = packed_dpop.sweep_blocks(
            ps, *packed_dpop._capacity(ps.D, ps.mode), B)
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by=by, max_abs_err=err,
                         launches=counts["dpop_whole_sweep"],
                         blocks=blocks, profiler_us=dev[DPOP_KERNEL])
        say("dpop_batched", case=name, B=B, n_nodes=ps.n_nodes, D=ps.D,
            L=ps.L, launches_per_call=1, blocks=blocks,
            first_call_s=round(call_s, 4), kernel_ms=ms,
            profiler_kernel_us=dev[DPOP_KERNEL], plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, bytes_per_call=nbytes,
            max_abs_err=err, tables_per_s=B * ps.n_nodes / (ms * 1e-3),
            single_sweep_ms=single_ms,
            single_profiler_us=dev_single[DPOP_KERNEL],
            single_tables_per_s=ps.n_nodes / (single_ms * 1e-3),
            table_gb=round(tables.numel() * 4 / 1e9, 3), nvidia_smi=smi)
        del tables
        torch.cuda.empty_cache()
    return out


#: the warm phase: the JAX churn leg's maxsum ring lattice (bench.py
#: bench_churn: every variable constrained to its two successors, D = 4,
#: tables uniform [0, 5) from default_rng(77), headroom 0.1, chunk 10,
#: damping 0.7, 60 base chunks, 50 seeded table edits each followed by
#: a 3-chunk window); the CPU run of the same stream checks the first
#: chunk and WARM_CPU_EDITS windows (a CPU window at this size, scoring
#: included, takes about two seconds); WARM_REPACK_ADDS factors added
#: to one variable of degree 4 (plan depth 8) run the stream past its
#: headroom
WARM_V, WARM_D, WARM_EDITS, WARM_CHUNK = 100_000, 4, 15, 10
WARM_BASE_CHUNKS, WARM_WINDOW, WARM_CPU_EDITS = 60, 3, 3
WARM_REPACK_ADDS = 5
#: the warm phase's mgm sub-leg (bench_churn's: 2,000 variables, 6,000
#: edges, seed 5, headroom 0.1, chunk 16, 50 edits of rng 99)
WARM_MGM_V, WARM_MGM_CHUNK = 2_000, 16


def ring_lattice(V=WARM_V, D=WARM_D, seed=77):
    """bench_churn's instance: edges (i, i+1) and (i, i+2) mod V, tables
    uniform [0, 5); returns the arrays and the generator, whose next
    draws are the edit stream's rows and tables."""
    rng = np.random.default_rng(seed)
    ei = np.concatenate([np.arange(V), np.arange(V)])
    ej = np.concatenate([(np.arange(V) + 1) % V, (np.arange(V) + 2) % V])
    mats = rng.uniform(0.0, 5.0, (ei.size, D, D)).astype(np.float32)
    return ei, ej, mats, rng


def ring_dcop(ei, ej, mats, V, D):
    """The lattice as the port's DCOP objects, named as
    ``compile_binary_from_arrays`` names its slots: the controller's
    edits and scoring read it, and a repack compiles it."""
    from pydcop_tpu_torch.dcop import (
        DCOP,
        Domain,
        NAryMatrixRelation,
        Variable,
    )

    dom = Domain("d", "d", list(range(D)))
    vs = [Variable(f"v{i:06d}", dom) for i in range(V)]
    d = DCOP("ring")
    for v in vs:
        d.add_variable(v)
    for k in range(ei.size):
        d.add_constraint(NAryMatrixRelation(
            [vs[ei[k]], vs[ej[k]]], mats[k], name=f"c{k:06d}"))
    return d


def warm_maxsum_leg(smi, device="cuda", V=WARM_V):
    """The maxsum warm stream on the ring lattice through the path a
    user runs: a ``WarmRepairController`` on the lattice's compiled
    arrays, ``solver.run`` to a converged base, then WARM_EDITS seeded
    table edits (``edit_factor``: in-place writes, the dirtied messages
    reset) each followed by ``run(resume=True)`` for a WARM_WINDOW-chunk
    window (its coin draw, end-of-run state and host scoring included).
    The captures must not change over the stream.  The first chunk and
    the first WARM_CPU_EDITS windows are held to a CPU controller:
    values equal, messages within TOL; the CPU windows start from the
    card's base state (a CPU base of 600 cycles at this size would take
    about half a minute).  Then WARM_REPACK_ADDS factors on one
    variable run the stream past its plan depth: exactly one repack at
    this size, the values carried by name, one more capture."""
    import torch

    from pydcop_tpu_torch.algorithms import AlgorithmDef
    from pydcop_tpu_torch.algorithms.base import synchronize
    from pydcop_tpu_torch.dcop import DCOP, NAryMatrixRelation
    from pydcop_tpu_torch.ops.compile import compile_binary_from_arrays
    from pydcop_tpu_torch.runtime.repair import WarmRepairController

    t0 = time.perf_counter()
    ei, ej, mats, rng = ring_lattice(V, WARM_D)
    mut_rows = rng.integers(0, ei.size, size=WARM_EDITS)
    mut_tabs = rng.uniform(0.0, 5.0, (WARM_EDITS, WARM_D, WARM_D)).astype(
        np.float32)
    algo_def = AlgorithmDef.build_with_default_params(
        "maxsum", {"damping": 0.7, "noise": 0.0})
    t1 = time.perf_counter()
    dc = ring_dcop(ei, ej, mats, V, WARM_D)
    # the CPU controller's own DCOP (an edit replaces its constraint)
    dc_cpu = DCOP("ring", variables=dc.variables)
    dc_cpu.constraints = dict(dc.constraints)
    dcop_s = time.perf_counter() - t1

    def edit(d, m):
        k = int(mut_rows[m])
        vs = [d.variables[f"v{int(v):06d}"] for v in (ei[k], ej[k])]
        return NAryMatrixRelation(vs, mut_tabs[m], name=f"c{k:06d}")

    def controller_on(dev, d):
        base = compile_binary_from_arrays(ei, ej, mats, V, device=dev)
        return WarmRepairController(d, "maxsum", algo_def=algo_def,
                                    headroom=0.1, chunk=WARM_CHUNK,
                                    tensors=base, device=dev)

    def window(ctl, chunks, resume=True):
        return ctl.solver.run(resume=resume, cycles=chunks * WARM_CHUNK,
                              chunk=WARM_CHUNK)

    def host(ctl):
        return [t.cpu().clone() for t in ctl.solver._last_state[:3]]

    def values(ctl):
        s = ctl.solver
        return s.tensors.assignment_from_indices(
            s.values_of(s._last_state).cpu().numpy())

    t1 = time.perf_counter()
    card = controller_on(device, dc)
    build_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    window(card, 1, resume=False)
    first = host(card)
    res = window(card, WARM_BASE_CHUNKS - 1)
    card.phase_done(res)
    base_s = time.perf_counter() - t1
    base_state = host(card)
    captures = card.total_traces()
    writes, windows, checked = [], [], []
    for m in range(WARM_EDITS):
        t1 = time.perf_counter()
        card.edit_factor(edit(dc, m))
        synchronize(card.solver.device)
        writes.append(time.perf_counter() - t1)
        t1 = time.perf_counter()
        res = window(card, WARM_WINDOW)
        windows.append(time.perf_counter() - t1)
        card.phase_done(res)
        if m < WARM_CPU_EDITS:
            checked.append(host(card))
    if card.total_traces() != captures or \
            card.counters.counts["repair_retraces"]:
        fail("warm", f"maxsum: captures {captures} before the stream, "
             f"{card.total_traces()} after, "
             f"{card.counters.counts['repair_retraces']} retraces")
    t1 = time.perf_counter()
    dc.solution_cost(res.assignment)
    score_ms = (time.perf_counter() - t1) * 1e3
    # the CPU run of the same stream: the first chunk from the zero
    # state, then the first windows from the card's base state
    cpu_t = time.perf_counter()
    cpu = controller_on("cpu", dc_cpu)
    errs = []

    def same(what, got, want):
        q, r, v = got
        wq, wr, wv = want
        if not torch.equal(v, wv):
            fail("warm", f"maxsum {what}: {int((v != wv).sum())} values "
                 f"differ from the CPU run")
        err = max(float((q - wq).abs().max()), float((r - wr).abs().max()))
        if err > TOL:
            fail("warm", f"maxsum {what}: messages {err} from the CPU run")
        errs.append(err)

    window(cpu, 1, resume=False)
    same("first chunk", host(cpu), first)
    cpu.solver._last_state = tuple(base_state) + (
        cpu.solver.resident_leaves(),)
    for m, want in enumerate(checked):
        cpu.edit_factor(edit(dc_cpu, m))
        window(cpu, WARM_WINDOW)
        same(f"edit {m}", host(cpu), want)
    cpu_s = time.perf_counter() - cpu_t
    del cpu, dc_cpu
    write_ms = np.array(writes) * 1e3
    window_ms = np.array(windows) * 1e3
    say("warm", kind="maxsum_stream", vars=V, factors=int(ei.size),
        D=WARM_D, edges_capacity=card.solver.tensors.n_edges,
        vars_capacity=card.solver.tensors.n_vars, headroom=0.1,
        chunk=WARM_CHUNK, base_chunks=WARM_BASE_CHUNKS, edits=WARM_EDITS,
        window_chunks=WARM_WINDOW,
        plan_depth=card.solver.tensors.plan_depths,
        captures_before=captures, captures_after=card.total_traces(),
        repair_retraces=card.counters.counts["repair_retraces"],
        dcop_build_s=dcop_s, build_s=build_s, base_s=base_s,
        write_ms_mean=float(write_ms.mean()),
        write_ms_p50=float(np.percentile(write_ms, 50)),
        write_ms_p99=float(np.percentile(write_ms, 99)),
        window_ms_mean=float(window_ms.mean()),
        window_ms_p50=float(np.percentile(window_ms, 50)),
        window_ms_p99=float(np.percentile(window_ms, 99)),
        host_score_ms=score_ms,
        recover_ms_mean=float((write_ms + window_ms).mean()),
        cpu_checked=["first chunk"] + [f"edit {m}" for m in
                                       range(len(checked))],
        values_equal=True, max_msg_err=max(errs), cpu_s=cpu_s,
        nvidia_smi=smi)
    # past the headroom at this size: factors on v000000 (degree 4)
    v0 = dc.variables["v000000"]
    before = values(card)
    base = card.total_traces()
    add_ms = []
    for j in range(WARM_REPACK_ADDS):
        other = dc.variables[f"v{50 + j:06d}"]
        t1 = time.perf_counter()
        card.add_constraint(NAryMatrixRelation(
            [v0, other], rng.uniform(0.0, 5.0, (WARM_D, WARM_D)),
            name=f"x{j:02d}"))
        synchronize(card.solver.device)
        add_ms.append((time.perf_counter() - t1) * 1e3)
    repacks = card.counters.counts["headroom_exhausted_repacks"]
    after = values(card)
    moved = [n for n in before if after.get(n) != before[n]]
    res = window(card, WARM_WINDOW)
    card.phase_done(res)
    if repacks != 1 or card.total_traces() != base + 1 or \
            card.counters.counts["repair_retraces"] != 1 or moved:
        fail("warm", f"maxsum repack: {repacks} repacks, captures {base} "
             f"-> {card.total_traces()}, {card.counters.as_dict()}, "
             f"values moved {moved[:5]}")
    if res.status != "FINISHED" or not np.isfinite(res.cost):
        fail("warm", f"maxsum repack: the window after it {res.status} "
             f"{res.cost}")
    say("warm", kind="maxsum_repack", vars=V, adds=WARM_REPACK_ADDS,
        repacks=repacks, captures_before=base,
        captures_after=card.total_traces(),
        vars_capacity=card.solver.tensors.n_vars,
        edges_capacity=card.solver.tensors.n_edges,
        plan_depth=card.solver.tensors.plan_depths,
        add_ms=[round(x, 3) for x in add_ms[:-1]],
        repack_add_ms=add_ms[-1], values_carried=True,
        window_ms=res.time * 1e3, cost=res.cost,
        phase_s=time.perf_counter() - t0, nvidia_smi=smi)


def warm_mgm_stream(dcop, device, n=WARM_EDITS):
    """bench_churn's mgm sub-leg through the solver API:
    ``build_warm_solver`` + ``change_factor_function`` + ``run(resume=
    True)``, one WARM_MGM_CHUNK-cycle chunk after each edit.  Returns
    the results, the captures after warm-up and at the end, and the
    stream's seconds."""
    from pydcop_tpu_torch.algorithms.warm import build_warm_solver
    from pydcop_tpu_torch.runtime.repair import perturbed_constraint

    s = build_warm_solver(dcop, algo="mgm", seed=5, headroom=0.1,
                          device=device)
    out = [s.run(chunk=WARM_MGM_CHUNK)]
    base = s.trace_count()
    names = sorted(dcop.constraints)
    rng = np.random.default_rng(99)
    t0 = time.perf_counter()
    for m in range(n):
        name = names[int(rng.integers(len(names)))]
        s.change_factor_function(perturbed_constraint(
            dcop.constraints[name], seed=m))
        out.append(s.run(resume=True, cycles=WARM_MGM_CHUNK,
                         chunk=WARM_MGM_CHUNK))
    return out, base, s.trace_count(), time.perf_counter() - t0


def warm_repack(dcop, device):
    """A stream run past its headroom: a controller with ONE free
    variable slot, two variables added, a 3-chunk window after each —
    exactly one repack and one more capture."""
    from pydcop_tpu_torch.dcop import Variable, constraint_from_str
    from pydcop_tpu_torch.runtime.repair import WarmRepairController

    ctl = WarmRepairController(dcop, "mgm", seed=7, headroom=0.0,
                               min_free=1, chunk=WARM_MGM_CHUNK,
                               device=device)
    res = ctl.solver.run(chunk=ctl.chunk)
    ctl.phase_done(res)
    base = ctl.total_traces()
    v0 = sorted(dcop.variables)[0]
    for i in range(2):
        z = Variable(f"zz{i}", dcop.variables[v0].domain)
        ctl.add_variable(z)
        ctl.add_constraint(constraint_from_str(
            f"czz{i}", f"0 if zz{i} == {v0} else 2",
            [z, dcop.variables[v0]]))
        res = ctl.solver.run(resume=True, cycles=3 * ctl.chunk,
                             chunk=ctl.chunk)
        ctl.phase_done(res)
    return ctl, base, res


def warm_phase(smi, device="cuda"):
    """Warm repair on the card (see warm_maxsum_leg, warm_mgm_stream and
    warm_repack): no kernel of the port is launched (the warm engines
    are the generic ones), captures unchanged over the streams, one
    more after the repack, and each stream equal to its CPU run."""
    t0 = time.perf_counter()
    reset_counts()
    warm_maxsum_leg(smi, device)
    got, base, end, secs = warm_mgm_stream(
        coloring_dcop(WARM_MGM_V, 3 * WARM_MGM_V, seed=5), device)
    if end != base:
        fail("warm", f"mgm: captures {base} after warm-up, {end} after "
             f"the stream")
    want, _, _, cpu_s = warm_mgm_stream(
        coloring_dcop(WARM_MGM_V, 3 * WARM_MGM_V, seed=5), "cpu")
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if (g.assignment, g.cost) != (w.assignment, w.cost)]
    if bad:
        fail("warm", f"mgm: windows {bad[:5]} differ from the CPU run")
    say("warm", kind="mgm_stream", vars=WARM_MGM_V, factors=3 * WARM_MGM_V,
        edits=WARM_EDITS, chunk=WARM_MGM_CHUNK, captures_before=base,
        captures_after=end, stream_s=secs,
        ms_per_edit_window=secs / WARM_EDITS * 1e3, cpu_stream_s=cpu_s,
        equal_to_cpu=True, final_cost=got[-1].cost, nvidia_smi=smi)
    ctl, base, res = warm_repack(
        coloring_dcop(WARM_MGM_V, 3 * WARM_MGM_V, seed=5), device)
    c = ctl.counters.as_dict()
    if c["headroom_exhausted_repacks"] != 1 or \
            ctl.total_traces() != base + 1 or c["repair_retraces"] != 1:
        fail("warm", f"repack: {c}, captures {base} -> "
             f"{ctl.total_traces()}")
    want_ctl, _, want = warm_repack(
        coloring_dcop(WARM_MGM_V, 3 * WARM_MGM_V, seed=5), "cpu")
    if (res.assignment, res.cost) != (want.assignment, want.cost):
        fail("warm", "repack: the card's stream differs from the CPU's")
    counts = read_counts()
    if any(counts.values()):
        fail("warm", f"the warm engines launched "
             f"{ {k: v for k, v in counts.items() if v} }; they run the "
             f"generic cycles")
    say("warm", kind="repack", algo="mgm", vars=WARM_MGM_V, repacks=1,
        captures_before=base, captures_after=ctl.total_traces(),
        counters=c, equal_to_cpu=True, launches=0,
        phase_s=time.perf_counter() - t0, nvidia_smi=smi)


#: the memo leg at the JAX bench's size (bench.py bench_memo): soft
#: 3-colourings of MEMO_V variables and 2 MEMO_V - 2 edges (the port's
#: colouring family, coloring_dcop), mgm at seed 1, a cold budget of
#: MEMO_COLD_CYCLES; the trace 4 novel, 4 duplicates, 4 one-edit
#: variants (edit seeds 100-103), 4 duplicates
MEMO_V, MEMO_COLD_CYCLES, MEMO_BASES = 800, 2000, 4
#: the at-size stream with the cache: serve_at_size's Poisson
#: stream, job i on problem i % 64 at seed i % 64; seconds into the
#: script after which it takes half the jobs (a quarter 100 s later)
MEMO_STREAM_CUT_AFTER_S = 500.0


def memo_instance(seed, edit_seed=None):
    from pydcop_tpu_torch.runtime.repair import perturbed_constraint

    d = coloring_dcop(MEMO_V, 2 * MEMO_V - 2, seed=seed)
    if edit_seed is not None:
        name = sorted(d.constraints)[2]
        d.constraints[name] = perturbed_constraint(d.constraints[name],
                                                   seed=edit_seed)
    return d


def memo_trace_leg(smi, device="cuda"):
    """The memo bench leg's trace through ``SolveService(memo=True)`` on
    the card, one request at a time: every exact hit equal to its cached
    result with no runner call, every served variant no worse than its
    seed (the cache's guarantee); each variant beside its cold solve
    (``solve_result`` on the card): costs, times and whether the served
    one is no worse (measured, as the JAX bench's
    ``memo_never_worse_trace``: a warm repair and a cold solve reach
    different local optima, so it is not a guarantee); the hit counts,
    p50 latency by kind and the variant speedup: the median cold ms over
    the median served ms, over the requests served as a variant hit."""
    from pydcop_tpu_torch.batch import CompileCache
    from pydcop_tpu_torch.runtime import solve_result
    from pydcop_tpu_torch.serve import SolveService

    trace = ([("novel", s, None) for s in range(MEMO_BASES)]
             + [("dup", s, None) for s in range(MEMO_BASES)]
             + [("variant", s, 100 + s) for s in range(MEMO_BASES)]
             + [("dup", s, None) for s in range(MEMO_BASES)])
    svc = SolveService(lanes=8, cache=CompileCache(), memo=True,
                       max_cycles=MEMO_COLD_CYCLES, device=device)
    first, lat, rows = {}, {}, []
    cold_ms = []
    try:
        svc.start()
        for kind, s, es in trace:
            d = memo_instance(s, es)
            calls = dict(svc.metrics()["runners"])
            res = svc.result(svc.submit(d, "mgm", seed=1), timeout=600)
            hit = res.memo["hit"]
            lat.setdefault(hit, []).append(res.time * 1e3)
            if res.status != "FINISHED":
                fail("memo", f"{kind} {s}: {res.status}")
            if hit == "exact":
                f = first[s]
                if (res.assignment, res.cost, res.cycle) != \
                        (f.assignment, f.cost, f.cycle):
                    fail("memo", f"exact hit {s} differs from its cached "
                         f"result")
                if svc.metrics()["runners"] != calls:
                    fail("memo", f"exact hit {s} made a runner call")
            elif kind == "novel":
                first[s] = res
            if kind == "variant":
                t1 = time.perf_counter()
                cold = solve_result(d, "mgm", seed=1,
                                    cycles=MEMO_COLD_CYCLES, device=device)
                cold_ms.append((time.perf_counter() - t1) * 1e3)
                seed_cost = res.memo.get("seed_cost")
                if hit == "variant" and res.cost > seed_cost + 1e-6:
                    fail("memo", f"variant {s} served {res.cost}, worse "
                         f"than its seed {seed_cost}")
                rows.append({"base": s, "hit": hit, "cost": res.cost,
                             "seed_cost": seed_cost, "cold_cost": cold.cost,
                             "no_worse_than_cold":
                                 res.cost <= cold.cost + 1e-6,
                             "warm_ms": res.time * 1e3,
                             "cold_ms": cold_ms[-1],
                             "repacks": res.memo.get("repacks")})
        stats = svc.metrics()["memo"]
    finally:
        svc.stop(drain=False)
    warm = [r for r in rows if r["hit"] == "variant"]
    say("memo", kind="trace", vars=MEMO_V, edges=2 * MEMO_V - 2,
        algo="mgm", seed=1, cold_cycles=MEMO_COLD_CYCLES,
        requests=len(trace), hits_exact=stats["hits_exact"],
        hits_variant=stats["hits_variant"], misses=stats["misses"],
        cold_fallbacks=stats["variant_cold_fallbacks"],
        p50_ms={k: float(np.percentile(v, 50)) for k, v in lat.items()},
        variants=rows,
        variant_speedup_median=(
            float(np.median([r["cold_ms"] for r in warm])
                  / np.median([r["warm_ms"] for r in warm]))
            if warm else None),
        exact_equal=True, exact_runner_calls=0, never_worse_than_seed=True,
        never_worse_than_cold=all(r["no_worse_than_cold"] for r in rows),
        nvidia_smi=smi)


def memo_corrupt_leg(smi, device="cuda"):
    """The ``corrupt_cache_entry`` fault on the card: a journaled
    service caches one solve and corrupts its persisted entry; a new
    service's ``resume()`` skips and counts it, and the duplicate is
    solved again (a miss), never served from the corrupt file."""
    import tempfile

    from pydcop_tpu_torch.batch import CompileCache
    from pydcop_tpu_torch.runtime.faults import Fault, FaultPlan
    from pydcop_tpu_torch.serve import SolveService

    journal = os.path.join(tempfile.mkdtemp(prefix="memo_"), "journal")
    d = memo_instance(0)
    plan = FaultPlan(faults=[Fault(kind="corrupt_cache_entry",
                                   jid="job-000001")], seed=7)
    runs = []
    for fp in (plan, None):
        svc = SolveService(lanes=2, cache=CompileCache(), memo=True,
                           max_cycles=MEMO_COLD_CYCLES, device=device,
                           journal_dir=journal, fault_plan=fp)
        try:
            if fp is None:
                svc.resume()
            svc.start()
            res = svc.result(svc.submit(d, "mgm", seed=1), timeout=600)
            runs.append((res, svc.metrics()["memo"],
                         svc.counters.counts["faults_injected"]))
        finally:
            svc.stop(drain=False)
    (r1, m1, injected), (r2, m2, _) = runs
    if not injected or m2["corrupt_skipped"] != 1 or m2["rehydrated"] \
            or r2.memo["hit"] != "miss":
        memo_dir = os.path.join(journal, "memo")
        fail("memo", f"corrupt entry: first job {r1.status} {r1.memo} "
             f"{m1}, injected {injected}, files "
             f"{sorted(os.listdir(memo_dir)) if os.path.isdir(memo_dir) else None}; "
             f"then {m2}, hit {r2.memo['hit']}")
    if (r2.assignment, r2.cost) != (r1.assignment, r1.cost):
        fail("memo", "corrupt entry: the re-solve differs from the first")
    say("memo", kind="corrupt_entry", faults_injected=injected,
        corrupt_skipped=m2["corrupt_skipped"], rehydrated=m2["rehydrated"],
        second_hit=r2.memo["hit"], served_from_corrupt=False,
        nvidia_smi=smi)


def memo_stream_leg(smi, device="cuda"):
    """serve_at_size's Poisson stream with the cache: SERVE_BIG_JOBS mgm
    jobs on SERVE_BIG_PROBLEMS problems of SERVE_BIG_V / SERVE_BIG_V // 2
    variables, SERVE_BIG_LANES lanes, SERVE_BIG_RATE jobs/s from arrival
    seed SERVE_SEED; job i on problem i % 64 at seed i % 64, so jobs i
    and i + 64 are exact duplicates.  Every hit equals the result of its
    first copy."""
    n = SERVE_BIG_JOBS
    elapsed = time.perf_counter() - SCRIPT_T0
    cut = elapsed > MEMO_STREAM_CUT_AFTER_S
    if cut:
        n //= 2
    if elapsed > MEMO_STREAM_CUT_AFTER_S + 100.0:
        n //= 2
    problems = serve_family(SERVE_BIG_PROBLEMS, SERVE_BIG_V, seed0=500)
    jobs = [(problems[i % SERVE_BIG_PROBLEMS], i % SERVE_BIG_PROBLEMS)
            for i in range(n)]
    reset_counts()
    results, row = serve_run(
        jobs, "mgm", SERVE_BIG_LANES, SERVE_MAX_CYCLES,
        poisson_offsets(n, SERVE_BIG_RATE, SERVE_SEED),
        prewarm=problems[:8], device=device, memo=True)
    counts = read_counts()
    if any(counts.values()):
        fail("memo", f"stream: the buckets launched kernels "
             f"{ {k: v for k, v in counts.items() if v} }")
    hits = {}
    bad = []
    for i, r in enumerate(results):
        hit = r.memo["hit"]
        hits[hit] = hits.get(hit, 0) + 1
        if hit == "exact":
            f = results[i % SERVE_BIG_PROBLEMS]
            if (r.assignment, r.cost, r.cycle, r.status) != \
                    (f.assignment, f.cost, f.cycle, f.status):
                bad.append(i)
    if bad:
        fail("memo", f"stream: exact hits {bad[:5]} differ from their "
             f"first copies")
    memo_stats = row.pop("memo")
    say("memo", kind="stream", algo="mgm", vars=[SERVE_BIG_V,
        SERVE_BIG_V // 2], problems=SERVE_BIG_PROBLEMS,
        lanes=SERVE_BIG_LANES, rate=SERVE_BIG_RATE,
        arrival_seed=SERVE_SEED, seeds="i mod 64",
        jobs_cut_from=SERVE_BIG_JOBS if cut else None,
        script_s_at_start=round(elapsed, 1), hits_by_kind=hits,
        memo=memo_stats, exact_equal_first_copy=True, **row,
        nvidia_smi=smi)


def memo_phase(smi, device="cuda"):
    """The solution cache on the card (see memo_trace_leg,
    memo_corrupt_leg and memo_stream_leg)."""
    t0 = time.perf_counter()
    memo_trace_leg(smi, device)
    memo_corrupt_leg(smi, device)
    memo_stream_leg(smi, device)
    say("memo", kind="done", phase_s=round(time.perf_counter() - t0, 3),
        script_s=round(time.perf_counter() - SCRIPT_T0, 1))


# --------------------------------------------------------------------------
# the solve fleets: threads (one CUDA context) and child processes
# --------------------------------------------------------------------------

#: the JAX bench's fleet leg (bench.py:1412-1560): the serve leg's trace
#: (dsa) at 1, 2 and 4 replicas, then a kill of replica-0 of 2 at
#: supervisor pass FLEET_KILL_TICK
FLEET_ALGO, FLEET_REPLICAS, FLEET_KILL_TICK = "dsa", (1, 2, 4), 4
#: the at-size burst (SERVE_BIG_JOBS mgm jobs at SERVE_BIG_LANES lanes)
#: at these replica counts: threads, processes
FLEET_BURST_REPLICAS, PROCFLEET_BURST_REPLICAS = (1, 2), (1, 2, 4)
#: the mgm2 job run in each of two children at once (K6 in two CUDA
#: contexts), held to its CPU solve
PROCFLEET_MGM2_V = 500
#: the process fleet's burst draws its jobs from the family's first
#: PROCFLEET_BURST_PROBLEMS problems (half of each size): every child
#: loads each problem's YAML file before the burst, 0.4-0.6 s a file on
#: the chip machine's host
PROCFLEET_BURST_PROBLEMS = 8
#: the process fleet's burst: this many of the at-size jobs (the
#: script's time limit holds every phase)
PROCFLEET_BURST_JOBS = 256
#: a wait longer than two of a child's report intervals (0.25 s): every
#: child's next report reads the card's memory after the last change
PROCFLEET_REPORT_S = 0.6
#: past this many seconds into the script the bursts are halved
FLEET_CUT_AFTER_S = 600.0


_BIG_PROBLEMS = []


def big_problems():
    """The serve phase's at-size family (SERVE_BIG_PROBLEMS mgm
    colourings of SERVE_BIG_V / SERVE_BIG_V // 2 variables), built once
    a process."""
    if not _BIG_PROBLEMS:
        _BIG_PROBLEMS.extend(serve_family(SERVE_BIG_PROBLEMS, SERVE_BIG_V,
                                          seed0=500))
    return _BIG_PROBLEMS


def fleet_replay(fleet, jobs, algo, offsets, files=None):
    """Submit ``jobs`` (job i: ``(dcop, seed)``, and its YAML ``files[i]``
    for a process fleet) at ``offsets[i]`` seconds into a started fleet;
    every result awaited.  Latency is against the scheduled arrival,
    as the JAX bench's fleet leg reads it (a process fleet's result time
    is the child's, without the socket's transit)."""
    t0 = time.perf_counter()
    sub = []
    for i, (d, seed) in enumerate(jobs):
        wait = offsets[i] - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        kw = {"source_file": files[i]} if files else {}
        sub.append((fleet.submit(d, algo, seed=seed, **kw),
                    time.perf_counter() - t0))
    results = [fleet.result(jid, timeout=600) for jid, _ in sub]
    done = [s + r.time for (_, s), r in zip(sub, results)]
    lat = np.array([c - o for c, o in zip(done, offsets)])
    wall = max(done)
    return results, dict(
        jobs=len(jobs), wall_s=wall, jobs_per_s=len(jobs) / wall,
        p50_ms=float(np.percentile(lat, 50)) * 1e3,
        p99_ms=float(np.percentile(lat, 99)) * 1e3,
        replicas_served=sorted({r.serve["replica"] for r in results}),
        statuses=sorted({r.status for r in results}))


def fleet_check(phase, what, results, want, which=None):
    """Each checked result's (assignment, cost, cycle, status) equal to
    ``want`` (its standalone solve on the card)."""
    bad = [(i, results[i].cost, want[i].cost, results[i].cycle,
            want[i].cycle, results[i].status)
           for i in (range(len(results)) if which is None else which)
           if (results[i].assignment, results[i].cost, results[i].cycle,
               results[i].status) != (want[i].assignment, want[i].cost,
                                      want[i].cycle, want[i].status)]
    if bad:
        fail(phase, f"{what}: {len(bad)} jobs differ from their standalone "
             f"solves on the card (job, cost, want, cycle, want, status): "
             f"{bad[:4]}")


def fleet_runners(fleet):
    """The bucket runners' calls summed over a thread fleet's replicas."""
    out = {}
    for h in fleet._handles.values():
        for k, v in h.service.metrics()["runners"].items():
            out[k] = out.get(k, 0) + v
    return out


def fleet_burst_jobs(n_problems=SERVE_BIG_PROBLEMS, n_jobs=SERVE_BIG_JOBS):
    """The at-size burst: ``n_jobs`` mgm jobs (halved past
    FLEET_CUT_AFTER_S), job i on problem i % ``n_problems`` of the big
    family at seed i, a sample of SERVE_SAMPLE of them checked."""
    n = n_jobs
    cut = time.perf_counter() - SCRIPT_T0 > FLEET_CUT_AFTER_S
    if cut:
        n //= 2
    problems = big_problems()
    jobs = [(problems[i % n_problems], i) for i in range(n)]
    sample = list(range(0, n, max(1, n // SERVE_SAMPLE)))[:SERVE_SAMPLE]
    return jobs, sample, cut


def fleet_trace_leg(smi, device):
    """The JAX bench's fleet leg on the card at 1, 2 and 4 thread
    replicas (prewarmed, then started), every job equal to its
    standalone solve; then 2 replicas, tick-driven, with ``kill_replica``
    of replica-0 at supervisor pass FLEET_KILL_TICK: every job equal to
    the unfailed run, the orphans re-seated, a finite RTO."""
    import tempfile

    from pydcop_tpu_torch.runtime.faults import Fault, FaultPlan
    from pydcop_tpu_torch.serve import SolveFleet

    dcops = serve_family(SERVE_JOBS, SERVE_VARS)
    jobs = [(d, i) for i, d in enumerate(dcops)]
    offsets = poisson_offsets(SERVE_JOBS, SERVE_RATE, SERVE_SEED)
    t0 = time.perf_counter()
    want = [serve_sequential(d, FLEET_ALGO, i, SERVE_MAX_CYCLES, device)
            for d, i in jobs]
    seq_s = time.perf_counter() - t0
    rows = {}
    for n in FLEET_REPLICAS:
        reset_counts()
        fleet = SolveFleet(replicas=n, lanes=SERVE_LANES,
                           max_cycles=SERVE_MAX_CYCLES, device=device)
        try:
            t0 = time.perf_counter()
            fleet.prewarm([(d, FLEET_ALGO) for d in dcops], block=True)
            prewarm_s = time.perf_counter() - t0
            warm = fleet_runners(fleet)
            fleet.start()
            results, row = fleet_replay(fleet, jobs, FLEET_ALGO, offsets)
            m = fleet.metrics()
            runners = fleet_runners(fleet)
        finally:
            fleet.stop(drain=False)
        counts = read_counts()
        if any(counts.values()):
            fail("fleet", f"trace at {n}: the buckets launched "
                 f"{ {k: v for k, v in counts.items() if v} }")
        fleet_check("fleet", f"trace at {n} replicas", results, want)
        rows[n] = row
        say("fleet", kind="trace", algo=FLEET_ALGO, replicas=n,
            vars=[SERVE_VARS, SERVE_VARS // 2], rate=SERVE_RATE,
            arrival_seed=SERVE_SEED, lanes=SERVE_LANES, equal=True,
            launches=0, prewarm_s=prewarm_s, runners_after_prewarm=warm,
            runners=runners, routed_warm=m["fleet"]["jobs_routed_warm"],
            sequential_s=seq_s, **row, nvidia_smi=smi)
    jd = tempfile.mkdtemp(prefix="fleet_kill_")
    plan = FaultPlan(faults=[Fault(kind="kill_replica", replica=0,
                                   cycle=FLEET_KILL_TICK)])
    fleet = SolveFleet(replicas=2, lanes=SERVE_LANES,
                       max_cycles=SERVE_MAX_CYCLES, journal_dir=jd,
                       checkpoint_every=1, fault_plan=plan, device=device)
    try:
        fleet.prewarm([(d, FLEET_ALGO) for d in dcops], block=True)
        jids = [fleet.submit(d, FLEET_ALGO, seed=i) for d, i in jobs]
        t0 = time.perf_counter()
        for _ in range(20_000):
            if not fleet.tick():
                break
        wall = time.perf_counter() - t0
        results = [fleet.result(j, timeout=60) for j in jids]
        m = fleet.metrics()
    finally:
        fleet.stop(drain=False)
    fleet_check("fleet", "kill_replica", results, want)
    fl, recov = m["fleet"], m["recoveries"]
    if not fl["jobs_reseated"] or not recov or recov[0]["rto_s"] is None:
        fail("fleet", f"kill_replica: nothing re-seated or no RTO ({fl}, "
             f"{recov})")
    say("fleet", kind="kill", algo=FLEET_ALGO, replicas=2,
        kill_at_pass=FLEET_KILL_TICK, equal=True,
        reseated=fl["jobs_reseated"],
        checkpoint_reseats=fl["reseat_checkpoint_hits"],
        cold_restarts=fl["reseat_cold_restarts"],
        rto_s=recov[0]["rto_s"], orphans=recov[0]["jobs"], wall_s=wall,
        nvidia_smi=smi)
    return rows


def fleet_burst_leg(smi, device):
    """SERVE_BIG_JOBS mgm jobs (500 / 250 variables) at SERVE_BIG_LANES
    lanes in one burst through 1 and 2 thread replicas."""
    from pydcop_tpu_torch.serve import SolveFleet

    jobs, sample, cut = fleet_burst_jobs()
    problems = big_problems()
    want = {i: serve_sequential(jobs[i][0], "mgm", jobs[i][1],
                                SERVE_MAX_CYCLES, device) for i in sample}
    rows = {}
    for n in FLEET_BURST_REPLICAS:
        fleet = SolveFleet(replicas=n, lanes=SERVE_BIG_LANES,
                           max_cycles=SERVE_MAX_CYCLES, device=device)
        try:
            fleet.prewarm([(d, "mgm") for d in problems[:8]], block=True)
            fleet.start()
            results, row = fleet_replay(fleet, jobs, "mgm",
                                        [0.0] * len(jobs))
            runners = fleet_runners(fleet)
        finally:
            fleet.stop(drain=False)
        fleet_check("fleet", f"burst at {n} replicas",
                    [results[i] for i in sample],
                    [want[i] for i in sample])
        rows[n] = row
        say("fleet", kind="burst", algo="mgm", replicas=n,
            vars=[SERVE_BIG_V, SERVE_BIG_V // 2],
            problems=SERVE_BIG_PROBLEMS, lanes=SERVE_BIG_LANES,
            jobs_cut_from=SERVE_BIG_JOBS if cut else None,
            checked=len(sample), equal=True, runners=runners, **row,
            nvidia_smi=smi)
    return rows


def fleet_capture_leg(smi, device):
    """Two started thread replicas prewarmed at the same signature set
    at once (their captures, each on its own scheduler thread, meet the
    process-wide capture lock), then eight jobs on each: every job equal
    to its standalone solve, its step a replay."""
    import threading

    from pydcop_tpu_torch.serve import SolveFleet

    dcops = serve_family(16, SERVE_VARS, seed0=700)
    want = [serve_sequential(d, "mgm", i, SERVE_MAX_CYCLES, device)
            for i, d in enumerate(dcops)]
    fleet = SolveFleet(replicas=2, lanes=SERVE_LANES,
                       max_cycles=SERVE_MAX_CYCLES, device=device)
    try:
        fleet.start()
        errs = []

        def warm(i):
            try:
                fleet.handle(i).service.prewarm(
                    [(d, "mgm") for d in dcops[:8]], block=True)
            except Exception as e:  # reported below, the phase fails
                errs.append(repr(e))

        threads = [threading.Thread(target=warm, args=(i,))
                   for i in (0, 1)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        prewarm_s = time.perf_counter() - t0
        if errs or any(t.is_alive() for t in threads):
            fail("fleet", f"overlapping prewarms: {errs}")
        warm_calls = [fleet.handle(i).service.metrics()["runners"]
                      for i in (0, 1)]
        jids = []
        for k in (0, 1):
            fleet.router.set_partitioned(f"replica-{1 - k}", True)
            fleet.router.set_partitioned(f"replica-{k}", False)
            jids += [fleet.submit(dcops[i], "mgm", seed=i)
                     for i in range(8 * k, 8 * k + 8)]
        results = [fleet.result(j, timeout=300) for j in jids]
        calls = [fleet.handle(i).service.metrics()["runners"]
                 for i in (0, 1)]
    finally:
        fleet.stop(drain=False)
    fleet_check("fleet", "overlapping captures", results, want)
    served = [r.serve["replica"] for r in results]
    if served != ["replica-0"] * 8 + ["replica-1"] * 8 or (
            device == "cuda" and any(c["captures"] < 1 or c["replays"] < 1
                                     for c in calls)):
        fail("fleet", f"overlapping captures: served by {served}, runner "
             f"calls {calls}")
    say("fleet", kind="captures", algo="mgm", replicas=2, equal=True,
        prewarm_s=prewarm_s, runners_after_prewarm=warm_calls,
        runners=calls, nvidia_smi=smi)


def fleet_fallback_leg(smi, device):
    """One mgm2 job (a SERVE_MGM2_V-variable colouring) and one dpop job
    (a SERVE_DPOP_NODES-node tree) through a thread replica's
    sequential fallback: K6 and K10 launch, and each result equals the
    CPU solve (the kernels' plain versions)."""
    from pydcop_tpu_torch.runtime import solve_result
    from pydcop_tpu_torch.serve import SolveFleet

    mgm2 = coloring_dcop(SERVE_MGM2_V, 3 * SERVE_MGM2_V, seed=21)
    tree = tree_dcop(SERVE_DPOP_NODES, seed=6)
    out = {}
    fleet = SolveFleet(replicas=2, lanes=2, max_cycles=SERVE_MAX_CYCLES,
                       device=device)
    try:
        fleet.start()
        for algo, dcop, counter in (("mgm2", mgm2, "mgm2"),
                                    ("dpop", tree, "dpop_whole_sweep")):
            reset_counts()
            res = fleet.result(fleet.submit(dcop, algo, seed=3),
                               timeout=300)
            counts = read_counts()
            if device == "cuda" and not counts[counter]:
                fail("fleet", f"fallback {algo}: {counter} launched no "
                     f"time ({counts})")
            want = solve_result(dcop, algo, seed=3, device="cpu")
            if (res.assignment, res.cost, res.cycle, res.status) != \
                    (want.assignment, want.cost, want.cycle, want.status):
                fail("fleet", f"fallback {algo}: served {res.cost} / "
                     f"{res.cycle} cycles, the CPU solve {want.cost} / "
                     f"{want.cycle}")
            out[counter] = counts[counter]
            say("fleet", kind="fallback", algo=algo, counter=counter,
                launches=counts[counter], replica=res.serve["replica"],
                cost=res.cost, cycle=res.cycle, equal_cpu=True,
                latency_ms=res.time * 1e3, nvidia_smi=smi)
    finally:
        fleet.stop(drain=False)
    return out


def fleet_phase(smi, device="cuda"):
    """The thread-hosted solve fleet on the card (see fleet_trace_leg,
    fleet_burst_leg, fleet_capture_leg and fleet_fallback_leg).
    Returns the fallback's launches by counter."""
    t0 = time.perf_counter()
    fleet_trace_leg(smi, device)
    fleet_burst_leg(smi, device)
    fleet_capture_leg(smi, device)
    launches = fleet_fallback_leg(smi, device)
    say("fleet", kind="done", phase_s=round(time.perf_counter() - t0, 3),
        script_s=round(time.perf_counter() - SCRIPT_T0, 1))
    return launches


def write_yaml(dcops, directory, stem):
    """Each dcop as ``<directory>/<stem><i>.yaml`` (a process fleet's
    jobs cross to the children by path); returns the paths."""
    from pydcop_tpu_torch.dcop import dcop_yaml

    paths = []
    for i, d in enumerate(dcops):
        paths.append(os.path.join(directory, f"{stem}{i}.yaml"))
        with open(paths[-1], "w", encoding="utf-8") as f:
            f.write(dcop_yaml(d))
    return paths


def procfleet_wait(phase, fleet, pred, what, timeout=300.0):
    """Wait (head supervision running) until ``pred()``; fail past
    ``timeout`` seconds."""
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if pred():
            return
        time.sleep(0.05)
    fail(phase, f"{what}: not within {timeout} s ({fleet.metrics()['fleet']})")


def procfleet_children(fleet):
    """The live children's last reports (pid, nvcc runs, launches, CUDA
    memory), by replica."""
    live = {n for n, h in fleet._handles.items() if h.up and not h.dead}
    return {n: p for n, p in fleet.metrics()["processes"].items()
            if n in live}


def procfleet_memory(fleet):
    """Each live child's ``memory_reserved`` and the card's free and
    total bytes (``mem_get_info``), from its latest report."""
    kids = procfleet_children(fleet)
    return {n: {k: p.get(k) for k in ("memory_reserved", "mem_free",
                                       "mem_total")}
            for n, p in kids.items()}


def procfleet_reported(fleet, key="pid"):
    """True when every live child has reported (``key``)."""
    kids = procfleet_children(fleet)
    live = [n for n, h in fleet._handles.items() if h.up and not h.dead]
    return len(kids) == len(live) and all(key in p for p in kids.values())


def procfleet_route_to(fleet, names):
    """Only ``names`` take new placements (the others partitioned), once
    each of them is routable: a child whose heartbeat went stale during
    a long tick (a capture at 64 lanes, say) is a stall, routed around
    until the supervisor sees it beat again (counted in
    ``replicas_stalled``)."""
    for n in fleet.router.up():
        fleet.router.set_partitioned(n, n not in names)
    procfleet_wait("procfleet", fleet, lambda: set(names) <= set(
        fleet.router.routable()), f"{names} routable")


def procfleet_trace_leg(smi, work, device, fleet, t_spawn):
    """``fleet``'s four replica children on the card (lanes SERVE_LANES,
    journaled, checkpoint every chunk, spawned at ``t_spawn``): the
    fleet trace at 1, 2 and 4 of them (the
    rest partitioned), every job equal to its standalone solve; an mgm2
    job in the fallback of each of two children at once (K6 in two CUDA
    contexts, each equal to the CPU solve); then kill -9 of replica-0
    holding jobs of a burst of the trace: every job equal, the orphans
    re-seated, a finite RTO, the slot relaunched; a ``corrupt_artifact``
    fault on every recipe, then the relaunched child's prewarm rejects it
    (counted) and rebuilds."""
    from pydcop_tpu_torch.runtime import solve_result
    from pydcop_tpu_torch.runtime.faults import Fault

    dcops = serve_family(SERVE_JOBS, SERVE_VARS)
    files = write_yaml(dcops, work, "trace")
    jobs = [(d, i) for i, d in enumerate(dcops)]
    offsets = poisson_offsets(SERVE_JOBS, SERVE_RATE, SERVE_SEED)
    want = [serve_sequential(d, FLEET_ALGO, i, SERVE_MAX_CYCLES, device)
            for d, i in jobs]
    mgm2 = coloring_dcop(PROCFLEET_MGM2_V, 3 * PROCFLEET_MGM2_V, seed=21)
    [mgm2_file] = write_yaml([mgm2], work, "mgm2_")
    try:
        if not fleet.wait_ready(timeout=300):
            fail("procfleet", "trace: the four children not ready")
        ready_s = time.perf_counter() - t_spawn
        fleet.start()
        procfleet_wait("procfleet", fleet, lambda: procfleet_reported(
            fleet), "the children's first reports")
        memory_idle = procfleet_memory(fleet)
        t0 = time.perf_counter()
        fleet.prewarm([(f, FLEET_ALGO) for f in files])
        procfleet_wait("procfleet", fleet, lambda: fleet.handle(0).service
                       .cache.stats().get("pooled", 0) > 0,
                       "the trace's prewarm")
        prewarm_s = time.perf_counter() - t0
        names = [f"replica-{i}" for i in range(4)]
        for n in FLEET_REPLICAS:
            procfleet_route_to(fleet, names[:n])
            results, row = fleet_replay(fleet, jobs, FLEET_ALGO, offsets,
                                        files)
            fleet_check("procfleet", f"trace at {n} children", results,
                        want)
            say("procfleet", kind="trace", algo=FLEET_ALGO, children=n,
                vars=[SERVE_VARS, SERVE_VARS // 2], rate=SERVE_RATE,
                arrival_seed=SERVE_SEED, lanes=SERVE_LANES, equal=True,
                ready_s=ready_s, prewarm_s=prewarm_s,
                stalls=fleet.metrics()["fleet"]["replicas_stalled"],
                memory_idle=memory_idle, **row, nvidia_smi=smi)
        # K6 in two CUDA contexts at once
        before = {n: p["launches"]["mgm2"]
                  for n, p in procfleet_children(fleet).items()}
        jids = []
        for k in (0, 1):
            procfleet_route_to(fleet, [names[k]])
            jids.append(fleet.submit(mgm2, "mgm2", seed=3 + k,
                                     source_file=mgm2_file))
        sub_t = time.perf_counter()
        res = [fleet.result(j, timeout=300) for j in jids]
        both_s = time.perf_counter() - sub_t
        time.sleep(PROCFLEET_REPORT_S)  # the children's reports after
        procfleet_wait("procfleet", fleet, lambda: device != "cuda" or all(
            procfleet_children(fleet)[names[k]]["launches"]["mgm2"]
            > before[names[k]] for k in (0, 1)), "K6 launches reported")
        k6 = {names[k]: procfleet_children(fleet)[names[k]]["launches"]
              ["mgm2"] - before[names[k]] for k in (0, 1)}
        for k, r in enumerate(res):
            w = solve_result(mgm2, "mgm2", seed=3 + k, device="cpu")
            if (r.assignment, r.cost, r.cycle, r.status) != \
                    (w.assignment, w.cost, w.cycle, w.status) or \
                    r.serve["replica"] != names[k]:
                fail("procfleet", f"mgm2 in {names[k]}: served {r.cost} / "
                     f"{r.cycle} on {r.serve['replica']}, the CPU solve "
                     f"{w.cost} / {w.cycle}")
        say("procfleet", kind="fallback", algo="mgm2", counter="mgm2",
            launches_by_child=k6, equal_cpu=True, both_s=both_s,
            latency_ms=[r.time * 1e3 for r in res],
            memory=procfleet_memory(fleet), nvidia_smi=smi)
        # kill -9 of replica-0 holding jobs of a burst of the trace
        procfleet_route_to(fleet, names[:2])
        sub = [fleet.submit(d, FLEET_ALGO, seed=i, source_file=files[i])
               for d, i in jobs]
        time.sleep(0.05)
        h0 = fleet.handle(0)
        held = h0.service._backlog
        t_kill = time.perf_counter()
        h0.kill()
        results = [fleet.result(j, timeout=600) for j in sub]
        fleet_check("procfleet", "kill -9", results, want)
        m = fleet.metrics()
        fl, recov = m["fleet"], m["recoveries"]
        if not fl["jobs_reseated"] or not recov or \
                recov[-1]["rto_s"] is None:
            fail("procfleet", f"kill -9: nothing re-seated or no RTO "
                 f"({fl}, {recov})")
        procfleet_wait("procfleet", fleet, lambda: fleet.metrics()[
            "fleet"]["replicas_relaunched"] >= 1, "the relaunch")
        if not fleet.wait_ready(timeout=300):
            fail("procfleet", "kill -9: the relaunched child not ready")
        relaunch_s = time.perf_counter() - t_kill
        say("procfleet", kind="kill9", algo=FLEET_ALGO, children=2,
            held_by_killed=held, equal=True, reseated=fl["jobs_reseated"],
            checkpoint_reseats=fl["reseat_checkpoint_hits"],
            cold_restarts=fl["reseat_cold_restarts"],
            rto_s=recov[-1]["rto_s"], relaunched=fl["replicas_relaunched"],
            relaunch_ready_s=relaunch_s, stalls=fl["replicas_stalled"],
            down_reason=h0.down_reason, nvidia_smi=smi)
        # the corrupt_artifact fault's own hand on every recipe; the
        # relaunched child (a fresh process) then loads the trace's
        arts = sorted(a for a in os.listdir(fleet.artifact_dir)
                      if a.endswith(".rnr"))
        for a in arts:
            fleet._inject("corrupt_artifact", Fault(
                kind="corrupt_artifact", cycle=0,
                path=os.path.join(fleet.artifact_dir, a)), time.monotonic())
        hr = fleet.handle(0)
        hr.service.prewarm([(f, FLEET_ALGO) for f in files])
        procfleet_wait("procfleet", fleet, lambda: procfleet_prewarmed(
            hr, 1), f"{hr.name}'s prewarm")
        stats = hr.service.cache.stats()
        rejected = stats.get("artifacts", {}).get("rejected_corrupt", 0)
        corrupted = fleet.metrics()["fleet"]["artifacts_corrupted"]
        if not corrupted or not rejected or stats["misses"] != 1:
            fail("procfleet", f"corrupt_artifact: {corrupted} of {arts} "
                 f"corrupted, {hr.name}'s cache {stats}")
        say("procfleet", kind="corrupt_artifact", child=hr.name,
            corrupted=corrupted, rejected_corrupt=rejected,
            rebuilt=stats["misses"], nvidia_smi=smi)
    finally:
        fleet.stop(drain=False)
    return k6


def procfleet_prewarmed(h, k):
    """True once child ``h`` reported ``k`` prewarms done (each prewarm
    loads its items' files, then builds or loads one runner)."""
    return h.service.counters.as_dict().get("prewarmed_runners", 0) >= k


def procfleet_burst_leg(smi, work, device, fleet, files):
    """The at-size burst through a process fleet (lanes SERVE_BIG_LANES)
    grown 1 → 2 → 4 children, the card's free memory and each child's
    reserve read at each size: replica-0 prewarms the family's first 8
    files (its runner exported to the artifact store), then every later
    child cold-joins — its prewarm rebuilds that runner from its recipe
    (misses 0, no ``nvcc`` run) before its first job — and every child
    loads the burst's PROCFLEET_BURST_PROBLEMS files in a prewarm
    (set-up, as the thread fleet's dcops are built before it; the
    children load in parallel).
    Then the burst at 1, 2 and 4 children (the rest partitioned).
    ``fleet`` started with replica-0 alone; ``files`` are the problems'
    YAML files."""
    jobs, sample, cut = fleet_burst_jobs(PROCFLEET_BURST_PROBLEMS,
                                         PROCFLEET_BURST_JOBS)
    want = {i: serve_sequential(jobs[i][0], "mgm", jobs[i][1],
                                SERVE_MAX_CYCLES, device) for i in sample}
    out = {}
    try:
        t0 = time.perf_counter()
        job_files = [files[i % PROCFLEET_BURST_PROBLEMS]
                     for i in range(len(jobs))]
        if not fleet.wait_ready(timeout=300):
            fail("procfleet", "burst: replica-0 not ready")
        fleet.start()
        procfleet_wait("procfleet", fleet, lambda: procfleet_reported(
            fleet), "replica-0's first report")
        time.sleep(PROCFLEET_REPORT_S)  # a report after the trace fleet
        memory = {1: procfleet_memory(fleet)}
        h0 = fleet.handle(0)
        fleet.prewarm([(f, "mgm") for f in files[:8]])
        procfleet_wait("procfleet", fleet,
                       lambda: procfleet_prewarmed(h0, 1),
                       "replica-0's prewarm")
        h0.service.prewarm([(f, "mgm") for f in files])
        joined, names = {}, []
        for k in (1, 2):
            names += [fleet.add_replica() for _ in range(k)]
            if not fleet.wait_ready(timeout=300):
                fail("procfleet", f"burst: {names} not ready")
            procfleet_wait("procfleet", fleet, lambda: procfleet_reported(
                fleet), "the joiners' first reports")
            time.sleep(PROCFLEET_REPORT_S)  # every child's, after the join
            memory[len(names) + 1] = procfleet_memory(fleet)
            for name in names[-k:]:
                fleet.handle(name).service.prewarm(
                    [(f, "mgm") for f in files])
        for name in names:
            h = fleet.handle(name)
            procfleet_wait("procfleet", fleet, lambda h=h:
                           procfleet_prewarmed(h, 1) and procfleet_reported(
                               fleet, "nvcc_runs"), f"{name}'s cold join")
            stats = h.service.cache.stats()
            joined[name] = dict(
                misses=stats["misses"],
                artifact_hits=stats.get("artifact_hits"),
                entries=stats["entries"],
                nvcc_runs=procfleet_children(fleet)[name]["nvcc_runs"])
            if stats["misses"] or joined[name]["nvcc_runs"] or \
                    stats.get("artifact_hits") != stats["entries"]:
                fail("procfleet", f"cold join of {name}: {joined[name]}")
        procfleet_wait("procfleet", fleet, lambda: procfleet_prewarmed(
            h0, 2), "replica-0's load of the family")
        load_s = time.perf_counter() - t0
        say("procfleet", kind="cold_join", joined=joined, setup_s=load_s,
            artifacts=fleet.metrics()["artifacts"], nvidia_smi=smi)
        order = ["replica-0"] + names
        for n in PROCFLEET_BURST_REPLICAS:
            procfleet_route_to(fleet, order[:n])
            results, row = fleet_replay(fleet, jobs, "mgm",
                                        [0.0] * len(jobs), job_files)
            fleet_check("procfleet", f"burst at {n} children",
                        [results[i] for i in sample],
                        [want[i] for i in sample])
            procfleet_wait("procfleet", fleet, lambda: procfleet_reported(
                fleet), "the children's reports")
            out[n] = row
            say("procfleet", kind="burst", algo="mgm", children=n,
                alive=len(order), vars=[SERVE_BIG_V, SERVE_BIG_V // 2],
                problems=PROCFLEET_BURST_PROBLEMS, lanes=SERVE_BIG_LANES,
                jobs_cut_from=PROCFLEET_BURST_JOBS if cut else None,
                checked=len(sample), equal=True,
                stalls=fleet.metrics()["fleet"]["replicas_stalled"],
                memory_at_spawn=memory.get(n),
                memory=procfleet_memory(fleet), **row, nvidia_smi=smi)
    finally:
        fleet.stop(drain=False)
    return out


def procfleet_phase(smi, device="cuda"):
    """The process fleet on the card (see procfleet_trace_leg and
    procfleet_burst_leg).  The kernels' libraries are built before any
    child starts (``cuda_build.build_all``), so no child runs ``nvcc``.
    Returns K6's launches by child."""
    import shutil
    import tempfile

    from pydcop_tpu_torch.ops import cuda_build

    from pydcop_tpu_torch.runtime.faults import FaultPlan
    from pydcop_tpu_torch.serve import ProcessFleet

    t0 = time.perf_counter()
    cuda_build.build_all()
    work = tempfile.mkdtemp(prefix="procfleet_")
    # both fleets' children start now, together, and the head writes
    # the burst's YAML files while they do
    t_spawn = time.perf_counter()
    fleets = [
        ProcessFleet(replicas=4, lanes=SERVE_LANES,
                     max_cycles=SERVE_MAX_CYCLES,
                     journal_dir=os.path.join(work, "trace_fleet"),
                     checkpoint_every=1, backoff_base=0.1,
                     fault_plan=FaultPlan(faults=[], seed=7), device=device),
        ProcessFleet(replicas=1, lanes=SERVE_BIG_LANES,
                     max_cycles=SERVE_MAX_CYCLES,
                     journal_dir=os.path.join(work, "burst_fleet"),
                     device=device)]
    try:
        files = write_yaml(big_problems()[:PROCFLEET_BURST_PROBLEMS], work,
                           "big")
        k6 = procfleet_trace_leg(smi, work, device, fleets[0], t_spawn)
        procfleet_burst_leg(smi, work, device, fleets[1], files)
    finally:
        for fleet in fleets:
            fleet.stop(drain=False)
        shutil.rmtree(work, ignore_errors=True)
    say("procfleet", kind="done",
        phase_s=round(time.perf_counter() - t0, 3),
        script_s=round(time.perf_counter() - SCRIPT_T0, 1))
    return k6



# -- resilience and the control plane -----------------------------------------

#: the colouring of the resilience phase (the 10k/30k of the main path)
RESIL_V, RESIL_E = 10_000, 30_000
#: the checkpointed solves: cycles, snapshot period, the restored cycle
RESIL_CYCLES = 200
RESIL_EVERY = 50
RESIL_RESTORE = 100
#: the orchestrator legs: agents (adhoc), replicas, cycles a phase, and
#: each agent's capacity as a multiple of the even share of the memory
#: (room for its own computations and k replicas of others)
RESIL_AGENTS = 200
RESIL_K = 3
RESIL_PHASE_CYCLES = 20
RESIL_CAPACITY = 5.0
#: the UI leg's scenario delays (seconds of solver activity)
RESIL_UI_DELAY = 0.3


def resil_dcop(algo):
    """The 10k/30k colouring with RESIL_AGENTS agents whose capacities
    leave room for the algorithm's computations and RESIL_K replicas."""
    from pydcop_tpu_torch.algorithms import load_algorithm_module
    from pydcop_tpu_torch.dcop import AgentDef
    from pydcop_tpu_torch.graph import load_graph_module

    dcop = coloring_dcop(RESIL_V, RESIL_E)
    mod = load_algorithm_module(algo)
    cg = load_graph_module(mod.GRAPH_TYPE).build_computation_graph(dcop)
    share = sum(mod.computation_memory(n) for n in cg.nodes) / RESIL_AGENTS
    dcop.add_agents([AgentDef(f"a{i:03d}", capacity=RESIL_CAPACITY * share)
                     for i in range(RESIL_AGENTS)])
    return dcop


def resil_state_equal(a, b):
    from pydcop_tpu_torch.runtime.checkpoint import flatten_state

    la, lb = flatten_state(a), flatten_state(b)
    return len(la) == len(lb) and all(
        torch_equal(x, y) for x, y in zip(la, lb))


def torch_equal(x, y):
    import torch

    return x.shape == y.shape and bool(torch.equal(x.cpu(), y.cpu()))


def resil_checkpoint_leg(smi, dcop, algo, counter, device, work):
    """Checkpointed solve_result (RESIL_CYCLES cycles, a snapshot every
    RESIL_EVERY), a straight run, and a fresh solver restored from the
    cycle-RESIL_RESTORE snapshot run to RESIL_CYCLES: its state must be
    ``torch.equal`` to the straight run's (dsa: its coin generator too).
    Returns the kernel's launches on the checkpointed run, the snapshot
    directory and the straight solver."""
    import torch

    from pydcop_tpu_torch.algorithms import AlgorithmDef, \
        load_algorithm_module
    from pydcop_tpu_torch.runtime import solve_result
    from pydcop_tpu_torch.runtime.checkpoint import (
        CheckpointManager,
        load_checkpoint,
        save_checkpoint,
    )

    mod = load_algorithm_module(algo)

    def fresh():
        return mod.build_solver(dcop, None, AlgorithmDef.build_with_default_params(
            algo, {}, mode=dcop.objective), seed=0, device=device)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    d = os.path.join(work, algo)
    reset_counts()
    res = solve_result(dcop, algo, cycles=RESIL_CYCLES, checkpoint_dir=d,
                       checkpoint_every=RESIL_EVERY, device=device)
    launches_ckpt = read_counts()[counter]
    mgr = CheckpointManager(d)
    snaps = [c for c, _ in mgr.snapshots()]
    if res.cycle != RESIL_CYCLES or RESIL_RESTORE not in snaps:
        fail("resilience", f"{algo}: checkpointed run ended at {res.cycle}"
             f" with snapshots {snaps}")
    straight = fresh()
    reset_counts()
    ref = straight.run(cycles=RESIL_CYCLES)
    launches_straight = read_counts()[counter]
    restored = fresh()
    sync()
    t = time.perf_counter()
    meta = load_checkpoint(mgr.path_for(RESIL_RESTORE), restored)
    sync()
    load_ms = (time.perf_counter() - t) * 1e3
    reset_counts()
    got = restored.run(cycles=RESIL_CYCLES - RESIL_RESTORE, resume=True)
    launches_restored = read_counts()[counter]
    if meta["cycle"] != RESIL_RESTORE \
            or not resil_state_equal(restored._last_state,
                                     straight._last_state) \
            or got.assignment != ref.assignment \
            or res.assignment != ref.assignment:
        fail("resilience", f"{algo}: the run restored at cycle "
             f"{RESIL_RESTORE} is not torch.equal to the straight run")
    extra = {}
    if algo == "maxsum":
        # the beliefs of one more cycle from each state (K1, outside the
        # counted runs)
        from pydcop_tpu_torch.ops.packed_maxsum import packed_cycles

        q1, r1, b1, v1 = packed_cycles(straight.packed, *straight._last_state[:2],
                                       1, damping=straight.damping)
        q2, r2, b2, v2 = packed_cycles(restored.packed, *restored._last_state[:2],
                                       1, damping=restored.damping)
        if not (torch_equal(b1, b2) and torch_equal(v1, v2)):
            fail("resilience", "maxsum: beliefs differ after the restore")
        extra["beliefs_equal"] = True
    if algo == "dsa":
        if not torch.equal(restored.coins.get_state(),
                           straight.coins.get_state()):
            fail("resilience", "dsa: the restored coin stream did not "
                 "continue to the straight run's")
        extra["generator_continued"] = True
    path = os.path.join(work, f"{algo}_save.npz")
    sync()
    t = time.perf_counter()
    save_checkpoint(path, straight, cycle=RESIL_CYCLES)
    save_ms = (time.perf_counter() - t) * 1e3
    # a card-written snapshot restores on the CPU too
    if device == "cuda":
        from pydcop_tpu_torch.algorithms import AlgorithmDef as AD

        cpu = mod.build_solver(dcop, None, AD.build_with_default_params(
            algo, {}, mode=dcop.objective), seed=0, device="cpu")
        load_checkpoint(path, cpu)
        if not resil_state_equal(cpu._last_state, straight._last_state):
            fail("resilience", f"{algo}: the card's snapshot restored on "
                 f"the CPU differs")
    say("resilience", kind="checkpoint", algo=algo, nvidia_smi=smi,
        engine=meta["extra"]["engine"], counter=counter,
        launches_checkpointed=launches_ckpt,
        launches_straight=launches_straight,
        launches_restored=launches_restored, snapshots=snaps,
        save_ms=round(save_ms, 3), load_ms=round(load_ms, 3),
        snapshot_bytes=os.path.getsize(path), state_equal=True,
        cost=ref.cost, **extra)
    return launches_ckpt, d, straight


def resil_fault_leg(smi, dcop, directory, straight, device):
    """A corrupt_checkpoint and a truncate_checkpoint fault on the newest
    snapshot: the manager skips it, and a resumed solve_result comes from
    the one before and ends at the straight run's state."""
    from pydcop_tpu_torch.runtime import solve_result
    from pydcop_tpu_torch.runtime.checkpoint import CheckpointManager
    from pydcop_tpu_torch.runtime.faults import (
        Fault,
        FaultPlan,
        apply_checkpoint_faults,
    )

    mgr = CheckpointManager(directory)
    newest = mgr.latest()[0]
    damaged = apply_checkpoint_faults(
        FaultPlan(faults=[Fault(kind="corrupt_checkpoint")], seed=3),
        directory, attempt=0)
    got = mgr.latest_valid_state()
    if len(damaged) != 1 or got is None or got[0] >= newest:
        fail("resilience", f"corrupt_checkpoint: damaged {damaged}, the "
             f"manager's newest valid snapshot {got and got[0]}")
    skipped_to = got[0]
    reset_counts()
    res = solve_result(dcop, "maxsum", cycles=RESIL_CYCLES,
                       checkpoint_dir=directory,
                       checkpoint_every=RESIL_EVERY, resume=True,
                       fault_plan=FaultPlan(faults=[
                           Fault(kind="truncate_checkpoint")], seed=5),
                       device=device)
    launches = read_counts()["packed_maxsum_cycle"]
    ref = straight.values_of(straight._last_state).cpu().numpy()
    want = straight.tensors.assignment_from_indices(ref)
    if res.cycle != RESIL_CYCLES or res.assignment != want:
        fail("resilience", "the resume past a truncated snapshot did not "
             "reach the straight run's assignment")
    say("resilience", kind="checkpoint_faults", nvidia_smi=smi,
        newest=newest, corrupt_skipped_to=skipped_to,
        resumed_cycles=RESIL_CYCLES - skipped_to, k1_launches=launches,
        assignment_equal=True)
    return launches


def resil_orchestrators(algo, device, twin=True):
    """The card's orchestrator (adhoc, RESIL_K replicas) and, with
    ``twin``, a CPU twin built on copies of its placement and replicas."""
    from pydcop_tpu_torch.distribution import Distribution
    from pydcop_tpu_torch.replication import ReplicaDistribution
    from pydcop_tpu_torch.runtime.orchestrator import VirtualOrchestrator

    t = time.perf_counter()
    card = VirtualOrchestrator(resil_dcop(algo), algo, distribution="adhoc",
                               device=device)
    build_s = time.perf_counter() - t
    card.deploy_computations()
    t = time.perf_counter()
    card.start_replication(RESIL_K)
    replication_s = time.perf_counter() - t
    if not twin:
        return card, None, build_s, replication_s
    cpu = VirtualOrchestrator(resil_dcop(algo), algo,
                              distribution=Distribution(
                                  card.distribution.mapping()),
                              device="cpu")
    cpu.deploy_computations()
    cpu.replicas = ReplicaDistribution(card.replicas.mapping())
    return card, cpu, build_s, replication_s


def resil_scenario(victim, delay):
    from pydcop_tpu_torch.dcop import DcopEvent, EventAction, Scenario

    return Scenario([
        DcopEvent("d1", delay=delay),
        DcopEvent("e1", actions=[EventAction("remove_agent", agent=victim)]),
        DcopEvent("d2", delay=delay)])


def resil_orchestrator_leg(smi, algo, counter, device):
    """VirtualOrchestrator on the 10k/30k colouring: a scenario removing
    one agent, RESIL_PHASE_CYCLES cycles a phase; the final cost and
    assignment must equal the CPU twin's.  Returns the kernel's launches
    and the repair's K4-mixed launches."""
    card, cpu, build_s, replication_s = resil_orchestrators(algo, device)
    victim = sorted(card.dcop.agents)[0]
    orphans = len(card.distribution.computations_hosted(victim))
    reset_counts()
    res = card.run(resil_scenario(victim, 3600.0), cycles=RESIL_PHASE_CYCLES)
    counts = read_counts()
    want = cpu.run(resil_scenario(victim, 3600.0), cycles=RESIL_PHASE_CYCLES)
    if res.cost != want.cost or res.assignment != want.assignment \
            or card.distribution.mapping() != cpu.distribution.mapping():
        fail("resilience", f"orchestrator {algo}: card cost {res.cost} != "
             f"CPU {want.cost} (or the placements differ)")
    rep = card.repair_log[0]
    # the repair DCOP's constraints have arity > 2: it packs (K4's mixed
    # branch) while every arity is at most 4, else the generic engine
    # runs it, with no kernel
    k4_mixed = counts["mgm_mixed"]
    engine = "K4 mixed" if k4_mixed else "generic (no kernel)"
    # (a CPU rehearsal launches no kernel)
    if device != "cpu" and (rep["max_arity"] <= 4) != (k4_mixed > 0):
        fail("resilience", f"orchestrator {algo}: the repair DCOP's widest "
             f"constraint has arity {rep['max_arity']}, yet K4's mixed "
             f"branch launched {k4_mixed} times")
    say("resilience", kind="orchestrator", algo=algo, nvidia_smi=smi,
        computations=len(card.cg.nodes), agents=RESIL_AGENTS, k=RESIL_K,
        build_s=round(build_s, 3), start_replication_ms=round(
            replication_s * 1e3, 3),
        victim=victim, orphans=orphans,
        repair_variables=rep["variables"],
        repair_constraints=rep["constraints"],
        repair_max_arity=rep["max_arity"],
        repair_build_ms=round(rep["build_s"] * 1e3, 3),
        repair_solve_ms=round(rep["solve_s"] * 1e3, 3),
        repair_engine=engine,
        phases=[{"cycles": p["cycles"], "ms": round(p["s"] * 1e3, 3)}
                for p in card.phase_log],
        launches={counter: counts[counter], "mgm_mixed": k4_mixed},
        cost=res.cost, cpu_cost=want.cost, equal_to_cpu=True)
    return counts[counter], k4_mixed


def ws_handshake(port):
    """A stdlib ws client's socket after the upgrade handshake."""
    import base64
    import socket

    from pydcop_tpu_torch.runtime.ws import _accept_key

    sock = socket.create_connection(("127.0.0.1", port), timeout=10)
    key = base64.b64encode(os.urandom(16)).decode()
    sock.sendall(
        f"GET / HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
        f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n"
        .encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        chunk = sock.recv(4096)
        if not chunk:
            fail("resilience", "ui: the ws handshake was cut")
        resp += chunk
    if _accept_key(key).encode() not in resp:
        fail("resilience", "ui: wrong Sec-WebSocket-Accept")
    return sock, resp.split(b"\r\n\r\n", 1)[1]


def free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def resil_ui_leg(smi, device):
    """One mgm orchestrator run whose scenario delays convert to cycles at
    the card's measured rate, with a UiServer: a stdlib ws client in this
    script receives the cycle events, and /state the end metrics.
    Returns K4's launches."""
    import http.client
    import threading

    from pydcop_tpu_torch.runtime import ws
    from pydcop_tpu_torch.runtime.events import event_bus
    from pydcop_tpu_torch.runtime.ui import UiServer

    card, _, _, _ = resil_orchestrators("mgm", device, twin=False)
    victim = sorted(card.dcop.agents)[1]
    ui = UiServer(port=free_port(), ws_port=free_port(), orchestrator=card)
    ui.start()
    got, done = [], threading.Event()
    try:
        sock, leftover = ws_handshake(ui.ws_port)
        reader = ws._BufferedSock(sock, leftover)
        t0 = time.perf_counter()
        while ui._ws.n_clients < 1:
            if time.perf_counter() - t0 > 10:
                fail("resilience", "ui: the ws client was not registered")
            time.sleep(0.01)

        def listen():
            while not done.is_set():
                opcode, payload = ws.read_frame(reader)
                if opcode is None:
                    return
                got.append(json.loads(payload.decode()))

        listener = threading.Thread(target=listen, daemon=True)
        listener.start()
        bus_was, event_bus.enabled = event_bus.enabled, True
        try:
            reset_counts()
            res = card.run(resil_scenario(victim, RESIL_UI_DELAY))
            k4 = read_counts()["mgm"]
        finally:
            event_bus.enabled = bus_was
        ui.update_state(**card.end_metrics())
        conn = http.client.HTTPConnection("127.0.0.1", ui.port, timeout=10)
        conn.request("GET", "/state")
        state = json.loads(conn.getresponse().read())
        conn.close()
        t0 = time.perf_counter()
        while not any(m.get("evt") == "cycle"
                      and m.get("cycles") == res.cycle for m in got):
            if time.perf_counter() - t0 > 10:
                fail("resilience", f"ui: no cycle event of {res.cycle} "
                     f"cycles reached the ws client")
            time.sleep(0.01)
    finally:
        done.set()
        ui.stop()
    cycles = [m["cycles"] for m in got if m.get("evt") == "cycle"]
    faults_seen = sorted({m["kind"] for m in got if m.get("evt") == "fault"})
    if state.get("cycle") != res.cycle or state.get("cost") != res.cost \
            or "recovered.repair" not in faults_seen:
        fail("resilience", f"ui: /state {state.get('cycle')}/"
             f"{state.get('cost')} against {res.cycle}/{res.cost}, fault "
             f"events {faults_seen}")
    say("resilience", kind="ui_orchestrator", nvidia_smi=smi,
        delay_s=RESIL_UI_DELAY,
        phases=[{"delay": p["delay"], "budget": p["budget"],
                 "cycles": p["cycles"], "ms": round(p["s"] * 1e3, 3)}
                for p in card.phase_log],
        cycle_events=cycles, fault_events=faults_seen,
        ws_messages=len(got), state_keys=sorted(state),
        packed_mgm_cycles=k4, cost=res.cost)
    return k4


def resilience_phase(smi, device="cuda"):
    """Resilience and the control plane on the card: checkpointed maxsum
    (K1), dsa (K5) and mgm (K4) solves == their straight runs, checkpoint
    faults, the orchestrator with replication and repair (== its CPU
    twin), and the UI server during a delay-driven run.  Returns the
    launches of K1, K4 (binary, mixed) and K5 on this path."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="resilience_")
    launches = {}
    try:
        dcop = coloring_dcop(RESIL_V, RESIL_E)
        for algo, counter in (("maxsum", "packed_maxsum_cycle"),
                              ("dsa", "dsa"), ("mgm", "mgm")):
            n, d, straight = resil_checkpoint_leg(smi, dcop, algo, counter,
                                                  device, work)
            launches[f"{algo}_checkpointed"] = n
            if algo == "maxsum":
                launches["maxsum_checkpoint_faults"] = resil_fault_leg(
                    smi, dcop, d, straight, device)
        for algo, counter in (("maxsum", "packed_maxsum_cycle"),
                              ("mgm", "mgm")):
            n, k4_mixed = resil_orchestrator_leg(smi, algo, counter, device)
            launches[f"orchestrator_{algo}"] = n
            launches[f"orchestrator_{algo}_repair_mixed"] = k4_mixed
        launches["orchestrator_mgm_ui"] = resil_ui_leg(smi, device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # on the card every leg but the repairs runs K1, K4 or K5 (the legs
    # check the repairs' K4-mixed launches against their arity)
    idle = sorted(leg for leg, n in launches.items()
                  if n == 0 and not leg.endswith("_repair_mixed"))
    if idle and device != "cpu":
        fail("resilience", f"{idle}: the path's kernel was launched no "
             f"time")
    say("resilience", kind="done", nvidia_smi=smi, launches=launches,
        phase_s=round(time.perf_counter() - t0, 3),
        script_s=round(time.perf_counter() - SCRIPT_T0, 1))
    return launches



# -- the compact collectives and the generic sharded engine -----------------

#: the compact phase's overlap modes: name -> (overlap, exchange)
COMPACT_MODES = {"off": ("off", None), "exact": ("exact", False),
                 "stale": ("stale", None), "exchange": ("exact", True)}
#: cycles of the phase's timed card runs (their launches counted), of the
#: stale runs held to their CPU twins, and of the launch-by-launch checks
#: of K7, K8 and K9 in each compact mode
COMPACT_CYCLES, COMPACT_CPU_CYCLES, COMPACT_CHECK_CYCLES = 200, 10, 4
#: cycles of the generic engines' runs, on the card and on the CPU
COMPACT_GENERIC_CYCLES = 100
#: the phase's colourings (the main path's 10k/30k; the ring lattice is
#: COMPACT_V variables) and the SECP's scale (1: SECP4-3.9k)
COMPACT_V, COMPACT_E, COMPACT_SECP_SCALE = 10_000, 30_000, 1
#: the generic maxsum's colouring: D = 10, out of the packers' scope
COMPACT_D10 = 10
#: the CLI leg's colouring
COMPACT_CLI_V, COMPACT_CLI_E = 1_000, 3_000
#: the library's stale placement solve at SHARDS shards, with per-cycle
#: metrics (one cycle a chunk) and without
COMPACT_STALE_CYCLES = 30
#: the sharded kernels' counters → their rows of the kernels line
COMPACT_ROWS = {
    "device_fused_ba": "packed_shard_fused_ba",
    "device_fused_ba_act": "packed_shard_fused_ba_act",
    "device_fused_ba_mixed": "packed_shard_fused_ba_mixed",
    "device_fused_ba_mixed_act": "packed_shard_fused_ba_mixed_act",
    "device_mgm_move": "packed_shard_route_gains",
    "device_mgm_move_mixed": "packed_shard_route_gains_mixed",
    "device_tables": "packed_shard_tables",
    "device_tables_mixed": "packed_shard_tables_mixed"}


def device_us_per_cycle(run, cycles, tries=2):
    """The device time of every kernel ``run()`` launches (torch.profiler's
    self device time, so a kernel is counted once), per cycle; None when
    no trace holds device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()  # warm-up
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        total = sum(getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
                    for e in prof.key_averages())
        if total:
            return total / cycles
    return None


def compact_want(algo, mixed, groups, cycles):
    """The launches of a ``cycles``-cycle sharded run on the card: one K7
    (or K9) a group a cycle, and mgm's K8 once a cycle over one group or
    twice a group (its "max" and "min" modes) over two."""
    tail = "_mixed" if mixed else ""
    if algo in ("maxsum", "amaxsum"):
        act = "_act" if algo == "amaxsum" else ""
        key = "device_fused_ba" + (tail + act if mixed else act)
        return {key: groups * cycles}
    want = {"device_tables" + tail: groups * cycles}
    if algo == "mgm":
        want["device_mgm_move" + tail] = (1 if groups == 1 else 4) * cycles
    return want


def compact_engine(t, mesh, algo, mode):
    from pydcop_tpu_torch.parallel import ShardedLocalSearch, ShardedMaxSum

    overlap, exchange = COMPACT_MODES[mode]
    if algo in ("maxsum", "amaxsum"):
        return ShardedMaxSum(t, mesh, damping=0.5, overlap=overlap,
                             exchange=exchange,
                             activation=0.7 if algo == "amaxsum" else None)
    params = {"activation": 0.7, "variant": "B"} if algo == "adsa" else None
    return ShardedLocalSearch(t, mesh, rule=algo, algo_params=params,
                              overlap=overlap, exchange=exchange)


def compact_run(eng, cycles):
    """(values, beliefs or None) of a fresh ``cycles``-cycle run."""
    if hasattr(eng, "beliefs"):
        values, q, _ = eng.run(cycles, seed=0)
        return values, eng.beliefs(q)
    return eng.run(cycles, seed=0), None


def compact_packed_leg(smi, name, t_dev, t_cpu, algos, device):
    """The packed engines on one graph at 8 shards, in one group (as on
    one card: the launches combine the shards) and in two
    (:func:`split_groups`: the launches write partials, the boundary
    columns cross), each algorithm in every overlap mode (the exchange on
    a pairwise cut): K7, K8 and K9 launch by launch against their plain
    versions (:func:`sharded_kernel_vs_plain`), the launches of a
    COMPACT_CYCLES run, exact and the exchange ``torch.equal`` to off
    (values and the owner-reconciled beliefs), stale ``torch.equal`` to
    its CPU twin; cycles/s, and (``algos["profile"]``) for maxsum and
    mgm the device us a cycle.  Returns (the launches by kernel row and
    path, cycles/s by (algo, mode, groups))."""
    import contextlib
    from unittest import mock

    import torch

    from pydcop_tpu_torch.parallel import build_mesh, packed_mesh

    mesh, cpu_mesh = build_mesh(SHARDS, device), build_mesh(SHARDS, "cpu")
    by_row, rates = {}, {}
    for groups in (1, 2):
        split = groups == 2
        grouping = (mock.patch.object(packed_mesh, "_device_groups",
                                      split_groups) if split
                    else contextlib.nullcontext())
        with grouping:
            pairwise = compact_engine(t_dev, mesh, "maxsum", "off") \
                .comm.info.pairwise
        modes = [m for m in COMPACT_MODES if pairwise or m != "exchange"]
        for mode in modes:
            if mode == "off":
                continue
            t0 = time.perf_counter()
            overlap, exchange = COMPACT_MODES[mode]
            try:
                errs, _ = sharded_kernel_vs_plain(
                    t_dev, SHARDS, COMPACT_CHECK_CYCLES, split=split,
                    overlap=overlap, exchange=exchange, dampings=(0.5,))
            except AssertionError as e:
                fail("sharded_compact", f"{name} {mode} in {groups} "
                     f"groups: {e}")
            if device != "cpu" and len(errs) < 4:
                fail("sharded_compact", f"{name} {mode}: only "
                     f"{sorted(errs)} were checked")
            say("sharded_compact", kind="kernel_vs_plain", instance=name,
                groups=groups, mode=mode, cycles=COMPACT_CHECK_CYCLES,
                max_abs_err=errs, seconds=round(time.perf_counter() - t0, 3))
        for algo in algos["algos"]:
            off = None
            for mode in modes:
                with grouping:
                    eng = compact_engine(t_dev, mesh, algo, mode)
                    reset_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    values, bel = compact_run(eng, COMPACT_CYCLES)
                    torch.cuda.synchronize()
                    run_s = time.perf_counter() - t0
                    counts = {k: v for k, v in read_counts().items() if v}
                    want = compact_want(algo, eng.packs.mixed, groups,
                                        COMPACT_CYCLES)
                    if device != "cpu" and counts != want:
                        fail("sharded_compact", f"{name} {algo} {mode} in "
                             f"{groups} groups: launches {counts}, "
                             f"expected {want}")
                    for k, n in counts.items():
                        by_row.setdefault(COMPACT_ROWS[k], {})[
                            f"sharded_compact_{name}_{algo}_{mode}_"
                            f"{groups}g"] = n
                    check = {}
                    if mode == "off":
                        off = (values, bel)
                    elif mode in ("exact", "exchange"):
                        same = np.array_equal(values, off[0]) and (
                            bel is None or torch.equal(bel, off[1]))
                        if not same:
                            fail("sharded_compact", f"{name} {algo} {mode}"
                                 f" in {groups} groups differs from off")
                        check["equal_to_off"] = True
                    else:
                        card = compact_run(eng, COMPACT_CPU_CYCLES)
                        cpu = compact_run(compact_engine(
                            t_cpu, cpu_mesh, algo, mode), COMPACT_CPU_CYCLES)
                        same = np.array_equal(card[0], cpu[0]) and (
                            card[1] is None
                            or torch.equal(card[1].cpu(), cpu[1]))
                        if not same:
                            fail("sharded_compact", f"{name} {algo} stale "
                                 f"in {groups} groups differs from its "
                                 f"CPU run")
                        check["equal_to_cpu"] = True
                        check["cpu_cycles"] = COMPACT_CPU_CYCLES
                    rates[algo, mode, groups] = COMPACT_CYCLES / run_s
                    if algos.get("profile") and algo in ("maxsum", "mgm") \
                            and mode != "exchange" and device != "cpu":
                        check["device_us_per_cycle"] = device_us_per_cycle(
                            lambda eng=eng: compact_run(eng, 20), 20)
                    stats = eng.comm_stats()
                say("sharded_compact", instance=name, algo=algo, mode=mode,
                    groups=groups, S=SHARDS, pairwise=pairwise,
                    comm_mode=stats["mode"], collective=stats["collective"],
                    cut_fraction=stats["cut_fraction"],
                    boundary_columns=stats["boundary_columns"],
                    total_columns=stats["total_columns"],
                    bytes_per_cycle_dense=stats["bytes_per_cycle_dense"],
                    bytes_per_cycle_compact=stats["bytes_per_cycle_compact"],
                    exchange_rounds=stats["exchange_rounds"],
                    cycles=COMPACT_CYCLES, launches=counts,
                    cycles_per_s=COMPACT_CYCLES / run_s, **check,
                    nvidia_smi=smi)
    return by_row, rates


def compact_generic_leg(smi, device, packed_rates):
    """The generic sharded engine on the card at 8 shards: maxsum on a
    D = 10 colouring (which the packers decline), mgm, dba and gdba on the
    10k/30k CSP with ``use_packed=False``; each COMPACT_GENERIC_CYCLES
    cycles, values equal to the CPU run (dba/gdba's weights too), no
    kernel of the port launched; cycles/s beside the packed engine's."""
    import torch

    from pydcop_tpu_torch.ops.compile import compile_constraint_graph
    from pydcop_tpu_torch.parallel import ShardedLocalSearch, \
        ShardedMaxSum, build_mesh

    from pydcop_tpu_torch.ops.compile import compile_binary_from_arrays

    rng = np.random.default_rng(5)
    V, D = COMPACT_V, COMPACT_D10
    ei, ej, _, _ = coloring_arrays(V, COMPACT_E)
    mats = rng.uniform(0.0, 1.0, (ei.size, D, D)).astype(np.float32)
    mats += np.eye(D, dtype=np.float32) * 3.0
    unary = rng.uniform(0.0, 0.01, (V, D)).astype(np.float32)
    d10 = [compile_binary_from_arrays(ei, ej, mats, V, unary=unary,
                                      device=dv) for dv in (device, "cpu")]
    csp = coloring_csp_dcop(V, COMPACT_E)
    cg = [compile_constraint_graph(csp, device=dv) for dv in (device, "cpu")]
    meshes = [build_mesh(SHARDS, device), build_mesh(SHARDS, "cpu")]
    rows = {}
    size = f"{V // 1000}k_{COMPACT_E // 1000}k"
    cases = [("maxsum", f"coloring_d10_{size}", d10)] + [
        (rule, f"coloring_csp_{size}", cg) for rule in ("mgm", "dba",
                                                        "gdba")]
    for algo, inst, ts in cases:
        engs = []
        for t, mesh in zip(ts, meshes):
            if algo == "maxsum":
                engs.append(ShardedMaxSum(t, mesh, damping=0.5))
            else:
                engs.append(ShardedLocalSearch(t, mesh, rule=algo,
                                               use_packed=False))
        if engs[0].st is None:
            fail("sharded_compact", f"generic {algo}: the packed engine ran")
        out = []
        for eng in engs:
            reset_counts()
            if eng.mesh[0].type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            if algo == "maxsum":
                values, q, r = eng.run(COMPACT_GENERIC_CYCLES)
                extra = eng.state_to_host(q, r)
            else:
                values, x, aux = eng.run_chunked(COMPACT_GENERIC_CYCLES,
                                                 seed=0)
                extra = {f"w{i}": w for i, w in enumerate(
                    eng.aux_numpy(aux))}
            if eng.mesh[0].type == "cuda":
                torch.cuda.synchronize()
            out.append((values, extra, time.perf_counter() - t0,
                        {k: v for k, v in read_counts().items() if v}))
        (vc, ec, sc, counts), (vp, ep, sp, _) = out
        if counts:
            fail("sharded_compact", f"generic {algo}: launches {counts}: the "
                 f"generic engine launches no kernel of the port")
        if not np.array_equal(vc, vp):
            fail("sharded_compact", f"generic {algo} on {inst}: "
                 f"{int((vc != vp).sum())} values differ from the CPU run")
        state_equal = all(np.array_equal(ec[k], ep[k]) for k in ec)
        if algo != "maxsum" and not state_equal:
            fail("sharded_compact", f"generic {algo}: the breakout weights "
                 f"differ from the CPU run")
        rows[algo] = COMPACT_GENERIC_CYCLES / sc
        stats = engs[0].comm_stats()
        say("sharded_compact", kind="generic", algo=algo, instance=inst,
            S=SHARDS, D=engs[0].base.max_domain_size,
            cycles=COMPACT_GENERIC_CYCLES, equal_to_cpu=True,
            state_equal_to_cpu=state_equal, comm_mode=stats["mode"],
            cut_fraction=stats["cut_fraction"],
            cycles_per_s=rows[algo], cpu_cycles_per_s=
            COMPACT_GENERIC_CYCLES / sp,
            packed_cycles_per_s=packed_rates.get(algo), nvidia_smi=smi)
    return rows


def compact_cli_leg(smi, device):
    """``solve -d placement.yaml --shard-overlap exact`` and ``stale``
    through the CLI, both commands at once: the result's
    ``metrics()["shard"]`` names the compact mode (one shard a visible
    device: the one card's single shard has no boundary, so stale runs
    as exact, as in the JAX package) and the assignment equals the
    library's solve of the same placement and mode.  Then the library at
    SHARDS shards on the card, stale, with and without per-cycle metrics:
    ``compact-stale`` both, the same assignment."""
    import shutil
    import tempfile

    from pydcop_tpu_torch.distribution import yaml_dist
    from pydcop_tpu_torch.runtime import solve_result

    work = tempfile.mkdtemp(prefix="compact_cli_")
    try:
        dcop = coloring_dcop(COMPACT_CLI_V, COMPACT_CLI_E, seed=3)
        [prob] = write_yaml([dcop], work, "prob")
        dist = block_distribution(dcop, SHARDS)
        placement = os.path.join(work, "placement.yaml")
        with open(placement, "w", encoding="utf-8") as f:
            f.write(yaml_dist(dist))
        modes = ("exact", "stale")
        procs = run_all([[sys.executable, "-m", "pydcop_tpu_torch", "solve",
                          "-a", "maxsum", "--device", device, "--cycles",
                          "100", "-d", placement, "--shard-overlap", m,
                          prob] for m in modes], timeout=600)
        for mode, (rc, stdout, stderr) in zip(modes, procs):
            try:
                out = json.loads(stdout)
            except ValueError:
                fail("sharded_compact", f"CLI {mode}: rc={rc} no JSON; "
                     f"stderr: {stderr[-2000:]}")
            lib = solve_result(dcop, "maxsum", distribution=dist,
                               cycles=100, shard_overlap=mode, device=device)
            shard = out.get("shard") or {}
            if rc != 0 or out.get("status") != "FINISHED" \
                    or not shard.get("mode", "").startswith("compact-") \
                    or shard != lib.metrics()["shard"] \
                    or out.get("assignment") != lib.assignment:
                fail("sharded_compact", f"CLI {mode}: rc={rc} status="
                     f"{out.get('status')} shard={shard} (library "
                     f"{lib.metrics()['shard']}) error={out.get('error')}")
            say("sharded_compact", kind="cli", overlap=mode,
                shard=shard, cost=out["cost"], cycle=out["cycle"],
                equal_to_library=True, nvidia_smi=smi)
        # the library at SHARDS shards on the card, where stale has a
        # halo; per-cycle metrics run it one cycle a chunk, and the halo
        # goes on across the chunks: the same run as one dispatch
        runs = [solve_result(dcop, "maxsum", distribution=dist,
                             cycles=COMPACT_STALE_CYCLES, n_shards=SHARDS,
                             shard_overlap="stale", collect_cycles=c,
                             device=device) for c in (False, True)]
        shard = [r.metrics()["shard"] for r in runs]
        if [s_["mode"] for s_ in shard] != ["compact-stale"] * 2 \
                or runs[0].assignment != runs[1].assignment \
                or len(runs[1].history or ()) != COMPACT_STALE_CYCLES:
            fail("sharded_compact", f"library stale at {SHARDS} shards: "
                 f"modes {[s_['mode'] for s_ in shard]}, chunked run "
                 f"equal: {runs[0].assignment == runs[1].assignment}")
        say("sharded_compact", kind="library_stale", n_shards=SHARDS,
            shard=shard[1], cost=runs[1].cost, cycle=runs[1].cycle,
            per_cycle_equal_to_one_dispatch=True, nvidia_smi=smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def sharded_compact_phase(smi, device="cuda"):
    """The compact collectives and the generic sharded engine on the card:
    :func:`compact_packed_leg` on the 10k/30k colouring (maxsum, amaxsum,
    mgm, dsa, adsa), on SECP4-3.9k (mixed: the same five) and on a
    10k-variable ring lattice (pairwise, so the exchange runs: maxsum and
    mgm), then :func:`compact_generic_leg` and :func:`compact_cli_leg`.
    Returns the launches by kernel row and path."""
    from pydcop_tpu_torch.ops.compile import compile_binary_from_arrays, \
        compile_factor_graph

    t0 = time.perf_counter()
    V, E = COMPACT_V, COMPACT_E
    size = f"{V // 1000}k_{E // 1000}k"
    ei, ej, mats, un = coloring_arrays(V, E)
    rei, rej, rmats, _ = ring_lattice(V, 3, seed=41)
    secp4 = secp_dcop(COMPACT_SECP_SCALE, 3)
    five = ("maxsum", "amaxsum", "mgm", "dsa", "adsa")
    graphs = {
        f"coloring_{size}": ([compile_binary_from_arrays(
            ei, ej, mats, V, unary=un, device=dv)
            for dv in (device, "cpu")], {"algos": five, "profile": True}),
        f"secp4_{3.9 * COMPACT_SECP_SCALE:g}k": (
            [compile_factor_graph(secp4, device=dv)
             for dv in (device, "cpu")], {"algos": five}),
        f"ring_lattice_{V // 1000}k": ([compile_binary_from_arrays(
            rei, rej, rmats, V, device=dv) for dv in (device, "cpu")],
            {"algos": ("maxsum", "mgm")}),
    }
    by_row, packed_rates = {}, {}
    for name, ((t_dev, t_cpu), algos) in graphs.items():
        rows, rates = compact_packed_leg(smi, name, t_dev, t_cpu, algos,
                                         device)
        for row, paths in rows.items():
            by_row.setdefault(row, {}).update(paths)
        if algos.get("profile"):
            packed_rates = {a: rates[a, "off", 1] for a, _, g in rates
                            if g == 1}
    generic = compact_generic_leg(smi, device, packed_rates)
    compact_cli_leg(smi, device)
    say("sharded_compact", kind="done", generic_cycles_per_s=generic,
        phase_s=round(time.perf_counter() - t0, 3),
        script_s=round(time.perf_counter() - SCRIPT_T0, 1), nvidia_smi=smi)
    return by_row


def main():
    try:
        import torch
    except ImportError as e:
        fail("device", f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("device", "no CUDA device visible (torch.cuda.is_available() "
             "is false)")
    if not os.path.isdir(os.path.join(ROOT, "pydcop_tpu_torch")):
        fail("device", "pydcop_tpu_torch/ not found beside chip_smoke.py: "
             "run from the root of a checkout")
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    from pydcop_tpu_torch.ops import cuda_build
    from pydcop_tpu_torch.ops.compile import compile_binary_from_arrays
    from pydcop_tpu_torch.ops.packed_local_search import pack_from_pg
    from pydcop_tpu_torch.ops.packed_maxsum import mixed_work, pack_for_gpu
    from pydcop_tpu_torch.algorithms.base import default_chunk
    from pydcop_tpu_torch.ops.packed_mgm2 import pack_mgm2_from_pls
    from pydcop_tpu_torch.runtime import solve_result

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device + build ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    if sys.argv[1:2] == ["--ab"]:
        # python3 chip_smoke.py --ab PARENT_TREE [SECTIONS]: the A/B of
        # K1 binary, of K1-mixed, of K6, of K4, of K5, of K10 and of the
        # sharded kernels (SECTIONS, comma-separated, default all), no
        # other phase, no result lines
        sections = (sys.argv[3].split(",") if len(sys.argv) > 3
                    else AB_SECTIONS)
        if not set(sections) <= set(AB_SECTIONS):
            fail("ab_kernels", f"sections {sections}: not in {AB_SECTIONS}")
        say("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0))
        ab_kernels(os.path.abspath(sys.argv[2]), sections)
        print(smi, flush=True)
        return
    build_s = cuda_build.build_all()
    ptxas = " | ".join(
        ln.strip() for log in cuda_build.build_logs.values()
        for ln in log.splitlines() if "registers" in ln or "spill" in ln)
    say("device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), build_s=round(build_s, 3),
        ptxas=ptxas)
    if sys.argv[1:2] == ["--phases"]:
        # python3 chip_smoke.py --phases fleet,procfleet: those phases
        # alone, no kernel check and no result lines
        phases = {"fleet": fleet_phase, "procfleet": procfleet_phase,
                  "resilience": resilience_phase,
                  "sharded_compact": sharded_compact_phase}
        for name in sys.argv[2].split(","):
            if name not in phases:
                fail("phases", f"{name}: not in {sorted(phases)}")
            phases[name](smi)
        print(smi, flush=True)
        return

    phase_seconds("build")
    # 2. kernels against their plain versions, on the card ----------------
    ei, ej, mats, un = coloring_arrays(10_000, 30_000)
    primary_t = compile_binary_from_arrays(ei, ej, mats, 10_000, unary=un,
                                           device=dev)
    primary = pack_for_gpu(primary_t)
    cases = {
        "coloring_10k_30k": primary,
        "star_deg2500": pack_for_gpu(star_tensors(2500, dev)),
        "unequal_domains_d4": pack_for_gpu(
            unequal_domains_tensors(5000, 15_000, 4, dev)),
    }
    main_err = 0.0

    def k1_checks(name, pg):
        """K1 binary on ``pg``: 20 cycles at damping 0.5 and 0 (the error
        and tie counts), then every grid and cycle count of
        k1_binary_vs_plain, all equal to the plain version."""
        nonlocal main_err
        if pg is None:
            fail("kernel_vs_plain", f"{name} did not pack")
        for damping in (0.5, 0.0):
            try:
                err, ties = kernel_vs_plain(pg, damping, exact=True)
            except AssertionError as e:
                fail("kernel_vs_plain", f"{name} damping={damping}: {e}")
            if name == "coloring_10k_30k":
                main_err = max(main_err, err)
            say("kernel_vs_plain", case=name, damping=damping, D=pg.D,
                N=pg.N, Vp=pg.Vp, max_deg=int(pg.col_deg.max()),
                blocks=k1_grid(pg), max_abs_err=err,
                near_tie_value_diffs=ties)
        try:
            runs = k1_binary_vs_plain(pg)
        except AssertionError as e:
            fail("kernel_vs_plain", f"{name} grids/cycles: {e}")
        say("kernel_vs_plain", case=name, grids=list(COOP_GRIDS),
            cycles=list(K1_CHECK_CYCLES), dampings=[0.5, 0.0], runs=runs,
            equal=True)

    for name, pg in cases.items():
        k1_checks(name, pg)

    cases["hard_coloring_10k_30k"] = pack_for_gpu(
        hard_coloring_tensors(10_000, 30_000, dev))
    ls_err = 0.0
    for name, pg in cases.items():
        try:
            err, stats = ls_kernel_vs_plain(pack_from_pg(pg))
        except AssertionError as e:
            fail("ls_kernel_vs_plain", f"{name}: {e}")
        ls_err = max(ls_err, err)
        say("ls_kernel_vs_plain", case=name, D=pg.D, N=pg.N, Vp=pg.Vp,
            max_deg=int(pg.col_deg.max()), max_abs_err=err, cycles=20,
            **stats)
    if cases["hard_coloring_10k_30k"] is not None and not stats["lateral"]:
        fail("ls_kernel_vs_plain", "the hard instance fired no lateral "
             "move: variant B's rule went unchecked")
    try:
        runs = mgm_tie_vs_plain()
    except AssertionError as e:
        fail("ls_kernel_vs_plain", f"MGM near ties: {e}")
    say("ls_kernel_vs_plain", case="mgm_near_ties", kinds=list(MGM_TIE_KINDS),
        runs=runs, equal=True)
    try:
        runs = dsa_nudge_vs_plain()
    except AssertionError as e:
        fail("ls_kernel_vs_plain", f"DSA nudge instances: {e}")
    say("ls_kernel_vs_plain", case="dsa_nudge", kinds=list(DSA_NUDGE_KINDS),
        rules=list(DSA_RULES), runs=runs, equal=True)

    big_arrays = coloring_arrays(100_000, 300_000)
    big_t = compile_binary_from_arrays(
        *big_arrays[:3], 100_000, unary=big_arrays[3], device=dev)
    big = pack_for_gpu(big_t)
    k1_checks("hard_coloring_10k_30k", cases["hard_coloring_10k_30k"])
    k1_checks("coloring_100k_300k", big)
    mgm2_err = 0.0
    for name, pg in list(cases.items()) + [("coloring_100k_300k", big)]:
        pm = pack_mgm2_from_pls(pack_from_pg(pg))
        try:
            err, stats = mgm2_kernel_vs_plain(pm)
        except AssertionError as e:
            fail("mgm2_kernel_vs_plain", f"{name}: {e}")
        mgm2_err = max(mgm2_err, err)
        say("mgm2_kernel_vs_plain", case=name, D=pg.D, N=pg.N, Vp=pg.Vp,
            max_deg=int(pg.col_deg.max()), max_abs_err=err,
            cycles=MGM2_CHECK_CYCLES, **stats)
    for mixed in (False, True):
        try:
            runs = mgm2_tie_vs_plain(mixed)
        except AssertionError as e:
            fail("mgm2_kernel_vs_plain", f"near ties (mixed={mixed}): {e}")
        say("mgm2_kernel_vs_plain", case="near_ties",
            layout="mixed" if mixed else "binary",
            kinds=list(MGM2_TIE_KINDS), runs=runs, equal=True)

    dpop_cases = {
        "bench_tree_10k": lambda: bench_tree_dcop(10_000),
        "bench_tree_100k": lambda: bench_tree_dcop(100_000),
        "forest_3k": lambda: tree_dcop(3000, seed=3, forest=True),
        "ragged_3k": lambda: tree_dcop(3000, D=5, seed=4, ragged=True),
        "max_3k": lambda: tree_dcop(3000, seed=5, objective="max"),
    }
    dpop_packed = {}
    dpop_err = 0.0
    for name, build in dpop_cases.items():
        t0 = time.perf_counter()
        dcop = build()
        build_s = time.perf_counter() - t0
        tree, plan, ps = dpop_pack(dcop, dev)
        prep_s = time.perf_counter() - t0 - build_s
        if ps is None:
            fail("dpop_kernel_vs_plain", f"{name} did not pack")
        try:
            err = dpop_kernel_vs_plain(plan, ps)
        except AssertionError as e:
            fail("dpop_kernel_vs_plain", f"{name}: {e}")
        dpop_err = max(dpop_err, err)
        if name.startswith("bench"):
            dpop_packed[name] = (dcop, ps, plan)
        say("dpop_kernel_vs_plain", case=name, n_nodes=ps.n_nodes, D=ps.D,
            L=ps.L, Bmax=plan.Bmax, max_children=ps.max_children,
            roots=len(tree.roots), mode=ps.mode, blocks=dpop_grid(ps),
            grids=list(COOP_GRIDS), max_abs_err=err,
            build_dcop_s=round(build_s, 3),
            tree_compile_pack_s=round(prep_s, 3))
        del tree, plan, ps

    # the mixed-arity layouts (unary to quaternary factors): K1's mixed
    # branch and the mixed branches of K2/K4/K5 against their plain versions
    from pydcop_tpu_torch.ops.compile import compile_factor_graph

    mixed_builds = {
        "secp_3.9k": lambda: secp_dcop(1, 2),
        "secp4_3.9k": lambda: secp_dcop(1, 3),
        f"secp4_{39 * SECP_BIG_SCALE // 10}k": lambda: secp_dcop(
            SECP_BIG_SCALE, 3),
        "mixed_star_deg2500": lambda: mixed_dcop(
            3401, 3, {1: 100, 2: 1400, 3: 1000}, seed=11, hub=True),
        "ragged_mixed_d4": lambda: mixed_dcop(
            6000, 4, {1: 1000, 2: 6000, 3: 3000, 4: 500}, seed=12,
            ragged=True),
    }
    mixed_dcops, mixed_pgs = {}, {}
    mixed_err = mixed_ls_err = mixed_mgm2_err = 0.0
    pair_moves = 0
    for name, build in mixed_builds.items():
        t0 = time.perf_counter()
        dcop = build()
        build_s = time.perf_counter() - t0
        pg = pack_for_gpu(compile_factor_graph(dcop, device=dev))
        prep_s = time.perf_counter() - t0 - build_s
        if pg is None or pg.mixed is None:
            fail("mixed_kernel_vs_plain", f"{name} did not take the mixed "
                 f"layout")
        mixed_dcops[name], mixed_pgs[name] = dcop, pg
        slots = [int(sl.numel()) for sl in pg.mixed.slots]
        for damping in (0.5, 0.0):
            try:
                err, ties = kernel_vs_plain(pg, damping, exact=True)
            except AssertionError as e:
                fail("mixed_kernel_vs_plain", f"{name} damping={damping}: "
                     f"{e}")
            mixed_err = max(mixed_err, err)
            say("mixed_kernel_vs_plain", kernel="packed_maxsum_mixed_cycle",
                case=name, damping=damping, D=pg.D, N=pg.N, Vp=pg.Vp,
                slots_by_arity=slots, max_deg=int(pg.col_deg.max()),
                units=mixed_work(pg), blocks=mixed_launch_blocks(pg),
                equal=True, max_abs_err=err, near_tie_value_diffs=ties,
                build_dcop_s=round(build_s, 3),
                compile_pack_s=round(prep_s, 3))
        try:
            err, stats = ls_kernel_vs_plain(pack_from_pg(pg))
        except AssertionError as e:
            fail("mixed_kernel_vs_plain", f"{name} local search: {e}")
        mixed_ls_err = max(mixed_ls_err, err)
        say("mixed_kernel_vs_plain", kernel="local_search_mixed", case=name,
            D=pg.D, N=pg.N, Vp=pg.Vp, max_abs_err=err, cycles=20, **stats)
        pm = pack_mgm2_from_pls(pack_from_pg(pg))
        if pm is None:
            fail("mgm2_kernel_vs_plain", f"{name}: no binary factor to pair")
        try:
            err, stats = mgm2_mixed_vs_plain(pm)
        except AssertionError as e:
            fail("mgm2_kernel_vs_plain", f"{name} (mixed): {e}")
        mixed_mgm2_err = max(mixed_mgm2_err, err)
        pair_moves += sum(v.get("pair_moves", 0) for v in stats.values()
                          if isinstance(v, dict))
        say("mgm2_kernel_vs_plain", layout="mixed", case=name, D=pg.D,
            N=pg.N, Vp=pg.Vp, binary_slots=int(pm.deg_col.sum()),
            max_abs_err=err, cycles=MGM2_CHECK_CYCLES, threshold=0.5,
            **stats)
    if not pair_moves:
        fail("mgm2_kernel_vs_plain", "no mixed graph made a pair move: the "
             "pairing of the mixed branch went unchecked")

    # K7, K8 and K9 (one launch per cycle over the card's group of shards)
    # against their plain versions, launch by launch inside real sharded
    # runs on the card, exactly; "split": the shards in two groups on the
    # card, so K7 and K9 write partials and K8 runs its "max" and "min"
    # modes
    sharded_cases = {
        "coloring_10k_30k": (primary_t, SHARDS, False),
        "coloring_10k_30k_split": (primary_t, SHARDS, True),
        "coloring_100k_300k": (big_t, SHARDS, False),
        "star_deg2500": (star_tensors(2500, dev), 4, False),
        "unequal_domains_d4": (
            unequal_domains_tensors(5000, 15_000, 4, dev), 4, False),
        "hard_coloring_10k_30k": (
            hard_coloring_tensors(10_000, 30_000, dev), SHARDS, False),
    }
    sharded_err = {}
    for name, (t, n_shards, split) in sharded_cases.items():
        t0 = time.perf_counter()
        try:
            errs, stats = sharded_kernel_vs_plain(
                t, n_shards, SHARDED_CHECK_CYCLES, split=split)
        except AssertionError as e:
            fail("sharded_kernel_vs_plain", f"{name}: {e}")
        for k, v in errs.items():
            sharded_err[k] = max(sharded_err.get(k, 0.0), v)
        k8 = ({"device_mgm_move_max", "device_mgm_move_min"} if split
              else {"device_mgm_move"})
        if set(errs) != {"device_fused_ba", "device_fused_ba_act",
                         "device_tables"} | k8:
            fail("sharded_kernel_vs_plain", f"{name}: only {sorted(errs)} "
                 f"were checked")
        say("sharded_kernel_vs_plain", case=name,
            cycles=SHARDED_CHECK_CYCLES,
            max_abs_err=errs, seconds=round(time.perf_counter() - t0, 3),
            **stats)

    # the mixed branches of K7 (with and without activation), K8 and K9
    # against their plain versions, launch by launch, exactly
    sharded_mixed_err = {}
    for name in ("secp_3.9k", "secp4_3.9k", "mixed_star_deg2500",
                 "ragged_mixed_d4"):
        t = compile_factor_graph(mixed_dcops[name], device=dev)
        for n_shards, split in ((4, False), (SHARDS, False), (SHARDS, True)):
            if split and name != "secp4_3.9k":
                continue
            t0 = time.perf_counter()
            try:
                errs, stats = sharded_kernel_vs_plain(
                    t, n_shards, SHARDED_CHECK_CYCLES, split=split)
            except AssertionError as e:
                fail("sharded_mixed_kernel_vs_plain", f"{name} S={n_shards}:"
                     f" {e}")
            for k, v in errs.items():
                sharded_mixed_err[k] = max(sharded_mixed_err.get(k, 0.0), v)
            k8 = ({"device_mgm_move_mixed_max", "device_mgm_move_mixed_min"}
                  if split else {"device_mgm_move_mixed"})
            if set(errs) != {"device_fused_ba_mixed",
                             "device_fused_ba_mixed_act",
                             "device_tables_mixed"} | k8:
                fail("sharded_mixed_kernel_vs_plain", f"{name}: only "
                     f"{sorted(errs)} were checked")
            say("sharded_mixed_kernel_vs_plain", case=name,
                cycles=SHARDED_CHECK_CYCLES,
                split=split, max_abs_err=errs,
                seconds=round(time.perf_counter() - t0, 3), **stats)

    # K3: the lane permutation against its plain version (no caller on
    # any path of the port or of the JAX package)
    permute_rows = {}
    for N in (30_000, 300_000):
        try:
            err, row = lane_permute_vs_plain_and_times(N)
        except AssertionError as e:
            fail("lane_permute_kernel_vs_plain", str(e))
        permute_rows[N] = (err, row)
        say("lane_permute_kernel_vs_plain", S=3, N=N, max_abs_err=err,
            equal_to_index_select=True)

    phase_seconds("kernels_vs_plain")
    # 3. CLI paths ---------------------------------------------------------
    from pydcop_tpu_torch.dcop import load_dcop_from_file

    tuto = os.path.join(ROOT, "tests", "instances", "graph_coloring_tuto.yaml")
    cli_algos = ("maxsum", "mgm", "dsa", "mgm2", "dpop", "dba", "gdba")
    # one process a command, all started together
    procs = run_all([[sys.executable, "-m", "pydcop_tpu_torch", "solve",
                      "-a", algo, tuto] for algo in cli_algos], timeout=300)
    for algo, (rc, stdout, stderr) in zip(cli_algos, procs):
        phase = {"maxsum": "cli", "dpop": "cli_dpop"}.get(
            algo, "cli_local_search")
        try:
            out = json.loads(stdout)
        except ValueError:
            fail(phase, f"{algo}: rc={rc} no JSON; stderr: "
                 f"{stderr[-2000:]}")
        want = 12 if algo in ("maxsum", "dpop") else solve_result(
            load_dcop_from_file([tuto]), algo, device="cpu").cost
        if rc != 0 or out.get("status") != "FINISHED" \
                or out.get("cost") != want:
            fail(phase, f"{algo}: rc={rc} "
                 f"status={out.get('status')} cost={out.get('cost')} "
                 f"(expected {want}) error={out.get('error')}")
        say(phase, algo=algo, status=out["status"], cost=out["cost"],
            cpu_cost=want, cycle=out["cycle"], assignment=out["assignment"])

    phase_seconds("cli")
    # 4. main paths at full width ------------------------------------------
    t0 = time.perf_counter()
    dcop = coloring_dcop(10_000, 30_000)
    build_dcop_s = time.perf_counter() - t0
    cycles = 200
    jax_keys = {"status", "assignment", "cost", "violation", "cycle",
                "msg_count", "msg_size", "time", "harness", "config"}
    main_launches = {}
    # MaxSum, MGM, the DSA family and MGM-2: one launch a chunk of the
    # harness (two chunks of 100 cycles)
    chunk_launches = -(-cycles // default_chunk(
        cycles, False, False, None, cycles))
    for algo, expect in (
            ("maxsum", {"packed_maxsum_cycle": chunk_launches}),
            ("mgm", {"mgm": chunk_launches}),
            *((a, {"dsa": chunk_launches}) for a in DSA_ALGOS),
            ("mgm2", {"mgm2": chunk_launches})):
        phase = {"maxsum": "main_path", "mgm2": "main_path_mgm2"}.get(
            algo, "main_path_local_search")
        reset_counts()
        t0 = time.perf_counter()
        res = solve_result(dcop, algo, cycles=cycles, device="cuda")
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        counts = read_counts()
        want = {k: expect.get(k, 0) for k in counts}
        if counts != want:
            fail(phase, f"{algo}: launches {counts} in a {cycles}-cycle "
                 f"solve, expected {want}")
        main_launches.update({k: v for k, v in counts.items() if v})
        keys = set(res.metrics())
        if keys != jax_keys:
            fail(phase, f"{algo}: metrics keys {sorted(keys)} != the JAX "
                 f"package's {sorted(jax_keys)}")
        if res.status != "FINISHED" or res.cycle != cycles \
                or not math.isfinite(res.cost) \
                or len(res.assignment) != 10_000:
            fail(phase, f"{algo}: status={res.status} cycle={res.cycle} "
                 f"cost={res.cost} n_assigned={len(res.assignment)}")
        extra = {}
        if algo != "maxsum":
            cpu = solve_result(dcop, algo, cycles=cycles, device="cpu")
            if res.cost != cpu.cost or res.assignment != cpu.assignment:
                fail(phase, f"{algo}: card cost {res.cost} != CPU cost "
                     f"{cpu.cost} (same assignment: "
                     f"{res.assignment == cpu.assignment})")
            extra = {"cpu_cost": cpu.cost}
        say(phase, algo=algo, launches=counts, cycle=res.cycle,
            status=res.status, cost=res.cost, violation=res.violation,
            msg_count=res.msg_count, build_dcop_s=round(build_dcop_s, 3),
            solve_s=round(solve_s, 3), harness=res.metrics()["harness"],
            **extra)
        if algo in BREAKDOWN_SOLVERS:
            say(phase + "_breakdown", algo=algo, nvidia_smi=smi,
                **breakdown(dcop, algo, cycles, dev))

    # dpop on the bench's 10k-node tree: one whole sweep, one launch
    from pydcop_tpu_torch.graph import pseudotree

    tree_dcop_10k = dpop_packed["bench_tree_10k"][0]
    L = pseudotree.build_computation_graph(tree_dcop_10k).height + 1
    reset_counts()
    t0 = time.perf_counter()
    res = solve_result(tree_dcop_10k, "dpop", device="cuda")
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = read_counts()
    want = {k: 0 for k in counts}
    want.update(dpop_whole_sweep=1)
    if counts != want:
        fail("main_path_dpop", f"launches {counts} in one dpop solve, "
             f"expected {want}")
    main_launches.update(dpop_whole_sweep=counts["dpop_whole_sweep"])
    cpu = solve_result(tree_dcop_10k, "dpop", device="cpu")
    dpop_keys = jax_keys - {"harness"}
    keys = set(res.metrics())
    if keys != dpop_keys:
        fail("main_path_dpop", f"metrics keys {sorted(keys)} != the JAX "
             f"package's {sorted(dpop_keys)}")
    if res.config["engine"] != "wholesweep" or res.status != "FINISHED" \
            or res.cost != cpu.cost or res.assignment != cpu.assignment \
            or len(res.assignment) != 10_000:
        fail("main_path_dpop", f"engine={res.config['engine']} "
             f"status={res.status} cost={res.cost} (CPU {cpu.cost}, "
             f"same assignment: {res.assignment == cpu.assignment})")
    say("main_path_dpop", algo="dpop", launches=counts, L=L,
        engine=res.config["engine"], cpu_engine=cpu.config["engine"],
        status=res.status, cost=res.cost, cpu_cost=cpu.cost,
        cycle=res.cycle, msg_count=res.msg_count, msg_size=res.msg_size,
        solve_s=round(solve_s, 3))
    say("main_path_dpop_breakdown", algo="dpop", nvidia_smi=smi,
        **dpop_breakdown(tree_dcop_10k, dev))

    # the mixed-arity path: the JAX bench's SECP, 200 cycles of maxsum,
    # mgm, dsa and mgm2 on the card through the mixed kernels, each cost
    # equal to the CPU run of the same packed engine (use_packed=True)
    secp = mixed_dcops["secp_3.9k"]
    for algo, expect in (
            ("maxsum", {"packed_maxsum_mixed": cycles}),
            ("mgm", {"mgm_mixed": chunk_launches}),
            *((a, {"dsa_mixed": chunk_launches}) for a in DSA_ALGOS),
            ("mgm2", {"mgm2_mixed": chunk_launches})):
        reset_counts()
        t0 = time.perf_counter()
        res = solve_result(secp, algo, cycles=cycles, device="cuda")
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        counts = read_counts()
        want = {k: expect.get(k, 0) for k in counts}
        if counts != want:
            fail("main_path_mixed", f"{algo}: launches {counts} in a "
                 f"{cycles}-cycle solve, expected {want}")
        main_launches.update({k: v for k, v in counts.items() if v})
        cpu = solve_cpu_packed(secp, algo, cycles=cycles)
        if set(res.metrics()) != jax_keys or res.status != "FINISHED" \
                or res.cycle != cycles or not math.isfinite(res.cost) \
                or len(res.assignment) != len(secp.variables):
            fail("main_path_mixed", f"{algo}: status={res.status} "
                 f"cycle={res.cycle} cost={res.cost} "
                 f"keys={sorted(res.metrics())}")
        if res.cost != cpu.cost or res.assignment != cpu.assignment:
            fail("main_path_mixed", f"{algo}: card cost {res.cost} != CPU "
                 f"(use_packed=True) cost {cpu.cost} (same assignment: "
                 f"{res.assignment == cpu.assignment})")
        say("main_path_mixed", algo=algo, instance="secp_3.9k",
            launches=counts, cycle=res.cycle, status=res.status,
            cost=res.cost, cpu_packed_cost=cpu.cost,
            violation=res.violation, msg_count=res.msg_count,
            solve_s=round(solve_s, 3), harness=res.metrics()["harness"])
        if algo in BREAKDOWN_SOLVERS:
            say("main_path_mixed_breakdown", algo=algo, nvidia_smi=smi,
                **breakdown(secp, algo, cycles, dev))

    # the breakout algorithms on a 10k-variable / 30k-constraint colouring
    # CSP: the generic engine (plain PyTorch on the card, as the JAX
    # package runs them in XLA), so no kernel counter may move
    t0 = time.perf_counter()
    csp = coloring_csp_dcop(10_000, 30_000)
    build_csp_s = time.perf_counter() - t0
    #: CPU runs the harness phase holds the captured card runs to
    cpu_results = {}
    for algo in ("dba", "gdba"):
        reset_counts()
        t0 = time.perf_counter()
        res = solve_result(csp, algo, cycles=cycles, device="cuda")
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        counts = read_counts()
        if any(counts.values()):
            fail("main_path_breakout", f"{algo}: launches {counts}: the "
                 f"generic engine launches no kernel of the port")
        cpu = solve_result(csp, algo, cycles=cycles, device="cpu")
        cpu_results[algo] = cpu
        if set(res.metrics()) != jax_keys or res.status != "FINISHED" \
                or res.cycle != cycles or not math.isfinite(res.cost) \
                or len(res.assignment) != 10_000:
            fail("main_path_breakout", f"{algo}: status={res.status} "
                 f"cycle={res.cycle} cost={res.cost} "
                 f"keys={sorted(res.metrics())}")
        if res.cost != cpu.cost or res.assignment != cpu.assignment \
                or res.cycle != cpu.cycle:
            fail("main_path_breakout", f"{algo}: card cost {res.cost} at "
                 f"cycle {res.cycle} != CPU cost {cpu.cost} at cycle "
                 f"{cpu.cycle} (same assignment: "
                 f"{res.assignment == cpu.assignment})")
        say("main_path_breakout", algo=algo, instance="coloring_csp_10k_30k",
            engine="generic (plain PyTorch, no kernel)", launches=counts,
            cycle=res.cycle, status=res.status, cost=res.cost,
            cpu_cost=cpu.cost, cpu_cycle=cpu.cycle, violation=res.violation,
            msg_count=res.msg_count, build_dcop_s=round(build_csp_s, 3),
            solve_s=round(solve_s, 3), harness=res.metrics()["harness"])
        say("main_path_breakout_breakdown", algo=algo, nvidia_smi=smi,
            engine="generic (plain PyTorch, no kernel)",
            **breakdown(csp, algo, cycles, dev))

    # the sharded path: solve -d with a placement of 8 agents, 8 shards on
    # the card, each cycle one K7 launch over the 8 shards with the ordered
    # sum inside; the card is held to the CPU run (the plain versions) of
    # the same shards
    from pydcop_tpu_torch.ops.compile import compile_constraint_graph
    from pydcop_tpu_torch.parallel import ShardedLocalSearch, build_mesh

    dist = block_distribution(dcop, SHARDS)
    reset_counts()
    t0 = time.perf_counter()
    res = solve_result(dcop, "maxsum", distribution=dist, n_shards=SHARDS,
                       cycles=cycles, device="cuda")
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = read_counts()
    want = {k: 0 for k in counts}
    want["device_fused_ba"] = cycles
    if counts != want:
        fail("main_path_sharded", f"launches {counts} in a {cycles}-cycle "
             f"{SHARDS}-shard solve, expected {want}")
    main_launches.update(device_fused_ba=counts["device_fused_ba"])
    cpu = solve_result(dcop, "maxsum", distribution=dist, n_shards=SHARDS,
                       cycles=cycles, device="cpu")
    if res.status != "FINISHED" or res.cycle != cycles \
            or not math.isfinite(res.cost) or len(res.assignment) != 10_000 \
            or set(res.metrics()) != jax_keys - {"harness"} | {"shard"}:
        fail("main_path_sharded", f"status={res.status} cycle={res.cycle} "
             f"cost={res.cost} keys={sorted(res.metrics())}")
    if (res.assignment, res.cost, res.cycle) != (cpu.assignment, cpu.cost,
                                                 cpu.cycle):
        fail("main_path_sharded", f"card cost {res.cost} at cycle "
             f"{res.cycle} != CPU cost {cpu.cost} at cycle {cpu.cycle} "
             f"(same assignment: {res.assignment == cpu.assignment})")
    single = solve_result(dcop, "maxsum", cycles=cycles,
                          algo_params={"noise": 0}, device="cuda")
    say("main_path_sharded", algo="maxsum", instance="coloring_10k_30k",
        agents=len(dist.agents), launches=counts, cycle=res.cycle,
        status=res.status, cost=res.cost, cpu_cost=cpu.cost,
        single_device_cost=single.cost,
        values_differing_from_single_device=sum(
            res.assignment[k] != single.assignment[k]
            for k in res.assignment),
        shard=res.metrics()["shard"], config=res.config,
        msg_count=res.msg_count, solve_s=round(solve_s, 3))

    # sharded mgm and dsa, 8 shards on the card against the CPU: the same
    # start and coins (drawn on the CPU from the seed)
    cg_cuda = compile_constraint_graph(dcop, device=dev)
    cg_cpu = compile_constraint_graph(dcop, device="cpu")
    # (one K9 and one K8 launch a cycle)
    for rule, expect in (
            ("mgm", {"device_tables": cycles, "device_mgm_move": cycles}),
            ("dsa", {"device_tables": cycles})):
        eng = ShardedLocalSearch(cg_cuda, build_mesh(SHARDS, "cuda"),
                                 rule=rule)
        reset_counts()
        t0 = time.perf_counter()
        values = eng.run(cycles, seed=0)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        want = {k: expect.get(k, 0) for k in counts}
        if counts != want:
            fail("main_path_sharded_local_search", f"{rule}: launches "
                 f"{counts}, expected {want}")
        main_launches.update(
            {f"{k}_{rule}": v for k, v in counts.items() if v})
        cpu_values = ShardedLocalSearch(
            cg_cpu, build_mesh(SHARDS, "cpu"), rule=rule).run(cycles,
                                                               seed=0)
        if not np.array_equal(values, cpu_values):
            fail("main_path_sharded_local_search", f"{rule}: "
                 f"{int((values != cpu_values).sum())} values differ from "
                 f"the CPU run")
        cost = dcop.solution_cost(
            cg_cpu.assignment_from_indices(values), 10000)[1]
        say("main_path_sharded_local_search", algo=rule,
            instance="coloring_10k_30k", S=SHARDS, launches=counts,
            cycles=cycles, cost=cost, equal_to_cpu=True,
            run_s=round(run_s, 3), comm=eng.comm_stats())

    from pydcop_tpu_torch.parallel.partition import \
        assigns_from_distribution

    # the sharded path on a mixed-arity graph: solve -d on the bench's
    # SECP with 8 agents, 8 shards on the card, each cycle one K7-mixed
    # launch over them; held to the CPU run of the same shards
    def solve_d(dcop_, algo, expect_key, phase, instance, params=None):
        dist_ = block_distribution(dcop_, SHARDS)
        reset_counts()
        t0 = time.perf_counter()
        res = solve_result(dcop_, algo, distribution=dist_,
                           n_shards=SHARDS, cycles=cycles,
                           algo_params=params, device="cuda")
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        counts = read_counts()
        assigns_ = assigns_from_distribution(
            dist_, compile_factor_graph(dcop_, device="cpu"), SHARDS)
        live = len(set(np.concatenate([np.asarray(a) for a in assigns_])))
        want = {k: 0 for k in counts}
        want[expect_key] = cycles
        if counts != want:
            fail(phase, f"{algo} on {instance}: launches {counts} in a "
                 f"{cycles}-cycle {SHARDS}-shard solve, expected {want}")
        cpu = solve_result(dcop_, algo, distribution=dist_, n_shards=SHARDS,
                           cycles=cycles, algo_params=params, device="cpu")
        if res.status != "FINISHED" or res.cycle != cycles \
                or not math.isfinite(res.cost) \
                or len(res.assignment) != len(dcop_.variables) \
                or res.config["algo"] != algo:
            fail(phase, f"{algo} on {instance}: status={res.status} "
                 f"cycle={res.cycle} cost={res.cost} config={res.config}")
        if (res.assignment, res.cost, res.cycle) != (
                cpu.assignment, cpu.cost, cpu.cycle):
            fail(phase, f"{algo} on {instance}: card cost {res.cost} at "
                 f"cycle {res.cycle} != CPU cost {cpu.cost} at cycle "
                 f"{cpu.cycle} (same assignment: "
                 f"{res.assignment == cpu.assignment})")
        say(phase, algo=algo, instance=instance, agents=len(dist_.agents),
            shards_holding_factors=live, launches=counts, cycle=res.cycle,
            status=res.status, cost=res.cost, cpu_cost=cpu.cost,
            shard=res.metrics()["shard"], config=res.config,
            msg_count=res.msg_count, solve_s=round(solve_s, 3))
        return counts[expect_key]

    main_launches["device_fused_ba_mixed"] = solve_d(
        secp, "maxsum", "device_fused_ba_mixed", "main_path_sharded_mixed",
        "secp_3.9k")

    # sharded mgm (K9 + K8 mixed), dsa and adsa (K9 mixed) on the SECP, 8
    # shards on the card against the CPU: the same start and coins; one
    # launch of each a cycle
    secp_cuda = compile_constraint_graph(secp, device=dev)
    secp_cpu = compile_constraint_graph(secp, device="cpu")
    for rule, expect in (
            ("mgm", {"device_tables_mixed": 1, "device_mgm_move_mixed": 1}),
            ("dsa", {"device_tables_mixed": 1}),
            ("adsa", {"device_tables_mixed": 1})):
        eng = ShardedLocalSearch(secp_cuda, build_mesh(SHARDS, "cuda"),
                                 rule=rule)
        reset_counts()
        t0 = time.perf_counter()
        values = eng.run(cycles, seed=0)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        want = {k: cycles * expect.get(k, 0) for k in counts}
        if counts != want:
            fail("main_path_sharded_mixed", f"{rule}: launches {counts}, "
                 f"expected {want}")
        main_launches.update(
            {f"{k}_{rule}": v for k, v in counts.items() if v})
        cpu_values = ShardedLocalSearch(
            secp_cpu, build_mesh(SHARDS, "cpu"), rule=rule).run(cycles,
                                                                 seed=0)
        if not np.array_equal(values, cpu_values):
            fail("main_path_sharded_mixed", f"{rule}: "
                 f"{int((values != cpu_values).sum())} values differ from "
                 f"the CPU run")
        cost = secp.solution_cost(
            secp_cpu.assignment_from_indices(values), 10000)[1]
        say("main_path_sharded_mixed", algo=rule, instance="secp_3.9k",
            S=SHARDS, launches=counts, cycles=cycles, cost=cost,
            equal_to_cpu=True, run_s=round(run_s, 3), comm=eng.comm_stats())

    # amaxsum on one device: the generic engine (plain PyTorch, no
    # kernel), the 10k/30k colouring, equal to the CPU run of the seed
    reset_counts()
    t0 = time.perf_counter()
    res = solve_result(dcop, "amaxsum", cycles=cycles, device="cuda")
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = read_counts()
    if any(counts.values()):
        fail("main_path_amaxsum", f"launches {counts}: the generic engine "
             f"launches no kernel of the port")
    cpu = solve_result(dcop, "amaxsum", cycles=cycles, device="cpu")
    cpu_results["amaxsum"] = cpu
    if set(res.metrics()) != jax_keys or res.status != "FINISHED" \
            or res.cycle != cycles or not math.isfinite(res.cost) \
            or len(res.assignment) != 10_000:
        fail("main_path_amaxsum", f"status={res.status} cycle={res.cycle} "
             f"cost={res.cost} keys={sorted(res.metrics())}")
    if (res.assignment, res.cost, res.cycle) != (cpu.assignment, cpu.cost,
                                                 cpu.cycle):
        fail("main_path_amaxsum", f"card cost {res.cost} at cycle "
             f"{res.cycle} != CPU cost {cpu.cost} at cycle {cpu.cycle} "
             f"(same assignment: {res.assignment == cpu.assignment})")
    say("main_path_amaxsum", algo="amaxsum", instance="coloring_10k_30k",
        engine="generic (plain PyTorch, no kernel)", launches=counts,
        cycle=res.cycle, status=res.status, cost=res.cost,
        cpu_cost=cpu.cost, msg_count=res.msg_count,
        solve_s=round(solve_s, 3), harness=res.metrics()["harness"])

    # sharded amaxsum: solve -d with 8 agents, each cycle one K7
    # activation launch over the 8 shards (the binary colouring, then the
    # SECP through the mixed kernel's activation branch)
    main_launches["device_fused_ba_act"] = solve_d(
        dcop, "amaxsum", "device_fused_ba_act", "main_path_sharded_amaxsum",
        "coloring_10k_30k")
    main_launches["device_fused_ba_mixed_act"] = solve_d(
        secp, "amaxsum", "device_fused_ba_mixed_act",
        "main_path_sharded_amaxsum", "secp_3.9k")

    # every test instance, by every algorithm of the port, on the card
    # and on the CPU: the same run (maxsum without noise, as the parity
    # tests run it; the local-search coins come from CPU generators)
    # A mixed-arity instance takes the packed engine on the card and the
    # generic one on the CPU by default (as the JAX package); there the
    # card is held to the CPU run of the packed engine (use_packed=True),
    # and the CPU default is printed beside it.
    inst = os.path.join(ROOT, "tests", "instances")
    for fn in sorted(os.listdir(inst)):
        d = load_dcop_from_file([os.path.join(inst, fn)])
        mixed = is_mixed(d)
        for algo in ("maxsum", "maxsum_dynamic", "mgm", "dsa", "dsatuto",
                     "mixeddsa", "adsa", "mgm2", "dpop", "dba", "gdba",
                     "syncbb", "ncbb"):
            params = ({"noise": 0} if algo in ("maxsum", "maxsum_dynamic")
                      else None)
            g = solve_result(d, algo, algo_params=params, device="cuda")
            c = solve_result(d, algo, algo_params=params, device="cpu")
            extra = {}
            if mixed and algo not in ("dpop", "dba", "gdba", "syncbb",
                                      "ncbb"):
                extra = dict(cpu_default_cost=c.cost,
                             cpu_default_cycle=c.cycle)
                c = solve_cpu_packed(d, algo, params)
            same = (g.assignment == c.assignment and g.cost == c.cost
                    and g.cycle == c.cycle and g.status == c.status)
            say("instances", instance=fn, algo=algo, cuda_cost=g.cost,
                cpu_cost=c.cost, cuda_cycle=g.cycle, cpu_cycle=c.cycle,
                cpu_use_packed=bool(extra),
                cuda_engine=(g.config or {}).get("engine", "host"),
                same_assignment=g.assignment == c.assignment, **extra)
            if not same or g.status != "FINISHED" \
                    or not math.isfinite(g.cost):
                fail("instances", f"{fn} {algo}: card status={g.status} "
                     f"cost={g.cost} cycle={g.cycle} against CPU "
                     f"status={c.status} cost={c.cost} cycle={c.cycle}")

    # the exact-search family: syncbb/ncbb's host loops, the frontier
    # engine on the JAX bench's anytime instances, DPOP's frontier engine
    # and --anytime-exact through the CLI
    phase_seconds("main_paths")
    search_host_phase()
    phase_seconds("search_host")
    search_frontier_phase(smi)
    phase_seconds("search_frontier")
    search_dpop_frontier_phase()
    phase_seconds("search_dpop_frontier")
    # maxsum_dynamic: K1 binary on a layout swapped in place, K1-mixed
    # through the re-pack
    dynamic_k1 = maxsum_dynamic_phase(smi)
    phase_seconds("maxsum_dynamic")
    # the harness: per-cycle metrics (K2 once a cycle), the captured
    # chunks of the generic engines, the pipelined dispatch
    harness_dcops = {"coloring_10k_30k": dcop, "coloring_csp_10k_30k": csp,
                     "secp_3.9k": secp}
    k2_by_path, k2_err, _ = harness_collect_phase(harness_dcops)
    phase_seconds("harness_collect")
    harness_captured_phase(harness_dcops, cpu_results, smi)
    phase_seconds("harness_captured")
    # batched solving: the batch engine's buckets (no kernel: the generic
    # cycles, as the JAX package's vmap) and K10 with an instance axis
    batch_phase(smi)
    phase_seconds("batch")
    # the solve service: continuous batching over the batch engine's
    # bucket runners (no kernel), and its sequential fallback (K6, K10)
    serve_phase(smi)
    phase_seconds("serve")
    dpop_batched = dpop_batched_phase(smi, dpop_packed)
    phase_seconds("dpop_batched")

    # 5. times -------------------------------------------------------------
    timing = {}
    # blocks of the cooperative local-search launches, by (size, kernel)
    blocks_of = {}
    sizes = {"10k_30k": primary, "100k_300k": big}
    for name, pg in sizes.items():
        ms, plain, bound, by, nbytes, device_us = time_kernel(pg)
        timing[name, "packed_maxsum_cycle"] = (ms, plain, bound, by)
        blocks_of[name, "packed_maxsum_cycle"] = k1_grid(pg)
        # share of a cycle's wall time (CUDA events) the kernel runs on
        # the device; the rest is the argmin epilogue and the host
        say("times", kernel="packed_maxsum_cycle", size=name, N=pg.N,
            Vp=pg.Vp, launches_per_call=1,
            blocks=blocks_of[name, "packed_maxsum_cycle"],
            kernel_ms=ms, plain_ms=plain, bound_ms=bound,
            bound_by=by, bytes_per_cycle=nbytes,
            profiler_kernel_us=device_us,
            kernel_busy_share=device_us / (ms * 1e3) if device_us else None,
            library_ms=None, nvidia_smi=smi)
        pls = pack_from_pg(pg)
        grids = coop_grids(pls)
        for kname, (ms, plain, bound, by, nbytes, device_us) in \
                time_ls(pls).items():
            timing[name, kname] = (ms, plain, bound, by)
            grid = {}
            if kname in grids:
                grid = {"blocks": grids[kname]}
                blocks_of[name, kname] = grids[kname]
            say("times", kernel=kname, size=name, N=pg.N, Vp=pg.Vp, **grid,
                kernel_ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                bytes_per_cycle=nbytes, profiler_kernel_us=device_us,
                kernel_busy_share=(device_us / (ms * 1e3) if device_us
                                   else None),
                library_ms=None,
                library_note="no single PyTorch call computes a "
                "local-tables gather-sum or an MGM/DSA move",
                nvidia_smi=smi)
        pm = pack_mgm2_from_pls(pack_from_pg(pg))
        ms, plain, bound, by, nbytes, device_us, us, offers = time_mgm2(pm)
        timing[name, "packed_mgm2_cycles"] = (ms, plain, bound, by)
        blocks, threads = mgm2_grid(pm)
        say("times", kernel="packed_mgm2_cycles", size=name, N=pg.N,
            Vp=pg.Vp, launches_per_call=1, blocks=blocks, threads=threads,
            kernel_ms=ms,
            plain_ms=plain, bound_ms=bound, bound_by=by,
            bytes_per_cycle=nbytes, offers_per_cycle=offers,
            profiler_kernel_us=device_us,
            profiler_us_per_launch_of_50_cycles=us,
            kernel_busy_share=(device_us / (ms * 1e3) if device_us
                               else None),
            library_ms=None,
            library_note="no single PyTorch call computes an MGM-2 cycle",
            nvidia_smi=smi)
    for name, (_, ps, _) in dpop_packed.items():
        ms, plain, bound, by, nbytes, device_us = time_dpop(ps)
        timing[name, "dpop_whole_sweep"] = (ms, plain, bound, by)
        blocks_of[name, "dpop_whole_sweep"] = dpop_grid(ps)
        say("times", kernel="dpop_whole_sweep", size=name,
            n_nodes=ps.n_nodes, D=ps.D, L=ps.L, launches_per_sweep=1,
            barriers_per_sweep=2 * ps.L - 1,
            blocks=blocks_of[name, "dpop_whole_sweep"],
            kernel_ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
            bytes_per_sweep=nbytes, profiler_kernel_us=device_us,
            kernel_busy_share=(device_us / (ms * 1e3) if device_us
                               else None),
            tables_per_s=ps.n_nodes / (ms * 1e-3),
            library_ms=None,
            library_note="no single PyTorch call computes a DPOP sweep",
            nvidia_smi=smi)

    big_secp = f"secp4_{39 * SECP_BIG_SCALE // 10}k"
    for name in ("secp_3.9k", "secp4_3.9k", big_secp):
        pg = mixed_pgs[name]
        ms, plain, bound, by, nbytes, device_us = time_kernel(pg)
        timing[name, "packed_maxsum_mixed_cycle"] = (ms, plain, bound, by)
        say("times", kernel="packed_maxsum_mixed_cycle", size=name, N=pg.N,
            Vp=pg.Vp, units=mixed_work(pg), blocks=mixed_launch_blocks(pg),
            kernel_ms=ms, plain_ms=plain, bound_ms=bound,
            bound_by=by, bytes_per_cycle=nbytes,
            profiler_kernel_us=device_us,
            kernel_busy_share=device_us / (ms * 1e3) if device_us else None,
            library_ms=None,
            library_note="no single PyTorch call computes a MaxSum cycle",
            nvidia_smi=smi)
        pls = pack_from_pg(pg)
        grids = coop_grids(pls)
        for kname, (ms, plain, bound, by, nbytes, device_us) in \
                time_ls(pls).items():
            timing[name, kname + "_mixed"] = (ms, plain, bound, by)
            grid = {}
            if kname in grids:
                grid = {"blocks": grids[kname]}
                blocks_of[name, kname + "_mixed"] = grids[kname]
            say("times", kernel=kname + "_mixed", size=name, N=pg.N,
                Vp=pg.Vp, **grid, kernel_ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, bytes_per_cycle=nbytes,
                profiler_kernel_us=device_us,
                kernel_busy_share=(device_us / (ms * 1e3) if device_us
                                   else None),
                library_ms=None,
                library_note="no single PyTorch call computes a "
                "local-tables gather-sum or an MGM/DSA move",
                nvidia_smi=smi)

    for name in ("secp_3.9k", "secp4_3.9k", big_secp):
        pg = mixed_pgs[name]
        pm = pack_mgm2_from_pls(pack_from_pg(pg))
        ms, plain, bound, by, nbytes, device_us, us, offers = time_mgm2(pm)
        timing[name, "packed_mgm2_cycles_mixed"] = (ms, plain, bound, by)
        blocks, threads = mgm2_grid(pm)
        say("times", kernel="packed_mgm2_cycles_mixed", size=name, N=pg.N,
            Vp=pg.Vp, launches_per_call=1, blocks=blocks, threads=threads,
            kernel_ms=ms,
            plain_ms=plain, bound_ms=bound, bound_by=by,
            bytes_per_cycle=nbytes, offers_per_cycle=offers,
            profiler_kernel_us=device_us,
            profiler_us_per_launch_of_50_cycles=us,
            kernel_busy_share=(device_us / (ms * 1e3) if device_us
                               else None),
            library_ms=None,
            library_note="no single PyTorch call computes an MGM-2 cycle",
            nvidia_smi=smi)

    for name, t in (("10k_30k", primary_t), ("100k_300k", big_t)):
        out, rates = time_sharded(t, SHARDS)
        for kname, row in out.items():
            timing[name, kname] = (row["kernel_ms"], row["plain_ms"],
                                   row["bound_ms"], row["bound_by"])
            say("times", kernel=kname, size=name, S=SHARDS, **row,
                kernel_busy_share=(
                    row["profiler_kernel_us"] / (row["kernel_ms"] * 1e3)
                    if row["profiler_kernel_us"] else None),
                library_ms=None,
                library_note="no single PyTorch call computes a shard's "
                "rotated MaxSum cycle, MGM's arbitration or partial tables",
                nvidia_smi=smi)
        say("times", kernel="sharded_cycles", size=name, S=SHARDS,
            cycles_per_s=rates, nvidia_smi=smi)

    sharded_note = ("no single PyTorch call computes a shard's rotated "
                    "MaxSum cycle, MGM's arbitration or partial tables")
    secp_t = compile_factor_graph(secp, device=dev)
    big_secp_t = compile_factor_graph(mixed_dcops[big_secp], device=dev)
    for name, t, amaxsum in (
            ("secp_3.9k", secp_t, False), (big_secp, big_secp_t, False),
            ("secp_3.9k", secp_t, True), (big_secp, big_secp_t, True),
            ("10k_30k", primary_t, True),
            ("100k_300k", big_t, True)):
        out, rates = time_sharded(t, SHARDS, amaxsum=amaxsum)
        for kname, row in out.items():
            timing[name, kname] = (row["kernel_ms"], row["plain_ms"],
                                   row["bound_ms"], row["bound_by"])
            say("times", kernel=kname, size=name, S=SHARDS, **row,
                kernel_busy_share=(
                    row["profiler_kernel_us"] / (row["kernel_ms"] * 1e3)
                    if row["profiler_kernel_us"] else None),
                library_ms=None, library_note=sharded_note, nvidia_smi=smi)
        say("times", kernel="sharded_cycles", size=name, S=SHARDS,
            cycles_per_s=rates, nvidia_smi=smi)
    say("times", kernel="amaxsum_cycles", size="10k_30k",
        engine="generic (plain PyTorch, no kernel)",
        cycles_per_s={"amaxsum": amaxsum_rate(dcop)}, nvidia_smi=smi)
    for N, (_, row) in permute_rows.items():
        timing[f"N{N}", "lane_permute"] = (row["kernel_ms"], row["plain_ms"],
                                           row["bound_ms"], row["bound_by"],
                                           row["library_ms"])
        say("times", kernel="lane_permute", size=f"3x{N}", **row,
            kernel_busy_share=(
                row["profiler_kernel_us"] / (row["kernel_ms"] * 1e3)
                if row["profiler_kernel_us"] else None),
            library_note="torch.index_select(x, 1, perm)", nvidia_smi=smi)

    entries = [
        ("packed_maxsum_cycle", "pydcop_tpu_torch/csrc/packed_maxsum.cu",
         "pydcop_tpu/ops/pallas_maxsum.py:1505",
         main_launches["packed_maxsum_cycle"], main_err),
        ("packed_local_tables", "pydcop_tpu_torch/csrc/local_search.cu",
         "pydcop_tpu/ops/pallas_maxsum.py:1603",
         k2_by_path["mgm_solve_coloring_10k_30k"], max(ls_err, k2_err)),
        ("packed_mgm_cycles", "pydcop_tpu_torch/csrc/local_search.cu",
         "pydcop_tpu/ops/pallas_local_search.py:529",
         main_launches["mgm"], ls_err),
        ("packed_dsa_cycles", "pydcop_tpu_torch/csrc/local_search.cu",
         "pydcop_tpu/ops/pallas_local_search.py:644",
         main_launches["dsa"], ls_err),
        ("dpop_whole_sweep", "pydcop_tpu_torch/csrc/dpop_sweep.cu",
         "pydcop_tpu/ops/pallas_dpop.py:306",
         main_launches["dpop_whole_sweep"], dpop_err),
        ("dpop_whole_sweep_batched", "pydcop_tpu_torch/csrc/dpop_sweep.cu",
         "pydcop_tpu/ops/pallas_dpop.py:306",
         dpop_batched["bench_tree_10k"]["launches"],
         max(v["max_abs_err"] for v in dpop_batched.values())),
        ("packed_mgm2_cycles", "pydcop_tpu_torch/csrc/mgm2.cu",
         "pydcop_tpu/ops/pallas_mgm2.py:448", main_launches["mgm2"],
         mgm2_err),
        ("packed_maxsum_mixed_cycle",
         "pydcop_tpu_torch/csrc/packed_maxsum.cu",
         "pydcop_tpu/ops/pallas_maxsum.py:1505",
         main_launches["packed_maxsum_mixed"], mixed_err),
        ("packed_local_tables_mixed", "pydcop_tpu_torch/csrc/local_search.cu",
         "pydcop_tpu/ops/pallas_maxsum.py:1603",
         k2_by_path["mgm_solve_secp_3.9k"], max(mixed_ls_err, k2_err)),
        ("packed_mgm_cycles_mixed", "pydcop_tpu_torch/csrc/local_search.cu",
         "pydcop_tpu/ops/pallas_local_search.py:529",
         main_launches["mgm_mixed"], mixed_ls_err),
        ("packed_dsa_cycles_mixed", "pydcop_tpu_torch/csrc/local_search.cu",
         "pydcop_tpu/ops/pallas_local_search.py:644",
         main_launches["dsa_mixed"], mixed_ls_err),
        ("packed_mgm2_cycles_mixed", "pydcop_tpu_torch/csrc/mgm2.cu",
         "pydcop_tpu/ops/pallas_mgm2.py:448", main_launches["mgm2_mixed"],
         mixed_mgm2_err),
        ("packed_shard_fused_ba", "pydcop_tpu_torch/csrc/sharded.cu",
         "pydcop_tpu/ops/pallas_sharded.py:180",
         main_launches["device_fused_ba"], sharded_err["device_fused_ba"]),
        ("packed_shard_route_gains", "pydcop_tpu_torch/csrc/sharded.cu",
         "pydcop_tpu/ops/pallas_sharded.py:258",
         main_launches["device_mgm_move_mgm"],
         max(v for k, v in sharded_err.items()
             if k.startswith("device_mgm_move"))),
        ("packed_shard_tables", "pydcop_tpu_torch/csrc/sharded.cu",
         "pydcop_tpu/ops/pallas_sharded.py:319",
         main_launches["device_tables_mgm"], sharded_err["device_tables"]),
        ("packed_shard_fused_ba_act", "pydcop_tpu_torch/csrc/sharded.cu",
         "pydcop_tpu/ops/pallas_sharded.py:180",
         main_launches["device_fused_ba_act"],
         sharded_err["device_fused_ba_act"]),
        ("packed_shard_fused_ba_mixed", "pydcop_tpu_torch/csrc/sharded.cu",
         "pydcop_tpu/ops/pallas_sharded.py:180",
         main_launches["device_fused_ba_mixed"],
         sharded_mixed_err["device_fused_ba_mixed"]),
        ("packed_shard_fused_ba_mixed_act",
         "pydcop_tpu_torch/csrc/sharded.cu",
         "pydcop_tpu/ops/pallas_sharded.py:180",
         main_launches["device_fused_ba_mixed_act"],
         sharded_mixed_err["device_fused_ba_mixed_act"]),
        ("packed_shard_route_gains_mixed", "pydcop_tpu_torch/csrc/sharded.cu",
         "pydcop_tpu/ops/pallas_sharded.py:258",
         main_launches["device_mgm_move_mixed_mgm"],
         max(v for k, v in sharded_mixed_err.items()
             if k.startswith("device_mgm_move"))),
        ("packed_shard_tables_mixed", "pydcop_tpu_torch/csrc/sharded.cu",
         "pydcop_tpu/ops/pallas_sharded.py:319",
         main_launches["device_tables_mixed_mgm"],
         sharded_mixed_err["device_tables_mixed"]),
        # K3 has no caller on any path of the port (nor of the JAX
        # package): no main-path launch to count
        ("lane_permute", "pydcop_tpu_torch/csrc/permute.cu",
         "pydcop_tpu/ops/pallas_permute.py:88", 0,
         max(err for err, _ in permute_rows.values())),
    ]
    b10k = dpop_batched["bench_tree_10k"]
    timing["bench_tree_10k", "dpop_whole_sweep_batched"] = (
        b10k["ms"], b10k["plain_ms"], b10k["bound_ms"], b10k["bound_by"])
    blocks_of["bench_tree_10k", "dpop_whole_sweep_batched"] = b10k["blocks"]
    sizes_of = {"dpop_whole_sweep": "bench_tree_10k",
                "dpop_whole_sweep_batched": "bench_tree_10k",
                "packed_shard_fused_ba_act": "10k_30k",
                "lane_permute": "N30000"}
    designs = {
        "packed_maxsum_cycle": K1_DESIGN,
        "packed_local_tables": K2_DESIGN,
        "packed_local_tables_mixed": K2_DESIGN,
        "dpop_whole_sweep": DPOP_DESIGN,
        "dpop_whole_sweep_batched": DPOP_BATCHED_DESIGN,
        "packed_maxsum_mixed_cycle": (
            "one cooperative launch a cycle, two phases: the slots' r' over "
            "the grid (a ternary or quaternary slot one thread a value), a "
            "grid barrier, one thread a column"),
        "packed_mgm2_cycles": MGM2_DESIGN,
        "packed_mgm2_cycles_mixed": MGM2_DESIGN,
        "packed_mgm_cycles": MGM_DESIGN,
        "packed_mgm_cycles_mixed": MGM_DESIGN,
        "packed_dsa_cycles": DSA_DESIGN,
        "packed_dsa_cycles_mixed": DSA_DESIGN}
    # K2's path: per-cycle metrics (collect_cycles), once a cycle, as in
    # the JAX package (pydcop_tpu/algorithms/_local_search.py:294-299)
    k2_note = ("launched once a cycle by the collect_cycles path of mgm, "
               "mgm2 and the DSA family (solve --run_metrics), inside the "
               "chunk's CUDA graph; launches: a 200-cycle solve_result mgm "
               "run with collect_cycles at the default chunk of 7 (the "
               "tail chunk's 3 frozen cycles launch too); the captured "
               "chunk's K2 nodes are counted in its graph, and a replayed "
               "run's launches in a profiler trace; times: the solve "
               "path's form, x and the tables [V, D] in variable order, "
               "one launch a call with no gather or transpose around it")
    notes = {"packed_local_tables": k2_note,
             "packed_local_tables_mixed": k2_note,
             "dpop_whole_sweep_batched": (
                 f"make_batched_sweep_fn at B = {DPOP_BATCH} on the 10k "
                 f"bench tree: one launch a call (counted in "
                 f"dpop_whole_sweep); times: the batched call's events "
                 f"(its device us by the profiler: "
                 f"{b10k['profiler_us']}), bound over the B instances' "
                 f"tables")}
    # the launches of each path that runs K1 binary or K2
    by_path = {"packed_maxsum_cycle": {
        "maxsum": main_launches["packed_maxsum_cycle"],
        "maxsum_dynamic": dynamic_k1}}
    for name, inst in (("packed_local_tables", "coloring_10k_30k"),
                       ("packed_local_tables_mixed", "secp_3.9k")):
        by_path[name] = {
            "mgm_solve_result_chunk7": k2_by_path[f"mgm_solve_{inst}"],
            **{f"{algo}_collect_chunk8": k2_by_path[f"{algo}_collect_{inst}"]
               for algo in ("mgm", "dsa")}}
    kernels = []
    for name, source, replaces, launches, err in entries:
        size = sizes_of.get(name, "secp_3.9k" if "mixed" in name
                            else "10k_30k")
        row = timing[size, name]
        ms, plain, bound, by = row[:4]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by,
            "library_ms": row[4] if len(row) > 4 else None,
            **({"design": designs[name]} if name in designs else {}),
            **({"blocks": blocks_of[size, name]}
               if (size, name) in blocks_of else {}),
            **({"note": notes[name]} if name in notes else {}),
            **({"launches_by_path": by_path[name]}
               if name in by_path else {}),
        })
    # warm repair (no kernel: the warm engines are the generic cycles)
    # and the solution cache over the service, last: their host-bound
    # stream is the phase whose length varies most
    phase_seconds("times")
    warm_phase(smi)
    phase_seconds("warm")
    memo_phase(smi)
    phase_seconds("memo")
    # the fleets: a replica's sequential fallback launches K6 and K10
    # (the thread fleet's one CUDA context; two children's contexts)
    fleet_launches = fleet_phase(smi)
    phase_seconds("fleet")
    child_k6 = procfleet_phase(smi)
    phase_seconds("procfleet")
    # checkpoints, checkpoint faults, the orchestrator and the UI: K1,
    # K4 and K5 launch on this path
    resil = resilience_phase(smi)
    phase_seconds("resilience")
    resil_rows = {
        "packed_maxsum_cycle": {
            "resilience_maxsum_checkpointed": resil["maxsum_checkpointed"],
            "resilience_maxsum_checkpoint_faults":
                resil["maxsum_checkpoint_faults"],
            "resilience_orchestrator_maxsum": resil["orchestrator_maxsum"]},
        "packed_dsa_cycles": {
            "resilience_dsa_checkpointed": resil["dsa_checkpointed"]},
        "packed_mgm_cycles": {
            "resilience_mgm_checkpointed": resil["mgm_checkpointed"],
            "resilience_orchestrator_mgm": resil["orchestrator_mgm"],
            "resilience_orchestrator_mgm_ui": resil["orchestrator_mgm_ui"]},
        "packed_mgm_cycles_mixed": {
            "resilience_repair_dcop_maxsum":
                resil["orchestrator_maxsum_repair_mixed"],
            "resilience_repair_dcop_mgm":
                resil["orchestrator_mgm_repair_mixed"]},
    }
    # the compact collectives (K7, K8, K9 in the boundary-compacted modes,
    # one group and two) and the generic sharded engine
    compact_rows = sharded_compact_phase(smi)
    phase_seconds("sharded_compact")
    for row in kernels:
        paths = row.setdefault("launches_by_path", {})
        paths.update(resil_rows.get(row["name"], {}))
        paths.update(compact_rows.get(row["name"], {}))
        if row["name"] == "packed_mgm2_cycles":
            paths["fleet_replica_fallback_mgm2_job"] = fleet_launches["mgm2"]
            for child, n in sorted(child_k6.items()):
                paths[f"procfleet_{child}_fallback_mgm2_job"] = n
        elif row["name"] == "dpop_whole_sweep":
            paths["fleet_replica_fallback_dpop_job"] = \
                fleet_launches["dpop_whole_sweep"]
        if not paths:
            del row["launches_by_path"]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
