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
2. kernel_vs_plain: the MaxSum kernel against its plain PyTorch
   version, both on the card, for 20 cycles at damping 0.5 and 0, on the
   bench's 10k-variable / 30k-edge 3-colour coloring, a star with one
   variable of degree 2,500, and an instance with unequal domain sizes
   (tolerance atol 1e-4·(1+|x|) on q, r and beliefs; values exact except
   columns whose two best beliefs lie within 1e-4, which are counted);
   ls_kernel_vs_plain: the three local-search kernels (ls_tables,
   mgm_move, dsa_cycle) against their plain versions on the same three
   instances and a hard-cost colouring (10,000 on equal colours), from
   one x and one set of uniforms: tables, cur, best and gain equal (max
   abs error 0), x equal after 20 MGM cycles and after 20 cycles of DSA
   A/B/C, mixeddsa and adsa;
   mgm2_kernel_vs_plain: the MGM-2 kernels against their plain version
   on those four instances and the 100k/300k colouring, from one x and
   one set of coins: x equal after 20 cycles for each favor at
   threshold 0.5 and for unilateral at thresholds 0 and 1;
   dpop_kernel_vs_plain: the whole-sweep DPOP kernel against its plain
   version on the JAX bench's 10,000-node random tree (D=10), the same
   generator at 100,000 nodes, and 3,000-node forest, ragged-domain and
   max-mode trees: assign equal, msg and cs with max abs error 0, and
   assign equal to the level scan's;
   mixed_kernel_vs_plain: the mixed branches of the MaxSum kernel and of
   the three local-search kernels against their plain versions (the same
   rules as above) on five mixed-arity graphs: the JAX bench's SECP
   (generate_secp(3000 lights, 900 models, 300 rules, seed 1), arity <= 3
   at max_model_size 2 and <= 4 at 3), the latter at 10x (30,000 lights),
   a star whose hub holds 2,500 unary, binary and ternary factors, and a
   6,000-variable graph of arity 1-4 with domains of 4 and 3 values;
   there also the mixed branch of the MGM-2 kernels against its plain
   version, cycle by cycle for 20 cycles from one x and one set of coins,
   for each favor at threshold 0.5 (x equal after every cycle; offers,
   accepted pairs and pair moves printed; some graph must make pair
   moves);
   sharded_kernel_vs_plain: the per-shard kernels K7 (shard_fused_ba),
   K8 (shard_route_gains) and K9 (shard_tables) against their plain
   versions on the same inputs, launch by launch inside 20-cycle sharded
   runs on the card (maxsum at damping 0.5 and 0, mgm, dsa): the 10k/30k
   and 100k/300k colourings at 8 shards, the degree-2,500 star and the
   unequal-domains graph at 4, the hard colouring (K8's ties) at 8;
   tolerance K7 atol 1e-4·(1+|x|), K8 and K9 max abs error 0; there
   also amaxsum (activation 0.7) through K7's activation branch;
   sharded_mixed_kernel_vs_plain: the mixed branches of K7 (with and
   without activation), K8 and K9 against their plain versions, launch
   by launch, exactly (max abs error 0), on SECP-3.9k, SECP4-3.9k, the
   mixed star and the ragged mixed graph at 4 and 8 shards;
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
   the kernels of that path must have launched once per cycle (mgm: 200
   ls_tables + 200 mgm_move; dsa: 200 dsa_cycle; mgm2: the 6 × 200
   launches its host loop reports, and the cost of the CPU run), or for
   dpop once per tree level and phase (L UTIL + L VALUE launches, engine
   "wholesweep", cost equal to the CPU run's); then each path piece by
   piece (graph, compile, pack, cycles or sweep, coin draw and copy,
   scoring);
   main_path_mixed: the same on the 3,900-variable SECP for maxsum, mgm,
   dsa and mgm2 through the mixed kernels (200 launches of the mixed
   MaxSum kernel; 200 + 200 of ls_tables and mgm_move; 200 of dsa_cycle;
   6 x 200 of the mixed MGM-2 kernels), the cost equal to the CPU run of
   the same engine (``use_packed=True``);
   main_path_breakout: dba and gdba (A/NZ/E), 200 cycles on a
   10,000-variable / 30,000-constraint 3-colouring posed as a CSP (cost 1
   on equal colours), on the generic engine: no kernel launched, cost,
   assignment and stop cycle equal to the CPU run, and the breakdown;
   main_path_sharded: ``solve_result`` with a placement of 8 agents
   (blocks of variables) over the 10k/30k colouring, ``n_shards=8``, 200
   cycles on the card: 8 × 200 K7 launches, assignment, cost and cycle
   equal to the same call on the CPU, and the number of values that
   differ from single-device maxsum (printed, not gated);
   main_path_sharded_local_search: sharded mgm (8 × 200 K9 + 8 × 200 K8)
   and dsa (8 × 200 K9), 200 cycles at 8 shards, values equal to the CPU
   run with the same start and coins;
   main_path_sharded_mixed: ``solve -d`` on SECP-3.9k with 8 agents, 8
   shards, 200 cycles: one K7-mixed launch per shard holding factors and
   cycle and no other kernel's, assignment, cost and cycle equal to the
   CPU run; sharded mgm (K9- and K8-mixed), dsa and adsa (K9-mixed) on
   it, values equal to the CPU run;
   main_path_amaxsum: ``solve -a amaxsum`` on the 10k/30k colouring, one
   device, the generic engine (no kernel), equal to the CPU run;
   main_path_sharded_amaxsum: ``solve -d -a amaxsum`` on the 10k/30k
   colouring (8 × 200 K7-activation launches) and on SECP-3.9k (the
   mixed kernel's activation branch), each equal to the CPU run;
   instances: every test instance solved on the card and on the CPU by
   every algorithm of the port: assignment, cost and stop cycle must be
   equal (a mixed-arity instance, except by dba and gdba: against the
   CPU run with ``use_packed=True``, the card's engine; the CPU default,
   the generic engine, is printed beside it);
5. times: each kernel's ms per cycle or sweep (CUDA events around a run
   of launches, after warm-up; MGM-2: 200 cycles of one call) at 10k/30k
   and 100k/300k (DPOP: the 10k and 100k trees, 200 back-to-back
   sweeps; the mixed branches, MGM-2's included: the 3.9k SECPs of
   arity <= 3 and <= 4 and the 39k SECP; K7-K9: ms per launch at 8
   shards of the 10k/30k and 100k/300k colourings, and the sharded
   maxsum/mgm/dsa cycles/s; their mixed branches at SECP-3.9k and
   SECP-39k; K7's activation branch at 10k/30k, 100k/300k and SECP-3.9k
   with the sharded amaxsum cycles/s; single-device amaxsum cycles/s; K3
   at [3, 30,000] and [3, 300,000] beside ``torch.index_select``) beside
   its bytes bound, its plain version's time, and its device time per
   launch from a torch.profiler trace.

The last three lines are the card (``nvidia-smi`` name and power limit),
``{"kernels": [...]}`` (one entry per kernel: launches on its main path,
max error against the plain version, times and bound) and
``{"ok": true, "device": {...}}``.
"""
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
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(phase, msg):
    print(json.dumps({"phase": phase, "error": msg}), flush=True)
    sys.exit(1)


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


def kernel_vs_plain(pg, damping, cycles=20):
    """Run the kernel and the plain version from the same state; return
    (max abs error, near-tie value mismatches).  Raises on a mismatch."""
    import torch

    from pydcop_tpu_torch.ops.packed_maxsum import (
        packed_cycles,
        packed_cycles_plain,
        packed_init_state,
    )

    q, r = packed_init_state(pg)
    kq, kr, kb, kv = packed_cycles(pg, q, r, cycles, damping=damping)
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


def profile_us(run, names):
    """Device time per launch of each kernel whose name contains one of
    ``names``, from torch.profiler's CUDA trace of ``run()`` (None for a
    kernel the trace holds no device time for)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {}
    for name in names:
        total_us, n = 0.0, 0
        for e in prof.key_averages():
            if name in e.key:
                total_us += getattr(e, "device_time_total",
                                    getattr(e, "cuda_time_total", 0.0))
                n += e.count
        out[name] = total_us / n if n and total_us else None
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
    name = ("packed_maxsum_cycle_kernel" if pg.mixed is None
            else "packed_maxsum_mixed_kernel")
    device_us = profile_us(
        lambda: packed_cycles(pg, q, r, 50, damping=0.5), [name])[name]
    return ms, plain, bound, by, nbytes, device_us


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
    card, from one x and one set of uniforms.  Returns (max abs error
    over the tables/cur/best/gain and every x, stats); raises on any
    difference."""
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

    for prefer in (False, True):
        k = P.ls_tables(pls, x, prefer_change=prefer)
        p = P.ls_tables_plain(pls, x, prefer_change=prefer)
        for name, a, b in zip(("tables", "cur", "best", "gain"), k, p):
            same(f"ls_tables {name} prefer_change={prefer}", a, b)
    same("packed_local_tables", P.packed_local_tables(pls, P.unpack_x(pls, x)),
         P.ls_tables_plain(pls, x)[0][:, pls.pg.var_order].T)
    km = P.packed_mgm_cycles(pls, x, cycles)
    same(f"mgm x after {cycles} cycles", km,
         P.packed_mgm_cycles_plain(pls, x, cycles))
    stats = {"mgm_moved": int((km != x).sum())}
    for rule, kw in DSA_RULES.items():
        kw = dict(kw)
        act = kw.pop("activation", None)
        aw = None if act is None else w
        k = P.packed_dsa_cycles(pls, x, u, awake_uniforms=aw,
                                activation=act, **kw)
        same(f"{rule} x after {cycles} cycles", k,
             P.packed_dsa_cycles_plain(pls, x, u, awake_uniforms=aw,
                                       activation=act, **kw))
        stats[f"{rule}_moved"] = int((k != x).sum())
    _, cur, best, gain = P.ls_tables(pls, x, prefer_change=True)
    stats["conflicted"] = int((cur >= 10000.0).sum())
    stats["lateral"] = int(((gain <= 1e-9) & (best != x)
                            & (cur >= 10000.0)).sum())
    return err, stats


def ls_bytes_ops(pls):
    """Bytes and float operations one call must move and do, per kernel
    entry point, each input read once and each output written once:

    * packed_local_tables (ls_tables): x, the D selected cost floats and
      mate_col of each slot, unary and mask columns, the three column
      arrays; out the tables, cur, best and gain;
    * packed_mgm_cycles, per cycle: the same inputs plus mate_idx and
      col_var; out x';
    * packed_dsa_cycles, per cycle: the same inputs plus the move coins;
      out x'.

    On the mixed layout a slot also reads its arity and cost_idx and up
    to three sibling columns (MGM: three sibling indices)."""
    D, N, Vp = pls.D, pls.N, pls.Vp
    sibs = 1 if pls.pg.mixed is None else 3
    slot_ints = N if pls.pg.mixed is None else 5 * N
    common = D * N + 2 * D * Vp + Vp + slot_ints + 3 * Vp
    ops = N * D + Vp * 4 * D
    return {
        "packed_local_tables": (4 * (common + D * Vp + 3 * Vp), ops),
        "packed_mgm_cycles": (4 * (common + sibs * N + Vp + Vp),
                              ops + 2 * sibs * N + 6 * Vp),
        "packed_dsa_cycles": (4 * (common + Vp + Vp), ops + 8 * Vp),
    }


def time_ls(pls, reps=200):
    """{kernel: (ms per call/cycle, plain ms, bound ms, bound_by, bytes,
    device us per cycle)} for the three local-search entry points."""
    import torch

    from pydcop_tpu_torch.ops import packed_local_search as P

    x = random_x_col(pls, 1)
    u = torch.rand((reps, pls.Vp), device=pls.device)
    scratch = P.ls_tables(pls, x)
    runs = {
        "packed_local_tables": (
            lambda: cuda_ms(lambda: P.ls_tables(pls, x, out=scratch), reps),
            lambda: cuda_ms(lambda: P.ls_tables_plain(pls, x), 20),
            lambda: P.ls_tables(pls, x, out=scratch), ["ls_tables_kernel"]),
        "packed_mgm_cycles": (
            lambda: cuda_ms(lambda: P.packed_mgm_cycles(pls, x, reps),
                            1) / reps,
            lambda: cuda_ms(lambda: P.packed_mgm_cycles_plain(pls, x, 5),
                            1) / 5,
            lambda: P.packed_mgm_cycles(pls, x, 50),
            ["ls_tables_kernel", "mgm_move_kernel"]),
        "packed_dsa_cycles": (
            lambda: cuda_ms(lambda: P.packed_dsa_cycles(pls, x, u, 0.7),
                            1) / reps,
            lambda: cuda_ms(lambda: P.packed_dsa_cycles_plain(
                pls, x, u[:5], 0.7), 1) / 5,
            lambda: P.packed_dsa_cycles(pls, x, u[:50], 0.7),
            ["dsa_cycle_kernel"]),
    }
    out = {}
    for name, (timed, plain, prof, names) in runs.items():
        prof()  # warm-up
        ms, plain_ms = timed(), plain()
        # device time per cycle: each kernel of the entry point launches
        # once per cycle
        us = profile_us(prof, names)
        device_us = None if None in us.values() else sum(us.values())
        nbytes, nops = ls_bytes_ops(pls)[name]
        bound, by = bound_of(nbytes, nops)
        out[name] = (ms, plain_ms, bound, by, nbytes, device_us)
    return out


#: the MGM-2 rules held against the plain version on the card: every
#: favor at threshold 0.5, and thresholds 0 (no offerer) and 1 (every
#: offer meets an offerer) once
MGM2_RULES = [("unilateral", 0.5), ("no", 0.5), ("coordinated", 0.5),
              ("unilateral", 0.0), ("unilateral", 1.0)]
MGM2_KERNELS = ["mgm2_tables_kernel", "mgm2_offer_kernel",
                "mgm2_response_kernel", "mgm2_commit_kernel",
                "mgm2_winner_kernel", "mgm2_go_kernel"]


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


def mgm2_kernel_vs_plain(pm, cycles=20, seed=0):
    """The MGM-2 kernels against their plain version on the card, from
    one x and one set of coins, for each rule of MGM2_RULES.  Returns
    (max abs error over every x, stats); raises on any difference."""
    import torch

    from pydcop_tpu_torch.ops.packed_mgm2 import (
        packed_mgm2_cycles,
        packed_mgm2_cycles_plain,
    )

    x = random_x_col(pm.pls, seed)
    u = mgm2_coins(pm.pls, cycles, seed)
    err, stats = 0.0, {}
    for favor, threshold in MGM2_RULES:
        k = packed_mgm2_cycles(pm, x, *u, threshold, favor)
        p = packed_mgm2_cycles_plain(pm, x, *u, threshold, favor)
        torch.cuda.synchronize()
        if not torch.equal(k, p):
            raise AssertionError(
                f"favor={favor} threshold={threshold}: x after {cycles} "
                f"cycles differs from plain in {int((k != p).sum())} "
                f"columns")
        err = max(err, float((k.double() - p.double()).abs().max()))
        stats[f"{favor}_{threshold}_moved"] = int((k != x).sum())
    stats["offers_per_cycle_0.5"] = mgm2_offers(pm, u[0], u[1], 0.5)
    return err, stats


def mgm2_mixed_vs_plain(pm, cycles=20, seed=0):
    """The mixed branch of the MGM-2 kernels against its plain version on
    the card, cycle by cycle from one x and one set of coins, for each
    favor at threshold 0.5: x equal after every cycle.  Returns (max abs
    error, stats with the offers, accepted pairs and pair moves of each
    run, counted by the plain version); raises on any difference."""
    import torch

    from pydcop_tpu_torch.ops.packed_mgm2 import (
        mgm2_cycle_plain,
        packed_mgm2_cycles,
    )

    x0 = random_x_col(pm.pls, seed)
    u = mgm2_coins(pm.pls, cycles, seed)
    err, stats = 0.0, {}
    for favor in ("unilateral", "no", "coordinated"):
        xk = xp = x0
        counts = {}
        for c in range(cycles):
            xk = packed_mgm2_cycles(pm, xk, *(a[c: c + 1] for a in u), 0.5,
                                    favor)
            xp = mgm2_cycle_plain(pm, xp, *(a[c] for a in u), 0.5, favor,
                                  stats=counts)
            torch.cuda.synchronize()
            if not torch.equal(xk, xp):
                raise AssertionError(
                    f"favor={favor}: x after cycle {c} differs from plain "
                    f"in {int((xk != xp).sum())} columns")
            err = max(err, float((xk.double() - xp.double()).abs().max()))
        stats[favor] = dict(counts, moved=int((xk != x0).sum()))
    return err, stats


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
    from the profiler (the six kernels' per-launch times summed), the
    per-launch time of each kernel, offers per cycle)."""
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
    us = profile_us(lambda: packed_mgm2_cycles(
        pm, x, *(a[:50] for a in u), threshold, favor), MGM2_KERNELS)
    device_us = None if None in us.values() else sum(us.values())
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
    """The whole-sweep kernel against its plain version on the card, and
    its assignment against the level scan's.  Returns the max abs error
    over assign, msg and cs; raises on any difference."""
    import torch

    from pydcop_tpu_torch.ops.dpop_sweep import run_sweep
    from pydcop_tpu_torch.ops.packed_dpop import (
        whole_sweep,
        whole_sweep_plain,
    )

    k = whole_sweep(ps)
    p = whole_sweep_plain(ps)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("assign", "msg", "cs"), k, p):
        if a.is_floating_point() and not torch.isfinite(a).all():
            raise AssertionError(f"kernel {name} has non-finite values")
        if not torch.equal(a, b):
            raise AssertionError(f"kernel {name} differs from plain in "
                                 f"{int((a != b).sum())} entries")
        err = max(err, float((a.double() - b.double()).abs().max()))
    if not np.array_equal(k[0].cpu().numpy(), run_sweep(plan)[0]):
        raise AssertionError("kernel assign differs from the level scan's")
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
    profiler)."""
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
    names = ["dpop_util_level_kernel", "dpop_value_level_kernel"]
    us = profile_us(lambda: [whole_sweep(ps) for _ in range(20)], names)
    device_us = (None if None in us.values()
                 else ps.L * (us[names[0]] + us[names[1]]))
    return ms, plain, bound, by, nbytes, device_us


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
    from pydcop_tpu_torch.ops import packed_dpop, packed_mgm2, \
        packed_sharded
    from pydcop_tpu_torch.ops import packed_local_search as P
    from pydcop_tpu_torch.ops.packed_maxsum import packed_cycles

    from pydcop_tpu_torch.ops.permute import lane_permute

    packed_cycles.launches = packed_cycles.mixed_launches = 0
    P.reset_launches()
    packed_dpop.reset_launches()
    packed_mgm2.reset_launches()
    packed_sharded.reset_launches()
    lane_permute.launches = 0


def read_counts():
    from pydcop_tpu_torch.ops import packed_local_search as P
    from pydcop_tpu_torch.ops import packed_sharded as K
    from pydcop_tpu_torch.ops.packed_dpop import whole_sweep
    from pydcop_tpu_torch.ops.packed_maxsum import packed_cycles
    from pydcop_tpu_torch.ops.packed_mgm2 import packed_mgm2_cycles
    from pydcop_tpu_torch.ops.permute import lane_permute

    return {"packed_maxsum_cycle": packed_cycles.launches,
            "ls_tables": P.ls_tables.launches,
            "mgm_move": P.mgm_move.launches,
            "dsa_cycle": P.dsa_cycle.launches,
            "packed_maxsum_mixed": packed_cycles.mixed_launches,
            "ls_tables_mixed": P.ls_tables.mixed_launches,
            "mgm_move_mixed": P.mgm_move.mixed_launches,
            "dsa_cycle_mixed": P.dsa_cycle.mixed_launches,
            "dpop_util_level": whole_sweep.util_launches,
            "dpop_value_level": whole_sweep.value_launches,
            "mgm2": packed_mgm2_cycles.launches,
            "mgm2_mixed": packed_mgm2_cycles.mixed_launches,
            "shard_fused_ba": K.shard_fused_ba.launches,
            "shard_route_gains": K.shard_route_gains.launches,
            "shard_tables": K.shard_tables.launches,
            "shard_fused_ba_mixed": K.shard_fused_ba.mixed_launches,
            "shard_fused_ba_act": K.shard_fused_ba.act_launches,
            "shard_fused_ba_mixed_act": K.shard_fused_ba.mixed_act_launches,
            "shard_route_gains_mixed": K.shard_route_gains.mixed_launches,
            "shard_tables_mixed": K.shard_tables.mixed_launches,
            "lane_permute": lane_permute.launches}


def breakdown(dcop, algo, cycles, dev):
    """Where a solve's time goes, piece by piece (host clock around work
    that ends in a synchronize): the computation graph, compile, pack,
    the cycles, the coin copy (DSA and MGM-2: per chunk of 100 cycles,
    the fixed-cycle chunk; MGM-2 draws three [100, V] tables a chunk) and
    scoring."""
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
    solver_cls = {"maxsum": "MaxSumSolver", "mgm": "MgmSolver",
                  "dsa": "DsaSolver", "mgm2": "Mgm2Solver",
                  "dba": "DbaSolver", "gdba": "GdbaSolver"}[algo]
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


def mixed_dcop(V, D, counts, seed, ragged=False, hub=False):
    """A random mixed-arity DCOP of the port's objects: ``counts`` maps
    an arity to its number of factors over random distinct variables
    (``hub``: every factor holds variable 0, the others distinct), costs
    uniform in [0, 5); ``ragged`` puts every second variable on D - 1
    values."""
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
            m = rng.uniform(0, 5, [len(v.domain) for v in sc])
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


def checked_kernels(errs, exact_only=False):
    """Context manager: while active, the engines' K7/K8/K9 calls run the
    kernel AND its plain version on the same inputs, hold them together
    (K7: atol 1e-4·(1+|x|), or exactly with ``exact_only``; K8, K9:
    exactly) and carry on with the kernel's outputs.  ``errs`` collects
    the max abs error per kernel and branch (``_mixed`` for a mixed
    layout, ``_act`` for K7 with an activation row)."""
    import contextlib

    import torch

    from pydcop_tpu_torch.ops import packed_sharded as K

    def check(base, kernel, plain, exact):
        def run(sh, *args):
            name = base + ("_mixed" if sh.mixed is not None else "") \
                + ("_act" if len(args) > 3 else "")
            k = kernel(sh, *args)  # counts on the wrapper's counters
            p = plain(sh, *args)
            ks = k if isinstance(k, tuple) else (k,)
            ps = p if isinstance(p, tuple) else (p,)
            torch.cuda.synchronize()
            for a, b in zip(ks, ps):
                d = (a.double() - b.double()).abs()
                err = float(d.max()) if d.numel() else 0.0
                errs[name] = max(errs.get(name, 0.0), err)
                ok = (torch.equal(a, b) if exact else
                      bool(torch.all(d <= TOL * (1 + b.double().abs()))))
                if not ok:
                    raise AssertionError(
                        f"{name} shard {sh.index}: kernel differs from "
                        f"plain (max abs error {err})")
            return k
        return run

    @contextlib.contextmanager
    def patched():
        real = (K.shard_fused_ba, K.shard_route_gains, K.shard_tables)
        K.shard_fused_ba = check("shard_fused_ba", real[0],
                                 K.shard_fused_ba_plain, exact_only)
        K.shard_route_gains = check("shard_route_gains", real[1],
                                    K.shard_route_gains_plain, True)
        K.shard_tables = check("shard_tables", real[2],
                               K.shard_tables_plain, True)
        try:
            yield
        finally:
            K.shard_fused_ba, K.shard_route_gains, K.shard_tables = real
    return patched()


def sharded_kernel_vs_plain(t, n_shards, cycles=20, exact_only=False):
    """K7, K8 and K9 against their plain versions on the card, per shard
    and per cycle, inside real sharded runs: maxsum at damping 0.5 and 0
    (K7), amaxsum at activation 0.7 (K7's activation branch), mgm and
    dsa (K9, K8 in mgm), ``cycles`` cycles each; on a mixed graph the
    kernels' mixed branches.  Returns (errs per kernel and branch,
    stats)."""
    import torch

    from pydcop_tpu_torch.parallel import ShardedLocalSearch, \
        ShardedMaxSum, build_mesh

    errs = {}
    mesh = build_mesh(n_shards, "cuda")
    with checked_kernels(errs, exact_only):
        for damping in (0.5, 0.0):
            ShardedMaxSum(t, mesh, damping=damping).run(cycles)
        # amaxsum: K7's activation branch
        ShardedMaxSum(t, mesh, damping=0.5, activation=0.7).run(cycles)
        moved = {}
        for rule in ("mgm", "dsa"):
            eng = ShardedLocalSearch(t, mesh, rule=rule)
            x0 = eng.run_chunked(0, seed=1)[1]
            _, x, _ = eng.run_chunked(cycles, x=x0, seed=1)
            moved[rule] = int((x != x0).sum())
    packs = ShardedMaxSum(t, mesh).packs
    Ns = [sh.N for sh in packs.shards]
    torch.cuda.synchronize()
    extra = {}
    if packs.mixed:
        extra["slots_by_arity"] = [
            sum(len(sh.slot_of.get(a, ())) for sh in packs.shards)
            for a in (1, 2, 3, 4)]
    return errs, dict(
        **extra,
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
    """{kernel: (bytes, operations)} of one launch, averaged over the
    shards that launch.  Each input read once, each output written once:
    the combined beliefs / gains / values at the columns the shard
    touches, each factor's table once (K7: D^a entries for an arity-a
    factor, though the layout keeps a rotated copy per slot; K9 reads
    the D entries its values select), the slot arrays (vmask,
    inv_dcount, the gain masks, and the ints each slot's kernel reads:
    on a mixed layout its arity and cost index and, for each of its
    a - 1 siblings, the slot and column in K7 or the column in K9), the
    four thread arrays; out r_new and
    the [D, Vp] partial, or nm_part and the routed gains.  ``act`` adds
    K7's activation operands: q_m, r_m and the active row in, q1 and r1
    out."""
    D, Vp = packs.D, packs.Vp
    rows = []
    for sh in packs.shards:
        if not sh.N:
            continue
        N = sh.N
        touched = int((sh.t_deg > 0).sum())
        walk = 4 * Vp
        if sh.mixed is None:
            n_a = {2: N}
            sibs = 1
            # mate and mate_col a slot
            ints7, ints9 = 2 * N, N
        else:
            n_a = {a: len(sh.slot_of.get(a, ())) for a in (1, 2, 3, 4)}
            sibs = 3
            # arity and cost_idx a slot, and each of its a - 1 siblings'
            # slot and column (K7) or column (K9)
            ints7 = sum(n * 2 * a for a, n in n_a.items())
            ints9 = sum(n * (a + 1) for a, n in n_a.items())
        table = sum(D ** a * n // a for a, n in n_a.items())
        k7 = (D * touched + D * N + table + D * N + N + ints7
              + walk + D * N + D * Vp)
        if act:
            k7 += 2 * D * N + N + 2 * D * N
        # per slot: the pending side of each sibling (D subtractions, D
        # multiply-adds, D subtract-multiplies, one multiply), the factor
        # side (binary D adds and D-1 mins a value; arity a about
        # 3 D^(a-1) a value), vmask, damping (3) and the partial add
        side = sum(n * (a - 1) * (5 * D + 1) for a, n in n_a.items())
        factor = sum(n * (D * (2 * D - 1) if a == 2 else 3 * D ** a)
                     for a, n in n_a.items() if a > 1)
        ops7 = side + factor + N * 5 * D
        k8 = touched + sibs * N * 2 + walk + Vp + sibs * N
        k9 = touched + D * N + ints9 + walk + D * Vp
        rows.append(((4 * k7, ops7), (4 * k8, 2 * sibs * N),
                     (4 * k9, D * N)))
    n = len(rows)
    return {name: (sum(r[i][0] for r in rows) / n,
                   sum(r[i][1] for r in rows) / n)
            for i, name in enumerate(("packed_shard_fused_ba",
                                      "packed_shard_route_gains",
                                      "packed_shard_tables"))}


def time_sharded(t, n_shards, reps=100, amaxsum=False):
    """Per-launch ms (CUDA events over ``reps`` rounds of one launch per
    shard), the plain versions' ms, device us per launch (profiler),
    bounds, and the sharded cycles/s of maxsum, mgm and dsa (host clock
    over 200 cycles, ending in a synchronize); on a mixed graph the
    kernels' mixed branches.  ``amaxsum``: K7's activation branch at
    activation 0.7 instead, and the sharded amaxsum cycles/s."""
    import torch

    from pydcop_tpu_torch.ops import packed_sharded as K
    from pydcop_tpu_torch.parallel import ShardedLocalSearch, \
        ShardedMaxSum, build_mesh

    mesh = build_mesh(n_shards, "cuda")
    ms_eng = ShardedMaxSum(t, mesh, activation=0.7 if amaxsum else None)
    packs = ms_eng.packs
    mixed = "_mixed" if packs.mixed else ""
    live = [sh for sh in packs.shards if sh.N]
    _, state, _ = ms_eng.run(5)
    bo = sharded_bytes_ops(packs, act=amaxsum)
    if amaxsum:
        q_m, r_m, r_u, bel, _ = state
        g = torch.Generator(device="cpu").manual_seed(0)
        act = [(torch.rand(sh.N, generator=g) < 0.7).float().cuda()
               for sh in packs.shards]

        def k7(sh):
            s = sh.index
            return (sh, bel[s], r_u[s], 0.5, q_m[s], r_m[s], act[s])
        calls = {"packed_shard_fused_ba": (
            lambda sh: K.shard_fused_ba(*k7(sh)),
            lambda sh: K.shard_fused_ba_plain(*k7(sh)),
            f"shard_fused_ba{mixed}_kernel")}
    else:
        r_u, bel = state
        ls = ShardedLocalSearch(t, mesh, rule="mgm")
        x = ls.run_chunked(5, seed=0)[1]
        unary_p, mask_p, _ = packs.common_on(x.device)
        tables = torch.where(mask_p > 0, unary_p + sum(
            K.shard_tables(sh, x) for sh in live), 1e30)
        gain = K.cur_best_gain(tables, x, False)[2]
        calls = {
            "packed_shard_fused_ba": (
                lambda sh: K.shard_fused_ba(sh, bel[sh.index],
                                            r_u[sh.index], 0.5),
                lambda sh: K.shard_fused_ba_plain(sh, bel[sh.index],
                                                  r_u[sh.index], 0.5),
                f"shard_fused_ba{mixed}_kernel"),
            "packed_shard_route_gains": (
                lambda sh: K.shard_route_gains(sh, gain),
                lambda sh: K.shard_route_gains_plain(sh, gain),
                f"shard_route_gains{mixed}_kernel"),
            "packed_shard_tables": (
                lambda sh: K.shard_tables(sh, x),
                lambda sh: K.shard_tables_plain(sh, x),
                f"shard_tables{mixed}_kernel"),
        }
    out = {}
    for name, (kern, plain, kname) in calls.items():
        def rounds(fn, n):
            for _ in range(n):
                for sh in live:
                    fn(sh)
        rounds(kern, 3)  # warm-up
        ms = cuda_ms(lambda: rounds(kern, reps), 1) / (reps * len(live))
        plain_ms = cuda_ms(lambda: rounds(plain, 3), 1) / (3 * len(live))
        device_us = profile_us(lambda: rounds(kern, 10), [kname])[kname]
        bound, by = bound_of(*bo[name])
        out[name + mixed + ("_act" if amaxsum else "")] = dict(
            kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            bytes_per_launch=bo[name][0], profiler_kernel_us=device_us,
            launches_per_cycle=len(live))
    rates = {}
    if amaxsum:
        runs = (("amaxsum", lambda: ms_eng.run(200)),)
    else:
        dsa = ShardedLocalSearch(t, mesh, rule="dsa")
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
    from pydcop_tpu_torch.ops.packed_maxsum import pack_for_gpu
    from pydcop_tpu_torch.ops.packed_mgm2 import LAUNCHES_PER_CYCLE, \
        pack_mgm2_from_pls
    from pydcop_tpu_torch.runtime import solve_result

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device + build ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    build_s = cuda_build.build_all()
    ptxas = " | ".join(
        ln.strip() for log in cuda_build.build_logs.values()
        for ln in log.splitlines() if "registers" in ln or "spill" in ln)
    say("device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), build_s=round(build_s, 3),
        ptxas=ptxas)

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
    for name, pg in cases.items():
        if pg is None:
            fail("kernel_vs_plain", f"{name} did not pack")
        for damping in (0.5, 0.0):
            try:
                err, ties = kernel_vs_plain(pg, damping)
            except AssertionError as e:
                fail("kernel_vs_plain", f"{name} damping={damping}: {e}")
            if name == "coloring_10k_30k":
                main_err = max(main_err, err)
            say("kernel_vs_plain", case=name, damping=damping, D=pg.D,
                N=pg.N, Vp=pg.Vp, max_deg=int(pg.col_deg.max()),
                max_abs_err=err, near_tie_value_diffs=ties)

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

    big_arrays = coloring_arrays(100_000, 300_000)
    big_t = compile_binary_from_arrays(
        *big_arrays[:3], 100_000, unary=big_arrays[3], device=dev)
    big = pack_for_gpu(big_t)
    mgm2_err = 0.0
    for name, pg in list(cases.items()) + [("coloring_100k_300k", big)]:
        pm = pack_mgm2_from_pls(pack_from_pg(pg))
        try:
            err, stats = mgm2_kernel_vs_plain(pm)
        except AssertionError as e:
            fail("mgm2_kernel_vs_plain", f"{name}: {e}")
        mgm2_err = max(mgm2_err, err)
        say("mgm2_kernel_vs_plain", case=name, D=pg.D, N=pg.N, Vp=pg.Vp,
            max_deg=int(pg.col_deg.max()), max_abs_err=err, cycles=20,
            **stats)

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
            dpop_packed[name] = (dcop, ps)
        say("dpop_kernel_vs_plain", case=name, n_nodes=ps.n_nodes, D=ps.D,
            L=ps.L, Bmax=plan.Bmax, max_children=ps.max_children,
            roots=len(tree.roots), mode=ps.mode, max_abs_err=err,
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
                err, ties = kernel_vs_plain(pg, damping)
            except AssertionError as e:
                fail("mixed_kernel_vs_plain", f"{name} damping={damping}: "
                     f"{e}")
            mixed_err = max(mixed_err, err)
            say("mixed_kernel_vs_plain", kernel="packed_maxsum_mixed_cycle",
                case=name, damping=damping, D=pg.D, N=pg.N, Vp=pg.Vp,
                slots_by_arity=slots, max_deg=int(pg.col_deg.max()),
                max_abs_err=err, near_tie_value_diffs=ties,
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
        pair_moves += sum(v.get("pair_moves", 0) for v in stats.values())
        say("mgm2_kernel_vs_plain", layout="mixed", case=name, D=pg.D,
            N=pg.N, Vp=pg.Vp, binary_slots=int(pm.deg_col.sum()),
            max_abs_err=err, cycles=20, threshold=0.5, **stats)
    if not pair_moves:
        fail("mgm2_kernel_vs_plain", "no mixed graph made a pair move: the "
             "pairing of the mixed branch went unchecked")

    # the per-shard kernels K7-K9 against their plain versions, launch by
    # launch inside real sharded runs on the card
    sharded_cases = {
        "coloring_10k_30k": (primary_t, SHARDS),
        "coloring_100k_300k": (big_t, SHARDS),
        "star_deg2500": (star_tensors(2500, dev), 4),
        "unequal_domains_d4": (
            unequal_domains_tensors(5000, 15_000, 4, dev), 4),
        "hard_coloring_10k_30k": (
            hard_coloring_tensors(10_000, 30_000, dev), SHARDS),
    }
    sharded_err = {}
    for name, (t, n_shards) in sharded_cases.items():
        t0 = time.perf_counter()
        try:
            errs, stats = sharded_kernel_vs_plain(t, n_shards)
        except AssertionError as e:
            fail("sharded_kernel_vs_plain", f"{name}: {e}")
        for k, v in errs.items():
            sharded_err[k] = max(sharded_err.get(k, 0.0), v)
        if set(errs) != {"shard_fused_ba", "shard_fused_ba_act",
                         "shard_route_gains", "shard_tables"}:
            fail("sharded_kernel_vs_plain", f"{name}: only {sorted(errs)} "
                 f"were checked")
        say("sharded_kernel_vs_plain", case=name, cycles=20,
            max_abs_err=errs, seconds=round(time.perf_counter() - t0, 3),
            **stats)

    # the mixed branches of K7 (with and without activation), K8 and K9
    # against their plain versions, launch by launch, exactly
    sharded_mixed_err = {}
    for name in ("secp_3.9k", "secp4_3.9k", "mixed_star_deg2500",
                 "ragged_mixed_d4"):
        t = compile_factor_graph(mixed_dcops[name], device=dev)
        for n_shards in (4, SHARDS):
            t0 = time.perf_counter()
            try:
                errs, stats = sharded_kernel_vs_plain(t, n_shards,
                                                      exact_only=True)
            except AssertionError as e:
                fail("sharded_mixed_kernel_vs_plain", f"{name} S={n_shards}:"
                     f" {e}")
            for k, v in errs.items():
                sharded_mixed_err[k] = max(sharded_mixed_err.get(k, 0.0), v)
            if set(errs) != {"shard_fused_ba_mixed", "shard_fused_ba_mixed_act",
                             "shard_route_gains_mixed", "shard_tables_mixed"}:
                fail("sharded_mixed_kernel_vs_plain", f"{name}: only "
                     f"{sorted(errs)} were checked")
            say("sharded_mixed_kernel_vs_plain", case=name, cycles=20,
                max_abs_err=errs, seconds=round(time.perf_counter() - t0, 3),
                **stats)

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

    # 3. CLI paths ---------------------------------------------------------
    from pydcop_tpu_torch.dcop import load_dcop_from_file

    tuto = os.path.join(ROOT, "tests", "instances", "graph_coloring_tuto.yaml")
    for algo in ("maxsum", "mgm", "dsa", "mgm2", "dpop", "dba", "gdba"):
        phase = {"maxsum": "cli", "dpop": "cli_dpop"}.get(
            algo, "cli_local_search")
        proc = subprocess.run(
            [sys.executable, "-m", "pydcop_tpu_torch", "solve", "-a", algo,
             tuto], capture_output=True, text=True, timeout=300, cwd=ROOT)
        try:
            out = json.loads(proc.stdout)
        except ValueError:
            fail(phase, f"{algo}: rc={proc.returncode} no JSON; stderr: "
                 f"{proc.stderr[-2000:]}")
        want = 12 if algo in ("maxsum", "dpop") else solve_result(
            load_dcop_from_file([tuto]), algo, device="cpu").cost
        if proc.returncode != 0 or out.get("status") != "FINISHED" \
                or out.get("cost") != want:
            fail(phase, f"{algo}: rc={proc.returncode} "
                 f"status={out.get('status')} cost={out.get('cost')} "
                 f"(expected {want}) error={out.get('error')}")
        say(phase, algo=algo, status=out["status"], cost=out["cost"],
            cpu_cost=want, cycle=out["cycle"], assignment=out["assignment"])

    # 4. main paths at full width ------------------------------------------
    t0 = time.perf_counter()
    dcop = coloring_dcop(10_000, 30_000)
    build_dcop_s = time.perf_counter() - t0
    cycles = 200
    jax_keys = {"status", "assignment", "cost", "violation", "cycle",
                "msg_count", "msg_size", "time", "harness", "config"}
    main_launches = {}
    for algo, expect in (
            ("maxsum", {"packed_maxsum_cycle": cycles}),
            ("mgm", {"ls_tables": cycles, "mgm_move": cycles}),
            ("dsa", {"dsa_cycle": cycles}),
            ("mgm2", {"mgm2": cycles * LAUNCHES_PER_CYCLE})):
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
        if algo == "mgm2":
            cpu = solve_result(dcop, algo, cycles=cycles, device="cpu")
            if res.cost != cpu.cost or res.assignment != cpu.assignment:
                fail(phase, f"mgm2: card cost {res.cost} != CPU cost "
                     f"{cpu.cost} (same assignment: "
                     f"{res.assignment == cpu.assignment})")
            extra = {"cpu_cost": cpu.cost}
        say(phase, algo=algo, launches=counts, cycle=res.cycle,
            status=res.status, cost=res.cost, violation=res.violation,
            msg_count=res.msg_count, build_dcop_s=round(build_dcop_s, 3),
            solve_s=round(solve_s, 3), harness=res.metrics()["harness"],
            **extra)
        say(phase + "_breakdown", algo=algo, nvidia_smi=smi,
            **breakdown(dcop, algo, cycles, dev))

    # dpop on the bench's 10k-node tree: one whole sweep, L + L launches
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
    want.update(dpop_util_level=L, dpop_value_level=L)
    if counts != want:
        fail("main_path_dpop", f"launches {counts} in one dpop solve, "
             f"expected {want}")
    main_launches.update(dpop_whole_sweep=counts["dpop_util_level"]
                         + counts["dpop_value_level"])
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
            ("mgm", {"ls_tables_mixed": cycles, "mgm_move_mixed": cycles}),
            ("dsa", {"dsa_cycle_mixed": cycles}),
            ("mgm2", {"mgm2_mixed": cycles * LAUNCHES_PER_CYCLE})):
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
        say("main_path_mixed_breakdown", algo=algo, nvidia_smi=smi,
            **breakdown(secp, algo, cycles, dev))

    # the breakout algorithms on a 10k-variable / 30k-constraint colouring
    # CSP: the generic engine (plain PyTorch on the card, as the JAX
    # package runs them in XLA), so no kernel counter may move
    t0 = time.perf_counter()
    csp = coloring_csp_dcop(10_000, 30_000)
    build_csp_s = time.perf_counter() - t0
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
    # the card, each cycle 8 K7 launches and one ordered sum; the card is
    # held to the CPU run (the plain versions) of the same shards
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
    want["shard_fused_ba"] = SHARDS * cycles
    if counts != want:
        fail("main_path_sharded", f"launches {counts} in a {cycles}-cycle "
             f"{SHARDS}-shard solve, expected {want}")
    main_launches.update(shard_fused_ba=counts["shard_fused_ba"])
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
    for rule, expect in (
            ("mgm", {"shard_tables": cycles, "shard_route_gains": cycles}),
            ("dsa", {"shard_tables": cycles})):
        eng = ShardedLocalSearch(cg_cuda, build_mesh(SHARDS, "cuda"),
                                 rule=rule)
        reset_counts()
        t0 = time.perf_counter()
        values = eng.run(cycles, seed=0)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        want = {k: SHARDS * expect.get(k, 0) for k in counts}
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
    # launch per shard; held to the CPU run of the same shards
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
        want[expect_key] = live * cycles
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

    main_launches["shard_fused_ba_mixed"] = solve_d(
        secp, "maxsum", "shard_fused_ba_mixed", "main_path_sharded_mixed",
        "secp_3.9k")

    # sharded mgm (K9 + K8 mixed), dsa and adsa (K9 mixed) on the SECP, 8
    # shards on the card against the CPU: the same start and coins
    secp_cuda = compile_constraint_graph(secp, device=dev)
    secp_cpu = compile_constraint_graph(secp, device="cpu")
    for rule, expect in (
            ("mgm", {"shard_tables_mixed": cycles,
                     "shard_route_gains_mixed": cycles}),
            ("dsa", {"shard_tables_mixed": cycles}),
            ("adsa", {"shard_tables_mixed": cycles})):
        eng = ShardedLocalSearch(secp_cuda, build_mesh(SHARDS, "cuda"),
                                 rule=rule)
        live = sum(1 for sh in eng.packs.shards if sh.N)
        reset_counts()
        t0 = time.perf_counter()
        values = eng.run(cycles, seed=0)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        want = {k: live * expect.get(k, 0) for k in counts}
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
    # activation launch per shard (the binary colouring, then the SECP
    # through the mixed kernel's activation branch)
    main_launches["shard_fused_ba_act"] = solve_d(
        dcop, "amaxsum", "shard_fused_ba_act", "main_path_sharded_amaxsum",
        "coloring_10k_30k")
    main_launches["shard_fused_ba_mixed_act"] = solve_d(
        secp, "amaxsum", "shard_fused_ba_mixed_act",
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
        for algo in ("maxsum", "mgm", "dsa", "dsatuto", "mixeddsa", "adsa",
                     "mgm2", "dpop", "dba", "gdba"):
            params = {"noise": 0} if algo == "maxsum" else None
            g = solve_result(d, algo, algo_params=params, device="cuda")
            c = solve_result(d, algo, algo_params=params, device="cpu")
            extra = {}
            if mixed and algo not in ("dpop", "dba", "gdba"):
                extra = dict(cpu_default_cost=c.cost,
                             cpu_default_cycle=c.cycle)
                c = solve_cpu_packed(d, algo, params)
            same = (g.assignment == c.assignment and g.cost == c.cost
                    and g.cycle == c.cycle and g.status == c.status)
            say("instances", instance=fn, algo=algo, cuda_cost=g.cost,
                cpu_cost=c.cost, cuda_cycle=g.cycle, cpu_cycle=c.cycle,
                cpu_use_packed=bool(extra), cuda_engine=g.config["engine"],
                same_assignment=g.assignment == c.assignment, **extra)
            if not same or g.status != "FINISHED" \
                    or not math.isfinite(g.cost):
                fail("instances", f"{fn} {algo}: card status={g.status} "
                     f"cost={g.cost} cycle={g.cycle} against CPU "
                     f"status={c.status} cost={c.cost} cycle={c.cycle}")

    # 5. times -------------------------------------------------------------
    timing = {}
    sizes = {"10k_30k": primary, "100k_300k": big}
    for name, pg in sizes.items():
        ms, plain, bound, by, nbytes, device_us = time_kernel(pg)
        timing[name, "packed_maxsum_cycle"] = (ms, plain, bound, by)
        # share of a cycle's wall time (CUDA events) the kernel runs on
        # the device; the rest is launch overhead and the argmin epilogue
        say("times", kernel="packed_maxsum_cycle", size=name, N=pg.N,
            Vp=pg.Vp, kernel_ms=ms, plain_ms=plain, bound_ms=bound,
            bound_by=by, bytes_per_cycle=nbytes,
            profiler_kernel_us=device_us,
            kernel_busy_share=device_us / (ms * 1e3) if device_us else None,
            library_ms=None, nvidia_smi=smi)
        for kname, (ms, plain, bound, by, nbytes, device_us) in \
                time_ls(pack_from_pg(pg)).items():
            timing[name, kname] = (ms, plain, bound, by)
            say("times", kernel=kname, size=name, N=pg.N, Vp=pg.Vp,
                kernel_ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                bytes_per_cycle=nbytes, profiler_kernel_us=device_us,
                kernel_busy_share=(device_us / (ms * 1e3) if device_us
                                   else None),
                library_ms=None,
                library_note="no single PyTorch call computes a "
                "local-tables gather-sum or an MGM/DSA move",
                nvidia_smi=smi)
        ms, plain, bound, by, nbytes, device_us, us, offers = time_mgm2(
            pack_mgm2_from_pls(pack_from_pg(pg)))
        timing[name, "packed_mgm2_cycles"] = (ms, plain, bound, by)
        say("times", kernel="packed_mgm2_cycles", size=name, N=pg.N,
            Vp=pg.Vp, launches_per_cycle=LAUNCHES_PER_CYCLE, kernel_ms=ms,
            plain_ms=plain, bound_ms=bound, bound_by=by,
            bytes_per_cycle=nbytes, offers_per_cycle=offers,
            profiler_kernel_us=device_us, profiler_us_by_kernel=us,
            kernel_busy_share=(device_us / (ms * 1e3) if device_us
                               else None),
            library_ms=None,
            library_note="no single PyTorch call computes an MGM-2 cycle",
            nvidia_smi=smi)
    for name, (_, ps) in dpop_packed.items():
        ms, plain, bound, by, nbytes, device_us = time_dpop(ps)
        timing[name, "dpop_whole_sweep"] = (ms, plain, bound, by)
        say("times", kernel="dpop_whole_sweep", size=name,
            n_nodes=ps.n_nodes, D=ps.D, L=ps.L, launches_per_sweep=2 * ps.L,
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
            Vp=pg.Vp, kernel_ms=ms, plain_ms=plain, bound_ms=bound,
            bound_by=by, bytes_per_cycle=nbytes,
            profiler_kernel_us=device_us,
            kernel_busy_share=device_us / (ms * 1e3) if device_us else None,
            library_ms=None,
            library_note="no single PyTorch call computes a MaxSum cycle",
            nvidia_smi=smi)
        for kname, (ms, plain, bound, by, nbytes, device_us) in \
                time_ls(pack_from_pg(pg)).items():
            timing[name, kname + "_mixed"] = (ms, plain, bound, by)
            say("times", kernel=kname + "_mixed", size=name, N=pg.N,
                Vp=pg.Vp, kernel_ms=ms, plain_ms=plain, bound_ms=bound,
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
        ms, plain, bound, by, nbytes, device_us, us, offers = time_mgm2(
            pack_mgm2_from_pls(pack_from_pg(pg)))
        timing[name, "packed_mgm2_cycles_mixed"] = (ms, plain, bound, by)
        say("times", kernel="packed_mgm2_cycles_mixed", size=name, N=pg.N,
            Vp=pg.Vp, launches_per_cycle=LAUNCHES_PER_CYCLE, kernel_ms=ms,
            plain_ms=plain, bound_ms=bound, bound_by=by,
            bytes_per_cycle=nbytes, offers_per_cycle=offers,
            profiler_kernel_us=device_us, profiler_us_by_kernel=us,
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
                "rotated MaxSum cycle, routed gains or partial tables",
                nvidia_smi=smi)
        say("times", kernel="sharded_cycles", size=name, S=SHARDS,
            cycles_per_s=rates, nvidia_smi=smi)

    sharded_note = ("no single PyTorch call computes a shard's rotated "
                    "MaxSum cycle, routed gains or partial tables")
    for name, t, amaxsum in (
            ("secp_3.9k", compile_factor_graph(secp, device=dev), False),
            (big_secp, compile_factor_graph(mixed_dcops[big_secp],
                                            device=dev), False),
            ("secp_3.9k", compile_factor_graph(secp, device=dev), True),
            (big_secp, compile_factor_graph(mixed_dcops[big_secp],
                                            device=dev), True),
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
         main_launches["ls_tables"], ls_err),
        ("packed_mgm_cycles", "pydcop_tpu_torch/csrc/local_search.cu",
         "pydcop_tpu/ops/pallas_local_search.py:529",
         main_launches["mgm_move"], ls_err),
        ("packed_dsa_cycles", "pydcop_tpu_torch/csrc/local_search.cu",
         "pydcop_tpu/ops/pallas_local_search.py:644",
         main_launches["dsa_cycle"], ls_err),
        ("dpop_whole_sweep", "pydcop_tpu_torch/csrc/dpop_sweep.cu",
         "pydcop_tpu/ops/pallas_dpop.py:306",
         main_launches["dpop_whole_sweep"], dpop_err),
        ("packed_mgm2_cycles", "pydcop_tpu_torch/csrc/mgm2.cu",
         "pydcop_tpu/ops/pallas_mgm2.py:448", main_launches["mgm2"],
         mgm2_err),
        ("packed_maxsum_mixed_cycle",
         "pydcop_tpu_torch/csrc/packed_maxsum.cu",
         "pydcop_tpu/ops/pallas_maxsum.py:1505",
         main_launches["packed_maxsum_mixed"], mixed_err),
        ("packed_local_tables_mixed", "pydcop_tpu_torch/csrc/local_search.cu",
         "pydcop_tpu/ops/pallas_maxsum.py:1603",
         main_launches["ls_tables_mixed"], mixed_ls_err),
        ("packed_mgm_cycles_mixed", "pydcop_tpu_torch/csrc/local_search.cu",
         "pydcop_tpu/ops/pallas_local_search.py:529",
         main_launches["mgm_move_mixed"], mixed_ls_err),
        ("packed_dsa_cycles_mixed", "pydcop_tpu_torch/csrc/local_search.cu",
         "pydcop_tpu/ops/pallas_local_search.py:644",
         main_launches["dsa_cycle_mixed"], mixed_ls_err),
        ("packed_mgm2_cycles_mixed", "pydcop_tpu_torch/csrc/mgm2.cu",
         "pydcop_tpu/ops/pallas_mgm2.py:448", main_launches["mgm2_mixed"],
         mixed_mgm2_err),
        ("packed_shard_fused_ba", "pydcop_tpu_torch/csrc/sharded.cu",
         "pydcop_tpu/ops/pallas_sharded.py:180",
         main_launches["shard_fused_ba"], sharded_err["shard_fused_ba"]),
        ("packed_shard_route_gains", "pydcop_tpu_torch/csrc/sharded.cu",
         "pydcop_tpu/ops/pallas_sharded.py:258",
         main_launches["shard_route_gains_mgm"],
         sharded_err["shard_route_gains"]),
        ("packed_shard_tables", "pydcop_tpu_torch/csrc/sharded.cu",
         "pydcop_tpu/ops/pallas_sharded.py:319",
         main_launches["shard_tables_mgm"], sharded_err["shard_tables"]),
        ("packed_shard_fused_ba_act", "pydcop_tpu_torch/csrc/sharded.cu",
         "pydcop_tpu/ops/pallas_sharded.py:180",
         main_launches["shard_fused_ba_act"],
         sharded_err["shard_fused_ba_act"]),
        ("packed_shard_fused_ba_mixed", "pydcop_tpu_torch/csrc/sharded.cu",
         "pydcop_tpu/ops/pallas_sharded.py:180",
         main_launches["shard_fused_ba_mixed"],
         sharded_mixed_err["shard_fused_ba_mixed"]),
        ("packed_shard_fused_ba_mixed_act",
         "pydcop_tpu_torch/csrc/sharded.cu",
         "pydcop_tpu/ops/pallas_sharded.py:180",
         main_launches["shard_fused_ba_mixed_act"],
         sharded_mixed_err["shard_fused_ba_mixed_act"]),
        ("packed_shard_route_gains_mixed", "pydcop_tpu_torch/csrc/sharded.cu",
         "pydcop_tpu/ops/pallas_sharded.py:258",
         main_launches["shard_route_gains_mixed_mgm"],
         sharded_mixed_err["shard_route_gains_mixed"]),
        ("packed_shard_tables_mixed", "pydcop_tpu_torch/csrc/sharded.cu",
         "pydcop_tpu/ops/pallas_sharded.py:319",
         main_launches["shard_tables_mixed_mgm"],
         sharded_mixed_err["shard_tables_mixed"]),
        # K3 has no caller on any path of the port (nor of the JAX
        # package): no main-path launch to count
        ("lane_permute", "pydcop_tpu_torch/csrc/permute.cu",
         "pydcop_tpu/ops/pallas_permute.py:88", 0,
         max(err for err, _ in permute_rows.values())),
    ]
    sizes_of = {"dpop_whole_sweep": "bench_tree_10k",
                "packed_shard_fused_ba_act": "10k_30k",
                "lane_permute": "N30000"}
    kernels = []
    for name, source, replaces, launches, err in entries:
        row = timing[
            sizes_of.get(name, "secp_3.9k" if "mixed" in name
                         else "10k_30k"),
            name]
        ms, plain, bound, by = row[:4]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by,
            "library_ms": row[4] if len(row) > 4 else None,
        })
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
