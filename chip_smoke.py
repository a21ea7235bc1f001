#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pydcop_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments, on a machine with one
NVIDIA H100 and the CUDA toolkit::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``pydcop_tpu_torch/csrc`` (one
``nvcc`` per source, started together), then drives the port's main
paths on one device: ``solve -a maxsum`` and ``solve -a mgm|dsa``.  Each
phase prints one line; any failure exits non-zero before the result
lines are printed.

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
3. cli / cli_local_search: ``python -m pydcop_tpu_torch solve`` in a
   subprocess on the tutorial instance: maxsum must finish with cost
   12, mgm and dsa with the cost of the port's own CPU run;
4. main_path: ``solve_result`` on a 10,000-variable / 30,000-constraint
   soft coloring built with the port's DCOP objects, 200 cycles, for
   maxsum, mgm and dsa; every launch counter is zeroed just before each
   solve, and just after it the kernels of that path must have launched
   once per cycle (mgm: 200 ls_tables + 200 mgm_move; dsa: 200
   dsa_cycle); then each path piece by piece (graph, compile, pack,
   cycles, coin copy, scoring);
   instances: every test instance solved on the card and on the CPU by
   every algorithm of the port: assignment, cost and stop cycle must be
   equal;
5. times: each kernel's ms per cycle (CUDA events around a run of
   launches, after warm-up) at 10k/30k and 100k/300k beside its bytes
   bound, its plain version's time, and its device time per launch from
   a torch.profiler trace.

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
    """Bytes one cycle must move: every input read once (q, r, the D*D
    cost rows, vmask, unary, inv_dcount, mate, the three column arrays),
    every output written once (q', r', beliefs)."""
    D, N, Vp = pg.D, pg.N, pg.Vp
    floats = (D * N * 2 + D * D * N + D * N + D * Vp + N  # inputs
              + D * N * 2 + D * Vp)                         # outputs
    ints = N + 3 * Vp
    return 4 * (floats + ints)


def packed_ops(pg):
    """Float operations of one cycle: per slot and value, D adds and D-1
    mins, the mask, damping (3) and the belief add; per slot, the q
    side (D subtractions, D multiply-adds for the mean, 2D to centre)."""
    D, N = pg.D, pg.N
    return N * D * (2 * D - 1 + 1 + 3 + 1) + N * (D + 2 * D + 1 + 2 * D)


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
    device_us = profile_us(
        lambda: packed_cycles(pg, q, r, 50, damping=0.5),
        ["packed_maxsum_cycle_kernel"])["packed_maxsum_cycle_kernel"]
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
      out x'."""
    D, N, Vp = pls.D, pls.N, pls.Vp
    common = D * N + 2 * D * Vp + Vp + N + 3 * Vp
    ops = N * D + Vp * 4 * D
    return {
        "packed_local_tables": (4 * (common + D * Vp + 3 * Vp), ops),
        "packed_mgm_cycles": (4 * (common + N + Vp + Vp),
                              ops + 2 * N + 6 * Vp),
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


def reset_counts():
    """Zero the launch counter of every kernel wrapper."""
    from pydcop_tpu_torch.ops import packed_local_search as P
    from pydcop_tpu_torch.ops.packed_maxsum import packed_cycles

    packed_cycles.launches = 0
    P.reset_launches()


def read_counts():
    from pydcop_tpu_torch.ops import packed_local_search as P
    from pydcop_tpu_torch.ops.packed_maxsum import packed_cycles

    return {"packed_maxsum_cycle": packed_cycles.launches,
            "ls_tables": P.ls_tables.launches,
            "mgm_move": P.mgm_move.launches,
            "dsa_cycle": P.dsa_cycle.launches}


def breakdown(dcop, algo, cycles, dev):
    """Where a solve's time goes, piece by piece (host clock around work
    that ends in a synchronize): the computation graph, compile, pack,
    the cycles, the coin copy (DSA: per chunk of 100 cycles, the fixed-
    cycle chunk) and scoring."""
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
                  "dsa": "DsaSolver"}[algo]
    solver, pack_s = timed(lambda: getattr(mod, solver_cls)(
        dcop, tensors, AlgorithmDef.build_with_default_params(algo)))
    state = solver.initial_state()
    out = dict(graph_s=graph_s, compile_s=compile_s, pack_s=pack_s)
    if algo == "dsa":
        # the coins of the two 100-cycle chunks: drawn on the CPU alone,
        # then as the solve pays for them (draw, copy, column permute)
        _, draw_s = timed(lambda: [solver.draw_uniforms(cycles // 2)
                                   for _ in range(2)])
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
    if algo == "dsa":
        out["cycles_per_s_with_coins"] = cycles / (cycles_s + coin_s)
    out.update(cycles_s=cycles_s, cycles=cycles,
               cycles_per_s=cycles / cycles_s,
               solution_cost_s=time.perf_counter() - t0)
    return out


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
    primary = pack_for_gpu(
        compile_binary_from_arrays(ei, ej, mats, 10_000, unary=un,
                                   device=dev))
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

    # 3. CLI paths ---------------------------------------------------------
    from pydcop_tpu_torch.dcop import load_dcop_from_file

    tuto = os.path.join(ROOT, "tests", "instances", "graph_coloring_tuto.yaml")
    for algo in ("maxsum", "mgm", "dsa"):
        phase = "cli" if algo == "maxsum" else "cli_local_search"
        proc = subprocess.run(
            [sys.executable, "-m", "pydcop_tpu_torch", "solve", "-a", algo,
             tuto], capture_output=True, text=True, timeout=300, cwd=ROOT)
        try:
            out = json.loads(proc.stdout)
        except ValueError:
            fail(phase, f"{algo}: rc={proc.returncode} no JSON; stderr: "
                 f"{proc.stderr[-2000:]}")
        want = 12 if algo == "maxsum" else solve_result(
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
            ("dsa", {"dsa_cycle": cycles})):
        phase = "main_path" if algo == "maxsum" else "main_path_local_search"
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
        say(phase, algo=algo, launches=counts, cycle=res.cycle,
            status=res.status, cost=res.cost, violation=res.violation,
            msg_count=res.msg_count, build_dcop_s=round(build_dcop_s, 3),
            solve_s=round(solve_s, 3), harness=res.metrics()["harness"])
        say(phase + "_breakdown", algo=algo, nvidia_smi=smi,
            **breakdown(dcop, algo, cycles, dev))

    # every test instance, by every algorithm of the port, on the card
    # and on the CPU: the same run (maxsum without noise, as the parity
    # tests run it; the local-search coins come from CPU generators)
    inst = os.path.join(ROOT, "tests", "instances")
    for fn in sorted(os.listdir(inst)):
        d = load_dcop_from_file([os.path.join(inst, fn)])
        for algo in ("maxsum", "mgm", "dsa", "dsatuto", "mixeddsa", "adsa"):
            params = {"noise": 0} if algo == "maxsum" else None
            g = solve_result(d, algo, algo_params=params, device="cuda")
            c = solve_result(d, algo, algo_params=params, device="cpu")
            same = (g.assignment == c.assignment and g.cost == c.cost
                    and g.cycle == c.cycle and g.status == c.status)
            say("instances", instance=fn, algo=algo, cuda_cost=g.cost,
                cpu_cost=c.cost, cuda_cycle=g.cycle, cpu_cycle=c.cycle,
                same_assignment=g.assignment == c.assignment)
            if not same or g.status != "FINISHED" \
                    or not math.isfinite(g.cost):
                fail("instances", f"{fn} {algo}: card status={g.status} "
                     f"cost={g.cost} cycle={g.cycle} against CPU "
                     f"status={c.status} cost={c.cost} cycle={c.cycle}")

    # 5. times -------------------------------------------------------------
    timing = {}
    big_arrays = coloring_arrays(100_000, 300_000)
    sizes = {
        "10k_30k": primary,
        "100k_300k": pack_for_gpu(compile_binary_from_arrays(
            *big_arrays[:3], 100_000, unary=big_arrays[3], device=dev)),
    }
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
    ]
    kernels = []
    for name, source, replaces, launches, err in entries:
        ms, plain, bound, by = timing["10k_30k", name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
        })
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
