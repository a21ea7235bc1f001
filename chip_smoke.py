#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pydcop_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments, on a machine with one
NVIDIA H100 and the CUDA toolkit::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``pydcop_tpu_torch/csrc`` (one
``nvcc`` per source, started together), then drives the port's main
path: ``solve -a maxsum`` on one device.  Each phase prints one line; any
failure exits non-zero before the result lines are printed.

1. device: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, kernel build time and the ptxas report;
2. kernel against its plain PyTorch version, both on the card, for 20
   cycles at damping 0.5 and 0, on the bench's 10k-variable / 30k-edge
   3-colour coloring, a star with one variable of degree 2,500, and an
   instance with unequal domain sizes (tolerance atol 1e-4·(1+|x|) on
   q, r and beliefs; values exact except columns whose two best beliefs
   lie within 1e-4, which are counted);
3. CLI: ``python -m pydcop_tpu_torch solve -a maxsum`` on the tutorial
   instance in a subprocess must finish with cost 12;
4. main path at full width: ``solve_result`` on a 10,000-variable /
   30,000-constraint soft coloring built with the port's DCOP objects,
   200 cycles; the kernel's launch counter is zeroed just before and
   must equal the cycle count just after;
   then the same path piece by piece (factor graph, compile, pack,
   cycles, scoring),
   and every test instance solved on the card and on the CPU;
5. times: the kernel's ms per cycle (CUDA events around a run of launches,
   after warm-up) at 10k/30k and 100k/300k beside its bytes bound, the
   plain version's, and the kernel's device time per launch from a
   torch.profiler trace (and its share of the cycle's wall time).

The second-to-last line is ``{"kernels": [...]}`` (one entry per kernel:
launches on the main path, max error against the plain version, times and
bound), the last ``{"ok": true, "device": {...}}``.
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


def profile_kernel(pg, cycles=50):
    """Device time of one launch of the kernel, from torch.profiler's CUDA
    trace of ``cycles`` back-to-back launches (None when the trace holds
    no device time for it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pydcop_tpu_torch.ops.packed_maxsum import packed_cycles, \
        packed_init_state

    q, r = packed_init_state(pg)
    packed_cycles(pg, q, r, 5, damping=0.5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        packed_cycles(pg, q, r, cycles, damping=0.5)
        torch.cuda.synchronize()
    total_us, n = 0.0, 0
    for e in prof.key_averages():
        if "packed_maxsum_cycle_kernel" in e.key:
            total_us += getattr(e, "device_time_total",
                                getattr(e, "cuda_time_total", 0.0))
            n += e.count
    return total_us / n if n and total_us else None


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
    nbytes, nops = packed_bytes(pg), packed_ops(pg)
    bound = max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= nops / FP32_OPS_PER_S \
        else "operations"
    return ms, plain, bound, by, nbytes


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
    from pydcop_tpu_torch.ops.packed_maxsum import pack_for_gpu, \
        packed_cycles
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

    # 2. kernel against plain, on the card ---------------------------------
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

    # 3. CLI path ----------------------------------------------------------
    tuto = os.path.join(ROOT, "tests", "instances", "graph_coloring_tuto.yaml")
    proc = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "solve", "-a", "maxsum",
         tuto], capture_output=True, text=True, timeout=300, cwd=ROOT)
    try:
        out = json.loads(proc.stdout)
    except ValueError:
        fail("cli", f"rc={proc.returncode} no JSON; stderr: "
             f"{proc.stderr[-2000:]}")
    if proc.returncode != 0 or out.get("status") != "FINISHED" \
            or out.get("cost") != 12:
        fail("cli", f"rc={proc.returncode} status={out.get('status')} "
             f"cost={out.get('cost')} error={out.get('error')}")
    say("cli", status=out["status"], cost=out["cost"], cycle=out["cycle"],
        assignment=out["assignment"])

    # 4. main path at full width -------------------------------------------
    t0 = time.perf_counter()
    dcop = coloring_dcop(10_000, 30_000)
    build_dcop_s = time.perf_counter() - t0
    cycles = 200
    packed_cycles.launches = 0
    t0 = time.perf_counter()
    res = solve_result(dcop, "maxsum", cycles=cycles, device="cuda")
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = packed_cycles.launches
    keys = set(res.metrics())
    jax_keys = {"status", "assignment", "cost", "violation", "cycle",
                "msg_count", "msg_size", "time", "harness", "config"}
    if launches != cycles:
        fail("main_path", f"kernel launched {launches} times in a "
             f"{cycles}-cycle solve")
    if keys != jax_keys:
        fail("main_path", f"metrics keys {sorted(keys)} != the JAX "
             f"package's {sorted(jax_keys)}")
    if res.status != "FINISHED" or res.cycle != cycles \
            or not math.isfinite(res.cost) \
            or len(res.assignment) != 10_000:
        fail("main_path", f"status={res.status} cycle={res.cycle} "
             f"cost={res.cost} n_assigned={len(res.assignment)}")
    say("main_path", launches=launches, cycle=res.cycle, status=res.status,
        cost=res.cost, violation=res.violation,
        build_dcop_s=round(build_dcop_s, 3), solve_s=round(solve_s, 3),
        harness=res.metrics()["harness"])

    # 4b. where the main path's time goes (not part of the launch count)
    from pydcop_tpu_torch.algorithms.maxsum import MaxSumSolver, algo_params
    from pydcop_tpu_torch.algorithms import AlgorithmDef
    from pydcop_tpu_torch.ops.compile import compile_factor_graph

    from pydcop_tpu_torch.graph import load_graph_module

    t0 = time.perf_counter()
    load_graph_module("factor_graph").build_computation_graph(dcop)
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tensors = compile_factor_graph(dcop, device=dev)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = MaxSumSolver(dcop, tensors, AlgorithmDef.build_with_default_params(
        "maxsum", parameters_definitions=algo_params))
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    state = solver.initial_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = solver.run_cycles(state, cycles)
    torch.cuda.synchronize()
    cycles_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    assignment = tensors.assignment_from_indices(
        solver.values_of(state).cpu().numpy())
    dcop.solution_cost(assignment, solver.infinity)
    score_s = time.perf_counter() - t0
    say("main_path_breakdown", graph_s=graph_s, compile_s=compile_s,
        pack_s=pack_s,
        cycles_s=cycles_s, cycles=cycles, cycles_per_s=cycles / cycles_s,
        solution_cost_s=score_s, nvidia_smi=smi)

    # 4c. the generic engine (mixed arity) and the packed one on the card
    # against the CPU, on every test instance, without noise
    inst = os.path.join(ROOT, "tests", "instances")
    from pydcop_tpu_torch.dcop import load_dcop_from_file

    for fn in sorted(os.listdir(inst)):
        d = load_dcop_from_file([os.path.join(inst, fn)])
        g = solve_result(d, "maxsum", algo_params={"noise": 0},
                         device="cuda")
        c = solve_result(d, "maxsum", algo_params={"noise": 0},
                         device="cpu")
        if g.status != "FINISHED" or not math.isfinite(g.cost):
            fail("instances", f"{fn}: status={g.status} cost={g.cost}")
        say("instances", instance=fn, cuda_cost=g.cost, cpu_cost=c.cost,
            cuda_cycle=g.cycle, cpu_cycle=c.cycle,
            same_assignment=g.assignment == c.assignment)

    # 5. times -------------------------------------------------------------
    timing = {}
    big_arrays = coloring_arrays(100_000, 300_000)
    sizes = {
        "10k_30k": primary,
        "100k_300k": pack_for_gpu(compile_binary_from_arrays(
            *big_arrays[:3], 100_000, unary=big_arrays[3], device=dev)),
    }
    for name, pg in sizes.items():
        ms, plain, bound, by, nbytes = time_kernel(pg)
        timing[name] = (ms, plain, bound, by)
        device_us = profile_kernel(pg)
        # share of a cycle's wall time (CUDA events) the kernel runs on
        # the device; the rest is launch overhead and the argmin epilogue
        busy = device_us / (ms * 1e3) if device_us else None
        say("times", size=name, N=pg.N, Vp=pg.Vp, kernel_ms=ms,
            plain_ms=plain, bound_ms=bound, bound_by=by,
            bytes_per_cycle=nbytes, profiler_kernel_us=device_us,
            kernel_busy_share=busy, nvidia_smi=smi)

    ms, plain, bound, by = timing["10k_30k"]
    print(json.dumps({"kernels": [{
        "name": "packed_maxsum_cycle",
        "route": "cuda",
        "source": "pydcop_tpu_torch/csrc/packed_maxsum.cu",
        "replaces": "pydcop_tpu/ops/pallas_maxsum.py:1505",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
