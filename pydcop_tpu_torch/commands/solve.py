"""`pydcop_tpu_torch solve` — single-device solve of a static DCOP.

Equivalent capability to the reference's pydcop/commands/solve.py
(run_cmd): load YAML → build graph → run → print the metrics JSON, the
same JSON as the JAX package's ``solve``.  The options ported so far are
``-a``, ``-p``, ``--cycles``, ``--seed``, ``--device``, the dpop
shorthands ``--dpop-budget-mb``, ``--i-bound`` and ``--dpop-no-prune``,
and ``-d``: a distribution YAML file drives a sharded maxsum or amaxsum
solve (one shard per visible device), with ``--shard-overlap`` and
``--shard-boundary-threshold``, and a strategy name (``oneagent``,
``adhoc``) is computed and validated (plus the global ``--timeout`` and
``--output``), the exact-search options ``--anytime-exact`` and
``--frontier-width``, ``--headroom`` (the warm-repair engine,
``metrics()["repair"]``), the metrics options ``-c/--collect_on``,
``--run_metrics`` and ``--end_metrics`` (the JAX package's CSV files: one
``RUNNING`` line a cycle of the history, then the end line), with
``-m/--mode``, ``--period`` and ``--delay`` accepted for compatibility,
``--batch`` with ``--max-padding-waste`` (each file a separate instance,
solved through the batched engine, :mod:`pydcop_tpu_torch.batch`), the
resilience options ``--checkpoint``, ``--checkpoint-every``, ``--resume``
and ``--fault-plan`` (its checkpoint kinds), and ``--uiport`` (the UI
server, ``runtime/ui.py``).  ``--elastic``, ``--elastic-chunk``,
``--scrub-every``, ``--elastic-min-devices``, a fault plan's device kinds
and ``--compile-cache-dir`` raise
:class:`~pydcop_tpu_torch.errors.NotPortedError`.
"""
from __future__ import annotations

from pydcop_tpu_torch.commands._utils import (
    add_csvline,
    output_metrics,
    parse_algo_params,
    warn_process_mode,
)
from pydcop_tpu_torch.errors import NotPortedError


def set_parser(subparsers):
    parser = subparsers.add_parser("solve", help="solve a static DCOP")
    parser.set_defaults(func=run_cmd)
    parser.add_argument("dcop_files", nargs="+", help="DCOP YAML file(s)")
    parser.add_argument(
        "--batch", action="store_true",
        help="treat each DCOP file as a SEPARATE instance and solve them "
        "all through the batched engine (shape-bucketed, one runner per "
        "bucket) instead of merging the files into one problem; prints "
        "one metrics object per file")
    parser.add_argument(
        "--max-padding-waste", type=float, default=0.25,
        help="with --batch: bucketing waste bound (the largest share of "
        "a bucket's padded array cells that may hold no real data)")
    parser.add_argument(
        "--compile-cache-dir", default=None,
        help="with --batch: a persistent compile cache directory; not "
        "ported (bucket runners are CUDA graphs held in their process)")
    parser.add_argument("-a", "--algo", default=None,
                        help="algorithm name (required unless "
                        "--anytime-exact, which defaults to syncbb)")
    parser.add_argument(
        "-p", "--algo_params", action="append",
        help="algorithm parameter as name:value, repeatable",
    )
    parser.add_argument("-m", "--mode", choices=["thread", "process"],
                        default="thread", help="accepted for compatibility")
    parser.add_argument("-c", "--collect_on",
                        choices=["value_change", "cycle_change", "period"],
                        default="value_change",
                        help="cycle_change collects each cycle's cost "
                        "(as --run_metrics does)")
    parser.add_argument("--period", type=float, default=None,
                        help="accepted for compatibility")
    parser.add_argument("--run_metrics", default=None,
                        help="CSV file for run metrics: one RUNNING line a "
                        "cycle (a chunk for the exact search)")
    parser.add_argument("--end_metrics", default=None,
                        help="CSV file for end metrics")
    parser.add_argument("--delay", type=float, default=None,
                        help="accepted for compatibility")
    parser.add_argument("--uiport", type=int, default=None,
                        help="serve the GUI websocket protocol + HTTP "
                        "/state on this port (ws on port+1)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cycles", type=int, default=None,
                        help="run exactly this many cycles")
    parser.add_argument("--device", choices=["cuda", "cpu"],
                        default="cuda",
                        help="device to solve on (default cuda; a missing "
                        "GPU is an error, never a silent CPU run)")
    parser.add_argument(
        "-d", "--distribution", default=None,
        help="a distribution YAML file, which drives the solve: factors "
        "are sharded by host agent onto one shard per visible device "
        "(maxsum and amaxsum; other algorithms reject an explicit "
        "placement), or a strategy name (oneagent, adhoc), which is "
        "computed and validated")
    parser.add_argument("--shard-overlap",
                        choices=["off", "exact", "stale"], default=None,
                        help="sharded-engine collective path: off = dense "
                        "whole-space sum; exact = boundary-compacted, bit "
                        "for bit the dense run; stale = the boundary one "
                        "cycle behind; default: exact when the cut "
                        "fraction is at most the threshold, else dense")
    parser.add_argument("--shard-boundary-threshold", type=float,
                        default=0.5,
                        help="auto-policy cut-fraction threshold, recorded "
                        "in metrics['config'] (default 0.5)")
    # DPOP only; shorthands for the matching -p algo params
    parser.add_argument("--dpop-budget-mb", type=float, default=None,
                        help="per-device byte budget for DPOP util "
                        "tables (-p budget_mb)")
    parser.add_argument("--i-bound", type=int, default=None,
                        help="mini-bucket width bound for DPOP and the "
                        "exact-search family (-p i_bound); "
                        "metrics['dpop'] reports the lower/upper bound "
                        "sandwich of engine:minibucket, and the frontier "
                        "engine sizes its bound tables with it")
    parser.add_argument("--dpop-no-prune", action="store_true",
                        help="disable the wire pruning of the sharded "
                        "DPOP sweep (-p prune:false); the sharded sweep "
                        "is not ported, so this is refused")
    # anytime exact search: the frontier-batched branch-and-bound engine
    parser.add_argument("--anytime-exact", action="store_true",
                        help="run the frontier-batched anytime "
                        "branch-and-bound engine (a [B, depth] slab of "
                        "partial assignments expanded on the device with "
                        "mini-bucket lower bounds, incumbent + bound "
                        "read as 2 scalars per chunk) to its optimality "
                        "proof; metrics land in metrics['search'].  "
                        "Default algorithm syncbb; also valid with -a "
                        "ncbb or -a dpop; --i-bound/--dpop-budget-mb "
                        "size the bound tables")
    parser.add_argument("--frontier-width", type=int, default=0,
                        help="with --anytime-exact (or engine:frontier): "
                        "frontier slab rows B (0 = auto)")
    # warm repair
    parser.add_argument("--headroom", type=float, default=None,
                        help="build the WARM-repair engine with this "
                        "reserved headroom fraction (e.g. 0.25): live "
                        "mutations become fixed-shape writes in place "
                        "with no re-capture; repair counters land in "
                        "metrics['repair'] (maxsum/mgm/dsa/adsa)")
    # crash resilience
    parser.add_argument("--fault-plan", default=None,
                        help="seeded FaultPlan YAML: its checkpoint kinds "
                        "damage --checkpoint's newest snapshot before "
                        "--resume reads it; the device kinds "
                        "(kill_device/shrink_mesh/corrupt_slab) need the "
                        "elastic driver, which is not ported")
    # the elastic device-fault tier (the JAX package's parallel/elastic.py)
    parser.add_argument("--elastic", action="store_true",
                        help="the elastic sharded driver: not ported")
    parser.add_argument("--elastic-chunk", type=int, default=8,
                        help="cycles per elastic chunk boundary (with "
                        "the elastic driver, not ported)")
    parser.add_argument("--scrub-every", type=int, default=0,
                        help="shadow-recompute scrub every K chunks "
                        "(with the elastic driver, not ported)")
    parser.add_argument("--elastic-min-devices", type=int, default=2,
                        help="shrink floor of the elastic driver (not "
                        "ported)")
    parser.add_argument("--checkpoint", default=None,
                        help="rotating snapshot directory: solver state "
                        "is persisted every --checkpoint-every cycles "
                        "(atomic + checksummed)")
    parser.add_argument("--checkpoint-every", type=int, default=10)
    parser.add_argument("--resume", action="store_true",
                        help="warm-start from the newest valid snapshot "
                        "in --checkpoint (corrupt files are skipped)")
    return parser


#: the elastic driver's flags and their defaults: any other value asks
#: for the driver, which is not ported
ELASTIC_DEFAULTS = {"elastic": False, "elastic_chunk": 8, "scrub_every": 0,
                    "elastic_min_devices": 2}


def run_cmd(args):
    from pydcop_tpu_torch.dcop import load_dcop_from_file
    from pydcop_tpu_torch.runtime import solve_result

    def refuse(error):
        output_metrics({"status": "ERROR", "error": error}, args.output)
        return 1

    elastic = [f"--{k.replace('_', '-')}"
               for k, v in ELASTIC_DEFAULTS.items() if getattr(args, k) != v]
    if elastic:
        raise NotPortedError(
            f"{', '.join(elastic)}: the elastic sharded driver "
            f"(parallel/elastic.py) is not ported to the PyTorch package "
            f"yet")

    if args.batch:
        return _run_batch(args)
    search_family = ("syncbb", "ncbb")
    if args.anytime_exact:
        if args.algo is None:
            args.algo = "syncbb"
        if args.algo not in ("syncbb", "ncbb", "dpop"):
            return refuse(
                f"--anytime-exact runs the exact-search family "
                f"(syncbb/ncbb/dpop), not {args.algo!r}")
    elif args.frontier_width and args.algo not in search_family:
        return refuse("--frontier-width only applies with "
                      "--anytime-exact or the syncbb/ncbb frontier engine")
    if args.algo is None:
        return refuse("one of -a/--algo or --anytime-exact is required")
    if (not args.anytime_exact and args.algo != "dpop"
            and args.algo not in search_family
            and (args.dpop_budget_mb is not None
                 or args.i_bound is not None or args.dpop_no_prune)):
        return refuse("--dpop-budget-mb/--i-bound/--dpop-no-prune only "
                      "apply to -a dpop (or the exact-search family)")
    try:
        algo_params = parse_algo_params(args.algo_params)
        if args.anytime_exact:
            # flag shorthands for the frontier engine params
            algo_params["engine"] = "frontier"
            if args.frontier_width and args.algo in search_family:
                algo_params.setdefault("frontier_width",
                                       args.frontier_width)
            if args.i_bound is not None:
                algo_params.setdefault("i_bound", args.i_bound)
            if args.dpop_budget_mb is not None:
                algo_params.setdefault("budget_mb", args.dpop_budget_mb)
        if args.algo in search_family:
            # the same shorthands work for the search family directly
            if args.frontier_width:
                algo_params.setdefault("frontier_width",
                                       args.frontier_width)
            if args.i_bound is not None:
                algo_params.setdefault("i_bound", args.i_bound)
            if args.dpop_budget_mb is not None:
                algo_params.setdefault("budget_mb", args.dpop_budget_mb)
        if args.algo == "dpop":
            if args.dpop_budget_mb is not None:
                algo_params.setdefault("budget_mb", args.dpop_budget_mb)
            if args.i_bound is not None:
                algo_params.setdefault("i_bound", args.i_bound)
            if args.dpop_no_prune:
                algo_params["prune"] = False
        dcop = load_dcop_from_file(args.dcop_files)
        # no silent no-op: thread and process modes run the same engine
        warn_process_mode(args.mode)
        distribution = args.distribution
        if distribution is not None \
                and distribution.endswith((".yaml", ".yml")):
            from pydcop_tpu_torch.distribution import load_dist_from_file

            try:
                distribution = load_dist_from_file(distribution)
            except Exception as e:
                raise ValueError(f"cannot load distribution: {e}") from e
        fault_plan = None
        if args.fault_plan:
            from pydcop_tpu_torch.runtime.faults import FaultPlan

            try:
                fault_plan = FaultPlan.from_yaml(args.fault_plan)
            except Exception as e:
                raise ValueError(f"cannot load fault plan: {e}") from e
    except Exception as e:
        output_metrics({"status": "ERROR", "error": str(e)}, args.output)
        return 1
    from pydcop_tpu_torch.runtime.ui import serving

    with serving(args.uiport) as ui:
        try:
            res = solve_result(
                dcop,
                args.algo,
                distribution=distribution,
                timeout=args.timeout,
                cycles=args.cycles,
                algo_params=algo_params,
                seed=args.seed,
                device=args.device,
                shard_overlap=args.shard_overlap,
                shard_boundary_threshold=args.shard_boundary_threshold,
                collect_cycles=args.run_metrics is not None
                or args.collect_on == "cycle_change",
                headroom=args.headroom,
                checkpoint_dir=args.checkpoint,
                checkpoint_every=args.checkpoint_every,
                resume=args.resume,
                fault_plan=fault_plan,
            )
        except Exception as e:
            output_metrics({"status": "ERROR", "error": str(e)},
                           args.output)
            return 1
        if ui is not None:
            ui.update_state(**res.metrics())
    metrics = res.metrics()
    if args.run_metrics and res.history:
        for h in res.history:
            add_csvline(args.run_metrics, args.collect_on,
                        {**metrics, **h, "status": "RUNNING"})
    if args.end_metrics:
        add_csvline(args.end_metrics, args.collect_on, metrics)
    output_metrics(metrics, args.output)
    return 0 if res.status in ("FINISHED", "TIMEOUT") else 1


def _run_batch(args):
    """``solve --batch f1.yaml f2.yaml ...`` — each file one instance,
    solved through the batched engine on ``--device``.  Prints a JSON
    object with per-file metrics plus the engine's bucket, cache and
    runner summary (the JAX package's ``_run_batch``)."""
    from pydcop_tpu_torch.batch import BatchEngine, BatchItem
    from pydcop_tpu_torch.batch.cache import refuse_persistent_cache
    from pydcop_tpu_torch.dcop import load_dcop_from_file

    refuse_persistent_cache(args.compile_cache_dir)
    if args.algo is None:
        output_metrics({"status": "ERROR",
                        "error": "--batch needs -a/--algo"}, args.output)
        return 1
    if args.distribution:
        output_metrics(
            {"status": "ERROR",
             "error": "--batch does not combine with --distribution or "
             "checkpointing; solve the instances separately"},
            args.output,
        )
        return 1
    # options the batched engine has no use for: refused, not ignored
    unused = {
        "--anytime-exact": args.anytime_exact,
        "--frontier-width": bool(args.frontier_width),
        "--run_metrics/--end_metrics/-c cycle_change": (
            args.run_metrics is not None or args.end_metrics is not None
            or args.collect_on == "cycle_change"),
        "--shard-overlap": args.shard_overlap is not None,
        "--dpop-budget-mb/--i-bound/--dpop-no-prune": (
            args.dpop_budget_mb is not None or args.i_bound is not None
            or args.dpop_no_prune),
        "--headroom": args.headroom is not None,
        "--checkpoint/--resume/--fault-plan": bool(
            args.checkpoint or args.resume or args.fault_plan),
        "--uiport": args.uiport is not None,
    }
    given = [name for name, on in unused.items() if on]
    if given:
        output_metrics(
            {"status": "ERROR",
             "error": f"--batch does not combine with {', '.join(given)}; "
             f"solve the instances separately"},
            args.output,
        )
        return 1
    algo_params = parse_algo_params(args.algo_params)
    warn_process_mode(args.mode)

    items, errors = [], {}
    for fn in args.dcop_files:
        try:
            items.append(BatchItem(
                load_dcop_from_file([fn]), args.algo,
                algo_params=algo_params, seed=args.seed, label=fn,
            ))
        except Exception as e:
            errors[fn] = {"status": "ERROR", "error": str(e)}

    try:
        engine = BatchEngine(max_padding_waste=args.max_padding_waste,
                             device=args.device)
        results = engine.solve(
            items, cycles=args.cycles, timeout=args.timeout
        )
    except Exception as e:
        output_metrics({"status": "ERROR", "error": str(e)}, args.output)
        return 1

    per_file = dict(errors)
    for item, res in zip(items, results):
        per_file[item.label] = res.metrics()
    ok = not errors and all(
        r.status in ("FINISHED", "TIMEOUT") for r in results
    )
    output_metrics(
        {
            "status": "FINISHED" if ok else "ERROR",
            "results": per_file,
            "batch": engine.metrics(),
        },
        args.output,
    )
    return 0 if ok else 1
