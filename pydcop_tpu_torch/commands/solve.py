"""`pydcop_tpu_torch solve` — single-device solve of a static DCOP.

Equivalent capability to the reference's pydcop/commands/solve.py
(run_cmd): load YAML → build graph → run → print the metrics JSON, the
same JSON as the JAX package's ``solve``.  The options ported so far are
``-a``, ``-p``, ``--cycles``, ``--seed``, ``--device``, the dpop
shorthands ``--dpop-budget-mb``, ``--i-bound`` and ``--dpop-no-prune``,
and ``-d`` with a distribution YAML file, which drives a sharded maxsum
or amaxsum solve (one shard per visible device), with
``--shard-overlap`` and ``--shard-boundary-threshold`` (plus the global
``--timeout`` and ``--output``).  ``-d`` with a strategy name is not
ported and fails.
"""
from __future__ import annotations

from pydcop_tpu_torch.commands._utils import output_metrics, \
    parse_algo_params


def set_parser(subparsers):
    parser = subparsers.add_parser("solve", help="solve a static DCOP")
    parser.set_defaults(func=run_cmd)
    parser.add_argument("dcop_files", nargs="+", help="DCOP YAML file(s)")
    parser.add_argument("-a", "--algo", required=True,
                        help="algorithm name")
    parser.add_argument(
        "-p", "--algo_params", action="append",
        help="algorithm parameter as name:value, repeatable",
    )
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
        "placement). "
        "Distribution strategy names are not ported")
    parser.add_argument("--shard-overlap",
                        choices=["off", "exact", "stale"], default=None,
                        help="sharded-engine collective path: off = dense "
                        "whole-space sum (the default path here); exact "
                        "and stale (boundary-compacted) are not ported")
    parser.add_argument("--shard-boundary-threshold", type=float,
                        default=0.5,
                        help="auto-policy cut-fraction threshold, recorded "
                        "in metrics['config'] (default 0.5)")
    # DPOP only; shorthands for the matching -p algo params
    parser.add_argument("--dpop-budget-mb", type=float, default=None,
                        help="per-device byte budget for DPOP util "
                        "tables (-p budget_mb)")
    parser.add_argument("--i-bound", type=int, default=None,
                        help="mini-bucket width bound for DPOP "
                        "(-p i_bound); metrics['dpop'] reports the "
                        "lower/upper bound sandwich of engine:minibucket")
    parser.add_argument("--dpop-no-prune", action="store_true",
                        help="disable the wire pruning of the sharded "
                        "DPOP sweep (-p prune:false); the sharded sweep "
                        "is not ported, so this is refused")
    return parser


def run_cmd(args):
    from pydcop_tpu_torch.dcop import load_dcop_from_file
    from pydcop_tpu_torch.runtime import solve_result

    if args.algo != "dpop" and (args.dpop_budget_mb is not None
                                or args.i_bound is not None
                                or args.dpop_no_prune):
        output_metrics(
            {"status": "ERROR",
             "error": "--dpop-budget-mb/--i-bound/--dpop-no-prune only "
             "apply to -a dpop (or the exact-search family)"},
            args.output,
        )
        return 1
    try:
        algo_params = parse_algo_params(args.algo_params)
        if args.algo == "dpop":
            if args.dpop_budget_mb is not None:
                algo_params.setdefault("budget_mb", args.dpop_budget_mb)
            if args.i_bound is not None:
                algo_params.setdefault("i_bound", args.i_bound)
            if args.dpop_no_prune:
                algo_params["prune"] = False
        dcop = load_dcop_from_file(args.dcop_files)
        distribution = args.distribution
        if distribution is not None \
                and distribution.endswith((".yaml", ".yml")):
            from pydcop_tpu_torch.distribution import load_dist_from_file

            try:
                distribution = load_dist_from_file(distribution)
            except Exception as e:
                raise ValueError(f"cannot load distribution: {e}") from e
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
        )
    except Exception as e:
        output_metrics({"status": "ERROR", "error": str(e)}, args.output)
        return 1
    output_metrics(res.metrics(), args.output)
    return 0 if res.status in ("FINISHED", "TIMEOUT") else 1
