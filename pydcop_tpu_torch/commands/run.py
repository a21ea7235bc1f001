"""`pydcop_tpu_torch run` — solve a dynamic DCOP with a scenario.

The port of the JAX package's ``run`` command (the reference's
pydcop/commands/run.py, run_cmd :312-446): like solve, plus a scenario
event stream, k-replication and repair on agent departures, over the
:class:`~pydcop_tpu_torch.runtime.orchestrator.VirtualOrchestrator` on
``--device``.  The JAX package's flags, plus ``--device``.  A scenario
delay converts to cycles at the measured device rate; the library's
``VirtualOrchestrator.run(cycles=)`` fixes every phase's cycles instead.
``-m process`` (the process runtime) raises
:class:`~pydcop_tpu_torch.errors.NotPortedError`.
"""
from __future__ import annotations

from pydcop_tpu_torch.commands._utils import (
    add_csvline,
    output_metrics,
    parse_algo_params,
)
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.runtime.run import REPLICATION_METHOD


def set_parser(subparsers):
    parser = subparsers.add_parser("run", help="run a dynamic DCOP")
    parser.set_defaults(func=run_cmd)
    parser.add_argument("dcop_files", nargs="+")
    parser.add_argument("-a", "--algo", required=True)
    parser.add_argument("-p", "--algo_params", action="append")
    parser.add_argument("-d", "--distribution", default="oneagent")
    parser.add_argument("-s", "--scenario", required=True,
                        help="scenario YAML file")
    parser.add_argument("-m", "--mode", choices=["thread", "process"],
                        default="thread",
                        help="thread (the orchestrator in this process); "
                        "process is not ported")
    parser.add_argument("-c", "--collect_on",
                        choices=["value_change", "cycle_change", "period"],
                        default="value_change")
    parser.add_argument("--period", type=float, default=None)
    parser.add_argument("--run_metrics", default=None)
    parser.add_argument("--end_metrics", default=None)
    parser.add_argument("--replication_method", default=REPLICATION_METHOD,
                        help="the one replica-placement method")
    parser.add_argument("--uiport", type=int, default=None,
                        help="serve the GUI websocket protocol + HTTP "
                        "/state on this port (ws on port+1)")
    parser.add_argument("--ktarget", type=int, default=3,
                        help="replication level k")
    parser.add_argument("--replica_dist", default=None,
                        help="pre-computed replica-distribution YAML "
                        "(from `replica_dist`); skips online replication")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", choices=["cuda", "cpu"],
                        default="cuda",
                        help="device to solve on (default cuda; a missing "
                        "GPU is an error, never a silent CPU run)")
    # crash resilience
    parser.add_argument("--fault-plan", default=None,
                        help="fault-plan YAML (runtime/faults.py): "
                        "kill_agent and the churn faults fire at phase "
                        "boundaries and route through the replica-repair "
                        "handshake; the checkpoint faults damage the "
                        "newest snapshot before --resume reads it")
    parser.add_argument("--checkpoint", default=None,
                        help="rotating snapshot directory: solver state "
                        "is persisted every --checkpoint-every cycles "
                        "(atomic + checksummed)")
    parser.add_argument("--checkpoint-every", type=int, default=10)
    parser.add_argument("--resume", action="store_true",
                        help="warm-start from the newest valid snapshot "
                        "in --checkpoint (corrupt files are skipped)")
    # warm repair
    parser.add_argument("--warm-repair", action="store_true",
                        help="route scenario mutations and agent churn "
                        "through the warm-repair layer: in-place "
                        "fixed-shape writes at reserved headroom (no "
                        "re-capture; one counted repack when exhausted) "
                        "instead of cold restarts "
                        "(maxsum/maxsum_dynamic/mgm/dsa/adsa)")
    parser.add_argument("--headroom", type=float, default=0.25,
                        help="with --warm-repair: reserved inert slot "
                        "fraction of the compiled capacity (default "
                        "0.25)")
    return parser


def run_cmd(args):
    from pydcop_tpu_torch.algorithms import AlgorithmDef
    from pydcop_tpu_torch.dcop import (
        load_dcop_from_file,
        load_scenario_from_file,
    )
    from pydcop_tpu_torch.runtime.orchestrator import VirtualOrchestrator
    from pydcop_tpu_torch.runtime.ui import serving

    if args.mode == "process":
        raise NotPortedError(
            "run -m process (the process runtime, runtime/process.py) is "
            "not ported to the PyTorch package yet; run -m thread")
    if args.replication_method != REPLICATION_METHOD:
        output_metrics(
            {"status": "ERROR",
             "error": f"unknown replication method "
             f"{args.replication_method!r}; the one method is "
             f"{REPLICATION_METHOD!r}"}, args.output)
        return 1
    dcop = load_dcop_from_file(args.dcop_files)
    scenario = load_scenario_from_file(args.scenario)
    algo_params = parse_algo_params(args.algo_params)
    algo_def = AlgorithmDef.build_with_default_params(
        args.algo, algo_params, mode=dcop.objective
    )
    fault_plan = None
    if args.fault_plan:
        from pydcop_tpu_torch.runtime.faults import FaultPlan

        try:
            fault_plan = FaultPlan.from_yaml(args.fault_plan)
        except (OSError, ValueError) as e:
            output_metrics(
                {"status": "ERROR",
                 "error": f"cannot load fault plan: {e}"}, args.output)
            return 1
    collected = []
    orch = VirtualOrchestrator(
        dcop, algo_def, distribution=args.distribution,
        collect_on=args.collect_on, period=args.period,
        collector=(lambda t, m: collected.append((t, m)))
        if args.run_metrics else None,
        seed=args.seed,
        fault_plan=fault_plan,
        checkpoint_dir=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        auto_resume=args.resume,
        warm_repair=args.warm_repair,
        headroom=args.headroom,
        device=args.device,
    )
    orch.deploy_computations()
    if args.replica_dist:
        from pydcop_tpu_torch.replication.yamlformat import (
            load_replica_dist_from_file,
        )

        orch.replicas = load_replica_dist_from_file(args.replica_dist)
    elif args.ktarget:
        orch.start_replication(args.ktarget)
    with serving(args.uiport, orchestrator=orch) as ui:
        try:
            orch.run(scenario, timeout=args.timeout)
        except Exception as e:
            output_metrics({"status": "ERROR", "error": str(e)},
                           args.output)
            return 1
        finally:
            if ui is not None:
                ui.update_state(**orch.end_metrics())
    metrics = orch.end_metrics()
    if args.run_metrics:
        for _t, m in collected:
            add_csvline(args.run_metrics, args.collect_on, m)
    if args.end_metrics:
        add_csvline(args.end_metrics, args.collect_on, metrics)
    output_metrics(metrics, args.output)
    return 0
