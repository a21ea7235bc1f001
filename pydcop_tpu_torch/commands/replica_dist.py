"""`pydcop_tpu_torch replica_dist` — compute a replica placement offline.

The port of the JAX package's ``replica_dist`` command (the reference's
pydcop/commands/replica_dist.py): given a DCOP, an algorithm and a
distribution strategy, place k replicas of every computation and emit
the mapping as a replica-distribution YAML document (reference
:219-233) that ``pydcop_tpu_torch run --replica_dist`` reads.  Host
code only: no device is touched.
"""
from __future__ import annotations

import sys

from pydcop_tpu_torch.runtime.run import REPLICATION_METHOD


def set_parser(subparsers):
    parser = subparsers.add_parser(
        "replica_dist", help="compute replica placement"
    )
    parser.set_defaults(func=run_cmd)
    parser.add_argument("dcop_files", nargs="+")
    parser.add_argument("-a", "--algo", required=True)
    parser.add_argument("-d", "--distribution", default="oneagent")
    parser.add_argument("-k", "--ktarget", type=int, required=True)
    return parser


def run_cmd(args):
    from pydcop_tpu_torch.algorithms import load_algorithm_module
    from pydcop_tpu_torch.dcop import load_dcop_from_file
    from pydcop_tpu_torch.distribution import load_distribution_module
    from pydcop_tpu_torch.graph import load_graph_module
    from pydcop_tpu_torch.replication import place_replicas
    from pydcop_tpu_torch.replication.yamlformat import yaml_replica_dist

    dcop = load_dcop_from_file(args.dcop_files)
    algo_module = load_algorithm_module(args.algo)
    cg = load_graph_module(algo_module.GRAPH_TYPE).build_computation_graph(
        dcop
    )
    dist_module = load_distribution_module(args.distribution)
    try:
        dist = dist_module.distribute(
            cg, dcop.agents.values(), hints=dcop.dist_hints,
            computation_memory=algo_module.computation_memory,
            communication_load=algo_module.communication_load,
        )
    except Exception as e:
        print(f"replica_dist: cannot distribute with "
              f"'{args.distribution}': {e}", file=sys.stderr)
        return 1
    replicas = place_replicas(
        [n.name for n in cg.nodes], dist, dcop.agents.values(),
        args.ktarget,
        computation_memory=lambda c: algo_module.computation_memory(
            cg.computation(c)
        ),
    )
    text = yaml_replica_dist(replicas, inputs={
        "dcop": list(args.dcop_files),
        "algo": args.algo,
        "distribution": args.distribution,
        "replication": REPLICATION_METHOD,
        "k": args.ktarget,
    })
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0
