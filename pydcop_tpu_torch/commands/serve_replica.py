"""`pydcop_tpu_torch serve-replica` — the process-fleet replica child body.

The port of the JAX package's ``serve-replica`` command.  Not a
user-facing front door: :class:`~pydcop_tpu_torch.serve.ProcessFleet`
spawns this command once per replica process.  It hosts a real
:class:`~pydcop_tpu_torch.serve.SolveService` on ``--device`` (cuda
unless ``--device cpu`` is given) — own scheduler thread, journal,
heartbeat file, runner cache backed by the shared ``--artifact-dir``
store — and drives it from length-prefixed, CRC-framed command records
streamed over the ``--connect`` socket by the fleet head's
:class:`~pydcop_tpu_torch.serve.wire.JournalHub`.

The child's fault plan arrives through the watchdog environment
protocol (``PYDCOP_TPU_FAULT_PLAN``), not a flag, so a relaunched
incarnation automatically sees the same plan with its bumped attempt
counter.  Exit codes follow the watchdog's taxonomy: 0 clean,
negative/KILL_EXIT_CODE retryable (the head relaunches with backoff),
anything else permanent — a missing GPU exits with
:data:`~pydcop_tpu_torch.serve.procfleet.NO_DEVICE_EXIT_CODE`.
"""
from __future__ import annotations

import sys


def set_parser(subparsers):
    parser = subparsers.add_parser(
        "serve-replica",
        help="process-fleet replica child (spawned by ProcessFleet)",
    )
    parser.set_defaults(func=run_cmd)
    parser.add_argument("--connect", required=True,
                        help="host:port of the fleet head's journal "
                        "hub socket")
    parser.add_argument("--name", required=True,
                        help="replica name (journal + heartbeat + "
                        "router identity)")
    parser.add_argument("--journal-dir", default=None,
                        help="this replica's crash-safe journal + "
                        "per-lane checkpoint directory")
    parser.add_argument("--heartbeat-file", default=None,
                        help="heartbeat file the head's supervisor "
                        "watches for staleness")
    parser.add_argument("--artifact-dir", default=None,
                        help="shared store of runner recipes: a hit "
                        "here rebuilds (and captures) a peer's runner "
                        "before the first job")
    parser.add_argument("--lanes", type=int, default=4,
                        help="lane (slot) count of each service bucket")
    parser.add_argument("--max-cycles", type=int, default=0,
                        help="per-job cycle ceiling (0: engine default)")
    parser.add_argument("--checkpoint-every", type=int, default=4,
                        help="lane checkpoint cadence in chunks")
    parser.add_argument("--max-buckets", type=int, default=None,
                        help="resident bucket-worker ceiling")
    parser.add_argument("--stats-interval", type=float, default=0.25,
                        help="seconds between counter/cache-key "
                        "snapshots streamed to the head")
    parser.add_argument("--memo", action="store_true",
                        help="enable the cross-request solution cache "
                        "(entries persisted under the journal dir and "
                        "shared fleet-wide via memo_adopt frames)")
    parser.add_argument("--device", choices=["cuda", "cpu"],
                        default="cuda",
                        help="device of the replica's buckets and "
                        "fallback solves (default cuda; a missing GPU "
                        "exits permanently, never a silent CPU run)")
    return parser


def run_cmd(args):
    from pydcop_tpu_torch.errors import DeviceUnavailableError
    from pydcop_tpu_torch.runtime.faults import FaultPlan
    from pydcop_tpu_torch.serve.procfleet import (
        NO_DEVICE_EXIT_CODE,
        ReplicaWorker,
    )

    host, _, port = args.connect.rpartition(":")
    try:
        worker = ReplicaWorker(
            (host or "127.0.0.1", int(port)),
            args.name,
            journal_dir=args.journal_dir,
            heartbeat_path=args.heartbeat_file,
            artifact_dir=args.artifact_dir,
            lanes=args.lanes,
            max_cycles=args.max_cycles,
            checkpoint_every=args.checkpoint_every,
            max_buckets=args.max_buckets,
            fault_plan=FaultPlan.from_env(),
            stats_interval=args.stats_interval,
            memo=bool(args.memo),
            device=args.device,
        )
    except DeviceUnavailableError as e:
        print(f"serve-replica {args.name}: {e}", file=sys.stderr)
        return NO_DEVICE_EXIT_CODE
    return worker.run()


if __name__ == "__main__":  # pragma: no cover
    sys.exit(run_cmd(None))
