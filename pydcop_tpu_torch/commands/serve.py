"""`pydcop_tpu_torch serve` — the continuous-batching solve service's CLI
front door.

The port of the JAX package's ``serve`` command, its single-service path:
feeds a stream of jobs drawn from the given DCOP files through an
in-process :class:`~pydcop_tpu_torch.serve.SolveService` on ``--device``
(cuda unless ``--device cpu`` is given) and prints one JSON object with
per-job metrics, the serve counters, the runner cache's scorecard, the
bucket runners' calls and the (seeded, reproducible) arrival trace — the
JAX command's keys.

Arrival models:

* ``--arrival immediate`` (default): all jobs submitted up front —
  a burst, the serving twin of ``solve --batch``;
* ``--arrival poisson --rate R``: seeded Poisson arrivals at ``R``
  jobs/sec (``--arrival-seed``); the exact arrival offsets land in the
  output JSON as ``arrival.trace`` so a run can be replayed.

``--jobs N`` cycles through the files round-robin with seeds 0..N-1
(``--seed-period P``: seeds cycle with period P); the default is one job
per file.  ``--journal-dir`` makes the session crash-safe (submissions
journaled, per-lane chunk-boundary checkpoints, ``JID:`` completion
lines); ``--resume`` re-queues the journal's unfinished jobs first,
re-seated at their last checkpointed chunk boundary.  ``--max-pending``
and ``--tenant-quota`` turn on admission control — rejected submits land
in the output's ``rejected`` list with their retry-after hints — and
``--fault-plan plan.yaml`` arms the seeded serve fault injector.

Not ported yet, and refused with
:class:`~pydcop_tpu_torch.errors.NotPortedError` (the JSON error the
port's ``solve`` and ``batch`` use): ``--replicas`` above 1 and
``--processes`` (the fleets), ``--memo`` / ``--memo-ttl`` /
``--memo-max-edits`` (the solution cache) and ``--uiport`` (the GUI
server).
"""
from __future__ import annotations

import sys
import time

from pydcop_tpu_torch.commands._utils import (
    output_metrics,
    parse_algo_params,
)
from pydcop_tpu_torch.errors import DeviceUnavailableError, NotPortedError


def set_parser(subparsers):
    parser = subparsers.add_parser(
        "serve", help="continuous-batching solve service"
    )
    parser.set_defaults(func=run_cmd)
    parser.add_argument("dcop_files", nargs="*",
                        help="DCOP YAML file(s) — the job pool")
    parser.add_argument("-a", "--algo", required=True,
                        help="algorithm name")
    parser.add_argument(
        "-p", "--algo_params", action="append",
        help="algorithm parameter as name:value, repeatable",
    )
    parser.add_argument("--jobs", type=int, default=None,
                        help="total jobs to submit (default: one per "
                        "file); files are cycled round-robin, seeds "
                        "run 0..N-1")
    parser.add_argument("--arrival", choices=["immediate", "poisson"],
                        default="immediate",
                        help="arrival process for the submitted jobs")
    parser.add_argument("--rate", type=float, default=10.0,
                        help="poisson arrival rate, jobs/sec")
    parser.add_argument("--arrival-seed", type=int, default=0,
                        help="seed of the Poisson arrival process "
                        "(the trace is recorded in the output JSON)")
    parser.add_argument("--lanes", type=int, default=4,
                        help="lane (slot) count of each service bucket")
    parser.add_argument("--replicas", type=int, default=1,
                        help="solve-service replicas: above 1 (the "
                        "fleet tier) is not ported")
    parser.add_argument("--processes", action="store_true",
                        help="replicas as child processes: not ported")
    parser.add_argument("--deadline", type=float, default=None,
                        help="per-job deadline in seconds (deadline-"
                        "pressured lanes shrink their chunks; expired "
                        "jobs complete as TIMEOUT and are counted "
                        "preempted)")
    parser.add_argument("--priority", type=int, default=0,
                        help="priority of every submitted job (higher "
                        "admits first)")
    parser.add_argument("--max-cycles", type=int, default=2000,
                        help="per-job cycle ceiling for "
                        "run-to-convergence")
    parser.add_argument("--prewarm", action="store_true",
                        help="build (and on the card capture) bucket "
                        "runners for the file pool's shapes BEFORE "
                        "starting arrivals")
    parser.add_argument("--max-pending", type=int, default=None,
                        help="bound on the not-yet-admitted queue: "
                        "submits beyond it are shed with a structured "
                        "overload error (a lower-priority queued job "
                        "is displaced instead when the arrival "
                        "outranks it)")
    parser.add_argument("--tenant-quota", type=int, default=None,
                        help="max open (unfinished) jobs per tenant; "
                        "submits over quota are rejected with a "
                        "retry-after hint")
    parser.add_argument("--fault-plan", default=None,
                        help="seeded serve fault plan YAML (chaos "
                        "injection: raise_in_step / nan_lane / "
                        "torn_journal_write / stall_tick)")
    parser.add_argument("--journal-dir", default=None,
                        help="crash-safe session journal + per-lane "
                        "chunk-boundary checkpoints")
    parser.add_argument("--resume", action="store_true",
                        help="re-queue the journal's unfinished jobs "
                        "(resumed from their last chunk boundary) "
                        "before submitting new ones")
    parser.add_argument("--uiport", type=int, default=None,
                        help="the GUI server: not ported")
    parser.add_argument("--memo", action="store_true",
                        help="the cross-request solution cache: not "
                        "ported")
    parser.add_argument("--memo-ttl", type=float, default=None,
                        help="solution-cache entry time-to-live: not "
                        "ported")
    parser.add_argument("--memo-max-edits", type=int, default=None,
                        help="solution-cache warm-start edits: not "
                        "ported")
    parser.add_argument("--seed-period", type=int, default=None,
                        help="cycle job seeds with this period "
                        "instead of 0..N-1 — with one file, jobs i "
                        "and i+PERIOD are exact duplicates")
    parser.add_argument("--device", choices=["cuda", "cpu"],
                        default="cuda",
                        help="device of the service's buckets and "
                        "fallback solves (default cuda; a missing GPU "
                        "is an error, never a silent CPU run)")
    return parser


def refuse_unported(args) -> None:
    """Raise :class:`NotPortedError` for a flag of the fleet, memo or UI
    tiers (none is accepted and then ignored)."""
    refused = []
    if args.replicas > 1:
        refused.append(f"--replicas {args.replicas} (the solve fleet)")
    if args.processes:
        refused.append("--processes (the process fleet)")
    if args.memo:
        refused.append("--memo (the solution cache)")
    if args.memo_ttl is not None:
        refused.append("--memo-ttl (the solution cache)")
    if args.memo_max_edits is not None:
        refused.append("--memo-max-edits (the solution cache)")
    if args.uiport is not None:
        refused.append("--uiport (the GUI server)")
    if refused:
        raise NotPortedError(
            f"serve: {', '.join(refused)} not ported to the PyTorch "
            f"package yet; it serves one in-process SolveService")


def run_cmd(args):
    import numpy as np

    from pydcop_tpu_torch.dcop import load_dcop_from_file
    from pydcop_tpu_torch.serve import (
        ServeError,
        ServiceOverloaded,
        SolveService,
    )

    refuse_unported(args)
    if args.resume and not args.journal_dir:
        output_metrics(
            {"status": "ERROR",
             "error": "--resume requires --journal-dir"},
            args.output,
        )
        return 1
    algo_params = parse_algo_params(args.algo_params)

    pool, errors = [], {}
    for fn in args.dcop_files:
        try:
            pool.append((fn, load_dcop_from_file([fn])))
        except Exception as e:
            errors[fn] = {"status": "ERROR", "error": str(e)}
    if errors and not pool:
        output_metrics(
            {"status": "ERROR", "results": errors}, args.output
        )
        return 1

    fault_plan = None
    if args.fault_plan:
        from pydcop_tpu_torch.runtime.faults import FaultPlan

        try:
            fault_plan = FaultPlan.from_yaml(args.fault_plan)
        except (OSError, ValueError) as e:
            output_metrics(
                {"status": "ERROR",
                 "error": f"bad fault plan: {e}"},
                args.output,
            )
            return 1

    try:
        service = SolveService(
            lanes=args.lanes,
            max_cycles=args.max_cycles,
            journal_dir=args.journal_dir,
            max_pending=args.max_pending,
            tenant_quota=args.tenant_quota,
            fault_plan=fault_plan,
            device=args.device,
        )
    except DeviceUnavailableError as e:
        output_metrics({"status": "ERROR", "error": str(e)}, args.output)
        return 1
    n_resumed = 0
    if args.resume:
        n_resumed = service.resume()
    if args.prewarm and pool:
        service.prewarm(
            [(dcop, args.algo, algo_params) for _fn, dcop in pool],
            block=True,
        )
    service.start()

    # arrival schedule (recorded for reproducibility)
    n_jobs = args.jobs if args.jobs is not None else len(pool)
    offsets = [0.0] * n_jobs
    if args.arrival == "poisson" and n_jobs:
        rng = np.random.default_rng(args.arrival_seed)
        inter = rng.exponential(1.0 / max(args.rate, 1e-9), n_jobs)
        inter[0] = 0.0
        offsets = [float(x) for x in np.cumsum(inter)]
    trace = [round(o, 6) for o in offsets]

    jids, rejected = [], []
    t0 = time.monotonic()
    for i in range(n_jobs):
        fn, dcop = pool[i % len(pool)] if pool else (None, None)
        if dcop is None:
            break
        wait = offsets[i] - (time.monotonic() - t0)
        if wait > 0:
            time.sleep(wait)
        seed = i if args.seed_period is None else i % args.seed_period
        try:
            jids.append(service.submit(
                dcop, args.algo, algo_params=algo_params, seed=seed,
                priority=args.priority, deadline_s=args.deadline,
                label=f"{fn}:{i}", source_file=fn,
            ))
        except ServeError as e:
            # admission control said no: a structured, recorded
            # rejection — never a silent drop
            rej = {"label": f"{fn}:{i}", "error": str(e)}
            if isinstance(e, ServiceOverloaded):
                rej.update(e.to_dict())
            rejected.append(rej)

    # resumed jobs are part of the session too
    all_jids = sorted(
        set(jids) | {j for j in service._jobs if args.resume}
    )
    per_job = dict(errors)
    ok = True
    try:
        for jid in all_jids:
            try:
                res = service.result(jid, timeout=args.timeout)
            except TimeoutError:
                per_job[jid] = {"status": "TIMEOUT",
                                "error": "service timeout"}
                ok = False
                continue
            except ServeError as e:
                per_job[jid] = {"status": "ERROR", "error": str(e)}
                ok = False
                continue
            job = service._jobs[jid]
            m = res.metrics()
            m["tenant"] = job.tenant
            m["label"] = job.label
            m["resumed"] = bool(job.resumed)
            per_job[jid] = m
            if res.status not in ("FINISHED", "TIMEOUT"):
                ok = False
    finally:
        service.stop(drain=False)

    payload = {
        "status": "FINISHED" if ok and not errors else "ERROR",
        "results": per_job,
        "arrival": {
            "model": args.arrival,
            "rate": args.rate,
            "seed": args.arrival_seed,
            "trace": trace,
        },
        "rejected": rejected,
        "resumed_jobs": n_resumed,
        "serve": service.metrics(),
    }
    output_metrics(payload, args.output)
    return 0 if ok and not errors else 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(run_cmd(None))
