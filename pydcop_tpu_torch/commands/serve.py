"""`pydcop_tpu_torch serve` — the continuous-batching solve service's CLI
front door.

The port of the JAX package's ``serve`` command: feeds a stream of jobs
drawn from the given DCOP files through an in-process
:class:`~pydcop_tpu_torch.serve.SolveService` on ``--device`` (cuda unless
``--device cpu`` is given) and prints one JSON object with per-job
metrics, the serve counters, the runner cache's scorecard, the bucket
runners' calls and the (seeded, reproducible) arrival trace — the JAX
command's keys.

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
``--memo`` turns on the cross-request solution cache
(:mod:`pydcop_tpu_torch.serve.memo`; ``--memo-ttl`` seconds a result
lives, ``--memo-max-edits`` factor edits a warm-started variant may
replay), persisted beside the journal with ``--journal-dir`` and
rehydrated by ``--resume``; its scorecard lands in ``serve.memo`` and
each job's provenance in its ``memo`` key.

``--replicas N`` (N > 1) serves the same trace through the fleet tier:
N replicated services (threads of this process, one CUDA context)
behind a runner-cache-signature router, per-replica journal streaming
into ``fleet.jsonl`` with ``--journal-dir``, and failover re-seating —
with a ``kill_replica`` fault in the plan, every in-flight job of the
killed replica completes on a peer bit-identically.  ``--processes``
makes each of the ``--replicas`` replicas (one included) a child
process (``serve-replica``, its own CUDA context on the card): a
socket-streamed journal, a ``kill -9`` failure domain and shared runner
artifacts; it needs ``--journal-dir``, and its jobs need their YAML
files (the children load them).  With a fleet the output JSON has a
``fleet`` section (router state, per-replica counters, the
recovery-time objective) in place of ``serve``.

``--uiport`` serves the GUI websocket protocol + HTTP ``/state`` and the
SSE stream (``runtime/ui.py``) for the service's lifetime: its
``serve.*`` events reach the clients.
"""
from __future__ import annotations

import sys
import time

from pydcop_tpu_torch.commands._utils import (
    output_metrics,
    parse_algo_params,
)
from pydcop_tpu_torch.errors import DeviceUnavailableError


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
                        help="solve-service replicas; > 1 serves "
                        "through the fleet tier (SolveFleet): jobs "
                        "route by runner-cache signature onto warm "
                        "replicas, a dead replica's in-flight jobs "
                        "re-seat on peers bit-identically, and the "
                        "output JSON gains a 'fleet' section")
    parser.add_argument("--processes", action="store_true",
                        help="each replica is a real child PROCESS "
                        "(ProcessFleet) — socket-streamed journal, "
                        "kill -9 failure domain, shared runner "
                        "artifacts; requires --journal-dir")
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
                        help="serve the GUI websocket protocol + HTTP "
                        "/state on this port (ws on port+1)")
    parser.add_argument("--memo", action="store_true",
                        help="enable the cross-request solution cache: "
                        "exact duplicates are served bit-identically "
                        "from the cache, near-duplicates warm-start from "
                        "the nearest cached solution — never worse than "
                        "its seed.  Persisted beside the journal when "
                        "--journal-dir is given; --resume rehydrates")
    parser.add_argument("--memo-ttl", type=float, default=3600.0,
                        help="solution-cache entry time-to-live in "
                        "seconds")
    parser.add_argument("--memo-max-edits", type=int, default=8,
                        help="max factor-diff edits for a warm-start "
                        "variant hit (beyond it: cold solve)")
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


def run_cmd(args):
    import numpy as np

    from pydcop_tpu_torch.dcop import load_dcop_from_file
    from pydcop_tpu_torch.serve import (
        ProcessFleet,
        ServeError,
        ServiceOverloaded,
        SolveFleet,
        SolveService,
    )

    if args.resume and not args.journal_dir:
        output_metrics(
            {"status": "ERROR",
             "error": "--resume requires --journal-dir"},
            args.output,
        )
        return 1
    fleet_mode = args.replicas > 1 or args.processes
    if args.resume and fleet_mode:
        output_metrics(
            {"status": "ERROR",
             "error": "--resume is a single-service flag; a fleet "
                      "re-seats a dead replica's jobs on live peers "
                      "instead of restarting"},
            args.output,
        )
        return 1
    if args.processes and not args.journal_dir:
        output_metrics(
            {"status": "ERROR",
             "error": "--processes requires --journal-dir (the "
                      "socket journal, heartbeat files and shared "
                      "artifact store live there)"},
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

    memo_cfg = None
    if args.memo:
        from pydcop_tpu_torch.serve.memo import MemoConfig

        memo_cfg = MemoConfig(
            ttl_s=args.memo_ttl, max_edits=args.memo_max_edits,
        )

    common = dict(
        lanes=args.lanes,
        max_cycles=args.max_cycles,
        journal_dir=args.journal_dir,
        max_pending=args.max_pending,
        tenant_quota=args.tenant_quota,
        fault_plan=fault_plan,
        memo=memo_cfg,
        device=args.device,
    )
    fleet = None
    try:
        if args.processes:
            fleet = ProcessFleet(replicas=args.replicas, **common)
            try:
                fleet.wait_ready()
            except DeviceUnavailableError:
                fleet.stop(drain=False)
                raise
        elif fleet_mode:
            fleet = SolveFleet(replicas=args.replicas, **common)
        service = fleet if fleet is not None else SolveService(**common)
    except DeviceUnavailableError as e:
        output_metrics({"status": "ERROR", "error": str(e)}, args.output)
        return 1
    from pydcop_tpu_torch.runtime.ui import serving

    with serving(args.uiport):
        n_resumed = 0
        if args.resume:
            n_resumed = service.resume()
        if args.prewarm and pool:
            # a process fleet ships prewarms by source path (the DCOP
            # objects live in the children); everything else takes objects
            heads = ([fn for fn, _dcop in pool] if args.processes
                     else [dcop for _fn, dcop in pool])
            service.prewarm(
                [(h, args.algo, algo_params) for h in heads], block=True,
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
                # fleet jobs carry re-seat provenance instead of a resumed
                # flag; surface both through the same key
                m["resumed"] = bool(
                    getattr(job, "resumed", False)
                    or (m.get("serve") or {}).get("resumed")
                )
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
    }
    if fleet is not None:
        payload["fleet"] = fleet.metrics()
    else:
        payload["serve"] = service.metrics()
    output_metrics(payload, args.output)
    return 0 if ok and not errors else 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(run_cmd(None))
