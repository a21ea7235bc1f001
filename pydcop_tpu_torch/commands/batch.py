"""`pydcop_tpu_torch batch` — YAML-driven benchmark sweeps.

The port of the JAX package's ``batch`` command.  Equivalent capability
to the reference's pydcop/commands/batch.py (:117-357): problem *sets*
(file lists + iterations) × *batches* (a command template +
cross-product of option values), each run as a subprocess of this CLI.

Resume protocol (reference parity, batch.py:56-142): every job that ran
without error is registered as a ``JID:`` line in a
``progress_<batch_file>`` state file inside the output directory; on
startup, registered jobs are skipped, so an interrupted sweep (crash,
kill -9, a preempted machine) resumes exactly where it stopped —
completion is recorded per JOB, not inferred from output files, so a
truncated output from a killed run is re-run rather than trusted.  When
the whole batch completes, the file is renamed
``done_<batch_file>_<date>`` (delete the progress file to re-run from
scratch).  The total job count (sets × files × iterations ×
combinations) is estimated up front (reference batch.py:159-169).

When NO progress file exists — outputs produced before the progress
protocol, or a sweep already completed and renamed to ``done_*`` —
existing output files are trusted as completed and skipped, so
re-invoking an old or finished sweep does not silently re-run and
overwrite everything; pass ``--force`` to re-run those jobs anyway.
While a progress file exists it is authoritative: an output file
without a ``JID:`` entry is an in-flight job that was killed, and is
re-run rather than trusted.

Batch definition format:

```yaml
sets:
  set1:
    path: ["instances/*.yaml"]     # glob(s)
    iterations: 2                   # repeat each file (seed varies)
batches:
  maxsum_sweep:
    command: solve                  # CLI command
    command_options:
      algo: [maxsum, dsa]           # cross-product of lists
      algo_params: ["damping:0.5"]
    global_options:
      timeout: 5
```

``--engine in-process`` routes ``solve`` jobs through the batched
engine (:class:`pydcop_tpu_torch.batch.BatchEngine`) instead of forking
one CLI subprocess per job: instances are shape-bucketed and solved B at
a time with one runner per bucket, so a 1000-job sweep pays neither 1000
interpreter startups nor 1000 chunk captures.  The JID resume
protocol is unchanged — every in-process job still registers its
``JID:`` line as its output file is written, so interrupted sweeps
resume identically in both engines.  Jobs the engine cannot express
(non-``solve`` commands, option combos beyond
algo/algo_params/cycles/seed) transparently fall back to the
subprocess path, per job.

Jobs run on ``--device`` (cuda unless ``--device cpu`` is given): the
in-process engine's device, and ``--device`` appended to each
subprocess ``solve`` job whose options do not set it.
``--compile-cache-dir`` (the JAX package's persistent XLA cache) raises
:class:`~pydcop_tpu_torch.errors.NotPortedError`.
"""
from __future__ import annotations

import datetime
import glob
import itertools
import os
import shutil
import subprocess
import sys
from typing import Any, Dict, List

import yaml


def set_parser(subparsers):
    parser = subparsers.add_parser("batch", help="run benchmark sweeps")
    parser.set_defaults(func=run_cmd)
    parser.add_argument("batch_file", help="batch definition YAML")
    parser.add_argument("--simulate", action="store_true",
                        help="print commands without running")
    parser.add_argument("--output_dir", default="batch_output")
    parser.add_argument(
        "--force", action="store_true",
        help="re-run jobs whose output file exists but has no progress "
        "entry (by default such outputs are trusted when no progress "
        "file exists)")
    parser.add_argument(
        "--engine", choices=["subprocess", "in-process"],
        default="subprocess",
        help="'in-process': route solve jobs through the batched engine "
        "(one runner per shape bucket); 'subprocess': one CLI subprocess "
        "per job (reference parity)")
    parser.add_argument(
        "--max-padding-waste", type=float, default=0.25,
        help="in-process bucketing: max fraction of padded array cells "
        "holding no real data before a new bucket is opened")
    parser.add_argument(
        "--compile-cache-dir", default=None,
        help="a persistent compile cache directory: not ported (bucket "
        "runners are CUDA graphs held in their process)")
    parser.add_argument("--device", choices=["cuda", "cpu"],
                        default="cuda",
                        help="device of the jobs (default cuda; a missing "
                        "GPU is an error, never a silent CPU run)")
    return parser


def _option_combinations(options: Dict[str, Any]):
    keys = list(options)
    value_lists = [
        v if isinstance(v, list) else [v] for v in (options[k] for k in keys)
    ]
    for combo in itertools.product(*value_lists):
        yield dict(zip(keys, combo))


def _opt_to_cli(name: str, value) -> List[str]:
    if isinstance(value, bool):
        return [f"--{name}"] if value else []
    return [f"--{name}", str(value)]


def _iter_jobs(definition, output_dir, device="cuda"):
    """Yield (jid, out_path, cmd, spec) for every job of the sweep, in
    a deterministic order (jid doubles as the output file stem).
    ``cmd`` is the subprocess argv; ``spec`` is the structured
    description (command / file / combo / global_options / iteration)
    the in-process engine interprets directly."""
    sets = definition.get("sets", {"default": {"path": []}})
    batches = definition.get("batches", {})
    for set_name, set_def in sets.items():
        paths = set_def.get("path", [])
        if isinstance(paths, str):
            paths = [paths]
        files: List[str] = []
        for p in paths:
            files.extend(sorted(glob.glob(p)))
        iterations = int(set_def.get("iterations", 1))
        for batch_name, batch_def in batches.items():
            command = batch_def.get("command", "solve")
            for combo in _option_combinations(
                batch_def.get("command_options", {})
            ):
                for it in range(iterations):
                    for fn in files or [None]:
                        jid = "_".join(
                            str(x)
                            for x in [
                                set_name, batch_name,
                                os.path.basename(fn) if fn else "nofile",
                                *(f"{k}{v}" for k, v in combo.items()),
                                f"it{it}",
                            ]
                        ).replace("/", "-").replace(":", "")
                        out_path = os.path.join(output_dir, jid + ".json")
                        cmd = [sys.executable, "-m", "pydcop_tpu_torch",
                               "--output", out_path]
                        for k, v in (
                            batch_def.get("global_options") or {}
                        ).items():
                            cmd.extend(_opt_to_cli(k, v))
                        cmd.append(command)
                        for k, v in combo.items():
                            cmd.extend(_opt_to_cli(k, v))
                        if command == "solve":
                            cmd.extend(_opt_to_cli("seed", it))
                            if "device" not in combo:
                                cmd.extend(_opt_to_cli("device", device))
                        if fn:
                            cmd.append(fn)
                        spec = {
                            "command": command,
                            "file": fn,
                            "combo": dict(combo),
                            "global_options": dict(
                                batch_def.get("global_options") or {}
                            ),
                            "iteration": it,
                        }
                        yield jid, out_path, cmd, spec


def estimate_jobs(definition) -> int:
    """Upfront job count: sets × files × iterations × combinations
    (reference batch.py:159-169)."""
    return sum(1 for _ in _iter_jobs(definition, ""))


def _load_progress(progress_path: str) -> set:
    if not os.path.exists(progress_path):
        return set()
    with open(progress_path, encoding="utf-8") as f:
        return {
            line[5:].strip() for line in f if line.startswith("JID: ")
        }


def _register_jid(progress_path: str, jid: str) -> None:
    # append + flush per job: a kill -9 at any point loses at
    # most the in-flight work, never a completed job
    with open(progress_path, "a", encoding="utf-8") as f:
        f.write(f"JID: {jid}\n")
        f.flush()
        os.fsync(f.fileno())


#: combo keys the in-process engine can interpret; a job whose combo
#: uses anything else keeps full CLI semantics via the subprocess path
_IN_PROCESS_KEYS = {"algo", "algo_params", "cycles", "seed"}


def _run_in_process(pending, progress_path, args):
    """Route eligible solve jobs through the BatchEngine.

    Returns (remaining_jobs_for_subprocess, n_run, n_failed).  Each
    completed job writes its metrics JSON to its output path and
    registers its JID exactly like the subprocess path, so the resume
    protocol sees no difference.  Completion granularity is one engine
    call per (timeout, cycles) group: a kill mid-call re-runs that
    call's jobs on resume, never loses a registered one.
    """
    import json

    from pydcop_tpu_torch.batch import BatchEngine, BatchItem
    from pydcop_tpu_torch.commands._utils import (
        NumpyEncoder,
        parse_algo_params,
    )
    from pydcop_tpu_torch.dcop import load_dcop_from_file

    eligible, remaining = [], []
    for job in pending:
        _jid, _out, _cmd, spec = job
        combo = spec["combo"]
        if (
            spec["command"] == "solve"
            and spec["file"]
            and "algo" in combo
            and set(combo) <= _IN_PROCESS_KEYS
        ):
            eligible.append(job)
        else:
            remaining.append(job)

    n_run = n_failed = 0
    engine = BatchEngine(
        max_padding_waste=getattr(args, "max_padding_waste", 0.25),
        device=getattr(args, "device", "cuda"),
    )
    # one engine call per (timeout, cycles) group — the engine itself
    # re-groups by algorithm+params and shape-buckets inside
    groups: dict = {}
    for job in eligible:
        _jid, _out, _cmd, spec = job
        combo = spec["combo"]
        timeout = spec["global_options"].get("timeout")
        cycles = combo.get("cycles")
        groups.setdefault(
            (timeout, cycles and int(cycles)), []
        ).append(job)

    for (timeout, cycles), jobs in sorted(
        groups.items(), key=lambda kv: str(kv[0])
    ):
        items, meta = [], []
        for jid, out_path, _cmd, spec in jobs:
            combo = spec["combo"]
            try:
                dcop = load_dcop_from_file([spec["file"]])
                ap = combo.get("algo_params")
                if ap is not None and not isinstance(ap, list):
                    ap = [str(ap)]
                params = parse_algo_params(ap) if ap else {}
                # subprocess parity: _iter_jobs appends `--seed <it>`
                # AFTER the combo options, and argparse keeps the last
                # occurrence — the iteration wins even over a combo seed
                seed = int(spec["iteration"])
                items.append(BatchItem(
                    dcop, str(combo["algo"]), algo_params=params,
                    seed=seed, label=jid,
                ))
                meta.append((jid, out_path))
            except Exception as e:
                n_failed += 1
                print(f"batch: job {jid} failed (in-process load): {e}",
                      file=sys.stderr)
        if not items:
            continue
        try:
            results = engine.solve(
                items, cycles=cycles,
                timeout=float(timeout) if timeout is not None else None,
            )
        except Exception as e:
            n_failed += len(items)
            print(f"batch: in-process engine failed ({e}); "
                  f"jobs count as failed", file=sys.stderr)
            continue
        for (jid, out_path), res in zip(meta, results):
            metrics = res.metrics()
            metrics["batch_engine"] = "in-process"
            with open(out_path, "w", encoding="utf-8") as f:
                f.write(json.dumps(metrics, sort_keys=True, indent="  ",
                                   cls=NumpyEncoder))
            n_run += 1
            _register_jid(progress_path, jid)
    print(
        f"batch: in-process engine solved {n_run} jobs "
        f"({engine.counters.counts['buckets_formed']} buckets, "
        f"{engine.cache.misses} runner builds, {engine.cache.hits} cache "
        f"hits, padding waste "
        f"{engine.counters.padding_waste:.1%})"
    )
    return remaining, n_run, n_failed


def run_cmd(args):
    from pydcop_tpu_torch.batch.cache import refuse_persistent_cache

    refuse_persistent_cache(getattr(args, "compile_cache_dir", None))
    with open(args.batch_file, encoding="utf-8") as f:
        definition = yaml.safe_load(f)

    os.makedirs(args.output_dir, exist_ok=True)

    batch_stem = os.path.splitext(os.path.basename(args.batch_file))[0]
    progress_path = os.path.join(args.output_dir, f"progress_{batch_stem}")
    done_jobs = _load_progress(progress_path)
    # no progress file → pre-protocol outputs or a completed (renamed to
    # done_*) sweep: trust existing output files unless --force
    trust_outputs = (
        not os.path.exists(progress_path) and not getattr(
            args, "force", False)
    )

    total = estimate_jobs(definition)
    print(f"batch: {total} jobs total, {len(done_jobs)} already done "
          f"(progress file: {progress_path})")

    n_run = n_skipped = n_failed = 0
    if not args.simulate and not os.path.exists(progress_path):
        with open(progress_path, "a", encoding="utf-8") as f:
            f.write(f"{batch_stem}_{datetime.datetime.now():%Y%m%d_%H%M}\n")

    pending = []
    device = getattr(args, "device", "cuda")
    for jid, out_path, cmd, spec in _iter_jobs(definition, args.output_dir,
                                               device):
        if jid in done_jobs or (trust_outputs and os.path.exists(out_path)):
            n_skipped += 1
            continue
        if args.simulate:
            print(" ".join(cmd))
            continue
        pending.append((jid, out_path, cmd, spec))

    in_process = getattr(args, "engine", "subprocess") == "in-process"
    if in_process and pending:
        pending, ran, failed = _run_in_process(pending, progress_path, args)
        n_run += ran
        n_failed += failed

    for jid, out_path, cmd, _spec in pending:
        res = subprocess.run(cmd, check=False, capture_output=True)
        if res.returncode == 0:
            n_run += 1
            _register_jid(progress_path, jid)
        else:
            n_failed += 1
            tail = (res.stderr or b"")[-500:].decode(errors="replace")
            print(f"batch: job {jid} failed (rc={res.returncode}): {tail}",
                  file=sys.stderr)

    if not args.simulate and n_failed == 0:
        # everything ran: the progress file becomes a completion record
        done_path = os.path.join(
            args.output_dir,
            f"done_{batch_stem}_{datetime.datetime.now():%Y%m%d_%H%M}",
        )
        shutil.move(progress_path, done_path)
    print(f"batch: ran {n_run}, skipped {n_skipped}, failed {n_failed} "
          f"(outputs in {args.output_dir})")
    return 0 if n_failed == 0 else 1
