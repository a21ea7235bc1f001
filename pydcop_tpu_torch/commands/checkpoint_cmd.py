"""``pydcop_tpu_torch checkpoint`` — offline checkpoint/journal hygiene.

The port of the JAX package's ``checkpoint`` command: the same output,
exit codes and quarantine renames.  ``checkpoint scrub <dir>`` walks a
journal/checkpoint tree and verifies every artifact OFFLINE — the
hygiene pass a long-lived snapshot directory needs between runs:

* ``*.npz`` checkpoints go through the full hardened read
  (runtime/checkpoint.read_state_npz): zip integrity, schema version,
  and every per-array CRC32;
* ``*.jsonl`` journals are line-checked with the serve tier's
  torn-line discipline: an unterminated TAIL line is tolerated (a
  crash loses at most the in-flight append — counted, not corrupt),
  but an unparseable line with records after it is corruption.

Exit status 1 when any corruption was found (and left in place);
``--fix`` quarantines each bad file by renaming it to
``<name>.quarantined`` — exactly the set resume()/latest_valid_state()
would have skipped at runtime, now moved out of the snapshot rotation
so the next run never reads them at all — and exits 0.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List


def set_parser(subparsers):
    parser = subparsers.add_parser(
        "checkpoint",
        help="offline checkpoint/journal verification (scrub)",
    )
    actions = parser.add_subparsers(dest="action", required=True)
    scrub = actions.add_parser(
        "scrub",
        help="verify every checkpoint CRC + schema and every journal "
        "line under a directory tree; exit 1 on corruption",
    )
    scrub.add_argument("directory", help="checkpoint/journal tree root")
    scrub.add_argument(
        "--fix", action="store_true",
        help="quarantine corrupt files (rename to *.quarantined — the "
        "same files resume() would skip) and exit 0",
    )
    scrub.set_defaults(func=run_cmd)


def _scrub_npz(path: str) -> List[str]:
    from pydcop_tpu_torch.runtime.checkpoint import read_state_npz

    try:
        read_state_npz(path)
    except ValueError as e:
        return [str(e)]
    return []


def _scrub_jsonl(path: str) -> List[str]:
    problems: List[str] = []
    with open(path, "rb") as f:
        raw = f.read()
    if not raw:
        return problems
    lines = raw.split(b"\n")
    torn_tail = lines[-1] != b""  # no trailing newline: in-flight append
    body = lines[:-1]
    for i, line in enumerate(body):
        if not line.strip():
            continue
        try:
            rec = json.loads(line.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            rest = any(ln.strip() for ln in body[i + 1:])
            if rest or not torn_tail:
                problems.append(
                    f"line {i + 1} is not a JSON record"
                )
    return problems


def run_cmd(args) -> int:
    root = args.directory
    if not os.path.isdir(root):
        print(json.dumps({
            "status": "ERROR",
            "error": f"{root!r} is not a directory",
        }))
        return 1
    checked = 0
    torn_tails = 0
    corrupt: List[Dict[str, Any]] = []
    quarantined: List[str] = []
    for dirpath, _dirs, names in os.walk(root):
        for name in sorted(names):
            path = os.path.join(dirpath, name)
            if name.endswith(".quarantined"):
                continue
            if name.endswith(".npz"):
                problems = _scrub_npz(path)
            elif name.endswith(".jsonl"):
                problems = _scrub_jsonl(path)
                with open(path, "rb") as f:
                    data = f.read()
                if data and not data.endswith(b"\n"):
                    torn_tails += 1
            else:
                continue
            checked += 1
            if problems:
                rel = os.path.relpath(path, root)
                corrupt.append({"file": rel, "problems": problems})
                if args.fix:
                    os.replace(path, path + ".quarantined")
                    quarantined.append(rel)
    out = {
        "status": "CORRUPT" if corrupt and not args.fix else "OK",
        "checked": checked,
        "corrupt": corrupt,
        "torn_tails_tolerated": torn_tails,
        "quarantined": quarantined,
    }
    print(json.dumps(out, indent=2, sort_keys=True))
    return 1 if corrupt and not args.fix else 0
