"""Shared CLI helpers: algo-param parsing, JSON and CSV output.

Equivalent capability to the reference's pydcop/commands/_utils.py +
the NumpyEncoder/_results plumbing in pydcop/commands/solve.py:580-627.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np


class NumpyEncoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, (np.integer,)):
            return int(obj)
        if isinstance(obj, (np.floating,)):
            return float(obj)
        return json.JSONEncoder.default(self, obj)


def parse_algo_params(param_strs: Optional[List[str]]) -> Dict[str, Any]:
    """Parse repeated --algo_params name:value options."""
    params: Dict[str, Any] = {}
    for p in param_strs or []:
        if ":" not in p:
            raise ValueError(
                f"Invalid algo param {p!r}, expected name:value"
            )
        name, value = p.split(":", 1)
        params[name.strip()] = value.strip()
    return params


def output_metrics(metrics: Dict, output_file: Optional[str] = None) -> None:
    """Print (and optionally write) the metrics JSON, reference format:
    sorted keys, 2-space indent."""
    txt = json.dumps(metrics, sort_keys=True, indent="  ", cls=NumpyEncoder)
    if output_file:
        with open(output_file, "w", encoding="utf-8") as f:
            f.write(txt)
    print(txt)


CSV_COLUMNS = ["time", "cycle", "cost", "violation", "msg_count", "msg_size",
               "status"]


def add_csvline(csv_file: str, collect_on: str, metrics: Dict) -> None:
    """Append one metrics line to a CSV (creating the header on first
    write) — the JAX package's, itself the reference's
    pydcop/commands/_utils.py add_csvline."""
    new = not os.path.exists(csv_file)
    with open(csv_file, "a", encoding="utf-8") as f:
        if new:
            f.write(",".join(CSV_COLUMNS) + "\n")
        f.write(
            ",".join(str(metrics.get(c, "")) for c in CSV_COLUMNS) + "\n"
        )


def warn_process_mode(mode: str) -> None:
    """One-line stderr notice when --mode process is requested: both
    modes run the single-process tensor engine, and a silent no-op would
    read as identical thread-vs-process numbers with no explanation."""
    if mode == "process":
        print(
            "note: --mode process runs the same single-process tensor "
            "engine as thread mode (one process IS the whole agent "
            "population); multi-process execution is not ported to "
            "pydcop_tpu_torch yet",
            file=sys.stderr,
        )
