"""Shared CLI helpers: algo-param parsing, JSON output.

Equivalent capability to the reference's pydcop/commands/_utils.py +
the NumpyEncoder/_results plumbing in pydcop/commands/solve.py:580-627.
"""
from __future__ import annotations

import json
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
