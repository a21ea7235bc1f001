"""Algorithm plugin registry and definitions.

Equivalent capability to the reference's pydcop/algorithms/__init__.py
(AlgoParameterDef :99, AlgorithmDef :141, check_param_value :383,
prepare_algo_params :446, list_available_algorithms :508,
load_algorithm_module :527).

Module contract — each algorithm module must define:

* ``GRAPH_TYPE: str`` — which computation-graph model it runs on,
* ``algo_params: List[AlgoParameterDef]`` — typed, validated parameters,
* ``build_solver(dcop, computation_graph, algo_def, seed=0) -> Solver`` —
  the tensor solver (replaces the reference's per-node
  ``build_computation``; one solver runs ALL computations as batched
  device arrays),
* optional ``computation_memory(node)`` and
  ``communication_load(node, target)`` — cost callbacks for the
  distribution layer (defaults injected here, like the reference's loader).
"""
from __future__ import annotations

import importlib
import pkgutil
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from pydcop_tpu_torch.utils.serialization import SimpleRepr

DEFAULT_INFINITY = 10000


@dataclass
class AlgoParameterDef:
    """Declaration of one algorithm parameter."""

    name: str
    type: str  # 'str' | 'int' | 'float' | 'bool'
    values: Optional[List[Any]] = None  # allowed values, if enumerated
    default_value: Any = None


class AlgoParameterException(Exception):
    pass


_CASTS = {
    "int": int,
    "float": float,
    "str": str,
    "bool": lambda v: v if isinstance(v, bool) else str(v).lower() in (
        "1", "true", "yes"
    ),
}


def check_param_value(value: Any, param_def: AlgoParameterDef) -> Any:
    """Validate & cast one parameter value against its definition."""
    if value is None:
        return param_def.default_value
    try:
        cast = _CASTS[param_def.type](value)
    except (KeyError, ValueError, TypeError):
        raise AlgoParameterException(
            f"Invalid value {value!r} for parameter {param_def.name} "
            f"(expected {param_def.type})"
        )
    if param_def.values is not None and cast not in param_def.values:
        raise AlgoParameterException(
            f"Value {cast!r} for parameter {param_def.name} not in allowed "
            f"values {param_def.values}"
        )
    return cast


def prepare_algo_params(
    params: Dict[str, Any], params_defs: List[AlgoParameterDef]
) -> Dict[str, Any]:
    """Validate user-given params and fill in defaults."""
    defs = {p.name: p for p in params_defs}
    unknown = set(params) - set(defs)
    if unknown:
        raise AlgoParameterException(
            f"Unknown algorithm parameter(s) {sorted(unknown)}; "
            f"available: {sorted(defs)}"
        )
    return {
        name: check_param_value(params.get(name), p)
        for name, p in defs.items()
    }


class AlgorithmDef(SimpleRepr):
    """An algorithm name + validated parameters + optimization mode.

    >>> from pydcop_tpu_torch.algorithms import AlgorithmDef
    >>> a = AlgorithmDef.build_with_default_params('maxsum', {'damping': 0.7})
    >>> a.algo
    'maxsum'
    >>> a.param_value('damping')
    0.7
    """

    def __init__(self, algo: str, params: Dict[str, Any], mode: str = "min"):
        self._algo = algo
        self._params = dict(params)
        self._mode = mode

    @classmethod
    def build_with_default_params(
        cls,
        algo: str,
        params: Optional[Dict[str, Any]] = None,
        mode: str = "min",
        parameters_definitions: Optional[List[AlgoParameterDef]] = None,
    ) -> "AlgorithmDef":
        if parameters_definitions is None:
            parameters_definitions = load_algorithm_module(algo).algo_params
        return cls(
            algo, prepare_algo_params(params or {}, parameters_definitions),
            mode,
        )

    @property
    def algo(self) -> str:
        return self._algo

    @property
    def mode(self) -> str:
        return self._mode

    @property
    def params(self) -> Dict[str, Any]:
        return dict(self._params)

    def param_value(self, name: str) -> Any:
        return self._params[name]

    def __eq__(self, other):
        return (
            isinstance(other, AlgorithmDef)
            and self._algo == other._algo
            and self._params == other._params
            and self._mode == other._mode
        )

    def __repr__(self):
        return f"AlgorithmDef({self._algo!r}, {self._params}, {self._mode!r})"


# ---------------------------------------------------------------------------
# Module registry
# ---------------------------------------------------------------------------


def list_available_algorithms() -> List[str]:
    import pydcop_tpu_torch.algorithms as pkg

    exclude = {"base", "capture"}
    return sorted(
        m.name
        for m in pkgutil.iter_modules(pkg.__path__)
        if not m.ispkg and m.name not in exclude
        and not m.name.startswith("_")
    )


def _default_computation_memory(node, *args, **kwargs) -> float:
    return 0.0


def _default_communication_load(node, target=None, *args, **kwargs) -> float:
    return 0.0


def load_algorithm_module(algo_name: str):
    """Import an algorithm module, check its contract, inject defaults.

    Only the algorithms ported so far exist here; any other name fails
    with an error that lists them."""
    available = list_available_algorithms()
    if algo_name not in available:
        raise ImportError(
            f"Algorithm {algo_name!r} is not available in the PyTorch "
            f"package; available: {available}"
        )
    module = importlib.import_module(f"pydcop_tpu_torch.algorithms.{algo_name}")
    for attr in ("GRAPH_TYPE", "build_solver"):
        if not hasattr(module, attr):
            raise AttributeError(
                f"Algorithm module {algo_name} must define {attr}"
            )
    if not hasattr(module, "algo_params"):
        module.algo_params = []
    if not hasattr(module, "computation_memory"):
        module.computation_memory = _default_computation_memory
    if not hasattr(module, "communication_load"):
        module.communication_load = _default_communication_load
    return module
