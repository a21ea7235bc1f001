"""Constraints from python expression strings.

Equivalent capability to the reference's ``ExpressionFunction``
(reference: pydcop/utils/expressionfunction.py:37): a cost function defined by
a python expression over variable names, e.g. ``"1 if v1 == v2 else 0"``.
These appear in the YAML problem format as ``intention`` constraints and
variable ``cost_function`` entries.

TPU relevance: expressions are *compile-time only* — the tensorization layer
(`pydcop_tpu_torch.ops.compile`) materializes them over the full domain product into
dense cost tensors once, after which only XLA array ops run.  We therefore
optimise for safe, deterministic evaluation rather than speed.

Safety: the expression is parsed with :mod:`ast` and evaluated with an empty
``__builtins__`` plus an explicit whitelist of math helpers, so YAML files
cannot run arbitrary code (import, attribute access to dunders, etc. are
rejected at parse time).
"""
from __future__ import annotations

import ast
import math
from typing import Callable, Iterable

from pydcop_tpu_torch.utils.serialization import SimpleRepr

_SAFE_NAMES: dict = {
    "abs": abs,
    "min": min,
    "max": max,
    "round": round,
    "len": len,
    "sum": sum,
    "all": all,
    "any": any,
    "int": int,
    "float": float,
    "str": str,
    "bool": bool,
    "pow": pow,
    "divmod": divmod,
    "sorted": sorted,
    "math": math,
    "sqrt": math.sqrt,
    "log": math.log,
    "exp": math.exp,
    "floor": math.floor,
    "ceil": math.ceil,
    "pi": math.pi,
    "inf": math.inf,
    "True": True,
    "False": False,
    "None": None,
}

_FORBIDDEN_NODES = (
    ast.Import,
    ast.ImportFrom,
    ast.Lambda,
    ast.Await,
    ast.Yield,
    ast.YieldFrom,
    ast.Global,
    ast.Nonlocal,
    ast.Delete,
    ast.With,
    ast.Raise,
    ast.Try,
    ast.ClassDef,
    ast.FunctionDef,
    ast.AsyncFunctionDef,
)


class ExpressionFunctionError(Exception):
    pass


def _check_safe(tree: ast.AST, expression: str) -> None:
    for node in ast.walk(tree):
        if isinstance(node, _FORBIDDEN_NODES):
            raise ExpressionFunctionError(
                f"Forbidden construct {type(node).__name__} in expression "
                f"{expression!r}"
            )
        if isinstance(node, ast.Attribute) and node.attr.startswith("__"):
            raise ExpressionFunctionError(
                f"Dunder attribute access forbidden in expression {expression!r}"
            )
        if isinstance(node, ast.Name) and node.id.startswith("__"):
            raise ExpressionFunctionError(
                f"Dunder name forbidden in expression {expression!r}"
            )


class ExpressionFunction(SimpleRepr):
    """A callable built from a python expression string.

    The free variable names of the expression (names that are neither
    whitelisted helpers nor fixed) are exposed as :attr:`variable_names`;
    the function is called with keyword arguments for those names.

    >>> f = ExpressionFunction('v1 + 2 * v2')
    >>> sorted(f.variable_names)
    ['v1', 'v2']
    >>> f(v1=1, v2=3)
    7
    >>> g = f.partial(v2=1)
    >>> g(v1=2)
    4
    """

    def __init__(self, expression: str, **fixed_vars):
        self._expression = expression
        self._fixed_vars = dict(fixed_vars)
        # Multi-line function bodies with a `return` are accepted, as the
        # reference format allows them for intention constraints
        # (reference: pydcop/utils/expressionfunction.py docstring).
        src = expression.strip()
        if "return" in src:
            self._mode = "exec"
            tree = ast.parse(src, mode="exec")
        else:
            self._mode = "eval"
            tree = ast.parse(src, mode="eval")
        _check_safe(tree, expression)
        names = {
            n.id
            for n in ast.walk(tree)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
        }
        assigned = {
            n.id
            for n in ast.walk(tree)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)
        }
        self._all_vars = names - set(_SAFE_NAMES) - assigned
        if self._mode == "exec":
            # wrap statements in a function so `return` works
            fn_src = "def __expr_fn__():\n" + "\n".join(
                "    " + line for line in src.splitlines()
            )
            fn_tree = ast.parse(fn_src, mode="exec")
            self._code = compile(fn_tree, "<expression_function>", "exec")
        else:
            self._code = compile(tree, "<expression_function>", "eval")

    @property
    def expression(self) -> str:
        return self._expression

    @property
    def variable_names(self) -> frozenset:
        """Free variables still needed at call time (fixed vars excluded)."""
        return frozenset(self._all_vars - set(self._fixed_vars))

    def partial(self, **kwargs) -> "ExpressionFunction":
        unknown = set(kwargs) - self._all_vars
        if unknown:
            raise ExpressionFunctionError(
                f"partial() got names {unknown} not used by {self._expression!r}"
            )
        return ExpressionFunction(
            self._expression, **{**self._fixed_vars, **kwargs}
        )

    def __call__(self, *args, **kwargs):
        if args:
            raise ExpressionFunctionError(
                "ExpressionFunction must be called with keyword arguments"
            )
        scope = {**self._fixed_vars, **kwargs}
        missing = self.variable_names - set(scope)
        if missing:
            raise ExpressionFunctionError(
                f"Missing variables {missing} for {self._expression!r}"
            )
        env = {"__builtins__": {}, **_SAFE_NAMES, **scope}
        if self._mode == "eval":
            return eval(self._code, env)  # noqa: S307 - sandboxed, see _check_safe
        exec(self._code, env)  # noqa: S102 - sandboxed, see _check_safe
        return env["__expr_fn__"]()

    def __repr__(self):
        return f"ExpressionFunction({self._expression!r})"

    def __eq__(self, other):
        return (
            isinstance(other, ExpressionFunction)
            and self._expression == other._expression
            and self._fixed_vars == other._fixed_vars
        )

    def __hash__(self):
        return hash((self._expression, tuple(sorted(self._fixed_vars.items()))))

    def _simple_repr(self):
        from pydcop_tpu_torch.utils.serialization import REPR_MODULE, REPR_QUALNAME, simple_repr

        return {
            REPR_MODULE: type(self).__module__,
            REPR_QUALNAME: type(self).__qualname__,
            "expression": self._expression,
            "fixed_vars": simple_repr(self._fixed_vars),
        }

    @classmethod
    def _from_repr(cls, r):
        from pydcop_tpu_torch.utils.serialization import from_repr

        return cls(r["expression"], **from_repr(r.get("fixed_vars", {})))


def expression_function_from_callable(
    fn: Callable, names: Iterable[str]
) -> Callable:
    """Adapter giving a plain callable the ExpressionFunction interface."""
    fn.variable_names = frozenset(names)  # type: ignore[attr-defined]
    return fn
