"""Constraints and the relational algebra kernel.

Equivalent capability to the reference's pydcop/dcop/relations.py
(RelationProtocol :48, ZeroAryRelation :218, UnaryFunctionRelation :270,
UnaryBooleanRelation :380, NAryFunctionRelation :456, AsNAryFunctionRelation
:639, NAryMatrixRelation :672, NeutralRelation :909, ConditionalRelation :948,
constraint_from_str :1275, find_optimum :1348, generate_assignment :1405,
assignment_cost :1460, find_arg_optimal :1535, join :1622, projection :1667).

TPU-first redesign: where the reference's ``join``/``projection`` iterate in
python over the full cross-product of assignments (its hottest loop, driving
DPOP's UTIL phase), here every constraint can materialize to a dense numpy
cost tensor over domain-index space (:meth:`Constraint.to_tensor`), and the
algebra is **broadcast arithmetic + axis reductions**:

* ``join(u, v)``  = ``u[..., None] + v`` aligned over the union of dimensions,
* ``projection(r, var)`` = ``min``/``max`` over that variable's axis.

The same formulation runs under numpy on the host; the device kernels of
this package consume the dense tensors through ``pydcop_tpu_torch.ops.compile``.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from pydcop_tpu_torch.dcop.objects import Domain, Variable
from pydcop_tpu_torch.utils.expressions import ExpressionFunction
from pydcop_tpu_torch.utils.serialization import SimpleRepr, simple_repr, from_repr, \
    REPR_MODULE, REPR_QUALNAME

DEFAULT_TYPE = np.float32


class Constraint(SimpleRepr):
    """Abstract constraint: a cost function over a tuple of variables.

    Immutable; all mutating-looking operations return new objects.
    """

    def __init__(self, name: str, variables: Sequence[Variable]):
        self._name = name
        self._variables = list(variables)

    @property
    def name(self) -> str:
        return self._name

    @property
    def dimensions(self) -> List[Variable]:
        return list(self._variables)

    @property
    def scope_names(self) -> List[str]:
        return [v.name for v in self._variables]

    @property
    def arity(self) -> int:
        return len(self._variables)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(len(v.domain) for v in self._variables)

    # -- evaluation ---------------------------------------------------------

    def __call__(self, *args, **kwargs):
        if args and kwargs:
            raise ValueError("Use either positional or keyword arguments")
        if args:
            if len(args) != self.arity:
                raise ValueError(
                    f"{self._name} expects {self.arity} values, got {len(args)}"
                )
            kwargs = {v.name: a for v, a in zip(self._variables, args)}
        return self.get_value_for_assignment(kwargs)

    def get_value_for_assignment(self, assignment: Union[Dict, List]) -> float:
        if isinstance(assignment, list):
            assignment = {v.name: a for v, a in zip(self._variables, assignment)}
        return self._value(assignment)

    def _value(self, assignment: Dict) -> float:
        raise NotImplementedError

    # -- algebra ------------------------------------------------------------

    def slice(self, partial_assignment: Dict[str, Any]) -> "Constraint":
        """Fix some variables, producing a constraint over the rest."""
        fixed = {
            k: v for k, v in partial_assignment.items() if k in self.scope_names
        }
        remaining = [v for v in self._variables if v.name not in fixed]
        if not fixed:
            return self
        return SlicedRelation(self, fixed, remaining)

    def to_tensor(self) -> np.ndarray:
        """Materialize as a dense cost tensor over domain-index space.

        Axis *k* corresponds to ``self.dimensions[k]``, indexed in its
        domain's order.  This is the compilation step that turns arbitrary
        python cost functions into XLA-ready arrays (reference twin:
        NAryMatrixRelation.from_func_relation, relations.py:861).
        """
        shape = self.shape
        t = np.empty(shape, dtype=DEFAULT_TYPE)
        domains = [v.domain for v in self._variables]
        names = self.scope_names
        for idx in np.ndindex(*shape) if shape else [()]:
            assignment = {n: d[i] for n, d, i in zip(names, domains, idx)}
            t[idx] = self._value(assignment)
        return t

    def set_value_for_assignment(
        self, assignment: Dict[str, Any], value: float
    ) -> "NAryMatrixRelation":
        rel = NAryMatrixRelation.from_constraint(self)
        return rel.set_value_for_assignment(assignment, value)

    def __eq__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        return self._name == other._name and self.scope_names == other.scope_names

    def __hash__(self):
        return hash((type(self).__name__, self._name, tuple(self.scope_names)))

    def __repr__(self):
        return f"{type(self).__name__}({self._name!r}, {self.scope_names})"


# Reference exposes `RelationProtocol` and `Constraint` as the same thing
# (relations.py:186)
RelationProtocol = Constraint


class ZeroAryRelation(Constraint):
    """A constant-cost relation over no variables (relations.py:218)."""

    def __init__(self, name: str, value: float):
        super().__init__(name, [])
        self._rel_value = value

    def _value(self, assignment: Dict) -> float:
        return self._rel_value

    def _simple_repr(self):
        return {REPR_MODULE: type(self).__module__,
                REPR_QUALNAME: type(self).__qualname__,
                "name": self._name, "value": self._rel_value}

    @classmethod
    def _from_repr(cls, r):
        return cls(r["name"], r["value"])


class UnaryFunctionRelation(Constraint):
    """Cost from a single-argument function of one variable (relations.py:270)."""

    def __init__(self, name: str, variable: Variable, rel_function: Callable):
        super().__init__(name, [variable])
        self._rel_function = rel_function

    @property
    def expression(self):
        if isinstance(self._rel_function, ExpressionFunction):
            return self._rel_function.expression
        return None

    def _value(self, assignment: Dict) -> float:
        val = assignment[self._variables[0].name]
        if isinstance(self._rel_function, ExpressionFunction):
            return self._rel_function(**{self._variables[0].name: val})
        return self._rel_function(val)


class UnaryBooleanRelation(Constraint):
    """Hard unary relation: cost 0 if value is truthy, else infinity
    (relations.py:380)."""

    def __init__(self, name: str, variable: Variable):
        super().__init__(name, [variable])

    def _value(self, assignment: Dict) -> float:
        return 0 if assignment[self._variables[0].name] else np.inf


class NAryFunctionRelation(Constraint):
    """Cost from an arbitrary function over n variables (relations.py:456).

    ``f`` may be an :class:`ExpressionFunction` (called with variable names as
    keywords) or a plain callable (called positionally in dimension order,
    unless ``takes_kwargs``).
    """

    def __init__(
        self,
        f: Callable,
        variables: Sequence[Variable],
        name: Optional[str] = None,
        takes_kwargs: Optional[bool] = None,
    ):
        super().__init__(name or getattr(f, "__name__", "relation"), variables)
        self._f = f
        if takes_kwargs is None:
            takes_kwargs = isinstance(f, ExpressionFunction)
        self._takes_kwargs = takes_kwargs

    @property
    def function(self):
        return self._f

    @property
    def expression(self):
        if isinstance(self._f, ExpressionFunction):
            return self._f.expression
        return None

    def _value(self, assignment: Dict) -> float:
        if self._takes_kwargs:
            return self._f(**{n: assignment[n] for n in self.scope_names})
        return self._f(*[assignment[n] for n in self.scope_names])

    def _simple_repr(self):
        if not isinstance(self._f, ExpressionFunction):
            raise ValueError(
                "Only expression-based NAryFunctionRelation are serializable"
            )
        return {
            REPR_MODULE: type(self).__module__,
            REPR_QUALNAME: type(self).__qualname__,
            "name": self._name,
            "f": simple_repr(self._f),
            "variables": simple_repr(self._variables),
        }

    @classmethod
    def _from_repr(cls, r):
        return cls(from_repr(r["f"]), from_repr(r["variables"]), r["name"])


def AsNAryFunctionRelation(*variables: Variable):
    """Decorator building an NAryFunctionRelation from a python function
    (relations.py:639).

    >>> from pydcop_tpu_torch.dcop.objects import Domain, Variable
    >>> d = Domain('d', 'd', [0, 1])
    >>> x, y = Variable('x', d), Variable('y', d)
    >>> @AsNAryFunctionRelation(x, y)
    ... def my_rel(x, y):
    ...     return x + y
    >>> my_rel(1, 1)
    2
    """

    def decorate(f):
        return NAryFunctionRelation(f, list(variables), f.__name__)

    return decorate


class NAryMatrixRelation(Constraint):
    """Cost tensor over the cartesian product of variable domains —
    the canonical compiled form of any constraint (relations.py:672).

    The backing array is a numpy tensor whose axis *k* is indexed by
    ``dimensions[k]``'s domain order.

    >>> from pydcop_tpu_torch.dcop.objects import Domain, Variable
    >>> d = Domain('d', 'd', ['a', 'b'])
    >>> x, y = Variable('x', d), Variable('y', d)
    >>> r = NAryMatrixRelation([x, y], [[1, 2], [3, 4]], name='r')
    >>> r(x='b', y='a')
    3.0
    >>> r.slice({'x': 'a'})(y='b')
    2.0
    """

    def __init__(
        self,
        variables: Sequence[Variable],
        matrix: Optional[np.ndarray] = None,
        name: str = "",
    ):
        super().__init__(name, variables)
        shape = self.shape
        if matrix is None:
            self._m = np.zeros(shape, dtype=DEFAULT_TYPE)
        else:
            self._m = np.asarray(matrix, dtype=DEFAULT_TYPE).reshape(shape)

    @property
    def matrix(self) -> np.ndarray:
        return self._m

    @classmethod
    def from_constraint(cls, c: Constraint) -> "NAryMatrixRelation":
        if isinstance(c, NAryMatrixRelation):
            return c
        return cls(c.dimensions, c.to_tensor(), c.name)

    # reference-parity alias (relations.py:861)
    from_func_relation = from_constraint

    def to_tensor(self) -> np.ndarray:
        return self._m

    def _index(self, assignment: Dict) -> Tuple[int, ...]:
        return tuple(
            v.domain.index(assignment[v.name]) for v in self._variables
        )

    def _value(self, assignment: Dict) -> float:
        return float(self._m[self._index(assignment)])

    def slice(self, partial_assignment: Dict[str, Any]) -> "NAryMatrixRelation":
        fixed = {
            k: v for k, v in partial_assignment.items() if k in self.scope_names
        }
        if not fixed:
            return self
        indexer: List[Any] = []
        remaining: List[Variable] = []
        for v in self._variables:
            if v.name in fixed:
                indexer.append(v.domain.index(fixed[v.name]))
            else:
                indexer.append(slice(None))
                remaining.append(v)
        return NAryMatrixRelation(remaining, self._m[tuple(indexer)], self._name)

    def set_value_for_assignment(
        self, assignment: Dict[str, Any], value: float
    ) -> "NAryMatrixRelation":
        m = self._m.copy()
        m[self._index(assignment)] = value
        return NAryMatrixRelation(self._variables, m, self._name)

    def __eq__(self, other):
        if not isinstance(other, NAryMatrixRelation):
            return NotImplemented
        return (
            self._name == other._name
            and self.scope_names == other.scope_names
            and np.array_equal(self._m, other._m)
        )

    def __hash__(self):
        return hash((self._name, tuple(self.scope_names)))

    def _simple_repr(self):
        return {
            REPR_MODULE: type(self).__module__,
            REPR_QUALNAME: type(self).__qualname__,
            "name": self._name,
            "variables": simple_repr(self._variables),
            "matrix": self._m.tolist(),
        }

    @classmethod
    def _from_repr(cls, r):
        return cls(from_repr(r["variables"]), np.array(r["matrix"]), r["name"])


class SlicedRelation(Constraint):
    """Generic lazy slice of any constraint (used when the base is not a
    matrix; matrix relations slice natively)."""

    def __init__(self, base: Constraint, fixed: Dict[str, Any],
                 remaining: Sequence[Variable]):
        super().__init__(base.name, remaining)
        self._base = base
        self._fixed = dict(fixed)

    def _value(self, assignment: Dict) -> float:
        return self._base.get_value_for_assignment({**self._fixed, **assignment})


class NeutralRelation(Constraint):
    """Always-zero relation over given variables (relations.py:909)."""

    def __init__(self, variables: Sequence[Variable], name: str = "neutral"):
        super().__init__(name, variables)

    def _value(self, assignment: Dict) -> float:
        return 0


class ConditionalRelation(Constraint):
    """Cost of ``relation_if_true`` when the (boolean) condition relation is
    truthy, else 0 (relations.py:948)."""

    def __init__(
        self,
        condition: Constraint,
        relation_if_true: Constraint,
        name: str = "conditional",
        return_value_if_false: float = 0,
    ):
        cond_vars = condition.dimensions
        rel_vars = [
            v for v in relation_if_true.dimensions if v not in cond_vars
        ]
        super().__init__(name, cond_vars + rel_vars)
        self._condition = condition
        self._relation = relation_if_true
        self._if_false = return_value_if_false

    def _value(self, assignment: Dict) -> float:
        cond = self._condition.get_value_for_assignment(
            {n: assignment[n] for n in self._condition.scope_names}
        )
        if cond:
            return self._relation.get_value_for_assignment(
                {n: assignment[n] for n in self._relation.scope_names}
            )
        return self._if_false


# ---------------------------------------------------------------------------
# Constructors & helpers
# ---------------------------------------------------------------------------


def constraint_from_str(
    name: str, expression: str, all_variables: Iterable[Variable]
) -> Constraint:
    """Build a constraint from a python expression string, binding the
    expression's free names to the given variables (relations.py:1275).

    >>> from pydcop_tpu_torch.dcop.objects import Domain, Variable
    >>> d = Domain('d', 'vals', [0, 1, 2])
    >>> x, y = Variable('x', d), Variable('y', d)
    >>> c = constraint_from_str('c', '10 if x == y else abs(x - y)', [x, y])
    >>> c(x=1, y=1)
    10
    >>> c(x=0, y=2)
    2
    >>> sorted(c.scope_names)
    ['x', 'y']
    """
    f = ExpressionFunction(expression)
    var_map = {v.name: v for v in all_variables}
    scope = []
    for vname in sorted(f.variable_names):
        if vname not in var_map:
            raise ValueError(
                f"Unknown variable {vname!r} in constraint {name}: {expression!r}"
            )
        scope.append(var_map[vname])
    if len(scope) == 1:
        return UnaryFunctionRelation(name, scope[0], f)
    return NAryFunctionRelation(f, scope, name)


def relation_from_str(name, expression, all_variables):
    return constraint_from_str(name, expression, all_variables)


def assignment_matrix(variables: Sequence[Variable], default_value: float = 0
                      ) -> np.ndarray:
    """Dense tensor over the variables' domain product, filled with default."""
    shape = tuple(len(v.domain) for v in variables)
    return np.full(shape, default_value, dtype=DEFAULT_TYPE)


def generate_assignment(variables: Sequence[Variable]):
    """Yield all assignments as value lists, last variable fastest
    (relations.py:1405)."""
    domains = [list(v.domain) for v in variables]
    for combo in itertools.product(*domains):
        yield list(combo)


def generate_assignment_as_dict(variables: Sequence[Variable]):
    """Yield all assignments as dicts (relations.py:1433)."""
    names = [v.name for v in variables]
    domains = [list(v.domain) for v in variables]
    for combo in itertools.product(*domains):
        yield dict(zip(names, combo))


def assignment_cost(
    assignment: Dict[str, Any],
    constraints: Iterable[Constraint],
    consider_variable_cost: bool = False,
    variables: Iterable[Variable] = (),
) -> float:
    """Total cost of an assignment over the given constraints
    (relations.py:1460).

    >>> from pydcop_tpu_torch.dcop.objects import Domain, Variable
    >>> d = Domain('d', 'vals', [0, 1])
    >>> x, y = Variable('x', d), Variable('y', d)
    >>> c1 = constraint_from_str('c1', 'x + y', [x, y])
    >>> c2 = constraint_from_str('c2', '5 * x', [x])
    >>> assignment_cost({'x': 1, 'y': 0}, [c1, c2])
    6.0
    """
    cost = 0.0
    for c in constraints:
        cost += c.get_value_for_assignment(
            {n: assignment[n] for n in c.scope_names}
        )
    if consider_variable_cost:
        for v in variables:
            if v.name in assignment and v.has_cost:
                cost += v.cost_for_val(assignment[v.name])
    return cost


def filter_assignment_dict(assignment: Dict, target_vars: Iterable[Variable]
                           ) -> Dict:
    """Keep only entries whose key names one of target_vars
    (reference: pydcop/dcop/relations.py filter_assignment_dict)."""
    names = {v.name for v in target_vars}
    return {k: v for k, v in assignment.items() if k in names}


def find_optimum(constraint: Constraint, mode: str) -> float:
    """Best achievable cost of a constraint: min or max over its tensor
    (relations.py:1348)."""
    if mode not in ("min", "max"):
        raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
    t = constraint.to_tensor() if not isinstance(constraint, NAryMatrixRelation) \
        else constraint.matrix
    return float(t.min() if mode == "min" else t.max())


def optimal_cost_value(variable: Variable, mode: str = "min"):
    """Best (value, cost) for a variable's own cost function."""
    costs = variable.cost_vector()
    idx = int(np.argmin(costs) if mode == "min" else np.argmax(costs))
    return variable.domain[idx], float(costs[idx])


def find_arg_optimal(
    variable: Variable, relation: Constraint, mode: str = "min"
) -> Tuple[List[Any], float]:
    """All optimal values of `variable` for a unary relation over it
    (relations.py:1535).  Returns (list_of_values, optimal_cost).

    >>> from pydcop_tpu_torch.dcop.objects import Domain, Variable
    >>> d = Domain('d', 'vals', ['a', 'b', 'c'])
    >>> v = Variable('v', d)
    >>> r = constraint_from_str('r', "{'a': 3, 'b': 1, 'c': 1}[v]", [v])
    >>> find_arg_optimal(v, r, mode='min')
    (['b', 'c'], 1.0)
    """
    if relation.arity != 1 or relation.dimensions[0].name != variable.name:
        raise ValueError(
            f"find_arg_optimal needs a unary relation on {variable.name}, "
            f"got {relation.scope_names}"
        )
    t = relation.to_tensor() if not isinstance(relation, NAryMatrixRelation) \
        else relation.matrix
    opt = t.min() if mode == "min" else t.max()
    values = [variable.domain[i] for i in np.flatnonzero(t == opt)]
    return values, float(opt)


def find_optimal(
    variable: Variable, assignment: Dict, constraints: Iterable[Constraint],
    mode: str = "min",
) -> Tuple[List[Any], float]:
    """Optimal values for one variable given fixed neighbors
    (relations.py:1575)."""
    costs = np.zeros(len(variable.domain), dtype=np.float64)
    for i, val in enumerate(variable.domain):
        full = {**assignment, variable.name: val}
        costs[i] = sum(
            c.get_value_for_assignment({n: full[n] for n in c.scope_names})
            for c in constraints
        )
    opt = costs.min() if mode == "min" else costs.max()
    values = [variable.domain[i] for i in np.flatnonzero(costs == opt)]
    return values, float(opt)


# ---------------------------------------------------------------------------
# The algebra: join & projection (broadcast formulation)
# ---------------------------------------------------------------------------


def _align_tensor(
    t: np.ndarray, dims: List[Variable], out_dims: List[Variable]
) -> np.ndarray:
    """Transpose/expand t (over `dims`) to broadcast over `out_dims`."""
    pos = {v.name: i for i, v in enumerate(dims)}
    # axes of out_dims present in dims, in out order
    perm = [pos[v.name] for v in out_dims if v.name in pos]
    t = np.transpose(t, perm) if perm else t
    shape = [len(v.domain) if v.name in pos else 1 for v in out_dims]
    return t.reshape(shape)


def join(u: Constraint, v: Constraint) -> NAryMatrixRelation:
    """Sum-combine two relations over the union of their dimensions
    (relations.py:1622).

    Broadcast formulation: align both cost tensors on the union axis order
    and add — one XLA-fusable op instead of the reference's python loop over
    every assignment.

    >>> from pydcop_tpu_torch.dcop.objects import Domain, Variable
    >>> d = Domain('d', 'd', [0, 1])
    >>> x, y, z = (Variable(n, d) for n in 'xyz')
    >>> r1 = NAryMatrixRelation([x, y], [[0, 1], [2, 3]], 'r1')
    >>> r2 = NAryMatrixRelation([y, z], [[10, 20], [30, 40]], 'r2')
    >>> j = join(r1, r2)
    >>> [v.name for v in j.dimensions]
    ['x', 'y', 'z']
    >>> j(x=1, y=0, z=1)
    22.0
    """
    u_dims = u.dimensions
    u_names = {d.name for d in u_dims}
    out_dims = u_dims + [d for d in v.dimensions if d.name not in u_names]
    ut = u.matrix if isinstance(u, NAryMatrixRelation) else u.to_tensor()
    vt = v.matrix if isinstance(v, NAryMatrixRelation) else v.to_tensor()
    m = _align_tensor(ut, u_dims, out_dims) + _align_tensor(
        vt, v.dimensions, out_dims
    )
    return NAryMatrixRelation(out_dims, m, f"joined_{u.name}_{v.name}")


def projection(
    rel: Constraint, variable: Variable, mode: str = "min"
) -> NAryMatrixRelation:
    """Eliminate one variable by optimizing it out (relations.py:1667).

    >>> from pydcop_tpu_torch.dcop.objects import Domain, Variable
    >>> d = Domain('d', 'd', [0, 1])
    >>> x, y = Variable('x', d), Variable('y', d)
    >>> r = NAryMatrixRelation([x, y], [[5, 1], [2, 8]], 'r')
    >>> p = projection(r, y, 'min')
    >>> p(x=0), p(x=1)
    (1.0, 2.0)
    """
    names = rel.scope_names
    if variable.name not in names:
        raise ValueError(
            f"Cannot project {variable.name} out of {rel.name}({names})"
        )
    axis = names.index(variable.name)
    t = rel.matrix if isinstance(rel, NAryMatrixRelation) else rel.to_tensor()
    m = t.min(axis=axis) if mode == "min" else t.max(axis=axis)
    out_dims = [v for v in rel.dimensions if v.name != variable.name]
    return NAryMatrixRelation(out_dims, m, rel.name)


def find_dependent_relations(
    variable: Variable, relations: Iterable[Constraint]
) -> List[Constraint]:
    return [r for r in relations if variable.name in r.scope_names]


def add_var_to_rel(
    name: str, rel: Constraint, variable: Variable, f: Callable
) -> Constraint:
    """Extend a relation with one more variable, combining costs with
    ``f(old_cost, var_value)`` (reference: relations.py add_var_to_rel)."""

    def extended(**kwargs):
        val = kwargs.pop(variable.name)
        base = rel.get_value_for_assignment(
            {n: kwargs[n] for n in rel.scope_names}
        )
        return f(base, val)

    return NAryFunctionRelation(
        extended, rel.dimensions + [variable], name, takes_kwargs=True
    )
