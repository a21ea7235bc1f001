"""Problem-model objects: domains, variables, agent definitions.

Equivalent capability to the reference's pydcop/dcop/objects.py
(Domain :46, Variable :175, BinaryVariable :335, VariableWithCostDict :410,
VariableWithCostFunc :464, VariableNoisyCostFunc :547, ExternalVariable :618,
AgentDef :669, create_variables :258, create_agents :879).

TPU-first design notes:

* A :class:`Domain` knows its integer index space — every variable value is
  ultimately an index into a padded value axis of a cost tensor; helpers
  ``index``/``to_value`` are the only bridge between python values and device
  arrays.
* Variable costs expose :meth:`Variable.cost_vector` returning a dense
  per-value numpy vector, ready to be stacked into the ``[V, D]`` unary-cost
  array consumed by the kernels (`pydcop_tpu_torch.ops.compile`).
* Noise for ``VariableNoisyCostFunc`` is drawn from a per-variable-name
  deterministic PRNG so runs are reproducible on device and host
  (documented deviation: the reference seeds from the global RNG).
"""
from __future__ import annotations

import hashlib
from itertools import product
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

from pydcop_tpu_torch.utils.expressions import ExpressionFunction
from pydcop_tpu_torch.utils.serialization import SimpleRepr


class Domain(SimpleRepr):
    """A named, ordered, finite set of values.

    >>> d = Domain('colors', 'color', ['R', 'G', 'B'])
    >>> len(d)
    3
    >>> d.index('G')
    1
    >>> d[2]
    'B'
    >>> 'R' in d
    True
    """

    def __init__(self, name: str, domain_type: str, values: Iterable):
        self._name = name
        self._domain_type = domain_type
        self._values = tuple(values)
        self._index = {v: i for i, v in enumerate(self._values)}

    @property
    def name(self) -> str:
        return self._name

    @property
    def type(self) -> str:
        return self._domain_type

    @property
    def values(self) -> Tuple:
        return self._values

    def index(self, value) -> int:
        try:
            return self._index[value]
        except KeyError:
            raise ValueError(f"{value!r} is not in domain {self._name}")

    def to_domain_value(self, token: str):
        """Map a string token (e.g. from YAML/CLI) to the domain value.

        Accepts the exact value, or its string form (so '1' matches int 1).
        """
        if token in self._index:
            return token
        for v in self._values:
            if str(v) == str(token):
                return v
        raise ValueError(f"{token!r} does not match any value of domain {self._name}")

    def __len__(self):
        return len(self._values)

    def __iter__(self):
        return iter(self._values)

    def __getitem__(self, i):
        return self._values[i]

    def __contains__(self, v):
        return v in self._index

    def __eq__(self, other):
        return (
            isinstance(other, Domain)
            and self._name == other._name
            and self._values == other._values
            and self._domain_type == other._domain_type
        )

    def __hash__(self):
        return hash((self._name, self._domain_type, self._values))

    def __repr__(self):
        return f"Domain({self._name!r}, {self._domain_type!r}, {list(self._values)!r})"


# Reference alias (pydcop/dcop/objects.py keeps VariableDomain as legacy name)
VariableDomain = Domain

binary_domain = Domain("binary", "binary", [0, 1])


class Variable(SimpleRepr):
    """A decision variable over a finite domain.

    >>> v = Variable('v1', Domain('d', 'd', [0, 1, 2]))
    >>> v.name
    'v1'
    >>> v.cost_for_val(2)
    0
    """

    has_cost = False

    def __init__(self, name: str, domain: Domain, initial_value=None):
        self._name = name
        self._domain = domain
        if initial_value is not None and initial_value not in domain:
            raise ValueError(
                f"initial value {initial_value!r} not in domain {domain.name}"
            )
        self._initial_value = initial_value

    @property
    def name(self) -> str:
        return self._name

    @property
    def domain(self) -> Domain:
        return self._domain

    @property
    def initial_value(self):
        return self._initial_value

    def cost_for_val(self, val) -> float:
        return 0

    def cost_vector(self) -> np.ndarray:
        """Dense per-value cost vector (aligned with domain order)."""
        return np.array([self.cost_for_val(v) for v in self._domain], dtype=np.float32)

    def clone(self, new_name: Optional[str] = None) -> "Variable":
        return Variable(new_name or self._name, self._domain, self._initial_value)

    def __eq__(self, other):
        return (
            type(other) is type(self)
            and self._name == other.name
            and self._domain == other.domain
        )

    def __hash__(self):
        return hash((type(self).__name__, self._name, self._domain))

    def __repr__(self):
        return f"{type(self).__name__}({self._name!r}, {self._domain.name})"


class BinaryVariable(Variable):
    """A 0/1 variable (used by the repair-DCOP builders, reference
    pydcop/dcop/objects.py:335)."""

    def __init__(self, name: str, initial_value=0):
        super().__init__(name, binary_domain, initial_value)

    def clone(self, new_name: Optional[str] = None) -> "BinaryVariable":
        return BinaryVariable(new_name or self._name, self._initial_value)


class VariableWithCostDict(Variable):
    """Variable with an explicit per-value cost table."""

    has_cost = True

    def __init__(
        self,
        name: str,
        domain: Domain,
        costs: Dict[Any, float],
        initial_value=None,
    ):
        super().__init__(name, domain, initial_value)
        self._costs = dict(costs)

    @property
    def costs(self) -> Dict[Any, float]:
        return dict(self._costs)

    def cost_for_val(self, val) -> float:
        return self._costs.get(val, 0)

    def clone(self, new_name=None):
        return VariableWithCostDict(
            new_name or self._name, self._domain, self._costs, self._initial_value
        )


class VariableWithCostFunc(Variable):
    """Variable whose per-value cost comes from a function of the value."""

    has_cost = True

    def __init__(
        self,
        name: str,
        domain: Domain,
        cost_func: Union[ExpressionFunction, Callable],
        initial_value=None,
    ):
        super().__init__(name, domain, initial_value)
        if isinstance(cost_func, ExpressionFunction):
            vnames = cost_func.variable_names
            if len(vnames) != 1 or name not in vnames:
                raise ValueError(
                    f"cost function for {name} must depend exactly on {name}, "
                    f"got {set(vnames)}"
                )
        self._cost_func = cost_func

    @property
    def cost_func(self):
        return self._cost_func

    def cost_for_val(self, val) -> float:
        if isinstance(self._cost_func, ExpressionFunction):
            return self._cost_func(**{self._name: val})
        return self._cost_func(val)

    def clone(self, new_name=None):
        if new_name and isinstance(self._cost_func, ExpressionFunction):
            raise ValueError(
                "Cannot rename a variable with an expression cost function: "
                "the expression refers to the old name"
            )
        return VariableWithCostFunc(
            new_name or self._name, self._domain, self._cost_func, self._initial_value
        )


def _stable_seed(*parts: str) -> int:
    h = hashlib.sha256("/".join(parts).encode()).digest()
    return int.from_bytes(h[:4], "little")


class VariableNoisyCostFunc(VariableWithCostFunc):
    """Cost function plus small per-value random noise.

    The reference adds uniform noise so MaxSum can break ties between
    symmetric solutions (pydcop/dcop/objects.py:547, used at maxsum.py:449).
    Noise here is deterministic per (variable name, value index), drawn once
    at construction from a name-seeded PRNG — reproducibility matters more
    than entropy for a solver, and it keeps the compiled cost tensors stable
    across processes/hosts.
    """

    has_cost = True

    def __init__(
        self,
        name: str,
        domain: Domain,
        cost_func,
        initial_value=None,
        noise_level: float = 0.02,
    ):
        super().__init__(name, domain, cost_func, initial_value)
        self._noise_level = noise_level
        rng = np.random.default_rng(_stable_seed("noise", name))
        self._noise = rng.uniform(0, noise_level, size=len(domain))

    @property
    def noise_level(self) -> float:
        return self._noise_level

    def cost_for_val(self, val) -> float:
        base = super().cost_for_val(val)
        return base + float(self._noise[self._domain.index(val)])

    def clone(self, new_name=None):
        if new_name and isinstance(self._cost_func, ExpressionFunction):
            raise ValueError("Cannot rename: expression refers to the old name")
        return VariableNoisyCostFunc(
            new_name or self._name,
            self._domain,
            self._cost_func,
            self._initial_value,
            self._noise_level,
        )


class ExternalVariable(Variable):
    """A read-only 'sensor' variable whose value is set from outside the
    optimization (reference: pydcop/dcop/objects.py:618).  Change callbacks
    let dynamic algorithms (maxsum_dynamic) react to new readings."""

    def __init__(self, name: str, domain: Domain, value=None):
        super().__init__(name, domain, value)
        self._value = value if value is not None else domain[0]
        self._callbacks: List[Callable] = []

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, val):
        if val == self._value:
            return
        if val not in self._domain:
            raise ValueError(f"{val!r} not in domain {self._domain.name}")
        self._value = val
        for cb in self._callbacks:
            cb(val)

    def subscribe(self, callback: Callable):
        self._callbacks.append(callback)

    def unsubscribe(self, callback: Callable):
        self._callbacks.remove(callback)

    def clone(self, new_name=None):
        return ExternalVariable(new_name or self._name, self._domain, self._value)


def create_variables(
    name_prefix: str,
    indexes: Union[str, Tuple, Iterable],
    domain: Domain,
    separator: str = "_",
) -> Dict[Union[str, Tuple[str, ...]], Variable]:
    """Batch-create variables over an index space.

    Mirrors the reference helper (pydcop/dcop/objects.py:258):

    * an iterable of names: ``create_variables('x_', ['a1', 'a2'], d)``
      → keys ``'x_a1', 'x_a2'``
    * a tuple of iterables: cartesian product, keys are tuples.

    >>> d = Domain('d', 'd', [0, 1])
    >>> vs = create_variables('v', ['1', '2'], d)
    >>> sorted(vs)
    ['v1', 'v2']
    >>> vs2 = create_variables('m', (['x', 'y'], ['1', '2']), d)
    >>> vs2[('x', '1')].name
    'mx_1'
    """
    variables: Dict = {}
    if isinstance(indexes, tuple):
        for combi in product(*indexes):
            name = name_prefix + separator.join(str(c) for c in combi)
            variables[tuple(str(c) for c in combi)] = Variable(name, domain)
    elif hasattr(indexes, "__iter__"):
        for i in indexes:
            name = name_prefix + str(i)
            variables[name] = Variable(name, domain)
    else:
        raise TypeError(f"indexes must be an iterable or tuple, got {indexes!r}")
    return variables


class AgentDef(SimpleRepr):
    """Agent metadata: capacity, hosting costs, route costs, extra attributes.

    Reference: pydcop/dcop/objects.py:669 (hosting_cost :739, route :788).

    >>> a = AgentDef('a1', capacity=100, default_hosting_cost=1,
    ...              hosting_costs={'v1': 5}, routes={'a2': 2})
    >>> a.hosting_cost('v1'), a.hosting_cost('v2')
    (5, 1)
    >>> a.route('a2'), a.route('a3'), a.route('a1')
    (2, 1, 0)
    """

    def __init__(
        self,
        name: str,
        capacity: float = 100,
        default_hosting_cost: float = 0,
        hosting_costs: Optional[Dict[str, float]] = None,
        default_route: float = 1,
        routes: Optional[Dict[str, float]] = None,
        **kwargs,
    ):
        self._name = name
        self._capacity = capacity
        self._default_hosting_cost = default_hosting_cost
        self._hosting_costs = dict(hosting_costs) if hosting_costs else {}
        self._default_route = default_route
        self._routes = dict(routes) if routes else {}
        self._extra_attrs = dict(kwargs)

    @property
    def name(self) -> str:
        return self._name

    @property
    def capacity(self) -> float:
        return self._capacity

    @property
    def default_hosting_cost(self) -> float:
        return self._default_hosting_cost

    @property
    def hosting_costs(self) -> Dict[str, float]:
        return dict(self._hosting_costs)

    @property
    def default_route(self) -> float:
        return self._default_route

    @property
    def routes(self) -> Dict[str, float]:
        return dict(self._routes)

    @property
    def extra_attrs(self) -> Dict[str, Any]:
        return dict(self._extra_attrs)

    def hosting_cost(self, computation_name: str) -> float:
        return self._hosting_costs.get(computation_name, self._default_hosting_cost)

    def route(self, other_agent: str) -> float:
        if other_agent == self._name:
            return 0
        return self._routes.get(other_agent, self._default_route)

    def __getattr__(self, item):
        # extra attributes (e.g. 'preferences') act like plain attributes,
        # as in the reference
        try:
            return self.__dict__["_extra_attrs"][item]
        except KeyError:
            raise AttributeError(f"AgentDef has no attribute {item!r}")

    def __eq__(self, other):
        return (
            isinstance(other, AgentDef)
            and self._name == other._name
            and self._capacity == other._capacity
            and self._hosting_costs == other._hosting_costs
            and self._routes == other._routes
        )

    def __hash__(self):
        return hash(("AgentDef", self._name, self._capacity))

    def __repr__(self):
        return f"AgentDef({self._name!r}, capacity={self._capacity})"

    def _simple_repr(self):
        from pydcop_tpu_torch.utils.serialization import (
            REPR_MODULE,
            REPR_QUALNAME,
            simple_repr,
        )

        r = {
            REPR_MODULE: type(self).__module__,
            REPR_QUALNAME: type(self).__qualname__,
            "name": self._name,
            "capacity": self._capacity,
            "default_hosting_cost": self._default_hosting_cost,
            "hosting_costs": simple_repr(self._hosting_costs),
            "default_route": self._default_route,
            "routes": simple_repr(self._routes),
        }
        r.update(simple_repr(self._extra_attrs))
        return r

    @classmethod
    def _from_repr(cls, r):
        from pydcop_tpu_torch.utils.serialization import (
            REPR_MODULE,
            REPR_QUALNAME,
            from_repr,
        )

        kwargs = {
            k: from_repr(v)
            for k, v in r.items()
            if k not in (REPR_MODULE, REPR_QUALNAME)
        }
        name = kwargs.pop("name")
        return cls(name, **kwargs)


def create_agents(
    name_prefix: str,
    indexes: Union[Tuple, Iterable],
    default_hosting_cost: float = 0,
    hosting_costs: Optional[Dict] = None,
    default_route: float = 1,
    routes: Optional[Dict] = None,
    separator: str = "_",
    **kwargs,
) -> Dict[Union[str, Tuple[str, ...]], AgentDef]:
    """Batch-create agents (reference: pydcop/dcop/objects.py:879)."""
    agents: Dict = {}
    hosting_costs = hosting_costs or {}
    routes = routes or {}

    def _mk(key, name):
        agents[key] = AgentDef(
            name,
            default_hosting_cost=default_hosting_cost,
            hosting_costs=hosting_costs.get(name, None),
            default_route=default_route,
            routes=routes.get(name, None),
            **kwargs,
        )

    if isinstance(indexes, tuple):
        for combi in product(*indexes):
            name = name_prefix + separator.join(str(c) for c in combi)
            _mk(tuple(str(c) for c in combi), name)
    elif hasattr(indexes, "__iter__"):
        for i in indexes:
            name = name_prefix + str(i)
            _mk(name, name)
    else:
        raise TypeError(f"indexes must be an iterable or tuple, got {indexes!r}")
    return agents
