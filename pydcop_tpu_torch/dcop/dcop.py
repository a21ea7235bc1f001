"""The DCOP container object.

Equivalent capability to the reference's pydcop/dcop/dcop.py:41 (`DCOP`),
including `solution_cost` (:308,319) and DCOP merging (`__add__`, :154).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

from pydcop_tpu_torch.dcop.objects import AgentDef, Domain, ExternalVariable, Variable
from pydcop_tpu_torch.dcop.relations import Constraint


class DCOP:
    """A Distributed Constraint Optimization Problem.

    Holds domains, variables, constraints, agents and external variables,
    with an objective ('min' or 'max').

    >>> from pydcop_tpu_torch.dcop.objects import Domain, Variable
    >>> from pydcop_tpu_torch.dcop.relations import constraint_from_str
    >>> dcop = DCOP('test')
    >>> d = Domain('d', 'd', [0, 1, 2])
    >>> v1, v2 = Variable('v1', d), Variable('v2', d)
    >>> _ = dcop.add_constraint(constraint_from_str('c1', 'abs(v1 - v2)', [v1, v2]))
    >>> dcop.solution_cost({'v1': 0, 'v2': 2}, 10000)
    (0, 2.0)
    """

    def __init__(
        self,
        name: str = "dcop",
        objective: str = "min",
        description: str = "",
        domains: Optional[Dict[str, Domain]] = None,
        variables: Optional[Dict[str, Variable]] = None,
        constraints: Optional[Dict[str, Constraint]] = None,
        agents: Optional[Dict[str, AgentDef]] = None,
    ):
        if objective not in ("min", "max"):
            raise ValueError(f"objective must be 'min' or 'max', got {objective!r}")
        self.name = name
        self.objective = objective
        self.description = description
        self.domains: Dict[str, Domain] = dict(domains or {})
        self.variables: Dict[str, Variable] = dict(variables or {})
        self.external_variables: Dict[str, ExternalVariable] = {}
        self.constraints: Dict[str, Constraint] = {}
        self.agents: Dict[str, AgentDef] = dict(agents or {})
        self.dist_hints = None  # DistributionHints, set by the yaml loader
        for c in (constraints or {}).values():
            self.add_constraint(c)

    # -- building -----------------------------------------------------------

    def add_domain(self, domain: Domain) -> "DCOP":
        self.domains[domain.name] = domain
        return self

    def add_variable(self, variable: Variable) -> "DCOP":
        if isinstance(variable, ExternalVariable):
            self.external_variables[variable.name] = variable
        else:
            self.variables[variable.name] = variable
        self.domains.setdefault(variable.domain.name, variable.domain)
        return self

    def add_constraint(self, constraint: Constraint) -> "DCOP":
        """Add a constraint; its variables (and their domains) are
        registered automatically."""
        self.constraints[constraint.name] = constraint
        for v in constraint.dimensions:
            if v.name not in self.variables and v.name not in self.external_variables:
                self.add_variable(v)
        return self

    def add_agents(
        self, agents: Union[Iterable[AgentDef], Dict[Any, AgentDef]]
    ) -> "DCOP":
        if isinstance(agents, dict):
            agents = agents.values()
        for a in agents:
            self.agents[a.name] = a
        return self

    # reference-parity conveniences
    def variable(self, name: str) -> Variable:
        return self.variables[name]

    def constraint(self, name: str) -> Constraint:
        return self.constraints[name]

    def agent(self, name: str) -> AgentDef:
        return self.agents[name]

    def get_external_variable(self, name: str) -> ExternalVariable:
        return self.external_variables[name]

    @property
    def all_variables(self) -> List[Variable]:
        return list(self.variables.values()) + list(self.external_variables.values())

    # -- queries ------------------------------------------------------------

    def constraints_for_variable(self, variable: Union[str, Variable]
                                 ) -> List[Constraint]:
        name = variable if isinstance(variable, str) else variable.name
        return [c for c in self.constraints.values() if name in c.scope_names]

    def solution_cost(
        self, assignment: Dict[str, Any], infinity: float = float("inf")
    ) -> Tuple[int, float]:
        """(hard-violation count, total cost) of a full assignment.

        A constraint whose cost reaches `infinity` counts as violated and is
        excluded from the cost sum; variable costs are included
        (reference: dcop.py:308-360).
        """
        full = dict(assignment)
        for ev in self.external_variables.values():
            full.setdefault(ev.name, ev.value)
        violations, cost = 0, 0.0
        for c in self.constraints.values():
            try:
                val = c.get_value_for_assignment(
                    {n: full[n] for n in c.scope_names}
                )
            except KeyError as ke:
                raise ValueError(
                    f"Incomplete assignment: missing {ke} for constraint {c.name}"
                )
            if val >= infinity:
                violations += 1
            else:
                cost += val
        for v in self.variables.values():
            if v.has_cost and v.name in full:
                cost += v.cost_for_val(full[v.name])
        return violations, cost

    # -- merge (dynamic DCOPs build on this, reference dcop.py:154) ---------

    def __add__(self, other: "DCOP") -> "DCOP":
        merged = DCOP(
            f"{self.name}+{other.name}",
            self.objective,
            self.description,
        )
        if self.objective != other.objective:
            raise ValueError("Cannot merge DCOPs with different objectives")
        for d in {**self.domains, **other.domains}.values():
            merged.add_domain(d)
        for v in {**self.variables, **other.variables}.values():
            merged.add_variable(v)
        for ev in {**self.external_variables, **other.external_variables}.values():
            merged.add_variable(ev)
        for c in {**self.constraints, **other.constraints}.values():
            merged.add_constraint(c)
        merged.add_agents({**self.agents, **other.agents})
        return merged

    def __repr__(self):
        return (
            f"DCOP({self.name!r}, {len(self.variables)} vars, "
            f"{len(self.constraints)} constraints, {len(self.agents)} agents)"
        )
