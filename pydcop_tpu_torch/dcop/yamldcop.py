"""YAML problem format, compatible with the reference's format.

Equivalent capability to the reference's pydcop/dcop/yamldcop.py
(load_dcop_from_file :63, load_dcop :93, dcop_yaml :116, _build_constraints
:214, _build_agents :305, load_scenario_from_file :493).

Format summary (see reference docs for the full spec):

* ``domains``: name → {values, type?, initial_value?}; ``values`` may be a
  range string like ``[0 .. 9]``.
* ``variables``: name → {domain, initial_value?, cost_function?, noise_level?}.
* ``external_variables``: like variables, with an ``initial_value``.
* ``constraints``: name → {type: intention, function: <python expr>} or
  {type: extensional, variables: [..], default?, values: {cost: "tok tok |
  tok tok"}}.
* ``agents``: list of names or map name → {capacity?, ...extras}; top-level
  ``routes`` / ``hosting_costs`` sections with ``default`` entries.
* ``distribution_hints``: {must_host: {agent: [computations]}}.
"""
from __future__ import annotations

import os
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Union

import yaml

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import (
    AgentDef,
    Domain,
    ExternalVariable,
    Variable,
    VariableNoisyCostFunc,
    VariableWithCostFunc,
)
from pydcop_tpu_torch.dcop.relations import (
    Constraint,
    NAryMatrixRelation,
    assignment_matrix,
    constraint_from_str,
    generate_assignment_as_dict,
)
from pydcop_tpu_torch.dcop.scenario import Scenario, DcopEvent, EventAction
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.utils.expressions import ExpressionFunction


class DcopInvalidFormatError(Exception):
    pass


class DistributionHints:
    """Placement hints from the problem file (reference:
    pydcop/distribution/objects.py DistributionHints)."""

    def __init__(self, must_host: Optional[Dict[str, List[str]]] = None,
                 host_with: Optional[Dict[str, List[str]]] = None):
        self._must_host = {k: list(v) for k, v in (must_host or {}).items()}
        self._host_with = {k: list(v) for k, v in (host_with or {}).items()}

    def must_host(self, agent_name: str) -> List[str]:
        return list(self._must_host.get(agent_name, []))

    def host_with(self, computation_name: str) -> List[str]:
        return list(self._host_with.get(computation_name, []))

    @property
    def must_host_map(self) -> Dict[str, List[str]]:
        return {k: list(v) for k, v in self._must_host.items()}


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------


def load_dcop_from_file(filenames: Union[str, Iterable[str]]) -> DCOP:
    """Load a DCOP from one or several YAML files (concatenated)."""
    if isinstance(filenames, str):
        filenames = [filenames]
    content = ""
    for fn in filenames:
        with open(os.path.expanduser(fn), encoding="utf-8") as f:
            content += f.read() + "\n"
    return load_dcop(content)


def load_dcop(dcop_str: str) -> DCOP:
    loaded = yaml.safe_load(dcop_str)
    if not loaded:
        raise DcopInvalidFormatError("Empty DCOP definition")
    if not isinstance(loaded, dict) or not loaded.get("variables"):
        raise DcopInvalidFormatError(
            "Invalid DCOP definition: no 'variables' section"
        )
    dcop = DCOP(
        name=loaded.get("name", "dcop"),
        objective=loaded.get("objective", "min"),
        description=loaded.get("description", ""),
    )
    domains = _build_domains(loaded)
    for d in domains.values():
        dcop.add_domain(d)
    for v in _build_variables(loaded, domains).values():
        dcop.add_variable(v)
    for ev in _build_external_variables(loaded, domains).values():
        dcop.add_variable(ev)
    for c in _build_constraints(loaded, dcop).values():
        dcop.add_constraint(c)
    dcop.add_agents(_build_agents(loaded))
    dcop.dist_hints = _build_dist_hints(loaded)
    return dcop


def str_2_domain_values(values_str: str) -> List:
    """Parse a range domain string like ``'0 .. 9'`` or ``'[0 .. 9]'``."""
    s = values_str.strip().strip("[]")
    lo, hi = (part.strip() for part in s.split(".."))
    return list(range(int(lo), int(hi) + 1))


def _build_domains(loaded) -> Dict[str, Domain]:
    domains = {}
    for name, d in (loaded.get("domains") or {}).items():
        values = d["values"]
        if len(values) == 1 and isinstance(values[0], str) and ".." in values[0]:
            values = str_2_domain_values(values[0])
        domains[name] = Domain(name, d.get("type", ""), values)
    return domains


def _variable_common(name, v, domains):
    try:
        domain = domains[v["domain"]]
    except KeyError:
        raise DcopInvalidFormatError(
            f"Unknown domain {v.get('domain')!r} for variable {name}"
        )
    initial_value = v.get("initial_value")
    if initial_value is not None and initial_value not in domain:
        raise DcopInvalidFormatError(
            f"initial value {initial_value!r} not in domain {domain.name} "
            f"for variable {name}"
        )
    return domain, initial_value


def _build_variables(loaded, domains) -> Dict[str, Variable]:
    variables = {}
    for name, v in (loaded.get("variables") or {}).items():
        domain, initial_value = _variable_common(name, v, domains)
        if "cost_function" in v:
            cost_func = ExpressionFunction(str(v["cost_function"]))
            if "noise_level" in v:
                variables[name] = VariableNoisyCostFunc(
                    name, domain, cost_func, initial_value,
                    noise_level=v["noise_level"],
                )
            else:
                variables[name] = VariableWithCostFunc(
                    name, domain, cost_func, initial_value
                )
        else:
            variables[name] = Variable(name, domain, initial_value)
    return variables


def _build_external_variables(loaded, domains) -> Dict[str, ExternalVariable]:
    ext = {}
    for name, v in (loaded.get("external_variables") or {}).items():
        domain, initial_value = _variable_common(name, v, domains)
        ext[name] = ExternalVariable(name, domain, initial_value)
    return ext


def _build_constraints(loaded, dcop: DCOP) -> Dict[str, Constraint]:
    constraints = {}
    all_vars = dcop.all_variables
    for name, c in (loaded.get("constraints") or {}).items():
        ctype = c.get("type")
        if ctype == "intention":
            constraints[name] = constraint_from_str(
                name, str(c["function"]), all_vars
            )
        elif ctype == "extensional":
            constraints[name] = _build_extensional(name, c, dcop)
        elif ctype == "structured":
            constraints[name] = _build_structured(name, c, dcop)
        else:
            raise DcopInvalidFormatError(
                f"Constraint {name}: unknown type {ctype!r} "
                "(must be 'intention', 'extensional' or 'structured')"
            )
    return constraints


def _lookup_var(dcop: DCOP, name: str) -> Variable:
    if name in dcop.variables:
        return dcop.variables[name]
    if name in dcop.external_variables:
        return dcop.external_variables[name]
    raise DcopInvalidFormatError(f"Unknown variable {name!r} in constraint")


def _build_extensional(name, c, dcop: DCOP) -> NAryMatrixRelation:
    var_names = c["variables"]
    if isinstance(var_names, str):
        var_names = [var_names]
    variables = [_lookup_var(dcop, vn) for vn in var_names]
    default = c.get("default", 0)
    matrix = assignment_matrix(variables, default)
    values_def = c.get("values") or {}
    for cost, assignments_def in values_def.items():
        cost = float(cost)
        if len(variables) == 1:
            dom = variables[0].domain
            tokens = (
                [t.strip() for t in assignments_def.split("|")]
                if isinstance(assignments_def, str)
                else [assignments_def]
            )
            for tok in tokens:
                matrix[dom.index(dom.to_domain_value(tok))] = cost
        else:
            for combo in str(assignments_def).split("|"):
                tokens = combo.split()
                if len(tokens) != len(variables):
                    raise DcopInvalidFormatError(
                        f"Constraint {name}: assignment {combo!r} does not "
                        f"match variables {var_names}"
                    )
                idx = tuple(
                    v.domain.index(v.domain.to_domain_value(t))
                    for v, t in zip(variables, tokens)
                )
                matrix[idx] = cost
    return NAryMatrixRelation(variables, matrix, name)


def _build_structured(name, c, dcop: DCOP):
    """``type: structured`` constraints need the closed-form constraint
    classes and their table-free kernels, which this package does not
    have yet: refuse with a typed error instead of densifying."""
    raise NotPortedError(
        f"Constraint {name}: 'structured' constraints are not ported to "
        f"the PyTorch package yet; solve this problem with the JAX package"
    )


def _build_agents(loaded) -> Dict[str, AgentDef]:
    agents_attrs: Dict[str, Dict] = {}
    agents_loaded = loaded.get("agents") or {}
    if isinstance(agents_loaded, list):
        agents_attrs = {a: {} for a in agents_loaded}
    else:
        for a_name, kw in agents_loaded.items():
            agents_attrs[a_name] = dict(kw) if kw else {}

    default_route = 1
    routes: Dict[str, Dict[str, float]] = defaultdict(dict)
    for a1, a1_routes in (loaded.get("routes") or {}).items():
        if a1 == "default":
            default_route = a1_routes
            continue
        if a1 not in agents_attrs:
            raise DcopInvalidFormatError(f"Route for unknown agent {a1}")
        for a2, cost in a1_routes.items():
            if a2 not in agents_attrs:
                raise DcopInvalidFormatError(f"Route for unknown agent {a2}")
            existing = routes.get(a1, {}).get(a2, routes.get(a2, {}).get(a1))
            if existing is not None and existing != cost:
                raise DcopInvalidFormatError(
                    f"Conflicting route definitions for ({a1}, {a2})"
                )
            routes[a1][a2] = cost
            routes[a2][a1] = cost

    default_hosting = 0
    agent_default_hosting: Dict[str, float] = {}
    hosting: Dict[str, Dict[str, float]] = defaultdict(dict)
    for a, costs in (loaded.get("hosting_costs") or {}).items():
        if a == "default":
            default_hosting = costs
            continue
        if a not in agents_attrs:
            raise DcopInvalidFormatError(f"hosting_costs for unknown agent {a}")
        if "default" in costs:
            agent_default_hosting[a] = costs["default"]
        for comp, cost in (costs.get("computations") or {}).items():
            hosting[a][comp] = cost

    agents = {}
    for a, attrs in agents_attrs.items():
        agents[a] = AgentDef(
            a,
            default_hosting_cost=agent_default_hosting.get(a, default_hosting),
            hosting_costs=hosting.get(a, {}),
            default_route=default_route,
            routes=routes.get(a, {}),
            **attrs,
        )
    return agents


def _build_dist_hints(loaded) -> Optional[DistributionHints]:
    if "distribution_hints" not in loaded:
        return None
    hints = loaded["distribution_hints"] or {}
    return DistributionHints(
        must_host=hints.get("must_host"), host_with=hints.get("host_with")
    )


# ---------------------------------------------------------------------------
# Dumping
# ---------------------------------------------------------------------------


def dcop_yaml(dcop: DCOP) -> str:
    """Serialize a DCOP back to the YAML format."""
    out: Dict[str, Any] = {
        "name": dcop.name,
        "objective": dcop.objective,
    }
    if dcop.description:
        out["description"] = dcop.description
    out["domains"] = {
        d.name: {"values": list(d.values), "type": d.type}
        for d in dcop.domains.values()
    }
    variables = {}
    for v in dcop.variables.values():
        vd: Dict[str, Any] = {"domain": v.domain.name}
        if v.initial_value is not None:
            vd["initial_value"] = v.initial_value
        if isinstance(v, VariableWithCostFunc) and isinstance(
            v.cost_func, ExpressionFunction
        ):
            vd["cost_function"] = v.cost_func.expression
        if isinstance(v, VariableNoisyCostFunc):
            vd["noise_level"] = v.noise_level
        variables[v.name] = vd
    out["variables"] = variables
    if dcop.external_variables:
        out["external_variables"] = {
            v.name: {"domain": v.domain.name, "initial_value": v.value}
            for v in dcop.external_variables.values()
        }
    out["constraints"] = {
        c.name: _constraint_yaml(c) for c in dcop.constraints.values()
    }
    out["agents"] = {
        a.name: ({"capacity": a.capacity} if a.capacity is not None else {})
        for a in dcop.agents.values()
    }
    return yaml.dump(out, default_flow_style=False, sort_keys=False)


def _constraint_yaml(c: Constraint) -> Dict:
    expr = getattr(c, "expression", None)
    if expr is not None:
        return {"type": "intention", "function": expr}
    # dump as extensional table, grouping assignments by cost
    by_cost: Dict[float, List[str]] = defaultdict(list)
    for assignment in generate_assignment_as_dict(c.dimensions):
        val = c.get_value_for_assignment(assignment)
        tokens = " ".join(str(assignment[v.name]) for v in c.dimensions)
        by_cost[val].append(tokens)
    return {
        "type": "extensional",
        "variables": c.scope_names,
        "values": {cost: " | ".join(toks) for cost, toks in by_cost.items()},
    }


def yaml_agents(agents: Iterable[AgentDef]) -> str:
    """Serialize agents (+hosting costs & routes) to YAML."""
    agents = list(agents)
    out: Dict[str, Any] = {
        "agents": {
            a.name: {"capacity": a.capacity, **a.extra_attrs} for a in agents
        }
    }
    routes: Dict[str, Any] = {}
    hosting: Dict[str, Any] = {}
    for a in agents:
        if a.routes:
            routes[a.name] = a.routes
        hc: Dict[str, Any] = {}
        if a.default_hosting_cost:
            hc["default"] = a.default_hosting_cost
        if a.hosting_costs:
            hc["computations"] = a.hosting_costs
        if hc:
            hosting[a.name] = hc
    if routes:
        out["routes"] = routes
    if hosting:
        out["hosting_costs"] = hosting
    return yaml.dump(out, default_flow_style=False, sort_keys=False)


def load_agents_from_file(filename: str) -> Dict[str, AgentDef]:
    with open(os.path.expanduser(filename), encoding="utf-8") as f:
        return _build_agents(yaml.safe_load(f.read()))


# ---------------------------------------------------------------------------
# Scenario
# ---------------------------------------------------------------------------


def load_scenario_from_file(filename: str) -> Scenario:
    with open(os.path.expanduser(filename), encoding="utf-8") as f:
        return load_scenario(f.read())


def load_scenario(scenario_str: str) -> Scenario:
    loaded = yaml.safe_load(scenario_str)
    if loaded is None:  # empty file = empty scenario, not a crash
        loaded = {}
    events = []
    for e in loaded.get("events", []):
        if "delay" in e:
            events.append(DcopEvent(e.get("id", "delay"), delay=e["delay"]))
        else:
            actions = [
                EventAction(a["type"], **{k: v for k, v in a.items() if k != "type"})
                for a in e.get("actions", [])
            ]
            events.append(DcopEvent(e.get("id", ""), actions=actions))
    return Scenario(events)


def yaml_scenario(scenario: Scenario) -> str:
    events = []
    for e in scenario.events:
        if e.is_delay:
            events.append({"id": e.id, "delay": e.delay})
        else:
            events.append(
                {
                    "id": e.id,
                    "actions": [
                        {"type": a.type, **a.parameters} for a in e.actions
                    ],
                }
            )
    return yaml.dump({"events": events}, default_flow_style=False, sort_keys=False)
