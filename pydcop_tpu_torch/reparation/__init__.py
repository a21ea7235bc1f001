"""Repair DCOP builders: re-host orphaned computations after agent loss.

The port of the JAX package's ``reparation/__init__.py`` (the
reference's pydcop/reparation/__init__.py, its hosted constraint :39 and
capacity constraint :70, and reparation/removal.py's candidate/orphan
helpers): when agents leave,
the orphaned computations and the candidate agents (their replica holders)
form a small *hosting DCOP* over binary variables x_{c,a} ("host c on a"):

* hard: each orphan hosted exactly once;
* hard: agent capacities not exceeded;
* soft: hosting costs + communication costs to the neighbors' hosts.

The reference solves it with MGM among surviving agents
(pydcop/infrastructure/agents.py:1044-1255); here the same mini-DCOP is
built and solved by ``solve_result(repair, "mgm")`` on the given device.
Each constraint is an ``NAryFunctionRelation`` whose table has 2^arity
entries, evaluated on the host when the DCOP compiles; a capacity
constraint spans every candidate variable of one agent.  While every
arity is at most 4 the DCOP packs on the card (MGM's kernel, its mixed
branch); past that it runs the generic engine.  Past
:data:`MAX_REPAIR_ARITY` :func:`build_repair_dcop` refuses: an agent
that is a candidate for many orphans (under unbounded capacities the
replicas of one agent's computations all go to its nearest agent) would
make a table the host cannot evaluate, or numpy cannot shape (past 64
axes).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import AgentDef, BinaryVariable
from pydcop_tpu_torch.dcop.relations import Constraint, NAryFunctionRelation

INFINITY = 10000
#: the widest constraint a repair DCOP may hold: its table has
#: 2^arity entries, each one a Python call when the DCOP compiles
MAX_REPAIR_ARITY = 20


def binary_var_name(computation: str, agent: str) -> str:
    return f"x_{computation}__{agent}"


def create_computation_hosted_constraint(
    computation: str, candidate_vars: List[BinaryVariable]
) -> Constraint:
    """Hard exactly-one: the orphan must be hosted on exactly one candidate
    (reference: reparation/__init__.py:39)."""

    def hosted(*values):
        return 0 if sum(values) == 1 else INFINITY

    return NAryFunctionRelation(
        hosted, candidate_vars, f"hosted_{computation}"
    )


def create_agent_capacity_constraint(
    agent: AgentDef,
    remaining_capacity: float,
    footprints: Dict[str, float],
    agent_vars: List[BinaryVariable],
    var_comp: Dict[str, str],
) -> Constraint:
    """Hard capacity: total footprint of orphans accepted by this agent must
    fit its remaining capacity (reference: reparation/__init__.py:70)."""

    names = [v.name for v in agent_vars]

    def capa(*values):
        used = sum(
            footprints[var_comp[n]] for n, x in zip(names, values) if x
        )
        return 0 if used <= remaining_capacity else INFINITY

    return NAryFunctionRelation(capa, agent_vars, f"capacity_{agent.name}")


def create_agent_hosting_constraint(
    agent: AgentDef, agent_vars: List[BinaryVariable],
    var_comp: Dict[str, str],
) -> Constraint:
    """Soft hosting cost of accepted orphans."""
    names = [v.name for v in agent_vars]

    def hosting(*values):
        return sum(
            agent.hosting_cost(var_comp[n])
            for n, x in zip(names, values) if x
        )

    return NAryFunctionRelation(hosting, agent_vars,
                                f"hosting_{agent.name}")


def create_comm_constraint(
    computation: str,
    candidate_vars: List[BinaryVariable],
    var_agent: Dict[str, str],
    neighbor_hosts: List[Tuple[str, float]],
    agents: Dict[str, AgentDef],
) -> Constraint:
    """Soft communication cost: route from the chosen host to each neighbor
    computation's (surviving) host, weighted by message load."""
    names = [v.name for v in candidate_vars]

    def comm(*values):
        total = 0.0
        for n, x in zip(names, values):
            if not x:
                continue
            a = agents[var_agent[n]]
            for nb_host, load in neighbor_hosts:
                total += a.route(nb_host) * load
        return total

    return NAryFunctionRelation(comm, candidate_vars, f"comm_{computation}")


def build_repair_dcop(
    orphaned: Iterable[str],
    candidates: Dict[str, List[str]],
    agents: Dict[str, AgentDef],
    distribution,
    computation_memory: Optional[Callable[[str], float]] = None,
    communication_load: Optional[Callable[[str, str], float]] = None,
    neighbors: Optional[Dict[str, List[str]]] = None,
) -> Tuple[DCOP, Dict[str, Dict[str, BinaryVariable]]]:
    """Build the hosting mini-DCOP for a set of orphaned computations.

    Returns (repair_dcop, vars_by_comp: comp → {agent: x variable}).
    """
    mem = computation_memory or (lambda c: 0.0)
    neighbors = neighbors or {}
    repair = DCOP("repair", "min")

    vars_by_comp: Dict[str, Dict[str, BinaryVariable]] = {}
    vars_by_agent: Dict[str, List[BinaryVariable]] = {a: [] for a in agents}
    var_comp: Dict[str, str] = {}
    var_agent: Dict[str, str] = {}
    for comp in sorted(orphaned):
        vars_by_comp[comp] = {}
        for a_name in candidates.get(comp, []):
            v = BinaryVariable(binary_var_name(comp, a_name))
            repair.add_variable(v)
            vars_by_comp[comp][a_name] = v
            vars_by_agent[a_name].append(v)
            var_comp[v.name] = comp
            var_agent[v.name] = a_name
    _check_arity(vars_by_comp, vars_by_agent)

    for comp, cand_vars in vars_by_comp.items():
        if not cand_vars:
            continue
        repair.add_constraint(
            create_computation_hosted_constraint(
                comp, list(cand_vars.values())
            )
        )
        if communication_load is not None:
            nb_hosts = []
            for nb in neighbors.get(comp, []):
                try:
                    nb_hosts.append(
                        (distribution.agent_for(nb),
                         communication_load(comp, nb))
                    )
                except KeyError:
                    continue
            if nb_hosts:
                repair.add_constraint(
                    create_comm_constraint(
                        comp, list(cand_vars.values()), var_agent,
                        nb_hosts, agents,
                    )
                )

    for a_name, a_vars in vars_by_agent.items():
        if not a_vars:
            continue
        agent = agents[a_name]
        used = sum(
            mem(c) for c in distribution.computations_hosted(a_name)
        )
        cap = agent.capacity if agent.capacity is not None else float("inf")
        repair.add_constraint(
            create_agent_capacity_constraint(
                agent, cap - used, {c: mem(c) for c in orphaned},
                a_vars, var_comp,
            )
        )
        if any(agent.hosting_cost(var_comp[v.name]) for v in a_vars):
            repair.add_constraint(
                create_agent_hosting_constraint(agent, a_vars, var_comp)
            )

    return repair, vars_by_comp


def _check_arity(vars_by_comp, vars_by_agent) -> None:
    """Refuse, before any table is built, a repair DCOP whose capacity
    constraint (an agent's candidate variables) or exactly-one
    constraint (an orphan's) spans more than :data:`MAX_REPAIR_ARITY`
    variables."""
    for what, groups in (
            ("agent {!r} is a candidate host for {} orphaned "
             "computations", vars_by_agent),
            ("computation {!r} has {} candidate hosts", vars_by_comp)):
        for name, group in sorted(groups.items()):
            if len(group) > MAX_REPAIR_ARITY:
                raise ValueError(
                    f"the repair DCOP would hold a constraint of arity "
                    f"{len(group)}, past MAX_REPAIR_ARITY = "
                    f"{MAX_REPAIR_ARITY} (its table has 2^{len(group)} "
                    f"entries): " + what.format(name, len(group))
                    + "; bound the agents' capacities so that the "
                    "replicas of one agent's computations spread over "
                    "several agents")


def repair_shape(repair: DCOP) -> Dict[str, int]:
    """The size of a repair DCOP: its variables, its constraints and
    their largest arity."""
    return {
        "variables": len(repair.variables),
        "constraints": len(repair.constraints),
        "max_arity": max((c.arity for c in repair.constraints.values()),
                         default=0),
    }


def solve_repair_dcop(
    repair: DCOP,
    vars_by_comp: Dict[str, Dict[str, BinaryVariable]],
    cycles: int = 30,
    seed: int = 0,
    device=None,
) -> Dict[str, str]:
    """Solve the hosting DCOP with MGM (the reference's choice,
    agents.py:1044) on ``device`` (cuda unless the caller passes
    ``device="cpu"``) and return comp → new host."""
    from pydcop_tpu_torch.runtime.run import solve_result

    res = solve_result(repair, "mgm", cycles=cycles, seed=seed,
                       device=device)
    placement: Dict[str, str] = {}
    for comp, cand in vars_by_comp.items():
        chosen = [
            a for a, v in cand.items() if res.assignment.get(v.name) == 1
        ]
        if len(chosen) == 1:
            placement[comp] = chosen[0]
        elif cand:
            # fall back: pick deterministically if MGM left an invalid
            # exactly-one state (can happen from a bad random start)
            placement[comp] = sorted(cand)[0]
    return placement
