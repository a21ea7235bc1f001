"""SECP generator — Smart Environment Configuration Problems (smart
lighting).

Equivalent capability to the reference's `pydcop generate secp`
(pydcop/commands/generators/secp.py:129-319), with the same problem
structure:

* **lights** — one variable ``l{i}`` per light plus one unary cost
  factor ``c_l{i}`` (energy = efficiency × level, build_lights :304);
* **physical models** — one variable ``m{j}`` plus one hard factor
  ``c_m{j}`` tying it to a weighted sum of 2..max_model_size lights
  (build_models :201; the weighted sum is rounded here so the equality
  is satisfiable on the integer light domain — the reference compares
  the raw float sum, which makes most model factors unsatisfiable);
* **rules** — soft constraints setting targets over lights and models
  (build_rules :233);
* **agents** — one per light, hosting cost 0 for its own light variable
  AND its cost factor, default hosting cost 100 (build_agents :178) —
  the pre-assignment signal the SECP distribution strategies
  (gh_secp_*, oilp_secp_*) rely on.
"""
from __future__ import annotations

import random
from typing import Optional

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import AgentDef, Domain, Variable
from pydcop_tpu_torch.dcop.relations import NAryFunctionRelation


def generate_secp(
    n_lights: int = 9,
    n_models: int = 3,
    n_rules: int = 2,
    light_levels: int = 5,
    max_model_size: int = 4,
    seed: int = 0,
    n_agents: Optional[int] = None,
    capacity: float = 100,
) -> DCOP:
    rng = random.Random(seed)
    dcop = DCOP(f"secp_{n_lights}l_{n_models}m", "min")
    domain = Domain("light_levels", "luminosity", list(range(light_levels)))

    # lights: variable l{i} + unary energy cost factor c_l{i}
    lights = []
    for i in range(n_lights):
        v = Variable(f"l{i}", domain)
        lights.append(v)
        dcop.add_variable(v)
        eff = rng.randint(0, 90) / 100

        def cost_fn(value, _eff=eff):
            return _eff * value

        dcop.add_constraint(
            NAryFunctionRelation(cost_fn, [v], f"c_l{i}")
        )

    # physical models: variable m{j} + hard factor c_m{j} equating it to
    # the (rounded) weighted sum of its lights
    model_vars = []
    for j in range(n_models):
        mv = Variable(f"m{j}", domain)
        model_vars.append(mv)
        dcop.add_variable(mv)
        size = rng.randint(2, max(2, min(max_model_size, n_lights)))
        scope = rng.sample(lights, size)
        weights = [rng.randint(1, 7) / 10 for _ in scope]

        def model_fn(*values, _w=tuple(weights), _levels=light_levels):
            *light_vals, m_val = values
            s = sum(w * lv for w, lv in zip(_w, light_vals))
            target = min(round(s), _levels - 1)
            return 0 if target == m_val else 10000

        dcop.add_constraint(
            NAryFunctionRelation(model_fn, scope + [mv], f"c_m{j}")
        )

    # rules: soft targets over a sample of lights and models
    elements = lights + model_vars
    for r in range(n_rules):
        size = rng.randint(1, min(3, len(elements)))
        scope = rng.sample(elements, size)
        target = rng.randint(0, light_levels - 1)

        def rule_fn(*values, _target=target, _n=len(scope)):
            return abs(sum(values) / _n - _target) * 10

        dcop.add_constraint(
            NAryFunctionRelation(rule_fn, scope, f"rule_{r}")
        )

    # agents: one per light; its light variable AND cost factor are free
    # to host (hosting cost 0), everything else costs 100
    n_agents = n_agents if n_agents is not None else n_lights
    agents = []
    for i in range(n_agents):
        hosting = {}
        if i < n_lights:
            hosting[f"l{i}"] = 0
            hosting[f"c_l{i}"] = 0
        agents.append(
            AgentDef(f"a{i}", capacity=capacity,
                     default_hosting_cost=100, hosting_costs=hosting)
        )
    dcop.add_agents(agents)
    return dcop
