from pydcop_tpu_torch.dcop.objects import (
    AgentDef,
    BinaryVariable,
    Domain,
    ExternalVariable,
    Variable,
    VariableDomain,
    VariableNoisyCostFunc,
    VariableWithCostDict,
    VariableWithCostFunc,
    create_agents,
    create_variables,
)
from pydcop_tpu_torch.dcop.relations import (
    AsNAryFunctionRelation,
    Constraint,
    NAryFunctionRelation,
    NAryMatrixRelation,
    RelationProtocol,
    UnaryBooleanRelation,
    UnaryFunctionRelation,
    ZeroAryRelation,
    assignment_cost,
    constraint_from_str,
    find_arg_optimal,
    find_optimum,
    join,
    projection,
)
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.scenario import DcopEvent, EventAction, Scenario
from pydcop_tpu_torch.dcop.yamldcop import (
    DistributionHints,
    dcop_yaml,
    load_dcop,
    load_dcop_from_file,
    load_scenario,
    load_scenario_from_file,
    yaml_agents,
    yaml_scenario,
)

__all__ = [
    "AgentDef", "BinaryVariable", "Domain", "ExternalVariable", "Variable",
    "VariableDomain", "VariableNoisyCostFunc", "VariableWithCostDict",
    "VariableWithCostFunc", "create_agents", "create_variables",
    "AsNAryFunctionRelation", "Constraint", "NAryFunctionRelation",
    "NAryMatrixRelation", "RelationProtocol", "UnaryBooleanRelation",
    "UnaryFunctionRelation", "ZeroAryRelation", "assignment_cost",
    "constraint_from_str", "find_arg_optimal", "find_optimum", "join",
    "projection", "DCOP", "DcopEvent", "EventAction", "Scenario",
    "DistributionHints", "dcop_yaml", "load_dcop", "load_dcop_from_file",
    "load_scenario", "load_scenario_from_file", "yaml_agents", "yaml_scenario",
]
