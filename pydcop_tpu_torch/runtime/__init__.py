"""Runtime: the high-level solve API (single device), the virtual
orchestrator's constructor and the fault plans."""
from pydcop_tpu_torch.runtime.faults import Fault, FaultPlan
from pydcop_tpu_torch.runtime.run import (
    run_local_process_dcop,
    run_local_thread_dcop,
    solve,
    solve_result,
)

__all__ = ["solve", "solve_result", "run_local_thread_dcop",
           "run_local_process_dcop", "Fault", "FaultPlan"]
