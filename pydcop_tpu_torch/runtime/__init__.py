"""Runtime: the high-level solve API (single device)."""
from pydcop_tpu_torch.runtime.run import solve, solve_result

__all__ = ["solve", "solve_result"]
