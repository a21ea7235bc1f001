from pydcop_tpu_torch.utils.serialization import SimpleRepr, simple_repr, from_repr
from pydcop_tpu_torch.utils.expressions import ExpressionFunction

__all__ = ["SimpleRepr", "simple_repr", "from_repr", "ExpressionFunction"]
