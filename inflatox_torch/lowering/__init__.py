from .registry import SymbolRegistry
from .torch_lowering import LoweredFunction, lower

__all__ = ["SymbolRegistry", "LoweredFunction", "lower"]
