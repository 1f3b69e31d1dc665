from .errors import (
    InflatoxError,
    ShapeError,
    MissingSymbolError,
    SchemaVersionError,
    BasisNormError,
    BasisOrthogonalityError,
    SimplificationTimeOut,
)
from .logging import log_info, log_warn, log_panic, Progress
from . import profiling

__all__ = [
    "InflatoxError",
    "ShapeError",
    "MissingSymbolError",
    "SchemaVersionError",
    "BasisNormError",
    "BasisOrthogonalityError",
    "SimplificationTimeOut",
    "log_info",
    "log_warn",
    "log_panic",
    "Progress",
    "profiling",
]
