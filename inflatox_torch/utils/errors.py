"""Exception hierarchy for inflatox_torch (the same classes as inflatox_tpu).

Reference parity: the Rust error enum ``LibInflxRsErr`` (err.rs:28-38) maps
onto Python exceptions at the PyO3 boundary (err.rs:63-74):

=====================  =============================  ==========================
reference variant      reference Python exception     inflatox exception    
=====================  =============================  ==========================
Io                     IOError                        OSError (builtin, reused)
MissingSymbol          SystemError                    MissingSymbolError
Version                SystemError                    SchemaVersionError
Rayon                  SystemError                    (no host thread pool) 
Shape                  Exception                      ShapeError
FieldDim               Exception                      ShapeError
BasisNorm              Exception                      BasisNormError
BasisOth               Exception                      BasisOrthogonalityError
=====================  =============================  ==========================

GSL numerical errors (err.rs:83-103) have no analogue: model functions are
evaluated in IEEE f64 on the device and produce NaN/Inf instead of aborting.
"""

from __future__ import annotations


class InflatoxError(Exception):
    """Base class for all inflatox errors."""


class ShapeError(InflatoxError, ValueError):
    """An input array had the wrong shape.

    Mirrors ``LibInflxRsErr::Shape`` (err.rs:34, Display impl err.rs:54).
    """

    def __init__(self, expected, got, msg: str = ""):
        self.expected = tuple(expected)
        self.got = tuple(got)
        self.msg = msg
        super().__init__(
            f"Expected array with shape {list(self.expected)}, received array "
            f"with shape {list(self.got)}. Context: {msg}"
        )


class MissingSymbolError(InflatoxError, KeyError):
    """A required function/symbol is missing from a compiled model bundle.

    Mirrors ``LibInflxRsErr::MissingSymbol`` (err.rs:31,45-51).
    """

    def __init__(self, symbol: str, bundle: str = "<CompiledModel>"):
        self.symbol = symbol
        self.bundle = bundle
        super().__init__(f'Could not find symbol "{symbol}" in {bundle}')


class SchemaVersionError(InflatoxError, RuntimeError):
    """A serialized model bundle was produced with an incompatible schema.

    Mirrors ``LibInflxRsErr::Version`` (err.rs:32,52)."""

    def __init__(self, found: str, supported: str):
        self.found = found
        self.supported = supported
        super().__init__(
            f"Cannot load model bundle written with schema {found} using the "
            f"current inflatox installation (schema {supported})"
        )


class BasisNormError(InflatoxError):
    """A vielbein basis vector is not normalised on the model's domain.

    Mirrors ``LibInflxRsErr::BasisNorm`` (err.rs:36,56)."""

    def __init__(self, norm: float, vector: int, point):
        self.norm = norm
        self.vector = vector
        self.point = list(point)
        super().__init__(
            f"Expected basis vector {vector} to be normalised everywhere in "
            f"the model's domain. Instead, found norm {norm} at {self.point}."
        )


class BasisOrthogonalityError(InflatoxError):
    """Two vielbein basis vectors are not orthogonal on the model's domain.

    Mirrors ``LibInflxRsErr::BasisOth`` (err.rs:37,57)."""

    def __init__(self, inner_prod: float, vectors: tuple[int, int], point):
        self.inner_prod = inner_prod
        self.vectors = tuple(vectors)
        self.point = list(point)
        v1, v2 = self.vectors
        super().__init__(
            f"Expected basis vectors w{v1} and w{v2} to be orthogonal "
            f"everywhere in the model's domain. Instead, found inner product "
            f"{inner_prod} at {self.point}."
        )


class SimplificationTimeOut(InflatoxError):
    """A sympy simplification step exceeded its time budget.

    Mirrors ``SimplificationTimeOut`` (symbolic.py:102-106 in the reference);
    raised internally and always caught — the unsimplified expression is used.
    """
