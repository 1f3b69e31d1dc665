"""sympy → PyTorch lowering.

The counterpart of ``inflatox_tpu/lowering/jax_lowering.py``: model
expressions are printed to Python source over ``torch`` and compiled with
``exec``.  The generated functions are elementwise and shape-polymorphic:
``x``/``xdot`` may be a 1-D float64 tensor (point evaluation) or a sequence
of broadcastable float64 tensors (grid evaluation), ``args`` a 1-D float64
tensor.  Every value stays float64: numeric subexpressions print as Python
float literals (never ``math.*`` calls and never float32 tensors), and the
result lives on the device of the inputs.

The printing rules are the JAX lowering's:

* registry slots — field symbols read ``x[i]``, tangents ``xdot[i]``,
  parameters ``args[i]`` (:mod:`inflatox_torch.lowering.registry`);
* integer and integral-float exponents print as integer powers
  (``_ipow``: repeated squaring, as XLA's ``integer_pow``), so negative
  bases stay finite as with C ``pow``;
* Adds and Muls above 16 terms print as balanced trees (CPython 3.12's
  fixed C recursion limit);
* ``Max``/``Min`` print as nested ``torch.maximum``/``torch.minimum``;
* a source that still names ``math.``/``functools.`` is rejected at lower
  time.

XLA's ~1e-8 f64 libm patches (``inflatox_tpu/lowering/accmath.py``) have no
counterpart: torch's f64 ``exp``/``atan``/``pow``/``sinh``/``cosh``/``acos``
are pinned against mpmath in the tests instead.  Special functions (Bessel,
hypergeometric, polygamma, erf, gamma) are not lowered yet (ROADMAP A8).
"""

from __future__ import annotations

import math
import re
import sys
from dataclasses import dataclass
from typing import Callable, Sequence

import sympy
import torch
from sympy.printing.pycode import PythonCodePrinter

from ..utils.errors import MissingSymbolError
from .registry import SymbolRegistry

__all__ = ["LoweredFunction", "lower", "MaxCsesExceeded"]


class MaxCsesExceeded(Exception):
    """Raised when sympy CSE produces more subexpressions than ``max_cses``
    (reference compiler.py:394: "Maximum number of common subexpressions
    reached!")."""


#: sympy function name → torch function, for one-argument elementwise heads
_TORCH_FUNCS = {
    "exp": "exp",
    "log": "log",
    "sin": "sin",
    "cos": "cos",
    "tan": "tan",
    "asin": "asin",
    "acos": "acos",
    "atan": "atan",
    "sinh": "sinh",
    "cosh": "cosh",
    "tanh": "tanh",
    "asinh": "asinh",
    "acosh": "acosh",
    "atanh": "atanh",
    "Abs": "abs",
    "sign": "sign",
    "floor": "floor",
    "ceiling": "ceil",
}

#: heads that wait for the special-function port (ROADMAP A8)
_SPECIAL_NAMES = (
    "besselj", "bessely", "besseli", "besselk", "jn", "yn", "hyper",
    "polygamma", "digamma", "trigamma", "erf", "erfc", "gamma", "loggamma",
)


def _special_not_ported(self, expr):
    raise NotImplementedError(
        f"{type(expr).__name__} has no torch lowering yet: special functions "
        "are ROADMAP item A8 of the PyTorch port"
    )


class _ModelTorchPrinter(PythonCodePrinter):
    """Python printer over ``torch``, wired to the x/xdot/args contract."""

    def __init__(self, registry: SymbolRegistry, settings=None):
        super().__init__(settings)
        self._registry = registry

    # -- numbers ------------------------------------------------------------ #

    def _print(self, expr, **kwargs):
        # A numeric subexpression other than a plain Integer/Rational/Float
        # (sqrt(2), pi, log(3), ...) becomes one float64 literal, evaluated
        # to 30 digits and rounded once.  Python ints and Rationals print
        # through the base printer (exact, or one correctly rounded division).
        if (
            isinstance(expr, sympy.Expr)
            and expr.is_number
            and not isinstance(expr, (sympy.Rational, sympy.Float))
        ):
            return self._float_literal(expr)
        return super()._print(expr, **kwargs)

    @staticmethod
    def _float_literal(expr) -> str:
        value = complex(expr.evalf(30))
        if value.imag != 0.0:
            raise NotImplementedError(f"complex constant {expr} in a model")
        v = value.real
        if math.isnan(v):
            return "float('nan')"
        if math.isinf(v):
            return "float('inf')" if v > 0 else "float('-inf')"
        return repr(v)

    def _as_tensor(self, expr) -> str:
        """Print an argument for torch functions that take tensors only."""
        s = self._print(expr)
        if isinstance(expr, sympy.Expr) and expr.is_number:
            return f"torch.tensor({s}, dtype=torch.float64)"
        return s

    # -- symbols ------------------------------------------------------------ #

    def _print_Symbol(self, expr):
        slot = self._registry.slot(expr)
        if slot is not None:
            kind, i = slot
            return f"{kind}[{i}]"
        name = str(expr)
        if name.startswith("cse"):
            return name  # CSE local variable
        raise MissingSymbolError(name, "<SymbolRegistry>")

    # -- wide sums/products (balanced above 16 terms) ------------------------ #

    _BALANCE_THRESHOLD = 16

    def _print_balanced(self, args, op):
        if len(args) == 1:
            return self._print(args[0])
        mid = len(args) // 2
        left = self._print_balanced(args[:mid], op)
        right = self._print_balanced(args[mid:], op)
        return f"({left} {op} {right})"

    def _print_Add(self, expr, order=None):
        if len(expr.args) <= self._BALANCE_THRESHOLD:
            return super()._print_Add(expr, order)
        return self._print_balanced(expr.args, "+")

    def _print_Mul(self, expr):
        if len(expr.args) <= self._BALANCE_THRESHOLD:
            return super()._print_Mul(expr)
        return self._print_balanced(expr.args, "*")

    # -- powers ------------------------------------------------------------- #

    def _print_Pow(self, expr, rational=False):
        base, exponent = expr.base, expr.exp
        if exponent.is_Integer:
            return f"_ipow({self._print(base)}, {int(exponent)})"
        if exponent.is_Number and not exponent.free_symbols:
            f = float(exponent)
            if f == int(f):
                return f"_ipow({self._print(base)}, {int(f)})"
        if exponent == sympy.Rational(1, 2):
            return f"torch.sqrt({self._as_tensor(base)})"
        if exponent == sympy.Rational(-1, 2):
            return f"(1.0/torch.sqrt({self._as_tensor(base)}))"
        return f"torch.pow({self._print(base)}, {self._print(exponent)})"

    # -- elementwise functions ---------------------------------------------- #

    def _print_Function(self, expr):
        name = type(expr).__name__
        fn = _TORCH_FUNCS.get(name)
        if fn is None or len(expr.args) != 1:
            return super()._print_Function(expr)
        return f"torch.{fn}({self._as_tensor(expr.args[0])})"

    def _print_atan2(self, expr):
        y, x = expr.args
        return f"torch.atan2({self._as_tensor(y)}, {self._as_tensor(x)})"

    def _print_Max(self, expr):
        args = [self._as_tensor(a) for a in expr.args]
        out = args[-1]
        for a in reversed(args[:-1]):
            out = f"torch.maximum({a}, {out})"
        return out

    def _print_Min(self, expr):
        args = [self._as_tensor(a) for a in expr.args]
        out = args[-1]
        for a in reversed(args[:-1]):
            out = f"torch.minimum({a}, {out})"
        return out

    def _print_Piecewise(self, expr):
        raise NotImplementedError(
            "Piecewise has no torch lowering; write the model without it"
        )


for _head, _fn in _TORCH_FUNCS.items():
    setattr(_ModelTorchPrinter, f"_print_{_head}", _ModelTorchPrinter._print_Function)
for _name in _SPECIAL_NAMES:
    setattr(_ModelTorchPrinter, f"_print_{_name}", _special_not_ported)
del _head, _fn, _name


def _ipow(base, n: int):
    """base**n for an integer n by repeated squaring, XLA's ``integer_pow``
    algorithm: exact products in a fixed order, so the torch version, the
    CUDA kernel (``inflx_powi``) and the JAX package round alike, and
    negative bases stay finite."""
    if n < 0:
        return 1.0 / _ipow(base, -n)
    if n == 0:
        return 1.0
    acc = None
    while True:
        if n & 1:
            acc = base if acc is None else acc * base
        n >>= 1
        if not n:
            return acc
        base = base * base


def _bounded_cse_symbols(max_cses: int):
    """Generator of cse0, cse1, ... capped at ``max_cses``
    (reference compiler.py:384-396)."""
    num = 0
    while num <= max_cses:
        yield sympy.Symbol(f"cse{num}")
        num += 1
    raise MaxCsesExceeded("Maximum number of common subexpressions reached!")


@dataclass(eq=False)
class LoweredFunction:
    """A model expression (or tuple of expressions) lowered to a torch
    callable.

    ``fn`` takes the positional arguments named in ``signature`` (subset of
    ``("x", "xdot", "args")``), each an indexable of float64 tensors, and
    returns one value (``n_outputs == 1``) or a tuple.  An output whose
    expression is constant comes back as a Python number: callers broadcast
    it to the grid shape."""

    fn: Callable
    signature: tuple
    source: str
    n_outputs: int
    name: str = "_lowered"

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def lower(
    exprs,
    registry: SymbolRegistry,
    signature: Sequence[str] = ("x", "args"),
    cse: bool = False,
    max_cses: int = 1000,
    name: str = "_lowered",
) -> LoweredFunction:
    """Lower one sympy expression (or a list) to a torch callable.

    Args
    ----
    exprs: a sympy expression or list of expressions (evaluated together, so
        CSE can share work across outputs).
    registry: the model's symbol registry (fixed slot assignment).
    signature: which argument arrays the function takes, in order.
    cse: run sympy common-subexpression elimination before printing.
    max_cses: cap on CSE symbol count (reference compiler.py:354-356).
    name: function name used in the generated source (for tracebacks).
    """
    single = not isinstance(exprs, (list, tuple))
    expr_list = [sympy.sympify(exprs)] if single else [sympy.sympify(e) for e in exprs]

    printer = _ModelTorchPrinter(registry)
    lines = []

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100_000))
    try:
        if cse:
            pairs, reduced = sympy.cse(
                expr_list,
                symbols=_bounded_cse_symbols(max_cses),
                order="none",
                list=True,
            )
            for sym, definition in pairs:
                lines.append(f"    {sym} = {printer.doprint(definition)}")
            expr_list = list(reduced)
        printed = [printer.doprint(e) for e in expr_list]
    finally:
        sys.setrecursionlimit(old_limit)

    if single:
        ret = printed[0]
    else:
        ret = "(" + ", ".join(printed) + ("," if len(printed) == 1 else "") + ")"

    src = (
        f"def {name}({', '.join(signature)}):\n"
        + ("\n".join(lines) + "\n" if lines else "")
        + f"    return {ret}\n"
    )
    # the base printer falls back to scalar math.* / functools.* for heads
    # without an override — those would fail on tensors at call time
    leak = re.search(r"(?<![\w.])(math|functools)\.(\w+)", src)
    if leak:
        raise NotImplementedError(
            f"'{leak.group(2)}' has no tensor lowering (the printer fell "
            f"back to scalar {leak.group(1)}.{leak.group(2)}); add a "
            "_print_ override in lowering/torch_lowering.py"
        )
    namespace = {"torch": torch, "_ipow": _ipow}
    exec(compile(src, f"<inflatox-lowered:{name}>", "exec"), namespace)
    return LoweredFunction(
        fn=namespace[name],
        signature=tuple(signature),
        source=src,
        n_outputs=len(expr_list),
        name=name,
    )
