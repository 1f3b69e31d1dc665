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

* ``Piecewise`` prints as nested ``torch.where``, its conditions taken in
  sympy's order (the JAX printer's ``select``: the first true condition
  wins, NaN where none holds); ``sinc`` as its Piecewise;
* special functions (Bessel J/Y/I/K, spherical j/y, the hypergeometric
  0F1/1F1/2F1/2F0, erf, erfc, loggamma, gamma, polygamma) print as
  ``_special.<fn>`` calls (:mod:`inflatox_torch.lowering.special`), and
  every distinct special call is hoisted into one ``cse_sf<k>`` local,
  innermost first, whatever the ``cse`` flag says (``jax_lowering.py``'s
  always-on special-call CSE, whose Bessel and hypergeometric heads are
  joined here by the gamma family).

XLA's ~1e-8 f64 libm patches (``inflatox_tpu/lowering/accmath.py``) have no
counterpart: torch's f64 ``exp``/``atan``/``pow``/``sinh``/``cosh``/``acos``
are pinned against mpmath in the tests instead.
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
from . import special as _special_module
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

#: special-function heads hoisted by the always-on special-call CSE: the JAX
#: printer's Bessel and hypergeometric heads, and the gamma family, whose
#: calls repeat by the dozen in a Hesse (Γ(y)'s derivatives are Γ·ψ⁽ⁿ⁾)
_SPECIAL_HEADS = (
    sympy.besselj,
    sympy.bessely,
    sympy.besseli,
    sympy.besselk,
    sympy.functions.special.bessel.jn,
    sympy.functions.special.bessel.yn,
    sympy.hyper,
    sympy.erf,
    sympy.erfc,
    sympy.gamma,
    sympy.loggamma,
    sympy.polygamma,
)

#: the comparisons a Piecewise condition may hold
_RELATIONS = {"<", "<=", ">", ">=", "==", "!="}


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

    # -- Piecewise and its conditions (C9) ---------------------------------- #

    def _print_Piecewise(self, expr):
        """Nested ``torch.where``: the first condition that holds picks its
        branch, NaN where none does (the JAX printer's ``select``)."""
        out = "torch.tensor(float('nan'), dtype=torch.float64)"
        for value, cond in reversed(expr.args):
            if cond is sympy.true:
                out = self._as_tensor(value)
            elif cond is not sympy.false:
                out = f"torch.where({self._print(cond)}, {self._as_tensor(value)}, {out})"
        return out

    def _print_Relational(self, expr):
        if expr.rel_op not in _RELATIONS:
            raise NotImplementedError(f"relation {expr.rel_op} in a Piecewise condition")
        return f"({self._as_tensor(expr.lhs)} {expr.rel_op} {self._print(expr.rhs)})"

    def _print_And(self, expr):
        args = [self._print(a) for a in expr.args]
        out = args[-1]
        for a in reversed(args[:-1]):
            out = f"torch.logical_and({a}, {out})"
        return out

    def _print_Or(self, expr):
        args = [self._print(a) for a in expr.args]
        out = args[-1]
        for a in reversed(args[:-1]):
            out = f"torch.logical_or({a}, {out})"
        return out

    def _print_Not(self, expr):
        return f"torch.logical_not({self._print(expr.args[0])})"

    def _print_sinc(self, expr):
        x = expr.args[0]
        return self._print(sympy.Piecewise((sympy.sin(x) / x, sympy.Ne(x, 0)), (1, True)))

    # -- special functions → _special.* (jax_lowering.py:142-223) ------------ #

    def _print_erf(self, expr):
        return f"_special.erf({self._print(expr.args[0])})"

    def _print_erfc(self, expr):
        return f"_special.erfc({self._print(expr.args[0])})"

    def _print_loggamma(self, expr):
        return f"_special.lgamma({self._print(expr.args[0])})"

    def _print_gamma(self, expr):
        return f"_special.gamma({self._print(expr.args[0])})"

    def _print_polygamma(self, expr):
        n, z = expr.args
        if not (n.is_Integer and int(n) >= 0):
            raise NotImplementedError(
                f"polygamma order must be a non-negative integer, got {n}"
            )
        return f"_special.polygamma({int(n)}, {self._print(z)})"

    def _print_digamma(self, expr):
        return f"_special.polygamma(0, {self._print(expr.args[0])})"

    def _print_trigamma(self, expr):
        return f"_special.polygamma(1, {self._print(expr.args[0])})"

    def _print_besselj(self, expr):
        nu, z = expr.args
        return f"_special.besselj({self._print(nu)}, {self._print(z)})"

    def _print_bessely(self, expr):
        nu, z = expr.args
        return f"_special.bessely({self._print(nu)}, {self._print(z)})"

    def _print_besseli(self, expr):
        nu, z = expr.args
        return f"_special.besseli({self._print(nu)}, {self._print(z)})"

    def _print_besselk(self, expr):
        nu, z = expr.args
        return f"_special.besselk({self._print(nu)}, {self._print(z)})"

    def _print_jn(self, expr):
        n, z = expr.args
        return f"_special.sph_jn({self._print(n)}, {self._print(z)})"

    def _print_yn(self, expr):
        n, z = expr.args
        return f"_special.sph_yn({self._print(n)}, {self._print(z)})"

    def _print_hyper(self, expr):
        """Same family coverage as the reference's GSL printer
        (compiler.py:158-177)."""
        ap, bq, z = expr.args
        kind = (len(ap), len(bq))
        a = [self._print(v) for v in ap]
        b = [self._print(v) for v in bq]
        zs = self._print(z)
        if kind == (2, 0):
            return f"_special.hyp2f0({a[0]}, {a[1]}, {zs})"
        if kind == (2, 1):
            return f"_special.hyp2f1({a[0]}, {a[1]}, {b[0]}, {zs})"
        if kind == (1, 1):
            return f"_special.hyp1f1({a[0]}, {b[0]}, {zs})"
        if kind == (0, 1):
            return f"_special.hyp0f1({b[0]}, {zs})"
        raise Exception(
            "Cannot compute hypergeometric functions other than 2F0, 2F1, "
            "1F1 and 0F1"
        )


for _head, _fn in _TORCH_FUNCS.items():
    setattr(_ModelTorchPrinter, f"_print_{_head}", _ModelTorchPrinter._print_Function)
del _head, _fn


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
        # always-on special-call CSE: every distinct special call (function,
        # order, argument expression) becomes ONE local, innermost first,
        # whatever the cse flag says
        sf_map: dict = {}

        def _hoist(e):
            insts = e.atoms(*_SPECIAL_HEADS)
            if not insts and not sf_map:
                return e
            for inst in sorted(
                insts,
                key=lambda i: (sympy.count_ops(i), sympy.default_sort_key(i)),
            ):
                if inst not in sf_map:
                    rewritten = inst.xreplace(sf_map) if sf_map else inst
                    sym = sympy.Symbol(f"cse_sf{len(sf_map)}")
                    lines.append(f"    {sym} = {printer.doprint(rewritten)}")
                    sf_map[inst] = sym
            return e.xreplace(sf_map) if sf_map else e

        if cse:
            pairs, reduced = sympy.cse(
                expr_list,
                symbols=_bounded_cse_symbols(max_cses),
                order="none",
                list=True,
            )
            for sym, definition in pairs:
                lines.append(f"    {sym} = {printer.doprint(_hoist(definition))}")
            expr_list = list(reduced)
        printed = [printer.doprint(_hoist(e)) for e in expr_list]
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
    namespace = {"torch": torch, "_ipow": _ipow, "_special": _special_module}
    exec(compile(src, f"<inflatox-lowered:{name}>", "exec"), namespace)
    return LoweredFunction(
        fn=namespace[name],
        signature=tuple(signature),
        source=src,
        n_outputs=len(expr_list),
        name=name,
    )
