"""Per-model CUDA/C++ headers for the hand-written kernels.

Two headers, one per kernel library.  :func:`generate_header` (2-field
models only) defines what the grid and point scans need, with the registry
slots of :mod:`inflatox_torch.lowering.registry` (``x[i]`` fields, ``p[i]``
parameters), in one of three precisions:

    f_V(x, p)           potential V
    f_hesse(x, p, out)  projected Hesse: out[0..3] = V_vv, V_vw, V_wv, V_ww
    f_gsq(x, p)         |∇V|²
    f_grad(x, p, out)   out[0..1] = ∂_0 V, ∂_1 V

``f_hesse`` and ``f_grad`` write every output of their lowered function at
once, so the outputs share its CSE work.  Each is also emitted in three
stages for the grid kernels (:func:`_emit_grid_fn`): ``<f>_row`` (what reads
only ``x[0]`` and ``p``), ``<f>_col`` (``x[1]`` and ``p``) and
``<f>_point``, which reads their values; :func:`grid_stage_ops` counts each
stage's operations.

* ``"f64"`` (kernels B1, B5a): ``double`` coordinates, parameters and
  values;
* ``"f32"`` (kernel B2): ``float`` throughout, every literal a ``float``
  constant (a bare ``3.0`` would promote the sum to double on the card,
  slower and rounded differently from torch's f32 operations), and every
  subexpression of Python numbers evaluated in Python and rounded to f32
  once, as torch receives it;
* ``"dd"`` (kernels B4, B5b): ``dd`` coordinates and parameters, the model
  evaluated in double-double (``csrc/dd.cuh``) and demoted to ``double``:
  each ``+ - * /`` a ``dd_*`` call, each literal a double-double constant,
  so that ``1/3`` is a double-double quotient
  (:mod:`inflatox_torch.lowering.dd_lowering`, whose rewritten tree this
  translates).

Each header also defines ``INFLX_PRECISION`` (the id of
:data:`inflatox_torch.ops.cuda_kernels.PRECISIONS`) and ``INFLX_NP``, the
number of parameters.  The model functions are inlined into each of the
library's eleven kernel instances, whatever the model's size: on the card
that was faster than calling them on every model measured, and D5's and
EGNO's libraries still build in seconds
(``scripts/probe_model_fn_inline.py``).

:func:`generate_solver_header` (any field count n) defines what the
background solver needs, with the signature ``(const double* x, const
double* xd, const double* p)`` (``xd[i]`` the field velocities), and
``#define INFLX_NF n``:

    f_eom_h            the Hubble parameter from the Friedmann constraint
    inflx_deriv(.., out)  out[0..n-1] the velocities χ^a, out[n..2n-1] the
                       EoM terms (Γ^a_bc χ^b χ^c + g^ab ∂_b V), out[2n]
                       Ḣ = −½ G_ab χ^a χ^b, from one body

Each body is translated from the model's torch lowering
(:mod:`inflatox_torch.lowering.torch_lowering`) through Python's ``ast``:
the same operations, in the same order, fully parenthesised — integer powers
through ``inflx_powi`` (the lowering's ``_ipow``), the same CSE locals when
the model was compiled with ``cse=True``; the staged functions and the
solver's are hash-consed (:class:`_Dag`), which names repeated operations
once and changes none.  Each operation rounds once, as
the corresponding torch kernel does, so the kernels agree with their plain
PyTorch versions to the last bit wherever both use the same libm (on the
card: CUDA's).  The headers keep FMA contraction out differently (see
:mod:`inflatox_torch.ops.build`): the grid-scan headers use plain operators
(and ``dd.cuh``'s non-fusing intrinsics) and are built with
``-fmad=false``; the solver header writes its sums and products as
``inflx_add``/``inflx_sub``/``inflx_mul`` (``csrc/inflx_math.cuh``, never
fused) and is built with contraction on, so that CUDA's ``pow`` compiles
exactly as inside ``torch.pow``.

Every function is marked ``INFLX_FN``: ``__device__ __forceinline__`` under
nvcc, ``static inline`` elsewhere, so the same headers also compile with
the host's C++ compiler (the CPU tests do that).
"""

from __future__ import annotations

import ast
import math
import re
from dataclasses import dataclass, field
from string import Template

import numpy as np

from ..ops.cuda_kernels import PRECISIONS
from .dd_lowering import DEMOTED, dd_tree

__all__ = ["generate_header", "generate_solver_header", "grid_stage_ops"]

#: torch functions of the lowered source → C functions
_C_FUNCS = {
    "sqrt": "sqrt", "exp": "exp", "log": "log",
    "sin": "sin", "cos": "cos", "tan": "tan",
    "asin": "asin", "acos": "acos", "atan": "atan",
    "sinh": "sinh", "cosh": "cosh", "tanh": "tanh",
    "asinh": "asinh", "acosh": "acosh", "atanh": "atanh",
    "floor": "floor", "ceil": "ceil", "abs": "fabs",
    "sign": "inflx_sign", "pow": "pow", "atan2": "atan2",
    "maximum": "inflx_max", "minimum": "inflx_min",
}

#: torch functions the double-double header computes in double-double
_DD_FUNCS = {"sqrt": "dd_sqrt", "exp": "dd_exp", "log": "dd_log", "pow": "dd_pow",
             "abs": "dd_abs", "maximum": "dd_max", "minimum": "dd_min"}

#: comparisons of a Piecewise condition → C operators, and their
#: double-double functions (``csrc/dd.cuh``)
_CMPOPS = {ast.Lt: "<", ast.LtE: "<=", ast.Gt: ">", ast.GtE: ">=", ast.Eq: "==", ast.NotEq: "!="}
_DD_CMPOPS = {ast.Lt: "dd_lt", ast.LtE: "dd_le", ast.Gt: "dd_gt", ast.GtE: "dd_ge",
              ast.Eq: "dd_eq", ast.NotEq: "dd_ne"}
_LOGICAL = {"logical_and": "&&", "logical_or": "||"}

#: the largest polygamma order of kernel B8 (``csrc/special.cuh``)
_POLYGAMMA_MAX = 8

_BINOPS = {ast.Add: "+", ast.Sub: "-", ast.Mult: "*"}
_RN_BINOPS = {ast.Add: "inflx_add", ast.Sub: "inflx_sub", ast.Mult: "inflx_mul"}
_DD_BINOPS = {ast.Add: "dd_add", ast.Sub: "dd_sub", ast.Mult: "dd_mul", ast.Div: "dd_div"}


def _double(value) -> str:
    v = float(value)
    if math.isnan(v):
        return "NAN"
    if math.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    return repr(v)


def _float(value) -> str:
    """A float constant equal to f32(value): the shortest decimal of the f32
    number, which the C++ compiler reads back as that float."""
    v = float(np.float32(value))
    if math.isnan(v) or math.isinf(v):
        return _double(v)
    return repr(v) + "f"


def _int_const(node):
    """The Python int a node denotes (``2``, ``-2``), or None."""
    if isinstance(node, ast.Constant) and type(node.value) is int:
        return node.value
    if (isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub)
            and isinstance(node.operand, ast.Constant)
            and type(node.operand.value) is int):
        return -node.operand.value
    return None


def _is_scalar(node, scalars) -> bool:
    """True if the node evaluates to a Python float or int (not a tensor)
    when the lowered function runs; ``scalars`` names the CSE locals that
    do."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id in scalars
    if isinstance(node, ast.BinOp):
        return _is_scalar(node.left, scalars) and _is_scalar(node.right, scalars)
    if isinstance(node, ast.UnaryOp):
        return _is_scalar(node.operand, scalars)
    if isinstance(node, ast.Call):
        return isinstance(node.func, ast.Name) and node.func.id == "float"
    return False


@dataclass
class _Ctx:
    """How to translate: ``rn`` writes sums and products as ``inflx_*``
    calls; ``real`` is ``"double"`` or ``"float"``; ``dd`` translates a
    tree rewritten by :func:`dd_tree` into double-double; ``values`` holds
    the Python values of the scalar CSE locals (used in float mode);
    ``dag``, when set, hash-conses every operation into it
    (:meth:`sub`), and ``names`` maps each CSE local to its value there."""

    rn: bool = False
    real: str = "double"
    dd: bool = False
    fast_div: bool = False
    scalars: set = field(default_factory=set)
    values: dict = field(default_factory=dict)
    dag: "_Dag | None" = None
    names: dict = field(default_factory=dict)

    def literal(self, value) -> str:
        return _float(value) if self.real == "float" else _double(value)

    def divide(self, left: str, right: str) -> str:
        """A division with a tensor divisor: the operator, or with
        ``fast_div`` the solver's branch-free ``inflx_div_fast``, which
        clears the local ``ok`` outside its range."""
        if self.fast_div:
            return f"inflx_div_fast({left}, {right}, &ok)"
        return f"({left} / {right})"

    def sub(self, node) -> str:
        """C text of a child node: its whole expression, or with a dag the
        name of its node there (leaves and constants stay inline)."""
        if self.dag is None:
            return _c_dd(node, self) if self.dd else _c(node, self)
        if isinstance(node, ast.Name) and node.id in self.names:
            return self.names[node.id]
        text = _c_dd(node, self) if self.dd else _c(node, self)
        if _is_leaf(node, self):
            return text
        return self.dag.intern(text, _head_ops(node, self))


def _binop(op, left, right, rn) -> str:
    if rn:
        return f"{_RN_BINOPS[op]}({left}, {right})"
    return f"({left} {_BINOPS[op]} {right})"


def _scalar_value(node, values):
    """The Python value of a scalar node, as the lowered function computes
    it (f64 arithmetic), or None where Python would raise."""
    try:
        return float(eval(compile(ast.Expression(node), "<scalar>", "eval"),  # noqa: S307
                          {"float": float, "__builtins__": {}}, dict(values)))
    except (ZeroDivisionError, OverflowError):
        return None


def _c(node, ctx: _Ctx) -> str:
    """C expression for one node of a lowered torch function.

    Division follows what torch computes on the card: ``number / tensor``
    is ``tensor.reciprocal() * number`` (``Tensor.__rtruediv__``) and
    ``tensor / number`` multiplies by the reciprocal (CUDA's CPU-scalar
    division path), which torch forms in f64 from the number and, for an f32
    tensor, rounds to f32 once."""
    if ctx.real == "float" and _is_scalar(node, ctx.scalars):
        value = _scalar_value(node, ctx.values)
        if value is not None:
            return ctx.literal(value)
    one = ctx.literal(1.0)
    if isinstance(node, ast.BinOp) and type(node.op) in (*_BINOPS, ast.Div):
        left, right = ctx.sub(node.left), ctx.sub(node.right)
        if isinstance(node.op, ast.Div):
            lscalar = _is_scalar(node.left, ctx.scalars)
            rscalar = _is_scalar(node.right, ctx.scalars)
            if lscalar and not rscalar:
                return _binop(ast.Mult, ctx.divide(one, right), left, ctx.rn)
            if rscalar and not lscalar:
                value = _scalar_value(node.right, ctx.values)
                if ctx.real == "float" and value not in (None, 0.0):
                    # torch on the card forms the reciprocal from the f64
                    # number and rounds it to f32 once (scripts/probe_f32_scalar_div.py)
                    return _binop(ast.Mult, left, ctx.literal(1.0 / value), ctx.rn)
                return _binop(ast.Mult, left, f"({one} / {right})", ctx.rn)
            return f"({left} / {right})" if lscalar else ctx.divide(left, right)
        return _binop(type(node.op), left, right, ctx.rn)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return f"(-{ctx.sub(node.operand)})"
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.UAdd):
        return ctx.sub(node.operand)
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return ctx.literal(node.value)
    if isinstance(node, ast.Name):
        return node.id  # a CSE local
    if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name):
        slot = {"x": "x", "xdot": "xd", "args": "p"}.get(node.value.id)
        index = _int_const(node.slice)
        if slot is not None and index is not None:
            return f"{slot}[{index}]"
    if isinstance(node, ast.Compare) and len(node.ops) == 1 and type(node.ops[0]) in _CMPOPS:
        return (f"({ctx.sub(node.left)} {_CMPOPS[type(node.ops[0])]} "
                f"{ctx.sub(node.comparators[0])})")
    if isinstance(node, ast.Call):
        func, args = node.func, node.args
        if (isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name)
                and func.value.id == "_special"):
            return _c_special(func.attr, args, ctx)
        if isinstance(func, ast.Attribute) and func.attr == "where" and len(args) == 3:
            return f"({ctx.sub(args[0])} ? {ctx.sub(args[1])} : {ctx.sub(args[2])})"
        if isinstance(func, ast.Attribute) and func.attr in _LOGICAL and len(args) == 2:
            return f"({ctx.sub(args[0])} {_LOGICAL[func.attr]} {ctx.sub(args[1])})"
        if isinstance(func, ast.Attribute) and func.attr == "logical_not" and len(args) == 1:
            return f"(!{ctx.sub(args[0])})"
        if isinstance(func, ast.Name) and func.id == "_ipow" and len(args) == 2:
            n = _int_const(args[1])
            if n is not None and n < 0 and ctx.fast_div:  # 1 / b**|n|, as inflx_powi
                return ctx.divide(one, f"inflx_powi<{-n}>({ctx.sub(args[0])})")
            if n is not None:
                return f"inflx_powi<{n}>({ctx.sub(args[0])})"
        if (isinstance(func, ast.Name) and func.id == "float" and len(args) == 1
                and isinstance(args[0], ast.Constant)):
            return ctx.literal(float(args[0].value))  # float('inf') / float('nan')
        if (isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name)
                and func.value.id == "torch"):
            if func.attr == "tensor" and args:  # a literal for Max/Min/atan2
                return ctx.sub(args[0])
            if func.attr in _C_FUNCS:
                inner = ", ".join(ctx.sub(a) for a in args)
                return f"{_C_FUNCS[func.attr]}({inner})"
    raise NotImplementedError(
        f"no CUDA translation for {ast.unparse(node)!r} of a lowered model "
        "function"
    )


def _static_value(node, ctx: _Ctx):
    """The Python number a node denotes when the lowered function runs
    (an order or parameter given as a literal), or None for a tensor."""
    if not _is_scalar(node, ctx.scalars):
        return None
    return _scalar_value(node, ctx.values)


def _is_int(value) -> bool:
    return value is not None and math.isfinite(value) and float(value) == int(value)


#: _special functions with an order, and their C entries
_ORDERED = ("besselj", "bessely", "besseli", "besselk")
_SPHERICAL = ("sph_jn", "sph_yn")
_PLAIN = ("hyp0f1", "hyp1f1", "hyp2f1", "hyp2f0", "erf", "erfc", "lgamma", "gamma")


def _c_special(name: str, args, ctx: _Ctx) -> str:
    """C call of kernel B8 (``csrc/special.cuh``) for ``_special.<name>(…)``:
    a static integer order is a template argument (``inflx_besselj_int<T,
    0>(z)``); any other order (a fractional literal or a parameter) takes
    the run-time-order route, as :func:`special._is_static_int` decides in
    the plain version; hypergeometric parameters stay arguments."""
    T = ctx.real
    if name in _ORDERED:
        nu, z = args
        value = _static_value(nu, ctx)
        if _is_int(value):
            return f"inflx_{name}_int<{T}, {int(value)}>({ctx.sub(z)})"
        return f"inflx_{name}<{T}>({ctx.sub(nu)}, {ctx.sub(z)})"
    if name in _SPHERICAL:
        n, z = args
        value = _static_value(n, ctx)
        if value is None:
            raise NotImplementedError(f"{name} needs a numeric order in a CUDA kernel")
        if _is_int(value):
            return f"inflx_{name}_int<{T}, {int(value)}>({ctx.sub(z)})"
        if _is_int(value + 0.5):
            return f"inflx_{name}_half<{T}, {int(value + 0.5)}>({ctx.sub(z)})"
        return f"inflx_{name}_frac<{T}>({_double(value)}, {ctx.sub(z)})"
    if name == "polygamma":
        n = _int_const(args[0])
        if n is None or not 0 <= n <= _POLYGAMMA_MAX:
            raise NotImplementedError(
                f"polygamma of order {ast.unparse(args[0])} has no CUDA kernel (orders "
                f"0..{_POLYGAMMA_MAX})")
        return f"inflx_polygamma<{T}, {n}>({ctx.sub(args[1])})"
    if name in _PLAIN:
        return f"inflx_{name}<{T}>({', '.join(ctx.sub(a) for a in args)})"
    raise NotImplementedError(f"no CUDA translation for special function {name!r}")


def _c_dd(node, ctx: _Ctx) -> str:
    """C expression, in double-double, for one node of a lowered function
    rewritten by :func:`inflatox_torch.lowering.dd_lowering.dd_tree`."""
    if isinstance(node, ast.BinOp) and type(node.op) in _DD_BINOPS:
        return f"{_DD_BINOPS[type(node.op)]}({ctx.sub(node.left)}, {ctx.sub(node.right)})"
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return f"dd_neg({ctx.sub(node.operand)})"
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.UAdd):
        return ctx.sub(node.operand)
    if isinstance(node, ast.Name):
        return node.id  # a CSE local
    if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name):
        slot = {"x": "x", "args": "p"}.get(node.value.id)
        index = _int_const(node.slice)
        if slot is not None and index is not None:
            return f"{slot}[{index}]"
    if isinstance(node, ast.Compare) and len(node.ops) == 1 and type(node.ops[0]) in _DD_CMPOPS:
        return (f"{_DD_CMPOPS[type(node.ops[0])]}({ctx.sub(node.left)}, "
                f"{ctx.sub(node.comparators[0])})")
    if isinstance(node, ast.Call):
        func, args = node.func, node.args
        if (isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name)
                and func.value.id == "_special"):
            raise NotImplementedError(
                f"special function {func.attr!r} is not available in the "
                "double-double engine (kernels B4, B5b, B7d); use precision='f64'"
            )
        if isinstance(func, ast.Attribute) and func.attr == "where" and len(args) == 3:
            return f"dd_where({ctx.sub(args[0])}, {ctx.sub(args[1])}, {ctx.sub(args[2])})"
        if isinstance(func, ast.Attribute) and func.attr in _LOGICAL and len(args) == 2:
            return f"({ctx.sub(args[0])} {_LOGICAL[func.attr]} {ctx.sub(args[1])})"
        if isinstance(func, ast.Attribute) and func.attr == "logical_not" and len(args) == 1:
            return f"(!{ctx.sub(args[0])})"
        if isinstance(func, ast.Name) and func.id == "_c" and isinstance(args[0], ast.Constant):
            return f"dd_c({_double(args[0].value)})"
        if isinstance(func, ast.Name) and func.id == "_ipow" and len(args) == 2:
            n = _int_const(args[1])
            if n is not None:
                return f"dd_powi<{n}>({ctx.sub(args[0])})"
        if (isinstance(func, ast.Name) and func.id == "float" and len(args) == 1
                and isinstance(args[0], ast.Constant)):
            return f"dd_c({_double(float(args[0].value))})"
        if (isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name)
                and func.value.id == "torch"):
            inner = [ctx.sub(a) for a in args]
            if func.attr == "tensor" and args:
                return inner[0]
            if func.attr in _DD_FUNCS:
                return f"{_DD_FUNCS[func.attr]}({', '.join(inner)})"
            if func.attr in DEMOTED or func.attr == "atan2":
                demoted = ", ".join(f"dd_to_f64({a})" for a in inner)
                return f"dd_c({_C_FUNCS[func.attr]}({demoted}))"
    raise NotImplementedError(
        f"no double-double CUDA translation for {ast.unparse(node)!r} of a "
        "lowered model function"
    )


def _returned(stmt) -> list:
    value = stmt.value
    return list(value.elts) if isinstance(value, ast.Tuple) else [value]


_REF = re.compile(r"\bv(\d+)\b")
_SLOT = re.compile(r"\bx\[(\d+)\]")


class _Dag:
    """Hash-consed operations of lowered functions: one node per distinct C
    expression over earlier nodes (``v<k>``), with leaves (coordinates,
    parameters, literals and constant subexpressions) inline.  Equal text
    is the same operations on the same operands in the same order, so a
    node computes each value once, and every use of it gets the bits that
    each of its copies in the lowered source would have."""

    def __init__(self):
        self.text, self.kids, self.slots, self.ops = [], [], [], []
        self._index = {}

    def intern(self, text: str, ops: dict) -> str:
        k = self._index.get(text)
        if k is None:
            k = len(self.text)
            kids = sorted({int(v) for v in _REF.findall(text)})
            slots = set(_SLOT.findall(text)).union(*(self.slots[c] for c in kids))
            self.text.append(text)
            self.kids.append(kids)
            self.slots.append(frozenset(slots))
            self.ops.append(ops)
            self._index[text] = k
        return f"v{k}"

    def closure(self, values) -> list:
        """The nodes that the C texts ``values`` need, in order."""
        need, stack = set(), [int(v) for t in values for v in _REF.findall(t)]
        while stack:
            k = stack.pop()
            if k not in need:
                need.add(k)
                stack.extend(self.kids[k])
        return sorted(need)


def _is_leaf(node, ctx: _Ctx) -> bool:
    """True for what a dag keeps inline: coordinates, parameters, CSE
    locals, literals, constant f64/f32 subexpressions (the compiler folds
    them) and wrappers that pass their argument through."""
    if isinstance(node, (ast.Constant, ast.Subscript, ast.Name, ast.Compare)):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.UAdd):
        return True
    if not ctx.dd and _is_scalar(node, ctx.scalars):
        return True
    if isinstance(node, ast.Call):
        func = node.func
        if isinstance(func, ast.Name) and func.id in ("float", "_c"):
            return True
        return isinstance(func, ast.Attribute) and func.attr in (
            "tensor", "logical_and", "logical_or", "logical_not")
    return False


def _head_ops(node, ctx: _Ctx) -> dict:
    """The operations of a node itself, its children not counted, by name:
    ``add`` (+ and −), ``mul``, ``div``, ``call`` (an f64/f32 library call),
    ``special`` (a kernel B8 call: its operations depend on the route that
    its argument takes, so a caller counts them on the arguments of a run,
    :func:`inflatox_torch.lowering.special.route_operations`) and,
    in double-double, ``sqrt``, ``exp``, ``log`` and ``demoted`` (a
    call made in f64); an integer power by its multiplies (and a division
    when negative), a ``pow`` in double-double as ``log``, ``mul``, ``exp``;
    a subexpression of constants only as nothing."""
    if not any(isinstance(n, (ast.Name, ast.Subscript)) for n in ast.walk(node)):
        return {}
    if isinstance(node, ast.BinOp):
        return {{ast.Add: "add", ast.Sub: "add", ast.Mult: "mul",
                 ast.Div: "div"}[type(node.op)]: 1}
    if isinstance(node, ast.Call):
        func = node.func
        if isinstance(func, ast.Name) and func.id == "_ipow":
            n = _int_const(node.args[1])
            mults = abs(n).bit_length() - 1 + bin(abs(n)).count("1") - 1
            return {"mul": mults, "div": int(n < 0)}
        if (isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name)
                and func.value.id == "_special"):
            return {"special": 1}
        if isinstance(func, ast.Attribute) and func.attr == "where":
            return {}
        if isinstance(func, ast.Attribute) and func.attr != "tensor":
            if not ctx.dd:
                return {"call": 1}
            if func.attr == "pow":
                return {"log": 1, "mul": 1, "exp": 1}
            return {func.attr if func.attr in ("sqrt", "exp", "log") else "demoted": 1}
    return {}


def _translate(lowered, ctx: _Ctx, ctype: str = "") -> tuple:
    """(C lines, C text of each returned output) of a lowered function.
    With ``ctx.dag`` every operation is hash-consed into it and there are no
    lines (an output is a node name or a leaf); without, each CSE local is
    one line ``const <ctype> <local> = <its whole expression>;``, as the
    lowering wrote it."""
    fn = dd_tree(lowered) if ctx.dd else ast.parse(lowered.source).body[0]
    ctx.names, ctx.scalars, ctx.values = {}, set(), {}  # CSE locals are per function
    lines = []
    for stmt in fn.body:
        if isinstance(stmt, ast.Assign):
            (target,) = stmt.targets
            if not ctx.dd and _is_scalar(stmt.value, ctx.scalars):
                ctx.scalars.add(target.id)
                ctx.values[target.id] = _scalar_value(stmt.value, ctx.values)
            value = ctx.sub(stmt.value)
            if ctx.dag is None:
                lines.append(f"  const {ctype} {target.id} = {value};\n")
            else:
                ctx.names[target.id] = value
        elif isinstance(stmt, ast.Return):
            return "".join(lines), [ctx.sub(v) for v in _returned(stmt)]
    raise ValueError(f"lowered function {lowered.name} has no return")


def _lines(dag: _Dag, nodes, ctype: str) -> str:
    return "".join(f"  const {ctype} v{k} = {dag.text[k]};\n" for k in nodes)


_PRELUDE = Template("""\
// Generated by inflatox_torch.lowering.cuda_codegen — per-model functions
// for the kernels in csrc/, translated from the model's torch lowering.
#pragma once
#include <math.h>
$include
#ifndef INFLX_FN
#ifdef __CUDACC__
#define INFLX_FN __device__ __forceinline__
#else
#define INFLX_FN static inline
#endif
#endif

// full-precision math constants (strict language modes hide the POSIX ones)
#ifndef M_PI
#define M_PI 3.14159265358979323846
#endif
#ifndef M_E
#define M_E 2.71828182845904523536
#endif
#ifndef M_LN2
#define M_LN2 0.69314718055994530942
#endif
#ifndef M_LN10
#define M_LN10 2.30258509299404568402
#endif
#ifndef M_LOG2E
#define M_LOG2E 1.44269504088896340736
#endif
#ifndef M_LOG10E
#define M_LOG10E 0.43429448190325182765
#endif
#ifndef M_SQRT2
#define M_SQRT2 1.41421356237309504880
#endif

// b**N by repeated squaring: the torch lowering's _ipow, product for product
// (from the lowest set bit of N, each bit's square times the product so far,
// b squared between bits), unrolled at compile time; 1/b**|N| for N < 0.  A
// loop over the bits of a run-time n stayed a loop in nvcc's code, its
// branches cutting each model function into blocks that did not overlap.
template <int N, bool HAVE, typename T>
INFLX_FN T inflx_powi_bits(T acc, T b) {
  if constexpr ((N & 1) != 0) {
    if constexpr (HAVE) {
      acc = $acc_b;
    } else {
      acc = b;
    }
  }
  if constexpr ((N >> 1) == 0) {
    return acc;
  } else {
    return inflx_powi_bits<(N >> 1), (HAVE || (N & 1) != 0)>(acc, $b_b);
  }
}
template <int N, typename T>
INFLX_FN T inflx_powi(T b) {
  if constexpr (N == 0) {
    return T(1);
  } else if constexpr (N < 0) {
    return T(1) / inflx_powi_bits<-N, false>(b, b);
  } else {
    return inflx_powi_bits<N, false>(b, b);
  }
}
// NaN-propagating, as torch.maximum/torch.minimum (C fmax/fmin drop NaN)
template <typename T>
INFLX_FN T inflx_max(T a, T b) { return (a != a || a > b) ? a : b; }
template <typename T>
INFLX_FN T inflx_min(T a, T b) { return (a != a || a < b) ? a : b; }
template <typename T>
INFLX_FN T inflx_sign(T a) { return a > T(0) ? T(1) : (a < T(0) ? T(-1) : a); }

""")


def _prelude(rn: bool = False, include: str = "") -> str:
    """The header's fixed part; with ``rn`` it includes
    ``csrc/inflx_math.cuh`` and ``inflx_powi`` multiplies through
    ``inflx_mul``."""
    if rn:
        return _PRELUDE.substitute(include='#include "inflx_math.cuh"\n' + include,
                                   acc_b="inflx_mul(acc, b)", b_b="inflx_mul(b, b)")
    return _PRELUDE.substitute(include=include, acc_b="acc * b", b_b="b * b")


_SPECIAL_INCLUDE = '#include "special.cuh"\n'

#: rows of a grid-scan block (``INFLX_ROWS`` in ``csrc/grid_scan.cu``) and the
#: static shared memory a block may hold
_GRID_ROWS = 16
_STATIC_SHARED = 48 * 1024

#: the model functions each scan kind evaluates (``inflx_uses_*`` in
#: ``csrc/grid_scan.cu``)
_KIND_FUNCTIONS = (("f_V", "f_hesse", "f_gsq"), ("f_V", "f_hesse"), ("f_V", "f_gsq"),
                   ("f_V",), ("f_hesse",), ("f_grad",))


def _check_shared(artifact, precision: str, n_rows: dict) -> None:
    """Raise if a kind's row stages (``rows[INFLX_ROWS][nr]`` in
    ``csrc/grid_scan.cu``) pass the 48 KB of static shared memory a block may
    hold: nvcc would refuse the library."""
    size = {"f64": 8, "f32": 4, "dd": 16}[precision]
    worst = max(sum(n_rows[f] for f in fns) for fns in _KIND_FUNCTIONS)
    need = _GRID_ROWS * worst * size
    if need > _STATIC_SHARED:
        name = getattr(artifact, "model_name", "<model>")
        raise ValueError(
            f'model "{name}" needs {worst} row values per grid row in precision '
            f"{precision!r}: {need} bytes of static shared memory for {_GRID_ROWS} rows, "
            f"more than the {_STATIC_SHARED} a block may hold"
        )


_SOLVER_SLOTS = ("const double* __restrict__ x, const double* __restrict__ xd, "
                 "const double* __restrict__ p")


def _emit_eom_h(artifact) -> str:
    """``f_eom_h(x, xd, p)``: H from the Friedmann constraint."""
    ctx = _Ctx(rn=True, dag=_Dag())
    _, (ret,) = _translate(artifact.eom_h, ctx)
    return (f"INFLX_FN double f_eom_h({_SOLVER_SLOTS}) {{\n  (void)x; (void)xd; (void)p;\n"
            + _lines(ctx.dag, ctx.dag.closure([ret]), "double")
            + f"  return {ret};\n}}\n\n")


def _deriv_body(artifact, fast_div: bool) -> tuple:
    """(C lines, outputs) of the merged derivative: the velocities, the n
    EoM terms and Ḣ, hash-consed together."""
    n = artifact.n_fields
    ctx = _Ctx(rn=True, fast_div=fast_div, dag=_Dag())
    outs = [f"xd[{a}]" for a in range(n)] + _translate(artifact.eom, ctx)[1]
    outs += _translate(artifact.eom_hdot, ctx)[1]
    if len(outs) != 2 * n + 1:
        raise ValueError(f"the EoM of a {n}-field model has {len(outs) - n - 1} terms")
    return _lines(ctx.dag, ctx.dag.closure(outs), "double"), outs


def _emit_deriv(artifact) -> str:
    """``inflx_deriv(x, xd, p, out)``: out[0..n-1] the velocities χ,
    out[n..2n-1] the EoM terms, out[2n] Ḣ, from one body in which the EoM's
    and Ḣ's identical subexpressions are computed once.  Its divisions are
    ``inflx_div_fast`` (no branch, so independent work overlaps them); when
    one of them is outside that function's range, the whole derivative is
    computed again by ``inflx_deriv_exact``, with the operator, out of line
    (``inflx_deriv_cold``, state and result passed by value, so that
    neither the fallback's code nor its divisions sit in the hot path)."""
    exact, exact_outs = _deriv_body(artifact, fast_div=False)
    fast, outs = _deriv_body(artifact, fast_div=True)
    head = (f"({_SOLVER_SLOTS},\n"
            "                        double* __restrict__ out) {\n  (void)x; (void)xd; (void)p;\n")
    return (
        "INFLX_FN void inflx_deriv_exact" + head + exact
        + "".join(f"  out[{k}] = {o};\n" for k, o in enumerate(exact_outs)) + "}\n\n"
        + _COLD
        + "INFLX_FN void inflx_deriv" + head + "  bool ok = true;\n" + fast
        + "  if (ok) {\n" + "".join(f"    out[{k}] = {o};\n" for k, o in enumerate(outs))
        + "  } else {\n    inflx_deriv_cold_into(x, xd, p, out);\n  }\n}\n"
    )


_COLD = """\
struct inflx_state { double x[INFLX_NF], xd[INFLX_NF]; };
struct inflx_slope_t { double out[2 * INFLX_NF + 1]; };
INFLX_COLD inflx_slope_t inflx_deriv_cold(const inflx_state s, const double* __restrict__ p) {
  inflx_slope_t r;
  inflx_deriv_exact(s.x, s.xd, p, r.out);
  return r;
}
INFLX_FN void inflx_deriv_cold_into(const double* x, const double* xd, const double* p,
                                    double* out) {
  inflx_state s;
  for (int a = 0; a < INFLX_NF; ++a) {
    s.x[a] = x[a];
    s.xd[a] = xd[a];
  }
  const inflx_slope_t r = inflx_deriv_cold(s, p);
  for (int k = 0; k < 2 * INFLX_NF + 1; ++k) out[k] = r.out[k];
}

"""


@dataclass
class _Stages:
    """A grid function's nodes by what they read: ``row`` (the row stage:
    x[0] and p, or p alone), ``col`` (x[1] and p, or p alone) and ``point``
    (both coordinates); ``row_out`` and ``col_out``, the row and column
    values the point stage reads."""

    row: list
    col: list
    point: list
    row_out: list
    col_out: list


def _stages(dag: _Dag, outputs) -> _Stages:
    point = [k for k in dag.closure(outputs) if dag.slots[k] >= {"0", "1"}]
    read = {int(v) for t in outputs for v in _REF.findall(t)}.union(
        *(dag.kids[k] for k in point))
    frontier = sorted(read.difference(point))
    row_out = [k for k in frontier if "0" in dag.slots[k]]
    col_out = [k for k in frontier if "0" not in dag.slots[k]]
    return _Stages(dag.closure([f"v{k}" for k in row_out]),
                   dag.closure([f"v{k}" for k in col_out]), point, row_out, col_out)


def _grid_fn(lowered, n_out, precision):
    """(dag, outputs, stages) of one grid-scan model function."""
    ctx = _Ctx(real="float" if precision == "f32" else "double", dd=precision == "dd",
               dag=_Dag())
    _, outs = _translate(lowered, ctx)
    if n_out is not None and len(outs) != n_out:
        raise ValueError(f"{lowered.name} returns {len(outs)} values, not {n_out}")
    if n_out is None and len(outs) != 1:
        raise ValueError(f"{lowered.name} returns {len(outs)} values, not one")
    return ctx.dag, outs, _stages(ctx.dag, outs)


def _emit_grid_fn(name: str, lowered, n_out: int | None, precision: str) -> tuple:
    """One grid-scan model function of ``x`` and ``p`` as three stages and
    whole: ``<name>_row(x, p, r)`` writes the row values (``<NAME>_NR`` of
    them) from x[0], ``<name>_col(x, p, c)`` the column values
    (``<NAME>_NC``) from x[1], and ``<name>_point(x, p, r, c[, out])`` the
    function from both; ``<name>(x, p[, out])`` is the function whole, one
    line per CSE local of the lowering, for the point kernels, whose points
    share nothing (nvcc merges their repeats itself; B5a and B5b ran 5-10 %
    slower with the hash-consed nodes in their place, PERF.md).  With
    ``n_out`` None the function returns the lowered function's one output,
    else it writes its ``n_out`` outputs to ``out[0..n_out-1]``.  Returns
    (C text, number of row values)."""
    dag, outs, st = _grid_fn(lowered, n_out, precision)
    coord = "dd" if precision == "dd" else ("float" if precision == "f32" else "double")
    real = "double" if precision == "dd" else coord
    demote = (lambda o: f"dd_to_f64({o})") if precision == "dd" else (lambda o: o)
    whole, whole_outs = _translate(lowered, _Ctx(real=real, dd=precision == "dd"), coord)
    upper = name.upper()
    xp = f"const {coord}* __restrict__ x, const {coord}* __restrict__ p"
    rc = f"const {coord}* __restrict__ r, const {coord}* __restrict__ c"
    reads = "".join(f"  const {coord} v{k} = r[{i}];\n" for i, k in enumerate(st.row_out))
    reads += "".join(f"  const {coord} v{k} = c[{i}];\n" for i, k in enumerate(st.col_out))
    def tail(values):
        if n_out is None:
            return f"  return {demote(values[0])};\n}}\n\n"
        return "".join(f"  out[{k}] = {demote(v)};\n" for k, v in enumerate(values)) + "}\n\n"

    if n_out is None:
        point_head = f"INFLX_FN {real} {name}_point({xp}, {rc}) {{\n"
        whole_head = f"INFLX_FN {real} {name}({xp}) {{\n"
    else:
        point_head = f"INFLX_FN void {name}_point({xp}, {rc}, {real}* __restrict__ out) {{\n"
        whole_head = f"INFLX_FN void {name}({xp}, {real}* __restrict__ out) {{\n"
    return (
        f"#define {upper}_NR {len(st.row_out)}\n#define {upper}_NC {len(st.col_out)}\n"
        f"INFLX_FN void {name}_row({xp}, {coord}* __restrict__ r) {{\n  (void)x; (void)p;\n"
        + _lines(dag, st.row, coord)
        + "".join(f"  r[{i}] = v{k};\n" for i, k in enumerate(st.row_out)) + "}\n"
        f"INFLX_FN void {name}_col({xp}, {coord}* __restrict__ c) {{\n  (void)x; (void)p;\n"
        + _lines(dag, st.col, coord)
        + "".join(f"  c[{i}] = v{k};\n" for i, k in enumerate(st.col_out)) + "}\n"
        + point_head + "  (void)x; (void)p; (void)r; (void)c;\n" + reads
        + _lines(dag, st.point, coord) + tail(outs)
        + whole_head + "  (void)x; (void)p;\n" + whole + tail(whole_outs)
    ), len(st.row_out)


#: (header function, lowered function attribute, outputs written to out[],
#: or None for a returned value)
_GRID_FUNCTIONS = (
    ("f_V", "potential", None),
    ("f_hesse", "_hesse", 4),
    ("f_gsq", "grad_square", None),
    ("f_grad", "_grad", 2),
)


def generate_header(artifact, precision: str = "f64") -> str:
    """Emit the grid/point-scan header for a 2-field :class:`CompiledModel`
    in ``precision`` (``"f64"``, ``"f32"`` or ``"dd"``)."""
    if artifact.n_fields != 2:
        raise ValueError("the grid-scan kernel supports 2-field models")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, got {precision!r}")
    lowered = [getattr(artifact, attr) for _, attr, _ in _GRID_FUNCTIONS]
    include = '#include "dd.cuh"\n' if precision == "dd" else ""
    if precision != "dd" and artifact.uses_special_functions:
        include += _SPECIAL_INCLUDE
    n_rows = {}
    body = []
    for (name, _, n_out), fn in zip(_GRID_FUNCTIONS, lowered):
        text, n_rows[name] = _emit_grid_fn(name, fn, n_out, precision)
        body.append(text)
    _check_shared(artifact, precision, n_rows)
    return (
        _prelude(include=include)
        + f"#define INFLX_PRECISION {PRECISIONS[precision].id}\n"
        + f"#define INFLX_NP {artifact.n_parameters}\n\n"
        + "".join(body)
    )


def grid_stage_ops(artifact, precision: str = "f64") -> dict:
    """Operations of each grid-scan model function's stages, as the header
    computes them: ``{header function: {"row": ops, "col": ops, "point":
    ops}}``, each ops a dict of counts by name (:func:`_head_ops`; in
    double-double each output's demotion to f64 as one ``f64``)."""
    counts = {}
    for name, attr, n_out in _GRID_FUNCTIONS:
        dag, outs, st = _grid_fn(getattr(artifact, attr), n_out, precision)
        stage = {}
        for key, nodes in (("row", st.row), ("col", st.col), ("point", st.point)):
            total = {}
            for k in nodes:
                for op, v in dag.ops[k].items():
                    total[op] = total.get(op, 0) + v
            stage[key] = total
        if precision == "dd":
            stage["point"]["f64"] = len(outs)
        counts[name] = stage
    return counts


def generate_solver_header(artifact) -> str:
    """Emit the background-solver header for a :class:`CompiledModel` with
    any number of fields: ``f_eom_h`` and ``inflx_deriv``."""
    include = _SPECIAL_INCLUDE if artifact.uses_special_functions else ""
    return (
        _prelude(rn=True, include=include)
        + f"#define INFLX_NF {artifact.n_fields}\n\n"
        + _emit_eom_h(artifact)
        + _emit_deriv(artifact)
    )
