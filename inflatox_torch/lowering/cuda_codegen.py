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
once, so the outputs share its CSE work.

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

    f_eom_<a>   the EoM term of field a < n (Γ^a_bc χ^b χ^c + g^ab ∂_b V)
    f_eom_h     the Hubble parameter from the Friedmann constraint
    f_eom_hdot  Ḣ = −½ G_ab χ^a χ^b

Each body is translated from the model's torch lowering
(:mod:`inflatox_torch.lowering.torch_lowering`) through Python's ``ast``:
the same operations, in the same order, fully parenthesised — integer powers
through ``inflx_powi`` (the lowering's ``_ipow``), the same CSE locals when
the model was compiled with ``cse=True``.  Each operation rounds once, as
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
from dataclasses import dataclass, field
from string import Template

import numpy as np

from ..ops.cuda_kernels import PRECISIONS
from .dd_lowering import DEMOTED, dd_tree

__all__ = ["generate_header", "generate_solver_header"]

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
    calls; ``real`` is ``"double"`` or ``"float"``; ``values`` holds the
    Python values of the scalar CSE locals (used in float mode)."""

    rn: bool = False
    real: str = "double"
    scalars: set = field(default_factory=set)
    values: dict = field(default_factory=dict)

    def literal(self, value) -> str:
        return _float(value) if self.real == "float" else _double(value)


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
    ``tensor / number`` multiplies by the reciprocal, computed in the
    tensor's type from the number (CUDA's CPU-scalar division path)."""
    if ctx.real == "float" and _is_scalar(node, ctx.scalars):
        value = _scalar_value(node, ctx.values)
        if value is not None:
            return ctx.literal(value)
    one = ctx.literal(1.0)
    if isinstance(node, ast.BinOp) and type(node.op) in (*_BINOPS, ast.Div):
        left, right = _c(node.left, ctx), _c(node.right, ctx)
        if isinstance(node.op, ast.Div):
            lscalar = _is_scalar(node.left, ctx.scalars)
            rscalar = _is_scalar(node.right, ctx.scalars)
            if lscalar and not rscalar:
                return _binop(ast.Mult, f"({one} / {right})", left, ctx.rn)
            if rscalar and not lscalar:
                return _binop(ast.Mult, left, f"({one} / {right})", ctx.rn)
            return f"({left} / {right})"
        return _binop(type(node.op), left, right, ctx.rn)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return f"(-{_c(node.operand, ctx)})"
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.UAdd):
        return _c(node.operand, ctx)
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return ctx.literal(node.value)
    if isinstance(node, ast.Name):
        return node.id  # a CSE local
    if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name):
        slot = {"x": "x", "xdot": "xd", "args": "p"}.get(node.value.id)
        index = _int_const(node.slice)
        if slot is not None and index is not None:
            return f"{slot}[{index}]"
    if isinstance(node, ast.Call):
        func, args = node.func, node.args
        if isinstance(func, ast.Name) and func.id == "_ipow" and len(args) == 2:
            n = _int_const(args[1])
            if n is not None:
                return f"inflx_powi({_c(args[0], ctx)}, {n})"
        if (isinstance(func, ast.Name) and func.id == "float" and len(args) == 1
                and isinstance(args[0], ast.Constant)):
            return ctx.literal(float(args[0].value))  # float('inf') / float('nan')
        if (isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name)
                and func.value.id == "torch"):
            if func.attr == "tensor" and args:  # a literal for Max/Min/atan2
                return _c(args[0], ctx)
            if func.attr in _C_FUNCS:
                inner = ", ".join(_c(a, ctx) for a in args)
                return f"{_C_FUNCS[func.attr]}({inner})"
    raise NotImplementedError(
        f"no CUDA translation for {ast.unparse(node)!r} of a lowered model "
        "function"
    )


def _c_dd(node) -> str:
    """C expression, in double-double, for one node of a lowered function
    rewritten by :func:`inflatox_torch.lowering.dd_lowering.dd_tree`."""
    if isinstance(node, ast.BinOp) and type(node.op) in _DD_BINOPS:
        return f"{_DD_BINOPS[type(node.op)]}({_c_dd(node.left)}, {_c_dd(node.right)})"
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return f"dd_neg({_c_dd(node.operand)})"
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.UAdd):
        return _c_dd(node.operand)
    if isinstance(node, ast.Name):
        return node.id  # a CSE local
    if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name):
        slot = {"x": "x", "args": "p"}.get(node.value.id)
        index = _int_const(node.slice)
        if slot is not None and index is not None:
            return f"{slot}[{index}]"
    if isinstance(node, ast.Call):
        func, args = node.func, node.args
        if isinstance(func, ast.Name) and func.id == "_c" and isinstance(args[0], ast.Constant):
            return f"dd_c({_double(args[0].value)})"
        if isinstance(func, ast.Name) and func.id == "_ipow" and len(args) == 2:
            n = _int_const(args[1])
            if n is not None:
                return f"dd_powi({_c_dd(args[0])}, {n})"
        if (isinstance(func, ast.Name) and func.id == "float" and len(args) == 1
                and isinstance(args[0], ast.Constant)):
            return f"dd_c({_double(float(args[0].value))})"
        if (isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name)
                and func.value.id == "torch"):
            inner = [_c_dd(a) for a in args]
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


def _function_body(lowered, ctx: _Ctx) -> tuple:
    """(CSE lines, C expression of each returned output) of a lowered
    function."""
    (fn,) = ast.parse(lowered.source).body
    lines = []
    for stmt in fn.body:
        if isinstance(stmt, ast.Assign):
            (target,) = stmt.targets
            if _is_scalar(stmt.value, ctx.scalars):
                ctx.scalars.add(target.id)
                ctx.values[target.id] = _scalar_value(stmt.value, ctx.values)
            lines.append(f"  const {ctx.real} {target.id} = {_c(stmt.value, ctx)};\n")
        elif isinstance(stmt, ast.Return):
            return lines, [_c(v, ctx) for v in _returned(stmt)]
    raise ValueError(f"lowered function {lowered.name} has no return")


def _dd_function_body(lowered) -> tuple:
    """The same in double-double, each output demoted to f64."""
    fn = dd_tree(lowered)
    lines = []
    for stmt in fn.body:
        if isinstance(stmt, ast.Assign):
            (target,) = stmt.targets
            lines.append(f"  const dd {target.id} = {_c_dd(stmt.value)};\n")
        elif isinstance(stmt, ast.Return):
            return lines, [f"dd_to_f64({_c_dd(v)})" for v in _returned(stmt)]
    raise ValueError(f"lowered function {lowered.name} has no return")


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

// b**n by repeated squaring: the torch lowering's _ipow, product for product
template <typename T>
INFLX_FN T inflx_powi(T b, int n) {
  const bool negative = n < 0;
  if (negative) n = -n;
  if (n == 0) return T(1);
  T acc = T(0);
  bool have = false;
  for (;;) {
    if (n & 1) {
      acc = have ? $acc_b : b;
      have = true;
    }
    n >>= 1;
    if (!n) break;
    b = $b_b;
  }
  return negative ? T(1) / acc : acc;
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
        return _PRELUDE.substitute(include='#include "inflx_math.cuh"\n',
                                   acc_b="inflx_mul(acc, b)", b_b="inflx_mul(b, b)")
    return _PRELUDE.substitute(include=include, acc_b="acc * b", b_b="b * b")


def _emit_fn(name: str, lowered, output: int | None = None, rn: bool = False) -> str:
    """One solver function (double): output ``output`` of the
    lowered function (its only one when None); its parameters are those of
    the lowered function's signature (``x``, ``xdot`` → ``xd``, ``args`` →
    ``p``)."""
    lines, rets = _function_body(lowered, _Ctx(rn=rn))
    slots = [{"xdot": "xd", "args": "p"}.get(a, a) for a in lowered.signature]
    params = ", ".join(f"const double* __restrict__ {s}" for s in slots)
    unused = " ".join(f"(void){s};" for s in slots)
    (ret,) = rets if output is None else (rets[output],)
    return (
        f"INFLX_FN double {name}({params}) {{\n"
        f"  {unused}\n"
        + "".join(lines)
        + f"  return {ret};\n}}\n\n"
    )


def _emit_grid_fn(name: str, lowered, n_out: int | None, precision: str) -> str:
    """One grid-scan model function of ``x`` and ``p``: with ``n_out`` None
    it returns the lowered function's one output, else it writes its
    ``n_out`` outputs to ``out[0..n_out-1]``."""
    if precision == "dd":
        coord, real = "dd", "double"
        lines, rets = _dd_function_body(lowered)
    else:
        coord = real = "float" if precision == "f32" else "double"
        lines, rets = _function_body(lowered, _Ctx(real=real))
    params = f"const {coord}* __restrict__ x, const {coord}* __restrict__ p"
    if n_out is None:
        (ret,) = rets
        head = f"INFLX_FN {real} {name}({params}) {{\n"
        tail = f"  return {ret};\n}}\n\n"
    else:
        if len(rets) != n_out:
            raise ValueError(f"{lowered.name} returns {len(rets)} values, {name} writes {n_out}")
        head = f"INFLX_FN void {name}({params}, {real}* __restrict__ out) {{\n"
        tail = "".join(f"  out[{k}] = {r};\n" for k, r in enumerate(rets)) + "}\n\n"
    return head + "  (void)x; (void)p;\n" + "".join(lines) + tail


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
    include = '#include "dd.cuh"\n' if precision == "dd" else ""
    return (
        _prelude(include=include)
        + f"#define INFLX_PRECISION {PRECISIONS[precision].id}\n"
        + f"#define INFLX_NP {artifact.n_parameters}\n\n"
        + "".join(_emit_grid_fn(name, getattr(artifact, attr), n_out, precision)
                  for name, attr, n_out in _GRID_FUNCTIONS)
    )


def generate_solver_header(artifact) -> str:
    """Emit the background-solver header for a :class:`CompiledModel` with
    any number of fields: the EoM functions and ``inflx_eom``, which fills
    all n EoM terms at once."""
    n = artifact.n_fields
    calls = "".join(f"  out[{a}] = f_eom_{a}(x, xd, p);\n" for a in range(n))
    return (
        _prelude(rn=True)
        + f"#define INFLX_NF {n}\n\n"
        + "".join(_emit_fn(f"f_eom_{a}", artifact.eom, a, rn=True) for a in range(n))
        + _emit_fn("f_eom_h", artifact.eom_h, rn=True)
        + _emit_fn("f_eom_hdot", artifact.eom_hdot, rn=True)
        + "INFLX_FN void inflx_eom(const double* __restrict__ x, "
        "const double* __restrict__ xd,\n"
        "                         const double* __restrict__ p, double* out) {\n"
        + calls
        + "}\n"
    )
