"""Per-model CUDA/C++ headers for the hand-written kernels.

Two headers, one per kernel library.  :func:`generate_header` (2-field
models only) defines what the grid and point scans need, with the signature
``(const double* x, const double* p)`` and the registry slots of
:mod:`inflatox_torch.lowering.registry` (``x[i]`` fields, ``p[i]``
parameters):

    f_V    potential V
    f_h00  projected Hesse V_vv
    f_h10  projected Hesse V_wv
    f_h11  projected Hesse V_ww
    f_gsq  |∇V|²

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
card: CUDA's).  The two headers keep FMA contraction out differently (see
:mod:`inflatox_torch.ops.build`): the grid-scan header uses plain operators
and is built with ``-fmad=false``; the solver header writes its sums and
products as ``inflx_add``/``inflx_sub``/``inflx_mul`` (``csrc/inflx_math.cuh``,
never fused) and is built with contraction on, so that CUDA's ``pow``
compiles exactly as inside ``torch.pow``.

Every function is marked ``INFLX_FN``: ``__device__ __forceinline__`` under
nvcc, ``static inline`` elsewhere, so the same header also compiles with the
host's C++ compiler (the CPU tests do that).
"""

from __future__ import annotations

import ast
import math
from string import Template

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

_BINOPS = {ast.Add: "+", ast.Sub: "-", ast.Mult: "*"}
_RN_BINOPS = {ast.Add: "inflx_add", ast.Sub: "inflx_sub", ast.Mult: "inflx_mul"}


def _double(value) -> str:
    v = float(value)
    if math.isnan(v):
        return "NAN"
    if math.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    return repr(v)


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


def _binop(op, left, right, rn) -> str:
    if rn:
        return f"{_RN_BINOPS[op]}({left}, {right})"
    return f"({left} {_BINOPS[op]} {right})"


def _c(node, scalars=frozenset(), rn=False) -> str:
    """C expression for one node of a lowered torch function; with ``rn``,
    sums and products are written as ``inflx_add``/``inflx_sub``/
    ``inflx_mul``.

    Division follows what torch computes on the card: ``number / tensor``
    is ``tensor.reciprocal() * number`` (``Tensor.__rtruediv__``) and
    ``tensor / number`` multiplies by the host-computed reciprocal (CUDA's
    CPU-scalar division path)."""
    if isinstance(node, ast.BinOp) and type(node.op) in (*_BINOPS, ast.Div):
        left, right = _c(node.left, scalars, rn), _c(node.right, scalars, rn)
        if isinstance(node.op, ast.Div):
            lscalar = _is_scalar(node.left, scalars)
            rscalar = _is_scalar(node.right, scalars)
            if lscalar and not rscalar:
                return _binop(ast.Mult, f"(1.0 / {right})", left, rn)
            if rscalar and not lscalar:
                return _binop(ast.Mult, left, f"(1.0 / {right})", rn)
            return f"({left} / {right})"
        return _binop(type(node.op), left, right, rn)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return f"(-{_c(node.operand, scalars, rn)})"
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.UAdd):
        return _c(node.operand, scalars, rn)
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return _double(node.value)
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
                return f"inflx_powi({_c(args[0], scalars, rn)}, {n})"
        if (isinstance(func, ast.Name) and func.id == "float" and len(args) == 1
                and isinstance(args[0], ast.Constant)):
            return _double(float(args[0].value))  # float('inf') / float('nan')
        if (isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name)
                and func.value.id == "torch"):
            if func.attr == "tensor" and args:  # a literal for Max/Min/atan2
                return _c(args[0], scalars, rn)
            if func.attr in _C_FUNCS:
                inner = ", ".join(_c(a, scalars, rn) for a in args)
                return f"{_C_FUNCS[func.attr]}({inner})"
    raise NotImplementedError(
        f"no CUDA translation for {ast.unparse(node)!r} of a lowered model "
        "function"
    )


def _function_body(lowered, output: int | None, rn: bool) -> tuple:
    """(CSE lines, return expression) of one output of a lowered function."""
    (fn,) = ast.parse(lowered.source).body
    lines = []
    scalars = set()
    for stmt in fn.body:
        if isinstance(stmt, ast.Assign):
            (target,) = stmt.targets
            if _is_scalar(stmt.value, scalars):
                scalars.add(target.id)
            lines.append(f"  const double {target.id} = {_c(stmt.value, scalars, rn)};\n")
        elif isinstance(stmt, ast.Return):
            value = stmt.value
            if output is not None and isinstance(value, ast.Tuple):
                value = value.elts[output]
            return lines, _c(value, scalars, rn)
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
INFLX_FN double inflx_powi(double b, int n) {
  const bool negative = n < 0;
  if (negative) n = -n;
  if (n == 0) return 1.0;
  double acc = 0.0;
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
  return negative ? 1.0 / acc : acc;
}
// NaN-propagating, as torch.maximum/torch.minimum (C fmax/fmin drop NaN)
INFLX_FN double inflx_max(double a, double b) { return (a != a || a > b) ? a : b; }
INFLX_FN double inflx_min(double a, double b) { return (a != a || a < b) ? a : b; }
INFLX_FN double inflx_sign(double a) { return a > 0.0 ? 1.0 : (a < 0.0 ? -1.0 : a); }

""")


def _prelude(rn: bool) -> str:
    """The header's fixed part; with ``rn`` it includes
    ``csrc/inflx_math.cuh`` and ``inflx_powi`` multiplies through
    ``inflx_mul``."""
    if rn:
        return _PRELUDE.substitute(include='#include "inflx_math.cuh"\n',
                                   acc_b="inflx_mul(acc, b)", b_b="inflx_mul(b, b)")
    return _PRELUDE.substitute(include="", acc_b="acc * b", b_b="b * b")


def _emit_fn(name: str, lowered, output: int | None = None, rn: bool = False) -> str:
    """One ``INFLX_FN double`` function; its parameters are those of the
    lowered function's signature (``x``, ``xdot`` → ``xd``, ``args`` →
    ``p``)."""
    lines, ret = _function_body(lowered, output, rn)
    slots = [{"xdot": "xd", "args": "p"}.get(a, a) for a in lowered.signature]
    params = ", ".join(f"const double* __restrict__ {s}" for s in slots)
    unused = " ".join(f"(void){s};" for s in slots)
    return (
        f"INFLX_FN double {name}({params}) {{\n"
        f"  {unused}\n"
        + "".join(lines)
        + f"  return {ret};\n}}\n\n"
    )


def generate_header(artifact) -> str:
    """Emit the grid/point-scan header for a 2-field :class:`CompiledModel`."""
    if artifact.n_fields != 2:
        raise ValueError("the grid-scan kernel supports 2-field models")
    return (
        _prelude(rn=False)
        + _emit_fn("f_V", artifact.potential)
        + _emit_fn("f_h00", artifact._hesse, 0)
        + _emit_fn("f_h10", artifact._hesse, 2)
        + _emit_fn("f_h11", artifact._hesse, 3)
        + _emit_fn("f_gsq", artifact.grad_square)
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
