"""Per-model CUDA/C++ header for the hand-written grid-scan kernel.

The header defines one function per model quantity the grid scan needs, with
the signature ``(const double* x, const double* p)`` and the registry slots
of :mod:`inflatox_torch.lowering.registry` (``x[i]`` fields, ``p[i]``
parameters):

    f_V    potential V
    f_h00  projected Hesse V_vv
    f_h10  projected Hesse V_wv
    f_h11  projected Hesse V_ww
    f_gsq  |∇V|²

Each body is translated from the model's torch lowering
(:mod:`inflatox_torch.lowering.torch_lowering`) through Python's ``ast``:
the same operations, in the same order, fully parenthesised — integer powers
through ``inflx_powi`` (the lowering's ``_ipow``), the same CSE locals when
the model was compiled with ``cse=True``.  Built without FMA contraction
(see :mod:`inflatox_torch.ops.build`), the kernel therefore rounds exactly
as the plain PyTorch version does, wherever both use the same libm (on the
card: CUDA's).

Every function is marked ``INFLX_FN``: ``__device__ __forceinline__`` under
nvcc, ``static inline`` elsewhere, so the same header also compiles with the
host's C++ compiler (the CPU tests do that).
"""

from __future__ import annotations

import ast
import math

__all__ = ["generate_header"]

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

_BINOPS = {ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/"}


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


def _c(node, scalars=frozenset()) -> str:
    """C expression for one node of a lowered torch function.

    Division follows what torch computes on the card: ``number / tensor``
    is ``tensor.reciprocal() * number`` (``Tensor.__rtruediv__``) and
    ``tensor / number`` multiplies by the host-computed reciprocal (CUDA's
    CPU-scalar division path)."""
    if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
        left, right = _c(node.left, scalars), _c(node.right, scalars)
        if isinstance(node.op, ast.Div):
            lscalar = _is_scalar(node.left, scalars)
            rscalar = _is_scalar(node.right, scalars)
            if lscalar and not rscalar:
                return f"((1.0 / {right}) * {left})"
            if rscalar and not lscalar:
                return f"({left} * (1.0 / {right}))"
        return f"({left} {_BINOPS[type(node.op)]} {right})"
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return f"(-{_c(node.operand, scalars)})"
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.UAdd):
        return _c(node.operand, scalars)
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return _double(node.value)
    if isinstance(node, ast.Name):
        return node.id  # a CSE local
    if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name):
        slot = {"x": "x", "args": "p"}.get(node.value.id)
        index = _int_const(node.slice)
        if slot is not None and index is not None:
            return f"{slot}[{index}]"
    if isinstance(node, ast.Call):
        func, args = node.func, node.args
        if isinstance(func, ast.Name) and func.id == "_ipow" and len(args) == 2:
            n = _int_const(args[1])
            if n is not None:
                return f"inflx_powi({_c(args[0], scalars)}, {n})"
        if (isinstance(func, ast.Name) and func.id == "float" and len(args) == 1
                and isinstance(args[0], ast.Constant)):
            return _double(float(args[0].value))  # float('inf') / float('nan')
        if (isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name)
                and func.value.id == "torch"):
            if func.attr == "tensor" and args:  # a literal for Max/Min/atan2
                return _c(args[0], scalars)
            if func.attr in _C_FUNCS:
                inner = ", ".join(_c(a, scalars) for a in args)
                return f"{_C_FUNCS[func.attr]}({inner})"
    raise NotImplementedError(
        f"no CUDA translation for {ast.unparse(node)!r} of a lowered model "
        "function"
    )


def _function_body(lowered, output: int | None) -> tuple:
    """(CSE lines, return expression) of one output of a lowered function."""
    (fn,) = ast.parse(lowered.source).body
    lines = []
    scalars = set()
    for stmt in fn.body:
        if isinstance(stmt, ast.Assign):
            (target,) = stmt.targets
            if _is_scalar(stmt.value, scalars):
                scalars.add(target.id)
            lines.append(f"  const double {target.id} = {_c(stmt.value, scalars)};\n")
        elif isinstance(stmt, ast.Return):
            value = stmt.value
            if output is not None:
                value = value.elts[output]
            return lines, _c(value, scalars)
    raise ValueError(f"lowered function {lowered.name} has no return")


_PRELUDE = """\
// Generated by inflatox_torch.lowering.cuda_codegen — per-model functions
// for the grid-scan kernel (csrc/grid_scan.cu), translated from the model's
// torch lowering.
#pragma once
#include <math.h>

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
      acc = have ? acc * b : b;
      have = true;
    }
    n >>= 1;
    if (!n) break;
    b = b * b;
  }
  return negative ? 1.0 / acc : acc;
}
// NaN-propagating, as torch.maximum/torch.minimum (C fmax/fmin drop NaN)
INFLX_FN double inflx_max(double a, double b) { return (a != a || a > b) ? a : b; }
INFLX_FN double inflx_min(double a, double b) { return (a != a || a < b) ? a : b; }
INFLX_FN double inflx_sign(double a) { return a > 0.0 ? 1.0 : (a < 0.0 ? -1.0 : a); }

"""


def _emit_fn(name: str, lowered, output: int | None = None) -> str:
    lines, ret = _function_body(lowered, output)
    return (
        f"INFLX_FN double {name}(const double* __restrict__ x, "
        "const double* __restrict__ p) {\n"
        "  (void)x; (void)p;\n"
        + "".join(lines)
        + f"  return {ret};\n}}\n\n"
    )


def generate_header(artifact) -> str:
    """Emit the header for a 2-field :class:`CompiledModel`."""
    if artifact.n_fields != 2:
        raise ValueError("the grid-scan kernel supports 2-field models")
    return (
        _PRELUDE
        + _emit_fn("f_V", artifact.potential)
        + _emit_fn("f_h00", artifact._hesse, 0)
        + _emit_fn("f_h10", artifact._hesse, 2)
        + _emit_fn("f_h11", artifact._hesse, 3)
        + _emit_fn("f_gsq", artifact.grad_square)
    )
