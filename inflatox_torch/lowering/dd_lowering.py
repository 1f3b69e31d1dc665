"""Model functions in double-double: the torch lowering's source, compiled
against :mod:`inflatox_torch.ops.dd`.

The counterpart of ``inflatox_tpu/lowering/tf32.py:compile_tf32``, which
re-executes a lowered source against triple-f32 implementations of
``jax.numpy``.  Here the source of a :class:`LoweredFunction` is rewritten
(Python ``ast``) and executed against a namespace whose ``torch`` holds the
double-double functions:

* every numeric literal becomes a double-double constant, so constant
  subexpressions are evaluated in double-double as well: ``(1/6)*x`` divides
  1 by 6 to about 106 bits, where the f64 lowering rounds 1/6 to f64 first.
  The exponent of ``_ipow`` stays a Python int (repeated squaring);
* ``+ - * /`` and unary minus act on :class:`~inflatox_torch.ops.dd.DD`;
* ``sqrt``, ``exp``, ``log``, ``pow``, ``abs``, ``maximum``, ``minimum``
  are double-double; every other function is evaluated in f64 on the
  rounded value (``hi + lo``) and returned with ``lo = 0``.

The CUDA header of kernels B4 and B5b
(:func:`inflatox_torch.lowering.cuda_codegen.generate_header` with
``precision="dd"``) translates the same rewritten tree call for call, so both
evaluate the same operations in the same order.
"""

from __future__ import annotations

import ast
import sys
import types

import torch

from ..ops.dd import (
    DD,
    as_dd,
    dd_abs,
    dd_exp,
    dd_ipow,
    dd_log,
    dd_max,
    dd_min,
    dd_pow,
    dd_sqrt,
    to_f64,
)

__all__ = ["DEMOTED", "compile_dd", "dd_tree"]

#: torch functions of the lowered source that are evaluated in f64
DEMOTED = ("sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh",
           "asinh", "acosh", "atanh", "floor", "ceil", "sign")


class _Constants(ast.NodeTransformer):
    """Numeric literals → ``_c(literal)`` (a double-double constant); slot
    indices, the exponent of ``_ipow`` and the argument of ``float()`` are
    left as they are."""

    def visit_Call(self, node):
        func = node.func
        if isinstance(func, ast.Name) and func.id == "float":
            return node
        if isinstance(func, ast.Name) and func.id == "_ipow":
            node.args[0] = self.visit(node.args[0])
            return node
        return self.generic_visit(node)

    def visit_Subscript(self, node):
        return node  # x[0], args[1]: slots, not numbers

    def visit_Constant(self, node):
        if isinstance(node.value, (int, float)) and not isinstance(node.value, bool):
            return ast.Call(func=ast.Name(id="_c", ctx=ast.Load()), args=[node], keywords=[])
        return node


def dd_tree(lowered) -> ast.FunctionDef:
    """The lowered function's tree with its literals made double-double
    constants (shared by :func:`compile_dd` and the CUDA translation)."""
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100_000))
    try:
        (fn,) = ast.parse(lowered.source).body
        fn = _Constants().visit(fn)
        return ast.fix_missing_locations(fn)
    finally:
        sys.setrecursionlimit(old)


def _demote(fn):
    def run(*args):
        vals = [to_f64(as_dd(a)) for a in args]
        vals = [v if torch.is_tensor(v) else torch.tensor(v, dtype=torch.float64) for v in vals]
        return DD(fn(*vals), 0.0)

    return run


def _namespace() -> types.SimpleNamespace:
    funcs = {name: _demote(getattr(torch, name)) for name in DEMOTED}
    return types.SimpleNamespace(
        sqrt=dd_sqrt, exp=dd_exp, log=dd_log, pow=dd_pow, abs=dd_abs,
        maximum=dd_max, minimum=dd_min, atan2=_demote(torch.atan2),
        tensor=lambda value, dtype=None: as_dd(value), float64=torch.float64,
        **funcs,
    )


def compile_dd(lowered):
    """A callable evaluating ``lowered`` in double-double: it takes the same
    positional sequences (of :class:`DD`, f64 tensors or numbers) and
    returns a :class:`DD` or a tuple of them."""
    tree = ast.Module(body=[dd_tree(lowered)], type_ignores=[])
    namespace = {"torch": _namespace(), "_ipow": dd_ipow,
                 "_c": lambda v: DD(float(v), 0.0)}
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100_000))
    try:
        code = compile(tree, f"<inflatox-dd:{lowered.name}>", "exec")
    finally:
        sys.setrecursionlimit(old)
    exec(code, namespace)
    inner = namespace[lowered.name]

    def run(*seqs):
        return inner(*[[as_dd(v) for v in s] for s in seqs])

    return run
