"""Symbol registry: the x[i] / xdot[i] / args[i] indexing contract.

The reference maps every sympy symbol in a model to an array slot during C
code generation (compiler.py:37-120): field symbols → ``x[i]`` (in field
order), field-derivative symbols → ``xdot[i]``, every other free symbol →
``args[i]`` **in the order the symbol is first encountered while printing**
(compiler.py:102-106).  The resulting ``symbol_dictionary`` is the only
contract telling users which parameter lands in which ``args`` slot
(compiler.py:215-276), so the rebuild must reproduce the ordering exactly.

To guarantee byte-identical parameter ordering, :class:`SymbolRegistry` runs
the same kind of registration pass the reference does: a
``C99CodePrinter``-driven traversal over the model expressions in the
reference's emission order (compiler.py:474-539 → V, metric/inner_prod, Hesse
components, basis vectors, |∇V|², eom, eomh, eomhdot).  Only the registration
side effect is kept; the printed C is discarded.  The torch lowering and the
CUDA header generator then use the frozen ordering.

Scope of the byte-compatibility claim: artifacts the reference compiled with
``cse=False`` (its default).  With ``cse=True`` the reference prints CSE
definitions *before* the plain expression, so a symbol whose first appearance
is inside a hoisted subexpression can claim an earlier ``args`` slot than this
plain-order replay assigns (docs/divergences.md item 5).  The ordering here is
deterministic and queryable either way — only cross-loading parameter arrays
*positionally* from a reference cse=True artifact needs care (use the symbol
dictionary, which both sides provide).
"""

from __future__ import annotations

import sympy
from sympy.printing.c import C99CodePrinter

__all__ = ["SymbolRegistry"]


class _RegistrationPrinter(C99CodePrinter):
    """C99 printer whose only job is to record symbol encounter order."""

    def __init__(self, registry: "SymbolRegistry", settings=None):
        super().__init__(settings)
        self._registry = registry

    def _print_Symbol(self, expr):
        name = super()._print_Symbol(expr)
        self._registry._touch(expr, name)
        return name

    def _print_not_supported(self, expr):
        # Registration cares only about symbol traversal: functions the C
        # printer can't express (Bessel/hypergeometric — the reference
        # delegates those to its GSL printer, compiler.py:123-212) still get
        # their arguments walked in order.
        for arg in expr.args:
            self._print(arg)
        return "0"


class SymbolRegistry:
    """Deterministic symbol → slot mapping for a model.

    Attributes
    ----------
    coord_names / dotcoord_names:
        C-printed names of the field and tangent symbols, in field order.
    param_names:
        C-printed names of the parameters, in registration order.
    symbol_dictionary:
        mapping ``printed name → "x[i]" | "args[i]"`` — byte-compatible with
        the reference's ``CompilationArtifact.symbol_dictionary``
        (compiler.py:564-566: coordinates first, then parameters; note the
        reference does *not* include xdot entries in the dictionary).
    """

    def __init__(self, coordinates, tangents):
        c_print = C99CodePrinter()._print_Symbol
        self._coord_slots = {}
        self._dot_slots = {}
        self._param_slots: dict = {}
        self.coord_names = []
        self.dotcoord_names = []
        self.param_names: list = []
        self._printer = _RegistrationPrinter(self)
        for i, s in enumerate(coordinates):
            name = c_print(s)
            self._coord_slots[name] = i
            self.coord_names.append(name)
        for i, s in enumerate(tangents):
            name = c_print(s)
            self._dot_slots[name] = i
            self.dotcoord_names.append(name)

    # -- registration pass -------------------------------------------------- #

    def _touch(self, symbol: sympy.Symbol, name: str) -> None:
        if name.startswith("cse"):
            return  # CSE locals are never registered (compiler.py:111-112)
        if name in self._coord_slots or name in self._dot_slots:
            return
        if name not in self._param_slots:
            self._param_slots[name] = len(self._param_slots)
            self.param_names.append(name)

    def register_exprs(self, exprs) -> None:
        """Walk ``exprs`` (in order), registering unseen free symbols.

        The traversal order within each expression is the C99 printer's —
        the same order the reference uses, so ``args`` indices match."""
        for expr in exprs:
            self._printer.doprint(sympy.sympify(expr))

    @classmethod
    def from_model(cls, model) -> "SymbolRegistry":
        """Build a registry by replaying the reference's emission order
        (compiler.py:474-539)."""
        reg = cls(model.coordinates, model.coordinate_tangents)
        seq = [model.potential]
        for row in model.metric:
            seq.extend(row)
        for row in model.hesse_cmp:
            seq.extend(row)
        for vec in model.basis:
            seq.extend(vec)
        seq.append(model.gradient_square)
        seq.extend(model.eom_fields)
        seq.append(model.eom_h)
        seq.append(model.eom_hdot)
        reg.register_exprs(seq)
        return reg

    # -- lookups ------------------------------------------------------------ #

    @property
    def n_fields(self) -> int:
        return len(self._coord_slots)

    @property
    def n_parameters(self) -> int:
        return len(self._param_slots)

    @property
    def symbol_dictionary(self) -> dict:
        out = {name: f"x[{i}]" for name, i in self._coord_slots.items()}
        out.update({name: f"args[{i}]" for name, i in self._param_slots.items()})
        return out

    def slot(self, symbol: sympy.Symbol) -> tuple[str, int] | None:
        """(kind, index) for a symbol, where kind ∈ {"x", "xdot", "args"}.

        Returns ``None`` for unknown symbols (they would have to be registered
        first) and for CSE locals."""
        name = C99CodePrinter()._print_Symbol(symbol)
        if name.startswith("cse"):
            return None
        if name in self._coord_slots:
            return ("x", self._coord_slots[name])
        if name in self._dot_slots:
            return ("xdot", self._dot_slots[name])
        if name in self._param_slots:
            return ("args", self._param_slots[name])
        return None
