"""Compiler: lower an :class:`InflationModel` to a bundle of torch callables.

The counterpart of ``inflatox_tpu/compiler.py``: the same ``Compiler`` /
``CompiledModel`` surface (potential, grad_square, grad, hesse, basis,
metric, inner_prod, eom, eom_h, eom_hdot, the symbol table) and the same
schema-guarded JSON bundle, so a bundle written by either package loads into
the other.  Beyond the JAX package, :meth:`CompiledModel.cuda_source` and
:meth:`CompiledModel.cuda_solver_source` emit the per-model headers that the
hand-written CUDA grid-scan and solver kernels include.

Of the JAX package's emulation bundles only ``tf_fns`` (triple-f32, for
EGNO-class cancellation) has a counterpart, :meth:`CompiledModel.dd_fns`
(double-double).  ``df32_fns``, ``edf_fns``, ``solver_df32_fns`` and
``df32_compatible`` have none: Hopper computes in native IEEE f64, with the
full exponent range.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import sympy
import torch

from .lowering import SymbolRegistry, lower
from .symbolic import InflationModel
from .utils.errors import SchemaVersionError
from .utils.logging import log_info
from .version import __schema_version__, schema_compatible

__all__ = ["Compiler", "CompiledModel", "CompilationArtifact"]


def _stack_f64(values, *like) -> torch.Tensor:
    """Stack lowered outputs into one float64 tensor.

    A constant output comes back from the lowering as a Python number; it is
    broadcast to the common shape (and device) of the tensor outputs and of
    the tensors in ``like`` (the inputs) before stacking."""
    tensors = [v for v in values if torch.is_tensor(v)]
    ref = [t for t in like if torch.is_tensor(t)]
    device = (tensors or ref or [torch.empty(0)])[0].device
    shape = torch.broadcast_shapes(*[t.shape for t in tensors + ref])
    return torch.stack([
        torch.as_tensor(v, dtype=torch.float64, device=device).broadcast_to(shape)
        for v in values
    ])


def _grid_refs(x) -> tuple:
    """The coordinate tensors of ``x``: the entries of a sequence, or the
    first element of a 1-D point tensor (broadcast shape ``()``)."""
    if torch.is_tensor(x):
        return (x[0],)
    return tuple(x)


class CompiledModel:
    """A model lowered to torch callables.

    All callables are elementwise and shape-polymorphic: ``x``/``xdot`` may
    be a 1-D float64 tensor for point evaluation or a sequence of
    broadcastable float64 tensors for grid evaluation, ``args`` a 1-D
    float64 tensor on the same device."""

    def __init__(
        self,
        model: InflationModel,
        registry: SymbolRegistry,
        *,
        cse: bool = False,
        max_cses: int = 1000,
        silent: bool = True,
    ):
        self._model = model
        self._registry = registry
        self._cse_opts = {"cse": cse, "max_cses": max_cses}
        self._cuda_source = {}
        self._cuda_solver_source = None
        self._dd_fns = None
        self.model_name = model.model_name
        self.n_fields = model.dim
        self.n_parameters = registry.n_parameters
        self.symbol_dictionary = registry.symbol_dictionary

        d = model.dim
        lo = lambda exprs, sig, name: lower(  # noqa: E731
            exprs, registry, signature=sig, name=name, **self._cse_opts
        )

        if not silent:
            log_info(f'Lowering model "{model.model_name}" to torch...')

        self.potential = lo(model.potential, ("x", "args"), "potential")
        self.grad_square = lo(model.gradient_square, ("x", "args"), "grad_square")

        # raw gradient ∂_a V (not part of the reference ABI)
        raw_grad = [sympy.diff(model.potential, f) for f in model.coordinates]
        self._grad = lo(raw_grad, ("x", "args"), "grad")

        # projected Hesse: all d² components in one lowered function
        flat_hesse = [model.hesse_cmp[a][b] for a in range(d) for b in range(d)]
        self._hesse = lo(flat_hesse, ("x", "args"), "hesse")

        # vielbein basis: d vectors × d components, flattened row-major
        flat_basis = [c for vec in model.basis for c in vec]
        self._basis = lo(flat_basis, ("x", "args"), "basis")

        # metric (for inner products); zero entries elided at lowering time
        self._metric_nonzero = [
            (a, b)
            for a in range(d)
            for b in range(d)
            if sympy.sympify(model.metric[a][b]) != 0
        ]
        nonzero_exprs = [model.metric[a][b] for a, b in self._metric_nonzero]
        self._metric = lo(nonzero_exprs or [sympy.Integer(0)], ("x", "args"), "metric")

        self.eom = lo(list(model.eom_fields), ("x", "xdot", "args"), "eom")
        self.eom_h = lo(model.eom_h, ("x", "xdot", "args"), "eom_h")
        self.eom_hdot = lo(model.eom_hdot, ("x", "xdot", "args"), "eom_hdot")

        if not silent:
            log_info(
                f"Lowered {2 + 1 + d * d + d * d + len(nonzero_exprs) + d + 2} "
                f"expressions ({self.n_parameters} parameters)."
            )

    # ------------------------------------------------------------------ #
    # structured evaluation helpers                                      #
    # ------------------------------------------------------------------ #

    def hesse(self, x, args) -> torch.Tensor:
        """Projected Hesse matrix, shape (d, d[, *grid])."""
        d = self.n_fields
        flat = _stack_f64(self._hesse(x, args), *_grid_refs(x))
        return flat.reshape(d, d, *flat.shape[1:])

    def hesse_tuple(self, x, args):
        """Projected Hesse components as a flat row-major tuple (constant
        components stay Python numbers)."""
        return self._hesse(x, args)

    def basis(self, x, args) -> torch.Tensor:
        """Vielbein basis, shape (d, d[, *grid]): ``basis[0]`` = v (normalized
        gradient), ``basis[i>0]`` = w_i."""
        d = self.n_fields
        flat = _stack_f64(self._basis(x, args), *_grid_refs(x))
        return flat.reshape(d, d, *flat.shape[1:])

    def basis_tuple(self, x, args):
        return self._basis(x, args)

    def grad(self, x, args) -> torch.Tensor:
        """Raw potential gradient ∂_a V, shape (d[, *grid])."""
        return _stack_f64(self._grad(x, args), *_grid_refs(x))

    def inner_prod(self, x, args, v1, v2):
        """G_ab(x) v1^a v2^b — zero metric entries elided at compile time."""
        g = self._metric(x, args)
        total = 0.0
        for k, (a, b) in enumerate(self._metric_nonzero):
            total = total + g[k] * v1[a] * v2[b]
        return total

    def metric(self, x, args) -> torch.Tensor:
        """Metric tensor G_ab(x), shape (d, d[, *grid])."""
        d = self.n_fields
        g = _stack_f64(self._metric(x, args), *_grid_refs(x))
        zero = torch.zeros_like(g[0])
        rows = [[zero] * d for _ in range(d)]
        for k, (a, b) in enumerate(self._metric_nonzero):
            rows[a][b] = g[k]
        return torch.stack([torch.stack(r) for r in rows])

    def cuda_source(self, precision: str = "f64") -> str:
        """The per-model CUDA/C++ header the grid-scan kernels include
        (``f_V``, ``f_hesse``, ``f_gsq``, ``f_grad``) in ``precision``
        (``"f64"``, ``"f32"`` or ``"dd"``), memoised per precision."""
        if precision not in self._cuda_source:
            from .lowering.cuda_codegen import generate_header  # noqa: PLC0415

            self._cuda_source[precision] = generate_header(self, precision)
        return self._cuda_source[precision]

    @property
    def uses_special_functions(self) -> bool:
        """True if a lowered model function calls a special function, so
        that the model's kernels carry kernel B8 (``csrc/special.cuh``)."""
        fns = (self.potential, self.grad_square, self._grad, self._hesse,
               self.eom_h, self.eom, self.eom_hdot)
        return any("_special." in fn.source for fn in fns)

    def dd_fns(self) -> dict:
        """The model functions in double-double (the counterpart of the JAX
        package's ``tf_fns``): ``potential``, ``grad_square``, ``grad`` and
        ``hesse`` (the flat tuple), each taking sequences of
        :class:`~inflatox_torch.ops.dd.DD` and returning DD values;
        memoised."""
        if self._dd_fns is None:
            from .lowering.dd_lowering import compile_dd  # noqa: PLC0415

            self._dd_fns = {
                "potential": compile_dd(self.potential),
                "grad_square": compile_dd(self.grad_square),
                "grad": compile_dd(self._grad),
                "hesse": compile_dd(self._hesse),
            }
        return self._dd_fns

    def cuda_solver_source(self) -> str:
        """The per-model CUDA/C++ header the background-solver kernel
        includes (``f_eom_h``, ``inflx_deriv`` and ``INFLX_NF``), for any
        field count, memoised."""
        if self._cuda_solver_source is None:
            from .lowering.cuda_codegen import generate_solver_header  # noqa: PLC0415

            self._cuda_solver_source = generate_solver_header(self)
        return self._cuda_solver_source

    # ------------------------------------------------------------------ #
    # symbol table (reference compiler.py:252-276)                       #
    # ------------------------------------------------------------------ #

    def lookup_symbol(self, symbol: sympy.Symbol) -> str | None:
        """Compiled slot ("x[n]" / "args[n]") for a sympy symbol, or None."""
        from sympy.printing.c import C99CodePrinter  # noqa: PLC0415

        name = C99CodePrinter()._print_Symbol(symbol)
        if not isinstance(name, str):
            return None
        return self.symbol_dictionary.get(name)

    def print_sym_lookup_table(self) -> None:
        print("[Symbol Dictionary]")
        for old, new in self.symbol_dictionary.items():
            print(f"{old} -> {new}")

    # ------------------------------------------------------------------ #
    # serialization (compile-once / scan-many)                           #
    # ------------------------------------------------------------------ #

    @property
    def model(self) -> InflationModel:
        return self._model

    def save(self, path: str) -> None:
        """Write a JSON bundle that :meth:`load` (of this package or of
        ``inflatox_tpu``) can re-lower without re-running the symbolic
        stage."""
        bundle = {
            "schema_version": __schema_version__,
            "options": dict(self._cse_opts),
            "model": self._model.to_dict(),
        }
        with open(path, "w") as f:
            json.dump(bundle, f)

    @classmethod
    def load(cls, path: str) -> "CompiledModel":
        with open(path) as f:
            bundle = json.load(f)
        found = bundle.get("schema_version", "0.0.0")
        if not schema_compatible(found):
            raise SchemaVersionError(found, __schema_version__)
        model = InflationModel.from_dict(bundle["model"])
        registry = SymbolRegistry.from_model(model)
        return cls(model, registry, **bundle.get("options", {}))


#: Drop-in alias for users porting from the reference API.
CompilationArtifact = CompiledModel


class Compiler:
    """Lowers an :class:`InflationModel` into a :class:`CompiledModel`.

    Constructor surface matches the reference ``Compiler``
    (compiler.py:315-382) and ``inflatox_tpu.Compiler``.

    Args
    ----
    model: the symbolic model to compile.
    output_path: if given, :meth:`compile` also saves the serialized bundle
        to this path.
    cleanup: with ``output_path`` set, remove the bundle at interpreter exit
        (``cleanup=False`` keeps it).
    silent: suppress console output.
    link_gsl: accepted for compatibility; there is no separate link step.
    cse: run sympy common-subexpression elimination before lowering.
    max_cses: cap on CSE symbols (reference compiler.py:354-356).
    compiler_flags: accepted for compatibility and ignored; the CUDA
        kernel's nvcc flags are fixed by :mod:`inflatox_torch.ops.build`.
    """

    def __init__(
        self,
        model: InflationModel,
        output_path: str | None = None,
        cleanup: bool = True,
        silent: bool = False,
        link_gsl: bool = False,
        cse: bool = False,
        max_cses: int = 1000,
        compiler_flags: Sequence[str] | None = None,
    ):
        self.model = model
        self.output_path = output_path
        self.cleanup = cleanup
        self.silent = silent
        self.link_gsl = link_gsl
        self.cse = cse
        self.max_cses = max_cses
        if compiler_flags is not None and not silent:
            log_info(
                "compiler_flags are ignored (the kernel's nvcc flags are "
                "fixed); accepted for API compatibility."
            )

    def compile(self) -> CompiledModel:
        """Lower the model; returns a :class:`CompiledModel`."""
        if not self.silent:
            print("Compiling model...")
        registry = SymbolRegistry.from_model(self.model)
        compiled = CompiledModel(
            self.model,
            registry,
            cse=self.cse,
            max_cses=self.max_cses,
            silent=self.silent,
        )
        if self.output_path is not None:
            compiled.save(self.output_path)
            if self.cleanup:
                import atexit  # noqa: PLC0415

                path = self.output_path
                atexit.register(lambda: os.path.exists(path) and os.remove(path))
        return compiled
