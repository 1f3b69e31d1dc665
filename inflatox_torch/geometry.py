"""Field-space geometry surfaces: Christoffels, Riemann, Ricci, coordinate
covariant Hesse — lowered to torch callables on first use.

The port of ``inflatox_tpu/geometry.py``.  The scan kernels work with the
*projected* (vielbein) Hesse; curvature-dependent analyses need the
coordinate-basis objects instead: the multi-field perturbation mass matrix
contracts ``R^a_{bcd} χ^b χ^c``, and transport-equation methods evolve
coordinate-space mode matrices.  This module derives those objects
symbolically from the model's metric (sympy ``diff`` only — no
simplification passes, which do not terminate on D5/EGNO-class expressions)
and lowers them through the same sympy → torch printer as every other model
function (:mod:`inflatox_torch.lowering.torch_lowering`), so they are
differentiable under autograd and shape-polymorphic (points or grids) like
the rest of :class:`~inflatox_torch.compiler.CompiledModel`.  A metric with
special functions lowers them through :mod:`inflatox_torch.lowering.special`,
as the Hesse does.

Conventions (MTW/Wald):

* ``Γ^a_{bc} = ½ g^{ad} (∂_b g_{dc} + ∂_c g_{bd} − ∂_d g_{bc})``
* ``R^a_{bcd} = ∂_c Γ^a_{db} − ∂_d Γ^a_{cb} + Γ^a_{ce} Γ^e_{db}
  − Γ^a_{de} Γ^e_{cb}``  (so the unit 2-sphere has Ricci scalar +2)
* ``V_{;ab} = ∂_a ∂_b V − Γ^c_{ab} ∂_c V``  (the covariant Hesse the
  builder projects)

Everything lowers lazily from the model bundle, so loaded bundles
(:meth:`CompiledModel.load`) get these surfaces without a schema change.
The surfaces compute on the device of their inputs (float64 tensors, as the
artifact's own functions take them).
"""

from __future__ import annotations

import sympy
import torch

__all__ = [
    "Geometry",
    "christoffel_exprs",
    "riemann_exprs",
    "ricci_scalar_expr",
    "hesse_coord_exprs",
]


def _metric_inverse(model) -> sympy.Matrix:
    # adjugate/det — pure arithmetic.  The default inv() (DM/GE) runs
    # pivot zero-testing through the assumption engine, which is the class
    # of sympy call that never terminates on D5/EGNO-scale entries
    return sympy.Matrix(model.metric).inv(method="ADJ")


def christoffel_exprs(model) -> list:
    """``Γ^a_{bc}`` as a nested d×d×d list of sympy expressions."""
    d = model.dim
    x = model.coordinates
    g = sympy.Matrix(model.metric)
    ginv = _metric_inverse(model)
    dg = [
        [[sympy.diff(g[a, b], x[c]) for c in range(d)] for b in range(d)]
        for a in range(d)
    ]
    gamma = [[[None] * d for _ in range(d)] for _ in range(d)]
    for a in range(d):
        for b in range(d):
            for c in range(d):
                s = sympy.Integer(0)
                for e in range(d):
                    s = s + ginv[a, e] * (dg[e][c][b] + dg[b][e][c] - dg[b][c][e])
                gamma[a][b][c] = s / 2
    return gamma


def riemann_exprs(model, gamma=None) -> list:
    """``R^a_{bcd}`` as a nested d⁴ list (convention in the module docs)."""
    d = model.dim
    x = model.coordinates
    gamma = christoffel_exprs(model) if gamma is None else gamma
    riem = [
        [[[None] * d for _ in range(d)] for _ in range(d)] for _ in range(d)
    ]
    for a in range(d):
        for b in range(d):
            for c in range(d):
                for dd in range(d):
                    s = sympy.diff(gamma[a][dd][b], x[c]) - sympy.diff(
                        gamma[a][c][b], x[dd]
                    )
                    for e in range(d):
                        s = s + gamma[a][c][e] * gamma[e][dd][b]
                        s = s - gamma[a][dd][e] * gamma[e][c][b]
                    riem[a][b][c][dd] = s
    return riem


def ricci_scalar_expr(model, riem=None) -> sympy.Expr:
    """``R = g^{bd} R^a_{bad}`` (unit 2-sphere → +2)."""
    d = model.dim
    riem = riemann_exprs(model) if riem is None else riem
    ginv = _metric_inverse(model)
    s = sympy.Integer(0)
    for b in range(d):
        for dd in range(d):
            ric = sympy.Integer(0)
            for a in range(d):
                ric = ric + riem[a][b][a][dd]
            s = s + ginv[b, dd] * ric
    return s


def hesse_coord_exprs(model, gamma=None) -> list:
    """Coordinate-basis covariant Hesse ``V_{;ab}`` (d×d list) — the object
    the builder projects onto the vielbein; here kept unprojected for
    curvature/perturbation work."""
    d = model.dim
    x = model.coordinates
    gamma = christoffel_exprs(model) if gamma is None else gamma
    grad = [sympy.diff(model.potential, x[a]) for a in range(d)]
    hesse = [[None] * d for _ in range(d)]
    for a in range(d):
        for b in range(d):
            s = sympy.diff(grad[a], x[b])
            for c in range(d):
                s = s - gamma[c][a][b] * grad[c]
            hesse[a][b] = s
    return hesse


class Geometry:
    """Lazily-lowered geometry callables for a compiled model.

    Construct from any :class:`~inflatox_torch.compiler.CompiledModel`
    (including loaded bundles); each surface derives its sympy expressions
    and lowers them on first call, then caches the callable.  All methods
    take ``(x, args)`` like the artifact's own functions — ``x`` a (d,)
    float64 tensor or a sequence of broadcastable float64 tensors, ``args``
    a (k,) float64 tensor on the same device — and return float64 tensors
    on that device, with the grid axes trailing.
    """

    def __init__(self, artifact):
        self._art = artifact
        self._fns: dict = {}
        self._gamma_exprs = None
        self._riemann_exprs = None

    @property
    def _gamma(self):
        if self._gamma_exprs is None:
            self._gamma_exprs = christoffel_exprs(self._art.model)
        return self._gamma_exprs

    @property
    def _riemann(self):
        # cached: the d⁴ nested diff over /det-laden Christoffels is
        # minutes of single-core sympy on D5/EGNO-class metrics
        if self._riemann_exprs is None:
            self._riemann_exprs = riemann_exprs(
                self._art.model, gamma=self._gamma
            )
        return self._riemann_exprs

    def _lowered(self, key, exprs_builder):
        fn = self._fns.get(key)
        if fn is None:
            from .lowering.torch_lowering import lower  # noqa: PLC0415

            fn = lower(
                exprs_builder(), self._art._registry, signature=("x", "args"),
                name=key, **self._art._cse_opts,
            )
            self._fns[key] = fn
        return fn

    @staticmethod
    def _stack(flat, dims, x):
        """Stack lowered components into shape dims + broadcast-shape.
        Identically-zero (or constant) components lower to Python numbers
        while the rest ride the grid shape, so broadcast everything up to
        the x tensors' common shape, on their device, in float64 — a flat
        metric must still honor the documented trailing-grid-axes (and
        float) contract."""
        from .compiler import _grid_refs, _stack_f64  # noqa: PLC0415

        out = _stack_f64(flat, *_grid_refs(x))
        return out.reshape(tuple(dims) + tuple(out.shape[1:]))

    def christoffels(self, x, args):
        """``Γ^a_{bc}(x)``, shape (d, d, d[, *grid])."""
        d = self._art.n_fields
        flat = self._lowered(
            "christoffels",
            lambda: [self._gamma[a][b][c]
                     for a in range(d) for b in range(d) for c in range(d)],
        )(x, args)
        return self._stack(flat, (d, d, d), x)

    def riemann(self, x, args):
        """``R^a_{bcd}(x)``, shape (d, d, d, d[, *grid])."""
        d = self._art.n_fields

        def build():
            riem = self._riemann
            return [riem[a][b][c][e] for a in range(d) for b in range(d)
                    for c in range(d) for e in range(d)]

        flat = self._lowered("riemann", build)(x, args)
        return self._stack(flat, (d, d, d, d), x)

    def ricci_scalar(self, x, args) -> torch.Tensor:
        """Ricci scalar ``R(x)``, shape ``()`` at a point or the grid's
        shape.  A constant-curvature space lowers to a literal; it is still
        returned as a float64 tensor of the grid's shape on its device."""
        value = self._lowered(
            "ricci_scalar",
            lambda: [ricci_scalar_expr(self._art.model, riem=self._riemann)],
        )(x, args)
        return self._stack(value, (), x)

    def hesse(self, x, args):
        """Coordinate covariant Hesse ``V_{;ab}(x)``, shape (d, d[, *grid]).
        Contracting with the artifact's vielbein reproduces the projected
        Hesse: ``e_i^a e_j^b V_{;ab} = artifact.hesse(x, args)[i, j]``."""
        d = self._art.n_fields
        flat = self._lowered(
            "hesse_coord",
            lambda: [e for row in hesse_coord_exprs(
                self._art.model, gamma=self._gamma) for e in row],
        )(x, args)
        return self._stack(flat, (d, d), x)
