"""Symbolic engine: derive all model quantities from (fields, metric, V).

This is the host-side (CPU, sympy) stage of the pipeline.  It reproduces the
capabilities of the reference's ``python/inflatox/symbolic.py``:

* :class:`InflationModel` — container of all symbolic quantities
  (reference symbolic.py:30-99),
* :class:`InflationModelBuilder` — derives the normalized-gradient vielbein
  basis, Christoffel symbols, covariant Hesse matrix projected on the basis,
  |∇V|², per-field equations of motion, and the Hubble constraint/EoM
  (reference symbolic.py:109-726).

The math is identical.  This module is the PyTorch port's copy of
``inflatox_tpu/symbolic.py`` with the same behaviour: the output of this
stage feeds the sympy→torch lowering and the CUDA header generator in
:mod:`inflatox_torch.compiler` instead of a C transpiler.

Documented divergences from the reference (see also tests/test_symbolic.py):

* ``compute_eom_h`` includes the textbook ½ factor in
  ``H = sqrt((V + ½ G_ab χ^a χ^b)/3)``.  The reference's code omits the ½
  (symbolic.py:707-711) even though its own docstring (symbolic.py:704-705)
  and the Rust solver's Hubble equation (background_solver.rs:57-59,
  ``g = V - 3H²`` which equals Ḣ only when 3H² = V + ½σ̇²) require it.
* simplification timeouts use ``signal.setitimer`` directly instead of the
  ``interruptingcow`` dependency; semantics are the same (graceful fallback
  to the unsimplified expression, disabled off the main thread / on Windows),
  and the deadline is checked again when the guarded call returns, so a
  swallowed SIGALRM cannot let it pass as in time.
"""

from __future__ import annotations

import contextlib
import os
import signal
import threading
import time
from dataclasses import dataclass, field

import sympy
from sympy.simplify.sqrtdenest import sqrtdenest

from .utils.errors import SimplificationTimeOut
from .utils.logging import log_warn

__all__ = ["InflationModel", "InflationModelBuilder", "SimplificationTimeOut"]


# --------------------------------------------------------------------------- #
# timeout machinery                                                           #
# --------------------------------------------------------------------------- #


def _timeouts_supported() -> bool:
    """SIGALRM timeouts only work on the main thread of a POSIX process.

    The reference disables simplification wholesale on Windows
    (symbolic.py:177-190); we additionally degrade gracefully when running on
    a worker thread (e.g. under joblib)."""
    return (
        os.name != "nt"
        and threading.current_thread() is threading.main_thread()
        and hasattr(signal, "SIGALRM")
    )


@contextlib.contextmanager
def _time_limit(seconds: float):
    """Raise :class:`SimplificationTimeOut` if the body runs too long.

    SIGALRM interrupts the body; but the exception the handler raises can
    land in a GC or C-level callback that swallows it, and the body then
    runs on and returns.  So the deadline is checked again after the body
    returns: a body that finished late raises all the same."""
    if not _timeouts_supported() or seconds <= 0:
        yield
        return

    def _handler(signum, frame):
        raise SimplificationTimeOut()

    deadline = time.monotonic() + seconds
    previous = signal.signal(signal.SIGALRM, _handler)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, previous)
    if time.monotonic() >= deadline:
        raise SimplificationTimeOut()


_TIMEOUT_MSG = (
    "Simplification step timed out (>{}s)!\n"
    "Consider increasing the simplification time-out time or turning off "
    "simplifications."
)


# --------------------------------------------------------------------------- #
# InflationModel                                                              #
# --------------------------------------------------------------------------- #


@dataclass
class InflationModel:
    """All symbolic quantities describing a multi-field inflation model.

    Reference parity: ``InflationModel`` (symbolic.py:30-99).  Field names are
    kept identical so downstream code ports over unchanged.

    Attributes
    ----------
    model_name:
        human-readable name.
    coordinates:
        the field symbols φ^a (coordinates on the scalar manifold).
    coordinate_tangents:
        symbols for the field time-derivatives χ^a (auto-generated by the
        builder as ``\\dot{...}`` symbols).
    basis:
        orthonormal vielbein: ``basis[0]`` is the normalized potential
        gradient v, ``basis[i>0]`` the orthogonal complements w_i
        (contravariant components).
    eom_fields:
        per-field expression ``Γ^a_bc χ^b χ^c + g^ab ∂_b V`` such that the
        equation of motion reads ``χ'^a + eom_fields[a] + 3H χ^a = 0``
        (the −3Hχ friction term is added by the solver, matching
        background_solver.rs:50-53).
    eom_h:
        Hubble constraint ``H = sqrt((V + ½ G_ab χ^a χ^b)/3)``.
    eom_hdot:
        ``H' = −½ G_ab χ^a χ^b``.
    potential, metric:
        the user inputs V and G_ab.
    gradient_square:
        ``g^ab ∂_a V ∂_b V``.
    hesse_cmp:
        covariant Hesse matrix projected onto the vielbein,
        ``H_proj[a][b] = V_xy basis[a]^x basis[b]^y``.
    """

    model_name: str
    coordinates: list
    tangents: list
    basis: list
    eom_fields: list
    eom_h: sympy.Expr
    eom_hdot: sympy.Expr
    potential: sympy.Expr
    metric: list
    gradient_square: sympy.Expr
    hesse_cmp: list
    dim: int = field(init=False)

    def __post_init__(self):
        self.dim = len(self.coordinates)
        # attribute-name parity with the reference (symbolic.py:62)
        self.coordinate_tangents = self.tangents
        # shape validation mirrors reference symbolic.py:71-88
        if len(self.hesse_cmp[0]) != len(self.hesse_cmp):
            raise ValueError(
                "Hesse matrix must be square: got "
                f"{len(self.hesse_cmp)} rows of {len(self.hesse_cmp[0])} "
                "columns"
            )
        if len(self.metric[0]) != len(self.metric):
            raise ValueError(
                "metric tensor must be square: got "
                f"{len(self.metric)} rows of {len(self.metric[0])} columns"
            )
        if len(self.hesse_cmp[0]) != len(self.basis[0]):
            raise ValueError(
                f"Hesse matrix ({len(self.hesse_cmp[0])}-dim) and basis "
                f"vectors ({len(self.basis[0])}-dim) disagree in "
                "dimensionality"
            )
        if len(self.basis) != len(self.coordinates):
            raise ValueError(
                f"basis has {len(self.basis)} vectors but the model has "
                f"{len(self.coordinates)} fields"
            )
        if len(self.coordinates) != len(self.tangents):
            raise ValueError(
                f"got {len(self.coordinates)} coordinate symbols but "
                f"{len(self.tangents)} tangent symbols"
            )

    def __str__(self) -> str:
        return (
            "[Inflatox Inflation Model]\n"
            f"model name: {self.model_name}\n"
            f"dimensionality: {self.dim} field(s)\n"
            f"coordinates: {list(self.coordinates)}\n"
            f"potential: {self.potential}\n"
            f"metric: {sympy.Matrix(self.metric)}\n"
            f"basis vectors (cntr. var.): {[sympy.Matrix(v) for v in self.basis]}\n"
            f"hesse matrix: {sympy.Matrix(self.hesse_cmp)}\n"
        )

    # ---- serialization (compile-once / scan-many across processes) -------- #

    def to_dict(self) -> dict:
        """Serialize all expressions with ``sympy.srepr`` (lossless)."""
        s = sympy.srepr
        return {
            "model_name": self.model_name,
            "coordinates": [s(c) for c in self.coordinates],
            "coordinate_tangents": [s(t) for t in self.tangents],
            "basis": [[s(c) for c in vec] for vec in self.basis],
            "eom_fields": [s(e) for e in self.eom_fields],
            "eom_h": s(self.eom_h),
            "eom_hdot": s(self.eom_hdot),
            "potential": s(self.potential),
            "metric": [[s(g) for g in row] for row in self.metric],
            "gradient_square": s(self.gradient_square),
            "hesse_cmp": [[s(h) for h in row] for row in self.hesse_cmp],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "InflationModel":
        p = _parse_srepr
        return cls(
            model_name=d["model_name"],
            coordinates=[p(c) for c in d["coordinates"]],
            tangents=[p(t) for t in d["coordinate_tangents"]],
            basis=[[p(c) for c in vec] for vec in d["basis"]],
            eom_fields=[p(e) for e in d["eom_fields"]],
            eom_h=p(d["eom_h"]),
            eom_hdot=p(d["eom_hdot"]),
            potential=p(d["potential"]),
            metric=[[p(g) for g in row] for row in d["metric"]],
            gradient_square=p(d["gradient_square"]),
            hesse_cmp=[[p(h) for h in row] for row in d["hesse_cmp"]],
        )


_SYMPY_NAMES: dict = {}


def _parse_srepr(text: str):
    """An expression from its ``sympy.srepr`` string, evaluated with sympy's
    names, as ``sympy.parse_expr`` does after it has tokenised the string:
    the same expression (numbers become sympy numbers), without the tokeniser,
    which takes minutes for one of the EGNO or D5 bundle's strings on some
    CPython 3.12 builds."""
    if not _SYMPY_NAMES:
        exec("from sympy import *", _SYMPY_NAMES)  # noqa: S102
    return sympy.sympify(eval(text, dict(_SYMPY_NAMES)))  # noqa: S307


# --------------------------------------------------------------------------- #
# InflationModelBuilder                                                       #
# --------------------------------------------------------------------------- #


class InflationModelBuilder:
    """Derives an :class:`InflationModel` from (fields, metric, potential).

    Reference parity: ``InflationModelBuilder`` (symbolic.py:109-726); the
    public surface is ``InflationModelBuilder.new(...)`` followed by
    ``.build(guesses)``.
    """

    # ---- construction ----------------------------------------------------- #

    @classmethod
    def new(
        cls,
        fields: list,
        field_metric: list,
        potential: sympy.Expr,
        model_name: str | None = None,
        silent: bool = False,
        init_sympy_printing: bool = True,
        assertions: bool = True,
        simplify: bool = True,
        simplify_timeout: float | None = None,
    ) -> "InflationModelBuilder":
        """Create a builder; mirrors reference symbolic.py:126-201.

        Args
        ----
        fields: sympy symbols interpreted as fields (manifold coordinates).
        field_metric: metric tensor G_ab on the scalar manifold (nested list).
        potential: scalar potential V.
        model_name: optional name, used for printing.
        silent: suppress console output during the calculation.
        init_sympy_printing: initialise sympy pretty-printing.
        assertions: run (expensive) orthonormality assertions on the basis.
        simplify: run sympy simplification passes (with per-step timeout).
        simplify_timeout: per-step timeout in seconds (default 20).
        """
        if init_sympy_printing:
            sympy.init_printing()
        if simplify and os.name == "nt":
            # reference symbolic.py:177-190: SIGALRM unavailable on Windows
            log_warn(
                "cannot use simplifications on Windows. "
                "Continuing without simplifications."
            )
            simplify = False
        return cls(
            fields=fields,
            field_metric=field_metric,
            potential=potential,
            model_name=model_name if model_name is not None else "generic model",
            silent=silent,
            assertions=assertions,
            simplify=simplify,
            simplify_timeout=simplify_timeout if simplify_timeout is not None else 20.0,
        )

    def __init__(
        self,
        fields: list,
        field_metric: list,
        potential: sympy.Expr,
        model_name: str,
        silent: bool,
        assertions: bool,
        simplify: bool,
        simplify_timeout: float,
    ):
        if len(field_metric) != len(field_metric[0]):
            raise ValueError("field metric should be square")
        if len(field_metric) != len(fields):
            raise ValueError(
                "number of fields must match dimensionality of metric tensor"
            )
        self.model_name = model_name
        self.dim = len(fields)
        self.fields = list(fields)
        # auto-generated tangent symbols, reference symbolic.py:223
        self.field_derivatives = sympy.symbols(
            [f"\\dot{{{sympy.latex(phi)}}}" for phi in fields]
        )
        self.metric = field_metric
        self.V = potential
        self.assertions = assertions
        self.silent = silent
        self.simplify = simplify
        self.simplify_timeout = simplify_timeout
        self._metric_inv = None

    # ---- simplification helpers (reference symbolic.py:231-265) ----------- #

    def simplify_expr(self, expr: sympy.Expr) -> sympy.Expr:
        """``sympy.simplify(expr, ratio=1, inverse=True)`` with a timeout."""
        if not self.simplify:
            return expr
        try:
            with _time_limit(self.simplify_timeout):
                return sympy.simplify(expr, ratio=1, inverse=True)
        except SimplificationTimeOut:
            self.print(_TIMEOUT_MSG.format(self.simplify_timeout))
            return expr

    def expand_and_factor_expr(self, expr: sympy.Expr) -> sympy.Expr:
        """``sympy.factor(sympy.expand(expr))`` with a timeout."""
        if not self.simplify:
            return expr
        try:
            with _time_limit(self.simplify_timeout):
                return sympy.factor(sympy.expand(expr))
        except SimplificationTimeOut:
            self.print(_TIMEOUT_MSG.format(self.simplify_timeout))
            return expr

    def sqrt_and_denest_expr(self, expr: sympy.Expr) -> sympy.Expr:
        """Denested ``sqrt(expr)`` with a timeout."""
        if not self.simplify:
            return sympy.sqrt(expr)
        try:
            with _time_limit(self.simplify_timeout):
                return sqrtdenest(sympy.sqrt(expr))
        except SimplificationTimeOut:
            self.print(_TIMEOUT_MSG.format(self.simplify_timeout))
            return sympy.sqrt(expr)

    # ---- console output --------------------------------------------------- #

    def print(self, msg: str) -> None:
        if not self.silent:
            print(msg)

    def display(self, expr, lhs: str | None = None) -> None:
        if self.silent:
            return
        eq = sympy.Eq(lhs, expr, evaluate=False) if lhs is not None else expr
        try:
            from IPython.display import display  # noqa: PLC0415

            display(eq)
        except Exception:
            sympy.pprint(eq)

    # ---- geometry primitives ---------------------------------------------- #

    @property
    def metric_inv(self) -> sympy.Matrix:
        if self._metric_inv is None:
            self._metric_inv = sympy.Matrix(self.metric).inv()
        return self._metric_inv

    def inner_prod(self, v1: list, v2: list) -> sympy.Expr:
        """G_ab v1^a v2^b (reference symbolic.py:419-434)."""
        dot = sum(
            self.metric[a][b] * v1[a] * v2[b]
            for a in range(self.dim)
            for b in range(self.dim)
        )
        return self.expand_and_factor_expr(dot)

    def normalize(self, vec: list) -> list:
        """vec / sqrt(G_ab vec^a vec^b) (reference symbolic.py:436-463)."""
        normsq = sum(
            self.metric[a][b] * vec[a] * vec[b]
            for a in range(self.dim)
            for b in range(self.dim)
        )
        normsq = sympy.cancel(normsq) if self.simplify else normsq
        # denest sqrt of numerator/denominator separately, like the reference
        numerator, denominator = sympy.fraction(normsq)
        numerator = self.sqrt_and_denest_expr(numerator)
        denominator = self.sqrt_and_denest_expr(denominator)
        out = [vi * denominator / numerator for vi in vec]
        return [sympy.cancel(vi) for vi in out] if self.simplify else out

    def christoffels(self) -> list:
        """Γ^a_bc from the metric, indexed Γ[a][b][c] (symbolic.py:465-490)."""
        d = self.dim
        inv = self.metric_inv
        g = sympy.Matrix(self.metric)
        gammas = [[[0] * d for _ in range(d)] for _ in range(d)]
        for i in range(d):
            for j in range(d):
                for k in range(j + 1):  # symmetric in (j, k)
                    term = sum(
                        (inv[i, n] / 2)
                        * (
                            sympy.diff(g[n, j], self.fields[k])
                            + sympy.diff(g[n, k], self.fields[j])
                            - sympy.diff(g[j, k], self.fields[n])
                        )
                        for n in range(d)
                    )
                    term = self.simplify_expr(term)
                    gammas[i][j][k] = term
                    gammas[i][k][j] = term
        return gammas

    # ---- derived quantities ------------------------------------------------ #

    def calc_hesse(self) -> list:
        """Covariant Hesse V_ab = ∂_a∂_b V − Γ^c_ab ∂_c V (symbolic.py:492-530)."""
        conn = self.christoffels()
        grad = [sympy.diff(self.V, f) for f in self.fields]
        out = [[0] * self.dim for _ in range(self.dim)]
        for a in range(self.dim):
            for b in range(self.dim):
                da_db_V = sympy.diff(self.V, self.fields[b], self.fields[a])
                gamma_term = sum(conn[c][b][a] * grad[c] for c in range(self.dim))
                out[a][b] = self.simplify_expr(da_db_V - gamma_term)
        return out

    def calc_gradient_square(self) -> sympy.Expr:
        """g^ab ∂_a V ∂_b V (symbolic.py:532-560)."""
        grad = [sympy.diff(self.V, f) for f in self.fields]
        inv = self.metric_inv
        out = sum(
            inv[a, b] * grad[a] * grad[b]
            for a in range(self.dim)
            for b in range(self.dim)
        )
        out = self.expand_and_factor_expr(out)
        return self.simplify_expr(out)

    def calc_v(self) -> list:
        """Normalized contravariant gradient (grad V)^a (symbolic.py:562-583)."""
        grad = [sympy.diff(self.V, f) for f in self.fields]
        inv = self.metric_inv
        vup = [
            sum(inv[a, b] * grad[b] for b in range(self.dim)) for a in range(self.dim)
        ]
        vup = self.normalize(vup)
        return [self.simplify_expr(vi) for vi in vup]

    def gramm_schmidt(self, current_basis: list, guess: list) -> list:
        """Orthogonalize ``guess`` against ``current_basis`` and normalize
        (reference symbolic.py:585-636).  ``current_basis`` must already be
        orthonormal; ``guess`` must be linearly independent from it."""
        d = len(current_basis[0])
        if len(current_basis) >= d:
            raise ValueError(
                "the orthonormal basis already spans the field space; "
                "refusing to add another vector"
            )
        y = list(guess)
        for x in current_basis:
            overlap = self.inner_prod(x, y)
            y = [y[a] - overlap * x[a] for a in range(d)]
        # NOTE: the reference runs this expand/factor under its timeout even
        # with simplify=False (symbolic.py:629-634) — factor() on the giant
        # D5-class expressions never terminates without the bound
        try:
            with _time_limit(self.simplify_timeout or 20.0):
                y = [sympy.factor(sympy.expand(yi)) for yi in y]
        except SimplificationTimeOut:
            self.print(_TIMEOUT_MSG.format(self.simplify_timeout))
        return [self.simplify_expr(yi) for yi in self.normalize(y)]

    def project_hesse(self, hesse_matrix: list, v1: list, v2: list) -> sympy.Expr:
        """H_ab v1^a v2^b (symbolic.py:638-669)."""
        out = sum(
            hesse_matrix[a][b] * v1[a] * v2[b]
            for a in range(self.dim)
            for b in range(self.dim)
        )
        return self.simplify_expr(out)

    def compute_eom(self) -> list:
        """Per-field Γ^a_bc χ^b χ^c + g^ab ∂_b V (symbolic.py:671-697).

        The full equation of motion is χ'^a + eom[a] + 3H χ^a = 0; the
        friction term is added numerically by the background solver."""
        conn = self.christoffels()
        inv = self.metric_inv
        chi = self.field_derivatives
        out = []
        for a in range(self.dim):
            conn_term = sum(
                conn[a][b][c] * chi[b] * chi[c]
                for b in range(self.dim)
                for c in range(self.dim)
            )
            grad_term = sum(
                inv[a, b] * sympy.diff(self.V, self.fields[b])
                for b in range(self.dim)
            )
            conn_term = self.expand_and_factor_expr(conn_term)
            grad_term = self.expand_and_factor_expr(grad_term)
            out.append(self.simplify_expr(conn_term + grad_term))
        return out

    def compute_eom_h(self) -> sympy.Expr:
        """Hubble constraint H = sqrt((V + ½ G_ab χ^a χ^b)/3).

        NOTE: the reference's implementation (symbolic.py:707-711) omits the ½
        its docstring requires; we implement the textbook Friedmann constraint
        (divergence documented in the module docstring)."""
        chi = self.field_derivatives
        kinetic = sum(
            self.metric[a][b] * chi[a] * chi[b]
            for a in range(self.dim)
            for b in range(self.dim)
        )
        out = self.V + kinetic / sympy.nsimplify(2)
        out = self.expand_and_factor_expr(out)
        return self.sqrt_and_denest_expr(out / 3)

    def compute_eom_hdot(self) -> sympy.Expr:
        """H' = −½ G_ab χ^a χ^b (symbolic.py:714-726)."""
        chi = self.field_derivatives
        out = -sum(
            self.metric[a][b] * chi[a] * chi[b]
            for a in range(self.dim)
            for b in range(self.dim)
        ) / sympy.nsimplify(2)
        return self.expand_and_factor_expr(out)

    # ---- the main entry point --------------------------------------------- #

    def build(self, guesses: list | None = None) -> InflationModel:
        """Run the full symbolic calculation (reference symbolic.py:287-417).

        Args
        ----
        guesses:
            ``dim - 1`` linearly-independent vectors used to complete the
            vielbein basis via Gram-Schmidt.  May be ``None`` for 2-field
            models, in which case the orthogonal complement of the gradient
            is constructed analytically (symbolic.py:322-330).
        """
        if guesses is not None and len(guesses) != self.dim - 1:
            raise ValueError(
                "number of guessed vectors must equal the number of fields "
                "minus one (n-1)"
            )

        # (1) orthonormal basis, starting from the normalized gradient
        self.print("building the orthonormal vielbein basis ...")
        self.print("normalising the potential gradient ...")
        basis = [self.calc_v()]
        self.display(sympy.Matrix(basis[0]), lhs=sympy.symbols("v"))

        if guesses is None and self.dim == 2:
            # analytic orthogonal complement: rotate the covariant gradient by
            # 90° and raise the index (reference symbolic.py:322-330)
            w_cov = [-basis[0][1], basis[0][0]]
            inv = self.metric_inv
            w = [
                sum(inv[a, b] * w_cov[b] for b in range(self.dim))
                for a in range(self.dim)
            ]
            basis.append(self.normalize(w))
            self.display(sympy.Matrix(basis[-1]), lhs=sympy.symbols("w_1"))
        elif guesses is None:
            raise ValueError(
                "models with more than two fields need explicit basis "
                "guesses (pass the `guesses` argument)"
            )
        else:
            for i, guess in enumerate(guesses):
                basis.append(self.gramm_schmidt(basis, guess))
                self.display(sympy.Matrix(basis[-1]), lhs=sympy.symbols(f"w_{i + 1}"))

        # (2) orthonormality assertions (reference symbolic.py:340-359)
        if self.assertions:
            for a in range(self.dim):
                for b in range(a, self.dim):
                    ip = self.inner_prod(basis[a], basis[b])
                    if a == b:
                        self.print(f"checking |w{a}|^2 == 1 ...")
                        ok = sympy.Eq(1, ip).simplify()
                        err = f"normalisation error: |w{a}|^2 does not equal 1"
                    else:
                        self.print(f"checking w{a}·w{b} == 0 ...")
                        ok = sympy.Eq(0, ip).simplify()
                        err = f"orthogonality error: w{a}•w{b} does not equal 0"
                    if ok is sympy.false or ok is False:
                        raise ValueError(err)
                    if not (ok is sympy.true or ok is True):
                        # could not decide symbolically — the numerical basis
                        # validation at model-load time will catch real issues
                        log_warn(f"could not symbolically verify: {err}")

        # (3) covariant Hesse matrix
        self.print("assembling the covariant Hesse matrix ...")
        hesse = self.calc_hesse()
        self.display(sympy.Matrix(hesse), lhs=sympy.symbols("H"))

        # (4) project onto the vielbein, parallelized over (a, b) pairs
        #     (reference symbolic.py:367-388 uses joblib the same way)
        self.print("projecting the Hesse matrix onto the vielbein ...")
        pairs = [(a, b) for a in range(self.dim) for b in range(self.dim)]
        h_proj = [[0] * self.dim for _ in range(self.dim)]
        results = self._parallel_project(hesse, basis, pairs)
        for (a, b), cmp in results:
            h_proj[a][b] = cmp
            la = "v" if a == 0 else a
            lb = "v" if b == 0 else b
            self.display(cmp, lhs=sympy.symbols(f"H_{{{la}{lb}}}"))

        # (5) |∇V|²
        self.print("computing |grad V|^2 ...")
        gradnorm = self.calc_gradient_square()
        self.display(gradnorm, lhs=sympy.symbols("gradV2"))

        # (6) equations of motion — displayed like the reference
        # (symbolic.py:399-404 shows each field EoM and the H constraint/EoM)
        self.print("deriving the background equations of motion ...")
        eoms = self.compute_eom()
        for a, e in enumerate(eoms):
            self.display(e, lhs=sympy.symbols(f"EoM_{{{self.fields[a]}}}"))
        constraint_h = self.compute_eom_h()
        self.display(constraint_h, lhs=sympy.symbols("H"))
        eom_hdot = self.compute_eom_hdot()
        self.display(eom_hdot, lhs=sympy.symbols("H'"))

        return InflationModel(
            model_name=self.model_name,
            coordinates=self.fields,
            tangents=self.field_derivatives,
            basis=basis,
            eom_fields=eoms,
            eom_h=constraint_h,
            eom_hdot=eom_hdot,
            potential=self.V,
            metric=self.metric,
            gradient_square=gradnorm,
            hesse_cmp=h_proj,
        )

    def _parallel_project(self, hesse, basis, pairs):
        """Project Hesse components, joblib-parallel when profitable."""

        def project(a: int, b: int):
            return (a, b), self.project_hesse(hesse, basis[a], basis[b])

        try:
            from joblib import Parallel, cpu_count, delayed  # noqa: PLC0415

            n_jobs = min(cpu_count(), len(pairs))
            if n_jobs > 1:
                return Parallel(n_jobs=n_jobs)(
                    delayed(project)(a, b) for a, b in pairs
                )
        except Exception:
            pass
        return [project(a, b) for a, b in pairs]
