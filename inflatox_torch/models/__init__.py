"""Model zoo: the four model families shipped with the reference test suite.

Each function returns ``(InflationModel, default_args)`` where
``default_args`` is ordered by the compiled symbol dictionary (the same
physical parameter values the reference tests use).  These are the standard
fixtures for benchmarks, examples and parity work:

* :func:`hyperinflation` — the README/doc example (reference tests/test_doc.py)
* :func:`angular` — angular inflation, JCAP11(2019)002 (tests/test_angular.py)
* :func:`egno` — EGNO supergravity, JCAP08(2014)044 (tests/test_egno.py)
* :func:`d5` — D5-brane model, JCAP02(2015)127 (tests/test_d5.py)

Beyond the reference set:

* :func:`natural` — natural inflation (axion cosine) plus a quadratic
  spectator; the concave potential region makes Planck-like (n_s, r)
  reachable, which the observable-fitting example exploits
  (examples/fit_observables.py).
* :func:`alpha_attractor` — two-field α-attractor T-model on a hyperbolic
  field space; the standard modern multi-field testbed (geometrical
  destabilization, curvature-fed isocurvature) for the geometry and
  perturbation-spectra layers.
* :func:`double_quadratic` — double inflation (two massive fields,
  mass ratio 7); the canonical isocurvature→adiabatic transfer testbed
  for the transport/δN spectrum routes.
"""

from __future__ import annotations

import numpy as np
import sympy

from ..symbolic import InflationModel, InflationModelBuilder

__all__ = [
    "hyperinflation", "angular", "egno", "d5", "natural", "alpha_attractor",
    "double_quadratic",
]


def hyperinflation(silent: bool = True):
    """Doc-example model: V = ½m²(θ² − 2/(3r²)), diagonal metric ½·diag(1, r²).

    Golden values (reference tests/test_doc.py:50-51): V(2,−2; m=1) = 23/12,
    and the projected Hesse matrix [[0.41206897, −1.05517241], …]."""
    r, theta, m = sympy.symbols("r θ m")
    V = sympy.Rational(1, 2) * m**2 * (theta**2 - sympy.Rational(2, 3) / r**2)
    g = [[sympy.Rational(1, 2), 0], [0, sympy.Rational(1, 2) * r**2]]
    model = InflationModelBuilder.new(
        [r, theta], g, V, model_name="hyperinflation", silent=silent
    ).build()
    return model, np.array([1.0])


def angular(silent: bool = True):
    """Angular inflation: quadratic potential on a hyperbolic disc."""
    p, x = sympy.symbols("phi chi")
    mp, mx, a = sympy.symbols("m_phi m_chi alpha")
    potential = (a / 2 * ((mp * p) ** 2 + (mx * x) ** 2)).nsimplify()
    diag = 6 * a / (1 - p**2 - x**2) ** 2
    metric = [[diag, 0], [0, diag]]
    model = InflationModelBuilder.new(
        [p, x], metric, potential, model_name="angular", silent=silent
    ).build()
    # reference parameter point (tests/test_angular.py:63-66): α, m_χ, m_φ
    alpha_v = 1 / 600
    m_phi = 2e-5
    return model, np.array([alpha_v, m_phi * 3.0, m_phi])


def egno(silent: bool = True):
    """EGNO supergravity: metric from a Kähler potential."""
    alpha, m, c, a = sympy.symbols("alpha m c a")
    r, th = sympy.symbols("r θ")
    Phi, Phi_b, S, S_b = sympy.symbols("Phi Phi_B S S_B")
    K = (
        -3 * alpha * sympy.ln(Phi + Phi_b - c * (Phi + Phi_b - 1) ** 4)
        + (S * S_b) / (Phi + Phi_b) ** 3
    ).nsimplify()
    g00 = sympy.diff(sympy.diff(K, Phi), Phi_b)
    g00 = g00.subs({Phi: r + sympy.I * th, Phi_b: r - sympy.I * th})
    g00 = g00.subs({S: 0, S_b: 0}).nsimplify().simplify()
    metric = [[g00, 0], [0, g00]]
    potential = (
        (6 * m**2 * r**3 * ((a - r) ** 2 + th**2))
        / (a**2 * (2 * r - c * (1 - 2 * r) ** 4) ** (3 * alpha))
    ).nsimplify()
    model = InflationModelBuilder.new(
        [r, th],
        metric,
        potential,
        model_name="egno",
        silent=silent,
        simplify=False,
        assertions=False,
    ).build([[0, 1]])
    by_name = {"m": 1e-3, "a": 0.5, "c": 1000.0, "alpha": 1.0}
    return model, _args_by_symbol(model, by_name)


def d5(silent: bool = True):
    """D5-brane model: ln/sqrt-heavy, 10 parameters.

    Physics from JCAP02(2015)127 §3 / JCAP01(2020)020: a D5-brane wrapping a
    two-cycle of the resolved conifold; warp factor H(ρ), flux function F,
    and a harmonic potential contribution Φ_min + Φ_h.  The
    nsimplify/collect/expand/powsimp normalization chain matches the form
    the reference test compiles (test_d5.py), so the compiled expressions —
    and hence parity points — are the same.
    """
    from sympy import Rational, cos, ln, pi, sqrt, symbols
    from sympy.simplify.radsimp import collect_sqrt

    r, th = symbols("r θ2")
    gs, ls, N, u, p, q, V0 = symbols("g_s l_s N u p q V0")
    a0, a1, b1 = symbols("a0 a1 b1")

    def norm(expr, wrt):
        """The reference's expression-normalization chain."""
        return expr.nsimplify().collect(wrt).expand().powsimp()

    brane_tension = 1 / (gs * (2 * pi) ** 5 * ls**6)  # T5 = μ5 / g_s
    rho = r / (3 * u)
    log_term = 2 / rho**2 - 2 * ln(1 / rho**2 + 1)

    warp = (pi * N * gs * ls**4) / (12 * u**4) * log_term
    warp = warp.nsimplify().collect([u, r]).expand().powsimp(force=True)

    flux = norm(warp / 9 * (r**2 + 3 * u**2) ** 2 + (pi * q * ls**2) ** 2, [r, u])

    pref = 4 * pi * p * brane_tension
    g00 = collect_sqrt(
        pref * sqrt(flux) * ((r**2 + 6 * u**2) / (r**2 + p * u**2)), evaluate=True
    ).expand().powsimp()
    g11 = norm(
        collect_sqrt(Rational(4, 6) * pi * p * brane_tension * sqrt(flux)
                     * (r**2 + 6 * u**2), evaluate=True),
        [r, u],
    )

    phi_min = norm(
        Rational(5, 72)
        * (81 * (9 * rho**2 - 2) * rho**2 + 162 * ln(9 * (rho**2 + 1))
           - 9 - 160 * ln(10)),
        [u],
    )
    phi_h = norm(
        a0 * log_term
        + 2 * a1 * (6 + 1 / rho**2 - 2 * (2 + 3 * rho**2) * ln(1 + 1 / rho**2)) * cos(th)
        + (b1 / 2) * (2 + 3 * rho**2) * cos(th),
        [u, r],
    )

    coupling = 4 * pi**2 * ls**2 * p * q * brane_tension * gs
    potential = (
        V0
        + (pref / warp) * (sqrt(flux) - ls**2 * pi * q * gs)
        + coupling * (phi_min + phi_h)
    )
    potential = norm(potential, [ls, gs])

    model = InflationModelBuilder.new(
        [r, th],
        [[g00, 0], [0, g11]],
        potential,
        model_name="d5",
        assertions=False,
        silent=silent,
        simplify=False,
    ).build([[1, 0]])
    by_name = {
        "V0": -1.17e-8,
        "N": 1000.0,
        "g_s": 0.01,
        "l_s": 501.961,
        "u": 50 * 501.961,
        "q": 1.0,
        "p": 5.0,
        "a0": 0.001,
        "a1": 0.0005,
        "b1": 0.001,
    }
    return model, _args_by_symbol(model, by_name)


def natural(silent: bool = True):
    """Natural inflation (axion cosine) + quadratic spectator, flat metric.

    V = 1 + cos(φ₁/f_a) + (m φ₂)²; Freese-Frieman-Olinto style potential
    (Phys. Rev. Lett. 65, 3233).  Not in the reference's model set — added
    because the hilltop region (η_V < 0) makes Planck-like (n_s, r)
    targets reachable, which examples/fit_observables.py fits by gradient
    descent.  Default args: f_a = 5.73 (the fitted decay constant), m = 0.05.
    """
    f1, f2 = sympy.symbols("phi_1 phi_2")
    fa, m = sympy.symbols("f_a m")
    V = 1 + sympy.cos(f1 / fa) + (m * f2) ** 2
    model = InflationModelBuilder.new(
        [f1, f2], [[1, 0], [0, 1]], V, model_name="natural", silent=silent
    ).build()
    return model, _args_by_symbol(model, {"f_a": 5.73, "m": 0.05})


def alpha_attractor(silent: bool = True):
    """Two-field α-attractor T-model on the hyperbolic disc.

    Disc coordinates (r, θ) with metric ``6α/(1−r²)² · diag(1, r²)``
    (constant negative curvature: Ricci scalar −4/(3α)) and potential
    ``V = M⁴ r² (1 + c·cos θ)`` — the T-model ``tanh²(φ/√(6α))`` in disc
    coordinates (r = tanh(φ/√(6α))) with a small angular modulation that
    makes the model genuinely two-field.  The universal large-N
    predictions n_s ≈ 1 − 2/N, r ≈ 12α/N² (Kallosh–Linde, JCAP07(2013)002)
    are what the zoo test pins.  Not in the reference's model set — added
    as the standard modern testbed for the geometry and perturbation-
    spectra layers (curved field space, curvature-fed isocurvature).
    Default args: α = 1, M⁴ = 1e-10, c = 0.1.
    """
    r, th = sympy.symbols("r θ", real=True)
    alpha, m4, c = sympy.symbols("alpha M4 c", positive=True)
    conf = 6 * alpha / (1 - r**2) ** 2
    metric = [[conf, 0], [0, conf * r**2]]
    V = m4 * r**2 * (1 + c * sympy.cos(th))
    model = InflationModelBuilder.new(
        [r, th], metric, V, model_name="alpha_attractor", silent=silent
    ).build()
    return model, _args_by_symbol(
        model, {"alpha": 1.0, "M4": 1e-10, "c": 0.1}
    )


def double_quadratic(silent: bool = True):
    """Double inflation: two massive fields with a mass hierarchy, flat
    metric (Polarski–Starobinsky, Phys. Rev. D 50, 6123).

    V = ½ m_h² φ_h² + ½ m_l² φ_l² with m_h/m_l = 7.  Inflation proceeds in
    two stages (heavy field first); scales leaving the horizon during the
    first stage gain curvature power super-horizon as the light field takes
    over — the canonical testbed for isocurvature→adiabatic transfer, which
    is what the zoo test pins (P_ζ(end)/P_ζ(*) of several, transport route
    vs δN).  Not in the reference's model set.  Default args:
    m_l = 1e-5, m_h = 7e-5 (reduced Planck units; P_ζ scales as m²).
    Standard initial conditions: φ_h = φ_l = 12.
    """
    fh, fl = sympy.symbols("phi_h phi_l")
    mh, ml = sympy.symbols("m_h m_l")
    V = sympy.Rational(1, 2) * ((mh * fh) ** 2 + (ml * fl) ** 2)
    model = InflationModelBuilder.new(
        [fh, fl], [[1, 0], [0, 1]], V, model_name="double_quadratic",
        silent=silent,
    ).build()
    return model, _args_by_symbol(model, {"m_h": 7e-5, "m_l": 1e-5})


def _args_by_symbol(model: InflationModel, by_name: dict) -> np.ndarray:
    """Order parameter values by the model's compiled symbol dictionary."""
    from ..lowering.registry import SymbolRegistry

    registry = SymbolRegistry.from_model(model)
    args = np.zeros(registry.n_parameters)
    for name, slot in registry.symbol_dictionary.items():
        if slot.startswith("args["):
            args[int(slot[5:-1])] = by_name[name]
    return args
