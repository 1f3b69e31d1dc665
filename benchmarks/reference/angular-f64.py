"""Plain reference of the configuration ``angular-f64``: angular inflation
(Christodoulidis, Roest, Sfakianakis, JCAP11(2019)002), the rapid-turn model
of inflatox's tests/test_angular.py: V = ½ α (m_φ² φ² + m_χ² χ²) on the
hyperbolic disc G_ab = 6α / (1 − φ² − χ²)² δ_ab, fields (φ, χ), evaluated in
float64 by ``background.py``."""

import numpy as np
import sympy

DTYPE = np.float64


def model():
    phi, chi = sympy.symbols("phi chi")
    alpha, m_phi, m_chi = sympy.symbols("alpha m_phi m_chi")
    half = sympy.Rational(1, 2)
    V = half * alpha * (m_phi**2 * phi**2 + m_chi**2 * chi**2)
    g = 6 * alpha / (1 - phi**2 - chi**2) ** 2
    G = [[g, 0], [0, g]]
    return (phi, chi), (alpha, m_phi, m_chi), G, V
