"""Plain reference of the configuration ``egno-dd``: EGNO no-scale
supergravity (Ellis, Garcia, Nanopoulos, Olive, JCAP08(2014)044), fields
(r, θ) with Φ = r + iθ, the metric G = K_ΦΦ̄ · diag(1, 1) of the Kähler
potential K = −3α ln(Φ + Φ̄ − c (Φ + Φ̄ − 1)⁴) + S S̄/(Φ + Φ̄)³ at S = 0, and
V = 6 m² r³ ((a − r)² + θ²) / (a² (2r − c (1 − 2r)⁴)^{3α}).

The configuration is computed in double-double; this reference runs in
the platform's 64-bit-significand long double, which ``anguelova.long_double``
checks."""

import sympy

from anguelova import long_double

DTYPE = long_double()


def model():
    r, theta = sympy.symbols("r theta", real=True)
    m, a, c, alpha = sympy.symbols("m a c alpha", real=True)
    phi, phib, s, sb = sympy.symbols("Phi Phi_B S S_B")
    K = -3 * alpha * sympy.log(phi + phib - c * (phi + phib - 1) ** 4) + s * sb / (phi + phib) ** 3
    g = sympy.diff(K, phi, phib).subs({s: 0, sb: 0})
    g = g.subs({phi: r + sympy.I * theta, phib: r - sympy.I * theta})
    g = sympy.simplify(sympy.expand_complex(g))
    V = 6 * m**2 * r**3 * ((a - r) ** 2 + theta**2) / (a**2 * (2 * r - c * (1 - 2 * r) ** 4) ** (3 * alpha))
    return (r, theta), (m, a, c, alpha), [[g, 0], [0, g]], V
