"""Plain reference of the configuration ``hyperinflation-f64``: the
inflatox documentation's example, V = ½ m² (θ² − 2/(3 r²)) on the metric
½·diag(1, r²), fields (r, θ), evaluated in float64."""

import numpy as np
import sympy

DTYPE = np.float64


def model():
    r, theta, m = sympy.symbols("r theta m")
    half = sympy.Rational(1, 2)
    V = half * m**2 * (theta**2 - sympy.Rational(2, 3) / r**2)
    G = [[half, 0], [0, half * r**2]]
    return (r, theta), (m,), G, V
