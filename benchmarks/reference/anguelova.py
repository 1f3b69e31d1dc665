"""Plain reference of the rapid-turn analysis of a two-field model, in
sympy and NumPy, written from the published definitions and independent of
the package under test.

From a potential V(x) and a field-space metric G_ab(x), given as sympy
expressions, sympy gives the partial derivatives ∂_a V, ∂_a∂_b V, G_ab and
∂_c G_ab; everything else is NumPy on the point values, in the dtype asked
for (float64, or float128 where the platform's long double has a 64-bit
significand):

* Christoffel symbols Γ^c_ab = ½ G^cd (∂_a G_db + ∂_b G_da − ∂_d G_ab);
* covariant Hesse V_ab = ∂_a∂_b V − Γ^c_ab ∂_c V;
* |∇V|² = G^ab ∂_a V ∂_b V;
* the vielbein: v^a = G^ab ∂_b V / |∇V|; w^a = G^ab w_b with the covariant
  w_b = (−v^1, v^0), normalised (orthogonal to v: G_ab v^a w^b = 0);
* the projections V_vv = V_ab v^a v^b, V_wv = V_ab w^a v^b,
  V_ww = V_ab w^a w^b;
* the six quantities of inflatox's ``anguelova.rs`` (lines 103-135):
  consistency, ε_V (without the ½), ε_H, η_∥, δ, ω; and the original
  rapid-turn condition (lines 143-154).
"""

from __future__ import annotations

import numpy as np
import sympy


def long_double():
    """NumPy's long double, checked to carry a 64-bit significand."""
    if np.finfo(np.longdouble).nmant < 63:
        raise RuntimeError("this platform's long double has no 64-bit significand")
    return np.longdouble


class TwoFieldModel:
    """V and G of a two-field model with named parameters, evaluated in
    NumPy on arrays of any float dtype."""

    def __init__(self, fields, params, metric, potential):
        self.params = list(params)
        x = list(fields)
        exprs = [potential]
        exprs += [sympy.diff(potential, x[a]) for a in range(2)]
        exprs += [sympy.diff(potential, x[a], x[b]) for a, b in ((0, 0), (0, 1), (1, 1))]
        exprs += [metric[a][b] for a, b in ((0, 0), (0, 1), (1, 1))]
        exprs += [sympy.diff(metric[a][b], x[c])
                  for c in range(2) for a, b in ((0, 0), (0, 1), (1, 1))]
        self._fn = sympy.lambdify([*x, *self.params], exprs, modules="numpy", cse=True)

    def parts(self, x0, x1, p: dict):
        """V, ∂V, ∂∂V, G, ∂G at the points, each broadcast to the shape of
        the points and the parameters (a parameter may be an array)."""
        values = [p[str(s)] for s in self.params]
        vals = self._fn(x0, x1, *values)
        shape = np.broadcast(x0, x1, *values).shape
        dtype = np.result_type(x0, x1)
        vals = [np.broadcast_to(np.asarray(v, dtype=dtype), shape) for v in vals]
        V, V0, V1, V00, V01, V11, G00, G01, G11 = vals[:9]
        dG = vals[9:]  # dG[3c + k]: ∂_c of G00, G01, G11
        sym = lambda a00, a01, a11: [[a00, a01], [a01, a11]]  # noqa: E731
        return (V, [V0, V1], sym(V00, V01, V11), sym(G00, G01, G11),
                [sym(*dG[3 * c:3 * c + 3]) for c in range(2)])


def projected(model: TwoFieldModel, x0, x1, p: dict):
    """V, V_vv, V_wv, V_ww and |∇V|² at the points."""
    V, dV, ddV, G, dG = model.parts(x0, x1, p)
    det = G[0][0] * G[1][1] - G[0][1] * G[1][0]
    Gi = [[G[1][1] / det, -G[0][1] / det], [-G[1][0] / det, G[0][0] / det]]
    # Γ^c_ab, dG[c][a][b] = ∂_c G_ab
    gamma = [[[sum(0.5 * Gi[c][d] * (dG[a][d][b] + dG[b][d][a] - dG[d][a][b])
                   for d in range(2)) for b in range(2)] for a in range(2)] for c in range(2)]
    H = [[ddV[a][b] - sum(gamma[c][a][b] * dV[c] for c in range(2)) for b in range(2)]
         for a in range(2)]
    up = [sum(Gi[a][b] * dV[b] for b in range(2)) for a in range(2)]
    gsq = sum(up[a] * dV[a] for a in range(2))

    def normalise(vec):
        norm = np.sqrt(sum(G[a][b] * vec[a] * vec[b] for a in range(2) for b in range(2)))
        return [c / norm for c in vec]

    v = normalise(up)
    w_cov = [-v[1], v[0]]
    w = normalise([sum(Gi[a][b] * w_cov[b] for b in range(2)) for a in range(2)])

    def hesse(e, f):
        return sum(H[a][b] * e[a] * f[b] for a in range(2) for b in range(2))

    return V, hesse(v, v), hesse(w, v), hesse(w, w), gsq


def _ratio(num, lhs, rhs):
    """|num| / (|lhs| + |rhs|) clamped to 1; NaN stays NaN."""
    return np.minimum(np.abs(num) / (np.abs(lhs) + np.abs(rhs)), 1.0)


def complete_analysis(V, v00, v10, v11, gsq):
    """anguelova.rs:103-135: consistency, ε_V, ε_H, η_∥, δ, ω."""
    with np.errstate(all="ignore"):
        lhs = v11 / V
        rhs = 3.0 + 3.0 * (v00 / v10) ** 2 + (v00 / V) * (v10 / v00) ** 2
        consistency = _ratio(lhs - rhs, lhs, rhs)
        eps_v = gsq / V**2
        vtt = (v00 * v10**2 + v11 * v00**2 - 2.0 * v00 * v10**2) / (v00**2 + v10**2)
        vt2 = eps_v / (1.0 + (v00 / v10) ** 2)
        eps_h = 3.0 * (eps_v - vt2) / (eps_v + np.abs(vtt) / V - vt2)
        tan_delta = np.abs(v10 / v00)
        delta = np.arctan(tan_delta)
        omega = np.sqrt((vtt / V) * (3.0 - eps_h))
        eta = omega * tan_delta - 3.0
    return [consistency, eps_v, eps_h, eta, delta, omega]


def consistency_rapidturn(V, v00, v10, v11):
    """anguelova.rs:143-154: ||V_ww/V| − |3 (V_wv/V_vv)²|| over their sum."""
    with np.errstate(all="ignore"):
        lhs = v11 / V
        rhs = 3.0 * (v10 / v00) ** 2
        return [_ratio(np.abs(lhs) - np.abs(rhs), lhs, rhs)]


def analysis(model: TwoFieldModel, kind: str, x0, x1, p: dict):
    """The maps of an analysis kind at the points, as a list of arrays."""
    with np.errstate(all="ignore"):
        V, v00, v10, v11, gsq = projected(model, x0, x1, p)
    if kind == "complete_analysis":
        return complete_analysis(V, v00, v10, v11, gsq)
    if kind == "consistency_rapidturn":
        return consistency_rapidturn(V, v00, v10, v11)
    raise ValueError(f"no reference for the kind {kind!r}")


def axis(start: float, stop: float, n: int, index, dtype):
    """Coordinates start + i·h of an endpoint-exclusive axis of n points,
    h = (stop − start)/n rounded to float64 (the documented grid)."""
    h = (float(stop) - float(start)) / int(n)
    i = np.asarray(index)
    if dtype == np.float64:
        return float(start) + i.astype(np.float64) * h
    return dtype(start) + i.astype(dtype) * dtype(h)
