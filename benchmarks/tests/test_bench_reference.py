"""The plain references and the frozen operation counter.

The hyperinflation reference against inflatox's golden values
(tests/test_doc.py of the reference project: V(2, −2; m = 1) = 23/12 and
the projected Hesse), the EGNO reference in long double against the same
quantities worked out in sympy at 40 digits, and the counter against hand
counts.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import sympy

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH / "reference"))
sys.path.insert(0, str(BENCH / "tools"))

import anguelova  # noqa: E402
import count_ops  # noqa: E402

GOLDEN_V = 23 / 12
GOLDEN_H = np.array([[0.41206897, -1.05517241], [-1.05517241, -0.07873563]])
EGNO = {"m": 1e-3, "a": 0.5, "c": 1000.0, "alpha": 1.0}
EGNO_POINTS = [(0.46, 0.1), (0.4725, 1.3), (0.4861, 2.2), (0.4993, 0.003), (0.49, 3.1)]


def _reference(name):
    spec = importlib.util.spec_from_file_location(name.replace("-", "_"),
                                                  BENCH / "reference" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_hyperinflation_golden_values():
    ref = _reference("hyperinflation-f64")
    model = anguelova.TwoFieldModel(*ref.model())
    V, v00, v10, v11, _ = anguelova.projected(model, np.array(2.0), np.array(-2.0), {"m": 1.0})
    assert V == pytest.approx(GOLDEN_V, rel=1e-15)
    np.testing.assert_allclose([[v00, v10], [v10, v11]], GOLDEN_H, atol=1e-8)


def _sympy_projected(fields, params, G, V, point, values):
    """V and the projected Hesse at one point, every step in sympy at 40
    digits (the point and parameters exact rationals of their floats)."""
    subs = {f: sympy.Rational(x) for f, x in zip(fields, point)}
    subs.update({p: sympy.Rational(values[str(p)]) for p in params})
    x = list(fields)
    Gm = sympy.Matrix(G)
    Gi = Gm.inv()
    dV = [sympy.diff(V, f) for f in x]
    gamma = [[[sum(Gi[c, d] * (sympy.diff(Gm[d, b], x[a]) + sympy.diff(Gm[d, a], x[b])
                               - sympy.diff(Gm[a, b], x[d])) / 2 for d in range(2))
               for b in range(2)] for a in range(2)] for c in range(2)]
    num = lambda e: sympy.N(e.subs(subs), 40)  # noqa: E731
    H = [[num(sympy.diff(V, x[a], x[b]) - sum(gamma[c][a][b] * dV[c] for c in range(2)))
          for b in range(2)] for a in range(2)]
    G_, Gi_ = Gm.subs(subs).evalf(40), Gi.subs(subs).evalf(40)
    dV_ = [num(d) for d in dV]
    up = [sum(Gi_[a, b] * dV_[b] for b in range(2)) for a in range(2)]

    def normalise(vec):
        n = sympy.sqrt(sum(G_[a, b] * vec[a] * vec[b] for a in range(2) for b in range(2)))
        return [c / n for c in vec]

    v = normalise(up)
    w = normalise([sum(Gi_[a, b] * wc for b, wc in enumerate([-v[1], v[0]])) for a in range(2)])

    def hesse(e, f):
        return sum(H[a][b] * e[a] * f[b] for a in range(2) for b in range(2))

    return [num(V), hesse(v, v), hesse(w, v), hesse(w, w)]


@pytest.mark.parametrize("point", EGNO_POINTS)
def test_egno_long_double_against_40_digits(point):
    ref = _reference("egno-dd")
    fields, params, G, V = ref.model()
    model = anguelova.TwoFieldModel(fields, params, G, V)
    ld = ref.DTYPE
    got = anguelova.projected(model, ld(point[0]), ld(point[1]),
                              {k: ld(v) for k, v in EGNO.items()})[:4]
    want = _sympy_projected(fields, params, G, V, point, EGNO)
    for g, w in zip(got, want):
        assert abs(float((g - ld(str(w))) / ld(str(w)))) < 1e-15
    # the rapid-turn condition from the exact values: long double keeps 1e-15
    cond = anguelova.consistency_rapidturn(*[np.array(ld(str(w))) for w in want])[0]
    assert abs(float(anguelova.consistency_rapidturn(*got)[0] - cond)) < 1e-15


def test_counter_hand_counts():
    """Hand counts of two small expressions as stages of the kernels'
    code generator count them: x0·x0 + p0 (one add, one mul: f64 2,
    double-double 20 + 9) and x0⁵/x1 (5 = 0b101: two squarings and one
    product, then the division: f64 4, double-double 3·9 + 70)."""
    first = {"add": 1, "mul": 1}
    second = {"mul": 3, "div": 1}
    assert count_ops.weigh(first, "f64") == 2 and count_ops.weigh(first, "dd") == 29
    assert count_ops.weigh(second, "f64") == 4 and count_ops.weigh(second, "dd") == 97
    stages = {f: {"point": first, "row": second, "col": {"call": 1}}
              for f in ("f_V", "f_hesse")}
    counts = count_ops.stage_counts(stages, "consistency_rapidturn", "dd")
    assert counts == {"point": 2 * 29, "row": 2 * 97, "col": 2, "tail": 8}
    # a launch of 3 sets over a 2 × 4 grid
    assert count_ops.launch_ops(counts, 2, 4, sets=3) == 3 * (66 * 8 + 194 * 2 + 2 * 4)
